import sys

from xframe_tpu_torch.main import main

sys.exit(main())
