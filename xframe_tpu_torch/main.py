"""Entry point of the fxs workers: the port's counterpart of
`xframe_tpu.select_project` and `xframe_tpu.run`.

    from xframe_tpu_torch.main import run_worker
    run_worker("fxs", "correlate", "tutorial")      # detector frames → ccd
    run_worker("fxs", "simulate_ccd", "tutorial")   # or a synthetic ccd
    run_worker("fxs", "extract", "tutorial")
    results = run_worker("fxs", "reconstruct", "tutorial",
                         overrides={"multi_start": {"seed": 0}})
    average = run_worker("fxs", "average", "tutorial")

Workers run on the card unless the caller passes device="cpu"; asking for
a CUDA device where none exists raises. Settings come from
xframe_tpu_torch.settings; files live under XFRAME_TPU_HOME
(projects/fxs/store.py).
"""
from __future__ import annotations

from xframe_tpu_torch.settings import load_settings

WORKERS = ("correlate", "simulate_ccd", "extract", "reconstruct",
           "average")


def select_worker(project, worker, settings_name=None, overrides=None,
                  device="cuda"):
    """The worker `worker` of `project` with its merged settings."""
    if project != "fxs":
        raise ValueError(f"unknown project {project!r} (the port has 'fxs')")
    if worker not in WORKERS:
        raise NotImplementedError(f"the {project} worker {worker!r} is not "
                                  f"ported (ported: {', '.join(WORKERS)})")
    settings = load_settings(worker, settings_name, overrides,
                             project=project)
    if worker == "correlate":
        from xframe_tpu_torch.projects.fxs.correlate import ProjectWorker
    elif worker == "simulate_ccd":
        from xframe_tpu_torch.projects.fxs.simulate_ccd import ProjectWorker
    elif worker == "extract":
        from xframe_tpu_torch.projects.fxs.extract import ProjectWorker
    elif worker == "reconstruct":
        from xframe_tpu_torch.projects.fxs.reconstruct import ProjectWorker
    else:
        from xframe_tpu_torch.projects.fxs.average import ProjectWorker
    return ProjectWorker(settings, device=device)


def run_worker(project, worker, settings_name=None, overrides=None,
               device="cuda"):
    """Select and run a worker. → its results dict."""
    return select_worker(project, worker, settings_name, overrides,
                         device=device).run()
