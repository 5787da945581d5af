"""The frozen work functions equal chip_smoke.py's, and give PERF.md's
bounds: B4 0.092 ms (tutorial) and 0.175 ms (production), B8 4.218 ms."""
import pytest

import chip_smoke
from fxsbench import work


@pytest.mark.parametrize("case", [
    ("inverse_real_project_fwd", 2 * 128, 256, 512, 64, 128),
    ("inverse_real_project_fwd", 256, 320, 640, 127, 256),
    ("inverse_real_project_fwd", 8 * 128, 128, 256, 64, 128),
    ("synthesize_update", 256, 256, 512, 64, 128),
    ("hankel_synthesize", 256, 320, 640, 127, 256),
    ("sht_forward_real_abs2", 256, 256, 512, 127, 256),
])
def test_kernel_work_is_chip_smokes(case):
    name, rows, t, p, l_max, n_q = case
    assert work.kernel_work(name, rows, t, p, l_max, n_q=n_q) \
        == chip_smoke.kernel_work(name, rows, t, p, l_max, n_q=n_q)


def test_bounds_of_perf_md():
    ms = {k: work.bound_s(*work.kernel_work("inverse_real_project_fwd",
                                            *dims))[0] * 1e3
          for k, dims in {"tutorial": (256, 256, 512, 64, 128),
                          "production": (256, 320, 640, 127, 256)}.items()}
    assert round(ms["tutorial"], 3) == 0.092
    assert round(ms["production"], 3) == 0.175
    b8 = work.ns_work("fused_projection", work.crop_buckets(127), 1, 256)
    assert b8 == chip_smoke.ns_work("fused_projection",
                                    work.crop_buckets(127), 1, 256, 14, 0)
    assert round(work.bound_s(*b8)[0] * 1e3, 3) == 4.218
    assert work.MINIMAX_STEPS == 14
    assert (work.PEAK_FLOPS, work.PEAK_BYTES) == (chip_smoke.PEAK_FLOPS,
                                                  chip_smoke.PEAK_BYTES)


def test_crop_buckets_and_schedule_are_the_programs():
    from xframe_tpu_torch.ops.polar_schedule import DEFAULT_SCHEDULE
    from xframe_tpu_torch.projects.fxs.projections import crop_buckets
    from fxsbench.reference.mtip import MINIMAX_SCHEDULE
    for l_max in (8, 64, 127, 200):
        assert work.crop_buckets(l_max) == crop_buckets(l_max)
    assert MINIMAX_SCHEDULE == DEFAULT_SCHEDULE
    assert len(MINIMAX_SCHEDULE) == work.MINIMAX_STEPS
