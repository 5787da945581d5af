"""The tutorial project's get_started worker on the port against the JAX
package's on the CPU: the intensity |FT(ρ)|² of a ball on the spherical
grid within 1e-4 of its max (float32 SHT and Hankel transform, sums in
another order), the result file's profile, q axis and settings, the run
numbering, a home settings file winning over the package's defaults, and
no kernel launched on the CPU."""
import os

import numpy as np
import pytest
import torch

from xframe_tpu.io import hdf5

from xframe_tpu_torch.main import select_worker
from xframe_tpu_torch.projects.fxs.store import archive_ext, load_archive

REL_TOL = 1e-4


def _jax_run(home, monkeypatch, overrides=None):
    import xframe_tpu as xf
    monkeypatch.setenv("XFRAME_TPU_HOME", home)
    xf.select_project("tutorial", "get_started", overrides=overrides)
    intensity = np.asarray(xf.run())
    return intensity, hdf5.load(os.path.join(home, "data", "tutorial",
                                             "run_1", "result.h5"))


@pytest.mark.parametrize("overrides", [None, {"n_points": 32, "radius": 6.0,
                                              "max_order": 6}])
def test_get_started_matches_jax(tmp_path, monkeypatch, overrides):
    want, want_file = _jax_run(str(tmp_path / "jax"), monkeypatch, overrides)
    home = str(tmp_path / "port")
    monkeypatch.setenv("XFRAME_TPU_HOME", home)
    worker = select_worker("tutorial", "get_started", overrides=overrides,
                           device="cpu")
    got = worker.run()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()
    out = load_archive(os.path.join(home, "data", "tutorial", "run_1",
                                    "result" + archive_ext()))
    assert set(out) == set(want_file)
    np.testing.assert_allclose(out["radial_points"],
                               want_file["radial_points"], rtol=1e-12)
    np.testing.assert_array_equal(out["intensity_q00"], got[:, 0, 0])
    assert np.abs(out["intensity_q00"] - want_file["intensity_q00"]).max() \
        <= REL_TOL * np.abs(want_file["intensity_q00"]).max()
    assert out["settings_used"] == {k: v.item() if hasattr(v, "item") else v
                                    for k, v in want_file["settings_used"]
                                    .items()}


def test_runs_number_and_home_settings_win(tmp_path, monkeypatch, capsys):
    from xframe_tpu_torch.main import main
    from xframe_tpu_torch.ops.fused_sht import FusedSHT
    home = str(tmp_path)
    monkeypatch.setenv("XFRAME_TPU_HOME", home)
    folder = os.path.join(home, "settings", "projects", "tutorial",
                          "get_started")
    os.makedirs(folder)
    with open(os.path.join(folder, "small.json"), "w") as f:
        f.write('{"n_points": 16, "radius": {"command": "2.0 * 3"}}')
    made = []
    init = FusedSHT.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)
    monkeypatch.setattr(FusedSHT, "__init__", spy)
    for run in (1, 2):
        assert main(["--device", "cpu", "tutorial", "get_started",
                     "small"]) == 0
        out = load_archive(os.path.join(home, "data", "tutorial",
                                        f"run_{run}",
                                        "result" + archive_ext()))
        assert out["settings_used"] == {"n_points": 16, "radius": 6.0}
        assert out["intensity_q00"].shape == (16,)
    assert "intensity profile saved" in capsys.readouterr().out
    assert len(made) == 2
    assert all(not any(m.launches.values()) for m in made)


def test_get_started_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        select_worker("tutorial", "get_started")
