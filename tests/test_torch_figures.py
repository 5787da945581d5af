"""The port's figures against the JAX package's (CPU, matplotlib on Agg):

  * the saves of tests/test_torch_outputs.py: the port's ProjectStore and
    the JAX ProjectDB write PNGs of the same names whose decoded pixels
    (matplotlib.pyplot.imread) are equal: first invariants, errors, first
    used invariants, density slices (3D and 2D), PRTF;
  * `view`: the port's view_file on an HDF5 and on an `.npz` archive
    draws the pixels of the JAX view_file on the HDF5 one (3D and 2D
    reconstructions, an average), both refuse an archive with nothing to
    draw, and `python -m xframe_tpu_torch view` prints what it wrote;
  * every class of presenters/matplotlib_presenter.py builds the JAX
    presenter's pixels;
  * with matplotlib blocked, saves name it in their notice and `view`
    exits naming it.
"""
import glob
import os

import numpy as np
import pytest

from xframe_tpu.presenters import matplotlib_presenter as jmp
from xframe_tpu.presenters import viewer as jview

from test_torch_outputs import CASES, _save_both, block_packages, results
from xframe_tpu_torch.main import main
from xframe_tpu_torch.presenters import matplotlib_presenter as tmp_
from xframe_tpu_torch.presenters import viewer as tview
from xframe_tpu_torch.projects.fxs.store import (ProjectStore, save_archive,
                                                 save_npz)
from xframe_tpu_torch.settings import load_settings


def _pixels(path):
    import matplotlib.pyplot as plt
    return plt.imread(path)


def _same_pngs(got, want):
    """Two lists of PNG paths: the same names, the same pixels."""
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        pa, pb = _pixels(a), _pixels(b)
        assert pa.shape == pb.shape and np.array_equal(pa, pb), \
            os.path.basename(a)


FIGURE_CASES = ("invariants", "invariants_toggles", "reconstructions",
                "reconstructions_vtk_3", "reconstructions_2d", "average",
                "average_no_vtk")


@pytest.mark.parametrize("case", FIGURE_CASES)
def test_save_figures_match_project_db(tmp_path, monkeypatch, case):
    kind, dim, overrides = CASES[case]
    root_j, root_t, path = _save_both(tmp_path, monkeypatch, kind, dim,
                                      overrides)
    run = os.path.dirname(path)
    run_j = os.path.join(root_j, os.path.relpath(run, root_t))
    got = sorted(glob.glob(os.path.join(run, "*.png")))
    want = sorted(glob.glob(os.path.join(run_j, "*.png")))
    _same_pngs(got, want)
    assert len(got) == {"invariants": 2, "invariants_toggles": 1,
                        "reconstructions": 4, "reconstructions_vtk_3": 4,
                        "reconstructions_2d": 4, "average": 1,
                        "average_no_vtk": 0}[case]


VIEW_CASES = {"reconstructions": ("reconstructions", 3),
              "reconstructions_2d": ("reconstructions", 2),
              "average": ("average_results", 3)}


@pytest.mark.parametrize("name", sorted(VIEW_CASES))
def test_view_matches_jax(tmp_path, monkeypatch, name):
    kind, dim = VIEW_CASES[name]
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    data = results(kind, dim)
    h5, _ = ProjectStore("v", load_settings("average")).save(kind, data)
    npz = str(tmp_path / "npz" / os.path.basename(h5)[:-3]) + ".npz"
    save_npz(npz, data)
    want = jview.view_file(h5, out_dir=str(tmp_path / "jax"),
                           max_results=2)
    assert len(want) == (2 if kind == "reconstructions" else 1)
    for path, out in ((h5, "h5"), (npz, "npz")):
        got = tview.view_file(path, out_dir=str(tmp_path / out),
                              max_results=2)
        _same_pngs(got, want)


def test_view_refuses_an_archive_with_nothing_to_draw(tmp_path):
    path = str(tmp_path / "plain.h5")
    save_archive(path, {"x": np.ones(3)})
    for viewer in (tview, jview):
        with pytest.raises(ValueError, match="no reconstruction_results"):
            viewer.view_file(path)


def test_cli_view_writes_next_to_the_archive(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    path, _ = ProjectStore("v", load_settings("reconstruct")).save(
        "reconstructions", results("reconstructions", 3))
    capsys.readouterr()
    assert main(["view", path, "-n", "1"]) == 0
    out = os.path.join(os.path.dirname(path), "data_view_0.png")
    assert capsys.readouterr().out.split() == [out]
    assert os.path.exists(out)


def _presenter_figures(mod):
    rng = np.random.default_rng(2)
    line = rng.random((2, 20))
    grid = rng.random((12, 16)) + 1j * rng.random((12, 16))
    sph = rng.random((6, 8, 10))
    xy = rng.random((4, 8, 2))
    return {
        "plot1D": mod.plot1D.get_fig(line, x=np.arange(20),
                                     labels=["a", "b"],
                                     ylog=True, xlabel="q", title="t"),
        "heat2D": mod.heat2D.get_fig(grid, log_scale=True, title="h"),
        "heat2D_multi": mod.heat2D.get_fig_multi([grid, grid.T],
                                                 titles=["a", "b"]),
        "heatPolar2D": mod.heatPolar2D.get_fig(grid.real, log_scale=True),
        "sphericalSlices": mod.sphericalSlices.get_fig(sph, title="s"),
        "detector_heat": mod.detector_heat.get_fig(xy, rng.random((4, 8)),
                                                   log_scale=True),
    }


def test_presenter_classes_match_jax(tmp_path):
    import matplotlib.pyplot as plt
    paths = {}
    for label, mod in (("port", tmp_), ("jax", jmp)):
        for name, fig in _presenter_figures(mod).items():
            paths[label, name] = str(tmp_path / f"{label}_{name}.png")
            fig.savefig(paths[label, name], dpi=60)
            plt.close(fig)
    names = sorted({n for _, n in paths})
    assert len(names) == 6
    for name in names:
        a, b = _pixels(paths["port", name]), _pixels(paths["jax", name])
        assert np.array_equal(a, b), name


def test_without_matplotlib_the_notice_and_view_name_it(tmp_path,
                                                        monkeypatch, capsys):
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    block_packages(monkeypatch)
    from xframe_tpu_torch.projects.fxs import figures
    assert not figures.available()
    path, _ = ProjectStore("m", load_settings("average")).save(
        "average_results", results("average_results", 3))
    assert path.endswith("average_results.npz")
    out = capsys.readouterr().out
    assert "average_results: figures not written (PRTF.png): matplotlib " \
        "is not installed" in out
    assert not glob.glob(os.path.join(os.path.dirname(path), "*.png"))
    with pytest.raises(SystemExit, match="matplotlib is not installed"):
        main(["view", path])
