"""The port's SPB experiment (xframe_tpu_torch/experiments/SPB/) against
the JAX package's (xframe_tpu/experiments/SPB/) on the run folders of
tests/test_spb.py, written here with h5py: the frame index (train, pulse
and cell ids, the bad-frame mask, the pulses per train, the drop counts)
and every chunk of get_data bitwise equal (data, masks, good flags and
ids) for flat, per-cell and adaptive three-gain calibration, sequence
files read across their seam, the cellId sentinel, repeated trains, good
cells, selection by train and a filter sequence; the same refusals (an
ambiguous dataset, modules that disagree on their frame count) and the
same deterministic pick of the INSTRUMENT/ dataset. The exp_library
functions and filters equal the JAX ones. correlate with input.source
experiment on the CPU: the CC within 1e-4 of max of the JAX worker's and
the good-frame count equal. The comm facade, and the command line's
`-e SPB -eset tutorial` in a fresh home."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import h5py

from xframe_tpu.experiments.SPB import exp_library as jxl
from xframe_tpu.experiments.SPB import experiment as jexp

from xframe_tpu_torch.experiments.SPB import exp_library as txl
from xframe_tpu_torch.experiments.SPB import experiment as texp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CC_TOL = 1e-4


def _write_module_file(path, mod, data, trains=None, pulses=None,
                       cells=None):
    with h5py.File(path, "w") as f:
        grp = f"INSTRUMENT/SPB_DET_AGIPD1M-1/DET/{mod}CH0:xtdf/image"
        f.create_dataset(f"{grp}/data", data=data)
        for name, ids, dtype in (("trainId", trains, np.uint64),
                                 ("pulseId", pulses, np.uint64),
                                 ("cellId", cells, np.uint16)):
            if ids is not None:
                f.create_dataset(f"{grp}/{name}",
                                 data=np.asarray(ids, dtype=dtype))


@pytest.fixture(scope="module")
def run_folder(tmp_path_factory):
    """tests/test_spb.py's run folder: 4 modules, 20 uniform frames."""
    folder = tmp_path_factory.mktemp("spb_run")
    rng = np.random.default_rng(0)
    for mod in range(4):
        _write_module_file(
            folder / f"RAW-R0001-AGIPD{mod:02d}-S00000.h5", mod,
            rng.uniform(0, 10, (20, 512, 128)).astype(np.float32))
    return str(folder)


@pytest.fixture(scope="module")
def multiseq_run(tmp_path_factory):
    """Two sequence files per module (12 + 8 frames), 4 pulses a train,
    trainId 0 at frame 14 and the cellId sentinel at frame 17; a frame's
    values are its index."""
    folder = tmp_path_factory.mktemp("spb_multiseq")
    trains = np.repeat([100, 101, 102, 103, 104], 4)
    pulses = np.tile(np.arange(4), 5)
    cells = np.tile(np.arange(4), 5).astype(np.uint16)
    trains[14] = 0
    cells[17] = 65535
    data = np.arange(20, dtype=np.float32)[:, None, None] \
        + np.zeros((20, 512, 128), np.float32)
    for mod in range(4):
        for seq, sl in ((0, slice(0, 12)), (1, slice(12, 20))):
            _write_module_file(
                folder / f"RAW-R2-AGIPD{mod:02d}-S{seq:05d}.h5", mod,
                data[sl], trains[sl], pulses[sl], cells[sl])
    return str(folder)


@pytest.fixture(scope="module")
def small_runs(tmp_path_factory):
    """The small single-module folders of tests/test_spb.py: repeated
    trains, the cellId sentinel (plain and adaptive raw frames), adaptive
    calibration, good cells."""
    out = {}
    rng = np.random.default_rng(0)
    ss, fs = 8, 4

    def folder(name, data, trains, pulses, cells):
        f = tmp_path_factory.mktemp(name)
        _write_module_file(f / "RAW-R5-AGIPD00-S00000.h5", 0, data, trains,
                           pulses, cells)
        out[name] = str(f)
    folder("repeats", np.zeros((7, 512, 128), np.float32),
           [10, 10, 11, 11, 11, 12, 12], [0, 1, 0, 1, 0, 0, 1],
           np.zeros(7))
    seven = np.full((4, ss, fs), 7.0, np.float32)
    folder("sentinel", seven, [5, 5, 6, 6], [0, 1, 0, 1], [0, 65535, 1, 0])
    folder("sentinel_adaptive",
           np.stack([seven, np.full_like(seven, 500.0)], axis=1),
           [5, 5, 6, 6], [0, 1, 0, 1], [0, 65535, 1, 0])
    analog = rng.uniform(100, 200, (6, ss, fs)).astype(np.float32)
    digital = np.full((6, ss, fs), 500.0, np.float32)
    digital[:, :, 1], digital[:, :, 2] = 1500.0, 2500.0
    folder("adaptive", np.stack([analog, digital], axis=1),
           [5, 5, 6, 6, 7, 7], np.tile([0, 1], 3), [0, 1, 0, 1, 0, 1])
    folder("good_cells", np.zeros((6, 512, 128), np.float32),
           np.arange(1, 7) + 100, np.zeros(6), [0, 1, 2, 0, 1, 2])
    return out


def _adaptive_constants(n_cells=2, ss=8, fs=4, badpixel=True):
    gl = np.zeros((3, n_cells, 16, ss, fs), np.float32)
    gl[1], gl[2] = 1000.0, 2000.0
    off = np.zeros((3, n_cells, 16, ss, fs), np.float32)
    off[0], off[1], off[2] = 10.0, 20.0, 30.0
    off[:, 1] += 5.0
    gn = np.ones((3, n_cells, 16, ss, fs), np.float32)
    gn[1], gn[2] = 2.0, 4.0
    cal = {"gain_levels": gl, "analog_offset": off, "relative_gain": gn}
    if badpixel:
        bad = np.zeros((3, n_cells, 16, ss, fs), np.float32)
        bad[:, :, :, 0, 3] = 1
        cal["badpixel"] = bad
    return cal


def _per_cell(n_cells=4, shape=(512, 128)):
    offset = np.zeros((16, n_cells) + shape, np.float32)
    gain = np.ones((16, n_cells) + shape, np.float32)
    for c in range(n_cells):
        offset[:, c], gain[:, c] = c, 1.0 / (1 + c)
    return {"offset": offset, "gain": gain}


def _sentinel_offset():
    off = np.zeros((16, 2, 8, 4), np.float32)
    off[:, 1] = 3.0
    return {"offset": off}


# name: (folder fixture, folder key, worker kwargs, selection kwargs)
CASES = {
    "flat": ("run_folder", None, {"calibration": {
        "offset": np.full((16, 512, 128), 1.0, np.float32),
        "gain": np.full((16, 512, 128), 2.0, np.float32)}},
        dict(frame_range=(2, 18), modules=(0, 1, 2, 3), batch_size=7)),
    "multi_sequence": ("multiseq_run", None, {},
                       dict(frame_range=(8, 16), modules=(0, 1, 2, 3),
                            batch_size=5)),
    "per_cell": ("multiseq_run", None, {"calibration": _per_cell()},
                 dict(frame_range=(0, 12), modules=(0, 1), batch_size=12,
                      good_cells_only=False)),
    "by_train": ("multiseq_run", None, {},
                 dict(modules=(0,), batch_size=32, trains=(101, 103))),
    "by_train_range": ("multiseq_run", None, {},
                       dict(modules=(0,), batch_size=32,
                            train_range=(102, 105))),
    "filter_sequence": ("multiseq_run", None, {"filter_sequence": "metric"},
                        dict(frame_range=(0, 20), modules=(0, 1),
                             batch_size=20, good_cells_only=False)),
    "lit_pixels": ("run_folder", None, {"filters": 0.999},
                   dict(frame_range=(0, 6), modules=(0, 1), batch_size=4)),
    "repeats": ("small_runs", "repeats", {}, dict(modules=(0,))),
    "cell_sentinel": ("small_runs", "sentinel",
                      {"calibration": _sentinel_offset()},
                      dict(frame_range=(0, 4), modules=(0,), batch_size=4,
                           good_cells_only=False)),
    "cell_sentinel_adaptive": (
        "small_runs", "sentinel_adaptive",
        {"calibration": _adaptive_constants(badpixel=False)},
        dict(frame_range=(0, 4), modules=(0,), batch_size=4,
             good_cells_only=False)),
    "adaptive": ("small_runs", "adaptive",
                 {"calibration": _adaptive_constants()},
                 dict(frame_range=(0, 6), modules=(0,), batch_size=6)),
    "good_cells": ("small_runs", "good_cells",
                   {"good_cells": [0, 1], "bad_cells": [1]},
                   dict(modules=(0,), batch_size=4)),
}


def _workers(request, case):
    fixture, key, kwargs, sel = CASES[case]
    folder = request.getfixturevalue(fixture)
    folder = folder[key] if key else folder
    out = []
    for mod, xl in ((jexp, jxl), (texp, txl)):
        kw = dict(kwargs)
        if kw.get("filter_sequence") == "metric":
            kw["filter_sequence"] = xl.FilterSequence(
                [xl.MetricFilter("mean", (None, 10.0)),
                 xl.ADUFilter((0.5, None))])
        if "filters" in kw:
            kw["filters"] = mod.Filters(lit_pixel_fraction_min=kw["filters"])
        out.append((mod.ExperimentWorker(folder, **kw),
                    mod.DataSelection(**sel)))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunks_match_jax(request, case):
    (jw, jsel), (tw, tsel) = _workers(request, case)
    assert tw.n_frames() == jw.n_frames()
    for f in ("train_ids", "pulse_ids", "cell_ids", "frame_mask"):
        a, b = getattr(tw.index, f), getattr(jw.index, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert tw.index.n_pulses == jw.index.n_pulses
    assert tw.drop_counts == jw.drop_counts
    got, want = list(tw.get_data(tsel)), list(jw.get_data(jsel))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k


def test_refusals_match_jax(tmp_path):
    """Modules that disagree on their frame count, and an ambiguous image
    dataset, raise in both packages; one INSTRUMENT/ dataset beside a
    stray copy is read in both."""
    bad = tmp_path / "mismatch"
    bad.mkdir()
    _write_module_file(bad / "RAW-R3-AGIPD00-S00000.h5", 0,
                       np.zeros((5, 512, 128), np.float32))
    _write_module_file(bad / "RAW-R3-AGIPD01-S00000.h5", 1,
                       np.zeros((4, 512, 128), np.float32))
    amb = tmp_path / "ambiguous"
    amb.mkdir()
    with h5py.File(amb / "RAW-R6-AGIPD00-S00000.h5", "w") as f:
        for det in ("DET_A", "DET_B"):
            f.create_dataset(f"INSTRUMENT/{det}/image/data",
                             data=np.zeros((2, 512, 128), np.float32))
    with h5py.File(amb / "RAW-R6-AGIPD01-S00000.h5", "w") as f:
        f.create_dataset("INSTRUMENT/DET_A/image/data",
                         data=np.arange(2 * 512 * 128, dtype=np.float32)
                         .reshape(2, 512, 128))
        f.create_dataset("CONTROL/copy/image/data",
                         data=np.zeros((2, 512, 128), np.float32))
    for mod in (jexp, texp):
        with pytest.raises(ValueError, match="disagree"):
            mod.ExperimentWorker(str(bad))
        with pytest.raises(ValueError, match="ambiguous"):
            mod.ExperimentWorker(str(amb))
    got, want = (next(mod.ExperimentWorker(
        str(amb), data_path_glob="*AGIPD01*.h5").get_data(
            mod.DataSelection(modules=(1,))))["data"]
        for mod in (texp, jexp))
    assert np.array_equal(got, want) and got[0, 0, 0, 1] == 1.0


def test_without_h5py_the_worker_names_it(run_folder, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py is not installed"):
        texp.ExperimentWorker(run_folder)


# ------------------------------------------------------------ exp_library
@pytest.fixture(scope="module")
def agipd_q():
    from xframe_tpu_torch.experiments.SPB.detectors.agipd import AGIPD
    det = AGIPD(detector_distance=0.2)
    return det.data_shape, det.pixel_grid_reciprocal(1.23984)


def test_saxs_and_rois_match_jax(agipd_q):
    shape, qgrid = agipd_q
    rng = np.random.default_rng(1)
    frames = rng.uniform(0, 5, (3,) + shape).astype(np.float32)
    mask = rng.random(shape) > 0.2
    for q_range in (None, (0.05, 0.4)):
        for a, b in zip(txl.radial_bins(qgrid, 32, q_range),
                        jxl.radial_bins(qgrid, 32, q_range)):
            assert np.array_equal(a, b)
        for m in (None, mask):
            for a, b in zip(txl.saxs_profile(frames, qgrid, 32, q_range, m),
                            jxl.saxs_profile(frames, qgrid, 32, q_range, m)):
                assert np.array_equal(a, b)
    assert np.array_equal(txl.annulus_roi(qgrid, 0.1, 0.3),
                          jxl.annulus_roi(qgrid, 0.1, 0.3))
    for lo, hi in ((-0.5, 0.5), (1.0, 2.5)):
        assert np.array_equal(txl.azimuthal_roi(qgrid, lo, hi),
                              jxl.azimuthal_roi(qgrid, lo, hi))


def test_refine_beam_center_matches_jax():
    ax = np.linspace(-0.05, 0.05, 64)
    X, Y = np.meshgrid(ax, ax, indexing="ij")
    centers = np.stack([X, Y, np.full_like(X, 0.2)], axis=-1)
    r = np.hypot(X - 1.5e-3, Y + 1.0e-3)
    frame = np.exp(-(r - 0.02) ** 2 / 2e-6)
    got = txl.refine_beam_center(frame, centers, search_radius=2e-3, steps=9)
    assert got == jxl.refine_beam_center(frame, centers, search_radius=2e-3,
                                         steps=9)
    assert abs(got[0] - 1.5e-3) <= 6e-4 and abs(got[1] + 1.0e-3) <= 6e-4


def _filters(xl):
    bins = np.zeros((16, 16), dtype=np.int64)
    bins[8:] = 1
    return {
        "adu": xl.ADUFilter((0.0, None)),
        "adu_numpy_bounds": xl.ADUFilter((np.float64(0.5), np.int64(5))),
        "adu_false": xl.ADUFilter((False, None)),
        "normalization": xl.NormalizationFilter(),
        "normalization_roi": xl.NormalizationFilter(
            roi_mask=np.eye(16, dtype=bool)),
        "metric_mean": xl.MetricFilter("mean", (None, 10.0)),
        "metric_median": xl.MetricFilter("median", (1.2, None)),
        "metric_std": xl.MetricFilter("std", (None, 50.0)),
        "lit_pixels": xl.LitPixelsFilter(0.5, (0.5, None)),
        "bragg_mask": xl.BraggFilter(bins, n_bins=2, max_sigma=5.0),
        "bragg_discard": xl.BraggFilter(bins, 2, 5.0, mode="discard"),
        "bragg_select": xl.BraggFilter(bins, 2, 5.0, mode="select",
                                       fill_value=-1.0),
        "sequence": xl.FilterSequence([
            xl.ADUFilter((0.0, None)), xl.MetricFilter("mean", (None, 10.0)),
            xl.LitPixelsFilter(0.5, (0.5, None)),
            xl.NormalizationFilter()]),
    }


@pytest.mark.parametrize("name", sorted(_filters(txl)))
def test_filters_match_jax(name):
    """tests/test_spb.py's chunk: a hot frame, a dim one, a Bragg-like
    outlier and a negative pixel."""
    rng = np.random.default_rng(0)
    data = rng.uniform(1.0, 2.0, (6, 16, 16)).astype(np.float32)
    data[1] *= 10
    data[2] = 0.01
    data[3, 4, 7] = 1000.0
    data[0, 0, 0] = -5.0

    def chunk():
        return {"data": data.copy(), "mask": np.ones(data.shape, bool),
                "good": np.ones(6, bool)}
    got = _filters(txl)[name](chunk())
    want = _filters(jxl)[name](chunk())
    for k in ("data", "mask", "good"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k


# ------------------------------------------------------- correlate, comm, CLI
SPB_CORRELATE = {"structure_name": "spb_test", "wavelength": 1.23984,
                 "polar_grid": {"n_q": 24, "n_phi": 64}, "batch_size": 8,
                 "max_n_patterns": 16, "input": {"source": "experiment"}}


def test_correlate_experiment_matches_jax(run_folder, tmp_path,
                                          monkeypatch):
    """tests/test_spb.py's experiment-sourced correlation in both
    packages, each in its own home."""
    import xframe_tpu as xf
    from xframe_tpu_torch.main import run_worker
    from xframe_tpu_torch.projects.fxs.store import ProjectStore
    ov = dict(SPB_CORRELATE, experiment={"run_folder": run_folder,
                                         "detector_distance": 0.2})
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path / "jax"))
    xf.select_project("fxs", "correlate", overrides=ov)
    want = xf.run()
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path / "port"))
    got = run_worker("fxs", "correlate", overrides=ov, device="cpu")
    a = got["cross_correlation"]["I1I1"]
    b = np.asarray(want["cross_correlation"]["I1I1"])
    assert a.shape == b.shape == (24, 24, 64) and np.isfinite(a).all()
    assert np.abs(a - b).max() <= CC_TOL * np.abs(b).max()
    assert got["num_images_good"] == want["num_images_good"] == 16
    assert got["num_images_processed"] == want["num_images_processed"]
    for k in ("radial_points", "angular_points"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    np.testing.assert_allclose(got["average_intensity"],
                               want["average_intensity"], rtol=1e-5)
    path = ProjectStore("spb_test").path("ccd", 1)[0]
    assert path.endswith(os.path.join("ccd", "spb_test", "run_1", "ccd.h5"))


def test_comm_facade(run_folder):
    from xframe_tpu_torch import comm
    try:
        exp = comm.select_experiment("SPB", run_folder=run_folder,
                                     detector_distance=0.2)
        assert comm.experiment() is exp
        assert comm.experiment_settings["detector_distance"] == 0.217
        assert comm.get_geometry().shape == (16, 512, 128, 3)
        assert comm.get_pixel_grid_reciprocal().shape == (16, 512, 128, 3)
        chunk = next(comm.get_data(texp.DataSelection(
            frame_range=(0, 4), modules=(0, 1, 2, 3), batch_size=4)))
        assert chunk["data"].shape == (4, 4, 512, 128)
        assert comm.select_experiment(exp) is exp
        assert comm.experiment_settings is None
    finally:
        comm.clear()
    with pytest.raises(RuntimeError, match="no experiment selected"):
        comm.experiment()


def test_cli_experiment_in_a_fresh_home(run_folder, tmp_path):
    """`python -m xframe_tpu_torch --device cpu fxs correlate <settings>
    -e SPB -eset tutorial`: the tutorial experiment settings, the worker
    settings' experiment block over them; the ccd archive and both
    snapshots in the run folder."""
    home = str(tmp_path / "home")
    settings = str(tmp_path / "spb.json")
    with open(settings, "w") as f:
        json.dump(dict(SPB_CORRELATE, experiment={
            "run_folder": run_folder, "detector_distance": 0.2}), f)
    env = dict(os.environ, XFRAME_TPU_HOME=home, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", "xframe_tpu_torch", "--device",
                        "cpu", "fxs", "correlate", settings, "-e", "SPB",
                        "-eset", "tutorial"], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "correlate(experiment): saved to" in r.stdout
    run = os.path.join(home, "data", "fxs", "ccd", "spb_test", "run_1")
    assert os.path.exists(os.path.join(run, "ccd.h5"))
    with open(os.path.join(run, "experiment_settings_merged.json")) as f:
        exp = json.load(f)
    assert exp["x_ray_energy"] == 8000 and exp["detector_distance"] == 0.285
    assert exp["good_cells"] == list(range(1, 352))
    with open(os.path.join(run, "experiment_settings.json")) as f:
        assert json.load(f)["x_ray_energy"] == 8000
