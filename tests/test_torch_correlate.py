"""The port's correlate worker against the JAX package's (CPU).

The same seeded frames go through the JAX Correlator and the port's, for
every option group of settings/correlate/default_0.1.yaml; the port's CC is
held within CC_TOL of max|CC| of the JAX one (float32 sums in another
order: the regrid's gather, the batched GEMM over harmonics and the FFTs;
4e-7 measured) and its average intensity within AVG_TOL. The regrid's
rounding (order 0 at exact half pixels) and the median of an even count
are held exactly. The worker runs end to end over raw files, with an
unreadable and a short file, against the JAX worker in its own
XFRAME_TPU_HOME; PanelCorrelator runs on the nominal AGIPD geometry; the
frame reader is held to the JAX package's on every dtype code. A test
marked `cuda` holds the card against the CPU (it skips without one); the
JAX package is imported by fixtures, so that on a machine without it
(`python3 -m pytest --noconftest tests/test_torch_correlate.py -m cuda`)
the JAX tests skip and the card's runs.
"""
import os
import sys

import numpy as np
import pytest
import torch

from xframe_tpu_torch.projects.fxs import correlate as tcor

N, ORIGIN = 64, (31.3, 31.6)
GEOM = dict(pixel_size_um=200.0, sample_distance_mm=800.0,
            wavelength=1.23984)
CC_TOL, AVG_TOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def jcor():
    """The JAX package's correlate module."""
    return pytest.importorskip("xframe_tpu.projects.fxs.correlate")


@pytest.fixture(scope="module")
def jnp():
    return pytest.importorskip("jax.numpy")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: parallel test processes would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(seed, n=N, origin=ORIGIN, n_nan=5):
    """A blob with a cos 2φ modulation, 5 % noise and n_nan NaN pixels."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n]
    oy, ox = origin
    r2 = (y - oy) ** 2 + (x - ox) ** 2
    base = np.exp(-r2 / (2 * (n / 6) ** 2))
    angular = 1 + 0.3 * np.cos(2 * np.arctan2(y - oy, x - ox))
    f = (base * angular * (1 + 0.05 * rng.normal(size=(n, n)))
         ).astype(np.float32)
    f[rng.integers(0, n, n_nan), rng.integers(0, n, n_nan)] = np.nan
    return f


def _frames(count=6, seed=0):
    return np.stack([_frame(seed + s) for s in range(count)])


def _negative_and_empty_roi():
    """Frame 1 has a negative ROI mean, frame 2 an ROI fully NaN."""
    f = _frames(3)
    f[1] -= 5.0
    y, x = np.mgrid[0:N, 0:N]
    r = np.hypot(y - ORIGIN[0], x - ORIGIN[1])
    f[2][r < 9.0] = np.nan
    return f


_MASK = (np.random.default_rng(5).uniform(size=(N, N)) > 0.1
         ).astype(np.float32)
_BG = np.full((N, N), 0.05, dtype=np.float32)

# option group → (Correlator options, frames or None for _frames())
OPTIONS = {
    "order1": ({}, None),
    "order0": ({"interpolation_order": 0}, None),
    "thresholds": ({"mask_below": 0.05, "mask_above": 0.9}, None),
    "background": ({"background": _BG}, None),
    "static_mask": ({"static_mask": _MASK}, None),
    "polarization_true": ({"polarization": True}, None),
    "polarization_h": ({"polarization": "h"}, None),
    "polarization_v_solid_angle": ({"polarization": "v",
                                    "solid_angle": True}, None),
    "qrange": ({"qrange": (0.01, 0.05, 0.004), "n_q": None}, None),
    "qrange_xcca": ({"qrange": (0.01, 0.05, 0.004), "n_q": None,
                     "qrange_xcca": ((0.018, 0.042, 2),
                                     (0.014, 0.046, 1))}, None),
    "phi_range_max": ({"phi_range": (0.5, 2 * np.pi - 0.5), "n_phi": 10_000,
                       "phi_sampling_mode": "max"}, None),
    "phi_range_min": ({"phi_range": (0.5, 2 * np.pi - 0.5), "n_phi": 8,
                       "phi_sampling_mode": "min"}, None),
    "roi_bounds": ({"roi_q_range": (0.0046, 0.0104), "roi_normalize": True,
                    "roi_mean_bounds": (0.888, 0.9)}, None),
    "roi_negative_and_empty": ({"roi_q_range": (0.0046, 0.0104),
                                "roi_normalize": True,
                                "background": np.zeros((N, N), np.float32)},
                               _negative_and_empty_roi),
    "filter_average_sigma": ({"radial_pixel_filter": ("average_sigma",
                                                      1.5)}, None),
    "filter_median_mad": ({"radial_pixel_filter": ("median_mad", 2.0)},
                          None),
    "symmetrize_fc": ({"symmetrize": True, "fc_n_max": 10}, None),
    "waxs_only": ({"with_ccf": False}, None),
}


def _both(jcor, options, frames, batches=((0, 4), (4, None))):
    """The JAX and the port's correlate_frames over the same batches."""
    kw = dict(GEOM, n_phi=64, n_q=16)
    kw.update(options)
    want = jcor.Correlator((N, N), ORIGIN, **kw).correlate_frames(
        iter([frames[a:b] for a, b in batches]))
    port = tcor.Correlator((N, N), ORIGIN, device="cpu", **kw)
    got = port.correlate_frames(iter([frames[a:b] for a, b in batches]))
    return want, got, port


def _same(got, want):
    assert got["num_images_good"] == want["num_images_good"]
    ga, wa = got["average_intensity"], want["average_intensity"]
    assert ga.dtype == wa.dtype and ga.shape == wa.shape
    assert np.abs(ga - wa).max() <= AVG_TOL * np.abs(wa).max()
    gc, wc = got["cross_correlation"], want["cross_correlation"]
    if wc is None:
        assert gc is None
        return 0.0
    assert gc.dtype == wc.dtype and gc.shape == wc.shape
    err = float(np.abs(gc - wc).max())
    assert err <= CC_TOL * np.abs(wc).max(), err
    return err


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_correlator_matches_jax(jcor, name):
    options, make = OPTIONS[name]
    frames = _frames() if make is None else make()
    want, got, port = _both(jcor, options, frames)
    _same(got, want)
    if name == "roi_negative_and_empty":
        assert got["num_images_good"] == 2
    if name == "roi_bounds":
        assert 0 < got["num_images_good"] < len(frames)
    if name.startswith("filter"):
        polar, pmask, _ = port.polar_batch(torch.as_tensor(frames),
                                           torch.ones(len(frames)))
        assert 0 < int((pmask == 0).sum()) < pmask.numel() // 2


def test_median_of_even_count_averages_the_middle_pair(jnp):
    """jnp.nanmedian averages the two middle values of an even count;
    torch.nanmedian returns the lower one. The port follows JAX."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 12)).astype(np.float32)
    keep = rng.uniform(size=x.shape) > 0.3
    keep[0, 0] = True                       # 12 values: even
    keep[0, 1] = np.arange(12) < 7          # odd
    keep[0, 2] = False                      # none → NaN
    keep[0, 3] = np.arange(12) < 1
    want = np.asarray(jnp.nanmedian(jnp.where(keep, x, jnp.nan), axis=-1,
                                    keepdims=True))
    got = tcor._nanmedian(torch.as_tensor(x), torch.as_tensor(keep)).numpy()
    np.testing.assert_array_equal(got, want)
    lower = torch.nanmedian(torch.where(torch.as_tensor(keep),
                                        torch.as_tensor(x), float("nan")),
                            dim=-1, keepdim=True).values.numpy()
    assert got[0, 0, 0] != lower[0, 0, 0]


def test_order0_rounds_halves_away_from_zero(jnp):
    """Samples at exact half-pixel positions, inside, on and past the
    edges: the gather table equals jax map_coordinates(order=0, cval=0)
    exactly; at order 1 within an ulp (XLA may fuse a product into the
    sum)."""
    frame = np.arange(1, 7 * 9 + 1, dtype=np.float32).reshape(7, 9)
    ys = np.array([-1.5, -0.5, 0.5, 1.5, 2.5, 5.5, 6.5, 6.0, 3.49999],
                  dtype=np.float32)
    xs = np.array([0.5, -0.5, 8.5, 7.5, 3.5, 2.5, -0.49, 8.4, 1.5],
                  dtype=np.float32)
    coords = np.stack(np.meshgrid(ys, xs, indexing="ij"))
    from jax.scipy.ndimage import map_coordinates
    for order in (0, 1):
        want = np.asarray(map_coordinates(jnp.asarray(frame),
                                          [jnp.asarray(c) for c in coords],
                                          order=order, cval=0.0))
        idx, w = tcor.regrid_table(coords, frame.shape, order)
        flat = np.append(frame.ravel(), np.float32(0))
        got = flat[idx[0]] * w[0]
        for k in range(1, len(w)):
            got = got + flat[idx[k]] * w[k]
        np.testing.assert_allclose(got.reshape(want.shape), want,
                                   rtol=0 if order == 0 else 2.5e-7, atol=0)


def test_refine_detector_origin_matches_jax(jcor):
    y, x = np.mgrid[0:N, 0:N]
    r = np.hypot(y - 30.0, x - 33.0)
    frame = np.exp(-((r - 12.0) / 3.0) ** 2) + 0.5 * np.exp(
        -((r - 20.0) / 3.0) ** 2)
    for args in (dict(search_radius_pix=3.0, steps=13),
                 dict(search_radius_pix=1.0, steps=3)):
        got = tcor.refine_detector_origin(frame, (31.5, 31.5), **args)
        assert got == jcor.refine_detector_origin(frame, (31.5, 31.5),
                                                  **args)
    assert abs(got[0] - 30.0) <= 1.0
    zero = np.zeros((N, N), dtype=np.float32)
    assert tcor.refine_detector_origin(zero, (31.5, 31.5)) == (31.5, 31.5)
    assert tcor.refine_detector_origin(frame, (0.0, 0.0), 1.0, 3) == \
        jcor.refine_detector_origin(frame, (0.0, 0.0), 1.0, 3)


# ------------------------------------------------------------------- worker
WORKER = {
    "structure_name": "corr_port", "image_dimensions": [N, N],
    "detector_origin": list(ORIGIN), "polar_grid": {"n_phi": 64, "n_q": 16},
    "batch_size": 3, "max_n_patterns": 11, "fc_n_max": 12,
    "qrange_xcca": [[0.004, 0.03, 1], [0.006, 0.04, 2]],
    "ccf_2p_symmetrize": True,
    "refine_beam_center": {"search_radius_pix": 1.0, "steps": 3},
    "filters": {"radial_pixel_filter": ["average_sigma", 3.0],
                "mask_above": 5.0, "lit_pixel_fraction_min": 0.2,
                "roi": {"q_range": [0.005, 0.02], "normalize": True,
                        "mean_bounds": [1e-8, 1e8]}},
    "corrections": {"polarization": "v", "solid_angle": True},
}


@pytest.fixture(scope="module")
def frame_files(tmp_path_factory):
    """12 listed frames: 9 good, one missing, one short, one mostly dark
    (below lit_pixel_fraction_min), and one past max_n_patterns."""
    folder = tmp_path_factory.mktemp("frames")
    names = []
    for s in range(12):
        name = f"frame_{s}.raw"
        f = _frame(100 + s)
        if s == 7:
            f[:, : int(0.85 * N)] = 0.0
        if s == 4:
            (folder / name).write_bytes(f.tobytes()[:100])
        elif s != 2:
            f.tofile(folder / name)
        names.append(name)
    (folder / "patterns_list.txt").write_text("\n".join(names))
    bg = np.full((N, N), 0.01, dtype=np.float32)
    np.save(folder / "bg.npy", bg)
    return str(folder)


@pytest.fixture(scope="module")
def workers(jcor, frame_files, tmp_path_factory):
    """Both workers on the same frames, each in its own home. → (JAX
    result, port result, port archive path)."""
    import xframe_tpu as xf
    from xframe_tpu_torch.main import select_worker
    ov = dict(WORKER, input={"input_folder": frame_files},
              filters=dict(WORKER["filters"], background_file=os.path.join(
                  frame_files, "bg.npy")))
    old = os.environ.get("XFRAME_TPU_HOME")
    try:
        os.environ["XFRAME_TPU_HOME"] = str(tmp_path_factory.mktemp("jax"))
        xf.select_project("fxs", "correlate", overrides=ov)
        want = xf.run()
        os.environ["XFRAME_TPU_HOME"] = str(tmp_path_factory.mktemp("port"))
        worker = select_worker("fxs", "correlate", overrides=ov,
                               device="cpu")
        got = worker.run()
    finally:
        if old is None:
            os.environ.pop("XFRAME_TPU_HOME", None)
        else:
            os.environ["XFRAME_TPU_HOME"] = old
    return want, got, worker.saved[0]


def test_worker_matches_jax(workers):
    want, got, _ = workers
    assert set(got) - {"timing"} == set(want)
    assert got["num_images_processed"] == want["num_images_processed"] == 11
    # the missing, the short and the dark frame are not good
    assert got["num_images_good"] == want["num_images_good"] == 8
    for key in ("radial_points", "angular_points", "qrange_xcca_q1_ids",
                "qrange_xcca_q2_ids", "qrange_xcca_q1_points",
                "qrange_xcca_q2_points"):
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w)
    assert got["xray_wavelength"] == want["xray_wavelength"]
    assert got["dimensions"] == want["dimensions"] == 3
    _same({"num_images_good": got["num_images_good"],
           "average_intensity": got["average_intensity"],
           "cross_correlation": got["cross_correlation"]["I1I1"]},
          {"num_images_good": want["num_images_good"],
           "average_intensity": want["average_intensity"],
           "cross_correlation": want["cross_correlation"]["I1I1"]})
    assert got["cross_correlation"]["I1I1"].shape[:2] == (
        len(want["qrange_xcca_q1_ids"]), len(want["qrange_xcca_q2_ids"]))


def test_worker_archive_is_what_extract_reads(workers):
    from xframe_tpu_torch.projects.fxs.store import ProjectStore
    _, got, path = workers
    ccd = ProjectStore().load_ccd(path=path)
    for key in ("radial_points", "angular_points", "average_intensity",
                "qrange_xcca_q1_ids", "qrange_xcca_q2_points"):
        np.testing.assert_array_equal(ccd[key], got[key])
        assert ccd[key].dtype == np.asarray(got[key]).dtype
    np.testing.assert_array_equal(ccd["cross_correlation"]["I1I1"],
                                  got["cross_correlation"]["I1I1"])
    assert ccd["num_images_good"] == got["num_images_good"]
    assert "timing" not in ccd


def test_worker_full_cc_feeds_extract(frame_files, tmp_path, monkeypatch):
    """Without qrange_xcca the archive holds the square CC, and the port's
    extract turns it into finite invariants."""
    from xframe_tpu_torch.main import run_worker
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    ccd = run_worker("fxs", "correlate", overrides={
        "structure_name": "corr_sq", "image_dimensions": [N, N],
        "detector_origin": list(ORIGIN), "batch_size": 4,
        "polar_grid": {"n_phi": 64, "n_q": 16},
        "input": {"input_folder": frame_files}}, device="cpu")
    assert ccd["cross_correlation"]["I1I1"].shape == (16, 16, 64)
    assert ccd["num_images_good"] == 10
    inv = run_worker("fxs", "extract", overrides={
        "structure_name": "corr_sq", "max_order": 4}, device="cpu")
    for v in inv["data_projection_matrices"]["I1I1"]:
        assert np.isfinite(v).all()


def _spb_run(folder, n_modules=2, n_frames=3):
    """A small SPB run folder: n_modules module files of n_frames seeded
    512×128 frames."""
    import h5py
    rng = np.random.default_rng(5)
    for mod in range(n_modules):
        with h5py.File(os.path.join(folder,
                                    f"RAW-R0001-AGIPD{mod:02d}-S00000.h5"),
                       "w") as f:
            f.create_dataset(
                f"INSTRUMENT/SPB_DET_AGIPD1M-1/DET/{mod}CH0:xtdf/image/data",
                data=rng.uniform(0, 10, (n_frames, 512, 128)).astype(
                    np.float32))


HDF5_INPUTS = {
    "experiment": {"input": {"source": "experiment"},
                   "wavelength": 1.23984,
                   "polar_grid": {"n_q": 16, "n_phi": 32}},
    "background": {"filters": {"background_file": "bg.h5"}},
    "mask": {"filters": {"mask_file": "mask.hdf5"}},
}


@pytest.mark.parametrize("blocked", [True, False],
                         ids=["h5py_blocked", "h5py"])
@pytest.mark.parametrize("name", sorted(HDF5_INPUTS))
def test_hdf5_inputs_raise(frame_files, tmp_path, monkeypatch, name,
                           blocked):
    """The inputs that are HDF5 files: an SPB run folder under
    input.source experiment, and .h5 / .hdf5 background and mask files
    (the dataset 'background', else the first one). Where h5py is blocked
    they raise an ImportError naming h5py before any frame is read and no
    archive is written; where it imports they run: the SPB run folder to
    a finite CC of its frames, the background and mask files to the CC of
    the same frames given as .npy."""
    import h5py
    from xframe_tpu_torch.main import run_worker
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    rng = np.random.default_rng(11)
    frames = {"bg.h5": ("background", rng.uniform(0, 0.05, (N, N))),
              "mask.hdf5": ("mask", (rng.random((N, N)) > 0.1) * 1.0)}
    for fname, (key, arr) in frames.items():
        with h5py.File(tmp_path / fname, "w") as f:
            # a second dataset, after the frame's in h5py's (name) order
            f.create_dataset("zzz", data=np.zeros((N, N), np.float32))
            f.create_dataset(key, data=arr.astype(np.float32))
        np.save(tmp_path / (fname.split(".")[0] + ".npy"),
                arr.astype(np.float32))
    spb = tmp_path / "spb"
    spb.mkdir()
    _spb_run(str(spb))
    ov = {"structure_name": name, "image_dimensions": [N, N],
          "detector_origin": list(ORIGIN),
          "input": {"input_folder": frame_files},
          "experiment": {"run_folder": str(spb), "detector_distance": 0.2}}
    for k, v in HDF5_INPUTS[name].items():
        ov[k] = dict(ov.get(k, {}), **v) if isinstance(v, dict) else v
    for k in ("background_file", "mask_file"):
        if k in ov.get("filters", {}):
            ov["filters"][k] = str(tmp_path / ov["filters"][k])
    if blocked:
        monkeypatch.setitem(sys.modules, "h5py", None)
        with pytest.raises(ImportError, match="h5py"):
            run_worker("fxs", "correlate", overrides=ov, device="cpu")
        assert not os.path.exists(tmp_path / "data")
        return
    got = run_worker("fxs", "correlate", overrides=ov, device="cpu")
    cc = got["cross_correlation"]["I1I1"]
    if name == "experiment":
        assert cc.shape == (16, 16, 32) and np.isfinite(cc).all()
        assert got["num_images_good"] == 3
        return
    f = ov["filters"]
    for k in ("background_file", "mask_file"):
        if k in f:
            f[k] = os.path.splitext(f[k])[0] + ".npy"
    want = run_worker("fxs", "correlate", overrides=dict(
        ov, structure_name=name + "_npy"), device="cpu")
    np.testing.assert_array_equal(cc, want["cross_correlation"]["I1I1"])
    assert got["num_images_good"] == want["num_images_good"]


# -------------------------------------------------------------- the panels
@pytest.fixture(scope="module")
def agipd_grid():
    from xframe_tpu_torch.experiments.SPB.detectors.agipd import AGIPD
    return AGIPD(detector_distance=0.217).pixel_grid_reciprocal(1.23984)


def test_panel_correlator_matches_jax(jcor, agipd_grid):
    """The nominal AGIPD-1M geometry (1,048,576 pixels) at n_q 16, n_φ 32:
    the gather table equal, the CC and average intensity within the
    tolerances."""
    rng = np.random.default_rng(3)
    q, phi = agipd_grid[..., 0], agipd_grid[..., 2]
    frames = np.stack([(np.exp(-q / 0.5) * (1 + 0.4 * np.cos(2 * (phi - a)))
                        * (1 + 0.05 * rng.normal(size=q.shape))
                        ).astype(np.float32) for a in (0.3, 1.1, 2.0)])
    jp = jcor.PanelCorrelator(agipd_grid, n_q=16, n_phi=32, fc_n_max=8)
    tp = tcor.PanelCorrelator(agipd_grid, n_q=16, n_phi=32, fc_n_max=8,
                              device="cpu")
    np.testing.assert_array_equal(tp._gather_idx, jp._gather_idx)
    np.testing.assert_array_equal(tp._bin_counts, jp._bin_counts)
    np.testing.assert_array_equal(tp.qs, jp.qs)
    good = np.array([1, 0, 1], dtype=np.float32)
    want = jp.correlate_frames(iter([(frames[:2], good[:2]),
                                     (frames[2:], good[2:])]))
    got = tp.correlate_frames(iter([(frames[:2], good[:2]),
                                    (frames[2:], good[2:])]))
    _same(got, want)
    assert got["num_images_good"] == 2
    assert tp.gather_bytes(2) == 2 * jp._gather_idx.size * 4


def test_gather_table_equals_the_loop():
    rng = np.random.default_rng(0)
    flat = rng.integers(0, 13, size=200)
    n_bins = 12                      # 12 is the trash bin
    table = tcor.gather_table(flat, n_bins)
    for b in range(n_bins):
        pixels = np.nonzero(flat == b)[0]
        np.testing.assert_array_equal(table[b, : len(pixels)], pixels)
        assert (table[b, len(pixels):] == flat.size).all()


# -------------------------------------------------------------- the reader
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "uint16",
                                   "int16"])
def test_frame_reader_matches_jax(jcor, tmp_path, dtype):
    from xframe_tpu.native import read_frame_batch as jread
    from xframe_tpu_torch.native import (PrefetchingFrameLoader,
                                         read_frame_batch)
    rng = np.random.default_rng(1)
    shape = (16, 24)
    paths = []
    for i in range(7):
        f = (rng.uniform(0, 1000, shape) * (1 if i % 2 else -0.5)).astype(
            dtype)
        if dtype == "uint16":
            f = np.abs(f)
        p = tmp_path / f"f{i}.raw"
        f.tofile(p)
        paths.append(str(p))
    (tmp_path / "short.raw").write_bytes(b"\x01" * 17)
    paths += [str(tmp_path / "short.raw"), str(tmp_path / "missing.raw")]
    want, ok_w = jread(paths, shape, dtype=dtype)
    got, ok = read_frame_batch(paths, shape, dtype=dtype)
    np.testing.assert_array_equal(ok, ok_w)
    assert list(ok) == [True] * 7 + [False, False]
    np.testing.assert_array_equal(got[ok], want[ok])
    # a frame not read whole is all zeros (the JAX reader keeps a short
    # float32 read's first values)
    assert (got[~ok] == 0).all()
    buffers = [np.full((4,) + shape, np.nan, np.float32) for _ in range(2)]
    for bufs in (None, buffers):
        items = [(b.copy(), o) for b, o in PrefetchingFrameLoader(
            paths, shape, dtype=dtype, batch_size=4, buffers=bufs)]
        assert [len(b) for b, _ in items] == [4, 4, 1]
        np.testing.assert_array_equal(np.concatenate([b for b, _ in items]),
                                      got)
        np.testing.assert_array_equal(np.concatenate([o for _, o in items]),
                                      ok_w)


def test_prefetching_buffers_under_thread_pressure(tmp_path):
    """With two shared buffers, a batch stays intact until the next one
    is asked for: 32 reader threads, a 1 µs switch interval and a consumer
    slower than the reader still see every frame once, in order."""
    import sys
    import time
    from xframe_tpu_torch.native import PrefetchingFrameLoader
    shape = (8, 8)
    paths = []
    for i in range(120):
        np.full(shape, i, dtype=np.float32).tofile(tmp_path / f"{i}.raw")
        paths.append(str(tmp_path / f"{i}.raw"))
    buffers = [np.empty((3,) + shape, np.float32) for _ in range(2)]
    seen = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        for batch, ok in PrefetchingFrameLoader(paths, shape, batch_size=3,
                                                n_threads=32,
                                                buffers=buffers):
            time.sleep(0.001)
            assert ok.all() and (batch == batch[:, :1, :1]).all()
            seen.extend(batch[:, 0, 0].astype(int).tolist())
            assert time.perf_counter() - t0 < 60
    finally:
        sys.setswitchinterval(old)
    assert seen == list(range(120))


def test_frame_reader_refuses_unknown_dtype(tmp_path):
    from xframe_tpu_torch.native import read_frame_batch
    with pytest.raises(ValueError, match="dtype"):
        read_frame_batch([str(tmp_path / "x.raw")], (4, 4), dtype="int8")


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_matches_cpu(cuda, agipd_grid):
    """Correlator (median filter, xcca subsets) and PanelCorrelator on the
    card against the CPU: 1e-5 of max."""
    kw = dict(GEOM, n_phi=64, n_q=16, radial_pixel_filter=("median_mad",
                                                           2.0),
              qrange_xcca=((0.004, 0.03, 1), (0.006, 0.04, 2)))
    frames = _frames()
    cpu = tcor.Correlator((N, N), ORIGIN, device="cpu", **kw)
    card = tcor.Correlator((N, N), ORIGIN, device=cuda, **kw)
    _same(card.correlate_frames(iter([frames])),
          cpu.correlate_frames(iter([frames])))
    rng = np.random.default_rng(4)
    q = agipd_grid[..., 0]
    frames = (np.exp(-q / 0.5)[None] * rng.uniform(0.9, 1.1, (2,) + q.shape)
              ).astype(np.float32)
    _same(tcor.PanelCorrelator(agipd_grid, 16, 32, device=cuda)
          .correlate_frames(iter([frames])),
          tcor.PanelCorrelator(agipd_grid, 16, 32, device="cpu")
          .correlate_frames(iter([frames])))
