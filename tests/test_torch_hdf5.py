"""The port's HDF5 archives against the JAX package's (CPU, where h5py
imports).

  * the codecs: a tree with every type of io/hdf5.py written by either
    package reads back through the other exactly as through its own
    (values, dtypes, None, str, list and tuple);
  * the chain in one XFRAME_TPU_HOME, at the sizes of
    tests/test_pipeline_integration.py: the JAX simulate_ccd's ccd.h5
    feeds the port's extract directly (its invariants equal those of the
    same ccd through an .npz); the
    port's proj_data.h5 reads back equal through the JAX ProjectDB; the
    JAX extract's proj_data.h5 feeds the port's reconstruct (its results
    equal those of the same invariants through an .npz); the port's
    data.h5 feeds the JAX average worker, and the same results written by
    the JAX codec feed the port's, each against the other package's
    average of the same file within tests/test_torch_average.py's bounds;
  * with h5py blocked, each kind of save writes the .npz of the same stem
    and one line naming h5py, and reads back equal to the HDF5 save;
  * a JAX checkpoint .h5 resumes in the port as the same state through
    the port's .npz checkpoint does (tests/test_torch_runners.py), and the
    port's .h5 checkpoint has the JAX package's layout;
  * the JAX package's Hankel weight cache (hankel_….h5) is read by the
    port, not recomputed.
"""
import os
import re
import sys

import numpy as np
import pytest
import torch

import xframe_tpu as xf
from xframe_tpu.io import hdf5 as jh5
from xframe_tpu.parallel import mesh as jmesh
from xframe_tpu.projects.fxs import phasing as jph
from xframe_tpu.projects.fxs._database_ import ProjectDB

from test_torch_outputs import WORKER, block_packages, results
from test_torch_reconstruct import (L_SIM, N_SIM, SHAPES,
                                    reconstruct_overrides)
from test_torch_runners import _schedule, problem  # noqa: F401
from test_torch_average import AVERAGE_OVERRIDES
from xframe_tpu_torch.convert import (save_ccd, save_invariants,
                                      state_arrays, state_from_numpy)
from xframe_tpu_torch.io import hdf5 as th5
from xframe_tpu_torch.main import run_worker
from xframe_tpu_torch.parallel import mesh as tmesh
from xframe_tpu_torch.projects.fxs import phasing as tph
from xframe_tpu_torch.projects.fxs import reconstruct as trec
from xframe_tpu_torch.projects.fxs.store import ProjectStore, flatten
from xframe_tpu_torch.settings import load_settings


def _tree():
    rng = np.random.default_rng(0)
    ragged = np.empty(2, dtype=object)
    ragged[0], ragged[1] = np.ones((2, 1)), np.ones((2, 3))
    return {
        "none": None, "text": "µ-strings ✓", "flag": True, "count": 7,
        "ratio": 0.25, "z": 1 - 2j, "raw": b"bytes",
        "np_scalars": {"f32": np.float32(1.5), "i64": np.int64(-3),
                       "b": np.bool_(False), "c64": np.complex64(2 + 1j)},
        "arrays": {"f32": rng.random((3, 4)).astype(np.float32),
                   "f64": rng.random(5), "c64": (rng.random((2, 3))
                                                 + 1j).astype(np.complex64),
                   "c128": rng.random(3) + 1j * rng.random(3),
                   "bool": rng.random((4, 2)) > 0.5,
                   "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
                   "u16": np.arange(4, dtype=np.uint16),
                   "empty": np.zeros(0),
                   "unicode": np.array(["ab", "cde"])},
        "ragged": ragged,
        "vs": [rng.random((3, min(2 * l + 1, 3))) for l in range(3)],
        "pair": (1, "two", [3.0, None]),
        "nested": {"0": {"deep": {"x": np.ones(2)}}, "empty": {}},
        "tensor": torch.arange(4, dtype=torch.float32),
    }


def _same(a, b, where="/"):
    """Exactly the same tree: types, dtypes and values."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}{k}/")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}{i}/")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_codecs_read_each_others_files(tmp_path, writer):
    tree = _tree()
    path = str(tmp_path / "tree.h5")
    if writer == "port":
        th5.save(path, tree)
    else:
        jax_tree = dict(tree, tensor=tree["tensor"].numpy())
        jh5.save(path, jax_tree)
    got, want = th5.load(path), jh5.load(path)
    _same(got, want)
    assert got["none"] is None and got["text"] == tree["text"]
    assert isinstance(got["pair"], tuple) and isinstance(got["vs"], list)
    assert got["arrays"]["unicode"].dtype == np.dtype("S3")
    assert "arrays" not in th5.load(path, skip=("arrays",))


# ------------------------------------------------------------------ chain
@pytest.fixture(scope="module")
def home(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("xf_hdf5_home"))
    old = os.environ.get("XFRAME_TPU_HOME")
    os.environ["XFRAME_TPU_HOME"] = path
    yield path
    if old is None:
        os.environ.pop("XFRAME_TPU_HOME", None)
    else:
        os.environ["XFRAME_TPU_HOME"] = old


def _overrides(**extra):
    """reconstruct_overrides with one main cycle (HIO 15 + SW + ER 10)."""
    ov = reconstruct_overrides(**extra)
    ov["main_loop"]["sub_loops"]["main"]["iterations"] = 1
    return ov


@pytest.fixture(scope="module")
def chain(home):
    """In one home: the JAX simulate_ccd (ccd run 1), the JAX extract
    (invariants run 1), the port's extract on the JAX ccd.h5 (invariants
    run 2), the port's reconstruct on the JAX proj_data.h5
    (reconstructions run 1) and its results written by the JAX codec
    (reconstructions run 2)."""
    store = ProjectStore("pytest", load_settings("extract"))
    xf.select_project("fxs", "simulate_ccd", overrides={
        "structure_name": "pytest", "dimensions": 3,
        "grid": {"n_radial_points": N_SIM, "max_order": L_SIM,
                 "max_q": 0.5},
        "shapes": SHAPES,
        "cross_correlation": {"method": "back_substitution",
                              "xray_wavelength": 1.23984}})
    ccd = xf.run()
    xf.select_project("fxs", "extract", overrides={
        "structure_name": "pytest", "dimensions": 3, "max_order": L_SIM})
    inv = xf.run()
    extract_ov = {"structure_name": "pytest", "dimensions": 3,
                  "max_order": L_SIM}
    port_inv = run_worker("fxs", "extract", overrides=extract_ov,
                          device="cpu")
    jax_inv_path = store.path("invariants", 1)[0]
    port_rec = run_worker("fxs", "reconstruct", overrides=_overrides(
        inv_path=jax_inv_path), device="cpu")
    jax_rec = os.path.join(store.folder("reconstructions"), "run_2")
    os.makedirs(jax_rec)
    jh5.save(os.path.join(jax_rec, "data.h5"),
             {k: v for k, v in port_rec.items() if k != "timing"})
    return dict(ccd=ccd, inv=inv, port_inv=port_inv, port_rec=port_rec,
                extract_ov=extract_ov, store=store)


def test_jax_ccd_h5_feeds_the_port_extract(chain, home):
    store = chain["store"]
    assert store.path("ccd", 1)[0].endswith("ccd.h5")
    npz = os.path.join(home, "jax_ccd.npz")
    save_ccd(chain["ccd"], npz)
    via_npz = run_worker("fxs", "extract", overrides=dict(
        chain["extract_ov"], structure_name="via_npz",
        input={"ccd_path": npz}), device="cpu")
    got = chain["port_inv"]
    for key in ("deg_2_invariant", "data_projection_matrices"):
        for a, b in zip(got[key]["I1I1"], via_npz[key]["I1I1"]):
            assert np.array_equal(np.asarray(a), np.asarray(b)), key


def test_port_proj_data_h5_read_by_project_db(chain):
    store = chain["store"]
    path = store.path("invariants", 2)[0]
    assert path.endswith("proj_data.h5")
    got = store.load_invariants(run=2)
    want = ProjectDB().load_invariants(path=path)
    assert got.keys() == want.keys()
    a, b = flatten(got), flatten(want)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_jax_proj_data_h5_feeds_the_port_reconstruct(chain, home):
    npz = os.path.join(home, "jax_invariants.npz")
    save_invariants(chain["inv"], npz)
    ov = _overrides(inv_path=npz)
    ov["structure_name"] = "via_npz"
    want = run_worker("fxs", "reconstruct", overrides=ov, device="cpu")
    got = chain["port_rec"]["reconstruction_results"]
    for key, res in want["reconstruction_results"].items():
        for f in ("real_density", "support_mask", "reciprocal_density"):
            assert np.array_equal(got[key][f], res[f]), f
        assert np.array_equal(got[key]["error_dict"]["main"],
                              res["error_dict"]["main"])


@pytest.mark.parametrize("source", ["port", "jax"])
def test_reconstructions_h5_feed_both_average_workers(chain, source):
    """The average of one data.h5 (the port's, run 1, or the JAX codec's,
    run 2) by both packages."""
    path = chain["store"].path("reconstructions", 1 if source == "port"
                               else 2)[0]
    assert path.endswith("data.h5")
    ov = dict(AVERAGE_OVERRIDES, reconstruction_files=[path])
    xf.select_project("fxs", "average", overrides=ov)
    want = xf.run()
    got = run_worker("fxs", "average", overrides=ov, device="cpu")
    assert np.array_equal(got["rotation_metric"]["inverted"],
                          want["rotation_metric"]["inverted"])
    for key in ("real_density", "normalized_real_density"):
        a, b = got["average"][key], np.asarray(want["average"][key])
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), key
    for name in ("PRTF", "FSC", "FQCB_from_density"):
        a = np.asarray(got["resolution_metrics"][name])
        b = np.asarray(want["resolution_metrics"][name])
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-4, name


# ------------------------------------------------------- h5py blocked
@pytest.mark.parametrize("kind", sorted(WORKER))
def test_saves_without_h5py_write_npz(tmp_path, monkeypatch, capsys, kind):
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    data = results(kind, 3)
    s = load_settings(WORKER[kind])
    h5_path, run = ProjectStore("a", s).save(kind, data)
    with monkeypatch.context() as m:
        block_packages(m)
        npz_path, _ = ProjectStore("b", s).save(kind, data)
        printed = capsys.readouterr().out
        stem = os.path.basename(h5_path)[:-3]
        assert npz_path == os.path.join(ProjectStore("b", s).folder(kind),
                                        f"run_{run}", stem + ".npz")
        assert re.findall(r"^.*h5py.*$", printed, flags=re.M) == [
            f"{stem}.h5: h5py is not installed; wrote {stem}.npz in its "
            "place"]
        assert ProjectStore("b", s).path(kind, run)[0] == npz_path
        back = ProjectStore("b", s).load(kind)
    a, b = flatten(ProjectStore("a", s).load(kind)), flatten(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# ------------------------------------------------------------ checkpoints
def test_jax_checkpoint_resumes_in_the_port(problem, tmp_path):  # noqa: F811
    """The JAX runner's checkpoint after one chunk, resumed by the port's
    runner, ends bitwise where the port's runner ends from the same state
    written as its own .npz checkpoint; the port's .h5 checkpoint has the
    JAX package's layout."""
    p, jm, port, r0 = problem
    sigma = p.mtip.sw.default_sigma
    ck = str(tmp_path / "jax_phasing.h5")
    j_state, j_err = jmesh.CheckpointingRunner(
        jm, _schedule(jph, sigma), checkpoint_path=ck)(
        r0, resume=False, max_chunks=1)
    assert np.array_equal(jh5.load(ck)["errors"], np.asarray(j_err))
    t_sched = _schedule(tph, sigma)
    got = tmesh.CheckpointingRunner(port["replay"], t_sched,
                                    checkpoint_path=ck)(
        torch.as_tensor(r0), resume=True)
    npz = tmesh.CheckpointingRunner(port["replay"], t_sched,
                                    checkpoint_path=str(tmp_path / "s.npz"))
    npz._save(state_from_numpy(device="cpu", **state_arrays(j_state)),
              [torch.as_tensor(np.array(j_err))], 1)
    want = npz(torch.as_tensor(r0), resume=True)
    assert torch.equal(got[1], want[1])
    for f in ("best_rho", "best_err", "rho", "support"):
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    assert set(jh5.load(ck)) == set(th5.load(ck))   # the port rewrote it
    assert {"rho_re", "rho_im", "anchor_rho_re", "chunk_index"} \
        <= set(th5.load(ck))


# ------------------------------------------------------------ Hankel cache
def test_jax_hankel_cache_is_read(tmp_path, monkeypatch):
    from xframe_tpu.projects.fxs import reconstruct as jrec
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    args = (6, 12, 2.0, 3, "midpoint")
    jrec.load_cached_weights(*args)
    files = os.listdir(tmp_path / "cache")
    assert len(files) == 1 and files[0].endswith(".h5")
    want = jrec.load_cached_weights(*args)      # the JAX package's read

    def recompute(*a, **k):
        raise AssertionError("the cached weights were recomputed")
    monkeypatch.setattr(trec, "generate_weights", recompute)
    got = trec.load_cached_weights(*args)
    assert got["weights"].dtype == np.asarray(want["weights"]).dtype
    assert np.array_equal(got["weights"], want["weights"])
    assert np.array_equal(got["posHarmOrders"], want["posHarmOrders"])
    assert os.listdir(tmp_path / "cache") == files
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        with pytest.raises(AssertionError, match="recomputed"):
            trec.load_cached_weights(*args)
