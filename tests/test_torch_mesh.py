"""The port's device mesh (xframe_tpu_torch/parallel/mesh.py) against the
JAX package's, on the CPU: the ranks are gloo processes that share the
CPU, as two ranks share one card in chip_smoke.py's phase `mesh`.

  * make_mesh, default_mesh_axes and _pad_restarts against the JAX
    functions, a rank's rows against the slices shard_map gives, and the
    workers' mesh sizes against the JAX workers' `_make_mesh`;
  * the reconstruct worker with mesh.restarts 2 on two CPU ranks, 3D and
    2D, against the JAX worker with the same mesh on the conftest's 8
    virtual devices, on the JAX chain's invariants: the archive's layout
    equal, the first segment from the port's initial densities within 1e-4
    of the JAX MTIP's (tests/test_torch_reconstruct.py's bound); and
    bitwise, row for row, against the port's one-process runs of each
    rank's sub-batch (initial density, errors, best error, best density);
  * an uneven count under batch_size chunking (5 restarts in chunks of 3
    over 2 ranks: each chunk padded to 4, the last trimmed);
  * the runners on a rank's mesh (a JAX make_demo_problem's tables, three
    restarts): MultiStartRunner and CheckpointingRunner bitwise the
    one-process runs of the sub-batches, a checkpoint after one chunk
    resumed under 2 ranks bitwise the uninterrupted 2-rank run, that
    checkpoint resumed in one process and the JAX runner's checkpoint
    resumed under the mesh bitwise the one-process runs of the same
    (on the CPU a restart's arithmetic does not depend on its batch);
  * the average worker with mesh.restarts 2 on two ranks against the JAX
    average worker with the same mesh (tests/test_torch_average.py's
    bounds) and against the port's one-process average (1e-6);
  * `python -m xframe_tpu_torch --distributed --device cpu` as two
    processes with torchrun's variables: rank 0's archive equals the
    spawned run's; a missing variable exits naming it; a rank that raises
    makes both processes exit non-zero;
  * the θ mesh of the plain path (precision float64 or fused_sht false):
    its ranks and layout, {"restarts": n_r, "theta": T}, the JAX worker's
    mesh (tests/test_torch_theta.py runs it).
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax

import xframe_tpu as xf
from xframe_tpu.parallel import mesh as jmesh
from xframe_tpu.projects.fxs import phasing as jph
from xframe_tpu.projects.fxs.average import ProjectWorker as JaxAverage
from xframe_tpu.projects.fxs.demo import make_demo_problem as jax_demo
from xframe_tpu.projects.fxs.reconstruct import ProjectWorker as JaxWorker

from test_torch_average import AVERAGE_OVERRIDES
from test_torch_reconstruct import (L_REC, N_REC, jax_invariants,
                                    reconstruct_overrides)
from test_torch_runners import _schedule
from xframe_tpu_torch.convert import (mtip_arrays, mtip_from_numpy,
                                      save_invariants, save_reconstructions,
                                      state_arrays)
from xframe_tpu_torch.main import run_worker, select_worker
from xframe_tpu_torch.parallel import mesh as tmesh
from xframe_tpu_torch.projects.fxs import phasing as tph
from xframe_tpu_torch.projects.fxs.average import ProjectWorker as Average
from xframe_tpu_torch.projects.fxs.reconstruct import ProjectWorker
from xframe_tpu_torch.projects.fxs.store import load_archive

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU2 = ["cpu", "cpu"]
MESH2 = {"mesh": {"restarts": 2}}
RESTARTS_4 = {"multi_start": {"n_reconstructions": 4, "batch_size": 0,
                              "seed": 7}}
# the reconstruct runs: one cycle of the pipeline test's schedule
LOOP_3D = {"main_loop": {"sub_loops": {
    "order": ["main"],
    "main": {"iterations": 1, "order": ["HIO", "SW", "ER"],
             "methods": {"HIO": {"iterations": 8}, "SW": {"iterations": 1},
                         "ER": {"iterations": 6}}}}}}
SIM_2D = {"structure_name": "mesh2d", "dimensions": 2,
          "grid": {"n_radial_points": 32, "max_order": 8, "max_q": 0.5,
                   "n_phi": 32},
          "shapes": {"types": ["sphere", "sphere"],
                     "centers": [[0, 0], [40, 1.0]], "sizes": [22, 15],
                     "densities": [1.0, 0.7],
                     "random_orientation": [False, False]},
          "cross_correlation": {"xray_wavelength": 1.23984}}
REC_2D = {"structure_name": "mesh2d", "dimensions": 2, "particle_radius": 60,
          "grid": {"n_radial_points": 24, "max_order": 8, "n_phi": 32},
          "projections": {"real": {
              "shrink_wrap": {"sigmas": [False], "thresholds": [0.09]},
              "HIO": {"beta": [[0.5, 0.4, -1 / 50, 100]]}}}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread here and in the ranks (they take the launcher's
    count): small tensors, several test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("xf_torch_mesh_home"))
    old = os.environ.get("XFRAME_TPU_HOME")
    os.environ["XFRAME_TPU_HOME"] = path
    yield path
    if old is None:
        os.environ.pop("XFRAME_TPU_HOME", None)
    else:
        os.environ["XFRAME_TPU_HOME"] = old


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("axes", [None, {"restarts": 2},
                                  {"restarts": 4, "theta": 2},
                                  {"restarts": 3}, {"restarts": 9}])
def test_make_mesh_matches_jax(axes):
    """The same devices on the same axes (devices told apart by index)."""
    jdev = jax.devices()
    tdev = [torch.device("cuda", i) for i in range(len(jdev))]
    if axes and int(np.prod(list(axes.values()))) > len(jdev):
        with pytest.raises(ValueError, match="needs 9 devices, have 8"):
            jmesh.make_mesh(axes, jdev)
        with pytest.raises(ValueError, match="needs 9 devices, have 8"):
            tmesh.make_mesh(axes, tdev)
        return
    jm, tm = jmesh.make_mesh(axes, jdev), tmesh.make_mesh(axes, tdev)
    assert tm.axis_names == jm.axis_names
    assert tm.shape == dict(jm.shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert np.array_equal(np.vectorize(lambda d: d.index)(tm.devices), ids)


@pytest.mark.parametrize("n", range(1, 9))
def test_default_mesh_axes_matches_jax(n):
    assert tmesh.default_mesh_axes(n) == jmesh.default_mesh_axes(n)


@pytest.mark.parametrize("n,shards", [(4, 2), (3, 2), (1, 2), (5, 3),
                                      (2, 4), (6, 4)])
def test_pad_restarts_and_rows_match_jax(n, shards):
    """Wrap-padding as the JAX package pads for shard_map, on a tensor and
    on an array; rank r's rows are the padded batch's r-th slice."""
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    want = np.asarray(jmesh._pad_restarts(x, shards))
    assert np.array_equal(tmesh._pad_restarts(torch.as_tensor(x),
                                              shards).numpy(), want)
    assert np.array_equal(tmesh._pad_restarts(x, shards), want)
    b = want.shape[0] // shards
    for r in range(shards):
        m = tmesh.Mesh(["cpu"] * shards, ("restarts",), rank=r)
        assert np.array_equal(x[m.rows(n)], want[r * b:(r + 1) * b])


@pytest.mark.parametrize("restarts,theta,n,fused,precision", [
    ("all", 1, 4, True, "float32"), ("all", 1, 3, True, "float32"),
    (2, 1, 8, True, "float32"), ("all", 2, 8, True, "float32"),
    (3, 2, 8, True, "float32"), ("all", 1, 1, True, "float32"),
    (5, 1, 8, False, "float32"), ("all", 2, 8, False, "float32"),
    (3, 2, 8, False, "float32"), (1, 2, 2, True, "float64"),
    ("all", 2, 1, True, "float64"), ("all", 4, 8, False, "float64")])
def test_worker_mesh_sizes_match_jax(monkeypatch, restarts, theta, n,
                                     fused, precision):
    """The reconstruct worker's mesh over 8 devices has as many ranks as
    the JAX worker's mesh has devices, and the average worker's as many as
    the JAX average's. On the fused path θ is flattened into restarts; on
    the plain path (fused_sht false or float64) the mesh is the JAX
    worker's, {"restarts": n_r, "theta": T}, axis for axis."""
    opt = {"mesh": {"restarts": restarts, "theta": theta},
           "fourier_transform": {"fused_sht": fused},
           "precision": precision}
    jw = JaxWorker.__new__(JaxWorker)
    jw.settings = opt
    jm = jw._make_mesh(n)
    tw = ProjectWorker.__new__(ProjectWorker)
    tw.settings, tw.devices = opt, [torch.device("cpu")] * 8
    tm = tw._make_mesh(n)
    assert (tm.size if tm else 1) == (jm.devices.size if jm else 1)
    plain = not fused or precision == "float64"
    if plain and theta > 1:
        assert tm.axis_names == jm.axis_names == ("restarts", "theta")
        assert tm.shape == dict(jm.shape)
    elif tm is not None:
        assert tm.axis_names == ("restarts",)
    ja = JaxAverage.__new__(JaxAverage)
    ja.settings = opt
    ta = Average.__new__(Average)
    ta.settings, ta.devices = opt, tw.devices
    ja, ta = ja._make_mesh(n), ta._make_mesh(n)
    assert (ta.size if ta else 1) == (ja.devices.size if ja else 1)


# ----------------------------------------------------------------- workers
@pytest.fixture(scope="module")
def chain3d(home):
    """The JAX chain's invariants (simulate_ccd → extract) and the JAX
    worker's reconstructions with mesh.restarts 2 (4 restarts)."""
    inv, inv_path = jax_invariants(home)
    chain = dict(inv=inv, inv_path=inv_path)
    ov = _overrides(3, chain, **RESTARTS_4)
    ov.pop("input")
    xf.select_project("fxs", "reconstruct", overrides=ov)
    rec = xf.run()
    rec_path = os.path.join(home, "jax_reconstructions.npz")
    save_reconstructions(rec, rec_path)
    return dict(chain, rec=rec, rec_path=rec_path)


@pytest.fixture(scope="module")
def chain2d(home):
    xf.select_project("fxs", "simulate_ccd", overrides=SIM_2D)
    xf.run()
    xf.select_project("fxs", "extract", overrides={
        "structure_name": "mesh2d", "dimensions": 2, "max_order": 8})
    inv = xf.run()
    path = os.path.join(home, "jax_invariants_2d.npz")
    save_invariants(inv, path)
    return dict(inv=inv, inv_path=path)


def _overrides(dim, chain, **extra):
    """The port's and the JAX worker's overrides for the mesh runs."""
    if dim == 3:
        ov = reconstruct_overrides(chain["inv_path"], **LOOP_3D)
    else:
        ov = dict(REC_2D, input={"invariants_path": chain["inv_path"]},
                  **LOOP_3D)
    ov.update(MESH2)
    ov.update(extra)
    return ov


def _one_process(ov):
    """The port's worker set-up in this process. → (worker, mtip,
    schedule, aux)."""
    w = select_worker("fxs", "reconstruct", overrides=ov, device="cpu")
    mtip, ft, aux = w.setup_mtip(w._load_invariants())
    return w, mtip, w._build_schedule(ft), aux


def _check_rows_bitwise(res, ov, chunk):
    """Each rank's restarts bitwise the one-process run of its sub-batch:
    the chunks' initial densities from seed + chunk index, each rank's rows
    of a chunk run apart, the restarts ranked by their best error. →
    (the one-process MTIP and schedule, ρ0 of all restarts, errors)."""
    w, mtip, sched, aux = _one_process(ov)
    centered = w.settings["output_density_modifiers"]["shift_to_center"]
    n = int(ov["multi_start"]["n_reconstructions"])
    seed = int(ov["multi_start"]["seed"])
    rho0s, errs, best, best_rho = [], [], [], []
    for ci in range(-(-n // chunk)):
        r0 = aux["initial_density_batch"](seed + ci, chunk)
        parts = [tph_run(mtip, sched, r0, tmesh.Mesh(CPU2, ("restarts",),
                                                      rank=r).rows(chunk))
                 for r in range(2)]
        e = torch.cat([p[1] for p in parts])[:chunk]
        s = [torch.cat([getattr(p[0], k) for p in parts])[:chunk]
             for k in ("best_err", "best_rho")]
        rho0s.append(r0)
        errs.append(e)
        best.append(s[0])
        best_rho.append(s[1])
    rho0 = torch.cat(rho0s)[:n].numpy()
    errs = torch.cat(errs)[:n].numpy()
    best = torch.cat(best)[:n].numpy()
    best_rho = torch.cat(best_rho)[:n].numpy()
    sqrt_s = float(np.sqrt(aux["data_scale"]))
    order = np.argsort(best)
    results = res["reconstruction_results"]
    assert sorted(results, key=int) == [str(k) for k in range(n)]
    for k, i in enumerate(order):
        got = results[str(k)]
        assert np.array_equal(got["initial_density"], rho0[i] * sqrt_s)
        assert np.array_equal(got["error_dict"]["main"], errs[i][:, 0])
        assert got["error_dict"]["final"] == float(best[i])
        if not centered:
            assert np.array_equal(got["real_density"], best_rho[i] * sqrt_s)
    return mtip, sched, rho0, errs


def tph_run(mtip, sched, r0, rows):
    return tmesh.MultiStartRunner(mtip, sched)(r0[torch.as_tensor(rows)])


def _layout(tree):
    """{key path: shape} of a results tree's arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in _layout(v).items()})
        elif isinstance(v, np.ndarray):
            out[k] = v.shape
    return out


def _worker_rank(mesh, ov, r0):
    """A rank of the reconstruct worker's mesh (a module-level function:
    the spawned ranks import it): the worker's run, then the first segment
    of its schedule on its MTIP from the densities r0 through the mesh's
    MultiStartRunner. → on rank 0 (results, archive path, launch counts,
    the segment's errors)."""
    w = select_worker("fxs", "reconstruct", overrides=ov, device=mesh.device,
                      mesh=mesh)
    res = w.run()
    mtip, ft, _ = w.setup_mtip(w._load_invariants())
    _, errs = tmesh.MultiStartRunner(mtip, w._build_schedule(ft)[:1],
                                     mesh=mesh)(torch.as_tensor(r0))
    if mesh.rank == 0:
        return res, w.saved, w.rank_launches, errs.numpy()


@pytest.mark.parametrize("dim", [3, 2])
def test_reconstruct_mesh_matches_jax(home, chain3d, chain2d, dim):
    """mesh.restarts 2 over two CPU ranks, 4 restarts: the layout of the
    JAX worker's archive under the same mesh; the mesh's MTIP from the JAX
    worker's initial densities against the JAX MTIP on the first segment
    (3D: the first iteration within 1e-4 relative,
    tests/test_torch_reconstruct.py's bound; 2D: the segment within 1e-4,
    tests/test_torch_pipeline2d.py's); every rank's rows bitwise its
    sub-batch run in one process; the ranks' launch counts returned (0: no
    kernel on the CPU)."""
    chain = chain3d if dim == 3 else chain2d
    ov = _overrides(dim, chain, **RESTARTS_4)
    jov = dict(ov)
    jov.pop("input")
    xf.select_project("fxs", "reconstruct", overrides=jov)
    jw = JaxWorker()
    jres = jw.run() if dim == 2 else chain3d["rec"]
    jm, jft, jaux = jw.setup_mtip(chain["inv"])
    seg = jw._build_schedule(jft)[0]
    jrho0 = np.array(jaux["initial_density_batch"](7, 3))
    _, je = jm.run_batch(jrho0, [seg])
    je = np.asarray(je)
    res, saved, launches, te = tmesh.run_ranks(
        tmesh.make_mesh(devices=CPU2), _worker_rank, ov, jrho0)
    assert te.shape == je.shape == (3, seg.n, 2)
    if dim == 3:
        assert (np.abs(te - je) / (np.abs(je) + 1e-9))[:, 0].max() < 1e-4
    else:
        assert np.abs(te - je).max() <= 1e-4
    assert len(launches) == 2 and not any(sum(c.values()) for c in launches)
    assert os.path.exists(saved[0])
    assert _layout(res["reconstruction_results"]) \
        == _layout(jres["reconstruction_results"])
    _check_rows_bitwise(res, ov, 4)


@pytest.fixture(scope="module")
def uneven(home, chain3d):
    """The worker over a spawned two-rank mesh (its own run_ranks), 5
    restarts in chunks of 3. → (overrides, worker, results)."""
    ov = _overrides(3, chain3d, structure_name="uneven", multi_start={
        "n_reconstructions": 5, "batch_size": 3, "seed": 11})
    w = select_worker("fxs", "reconstruct", overrides=ov, device="cpu",
                      devices=CPU2)
    return ov, w, w.run()


def test_reconstruct_mesh_uneven_chunks(uneven):
    """5 restarts in chunks of 3 over two ranks: each chunk wrap-padded to
    4 rows, 2 a rank, and trimmed; the archive holds the 5 restarts,
    bitwise each rank's sub-batch runs."""
    ov, w, res = uneven
    assert len(res["reconstruction_results"]) == 5
    assert len(res["timing"]["chunk_walls_s"]) == 2
    _check_rows_bitwise(res, ov, 3)


# ----------------------------------------------------------------- runners
def _runner_rank(mesh, arrays, config, r0, sigma, paths):
    """A rank's runner runs (a module-level function: the spawned ranks
    import it): uninterrupted, one chunk with a checkpoint (copied to
    paths["one_chunk"] before the resume), resumed, from the JAX
    checkpoint, and MultiStartRunner. → on rank 0 {name: (state arrays,
    errors)}."""
    tm = mtip_from_numpy(arrays, config, device=mesh.device)
    sched = _schedule(tph, sigma)
    rho0 = torch.as_tensor(r0)
    out = {"full": tmesh.CheckpointingRunner(tm, sched, mesh=mesh)(
        rho0, resume=False)}
    tmesh.CheckpointingRunner(tm, sched, checkpoint_path=paths["ck"],
                              mesh=mesh)(rho0, resume=False, max_chunks=1)
    if mesh.rank == 0:
        shutil.copy(paths["ck"], paths["one_chunk"])
    out["resumed"] = tmesh.CheckpointingRunner(
        tm, sched, checkpoint_path=paths["ck"], mesh=mesh)(rho0)
    out["from_jax"] = tmesh.CheckpointingRunner(
        tm, sched, checkpoint_path=paths["jax"], mesh=mesh)(rho0)
    out["multi"] = tmesh.MultiStartRunner(tm, sched, mesh=mesh)(rho0)
    if mesh.rank != 0:
        return None
    return {k: (state_arrays(s), e.numpy()) for k, (s, e) in out.items()}


def _same(got, want):
    (s, e), (ws, we) = got, want
    assert np.array_equal(e, we.numpy())
    for k in ("best_err", "best_rho", "best_mask", "rho", "support"):
        assert np.array_equal(s[k], getattr(ws, k).numpy()), k


def test_runners_and_checkpoints_on_the_mesh(tmp_path):
    """Three restarts of a JAX make_demo_problem's MTIP (replay) on two
    ranks: every run bitwise the one-process run; the 2-rank checkpoint
    resumed in one process and the JAX runner's checkpoint resumed under
    the mesh as the same checkpoints resumed in one process."""
    p = jax_demo(12, 6, fused_sht=True)
    m = p.mtip
    jm = jph.MTIP(p.ft, m.rc, m.real, m.sw, m._w_err_host, m.initial_support,
                  enforce_initial_support_limit=m.enforce_limit,
                  best_mode="replay")
    arrays, config = mtip_arrays(jm)
    config = dict(config, best_mode="replay")
    r0 = np.array(p.initial_density_batch(5, 3))
    sigma = m.sw.default_sigma
    paths = {k: str(tmp_path / f"{k}.npz") for k in ("ck", "one_chunk")}
    paths["jax"] = str(tmp_path / "jax_phasing.h5")
    jmesh.CheckpointingRunner(jm, _schedule(jph, sigma),
                              checkpoint_path=paths["jax"])(
        r0, resume=False, max_chunks=1)
    jax_copy = str(tmp_path / "jax_copy.h5")
    shutil.copy(paths["jax"], jax_copy)
    got = tmesh.run_ranks(tmesh.make_mesh(devices=CPU2), _runner_rank,
                          arrays, config, r0, sigma, paths)
    tm = mtip_from_numpy(arrays, config, device="cpu")
    sched = _schedule(tph, sigma)
    rho0 = torch.as_tensor(r0)
    full = tmesh.CheckpointingRunner(tm, sched)(rho0, resume=False)
    _same(got["full"], full)
    _same(got["multi"], tmesh.MultiStartRunner(tm, sched)(rho0))
    _same(got["resumed"], full)
    # the checkpoint holds the whole batch, the one-card layout
    with np.load(paths["one_chunk"]) as ck:
        assert ck["rho"].shape[0] == 3 and ck["errors"].shape[:2] == (3, 7)
    _same(got["resumed"], tmesh.CheckpointingRunner(
        tm, sched, checkpoint_path=paths["one_chunk"])(rho0))
    os.remove(paths["one_chunk"])
    _same(got["from_jax"], tmesh.CheckpointingRunner(
        tm, sched, checkpoint_path=jax_copy)(rho0))


# ----------------------------------------------------------------- average
def test_average_mesh_matches_jax(home, chain3d):
    """The JAX worker's 4 reconstructions averaged on two ranks: as the
    JAX average with the same mesh (inversion flags equal, l2 within 1e-4,
    the average within 1e-4 of max, every metric within 1e-4) and as the
    port's one-process average (angles, l2 and the average within 1e-6)."""
    ov = dict(AVERAGE_OVERRIDES, **MESH2,
              reconstruction_files=[chain3d["rec_path"]])
    w = select_worker("fxs", "average", overrides=ov, device="cpu",
                      devices=CPU2)
    got = w.run()
    one = run_worker("fxs", "average", overrides=ov, device="cpu")
    xf.select_project("fxs", "average", overrides=dict(
        ov, reconstruction_files=[1]))          # the JAX worker's run
    want = xf.run()
    g, o, j = (r["rotation_metric"] for r in (got, one, want))
    assert len(got["aligned"]) == len(want["aligned"]) == 4
    assert np.array_equal(g["inverted"], j["inverted"])
    assert np.abs(g["l2_to_ref"] - j["l2_to_ref"]).max() <= 1e-4
    assert np.array_equal(g["inverted"], o["inverted"])
    for k in ("angles", "l2_to_ref"):
        assert np.abs(g[k] - o[k]).max() <= 1e-6, k
    for ref, tol in ((one, 1e-6), (want, 1e-4)):
        a = got["average"]["real_density"]
        b = ref["average"]["real_density"]
        assert np.abs(a - b).max() <= tol * np.abs(b).max()
    for k, v in want["resolution_metrics"].items():
        if np.ndim(v) and k in got["resolution_metrics"]:
            assert np.abs(np.asarray(got["resolution_metrics"][k])
                          - np.asarray(v)).max() <= 1e-4, k


# -------------------------------------------------------------------- CLI
def _cli(home, *args, **env):
    e = dict(os.environ, XFRAME_TPU_HOME=home, JAX_PLATFORMS="cpu", **env)
    return subprocess.Popen([sys.executable, "-m", "xframe_tpu_torch", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO, env=e)


def _torchrun_env(rank, port, **extra):
    env = {"RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "OMP_NUM_THREADS": "1"}
    env.update(extra)
    return env


def _distributed(home, settings, homes=None):
    """Two `--distributed --device cpu` processes with torchrun's
    variables; homes: each rank's XFRAME_TPU_HOME. → [(returncode,
    stdout, stderr)] in rank order."""
    port = tmesh._free_port()
    homes = homes or [home, home]
    procs = [_cli(homes[r], "--distributed", "--device", "cpu", "fxs",
                  "reconstruct", settings, **_torchrun_env(r, port))
             for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    return [(p.returncode,) + o for p, o in zip(procs, outs)]


def test_distributed_cli_matches_the_spawned_mesh(home, uneven, tmp_path):
    """rank 0 of a two-process --distributed run writes the archive of the
    same settings run over a spawned two-rank mesh (every array equal);
    rank 1 writes none."""
    ov, spawned, _ = uneven
    path = str(tmp_path / "mesh.json")
    with open(path, "w") as f:
        json.dump(ov, f)
    out = _distributed(home, path)
    assert [o[0] for o in out] == [0, 0], out[1][2] + out[0][2]
    assert "saved to" in out[0][1] and "saved to" not in out[1][1]
    runs = os.path.join(home, "data", "fxs", "reconstructions", "uneven")
    assert sorted(os.listdir(runs)) == ["run_1", "run_2"]
    a = load_archive(spawned.saved[0])
    b = load_archive(spawned.saved[0].replace("run_1", "run_2"))
    flat_a, flat_b = _layout(a), _layout(b)
    assert flat_a == flat_b
    for k in a["reconstruction_results"]:
        for f in ("real_density", "initial_density", "support_mask"):
            assert np.array_equal(a["reconstruction_results"][k][f],
                                  b["reconstruction_results"][k][f]), f


@pytest.mark.parametrize("missing", ["RANK", "MASTER_PORT"])
def test_distributed_missing_variable_exits_naming_it(home, missing):
    env = _torchrun_env(0, 29500)
    env.pop(missing)
    e = {k: v for k, v in os.environ.items()
         if k not in tmesh_variables()}
    e.update(env, XFRAME_TPU_HOME=home, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", "xframe_tpu_torch",
                        "--distributed", "--device", "cpu", "fxs",
                        "reconstruct"], capture_output=True, text=True,
                       cwd=REPO, env=e, timeout=300)
    assert r.returncode != 0
    assert f"{missing} is not set" in r.stderr


def tmesh_variables():
    from xframe_tpu_torch.main import TORCHRUN_VARIABLES
    return TORCHRUN_VARIABLES


def test_failing_rank_fails_the_command(home, chain3d, tmp_path):
    """Rank 1 finds no invariants in its home and raises: both processes
    exit non-zero, and no archive is written."""
    ov = _overrides(3, chain3d, structure_name="cli_fail",
                    multi_start={"n_reconstructions": 2, "seed": 3})
    ov.pop("input")
    path = str(tmp_path / "fail.json")
    with open(path, "w") as f:
        json.dump(ov, f)
    # rank 0's home holds the invariants as the latest run of structure
    # cli_fail, rank 1's is empty
    inv_dir = os.path.join(str(tmp_path / "h0"), "data", "fxs", "invariants",
                           "cli_fail", "run_1")
    os.makedirs(inv_dir)
    shutil.copy(chain3d["inv_path"], os.path.join(inv_dir, "proj_data.npz"))
    empty = str(tmp_path / "h1")
    os.makedirs(empty)
    out = _distributed(home, path, homes=[str(tmp_path / "h0"), empty])
    assert out[0][0] != 0 and out[1][0] != 0, out
    assert not os.path.exists(os.path.join(str(tmp_path / "h0"), "data",
                                           "fxs", "reconstructions"))
