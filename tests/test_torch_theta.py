"""The θ axis of the port's device mesh (`mesh.theta` on the plain
transforms) against the JAX package's θ-sharded runs and the port's own
one-process runs, on the CPU: the ranks are gloo processes sharing the
CPU, as in tests/test_torch_mesh.py.

  * the transform's θ shard in one process: the partial analyses of T
    blocks, summed, are the whole forward, forward_real and
    forward_real_abs2 (1e-12 of max in float64, 1e-6 in float32); the
    blocks' syntheses, joined, are the whole inverse and inverse_real
    bitwise, at T = 2 and at a T that does not divide n_θ (blocks of 6,
    6 and 4 rows of 16);
  * the runners on a {"restarts": 2, "theta": 2} mesh (4 ranks),
    make_demo_problem(16, 8) on the plain transforms: the JAX problem's
    MTIP carried by convert.mtip_arrays in float32 against the JAX runner
    on its {"restarts": 4, "theta": 2} mesh from the same ρ0 (the first
    iteration within 1e-4, the series within tests/test_parallel.py's
    bound), the port's own problem in float64 against the port's
    one-process run (the first iteration within 1e-10), every θ rank's
    errors bitwise its group partner's; CheckpointingRunner resumed under
    the θ mesh bitwise the uninterrupted θ run, from a θ file and from a
    one-card file, and the θ file resumed on one card;
  * the reconstruct worker with mesh.theta 2 over two ranks: precision
    float64 and fused_sht false against the JAX worker's runner on the
    same mesh (tests/test_torch_precision.py's _series_close), SW_center
    with the sort fixed volume and a non-default error configuration, and
    the bucketed fixed volume with the particle-number estimate, each
    against the port's one-process run; the float64 archive against the
    one-process archive; `--distributed --device cpu` as two processes
    with torchrun's variables, rank 0's archive bitwise the spawned run's.
"""
import copy
import json
import os
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import xframe_tpu as xf
from xframe_tpu.parallel import mesh as jmesh
from xframe_tpu.projects.fxs import phasing as jph
from xframe_tpu.projects.fxs.demo import make_demo_problem as jax_demo
from xframe_tpu.projects.fxs.reconstruct import ProjectWorker as JaxWorker

from test_torch_mesh import _distributed, _layout
from test_torch_precision import _series_close
from xframe_tpu_torch.convert import (mtip_arrays, mtip_from_numpy,
                                      save_invariants, state_arrays)
from xframe_tpu_torch.main import select_worker
from xframe_tpu_torch.ops import sht as tsht
from xframe_tpu_torch.parallel import mesh as tmesh
from xframe_tpu_torch.projects.fxs import phasing as tph
from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
from xframe_tpu_torch.projects.fxs.projections import ShrinkWrap, ThetaShard
from xframe_tpu_torch.projects.fxs.store import load_archive
from xframe_tpu_torch.settings import deep_update

F64, F32 = torch.float64, torch.float32
TOL = {F64: 1e-12, F32: 1e-6}      # a shard's transforms, of max
ITER_TOL = 1e-10                   # float64: the first iteration
F32_TOL = 1e-4                     # float32 against the JAX package
THETA2 = {"restarts": 1, "theta": 2}
CPU2 = ["cpu", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _segments(mod, sigma):
    return [mod.Segment("HIO", 3, betas=np.full(3, 0.5), ft_stab=True),
            mod.Segment("SW", sigma=sigma, threshold=0.1),
            mod.Segment("ER", 2, betas=np.zeros(2), ft_stab=True)]


# --------------------------------------------------------- the transform
@pytest.mark.parametrize("dtype,t", [(F64, 2), (F64, 3), (F32, 2),
                                     (F32, 3)])
def test_sht_theta_shards(dtype, t):
    sht = tsht.SphericalHarmonicTransform(8, real_dtype=dtype, device="cpu")
    n_theta, L = sht.n_theta, sht.l_max
    blocks = [tmesh.Mesh(["cpu"] * t, ("theta",), rank=r).theta_rows(n_theta)
              for r in range(t)]
    assert [b.stop - b.start for b in blocks] == (
        [8, 8] if t == 2 else [6, 6, 4])
    # one process: each shard's all_reduce is the identity, the test sums
    shards = [sht.theta_shard(ThetaShard(
        tmesh.Mesh(["cpu"] * t, ("theta",), rank=r), (n_theta, sht.n_phi)))
        for r in range(t)]
    rng = np.random.default_rng(3)
    cd = tsht.complex_dtype_of(dtype)
    f = torch.as_tensor(rng.standard_normal((2, n_theta, sht.n_phi))
                        + 1j * rng.standard_normal((2, n_theta, sht.n_phi))
                        ).to(cd)
    c = torch.as_tensor(rng.standard_normal((2, 2 * L + 1, L + 1))
                        + 1j * rng.standard_normal((2, 2 * L + 1, L + 1))
                        ).to(cd)

    def close(got, want):
        got, want = got.numpy(), want.numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= TOL[dtype] * np.abs(want).max()

    for name, x in (("forward", f), ("forward_real", f.real),
                    ("forward_real_abs2", f)):
        close(sum(getattr(s, name)(x[..., b, :])
                  for s, b in zip(shards, blocks)), getattr(sht, name)(x))
    for name in ("inverse", "inverse_real"):
        joined = torch.cat([getattr(s, name)(c) for s in shards], dim=-2)
        assert torch.equal(joined, getattr(sht, name)(c)), name


# ----------------------------------------------------------- the runners
def _plain(mtip):
    """The float32 MTIP on its plain transforms, the JAX problem's own
    (mtip_from_numpy gives it a FusedSHT built from the SHT tables): the
    stepwise iteration, which a θ shard runs."""
    new = copy.copy(mtip)
    new.ft = copy.copy(mtip.ft)
    new.ft.harmonic = new.sht = mtip.ft.sht
    new._fi, new.best_mode = None, "eager"
    return new


SW_MODES = ("threshold", "sort", "bucketed")
SW_SEG = tph.Segment("SW", sigma=2.0, threshold=0.1)


def _sw_inputs(p64):
    """p64's MTIP under each shrink-wrap of SW_MODES (the threshold, a
    fixed volume of 0.3 by sort or bucketed) and a random state of 4
    restarts: |ρ| noise, so that the blur's largest value lies anywhere on
    the grid; random supports; errors either side of the enforcement
    limit. → ({mode: MTIP}, ρ, support, last_err)."""
    m = p64.mtip
    mtips = {"threshold": m}
    for method in SW_MODES[1:]:
        mtips[method] = copy.copy(m)
        mtips[method].sw = ShrinkWrap.build(
            np.asarray(p64.ft.qs), "fixed_volume", 0.3,
            integration_weights=m._w_host,
            initial_support=m.initial_support.numpy(),
            fixed_volume_method=method, real_dtype=F64, device="cpu")
    rng = np.random.default_rng(11)
    shape = (4,) + tuple(m.initial_support.shape)
    rho = torch.as_tensor(rng.standard_normal(shape)
                          + 1j * rng.standard_normal(shape))
    support = torch.as_tensor(rng.random(shape) < 0.4)
    last_err = torch.tensor([1e-4, 1.0, 1e-4, 1.0], dtype=F64)
    return mtips, rho, support, last_err


def _shrink_wrap(mtip, rho, support, last_err):
    """One shrink-wrap (SW_SEG) of `mtip` from the given state. → its
    support."""
    state = mtip.initial_state_batch(rho, support=support)
    return mtip._shrink_wrap(state._replace(last_err=last_err),
                             SW_SEG).support


def _runner_rank(mesh, arrays, config, r0_f32, paths):
    """A rank of the {"restarts": 2, "theta": 2} mesh (module-level: the
    spawned ranks import it): the JAX problem's MTIP in float32 from the
    JAX ρ0, make_demo_problem(16, 8) on the plain transforms in float64
    from its own, the float64 errors of each rank's own run gathered, and
    the checkpoint runs. → on rank 0 a dict of host arrays."""
    m32 = _plain(mtip_from_numpy(arrays, config, "cpu"))
    p64 = make_demo_problem(16, 8, fused_sht=False, real_dtype=F64,
                            device="cpu")
    sigma = p64.mtip.sw.default_sigma
    rho64 = p64.initial_density_batch(0, 4)
    s32, e32 = tmesh.MultiStartRunner(
        m32, _segments(tph, m32.sw.default_sigma), mesh=mesh)(
        torch.as_tensor(r0_f32))
    runner = tmesh.MultiStartRunner(p64.mtip, _segments(tph, sigma),
                                    mesh=mesh)
    s64, e64 = runner(rho64)
    exchanges = {k: dict(v) for k, v in mesh.exchanges.items()}
    own = runner.mtip.run_batch(mesh.local(rho64), _segments(tph, sigma))[1]
    rank_errors = mesh.gather_objects(own.numpy())
    long = _segments(tph, sigma) + _segments(tph, 0.8 * sigma)
    full = tmesh.CheckpointingRunner(p64.mtip, long, mesh=mesh)(
        rho64, resume=False)
    tmesh.CheckpointingRunner(p64.mtip, long, checkpoint_path=paths["ck"],
                              mesh=mesh)(rho64, resume=False, max_chunks=1)
    if mesh.rank == 0:
        shutil.copy(paths["ck"], paths["theta_file"])
    resumed = tmesh.CheckpointingRunner(
        p64.mtip, long, checkpoint_path=paths["ck"], mesh=mesh)(rho64)
    from_one_card = tmesh.CheckpointingRunner(
        p64.mtip, long, checkpoint_path=paths["one_card_file"],
        mesh=mesh)(rho64)
    mtips, rho, support, last_err = _sw_inputs(p64)
    n_theta = int(rho.shape[-2])
    sw = {}
    for mode, m in mtips.items():
        got = _shrink_wrap(m.theta_shard(mesh), mesh.local(rho),
                           mesh.local(support),
                           last_err[torch.as_tensor(mesh.rows(4))])
        sw[mode] = mesh.gather({"support": got.numpy()}, name="sw_check",
                               n_theta=n_theta)
    if mesh.rank != 0:
        return None
    return dict(
        sw={k: v["support"] for k, v in sw.items()},
        e32=e32.numpy(), sup32=s32.support.numpy(), e64=e64.numpy(),
        sup64=s64.support.numpy(), rho64=s64.rho.numpy(),
        rank_errors=rank_errors, exchanges=exchanges,
        full=(state_arrays(full[0]), full[1].numpy()),
        resumed=(state_arrays(resumed[0]), resumed[1].numpy()),
        from_one_card=(state_arrays(from_one_card[0]),
                       from_one_card[1].numpy()))


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """The JAX θ run, the port's θ runs and the one-process references."""
    tmp = tmp_path_factory.mktemp("theta_runners")
    j = jax_demo(16, 8)
    r0 = np.array(j.initial_density_batch(0, 4))
    js = _segments(jph, j.mtip.sw.default_sigma)
    s_j, e_j = jmesh.MultiStartRunner(
        j.mtip, js, jmesh.make_mesh({"restarts": 4, "theta": 2}))(r0)
    p64 = make_demo_problem(16, 8, fused_sht=False, real_dtype=F64,
                            device="cpu")
    sigma = p64.mtip.sw.default_sigma
    rho64 = p64.initial_density_batch(0, 4)
    long = _segments(tph, sigma) + _segments(tph, 0.8 * sigma)
    paths = {k: str(tmp / f"{k}.npz") for k in ("ck", "theta_file",
                                                 "one_card_file")}
    tmesh.CheckpointingRunner(p64.mtip, long,
                              checkpoint_path=paths["one_card_file"])(
        rho64, resume=False, max_chunks=1)
    shutil.copy(paths["one_card_file"], str(tmp / "one_card_copy.npz"))
    arrays, config = mtip_arrays(j.mtip)
    got = tmesh.run_ranks(
        tmesh.make_mesh({"restarts": 2, "theta": 2}, ["cpu"] * 4),
        _runner_rank, arrays, config, r0, paths)
    one = tmesh.MultiStartRunner(p64.mtip, _segments(tph, sigma))(rho64)
    return dict(got=got, jax=(s_j, np.asarray(e_j)), one=one,
                p64=p64, rho64=rho64, long=long, paths=paths,
                one_card_copy=str(tmp / "one_card_copy.npz"))


def _supports_equal(want, got):
    """The θ run's final supports (after the shrink-wrap, joined over
    θ) bitwise the reference's: a shrink-wrap reduced over only some of
    the θ rows gives another support, which _series_close alone would
    skip."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    assert np.array_equal(want, got), \
        f"{int((want != got).sum())} of {want.size} support points differ"


def test_theta_runner_float32_matches_jax(runners):
    got, (s_j, e_j) = runners["got"], runners["jax"]
    e_t = got["e32"]
    assert e_t.shape == e_j.shape == (4, 5, 2)
    _supports_equal(s_j.support, got["sup32"])
    np.testing.assert_allclose(e_t[:, 0], e_j[:, 0], rtol=F32_TOL, atol=0)
    # tests/test_parallel.py's bound for its θ mesh against one device
    assert np.allclose(e_t, e_j, rtol=2e-2, atol=1e-5)


def test_theta_runner_float64_matches_one_process(runners):
    got, (s_o, e_o) = runners["got"], runners["one"]
    _supports_equal(s_o.support.numpy(), got["sup64"])
    _series_close(e_o.numpy(), s_o, torch.as_tensor(got["e64"]),
                  s_o._replace(support=torch.as_tensor(got["sup64"])),
                  ITER_TOL, 3)
    assert got["rho64"].shape == tuple(s_o.rho.shape)
    # the analyses and the grid's sums went over the θ group; one gather
    # of the state for each of the two runs
    ex = got["exchanges"]
    assert ex["sht_analysis"]["count"] > 0 and ex["grid_sum"]["count"] > 0
    assert ex["state"]["count"] == 2


def test_theta_ranks_hold_the_same_errors(runners):
    """Each θ rank's own errors bitwise its partner's and the gathered
    run's rows."""
    got = runners["got"]
    errs = got["rank_errors"]
    assert len(errs) == 4
    for g in range(2):
        assert np.array_equal(errs[2 * g], errs[2 * g + 1])
        assert np.array_equal(errs[2 * g], got["e64"][2 * g:2 * g + 2])


@pytest.mark.parametrize("mode", SW_MODES)
def test_theta_shrink_wrap_matches_one_process(runners, mode):
    """One shrink-wrap of the θ shards (the blur's analysis summed over
    the θ ranks, the threshold's max and min reduced over them, or the
    fixed volume on the gathered grid) from a random state, joined over
    θ: bitwise the whole MTIP's support."""
    mtips, rho, support, last_err = _sw_inputs(runners["p64"])
    want = _shrink_wrap(mtips[mode], rho, support, last_err).numpy()
    got = runners["got"]["sw"][mode]
    assert 0 < want.sum() < want.size
    _supports_equal(want, got)


def _same(a, b):
    (sa, ea), (sb, eb) = a, b
    assert np.array_equal(ea, eb)
    for k in ("rho", "support", "best_rho", "best_mask", "best_err"):
        assert np.array_equal(sa[k], sb[k]), k


def test_theta_checkpoint_resumes_bitwise(runners):
    """A θ checkpoint holds the whole grid; the θ resume from it, and from
    a one-card file, equals the uninterrupted θ run bitwise (the one-card
    file's first chunk was computed without θ shards, so that run is held
    to the one-card resume of the same file)."""
    got, paths = runners["got"], runners["paths"]
    _same(got["resumed"], got["full"])
    with np.load(paths["theta_file"]) as ck:
        assert ck["rho"].shape == (4,) + runners["p64"].ft.grid_shape
        assert int(ck["chunk_index"]) == 1
        first = ck["errors"]
    assert np.array_equal(got["full"][1][:, :first.shape[1]], first)
    p64 = runners["p64"]
    one = tmesh.CheckpointingRunner(
        p64.mtip, runners["long"],
        checkpoint_path=runners["one_card_copy"])(runners["rho64"])
    e_o = one[1].numpy()
    e_t = got["from_one_card"][1]
    n0 = first.shape[1]
    assert np.array_equal(e_t[:, :n0], e_o[:, :n0])
    np.testing.assert_allclose(e_t[:, n0], e_o[:, n0], rtol=ITER_TOL, atol=0)


def test_theta_checkpoint_loads_on_one_card(runners):
    got, p64 = runners["got"], runners["p64"]
    path = runners["paths"]["theta_file"]
    with np.load(path) as ck:
        n0 = ck["errors"].shape[1]  # the first chunk's iterations
    state, errs = tmesh.CheckpointingRunner(
        p64.mtip, runners["long"], checkpoint_path=path)(runners["rho64"])
    errs = errs.numpy()
    full = got["full"][1]
    assert errs.shape == full.shape
    assert np.array_equal(errs[:, :n0], full[:, :n0])
    np.testing.assert_allclose(errs[:, n0], full[:, n0], rtol=ITER_TOL,
                               atol=0)
    assert state.rho.dtype == torch.complex128
    assert np.isfinite(errs).all()


# ------------------------------------------------------------ the worker
BASE = {"structure_name": "theta", "dimensions": 3, "particle_radius": 50,
        "grid": {"n_radial_points": 24, "max_order": 10},
        "multi_start": {"n_reconstructions": 2, "seed": 7},
        "mesh": THETA2,
        "main_loop": {"sub_loops": {
            "order": ["main"],
            "main": {"iterations": 1, "order": ["HIO", "SW", "ER"],
                     "methods": {"HIO": {"iterations": 3},
                                 "SW": {"iterations": 1},
                                 "ER": {"iterations": 2}}}}}}
WORKER_RUNS = {
    "float64": {"precision": "float64"},
    "fused_sht_false": {"fourier_transform": {"fused_sht": False}},
    "sw_center_sort_errors": {
        "precision": "float64",
        "main_loop": {
            "sub_loops": {"main": {
                "order": ["HIO", "SW_center", "ER"],
                "methods": {"HIO": {"iterations": 3},
                            "SW_center": {"iterations": 1},
                            "ER": {"iterations": 2}}}},
            "error": {"methods": {
                "reciprocal": {"calculate": ["l2_projection_diff",
                                             "deg2_invariant_l2_diff"]},
                "main": {"metrics": {"real": ["l2_projection_diff"],
                                     "reciprocal": ["l2_projection_diff"]},
                         "type": "max"}}}},
        "projections": {"real": {"shrink_wrap": {
            "mode": "fixed_volume", "fixed_volume": {"method": "sort"}}}}},
    "bucketed_particle_number": {
        "precision": "float64",
        "projections": {
            "real": {"shrink_wrap": {"mode": "fixed_volume",
                                     "fixed_volume": {"method": "bucketed"}}},
            "reciprocal": {"number_of_particles": {"estimate": {
                "apply": True, "estimate_in": ["ER"], "project": True}}}}},
}
JAX_RUNS = ("float64", "fused_sht_false")


def _worker_overrides(name, inv_path=None):
    ov = deep_update(json.loads(json.dumps(BASE)), WORKER_RUNS[name])
    ov["structure_name"] = f"theta_{name}"
    if inv_path is not None:
        ov["input"] = {"invariants_path": inv_path}
    return ov


def _theta_worker_rank(mesh, runs):
    """The reconstruct worker of each run on a rank of the θ mesh
    (module-level: the spawned rank imports it): the worker's run, then
    the first three schedule entries from the run's ρ0 through the mesh's
    MultiStartRunner, and each rank's own errors of them. → on rank 0
    {name: ...}."""
    out = {}
    for name, (ov, r0) in runs.items():
        w = select_worker("fxs", "reconstruct", overrides=ov,
                          device=mesh.device, mesh=mesh)
        res = w.run()
        mtip, ft, _ = w.setup_mtip(w._load_invariants())
        sched = w._build_schedule(ft)[:3]
        runner = tmesh.MultiStartRunner(mtip, sched, mesh=mesh)
        state, errs = runner(torch.as_tensor(r0))
        own = runner.mtip.run_batch(mesh.local(torch.as_tensor(r0)),
                                    sched)[1].numpy()
        ranks = mesh.gather_objects(own)
        if mesh.rank == 0:
            out[name] = dict(res=res, saved=w.saved, errors=errs.numpy(),
                             support=state.support.numpy(),
                             rank_errors=ranks,
                             sharded=runner.mtip.shard.mesh is mesh,
                             launches=w.rank_launches)
    return out if mesh.rank == 0 else None


@pytest.fixture(scope="module")
def worker_runs(tmp_path_factory):
    """Invariants from the float64 demo problem; the JAX worker's θ runs,
    the port's one-process set-ups and the port's θ runs over two ranks."""
    home = str(tmp_path_factory.mktemp("xf_theta_home"))
    old = os.environ.get("XFRAME_TPU_HOME")
    os.environ["XFRAME_TPU_HOME"] = home
    p = make_demo_problem(32, 12, q_max=0.5, fused_sht=False, real_dtype=F64,
                          device="cpu")
    inv = {"data_radial_points": np.asarray(p.ft.qs), "max_order": 12,
           "dimensions": 3,
           "data_projection_matrices": {"I1I1": p.projection_matrices},
           "average_intensity": np.asarray(p.average_intensity),
           "xray_wavelength": 1.23984}
    inv_path = os.path.join(home, "invariants.npz")
    save_invariants(inv, inv_path)
    out, runs = {"inv_path": inv_path, "home": home}, {}
    for name in WORKER_RUNS:
        ov = _worker_overrides(name, inv_path)
        wide = ov.get("precision") == "float64"
        if name in JAX_RUNS:
            with jax.enable_x64(wide):
                jov = dict(ov)
                jov.pop("input")
                xf.select_project("fxs", "reconstruct", overrides=jov)
                jw = JaxWorker()
                jm, jft, jaux = jw.setup_mtip(inv)
                js = jw._build_schedule(jft)[:3]
                r0 = np.array(jaux["initial_density_batch"](7, 2))
                s_j, e_j = jmesh.MultiStartRunner(
                    jm, js, jw._make_mesh(2))(jnp.asarray(r0))
                out[name, "jax"] = (s_j, np.asarray(e_j))
        tw = select_worker("fxs", "reconstruct", overrides=ov, device="cpu")
        tm, tft, taux = tw.setup_mtip(tw._load_invariants())
        ts = tw._build_schedule(tft)[:3]
        if name not in JAX_RUNS:
            r0 = taux["initial_density_batch"](7, 2).numpy()
        out[name, "one"] = tmesh.MultiStartRunner(tm, ts)(torch.as_tensor(r0))
        runs[name] = (ov, r0)
    out["theta"] = tmesh.run_ranks(tmesh.make_mesh(THETA2, CPU2),
                                   _theta_worker_rank, runs)
    out["one_archive"] = select_worker(
        "fxs", "reconstruct", overrides=dict(
            _worker_overrides("float64", inv_path),
            structure_name="theta_one"), device="cpu").run()
    yield out
    if old is None:
        os.environ.pop("XFRAME_TPU_HOME", None)
    else:
        os.environ["XFRAME_TPU_HOME"] = old


@pytest.mark.parametrize("name", JAX_RUNS)
def test_theta_worker_matches_jax(worker_runs, name):
    got = worker_runs["theta"][name]
    s_j, e_j = worker_runs[name, "jax"]
    s_t = worker_runs[name, "one"][0]._replace(
        support=torch.as_tensor(got["support"]))
    wide = name == "float64"
    _supports_equal(s_j.support, got["support"])
    _series_close(e_j, s_j, torch.as_tensor(got["errors"]), s_t,
                  ITER_TOL if wide else F32_TOL, 3)
    assert got["sharded"]
    assert got["errors"].dtype == (np.float64 if wide else np.float32)


@pytest.mark.parametrize("name", sorted(WORKER_RUNS))
def test_theta_worker_matches_one_process(worker_runs, name):
    """The first iteration within 1e-10 (float32: 1e-4) of the one-process
    run from the same ρ0, the rest where the supports agree; the θ ranks'
    errors bitwise equal; no kernel launched."""
    got = worker_runs["theta"][name]
    s_o, e_o = worker_runs[name, "one"]
    wide = name != "fused_sht_false"
    _supports_equal(s_o.support.numpy(), got["support"])
    _series_close(e_o.numpy(), s_o, torch.as_tensor(got["errors"]),
                  s_o._replace(support=torch.as_tensor(got["support"])),
                  ITER_TOL if wide else F32_TOL, 3)
    a, b = got["rank_errors"]
    assert np.array_equal(a, b) and np.array_equal(a, got["errors"])
    assert len(got["launches"]) == 2
    assert not any(sum(c.values()) for c in got["launches"])
    if name == "bucketed_particle_number":
        n_hat = got["errors"][..., 2]
        assert (n_hat[:, :3] == 0).all() and (n_hat[:, 3:] >= 1).all()
    for r in got["res"]["reconstruction_results"].values():
        assert np.isfinite(r["real_density"]).all()


def test_theta_worker_archive_is_the_one_card_archive(worker_runs):
    """The θ worker's float64 archive: the one-process archive's layout
    and dtypes, the initial densities bitwise (drawn whole from the seed),
    the error series within 1e-10 on the first iteration."""
    got = worker_runs["theta"]["float64"]["res"]["reconstruction_results"]
    one = worker_runs["one_archive"]["reconstruction_results"]
    assert _layout(got) == _layout(one)
    by_init = {r["initial_density"].tobytes(): r for r in one.values()}
    for r in got.values():
        o = by_init[r["initial_density"].tobytes()]
        assert r["real_density"].dtype == o["real_density"].dtype \
            == np.complex128
        np.testing.assert_allclose(r["error_dict"]["main"][0],
                                   o["error_dict"]["main"][0],
                                   rtol=ITER_TOL, atol=0)
        assert np.array_equal(r["initial_support"], o["initial_support"])


def test_theta_distributed_cli_matches_the_spawned_mesh(worker_runs,
                                                        tmp_path):
    """Two `--distributed --device cpu` processes with torchrun's
    variables and mesh.theta 2 in float64: rank 0's archive bitwise the
    archive of the same settings over the spawned θ mesh."""
    ov = _worker_overrides("float64", worker_runs["inv_path"])
    path = str(tmp_path / "theta.json")
    with open(path, "w") as f:
        json.dump(ov, f)
    out = _distributed(worker_runs["home"], path)
    assert [o[0] for o in out] == [0, 0], out[1][2] + out[0][2]
    assert "saved to" in out[0][1] and "saved to" not in out[1][1]
    spawned = worker_runs["theta"]["float64"]["saved"][0]
    runs = os.path.dirname(os.path.dirname(spawned))
    latest = os.path.join(runs, sorted(os.listdir(runs))[-1],
                          os.path.basename(spawned))
    a = load_archive(spawned)["reconstruction_results"]
    b = load_archive(latest)["reconstruction_results"]
    assert latest != spawned and _layout(a) == _layout(b)
    for k in a:
        for f in ("real_density", "initial_density", "support_mask",
                  "reciprocal_density"):
            assert np.array_equal(a[k][f], b[k][f]), f
        assert np.array_equal(a[k]["error_dict"]["main"],
                              b[k]["error_dict"]["main"])
