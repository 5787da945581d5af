"""`precision: float64` and `fourier_transform.fused_sht: false` in the port
against the JAX package (CPU). The JAX side runs under x64 (without it JAX
truncates float64 to float32), its Pallas polar kernel in interpret mode.

  * modules in float64: the five SHT functions and the circular transform
    at L = 8, the spherical and polar Hankel transforms, the integrators,
    ShrinkWrap and ReciprocalConstraint under svd and newton_schulz, within
    1e-12 of max; newton_schulz_pallas at L = 64 (2L+1 = 129: the crop
    path) runs B7's plain version on complex64 crops and returns complex128
    W, within the 5e-4 that tests/test_torch_fused_projection.py holds
    float32 polar factors to;
  * make_demo_problem(16, 8) in float64: the port's own tables against the
    JAX problem's within 1e-12, and the JAX MTIP carried across by
    convert.mtip_arrays on HIO 3 + SW + ER 2, the first iteration within
    1e-10 relative, the rest where the supports agree;
  * the reconstruct worker on the JAX chain simulate_ccd → extract at the
    pipeline tests' sizes (3D and 2D), float64 in 3D and 2D and fused_sht
    false at float32: set-up tables within 1e-12 (1e-6 at float32), the
    first iterations from the JAX worker's densities within 1e-10 (1e-4
    at float32), the archive's densities at the JAX state's dtype, and
    the average worker on the float64 archive;
  * a float64 checkpoint resumed equals the uninterrupted run bitwise;
    simulate_ccd under fused_sht false runs the plain transforms and gives
    the kernel path's CC.
"""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import xframe_tpu as xf
from xframe_tpu.ops import hankel as jhankel
from xframe_tpu.ops import integrate as jint
from xframe_tpu.ops import sht as jsht
from xframe_tpu.ops.polar_schedule import DEFAULT_SCHEDULE
from xframe_tpu.projects.fxs import phasing as jph
from xframe_tpu.projects.fxs import projections as jp
from xframe_tpu.projects.fxs.demo import make_demo_problem as jax_demo
from xframe_tpu.projects.fxs.reconstruct import ProjectWorker as JaxWorker

from xframe_tpu_torch.convert import (mtip_arrays, mtip_from_numpy,
                                      save_invariants, state_arrays,
                                      state_from_numpy)
from xframe_tpu_torch.main import run_worker, select_worker
from xframe_tpu_torch.ops import fused_projection
from xframe_tpu_torch.ops import hankel as thankel
from xframe_tpu_torch.ops import integrate as tint
from xframe_tpu_torch.ops import sht as tsht
from xframe_tpu_torch.ops.fused_sht import FusedSHT
from xframe_tpu_torch.parallel import mesh as tmesh
from xframe_tpu_torch.projects.fxs import phasing as tph
from xframe_tpu_torch.projects.fxs import projections as tp
from xframe_tpu_torch.projects.fxs import simulate_ccd as tsim
from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
from xframe_tpu_torch.settings import deep_update

F64 = torch.float64
MODULE_TOL = 1e-12
ITER_TOL = 1e-10
F32_TOL = 1e-4           # the port's bound for float32 against the JAX one
POLAR_TOL = 5e-4         # tests/test_torch_fused_projection.py, float32 W


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=MODULE_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale, \
        np.abs(got - want).max() / scale


def _cplx(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


# ------------------------------------------------------------ modules
def test_sht_float64_matches_jax():
    L, rng = 8, np.random.default_rng(0)
    t = tsht.SphericalHarmonicTransform(L, real_dtype=F64, device="cpu")
    grid, coef = (2, t.n_theta, t.n_phi), (2, t.n_m, L + 1)
    f, fr = _cplx(rng, grid), rng.normal(size=grid)
    c = _cplx(rng, coef) * t.lm_mask
    assert t._P.dtype == t._PW.dtype == F64
    with jax.enable_x64(True):
        j = jsht.SphericalHarmonicTransform(L, real_dtype=jnp.float64)
        want = {"forward": j.forward(jnp.asarray(f)),
                "inverse": j.inverse(jnp.asarray(c)),
                "forward_real": j.forward_real(jnp.asarray(fr)),
                "inverse_real": j.inverse_real(jnp.asarray(c)),
                "forward_real_abs2": j.forward_real(
                    jnp.abs(jnp.asarray(f)) ** 2)}
        want = {k: np.asarray(v) for k, v in want.items()}
        jc = jsht.CircularHarmonicTransform(32, real_dtype=jnp.float64)
        g = _cplx(rng, (3, 32))
        want_c = (np.asarray(jc.forward(jnp.asarray(g))),
                  np.asarray(jc.inverse(jnp.asarray(g))))
    got = {"forward": t.forward(torch.as_tensor(f)),
           "inverse": t.inverse(torch.as_tensor(c)),
           "forward_real": t.forward_real(torch.as_tensor(fr)),
           "inverse_real": t.inverse_real(torch.as_tensor(c)),
           "forward_real_abs2": t.forward_real_abs2(torch.as_tensor(f))}
    for k, v in got.items():
        assert v.dtype == (F64 if k == "inverse_real" else torch.complex128)
        _close(v.numpy(), want[k])
    tc = tsht.CircularHarmonicTransform(32, real_dtype=F64)
    for v, w in zip((tc.forward(torch.as_tensor(g)),
                     tc.inverse(torch.as_tensor(g))), want_c):
        assert v.dtype == torch.complex128
        _close(v.numpy(), w)


@pytest.mark.parametrize("mode", ["midpoint", "trapz"])
def test_hankel_and_integrators_float64(mode):
    L, M, N, rng = 6, 5, 12, np.random.default_rng(1)
    rs, qs, r_max = thankel.radial_grids(mode, 0.4, N, np.pi)
    w3 = thankel.generate_weights(L, N, np.pi, 3, mode)
    w2 = thankel.generate_weights(M, N, np.pi, 2, mode)
    f3, f2 = _cplx(rng, (2, N, 2 * L + 1, L + 1)), _cplx(rng, (2, N,
                                                               2 * M + 1))
    t3 = thankel.SphericalHankelTransform(w3, r_max, np.pi, real_dtype=F64,
                                          device="cpu")
    t2 = thankel.PolarHankelTransform(w2, r_max, np.pi, real_dtype=F64,
                                      device="cpu")
    ts = tint.SphericalIntegrator(rs, 10, 20, real_dtype=F64, device="cpu")
    tpol = tint.PolarIntegrator(rs, 20, real_dtype=F64, device="cpu")
    with jax.enable_x64(True):
        j3 = jhankel.SphericalHankelTransform(w3, r_max, np.pi, jnp.float64)
        j2 = jhankel.PolarHankelTransform(w2, r_max, np.pi, jnp.float64)
        want = [np.asarray(h(jnp.asarray(f))) for h, f in (
            (j3.forward, f3), (j3.inverse, f3), (j2.forward, f2),
            (j2.inverse, f2))]
        js = jint.SphericalIntegrator(rs, 10, 20, real_dtype=jnp.float64)
        jpol = jint.PolarIntegrator(rs, 20, real_dtype=jnp.float64)
    got = [h(torch.as_tensor(f)) for h, f in (
        (t3.forward, f3), (t3.inverse, f3), (t2.forward, f2),
        (t2.inverse, f2))]
    for g, w in zip(got, want):
        assert g.dtype == torch.complex128
        _close(g.numpy(), w)
    assert ts.w_broadcast.dtype == tpol._w.dtype == F64
    _close(ts.w_broadcast.numpy(), js.w_broadcast)
    _close(tpol._w.numpy(), jpol._w)


@pytest.mark.parametrize("mode", ["threshold", "fixed_volume"])
def test_shrink_wrap_float64(mode):
    rng = np.random.default_rng(2)
    qs = np.linspace(0.01, 0.4, 10)
    w = rng.uniform(0.5, 1.5, (10, 6, 12))
    sup = np.ones((10, 6, 12), bool)
    sup[7:] = False
    conv = _cplx(rng, (2, 10, 6, 12))
    kw = dict(mode=mode, integration_weights=w, initial_support=sup)
    t = tp.ShrinkWrap.build(qs, real_dtype=F64, device="cpu", **kw)
    g_t = t.gaussian_values(1.7)
    s_t = t.new_support(torch.as_tensor(conv), 0.3)
    with jax.enable_x64(True):
        j = jp.ShrinkWrap.build(qs, real_dtype=jnp.float64, **kw)
        g_j = np.asarray(j.gaussian_values(jnp.asarray(1.7)))
        s_j = [np.asarray(j.new_support(jnp.asarray(x), 0.3)) for x in conv]
    assert g_t.dtype == t.q_radii.dtype == F64
    _close(g_t.numpy(), g_j)
    assert np.array_equal(s_t.numpy(), np.stack(s_j))


def _constraints(l_max, n_q, method, seed):
    """Both packages' float64 constraints from the same matrices, full rank
    (n_q ≥ 2l+1), and two restarts' Ilm."""
    rng = np.random.default_rng(seed)
    qs = np.linspace(0.05, 1.0, n_q)
    proj = [_cplx(rng, (n_q, min(2 * l + 1, n_q))) for l in range(l_max + 1)]
    kw = dict(use_averaged_intensity=True,
              average_intensity=rng.uniform(0.5, 1.0, n_q), n_particles=2.0,
              schmidt_scaling=False, procrustes_method=method,
              ns_schedule=DEFAULT_SCHEDULE)
    trc = tp.ReciprocalConstraint.build(proj, qs, l_max, real_dtype=F64,
                                        device="cpu", **kw)
    jrc = jp.ReciprocalConstraint.build(proj, qs, l_max,
                                        real_dtype=jnp.float64, **kw)
    n_m = 2 * l_max + 1
    lm = np.arange(l_max + 1)[None, :] \
        >= np.abs(np.arange(-l_max, l_max + 1))[:, None]
    return jrc, trc, _cplx(rng, (2, n_q, n_m, l_max + 1)) * lm


@pytest.mark.parametrize("method", ["svd", "newton_schulz"])
def test_reciprocal_constraint_float64(method):
    with jax.enable_x64(True):
        jrc, trc, ilm = _constraints(4, 12, method, seed=4)
        W_j = [np.asarray(jrc.approximate_unknowns(jnp.asarray(x)))
               for x in ilm]
        P_j = [np.asarray(jrc(jnp.asarray(x))) for x in ilm]
    assert trc.V_pad.dtype == trc.PD.dtype == torch.complex128
    assert trc.eye_diag.dtype == F64
    for name in ("V_pad", "PD", "eye_diag"):
        _close(getattr(trc, name).numpy(), getattr(jrc, name))
    W_t = trc.approximate_unknowns(torch.as_tensor(ilm))
    P_t = trc(torch.as_tensor(ilm))
    assert W_t.dtype == P_t.dtype == torch.complex128
    for r in range(2):
        _close(W_t[r].numpy(), W_j[r])
        _close(P_t[r].numpy(), P_j[r])


def test_newton_schulz_pallas_float64_runs_b7_on_complex64():
    """L = 64: one crop bucket (h = 63) and the full-width order, each crop
    cast to complex64 for B7 (its plain version on the CPU, the JAX
    package's Pallas kernel in interpret mode), W cast back; B8 stays off
    at complex128."""
    with jax.enable_x64(True):
        jrc, trc, ilm = _constraints(64, 131, "newton_schulz_pallas",
                                     seed=5)
        W_j = np.asarray(jrc.approximate_unknowns(jnp.asarray(ilm[0])))
    assert not trc.k5_active and not jrc.k5_active
    fused_projection.reset_launches()
    W_t = trc.approximate_unknowns(torch.as_tensor(ilm[:1]))[0]
    assert W_t.dtype == torch.complex128 and W_j.dtype == np.complex128
    assert np.abs(W_t.numpy() - W_j).max() < POLAR_TOL
    assert fused_projection.launches == dict.fromkeys(
        fused_projection.METHODS, 0)


# ------------------------------------------------------------ the slice
def _segments(mod, sigma):
    return [mod.Segment("HIO", 3, betas=np.full(3, 0.5), ft_stab=True),
            mod.Segment("SW", sigma=sigma, threshold=0.1),
            mod.Segment("ER", 2, betas=np.zeros(2), ft_stab=True)]


def _series_close(e_j, s_j, e_t, s_t, tol, n_head):
    """The first n_head iterations (before the shrink-wrap) within tol
    relative; the rest where both supports agree."""
    e_j, e_t = np.asarray(e_j), e_t.numpy()
    assert e_t.shape == e_j.shape
    np.testing.assert_allclose(e_t[:, :n_head], e_j[:, :n_head], rtol=tol,
                               atol=0)
    same = (np.asarray(s_j.support) == s_t.support.numpy()).reshape(
        len(e_j), -1).all(-1)
    np.testing.assert_allclose(e_t[same], e_j[same], rtol=100 * tol, atol=0)


def test_demo_problem_float64_matches_jax():
    with jax.enable_x64(True):
        j = jax_demo(16, 8, real_dtype=jnp.float64,
                     procrustes_method="newton_schulz",
                     ns_schedule=DEFAULT_SCHEDULE)
        arrays, config = mtip_arrays(j.mtip)
        rho0 = np.array(j.initial_density_batch(0, 2))
        js = _segments(jph, j.mtip.sw.default_sigma)
        s_j, e_j = jax.jit(lambda r: j.mtip.run_batch(r, js))(rho0)
    assert rho0.dtype == np.complex128 and config["precision"] == "float64"
    tm = mtip_from_numpy(arrays, config, "cpu")
    assert tm.rdtype == F64 and tm._fi is None
    assert type(tm.sht) is tsht.SphericalHarmonicTransform
    s_t, e_t = tm.run_batch(torch.as_tensor(rho0),
                            _segments(tph, j.mtip.sw.default_sigma))
    assert s_t.rho.dtype == torch.complex128 and e_t.dtype == F64
    _series_close(e_j, s_j, e_t, s_t, ITER_TOL, 3)

    # the port's own float64 demo problem builds the JAX problem's tables
    t = make_demo_problem(16, 8, procrustes_method="newton_schulz",
                          ns_schedule=DEFAULT_SCHEDULE, real_dtype=F64,
                          device="cpu")
    assert type(t.ft.harmonic) is tsht.SphericalHarmonicTransform
    assert t.mtip._fi is None and t.mtip.rdtype == F64
    for got, name in ((t.ft.sht._P, "sht_P"), (t.ft.sht._PW, "sht_PW"),
                      (t.ft.hankel._wf, "h_wf"), (t.ft.hankel._wi, "h_wi"),
                      (t.mtip._w_rec, "w_rec"), (t.mtip.sw.q_radii,
                                                 "q_radii")):
        assert got.dtype in (F64, torch.complex128), name
        _close(got.numpy(), arrays[name])
    _close(t.bl, j.bl, 1e-10)
    vt, vj = t.mtip.rc.V_pad.numpy(), arrays["V_pad"]
    _close(vt @ vt.conj().transpose(0, 2, 1),
           vj @ vj.conj().transpose(0, 2, 1), 1e-10)
    r0 = t.initial_density_batch(0, 2)
    assert r0.dtype == torch.complex128 and r0.shape == (2,) + \
        t.ft.grid_shape


def test_float64_checkpoint_resume_equals_uninterrupted(tmp_path):
    p = make_demo_problem(8, 4, procrustes_method="newton_schulz",
                          real_dtype=F64, device="cpu")
    sched = _segments(tph, p.mtip.sw.default_sigma) \
        + _segments(tph, 0.8 * p.mtip.sw.default_sigma)
    rho0 = p.initial_density_batch(2, 2)
    full = tmesh.MultiStartRunner(p.mtip, sched)(rho0)
    ck = str(tmp_path / "f64.npz")
    tmesh.CheckpointingRunner(p.mtip, sched, checkpoint_path=ck)(
        rho0, resume=False, max_chunks=1)
    state, errs = tmesh.CheckpointingRunner(p.mtip, sched,
                                            checkpoint_path=ck)(rho0)
    assert state.rho.dtype == torch.complex128 and errs.dtype == F64
    assert torch.equal(errs, full[1])
    for f in ("rho", "best_rho", "best_err", "support"):
        assert torch.equal(getattr(state, f), getattr(full[0], f)), f
    back = state_from_numpy(device="cpu", **state_arrays(state))
    assert back.rho.dtype == torch.complex128 and back.best_err.dtype == F64


# ------------------------------------------------------------ workers
L_SIM, N_SIM, L_REC, N_REC = 14, 48, 10, 24
SIM_3D = {"structure_name": "prec", "dimensions": 3,
          "grid": {"n_radial_points": N_SIM, "max_order": L_SIM,
                   "max_q": 0.5},
          "shapes": {"types": ["sphere", "sphere"],
                     "centers": [[0, 0, 0], [30, 1.2, 0.7]],
                     "sizes": [20, 14], "densities": [1.0, 0.7],
                     "random_orientation": [False, False]},
          "cross_correlation": {"method": "back_substitution",
                                "xray_wavelength": 1.23984}}
SIM_2D = {"structure_name": "prec2d", "dimensions": 2,
          "grid": {"n_radial_points": 48, "max_order": 12, "max_q": 0.5,
                   "n_phi": 64},
          "shapes": {"types": ["sphere", "sphere"],
                     "centers": [[0, 0], [40, 1.0]], "sizes": [22, 15],
                     "densities": [1.0, 0.7],
                     "random_orientation": [False, False]},
          "cross_correlation": {"xray_wavelength": 1.23984}}


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """The JAX chains simulate_ccd → extract in 3D and 2D at the pipeline
    tests' sizes in a temporary XFRAME_TPU_HOME; the invariants also as the
    port's archives."""
    home = str(tmp_path_factory.mktemp("xf_precision_home"))
    old = os.environ.get("XFRAME_TPU_HOME")
    os.environ["XFRAME_TPU_HOME"] = home
    out = {}
    for dim, sim, L in ((3, SIM_3D, L_SIM), (2, SIM_2D, 12)):
        xf.select_project("fxs", "simulate_ccd", overrides=sim)
        xf.run()
        xf.select_project("fxs", "extract", overrides={
            "structure_name": sim["structure_name"], "dimensions": dim,
            "max_order": L})
        inv = xf.run()
        path = os.path.join(home, f"invariants_{dim}d.npz")
        save_invariants(inv, path)
        out[dim] = (inv, path)
    yield out
    if old is None:
        os.environ.pop("XFRAME_TPU_HOME", None)
    else:
        os.environ["XFRAME_TPU_HOME"] = old


def _overrides(dim, extra, inv_path=None):
    ov = {"structure_name": f"prec{dim}", "dimensions": dim,
          "particle_radius": 50 if dim == 3 else 60,
          "grid": {"n_radial_points": N_REC if dim == 3 else 32,
                   "max_order": L_REC, **({} if dim == 3 else
                                          {"n_phi": 64})},
          "multi_start": {"n_reconstructions": 2, "seed": 7},
          "main_loop": {"sub_loops": {
              "order": ["main"],
              "main": {"iterations": 1, "order": ["HIO", "SW", "ER"],
                       "methods": {"HIO": {"iterations": 3},
                                   "SW": {"iterations": 1},
                                   "ER": {"iterations": 2}}}}}}
    if inv_path is not None:
        ov["input"] = {"invariants_path": inv_path}
    return deep_update(ov, extra)


WORKER_RUNS = {
    "float64": (3, {"precision": "float64"}),
    "float64_2d": (2, {"precision": "float64"}),
    "fused_sht_false": (3, {"fourier_transform": {"fused_sht": False}}),
}


@pytest.mark.parametrize("name", sorted(WORKER_RUNS))
def test_worker_matches_jax(chains, name, capsys):
    dim, extra = WORKER_RUNS[name]
    inv, path = chains[dim]
    wide = extra.get("precision") == "float64"
    with jax.enable_x64(wide):
        xf.select_project("fxs", "reconstruct",
                          overrides=_overrides(dim, extra))
        jw = JaxWorker()
        jm, jft, jaux = jw.setup_mtip(inv)
        js = jw._build_schedule(jft)
        arrays, _ = mtip_arrays(jm)
        rho0 = np.array(jaux["initial_density_batch"](7, 2))
        s_j, e_j = jax.jit(lambda r: jm.run_batch(r, js[:3]))(rho0)
    tw = select_worker("fxs", "reconstruct",
                       overrides=_overrides(dim, extra, path), device="cpu")
    tm, tft, taux = tw.setup_mtip(tw._load_invariants())
    ts = tw._build_schedule(tft)
    warned = "precision float64 requested" in capsys.readouterr().out
    assert warned == (wide and dim == 3)
    assert tm.rdtype == (F64 if wide else torch.float32)
    assert tm._fi is None and not isinstance(tm.sht, FusedSHT)
    assert [(a.method, a.n) for a in ts] == [(b.method, b.n) for b in js]
    tol = MODULE_TOL if wide else 1e-6
    assert abs(taux["data_scale"] - jaux["data_scale"]) \
        <= tol * jaux["data_scale"]
    assert np.array_equal(np.asarray(taux["initial_support"]),
                          np.asarray(jaux["initial_support"]))
    tables = {"h_wf": tft.hankel._wf, "h_wi": tft.hankel._wi,
              "w_rec": tm._w_rec}
    tables.update({"V": tm.rc.V, "VD": tm.rc.VD} if dim == 2 else
                  {"V_pad": tm.rc.V_pad, "PD": tm.rc.PD,
                   "sht_P": tft.sht._P, "sht_PW": tft.sht._PW})
    for k, v in tables.items():
        assert v.dtype in ((F64, torch.complex128) if wide
                           else (torch.float32, torch.complex64)), k
        _close(v.numpy(), arrays[k], tol)
    s_t, e_t = tm.run_batch(torch.as_tensor(rho0), ts[:3])
    _series_close(e_j, s_j, e_t, s_t, ITER_TOL if wide else F32_TOL, 3)

    if name != "fused_sht_false":
        # the archive keeps the JAX state's dtype; the average worker reads
        # it and casts to complex64, as the JAX one does
        res = tw.run()
        saved = tw.saved[0]
        for r in res["reconstruction_results"].values():
            assert r["real_density"].dtype == np.asarray(s_j.rho).dtype
        from xframe_tpu_torch.projects.fxs.store import load_archive
        back = load_archive(saved)["reconstruction_results"]["0"]
        assert back["real_density"].dtype == np.complex128
        avg = run_worker("fxs", "average", overrides={
            "structure_name": f"prec{dim}", "reconstruction_files": [saved],
            "selection": {"error_limit": 10.0}, "l2_error_limit": 10.0},
            device="cpu")
        assert np.isfinite(avg["average"]["real_density"]).all()


def test_simulate_fused_sht_false_runs_plain_transforms(tmp_path,
                                                        monkeypatch):
    """fused_sht false builds the FT on the plain transforms (the CUDA
    path too: no refusal); on the CPU its CC equals the kernel path's."""
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    seen, inner = [], tsim.intensity_coefficients

    def spy(ft, density):
        seen.append(ft.harmonic)
        return inner(ft, density)
    monkeypatch.setattr(tsim, "intensity_coefficients", spy)
    ov = {"structure_name": "plain", "grid": {"n_radial_points": 16,
                                              "max_order": 6, "max_q": 0.5},
          "shapes": {"types": ["sphere"], "centers": [[0, 0, 0]],
                     "sizes": [20], "densities": [1.0]}}
    ccs = [run_worker("fxs", "simulate_ccd", overrides=deep_update(
        ov, {"fourier_transform": {"fused_sht": fs}}),
        device="cpu")["cross_correlation"]["I1I1"] for fs in (False, True)]
    assert type(seen[0]) is tsht.SphericalHarmonicTransform
    assert isinstance(seen[1], FusedSHT)
    assert np.array_equal(ccs[0], ccs[1])
