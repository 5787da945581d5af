"""The port's numpy copies of host table builders equal the JAX package's.

xframe_tpu_torch carries copies because importing xframe_tpu pulls in jax
and PyYAML; these tests keep the copies equal to the originals (≤1e-12).
"""
import numpy as np
import pytest
import torch

from xframe_tpu.library import legendre as jleg
from xframe_tpu.library import shapes as jshapes
from xframe_tpu.library import ramps as jramps
from xframe_tpu.ops import hankel as jhankel
from xframe_tpu.ops import polar_schedule as jpolar
from xframe_tpu.projects.fxs import invariants as jinv

from xframe_tpu_torch.library import legendre as tleg
from xframe_tpu_torch.library import shapes as tshapes
from xframe_tpu_torch.library import ramps as tramps
from xframe_tpu_torch.ops import hankel as thankel
from xframe_tpu_torch.ops import polar_schedule as tpolar
from xframe_tpu_torch.projects.fxs import invariants as tinv

TOL = 1e-12


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= TOL * max(np.abs(b).max(initial=0.0), 1.0)


@pytest.mark.parametrize("n", [8, 24, 33])
def test_gauss_legendre(n):
    for want, got in zip(jleg.gauss_legendre(n, 0.0, 2.5),
                         tleg.gauss_legendre(n, 0.0, 2.5)):
        _close(got, want)


@pytest.mark.parametrize("l_max", [0, 4, 10])
def test_legendre_tables(l_max):
    x, _ = jleg.gauss_legendre(2 * l_max + 6)
    _close(tleg.sph_legendre_table(l_max, x), jleg.sph_legendre_table(l_max, x))
    _close(tleg.sph_legendre_table_full_m(l_max, x),
           jleg.sph_legendre_table_full_m(l_max, x))


@pytest.mark.parametrize("mode", ["midpoint", "trapz", "gauss", "Zernike"])
def test_hankel_weights(mode):
    L, N, rc = 8, 16, 2.0
    for want, got in zip(jhankel.radial_grids(mode, 0.4, N, rc),
                         thankel.radial_grids(mode, 0.4, N, rc)):
        _close(got, want)
    wj = jhankel.generate_weights(L, N, rc, 3, mode)
    wt = thankel.generate_weights(L, N, rc, 3, mode)
    _close(wt["weights"], wj["weights"])
    r_max = jhankel.radial_grids(mode, 0.4, N, rc)[2]
    aj = jhankel.assemble_weights(wj["weights"], r_max, rc, 3, mode)
    at = thankel.assemble_weights(wt["weights"], r_max, rc, 3, mode)
    _close(at["forward"], aj["forward"])
    _close(at["inverse"], aj["inverse"])


def test_spherical_bessel_table():
    z = np.concatenate([[0.0], np.geomspace(1e-6, 120.0, 400)])
    _close(thankel.spherical_jn_all(40, z), jhankel.spherical_jn_all(40, z))


def test_default_polar_schedule():
    assert tpolar.DEFAULT_SCHEDULE == jpolar.DEFAULT_SCHEDULE


@pytest.mark.parametrize("sigma_min", [1e-5, 1e-3])
def test_polar_schedule_generator(sigma_min):
    """The linear programs' schedule, a step's minimax quintic and the
    dispatch of default_or_computed_schedule equal the JAX package's."""
    assert tpolar._minimax_quintic(sigma_min, 1.02) \
        == jpolar._minimax_quintic(sigma_min, 1.02)
    assert tpolar.polar_express_schedule(sigma_min) \
        == jpolar.polar_express_schedule(sigma_min)
    assert tpolar.default_or_computed_schedule(sigma_min) \
        == jpolar.default_or_computed_schedule(sigma_min)


def test_shapes():
    rs = np.linspace(0.1, 3.0, 7)
    th = np.linspace(0.1, 3.0, 5)
    ph = np.linspace(0.0, 6.0, 9)
    grid = jshapes.spherical_grid(rs, th, ph)
    _close(tshapes.spherical_grid(rs, th, ph), grid)
    _close(tshapes.spherical_to_cartesian(grid),
           jshapes.spherical_to_cartesian(grid))
    _close(tshapes.ball_density(grid, 1.2, center=(0.8, 1.2, 0.7), amplitude=0.7),
           jshapes.ball_density(grid, 1.2, center=(0.8, 1.2, 0.7), amplitude=0.7))
    x = np.linspace(-2, 2, 41)
    _close(tshapes.get_test_function([-1.5, 1.5], 0.3)(x),
           jshapes.get_test_function([-1.5, 1.5], 0.3)(x))


@pytest.mark.parametrize("spec", [(0.5, 0.5, -1 / 700, 1600),
                                  (0.9, 0.5, 0.01, 100), (0.1, 0.6, 0.02, 50)])
def test_ramps(spec):
    x = np.arange(0, 200, 7)
    _close(tramps.ExponentialRamp(*spec)(x), jramps.ExponentialRamp(*spec)(x))
    for args in ([spec[0], [spec[1], 40]], [spec[0], False, 0.01],
                 [[spec[0], 3]]):
        lj, lt = jramps.LinearRamp(*args), tramps.LinearRamp(*args)
        _close([lt(v) for v in x], [lj(v) for v in x])


def test_invariants():
    rng = np.random.default_rng(3)
    n_q, L = 10, 6
    coeff = (rng.normal(size=(n_q, 2 * L + 1, L + 1))
             + 1j * rng.normal(size=(n_q, 2 * L + 1, L + 1)))
    bl = jinv.harmonic_coeff_to_deg2_invariants_3d(coeff)
    _close(tinv.harmonic_coeff_to_deg2_invariants_3d(coeff), bl)
    bl = bl.real.astype(complex)
    bl[1::2] = 0
    pj, ej = jinv.deg2_invariant_to_projection_matrices(bl)
    pt, et = tinv.deg2_invariant_to_projection_matrices(torch.as_tensor(bl))
    # V_l is fixed up to a phase per column (the LAPACK builds differ)
    for a, b in zip(pt, pj):
        a = a.numpy()
        _close(a @ a.conj().T, b @ b.conj().T)
    for a, b in zip(et, ej):
        _close(a, b)


@pytest.mark.parametrize("sort_mode", [0, 1])
def test_invariants_2d(sort_mode):
    """The 2D functions (torch float64) against the JAX package's numpy:
    B_m, CC synthesis, CC → B_m and the rank-1 vectors (compared as
    v_m v_m†, the eigenvector phase is free)."""
    rng = np.random.default_rng(4)
    n_q, M, n_phi = 10, 6, 16
    coeff = rng.normal(size=(n_q, M + 1)) + 1j * rng.normal(size=(n_q, M + 1))
    bm = jinv.harmonic_coeff_to_deg2_invariants_2d(coeff)
    _close(tinv.harmonic_coeff_to_deg2_invariants_2d(
        torch.as_tensor(coeff)).numpy(), bm)
    bm[1::2] = 0
    cc = jinv.deg2_invariant_to_cc_2d(bm, n_phi=n_phi)
    _close(tinv.deg2_invariant_to_cc_2d(torch.as_tensor(bm),
                                        n_phi=n_phi).numpy(), cc)
    _close(tinv.cc_to_deg2_invariant_2d(torch.as_tensor(cc), M).numpy(),
           jinv.cc_to_deg2_invariant_2d(cc, M))
    noisy = bm + 0.05 * np.eye(n_q)
    vj, ej = jinv.deg2_invariant_to_projection_vectors_2d(noisy, sort_mode)
    vt, et = tinv.deg2_invariant_to_projection_vectors_2d(
        torch.as_tensor(noisy), sort_mode)
    _close(et.numpy(), ej)
    for a, b in zip(vt.numpy(), vj):
        _close(np.outer(a, a.conj()), np.outer(b, b.conj()))


def test_polar_grid_and_orientation_fix():
    rs, phis = np.linspace(0.5, 3.0, 6), 2 * np.pi * np.arange(8) / 8
    grid = jshapes.polar_grid(rs, phis)
    _close(tshapes.polar_grid(rs, phis), grid)
    _close(tshapes.spherical_to_cartesian(grid),
           jshapes.spherical_to_cartesian(grid))
    from xframe_tpu.projects.fxs import reconstruct as jrec_
    from xframe_tpu_torch.projects.fxs import reconstruct as trec_
    rng = np.random.default_rng(5)
    M, n_q = 12, 9
    qs = np.linspace(0.01, 0.3, n_q)
    for _ in range(5):
        unknowns = np.exp(1j * rng.uniform(-np.pi, np.pi, M + 1))
        proj = [rng.normal(size=(n_q, 1)) for _ in range(M + 1)]
        phi0 = jrec_.so2_residual_rotation_phase(unknowns, proj, qs)
        assert trec_.so2_residual_rotation_phase(unknowns, proj, qs) == phi0
    arr = rng.normal(size=(n_q, 16)) + 1j * rng.normal(size=(n_q, 16))
    _close(trec_.rotate_polar_density(arr, 0.7),
           jrec_.rotate_polar_density(arr, 0.7))


@pytest.mark.parametrize("l_max", [0, 3, 9])
def test_wigner_tables(l_max):
    from xframe_tpu.ops import so3 as jso3
    from xframe_tpu_torch.ops import so3 as tso3
    betas = np.linspace(0.05, 3.1, 6)
    for want, got in zip(jso3.wigner_d_blocks(l_max, betas),
                         tso3.wigner_d_blocks(l_max, betas)):
        _close(got, want)
    _close(tso3.wigner_d_padded(l_max, betas),
           jso3.wigner_d_padded(l_max, betas))
    _close(tso3.wigner_D_single(l_max, 0.3, 1.9, -2.2),
           jso3.wigner_D_single(l_max, 0.3, 1.9, -2.2))
    for want, got in zip(jso3.so3_grid(l_max + 1), tso3.so3_grid(l_max + 1)):
        _close(got, want)


@pytest.mark.parametrize("name,size", [("ball", 1.1), ("cube", 1.4),
                                       ("cube", (1.4, 0.9, 2.0)),
                                       ("tetrahedron", 1.6)])
@pytest.mark.parametrize("rotated", [False, True])
def test_shape_builders(name, size, rotated):
    rs = np.linspace(0.1, 2.0, 9)
    grid = jshapes.spherical_grid(rs, np.linspace(0.1, 3.0, 7),
                                  np.linspace(0.0, 6.0, 11))
    kw = dict(center=(0.4, 1.0, 2.0), amplitude=0.6,
              random_orientation=rotated)
    want = jshapes.SHAPE_BUILDERS[name](grid, size,
                                        rng=np.random.default_rng(5), **kw)
    got = tshapes.SHAPE_BUILDERS[name](grid, size,
                                       rng=np.random.default_rng(5), **kw)
    _close(got, want)
    assert 0 < (want > 0).sum() < want.size


@pytest.mark.parametrize("dim", [2, 3])
def test_cartesian_to_spherical(dim):
    pts = np.random.default_rng(6).normal(size=(40, dim))
    pts[0] = 0.0
    _close(tshapes.cartesian_to_spherical(pts),
           jshapes.cartesian_to_spherical(pts))


@pytest.mark.parametrize("shapes_opt", [
    dict(types=["sphere", "sphere"],
         centers=[(0.5, 1.2, 0.7), (0.45, 2.1, 3.9)],
         sizes=[0.4, 0.33], densities=[1.0, 0.7]),
    dict(types=["cube", "tetrahedron", "ball"],
         centers=[(0.3, 0.5, 1.0), (0.6, 2.0, 4.0), (0.0, 0.0, 0.0)],
         sizes=[0.6, 0.7, [0.2]], densities=[1.0, 0.5, 2.0],
         random_orientation=[True, True, False]),
])
def test_build_density_from_shapes(shapes_opt):
    from xframe_tpu.projects.fxs import simulate_ccd as jsim
    from xframe_tpu_torch.projects.fxs import simulate_ccd as tsim
    grid = jshapes.spherical_grid(np.linspace(0.02, 1.2, 12),
                                  np.linspace(0.1, 3.0, 9),
                                  np.linspace(0.0, 6.0, 16))
    want = jsim.build_density_from_shapes(grid, shapes_opt,
                                          rng=np.random.default_rng(8))
    got = tsim.build_density_from_shapes(grid, shapes_opt,
                                         rng=np.random.default_rng(8))
    _close(got, want)
    assert (want > 0).any()


@pytest.mark.parametrize("rotated", [False, True])
def test_build_density_from_shapes_2d(rotated):
    """Polar grids: (r, φ) centers, a 3-coordinate center read as
    (c[0], c[2]), a randomly rotated cube."""
    from xframe_tpu.projects.fxs import simulate_ccd as jsim
    from xframe_tpu_torch.projects.fxs import simulate_ccd as tsim
    opts = dict(types=["sphere", "cube", "sphere"],
                centers=[(0.5, 0.7), (0.45, 3.9), (0.3, 0.0, 1.0)],
                sizes=[0.4, 0.33, 0.2], densities=[1.0, 0.7, 0.5],
                random_orientation=[False, rotated, False])
    grid = jshapes.polar_grid(np.linspace(0.02, 1.2, 12),
                              np.linspace(0.0, 6.0, 16))
    want = jsim.build_density_from_shapes(grid, opts,
                                          rng=np.random.default_rng(8))
    got = tsim.build_density_from_shapes(grid, opts,
                                         rng=np.random.default_rng(8))
    _close(got, want)
    assert 0 < (want > 0).sum() < want.size


# ------------------------------------------------------------ the workers
from types import SimpleNamespace  # noqa: E402

from xframe_tpu.projects.fxs import average as javg  # noqa: E402
from xframe_tpu.projects.fxs import reconstruct as jrec  # noqa: E402
from xframe_tpu.projects.fxs import resolution_metrics as jrm  # noqa: E402
from xframe_tpu.settings.tools import DictNamespace  # noqa: E402

from xframe_tpu_torch.projects.fxs import average as tavg  # noqa: E402
from xframe_tpu_torch.projects.fxs import reconstruct as trec  # noqa: E402
from xframe_tpu_torch.projects.fxs import \
    resolution_metrics as trm  # noqa: E402
from xframe_tpu_torch.settings import load_settings  # noqa: E402


def _proj(rng, n_q, L, cols=None):
    return [rng.normal(size=(n_q, cols or min(2 * l + 1, n_q)))
            + 1j * rng.normal(size=(n_q, cols or min(2 * l + 1, n_q)))
            for l in range(L + 1)]


@pytest.mark.parametrize("interp", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize("complex_data", [False, True])
def test_interp_radial(interp, complex_data):
    rng = np.random.default_rng(11)
    qs_data = np.sort(rng.uniform(0.05, 1.0, 17))
    qs_new = np.linspace(0.0, 1.1, 23)
    y = rng.normal(size=(17, 3, 2))
    if complex_data:
        y = y + 1j * rng.normal(size=y.shape)
    _close(trec._interp_radial(y, qs_data, qs_new, interp),
           jrec._interp_radial(y, qs_data, qs_new, interp))
    _close(trec._interp_radial(y, qs_data, qs_data, interp),
           jrec._interp_radial(y, qs_data, qs_data, interp))


@pytest.mark.parametrize("interp", ["nearest", "linear", "cubic"])
def test_regrid_projection_matrices_and_pad(interp):
    rng = np.random.default_rng(12)
    qs_data = np.linspace(0.05, 1.0, 9)
    qs_new = np.linspace(0.0, 1.05, 12)
    proj = _proj(rng, 9, 5)
    want = jrec.regrid_projection_matrices(proj, qs_data, qs_new, interp)
    got = trec.regrid_projection_matrices(proj, qs_data, qs_new, interp)
    for a, b in zip(got, want):
        _close(a, b)
    _close(trec.pad_coeff_dense(got, 12, 4), jrec.pad_coeff_dense(want, 12, 4))
    _close(trec.pad_coeff_dense(got, 12, 7), jrec.pad_coeff_dense(want, 12, 7))


@pytest.mark.parametrize("ropt", [{}, {"ns_coefficients": "minimax"},
                                  {"ns_coefficients": "fixed"}])
def test_resolve_ns_schedule(ropt):
    assert trec._resolve_ns_schedule(ropt) == \
        jrec._resolve_ns_schedule(ropt)


Q_MASKS = [
    {"type": "none"},
    {"type": "manual", "manual": {"type": "region", "region": [0.2, 0.7]}},
    {"type": "manual", "manual": {"type": "region", "region": [False, 0.5]}},
    {"type": "manual", "region": [0.3, False]},
    {"type": "manual", "manual": {"type": "order_dependent_line",
                                  "order_dependent_line": [[2, 0.1],
                                                           [8, 0.6]]}},
    {"type": "from_projection_matrices"},
    {"type": "from_invariants"},
]


@pytest.mark.parametrize("qm", Q_MASKS)
@pytest.mark.parametrize("with_data", [False, True])
def test_radial_mask(qm, with_data):
    L = 8
    qs = np.linspace(0.0, 1.0, 15)
    qs_data = np.linspace(0.1, 0.9, 11) if with_data else None
    lims = np.stack([np.arange(L + 1) % 3, 11 - np.arange(L + 1)], axis=1) \
        if with_data else None
    ropt = {"q_mask": qm}
    want = jrec.ProjectWorker._radial_mask(None, ropt, L, qs,
                                           qs_data=qs_data, q_id_limits=lims)
    got = trec._radial_mask(ropt, L, qs, qs_data=qs_data, q_id_limits=lims)
    assert (got is None) == (want is None)
    if want is not None:
        assert np.array_equal(got, want)


ERROR_METHODS = [
    {},
    {"real": {"calculate": ["l2_projection_diff"],
              "l2_projection_diff": {"inside_initial_support": False}},
     "reciprocal": {"calculate": ["deg2_invariant_l2_diff"],
                    "deg2_invariant_l2_diff": {"order": 4}},
     "main": {"metrics": {"real": ["l2_projection_diff"],
                          "reciprocal": ["deg2_invariant_l2_diff"]},
              "type": "max"}},
]
PIPELINE_LOOPS = {"sub_loops": {
    "order": ["main", "refinement"],
    "main": {"iterations": 2, "order": ["HIO", "SW", "ER"],
             "methods": {"HIO": {"iterations": 15}, "SW": {"iterations": 1},
                         "ER": {"iterations": 10}}},
    "refinement": {"iterations": 1, "order": ["SW_center", "ER"],
                   "methods": {"SW_center": {"iterations": 1},
                               "ER": {"iterations": 15}}}}}


@pytest.mark.parametrize("methods", ERROR_METHODS)
def test_error_config(methods):
    s = load_settings("reconstruct", None,
                      {"main_loop": {"error": {"methods": methods}}})
    assert trec._error_config(s) == \
        jrec.ProjectWorker._error_config(None, DictNamespace(s))


@pytest.mark.parametrize("name,overrides", [
    (None, None), ("tutorial", None), (None, {"main_loop": PIPELINE_LOOPS})])
def test_build_schedule(name, overrides):
    s = load_settings("reconstruct", name, overrides)
    ft = SimpleNamespace(rs=np.linspace(0.0, 40.0, 21))
    want = jrec.ProjectWorker._build_schedule(
        SimpleNamespace(settings=DictNamespace(s)), ft)
    got = trec._build_schedule(s, ft)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.method, a.n, a.ft_stab, a.sigma, a.threshold,
                a.ft_stab_link_delay) == (b.method, b.n, b.ft_stab, b.sigma,
                                          b.threshold, b.ft_stab_link_delay)
        if b.betas is not None:
            assert np.array_equal(a.betas, b.betas)


def test_projection_matrices_to_deg2_invariant_3d():
    proj = _proj(np.random.default_rng(13), 7, 6)
    _close(tinv.projection_matrices_to_deg2_invariant_3d(proj),
           jinv.projection_matrices_to_deg2_invariant_3d(proj))


def _metric_inputs(rng):
    shape = (6, 5, 8)
    cx = lambda *s: rng.normal(size=s) + 1j * rng.normal(size=s)  # noqa: E731
    return dict(psis=cx(4, *shape), a=cx(*shape), b=cx(*shape),
                i1=rng.uniform(0.1, 2.0, shape),
                i2=rng.uniform(0.1, 2.0, shape),
                w=rng.uniform(0.1, 1.0, 5), cc=rng.normal(size=(6, 6, 16)),
                cc2=rng.normal(size=(6, 6, 16)), b1=cx(7, 6, 6),
                b2=cx(7, 6, 6))


METRIC_CASES = {
    "prtf": lambda m, x: m.prtf(x["psis"], theta_weights=x["w"]),
    "prtf_polar": lambda m, x: m.prtf(x["psis"][..., 0, :], axes=(-1,)),
    "prtf_resolution": lambda m, x: m.prtf_resolution(
        np.linspace(1.0, 0.1, 6), np.linspace(0.1, 0.6, 6)),
    "prtf_fxs": lambda m, x: m.prtf_fxs(x["a"], x["i1"]),
    "prtf_fxs_cross": lambda m, x: m.prtf_fxs(x["a"], x["i1"], x["b"],
                                              x["i2"]),
    "fsc": lambda m, x: m.fsc(x["a"], x["b"], x["w"]),
    "half_bit_threshold": lambda m, x: m.half_bit_threshold(
        np.arange(1, 20)),
    "fqc": lambda m, x: m.fqc(x["cc"], x["cc2"], skip_odd_orders=True),
    "fqcb": lambda m, x: m.fqcb(x["b1"], x["b2"], skip_odd_orders=True,
                                include_zero_order=True),
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_resolution_metrics(case):
    x = _metric_inputs(np.random.default_rng(14))
    want, got = METRIC_CASES[case](jrm, x), METRIC_CASES[case](trm, x)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            _close(a, b)


def _recs(rng):
    """Two files of reconstructions with errors, densities and masks."""
    recs = []
    for f in range(2):
        res = {}
        for k in range(3):
            rho = rng.normal(size=(4, 3, 5)) * (1 + k + 2 * f)
            res[str(k)] = {
                "real_density": rho + 0j,
                "reciprocal_density": rho * 1j,
                "support_mask": rho > 0,
                "error_dict": {"final": float(rng.uniform(0, 1)),
                               "main": rng.uniform(0, 1, 5)}}
        recs.append({"reconstruction_results": res,
                     "projection_matrices": _proj(rng, 4, 3)})
    return recs


SELECTIONS = [
    {},
    {"error_limit": 0.5},
    {"n_reconstructions": 3, "error_metric": "main"},
    {"max_density_range": [2.0, False]},
    {"method": "manual", "manual_ids": [0, 2]},
    {"method": "manual", "manual_specifier": [1, "2"], "error_limit": 2.0},
]


@pytest.mark.parametrize("sel", SELECTIONS)
def test_select_and_averaged_projection_matrices(sel):
    recs = _recs(np.random.default_rng(15))
    settings = {"selection": sel}
    want = javg.ProjectWorker._select(SimpleNamespace(settings=settings),
                                      recs)
    got = tavg.ProjectWorker._select(SimpleNamespace(settings=settings),
                                     recs)
    dens, psis, errs, meta, masks = want
    assert got[2] == errs and got[3] == meta
    for i in (0, 1, 4):
        assert len(got[i]) == len(want[i])
        for a, b in zip(got[i], want[i]):
            assert np.array_equal(a, b)
    if not dens:
        return
    scales = np.linspace(0.5, 2.0, len(meta))
    pj = javg.ProjectWorker._averaged_projection_matrices(
        [r["projection_matrices"] for r in recs], meta[1:], scales, meta)
    pt = tavg.ProjectWorker._averaged_projection_matrices(
        [r["projection_matrices"] for r in recs], meta[1:], scales, meta)
    assert (pt is None) == (pj is None)
    for a, b in zip(pt or [], pj or []):
        _close(a, b)


# ------------------------------------------- physics, Legendre, PDB and maps
def test_physics():
    from xframe_tpu.library import physics as jphys
    from xframe_tpu_torch.library import physics as tphys
    qs = np.linspace(0.0, 0.9, 17)
    _close(tphys.ewald_sphere_theta_pi(1.23984, qs),
           jphys.ewald_sphere_theta_pi(1.23984, qs))
    th = np.linspace(0.3, 1.5, 9)
    _close(tphys.ewald_sphere_q_pi(1.23984, th),
           jphys.ewald_sphere_q_pi(1.23984, th))
    _close(tphys.scattering_angle_to_reciprocal_radii(th, 2.0),
           jphys.scattering_angle_to_reciprocal_radii(th, 2.0))
    assert tphys.energy_to_wavelength(9500.0) == \
        jphys.energy_to_wavelength(9500.0)
    _close(tphys.spherical_formfactor(qs, 50.0),
           jphys.spherical_formfactor(qs, 50.0))
    pix = np.random.default_rng(2).normal(size=(5, 4, 3)) + [0, 0, 3.0]
    _close(tphys.pixel_grid_to_scattering_grid(pix, 1.5),
           jphys.pixel_grid_to_scattering_grid(pix, 1.5))


@pytest.mark.parametrize("l_max", [0, 1, 9, 40])
def test_legendre_poly_table(l_max):
    x = np.random.default_rng(3).uniform(-1, 1, size=(7, 5))
    got = tleg.legendre_poly_table(l_max, x)
    assert got.shape == (7, 5, l_max + 1)
    np.testing.assert_array_equal(got, jleg.legendre_poly_table(l_max, x))


def _pdb_file(path, gz=False):
    import gzip
    rng = np.random.default_rng(10)
    lines = []
    for i, (x, y, z) in enumerate(rng.uniform(-8, 8, size=(20, 3))):
        elem = ("C", "N", "O", "FE", "")[i % 5]
        name = "CA" if not elem else elem
        record = "HETATM" if i % 7 == 0 else "ATOM  "
        occ = f"{0.5 + (i % 3) / 4:6.2f}" if i % 4 else "      "
        lines.append(f"{record}{i + 1:5d} {name:<4s} ALA A{i + 1:4d}    "
                     f"{x:8.3f}{y:8.3f}{z:8.3f}{occ}{20.0:6.2f}"
                     f"          {elem:>2s}\n")
    lines.append("TER\nEND\n")
    with (gzip.open if gz else open)(path, "wt") as f:
        f.writelines(lines)


@pytest.mark.parametrize("gz", [False, True])
def test_pdb(tmp_path, gz):
    from xframe_tpu.library import pdb as jpdb
    from xframe_tpu_torch.library import pdb as tpdb
    path = str(tmp_path / ("m.pdb.gz" if gz else "m.pdb"))
    _pdb_file(path, gz)
    for a, b in zip(tpdb.parse_pdb(path), jpdb.parse_pdb(path)):
        np.testing.assert_array_equal(a, b)
    cart = np.random.default_rng(1).uniform(-10, 10, size=(6, 5, 3))
    for kw in ({}, {"resolution": 2.5, "center": False, "chunk_atoms": 7}):
        _close(tpdb.pdb_density(path, cart, **kw),
               jpdb.pdb_density(path, cart, **kw))


@pytest.mark.parametrize("cell,mapcrs,origin", [
    ((30.0, 26.0, 34.0, 90.0, 90.0, 90.0), (1, 2, 3), None),
    ((30.0, 26.0, 34.0, 90.0, 90.0, 90.0), (3, 1, 2), (1.5, -2.0, 0.5)),
    ((30.0, 26.0, 34.0, 80.0, 95.0, 110.0), (2, 3, 1), None),
])
def test_ccp4_maps(tmp_path, cell, mapcrs, origin):
    from xframe_tpu.library import pdb as jpdb
    from xframe_tpu_torch.library import pdb as tpdb
    rng = np.random.default_rng(6)
    density = rng.uniform(0, 1, (10, 8, 12))
    pj, pt = str(tmp_path / "j.ccp4"), str(tmp_path / "t.ccp4")
    jpdb.write_ccp4(pj, density, cell, mapcrs=mapcrs, crs_start=(2, 1, 3),
                    origin=origin)
    tpdb.write_ccp4(pt, density, cell, mapcrs=mapcrs, crs_start=(2, 1, 3),
                    origin=origin)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    mj, mt = jpdb.read_ccp4(pj), tpdb.read_ccp4(pt)
    np.testing.assert_array_equal(mt.density, mj.density)
    _close(mt.origin, mj.origin)
    _close(mt.center_of_mass_xyz(), mj.center_of_mass_xyz())
    crs = rng.integers(0, 8, size=(9, 3))
    _close(mt.crs2xyz(crs), mj.crs2xyz(crs))
    xyz = rng.uniform(-5, 30, size=(11, 3))
    np.testing.assert_array_equal(mt.xyz2crs(xyz), mj.xyz2crs(xyz))
    cart = rng.uniform(-12, 12, size=(4, 5, 3))
    for center in (True, False):
        _close(tpdb.map_density(pt, cart, center=center, fill_value=-1.0),
               jpdb.map_density(pj, cart, center=center, fill_value=-1.0))
    for name in ("a.ccp4", "b.MRC", "c.map.gz", "d.pdb", "e.mrc.gz"):
        assert tpdb.is_map_file(name) == jpdb.is_map_file(name)


# ------------------------------------------------- the correlate worker's
_GEOM = """res = 5000
clen = 0.26
p0/fs = +1.0x
p0/ss = -1.0y
p0/corner_x = -100
p0/corner_y = 50
p1a0/fs = -1.0x
p1a0/ss = +1.0y
p1a0/corner_x = 10
p1a0/corner_y = 20
"""


def test_ring_symmetry_score():
    from xframe_tpu.library.mathtools import ring_symmetry_score as jscore
    from xframe_tpu_torch.library.mathtools import \
        ring_symmetry_score as tscore
    rng = np.random.default_rng(4)
    y, x = np.mgrid[0:40, 0:40]
    r = np.hypot(y - 19.2, x - 20.7)
    w = np.exp(-r / 9) * (1 + 0.1 * rng.normal(size=r.shape))
    for args in ((r, w, 64, 19.0), (r, w, 16, None), (r, 0 * w, 64, 19.0),
                 (r, w, 64, 0.0), (r, w, 64, 0.5)):
        assert tscore(*args) == jscore(*args)


@pytest.mark.parametrize("source", ["nominal", "geom"])
def test_agipd_geometry(tmp_path, source):
    from xframe_tpu.experiments.SPB.detectors import agipd as jagipd
    from xframe_tpu_torch.experiments.SPB.detectors import agipd as tagipd
    kw = dict(detector_distance=0.2)
    if source == "geom":
        (tmp_path / "d.geom").write_text(_GEOM)
        kw["geometry_file"] = str(tmp_path / "d.geom")
        for a, b in zip(tagipd.parse_crystfel_geom(kw["geometry_file"]),
                        jagipd.parse_crystfel_geom(kw["geometry_file"])):
            assert a == b
    tdet, jdet = tagipd.AGIPD(**kw), jagipd.AGIPD(**kw)
    np.testing.assert_array_equal(tdet.pixel_centers, jdet.pixel_centers)
    np.testing.assert_array_equal(tdet.pixel_xy, jdet.pixel_xy)
    _close(tdet.pixel_grid_reciprocal(1.23984),
           jdet.pixel_grid_reciprocal(1.23984))
    np.testing.assert_array_equal(tagipd.module_slow_offsets(),
                                  jagipd.module_slow_offsets())
    assert tdet.pixel_centers.shape == (16, 512, 128, 3)


def test_cc_symmetrize_and_low_pass():
    from xframe_tpu.projects.fxs import correlate as jcor
    from xframe_tpu_torch.projects.fxs import correlate as tcor
    rng = np.random.default_rng(6)
    for n_phi in (32, 64, 90):
        cc = rng.normal(size=(3, 4, n_phi)).astype(np.float32)
        phis = 2 * np.pi * np.arange(n_phi) / n_phi
        np.testing.assert_array_equal(
            tcor.symmetrize_cc(torch.as_tensor(cc), phis).numpy(),
            jcor.symmetrize_cc(cc, phis))
        for fc in (None, 0, 5, n_phi // 2):
            got = tcor._low_pass_cc(torch.as_tensor(cc), fc).numpy()
            want = jcor._low_pass_cc(cc, fc)
            assert got.dtype == want.dtype
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("kw", [
    {}, {"polarization": True, "solid_angle": True},
    {"polarization": "h", "n_q": 9},
    {"qrange": (0.01, 0.05, 0.004),
     "qrange_xcca": ((0.018, 0.042, 2), (0.014, 0.046, 1))},
    {"phi_range": (0.5, 5.5), "n_phi": 10_000, "phi_sampling_mode": "max"},
    {"n_phi": 8, "phi_sampling_mode": "min", "roi_q_range": (0.005, 0.02)},
])
def test_correlator_host_constants(kw):
    from xframe_tpu.projects.fxs import correlate as jcor
    from xframe_tpu_torch.projects.fxs import correlate as tcor
    args = ((64, 60), (31.2, 29.6), 200.0, 800.0, 1.23984)
    kw = dict({"n_phi": 64, "n_q": 16}, **kw)
    j = jcor.Correlator(*args, **kw)
    t = tcor.Correlator(*args, device="cpu", **kw)
    for name in ("n_q", "n_phi", "_roi", "order"):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("qs", "phis", "q1_pos", "q2_pos", "_coords",
                 "_corrections"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.int64, np.uint8, np.complex64,
                                   np.float16, bool])
def test_vtk_b64_and_data_array(dtype):
    from xframe_tpu.io import vtk as jvtk
    from xframe_tpu_torch.io import vtk as tvtk
    arr = (np.random.default_rng(5).random(37) * 50).astype(dtype)
    assert tvtk._b64(arr) == jvtk._b64(arr)
    assert tvtk._data_array("x", arr) == jvtk._data_array("x", arr)


@pytest.mark.parametrize("complex_field", [False, True])
def test_vtk_structured_grid_bytes(tmp_path, complex_field):
    from xframe_tpu.io import vtk as jvtk
    from xframe_tpu_torch.io import vtk as tvtk
    rng = np.random.default_rng(6)
    points = rng.normal(size=(3, 4, 5, 3))
    field = rng.normal(size=(3, 4, 5)).astype(np.float32)
    fields = {"density": field + 1j * field if complex_field else field,
              "mask": field > 0}
    for pkg, mod in (("jax", jvtk), ("torch", tvtk)):
        mod.save_structured_grid(str(tmp_path / f"{pkg}.vts"), points, fields)
    assert (tmp_path / "jax.vts").read_bytes() == \
        (tmp_path / "torch.vts").read_bytes()


@pytest.mark.parametrize("close_phi", [True, False])
@pytest.mark.parametrize("n_theta", [4, 0])
def test_vtk_spherical_bytes(tmp_path, close_phi, n_theta):
    """save_spherical, 3D and the θ-less grid of a 2D average; the port's
    reader gives the field back."""
    from xframe_tpu.io import vtk as jvtk
    from xframe_tpu_torch.io import vtk as tvtk
    rng = np.random.default_rng(7)
    rs, phis = np.linspace(0.3, 9.0, 6), 2 * np.pi * np.arange(8) / 8
    thetas = np.linspace(0.1, 3.0, n_theta)
    rho = rng.random((6, n_theta, 8) if n_theta else (6, 8))
    for pkg, mod in (("jax", jvtk), ("torch", tvtk)):
        mod.save_spherical(str(tmp_path / f"{pkg}.vts"), rs, thetas, phis,
                           {"density": rho}, close_phi=close_phi)
    assert (tmp_path / "jax.vts").read_bytes() == \
        (tmp_path / "torch.vts").read_bytes()
    if n_theta:
        flat = tvtk.read_field(str(tmp_path / "torch.vts"), "density")
        back = flat.reshape((6, n_theta, 8 + close_phi), order="F")
        np.testing.assert_array_equal(back[..., :8], rho)
