"""The port's numpy copies of host table builders equal the JAX package's.

xframe_tpu_torch carries copies because importing xframe_tpu pulls in jax
and PyYAML; these tests keep the copies equal to the originals (≤1e-12).
"""
import numpy as np
import pytest

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
    pt, et = tinv.deg2_invariant_to_projection_matrices(bl)
    for a, b in zip(pt, pj):
        _close(a, b)
    for a, b in zip(et, ej):
        _close(a, b)


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
