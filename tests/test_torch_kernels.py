"""The CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU and nvcc (marker `cuda`); elsewhere every test skips.
Run on a GPU machine with
`python3 -m pytest --noconftest tests/test_torch_kernels.py`.
Tolerance 1e-5·max for the SHT kernels: float32 sums over at most 48 φ and
24 θ terms, taken in another order than cuFFT's and cuBLAS's. The fused MTIP
kernels keep the JAX package's own tolerances for them
(tests/test_transforms.py:386-563): 1e-4·max for coefficients and the
Hankel-fused synthesis, 2e-5·max for the updated density away from the real
constraint's thresholds, 1e-4 relative for every sum (B5 and B6 on both
synthesis routes); the variants' B11 ψ_p
(away from I_new = 0 on random coefficients) and B12 ψ 1e-5·max (both on
both synthesis routes). The Newton–Schulz kernels keep the JAX package's bounds
for its Pallas kernels against the jnp path: 5e-4 for the polar factor
(tests/test_polar_schedule.py:125), 5e-3·max for the fused projection
(tests/test_phasing.py:389); the polar factor at c = 253 and 255 is held to
chip_smoke.py's 2e-3, the float32 floor of the minimax iteration there.
The bf16-table forms (fourier_transform.fused_bf16_tables) are held to
their plain versions, the plain SHT at mxu_dtype bf16, at the bounds that
BF16_TOL below states.
"""
import numpy as np
import pytest
import torch

from xframe_tpu_torch.ops import fused_mtip, fused_projection
from xframe_tpu_torch.ops.polar_schedule import DEFAULT_SCHEDULE
from xframe_tpu_torch.ops.fused_sht import FusedSHT, METHODS
from xframe_tpu_torch.ops.hankel import (SphericalHankelTransform,
                                         generate_weights)
from xframe_tpu_torch.ops.sht import SphericalHarmonicTransform
from xframe_tpu_torch.projects.fxs.projections import RealConstraint

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("l_max,n_theta,n_phi,rows",
                         [(10, 24, 48, 6), (7, 17, 30, 3), (20, 48, 96, 2)])
@pytest.mark.parametrize("method", METHODS)
def test_kernel_matches_plain(cuda, method, l_max, n_theta, n_phi, rows):
    sht = SphericalHarmonicTransform(l_max, n_theta, n_phi, device=cuda)
    fused = FusedSHT(sht)
    assert fused.analysis_route == "fft"
    rng = np.random.default_rng(0)
    grid = (rows, n_theta, n_phi)
    coef = (rows, 2 * l_max + 1, l_max + 1)
    if method in ("forward", "forward_real_abs2"):
        x = rng.normal(size=grid) + 1j * rng.normal(size=grid)
    elif method == "forward_real":
        x = rng.normal(size=grid)
    else:
        x = (rng.normal(size=coef) + 1j * rng.normal(size=coef)) \
            * sht.lm_mask[None]
    dtype = torch.float32 if method == "forward_real" else torch.complex64
    x = torch.as_tensor(x, dtype=dtype, device=cuda)
    got = getattr(fused, method)(x)
    want = getattr(sht, method)(x)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert fused.launches == {m: int(m == method) for m in METHODS}


@pytest.mark.parametrize("l_max,n_theta,n_phi,rows,route",
                         [(10, 21, 22, 5, "dense"), (6, 9, 640, 3, "fft"),
                          (12, 27, 60, 67, "fft"), (4, 1100, 10, 2, "fft"),
                          (40, 2048, 4096, 2, "fft"),
                          (10, 23, 8192, 2, "fft")])
def test_analysis_routes(cuda, l_max, n_theta, n_phi, rows, route):
    """B1, B9 and B3 on both analysis routes against their plain versions
    at 1e-5·max: the dense analysis_kernel (n_φ = 22), n_φ = 640 (the FFT
    block's shared memory past the default 48 KB), 67 rows (a ragged
    64-row GEMM tile) with an odd θ count, n_θ = 1100, past the dense
    route's cap, the JAX package's default grid from L = 683 (2048×4096, L
    cut to 40, since the L = 683 tables take 15 GB; 2 FFT lines per block)
    and n_φ = 8192 (1 line). B9 analyses the real part of the grid. A
    second call is bitwise equal to the first."""
    sht = SphericalHarmonicTransform(l_max, n_theta, n_phi, device=cuda)
    fused = FusedSHT(sht)
    assert fused.analysis_route == route
    rng = np.random.default_rng(n_theta + n_phi)
    grid = (rows, n_theta, n_phi)
    x = torch.as_tensor(rng.normal(size=grid) + 1j * rng.normal(size=grid),
                        dtype=torch.complex64, device=cuda)
    methods = ("forward", "forward_real", "forward_real_abs2")
    for method in methods:
        arg = x.real.contiguous() if method == "forward_real" else x
        got = getattr(fused, method)(arg)
        again = getattr(fused, method)(arg)
        want = getattr(sht, method)(arg)
        torch.cuda.synchronize()
        _close(got, want, 1e-5)
        assert torch.equal(got, again)
    assert fused.launches == {m: 2 * (m in methods) for m in METHODS}


def test_dense_analysis_keeps_the_theta_cap(cuda):
    """The dense route (n_φ = 22) threads one θ line each: past 1024 lines
    B1 and B9 refuse the launch; on the FFT route (n_φ = 20) both take it,
    B9 within 1e-5·max of its plain version."""
    x = torch.ones((1, 1030, 22), dtype=torch.complex64, device=cuda)
    fused = FusedSHT(SphericalHarmonicTransform(4, 1030, 22, device=cuda))
    assert fused.analysis_route == "dense"
    with pytest.raises(RuntimeError):
        fused.forward(x)
    with pytest.raises(RuntimeError):
        fused.forward_real(x.real.contiguous())
    sht = SphericalHarmonicTransform(4, 1030, 20, device=cuda)
    fft = FusedSHT(sht)
    assert fft.analysis_route == "fft"
    assert fft.forward(x[..., :20].contiguous()).shape == (1, 9, 5)
    f = torch.as_tensor(np.random.default_rng(1030).normal(size=(1, 1030, 20)),
                        dtype=torch.float32, device=cuda)
    got = fft.forward_real(f)
    assert got.shape == (1, 9, 5)
    _close(got, sht.forward_real(f), 1e-5)
    assert fft.launches["forward_real"] == 1


def test_fft_analysis_refuses_an_n_phi_past_shared_memory(cuda):
    """At n_φ = 16384 not even one FFT line and the twiddles fit a block's
    227 KB: B1, B9 and B3 refuse the launch rather than run."""
    fused = FusedSHT(SphericalHarmonicTransform(4, 6, 16384, device=cuda))
    assert fused.analysis_route == "fft"
    x = torch.ones((1, 6, 16384), dtype=torch.complex64, device=cuda)
    for method in ("forward", "forward_real", "forward_real_abs2"):
        arg = x.real.contiguous() if method == "forward_real" else x
        with pytest.raises(RuntimeError, match="n_φ = 16384"):
            getattr(fused, method)(arg)
    assert not any(fused.launches.values())


@pytest.mark.parametrize("n_phi", [8192, 16384])
def test_fft_synthesis_and_projection_refuse_past_shared_memory(cuda, n_phi):
    """Past its limit each FFT kernel refuses with a message naming n_φ: B4
    from n_φ = 8192 (its tile's lines run in pairs, two lines do not fit),
    B2, B10, B5, B6, B11 and B12 at 16384, where B2, B10, B11 and B12 still
    run at 8192 (one line)."""
    l_max, n_theta, n_q = 4, 6, 3
    sht = SphericalHarmonicTransform(l_max, n_theta, n_phi, device=cuda)
    fused = FusedSHT(sht)
    hankel = SphericalHankelTransform(
        generate_weights(l_max, n_q, np.pi, 3, "midpoint"), r_max=1.0,
        device=cuda)
    fi = fused_mtip.FusedIteration(fused, hankel=hankel)
    rng = np.random.default_rng(n_phi)
    coef = (1, n_q, 2 * l_max + 1, l_max + 1)
    c = torch.as_tensor((rng.normal(size=coef) + 1j * rng.normal(size=coef))
                        * sht.lm_mask, dtype=torch.complex64, device=cuda)
    grid = (1, n_q, n_theta, n_phi)
    psi = torch.ones(grid, dtype=torch.complex64, device=cuda)
    refused = [lambda: fi.inverse_real_project_fwd(c, psi)]
    if n_phi == 16384:
        rc = RealConstraint()
        w = torch.ones((n_q, n_theta), device=cuda)
        refused += [lambda: fused.inverse(c),
                    lambda: fused.inverse_real(c),
                    lambda: fi.hankel_synthesize(c),
                    lambda: fi.synthesize_update(
                        c, psi, psi.real > 0, w, 0.5, 1.0, method="ER",
                        ft_stab=True, real_constraint=rc),
                    lambda: fi.inverse_real_project(c, psi),
                    lambda: fi.synthesize_abs2(c)]
    else:
        _close(fused.inverse(c), sht.inverse(c), 1e-5)
        _close(fused.inverse_real(c), sht.inverse_real(c), 1e-5)
        for got, want in zip(fi.synthesize_abs2(c),
                             fi.synthesize_abs2_plain(c)):
            _close(got, want, 1e-4)
        # ψ_p is held away from I_new = 0 in test_inverse_real_project_routes
        for got, want in zip(fi.inverse_real_project(c, psi)[1:],
                             fi.inverse_real_project_plain(c, psi)[1:]):
            _close(got, want, 1e-4)
    for call in refused:
        with pytest.raises(RuntimeError, match=f"n_φ = {n_phi}"):
            call()
    assert fused.launches["inverse"] == int(n_phi == 8192)
    assert fused.launches["inverse_real"] == int(n_phi == 8192)
    assert fi.launches == {m: int(n_phi == 8192 and m in (
        "inverse_real_project", "synthesize_abs2")) for m in fi.launches}


@pytest.mark.parametrize("l_max,n_theta,n_phi,rows,route",
                         [(10, 21, 22, 5, "dense"), (6, 9, 640, 3, "fft"),
                          (12, 27, 60, 67, "fft"), (12, 70, 60, 3, "fft"),
                          (40, 64, 4096, 2, "fft"),
                          (10, 23, 8192, 2, "fft")])
def test_inverse_routes(cuda, l_max, n_theta, n_phi, rows, route):
    """B2 and B10 on both synthesis routes against the plain SHT at
    1e-5·max, on random coefficients (not Hermitian): the dense
    synthesis_kernel (n_φ = 22), n_φ = 640 (the FFT block past the default
    48 KB), 67 rows (a ragged 64-row Legendre GEMM tile) with an odd θ
    count (B10: a lone last θ line in its FFT line), 70 θ lines (a ragged
    64-line tile), the JAX package's default n_φ from L = 683 (4096, L cut
    to 40; 2 FFT lines per block) and n_φ = 8192 (1 line). A second call is
    bitwise equal to the first, one launch each."""
    sht = SphericalHarmonicTransform(l_max, n_theta, n_phi, device=cuda)
    fused = FusedSHT(sht)
    assert fused.synthesis_route == route
    rng = np.random.default_rng(n_theta + n_phi)
    coef = (rows, 2 * l_max + 1, l_max + 1)
    c = torch.as_tensor((rng.normal(size=coef) + 1j * rng.normal(size=coef))
                        * sht.lm_mask, dtype=torch.complex64, device=cuda)
    methods = ("inverse", "inverse_real")
    for method in methods:
        got, again = getattr(fused, method)(c), getattr(fused, method)(c)
        want = getattr(sht, method)(c)
        torch.cuda.synchronize()
        _close(got, want, 1e-5)
        assert torch.equal(got, again)
    assert fused.launches == {m: 2 * (m in methods) for m in METHODS}


def test_fourier_transform_through_kernels(cuda):
    """The FT on the card runs the kernels; the plain composition of the same
    tables (cuFFT, cuBLAS) is the reference."""
    from xframe_tpu_torch.ops.fourier import SphericalFourierTransform
    kw = dict(q_max=0.4, mode="midpoint", reciprocity_coefficient=2.0)
    ft = SphericalFourierTransform(16, 8, device=cuda, **kw)
    rng = np.random.default_rng(1)
    rho = torch.as_tensor(rng.normal(size=(2,) + ft.grid_shape),
                          dtype=torch.complex64, device=cuda)
    for name in ("forward", "inverse"):
        got = getattr(ft, name)(rho)
        want = ft.sht.inverse(getattr(ft.hankel, name)(ft.sht.forward(rho)))
        assert float((got - want).abs().max()) \
            <= 1e-5 * float(want.abs().max())
    assert ft.harmonic.launches["forward"] == 2
    assert ft.harmonic.launches["inverse"] == 2


def test_demo_problem_on_card_runs_kernels(cuda):
    """make_demo_problem at its defaults on the card runs every kernel of
    the fused iteration once an iteration; fused_sht=False runs the plain
    transforms there and launches none."""
    from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
    from xframe_tpu_torch.projects.fxs.phasing import Segment
    from xframe_tpu_torch.ops.sht import SphericalHarmonicTransform
    plain = make_demo_problem(8, 4, fused_sht=False, device=cuda)
    assert type(plain.ft.harmonic) is SphericalHarmonicTransform
    assert plain.mtip._fi is None
    _, errors = plain.mtip.run_batch(
        plain.initial_density_batch(0, 2),
        [Segment("HIO", 1, betas=np.full(1, 0.5), ft_stab=True)])
    assert bool(torch.isfinite(errors).all())
    p = make_demo_problem(8, 4, device=cuda)
    rho0 = p.initial_density_batch(0, 2)
    p.ft.harmonic.reset_launches()
    _, errors = p.mtip.run_batch(
        rho0, [Segment("HIO", 1, betas=np.full(1, 0.5), ft_stab=True)])
    assert bool(torch.isfinite(errors).all())
    assert p.ft.harmonic.launches == {"forward": 1, "inverse": 0,
                                      "forward_real": 0, "inverse_real": 0,
                                      "forward_real_abs2": 1}
    assert p.mtip._fi.launches == {
        m: int(m not in ("inverse_real_project", "synthesize_abs2"))
        for m in fused_mtip.METHODS}


def _close(got, want, tol):
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("l_max,n_theta,n_phi,batch,n_q,mode",
                         [(6, 16, 32, 2, 8, "midpoint"),
                          (7, 17, 30, 2, 5, "trapz"),
                          (10, 24, 48, 1, 12, "midpoint")])
def test_fused_iteration_kernels_match_plain(cuda, l_max, n_theta, n_phi,
                                             batch, n_q, mode):
    sht = SphericalHarmonicTransform(l_max, n_theta, n_phi, device=cuda)
    fused = FusedSHT(sht)
    hankel = SphericalHankelTransform(
        generate_weights(l_max, n_q, np.pi, 3, mode), r_max=1.0,
        device=cuda)
    rng = np.random.default_rng(3)
    w_rec = rng.uniform(0.1, 1.0, (n_q, n_theta))
    grid = (batch, n_q, n_theta, n_phi)
    coef = (batch, n_q, 2 * l_max + 1, l_max + 1)

    def cx(shape, mask=False):
        x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        if mask:
            x = x * sht.lm_mask
        return torch.as_tensor(x, dtype=torch.complex64, device=cuda)

    c, psi = cx(coef, True), cx(grid)
    # random coefficients give I_new < 0 on about half the grid, where ψ_p
    # is 0; an intensity's coefficients keep I_new > 0 everywhere. B11's ψ_p
    # is compared away from I_new = 0, where √I_new turns a rounding
    # difference δ of the synthesis into one of √δ.
    c_int = sht.forward_real(cx(grid).abs() ** 2 + 1.0)
    i_new = sht.inverse_real(c)
    assert 0.3 < float((i_new < 0).float().mean()) < 0.7
    away = i_new.abs() > 1e-2 * float(i_new.abs().max())
    for fi in (fused_mtip.FusedIteration(fused, hankel=hankel),
               fused_mtip.FusedIteration(fused, w_rec=w_rec, hankel=hankel)):
        for got, want in zip(fi.hankel_synthesize(c),
                             fi.hankel_synthesize_plain(c)):
            _close(got, want, 1e-4)
        for name, tol, coeffs, keep in (
                ("inverse_real_project_fwd", 1e-4, c, None),
                ("inverse_real_project", 1e-5, c_int, None),
                ("inverse_real_project", 1e-5, c, away)):
            got = getattr(fi, name)(coeffs, psi)
            want = getattr(fi, name + "_plain")(coeffs, psi)
            if keep is None:
                _close(got[0], want[0], tol)
            else:
                assert got[0].shape == want[0].shape
                assert float((got[0] - want[0])[keep].abs().max()) \
                    <= tol * float(want[0].abs().max())
            for g, w in zip(got[1:], want[1:]):
                assert g.shape == (batch,)
                assert float((g - w).abs().max()) \
                    <= 1e-4 * float(w.abs().min())
        got, want = fi.synthesize_abs2(c), fi.synthesize_abs2_plain(c)
        _close(got[0], want[0], 1e-5)
        _close(got[1], want[1], 1e-4)
        torch.cuda.synchronize()
        assert fi.launches == {"hankel_synthesize": 1,
                               "inverse_real_project_fwd": 1,
                               "synthesize_update": 0,
                               "inverse_real_project": 2,
                               "synthesize_abs2": 1}


@pytest.mark.parametrize("l_max,n_theta,n_phi,batch,n_q",
                         [(6, 16, 32, 2, 8), (7, 17, 30, 3, 5)])
@pytest.mark.parametrize("method,ft_stab", [("HIO", True), ("ER", True),
                                            ("RAAR", False), ("HIO", False)])
def test_synthesize_update_kernel_matches_plain(cuda, l_max, n_theta, n_phi,
                                                batch, n_q, method, ft_stab):
    sht = SphericalHarmonicTransform(l_max, n_theta, n_phi, device=cuda)
    fi = fused_mtip.FusedIteration(FusedSHT(sht))
    rng = np.random.default_rng(4)
    grid = (batch, n_q, n_theta, n_phi)
    coef = (batch, n_q, 2 * l_max + 1, l_max + 1)
    d = torch.as_tensor((rng.normal(size=coef) + 1j * rng.normal(size=coef))
                        * sht.lm_mask, dtype=torch.complex64, device=cuda)
    rho_in = torch.as_tensor(rng.normal(size=grid)
                             + 1j * rng.normal(size=grid),
                             dtype=torch.complex64, device=cuda)
    support = torch.as_tensor(rng.uniform(size=grid) > 0.4, device=cuda)
    w = torch.as_tensor(rng.uniform(0.1, 1.0, (n_q, n_theta)),
                        dtype=torch.float32, device=cuda)
    c_phase = torch.as_tensor(np.exp(1j * rng.uniform(-3, 3, batch)),
                              dtype=torch.complex64, device=cuda)
    scale = float(sht.inverse(d).abs().std())
    rc = RealConstraint(threshold_low=0.05 * scale, limit_imag=0.3 * scale)
    kw = dict(method=method, ft_stab=ft_stab, real_constraint=rc)
    got = fi.synthesize_update(d, rho_in, support, w, 0.6, c_phase, **kw)
    want = fi.synthesize_update_plain(d, rho_in, support, w, 0.6, c_phase,
                                      **kw)
    rp, _ = fi.pre_constraint_plain(d, rho_in, c_phase, ft_stab=ft_stab)
    keep = fused_mtip.away_from_thresholds(rp, rc,
                                           1e-4 * float(rp.abs().max()))
    torch.cuda.synchronize()
    assert got[0].shape == grid
    assert float((got[0] - want[0])[keep].abs().max()) \
        <= 2e-5 * float(want[0].abs().max())
    for g, w_ in zip(got[1:], want[1:]):
        assert g.shape == (batch,)
        assert float((g - w_).abs().max()) <= 1e-4 * float(w_.abs().min())
    assert fi.launches["synthesize_update"] == 1
    # a grid of weights per restart is the plain version's only: the kernel
    # takes the plane or the grid the restarts share
    with pytest.raises(ValueError):
        fi.synthesize_update(d, rho_in, support, w[None, :, :, None]
                             .expand(grid), 0.6, c_phase, **kw)


@pytest.mark.parametrize("l_max,n_theta,n_phi,route",
                         [(6, 13, 26, "dense"), (10, 21, 40, "fft"),
                          (6, 9, 640, "fft")])
def test_synthesize_update_grid_and_gate(cuda, l_max, n_theta, n_phi, route):
    """B5's grid of weights (shared by the restarts) and the linked ft-stab
    gate per restart on both routes, against the plain version (2e-5·max on
    ρ_new away from the thresholds, 1e-4 relative on the sums); with gates
    (0, 1) restart 0 is bitwise the kernel without ft-stab and restart 1
    the kernel with it."""
    sht = SphericalHarmonicTransform(l_max, n_theta, n_phi, device=cuda)
    fi = fused_mtip.FusedIteration(FusedSHT(sht))
    assert fi.synthesis_route == route
    rng = np.random.default_rng(11)
    n_q, batch = 9, 2
    grid = (batch, n_q, n_theta, n_phi)
    coef = (batch, n_q, 2 * l_max + 1, l_max + 1)
    d = torch.as_tensor((rng.normal(size=coef) + 1j * rng.normal(size=coef))
                        * sht.lm_mask, dtype=torch.complex64, device=cuda)
    rho_in = torch.as_tensor(rng.normal(size=grid)
                             + 1j * rng.normal(size=grid),
                             dtype=torch.complex64, device=cuda)
    support = torch.as_tensor(rng.uniform(size=grid) > 0.4, device=cuda)
    c_phase = torch.as_tensor(np.exp(1j * rng.uniform(-3, 3, batch)),
                              dtype=torch.complex64, device=cuda)
    scale = float(sht.inverse(d).abs().std())
    rc = RealConstraint(threshold_low=0.05 * scale, limit_imag=0.3 * scale)
    gate = torch.tensor([0.0, 1.0], device=cuda)
    for w, g in ((torch.as_tensor(rng.uniform(0.1, 1.0, grid[1:]),
                                  dtype=torch.float32, device=cuda), None),
                 (torch.as_tensor(rng.uniform(0.1, 1.0, (n_q, n_theta)),
                                  dtype=torch.float32, device=cuda), gate)):
        kw = dict(method="HIO", ft_stab=True, real_constraint=rc, ft_gate=g)
        args = (d, rho_in, support, w, 0.6, c_phase)
        got = fi.synthesize_update(*args, **kw)
        want = fi.synthesize_update_plain(*args, **kw)
        rp, _ = fi.pre_constraint_plain(d, rho_in, c_phase, ft_stab=True,
                                        ft_gate=g)
        keep = fused_mtip.away_from_thresholds(rp, rc,
                                               1e-4 * float(rp.abs().max()))
        w3 = w if w.dim() == 3 else w[..., None]
        new = want[0].abs()
        scales = (None, want[1], want[2],
                  (w3 * new ** 2).sum((-3, -2, -1)),
                  (w3 * new).sum((-3, -2, -1)))
        torch.cuda.synchronize()
        assert float((got[0] - want[0])[keep].abs().max()) \
            <= 2e-5 * float(want[0].abs().max())
        for x, y, s in zip(got[1:], want[1:], scales[1:]):
            assert float(((x - y).abs() / s.abs()).max()) <= 1e-4
        if g is not None:
            on = fi.synthesize_update(*args, **dict(kw, ft_gate=None))
            off = fi.synthesize_update(*args, **dict(kw, ft_gate=None,
                                                     ft_stab=False))
            torch.cuda.synchronize()
            for x, a, b in zip(got, off, on):
                assert torch.equal(x[0], a[0]) and torch.equal(x[1], b[1])


@pytest.mark.parametrize("schedule", [None, DEFAULT_SCHEDULE],
                         ids=["fixed", "minimax"])
@pytest.mark.parametrize("g,c", [(3, 11), (2, 127), (1, 129)])
def test_polar_unitary_kernel_matches_plain(cuda, schedule, g, c):
    """Two restarts of g full-rank c×c matrices each."""
    rng = np.random.default_rng(c)
    m = torch.as_tensor(rng.normal(size=(2, g, c, c))
                        + 1j * rng.normal(size=(2, g, c, c)),
                        dtype=torch.complex64, device=cuda)
    fused_projection.reset_launches()
    got = fused_projection.polar_unitary(m, 16, schedule=schedule)
    want = fused_projection.polar_unitary_newton_schulz(m, 16,
                                                        schedule=schedule)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 5e-4
    assert fused_projection.launches["polar_unitary"] == 1


@pytest.mark.parametrize("schedule", [None, DEFAULT_SCHEDULE],
                         ids=["fixed", "minimax"])
def test_fused_projection_kernel_matches_plain(cuda, schedule, monkeypatch):
    """The projection under newton_schulz_pallas at L = 66 (both crop
    buckets and the full-width order, one launch each) for two restarts,
    against the same constraint's plain buckets on the card."""
    from xframe_tpu_torch.projects.fxs import projections
    rng = np.random.default_rng(21)
    L, n_q = 66, 135
    n_m = 2 * L + 1
    mats = [rng.normal(size=(n_q, min(2 * l + 1, n_q)))
            + 1j * rng.normal(size=(n_q, min(2 * l + 1, n_q)))
            for l in range(L + 1)]
    mask = np.ones((L + 1, n_q), dtype=bool)
    mask[:, :3] = False
    rc = projections.ReciprocalConstraint.build(
        mats, np.linspace(0.1, 1.0, n_q), L, radial_mask=mask,
        average_intensity=np.abs(rng.normal(size=n_q)) + 0.5,
        n_particles=3.0, procrustes_method="newton_schulz_pallas",
        ns_schedule=schedule, device=cuda)
    assert rc.k5_active
    lm = np.arange(L + 1)[None, :] >= np.abs(np.arange(-L, L + 1))[:, None]
    ilm = torch.as_tensor((rng.normal(size=(2, n_q, n_m, L + 1))
                           + 1j * rng.normal(size=(2, n_q, n_m, L + 1))) * lm,
                          dtype=torch.complex64, device=cuda)
    fused_projection.reset_launches()
    got = rc(ilm)
    assert fused_projection.launches["fused_projection_bucket"] == 3
    monkeypatch.setattr(projections, "fused_projection_bucket",
                        fused_projection.fused_projection_bucket_plain)
    want = rc(ilm)
    torch.cuda.synchronize()
    _close(got, want, 5e-3)


@pytest.mark.parametrize("l_max,n_theta,n_phi,route",
                         [(6, 13, 26, "dense"), (10, 21, 40, "fft"),
                          (12, 27, 60, "fft"), (12, 27, 2048, "fft"),
                          (10, 21, 4096, "fft")])
def test_inverse_real_project_fwd_routes(cuda, l_max, n_theta, n_phi, route):
    """B4 on both routes, each with a ragged last θ tile (the dense route's
    16 lines, the FFT route's 8, and at n_φ = 2048 and 4096 the line rule's
    4 and 2), random coefficients (I_new < 0 on about half the grid) and
    the weight plane; 1e-4·max on the coefficients, 1e-4 relative on the
    sums."""
    sht = SphericalHarmonicTransform(l_max, n_theta, n_phi, device=cuda)
    rng = np.random.default_rng(n_phi)
    n_q, batch = 3, 2
    fi = fused_mtip.FusedIteration(
        FusedSHT(sht), w_rec=rng.uniform(0.1, 1.0, (n_q, n_theta)))
    assert fi.projection_route == route
    grid = (batch, n_q, n_theta, n_phi)
    coef = (batch, n_q, 2 * l_max + 1, l_max + 1)
    c = torch.as_tensor((rng.normal(size=coef) + 1j * rng.normal(size=coef))
                        * sht.lm_mask, dtype=torch.complex64, device=cuda)
    psi = torch.as_tensor(rng.normal(size=grid) + 1j * rng.normal(size=grid),
                          dtype=torch.complex64, device=cuda)
    got = fi.inverse_real_project_fwd(c, psi)
    want = fi.inverse_real_project_fwd_plain(c, psi)
    torch.cuda.synchronize()
    _close(got[0], want[0], 1e-4)
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == (batch,)
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().min())
    assert fi.launches["inverse_real_project_fwd"] == 1


@pytest.mark.parametrize("l_max,n_theta,n_phi,route",
                         [(6, 13, 26, "dense"), (10, 21, 40, "fft"),
                          (12, 27, 60, "fft"), (12, 70, 60, "fft"),
                          (6, 9, 640, "fft"), (10, 23, 4096, "fft"),
                          (6, 9, 8192, "fft")])
def test_synthesis_routes(cuda, l_max, n_theta, n_phi, route):
    """B6 and B5 on both synthesis routes, two restarts of n_q = 67 shells
    (the 32 q′ tiles of the Hankel GEMM and the 64-row tiles of the
    Legendre GEMM ragged, and with L = 12 the Hankel GEMM's 32-m and 8-l
    tiles too), odd θ counts (a ragged last θ tile; 70 lines: a ragged
    64-line Legendre tile; n_φ = 640: the FFT block's dynamic shared memory
    and B5's static block-sum buffer together past the default 48 KB;
    n_φ = 4096 and 8192: 2 and 1 FFT lines per block by the line rule);
    1e-4·max for B6, for
    B5 2e-5·max on ρ_new away from the thresholds and 1e-4 relative on the
    sums. A second call is bitwise equal to the first."""
    sht = SphericalHarmonicTransform(l_max, n_theta, n_phi, device=cuda)
    n_q, batch = 67, 2
    hankel = SphericalHankelTransform(
        generate_weights(l_max, n_q, np.pi, 3, "midpoint"), r_max=1.0,
        device=cuda)
    fi = fused_mtip.FusedIteration(FusedSHT(sht), hankel=hankel)
    assert fi.synthesis_route == route
    rng = np.random.default_rng(n_theta + n_phi)
    grid = (batch, n_q, n_theta, n_phi)
    coef = (batch, n_q, 2 * l_max + 1, l_max + 1)

    def cx(shape, mask=False):
        x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        return torch.as_tensor(x * sht.lm_mask if mask else x,
                               dtype=torch.complex64, device=cuda)

    c = cx(coef, True)
    got = fi.hankel_synthesize(c)
    want = fi.hankel_synthesize_plain(c)
    again = fi.hankel_synthesize(c)
    torch.cuda.synchronize()
    for g, w, a in zip(got, want, again):
        _close(g, w, 1e-4)
        assert torch.equal(g, a)

    d, rho_in = cx(coef, True), cx(grid)
    support = torch.as_tensor(rng.uniform(size=grid) > 0.4, device=cuda)
    w = torch.as_tensor(rng.uniform(0.1, 1.0, (n_q, n_theta)),
                        dtype=torch.float32, device=cuda)
    c_phase = torch.as_tensor(np.exp(1j * rng.uniform(-3, 3, batch)),
                              dtype=torch.complex64, device=cuda)
    scale = float(sht.inverse(d).abs().std())
    rc = RealConstraint(threshold_low=0.05 * scale, limit_imag=0.3 * scale)
    kw = dict(method="HIO", ft_stab=True, real_constraint=rc)
    args = (d, rho_in, support, w, 0.6, c_phase)
    got = fi.synthesize_update(*args, **kw)
    want = fi.synthesize_update_plain(*args, **kw)
    again = fi.synthesize_update(*args, **kw)
    rp, _ = fi.pre_constraint_plain(d, rho_in, c_phase, ft_stab=True)
    keep = fused_mtip.away_from_thresholds(rp, rc,
                                           1e-4 * float(rp.abs().max()))
    # Σwρ² and Σwρ cancel down to ~√N of their terms over these 10⁵ points
    # a restart: they are held to the sums of the terms' magnitudes
    new, grid_axes = want[0].abs(), (-3, -2, -1)
    scales = (None, want[1], want[2],
              (w[..., None] * new ** 2).sum(grid_axes),
              (w[..., None] * new).sum(grid_axes))
    torch.cuda.synchronize()
    assert float((got[0] - want[0])[keep].abs().max()) \
        <= 2e-5 * float(want[0].abs().max())
    for g, w_, a, s in zip(got, want, again, scales):
        assert torch.equal(g, a)
        if s is not None:
            assert g.shape == (batch,)
            assert float(((g - w_).abs() / s.abs()).max()) <= 1e-4
    assert fi.launches["hankel_synthesize"] == 2
    assert fi.launches["synthesize_update"] == 2


_VARIANT_CASES = [(6, 13, 26, "dense"), (10, 21, 40, "fft"),
                  (12, 27, 60, "fft"), (12, 70, 60, "fft"),
                  (6, 9, 640, "fft"), (10, 23, 4096, "fft"),
                  (6, 9, 8192, "fft")]


def _variant_fixture(cuda, l_max, n_theta, n_phi, weighted=True):
    """A FusedIteration with the weight plane on two restarts of n_q = 67
    shells (ragged 64-row Legendre GEMM tiles), and a random coefficient
    draw."""
    sht = SphericalHarmonicTransform(l_max, n_theta, n_phi, device=cuda)
    rng = np.random.default_rng(n_theta * n_phi)
    n_q, batch = 67, 2
    fi = fused_mtip.FusedIteration(
        FusedSHT(sht), w_rec=rng.uniform(0.1, 1.0, (n_q, n_theta))
        if weighted else None)

    def cx(shape, mask=False):
        x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        return torch.as_tensor(x * sht.lm_mask if mask else x,
                               dtype=torch.complex64, device=cuda)
    return sht, fi, (batch, n_q), cx


@pytest.mark.parametrize("l_max,n_theta,n_phi,route", _VARIANT_CASES)
def test_inverse_real_project_routes(cuda, l_max, n_theta, n_phi, route):
    """B11 on both routes, weighted: the dense project_dft_kernel<false>
    (n_φ = 26) and the FFT route (B10's folded Legendre GEMM, then two θ
    lines per inverse FFT with the projection as the epilogue), odd θ
    counts (a lone last line in its FFT line, adding nothing to the sums),
    70 θ lines (a ragged 64-line GEMM tile), n_φ = 640 (past the default
    48 KB), 4096 and 8192 (2 and 1 FFT lines a block: partials per 4 and 2
    θ lines). Random coefficients (I_new < 0 on about half the grid): ψ_p
    within 1e-5·max away from I_new = 0, the sums 1e-4 relative; a second
    call bitwise equal, one launch each."""
    sht, fi, lead, cx = _variant_fixture(cuda, l_max, n_theta, n_phi)
    assert fi.synthesis_route == route
    c, psi = cx(lead + (2 * l_max + 1, l_max + 1), True), \
        cx(lead + (n_theta, n_phi))
    i_new = sht.inverse_real(c)
    assert 0.3 < float((i_new < 0).float().mean()) < 0.7
    away = i_new.abs() > 1e-2 * float(i_new.abs().max())
    got = fi.inverse_real_project(c, psi)
    again = fi.inverse_real_project(c, psi)
    want = fi.inverse_real_project_plain(c, psi)
    torch.cuda.synchronize()
    assert got[0].shape == want[0].shape
    assert float((got[0] - want[0])[away].abs().max()) \
        <= 1e-5 * float(want[0].abs().max())
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == lead[:1]
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().min())
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert fi.launches == {m: 2 * (m == "inverse_real_project")
                           for m in fused_mtip.METHODS}


@pytest.mark.parametrize("l_max,n_theta,n_phi,route", _VARIANT_CASES)
def test_synthesize_abs2_routes(cuda, l_max, n_theta, n_phi, route):
    """B12 on both routes: the dense synthesis_kernel<Abs2Out> and
    quadrature_kernel<true> (n_φ = 26), and the FFT route (B6's synthesis,
    the |ψ|² analysis of each synthesis tile in the FFT block, the
    mirrored quadrature GEMM) with odd θ counts, a ragged 64-line GEMM
    tile, n_φ = 640, 4096 and 8192 (2 and 1 lines a block: a lone |ψ|²
    line with a zero partner). ψ within 1e-5·max, the coefficients
    1e-4·max; a second call bitwise equal, one launch each."""
    sht, fi, lead, cx = _variant_fixture(cuda, l_max, n_theta, n_phi,
                                         weighted=False)
    assert fi.synthesis_route == route
    c = cx(lead + (2 * l_max + 1, l_max + 1), True)
    got, again = fi.synthesize_abs2(c), fi.synthesize_abs2(c)
    want = fi.synthesize_abs2_plain(c)
    torch.cuda.synchronize()
    _close(got[0], want[0], 1e-5)
    _close(got[1], want[1], 1e-4)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert fi.launches == {m: 2 * (m == "synthesize_abs2")
                           for m in fused_mtip.METHODS}


def test_synthesize_abs2_past_the_dense_cap(cuda):
    """At L = 256 (L + 1 past the dense route's 256 m ≥ 0 bins) B12 runs on
    the FFT route (n_φ = 640) within 1e-5·max (ψ) and 1e-4·max (the
    coefficients) of its plain version; on the dense route (n_φ = 518 =
    2·7·37) the launch is refused, and the refusal raises: no fallback,
    no launch counted."""
    l_max, n_theta, rows = 256, 258, 2
    rng = np.random.default_rng(l_max)
    for n_phi, route in ((640, "fft"), (518, "dense")):
        sht = SphericalHarmonicTransform(l_max, n_theta, n_phi, device=cuda)
        fi = fused_mtip.FusedIteration(FusedSHT(sht))
        assert fi.synthesis_route == route
        coef = (rows, 2 * l_max + 1, l_max + 1)
        c = torch.as_tensor((rng.normal(size=coef)
                             + 1j * rng.normal(size=coef)) * sht.lm_mask,
                            dtype=torch.complex64, device=cuda)
        if route == "dense":
            with pytest.raises(RuntimeError, match="xf_synthesize_abs2"):
                fi.synthesize_abs2(c)
            assert fi.launches["synthesize_abs2"] == 0
            continue
        got, want = fi.synthesize_abs2(c), fi.synthesize_abs2_plain(c)
        torch.cuda.synchronize()
        _close(got[0], want[0], 1e-5)
        _close(got[1], want[1], 1e-4)
        assert fi.launches["synthesize_abs2"] == 1


@pytest.mark.parametrize("c,n_mat", [(127, 3), (253, 2), (255, 1)])
def test_polar_unitary_clusters(cuda, c, n_mat):
    """B7 at the production crop widths (c = 127, 253, and the full-width
    255 alone) on well-conditioned matrices Q1·diag(s)·Q2†, s in [0.2, 1],
    with the minimax schedule: the cluster shape polar_unitary picks from
    B7's own resident clusters spreads the call over more than one SM and
    agrees with the plain float32 iteration within 2e-3, a second call
    bitwise; then every other shape the card holds of B7's kernel, each
    within 2e-3 of the same plain run."""
    rng = np.random.default_rng(c)

    def orthonormal():
        return torch.linalg.qr(torch.as_tensor(
            rng.normal(size=(n_mat, c, c)) + 1j * rng.normal(size=(n_mat, c, c)),
            dtype=torch.complex64, device=cuda))[0]
    s = torch.as_tensor(rng.uniform(0.2, 1.0, (n_mat, 1, c)),
                        dtype=torch.complex64, device=cuda)
    m = ((orthonormal() * s) @ orthonormal().mH).contiguous()
    resident = fused_projection.max_active_clusters(m.device, "polar_unitary")
    shape = fused_projection.launch_shape(
        n_mat, c, resident,
        torch.cuda.get_device_properties(m.device).multi_processor_count)
    assert n_mat * shape[0] > 1
    fused_projection.reset_launches()
    got = fused_projection.polar_unitary(m, schedule=DEFAULT_SCHEDULE)
    again = fused_projection.polar_unitary(m, schedule=DEFAULT_SCHEDULE)
    want = fused_projection.polar_unitary_newton_schulz(
        m, schedule=DEFAULT_SCHEDULE)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) < 2e-3
    assert torch.equal(got, again)
    assert fused_projection.launches["polar_unitary"] == 2
    rows = fused_projection.schedule_rows(16, DEFAULT_SCHEDULE)
    for other, n in resident.items():
        if n > 0 and other[0] * other[1] <= (-(-c // 64)) ** 2:
            w = torch.empty_like(m)
            fused_projection.launch_polar(m, w, rows, other)
            torch.cuda.synchronize()
            assert float((w - want).abs().max()) < 2e-3, other


def _conditioned_bucket(rng, cuda, n_g, c, n_q, batch):
    """A bucket's PD = V†D², I = V·Q1·diag(s)·Q2† and V with orthonormal
    columns (or rows where c > n_q), D² in [0.5, 1], s in [0.2, 1]."""
    def cx(shape):
        return torch.as_tensor(rng.normal(size=shape)
                               + 1j * rng.normal(size=shape),
                               dtype=torch.complex64, device=cuda)

    def orthonormal(rows, cols, lead):
        if rows >= cols:
            return torch.linalg.qr(cx(lead + (rows, cols)))[0]
        return torch.linalg.qr(cx(lead + (cols, rows)))[0].mH

    s = torch.as_tensor(rng.uniform(0.2, 1.0, (batch, n_g, 1, c)),
                        dtype=torch.complex64, device=cuda)
    r = (orthonormal(c, c, (batch, n_g)) * s) @ orthonormal(c, c,
                                                            (batch, n_g)).mH
    v = orthonormal(n_q, c, (n_g,))
    d2 = torch.linspace(0.5, 1.0, n_q, device=cuda)[:, None]
    take = torch.as_tensor(rng.uniform(size=(n_g, n_q)) > 0.2,
                           dtype=torch.float32, device=cuda)
    return tuple(x.resolve_conj().contiguous()
                 for x in (v.mH * d2.T, v @ r, v)) + (take,)


@pytest.mark.parametrize("l_lo,h,n_q,batch", [(127, 127, 256, 1),
                                              (64, 64, 128, 2),
                                              (0, 63, 128, 2)],
                         ids=["c255-single", "c129-above-nq", "c127"])
def test_fused_projection_bucket_clusters(cuda, l_lo, h, n_q, batch):
    """B8 on the lone full-width order at c = 255 (one matrix, the largest
    cluster), on a c = 129 > n_q bucket (W not unique: V·W is compared) and
    on a 64-order bucket at c = 127 < n_q, against its plain version at
    5e-3·max; the
    chosen cluster spreads each bucket over more than one SM. Then every
    other cluster shape the card holds, each against the same plain run."""
    rng = np.random.default_rng(h)
    n_g, c = h - l_lo + 1, 2 * h + 1
    pd, it, v, take = _conditioned_bucket(rng, cuda, n_g, c, n_q, batch)
    resident = fused_projection.max_active_clusters(
        it.device, "fused_projection_bucket")
    shape = fused_projection.launch_shape(
        batch * n_g, c, resident,
        torch.cuda.get_device_properties(it.device).multi_processor_count)
    assert batch * n_g * shape[0] > 1
    fused_projection.reset_launches()
    kw = dict(l_lo=l_lo, h=h, schedule=DEFAULT_SCHEDULE)
    got = fused_projection.fused_projection_bucket(pd, it, v, take, **kw)
    want = fused_projection.fused_projection_bucket_plain(pd, it, v, take,
                                                          **kw)
    torch.cuda.synchronize()
    _close(got, want, 5e-3)
    assert fused_projection.launches["fused_projection_bucket"] == 1
    # two runs agree bitwise: the cluster reductions run in rank order
    again = fused_projection.fused_projection_bucket(pd, it, v, take, **kw)
    assert torch.equal(got, again)
    rows = fused_projection.schedule_rows(16, DEFAULT_SCHEDULE)
    for other, n in resident.items():
        if n > 0 and other[0] * other[1] <= (-(-c // 64)) ** 2:
            out = torch.empty_like(it)
            fused_projection.launch_bucket(pd, it, v, take, out, l_lo, h,
                                           rows, other)
            torch.cuda.synchronize()
            _close(out, want, 5e-3)


def test_kernels_read_lazily_conjugated_inputs(cuda):
    """A contiguous view with a pending conjugation (the .mH of torch's
    column-major QR factor, x.conj()) reaches the kernels as its values."""
    rng = np.random.default_rng(3)
    # 3·I plus a small complex Gaussian: condition number about 2
    m = torch.as_tensor(3 * np.eye(11) + 0.1 * (
        rng.normal(size=(2, 11, 11)) + 1j * rng.normal(size=(2, 11, 11))),
        dtype=torch.complex64, device=cuda)
    _close(fused_projection.polar_unitary(m.conj(), schedule=DEFAULT_SCHEDULE),
           fused_projection.polar_unitary_newton_schulz(
               m.conj().resolve_conj(), schedule=DEFAULT_SCHEDULE), 5e-4)
    g, n_q, c = 1, 10, 11
    q = torch.linalg.qr(torch.as_tensor(
        rng.normal(size=(g, c, n_q)) + 1j * rng.normal(size=(g, c, n_q)),
        dtype=torch.complex64, device=cuda))[0]
    v = q.mH                                      # (g, n_q, c), conj pending
    assert v.is_contiguous() and v.is_conj()
    pd = q.clone()
    it = torch.as_tensor(rng.normal(size=(2, g, n_q, c))
                         + 1j * rng.normal(size=(2, g, n_q, c)),
                         dtype=torch.complex64, device=cuda)
    take = torch.ones((g, n_q), device=cuda)
    kw = dict(l_lo=5, h=5, schedule=DEFAULT_SCHEDULE)
    _close(fused_projection.fused_projection_bucket(pd, it, v, take, **kw),
           fused_projection.fused_projection_bucket_plain(
               pd, it, v.resolve_conj(), take, **kw), 5e-3)
    # B1 and B3 on the FFT route
    sht = SphericalHarmonicTransform(10, 24, 48, device=cuda)
    fused = FusedSHT(sht)
    f = torch.as_tensor(rng.normal(size=(2, 24, 48))
                        + 1j * rng.normal(size=(2, 24, 48)),
                        dtype=torch.complex64, device=cuda).conj()
    assert f.is_conj()
    for method in ("forward", "forward_real_abs2"):
        _close(getattr(fused, method)(f),
               getattr(sht, method)(f.resolve_conj()), 1e-5)


# ------------------------------------------------------------ bf16 tables
# The bf16-table forms (fourier_transform.fused_bf16_tables) against their
# plain versions, the plain SHT at mxu_dtype bf16 (FusedSHT.plain): the same
# bf16-rounded Legendre operands and float32 sums in another order. Where
# the kernel computes an operand itself (an FFT's output, the Hankel GEMM,
# B4's and B12's second stage) it may sit one float32 ulp from the plain
# version's across a bf16 rounding boundary and round one bf16 step apart:
# 1e-3·max there, 1e-5·max where the operands come from the input or a
# float32 fold (BF16_TOL; chip_smoke.py states its own at the cells'
# shapes). Each form also lies more than 1e-5·max from its float32 form.
BF16_TOL = {"forward": 1e-3, "inverse": 1e-5, "forward_real": 1e-3,
            "inverse_real": 1e-5, "forward_real_abs2": 1e-3,
            "hankel_synthesize": 1e-3, "inverse_real_project_fwd": 1e-3,
            "inverse_real_project": 1e-5, "synthesize_abs2": 1e-3,
            "synthesize_update": 1e-5}
BF16_CASES = [(10, 24, 48, 6, "fft"), (7, 17, 30, 67, "fft"),
              (10, 21, 22, 5, "dense")]


def _bf16_close(name, got, want, f32, keep=None):
    """got within BF16_TOL[name]·max of want, and more than 1e-5·max from
    the float32 form's f32 (over keep where given)."""
    scale = float(want.abs().max())
    diff, dist = (got - want).abs(), (got - f32).abs()
    if keep is not None:
        diff, dist = diff[keep], dist[keep]
    err = float(diff.max()) / scale
    assert err <= BF16_TOL[name], (name, err)
    assert float(dist.max()) > 1e-5 * scale, name


@pytest.mark.parametrize("l_max,n_theta,n_phi,rows,route", BF16_CASES)
@pytest.mark.parametrize("method", METHODS)
def test_bf16_sht_matches_plain(cuda, method, l_max, n_theta, n_phi, rows,
                                route):
    """B1, B2, B3, B9 and B10 with bf16 tables on both routes (67 rows: a
    ragged 64-row tile of the tensor-core GEMMs, an odd θ count): the
    Legendre tables on the card in bf16, one launch of the _bf16 entry
    point, none of the float32 one; a second call bitwise equal."""
    sht = SphericalHarmonicTransform(l_max, n_theta, n_phi, device=cuda)
    fused = FusedSHT(sht, table_dtype=torch.bfloat16)
    f32 = FusedSHT(sht)
    assert fused.analysis_route == fused.synthesis_route == route
    assert fused._PW.dtype == fused._P_t.dtype == torch.bfloat16
    rng = np.random.default_rng(rows)
    grid = (rows, n_theta, n_phi)
    coef = (rows, 2 * l_max + 1, l_max + 1)
    if method in ("forward", "forward_real_abs2"):
        x = rng.normal(size=grid) + 1j * rng.normal(size=grid)
    elif method == "forward_real":
        x = rng.normal(size=grid)
    else:
        x = (rng.normal(size=coef) + 1j * rng.normal(size=coef)) \
            * sht.lm_mask[None]
    dtype = torch.float32 if method == "forward_real" else torch.complex64
    x = torch.as_tensor(x, dtype=dtype, device=cuda)
    got, again = getattr(fused, method)(x), getattr(fused, method)(x)
    want = getattr(fused.plain, method)(x)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, again)
    _bf16_close(method, got, want, getattr(f32, method)(x))
    assert fused.launches == {m + "_bf16": 2 * (m == method)
                              for m in METHODS}
    assert not any(f32.launches[m] for m in METHODS if m != method)


@pytest.mark.parametrize("l_max,n_theta,n_phi,rows,route", BF16_CASES)
def test_bf16_fused_iteration_matches_plain(cuda, l_max, n_theta, n_phi,
                                            rows, route):
    """B4, B5 (HIO, ft-stab, the weight plane), B6, B11 and B12 with bf16
    tables on both routes over 2 restarts of `rows` shells: B11 away from
    I_new = 0, B5 away from the real constraint's thresholds; the sums
    1e-4 relative (B5's Σwρ², Σwρ of the terms' magnitudes); one launch
    each of the _bf16 entry points."""
    sht = SphericalHarmonicTransform(l_max, n_theta, n_phi, device=cuda)
    rng = np.random.default_rng(rows + n_phi)
    batch, n_q = 2, rows
    w_rec = rng.uniform(0.1, 1.0, (n_q, n_theta))
    hankel = SphericalHankelTransform(
        generate_weights(l_max, n_q, 2.0, 3, "midpoint"), r_max=100.0,
        reciprocity_coefficient=2.0, device=cuda)
    fi = fused_mtip.FusedIteration(FusedSHT(sht, table_dtype=torch.bfloat16),
                                   w_rec=w_rec, hankel=hankel)
    fi32 = fused_mtip.FusedIteration(FusedSHT(sht), w_rec=w_rec,
                                     hankel=hankel)
    assert fi.synthesis_route == fi.projection_route == route

    def cx(shape, mask=False):
        x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        return torch.as_tensor(x * sht.lm_mask if mask else x,
                               dtype=torch.complex64, device=cuda)
    coef = (batch, n_q, 2 * l_max + 1, l_max + 1)
    grid = (batch, n_q, n_theta, n_phi)
    c, psi = cx(coef, True), cx(grid)
    away = fi.f.plain.inverse_real(c).abs()
    away = away > 1e-2 * float(away.max())
    for name, args, keep in (("hankel_synthesize", (c,), None),
                             ("inverse_real_project_fwd", (c, psi), None),
                             ("inverse_real_project", (c, psi), away),
                             ("synthesize_abs2", (c,), None)):
        got = getattr(fi, name)(*args)
        want = getattr(fi, name + "_plain")(*args)
        ref = getattr(fi32, name)(*args)
        torch.cuda.synchronize()
        if name == "hankel_synthesize":
            # the Hankel GEMM stays float32: cf is the float32 form's
            assert torch.equal(got[1], ref[1])
            _close(got[1], want[1], 1e-4)
            got, want, ref = got[:1], want[:1], ref[:1]
        for g, w, r in zip(got, want, ref):
            if g.dim() >= 3:
                _bf16_close(name, g, w, r,
                            keep if g.shape == psi.shape else None)
            else:
                assert float(((g - w).abs() / w.abs()).max()) <= 1e-4, name
    d, rho_in = cx(coef, True), cx(grid)
    support = torch.as_tensor(rng.uniform(size=grid) > 0.4, device=cuda)
    w = torch.as_tensor(rng.uniform(0.1, 1.0, (n_q, n_theta)),
                        dtype=torch.float32, device=cuda)
    c_phase = torch.as_tensor(np.exp(1j * rng.uniform(-3, 3, batch)),
                              dtype=torch.complex64, device=cuda)
    scale = float(fi.f.plain.inverse(d).abs().std())
    rc = RealConstraint(threshold_low=0.05 * scale, limit_imag=0.3 * scale)
    kw = dict(method="HIO", ft_stab=True, real_constraint=rc)
    args = (d, rho_in, support, w, 0.6, c_phase)
    got = fi.synthesize_update(*args, **kw)
    want = fi.synthesize_update_plain(*args, **kw)
    ref = fi32.synthesize_update(*args, **kw)
    rp, _ = fi.pre_constraint_plain(d, rho_in, c_phase, ft_stab=True)
    keep = fused_mtip.away_from_thresholds(rp, rc,
                                           1e-4 * float(rp.abs().max()))
    torch.cuda.synchronize()
    _bf16_close("synthesize_update", got[0], want[0], ref[0], keep)
    new = want[0].abs()
    scales = (want[1], want[2], (w[..., None] * new ** 2).sum((-3, -2, -1)),
              (w[..., None] * new).sum((-3, -2, -1)))
    for g, w_, s in zip(got[1:], want[1:], scales):
        assert float(((g - w_).abs() / s.abs()).max()) <= 1e-4
    assert fi.launches == dict.fromkeys(fused_mtip.BF16_METHODS, 1)
