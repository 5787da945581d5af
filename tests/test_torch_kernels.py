"""The CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU and nvcc (marker `cuda`); elsewhere every test skips.
Run on a GPU machine with
`python3 -m pytest --noconftest tests/test_torch_kernels.py`.
Tolerance 1e-5·max for the SHT kernels: float32 sums over at most 48 φ and
24 θ terms, taken in another order than cuFFT's and cuBLAS's. The fused MTIP
kernels keep the JAX package's own tolerances for them
(tests/test_transforms.py:386-563): 1e-4·max for coefficients and the
Hankel-fused synthesis, 2e-5·max for the updated density away from the real
constraint's thresholds, 1e-4 relative for every sum.
"""
import numpy as np
import pytest
import torch

from xframe_tpu_torch.ops import fused_mtip
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
    the fused iteration once an iteration, and refuses fused_sht=False
    there."""
    from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
    from xframe_tpu_torch.projects.fxs.phasing import Segment
    with pytest.raises(ValueError):
        make_demo_problem(8, 4, fused_sht=False, device=cuda)
    p = make_demo_problem(8, 4, device=cuda)
    rho0 = p.initial_density_batch(0, 2)
    p.ft.harmonic.reset_launches()
    _, errors = p.mtip.run_batch(
        rho0, [Segment("HIO", 1, betas=np.full(1, 0.5), ft_stab=True)])
    assert bool(torch.isfinite(errors).all())
    assert p.ft.harmonic.launches == {"forward": 1, "inverse": 0,
                                      "forward_real": 0, "inverse_real": 0,
                                      "forward_real_abs2": 1}
    assert p.mtip._fi.launches == dict.fromkeys(fused_mtip.METHODS, 1)


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
    for fi in (fused_mtip.FusedIteration(fused, hankel=hankel),
               fused_mtip.FusedIteration(fused, w_rec=w_rec, hankel=hankel)):
        for got, want in zip(fi.hankel_synthesize(c),
                             fi.hankel_synthesize_plain(c)):
            _close(got, want, 1e-4)
        got = fi.inverse_real_project_fwd(c, psi)
        want = fi.inverse_real_project_fwd_plain(c, psi)
        _close(got[0], want[0], 1e-4)
        for g, w in zip(got[1:], want[1:]):
            assert g.shape == (batch,)
            assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().min())
        torch.cuda.synchronize()
        assert fi.launches == {"hankel_synthesize": 1,
                               "inverse_real_project_fwd": 1,
                               "synthesize_update": 0}


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
    with pytest.raises(NotImplementedError):
        fi.synthesize_update(d, rho_in, support, w[None, :, :, None]
                             .expand(grid), 0.6, c_phase, **kw)
