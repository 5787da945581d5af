"""The host-side launch plans of the redesigned kernels B1–B12 (CPU).

B4 (`FusedIteration.inverse_real_project_fwd`) runs its φ-transforms as
Stockham FFTs where n_φ = 2^a·3^b·5^c: the wrapper's radix list, twiddle
table and bin map are what the kernel runs on, so each is held here against
`numpy.fft` through a numpy emulation of the kernel's passes (the same
index and twiddle arithmetic as `fft_pass` in `csrc/fft.cuh`), and the
route's two transforms (the paired inverse FFT of I_new, the analysis FFT
of ψ_p onto the 2L+1 columns) against the port's plain SHT. B5 and B6
synthesize on the same route (the triangle Legendre stage, the spectrum
scatter and one inverse FFT per θ line) with partial sums per θ tile of
the route. B1, B9 and B3 (`FusedSHT.forward`, `forward_real`,
`forward_real_abs2`) analyse on it: per θ tile the forward FFTs (B9 two
real θ lines per complex FFT, B3 two squared ones, then unpaired) into
Fourier columns laid out as the kernel writes them, then the triangle
quadrature block by block as the GEMM's tiles cut it, B9 and B3 with the
mirrored m < 0 rows. B2 (`FusedSHT.inverse`) synthesizes on B5's and B6's
route; B10 (`FusedSHT.inverse_real`) on it folded onto m ≥ 0, its Legendre
GEMM block by block, then two θ lines per inverse FFT, tile by tile. The
wrappers' launch operands for B9 and B10 (entry, scratch, twiddles, radix
code, line count) are read from a launch recorded on the CPU. B11
(`FusedIteration.inverse_real_project`) runs B10's route with the amplitude
projection as its epilogue, its partial sums per tile of 2·lines θ lines;
B12 (`synthesize_abs2`) B6's synthesis with B3's |ψ|² analysis of each
synthesis tile as its epilogue, then the mirrored quadrature; both are
emulated tile by tile, and their launch operands read from recorded
launches. How many θ lines each FFT block holds follows from n_φ
and the card's shared memory (the line rule of `ops/fft_plan.py`), and
B4's, B5's and B11's partial sums follow it. B8 (`fused_projection_bucket`) and
B7 (`polar_unitary`) spread each matrix over a thread-block cluster: the
cluster shape per bucket and the tile list of the Hermitian products are
host code too. Tolerances: 1e-5 relative for float32 transforms of at most
640 points (and 4096 and 8192 for the analysis), 1e-12 in float64.
"""
import numpy as np
import pytest
import torch

from xframe_tpu_torch.ops import fft_plan as plan
from xframe_tpu_torch.ops import fused_mtip, fused_projection as fp
from xframe_tpu_torch.ops.fused_sht import FusedSHT
from xframe_tpu_torch.ops.polar_schedule import DEFAULT_SCHEDULE
from xframe_tpu_torch.ops.sht import SphericalHarmonicTransform
from xframe_tpu_torch.projects.fxs.projections import crop_buckets


def stockham(x, radices, tw, inverse):
    """The kernel's FFT on the rows of x: pass p of radix R after passes
    whose radices multiply to ns reads x[j + r·n/R], twiddles it by
    tw[r·k·n/(ns·R)] (conjugated for the inverse), k = j mod ns, runs the
    radix-R DFT and writes (j/ns)·ns·R + k + r·ns."""
    n = x.shape[-1]
    w = tw.astype(np.complex128)
    if inverse:
        w = w.conj()
    ns = 1
    for R in radices:
        nb = n // R
        j = np.arange(nb)
        k = j % ns
        r = np.arange(R)[:, None]
        v = x[..., j[None, :] + r * nb] * w[r * k[None, :] * (n // (ns * R))]
        s = np.arange(R)
        dft = w[((r * s[None, :]) % R) * (n // R)]          # [r, s]
        y = np.einsum("...rj,rs->...sj", v, dft)
        out = np.empty_like(x)
        out[..., (j // ns)[None, :] * ns * R + k[None, :] + s[:, None] * ns] = y
        x = out
        ns *= R
    return x


@pytest.mark.parametrize("n,radices", [(512, [4, 4, 4, 4, 2]),
                                       (640, [4, 4, 4, 2, 5]),
                                       (96, [4, 4, 2, 3]), (130, None),
                                       (2 * 7, None), (4 ** 11, None)])
def test_fft_radices(n, radices):
    assert fused_mtip.fft_radices(n) == radices
    if radices is not None:
        assert int(np.prod(radices)) == n


def test_fft_twiddles_and_bins():
    n = 640
    tw = fused_mtip.fft_twiddles(n)
    assert tw.dtype == np.complex64 and tw.shape == (n,)
    assert np.abs(tw - np.exp(-2j * np.pi * np.arange(n) / n)).max() < 1e-7
    L = 127
    bins = fused_mtip.fft_bins(L, n)
    # column j of g holds m = j − L: numpy's frequency of that FFT bin
    freqs = np.rint(np.fft.fftfreq(n) * n).astype(int)
    assert np.array_equal(freqs[bins], np.arange(-L, L + 1))
    plan = fused_mtip.fft_plan(L, n, "cpu")
    # three bits per pass, first pass lowest
    assert [(plan.code >> (3 * k)) & 7 for k in range(5)] == [4, 4, 4, 2, 5]
    assert plan.code >> 15 == 0
    assert np.array_equal(plan.bins.numpy(), bins)
    assert fused_mtip.fft_plan(64, 130, "cpu") is None


@pytest.mark.parametrize("n", [512, 640, 96, 60])
@pytest.mark.parametrize("inverse", [False, True])
def test_stockham_emulation_matches_numpy(n, inverse):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    got = stockham(x, fused_mtip.fft_radices(n),
                   np.exp(-2j * np.pi * np.arange(n) / n), inverse)
    want = np.fft.ifft(x) * n if inverse else np.fft.fft(x)
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


def _sht(l_max, n_theta, n_phi):
    return SphericalHarmonicTransform(l_max, n_theta, n_phi, device="cpu")


def _route_h(sht, c):
    """H[θ, m] for m = 0..L, the kernel's legendre_pos without the factor 2:
    the hermitianized coefficients' m ≥ 0 Legendre sums."""
    L = sht.l_max
    P = sht._P.numpy().astype(np.float64)               # (2L+1, θ, L+1)
    signs = (-1.0) ** np.arange(L + 1)
    ch = 0.5 * (c[..., L:, :] + signs[:, None] * c[..., L::-1, :].conj())
    ch[..., 0, :] = c[..., L, :].real
    return np.einsum("...ml,mtl->...tm", ch, P[L:])


@pytest.mark.parametrize("l_max,n_theta,n_phi", [(10, 24, 48), (7, 17, 30),
                                                 (20, 40, 60)])
def test_fft_route_synthesis_matches_inverse_real(l_max, n_theta, n_phi):
    """Two θ lines in one complex inverse FFT, Z = H_a + i·H_b, give the
    plain SHT's I_new = Re iSHT(I_lm) of both (an odd θ count leaves the
    last line's partner zero)."""
    sht = _sht(l_max, n_theta, n_phi)
    rng = np.random.default_rng(l_max)
    shape = (2, 2 * l_max + 1, l_max + 1)
    c = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * sht.lm_mask
    H = _route_h(sht, c)                                 # (2, θ, L+1)
    H = np.concatenate([H, np.zeros_like(H[:, :n_theta % 2])], axis=1)
    ha, hb = H[:, 0::2], H[:, 1::2]
    Z = np.zeros(ha.shape[:-1] + (n_phi,), np.complex128)
    Z[..., 0] = ha[..., 0].real + 1j * hb[..., 0].real
    Z[..., 1:l_max + 1] = ha[..., 1:] + 1j * hb[..., 1:]
    Z[..., n_phi - l_max:] = (ha[..., 1:].conj()
                              + 1j * hb[..., 1:].conj())[..., ::-1]
    z = stockham(Z, fused_mtip.fft_radices(n_phi),
                 fused_mtip.fft_twiddles(n_phi), inverse=True)
    got = np.stack([z.real, z.imag], axis=2).reshape(2, -1, n_phi)[:, :n_theta]
    want = sht.inverse_real(torch.as_tensor(c, dtype=torch.complex64)).numpy()
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("l_max,n_theta,n_phi", [(10, 24, 48), (20, 40, 60)])
def test_fft_route_analysis_matches_forward(l_max, n_theta, n_phi):
    """2π/n_φ times the FFT bins of the bin map are the analysis's Fourier
    columns g, so the quadrature of g is the plain forward SHT."""
    sht = _sht(l_max, n_theta, n_phi)
    rng = np.random.default_rng(n_phi)
    f = rng.normal(size=(2, n_theta, n_phi)) \
        + 1j * rng.normal(size=(2, n_theta, n_phi))
    spec = stockham(f, fused_mtip.fft_radices(n_phi),
                    fused_mtip.fft_twiddles(n_phi), inverse=False)
    g = spec[..., fused_mtip.fft_bins(l_max, n_phi)] * (2 * np.pi / n_phi)
    got = sht._analysis(torch.as_tensor(g, dtype=torch.complex64)).numpy()
    want = sht.forward(torch.as_tensor(f, dtype=torch.complex64)).numpy()
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n_phi,route", [(512, "fft"), (640, "fft"),
                                         (30, "fft"), (130, "dense")])
def test_projection_route_follows_n_phi(n_phi, route):
    l_max = min(8, (n_phi - 1) // 2)
    fi = fused_mtip.FusedIteration(FusedSHT(_sht(l_max, 12, n_phi)))
    assert fi.projection_route == route


# ------------------------------------------------------------ B5 and B6
def _synthesis_fft_route(sht, c):
    """The FFT-route synthesis's arithmetic in numpy: legendre_gemm_kernel's
    Fourier columns fm[j, θ] over the triangle l ≥ |m| only, then
    synthesis_fft_kernel's spectrum (column j into bin k = j − L for
    j ≥ L, j − L + n_φ below; zero in the bins L+1 .. n_φ−L−1) and the
    emulated inverse Stockham passes."""
    L, n_phi = sht.l_max, sht.n_phi
    P = sht._P.numpy().astype(np.float64)               # (2L+1, θ, L+1)
    fm = np.zeros(c.shape[:-2] + (2 * L + 1, sht.n_theta), np.complex128)
    for j in range(2 * L + 1):
        m = abs(j - L)
        fm[..., j, :] = c[..., j, m:] @ P[j, :, m:].T
    j = np.arange(2 * L + 1)
    k = np.where(j >= L, j - L, j - L + n_phi)
    spec = np.zeros(fm.shape[:-2] + (sht.n_theta, n_phi), np.complex128)
    spec[..., k] = np.swapaxes(fm, -1, -2)
    gap = np.arange(L + 1, n_phi - L)
    assert not np.isin(k, gap).any() and len(k) + len(gap) == n_phi
    return stockham(spec, fused_mtip.fft_radices(n_phi),
                    fused_mtip.fft_twiddles(n_phi), inverse=True)


@pytest.mark.parametrize("l_max,n_theta,n_phi", [(10, 24, 48), (7, 17, 30),
                                                 (20, 40, 60)])
def test_fft_route_synthesis_matches_inverse(l_max, n_theta, n_phi):
    """B5's and B6's FFT-route synthesis (triangle Legendre GEMM, spectrum
    scatter, inverse FFT) is the plain SHT's inverse, 1e-5 relative."""
    sht = _sht(l_max, n_theta, n_phi)
    rng = np.random.default_rng(n_phi)
    shape = (3, 2 * l_max + 1, l_max + 1)
    c = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * sht.lm_mask
    got = _synthesis_fft_route(sht, c)
    want = sht.inverse(torch.as_tensor(c, dtype=torch.complex64)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


_SMEM_OPTIN = 227 * 1024  # the H100's opt-in shared memory per block
# θ lines per FFT block by the line rule on the H100: (synthesis, B4's
# projection) at each n_φ, L = min(8, (n_φ − 1)/2); 0: refused
_LINES = {512: (4, 8), 640: (4, 8), 30: (4, 8), 2048: (4, 4), 4096: (2, 2),
          8192: (1, 0)}


@pytest.fixture
def h100(monkeypatch):
    """The wrappers' line rule on the H100's shared memory, here without a
    card."""
    monkeypatch.setattr(plan, "smem_optin", lambda device: _SMEM_OPTIN)


@pytest.mark.parametrize("n_phi,route", [(512, "fft"), (640, "fft"),
                                         (30, "fft"), (130, "dense"),
                                         (2048, "fft"), (4096, "fft"),
                                         (8192, "fft")])
def test_synthesis_route_and_partials_follow_n_phi(h100, n_phi, route):
    """hankel_synthesize and synthesize_update take the FFT route exactly
    where B4 does, with a scratch of Fourier columns (rows, 2L+1, n_θ)
    there and none on the dense route; B5's partial sums (and B4's) come one
    per (row, θ tile) of that route: a tile holds the line rule's count of
    θ lines for each kernel (4, then 2 from n_φ = 4096, 1 at 8192 for B5;
    8, 4 at 2048, 2 at 4096 for B4, which refuses 8192), 16 on the dense
    route."""
    l_max, n_theta, rows = min(8, (n_phi - 1) // 2), 21, 10
    fused = FusedSHT(_sht(l_max, n_theta, n_phi))
    fi = fused_mtip.FusedIteration(fused)
    assert fi.synthesis_route == fi.projection_route == route
    (tw, fm), (code, lines) = fused.fft_operands(rows, fused.n_m,
                                                 "synthesis")
    if route == "dense":
        assert fm is None and tw is None and code == lines == 0
        assert fi._partials(rows, 6, lines).shape == (rows, 2, 6)
        return
    syn, proj = _LINES[n_phi]
    assert lines == fused.fft_lines("synthesis") == syn
    assert fi._partials(rows, 6, lines).shape == (rows, -(-n_theta // syn), 6)
    assert fm.shape == (rows, 2 * l_max + 1, n_theta)
    assert fm.dtype == torch.complex64
    assert code == fi._fft.code and tw is fi._fft.twiddles
    if proj == 0:
        with pytest.raises(RuntimeError, match=f"n_φ = {n_phi}"):
            fused.fft_lines("projection")
    else:
        assert fused.fft_lines("projection") == proj
        assert fi._partials(rows, 2, proj).shape \
            == (rows, -(-n_theta // proj), 2)


@pytest.mark.parametrize("n_phi", [512, 640, 2048, 4096, 8192, 9216, 9600,
                                   16384])
def test_fft_line_rule_follows_n_phi(n_phi):
    """The line rule on the H100's 227 KB: the analysis and the synthesis
    take 4 lines a block, 2 from n_φ = 4096 (the JAX package's default grid
    from L = 683), 1 at 8192 and none past ≈9250; B4 takes 8, 4 from 2048,
    2 at 4096 and none at 8192 (its tile's L+1 Legendre sums per line
    besides, L = n_φ/3 here, the default grid's largest). Each count is the
    largest whose block fits beside the 1 KB static reserve, and the count
    twice as large does not fit."""
    want = {512: (4, 8), 640: (4, 8), 2048: (4, 4), 4096: (2, 2),
            8192: (1, 0), 9216: (1, 0), 9600: (0, 0), 16384: (0, 0)}[n_phi]
    l_max = n_phi // 3
    stride = n_phi + (n_phi + 15) // 16

    def block(lines, per_line):
        return (2 * lines * stride + n_phi) * 8 + lines * per_line + 1024
    for kernel, lines, per_line in (("analysis", want[0], 0),
                                    ("synthesis", want[0], 0),
                                    ("projection", want[1],
                                     8 * (l_max + 1))):
        assert plan.fft_block_lines(kernel, n_phi, l_max, _SMEM_OPTIN) \
            == lines
        most, least = plan.FFT_KERNELS[kernel]
        assert lines == 0 or least <= lines <= most
        if lines:
            assert block(lines, per_line) <= _SMEM_OPTIN
        if lines < most:
            assert block(max(2 * lines, least), per_line) > _SMEM_OPTIN


def test_fft_lines_refusal_names_n_phi(h100):
    """Past its limit each FFT route raises before the launch, naming n_φ:
    at 16384 the synthesis (B2, B5, B6) and the analysis (B1, B3); B4 from
    8192 on."""
    fused = FusedSHT(_sht(4, 6, 16384))
    for kernel in plan.FFT_KERNELS:
        with pytest.raises(RuntimeError, match="n_φ = 16384"):
            fused.fft_lines(kernel)
        with pytest.raises(RuntimeError, match="n_φ = 16384"):
            fused.fft_operands(3, fused.n_m, kernel)
    assert FusedSHT(_sht(4, 6, 8192)).fft_lines("synthesis") == 1


@pytest.mark.parametrize("n_phi,route", [(640, "fft"), (4096, "fft"),
                                         (130, "dense")])
def test_inverse_route_and_scratch_follow_n_phi(h100, n_phi, route):
    """B2 (FusedSHT.inverse) synthesizes on the route B5 and B6 take, on
    the plan the FusedSHT shares with its FusedIteration: on the FFT route
    a (rows, 2L+1, n_θ) complex64 scratch of Fourier columns, the plan's
    twiddles and radix code and the line rule's count (4 at n_φ = 640, 2
    at 4096); on the dense route none of them."""
    l_max, n_theta, rows = min(8, (n_phi - 1) // 2), 13, 7
    fused = FusedSHT(_sht(l_max, n_theta, n_phi))
    fi = fused_mtip.FusedIteration(fused)
    assert fused.synthesis_route == fi.synthesis_route == route
    assert fi._fft is fused.fft
    (tw, fm), (code, lines) = fused.fft_operands(rows, fused.n_m,
                                                 "synthesis")
    if route == "dense":
        assert fused.fft is None and tw is fm is None and code == lines == 0
    else:
        assert fm.shape == (rows, 2 * l_max + 1, n_theta)
        assert fm.dtype == torch.complex64
        assert tw is fused.fft.twiddles and code == fused.fft.code
        assert lines == {640: 4, 4096: 2}[n_phi]


# ------------------------------------------------------------ B1 and B3
_Q_ROWS, _Q_L = 64, 32   # kQR, kQL of csrc/sht.cuh: the quadrature GEMM tile


def _fft_lines(n_phi):
    """The analysis's FFT lines per block on the H100 by the line rule: 4,
    2 at n_φ = 4096, 1 at 8192."""
    return plan.fft_block_lines("analysis", n_phi, 0, _SMEM_OPTIN)


def _analysis_ffts(sht, x, mode, tile=None):
    """analysis_fft_kernel's arithmetic in numpy, θ tile by θ tile at the
    launch's line count: the tile's lines zero-padded past n_θ (mode
    "complex": B1, one θ line per FFT line; "real": B9, θ lines 2k and 2k+1
    as the real and imaginary parts of FFT line k; "abs2": B3, |x|² of
    those lines), the emulated forward Stockham passes, then the Fourier
    columns times 2π/n_φ as the kernel writes its scratch g (rows, n_g,
    n_θ): B1 the 2L+1 bins (j − L) mod n_φ, B9 and B3 m = 0..L unpaired.
    tile: θ lines per block, by default the analysis's (its line count, or
    twice that for the paired modes); B12's epilogue analyses its synthesis
    tile of kLines lines, a lone line (kLines = 1) with a zero partner.
    Unwritten entries stay NaN."""
    L, n_theta, n_phi = sht.l_max, sht.n_theta, sht.n_phi
    rows, lines = x.shape[0], _fft_lines(n_phi)
    paired = mode != "complex"
    n_g = L + 1 if paired else 2 * L + 1
    if tile is None:
        tile = 2 * lines if paired else lines
    width = tile + tile % 2 if paired else tile    # θ lines the FFTs hold
    g = np.full((rows, n_g, n_theta), np.nan, np.complex128)
    m = np.arange(L + 1)
    j = np.arange(2 * L + 1)
    bins = np.where(j >= L, j - L, j - L + n_phi)
    assert np.array_equal(bins, plan.fft_bins(L, n_phi))
    for t0 in range(0, n_theta, tile):
        tcount = min(tile, n_theta - t0)
        src = np.zeros((rows, width, n_phi), np.complex128)
        src[:, :tcount] = x[:, t0:t0 + tcount]
        if paired:
            field = np.abs(src) ** 2 if mode == "abs2" else src.real
            src = field[:, 0::2] + 1j * field[:, 1::2]
        spec = stockham(src, plan.fft_radices(n_phi),
                        plan.fft_twiddles(n_phi), inverse=False)
        if paired:
            # A[m] = (Z[m] + conj Z[n−m])/2, B[m] = (Z[m] − conj Z[n−m])/2i
            # in the kernel's real arithmetic; Z[n−0] is Z[0]
            zm, zn = spec[..., m], spec[..., (n_phi - m) % n_phi]
            a = 0.5 * ((zm.real + zn.real) + 1j * (zm.imag - zn.imag))
            b = 0.5 * ((zm.imag + zn.imag) + 1j * (zn.real - zm.real))
            cols = np.stack([a, b], axis=2).reshape(rows, width, L + 1)
        else:
            cols = spec[..., bins]
        g[:, :, t0:t0 + tcount] = np.swapaxes(cols[:, :tcount], 1, 2) \
            * (2 * np.pi / n_phi)
    return g


def _quadrature_blocks(l_max, rows, mirror):
    """quadrature_gemm_kernel's blocks: (row slice, order j, the l it sums
    or None, the l below the triangle it zeroes or None). Per j (B9 and
    B3: m ≥ 0 only), per row tile, l tiles from |m| on; tiles past L sum
    nothing."""
    n_l = l_max + 1
    for j in range(l_max if mirror else 0, 2 * l_max + 1):
        m = abs(j - l_max)
        for r0 in range(0, rows, _Q_ROWS):
            rs = slice(r0, min(r0 + _Q_ROWS, rows))
            for bx in range(-(-n_l // _Q_L)):
                l0 = m + bx * _Q_L
                yield (rs, j,
                       slice(l0, min(l0 + _Q_L, n_l)) if l0 < n_l else None,
                       slice(0, m) if bx == 0 else None)


def _quadrature_gemm(sht, g, mirror):
    """The blocks' sums c[r, j, l] = Σ_θ g[r, j − j_begin, θ]·PW[j, θ, l]
    for l ≥ |m|, zeros below, and B9's and B3's row L − m = (−1)^m
    conj(c)."""
    L = sht.l_max
    PW = sht._PW.numpy().astype(np.float64)             # (2L+1, θ, L+1)
    c = np.full((g.shape[0], 2 * L + 1, L + 1), np.nan, np.complex128)
    j_begin = L if mirror else 0
    for rs, j, ls, zs in _quadrature_blocks(L, g.shape[0], mirror):
        m = abs(j - L)
        for s, v in ((zs, 0.0), (ls, None)):
            if s is None:
                continue
            if v is None:
                v = g[rs, j - j_begin] @ PW[j][:, s]
            c[rs, j, s] = v
            if mirror and m > 0:
                c[rs, L - m, s] = (-1.0) ** m * np.conj(v)
    return c


_ANALYSIS_SHAPES = [(10, 24, 48), (7, 17, 30), (20, 40, 60),
                    (10, 24, 4096), (7, 17, 8192)]


@pytest.mark.parametrize("l_max,n_theta,n_phi", _ANALYSIS_SHAPES)
def test_fft_route_forward_matches_plain(l_max, n_theta, n_phi):
    """B1's FFT route (forward FFT per θ line, the 2L+1 bins, the
    (rows, 2L+1, θ) scratch, the triangle quadrature per order with zeros
    below it) is the plain SHT's forward, 1e-5 relative, at 4, 2 (n_φ =
    4096) and 1 (8192) FFT lines per block."""
    sht = _sht(l_max, n_theta, n_phi)
    rng = np.random.default_rng(n_theta)
    f = rng.normal(size=(3, n_theta, n_phi)) \
        + 1j * rng.normal(size=(3, n_theta, n_phi))
    g = _analysis_ffts(sht, f, "complex")
    assert not np.isnan(g).any()
    got = _quadrature_gemm(sht, g, mirror=False)
    want = sht.forward(torch.as_tensor(f, dtype=torch.complex64)).numpy()
    assert got.shape == want.shape and not np.isnan(got).any()
    assert (got[~sht.lm_mask[None].repeat(3, 0)] == 0).all()
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("l_max,n_theta,n_phi", _ANALYSIS_SHAPES)
def test_fft_route_forward_real_abs2_matches_plain(l_max, n_theta, n_phi):
    """B3's FFT route (|ψ|² of two θ lines per complex FFT, an odd θ count
    leaving the last partner zero, the unpairing, the m ≥ 0 columns, the
    triangle quadrature and the mirror) is the plain SHT's
    forward_real_abs2, 1e-5 relative, at 4, 2 and 1 FFT lines per
    block."""
    sht = _sht(l_max, n_theta, n_phi)
    rng = np.random.default_rng(n_phi)
    psi = rng.normal(size=(3, n_theta, n_phi)) \
        + 1j * rng.normal(size=(3, n_theta, n_phi))
    g = _analysis_ffts(sht, psi, "abs2")
    assert g.shape == (3, l_max + 1, n_theta) and not np.isnan(g).any()
    # a real field's m = 0 column is real
    assert (g[:, 0].imag == 0).all()
    got = _quadrature_gemm(sht, g, mirror=True)
    want = sht.forward_real_abs2(
        torch.as_tensor(psi, dtype=torch.complex64)).numpy()
    assert got.shape == want.shape and not np.isnan(got).any()
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("l_max,n_theta,n_phi", _ANALYSIS_SHAPES)
def test_fft_route_forward_real_matches_plain(l_max, n_theta, n_phi):
    """B9's FFT route (two real θ lines per complex FFT, an odd θ count
    leaving the last partner zero, the unpairing, the m ≥ 0 columns, the
    triangle quadrature and the mirror) is the plain SHT's forward_real,
    1e-5 relative, at 4, 2 and 1 FFT lines per block."""
    sht = _sht(l_max, n_theta, n_phi)
    rng = np.random.default_rng(n_theta + n_phi)
    f = rng.normal(size=(3, n_theta, n_phi))
    g = _analysis_ffts(sht, f, "real")
    assert g.shape == (3, l_max + 1, n_theta) and not np.isnan(g).any()
    assert (g[:, 0].imag == 0).all()
    got = _quadrature_gemm(sht, g, mirror=True)
    want = sht.forward_real(torch.as_tensor(f, dtype=torch.float32)).numpy()
    assert got.shape == want.shape and not np.isnan(got).any()
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("l_max,rows", [(64, 256), (127, 256), (20, 67)])
@pytest.mark.parametrize("mirror", [False, True])
def test_quadrature_gemm_blocks_write_every_coefficient_once(l_max, rows,
                                                             mirror):
    """At the tutorial (2 × 128 rows, L = 64) and production (256 rows,
    L = 127) shapes, and a ragged row tile, the quadrature GEMM's blocks
    write every (row, j, l) exactly once, zeros included (B9 and B3: the
    m < 0 rows through the mirror)."""
    count = np.zeros((rows, 2 * l_max + 1, l_max + 1), np.int32)
    for rs, j, ls, zs in _quadrature_blocks(l_max, rows, mirror):
        for s in (ls, zs):
            if s is not None:
                count[rs, j, s] += 1
                if mirror and j > l_max:
                    count[rs, 2 * l_max - j, s] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("n_phi,route", [(512, "fft"), (640, "fft"),
                                         (30, "fft"), (130, "dense")])
def test_analysis_route_follows_n_phi(h100, n_phi, route):
    """B1 and B3 take the FFT route exactly where B4, B5 and B6 do, on the
    one plan the FusedSHT builds and its FusedIteration shares, with a
    scratch of Fourier columns (rows, n_cols, n_θ) there and none on the
    dense route."""
    l_max, n_theta = min(8, (n_phi - 1) // 2), 12
    fused = FusedSHT(_sht(l_max, n_theta, n_phi))
    fi = fused_mtip.FusedIteration(fused)
    assert fused.analysis_route == fi.projection_route == route
    assert fi._fft is fused.fft
    (_, g), (_, lines) = fused.fft_operands(5, l_max + 1, "analysis")
    if route == "dense":
        assert fused.fft is None and g is None and lines == 0
    else:
        assert g.shape == (5, l_max + 1, n_theta) and g.dtype == torch.complex64
        assert lines == 4
        assert fused.fft.code == sum(r << (3 * k) for k, r in enumerate(
            plan.fft_radices(n_phi)))


# ------------------------------------------------------------------ B10
_L_ROWS, _L_THETA, _L_K = 64, 64, 8   # kLR, kLT, kLK: the Legendre GEMM tile


def _legendre_gemm_folded(sht, c, count):
    """legendre_gemm_kernel<RealOut>'s blocks in numpy: per (θ tile, row
    tile, m = 0..L) the chunks of kLK orders l from m, each coefficient
    folded as it lands, c_h = (c[L+m] + (−1)^m conj c[L−m])/2 (c_h[0] =
    Re c[L]), summed into H[r, m, θ] = Σ_l c_h[r, m, l]·P̄_l^m(θ), the
    scratch (rows, L+1, n_θ); count[r, m, θ] counts the writes."""
    L, n_theta, n_l = sht.l_max, sht.n_theta, sht.l_max + 1
    rows = c.shape[0]
    Pt = np.swapaxes(sht._P.numpy().astype(np.float64), 1, 2)   # (j, l, θ)
    H = np.full((rows, n_l, n_theta), np.nan, np.complex128)
    for t0 in range(0, n_theta, _L_THETA):
        ts = slice(t0, min(t0 + _L_THETA, n_theta))
        for r0 in range(0, rows, _L_ROWS):
            rs = slice(r0, min(r0 + _L_ROWS, rows))
            for m in range(n_l):
                acc = np.zeros((rs.stop - r0, ts.stop - t0), np.complex128)
                for l0 in range(m, n_l, _L_K):
                    ls = slice(l0, min(l0 + _L_K, n_l))
                    a, b = c[rs, L + m, ls], c[rs, L - m, ls]
                    s = (-1.0) ** m
                    ch = 0.5 * ((a.real + s * b.real)
                                + 1j * (a.imag - s * b.imag))
                    acc += ch @ Pt[L + m, ls, ts]
                H[rs, m, ts] = acc
                count[rs, m, ts] += 1
    return H


def _paired_inverse_ffts(sht, H, lines, count):
    """synthesis_fft_kernel<RealOut, lines>'s blocks in numpy: per (row,
    tile of 2·lines θ lines), FFT line k holds Z[0] = Re H_a[0] +
    i·Re H_b[0], Z[m] = H_a[m] + i·H_b[m] and Z[n−m] = conj H_a[m] +
    i·conj H_b[m] for m = 1..L (θ lines a = 2k, b = 2k+1 of the tile, zero
    past n_θ), zero elsewhere; the emulated inverse Stockham passes; Re z
    to line a, Im z to line b, lines past n_θ not written; count[θ] counts
    the writes of each θ line."""
    L, n_theta, n_phi = sht.l_max, sht.n_theta, sht.n_phi
    rows, tile = H.shape[0], 2 * lines
    f = np.full((rows, n_theta, n_phi), np.nan)
    m = np.arange(1, L + 1)
    for t0 in range(0, n_theta, tile):
        tcount = min(tile, n_theta - t0)
        h = np.zeros((rows, L + 1, tile), np.complex128)
        h[..., :tcount] = H[..., t0:t0 + tcount]
        ha = np.swapaxes(h[..., 0::2], 1, 2)            # (rows, lines, L+1)
        hb = np.swapaxes(h[..., 1::2], 1, 2)
        Z = np.zeros((rows, lines, n_phi), np.complex128)
        Z[..., 0] = ha[..., 0].real + 1j * hb[..., 0].real
        Z[..., m] = (ha[..., 1:].real - hb[..., 1:].imag) \
            + 1j * (ha[..., 1:].imag + hb[..., 1:].real)
        Z[..., n_phi - m] = (ha[..., 1:].real + hb[..., 1:].imag) \
            + 1j * (hb[..., 1:].real - ha[..., 1:].imag)
        z = stockham(Z, plan.fft_radices(n_phi), plan.fft_twiddles(n_phi),
                     inverse=True)
        out = np.stack([z.real, z.imag], axis=2).reshape(rows, tile, n_phi)
        f[:, t0:t0 + tcount] = out[:, :tcount]
        count[t0:t0 + tcount] += 1
    return f


@pytest.mark.parametrize("l_max,n_theta,n_phi,rows",
                         [(10, 23, 48, 3), (7, 17, 30, 2), (12, 70, 60, 67),
                          (10, 23, 4096, 2), (7, 17, 8192, 2)])
def test_fft_route_inverse_real_matches_plain(l_max, n_theta, n_phi, rows):
    """B10's FFT route as it is cut, the folded m ≥ 0 Legendre GEMM block
    by block (every (r, m, θ) of its scratch written once; 67 rows and 70
    θ lines: ragged 64-row and 64-line tiles), then the paired inverse FFT
    tile by tile at the line rule's count (4, 2 at n_φ = 4096, 1 at 8192;
    odd θ counts and a ragged last tile, every θ line written once), is the
    plain SHT's inverse_real, 1e-5 relative, for coefficients that are not
    Hermitian."""
    sht = _sht(l_max, n_theta, n_phi)
    rng = np.random.default_rng(n_theta * n_phi)
    shape = (rows, 2 * l_max + 1, l_max + 1)
    c = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * sht.lm_mask
    # far from c_{l,−m} = (−1)^m conj c_{l,m}
    signs = (-1.0) ** np.arange(-l_max, l_max + 1)[:, None]
    assert np.abs(c - signs * c[:, ::-1].conj()).max() > 0.5 * np.abs(c).max()
    count = np.zeros((rows, l_max + 1, n_theta), np.int32)
    H = _legendre_gemm_folded(sht, c, count)
    assert (count == 1).all()
    lines = plan.fft_block_lines("synthesis", n_phi, l_max, _SMEM_OPTIN)
    assert lines == {4096: 2, 8192: 1}.get(n_phi, 4)
    written = np.zeros(n_theta, np.int32)
    got = _paired_inverse_ffts(sht, H, lines, written)
    assert (written == 1).all()
    want = sht.inverse_real(torch.as_tensor(c, dtype=torch.complex64)).numpy()
    assert got.shape == want.shape and not np.isnan(got).any()
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


# ------------------------------------------------------------ B11 and B12
def _project_tiles(psi, i_new, w, n_q, tile):
    """synthesis_fft_kernel<ProjectOut>'s epilogue in numpy, per (row, tile
    of `tile` θ lines): ψ_p = ψ·√(I_new/|ψ|²) where |ψ|² > 0 and I_new ≥ 0,
    else 0, and the block's partials Σw|ψ−ψ_p|², Σw|ψ|² (w[q, θ], q = row
    mod n_q), laid out (rows, θ tiles, 2) as the kernel writes them."""
    rows, n_theta = psi.shape[:2]
    inten = np.abs(psi) ** 2
    valid = (inten > 0) & (i_new >= 0)
    psi_p = psi * np.sqrt(np.where(valid, i_new / np.where(valid, inten, 1),
                                   0.0))
    wr = w[np.arange(rows) % n_q][..., None]             # (rows, θ, 1)
    terms = np.stack([(wr * np.abs(psi - psi_p) ** 2).sum(-1),
                      (wr * inten).sum(-1)], axis=-1)     # (rows, θ, 2)
    parts = np.stack([terms[:, t0:t0 + tile].sum(1)
                      for t0 in range(0, n_theta, tile)], axis=1)
    return psi_p, parts


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("l_max,n_theta,n_phi,n_q",
                         [(10, 24, 48, 3), (7, 17, 30, 2), (12, 70, 60, 67),
                          (10, 23, 4096, 2), (7, 17, 8192, 3)])
def test_fft_route_inverse_real_project_matches_plain(l_max, n_theta, n_phi,
                                                      n_q, weighted):
    """B11's FFT route as it is cut: B10's folded Legendre GEMM block by
    block and its paired inverse FFT tile by tile give I_new, never stored;
    the ProjectOut epilogue turns it into ψ_p and per-block partials over
    tiles of 2·lines θ lines (8, 4 at n_φ = 4096, 2 at 8192; even and odd
    θ counts, a ragged last tile; 67 shells: ragged 64-row GEMM tiles), the
    wrapper's partials scratch has that shape, and its per-restart sums
    are the plain version's, weighted by w_rec or not, for random
    coefficients (I_new < 0 on about half the grid). 1e-5 relative:
    ψ_p away from I_new = 0 (where √ turns a rounding difference δ into
    one of √δ), the sums everywhere."""
    sht = _sht(l_max, n_theta, n_phi)
    rng = np.random.default_rng(n_theta + n_phi + weighted)
    batch = 2
    rows = batch * n_q
    c = (rng.normal(size=(rows, 2 * l_max + 1, l_max + 1))
         + 1j * rng.normal(size=(rows, 2 * l_max + 1, l_max + 1))) \
        * sht.lm_mask
    psi = rng.normal(size=(rows, n_theta, n_phi)) \
        + 1j * rng.normal(size=(rows, n_theta, n_phi))
    w = rng.uniform(0.1, 1.0, (n_q, n_theta)) if weighted \
        else np.ones((n_q, n_theta))
    lines = plan.fft_block_lines("synthesis", n_phi, l_max, _SMEM_OPTIN)
    assert lines == {4096: 2, 8192: 1}.get(n_phi, 4)
    count = np.zeros((rows, l_max + 1, n_theta), np.int32)
    written = np.zeros(n_theta, np.int32)
    i_new = _paired_inverse_ffts(sht, _legendre_gemm_folded(sht, c, count),
                                 lines, written)
    assert (count == 1).all() and (written == 1).all()
    assert 0.3 < (i_new < 0).mean() < 0.7
    psi_p, parts = _project_tiles(psi, i_new, w, n_q, 2 * lines)
    fi = fused_mtip.FusedIteration(FusedSHT(sht),
                                   w_rec=w if weighted else None)
    assert fi._partials(rows, 2, 2 * lines).shape == parts.shape
    got = fi._restart_sums(torch.as_tensor(parts), n_q, (batch,))
    lead = (batch, n_q)
    want = fi.inverse_real_project_plain(
        torch.as_tensor(c.reshape(lead + c.shape[1:]), dtype=torch.complex64),
        torch.as_tensor(psi.reshape(lead + psi.shape[1:]),
                        dtype=torch.complex64))
    away = np.abs(i_new) > 1e-2 * np.abs(i_new).max()
    want_p = want[0].numpy().reshape(psi.shape)
    assert np.abs(psi_p - want_p)[away].max() \
        <= 1e-5 * np.abs(want_p).max()
    for g, w_ in zip(got, want[1:]):
        assert g.shape == (batch,)
        assert (np.abs(g.numpy() - w_.numpy())
                <= 1e-5 * np.abs(w_.numpy())).all()


@pytest.mark.parametrize("l_max,n_theta,n_phi,rows",
                         [(10, 24, 48, 3), (7, 17, 30, 2), (12, 70, 60, 67),
                          (10, 23, 4096, 2), (7, 17, 8192, 2)])
def test_fft_route_synthesize_abs2_matches_plain(l_max, n_theta, n_phi, rows):
    """B12's FFT route as it is cut: B6's synthesis (the triangle Legendre
    GEMM, the spectrum scatter, the inverse FFT) gives ψ; per synthesis tile
    of kLines θ lines (4, 2 at n_φ = 4096, 1 at 8192: a lone |ψ|² line with
    a zero partner; odd θ counts, a ragged last tile), |ψ|² of θ lines 2k
    and 2k+1 in FFT line k, the forward FFTs and B3's unpairing into the
    (rows, L+1, n_θ) scratch, every column written once, then the mirrored
    quadrature GEMM block by block: ψ and the coefficients are the plain
    version's, 1e-5 relative."""
    sht = _sht(l_max, n_theta, n_phi)
    rng = np.random.default_rng(n_theta * n_phi + rows)
    shape = (rows, 2 * l_max + 1, l_max + 1)
    c = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * sht.lm_mask
    lines = plan.fft_block_lines("synthesis", n_phi, l_max, _SMEM_OPTIN)
    assert lines == {4096: 2, 8192: 1}.get(n_phi, 4)
    psi = _synthesis_fft_route(sht, c)
    g = _analysis_ffts(sht, psi, "abs2", tile=lines)
    assert g.shape == (rows, l_max + 1, n_theta) and not np.isnan(g).any()
    assert (g[:, 0].imag == 0).all()
    got = _quadrature_gemm(sht, g, mirror=True)
    fi = fused_mtip.FusedIteration(FusedSHT(sht))
    want_psi, want_c = (x.numpy() for x in fi.synthesize_abs2_plain(
        torch.as_tensor(c, dtype=torch.complex64)))
    assert psi.shape == want_psi.shape and got.shape == want_c.shape
    assert not np.isnan(got).any()
    assert np.abs(psi - want_psi).max() <= 1e-5 * np.abs(want_psi).max()
    assert np.abs(got - want_c).max() <= 1e-5 * np.abs(want_c).max()


@pytest.mark.parametrize("n_phi,route,lines", [(640, "fft", 4),
                                               (4096, "fft", 2),
                                               (8192, "fft", 1),
                                               (130, "dense", 0),
                                               (16384, "fft", None)])
@pytest.mark.parametrize("method", ["inverse_real_project",
                                    "synthesize_abs2"])
def test_variants_route_scratch_and_partials_follow_n_phi(h100, monkeypatch,
                                                          method, n_phi,
                                                          route, lines):
    """B11 (inverse_real_project) and B12 (synthesize_abs2) take the
    synthesis route of B5 and B6 (FusedIteration.synthesis_route), read
    from one launch recorded on the CPU: on the FFT route the plan's
    twiddles and radix code and the synthesis line rule's count (4 at n_φ =
    640, 2 at 4096, 1 at 8192); B11 a (rows, L+1, n_θ) scratch and partial
    sums per tile of 2·lines θ lines, B12 a (rows, 2L+1, n_θ) scratch for
    its synthesis and a (rows, L+1, n_θ) one for its |ψ|² columns; on the
    dense route no twiddles or synthesis scratch, B11's partials per 16 θ
    lines and B12's columns (rows, n_θ, L+1); past the rule's limit
    (16384) a refusal naming n_φ before any launch."""
    l_max, n_theta, batch, n_q = min(8, (n_phi - 1) // 2), 13, 2, 3
    rows = batch * n_q
    fused = FusedSHT(_sht(l_max, n_theta, n_phi))
    w = np.ones((n_q, n_theta), np.float32)
    fi = fused_mtip.FusedIteration(fused, w_rec=w)
    assert fi.synthesis_route == route
    calls = []
    monkeypatch.setattr(fi, "_on_card", lambda x: True)
    monkeypatch.setattr(fi, "_launch", lambda *a: calls.append(a))
    c = torch.zeros((batch, n_q, 2 * l_max + 1, l_max + 1),
                    dtype=torch.complex64)
    psi = torch.zeros((batch, n_q, n_theta, n_phi), dtype=torch.complex64)
    call = (lambda: fi.inverse_real_project(c, psi)) \
        if method == "inverse_real_project" else (lambda: fi.synthesize_abs2(c))
    if lines is None:
        with pytest.raises(RuntimeError, match=f"n_φ = {n_phi}"):
            call()
        assert calls == []
        return
    call()
    ((name, entry, tensors, ints),) = calls
    assert (name, entry) == (method, f"xf_{method}")
    assert tuple(tensors[0].shape) == (rows, 2 * l_max + 1, l_max + 1)
    assert all(a is b for a, b in zip(tensors[1:4], (fused._P_t, fused._I_re,
                                                    fused._I_im)))
    code = 0 if route == "dense" else fused.fft.code
    if method == "inverse_real_project":
        _, _, _, _, p, w_rec, tw, fm, psi_p, parts = tensors
        assert ints == (rows, n_q, n_theta, n_phi, l_max, code, lines)
        assert w_rec is fi._w_rec and p.shape == psi_p.shape \
            == (rows, n_theta, n_phi)
        assert parts.shape == (rows, -(-n_theta // (2 * lines or 16)), 2)
        cols = (rows, l_max + 1, n_theta)
    else:
        *tables, tw, fm, out_psi, g, out_c = tensors[4:]
        assert all(a is b for a, b in zip(tables, (fused._E_re, fused._E_im,
                                                   fused._PW)))
        assert ints == (rows, n_theta, n_phi, l_max, code, lines)
        assert out_psi.shape == (rows, n_theta, n_phi)
        assert out_c.shape == (rows, 2 * l_max + 1, l_max + 1)
        assert g.dtype == torch.complex64
        assert g.shape == ((rows, n_theta, l_max + 1) if route == "dense"
                           else (rows, l_max + 1, n_theta))
        cols = (rows, 2 * l_max + 1, n_theta)
    if route == "dense":
        assert tw is fm is None
    else:
        assert tw is fused.fft.twiddles
        assert fm.shape == cols and fm.dtype == torch.complex64


def _recorded_launches(fused, monkeypatch):
    """fused's launches on the CPU: a CPU tensor takes the kernel's way,
    and each launch is recorded as (method, entry, x, tensors, ints)
    instead of made."""
    calls = []
    monkeypatch.setattr(fused, "_rows", lambda x, tail, dtype:
                        x.reshape((-1,) + tail).to(dtype))
    monkeypatch.setattr(fused, "_launch", lambda *a: calls.append(a))
    return calls


@pytest.mark.parametrize("n_phi,route,lines", [(640, "fft", 4),
                                               (4096, "fft", 2),
                                               (8192, "fft", 1),
                                               (130, "dense", 0),
                                               (16384, "fft", None)])
@pytest.mark.parametrize("method", ["forward_real", "inverse_real"])
def test_real_transforms_route_and_scratch_follow_n_phi(h100, monkeypatch,
                                                        method, n_phi, route,
                                                        lines):
    """B9 (forward_real) and B10 (inverse_real) take the routes of B1 and
    B2: on the FFT route their one launch gets the plan's twiddles and
    radix code, the line rule's count of the analysis or the synthesis
    kernel (4 at n_φ = 640, 2 at 4096, 1 at 8192) and a (rows, L+1, n_θ)
    complex64 scratch of Fourier columns, half of B1's and B2's; on the
    dense route none of them; past the rule's limit (16384) the wrapper
    refuses, naming n_φ, before any launch."""
    l_max, n_theta, rows = min(8, (n_phi - 1) // 2), 13, 7
    fused = FusedSHT(_sht(l_max, n_theta, n_phi))
    coef = (rows, 2 * l_max + 1, l_max + 1)
    grid = (rows, n_theta, n_phi)
    if method == "forward_real":
        assert fused.analysis_route == route
        x, out_shape = torch.zeros(grid), coef
        tables = (fused._E_re, fused._E_im, fused._PW)
    else:
        assert fused.synthesis_route == route
        x, out_shape = torch.zeros(coef, dtype=torch.complex64), grid
        tables = (fused._P_t, fused._I_re, fused._I_im)
    calls = _recorded_launches(fused, monkeypatch)
    if lines is None:
        with pytest.raises(RuntimeError, match=f"n_φ = {n_phi}"):
            getattr(fused, method)(x)
        assert calls == []
        return
    out = getattr(fused, method)(x)
    ((name, entry, xin, tensors, ints),) = calls
    assert (name, entry) == (method, f"xf_sht_{method}")
    assert tuple(xin.shape) == tuple(x.shape)
    *got_tables, tw, scratch, dst = tensors
    assert all(a is b for a, b in zip(got_tables, tables))
    assert dst.shape == out_shape and out.shape == out_shape
    if route == "dense":
        assert fused.fft is None and tw is scratch is None
        assert ints == (0, 0)
    else:
        assert scratch.shape == (rows, l_max + 1, n_theta)
        assert scratch.dtype == torch.complex64
        assert tw is fused.fft.twiddles and ints == (fused.fft.code, lines)


def test_fft_plan_names_stay_importable_from_fused_mtip():
    for name in ("fft_radices", "fft_twiddles", "fft_bins", "FftPlan",
                 "fft_plan"):
        assert getattr(fused_mtip, name) is getattr(plan, name)


# ------------------------------------------------------- launch device
def test_every_entry_point_launches_under_its_tensors_device(h100,
                                                             monkeypatch):
    """The C side reads the current CUDA device (the FFT line rule's
    cudaGetDevice, cudaFuncSetAttribute, the occupancy query) and CUDA
    refuses a launch into another device's stream, so a tensor on card N
    must launch with card N current. Every entry point of the library,
    reached through its wrapper from CPU tensors that take the kernel's way
    (the card checks passed, the library replaced by a recorder), is called
    inside torch.cuda.device(<the input tensor's device>) on that device's
    current stream; the SHT and fused-iteration entry points in their
    float32-table and bf16-table forms."""
    import ctypes
    from types import SimpleNamespace
    from xframe_tpu_torch.ops import _build
    from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
    current, calls = [], []

    class Current:                      # torch.cuda.device
        def __init__(self, device):
            self.device = torch.device(device)

        def __enter__(self):
            current.append(self.device)

        def __exit__(self, *exc):
            current.pop()

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, current[-1] if current else None,
                              args[-1]))
                if name == "xf_max_active_clusters":
                    ctypes.c_int.from_address(args[0]).value = 1
                return 0
            return entry

    def stream(device):
        assert current and current[-1] == torch.device(device)
        return SimpleNamespace(cuda_stream=("stream", str(device)))

    monkeypatch.setattr(torch.cuda, "device", Current)
    monkeypatch.setattr(torch.cuda, "current_stream", stream)
    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(fp, "_on_card", lambda x, name: True)
    monkeypatch.setattr(fp, "_sm_count", lambda device: 132)
    monkeypatch.setattr(fp, "launches", dict.fromkeys(fp.METHODS, 0))
    fp.max_active_clusters.cache_clear()
    # the float32 tables' entry points, then their bf16 forms
    for table_dtype in (None, torch.bfloat16):
        p = make_demo_problem(8, 4, fused_sht=True, device="cpu",
                              fused_table_dtype=table_dtype)
        fused, fi = p.ft.harmonic, p.mtip._fi
        monkeypatch.setattr(fused, "_rows", lambda x, tail, dtype:
                            x.reshape((-1,) + tail).to(dtype))
        monkeypatch.setattr(fi, "_on_card", lambda x: True)
        n_q, L = p.ft.n_radial_points, fused.l_max
        grid = torch.ones((2, n_q, fused.n_theta, fused.n_phi),
                          dtype=torch.complex64)
        coef = torch.ones((2, n_q, 2 * L + 1, L + 1), dtype=torch.complex64)
        fused.forward(grid)
        fused.forward_real(grid.real)
        fused.forward_real_abs2(grid)
        fused.inverse(coef)
        fused.inverse_real(coef)
        fi.hankel_synthesize(coef)
        fi.inverse_real_project_fwd(coef, grid)
        fi.inverse_real_project(coef, grid)
        fi.synthesize_abs2(coef)
        fi.synthesize_update(coef, grid, grid.real > 0,
                             torch.ones((n_q, fused.n_theta)), 0.5,
                             torch.ones(2, dtype=torch.complex64),
                             method="HIO", ft_stab=True,
                             real_constraint=p.mtip.real)
    c = 5
    fp.polar_unitary(torch.ones((3, c, c), dtype=torch.complex64))
    fp.fused_projection_bucket(
        torch.ones((2, c, n_q), dtype=torch.complex64),
        torch.ones((2, 2, n_q, c), dtype=torch.complex64),
        torch.ones((2, n_q, c), dtype=torch.complex64),
        torch.ones((2, n_q)), l_lo=1, h=2)
    fp.max_active_clusters.cache_clear()
    assert {name for name, _, _ in calls} == set(_build._ENTRY_POINTS)
    for name, device, s in calls:
        assert device == grid.device, name
        assert s == ("stream", str(grid.device)), name


# ------------------------------------------------------------------ B8
@pytest.mark.parametrize("c", [11, 64, 65, 127, 129, 253, 255])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_hermitian_tiles_cover_the_upper_triangle_once(c, cluster):
    """Every element on or above the diagonal of a c×c product lies in
    exactly one listed 64×64 tile, no listed tile lies wholly below it, and
    the ranks of a cluster (rank r takes entries r, r + S, …) share the list
    without overlap."""
    tiles = fp.hermitian_tiles(c)
    nt = -(-c // 64)
    assert tiles.dtype == np.int32 and len(tiles) == nt * (nt + 1) // 2
    cover = np.zeros((c, c), int)
    for i, j in tiles:
        cover[64 * i:64 * i + 64, 64 * j:64 * j + 64] += 1
    upper = np.triu(np.ones((c, c), bool))
    assert (cover[upper] == 1).all()
    assert (tiles[:, 1] >= tiles[:, 0]).all()
    taken = np.concatenate([np.arange(r, len(tiles), cluster)
                            for r in range(cluster)])
    assert np.array_equal(np.sort(taken), np.arange(len(tiles)))


# the resident clusters of B8's kernel an H100 (132 SMs) reports through
# cudaOccupancyMaxActiveClusters for each (S blocks, G product groups)
# (chip_smoke.py's kernel_bucket lines)
H100 = {(1, 1): 264, (2, 1): 132, (4, 1): 62, (8, 1): 30, (16, 1): 14,
        (1, 2): 132, (2, 2): 66, (4, 2): 30, (8, 2): 15, (16, 2): 7}


def test_launch_shape_spreads_every_production_bucket():
    """At the production projection (N_q = 256, L = 127, 1 restart) every
    bucket puts workers on most of the 132 SMs in one wave, and the lone
    full-width order takes the largest cluster."""
    shapes = {}
    for l_lo, l_hi, h in crop_buckets(127):
        n_mat, c = l_hi - l_lo + 1, 2 * h + 1
        s, g = fp.launch_shape(n_mat, c, H100, 132)
        assert n_mat * s <= 132 * 2 // g
        assert n_mat * s * g >= min(252, n_mat * -(-c // 64) ** 2)
        shapes[c] = (s, g)
    assert shapes == {127: (2, 2), 253: (2, 2), 255: (16, 1)}
    # tutorial: 2 restarts × 64 orders at c = 127, 2 × 1 at c = 129
    assert fp.launch_shape(128, 127, H100, 132) == (2, 1)
    assert fp.launch_shape(2, 129, H100, 132) == (8, 1)


def test_launch_shape_limits():
    # never more workers than a product has output tiles
    assert fp.launch_shape(1, 11, H100, 132) == (1, 1)
    # one matrix: workers on SMs of their own beat two workers per SM
    assert fp.launch_shape(1, 65, H100, 132) == (4, 1)
    # a shape the card does not hold is never chosen
    res = dict(H100)
    res[(16, 1)] = 0
    assert fp.launch_shape(1, 255, res, 132) == (8, 2)
    with pytest.raises(RuntimeError):
        fp.launch_shape(1, 255, dict.fromkeys(res, 0), 132)
    # enough matrices to fill the card many times over: one worker each,
    # which wastes no tile slots
    assert fp.launch_shape(10_000, 127, H100, 132) == (1, 1)


# the resident clusters of B7's kernel an H100 (132 SMs) reports through
# cudaOccupancyMaxActiveClusters for each (S blocks, G product groups)
# (chip_smoke.py's kernel_bucket lines of polar_unitary): B8's, measured
H100_B7 = {(1, 1): 264, (2, 1): 132, (4, 1): 62, (8, 1): 30, (16, 1): 14,
           (1, 2): 132, (2, 2): 66, (4, 2): 30, (8, 2): 15, (16, 2): 7}


def test_polar_launch_plan_per_production_bucket(monkeypatch):
    """B7 in finalize at the production projection (N_q = 256, L = 127, 1
    restart): per crop bucket the cluster shape launch_shape picks from
    B7's own resident clusters (every bucket spread over most of the 132
    SMs in one wave, the lone full-width order on the largest cluster), and
    the launch it makes: the tile list of the Hermitian products for its c,
    the cluster shape, the schedule's steps and the matrix count."""
    calls = []
    monkeypatch.setattr(fp, "_launch", lambda *a: calls.append(a))
    rows = fp.schedule_rows(16, DEFAULT_SCHEDULE)
    shapes = {}
    for l_lo, l_hi, h in crop_buckets(127):
        n_mat, c = l_hi - l_lo + 1, 2 * h + 1
        s, g = shapes[c] = fp.launch_shape(n_mat, c, H100_B7, 132)
        assert n_mat * s <= 132 * 2 // g
        assert n_mat * s * g >= min(252, n_mat * -(-c // 64) ** 2)
        x = torch.zeros((n_mat, c, c), dtype=torch.complex64)
        fp.launch_polar(x, torch.empty_like(x), rows, (s, g))
        method, entry, device, *args = calls[-1]
        herm = fp._herm_table(c, device)
        assert (method, entry) == ("polar_unitary", "xf_polar_unitary")
        assert np.array_equal(herm.numpy(), fp.hermitian_tiles(c))
        assert args[0] == x.data_ptr() and args[4] == herm.data_ptr()
        assert args[5:] == [len(herm), s, g, len(rows), n_mat, c]
    assert shapes == {127: (2, 2), 253: (2, 2), 255: (16, 1)}
