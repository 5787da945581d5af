"""The host-side launch plans of the redesigned kernels B1, B3, B4, B5, B6
and B8 (CPU).

B4 (`FusedIteration.inverse_real_project_fwd`) runs its φ-transforms as
Stockham FFTs where n_φ = 2^a·3^b·5^c: the wrapper's radix list, twiddle
table and bin map are what the kernel runs on, so each is held here against
`numpy.fft` through a numpy emulation of the kernel's passes (the same
index and twiddle arithmetic as `fft_pass` in `csrc/fft.cuh`), and the
route's two transforms (the paired inverse FFT of I_new, the analysis FFT
of ψ_p onto the 2L+1 columns) against the port's plain SHT. B5 and B6
synthesize on the same route (the triangle Legendre stage, the spectrum
scatter and one inverse FFT per θ line) with partial sums per θ tile of
the route. B1 and B3 (`FusedSHT.forward`, `forward_real_abs2`) analyse on
it: per θ tile the forward FFTs (B3 two squared θ lines per complex FFT,
then unpaired) into Fourier columns laid out as the kernel writes them,
then the triangle quadrature block by block as the GEMM's tiles cut it,
B3 with the mirrored m < 0 rows. B8
(`fused_projection_bucket`) spreads each matrix over a thread-block
cluster: the cluster shape per bucket and the tile list of the Hermitian
products are host code too. Tolerances: 1e-5 relative for float32
transforms of at most 640 points, 1e-12 in float64.
"""
import numpy as np
import pytest
import torch

from xframe_tpu_torch.ops import fft_plan as plan
from xframe_tpu_torch.ops import fused_mtip, fused_projection as fp
from xframe_tpu_torch.ops.fused_sht import FusedSHT
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


@pytest.mark.parametrize("n_phi,route", [(512, "fft"), (640, "fft"),
                                         (30, "fft"), (130, "dense")])
def test_synthesis_route_and_partials_follow_n_phi(n_phi, route):
    """hankel_synthesize and synthesize_update take the FFT route exactly
    where B4 does, with a scratch of Fourier columns (rows, 2L+1, n_θ)
    there and none on the dense route; B5's partial sums (and B4's) come one
    per (row, θ tile) of that route: 4 θ lines a tile for B5 and 8 for B4 on
    the FFT route, 16 on the dense one."""
    l_max, n_theta, rows = min(8, (n_phi - 1) // 2), 21, 10
    fi = fused_mtip.FusedIteration(FusedSHT(_sht(l_max, n_theta, n_phi)))
    assert fi.synthesis_route == fi.projection_route == route
    fft = route == "fft"
    for sums, fft_tile, tile in ((6, fused_mtip._SYN_FFT_THETA_TILE,
                                  4 if fft else 16),
                                 (2, fused_mtip._FFT_THETA_TILE,
                                  8 if fft else 16)):
        assert fi._partials(rows, sums, fft_tile).shape \
            == (rows, -(-n_theta // tile), sums)
    fm = fi.synthesis_scratch(rows)
    tw, fm_ptr, *_, code = fi._synthesis_args(fm, 0)
    if route == "dense":
        assert fm is None and tw is None and fm_ptr is None and code == 0
    else:
        assert fm.shape == (rows, 2 * l_max + 1, n_theta)
        assert fm.dtype == torch.complex64 and fm_ptr == fm.data_ptr()
        assert code == fi._fft.code and tw == fi._fft.twiddles.data_ptr()


# ------------------------------------------------------------ B1 and B3
_Q_ROWS, _Q_L = 64, 32   # kQR, kQL of csrc/sht.cuh: the quadrature GEMM tile
_SMEM_OPTIN = 227 * 1024  # the H100's opt-in shared memory per block


def _fft_lines(n_phi):
    """analysis_fft_lines of csrc/sht.cuh on the H100: 4 FFT lines per
    block where two line buffers of 4 and the twiddles fit, else 2 (n_φ =
    4096), else 1 (8192); 0 where none fits."""
    for lines in (4, 2, 1):
        stride = n_phi + (n_phi + 15) // 16          # fft_line_stride
        if (2 * lines * stride + n_phi) * 8 <= _SMEM_OPTIN:
            return lines
    return 0


def _analysis_ffts(sht, x, abs2):
    """analysis_fft_kernel's arithmetic in numpy, θ tile by θ tile at the
    launch's line count: the tile's lines zero-padded past n_θ (B3: |x|²
    of θ lines 2k and 2k+1 as the real and imaginary parts of FFT line k),
    the emulated forward Stockham passes, then the Fourier columns times
    2π/n_φ as the kernel writes its scratch g (rows, n_g, n_θ): B1 the
    2L+1 bins (j − L) mod n_φ, B3 m = 0..L unpaired. Unwritten entries
    stay NaN."""
    L, n_theta, n_phi = sht.l_max, sht.n_theta, sht.n_phi
    rows, lines = x.shape[0], _fft_lines(n_phi)
    n_g, tile = (L + 1, 2 * lines) if abs2 else (2 * L + 1, lines)
    g = np.full((rows, n_g, n_theta), np.nan, np.complex128)
    m = np.arange(L + 1)
    j = np.arange(2 * L + 1)
    bins = np.where(j >= L, j - L, j - L + n_phi)
    assert np.array_equal(bins, plan.fft_bins(L, n_phi))
    for t0 in range(0, n_theta, tile):
        tcount = min(tile, n_theta - t0)
        src = np.zeros((rows, tile, n_phi), np.complex128)
        src[:, :tcount] = x[:, t0:t0 + tcount]
        if abs2:
            inten = np.abs(src) ** 2
            src = inten[:, 0::2] + 1j * inten[:, 1::2]
        spec = stockham(src, plan.fft_radices(n_phi),
                        plan.fft_twiddles(n_phi), inverse=False)
        if abs2:
            # A[m] = (Z[m] + conj Z[n−m])/2, B[m] = (Z[m] − conj Z[n−m])/2i
            # in the kernel's real arithmetic; Z[n−0] is Z[0]
            zm, zn = spec[..., m], spec[..., (n_phi - m) % n_phi]
            a = 0.5 * ((zm.real + zn.real) + 1j * (zm.imag - zn.imag))
            b = 0.5 * ((zm.imag + zn.imag) + 1j * (zn.real - zm.real))
            cols = np.stack([a, b], axis=2).reshape(rows, tile, L + 1)
        else:
            cols = spec[..., bins]
        g[:, :, t0:t0 + tcount] = np.swapaxes(cols[:, :tcount], 1, 2) \
            * (2 * np.pi / n_phi)
    return g


def _quadrature_blocks(l_max, rows, mirror):
    """quadrature_gemm_kernel's blocks: (row slice, order j, the l it sums
    or None, the l below the triangle it zeroes or None). Per j (B3: m ≥ 0
    only), per row tile, l tiles from |m| on; tiles past L sum nothing."""
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
    for l ≥ |m|, zeros below, and B3's row L − m = (−1)^m conj(c)."""
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
    g = _analysis_ffts(sht, f, abs2=False)
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
    g = _analysis_ffts(sht, psi, abs2=True)
    assert g.shape == (3, l_max + 1, n_theta) and not np.isnan(g).any()
    # a real field's m = 0 column is real
    assert (g[:, 0].imag == 0).all()
    got = _quadrature_gemm(sht, g, mirror=True)
    want = sht.forward_real_abs2(
        torch.as_tensor(psi, dtype=torch.complex64)).numpy()
    assert got.shape == want.shape and not np.isnan(got).any()
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("l_max,rows", [(64, 256), (127, 256), (20, 67)])
@pytest.mark.parametrize("mirror", [False, True])
def test_quadrature_gemm_blocks_write_every_coefficient_once(l_max, rows,
                                                             mirror):
    """At the tutorial (2 × 128 rows, L = 64) and production (256 rows,
    L = 127) shapes, and a ragged row tile, the quadrature GEMM's blocks
    write every (row, j, l) exactly once, zeros included (B3: the m < 0
    rows through the mirror)."""
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
def test_analysis_route_follows_n_phi(n_phi, route):
    """B1 and B3 take the FFT route exactly where B4, B5 and B6 do, on the
    one plan the FusedSHT builds and its FusedIteration shares, with a
    scratch of Fourier columns (rows, n_cols, n_θ) there and none on the
    dense route."""
    l_max, n_theta = min(8, (n_phi - 1) // 2), 12
    fused = FusedSHT(_sht(l_max, n_theta, n_phi))
    fi = fused_mtip.FusedIteration(fused)
    assert fused.analysis_route == fi.projection_route == route
    assert fi._fft is fused.fft
    g = fused.analysis_scratch(5, l_max + 1)
    if route == "dense":
        assert fused.fft is None and g is None
    else:
        assert g.shape == (5, l_max + 1, n_theta) and g.dtype == torch.complex64
        assert fused.fft.code == sum(r << (3 * k) for k, r in enumerate(
            plan.fft_radices(n_phi)))


def test_fft_plan_names_stay_importable_from_fused_mtip():
    for name in ("fft_radices", "fft_twiddles", "fft_bins", "FftPlan",
                 "fft_plan"):
        assert getattr(fused_mtip, name) is getattr(plan, name)


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
