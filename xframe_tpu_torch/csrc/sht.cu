// Spherical-harmonic analysis and synthesis kernels for Hopper (sm_90a).
//
// Five C entry points, bound with ctypes by xframe_tpu_torch/ops/fused_sht.py
// (plain versions: ops/sht.py); the kernels live in sht.cuh:
//
//   xf_sht_forward            complex (R, θ, φ) → complex (R, 2L+1, L+1)
//                             replaces xframe_tpu/ops/pallas_sht.py:184 _fwd_kernel (K1)
//   xf_sht_forward_real       real (R, θ, φ)    → complex (R, 2L+1, L+1)
//                             replaces xframe_tpu/ops/pallas_sht.py:622 _fwd_real_kernel
//   xf_sht_forward_real_abs2  complex ψ (R, θ, φ) → analysis of |ψ|², (R, 2L+1, L+1)
//                             replaces xframe_tpu/ops/pallas_sht.py:602 _fwd_abs2_kernel
//   xf_sht_inverse            complex (R, 2L+1, L+1) → complex (R, θ, φ)
//                             replaces xframe_tpu/ops/pallas_sht.py:212 _inv_kernel (K1')
//   xf_sht_inverse_real       complex (R, 2L+1, L+1) → real (R, θ, φ)
//                             replaces xframe_tpu/ops/pallas_sht.py:521 FusedSHT.inverse_real.kern_acc
//
// What bounds them. Counting each φ-transform as an FFT and the Legendre
// stage over the (l, m) triangle (chip_smoke.py kernel_work), every one of
// them is bound by its bytes: one grid pass (134 MB complex at 128 rows, L =
// 64, 256×512), the coefficients and the Legendre table, ≈0.09 ms per
// tutorial call and ≈0.15 ms at production (256 rows, L = 127, 320×640).
//
// What the designs do about it.
//   B1 (forward), B9 (forward_real) and B3 (forward_real_abs2) run two
//   kernels wherever n_φ = 2^a·3^b·5^c (both cells' 512 and 640; the
//   wrapper's route): analysis_fft_kernel reads the grid once, coalesced
//   along φ, runs one forward Stockham FFT per line in shared memory
//   (fft.cuh; B9 and B3 run two real θ lines as one complex FFT, B3
//   squaring ψ on the way) and writes the Fourier columns (rows, 2L+1 or
//   L+1, θ) to a scratch; quadrature_gemm_kernel then runs the Legendre
//   quadrature per order as a (rows × θ)·(θ × l) GEMM over the triangle
//   l ≥ |m|, 64 rows × 32 l a block, so each table value serves 64 rows (B9
//   and B3 over m ≥ 0, mirroring the m < 0 rows). The columns go through
//   device memory because a row's (θ, 2L+1) columns (264 KB at L = 64)
//   exceed a block's shared memory, and the GEMM needs every θ of an order.
//   θ is tiled, so this route has no cap on n_θ; an FFT block holds 4
//   lines, or 2 or 1 where n_φ leaves no room for 4 (fft_block_lines: n_φ ≤
//   ≈9250 with one line on the H100's 227 KB). B3's intensity grid never
//   reaches HBM. Other n_φ keep the dense analysis_kernel: a φ-DFT against
//   the E table with the (θ, m) columns in shared memory, then the
//   quadrature in the same block; one thread per θ line, so n_θ ≤ 1024,
//   and a block per 16 m rows rereads its row's grid, its loads n_φ·8
//   bytes apart across a warp.
//   B2 (inverse) and B10 (inverse_real) run, on the same n_φ, the FFT-route
//   synthesis that B5, B6, B11 and B12 (mtip.cu) run: legendre_gemm_kernel,
//   the Legendre stage as a per-order (rows × l)·(l × θ) GEMM over the
//   triangle, into a scratch of (rows, 2L+1, θ) Fourier columns, then
//   synthesis_fft_kernel, one inverse Stockham FFT per line in shared
//   memory (4 lines a block, or 2 or 1 by the same rule), writing the grid
//   coalesced along φ; the output types InverseOut and RealOut name their
//   instances apart from B6's. B10 keeps only Re f, for any c: its GEMM
//   folds c onto m ≥ 0 as it loads it (half the orders and half the
//   scratch), and each FFT line carries two θ lines, whose real spectra
//   are Hermitian. Other n_φ keep synthesis_kernel, a dense φ-DFT against
//   the I table.
//
// Every launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() so that the Python wrapper raises on a refused launch.

#include "sht.cuh"

extern "C" {

// radices ≠ 0: the FFT route (tw, the scratch g of (rows, 2L+1, n_θ)
// values, `lines` θ lines per FFT block by the line rule); 0: the dense
// route (E tables).
int xf_sht_forward(const void* f, const float* e_re, const float* e_im,
                   const float* pw, const void* tw, void* g, void* c,
                   int rows, int n_theta, int n_phi, int l_max, int radices,
                   int lines, void* stream) {
  if (radices != 0)
    return launch_analysis_fft<kComplexIn>(f, pw, tw, g, c, rows, n_theta,
                                           n_phi, l_max, radices, lines,
                                           (cudaStream_t)stream);
  return launch_analysis<kComplexIn>(f, e_re, e_im, pw, c, rows, n_theta,
                                     n_phi, l_max, (cudaStream_t)stream);
}

// As xf_sht_forward; the scratch g holds (rows, L+1, n_θ) values.
int xf_sht_forward_real(const void* f, const float* e_re, const float* e_im,
                        const float* pw, const void* tw, void* g, void* c,
                        int rows, int n_theta, int n_phi, int l_max,
                        int radices, int lines, void* stream) {
  if (radices != 0)
    return launch_analysis_fft<kRealIn>(f, pw, tw, g, c, rows, n_theta,
                                        n_phi, l_max, radices, lines,
                                        (cudaStream_t)stream);
  return launch_analysis<kRealIn>(f, e_re, e_im, pw, c, rows, n_theta, n_phi,
                                  l_max, (cudaStream_t)stream);
}

// As xf_sht_forward; the scratch g holds (rows, L+1, n_θ) values.
int xf_sht_forward_real_abs2(const void* psi, const float* e_re,
                             const float* e_im, const float* pw,
                             const void* tw, void* g, void* c, int rows,
                             int n_theta, int n_phi, int l_max, int radices,
                             int lines, void* stream) {
  if (radices != 0)
    return launch_analysis_fft<kAbs2In>(psi, pw, tw, g, c, rows, n_theta,
                                        n_phi, l_max, radices, lines,
                                        (cudaStream_t)stream);
  return launch_analysis<kAbs2In>(psi, e_re, e_im, pw, c, rows, n_theta,
                                  n_phi, l_max, (cudaStream_t)stream);
}

// radices ≠ 0: the FFT route (tw, the scratch fm of (rows, 2L+1, n_θ)
// values, `lines` θ lines per FFT block by the line rule); 0: the dense
// route (I tables).
int xf_sht_inverse(const void* c, const float* pt, const float* i_re,
                   const float* i_im, const void* tw, void* fm, void* f,
                   int rows, int n_theta, int n_phi, int l_max, int radices,
                   int lines, void* stream) {
  const InverseOut out{{static_cast<float2*>(f)}};
  if (radices != 0)
    return launch_synthesis_fft(c, pt, tw, fm, out, rows, n_theta, n_phi,
                                l_max, radices, lines, (cudaStream_t)stream);
  return launch_synthesis(c, pt, i_re, i_im, out, rows, n_theta, n_phi, l_max,
                          (cudaStream_t)stream);
}

// As xf_sht_inverse; the scratch fm holds (rows, L+1, n_θ) values.
int xf_sht_inverse_real(const void* c, const float* pt, const float* i_re,
                        const float* i_im, const void* tw, void* fm, void* f,
                        int rows, int n_theta, int n_phi, int l_max,
                        int radices, int lines, void* stream) {
  const RealOut out{static_cast<float*>(f)};
  if (radices != 0)
    return launch_synthesis_fft(c, pt, tw, fm, out, rows, n_theta, n_phi,
                                l_max, radices, lines, (cudaStream_t)stream);
  return launch_synthesis(c, pt, i_re, i_im, out, rows, n_theta, n_phi, l_max,
                          (cudaStream_t)stream);
}

}  // extern "C"
