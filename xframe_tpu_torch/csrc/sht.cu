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
// bf16 tables (fourier_transform.fused_bf16_tables): each entry point has a
// form, named with _bf16 at the end, that takes the Legendre tables PW and
// Pt in bf16 and otherwise the same arguments (the E and I tables stay
// float32). It runs the same kernels with T = bf16 (sht.cuh): the FFT
// route's Legendre GEMMs on the tensor cores (legendre_bf16_kernel,
// quadrature_bf16_kernel), the dense route's Legendre stages on CUDA cores,
// each Legendre operand rounded to bf16 and every sum in float32.
//
// Every launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() so that the Python wrapper raises on a refused launch.

#include "sht.cuh"

namespace {

// radices ≠ 0: the FFT route (tw, the scratch g of (rows, 2L+1, n_θ)
// values — (rows, L+1, n_θ) for the real fields —, `lines` θ lines per FFT
// block by the line rule); 0: the dense route (E tables).
template <int kIn, class T>
int sht_analysis(const void* f, const float* e_re, const float* e_im,
                 const void* pw, const void* tw, void* g, void* c, int rows,
                 int n_theta, int n_phi, int l_max, int radices, int lines,
                 void* stream) {
  const T* w = static_cast<const T*>(pw);
  if (radices != 0)
    return launch_analysis_fft<kIn, T>(f, w, tw, g, c, rows, n_theta, n_phi,
                                       l_max, radices, lines,
                                       (cudaStream_t)stream);
  return launch_analysis<kIn, T>(f, e_re, e_im, w, c, rows, n_theta, n_phi,
                                 l_max, (cudaStream_t)stream);
}

// radices ≠ 0: the FFT route (tw, the scratch fm of (rows, 2L+1, n_θ)
// values — (rows, L+1, n_θ) for a real output —, `lines` θ lines per FFT
// block by the line rule); 0: the dense route (I tables).
template <class Out, class T>
int sht_synthesis(const void* c, const void* pt, const float* i_re,
                  const float* i_im, const void* tw, void* fm, Out out,
                  int rows, int n_theta, int n_phi, int l_max, int radices,
                  int lines, void* stream) {
  const T* p = static_cast<const T*>(pt);
  if (radices != 0)
    return launch_synthesis_fft<Out, T>(c, p, tw, fm, out, rows, n_theta,
                                        n_phi, l_max, radices, lines,
                                        (cudaStream_t)stream);
  return launch_synthesis<Out, T>(c, p, i_re, i_im, out, rows, n_theta, n_phi,
                                  l_max, (cudaStream_t)stream);
}

// The output of B2 (complex) and B10 (its real part) at f.
template <class Out>
Out sht_output(void* f);
template <>
InverseOut sht_output<InverseOut>(void* f) {
  return InverseOut{{static_cast<float2*>(f)}};
}
template <>
RealOut sht_output<RealOut>(void* f) {
  return RealOut{static_cast<float*>(f)};
}

}  // namespace

// One C entry point per transform and table type: NAME with float32
// tables, NAME_bf16 with bf16 ones.
#define XF_SHT_ANALYSIS(NAME, IN, T)                                         \
  int NAME(const void* f, const float* e_re, const float* e_im,             \
           const void* pw, const void* tw, void* g, void* c, int rows,      \
           int n_theta, int n_phi, int l_max, int radices, int lines,       \
           void* stream) {                                                  \
    return sht_analysis<IN, T>(f, e_re, e_im, pw, tw, g, c, rows, n_theta,  \
                               n_phi, l_max, radices, lines, stream);       \
  }
#define XF_SHT_SYNTHESIS(NAME, OUT, T)                                       \
  int NAME(const void* c, const void* pt, const float* i_re,                \
           const float* i_im, const void* tw, void* fm, void* f, int rows,  \
           int n_theta, int n_phi, int l_max, int radices, int lines,       \
           void* stream) {                                                  \
    return sht_synthesis<OUT, T>(c, pt, i_re, i_im, tw, fm,              \
                                 sht_output<OUT>(f), rows,                 \
                                 n_theta, n_phi, l_max, radices, lines,     \
                                 stream);                                   \
  }

extern "C" {

XF_SHT_ANALYSIS(xf_sht_forward, kComplexIn, float)
XF_SHT_ANALYSIS(xf_sht_forward_real, kRealIn, float)
XF_SHT_ANALYSIS(xf_sht_forward_real_abs2, kAbs2In, float)
XF_SHT_SYNTHESIS(xf_sht_inverse, InverseOut, float)
XF_SHT_SYNTHESIS(xf_sht_inverse_real, RealOut, float)

XF_SHT_ANALYSIS(xf_sht_forward_bf16, kComplexIn, bf16)
XF_SHT_ANALYSIS(xf_sht_forward_real_bf16, kRealIn, bf16)
XF_SHT_ANALYSIS(xf_sht_forward_real_abs2_bf16, kAbs2In, bf16)
XF_SHT_SYNTHESIS(xf_sht_inverse_bf16, InverseOut, bf16)
XF_SHT_SYNTHESIS(xf_sht_inverse_real_bf16, RealOut, bf16)

}  // extern "C"
