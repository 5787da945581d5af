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
// What bounds them. The φ-DFT against a table costs R·θ·φ·(2L+1)·8 FLOP for
// a complex transform (17.3 GFLOP for R = 128 rows at L = 64 on a 256×512
// grid; about a quarter of that for the real-input analysis, which reads
// real data and forms m ≥ 0 only, and half for the real-output synthesis),
// against ≈1.1 GFLOP for the Legendre stage and 134 MB for one complex grid
// pass. At more than 100 FLOP per grid byte the design assumes FP32
// instruction throughput, not HBM, to be the bound. That is assumed, not
// measured: by that FLOP count the kernels reach 8 % (real analysis) to
// 34 % (complex synthesis) of the card's FP32 peak (PERF.md), so they are
// not at the compute limit. The functions themselves need far less: with
// each φ-transform as an FFT (≈23× fewer FLOP at L = 64, 512 φ) they are
// bound by their bytes, ≈0.09 ms per tutorial call (chip_smoke.py
// kernel_work), so the dense DFT is this design's cost, not the function's.
// In the analysis each thread streams its own θ line, so a
// warp's loads fall n_φ·8 bytes apart; those uncoalesced reads are a likely
// limit, and staging θ-line tiles through shared memory is the next step.
//
// What the design does about it. The grid is read once and written once,
// and the (θ, m) Fourier columns never reach HBM: they live in shared
// memory between the DFT and the Legendre stage. Each FMA of the DFT loop
// reads its table operand from shared memory as a warp-wide broadcast and
// its data operand from a register, so the loops spend their instructions
// on FMAs, not loads. The |ψ|² analysis squares ψ in registers, so the
// intensity grid never exists in HBM.
// An FFT over φ (n_φ = 640 at production scale is no power of two) and
// tensor-core DFTs are left to later work.
//
// Every launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() so that the Python wrapper raises on a refused launch.

#include "sht.cuh"

extern "C" {

int xf_sht_forward(const void* f, const float* e_re, const float* e_im,
                   const float* pw, void* c, int rows, int n_theta, int n_phi,
                   int l_max, void* stream) {
  return launch_analysis<kComplexIn>(f, e_re, e_im, pw, c, rows, n_theta,
                                     n_phi, l_max, (cudaStream_t)stream);
}

int xf_sht_forward_real(const void* f, const float* e_re, const float* e_im,
                        const float* pw, void* c, int rows, int n_theta,
                        int n_phi, int l_max, void* stream) {
  return launch_analysis<kRealIn>(f, e_re, e_im, pw, c, rows, n_theta, n_phi,
                                  l_max, (cudaStream_t)stream);
}

int xf_sht_forward_real_abs2(const void* psi, const float* e_re,
                             const float* e_im, const float* pw, void* c,
                             int rows, int n_theta, int n_phi, int l_max,
                             void* stream) {
  return launch_analysis<kAbs2In>(psi, e_re, e_im, pw, c, rows, n_theta,
                                  n_phi, l_max, (cudaStream_t)stream);
}

int xf_sht_inverse(const void* c, const float* pt, const float* i_re,
                   const float* i_im, void* f, int rows, int n_theta,
                   int n_phi, int l_max, void* stream) {
  return launch_synthesis(c, pt, i_re, i_im,
                          ComplexOut{static_cast<float2*>(f)}, rows, n_theta,
                          n_phi, l_max, (cudaStream_t)stream);
}

int xf_sht_inverse_real(const void* c, const float* pt, const float* i_re,
                        const float* i_im, void* f, int rows, int n_theta,
                        int n_phi, int l_max, void* stream) {
  return launch_synthesis(c, pt, i_re, i_im,
                          RealOut{static_cast<float*>(f)}, rows, n_theta,
                          n_phi, l_max, (cudaStream_t)stream);
}

}  // extern "C"
