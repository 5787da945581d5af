// Spherical-harmonic analysis and synthesis kernels for Hopper (sm_90a),
// shared by the SHT entry points (sht.cu) and the fused MTIP kernels
// (mtip.cu). Everything here is file-local to each translation unit.
//
// Layout: centered m (row j ↔ m = j − L), complex data as interleaved float2,
// tables float32 (built on the host by FusedSHT):
//   E[j, φ]    = e^{−imφ}·2π/n_φ (re/im planes)   analysis DFT (dense route)
//   PW[j, θ, l] = P̄_l^m(θ)·w_GL(θ)                analysis quadrature
//   Pt[j, l, θ] = P̄_l^m(θ)                        synthesis
//   I[j, φ]    = e^{+imφ} (re/im planes)          synthesis DFT (dense route)
// The FFT routes (n_φ = 2^a·3^b·5^c) run the φ-transforms as Stockham FFTs
// (fft.cuh) on the host plan's radices and twiddles instead of E and I.
// All sums accumulate in FP32 on CUDA cores.
//
// bf16 tables (fourier_transform.fused_bf16_tables): every kernel that
// reads PW or Pt also has a form, the template argument T = bf16, whose
// Legendre tables are held in bf16. At every Legendre product the data
// operand is rounded to bf16 by round-to-nearest-even (legendre_operand):
// the Fourier columns of an analysis, the coefficients of a synthesis
// after the Hermitian fold of a real output (which stays float32). Every
// sum accumulates in float32. The φ-transforms (FFTs, and the E and I
// DFTs of the dense routes) stay float32. The FFT routes' per-order GEMMs
// run on the tensor cores in that form (legendre_bf16_kernel,
// quadrature_bf16_kernel: mma.sync m16n8k16 bf16 × bf16 → f32); the dense
// routes' Legendre stages stay on CUDA cores. The float32 instantiations
// (T = float) are the kernels as they were.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "fft.cuh"

namespace {

using bf16 = __nv_bfloat16;

// A Legendre table value as float: a bf16 value is its bits in the high
// half of a float32.
__device__ __forceinline__ float table_value(float v) { return v; }
__device__ __forceinline__ float table_value(bf16 v) {
  return __uint_as_float(
      (unsigned)reinterpret_cast<const unsigned short&>(v) << 16);
}

// The unrolling of the CUDA-core Legendre loops on bf16 tables (the
// float32 loops keep the compiler's own): with the compiler's unrolling
// B4's bf16 form took 1.98x its float32 form's time at production on an
// H100 (chip_smoke.py's kernel phase), most of it in quadrature_kernel's
// θ loop; unrolled by 8, about the same time.
constexpr int kBf16Unroll = 8;

// The data operand of a Legendre product against a table of type T: itself
// for float32 tables; for bf16 ones rounded to bf16 by round-to-nearest-even
// and held as float32, what __float2bfloat16_rn gives for a finite x, in
// integer arithmetic.
template <class T>
__device__ __forceinline__ float legendre_operand(float x) {
  if constexpr (std::is_same_v<T, bf16>) {
    const unsigned u = __float_as_uint(x);
    return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
  } else {
    return x;
  }
}

constexpr int kMT = 16;           // m rows per analysis block
constexpr int kKP = 32;           // φ samples per staged DFT-table chunk
constexpr int kTT = 16;           // θ lines per synthesis block
constexpr int kSynThreads = 256;  // synthesis block size (threads across φ)
constexpr int kMaxRows = 65535;   // gridDim.y limit
constexpr int kDefaultSmem = 48 * 1024;

// Input of an analysis: a complex grid, a real grid, or a complex grid
// whose |x|² is analysed as a real field (formed in registers); or, as a
// tag of the quadrature GEMM only, |ψ|² of the ψ that B12's synthesis has
// just formed in shared memory (its FFTs run in synthesis_fft_kernel).
enum AnalysisIn {
  kComplexIn = 0,
  kRealIn = 1,
  kAbs2In = 2,
  kSynthAbs2In = 3
};

// The element type of an analysis input's grid.
template <int kIn>
using AnalysisElem = std::conditional_t<kIn == kRealIn, float, float2>;

// Deterministic block sum of N per-thread values (fixed shuffle tree, then
// the warps in order); the result is valid in thread 0 only.
template <int N>
__device__ void block_sum(float (&v)[N]) {
  __shared__ float red[32][N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k)
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) red[warp][k] = v[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float s = 0.f;
      for (int w = 0; w < n_warps; ++w) s += red[w][k];
      v[k] = s;
    }
  }
}

// Legendre quadrature of an analysis: c[row, j, l] = Σ_θ fm[θ, j]·PW[j, θ, l]
// for the block's mcount rows j0.. held in fm_s[θ·kMT + mm] (under bf16
// tables already rounded by legendre_operand as they were staged); threads
// across (j, l). kMirror also writes c_{l,−m} = (−1)^m conj(c_{l,m}) (real
// fields).
template <bool kMirror, class T = float>
__device__ void legendre_quadrature(const float2* fm_s, const T* pw,
                                    float2* out, int row, int j0, int mcount,
                                    int n_theta, int l_max) {
  const int n_m = 2 * l_max + 1;
  const int n_l = l_max + 1;
  for (int idx = threadIdx.x; idx < mcount * n_l; idx += blockDim.x) {
    const int mm = idx / n_l, l = idx % n_l, j = j0 + mm;
    const T* w = pw + (size_t)j * n_theta * n_l + l;
    float sr = 0.f, si = 0.f;
    if constexpr (std::is_same_v<T, bf16>) {
#pragma unroll (kBf16Unroll)
      for (int th = 0; th < n_theta; ++th) {
        const float wv = table_value(w[(size_t)th * n_l]);
        const float2 f = fm_s[th * kMT + mm];
        sr = fmaf(f.x, wv, sr);
        si = fmaf(f.y, wv, si);
      }
    } else {
      for (int th = 0; th < n_theta; ++th) {
        const float wv = w[(size_t)th * n_l];
        const float2 f = fm_s[th * kMT + mm];
        sr = fmaf(f.x, wv, sr);
        si = fmaf(f.y, wv, si);
      }
    }
    float2* orow = out + (size_t)row * n_m * n_l;
    orow[(size_t)j * n_l + l] = make_float2(sr, si);
    if constexpr (kMirror) {
      const int m = j - l_max;
      if (m > 0) {
        const float s = (m & 1) ? -1.f : 1.f;
        orow[(size_t)(l_max - m) * n_l + l] = make_float2(s * sr, -s * si);
      }
    }
  }
}

// Analysis, dense route (n_φ with another prime factor than 2, 3 and 5).
// One block per (row, tile of kMT table rows); thread
// t owns the θ line t of the row, so n_θ ≤ 1024. Stage 1 forms fm[θ, m] =
// Σ_φ f[θ, φ]·E[m, φ] with the E chunk in shared memory; stage 2 is
// legendre_quadrature. Real and |x|² input: table rows m = 0..L only, and
// the block also writes the mirrored rows.
template <int kIn, class T = float>
__global__ void analysis_kernel(const void* __restrict__ in,
                                const float* __restrict__ e_re,
                                const float* __restrict__ e_im,
                                const T* __restrict__ pw,
                                float2* __restrict__ out,
                                int n_theta, int n_phi, int l_max,
                                int j_begin, int n_j) {
  extern __shared__ float2 fm_s[];          // [n_theta][kMT]
  __shared__ float es_re[kMT][kKP];
  __shared__ float es_im[kMT][kKP];
  const int row = blockIdx.y;
  const int j0 = j_begin + blockIdx.x * kMT;
  const int mcount = min(kMT, j_begin + n_j - j0);
  const int t = threadIdx.x;
  const bool active = t < n_theta;
  const size_t line = ((size_t)row * n_theta + (active ? t : 0)) * n_phi;

  float acc_re[kMT], acc_im[kMT];
#pragma unroll
  for (int mm = 0; mm < kMT; ++mm) {
    acc_re[mm] = 0.f;
    acc_im[mm] = 0.f;
  }

  for (int p0 = 0; p0 < n_phi; p0 += kKP) {
    __syncthreads();
    for (int idx = t; idx < kMT * kKP; idx += blockDim.x) {
      const int mm = idx / kKP, k = idx % kKP, p = p0 + k;
      const bool ok = mm < mcount && p < n_phi;
      const size_t e = (size_t)(j0 + mm) * n_phi + p;
      es_re[mm][k] = ok ? e_re[e] : 0.f;
      es_im[mm][k] = ok ? e_im[e] : 0.f;
    }
    __syncthreads();
    if (active) {
      const int kn = min(kKP, n_phi - p0);
      for (int k = 0; k < kn; ++k) {
        if constexpr (kIn == kComplexIn) {
          const float2 x = static_cast<const float2*>(in)[line + p0 + k];
#pragma unroll
          for (int mm = 0; mm < kMT; ++mm) {
            const float er = es_re[mm][k], ei = es_im[mm][k];
            acc_re[mm] = fmaf(x.x, er, acc_re[mm]);
            acc_re[mm] = fmaf(-x.y, ei, acc_re[mm]);
            acc_im[mm] = fmaf(x.x, ei, acc_im[mm]);
            acc_im[mm] = fmaf(x.y, er, acc_im[mm]);
          }
        } else {
          float x;
          if constexpr (kIn == kAbs2In) {
            const float2 z = static_cast<const float2*>(in)[line + p0 + k];
            x = z.x * z.x + z.y * z.y;
          } else {
            x = static_cast<const float*>(in)[line + p0 + k];
          }
#pragma unroll
          for (int mm = 0; mm < kMT; ++mm) {
            acc_re[mm] = fmaf(x, es_re[mm][k], acc_re[mm]);
            acc_im[mm] = fmaf(x, es_im[mm][k], acc_im[mm]);
          }
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int mm = 0; mm < kMT; ++mm)
      fm_s[t * kMT + mm] = make_float2(legendre_operand<T>(acc_re[mm]),
                                       legendre_operand<T>(acc_im[mm]));
  }
  __syncthreads();
  legendre_quadrature<kIn != kComplexIn, T>(fm_s, pw, out, row, j0, mcount,
                                            n_theta, l_max);
}

// Where a synthesis puts its values. Each output type is copied into every
// thread; begin() runs once per block before the first put(), finish()
// once after the last (every thread of the block calls both). kReal: only
// the real part is kept (the FFT route then runs the real synthesis).
struct ComplexOut {
  static constexpr bool kReal = false;
  float2* f;
  __device__ void begin(int) {}
  __device__ void put(size_t o, int, float re, float im) {
    f[o] = make_float2(re, im);
  }
  __device__ void finish(int, int) {}
};

// B2's output: ComplexOut under a name of its own, so that B2's kernel
// instances are told apart from B6's in a profile.
struct InverseOut : ComplexOut {};

struct RealOut {
  static constexpr bool kReal = true;
  float* f;
  __device__ void begin(int) {}
  __device__ void put(size_t o, int, float re, float) { f[o] = re; }
  __device__ void finish(int, int) {}
};

// B12's output on the FFT route (mtip.cu xf_synthesize_abs2): ψ written as
// ComplexOut writes it, then the analysis of the tile's |ψ|² in the same
// block (synthesis_fft_kernel's epilogue, synthesis_abs2_epilogue) into g,
// the (rows, L+1, n_θ) scratch of m ≥ 0 Fourier columns that
// quadrature_gemm_kernel<kSynthAbs2In> reads.
struct Abs2FftOut : ComplexOut {
  float2* g;
};

// Synthesis. One block per (row, tile of kTT θ lines). Stage 1 forms
// fm[m, θ] = Σ_l c[m, l]·Pt[m, l, θ] into shared memory; stage 2 sums
// f[θ, φ] = Σ_m fm[m, θ]·I[m, φ] with threads across φ (two φ per thread
// per pass) and hands each grid value to out.put() once. Out::kReal skips
// the imaginary part; under bf16 tables its stage 1 rounds the folded
// coefficients c_h (legendre_pos's fold, float32) and forms H[m] =
// Σ_l c_h[m, l]·P̄_l^m for m ≥ 0 and conj H[|m|] for m < 0, the synthesis of
// c_h's Hermitian completion, whose real part is Re f.
template <class Out, class T = float>
__global__ void __launch_bounds__(kSynThreads)
synthesis_kernel(const float2* __restrict__ c,
                 const T* __restrict__ pt,
                 const float* __restrict__ i_re,
                 const float* __restrict__ i_im,
                 Out out, int n_theta, int n_phi, int l_max) {
  extern __shared__ float2 fm_s[];          // [n_m][kTT]
  const int n_m = 2 * l_max + 1;
  const int n_l = l_max + 1;
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * kTT;
  const int tcount = min(kTT, n_theta - t0);
  const float2* crow = c + (size_t)row * n_m * n_l;
  Out o = out;
  o.begin(row);

  for (int idx = threadIdx.x; idx < n_m * kTT; idx += blockDim.x) {
    const int j = idx / kTT, tt = idx % kTT;
    float sr = 0.f, si = 0.f;
    if (tt < tcount) {
      if constexpr (Out::kReal && std::is_same_v<T, bf16>) {
        const int m = j < l_max ? l_max - j : j - l_max;
        const float2* cp = crow + (size_t)(l_max + m) * n_l;
        const float2* cn = crow + (size_t)(l_max - m) * n_l;
        const float s = (m & 1) ? -1.f : 1.f;
        const T* pj = pt + (size_t)(l_max + m) * n_l * n_theta + t0 + tt;
#pragma unroll (kBf16Unroll)
        for (int l = m; l < n_l; ++l) {
          const float2 a = cp[l];
          float hr = a.x, hi = 0.f;
          if (m > 0) {
            const float2 b = cn[l];
            hr = 0.5f * (a.x + s * b.x);
            hi = 0.5f * (a.y - s * b.y);
          }
          const float p = table_value(pj[(size_t)l * n_theta]);
          sr = fmaf(legendre_operand<T>(hr), p, sr);
          si = fmaf(legendre_operand<T>(hi), p, si);
        }
        if (j < l_max) si = -si;
      } else if constexpr (std::is_same_v<T, bf16>) {
        const float2* cj = crow + (size_t)j * n_l;
        const T* pj = pt + (size_t)j * n_l * n_theta + t0 + tt;
#pragma unroll (kBf16Unroll)
        for (int l = 0; l < n_l; ++l) {
          const float2 cv = cj[l];
          const float p = table_value(pj[(size_t)l * n_theta]);
          sr = fmaf(legendre_operand<T>(cv.x), p, sr);
          si = fmaf(legendre_operand<T>(cv.y), p, si);
        }
      } else {
        const float2* cj = crow + (size_t)j * n_l;
        const float* pj = pt + (size_t)j * n_l * n_theta + t0 + tt;
        for (int l = 0; l < n_l; ++l) {
          const float2 cv = cj[l];
          const float p = pj[(size_t)l * n_theta];
          sr = fmaf(cv.x, p, sr);
          si = fmaf(cv.y, p, si);
        }
      }
    }
    fm_s[idx] = make_float2(sr, si);
  }
  __syncthreads();

  for (int p0 = 0; p0 < n_phi; p0 += 2 * blockDim.x) {
    const int pa = p0 + threadIdx.x;
    const int pb = pa + blockDim.x;
    const bool oka = pa < n_phi, okb = pb < n_phi;
    float ar_[kTT], ai_[kTT], br_[kTT], bi_[kTT];
#pragma unroll
    for (int tt = 0; tt < kTT; ++tt) {
      ar_[tt] = 0.f; ai_[tt] = 0.f; br_[tt] = 0.f; bi_[tt] = 0.f;
    }
    for (int j = 0; j < n_m; ++j) {
      const size_t e = (size_t)j * n_phi;
      const float iar = oka ? i_re[e + pa] : 0.f;
      const float iai = oka ? i_im[e + pa] : 0.f;
      const float ibr = okb ? i_re[e + pb] : 0.f;
      const float ibi = okb ? i_im[e + pb] : 0.f;
      const float2* fj = fm_s + j * kTT;
#pragma unroll
      for (int tt = 0; tt < kTT; ++tt) {
        const float2 f = fj[tt];
        ar_[tt] = fmaf(f.x, iar, ar_[tt]);
        ar_[tt] = fmaf(-f.y, iai, ar_[tt]);
        br_[tt] = fmaf(f.x, ibr, br_[tt]);
        br_[tt] = fmaf(-f.y, ibi, br_[tt]);
        if constexpr (!Out::kReal) {
          ai_[tt] = fmaf(f.x, iai, ai_[tt]);
          ai_[tt] = fmaf(f.y, iar, ai_[tt]);
          bi_[tt] = fmaf(f.x, ibi, bi_[tt]);
          bi_[tt] = fmaf(f.y, ibr, bi_[tt]);
        }
      }
    }
#pragma unroll
    for (int tt = 0; tt < kTT; ++tt) {
      if (tt < tcount) {
        const size_t o_line = ((size_t)row * n_theta + t0 + tt) * n_phi;
        if (oka) o.put(o_line + pa, t0 + tt, ar_[tt], ai_[tt]);
        if (okb) o.put(o_line + pb, t0 + tt, br_[tt], bi_[tt]);
      }
    }
  }
  o.finish(row, blockIdx.x);
}

// 4- and 8-byte asynchronous copies global → shared, zero-filled where
// !valid (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async8(float2* dst, const float2* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Synthesis, FFT route (n_φ = 2^a·3^b·5^c), kernel 1: the Legendre stage
// as a per-order GEMM over the triangle,
//   fm[r, j, θ] = Σ_{l=|m|}^{L} c[r, j, l]·Pt[j, l, θ]   (P̄_l^m = 0 below),
// for order j the complex (rows × l)·(l × θ) product with a real right
// factor. One block per (θ tile, row tile, j); kLK orders l at a time
// through two shared stages filled by cp.async, the next chunk's copies in
// flight while the current one multiplies; thread (ty, tx) keeps the 4 × 4
// sums r = r0 + ty + 16i, θ = t0 + tx + 16k in registers. Each table value
// serves kLR rows and each coefficient kLT θ lines: the table crosses L2
// rows/kLR times, where a block per (row, θ tile) reads it rows times.
// The template argument is the synthesis's output type: it names the
// launch in a profile (B2's InverseOut, B5's UpdateOut, B6's ComplexOut,
// B10's RealOut, B11's ProjectOut, B12's Abs2FftOut). A real output
// (Out::kReal: B10, and B11's I_new) keeps Re f only, so the
// orders fold onto m ≥ 0 (j = L..2L, half the work): each stage also holds
// row L − m, and each thread folds the values it copied, once they have
// landed, into the Hermitian coefficients c_h[m] = (c[L+m] + (−1)^m
// conj c[L−m])/2 (c_h[0] = Re c[L]), as B4's legendre_pos does; by P̄_l^{−m}
// = (−1)^m P̄_l^m, Re f = H[0] + Σ_{m>0} 2·Re(H[m]·e^{imφ}) with H[m] =
// Σ_l c_h[m, l]·P̄_l^m, for any c. fm is then (rows, L+1, n_θ).
constexpr int kLR = 64;           // rows per block tile
constexpr int kLT = 64;           // θ lines per block tile
constexpr int kLK = 8;            // l per staged chunk
constexpr int kLThreads = 256;    // 16 × 16 threads, 4 × 4 sums each

template <class Out>
__global__ void __launch_bounds__(kLThreads)
legendre_gemm_kernel(const float2* __restrict__ c,
                     const float* __restrict__ pt, float2* __restrict__ fm,
                     int rows, int n_theta, int l_max) {
  constexpr bool kFold = Out::kReal;
  // c[r0 + r, j, l0 + l]; kFold: row L − m in stages 2 and 3
  __shared__ float2 a_s[kFold ? 4 : 2][kLK][kLR + 1];
  __shared__ float b_s[2][kLK][kLT + 4];    // Pt[j, l0 + l, t0 + θ]
  const int n_m = 2 * l_max + 1, n_l = l_max + 1;
  const int t0 = blockIdx.x * kLT, r0 = blockIdx.y * kLR;
  const int j = kFold ? l_max + blockIdx.z : blockIdx.z;
  const int m = j < l_max ? l_max - j : j - l_max;
  const int n_out = kFold ? n_l : n_m, j_out = kFold ? m : j;   // fm's rows
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;

  auto load = [&](int st, int l0) {
    for (int e = t; e < kLK * kLR; e += kLThreads) {
      const int l = e % kLK, r = e / kLK;
      const bool ok = l0 + l < n_l && r0 + r < rows;
      cp_async8(&a_s[st][l][r],
                ok ? c + ((size_t)(r0 + r) * n_m + j) * n_l + l0 + l : c, ok);
      if constexpr (kFold)
        cp_async8(&a_s[2 + st][l][r],
                  ok ? c + ((size_t)(r0 + r) * n_m + l_max - m) * n_l + l0 + l
                     : c,
                  ok);
    }
    for (int e = t; e < kLK * kLT; e += kLThreads) {
      const int th = e % kLT, l = e / kLT;
      const bool ok = l0 + l < n_l && t0 + th < n_theta;
      cp_async4(&b_s[st][l][th],
                ok ? pt + ((size_t)j * n_l + l0 + l) * n_theta + t0 + th : pt,
                ok);
    }
    cp_async_commit();
  };

  float2 acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = make_float2(0.f, 0.f);
  const int chunks = (n_l - m + kLK - 1) / kLK;
  load(0, m);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      load((ch + 1) & 1, m + (ch + 1) * kLK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int st = ch & 1;
    if constexpr (kFold) {
      // c_h in place of c[L + m], by each thread on the values it copied
      // (visible to it after the wait), before the barrier that shows
      // them to the block
      const float s = (m & 1) ? -1.f : 1.f;
      for (int e = t; e < kLK * kLR; e += kLThreads) {
        const int l = e % kLK, r = e / kLK;
        const float2 a = a_s[st][l][r], b = a_s[2 + st][l][r];
        a_s[st][l][r] =
            make_float2(0.5f * (a.x + s * b.x), 0.5f * (a.y - s * b.y));
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kLK; ++kk) {
      float2 a[4];
      float b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[st][kk][ty + 16 * i];
#pragma unroll
      for (int k = 0; k < 4; ++k) b[k] = b_s[st][kk][tx + 16 * k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[i][k].x = fmaf(a[i].x, b[k], acc[i][k].x);
          acc[i][k].y = fmaf(a[i].y, b[k], acc[i][k].y);
        }
    }
    __syncthreads();   // the stage is refilled two chunks on
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int th = t0 + tx + 16 * k;
      if (r < rows && th < n_theta)
        fm[((size_t)r * n_out + j_out) * n_theta + th] = acc[i][k];
    }
  }
}

// The Fourier columns of real fields from paired FFT lines (B9, B3, B12):
// FFT line k of spec holds θ lines a = 2k and b = 2k+1 of a tile as Z =
// x_a + i·x_b; for m = 0..L, A[m] = (Z[m] + conj Z[n−m])/2 goes to line a
// and B[m] = (Z[m] − conj Z[n−m])/(2i) to line b (Z[n−0] read as Z[0]),
// times 2π/n_φ, at grow[m·n_θ + tt] for the tile's first tcount lines;
// grow is the row's (L+1, n_θ) block from the tile's first θ line.
__device__ __forceinline__ void unpair_real_columns(const float2* spec,
                                                    float2* grow, int tile,
                                                    int tcount, int n_theta,
                                                    int n_phi, int l_max,
                                                    int ls) {
  const float h = 0.5f * (6.283185307179586f / (float)n_phi);
  for (int idx = threadIdx.x; idx < (l_max + 1) * tile; idx += blockDim.x) {
    const int j = idx / tile, tt = idx - j * tile;
    if (tt >= tcount) continue;
    const float2* z = spec + (tt >> 1) * ls;
    const float2 zm = z[fpad(j)], zn = z[fpad(j ? n_phi - j : 0)];
    grow[(size_t)j * n_theta + tt] =
        (tt & 1) ? make_float2(h * (zm.y + zn.y), h * (zn.x - zm.x))
                 : make_float2(h * (zm.x + zn.x), h * (zm.y - zn.y));
  }
}

// B12's epilogue of synthesis_fft_kernel, after the inverse FFTs left the
// tile's ψ lines in f:
//   1. one pass across (θ line, φ): ψ to out.put(), coalesced along φ, and
//      |ψ|² of θ lines a = 2k and b = 2k+1 into line k of z, the buffer
//      the inverse FFTs did not end in, as Z = |ψ_a|² + i·|ψ_b|² (zero
//      past the tile's tcount lines, and the lone line's partner at
//      kLines = 1);
//   2. ⌈kLines/2⌉ forward FFTs, z and f alternating;
//   3. unpair_real_columns onto m = 0..L into out.g, as B3's
//      analysis_fft_kernel writes its scratch.
// The |ψ|² grid never leaves shared memory and ψ is not read back.
template <int kLines>
__device__ void synthesis_abs2_epilogue(Abs2FftOut& o, float2* f, float2* z,
                                        const float2* tw, const int* radix,
                                        int passes, int row, int t0,
                                        int tcount, int n_theta, int n_phi,
                                        int l_max, int ls) {
  constexpr int kPairs = (kLines + 1) / 2;
  for (int idx = threadIdx.x; idx < 2 * kPairs * n_phi; idx += blockDim.x) {
    const int tt = idx / n_phi, p = idx - tt * n_phi;
    float a2 = 0.f;
    if (tt < tcount) {
      const float2 v = f[tt * ls + fpad(p)];
      o.put(((size_t)row * n_theta + t0 + tt) * n_phi + p, t0 + tt, v.x,
            v.y);
      a2 = v.x * v.x + v.y * v.y;
    }
    reinterpret_cast<float*>(z + (tt >> 1) * ls + fpad(p))[tt & 1] = a2;
  }
  __syncthreads();
  const float2* spec = fft_lines(z, f, tw, radix, passes, n_phi, kPairs, ls,
                                 false);
  unpair_real_columns(spec, o.g + (size_t)row * (l_max + 1) * n_theta + t0,
                      kLines, tcount, n_theta, n_phi, l_max, ls);
}

// Synthesis, FFT route, kernel 2. One block per (row, tile of kLines FFT
// lines; the launch takes 4 where they fit the card's shared memory, else 2
// or 1, fft_block_lines):
//   1. each line's spectrum in shared memory, zero between L and n_φ − L:
//      complex outputs one θ line per FFT line, bin (m mod n_φ) ← fm[row,
//      m + L, θ] (read as 32-byte runs along θ at 4 lines); a real output
//      (Out::kReal, B10, B11) θ lines a = 2k and b = 2k+1 in FFT line k (a
//      tile of 2·kLines θ lines; an odd θ count leaves the last partner
//      zero, and out.put() never sees it),
//      from the folded H = fm[row, m, θ] of m ≥ 0: Z[0] = Re H_a[0] +
//      i·Re H_b[0], Z[m] = H_a[m] + i·H_b[m] and Z[n_φ−m] = conj H_a[m] +
//      i·conj H_b[m] for m = 1..L, whose inverse FFT is f_a + i·f_b;
//   2. one unnormalised inverse Stockham FFT per line (fft.cuh), e^{+imφ}
//      as the I table of the dense route;
//   3. threads across (θ line, φ) hand each value to out.put(), coalesced
//      along φ (a real output: Re z to line a, Im z to line b), then
//      out.finish() once; B12's Abs2FftOut also analyses the tile's |ψ|²
//      first (synthesis_abs2_epilogue), in the same shared memory.
// ≈49 KB of shared memory at n_φ = 640 and 4 lines, four blocks per SM (the
// register limit): twice the warps of 8-line tiles, whose barriers and the
// epilogue's loads then overlap more.
template <class Out, int kLines>
__global__ void __launch_bounds__(kSynThreads, 4)
synthesis_fft_kernel(const float2* __restrict__ fm,
                     const float2* __restrict__ tw_g, Out out, int n_theta,
                     int n_phi, int l_max, int radices) {
  constexpr int tile = Out::kReal ? 2 * kLines : kLines;   // θ lines
  extern __shared__ float2 smem[];
  const int n_m = 2 * l_max + 1, ls = fft_line_stride(n_phi);
  float2* buf0 = smem;                                   // [kLines][ls]
  float2* buf1 = buf0 + kLines * ls;
  float2* tw = buf1 + kLines * ls;                       // [n_phi]
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * tile, tcount = min(tile, n_theta - t0);
  const int t = threadIdx.x;
  int radix[kMaxPasses];
  const int passes = fft_radices(radices, radix);
  Out o = out;
  o.begin(row);

  for (int i = t; i < n_phi; i += blockDim.x) tw[i] = tw_g[i];
  const int gap = n_phi - n_m;
  for (int idx = t; idx < kLines * gap; idx += blockDim.x) {
    const int tt = idx / gap, k = l_max + 1 + idx - tt * gap;
    buf0[tt * ls + fpad(k)] = make_float2(0.f, 0.f);
  }
  if constexpr (Out::kReal) {
    const float2* frow = fm + (size_t)row * (l_max + 1) * n_theta + t0;
    const float2 zero = make_float2(0.f, 0.f);
    for (int idx = t; idx < (l_max + 1) * kLines; idx += blockDim.x) {
      const int m = idx / kLines, k = idx - m * kLines;
      const float2* h = frow + (size_t)m * n_theta + 2 * k;
      const float2 ha = 2 * k < tcount ? h[0] : zero;
      const float2 hb = 2 * k + 1 < tcount ? h[1] : zero;
      float2* z = buf0 + k * ls;
      if (m == 0) {
        z[0] = make_float2(ha.x, hb.x);
      } else {
        z[fpad(m)] = make_float2(ha.x - hb.y, ha.y + hb.x);
        z[fpad(n_phi - m)] = make_float2(ha.x + hb.y, hb.x - ha.y);
      }
    }
  } else {
    const float2* frow = fm + (size_t)row * n_m * n_theta + t0;
    for (int idx = t; idx < n_m * kLines; idx += blockDim.x) {
      const int j = idx / kLines, tt = idx - j * kLines;
      const int k = j >= l_max ? j - l_max : j - l_max + n_phi;
      buf0[tt * ls + fpad(k)] = tt < tcount ? frow[(size_t)j * n_theta + tt]
                                            : make_float2(0.f, 0.f);
    }
  }
  __syncthreads();
  float2* f = fft_lines(buf0, buf1, tw, radix, passes, n_phi, kLines, ls,
                        true);
  if constexpr (std::is_same_v<Out, Abs2FftOut>) {
    synthesis_abs2_epilogue<kLines>(o, f, f == buf0 ? buf1 : buf0, tw, radix,
                                    passes, row, t0, tcount, n_theta, n_phi,
                                    l_max, ls);
  } else {
    for (int idx = t; idx < tcount * n_phi; idx += blockDim.x) {
      const int tt = idx / n_phi, p = idx - tt * n_phi;
      const size_t off = ((size_t)row * n_theta + t0 + tt) * n_phi + p;
      if constexpr (Out::kReal) {
        const float2 z = f[(tt >> 1) * ls + fpad(p)];
        o.put(off, t0 + tt, (tt & 1) ? z.y : z.x, 0.f);
      } else {
        const float2 z = f[tt * ls + fpad(p)];
        o.put(off, t0 + tt, z.x, z.y);
      }
    }
  }
  o.finish(row, blockIdx.x);
}

// Analysis, FFT route (n_φ = 2^a·3^b·5^c), kernel 1: the φ-transforms. One
// block per (row, tile of θ lines), kLines FFT lines in shared memory (the
// launch takes 4 where two buffers of 4 lines and the twiddles fit the
// card's shared memory, else 2 or 1; fft_block_lines):
//   1. the tile's θ lines read coalesced along φ into line buffer 0; the
//      real fields pair θ lines a = 2k, b = 2k+1 into one complex line
//      Z = x_a + i·x_b (a tile of 2·kLines θ lines; an odd θ count leaves
//      the last line's partner zero): kRealIn (B9) reads the real grid as
//      it is, kAbs2In (B3) squares ψ on the way;
//   2. one forward Stockham FFT per line (fft.cuh, the host plan's radices);
//   3. the Fourier columns, times 2π/n_φ, into the scratch g:
//      kComplexIn the 2L+1 bins (j − L) mod n_φ; the real fields m = 0..L
//      only, unpaired (unpair_real_columns).
// g is (rows, n_g, n_θ), θ innermost (n_g = 2L+1 or L+1): the layout
// quadrature_gemm_kernel stages as 128-byte runs along θ, and the one
// legendre_gemm_kernel writes for the syntheses. Written from here it comes
// as runs of one tile's θ lines (32 bytes per bin at 4 lines), whole
// sectors; (rows, θ, m) would write whole lines but make the GEMM's
// per-order reads 8 bytes of every n_g·8.
template <int kIn, int kLines>
__global__ void __launch_bounds__(kSynThreads, 4)
analysis_fft_kernel(const AnalysisElem<kIn>* __restrict__ in,
                    const float2* __restrict__ tw_g, float2* __restrict__ g,
                    int n_theta, int n_phi, int l_max, int radices) {
  constexpr int kPer = kIn == kComplexIn ? 1 : 2;   // θ lines per FFT line
  constexpr int tile = kPer * kLines;
  extern __shared__ float2 smem[];
  const int ls = fft_line_stride(n_phi);
  float2* buf0 = smem;                                   // [kLines][ls]
  float2* buf1 = buf0 + kLines * ls;
  float2* tw = buf1 + kLines * ls;                       // [n_phi]
  const int row = blockIdx.y, t0 = blockIdx.x * tile;
  const int tcount = min(tile, n_theta - t0);
  const int t = threadIdx.x;
  int radix[kMaxPasses];
  const int passes = fft_radices(radices, radix);

  for (int i = t; i < n_phi; i += blockDim.x) tw[i] = tw_g[i];
  // kLoads values per thread (kPer grid values each) loaded before any is
  // stored, so that that many loads per thread are in flight
  constexpr int kLoads = 4;
  const AnalysisElem<kIn>* src = in + ((size_t)row * n_theta + t0) * n_phi;
  const int n_in = kLines * n_phi;
  for (int base = t; base < n_in; base += kLoads * blockDim.x) {
    AnalysisElem<kIn> x[kLoads][kPer];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = base + u * blockDim.x;
      const int k = idx / n_phi, p = idx - k * n_phi;
#pragma unroll
      for (int h = 0; h < kPer; ++h) {
        const int tt = kPer * k + h;
        x[u][h] = idx < n_in && tt < tcount ? src[(size_t)tt * n_phi + p]
                                            : AnalysisElem<kIn>{};
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx >= n_in) break;
      const int k = idx / n_phi, p = idx - k * n_phi;
      float2 z;
      if constexpr (kIn == kComplexIn)
        z = x[u][0];
      else if constexpr (kIn == kAbs2In)
        z = make_float2(x[u][0].x * x[u][0].x + x[u][0].y * x[u][0].y,
                        x[u][1].x * x[u][1].x + x[u][1].y * x[u][1].y);
      else
        z = make_float2(x[u][0], x[u][1]);
      buf0[k * ls + fpad(p)] = z;
    }
  }
  __syncthreads();
  const float2* spec = fft_lines(buf0, buf1, tw, radix, passes, n_phi, kLines,
                                 ls, false);

  if constexpr (kIn != kComplexIn) {
    unpair_real_columns(spec, g + (size_t)row * (l_max + 1) * n_theta + t0,
                        tile, tcount, n_theta, n_phi, l_max, ls);
  } else {
    const float scale = 6.283185307179586f / (float)n_phi;
    const int n_g = 2 * l_max + 1;
    float2* grow = g + (size_t)row * n_g * n_theta + t0;
    for (int idx = t; idx < n_g * tile; idx += blockDim.x) {
      const int j = idx / tile, tt = idx - j * tile;
      if (tt >= tcount) continue;
      const int k = j >= l_max ? j - l_max : j - l_max + n_phi;
      const float2 z = spec[tt * ls + fpad(k)];
      grow[(size_t)j * n_theta + tt] = make_float2(z.x * scale, z.y * scale);
    }
  }
}

// Analysis, FFT route, kernel 2: the Legendre quadrature as a per-order
// GEMM over the triangle,
//   c[r, j, l] = Σ_θ g[r, j − j_begin, θ]·PW[j, θ, l]   for l ≥ |m|,
// zero below (where the table is zero), for order j the complex (rows × θ)
// ·(θ × l) product with a real right factor: the transpose of
// legendre_gemm_kernel. One block per (l tile from |m|, row tile, j), the
// tiles past l = L exiting at once; kQK θ at a time through two shared
// stages filled by cp.async, the next chunk's copies in flight while the
// current one multiplies; thread (ty, tx) keeps the 4 × 4 sums r = r0 +
// 4ty + i, l = l0 + 4tx + k in registers, read from the stages as 16-byte
// loads. Each table value serves kQR rows and each Fourier value kQL
// orders l; blocks of one (row tile, j) run together, so g comes from HBM
// about once. FP32 on CUDA cores (TF32 keeps three digits, short of the
// 1e-4 bound), each sum in a fixed order. The template argument is the
// analysis's input (AnalysisIn), so that B1's, B9's, B3's and B12's
// launches are told apart in a profile; the real fields (kRealIn, kAbs2In,
// kSynthAbs2In; j = L..2L) also write row L − m as (−1)^m conj(c).
constexpr int kQR = 64;           // rows per block tile
constexpr int kQL = 32;           // orders l per block tile
constexpr int kQK = 16;           // θ per staged chunk
constexpr int kQThreads = 128;    // 16 × 8 threads, 4 × 4 sums each

template <int kIn>
__global__ void __launch_bounds__(kQThreads)
quadrature_gemm_kernel(const float2* __restrict__ g,
                       const float* __restrict__ pw, float2* __restrict__ c,
                       int rows, int n_theta, int l_max, int j_begin) {
  constexpr bool kMirror = kIn != kComplexIn;
  __shared__ __align__(16) float2 a_s[2][kQK][kQR + 2];  // g[r0 + r, ·, θ]
  __shared__ __align__(16) float b_s[2][kQK][kQL + 4];   // PW[j, θ, l0 + l]
  const int n_m = 2 * l_max + 1, n_l = l_max + 1, n_g = gridDim.z;
  const int jg = blockIdx.z, j = j_begin + jg;
  const int m = j < l_max ? l_max - j : j - l_max;
  const int l0 = m + blockIdx.x * kQL, r0 = blockIdx.y * kQR;
  const int t = threadIdx.x, tx = t & 7, ty = t >> 3;
  const int j_mirror = l_max - m;   // kMirror: the m < 0 row
  const float sign = (m & 1) ? -1.f : 1.f;

  if (blockIdx.x == 0) {
    for (int e = t; e < kQR * m; e += kQThreads) {
      const int r = r0 + e / m, l = e % m;
      if (r >= rows) break;
      c[((size_t)r * n_m + j) * n_l + l] = make_float2(0.f, 0.f);
      if (kMirror && m > 0)
        c[((size_t)r * n_m + j_mirror) * n_l + l] = make_float2(0.f, 0.f);
    }
  }
  if (l0 >= n_l) return;

  auto load = [&](int st, int th0) {
    for (int e = t; e < kQK * kQR; e += kQThreads) {
      const int k = e % kQK, r = e / kQK;
      const bool ok = th0 + k < n_theta && r0 + r < rows;
      cp_async8(&a_s[st][k][r],
                ok ? g + ((size_t)(r0 + r) * n_g + jg) * n_theta + th0 + k : g,
                ok);
    }
    for (int e = t; e < kQK * kQL; e += kQThreads) {
      const int l = e % kQL, k = e / kQL;
      const bool ok = th0 + k < n_theta && l0 + l < n_l;
      cp_async4(&b_s[st][k][l],
                ok ? pw + ((size_t)j * n_theta + th0 + k) * n_l + l0 + l : pw,
                ok);
    }
    cp_async_commit();
  };

  float2 acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = make_float2(0.f, 0.f);
  const int chunks = (n_theta + kQK - 1) / kQK;
  load(0, 0);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      load((ch + 1) & 1, (ch + 1) * kQK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = ch & 1;
#pragma unroll
    for (int kk = 0; kk < kQK; ++kk) {
      const float4* ap = reinterpret_cast<const float4*>(&a_s[st][kk][4 * ty]);
      const float4 a01 = ap[0], a23 = ap[1];
      const float2 a[4] = {make_float2(a01.x, a01.y), make_float2(a01.z, a01.w),
                           make_float2(a23.x, a23.y), make_float2(a23.z, a23.w)};
      const float4 b4 = *reinterpret_cast<const float4*>(&b_s[st][kk][4 * tx]);
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[i][k].x = fmaf(a[i].x, b[k], acc[i][k].x);
          acc[i][k].y = fmaf(a[i].y, b[k], acc[i][k].y);
        }
    }
    __syncthreads();   // the stage is refilled two chunks on
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = l0 + 4 * tx + k;
      if (l >= n_l) continue;
      c[((size_t)r * n_m + j) * n_l + l] = acc[i][k];
      if (kMirror && m > 0)
        c[((size_t)r * n_m + j_mirror) * n_l + l] =
            make_float2(sign * acc[i][k].x, -sign * acc[i][k].y);
    }
  }
}

// ------------------------------------------------ bf16 tables, tensor cores
// The FFT routes' per-order GEMMs under bf16 tables, on the tensor cores by
// the warp-level mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: A (16
// × 16, row-major) and B (16 × 8, column-major) in registers, D += A·B in
// float32 registers. An M tile of A holds 8 complex rows, their real parts
// in its rows 0-7 and their imaginary parts in rows 8-15, so that a
// thread's accumulators c0/c2 (c1/c3) are the real and imaginary parts of
// one output. A is staged float32 (as the float32 kernels stage it) and
// rounded to bf16 as the fragments are built; B is the bf16 table, staged
// through registers (its rows need not be 4-byte aligned for cp.async).
// Block tiles: 64 complex rows; the warp tile is 16 complex rows (two M
// tiles) × 32 columns (four N tiles), so each k-step of 16 is 8 MMAs a
// warp. A simple form: wgmma, TMA and a bf16 cp.async pipeline are later
// work.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two values as one bf16x2 register, lo in the low half: float32 values
// rounded to nearest even, or the bits of two bf16 values as they are.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return (unsigned)__bfloat16_as_ushort(v.x) |
         ((unsigned)__bfloat16_as_ushort(v.y) << 16);
}
__device__ __forceinline__ unsigned pack_bf16(unsigned short lo,
                                              unsigned short hi) {
  return (unsigned)lo | ((unsigned)hi << 16);
}

constexpr int kWarpRows = 16;     // complex rows of a warp tile
constexpr int kWarpCols = 32;     // columns of a warp tile
constexpr int kMmaK = 16;         // k per stage: one MMA k-step

// One k-step of a warp tile: rows r0 .. r0 + 15 of the stage a[k][row]
// (complex float32, rounded here), columns n0 .. n0 + 31 of the stage
// b[k][column] (bf16 bits); acc[mt][nt] the accumulators of M tile mt (rows
// r0 + 8·mt ..) and N tile nt (columns n0 + 8·nt ..).
template <class StageA, class StageB>
__device__ __forceinline__ void warp_mma_step(const StageA& a,
                                              const StageB& b, int r0,
                                              int n0, float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  unsigned af[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = r0 + 8 * mt + g;
    const float2 x0 = a[2 * q][r], x1 = a[2 * q + 1][r];
    const float2 x2 = a[2 * q + 8][r], x3 = a[2 * q + 9][r];
    af[mt][0] = pack_bf16(x0.x, x1.x);    // Re, k = 2q, 2q + 1
    af[mt][1] = pack_bf16(x0.y, x1.y);    // Im
    af[mt][2] = pack_bf16(x2.x, x3.x);    // Re, k = 2q + 8, 2q + 9
    af[mt][3] = pack_bf16(x2.y, x3.y);    // Im
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + 8 * nt + g;
    const unsigned b0 = pack_bf16(b[2 * q][n], b[2 * q + 1][n]);
    const unsigned b1 = pack_bf16(b[2 * q + 8][n], b[2 * q + 9][n]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][nt], af[mt], b0, b1);
  }
}

// The warp tile's outputs: out(r, n, value) for each complex row r = r0 +
// 8·mt + g and column n = n0 + 8·nt + 2q (+1).
template <class Put>
__device__ __forceinline__ void warp_mma_outputs(const float (&acc)[2][4][4],
                                                 int r0, int n0, Put put) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = r0 + 8 * mt + g, n = n0 + 8 * nt + 2 * q;
      put(r, n, make_float2(acc[mt][nt][0], acc[mt][nt][2]));
      put(r, n + 1, make_float2(acc[mt][nt][1], acc[mt][nt][3]));
    }
}

// legendre_gemm_kernel's product under bf16 tables: per order j the complex
// (rows × l)·(l × θ) product over the triangle l ≥ |m|, A the coefficients
// (folded onto m ≥ 0 in float32 for a real output, as there), B the bf16
// Pt of order j. One block per (θ tile of 64, row tile of 64, j); 8 warps,
// 4 along rows × 2 along θ. The next chunk's coefficients are in flight by
// cp.async and its table values in registers while the current chunk
// multiplies.
constexpr int kBR = 64;           // complex rows per block tile
constexpr int kBT = 64;           // θ lines per block tile
constexpr int kBThreads = 256;
constexpr int kBTab = kMmaK * kBT / kBThreads;   // table values per thread

template <class Out>
__global__ void __launch_bounds__(kBThreads)
legendre_bf16_kernel(const float2* __restrict__ c, const bf16* __restrict__ p,
                     float2* __restrict__ fm, int rows, int n_theta,
                     int l_max) {
  constexpr bool kFold = Out::kReal;
  __shared__ __align__(16) float2 a_s[kFold ? 4 : 2][kMmaK][kBR + 2];
  __shared__ __align__(16) unsigned short b_s[2][kMmaK][kBT + 8];
  const unsigned short* pt = reinterpret_cast<const unsigned short*>(p);
  const int n_m = 2 * l_max + 1, n_l = l_max + 1;
  const int t0 = blockIdx.x * kBT, r0 = blockIdx.y * kBR;
  const int j = kFold ? l_max + blockIdx.z : blockIdx.z;
  const int m = j < l_max ? l_max - j : j - l_max;
  const int n_out = kFold ? n_l : n_m, j_out = kFold ? m : j;   // fm's rows
  const int t = threadIdx.x, warp = t >> 5;
  const int wr = (warp & 3) * kWarpRows, wn = (warp >> 2) * kWarpCols;

  auto load_a = [&](int st, int l0) {
    for (int e = t; e < kMmaK * kBR; e += kBThreads) {
      const int l = e % kMmaK, r = e / kMmaK;
      const bool ok = l0 + l < n_l && r0 + r < rows;
      cp_async8(&a_s[st][l][r],
                ok ? c + ((size_t)(r0 + r) * n_m + j) * n_l + l0 + l : c, ok);
      if constexpr (kFold)
        cp_async8(&a_s[2 + st][l][r],
                  ok ? c + ((size_t)(r0 + r) * n_m + l_max - m) * n_l + l0 + l
                     : c,
                  ok);
    }
    cp_async_commit();
  };
  unsigned short b_r[kBTab];
  auto load_b = [&](int l0) {
#pragma unroll
    for (int i = 0; i < kBTab; ++i) {
      const int e = t + i * kBThreads, th = e % kBT, l = e / kBT;
      const bool ok = l0 + l < n_l && t0 + th < n_theta;
      b_r[i] = ok ? pt[((size_t)j * n_l + l0 + l) * n_theta + t0 + th] : 0;
    }
  };
  auto store_b = [&](int st) {
#pragma unroll
    for (int i = 0; i < kBTab; ++i) {
      const int e = t + i * kBThreads;
      b_s[st][e / kBT][e % kBT] = b_r[i];
    }
  };

  float acc[2][4][4] = {};
  const int chunks = (n_l - m + kMmaK - 1) / kMmaK;
  load_a(0, m);
  load_b(m);
  store_b(0);
  for (int ch = 0; ch < chunks; ++ch) {
    const bool more = ch + 1 < chunks;
    if (more) {
      load_a((ch + 1) & 1, m + (ch + 1) * kMmaK);
      load_b(m + (ch + 1) * kMmaK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int st = ch & 1;
    if constexpr (kFold) {
      // c_h in place of c[L + m], in float32, by each thread on the values
      // it copied, before the barrier that shows them to the block
      const float s = (m & 1) ? -1.f : 1.f;
      for (int e = t; e < kMmaK * kBR; e += kBThreads) {
        const int l = e % kMmaK, r = e / kMmaK;
        const float2 a = a_s[st][l][r], b = a_s[2 + st][l][r];
        a_s[st][l][r] =
            make_float2(0.5f * (a.x + s * b.x), 0.5f * (a.y - s * b.y));
      }
    }
    __syncthreads();
    warp_mma_step(a_s[st], b_s[st], wr, wn, acc);
    // the other stage was last read before the previous barrier
    if (more) store_b((ch + 1) & 1);
    __syncthreads();
  }
  warp_mma_outputs(acc, wr, wn, [&](int r, int th, float2 v) {
    if (r0 + r < rows && t0 + th < n_theta)
      fm[((size_t)(r0 + r) * n_out + j_out) * n_theta + t0 + th] = v;
  });
}

// quadrature_gemm_kernel's product under bf16 tables: per order j the
// complex (rows × θ)·(θ × l) product over the triangle, A the Fourier
// columns g, B the bf16 PW of order j; zero below the triangle and the
// mirrored m < 0 rows of a real field as there. One block per (l tile of
// 32 from |m|, row tile of 64, j); 4 warps along rows.
constexpr int kCR = 64;           // complex rows per block tile
constexpr int kCL = kWarpCols;    // orders l per block tile
constexpr int kCThreads = 128;
constexpr int kCTab = kMmaK * kCL / kCThreads;   // table values per thread

template <int kIn>
__global__ void __launch_bounds__(kCThreads)
quadrature_bf16_kernel(const float2* __restrict__ g,
                       const bf16* __restrict__ p, float2* __restrict__ c,
                       int rows, int n_theta, int l_max, int j_begin) {
  constexpr bool kMirror = kIn != kComplexIn;
  __shared__ __align__(16) float2 a_s[2][kMmaK][kCR + 2];  // g[r0 + r, ·, θ]
  // PW[j, θ, l0 + l], bf16 bits
  __shared__ __align__(16) unsigned short b_s[2][kMmaK][kCL + 8];
  const unsigned short* pw = reinterpret_cast<const unsigned short*>(p);
  const int n_m = 2 * l_max + 1, n_l = l_max + 1, n_g = gridDim.z;
  const int jg = blockIdx.z, j = j_begin + jg;
  const int m = j < l_max ? l_max - j : j - l_max;
  const int l0 = m + blockIdx.x * kCL, r0 = blockIdx.y * kCR;
  const int t = threadIdx.x, wr = (t >> 5) * kWarpRows;
  const int j_mirror = l_max - m;   // kMirror: the m < 0 row
  const float sign = (m & 1) ? -1.f : 1.f;

  if (blockIdx.x == 0) {
    for (int e = t; e < kCR * m; e += kCThreads) {
      const int r = r0 + e / m, l = e % m;
      if (r >= rows) break;
      c[((size_t)r * n_m + j) * n_l + l] = make_float2(0.f, 0.f);
      if (kMirror && m > 0)
        c[((size_t)r * n_m + j_mirror) * n_l + l] = make_float2(0.f, 0.f);
    }
  }
  if (l0 >= n_l) return;

  auto load_a = [&](int st, int th0) {
    for (int e = t; e < kMmaK * kCR; e += kCThreads) {
      const int k = e % kMmaK, r = e / kMmaK;
      const bool ok = th0 + k < n_theta && r0 + r < rows;
      cp_async8(&a_s[st][k][r],
                ok ? g + ((size_t)(r0 + r) * n_g + jg) * n_theta + th0 + k : g,
                ok);
    }
    cp_async_commit();
  };
  unsigned short b_r[kCTab];
  auto load_b = [&](int th0) {
#pragma unroll
    for (int i = 0; i < kCTab; ++i) {
      const int e = t + i * kCThreads, l = e % kCL, k = e / kCL;
      const bool ok = th0 + k < n_theta && l0 + l < n_l;
      b_r[i] = ok ? pw[((size_t)j * n_theta + th0 + k) * n_l + l0 + l] : 0;
    }
  };
  auto store_b = [&](int st) {
#pragma unroll
    for (int i = 0; i < kCTab; ++i) {
      const int e = t + i * kCThreads;
      b_s[st][e / kCL][e % kCL] = b_r[i];
    }
  };

  float acc[2][4][4] = {};
  const int chunks = (n_theta + kMmaK - 1) / kMmaK;
  load_a(0, 0);
  load_b(0);
  store_b(0);
  for (int ch = 0; ch < chunks; ++ch) {
    const bool more = ch + 1 < chunks;
    if (more) {
      load_a((ch + 1) & 1, (ch + 1) * kMmaK);
      load_b((ch + 1) * kMmaK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = ch & 1;
    warp_mma_step(a_s[st], b_s[st], wr, 0, acc);
    if (more) store_b((ch + 1) & 1);
    __syncthreads();
  }
  warp_mma_outputs(acc, wr, 0, [&](int r, int l, float2 v) {
    r += r0;
    l += l0;
    if (r >= rows || l >= n_l) return;
    c[((size_t)r * n_m + j) * n_l + l] = v;
    if (kMirror && m > 0)
      c[((size_t)r * n_m + j_mirror) * n_l + l] =
          make_float2(sign * v.x, -sign * v.y);
  });
}

// Lets `kernel` take `smem` bytes of dynamic shared memory where that and
// its static shared memory (block_sum's, for one) exceed the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (smem + attr.sharedSizeBytes <= (size_t)kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int kIn, class T = float>
int launch_analysis(const void* f, const float* e_re, const float* e_im,
                    const T* pw, void* c, int rows, int n_theta,
                    int n_phi, int l_max, cudaStream_t stream) {
  if (rows < 1 || rows > kMaxRows || n_theta < 1 || n_theta > 1024 ||
      n_phi < 1 || l_max < 0)
    return (int)cudaErrorInvalidValue;
  const int j_begin = kIn == kComplexIn ? 0 : l_max;
  const int n_j = kIn == kComplexIn ? 2 * l_max + 1 : l_max + 1;
  const dim3 grid((n_j + kMT - 1) / kMT, rows);
  const int threads = ((n_theta + 31) / 32) * 32;
  const size_t smem = (size_t)n_theta * kMT * sizeof(float2);
  cudaError_t err = allow_smem(analysis_kernel<kIn, T>, smem);
  if (err != cudaSuccess) return (int)err;
  analysis_kernel<kIn, T><<<grid, threads, smem, stream>>>(
      f, e_re, e_im, pw, static_cast<float2*>(c), n_theta, n_phi, l_max,
      j_begin, n_j);
  return (int)cudaGetLastError();
}

// Shared memory of an FFT block of `lines` lines: two line buffers and the
// twiddles, and `per_line` bytes more for each line (B4's Legendre sums).
inline size_t fft_block_smem(int n_phi, int lines, size_t per_line = 0) {
  return ((size_t)2 * lines * fft_line_stride(n_phi) + n_phi) *
             sizeof(float2) + lines * per_line;
}

// Static shared memory an FFT kernel may hold beside its dynamic share
// (block_sum's partials: 768 bytes under B5's UpdateOut, 256 under B11's
// ProjectOut), kept free.
constexpr size_t kStaticReserve = 1024;

// The line rule of every FFT kernel: θ lines per block, the largest of
// most, most/2, … least whose block fits `smem_optin` bytes; 0 where not
// even `least` fits. Analysis and synthesis take 4 (faster than 8 at both
// cells' grids, PERF.md), 2 or 1: 2 at n_φ = 4096 (the JAX package's
// default grid from L = 683), 1 at 8192, none past ≈9250 on the H100's
// 227 KB. B4 takes 8, 4 or 2 (its lines run in pairs). The wrapper derives
// the same count (ops/fft_plan.py fft_block_lines), sizes its buffers by
// it and passes it; the launch refuses any other.
inline int fft_block_lines(int most, int least, int n_phi, size_t per_line,
                           size_t smem_optin) {
  for (int lines = most; lines >= least; lines /= 2)
    if (fft_block_smem(n_phi, lines, per_line) + kStaticReserve <= smem_optin)
      return lines;
  return 0;
}

// cudaSuccess where `lines` is the rule's count on the current card.
inline cudaError_t check_fft_lines(int lines, int most, int least, int n_phi,
                                   size_t per_line) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return lines > 0 &&
                 lines == fft_block_lines(most, least, n_phi, per_line,
                                          (size_t)optin)
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

template <int kIn, int kLines>
cudaError_t launch_analysis_ffts(const void* f, const void* tw, void* g,
                                 int rows, int n_theta, int n_phi, int l_max,
                                 int radices, cudaStream_t stream) {
  constexpr int tile = (kIn == kComplexIn ? 1 : 2) * kLines;
  const dim3 grid((n_theta + tile - 1) / tile, rows);
  const size_t smem = fft_block_smem(n_phi, kLines);
  const cudaError_t err = allow_smem(analysis_fft_kernel<kIn, kLines>, smem);
  if (err != cudaSuccess) return err;
  analysis_fft_kernel<kIn, kLines><<<grid, kSynThreads, smem, stream>>>(
      static_cast<const AnalysisElem<kIn>*>(f),
      static_cast<const float2*>(tw), static_cast<float2*>(g), n_theta, n_phi,
      l_max, radices);
  return cudaGetLastError();
}

// The quadrature GEMM of an FFT-route analysis, g (rows, n_g, n_θ) → c
// (rows, 2L+1, L+1): n_g = 2L+1 for a complex field; L+1 for the real
// fields, j = L..2L, the m < 0 rows mirrored. bf16 tables: on the tensor
// cores (quadrature_bf16_kernel).
template <int kIn, class T = float>
int launch_quadrature_gemm(const void* g, const T* pw, void* c, int rows,
                           int n_theta, int l_max, cudaStream_t stream) {
  const int n_g = kIn == kComplexIn ? 2 * l_max + 1 : l_max + 1;
  if constexpr (std::is_same_v<T, bf16>) {
    const dim3 grid((l_max + kCL) / kCL, (rows + kCR - 1) / kCR, n_g);
    quadrature_bf16_kernel<kIn><<<grid, kCThreads, 0, stream>>>(
        static_cast<const float2*>(g), pw, static_cast<float2*>(c), rows,
        n_theta, l_max, kIn == kComplexIn ? 0 : l_max);
  } else {
    const dim3 grid((l_max + kQL) / kQL, (rows + kQR - 1) / kQR, n_g);
    quadrature_gemm_kernel<kIn><<<grid, kQThreads, 0, stream>>>(
        static_cast<const float2*>(g), pw, static_cast<float2*>(c), rows,
        n_theta, l_max, kIn == kComplexIn ? 0 : l_max);
  }
  return (int)cudaGetLastError();
}

// FFT route of an analysis: the FFTs into the scratch g ((rows, 2L+1,
// n_θ), or (rows, L+1, n_θ) for the real fields), then the quadrature
// GEMM; radices is the host plan's code for n_φ, tw its
// twiddles, lines the line rule's count. No cap on n_θ: θ is tiled; n_φ is
// capped where one FFT line no longer fits a block's shared memory.
template <int kIn, class T = float>
int launch_analysis_fft(const void* f, const T* pw, const void* tw,
                        void* g, void* c, int rows, int n_theta, int n_phi,
                        int l_max, int radices, int lines,
                        cudaStream_t stream) {
  const int n_m = 2 * l_max + 1;
  if (rows < 1 || rows > kMaxRows || n_theta < 1 || l_max < 0 ||
      n_m > n_phi || n_m > 65535 || tw == nullptr || g == nullptr ||
      !fft_code_valid(radices, n_phi))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = check_fft_lines(lines, 4, 1, n_phi, 0);
  if (err != cudaSuccess) return (int)err;
  switch (lines) {
    case 4:
      err = launch_analysis_ffts<kIn, 4>(f, tw, g, rows, n_theta, n_phi,
                                         l_max, radices, stream);
      break;
    case 2:
      err = launch_analysis_ffts<kIn, 2>(f, tw, g, rows, n_theta, n_phi,
                                         l_max, radices, stream);
      break;
    case 1:
      err = launch_analysis_ffts<kIn, 1>(f, tw, g, rows, n_theta, n_phi,
                                         l_max, radices, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return launch_quadrature_gemm<kIn, T>(g, pw, c, rows, n_theta, l_max,
                                        stream);
}

// extra_smem: dynamic shared memory the output type uses after fm_s.
template <class Out, class T = float>
int launch_synthesis(const void* c, const T* pt, const float* i_re,
                     const float* i_im, Out out, int rows, int n_theta,
                     int n_phi, int l_max, cudaStream_t stream,
                     size_t extra_smem = 0) {
  if (rows < 1 || rows > kMaxRows || n_theta < 1 || n_phi < 1 || l_max < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_theta + kTT - 1) / kTT, rows);
  const size_t smem =
      (size_t)(2 * l_max + 1) * kTT * sizeof(float2) + extra_smem;
  cudaError_t err = allow_smem(synthesis_kernel<Out, T>, smem);
  if (err != cudaSuccess) return (int)err;
  synthesis_kernel<Out, T><<<grid, kSynThreads, smem, stream>>>(
      static_cast<const float2*>(c), pt, i_re, i_im, out, n_theta, n_phi,
      l_max);
  return (int)cudaGetLastError();
}

template <class Out, int kLines>
cudaError_t launch_synthesis_ffts(const void* fm, const void* tw, Out out,
                                  int rows, int n_theta, int n_phi, int l_max,
                                  int radices, cudaStream_t stream) {
  constexpr int tile = Out::kReal ? 2 * kLines : kLines;
  const dim3 grid((n_theta + tile - 1) / tile, rows);
  const size_t smem = fft_block_smem(n_phi, kLines);
  const cudaError_t err = allow_smem(synthesis_fft_kernel<Out, kLines>, smem);
  if (err != cudaSuccess) return err;
  synthesis_fft_kernel<Out, kLines><<<grid, kSynThreads, smem, stream>>>(
      static_cast<const float2*>(fm), static_cast<const float2*>(tw), out,
      n_theta, n_phi, l_max, radices);
  return cudaGetLastError();
}

// FFT route: the Legendre GEMM into the scratch fm (rows, 2L+1, n_θ), then
// the FFTs and the output in tiles of `lines` θ lines (the line rule's
// count); radices is the host plan's code for n_φ, tw its twiddles. A real
// output folds onto m ≥ 0: fm is (rows, L+1, n_θ), and an FFT block of
// `lines` lines writes 2·lines θ lines. bf16 tables: the Legendre GEMM on
// the tensor cores (legendre_bf16_kernel).
template <class Out, class T = float>
int launch_synthesis_fft(const void* c, const T* pt, const void* tw,
                         void* fm, Out out, int rows, int n_theta, int n_phi,
                         int l_max, int radices, int lines,
                         cudaStream_t stream) {
  const int n_m = 2 * l_max + 1;
  if (rows < 1 || rows > kMaxRows || n_theta < 1 || l_max < 0 ||
      n_m > n_phi || n_m > 65535 || tw == nullptr || fm == nullptr ||
      !fft_code_valid(radices, n_phi))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = check_fft_lines(lines, 4, 1, n_phi, 0);
  if (err != cudaSuccess) return (int)err;
  if constexpr (std::is_same_v<T, bf16>) {
    const dim3 grid_l((n_theta + kBT - 1) / kBT, (rows + kBR - 1) / kBR,
                      Out::kReal ? l_max + 1 : n_m);
    legendre_bf16_kernel<Out><<<grid_l, kBThreads, 0, stream>>>(
        static_cast<const float2*>(c), pt, static_cast<float2*>(fm), rows,
        n_theta, l_max);
  } else {
    const dim3 grid_l((n_theta + kLT - 1) / kLT, (rows + kLR - 1) / kLR,
                      Out::kReal ? l_max + 1 : n_m);
    legendre_gemm_kernel<Out><<<grid_l, kLThreads, 0, stream>>>(
        static_cast<const float2*>(c), pt, static_cast<float2*>(fm), rows,
        n_theta, l_max);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (lines) {
    case 4:
      err = launch_synthesis_ffts<Out, 4>(fm, tw, out, rows, n_theta, n_phi,
                                          l_max, radices, stream);
      break;
    case 2:
      err = launch_synthesis_ffts<Out, 2>(fm, tw, out, rows, n_theta, n_phi,
                                          l_max, radices, stream);
      break;
    default:
      err = launch_synthesis_ffts<Out, 1>(fm, tw, out, rows, n_theta, n_phi,
                                          l_max, radices, stream);
  }
  return (int)err;
}

}  // namespace
