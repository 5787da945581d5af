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
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "fft.cuh"

namespace {

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
// for the block's mcount rows j0.. held in fm_s[θ·kMT + mm]; threads across
// (j, l). kMirror also writes c_{l,−m} = (−1)^m conj(c_{l,m}) (real fields).
template <bool kMirror>
__device__ void legendre_quadrature(const float2* fm_s, const float* pw,
                                    float2* out, int row, int j0, int mcount,
                                    int n_theta, int l_max) {
  const int n_m = 2 * l_max + 1;
  const int n_l = l_max + 1;
  for (int idx = threadIdx.x; idx < mcount * n_l; idx += blockDim.x) {
    const int mm = idx / n_l, l = idx % n_l, j = j0 + mm;
    const float* w = pw + (size_t)j * n_theta * n_l + l;
    float sr = 0.f, si = 0.f;
    for (int th = 0; th < n_theta; ++th) {
      const float wv = w[(size_t)th * n_l];
      const float2 f = fm_s[th * kMT + mm];
      sr = fmaf(f.x, wv, sr);
      si = fmaf(f.y, wv, si);
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
template <int kIn>
__global__ void analysis_kernel(const void* __restrict__ in,
                                const float* __restrict__ e_re,
                                const float* __restrict__ e_im,
                                const float* __restrict__ pw,
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
      fm_s[t * kMT + mm] = make_float2(acc_re[mm], acc_im[mm]);
  }
  __syncthreads();
  legendre_quadrature<kIn != kComplexIn>(fm_s, pw, out, row, j0, mcount,
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
// the imaginary part.
template <class Out>
__global__ void __launch_bounds__(kSynThreads)
synthesis_kernel(const float2* __restrict__ c,
                 const float* __restrict__ pt,
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
      const float2* cj = crow + (size_t)j * n_l;
      const float* pj = pt + (size_t)j * n_l * n_theta + t0 + tt;
      for (int l = 0; l < n_l; ++l) {
        const float2 cv = cj[l];
        const float p = pj[(size_t)l * n_theta];
        sr = fmaf(cv.x, p, sr);
        si = fmaf(cv.y, p, si);
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

template <int kIn>
int launch_analysis(const void* f, const float* e_re, const float* e_im,
                    const float* pw, void* c, int rows, int n_theta,
                    int n_phi, int l_max, cudaStream_t stream) {
  if (rows < 1 || rows > kMaxRows || n_theta < 1 || n_theta > 1024 ||
      n_phi < 1 || l_max < 0)
    return (int)cudaErrorInvalidValue;
  const int j_begin = kIn == kComplexIn ? 0 : l_max;
  const int n_j = kIn == kComplexIn ? 2 * l_max + 1 : l_max + 1;
  const dim3 grid((n_j + kMT - 1) / kMT, rows);
  const int threads = ((n_theta + 31) / 32) * 32;
  const size_t smem = (size_t)n_theta * kMT * sizeof(float2);
  cudaError_t err = allow_smem(analysis_kernel<kIn>, smem);
  if (err != cudaSuccess) return (int)err;
  analysis_kernel<kIn><<<grid, threads, smem, stream>>>(
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
// fields, j = L..2L, the m < 0 rows mirrored.
template <int kIn>
int launch_quadrature_gemm(const void* g, const float* pw, void* c, int rows,
                           int n_theta, int l_max, cudaStream_t stream) {
  const int n_g = kIn == kComplexIn ? 2 * l_max + 1 : l_max + 1;
  const dim3 grid((l_max + kQL) / kQL, (rows + kQR - 1) / kQR, n_g);
  quadrature_gemm_kernel<kIn><<<grid, kQThreads, 0, stream>>>(
      static_cast<const float2*>(g), pw, static_cast<float2*>(c), rows,
      n_theta, l_max, kIn == kComplexIn ? 0 : l_max);
  return (int)cudaGetLastError();
}

// FFT route of an analysis: the FFTs into the scratch g ((rows, 2L+1,
// n_θ), or (rows, L+1, n_θ) for the real fields), then the quadrature
// GEMM; radices is the host plan's code for n_φ, tw its
// twiddles, lines the line rule's count. No cap on n_θ: θ is tiled; n_φ is
// capped where one FFT line no longer fits a block's shared memory.
template <int kIn>
int launch_analysis_fft(const void* f, const float* pw, const void* tw,
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
  return launch_quadrature_gemm<kIn>(g, pw, c, rows, n_theta, l_max, stream);
}

// extra_smem: dynamic shared memory the output type uses after fm_s.
template <class Out>
int launch_synthesis(const void* c, const float* pt, const float* i_re,
                     const float* i_im, Out out, int rows, int n_theta,
                     int n_phi, int l_max, cudaStream_t stream,
                     size_t extra_smem = 0) {
  if (rows < 1 || rows > kMaxRows || n_theta < 1 || n_phi < 1 || l_max < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_theta + kTT - 1) / kTT, rows);
  const size_t smem =
      (size_t)(2 * l_max + 1) * kTT * sizeof(float2) + extra_smem;
  cudaError_t err = allow_smem(synthesis_kernel<Out>, smem);
  if (err != cudaSuccess) return (int)err;
  synthesis_kernel<Out><<<grid, kSynThreads, smem, stream>>>(
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
// `lines` lines writes 2·lines θ lines.
template <class Out>
int launch_synthesis_fft(const void* c, const float* pt, const void* tw,
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
  const dim3 grid_l((n_theta + kLT - 1) / kLT, (rows + kLR - 1) / kLR,
                    Out::kReal ? l_max + 1 : n_m);
  legendre_gemm_kernel<Out><<<grid_l, kLThreads, 0, stream>>>(
      static_cast<const float2*>(c), pt, static_cast<float2*>(fm), rows,
      n_theta, l_max);
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
