// Spherical-harmonic analysis and synthesis kernels for Hopper (sm_90a),
// shared by the SHT entry points (sht.cu) and the fused MTIP kernels
// (mtip.cu). Everything here is file-local to each translation unit.
//
// Layout: centered m (row j ↔ m = j − L), complex data as interleaved float2,
// tables float32 (built on the host by FusedSHT):
//   E[j, φ]    = e^{−imφ}·2π/n_φ (re/im planes)   analysis DFT
//   PW[j, θ, l] = P̄_l^m(θ)·w_GL(θ)                analysis quadrature
//   Pt[j, l, θ] = P̄_l^m(θ)                        synthesis
//   I[j, φ]    = e^{+imφ} (re/im planes)          synthesis DFT
// All sums accumulate in FP32 on CUDA cores.
#pragma once

#include <cuda_runtime.h>

#include "fft.cuh"

namespace {

constexpr int kMT = 16;           // m rows per analysis block
constexpr int kKP = 32;           // φ samples per staged DFT-table chunk
constexpr int kTT = 16;           // θ lines per synthesis block
constexpr int kSynThreads = 256;  // synthesis block size (threads across φ)
constexpr int kMaxRows = 65535;   // gridDim.y limit
constexpr int kDefaultSmem = 48 * 1024;

// Input of an analysis: a complex grid, a real grid, or a complex grid
// whose |x|² is analysed as a real field (formed in registers).
enum AnalysisIn { kComplexIn = 0, kRealIn = 1, kAbs2In = 2 };

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

// Analysis. One block per (row, tile of kMT table rows); thread t owns the
// θ line t of the row. Stage 1 forms fm[θ, m] = Σ_φ f[θ, φ]·E[m, φ] with the
// E chunk in shared memory; stage 2 is legendre_quadrature. Real and |x|²
// input: table rows m = 0..L only, and the block also writes the mirrored
// rows.
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
// once after the last (every thread of the block calls both).
struct ComplexOut {
  static constexpr bool kReal = false;
  float2* f;
  __device__ void begin(int) {}
  __device__ void put(size_t o, int, float re, float im) {
    f[o] = make_float2(re, im);
  }
  __device__ void finish(int, int) {}
};

struct RealOut {
  static constexpr bool kReal = true;
  float* f;
  __device__ void begin(int) {}
  __device__ void put(size_t o, int, float re, float) { f[o] = re; }
  __device__ void finish(int, int) {}
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
// The template argument is the synthesis's output type, unused here: it
// names the launch in a profile (B5's UpdateOut, B6's ComplexOut).
constexpr int kLR = 64;           // rows per block tile
constexpr int kLT = 64;           // θ lines per block tile
constexpr int kLK = 8;            // l per staged chunk
constexpr int kLThreads = 256;    // 16 × 16 threads, 4 × 4 sums each

template <class Out>
__global__ void __launch_bounds__(kLThreads)
legendre_gemm_kernel(const float2* __restrict__ c,
                     const float* __restrict__ pt, float2* __restrict__ fm,
                     int rows, int n_theta, int l_max) {
  __shared__ float2 a_s[2][kLK][kLR + 1];   // c[r0 + r, j, l0 + l]
  __shared__ float b_s[2][kLK][kLT + 4];    // Pt[j, l0 + l, t0 + θ]
  const int n_m = 2 * l_max + 1, n_l = l_max + 1;
  const int t0 = blockIdx.x * kLT, r0 = blockIdx.y * kLR, j = blockIdx.z;
  const int m = j < l_max ? l_max - j : j - l_max;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;

  auto load = [&](int st, int l0) {
    for (int e = t; e < kLK * kLR; e += kLThreads) {
      const int l = e % kLK, r = e / kLK;
      const bool ok = l0 + l < n_l && r0 + r < rows;
      cp_async8(&a_s[st][l][r],
                ok ? c + ((size_t)(r0 + r) * n_m + j) * n_l + l0 + l : c, ok);
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
    __syncthreads();
    const int st = ch & 1;
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
        fm[((size_t)r * n_m + j) * n_theta + th] = acc[i][k];
    }
  }
}

// Synthesis, FFT route, kernel 2. One block per (row, tile of kSFT θ lines):
//   1. each θ line's spectrum in shared memory: bin (m mod n_φ) ← fm[row,
//      m + L, θ] (read as 32-byte runs along θ), zero between L and n_φ − L;
//   2. one unnormalised inverse Stockham FFT per line (fft.cuh), e^{+imφ}
//      as the I table of the dense route;
//   3. threads across (θ line, φ) hand each value to out.put(), coalesced
//      along φ, then out.finish() once.
// ≈49 KB of shared memory at n_φ = 640, four blocks per SM (the register
// limit): twice the warps of 8-line tiles, whose barriers and the
// epilogue's loads then overlap more.
constexpr int kSFT = 4;           // θ lines per block

template <class Out>
__global__ void __launch_bounds__(kSynThreads, 4)
synthesis_fft_kernel(const float2* __restrict__ fm,
                     const float2* __restrict__ tw_g, Out out, int n_theta,
                     int n_phi, int l_max, int radices) {
  extern __shared__ float2 smem[];
  const int n_m = 2 * l_max + 1, ls = fft_line_stride(n_phi);
  float2* buf0 = smem;                                   // [kSFT][ls]
  float2* buf1 = buf0 + kSFT * ls;
  float2* tw = buf1 + kSFT * ls;                         // [n_phi]
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * kSFT, tcount = min(kSFT, n_theta - t0);
  const int t = threadIdx.x;
  int radix[kMaxPasses];
  const int passes = fft_radices(radices, radix);
  Out o = out;
  o.begin(row);

  for (int i = t; i < n_phi; i += blockDim.x) tw[i] = tw_g[i];
  const int gap = n_phi - n_m;
  for (int idx = t; idx < kSFT * gap; idx += blockDim.x) {
    const int tt = idx / gap, k = l_max + 1 + idx - tt * gap;
    buf0[tt * ls + fpad(k)] = make_float2(0.f, 0.f);
  }
  const float2* frow = fm + (size_t)row * n_m * n_theta + t0;
  for (int idx = t; idx < n_m * kSFT; idx += blockDim.x) {
    const int j = idx / kSFT, tt = idx - j * kSFT;
    const int k = j >= l_max ? j - l_max : j - l_max + n_phi;
    buf0[tt * ls + fpad(k)] =
        tt < tcount ? frow[(size_t)j * n_theta + tt] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  const float2* f = fft_lines(buf0, buf1, tw, radix, passes, n_phi, kSFT, ls,
                              true);
  for (int idx = t; idx < tcount * n_phi; idx += blockDim.x) {
    const int tt = idx / n_phi, p = idx - tt * n_phi;
    const float2 z = f[tt * ls + fpad(p)];
    o.put(((size_t)row * n_theta + t0 + tt) * n_phi + p, t0 + tt, z.x, z.y);
  }
  o.finish(row, blockIdx.x);
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

// FFT route: the Legendre GEMM into the scratch fm (rows, 2L+1, n_θ), then
// the FFTs and the output; radices is the host plan's code for n_φ, tw its
// twiddles.
template <class Out>
int launch_synthesis_fft(const void* c, const float* pt, const void* tw,
                         void* fm, Out out, int rows, int n_theta, int n_phi,
                         int l_max, int radices, cudaStream_t stream) {
  const int n_m = 2 * l_max + 1;
  if (rows < 1 || rows > kMaxRows || n_theta < 1 || l_max < 0 ||
      n_m > n_phi || n_m > 65535 || tw == nullptr || fm == nullptr ||
      !fft_code_valid(radices, n_phi))
    return (int)cudaErrorInvalidValue;
  const dim3 grid_l((n_theta + kLT - 1) / kLT, (rows + kLR - 1) / kLR, n_m);
  legendre_gemm_kernel<Out><<<grid_l, kLThreads, 0, stream>>>(
      static_cast<const float2*>(c), pt, static_cast<float2*>(fm), rows,
      n_theta, l_max);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_theta + kSFT - 1) / kSFT, rows);
  const size_t smem =
      ((size_t)2 * kSFT * fft_line_stride(n_phi) + n_phi) * sizeof(float2);
  err = allow_smem(synthesis_fft_kernel<Out>, smem);
  if (err != cudaSuccess) return (int)err;
  synthesis_fft_kernel<Out><<<grid, kSynThreads, smem, stream>>>(
      static_cast<const float2*>(fm), static_cast<const float2*>(tw), out,
      n_theta, n_phi, l_max, radices);
  return (int)cudaGetLastError();
}

}  // namespace
