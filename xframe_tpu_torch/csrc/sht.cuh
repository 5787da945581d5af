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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= (size_t)kDefaultSmem) return cudaSuccess;
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

}  // namespace
