// Newton–Schulz polar factor and the fused data projection for Hopper
// (sm_90a).
//
// Two C entry points, bound with ctypes by
// xframe_tpu_torch/ops/fused_projection.py (plain versions beside them
// there):
//
//   xf_polar_unitary     W = polar(M) for a batch of complex c×c matrices
//                        replaces xframe_tpu/ops/pallas_kernels.py:88 _polar_kernel
//                        (core _ns_polar_planes, :45)
//   xf_fused_projection  per order l of a bucket: B = PD_l·I_l, M = B + rms·eyeᶜ,
//                        W = polar(M), out = take·(V_l·W) + (1−take)·I_l
//                        replaces xframe_tpu/ops/pallas_kernels.py:119 _project_kernel (K5)
//
// Both share one Newton–Schulz core (ns_polar): normalise by
// √(max row sum · max column sum of |X|) + 1e-12, then per step of the
// schedule X ← a·X + X·(b·A + c·A²) with A = X†X; a step with c = 0 skips A²
// (the fixed iteration's four cubic polishing steps are (1.5, −0.5, 0)). The
// schedule's rows reach the kernel as a small float table in device memory.
//
// What bounds them. Three complex c×c products per step, c³ complex FMAs of
// 8 FLOP each: 14 minimax steps over the 63 orders at c = 253 of the
// production bucket are 343 GFLOP against a few MB of inputs, so FP32
// instruction throughput is the bound (5.1 ms at 67 TFLOP/s for that bucket
// alone; A and A² are Hermitian, so a kernel that forms half of each needs
// two thirds of that, 4.2 ms for the whole production projection, the bound
// chip_smoke.py states). All sums are FP32 FMAs on CUDA cores: no TF32, since the polar is
// pinned at float32 and its rounding floor is already ≈1e-5.
//
// What the design does about it. A block owns one (restart, order) matrix
// and runs its whole projection, as one grid program of the TPU kernel
// does; B, M and W never leave the block's scratch. X, A, A² do not fit in
// a block's 227 KB of shared memory (one c×c complex matrix is 512 KB at
// c = 253), so they live in a device-memory scratch the wrapper allocates,
// four c×c slots per block, and each product is tiled through shared memory
// (64×64 output tiles, 16-deep chunks, a 4×4 register micro-tile of complex
// FMAs per thread), with __syncthreads() between products. One block per
// matrix leaves SMs idle where a launch has fewer matrices than SMs: 63 of
// 132 SMs busy in the production c = 253 bucket, one SM for the full-width
// order l = L. Thread-block clusters with distributed shared memory, 3xTF32
// or wgmma are later work.
//
// Every launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() so that the Python wrapper raises on a refused launch.

#include "sht.cuh"

namespace {

constexpr int kNsThreads = 256;         // 16 × 16 threads
constexpr int kGM = 64, kGN = 64;       // output tile of a block product
constexpr int kGK = 16;                 // depth of a staged chunk
constexpr int kRM = kGM / 16, kRN = kGN / 16;  // register micro-tile
constexpr int kSlots = 4;               // c×c scratch matrices per block

// A complex matrix operand: element (r, k) at p[r·rs + k·cs], conjugated
// when conj is set (X† is {X, 1, c, true}). Scratch operands are written
// earlier in the same kernel, so no operand is read through the read-only
// cache.
struct CMat {
  const float2* p;
  int rs, cs;
  bool conj;
};

// out = alpha·d + beta·value (d may be null).
struct AxpbyEpi {
  float2* out;
  int ld;
  const float2* d;
  float alpha, beta;
  __device__ void operator()(int r, int n, float2 v) const {
    const size_t o = (size_t)r * ld + n;
    float2 y = make_float2(beta * v.x, beta * v.y);
    if (d) {
      const float2 x = d[o];
      y.x = fmaf(alpha, x.x, y.x);
      y.y = fmaf(alpha, x.y, y.y);
    }
    out[o] = y;
  }
};

// out = take_r·value + (1 − take_r)·keep, row r of an (n_q × c) block.
struct TakeEpi {
  float2* out;
  const float2* keep;
  const float* take;
  int ld;
  __device__ void operator()(int r, int n, float2 v) const {
    const size_t o = (size_t)r * ld + n;
    const float t = take[r];
    const float2 k = keep[o];
    out[o] = make_float2(t * v.x + (1.f - t) * k.x, t * v.y + (1.f - t) * k.y);
  }
};

// epi(r, n, (op(a)·b)[r, n]) for every element of the M×N product, K deep.
// Every thread of the block calls it; the caller synchronises before
// reading what epi wrote.
template <class Epi>
__device__ void block_gemm(int M, int N, int K, CMat a, CMat b, Epi epi) {
  __shared__ float2 as[kGK][kGM + 1];   // padded against bank conflicts
  __shared__ float2 bs[kGK][kGN + 1];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  for (int m0 = 0; m0 < M; m0 += kGM) {
    for (int n0 = 0; n0 < N; n0 += kGN) {
      float2 acc[kRM][kRN];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) acc[i][j] = make_float2(0.f, 0.f);
      for (int k0 = 0; k0 < K; k0 += kGK) {
        __syncthreads();
        // neighbouring threads on neighbouring addresses where a stride is 1
        for (int s = t; s < kGM * kGK; s += kNsThreads) {
          int r, k;
          if (a.rs == 1) {
            r = s % kGM;
            k = s / kGM;
          } else {
            k = s % kGK;
            r = s / kGK;
          }
          float2 x = make_float2(0.f, 0.f);
          if (m0 + r < M && k0 + k < K) {
            x = a.p[(size_t)(m0 + r) * a.rs + (size_t)(k0 + k) * a.cs];
            if (a.conj) x.y = -x.y;
          }
          as[k][r] = x;
        }
        for (int s = t; s < kGK * kGN; s += kNsThreads) {
          int k, n;
          if (b.cs == 1) {
            n = s % kGN;
            k = s / kGN;
          } else {
            k = s % kGK;
            n = s / kGK;
          }
          float2 x = make_float2(0.f, 0.f);
          if (k0 + k < K && n0 + n < N) {
            x = b.p[(size_t)(k0 + k) * b.rs + (size_t)(n0 + n) * b.cs];
            if (b.conj) x.y = -x.y;
          }
          bs[k][n] = x;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kGK; ++k) {
          float2 av[kRM], bv[kRN];
#pragma unroll
          for (int i = 0; i < kRM; ++i) av[i] = as[k][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < kRN; ++j) bv[j] = bs[k][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kRM; ++i)
#pragma unroll
            for (int j = 0; j < kRN; ++j) {
              acc[i][j].x = fmaf(av[i].x, bv[j].x, acc[i][j].x);
              acc[i][j].x = fmaf(-av[i].y, bv[j].y, acc[i][j].x);
              acc[i][j].y = fmaf(av[i].x, bv[j].y, acc[i][j].y);
              acc[i][j].y = fmaf(av[i].y, bv[j].x, acc[i][j].y);
            }
        }
      }
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          const int r = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
          if (r < M && n < N) epi(r, n, acc[i][j]);
        }
    }
  }
}

// The block's maximum of v, returned to every thread.
__device__ float block_max(float v) {
  __shared__ float red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = fmaxf(r, red[w]);
  return r;
}

// x = m / (√(max row sum · max column sum of |m|) + 1e-12), c×c row-major.
__device__ void ns_normalize(const float2* m, float2* x, int c) {
  float rmax = 0.f, cmax = 0.f;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    float sr = 0.f, sc = 0.f;
    for (int j = 0; j < c; ++j) {
      const float2 a = m[(size_t)i * c + j], b = m[(size_t)j * c + i];
      sr += sqrtf(a.x * a.x + a.y * a.y);
      sc += sqrtf(b.x * b.x + b.y * b.y);
    }
    rmax = fmaxf(rmax, sr);
    cmax = fmaxf(cmax, sc);
  }
  rmax = block_max(rmax);
  cmax = block_max(cmax);
  const float norm = sqrtf(rmax * cmax) + 1e-12f;
  for (size_t idx = threadIdx.x; idx < (size_t)c * c; idx += blockDim.x) {
    const float2 a = m[idx];
    x[idx] = make_float2(a.x / norm, a.y / norm);
  }
}

// The schedule's steps on the normalised X in slot 0 of buf (kSlots c×c
// matrices); returns the slot that holds the polar factor.
__device__ const float2* ns_polar(float2* buf, int c, const float* sched,
                                  int n_steps) {
  const size_t cc = (size_t)c * c;
  float2 *X = buf, *A = buf + cc, *Bm = buf + 2 * cc, *Y = buf + 3 * cc;
  for (int s = 0; s < n_steps; ++s) {
    const float ca = sched[3 * s], cb = sched[3 * s + 1],
                cq = sched[3 * s + 2];
    const CMat xh{X, 1, c, true}, x{X, c, 1, false};
    if (cq != 0.f) {
      block_gemm(c, c, c, xh, x, AxpbyEpi{A, c, nullptr, 0.f, 1.f});
      __syncthreads();
      const CMat a{A, c, 1, false};
      block_gemm(c, c, c, a, a, AxpbyEpi{Bm, c, A, cb, cq});
    } else {
      block_gemm(c, c, c, xh, x, AxpbyEpi{Bm, c, nullptr, 0.f, cb});
    }
    __syncthreads();
    block_gemm(c, c, c, x, CMat{Bm, c, 1, false}, AxpbyEpi{Y, c, X, ca, 1.f});
    __syncthreads();
    float2* tmp = X;
    X = Y;
    Y = tmp;
  }
  return X;
}

// B7: one block per matrix.
__global__ void __launch_bounds__(kNsThreads)
polar_kernel(const float2* m, float2* w, float2* scratch, const float* sched,
             int n_steps, int c) {
  const size_t cc = (size_t)c * c, g = blockIdx.x;
  float2* buf = scratch + g * kSlots * cc;
  ns_normalize(m + g * cc, buf, c);
  __syncthreads();
  const float2* X = ns_polar(buf, c, sched, n_steps);
  for (size_t idx = threadIdx.x; idx < cc; idx += blockDim.x)
    w[g * cc + idx] = X[idx];
}

// B8: one block per (order g of the bucket, restart b). pd (n_g, c, n_q);
// it, v and out (batch, n_g, n_q, c) and (n_g, n_q, c); take (n_g, n_q).
__global__ void __launch_bounds__(kNsThreads)
project_kernel(const float2* pd, const float2* it, const float2* v,
               const float* take, float2* out, float2* scratch,
               const float* sched, int n_steps, int n_g, int c, int n_q,
               int l_lo, int h) {
  __shared__ float rms_s;
  const int g = blockIdx.x, l = l_lo + g;
  const size_t cc = (size_t)c * c, qc = (size_t)n_q * c;
  const size_t mat = (size_t)blockIdx.y * n_g + g;
  float2* buf = scratch + mat * kSlots * cc;
  float2* B = buf + 3 * cc;
  const float2* itg = it + mat * qc;
  block_gemm(c, c, n_q, CMat{pd + g * qc, n_q, 1, false},
             CMat{itg, c, 1, false}, AxpbyEpi{B, c, nullptr, 0.f, 1.f});
  __syncthreads();
  // rms singular-value scale of the block, then the identity on the crop's
  // diagonal outside this order's window [h − l, h + l]
  float s[1] = {0.f};
  for (size_t idx = threadIdx.x; idx < cc; idx += blockDim.x) {
    const float2 x = B[idx];
    s[0] = fmaf(x.x, x.x, fmaf(x.y, x.y, s[0]));
  }
  block_sum(s);
  if (threadIdx.x == 0) rms_s = sqrtf(s[0] / (float)(2 * l + 1)) + 1e-20f;
  __syncthreads();
  const float rms = rms_s;
  for (int i = threadIdx.x; i < c; i += blockDim.x)
    if (i < h - l || i > h + l) B[(size_t)i * c + i].x += rms;
  __syncthreads();
  ns_normalize(B, buf, c);
  __syncthreads();
  const float2* W = ns_polar(buf, c, sched, n_steps);
  block_gemm(n_q, c, c, CMat{v + g * qc, c, 1, false}, CMat{W, c, 1, false},
             TakeEpi{out + mat * qc, itg, take + (size_t)g * n_q, c});
}

}  // namespace

extern "C" {

int xf_polar_unitary(const void* m, void* w, void* scratch, const float* sched,
                     int n_steps, int n_mat, int c, void* stream) {
  if (n_mat < 1 || c < 1 || n_steps < 0) return (int)cudaErrorInvalidValue;
  polar_kernel<<<n_mat, kNsThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float2*>(m), static_cast<float2*>(w),
      static_cast<float2*>(scratch), sched, n_steps, c);
  return (int)cudaGetLastError();
}

int xf_fused_projection(const void* pd, const void* it, const void* v,
                        const float* take, void* out, void* scratch,
                        const float* sched, int n_steps, int batch, int n_g,
                        int c, int n_q, int l_lo, int h, void* stream) {
  if (batch < 1 || batch > 65535 || n_g < 1 || c < 1 || n_q < 1 ||
      n_steps < 0 || l_lo < 0 || h < l_lo + n_g - 1 || c != 2 * h + 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_g, batch);
  project_kernel<<<grid, kNsThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float2*>(pd), static_cast<const float2*>(it),
      static_cast<const float2*>(v), take, static_cast<float2*>(out),
      static_cast<float2*>(scratch), sched, n_steps, n_g, c, n_q, l_lo, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
