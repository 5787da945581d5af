// Fused MTIP-iteration kernels for Hopper (sm_90a).
//
// Five C entry points, bound with ctypes by
// xframe_tpu_torch/ops/fused_mtip.py (plain versions beside them there):
//
//   xf_hankel_synthesize        cf = H(c) by a per-l contraction over k, then
//                               ψ = iSHT(cf); emits both
//                               replaces xframe_tpu/ops/pallas_mtip.py:115 _hankel_synth_kernel (K1h)
//   xf_inverse_real_project_fwd I_new = Re iSHT(I_lm), ψ_p = ψ·√(I_new/|ψ|²),
//                               Σw|ψ−ψ_p|² and Σw|ψ|², then the analysis of ψ_p
//                               replaces xframe_tpu/ops/pallas_mtip.py:241 _inv_real_project_fwd_kernel (K2⁺)
//   xf_synthesize_update        ρ_p = iSHT(d) (+ g·ρ_in on rows q ≠ 0 under ft-stab,
//                               g the per-restart linked ft-stab gate),
//                               phase anchor, real constraint, HIO/ER/RAAR,
//                               error sums and the next anchor sums, weighted by
//                               the (n_q, n_θ) plane or the shared grid
//                               replaces xframe_tpu/ops/pallas_mtip.py:321 _synth_update_kernel (K4)
//   xf_inverse_real_project     I_new = Re iSHT(I_lm), ψ_p = ψ·√(I_new/|ψ|²) written,
//                               Σw|ψ−ψ_p|² and Σw|ψ|² (B4 without the analysis)
//                               replaces xframe_tpu/ops/pallas_mtip.py:179 _inv_real_project_kernel (K2)
//   xf_synthesize_abs2          ψ = iSHT(cf), written, then the analysis of |ψ|²
//                               (m ≥ 0, mirrored) without re-reading ψ
//                               replaces xframe_tpu/ops/pallas_mtip.py:218 _synth_abs2_kernel (K1⁺)
//
// Rows are restarts × radial shells flattened, row = b·n_q + q. Per-restart
// sums leave the kernels as per-block partials, one block's in a fixed
// order (block_sum), and the wrapper adds them per restart; no float
// atomics, so two runs agree bitwise.
//
// What bounds them. Counting each φ-transform as an FFT and each Legendre
// stage over the (l, m) triangle (chip_smoke.py kernel_work), B4, B5, B6,
// B11 and B12 are bound by their bytes or, B4, B6 and B12 at production, by
// their operations: the production shapes (256 rows, L = 127, 320×640)
// give B4 11.7 GFLOP and 585 MB (0.175 ms at 67 TFLOP/s), B6 the n_q²
// Hankel contraction on top of a synthesis (0.245 ms), B11 a real
// synthesis plus one complex grid in and one out (918 MB, 0.274 ms), B12 a
// complex synthesis and a real analysis (0.178 ms).
//
// What the design does about it: every grid-sized intermediate of the TPU
// kernel stays out of HBM — the intensity I_new and ψ_p (B4), ρ_p, the
// round-trip correction and the anchored ρ_in (B5), I_new (B11), |ψ|²
// (B12). The φ-transforms run as mixed-radix Stockham FFTs in shared
// memory (fft.cuh, on the wrapper's plan: radices 4, 2, 3, 5 and a twiddle
// table) wherever n_φ = 2^a·3^b·5^c, every grid angular_grid_size gives and
// the production 640; other n_φ keep dense DFTs against the E/I tables, the
// route chosen by the wrapper from the shape.
//   B4, kernel (a) on the FFT route: per tile of 8 θ lines (4 or 2 where n_φ
//   leaves no room for 8: fft_block_lines, 2 at n_φ = 4096, refused past
//   ≈5500), the m ≥ 0 Legendre sums, I_new by one complex inverse FFT per
//   pair of lines (the two real lines in its real and imaginary parts), ψ_p
//   into shared memory and its forward FFT: ≈1/20 of the dense DFTs'
//   operations, ≈100 KB of shared memory per block at n_φ = 640 and 8
//   lines, two blocks per SM. The grid shape
//   forces the split: the synthesis of I_new needs every m of a θ line, the
//   analysis of ψ_p every θ of an m, and one row's (θ, 2L+1) Fourier
//   columns (264 KB at L = 64) exceed a block's shared memory; so kernel (a)
//   writes those columns (a quarter of ψ's bytes) and kernel (b) runs the
//   Legendre quadrature. Dense route: project_dft_kernel<true>.
//   B5 and B6 (and B11, B12 below) synthesize on sht.cuh's FFT route
//   (dense route: synthesis_kernel), B5 with the update as the epilogue
//   (UpdateOut). Its
//   Legendre stage is a per-order GEMM over the triangle only
//   (legendre_gemm_kernel, 64 rows × 64 θ lines per block), so each table
//   value serves 64 shells and the 41.8 MB table crosses L2 rows/64 times;
//   its output fm, (rows, 2L+1, θ) Fourier columns (40 % of the grid's
//   bytes), goes through device memory to synthesis_fft_kernel (spectra,
//   inverse FFTs, epilogue). Not inside the FFT block: a few shells per
//   block there stall on L2 latency, the block's table slice read as
//   32-byte pieces, too few in flight.
//   B6's contraction is a per-order complex GEMM (hankel_gemm_kernel): 32
//   q′ × 32 m × 8 l per block, 4 × 8 complex sums per thread in registers,
//   k-chunks double-buffered in shared memory by cp.async, FP32 on CUDA
//   cores (TF32 keeps three digits, short of the 1e-4 bound). It writes cf
//   at full (m, l) width, an output in any case, and the synthesis reads it
//   back: ≈0.02 ms at production against a fused kernel's shared-memory
//   hand-off.
//   B11 is B10's real synthesis with the projection as its epilogue: on
//   the FFT route legendre_gemm_kernel<ProjectOut> (folded onto m ≥ 0) into
//   a (rows, L+1, θ) scratch, then synthesis_fft_kernel<ProjectOut> (two θ
//   lines per inverse FFT), whose ProjectOut turns each I_new value in
//   registers into ψ_p, reading ψ once and writing ψ_p once, and keeps the
//   sums in registers; I_new never reaches HBM. Dense route: B4's dense
//   kernel (a) less its DFT, project_dft_kernel<false>.
//   B12 is B6's synthesis with B3's |ψ|² analysis as its epilogue: on the
//   FFT route legendre_gemm_kernel<Abs2FftOut>, then
//   synthesis_fft_kernel<Abs2FftOut> writes ψ and, in the same block, packs
//   |ψ|² two θ lines per complex line into the buffer its inverse FFTs left
//   free, runs the forward FFTs and unpairs onto m ≥ 0 into a (rows, L+1,
//   θ) scratch; quadrature_gemm_kernel<kSynthAbs2In> mirrors the m < 0
//   rows. Dense route: kernel (a) is the ψ synthesis with an epilogue
//   (Abs2Out) that keeps the tile's |ψ|² in shared memory and DFTs it onto
//   the m ≥ 0 bins, kernel (b) B4's quadrature with the m < 0 rows mirrored.
//
// bf16 tables (fourier_transform.fused_bf16_tables): each entry point has a
// form named with _bf16 at the end, the same kernels with T = bf16 and the
// same arguments, the Legendre tables PW and Pt in bf16 (sht.cuh): the FFT
// route's Legendre GEMMs of B5, B6, B11 and B12 and B12's quadrature GEMM
// on the tensor cores; B4's legendre_pos and quadrature_kernel, and the
// dense routes' Legendre stages, on CUDA cores; each Legendre operand
// rounded to bf16 (B4's and B11's coefficients after the Hermitian fold,
// which stays float32), every sum in float32. The Hankel GEMM (B6), the
// FFTs and the E and I DFTs stay float32.
//
// Every launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() so that the Python wrapper raises on a refused launch.

#include "sht.cuh"

namespace {

// ------------------------------------------------------------ B6 (K1h)
// The Hankel contraction cf[b, q′, m, l] = Σ_k wf[k, q′, l]·c[b, k, m, l]
// as, for each order l, the complex product (n_q × n_q)·(n_q × n_m) of
// wf[·, ·, l]ᵀ and c[b, ·, ·, l], at full (m, l) width.
constexpr int kGQ = 32;         // q′ per block tile
constexpr int kGM = 32;         // m per block tile
constexpr int kGL = 8;          // consecutive l per block tile, a warp each
constexpr int kGK = 8;          // k per staged chunk
constexpr int kGThreads = 32 * kGL;
constexpr int kGTq = 4;         // q′ per thread: lane/4 + 8·i
constexpr int kGTm = 8;         // m per thread: lane%4 + 4·j
constexpr int kGQs = kGQ + 4;   // padded shared rows
constexpr int kGMs = kGM + 4;
static_assert(kGTq * 8 == kGQ && kGTm * 4 == kGM,
              "a warp's 8 × 4 lanes cover the block tile of its order");

struct HankelStage {
  float2 w[kGK][kGL][kGQs];     // wf[k0 + kk, q0 + q, l0 + l]
  float2 c[kGK][kGL][kGMs];     // c[b, k0 + kk, m0 + m, l0 + l]
};

// One block per (l tile, m tile, q′ tile) along x (q′ fastest, so that the
// blocks sharing a c slice run together, then m, so that those sharing a
// weight slice do) and restart b along z. Warp w computes order l0 + w;
// lane (qg, mg) = (lane/4, lane%4) holds the 4 × 8 complex sums q′ = q0 +
// qg + 8i, m = m0 + mg + 4j in registers. k advances kGK at a time through
// two shared stages filled by cp.async, the next chunk's copies in flight
// while the current one multiplies: per k, 12 shared loads (broadcast
// within the warp) feed 128 FMAs. The copies run along l, the innermost
// axis of both inputs, and transpose into the stage's [k][l][·] rows.
__global__ void __launch_bounds__(kGThreads, 2)
hankel_gemm_kernel(const float2* __restrict__ c, const float2* __restrict__ wf,
                   float2* __restrict__ cf, int n_q, int n_m, int n_l) {
  extern __shared__ float4 hankel_dyn[];
  HankelStage* stage = reinterpret_cast<HankelStage*>(hankel_dyn);
  const int n_qt = (n_q + kGQ - 1) / kGQ, n_mt = (n_m + kGM - 1) / kGM;
  const int qt = blockIdx.x % n_qt, rest = blockIdx.x / n_qt;
  const int q0 = qt * kGQ, m0 = (rest % n_mt) * kGM, l0 = (rest / n_mt) * kGL;
  const int b = blockIdx.z, t = threadIdx.x;
  const float2* cb = c + (size_t)b * n_q * n_m * n_l;

  auto load = [&](int st, int k0) {
    HankelStage& s = stage[st];
    for (int e = t; e < kGK * kGQ * kGL; e += kGThreads) {
      const int l = e % kGL, q = (e / kGL) % kGQ, kk = e / (kGL * kGQ);
      const int k = k0 + kk;
      const bool ok = k < n_q && q0 + q < n_q && l0 + l < n_l;
      cp_async8(&s.w[kk][l][q],
                ok ? wf + ((size_t)k * n_q + q0 + q) * n_l + l0 + l : wf, ok);
    }
    for (int e = t; e < kGK * kGM * kGL; e += kGThreads) {
      const int l = e % kGL, m = (e / kGL) % kGM, kk = e / (kGL * kGM);
      const int k = k0 + kk;
      const bool ok = k < n_q && m0 + m < n_m && l0 + l < n_l;
      cp_async8(&s.c[kk][l][m],
                ok ? cb + ((size_t)k * n_m + m0 + m) * n_l + l0 + l : cb, ok);
    }
    cp_async_commit();
  };

  const int w = t >> 5, qg = (t & 31) >> 2, mg = t & 3;
  float2 acc[kGTq][kGTm];
#pragma unroll
  for (int i = 0; i < kGTq; ++i)
#pragma unroll
    for (int j = 0; j < kGTm; ++j) acc[i][j] = make_float2(0.f, 0.f);

  const int chunks = (n_q + kGK - 1) / kGK;
  load(0, 0);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      load((ch + 1) & 1, (ch + 1) * kGK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const HankelStage& s = stage[ch & 1];
#pragma unroll
    for (int kk = 0; kk < kGK; ++kk) {
      float2 wv[kGTq], cv[kGTm];
#pragma unroll
      for (int i = 0; i < kGTq; ++i) wv[i] = s.w[kk][w][qg + 8 * i];
#pragma unroll
      for (int j = 0; j < kGTm; ++j) cv[j] = s.c[kk][w][mg + 4 * j];
#pragma unroll
      for (int i = 0; i < kGTq; ++i)
#pragma unroll
        for (int j = 0; j < kGTm; ++j) {
          acc[i][j].x = fmaf(wv[i].x, cv[j].x, acc[i][j].x);
          acc[i][j].x = fmaf(-wv[i].y, cv[j].y, acc[i][j].x);
          acc[i][j].y = fmaf(wv[i].x, cv[j].y, acc[i][j].y);
          acc[i][j].y = fmaf(wv[i].y, cv[j].x, acc[i][j].y);
        }
    }
    __syncthreads();   // the stage is refilled two chunks on
  }

  const int l = l0 + w;
  if (l >= n_l) return;
#pragma unroll
  for (int i = 0; i < kGTq; ++i) {
    const int q = q0 + qg + 8 * i;
#pragma unroll
    for (int j = 0; j < kGTm; ++j) {
      const int m = m0 + mg + 4 * j;
      if (q < n_q && m < n_m)
        cf[(((size_t)b * n_q + q) * n_m + m) * n_l + l] = acc[i][j];
    }
  }
}

int launch_hankel_gemm(const void* c, const void* wf, void* cf, int batch,
                       int n_q, int l_max, cudaStream_t st) {
  const int n_m = 2 * l_max + 1, n_l = l_max + 1;
  const long long tiles = (long long)((n_q + kGQ - 1) / kGQ)
                          * ((n_m + kGM - 1) / kGM) * ((n_l + kGL - 1) / kGL);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, 1, batch);
  const size_t smem = 2 * sizeof(HankelStage);
  cudaError_t err = allow_smem(hankel_gemm_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  hankel_gemm_kernel<<<grid, kGThreads, smem, st>>>(
      static_cast<const float2*>(c), static_cast<const float2*>(wf),
      static_cast<float2*>(cf), n_q, n_m, n_l);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ B4 (K2⁺)
constexpr int kPThreads = 256;  // projection block size
constexpr int kPJ = 8;          // m rows per thread in the ψ_p DFT
static_assert(kTT == 2 * (kPThreads / 32),
              "the ψ_p DFT gives each warp two θ lines of the tile");

// The m ≥ 0 Legendre sums of a tile of `tile` θ lines from t0 (tcount of
// them real, the rest zero) into fm_s[m·tile + tt]: I_lm hermitianized by
// index, c_h[0] = Re c[L], c_h[m] = (c[L+m] + (−1)^m conj c[L−m])/2, then
// Σ_{l ≥ m} c_h[m, l]·P̄_l^m(θ), times `mscale` for m > 0 (P̄_l^m = 0 for
// l < m).
template <class T>
__device__ void legendre_pos(const float2* crow, const T* pt,
                             float2* fm_s, int tile, int t0, int tcount,
                             int n_theta, int l_max, float mscale) {
  const int n_l = l_max + 1;
  for (int idx = threadIdx.x; idx < n_l * tile; idx += blockDim.x) {
    const int m = idx / tile, tt = idx % tile;
    float sr = 0.f, si = 0.f;
    if (tt < tcount) {
      const float2* cp = crow + (size_t)(l_max + m) * n_l;
      const float2* cn = crow + (size_t)(l_max - m) * n_l;
      const float s = (m & 1) ? -1.f : 1.f;
      const T* pj = pt + (size_t)(l_max + m) * n_l * n_theta + t0 + tt;
      if constexpr (std::is_same_v<T, bf16>) {
#pragma unroll (kBf16Unroll)
        for (int l = m; l < n_l; ++l) {
          const float2 a = cp[l];
          float hr = a.x, hi = 0.f;
          if (m > 0) {
            const float2 bm = cn[l];
            hr = 0.5f * (a.x + s * bm.x);
            hi = 0.5f * (a.y - s * bm.y);
          }
          const float p = table_value(pj[(size_t)l * n_theta]);
          sr = fmaf(legendre_operand<T>(hr), p, sr);
          si = fmaf(legendre_operand<T>(hi), p, si);
        }
      } else {
        for (int l = m; l < n_l; ++l) {
          const float2 a = cp[l];
          float hr = a.x, hi = 0.f;
          if (m > 0) {
            const float2 bm = cn[l];
            hr = 0.5f * (a.x + s * bm.x);
            hi = 0.5f * (a.y - s * bm.y);
          }
          const float p = pj[(size_t)l * n_theta];
          sr = fmaf(hr, p, sr);
          si = fmaf(hi, p, si);
        }
      }
      if (m > 0) {
        sr *= mscale;
        si *= mscale;
      }
    }
    fm_s[idx] = make_float2(sr, si);
  }
}

// ψ_p = ψ·√(I_new/|ψ|²) where |ψ|² > 0 and I_new ≥ 0, else 0, at grid
// offset o; adds the w-weighted terms of Σw|ψ−ψ_p|² and Σw|ψ|².
__device__ __forceinline__ float2 amplitude_project(const float2* psi,
                                                    size_t o, float inew,
                                                    float wv, float& num,
                                                    float& den) {
  const float2 x = psi[o];
  const float inten = x.x * x.x + x.y * x.y;
  const bool valid = inten > 0.f && inew >= 0.f;
  const float s = valid ? sqrtf(inew / inten) : 0.f;
  const float2 pp = make_float2(x.x * s, x.y * s);
  const float dr = x.x - pp.x, di = x.y - pp.y;
  num += wv * (dr * dr + di * di);
  den += wv * inten;
  return pp;
}

// B11's output on the FFT route (synthesis_fft_kernel, a real output):
// each I_new value, in registers, becomes ψ_p = amplitude_project(ψ) at its
// grid offset, ψ read once and ψ_p written once, coalesced along φ; the
// w-weighted sums stay in registers and leave as one pair of partials per
// (row, θ tile of 2·kLines lines) through block_sum, in a fixed order.
struct ProjectOut {
  static constexpr bool kReal = true;
  const float2* psi;
  const float* w;       // (n_q, n_θ) weight plane, or null: unweighted
  float2* psi_p;
  float* parts;         // (rows, θ tiles, 2)
  int n_q, n_theta;
  const float* wq;
  float acc[2];

  __device__ void begin(int row) {
    wq = w ? w + (size_t)(row % n_q) * n_theta : nullptr;
    acc[0] = acc[1] = 0.f;
  }

  __device__ void put(size_t o, int th, float inew, float) {
    psi_p[o] =
        amplitude_project(psi, o, inew, wq ? wq[th] : 1.f, acc[0], acc[1]);
  }

  __device__ void finish(int row, int tile) {
    block_sum(acc);
    if (threadIdx.x == 0) {
      float* pr = parts + ((size_t)row * gridDim.x + tile) * 2;
      pr[0] = acc[0];
      pr[1] = acc[1];
    }
  }
};

size_t project_smem(int n_phi, int l_max) {
  return (size_t)(l_max + 1) * kTT * sizeof(float2)        // fm_s
         + (size_t)kTT * (n_phi + 1) * sizeof(float2)      // ψ_p tile
         + (size_t)2 * (2 * l_max + 1) * (kKP + 1) * sizeof(float);  // E chunk
}

// Dense route of B4 and of B11. Kernel (a): one block per (row, tile of
// kTT θ lines).
//   1. legendre_pos with w_0 = 1, w_{m>0} = 2, so I_new = Σ_m Re(fm·e^{imφ}).
//   2. Threads across φ: I_new in registers (a dense sum over the L+1
//      m ≥ 0 bins against the I table), ψ_p and the w-weighted partial
//      sums. B11 (kDft = false) writes ψ_p and stops here; B4 keeps ψ_p in
//      shared memory (rows padded by one value against bank conflicts).
//   3. B4 only: dense DFT of the tile's ψ_p onto the 2L+1 bins: lane ↔ m
//      (32 apart), warp ↔ two θ lines, E staged kKP φ at a time; write
//      g[row, θ, m]. B4 takes this route only where n_φ has a prime factor
//      other than 2, 3 and 5.
template <bool kDft, class T = float>
__global__ void __launch_bounds__(kPThreads)
project_dft_kernel(const float2* __restrict__ c, const T* __restrict__ pt,
                   const float* __restrict__ i_re,
                   const float* __restrict__ i_im,
                   const float2* __restrict__ psi, const float* __restrict__ w,
                   const float* __restrict__ e_re,
                   const float* __restrict__ e_im, float2* __restrict__ g,
                   float2* __restrict__ psi_p, float* __restrict__ parts,
                   int n_q, int n_theta, int n_phi, int l_max) {
  extern __shared__ float2 smem[];
  const int n_m = 2 * l_max + 1, n_l = l_max + 1;
  const int ps_stride = n_phi + 1;
  float2* fm_s = smem;                                   // [n_l][kTT]
  float2* ps_s = fm_s + n_l * kTT;                       // [kTT][n_phi + 1]
  float* es_re = reinterpret_cast<float*>(ps_s + kTT * ps_stride);
  float* es_im = es_re + n_m * (kKP + 1);                // [n_m][kKP + 1]
  const int row = blockIdx.y, q = row % n_q;
  const int t0 = blockIdx.x * kTT, tcount = min(kTT, n_theta - t0);
  const int t = threadIdx.x;

  legendre_pos(c + (size_t)row * n_m * n_l, pt, fm_s, kTT, t0, tcount,
               n_theta, l_max, 2.f);
  __syncthreads();

  float num = 0.f, den = 0.f;
  const float* wq = w ? w + (size_t)q * n_theta + t0 : nullptr;
  auto project = [&](int tt, int p, float inew) {
    float2 pp = make_float2(0.f, 0.f);
    if (tt < tcount) {
      const size_t o = ((size_t)row * n_theta + t0 + tt) * n_phi + p;
      pp = amplitude_project(psi, o, inew, wq ? wq[tt] : 1.f, num, den);
      if constexpr (!kDft) psi_p[o] = pp;
    }
    if constexpr (kDft) ps_s[tt * ps_stride + p] = pp;
  };
  for (int p0 = 0; p0 < n_phi; p0 += 2 * blockDim.x) {
    const int pa = p0 + t, pb = pa + blockDim.x;
    const bool oka = pa < n_phi, okb = pb < n_phi;
    float ia[kTT], ib[kTT];
#pragma unroll
    for (int tt = 0; tt < kTT; ++tt) {
      ia[tt] = 0.f;
      ib[tt] = 0.f;
    }
    for (int m = 0; m < n_l; ++m) {
      const size_t e = (size_t)(l_max + m) * n_phi;
      const float car = oka ? i_re[e + pa] : 0.f;
      const float sar = oka ? i_im[e + pa] : 0.f;
      const float cbr = okb ? i_re[e + pb] : 0.f;
      const float sbr = okb ? i_im[e + pb] : 0.f;
      const float2* fj = fm_s + m * kTT;
#pragma unroll
      for (int tt = 0; tt < kTT; ++tt) {
        const float2 f = fj[tt];
        ia[tt] = fmaf(f.x, car, ia[tt]);
        ia[tt] = fmaf(-f.y, sar, ia[tt]);
        ib[tt] = fmaf(f.x, cbr, ib[tt]);
        ib[tt] = fmaf(-f.y, sbr, ib[tt]);
      }
    }
#pragma unroll
    for (int tt = 0; tt < kTT; ++tt) {
      if (oka) project(tt, pa, ia[tt]);
      if (okb) project(tt, pb, ib[tt]);
    }
  }

  if constexpr (kDft) {
    const int jg = t & 31, tg = t >> 5;
    float ar[kPJ][2], ai[kPJ][2];
#pragma unroll
    for (int i = 0; i < kPJ; ++i) {
      ar[i][0] = ar[i][1] = 0.f;
      ai[i][0] = ai[i][1] = 0.f;
    }
    for (int p0 = 0; p0 < n_phi; p0 += kKP) {
      const int kn = min(kKP, n_phi - p0);
      __syncthreads();
      for (int idx = t; idx < n_m * kKP; idx += blockDim.x) {
        const int j = idx / kKP, k = idx % kKP;
        const bool ok = k < kn;
        const size_t e = (size_t)j * n_phi + p0 + k;
        es_re[j * (kKP + 1) + k] = ok ? e_re[e] : 0.f;
        es_im[j * (kKP + 1) + k] = ok ? e_im[e] : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < kn; ++k) {
        const float2 x0 = ps_s[tg * ps_stride + p0 + k];
        const float2 x1 = ps_s[(tg + kTT / 2) * ps_stride + p0 + k];
#pragma unroll
        for (int i = 0; i < kPJ; ++i) {
          const int j = jg + 32 * i;
          if (j < n_m) {
            const float er = es_re[j * (kKP + 1) + k];
            const float ei = es_im[j * (kKP + 1) + k];
            ar[i][0] = fmaf(x0.x, er, ar[i][0]);
            ar[i][0] = fmaf(-x0.y, ei, ar[i][0]);
            ai[i][0] = fmaf(x0.x, ei, ai[i][0]);
            ai[i][0] = fmaf(x0.y, er, ai[i][0]);
            ar[i][1] = fmaf(x1.x, er, ar[i][1]);
            ar[i][1] = fmaf(-x1.y, ei, ar[i][1]);
            ai[i][1] = fmaf(x1.x, ei, ai[i][1]);
            ai[i][1] = fmaf(x1.y, er, ai[i][1]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPJ; ++i) {
      const int j = jg + 32 * i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tt = tg + h * (kTT / 2);
        if (j < n_m && tt < tcount)
          g[((size_t)row * n_theta + t0 + tt) * n_m + j] =
              make_float2(ar[i][h], ai[i][h]);
      }
    }
  }

  float v[2] = {num, den};
  block_sum(v);
  if (t == 0) {
    float* pr = parts + ((size_t)row * gridDim.x + blockIdx.x) * 2;
    pr[0] = v[0];
    pr[1] = v[1];
  }
}

// FFT route of B4's kernel (a), for n_φ = 2^a·3^b·5^c: one block per (row,
// tile of kLines θ lines, kLines/2 pairs), all of the tile's φ-transforms
// as Stockham FFTs in shared memory (fft.cuh: two line buffers that passes
// alternate between, and the twiddle table), after the tile's Legendre
// sums, (L+1) values per line.
inline size_t project_fft_line_bytes(int l_max) {
  return (size_t)(l_max + 1) * sizeof(float2);
}

// Kernel (a), FFT route:
//   1. legendre_pos without the factor 2, H[m] for m = 0..L.
//   2. θ lines a = 2k and b = 2k+1 of the tile share one complex spectrum
//      Z = H_a + i·H_b of n_φ bins: Z[0] = Re H_a[0] + i·Re H_b[0], Z[m] =
//      H_a[m] + i·H_b[m] and Z[n_φ−m] = conj H_a[m] + i·conj H_b[m] for
//      m = 1..L, zero elsewhere; its inverse FFT is I_new(a) + i·I_new(b),
//      = irfft(spec·n_φ) of SphericalHarmonicTransform.inverse_real.
//   3. ψ read coalesced along φ, ψ_p (and the partial sums) into the other
//      line buffer.
//   4. Forward FFT of the tile's ψ_p lines; g[row, θ, j] = 2π/n_φ times FFT
//      bin bins[j], bins[j] = (j − L) mod n_φ (torch.fft.fft's
//      unnormalised convention, the analysis's 2π/n_φ applied here).
// The passes' radices arrive as 3-bit digits of `radices`, first pass
// lowest; the twiddles tw[t] = e^{−2πi·t/n_φ} and the bin map come from the
// wrapper.
template <int kLines, class T = float>
__global__ void __launch_bounds__(kPThreads, 2)
project_fft_kernel(const float2* __restrict__ c, const T* __restrict__ pt,
                   const float2* __restrict__ psi, const float* __restrict__ w,
                   const float2* __restrict__ tw_g,
                   const int* __restrict__ bins, float2* __restrict__ g,
                   float* __restrict__ parts, int n_q, int n_theta,
                   int n_phi, int l_max, int radices) {
  static_assert(kLines % 2 == 0, "the I_new synthesis runs θ lines in pairs");
  extern __shared__ float2 smem[];
  const int n_m = 2 * l_max + 1, n_l = l_max + 1;
  const int ls = fft_line_stride(n_phi);
  float2* fm_s = smem;                                   // [n_l][kLines]
  float2* buf0 = fm_s + n_l * kLines;                    // [kLines][ls]
  float2* buf1 = buf0 + kLines * ls;
  float2* tw = buf1 + kLines * ls;                       // [n_phi]
  const int row = blockIdx.y, q = row % n_q;
  const int t0 = blockIdx.x * kLines, tcount = min(kLines, n_theta - t0);
  const int t = threadIdx.x;
  int radix[kMaxPasses];
  const int passes = fft_radices(radices, radix);

  for (int i = t; i < n_phi; i += blockDim.x) tw[i] = tw_g[i];
  legendre_pos(c + (size_t)row * n_m * n_l, pt, fm_s, kLines, t0, tcount,
               n_theta, l_max, 1.f);
  __syncthreads();

  // 2. the pairs' spectra into buf0 lines 0 .. kLines/2 − 1
  for (int idx = t; idx < (kLines / 2) * n_phi; idx += blockDim.x) {
    const int pair = idx / n_phi, k = idx - pair * n_phi;
    const int m = k <= l_max ? k : n_phi - k;
    float2 z = make_float2(0.f, 0.f);
    if (m <= l_max) {
      const float2 ha = fm_s[m * kLines + 2 * pair];
      const float2 hb = fm_s[m * kLines + 2 * pair + 1];
      if (k == 0)
        z = make_float2(ha.x, hb.x);
      else if (k == m)
        z = make_float2(ha.x - hb.y, ha.y + hb.x);
      else
        z = make_float2(ha.x + hb.y, hb.x - ha.y);
    }
    buf0[pair * ls + fpad(k)] = z;
  }
  __syncthreads();
  float2* inew = fft_lines(buf0, buf1, tw, radix, passes, n_phi, kLines / 2,
                           ls, true);
  float2* lines = inew == buf0 ? buf1 : buf0;

  // 3. ψ_p of the tile
  float num = 0.f, den = 0.f;
  const float* wq = w ? w + (size_t)q * n_theta + t0 : nullptr;
  for (int idx = t; idx < kLines * n_phi; idx += blockDim.x) {
    const int tt = idx / n_phi, p = idx - tt * n_phi;
    float2 pp = make_float2(0.f, 0.f);
    if (tt < tcount) {
      const float2 z = inew[(tt >> 1) * ls + fpad(p)];
      const size_t o = ((size_t)row * n_theta + t0 + tt) * n_phi + p;
      pp = amplitude_project(psi, o, (tt & 1) ? z.y : z.x,
                             wq ? wq[tt] : 1.f, num, den);
    }
    lines[tt * ls + fpad(p)] = pp;
  }
  __syncthreads();

  // 4. the analysis FFT and the 2L+1 bins
  const float2* spec = fft_lines(lines, inew, tw, radix, passes, n_phi,
                                 kLines, ls, false);
  const float scale = 6.283185307179586f / (float)n_phi;
  for (int idx = t; idx < tcount * n_m; idx += blockDim.x) {
    const int tt = idx / n_m, j = idx - tt * n_m;
    const float2 z = spec[tt * ls + fpad(bins[j])];
    g[((size_t)row * n_theta + t0 + tt) * n_m + j] =
        make_float2(z.x * scale, z.y * scale);
  }

  float v[2] = {num, den};
  block_sum(v);
  if (t == 0) {
    float* pr = parts + ((size_t)row * gridDim.x + blockIdx.x) * 2;
    pr[0] = v[0];
    pr[1] = v[1];
  }
}

// Kernel (b): the Legendre quadrature of Fourier columns g (rows, θ, n_j)
// onto table rows j_begin .. j_begin + n_j − 1, one block per (row, tile of
// kMT rows), as stage 2 of analysis_kernel (g rounded by legendre_operand
// as it is staged). kMirror also writes the m < 0 rows of a real field
// (B12's |ψ|², m ≥ 0 columns only).
template <bool kMirror, class T = float>
__global__ void quadrature_kernel(const float2* __restrict__ g,
                                  const T* __restrict__ pw,
                                  float2* __restrict__ out, int n_theta,
                                  int l_max, int j_begin, int n_j) {
  extern __shared__ float2 fm_s[];          // [n_theta][kMT]
  const int row = blockIdx.y, j0 = j_begin + blockIdx.x * kMT;
  const int mcount = min(kMT, j_begin + n_j - j0);
  for (int idx = threadIdx.x; idx < n_theta * kMT; idx += blockDim.x) {
    const int th = idx / kMT, mm = idx % kMT;
    float2 v = make_float2(0.f, 0.f);
    if (mm < mcount) {
      v = g[((size_t)row * n_theta + th) * n_j + j0 - j_begin + mm];
      v = make_float2(legendre_operand<T>(v.x), legendre_operand<T>(v.y));
    }
    fm_s[idx] = v;
  }
  __syncthreads();
  legendre_quadrature<kMirror, T>(fm_s, pw, out, row, j0, mcount, n_theta,
                                  l_max);
}

template <int kLines, class T>
cudaError_t launch_project_fft(const void* c, const T* pt, const void* psi,
                               const float* w, const void* tw,
                               const int* bins, void* g, float* parts,
                               int rows, int n_q, int n_theta, int n_phi,
                               int l_max, int radices, cudaStream_t st) {
  const dim3 grid((n_theta + kLines - 1) / kLines, rows);
  const size_t smem =
      fft_block_smem(n_phi, kLines, project_fft_line_bytes(l_max));
  const cudaError_t err = allow_smem(project_fft_kernel<kLines, T>, smem);
  if (err != cudaSuccess) return err;
  project_fft_kernel<kLines, T><<<grid, kPThreads, smem, st>>>(
      static_cast<const float2*>(c), pt, static_cast<const float2*>(psi), w,
      static_cast<const float2*>(tw), bins, static_cast<float2*>(g), parts,
      n_q, n_theta, n_phi, l_max, radices);
  return cudaGetLastError();
}

template <bool kMirror, class T>
int launch_quadrature(const void* g, const T* pw, void* out, int rows,
                      int n_theta, int l_max, int j_begin, int n_j,
                      cudaStream_t st) {
  const dim3 grid((n_j + kMT - 1) / kMT, rows);
  const size_t smem = (size_t)n_theta * kMT * sizeof(float2);
  cudaError_t err = allow_smem(quadrature_kernel<kMirror, T>, smem);
  if (err != cudaSuccess) return (int)err;
  quadrature_kernel<kMirror, T><<<grid, 256, smem, st>>>(
      static_cast<const float2*>(g), pw, static_cast<float2*>(out), n_theta,
      l_max, j_begin, n_j);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ B12 (K1⁺)
static_assert(kTT == 2 * (kSynThreads / 32),
              "the |ψ|² DFT gives each warp two θ lines of the tile");

// The epilogue of B12's ψ synthesis: writes ψ, keeps |ψ|² of the tile in
// shared memory after fm_s, and in finish() runs the real φ-DFT of that
// tile onto the m ≥ 0 bins (lane ↔ m, warp ↔ two θ lines, E rows L..2L
// staged kKP φ at a time), writing the Fourier columns g[row, θ, m].
struct Abs2Out {
  static constexpr bool kReal = false;
  float2* psi;
  const float* e_re;
  const float* e_im;
  float2* g;            // (rows, θ, L+1)
  int n_theta, n_phi, l_max;
  float* a_s;           // [kTT][n_phi + 1]
  int row, t0;

  static size_t smem(int n_phi, int l_max) {
    return (size_t)kTT * (n_phi + 1) * sizeof(float)
           + (size_t)2 * (l_max + 1) * (kKP + 1) * sizeof(float);
  }

  __device__ void begin(int r) {
    extern __shared__ float2 abs2_dyn[];
    row = r;
    t0 = blockIdx.x * kTT;
    a_s = reinterpret_cast<float*>(abs2_dyn + (2 * l_max + 1) * kTT);
  }

  __device__ void put(size_t o, int th, float re, float im) {
    psi[o] = make_float2(re, im);
    const size_t p = o - ((size_t)row * n_theta + th) * n_phi;
    a_s[(th - t0) * (n_phi + 1) + p] = re * re + im * im;
  }

  __device__ void finish(int, int) {
    const int n_l = l_max + 1, stride = n_phi + 1;
    const int tcount = min(kTT, n_theta - t0);
    float* es_re = a_s + kTT * stride;                  // [n_l][kKP + 1]
    float* es_im = es_re + n_l * (kKP + 1);
    const int t = threadIdx.x, jg = t & 31, tg = t >> 5;
    float ar[kPJ][2], ai[kPJ][2];
#pragma unroll
    for (int i = 0; i < kPJ; ++i) {
      ar[i][0] = ar[i][1] = 0.f;
      ai[i][0] = ai[i][1] = 0.f;
    }
    for (int p0 = 0; p0 < n_phi; p0 += kKP) {
      const int kn = min(kKP, n_phi - p0);
      __syncthreads();
      for (int idx = t; idx < n_l * kKP; idx += blockDim.x) {
        const int m = idx / kKP, k = idx % kKP;
        const bool ok = k < kn;
        const size_t e = (size_t)(l_max + m) * n_phi + p0 + k;
        es_re[m * (kKP + 1) + k] = ok ? e_re[e] : 0.f;
        es_im[m * (kKP + 1) + k] = ok ? e_im[e] : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < kn; ++k) {
        const float x0 = a_s[tg * stride + p0 + k];
        const float x1 = a_s[(tg + kTT / 2) * stride + p0 + k];
#pragma unroll
        for (int i = 0; i < kPJ; ++i) {
          const int m = jg + 32 * i;
          if (m < n_l) {
            const float er = es_re[m * (kKP + 1) + k];
            const float ei = es_im[m * (kKP + 1) + k];
            ar[i][0] = fmaf(x0, er, ar[i][0]);
            ai[i][0] = fmaf(x0, ei, ai[i][0]);
            ar[i][1] = fmaf(x1, er, ar[i][1]);
            ai[i][1] = fmaf(x1, ei, ai[i][1]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPJ; ++i) {
      const int m = jg + 32 * i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tt = tg + h * (kTT / 2);
        if (m < n_l && tt < tcount)
          g[((size_t)row * n_theta + t0 + tt) * n_l + m] =
              make_float2(ar[i][h], ai[i][h]);
      }
    }
  }
};

// ------------------------------------------------------------- B5 (K4)
enum UpdateMethod { kHIO = 0, kER = 1, kRAAR = 2 };
enum UpdateFlags {
  kFtStab = 1 << 0,       // add ρ_in on rows q ≠ 0
  kFixPhase = 1 << 1,     // multiply ρ_p and ρ_in by the anchor scalar
  kSupport = 1 << 2,      // the real constraint's five projections
  kTLow = 1 << 3,
  kTHigh = 1 << 4,
  kLimImag = 1 << 5,
  kAssertReal = 1 << 6,
  kConsSupport = 1 << 7,  // which violations feed the HIO/RAAR region
  kConsThresh = 1 << 8,
  kConsLimImag = 1 << 9,
  kGridWeights = 1 << 10,  // w is the (n_q, n_θ, n_φ) grid, else the plane
  kGated = 1 << 11,        // the ρ_in add scaled by the gate scal[6]
};
// per-restart scalars: β, c_re, c_im, t_low, t_high, limit_imag, and the
// ft-stab gate g that scales the ρ_in add (1: static ft-stab; 0 under a
// linked segment whose gate is shut gives the kernel without kFtStab)
constexpr int kScal = 7;
constexpr int kUpdateSums = 6;  // Σw|ρ_p−ρ_proj|², Σw|ρ_p|², Σwρ² (re, im), Σwρ (re, im)

// The grid form's addressing and the gate, as empty bases where they are
// not used: the plane form without a gate keeps the epilogue, and the
// layout, it had without them.
template <bool kGrid>
struct GridAddress {};
template <>
struct GridAddress<true> {
  int n_phi;
  size_t w_skip;        // the restart's (row − q)·n_θ·n_φ
};
template <bool kGate>
struct GateScalar {};
template <>
struct GateScalar<true> {
  float gate;
};

// The epilogue of the ρ synthesis, applied to each value in registers.
// kGrid (flag kGridWeights): the weights are the (n_q, n_θ, n_φ) grid that
// every restart shares, else the (n_q, n_θ) plane. kGate (flag kGated): the
// ρ_in add is scaled by the gate.
template <bool kGrid, bool kGate>
struct UpdateOut : GridAddress<kGrid>, GateScalar<kGate> {
  static constexpr bool kReal = false;
  const float2* rin;
  const unsigned char* sup;
  const float* w;
  const float* scal;    // (B, kScal)
  float2* out;
  float* parts;         // (rows, θ tiles, kUpdateSums)
  int n_q, n_theta, method, flags;
  const float* wq;      // the plane's row q
  float beta, cr, ci, t_low, t_high, lim_imag;
  bool add_rin;
  float acc[kUpdateSums];

  __device__ void begin(int row) {
    const int q = row % n_q;
    const float* s = scal + (size_t)(row / n_q) * kScal;
    beta = s[0];
    cr = s[1];
    ci = s[2];
    t_low = s[3];
    t_high = s[4];
    lim_imag = s[5];
    if constexpr (kGate) this->gate = s[6];
    add_rin = (flags & kFtStab) && q != 0;
    // a grid weight of the value at o = ((row·n_θ + θ)·n_φ + φ) sits at
    // o less the restart's offset
    if constexpr (kGrid)
      this->w_skip = (size_t)(row - q) * n_theta * this->n_phi;
    else
      wq = w + (size_t)q * n_theta;
#pragma unroll
    for (int k = 0; k < kUpdateSums; ++k) acc[k] = 0.f;
  }

  __device__ void put(size_t o, int th, float rpr, float rpi) {
    float2 x = rin[o];
    if (add_rin) {
      if constexpr (kGate) {  // at g = 1 exactly rpr + x (one rounding)
        rpr = fmaf(x.x, this->gate, rpr);
        rpi = fmaf(x.y, this->gate, rpi);
      } else {
        rpr += x.x;
        rpi += x.y;
      }
    }
    if (flags & kFixPhase) {
      const float a = rpr * cr - rpi * ci, b = rpr * ci + rpi * cr;
      rpr = a;
      rpi = b;
      x = make_float2(x.x * cr - x.y * ci, x.x * ci + x.y * cr);
    }
    float outr = rpr, outi = rpi;
    bool invalid = false;
    if (flags & kSupport) {
      const bool m = sup[o] == 0;
      if (m) outr = outi = 0.f;
      if (flags & kConsSupport) invalid |= m;
    }
    if (flags & kTLow) {
      const bool m = outr < t_low;
      if (m) outr = t_low;
      if (flags & kConsThresh) invalid |= m;
    }
    if (flags & kTHigh) {
      const bool m = outr > t_high;
      if (m) outr = t_high;
      if (flags & kConsThresh) invalid |= m;
    }
    if (flags & kLimImag) {
      const bool m = fabsf(outi) >= lim_imag;
      if (m) outi = 0.f;
      if (flags & kConsLimImag) invalid |= m;
    }
    if (flags & kAssertReal) outi = 0.f;
    float wv;
    if constexpr (kGrid)
      wv = w[o - this->w_skip];
    else
      wv = wq[th];
    const float dr = rpr - outr, di = rpi - outi;
    acc[0] += wv * (dr * dr + di * di);
    acc[1] += wv * (rpr * rpr + rpi * rpi);
    float nr = outr, ni = outi;
    if (invalid && method == kHIO) {
      nr = x.x - beta * dr;
      ni = x.y - beta * di;
    } else if (invalid && method == kRAAR) {
      nr = beta * x.x + (1.f - 2.f * beta) * rpr;
      ni = beta * x.y + (1.f - 2.f * beta) * rpi;
    }
    out[o] = make_float2(nr, ni);
    acc[2] += wv * (nr * nr - ni * ni);
    acc[3] += wv * (2.f * nr * ni);
    acc[4] += wv * nr;
    acc[5] += wv * ni;
  }

  __device__ void finish(int row, int tile) {
    block_sum(acc);
    if (threadIdx.x == 0) {
      float* pr = parts + ((size_t)row * gridDim.x + tile) * kUpdateSums;
#pragma unroll
      for (int k = 0; k < kUpdateSums; ++k) pr[k] = acc[k];
    }
  }
};

// ------------------------------------------------------- entry points
// Each C entry point below runs one of these with T = float (float32
// tables) and, named with _bf16 at the end, with T = bf16 (bf16 Legendre
// tables PW and Pt; the Hankel weights and the E and I tables stay
// float32).

// radices ≠ 0: the synthesis's FFT route (tw, the scratch fm of (rows,
// 2L+1, n_θ) values, θ tiles of `lines` lines by the line rule); 0: the
// dense route (I tables, kTT-line tiles).
template <class T>
int hankel_synthesize(const void* c, const void* wf, const void* pt_,
                      const float* i_re, const float* i_im, const void* tw,
                      void* fm, void* psi, void* cf, int batch, int n_q,
                      int n_theta, int n_phi, int l_max, int radices,
                      int lines, void* stream) {
  if (batch < 1 || batch > 65535 || n_q < 1 || n_q > 65535 || l_max < 0)
    return (int)cudaErrorInvalidValue;
  const T* pt = static_cast<const T*>(pt_);
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = launch_hankel_gemm(c, wf, cf, batch, n_q, l_max, st);
  if (err != 0) return err;
  const ComplexOut out{static_cast<float2*>(psi)};
  if (radices != 0)
    return launch_synthesis_fft<ComplexOut, T>(cf, pt, tw, fm, out,
                                               batch * n_q, n_theta, n_phi,
                                               l_max, radices, lines, st);
  return launch_synthesis<ComplexOut, T>(cf, pt, i_re, i_im, out,
                                         batch * n_q, n_theta, n_phi, l_max,
                                         st);
}

// radices ≠ 0: the FFT route (tw, bins and θ tiles of `lines` lines by the
// line rule); 0: the dense route (E tables, kTT-line tiles, 2L+1 ≤ 32·kPJ).
// parts holds one pair of sums per (row, θ tile) of the route.
template <class T>
int inverse_real_project_fwd(const void* c, const void* pt_,
                             const float* i_re, const float* i_im,
                             const void* psi, const float* w,
                             const float* e_re, const float* e_im,
                             const void* pw_, const void* tw,
                             const int* bins, void* g, void* c_out,
                             float* parts, int rows, int n_q, int n_theta,
                             int n_phi, int l_max, int radices, int lines,
                             void* stream) {
  if (rows < 1 || rows > kMaxRows || n_q < 1 || n_theta < 1 || n_phi < 1 ||
      l_max < 0 || 2 * l_max + 1 > n_phi ||
      (radices == 0 && 2 * l_max + 1 > 32 * kPJ) ||
      (radices != 0 && (tw == nullptr || bins == nullptr)))
    return (int)cudaErrorInvalidValue;
  const T* pt = static_cast<const T*>(pt_);
  const T* pw = static_cast<const T*>(pw_);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (radices != 0) {
    if (!fft_code_valid(radices, n_phi)) return (int)cudaErrorInvalidValue;
    err = check_fft_lines(lines, 8, 2, n_phi, project_fft_line_bytes(l_max));
    if (err != cudaSuccess) return (int)err;
    const auto launch = lines == 8   ? launch_project_fft<8, T>
                        : lines == 4 ? launch_project_fft<4, T>
                                     : launch_project_fft<2, T>;
    err = launch(c, pt, psi, w, tw, bins, g, parts, rows, n_q, n_theta, n_phi,
                 l_max, radices, st);
    if (err != cudaSuccess) return (int)err;
  } else {
    const dim3 grid_a((n_theta + kTT - 1) / kTT, rows);
    const size_t smem_a = project_smem(n_phi, l_max);
    err = allow_smem(project_dft_kernel<true, T>, smem_a);
    if (err != cudaSuccess) return (int)err;
    project_dft_kernel<true, T><<<grid_a, kPThreads, smem_a, st>>>(
        static_cast<const float2*>(c), pt, i_re, i_im,
        static_cast<const float2*>(psi), w, e_re, e_im,
        static_cast<float2*>(g), nullptr, parts, n_q, n_theta, n_phi, l_max);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_quadrature<false, T>(g, pw, c_out, rows, n_theta, l_max, 0,
                                     2 * l_max + 1, st);
}

// radices ≠ 0: the FFT route (tw, the scratch fm of (rows, L+1, n_θ)
// values, θ tiles of 2·`lines` lines by the line rule); 0: the dense route
// (I tables, kTT-line tiles). parts holds one pair of sums per (row, θ
// tile) of the route.
template <class T>
int inverse_real_project(const void* c, const void* pt_, const float* i_re,
                         const float* i_im, const void* psi, const float* w,
                         const void* tw, void* fm, void* psi_p, float* parts,
                         int rows, int n_q, int n_theta, int n_phi, int l_max,
                         int radices, int lines, void* stream) {
  if (rows < 1 || rows > kMaxRows || n_q < 1 || n_theta < 1 || n_phi < 1 ||
      l_max < 0)
    return (int)cudaErrorInvalidValue;
  const T* pt = static_cast<const T*>(pt_);
  const cudaStream_t st = (cudaStream_t)stream;
  if (radices != 0) {
    ProjectOut out{};
    out.psi = static_cast<const float2*>(psi);
    out.w = w;
    out.psi_p = static_cast<float2*>(psi_p);
    out.parts = parts;
    out.n_q = n_q;
    out.n_theta = n_theta;
    return launch_synthesis_fft<ProjectOut, T>(c, pt, tw, fm, out, rows,
                                               n_theta, n_phi, l_max, radices,
                                               lines, st);
  }
  const dim3 grid((n_theta + kTT - 1) / kTT, rows);
  const size_t smem = (size_t)(l_max + 1) * kTT * sizeof(float2);
  cudaError_t err = allow_smem(project_dft_kernel<false, T>, smem);
  if (err != cudaSuccess) return (int)err;
  project_dft_kernel<false, T><<<grid, kPThreads, smem, st>>>(
      static_cast<const float2*>(c), pt, i_re, i_im,
      static_cast<const float2*>(psi), w, nullptr, nullptr, nullptr,
      static_cast<float2*>(psi_p), parts, n_q, n_theta, n_phi, l_max);
  return (int)cudaGetLastError();
}

// radices ≠ 0: the FFT route (tw, the scratch fm of (rows, 2L+1, n_θ)
// values, the scratch g of (rows, L+1, n_θ) |ψ|² columns, θ tiles of
// `lines` lines by the line rule; no cap on L); 0: the dense route (I and
// E tables, g of (rows, n_θ, L+1), L + 1 ≤ 32·kPJ).
template <class T>
int synthesize_abs2(const void* cf, const void* pt_, const float* i_re,
                    const float* i_im, const float* e_re, const float* e_im,
                    const void* pw_, const void* tw, void* fm, void* psi,
                    void* g, void* c_out, int rows, int n_theta, int n_phi,
                    int l_max, int radices, int lines, void* stream) {
  if (rows < 1 || rows > kMaxRows || n_theta < 1 || n_phi < 1 ||
      l_max < 0 || (radices == 0 && l_max + 1 > 32 * kPJ))
    return (int)cudaErrorInvalidValue;
  const T* pt = static_cast<const T*>(pt_);
  const T* pw = static_cast<const T*>(pw_);
  const cudaStream_t st = (cudaStream_t)stream;
  if (radices != 0) {
    const Abs2FftOut out{{static_cast<float2*>(psi)},
                         static_cast<float2*>(g)};
    const int err = launch_synthesis_fft<Abs2FftOut, T>(
        cf, pt, tw, fm, out, rows, n_theta, n_phi, l_max, radices, lines, st);
    if (err != 0) return err;
    return launch_quadrature_gemm<kSynthAbs2In, T>(g, pw, c_out, rows,
                                                   n_theta, l_max, st);
  }
  Abs2Out out{};
  out.psi = static_cast<float2*>(psi);
  out.e_re = e_re;
  out.e_im = e_im;
  out.g = static_cast<float2*>(g);
  out.n_theta = n_theta;
  out.n_phi = n_phi;
  out.l_max = l_max;
  const int err = launch_synthesis<Abs2Out, T>(cf, pt, i_re, i_im, out, rows,
                                               n_theta, n_phi, l_max, st,
                                               Abs2Out::smem(n_phi, l_max));
  if (err != 0) return err;
  return launch_quadrature<true, T>(g, pw, c_out, rows, n_theta, l_max, l_max,
                                    l_max + 1, st);
}

template <bool kGrid, bool kGate, class T>
int launch_update(const void* d, const T* pt, const float* i_re,
                  const float* i_im, const void* tw, void* fm,
                  const void* rho_in, const void* support, const float* w,
                  const float* scal, void* rho_new, float* parts, int rows,
                  int n_q, int n_theta, int n_phi, int l_max, int method,
                  int flags, int radices, int lines, void* stream) {
  UpdateOut<kGrid, kGate> out{};
  out.rin = static_cast<const float2*>(rho_in);
  out.sup = static_cast<const unsigned char*>(support);
  out.w = w;
  out.scal = scal;
  out.out = static_cast<float2*>(rho_new);
  out.parts = parts;
  out.n_q = n_q;
  out.n_theta = n_theta;
  if constexpr (kGrid) out.n_phi = n_phi;
  out.method = method;
  out.flags = flags;
  if (radices != 0)
    return launch_synthesis_fft<UpdateOut<kGrid, kGate>, T>(
        d, pt, tw, fm, out, rows, n_theta, n_phi, l_max, radices, lines,
        (cudaStream_t)stream);
  return launch_synthesis<UpdateOut<kGrid, kGate>, T>(
      d, pt, i_re, i_im, out, rows, n_theta, n_phi, l_max,
      (cudaStream_t)stream);
}

// radices, lines, tw and fm as for hankel_synthesize; parts holds
// kUpdateSums per (row, θ tile) of the route; flags & kGridWeights takes
// w as the shared (n_q, n_θ, n_φ) grid, flags & kGated scales the ft-stab
// add by scal[6].
template <class T>
int synthesize_update(const void* d, const void* pt, const float* i_re,
                      const float* i_im, const void* tw, void* fm,
                      const void* rho_in, const void* support, const float* w,
                      const float* scal, void* rho_new, float* parts,
                      int rows, int n_q, int n_theta, int n_phi, int l_max,
                      int method, int flags, int radices, int lines,
                      void* stream) {
  if (n_q < 1 || rows % n_q || method < kHIO || method > kRAAR)
    return (int)cudaErrorInvalidValue;
  const bool grid = flags & kGridWeights, gated = flags & kGated;
  const auto launch = grid ? (gated ? launch_update<true, true, T>
                                    : launch_update<true, false, T>)
                           : (gated ? launch_update<false, true, T>
                                    : launch_update<false, false, T>);
  return launch(d, static_cast<const T*>(pt), i_re, i_im, tw, fm, rho_in,
                support, w, scal, rho_new, parts, rows, n_q, n_theta, n_phi,
                l_max, method, flags, radices, lines, stream);
}

}  // namespace

extern "C" {

int xf_hankel_synthesize(const void* c, const void* wf, const void* pt,
                         const float* i_re, const float* i_im, const void* tw,
                         void* fm, void* psi, void* cf, int batch, int n_q,
                         int n_theta, int n_phi, int l_max, int radices,
                         int lines, void* stream) {
  return hankel_synthesize<float>(c, wf, pt, i_re, i_im, tw, fm, psi, cf,
                                  batch, n_q, n_theta, n_phi, l_max, radices,
                                  lines, stream);
}
int xf_hankel_synthesize_bf16(const void* c, const void* wf, const void* pt,
                              const float* i_re, const float* i_im,
                              const void* tw, void* fm, void* psi, void* cf,
                              int batch, int n_q, int n_theta, int n_phi,
                              int l_max, int radices, int lines,
                              void* stream) {
  return hankel_synthesize<bf16>(c, wf, pt, i_re, i_im, tw, fm, psi, cf,
                                 batch, n_q, n_theta, n_phi, l_max, radices,
                                 lines, stream);
}

int xf_inverse_real_project_fwd(const void* c, const void* pt,
                                const float* i_re, const float* i_im,
                                const void* psi, const float* w,
                                const float* e_re, const float* e_im,
                                const void* pw, const void* tw,
                                const int* bins, void* g, void* c_out,
                                float* parts, int rows, int n_q, int n_theta,
                                int n_phi, int l_max, int radices, int lines,
                                void* stream) {
  return inverse_real_project_fwd<float>(
      c, pt, i_re, i_im, psi, w, e_re, e_im, pw, tw, bins, g, c_out, parts,
      rows, n_q, n_theta, n_phi, l_max, radices, lines, stream);
}
int xf_inverse_real_project_fwd_bf16(const void* c, const void* pt,
                                     const float* i_re, const float* i_im,
                                     const void* psi, const float* w,
                                     const float* e_re, const float* e_im,
                                     const void* pw, const void* tw,
                                     const int* bins, void* g, void* c_out,
                                     float* parts, int rows, int n_q,
                                     int n_theta, int n_phi, int l_max,
                                     int radices, int lines, void* stream) {
  return inverse_real_project_fwd<bf16>(
      c, pt, i_re, i_im, psi, w, e_re, e_im, pw, tw, bins, g, c_out, parts,
      rows, n_q, n_theta, n_phi, l_max, radices, lines, stream);
}

int xf_inverse_real_project(const void* c, const void* pt, const float* i_re,
                            const float* i_im, const void* psi, const float* w,
                            const void* tw, void* fm, void* psi_p,
                            float* parts, int rows, int n_q, int n_theta,
                            int n_phi, int l_max, int radices, int lines,
                            void* stream) {
  return inverse_real_project<float>(c, pt, i_re, i_im, psi, w, tw, fm, psi_p,
                                     parts, rows, n_q, n_theta, n_phi, l_max,
                                     radices, lines, stream);
}
int xf_inverse_real_project_bf16(const void* c, const void* pt,
                                 const float* i_re, const float* i_im,
                                 const void* psi, const float* w,
                                 const void* tw, void* fm, void* psi_p,
                                 float* parts, int rows, int n_q, int n_theta,
                                 int n_phi, int l_max, int radices, int lines,
                                 void* stream) {
  return inverse_real_project<bf16>(c, pt, i_re, i_im, psi, w, tw, fm, psi_p,
                                    parts, rows, n_q, n_theta, n_phi, l_max,
                                    radices, lines, stream);
}

int xf_synthesize_abs2(const void* cf, const void* pt, const float* i_re,
                       const float* i_im, const float* e_re,
                       const float* e_im, const void* pw, const void* tw,
                       void* fm, void* psi, void* g, void* c_out, int rows,
                       int n_theta, int n_phi, int l_max, int radices,
                       int lines, void* stream) {
  return synthesize_abs2<float>(cf, pt, i_re, i_im, e_re, e_im, pw, tw, fm,
                                psi, g, c_out, rows, n_theta, n_phi, l_max,
                                radices, lines, stream);
}
int xf_synthesize_abs2_bf16(const void* cf, const void* pt, const float* i_re,
                            const float* i_im, const float* e_re,
                            const float* e_im, const void* pw, const void* tw,
                            void* fm, void* psi, void* g, void* c_out,
                            int rows, int n_theta, int n_phi, int l_max,
                            int radices, int lines, void* stream) {
  return synthesize_abs2<bf16>(cf, pt, i_re, i_im, e_re, e_im, pw, tw, fm,
                               psi, g, c_out, rows, n_theta, n_phi, l_max,
                               radices, lines, stream);
}

int xf_synthesize_update(const void* d, const void* pt, const float* i_re,
                         const float* i_im, const void* tw, void* fm,
                         const void* rho_in, const void* support,
                         const float* w, const float* scal, void* rho_new,
                         float* parts, int rows, int n_q, int n_theta,
                         int n_phi, int l_max, int method, int flags,
                         int radices, int lines, void* stream) {
  return synthesize_update<float>(d, pt, i_re, i_im, tw, fm, rho_in, support,
                                  w, scal, rho_new, parts, rows, n_q, n_theta,
                                  n_phi, l_max, method, flags, radices, lines,
                                  stream);
}
int xf_synthesize_update_bf16(const void* d, const void* pt,
                              const float* i_re, const float* i_im,
                              const void* tw, void* fm, const void* rho_in,
                              const void* support, const float* w,
                              const float* scal, void* rho_new, float* parts,
                              int rows, int n_q, int n_theta, int n_phi,
                              int l_max, int method, int flags, int radices,
                              int lines, void* stream) {
  return synthesize_update<bf16>(d, pt, i_re, i_im, tw, fm, rho_in, support,
                                 w, scal, rho_new, parts, rows, n_q, n_theta,
                                 n_phi, l_max, method, flags, radices, lines,
                                 stream);
}

}  // extern "C"
