// Newton–Schulz polar factor and the fused data projection for Hopper
// (sm_90a).
//
// Three C entry points, bound with ctypes by
// xframe_tpu_torch/ops/fused_projection.py (plain versions beside them
// there):
//
//   xf_polar_unitary     W = polar(M) for a batch of complex c×c matrices
//                        replaces xframe_tpu/ops/pallas_kernels.py:88 _polar_kernel
//                        (core _ns_polar_planes, :45)
//   xf_fused_projection  per order l of a bucket: B = PD_l·I_l, M = B + rms·eyeᶜ,
//                        W = polar(M), out = take·(V_l·W) + (1−take)·I_l
//                        replaces xframe_tpu/ops/pallas_kernels.py:119 _project_kernel (K5)
//   xf_max_active_clusters
//                        how many clusters of a given shape of either kernel
//                        the card holds at once (cudaOccupancyMaxActiveClusters),
//                        for the wrapper's choice of cluster shape
//
// Both kernels run the Newton–Schulz iteration: normalise by
// √(max row sum · max column sum of |X|) + 1e-12, then per step of the
// schedule X ← a·X + X·(b·A + c·A²) with A = X†X; a step with c = 0 skips A²
// (the fixed iteration's four cubic polishing steps are (1.5, −0.5, 0)). The
// schedule's rows reach the kernels as a small float table in device memory.
// All sums are FP32 FMAs on CUDA cores: no TF32, since the polar is pinned
// at float32 and its rounding floor is already ≈1e-5.
//
// What bounds B8. Per quintic step A = X†X and A² are Hermitian (the
// schedule's coefficients are real), so a kernel needs half of each plus
// the full X·(bA + cA²): 2c³ complex multiply-adds of 8 FLOP. Over the
// production projection (N_q = 256, L = 127, 1 restart; buckets of 64
// orders at c = 127, 63 at c = 253 and the full-width order at c = 255; 14
// minimax steps) with B = PD·I and V·W that is 282.6 GFLOP against a few MB
// of inputs: 4.22 ms at 67 TFLOP/s, FP32 instruction throughput is the
// bound (chip_smoke.py ns_work). B7 over the same buckets does the same
// steps without B and V·W: 261.6 GFLOP, 3.90 ms.
//
// What the design does about it. One (restart, order) matrix is owned by a
// thread-block cluster of S blocks (1–16), each block holding G product
// groups of 256 threads (1 or 2; two groups share one block's SM and run
// different tiles, each behind its own named barrier). The wrapper chooses
// (S, G) per bucket from the matrix count, c and the clusters the card
// holds at once, so that small buckets and the lone full-width order still
// spread over many SMs in one wave: at the production projection 2 blocks
// of 2 groups per matrix at c = 127 and c = 253, 16 blocks of 1 for the
// full-width order. The cluster's S·G workers split the 64×64 output tiles
// of every product (PD·I, X†X, A², X·Bm, V·W), tile t going to worker
// t mod S·G, and meet at a cluster barrier between products. The two
// Hermitian products form only the tiles on and above the diagonal, from a
// tile list the wrapper builds, and write each value twice: as it is, and
// conjugate-transposed, staged through shared memory so that the transposed
// write stays coalesced; A and Bm are then exactly Hermitian. X, A, A² and
// the next X live in a device scratch of four c×c slots per matrix (one c×c
// complex matrix is 512 KB at c = 253, over a block's shared memory); the
// clusters of a bucket are numbered so that the resident ones' matrices are
// contiguous there. Scratch writes are made visible to the cluster by
// __threadfence() before each barrier and read through L2 (ld.global.cg).
// The rms of B and the normalisation's row and column maxima are cluster
// reductions: each block leaves its partial in its shared memory, and after
// the barrier every block reads the S partials through distributed shared
// memory in rank order, so two runs agree bitwise. The product core is a
// register-tiled complex FMA (64×64 tile, 16 deep, 4×4 micro-tile per
// thread) whose next k-chunk is loaded into registers while the current
// one is multiplied (two shared buffers). Tensor cores (3xTF32) are later
// work.
//
// B7 runs the same polar on the same clusters, the wrapper choosing (S, G)
// from B7's own resident clusters: the normalisation (cluster_normalize)
// reads M from its input where B8 reads it from PD·I, both run the steps
// through one function (cluster_ns_steps), and B7's ranks copy their share
// of the polar factor out.
//
// Every launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() so that the Python wrapper raises on a refused launch.

#include <cooperative_groups.h>

#include "sht.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kNsThreads = 256;         // 16 × 16 threads
constexpr int kGM = 64, kGN = 64;       // output tile of a product
constexpr int kGK = 16;                 // depth of a staged chunk
constexpr int kRM = kGM / 16, kRN = kGN / 16;  // register micro-tile
constexpr int kLoads = kGM * kGK / kNsThreads;  // chunk values per thread
constexpr int kSlots = 4;               // c×c scratch matrices per matrix
constexpr int kMaxCluster = 16;
static_assert(kGM == kGN, "Hermitian products mirror square tiles");
static_assert(kGM * kGK == kGN * kGK && kLoads * kNsThreads == kGM * kGK,
              "every thread loads the same number of chunk values");

// A complex matrix operand: element (r, k) at p[r·rs + k·cs], conjugated
// when conj is set (X† is {X, 1, c, true}). Scratch operands are written
// earlier in the same kernel, by this block or another of its cluster, so
// every operand is read through L2 (__ldcg), never the per-SM L1.
struct CMat {
  const float2* p;
  int rs, cs;
  bool conj;
};

__device__ __forceinline__ float2 conjf2(float2 v) {
  return make_float2(v.x, -v.y);
}

// out = alpha·d + beta·value (d may be null).
struct AxpbyEpi {
  float2* out;
  int ld;
  const float2* d;
  float alpha, beta;
  __device__ void operator()(int r, int n, float2 v) {
    const size_t o = (size_t)r * ld + n;
    float2 y = make_float2(beta * v.x, beta * v.y);
    if (d) {
      const float2 x = __ldcg(d + o);
      y.x = fmaf(alpha, x.x, y.x);
      y.y = fmaf(alpha, x.y, y.y);
    }
    out[o] = y;
  }
};

// out = value, and the thread's Σ|value|² in acc.
struct SumSqEpi {
  float2* out;
  int ld;
  float acc;
  __device__ void operator()(int r, int n, float2 v) {
    out[(size_t)r * ld + n] = v;
    acc = fmaf(v.x, v.x, fmaf(v.y, v.y, acc));
  }
};

// out = take_r·value + (1 − take_r)·keep, row r of an (n_q × c) block.
struct TakeEpi {
  float2* out;
  const float2* keep;
  const float* take;
  int ld;
  __device__ void operator()(int r, int n, float2 v) {
    const size_t o = (size_t)r * ld + n;
    const float t = take[r];
    const float2 k = keep[o];
    out[o] = make_float2(t * v.x + (1.f - t) * k.x, t * v.y + (1.f - t) * k.y);
  }
};

// Chunk k0 of the tile's operands into registers: the kGM×kGK slice of a
// and the kGK×kGN slice of b, neighbouring threads on neighbouring
// addresses where a stride is 1.
__device__ __forceinline__ void load_chunk(int t, const CMat& a,
                                           const CMat& b, int m0, int n0,
                                           int k0, int M, int N, int K,
                                           float2 (&ra)[kLoads],
                                           float2 (&rb)[kLoads]) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int s = t + i * kNsThreads;
    const int r = a.rs == 1 ? s % kGM : s / kGK;
    const int k = a.rs == 1 ? s / kGM : s % kGK;
    float2 x = make_float2(0.f, 0.f);
    if (m0 + r < M && k0 + k < K) {
      x = __ldcg(a.p + (size_t)(m0 + r) * a.rs + (size_t)(k0 + k) * a.cs);
      if (a.conj) x.y = -x.y;
    }
    ra[i] = x;
  }
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int s = t + i * kNsThreads;
    const int n = b.cs == 1 ? s % kGN : s / kGK;
    const int k = b.cs == 1 ? s / kGN : s % kGK;
    float2 x = make_float2(0.f, 0.f);
    if (k0 + k < K && n0 + n < N) {
      x = __ldcg(b.p + (size_t)(k0 + k) * b.rs + (size_t)(n0 + n) * b.cs);
      if (b.conj) x.y = -x.y;
    }
    rb[i] = x;
  }
}

// The staging buffers of one product group. They live outside gemm_tile:
// a __shared__ variable inside the template would be a separate allocation
// for every instantiation (epilogue type, Hermitian or not).
struct GemmSmem {
  float2 as[2][kGK][kGM + 1];   // padded against bank conflicts
  float2 bs[2][kGK][kGN + 1];
};

// A group of kNsThreads threads that forms output tiles together: its
// staging buffers, the thread's index in the group and its barrier (0: the
// whole block, as __syncthreads(); else a named barrier of the group's
// threads, so that two groups of one block run different tiles).
struct Group {
  GemmSmem* sm;
  int t;
  int bar;
  __device__ __forceinline__ void sync() const {
    if (bar == 0)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(kNsThreads) : "memory");
  }
};

// The output tile (m0, n0) of op(a)·b (M×N, K deep), handed to epi. With
// kHerm, a tile on or above the diagonal of a Hermitian product: elements
// n ≥ r go to epi(r, n, v), and every n > r also to epi(n, r, conj v),
// staged through shared memory so that the transposed writes stay
// coalesced. Every thread of the group calls it; the caller synchronises
// (block or cluster) before reading what epi wrote.
template <bool kHerm, class Epi>
__device__ void gemm_tile(const Group& grp, int m0, int n0, int M, int N,
                          int K, const CMat& a, const CMat& b, Epi& epi) {
  auto& as = grp.sm->as;
  auto& bs = grp.sm->bs;
  const int t = grp.t, tx = t % 16, ty = t / 16;
  float2 acc[kRM][kRN];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = make_float2(0.f, 0.f);

  float2 ra[kLoads], rb[kLoads];
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int s = t + i * kNsThreads;
      if (a.rs == 1)
        as[buf][s / kGM][s % kGM] = ra[i];
      else
        as[buf][s % kGK][s / kGK] = ra[i];
      if (b.cs == 1)
        bs[buf][s / kGN][s % kGN] = rb[i];
      else
        bs[buf][s % kGK][s / kGK] = rb[i];
    }
  };
  const int n_chunks = (K + kGK - 1) / kGK;
  load_chunk(t, a, b, m0, n0, 0, M, N, K, ra, rb);
  stage(0);
  grp.sync();
  for (int kc = 0; kc < n_chunks; ++kc) {
    const int buf = kc & 1;
    const bool more = kc + 1 < n_chunks;
    if (more) load_chunk(t, a, b, m0, n0, (kc + 1) * kGK, M, N, K, ra, rb);
#pragma unroll
    for (int k = 0; k < kGK; ++k) {
      float2 av[kRM], bv[kRN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) av[i] = as[buf][k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kRN; ++j) bv[j] = bs[buf][k][tx + 16 * j];
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
    if (more) stage(buf ^ 1);
    grp.sync();
  }
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int r = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (r < M && n < N && (!kHerm || n >= r)) epi(r, n, acc[i][j]);
    }
  if constexpr (kHerm) {
    // 16 rows of the tile at a time through as[0] ([kGK][kGM + 1]): the
    // mirror of row r is column r, written along r
    float2(*st)[kGM + 1] = as[0];
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
#pragma unroll
      for (int j = 0; j < kRN; ++j) st[ty][tx + 16 * j] = acc[i][j];
      grp.sync();
      for (int e = t; e < 16 * kGN; e += kNsThreads) {
        const int rr = e % 16, nn = e / 16;
        const int r = m0 + 16 * i + rr, n = n0 + nn;
        if (r < M && n < N && n > r) epi(n, r, conjf2(st[rr][nn]));
      }
      grp.sync();
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

// ------------------------------------------------------- B7 and B8 core
// A cluster of S blocks of kGroups product groups each has W = S·kGroups
// workers; worker w = rank·kGroups + group.
struct Worker {
  Group grp;
  int w, n;
};

// This worker's share of a cluster's product: output tiles w, w + W, … of
// the M×N product in row-major tile order.
template <class Epi>
__device__ void cluster_gemm(const Worker& wk, int M, int N, int K,
                             const CMat& a, const CMat& b, Epi& epi) {
  const int tn = (N + kGN - 1) / kGN, tiles = tn * ((M + kGM - 1) / kGM);
  for (int t = wk.w; t < tiles; t += wk.n)
    gemm_tile<false>(wk.grp, (t / tn) * kGM, (t % tn) * kGN, M, N, K, a, b,
                     epi);
}

// The same for a Hermitian c×c product: entries w, w + W, … of the
// wrapper's list of (row, column) tiles on and above the diagonal.
template <class Epi>
__device__ void cluster_herm(const Worker& wk, const int2* herm, int n_herm,
                             int c, const CMat& a, const CMat& b, Epi epi) {
  for (int t = wk.w; t < n_herm; t += wk.n) {
    const int2 ij = herm[t];
    gemm_tile<true>(wk.grp, ij.x * kGM, ij.y * kGN, c, c, c, a, b, epi);
  }
}

// Scratch writes of every block visible to the cluster, then its barrier
// (barrier.cluster arrive.release / wait.acquire).
__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cl) {
  __threadfence();
  cl.sync();
}

// Σ over the cluster's ranks, in rank order, of each block's *v.
__device__ float cluster_sum(cg::cluster_group& cl, float* v) {
  float s = 0.f;
  for (int j = 0; j < (int)cl.num_blocks(); ++j) s += *cl.map_shared_rank(v, j);
  return s;
}

__device__ float cluster_max(cg::cluster_group& cl, float* v) {
  float s = 0.f;
  for (int j = 0; j < (int)cl.num_blocks(); ++j)
    s = fmaxf(s, *cl.map_shared_rank(v, j));
  return s;
}

// This thread's worker of a cluster kernel of kGroups product groups per
// block, the groups' staging buffers in dynamic shared memory.
template <int kGroups>
__device__ Worker cluster_worker(cg::cluster_group& cl, float4* dyn) {
  const int group = (int)threadIdx.x / kNsThreads;
  return Worker{Group{reinterpret_cast<GemmSmem*>(dyn) + group,
                      (int)threadIdx.x % kNsThreads,
                      kGroups == 1 ? 0 : 1 + group},
                (int)cl.block_rank() * kGroups + group,
                (int)cl.num_blocks() * kGroups};
}

// [begin, end) of this block's share of n elements: S contiguous shares in
// rank order.
__device__ __forceinline__ void rank_share(cg::cluster_group& cl, size_t n,
                                           size_t& begin, size_t& end) {
  const size_t share = (n + cl.num_blocks() - 1) / cl.num_blocks();
  begin = cl.block_rank() * share;
  end = begin + share < n ? begin + share : n;
}

// X = M / (√(max row sum · max column sum of |M|) + 1e-12) for the c×c M
// whose (i, j) is m_at(i, j), over the cluster: one warp per (row, column)
// i, the maxima over the block, then over the cluster in rank order
// through part_s (two floats of each block's shared memory); each block
// writes its share of X; ends at a cluster barrier.
template <class MAt>
__device__ void cluster_normalize(cg::cluster_group& cl, MAt m_at, float2* X,
                                  int c, float* part_s) {
  const int S = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int warps = (int)blockDim.x / 32;
  float rmax = 0.f, cmax = 0.f;
  for (int i = rank * warps + warp; i < c; i += S * warps) {
    float sr = 0.f, sc = 0.f;
    for (int j = lane; j < c; j += 32) {
      const float2 a = m_at(i, j), b = m_at(j, i);
      sr += sqrtf(a.x * a.x + a.y * a.y);
      sc += sqrtf(b.x * b.x + b.y * b.y);
    }
    for (int off = 16; off > 0; off >>= 1) {
      sr += __shfl_xor_sync(0xffffffffu, sr, off);
      sc += __shfl_xor_sync(0xffffffffu, sc, off);
    }
    rmax = fmaxf(rmax, sr);
    cmax = fmaxf(cmax, sc);
  }
  rmax = block_max(rmax);
  cmax = block_max(cmax);
  if (t == 0) {
    part_s[0] = rmax;
    part_s[1] = cmax;
  }
  cluster_barrier(cl);
  const float norm =
      sqrtf(cluster_max(cl, &part_s[0]) * cluster_max(cl, &part_s[1]))
      + 1e-12f;
  size_t begin, end;
  rank_share(cl, (size_t)c * c, begin, end);
  for (size_t idx = begin + t; idx < end; idx += blockDim.x) {
    const float2 a = m_at((int)(idx / c), (int)(idx % c));
    X[idx] = make_float2(a.x / norm, a.y / norm);
  }
  cluster_barrier(cl);
}

// The schedule's Newton–Schulz steps on the normalised X in slot 0 of buf
// (kSlots c×c matrices), over the cluster's workers: per step the
// Hermitian A = X†X and, where c ≠ 0, A² on the upper tiles of the
// wrapper's list, then X·(bA + cA²) + aX in full, a cluster barrier after
// each product. → the slot that holds the polar factor.
__device__ const float2* cluster_ns_steps(cg::cluster_group& cl,
                                          const Worker& wk, float2* buf,
                                          int c, const float* sched,
                                          int n_steps, const int2* herm,
                                          int n_herm) {
  const size_t cc = (size_t)c * c;
  float2 *X = buf, *A = buf + cc, *Bm = buf + 2 * cc, *Y = buf + 3 * cc;
  for (int st = 0; st < n_steps; ++st) {
    const float ca = sched[3 * st], cb = sched[3 * st + 1],
                cq = sched[3 * st + 2];
    const CMat xh{X, 1, c, true}, x{X, c, 1, false};
    if (cq != 0.f) {
      cluster_herm(wk, herm, n_herm, c, xh, x,
                   AxpbyEpi{A, c, nullptr, 0.f, 1.f});
      cluster_barrier(cl);
      const CMat a{A, c, 1, false};
      cluster_herm(wk, herm, n_herm, c, a, a, AxpbyEpi{Bm, c, A, cb, cq});
    } else {
      cluster_herm(wk, herm, n_herm, c, xh, x,
                   AxpbyEpi{Bm, c, nullptr, 0.f, cb});
    }
    cluster_barrier(cl);
    AxpbyEpi ey{Y, c, X, ca, 1.f};
    cluster_gemm(wk, c, c, c, x, CMat{Bm, c, 1, false}, ey);
    cluster_barrier(cl);
    float2* tmp = X;
    X = Y;
    Y = tmp;
  }
  return X;
}

// ---------------------------------------------------------------- B7
// One cluster per matrix mat = blockIdx.x / S of m (n_mat, c, c); W into w,
// the same layout; herm (n_herm) tiles on and above the diagonal.
template <int kGroups>
__global__ void __launch_bounds__(kNsThreads * kGroups, 2 / kGroups)
polar_kernel(const float2* m, float2* w, float2* scratch, const float* sched,
             const int2* herm, int n_herm, int n_steps, int c) {
  extern __shared__ float4 b7_dyn[];
  __shared__ float part_s[2];   // max row sum, max column sum
  cg::cluster_group cl = cg::this_cluster();
  const Worker wk = cluster_worker<kGroups>(cl, b7_dyn);
  const size_t cc = (size_t)c * c, mat = blockIdx.x / cl.num_blocks();
  const float2* mm = m + mat * cc;
  float2* buf = scratch + mat * kSlots * cc;
  cluster_normalize(
      cl, [&](int i, int j) { return __ldg(mm + (size_t)i * c + j); }, buf, c,
      part_s);
  const float2* X =
      cluster_ns_steps(cl, wk, buf, c, sched, n_steps, herm, n_herm);
  size_t begin, end;
  rank_share(cl, cc, begin, end);
  for (size_t idx = begin + threadIdx.x; idx < end; idx += blockDim.x)
    w[mat * cc + idx] = __ldcg(X + idx);
}

// ---------------------------------------------------------------- B8
// One cluster per (restart b, order g of the bucket), matrix mat = b·n_g + g
// = blockIdx.x / S; kGroups product groups per block, each with its staging
// buffers in dynamic shared memory. pd (n_g, c, n_q); it, v and out (batch,
// n_g, n_q, c) and (n_g, n_q, c); take (n_g, n_q); herm (n_herm) tiles on
// and above the diagonal of a c×c product.
template <int kGroups>
__global__ void __launch_bounds__(kNsThreads * kGroups, 2 / kGroups)
project_kernel(const float2* pd, const float2* it, const float2* v,
               const float* take, float2* out, float2* scratch,
               const float* sched, const int2* herm, int n_herm, int n_steps,
               int n_g, int c, int n_q, int l_lo, int h) {
  extern __shared__ float4 b8_dyn[];
  __shared__ float part_s[3];   // Σ|B|², max row sum, max column sum
  cg::cluster_group cl = cg::this_cluster();
  const Worker wk = cluster_worker<kGroups>(cl, b8_dyn);
  const size_t mat = blockIdx.x / cl.num_blocks();
  const int g = (int)(mat % n_g), l = l_lo + g;
  const size_t qc = (size_t)n_q * c;
  float2* buf = scratch + mat * kSlots * (size_t)c * c;
  float2* Y = buf + 3 * (size_t)c * c;
  const float2* itg = it + mat * qc;

  // B = PD_g·I into slot 3, and its Σ|B|²
  SumSqEpi eb{Y, c, 0.f};
  cluster_gemm(wk, c, c, n_q, CMat{pd + g * qc, n_q, 1, false},
               CMat{itg, c, 1, false}, eb);
  float s[1] = {eb.acc};
  block_sum(s);
  if (threadIdx.x == 0) part_s[0] = s[0];
  cluster_barrier(cl);
  // rms singular-value scale, then M = B + rms on the crop's diagonal
  // outside this order's window [h − l, h + l]
  const float rms = sqrtf(cluster_sum(cl, &part_s[0]) / (float)(2 * l + 1))
                    + 1e-20f;
  auto m_at = [&](int i, int j) {
    float2 x = __ldcg(Y + (size_t)i * c + j);
    if (i == j && (i < h - l || i > h + l)) x.x += rms;
    return x;
  };
  cluster_normalize(cl, m_at, buf, c, &part_s[1]);
  const float2* X =
      cluster_ns_steps(cl, wk, buf, c, sched, n_steps, herm, n_herm);
  TakeEpi eo{out + mat * qc, itg, take + (size_t)g * n_q, c};
  cluster_gemm(wk, n_q, c, c, CMat{v + g * qc, c, 1, false},
               CMat{X, c, 1, false}, eo);
}

// The launch configuration of a cluster kernel of `groups` product groups
// per block (polar_kernel<G>, project_kernel<G>) for `blocks` blocks in
// clusters of `cluster`: the groups' staging buffers as dynamic shared
// memory, and sizes above the portable 8 allowed.
template <class Kernel>
cudaError_t cluster_config(Kernel kernel, int groups, int cluster,
                           unsigned blocks, cudaStream_t st,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const size_t smem = groups * sizeof(GemmSmem);
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(kNsThreads * groups);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int kGroups>
cudaError_t launch_project(int cluster, unsigned blocks, cudaStream_t st,
                           const float2* pd, const float2* it,
                           const float2* v, const float* take, float2* out,
                           float2* scratch, const float* sched,
                           const int2* herm, int n_herm, int n_steps, int n_g,
                           int c, int n_q, int l_lo, int h) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(project_kernel<kGroups>, kGroups, cluster,
                                   blocks, st, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, project_kernel<kGroups>, pd, it, v, take,
                           out, scratch, sched, herm, n_herm, n_steps, n_g, c,
                           n_q, l_lo, h);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int kGroups>
cudaError_t launch_polar(int cluster, unsigned blocks, cudaStream_t st,
                         const float2* m, float2* w, float2* scratch,
                         const float* sched, const int2* herm, int n_herm,
                         int n_steps, int c) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(polar_kernel<kGroups>, kGroups, cluster,
                                   blocks, st, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, polar_kernel<kGroups>, m, w, scratch, sched,
                           herm, n_herm, n_steps, c);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class Kernel>
cudaError_t max_clusters(Kernel kernel, int groups, int* n, int cluster,
                         cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = cluster_config(kernel, groups, cluster,
                                         (unsigned)cluster, st, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

// The launch arguments both cluster kernels check: cluster shape, the
// Hermitian tile list of a c×c product and the grid's block count.
bool cluster_args_valid(int cluster, int groups, int n_herm, int c,
                        size_t blocks) {
  const int nt = (c + kGM - 1) / kGM;
  return c >= 1 && n_herm == nt * (nt + 1) / 2 && cluster >= 1 &&
         cluster <= kMaxCluster && groups >= 1 && groups <= 2 &&
         blocks <= 0x7fffffffu;
}

}  // namespace

extern "C" {

// One cluster of `cluster` blocks × `groups` product groups per matrix;
// herm as for xf_fused_projection.
int xf_polar_unitary(const void* m, void* w, void* scratch, const float* sched,
                     const void* herm, int n_herm, int cluster, int groups,
                     int n_steps, int n_mat, int c, void* stream) {
  if (n_mat < 1 || n_steps < 0 ||
      !cluster_args_valid(cluster, groups, n_herm, c,
                          (size_t)n_mat * cluster))
    return (int)cudaErrorInvalidValue;
  const auto launch = groups == 1 ? launch_polar<1> : launch_polar<2>;
  return (int)launch(cluster, (unsigned)(n_mat * cluster),
                     (cudaStream_t)stream, static_cast<const float2*>(m),
                     static_cast<float2*>(w), static_cast<float2*>(scratch),
                     sched, static_cast<const int2*>(herm), n_herm, n_steps,
                     c);
}

int xf_fused_projection(const void* pd, const void* it, const void* v,
                        const float* take, void* out, void* scratch,
                        const float* sched, const void* herm, int n_herm,
                        int cluster, int groups, int n_steps, int batch,
                        int n_g, int c, int n_q, int l_lo, int h,
                        void* stream) {
  if (batch < 1 || n_g < 1 || n_q < 1 || n_steps < 0 || l_lo < 0 ||
      h < l_lo + n_g - 1 || c != 2 * h + 1 ||
      !cluster_args_valid(cluster, groups, n_herm, c,
                          (size_t)batch * n_g * cluster))
    return (int)cudaErrorInvalidValue;
  const auto launch = groups == 1 ? launch_project<1> : launch_project<2>;
  return (int)launch(cluster, (unsigned)(batch * n_g * cluster),
                     (cudaStream_t)stream, static_cast<const float2*>(pd),
                     static_cast<const float2*>(it),
                     static_cast<const float2*>(v), take,
                     static_cast<float2*>(out), static_cast<float2*>(scratch),
                     sched, static_cast<const int2*>(herm), n_herm, n_steps,
                     n_g, c, n_q, l_lo, h);
}

// kernel 0: B8's project_kernel<groups>, 1: B7's polar_kernel<groups>.
int xf_max_active_clusters(void* n_clusters, int kernel, int cluster,
                           int groups, void* stream) {
  if (kernel < 0 || kernel > 1 || cluster < 1 || cluster > kMaxCluster ||
      groups < 1 || groups > 2)
    return (int)cudaErrorInvalidValue;
  int* n = static_cast<int*>(n_clusters);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (kernel == 0)
    err = groups == 1 ? max_clusters(project_kernel<1>, 1, n, cluster, st)
                      : max_clusters(project_kernel<2>, 2, n, cluster, st);
  else
    err = groups == 1 ? max_clusters(polar_kernel<1>, 1, n, cluster, st)
                      : max_clusters(polar_kernel<2>, 2, n, cluster, st);
  return (int)err;
}

}  // extern "C"
