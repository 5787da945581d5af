// Mixed-radix Stockham FFTs in shared memory for Hopper (sm_90a), shared by
// the FFT routes of the fused MTIP kernels (csrc/mtip.cu: B4's projection),
// of the synthesis (sht.cuh: synthesis_fft_kernel, B2, B5, B6, B10, B11 and
// B12, whose epilogue also runs forward FFTs) and of the analysis (sht.cuh:
// analysis_fft_kernel, B1, B3 and B9).
// Everything here is file-local to each translation unit.
//
// A line of n = n_φ complex values lives in shared memory with one float2 of
// padding after every 16 (fpad), lines fft_line_stride(n) apart; a transform
// alternates between two such buffers, one block barrier per pass. The
// passes' radices (4s first, then 2, 3 and 5) arrive from the host plan
// (ops/fft_plan.py) as 3-bit digits of an int, first pass lowest,
// and the twiddles tw[t] = e^{−2πi·t/n} as a table the block copies into
// shared memory.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPasses = 10;    // radices packed 3 bits each in an int

// Index of element i of a line in shared memory: one float2 of padding
// after every 16, so that the stride-R writes of the first passes fall on
// distinct banks.
__device__ __forceinline__ int fpad(int i) { return i + (i >> 4); }

__host__ __device__ int fft_line_stride(int n_phi) {
  return n_phi + (n_phi + 15) / 16;
}

// The host plan's radix code → radix[0 .. passes−1]; returns passes.
__device__ __forceinline__ int fft_radices(int code, int (&radix)[kMaxPasses]) {
  int passes = 0;
  for (; code && passes < kMaxPasses; code >>= 3) radix[passes++] = code & 7;
  return passes;
}

// True where `code` is a valid plan for length n (every radix 2..5, at most
// kMaxPasses of them, product n); the entry points check it on the host.
inline bool fft_code_valid(int code, int n) {
  int prod = 1, passes = 0;
  for (; code; code >>= 3, ++passes) {
    const int r = code & 7;
    if (r < 2 || r > 5 || passes == kMaxPasses) return false;
    prod *= r;
  }
  return passes > 0 && prod == n;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// The radix-R DFT of x in place, y_s = Σ_r x_r·e^{∓2πi·rs/R} (− forward,
// + inverse); tw holds e^{−2πi·t/n} with R | n.
template <int R>
__device__ __forceinline__ void small_dft(float2 (&x)[R], const float2* tw,
                                          int n, bool inverse) {
  if constexpr (R == 2) {
    const float2 a = x[0], b = x[1];
    x[0] = make_float2(a.x + b.x, a.y + b.y);
    x[1] = make_float2(a.x - b.x, a.y - b.y);
  } else if constexpr (R == 4) {
    const float2 a = make_float2(x[0].x + x[2].x, x[0].y + x[2].y);
    const float2 b = make_float2(x[0].x - x[2].x, x[0].y - x[2].y);
    const float2 c = make_float2(x[1].x + x[3].x, x[1].y + x[3].y);
    // d = ∓i·(x1 − x3)
    float2 d = make_float2(x[1].y - x[3].y, x[3].x - x[1].x);
    if (inverse) d = make_float2(-d.x, -d.y);
    x[0] = make_float2(a.x + c.x, a.y + c.y);
    x[1] = make_float2(b.x + d.x, b.y + d.y);
    x[2] = make_float2(a.x - c.x, a.y - c.y);
    x[3] = make_float2(b.x - d.x, b.y - d.y);
  } else {
    float2 y[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      y[s] = x[0];
#pragma unroll
      for (int r = 1; r < R; ++r) {
        float2 e = tw[((r * s) % R) * (n / R)];
        if (inverse) e.y = -e.y;
        const float2 v = cmul(x[r], e);
        y[s].x += v.x;
        y[s].y += v.y;
      }
    }
#pragma unroll
    for (int s = 0; s < R; ++s) x[s] = y[s];
  }
}

// One Stockham pass of radix R over `lines` lines of n (stride ls): after
// the passes before it, whose radices multiply to ns, butterfly j of a line
// reads elements j + r·n/R, twiddles them by e^{∓2πi·r·k/(ns·R)} (k = j mod
// ns), and writes its R outputs to (j/ns)·ns·R + k + r·ns.
template <int R>
__device__ void fft_pass(const float2* in, float2* out, const float2* tw,
                         int n, int ns, int lines, int ls, bool inverse) {
  const int nb = n / R, step = n / (ns * R);
  for (int u = threadIdx.x; u < lines * nb; u += blockDim.x) {
    const int line = u / nb, j = u - line * nb, k = j % ns;
    const float2* src = in + line * ls;
    float2* dst = out + line * ls;
    float2 x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = src[fpad(j + r * nb)];
#pragma unroll
    for (int r = 1; r < R; ++r) {
      float2 e = tw[r * k * step];
      if (inverse) e.y = -e.y;
      x[r] = cmul(x[r], e);
    }
    small_dft<R>(x, tw, n, inverse);
    const int base = (j / ns) * ns * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[fpad(base + r * ns)] = x[r];
  }
}

// The unnormalised DFT (inverse: e^{+2πi·kp/n}) of `lines` lines held in
// a, passes alternating between a and b; → the buffer with the result.
__device__ float2* fft_lines(float2* a, float2* b, const float2* tw,
                             const int* radix, int passes, int n, int lines,
                             int ls, bool inverse) {
  int ns = 1;
  for (int p = 0; p < passes; ++p) {
    const int r = radix[p];
    if (r == 2) fft_pass<2>(a, b, tw, n, ns, lines, ls, inverse);
    else if (r == 3) fft_pass<3>(a, b, tw, n, ns, lines, ls, inverse);
    else if (r == 4) fft_pass<4>(a, b, tw, n, ns, lines, ls, inverse);
    else fft_pass<5>(a, b, tw, n, ns, lines, ls, inverse);
    __syncthreads();
    float2* t = a;
    a = b;
    b = t;
    ns *= r;
  }
  return a;
}

}  // namespace
