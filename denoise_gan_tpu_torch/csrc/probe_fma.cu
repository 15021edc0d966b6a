// CUDA-core peak probe (K9): a chained FMA and a chained roll + FMA on f32.
//
// Replaces the Pallas probe tools/exp_vpu_peak.py (fma_kernel :39,
// roll_fma_kernel :49), which measured the TPU vector unit's FMA peak and
// the cost of a lane roll.  The Hopper questions are the CUDA cores' FFMA
// peak (132 SMs x 128 lanes x 2 flops per clock) and the cost of the
// __shfl_sync + FMA step with which csrc/tail_srgan.cu feeds R to its 1x1
// conv.
//
// fma_kernel: acc = fmaf(acc, c1, c2), `iters` times, per element.  Each
// thread owns V elements (V independent chains), so a warp always has an
// FFMA ready despite the 4-cycle latency; operations bound it: 2 flops per
// element per iteration, nothing read or written in between.
//
// roll_fma_kernel: acc = fmaf(roll(acc, 1, axis 1), c1, acc), `iters`
// times, on rows of WIDTH = 1024 floats (the JAX probe's), where
// roll(a, 1)[j] = a[j - 1] and [0] = a[WIDTH - 1] (np.roll, which
// pltpu.roll matches).  One row per warp: element j lives on lane j % 32 in
// register j / 32, so a roll step is one __shfl_sync per element (from
// lane - 1); lane 0 takes lane 31's value of the previous register, and of
// the last register for register 0, which keeps the wrap.  The shuffle unit
// gives 32 results per clock per SM against 128 FFMA, so the shuffle bounds
// this kernel at a quarter of the FFMA peak.
//
// Every step is one fmaf, rounded once; the plain versions
// (probes/fma_peak.py) round each multiply-add once too.

#include <cuda_runtime.h>

namespace {

constexpr int V = 8;             // chains per thread in fma_kernel
constexpr int FMA_THREADS = 128;
constexpr int ROLL_WARPS = 4;    // rows per block in roll_fma_kernel
constexpr int R = 32;            // registers per lane: rows of 32 * R floats

__global__ void __launch_bounds__(FMA_THREADS)
fma_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
           int iters, float c1, float c2) {
  const long long base = (long long)blockIdx.x * FMA_THREADS * V + threadIdx.x;
  float a[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const long long i = base + (long long)v * FMA_THREADS;
    a[v] = i < n ? x[i] : 0.f;
  }
#pragma unroll 8
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int v = 0; v < V; ++v) a[v] = fmaf(a[v], c1, c2);
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const long long i = base + (long long)v * FMA_THREADS;
    if (i < n) out[i] = a[v];
  }
}

__global__ void __launch_bounds__(32 * ROLL_WARPS)
roll_fma_kernel(const float* __restrict__ x, float* __restrict__ out,
                int rows, int iters, float c1) {
  const int row = blockIdx.x * ROLL_WARPS + threadIdx.x / 32;
  if (row >= rows) return;                 // warp-uniform
  const int lane = threadIdx.x % 32;
  const int src = (lane + 31) % 32;
  const float* xr = x + (size_t)row * 32 * R;
  float a[R];
#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = xr[32 * r + lane];
  for (int it = 0; it < iters; ++it) {
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = __shfl_sync(0xffffffffu, a[r], src);
#pragma unroll
    for (int r = 0; r < R; ++r)
      a[r] = fmaf(lane ? s[r] : s[(r + R - 1) % R], c1, a[r]);
  }
  float* orow = out + (size_t)row * 32 * R;
#pragma unroll
  for (int r = 0; r < R; ++r) orow[32 * r + lane] = a[r];
}

}  // namespace

// n f32 values x -> out, each `iters` chained fmaf(acc, c1, c2), on
// `stream`; returns the launch's cudaError_t.
extern "C" int dgt_probe_fma(const void* x, void* out, long long n, int iters,
                             float c1, float c2, void* stream) {
  if (n < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  const long long grid = (n + (long long)FMA_THREADS * V - 1) /
                         ((long long)FMA_THREADS * V);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fma_kernel<<<(unsigned)grid, FMA_THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, iters, c1,
      c2);
  return (int)cudaGetLastError();
}

// (rows, 32 * R) f32 x -> out, each row `iters` chained
// fmaf(roll(acc, 1), c1, acc), on `stream`; returns the launch's
// cudaError_t.
extern "C" int dgt_probe_roll_fma(const void* x, void* out, int rows,
                                  int iters, float c1, void* stream) {
  if (rows < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  const int grid = (rows + ROLL_WARPS - 1) / ROLL_WARPS;
  roll_fma_kernel<<<grid, 32 * ROLL_WARPS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, iters,
      c1);
  return (int)cudaGetLastError();
}
