// The fused tails' up1 certainty test (tail_common.cuh::up1_certain) as a
// C entry point over arrays on the card: the test the up1 epilogues of
// tail.cu (w8a8) and tail_srgan.cu (w8a8, bf16) apply, compiled as they
// compile it.  chip_smoke.py counts with it the share of u1 values a
// margin leaves to the repair; no frame path runs it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tail_common.cuh"

namespace {

template <bool Q8>
__global__ void up1_certain_kernel(const float* __restrict__ z,
                                   const float* __restrict__ a,
                                   const float* __restrict__ xerr,
                                   const float* __restrict__ wn,
                                   uint8_t* __restrict__ out, float inv,
                                   long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = tail::up1_certain<Q8>(z[i], a[i], xerr[i], wn[i], inv);
}

}  // namespace

// out[i] = 1 where u1 = prelu(z[i], a[i]) keeps its rounding (q8: the int8
// step q(u1 * inv); else bf16) for every sum within xerr[i] * wn[i] of
// z[i], else 0; f32 inputs and u8 output of n elements on the card.
// Returns the launch's cudaError_t.
extern "C" int dgt_up1_certain(const void* z, const void* a, const void* xerr,
                               const void* wn, void* out, float inv,
                               long long n, int q8, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((n + 255) / 256 < 65536 ? (n + 255) / 256 : 65536);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  uint8_t* o = static_cast<uint8_t*>(out);
  if (q8)
    up1_certain_kernel<true><<<blocks, 256, 0, st>>>(f(z), f(a), f(xerr),
                                                     f(wn), o, inv, n);
  else
    up1_certain_kernel<false><<<blocks, 256, 0, st>>>(f(z), f(a), f(xerr),
                                                      f(wn), o, inv, n);
  return (int)cudaGetLastError();
}
