// Helpers shared by the fused tail kernels (tail.cu, tail_srgan.cu): bf16
// unpacking, PReLU, int8 quantisation and dequantisation, and the u8
// epilogue, each rounding where the plain PyTorch twin (ops/tail.py) does.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tail {

constexpr int T = 124;             // tile width
constexpr int CORE = 120;          // tile core width

__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ void unpack8(const uint4 v, float* f) {
  f[0] = bf_lo(v.x); f[1] = bf_hi(v.x); f[2] = bf_lo(v.y); f[3] = bf_hi(v.y);
  f[4] = bf_lo(v.z); f[5] = bf_hi(v.z); f[6] = bf_lo(v.w); f[7] = bf_hi(v.w);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float prelu(float v, float a) {
  return v >= 0.f ? v : a * v;
}
// q(v * inv): round half to even, clip to +-127
__device__ __forceinline__ int quant(float v, float inv) {
  return (int)fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
}
__device__ __forceinline__ uint32_t pack_s8x4(const float* v, float inv) {
  return (uint32_t)(quant(v[0], inv) & 0xff) |
         ((uint32_t)(quant(v[1], inv) & 0xff) << 8) |
         ((uint32_t)(quant(v[2], inv) & 0xff) << 16) |
         ((uint32_t)(quant(v[3], inv) & 0xff) << 24);
}
// int32 * scale + bias with two roundings, as the twin computes it
__device__ __forceinline__ float dequant(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn((float)acc, s), b);
}
// tanh, rounded to bf16, then trunc(clip((t + 1) * 127.5 + 0.5, 0, 255))
__device__ __forceinline__ uint8_t to_u8(float v) {
  const float t = round_bf16(tanhf(v));
  float u = __fadd_rn(__fmul_rn(__fadd_rn(t, 1.0f), 127.5f), 0.5f);
  return (uint8_t)(int)fminf(fmaxf(u, 0.f), 255.f);
}

}  // namespace tail
