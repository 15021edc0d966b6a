// Helpers shared by the fused tail kernels (tail.cu, tail_srgan.cu): the
// modes and epilogues, the h patch load, bf16 unpacking, PReLU, int8
// quantisation, dot products and dequantisation, and the two output
// epilogues, each rounding where the plain PyTorch twin (ops/tail.py) does;
// and the tensor-core building blocks (cp.async, ldmatrix, mma.sync).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tail {

constexpr int T = 124;             // tile width
constexpr int CORE = 120;          // tile core width

// Modes, numbered as ops/tail.py::MODES.  bf16: bf16 h, f32 sums.  w8a8:
// bf16 h and up1; up2 and the output conv int8 x int8 -> int32.  qh8: as
// w8a8, with int8 h (one step size per channel) and up1 int8 too.
enum Mode { BF16 = 0, W8A8 = 1, QH8 = 2 };

// The launch's arguments, as the C entry points take them.
struct Args {
  const void* h;
  void* out;
  const void *w1, *b1, *a1, *w2, *b2, *a2, *w3, *b3, *s1, *s2, *s3;
  float inv_su1, inv_sr;
  int nx, core_rows, height, width, bgr;
};

// The h patch of tile rows r0.. and cols c0.. (HR x HC pixels of PX bytes)
// into shared memory in 16-byte pieces; zero outside the (tr, T) tile.
template <int PX, int HR, int HC>
__device__ __forceinline__ void load_patch(const unsigned char* hn, uint4* dst,
                                           int r0, int c0, int tr, int tid,
                                           int nt) {
  constexpr int PARTS = PX / 16;
  for (int i = tid; i < HR * HC * PARTS; i += nt) {
    const int px = i / PARTS, part = i % PARTS;
    const int y = r0 + px / HC, x = c0 + px % HC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (y < tr && x < T)
      v = *reinterpret_cast<const uint4*>(hn + ((size_t)y * T + x) * PX +
                                          part * 16);
    dst[i] = v;
  }
}

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
// 4 channels of an activation: int8 q(v * inv) when Q8, else bf16
template <bool Q8, typename act_t>
__device__ __forceinline__ void put4(act_t* dst, const float* v, float inv) {
  if constexpr (Q8)
    *reinterpret_cast<uint32_t*>(dst) = pack_s8x4(v, inv);
  else
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}
// w[k][q] = int32 word q of row k, k < 4, from rows `stride` words apart:
// 4 consecutive int8 along the contraction of 4 output channels
__device__ __forceinline__ void load_w16(int (*w)[4], const int* rows,
                                         int stride) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 wv = *reinterpret_cast<const int4*>(rows + k * stride);
    w[k][0] = wv.x; w[k][1] = wv.y; w[k][2] = wv.z; w[k][3] = wv.w;
  }
}
// s[q] += the 16 int8 of `a` dotted with the 16 int8 of w[0..3][q]
__device__ __forceinline__ void dp4a_16(int* s, const uint4 a,
                                        const int (*w)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int v = s[q];
    v = __dp4a((int)a.x, w[0][q], v);
    v = __dp4a((int)a.y, w[1][q], v);
    v = __dp4a((int)a.z, w[2][q], v);
    v = __dp4a((int)a.w, w[3][q], v);
    s[q] = v;
  }
}
// int32 * scale + bias with two roundings, as the twin computes it
__device__ __forceinline__ float dequant(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn((float)acc, s), b);
}
// u8 epilogue: tanh, rounded to bf16, then
// trunc(clip((t + 1) * 127.5 + 0.5, 0, 255))
__device__ __forceinline__ uint8_t to_u8(float v) {
  const float t = round_bf16(tanhf(v));
  float u = __fadd_rn(__fmul_rn(__fadd_rn(t, 1.0f), 127.5f), 0.5f);
  return (uint8_t)(int)fminf(fmaxf(u, 0.f), 255.f);
}
// one output element from the output conv's pre-activation v: the u8 byte,
// or (canvas) the bf16 tanh that to_u8 rounds
__device__ __forceinline__ void store_px(uint8_t* dst, float v) {
  *dst = to_u8(v);
}
__device__ __forceinline__ void store_px(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(tanhf(v));
}

// ---- tensor-core building blocks (mma.sync, ldmatrix, cp.async)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared without passing through registers; zeros when
// !valid (then nothing is read from src)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// four 8x8 b16 matrices; lanes 8i..8i+7 give matrix i's row addresses
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void lds128(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// c += a . b, m16n8k16, bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a . b, m16n8k32, int8 operands, int32 sums (exact)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The C entry points' check of their arguments; cudaSuccess if valid.
inline cudaError_t check_args(const Args& a, int mode, int canvas,
                              int n_tiles) {
  if (n_tiles < 1 || a.nx < 1 || n_tiles % a.nx || a.core_rows < 1 ||
      n_tiles > 65535 || mode < BF16 || mode > QH8 ||
      (mode != BF16 && (!a.s2 || !a.s3)) || (mode == QH8 && !a.s1) ||
      (canvas && a.bgr))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace tail
