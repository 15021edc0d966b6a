// Helpers shared by the fused tail kernels (tail.cu, tail_srgan.cu): the
// modes and epilogues, bf16 unpacking, PReLU, int8 quantisation and
// dequantisation, and the two output epilogues, each rounding where the
// plain PyTorch twin (ops/tail.py) does; the tensor-core building blocks
// (cp.async, ldmatrix, mma.sync); up1's sum error bound, its certainty
// test and the repair of the values it leaves uncertain.
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
// d = a . b, m16n8k16, bf16 operands, f32 sums from zero: the caller adds
// d to its sums in f32, rounding to nearest, where mma_bf16's accumulation
// would truncate
__device__ __forceinline__ void mma_bf16_z(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
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

// up1's sum error bound, relative to |x| |w|, for a sum of k <= 576 bf16
// products (each exact in f32) that a kernel takes on the tensor cores and
// compares with the twin's (ops/tail.py::_up1_sum): x the k inputs, w the
// weights.
// * The twin's order adds one product at a time, k - 1 roundings: within
//   gamma_{k-1} sum |x w| <= gamma_{k-1} |x| |w| of the exact sum (Higham,
//   Accuracy and Stability of Numerical Algorithms, 2nd ed., (4.4));
//   gamma_n = n u / (1 - n u), u = 2**-24.  Proven; up1_err_twin, rounded
//   up.
// * mma.sync's f32 accumulation has no published bound.  It is allowed
//   UP1_ERR_MMA = 2**-16, at least 10x the largest distance chip_smoke.py's
//   phase 3b measures, at k = 288 (K1) and k = 576 (K2), both with K8's
//   chained bf16 mma.sync product (inputs of one sign come closest), which
//   the phase requires on every run.
// ops/tail.py::up1_err mirrors both parts; the kernels report theirs
// (dgt_tail_params, dgt_tail64_params) and chip_smoke.py holds the two
// equal.
constexpr float UP1_ERR_MMA = 0x1p-16f;
__host__ __device__ constexpr float up1_err_twin(int k) {
  return (float)((k - 1) * 0x1p-24 / (1.0 - (k - 1) * 0x1p-24) *
                 (1.0 + 0x1p-20));
}
__host__ __device__ constexpr float up1_err(int k) {
  return up1_err_twin(k) + UP1_ERR_MMA;
}

// Whether every u1 within dv of v = prelu(z, a) rounds as v does: to one
// int8 step q(v * inv) (Q8; x = v * inv, the half-integers are the steps'
// boundaries) or to one bf16 value.  The slack covers the roundings of
// v * inv and v +- dv themselves.
template <bool Q8>
__device__ __forceinline__ bool certain(float v, float dv, float inv) {
  if constexpr (Q8) {
    const float x = __fmul_rn(v, inv);
    const float dx = dv * inv * (1.f + 0x1p-20f) + fabsf(x) * 0x1p-22f;
    return fabsf(x - rintf(x)) < 0.5f - dx;
  } else {
    const float d = dv + fabsf(v) * 0x1p-22f;
    return __bfloat16_as_ushort(__float2bfloat16_rn(v - d)) ==
           __bfloat16_as_ushort(__float2bfloat16_rn(v + d));
  }
}
// Whether u1 = prelu(z, a) keeps the rounding of a tensor-core sum z + b1:
// both that sum and the twin's lie within xerr * wn of the exact one (xerr
// = ERR |x|, wn = |w|, each rounded up), plus z's own rounding.  The
// kernels' up1 epilogues and dgt_up1_certain (tail_check.cu) apply it.
template <bool Q8>
__device__ __forceinline__ bool up1_certain(float z, float a, float xerr,
                                            float wn, float inv) {
  const float dz = xerr * wn + fabsf(z) * 0x1p-22f;
  return certain<Q8>(prelu(z, a), dz * fmaxf(1.f, fabsf(a)), inv);
}
// entry e of the repair's list (count, then cap entries); past cap only
// the count grows, and the repair takes every value
__device__ __forceinline__ void list_add(int* count, uint16_t* list, int cap,
                                         int e) {
  const int k = atomicAdd(count, 1);
  if (k < cap) list[k] = (uint16_t)e;
}

// element (k, c) of a shared bf16 weight slice of NC columns: row k,
// 16-byte chunk c/8 ^ (k & 7)
template <int NC>
__device__ __forceinline__ float w16_at(const unsigned char* sl, int k,
                                        int c) {
  const uint16_t v = *reinterpret_cast<const uint16_t*>(
      sl + k * 2 * NC + (((c >> 3) ^ (k & 7)) << 4) + (c & 7) * 2);
  return __uint_as_float((uint32_t)v << 16);
}

// The repair cycles for `todo` values, RPT a thread of NT.
template <int NT, int RPT>
__device__ __forceinline__ int repair_cycles(int todo) {
  return (todo + NT * RPT - 1) / (NT * RPT);
}
// The repair of up1 (tail.cu, tail_srgan.cu): the values a tensor-core sum
// left uncertain summed again one product at a time in the twin's order
// (tap-major, then input channel: ops/tail.py::_up1_sum), RPT a thread a
// cycle while W1's 9 tap slices (NC columns) pass through the kernel's
// ring.  The list holds `listed` entries e = position * NC + channel; past
// `cap` it overflowed and values 0..todo-1 are taken in order.  slice()
// waits for the next tap's slice and returns it; pixel(p, tap, sw) the h
// pixel (CIN bf16 values in 16-byte chunks, chunk XOR sw) that position p
// reads at the tap; put(p, c, sum) stores u1.
template <int CIN, int NC, int NT, int RPT, typename Slice, typename Pixel,
          typename Put>
__device__ __forceinline__ void repair(int cycles, int listed, int cap,
                                       int todo, const uint16_t* list,
                                       int tid, Slice slice, Pixel pixel,
                                       Put put) {
#pragma unroll 1
  for (int cyc = 0; cyc < cycles; ++cyc) {
    int e[RPT];
    float sum[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int k = (cyc * RPT + j) * NT + tid;
      e[j] = k >= todo ? -1 : listed > cap ? k : list[k];
      sum[j] = 0.f;
    }
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const unsigned char* sl = slice();
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        if (e[j] < 0) continue;
        const int c = e[j] % NC;
        int sw;
        const unsigned char* hp = pixel(e[j] / NC, tap, sw);
#pragma unroll 2
        for (int k8 = 0; k8 < CIN / 8; ++k8) {
          float x[8];
          unpack8(*reinterpret_cast<const uint4*>(hp + ((k8 ^ sw) << 4)), x);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            sum[j] = fmaf(x[i], w16_at<NC>(sl, 8 * k8 + i, c), sum[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      if (e[j] >= 0) put(e[j] / NC, e[j] % NC, sum[j]);
  }
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
