// Fused inverted residual (MobileNetV2 block, BN folded) for Hopper
// (sm_90a): expand 1x1 + bias + ReLU -> 3x3 depthwise + bias + ReLU ->
// project 1x1 + bias + residual, one launch per block.
//
// Replaces the TPU kernel tools/exp_mbconv_kernel.py::_mbconv_kernel.  Its
// plain PyTorch version is ops/mbconv.py::fused_mbconv_reference, and the
// kernel's output equals it bit for bit; the wrapper is
// ops/mbconv.py::fused_mbconv.
//
// Input x: NHWC (n, h, w, 32) bf16, contiguous.  Output: the same shape.
// Weights bf16: we (32, E) and be (E) (null without an expand, where E =
// 32), wd (3, 3, E), bd (E), wp (E, 32), bp (32).  E is a multiple of 32,
// at most E_MAX = 192.
//
// What bounds it on the H100.  Bytes: x read once, y written once, 282 MB
// a launch at 1080p (0.08 ms at 3.35 TB/s).  Instructions: the plain
// version rounds every depthwise product and sum (__fmul_rn, __fadd_rn), 2
// FP32 instructions a tap, 9 x 2 x E an output pixel, which no tensor core
// can take; at 1080p that is ~1.2 ms a frame on the CUDA cores.  The two
// 1x1 convolutions (6,144 multiply-adds a pixel each at E = 192) go to the
// tensor cores, where they cost little.  So the design keeps the expanded
// tensor out of device memory, puts the products on mma.sync and runs the
// depthwise on warps of its own beside them.
//
// Design.
// * Persistent blocks: one block an SM (the grid is the SM count times the
//   resident blocks, at most the number of units); each walks units of
//   BR x BC = 16 x 16 outputs (a patch of 18 x 18 pixels of x, the halo 1.27x)
//   in the order (image, band, column chunk), strided by the grid.  The
//   weights come to shared memory once a block.  The x patch of the next
//   unit arrives by cp.async into the second of two buffers (zero outside
//   the image) while the current unit is computed.
// * Warp roles, 16 warps: 8 tensor-core warps (TC) and 8 depthwise warps
//   (DW).  The expanded channels go in chunks of EC = 16.  For chunk g of
//   the block's stream of chunks, TC expands it into e buffer g & 1 and
//   projects chunk g - 1, while DW runs the depthwise of chunk g - 1 or g.
//   They meet at named barriers: FULL (e buffer written), EMPTY (e buffer
//   read), DREADY (d chunk written and repaired), each one per buffer
//   parity, so no arrival can run a generation ahead of its wait; and at
//   YB, twice a unit, around the y repair that all warps share.
// * Expand (TC): mma.sync m16n8k16 bf16 -> f32, chained over K = 32, of
//   e^T = we^T x^T: M the chunk's 16 channels (A, we^T, held for the
//   chunk), N the 324 patch pixels (41 n-tiles, the last clamped; B, the
//   x patch's rows), both by ldmatrix from swizzled tiles.  Epilogue: +
//   be, ReLU, 0 outside the image (SAME padding on the expanded tensor),
//   two neighbouring pixels of a channel's f32 e plane (18 x 20) a store.
//   Without an expand, e is x itself, copied into the planes.
// * Depthwise (DW): a thread takes one channel, 4 output rows and 4
//   columns; it walks the 6 patch rows downwards, each row one 16-byte and
//   one 8-byte load, and adds each row's taps into the output rows it
//   reaches, so every output takes its taps in the plain version's order:
//   tap row, then tap column, __fmul_rn and __fadd_rn, then + bd, ReLU,
//   bf16.  d of all E channels of the unit stays in shared memory (256 x E
//   bf16, a row an output, swizzled).  K4's chunked form took its horizontal
//   neighbours from lanes +-1 by __shfl_sync; here a row of 18 patch
//   pixels does not split into lanes of 4, and the 8-byte load costs one
//   instruction where the two shuffles cost two.
// * Project (TC): mma.sync bf16, chained over the chunks (K = E), M the
//   256 outputs (16 m-tiles, one an output row), N = 32; A (d) and B (wp^T)
//   by ldmatrix.  The sums stay in registers across the chunks.
//   Epilogue: y = bf16((p + bp) + x), in this order.
// What the repairs cost (PERF.md, section 6: chip_smoke.py's repaired
// shares and the check form's phase timer): a d repair is ~650
// instructions and 40 16-byte shared loads (9 taps of 32 products, x
// unpacked from bf16), so at the few percent of d values repaired on
// seeded weights the d repairs, and the shared-memory traffic they add,
// take more of the time than the tensor cores or the depthwise.
//
// Bit-identity.  The plain version sums the expand over input channels
// 0..31 and the project over expanded channels 0..E-1, one product at a
// time; the tensor cores sum in an order of their own.  So the kernel keeps
// a tensor-core result only where its rounding is certain within a margin
// that covers both sums, and recomputes the rest in the plain order (the
// K1/K2 route, tail_common.cuh::up1_certain and repair).
//   Sum errors, relative to the L2 norms |x| |w| of the two operands: the
//   plain order's recursive sum of k exact products lies within
//   gamma_{k-1} sum |x w| <= gamma_{k-1} |x| |w| of the exact sum
//   (tail_common.cuh::up1_err_twin, proven); mma.sync's within
//   ERR_MMA_EXPAND (K = 32) or ERR_MMA_PROJECT (K = E), allowances that
//   chip_smoke.py's phase 3b holds at 10x what it measures for chained
//   bf16 mma.sync at those K.  u = 2**-24.
//   d test.  For output o and channel k, with |x_t| the norm of x at the
//   patch pixel of tap t (0 outside the image), W = |we[:, k]|, B =
//   be[k]: the two sums of tap t differ by at most (eps_e + gamma_31)
//   |x_t| W, and each is at most |x_t| W in size, so + be, rounded on
//   each side, moves them apart by 2u (|x_t| W + |B|) more: the two e
//   values differ by at most De_t = (eps_e + gamma_31 + 2u) |x_t| W + 2u
//   |B|.  The depthwise applies the same roundings to different inputs:
//   its products differ by |wd_t| De_t plus their two roundings, 2u
//   |wd_t| e_t (e the kernel's own, >= 0; the plain version's is within
//   De_t of it: second order), its eight sums by their two roundings,
//   each at most u sum |wd| e a side, and + bd by 2u (sum |wd| e + |bd|).
//   In all, v = acc + bd of kernel and plain lie within sum over t of
//   |wd_t| (alpha_k |x_t| + 20u e_t) + beta_k, alpha_k = W (eps_e +
//   gamma_31 + 2u), beta_k = 2u Wd |B| + 2u |bd| (Wd = sum |wd[:, k]|),
//   each part times SLACK = 1 + 2**-10 for the higher-order terms and the
//   margin's own f32 arithmetic; the depthwise warps sum it beside acc,
//   from |x| planes that the tensor-core warps fill once a unit.  The
//   kernel keeps bf16(relu(v)) where bf16(relu(v -+ m)) agree (m the
//   margin plus 4u |v| for the roundings of v -+ m); otherwise it
//   recomputes the value's 9 taps of e in the plain order (32 fmaf each:
//   every product is exact in f32, so fmaf rounds as the plain version's
//   add) and its depthwise, exactly.
//   y test.  With d now the plain version's, p differs only by order.
//   The tensor cores' sum lies within eps_p P V of the exact one, P =
//   |d[o, :]| (from the project's own A fragments), V = |wp[:, c]|.  The
//   plain order's error is sum over i of delta_i (S^_{i-1} + d_i wp_i),
//   |delta_i| <= u: within u times the sum of the partial sums' sizes.  In
//   chunk j (16 products) each partial sum is at most |S_16j| + A_j, A_j =
//   sum over the chunk of |d wp| <= |d_j| |wp_j| (Cauchy-Schwarz), and
//   sum_j |d_j| |wp_j| <= P V: so within 16u (sum_j M_j + P V), M_j the
//   largest |p| over the 32 channels at the output after chunks 0..j-1,
//   read from the tensor cores' own sums before each chunk is added (their
//   distance from the exact partial sums, and the plain partial sums' own
//   errors, are second order: SLACK covers them).  + bp and + x round both
//   sides once each: 2u (P V + |bp|) and 2u (P V + |bp| + |x|).  The
//   margin is SLACK (P V (eps_p + 16u + 4u) + 16u sum_j M_j + 4u |bp| + 2u
//   |x|); the kernel keeps bf16(y) where bf16(y -+ m) agree.  The rest is
//   listed, and after the unit's last chunk every thread of the block sums
//   it again over E in the plain order from the d tile (repair_y), before
//   the depthwise warps write the next unit's d.
//   The uncertain values go to lists in shared memory, one atomicAdd a
//   warp (warp_reserve); past a list's cap the repair takes every value of
//   the chunk or unit.  Without an
//   expand, e = x exactly, so only y is tested.  dgt_mbconv_params reports
//   the margins' parts and the geometry (ops/mbconv.py mirrors them);
//   dgt_mbconv_counted runs the kernel's check form, which counts the
//   values each test left to the repair and times the phases (clock64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tail_common.cuh"

namespace {

constexpr int C = 32;                  // residual stream channels
constexpr int E_MAX = 192;             // expanded channels at most
constexpr int BR = 16, BC = 16;        // output rows, cols of a unit
constexpr int PR = BR + 2, PC = BC + 2;      // the x patch with its halo
constexpr int NPP = PR * PC;                 // 324 patch pixels
constexpr int NT_E = (NPP + 7) / 8;          // 41 expand n-tiles
constexpr int NPO = BR * BC;                 // 256 outputs
constexpr int EC = 16;                       // expanded channels a chunk
constexpr int ES_ROW = 20;             // e plane row stride, floats
constexpr int ES_PLANE = 360;          // e plane stride, floats
constexpr int NTC = 8, NDW = 8;        // tensor-core and depthwise warps
constexpr int TCT = 32 * NTC, DWT = 32 * NDW, NT = TCT + DWT;
constexpr int MPW = NPO / 16 / NTC;    // output rows (m-tiles) a TC warp
static_assert(MPW * 16 * NTC == NPO, "the TC warps share the outputs");
constexpr int DCAP = 1024, YCAP = 2048;      // repair list entries

// the margins' parts (header note); ops/mbconv.py mirrors them
constexpr float ERR_MMA_EXPAND = 1.5e-6f;
constexpr float ERR_MMA_PROJECT = 5e-6f;
constexpr float U = 0x1p-24f;
constexpr float ROUND_E = 2 * U;
constexpr float ROUND_DW = 20 * U;
constexpr float ROUND_Y = 4 * U;
constexpr float PLAIN_Y = EC * U;
constexpr float SLACK = 1.f + 0x1p-10f;

// shared memory, bytes
constexpr int XS_BYTES = NPP * C * 2;              // one x patch buffer
constexpr int ES_BYTES = EC * ES_PLANE * 4;        // one e buffer
constexpr int OFF_XS = 0;
constexpr int OFF_ES = OFF_XS + 2 * XS_BYTES;
constexpr int OFF_DP = OFF_ES + 2 * ES_BYTES;      // d (NPO, E_MAX) bf16
constexpr int OFF_WE = OFF_DP + NPO * E_MAX * 2;   // we^T (E_MAX, C) bf16
constexpr int OFF_WP = OFF_WE + E_MAX * C * 2;     // wp^T (C, E_MAX) bf16
constexpr int OFF_WD = OFF_WP + C * E_MAX * 2;     // wd (9, E_MAX) f32
constexpr int OFF_CH = OFF_WD + 9 * E_MAX * 4;     // be, bd, alpha, beta
constexpr int OFF_OC = OFF_CH + 4 * E_MAX * 4;     // bp, |wp[:, c]|
constexpr int XN_BYTES = PR * ES_ROW * 4;          // |x| a patch pixel
constexpr int OFF_XN = OFF_OC + 2 * C * 4;         // 2 units' |x| planes
constexpr int OFF_DL = OFF_XN + 2 * XN_BYTES;      // d repair list
constexpr int OFF_YL = OFF_DL + DCAP * 2;          // y repair list
constexpr int OFF_CNT = OFF_YL + YCAP * 2;         // d counts (2), y count
constexpr int SMEM = OFF_CNT + 16;
static_assert(SMEM <= 232448, "a block's shared memory");
static_assert(XS_BYTES % 16 == 0 && ES_BYTES % 16 == 0 && OFF_XN % 16 == 0 &&
                  OFF_DL % 16 == 0, "16-byte aligned buffers");
static_assert(ES_PLANE >= PR * ES_ROW, "an e plane holds the patch");

// named barriers (0 is __syncthreads)
enum Bar { FULL = 1, EMPTY = 3, DREADY = 5, TCB = 7, DWB = 8, YB = 9 };

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// byte offsets of 16-byte chunk kc: in a 64-byte row r (x patch, we^T),
// in a row n of wp^T, in the d row of output o; the XOR puts the 8 rows an
// ldmatrix reads in 8 bank groups, and (d) the 8 rows o + 4 q + 64 r (q <
// 4, r < 2) that a depthwise warp's store reaches too
__device__ __forceinline__ int sw64(int r, int kc) {
  return r * 64 + ((kc ^ ((r >> 1) & 3)) << 4);
}
__device__ __forceinline__ int swp(int n, int kc) {
  return n * (E_MAX * 2) + ((kc ^ (n & 7)) << 4);
}
__device__ __forceinline__ int sdp(int o, int kc) {
  return o * (E_MAX * 2) +
         ((kc ^ (o & 7) ^ (((o >> 3) & 1) << 1) ^ ((o >> 6) & 1)) << 4);
}
// ldmatrix x4 and mma.sync m16n8k16 bf16 -> f32 (c += a . b) as the
// tensor-core warps use them: the ldmatrix stays in order with the
// barriers (volatile) but lets the epilogues' stores move past it (no
// memory clobber: they write other buffers); the mma touches registers
// only, so the compiler may interleave the products of several tiles
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float bf_at(const unsigned char* p) {
  return __uint_as_float((uint32_t)*reinterpret_cast<const uint16_t*>(p)
                         << 16);
}
__device__ __forceinline__ uint16_t bf_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Whether bf16(v) (bf16(relu(v)) when RELU) holds for every value within
// m of v; 4u |v| more covers the roundings of v -+ m.
template <bool RELU>
__device__ __forceinline__ bool certain(float v, float m) {
  const float d = fmaf(fabsf(v), 0x1p-22f, m);
  float lo = __fsub_rn(v, d), hi = __fadd_rn(v, d);
  if (RELU) {
    lo = fmaxf(lo, 0.f);
    hi = fmaxf(hi, 0.f);
  }
  const uint32_t b = tail::pack_bf16x2(lo, hi);
  return (b & 0xffffu) == (b >> 16);
}

// Reserves n consecutive entries of a shared list for this lane, one
// atomicAdd a warp (every lane of the warp calls it); returns the first.
__device__ __forceinline__ int warp_reserve(int* count, int n) {
  const int lane = threadIdx.x & 31;
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  int base = 0;
  if (lane == 31 && incl) base = atomicAdd(count, incl);
  return __shfl_sync(0xffffffffu, base, 31) + incl - n;
}

struct Unit {
  int img, r0, c0;
};
__device__ __forceinline__ Unit unit_at(long long u, int nby, int nbx) {
  const long long q = u / nbx;
  return {(int)(q / nby), (int)(q % nby) * BR, (int)(u % nbx) * BC};
}

// y of the listed values of unit un (x buffer xb), summed again over E in
// the plain order from the d tile, thread rid of the block's NT; past the
// list's cap, every value of the unit.  Both roles call it: one copy.
__device__ __noinline__ void repair_y(unsigned char* smem, const Unit& un,
                                         int xb, int h, int w, int e_dim,
                                         int residual,
                                         __nv_bfloat16* __restrict__ out,
                                         int rid) {
  const int listed = reinterpret_cast<const int*>(smem + OFF_CNT)[2];
  const uint16_t* ylist = reinterpret_cast<const uint16_t*>(smem + OFF_YL);
  const float* bps = reinterpret_cast<const float*>(smem + OFF_OC);
  const unsigned char* xs = smem + OFF_XS + xb * XS_BYTES;
  const int todo = listed > YCAP ? NPO * C : listed;
  __nv_bfloat16* on = out + (size_t)un.img * h * w * C;
#pragma unroll 1
  for (int i = rid; i < todo; i += 2 * NT) {
    // two values a pass, two independent chains
    int o[2], c[2];
    bool ok[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int iv = i + v * NT;
      const int e = iv >= todo ? (listed > YCAP ? i : ylist[i])
                               : (listed > YCAP ? iv : ylist[iv]);
      o[v] = e >> 5;
      c[v] = e & 31;
      ok[v] = iv < todo && un.r0 + (o[v] >> 4) < h && un.c0 + (o[v] & 15) < w;
    }
    float p[2] = {0.f, 0.f};
#pragma unroll 1
    for (int kc = 0; kc < e_dim / 8; ++kc)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        float dv[8], wv[8];
        tail::unpack8(
            *reinterpret_cast<const uint4*>(smem + OFF_DP + sdp(o[v], kc)),
            dv);
        tail::unpack8(*reinterpret_cast<const uint4*>(smem + OFF_WP +
                                                      swp(c[v], kc)),
                      wv);
#pragma unroll
        for (int i8 = 0; i8 < 8; ++i8) p[v] = fmaf(dv[i8], wv[i8], p[v]);
      }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      if (!ok[v]) continue;
      float y = __fadd_rn(p[v], bps[c[v]]);
      const int px = ((o[v] >> 4) + 1) * PC + (o[v] & 15) + 1;
      if (residual)
        y = __fadd_rn(y, bf_at(xs + sw64(px, c[v] >> 3) + (c[v] & 7) * 2));
      on[((size_t)(un.r0 + (o[v] >> 4)) * w + un.c0 + (o[v] & 15)) * C +
         c[v]] = __float2bfloat16_rn(y);
    }
  }
}

// The check form's phase timer (CHECK): clock64 cycles a thread spends in
// each phase, summed; thread 0 (tensor-core warps) and thread TCT
// (depthwise warps) of each block add theirs to the check counters.
enum Phase {
  TC_START, TC_WAIT, TC_EXPAND, TC_PROJECT, TC_Y_TEST, TC_Y_REPAIR,
  DW_WAIT, DW_DEPTHWISE, DW_D_TEST, DW_D_REPAIR, DW_Y_REPAIR, N_PHASES
};
template <bool ON>
struct Phases {
  unsigned t[N_PHASES];
  long long last;
  __device__ __forceinline__ void start() {
    if constexpr (ON) {
#pragma unroll
      for (int i = 0; i < N_PHASES; ++i) t[i] = 0;
      last = clock64();
    }
  }
  // the time since the last tick, to phase p
  __device__ __forceinline__ void tick(int p) {
    if constexpr (ON) {
      const long long now = clock64();
      t[p] += (unsigned)(now - last);
      last = now;
    }
  }
  __device__ __forceinline__ void flush(unsigned long long* out) {
    if constexpr (ON) {
#pragma unroll
      for (int i = 0; i < N_PHASES; ++i) atomicAdd(out + i, t[i]);
    }
  }
};

// CHECK: the check form (dgt_mbconv_counted), which also counts the
// values each test left to the repair into check[0] (d) and check[1] (y)
// and times the phases into check[2 ..]; the frame path runs !CHECK.
template <bool EXPAND, bool CHECK>
__global__ void __launch_bounds__(NT, 1)
mbconv_kernel(const __nv_bfloat16* __restrict__ x,
              __nv_bfloat16* __restrict__ out,
              const __nv_bfloat16* __restrict__ we,
              const __nv_bfloat16* __restrict__ be,
              const __nv_bfloat16* __restrict__ wd,
              const __nv_bfloat16* __restrict__ bd,
              const __nv_bfloat16* __restrict__ wp,
              const __nv_bfloat16* __restrict__ bp, int h, int w, int e_dim,
              int residual, long long units,
              unsigned long long* __restrict__ check) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned sbase = tail::smem_addr(smem);
  float* wds = reinterpret_cast<float*>(smem + OFF_WD);
  float* bes = reinterpret_cast<float*>(smem + OFF_CH);
  float* bds = bes + E_MAX;
  float* alpha = bds + E_MAX;
  float* beta = alpha + E_MAX;
  float* bps = reinterpret_cast<float*>(smem + OFF_OC);
  float* wpn = bps + C;
  float* xn = reinterpret_cast<float*>(smem + OFF_XN);
  uint16_t* dlist = reinterpret_cast<uint16_t*>(smem + OFF_DL);
  uint16_t* ylist = reinterpret_cast<uint16_t*>(smem + OFF_YL);
  int* cnt = reinterpret_cast<int*>(smem + OFF_CNT);   // d[2], y
  const int tid = threadIdx.x;
  const int nby = (h + BR - 1) / BR, nbx = (w + BC - 1) / BC;
  const int nch = e_dim / EC;
  const uint16_t* weu = reinterpret_cast<const uint16_t*>(we);
  const uint16_t* wpu = reinterpret_cast<const uint16_t*>(wp);

  // ---- the weights, once a block
  if (EXPAND)
    for (int i = tid; i < e_dim * 4; i += NT) {
      const int n = i >> 2, kc = i & 3;
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = weu[(8 * kc + 2 * q) * e_dim + n] |
               ((uint32_t)weu[(8 * kc + 2 * q + 1) * e_dim + n] << 16);
      *reinterpret_cast<uint4*>(smem + OFF_WE + sw64(n, kc)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  for (int i = tid; i < C * (e_dim / 8); i += NT) {
    const int n = i / (e_dim / 8), kc = i % (e_dim / 8);
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = wpu[(8 * kc + 2 * q) * C + n] |
             ((uint32_t)wpu[(8 * kc + 2 * q + 1) * C + n] << 16);
    *reinterpret_cast<uint4*>(smem + OFF_WP + swp(n, kc)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  for (int i = tid; i < 9 * e_dim; i += NT)
    wds[i / e_dim * E_MAX + i % e_dim] = __bfloat162float(wd[i]);
  for (int k = tid; k < e_dim; k += NT) {
    const float bk = __bfloat162float(bd[k]);
    bds[k] = bk;
    if (EXPAND) {
      const float b = __bfloat162float(be[k]);
      float ww = 0.f, wdd = 0.f;
      for (int c = 0; c < C; ++c) {
        const float v = __bfloat162float(we[c * e_dim + k]);
        ww = fmaf(v, v, ww);
      }
      for (int t = 0; t < 9; ++t)
        wdd += fabsf(__bfloat162float(wd[t * e_dim + k]));
      bes[k] = b;
      alpha[k] = SLACK * sqrtf(ww) *
                 (ERR_MMA_EXPAND + tail::up1_err_twin(C) + ROUND_E);
      beta[k] = SLACK * (ROUND_E * wdd * fabsf(b) + 2.f * U * fabsf(bk));
    }
  }
  if (tid < C) {
    float s = 0.f;
    for (int k = 0; k < e_dim; ++k) {
      const float v = __bfloat162float(wp[k * C + tid]);
      s = fmaf(v, v, s);
    }
    bps[tid] = __bfloat162float(bp[tid]);
    wpn[tid] = sqrtf(s);
  }
  if (tid < 4) cnt[tid] = 0;
  __syncthreads();

  const long long first = blockIdx.x, stride = gridDim.x;
  Phases<CHECK> ph;
  ph.start();
  const long long my_chunks = (units - first + stride - 1) / stride * nch;

  if (tid < TCT) {
    // ================= tensor-core warps: expand, project, the y test
    const int lane = tid & 31, warp = tid >> 5, g8 = lane >> 2, t4 = lane & 3;
    const float ky = ERR_MMA_PROJECT + PLAIN_Y + ROUND_Y;

    auto load_x = [&](long long u, int b) {
      const Unit un = unit_at(u, nby, nbx);
      const __nv_bfloat16* xi = x + (size_t)un.img * h * w * C;
      for (int i = tid; i < NPP * 4; i += TCT) {
        const int px = i >> 2, kc = i & 3;
        const int y = un.r0 - 1 + px / PC, xx = un.c0 - 1 + px % PC;
        const bool ok = y >= 0 && y < h && xx >= 0 && xx < w;
        tail::cp_async16(sbase + OFF_XS + b * XS_BYTES + sw64(px, kc),
                         ok ? xi + ((size_t)y * w + xx) * C + kc * 8 : x, ok);
      }
      tail::cp_async_commit();
    };

    // p, and per output |d|^2 and the sum over chunk boundaries of the
    // largest |p| over the lane's 8 channels
    float pacc[MPW][4][4], dn[MPW][2], pm[MPW][2];
    auto zero = [&]() {
#pragma unroll
      for (int m = 0; m < MPW; ++m) {
        dn[m][0] = dn[m][1] = pm[m][0] = pm[m][1] = 0.f;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pacc[m][n][e] = 0.f;
      }
    };

    // e of chunk j into e buffer b from x buffer xb
    auto expand = [&](int j, int b, int xb, const Unit& un) {
      float* es = reinterpret_cast<float*>(smem + OFF_ES + b * ES_BYTES);
      const unsigned char* xs = smem + OFF_XS + xb * XS_BYTES;
      if constexpr (EXPAND) {
        // e^T = we^T x^T: M the chunk's 16 channels (A, we^T, held for the
        // chunk), N 8 patch pixels an n-tile (B, the x patch's rows), K 32
        uint32_t aw[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          ldsm4(aw[ks], sbase + OFF_WE +
                            sw64(EC * j + (lane & 7) + 8 * ((lane >> 3) & 1),
                                 2 * ks + (lane >> 4)));
        const float b0 = bes[EC * j + g8], b1 = bes[EC * j + g8 + 8];
        const unsigned xsa = sbase + OFF_XS + xb * XS_BYTES;
        float* e0 = es + g8 * ES_PLANE;
        float* e1 = es + (g8 + 8) * ES_PLANE;
#pragma unroll 2
        for (int nt = warp; nt < NT_E; nt += NTC) {
          uint32_t bx[4];
          ldsm4(bx,
                xsa + sw64(min(8 * nt + (lane & 7), NPP - 1), lane >> 3));
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          mma16816(acc, aw[0], bx[0], bx[1]);
          mma16816(acc, aw[1], bx[2], bx[3]);
          // pixels m, m + 1 of one patch row (m even, PC even)
          const int m = 8 * nt + 2 * t4;
          if (m >= NPP) continue;
          const int pr = m / PC, pc = m % PC;
          const int y = un.r0 - 1 + pr, xx = un.c0 - 1 + pc;
          const bool row = y >= 0 && y < h;
          const bool in0 = row && xx >= 0 && xx < w;
          const bool in1 = row && xx + 1 >= 0 && xx + 1 < w;
          const int at = pr * ES_ROW + pc;
          *reinterpret_cast<float2*>(e0 + at) = make_float2(
              in0 ? fmaxf(__fadd_rn(acc[0], b0), 0.f) : 0.f,
              in1 ? fmaxf(__fadd_rn(acc[1], b0), 0.f) : 0.f);
          *reinterpret_cast<float2*>(e1 + at) = make_float2(
              in0 ? fmaxf(__fadd_rn(acc[2], b1), 0.f) : 0.f,
              in1 ? fmaxf(__fadd_rn(acc[3], b1), 0.f) : 0.f);
        }
      } else {
        // no expand: e = x (zero outside the image already)
        for (int i = tid; i < NPP * EC; i += TCT) {
          const int px = i >> 4, cl = i & 15, k = EC * j + cl;
          es[cl * ES_PLANE + px / PC * ES_ROW + px % PC] =
              bf_at(xs + sw64(px, k >> 3) + (k & 7) * 2);
        }
      }
    };

    // p += d[:, chunk j] . wp[chunk j, :] for the warp's four output rows;
    // before it, each output's largest |p| over the lane's 8 channels
    // joins pm
    auto project = [&](int j) {
      uint32_t bw[2][4];
#pragma unroll
      for (int pr = 0; pr < 2; ++pr)
        ldsm4(bw[pr], sbase + OFF_WP +
                          swp(16 * pr + (lane & 7) + 8 * (lane >> 4),
                              2 * j + ((lane >> 3) & 1)));
#pragma unroll
      for (int m = 0; m < MPW; ++m) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float mx = 0.f;
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mx = fmaxf(mx, fmaxf(fabsf(pacc[m][n][2 * hf]),
                                 fabsf(pacc[m][n][2 * hf + 1])));
          pm[m][hf] += mx;
        }
        const int orow = MPW * warp + m;
        uint32_t a[4];
        ldsm4(a, sbase + OFF_DP +
                     sdp(BC * orow + (lane & 7) + 8 * ((lane >> 3) & 1),
                         2 * j + (lane >> 4)));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float lo = tail::bf_lo(a[r]), hi = tail::bf_hi(a[r]);
          dn[m][r & 1] = fmaf(hi, hi, fmaf(lo, lo, dn[m][r & 1]));
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma16816(pacc[m][n], a, bw[n >> 1][2 * (n & 1)],
                   bw[n >> 1][2 * (n & 1) + 1]);
      }
    };

    // y of a unit from p and its x buffer xb where the test makes it
    // certain; the rest listed, and summed again by every thread of the
    // block (repair_y); the d tile stays until then
    auto finish = [&](const Unit& un, int xb, int dready) {
      bar_sync(DREADY + dready, NT);
      ph.tick(TC_WAIT);
      project(nch - 1);
      ph.tick(TC_PROJECT);
      const unsigned char* xs = smem + OFF_XS + xb * XS_BYTES;
      __nv_bfloat16* on = out + (size_t)un.img * h * w * C;
#pragma unroll
      for (int m = 0; m < MPW; ++m) {
        float pn[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float s = dn[m][hf];
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          pn[hf] = sqrtf(s);
        }
        const int orow = MPW * warp + m, y = un.r0 + orow;
        uint32_t unsure = 0;   // bit (hf n e) of the uncertain values
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int ocol = g8 + 8 * hf, xx = un.c0 + ocol;
          if (y >= h || xx >= w) continue;
          const int px = (orow + 1) * PC + ocol + 1;
          __nv_bfloat16* op = on + ((size_t)y * w + xx) * C;
          const float pms = PLAIN_Y * pm[m][hf];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int c = 8 * n + 2 * t4;
            const uint32_t xv2 = *reinterpret_cast<const uint32_t*>(
                xs + sw64(px, c >> 3) + (c & 7) * 2);
            float yv[2];
            bool ok[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float xv = residual ? (e ? tail::bf_hi(xv2)
                                             : tail::bf_lo(xv2)) : 0.f;
              const float s = __fadd_rn(pacc[m][n][2 * hf + e], bps[c + e]);
              yv[e] = residual ? __fadd_rn(s, xv) : s;
              const float mg = SLACK * (pn[hf] * wpn[c + e] * ky + pms +
                                        ROUND_Y * fabsf(bps[c + e]) +
                                        2.f * U * fabsf(xv));
              ok[e] = certain<false>(yv[e], mg);
            }
            if (ok[0] && ok[1]) {
              *reinterpret_cast<uint32_t*>(op + c) =
                  bf_bits(yv[0]) | ((uint32_t)bf_bits(yv[1]) << 16);
            } else {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (ok[e])
                  op[c + e] = __float2bfloat16_rn(yv[e]);
                else
                  unsure |= 1u << (8 * hf + 2 * n + e);
              }
            }
          }
        }
        int at = warp_reserve(cnt + 2, __popc(unsure));
        for (; unsure; unsure &= unsure - 1, ++at) {
          const int bit = __ffs(unsure) - 1;
          if (at < YCAP)
            ylist[at] = (uint16_t)(((orow * BC + g8 + 8 * (bit >> 3)) << 5) |
                                   (8 * ((bit >> 1) & 3) + 2 * t4 + (bit & 1)));
        }
      }
      ph.tick(TC_Y_TEST);
      bar_sync(YB, NT);
      if (CHECK && tid == 0)
        atomicAdd(check + 1, (unsigned long long)cnt[2]);
      repair_y(smem, un, xb, h, w, e_dim, residual, out, tid);
      bar_sync(YB, NT);
      if (tid == 0) cnt[2] = 0;
      zero();
      ph.tick(TC_Y_REPAIR);
    };

    zero();
    load_x(first, 0);
    long long g = 0;
    int it = 0;
    Unit prev{0, 0, 0};
    // one pass more than the block has units: after its first chunk (none
    // in the last pass) each pass finishes the previous unit, so finish
    // runs from one place
    for (long long u = first;; u += stride, ++it) {
      const bool more = u < units;
      const Unit un = more ? unit_at(u, nby, nbx) : prev;
      const int xb = it & 1;
      if (more) {
        // the unit's x patch, and |x| a patch pixel
        tail::cp_async_wait<0>();
        bar_sync(TCB, TCT);
        if constexpr (EXPAND) {
          const unsigned char* xs = smem + OFF_XS + xb * XS_BYTES;
          for (int px = tid; px < NPP; px += TCT) {
            float s = 0.f;
#pragma unroll
            for (int kc = 0; kc < 4; ++kc) {
              float v[8];
              tail::unpack8(
                  *reinterpret_cast<const uint4*>(xs + sw64(px, kc)), v);
#pragma unroll
              for (int i = 0; i < 8; ++i) s = fmaf(v[i], v[i], s);
            }
            xn[xb * (XN_BYTES / 4) + px / PC * ES_ROW + px % PC] = sqrtf(s);
          }
        }
        ph.tick(TC_START);
        const int b = (int)(g & 1);
        if (g >= 2) bar_sync(EMPTY + b, NT);
        ph.tick(TC_WAIT);
        expand(0, b, xb, un);
        bar_arrive(FULL + b, NT);
        ph.tick(TC_EXPAND);
      }
      // the previous unit's last chunk and y, while DW starts this one
      if (it >= 1) finish(prev, xb ^ 1, (int)((g - 1) & 1));
      if (!more) break;
      if (u + stride < units) load_x(u + stride, xb ^ 1);
      ph.tick(TC_START);
      ++g;
      for (int j = 1; j < nch; ++j, ++g) {
        const int b = (int)(g & 1);
        if (g >= 2) bar_sync(EMPTY + b, NT);
        ph.tick(TC_WAIT);
        expand(j, b, xb, un);
        bar_arrive(FULL + b, NT);
        ph.tick(TC_EXPAND);
        bar_sync(DREADY + (b ^ 1), NT);
        ph.tick(TC_WAIT);
        project(j - 1);
        ph.tick(TC_PROJECT);
      }
      prev = un;
    }
    if (tid == 0) ph.flush(check + 2);
  } else {
    // ================= depthwise warps: d, its test and repair
    const int dt = tid - TCT, lane = dt & 31, warp = dt >> 5;
    // lane: 4 columns q, 2 row blocks, 4 channels; warp: 2 row blocks, 4
    // channel groups (a quarter-warp reads one channel's plane)
    const int q = lane & 3, rb = ((lane >> 2) & 1) | ((warp & 1) << 1);
    const int cl = (lane >> 3) | ((warp >> 1) << 2);
    long long g = 0;
    int it = 0;
    for (long long u = first; u < units; u += stride, ++it) {
      const Unit un = unit_at(u, nby, nbx);
      const unsigned char* xs = smem + OFF_XS + (it & 1) * XS_BYTES;
      const float* xnu = xn + (it & 1) * (XN_BYTES / 4) + 4 * rb * ES_ROW +
                         4 * q;
      for (int j = 0; j < nch; ++j, ++g) {
        const int b = (int)(g & 1), k = EC * j + cl;
        bar_sync(FULL + b, NT);
        ph.tick(DW_WAIT);
        if (dt == 0) cnt[b ^ 1] = 0;
        float w9[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) w9[t] = wds[t * E_MAX + k];
        const float bk = bds[k];
        const float* ep = reinterpret_cast<const float*>(
                              smem + OFF_ES + b * ES_BYTES) +
                          cl * ES_PLANE + 4 * rb * ES_ROW + 4 * q;
        // acc: the depthwise in the plain order; mag: sum over the taps of
        // |wd| (alpha_k |x| + 20u e), the d test's margin less beta_k
        // (e >= 0)
        float acc[4][4], mag[4][4], wa[9];
        float al = 0.f, bt = 0.f;
        if (EXPAND) al = alpha[k], bt = beta[k];
#pragma unroll
        for (int o = 0; o < 4; ++o)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[o][c] = mag[o][c] = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) wa[t] = fabsf(w9[t]);
        // patch rows 4 rb + i, each added into output rows 4 rb + i - dr:
        // every output takes tap rows 0, 1, 2 in turn, columns 0, 1, 2
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float4 c4 = *reinterpret_cast<const float4*>(ep + i * ES_ROW);
          const float2 c2 =
              *reinterpret_cast<const float2*>(ep + i * ES_ROW + 4);
          const float v[6] = {c4.x, c4.y, c4.z, c4.w, c2.x, c2.y};
          float z[6];
          if (EXPAND) {
            const float4 n4 =
                *reinterpret_cast<const float4*>(xnu + i * ES_ROW);
            const float2 n2 =
                *reinterpret_cast<const float2*>(xnu + i * ES_ROW + 4);
            const float xr[6] = {n4.x, n4.y, n4.z, n4.w, n2.x, n2.y};
#pragma unroll
            for (int j = 0; j < 6; ++j)
              z[j] = fmaf(al, xr[j], SLACK * ROUND_DW * v[j]);
          }
#pragma unroll
          for (int o = 0; o < 4; ++o) {
            const int dr = i - o;
            if (dr < 0 || dr > 2) continue;
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
              for (int dc = 0; dc < 3; ++dc) {
                acc[o][c] = __fadd_rn(acc[o][c],
                                      __fmul_rn(v[c + dc], w9[3 * dr + dc]));
                if (EXPAND)
                  mag[o][c] = fmaf(wa[3 * dr + dc], z[c + dc], mag[o][c]);
              }
          }
        }
        if (g + 2 < my_chunks) bar_arrive(EMPTY + b, NT);
        ph.tick(DW_DEPTHWISE);
        uint32_t unsure = 0;   // bit 4 o + c of the uncertain values
        // where d of output (4 rb + o, 4 q + c) goes: its swizzle does not
        // depend on o
        unsigned char* dst[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dst[c] = smem + OFF_DP + sdp(4 * rb * BC + 4 * q + c, k >> 3) +
                   (k & 7) * 2;
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          float v[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            v[c] = __fadd_rn(acc[o][c], bk);
            if (EXPAND && !certain<true>(v[c], mag[o][c] + bt))
              unsure |= 1u << (4 * o + c);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c)
            *reinterpret_cast<uint16_t*>(dst[c] + o * (BC * E_MAX * 2)) =
                bf_bits(fmaxf(v[c], 0.f));
        }
        if constexpr (EXPAND) {
          int at = warp_reserve(cnt + b, __popc(unsure));
          for (; unsure; unsure &= unsure - 1, ++at) {
            const int bit = __ffs(unsure) - 1;
            if (at < DCAP)
              dlist[at] = (uint16_t)((((4 * rb + (bit >> 2)) * BC + 4 * q +
                                       (bit & 3)) << 4) | cl);
          }
        }
        if constexpr (EXPAND) {
          ph.tick(DW_D_TEST);
          bar_sync(DWB, DWT);
          const int listed = cnt[b];
          const int todo = listed > DCAP ? NPO * EC : listed;
#pragma unroll 1
          for (int i = dt; i < todo; i += DWT) {
            const int e = listed > DCAP ? i : dlist[i];
            const int o = e >> 4, kk = EC * j + (e & 15);
            const int orow = o / BC, ocol = o % BC;
            float wc[C];
#pragma unroll
            for (int kc = 0; kc < 4; ++kc)
              tail::unpack8(*reinterpret_cast<const uint4*>(
                                smem + OFF_WE + sw64(kk, kc)),
                            wc + 8 * kc);
            // the 9 taps' sums side by side: 9 independent chains, each
            // over input channels 0..31 in turn
            float s9[9];
            int px[9];
#pragma unroll
            for (int t = 0; t < 9; ++t) {
              s9[t] = 0.f;
              px[t] = (orow + t / 3) * PC + ocol + t % 3;
            }
#pragma unroll
            for (int kc = 0; kc < 4; ++kc)
#pragma unroll
              for (int t = 0; t < 9; ++t) {
                float xv8[8];
                tail::unpack8(
                    *reinterpret_cast<const uint4*>(xs + sw64(px[t], kc)),
                    xv8);
#pragma unroll
                for (int i8 = 0; i8 < 8; ++i8)
                  s9[t] = fmaf(xv8[i8], wc[8 * kc + i8], s9[t]);
              }
            const float bek = bes[kk];
            float a = 0.f;
#pragma unroll
            for (int t = 0; t < 9; ++t) {
              const int y = un.r0 - 1 + orow + t / 3;
              const int xx = un.c0 - 1 + ocol + t % 3;
              const float ev = y >= 0 && y < h && xx >= 0 && xx < w
                                   ? fmaxf(__fadd_rn(s9[t], bek), 0.f)
                                   : 0.f;
              a = __fadd_rn(a, __fmul_rn(ev, wds[t * E_MAX + kk]));
            }
            *reinterpret_cast<uint16_t*>(smem + OFF_DP + sdp(o, kk >> 3) +
                                         (kk & 7) * 2) =
                bf_bits(fmaxf(__fadd_rn(a, bds[kk]), 0.f));
          }
          if (CHECK && dt == 0)
            atomicAdd(check, (unsigned long long)listed);
        }
        bar_arrive(DREADY + b, NT);
        ph.tick(EXPAND ? DW_D_REPAIR : DW_D_TEST);
      }
      // the unit's y repair, with the tensor-core warps
      bar_sync(YB, NT);
      repair_y(smem, un, it & 1, h, w, e_dim, residual, out, tid);
      bar_sync(YB, NT);
      ph.tick(DW_Y_REPAIR);
    }
    if (dt == 0) ph.flush(check + 2);
  }
}

template <bool EXPAND, bool CHECK>
cudaError_t occupancy(int* smem, int* blocks) {
  *smem = SMEM;
  const auto kernel = mbconv_kernel<EXPAND, CHECK>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, NT,
                                                       SMEM);
}

template <bool EXPAND, bool CHECK>
cudaError_t launch(const void* x, void* out, const void* we, const void* be,
                   const void* wd, const void* bd, const void* wp,
                   const void* bp, int n, int h, int w, int e_dim,
                   int residual, unsigned long long* check,
                   cudaStream_t stream) {
  int smem, blocks, dev, sms;
  cudaError_t e = occupancy<EXPAND, CHECK>(&smem, &blocks);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  const long long units = (long long)n * ((h + BR - 1) / BR) *
                          ((w + BC - 1) / BC);
  const long long cap = (long long)sms * blocks;
  const int grid = (int)(units < cap ? units : cap);
  using bf = __nv_bfloat16;
  mbconv_kernel<EXPAND, CHECK><<<grid, NT, smem, stream>>>(
      static_cast<const bf*>(x), static_cast<bf*>(out),
      static_cast<const bf*>(we), static_cast<const bf*>(be),
      static_cast<const bf*>(wd), static_cast<const bf*>(bd),
      static_cast<const bf*>(wp), static_cast<const bf*>(bp), h, w, e_dim,
      residual, units, check);
  return cudaGetLastError();
}

template <bool CHECK>
int run(const void* x, void* out, const void* we, const void* be,
        const void* wd, const void* bd, const void* wp, const void* bp, int n,
        int h, int w, int e_dim, int residual, unsigned long long* check,
        void* stream) {
  if (n < 1 || h < 1 || w < 1 || e_dim < C || e_dim % C || e_dim > E_MAX ||
      (!we && e_dim != C) || (we && !be))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      we ? launch<true, CHECK>(x, out, we, be, wd, bd, wp, bp, n, h, w,
                               e_dim, residual, check, st)
         : launch<false, CHECK>(x, out, we, be, wd, bd, wp, bp, n, h, w,
                                e_dim, residual, check, st);
  return (int)e;
}

}  // namespace

// Launches one inverted residual on `stream`; returns the cudaError_t of the
// launch.  we == null runs the block without an expand (e_dim must be 32).
extern "C" int dgt_mbconv(const void* x, void* out, const void* we,
                          const void* be, const void* wd, const void* bd,
                          const void* wp, const void* bp, int n, int h, int w,
                          int e_dim, int residual, void* stream) {
  return run<false>(x, out, we, be, wd, bd, wp, bp, n, h, w, e_dim,
                    residual, nullptr, stream);
}

// The kernel's check form, which no frame path runs: dgt_mbconv that also
// adds, into check[0] and check[1] (zeroed unsigned 64-bit counters on the
// card, 2 + N_PHASES of them), the number of d and of y values whose
// rounding the margins left uncertain, so that the repair recomputed them
// in the plain order, and into check[2 + p] the clock64 cycles that the
// first thread of each role spent in phase p (Phase), summed over blocks.
extern "C" int dgt_mbconv_counted(const void* x, void* out, const void* we,
                                  const void* be, const void* wd,
                                  const void* bd, const void* wp,
                                  const void* bp, int n, int h, int w,
                                  int e_dim, int residual, void* check,
                                  void* stream) {
  if (!check) return (int)cudaErrorInvalidValue;
  return run<true>(x, out, we, be, wd, bd, wp, bp, n, h, w, e_dim, residual,
                   static_cast<unsigned long long*>(check), stream);
}

// The margins' parts as compiled: err[0] the plain order's part at the
// expand (gamma_31), err[1] the tensor core's (ERR_MMA_EXPAND), err[2] the
// tensor core's at the project (ERR_MMA_PROJECT), err[3] the plain order's
// there (PLAIN_Y, a chunk's partial sums), err[4] to err[6] the allowances
// for the roundings between a sum and its test (ROUND_E at + be, ROUND_DW
// in the depthwise, ROUND_Y); geom the unit's output rows and cols, the
// expanded channels a chunk, and the threads a block (ops/mbconv.py
// mirrors them).  Returns the cudaError_t.
extern "C" int dgt_mbconv_params(float* err, int* geom) {
  err[0] = tail::up1_err_twin(C);
  err[1] = ERR_MMA_EXPAND;
  err[2] = ERR_MMA_PROJECT;
  err[3] = PLAIN_Y;
  err[4] = ROUND_E;
  err[5] = ROUND_DW;
  err[6] = ROUND_Y;
  geom[0] = BR;
  geom[1] = BC;
  geom[2] = EC;
  geom[3] = NT;
  return (int)cudaSuccess;
}

// Dynamic shared memory and resident blocks an SM of the kernel with
// (expand = 1) or without the expand, as its launch sets them.
extern "C" int dgt_mbconv_occupancy(int expand, int* smem, int* blocks) {
  return (int)(expand ? occupancy<true, false>(smem, blocks)
                      : occupancy<false, false>(smem, blocks));
}
