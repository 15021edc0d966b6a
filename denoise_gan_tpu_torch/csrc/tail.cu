// Fused FSRGAN tail for Hopper (sm_90a): up1 -> up2 -> output conv -> tanh
// -> crop-stitch -> uint8 (or bf16 canvas), one launch per frame.
//
// Replaces the TPU kernel denoise_gan_tpu/ops/pallas/tail.py::_tail_kernel
// in all its modes (bf16, w8a8, qh8) and both epilogues (u8, canvas).  Its
// plain PyTorch twins are ops/tail.py::fused_tail_u8_reference and
// fused_tail_canvas_reference; the wrappers are ops/tail.py::fused_tail_u8
// and fused_tail_canvas.
//
// Input: the body output h, NHWC tiles (n_tiles, core_rows+4, 124, 32),
// contiguous: bf16, or int8 in qh8 mode (ops/tail.py::quantize_h).  Output:
// the (4*height, 4*width, 3) frame, uint8 (u8 epilogue) or the bf16 tanh
// (canvas epilogue).  The core of tile (ty, tx) is coarse rows [2, 2+cr) x
// cols [2, 122), i.e. fine [8, 8+4cr) x [8, 488), and lands at fine (ty*4cr,
// tx*480) of the frame; the ragged bottom and right edges are masked.  A
// core pixel depends on its own tile only; reads outside the tile return
// zero (per-tile SAME padding), which no core pixel reaches.
//
// What bounds it on the H100: arithmetic.  A 1080p frame (128 tiles of
// 139x124) needs ~0.41 T multiply-adds (up1 76 G, up2 306 G, the output
// conv 29 G) while it moves only the 141 MB of bf16 h (71 MB int8) in and
// the 100 MB of u8 (199 MB of bf16 canvas) out.  So the design keeps every
// intermediate on chip and puts the products on the tensor cores:
// * up2 is an implicit GEMM on mma.sync: M = positions of the 2x grid, N =
//   the 128 conv outputs in four 32-column phase slabs (channel q =
//   (a*2+b)*32 + t goes to depth_to_space phase (a, b), channel t), K = 9
//   taps x 32 channels.  Its A rows are u1 rows gathered through the
//   depth_to_space addressing (one ldmatrix row address a lane).  int8
//   m16n8k32 with int32 sums (exact in any order) in w8a8 and qh8, bf16
//   m16n8k16 in bf16, each product summed from zero and added to the f32
//   sums with round-to-nearest (add_mma).
// * The 3x3 output conv is a GEMM too: M = fine pixels, N = 3 padded to 8,
//   K = 288, its B fragments precomputed in shared memory.  A lane gives
//   one A row address, so in the int8 modes the two taps that reach the
//   neighbouring 4-column group (tile-local output column 4j, tap dx = 0;
//   4j+3, dx = 2) read R quantised from its bf16 copy, as the JAX kernel
//   (tail.py:439-453), from a half-width second copy (only R columns
//   = 1, 2 mod 4 of the block are read through it).
// * up1 is the same GEMM over h patch pixels.  qh8: int8, exact.  w8a8:
//   bf16 products with f32 sums, which the tensor cores take in another
//   order than the twin's (tap-major, then input channel, one fmaf at a
//   time); where that moves u1 across an int8 step the frame moves by u8
//   levels.  So, as csrc/tail_srgan.cu, a tensor-core value is kept only
//   where its int8 step is certain within ERR * |x| |w| of the sum (ERR =
//   tail_common.cuh::up1_err(288): gamma_287, proven for the twin's order,
//   plus the tensor core's allowance 2**-16, which chip_smoke.py's phase
//   3b holds at 10x the mma.sync distance it measures at k = 288), and the
//   uncertain values (a few %) are listed and summed again in the twin's
//   order by fmaf while W1's tap slices, streamed by cp.async through a
//   2-stage ring, pass once more (tail_common.cuh::repair): u1 is the
//   twin's bit for bit.  bf16 would leave most values
//   uncertain (its rounding grid is dense), so there up1 runs on the CUDA
//   cores in the twin's order: a thread owns 8 channels x 11 positions (88
//   sums), h is f32 in shared memory (pixel stride 33 floats, so the
//   warp's two positions fall on different banks), the W1 slices are
//   unpacked from bf16 in registers.  A warp never interleaves FMAs with
//   mma.syncs in one stream (the probe K7).
// * Blocking: a block is BR x BC = 15 x 8 core positions (135 = 9 x 15
//   rows, 120 = 15 x 8 cols): h patch 19 x 12, up1 at 17 x 10 = 170
//   positions (1.42x the 120 it feeds), up2 at 32 x 18 = 576 (1.2x).  R on
//   the 4x grid (64 x 36 pixels) would not fit twice an SM, so up2 runs in
//   NCHUNK chunks of CH 2x rows (9 m16 tiles), each writing its R rows into
//   a ring of RR rows, and the output conv consumes the rows each chunk
//   completes, a warp an output row (its two m16 tiles side by side).
//   up2's weights (int8 36.9 KB, bf16 73.7 KB) stay resident, so its warps
//   walk over units of an m16 tile x NSU phase slabs (A loaded once for
//   them) with no barrier.
// * Bank conflicts: shared rows are 16-byte chunks, the chunk index XORed
//   with bits of the row (u1: the position; R: the column; weights: k or
//   k/4; h: the pixel), so the 8 rows of an ldmatrix matrix or the 8
//   lanes of a 16-byte load fall on different chunks of a 128-byte bank row.
// * Epilogues in the accumulator's layout: dequant (int32 * s + b) or + b,
//   PReLU, then u1 or R stored int8 q(v / s_act) (w8a8, qh8) or bf16; the
//   output conv's dequant or + b3, tanh, bf16 rounding, u8 =
//   trunc(clip((v+1)*127.5+0.5)) or the bf16 value (canvas).
// q(x) rounds half to even and clips to +-127; u1 and R are quantised from
// f32.  So qh8 sums exactly what the twin sums, and w8a8 too once up1 is
// repaired: both match it bit for bit; bf16 differs where the f32 sums of
// up2 and the output conv round apart.
//
// Shared memory (Layout::total): qh8 107,520 bytes, w8a8 101,120 (2 blocks
// an SM), bf16 170,880 (one).  Registers (ptxas): bf16 128 (the up1
// tile's 88 sums, its ci loop unrolled 2x: 4x spilled), w8a8 126, qh8 96;
// no spills.  In bf16 up1 (CUDA cores) takes about half the time; the
// rest is bound by instruction issue (epilogues, addressing) more than by
// the tensor cores (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tail_common.cuh"

namespace {

using namespace tail;

constexpr int CIN = 32;            // body channels
constexpr int C1 = 128;            // up1/up2 conv outputs (4 phases x 32)
constexpr int NSLAB = C1 / CIN;    // 32-column phase slabs of a GEMM's N
constexpr int NSU = 2;             // slabs a warp's GEMM unit
constexpr int NUNIT = NSLAB / NSU; // units an m16 tile
constexpr int BR = 15;             // core rows per block (135 = 9 x 15)
constexpr int BC = 8;              // core cols per block (120 = 15 x 8)
constexpr int NT = 256;            // threads per block
constexpr int NWARP = NT / 32;

constexpr int HR = BR + 4, HC = BC + 4;          // h patch
constexpr int NPIX = HR * HC;                    // 228
constexpr int UR = BR + 2, UC = BC + 2;          // up1 positions
constexpr int NP1 = UR * UC;                     // 170
constexpr int NT1 = (NP1 + 15) / 16;             // up1's m16 tiles (qh8)
constexpr int YR = 2 * BR + 2, YC = 2 * BC + 2;  // up2 positions (2x grid)
constexpr int CH = 8;                            // 2x rows a chunk
constexpr int NCHUNK = YR / CH;                  // 4
constexpr int T2 = CH * YC / 16;                 // up2's m16 tiles a chunk
constexpr int FC = 2 * YC;                       // R columns
constexpr int RBC = FC / 2;                      // R's bf16 copy: columns
constexpr int RR = 2 * CH + 2;                   // R ring rows
constexpr int OR = 4 * BR, OC = 4 * BC;          // output pixels
constexpr int HS = CIN + 1;                      // f32 h: floats a pixel
constexpr int MP = 11;                           // up1 positions a thread
constexpr int CAP = 2048;                        // w8a8's repair list
constexpr int RPT = 4;                           // its entries a thread
static_assert(YR % CH == 0 && CH * YC % 16 == 0, "whole m16 tiles a chunk");
static_assert(2 * YR - 4 >= OR - 1, "the last chunk completes every row");
static_assert(OC == 32, "an output row is two m16 tiles");
static_assert(NT == 16 * 16 && 16 * MP >= NP1, "up1: 16 x 16 thread tiles");

// output rows the chunks complete: chunk k ends at out_hi(k)
__device__ __forceinline__ int out_hi(int k) {
  return min(2 * CH * (k + 1) - 4, OR - 1);
}

template <int MODE>
struct Layout {
  static constexpr bool Q8 = MODE != BF16;       // u1, R, W2 int8
  static constexpr bool H8 = MODE == QH8;        // h, W1 int8
  static constexpr bool TC1 = MODE == W8A8;      // up1 on the tensor cores
  // up1's margin, relative to |x| |w| (0: no repair)
  static constexpr float ERR = TC1 ? up1_err(9 * CIN) : 0.f;
  static constexpr int u_px = Q8 ? C1 : 2 * C1;  // u1 bytes a position
  static constexpr int r_px = Q8 ? CIN : 2 * CIN;  // R bytes a pixel
  static constexpr int w_bytes = 9 * CIN * C1 * (Q8 ? 1 : 2);
  // the constants (f32): b1, s1, b2, s2, a1, a2, b3, s3; the output conv's
  // B fragments (uint2 a lane: 9 taps, x 2 k-steps in bf16)
  static constexpr int cst_off = 0;
  static constexpr int w3f_off = 2432;
  static constexpr int u_off = w3f_off + 9 * 32 * 8 * (Q8 ? 1 : 2);
  static constexpr int w2_off = u_off + NP1 * u_px;
  // region X: during up1 the h patch (qh8 int8, w8a8 bf16, bf16 f32) and
  // W1 (qh8: resident int8; else a 2-stage ring of bf16 tap slices), and
  // w8a8's repair buffers; after it, the R ring and (int8 modes) R's bf16
  // copy
  static constexpr int x_off = w2_off + w_bytes;
  static constexpr int h_bytes =
      H8 ? NPIX * CIN
         : TC1 ? NPIX * 2 * CIN : (NPIX * HS * 4 + 127) / 128 * 128;
  static constexpr int w1_off = x_off + h_bytes;
  static constexpr int slice = CIN * C1 * 2;     // a bf16 W1 tap slice
  static constexpr int ring_end = w1_off + (H8 ? w_bytes : 2 * slice);
  // w8a8's repair: sum h^2 a patch pixel; sum W1^2 a channel (2 row
  // groups, then the norm); the list's count; the list
  static constexpr int pix_off = ring_end;
  static constexpr int col_off = pix_off + 1024;
  static constexpr int ctl_off = col_off + 3 * C1 * 4;
  static constexpr int list_off = ctl_off + 128;
  static constexpr int up1_end = TC1 ? list_off + CAP * 2 : ring_end;
  static constexpr int rs_off = x_off;
  static constexpr int rb_off = rs_off + RR * FC * r_px;
  static constexpr int r_end = rb_off + (Q8 ? RR * RBC * r_px : 0);
  static constexpr int total = up1_end > r_end ? up1_end : r_end;
  static_assert(u_off % 128 == 0 && w2_off % 128 == 0 && x_off % 128 == 0 &&
                    w1_off % 128 == 0 && rb_off % 128 == 0,
                "shared buffers start on a bank row");
  static_assert(NPIX * 4 <= 1024 && NP1 * C1 < 65536, "repair buffers");
};
// offsets of the constants, in floats
constexpr int CB1 = 0, CS1 = C1, CB2 = 2 * C1, CS2 = 3 * C1, CA1 = 4 * C1,
              CA2 = 4 * C1 + CIN, CB3 = 4 * C1 + 2 * CIN, CS3 = CB3 + 4;
static_assert((CS3 + 4) * 4 <= Layout<BF16>::w3f_off, "constants fit");

// The XOR applied to a 16-byte chunk index.  u1 position p: int8 (8 chunks)
// bits 0 and 2 from p's low 2 bits, bf16 (16 chunks) bits 0-1.
template <bool Q8>
__device__ __forceinline__ int u_swz(int p) {
  return Q8 ? (p & 1) | ((p & 2) << 1) : p & 3;
}
// R column k: int8 (2 chunks a pixel) bit 2 of k, bf16 (4 chunks) bits 1-2;
// also qh8's h patch pixel (2 chunks)
template <bool Q8>
__device__ __forceinline__ int r_swz(int k) {
  return Q8 ? (k >> 2) & 1 : (k >> 1) & 3;
}
// weights: int8 word row kw (4 k) chunk ^ (kw & 3) << 1; bf16 row k ^ (k & 7)
__device__ __forceinline__ int w8_swz(int kw) { return (kw & 3) << 1; }

// One tap's rows of an int8 (72, 128) word matrix (8 rows, one chunk a
// thread) or a bf16 (288, 128) matrix (32 rows) into its resident copy.
template <bool I8>
__device__ __forceinline__ void load_tap(unsigned dst, const void* w, int tap,
                                         int tid) {
  const unsigned char* wb = static_cast<const unsigned char*>(w);
  if constexpr (I8) {
    static_assert(NT == 8 * 32, "one chunk a thread");
    const int kw = tap * 8 + (tid >> 5), c = tid & 31;
    cp_async16(dst + kw * 512 + ((c ^ w8_swz(kw)) << 4),
               wb + kw * 512 + c * 16, true);
  } else {
#pragma unroll
    for (int i = tid; i < 32 * 16; i += NT) {
      const int k = tap * 32 + (i >> 4), c = i & 15;
      cp_async16(dst + k * 256 + ((c ^ (k & 7)) << 4),
                 wb + k * 256 + c * 16, true);
    }
  }
}

// W1's bf16 slice of tap `tap` (32 rows k of 128 values) into ring stage
// st; with SWZ (w8a8, read by ldmatrix.trans) chunk c of row k at
// c ^ (k & 7), else in place
template <bool SWZ>
__device__ __forceinline__ void load_slice(unsigned st, const void* w1,
                                           int tap, int tid) {
  const unsigned char* wb =
      static_cast<const unsigned char*>(w1) + tap * CIN * C1 * 2;
#pragma unroll
  for (int i = tid; i < CIN * C1 * 2 / 16; i += NT) {
    const int k = i >> 4, c = i & 15;
    cp_async16(st + k * 256 + ((SWZ ? c ^ (k & 7) : c) << 4), wb + i * 16,
               true);
  }
}

// c += a . b, m16n8k16 bf16, the product summed from zero and added to c
// in f32 with round-to-nearest.  mma.sync's own f32 accumulation truncates;
// chained over up2's or the output conv's 18 k-steps it moved the bf16
// canvas off the twin's on 2.04e-3 of the values at the 1x2x24 geometry of
// tests/test_torch_cuda.py (bound 2e-3).
__device__ __forceinline__ void add_mma(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  float d[4];
  mma_bf16_z(d, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], d[e]);
}

// The warp's products for one unit, an m16 tile x NS phase slabs s0..,
// over the 9 taps: acc[i][j] += A . B_j for slab s0 + i's 4 n8 tiles, A
// loaded once a k-step for all NS slabs.  arow(tap) is the lane's ldmatrix
// row address for the tap without its chunk; achunk(tap, ks) its chunk,
// XORed.  int8 (I8): one m16n8k32 k-step a tap; B by two 16-byte loads a
// slab from the resident word matrix at s_w, whose slab columns are read
// as tile j's column g = channel 32s + 4g + j, so lane (g, t) takes words
// 32s + 4g.. of rows 8 tap + t and 8 tap + 4 + t and ends up holding
// channels 32s + 8t.. 32s + 8t + 7.  bf16: two m16n8k16 k-steps a tap,
// each added by add_mma, B by ldmatrix.trans from [k][n] rows; lane (g, t)
// holds channels 32s + 8j + 2t, + 1.
template <bool I8, int NS, typename acc_t, typename RowFn, typename ChunkFn>
__device__ __forceinline__ void gemm_unit(acc_t (&acc)[NS][4][4], RowFn arow,
                                          ChunkFn achunk, unsigned s_w,
                                          int s0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, csel = lane >> 4;
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
#pragma unroll 3
  for (int tap = 0; tap < 9; ++tap) {
    const unsigned row = arow(tap);
    if constexpr (I8) {
      uint32_t a[4];
      ldsm_x4(a, row + (achunk(tap, csel) << 4));
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        uint32_t b0[4], b1[4];
        const unsigned c = ((8 * (s0 + i) + g) ^ w8_swz(t)) << 4;
        lds128(b0, s_w + (8 * tap + t) * 512 + c);
        lds128(b1, s_w + (8 * tap + 4 + t) * 512 + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a, b0[j], b1[j]);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, row + (achunk(tap, 2 * ks + csel) << 4));
        const int k = 32 * tap + 16 * ks + lr;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          uint32_t b[2][4];
#pragma unroll
          for (int jp = 0; jp < 2; ++jp)
            ldsm_x4_trans(b[jp], s_w + k * 256 +
                                     (((4 * (s0 + i) + 2 * jp + csel) ^
                                       (k & 7)) << 4));
#pragma unroll
          for (int j = 0; j < 4; ++j)
            add_mma(acc[i][j], a, b[j >> 1][2 * (j & 1)],
                    b[j >> 1][2 * (j & 1) + 1]);
        }
      }
    }
  }
}

// 8 int8 q(v * inv) as one 8-byte word
__device__ __forceinline__ uint2 pack_s8x8(const float* v, float inv) {
  return make_uint2(pack_s8x4(v, inv), pack_s8x4(v + 4, inv));
}

template <int MODE, bool CANVAS>
__global__ void __launch_bounds__(NT, 2)
tail_kernel(const unsigned char* __restrict__ h, void* __restrict__ outv,
            const void* __restrict__ w1v, const float* __restrict__ b1,
            const float* __restrict__ a1, const void* __restrict__ w2v,
            const float* __restrict__ b2, const float* __restrict__ a2,
            const void* __restrict__ w3v, const float* __restrict__ b3,
            const float* __restrict__ s1, const float* __restrict__ s2,
            const float* __restrict__ s3, float inv_su1, float inv_sr,
            int nx, int core_rows, int height, int width, int bgr) {
  using L = Layout<MODE>;
  constexpr bool Q8 = L::Q8, H8 = L::H8;
  using out_t =
      typename std::conditional<CANVAS, __nv_bfloat16, uint8_t>::type;
  using acc_t = typename std::conditional<Q8, int, float>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  float* cst = reinterpret_cast<float*>(smem + L::cst_off);
  const uint2* w3f = reinterpret_cast<const uint2*>(smem + L::w3f_off);
  unsigned char* u1s = smem + L::u_off;
  out_t* out = static_cast<out_t*>(outv);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, csel = lane >> 4;
  const int c0 = blockIdx.x * BC;   // first core col (core coords)
  const int r0 = blockIdx.y * BR;   // first core row
  const int n = blockIdx.z;
  const int tr = core_rows + 4;
  const unsigned s_u = smem_addr(u1s);
  const unsigned s_w2 = smem_addr(smem + L::w2_off);
  const unsigned s_x = smem_addr(smem + L::x_off);
  const unsigned s_w1 = smem_addr(smem + L::w1_off);
  const unsigned char* hn = h + (size_t)n * tr * T * (H8 ? CIN : 2 * CIN);

  // ---- stage 0: the h patch (tile rows r0.., cols c0..; zero outside the
  // tile) and W1 (qh8: all of it; else tap 0's slice) by cp.async, except
  // bf16 h, which is widened to f32 on the way; the constants and the
  // output conv's B fragments by plain stores.  up2's weights follow, one
  // tap a step of up1 (qh8: all at once, after W1).
  if constexpr (H8) {
    for (int i = tid; i < NPIX * 2; i += NT) {
      const int P = i >> 1, c = i & 1;
      const int y = r0 + P / HC, x = c0 + P % HC;
      const bool ok = y < tr && x < T;
      cp_async16(s_x + P * CIN + ((c ^ r_swz<true>(P)) << 4),
                 ok ? hn + ((size_t)y * T + x) * CIN + c * 16 : hn, ok);
    }
    for (int tap = 0; tap < 9; ++tap) load_tap<true>(s_w1, w1v, tap, tid);
    cp_async_commit();
    for (int tap = 0; tap < 9; ++tap) load_tap<true>(s_w2, w2v, tap, tid);
    cp_async_commit();
  } else if constexpr (L::TC1) {
    for (int i = tid; i < NPIX * 4; i += NT) {
      const int P = i >> 2, c = i & 3;
      const int y = r0 + P / HC, x = c0 + P % HC;
      const bool ok = y < tr && x < T;
      cp_async16(s_x + P * 2 * CIN + ((c ^ r_swz<false>(P)) << 4),
                 ok ? hn + ((size_t)y * T + x) * 2 * CIN + c * 16 : hn, ok);
    }
    load_slice<true>(s_w1, w1v, 0, tid);
    cp_async_commit();
  } else {
    load_slice<false>(s_w1, w1v, 0, tid);
    cp_async_commit();
    float* hs = reinterpret_cast<float*>(smem + L::x_off);
    for (int i = tid; i < NPIX * 4; i += NT) {
      const int P = i >> 2, c = i & 3;
      const int y = r0 + P / HC, x = c0 + P % HC;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (y < tr && x < T)
        v = __ldg(reinterpret_cast<const uint4*>(
            hn + ((size_t)y * T + x) * 2 * CIN + c * 16));
      float f[8];
      unpack8(v, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) hs[P * HS + 8 * c + e] = f[e];
    }
  }
  for (int i = tid; i < C1; i += NT) {
    cst[CB1 + i] = b1[i];
    cst[CB2 + i] = b2[i];
    if constexpr (H8) cst[CS1 + i] = s1[i];
    if constexpr (Q8) cst[CS2 + i] = s2[i];
  }
  if (tid < CIN) {
    cst[CA1 + tid] = a1[tid];
    cst[CA2 + tid] = a2[tid];
  }
  if (tid < 3) {
    cst[CB3 + tid] = b3[tid];
    if constexpr (Q8) cst[CS3 + tid] = s3[tid];
  }
  {
    // B fragments of the output conv, N = 3 padded to 8: lane (g, t) of
    // k-step ks holds column g (0 for g >= 3); int8 words k/4 = 8 tap + t
    // and + 4 of the (3, 72) packing, bf16 pairs k = 32 tap + 16 ks + 2t,
    // + 1 and + 8, + 9 of the (288, 3) matrix
    uint2* w3d = reinterpret_cast<uint2*>(smem + L::w3f_off);
    for (int i = tid; i < 9 * 32 * (Q8 ? 1 : 2); i += NT) {
      const int step = i >> 5, gg = (i & 31) >> 2, tt = i & 3;
      uint2 v = make_uint2(0u, 0u);
      if (gg < 3) {
        if constexpr (Q8) {
          const int* w3 = static_cast<const int*>(w3v);
          v = make_uint2(w3[gg * 72 + step * 8 + tt],
                         w3[gg * 72 + step * 8 + 4 + tt]);
        } else {
          const uint16_t* w3 = static_cast<const uint16_t*>(w3v);
          const int k = step * 16 + 2 * tt;
          v = make_uint2(w3[k * 3 + gg] | (uint32_t)w3[(k + 1) * 3 + gg] << 16,
                         w3[(k + 8) * 3 + gg] |
                             (uint32_t)w3[(k + 9) * 3 + gg] << 16);
        }
      }
      w3d[i] = v;
    }
  }

  // ---- stage 1: up1 at U1 position p = (i, j), tile (r0+1+i, c0+1+j),
  // reading h patch (i+dy, j+dx); stored at u1 row p, channel q (the conv's
  // channel: phase block q / 32)
  if constexpr (H8) {
    cp_async_wait<1>();
    __syncthreads();
    for (int u = warp; u < NT1 * NUNIT; u += NWARP) {
      const int tile = u / NUNIT, s0 = u % NUNIT * NSU;
      const int p = min(tile * 16 + lr, NP1 - 1);
      const int P0 = (p / UC) * HC + p % UC;
      int acc[NSU][4][4];
      gemm_unit<true, NSU>(
          acc,
          [&](int tap) {
            return s_x + (P0 + (tap / 3) * HC + tap % 3) * CIN;
          },
          [&](int tap, int c) {
            return c ^ r_swz<true>(P0 + (tap / 3) * HC + tap % 3);
          },
          s_w1, s0, lane);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int pp = tile * 16 + g + 8 * hr;
        if (pp >= NP1) continue;
#pragma unroll
        for (int i = 0; i < NSU; ++i) {
          const int s = s0 + i;
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {   // channel q = 32s + 8t + e
            const int q = 32 * s + 8 * t + e;
            v[e] = prelu(dequant(acc[i][e & 3][2 * hr + (e >> 2)],
                                 cst[CS1 + q], cst[CB1 + q]),
                         cst[CA1 + (q & 31)]);
          }
          *reinterpret_cast<uint2*>(
              u1s + pp * L::u_px +
              (((2 * s + (t >> 1)) ^ u_swz<true>(pp)) << 4) + (t & 1) * 8) =
              pack_s8x8(v, inv_su1);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  } else if constexpr (L::TC1) {
    // w8a8: up1 as a GEMM over h patch pixels, bf16 m16n8k16 with f32 sums
    // (chained, as chip_smoke.py's phase 3b measures them), W1's tap slices
    // through the ring, two passes of one m16 tile x all 4 slabs a warp.
    // A value is kept where its int8 step is certain within ERR |x| |w|
    // (|x| the position's 288 inputs, |w| the channel's W1 column; both
    // sums lie that close to the exact one), else listed and summed again
    // in the twin's order while the slices pass once more (the repair).
    float* pix_sq = reinterpret_cast<float*>(smem + L::pix_off);
    float* colsq = reinterpret_cast<float*>(smem + L::col_off);
    int* ctl = reinterpret_cast<int*>(smem + L::ctl_off);
    uint16_t* list = reinterpret_cast<uint16_t*>(smem + L::list_off);
    if (tid == 0) ctl[0] = 0;
    int q = 0;    // ring step: tap q % 9 in stage q & 1
    // wait for step q's slice; then (no warp reads the other stage any
    // more) start the next one, with up2's rows of tap q in the first 9
    const auto step = [&]() {
      cp_async_wait<0>();
      __syncthreads();
      load_slice<true>(s_w1 + ((q + 1) & 1) * L::slice, w1v, (q + 1) % 9,
                       tid);
      if (q < 9) load_tap<true>(s_w2, w2v, q, tid);
      cp_async_commit();
    };
    const auto pixel = [](int p) { return (p / UC) * HC + p % UC; };
    const int cc = tid & (C1 - 1), rg = tid >> 7;   // W1 column norms
    float wsq = 0.f;
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const int tile = pass * NWARP + warp;
      const bool active = tile < NT1;
      const int P0 = pixel(min(tile * 16 + lr, NP1 - 1));
      float acc[NSLAB][4][4];
#pragma unroll
      for (int i = 0; i < NSLAB; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap, ++q) {
        step();
        const unsigned sl = s_w1 + (q & 1) * L::slice;
        if (pass == 0) {
          if (tap == 0)                   // the patch has landed
            for (int P = tid; P < NPIX; P += NT) {
              float sum = 0.f, x[8];
#pragma unroll
              for (int k8 = 0; k8 < 4; ++k8) {
                unpack8(*reinterpret_cast<const uint4*>(
                            smem + L::x_off + P * 2 * CIN + k8 * 16), x);
#pragma unroll
                for (int e = 0; e < 8; ++e) sum = fmaf(x[e], x[e], sum);
              }
              pix_sq[P] = sum;
            }
          const unsigned char* slp = smem + L::w1_off + (q & 1) * L::slice;
#pragma unroll
          for (int k = 16 * rg; k < 16 * rg + 16; ++k) {
            const float w = w16_at<C1>(slp, k, cc);
            wsq = fmaf(w, w, wsq);
          }
        }
        if (!active) continue;
        const int P = P0 + (tap / 3) * HC + tap % 3;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t a[4];
          ldsm_x4(a, s_x + P * 2 * CIN +
                         (((2 * ks + csel) ^ r_swz<false>(P)) << 4));
          const int k = 16 * ks + lr;
#pragma unroll
          for (int i = 0; i < NSLAB; ++i) {
            uint32_t b[2][4];
#pragma unroll
            for (int jp = 0; jp < 2; ++jp)
              ldsm_x4_trans(b[jp], sl + k * 256 +
                                       (((4 * i + 2 * jp + csel) ^ (k & 7))
                                        << 4));
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_bf16(acc[i][j], a, b[j >> 1][2 * (j & 1)],
                       b[j >> 1][2 * (j & 1) + 1]);
          }
        }
      }
      if (pass == 0) {                    // |W1 column|, rounded up
        colsq[rg * C1 + cc] = wsq;
        __syncthreads();
        if (tid < C1)
          colsq[2 * C1 + tid] =
              sqrtf(colsq[tid] + colsq[C1 + tid]) * (1.f + 0x1p-10f);
        __syncthreads();
      }
      if (!active) continue;
      // epilogue: u1 for the lane's rows g, g + 8, channels 32s + 8j + 2t,
      // + 1: int8 pairs, and the uncertain values listed
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int p = tile * 16 + g + 8 * hr;
        if (p >= NP1) continue;
        const int Pp = pixel(p);
        float xnorm = 0.f;               // ERR * |x|, rounded up
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          xnorm += pix_sq[Pp + (tap / 3) * HC + tap % 3];
        xnorm = sqrtf(xnorm) * (L::ERR * (1.f + 0x1p-10f));
#pragma unroll
        for (int i = 0; i < NSLAB; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = 32 * i + 8 * j + 2 * t;
            uint32_t pair = 0;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float z = acc[i][j][2 * hr + e] + cst[CB1 + c + e];
              const float a = cst[CA1 + ((c + e) & 31)];
              if (!up1_certain<true>(z, a, xnorm, colsq[2 * C1 + c + e],
                                     inv_su1))
                list_add(&ctl[0], list, CAP, p * C1 + c + e);
              pair |= (uint32_t)(quant(prelu(z, a), inv_su1) & 0xff)
                      << (8 * e);
            }
            *reinterpret_cast<uint16_t*>(
                u1s + p * C1 + (((c >> 4) ^ u_swz<true>(p)) << 4) +
                (c & 15)) = (uint16_t)pair;
          }
      }
    }
    // the repair: the listed values (all of them, if the list overflowed)
    // summed one product at a time in the twin's order, RPT a thread a
    // cycle of the 9 slices
    __syncthreads();
    const int listed = ctl[0];
    const int todo = listed > CAP ? NP1 * C1 : listed;
    repair<CIN, C1, NT, RPT>(
        repair_cycles<NT, RPT>(todo), listed, CAP, todo, list, tid,
        [&]() {
          step();
          return smem + L::w1_off + (q++ & 1) * L::slice;
        },
        [&](int p, int tap, int& sw) {
          const int P = pixel(p) + (tap / 3) * HC + tap % 3;
          sw = r_swz<false>(P);
          return smem + L::x_off + P * 2 * CIN;
        },
        [&](int p, int c, float sum) {
          u1s[p * C1 + (((c >> 4) ^ u_swz<true>(p)) << 4) + (c & 15)] =
              (unsigned char)(quant(prelu(sum + cst[CB1 + c],
                                          cst[CA1 + (c & 31)]),
                                    inv_su1) &
                              0xff);
        });
    cp_async_wait<0>();
    __syncthreads();
  } else {
    // bf16: up1 on the CUDA cores in the twin's order (a tensor-core sum
    // would leave most bf16 roundings uncertain).  A thread: channels
    // 8cg..8cg+7 of positions pg + 16m; W1's slice of
    // tap `tap` in ring stage tap & 1, loaded one step ahead, with up2's
    // rows of the tap
    const int cg = tid & 15, pg = tid >> 4;
    const float* hs = reinterpret_cast<const float*>(smem + L::x_off);
    int base[MP];
#pragma unroll
    for (int m = 0; m < MP; ++m) {
      const int p = min(pg + 16 * m, NP1 - 1);
      base[m] = ((p / UC) * HC + p % UC) * HS;
    }
    float acc[MP][8];
#pragma unroll
    for (int m = 0; m < MP; ++m)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[m][c] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      cp_async_wait<0>();
      __syncthreads();
      if (tap + 1 < 9)
        load_slice<false>(s_w1 + ((tap + 1) & 1) * L::slice, w1v, tap + 1,
                          tid);
      load_tap<false>(s_w2, w2v, tap, tid);
      cp_async_commit();
      const unsigned char* sl = smem + L::w1_off + (tap & 1) * L::slice;
      const float* hp = hs + ((tap / 3) * HC + tap % 3) * HS;
#pragma unroll 2
      for (int ci = 0; ci < CIN; ++ci) {
        float w[8];
        unpack8(*reinterpret_cast<const uint4*>(sl + ci * 2 * C1 + cg * 16),
                w);
#pragma unroll
        for (int m = 0; m < MP; ++m) {
          const float x = hp[base[m] + ci];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[m][c] = fmaf(x, w[c], acc[m][c]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MP; ++m) {
      const int p = pg + 16 * m;
      if (p >= NP1) continue;
      float v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int q = 8 * cg + c;
        v[c] = prelu(acc[m][c] + cst[CB1 + q], cst[CA1 + (q & 31)]);
      }
      *reinterpret_cast<uint4*>(u1s + p * L::u_px +
                                ((cg ^ u_swz<false>(p)) << 4)) =
          make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                     pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // ---- stages 2 and 3, chunk by chunk.  up2 on the 2x grid of
  // depth_to_space(u1): output (Y, X) reads d1 (Y+du, X+dv) = U1
  // ((Y+du)/2, (X+dv)/2), phase block ((Y+du)&1)*2 + ((X+dv)&1); slab s =
  // (a, b) of its output is R at (2Y+a, 2X+b), ring row (2Y+a) % RR.  Then
  // the output conv: output (oy, ox) = tile fine (8+4*r0+oy, 8+4*c0+ox)
  // reads R (oy+1+dy, ox+1+dx); its tile-local column is 4j + (ox & 3).
  const int ty = n / nx, tx = n % nx;
#pragma unroll 1
  for (int k = 0; k < NCHUNK; ++k) {
    for (int u = warp; u < T2 * NUNIT; u += NWARP) {
      const int tile = u / NUNIT, s0 = u % NUNIT * NSU;
      const int m = tile * 16 + lr;                  // the lane's A row
      const int Y = CH * k + m / YC, X = m % YC;
      acc_t acc[NSU][4][4];
      const auto pos = [&](int tap) {
        return ((Y + tap / 3) >> 1) * UC + ((X + tap % 3) >> 1);
      };
      const auto phase = [&](int tap) {
        return ((Y + tap / 3) & 1) * 2 + ((X + tap % 3) & 1);
      };
      gemm_unit<Q8, NSU>(
          acc, [&](int tap) { return s_u + pos(tap) * L::u_px; },
          [&](int tap, int c) {
            return ((Q8 ? 2 : 4) * phase(tap) + c) ^ u_swz<Q8>(pos(tap));
          },
          s_w2, s0, lane);
      // epilogue: R for the lane's rows g, g + 8
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int mm = tile * 16 + g + 8 * hr;
        const int Y2 = CH * k + mm / YC, X2 = mm % YC;
#pragma unroll
        for (int i = 0; i < NSU; ++i) {
          const int s = s0 + i;
          const int rho = 2 * Y2 + (s >> 1), kap = 2 * X2 + (s & 1);
          unsigned char* rrow = smem + L::rs_off + (rho % RR) * FC * L::r_px;
          if constexpr (Q8) {
            float v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {   // R channel 8t + e
              const int q = 32 * s + 8 * t + e;
              v[e] = prelu(dequant(acc[i][e & 3][2 * hr + (e >> 2)],
                                   cst[CS2 + q], cst[CB2 + q]),
                           cst[CA2 + 8 * t + e]);
            }
            *reinterpret_cast<uint2*>(
                rrow + kap * CIN + (((t >> 1) ^ r_swz<true>(kap)) << 4) +
                (t & 1) * 8) = pack_s8x8(v, inv_sr);
            if ((kap & 3) == 1 || (kap & 3) == 2) {   // read by the edge taps
              const int kb = (kap >> 2) * 2 + (kap & 3) - 1;
#pragma unroll
              for (int e = 0; e < 8; ++e) v[e] = round_bf16(v[e]);
              *reinterpret_cast<uint2*>(
                  smem + L::rb_off + ((rho % RR) * RBC + kb) * CIN +
                  (((t >> 1) ^ r_swz<true>(kb)) << 4) + (t & 1) * 8) =
                  pack_s8x8(v, inv_sr);
            }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {   // R channels 8j + 2t, + 1
              const int c = 8 * j + 2 * t, q = 32 * s + c;
              *reinterpret_cast<uint32_t*>(
                  rrow + kap * 2 * CIN + ((j ^ r_swz<false>(kap)) << 4) +
                  4 * t) =
                  pack_bf16x2(
                      prelu(acc[i][j][2 * hr] + cst[CB2 + q], cst[CA2 + c]),
                      prelu(acc[i][j][2 * hr + 1] + cst[CB2 + q + 1],
                            cst[CA2 + c + 1]));
            }
          }
        }
      }
    }
    __syncthreads();
    const int lo = k ? out_hi(k - 1) + 1 : 0, hi = out_hi(k);
    for (int oy = lo + warp; oy <= hi; oy += NWARP) {
      // an output row: its two m16 tiles (ox0 = 0, 16) side by side, the
      // B fragment shared
      acc_t acc[2][4] = {};
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dx = tap % 3, slot = (oy + 1 + tap / 3) % RR;
        if constexpr (Q8) {
          const uint2 b = w3f[tap * 32 + lane];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int ox = 16 * m + lr, kap = ox + 1 + dx;   // the A row
            const bool edge = (dx == 0 && (ox & 3) == 0) ||
                              (dx == 2 && (ox & 3) == 3);
            const int kb = (kap >> 2) * 2 + (kap & 3) - 1;
            uint32_t a[4];
            ldsm_x4(a, edge ? s_x + (L::rb_off - L::x_off) +
                                 (slot * RBC + kb) * CIN +
                                 ((csel ^ r_swz<true>(kb)) << 4)
                            : s_x + (slot * FC + kap) * CIN +
                                 ((csel ^ r_swz<true>(kap)) << 4));
            mma_s8(acc[m], a, b.x, b.y);
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const uint2 b = w3f[(2 * tap + ks) * 32 + lane];
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const int kap = 16 * m + lr + 1 + dx;
              uint32_t a[4];
              ldsm_x4(a, s_x + (slot * FC + kap) * 2 * CIN +
                             (((2 * ks + csel) ^ r_swz<false>(kap)) << 4));
              add_mma(acc[m], a, b.x, b.y);
            }
          }
        }
      }
      // lanes t = 0, 1 hold output channels 2t, 2t + 1 (< 3) of pixels
      // (oy, 16m + g) and (oy, 16m + g + 8)
      if (t < 2) {
        const int fy = 4 * r0 + oy, gy = ty * 4 * core_rows + fy;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int gx = tx * 4 * CORE + 4 * c0 + 16 * m + g + 8 * hr;
            if (fy >= 4 * core_rows || gy >= 4 * height || gx >= 4 * width)
              continue;
            out_t* dst = out + ((size_t)gy * 4 * width + gx) * 3;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 2 * t + e;
              if (c > 2) continue;
              float y;
              if constexpr (Q8) y = dequant(acc[m][2 * hr + e], cst[CS3 + c],
                                            cst[CB3 + c]);
              else y = acc[m][2 * hr + e] + cst[CB3 + c];
              store_px(dst + (bgr ? 2 - c : c), y);
            }
          }
      }
    }
    if (k + 1 < NCHUNK) __syncthreads();
  }
}

// The kernel's shared-memory attributes, set; its dynamic shared memory and
// resident blocks an SM.
template <int MODE, bool CANVAS>
cudaError_t occupancy(int* smem, int* blocks) {
  *smem = Layout<MODE>::total;
  const auto kernel = tail_kernel<MODE, CANVAS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, NT,
                                                       *smem);
}

template <int MODE, bool CANVAS>
cudaError_t launch(const Args& a, int n_tiles, cudaStream_t stream) {
  int smem, blocks;
  cudaError_t e = occupancy<MODE, CANVAS>(&smem, &blocks);
  if (e != cudaSuccess) return e;
  const dim3 grid(CORE / BC, (a.core_rows + BR - 1) / BR, n_tiles);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  tail_kernel<MODE, CANVAS><<<grid, NT, smem, stream>>>(
      static_cast<const unsigned char*>(a.h), a.out, a.w1, f(a.b1), f(a.a1),
      a.w2, f(a.b2), f(a.a2), a.w3, f(a.b3), f(a.s1), f(a.s2), f(a.s3),
      a.inv_su1, a.inv_sr, a.nx, a.core_rows, a.height, a.width, a.bgr);
  return cudaGetLastError();
}

}  // namespace

// Launches the fused tail on `stream`; returns the cudaError_t of the launch.
// mode (tail_common.cuh::Mode): 0 bf16: h bf16, w1 (288, 128), w2 (288,
// 128) and w3 (288, 3) bf16, s1/s2/s3 unused.  1 w8a8: w2 (72, 128) and w3
// (3, 72) int32 words of 4 int8 along k, s2 (128,) and s3 (3,) f32 dequant
// scales.  2 qh8: as w8a8, with h int8 and w1 (72, 128) int32 words, s1
// (128,).  canvas = 1 writes the bf16 tanh instead of u8 (RGB only).
extern "C" int dgt_tail(const void* h, void* out, const void* w1,
                        const void* b1, const void* a1, const void* w2,
                        const void* b2, const void* a2, const void* w3,
                        const void* b3, const void* s1, const void* s2,
                        const void* s3, float inv_su1, float inv_sr,
                        int mode, int canvas, int n_tiles, int nx,
                        int core_rows, int height, int width, int bgr,
                        void* stream) {
  const Args a{h, out, w1, b1, a1, w2, b2, a2, w3, b3, s1, s2, s3,
               inv_su1, inv_sr, nx, core_rows, height, width, bgr};
  cudaError_t e = check_args(a, mode, canvas, n_tiles);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode * 2 + (canvas ? 1 : 0)) {
    case 0: e = launch<BF16, false>(a, n_tiles, st); break;
    case 1: e = launch<BF16, true>(a, n_tiles, st); break;
    case 2: e = launch<W8A8, false>(a, n_tiles, st); break;
    case 3: e = launch<W8A8, true>(a, n_tiles, st); break;
    case 4: e = launch<QH8, false>(a, n_tiles, st); break;
    default: e = launch<QH8, true>(a, n_tiles, st); break;
  }
  return (int)e;
}

// The kernel's dynamic shared memory (bytes) and resident blocks an SM in a
// mode and epilogue, as the launch sets them up; returns the cudaError_t.
extern "C" int dgt_tail_occupancy(int mode, int canvas, int* smem,
                                  int* blocks) {
  if (mode < BF16 || mode > QH8) return (int)cudaErrorInvalidValue;
  switch (mode * 2 + (canvas ? 1 : 0)) {
    case 0: return (int)occupancy<BF16, false>(smem, blocks);
    case 1: return (int)occupancy<BF16, true>(smem, blocks);
    case 2: return (int)occupancy<W8A8, false>(smem, blocks);
    case 3: return (int)occupancy<W8A8, true>(smem, blocks);
    case 4: return (int)occupancy<QH8, false>(smem, blocks);
    default: return (int)occupancy<QH8, true>(smem, blocks);
  }
}

// The kernel's parameters in a mode, as compiled: err[0] up1's margin
// relative to |x| |w| (0: no repair), err[1] the tensor core's allowance
// within it (tail_common.cuh::UP1_ERR_MMA); geom the block's core rows and
// cols and up2's 2x rows a chunk (ops/tail.py::BLOCK, CHUNK mirror them).
// Returns the cudaError_t.
extern "C" int dgt_tail_params(int mode, float* err, int* geom) {
  if (mode < BF16 || mode > QH8) return (int)cudaErrorInvalidValue;
  err[0] = mode == BF16 ? Layout<BF16>::ERR
           : mode == W8A8 ? Layout<W8A8>::ERR : Layout<QH8>::ERR;
  err[1] = mode == W8A8 ? UP1_ERR_MMA : 0.f;
  geom[0] = BR;
  geom[1] = BC;
  geom[2] = CH;
  return (int)cudaSuccess;
}
