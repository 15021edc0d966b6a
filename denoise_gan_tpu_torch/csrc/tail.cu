// Fused FSRGAN tail for Hopper (sm_90a): up1 -> up2 -> output conv -> tanh
// -> crop-stitch -> uint8, one launch per frame.
//
// Replaces the TPU kernel denoise_gan_tpu/ops/pallas/tail.py::_tail_kernel
// (u8 epilogue; bf16 and w8a8 modes).  Its plain PyTorch twin is
// ops/tail.py::fused_tail_u8_reference; the wrapper is ops/tail.py::
// fused_tail_u8.
//
// Input: the body output h, NHWC tiles (n_tiles, core_rows+4, 124, 32)
// bf16, contiguous.  Output: the (4*height, 4*width, 3) uint8 frame.  The
// core of tile (ty, tx) is coarse rows [2, 2+cr) x cols [2, 122), i.e. fine
// [8, 8+4cr) x [8, 488), and lands at fine (ty*4cr, tx*480) of the frame;
// the ragged bottom and right edges are masked.  A core pixel depends on
// its own tile only; reads outside the tile return zero (per-tile SAME
// padding), which no core pixel reaches.
//
// What bounds it on the H100: arithmetic.  A 1080p frame (128 tiles of
// 139x124) needs ~0.44 T multiply-adds (up2 is 3/4 of them) and this
// blocking recomputes conv halos for ~1.4x that, while it moves only the
// 141 MB of bf16 h in and the 100 MB of u8 out (~0.07 ms at 3.35 TB/s).
// The design keeps every intermediate in shared memory, so device memory
// sees only h and the frame, and spends its time in the three convolutions.
// This first version runs them on the CUDA cores: f32 FMAs on bf16
// operands, __dp4a for the int8 products of w8a8.  Each lane owns 4 output
// channels and each warp a set of positions, so one broadcast 16-byte
// shared load feeds 32 multiply-adds.  Tensor-core products (mma.sync,
// wgmma) are the next step.
//
// Block = (column chunk of BC core cols, band of BR core rows, tile):
//   stage 0: h patch (BR+4) x (BC+4) x 32 -> smem (zero outside the tile)
//   stage 1: up1 at (BR+2) x (BC+2) coarse positions, 128 channels, + b1,
//            PReLU; stored bf16 (bf16 mode) or int8 = q(u1 / su1) (w8a8)
//   stage 2: up2 at (2BR+2) x (2BC+2) positions of the 2x grid, 128
//            channels, + b2 (or int32 * s2 + b2), PReLU; stored on the 4x
//            grid as R: bf16, or int8 = q(R / sr) and q(bf16(R) / sr)
//   stage 3: output conv at 4BR x 4BC fine pixels, + b3 (or int32 * s3 +
//            b3), tanh, bf16 rounding, u8 = trunc(clip((v+1)*127.5+0.5)).
// q(x) rounds half to even and clips to +-127.  u1 and R are quantised
// from f32, except in the two output-conv taps that reach the neighbouring
// 4-column group (tile-local output column 4j, tap dx = 0, and 4j+3, tap
// dx = 2): they read q(bf16(R) / sr), as the JAX kernel (tail.py:439-453).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tail_common.cuh"

namespace {

using namespace tail;

constexpr int CIN = 32;            // body channels
constexpr int C1 = 128;            // up1/up2 conv outputs (4 phases x 32)
constexpr int BR = 5;              // core rows per block (135 = 27 x 5)
constexpr int BC = 8;              // core cols per block (120 = 15 x 8)
constexpr int NT = 256;            // threads per block
constexpr int NWARP = NT / 32;

constexpr int HR = BR + 4, HC = BC + 4;          // h patch
constexpr int UR = BR + 2, UC = BC + 2;          // up1 positions
constexpr int YR = 2 * BR + 2, YC = 2 * BC + 2;  // up2 positions (2x grid)
constexpr int FR = 2 * YR, FC = 2 * YC;          // R on the 4x grid
constexpr int OR = 4 * BR, OC = 4 * BC;          // output pixels

constexpr int NP1 = UR * UC;                     // 70
constexpr int P1 = (NP1 + NWARP - 1) / NWARP;    // 9 per warp
constexpr int NP2 = YR * YC;                     // 216
constexpr int P2 = 9;                            // per warp and pass
constexpr int NPASS2 = (NP2 + NWARP * P2 - 1) / (NWARP * P2);
constexpr int NP3 = OR * OC;                     // 640
constexpr int P3 = (NP3 + NT - 1) / NT;

template <bool Q8>
struct Layout {
  using act_t = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  // output-conv weights: w8a8 int32 words [c][72]; bf16 f32 [tap][c][ch]
  static constexpr int w3_bytes = Q8 ? 3 * 72 * 4 : 9 * 3 * CIN * 4;
  static constexpr int h_bytes = HR * HC * CIN * 2;
  static constexpr int u1_bytes = NP1 * C1 * (int)sizeof(act_t);
  static constexpr int r_bytes = FR * FC * CIN * (int)sizeof(act_t);
  // w8a8: R quantised from its bf16 copy, for the edge taps of stage 3
  static constexpr int rb_bytes = Q8 ? r_bytes : 0;
  static constexpr int h_off = w3_bytes;
  static constexpr int u1_off = h_off + h_bytes;
  static constexpr int r_off = u1_off + u1_bytes;
  static constexpr int rb_off = r_off + r_bytes;
  static constexpr int total = rb_off + rb_bytes;
  static_assert(h_off % 16 == 0 && u1_off % 16 == 0 && r_off % 16 == 0 &&
                    rb_off % 16 == 0,
                "16-byte shared loads need aligned buffers");
};

template <bool Q8>
__global__ void __launch_bounds__(NT, 2)
tail_u8_kernel(const __nv_bfloat16* __restrict__ h, uint8_t* __restrict__ out,
               const __nv_bfloat16* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ a1,
               const void* __restrict__ w2v, const float* __restrict__ b2,
               const float* __restrict__ a2, const void* __restrict__ w3v,
               const float* __restrict__ b3, const float* __restrict__ s2,
               const float* __restrict__ s3, float inv_su1, float inv_sr,
               int nx, int core_rows, int height, int width, int bgr) {
  using L = Layout<Q8>;
  using act_t = typename L::act_t;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem + L::h_off);
  act_t* u1s = reinterpret_cast<act_t*>(smem + L::u1_off);
  act_t* rs = reinterpret_cast<act_t*>(smem + L::r_off);
  act_t* rbs = reinterpret_cast<act_t*>(smem + L::rb_off);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * BC;   // first core col (core coords)
  const int r0 = blockIdx.y * BR;   // first core row
  const int n = blockIdx.z;
  const int tr = core_rows + 4;
  const __nv_bfloat16* hn = h + (size_t)n * tr * T * CIN;

  // ---- stage 0: output-conv weights and the h patch (tile rows r0.., cols
  // c0..) into shared memory
  if constexpr (Q8) {
    const int* w3 = static_cast<const int*>(w3v);            // (3, 72)
    int* w3s = reinterpret_cast<int*>(smem);
    for (int i = tid; i < 3 * 72; i += NT) w3s[i] = w3[i];
  } else {
    const __nv_bfloat16* w3 = static_cast<const __nv_bfloat16*>(w3v);
    float* w3s = reinterpret_cast<float*>(smem);             // (9, 3, 32)
    for (int i = tid; i < 9 * 3 * CIN; i += NT) {
      const int ch = i % CIN, c = (i / CIN) % 3, tap = i / (3 * CIN);
      w3s[i] = __bfloat162float(w3[(tap * CIN + ch) * 3 + c]);
    }
  }
  for (int i = tid; i < HR * HC * 4; i += NT) {
    const int px = i >> 2, part = i & 3;
    const int y = r0 + px / HC, x = c0 + px % HC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (y < tr && x < T)
      v = *reinterpret_cast<const uint4*>(hn + ((size_t)y * T + x) * CIN +
                                          part * 8);
    reinterpret_cast<uint4*>(hs)[i] = v;
  }
  __syncthreads();

  // ---- stage 1: up1 at U1 position (i, j) = tile (r0+1+i, c0+1+j), reading
  // h patch (i+dy, j+dx).  Lane: channels o..o+3; warp: positions warp+8m.
  {
    const int o = lane * 4;
    float acc[P1][4];
#pragma unroll
    for (int m = 0; m < P1; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll 1
      for (int c8 = 0; c8 < CIN; c8 += 8) {
        float w[8][4];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint2 wv = *reinterpret_cast<const uint2*>(
              w1 + (size_t)(tap * CIN + c8 + k) * C1 + o);
          w[k][0] = bf_lo(wv.x); w[k][1] = bf_hi(wv.x);
          w[k][2] = bf_lo(wv.y); w[k][3] = bf_hi(wv.y);
        }
#pragma unroll
        for (int m = 0; m < P1; ++m) {
          const int p = warp + NWARP * m;
          if (p < NP1) {
            const int i = p / UC, j = p % UC;
            float x[8];
            unpack8(*reinterpret_cast<const uint4*>(
                        hs + ((i + dy) * HC + (j + dx)) * CIN + c8), x);
#pragma unroll
            for (int k = 0; k < 8; ++k)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                acc[m][q] = fmaf(x[k], w[k][q], acc[m][q]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < P1; ++m) {
      const int p = warp + NWARP * m;
      if (p < NP1) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = prelu(acc[m][q] + b1[o + q], a1[(o + q) & 31]);
        if constexpr (Q8) {
          *reinterpret_cast<uint32_t*>(u1s + p * C1 + o) =
              pack_s8x4(v, inv_su1);
        } else {
          *reinterpret_cast<uint2*>(u1s + p * C1 + o) =
              make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
        }
      }
    }
  }
  __syncthreads();

  // ---- stage 2: up2 on the 2x grid of depth_to_space(u1).  Output (Y, X)
  // reads d1 (Y+du, X+dv) = U1 ((Y+du)/2, (X+dv)/2), phase block
  // ((Y+du)&1)*2 + ((X+dv)&1).  Conv channel q = (a*2+b)*32 + t goes to R
  // at (2Y+a, 2X+b), channel t.  Lane: channels q0..q0+3 (one phase).
  {
    const int q0 = lane * 4;
    const int pa = q0 >> 6, pb = (q0 >> 5) & 1, t0 = q0 & 31;
#pragma unroll 1
    for (int pass = 0; pass < NPASS2; ++pass) {
      using acc_t = typename std::conditional<Q8, int, float>::type;
      acc_t acc[P2][4];
#pragma unroll
      for (int m = 0; m < P2; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][q] = 0;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int du = tap / 3, dv = tap % 3;
        if constexpr (Q8) {
          const int* w2 = static_cast<const int*>(w2v);      // (72, 128)
#pragma unroll 1
          for (int c16 = 0; c16 < CIN; c16 += 16) {
            int w[4][4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int4 wv = *reinterpret_cast<const int4*>(
                  w2 + (size_t)(tap * 8 + c16 / 4 + k) * C1 + q0);
              w[k][0] = wv.x; w[k][1] = wv.y; w[k][2] = wv.z; w[k][3] = wv.w;
            }
#pragma unroll
            for (int m = 0; m < P2; ++m) {
              const int p = warp + NWARP * (pass * P2 + m);
              if (p < NP2) {
                const int D = p / YC + du, E = p % YC + dv;
                const uint4 a = *reinterpret_cast<const uint4*>(
                    u1s + ((D >> 1) * UC + (E >> 1)) * C1 +
                    ((D & 1) * 2 + (E & 1)) * CIN + c16);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  int s = acc[m][q];
                  s = __dp4a((int)a.x, w[0][q], s);
                  s = __dp4a((int)a.y, w[1][q], s);
                  s = __dp4a((int)a.z, w[2][q], s);
                  s = __dp4a((int)a.w, w[3][q], s);
                  acc[m][q] = s;
                }
              }
            }
          }
        } else {
          const __nv_bfloat16* w2 = static_cast<const __nv_bfloat16*>(w2v);
#pragma unroll 1
          for (int c8 = 0; c8 < CIN; c8 += 8) {
            float w[8][4];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const uint2 wv = *reinterpret_cast<const uint2*>(
                  w2 + (size_t)(tap * CIN + c8 + k) * C1 + q0);
              w[k][0] = bf_lo(wv.x); w[k][1] = bf_hi(wv.x);
              w[k][2] = bf_lo(wv.y); w[k][3] = bf_hi(wv.y);
            }
#pragma unroll
            for (int m = 0; m < P2; ++m) {
              const int p = warp + NWARP * (pass * P2 + m);
              if (p < NP2) {
                const int D = p / YC + du, E = p % YC + dv;
                float x[8];
                unpack8(*reinterpret_cast<const uint4*>(
                            u1s + ((D >> 1) * UC + (E >> 1)) * C1 +
                            ((D & 1) * 2 + (E & 1)) * CIN + c8), x);
#pragma unroll
                for (int k = 0; k < 8; ++k)
#pragma unroll
                  for (int q = 0; q < 4; ++q)
                    acc[m][q] = fmaf(x[k], w[k][q], acc[m][q]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < P2; ++m) {
        const int p = warp + NWARP * (pass * P2 + m);
        if (p < NP2) {
          const int Y = p / YC, X = p % YC;
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float z;
            if constexpr (Q8) z = dequant(acc[m][q], s2[q0 + q], b2[q0 + q]);
            else z = acc[m][q] + b2[q0 + q];
            v[q] = prelu(z, a2[t0 + q]);
          }
          const int at = ((2 * Y + pa) * FC + 2 * X + pb) * CIN + t0;
          if constexpr (Q8) {
            *reinterpret_cast<uint32_t*>(rs + at) = pack_s8x4(v, inv_sr);
            float vb[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) vb[q] = round_bf16(v[q]);
            *reinterpret_cast<uint32_t*>(rbs + at) = pack_s8x4(vb, inv_sr);
          } else {
            *reinterpret_cast<uint2*>(rs + at) =
                make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- stage 3: output conv on the 4x grid.  Output (oy, ox) = tile fine
  // (8+4*r0+oy, 8+4*c0+ox) reads R (oy+1+dy, ox+1+dx); its tile-local
  // column is 4j + (ox & 3).
  const int ty = n / nx, tx = n % nx;
#pragma unroll 1
  for (int m = 0; m < P3; ++m) {
    const int p = tid + NT * m;
    if (p >= NP3) break;
    const int oy = p / OC, ox = p % OC;
    const int fy = 4 * r0 + oy, fx = 4 * c0 + ox;   // fine core coords
    const int gy = ty * 4 * core_rows + fy, gx = tx * 4 * CORE + fx;
    if (fy >= 4 * core_rows || fx >= 4 * CORE || gy >= 4 * height ||
        gx >= 4 * width)
      continue;
    float v[3];
    if constexpr (Q8) {
      const int* w3s = reinterpret_cast<const int*>(smem);
      int acc[3] = {0, 0, 0};
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int dx = tap % 3;
        const bool edge = (dx == 0 && (ox & 3) == 0) ||
                          (dx == 2 && (ox & 3) == 3);
        const act_t* src = (edge ? rbs : rs) +
                           ((oy + 1 + tap / 3) * FC + ox + 1 + dx) * CIN;
#pragma unroll
        for (int c16 = 0; c16 < CIN; c16 += 16) {
          const uint4 a = *reinterpret_cast<const uint4*>(src + c16);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int4 w = *reinterpret_cast<const int4*>(
                w3s + c * 72 + tap * 8 + c16 / 4);
            int s = acc[c];
            s = __dp4a((int)a.x, w.x, s);
            s = __dp4a((int)a.y, w.y, s);
            s = __dp4a((int)a.z, w.z, s);
            s = __dp4a((int)a.w, w.w, s);
            acc[c] = s;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = dequant(acc[c], s3[c], b3[c]);
    } else {
      const float* w3s = reinterpret_cast<const float*>(smem);
      float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const act_t* src =
            rs + ((oy + 1 + tap / 3) * FC + ox + 1 + tap % 3) * CIN;
#pragma unroll
        for (int c8 = 0; c8 < CIN; c8 += 8) {
          float x[8];
          unpack8(*reinterpret_cast<const uint4*>(src + c8), x);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float* wp = w3s + (tap * 3 + c) * CIN + c8;
            const float4 wa = *reinterpret_cast<const float4*>(wp);
            const float4 wb = *reinterpret_cast<const float4*>(wp + 4);
            float s = acc[c];
            s = fmaf(x[0], wa.x, s); s = fmaf(x[1], wa.y, s);
            s = fmaf(x[2], wa.z, s); s = fmaf(x[3], wa.w, s);
            s = fmaf(x[4], wb.x, s); s = fmaf(x[5], wb.y, s);
            s = fmaf(x[6], wb.z, s); s = fmaf(x[7], wb.w, s);
            acc[c] = s;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = acc[c] + b3[c];
    }
    uint8_t* dst = out + ((size_t)gy * 4 * width + gx) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) dst[bgr ? 2 - c : c] = to_u8(v[c]);
  }
}

template <bool Q8>
cudaError_t launch(const void* h, void* out, const void* w1, const void* b1,
                   const void* a1, const void* w2, const void* b2,
                   const void* a2, const void* w3, const void* b3,
                   const void* s2, const void* s3, float inv_su1,
                   float inv_sr, int n_tiles, int nx, int core_rows,
                   int height, int width, int bgr, cudaStream_t stream) {
  const int smem = Layout<Q8>::total;
  cudaError_t e = cudaFuncSetAttribute(
      tail_u8_kernel<Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((CORE + BC - 1) / BC, (core_rows + BR - 1) / BR, n_tiles);
  tail_u8_kernel<Q8><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<uint8_t*>(out),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(a1), w2, static_cast<const float*>(b2),
      static_cast<const float*>(a2), w3, static_cast<const float*>(b3),
      static_cast<const float*>(s2), static_cast<const float*>(s3), inv_su1,
      inv_sr, nx, core_rows, height, width, bgr);
  return cudaGetLastError();
}

}  // namespace

// Launches the fused tail on `stream`; returns the cudaError_t of the launch.
// bf16 mode (q8 = 0): w2 (288, 128) and w3 (288, 3) bf16; s2/s3 unused.
// w8a8 mode (q8 = 1): w2 (72, 128) and w3 (3, 72) int32 words of 4 int8
// along k, s2 (128,) and s3 (3,) f32 dequant scales.
extern "C" int dgt_tail_u8(const void* h, void* out, const void* w1,
                           const void* b1, const void* a1, const void* w2,
                           const void* b2, const void* a2, const void* w3,
                           const void* b3, const void* s2, const void* s3,
                           float inv_su1, float inv_sr, int q8, int n_tiles,
                           int nx, int core_rows, int height, int width,
                           int bgr, void* stream) {
  if (n_tiles < 1 || nx < 1 || n_tiles % nx || core_rows < 1 ||
      n_tiles > 65535 || (q8 && (!s2 || !s3)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      q8 ? launch<true>(h, out, w1, b1, a1, w2, b2, a2, w3, b3, s2, s3,
                        inv_su1, inv_sr, n_tiles, nx, core_rows, height,
                        width, bgr, st)
         : launch<false>(h, out, w1, b1, a1, w2, b2, a2, w3, b3, s2, s3,
                         inv_su1, inv_sr, n_tiles, nx, core_rows, height,
                         width, bgr, st);
  return (int)e;
}
