// Fused SRGAN tail for Hopper (sm_90a): up1 -> up2 -> 1x1 output conv ->
// tanh -> crop-stitch -> uint8 (or bf16 canvas), one launch per frame.
//
// Replaces the TPU kernel denoise_gan_tpu/ops/pallas/tail_srgan.py::
// _tail64_kernel in all its modes (bf16, w8a8, qh8) and both epilogues (u8,
// canvas).  Its plain PyTorch twins are ops/tail_srgan.py::
// fused_tail64_u8_reference and fused_tail64_canvas_reference; the wrappers
// are ops/tail_srgan.py::fused_tail64_u8 and fused_tail64_canvas.
//
// Input: the body output h, NHWC tiles (n_tiles, core_rows+4, 124, 64),
// contiguous: bf16, or int8 in qh8 mode.  Output: the (4*height, 4*width,
// 3) frame, uint8 or (canvas) the bf16 tanh.  The geometry is tail.cu's:
// the core of tile (ty, tx) is coarse rows [2, 2+cr) x cols [2, 122), i.e.
// fine [8, 8+4cr) x [8, 488), and lands at fine (ty*4cr, tx*480) of the
// frame; the ragged bottom and right edges are masked; reads outside the
// tile return zero, which no core pixel reaches.
//
// What bounds it on the H100: arithmetic.  A 1080p frame (128 tiles of
// 139x124) needs ~1.54 T multiply-adds (up1 0.31 T, up2 1.22 T, the 1x1
// conv 6 G), ~1.8 T with this blocking's recomputed up1 halo, while it
// moves only the 282 MB of bf16 h (141 MB int8) in and the 100 MB of u8
// (199 MB of bf16 canvas) out (~0.11 ms at 3.35 TB/s).  So, as in tail.cu,
// every intermediate stays on chip and the time goes to the two 3x3
// convolutions, here on the CUDA cores: f32 FMAs on bf16 operands, __dp4a
// for the int8 products.  Each lane owns 4 output channels and each warp a
// set of positions, so one broadcast 16-byte shared load feeds 32
// multiply-adds.  What differs from tail.cu:
// * The output conv is 1x1, so R needs no halo and no shared memory.  In
//   up2's epilogue a lane holds R for 4 channels of one fine pixel (16
//   lanes hold its 64), takes its part of the 64->3 dot and the 16 lanes
//   add their parts with warp shuffles (integers in the int8 modes: exact
//   in any order).
// * 256 conv outputs: the block runs up1 and up2 once per 128-channel
//   half, a lane owning 4 channels of the half.
// * W1 and W2 (576 x 256: 295 KB each in bf16, 147 KB in int8) exceed
//   shared memory; each lane reads its 4 columns through L1/L2, once per 8
//   (bf16) or 16 (int8) input channels, and uses them at 9-10 positions.
// Tensor-core products (mma.sync, wgmma) are later work.
//
// Block = (column chunk of BC core cols, band of BR core rows, tile):
//   stage 0: h patch (BR+4) x (BC+4) x 64 -> smem (zero outside the tile),
//            output-conv weights -> smem
//   stage 1: up1 at (BR+2) x (BC+2) coarse positions, 256 channels, + b1
//            (qh8: int32 * s1 + b1), PReLU; stored bf16 (bf16 mode) or
//            int8 = q(u1 / su1) (w8a8, qh8)
//   stage 2: up2 at 2BR x 2BC positions of the 2x grid, 256 channels, + b2
//            (or int32 * s2 + b2), PReLU -> R, bf16 or q(R / sr) -> 1x1
//            conv + b3 (or int32 * s3 + b3), tanh, bf16 rounding;
//            u8 = trunc(clip((v+1)*127.5+0.5)), or the bf16 value (canvas).
// q(x) rounds half to even and clips to +-127; u1 and R are quantised from
// f32 (tail_srgan.py:239-241, :283).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tail_common.cuh"

namespace {

using namespace tail;

constexpr int CIN = 64;            // body channels
constexpr int C1 = 256;            // up1/up2 conv outputs (4 phases x 64)
constexpr int HALF = C1 / 2;       // channels a pass of the block covers
constexpr int BR = 5;              // core rows per block (135 = 27 x 5)
constexpr int BC = 8;              // core cols per block (120 = 15 x 8)
constexpr int NT = 256;            // threads per block
constexpr int NWARP = NT / 32;

constexpr int HR = BR + 4, HC = BC + 4;          // h patch
constexpr int UR = BR + 2, UC = BC + 2;          // up1 positions
constexpr int YR = 2 * BR, YC = 2 * BC;          // up2 positions (2x grid)

constexpr int NP1 = UR * UC;                     // 70
constexpr int P1 = (NP1 + NWARP - 1) / NWARP;    // 9 per warp
constexpr int NP2 = YR * YC;                     // 160
constexpr int P2 = 10;                           // per warp and pass
constexpr int NPASS2 = (NP2 + NWARP * P2 - 1) / (NWARP * P2);

template <int MODE>
struct Layout {
  static constexpr bool Q8 = MODE != BF16;
  using act_t = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  static constexpr int h_px = MODE == QH8 ? CIN : 2 * CIN;  // bytes per pixel
  // output-conv weights: int8 modes int32 words [c][16]; bf16 f32 [c][64]
  static constexpr int w3_bytes = Q8 ? 3 * 16 * 4 : 3 * CIN * 4;
  static constexpr int h_bytes = HR * HC * h_px;
  static constexpr int u1_bytes = NP1 * C1 * (int)sizeof(act_t);
  static constexpr int h_off = w3_bytes;
  static constexpr int u1_off = h_off + h_bytes;
  static constexpr int total = u1_off + u1_bytes;
  static_assert(h_off % 16 == 0 && u1_off % 16 == 0,
                "16-byte shared loads need aligned buffers");
};

template <int MODE, bool CANVAS>
__global__ void __launch_bounds__(NT, 2)
tail64_kernel(const unsigned char* __restrict__ h, void* __restrict__ outv,
              const void* __restrict__ w1v, const float* __restrict__ b1,
              const float* __restrict__ a1, const void* __restrict__ w2v,
              const float* __restrict__ b2, const float* __restrict__ a2,
              const void* __restrict__ w3v, const float* __restrict__ b3,
              const float* __restrict__ s1, const float* __restrict__ s2,
              const float* __restrict__ s3, float inv_su1, float inv_sr,
              int nx, int core_rows, int height, int width, int bgr) {
  using L = Layout<MODE>;
  using act_t = typename L::act_t;
  using out_t =
      typename std::conditional<CANVAS, __nv_bfloat16, uint8_t>::type;
  constexpr bool Q8 = L::Q8;
  extern __shared__ __align__(16) unsigned char smem[];
  act_t* u1s = reinterpret_cast<act_t*>(smem + L::u1_off);
  out_t* out = static_cast<out_t*>(outv);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * BC;   // first core col (core coords)
  const int r0 = blockIdx.y * BR;   // first core row
  const int n = blockIdx.z;
  const int tr = core_rows + 4;

  // ---- stage 0: output-conv weights and the h patch (tile rows r0.., cols
  // c0..) into shared memory
  if constexpr (Q8) {
    const int* w3 = static_cast<const int*>(w3v);            // (3, 16)
    int* w3s = reinterpret_cast<int*>(smem);
    for (int i = tid; i < 3 * 16; i += NT) w3s[i] = w3[i];
  } else {
    const __nv_bfloat16* w3 = static_cast<const __nv_bfloat16*>(w3v);
    float* w3s = reinterpret_cast<float*>(smem);             // (3, 64)
    for (int i = tid; i < 3 * CIN; i += NT)
      w3s[i] = __bfloat162float(w3[(i % CIN) * 3 + i / CIN]);
  }
  load_patch<L::h_px, HR, HC>(h + (size_t)n * tr * T * L::h_px,
                              reinterpret_cast<uint4*>(smem + L::h_off), r0,
                              c0, tr, tid, NT);
  __syncthreads();

  // ---- stage 1: up1 at U1 position (i, j) = tile (r0+1+i, c0+1+j), reading
  // h patch (i+dy, j+dx).  Lane: channels o..o+3 of the half; warp:
  // positions warp+8m.  Sums run tap-major, then input channel, as the
  // twin's _up1_sum, so w8a8 quantises the same u1 (qh8's integer sums are
  // exact in any order).
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    const int o = half * HALF + lane * 4;
    if constexpr (MODE == QH8) {
      const int8_t* hs = reinterpret_cast<const int8_t*>(smem + L::h_off);
      const int* w1 = static_cast<const int*>(w1v);          // (144, 256)
      int acc[P1][4];
#pragma unroll
      for (int m = 0; m < P1; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][q] = 0;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
#pragma unroll 1
        for (int c16 = 0; c16 < CIN; c16 += 16) {
          int w[4][4];
          load_w16(w, w1 + (size_t)(tap * 16 + c16 / 4) * C1 + o, C1);
#pragma unroll
          for (int m = 0; m < P1; ++m) {
            const int p = warp + NWARP * m;
            if (p < NP1) {
              const int i = p / UC, j = p % UC;
              dp4a_16(acc[m],
                      *reinterpret_cast<const uint4*>(
                          hs + ((i + dy) * HC + (j + dx)) * CIN + c16),
                      w);
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
            v[q] = prelu(dequant(acc[m][q], s1[o + q], b1[o + q]),
                         a1[(o + q) & (CIN - 1)]);
          put4<Q8>(u1s + p * C1 + o, v, inv_su1);
        }
      }
    } else {
      const __nv_bfloat16* hs =
          reinterpret_cast<const __nv_bfloat16*>(smem + L::h_off);
      const __nv_bfloat16* w1 = static_cast<const __nv_bfloat16*>(w1v);
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
            v[q] = prelu(acc[m][q] + b1[o + q], a1[(o + q) & (CIN - 1)]);
          put4<Q8>(u1s + p * C1 + o, v, inv_su1);
        }
      }
    }
  }
  __syncthreads();

  // ---- stage 2: up2 on the 2x grid of depth_to_space(u1), then the 1x1
  // output conv.  Output (Y, X) = 2x core coord (2*r0+Y, 2*c0+X) reads d1
  // (Y+du+1, X+dv+1) = U1 ((Y+du+1)/2, (X+dv+1)/2), phase block
  // ((Y+du+1)&1)*2 + ((X+dv+1)&1).  Conv channel q = (a*2+b)*64 + t goes to
  // R at fine core (4*r0 + 2Y+a, 4*c0 + 2X+b), channel t.  Lane: channels
  // q0..q0+3; lanes 0-15 hold phase (half, 0), lanes 16-31 (half, 1).
  const int ty = n / nx, tx = n % nx;
  const int sub = lane & 15;
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    const int q0 = half * HALF + lane * 4;
    const int pa = half, pb = lane >> 4, t0 = q0 & (CIN - 1);
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
          const int* w2 = static_cast<const int*>(w2v);      // (144, 256)
#pragma unroll 1
          for (int c16 = 0; c16 < CIN; c16 += 16) {
            int w[4][4];
            load_w16(w, w2 + (size_t)(tap * 16 + c16 / 4) * C1 + q0, C1);
#pragma unroll
            for (int m = 0; m < P2; ++m) {
              const int p = warp + NWARP * (pass * P2 + m);
              if (p < NP2) {
                const int D = p / YC + du + 1, E = p % YC + dv + 1;
                dp4a_16(acc[m],
                        *reinterpret_cast<const uint4*>(
                            u1s + ((D >> 1) * UC + (E >> 1)) * C1 +
                            ((D & 1) * 2 + (E & 1)) * CIN + c16),
                        w);
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
                const int D = p / YC + du + 1, E = p % YC + dv + 1;
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
      // epilogue: R for channels t0..t0+3 of fine pixel (2Y+pa, 2X+pb),
      // its part of the 64->3 dot, the sum over the pixel's 16 lanes, and
      // lanes sub = 0, 1, 2 write output channel c = sub.
#pragma unroll
      for (int m = 0; m < P2; ++m) {
        const int p = warp + NWARP * (pass * P2 + m);
        if (p >= NP2) continue;                    // the same in all lanes
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float z;
          if constexpr (Q8) z = dequant(acc[m][q], s2[q0 + q], b2[q0 + q]);
          else z = acc[m][q] + b2[q0 + q];
          v[q] = prelu(z, a2[t0 + q]);
        }
        acc_t part[3];
        if constexpr (Q8) {
          const int* w3s = reinterpret_cast<const int*>(smem);
          const int rq = (int)pack_s8x4(v, inv_sr);
#pragma unroll
          for (int c = 0; c < 3; ++c)
            part[c] = __dp4a(rq, w3s[c * 16 + t0 / 4], 0);
        } else {
          const float* w3s = reinterpret_cast<const float*>(smem);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            float s = 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              s = fmaf(round_bf16(v[q]), w3s[c * CIN + t0 + q], s);
            part[c] = s;
          }
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            part[c] += __shfl_xor_sync(0xffffffffu, part[c], off);
        if (sub < 3) {
          const int Y = p / YC, X = p % YC;
          const int fy = 4 * r0 + 2 * Y + pa, fx = 4 * c0 + 2 * X + pb;
          const int gy = ty * 4 * core_rows + fy, gx = tx * 4 * CORE + fx;
          if (fy < 4 * core_rows && gy < 4 * height && gx < 4 * width) {
            const acc_t sum = sub == 0 ? part[0] : sub == 1 ? part[1]
                                                            : part[2];
            float y;
            if constexpr (Q8) y = dequant(sum, s3[sub], b3[sub]);
            else y = sum + b3[sub];
            store_px(out + ((size_t)gy * 4 * width + gx) * 3 +
                         (bgr ? 2 - sub : sub),
                     y);
          }
        }
      }
    }
  }
}

template <int MODE, bool CANVAS>
cudaError_t launch(const Args& a, int n_tiles, cudaStream_t stream) {
  const int smem = Layout<MODE>::total;
  cudaError_t e = cudaFuncSetAttribute(
      tail64_kernel<MODE, CANVAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((CORE + BC - 1) / BC, (a.core_rows + BR - 1) / BR, n_tiles);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  tail64_kernel<MODE, CANVAS><<<grid, NT, smem, stream>>>(
      static_cast<const unsigned char*>(a.h), a.out, a.w1, f(a.b1), f(a.a1),
      a.w2, f(a.b2), f(a.a2), a.w3, f(a.b3), f(a.s1), f(a.s2), f(a.s3),
      a.inv_su1, a.inv_sr, a.nx, a.core_rows, a.height, a.width, a.bgr);
  return cudaGetLastError();
}

}  // namespace

// Launches the fused SRGAN tail on `stream`; returns the cudaError_t of the
// launch.  Arguments as dgt_tail (tail.cu), for 64 body channels: mode 0
// bf16: h bf16, w1 and w2 (576, 256) and w3 (64, 3) bf16.  1 w8a8: w2
// (144, 256) and w3 (3, 16) int32 words of 4 int8 along k, s2 (256,) and s3
// (3,) f32 dequant scales.  2 qh8: as w8a8, with h int8 and w1 (144, 256)
// int32 words, s1 (256,).  canvas = 1 writes the bf16 tanh (RGB only).
extern "C" int dgt_tail64(const void* h, void* out, const void* w1,
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
