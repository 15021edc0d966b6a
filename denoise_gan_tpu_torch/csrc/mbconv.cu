// Fused inverted residual (MobileNetV2 block, BN folded) for Hopper
// (sm_90a): expand 1x1 + bias + ReLU -> 3x3 depthwise + bias + ReLU ->
// project 1x1 + bias + residual, one launch per block.
//
// Replaces the TPU kernel tools/exp_mbconv_kernel.py::_mbconv_kernel.  Its
// plain PyTorch version is ops/mbconv.py::fused_mbconv_reference; the
// wrapper is ops/mbconv.py::fused_mbconv.
//
// Input x: NHWC (n, h, w, 32) bf16, contiguous.  Output: the same shape.
// Weights bf16: we (32, E) and be (E) (null without an expand, where E =
// 32), wd (3, 3, E), bd (E), wp (E, 32), bp (32).  E is a multiple of 32.
//
// What bounds it on the H100: memory.  At 1080p (128 tiles of 139x124) one
// block reads its 141 MB input and writes its 141 MB output, 282 MB, ~0.08
// ms at 3.35 TB/s, for 31 G multiply-adds (~0.06 ms at the bf16 tensor-core
// peak).  The unfused form also writes and reads the 192-channel expanded
// tensor (847 MB in bf16) several times.  This design never lets it reach
// device memory: each block of threads expands a patch of x into shared
// memory one chunk of 32 expanded channels at a time, runs the depthwise on
// the chunk and adds the chunk's share of the project into per-thread f32
// sums, so device memory sees x once (plus a 1-pixel halo) and y once.
// This first version does its products on the CUDA cores (f32 FMA on bf16
// operands); tensor cores and TMA are later work.
//
// Block = (column chunk of BC, band of BR rows, image):
//   stage 0: x patch (BR+2) x (BC+2) x 32 -> smem, zero outside the image
//   per chunk of 32 expanded channels:
//     stage 1: e = relu(x . we + be) in f32 at every patch pixel, 0 outside
//              the image (SAME padding on the expanded tensor; the TPU
//              kernel leaves relu(be) there)
//     stage 2: d = bf16(relu(dw3x3(e) + bd)) at the BR x BC outputs
//     stage 3: acc += d . wp, the chunk's part of the project
//   epilogue: y = (acc + bp) + x, rounded to bf16, masked to the image.
// Sums run in the plain version's order: expand over input channels 0..31,
// the depthwise tap row then tap column, the project over expanded channels
// 0..E-1.  bf16 x bf16 products are exact in f32, so the FMAs of stages 1
// and 3 round as the plain version's adds do; the depthwise multiplies f32
// by bf16 and rounds each product and each sum (__fmul_rn, __fadd_rn, no
// contraction), as the plain version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;              // residual stream channels
constexpr int EC = 32;             // expanded channels per chunk (one warp)
constexpr int BR = 8;              // output rows per block
constexpr int BC = 16;             // output cols per block
constexpr int NT = 256;            // threads per block
constexpr int NWARP = NT / 32;
constexpr int PR = BR + 2, PC = BC + 2;          // patch with halo
constexpr int NPP = PR * PC;                     // 180 patch pixels
constexpr int NPO = BR * BC;                     // 128 output pixels
constexpr int MO = NPO / NWARP;                  // 16 output pixels a warp

constexpr int XS_BYTES = NPP * C * 2;            // x patch, bf16
constexpr int ES_BYTES = NPP * EC * 4;           // e chunk, f32
constexpr int DS_BYTES = NPO * EC * 2;           // d chunk, bf16
constexpr int SMEM = XS_BYTES + ES_BYTES + DS_BYTES;
static_assert(XS_BYTES % 16 == 0 && ES_BYTES % 16 == 0,
              "16-byte shared loads need aligned buffers");
static_assert(NPO % NWARP == 0, "each warp takes as many output pixels");

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

// Lane = expanded channel of the chunk (stages 1-2) or output channel
// (stage 3); warp = a set of pixels.
template <bool EXPAND>
__global__ void __launch_bounds__(NT)
mbconv_kernel(const __nv_bfloat16* __restrict__ x,
              __nv_bfloat16* __restrict__ out,
              const __nv_bfloat16* __restrict__ we,
              const __nv_bfloat16* __restrict__ be,
              const __nv_bfloat16* __restrict__ wd,
              const __nv_bfloat16* __restrict__ bd,
              const __nv_bfloat16* __restrict__ wp,
              const __nv_bfloat16* __restrict__ bp, int h, int w, int e_dim,
              int residual) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* es = reinterpret_cast<float*>(smem + XS_BYTES);
  __nv_bfloat16* ds =
      reinterpret_cast<__nv_bfloat16*>(smem + XS_BYTES + ES_BYTES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * BC, r0 = blockIdx.y * BR;
  const __nv_bfloat16* xn = x + (size_t)blockIdx.z * h * w * C;

  // ---- stage 0: x patch rows r0-1.., cols c0-1.. (zero outside the image)
  for (int i = tid; i < NPP * 4; i += NT) {
    const int px = i >> 2, part = i & 3;
    const int y = r0 - 1 + px / PC, xx = c0 - 1 + px % PC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (y >= 0 && y < h && xx >= 0 && xx < w)
      v = *reinterpret_cast<const uint4*>(xn + ((size_t)y * w + xx) * C +
                                          part * 8);
    reinterpret_cast<uint4*>(xs)[i] = v;
  }
  __syncthreads();

  float acc[MO];
#pragma unroll
  for (int m = 0; m < MO; ++m) acc[m] = 0.f;

#pragma unroll 1
  for (int k0 = 0; k0 < e_dim; k0 += EC) {
    const int k = k0 + lane;
    // ---- stage 1: the chunk of e at every patch pixel
    if constexpr (EXPAND) {
      float wk[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        wk[c] = __bfloat162float(we[(size_t)c * e_dim + k]);
      const float bk = __bfloat162float(be[k]);
#pragma unroll 1
      for (int p = warp; p < NPP; p += NWARP) {
        const int y = r0 - 1 + p / PC, xx = c0 - 1 + p % PC;
        float s = 0.f;
#pragma unroll
        for (int c8 = 0; c8 < C; c8 += 8) {
          float xv[8];
          unpack8(*reinterpret_cast<const uint4*>(xs + p * C + c8), xv);
#pragma unroll
          for (int j = 0; j < 8; ++j) s = fmaf(xv[j], wk[c8 + j], s);
        }
        const bool inside = y >= 0 && y < h && xx >= 0 && xx < w;
        es[p * EC + lane] = inside ? fmaxf(__fadd_rn(s, bk), 0.f) : 0.f;
      }
    } else {
      // no expand: e = x (zero outside the image already); E = C = EC
      for (int p = warp; p < NPP; p += NWARP)
        es[p * EC + lane] = __bfloat162float(xs[p * C + lane]);
    }
    __syncthreads();

    // ---- stage 2: depthwise 3x3 on the chunk, at the output pixels
    {
      float wk[9];
#pragma unroll
      for (int t = 0; t < 9; ++t)
        wk[t] = __bfloat162float(wd[(size_t)t * e_dim + k]);
      const float bk = __bfloat162float(bd[k]);
#pragma unroll 4
      for (int m = 0; m < MO; ++m) {
        const int q = warp + NWARP * m;
        const int i = q / BC, j = q % BC;
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t)
          s = __fadd_rn(s, __fmul_rn(es[((i + t / 3) * PC + j + t % 3) * EC +
                                        lane], wk[t]));
        ds[q * EC + lane] = __float2bfloat16_rn(fmaxf(__fadd_rn(s, bk), 0.f));
      }
    }
    __syncthreads();

    // ---- stage 3: acc += d . wp over the chunk; lane = output channel
    {
      float wk[EC];
#pragma unroll
      for (int kk = 0; kk < EC; ++kk)
        wk[kk] = __bfloat162float(wp[(size_t)(k0 + kk) * C + lane]);
#pragma unroll
      for (int m = 0; m < MO; ++m) {
        const int q = warp + NWARP * m;
#pragma unroll
        for (int k8 = 0; k8 < EC; k8 += 8) {
          float dv[8];
          unpack8(*reinterpret_cast<const uint4*>(ds + q * EC + k8), dv);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[m] = fmaf(dv[j], wk[k8 + j], acc[m]);
        }
      }
    }
    // the next chunk's stage 1 writes es, read last in stage 2 above (behind
    // a barrier), and its barrier keeps stage 2's ds writes behind this
    // stage's reads
  }

  // ---- epilogue: (acc + bp) + x, bf16, inside the image only
  const float bo = __bfloat162float(bp[lane]);
  __nv_bfloat16* on = out + (size_t)blockIdx.z * h * w * C;
#pragma unroll
  for (int m = 0; m < MO; ++m) {
    const int q = warp + NWARP * m;
    const int i = q / BC, j = q % BC;
    const int y = r0 + i, xx = c0 + j;
    if (y >= h || xx >= w) continue;
    float v = __fadd_rn(acc[m], bo);
    if (residual)
      v = __fadd_rn(v, __bfloat162float(xs[((i + 1) * PC + j + 1) * C + lane]));
    on[((size_t)y * w + xx) * C + lane] = __float2bfloat16_rn(v);
  }
}

template <bool EXPAND>
cudaError_t launch(const void* x, void* out, const void* we, const void* be,
                   const void* wd, const void* bd, const void* wp,
                   const void* bp, int n, int h, int w, int e_dim,
                   int residual, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      mbconv_kernel<EXPAND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((w + BC - 1) / BC, (h + BR - 1) / BR, n);
  using bf = __nv_bfloat16;
  mbconv_kernel<EXPAND><<<grid, NT, SMEM, stream>>>(
      static_cast<const bf*>(x), static_cast<bf*>(out),
      static_cast<const bf*>(we), static_cast<const bf*>(be),
      static_cast<const bf*>(wd), static_cast<const bf*>(bd),
      static_cast<const bf*>(wp), static_cast<const bf*>(bp), h, w, e_dim,
      residual);
  return cudaGetLastError();
}

}  // namespace

// Launches one inverted residual on `stream`; returns the cudaError_t of the
// launch.  we == null runs the block without an expand (e_dim must be 32).
extern "C" int dgt_mbconv(const void* x, void* out, const void* we,
                          const void* be, const void* wd, const void* bd,
                          const void* wp, const void* bp, int n, int h, int w,
                          int e_dim, int residual, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || e_dim < EC || e_dim % EC ||
      (!we && e_dim != C) || (we && !be))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      we ? launch<true>(x, out, we, be, wd, bd, wp, bp, n, h, w, e_dim,
                        residual, st)
         : launch<false>(x, out, we, be, wd, bd, wp, bp, n, h, w, e_dim,
                         residual, st);
  return (int)e;
}
