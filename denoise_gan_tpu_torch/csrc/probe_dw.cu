// Depthwise-forms probe (K4): a chained 3x3 depthwise on a (C, 17 x 128)
// f32 band in four forms that differ in where the operands live.
//
// Replaces the Pallas probe tools/exp_dw_forms.py (_kernel :96), which
// looked for the fastest Mosaic form of the FSRGAN body's 3x3 depthwise
// for a fused body kernel.  The Hopper question: which form of it runs
// fastest on the CUDA cores, for the tensor-core K3 (csrc/mbconv.cu's
// stage 2 is such a depthwise, on a shared-memory patch).
//
// Per channel c, a rep computes d (15 x 128 = 1920 outputs) from the band
// e (2176 = 17 x 128, rows of 128 flattened):
//   d[p] = sum over dr, dc of w[3 dr + dc][c] * src_dc[p + 128 dr],
// src_0 = roll(e, 1) (e[j - 1]), src_1 = e, src_2 = roll(e, -1) (e[j + 1]),
// rolled on the flattened axis and wrapping at its ends, so a row's edge
// taps read the neighbouring row's edge value; then e[0:128] = d[0:128] *
// 1e-3, which the next rep reads (d's chunks 0, 1 and 14: through
// src_0[128] and src_2[2175] = e[0]).  Every sum is fmaf in the JAX order
// (tap row, then left, centre, right), from 0; the plain version
// (probes/dw_forms.py) rounds each multiply-add once in the same order, so
// the two are bit-identical.
//
// The forms, each against the TPU form it stands for:
//   scratch (_dw_scratch, rolled copies in VMEM scratch): each rep writes
//     the two rolled copies of e to shared memory, then the taps read the
//     three shared buffers at row offsets;
//   value (_dw_value, one expression, rolls as values): no copies; the
//     roll becomes an address: per tap row, one 16-byte load of the lane's
//     four centre values and the two neighbours at flat offsets -1 and +4
//     of e's one shared buffer, wrapped at the band's ends;
//   chunked (_dw_chunked, 3-chunk window of vregs, lane rolls within a
//     chunk): per tap row a register window of the lane's four values, the
//     -1 and +1 neighbours from lanes - 1 and + 1 by __shfl_sync, wrapping
//     inside the 128-wide chunk: a different function, which differs from
//     scratch at columns 0 and 127 of each output chunk (as the TPU form);
//   planes (_dw_planes, full weight planes): as scratch, but each FMA reads
//     its weight from a full plane in shared memory (a channel's nine
//     planes, 69 KB, filled once per launch) where the others broadcast a
//     register.
//
// Partition: channels are independent, so each CTA takes one channel for
// every rep, with no inter-CTA sync (a channel's rows are not split: the
// chunk-0 update feeds chunks 0, 1 and 14).  15 warps, warp j on output
// chunk j, four contiguous outputs a lane (16-byte loads and stores).  192
// channels on 132 SMs: all 192 CTAs are resident at once (480 threads and
// at most 95 KB of shared memory each, so two fit an SM), so there is no
// second wave: 60 SMs hold two channels and 72 one, and the SMs with two
// set the time.
//
// Bound: operations, 9 FMAs an output (192 x 1920 x 18 = 6.64 MFLOP a rep)
// at the FP32 peak.  Shared memory comes first: the taps read 9 x 4 bytes
// an output (13.3 MB a rep, twice that with the planes) at 128 bytes a
// clock an SM, and each rep has two barriers (three with copies).
// csrc/mbconv.cu's stage 2 reads its taps from a shared patch by address,
// the value form.

#include <cuda_runtime.h>

namespace {

constexpr int CH = 128;                   // a chunk: one band row
constexpr int MB = 17 * CH;               // band columns
constexpr int MP = 15 * CH;               // output columns
constexpr int WARPS = MP / CH;            // one output chunk a warp
constexpr int THREADS = 32 * WARPS;
constexpr int SMEM_MAX = 232448;          // a block's shared-memory limit

enum Form { SCRATCH = 0, VALUE = 1, CHUNKED = 2, PLANES = 3 };

constexpr int smem_bytes(int form) {
  return 4 * (MB * (form == SCRATCH || form == PLANES ? 3 : 1) +
              (form == PLANES ? 9 * MP : 0));
}

template <int FORM>
__global__ void __launch_bounds__(THREADS)
dw_kernel(float* __restrict__ e, const float* __restrict__ w,
          float* __restrict__ d, int nch, int reps, float cu) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool COPIES = FORM == SCRATCH || FORM == PLANES;
  float* es = smem;
  float* els = smem + MB;                 // scratch and planes only
  float* ers = smem + 2 * MB;
  float* pl = smem + 3 * MB;              // planes only: [9][MP]
  const int ch = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int p0 = CH * warp + 4 * lane;    // the lane's first output
  float* erow = e + (size_t)ch * MB;

  for (int q = tid; q < MB / 4; q += THREADS)
    reinterpret_cast<float4*>(es)[q] = reinterpret_cast<const float4*>(erow)[q];
  float wr[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) wr[t] = w[t * nch + ch];
  if (FORM == PLANES)                     // another thread's outputs than
    for (int i = tid; i < 9 * MP; i += THREADS)   // the ones it reads
      pl[i] = w[i / MP * nch + ch];
  __syncthreads();

  float acc[4];
  for (int rep = 0; rep < reps; ++rep) {
    if (COPIES) {
      for (int j = tid; j < MB; j += THREADS) {
        els[j] = es[j ? j - 1 : MB - 1];
        ers[j] = es[j + 1 < MB ? j + 1 : 0];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = 0.f;
#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
      const int base = p0 + CH * dr;
      const float4 c4 = *reinterpret_cast<const float4*>(es + base);
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
      float lv[4], rv[4];
      if (COPIES) {
        const float4 l4 = *reinterpret_cast<const float4*>(els + base);
        const float4 r4 = *reinterpret_cast<const float4*>(ers + base);
        lv[0] = l4.x, lv[1] = l4.y, lv[2] = l4.z, lv[3] = l4.w;
        rv[0] = r4.x, rv[1] = r4.y, rv[2] = r4.z, rv[3] = r4.w;
      } else {
        float lft, rgt;
        if (FORM == VALUE) {
          lft = es[base ? base - 1 : MB - 1];
          rgt = es[base + 4 < MB ? base + 4 : 0];
        } else {
          lft = __shfl_sync(0xffffffffu, c4.w, (lane + 31) % 32);
          rgt = __shfl_sync(0xffffffffu, c4.x, (lane + 1) % 32);
        }
        lv[0] = lft, lv[1] = c4.x, lv[2] = c4.y, lv[3] = c4.z;
        rv[0] = c4.y, rv[1] = c4.z, rv[2] = c4.w, rv[3] = rgt;
      }
      float wv[3][4];
#pragma unroll
      for (int dc = 0; dc < 3; ++dc) {
        if (FORM == PLANES) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(pl + (3 * dr + dc) * MP + p0);
          wv[dc][0] = w4.x, wv[dc][1] = w4.y, wv[dc][2] = w4.z,
          wv[dc][3] = w4.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[dc][i] = wr[3 * dr + dc];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i] = fmaf(wv[0][i], lv[i], acc[i]);
        acc[i] = fmaf(wv[1][i], cv[i], acc[i]);
        acc[i] = fmaf(wv[2][i], rv[i], acc[i]);
      }
    }
    __syncthreads();                      // every read of e is done
    if (warp == 0)
      *reinterpret_cast<float4*>(es + p0) =
          make_float4(__fmul_rn(acc[0], cu), __fmul_rn(acc[1], cu),
                      __fmul_rn(acc[2], cu), __fmul_rn(acc[3], cu));
    __syncthreads();                      // before the next rep reads e
  }
  *reinterpret_cast<float4*>(d + (size_t)ch * MP + p0) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
  if (warp == 0)                          // the only chunk of e that changed
    *reinterpret_cast<float4*>(erow + p0) =
        *reinterpret_cast<const float4*>(es + p0);
}

template <int FORM>
cudaError_t launch(void* e, const void* w, void* d, int nch, int reps,
                   float cu, cudaStream_t stream) {
  auto kern = dw_kernel<FORM>;
  constexpr int smem = smem_bytes(FORM);
  static_assert(smem <= SMEM_MAX, "a form's buffers fit a block");
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<nch, THREADS, smem, stream>>>(static_cast<float*>(e),
                                       static_cast<const float*>(w),
                                       static_cast<float*>(d), nch, reps, cu);
  return cudaGetLastError();
}

}  // namespace

// `reps` depthwise reps of form `form` (0 scratch, 1 value, 2 chunked, 3
// planes) in place on e (nch, 2176) f32, from w (9, nch) f32, the last
// rep's output into d (nch, 1920) f32, all row-major, with the chunk-0
// update e[:, 0:128] = d[:, 0:128] * cu, on `stream`; returns the launch's
// cudaError_t.
extern "C" int dgt_probe_dw(void* e, const void* w, void* d, int nch,
                            int reps, int form, float cu, void* stream) {
  if (nch < 1 || reps < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case SCRATCH: return (int)launch<SCRATCH>(e, w, d, nch, reps, cu, st);
    case VALUE: return (int)launch<VALUE>(e, w, d, nch, reps, cu, st);
    case CHUNKED: return (int)launch<CHUNKED>(e, w, d, nch, reps, cu, st);
    case PLANES: return (int)launch<PLANES>(e, w, d, nch, reps, cu, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
