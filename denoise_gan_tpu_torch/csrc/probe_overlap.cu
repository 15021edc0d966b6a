// Overlap probe (K7): a tensor-core product chain beside a warp-shuffle roll
// + FMA chain, alone and interleaved in one instruction stream.
//
// Replaces the Pallas probe tools/exp_overlap_probe.py (_kernel :32), which
// asked whether one TPU core's matrix unit and vector unit run at the same
// time when one loop body holds both chains.  The Hopper question: do one
// SM's tensor cores (mma.sync) and CUDA cores + shuffle unit (FFMA, SHFL)
// serve one instruction stream at the same time?
//
// State (the JAX probe's): y (128, M) bf16, z (8, M) f32, w (128, 128)
// bf16, M = 15360.  Each of n iterations:
//   MMA: s = w . y over all M columns, f32 sums; y[:, 0:128] = bf16(s[:, 0:128])
//   VPU: z = z * c1 + roll(z, 1, axis 1) * c2, roll(a, 1)[j] = a[j - 1],
//        wrapping; rounded as fmaf(z, c1, __fmul_rn(roll, c2)), the order
//        XLA's CPU backend contracts the JAX expression to (one product
//        rounded, then a fused multiply-add).
// The caller picks the chains (mode a: MMA, b: VPU, c: both) and n; the
// JAX probe runs n = max(mxu_iters, vpu_iters) iterations of every chain
// whose count is not zero.
//
// Design (one instruction stream serving both units, as the TPU core's):
// - y is 3.75 MB, more than an SM holds.  CTA b owns the column slab
//   128 b .. 128 b + 127 (M / 128 = 120 CTAs, one wave on 132 SMs), with w
//   (32 KB) and its slab (32 KB) in shared memory, stored as rows of 16-byte
//   chunks, chunk c of row r at c ^ (r % 8), so that each ldmatrix's eight
//   row addresses fall in eight bank groups.  Every iteration every CTA
//   computes its 128 x 128 x 128 product with mma.sync m16n8k16 (bf16 in,
//   f32 sums): 8 warps, each 32 rows x 64 columns.  w never changes, so a
//   warp loads its A fragments (its 32 rows of w, all 8 k-steps) by
//   ldmatrix.x4 once, before the loop, and holds them in 64 registers a
//   lane; in the loop it reads only B (the slab, K x N row-major), four
//   ldmatrix.x4.trans a k-step.  Only CTA 0's columns feed back: it writes
//   bf16(s) over its slab between two barriers.  The other CTAs' products
//   are thrown away, but they are the probe's work: mma and ldmatrix are
//   asm volatile, so the compiler keeps every one of them inside the loop
//   (probes/overlap.py::sass_loop_counts reads the loop's HMMA count).
// - z's rows are independent (the roll moves along axis 1 only): CTAs 0-7
//   hold one row each, 60 KB, in registers: warp w of 8 holds elements
//   1920 w .. 1920 w + 1919, element 32 r + lane in register r (60 a lane;
//   with the A fragments and 64 sums a lane, 512 threads would need more
//   than their 128 registers, so the CTA has 256).  A roll is one
//   __shfl_sync from lane - 1 per register, as csrc/probe_fma.cu's
//   roll_fma_kernel; lane 0 takes lane 31's previous
//   register, and for register 0 the previous warp's last element, which
//   lane 31 of that warp posts in shared memory before the iteration's
//   barrier (two buffers by iteration parity, so one barrier an iteration
//   suffices); warp 0 takes warp 7's, which keeps the row's wrap.
// - Mode c: the same warps run both chains in one loop body, with no warp
//   specialisation: after each k-step's mmas come 8 of the lane's 60
//   shuffles and FMAs (4 after the last).  CTAs 8-119 run the product
//   alone, so t(c) is set by the eight SMs that do both.
// - Bound: operations.  The product is 2 * 128 * 128 * 15360 = 503.3 MFLOP
//   an iteration at the bf16 tensor-core peak; the roll + FMA 3 flops x 8 x
//   15360 an iteration at the FP32 peak, but one row's 15,360 shuffles on
//   one SM take 480 clocks at 32 results a clock, the chain's floor here.
//   Shared memory (128 bytes a clock an SM) allows this product the
//   tensor-core peak (one m16n8k16 a clock an SM): a warp reads 2 KB of B
//   for 16 mmas a k-step, 1,024 clocks of reads and 1,024 mmas an
//   iteration an SM.  Reading A by ldmatrix as well would halve that.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int M = 15360;                  // columns of y and z
constexpr int ROWS = 128;                 // rows of y, w and s
constexpr int SLAB = 128;                 // columns of y per CTA
constexpr int ZROWS = 8;                  // rows of z
constexpr int WARPS = 8;                  // 4 along the rows x 2 along n
constexpr int THREADS = 32 * WARPS;
constexpr int ZR = M / THREADS;           // z registers a lane: 60
constexpr int KSTEPS = ROWS / 16;         // k-steps of a product: 8
constexpr int ZPER = (ZR + KSTEPS - 1) / KSTEPS;   // z registers a k-step
constexpr int CHUNKS = SLAB * 2 / 16;     // 16-byte chunks a shared row: 16
constexpr int SMEM = 2 * ROWS * CHUNKS * 16;   // w and the slab: 64 KB
static_assert(ZR * THREADS == M, "z rows split evenly over the lanes");

// 16-byte chunk index of chunk c of row r
__device__ __forceinline__ int swz(int r, int c) {
  return r * CHUNKS + (c ^ (r & 7));
}

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

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The iteration loop of one CTA: the product chain when MMA, the roll + FMA
// chain of the CTA's z row (in `a`) when Z, in one loop body.
template <bool MMA, bool Z>
__device__ __forceinline__ void chain(unsigned char* smem, float (&a)[ZR],
                                      float (*edge)[WARPS], int iters,
                                      float c1, float c2) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, mat = lane / 8, row8 = lane % 8;
  const int mrow0 = warp % 4 * 32, ncol0 = warp / 4 * 64;
  const unsigned ws = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned ys = ws + ROWS * CHUNKS * 16;
  const int src = (lane + 31) % 32;
  const int prev_warp = (warp + WARPS - 1) % WARPS;
  // the lane's ldmatrix rows: A rows of w (m-tiles 0 and 1), B rows of the
  // slab (k within a k-step); chunks along k (A) or n (B) are XORed with
  // row8, the rows' common swizzle
  const int a_row0 = mrow0 + row8 + 8 * (mat % 2);
  const int b_krow = row8 + 8 * (mat % 2);
  // the warp's A fragments, every k-step and m-tile, for the whole loop
  uint32_t af[KSTEPS][2][4];
  if (MMA) {
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[ks][i], ws + 16 * swz(a_row0 + 16 * i, 2 * ks + mat / 2));
  }

#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float* ebuf = edge[it & 1];
    if (Z && lane == 31) ebuf[warp] = a[ZR - 1];
    __syncthreads();                      // edges posted; last write-back done
    float c[2][8][4];
    if (MMA) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;
    }
    float sp = 0.f;                       // lane 0: the element left of r
    if (Z) sp = ebuf[prev_warp];
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      if (MMA) {
        // B for 16 k x 16 n: matrix 2 q + p of an x4.trans is k rows
        // 8 p .. 8 p + 7 of n-tile 2 h + q
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, ys + 16 * swz(16 * ks + b_krow,
                                          ncol0 / 8 + 2 * h + mat / 2));
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              mma(c[i][2 * h + q], af[ks][i], bf[2 * q], bf[2 * q + 1]);
        }
      }
      if (Z) {
        // this k-step's ZPER of the lane's z registers (a trip count that
        // does not depend on ks, so the loops unroll fully and a[] stays
        // in registers)
#pragma unroll
        for (int q = 0; q < ZPER; ++q) {
          const int r = ks * ZPER + q;
          if (r < ZR) {
            const float s = __shfl_sync(0xffffffffu, a[r], src);
            const float left = lane ? s : sp;
            sp = s;
            a[r] = fmaf(a[r], c1, __fmul_rn(left, c2));
          }
        }
      }
    }
    if (MMA && blockIdx.x == 0) {
      __syncthreads();                    // every read of the slab is done
      unsigned char* yb = smem + ROWS * CHUNKS * 16;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = mrow0 + 16 * i + g + 8 * hf;
            const int col = ncol0 + 8 * j + 2 * t;
            *reinterpret_cast<uint32_t*>(yb + 16 * swz(row, col / 8) +
                                         2 * (col % 8)) =
                pack_bf16(c[i][j][2 * hf], c[i][j][2 * hf + 1]);
          }
    }
  }
}

template <bool MMA, bool VPU>
__global__ void __launch_bounds__(THREADS, 1)
overlap_kernel(const uint16_t* __restrict__ w, uint16_t* __restrict__ y,
               float* __restrict__ z, int iters, float c1, float c2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float edge[2][WARPS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool zrow = VPU && blockIdx.x < ZROWS;
  uint4* ws = reinterpret_cast<uint4*>(smem);
  uint4* ys = ws + ROWS * CHUNKS;
  const int m0 = blockIdx.x * SLAB;
  if (MMA) {
    for (int i = tid; i < ROWS * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, q = i % CHUNKS;
      ws[swz(r, q)] = reinterpret_cast<const uint4*>(w + r * ROWS)[q];
      ys[swz(r, q)] =
          reinterpret_cast<const uint4*>(y + (size_t)r * M + m0)[q];
    }
  }
  float a[ZR];
  float* zr = z + (size_t)blockIdx.x * M + warp * (32 * ZR) + lane;
  if (zrow) {
#pragma unroll
    for (int r = 0; r < ZR; ++r) a[r] = zr[32 * r];
  }
  __syncthreads();
  if (zrow)
    chain<MMA, true>(smem, a, edge, iters, c1, c2);
  else
    chain<MMA, false>(smem, a, edge, iters, c1, c2);
  if (zrow) {
#pragma unroll
    for (int r = 0; r < ZR; ++r) zr[32 * r] = a[r];
  }
  if (MMA && blockIdx.x == 0) {
    __syncthreads();                      // the last write-back is done
    for (int i = tid; i < ROWS * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, q = i % CHUNKS;
      reinterpret_cast<uint4*>(y + (size_t)r * M)[q] = ys[swz(r, q)];
    }
  }
}

template <bool MMA, bool VPU>
cudaError_t launch(const void* w, void* y, void* z, int iters, float c1,
                   float c2, cudaStream_t stream) {
  auto kern = overlap_kernel<MMA, VPU>;
  const int smem = MMA ? SMEM : 0;
  if (MMA) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<MMA ? M / SLAB : ZROWS, THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(w), static_cast<uint16_t*>(y),
      static_cast<float*>(z), iters, c1, c2);
  return cudaGetLastError();
}

}  // namespace

// `iters` iterations of the chains picked by mma and vpu (not both 0), in
// place on y (128, 15360) bf16 and z (8, 15360) f32, from w (128, 128)
// bf16, all row-major, on `stream`; returns the launch's cudaError_t.
extern "C" int dgt_probe_overlap(const void* w, void* y, void* z, int iters,
                                 int mma, int vpu, float c1, float c2,
                                 void* stream) {
  if (iters < 0 || !(mma || vpu)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma && vpu) return (int)launch<true, true>(w, y, z, iters, c1, c2, st);
  if (mma) return (int)launch<true, false>(w, y, z, iters, c1, c2, st);
  return (int)launch<false, true>(w, y, z, iters, c1, c2, st);
}
