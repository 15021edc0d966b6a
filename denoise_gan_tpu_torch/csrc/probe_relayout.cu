// Relayout probe (K8): tensor-core products by operand layout, and a chain
// of in-kernel transposes.
//
// Replaces the Pallas probe tools/exp_relayout.py (mm_kernel :41, tk :119),
// which measured the TPU matrix unit's rate by dot_general form and the
// cost of an in-kernel (1536, 128) f32 transpose, for the fused tail's
// layout choices.
//
// matmul_form_kernel: y = A . B (P x Q) in f32 from bf16, `reps` times, and
// acc = the serial f32 sum of y[0, 0] over the reps (the JAX probe's
// output); y of the last rep is stored too.
//   canonical: A = x (M, K), B = w (K, N): A K-major, B MN-major;
//   sublane:   A = w^T, B = x with x (K, M), w (K, N), y (N, M): both
//              operands contracted on their leading axis, both MN-major.
// In mma.sync (m16n8k16 bf16 -> f32) terms: a K-major A fragment is one
// ldmatrix.x4, an MN-major one ldmatrix.x4.trans; B is MN-major in both
// forms (ldmatrix.x4.trans).  So the forms differ only in A's .trans,
// which is what the probe measures on this card.
//
// Design (simple and right first; wgmma forms are later work):
// - A CTA computes a BP x BQ = 64 x 32 tile of y with four warps, each 16
//   rows x 32 columns (four accumulator tiles).  Its A rows and B columns
//   stay in shared memory for all its reps (64 x K + K x 32 bf16: 221 KB
//   at K = 1152, under a block's 227 KB), so the rep loop measures the
//   form and not L2 streaming.  K <= 1152 and K % 64 == 0.
// - Work the compiler could hoist: every rep computes the same product.
//   ldmatrix and mma are asm volatile with a "memory" clobber, so every
//   rep loads its fragments from shared memory again and issues its mmas.
// - Filling the card: where the grid has fewer tiles than the card has SMs
//   ((1024, 1152, 48) gives 32), the reps of a tile are split among
//   splits = min(reps, SMs / tiles) CTAs that compute the same tile; the
//   total work stays 2 * M * K * N * reps.  Each split sums y[0, 0] over
//   its own reps; the last of tile 0's splits to finish adds the splits'
//   sums in order.  They count their arrivals in the first word of the
//   caller's scratch, which the entry point zeroes on the launch's stream
//   before each split launch, so every launch has its own counter.  With
//   one split acc is the serial sum itself.  The last split stores y.
// - Bank conflicts: every shared tile is rows of 16-byte chunks, chunk c
//   of row r stored at c ^ (r % 8) (rows of >= 8 chunks) or, for B's rows
//   of 4 chunks, at c ^ (r / 2 % 4), so the 8 row addresses of each
//   ldmatrix fall in 8 different 16-byte bank groups, in both forms alike.
// - Ragged P and Q (M not a multiple of 16, N = 48 against BQ = 32) load
//   as zeros and are not stored.
// - One schedule for both forms: each k-block of 64 walks precomputed
//   per-lane ldmatrix addresses (one add a load), and the next k-step's
//   fragments load while this one's mmas issue (double-buffered
//   registers).  Left to the compiler, the two forms' schedules differed
//   and so did their times, though the .trans flag itself costs nothing.
// - Bound: operations, 2 * M * K * N * reps over the bf16 tensor-core peak.
//   This design reads 1536 bytes of shared memory a warp per 4 mmas (16,384
//   flops), so shared memory (128 bytes a clock an SM) caps it first, at
//   ~36% of that peak.
//
// transpose_chain_kernel: the JAX probe's `tk`, `iters` times
// t = acc^T * c; acc = t^T on a (rows, cols) f32 block.  Each CTA takes a
// 32 x 32 tile, 256 threads with 4 elements each.  Each swap goes through
// shared memory: thread (r, j) writes its element at [r][j] and, after a
// __syncthreads, reads [j][r], the transposed tile's element (r, j), which
// another thread held (but on the diagonal); the multiply sits between
// the two swaps.  The tile is padded to 33 columns, so the column reads
// hit 32 banks.  Bound: device bytes (the block read once and written
// once); the shared-memory traffic (4 x 4 bytes per element per
// iteration) limits it first.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int BP = 64;                    // rows of y per CTA
constexpr int BQ = 32;                    // columns of y per CTA
constexpr int WARPS = 4;                  // 16 rows of y each
constexpr int THREADS = 32 * WARPS;
constexpr int SMEM_MAX = 232448;          // a block's shared-memory limit

// Chunk (16 bytes) index of chunk c of row r in a tile of w chunks a row.
__device__ __forceinline__ int swz(int r, int c, int w) {
  return r * w + (w == 4 ? (c ^ ((r >> 1) & 3)) : (c ^ (r & 7)));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ldmatrix.x4 at a shared address, transposed (.trans) or not
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  if (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr)
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// rows x (8 * w) bf16 of src (row-major, `pitch` elements a row) from
// (row0, col0) into a swizzled shared tile; elements past rows_total or
// cols_total read as 0.
__device__ void load_tile(uint4* dst, int rows, int w,
                          const uint16_t* __restrict__ src, int pitch,
                          int row0, int rows_total, int col0,
                          int cols_total) {
  const bool vec = pitch % 8 == 0 &&      // every chunk 16-byte aligned
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  for (int i = threadIdx.x; i < rows * w; i += THREADS) {
    const int r = i / w, c = i % w;
    const int gr = row0 + r, gc = col0 + 8 * c;
    const uint16_t* s = src + (size_t)gr * pitch + gc;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gr < rows_total) {
      if (vec && gc + 8 <= cols_total) {
        v = *reinterpret_cast<const uint4*>(s);
      } else {
        uint16_t e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = gc + j < cols_total ? s[j] : 0;
        v = make_uint4(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16,
                       e[4] | (uint32_t)e[5] << 16, e[6] | (uint32_t)e[7] << 16);
      }
    }
    dst[swz(r, c, w)] = v;
  }
}

template <bool SUBLANE>
__global__ void __launch_bounds__(THREADS)
matmul_form_kernel(const uint16_t* __restrict__ a_src,
                   const uint16_t* __restrict__ b_src, float* __restrict__ y,
                   float* __restrict__ parts, float* __restrict__ acc,
                   int p_dim, int q_dim, int k, int reps, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* as = reinterpret_cast<uint4*>(smem);
  uint4* bs = as + BP * k / 8;
  const int nq = (q_dim + BQ - 1) / BQ;
  const int p0 = blockIdx.x / nq * BP, q0 = blockIdx.x % nq * BQ;
  const int split = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, mat = lane / 8, row8 = lane % 8;
  const int pw = warp * 16;               // the warp's first row of the tile

  // A: canonical x rows p (K-contiguous), sublane w^T as w's rows k
  if (SUBLANE)
    load_tile(as, k, BP / 8, a_src, p_dim, 0, k, p0, p_dim);
  else
    load_tile(as, BP, k / 8, a_src, k, p0, p_dim, 0, k);
  load_tile(bs, k, BQ / 8, b_src, q_dim, 0, k, q0, q_dim);
  __syncthreads();

  // The lane's ldmatrix row addresses for the 4 k-steps of 16 in the
  // first block of 64 k; each block of 64 moves them by a_step and b_step
  // bytes (the swizzle repeats every 8 rows and, along a row, every 8
  // chunks), so neither form does address arithmetic in the loop beyond
  // one add per load.  A: canonical rows p, chunks along k; sublane
  // (.trans) rows k, the warp's p chunk.  B (.trans): rows k, two chunks of
  // 16 columns.
  const int ka = row8 + 8 * (mat / 2), kb = row8 + 8 * (mat % 2);
  const unsigned a0 = smem_addr(as), b0 = smem_addr(bs);
  unsigned a_row[4], b_row[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a_row[j] = a0 + 16 * (SUBLANE ? swz(16 * j + ka, pw / 8 + mat % 2, BP / 8)
                                  : swz(pw + row8 + 8 * (mat % 2),
                                        2 * j + mat / 2, k / 8));
#pragma unroll
    for (int h = 0; h < 2; ++h)
      b_row[j][h] = b0 + 16 * swz(16 * j + kb, 2 * h + mat / 2, BQ / 8);
  }
  const unsigned a_step = SUBLANE ? 64 * BP * 2 : 128;
  const unsigned b_step = 64 * BQ * 2;
  const int nblk = k / 64;
  float sum = 0.f;
  float c[4][4];
  const int r_begin = (int)((long long)reps * split / splits);
  const int r_end = (int)((long long)reps * (split + 1) / splits);
  for (int rep = r_begin; rep < r_end; ++rep) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
    // the next k-step's fragments load while this one's mmas issue, in
    // both forms alike (registers double-buffered)
    uint32_t a[2][4], b[2][2][4];
    auto load = [&](int j, int blk, int buf) {
      ldsm_x4<SUBLANE>(a[buf], a_row[j] + blk * a_step);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ldsm_x4<true>(b[buf][h], b_row[j][h] + blk * b_step);
    };
    load(0, 0, 0);
    for (int blk = 0; blk < nblk; ++blk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < 3)
          load(j + 1, blk, (j + 1) % 2);
        else if (blk + 1 < nblk)
          load(0, blk + 1, 0);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma(c[n], a[j % 2], b[j % 2][n / 2][2 * (n % 2)],
              b[j % 2][n / 2][2 * (n % 2) + 1]);
      }
    }
    sum += c[0][0];                       // y[0, 0] in tile 0, lane 0
  }

  if (split == splits - 1) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + pw + g + 8 * (e / 2);
        const int q = q0 + 8 * n + 2 * t + e % 2;
        if (p < p_dim && q < q_dim) y[(size_t)p * q_dim + q] = c[n][e];
      }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (splits == 1) {
      *acc = sum;
    } else {
      // parts[0]: the splits of tile 0 finished; parts[1 + s]: their sums
      parts[1 + split] = sum;
      __threadfence();
      if (atomicAdd(reinterpret_cast<unsigned*>(parts), 1u) ==
          (unsigned)splits - 1) {
        __threadfence();
        float total = 0.f;
        for (int s = 0; s < splits; ++s)
          total += static_cast<volatile float*>(parts)[1 + s];
        *acc = total;
      }
    }
  }
}

constexpr int TT = 32;                    // transpose tile side
constexpr int TROWS = 8;                  // thread rows: 4 elements each

__global__ void __launch_bounds__(TT * TROWS)
transpose_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                       int rows, int cols, int iters, float c) {
  __shared__ float s[TT][TT + 1];
  const int j = threadIdx.x % TT, i0 = threadIdx.x / TT;
  const int r0 = blockIdx.y * TT, c0 = blockIdx.x * TT;
  float v[TT / TROWS];
#pragma unroll
  for (int i = 0; i < TT / TROWS; ++i) {
    const int r = r0 + i0 + TROWS * i, col = c0 + j;
    v[i] = r < rows && col < cols ? x[(size_t)r * cols + col] : 0.f;
  }
  for (int it = 0; it < iters; ++it) {
    // t = acc^T * c: thread (r, j) takes the transposed tile's (r, j)
#pragma unroll
    for (int i = 0; i < TT / TROWS; ++i) s[i0 + TROWS * i][j] = v[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TT / TROWS; ++i)
      v[i] = __fmul_rn(s[j][i0 + TROWS * i], c);
    __syncthreads();
    // acc = t^T
#pragma unroll
    for (int i = 0; i < TT / TROWS; ++i) s[i0 + TROWS * i][j] = v[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TT / TROWS; ++i) v[i] = s[j][i0 + TROWS * i];
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TT / TROWS; ++i) {
    const int r = r0 + i0 + TROWS * i, col = c0 + j;
    if (r < rows && col < cols) out[(size_t)r * cols + col] = v[i];
  }
}

template <bool SUBLANE>
cudaError_t launch_mm(const void* a, const void* b, float* y, float* parts,
                      float* acc, int p, int q, int k, int reps, int sms,
                      cudaStream_t stream) {
  auto kern = matmul_form_kernel<SUBLANE>;
  const int smem = (BP + BQ) * k * 2;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int tiles = (p + BP - 1) / BP * ((q + BQ - 1) / BQ);
  const int splits = std::max(1, std::min(reps, sms / tiles));
  if (splits > 1) {                       // this launch's arrival counter
    e = cudaMemsetAsync(parts, 0, sizeof(unsigned), stream);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(tiles, splits), THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b), y,
      parts, acc, p, q, k, reps, splits);
  return cudaGetLastError();
}

}  // namespace

// The K8 product `reps` times on bf16 x and w (row-major): canonical
// (sublane == 0) x (m, k) @ w (k, n) -> y (m, n); sublane x (k, m),
// w (k, n), y = w^T . x (n, m).  y (f32) gets the last rep's product, acc
// (one f32) the serial sum of y[0, 0] over the reps; parts is sms + 1
// words of scratch, sms the card's SM count.  k % 64 == 0, k <= 1152.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for arguments
// it does not take).
extern "C" int dgt_probe_matmul_form(const void* x, const void* w, void* y,
                                     void* parts, void* acc, int m, int k,
                                     int n, int sublane, int reps, int sms,
                                     void* stream) {
  if (m < 1 || n < 1 || k < 64 || k % 64 || (BP + BQ) * k * 2 > SMEM_MAX ||
      reps < 1 || sms < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* yf = static_cast<float*>(y);
  float* pf = static_cast<float*>(parts);
  float* af = static_cast<float*>(acc);
  return (int)(sublane ? launch_mm<true>(w, x, yf, pf, af, n, m, k, reps,
                                         sms, st)
                       : launch_mm<false>(x, w, yf, pf, af, m, n, k, reps,
                                          sms, st));
}

// `iters` times acc = (acc^T * c)^T on (rows, cols) f32 x -> out, on
// `stream`; returns the launch's cudaError_t.
extern "C" int dgt_probe_transpose_chain(const void* x, void* out, int rows,
                                         int cols, int iters, float c,
                                         void* stream) {
  if (rows < 1 || cols < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + TT - 1) / TT, (rows + TT - 1) / TT);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  transpose_chain_kernel<<<grid, TT * TROWS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, cols,
      iters, c);
  return (int)cudaGetLastError();
}
