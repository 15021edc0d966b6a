// Tensor-core chained-dot probe (K6): bf16 vs int8 chains of dependent
// products, y[0:128, :] = w^T . y, with mma.sync.
//
// Replaces the Pallas probe tools/exp_int8_mosaic.py (_kernel_bf16 :33,
// _kernel_i8 :50), which asked whether int8 doubles the TPU matrix unit's
// rate at the tails' contraction depths.  Here: y is (K, M), w is (K, 128);
// a step computes s = w^T . y (128 x M) and writes it over y's rows 0..127,
// in bf16 (f32 sums, rounded to nearest even) or in int8 (int32 sums, then
// clip(s >> 8, -127, 127), >> arithmetic).  Rows 128..K-1 never change.
//
// Design (simple and right first; wgmma and TMA are later work):
// - Step t's column block depends only on step t-1's same block, so each
//   CTA owns NS = 32 columns of y for the whole chain and needs no
//   inter-CTA sync.  Its slab lives in shared memory, transposed and
//   K-contiguous (ys[col][k]), as mma's "col" B operand wants it: loaded
//   transposed once at the start, and rows 0..127 stored back once at the
//   end.
// - w is given transposed (wt, 128 x K, K-contiguous: mma's "row" A
//   operand).  ldmatrix.trans exists only for 16-bit elements, so both
//   operands are laid out K-contiguous from the start, and each step's s is
//   written back into the slab transposed.
// - A and B fragments of m16n8k16 (bf16) and m16n8k32 (s8) take the same
//   bytes: rows g and g + 8 (g = lane / 4) at byte 4 * (lane % 4) and 16
//   bytes further, in 32-byte K steps.  One loader serves both types.
// - w streams through shared memory in chunks of 128 rows x 128 bytes of K.
//   Where all chunks fit beside the slab they are loaded once (resident:
//   bf16 K <= 384, int8 K <= 1152).  Where not (bf16 K = 1152: w is 295 KB,
//   more than a block's 227 KB), every step streams them again from L2
//   through a ring of 4 buffers with cp.async.
// - Eight warps, each 16 rows of s x 32 columns (4 accumulator tiles).
//   Rows 0..127 of the slab are read and rewritten within a step: a
//   __syncthreads sits between the step's last read and its write-back,
//   and another before the next step reads (int8 bit-identity catches a
//   race).
// - Operations bound it: 2 * K * 128 * M per step at the tensor cores'
//   dense rate (989 T bf16, 1979 T int8); the bytes (y once, w once) are
//   negligible.  Shared-memory bandwidth limits this design first: every
//   warp reads the slab's B fragments itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NOUT = 128;                 // rows of s = columns of w
constexpr int NS = 32;                    // columns of y per CTA
constexpr int WARPS = 8;                  // 16 rows of s each
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = 128;                // bytes of K per chunk of w
constexpr int PAD = 16;                   // bytes after each shared row
constexpr int CROW = CHUNK + PAD;         // shared row of a chunk
constexpr int CHUNK_BYTES = NOUT * CROW;  // 18,432
constexpr int RING = 4;                   // chunk buffers when streamed
constexpr int SMEM_MAX = 232448;          // a block's shared-memory limit

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Per element type: storage, accumulator, the mma and the write-back.
template <bool INT8>
struct Kind;

template <>
struct Kind<false> {                      // bf16, f32 sums
  using S = uint16_t;
  using Acc = float;
  static __device__ __forceinline__ void mma(Acc (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ S out(Acc v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

template <>
struct Kind<true> {                       // int8, int32 sums
  using S = int8_t;
  using Acc = int;
  static __device__ __forceinline__ void mma(Acc (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ S out(Acc v) {
    return static_cast<S>(min(max(v >> 8, -127), 127));
  }
};

template <bool INT8, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
dot_chain_kernel(const unsigned char* __restrict__ wt,
                 typename Kind<INT8>::S* __restrict__ y, int k, int m,
                 int iters) {
  using K8 = Kind<INT8>;
  using S = typename K8::S;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kbytes = k * (int)sizeof(S);
  const int yrow = kbytes + PAD;          // one column of y, K-contiguous
  unsigned char* ys = smem;
  unsigned char* ws = smem + NS * yrow;
  const int nc = kbytes / CHUNK;
  const int m0 = blockIdx.x * NS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // the slab, transposed; columns past m read as 0 and are never stored
  for (int i = tid; i < k * NS; i += THREADS) {
    const int kk = i / NS, c = i % NS;
    reinterpret_cast<S*>(ys + c * yrow)[kk] =
        m0 + c < m ? y[(size_t)kk * m + m0 + c] : S(0);
  }
  auto load_chunk = [&](int buf, int kc) {
    for (int p = tid; p < NOUT * CHUNK / 16; p += THREADS) {
      const int n = p / (CHUNK / 16), q = p % (CHUNK / 16);
      cp_async16(ws + buf * CHUNK_BYTES + n * CROW + q * 16,
                 wt + (size_t)n * kbytes + kc * CHUNK + q * 16);
    }
  };
  const int total = iters * nc;
  if (RESIDENT) {
    for (int kc = 0; kc < nc; ++kc) load_chunk(kc, kc);
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int i = 0; i < RING - 1; ++i) {
      if (i < total) load_chunk(i, i % nc);
      cp_async_commit();
    }
  }
  __syncthreads();

  for (int step = 0; step < iters; ++step) {
    typename K8::Acc c[4][4] = {};
    for (int kc = 0; kc < nc; ++kc) {
      int buf = kc;
      if (!RESIDENT) {
        const int ci = step * nc + kc;
        cp_async_wait<RING - 2>();        // chunk ci has landed
        __syncthreads();                  // and chunk ci - 1 is consumed
        const int next = ci + RING - 1;
        if (next < total) load_chunk(next % RING, next % nc);
        cp_async_commit();
        buf = ci % RING;
      }
      const unsigned char* wa =
          ws + buf * CHUNK_BYTES + (warp * 16 + g) * CROW + 4 * t;
      const unsigned char* yb = ys + g * yrow + kc * CHUNK + 4 * t;
#pragma unroll
      for (int ks = 0; ks < CHUNK; ks += 32) {
        const uint32_t a[4] = {ld32(wa + ks), ld32(wa + 8 * CROW + ks),
                               ld32(wa + ks + 16),
                               ld32(wa + 8 * CROW + ks + 16)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned char* b = yb + j * 8 * yrow + ks;
          K8::mma(c[j], a, ld32(b), ld32(b + 16));
        }
      }
    }
    __syncthreads();                      // every read of this step is done
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = warp * 16 + g + 8 * (e / 2);
        const int col = 8 * j + 2 * t + e % 2;
        reinterpret_cast<S*>(ys + col * yrow)[n] = K8::out(c[j][e]);
      }
    __syncthreads();                      // before the next step reads
  }
  if (!RESIDENT) cp_async_wait<0>();

  for (int i = tid; i < NOUT * NS; i += THREADS) {
    const int n = i / NS, c = i % NS;
    if (m0 + c < m)
      y[(size_t)n * m + m0 + c] = reinterpret_cast<const S*>(ys + c * yrow)[n];
  }
}

template <bool INT8, bool RESIDENT>
cudaError_t launch(const void* wt, void* y, int k, int m, int iters,
                   int smem, cudaStream_t stream) {
  auto kern = dot_chain_kernel<INT8, RESIDENT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<(m + NS - 1) / NS, THREADS, smem, stream>>>(
      static_cast<const unsigned char*>(wt),
      static_cast<typename Kind<INT8>::S*>(y), k, m, iters);
  return cudaGetLastError();
}

}  // namespace

// `iters` chained steps y[0:128, :] = w^T . y in place on y (K, m),
// row-major, from wt = w^T (128, K), row-major; int8 != 0 for int8 (else
// bf16).  K * element size must be a multiple of 128 bytes, K >= 128.
// Returns the launch's cudaError_t.
extern "C" int dgt_probe_dot_chain(const void* wt, void* y, int k, int m,
                                   int iters, int int8, void* stream) {
  const int kbytes = k * (int8 ? 1 : 2);
  if (k < NOUT || kbytes % CHUNK || m < 1 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const int slab = NS * (kbytes + PAD);
  const int resident = slab + kbytes / CHUNK * CHUNK_BYTES;
  const int streamed = slab + RING * CHUNK_BYTES;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (resident <= SMEM_MAX)
    e = int8 ? launch<true, true>(wt, y, k, m, iters, resident, st)
             : launch<false, true>(wt, y, k, m, iters, resident, st);
  else if (streamed <= SMEM_MAX)
    e = int8 ? launch<true, false>(wt, y, k, m, iters, streamed, st)
             : launch<false, false>(wt, y, k, m, iters, streamed, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
