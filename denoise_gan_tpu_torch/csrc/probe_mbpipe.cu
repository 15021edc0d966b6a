// Inverted-residual band-pipeline probe (K5): one band step of the FSRGAN
// body's inverted residual, expand and project on tensor cores and the 3x3
// depthwise on CUDA cores, with one chain of steps or two independent
// chains on separate warps of the same CTA.
//
// Replaces the Pallas probe tools/exp_mbpipe.py (_kernel :40), which asked
// whether one TPU core overlaps its matrix unit (chain A's dots) with its
// vector unit (chain B's depthwise) when two independent chains share a
// loop body.  The Hopper question: do the tensor cores (mma.sync) and the
// CUDA cores (FFMA) of one SM overlap when the two chains run on separate
// warps, which the SM's schedulers interleave?  (K7, csrc/probe_overlap.cu,
// found that one warp's own instruction stream does not overlap them.)
//
// A band is r (32, 2176) bf16: 17 rows of 128 pixels flattened, 32
// channels.  One step, as the JAX kernel's block_step (:50-73):
//   E = relu(we^T r + 0.01)          (192, 2176) f32, bf16 x bf16 in f32
//   D[c, p] = relu(sum over tap rows dr, then (E[p - 1], E[p], E[p + 1])
//             at p + 128 dr, of wdw[3 dr + dc][c] * tap + 0.01), p < 1920,
//             the +-1 on the flat axis (row edges read the neighbouring
//             row, the band's ends wrap), each tap one fmaf from 0
//   p = wp^T D                        (32, 1920) f32, bf16 x f32
//   r[:, 128:2048] = bf16(f32(r[:, 128:2048]) + p * 1e-3), in place.
// Output row i of D (pixels 128 i .. 128 i + 127) reads E rows i .. i + 2
// and writes r row i + 1.  The plain version (probes/mbpipe.py) computes
// the depthwise and the r update bit for bit as here; E and p are
// tensor-core sums, in an order of the hardware's.
//
// The project's D is f32: each D value is split into three bf16 pieces,
// D = hi + mid + lo exactly (each the bf16 rounding of what remains; 3 x 8
// significand bits cover f32's 24), and p sums wp x hi, wp x mid, wp x lo:
// every product is exact and only the f32 sums round, so this is the JAX
// function (no TF32, no bf16 D).  It triples the project's mma.sync work.
//
// Partition: one band per CTA, no cluster.  A cluster of CTAs holding one
// E row each (96 KB) would need 17 CTAs, above the 16 a cluster may have,
// so each CTA recomputes the E rows it needs instead: for each output row
// i it expands a window of 400 pixels (E rows i .. i + 2 and 8 pixels on
// each side for the taps at the row edges; 3.125 rows of E, so the expand
// runs 3 x 400 / 128 = 2.76 x the JAX step's work over the 15 output rows,
// and E rows 0 and 16, which no step changes, are computed every step as
// in the JAX kernel).  Per output row, per group of 16 channels (12):
//   1. expand (mma.sync m16n8k16, bf16 in, f32 sums): the 50 n-tiles of
//      the window split over the chain's 8 warps, B fragments (the r
//      window) loaded by ldmatrix.trans once a row and held in registers;
//      +0.01 and relu; stored to a shared E tile, 16 x 400 f32;
//   2. depthwise (CUDA cores): warp w takes channels 2 w and 2 w + 1, each
//      lane four neighbouring pixels of a row: one 16-byte load of the
//      centre values a tap row, the -1 / +1 neighbours from lanes - 1 /
//      + 1 by __shfl_sync (lanes 0 and 31 read the true neighbours, across
//      the row edge, from shared memory), nine fmaf a pixel in the JAX
//      order; +0.01 and relu; split into hi, mid, lo bf16 in shared memory;
//   3. project (mma.sync): p (32 x 128) += wp^T (32 x 16) x each piece,
//      warp w owning pixels 16 w .. 16 w + 15, its sums in registers over
//      all 12 groups.
// Two named barriers a group (one chain's warps; two forms below share one
// between the chains).  After the 12 groups the chain writes r row i + 1
// to device memory.
//
// r and the in-place update: each chain of each band keeps its r in device
// memory (L2-resident).  Shared memory holds a ring of 6 r rows (rows
// i - 1 .. i + 3 of output row i's window and the next one, prefetched by
// cp.async); each row is read from device memory once a step, before the
// step writes it, and the update of row i + 1 reads its old value from the
// ring, so every E of a step comes from the step's old r (the JAX kernel
// reads r before it writes it, and its taps el[0] = E[2175] and er[2175] =
// E[0] reach across the band: rows 16 and 0, which no step writes).  A
// step ends with __threadfence and a barrier before the next step reads r.
//
// Two chains: chain q runs on warps 8 q .. 8 q + 7 of the CTA with its own
// shared buffers and barriers (ids 1 + q); the weights are shared.  With
// one chain the CTA has only those 8 warps: the same threads per chain and
// the same code (every form built under one register cap, 512 threads).
// Two more forms of two chains meet at one barrier (id 1, all 16 warps):
// aligned, both chains in the same phase in each interval between
// barriers, and offset, chain 1 one interval behind chain 0, so that one
// chain's tensor-core interval (project and next expand) runs beside the
// other's depthwise (24 of an output row's 25 intervals; at a row boundary
// two tensor-core intervals meet).  Both wait for the slower chain at
// every barrier alike, so t(aligned) - t(offset) is what running the two
// units side by side buys, apart from the latency hiding that any second
// chain of warps brings.
//
// Per CTA: 8 warps a chain; shared memory 35,072 bytes of weights (we^T,
// wp^T bf16, wdw f32) + 91,392 a chain (E tile 26,112, D pieces 13,056,
// r ring 52,224): 126,464 with one chain, 217,856 with two, so one CTA
// (band) an SM either way.  Registers: at most 128 a thread.
//
// Bound, per band step (the JAX step's work once): tensor-core operations
// 2 x 192 x 32 x 2176 (expand) + 2 x 32 x 192 x 1920 (project) = 50.3 M,
// 0.051 us at the bf16 peak; CUDA-core operations 8.34 M (the depthwise's
// 3.32 M fmaf as 2 each, bias and relu of E and D, the r update's
// multiply and add), 0.125 us at the FP32 peak: operations, the CUDA
// cores.  This design issues 2.76 x the expand and 3 x the project on the
// tensor cores (144.5 M flops a band step) and moves about 1.1 MB through
// shared memory an output row (E written and read, the D pieces written
// and read, fragments): ~8,700 clocks of the shared-memory pipe (128 bytes
// a clock an SM) against 1,728 of FFMA and ~2,400 of mma.sync.  Measured
// on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6), one chain takes
// 11.7 us an output row (~23,000 clocks at 1,980 MHz) and two chains'
// warps together use the tensor cores and the FFMA pipe below 15% each:
// the phases' latency between barriers, with 8 or 16 warps an SM, sets
// the time, not a pipe.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CH = 128;                   // pixels a band row
constexpr int ROWS = 17;                  // band rows
constexpr int MB = ROWS * CH;             // 2176
constexpr int OROWS = 15;                 // output rows
constexpr int MP = OROWS * CH;            // 1920
constexpr int NR = 32;                    // channels of r
constexpr int NE = 192;                   // expanded channels
constexpr int G = 16;                     // channels a group: one m-tile
constexpr int NG = NE / G;                // 12
constexpr int WIN = 3 * CH + 16;          // window pixels: 400
constexpr int NT = WIN / 8;               // its n-tiles: 50
constexpr int WARPS = 8;                  // a chain's warps
constexpr int CT = 32 * WARPS;            // a chain's threads
constexpr int TPW = (NT + WARPS - 1) / WARPS;   // n-tiles a warp: 7
constexpr int ES = WIN + 8;               // E tile row stride, floats
constexpr int RS = CH + 8;                // ring row stride, bf16
constexpr int DS = CH + 8;                // D pieces row stride, bf16
constexpr int NSLOT = 6;                  // ring rows
constexpr int WES = NR + 8;               // we^T row stride, bf16
constexpr int WPS = NE + 8;               // wp^T row stride, bf16
constexpr int SLOT_BYTES = NR * RS * 2;
constexpr int E_BYTES = G * ES * 4;
constexpr int D_BYTES = 3 * G * DS * 2;
constexpr int CHAIN_BYTES = E_BYTES + D_BYTES + NSLOT * SLOT_BYTES;
constexpr int WE_BYTES = NE * WES * 2;
constexpr int WP_BYTES = NR * WPS * 2;
constexpr int WDW_BYTES = 9 * NE * 4;
constexpr int SHARED_BYTES = WE_BYTES + WP_BYTES + WDW_BYTES;
constexpr int SMEM_MAX = 232448;          // a block's shared-memory limit
static_assert(SHARED_BYTES + 2 * CHAIN_BYTES <= SMEM_MAX,
              "two chains fit a block");
static_assert(2 * (SHARED_BYTES + CHAIN_BYTES + 1024) > 233472,
              "one chain's CTA takes more than half an SM");

constexpr int smem_bytes(int chains) {
  return SHARED_BYTES + chains * CHAIN_BYTES;
}

// Row strides of 272, 80 and 400 bytes and the E tile's 1,632 put the 8
// row addresses of each ldmatrix, and the 4 rows of each half-warp's
// 8-byte E stores, in different bank groups.

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

// bf16 pair, lo in the low half, each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// (a, b) as three bf16 pairs whose low halves sum to a and high halves to
// b exactly: each piece the rounding of what the earlier ones left (the
// subtractions are exact).
__device__ __forceinline__ void split3(float a, float b, uint32_t (&w)[3]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    w[q] = pack_bf16(a, b);
    a = __fsub_rn(a, bf16_lo(w[q]));
    b = __fsub_rn(b, bf16_hi(w[q]));
  }
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
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

// How the chains' warps meet at the barriers between phases.
enum Sync {
  OWN = 0,       // each chain its own barrier (id 1 + chain, CT threads)
  ALIGNED = 1,   // both chains one barrier (id 1, 2 CT threads): the two
                 // chains run the same phase in each interval
  OFFSET = 2,    // one barrier, chain 1 one interval behind chain 0: an
                 // expand or project interval of one chain beside a
                 // depthwise interval of the other
};

// barrier between two phases of chain q
template <int SYNC>
__device__ __forceinline__ void chain_bar(int q) {
  if (SYNC == OWN)
    asm volatile("bar.sync %0, %1;\n" ::"r"(q + 1), "n"(CT) : "memory");
  else
    asm volatile("bar.sync 1, %0;\n" ::"n"(2 * CT) : "memory");
}

// The ring slot of window row v (-1 .. 17 over a step).
__device__ __forceinline__ int slot_of(int v) { return (v + 1) % NSLOT; }

// Queue the copy of window row v (band row v mod 17) into its ring slot.
__device__ __forceinline__ void load_row(unsigned ring, const uint16_t* rg,
                                         int v, int lt) {
  const int row = (v + ROWS) % ROWS;
  const unsigned base = ring + slot_of(v) * SLOT_BYTES;
  for (int q = lt; q < NR * CH / 8; q += CT) {
    const int k = q / (CH / 8), c = q % (CH / 8);
    cp_async16(base + (k * RS + 8 * c) * 2, rg + k * MB + row * CH + 8 * c);
  }
}

template <int CHAINS, int SYNC>
__global__ void __launch_bounds__(2 * CT, 1)
mbpipe_kernel(uint16_t* __restrict__ r, const uint16_t* __restrict__ we,
              const uint16_t* __restrict__ wp, const float* __restrict__ wdw,
              float* __restrict__ e_out, float* __restrict__ d_out,
              float* __restrict__ p_out, int reps, float bias, float cu) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* weT = reinterpret_cast<uint16_t*>(smem);          // [NE][WES]
  uint16_t* wpT = reinterpret_cast<uint16_t*>(smem + WE_BYTES);  // [NR][WPS]
  float* wdw_s = reinterpret_cast<float*>(smem + WE_BYTES + WP_BYTES);
  const int tid = threadIdx.x;
  for (int x = tid; x < NR * NE; x += CHAINS * CT) {
    weT[(x % NE) * WES + x / NE] = we[x];    // we (NR, NE)
    wpT[(x % NR) * WPS + x / NR] = wp[x];    // wp (NE, NR)
  }
  for (int x = tid; x < 9 * NE; x += CHAINS * CT) wdw_s[x] = wdw[x];
  __syncthreads();

  const int q = tid / CT, lt = tid % CT;     // chain, its thread
  const int lw = lt / 32, lane = lt % 32;
  const int gq = lane / 4, tq = lane % 4;    // mma fragment row, column
  unsigned char* cs = smem + SHARED_BYTES + q * CHAIN_BYTES;
  float* et = reinterpret_cast<float*>(cs);                 // [G][ES]
  unsigned char* dp = cs + E_BYTES;                          // [3][G][DS]
  const unsigned ring = static_cast<unsigned>(
      __cvta_generic_to_shared(cs + E_BYTES + D_BYTES));
  const unsigned we_s = static_cast<unsigned>(__cvta_generic_to_shared(weT));
  const unsigned wp_s = static_cast<unsigned>(__cvta_generic_to_shared(wpT));
  const unsigned dp_s = static_cast<unsigned>(__cvta_generic_to_shared(dp));
  const size_t bc = static_cast<size_t>(blockIdx.x) * CHAINS + q;  // band,
  uint16_t* rg = r + bc * NR * MB;                              // chain
  float* eo = e_out + bc * NE * MB;
  float* dout = d_out + bc * NE * MP;
  float* po = p_out + bc * NR * MP;
  // ldmatrix lane roles: the row of an A tile (m 0..15) and its k half,
  // the k row of a B tile and its n half
  const int arow = lane % 8 + 8 * (lane / 8 % 2), akof = 8 * (lane / 16);
  const int brow = arow, bnof = akof;
  if (SYNC == OFFSET && q == 1) chain_bar<SYNC>(q);   // one interval behind

  for (int rep = 0; rep < reps; ++rep) {
    const bool out = rep == reps - 1;
    for (int v = -1; v <= 3; ++v) load_row(ring, rg, v, lt);
    cp_async_commit();
    for (int i = 0; i < OROWS; ++i) {
      if (i + 4 <= ROWS) load_row(ring, rg, i + 4, lt);
      cp_async_commit();
      cp_async_wait<1>();                    // window rows i - 1 .. i + 3
      chain_bar<SYNC>(q);
      // the warp's n-tiles j = lw + 8 m of the window (flat pixels
      // 128 i - 8 + 8 j ..): both k-steps' B fragments, held for the row
      uint32_t bf[TPW][4];
#pragma unroll
      for (int m = 0; m < TPW; ++m) {
        const int j = lw + WARPS * m;
        if (j < NT) {
          const int v = i - 1 + (j + 15) / 16, col = (j + 15) % 16 * 8;
          ldsm_x4_trans(bf[m], ring + slot_of(v) * SLOT_BYTES +
                                   (lane * RS + col) * 2);
        }
      }
      float pacc[2][2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) pacc[a][b][e] = 0.f;

#pragma unroll 1
      for (int g = 0; g < NG; ++g) {
        // 1. expand channels 16 g .. 16 g + 15 over the window
        uint32_t aw[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          ldsm_x4(aw[ks], we_s + ((G * g + arow) * WES + 16 * ks + akof) * 2);
#pragma unroll
        for (int m = 0; m < TPW; ++m) {
          const int j = lw + WARPS * m;
          if (j < NT) {
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            mma(acc, aw[0], bf[m][0], bf[m][1]);
            mma(acc, aw[1], bf[m][2], bf[m][3]);
            float* e0 = et + gq * ES + 8 * j + 2 * tq;
            *reinterpret_cast<float2*>(e0) =
                make_float2(fmaxf(__fadd_rn(acc[0], bias), 0.f),
                            fmaxf(__fadd_rn(acc[1], bias), 0.f));
            *reinterpret_cast<float2*>(e0 + 8 * ES) =
                make_float2(fmaxf(__fadd_rn(acc[2], bias), 0.f),
                            fmaxf(__fadd_rn(acc[3], bias), 0.f));
          }
        }
        chain_bar<SYNC>(q);
        // 2. depthwise of channels 2 lw, 2 lw + 1: pixels 4 lane .. + 3
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cl = 2 * lw + h, c = G * g + cl;
          const float* er = et + cl * ES;
          float wt[9];
#pragma unroll
          for (int t = 0; t < 9; ++t) wt[t] = wdw_s[t * NE + c];
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int dr = 0; dr < 3; ++dr) {
            const int base = 8 + CH * dr + 4 * lane;   // window pixel
            const float4 c4 = *reinterpret_cast<const float4*>(er + base);
            float lft = __shfl_sync(0xffffffffu, c4.w, (lane + 31) % 32);
            float rgt = __shfl_sync(0xffffffffu, c4.x, (lane + 1) % 32);
            if (lane == 0) lft = er[base - 1];
            if (lane == 31) rgt = er[base + 4];
            if (out && (dr == 0 || i == OROWS - 1))
              *reinterpret_cast<float4*>(eo + c * MB + CH * (i + dr) +
                                         4 * lane) = c4;
            const float lv[4] = {lft, c4.x, c4.y, c4.z};
            const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
            const float rv[4] = {c4.y, c4.z, c4.w, rgt};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              acc[k] = fmaf(wt[3 * dr], lv[k], acc[k]);
              acc[k] = fmaf(wt[3 * dr + 1], cv[k], acc[k]);
              acc[k] = fmaf(wt[3 * dr + 2], rv[k], acc[k]);
            }
          }
          float d[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            d[k] = fmaxf(__fadd_rn(acc[k], bias), 0.f);
          if (out)
            *reinterpret_cast<float4*>(dout + c * MP + CH * i + 4 * lane) =
                make_float4(d[0], d[1], d[2], d[3]);
          uint32_t w01[3], w23[3];
          split3(d[0], d[1], w01);
          split3(d[2], d[3], w23);
#pragma unroll
          for (int s = 0; s < 3; ++s) {
            unsigned char* dst = dp + ((s * G + cl) * DS + 4 * lane) * 2;
            *reinterpret_cast<uint2*>(dst) = make_uint2(w01[s], w23[s]);
          }
        }
        chain_bar<SYNC>(q);
        // 3. project: p[:, 16 lw .. 16 lw + 15] += wp^T[:, group] x piece
        uint32_t ap[2][4];
#pragma unroll
        for (int mo = 0; mo < 2; ++mo)
          ldsm_x4(ap[mo], wp_s + ((16 * mo + arow) * WPS + G * g + akof) * 2);
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          uint32_t bd[4];
          ldsm_x4_trans(bd, dp_s + ((s * G + brow) * DS + 16 * lw + bnof) * 2);
#pragma unroll
          for (int mo = 0; mo < 2; ++mo) {
            mma(pacc[mo][0], ap[mo], bd[0], bd[1]);
            mma(pacc[mo][1], ap[mo], bd[2], bd[3]);
          }
        }
      }
      // r row i + 1 from its old value (ring) and p
      const unsigned char* old = reinterpret_cast<const unsigned char*>(
          cs + E_BYTES + D_BYTES + slot_of(i + 1) * SLOT_BYTES);
#pragma unroll
      for (int mo = 0; mo < 2; ++mo)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int k = 16 * mo + gq + 8 * hf;
            const int px = 16 * lw + 8 * n + 2 * tq;
            const float p0 = pacc[mo][n][2 * hf], p1 = pacc[mo][n][2 * hf + 1];
            const uint32_t o =
                *reinterpret_cast<const uint32_t*>(old + (k * RS + px) * 2);
            *reinterpret_cast<uint32_t*>(rg + k * MB + CH * (i + 1) + px) =
                pack_bf16(__fadd_rn(bf16_lo(o), __fmul_rn(p0, cu)),
                          __fadd_rn(bf16_hi(o), __fmul_rn(p1, cu)));
            if (out)
              *reinterpret_cast<float2*>(po + k * MP + CH * i + px) =
                  make_float2(p0, p1);
          }
    }
    cp_async_wait<0>();
    __threadfence();                         // r's new rows, for the next
    chain_bar<SYNC>(q);                      // step's copies
  }
  if (SYNC == OFFSET && q == 0) chain_bar<SYNC>(q);   // chain 1's last
}

template <int CHAINS, int SYNC>
cudaError_t launch(void* r, const void* we, const void* wp, const void* wdw,
                   void* e, void* d, void* p, int bands, int reps,
                   float bias, float cu, cudaStream_t stream) {
  auto kern = mbpipe_kernel<CHAINS, SYNC>;
  constexpr int smem = smem_bytes(CHAINS);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<bands, CHAINS * CT, smem, stream>>>(
      static_cast<uint16_t*>(r), static_cast<const uint16_t*>(we),
      static_cast<const uint16_t*>(wp), static_cast<const float*>(wdw),
      static_cast<float*>(e), static_cast<float*>(d), static_cast<float*>(p),
      reps, bias, cu);
  return cudaGetLastError();
}

}  // namespace

// `reps` band steps of `chains` (1 or 2) chains on each of `bands` bands,
// one CTA a band, in place on r (bands, chains, 32, 2176) bf16, from we
// (32, 192) bf16, wp (192, 32) bf16 and wdw (9, 192) f32; the last step's
// E (bands, chains, 192, 2176), D (bands, chains, 192, 1920) and p (bands,
// chains, 32, 1920) f32 into e, d and p; all row-major, on `stream`.  sync
// (two chains only): 0 each chain its own barriers, 1 one barrier with the
// chains' phases aligned, 2 one barrier with chain 1 an interval behind.
// Returns the launch's cudaError_t.
extern "C" int dgt_probe_mbpipe(void* r, const void* we, const void* wp,
                                const void* wdw, void* e, void* d, void* p,
                                int bands, int chains, int sync, int reps,
                                float bias, float cu, void* stream) {
  if (bands < 1 || reps < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chains == 1 && sync == OWN)
    return (int)launch<1, OWN>(r, we, wp, wdw, e, d, p, bands, reps, bias,
                               cu, st);
  if (chains != 2) return (int)cudaErrorInvalidValue;
  switch (sync) {
    case OWN: return (int)launch<2, OWN>(r, we, wp, wdw, e, d, p, bands,
                                         reps, bias, cu, st);
    case ALIGNED: return (int)launch<2, ALIGNED>(r, we, wp, wdw, e, d, p,
                                                 bands, reps, bias, cu, st);
    case OFFSET: return (int)launch<2, OFFSET>(r, we, wp, wdw, e, d, p,
                                               bands, reps, bias, cu, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
