// eComformer tensor-product weight generation + contraction, backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cartnet_tpu/ops/pallas/tp_kernels.py:
// _bwd_call -> _tp_bwd_kernel (driven by _l1_bwd / _l2_bwd). With W given as
// wt [5120, d] (nn.Linear layout), the cotangents dc of the forward's
// outputs, and a and dc already in h's dtype (the wrapper rounds them):
//   w_all[e, c]  = round(h[e] . wt[c] + b[c])          (recomputed)
//   da_p[e, u]   = sum_v round(dc_p[e, v] * w_all[e, off + u*V + v])
//   dwall[e, off + u*V + v] = round(dc_p[e, v] * a_p[e, u])
//   dh  = round(dwall @ wt)      dwt = dwall^T h      db = sum_e dwall
// L1 paths (64,64,0), (64,8,4096), (64,8,4608): one a [E, 64] whose three
// path terms are summed in f32 before one rounding, dc0 [E,64], dc1 [E,8],
// dc2 [E,8]. L2 paths (64,64,0), (8,64,4096), (8,64,4608): a0 [E,64],
// a1 [E,8], a2 [E,8] and one dc [E, 64] for all three paths. Rounding is to
// h's dtype at the Pallas kernel's points; dh, da in h's dtype; dwt, db f32.
// With f32 h nothing is rounded and no TF32 is used.
//
// What bounds it: three E x d x 5120 products (the w_all recompute, dh and
// dwt), 165 GFLOP at E = 20992, d = 256, against ~30 MB of inputs and
// outputs: the tensor cores (bf16: 0.168 ms at the 989 TFLOP/s of an NVIDIA
// H100 SXM at its 700 W limit) or the f32 FMA rate. Nothing of size
// [E, 5120] or [E, U, V] reaches device memory (dwall alone would be 215 MB
// in bf16 at those shapes, 0.13 ms at that card's 3.35 TB/s), no float
// atomics, every sum in a fixed order: the results
// repeat bitwise. d % 128 == 0 and d <= 512 (the wrapper zero-pads other
// widths: padded columns of h and wt are zero, so w_all, da and the real
// columns of dh and dwt are unchanged).
//
// bf16 design, wgmma + TMA, three launches:
//  (a) tile pass, dh and da: a persistent grid (one block per SM) walking
//      64-edge tiles in a static order (tile = blockIdx.x + k gridDim.x).
//      Block = two consumer warpgroups + one producer warp. The producer
//      loads the h tile [64, d] by TMA (d/64 128-byte swizzled slabs, once
//      per tile) and streams wt through a ring of 64 x 64 slabs (TMA,
//      mbarrier completion): chunk ch is the d/64 slabs of wt rows
//      [64 ch, 64 ch + 64), the same for every tile (L2-resident). Each
//      chunk's slabs serve both products: the w_all recompute reads them
//      K-major, dh += dwall_ch @ wt_ch reads them MN-major, so wt is loaded
//      once for both. The two warpgroups split each product by columns:
//      * d <= 256 (tp_bwd_tile_split): warpgroup wg runs w_all_ch's 32
//        columns from 32 wg (wgmma m64n32k16, A = the h tile) and dh's d/2
//        columns from wg d/2 (wgmma m64n64k16 with A from registers: the
//        A fragments of dwall_ch = round(dc (x) a) are computed in
//        registers from the tile's a and dc rows, staged in shared memory,
//        so no dwall tile passes through shared memory). The next chunk's
//        w_all product is started before the current chunk's epilogue, and
//        the current chunk's slabs go back to the producer before it, so
//        the epilogue (w = round(acc + b), round(w dc), fixed-order sums
//        over v, quad shuffles) runs while the next product is in flight;
//        each warpgroup sums its half of every row into its own f32 da
//        table, and the two are added in a fixed order at the tile's end.
//        The ring holds two chunks at once.
//      * d = 384, 512 (tp_bwd_tile_tc): dh's [64, d] f32 accumulator
//        takes d/4 registers a thread per half, which leaves no room for a
//        second chunk in flight; each chunk's w_all product runs on one
//        owner warpgroup (wgmma m64n64k16), both warpgroups build dwall_ch
//        into a swizzled shared tile (fence.proxy.async) and accumulate
//        their d/2 columns of dh from it; the owner's epilogue runs while
//        the dh products do. A chunk's owner is fixed so that the three L1
//        path terms of one a column land in one thread, in path order.
//  (b) weight pass, dwt and db: output tiles of 128 rows (two chunks, one
//      per warpgroup) x 128 columns of dwt, E split over KSPLIT ranges so
//      that tiles x KSPLIT fills the SMs. A = dwall^T (MN-major) is built in
//      shared memory from a and dc (double-buffered, the next step's a/dc
//      loads in flight during the product); B = h (MN-major) arrives by TMA
//      in a 4-stage ring; wgmma m64n128k16. The blocks of the first column
//      tile also sum their dwall columns (db) in a fixed order. (256-row
//      tiles, each h box feeding four chunks, measured slower: 0.30 against
//      0.18 ms device at d = 256 on an NVIDIA H100 80GB HBM3 at 700 W.)
//  (c) reduce: the KSPLIT partials of dwt and db in split order.
//
// f32 design (no TF32: FMA on the CUDA cores, bound by their 67 TFLOP/s,
// 2.47 ms for the 165 GFLOP at E = 20992, d = 256): the three products as
// SIMT GEMM tiles of 64 x 128 (simt_gemm.cuh: 128 threads, an 8 x 8
// register micro-tile each, k-slabs of 8 double-buffered through shared
// memory with the next slab's loads in flight during the FMAs, four
// blocks an SM), three launches:
//  (a) tile pass, two kinds of block in one grid: dh tiles (64 edges x 128
//      columns of dh over K = 5120, A = dwall computed from dc and a as it
//      is staged, B = wt), then w_all tiles (64 edges x two chunks over
//      K = d, A = h, B = wt^T) whose epilogue forms da; the long dh tiles
//      come first in the grid so the short ones fill its last wave. Each
//      tile's width is fixed, so every d up to 512 runs the same registers.
//      L2 and L1's path 0 write da; L1's path 1 and 2 terms of each a column
//      go to two [E, 64] f32 scratch tables.
//  (b) weight pass, dwt and db: tiles of one chunk (64 rows) x 128 columns
//      of dwt over KSPLIT edge ranges that fill the SMs' block slots (A =
//      dwall^T computed, B = h); the blocks of the first column tile also
//      sum db, each thread over its edges in order, then the 8 edge lanes.
//  (c) reduce: dwt and db over the ranges in range order, and L1's da as
//      path 0 + path 1 + path 2, in path order.
// Elementwise steps use explicitly rounded operations (__fmul_rn,
// __fadd_rn), so nvcc contracts nothing the plain version rounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper_common.cuh"
#include "simt_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int NUMEL = 5120;
constexpr int CW = 64;              // wt rows (w_all columns) per chunk
constexpr int NCHUNK = NUMEL / CW;  // 80
constexpr int CH_P1 = 4096 / CW;    // first chunk of path 1 (64)
constexpr int CH_P2 = 4608 / CW;    // first chunk of path 2 (72)
constexpr int NTHREADS = 256;       // the reduce passes: 8 warps
constexpr long long SMEM_LIMIT = 232448;  // bytes a block may use

// a table: L1 a [64]; L2 a0 | a1 | a2 [80]. dc table: L1 dc0 | dc1 | dc2
// [80]; L2 dc [64].
template <bool L2> __host__ __device__ constexpr int a_width() {
  return L2 ? 80 : 64;
}
template <bool L2> __host__ __device__ constexpr int dc_width() {
  return L2 ? 64 : 80;
}

template <bool L2, typename T>
__device__ __forceinline__ T a_at(const T* a0, const T* a1, const T* a2,
                                  size_t e, int col) {
  if (!L2 || col < 64) return a0[e * 64 + col];
  return col < 72 ? a1[e * 8 + col - 64] : a2[e * 8 + col - 72];
}
template <bool L2, typename T>
__device__ __forceinline__ T dc_at(const T* dc0, const T* dc1, const T* dc2,
                                   size_t e, int col) {
  if (L2 || col < 64) return dc0[e * 64 + col];
  return col < 72 ? dc1[e * 8 + col - 64] : dc2[e * 8 + col - 72];
}

// ============================================ bf16: wgmma + TMA (3 passes)

constexpr int TC_THREADS = 288;  // two consumer warpgroups + a producer warp
constexpr int TE = 64;           // edges per tile (one wgmma M)
constexpr int TAB = 80;          // row width of the staged a / dc tables
constexpr int TC_MAX_STAGES = 16;
constexpr int W_STAGES = 4;      // pass (b) ring: two h slabs a stage
constexpr int W_ROWS = 128;      // pass (b) output tile: two chunks ...
constexpr int W_COLS = 128;      // ... x 128 columns of d
constexpr int KSPLIT_MAX = 4;

struct TcArgs {
  const bf16 *h, *a0, *a1, *a2, *wt, *bias, *dc0, *dc1, *dc2;
  bf16 *dh, *da0, *da1, *da2;
  float* w_part;   // [ksplit][5120 d]
  float* db_part;  // [ksplit][5120]
  int E, d;
};

// shared-memory plan of the tile pass (bytes from the 1024-aligned base;
// total includes the 1024 bytes of alignment slack): the h tile (d/64
// slabs), one dwall slab per warpgroup, the a and dc tables [64][80] bf16,
// the da table [64][80] f32, then the wt ring (as many 8 KB slabs as fit,
// up to 16; a chunk's d/64 slabs must fit at once) and its barriers
struct TileLayout {
  int stages;
  size_t h, dw, a, dc, da, ring, bars, total;
  __host__ __device__ explicit TileLayout(int d) {
    h = 0;
    dw = h + (size_t)d * 128;
    a = dw + 2 * (size_t)SLAB;
    dc = a + (size_t)TE * TAB * 2;
    da = dc + (size_t)TE * TAB * 2;
    ring = (da + (size_t)TE * TAB * 4 + 1023) / 1024 * 1024;
    const long long s = (SMEM_LIMIT - 1024 - (long long)ring -
                         16 * TC_MAX_STAGES - 16) / SLAB;
    stages = (int)(s < TC_MAX_STAGES ? (s < 0 ? 0 : s) : TC_MAX_STAGES);
    bars = ring + (size_t)stages * SLAB;  // full[S], empty[S], h_full/empty
    total = 1024 + bars + 16 * (size_t)stages + 16;
  }
};

// pass (b): the h ring, two A buffers per warpgroup, the db sums, barriers
constexpr size_t W_RING = 0;
constexpr size_t W_A = W_RING + (size_t)W_STAGES * 2 * SLAB;
constexpr size_t W_RED = W_A + 4 * (size_t)SLAB;  // [2 wg][16][64] f32
constexpr size_t W_BARS = W_RED + 2 * 16 * 64 * 4;
constexpr size_t WEIGHT_SMEM = 1024 + W_BARS + 16 * W_STAGES;

__device__ __forceinline__ uint32_t as_u32(bf162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ bf162 as_bf162(uint32_t u) {
  return *reinterpret_cast<bf162*>(&u);
}
// Two adjacent columns of one row: w = round(acc + b) (one bf16x2
// conversion), p = round(w * x) (one bf16x2 multiply: the exact product of
// two bf16 values rounded once), the Pallas kernel's rounding points
__device__ __forceinline__ float2 term2(float acc0, float acc1, float2 b,
                                        bf162 x) {
  const bf162 w =
      __floats2bfloat162_rn(__fadd_rn(acc0, b.x), __fadd_rn(acc1, b.y));
  return __bfloat1622float2(__hmul2(w, x));
}
// quad (4 lanes of one accumulator row) sum, the same bits in every lane
__device__ __forceinline__ float quad_sum(float s) {
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
  return __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
}
// eight dwall values = round(dc[0..7] * a), packed as 16 bytes
__device__ __forceinline__ uint4 dwall8(uint4 dv, bf16 a) {
  const bf162 a2 = __bfloat162bfloat162(a);
  return make_uint4(as_u32(__hmul2(as_bf162(dv.x), a2)),
                    as_u32(__hmul2(as_bf162(dv.y), a2)),
                    as_u32(__hmul2(as_bf162(dv.z), a2)),
                    as_u32(__hmul2(as_bf162(dv.w), a2)));
}

// The warpgroup that owns chunk ch's w_all product and da epilogue: L1's
// u takes path terms from chunks u, 64 + u/8 and 72 + u/8, all owned by
// warpgroup (u / 8) % 2, so one thread sums them in path order
__device__ __forceinline__ int owner_of(bool l2, int ch) {
  return (l2 || ch >= CH_P1) ? (ch & 1) : ((ch >> 3) & 1);
}

// dwall_ch [64 edges, 64 columns] from the staged tables -> the warpgroup's
// swizzled K-major tile. Thread wt: columns 8 (wt % 8) .. + 7 of rows
// wt / 8 + 16 q.
template <bool L2>
__device__ __forceinline__ void build_dwall(const bf16* a_s,
                                            const bf16* dc_s, int ch,
                                            unsigned char* dw_g, int wt) {
  const int vc = wt & 7;
  const bool v64 = L2 || ch < CH_P1;
  const int dcol = v64 ? 8 * vc : (ch < CH_P2 ? 64 : 72);
  const int acol = v64 ? ch : (ch - (ch < CH_P2 ? CH_P1 : CH_P2)) * 8 + vc;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = (wt >> 3) + 16 * q;
    const uint4 dv = *reinterpret_cast<const uint4*>(dc_s + r * TAB + dcol);
    *reinterpret_cast<uint4*>(dw_g + sw_off(r, 8 * vc)) =
        dwall8(dv, a_s[r * TAB + acol]);
  }
}

// da from the owner's w_all chunk in registers: acc[4 i + 2 hr + j] holds
// row r_lo + 8 hr, column 8 i + 2 t4 + j of the chunk
template <bool L2>
__device__ __forceinline__ void da_epilogue(const float (&acc)[32],
                                            const bf16* bias,
                                            const bf16* dc_s, float* da_s,
                                            int ch, int r_lo, int t4) {
  const bf162* b2 = reinterpret_cast<const bf162*>(bias + ch * CW) + t4;
  const bf16* dlo = dc_s + r_lo * TAB;
  const bf16* dhi = dc_s + (r_lo + 8) * TAB;
  float* out_lo = da_s + r_lo * TAB;
  float* out_hi = da_s + (r_lo + 8) * TAB;
  if (L2 || ch < CH_P1) {  // V = 64: u = ch (a-table column ch), v = column
    float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 8 * i + 2 * t4;
      const float2 bj = __bfloat1622float2(b2[4 * i]);
      const float2 plo =
          term2(acc[4 * i], acc[4 * i + 1], bj,
                *reinterpret_cast<const bf162*>(dlo + col));
      const float2 phi =
          term2(acc[4 * i + 2], acc[4 * i + 3], bj,
                *reinterpret_cast<const bf162*>(dhi + col));
      s_lo = __fadd_rn(__fadd_rn(s_lo, plo.x), plo.y);
      s_hi = __fadd_rn(__fadd_rn(s_hi, phi.x), phi.y);
    }
    s_lo = quad_sum(s_lo);
    s_hi = quad_sum(s_hi);
    if (t4 == 0) {
      out_lo[ch] = __fadd_rn(out_lo[ch], s_lo);
      out_hi[ch] = __fadd_rn(out_hi[ch], s_hi);
    }
  } else {  // L1 V = 8: column 8 i + v is u = u0 + i, v = 2 t4, 2 t4 + 1
    const bool p1 = ch < CH_P2;
    const int u0 = (ch - (p1 ? CH_P1 : CH_P2)) * 8;
    const int dcol = (p1 ? 64 : 72) + 2 * t4;
    const bf162 dl = *reinterpret_cast<const bf162*>(dlo + dcol);
    const bf162 dh = *reinterpret_cast<const bf162*>(dhi + dcol);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 bj = __bfloat1622float2(b2[4 * i]);
      const float2 plo = term2(acc[4 * i], acc[4 * i + 1], bj, dl);
      const float2 phi = term2(acc[4 * i + 2], acc[4 * i + 3], bj, dh);
      const float s_lo = quad_sum(__fadd_rn(plo.x, plo.y));
      const float s_hi = quad_sum(__fadd_rn(phi.x, phi.y));
      if (t4 == 0) {
        out_lo[u0 + i] = __fadd_rn(out_lo[u0 + i], s_lo);
        out_hi[u0 + i] = __fadd_rn(out_hi[u0 + i], s_hi);
      }
    }
  }
}

// ------------------------------------------------- bf16 pass (a): dh, da
template <bool L2, int NH>
__global__ void __launch_bounds__(TC_THREADS, 1)
    tp_bwd_tile_tc(TcArgs p, const __grid_constant__ CUtensorMap h_m,
                   const __grid_constant__ CUtensorMap wt_m) {
  constexpr int D = 128 * NH, KS = D / 64;
  constexpr int AW = a_width<L2>(), DW = dc_width<L2>();
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const TileLayout L(D);
  const uint32_t raw = saddr(smem_tc);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_tc + (base - raw);
  const Ring ring{base + (uint32_t)L.ring, base + (uint32_t)L.bars,
                  base + (uint32_t)L.bars + 8u * L.stages, L.stages};
  const uint32_t h_full = base + (uint32_t)L.bars + 16u * L.stages;
  const uint32_t h_empty = h_full + 8;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n_tiles = p.E / TE;
  if (tid == 0) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, 8);  // the 8 consumer warps
    }
    mbar_init(h_full, 1);
    mbar_init(h_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer: the h tile, then wt chunk by chunk
    if ((tid & 31) == 0) {
      uint32_t n = 0, it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
        if (it > 0) mbar_wait(h_empty, (it - 1) & 1);
        mbar_expect_tx(h_full, D * 128);
        for (int j = 0; j < KS; ++j)
          tma_load(base + (uint32_t)L.h + j * SLAB, &h_m, h_full, j * 64,
                   t * TE);
        for (int ch = 0; ch < NCHUNK; ++ch)
          for (int j = 0; j < KS; ++j, ++n)
            tma_load(ring.acquire(n, SLAB, SLAB), &wt_m,
                     ring.full + 8 * ring.stage(n), j * 64, ch * CW);
      }
    }
    return;
  }

  const int wg = warp >> 2, wt = tid & 127, wi = wt >> 5, lane = wt & 31;
  const int r_lo = wi * 16 + (lane >> 2), t4 = lane & 3;
  bf16* a_s = reinterpret_cast<bf16*>(gbase + L.a);      // [TE][TAB]
  bf16* dc_s = reinterpret_cast<bf16*>(gbase + L.dc);    // [TE][TAB]
  float* da_s = reinterpret_cast<float*>(gbase + L.da);  // [TE][TAB]
  unsigned char* dw_g = gbase + L.dw + (size_t)wg * SLAB;
  const uint32_t dw_a = base + (uint32_t)L.dw + (uint32_t)wg * SLAB;
  const uint32_t h_a = base + (uint32_t)L.h;
  const bf16 zero = __float2bfloat16_rn(0.f);
  uint32_t pos = 0, it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const size_t e0 = (size_t)t * TE;
    for (int i = tid; i < TE * TAB; i += 256) {
      const int r = i / TAB, c = i % TAB;
      a_s[i] = c < AW ? a_at<L2>(p.a0, p.a1, p.a2, e0 + r, c) : zero;
      dc_s[i] = c < DW ? dc_at<L2>(p.dc0, p.dc1, p.dc2, e0 + r, c) : zero;
      da_s[i] = 0.f;
    }
    bar_sync(1, 256);  // the tables are in place
    mbar_wait(h_full, it & 1);
    float dh[NH][32];
#pragma unroll
    for (int nt = 0; nt < NH; ++nt)
#pragma unroll
      for (int i = 0; i < 32; ++i) dh[nt][i] = 0.f;
    for (int ch = 0; ch < NCHUNK; ++ch) {
      const uint32_t nb = pos;
      pos += KS;
      const bool own = owner_of(L2, ch) == wg;
      float acc[32];
      if (own) {  // w_all chunk = h @ wt_ch^T, in flight during the build
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        for (int ks = 0; ks < KS; ++ks) {
          const uint32_t b_s = ring.wait_full(nb + ks, SLAB);
          fence_acc(acc);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64<0, 0>(acc,
                               sw128_desc(h_a + ks * SLAB + kk * 32, 16, 1024),
                               sw128_desc(b_s + kk * 32, 16, 1024));
        }
        wg_commit();
        fence_acc(acc);
      }
      bar_sync(2 + wg, 128);  // the previous chunk's dh products are done
      build_dwall<L2>(a_s, dc_s, ch, dw_g, wt);
      fence_async_smem();
      bar_sync(2 + wg, 128);  // dwall_ch is in place
#pragma unroll
      for (int nt = 0; nt < NH; ++nt) {  // dh[:, own half] += dwall wt_ch
        const uint32_t b_s = ring.wait_full(nb + wg * NH + nt, SLAB);
        fence_acc(dh[nt]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64<0, 1>(dh[nt], sw128_desc(dw_a + kk * 32, 16, 1024),
                             sw128_desc(b_s + kk * 2048, SLAB, 1024));
      }
      wg_commit();
#pragma unroll
      for (int nt = 0; nt < NH; ++nt) fence_acc(dh[nt]);
      if (own) {  // da while the dh products run
        wg_wait<1>();
        fence_acc(acc);
        da_epilogue<L2>(acc, p.bias, dc_s, da_s, ch, r_lo, t4);
      }
      wg_wait<0>();
#pragma unroll
      for (int nt = 0; nt < NH; ++nt) fence_acc(dh[nt]);
      // a slab is released by all 8 warps, each after seeing it land (so an
      // arrival never counts toward the slab's previous use)
      if (!own)
        for (int s = 0; s < KS; ++s) ring.wait_full(nb + s, SLAB);
      if (lane == 0) {
        for (int s = 0; s < KS; ++s)
          mbar_arrive(ring.empty + 8 * ring.stage(nb + s));
        if (ch == NCHUNK - 1) mbar_arrive(h_empty);
      }
    }
    // dh, rounded: columns wg d/2 + 64 nt + 8 i + 2 t4 (+1)
#pragma unroll
    for (int nt = 0; nt < NH; ++nt)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const size_t row = e0 + r_lo + 8 * hr;
          const int col = wg * (D / 2) + nt * 64 + 8 * i + 2 * t4;
          *reinterpret_cast<bf162*>(p.dh + row * D + col) =
              __floats2bfloat162_rn(dh[nt][4 * i + 2 * hr],
                                    dh[nt][4 * i + 2 * hr + 1]);
        }
    bar_sync(1, 256);  // da_s is complete
    for (int i = tid; i < TE * AW; i += 256) {
      const int r = i / AW, c = i % AW;
      const bf16 v = __float2bfloat16_rn(da_s[r * TAB + c]);
      if (!L2 || c < 64)
        p.da0[(e0 + r) * 64 + c] = v;
      else if (c < 72)
        p.da1[(e0 + r) * 8 + c - 64] = v;
      else
        p.da2[(e0 + r) * 8 + c - 72] = v;
    }
    bar_sync(1, 256);  // the tables are free for the next tile
  }
}

// ------------------------------- bf16 pass (a), d <= 256: column halves
// The same work with every product split between the warpgroups by
// columns, so both do the same work on every chunk, and with the da
// epilogue overlapped with the products: warpgroup wg runs w_all_ch's 32
// columns from 32 wg (wgmma m64n32k16, A = the h tile, B = rows 32 wg.. of
// the chunk's slabs, K-major), the next chunk's product in flight while it
// contracts the current one in registers (its half of each row's sum over
// v goes to its own f32 da table; the two tables are added in a fixed
// order at the tile's end), and accumulates dh's d/2 columns from wg d/2
// from dwall_ch's A fragments computed in registers from the staged a and
// dc rows (wgmma with A from registers, B = the same slabs MN-major), so no
// dwall tile passes through shared memory.

struct SplitLayout {
  int stages;
  size_t h, a, dc, da, bias, ring, bars, total;
  __host__ __device__ explicit SplitLayout(int d) {
    h = 0;  // d/64 slabs
    a = h + (size_t)d * 128;
    dc = a + (size_t)TE * TAB * 2;
    da = dc + (size_t)TE * TAB * 2;           // [2 wg][TE][TAB] f32
    bias = da + 2 * (size_t)TE * TAB * 4;     // b [5120] bf16, every tile
    ring = (bias + (size_t)NUMEL * 2 + 1023) / 1024 * 1024;
    const long long s = (SMEM_LIMIT - 1024 - (long long)ring -
                         16 * TC_MAX_STAGES - 16) / SLAB;
    stages = (int)(s < TC_MAX_STAGES ? (s < 0 ? 0 : s) : TC_MAX_STAGES);
    bars = ring + (size_t)stages * SLAB;  // full[S], empty[S], h_full/empty
    total = 1024 + bars + 16 * (size_t)stages + 16;
  }
};

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// this warp's arrivals on the empty barriers of a chunk's KS slabs
__device__ __forceinline__ void chunk_release(const Ring& ring, uint32_t nb,
                                              int ks_n) {
  if ((threadIdx.x & 31) == 0)
    for (int s = 0; s < ks_n; ++s)
      mbar_arrive(ring.empty + 8 * ring.stage(nb + s));
}

// w_all_ch's 32 columns from 32 wg into acc: the chunk's KS slabs from ring
// position nb (rows 32 wg.. of each, 4096 bytes in), A = the h tile's KS
// slabs at h_a; one commit group
template <int KS>
__device__ __forceinline__ void half_wall_mma(float (&acc)[16],
                                                uint32_t h_a, int wg,
                                                const Ring& ring,
                                                uint32_t nb) {
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t b_s = ring.wait_full(nb + ks, SLAB) + 4096u * wg;
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n32<0, 0>(acc, sw128_desc(h_a + ks * SLAB + kk * 32, 16, 1024),
                         sw128_desc(b_s + kk * 32, 16, 1024));
  }
  wg_commit();
  fence_acc(acc);
}

// the dc values this thread's epilogue multiplies, for the whole tile: rows
// r_lo + 8 hr, columns 32 wg + 8 i + 2 t4 of the V = 64 table (L1 dc0, L2
// dc), and L1's dc1 / dc2 at 2 t4
struct DcHalf {
  bf162 v64[2][4];
  bf162 v8[2][2];
};

template <bool L2>
__device__ __forceinline__ void load_dc_half(const bf16* dc_s, int wg,
                                             int r_lo, int t4, DcHalf& f) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const bf16* row = dc_s + (r_lo + 8 * hr) * TAB;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f.v64[hr][i] = as_bf162(ld_u32(row + 32 * wg + 8 * i + 2 * t4));
    if (!L2) {
      f.v8[0][hr] = as_bf162(ld_u32(row + 64 + 2 * t4));
      f.v8[1][hr] = as_bf162(ld_u32(row + 72 + 2 * t4));
    }
  }
}

// da terms from the warpgroup's half of w_all_ch (acc[4 i + 2 hr + j]: row
// r_lo + 8 hr, column 32 wg + 8 i + 2 t4 + j) into its table da_w: as
// da_epilogue, with the dc values and the bias (staged in shared memory) at
// hand and two independent sums a row
template <bool L2>
__device__ __forceinline__ void half_da_epilogue(const float (&acc)[16],
                                                 int ch, int wg,
                                                 const bf16* bias_s,
                                                 const DcHalf& dc,
                                                 float* da_w, int r_lo,
                                                 int t4) {
  const bf162* b2 =
      reinterpret_cast<const bf162*>(bias_s + ch * CW + 32 * wg) + t4;
  float* out[2] = {da_w + r_lo * TAB, da_w + (r_lo + 8) * TAB};
  if (L2 || ch < CH_P1) {  // V = 64: u = ch (a-table column ch), v = column
    float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 bj = __bfloat1622float2(b2[4 * i]);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float2 pr = term2(acc[4 * i + 2 * hr], acc[4 * i + 2 * hr + 1],
                                bj, dc.v64[hr][i]);
        sum[hr][i & 1] = __fadd_rn(__fadd_rn(sum[hr][i & 1], pr.x), pr.y);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float v = quad_sum(__fadd_rn(sum[hr][0], sum[hr][1]));
      if (t4 == 0) out[hr][ch] = __fadd_rn(out[hr][ch], v);
    }
  } else {  // L1 V = 8: column 8 uu + v is u = u0 + uu, uu = 4 wg + i
    const bool p1 = ch < CH_P2;
    const int u = (ch - (p1 ? CH_P1 : CH_P2)) * 8 + 4 * wg;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 bj = __bfloat1622float2(b2[4 * i]);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float2 pr = term2(acc[4 * i + 2 * hr], acc[4 * i + 2 * hr + 1],
                                bj, dc.v8[p1 ? 0 : 1][hr]);
        const float v = quad_sum(__fadd_rn(pr.x, pr.y));
        if (t4 == 0) out[hr][u + i] = __fadd_rn(out[hr][u + i], v);
      }
    }
  }
}

// the A fragments of dwall_ch [64, 64] for this thread (k16 step kk:
// columns 16 kk + 2 t4 (+1, +8, +9), rows r_lo, r_lo + 8), from the staged
// a and dc rows: round(dc * a), as build_dwall
template <bool L2>
__device__ __forceinline__ void dwall_frags(const bf16* a_s,
                                            const bf16* dc_s, int ch,
                                            int r_lo, int t4,
                                            uint32_t (&af)[4][4]) {
  const bf16* dlo = dc_s + r_lo * TAB;
  const bf16* dhi = dc_s + (r_lo + 8) * TAB;
  const bf16* alo = a_s + r_lo * TAB;
  const bf16* ahi = a_s + (r_lo + 8) * TAB;
  if (L2 || ch < CH_P1) {  // V = 64: dc[v = column] * a[u = ch]
    const bf162 al = __bfloat162bfloat162(alo[ch]);
    const bf162 ah = __bfloat162bfloat162(ahi[ch]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = 16 * kk + 2 * t4;
      af[kk][0] = as_u32(__hmul2(as_bf162(ld_u32(dlo + c)), al));
      af[kk][1] = as_u32(__hmul2(as_bf162(ld_u32(dhi + c)), ah));
      af[kk][2] = as_u32(__hmul2(as_bf162(ld_u32(dlo + c + 8)), al));
      af[kk][3] = as_u32(__hmul2(as_bf162(ld_u32(dhi + c + 8)), ah));
    }
  } else {  // L1 V = 8: column 8 uu + v is dc[64|72 + v] * a[u0 + uu]
    const bool p1 = ch < CH_P2;
    const int u0 = (ch - (p1 ? CH_P1 : CH_P2)) * 8;
    const int dcol = (p1 ? 64 : 72) + 2 * t4;
    const bf162 dl = as_bf162(ld_u32(dlo + dcol));
    const bf162 dh = as_bf162(ld_u32(dhi + dcol));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int u = u0 + 2 * kk;
      af[kk][0] = as_u32(__hmul2(dl, __bfloat162bfloat162(alo[u])));
      af[kk][1] = as_u32(__hmul2(dh, __bfloat162bfloat162(ahi[u])));
      af[kk][2] = as_u32(__hmul2(dl, __bfloat162bfloat162(alo[u + 1])));
      af[kk][3] = as_u32(__hmul2(dh, __bfloat162bfloat162(ahi[u + 1])));
    }
  }
}

// dh[:, wg d/2 ..] += dwall_ch @ wt_ch: n-tile nt reads slab wg NH + nt
// (MN-major) of the chunk at ring position nb; A = af; one commit group
template <int NH>
__device__ __forceinline__ void half_dh_mma(float (&dh)[NH][32],
                                              const uint32_t (&af)[4][4],
                                              int wg, const Ring& ring,
                                              uint32_t nb, bool first) {
  uint32_t b_s[NH];
#pragma unroll
  for (int nt = 0; nt < NH; ++nt)
    b_s[nt] = ring.wait_full(nb + wg * NH + nt, SLAB);
#pragma unroll
  for (int nt = 0; nt < NH; ++nt) fence_acc(dh[nt]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nt = 0; nt < NH; ++nt)
      wgmma_m64n64_rs<1>(dh[nt], af[kk],
                         sw128_desc(b_s[nt] + kk * 2048, SLAB, 1024),
                         !(first && kk == 0));
  wg_commit();
#pragma unroll
  for (int nt = 0; nt < NH; ++nt) fence_acc(dh[nt]);
}

template <bool L2, int NH>
__global__ void __launch_bounds__(TC_THREADS, 1)
    tp_bwd_tile_split(TcArgs p, const __grid_constant__ CUtensorMap h_m,
                      const __grid_constant__ CUtensorMap wt_m) {
  constexpr int D = 128 * NH, KS = D / 64;
  constexpr int AW = a_width<L2>(), DW = dc_width<L2>();
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const SplitLayout L(D);
  const uint32_t raw = saddr(smem_tc);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_tc + (base - raw);
  const Ring ring{base + (uint32_t)L.ring, base + (uint32_t)L.bars,
                  base + (uint32_t)L.bars + 8u * L.stages, L.stages};
  const uint32_t h_full = base + (uint32_t)L.bars + 16u * L.stages;
  const uint32_t h_empty = h_full + 8;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n_tiles = p.E / TE;
  if (tid == 0) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, 8);  // the 8 consumer warps
    }
    mbar_init(h_full, 1);
    mbar_init(h_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer: the h tile, then wt chunk by chunk
    if ((tid & 31) == 0) {
      uint32_t n = 0, it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
        if (it > 0) mbar_wait(h_empty, (it - 1) & 1);
        mbar_expect_tx(h_full, D * 128);
        for (int j = 0; j < KS; ++j)
          tma_load(base + (uint32_t)L.h + j * SLAB, &h_m, h_full, j * 64,
                   t * TE);
        for (int ch = 0; ch < NCHUNK; ++ch)
          for (int j = 0; j < KS; ++j, ++n)
            tma_load(ring.acquire(n, SLAB, SLAB), &wt_m,
                     ring.full + 8 * ring.stage(n), j * 64, ch * CW);
      }
    }
    return;
  }

  const int wg = warp >> 2, wt = tid & 127, wi = wt >> 5, lane = wt & 31;
  const int r_lo = wi * 16 + (lane >> 2), t4 = lane & 3;
  bf16* a_s = reinterpret_cast<bf16*>(gbase + L.a);      // [TE][TAB]
  bf16* dc_s = reinterpret_cast<bf16*>(gbase + L.dc);    // [TE][TAB]
  float* da_s = reinterpret_cast<float*>(gbase + L.da);  // [2][TE][TAB]
  float* da_w = da_s + wg * TE * TAB;
  bf16* bias_s = reinterpret_cast<bf16*>(gbase + L.bias);
  for (int i = tid; i < NUMEL / 8; i += 256)
    reinterpret_cast<uint4*>(bias_s)[i] =
        reinterpret_cast<const uint4*>(p.bias)[i];
  const bf16 zero = __float2bfloat16_rn(0.f);
  const uint32_t h_a = base + (uint32_t)L.h;
  uint32_t pos = 0, it = 0;  // ring position of the tile's first slab
  for (int t = blockIdx.x; t < n_tiles;
       t += gridDim.x, pos += NCHUNK * KS, ++it) {
    const size_t e0 = (size_t)t * TE;
    bar_sync(1, 256);  // the previous tile is done with the tables
    for (int i = tid; i < TE * TAB; i += 256) {
      const int r = i / TAB, c = i % TAB;
      a_s[i] = c < AW ? a_at<L2>(p.a0, p.a1, p.a2, e0 + r, c) : zero;
      dc_s[i] = c < DW ? dc_at<L2>(p.dc0, p.dc1, p.dc2, e0 + r, c) : zero;
      da_s[i] = 0.f;
      da_s[TE * TAB + i] = 0.f;
    }
    bar_sync(1, 256);  // the tables (and the bias) are in place
    DcHalf dcf;
    load_dc_half<L2>(dc_s, wg, r_lo, t4, dcf);
    mbar_wait(h_full, it & 1);
    float dh[NH][32], acc0[16], acc1[16];
    uint32_t af[4][4];
    half_wall_mma<KS>(acc0, h_a, wg, ring, pos);
    for (int ch = 0; ch < NCHUNK; ch += 2) {
      // chunk ch: its dh products, then the next chunk's w_all half; once
      // both of chunk ch's products are done its slabs go back to the
      // producer, and its epilogue runs while the next product does
      dwall_frags<L2>(a_s, dc_s, ch, r_lo, t4, af);
      half_dh_mma<NH>(dh, af, wg, ring, pos + ch * KS, ch == 0);
      half_wall_mma<KS>(acc1, h_a, wg, ring, pos + (ch + 1) * KS);
      wg_wait<1>();
#pragma unroll
      for (int nt = 0; nt < NH; ++nt) fence_acc(dh[nt]);
      fence_acc(acc0);
      chunk_release(ring, pos + ch * KS, KS);
      half_da_epilogue<L2>(acc0, ch, wg, bias_s, dcf, da_w, r_lo, t4);
      // chunk ch + 1, likewise
      dwall_frags<L2>(a_s, dc_s, ch + 1, r_lo, t4, af);
      half_dh_mma<NH>(dh, af, wg, ring, pos + (ch + 1) * KS, false);
      const bool more = ch + 2 < NCHUNK;
      if (more) {
        half_wall_mma<KS>(acc0, h_a, wg, ring, pos + (ch + 2) * KS);
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
#pragma unroll
      for (int nt = 0; nt < NH; ++nt) fence_acc(dh[nt]);
      fence_acc(acc1);
      chunk_release(ring, pos + (ch + 1) * KS, KS);
      if (!more && lane == 0) mbar_arrive(h_empty);  // h is read
      half_da_epilogue<L2>(acc1, ch + 1, wg, bias_s, dcf, da_w, r_lo, t4);
    }
    // dh, rounded: columns wg d/2 + 64 nt + 8 i + 2 t4 (+1)
#pragma unroll
    for (int nt = 0; nt < NH; ++nt)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const size_t row = e0 + r_lo + 8 * hr;
          const int col = wg * (D / 2) + nt * 64 + 8 * i + 2 * t4;
          *reinterpret_cast<bf162*>(p.dh + row * D + col) =
              __floats2bfloat162_rn(dh[nt][4 * i + 2 * hr],
                                    dh[nt][4 * i + 2 * hr + 1]);
        }
    bar_sync(1, 256);  // both da tables are complete
    for (int i = tid; i < TE * AW; i += 256) {
      const int r = i / AW, c = i % AW;
      const bf16 v = __float2bfloat16_rn(
          __fadd_rn(da_s[r * TAB + c], da_s[TE * TAB + r * TAB + c]));
      if (!L2 || c < 64)
        p.da0[(e0 + r) * 64 + c] = v;
      else if (c < 72)
        p.da1[(e0 + r) * 8 + c - 64] = v;
      else
        p.da2[(e0 + r) * 8 + c - 72] = v;
    }
  }
}

// the a value and dc vector of one dwall row for pass (b): chunk ch,
// columns 8 vc .. 8 vc + 7, edge e
template <bool L2>
__device__ __forceinline__ void fetch_row(const TcArgs& p, int ch, int vc,
                                          size_t e, uint4& dv, bf16& av) {
  if (L2 || ch < CH_P1) {
    dv = *reinterpret_cast<const uint4*>(p.dc0 + e * 64 + 8 * vc);
    av = a_at<L2>(p.a0, p.a1, p.a2, e, ch);
  } else {
    const bool p1 = ch < CH_P2;
    dv = *reinterpret_cast<const uint4*>((p1 ? p.dc1 : p.dc2) + e * 8);
    av = p.a0[e * 64 + (ch - (p1 ? CH_P1 : CH_P2)) * 8 + vc];
  }
}

// ----------------------------------------------- bf16 pass (b): dwt, db
// block (rt, ct) x split: dwt rows [128 rt, 128 rt + 128) (chunk 2 rt + wg
// per warpgroup) x columns [128 ct, 128 ct + 128) over one edge range
template <bool L2>
__global__ void __launch_bounds__(TC_THREADS, 1)
    tp_bwd_weights_tc(TcArgs p, int per_split,
                      const __grid_constant__ CUtensorMap h_m) {
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  constexpr uint32_t STAGE = 2 * SLAB;
  const int d = p.d, nct = d / W_COLS;
  const int rt = blockIdx.x / nct, ct = blockIdx.x % nct;
  const uint32_t raw = saddr(smem_tc);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_tc + (base - raw);
  const uint32_t bars = base + (uint32_t)W_BARS;
  const Ring ring{base + (uint32_t)W_RING, bars, bars + 8u * W_STAGES,
                  W_STAGES};
  const int tid = threadIdx.x, warp = tid >> 5;
  const int ebeg = blockIdx.y * per_split;
  const int eend = ebeg + per_split < p.E ? ebeg + per_split : p.E;
  const int nsteps = eend > ebeg ? (eend - ebeg) / TE : 0;
  if (tid == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, 8);  // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer: the h boxes of each 64-edge step
    if ((tid & 31) == 0)
      for (int i = 0; i < nsteps; ++i) {
        const uint32_t st = ring.acquire(i, STAGE, STAGE);
        const uint32_t fb = ring.full + 8 * ring.stage(i);
        tma_load(st, &h_m, fb, ct * W_COLS, ebeg + i * TE);
        tma_load(st + SLAB, &h_m, fb, ct * W_COLS + 64, ebeg + i * TE);
      }
    return;
  }

  const int wg = warp >> 2, wt = tid & 127, wi = wt >> 5, lane = wt & 31;
  const int vc = wt & 7, rg = wt >> 3;
  const int ch = 2 * rt + wg;
  const bool with_db = ct == 0;
  unsigned char* a_g = gbase + W_A + (size_t)wg * 2 * SLAB;
  const uint32_t a_a = base + (uint32_t)W_A + (uint32_t)wg * 2 * SLAB;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float dbs[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) dbs[k] = 0.f;
  uint4 dv[4];
  bf16 av[4];
  if (nsteps > 0)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      fetch_row<L2>(p, ch, vc, (size_t)ebeg + rg + 16 * q, dv[q], av[q]);
  for (int i = 0; i < nsteps; ++i) {
    unsigned char* buf = a_g + (i & 1) * SLAB;
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // dwall^T rows = edges, 64 chunk columns
      const uint4 u = dwall8(dv[q], av[q]);
      *reinterpret_cast<uint4*>(buf + sw_off(rg + 16 * q, 8 * vc)) = u;
      if (with_db) {
        const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(as_bf162(w4[k]));
          dbs[2 * k] = __fadd_rn(dbs[2 * k], f.x);
          dbs[2 * k + 1] = __fadd_rn(dbs[2 * k + 1], f.y);
        }
      }
    }
    if (i + 1 < nsteps)  // the next step's rows, in flight during the product
#pragma unroll
      for (int q = 0; q < 4; ++q)
        fetch_row<L2>(p, ch, vc, (size_t)ebeg + (i + 1) * TE + rg + 16 * q,
                      dv[q], av[q]);
    fence_async_smem();
    bar_sync(2 + wg, 128);  // this step's A tile is in place
    const uint32_t st = ring.wait_full(i, STAGE);
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 edges each
      wgmma_m64n128<1, 1>(
          acc, sw128_desc(a_a + (i & 1) * SLAB + kk * 2048, SLAB, 1024),
          sw128_desc(st + kk * 2048, SLAB, 1024));
    wg_commit();
    fence_acc(acc);
    if (i > 0) {
      wg_wait<1>();
      fence_acc(acc);
      ring.release(i - 1);
    }
    bar_sync(2 + wg, 128);  // every warp saw step i - 1 done: its A is free
  }
  wg_wait<0>();
  fence_acc(acc);
  if (nsteps > 0) ring.release(nsteps - 1);
  float* out = p.w_part + (size_t)blockIdx.y * NUMEL * d +
               (size_t)(ch * CW) * d + ct * W_COLS;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = 8 * i + 2 * (lane & 3);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wi * 16 + (lane >> 2) + 8 * hr;
      *reinterpret_cast<float2*>(out + (size_t)r * d + c) =
          make_float2(acc[4 * i + 2 * hr], acc[4 * i + 2 * hr + 1]);
    }
  }
  if (with_db) {  // the 16 row groups' sums in order
    float* red = reinterpret_cast<float*>(gbase + W_RED) + wg * 16 * 64;
#pragma unroll
    for (int k = 0; k < 8; ++k) red[rg * 64 + 8 * vc + k] = dbs[k];
    bar_sync(2 + wg, 128);
    if (wt < 64) {
      float s = red[wt];
      for (int g = 1; g < 16; ++g) s = __fadd_rn(s, red[g * 64 + wt]);
      p.db_part[(size_t)blockIdx.y * NUMEL + ch * CW + wt] = s;
    }
  }
}

// ------------------------------------------------------ pass (c): reduce
__global__ void __launch_bounds__(NTHREADS)
    tp_bwd_reduce(const float* __restrict__ w_part,
                  const float* __restrict__ db_part, float* __restrict__ dwt,
                  float* __restrict__ db, int n_w, int ksplit) {
  const size_t i = (size_t)blockIdx.x * NTHREADS + threadIdx.x;
  if (i < (size_t)n_w) {
    float s = 0.f;
    for (int k = 0; k < ksplit; ++k)
      s = __fadd_rn(s, w_part[(size_t)k * n_w + i]);
    dwt[i] = s;
  } else if (i < (size_t)n_w + NUMEL) {
    const size_t c = i - n_w;
    float s = 0.f;
    for (int k = 0; k < ksplit; ++k)
      s = __fadd_rn(s, db_part[(size_t)k * NUMEL + c]);
    db[c] = s;
  }
}

// ------------------------------------------------------ f32: CUDA cores

// blocks an SM the f32 passes are compiled for (__launch_bounds__: 128
// registers a thread at four)
constexpr int TILE_BLOCKS_F32 = 4, WEIGHT_BLOCKS_F32 = 4;

struct F32Args {
  const float *h, *a0, *a1, *a2, *wt, *bias, *dc0, *dc1, *dc2;
  float *dh, *da0, *da1, *da2;
  float* da_part;  // L1: [2][E][64], da's path 1 and path 2 terms
  float* w_part;   // [ksplit][5120 d]
  float* db_part;  // [ksplit][5120]
  int E, d;
};

// dwall[e, c .. c + 3] = dc[e, v] * a[e, u] (c % 4 == 0: one u, four v)
template <bool L2>
__device__ __forceinline__ float4 dwall4(const F32Args& p, size_t e, int c) {
  const int ch = c / CW, cc = c % CW;
  float4 dv;
  float av;
  if (L2 || ch < CH_P1) {  // V = 64: u = ch, v = cc
    dv = *reinterpret_cast<const float4*>(p.dc0 + e * 64 + cc);
    av = a_at<L2>(p.a0, p.a1, p.a2, e, ch);
  } else {  // L1 V = 8: u = u0 + cc / 8, v = cc % 8
    const bool p1 = ch < CH_P2;
    dv = *reinterpret_cast<const float4*>((p1 ? p.dc1 : p.dc2) + e * 8 +
                                          (cc & 7));
    av = p.a0[e * 64 + (ch - (p1 ? CH_P1 : CH_P2)) * 8 + (cc >> 3)];
  }
  return make_float4(__fmul_rn(dv.x, av), __fmul_rn(dv.y, av),
                     __fmul_rn(dv.z, av), __fmul_rn(dv.w, av));
}

// A of a dh tile: dwall rows e0 .. e0 + 63 (k = dwall's column), computed
// from dc and a, stored transposed as simt::RowsT<64> stores
template <bool L2>
struct DwallRows {
  using Regs = float4[1];
  const F32Args* p;
  size_t e0;
  __device__ __forceinline__ void fetch(int kt, Regs& v) const {
    const int idx = threadIdx.x;
    v[0] = dwall4<L2>(*p, e0 + (idx >> 1), kt * simt::BK + 4 * (idx & 1));
  }
  __device__ __forceinline__ void store(const Regs& v, float* S) const {
    simt::RowsT<simt::BM>{nullptr, 0, 0}.store(v, S);
  }
};

// A of a weight tile: dwall^T, rows k = edges from ebeg, columns c0 .. c0 +
// 63 (one chunk), stored as simt::ColsD<64> stores. A thread's four
// columns are fixed (4 (idx % 16) ..), so are their dc columns and their a
// column: two pointers walk down them, one slab (8 edges) a fetch, which
// the mainloop calls once per slab in order, with the row strides of the
// chunk's dc and a tables (DC_LD, A_LD) compiled in. The four columns also
// sum into dbs over the thread's edges (ebeg + 8 s + idx / 16, in slab
// order).
template <int DC_LD, int A_LD>
struct DwallCols {
  using Regs = float4[1];
  const float *dcp, *ap;  // the next slab's dc and a values of the thread
  float dbs[4];
  __device__ __forceinline__ void fetch(int, Regs& v) {
    const float4 dv = *reinterpret_cast<const float4*>(dcp);
    const float av = *ap;
    dcp += simt::BK * DC_LD;
    ap += simt::BK * A_LD;
    v[0] = make_float4(__fmul_rn(dv.x, av), __fmul_rn(dv.y, av),
                       __fmul_rn(dv.z, av), __fmul_rn(dv.w, av));
    dbs[0] = __fadd_rn(dbs[0], v[0].x);
    dbs[1] = __fadd_rn(dbs[1], v[0].y);
    dbs[2] = __fadd_rn(dbs[2], v[0].z);
    dbs[3] = __fadd_rn(dbs[3], v[0].w);
  }
  __device__ __forceinline__ void store(const Regs& v, float* S) const {
    simt::ColsD<CW>{nullptr, 0, 0}.store(v, S);
  }
};

// a weight tile's products over nk slabs from edge ebeg (chunk ch, B = h
// columns from 128 ct) into acc, and the thread's db sums into dbs: the
// fetcher of the chunk's tables (V = 64 with a0, or L2's a1 / a2; L1's
// V = 8)
template <bool L2>
__device__ __forceinline__ void weight_products(const F32Args& p, int ebeg,
                                                int ch, int ct, int nk,
                                                float (&acc)[8][8],
                                                float (&dbs)[4],
                                                float* smem) {
  const int cc = 4 * (threadIdx.x % 16);
  const size_t e = (size_t)ebeg + threadIdx.x / 16;
  simt::ColsD<simt::BN> fb{p.h + ct * simt::BN, (size_t)p.d, ebeg};
  auto run = [&](auto fa) {
    simt::mainloop(acc, nk, fa, fb, smem);
#pragma unroll
    for (int q = 0; q < 4; ++q) dbs[q] = fa.dbs[q];
  };
  if (!L2 && ch >= CH_P1) {  // L1 V = 8: dc[v = cc % 8 ..], a[u0 + cc / 8]
    const bool p1 = ch < CH_P2;
    run(DwallCols<8, 64>{
        (p1 ? p.dc1 : p.dc2) + e * 8 + (cc & 7),
        p.a0 + e * 64 + (ch - (p1 ? CH_P1 : CH_P2)) * 8 + (cc >> 3), {}});
  } else if (!L2 || ch < CH_P1) {  // V = 64: dc[v = cc ..], a0[u = ch]
    run(DwallCols<64, 64>{p.dc0 + e * 64 + cc, p.a0 + e * 64 + ch, {}});
  } else {  // L2's paths 1 and 2: a1 / a2 [E, 8], u = ch - 64 | 72
    run(DwallCols<64, 8>{p.dc0 + e * 64 + cc,
                         ch < CH_P2 ? p.a1 + e * 8 + ch - CH_P1
                                    : p.a2 + e * 8 + ch - CH_P2,
                         {}});
  }
}

// da terms of a w_all tile (rows e0.., chunks 2 nt and 2 nt + 1: the
// thread's columns 4 tx + q of each): w = acc + b, p = dc_v w, summed over
// v in a fixed order (the thread's four columns in order, then a shuffle
// tree over the lanes of one u: 16 for V = 64, 2 for L1's V = 8). L2 and
// L1's path 0 write da directly; L1's paths 1 and 2 write their terms to
// da_part, which the reduce adds to path 0's in path order.
template <bool L2>
__device__ __forceinline__ void da_epilogue_f32(const F32Args& p,
                                                const float (&acc)[8][8],
                                                size_t e0, int nt) {
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int ch = 2 * nt + hh;
    const bool v64 = L2 || ch < CH_P1;  // the same for both chunks
    const bool p1 = ch < CH_P2;
    const float4 b4 =
        *reinterpret_cast<const float4*>(p.bias + ch * CW + 4 * tx);
    const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const size_t e = e0 + simt::row_of(i);
      const float4 d4 =
          v64 ? *reinterpret_cast<const float4*>(p.dc0 + e * 64 + 4 * tx)
              : *reinterpret_cast<const float4*>((p1 ? p.dc1 : p.dc2) +
                                                 e * 8 + 4 * (tx & 1));
      const float dq[4] = {d4.x, d4.y, d4.z, d4.w};
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        s = __fadd_rn(s, __fmul_rn(dq[q], __fadd_rn(acc[i][4 * hh + q],
                                                    bq[q])));
      if (v64) {
#pragma unroll
        for (int o = 1; o < 16; o <<= 1)
          s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
        if (tx == 0) {
          if (!L2 || ch < CH_P1)
            p.da0[e * 64 + ch] = s;
          else
            (p1 ? p.da1 : p.da2)[e * 8 + ch - (p1 ? CH_P1 : CH_P2)] = s;
        }
      } else {
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
        if ((tx & 1) == 0)
          p.da_part[(p1 ? 0 : (size_t)p.E * 64) + e * 64 +
                    (ch - (p1 ? CH_P1 : CH_P2)) * 8 + tx / 2] = s;
      }
    }
  }
}

// (a) tile pass: blocks [0, n_dh) are dh tiles (64 edges x 128 columns of
// dh, K = the 5120 columns of dwall, A computed from dc and a, B = wt),
// the rest w_all tiles (64 edges x two chunks, K = d, A = h, B = wt^T) with
// the da epilogue; the long dh tiles come first, so the short ones fill
// the last wave
template <bool L2>
__global__ void __launch_bounds__(simt::THREADS, TILE_BLOCKS_F32)
    tp_bwd_tile_f32(const __grid_constant__ F32Args p, int n_dh) {
  extern __shared__ float4 smem_f32[];
  float* smem = reinterpret_cast<float*>(smem_f32);
  const int d = p.d, nct = d / simt::BN;
  float acc[8][8];
  simt::zero(acc);
  int b = blockIdx.x;
  if (b < n_dh) {
    const size_t e0 = (size_t)(b / nct) * simt::BM;
    const int n0 = (b % nct) * simt::BN;
    DwallRows<L2> fa{&p, e0};
    simt::ColsD<simt::BN> fb{p.wt + n0, (size_t)d, 0};
    simt::mainloop(acc, NUMEL / simt::BK, fa, fb, smem);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float4*>(p.dh + (e0 + simt::row_of(i)) * d + n0 +
                                   simt::col_of(4 * hh)) =
            make_float4(acc[i][4 * hh], acc[i][4 * hh + 1],
                        acc[i][4 * hh + 2], acc[i][4 * hh + 3]);
    return;
  }
  b -= n_dh;
  constexpr int NT = NUMEL / simt::BN;  // w_all column tiles (chunk pairs)
  const size_t e0 = (size_t)(b / NT) * simt::BM;
  const int nt = b % NT;
  simt::RowsT<simt::BM> fa{p.h + e0 * d, (size_t)d, 0};
  simt::RowsT<simt::BN> fb{p.wt + (size_t)nt * simt::BN * d, (size_t)d, 0};
  simt::mainloop(acc, d / simt::BK, fa, fb, smem);
  da_epilogue_f32<L2>(p, acc, e0, nt);
}

// (b) weight pass: block (chunk ch, column tile ct) x split: the KSPLIT
// partial of dwt rows [64 ch, 64 ch + 64) x columns [128 ct, 128 ct + 128)
// over one edge range (A = dwall^T computed, B = h), and of db (ct = 0)
template <bool L2>
__global__ void __launch_bounds__(simt::THREADS, WEIGHT_BLOCKS_F32)
    tp_bwd_weights_f32(const __grid_constant__ F32Args p, int per_split) {
  extern __shared__ float4 smem_f32[];
  float* smem = reinterpret_cast<float*>(smem_f32);
  const int d = p.d, nct = d / simt::BN;
  const int ch = blockIdx.x / nct, ct = blockIdx.x % nct;
  const int ebeg = blockIdx.y * per_split;
  const int eend = ebeg + per_split < p.E ? ebeg + per_split : p.E;
  const int nk = eend > ebeg ? (eend - ebeg) / simt::BK : 0;
  float acc[8][8], dbs[4] = {0.f, 0.f, 0.f, 0.f};
  simt::zero(acc);
  if (nk > 0) weight_products<L2>(p, ebeg, ch, ct, nk, acc, dbs, smem);
  float* out = p.w_part + (size_t)blockIdx.y * NUMEL * d +
               (size_t)(ch * CW) * d + ct * simt::BN;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float4*>(out + (size_t)simt::row_of(i) * d +
                                 simt::col_of(4 * hh)) =
          make_float4(acc[i][4 * hh], acc[i][4 * hh + 1], acc[i][4 * hh + 2],
                      acc[i][4 * hh + 3]);
  if (ct == 0) {  // db: the 8 edge lanes' sums in order
    const int idx = threadIdx.x;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      smem[(idx / 16) * CW + 4 * (idx % 16) + q] = dbs[q];
    __syncthreads();
    if (idx < CW) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) s = __fadd_rn(s, smem[k * CW + idx]);
      p.db_part[(size_t)blockIdx.y * NUMEL + ch * CW + idx] = s;
    }
  }
}

// (c) reduce: the KSPLIT partials of dwt and db in split order; L1's da
// as path 0 + path 1 + path 2, in path order
template <bool L2>
__global__ void __launch_bounds__(NTHREADS)
    tp_bwd_reduce_f32(const __grid_constant__ F32Args p,
                      float* __restrict__ dwt, float* __restrict__ db,
                      int ksplit) {
  const size_t n_w = (size_t)NUMEL * p.d;
  size_t i = (size_t)blockIdx.x * NTHREADS + threadIdx.x;
  if (i < n_w) {
    float s = 0.f;
    for (int k = 0; k < ksplit; ++k)
      s = __fadd_rn(s, p.w_part[(size_t)k * n_w + i]);
    dwt[i] = s;
    return;
  }
  i -= n_w;
  if (i < NUMEL) {
    float s = 0.f;
    for (int k = 0; k < ksplit; ++k)
      s = __fadd_rn(s, p.db_part[(size_t)k * NUMEL + i]);
    db[i] = s;
    return;
  }
  i -= NUMEL;
  if (!L2 && i < (size_t)p.E * 64)
    p.da0[i] = __fadd_rn(__fadd_rn(p.da0[i], p.da_part[i]),
                         p.da_part[(size_t)p.E * 64 + i]);
}

// --------------------------------------------------------------- host

int n_weight_tiles(int d) { return (NUMEL / W_ROWS) * (d / W_COLS); }

// edge ranges of the bf16 weight pass: the KSPLIT (up to 4) whose waves of
// tiles x KSPLIT blocks over the SMs take the least time
int ksplit_of(int E, int d) {
  const int tiles = n_weight_tiles(d), nsm = num_sms();
  int best = 1;
  double best_t = 1e30;
  for (int k = 1; k <= KSPLIT_MAX && k <= E / TE; ++k) {
    const double t = (double)((tiles * k + nsm - 1) / nsm) / k;
    if (t < best_t) {
      best_t = t;
      best = k;
    }
  }
  return best;
}

template <typename K, typename... Args>
cudaError_t launch(K kern, dim3 blocks, int threads, size_t smem,
                   cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<blocks, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <bool L2, int NH>
cudaError_t run_bf16(const TcArgs& p, float* dwt, float* db, cudaStream_t s) {
  constexpr int D = 128 * NH;
  CUtensorMap h_m, wt_m;
  if (!make_map(&h_m, p.h, D, p.E) || !make_map(&wt_m, p.wt, D, NUMEL))
    return cudaErrorInvalidValue;
  const int n_tiles = p.E / TE, nsm = num_sms();
  const dim3 grid(n_tiles < nsm ? n_tiles : nsm);
  cudaError_t err;
  if constexpr (NH <= 2) {  // column halves, two chunks in the ring
    const SplitLayout L(D);
    if (L.stages < 2 * (D / 64) || L.total > (size_t)SMEM_LIMIT)
      return cudaErrorInvalidConfiguration;
    err = launch(tp_bwd_tile_split<L2, NH>, grid, TC_THREADS, L.total, s, p,
                 h_m, wt_m);
  } else {
    const TileLayout L(D);
    if (L.stages < D / 64 || L.total > (size_t)SMEM_LIMIT)
      return cudaErrorInvalidConfiguration;
    err = launch(tp_bwd_tile_tc<L2, NH>, grid, TC_THREADS, L.total, s, p,
                 h_m, wt_m);
  }
  if (err != cudaSuccess) return err;
  const int ksplit = ksplit_of(p.E, D);
  const int per_split = (n_tiles + ksplit - 1) / ksplit * TE;
  err = launch(tp_bwd_weights_tc<L2>, dim3(n_weight_tiles(D), ksplit),
               TC_THREADS, WEIGHT_SMEM, s, p, per_split, h_m);
  if (err != cudaSuccess) return err;
  const int n_w = NUMEL * D;
  tp_bwd_reduce<<<(n_w + NUMEL + NTHREADS - 1) / NTHREADS, NTHREADS, 0, s>>>(
      p.w_part, p.db_part, dwt, db, n_w, ksplit);
  return cudaGetLastError();
}

// edge ranges of the f32 weight pass: as many as fill the SMs' block
// slots (WEIGHT_BLOCKS_F32 an SM) with tiles x KSPLIT blocks
int ksplit_f32(int E, int d) {
  const int tiles = NCHUNK * (d / simt::BN);
  int k = WEIGHT_BLOCKS_F32 * num_sms() / tiles;
  if (k > E / simt::BM) k = E / simt::BM;
  return k < 1 ? 1 : k;
}

template <bool L2>
cudaError_t run_f32(const F32Args& q, void* dwt, void* db, cudaStream_t s) {
  F32Args p = q;
  const int E = p.E, d = p.d, ksplit = ksplit_f32(E, d);
  p.db_part = p.w_part + (size_t)ksplit * NUMEL * d;
  p.da_part = p.db_part + (size_t)ksplit * NUMEL;
  const int n_rows = E / simt::BM;
  const int n_dh = n_rows * (d / simt::BN);
  cudaError_t err = launch(tp_bwd_tile_f32<L2>,
                           dim3(n_dh + n_rows * (NUMEL / simt::BN)),
                           simt::THREADS, simt::SMEM, s, p, n_dh);
  if (err != cudaSuccess) return err;
  const int per_split = (n_rows + ksplit - 1) / ksplit * simt::BM;
  err = launch(tp_bwd_weights_f32<L2>, dim3(NCHUNK * (d / simt::BN), ksplit),
               simt::THREADS, simt::SMEM, s, p, per_split);
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)NUMEL * d + NUMEL + (L2 ? 0 : (size_t)E * 64);
  tp_bwd_reduce_f32<L2><<<(unsigned)((n + NTHREADS - 1) / NTHREADS),
                          NTHREADS, 0, s>>>(p, (float*)dwt, (float*)db,
                                            ksplit);
  return cudaGetLastError();
}

template <bool L2>
cudaError_t run(const void* h, const void* a0, const void* a1,
                const void* a2, const void* wt, const void* bias,
                const void* dc0, const void* dc1, const void* dc2, void* dh,
                void* da0, void* da1, void* da2, void* dwt, void* db,
                void* work, int E, int d, bool is_bf16, cudaStream_t s) {
  if (is_bf16) {
    using T = const bf16*;
    const int ksplit = ksplit_of(E, d);
    const TcArgs p{(T)h,  (T)a0, (T)a1, (T)a2, (T)wt, (T)bias,
                   (T)dc0, (T)dc1, (T)dc2, (bf16*)dh, (bf16*)da0,
                   (bf16*)da1, (bf16*)da2, (float*)work,
                   (float*)work + (size_t)ksplit * NUMEL * d, E, d};
    switch (d) {
      case 128: return run_bf16<L2, 1>(p, (float*)dwt, (float*)db, s);
      case 256: return run_bf16<L2, 2>(p, (float*)dwt, (float*)db, s);
      case 384: return run_bf16<L2, 3>(p, (float*)dwt, (float*)db, s);
      default: return run_bf16<L2, 4>(p, (float*)dwt, (float*)db, s);
    }
  }
  using T = const float*;
  const F32Args p{(T)h,  (T)a0, (T)a1, (T)a2, (T)wt, (T)bias,
                  (T)dc0, (T)dc1, (T)dc2, (float*)dh, (float*)da0,
                  (float*)da1, (float*)da2, nullptr, (float*)work, nullptr,
                  E, d};
  return run_f32<L2>(p, dwt, db, s);
}

bool width_ok(int d) { return d == 128 || d == 256 || d == 384 || d == 512; }

}  // namespace

// Shared memory (bytes) of the block of each pass: kind 0 the bf16 tile
// pass (TileLayout, whose stages must hold a chunk's d / 64 slabs), 1 the
// bf16 weight pass, 2 the f32 tile pass, 3 the f32 weight pass (both the
// double-buffered A and B slabs of simt_gemm.cuh); 0 for an unsupported d.
extern "C" long long tp_contract_bwd_smem(int d, int kind, int l2) {
  (void)l2;
  if (!width_ok(d)) return 0;
  switch (kind) {
    case 0:
      return (long long)(d <= 256 ? SplitLayout(d).total
                                  : TileLayout(d).total);
    case 1: return (long long)WEIGHT_SMEM;
    default: return (long long)simt::SMEM;
  }
}

// floats of scratch the call needs in ``work``: the weight pass's KSPLIT
// partials of dwt and db, and in f32 L1's path 1 and 2 terms of da
extern "C" long long tp_contract_bwd_workspace(int E, int d, int is_bf16) {
  if (!width_ok(d)) return 0;
  if (!is_bf16)
    return (long long)ksplit_f32(E, d) * NUMEL * ((long long)d + 1) +
           2LL * E * 64;
  return (long long)ksplit_of(E, d) * NUMEL * ((long long)d + 1);
}

// C entry point (bound with ctypes). E % 64 == 0, d in {128, 256, 384, 512};
// every tensor in one dtype (is_bf16), 16-byte aligned. l2 = 0: a0 = a
// [E, 64], dc0/dc1/dc2 [E,64]/[E,8]/[E,8], da0 [E, 64]; a1/a2/da1/da2 unused
// (null). l2 = 1: a0/a1/a2 and da0/da1/da2 [E,64]/[E,8]/[E,8], dc0 [E, 64],
// dc1/dc2 unused. dh [E, d]; dwt [5120, d] and db [5120] f32; work:
// tp_contract_bwd_workspace floats. Three launches on the stream (tile
// pass, weight pass, reduce). Returns cudaGetLastError()
// after them (cudaErrorInvalidValue when a tensor map cannot be made).
extern "C" int tp_contract_bwd(const void* h, const void* a0, const void* a1,
                               const void* a2, const void* wt,
                               const void* bias, const void* dc0,
                               const void* dc1, const void* dc2, void* dh,
                               void* da0, void* da1, void* da2, void* dwt,
                               void* db, void* work, int E, int d,
                               int is_bf16, int l2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E == 0 || !width_ok(d)) return cudaGetLastError();
  const bool bf = is_bf16 != 0;
  if (l2)
    return run<true>(h, a0, a1, a2, wt, bias, dc0, dc1, dc2, dh, da0, da1,
                     da2, dwt, db, work, E, d, bf, s);
  return run<false>(h, a0, a1, a2, wt, bias, dc0, dc1, dc2, dh, da0, da1,
                    da2, dwt, db, work, E, d, bf, s);
}
