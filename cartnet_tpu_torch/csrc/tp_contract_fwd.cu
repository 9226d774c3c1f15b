// eComformer tensor-product weight generation + contraction, forward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cartnet_tpu/ops/pallas/tp_kernels.py:
// _fwd_call -> _tp_fwd_kernel (entries tp_contract_l1 / tp_contract_l2).
// Per edge e, with W given as wt [5120, d] (nn.Linear layout):
//   w_all[e, c] = h[e] . wt[c] + b[c]               (f32 sum, rounded to h's
//                                                    dtype)
//   path (U, V, off):  c_p[e, v] = sum_u round(w_all[e, off + u*V + v]
//                                              * round(a_p[e, u]))
// L1 paths (64,64,0), (64,8,4096), (64,8,4608) over one input a [E, 64],
// three outputs [E,64], [E,8], [E,8]; L2 paths (64,64,0), (8,64,4096),
// (8,64,4608) over a0 [E,64], a1 [E,8], a2 [E,8], summed into one [E, 64].
// The rounding points are the Pallas kernel's: w_all and a are rounded to
// h's dtype, each product is rounded to h's dtype, the sum over u runs in
// f32 and the output is rounded once (for L2 after all three paths). With
// f32 h nothing is rounded and no TF32 is used.
//
// What bounds it: the weight-generation GEMM, 2*E*d*5120 flops (55 GFLOP at
// E = 20992, d = 256) against ~20 MB of inputs and outputs, so the tensor
// cores (bf16: 0.056 ms at the 989 TFLOP/s of an NVIDIA H100 SXM at its
// 700 W limit) or the f32 FMA rate (0.82 ms at its 67 TFLOP/s) bound it.
// Nothing of size [E, 5120] or [E, U, V] reaches device memory.
//
// bf16 design, wgmma + TMA, one launch (tp_fwd_tc): a persistent grid (one
// block per SM) of consumer warpgroups and one producer warp. Each consumer
// warpgroup owns a 64-edge tile at a time (tile = blockIdx.x + gridDim.x
// (warpgroups round + warpgroup)); the producer loads each tile's h [64, d]
// by TMA once (d/64 128-byte swizzled slabs; columns past d come in as
// zeros, so any d % 16 == 0 from 64 up runs unpadded) and streams wt
// through one ring of stages (a 64-column k-slab of TC_NB chunks' wt rows,
// TMA, mbarrier completion) that all the block's warpgroups read in step:
// a stage goes back to the producer once every consumer warp has read it,
// so one pass over wt (2.6 MB at d = 256, from L2) serves every warpgroup's
// tile (one without a tile in a round passes the stages through). What
// bounds the design is that traffic and the shared-memory operand rate:
//  - three warpgroups (TC_WGS) while their h tiles leave a ring of
//    TC_MIN_STAGES stages (d <= 256): 328 tiles of E = 20992 in one round
//    on 132 SMs, wt read 132 times; past that, two warpgroups (tc_plan);
//  - wgmma m64n128k16 (TC_NB = 2: two 64-column chunks a product), A = the
//    h tile and B = the stage, both from shared memory, ~96 bytes a cycle
//    where m64n64k16 needs ~128, the SM's rate;
//  - one f32 accumulator set a thread (64 registers; three warpgroups and
//    the producer warp leave 128 a thread), each chunk group's k-slabs
//    streamed (one commit group a slab, at most two in flight, each stage
//    freed once read), the contraction after the group's product while the
//    other warpgroups' products run.
// TC_WGS and TC_NB are build-time constants (kernel_ab's k7_bf16_variants
// builds two warpgroups, and n = 64). No instruction but wgmma writes an
// accumulator (the first product of a sum drops the old value through
// scale-d) and no wgmma follows a read of an accumulator inside one
// pipeline stage: either makes ptxas serialize every wgmma of the kernel.
// The wgmma accumulator puts
// row 16 w + g (+8) and columns 8 j + 2 t (+1) of a chunk in thread (warp
// w, g = lane / 4, t = lane % 4), as mma.sync's fragment did, so each
// thread contracts its own accumulator in registers (a 64-column chunk is
// one u of a V = 64 path or eight u of a V = 8 path: the TPU's R_rep /
// R_sum 0/1 matmuls are not needed), every row's 80 chunks run in one
// warpgroup in ascending order, and each row's arithmetic is independent
// of its tile: the outputs are bitwise those of the mma.sync kernel.
//
// f32 design (no TF32: FMA on the CUDA cores, bound by their 67 TFLOP/s):
// w_all as the 64 x 128 SIMT GEMM tiles of simt_gemm.cuh (A = h rows, B =
// wt rows, K = d; K8's f32 w_all tiles read the same way), four blocks an
// SM, with the contraction as each tile's epilogue, two launches:
//  (a) tile pass: a block takes one 64-edge tile and a group of F32_GROUP
//      column tiles (8 chunks) in order, so 328 x 10 blocks at E = 20992
//      fill the SMs' 528 block slots evenly (one block per edge tile
//      walking all 40 column tiles would leave 328 blocks of serial work
//      in those slots). A thread's columns in a tile's two chunks share
//      v = 4 tx + q, so its 8 rows x 4 v output sums run over ascending u
//      in shared memory that only it touches (no barrier; the tile keeps
//      its 128-register budget). L1's V = 8 chunks sum every eighth u per
//      thread, then over the lanes of one v in a fixed shuffle tree; their
//      groups (tiles 32-35, 36-39) write out1 and out2 directly. Each group
//      of V = 64 tiles writes a partial [E, 64] table.
//  (b) reduce: out0 = the partial tables in group order (8 for L1, 10 for
//      L2; 43 MB of f32 traffic at E = 20992, mostly in L2).
// The tile's width is fixed, so every d up to 512 runs the same registers
// and d only lengthens the k loop.
// Sums run in a fixed order (ascending u, then the fixed trees), so results
// are bitwise repeatable; the epilogues use explicitly rounded
// adds/multiplies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

// TMA, mbarriers and wgmma (shared with K1's, K5/K6's and K8's bf16 passes)
#include "hopper_common.cuh"
// the f32 SIMT GEMM tile (shared with K5/K6's and K8's f32 passes)
#include "simt_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int CW = 64;                // wt rows (output columns) per chunk
constexpr int NUMEL = 5120;
constexpr int NCHUNK = NUMEL / CW;    // 80
constexpr int CH_P1 = 4096 / CW;      // first chunk of path 1 (64)
constexpr int CH_P2 = 4608 / CW;      // first chunk of path 2 (72)
constexpr long long SMEM_LIMIT = 232448;  // bytes a block may use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// ------------------------------------------------ bf16: wgmma + TMA

constexpr int TC_WGS = 3;         // consumer warpgroups a block, at most
constexpr int TC_MIN_STAGES = 4;  // ... while the ring keeps this many
constexpr int TC_NB = 2;          // chunks a wgmma: n = 64 TC_NB
template <int WGS> constexpr int tc_threads() { return 128 * WGS + 32; }
constexpr int TE = 64;            // edges a tile (one wgmma M)
constexpr int TC_MAX_STAGES = 16;

// a's columns in shared memory, stored as bf16: L1 a [64]; L2 a0 [64] |
// a1 [8] | a2 [8]; the padded stride keeps the 8 rows a warp reads at once
// on distinct banks
__host__ __device__ constexpr int a_width(bool l2) { return l2 ? 80 : 64; }
__host__ __device__ constexpr int a_stride(bool l2) {
  return a_width(l2) + 2;
}

// shared-memory plan of a bf16 block of wgs consumer warpgroups (bytes
// from the 1024-aligned base; total includes the 1024 bytes of alignment
// slack): the warpgroups' h tiles (d/64 slabs each), their a tables
// [64][a_stride] bf16, the bias [5120] bf16, then the wt ring (as many
// stages of TC_NB slabs as fit, up to 16) and its barriers: full[S],
// empty[S], h_full[wgs], h_empty[wgs]. A plan holds at least two stages.
struct TcLayout {
  int ks, wgs, stages;
  size_t h, a, bias, ring, bars, total;
  __host__ __device__ TcLayout(int d, bool l2, int w) {
    ks = (d + 63) / 64;
    wgs = w;
    h = 0;
    a = h + (size_t)wgs * ks * SLAB;
    bias = a + (size_t)wgs * TE * a_stride(l2) * 2;
    ring = (bias + (size_t)NUMEL * 2 + 1023) / 1024 * 1024;
    const long long s =
        (SMEM_LIMIT - 1024 - (long long)ring - 16 * TC_MAX_STAGES -
         16 * wgs) / ((long long)TC_NB * SLAB);
    stages = (int)(s < TC_MAX_STAGES ? (s < 0 ? 0 : s) : TC_MAX_STAGES);
    bars = ring + (size_t)stages * TC_NB * SLAB;
    total = 1024 + bars + 16 * (size_t)stages + 16 * wgs;
  }
  __host__ __device__ bool ok() const {
    return total <= (size_t)SMEM_LIMIT && stages >= 2;
  }
};

// the plan a call runs: TC_WGS warpgroups while their ring keeps
// TC_MIN_STAGES stages (d <= 256 at three), else two
__host__ __device__ inline TcLayout tc_plan(int d, bool l2) {
  const TcLayout most(d, l2, TC_WGS);
  return most.ok() && most.stages >= TC_MIN_STAGES ? most
                                                   : TcLayout(d, l2, 2);
}

struct TcArgs {
  const void *a0, *a1, *a2;
  const bf16* bias;
  bf16 *out0, *out1, *out2;
  int E, d;
};

// the a rows of tile e0 -> a_s rounded to bf16, by the warpgroup's threads
template <bool L2, typename AT>
__device__ __forceinline__ void stage_a(const TcArgs& p, size_t e0, int wt,
                                        bf16* a_s) {
  constexpr int AW = a_width(L2), AS = a_stride(L2);
  const AT* a0 = static_cast<const AT*>(p.a0);
  const AT* a1 = static_cast<const AT*>(p.a1);
  const AT* a2 = static_cast<const AT*>(p.a2);
  for (int i = wt; i < TE * AW; i += 128) {
    const int r = i / AW, c = i % AW;
    float v;
    if (c < 64)
      v = to_f(a0[(e0 + r) * 64 + c]);
    else if (c < 72)
      v = to_f(a1[(e0 + r) * 8 + c - 64]);
    else
      v = to_f(a2[(e0 + r) * 8 + c - 72]);
    a_s[r * AS + c] = __float2bfloat16_rn(v);
  }
}

// Two adjacent columns of one row: w = round(acc + b) (one bf16x2
// conversion), p = round(w * a) (one bf16x2 multiply: the exact product of
// two bf16 values rounded once), the Pallas kernel's rounding points
__device__ __forceinline__ float2 tp_term2(float acc0, float acc1, float2 b,
                                           __nv_bfloat162 a2) {
  const __nv_bfloat162 w =
      __floats2bfloat162_rn(__fadd_rn(acc0, b.x), __fadd_rn(acc1, b.y));
  return __bfloat1622float2(__hmul2(w, a2));
}

// A thread's output sums: V = 64 at its accumulator positions (column
// 8 j + 2 t + (q & 1), row r_lo or r_lo + 8 by q / 2); L1's V = 8 paths at
// (row, v = 2 t + (q & 1))
struct Sums {
  float c64[8][4], c8a[4], c8b[4];
};

// Contract chunk ch (this thread's 32 accumulators of it from acc[off]:
// acc[off + 4 j + q] at column 8 j + 2 t + (q & 1) of the chunk) into the
// sums
template <bool L2, int N>
__device__ __forceinline__ void contract(const float (&acc)[N], int off,
                                         int ch, const bf16* bias_s,
                                         const bf16* a_s, int r_lo, int t,
                                         Sums& o) {
  constexpr int AS = a_stride(L2);
  const float* f = acc + off;
  const int r_hi = r_lo + 8;
  const __nv_bfloat162* b2 =
      reinterpret_cast<const __nv_bfloat162*>(bias_s + ch * CW) + t;
  if (!L2 && ch >= CH_P1) {  // V = 8: u = u0 + j, v = 2t + (q & 1)
    const int u0 = (ch - (ch < CH_P2 ? CH_P1 : CH_P2)) * 8;
    float s8[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bj = __bfloat1622float2(b2[4 * j]);
      const float2 plo =
          tp_term2(f[4 * j], f[4 * j + 1], bj,
                   __bfloat162bfloat162(a_s[r_lo * AS + u0 + j]));
      const float2 phi =
          tp_term2(f[4 * j + 2], f[4 * j + 3], bj,
                   __bfloat162bfloat162(a_s[r_hi * AS + u0 + j]));
      s8[0] = __fadd_rn(s8[0], plo.x);
      s8[1] = __fadd_rn(s8[1], plo.y);
      s8[2] = __fadd_rn(s8[2], phi.x);
      s8[3] = __fadd_rn(s8[3], phi.y);
    }
    if (ch < CH_P2) {
#pragma unroll
      for (int q = 0; q < 4; ++q) o.c8a[q] = __fadd_rn(o.c8a[q], s8[q]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) o.c8b[q] = __fadd_rn(o.c8b[q], s8[q]);
    }
  } else {  // V = 64: one u per chunk; a's column is ch for L1 and L2
    const __nv_bfloat162 alo = __bfloat162bfloat162(a_s[r_lo * AS + ch]);
    const __nv_bfloat162 ahi = __bfloat162bfloat162(a_s[r_hi * AS + ch]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bj = __bfloat1622float2(b2[4 * j]);
      const float2 plo = tp_term2(f[4 * j], f[4 * j + 1], bj, alo);
      const float2 phi = tp_term2(f[4 * j + 2], f[4 * j + 3], bj, ahi);
      o.c64[j][0] = __fadd_rn(o.c64[j][0], plo.x);
      o.c64[j][1] = __fadd_rn(o.c64[j][1], plo.y);
      o.c64[j][2] = __fadd_rn(o.c64[j][2], phi.x);
      o.c64[j][3] = __fadd_rn(o.c64[j][3], phi.y);
    }
  }
}

// Issue the products of slabs [k0, k1) of the chunk group at ring position
// n0 (its slab ks at n0 + ks) into acc as one commit group: A = the h tile
// at h_a, B = the ring stage, K-major (N / 32 chunks of 64 rows). The
// group's first product (slab 0, k16 step 0) drops acc's old value.
template <int N>
__device__ __forceinline__ void issue(float (&acc)[N], uint32_t h_a,
                                      const Ring& ring, uint32_t n0, int k0,
                                      int k1) {
  static_assert(N == 32 * TC_NB, "n = 64 TC_NB");
  for (int ks = k0; ks < k1; ++ks) {
    const uint32_t b_s = ring.wait_full(n0 + ks, TC_NB * SLAB);
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = sw128_desc(h_a + ks * SLAB + kk * 32, 16, 1024);
      const uint64_t db = sw128_desc(b_s + kk * 32, 16, 1024);
      if constexpr (N == 32)
        wgmma_m64n64<0, 0>(acc, da, db, (ks | kk) != 0);
      else
        wgmma_m64n128<0, 0>(acc, da, db, (ks | kk) != 0);
    }
  }
  wg_commit();
  fence_acc(acc);
}

// this warp's arrivals on the empty barriers of ring positions [n, n + k)
__device__ __forceinline__ void release(const Ring& ring, uint32_t n, int k) {
  if ((threadIdx.x & 31) == 0)
    for (int s = 0; s < k; ++s)
      mbar_arrive(ring.empty + 8 * ring.stage(n + s));
}

// Chunk group g (TC_NB chunks) of the tile: one commit group a slab, at
// most two in flight, each slab freed once its products are done; then the
// contraction
template <bool L2, int N>
__device__ __forceinline__ void stream_group(
    float (&acc)[N], int g, uint32_t h_a, const Ring& ring, uint32_t n0,
    int ks, const bf16* bias_s, const bf16* a_s, int r_lo, int t, Sums& o) {
  const uint32_t ng = n0 + (uint32_t)g * ks;
  for (int k = 0; k < ks; ++k) {
    issue(acc, h_a, ring, ng, k, k + 1);
    if (k > 0) {
      wg_wait<1>();
      fence_acc(acc);
      release(ring, ng + k - 1, 1);
    }
  }
  wg_wait<0>();
  fence_acc(acc);
  release(ring, ng + ks - 1, 1);
#pragma unroll
  for (int c = 0; c < N / 32; ++c)
    contract<L2>(acc, 32 * c, g * (N / 32) + c, bias_s, a_s, r_lo, t, o);
}

// One block: WGS consumer warpgroups (warps 0 .. 4 WGS - 1) and the
// producer warp. Round r gives warpgroup w tile blockIdx.x + gridDim.x
// (WGS r + w) while that is below E / 64.
template <bool L2, typename AT, int WGS>
__global__ void __launch_bounds__(tc_threads<WGS>(), 1)
    tp_fwd_tc(const __grid_constant__ TcArgs p,
              const __grid_constant__ CUtensorMap h_m,
              const __grid_constant__ CUtensorMap wt_m) {
  constexpr int NG = NCHUNK / TC_NB;  // chunk groups a tile
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const TcLayout L(p.d, L2, WGS);
  const int ks = L.ks;
  const uint32_t raw = saddr(smem_tc);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_tc + (base - raw);
  const Ring ring{base + (uint32_t)L.ring, base + (uint32_t)L.bars,
                  base + (uint32_t)L.bars + 8u * L.stages, L.stages};
  const uint32_t h_full = base + (uint32_t)L.bars + 16u * L.stages;
  const uint32_t h_empty = h_full + 8u * WGS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = p.E / TE, bx = blockIdx.x;
  const int per_round = gridDim.x * WGS;
  if (tid == 0) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, 4 * WGS);  // every consumer warp
    }
    for (int w = 0; w < WGS; ++w) {
      mbar_init(h_full + 8 * w, 1);
      mbar_init(h_empty + 8 * w, 4);  // the warpgroup's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WGS) {  // producer: each round's h tiles, then wt
    if (lane == 0) {
      uint32_t n = 0;
      for (int r = 0; bx + r * per_round < n_tiles; ++r) {
        for (int w = 0; w < WGS; ++w) {
          const int t = bx + r * per_round + w * gridDim.x;
          if (t >= n_tiles) break;
          if (r > 0) mbar_wait(h_empty + 8 * w, (r - 1) & 1);
          mbar_expect_tx(h_full + 8 * w, (uint32_t)ks * SLAB);
          for (int j = 0; j < ks; ++j)
            tma_load(base + (uint32_t)(L.h + ((size_t)w * ks + j) * SLAB),
                     &h_m, h_full + 8 * w, j * 64, t * TE);
        }
        for (int g = 0; g < NG; ++g)
          for (int j = 0; j < ks; ++j, ++n) {
            const uint32_t st =
                ring.acquire(n, TC_NB * SLAB, TC_NB * SLAB);
            for (int c = 0; c < TC_NB; ++c)
              tma_load(st + c * SLAB, &wt_m, ring.full + 8 * ring.stage(n),
                       j * 64, (g * TC_NB + c) * CW);
          }
      }
    }
    return;
  }

  const int wg = warp >> 2, wt = tid & 127, wi = wt >> 5;
  const int r_lo = 16 * wi + (lane >> 2), t = lane & 3;
  bf16* a_s = reinterpret_cast<bf16*>(gbase + L.a) + wg * TE * a_stride(L2);
  bf16* bias_s = reinterpret_cast<bf16*>(gbase + L.bias);
  const uint32_t h_a = base + (uint32_t)(L.h + (size_t)wg * ks * SLAB);
  for (int i = tid; i < NUMEL / 8; i += 128 * WGS)
    reinterpret_cast<uint4*>(bias_s)[i] =
        reinterpret_cast<const uint4*>(p.bias)[i];
  bar_sync(1, 128 * WGS);  // the bias is in place
  uint32_t n0 = 0;  // ring position of the round's first slab
  for (int r = 0; bx + r * per_round < n_tiles;
       ++r, n0 += (uint32_t)NG * ks) {
    const int tile = bx + r * per_round + wg * gridDim.x;
    if (tile >= n_tiles) {  // no tile this round: pass the stages through
      for (int k = 0; k < NG * ks; ++k) {
        ring.wait_full(n0 + k, TC_NB * SLAB);
        release(ring, n0 + k, 1);
      }
      continue;
    }
    const size_t e0 = (size_t)tile * TE;
    bar_sync(2 + wg, 128);  // the previous tile's reads of a_s are done
    stage_a<L2, AT>(p, e0, wt, a_s);
    bar_sync(2 + wg, 128);  // a_s is in place
    mbar_wait(h_full + 8 * wg, r & 1);
    Sums o;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) o.c64[j][q] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) o.c8a[q] = o.c8b[q] = 0.f;
    float acc[32 * TC_NB];
    for (int g = 0; g < NG; ++g)
      stream_group<L2>(acc, g, h_a, ring, n0, ks, bias_s, a_s, r_lo, t, o);
    if (lane == 0) mbar_arrive(h_empty + 8 * wg);  // h is read
    const size_t lo = e0 + r_lo, hi = lo + 8;
    auto put = [](bf16* q, float x, float y) {
      *reinterpret_cast<__nv_bfloat162*>(q) = __floats2bfloat162_rn(x, y);
    };
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      put(p.out0 + lo * 64 + c, o.c64[j][0], o.c64[j][1]);
      put(p.out0 + hi * 64 + c, o.c64[j][2], o.c64[j][3]);
    }
    if (!L2) {
      const int c = 2 * t;
      put(p.out1 + lo * 8 + c, o.c8a[0], o.c8a[1]);
      put(p.out2 + lo * 8 + c, o.c8b[0], o.c8b[1]);
      put(p.out1 + hi * 8 + c, o.c8a[2], o.c8a[3]);
      put(p.out2 + hi * 8 + c, o.c8b[2], o.c8b[3]);
    }
  }
}

// ------------------------------------------------ f32: CUDA cores

// The f32 tile pass: 64 x 128 SIMT tiles (simt_gemm.cuh) of w_all = h wt^T
// (A = h rows, B = wt rows, K = d), each tile two 64-column chunks whose
// contraction is the tile's epilogue. A block walks F32_GROUP column tiles
// of one 64-edge tile in order; tile nt holds chunks 2 nt and 2 nt + 1, and
// a thread's columns in both are the same v = 4 tx + q (simt::col_of).
constexpr int F32_BLOCKS = 4;         // blocks an SM (__launch_bounds__)
constexpr int NT = NUMEL / simt::BN;  // column tiles (chunk pairs): 40
constexpr int NT_P1 = CH_P1 / 2;      // first tile of L1's path 1 (32)
constexpr int NT_P2 = CH_P2 / 2;      // first tile of L1's path 2 (36)
constexpr int F32_GROUP = 4;          // column tiles a block walks
static_assert(NT % F32_GROUP == 0 &&
                  NT_P1 / F32_GROUP == (NT_P2 - 1) / F32_GROUP &&
                  NT_P2 / F32_GROUP == (NT - 1) / F32_GROUP,
              "each of L1's V = 8 paths lies in one group");
constexpr int NG = NT / F32_GROUP;    // groups an edge tile
constexpr int OUT_SUMS = 32;          // a thread's output sums: 8 rows x 4
// dynamic shared memory of the tile pass: the SIMT tile's slabs, then the
// output sums [OUT_SUMS][THREADS] (each thread owns a column of them)
constexpr size_t F32_SMEM = simt::SMEM + sizeof(float) * OUT_SUMS *
                                             simt::THREADS;

// the partial tables of out0 the tile pass writes, one a group that holds
// V = 64 tiles (L2: all 40 tiles; L1: path 0's 32); with one, out0 itself
__host__ __device__ constexpr int n_parts(bool l2) {
  return ((l2 ? NT : NT_P1) + F32_GROUP - 1) / F32_GROUP;
}

struct F32Args {
  const float *h, *a0, *a1, *a2, *wt, *bias;
  float *out0, *out1, *out2;
  float* part;  // [n_parts][E][64] partial sums of out0
  int E, d;
};

// a[e, u] of V = 64 chunk ch (u = ch): L1 a [E, 64]; L2 a0 | a1 | a2
template <bool L2>
__device__ __forceinline__ float a_of(const F32Args& p, size_t e, int ch) {
  if (!L2 || ch < CH_P1) return p.a0[e * 64 + ch];
  return ch < CH_P2 ? p.a1[e * 8 + ch - CH_P1] : p.a2[e * 8 + ch - CH_P2];
}

// Contraction of tile nt into the thread's sums o (o[k THREADS], k = 4 i +
// q: row row_of(i), v = 4 tx + q), chunk 2 nt, then 2 nt + 1:
// o += round(acc + b) round(a), the Pallas kernel's rounding points (none
// in f32, but no contraction into an FMA either). V = 64: u = ch; L1's V =
// 8 chunks: column 4 tx + q is (u = u0 + tx / 2, v = 4 (tx & 1) + q), so a
// thread sums every eighth u of its path over the chunks, in chunk order.
template <bool L2>
__device__ __forceinline__ void contract(const F32Args& p,
                                         const float (&acc)[8][8], size_t e0,
                                         int nt, float* o) {
  const int tx = threadIdx.x % 16;
  const bool v8 = !L2 && nt >= NT_P1;
  float bq[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bq[j] = p.bias[nt * simt::BN + simt::col_of(j)];
  // L1's V = 8: a's column of chunk 2 nt (chunk 2 nt + 1: 8 further)
  const int u8 = (2 * nt - (nt < NT_P2 ? CH_P1 : CH_P2)) * 8 + tx / 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t e = e0 + simt::row_of(i);
    const float a_lo = v8 ? p.a0[e * 64 + u8] : a_of<L2>(p, e, 2 * nt);
    const float a_hi = v8 ? p.a0[e * 64 + u8 + 8]
                          : a_of<L2>(p, e, 2 * nt + 1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float s = o[(4 * i + q) * simt::THREADS];
      s = __fadd_rn(s, __fmul_rn(__fadd_rn(acc[i][q], bq[q]), a_lo));
      s = __fadd_rn(s, __fmul_rn(__fadd_rn(acc[i][4 + q], bq[4 + q]), a_hi));
      o[(4 * i + q) * simt::THREADS] = s;
    }
  }
}

// The end of a path in the block: V = 64 sums go to out0 (one group) or
// to the group's partial table; L1's V = 8 sums are added over the eight
// lanes of one v (tx ^ 2, ^ 4, ^ 8: a fixed tree, the same bits in each
// lane) and written by tx = 0, 1 to out1 (path 1) or out2 (path 2). The
// sums are zeroed for the next path.
template <bool L2>
__device__ __forceinline__ void flush(const F32Args& p, size_t e0, int nt,
                                      int g, float* o) {
  const int tx = threadIdx.x % 16;
  const bool v8 = !L2 && nt >= NT_P1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t e = e0 + simt::row_of(i);
    float s[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s[q] = o[(4 * i + q) * simt::THREADS];
      o[(4 * i + q) * simt::THREADS] = 0.f;
      if (v8) {
#pragma unroll
        for (int m = 2; m < 16; m <<= 1)
          s[q] = __fadd_rn(s[q], __shfl_xor_sync(0xffffffffu, s[q], m));
      }
    }
    const float4 v = make_float4(s[0], s[1], s[2], s[3]);
    if (v8) {
      if (tx < 2)
        *reinterpret_cast<float4*>((nt < NT_P2 ? p.out1 : p.out2) + e * 8 +
                                   4 * tx) = v;
    } else {
      float* dst = n_parts(L2) > 1 ? p.part + ((size_t)g * p.E + e) * 64
                                   : p.out0 + e * 64;
      *reinterpret_cast<float4*>(dst + 4 * tx) = v;
    }
  }
}

// tile pass: block = (64-edge tile, group g of F32_GROUP column tiles)
template <bool L2>
__global__ void __launch_bounds__(simt::THREADS, F32_BLOCKS)
    tp_fwd_tile_f32(const __grid_constant__ F32Args p) {
  extern __shared__ float4 smem_f32[];
  float* smem = reinterpret_cast<float*>(smem_f32);
  float* o = smem + simt::SMEM / sizeof(float) + threadIdx.x;
  const int d = p.d, g = blockIdx.x % NG;
  const size_t e0 = (size_t)(blockIdx.x / NG) * simt::BM;
#pragma unroll
  for (int k = 0; k < OUT_SUMS; ++k) o[k * simt::THREADS] = 0.f;
  simt::RowsT<simt::BM> fa{p.h + e0 * d, (size_t)d, 0};
  for (int nt = g * F32_GROUP; nt < (g + 1) * F32_GROUP; ++nt) {
    float acc[8][8];
    simt::zero(acc);
    simt::RowsT<simt::BN> fb{p.wt + (size_t)nt * simt::BN * d, (size_t)d, 0};
    simt::mainloop(acc, d / simt::BK, fa, fb, smem);
    contract<L2>(p, acc, e0, nt, o);
    const int next = nt + 1;
    if (next == (g + 1) * F32_GROUP ||
        (!L2 && (next == NT_P1 || next == NT_P2)))
      flush<L2>(p, e0, nt, g, o);
  }
}

// reduce: out0 = the partial tables summed in group order (float4 a thread)
__global__ void __launch_bounds__(256)
    tp_fwd_reduce_f32(const float4* __restrict__ part,
                      float4* __restrict__ out0, int n4, int np) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  float4 s = part[i];
  for (int k = 1; k < np; ++k) {
    const float4 v = part[(size_t)k * n4 + i];
    s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y),
                    __fadd_rn(s.z, v.z), __fadd_rn(s.w, v.w));
  }
  out0[i] = s;
}

// shared memory of one block (bytes): bf16, the tp_fwd_tc plan (0 where
// none fits); f32, the tile pass's
size_t smem_bytes(int d, bool is_bf16, bool l2) {
  if (!is_bf16) return F32_SMEM;
  const TcLayout L = tc_plan(d, l2);
  return L.ok() ? L.total : 0;
}

template <typename K, typename... Args>
cudaError_t launch(K kern, int blocks, int threads, size_t smem,
                   cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<blocks, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <bool L2>
cudaError_t run_f32(const F32Args& p, cudaStream_t s) {
  cudaError_t err = launch(tp_fwd_tile_f32<L2>, p.E / simt::BM * NG,
                           simt::THREADS, F32_SMEM, s, p);
  if (err != cudaSuccess || n_parts(L2) == 1) return err;
  const int n4 = p.E * 16;
  tp_fwd_reduce_f32<<<(n4 + 255) / 256, 256, 0, s>>>(
      reinterpret_cast<const float4*>(p.part),
      reinterpret_cast<float4*>(p.out0), n4, n_parts(L2));
  return cudaGetLastError();
}

// the bf16 kernel of a plan (of the warpgroup counts this build takes)
using TcKernel = void (*)(TcArgs, CUtensorMap, CUtensorMap);
template <bool L2, typename AT>
TcKernel tp_fwd_tc_of(const TcLayout& L) {
  if constexpr (TC_WGS > 2) {
    if (L.wgs == TC_WGS) return tp_fwd_tc<L2, AT, TC_WGS>;
  }
  return tp_fwd_tc<L2, AT, 2>;
}

template <bool L2, typename AT>
cudaError_t run_bf16(const void* h, const TcArgs& p, const void* wt,
                     cudaStream_t s) {
  const TcLayout L = tc_plan(p.d, L2);
  if (!L.ok()) return cudaErrorInvalidConfiguration;
  CUtensorMap h_m, wt_m;
  if (!make_map(&h_m, h, p.d, p.E) || !make_map(&wt_m, wt, p.d, NUMEL))
    return cudaErrorInvalidValue;
  const int n_tiles = p.E / TE, nsm = num_sms();
  return launch(tp_fwd_tc_of<L2, AT>(L), n_tiles < nsm ? n_tiles : nsm,
                128 * L.wgs + 32, L.total, s, p, h_m, wt_m);
}

template <bool L2>
cudaError_t run(const void* h, const void* a0, const void* a1,
                const void* a2, const void* wt, const void* bias, void* out0,
                void* out1, void* out2, void* work, int E, int d, int is_bf16,
                int a_f32, cudaStream_t s) {
  if (is_bf16) {
    const TcArgs p{a0, a1, a2, (const bf16*)bias, (bf16*)out0, (bf16*)out1,
                   (bf16*)out2, E, d};
    return a_f32 ? run_bf16<L2, float>(h, p, wt, s)
                 : run_bf16<L2, bf16>(h, p, wt, s);
  }
  using T = const float*;
  return run_f32<L2>(F32Args{(T)h, (T)a0, (T)a1, (T)a2, (T)wt, (T)bias,
                             (float*)out0, (float*)out1, (float*)out2,
                             (float*)work, E, d},
                     s);
}

}  // namespace

// Shared memory one block needs (bytes; 0 where no bf16 plan fits), for the
// wrapper's shape check.
extern "C" long long tp_contract_fwd_smem(int d, int is_bf16, int l2) {
  return (long long)smem_bytes(d, is_bf16 != 0, l2 != 0);
}

// floats of scratch the call needs in ``work``: the f32 tile pass's partial
// tables of out0 (none in bf16, or with one group)
extern "C" long long tp_contract_fwd_workspace(int E, int is_bf16, int l2) {
  const int np = n_parts(l2 != 0);
  return is_bf16 || np == 1 ? 0 : (long long)np * E * 64;
}

// C entry point (bound with ctypes). E % 64 == 0; f32: d % 16 == 0; bf16:
// d % 16 == 0 and d >= 64 (the wrapper pads other widths), with a plan
// (tp_contract_fwd_smem > 0). h [E, d], wt [5120, d], bias [5120] and the
// outputs in one dtype (is_bf16), a in f32 (a_f32 = 1) or h's dtype; h and
// wt 16-byte aligned. l2 = 0: a0 = a [E, 64], a1/a2 unused (null), outputs
// out0 [E, 64], out1 [E, 8], out2 [E, 8]; l2 = 1: a0 [E, 64], a1/a2
// [E, 8], one output out0 [E, 64]. work: tp_contract_fwd_workspace floats.
// bf16: one launch (tp_fwd_tc); f32: the tile pass and, with more than one
// partial table, the reduce. Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue when a tensor map cannot be made).
extern "C" int tp_contract_fwd(const void* h, const void* a0, const void* a1,
                               const void* a2, const void* wt,
                               const void* bias, void* out0, void* out1,
                               void* out2, void* work, int E, int d,
                               int is_bf16, int a_f32, int l2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E == 0) return cudaGetLastError();
  if (l2)
    return run<true>(h, a0, a1, a2, wt, bias, out0, out1, out2, work, E, d,
                     is_bf16, a_f32, s);
  return run<false>(h, a0, a1, a2, wt, bias, out0, out1, out2, work, E, d,
                    is_bf16, a_f32, s);
}
