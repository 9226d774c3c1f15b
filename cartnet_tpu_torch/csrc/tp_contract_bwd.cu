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
// outputs: the tensor cores (bf16) or the f32 FMA rate.
//
// Design: two launches, no float atomics, fixed summation orders (bitwise
// repeatable); nothing of size [E, 5120] or [E, U, V] reaches device memory.
// (a) Edge-tile pass (dh, da): one block per 64 edges, 8 warps; h's tile
//     stays in shared memory and wt streams through in chunks of 64 rows
//     (double-buffered cp.async). Per chunk, mma.sync m16n8k16 recomputes
//     the chunk of w_all (warp: 16 edges x 32 columns) and each thread
//     contracts its fragment with dc in registers; the sums over v finish
//     with quad shuffles and a fixed-order merge of the two column halves
//     into an f32 da table in shared memory. dwall's chunk needs no weights
//     (it is dc (x) a): each thread builds its A fragments from the staged a
//     and dc rows, and a second mma.sync with the same wt chunk (ldmatrix
//     .trans) accumulates dh (warp: 16 edges x d/2 columns) in registers.
// (b) Output-tiled weight pass (dwt, db): one block per (64-row chunk of
//     dwt, 128 columns of d); it walks the edges in ascending 64-edge tiles,
//     builds its dwall columns from a and dc into shared memory, and
//     accumulates dwt^T = dwall^T h with mma.sync (both operands through
//     ldmatrix .trans); db is a serial column sum of the same tiles.
// f32: the same two passes on the CUDA cores (FMA), with 32-edge tiles in
// pass (a) and 32-edge steps in pass (b).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int NUMEL = 5120;
constexpr int CW = 64;              // wt rows (w_all columns) per chunk
constexpr int NCHUNK = NUMEL / CW;  // 80
constexpr int CH_P1 = 4096 / CW;    // first chunk of path 1 (64)
constexpr int CH_P2 = 4608 / CW;    // first chunk of path 2 (72)
constexpr int NTHREADS = 256;       // 8 warps, every kernel
constexpr int TE = 64;              // bf16: edges per tile (both passes)
constexpr int TEF = 32;             // f32: edges per tile (both passes)
constexpr int KB = 128;             // pass (b): d columns per block

// a table: L1 a [64]; L2 a0 | a1 | a2 [80]. dc table: L1 dc0 | dc1 | dc2
// [80]; L2 dc [64].
template <bool L2> __host__ __device__ constexpr int a_width() {
  return L2 ? 80 : 64;
}
template <bool L2> __host__ __device__ constexpr int dc_width() {
  return L2 ? 64 : 80;
}

// Column c (0..63) of chunk ch: the a-table column (u) and dc-table column
// (v) whose product is dwall[e, ch*CW + c].
template <bool L2>
__device__ __forceinline__ void chunk_cols(int ch, int c, int& acol,
                                           int& dcol) {
  if (L2 || ch < CH_P1) {  // V = 64: u = ch, v = c
    acol = ch;
    dcol = c;
  } else {  // L1 V = 8: u = u0 + c / 8, v = c % 8
    const bool p1 = ch < CH_P2;
    acol = (ch - (p1 ? CH_P1 : CH_P2)) * 8 + (c >> 3);
    dcol = (p1 ? 64 : 72) + (c & 7);
  }
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

// -------------------------------------------------- bf16: tensor cores

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(s)),
               "l"(g));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c += A (16x16, row) * B (16x8, col); bf16 operands, f32 accumulators.
// Fragment c: c[0], c[1] at (row g, cols 2t, 2t+1); c[2], c[3] at row g+8.
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned as_u32(bf162 v) {
  return *reinterpret_cast<unsigned*>(&v);
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
// quad (4 lanes of one fragment row) sum, the same bits in every lane
__device__ __forceinline__ float quad_sum(float s) {
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
  return __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
}

// dwall[row, ch*CW + c], dwall[row, ch*CW + c + 1] (c even) from the staged
// a and dc rows, as one bf16x2 A-fragment register
template <bool L2>
__device__ __forceinline__ unsigned dwall2(const bf16* a_row,
                                           const bf16* dc_row, int ch,
                                           int c) {
  int acol, dcol;
  chunk_cols<L2>(ch, c, acol, dcol);
  const bf162 d = *reinterpret_cast<const bf162*>(dc_row + dcol);
  return as_u32(__hmul2(d, __bfloat162bfloat162(a_row[acol])));
}

template <int D> __host__ __device__ constexpr int tile_ldh() { return D + 8; }

template <bool L2, int D>
size_t smem_tile_bf16() {
  constexpr int LDH = tile_ldh<D>();
  constexpr int AS = a_width<L2>() + 8, DS = dc_width<L2>() + 8;
  return sizeof(bf16) * ((size_t)TE * LDH + 2 * CW * LDH + TE * AS + TE * DS) +
         sizeof(float) * ((size_t)TE * a_width<L2>() + 2 * TE);
}

// (a) dh and da for one 64-edge tile
template <bool L2, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    tp_bwd_tile_mma(const bf16* __restrict__ h, const bf16* __restrict__ a0,
                    const bf16* __restrict__ a1, const bf16* __restrict__ a2,
                    const bf16* __restrict__ wt, const bf16* __restrict__ bias,
                    const bf16* __restrict__ dc0, const bf16* __restrict__ dc1,
                    const bf16* __restrict__ dc2, bf16* __restrict__ dh,
                    bf16* __restrict__ da0, bf16* __restrict__ da1,
                    bf16* __restrict__ da2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int LDH = tile_ldh<D>();
  constexpr int AW = a_width<L2>(), DW = dc_width<L2>();
  constexpr int AS = AW + 8, DS = DW + 8;
  constexpr int NT2 = D / 16;  // dh n-tiles per warp (d / 2 columns)
  bf16* h_s = reinterpret_cast<bf16*>(smem_raw);  // [TE][LDH]
  bf16* w_s = h_s + TE * LDH;                      // 2 x [CW][LDH]
  bf16* a_s = w_s + 2 * CW * LDH;                  // [TE][AS]
  bf16* dc_s = a_s + TE * AS;                      // [TE][DS]
  float* da_s = reinterpret_cast<float*>(dc_s + TE * DS);  // [TE][AW]
  float* red_s = da_s + TE * AW;                           // [2][TE]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, half = warp >> 2;
  const int r_lo = rg * 16 + g, r_hi = r_lo + 8;
  const size_t e0 = (size_t)blockIdx.x * TE;

  constexpr int SEGS = D / 8;
  for (int i = tid; i < TE * SEGS; i += NTHREADS) {
    const int r = i / SEGS, s = i % SEGS;
    cp_async16(h_s + r * LDH + 8 * s, h + (e0 + r) * D + 8 * s);
  }
  for (int i = tid; i < CW * SEGS; i += NTHREADS) {
    const int n = i / SEGS, s = i % SEGS;
    cp_async16(w_s + n * LDH + 8 * s, wt + (size_t)n * D + 8 * s);
  }
  cp_commit();
  for (int i = tid; i < TE * AW; i += NTHREADS) {
    const int r = i / AW, c = i % AW;
    a_s[r * AS + c] = a_at<L2>(a0, a1, a2, e0 + r, c);
    da_s[i] = 0.f;
  }
  for (int i = tid; i < TE * DW; i += NTHREADS) {
    const int r = i / DW, c = i % DW;
    dc_s[r * DS + c] = dc_at<L2>(dc0, dc1, dc2, e0 + r, c);
  }

  float acc[NT2][4];
#pragma unroll
  for (int n = 0; n < NT2; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;
  const bf16* a_lo = a_s + r_lo * AS;
  const bf16* a_hi = a_s + r_hi * AS;
  const bf16* d_lo = dc_s + r_lo * DS;
  const bf16* d_hi = dc_s + r_hi * DS;

  for (int ch = 0; ch < NCHUNK; ++ch) {
    cp_wait_all();
    // chunk ch has landed everywhere, and every warp is done with chunk
    // ch - 1, whose buffer the next load reuses
    __syncthreads();
    if (ch + 1 < NCHUNK) {
      bf16* dst = w_s + ((ch + 1) & 1) * CW * LDH;
      for (int i = tid; i < CW * SEGS; i += NTHREADS) {
        const int n = i / SEGS, s = i % SEGS;
        cp_async16(dst + n * LDH + 8 * s,
                   wt + (size_t)((ch + 1) * CW + n) * D + 8 * s);
      }
      cp_commit();
    }
    const bf16* wb = w_s + (ch & 1) * CW * LDH;

    // w_all chunk: rows rg*16.., columns half*32 .. half*32 + 31
    float f[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) f[j][q] = 0.f;
    for (int kk = 0; kk < D; kk += 16) {
      unsigned af[4];
      ldmatrix_x4(af, h_s + (rg * 16 + (lane & 15)) * LDH + kk +
                          (lane >> 4) * 8);
      const int m = lane >> 3, rr = lane & 7;
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        unsigned bfr[4];
        ldmatrix_x4(bfr, wb + (half * 32 + 16 * jp + 8 * (m >> 1) + rr) * LDH +
                             kk + 8 * (m & 1));
        mma_bf16(f[2 * jp], af, bfr[0], bfr[1]);
        mma_bf16(f[2 * jp + 1], af, bfr[2], bfr[3]);
      }
    }

    // da: contract the fragment with dc over v
    const bf162* b2 =
        reinterpret_cast<const bf162*>(bias + ch * CW + half * 32) + t;
    if (L2 || ch < CH_P1) {  // V = 64: u = ch, v = column
      float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = half * 32 + 8 * j + 2 * t;
        const float2 bj = __bfloat1622float2(b2[4 * j]);
        const float2 plo = term2(
            f[j][0], f[j][1], bj, *reinterpret_cast<const bf162*>(d_lo + col));
        const float2 phi = term2(
            f[j][2], f[j][3], bj, *reinterpret_cast<const bf162*>(d_hi + col));
        s_lo = __fadd_rn(__fadd_rn(s_lo, plo.x), plo.y);
        s_hi = __fadd_rn(__fadd_rn(s_hi, phi.x), phi.y);
      }
      s_lo = quad_sum(s_lo);
      s_hi = quad_sum(s_hi);
      if (t == 0) {
        red_s[half * TE + r_lo] = s_lo;
        red_s[half * TE + r_hi] = s_hi;
      }
    } else {  // L1 V = 8: n-tile j is u = u0 + 4*half + j, v = 2t, 2t + 1
      const bool p1 = ch < CH_P2;
      const int u0 = (ch - (p1 ? CH_P1 : CH_P2)) * 8 + 4 * half;
      const int dcol = (p1 ? 64 : 72) + 2 * t;
      const bf162 dlo = *reinterpret_cast<const bf162*>(d_lo + dcol);
      const bf162 dhi = *reinterpret_cast<const bf162*>(d_hi + dcol);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 bj = __bfloat1622float2(b2[4 * j]);
        const float2 plo = term2(f[j][0], f[j][1], bj, dlo);
        const float2 phi = term2(f[j][2], f[j][3], bj, dhi);
        const float s_lo = quad_sum(__fadd_rn(plo.x, plo.y));
        const float s_hi = quad_sum(__fadd_rn(phi.x, phi.y));
        if (t == 0) {  // the only writer of these entries in this chunk
          float* lo = da_s + r_lo * AW + u0 + j;
          float* hi = da_s + r_hi * AW + u0 + j;
          *lo = __fadd_rn(*lo, s_lo);
          *hi = __fadd_rn(*hi, s_hi);
        }
      }
    }

    // dh += dwall chunk [16 rows, 64] @ wt chunk [64, this warp's d / 2]
#pragma unroll
    for (int ks = 0; ks < CW / 16; ++ks) {
      const int c0 = 16 * ks + 2 * t;
      unsigned af[4];
      af[0] = dwall2<L2>(a_lo, d_lo, ch, c0);
      af[1] = dwall2<L2>(a_hi, d_hi, ch, c0);
      af[2] = dwall2<L2>(a_lo, d_lo, ch, c0 + 8);
      af[3] = dwall2<L2>(a_hi, d_hi, ch, c0 + 8);
      const bf16* brow = wb + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  LDH + half * (D / 2) + (lane >> 4) * 8;
#pragma unroll
      for (int jp = 0; jp < NT2 / 2; ++jp) {
        unsigned bfr[4];
        ldmatrix_x4_trans(bfr, brow + 16 * jp);
        mma_bf16(acc[2 * jp], af, bfr[0], bfr[1]);
        mma_bf16(acc[2 * jp + 1], af, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // red_s is complete
    if ((L2 || ch < CH_P1) && tid < TE) {  // merge the halves, fixed order
      float* p = da_s + tid * AW + ch;
      *p = __fadd_rn(*p, __fadd_rn(red_s[tid], red_s[TE + tid]));
    }
  }
  __syncthreads();

  auto put = [](bf16* p, float x, float y) {
    *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(x, y);
  };
#pragma unroll
  for (int n = 0; n < NT2; ++n) {
    const int col = half * (D / 2) + 8 * n + 2 * t;
    put(dh + (e0 + r_lo) * D + col, acc[n][0], acc[n][1]);
    put(dh + (e0 + r_hi) * D + col, acc[n][2], acc[n][3]);
  }
  for (int i = tid; i < TE * AW; i += NTHREADS) {
    const int r = i / AW, c = i % AW;
    const bf16 v = __float2bfloat16_rn(da_s[i]);
    if (!L2 || c < 64)
      da0[(e0 + r) * 64 + c] = v;
    else if (c < 72)
      da1[(e0 + r) * 8 + c - 64] = v;
    else
      da2[(e0 + r) * 8 + c - 72] = v;
  }
}

constexpr int LDB = KB + 8;  // pass (b): h tile row stride (bf16)
constexpr int LDW = CW + 8;  // pass (b): dwall tile row stride (bf16)

constexpr size_t smem_weight_bf16() {
  return sizeof(bf16) * 2 * ((size_t)TE * LDB + (size_t)TE * LDW);
}

// (b) dwt rows [ch*CW, ch*CW + 64) x columns [kb*KB, kb*KB + 128) and db
template <bool L2, int D>
__global__ void __launch_bounds__(NTHREADS)
    tp_bwd_weight_mma(const bf16* __restrict__ h,
                      const bf16* __restrict__ a0,
                      const bf16* __restrict__ a1,
                      const bf16* __restrict__ a2,
                      const bf16* __restrict__ dc0,
                      const bf16* __restrict__ dc1,
                      const bf16* __restrict__ dc2, float* __restrict__ dwt,
                      float* __restrict__ db, int E) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* h_s = reinterpret_cast<bf16*>(smem_raw);  // 2 x [TE][LDB]
  bf16* w_s = h_s + 2 * TE * LDB;                  // 2 x [TE][LDW]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ch = blockIdx.x, kb = blockIdx.y;
  const int m0 = 16 * (warp & 3), n0 = 64 * (warp >> 2);
  const bool v64 = L2 || ch < CH_P1;
  const bool with_db = kb == 0 && tid < CW;
  const int ntiles = E / TE;
  // this thread's share of a dwall tile: row er, columns cq .. cq + 15
  const int er = tid >> 2, cq = (tid & 3) * 16;

  auto stage_h = [&](int it, bf16* dst) {
    const size_t e = (size_t)it * TE;
    for (int i = tid; i < TE * (KB / 8); i += NTHREADS) {
      const int r = i / (KB / 8), s = i % (KB / 8);
      cp_async16(dst + r * LDB + 8 * s, h + (e + r) * D + kb * KB + 8 * s);
    }
    cp_commit();
  };
  // dc values (16) and a values (one per 8 columns) of a tile's share
  uint4 dv0, dv1;
  bf16 av0, av1;
  auto fetch = [&](int it) {
    const size_t e = (size_t)it * TE + er;
    if (v64) {
      const uint4* p = reinterpret_cast<const uint4*>(dc0 + e * 64 + cq);
      dv0 = p[0];
      dv1 = p[1];
      av0 = av1 = a_at<L2>(a0, a1, a2, e, ch);
    } else {
      const bool p1 = ch < CH_P2;
      const uint4* p =
          reinterpret_cast<const uint4*>((p1 ? dc1 : dc2) + e * 8);
      dv0 = dv1 = p[0];
      const int u = (ch - (p1 ? CH_P1 : CH_P2)) * 8 + (cq >> 3);
      av0 = a0[e * 64 + u];
      av1 = a0[e * 64 + u + 1];
    }
  };
  auto store = [&](bf16* dst) {  // pair i: columns cq + 2i, cq + 2i + 1
    const unsigned dw[8] = {dv0.x, dv0.y, dv0.z, dv0.w,
                            dv1.x, dv1.y, dv1.z, dv1.w};
    unsigned out[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned dword = v64 ? dw[i] : dw[i & 3];
      const bf16 a = (v64 || i < 4) ? av0 : av1;
      out[i] = as_u32(__hmul2(*reinterpret_cast<const bf162*>(&dword),
                              __bfloat162bfloat162(a)));
    }
    uint4* p = reinterpret_cast<uint4*>(dst + er * LDW + cq);
    p[0] = make_uint4(out[0], out[1], out[2], out[3]);
    p[1] = make_uint4(out[4], out[5], out[6], out[7]);
  };

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;
  float dbs = 0.f;

  stage_h(0, h_s);
  fetch(0);
  store(w_s);
  for (int it = 0; it < ntiles; ++it) {
    cp_wait_all();
    __syncthreads();  // tile it is in place; tile it - 1's buffers are free
    const int cur = it & 1, nxt = cur ^ 1;
    const bool more = it + 1 < ntiles;
    if (more) {
      stage_h(it + 1, h_s + nxt * TE * LDB);
      fetch(it + 1);
    }
    const bf16* hb = h_s + cur * TE * LDB;
    const bf16* wb = w_s + cur * TE * LDW;
#pragma unroll
    for (int ks = 0; ks < TE / 16; ++ks) {
      unsigned af[4];
      ldmatrix_x4_trans(af, wb + (16 * ks + (lane & 7) + ((lane >> 4) << 3)) *
                                     LDW + m0 + ((lane >> 3) & 1) * 8);
      const bf16* brow = hb + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  LDB + n0 + (lane >> 4) * 8;
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        unsigned bfr[4];
        ldmatrix_x4_trans(bfr, brow + 16 * jp);
        mma_bf16(acc[2 * jp], af, bfr[0], bfr[1]);
        mma_bf16(acc[2 * jp + 1], af, bfr[2], bfr[3]);
      }
    }
    if (with_db)
      for (int r = 0; r < TE; ++r)
        dbs = __fadd_rn(dbs, __bfloat162float(wb[r * LDW + tid]));
    if (more) store(w_s + nxt * TE * LDW);
  }

  const size_t row = (size_t)ch * CW + m0 + g;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = kb * KB + n0 + 8 * n + 2 * t;
    *reinterpret_cast<float2*>(dwt + row * D + col) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(dwt + (row + 8) * D + col) =
        make_float2(acc[n][2], acc[n][3]);
  }
  if (with_db) db[ch * CW + tid] = dbs;
}

// ------------------------------------------------------ f32: CUDA cores

template <bool L2, int D>
size_t smem_tile_f32() {
  return sizeof(float) *
         ((size_t)TEF * (D + 4) + (size_t)CW * (D + 4) +
          TEF * (a_width<L2>() + dc_width<L2>()) + TEF * (CW + 1) +
          TEF * a_width<L2>());
}

// (a) dh and da for one 32-edge tile
template <bool L2, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    tp_bwd_tile_fma(const float* __restrict__ h, const float* __restrict__ a0,
                    const float* __restrict__ a1,
                    const float* __restrict__ a2,
                    const float* __restrict__ wt,
                    const float* __restrict__ bias,
                    const float* __restrict__ dc0,
                    const float* __restrict__ dc1,
                    const float* __restrict__ dc2, float* __restrict__ dh,
                    float* __restrict__ da0, float* __restrict__ da1,
                    float* __restrict__ da2) {
  extern __shared__ float4 smem4[];
  constexpr int LD = D + 4;
  constexpr int AW = a_width<L2>(), DW = dc_width<L2>();
  constexpr int QC = D / 64;  // dh columns per thread
  float* h_s = reinterpret_cast<float*>(smem4);  // [TEF][LD]
  float* w_s = h_s + TEF * LD;                    // [CW][LD]
  float* a_s = w_s + CW * LD;                     // [TEF][AW]
  float* dc_s = a_s + TEF * AW;                   // [TEF][DW]
  float* dw_s = dc_s + TEF * DW;                  // [TEF][CW + 1]
  float* da_s = dw_s + TEF * (CW + 1);            // [TEF][AW]
  const int tid = threadIdx.x;
  const int r = tid >> 3, sub = tid & 7;       // chunk work: row, column
  const int kc = tid & 63, rq = (tid >> 6) * 8;  // dh work: columns, rows
  const size_t e0 = (size_t)blockIdx.x * TEF;

  for (int i = tid; i < TEF * D / 4; i += NTHREADS) {
    const int rr = i / (D / 4), c = 4 * (i % (D / 4));
    *reinterpret_cast<float4*>(h_s + rr * LD + c) =
        *reinterpret_cast<const float4*>(h + (e0 + rr) * D + c);
  }
  for (int i = tid; i < TEF * AW; i += NTHREADS) {
    a_s[i] = a_at<L2>(a0, a1, a2, e0 + i / AW, i % AW);
    da_s[i] = 0.f;
  }
  for (int i = tid; i < TEF * DW; i += NTHREADS)
    dc_s[i] = dc_at<L2>(dc0, dc1, dc2, e0 + i / DW, i % DW);

  float acc[8][QC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < QC; ++q) acc[i][q] = 0.f;

  for (int ch = 0; ch < NCHUNK; ++ch) {
    __syncthreads();  // the previous chunk is done with w_s and dw_s
    for (int i = tid; i < CW * D / 4; i += NTHREADS) {
      const int n = i / (D / 4), c = 4 * (i % (D / 4));
      *reinterpret_cast<float4*>(w_s + n * LD + c) =
          *reinterpret_cast<const float4*>(wt + (size_t)(ch * CW + n) * D +
                                           c);
    }
    __syncthreads();
    // w_all chunk: row r, columns sub + 8j
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = 0.f;
    for (int k = 0; k < D; k += 4) {
      const float4 x = *reinterpret_cast<const float4*>(h_s + r * LD + k);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 w =
            *reinterpret_cast<const float4*>(w_s + (sub + 8 * j) * LD + k);
        f[j] = fmaf(x.x, w.x, f[j]);
        f[j] = fmaf(x.y, w.y, f[j]);
        f[j] = fmaf(x.z, w.z, f[j]);
        f[j] = fmaf(x.w, w.w, f[j]);
      }
    }
    const float* arow = a_s + r * AW;
    const float* drow = dc_s + r * DW;
    float s8[8];
    float s64 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = sub + 8 * j;
      int acol, dcol;
      chunk_cols<L2>(ch, c, acol, dcol);
      const float w = __fadd_rn(f[j], bias[ch * CW + c]);
      const float p = __fmul_rn(drow[dcol], w);
      s64 = __fadd_rn(s64, p);
      s8[j] = p;
      dw_s[r * (CW + 1) + c] = __fmul_rn(drow[dcol], arow[acol]);
    }
    // sums over v across the 8 lanes of a row (fixed xor order)
    if (L2 || ch < CH_P1) {  // V = 64: u = ch
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        s64 = __fadd_rn(s64, __shfl_xor_sync(0xffffffffu, s64, o));
      if (sub == 0) da_s[r * AW + ch] = __fadd_rn(da_s[r * AW + ch], s64);
    } else {  // L1 V = 8: column sub + 8j is u = u0 + j, v = sub
      const int u0 = (ch - (ch < CH_P2 ? CH_P1 : CH_P2)) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          s8[j] = __fadd_rn(s8[j], __shfl_xor_sync(0xffffffffu, s8[j], o));
      }
      if (sub == 0)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          da_s[r * AW + u0 + j] = __fadd_rn(da_s[r * AW + u0 + j], s8[j]);
    }
    __syncthreads();  // dw_s is complete
    // dh rows rq .. rq + 7, columns kc + 64q
    for (int c = 0; c < CW; ++c) {
      float wv[QC];
#pragma unroll
      for (int q = 0; q < QC; ++q) wv[q] = w_s[c * LD + kc + 64 * q];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = dw_s[(rq + i) * (CW + 1) + c];
#pragma unroll
        for (int q = 0; q < QC; ++q) acc[i][q] = fmaf(x, wv[q], acc[i][q]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < QC; ++q)
      dh[(e0 + rq + i) * D + kc + 64 * q] = acc[i][q];
  for (int i = tid; i < TEF * AW; i += NTHREADS) {
    const int rr = i / AW, c = i % AW;
    if (!L2 || c < 64)
      da0[(e0 + rr) * 64 + c] = da_s[i];
    else if (c < 72)
      da1[(e0 + rr) * 8 + c - 64] = da_s[i];
    else
      da2[(e0 + rr) * 8 + c - 72] = da_s[i];
  }
}

constexpr size_t smem_weight_f32() {
  return sizeof(float) * ((size_t)TEF * KB + (size_t)TEF * CW);
}

// (b) dwt rows [ch*CW, ch*CW + 64) x columns [kb*KB, kb*KB + 128) and db
template <bool L2, int D>
__global__ void __launch_bounds__(NTHREADS)
    tp_bwd_weight_fma(const float* __restrict__ h,
                      const float* __restrict__ a0,
                      const float* __restrict__ a1,
                      const float* __restrict__ a2,
                      const float* __restrict__ dc0,
                      const float* __restrict__ dc1,
                      const float* __restrict__ dc2, float* __restrict__ dwt,
                      float* __restrict__ db, int E) {
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);  // [TEF][KB]
  float* w_s = h_s + TEF * KB;                    // [TEF][CW]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch = blockIdx.x, kb = blockIdx.y;
  const bool with_db = kb == 0 && tid < CW;
  float acc[8][4];  // rows warp*8 + i of the chunk, columns 4*lane + q
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  float dbs = 0.f;

  for (size_t e0 = 0; e0 < (size_t)E; e0 += TEF) {
    __syncthreads();  // the previous step is done with h_s and w_s
    for (int i = tid; i < TEF * KB / 4; i += NTHREADS) {
      const int r = i / (KB / 4), c = 4 * (i % (KB / 4));
      *reinterpret_cast<float4*>(h_s + r * KB + c) =
          *reinterpret_cast<const float4*>(h + (e0 + r) * D + kb * KB + c);
    }
    for (int i = tid; i < TEF * CW; i += NTHREADS) {
      const int r = i / CW, c = i % CW;
      int acol, dcol;
      chunk_cols<L2>(ch, c, acol, dcol);
      w_s[i] = __fmul_rn(dc_at<L2>(dc0, dc1, dc2, e0 + r, dcol),
                         a_at<L2>(a0, a1, a2, e0 + r, acol));
    }
    __syncthreads();
    for (int r = 0; r < TEF; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(h_s + r * KB +
                                                        4 * lane);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float w = w_s[r * CW + warp * 8 + i];
        acc[i][0] = fmaf(w, x.x, acc[i][0]);
        acc[i][1] = fmaf(w, x.y, acc[i][1]);
        acc[i][2] = fmaf(w, x.z, acc[i][2]);
        acc[i][3] = fmaf(w, x.w, acc[i][3]);
      }
    }
    if (with_db)
      for (int r = 0; r < TEF; ++r) dbs = __fadd_rn(dbs, w_s[r * CW + tid]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(dwt + (size_t)(ch * CW + warp * 8 + i) * D +
                               kb * KB + 4 * lane) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  if (with_db) db[ch * CW + tid] = dbs;
}

// --------------------------------------------------------------- host

template <bool L2, int D>
size_t smem_bytes(bool is_bf16) {
  if (is_bf16) {
    const size_t a = smem_tile_bf16<L2, D>(), b = smem_weight_bf16();
    return a > b ? a : b;
  }
  const size_t a = smem_tile_f32<L2, D>(), b = smem_weight_f32();
  return a > b ? a : b;
}

template <typename K, typename... Args>
cudaError_t launch(K kern, dim3 blocks, size_t smem, cudaStream_t s,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<blocks, NTHREADS, smem, s>>>(args...);
  return cudaGetLastError();
}

template <bool L2, int D>
cudaError_t run(const void* h, const void* a0, const void* a1,
                const void* a2, const void* wt, const void* bias,
                const void* dc0, const void* dc1, const void* dc2, void* dh,
                void* da0, void* da1, void* da2, void* dwt, void* db, int E,
                bool is_bf16, cudaStream_t s) {
  const dim3 wgrid(NCHUNK, D / KB);
  cudaError_t err;
  if (is_bf16) {
    using T = const bf16*;
    err = launch(tp_bwd_tile_mma<L2, D>, dim3(E / TE),
                 smem_tile_bf16<L2, D>(), s, (T)h, (T)a0, (T)a1, (T)a2,
                 (T)wt, (T)bias, (T)dc0, (T)dc1, (T)dc2, (bf16*)dh,
                 (bf16*)da0, (bf16*)da1, (bf16*)da2);
    if (err != cudaSuccess) return err;
    return launch(tp_bwd_weight_mma<L2, D>, wgrid, smem_weight_bf16(), s,
                  (T)h, (T)a0, (T)a1, (T)a2, (T)dc0, (T)dc1, (T)dc2,
                  (float*)dwt, (float*)db, E);
  }
  using T = const float*;
  err = launch(tp_bwd_tile_fma<L2, D>, dim3(E / TEF), smem_tile_f32<L2, D>(),
               s, (T)h, (T)a0, (T)a1, (T)a2, (T)wt, (T)bias, (T)dc0, (T)dc1,
               (T)dc2, (float*)dh, (float*)da0, (float*)da1, (float*)da2);
  if (err != cudaSuccess) return err;
  return launch(tp_bwd_weight_fma<L2, D>, wgrid, smem_weight_f32(), s, (T)h,
                (T)a0, (T)a1, (T)a2, (T)dc0, (T)dc1, (T)dc2, (float*)dwt,
                (float*)db, E);
}

}  // namespace

// Shared memory of the larger of the two passes' blocks (bytes), for the
// wrapper's shape check; 0 for an unsupported d.
extern "C" long long tp_contract_bwd_smem(int d, int is_bf16, int l2) {
  if (d != 128 && d != 256) return 0;
  if (l2)
    return (long long)(d == 128 ? smem_bytes<true, 128>(is_bf16 != 0)
                                : smem_bytes<true, 256>(is_bf16 != 0));
  return (long long)(d == 128 ? smem_bytes<false, 128>(is_bf16 != 0)
                              : smem_bytes<false, 256>(is_bf16 != 0));
}

// C entry point (bound with ctypes). E % 64 == 0, d in {128, 256}; every
// tensor in one dtype (is_bf16), 16-byte aligned. l2 = 0: a0 = a [E, 64],
// dc0/dc1/dc2 [E,64]/[E,8]/[E,8], da0 [E, 64]; a1/a2/da1/da2 unused (null).
// l2 = 1: a0/a1/a2 and da0/da1/da2 [E,64]/[E,8]/[E,8], dc0 [E, 64],
// dc1/dc2 unused. dh [E, d]; dwt [5120, d] and db [5120] f32. Two launches
// on the stream; returns cudaGetLastError() after them.
extern "C" int tp_contract_bwd(const void* h, const void* a0, const void* a1,
                               const void* a2, const void* wt,
                               const void* bias, const void* dc0,
                               const void* dc1, const void* dc2, void* dh,
                               void* da0, void* da1, void* da2, void* dwt,
                               void* db, int E, int d, int is_bf16, int l2,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E == 0 || (d != 128 && d != 256)) return cudaGetLastError();
  const bool bf = is_bf16 != 0;
  if (l2)
    return d == 128 ? run<true, 128>(h, a0, a1, a2, wt, bias, dc0, dc1, dc2,
                                     dh, da0, da1, da2, dwt, db, E, bf, s)
                    : run<true, 256>(h, a0, a1, a2, wt, bias, dc0, dc1, dc2,
                                     dh, da0, da1, da2, dwt, db, E, bf, s);
  return d == 128 ? run<false, 128>(h, a0, a1, a2, wt, bias, dc0, dc1, dc2,
                                    dh, da0, da1, da2, dwt, db, E, bf, s)
                  : run<false, 256>(h, a0, a1, a2, wt, bias, dc0, dc1, dc2,
                                    dh, da0, da1, da2, dwt, db, E, bf, s);
}
