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
// cores (bf16) or the f32 FMA rate (0.82 ms at the 67 TFLOP/s of an NVIDIA
// H100 SXM at its 700 W limit) bound it. Nothing of size [E, 5120] or
// [E, U, V] reaches device memory.
//
// bf16 design: one block per tile of edges; h's tile stays in shared memory
// and wt streams through in chunks of 64 columns. The tile is 16 edges per
// warp, 4 to 12 warps, sized by the caller so that the tiles fill the SMs in
// one wave (one block per SM: at E = 20992 on 132 SMs, 10 warps, 132
// blocks of 160 edges, where 128-edge tiles took two waves, the second a
// quarter full); wt chunks are double-buffered with cp.async; each warp runs
// mma.sync m16n8k16 (bf16 operands from ldmatrix, f32 accumulators) over its
// 16 rows of the chunk; a 64-column chunk is one u of a V = 64 path or eight
// u of a V = 8 path, so every thread contracts its own accumulator fragment
// in registers (the TPU's R_rep / R_sum 0/1 matmuls are not needed). Each
// row's arithmetic is independent of the tile it sits in. bf16 at d = 512
// fits with at most 5 warps per block (the wrapper picks the largest warp
// count that fits).
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

// the f32 SIMT GEMM tile (shared with K5/K6's and K8's f32 passes)
#include "simt_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_WARPS = 12;         // bf16 path: 16 edges per warp
constexpr int CW = 64;                // wt rows (output columns) per chunk
constexpr int NUMEL = 5120;
constexpr int NCHUNK = NUMEL / CW;    // 80
constexpr int CH_P1 = 4096 / CW;      // first chunk of path 1 (64)
constexpr int CH_P2 = 4608 / CW;      // first chunk of path 2 (72)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// a's columns in shared memory, stored as ST: L1 a [64]; L2 a0 [64] |
// a1 [8] | a2 [8]; the padded stride keeps the 8 rows a warp reads at once
// on distinct banks
template <bool L2> __host__ __device__ constexpr int a_width() {
  return L2 ? 80 : 64;
}
template <bool L2, typename ST> __host__ __device__ constexpr int a_stride() {
  return a_width<L2>() + (sizeof(ST) == 2 ? 2 : 1);
}

// a tile -> a_s, rounded to T (exact in ST): rows e0 .. e0 + te, zeros for
// rows at or past E
template <bool L2, typename T, typename AT, typename ST>
__device__ __forceinline__ void stage_a(const AT* a0, const AT* a1,
                                        const AT* a2, size_t e0, int te,
                                        int E, ST* a_s) {
  constexpr int AW = a_width<L2>(), AS = a_stride<L2, ST>();
  for (int i = threadIdx.x; i < te * AW; i += blockDim.x) {
    const int r = i / AW, c = i % AW;
    float v = 0.f;
    if (e0 + r < (size_t)E) {
      if (c < 64)
        v = to_f(a0[(e0 + r) * 64 + c]);
      else if (c < 72)
        v = to_f(a1[(e0 + r) * 8 + c - 64]);
      else
        v = to_f(a2[(e0 + r) * 8 + c - 72]);
    }
    a_s[r * AS + c] = from_f<ST>(round_to<T>(v));
  }
}

// ------------------------------------------------ bf16: tensor cores

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
// c += A (16x16, row) * B (16x8, col); bf16 operands, f32 accumulators.
// Fragment c: c[0], c[1] at (row g, cols 2t, 2t+1); c[2], c[3] at row g+8.
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wt rows [ch*CW, ch*CW + CW) -> dst [CW][ldh] (16-byte cp.async)
__device__ __forceinline__ void load_chunk(const bf16* wt, int ch, int d,
                                           int ldh, bf16* dst) {
  const int segs = d / 8;
  for (int i = threadIdx.x; i < CW * segs; i += blockDim.x) {
    const int n = i / segs, s = i % segs;
    cp_async16(dst + n * ldh + 8 * s, wt + (size_t)(ch * CW + n) * d + 8 * s);
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

template <bool L2, typename AT>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
    tp_fwd_mma(const bf16* __restrict__ h, const AT* __restrict__ a0,
               const AT* __restrict__ a1, const AT* __restrict__ a2,
               const bf16* __restrict__ wt, const bf16* __restrict__ bias,
               bf16* __restrict__ out0, bf16* __restrict__ out1,
               bf16* __restrict__ out2, int E, int d) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int AS = a_stride<L2, bf16>();
  const int te = blockDim.x / 2;
  const int ldh = d + 8;  // bf16 row stride: 16-byte rows, no bank conflicts
  bf16* h_s = reinterpret_cast<bf16*>(smem_raw);  // [te][ldh]
  bf16* w_s = h_s + te * ldh;                      // 2 x [CW][ldh]
  bf16* a_s = w_s + 2 * CW * ldh;                  // [te][AS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t e0 = (size_t)blockIdx.x * te;

  const int segs = d / 8;
  for (int i = tid; i < te * segs; i += blockDim.x) {
    const int r = i / segs, s = i % segs;
    if (e0 + r < (size_t)E)
      cp_async16(h_s + r * ldh + 8 * s, h + (e0 + r) * d + 8 * s);
    else
      *reinterpret_cast<uint4*>(h_s + r * ldh + 8 * s) = make_uint4(0, 0,
                                                                    0, 0);
  }
  load_chunk(wt, 0, d, ldh, w_s);
  cp_commit();
  stage_a<L2, bf16>(a0, a1, a2, e0, te, E, a_s);

  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  float c64[8][4];  // V = 64 outputs at this thread's fragment positions
  float c8a[4], c8b[4];  // L1's V = 8 paths: (row, v = 2t + (q & 1))
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) c64[j][q] = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) c8a[q] = c8b[q] = 0.f;

  for (int ch = 0; ch < NCHUNK; ++ch) {
    cp_wait_all();
    // chunk ch has landed everywhere, and every warp is done with chunk
    // ch - 1, whose buffer the next load reuses
    __syncthreads();
    if (ch + 1 < NCHUNK) {
      load_chunk(wt, ch + 1, d, ldh, w_s + ((ch + 1) & 1) * CW * ldh);
      cp_commit();
    }
    const bf16* wb = w_s + (ch & 1) * CW * ldh;
    float f[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) f[j][q] = 0.f;
    for (int kk = 0; kk < d; kk += 16) {
      unsigned af[4];
      ldmatrix_x4(af, h_s + (warp * 16 + (lane & 15)) * ldh + kk +
                          (lane >> 4) * 8);
      const int m = lane >> 3, rr = lane & 7;
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {  // n-tiles 2jp, 2jp + 1
        unsigned bfr[4];
        ldmatrix_x4(bfr, wb + (16 * jp + 8 * (m >> 1) + rr) * ldh + kk +
                             8 * (m & 1));
        mma_bf16(f[2 * jp], af, bfr[0], bfr[1]);
        mma_bf16(f[2 * jp + 1], af, bfr[2], bfr[3]);
      }
    }

    // contract the chunk: column ch*CW + 8j + 2t + (q & 1)
    const __nv_bfloat162* b2 =
        reinterpret_cast<const __nv_bfloat162*>(bias + ch * CW) + t;
    if (!L2 && ch >= CH_P1) {  // V = 8: u = u0 + j, v = 2t + (q & 1)
      const int u0 = (ch - (ch < CH_P2 ? CH_P1 : CH_P2)) * 8;
      float s8[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bj = __bfloat1622float2(b2[4 * j]);
        const float2 plo = tp_term2(
            f[j][0], f[j][1], bj,
            __bfloat162bfloat162(a_s[r_lo * AS + u0 + j]));
        const float2 phi = tp_term2(
            f[j][2], f[j][3], bj,
            __bfloat162bfloat162(a_s[r_hi * AS + u0 + j]));
        s8[0] = __fadd_rn(s8[0], plo.x);
        s8[1] = __fadd_rn(s8[1], plo.y);
        s8[2] = __fadd_rn(s8[2], phi.x);
        s8[3] = __fadd_rn(s8[3], phi.y);
      }
      if (ch < CH_P2) {
#pragma unroll
        for (int q = 0; q < 4; ++q) c8a[q] = __fadd_rn(c8a[q], s8[q]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) c8b[q] = __fadd_rn(c8b[q], s8[q]);
      }
    } else {  // V = 64: one u per chunk; a's column is ch for L1 and L2
      const __nv_bfloat162 alo = __bfloat162bfloat162(a_s[r_lo * AS + ch]);
      const __nv_bfloat162 ahi = __bfloat162bfloat162(a_s[r_hi * AS + ch]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bj = __bfloat1622float2(b2[4 * j]);
        const float2 plo = tp_term2(f[j][0], f[j][1], bj, alo);
        const float2 phi = tp_term2(f[j][2], f[j][3], bj, ahi);
        c64[j][0] = __fadd_rn(c64[j][0], plo.x);
        c64[j][1] = __fadd_rn(c64[j][1], plo.y);
        c64[j][2] = __fadd_rn(c64[j][2], phi.x);
        c64[j][3] = __fadd_rn(c64[j][3], phi.y);
      }
    }
  }

  const size_t lo = e0 + r_lo, hi = e0 + r_hi;
  const bool lo_in = lo < (size_t)E, hi_in = hi < (size_t)E;
  auto put = [](bf16* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  };
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (lo_in) put(out0 + lo * 64 + c, c64[j][0], c64[j][1]);
    if (hi_in) put(out0 + hi * 64 + c, c64[j][2], c64[j][3]);
  }
  if (!L2) {
    const int c = 2 * t;
    if (lo_in) {
      put(out1 + lo * 8 + c, c8a[0], c8a[1]);
      put(out2 + lo * 8 + c, c8b[0], c8b[1]);
    }
    if (hi_in) {
      put(out1 + hi * 8 + c, c8a[2], c8a[3]);
      put(out2 + hi * 8 + c, c8b[2], c8b[3]);
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

// dynamic shared memory of one block (bytes); warps: the bf16 tile
size_t smem_bytes(int d, bool is_bf16, bool l2, int warps) {
  if (is_bf16)
    return sizeof(bf16) *
           ((size_t)(16 * warps + 2 * CW) * (d + 8) +
            (size_t)16 * warps *
                (l2 ? a_stride<true, bf16>() : a_stride<false, bf16>()));
  return F32_SMEM;
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

template <bool L2, typename AT>
cudaError_t run_bf16(const void* h, const void* a0, const void* a1,
                     const void* a2, const void* wt, const void* bias,
                     void* out0, void* out1, void* out2, int E, int d,
                     int warps, cudaStream_t s) {
  const int te = 16 * warps, blocks = (E + te - 1) / te;
  return launch(tp_fwd_mma<L2, AT>, blocks, 32 * warps,
                smem_bytes(d, true, L2, warps), s, (const bf16*)h,
                (const AT*)a0, (const AT*)a1, (const AT*)a2, (const bf16*)wt,
                (const bf16*)bias, (bf16*)out0, (bf16*)out1, (bf16*)out2, E,
                d);
}

template <bool L2>
cudaError_t run(const void* h, const void* a0, const void* a1,
                const void* a2, const void* wt, const void* bias, void* out0,
                void* out1, void* out2, void* work, int E, int d, int is_bf16,
                int a_f32, int warps, cudaStream_t s) {
  if (is_bf16 && a_f32)
    return run_bf16<L2, float>(h, a0, a1, a2, wt, bias, out0, out1, out2, E,
                               d, warps, s);
  if (is_bf16)
    return run_bf16<L2, bf16>(h, a0, a1, a2, wt, bias, out0, out1, out2, E,
                              d, warps, s);
  using T = const float*;
  return run_f32<L2>(F32Args{(T)h, (T)a0, (T)a1, (T)a2, (T)wt, (T)bias,
                             (float*)out0, (float*)out1, (float*)out2,
                             (float*)work, E, d},
                     s);
}

}  // namespace

// Shared memory one block needs (bytes), for the wrapper's shape check.
extern "C" long long tp_contract_fwd_smem(int d, int is_bf16, int l2,
                                          int warps) {
  return (long long)smem_bytes(d, is_bf16 != 0, l2 != 0, warps);
}

// floats of scratch the call needs in ``work``: the f32 tile pass's partial
// tables of out0 (none in bf16, or with one group)
extern "C" long long tp_contract_fwd_workspace(int E, int is_bf16, int l2) {
  const int np = n_parts(l2 != 0);
  return is_bf16 || np == 1 ? 0 : (long long)np * E * 64;
}

// C entry point (bound with ctypes). E % 64 == 0, d % 16 == 0 (the wrapper
// pads other widths), bf16 with a warp count whose smem_bytes fits; h [E, d],
// wt [5120, d], bias [5120] and the outputs in one dtype (is_bf16), a in f32
// (a_f32 = 1) or h's dtype; h and wt 16-byte aligned. l2 = 0: a0 = a
// [E, 64], a1/a2 unused (null), outputs out0 [E, 64], out1 [E, 8], out2
// [E, 8]; l2 = 1: a0 [E, 64], a1/a2 [E, 8], one output out0 [E, 64]. work:
// tp_contract_fwd_workspace floats. bf16: one launch, blocks of 16 * warps
// edges (4 <= warps <= 12); f32: the tile pass and, with more than one
// partial table, the reduce. Returns cudaGetLastError() after the launches.
extern "C" int tp_contract_fwd(const void* h, const void* a0, const void* a1,
                               const void* a2, const void* wt,
                               const void* bias, void* out0, void* out1,
                               void* out2, void* work, int E, int d,
                               int is_bf16, int a_f32, int l2, int warps,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E == 0) return cudaGetLastError();
  if (l2)
    return run<true>(h, a0, a1, a2, wt, bias, out0, out1, out2, work, E, d,
                     is_bf16, a_f32, warps, s);
  return run<false>(h, a0, a1, a2, wt, bias, out0, out1, out2, work, E, d,
                    is_bf16, a_f32, warps, s);
}
