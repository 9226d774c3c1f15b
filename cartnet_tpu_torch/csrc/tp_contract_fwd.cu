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
// cores (bf16) or the f32 FMA rate bound it. Nothing of size [E, 5120] or
// [E, U, V] reaches device memory.
//
// Design: one block per tile of edges; h's tile stays in shared memory and
// wt streams through in chunks of 64 columns. bf16: the tile is 16 edges per
// warp, 4 to 12 warps, sized by the caller so that the tiles fill the SMs in
// one wave (one block per SM: at E = 20992 on 132 SMs, 10 warps, 132
// blocks of 160 edges, where 128-edge tiles took two waves, the second a
// quarter full); wt chunks are double-buffered with cp.async; each warp runs
// mma.sync m16n8k16 (bf16 operands from ldmatrix, f32 accumulators) over its
// 16 rows of the chunk; a 64-column chunk is one u of a V = 64 path or eight
// u of a V = 8 path, so every thread contracts its own accumulator fragment
// in registers (the TPU's R_rep / R_sum 0/1 matmuls are not needed). Each
// row's arithmetic is independent of the tile it sits in. f32: blocks of
// 128 edges, a register-tiled FMA GEMM on the CUDA cores writes the chunk to
// shared memory and each thread contracts the (edge, v) outputs it owns;
// past d = 256 the h tile no longer fits beside the chunk tiles, and h is
// staged KC columns at a time beside the weight chunk (a K loop over d).
// bf16 at d = 512 fits with at most 5 warps per block (the wrapper picks
// the largest warp count that fits).
// Sums run in a fixed order (ascending u), so results are bitwise
// repeatable; the epilogue uses explicitly rounded adds/multiplies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TE = 128;               // f32 path: edges per block
constexpr int NTHREADS = 256;         // f32 path: 8 warps
constexpr int MAX_WARPS = 12;         // bf16 path: 16 edges per warp
constexpr int CW = 64;                // wt rows (output columns) per chunk
constexpr int NUMEL = 5120;
constexpr int NCHUNK = NUMEL / CW;    // 80
constexpr int CH_P1 = 4096 / CW;      // first chunk of path 1 (64)
constexpr int CH_P2 = 4608 / CW;      // first chunk of path 2 (72)
constexpr int KC = 16;                // wt columns staged per FMA step
constexpr int CS = CW + 4;            // f32 chunk tile stride

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

template <bool L2>
__global__ void __launch_bounds__(NTHREADS, 1)
    tp_fwd_fma(const float* __restrict__ h, const float* __restrict__ a0,
               const float* __restrict__ a1, const float* __restrict__ a2,
               const float* __restrict__ wt, const float* __restrict__ bias,
               float* __restrict__ out0, float* __restrict__ out1,
               float* __restrict__ out2, int E, int d, int full_h) {
  extern __shared__ float4 smem4[];
  constexpr int AS = a_stride<L2, float>();
  // h_s holds the whole h tile where it fits (full_h), else the KC columns
  // of the current step, staged beside each weight chunk (a K loop over d)
  const int ldh = full_h ? d + 4 : KC + 4;
  float* h_s = reinterpret_cast<float*>(smem4);  // [TE][ldh]
  float* w_s = h_s + TE * ldh;                    // [KC][CW]
  float* c_s = w_s + KC * CW;                     // [TE][CS]
  float* a_s = c_s + TE * CS;                     // [TE][AS]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t e0 = (size_t)blockIdx.x * TE;

  if (full_h)
    for (int i = tid; i < TE * d / 4; i += NTHREADS) {
      const int r = i / (d / 4), c = 4 * (i % (d / 4));
      *reinterpret_cast<float4*>(&h_s[r * ldh + c]) =
          *reinterpret_cast<const float4*>(&h[(e0 + r) * d + c]);
    }
  stage_a<L2, float>(a0, a1, a2, e0, TE, E, a_s);
  __syncthreads();

  // outputs owned in the contraction: V = 64 at (tid/64 + 4i, tid%64);
  // L1's V = 8 paths at (tid/8 + 32i, tid%8)
  float o64[TE * 64 / NTHREADS];
  float o8a[TE * 8 / NTHREADS], o8b[TE * 8 / NTHREADS];
#pragma unroll
  for (int i = 0; i < TE * 64 / NTHREADS; ++i) o64[i] = 0.f;
#pragma unroll
  for (int i = 0; i < TE * 8 / NTHREADS; ++i) o8a[i] = o8b[i] = 0.f;

  for (int ch = 0; ch < NCHUNK; ++ch) {
    // chunk GEMM: rows ty*8 + i, columns 4tx + j
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += KC) {
      for (int i = tid; i < KC * CW; i += NTHREADS) {
        const int n = i / KC, kk = i % KC;
        w_s[kk * CW + n] = wt[(size_t)(ch * CW + n) * d + k0 + kk];
      }
      if (!full_h)
        for (int i = tid; i < TE * KC / 4; i += NTHREADS) {
          const int r = i / (KC / 4), c = 4 * (i % (KC / 4));
          *reinterpret_cast<float4*>(&h_s[r * ldh + c]) =
              *reinterpret_cast<const float4*>(&h[(e0 + r) * d + k0 + c]);
        }
      __syncthreads();
      const int hk = full_h ? k0 : 0;  // h_s column of step k0
#pragma unroll
      for (int kk = 0; kk < KC; kk += 4) {
        float4 a4[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a4[i] = *reinterpret_cast<const float4*>(
              &h_s[(ty * 8 + i) * ldh + hk + kk]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 b4 =
              *reinterpret_cast<const float4*>(&w_s[(kk + q) * CW + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float av = q == 0 ? a4[i].x
                           : q == 1 ? a4[i].y
                           : q == 2 ? a4[i].z
                                    : a4[i].w;
            acc[i][0] = fmaf(av, b4.x, acc[i][0]);
            acc[i][1] = fmaf(av, b4.y, acc[i][1]);
            acc[i][2] = fmaf(av, b4.z, acc[i][2]);
            acc[i][3] = fmaf(av, b4.w, acc[i][3]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(&c_s[(ty * 8 + i) * CS + 4 * tx]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();

    const float* bc = bias + ch * CW;
    if (!L2 && ch >= CH_P1) {  // V = 8: chunk column 8uu + v, u = u0 + uu
      const int u0 = (ch - (ch < CH_P2 ? CH_P1 : CH_P2)) * 8, v = tid % 8;
#pragma unroll
      for (int i = 0; i < TE * 8 / NTHREADS; ++i) {
        const int r = tid / 8 + 32 * i;
        float s = 0.f;
#pragma unroll
        for (int uu = 0; uu < 8; ++uu)
          s = __fadd_rn(s, __fmul_rn(__fadd_rn(c_s[r * CS + 8 * uu + v],
                                               bc[8 * uu + v]),
                                     a_s[r * AS + u0 + uu]));
        if (ch < CH_P2)
          o8a[i] = __fadd_rn(o8a[i], s);
        else
          o8b[i] = __fadd_rn(o8b[i], s);
      }
    } else {  // V = 64: u = ch (L1) / a column ch (L2)
      const int v = tid % 64;
      const float bv = bc[v];
#pragma unroll
      for (int i = 0; i < TE * 64 / NTHREADS; ++i) {
        const int r = tid / 64 + 4 * i;
        o64[i] = __fadd_rn(o64[i],
                           __fmul_rn(__fadd_rn(c_s[r * CS + v], bv),
                                     a_s[r * AS + ch]));
      }
    }
    // c_s is rewritten only after the next chunk's GEMM barriers
  }

#pragma unroll
  for (int i = 0; i < TE * 64 / NTHREADS; ++i)
    out0[(e0 + tid / 64 + 4 * i) * 64 + tid % 64] = o64[i];
  if (!L2) {
#pragma unroll
    for (int i = 0; i < TE * 8 / NTHREADS; ++i) {
      const size_t o = (e0 + tid / 8 + 32 * i) * 8 + tid % 8;
      out1[o] = o8a[i];
      out2[o] = o8b[i];
    }
  }
}

constexpr size_t SMEM_LIMIT = 232448;  // bytes of shared memory a block may use

// f32 shared memory (bytes) with the whole h tile staged (full_h) or KC
// columns of it per step
size_t smem_f32(int d, bool l2, bool full_h) {
  const int as = l2 ? a_stride<true, float>() : a_stride<false, float>();
  return sizeof(float) * ((size_t)TE * (full_h ? d + 4 : KC + 4) + KC * CW +
                          TE * CS + (size_t)TE * as);
}

// dynamic shared memory of one block (bytes); warps: the bf16 tile
size_t smem_bytes(int d, bool is_bf16, bool l2, int warps) {
  if (is_bf16)
    return sizeof(bf16) *
           ((size_t)(16 * warps + 2 * CW) * (d + 8) +
            (size_t)16 * warps *
                (l2 ? a_stride<true, bf16>() : a_stride<false, bf16>()));
  const size_t full = smem_f32(d, l2, true);
  return full <= SMEM_LIMIT ? full : smem_f32(d, l2, false);
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
cudaError_t run(const void* h, const void* a0, const void* a1,
                const void* a2, const void* wt, const void* bias, void* out0,
                void* out1, void* out2, int E, int d, int is_bf16, int a_f32,
                int warps, cudaStream_t s) {
  const size_t smem = smem_bytes(d, is_bf16, L2, warps);
  if (!is_bf16)
    return launch(tp_fwd_fma<L2>, E / TE, NTHREADS, smem, s,
                  (const float*)h, (const float*)a0, (const float*)a1,
                  (const float*)a2, (const float*)wt, (const float*)bias,
                  (float*)out0, (float*)out1, (float*)out2, E, d,
                  (int)(smem_f32(d, L2, true) <= SMEM_LIMIT));
  const int te = 16 * warps, blocks = (E + te - 1) / te;
  if (a_f32)
    return launch(tp_fwd_mma<L2, float>, blocks, 32 * warps, smem, s,
                  (const bf16*)h, (const float*)a0, (const float*)a1,
                  (const float*)a2, (const bf16*)wt, (const bf16*)bias,
                  (bf16*)out0, (bf16*)out1, (bf16*)out2, E, d);
  return launch(tp_fwd_mma<L2, bf16>, blocks, 32 * warps, smem, s,
                (const bf16*)h, (const bf16*)a0, (const bf16*)a1,
                (const bf16*)a2, (const bf16*)wt, (const bf16*)bias,
                (bf16*)out0, (bf16*)out1, (bf16*)out2, E, d);
}

}  // namespace

// Shared memory one block needs (bytes), for the wrapper's shape check.
extern "C" long long tp_contract_fwd_smem(int d, int is_bf16, int l2,
                                          int warps) {
  return (long long)smem_bytes(d, is_bf16 != 0, l2 != 0, warps);
}

// C entry point (bound with ctypes). E % 128 == 0, d % 16 == 0 (the wrapper
// pads other widths), bf16 with a warp count whose smem_bytes fits; h [E, d],
// wt [5120, d], bias [5120] and the outputs in one dtype (is_bf16), a in f32
// (a_f32 = 1) or h's dtype. l2 = 0: a0 = a [E, 64], a1/a2 unused (null),
// outputs out0 [E, 64], out1 [E, 8], out2 [E, 8]; l2 = 1: a0 [E, 64],
// a1/a2 [E, 8], one output out0 [E, 64]. bf16: blocks of 16 * warps edges
// (4 <= warps <= 12); f32: blocks of 128. Returns cudaGetLastError() after
// the launch.
extern "C" int tp_contract_fwd(const void* h, const void* a0, const void* a1,
                               const void* a2, const void* wt,
                               const void* bias, void* out0, void* out1,
                               void* out2, int E, int d, int is_bf16,
                               int a_f32, int l2, int warps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E == 0) return cudaGetLastError();
  if (l2)
    return run<true>(h, a0, a1, a2, wt, bias, out0, out1, out2, E, d, is_bf16,
                     a_f32, warps, s);
  return run<false>(h, a0, a1, a2, wt, bias, out0, out1, out2, E, d, is_bf16,
                    a_f32, warps, s);
}
