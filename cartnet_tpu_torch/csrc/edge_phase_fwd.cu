// CartNet edge phase, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cartnet_tpu/ops/pallas/edge_kernels.py:
// edge_phase_fwd -> _fwd_kernel. Per edge e (f32 accumulation throughout):
//   pre    = xi[dst] + xj[src] + e @ We + b          [2d]
//   h      = silu(pre), rounded to the edge dtype
//   gate   = h[:d] @ W1g + b1g,  sender = h[d:] @ W1a + b1a   (table dtype)
// plus two optional outputs: the saved residual, [pre | sigmoid(pre)] [E, 4d]
// or pre alone [E, 2d] (the merged backward recomputes the sigmoid), and the
// per-tile masked Welford partials s1_w / M2_w of the rounded gate.
//
// What bounds it: 4*E*d*2d multiply-adds (11 GFLOP at E=20992, d=256)
// against ~35-60 MB of unavoidable traffic (e in, gate/sender out), so at
// the tensor-core rate the card is bound by memory for f32 node tables and
// by the matmuls for bf16 ones, both near 11-17 us at the published rates
// of an NVIDIA H100 SXM at its 700 W limit. One launch
// per call; every sum in a fixed order, so results repeat bitwise; the
// elementwise steps use explicitly rounded adds/multiplies so nothing is
// contracted into an FMA that the plain PyTorch version does not have.
// d % 128 == 0 and d <= 512 (the wrapper zero-pads other widths).
//
// bf16 edges (serving layer 0 and layers 1-3, the training layouts, the
// eComformer convs), wgmma + TMA: a persistent grid (one block per SM)
// walks the 64-edge tiles in a static order (tile = blockIdx.x + k
// gridDim.x). Block = two consumer warpgroups + one producer warp. The
// producer loads the tile's e [64, d] by TMA (d/64 128-byte swizzled
// slabs; the next tile's as soon as this tile's pre products are done, so
// it lands during the sender product) and keeps a ring of 64 x 64 weight
// slabs of We, W1g, W1a in flight (TMA, mbarrier completion, as K5/K6 do;
// the weights are the same for every tile and stay in L2). The consumers
// work one half of pre at a time, each warpgroup owning every other
// 64-column chunk: wgmma m64n64k16 runs e @ We's chunk (A = the e tile
// K-major, B = the slabs MN-major, as the [K, N] weights are stored); the
// chunk's xi[dst] and xj[src] pairs are loaded into registers before its
// products are started, so the gathers' latency overlaps them; the epilogue
// in the accumulator registers forms pre = xi + xj + acc + b and
// h = silu(pre), rounded, into a swizzled h half tile (fence.proxy.async),
// and stores the optional residual. Then wgmma runs h_g @ W1g (h_a @ W1a)
// from that tile; its epilogue adds b1g (b1a), rounds and stores gate
// (sender) and, on the gate half, sums the masked Welford partials of the
// rounded gate over the tile's 64 rows (a fixed-order shuffle tree, then
// the warpgroup's 4 warps in order). No f32 tile makes a round trip through
// shared memory; [E, 2d] pre/h never reach device memory.
//
// f32 edges (the all-f32 configuration) keep the FMA design: one block per
// 64-edge tile, a register-tiled GEMM on the CUDA cores (full f32, no
// TF32) over weight chunks staged by the threads, the e tile staged where
// it fits (up to d = 384; else the phase-1 product reads e from device
// memory), one half of pre at a time in a [64, d] shared-memory tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

// TMA, mbarriers, wgmma descriptors and products, the TMA ring, the tensor
// maps (shared with K5/K6 and K8)
#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TE = 64;         // edges per block
constexpr int NTHREADS = 256;  // 8 warps
constexpr int CN = 128;        // output columns per chunk
constexpr size_t SMEM_LIMIT = 232448;  // bytes of shared memory a block may use

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

// Per-block operands shared by both product paths.
template <typename TT, typename ET>
struct Args {
  const TT* xi;
  const TT* xj;
  const ET* e;
  const ET* we;
  const ET* b;
  const ET* w1g;
  const ET* b1g;
  const ET* w1a;
  const ET* b1a;
  const int* dst;
  const int* src;
  const uint8_t* emask;
  TT* gate;
  TT* sender;
  TT* saved;
  float* s1w;
  float* m2w;
  int d;
  int save_sig;  // saved row: [pre | sig] (1) or pre alone (0)
  int stage_e;   // f32 edges: the e tile is staged in shared memory
};

// phase-1 epilogue of one element: pre = xi[dst] + xj[src] + acc + b,
// h = silu(pre) rounded to ET (returned), optional residual [pre | sig] or
// pre alone
template <typename TT, typename ET>
__device__ __forceinline__ float phase1_element(const Args<TT, ET>& p,
                                                size_t e0, int r, int c,
                                                int dst_r, int src_r,
                                                float acc) {
  const int d2 = 2 * p.d;
  const float pre = __fadd_rn(
      __fadd_rn(__fadd_rn(to_f(p.xi[(size_t)dst_r * d2 + c]),
                          to_f(p.xj[(size_t)src_r * d2 + c])),
                acc),
      to_f(p.b[c]));
  const float sg = 1.f / (1.f + expf(-pre));
  if (p.saved != nullptr) {
    TT* row = p.saved + (e0 + r) * (size_t)(p.save_sig ? 2 * d2 : d2);
    row[c] = from_f<TT>(pre);
    if (p.save_sig) row[d2 + c] = from_f<TT>(sg);
  }
  return round_to<ET>(__fmul_rn(pre, sg));
}

// column-wise masked Welford partials of the TE x CN rounded gate block in
// g_s (row stride ldg; shared or device memory): s1 = sum(m g),
// M2 = sum((m (g - s1/n))^2)
template <typename G>
__device__ __forceinline__ void window_moments(const G* g_s, int ldg,
                                               const float* m_s, float* s1w,
                                               float* m2w, size_t out0) {
  const int tid = threadIdx.x;
  if (tid >= CN) return;
  float n = 0.f, s1 = 0.f;
  for (int r = 0; r < TE; ++r) {
    n = __fadd_rn(n, m_s[r]);
    s1 = __fadd_rn(s1, __fmul_rn(to_f(g_s[r * ldg + tid]), m_s[r]));
  }
  const float mean = s1 / fmaxf(n, 1.f);
  float m2 = 0.f;
  for (int r = 0; r < TE; ++r) {
    const float df =
        __fmul_rn(__fadd_rn(to_f(g_s[r * ldg + tid]), -mean), m_s[r]);
    m2 = __fadd_rn(m2, __fmul_rn(df, df));
  }
  s1w[out0 + tid] = s1;
  m2w[out0 + tid] = m2;
}

// --------------------------------------------------- f32 edges: CUDA cores

constexpr int KC = 16;  // weight rows staged per step
constexpr int TM = 4;   // rows per thread
constexpr int TN = 8;   // columns per thread (16 x 16 threads -> 64 x 128)

// column of this thread's j-th output inside a CN-wide chunk: two groups of
// four adjacent columns, 64 apart, so the float4 reads of a warp are dense
__device__ __forceinline__ int col_of(int tx, int j) {
  return (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

// acc += A[rows of this thread, 0:K] @ W[0:K, c0:c0+CN]; A: f32 rows in
// shared memory (stride lda, 16-byte aligned); W: row-major [K, ldw]
__device__ __forceinline__ void gemm_fma(const float* A, int lda,
                                         const float* __restrict__ W,
                                         int ldw, int K, int c0, float* w_s,
                                         float acc[TM][TN]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < K; k0 += KC) {
    for (int i = tid; i < KC * CN; i += NTHREADS) {
      const int kk = i / CN, cc = i % CN;
      w_s[kk * CN + cc] = W[(size_t)(k0 + kk) * ldw + c0 + cc];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      float4 a4[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a4[i] = *reinterpret_cast<const float4*>(
            &A[(ty * TM + i) * lda + k0 + kk]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(&w_s[(kk + q) * CN + tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(
            &w_s[(kk + q) * CN + 64 + tx * 4]);
        const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = q == 0 ? a4[i].x
                         : q == 1 ? a4[i].y
                         : q == 2 ? a4[i].z
                                  : a4[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
}

// shared memory of the FMA kernel (bytes): [e tile,] h half tile, weight
// chunk, ids and mask
__host__ __device__ inline size_t fma_smem(int d, bool stage_e) {
  return sizeof(float) * ((stage_e ? (size_t)TE * (d + 4) : 0) +
                          (size_t)TE * (d + 4) + KC * CN + 3 * TE);
}

template <typename TT>
__global__ void __launch_bounds__(NTHREADS)
    edge_phase_fwd_fma(Args<TT, float> p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = p.d, d2 = 2 * d, ldh = d + 4;
  const int te = p.stage_e ? TE * (d + 4) : 0;
  float* a_s = smem;              // [TE][d + 4]  e tile (if staged)
  float* h_s = a_s + te;          // [TE][ldh]    h = silu(pre), one half
  float* w_s = h_s + TE * ldh;    // [KC][CN]     weight chunk
  int* dst_s = reinterpret_cast<int*>(w_s + KC * CN);
  int* src_s = dst_s + TE;
  float* m_s = reinterpret_cast<float*>(src_s + TE);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t e0 = (size_t)blockIdx.x * TE;
  // the phase-1 A operand: the staged tile or e's rows in device memory
  const float* A = p.stage_e ? a_s : p.e + e0 * d;
  const int lda = p.stage_e ? d + 4 : d;

  if (tid < TE) {
    dst_s[tid] = p.dst[e0 + tid];
    src_s[tid] = p.src[e0 + tid];
    m_s[tid] = p.emask[e0 + tid] ? 1.f : 0.f;
  }
  if (p.stage_e)
    for (int i = tid; i < TE * d; i += NTHREADS) {
      const int r = i / d, c = i % d;
      a_s[r * lda + c] = p.e[(e0 + r) * d + c];
    }
  __syncthreads();

  for (int half = 0; half < 2; ++half) {
    for (int c0 = 0; c0 < d; c0 += CN) {  // phase 1, this half of pre
      float acc[TM][TN] = {};
      gemm_fma(A, lda, p.we, d2, d, half * d + c0, w_s, acc);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty * TM + i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int c = c0 + col_of(tx, j);
          h_s[r * ldh + c] = phase1_element(p, e0, r, half * d + c, dst_s[r],
                                            src_s[r], acc[i][j]);
        }
      }
    }
    __syncthreads();

    const float* w1 = half ? p.w1a : p.w1g;  // phase 2, this half's product
    const float* b1 = half ? p.b1a : p.b1g;
    TT* out = half ? p.sender : p.gate;
    const bool mom = half == 0 && p.s1w != nullptr;
    for (int c0 = 0; c0 < d; c0 += CN) {
      float acc[TM][TN] = {};
      gemm_fma(h_s, ldh, w1, d, d, c0, w_s, acc);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty * TM + i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int cl = col_of(tx, j);
          out[(e0 + r) * d + c0 + cl] =
              from_f<TT>(__fadd_rn(acc[i][j], b1[c0 + cl]));
        }
      }
      if (mom) {  // from the rounded gate this block just wrote
        __syncthreads();
        window_moments(out + e0 * d + c0, d, m_s, p.s1w, p.m2w,
                       (size_t)blockIdx.x * d + c0);
      }
    }
    __syncthreads();  // h_s is rewritten by the next half
  }
}

// --------------------------------------------- bf16 edges: wgmma + TMA

constexpr int TC_THREADS = 288;  // two consumer warpgroups + a producer warp
constexpr int TC_MAX_STAGES = 16;
constexpr int RED_BYTES = 8192;  // moments: [2 wg][2 passes][2 buffers][4][64]

// shared-memory plan of the wgmma kernel (bytes from the 1024-aligned base;
// total includes the 1024 bytes of alignment slack): the e tile and the h
// half tile (d/64 swizzled slabs each), the moments' partial sums, the
// tile's dst / src / mask and mask count, then the weight ring (as many
// 8 KB slabs as fit, up to 16) and its barriers
struct TcLayout {
  int stages;
  size_t e, h, red, ids, ring, bars, total;
  __host__ __device__ explicit TcLayout(int d) {
    e = 0;
    h = e + (size_t)d * 128;
    red = h + (size_t)d * 128;
    ids = red + RED_BYTES;
    ring = (ids + 4 * 3 * TE + 16 + 1023) / 1024 * 1024;
    const long long s = ((long long)SMEM_LIMIT - 1024 - (long long)ring -
                         16 * TC_MAX_STAGES - 16) / SLAB;
    stages = (int)(s < TC_MAX_STAGES ? (s < 0 ? 0 : s) : TC_MAX_STAGES);
    bars = ring + (size_t)stages * SLAB;  // full[S], empty[S], e_full/empty
    total = 1024 + bars + 16 * (size_t)stages + 16;
  }
};

// sigmoid for the bf16-edge epilogue: the hardware exp2 and reciprocal
// (__expf, __fdividef: a few ulp of f32); the product with pre is rounded
// to bf16 before any use, the saved sig to the table dtype. For
// pre < -87, 1 + exp(-pre) is inf and the quotient 0, sigmoid's limit.
__device__ __forceinline__ float fast_sigmoid(float x) {
  return __fdividef(1.f, __fadd_rn(1.f, __expf(-x)));
}

template <typename T> struct Pair;
template <> struct Pair<float> {
  using type = float2;
  static __device__ __forceinline__ float2 f(float2 v) { return v; }
  static __device__ __forceinline__ float2 make(float x, float y) {
    return make_float2(x, y);
  }
};
template <> struct Pair<bf16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float2 f(__nv_bfloat162 v) {
    return __bfloat1622float2(v);
  }
  static __device__ __forceinline__ __nv_bfloat162 make(float x, float y) {
    return __floats2bfloat162_rn(x, y);
  }
};

// the gathered node-table pairs of one pre chunk at a thread's accumulator
// elements, and the bias pairs, loaded before the chunk's products so that
// the loads overlap them: [2 i + hr] is row r_lo + 8 hr, columns
// pc0 + 8 i + 2 t4 + {0, 1}; b[i] the bias at those columns
template <typename TT>
struct Gathered {
  typename Pair<TT>::type xi[16], xj[16];
  __nv_bfloat162 b[8];
};

template <typename TT>
__device__ __forceinline__ void tc_gather(const Args<TT, bf16>& p,
                                          const int* dst_s, const int* src_s,
                                          int pc0, int r_lo, int t4,
                                          Gathered<TT>& g) {
  using P2 = typename Pair<TT>::type;
  const size_t d2 = 2 * (size_t)p.d;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const P2* xi = reinterpret_cast<const P2*>(
        p.xi + (size_t)dst_s[r_lo + 8 * hr] * d2 + pc0 + 2 * t4);
    const P2* xj = reinterpret_cast<const P2*>(
        p.xj + (size_t)src_s[r_lo + 8 * hr] * d2 + pc0 + 2 * t4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      g.xi[2 * i + hr] = xi[4 * i];
      g.xj[2 * i + hr] = xj[4 * i];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    g.b[i] = *reinterpret_cast<const __nv_bfloat162*>(p.b + pc0 + 8 * i +
                                                       2 * t4);
}

// phase-1 epilogue of one pre chunk (64 columns from pc0 = half d + c0):
// pre = xi[dst] + xj[src] + acc + b, h = silu(pre) rounded to bf16 into the
// swizzled h tile (column c0 + ...), and the optional residual
template <typename TT>
__device__ __forceinline__ void tc_phase1_epilogue(
    const Args<TT, bf16>& p, const float (&acc)[32], const Gathered<TT>& g,
    size_t e0, int pc0, int c0, int r_lo, int t4, unsigned char* h_g) {
  using PT = Pair<TT>;
  const int d2 = 2 * p.d;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int pc = pc0 + 8 * i + 2 * t4;
    const float2 b = __bfloat1622float2(g.b[i]);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r_lo + 8 * hr;
      const float2 xi = PT::f(g.xi[2 * i + hr]), xj = PT::f(g.xj[2 * i + hr]);
      const float pre0 = __fadd_rn(
          __fadd_rn(__fadd_rn(xi.x, xj.x), acc[4 * i + 2 * hr]), b.x);
      const float pre1 = __fadd_rn(
          __fadd_rn(__fadd_rn(xi.y, xj.y), acc[4 * i + 2 * hr + 1]), b.y);
      const float sg0 = fast_sigmoid(pre0), sg1 = fast_sigmoid(pre1);
      *reinterpret_cast<__nv_bfloat162*>(h_g + sw_off(r, c0 + 8 * i +
                                                         2 * t4)) =
          __floats2bfloat162_rn(__fmul_rn(pre0, sg0), __fmul_rn(pre1, sg1));
      if (p.saved != nullptr) {
        TT* row = p.saved + (e0 + r) * (size_t)(p.save_sig ? 2 * d2 : d2);
        *reinterpret_cast<typename PT::type*>(row + pc) = PT::make(pre0, pre1);
        if (p.save_sig)
          *reinterpret_cast<typename PT::type*>(row + d2 + pc) =
              PT::make(sg0, sg1);
      }
    }
  }
}

// phase-2 epilogue of one output chunk (64 columns from c0): out = acc +
// b1, rounded to the table dtype; on the gate half with moments, the masked
// Welford partials of the rounded gate over the tile's 64 rows: per column,
// each thread's two rows, a shuffle tree over the warp's 16 rows, then the
// warpgroup's 4 warps in order (red: this warpgroup's [2][4][64] buffer,
// alternating between two from one chunk to the next so that one barrier
// per pass orders its writes and reads)
template <typename TT>
__device__ __forceinline__ void tc_phase2_epilogue(
    const Args<TT, bf16>& p, const float (&acc)[32], int half, size_t e0,
    int tile, int c0, int r_lo, int t4, int wi, const float* m_s, float n_w,
    float* red, int wg) {
  using PT = Pair<TT>;
  const int d = p.d, wt = threadIdx.x & 127;
  const bf16* b1 = half ? p.b1a : p.b1g;
  TT* out = half ? p.sender : p.gate;
  float g[32];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + 8 * i + 2 * t4;
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(b1 + c));
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const typename PT::type o =
          PT::make(__fadd_rn(acc[4 * i + 2 * hr], b.x),
                   __fadd_rn(acc[4 * i + 2 * hr + 1], b.y));
      *reinterpret_cast<typename PT::type*>(
          out + (e0 + r_lo + 8 * hr) * (size_t)d + c) = o;
      const float2 of = PT::f(o);
      g[4 * i + 2 * hr] = of.x;
      g[4 * i + 2 * hr + 1] = of.y;
    }
  }
  if (half != 0 || p.s1w == nullptr) return;
  const float m_lo = m_s[r_lo], m_hi = m_s[r_lo + 8];
  const auto warp_sum = [](float v) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 8));
    return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 16));
  };
  float* red1 = red;        // [4][64] s1 partials
  float* red2 = red + 256;  // [4][64] M2 partials
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 16; ++k) {  // column 8 (k / 2) + 2 t4 + k % 2
    const float s = warp_sum(__fadd_rn(__fmul_rn(g[(k / 2) * 4 + (k & 1)],
                                                 m_lo),
                                       __fmul_rn(g[(k / 2) * 4 + 2 + (k & 1)],
                                                 m_hi)));
    if (lane < 4) red1[wi * 64 + 8 * (k / 2) + 2 * t4 + (k & 1)] = s;
  }
  bar_sync(2 + wg, 128);
  const float nd = fmaxf(n_w, 1.f);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int c = 8 * (k / 2) + 2 * t4 + (k & 1);
    float s1 = red1[c];
#pragma unroll
    for (int w = 1; w < 4; ++w) s1 = __fadd_rn(s1, red1[w * 64 + c]);
    const float mean = s1 / nd;
    const float dlo = __fmul_rn(__fadd_rn(g[(k / 2) * 4 + (k & 1)], -mean),
                                m_lo);
    const float dhi = __fmul_rn(
        __fadd_rn(g[(k / 2) * 4 + 2 + (k & 1)], -mean), m_hi);
    const float s = warp_sum(__fadd_rn(__fmul_rn(dlo, dlo),
                                       __fmul_rn(dhi, dhi)));
    if (lane < 4) red2[wi * 64 + c] = s;
  }
  bar_sync(2 + wg, 128);
  if (wt < 64) {
    float s1 = red1[wt], m2 = red2[wt];
#pragma unroll
    for (int w = 1; w < 4; ++w) {
      s1 = __fadd_rn(s1, red1[w * 64 + wt]);
      m2 = __fadd_rn(m2, red2[w * 64 + wt]);
    }
    p.s1w[(size_t)tile * d + c0 + wt] = s1;
    p.m2w[(size_t)tile * d + c0 + wt] = m2;
  }
}

template <typename TT>
__global__ void __launch_bounds__(TC_THREADS, 1)
    edge_phase_fwd_tc(Args<TT, bf16> p, int n_tiles,
                      const __grid_constant__ CUtensorMap e_m,
                      const __grid_constant__ CUtensorMap we_m,
                      const __grid_constant__ CUtensorMap w1g_m,
                      const __grid_constant__ CUtensorMap w1a_m) {
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const int d = p.d, KS = d / 64, NP = d / 128;
  const TcLayout L(d);
  const uint32_t raw = saddr(smem_tc);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_tc + (base - raw);
  const Ring ring{base + (uint32_t)L.ring, base + (uint32_t)L.bars,
                  base + (uint32_t)L.bars + 8u * L.stages, L.stages};
  const uint32_t e_full = base + (uint32_t)L.bars + 16u * L.stages;
  const uint32_t e_empty = e_full + 8;
  const int tid = threadIdx.x, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, 4);  // the 4 warps of one warpgroup
    }
    mbar_init(e_full, 1);
    mbar_init(e_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer: the e tile, then the slabs in use order
    if ((tid & 31) == 0) {
      uint32_t n = 0, it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
        if (it > 0) mbar_wait(e_empty, (it - 1) & 1);
        mbar_expect_tx(e_full, d * 128);
        for (int j = 0; j < KS; ++j)
          tma_load(base + (uint32_t)L.e + j * SLAB, &e_m, e_full, j * 64,
                   t * TE);
        for (int half = 0; half < 2; ++half) {
          for (int jp = 0; jp < NP; ++jp)  // We's half: [d, 2d] from col h d
            for (int ks = 0; ks < KS; ++ks)
              for (int w = 0; w < 2; ++w, ++n)
                tma_load(ring.acquire(n, SLAB, SLAB), &we_m,
                         ring.full + 8 * ring.stage(n),
                         half * d + (2 * jp + w) * 64, ks * 64);
          for (int jp = 0; jp < NP; ++jp)  // W1g / W1a [d, d]
            for (int ks = 0; ks < KS; ++ks)
              for (int w = 0; w < 2; ++w, ++n)
                tma_load(ring.acquire(n, SLAB, SLAB), half ? &w1a_m : &w1g_m,
                         ring.full + 8 * ring.stage(n), (2 * jp + w) * 64,
                         ks * 64);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns the 64-column chunks 2 jp + wg
  const int wg = warp >> 2, wt = tid & 127, wi = wt >> 5, lane = wt & 31;
  const int r_lo = wi * 16 + (lane >> 2), t4 = lane & 3;
  const uint32_t e_a = base + (uint32_t)L.e, h_a = base + (uint32_t)L.h;
  unsigned char* h_g = gbase + L.h;
  float* red = reinterpret_cast<float*>(gbase + L.red) + 1024 * wg;
  int* dst_s = reinterpret_cast<int*>(gbase + L.ids);
  int* src_s = dst_s + TE;
  float* m_s = reinterpret_cast<float*>(src_s + TE);
  int* cnt_s = reinterpret_cast<int*>(m_s + TE);
  uint32_t pos = 0, it = 0, ep = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const size_t e0 = (size_t)t * TE;
    bar_sync(1, 256);  // the previous tile is done with ids and the h tile
    if (tid < TE) {
      const bool m = p.emask[e0 + tid] != 0;
      dst_s[tid] = p.dst[e0 + tid];
      src_s[tid] = p.src[e0 + tid];
      m_s[tid] = m ? 1.f : 0.f;
      const unsigned ballot = __ballot_sync(0xffffffffu, m);
      if (lane == 0) cnt_s[warp] = __popc(ballot);
    }
    bar_sync(1, 256);
    const float n_w = (float)(cnt_s[0] + cnt_s[1]);
    mbar_wait(e_full, it & 1);
    for (int half = 0; half < 2; ++half) {
      for (int jp = 0; jp < NP; ++jp) {  // phase 1: this half of pre
        const int c0 = (2 * jp + wg) * 64, pc0 = half * d + c0;
        Gathered<TT> g;
        tc_gather(p, dst_s, src_s, pc0, r_lo, t4, g);
        float acc[32];
        tc_chunk<1>(acc, e_a, KS, ring, pos, wg);
        tc_phase1_epilogue(p, acc, g, e0, pc0, c0, r_lo, t4, h_g);
      }
      if (half == 1 && lane == 0) mbar_arrive(e_empty);  // e is read
      fence_async_smem();
      bar_sync(1, 256);  // the h half tile is in place
      for (int jp = 0; jp < NP; ++jp) {  // phase 2: gate / sender
        const int c0 = (2 * jp + wg) * 64;
        float acc[32];
        tc_chunk<1>(acc, h_a, KS, ring, pos, wg);
        tc_phase2_epilogue(p, acc, half, e0, t, c0, r_lo, t4, wi, m_s, n_w,
                           red + 512 * (ep & 1), wg);
        ep += half == 0;
      }
      bar_sync(1, 256);  // the h tile is read before the next half writes it
    }
  }
}

template <typename TT, typename ET>
cudaError_t launch(const Args<TT, ET>& p, int E, cudaStream_t stream) {
  const int d = p.d;
  if constexpr (sizeof(ET) == 2) {
    CUtensorMap e_m, we_m, w1g_m, w1a_m;
    if (!make_map(&e_m, p.e, d, E) || !make_map(&we_m, p.we, 2 * d, d) ||
        !make_map(&w1g_m, p.w1g, d, d) || !make_map(&w1a_m, p.w1a, d, d))
      return cudaErrorInvalidValue;
    const TcLayout L(d);
    if (L.stages < 2 || L.total > SMEM_LIMIT)
      return cudaErrorInvalidConfiguration;
    cudaError_t err = cudaFuncSetAttribute(
        edge_phase_fwd_tc<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L.total);
    if (err != cudaSuccess) return err;
    const int n_tiles = E / TE, nsm = num_sms();
    edge_phase_fwd_tc<TT><<<n_tiles < nsm ? n_tiles : nsm, TC_THREADS,
                            L.total, stream>>>(p, n_tiles, e_m, we_m, w1g_m,
                                               w1a_m);
  } else {
    const size_t smem = fma_smem(d, p.stage_e != 0);
    cudaError_t err = cudaFuncSetAttribute(
        edge_phase_fwd_fma<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    edge_phase_fwd_fma<TT><<<E / TE, NTHREADS, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// dynamic shared memory (bytes) of the kernel's block: the wgmma kernel's
// (bf16 edges) or the FMA kernel's, for the wrapper's plan check
extern "C" long long edge_phase_fwd_smem(int d, int edge_bf16) {
  if (edge_bf16) return (long long)TcLayout(d).total;
  const size_t full = fma_smem(d, true);
  return (long long)(full <= SMEM_LIMIT ? full : fma_smem(d, false));
}

namespace {

template <typename TT, typename ET>
cudaError_t run(const void* xi, const void* xj, const void* e, const void* we,
                const void* b, const void* w1g, const void* b1g,
                const void* w1a, const void* b1a, const void* dst,
                const void* src, const void* emask, void* gate, void* sender,
                void* saved, void* s1w, void* m2w, int E, int d,
                int save_sig, cudaStream_t stream) {
  const int stage_e = fma_smem(d, true) <= (size_t)SMEM_LIMIT;
  const Args<TT, ET> p{(const TT*)xi,  (const TT*)xj,  (const ET*)e,
                       (const ET*)we,  (const ET*)b,   (const ET*)w1g,
                       (const ET*)b1g, (const ET*)w1a, (const ET*)b1a,
                       (const int*)dst, (const int*)src,
                       (const uint8_t*)emask, (TT*)gate, (TT*)sender,
                       (TT*)saved, (float*)s1w, (float*)m2w, d, save_sig,
                       stage_e};
  return launch(p, E, stream);
}

}  // namespace

// C entry point (bound with ctypes). E % 64 == 0, d % 128 == 0, d <= 512;
// e and the weights 16-byte aligned (TMA); xi/xj 8-byte aligned, since
// the wgmma kernel reads them as pairs of elements (float2 at most). The
// wrapper checks both.
// table_bf16 / edge_bf16 select bf16 (1) or f32 (0) node tables / edge
// activations and weights; save_sig selects the saved residual's layout
// ([pre | sig] [E, 4d] or pre [E, 2d]). Returns cudaGetLastError() after the
// launch.
extern "C" int edge_phase_fwd(const void* xi, const void* xj, const void* e,
                              const void* we, const void* b, const void* w1g,
                              const void* b1g, const void* w1a,
                              const void* b1a, const void* dst,
                              const void* src, const void* emask, void* gate,
                              void* sender, void* saved, void* s1w, void* m2w,
                              int E, int d, int table_bf16, int edge_bf16,
                              int save_sig, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (table_bf16 && edge_bf16)
    return run<bf16, bf16>(xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src,
                           emask, gate, sender, saved, s1w, m2w, E, d,
                           save_sig, s);
  if (edge_bf16)
    return run<float, bf16>(xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src,
                            emask, gate, sender, saved, s1w, m2w, E, d,
                            save_sig, s);
  if (table_bf16)
    return run<bf16, float>(xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src,
                            emask, gate, sender, saved, s1w, m2w, E, d,
                            save_sig, s);
  return run<float, float>(xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src,
                           emask, gate, sender, saved, s1w, m2w, E, d,
                           save_sig, s);
}
