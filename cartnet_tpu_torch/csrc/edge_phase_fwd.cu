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
// of an NVIDIA H100 SXM at its 700 W limit; f32 edges run on the CUDA
// cores' FMA rate (67 TFLOP/s: 0.164 ms). Every sum in a fixed order, so
// results repeat bitwise; the elementwise steps use explicitly rounded
// adds/multiplies so nothing is contracted into an FMA that the plain
// PyTorch version does not have. d % 128 == 0 and d <= 512 (the wrapper
// zero-pads other widths).
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
// f32 edges (the all-f32 configuration; full f32, no TF32), two launches of
// the 64 x 128 SIMT GEMM tiles of simt_gemm.cuh (128 threads, 8 x 8 register
// micro-tiles, double-buffered k-slabs), four blocks an SM, bounded by the
// batch's live edge count (below):
//  (1) pre tiles, 2 (E / 64) (d / 128) blocks: e @ We over K = d with the
//      gather + silu epilogue; h = pre sig goes to device memory in f32
//      ([E, 2d] scratch, 43 MB at d = 256), the saved residual beside it;
//  (2) output tiles, as many blocks: h_g @ W1g and h_a @ W1a from that
//      scratch, the bias epilogue, and on each gate tile (one 64-edge
//      window) the masked Welford partials in two fixed-order column sums.
// A block owns one output tile, so each pass spreads its E / 64 windows
// over 2 d / 128 blocks and fills the SMs' block slots evenly (one block
// per 64-edge tile, doing both phases in turn, left 328 blocks of serial
// work in the slots at E = 20992). The round trip of h through device
// memory (twice 43 MB, mostly in L2) buys that parallelism.
//
// The live edge count (f32 edges only): ``live`` points at the batch's live
// counts on the device (int32; K5/K6 take the same two), whose first is one
// past the last masked-in edge (rounded up to the 64-edge tile here as
// well). Every block reads it, so the grids stay static and a CUDA graph
// replays any batch of its shape. Every edge at or past the count is a
// masked-out pad (the batch's tail), so a tile that starts there
// spends no arithmetic: its pre block leaves at once (its rows of h and of
// the saved residual stay unwritten: the backward's passes skip the same
// tiles and read neither), and its output block writes zeros to gate and
// sender (which K2 reads at every edge) and, on the window's gate tile,
// zero moments. The live tiles' rows are bitwise what a call without the
// count writes. A null ``live`` is every edge; the bf16-edge kernel
// computes every tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

// TMA, mbarriers, wgmma descriptors and products, the TMA ring, the tensor
// maps (shared with K5/K6 and K8)
#include "hopper_common.cuh"
// the f32 SIMT GEMM tile (shared with K5/K6's, K7's and K8's f32 passes)
#include "simt_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TE = 64;  // edges per tile (the moments' window)
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
  const int* live;  // the live edge counts on the device, or null (all)
  int d;
  int save_sig;  // saved row: [pre | sig] (1) or pre alone (0)
};

// whether the 64-edge tile ``tile`` lies past the live edge count (the
// count rounded up to the tile: the tile that holds the last live edge is
// live). The f32 passes test it first thing, on the tile index alone, and
// leave through PTX's exit (all the block's threads at once, before any
// barrier), which nvcc does not take for a return: so ptxas allocates the
// live tiles' registers as without the test (128 a thread at four blocks
// an SM). A test on the tile's first edge after the tile's offsets, with
// a return, spilled 68 bytes in the pre tile and cost both passes 5-13%
// at every tile live, on an H100.
__device__ __forceinline__ bool dead_tile(const int* live, int tile) {
  return live != nullptr && tile >= (*live + TE - 1) / TE;
}
__device__ __forceinline__ void exit_block() { asm volatile("exit;"); }

// --------------------------------------------------- f32 edges: CUDA cores

constexpr int F32_BLOCKS = 4;  // blocks an SM the f32 passes are compiled for
static_assert(simt::BM == TE, "an f32 tile is one moment window");

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

// four adjacent elements of T at p (8-byte aligned for float, 4 for bf16)
// as f32, and stored from f32 (rounded to T)
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
  using P = Pair<T>;
  const float2 lo = P::f(reinterpret_cast<const typename P::type*>(p)[0]);
  const float2 hi = P::f(reinterpret_cast<const typename P::type*>(p)[1]);
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}
template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]) {
  using P = Pair<T>;
  reinterpret_cast<typename P::type*>(p)[0] = P::make(v[0], v[1]);
  reinterpret_cast<typename P::type*>(p)[1] = P::make(v[2], v[3]);
}

// Pass 1, pre tile: 64 edges x 128 columns of pre [E, 2d] over K = d (A =
// e rows, B = We's columns; simt_gemm.cuh). Epilogue per element: pre =
// xi[dst] + xj[src] + acc + b, sig = 1 / (1 + exp(-pre)) in IEEE f32,
// h = pre sig -> hw [E, 2d] f32 (device memory, for pass 2), and the
// optional residual [pre | sig] or pre alone in the table dtype.
template <typename TT>
__global__ void __launch_bounds__(simt::THREADS, F32_BLOCKS)
    edge_fwd_pre_f32(const __grid_constant__ Args<TT, float> p,
                     float* __restrict__ hw) {
  extern __shared__ float4 smem_f32[];
  float* smem = reinterpret_cast<float*>(smem_f32);
  const int d = p.d, d2 = 2 * d, nct = d2 / simt::BN;
  // pads only: nothing reads its rows
  if (dead_tile(p.live, (int)(blockIdx.x / nct))) exit_block();
  const size_t e0 = (size_t)(blockIdx.x / nct) * simt::BM;
  const int c0 = (blockIdx.x % nct) * simt::BN;
  float acc[8][8];
  simt::zero(acc);
  simt::RowsT<simt::BM> fa{p.e + e0 * d, (size_t)d, 0};
  simt::ColsD<simt::BN> fb{p.we + c0, (size_t)d2, 0};
  simt::mainloop(acc, d / simt::BK, fa, fb, smem);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t e = e0 + simt::row_of(i);
    const TT* xi = p.xi + (size_t)p.dst[e] * d2;
    const TT* xj = p.xj + (size_t)p.src[e] * d2;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = c0 + simt::col_of(4 * hh);  // 4 columns from c
      float vi[4], vj[4], pre[4], sg[4], h[4];
      load4(xi + c, vi);
      load4(xj + c, vj);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        pre[q] = __fadd_rn(__fadd_rn(__fadd_rn(vi[q], vj[q]),
                                     acc[i][4 * hh + q]),
                           p.b[c + q]);
        sg[q] = 1.f / (1.f + expf(-pre[q]));
        h[q] = __fmul_rn(pre[q], sg[q]);
      }
      *reinterpret_cast<float4*>(hw + e * d2 + c) =
          make_float4(h[0], h[1], h[2], h[3]);
      if (p.saved != nullptr) {
        TT* row = p.saved + e * (size_t)(p.save_sig ? 2 * d2 : d2);
        store4(row + c, pre);
        if (p.save_sig) store4(row + d2 + c, sg);
      }
    }
  }
}

// The zeros of an output tile past the live count: its 64 rows x 128
// columns of gate or sender (K2 reads them at every edge) and, on a gate
// tile, its window's moments (no edge of it is masked in).
template <typename TT>
__device__ __forceinline__ void zero_out_tile(const Args<TT, float>& p,
                                              int tile) {
  const int d = p.d, nct = d / simt::BN;
  const int half = (blockIdx.x / nct) % 2, c0 = (blockIdx.x % nct) * simt::BN;
  const size_t e0 = (size_t)tile * simt::BM;
  TT* out = half ? p.sender : p.gate;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      store4(out + (e0 + simt::row_of(i)) * d + c0 + simt::col_of(4 * hh),
             zero);
  if (half == 0 && p.s1w != nullptr) {  // THREADS == BN: one a column
    p.s1w[(size_t)tile * d + c0 + threadIdx.x] = 0.f;
    p.m2w[(size_t)tile * d + c0 + threadIdx.x] = 0.f;
  }
}

// Pass 2, output tile: 64 edges x 128 columns of gate (half 0: h_g @ W1g)
// or sender (half 1: h_a @ W1a) over K = d (A = hw's half, B = W1's
// columns); out = acc + b1 rounded to the table dtype. A gate tile with
// moments is one 64-edge window: the masked Welford partials of the
// rounded gate over its 64 rows, each a fixed-order column sum
// (simt::column_sums): s1 = sum m g, then M2 = sum (m (g - s1 / n))^2.
// A tile past the live count skips the product and stores zeros
// (zero_out_tile).
template <typename TT>
__global__ void __launch_bounds__(simt::THREADS, F32_BLOCKS)
    edge_fwd_out_f32(const __grid_constant__ Args<TT, float> p,
                     const float* __restrict__ hw) {
  extern __shared__ float4 smem_f32[];
  float* smem = reinterpret_cast<float*>(smem_f32);
  {  // the test first, on the tile index alone (dead_tile)
    const int tile = blockIdx.x / (2 * (p.d / simt::BN));
    if (dead_tile(p.live, tile)) {
      zero_out_tile(p, tile);
      exit_block();
    }
  }
  const int d = p.d, nct = d / simt::BN;
  const int ct = blockIdx.x % nct, half = (blockIdx.x / nct) % 2;
  const int tile = blockIdx.x / (2 * nct), c0 = ct * simt::BN;
  const size_t e0 = (size_t)tile * simt::BM;
  const float* b1 = half ? p.b1a : p.b1g;
  TT* out = half ? p.sender : p.gate;
  float acc[8][8];
  simt::zero(acc);
  simt::RowsT<simt::BM> fa{hw + e0 * 2 * d + half * d, 2 * (size_t)d, 0};
  simt::ColsD<simt::BN> fb{(half ? p.w1a : p.w1g) + c0, (size_t)d, 0};
  simt::mainloop(acc, d / simt::BK, fa, fb, smem);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t e = e0 + simt::row_of(i);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = c0 + simt::col_of(4 * hh);
      float o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)  // the stored value, as f32
        o[q] = acc[i][4 * hh + q] =
            round_to<TT>(__fadd_rn(acc[i][4 * hh + q], b1[c + q]));
      store4(out + e * d + c, o);
    }
  }
  if (half != 0 || p.s1w == nullptr) return;
  float* red = smem;                     // [8][BN] column partials
  float* mean_s = smem + 8 * simt::BN;  // [BN]
  const float n = (float)__syncthreads_count(
      threadIdx.x < simt::BM && p.emask[e0 + threadIdx.x] != 0);
  float m[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = p.emask[e0 + simt::row_of(i)] ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = __fmul_rn(acc[i][j], m[i]);
  }
  const size_t w0 = (size_t)tile * d + c0;
  simt::column_sums(acc, red, [&](int c, float s) {
    p.s1w[w0 + c] = s;
    mean_s[c] = s / fmaxf(n, 1.f);
  });
  __syncthreads();  // mean_s written, red read
  // m in {0, 1}: (g m - mean) m is (g - mean) m
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float df =
          __fmul_rn(__fadd_rn(acc[i][j], -mean_s[simt::col_of(j)]), m[i]);
      acc[i][j] = __fmul_rn(df, df);
    }
  simt::column_sums(acc, red, [&](int c, float s) { p.m2w[w0 + c] = s; });
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

template <typename TT>
cudaError_t launch_tc(const Args<TT, bf16>& p, int E, cudaStream_t stream) {
  const int d = p.d;
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
  return cudaGetLastError();
}

// one f32 pass: blocks of simt::THREADS threads and simt::SMEM bytes
template <typename K, typename... A>
cudaError_t launch(K kern, int blocks, cudaStream_t s, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)simt::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<blocks, simt::THREADS, simt::SMEM, s>>>(args...);
  return cudaGetLastError();
}

// f32 edges: pass 1 (pre tiles, h to hw), then pass 2 (gate and sender
// tiles from hw); 2 (E / 64) (d / 128) blocks each
template <typename TT>
cudaError_t launch_f32(const Args<TT, float>& p, float* hw, int E,
                       cudaStream_t s) {
  const int blocks = E / simt::BM * 2 * (p.d / simt::BN);
  cudaError_t err = launch(edge_fwd_pre_f32<TT>, blocks, s, p, hw);
  if (err != cudaSuccess) return err;
  return launch(edge_fwd_out_f32<TT>, blocks, s, p, (const float*)hw);
}

}  // namespace

// dynamic shared memory (bytes) of the kernel's block: the wgmma kernel's
// (bf16 edges) or the SIMT tile's of both f32 passes, for the wrapper's
// plan check
extern "C" long long edge_phase_fwd_smem(int d, int edge_bf16) {
  return (long long)(edge_bf16 ? TcLayout(d).total : simt::SMEM);
}

// floats of scratch the call needs in ``work``: h [E, 2d] f32 between the
// two f32 passes (none for bf16 edges)
extern "C" long long edge_phase_fwd_workspace(int E, int d, int edge_bf16) {
  return edge_bf16 ? 0 : 2LL * E * d;
}

namespace {

template <typename TT, typename ET>
cudaError_t run(const void* xi, const void* xj, const void* e, const void* we,
                const void* b, const void* w1g, const void* b1g,
                const void* w1a, const void* b1a, const void* dst,
                const void* src, const void* emask, void* gate, void* sender,
                void* saved, void* s1w, void* m2w, void* work,
                const void* live, int E, int d, int save_sig,
                cudaStream_t stream) {
  // the bf16-edge kernel computes every tile: no count
  const Args<TT, ET> p{(const TT*)xi,  (const TT*)xj,  (const ET*)e,
                       (const ET*)we,  (const ET*)b,   (const ET*)w1g,
                       (const ET*)b1g, (const ET*)w1a, (const ET*)b1a,
                       (const int*)dst, (const int*)src,
                       (const uint8_t*)emask, (TT*)gate, (TT*)sender,
                       (TT*)saved, (float*)s1w, (float*)m2w,
                       sizeof(ET) == 2 ? nullptr : (const int*)live, d,
                       save_sig};
  if constexpr (sizeof(ET) == 2)
    return launch_tc(p, E, stream);
  else
    return launch_f32(p, (float*)work, E, stream);
}

}  // namespace

// C entry point (bound with ctypes). E % 64 == 0, d % 128 == 0, d <= 512;
// e and the weights 16-byte aligned (TMA and the f32 tiles' float4 loads);
// xi/xj 8-byte aligned, since both paths read them as pairs of elements
// (float2 at most). The wrapper checks both.
// table_bf16 / edge_bf16 select bf16 (1) or f32 (0) node tables / edge
// activations and weights; save_sig selects the saved residual's layout
// ([pre | sig] [E, 4d] or pre [E, 2d]); work: edge_phase_fwd_workspace
// floats; live: the live edge counts (int32 on the device, the first read
// here; null: every edge), which the f32-edge passes read and the
// bf16-edge kernel ignores.
// One launch for bf16 edges, two for f32 edges. Returns cudaGetLastError()
// after the launches.
extern "C" int edge_phase_fwd(const void* xi, const void* xj, const void* e,
                              const void* we, const void* b, const void* w1g,
                              const void* b1g, const void* w1a,
                              const void* b1a, const void* dst,
                              const void* src, const void* emask, void* gate,
                              void* sender, void* saved, void* s1w, void* m2w,
                              void* work, const void* live, int E, int d,
                              int table_bf16, int edge_bf16, int save_sig,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (table_bf16 && edge_bf16)
    return run<bf16, bf16>(xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src,
                           emask, gate, sender, saved, s1w, m2w, work, live,
                           E, d, save_sig, s);
  if (edge_bf16)
    return run<float, bf16>(xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src,
                            emask, gate, sender, saved, s1w, m2w, work, live,
                            E, d, save_sig, s);
  if (table_bf16)
    return run<bf16, float>(xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src,
                            emask, gate, sender, saved, s1w, m2w, work, live,
                            E, d, save_sig, s);
  return run<float, float>(xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src,
                           emask, gate, sender, saved, s1w, m2w, work, live,
                           E, d, save_sig, s);
}
