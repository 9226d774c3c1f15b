// CartNet edge phase, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cartnet_tpu/ops/pallas/edge_kernels.py:
// edge_phase_bwd_call -> _bwd_kernel (driven by _ep_bwd). The forward
// (edge_phase_fwd.cu) computed, per edge, pre = xi[dst] + xj[src] + e@We + b,
// h = silu(pre), gate = h_g@W1g + b1g, sender = h_a@W1a + b1a, saved the
// rounded [pre | sigmoid(pre)] and per-64-edge-window moments s1_w/M2_w of
// the rounded gate. With cdt the edge dtype (= the node-table dtype in
// training) and f32 arithmetic, this kernel computes
//   dg     = (dgate + m * (ds1_w + 2 dM2_w (gate - mean_w))) -> cdt
//   ds     = dsender -> cdt
//   h      = pre * sig -> cdt                 (from the saved, rounded pair)
//   dh     = [dg @ W1g^T | ds @ W1a^T]        (f32)
//   dpre   = dh * (sig + h32 (1 - sig))       (f32);  dpre_c = dpre -> cdt
//   de     = (deres + dpre_c @ We^T) -> e's dtype
//   dWe    = e^T dpre_c,  dW1g = h_g^T dg,  dW1a = h_a^T ds      (f32)
//   db     = sum_e dpre,  db1g = sum_e dg,  db1a = sum_e ds      (f32)
//   dxi[n] = sum of dpre_c over the masked-in edges with dst = n  (f32)
//   dxj[n] = sum of dpre_c over the masked-in edges with src = n  (f32)
// The weight and bias sums run over every edge (pads carry zero cotangents
// in the model); pads are left out of the node sums, as the Pallas kernel
// leaves out-of-band pads out.
//
// The second entry point, edge_phase_merged_bwd, is the merged sigma + edge
// backward: it replaces cartnet_tpu/ops/pallas/edge_kernels.py:
// _merged_bwd_call -> _bwd_merged_kernel (driven by _fes_bwd, the backward of
// fused_edge_sigma under CARTNET_MERGED=1). The forward saved the rounded pre
// alone [E, 2d], and the sigma chain sig = sigmoid(gate scale + shift) env
// fed e_out = e + sig and aggr = segsum_dst(sig sender). The tile pass then
// opens with the sigma backward in place of reading dgate/dsender:
//   dvals  = daggr[dst] on masked-in edges, 0 on pads                (f32)
//   sig0   = sigmoid(gate scale + shift)
//   da     = (deout + dvals sender) env sig0 (1 - sig0)
//   ds     = dvals sig0 env -> cdt          (written for the weight pass)
//   dg     = (da scale + m (ds1_w + 2 dM2_w (gate - mean_w))) -> cdt
// so dg is rounded once, after the BN fold (K4 + K5 round it twice); sig is
// recomputed from pre in f32; deout takes deres's place. dscale/dshift, the
// BN backward's global sums, come in folded into ds1_w/dM2_w (computed
// outside, as the Pallas op does). Both entry points share every pass
// through the MERGED template flag.
//
// What bounds it: 8 E d^2 multiply-adds (22 GFLOP at E = 20992, d = 256)
// against ~82-114 MB of unavoidable bf16 traffic, so at the tensor-core rate
// memory bounds it (25-34 us on an H100); with f32 operands (no TF32) the
// f32 FMA rate bounds it (~0.33 ms). The bf16 design below takes the
// products off the critical path; what holds its tile pass back is the
// latency of the elementwise loads and stores around them (the dg
// prologue, the epilogues) and the scratch it writes for the weight pass
// (dg, dpre_c, h_c: ~54 MB at those shapes).
//
// Three launches per call, no atomics, every sum in a fixed order, so the
// results are bitwise repeatable; d % 128 == 0 and d <= 512 (the wrappers
// zero-pad other widths).
//
// bf16 (training) design, wgmma + TMA:
//   1. tile pass, a persistent grid (one block per SM) walking the 64-edge
//      tiles in a static order (tile = blockIdx.x + k gridDim.x). Block =
//      two consumer warpgroups + one producer warp. The producer keeps TMA
//      loads (cp.async.bulk.tensor, 128-byte swizzle, mbarrier completion)
//      of 64 x 64 weight slabs of W1g, W1a and We in flight in a ring of
//      3-16 stages; the weights are the same for every tile and stay hot in
//      L2. The consumers form dg (the prologue: 16-byte vector loads, dg
//      and its column sums), keep it in shared memory in the swizzled
//      K-major layout wgmma reads (fence.proxy.async before the first
//      product), and run dh = dg @ W1g^T with wgmma.mma_async m64n64k16
//      (bf16 operands, f32 accumulation), each warpgroup owning every other
//      64-column chunk. The silu' chain runs on the accumulator registers;
//      dpre_c goes to device memory, to a swizzled [64, 2d] tile in shared
//      memory (the A operand of de) and h_c = round(pre sig) [E, 2d] goes
//      to device memory for the weight pass; db's column sums are a
//      fixed-order warp-shuffle tree over the accumulator rows. Then ds
//      replaces dg (dh's aggregate half), then de = deres + dpre_c @ We^T
//      from the dpre_c tile. No f32 tile makes a round trip through shared
//      memory.
//   2. weight pass, output tiles of 128 x 128 (two warpgroups of
//      m64n128k16) of dWe | dW1g | dW1a, split over KSPLIT edge ranges so
//      that tiles x KSPLIT fills the SMs. A (e or h_c, edge-major) is the
//      transposed (MN-major) shared-memory operand, B (dpre_c, dg, ds) the
//      MN-major B operand, both loaded by TMA into a 4-stage ring. The f32
//      partials cost 2 x KSPLIT x 4d^2 x 4 bytes (written, then read once).
//   3. reduce pass: the split partials in split order, the per-tile bias
//      partials in tile order, and the dxi / dxj CSR row reduces (dst rows
//      over dst_rowptr; src rows over src_rowptr through src_perm, the
//      masked-in edges of each chunk compacted in order by warp ballots).
// Shared memory of the tile pass (TileLayout): the ring S x 8 KB, dg/ds
// [64, d] bf16 (d x 128 bytes), dpre_c [64, 2d] (2d x 128 bytes), 4 KB of
// the epilogues' column-sum scratch and the barriers, from a 1024-byte
// aligned base; the column partials of dg and ds use the dpre_c tile's
// halves before the epilogues fill them. At d = 512 that is 64 + 128 KB +
// 3 stages (24 KB): the stage count is what gives way (15 stages at
// d = 256, 9 at d = 384).
//
// f32 design (no TF32, so no tensor cores): the f32 FMA rate of the CUDA
// cores (67 TFLOP/s) bounds it, 0.33 ms for the 22 GFLOP above. Every
// product runs as SIMT GEMM tiles of 64 x 128 (simt_gemm.cuh: 128 threads,
// an 8 x 8 register micro-tile each fed by float4 loads from k-major
// shared slabs, the next k-slab's loads in flight during the FMAs, four
// blocks an SM):
//   1. tile pass, one block per 64-edge tile (one moment window): dg (and
//      merged, ds) one column a thread with its bias sums, written to
//      device memory; dh in 128-column tiles (A = dg or ds, B = W1g^T or
//      W1a^T) whose epilogue applies silu' on the registers and writes
//      dpre_c with db's column sums; then de = deres + dpre_c @ We^T with
//      A read back from the block's own dpre_c rows (L2-resident), so no
//      [64, 2d] f32 tile has to fit in shared memory at any d <= 512. The
//      weights are the same for every tile and stay in L2.
//   2. weight pass, 64 x 128 tiles of dWe | dW1g | dW1a (A = e or h =
//      pre sig recomputed from the residual, B = dpre_c, dg or ds) over
//      KSPLIT edge ranges that fill the SMs' block slots.
//   3. the reduce pass above.
// Elementwise steps use explicitly rounded operations so nvcc contracts
// nothing into an FMA that the plain PyTorch version does not have.
//
// The live edge counts (f32 only; the bf16 passes compute every tile).
// ``live`` points at two int32 on the device: [0] one past the batch's last
// masked-in edge (rounded up to the 64-edge tile here as well), [1] one past
// the last masked-in position of the src-sorted order. Every edge or
// position at or past them is a masked-out pad; the blocks read them, so
// the grids stay static (a CUDA graph replays any batch of its shape):
//   1. a tile past [0] writes de = deres + 0 (what its all-zero dpre gives:
//      pads carry zero cotangents, so dg = ds = dh = dpre = 0 there) and
//      zero bias partials (a sum of zeros from 0 is +0), and nothing else:
//      dg, ds, dpre_c and h of its rows are never read;
//   2. the KSPLIT edge ranges cut the live tiles alone, so the blocks stay
//      balanced and the pass shortens; a range past the count sums nothing
//      (zero partials). The split differs from the one over every edge, so
//      the weight gradients agree with a call without the count to f32
//      rounding, not bitwise;
//   3. the dst row walks stop at [0], the src row walks at [1]: they sum
//      masked-in edges only, so dxi / dxj are bitwise those without them.
// de, dxi, dxj and the bias gradients are bitwise those of a call without
// the counts. A null ``live`` is every edge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

// TMA, mbarriers, wgmma descriptors and products, the TMA ring, the tensor
// maps (shared with K1 and K8)
#include "hopper_common.cuh"
// the f32 passes' SIMT products (shared with K8)
#include "simt_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int NTHREADS = 256;     // the reduce pass: 8 warps
constexpr int MOM = 64;           // edges per moment window (the forward's)
constexpr int MAXF = 4;           // pass 3: 2d <= MAXF * NTHREADS
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

template <typename T>
struct Args {
  const T* e;
  const T* we;
  const T* w1g;
  const T* w1a;
  const T* saved;
  const T* gate;
  const float* meanw;
  const float* ds1w;
  const float* dm2w;
  const T* dgate;
  const T* dsender;
  const T* deres;   // merged: deout
  const T* sender;  // merged only, as are env ... dst and ds_out
  const T* env;     // [E]
  const float* scale;
  const float* shift;
  const T* daggr;   // [N, d]  (N: dst rows)
  const int* dst;
  const uint8_t* emask;
  const int* dst_rowptr;
  const int* src_perm;
  const int* src_rowptr;
  T* de;
  T* dg_out;    // [E, d]   rounded dg
  T* ds_out;    // [E, d]   merged: rounded ds
  T* dpre_out;  // [E, 2d]  dpre_c
  T* h_out;     // [E, 2d]  bf16: h_c = round(pre sig), for the weight pass
  float* dxi;   // [N, 2d]   dst rows, walked over dst_rowptr
  float* dxj;   // [Ns, 2d]  src rows, walked over src_rowptr
  float* dw;    // [4 d^2]  dWe [d, 2d] | dW1g [d, d] | dW1a [d, d]
  float* dbias; // [4 d]    db [2d] | db1g [d] | db1a [d]
  float* bias_part;  // [n_tiles, 4d]
  float* w_part;     // [ksplit, 4 d^2]
  const int* live;   // f32: the live edge counts on the device, or null
  int E, N, Ns, d, ksplit;
};

// the live edges (rounded up to the 64-edge tile) and the live src-sorted
// positions of a call, within [0, E]
__device__ __forceinline__ int live_edges(const int* live, int E) {
  if (live == nullptr) return E;
  const long long n = ((long long)live[0] + MOM - 1) / MOM * MOM;
  return n < 0 ? 0 : n > E ? E : (int)n;
}
__device__ __forceinline__ int live_src(const int* live, int E) {
  if (live == nullptr) return E;
  const int n = live[1];
  return n < 0 ? 0 : n > E ? E : n;
}

// ===================================================== f32: CUDA cores (FMA)
// Every product is a run of simt_gemm.cuh's 64 x 128 tiles (128 threads,
// 8 x 8 register micro-tiles, double-buffered k-slabs of 8).

static_assert(simt::BM == MOM, "an f32 tile is one moment window");
// blocks an SM the f32 passes are compiled for (__launch_bounds__: 170
// registers a thread, none spilled at three)
constexpr int TILE_BLOCKS_F32 = 3, WEIGHT_BLOCKS_F32 = 3;

// ------------------------------------------------------- f32 pass 1: tile
// One block per 64-edge tile: (1) dg with the window-moment cotangents
// folded in (merged: the gate's cotangent from the sigma backward, which
// also gives ds), one column a thread over the rows in order, written for
// the products and the weight pass, with db1g / db1a's column sums; (2)
// dh = [dg @ W1g^T | ds @ W1a^T] in 128-column tiles, each tile's
// epilogue dpre = dh (sig + h (1 - sig)) -> dpre_out and db's column sums;
// (3) de = deres + dpre @ We^T, A read back from dpre_out (this block's own
// rows, in L2). A barrier orders each step's stores before the next
// step's loads, as they are this block's. A tile past the live count
// writes de = deres + 0 and zero bias partials alone.
template <bool MERGED>
__global__ void __launch_bounds__(simt::THREADS, TILE_BLOCKS_F32)
    edge_bwd_tile_f32(const __grid_constant__ Args<float> p) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int d = p.d, d2 = 2 * d;
  const size_t e0 = (size_t)blockIdx.x * simt::BM;
  float* bpart = p.bias_part + (size_t)blockIdx.x * 4 * d;
  if ((long long)e0 >= live_edges(p.live, p.E)) {
    for (int c = threadIdx.x; c < 4 * d; c += simt::THREADS) bpart[c] = 0.f;
    const float4* r4 = reinterpret_cast<const float4*>(p.deres + e0 * d);
    float4* de4 = reinterpret_cast<float4*>(p.de + e0 * d);
    for (int i = threadIdx.x; i < simt::BM * d / 4; i += simt::THREADS) {
      const float4 r = r4[i];  // + 0 turns -0 into +0, as the sum does
      de4[i] = make_float4(__fadd_rn(r.x, 0.f), __fadd_rn(r.y, 0.f),
                           __fadd_rn(r.z, 0.f), __fadd_rn(r.w, 0.f));
    }
    return;
  }

  for (int c = threadIdx.x; c < d; c += simt::THREADS) {
    const size_t w = (size_t)blockIdx.x * d + c;  // the tile's window
    const float mean = p.meanw[w], s1 = p.ds1w[w];
    const float m2 = __fmul_rn(2.f, p.dm2w[w]);
    const float sc = MERGED ? p.scale[c] : 0.f;
    const float sh = MERGED ? p.shift[c] : 0.f;
    float sum_g = 0.f, sum_s = 0.f;
#pragma unroll 8
    for (int r = 0; r < simt::BM; ++r) {
      const size_t e = e0 + r, o = e * d + c;
      const float m = p.emask[e] ? 1.f : 0.f;
      const float g = p.gate[o];
      const float corr = __fadd_rn(s1, __fmul_rn(m2, __fadd_rn(g, -mean)));
      float dgate, ds;
      if constexpr (MERGED) {
        const float dvals =
            m != 0.f ? p.daggr[(size_t)p.dst[e] * d + c] : 0.f;
        const float sig0 = sigmoid_f(__fadd_rn(__fmul_rn(g, sc), sh));
        const float env = p.env[e];
        const float dsig =
            __fadd_rn(p.deres[o], __fmul_rn(dvals, p.sender[o]));
        const float da = __fmul_rn(__fmul_rn(__fmul_rn(dsig, env), sig0),
                                   __fadd_rn(1.f, -sig0));
        ds = __fmul_rn(__fmul_rn(dvals, sig0), env);
        p.ds_out[o] = ds;
        dgate = __fmul_rn(da, sc);
      } else {
        ds = p.dsender[o];
        dgate = p.dgate[o];
      }
      const float v = __fadd_rn(dgate, __fmul_rn(m, corr));
      p.dg_out[o] = v;
      sum_g = __fadd_rn(sum_g, v);
      sum_s = __fadd_rn(sum_s, ds);
    }
    bpart[d2 + c] = sum_g;      // db1g
    bpart[d2 + d + c] = sum_s;  // db1a
  }
  __syncthreads();

  const float* ds_src = MERGED ? p.ds_out : p.dsender;
  for (int pc0 = 0; pc0 < d2; pc0 += simt::BN) {  // dh, then dpre
    const bool agg = pc0 >= d;
    const int n0 = agg ? pc0 - d : pc0;
    float acc[8][8];
    simt::zero(acc);
    simt::RowsT<simt::BM> fa{(agg ? ds_src : p.dg_out) + e0 * d, (size_t)d,
                             0};
    simt::RowsT<simt::BN> fb{(agg ? p.w1a : p.w1g) + (size_t)n0 * d,
                             (size_t)d, 0};
    simt::mainloop(acc, d / simt::BK, fa, fb, smem);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const size_t e = e0 + simt::row_of(i);
      const float* srow = p.saved + e * (MERGED ? d2 : 2 * d2);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pc = pc0 + simt::col_of(4 * hh);
        const float4 pr4 = *reinterpret_cast<const float4*>(srow + pc);
        const float pr[4] = {pr4.x, pr4.y, pr4.z, pr4.w};
        float sg[4];
        if constexpr (MERGED) {
#pragma unroll
          for (int q = 0; q < 4; ++q) sg[q] = sigmoid_f(pr[q]);
        } else {
          const float4 s4 = *reinterpret_cast<const float4*>(srow + d2 + pc);
          sg[0] = s4.x; sg[1] = s4.y; sg[2] = s4.z; sg[3] = s4.w;
        }
        float* a = acc[i] + 4 * hh;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float h32 = __fmul_rn(pr[q], sg[q]);
          a[q] = __fmul_rn(a[q], __fadd_rn(sg[q], __fmul_rn(
                                                      h32, __fadd_rn(1.f, -sg[q]))));
        }
        *reinterpret_cast<float4*>(p.dpre_out + e * d2 + pc) =
            make_float4(a[0], a[1], a[2], a[3]);
      }
    }
    simt::column_sums(acc, smem,
                      [&](int c, float s) { bpart[pc0 + c] = s; });  // db
    __syncthreads();
  }

  for (int n0 = 0; n0 < d; n0 += simt::BN) {  // de = deres + dpre_c @ We^T
    float acc[8][8];
    simt::zero(acc);
    simt::RowsT<simt::BM> fa{p.dpre_out + e0 * d2, (size_t)d2, 0};
    simt::RowsT<simt::BN> fb{p.we + (size_t)n0 * d2, (size_t)d2, 0};
    simt::mainloop(acc, d2 / simt::BK, fa, fb, smem);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const size_t o = (e0 + simt::row_of(i)) * d + n0 +
                         simt::col_of(4 * hh);
        const float4 r4 = *reinterpret_cast<const float4*>(p.deres + o);
        const float* a = acc[i] + 4 * hh;
        *reinterpret_cast<float4*>(p.de + o) =
            make_float4(__fadd_rn(r4.x, a[0]), __fadd_rn(r4.y, a[1]),
                        __fadd_rn(r4.z, a[2]), __fadd_rn(r4.w, a[3]));
      }
  }
}

// ---------------------------------------------------- f32 pass 2: weights
// A of a dW1g / dW1a tile: h = pre sig recomputed from the saved residual
// ([pre | sig] rows of 4d; merged, pre rows of 2d and sig from pre), rows
// k = edges from ebeg, 64 columns from col, stored as simt::ColsD<64> does
template <bool MERGED>
struct HCols {
  using Regs = float4[1];
  const float* saved;
  int d2, col, ebeg;
  __device__ __forceinline__ void fetch(int kt, Regs& v) const {
    const int idx = threadIdx.x;
    const float* row = saved + (size_t)(ebeg + kt * simt::BK + idx / 16) *
                                   (MERGED ? d2 : 2 * d2) +
                       col + 4 * (idx % 16);
    const float4 pr = *reinterpret_cast<const float4*>(row);
    const float4 sg =
        MERGED ? make_float4(sigmoid_f(pr.x), sigmoid_f(pr.y),
                             sigmoid_f(pr.z), sigmoid_f(pr.w))
               : *reinterpret_cast<const float4*>(row + d2);
    v[0] = make_float4(__fmul_rn(pr.x, sg.x), __fmul_rn(pr.y, sg.y),
                       __fmul_rn(pr.z, sg.z), __fmul_rn(pr.w, sg.w));
  }
  __device__ __forceinline__ void store(const Regs& v, float* S) const {
    simt::ColsD<simt::BM>{nullptr, 0, 0}.store(v, S);
  }
};

// which weight-gradient tile (rows x cols) this block owns
struct WTile {
  int mat, rt, ct, ld_out;
  size_t off;  // offset of the matrix inside the 4 d^2 block
};

__device__ __forceinline__ WTile weight_tile(int t, int d, int rows,
                                             int cols) {
  const int nr = d / rows, nc0 = 2 * d / cols, nc1 = d / cols;
  WTile w;
  if (t < nr * nc0) {
    w.mat = 0; w.rt = t / nc0; w.ct = t % nc0; w.ld_out = 2 * d; w.off = 0;
  } else {
    t -= nr * nc0;
    w.mat = 1 + t / (nr * nc1);
    t %= nr * nc1;
    w.rt = t / nc1; w.ct = t % nc1; w.ld_out = d;
    w.off = (size_t)2 * d * d + (size_t)(w.mat - 1) * d * d;
  }
  return w;
}

// block (tile, split): the KSPLIT partial of one 64 x 128 tile of dWe
// (A = e) | dW1g | dW1a (A = h) over one edge range, B = dpre_c | dg | ds;
// the ranges cut the live tiles into KSPLIT runs of whole tiles
template <bool MERGED>
__global__ void __launch_bounds__(simt::THREADS, WEIGHT_BLOCKS_F32)
    edge_bwd_weights_f32(const __grid_constant__ Args<float> p) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int d = p.d;
  const WTile w = weight_tile(blockIdx.x, d, simt::BM, simt::BN);
  const int live = live_edges(p.live, p.E);
  const int per_split = (live / MOM + p.ksplit - 1) / p.ksplit * MOM;
  const int ebeg = blockIdx.y * per_split;
  const int eend = ebeg + per_split < live ? ebeg + per_split : live;
  const int nk = eend > ebeg ? (eend - ebeg) / simt::BK : 0;
  const float* bsrc = w.mat == 0 ? p.dpre_out
                    : w.mat == 1 ? p.dg_out : MERGED ? p.ds_out : p.dsender;
  float acc[8][8];
  simt::zero(acc);
  simt::ColsD<simt::BN> fb{bsrc + w.ct * simt::BN,
                           (size_t)(w.mat == 0 ? 2 * d : d), ebeg};
  if (nk > 0 && w.mat == 0) {
    simt::ColsD<simt::BM> fa{p.e + w.rt * simt::BM, (size_t)d, ebeg};
    simt::mainloop(acc, nk, fa, fb, smem);
  } else if (nk > 0) {
    HCols<MERGED> fa{p.saved, 2 * d,
                     (w.mat == 1 ? 0 : d) + w.rt * simt::BM, ebeg};
    simt::mainloop(acc, nk, fa, fb, smem);
  }
  float* out = p.w_part + (size_t)blockIdx.y * 4 * d * d + w.off +
               (size_t)w.rt * simt::BM * w.ld_out + w.ct * simt::BN;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float4*>(out + (size_t)simt::row_of(i) * w.ld_out +
                                 simt::col_of(4 * hh)) =
          make_float4(acc[i][4 * hh], acc[i][4 * hh + 1], acc[i][4 * hh + 2],
                      acc[i][4 * hh + 3]);
}

// ========================================== bf16: wgmma + TMA (tensor cores)

constexpr int TC_THREADS = 288;  // two consumer warpgroups + a producer warp
constexpr int TE = 64;           // edges per tile (one wgmma M; = MOM)
constexpr int TC_MAX_STAGES = 16;
constexpr int RED_BYTES = 4096;  // epilogue sums: [2 wg][2 buffers][4][64]
constexpr int WT_STAGES = 4;     // weight-pass ring, 4 slabs per stage
constexpr int WT = 128;          // weight-pass output tile (WT x WT)

// shared-memory plan of the bf16 tile pass (bytes from the 1024-aligned
// base; total includes the 1024 bytes of alignment slack)
struct TileLayout {
  int stages;
  size_t ring, a, p, red, bars, total;
  __host__ __device__ explicit TileLayout(int d) {
    const long long fixed = 1024 + 384LL * d + RED_BYTES + 16 * TC_MAX_STAGES;
    const long long s = (SMEM_LIMIT - fixed) / SLAB;
    stages = (int)(s < TC_MAX_STAGES ? (s < 0 ? 0 : s) : TC_MAX_STAGES);
    ring = 0;
    a = ring + (size_t)stages * SLAB;  // dg, then ds: d/64 slabs
    p = a + (size_t)d * 128;            // dpre_c: 2d/64 slabs
    red = p + (size_t)d * 256;
    bars = red + RED_BYTES;             // full[stages], empty[stages]
    total = 1024 + bars + 16 * (size_t)stages;
  }
};

constexpr size_t WEIGHT_SMEM = 1024 + (size_t)WT_STAGES * 4 * SLAB +
                               16 * WT_STAGES;


__device__ __forceinline__ void load8(const bf16* src, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const bf162* h = reinterpret_cast<const bf162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 u;
  bf162* h = reinterpret_cast<bf162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}

// column sums of a [64, d] tile, step 1, per 64-column slab sb: the 8
// partials of each thread (its two rows rr, rr + 32 at columns 8 vc ..)
// summed by a shuffle tree over the 4 row quads of each warp into
// red[warp][d] (no barrier: every slab has its own columns)
__device__ __forceinline__ void slab_partials(float (&cs)[8], float* red,
                                              int sb, int d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cs[i] = __fadd_rn(cs[i], __shfl_xor_sync(0xffffffffu, cs[i], 8));
    cs[i] = __fadd_rn(cs[i], __shfl_xor_sync(0xffffffffu, cs[i], 16));
  }
  if (lane < 8)
#pragma unroll
    for (int i = 0; i < 8; ++i) red[warp * d + sb * 64 + lane * 8 + i] = cs[i];
}

// step 2, once per tile: the 8 warps' partials in order -> out[0:d). All
// 256 consumer threads; red is not written again before the next
// consumer-wide barrier.
__device__ __forceinline__ void column_sums_8(const float* red, int d,
                                              float* out) {
  bar_sync(1, 256);
  for (int c = threadIdx.x; c < d; c += 256) {
    float s = red[c];
#pragma unroll
    for (int w = 1; w < 8; ++w) s = __fadd_rn(s, red[w * d + c]);
    out[c] = s;
  }
}

// prologue: dg (the window-moment fold; merged, after the sigma backward,
// which also writes ds) -> the swizzled A tile, dg_out and db1g's sums
// (partials through red, [8][d] f32 of free shared memory). Thread ct owns
// rows ct / 8 and ct / 8 + 32, 16-byte column vector ct % 8 of every
// 64-column slab.
template <bool MERGED>
__device__ __forceinline__ void tc_prologue(const Args<bf16>& p, size_t e0,
                                            unsigned char* a_g, float* red,
                                            float* out) {
  const int ct = threadIdx.x, vc = ct & 7, rr = ct >> 3, d = p.d;
  const size_t wrow = (e0 / MOM) * d;  // the tile is one moment window
  float m[2], env[2];
  int dst[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const size_t e = e0 + rr + 32 * q;
    m[q] = p.emask[e] ? 1.f : 0.f;
    if constexpr (MERGED) {
      dst[q] = p.dst[e];
      env[q] = to_f(p.env[e]);
    }
  }
  for (int sb = 0; sb < d / 64; ++sb) {
    const int c0 = sb * 64 + vc * 8;
    float mw[8], s1[8], m2[8], sc[8], sh[8], cs[8];
    load8(p.meanw + wrow + c0, mw);
    load8(p.ds1w + wrow + c0, s1);
    load8(p.dm2w + wrow + c0, m2);
    if constexpr (MERGED) {
      load8(p.scale + c0, sc);
      load8(p.shift + c0, sh);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = rr + 32 * q;
      const size_t o = (e0 + r) * d + c0;
      float g[8], dgate[8], v[8];
      load8(p.gate + o, g);
      if constexpr (MERGED) {
        float dv[8], snd[8], dout[8], ds[8];
        if (m[q] != 0.f) {
          load8(p.daggr + (size_t)dst[q] * d + c0, dv);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) dv[i] = 0.f;
        }
        load8(p.sender + o, snd);
        load8(p.deres + o, dout);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float sig0 =
              sigmoid_f(__fadd_rn(__fmul_rn(g[i], sc[i]), sh[i]));
          const float dsig = __fadd_rn(dout[i], __fmul_rn(dv[i], snd[i]));
          const float da = __fmul_rn(
              __fmul_rn(__fmul_rn(dsig, env[q]), sig0), __fadd_rn(1.f, -sig0));
          ds[i] = __fmul_rn(__fmul_rn(dv[i], sig0), env[q]);
          dgate[i] = __fmul_rn(da, sc[i]);
        }
        *reinterpret_cast<uint4*>(p.ds_out + o) = pack8(ds);
      } else {
        load8(p.dgate + o, dgate);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float corr = __fadd_rn(
            s1[i], __fmul_rn(__fmul_rn(2.f, m2[i]), __fadd_rn(g[i], -mw[i])));
        v[i] = __fadd_rn(dgate[i], __fmul_rn(m[q], corr));
      }
      const uint4 u = pack8(v);
      *reinterpret_cast<uint4*>(a_g + sw_off(r, c0)) = u;
      *reinterpret_cast<uint4*>(p.dg_out + o) = u;
      const bf162* h = reinterpret_cast<const bf162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // sums of the rounded dg
        const float2 f = __bfloat1622float2(h[i]);
        cs[2 * i] = q ? __fadd_rn(cs[2 * i], f.x) : f.x;
        cs[2 * i + 1] = q ? __fadd_rn(cs[2 * i + 1], f.y) : f.y;
      }
    }
    slab_partials(cs, red, sb, d);
  }
  column_sums_8(red, d, out);
}

// ds (dsender; merged, the ds_out this thread wrote in the prologue) -> the
// swizzled A tile and db1a's sums, in the prologue's thread layout
template <bool MERGED>
__device__ __forceinline__ void tc_load_ds(const Args<bf16>& p, size_t e0,
                                           unsigned char* a_g, float* red,
                                           float* out) {
  const int ct = threadIdx.x, vc = ct & 7, rr = ct >> 3, d = p.d;
  const bf16* ds = MERGED ? p.ds_out : p.dsender;
  for (int sb = 0; sb < d / 64; ++sb) {
    const int c0 = sb * 64 + vc * 8;
    float cs[8];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = rr + 32 * q;
      const uint4 u =
          *reinterpret_cast<const uint4*>(ds + (e0 + r) * d + c0);
      *reinterpret_cast<uint4*>(a_g + sw_off(r, c0)) = u;
      const bf162* h = reinterpret_cast<const bf162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        cs[2 * i] = q ? __fadd_rn(cs[2 * i], f.x) : f.x;
        cs[2 * i + 1] = q ? __fadd_rn(cs[2 * i + 1], f.y) : f.y;
      }
    }
    slab_partials(cs, red, sb, d);
  }
  column_sums_8(red, d, out);
}

// the residual at a thread's accumulator elements of a dh chunk (64
// columns from pc0): [2 i + hr] holds rows wi 16 + lane / 4 + 8 hr, columns
// pc0 + 8 i + 2 (lane % 4) + {0, 1}; loaded before the chunk's products so
// that the loads overlap them (sig only for K5's [pre | sig] layout)
struct DhResidual {
  bf162 pre[16], sig[16];
};

template <bool MERGED>
__device__ __forceinline__ void tc_dh_residual(const Args<bf16>& p,
                                               size_t e0, int pc0,
                                               DhResidual& res) {
  const int wt = threadIdx.x & 127, wi = wt >> 5, lane = wt & 31;
  const int d2 = 2 * p.d;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int pc = pc0 + 8 * i + 2 * (lane & 3);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const size_t e = e0 + wi * 16 + (lane >> 2) + 8 * hr;
      const bf16* row = p.saved + e * (MERGED ? d2 : 2 * d2);
      res.pre[2 * i + hr] = *reinterpret_cast<const bf162*>(row + pc);
      if constexpr (!MERGED)
        res.sig[2 * i + hr] = *reinterpret_cast<const bf162*>(row + d2 + pc);
    }
  }
}

// dh chunk (64 columns from pc0 of [dh_g | dh_a]) -> the silu' chain on the
// accumulators: dpre_c to device memory and to the swizzled dpre_c tile,
// h_c to device memory, db's column sums (rows paired, a shuffle tree over
// the warp's 16 rows, then the warpgroup's 4 warps in order) -> bsum[0:64).
// red: this warpgroup's [4][64] buffer, alternating between two from one
// epilogue to the next so that one barrier orders writes and reads
template <bool MERGED>
__device__ __forceinline__ void tc_dh_epilogue(const Args<bf16>& p,
                                               const float (&acc)[32],
                                               const DhResidual& res,
                                               size_t e0, int pc0,
                                               unsigned char* p_g, float* red,
                                               float* bsum, int wg) {
  const int wt = threadIdx.x & 127, wi = wt >> 5, lane = wt & 31;
  const int d2 = 2 * p.d;
  float cs[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int pc = pc0 + 8 * i + 2 * (lane & 3);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wi * 16 + (lane >> 2) + 8 * hr;
      const size_t e = e0 + r;
      const float2 pre = __bfloat1622float2(res.pre[2 * i + hr]);
      float2 sg;
      if constexpr (MERGED) {
        sg = make_float2(sigmoid_f(pre.x), sigmoid_f(pre.y));
      } else {
        sg = __bfloat1622float2(res.sig[2 * i + hr]);
      }
      const float h0 = __fmul_rn(pre.x, sg.x), h1 = __fmul_rn(pre.y, sg.y);
      const float dp0 = __fmul_rn(
          acc[4 * i + 2 * hr],
          __fadd_rn(sg.x, __fmul_rn(h0, __fadd_rn(1.f, -sg.x))));
      const float dp1 = __fmul_rn(
          acc[4 * i + 2 * hr + 1],
          __fadd_rn(sg.y, __fmul_rn(h1, __fadd_rn(1.f, -sg.y))));
      const bf162 v = __floats2bfloat162_rn(dp0, dp1);
      *reinterpret_cast<bf162*>(p.dpre_out + e * d2 + pc) = v;
      *reinterpret_cast<bf162*>(p.h_out + e * d2 + pc) =
          __floats2bfloat162_rn(h0, h1);
      *reinterpret_cast<bf162*>(p_g + sw_off(r, pc)) = v;
      cs[2 * i] = hr ? __fadd_rn(cs[2 * i], dp0) : dp0;
      cs[2 * i + 1] = hr ? __fadd_rn(cs[2 * i + 1], dp1) : dp1;
    }
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    cs[k] = __fadd_rn(cs[k], __shfl_xor_sync(0xffffffffu, cs[k], 4));
    cs[k] = __fadd_rn(cs[k], __shfl_xor_sync(0xffffffffu, cs[k], 8));
    cs[k] = __fadd_rn(cs[k], __shfl_xor_sync(0xffffffffu, cs[k], 16));
  }
  if (lane < 4)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      red[wi * 64 + 8 * i + 2 * lane] = cs[2 * i];
      red[wi * 64 + 8 * i + 2 * lane + 1] = cs[2 * i + 1];
    }
  bar_sync(2 + wg, 128);
  if (wt < 64) {
    float s = red[wt];
#pragma unroll
    for (int w = 1; w < 4; ++w) s = __fadd_rn(s, red[w * 64 + wt]);
    bsum[wt] = s;
  }
}

// offset of a thread's accumulator pair [2 i + hr] of a de chunk (64
// columns from k0) in an [E, d] array
__device__ __forceinline__ size_t de_off(size_t e0, int k0, int d, int i,
                                         int hr) {
  const int wt = threadIdx.x & 127, wi = wt >> 5, lane = wt & 31;
  return (e0 + wi * 16 + (lane >> 2) + 8 * hr) * d + k0 + 8 * i +
         2 * (lane & 3);
}

// deres at the thread's elements of a de chunk, loaded before its products
__device__ __forceinline__ void tc_de_residual(const Args<bf16>& p,
                                               size_t e0, int k0,
                                               bf162 (&deres)[16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      deres[2 * i + hr] = *reinterpret_cast<const bf162*>(
          p.deres + de_off(e0, k0, p.d, i, hr));
}

// de chunk (64 columns from k0): de = deres + acc -> e's dtype
__device__ __forceinline__ void tc_de_epilogue(const Args<bf16>& p,
                                               const float (&acc)[32],
                                               const bf162 (&deres)[16],
                                               size_t e0, int k0) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const size_t o = de_off(e0, k0, p.d, i, hr);
      const float2 r = __bfloat1622float2(deres[2 * i + hr]);
      *reinterpret_cast<bf162*>(p.de + o) =
          __floats2bfloat162_rn(__fadd_rn(r.x, acc[4 * i + 2 * hr]),
                                __fadd_rn(r.y, acc[4 * i + 2 * hr + 1]));
    }
  }
}

// ------------------------------------------------------ bf16 pass 1: tile
template <bool MERGED>
__global__ void __launch_bounds__(TC_THREADS, 1)
    edge_bwd_tile_tc(Args<bf16> p, const __grid_constant__ CUtensorMap w1g_m,
                     const __grid_constant__ CUtensorMap w1a_m,
                     const __grid_constant__ CUtensorMap we_m) {
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const int d = p.d, d2 = 2 * d;
  const TileLayout L(d);
  const uint32_t raw = saddr(smem_tc);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_tc + (base - raw);
  const Ring ring{base + (uint32_t)L.ring, base + (uint32_t)L.bars,
                  base + (uint32_t)L.bars + 8u * L.stages, L.stages};
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n_tiles = p.E / TE;
  if (tid == 0) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, 4);  // the 4 warps of one warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer: the weight slabs, in the consumers' order
    if ((tid & 31) == 0) {
      uint32_t n = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        for (int half = 0; half < 2; ++half)
          for (int jp = 0; jp < d / 128; ++jp)
            for (int ks = 0; ks < d / 64; ++ks)
              for (int w = 0; w < 2; ++w, ++n)
                tma_load(ring.acquire(n, SLAB, SLAB), half ? &w1a_m : &w1g_m,
                         ring.full + 8 * ring.stage(n), ks * 64,
                         (2 * jp + w) * 64);
        for (int jp = 0; jp < d / 128; ++jp)
          for (int ks = 0; ks < d2 / 64; ++ks)
            for (int w = 0; w < 2; ++w, ++n)
              tma_load(ring.acquire(n, SLAB, SLAB), &we_m,
                       ring.full + 8 * ring.stage(n), ks * 64,
                       (2 * jp + w) * 64);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns the 64-column chunks 2 jp + wg
  const int wg = warp >> 2;
  const uint32_t a_s = base + (uint32_t)L.a, p_s = base + (uint32_t)L.p;
  unsigned char* a_g = gbase + L.a;
  unsigned char* p_g = gbase + L.p;
  float* red = reinterpret_cast<float*>(gbase + L.red) + 512 * wg;
  // the prologue's and ds's column partials use the dpre_c tile's halves,
  // free until the epilogues of half 0 and half 1 write them
  float* red_dg = reinterpret_cast<float*>(p_g);
  float* red_ds = reinterpret_cast<float*>(p_g + (size_t)d * 128);
  uint32_t pos = 0, ep = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const size_t e0 = (size_t)t * TE;
    float* bpart = p.bias_part + (size_t)t * 4 * d;
    tc_prologue<MERGED>(p, e0, a_g, red_dg, bpart + d2);  // dg, db1g
    for (int half = 0; half < 2; ++half) {
      if (half == 1)
        tc_load_ds<MERGED>(p, e0, a_g, red_ds, bpart + d2 + d);  // ds, db1a
      fence_async_smem();
      bar_sync(1, 256);  // the A tile is in place
      for (int jp = 0; jp < d / 128; ++jp) {
        const int pc0 = half * d + (2 * jp + wg) * 64;
        DhResidual res;
        tc_dh_residual<MERGED>(p, e0, pc0, res);
        float acc[32];
        tc_chunk(acc, a_s, d / 64, ring, pos, wg);
        tc_dh_epilogue<MERGED>(p, acc, res, e0, pc0, p_g,
                               red + 256 * (ep++ & 1), bpart + pc0, wg);
      }
      fence_async_smem();
      bar_sync(1, 256);  // the A tile is read; this half of dpre_c written
    }
    for (int jp = 0; jp < d / 128; ++jp) {
      float acc[32];
      bf162 deres[16];
      tc_de_residual(p, e0, (2 * jp + wg) * 64, deres);
      tc_chunk(acc, p_s, d2 / 64, ring, pos, wg);
      tc_de_epilogue(p, acc, deres, e0, (2 * jp + wg) * 64);
    }
    bar_sync(1, 256);  // the tiles are free for the next edge tile
  }
}

// --------------------------------------------------- bf16 pass 2: weights
// dW tile [128 x 128] of dWe (A = e, B = dpre_c), dW1g (A = h_g, B = dg) or
// dW1a (A = h_a, B = ds) summed over one edge range; warpgroup wg owns rows
// 64 wg .. 64 wg + 63. A stage holds A's two 64-column boxes, then B's.
template <bool MERGED>
__global__ void __launch_bounds__(TC_THREADS, 1)
    edge_bwd_weights_tc(Args<bf16> p, int per_split,
                        const __grid_constant__ CUtensorMap e_m,
                        const __grid_constant__ CUtensorMap h_m,
                        const __grid_constant__ CUtensorMap dpre_m,
                        const __grid_constant__ CUtensorMap dg_m,
                        const __grid_constant__ CUtensorMap ds_m) {
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  constexpr uint32_t STAGE = 4 * SLAB;
  const int d = p.d;
  const uint32_t raw = saddr(smem_tc);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + WT_STAGES * STAGE;
  const Ring ring{base, bars, bars + 8u * WT_STAGES, WT_STAGES};
  const int tid = threadIdx.x, warp = tid >> 5;
  const WTile w = weight_tile(blockIdx.x, d, WT, WT);
  const int ebeg = blockIdx.y * per_split;
  const int eend = ebeg + per_split < p.E ? ebeg + per_split : p.E;
  const int nslab = eend > ebeg ? (eend - ebeg) / TE : 0;
  if (tid == 0) {
    for (int s = 0; s < WT_STAGES; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, 8);  // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if ((tid & 31) == 0) {
      const CUtensorMap* am = w.mat == 0 ? &e_m : &h_m;
      const CUtensorMap* bm = w.mat == 0 ? &dpre_m
                            : w.mat == 1 ? &dg_m : &ds_m;
      const int acol = (w.mat == 2 ? d : 0) + w.rt * WT, bcol = w.ct * WT;
      for (int i = 0; i < nslab; ++i) {
        const uint32_t st = ring.acquire(i, STAGE, STAGE);
        const uint32_t fb = ring.full + 8 * ring.stage(i);
        const int e = ebeg + i * TE;
        tma_load(st, am, fb, acol, e);
        tma_load(st + SLAB, am, fb, acol + 64, e);
        tma_load(st + 2 * SLAB, bm, fb, bcol, e);
        tma_load(st + 3 * SLAB, bm, fb, bcol + 64, e);
      }
    }
    return;
  }

  const int wg = warp >> 2, wt = tid & 127, wi = wt >> 5, lane = wt & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int i = 0; i < nslab; ++i) {
    const uint32_t st = ring.wait_full(i, STAGE);
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 edges each: 2 swizzle atoms
      wgmma_m64n128<1, 1>(
          acc, sw128_desc(st + wg * SLAB + kk * 2048, SLAB, 1024),
          sw128_desc(st + 2 * SLAB + kk * 2048, SLAB, 1024));
    wg_commit();
    fence_acc(acc);
    if (i > 0) {
      wg_wait<1>();
      fence_acc(acc);
      ring.release(i - 1);
    }
  }
  wg_wait<0>();
  fence_acc(acc);
  if (nslab > 0) ring.release(nslab - 1);
  float* out = p.w_part + (size_t)blockIdx.y * 4 * d * d + w.off +
               (size_t)(w.rt * WT + wg * 64) * w.ld_out + w.ct * WT;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = 8 * i + 2 * (lane & 3);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wi * 16 + (lane >> 2) + 8 * hr;
      *reinterpret_cast<float2*>(out + (size_t)r * w.ld_out + c) =
          make_float2(acc[4 * i + 2 * hr], acc[4 * i + 2 * hr + 1]);
    }
  }
}

// ---------------------------------------------------------- pass 3: reduce
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    edge_bwd_reduce(Args<T> p, int nw_blocks, int nb_blocks, int n_tiles) {
  __shared__ int idx_s[NTHREADS];
  __shared__ int warp_cnt[NTHREADS / 32];
  const int d = p.d, d2 = 2 * d, tid = threadIdx.x;
  int b = blockIdx.x;
  if (b < nw_blocks) {  // weight partials, in split order
    const size_t n = (size_t)4 * d * d;
    const size_t i = (size_t)b * NTHREADS + tid;
    if (i < n) {
      float s = 0.f;
      for (int k = 0; k < p.ksplit; ++k)
        s = __fadd_rn(s, p.w_part[k * n + i]);
      p.dw[i] = s;
    }
    return;
  }
  b -= nw_blocks;
  if (b < nb_blocks) {  // bias partials, in tile order
    const int c = b * NTHREADS + tid;
    if (c < 4 * d) {
      float s = 0.f;
      for (int t = 0; t < n_tiles; ++t)
        s = __fadd_rn(s, p.bias_part[(size_t)t * 4 * d + c]);
      p.dbias[c] = s;
    }
    return;
  }
  b -= nb_blocks;
  // node row: the N dst rows first, then the Ns src rows (through
  // src_perm)
  const bool src_side = b >= p.N;
  const int row = src_side ? b - p.N : b;
  const int* rowptr = src_side ? p.src_rowptr : p.dst_rowptr;
  float* out = src_side ? p.dxj : p.dxi;
  // past the live counts every edge is masked out: the walk stops there
  const int cap = src_side ? live_src(p.live, p.E) : live_edges(p.live, p.E);
  const int beg = rowptr[row];
  const int end = rowptr[row + 1] < cap ? rowptr[row + 1] : cap;
  float acc[MAXF];
#pragma unroll
  for (int q = 0; q < MAXF; ++q) acc[q] = 0.f;
  const int lane = tid & 31, warp = tid >> 5;
  for (int c0 = beg; c0 < end; c0 += NTHREADS) {
    const int k = c0 + tid;
    int e = -1;
    if (k < end) e = src_side ? p.src_perm[k] : k;
    const bool real = e >= 0 && p.emask[e] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, real);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < NTHREADS / 32; ++w) {
      off += w < warp ? warp_cnt[w] : 0;
      total += warp_cnt[w];
    }
    if (real) idx_s[off + __popc(ballot & ((1u << lane) - 1u))] = e;
    __syncthreads();
    for (int j = 0; j < total; ++j) {
      const T* src = p.dpre_out + (size_t)idx_s[j] * d2;
#pragma unroll
      for (int q = 0; q < MAXF; ++q) {
        const int f = tid + q * NTHREADS;
        if (f < d2) acc[q] = __fadd_rn(acc[q], to_f(src[f]));
      }
    }
    __syncthreads();  // idx_s / warp_cnt are rewritten by the next chunk
  }
#pragma unroll
  for (int q = 0; q < MAXF; ++q) {
    const int f = tid + q * NTHREADS;
    if (f < d2) out[(size_t)row * d2 + f] = acc[q];
  }
}

// ------------------------------------------------------------------- host

int n_weight_tiles(int d, int is_bf16) {
  return is_bf16 ? 4 * d * d / (WT * WT)
                 : (d / simt::BM) * (4 * d / simt::BN);
}

// edge ranges of the weight pass: tiles x KSPLIT blocks fill the SMs (bf16:
// one block an SM; f32: WEIGHT_BLOCKS_F32)
int ksplit_of(int E, int d, int is_bf16) {
  int k = (is_bf16 ? 1 : WEIGHT_BLOCKS_F32) * num_sms() /
          n_weight_tiles(d, is_bf16);
  if (k > E / TE) k = E / TE;
  return k < 1 ? 1 : k;
}

// the operands of one call, untyped, as the C entry points receive them
// (the pointers a pass does not read stay null)
struct Ptrs {
  const void *e, *we, *w1g, *w1a, *saved, *gate, *meanw, *ds1w, *dm2w,
      *dgate, *dsender, *deres, *sender, *env, *scale, *shift, *daggr, *dst,
      *emask, *dst_rowptr, *src_perm, *src_rowptr, *live;
  void *de, *dg_buf, *ds_buf, *dpre_buf, *h_buf, *dxi, *dxj, *dw, *dbias,
      *work;
};

template <typename T>
Args<T> make_args(const Ptrs& q, int E, int N, int Ns, int d, int te) {
  Args<T> p{};
  p.live = sizeof(T) == 2 ? nullptr : (const int*)q.live;  // bf16: all
  p.e = (const T*)q.e;
  p.we = (const T*)q.we;
  p.w1g = (const T*)q.w1g;
  p.w1a = (const T*)q.w1a;
  p.saved = (const T*)q.saved;
  p.gate = (const T*)q.gate;
  p.meanw = (const float*)q.meanw;
  p.ds1w = (const float*)q.ds1w;
  p.dm2w = (const float*)q.dm2w;
  p.dgate = (const T*)q.dgate;
  p.dsender = (const T*)q.dsender;
  p.deres = (const T*)q.deres;
  p.sender = (const T*)q.sender;
  p.env = (const T*)q.env;
  p.scale = (const float*)q.scale;
  p.shift = (const float*)q.shift;
  p.daggr = (const T*)q.daggr;
  p.dst = (const int*)q.dst;
  p.emask = (const uint8_t*)q.emask;
  p.dst_rowptr = (const int*)q.dst_rowptr;
  p.src_perm = (const int*)q.src_perm;
  p.src_rowptr = (const int*)q.src_rowptr;
  p.de = (T*)q.de;
  p.dg_out = (T*)q.dg_buf;
  p.ds_out = (T*)q.ds_buf;
  p.dpre_out = (T*)q.dpre_buf;
  p.h_out = (T*)q.h_buf;
  p.dxi = (float*)q.dxi;
  p.dxj = (float*)q.dxj;
  p.dw = (float*)q.dw;
  p.dbias = (float*)q.dbias;
  p.bias_part = (float*)q.work;
  p.w_part = p.bias_part + (size_t)(E / te) * 4 * d;
  p.E = E;
  p.N = N;
  p.Ns = Ns;
  p.d = d;
  p.ksplit = ksplit_of(E, d, sizeof(T) == 2);
  return p;
}

template <typename T>
cudaError_t launch_reduce(const Args<T>& p, int n_tiles, cudaStream_t stream) {
  const int d = p.d;
  const int nw = (4 * d * d + NTHREADS - 1) / NTHREADS;
  const int nb = (4 * d + NTHREADS - 1) / NTHREADS;
  edge_bwd_reduce<T><<<nw + nb + p.N + p.Ns, NTHREADS, 0, stream>>>(
      p, nw, nb, n_tiles);
  return cudaGetLastError();
}

template <bool MERGED>
cudaError_t launch_f32(const Ptrs& q, int E, int N, int Ns, int d,
                       cudaStream_t stream) {
  const Args<float> p = make_args<float>(q, E, N, Ns, d, TE);
  cudaError_t err = cudaFuncSetAttribute(
      edge_bwd_tile_f32<MERGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)simt::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(edge_bwd_weights_f32<MERGED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)simt::SMEM);
  if (err != cudaSuccess) return err;
  const int n_tiles = E / TE;
  edge_bwd_tile_f32<MERGED><<<n_tiles, simt::THREADS, simt::SMEM, stream>>>(
      p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  edge_bwd_weights_f32<MERGED>
      <<<dim3(n_weight_tiles(d, 0), p.ksplit), simt::THREADS, simt::SMEM,
         stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(p, n_tiles, stream);
}

template <bool MERGED>
cudaError_t launch_bf16(const Ptrs& q, int E, int N, int Ns, int d,
                        cudaStream_t stream) {
  const Args<bf16> p = make_args<bf16>(q, E, N, Ns, d, TE);
  CUtensorMap w1g_m, w1a_m, we_m, e_m, h_m, dpre_m, dg_m, ds_m;
  if (!make_map(&w1g_m, q.w1g, d, d) || !make_map(&w1a_m, q.w1a, d, d) ||
      !make_map(&we_m, q.we, 2 * d, d) || !make_map(&e_m, q.e, d, E) ||
      !make_map(&h_m, q.h_buf, 2 * d, E) ||
      !make_map(&dpre_m, q.dpre_buf, 2 * d, E) ||
      !make_map(&dg_m, q.dg_buf, d, E) ||
      !make_map(&ds_m, MERGED ? q.ds_buf : q.dsender, d, E))
    return cudaErrorInvalidValue;
  const TileLayout L(d);
  if (L.stages < 2 || L.total > (size_t)SMEM_LIMIT)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      edge_bwd_tile_tc<MERGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return err;
  const int n_tiles = E / TE, nsm = num_sms();
  edge_bwd_tile_tc<MERGED>
      <<<n_tiles < nsm ? n_tiles : nsm, TC_THREADS, L.total, stream>>>(
          p, w1g_m, w1a_m, we_m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(edge_bwd_weights_tc<MERGED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)WEIGHT_SMEM);
  if (err != cudaSuccess) return err;
  const int per_split = (E / TE + p.ksplit - 1) / p.ksplit * TE;
  edge_bwd_weights_tc<MERGED>
      <<<dim3(n_weight_tiles(d, 1), p.ksplit), TC_THREADS, WEIGHT_SMEM,
         stream>>>(p, per_split, e_m, h_m, dpre_m, dg_m, ds_m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(p, n_tiles, stream);
}

}  // namespace

// C entry points (bound with ctypes). d % 128 == 0, d <= 512, E % 64 == 0,
// E > 0; every T tensor is bf16 (bf16 = 1) or f32 (0), 16-byte aligned; the
// moments/meanw are f32 [E / 64, d]; index tensors int32; emask bool.
// dg_buf [E, d] and dpre_buf [E, 2d] (T), h_buf [E, 2d] (bf16 only; null in
// f32) and work (edge_phase_bwd_workspace floats) are scratch. dw receives
// dWe | dW1g | dW1a, dbias db | db1g | db1a. live: the two live counts (two
// int32 on the device; null: every edge), which the f32 passes read and
// the bf16 ones ignore. Three launches each; they
// return cudaGetLastError() after them (cudaErrorInvalidValue when a
// tensor map cannot be made). N is dxi's row count (dst_rowptr has N + 1
// entries), Ns dxj's (src_rowptr has Ns + 1): they differ where the src
// table is longer than the dst one (halo partitioning), and K5/K6 then
// write dxj over Ns rows.

// K5: saved is [pre | sig] [E, 4d]
extern "C" int edge_phase_bwd(
    const void* e, const void* we, const void* w1g, const void* w1a,
    const void* saved, const void* gate, const void* meanw, const void* ds1w,
    const void* dm2w, const void* dgate, const void* dsender,
    const void* deres, const void* emask, const void* dst_rowptr,
    const void* src_perm, const void* src_rowptr, void* de, void* dg_buf,
    void* dpre_buf, void* h_buf, void* dxi, void* dxj, void* dw, void* dbias,
    void* work, const void* live, int E, int N, int Ns, int d, int is_bf16,
    void* stream) {
  Ptrs q{};
  q.e = e; q.we = we; q.w1g = w1g; q.w1a = w1a; q.saved = saved;
  q.gate = gate; q.meanw = meanw; q.ds1w = ds1w; q.dm2w = dm2w;
  q.dgate = dgate; q.dsender = dsender; q.deres = deres; q.emask = emask;
  q.dst_rowptr = dst_rowptr; q.src_perm = src_perm;
  q.src_rowptr = src_rowptr; q.de = de; q.dg_buf = dg_buf;
  q.dpre_buf = dpre_buf; q.h_buf = h_buf; q.dxi = dxi; q.dxj = dxj;
  q.dw = dw; q.dbias = dbias; q.work = work; q.live = live;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_bf16<false>(q, E, N, Ns, d, s)
                 : launch_f32<false>(q, E, N, Ns, d, s);
}

// K6: pre is the rounded pre alone [E, 2d]; sender, deout [E, d] and env
// [E] in T; scale/shift f32 [d]; daggr [N, d] in T; dst int32 [E];
// ds_buf [E, d] (T) is scratch too
extern "C" int edge_phase_merged_bwd(
    const void* e, const void* we, const void* w1g, const void* w1a,
    const void* pre, const void* gate, const void* sender, const void* env,
    const void* scale, const void* shift, const void* meanw,
    const void* ds1w, const void* dm2w, const void* deout, const void* daggr,
    const void* dst, const void* emask, const void* dst_rowptr,
    const void* src_perm, const void* src_rowptr, void* de, void* dg_buf,
    void* ds_buf, void* dpre_buf, void* h_buf, void* dxi, void* dxj,
    void* dw, void* dbias, void* work, const void* live, int E, int N, int Ns,
    int d, int is_bf16, void* stream) {
  Ptrs q{};
  q.e = e; q.we = we; q.w1g = w1g; q.w1a = w1a; q.saved = pre;
  q.gate = gate; q.sender = sender; q.env = env; q.scale = scale;
  q.shift = shift; q.meanw = meanw; q.ds1w = ds1w; q.dm2w = dm2w;
  q.deres = deout; q.daggr = daggr; q.dst = dst; q.emask = emask;
  q.dst_rowptr = dst_rowptr; q.src_perm = src_perm;
  q.src_rowptr = src_rowptr; q.de = de; q.dg_buf = dg_buf;
  q.ds_buf = ds_buf; q.dpre_buf = dpre_buf; q.h_buf = h_buf; q.dxi = dxi;
  q.dxj = dxj; q.dw = dw; q.dbias = dbias; q.work = work; q.live = live;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_bf16<true>(q, E, N, Ns, d, s)
                 : launch_f32<true>(q, E, N, Ns, d, s);
}

// floats of scratch that edge_phase_bwd needs in ``work``
extern "C" long long edge_phase_bwd_workspace(int E, int d, int is_bf16) {
  return (long long)(E / TE) * 4 * d +
         (long long)ksplit_of(E, d, is_bf16) * 4 * d * d;
}

// dynamic shared memory (bytes) of the tile pass (f32: the weight pass's
// too)
extern "C" long long edge_phase_bwd_smem(int d, int is_bf16) {
  return is_bf16 ? (long long)TileLayout(d).total : (long long)simt::SMEM;
}
