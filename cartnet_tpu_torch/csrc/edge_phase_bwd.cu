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
// What bounds it: 8 E d^2 multiply-adds (22 GFLOP at E = 20992, d = 256)
// against ~107 MB of unavoidable bf16 traffic, so at the tensor-core rate
// memory bounds it (~32 us); with f32 operands (no TF32) the f32 FMA rate
// bounds it (~0.33 ms).
//
// Design: three launches, no atomics, every sum in a fixed order, so the
// results are bitwise repeatable.
//   1. tile pass, one block per TE1 edges: forms dg (and its bias column
//      sums), runs dh = [dg|ds] @ W1^T on the tile held in shared memory,
//      the silu' chain, then de = deres + dpre_c @ We^T; writes de, dg_c and
//      dpre_c and per-tile column sums of dpre, dg and ds.
//   2. weight pass, output-tiled (64 x 128 tiles of dWe, dW1g, dW1a) and
//      split over KSPLIT edge ranges: each block walks its edges in order,
//      recomputing h from the saved residual; partials per split.
//   3. reduce pass: the split partials in split order, the per-tile bias
//      partials in tile order, and the dxi / dxj CSR row reduces (dst rows
//      over dst_rowptr; src rows over src_rowptr through src_perm, the
//      masked-in edges of each chunk compacted in order by warp ballots).
// bf16 products run on the tensor cores through WMMA (mma.sync, f32
// accumulation); f32 products run on the CUDA cores (full f32, no TF32).
// Elementwise steps use explicitly rounded operations so nvcc contracts
// nothing into an FMA that the plain PyTorch version does not have.
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
// outside, as the Pallas op does). The rest is the three passes above, with
// the same bound, sharing their code through the MERGED template flag.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 256;  // 8 warps
constexpr int CN = 128;        // output columns per chunk (pass 1)
constexpr int LDC = CN + 4;    // f32 chunk stride
constexpr int MOM = 64;        // edges per moment window (the forward's)
constexpr int KSPLIT = 4;      // edge ranges of the weight pass
constexpr int WR = 64, WC = 128;  // weight-pass output tile
constexpr int MAXF = 4;        // pass 3: 2d <= MAXF * NTHREADS

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// per-dtype tiling: bf16 -> WMMA, f32 -> register-tiled FMA
template <typename T> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int TE1 = 64;  // edges per pass-1 block
  static constexpr int PAD = 8;   // row padding (16 bytes)
  static constexpr int KW = 64;   // weight rows staged per step (pass 1)
  static constexpr int KE = 64;   // edges staged per step (pass 2)
};
template <> struct Cfg<float> {
  static constexpr int TE1 = 32;
  static constexpr int PAD = 4;
  static constexpr int KW = 16;
  static constexpr int KE = 32;
};

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
  const T* daggr;   // [N, d]
  const int* dst;
  const uint8_t* emask;
  const int* dst_rowptr;
  const int* src_perm;
  const int* src_rowptr;
  T* de;
  T* dg_out;    // [E, d]   rounded dg
  T* ds_out;    // [E, d]   merged: rounded ds
  T* dpre_out;  // [E, 2d]  dpre_c
  float* dxi;   // [N, 2d]
  float* dxj;   // [N, 2d]
  float* dw;    // [4 d^2]  dWe [d, 2d] | dW1g [d, d] | dW1a [d, d]
  float* dbias; // [4 d]    db [2d] | db1g [d] | db1a [d]
  float* bias_part;  // [E / TE1, 4d]
  float* w_part;     // [KSPLIT, 4 d^2]
  int E, N, d;
};

// shared-memory layout of the tile pass (bytes)
template <typename T>
struct Layout1 {
  size_t a, p, w, c, m, total;
  __host__ __device__ explicit Layout1(int d) {
    constexpr int TE1 = Cfg<T>::TE1, PAD = Cfg<T>::PAD;
    a = 0;
    p = a + align128(sizeof(T) * TE1 * (d + PAD));
    w = p + align128(sizeof(T) * TE1 * (2 * d + PAD));
    const size_t wbytes = sizeof(T) == 2
        ? sizeof(T) * CN * (Cfg<T>::KW + PAD)    // [CN][KW + PAD]
        : sizeof(T) * Cfg<T>::KW * (CN + PAD);   // [KW][CN + PAD]
    c = w + align128(wbytes);
    m = c + align128(sizeof(float) * TE1 * LDC);
    total = m + sizeof(float) * TE1;
  }
};

// ------------------------------------------------ pass-1 products C = A W^T
// c_s[r][j] = sum_k A[r][k] * W[c0 + j][k], r < TE1, j < CN. A: rows in
// shared memory (stride lda); W: row-major [*, ldw] in device memory.

// bf16: warp w owns rows 16 (w % 4) and the four 16-column tiles from
// 64 (w / 4); W chunks are staged as [j][k] and read as col-major B.
__device__ __forceinline__ void gemm_nt(const bf16* A, int lda,
                                        const bf16* __restrict__ W, int ldw,
                                        int K, int c0, bf16* w_s,
                                        float* c_s) {
  using namespace nvcuda;
  constexpr int KW = Cfg<bf16>::KW, LDW = KW + Cfg<bf16>::PAD;
  const int tid = threadIdx.x, warp = tid / 32;
  const int row0 = 16 * (warp % 4), col0 = 64 * (warp / 4);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int k0 = 0; k0 < K; k0 += KW) {
    for (int i = tid; i < CN * KW / 8; i += NTHREADS) {
      const int j = i / (KW / 8), kk = 8 * (i % (KW / 8));
      *reinterpret_cast<uint4*>(&w_s[j * LDW + kk]) =
          *reinterpret_cast<const uint4*>(&W[(size_t)(c0 + j) * ldw + k0 +
                                             kk]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KW; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + row0 * lda + k0 + kk, lda);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
        wmma::load_matrix_sync(bm, w_s + (col0 + 16 * j) * LDW + kk, LDW);
        wmma::mma_sync(acc[j], a, bm, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(c_s + row0 * LDC + col0 + 16 * j, acc[j], LDC,
                            wmma::mem_row_major);
  __syncthreads();
}

// column of a thread's j-th output inside a 128-wide tile: two groups of
// four adjacent columns, 64 apart, so the float4 reads of a warp are dense
__device__ __forceinline__ int col_of(int tx, int j) {
  return (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

// f32: 16 x 16 threads, each 2 rows x 8 columns of the 32 x 128 chunk;
// W chunks are staged transposed as [k][j]
__device__ __forceinline__ void gemm_nt(const float* A, int lda,
                                        const float* __restrict__ W, int ldw,
                                        int K, int c0, float* w_s,
                                        float* c_s) {
  constexpr int KC = Cfg<float>::KW, LDW = CN + Cfg<float>::PAD;
  constexpr int TM = Cfg<float>::TE1 / 16;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[TM][8] = {};
  for (int k0 = 0; k0 < K; k0 += KC) {
    for (int i = tid; i < KC * CN; i += NTHREADS) {
      const int kk = i % KC, j = i / KC;
      w_s[kk * LDW + j] = W[(size_t)(c0 + j) * ldw + k0 + kk];
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
            *reinterpret_cast<const float4*>(&w_s[(kk + q) * LDW + tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(
            &w_s[(kk + q) * LDW + 64 + tx * 4]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = q == 0 ? a4[i].x
                         : q == 1 ? a4[i].y
                         : q == 2 ? a4[i].z
                                  : a4[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      c_s[(ty * TM + i) * LDC + col_of(tx, j)] = acc[i][j];
  __syncthreads();
}

// column sums over the tile's rows of a [TE1][ld] T tile -> out[0:n)
template <typename T, int TE1>
__device__ __forceinline__ void column_sums(const T* s, int ld, int n,
                                            float* out) {
  for (int c = threadIdx.x; c < n; c += NTHREADS) {
    float acc = 0.f;
    for (int r = 0; r < TE1; ++r) acc = __fadd_rn(acc, to_f(s[r * ld + c]));
    out[c] = acc;
  }
}

// ------------------------------------------------------------ pass 1: tile
template <typename T, bool MERGED>
__global__ void __launch_bounds__(NTHREADS) edge_bwd_tile(Args<T> p) {
  constexpr int TE1 = Cfg<T>::TE1, PAD = Cfg<T>::PAD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int d = p.d, d2 = 2 * d, d4 = 4 * d;
  const int lda = d + PAD, ldp = d2 + PAD;
  const Layout1<T> L(d);
  T* a_s = reinterpret_cast<T*>(smem_raw + L.a);         // dg, then ds
  T* p_s = reinterpret_cast<T*>(smem_raw + L.p);         // dpre_c
  T* w_s = reinterpret_cast<T*>(smem_raw + L.w);
  float* c_s = reinterpret_cast<float*>(smem_raw + L.c);  // [TE1][LDC]
  float* m_s = reinterpret_cast<float*>(smem_raw + L.m);
  const int tid = threadIdx.x;
  const size_t e0 = (size_t)blockIdx.x * TE1;
  float* bpart = p.bias_part + (size_t)blockIdx.x * d4;

  if (tid < TE1) m_s[tid] = p.emask[e0 + tid] ? 1.f : 0.f;
  __syncthreads();
  // dg with the window-moment cotangents folded in, rounded to cdt; merged,
  // the gate's cotangent comes from the sigma backward, which also gives ds
  for (int i = tid; i < TE1 * d; i += NTHREADS) {
    const int r = i / d, c = i % d;
    const size_t o = (e0 + r) * d + c;
    const size_t w = ((e0 + r) / MOM) * d + c;
    const float g = to_f(p.gate[o]);
    const float corr = __fadd_rn(
        p.ds1w[w], __fmul_rn(__fmul_rn(2.f, p.dm2w[w]),
                             __fadd_rn(g, -p.meanw[w])));
    float dgate;
    if constexpr (MERGED) {
      const float dvals =
          m_s[r] != 0.f ? to_f(p.daggr[(size_t)p.dst[e0 + r] * d + c]) : 0.f;
      const float sig0 =
          sigmoid_f(__fadd_rn(__fmul_rn(g, p.scale[c]), p.shift[c]));
      const float env = to_f(p.env[e0 + r]);
      const float dsig =
          __fadd_rn(to_f(p.deres[o]), __fmul_rn(dvals, to_f(p.sender[o])));
      const float da = __fmul_rn(__fmul_rn(__fmul_rn(dsig, env), sig0),
                                 __fadd_rn(1.f, -sig0));
      p.ds_out[o] = from_f<T>(__fmul_rn(__fmul_rn(dvals, sig0), env));
      dgate = __fmul_rn(da, p.scale[c]);
    } else {
      dgate = to_f(p.dgate[o]);
    }
    const T v = from_f<T>(__fadd_rn(dgate, __fmul_rn(m_s[r], corr)));
    a_s[r * lda + c] = v;
    p.dg_out[o] = v;
  }
  __syncthreads();
  column_sums<T, TE1>(a_s, lda, d, bpart + d2);  // db1g

  for (int half = 0; half < 2; ++half) {
    if (half == 1) {  // ds replaces dg in the A tile
      __syncthreads();  // also makes this block's ds_out writes visible
      const T* ds = MERGED ? p.ds_out : p.dsender;
      for (int i = tid; i < TE1 * d; i += NTHREADS) {
        const int r = i / d, c = i % d;
        a_s[r * lda + c] = ds[(e0 + r) * d + c];
      }
      __syncthreads();
      column_sums<T, TE1>(a_s, lda, d, bpart + d2 + d);  // db1a
    }
    const T* w1 = half ? p.w1a : p.w1g;
    for (int c0 = 0; c0 < d; c0 += CN) {
      gemm_nt(a_s, lda, w1, d, d, c0, w_s, c_s);  // dh chunk
      for (int i = tid; i < TE1 * CN; i += NTHREADS) {
        const int r = i / CN, cl = i % CN, pc = half * d + c0 + cl;
        const T* srow = p.saved + (e0 + r) * (MERGED ? d2 : d4);
        const float pre = to_f(srow[pc]);
        const float sg = MERGED ? sigmoid_f(pre) : to_f(srow[d2 + pc]);
        const float h32 = __fmul_rn(pre, sg);
        const float dpre = __fmul_rn(
            c_s[r * LDC + cl],
            __fadd_rn(sg, __fmul_rn(h32, __fadd_rn(1.f, -sg))));
        c_s[r * LDC + cl] = dpre;
        const T v = from_f<T>(dpre);
        p_s[r * ldp + pc] = v;
        p.dpre_out[(e0 + r) * d2 + pc] = v;
      }
      __syncthreads();
      if (tid < CN) {  // db: column sums of the unrounded dpre
        float s = 0.f;
        for (int r = 0; r < TE1; ++r) s = __fadd_rn(s, c_s[r * LDC + tid]);
        bpart[half * d + c0 + tid] = s;
      }
      // the next gemm_nt rewrites c_s only after its own barriers
    }
  }
  __syncthreads();
  for (int c0 = 0; c0 < d; c0 += CN) {  // de = deres + dpre_c @ We^T
    gemm_nt(p_s, ldp, p.we, d2, d2, c0, w_s, c_s);
    for (int i = tid; i < TE1 * CN; i += NTHREADS) {
      const int r = i / CN, cl = i % CN;
      const size_t o = (e0 + r) * d + c0 + cl;
      p.de[o] = from_f<T>(__fadd_rn(to_f(p.deres[o]), c_s[r * LDC + cl]));
    }
  }
}

// ---------------------------------------------------------- pass 2: weights
// stage rows [c, c + KE) of the A source (64 columns from col) into
// at_s[r][k]: e itself (hoff < 0) or h = pre * sig -> cdt recomputed from
// the saved residual (hoff = 0 gate half, d aggregate half); merged, sig is
// recomputed from pre as well
template <typename T, bool MERGED>
__device__ __forceinline__ void stage_a(const Args<T>& p, int hoff, size_t c,
                                        int col, T* at_s, int ld) {
  constexpr int KE = Cfg<T>::KE, V = 16 / sizeof(T);  // 16-byte vectors
  const int d = p.d;
  for (int i = threadIdx.x; i < KE * WR / V; i += NTHREADS) {
    const int r = i / (WR / V), k = V * (i % (WR / V));
    uint4 out;
    if (hoff < 0) {
      out = *reinterpret_cast<const uint4*>(&p.e[(c + r) * d + col + k]);
    } else if (MERGED) {
      const uint4 pr = *reinterpret_cast<const uint4*>(
          p.saved + (c + r) * 2 * d + hoff + col + k);
      const T* pv = reinterpret_cast<const T*>(&pr);
      T* ov = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float x = to_f(pv[v]);
        ov[v] = from_f<T>(__fmul_rn(x, sigmoid_f(x)));
      }
    } else {
      const T* srow = p.saved + (c + r) * 4 * d + hoff + col + k;
      const uint4 pr = *reinterpret_cast<const uint4*>(srow);
      const uint4 sr = *reinterpret_cast<const uint4*>(srow + 2 * d);
      const T* pv = reinterpret_cast<const T*>(&pr);
      const T* sv = reinterpret_cast<const T*>(&sr);
      T* ov = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int v = 0; v < V; ++v)
        ov[v] = from_f<T>(__fmul_rn(to_f(pv[v]), to_f(sv[v])));
    }
    *reinterpret_cast<uint4*>(&at_s[r * ld + k]) = out;
  }
}

template <typename T>
__device__ __forceinline__ void stage_b(const T* src, int lds, size_t c,
                                        int col, T* b_s, int ld) {
  constexpr int KE = Cfg<T>::KE, V = 16 / sizeof(T);
  for (int i = threadIdx.x; i < KE * WC / V; i += NTHREADS) {
    const int r = i / (WC / V), k = V * (i % (WC / V));
    *reinterpret_cast<uint4*>(&b_s[r * ld + k]) =
        *reinterpret_cast<const uint4*>(&src[(c + r) * lds + col + k]);
  }
}

// which weight-gradient tile this block owns
struct WTile {
  int mat, rt, ct, ld_out;
  size_t off;  // offset of the matrix inside the 4 d^2 block
};

__device__ __forceinline__ WTile weight_tile(int t, int d) {
  const int nr = d / WR, nc0 = 2 * d / WC, nc1 = d / WC;
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

// bf16: dW tile += At^T B over KE-edge chunks on the tensor cores
template <bool MERGED>
__device__ __forceinline__ void weight_tile_loop(const Args<bf16>& p,
                                                 const WTile& w, size_t ebeg,
                                                 size_t eend, float* out) {
  using namespace nvcuda;
  constexpr int KE = Cfg<bf16>::KE, PAD = Cfg<bf16>::PAD;
  constexpr int LDA = WR + PAD, LDB = WC + PAD;
  __shared__ __align__(128) bf16 at_s[KE * LDA];
  __shared__ __align__(128) bf16 b_s[KE * LDB];
  const int d = p.d, warp = threadIdx.x / 32;
  const int row0 = 16 * (warp % 4), col0 = 64 * (warp / 4);
  const int hoff = w.mat == 0 ? -1 : (w.mat == 1 ? 0 : d);
  const bf16* bsrc = w.mat == 0 ? p.dpre_out
                   : w.mat == 1 ? p.dg_out : MERGED ? p.ds_out : p.dsender;
  const int ldb_src = w.mat == 0 ? 2 * d : d;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (size_t c = ebeg; c < eend; c += KE) {
    stage_a<bf16, MERGED>(p, hoff, c, w.rt * WR, at_s, LDA);
    stage_b(bsrc, ldb_src, c, w.ct * WC, b_s, LDB);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KE; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::load_matrix_sync(a, at_s + kk * LDA + row0, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(bm, b_s + kk * LDB + col0 + 16 * j, LDB);
        wmma::mma_sync(acc[j], a, bm, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(out + (size_t)row0 * w.ld_out + col0 + 16 * j,
                            acc[j], w.ld_out, wmma::mem_row_major);
}

// f32: 16 x 16 threads, each 4 rows x 8 columns of the 64 x 128 tile
template <bool MERGED>
__device__ __forceinline__ void weight_tile_loop(const Args<float>& p,
                                                 const WTile& w, size_t ebeg,
                                                 size_t eend, float* out) {
  constexpr int KE = Cfg<float>::KE, PAD = Cfg<float>::PAD;
  constexpr int LDA = WR + PAD, LDB = WC + PAD;
  __shared__ __align__(128) float at_s[KE * LDA];
  __shared__ __align__(128) float b_s[KE * LDB];
  const int d = p.d, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int hoff = w.mat == 0 ? -1 : (w.mat == 1 ? 0 : d);
  const float* bsrc = w.mat == 0 ? p.dpre_out
                    : w.mat == 1 ? p.dg_out : MERGED ? p.ds_out : p.dsender;
  const int ldb_src = w.mat == 0 ? 2 * d : d;
  float acc[4][8] = {};
  for (size_t c = ebeg; c < eend; c += KE) {
    stage_a<float, MERGED>(p, hoff, c, w.rt * WR, at_s, LDA);
    stage_b(bsrc, ldb_src, c, w.ct * WC, b_s, LDB);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < KE; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&at_s[r * LDA + ty * 4]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&b_s[r * LDB + tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&b_s[r * LDB + 64 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[(size_t)(ty * 4 + i) * w.ld_out + col_of(tx, j)] = acc[i][j];
}

template <typename T, bool MERGED>
__global__ void __launch_bounds__(NTHREADS)
    edge_bwd_weights(Args<T> p, int per_split) {
  const int d = p.d;
  const WTile w = weight_tile(blockIdx.x, d);
  const size_t ebeg = (size_t)blockIdx.y * per_split;
  const size_t eend = ebeg + per_split < (size_t)p.E ? ebeg + per_split
                                                     : (size_t)p.E;
  float* out = p.w_part + (size_t)blockIdx.y * 4 * d * d + w.off +
               (size_t)w.rt * WR * w.ld_out + w.ct * WC;
  weight_tile_loop<MERGED>(p, w, ebeg, ebeg < eend ? eend : ebeg, out);
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
      for (int k = 0; k < KSPLIT; ++k) s = __fadd_rn(s, p.w_part[k * n + i]);
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
  // node row: dst rows first, then src rows (through src_perm)
  const bool src_side = b >= p.N;
  const int row = src_side ? b - p.N : b;
  const int* rowptr = src_side ? p.src_rowptr : p.dst_rowptr;
  float* out = src_side ? p.dxj : p.dxi;
  const int beg = rowptr[row], end = rowptr[row + 1];
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

// the operands of one call, untyped, as the C entry points receive them
// (the pointers a pass does not read stay null)
struct Ptrs {
  const void *e, *we, *w1g, *w1a, *saved, *gate, *meanw, *ds1w, *dm2w,
      *dgate, *dsender, *deres, *sender, *env, *scale, *shift, *daggr, *dst,
      *emask, *dst_rowptr, *src_perm, *src_rowptr;
  void *de, *dg_buf, *ds_buf, *dpre_buf, *dxi, *dxj, *dw, *dbias, *work;
};

template <typename T, bool MERGED>
cudaError_t launch(const Ptrs& q, int E, int N, int d, cudaStream_t stream) {
  Args<T> p{};
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
  p.dxi = (float*)q.dxi;
  p.dxj = (float*)q.dxj;
  p.dw = (float*)q.dw;
  p.dbias = (float*)q.dbias;
  p.bias_part = (float*)q.work;
  p.w_part = p.bias_part + (size_t)(E / Cfg<T>::TE1) * 4 * d;
  p.E = E;
  p.N = N;
  p.d = d;

  const size_t smem = Layout1<T>(d).total;
  cudaError_t err = cudaFuncSetAttribute(
      edge_bwd_tile<T, MERGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = E / Cfg<T>::TE1;
  edge_bwd_tile<T, MERGED><<<n_tiles, NTHREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int KE = Cfg<T>::KE;
  const int per_split = (E / KE + KSPLIT - 1) / KSPLIT * KE;
  const int n_wtiles = (d / WR) * (4 * d / WC);
  edge_bwd_weights<T, MERGED>
      <<<dim3(n_wtiles, KSPLIT), NTHREADS, 0, stream>>>(p, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int nw = (4 * d * d + NTHREADS - 1) / NTHREADS;
  const int nb = (4 * d + NTHREADS - 1) / NTHREADS;
  edge_bwd_reduce<T><<<nw + nb + 2 * N, NTHREADS, 0, stream>>>(p, nw, nb,
                                                               n_tiles);
  return cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes). d % 128 == 0, d <= 256, E % 64 == 0,
// E > 0; every T tensor is bf16 (bf16 = 1) or f32 (0); the
// moments/meanw are f32 [E / 64, d]; index tensors int32; emask bool.
// dg_buf [E, d] and dpre_buf [E, 2d] (T) and work (edge_phase_bwd_workspace
// floats) are scratch. dw receives dWe | dW1g | dW1a, dbias db | db1g | db1a.
// Three launches each; they return cudaGetLastError() after them.

// K5: saved is [pre | sig] [E, 4d]
extern "C" int edge_phase_bwd(
    const void* e, const void* we, const void* w1g, const void* w1a,
    const void* saved, const void* gate, const void* meanw, const void* ds1w,
    const void* dm2w, const void* dgate, const void* dsender,
    const void* deres, const void* emask, const void* dst_rowptr,
    const void* src_perm, const void* src_rowptr, void* de, void* dg_buf,
    void* dpre_buf, void* dxi, void* dxj, void* dw, void* dbias, void* work,
    int E, int N, int d, int is_bf16, void* stream) {
  Ptrs q{};
  q.e = e; q.we = we; q.w1g = w1g; q.w1a = w1a; q.saved = saved;
  q.gate = gate; q.meanw = meanw; q.ds1w = ds1w; q.dm2w = dm2w;
  q.dgate = dgate; q.dsender = dsender; q.deres = deres; q.emask = emask;
  q.dst_rowptr = dst_rowptr; q.src_perm = src_perm;
  q.src_rowptr = src_rowptr; q.de = de; q.dg_buf = dg_buf;
  q.dpre_buf = dpre_buf; q.dxi = dxi; q.dxj = dxj; q.dw = dw;
  q.dbias = dbias; q.work = work;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<bf16, false>(q, E, N, d, s)
                 : launch<float, false>(q, E, N, d, s);
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
    void* ds_buf, void* dpre_buf, void* dxi, void* dxj, void* dw,
    void* dbias, void* work, int E, int N, int d, int is_bf16,
    void* stream) {
  Ptrs q{};
  q.e = e; q.we = we; q.w1g = w1g; q.w1a = w1a; q.saved = pre;
  q.gate = gate; q.sender = sender; q.env = env; q.scale = scale;
  q.shift = shift; q.meanw = meanw; q.ds1w = ds1w; q.dm2w = dm2w;
  q.deres = deout; q.daggr = daggr; q.dst = dst; q.emask = emask;
  q.dst_rowptr = dst_rowptr; q.src_perm = src_perm;
  q.src_rowptr = src_rowptr; q.de = de; q.dg_buf = dg_buf;
  q.ds_buf = ds_buf; q.dpre_buf = dpre_buf; q.dxi = dxi; q.dxj = dxj;
  q.dw = dw; q.dbias = dbias; q.work = work;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<bf16, true>(q, E, N, d, s)
                 : launch<float, true>(q, E, N, d, s);
}

// floats of scratch that edge_phase_bwd needs in ``work``
extern "C" long long edge_phase_bwd_workspace(int E, int d, int is_bf16) {
  const int te1 = is_bf16 ? Cfg<bf16>::TE1 : Cfg<float>::TE1;
  return (long long)(E / te1) * 4 * d + (long long)KSPLIT * 4 * d * d;
}

// dynamic shared memory (bytes) of the tile pass
extern "C" long long edge_phase_bwd_smem(int d, int is_bf16) {
  return is_bf16 ? (long long)Layout1<bf16>(d).total
                 : (long long)Layout1<float>(d).total;
}
