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
// by the matmuls for bf16 ones, both near 11-17 us. With bf16 edges this
// kernel runs its three products on the tensor cores through WMMA
// (mma.sync, bf16 operands, f32 accumulation); with f32 edges it runs a
// register-tiled FMA GEMM on the CUDA cores (full f32, no TF32), bound by
// the f32 FMA rate. Neither uses wgmma/TMA yet: operands are staged through
// shared memory by the threads, and one block per SM is resident.
//
// Design: one block per tile of TE edges. The block gathers xi[dst] and
// xj[src] rows directly by index (the TPU's banded one-hot gathers are not
// needed) and works one half of pre at a time: the gate half's h = silu(pre)
// [TE, d] tile in shared memory feeds the gate product, then the aggregate
// half's tile (in the same place) feeds the sender product, so the [E, 2d]
// pre/h intermediates never reach device memory and d <= 512 fits in
// shared memory. The e tile is staged too where it fits (bf16 edges always;
// f32 edges up to d = 384), else the phase-1 product reads e from device
// memory. Weight chunks are staged through shared memory. Every sum runs in
// a fixed order, so results are bitwise repeatable. The elementwise
// epilogue uses explicitly rounded adds/multiplies so nothing is contracted
// into an FMA that the plain PyTorch version does not have.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

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

// --------------------------------------------------- bf16 edges: WMMA

constexpr int KW = 64;         // weight rows staged per step
constexpr int PAD16 = 8;       // bf16 row padding (16 bytes)
constexpr int LDW = CN + PAD16;
constexpr int LDC = CN + 4;    // f32 accumulator tile stride

// c_s[TE][LDC] = A[0:TE, 0:K] @ W[0:K, c0:c0+CN]; A: bf16 rows in shared
// memory (stride lda); W: row-major bf16 [K, ldw] in device memory. Warp w
// owns rows 16*(w%4) and the four 16-column tiles starting at 64*(w/4).
__device__ __forceinline__ void gemm_wmma(const bf16* A, int lda,
                                          const bf16* __restrict__ W,
                                          int ldw, int K, int c0, bf16* w_s,
                                          float* c_s) {
  using namespace nvcuda;
  const int tid = threadIdx.x, warp = tid / 32;
  const int row0 = 16 * (warp % 4), col0 = 64 * (warp / 4);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int k0 = 0; k0 < K; k0 += KW) {
    for (int i = tid; i < KW * CN / 8; i += NTHREADS) {  // 16-byte vectors
      const int kk = i / (CN / 8), cc = 8 * (i % (CN / 8));
      *reinterpret_cast<uint4*>(&w_s[kk * LDW + cc]) =
          *reinterpret_cast<const uint4*>(&W[(size_t)(k0 + kk) * ldw + c0 +
                                             cc]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KW; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + row0 * lda + k0 + kk, lda);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(bm, w_s + kk * LDW + col0 + 16 * j, LDW);
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

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// shared-memory layout of the WMMA kernel (bytes)
struct TcLayout {
  size_t e, h, w, c, ids, total;
  __host__ __device__ explicit TcLayout(int d)
      : e(0),
        h(align128(sizeof(bf16) * TE * (d + PAD16))),
        w(h + align128(sizeof(bf16) * TE * (d + PAD16))),
        c(w + align128(sizeof(bf16) * KW * LDW)),
        ids(c + align128(sizeof(float) * TE * LDC)),
        total(ids + sizeof(int) * 3 * TE) {}
};

template <typename TT>
__global__ void __launch_bounds__(NTHREADS)
    edge_phase_fwd_wmma(Args<TT, bf16> p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int d = p.d, d2 = 2 * d, lda = d + PAD16, ldh = d + PAD16;
  const TcLayout L(d);
  bf16* e_s = reinterpret_cast<bf16*>(smem_raw + L.e);   // [TE][lda]
  bf16* h_s = reinterpret_cast<bf16*>(smem_raw + L.h);   // [TE][ldh], a half
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw + L.w);   // [KW][LDW]
  float* c_s = reinterpret_cast<float*>(smem_raw + L.c); // [TE][LDC]
  int* dst_s = reinterpret_cast<int*>(smem_raw + L.ids);
  int* src_s = dst_s + TE;
  float* m_s = reinterpret_cast<float*>(src_s + TE);
  const int tid = threadIdx.x;
  const size_t e0 = (size_t)blockIdx.x * TE;

  if (tid < TE) {
    dst_s[tid] = p.dst[e0 + tid];
    src_s[tid] = p.src[e0 + tid];
    m_s[tid] = p.emask[e0 + tid] ? 1.f : 0.f;
  }
  for (int i = tid; i < TE * d / 8; i += NTHREADS) {  // 16-byte vectors
    const int r = i / (d / 8), c = 8 * (i % (d / 8));
    *reinterpret_cast<uint4*>(&e_s[r * lda + c]) =
        *reinterpret_cast<const uint4*>(&p.e[(e0 + r) * d + c]);
  }
  __syncthreads();

  for (int half = 0; half < 2; ++half) {
    for (int c0 = 0; c0 < d; c0 += CN) {  // phase 1, this half of pre
      gemm_wmma(e_s, lda, p.we, d2, d, half * d + c0, w_s, c_s);
      for (int i = tid; i < TE * CN; i += NTHREADS) {
        const int r = i / CN, cl = i % CN;
        h_s[r * ldh + c0 + cl] = from_f<bf16>(
            phase1_element(p, e0, r, half * d + c0 + cl, dst_s[r], src_s[r],
                           c_s[r * LDC + cl]));
      }
      // the next gemm_wmma rewrites c_s only after its own barriers
    }
    __syncthreads();

    const bf16* w1 = half ? p.w1a : p.w1g;  // phase 2, this half's product
    const bf16* b1 = half ? p.b1a : p.b1g;
    TT* out = half ? p.sender : p.gate;
    const bool mom = half == 0 && p.s1w != nullptr;
    for (int c0 = 0; c0 < d; c0 += CN) {
      gemm_wmma(h_s, ldh, w1, d, d, c0, w_s, c_s);
      for (int i = tid; i < TE * CN; i += NTHREADS) {
        const int r = i / CN, cl = i % CN;
        const TT o =
            from_f<TT>(__fadd_rn(c_s[r * LDC + cl], to_f(b1[c0 + cl])));
        out[(e0 + r) * d + c0 + cl] = o;
        if (mom) c_s[r * LDC + cl] = to_f(o);  // same thread, same element
      }
      __syncthreads();
      if (mom) {
        window_moments(c_s, LDC, m_s, p.s1w, p.m2w,
                       (size_t)blockIdx.x * d + c0);
        __syncthreads();
      }
    }
  }
}

template <typename TT, typename ET>
cudaError_t launch(const Args<TT, ET>& p, int E, cudaStream_t stream) {
  const int d = p.d;
  size_t smem;
  void (*kern)(Args<TT, ET>);
  if constexpr (sizeof(ET) == 2) {
    smem = TcLayout(d).total;
    kern = edge_phase_fwd_wmma<TT>;
  } else {
    smem = fma_smem(d, p.stage_e != 0);
    kern = edge_phase_fwd_fma<TT>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<E / TE, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

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

// C entry point (bound with ctypes). E % 64 == 0, d % 128 == 0, d <= 512.
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
