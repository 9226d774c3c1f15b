// Masked CSR segment sum, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cartnet_tpu/ops/pallas/segment_kernels.py:
// segment_sum_sorted_window -> _seg_kernel, at its call site
// cartnet_tpu/ops/segment.py::segment_sum_presorted. For every row n:
//   out[n, :] = sum over k in [rowptr[n], rowptr[n+1]) with mask[k] of
//               values[perm[k], :]        (values[k, :] when perm is null)
// summed in f32 in ascending k and rounded once to the values' dtype.
// With perm = edge_src_perm, rowptr = src_rowptr and mask =
// edge_mask_src_sorted this is the eComformer scatter onto edge sources
// without the [E, D] permute pass; with perm = null, rowptr = dst_rowptr and
// mask = edge_mask it is the sum over edges already sorted by destination.
//
// What bounds it: one read of the masked-in rows of values plus the
// [N, D] output and the index arrays, a few bytes per flop: device memory.
//
// Design: one block per row. Pads sit in long masked-out runs at the end of
// a graph's last row (per-graph alignment pads) and on the last row (tail
// pads), so the block first compacts the row's masked-in positions: each
// thread tests 16 mask bytes at a time, a block-wide scan orders the hits,
// and their positions land in a shared list in ascending k, which the
// threads then map through perm in parallel (the TPU one-hot windows,
// C_WINDOW and the banded mode are not needed). Then the threads, one per
// feature, sum the listed rows in list order, eight loads in flight. The
// chain of dependent loads per row is short (rowptr, mask, perm, values), so
// all N row blocks resident at once finish in a few load latencies. No
// atomics, fixed order: two runs agree bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 128;           // 4 warps
constexpr int WORD = 16;                // mask bytes tested per thread
constexpr int ROUND = NTHREADS * WORD;  // positions compacted per round
constexpr int MAXF = 4;                 // features per thread: D <= 512
constexpr int UNROLL = 8;               // value rows loaded per step

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    segment_sum_csr_kernel(const T* __restrict__ values,
                           const int* __restrict__ perm,
                           const int* __restrict__ rowptr,
                           const uint8_t* __restrict__ mask,
                           T* __restrict__ out, int E, int D) {
  __shared__ int list_s[ROUND];
  __shared__ int warp_s[NTHREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  const int beg = rowptr[row], end = rowptr[row + 1];

  float acc[MAXF];
#pragma unroll
  for (int q = 0; q < MAXF; ++q) acc[q] = 0.f;

  // rounds of ROUND positions, starting at the 16-byte word holding beg
  for (int r0 = beg - beg % WORD; r0 < end; r0 += ROUND) {
    const int p0 = r0 + tid * WORD;
    unsigned bits = 0;
    if (p0 < end && p0 + WORD > beg) {
      if (p0 + WORD <= E && (reinterpret_cast<uintptr_t>(mask + p0) & 15) ==
                                0) {
        const uint4 w = *reinterpret_cast<const uint4*>(mask + p0);
        const unsigned wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int b = 0; b < WORD; ++b)
          if ((wv[b >> 2] >> (8 * (b & 3))) & 0xffu) bits |= 1u << b;
      } else {
        for (int b = 0; b < WORD && p0 + b < E; ++b)
          if (mask[p0 + b]) bits |= 1u << b;
      }
      // keep [beg, end) only
      for (int b = 0; b < WORD; ++b)
        if (p0 + b < beg || p0 + b >= end) bits &= ~(1u << b);
    }
    // block-wide exclusive scan of the hit counts, in thread order
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_s[warp] = incl;
    __syncthreads();
    int off = incl - cnt, total = 0;
#pragma unroll
    for (int w = 0; w < NTHREADS / 32; ++w) {
      off += w < warp ? warp_s[w] : 0;
      total += warp_s[w];
    }
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      list_s[off++] = p0 + b;
    }
    __syncthreads();
    if (perm != nullptr) {  // positions -> value rows, all loads in parallel
      for (int i = tid; i < total; i += NTHREADS) list_s[i] = perm[list_s[i]];
      __syncthreads();
    }

    // sum the listed rows in list order, features across threads, UNROLL
    // row loads in flight
    int i = 0;
    for (; i + UNROLL <= total; i += UNROLL) {
      size_t rows[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) rows[u] = (size_t)list_s[i + u] * D;
#pragma unroll
      for (int q = 0; q < MAXF; ++q) {
        const int f = tid + q * NTHREADS;
        if (f >= D) break;
        float v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = to_f(values[rows[u] + f]);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) acc[q] = __fadd_rn(acc[q], v[u]);
      }
    }
    for (; i < total; ++i) {
      const size_t i0 = (size_t)list_s[i] * D;
#pragma unroll
      for (int q = 0; q < MAXF; ++q) {
        const int f = tid + q * NTHREADS;
        if (f >= D) break;
        acc[q] = __fadd_rn(acc[q], to_f(values[i0 + f]));
      }
    }
    __syncthreads();  // list_s / warp_s are rewritten by the next round
  }
#pragma unroll
  for (int q = 0; q < MAXF; ++q) {
    const int f = tid + q * NTHREADS;
    if (f < D) out[(size_t)row * D + f] = from_f<T>(acc[q]);
  }
}

}  // namespace

// C entry point (bound with ctypes). D <= 512; rowptr [N+1] ascending
// within [0, E]; perm [E] or null; mask [E] bytes. is_bf16 selects bf16 (1)
// or f32 (0) values and output. Returns cudaGetLastError() after the launch.
extern "C" int segment_sum_csr(const void* values, const void* perm,
                               const void* rowptr, const void* mask,
                               void* out, int E, int N, int D, int is_bf16,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N == 0) return cudaGetLastError();
  if (is_bf16)
    segment_sum_csr_kernel<bf16><<<N, NTHREADS, 0, s>>>(
        (const bf16*)values, (const int*)perm, (const int*)rowptr,
        (const uint8_t*)mask, (bf16*)out, E, D);
  else
    segment_sum_csr_kernel<float><<<N, NTHREADS, 0, s>>>(
        (const float*)values, (const int*)perm, (const int*)rowptr,
        (const uint8_t*)mask, (float*)out, E, D);
  return cudaGetLastError();
}
