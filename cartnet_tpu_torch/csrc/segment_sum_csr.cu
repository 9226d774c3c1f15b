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
// mask = edge_mask it is the sum over edges already sorted by destination
// (the sorted gathers' backward).
//
// What bounds it: one read of the masked-in rows of values plus the
// [N, D] output and the index arrays, ~9 MB at the main path's f32
// [E, 128] (2.7 us at the 3.35 TB/s of an NVIDIA H100 SXM). The rows are
// short (~19 masked-in positions) and all 896 of them are in flight at
// once, so what sets the time is the chain of dependent steps of a row
// (rowptr -> mask -> perm -> values -> out) and the launch: ~5 us.
//
// Design: one block of THREADS per row (the warp-per-row shape of
// sigma_segsum_fwd.cu was slower here: its one warp runs the whole chain
// alone, where four warps share it). A round compacts ROUND positions:
// each thread tests a word of WORD mask bytes (row_vectors.cuh,
// word_hits: two 16-byte loads and a byte compare, so the ~3600 pad
// positions of the last node take one round), a warp shuffle scan and one
// block barrier order the hits, and each thread writes its own to the
// list at offset + the hits below them in its word (no serial chain per
// thread). The threads map the listed positions through perm in parallel;
// then, one feature a thread, they sum the listed rows in list order,
// UNROLL row loads in flight. No atomics, one order: two runs agree
// bitwise, and each output is the earlier kernel's bit for bit. The TPU's
// one-hot windows, C_WINDOW and the banded mode are not needed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "row_vectors.cuh"

namespace {

constexpr int THREADS = 128;           // one block a row
constexpr int WARPS = THREADS / 32;
constexpr int ROUND = THREADS * WORD;  // positions compacted a round
constexpr int MAXF = 4;                // features a thread: D <= MAX_D
constexpr int UNROLL = 4;              // value rows whose loads are in flight
constexpr int MAX_D = MAXF * THREADS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    segment_sum_csr_kernel(const T* __restrict__ values,
                           const int* __restrict__ perm,
                           const int* __restrict__ rowptr,
                           const uint8_t* __restrict__ mask,
                           T* __restrict__ out, int E, int D) {
  // the round's list of hit positions, then of value rows, in ascending
  // position; the warps' hit counts
  __shared__ int list_s[ROUND];
  __shared__ int warp_s[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Team t(32, lane);
  const int row = blockIdx.x;
  const int beg = rowptr[row], end = rowptr[row + 1];
  const bool mask16 = (reinterpret_cast<uintptr_t>(mask) & 15) == 0;

  float acc[MAXF];
#pragma unroll
  for (int q = 0; q < MAXF; ++q) acc[q] = 0.f;

  // rounds of ROUND positions, from the word holding beg
  for (int r0 = beg - beg % WORD; r0 < end; r0 += ROUND) {
    const int p0 = r0 + WORD * tid;
    const unsigned bits =
        p0 < end ? word_hits(mask, p0, beg, end, E, mask16) : 0u;
    // block-wide exclusive scan of the hit counts, in thread order
    int off;
    const int in_warp = team_scan(t, bits, off);
    if (lane == 0) warp_s[warp] = in_warp;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      off += w < warp ? warp_s[w] : 0;
      total += warp_s[w];
    }
    // each hit's place: the thread's offset plus its hits below
#pragma unroll
    for (int b = 0; b < WORD; ++b)
      if ((bits >> b) & 1u)
        list_s[off + __popc(bits & ((1u << b) - 1u))] = p0 + b;
    __syncthreads();
    if (perm != nullptr) {  // positions -> value rows, all loads in parallel
      for (int i = tid; i < total; i += THREADS) list_s[i] = perm[list_s[i]];
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
        const int f = tid + q * THREADS;
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
        const int f = tid + q * THREADS;
        if (f >= D) break;
        acc[q] = __fadd_rn(acc[q], to_f(values[i0 + f]));
      }
    }
    __syncthreads();  // list_s and warp_s are rewritten by the next round
  }
#pragma unroll
  for (int q = 0; q < MAXF; ++q) {
    const int f = tid + q * THREADS;
    if (f < D) out[(size_t)row * D + f] = from_f<T>(acc[q]);
  }
}

template <typename K, typename... A>
cudaError_t launch(K kern, int blocks, cudaStream_t s, A... args) {
  kern<<<blocks, THREADS, 0, s>>>(args...);
  return cudaGetLastError();
}

// one block a row
template <typename T>
cudaError_t run(const void* values, const void* perm, const void* rowptr,
                const void* mask, void* out, int E, int N, int D,
                cudaStream_t s) {
  return launch(segment_sum_csr_kernel<T>, N, s, (const T*)values,
                (const int*)perm, (const int*)rowptr, (const uint8_t*)mask,
                (T*)out, E, D);
}

}  // namespace

// C entry point (bound with ctypes). 0 < D <= 512; rowptr [N+1] ascending
// within [0, E]; perm [E] or null; mask [E] bytes. is_bf16 selects bf16 (1)
// or f32 (0) values and output. Returns cudaGetLastError() after the launch.
extern "C" int segment_sum_csr(const void* values, const void* perm,
                               const void* rowptr, const void* mask,
                               void* out, int E, int N, int D, int is_bf16,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 0 || D > MAX_D) return cudaErrorInvalidValue;
  if (N == 0) return cudaGetLastError();
  return is_bf16 ? run<bf16>(values, perm, rowptr, mask, out, E, N, D, s)
                 : run<float>(values, perm, rowptr, mask, out, E, N, D, s);
}
