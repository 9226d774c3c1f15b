// Fused sigma chain + destination segment sum, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cartnet_tpu/ops/pallas/segment_kernels.py:
// _sigma_bwd -> _sigma_seg_bwd_kernel. The forward (sigma_segsum_fwd.cu) is
//   sig0 = sigmoid(gate * scale + shift),  sig = sig0 * env
//   e_out = e_in + sig,  aggr[dst] += sig * sender   (masked-in edges only)
// and, per edge e and feature f, this kernel computes (f32 arithmetic)
//   dvals   = emask[e] ? daggr[dst[e]] : 0
//   dsender = dvals * sig                              (sender's dtype)
//   dsig    = deout + dvals * sender
//   denv[e] = sum_f dsig * sig0                        (env's dtype)
//   da      = dsig * env * sig0 * (1 - sig0)
//   dgate   = da * scale                               (gate's dtype)
//   dscale  = sum_e da * gate,  dshift = sum_e da      (f32, every edge)
// The cotangent of e_in is deout itself; the wrapper passes it through.
//
// What bounds it: ~20 flops and one exp per element against the [E, d]
// streams (gate, sender, deout in; dgate, dsender out) and the [N, d]
// daggr gathers, so device memory bandwidth bounds it.
//
// Design: two launches, no atomics, bitwise repeatable.
//   1. One block per TE consecutive edges; each warp owns whole edges
//      (lane l holds features l, l + 32, ...), so denv is a warp-shuffle
//      butterfly over the row and every access is coalesced along d. Each
//      lane keeps its features' dscale/dshift partials in registers; the
//      block folds its 8 warps in order into one partial row per block.
//   2. One thread per column sums the block partials in block order.
// Elementwise steps use explicitly rounded operations so nvcc contracts
// nothing into an FMA that the plain PyTorch version does not have.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int TE = 32;     // edges per block (4 per warp)
constexpr int MAXQ = 16;   // features per lane: d <= 32 * MAXQ

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename GT, typename ET>
__global__ void __launch_bounds__(NTHREADS)
    sigma_bwd_edges(const GT* __restrict__ gate,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift,
                    const GT* __restrict__ env, const GT* __restrict__ sender,
                    const ET* __restrict__ deout,
                    const GT* __restrict__ daggr, const int* __restrict__ dst,
                    const uint8_t* __restrict__ emask, GT* __restrict__ dgate,
                    GT* __restrict__ denv, GT* __restrict__ dsender,
                    float* __restrict__ part, int E, int d) {
  __shared__ float red_s[2][NWARPS][32 * MAXQ];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = (d + 31) / 32;  // lanes past d in the last word own nothing
  float acc_sc[MAXQ], acc_sh[MAXQ], sc[MAXQ], sh[MAXQ];
#pragma unroll
  for (int q = 0; q < MAXQ; ++q) {
    const int f = lane + 32 * q;
    acc_sc[q] = 0.f;
    acc_sh[q] = 0.f;
    sc[q] = f < d ? scale[f] : 0.f;
    sh[q] = f < d ? shift[f] : 0.f;
  }
  const int e0 = blockIdx.x * TE;
  for (int r = warp; r < TE; r += NWARPS) {
    const int e = e0 + r;
    if (e >= E) break;
    const bool real = emask[e] != 0;
    const size_t row = (size_t)e * d;
    const size_t drow = (size_t)dst[e] * d;
    const float env_e = to_f(env[e]);
    float denv_part = 0.f;
#pragma unroll
    for (int q = 0; q < MAXQ; ++q) {
      if (q >= nq) break;
      if (lane + 32 * q >= d) continue;
      const size_t o = row + lane + 32 * q;
      const float g = to_f(gate[o]);
      const float a = __fadd_rn(__fmul_rn(g, sc[q]), sh[q]);
      const float s0 = 1.f / (1.f + expf(-a));
      const float sg = __fmul_rn(s0, env_e);
      const float dv = real ? to_f(daggr[drow + lane + 32 * q]) : 0.f;
      dsender[o] = from_f<GT>(__fmul_rn(dv, sg));
      const float dsig =
          __fadd_rn(to_f(deout[o]), __fmul_rn(dv, to_f(sender[o])));
      denv_part = __fadd_rn(denv_part, __fmul_rn(dsig, s0));
      const float da = __fmul_rn(__fmul_rn(__fmul_rn(dsig, env_e), s0),
                                 __fadd_rn(1.f, -s0));
      dgate[o] = from_f<GT>(__fmul_rn(da, sc[q]));
      acc_sc[q] = __fadd_rn(acc_sc[q], __fmul_rn(da, g));
      acc_sh[q] = __fadd_rn(acc_sh[q], da);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      denv_part =
          __fadd_rn(denv_part, __shfl_xor_sync(0xffffffffu, denv_part, off));
    if (lane == 0) denv[e] = from_f<GT>(denv_part);
  }
#pragma unroll
  for (int q = 0; q < MAXQ; ++q) {
    if (q >= nq) break;
    if (lane + 32 * q >= d) continue;
    red_s[0][warp][lane + 32 * q] = acc_sc[q];
    red_s[1][warp][lane + 32 * q] = acc_sh[q];
  }
  __syncthreads();
  // block partial row: [dscale (d) | dshift (d)], warps folded in order
  for (int c = threadIdx.x; c < 2 * d; c += NTHREADS) {
    const int k = c < d ? 0 : 1, f = c < d ? c : c - d;
    float s = 0.f;
    for (int w = 0; w < NWARPS; ++w) s = __fadd_rn(s, red_s[k][w][f]);
    part[(size_t)blockIdx.x * 2 * d + c] = s;
  }
}

// out[c] = sum_b part[b][c], b in order (c < 2d: dscale then dshift)
__global__ void __launch_bounds__(NTHREADS)
    sigma_bwd_columns(const float* __restrict__ part, float* __restrict__ out,
                      int nblocks, int width) {
  const int c = blockIdx.x * NTHREADS + threadIdx.x;
  if (c >= width) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b)
    s = __fadd_rn(s, part[(size_t)b * width + c]);
  out[c] = s;
}

template <typename GT, typename ET>
cudaError_t launch(const void* gate, const void* scale, const void* shift,
                   const void* env, const void* sender, const void* deout,
                   const void* daggr, const void* dst, const void* emask,
                   void* dgate, void* dscale_shift, void* denv, void* dsender,
                   void* part, int E, int d, cudaStream_t stream) {
  const int nblocks = (E + TE - 1) / TE;
  sigma_bwd_edges<GT, ET><<<nblocks, NTHREADS, 0, stream>>>(
      (const GT*)gate, (const float*)scale, (const float*)shift,
      (const GT*)env, (const GT*)sender, (const ET*)deout, (const GT*)daggr,
      (const int*)dst, (const uint8_t*)emask, (GT*)dgate, (GT*)denv,
      (GT*)dsender, (float*)part, E, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sigma_bwd_columns<<<(2 * d + NTHREADS - 1) / NTHREADS, NTHREADS, 0,
                      stream>>>((const float*)part, (float*)dscale_shift,
                                nblocks, 2 * d);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). 0 < d <= 512 (any width); E > 0.
// gate_bf16 / e_bf16 select bf16 (1) or f32 (0) for gate, env, sender,
// daggr and their cotangents / for deout. dscale_shift [2d] f32 receives
// dscale then dshift; part is scratch of ceil(E / 32) * 2d floats. Two
// launches; returns cudaGetLastError() after them.
extern "C" int sigma_segsum_bwd(const void* gate, const void* scale,
                                const void* shift, const void* env,
                                const void* sender, const void* deout,
                                const void* daggr, const void* dst,
                                const void* emask, void* dgate,
                                void* dscale_shift, void* denv,
                                void* dsender, void* part, int E, int d,
                                int gate_bf16, int e_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  if (gate_bf16 && e_bf16)
    return launch<bf, bf>(gate, scale, shift, env, sender, deout, daggr, dst,
                          emask, dgate, dscale_shift, denv, dsender, part, E,
                          d, s);
  if (gate_bf16)
    return launch<bf, float>(gate, scale, shift, env, sender, deout, daggr,
                             dst, emask, dgate, dscale_shift, denv, dsender,
                             part, E, d, s);
  if (e_bf16)
    return launch<float, bf>(gate, scale, shift, env, sender, deout, daggr,
                             dst, emask, dgate, dscale_shift, denv, dsender,
                             part, E, d, s);
  return launch<float, float>(gate, scale, shift, env, sender, deout, daggr,
                              dst, emask, dgate, dscale_shift, denv, dsender,
                              part, E, d, s);
}

// TE, for the wrapper's scratch size
extern "C" int sigma_segsum_bwd_tile() { return TE; }
