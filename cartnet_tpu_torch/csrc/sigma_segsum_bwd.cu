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
// daggr gathers (~54 MB in bf16 at E = 20992, d = 256: 16 us at the
// 3.35 TB/s of an NVIDIA H100 SXM), so device memory bandwidth bounds it.
//
// Design: a pass at memory speed, two launches, no float atomics, bitwise
// repeatable.
//   1. Row pass: a grid of BLOCKS_PER_SM blocks an SM (fewer when E is
//      small), each walking its own contiguous range of edges, warp w of a
//      block taking the range's rows w, w + WARPS, .... A lane owns VEC
//      contiguous features (16 bytes of gate: 8 bf16 or 4 f32) in each of
//      NV groups of 32 VEC, so every row is read and written in 16-byte
//      accesses (row_vectors.cuh's load / store; one warp instruction
//      covers a bf16 row of 256), and the
//      lane's dscale/dshift partials take 2 NV VEC registers, sized to d
//      by the template. denv is a fixed butterfly over the row's lanes.
//      The block folds its warps' partials in warp order into one partial
//      row [dscale | dshift] (the grid's rows: ~2 an SM, not one per 32
//      edges).
//   2. Column pass: 32 columns a block, its warps summing fixed row ranges
//      of the partial rows in order, then the warps' sums in warp order.
// The per-element arithmetic is the earlier kernel's, operation for
// operation (__fadd_rn/__fmul_rn, expf, 1/(1 + e)), so dgate and dsender
// are bitwise those of a kernel that walks the features in any order;
// denv, dscale and dshift sum in this kernel's fixed order. Elementwise
// steps use explicitly rounded operations so nvcc contracts nothing into an
// FMA that the plain PyTorch version does not have.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "row_vectors.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 2;  // row-pass blocks an SM (launch bounds)
constexpr int MAX_WIDTH = 512;
// the row pass's dynamic shared memory at MAX_WIDTH stays within the 48 KB
// a launch takes without opting in (no cudaFuncSetAttribute a call)
static_assert(sizeof(float) * 2 * WARPS * MAX_WIDTH <= 48 * 1024,
              "row-pass partials fit the default dynamic shared memory");

// features a lane owns in each group: 16 bytes of the gate's dtype
template <typename GT> __host__ __device__ constexpr int vec_of() {
  return 16 / (int)sizeof(GT);
}

struct Args {
  const void *gate, *env, *sender, *deout, *daggr;
  const float *scale, *shift;
  const int* dst;
  const uint8_t* emask;
  void *dgate, *denv, *dsender;
  float* part;   // [gridDim.x][2 d]: each row-pass block's [dscale|dshift]
  float* out;    // [2 d]: dscale then dshift
  int E, d;
};

// Row pass: block b walks edges [b E / G, (b + 1) E / G) (G = gridDim.x),
// warp w its rows w, w + WARPS, ...; lane l owns features VEC (l + 32 q)
// .. + VEC - 1 of every row, q < NV. Dynamic shared memory: the warps'
// partials [2][WARPS][d] f32.
template <typename GT, typename ET, int NV, bool AL>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    sigma_bwd_rows(const __grid_constant__ Args p) {
  constexpr int VEC = vec_of<GT>();
  extern __shared__ float red_s[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, d = p.d;
  const GT* gate = static_cast<const GT*>(p.gate);
  const GT* env = static_cast<const GT*>(p.env);
  const GT* sender = static_cast<const GT*>(p.sender);
  const ET* deout = static_cast<const ET*>(p.deout);
  const GT* daggr = static_cast<const GT*>(p.daggr);
  GT* dgate = static_cast<GT*>(p.dgate);
  GT* dsender = static_cast<GT*>(p.dsender);
  float sc[NV][VEC], sh[NV][VEC], acc_sc[NV][VEC], acc_sh[NV][VEC];
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const int f0 = VEC * (lane + 32 * q);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sc[q][i] = f0 + i < d ? p.scale[f0 + i] : 0.f;
      sh[q][i] = f0 + i < d ? p.shift[f0 + i] : 0.f;
      acc_sc[q][i] = acc_sh[q][i] = 0.f;
    }
  }
  const long long G = gridDim.x;
  const long long e_lo = (long long)blockIdx.x * p.E / G;
  const long long e_hi = (long long)(blockIdx.x + 1) * p.E / G;
  for (long long e = e_lo + warp; e < e_hi; e += WARPS) {
    const bool real = p.emask[e] != 0;
    const size_t row = (size_t)e * d;
    const size_t drow = (size_t)p.dst[e] * d;
    const float env_e = to_f(env[e]);
    float denv_part = 0.f;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int f0 = VEC * (lane + 32 * q);
      if (f0 >= d) break;
      float g[VEC], s[VEC], de[VEC], dv[VEC], dg[VEC], ds[VEC];
      load<VEC, AL>(gate + row, f0, d, g);
      load<VEC, AL>(sender + row, f0, d, s);
      load<VEC, AL>(deout + row, f0, d, de);
      if (real) {
        load<VEC, AL>(daggr + drow, f0, d, dv);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) dv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (!AL && f0 + i >= d) break;
        const float a = __fadd_rn(__fmul_rn(g[i], sc[q][i]), sh[q][i]);
        const float s0 = 1.f / (1.f + expf(-a));
        const float sg = __fmul_rn(s0, env_e);
        ds[i] = __fmul_rn(dv[i], sg);
        const float dsig = __fadd_rn(de[i], __fmul_rn(dv[i], s[i]));
        denv_part = __fadd_rn(denv_part, __fmul_rn(dsig, s0));
        const float da = __fmul_rn(__fmul_rn(__fmul_rn(dsig, env_e), s0),
                                   __fadd_rn(1.f, -s0));
        dg[i] = __fmul_rn(da, sc[q][i]);
        acc_sc[q][i] = __fadd_rn(acc_sc[q][i], __fmul_rn(da, g[i]));
        acc_sh[q][i] = __fadd_rn(acc_sh[q][i], da);
      }
      store<VEC, AL>(dgate + row, f0, d, dg);
      store<VEC, AL>(dsender + row, f0, d, ds);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      denv_part =
          __fadd_rn(denv_part, __shfl_xor_sync(0xffffffffu, denv_part, off));
    if (lane == 0) static_cast<GT*>(p.denv)[e] = from_f<GT>(denv_part);
  }
  // the block's partial row [dscale | dshift]: warps folded in warp order
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const int f0 = VEC * (lane + 32 * q);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (f0 + i < d) {
        red_s[warp * d + f0 + i] = acc_sc[q][i];
        red_s[(WARPS + warp) * d + f0 + i] = acc_sh[q][i];
      }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * d; c += THREADS) {
    const int k = c < d ? 0 : 1, f = c < d ? c : c - d;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      s = __fadd_rn(s, red_s[(k * WARPS + w) * d + f]);
    p.part[(size_t)blockIdx.x * 2 * d + c] = s;
  }
}

// Column pass: out[c] of the partial rows [dscale | dshift] (nrows of
// width floats) for 32 columns a block, column c = 32 blockIdx.x + lane:
// warp w sums its fixed range of rows in order, then warp 0 sums the
// warps' sums in warp order
__global__ void __launch_bounds__(THREADS)
    sigma_bwd_fold(const float* __restrict__ part, float* __restrict__ out,
                   int nrows, int width) {
  __shared__ float red[WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int r0 = (int)((long long)warp * nrows / WARPS);
  const int r1 = (int)((long long)(warp + 1) * nrows / WARPS);
  float s = 0.f;
  if (c < width)
    for (int r = r0; r < r1; ++r)
      s = __fadd_rn(s, part[(size_t)r * width + c]);
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < width) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t = __fadd_rn(t, red[w][lane]);
    out[c] = t;
  }
}

// the current device's SMs, asked once a device
int num_sms() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) dev = 0;
  int& n = cache[dev & 63];
  if (n <= 0 &&
      (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
           cudaSuccess || n <= 0))
    n = 132;
  return n;
}

// row-pass blocks (= partial rows): BLOCKS_PER_SM an SM, at most one per
// WARPS edges (every warp has a row), at least one
int parts_of(int E, int n_sm) {
  const long long by_rows = ((long long)E + WARPS - 1) / WARPS;
  const long long g = (long long)n_sm * BLOCKS_PER_SM;
  const long long n = g < by_rows ? g : by_rows;
  return n < 1 ? 1 : (int)n;
}

template <typename K>
cudaError_t launch(K kern, int blocks, size_t smem, cudaStream_t s,
                   const Args& p) {
  kern<<<blocks, THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

// the row pass over parts_of(E) blocks, then the column pass
template <typename GT, typename ET, int NV, bool AL>
cudaError_t run(const Args& p, cudaStream_t s) {
  const int G = parts_of(p.E, num_sms()), width = 2 * p.d;
  cudaError_t err = launch(sigma_bwd_rows<GT, ET, NV, AL>, G,
                           sizeof(float) * 2 * WARPS * p.d, s, p);
  if (err != cudaSuccess) return err;
  sigma_bwd_fold<<<(width + 31) / 32, THREADS, 0, s>>>(p.part, p.out, G,
                                                        width);
  return cudaGetLastError();
}

// vector accesses (AL): whole VEC groups, 16-byte aligned rows of gate's
// dtype and VEC-element aligned rows of deout's
template <typename GT, typename ET, int NV>
cudaError_t run_aligned(const Args& p, cudaStream_t s) {
  constexpr size_t VEC = vec_of<GT>();
  constexpr size_t EA = VEC * sizeof(ET) < 16 ? VEC * sizeof(ET) : 16;
  const bool al = p.d % VEC == 0 &&
                  (reinterpret_cast<uintptr_t>(p.gate) |
                   reinterpret_cast<uintptr_t>(p.sender) |
                   reinterpret_cast<uintptr_t>(p.daggr) |
                   reinterpret_cast<uintptr_t>(p.dgate) |
                   reinterpret_cast<uintptr_t>(p.dsender)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(p.deout) % EA == 0;
  return al ? run<GT, ET, NV, true>(p, s) : run<GT, ET, NV, false>(p, s);
}

// NV = the 32 VEC-feature groups a lane walks: d <= 32 VEC NV
template <typename GT, typename ET>
cudaError_t run_width(const Args& p, cudaStream_t s) {
  constexpr int W = 32 * vec_of<GT>();
  if (p.d <= W) return run_aligned<GT, ET, 1>(p, s);
  if (p.d <= 2 * W) return run_aligned<GT, ET, 2>(p, s);
  if constexpr (W < MAX_WIDTH / 2) {
    if (p.d <= 3 * W) return run_aligned<GT, ET, 3>(p, s);
    return run_aligned<GT, ET, 4>(p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point (bound with ctypes). 0 < d <= 512 (any width); E > 0.
// gate_bf16 / e_bf16 select bf16 (1) or f32 (0) for gate, env, sender,
// daggr and their cotangents / for deout. dscale_shift [2d] f32 receives
// dscale then dshift; part is scratch of sigma_segsum_bwd_parts(E) * 2d
// floats. Two launches (row pass, column pass); returns cudaGetLastError()
// after them.
extern "C" int sigma_segsum_bwd(const void* gate, const void* scale,
                                const void* shift, const void* env,
                                const void* sender, const void* deout,
                                const void* daggr, const void* dst,
                                const void* emask, void* dgate,
                                void* dscale_shift, void* denv,
                                void* dsender, void* part, int E, int d,
                                int gate_bf16, int e_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E <= 0 || d <= 0 || d > MAX_WIDTH) return cudaErrorInvalidValue;
  const Args p{gate, env, sender, deout, daggr, (const float*)scale,
               (const float*)shift, (const int*)dst, (const uint8_t*)emask,
               dgate, denv, dsender, (float*)part, (float*)dscale_shift, E,
               d};
  if (gate_bf16 && e_bf16) return run_width<bf16, bf16>(p, s);
  if (gate_bf16) return run_width<bf16, float>(p, s);
  if (e_bf16) return run_width<float, bf16>(p, s);
  return run_width<float, float>(p, s);
}

// partial rows the call writes to part (the row pass's grid), for the
// wrapper's scratch size
extern "C" int sigma_segsum_bwd_parts(int E) {
  return parts_of(E, num_sms());
}
