// f32 products on Hopper's CUDA cores (FMA), shared by the f32 passes of
// K5/K6 (edge_phase_bwd.cu) and K8 (tp_contract_bwd.cu).
//
// One block of 128 threads computes a 64 x 128 tile C[m][n] =
// sum_k A[m][k] B[k][n] in f32 registers, each thread an 8 x 8 micro-tile:
// rows 4 ty + i and 32 + 4 ty + i, columns 4 tx + j and 64 + 4 tx + j
// (tx = thread % 16, ty = thread / 16, i, j < 4), so that one k step reads
// two float4 of A and two of B from shared memory and runs 64 FMAs. A and
// B are staged k-major ([BK][64 + 4] and [BK][128 + 4] floats, the padding
// keeps the transposed stores free of bank conflicts) in two buffers: the
// next k-slab of BK = 8 is fetched from device memory into registers while
// the current one's FMAs run, stored to the other buffer after them, and
// one barrier per slab separates the two uses of a buffer. Each sum over k
// runs in k order in one thread (fmaf), so repeats are bitwise equal.
//
// The operands come through fetchers, each with fetch(kt, regs) (slab kt
// of its K range into registers) and store(regs, smem): RowsT reads rows of
// a row-major matrix (k contiguous) and stores them transposed, ColsD reads
// k-major rows (the tile's columns contiguous) and stores them as they
// are; a pass that computes an operand on the fly (K8's dwall = dc (x) a,
// K5's h = pre sig) writes its own fetcher of the same shape.
//
// Every definition sits in an unnamed namespace: each source that includes
// this header is its own shared library.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

namespace simt {

constexpr int THREADS = 128;
constexpr int BM = 64, BN = 128, BK = 8;
constexpr int LDA = BM + 4, LDB = BN + 4;  // shared row strides (floats)
constexpr int A_FLOATS = BK * LDA, B_FLOATS = BK * LDB;
// dynamic shared memory of every f32 pass: two A and two B buffers (the
// epilogues reuse it for their column sums, at most [8][128] floats)
constexpr size_t SMEM = sizeof(float) * 2 * (A_FLOATS + B_FLOATS);

// row of a thread's i-th and column of its j-th output in the tile
__device__ __forceinline__ int row_of(int i) {
  return (i < 4 ? 0 : 32) + 4 * (threadIdx.x / 16) + (i & 3);
}
__device__ __forceinline__ int col_of(int j) {
  return (j < 4 ? 0 : 64) + 4 * (threadIdx.x % 16) + (j & 3);
}

// R rows x BK columns of a row-major source (row r at rows + r * ld, slab
// kt at column k0 + kt BK), stored transposed as S[k][r] (stride R + 4)
template <int R>
struct RowsT {
  static constexpr int NV = R * BK / 4 / THREADS;  // float4 a thread
  using Regs = float4[NV];
  const float* rows;
  size_t ld;
  int k0;
  __device__ __forceinline__ void fetch(int kt, Regs& v) const {
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int idx = threadIdx.x + THREADS * q;
      v[q] = *reinterpret_cast<const float4*>(
          rows + (size_t)(idx >> 1) * ld + k0 + kt * BK + 4 * (idx & 1));
    }
  }
  __device__ __forceinline__ void store(const Regs& v, float* S) const {
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int idx = threadIdx.x + THREADS * q;
      float* s = S + 4 * (idx & 1) * (R + 4) + (idx >> 1);
      s[0] = v[q].x;
      s[R + 4] = v[q].y;
      s[2 * (R + 4)] = v[q].z;
      s[3 * (R + 4)] = v[q].w;
    }
  }
};

// BK k-major rows of C contiguous columns (row k at base + k * ld, slab kt
// at row k0 + kt BK), stored as S[k][c] (stride C + 4)
template <int C>
struct ColsD {
  static constexpr int NV = C * BK / 4 / THREADS;
  using Regs = float4[NV];
  const float* base;
  size_t ld;
  int k0;
  __device__ __forceinline__ void fetch(int kt, Regs& v) const {
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int idx = threadIdx.x + THREADS * q;
      v[q] = *reinterpret_cast<const float4*>(
          base + (size_t)(k0 + kt * BK + idx / (C / 4)) * ld +
          4 * (idx % (C / 4)));
    }
  }
  __device__ __forceinline__ void store(const Regs& v, float* S) const {
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int idx = threadIdx.x + THREADS * q;
      *reinterpret_cast<float4*>(S + (idx / (C / 4)) * (C + 4) +
                                 4 * (idx % (C / 4))) = v[q];
    }
  }
};

// acc += A B over nk slabs; smem holds the two A buffers, then the two B
// buffers. Ends with a barrier: the caller may reuse smem at once.
template <class FA, class FB>
__device__ __forceinline__ void mainloop(float (&acc)[8][8], int nk, FA& fa,
                                         FB& fb, float* smem) {
  float* As = smem;
  float* Bs = smem + 2 * A_FLOATS;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  typename FA::Regs ra;
  typename FB::Regs rb;
  fa.fetch(0, ra);
  fb.fetch(0, rb);
  fa.store(ra, As);
  fb.store(rb, Bs);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {  // the next slab, in flight during the FMAs
      fa.fetch(kt + 1, ra);
      fb.fetch(kt + 1, rb);
    }
    const float* a_s = As + cur * A_FLOATS + 4 * ty;
    const float* b_s = Bs + cur * B_FLOATS + 4 * tx;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_s + k * LDA);
      const float4 a1 = *reinterpret_cast<const float4*>(a_s + k * LDA + 32);
      const float4 b0 = *reinterpret_cast<const float4*>(b_s + k * LDB);
      const float4 b1 = *reinterpret_cast<const float4*>(b_s + k * LDB + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      fa.store(ra, As + (cur ^ 1) * A_FLOATS);
      fb.store(rb, Bs + (cur ^ 1) * B_FLOATS);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// the tile's column sums of v (8 rows a thread) in a fixed order: each
// thread's rows in order, then the 8 row groups (ty) in order through
// red [8][128] of shared memory; out(col, sum) for col < 128 is called by
// thread col. The caller puts a barrier between red's previous use and
// this call, and one after it before red's next use.
template <class Out>
__device__ __forceinline__ void column_sums(const float (&v)[8][8],
                                            float* red, Out out) {
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s = __fadd_rn(s, v[i][j]);
    red[ty * BN + col_of(j)] = s;
  }
  __syncthreads();
  {
    const int c = threadIdx.x;  // THREADS == BN
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < 8; ++g) s = __fadd_rn(s, red[g * BN + c]);
    out(c, s);
  }
}

}  // namespace simt

}  // namespace
