// Row accesses at memory speed, shared by the port's row passes:
// sigma_segsum_fwd.cu (K2), segment_sum_csr.cu (K3) and sigma_segsum_bwd.cu
// (K4).
//
//   * to_f / from_f / round_to: f32 <-> the operand's dtype (bf16 rounds to
//     nearest even);
//   * load / store<VEC, AL>: VEC contiguous features of a row as floats,
//     one access of VEC elements (16 bytes and more: 16-byte accesses)
//     where AL (the width a multiple of VEC and the base 16-byte aligned),
//     else element by element with the ragged end masked;
//   * team_lanes / row_slices: the lanes a row's team takes (8, 16 or 32
//     of a warp) and the teams (feature slices) a row takes;
//   * Team, word_hits, team_scan: a team walks a CSR row's masked-in
//     positions in ascending order, a window of WORD L positions at a
//     time. Each lane tests a word of WORD mask bytes (two 16-byte loads);
//     a shuffle scan of the lanes' hit counts orders the hits and each lane
//     writes its own to the team's list in shared memory: no block barrier
//     and no dependent load per position.
//
// Every definition sits in an unnamed namespace: each source that includes
// this header is its own shared library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WORD = 32;  // mask bytes a lane tests at once (two loads)

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

// v = p[f0 .. f0 + VEC) as floats; with AL (d % VEC == 0, rows 16-byte
// aligned) vector loads of VEC elements (16 bytes each at most), else
// element by element, zeros past d
template <int VEC, bool AL>
__device__ __forceinline__ void load(const float* p, int f0, int d,
                                     float (&v)[VEC]) {
  if constexpr (AL && VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + f0 + i);
      v[i] = x.x;
      v[i + 1] = x.y;
      v[i + 2] = x.z;
      v[i + 3] = x.w;
    }
  } else if constexpr (AL && VEC == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p + f0);
    v[0] = x.x;
    v[1] = x.y;
  } else if constexpr (AL) {
    v[0] = p[f0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = f0 + i < d ? p[f0 + i] : 0.f;
  }
}
template <int VEC, bool AL>
__device__ __forceinline__ void load(const bf16* p, int f0, int d,
                                     float (&v)[VEC]) {
  if constexpr (AL && VEC >= 2) {
    uint32_t w[VEC / 2];
    if constexpr (VEC == 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(p + f0);
      w[0] = x.x;
      w[1] = x.y;
      w[2] = x.z;
      w[3] = x.w;
    } else if constexpr (VEC == 4) {
      const uint2 x = *reinterpret_cast<const uint2*>(p + f0);
      w[0] = x.x;
      w[1] = x.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p + f0);
    }
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else if constexpr (AL) {
    v[0] = __bfloat162float(p[f0]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      v[i] = f0 + i < d ? __bfloat162float(p[f0 + i]) : 0.f;
  }
}

// p[f0 .. f0 + VEC) = v rounded to T (element by element past d without AL)
template <int VEC, bool AL>
__device__ __forceinline__ void store(float* p, int f0, int d,
                                      const float (&v)[VEC]) {
  if constexpr (AL && VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + f0 + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (AL && VEC == 2) {
    *reinterpret_cast<float2*>(p + f0) = make_float2(v[0], v[1]);
  } else if constexpr (AL) {
    p[f0] = v[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (f0 + i < d) p[f0 + i] = v[i];
  }
}
template <int VEC, bool AL>
__device__ __forceinline__ void store(bf16* p, int f0, int d,
                                      const float (&v)[VEC]) {
  if constexpr (AL && VEC >= 2) {
    uint32_t w[VEC / 2];
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    if constexpr (VEC == 8)
      *reinterpret_cast<uint4*>(p + f0) = make_uint4(w[0], w[1], w[2], w[3]);
    else if constexpr (VEC == 4)
      *reinterpret_cast<uint2*>(p + f0) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(p + f0) = w[0];
  } else if constexpr (AL) {
    p[f0] = __float2bfloat16_rn(v[0]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (f0 + i < d) p[f0 + i] = __float2bfloat16_rn(v[i]);
  }
}

// A row's features are cut into slices of at most 32 VEC, one team of
// lanes each: 8, 16 or 32 lanes, the fewest whose VEC-wide vectors cover
// d (a narrower row leaves a warp to 4 or 2 rows), and lane l of the team
// of slice s owns features VEC (32 s + l) .. + VEC - 1
__host__ __device__ constexpr int team_lanes(int d, int vec) {
  return (d + vec - 1) / vec <= 8 ? 8 : (d + vec - 1) / vec <= 16 ? 16 : 32;
}
__host__ __device__ constexpr int row_slices(int d, int vec) {
  return (d + 32 * vec - 1) / (32 * vec);
}

// lanes team * L .. team * L + L - 1 of a warp (L = 8, 16 or 32)
struct Team {
  int L, team, tl, shift;
  unsigned mask;  // the team's lanes in the warp
  __device__ Team(int lanes, int lane)
      : L(lanes), team(lane / lanes), tl(lane % lanes),
        shift(lane / lanes * lanes),
        mask(lanes == 32 ? 0xffffffffu
                         : ((1u << lanes) - 1u) << (lane / lanes * lanes)) {}
};

// bit b: position p0 + b (p0 a multiple of WORD) lies in [lo, hi) and its
// mask byte is set; two 16-byte loads where the word is whole and the
// mask's base 16-byte aligned (al16), else byte by byte
__device__ __forceinline__ unsigned word_hits(const uint8_t* mask, int p0,
                                              int lo, int hi, int E,
                                              bool al16) {
  unsigned bits = 0u;
  if (al16 && p0 + WORD <= E) {
    const uint4 w0 = *reinterpret_cast<const uint4*>(mask + p0);
    const uint4 w1 = *reinterpret_cast<const uint4*>(mask + p0 + 16);
    const unsigned wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      // one bit per byte: its low bit after the byte-wise compare, the
      // four gathered into the top byte by one multiply
      const unsigned b = __vcmpne4(wv[k], 0u) & 0x01010101u;
      bits |= ((b * 0x01020408u) >> 24) << (4 * k);
    }
  } else {
    for (int b = 0; b < WORD; ++b)
      if (p0 + b < E && mask[p0 + b]) bits |= 1u << b;
  }
  const int a = lo > p0 ? lo - p0 : 0, z = hi - p0 < WORD ? hi - p0 : WORD;
  if (z <= a) return 0u;
  return bits & (z == WORD ? ~0u : (1u << z) - 1u) & ~((1u << a) - 1u);
}

// The team's compaction of one window: each lane holds the hit bits of
// its word (``mine``); returns the window's hits, and off = the hits of
// the team's lanes before this one (a shuffle scan), so that the lane
// writes its hits to list[off ..] in ascending position and the team's
// list holds every hit of the window in order
__device__ __forceinline__ int team_scan(const Team& t, unsigned mine,
                                         int& off) {
  const int cnt = __popc(mine);
  int incl = cnt;
  for (int o = 1; o < t.L; o <<= 1) {
    const int v = __shfl_up_sync(t.mask, incl, o, t.L);
    if (t.tl >= o) incl += v;
  }
  off = incl - cnt;
  return __shfl_sync(t.mask, incl, t.L - 1, t.L);
}

}  // namespace
