// Element access for the bf16 modes of the NATTEN kernels (natten3d.cu,
// natten3d_bwd.cu, natten_flash.cu, natten_flash_bwd.cu): loads that turn f32
// or bf16 elements into floats, stores that round floats to the element type,
// and the copy of a bf16 row into an f32 row of shared memory (the bf16
// modes stage their slabs as f32, converted on the copy, so that they share
// the f32 kernels' loops and plans; the copy is a plain load and store, not
// cp.async, which cannot convert).

#pragma once

#include <cuda_bf16.h>

#include <type_traits>

namespace nelem {

using bf16 = __nv_bfloat16;

template <class T>
constexpr bool is_bf16 = std::is_same_v<T, bf16>;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// x rounded to bf16 (to nearest, ties to even), as a float: by integer ops
// on its bits, which run at four times the rate of the conversions
// (finite x; what __float2bfloat16_rn gives).
__device__ __forceinline__ float round_bf16(float x) {
  const unsigned u = __float_as_uint(x);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

template <class T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (is_bf16<T>) {
    return __float2bfloat16_rn(x);
  } else {
    return x;
  }
}

// Element c of a global row, zero at or past n.
template <class T>
__device__ __forceinline__ float load1(const T* row, int c, int n) {
  return c < n ? to_f(__ldg(row + c)) : 0.f;
}

// Elements c .. c + 3 of a global row as a float4, zeros at or past n; one
// 16-byte (f32) or 8-byte (bf16) load when `vec` (c a multiple of 4, the row
// 16-byte aligned, n a multiple of 4).
template <class T>
__device__ __forceinline__ float4 load4(const T* row, int c, int n, bool vec) {
  if (vec) {
    if (c >= n) return make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (is_bf16<T>) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + c));
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      return make_float4(a.x, a.y, b.x, b.y);
    } else {
      return __ldg(reinterpret_cast<const float4*>(row + c));
    }
  }
  return make_float4(load1(row, c, n), load1(row, c + 1, n), load1(row, c + 2, n),
                     load1(row, c + 3, n));
}

// Stores x rounded to T at row[c], if c < n.
template <class T>
__device__ __forceinline__ void store1(T* row, int c, int n, float x) {
  if (c < n) row[c] = from_f<T>(x);
}

// dst[c .. c + 8) = the bf16 elements src[c .. c + 8) as floats, zeros at or
// past n (the row's channels); one 16-byte load when `vec` (n a multiple of 8,
// src 16-byte aligned). `ok` false: zeros.
__device__ __forceinline__ void convert8(float* dst, const bf16* src, int c, int n, bool vec,
                                         bool ok) {
  float x[8];
  if (ok && vec && c < n) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(src + c));
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = ok ? load1(src, c + i, n) : 0.f;
  }
  *reinterpret_cast<float4*>(dst + c) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(dst + c + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

}  // namespace nelem
