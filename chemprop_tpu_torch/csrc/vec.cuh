// Four-element row vectors shared by the port's kernels: loads and stores of
// float32 or bfloat16 rows as float4 (16 bytes of float32, 8 of bfloat16),
// so that a warp's lanes read neighbouring addresses. Every row width the
// kernels take is a multiple of 4, and every row starts 16-byte (float32) or
// 8-byte (bfloat16) aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// dtype codes passed from Python
enum { DT_F32 = 0, DT_BF16 = 1 };

// a lane holds at most MAXV vectors of a row: widths up to 32 * 4 * MAXV
constexpr int MAXV = 8;
constexpr int MAX_WIDTH = 32 * 4 * MAXV;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// two floats rounded to a bf16 pair in 32 bits, and back
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ void add4(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ float4 relu4(float4 v) {
  return make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
}

// acc[j] += row[4 * (lane + 32 j)] for the lane's vectors of a d-wide row
template <typename T>
__device__ __forceinline__ void add_row(float4 (&acc)[MAXV], const T* row, int lane, int nv,
                                        bool relu) {
#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    int v = lane + 32 * j;
    if (v < nv) {
      float4 x = load4(row + 4 * v);
      add4(acc[j], relu ? relu4(x) : x);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_row(T* row, const float4 (&acc)[MAXV], int lane, int nv) {
#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    int v = lane + 32 * j;
    if (v < nv) store4(row + 4 * v, acc[j]);
  }
}

__device__ __forceinline__ void zero(float4 (&acc)[MAXV]) {
#pragma unroll
  for (int j = 0; j < MAXV; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
}
