// The parts of the fused depth iteration that fused_iter.cu (one iteration,
// kernel B) and iter2.cu (the first two, kernel D) share: the layout of a
// 64-row tile in shared memory, and the epilogue y = relu(H0 + z [+ b]) from
// the consumer warpgroup's wgmma accumulator, with its copy-out. Both kernels
// finish every row by this code, so that their outputs are equal bit for bit.
// `t` is the thread's index in its consumer warpgroup.
#pragma once

#include "sm90.cuh"
#include "vec.cuh"

constexpr int FI_ROWS = 64;            // edge rows per tile: wgmma's M
constexpr int FI_BOX = FI_ROWS * 128;  // one 64 x 64 bf16 box: a stage, a W or H0 box

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

struct Smem {
  uint32_t w, h0, ring, full, empty, wbar, h0bar;
};

// the epilogue in the consumer's registers: rows 16 (t / 32) + (t % 32) / 4
// (+ 8), columns 8 j + 2 (t % 4) (+ 1) of the slice; H0 there is in box
// j / 8, 16-byte chunk j % 8 of the row, swizzled, and y = relu(H0 + z [+ b])
// goes over it
template <int N>
__device__ __forceinline__ void epilogue(const float (&acc)[N / 2], const bf16* __restrict__ b,
                                         uint8_t* h0, int n0, int t) {
  constexpr int NB = N / 64;
  const int row = (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    uint32_t* hr = reinterpret_cast<uint32_t*>(h0 + r * 128) + t % 4;
#pragma unroll
    for (int box = 0; box < NB; ++box) {
      uint32_t hw[8];  // the box's loads first, then its stores
#pragma unroll
      for (int j = 0; j < 8; ++j) hw[j] = hr[box * FI_BOX / 4 + (j ^ (r % 8)) * 4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int jj = 8 * box + j;  // the 8-column block of the slice
        float2 hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hw[j]));
        float z0 = acc[4 * jj + 2 * h], z1 = acc[4 * jj + 2 * h + 1];
        if (b != nullptr) {
          float2 bv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(b + n0 + 8 * jj + 2 * (t % 4)));
          z0 += bv.x;
          z1 += bv.y;
        }
        hr[box * FI_BOX / 4 + (j ^ (r % 8)) * 4] =
            pack2(fmaxf(hv.x + z0, 0.f), fmaxf(hv.y + z1, 0.f));
      }
    }
  }
}

// the tile's y out of the H0 buffer in 16-byte chunks, eight lanes to a
// 128-byte row: rows e0 + r for e0 + r < end; LISTED (the row pass of
// fused_iter.cu): rows list[e0 + r] of y
template <int N, bool LISTED = false>
__device__ __forceinline__ void store_tile(bf16* __restrict__ y, const uint8_t* h0, int e0,
                                           int end, int d, int n0, int t,
                                           const int* __restrict__ list = nullptr) {
  constexpr int NB = N / 64;
#pragma unroll
  for (int i = t; i < NB * FI_ROWS * 8; i += 128) {
    const int box = i / (FI_ROWS * 8), r = i / 8 % FI_ROWS, ch = i % 8;
    const int e = e0 + r;
    if (e < end)
      *reinterpret_cast<uint4*>(y + (size_t)(LISTED ? __ldg(list + e) : e) * d + n0 +
                                64 * box + 8 * ch) =
          *reinterpret_cast<const uint4*>(h0 + box * FI_BOX + r * 128 + ((ch ^ (r % 8)) << 4));
  }
}
