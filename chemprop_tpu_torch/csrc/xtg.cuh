// The tall-skinny product X^T G, [n x dx]^T [n x dg] -> [dx x dg] in float32,
// for the weight gradient of message_bwd.cu's iter_bwd (G formed on the fly);
// grad_weight.cu, whose tables both come from device memory, has its own
// kernel on Hopper's TMA and wgmma.
//
// The output is tiny and the reduction runs over all n rows, so the rows are
// split: block (i, j, s) accumulates the XT_TILE x XT_TILE tile (i, j) of the
// product over the rows of split s, XT_K rows at a time through shared memory
// on the tensor cores (WMMA bf16 16x16x16, f32 accumulation), and stores its
// tile into the split's own [dx x dg] partial. xtg_reduce_kernel then adds
// the partials in the order of s. The partition depends on n alone and there
// are no atomics, so the result is the same bit for bit in every run.
#pragma once

#include <mma.h>

#include "vec.cuh"

constexpr int XT_TILE = 128;     // rows and columns of an output tile
constexpr int XT_K = 64;         // table rows per step
constexpr int XT_THREADS = 256;  // 8 warps: 2 x 4 warp tiles of 64 x 32
constexpr int XT_LD = XT_TILE + 8;  // padded row stride (elements) of Xs and Gs
constexpr int XT_MAX_SPLITS = 28;   // 9 tiles x 28 splits: one wave at 2 blocks per SM

typedef nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> XtAcc;

// rows per split, a multiple of XT_K, and the number of splits for n rows
static inline int xtg_rows_per_split(int n) {
  int steps = (n + XT_K - 1) / XT_K;
  int per = (steps + XT_MAX_SPLITS - 1) / XT_MAX_SPLITS;
  return (per > 0 ? per : 1) * XT_K;
}

static inline int xtg_n_splits(int n) {
  int rows = xtg_rows_per_split(n);
  int s = (n + rows - 1) / rows;
  return s > 0 ? s : 1;
}

__device__ __forceinline__ void xtg_zero(XtAcc (&c)[4][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(c[i][j], 0.f);
}

// XT_K rows x XT_TILE columns of a bf16 table, from column c0 of rows
// [k0, k0 + XT_K), into Ts[k][c]; rows from row_end on are zeros
__device__ __forceinline__ void xtg_load(bf16* Ts, const bf16* __restrict__ T, int k0,
                                         int row_end, int width, int c0) {
  for (int t = threadIdx.x; t < XT_K * XT_TILE / 8; t += XT_THREADS) {
    int k = t / (XT_TILE / 8), c8 = t % (XT_TILE / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + k < row_end)
      v = *reinterpret_cast<const uint4*>(T + (size_t)(k0 + k) * width + c0 + c8 * 8);
    *reinterpret_cast<uint4*>(Ts + k * XT_LD + c8 * 8) = v;
  }
}

// c += Xs^T Gs for Xs[k][m], Gs[k][n] of XT_K rows: X^T is read as a
// column-major matrix_a, so it is never formed
__device__ __forceinline__ void xtg_accumulate(XtAcc (&c)[4][2], const bf16* Xs, const bf16* Gs) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int kk = 0; kk < XT_K; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[4];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wmma::load_matrix_sync(a[i], Xs + kk * XT_LD + wm * 64 + i * 16, XT_LD);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(b[j], Gs + kk * XT_LD + wn * 32 + j * 16, XT_LD);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
  }
}

// the block's tile at (m0, n0) of a [dx x dg] float32 partial
__device__ __forceinline__ void xtg_store(const XtAcc (&c)[4][2], float* partial, int dg, int m0,
                                          int n0) {
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::store_matrix_sync(
          partial + (size_t)(m0 + wm * 64 + i * 16) * dg + n0 + wn * 32 + j * 16, c[i][j], dg,
          nvcuda::wmma::mem_row_major);
}

// out[i] = partial[0][i] + partial[1][i] + ... in that order; size % 4 == 0
static __global__ void xtg_reduce_kernel(const float* __restrict__ partial,
                                         float* __restrict__ out, int n_splits, int size) {
  int i = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= size) return;
  float4 acc = load4(partial + i);
  for (int s = 1; s < n_splits; ++s) add4(acc, load4(partial + (size_t)s * size + i));
  store4(out + i, acc);
}

static inline cudaError_t xtg_reduce(const float* partial, float* out, int n_splits, int size,
                                     cudaStream_t stream) {
  int threads = 256;
  int grid = (size / 4 + threads - 1) / threads;
  xtg_reduce_kernel<<<grid, threads, 0, stream>>>(partial, out, n_splits, size);
  return cudaGetLastError();
}
