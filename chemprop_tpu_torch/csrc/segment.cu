// Sorted segment sum, optionally with per-segment row counts.
//
// Replaces the Pallas TPU kernel chemprop_tpu/ops/sorted_segments.py
// (_make_kernel, launched by _sorted_segment_sum_fwd_impl; its with_counts
// variant serves sorted_segment_sum_counts). There, one-hot matrices on the
// MXU reduce 128-row chunks into 256-segment tiles. Here the rows are sorted
// by segment and the segment boundaries come as CSR pointers, so segment s is
// rows [ptr[s], ptr[s+1]) and no one-hot product is needed.
//
// Bound on the H100: bytes. Each input row is read once and each output row
// written once; there are no operations to speak of (one add per element).
// The design keeps the reads coalesced (a warp reads a row as neighbouring
// 4-element vectors) and the sum deterministic and free of atomics (a fixed
// order for every segment), with f32 accumulation and one cast on store.
//
// Long segments are the trap: the padding node and the padding graph own
// every padding row, thousands of them, and one warp walking them alone
// would serialise the launch. So pass 1 gives each short segment (at most
// TILE rows) one warp, and cuts the rows into TILE-row tiles whose warps sum
// the parts of long segments inside their tile into a scratch table (a tile
// meets at most two long segments: the one it starts in and the one it ends
// in). Pass 2 gives each long segment one warp, found by the tile it starts
// in, that adds its tiles' partial sums in tile order.
#include "vec.cuh"

constexpr int TILE = 32;     // rows per tile, and the most rows of a short segment
constexpr int THREADS = 256;  // 8 warps per block

template <typename Tin>
__device__ __forceinline__ void sum_rows(float4 (&acc)[MAXV], const Tin* data, int lo, int hi,
                                         int d, int lane) {
  for (int r = lo; r < hi; ++r) add_row(acc, data + (size_t)r * d, lane, d >> 2, false);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
    seg_pass1(const Tin* __restrict__ data, const int* __restrict__ ids,
              const int* __restrict__ ptr, Tout* __restrict__ out, float* __restrict__ counts,
              float* __restrict__ scratch, int n_rows, int n_seg, int d) {
  int warp = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  int nv = d >> 2;
  float4 acc[MAXV];
  zero(acc);
  if (warp < n_seg) {  // one short segment
    int lo = ptr[warp], hi = ptr[warp + 1];
    if (hi - lo > TILE) return;  // long: summed by the tiles and pass 2
    sum_rows(acc, data, lo, hi, d, lane);
    store_row(out + (size_t)warp * d, acc, lane, nv);
    if (counts != nullptr && lane == 0) counts[warp] = (float)(hi - lo);
    return;
  }
  int k = warp - n_seg;  // one row tile
  int r0 = k * TILE;
  if (r0 >= n_rows) return;
  int r1 = min(r0 + TILE, n_rows);
  int s0 = ids[r0], s1 = ids[r1 - 1];
  if (ptr[s0 + 1] - ptr[s0] > TILE) {  // slot 0: the long segment the tile starts in
    sum_rows(acc, data, r0, min(r1, ptr[s0 + 1]), d, lane);
    store_row(scratch + (size_t)(2 * k) * d, acc, lane, nv);
  }
  if (s1 != s0 && ptr[s1 + 1] - ptr[s1] > TILE) {  // slot 1: the one it ends in
    zero(acc);
    sum_rows(acc, data, max(r0, ptr[s1]), r1, d, lane);
    store_row(scratch + (size_t)(2 * k + 1) * d, acc, lane, nv);
  }
}

// the reduction of long segment s: its tiles' partial sums, in tile order
template <typename Tout>
__device__ void reduce_long(const float* __restrict__ scratch, const int* __restrict__ ptr,
                            Tout* __restrict__ out, float* __restrict__ counts, int s, int d,
                            int lane) {
  int lo = ptr[s], hi = ptr[s + 1];
  int k0 = lo / TILE, k1 = (hi - 1) / TILE;
  float4 acc[MAXV];
  zero(acc);
  // the segment covers the first row of every tile after its first, so it is
  // their slot 0; in its first tile it is slot 1 unless it starts the tile.
  // No load decides the address, so the unrolled loads can all be in flight.
#pragma unroll 4
  for (int k = k0; k <= k1; ++k) {
    int slot = (k == k0 && lo != k0 * TILE) ? 1 : 0;
    add_row(acc, scratch + (size_t)(2 * k + slot) * d, lane, d >> 2, false);
  }
  store_row(out + (size_t)s * d, acc, lane, d >> 2);
  if (counts != nullptr && lane == 0) counts[s] = (float)(hi - lo);
}

// one warp per row tile: it reduces the long segments that start in its tile
// (each long segment starts in exactly one), so only the few long segments
// are visited, not every segment
template <typename Tout>
__global__ void __launch_bounds__(THREADS)
    seg_pass2(const float* __restrict__ scratch, const int* __restrict__ ids,
              const int* __restrict__ ptr, Tout* __restrict__ out, float* __restrict__ counts,
              int n_rows, int d) {
  int k = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  int r0 = k * TILE;
  if (r0 >= n_rows) return;
  int r1 = min(r0 + TILE, n_rows);
  int s0 = ids[r0], s1 = ids[r1 - 1];
  if (ptr[s0] == r0 && ptr[s0 + 1] - r0 > TILE)
    reduce_long(scratch, ptr, out, counts, s0, d, lane);
  // a long segment other than s0 that meets this tile starts inside it
  if (s1 != s0 && ptr[s1 + 1] - ptr[s1] > TILE)
    reduce_long(scratch, ptr, out, counts, s1, d, lane);
}

template <typename Tin, typename Tout>
static cudaError_t launch(const void* data, const int* ids, const int* ptr, void* out,
                          float* counts, float* scratch, int n_rows, int n_seg, int d,
                          cudaStream_t stream) {
  int n_tiles = (n_rows + TILE - 1) / TILE;
  int warps_per_block = THREADS / 32;
  int grid1 = (n_seg + n_tiles + warps_per_block - 1) / warps_per_block;
  int grid2 = (n_tiles + warps_per_block - 1) / warps_per_block;
  if (grid1 > 0)
    seg_pass1<Tin, Tout><<<grid1, THREADS, 0, stream>>>(
        (const Tin*)data, ids, ptr, (Tout*)out, counts, scratch, n_rows, n_seg, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (grid2 > 0)
    seg_pass2<Tout><<<grid2, THREADS, 0, stream>>>(scratch, ids, ptr, (Tout*)out, counts, n_rows,
                                                   d);
  return cudaGetLastError();
}

extern "C" int seg_scratch_rows(int n_rows) { return 2 * ((n_rows + TILE - 1) / TILE); }

// out[s] = sum of data rows [ptr[s], ptr[s+1]) for s < n_seg, cast to out's
// dtype; counts[s] = ptr[s+1] - ptr[s] when counts is not null. scratch holds
// seg_scratch_rows(n_rows) f32 rows of width d. The dtype pairs are those of
// the readouts: f32 -> f32, bf16 -> bf16 (M_v) and bf16 -> f32 (by graph).
extern "C" int seg_sum(const void* data, const int* ids, const int* ptr, void* out,
                       float* counts, float* scratch, int n_rows, int n_seg, int d, int in_dtype,
                       int out_dtype, cudaStream_t stream) {
  if (d % 4 != 0 || d > MAX_WIDTH) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (in_dtype == DT_F32 && out_dtype == DT_F32)
    err = launch<float, float>(data, ids, ptr, out, counts, scratch, n_rows, n_seg, d, stream);
  else if (in_dtype == DT_BF16 && out_dtype == DT_F32)
    err = launch<bf16, float>(data, ids, ptr, out, counts, scratch, n_rows, n_seg, d, stream);
  else if (in_dtype == DT_BF16 && out_dtype == DT_BF16)
    err = launch<bf16, bf16>(data, ids, ptr, out, counts, scratch, n_rows, n_seg, d, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}
