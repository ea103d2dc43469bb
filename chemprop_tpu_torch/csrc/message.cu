// The D-MPNN message:
//
//   M[e] = sum_{k : dst[k] == src[e]} H[k] - H[rev[e]]
//
// plain_message replaces the Pallas TPU kernel _kernel of
// chemprop_tpu/ops/fused_message.py (launched by _fused_message_impl). The
// fused iteration (_iter_kernel) is fused_iter.cu's, the first two chained
// (_iter2_kernel) iter2.cu's. The TPU kernels form the message as a one-hot
// product over a sliding window of 128-edge chunks, because the MXU is their
// only fast unit. Here edges are sorted by dst and the in-edges of node v are
// rows [ptr[v], ptr[v+1]), so the message of edge e is a gather-sum over the
// in-edges of src[e]: no one-hot work at all.
//
// Padding edges all have src = dst = the padding node, whose in-edge range
// is every padding row; summing it for each padding edge would be quadratic
// in the padding. Their rows get exact zeros instead (the TPU kernels leave
// garbage there; no real row reads a padding row either way).
//
// plain_message is bound by bytes: it reads H and writes M once (the rows of
// an edge's neighbours come from L2, since a molecule's edges are adjacent).
// One warp forms one edge's row with f32 accumulation.
//
// message_rows is the same kernel over a list of rows: it forms M again at
// those rows only and leaves every other row of M as it is. It is the
// second pass of message_tiles.cu over a split tile table (a molecule of
// more than 128 rows cut at its nodes' boundaries): the rows whose reverse
// lies in another tile, which the tile kernel flags and writes as NaN, are
// formed here with message_row, so that they get plain_message's sums in its
// order, rounded once: the bits every other row gets.
#include "vec.cuh"

constexpr int MSG_THREADS = 256;  // 8 warps, one edge each

template <typename T>
__device__ __forceinline__ void message_row(float4 (&acc)[MAXV], const T* H,
                                            const int* __restrict__ src,
                                            const int* __restrict__ rev,
                                            const int* __restrict__ ptr, int e, int d,
                                            int pad_node, int lane) {
  zero(acc);
  int s = src[e];
  if (s == pad_node) return;  // padding edge: zeros
  int nv = d >> 2;
  for (int k = ptr[s]; k < ptr[s + 1]; ++k) add_row(acc, H + (size_t)k * d, lane, nv, false);
  float4 r[MAXV];
  zero(r);
  add_row(r, H + (size_t)rev[e] * d, lane, nv, false);
#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    acc[j].x -= r[j].x;
    acc[j].y -= r[j].y;
    acc[j].z -= r[j].z;
    acc[j].w -= r[j].w;
  }
}

// warp w forms row rows[w] (row w where rows is null) of the n listed rows
template <typename T>
__global__ void __launch_bounds__(MSG_THREADS)
    message_kernel(const T* __restrict__ H, const int* __restrict__ src,
                   const int* __restrict__ rev, const int* __restrict__ ptr,
                   const int* __restrict__ rows, T* __restrict__ out, int n, int d,
                   int pad_node) {
  int w = (blockIdx.x * MSG_THREADS + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (w >= n) return;
  int e = rows == nullptr ? w : rows[w];
  float4 acc[MAXV];
  message_row(acc, H, src, rev, ptr, e, d, pad_node, lane);
  store_row(out + (size_t)e * d, acc, lane, d >> 2);  // bfloat16: the one rounding
}

static int launch_message(const void* H, const int* src, const int* rev, const int* ptr,
                          const int* rows, void* out, int n, int d, int pad_node, int dtype,
                          cudaStream_t stream) {
  if (d % 4 != 0 || d > MAX_WIDTH || n < 0) return (int)cudaErrorInvalidValue;
  int grid = (n + MSG_THREADS / 32 - 1) / (MSG_THREADS / 32);
  if (grid == 0) return 0;
  if (dtype == DT_F32)
    message_kernel<float><<<grid, MSG_THREADS, 0, stream>>>(
        (const float*)H, src, rev, ptr, rows, (float*)out, n, d, pad_node);
  else if (dtype == DT_BF16)
    message_kernel<bf16><<<grid, MSG_THREADS, 0, stream>>>(
        (const bf16*)H, src, rev, ptr, rows, (bf16*)out, n, d, pad_node);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// float32 or bfloat16 tables (f32 sums in both)
extern "C" int plain_message(const void* H, const int* src, const int* rev, const int* ptr,
                             void* out, int n_edges, int d, int pad_node, int dtype,
                             cudaStream_t stream) {
  return launch_message(H, src, rev, ptr, nullptr, out, n_edges, d, pad_node, dtype, stream);
}

// out [n_edges x d] at the n_rows rows listed in rows (int32, each in
// [0, n_edges)), from H of the same shape and dtype; every other row of out
// is left as it is
extern "C" int message_rows(const void* H, const int* src, const int* rev, const int* ptr,
                            const int* rows, void* out, int n_rows, int d, int pad_node,
                            int dtype, cudaStream_t stream) {
  return launch_message(H, src, rev, ptr, rows, out, n_rows, d, pad_node, dtype, stream);
}
