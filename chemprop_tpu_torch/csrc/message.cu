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

template <typename T>
__global__ void __launch_bounds__(MSG_THREADS)
    plain_message_kernel(const T* __restrict__ H, const int* __restrict__ src,
                         const int* __restrict__ rev, const int* __restrict__ ptr,
                         T* __restrict__ out, int n_edges, int d, int pad_node) {
  int e = (blockIdx.x * MSG_THREADS + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (e >= n_edges) return;
  float4 acc[MAXV];
  message_row(acc, H, src, rev, ptr, e, d, pad_node, lane);
  store_row(out + (size_t)e * d, acc, lane, d >> 2);  // bfloat16: the one rounding
}

// float32 or bfloat16 tables (f32 sums in both)
extern "C" int plain_message(const void* H, const int* src, const int* rev, const int* ptr,
                             void* out, int n_edges, int d, int pad_node, int dtype,
                             cudaStream_t stream) {
  if (d % 4 != 0 || d > MAX_WIDTH) return (int)cudaErrorInvalidValue;
  int grid = (n_edges + MSG_THREADS / 32 - 1) / (MSG_THREADS / 32);
  if (grid == 0) return 0;
  if (dtype == DT_F32)
    plain_message_kernel<float><<<grid, MSG_THREADS, 0, stream>>>(
        (const float*)H, src, rev, ptr, (float*)out, n_edges, d, pad_node);
  else if (dtype == DT_BF16)
    plain_message_kernel<bf16><<<grid, MSG_THREADS, 0, stream>>>(
        (const bf16*)H, src, rev, ptr, (bf16*)out, n_edges, d, pad_node);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
