// The D-MPNN message and the fused depth iteration.
//
//   message:     M[e] = sum_{k : dst[k] == src[e]} H[k] - H[rev[e]]
//   fused_iter:  y[e] = relu(H0[e] + bf16(M[e]) @ W [+ b])
//
// plain_message replaces the Pallas TPU kernel _kernel of
// chemprop_tpu/ops/fused_message.py (launched by _fused_message_impl);
// fused_iter replaces _iter_kernel there (launched by _iter_impl), with its
// relu_stream form for the first depth iteration. The TPU kernels form the
// message as a one-hot product over a sliding window of 128-edge chunks,
// because the MXU is their only fast unit. Here edges are sorted by dst and
// the in-edges of node v are rows [ptr[v], ptr[v+1]), so the message of edge
// e is a gather-sum over the in-edges of src[e]: no one-hot work at all.
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
// fused_iter is bound by bytes too (it reads H and H0 and writes y; the
// 2*E*d*d GEMM needs about half the time the bytes do at d=384), and it keeps
// the message table M out of device memory: a block forms the bf16 message
// rows of BM edges in shared memory, multiplies them by W on the tensor cores
// (WMMA bf16 16x16x16 with f32 accumulation; W streams through shared memory
// in BK x BN panels), and adds H0, the bias and the ReLU on the way out.
#include <mma.h>

#include "vec.cuh"

using namespace nvcuda;

constexpr int MSG_THREADS = 256;  // 8 warps, one edge each

template <typename T>
__device__ __forceinline__ void message_row(float4 (&acc)[MAXV], const T* __restrict__ H,
                                            const int* __restrict__ src,
                                            const int* __restrict__ rev,
                                            const int* __restrict__ ptr, int e, int d,
                                            int pad_node, bool relu, int lane) {
  zero(acc);
  int s = src[e];
  if (s == pad_node) return;  // padding edge: zeros
  int nv = d >> 2;
  for (int k = ptr[s]; k < ptr[s + 1]; ++k) add_row(acc, H + (size_t)k * d, lane, nv, relu);
  float4 r[MAXV];
  zero(r);
  add_row(r, H + (size_t)rev[e] * d, lane, nv, relu);
#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    acc[j].x -= r[j].x;
    acc[j].y -= r[j].y;
    acc[j].z -= r[j].z;
    acc[j].w -= r[j].w;
  }
}

// float32 only: the bfloat16 forward forms its messages inside fused_iter
__global__ void __launch_bounds__(MSG_THREADS)
    plain_message_kernel(const float* __restrict__ H, const int* __restrict__ src,
                         const int* __restrict__ rev, const int* __restrict__ ptr,
                         float* __restrict__ out, int n_edges, int d, int pad_node) {
  int e = (blockIdx.x * MSG_THREADS + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (e >= n_edges) return;
  float4 acc[MAXV];
  message_row(acc, H, src, rev, ptr, e, d, pad_node, false, lane);
  store_row(out + (size_t)e * d, acc, lane, d >> 2);
}

extern "C" int plain_message(const float* H, const int* src, const int* rev, const int* ptr,
                             float* out, int n_edges, int d, int pad_node, cudaStream_t stream) {
  if (d % 4 != 0 || d > MAX_WIDTH) return (int)cudaErrorInvalidValue;
  int grid = (n_edges + MSG_THREADS / 32 - 1) / (MSG_THREADS / 32);
  if (grid == 0) return 0;
  plain_message_kernel<<<grid, MSG_THREADS, 0, stream>>>(H, src, rev, ptr, out, n_edges, d,
                                                         pad_node);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- fused_iter
constexpr int BM = 64;   // edge rows per block
constexpr int BN = 128;  // output columns per pass over W
constexpr int BK = 64;   // rows of a W panel
constexpr int ITER_THREADS = 256;  // 8 warps: 2 x 4 warp tiles of 32 x 32
constexpr int LDW = BN + 8;        // padded row strides (elements) against bank conflicts
constexpr int LDC = BN + 4;

static size_t iter_smem_bytes(int d) {
  return (size_t)BM * (d + 8) * sizeof(bf16) + (size_t)BK * LDW * sizeof(bf16) +
         (size_t)BM * LDC * sizeof(float);
}

__global__ void __launch_bounds__(ITER_THREADS)
    fused_iter_kernel(const bf16* __restrict__ H, const bf16* __restrict__ H0,
                      const bf16* __restrict__ W, const bf16* __restrict__ b,
                      const int* __restrict__ src, const int* __restrict__ rev,
                      const int* __restrict__ ptr, bf16* __restrict__ y, int n_edges, int d,
                      int pad_node, int relu_stream) {
  // every array starts on a 128-byte boundary: BM * (d + 8) * 2 and
  // BK * LDW * 2 are multiples of 128 for d a multiple of 128, and every
  // WMMA tile pointer below is then 32-byte aligned as WMMA requires
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldm = d + 8;
  bf16* Ms = reinterpret_cast<bf16*>(smem);  // [BM][ldm] message rows, bf16
  bf16* Ws = Ms + BM * ldm;                  // [BK][LDW] panel of W
  float* Cs = reinterpret_cast<float*>(Ws + BK * LDW);  // [BM][LDC] f32 product

  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1. the block's message rows, relu applied to the gathered rows only
  for (int i = warp; i < BM; i += ITER_THREADS / 32) {
    float4 acc[MAXV];
    if (m0 + i < n_edges)
      message_row(acc, H, src, rev, ptr, m0 + i, d, pad_node, relu_stream != 0, lane);
    else
      zero(acc);
    store_row(Ms + i * ldm, acc, lane, d >> 2);
  }
  __syncthreads();

  // 2. Ms @ W one BN-column strip at a time, then the epilogue per strip
  const int wm = warp >> 2, wn = warp & 3;  // this warp's 32 x 32 tile of the strip
  for (int n0 = 0; n0 < d; n0 += BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

    for (int k0 = 0; k0 < d; k0 += BK) {
      for (int t = threadIdx.x; t < BK * BN / 8; t += ITER_THREADS) {
        int r = t / (BN / 8), c8 = t % (BN / 8);
        *reinterpret_cast<uint4*>(Ws + r * LDW + c8 * 8) =
            *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * d + n0 + c8 * 8);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], Ms + (wm * 32 + i * 16) * ldm + k0 + kk, ldm);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bw[j], Ws + kk * LDW + wn * 32 + j * 16, LDW);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], bw[j], c[i][j]);
      }
      __syncthreads();  // the panel is overwritten next
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, c[i][j], LDC,
                                wmma::mem_row_major);
    __syncthreads();

    // 3. y = relu(H0 + z [+ b]) in f32, one bf16 store
    for (int t = threadIdx.x; t < BM * BN / 4; t += ITER_THREADS) {
      int r = t / (BN / 4), c4 = (t % (BN / 4)) * 4;
      int e = m0 + r;
      if (e >= n_edges) continue;
      int col = n0 + c4;
      float4 z = *reinterpret_cast<const float4*>(Cs + r * LDC + c4);
      if (b != nullptr) add4(z, load4(b + col));
      float4 h = load4(H0 + (size_t)e * d + col);
      add4(h, z);
      store4(y + (size_t)e * d + col, relu4(h));
    }
    __syncthreads();  // Cs is overwritten by the next strip
  }
}

extern "C" int fused_iter(const void* H, const void* H0, const void* W, const void* b,
                          const int* src, const int* rev, const int* ptr, void* y, int n_edges,
                          int d, int pad_node, int relu_stream, cudaStream_t stream) {
  if (d % BN != 0 || d > MAX_WIDTH) return (int)cudaErrorInvalidValue;
  int grid = (n_edges + BM - 1) / BM;
  if (grid == 0) return 0;
  size_t smem = iter_smem_bytes(d);
  // the opt-in above 48 KB is per device, so it is made at every launch (cheap)
  cudaError_t err = cudaFuncSetAttribute(fused_iter_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_iter_kernel<<<grid, ITER_THREADS, smem, stream>>>(
      (const bf16*)H, (const bf16*)H0, (const bf16*)W, (const bf16*)b, src, rev, ptr, (bf16*)y,
      n_edges, d, pad_node, relu_stream);
  return (int)cudaGetLastError();
}
