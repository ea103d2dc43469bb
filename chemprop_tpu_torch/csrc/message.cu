// The D-MPNN message and the chained first two depth iterations.
//
//   message:     M[e] = sum_{k : dst[k] == src[e]} H[k] - H[rev[e]]
//   fused_iter2: y1 = iteration(relu(H0)), y2 = iteration(y1), in one launch,
//                where iteration(H)[e] = relu(H0[e] + bf16(M[e]) @ W [+ b])
//
// plain_message replaces the Pallas TPU kernel _kernel of
// chemprop_tpu/ops/fused_message.py (launched by _fused_message_impl);
// fused_iter2 replaces _iter2_kernel there (launched by _iter2_impl). The
// single iteration (_iter_kernel) is fused_iter.cu's. The TPU kernels form
// the message as a one-hot product over a sliding window of 128-edge chunks,
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
// fused_iter2 chains the first two iterations. It is bound by bytes: H0 read
// once, y1 and y2 written once (three edge tables against the six of two
// single iterations). Iteration 2 at edge e gathers y1 at the in-edges of
// src[e] and at rev[e], rows that another block of a fixed row tiling would
// own, and blocks cannot wait on each other. Those rows all belong to e's
// own molecule, and a molecule's edge rows are contiguous, so a block here
// owns whole molecules: a tile table (row offsets, packed on the host by the
// collate) gives each block up to 128 rows that no other block's second
// iteration reads. The block forms its y1 rows, writes them out (the
// backward needs them), and after a block barrier gathers them back for
// iteration 2 from L2, where they have just been written. Each iteration
// (iteration_rows) forms the block's bf16 message rows in shared memory
// (f32 sums in the order of the edges, as fused_iter.cu), multiplies them by
// W on the tensor cores (WMMA bf16 16x16x16 with f32 accumulation; W streams
// through shared memory in BK x BN panels) and adds H0, the bias and the
// ReLU on the way out. y1 and y2 equal two fused_iter launches bit for bit
// on the main path's shapes (chip_smoke.py and the card tests check it): the
// messages are summed in the same order, though the products run on WMMA
// here and on wgmma there. A molecule of more than 128 edge rows cannot be
// served; the caller sees that from the tile table and takes two fused_iter
// launches for that batch.
#include <mma.h>

#include "vec.cuh"

using namespace nvcuda;

constexpr int MSG_THREADS = 256;  // 8 warps, one edge each

template <typename T>
__device__ __forceinline__ void message_row(float4 (&acc)[MAXV], const T* H,
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

template <typename T>
__global__ void __launch_bounds__(MSG_THREADS)
    plain_message_kernel(const T* __restrict__ H, const int* __restrict__ src,
                         const int* __restrict__ rev, const int* __restrict__ ptr,
                         T* __restrict__ out, int n_edges, int d, int pad_node) {
  int e = (blockIdx.x * MSG_THREADS + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (e >= n_edges) return;
  float4 acc[MAXV];
  message_row(acc, H, src, rev, ptr, e, d, pad_node, false, lane);
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

// ------------------------------------------------------------ iteration_rows
constexpr int BM2 = 128;  // edge rows per block of fused_iter2 (a tile of whole molecules)
constexpr int BN = 128;   // output columns per pass over W
constexpr int BK = 64;    // rows of a W panel
constexpr int LDW = BN + 8;  // padded row strides (elements) against bank conflicts
constexpr int LDC = BN + 4;

// ROWS edge rows per block run on ROWS * 4 threads: ROWS / 32 x 4 warp tiles
// of 32 x 32 over a ROWS x BN strip of the product
template <int ROWS>
static size_t iter_smem_bytes(int d) {
  return (size_t)ROWS * (d + 8) * sizeof(bf16) + (size_t)BK * LDW * sizeof(bf16) +
         (size_t)ROWS * LDC * sizeof(float);
}

// Rows [m0, m0 + rows) of one iteration, rows <= ROWS, by the whole block:
// the bf16 message rows of H into Ms, Ms @ W one BN-column strip at a time
// through the panel Ws into Cs, then out = relu(H0 + z [+ b]). H may be a
// table this kernel wrote itself (no __restrict__, so no read-only loads).
template <int ROWS>
__device__ __forceinline__ void iteration_rows(
    const bf16* H, const bf16* __restrict__ H0, const bf16* __restrict__ W,
    const bf16* __restrict__ b, const int* __restrict__ src, const int* __restrict__ rev,
    const int* __restrict__ ptr, bf16* out, bf16* Ms, bf16* Ws, float* Cs, int m0, int rows,
    int d, int pad_node, bool relu_stream) {
  constexpr int THREADS = ROWS * 4;
  const int ldm = d + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1. the block's message rows, relu applied to the gathered rows only
  for (int i = warp; i < ROWS; i += THREADS / 32) {
    float4 acc[MAXV];
    if (i < rows)
      message_row(acc, H, src, rev, ptr, m0 + i, d, pad_node, relu_stream, lane);
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
      for (int t = threadIdx.x; t < BK * BN / 8; t += THREADS) {
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
    for (int t = threadIdx.x; t < ROWS * BN / 4; t += THREADS) {
      int r = t / (BN / 4), c4 = (t % (BN / 4)) * 4;
      if (r >= rows) continue;
      int e = m0 + r;
      int col = n0 + c4;
      float4 z = *reinterpret_cast<const float4*>(Cs + r * LDC + c4);
      if (b != nullptr) add4(z, load4(b + col));
      float4 h = load4(H0 + (size_t)e * d + col);
      add4(h, z);
      store4(out + (size_t)e * d + col, relu4(h));
    }
    __syncthreads();  // Cs is overwritten by the next strip
  }
}

// every array starts on a 128-byte boundary: ROWS * (d + 8) * 2 and
// BK * LDW * 2 are multiples of 128 for d a multiple of 128, and every
// WMMA tile pointer is then 32-byte aligned as WMMA requires
#define ITER_SMEM(ROWS)                                                               \
  extern __shared__ __align__(128) unsigned char smem[];                              \
  bf16* Ms = reinterpret_cast<bf16*>(smem);              /* [ROWS][d + 8] messages */ \
  bf16* Ws = Ms + ROWS * (d + 8);                        /* [BK][LDW] panel of W */   \
  float* Cs = reinterpret_cast<float*>(Ws + BK * LDW);   /* [ROWS][LDC] f32 product */

// --------------------------------------------------------------- fused_iter2
// Block t owns rows [tiles[t], tiles[t + 1]), at most BM2 of them: whole
// molecules, or a run of padding rows. y1 is written, then read back by this
// block alone after the barrier that ends iteration 1's last strip.
__global__ void __launch_bounds__(BM2 * 4)
    fused_iter2_kernel(const bf16* __restrict__ H0, const bf16* __restrict__ W,
                       const bf16* __restrict__ b, const int* __restrict__ src,
                       const int* __restrict__ rev, const int* __restrict__ ptr,
                       const int* __restrict__ tiles, bf16* y1, bf16* y2, int d, int pad_node) {
  ITER_SMEM(BM2)
  const int m0 = tiles[blockIdx.x];
  const int rows = min(BM2, tiles[blockIdx.x + 1] - m0);
  iteration_rows<BM2>(H0, H0, W, b, src, rev, ptr, y1, Ms, Ws, Cs, m0, rows, d, pad_node, true);
  iteration_rows<BM2>(y1, H0, W, b, src, rev, ptr, y2, Ms, Ws, Cs, m0, rows, d, pad_node, false);
}

// the most rows a tile of the table may hold
extern "C" int fused_iter2_tile_rows() { return BM2; }

extern "C" int fused_iter2(const void* H0, const void* W, const void* b, const int* src,
                           const int* rev, const int* ptr, const int* tiles, void* y1, void* y2,
                           int n_tiles, int d, int pad_node, cudaStream_t stream) {
  if (d % BN != 0 || d > MAX_WIDTH) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  size_t smem = iter_smem_bytes<BM2>(d);
  cudaError_t err = cudaFuncSetAttribute(fused_iter2_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_iter2_kernel<<<n_tiles, BM2 * 4, smem, stream>>>(
      (const bf16*)H0, (const bf16*)W, (const bf16*)b, src, rev, ptr, tiles, (bf16*)y1,
      (bf16*)y2, d, pad_node);
  return (int)cudaGetLastError();
}
