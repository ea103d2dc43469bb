// The weight gradient of a dense layer over an edge table: dW = X^T G,
// [n x dx]^T [n x dg] -> [dx x dg] in float32 from bfloat16 tables.
//
// grad_weight replaces the Pallas TPU kernel _kernel of
// chemprop_tpu/ops/grad_weight.py (launched by grad_weight there). The TPU
// kernel walks the rows as one sequential grid and keeps the whole [dx x dg]
// accumulator in VMEM. Here blocks run in parallel and a [384 x 384] float32
// accumulator (590 KB) fits no block, so the rows are split over blocks and
// the output over 128 x 128 tiles, each block writes its tile of its split's
// partial sum, and a second small launch adds the partials in a fixed order
// (xtg.cuh): no atomics, so the result is the same bit for bit in every run.
//
// It is bound by bytes: X and G read once (190 MB at [123,392 x 384], against
// 2 n dx dg = 36 GFLOP on the tensor cores, a fifth of the time of the
// bytes); the partials (28 x 590 KB) and the output are small beside them.
// Each table is read by the three blocks that share a strip of it; the
// second and third reads come from L2 when the blocks run together.
#include "xtg.cuh"

__global__ void __launch_bounds__(XT_THREADS, 2)  // two blocks per SM: at most 128 registers
    grad_weight_kernel(const bf16* __restrict__ X, const bf16* __restrict__ G,
                       float* __restrict__ partial, int n, int dx, int dg, int rows_per_split) {
  __shared__ __align__(128) bf16 Xs[XT_K * XT_LD];
  __shared__ __align__(128) bf16 Gs[XT_K * XT_LD];
  const int m0 = blockIdx.x * XT_TILE, n0 = blockIdx.y * XT_TILE;
  const int r0 = blockIdx.z * rows_per_split;
  const int r1 = min(n, r0 + rows_per_split);
  XtAcc c[4][2];
  xtg_zero(c);
  for (int k0 = r0; k0 < r1; k0 += XT_K) {
    xtg_load(Xs, X, k0, r1, dx, m0);
    xtg_load(Gs, G, k0, r1, dg, n0);
    __syncthreads();
    xtg_accumulate(c, Xs, Gs);
    __syncthreads();  // the tiles are overwritten next
  }
  xtg_store(c, partial + (size_t)blockIdx.z * dx * dg, dg, m0, n0);
}

// the number of [dx x dg] float32 partials the caller allocates for n rows
extern "C" int grad_weight_splits(int n) { return xtg_n_splits(n); }

// out[dx x dg] = X^T G; X [n x dx] and G [n x dg] bfloat16 with dx and dg
// multiples of 128; partial holds grad_weight_splits(n) * dx * dg floats
extern "C" int grad_weight(const void* X, const void* G, float* partial, float* out, int n,
                           int dx, int dg, cudaStream_t stream) {
  if (dx % XT_TILE != 0 || dg % XT_TILE != 0 || dx <= 0 || dg <= 0)
    return (int)cudaErrorInvalidValue;
  int splits = xtg_n_splits(n);
  dim3 grid(dx / XT_TILE, dg / XT_TILE, splits);
  grad_weight_kernel<<<grid, XT_THREADS, 0, stream>>>((const bf16*)X, (const bf16*)G, partial, n,
                                                      dx, dg, xtg_rows_per_split(n));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)xtg_reduce(partial, out, splits, dx * dg, stream);
}
