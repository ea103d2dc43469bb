// Row gather with a zero rule: out[j] = M[ids[j]], and the sacrificial id
// (the last row of M) gives a zero row.
//
// Replaces the Pallas TPU kernel _kernel of chemprop_tpu/ops/window_gather.py
// (launched by _window_gather_impl), which expands the mean readout's graph
// cotangent to the node table in the backward of sorted_segment_sum_counts.
// There the gather is a one-hot product over a sliding window of M, and ids
// outside the window (the padding rows' sacrificial id) come out as zeros.
// Here a row is copied as it is: one thread moves 16 bytes, neighbouring
// threads neighbouring bytes of one row, so the kernel is bound by bytes
// (ids and the rows of M read once, out written once; M is small and stays
// in L2). Rows are copied as raw bytes, so any dtype whose row is a multiple
// of 16 bytes is taken.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int GATHER_THREADS = 256;

__global__ void __launch_bounds__(GATHER_THREADS)
    row_gather_kernel(const uint4* __restrict__ M, const int* __restrict__ ids,
                      uint4* __restrict__ out, long long n_vec, int vec_per_row, int zero_id) {
  long long t = (long long)blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (t >= n_vec) return;
  long long row = t / vec_per_row;
  int c = (int)(t % vec_per_row);
  int id = ids[row];
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (id != zero_id) v = M[(long long)id * vec_per_row + c];
  out[t] = v;
}

// out [n, row_bytes] = M [m_rows, row_bytes] gathered by ids [n]; the id
// m_rows - 1 gives zeros. row_bytes is a multiple of 16.
extern "C" int row_gather(const void* M, const int* ids, void* out, int n, int m_rows,
                          int row_bytes, cudaStream_t stream) {
  if (row_bytes % 16 != 0 || m_rows < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int vec_per_row = row_bytes / 16;
  long long n_vec = (long long)n * vec_per_row;
  long long grid = (n_vec + GATHER_THREADS - 1) / GATHER_THREADS;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  row_gather_kernel<<<(unsigned)grid, GATHER_THREADS, 0, stream>>>(
      (const uint4*)M, ids, (uint4*)out, n_vec, vec_per_row, m_rows - 1);
  return (int)cudaGetLastError();
}
