// The backward of the D-MPNN message: the masked transposed message, from an
// edge cotangent (bwd_message) or from a node cotangent (bwd_message_nodes);
// and the whole backward of one iteration with the weight gradient
// (iter_bwd). The premultiplied form is bwd_premul.cu's.
//
//   gz[k] = g[k] * [y[k] > 0]
//   G[e]  = sum_{k : src[k] == dst[e]} gz[k] - gz[rev[e]]        (S - R)^T gz
//
// bwd_message replaces the Pallas TPU kernel _bwd_msg_kernel of
// chemprop_tpu/ops/fused_message.py (launched by _bwd_msg_impl, with its
// has_acc form gz_out = gz + gz_acc); bwd_message_nodes replaces
// _bwd_msg_nodes_kernel (launched by _bwd_msg_nodes_impl), where
// g[k] = g_nodes[dst[k]] is formed on chip. transposed_message is the same
// sum with no mask: the backward of the message kernel itself, and the node
// pass of bwd_premul.cu's form without a tile table.
//
// The TPU kernels form (S - R)^T as a one-hot product over a sliding window of
// 128-edge chunks. Here no scatter and no one-hot work is needed: the edges
// are sorted by dst with ptr its CSR, and src[k] = dst[rev[k]], so the
// out-edges of node v are {rev[j] : j in [ptr[v], ptr[v+1])}. Every edge into
// v therefore shares T[v] = sum_j gz[rev[j]], and G[j] = T[v] - gz[rev[j]].
// One warp per node walks the node's contiguous in-edge rows: it forms T[v]
// in f32, then writes G and gz for those rows. Sums run in a fixed order and
// there are no atomics, so a launch is reproducible bit for bit.
//
// Padding edges all have src = dst = the padding node (the last one). Their
// rows of G and gz get exact zeros and the padding node is never walked (it
// owns thousands of rows). The weight gradients x^T G sum over all rows, so
// these zeros are load-bearing.
//
// Both are bound by bytes on the H100: g (or the node table), y and gz_acc
// read once, G and gz written once; the gathers at rev[j] stay inside one
// molecule's rows and come from L2.
//
// iter_bwd replaces _iter_bwd_kernel there (launched by _iter_bwd_impl): from
// the cotangent g, the saved output y, the iteration's input H and W it gives
// dH = bf16(G) W^T, gz, and dW = H^T bf16(G) in float32, and G is never
// written. g and y are both inputs, so the mask is applied while gathering
// (gz[rev[j]] = g[rev[j]] * [y[rev[j]] > 0]) and no block waits on another:
// one warp forms one edge's row of G, with the node pass's sums in its order,
// so G equals bwd_message's bit for bit. It is bound by bytes: g, y and H
// read once, dH and gz written once (five bf16 edge tables; the two products,
// 4 E d d operations on the tensor cores, take about half the time of the
// bytes at d = 384). The trouble is dW: a [384 x 384] float32 accumulator
// (590 KB) fits no block, and float atomics would make runs differ. So
// iter_bwd is three launches behind one entry point. The first forms each
// 64-row tile of G in shared memory and multiplies it by W^T (WMMA bf16
// 16x16x16 with f32 accumulation, W^T streamed through shared memory in
// panels, rows_times_wt) and writes dH and gz. The second is the split
// product of xtg.cuh with its G operand formed on the fly, a 128-column strip
// of a 64-row tile at a time (every strip is formed by the three blocks that
// share it, so G is gathered four times in all: the price of not writing
// it). The third adds the splits' partials in a fixed order. Rows of the
// padding edges give zeros in dH and gz, and H's padding rows never reach dW.
#include <mma.h>

#include "xtg.cuh"

using namespace nvcuda;

constexpr int NODE_THREADS = 256;  // 8 warps, one node each
constexpr int ZERO_WARPS = 1024;   // warps that zero the padding rows

__device__ __forceinline__ float4 mask4(float4 g, float4 y) {
  return make_float4(y.x > 0.f ? g.x : 0.f, y.y > 0.f ? g.y : 0.f, y.z > 0.f ? g.z : 0.f,
                     y.w > 0.f ? g.w : 0.f);
}

template <typename T>
__device__ __forceinline__ void zero_row(T* row, int lane, int nv) {
  float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int v = lane; v < nv; v += 32) store4(row + 4 * v, z);
}

// gz at edge row r for this lane's vector v: the cotangent row (an edge row,
// or the node row of dst[r]) under the mask of y[r]; no mask when y is null
template <typename T>
__device__ __forceinline__ float4 gz_at(const T* __restrict__ g, const T* __restrict__ y,
                                        const int* __restrict__ dst, bool nodes, int r, int d,
                                        int v) {
  size_t grow = nodes ? (size_t)dst[r] : (size_t)r;
  float4 x = load4(g + grow * d + 4 * v);
  if (y != nullptr) x = mask4(x, load4(y + (size_t)r * d + 4 * v));
  return x;
}

// One warp per node v < pad_node; the warps past them zero the padding rows.
//   g      [E, d], or [N, d] when nodes != 0
//   y      [E, d] or null (no mask)
//   acc    [E, d] or null: gz_out = gz + acc, summed in f32
//   G      [E, d]
//   gz_out [E, d] or null (not written)
template <typename T>
__global__ void __launch_bounds__(NODE_THREADS)
    bwd_message_kernel(const T* __restrict__ g, const T* __restrict__ y,
                       const T* __restrict__ acc, const int* __restrict__ dst,
                       const int* __restrict__ rev, const int* __restrict__ ptr,
                       T* __restrict__ G, T* __restrict__ gz_out, int n_edges, int d,
                       int pad_node, int nodes) {
  int w = (blockIdx.x * NODE_THREADS + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  int nv = d >> 2;
  if (w >= pad_node) {  // padding rows: exact zeros
    if (w - pad_node >= ZERO_WARPS) return;
    for (int r = ptr[pad_node] + (w - pad_node); r < n_edges; r += ZERO_WARPS) {
      zero_row(G + (size_t)r * d, lane, nv);
      if (gz_out != nullptr) zero_row(gz_out + (size_t)r * d, lane, nv);
    }
    return;
  }
  int lo = ptr[w], hi = ptr[w + 1];
  if (lo == hi) return;
  float4 t[MAXV];
  zero(t);
  for (int j = lo; j < hi; ++j) {
    int r = rev[j];
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      int v = lane + 32 * i;
      if (v < nv) add4(t[i], gz_at(g, y, dst, nodes != 0, r, d, v));
    }
  }
  for (int j = lo; j < hi; ++j) {
    int r = rev[j];
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      int v = lane + 32 * i;
      if (v >= nv) continue;
      float4 x = gz_at(g, y, dst, nodes != 0, r, d, v);  // from L1/L2: read just above
      store4(G + (size_t)j * d + 4 * v,
             make_float4(t[i].x - x.x, t[i].y - x.y, t[i].z - x.z, t[i].w - x.w));
      if (gz_out != nullptr) {
        float4 z = gz_at(g, y, dst, nodes != 0, j, d, v);
        if (acc != nullptr) add4(z, load4(acc + (size_t)j * d + 4 * v));
        store4(gz_out + (size_t)j * d + 4 * v, z);
      }
    }
  }
}

template <typename T>
static cudaError_t launch_nodes(const void* g, const void* y, const void* acc, const int* dst,
                                const int* rev, const int* ptr, void* G, void* gz_out,
                                int n_edges, int d, int pad_node, int nodes,
                                cudaStream_t stream) {
  int warps = pad_node + ZERO_WARPS;
  int grid = (warps + NODE_THREADS / 32 - 1) / (NODE_THREADS / 32);
  bwd_message_kernel<T><<<grid, NODE_THREADS, 0, stream>>>(
      (const T*)g, (const T*)y, (const T*)acc, dst, rev, ptr, (T*)G, (T*)gz_out, n_edges, d,
      pad_node, nodes);
  return cudaGetLastError();
}

// (G, gz_out) from an edge cotangent (nodes == 0) or a node cotangent
// (nodes != 0) of dtype float32 or bfloat16; y, acc and gz_out may be null
extern "C" int bwd_message(const void* g, const void* y, const void* acc, const int* dst,
                           const int* rev, const int* ptr, void* G, void* gz_out, int n_edges,
                           int d, int pad_node, int nodes, int dtype, cudaStream_t stream) {
  if (d % 4 != 0 || d > MAX_WIDTH) return (int)cudaErrorInvalidValue;
  if (n_edges == 0) return 0;
  if (dtype == DT_F32)
    return (int)launch_nodes<float>(g, y, acc, dst, rev, ptr, G, gz_out, n_edges, d, pad_node,
                                    nodes, stream);
  if (dtype == DT_BF16)
    return (int)launch_nodes<bf16>(g, y, acc, dst, rev, ptr, G, gz_out, n_edges, d, pad_node,
                                   nodes, stream);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------ cross rows
// G at the listed rows only, from a bf16 gz table already in device memory:
// the rows of a split tile table (a molecule of more than 128 rows cut at
// its nodes' boundaries) whose sum reads a row of another tile, which the
// tile kernels of bwd_nodes.cu and bwd_premul.cu cannot form inside their
// tile. One warp per listed row sums gz[rev[j]] over the in-edges j of the
// row's node in f32 in row order, less gz[rev[e]], rounded once: the node
// pass's sums in its order, so the bits every other row gets.
__global__ void __launch_bounds__(NODE_THREADS)
    cross_rows_kernel(const bf16* __restrict__ gz, const int* __restrict__ dst,
                      const int* __restrict__ rev, const int* __restrict__ ptr,
                      const int* __restrict__ rows, bf16* __restrict__ G, int n_rows, int d) {
  const int w = (blockIdx.x * NODE_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n_rows) return;
  const int nv = d >> 2, e = rows[w], v = dst[e];
  float4 t[MAXV];
  zero(t);
  for (int j = ptr[v]; j < ptr[v + 1]; ++j) add_row(t, gz + (size_t)rev[j] * d, lane, nv, false);
  const bf16* x = gz + (size_t)rev[e] * d;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int c = lane + 32 * i;
    if (c >= nv) continue;
    const float4 r = load4(x + 4 * c);
    store4(G + (size_t)e * d + 4 * c,
           make_float4(t[i].x - r.x, t[i].y - r.y, t[i].z - r.z, t[i].w - r.w));
  }
}

// G [n_edges x d] at the n_rows rows listed in rows, from gz of the same
// shape, both bf16; every other row of G is left as it is
extern "C" int cross_rows(const void* gz, const int* dst, const int* rev, const int* ptr,
                          const int* rows, void* G, int n_rows, int d, cudaStream_t stream) {
  if (d % 4 != 0 || d > MAX_WIDTH || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const int grid = (n_rows + NODE_THREADS / 32 - 1) / (NODE_THREADS / 32);
  cross_rows_kernel<<<grid, NODE_THREADS, 0, stream>>>((const bf16*)gz, dst, rev, ptr, rows,
                                                       (bf16*)G, n_rows, d);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ G_tile W^T
constexpr int BM = 64;   // edge rows per block
constexpr int BN = 128;  // output columns per pass over W^T
constexpr int BK = 64;   // depth of a W^T panel
constexpr int PRE_THREADS = 256;  // 8 warps: 2 x 4 warp tiles of 32 x 32
constexpr int LDT = BK + 8;       // padded row strides (elements) against bank conflicts
constexpr int LDC = BN + 4;

static size_t dh_smem_bytes(int d) {
  return (size_t)BM * (d + 8) * sizeof(bf16) + (size_t)BN * LDT * sizeof(bf16) +
         (size_t)BM * LDC * sizeof(float);
}

// Cs = As (W^T)[:, n0 : n0 + BN] for the block's BM rows of As, f32, by the
// whole block; ends with a barrier, so Cs may be read right after
__device__ __forceinline__ void rows_times_wt(const bf16* As, int lda, bf16* Ws, float* Cs,
                                              const bf16* __restrict__ W, int d, int n0) {
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // this warp's 32 x 32 tile of the strip
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  for (int k0 = 0; k0 < d; k0 += BK) {
    // (W^T)[k][n] = W[n][k]: a row of W is contiguous in k, so the panel is
    // copied row by row and read as a column-major matrix_b; W^T itself is
    // never formed
    for (int t = threadIdx.x; t < BN * BK / 8; t += PRE_THREADS) {
      int n = t / (BK / 8), k8 = t % (BK / 8);
      *reinterpret_cast<uint4*>(Ws + n * LDT + k8 * 8) =
          *reinterpret_cast<const uint4*>(W + (size_t)(n0 + n) * d + k0 + k8 * 8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * lda + k0 + kk, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bw[j], Ws + (wn * 32 + j * 16) * LDT + kk, LDT);
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
}

// ----------------------------------------------------------------- iter_bwd
// this lane's float4 of G's row e at vector v: the masked cotangents at the
// reverses of the in-edges of dst[e], summed in their order in f32, less the
// one at rev[e]; zeros for a padding edge (whose node is never walked)
__device__ __forceinline__ float4 transposed_at(const bf16* __restrict__ g,
                                                const bf16* __restrict__ y,
                                                const int* __restrict__ dst,
                                                const int* __restrict__ rev,
                                                const int* __restrict__ ptr, int e, int d,
                                                int pad_node, int v) {
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
  int node = dst[e];
  if (node == pad_node) return t;
  for (int j = ptr[node]; j < ptr[node + 1]; ++j) add4(t, gz_at(g, y, dst, false, rev[j], d, v));
  float4 x = gz_at(g, y, dst, false, rev[e], d, v);
  return make_float4(t.x - x.x, t.y - x.y, t.z - x.z, t.w - x.w);
}

// launch 1: BM rows of G into shared memory, dH = bf16(G) W^T and gz
__global__ void __launch_bounds__(PRE_THREADS)
    iter_bwd_dh_kernel(const bf16* __restrict__ g, const bf16* __restrict__ y,
                       const bf16* __restrict__ W, const int* __restrict__ dst,
                       const int* __restrict__ rev, const int* __restrict__ ptr,
                       bf16* __restrict__ dH, bf16* __restrict__ gz, int n_edges, int d,
                       int pad_node) {
  // every array starts on a 128-byte boundary (BM * (d + 8) * 2 and
  // BN * LDT * 2 are multiples of 128 for d a multiple of 128), and every
  // WMMA tile pointer below is 32-byte aligned as WMMA requires
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = d + 8;
  bf16* As = reinterpret_cast<bf16*>(smem);  // [BM][lda] rows of G, bf16
  bf16* Ws = As + BM * lda;                  // [BN][LDT] panel of W^T
  float* Cs = reinterpret_cast<float*>(Ws + BN * LDT);  // [BM][LDC] f32 product

  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = d >> 2;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = warp; i < BM; i += PRE_THREADS / 32) {
    int e = m0 + i;
    bool pad = e >= n_edges || dst[e] == pad_node;
    for (int v = lane; v < nv; v += 32) {
      store4(As + i * lda + 4 * v,
             e < n_edges ? transposed_at(g, y, dst, rev, ptr, e, d, pad_node, v) : zero4);
      if (e < n_edges)
        store4(gz + (size_t)e * d + 4 * v, pad ? zero4 : gz_at(g, y, dst, false, e, d, v));
    }
  }
  __syncthreads();

  for (int n0 = 0; n0 < d; n0 += BN) {
    rows_times_wt(As, lda, Ws, Cs, W, d, n0);
    for (int t = threadIdx.x; t < BM * BN / 4; t += PRE_THREADS) {
      int r = t / (BN / 4), c4 = (t % (BN / 4)) * 4;
      int e = m0 + r;
      if (e >= n_edges) continue;
      // a padding row of G is zero, and so is its product
      store4(dH + (size_t)e * d + n0 + c4, *reinterpret_cast<const float4*>(Cs + r * LDC + c4));
    }
    __syncthreads();  // Cs is overwritten by the next strip
  }
}

// launch 2: the split product H^T G of xtg.cuh with the XT_K x XT_TILE strip
// of G formed on the fly; H's rows from first_pad on are read as zeros
__global__ void __launch_bounds__(XT_THREADS, 2)  // two blocks per SM: at most 128 registers
    iter_bwd_dw_kernel(const bf16* __restrict__ g, const bf16* __restrict__ y,
                       const bf16* __restrict__ H, const int* __restrict__ dst,
                       const int* __restrict__ rev, const int* __restrict__ ptr,
                       float* __restrict__ partial, int n_edges, int d, int pad_node,
                       int rows_per_split) {
  __shared__ __align__(128) bf16 Xs[XT_K * XT_LD];
  __shared__ __align__(128) bf16 Gs[XT_K * XT_LD];
  const int m0 = blockIdx.x * XT_TILE, n0 = blockIdx.y * XT_TILE;
  const int r0 = blockIdx.z * rows_per_split;
  const int r1 = min(min(n_edges, ptr[pad_node]), r0 + rows_per_split);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  XtAcc c[4][2];
  xtg_zero(c);
  for (int k0 = r0; k0 < r1; k0 += XT_K) {
    xtg_load(Xs, H, k0, r1, d, m0);
    for (int i = warp; i < XT_K; i += XT_THREADS / 32) {  // a lane's float4 spans the strip
      int e = k0 + i;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < r1) t = transposed_at(g, y, dst, rev, ptr, e, d, pad_node, n0 / 4 + lane);
      store4(Gs + i * XT_LD + 4 * lane, t);
    }
    __syncthreads();
    xtg_accumulate(c, Xs, Gs);
    __syncthreads();  // the tiles are overwritten next
  }
  xtg_store(c, partial + (size_t)blockIdx.z * d * d, d, m0, n0);
}

// the number of [d x d] float32 partials the caller allocates for n_edges rows
extern "C" int iter_bwd_splits(int n_edges) { return xtg_n_splits(n_edges); }

// (dH, gz, dW) from g, y, H [E, d] bfloat16 and W [d, d] in (in, out) layout,
// d a multiple of 128; partial holds iter_bwd_splits(n_edges) * d * d floats
extern "C" int iter_bwd(const void* g, const void* y, const void* H, const void* W,
                        const int* dst, const int* rev, const int* ptr, void* dH, void* gz,
                        float* partial, float* dW, int n_edges, int d, int pad_node,
                        cudaStream_t stream) {
  if (d % BN != 0 || d > MAX_WIDTH) return (int)cudaErrorInvalidValue;
  size_t smem = dh_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(iter_bwd_dh_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_edges > 0) {
    iter_bwd_dh_kernel<<<(n_edges + BM - 1) / BM, PRE_THREADS, smem, stream>>>(
        (const bf16*)g, (const bf16*)y, (const bf16*)W, dst, rev, ptr, (bf16*)dH, (bf16*)gz,
        n_edges, d, pad_node);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  int splits = xtg_n_splits(n_edges);
  dim3 grid(d / XT_TILE, d / XT_TILE, splits);
  iter_bwd_dw_kernel<<<grid, XT_THREADS, 0, stream>>>(
      (const bf16*)g, (const bf16*)y, (const bf16*)H, dst, rev, ptr, partial, n_edges, d,
      pad_node, xtg_rows_per_split(n_edges));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)xtg_reduce(partial, dW, splits, d * d, stream);
}
