// The backward of the D-MPNN message: the masked transposed message, from an
// edge cotangent (bwd_message), from a node cotangent (bwd_message_nodes), or
// from the next stage's table times W^T (bwd_message_premul).
//
//   gz[k] = g[k] * [y[k] > 0]
//   G[e]  = sum_{k : src[k] == dst[e]} gz[k] - gz[rev[e]]        (S - R)^T gz
//
// bwd_message replaces the Pallas TPU kernel _bwd_msg_kernel of
// chemprop_tpu/ops/fused_message.py (launched by _bwd_msg_impl, with its
// has_acc form gz_out = gz + gz_acc); bwd_message_nodes replaces
// _bwd_msg_nodes_kernel (launched by _bwd_msg_nodes_impl), where
// g[k] = g_nodes[dst[k]] is formed on chip; bwd_message_premul replaces
// _bwd_msg_premul_kernel (launched by _bwd_msg_premul_impl), where
// g = G_in W^T is formed on chip and, with fold_h0, the first iteration's
// whole H0 cotangent z = gz + g * [H0 > 0] is written in place of gz.
// transposed_message is the same sum with no mask: the backward of the
// message kernel itself.
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
// rows of G, gz and z get exact zeros and the padding node is never walked
// (it owns thousands of rows). The weight gradients x^T G and x^T z sum over
// all rows, so these zeros are load-bearing.
//
// All three are bound by bytes on the H100: g (or the node table), y and
// gz_acc read once, G and gz written once; the gathers at rev[j] stay inside
// one molecule's rows and come from L2. bwd_message_premul's 2 E d d product
// runs on the tensor cores (WMMA bf16 16x16x16, f32 accumulation) at about
// half the time of its bytes at d = 384. It is two launches behind one entry
// point: the product with the mask writes gz (and z), then the node pass
// forms G from gz. With fold_h0 that moves one bf16 edge table more than the
// bound counts (gz is written and read back); without it z is gz.
#include <mma.h>

#include "vec.cuh"

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

// ------------------------------------------------------------ premultiplied
constexpr int BM = 64;   // edge rows per block
constexpr int BN = 128;  // output columns per pass over W^T
constexpr int BK = 64;   // depth of a W^T panel
constexpr int PRE_THREADS = 256;  // 8 warps: 2 x 4 warp tiles of 32 x 32
constexpr int LDT = BK + 8;       // padded row strides (elements) against bank conflicts
constexpr int LDC = BN + 4;

static size_t premul_smem_bytes(int d) {
  return (size_t)BM * (d + 8) * sizeof(bf16) + (size_t)BN * LDT * sizeof(bf16) +
         (size_t)BM * LDC * sizeof(float);
}

// dh = G_in W^T for BM rows, f32; gz = dh * [y > 0] rounded to bf16 into gz;
// with H0, z = gz + dh * [H0 > 0] formed in f32 and rounded once into z.
// Rows from first_pad on (the padding edges) get zeros.
__global__ void __launch_bounds__(PRE_THREADS)
    premul_mask_kernel(const bf16* __restrict__ G_in, const bf16* __restrict__ y,
                       const bf16* __restrict__ H0, const bf16* __restrict__ W,
                       const int* __restrict__ ptr, bf16* __restrict__ gz, bf16* __restrict__ z,
                       int n_edges, int d, int pad_node) {
  // every array starts on a 128-byte boundary (BM * (d + 8) * 2 and
  // BN * LDT * 2 are multiples of 128 for d a multiple of 128), and every
  // WMMA tile pointer below is 32-byte aligned as WMMA requires
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = d + 8;
  bf16* As = reinterpret_cast<bf16*>(smem);  // [BM][lda] rows of G_in
  bf16* Ws = As + BM * lda;                  // [BN][LDT]: Ws[n][k] = W[n0 + n][k0 + k]
  float* Cs = reinterpret_cast<float*>(Ws + BN * LDT);  // [BM][LDC] f32 product

  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5;
  const int first_pad = ptr[pad_node];

  for (int t = threadIdx.x; t < BM * (d / 8); t += PRE_THREADS) {
    int r = t / (d / 8), c8 = t % (d / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < n_edges)
      v = *reinterpret_cast<const uint4*>(G_in + (size_t)(m0 + r) * d + c8 * 8);
    *reinterpret_cast<uint4*>(As + r * lda + c8 * 8) = v;
  }
  __syncthreads();

  const int wm = warp >> 2, wn = warp & 3;  // this warp's 32 x 32 tile of the strip
  for (int n0 = 0; n0 < d; n0 += BN) {
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

    for (int t = threadIdx.x; t < BM * BN / 4; t += PRE_THREADS) {
      int r = t / (BN / 4), c4 = (t % (BN / 4)) * 4;
      int e = m0 + r;
      if (e >= n_edges) continue;
      size_t off = (size_t)e * d + n0 + c4;
      float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e >= first_pad) {
        store4(gz + off, zero4);
        if (H0 != nullptr) store4(z + off, zero4);
        continue;
      }
      float4 dh = *reinterpret_cast<const float4*>(Cs + r * LDC + c4);
      float4 gzv = mask4(dh, load4(y + off));
      store4(gz + off, gzv);
      if (H0 != nullptr) {
        float4 zv = mask4(dh, load4(H0 + off));
        add4(zv, gzv);
        store4(z + off, zv);
      }
    }
    __syncthreads();  // Cs is overwritten by the next strip
  }
}

// G, z from the next stage's G_in: pass 1 writes gz (into z itself when H0 is
// null, else into the scratch table gz and the folded cotangent into z),
// pass 2 forms G = (S - R)^T gz node by node. All tables bfloat16 [E, d], W
// [d, d] in (in, out) layout, d a multiple of 128.
extern "C" int bwd_message_premul(const void* G_in, const void* y, const void* H0, const void* W,
                                  const int* dst, const int* rev, const int* ptr, void* G,
                                  void* z, void* gz_scratch, int n_edges, int d, int pad_node,
                                  cudaStream_t stream) {
  if (d % BN != 0 || d > MAX_WIDTH) return (int)cudaErrorInvalidValue;
  if (H0 != nullptr && gz_scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (n_edges == 0) return 0;
  void* gz = H0 != nullptr ? gz_scratch : z;
  size_t smem = premul_smem_bytes(d);
  // the opt-in above 48 KB is per device, so it is made at every launch (cheap)
  cudaError_t err = cudaFuncSetAttribute(premul_mask_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int grid = (n_edges + BM - 1) / BM;
  premul_mask_kernel<<<grid, PRE_THREADS, smem, stream>>>(
      (const bf16*)G_in, (const bf16*)y, (const bf16*)H0, (const bf16*)W, ptr, (bf16*)gz,
      (bf16*)z, n_edges, d, pad_node);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_nodes<bf16>(gz, nullptr, nullptr, dst, rev, ptr, G, nullptr, n_edges, d,
                                 pad_node, 0, stream);
}
