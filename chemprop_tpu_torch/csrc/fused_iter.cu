// The fused depth iteration of the D-MPNN, redesigned for Hopper:
//
//   y[e] = relu(H0[e] + bf16(M[e]) @ W [+ b]),
//   M[e] = sum_{k : dst[k] == src[e]} H[k] - H[rev[e]]
//
// with f32 sums, the message rounded to bfloat16 once before the product (as
// the TPU kernel does), relu_stream applying the ReLU to the gathered rows
// only, and padding edges (src = the padding node) given a zero message.
//
// fused_iter replaces the Pallas TPU kernel _iter_kernel of
// chemprop_tpu/ops/fused_message.py (launched by _iter_impl). The TPU kernel
// forms the message as a one-hot product over a window of edge chunks on the
// MXU. Here edges are sorted by dst and the in-edges of node v are rows
// [ptr[v], ptr[v+1]), so a message row is a gather-sum of H's rows.
//
// It is bound by bytes: H and H0 read and y written once are three edge
// tables (284 MB at [123,392 x 384]; 85 us at 3.35 TB/s), against 36 GFLOP
// on the tensor cores (37 us at their bf16 peak). So the gather, the product
// and the epilogue must overlap, and W (288 KB at d = 384, more than a
// block's 227 KB of shared memory) must not be re-read per tile:
//
// * W resident. The output columns are cut into d / N slices (N = 192 at
//   d = 384: two slices of 144 KB; d <= 256 takes one). A block owns one
//   slice for the whole launch, loaded once by TMA as wgmma's MN-major B
//   operand (64 x 64 boxes, 128-byte swizzle). Persistent blocks, one per
//   SM, walk the 64-row tiles; the blocks of a tile's slices run side by
//   side, so the second gather of a tile's rows of H reads L2.
// * Warp-specialised. Eight gather warps form the message of each tile, 64
//   columns (one 8 KB stage) at a time, into a ring of stages (as many as
//   shared memory leaves: seven at d = 384); one consumer warpgroup
//   multiplies each stage as it lands. Full and empty mbarriers hand the
//   stages over, as in grad_weight.cu.
// * The gather with loads in flight. Eight lanes hold one row's 128-byte
//   piece of a stage, so a warp forms four rows at once; a round forms two
//   such groups in two stages and issues all of their row loads (the
//   reverse edge and two in-edges per row at a time: most atoms have one to
//   three neighbours) before the first add.
//   Each tile's ids (src, then ptr and rev) are loaded a tile ahead. The
//   sums are f32 in the order of the edges; each row is written once, as
//   bf16, into the stage, swizzled (16-byte chunk c of row r at chunk
//   c ^ (r % 8)).
// * The product from registers. The consumer reads each stage's A
//   fragments with ldmatrix (no bank conflicts, thanks to the swizzle),
//   hands the stage back at once and runs wgmma m64nNk16 with A in
//   registers and B, W's slice, in shared memory. A generic load, unlike
//   wgmma's own read of shared memory, needs no proxy fence between the
//   gather warps' stores and the product: the fence cost more than the
//   stores themselves.
// * Epilogue from registers. H0's slice of the tile arrives by TMA while
//   the product runs; the consumer adds it, the bias and the ReLU in f32 on
//   its accumulator, writes bf16 y over H0 in shared memory and then copies
//   the tile out in whole 128-byte rows. Meanwhile the gather warps fill
//   the next tile's stages.
//
// Every output row is written by one block, in one fixed order of k, with
// no atomics: the result is the same bit for bit in every run.
//
// fused_iter_rows is the same kernel over a list of rows (LISTED): its tiles
// are 64 listed rows each, gathered as B gathers, multiplied in B's order of
// K, finished by B's epilogue, and written back to their own rows of y; H0's
// rows come in by plain loads, laid out as TMA lays them. So every listed row
// gets the bits B gives it. It is kernel D's row pass over a split tile table
// (iter2.cu): the rows of y1, then of y2, that D cannot form in their tile.
#include "fused_iter.cuh"

constexpr int FI_GATHER_WARPS = 8;
constexpr int FI_THREADS = 128 + 32 * FI_GATHER_WARPS;
constexpr int FI_MAX_STAGES = 16;
constexpr int FI_SMEM_MAX = 232448;   // a block's shared memory on sm_90
constexpr int FI_W_MAX = 160 * 1024;  // the most of W a block keeps

// 8 bf16 (one 16-byte load) added into 8 f32 sums
__device__ __forceinline__ void add8(float (&acc)[8], uint4 v, bool relu) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    acc[2 * i] += relu ? fmaxf(f.x, 0.f) : f.x;
    acc[2 * i + 1] += relu ? fmaxf(f.y, 0.f) : f.y;
  }
}

// the four warps of the consumer warpgroup, apart from the gather warps
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

// one stage of the consumer: the A fragments of this warp's 16 rows from
// stage s (ldmatrix, swizzled rows), the stage handed back to the gather
// warps, then four wgmma over its 64 K values against the resident W slice;
// the previous stage's group is then done
template <int N>
__device__ __forceinline__ void product_stage(float (&acc)[N / 2], uint32_t (&a)[4][4],
                                              const Smem& sm, int c, int kb, int n_stages) {
  constexpr int NB = N / 64;
  const int s = c % n_stages, lane = threadIdx.x % 32;
  const int row = 16 * (threadIdx.x / 32) + lane % 16;
  mbar_wait(sm.full + 8 * s, (c / n_stages) & 1);
  const uint32_t stage = sm.ring + s * FI_BOX + row * 128;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(a[kk], stage + (((2 * kk + lane / 16) ^ (row % 8)) << 4));
  __syncwarp();
  if (lane == 0) mbar_arrive(sm.empty + 8 * s);  // the warpgroup's four warps release it
  const uint32_t bw = sm.w + kb * NB * FI_BOX;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rmn<N>(acc, a[kk], desc_mn_sw128(bw + 2048 * kk, FI_BOX, 1024), kb + kk > 0);
  wgmma_commit();
  wgmma_wait<1>();
}

// the consumer warpgroup: tile by tile, the product of the message stages
// with the resident W slice, then y = relu(H0 + z [+ b]) from registers,
// with H0's slice of the tile brought into shared memory by TMA meanwhile
// (the epilogue and the copy-out are fused_iter.cuh's)
template <int N, bool LISTED>
__device__ __forceinline__ void consume(const CUtensorMap* th0, const bf16* __restrict__ H0,
                                        const int* __restrict__ list, const bf16* __restrict__ b,
                                        bf16* __restrict__ y, const Smem& sm, uint8_t* h0,
                                        int n_edges, int d, int n0, int first, int step,
                                        int n_stages) {
  constexpr int NB = N / 64;  // boxes of 64 columns in the slice
  const int t = threadIdx.x, nk = d / 64, tiles = (n_edges + FI_ROWS - 1) / FI_ROWS;
  auto load_h0 = [&](int tile) {
    mbar_arrive_expect_tx(sm.h0bar, NB * FI_BOX);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load_2d(sm.h0 + j * FI_BOX, th0, sm.h0bar, n0 + 64 * j, tile * FI_ROWS);
  };
  if (!LISTED && t == 0 && first < tiles) load_h0(first);
  int c = 0;  // the block's stage count: stage c % n_stages, round c / n_stages
  int iter = 0;
  for (int tile = first; tile < tiles; tile += step, ++iter) {
    if constexpr (LISTED) {  // the listed rows' H0 slice, swizzled as TMA lays it
#pragma unroll
      for (int i = t; i < NB * FI_ROWS * 8; i += 128) {
        const int box = i / (FI_ROWS * 8), r = i / 8 % FI_ROWS, ch = i % 8;
        const int e = tile * FI_ROWS + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (e < n_edges)
          v = __ldg(reinterpret_cast<const uint4*>(H0 + (size_t)__ldg(list + e) * d + n0 +
                                                   64 * box + 8 * ch));
        *reinterpret_cast<uint4*>(h0 + box * FI_BOX + r * 128 + ((ch ^ (r % 8)) << 4)) = v;
      }
      consumer_sync();
    }
    float acc[N / 2];
    uint32_t a0[4][4], a1[4][4];  // two stages' fragments: one in flight, one loading
    for (int kb = 0; kb < nk; kb += 2, c += 2) {
      product_stage<N>(acc, a0, sm, c, kb, n_stages);
      product_stage<N>(acc, a1, sm, c + 1, kb + 1, n_stages);
    }
    wgmma_wait<0>();

    if (!LISTED) mbar_wait(sm.h0bar, iter & 1);
    epilogue<N>(acc, b, h0, n0, t);
    consumer_sync();
    store_tile<N, LISTED>(y, h0, tile * FI_ROWS, n_edges, d, n0, t, list);
    consumer_sync();  // every thread is done with the buffer: the next H0 may land
    if (!LISTED && t == 0 && tile + step < tiles) load_h0(tile + step);
  }
}

// the ids of one row of a tile: where its in-edges start and end, and its
// reverse edge (-1: a zero message, for padding edges and rows past the end)
struct RowIds {
  int p0, p1, rv;
};

// the edge row of a tile's row e: e itself, or the listed row
template <bool LISTED>
__device__ __forceinline__ int row_of(const int* __restrict__ list, int e) {
  return LISTED ? __ldg(list + e) : e;
}

template <bool LISTED>
__device__ __forceinline__ int row_src(const int* __restrict__ src, const int* __restrict__ list,
                                       int e, int n_edges, int pad_node) {
  return e < n_edges ? src[row_of<LISTED>(list, e)] : pad_node;
}

template <bool LISTED>
__device__ __forceinline__ RowIds row_ids(const int* __restrict__ rev,
                                          const int* __restrict__ ptr,
                                          const int* __restrict__ list, int e, int s,
                                          int pad_node) {
  if (s == pad_node) return {0, 0, -1};
  return {ptr[s], ptr[s + 1], rev[row_of<LISTED>(list, e)]};
}

// a gather warp: rows 4 (g + 8 i) + lane / 8 (i < G) of every tile, 16
// bytes (8 columns) of a stage per lane; a round forms its G row groups in
// two stages (d is a multiple of 128: the stages of a tile come in pairs);
// LISTED: row e of the walk is edge row list[e]
template <bool LISTED>
__device__ __forceinline__ void gather(const bf16* __restrict__ H, const int* __restrict__ src,
                                       const int* __restrict__ rev, const int* __restrict__ ptr,
                                       const int* __restrict__ list, const Smem& sm, int n_edges,
                                       int d, int pad_node, bool relu, int first, int step,
                                       int n_stages, int g) {
  constexpr int G = FI_ROWS / 4 / FI_GATHER_WARPS;
  const int lane = threadIdx.x % 32, q = lane / 8, l8 = lane % 8;
  const int nk = d / 64, tiles = (n_edges + FI_ROWS - 1) / FI_ROWS;
  int rows[G];
#pragma unroll
  for (int i = 0; i < G; ++i) rows[i] = 4 * (g + FI_GATHER_WARPS * i) + q;

  // ids a tile ahead: this tile's RowIds, the next tile's src
  RowIds ids[G];
  int s_next[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int e = first * FI_ROWS + rows[i];
    ids[i] = row_ids<LISTED>(rev, ptr, list, e, row_src<LISTED>(src, list, e, n_edges, pad_node),
                             pad_node);
    s_next[i] = row_src<LISTED>(src, list, e + step * FI_ROWS, n_edges, pad_node);
  }
  int c = 0;  // the block's stage count, as the consumer's
  for (int tile = first; tile < tiles; tile += step) {
    RowIds ids_next[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int e = (tile + step) * FI_ROWS + rows[i];
      ids_next[i] = row_ids<LISTED>(rev, ptr, list, e, s_next[i], pad_node);
      s_next[i] = row_src<LISTED>(src, list, e + step * FI_ROWS, n_edges, pad_node);
    }
    int most = 0;
#pragma unroll
    for (int i = 0; i < G; ++i) most = max(most, ids[i].p1 - ids[i].p0);

    for (int kb = 0; kb < nk; kb += 2, c += 2) {  // two stages a round
      const int s0 = c % n_stages, s1 = (c + 1) % n_stages;
      if (c >= n_stages) mbar_wait(sm.empty + 8 * s0, (c / n_stages - 1) & 1);
      if (c + 1 >= n_stages) mbar_wait(sm.empty + 8 * s1, ((c + 1) / n_stages - 1) & 1);
      constexpr int P = 2 * G;  // piece p: row group p % G, stage p / G
      float acc[P][8];
      uint4 r[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const RowIds& id = ids[p % G];
        const bf16* Hc = H + (kb + p / G) * 64 + l8 * 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;
        r[p] = id.rv >= 0 ? __ldg(reinterpret_cast<const uint4*>(Hc + (size_t)id.rv * d))
                          : make_uint4(0, 0, 0, 0);
      }
      for (int k = 0; k < most; k += 2) {
        uint4 v[P][2];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const RowIds& id = ids[p % G];
          const bf16* Hc = H + (kb + p / G) * 64 + l8 * 8;
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (id.p0 + k + u < id.p1)
              v[p][u] = __ldg(reinterpret_cast<const uint4*>(Hc + (size_t)(id.p0 + k + u) * d));
        }
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (ids[p % G].p0 + k + u < ids[p % G].p1) add8(acc[p], v[p][u], relu);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (ids[p % G].rv >= 0) {  // minus the reverse edge's row
          float m[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          add8(m, r[p], relu);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[p][j] -= m[j];
        }
        const int row = rows[p % G];
        st_shared16(sm.ring + (p / G ? s1 : s0) * FI_BOX + row * 128 + ((l8 ^ (row & 7)) << 4),
                    make_uint4(pack2(acc[p][0], acc[p][1]), pack2(acc[p][2], acc[p][3]),
                               pack2(acc[p][4], acc[p][5]), pack2(acc[p][6], acc[p][7])));
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(sm.full + 8 * s0);
        mbar_arrive(sm.full + 8 * s1);
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) ids[i] = ids_next[i];
  }
}

// block b holds slice b % (d / N) and walks tiles b / (d / N), + gridDim.x /
// (d / N), ...; n_edges rows (LISTED: the n_edges rows of list, H0 read
// through H0 and not th0)
template <int N, bool LISTED>
__global__ void __launch_bounds__(FI_THREADS, 1)
    fused_iter_kernel(const __grid_constant__ CUtensorMap tw,
                      const __grid_constant__ CUtensorMap th0, const bf16* __restrict__ H,
                      const bf16* __restrict__ H0, const int* __restrict__ list,
                      const bf16* __restrict__ b, bf16* __restrict__ y, const int* __restrict__ src,
                      const int* __restrict__ rev, const int* __restrict__ ptr, int n_edges,
                      int d, int pad_node, int relu_stream, int n_stages) {
  constexpr int NB = N / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const int nk = d / 64, slices = d / N;
  Smem sm;
  sm.w = base;                              // nk x NB boxes of the W slice
  sm.h0 = sm.w + nk * NB * FI_BOX;          // NB boxes of H0
  sm.ring = sm.h0 + NB * FI_BOX;            // the message stages
  sm.full = sm.ring + n_stages * FI_BOX;    // their barriers
  sm.empty = sm.full + 8 * n_stages;
  sm.wbar = sm.empty + 8 * n_stages;
  sm.h0bar = sm.wbar + 8;
  const int n0 = (blockIdx.x % slices) * N;
  const int first = blockIdx.x / slices, step = gridDim.x / slices;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(sm.full + 8 * s, FI_GATHER_WARPS);  // one arrival per gather warp
      mbar_init(sm.empty + 8 * s, 4);               // one per consumer warp
    }
    mbar_init(sm.wbar, 1);
    mbar_init(sm.h0bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    if (threadIdx.x == 0) {  // the W slice, once for the whole launch
      tma_prefetch_map(&tw);
      tma_prefetch_map(&th0);
      mbar_arrive_expect_tx(sm.wbar, nk * NB * FI_BOX);
      for (int k = 0; k < nk; ++k)
        for (int j = 0; j < NB; ++j)
          tma_load_2d(sm.w + (k * NB + j) * FI_BOX, &tw, sm.wbar, n0 + 64 * j, 64 * k);
    }
    mbar_wait(sm.wbar, 0);
    consume<N, LISTED>(&th0, H0, list, b, y, sm, smem_raw + (sm.h0 - smem_addr(smem_raw)),
                       n_edges, d, n0, first, step, n_stages);
  } else {
    gather<LISTED>(H, src, rev, ptr, list, sm, n_edges, d, pad_node, relu_stream != 0, first,
                   step, n_stages, warp - 4);
  }
}

// the width of a block's W slice: the widest of 256, 192, 128, 64 that
// divides d and keeps the slice within FI_W_MAX (d = 128: 128; 256: 256;
// 384: 192; 512: 128; 1024: 64)
static int fi_width(int d) {
  const int widths[4] = {256, 192, 128, 64};
  for (int n : widths)
    if (d % n == 0 && d * n * 2 <= FI_W_MAX) return n;
  return 0;
}

// the stages that fit beside the W slice, the H0 tile, the barriers and the
// alignment
static int fi_stages(int d, int n) {
  int s = (FI_SMEM_MAX - 1024 - 8 * (2 * FI_MAX_STAGES + 2) - (d + 64) * n * 2) / FI_BOX;
  return s < FI_MAX_STAGES ? s : FI_MAX_STAGES;
}

static size_t fi_smem(int d, int n, int stages) {
  return 1024 + (size_t)(d + 64) * n * 2 + (size_t)stages * FI_BOX + 8 * (2 * stages + 2);
}

// blocks of the grid: as many groups of d / N (one block per slice of a
// tile) as fit one block per SM, no more than there are tiles
static int fi_grid(int d, int n, int n_edges) {
  const int slices = d / n, tiles = (n_edges + FI_ROWS - 1) / FI_ROWS;
  const int groups = sm_count() / slices > 0 ? sm_count() / slices : 1;
  return (tiles < groups ? tiles : groups) * slices;
}

// the rows walked, n_rows, are the edge rows, or the rows of list where it
// is given (H0 then read through its pointer)
template <int N, bool LISTED>
static cudaError_t fi_launch(const CUtensorMap* maps, const void* H, const void* H0,
                             const int* list, const void* b, void* y, const int* src,
                             const int* rev, const int* ptr, int n_rows, int d, int pad_node,
                             int relu_stream, cudaStream_t stream, int* blocks_per_sm) {
  const int stages = fi_stages(d, N);
  const size_t smem = fi_smem(d, N, stages);
  // the opt-in above 48 KB is per device and per size, so it is made at every launch (cheap)
  cudaError_t err = cudaFuncSetAttribute(fused_iter_kernel<N, LISTED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (blocks_per_sm != nullptr)  // how many blocks of it one SM runs at once
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fused_iter_kernel<N, LISTED>, FI_THREADS, smem);
  fused_iter_kernel<N, LISTED><<<fi_grid(d, N, n_rows), FI_THREADS, smem, stream>>>(
      maps[0], maps[1], (const bf16*)H, (const bf16*)H0, list, (const bf16*)b, (bf16*)y, src,
      rev, ptr, n_rows, d, pad_node, relu_stream, stages);
  return cudaGetLastError();
}

template <int N>
static cudaError_t fi_listed(const CUtensorMap* maps, const void* H, const void* H0,
                             const int* list, const void* b, void* y, const int* src,
                             const int* rev, const int* ptr, int n_rows, int d, int pad_node,
                             int relu_stream, cudaStream_t stream, int* blocks_per_sm) {
  if (list != nullptr)
    return fi_launch<N, true>(maps, H, H0, list, b, y, src, rev, ptr, n_rows, d, pad_node,
                              relu_stream, stream, blocks_per_sm);
  return fi_launch<N, false>(maps, H, H0, list, b, y, src, rev, ptr, n_rows, d, pad_node,
                             relu_stream, stream, blocks_per_sm);
}

// fi_launch for the run's slice width, over the listed rows where list is given
static cudaError_t fi_dispatch(int n, const CUtensorMap* maps, const void* H, const void* H0,
                               const int* list, const void* b, void* y, const int* src,
                               const int* rev, const int* ptr, int n_rows, int d, int pad_node,
                               int relu_stream, cudaStream_t stream,
                               int* blocks_per_sm = nullptr) {
  switch (n) {
    case 256: return fi_listed<256>(maps, H, H0, list, b, y, src, rev, ptr, n_rows, d, pad_node, relu_stream, stream, blocks_per_sm);
    case 192: return fi_listed<192>(maps, H, H0, list, b, y, src, rev, ptr, n_rows, d, pad_node, relu_stream, stream, blocks_per_sm);
    case 128: return fi_listed<128>(maps, H, H0, list, b, y, src, rev, ptr, n_rows, d, pad_node, relu_stream, stream, blocks_per_sm);
    case 64: return fi_listed<64>(maps, H, H0, list, b, y, src, rev, ptr, n_rows, d, pad_node, relu_stream, stream, blocks_per_sm);
  }
  return cudaErrorInvalidValue;
}

// y = relu(H0 + bf16(M(H)) @ W [+ b]) for bf16 [n_edges x d] tables, W
// [d x d] (in, out), d a multiple of 128 up to MAX_WIDTH; b may be null
extern "C" int fused_iter(const void* H, const void* H0, const void* W, const void* b,
                          const int* src, const int* rev, const int* ptr, void* y, int n_edges,
                          int d, int pad_node, int relu_stream, cudaStream_t stream) {
  if (d % 128 != 0 || d > MAX_WIDTH || n_edges < 0) return (int)cudaErrorInvalidValue;
  if (n_edges == 0) return 0;
  const int n = fi_width(d);
  if (n == 0 || fi_stages(d, n) < 2) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];  // W, H0
  if (!bf16_table_map(&maps[0], W, d, d, 64) || !bf16_table_map(&maps[1], H0, n_edges, d, 64))
    return (int)cudaErrorInvalidValue;
  return (int)fi_dispatch(n, maps, H, H0, nullptr, b, y, src, rev, ptr, n_edges, d, pad_node,
                          relu_stream, stream);
}

// y at the n_rows rows listed in rows (int32, each in [0, n_edges)) formed as
// fused_iter forms them, every other row of y left as it is: H, H0 and y bf16
// [n_edges x d], W [d x d] (in, out); y must not alias H or H0
extern "C" int fused_iter_rows(const void* H, const void* H0, const void* W, const void* b,
                               const int* src, const int* rev, const int* ptr, const int* rows,
                               void* y, int n_rows, int d, int pad_node, int relu_stream,
                               cudaStream_t stream) {
  if (d % 128 != 0 || d > MAX_WIDTH || n_rows < 0 || rows == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const int n = fi_width(d);
  if (n == 0 || fi_stages(d, n) < 2) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];  // W, and W again in H0's place: the listed rows' H0 is loaded plainly
  if (!bf16_table_map(&maps[0], W, d, d, 64)) return (int)cudaErrorInvalidValue;
  maps[1] = maps[0];
  return (int)fi_dispatch(n, maps, H, H0, rows, b, y, src, rev, ptr, n_rows, d, pad_node,
                          relu_stream, stream);
}

// the launch's shape at width d and n_edges rows, into info[0..5]: slice
// width N, slices, stages, shared-memory bytes per block, blocks of the grid,
// and blocks of the kernel that one SM runs at once
extern "C" int fused_iter_info(int d, int n_edges, int* info) {
  const int n = d % 128 == 0 && d <= MAX_WIDTH ? fi_width(d) : 0;
  if (n == 0 || n_edges <= 0) return (int)cudaErrorInvalidValue;
  info[0] = n;
  info[1] = d / n;
  info[2] = fi_stages(d, n);
  info[3] = (int)fi_smem(d, n, info[2]);
  info[4] = fi_grid(d, n, n_edges);
  return (int)fi_dispatch(n, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, nullptr, n_edges, d, 0, 0, nullptr, &info[5]);
}
