// The backward of the last depth iteration from the node cotangent of the
// M_v readout, redesigned for Hopper:
//
//   gz[k] = g_nodes[dst[k]] [y[k] > 0]                           (written out)
//   G[e]  = sum_{j in [ptr[v], ptr[v+1])} gz[rev[j]] - gz[rev[e]],  v = dst[e]
//
// summed in f32 in the order of the rows j and rounded once to bf16. Rows
// from ptr[pad_node] on (the padding edges) get exact zeros in both outputs.
//
// bwd_nodes replaces the Pallas TPU kernel _bwd_msg_nodes_kernel of
// chemprop_tpu/ops/fused_message.py (launched by _bwd_msg_nodes_impl), which
// streams the node table through its own ring and expands g_nodes[dst] in
// VMEM, so that the expanded edge table never exists in device memory.
//
// It is bound by bytes on the H100: y and the ids of the real rows and the
// g_nodes rows of the nodes that own rows read once, G and gz written once;
// three adds a row and element. At the benchmark batch ([123,392 x 384] bf16
// edge tables, [57,088 x 384] node table) that is about 325 MB, 0.097 ms at
// 3.35 TB/s. The earlier form (message_bwd.cu, one
// warp per node) follows a chain of dependent loads for every in-edge
// (ptr -> rev -> dst -> a g_nodes row and a y row) with 8 bytes a lane, and
// reads every reverse row's g and y a second time for G. Here:
//
// * One launch over the molecule tiles. The collate's tile table cuts the
//   dst-sorted rows into tiles of at most 128 rows with no molecule in two, so
//   every rev[j], and every in-edge of dst[j], of a tile's row j lies in the
//   tile. A block forms the tile's gz in shared memory, writes it out once,
//   and forms G from shared memory: no row is read twice from L2 and no
//   pointer is chased through device memory.
// * Persistent blocks over (tile, column slice) items, warp-specialised. A
//   producer warp reads a tile's dst and rev (a lane to four rows), finds
//   the nodes that own its rows and each row's in-edge range with ballots
//   over dst (the rows of a node are contiguous: dst is sorted; tiles.cuh,
//   shared with kernel F's message_bwd_tiles.cu), packs them
//   into the stage, and brings the tile's y rows in by bulk copies
//   (cp.async.bulk): one copy of the whole tile when a block takes every
//   column (d <= 384), one per row of the slice otherwise. Sixteen consumer
//   warps wait for the stage, form gz in place over y and store it, 16 bytes
//   a thread, then form G from the stage. The producer fills the other
//   stages meanwhile.
// * g_nodes rows read once each: only the rows of the nodes that own rows of
//   the tile are read, one 16-byte load a node and chunk, straight into
//   registers, and applied to each of the node's rows. A tile's dst values
//   span a node range of any length (nodes with no edges, such as the atom of
//   "C" or a counter-ion like [Na+], lie inside it, and a tile may hold any
//   number of such molecules), but the nodes that own rows are at most the
//   tile's 128 rows: the node list is sized by rows, never by the range.
// * The same bits as the node-warp form of message_bwd.cu: gz is the same
//   select of the same bf16 values, and G sums the same f32 values in the
//   same order (the in-edges of v in row order), less the row's own reverse,
//   rounded once. Every output row is written by one thread in a fixed order
//   with no atomics: two calls give the same bits.
//
// What binds it on the card (experiments/torch_bwd_nodes.py, H100 SXM at
// 700 W): the memory system. At the benchmark batch it takes about 0.128 ms
// of device time, 0.76 of the bound: 2.5 TB/s of mixed reads and writes,
// where a plain device copy of y runs at 2.8-2.9 TB/s. Copies of the kernel
// without the g_nodes loads, or without the sums of G, each took 5-10 us
// less; eight g_nodes loads in flight per thread (not four) took 5 us off,
// while twenty consumer warps, gz written out by one bulk store from the
// stage, and the g_nodes rows prefetched into L2 by the producer moved
// nothing or cost time.
//
// Padding rows and padding tiles (which hold no molecule) are written as
// zeros without any load. With a table that breaks the collate's rule, every
// row of a node whose in-edges, or their reverses, are not all inside its
// tile gets NaN in G: no row it cannot form comes out finite.
//
// With a split table, whose tiles cut a molecule of more than 128 rows at its
// nodes' boundaries, the rows whose sum reads a row of another tile get NaN
// as above, and the caller forms them again from the gz written out
// (bwd_message_rows of message_bwd.cu). Without any tile table the caller
// takes the node-warp form of message_bwd.cu.
#include "sm90.cuh"
#include "tiles.cuh"

constexpr int BN_CONSUMER_WARPS = 16;
constexpr int BN_CONSUMERS = 32 * BN_CONSUMER_WARPS;  // threads 0-511; the producer warp after
constexpr int BN_THREADS = BN_CONSUMERS + 32;
constexpr int BN_MAX_STAGES = 4;
constexpr int BN_BARS = 128;                        // bytes of the barriers: 2 per stage
// ids, starts, nodes, header
constexpr int BN_IDS = 4 * (TILE_ROWS + (TILE_ROWS + 4) + TILE_ROWS + 4);
constexpr int BN_UNROLL = 8;                        // g_nodes loads in flight per thread

// the bytes of a stage at slice width n: the y (then gz) rows, then per row
// its packed id (reverse | first in-edge << 8 | end << 16, in local rows),
// the first row of each node (and the end), each node's id, and the header
// (first row, rows, real rows, nodes)
__host__ __device__ inline int bn_stage_bytes(int n) {
  return (TILE_ROWS * n * 2 + BN_IDS + 127) & ~127;
}

struct BnStage {
  uint8_t* data;
  uint32_t* ids;
  int* starts;
  int* nodes;
  int* hdr;
};

__device__ __forceinline__ BnStage bn_stage(uint8_t* stages, int s, int n) {
  BnStage st;
  st.data = stages + s * bn_stage_bytes(n);
  st.ids = reinterpret_cast<uint32_t*>(st.data + TILE_ROWS * n * 2);
  st.starts = reinterpret_cast<int*>(st.ids + TILE_ROWS);
  st.nodes = st.starts + TILE_ROWS + 4;
  st.hdr = st.nodes + TILE_ROWS;
  return st;
}

// the producer warp: per item, the tile's ids (loaded before it waits for a
// free stage), its node list and packed ids into the stage, then the y rows
// of the slice by bulk copy, all counted on the stage's full barrier
template <int N>
__device__ void bn_produce(const bf16* __restrict__ y, const int* __restrict__ dst,
                           const int* __restrict__ rev, const int* __restrict__ tiles,
                           uint8_t* stages, uint32_t bars, int n_items, int n_edges, int d,
                           int first_pad, int n_stages) {
  const int lane = threadIdx.x % 32, slices = d / N;
  int c = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++c) {
    const int s = c % n_stages, t = item / slices, n0 = (item % slices) * N;
    const int r0 = __ldg(tiles + t);
    const int rows = max(0, min(__ldg(tiles + t + 1) - r0, TILE_ROWS));
    const int real = max(0, min(rows, first_pad - r0));  // rows before the padding
    const TileRows tr = tile_rows(dst, rev, r0, real, n_edges);
    if (c >= n_stages) mbar_wait(bars + 8 * (n_stages + s), (c / n_stages - 1) & 1);
    const BnStage st = bn_stage(stages, s, N);
    tile_store_ids(tr, real, st.ids);
    tile_store_nodes(tr, real, st.starts, st.nodes);
    if (lane == 0) {
      st.hdr[0] = r0;
      st.hdr[1] = rows;
      st.hdr[2] = real;
      st.hdr[3] = tr.n_nodes;
    }
    __syncwarp();
    const uint32_t full = bars + 8 * s, data = smem_addr(st.data);
    const uint32_t bytes = (uint32_t)real * N * 2;
    if (lane == 0) mbar_arrive_expect_tx(full, bytes);
    __syncwarp();  // the bytes are expected before any copy lands
    if (N == d) {  // the tile's rows are one stretch of memory
      if (lane == 0 && bytes > 0) bulk_load(data, y + (size_t)r0 * d, bytes, full);
    } else {
      for (int i = lane; i < real; i += 32)
        bulk_load(data + i * N * 2, y + (size_t)(r0 + i) * d + n0, N * 2, full);
    }
    if (lane != 0) mbar_arrive(full);
  }
}

// the consumer warps: per item, gz node by node (in place over y, and out),
// zeros on the rows past the real ones, then G row by row from the stage
template <int N>
__device__ void bn_consume(const bf16* __restrict__ g_nodes, bf16* __restrict__ G,
                           bf16* __restrict__ gz_out, uint8_t* stages, uint32_t bars,
                           int n_items, int d, int n_stages) {
  constexpr int CH = N / 8;  // 16-byte chunks of a row of the slice
  const int tid = threadIdx.x, lane = tid % 32, slices = d / N;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  int c = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++c) {
    const int s = c % n_stages, n0 = (item % slices) * N;
    mbar_wait(bars + 8 * s, (c / n_stages) & 1);
    const BnStage st = bn_stage(stages, s, N);
    const int r0 = st.hdr[0], rows = st.hdr[1], real = st.hdr[2], n_nodes = st.hdr[3];
    auto chunk = [&](int i, int ch) { return reinterpret_cast<uint4*>(st.data + i * N * 2) + ch; };
    auto out = [&](bf16* T, int i, int ch) {
      return reinterpret_cast<uint4*>(T + (size_t)(r0 + i) * d + n0) + ch;
    };

    // gz: node k's rows [starts[k], starts[k+1]) share its g_nodes row,
    // loaded once, BN_UNROLL nodes' chunks in flight at a time
    const int tasks = n_nodes * CH;
    for (int base = tid; base < tasks; base += BN_CONSUMERS * BN_UNROLL) {
      uint4 g[BN_UNROLL];
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u) {
        const int task = base + BN_CONSUMERS * u;
        if (task < tasks)
          g[u] = __ldg(reinterpret_cast<const uint4*>(g_nodes + (size_t)st.nodes[task / CH] * d +
                                                      n0) + task % CH);
      }
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u) {
        const int task = base + BN_CONSUMERS * u;
        if (task >= tasks) continue;
        const int k = task / CH, ch = task % CH;
        for (int i = st.starts[k]; i < st.starts[k + 1]; ++i) {
          const uint4 z = mask_chunk<bf16>(g[u], *chunk(i, ch));
          *chunk(i, ch) = z;
          *out(gz_out, i, ch) = z;
        }
      }
    }
    // padding rows: zeros, no loads
    for (int task = tid; task < (rows - real) * CH; task += BN_CONSUMERS) {
      const int i = real + task / CH, ch = task % CH;
      *out(G, i, ch) = zero4;
      *out(gz_out, i, ch) = zero4;
    }
    asm volatile("bar.sync 1, %0;" ::"n"(BN_CONSUMERS) : "memory");  // the tile's gz is in

    // G: T[dst] over the in-edges in their order, less the row's reverse
    for (int task = tid; task < real * CH; task += BN_CONSUMERS) {
      const int i = task / CH, ch = task % CH;
      *out(G, i, ch) =
          transposed_chunk<bf16, CH>(reinterpret_cast<const uint4*>(st.data), st.ids, i, ch);
    }
    // the stage goes back only after this warp's last read of it (and its
    // writes of gz are ordered before the bulk copy that refills it)
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (n_stages + s));
  }
}

// item i is slice i % (d / N) of tile i / (d / N); block b takes items b,
// b + gridDim.x, ...
template <int N>
__global__ void __launch_bounds__(BN_THREADS, 1)
    bwd_nodes_kernel(const bf16* __restrict__ g_nodes, const bf16* __restrict__ y,
                     const int* __restrict__ dst, const int* __restrict__ rev,
                     const int* __restrict__ ptr, const int* __restrict__ tiles,
                     bf16* __restrict__ G, bf16* __restrict__ gz, int n_edges, int d,
                     int pad_node, int n_tiles, int n_stages) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  const uint32_t bars = smem_addr(base);  // full[s], then empty[s]
  uint8_t* stages = base + BN_BARS;
  const int n_items = n_tiles * (d / N);
  const int first_pad = __ldg(ptr + pad_node);
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(bars + 8 * s, 32);                             // the producer's lanes, and the bytes
      mbar_init(bars + 8 * (n_stages + s), BN_CONSUMER_WARPS);  // one per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < BN_CONSUMERS)
    bn_consume<N>(g_nodes, G, gz, stages, bars, n_items, d, n_stages);
  else
    bn_produce<N>(y, dst, rev, tiles, stages, bars, n_items, n_edges, d, first_pad, n_stages);
}

// the stages of slice width n that fit a block
static int bn_stages(int n) {
  const int s = (TILE_SMEM_MAX - 128 - BN_BARS) / bn_stage_bytes(n);
  return s < BN_MAX_STAGES ? s : BN_MAX_STAGES;
}

static size_t bn_smem(int n, int stages) {
  return 128 + BN_BARS + (size_t)stages * bn_stage_bytes(n);
}

// the slice width at width d: the widest of 384, 256 and 128 that divides d
// and leaves room for two stages (d itself up to 384: one copy per tile)
static int bn_width(int d) {
  const int widths[3] = {384, 256, 128};
  for (int n : widths)
    if (d % n == 0 && bn_stages(n) >= 2) return n;
  return 0;
}

template <int N>
static cudaError_t bn_launch(const void* g_nodes, const void* y, const int* dst, const int* rev,
                             const int* ptr, const int* tiles, void* G, void* gz, int n_edges,
                             int d, int pad_node, int n_tiles, cudaStream_t stream,
                             int* blocks_per_sm = nullptr) {
  const int stages = bn_stages(N);
  const size_t smem = bn_smem(N, stages);
  // the opt-in above 48 KB is per device and per size, so it is made at every launch (cheap)
  cudaError_t err = cudaFuncSetAttribute(bwd_nodes_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (blocks_per_sm != nullptr)  // how many blocks of it one SM runs at once
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, bwd_nodes_kernel<N>,
                                                         BN_THREADS, smem);
  bwd_nodes_kernel<N><<<tile_grid(n_tiles * (d / N)), BN_THREADS, smem, stream>>>(
      (const bf16*)g_nodes, (const bf16*)y, dst, rev, ptr, tiles, (bf16*)G, (bf16*)gz, n_edges,
      d, pad_node, n_tiles, stages);
  return cudaGetLastError();
}

static cudaError_t bn_dispatch(int n, const void* g_nodes, const void* y, const int* dst,
                               const int* rev, const int* ptr, const int* tiles, void* G,
                               void* gz, int n_edges, int d, int pad_node, int n_tiles,
                               cudaStream_t stream, int* blocks_per_sm = nullptr) {
  switch (n) {
    case 384: return bn_launch<384>(g_nodes, y, dst, rev, ptr, tiles, G, gz, n_edges, d, pad_node, n_tiles, stream, blocks_per_sm);
    case 256: return bn_launch<256>(g_nodes, y, dst, rev, ptr, tiles, G, gz, n_edges, d, pad_node, n_tiles, stream, blocks_per_sm);
    case 128: return bn_launch<128>(g_nodes, y, dst, rev, ptr, tiles, G, gz, n_edges, d, pad_node, n_tiles, stream, blocks_per_sm);
  }
  return cudaErrorInvalidValue;
}

// (G, gz) from the node cotangent g_nodes [N_nodes x d] and the saved output
// y [n_edges x d], both bf16, d a multiple of 128 up to MAX_WIDTH, over a
// tile table of n_tiles tiles (ascending row offsets from 0 to n_edges, at
// most 128 rows each, no molecule in two tiles); rows 16-byte aligned
extern "C" int bwd_nodes(const void* g_nodes, const void* y, const int* dst, const int* rev,
                         const int* ptr, const int* tiles, void* G, void* gz, int n_edges, int d,
                         int pad_node, int n_tiles, cudaStream_t stream) {
  if (d % 128 != 0 || d > MAX_WIDTH || n_edges < 0 || tiles == nullptr || n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  if (n_edges == 0) return 0;
  const int n = bn_width(d);
  if (n == 0) return (int)cudaErrorInvalidValue;
  return (int)bn_dispatch(n, g_nodes, y, dst, rev, ptr, tiles, G, gz, n_edges, d, pad_node,
                          n_tiles, stream);
}

// the launch's shape at width d over n_tiles tiles, into info[0..5]: slice
// width N, slices, stages, shared-memory bytes per block, blocks of the grid,
// and blocks of the kernel that one SM runs at once
extern "C" int bwd_nodes_info(int d, int n_tiles, int* info) {
  const int n = d % 128 == 0 && d <= MAX_WIDTH ? bn_width(d) : 0;
  if (n == 0 || n_tiles <= 0) return (int)cudaErrorInvalidValue;
  info[0] = n;
  info[1] = d / n;
  info[2] = bn_stages(n);
  info[3] = (int)bn_smem(n, info[2]);
  info[4] = tile_grid(n_tiles * (d / n));
  return (int)bn_dispatch(n, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, 0, d, 0, n_tiles, nullptr, &info[5]);
}
