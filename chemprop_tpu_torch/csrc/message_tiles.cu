// The D-MPNN message over the molecule tiles, redesigned for Hopper:
//
//   M[e] = sum_{k in [ptr[src[e]], ptr[src[e] + 1])} H[k] - H[rev[e]]
//
// summed in f32 in the order of the rows k, less the row's own reverse, and
// rounded once to H's dtype (float32 or bfloat16). Rows from ptr[pad_node] on
// (the padding edges) get exact zeros, with no load. These are the sums and
// the bits of message.cu's plain_message, row for row.
//
// message_tiles replaces the Pallas TPU kernel _kernel of
// chemprop_tpu/ops/fused_message.py (launched by _fused_message_impl), which
// forms the message as a one-hot product over a sliding window of 128-edge
// chunks on the MXU.
//
// It is bound by bytes on the H100: H read over the real rows, M written over
// every row, src and rev of the real rows, the ptr entries of the real nodes
// and the tile table. At the benchmark batch ([123,392 x 384] bf16 edge
// tables, 120,482 real rows) that is about 188.5 MB, 0.0563 ms at 3.35 TB/s;
// about one add per in-edge and element. The earlier form (message.cu, one
// warp per edge) follows a dependent chain src[e] -> ptr[s], ptr[s+1] -> the
// H rows for every edge, with 8 bytes a lane in bf16, and reads every H row
// about 3.2 times from L2 (its in-degree plus the reverse edge). Here, as in
// bwd_nodes.cu:
//
// * One launch over the molecule tiles. The collate's tile table cuts the
//   dst-sorted rows into tiles of at most 128 rows with no molecule in two, so
//   every in-edge of src[e], and rev[e], of a tile's row e lies in the tile.
//   A block brings the tile's H rows into shared memory once and forms every
//   output row from there: no H row is read twice from device memory or L2,
//   and no pointer is chased through device memory by the warps that sum.
// * Persistent blocks over (tile, column slice) items, warp-specialised. A
//   producer warp reads a tile's src and rev (a lane to four rows) and the
//   in-edge range of each row's source from ptr, packs each row's reverse
//   and range as rows of the tile into the stage, and brings the tile's H
//   rows in by bulk copies (cp.async.bulk): one copy of the whole tile when a
//   block takes every column (a row of at most 768 bytes: bf16 up to
//   d = 384), one per row of the slice otherwise (float32, wider models).
//   Sixteen consumer warps wait for the stage and form each output chunk of
//   16 bytes in one thread, from the stage, and store it. The producer fills
//   the other stages meanwhile.
// * The producer starts a tile's copy as soon as its stage is free, before
//   it reads the ids (the copy needs only the tile table), and the consumers
//   form all their chunks into registers and give the stage back before
//   they store them, so that the next copy overlaps the stores.
// * The same bits as message.cu: the same f32 values summed in the same
//   order, from +0, less the reverse row, rounded once; a sum that is never
//   -0 keeps its bits. Every output chunk is written by one thread in a fixed
//   order with no atomics: two calls give the same bits.
//
// What binds it on the card (experiments/torch_message.py and
// torch_message_parts.py, H100 SXM at 700 W): the memory system. At the
// benchmark batch it takes about 0.078 ms of device time in bf16, 0.72 of
// the bound, 2.4 TB/s where a plain device copy of H runs at 3.0 TB/s;
// copies of the kernel without the bulk copies, or without the stores, each
// took 0.017-0.019 ms less, without the ids nothing, and bf16 slices of 192
// columns (four stages, one copy a row) 0.033 ms more.
//
// Padding rows and padding tiles (which hold no molecule) are written as
// zeros without any load; summing the padding node's in-edges, which are
// every padding row, would be quadratic. With a table that breaks the
// collate's rule, every row whose in-edges or reverse are not all inside its
// tile is NaN: no row it cannot form comes out finite.
//
// A split tile table (the collate's split_ptr: a molecule of more than 128
// rows cut at its nodes' boundaries, so one molecule spans several tiles)
// runs through the same launch, and three things keep its result right:
// * its tiles keep the rules the kernel reads: ascending offsets, at most 128
//   rows a tile, and the rows of a node in one tile. The in-edges of src[e]
//   are one node's rows and hold rev[e], so a row's sum lies in its tile
//   exactly when its reverse does; a row whose reverse lies in another tile
//   is flagged (MT_BAD) and written as NaN, and every other row gets its
//   bits;
// * a flagged row is written once, by this launch, and read by nothing: the
//   kernel reads H alone, never M. The caller then forms every such row again
//   with message_rows (message.cu) over the collate's cross_rows, which hold
//   each of them (a row whose reverse lies in another tile is one of its own
//   node's in-edges with that property), in stream order after this launch;
// * the rows the caller re-forms that the launch got right get the same bits
//   again.
// Without any tile table, or at a width that is not a multiple of 128, the
// caller takes message.cu.
#include "sm90.cuh"
#include "tiles.cuh"

constexpr int MT_ROWS = 128;  // the most rows a tile holds
constexpr int MT_CONSUMER_WARPS = 16;
constexpr int MT_CONSUMERS = 32 * MT_CONSUMER_WARPS;  // threads 0-511; the producer warp after
constexpr int MT_THREADS = MT_CONSUMERS + 32;
constexpr int MT_MAX_STAGES = 4;
constexpr int MT_BARS = 128;                // bytes of the barriers: 2 per stage
constexpr int MT_IDS = 4 * (MT_ROWS + 4);  // packed ids, then the header
constexpr uint32_t MT_BAD = 1u << 24;       // id flag: a row the tile cannot form

// the bytes of a stage whose rows are rb bytes (a row's column slice): the H
// rows, then per row its packed id (reverse | first in-edge << 8 | end << 16,
// in rows of the tile), then the header (first row, rows, real rows)
__host__ __device__ inline int mt_stage_bytes(int rb) {
  return (MT_ROWS * rb + MT_IDS + 127) & ~127;
}

struct MtStage {
  uint8_t* data;
  uint32_t* ids;
  int* hdr;
};

__device__ __forceinline__ MtStage mt_stage(uint8_t* stages, int s, int rb) {
  MtStage st;
  st.data = stages + s * mt_stage_bytes(rb);
  st.ids = reinterpret_cast<uint32_t*>(st.data + MT_ROWS * rb);
  st.hdr = reinterpret_cast<int*>(st.ids + MT_ROWS);
  return st;
}

// the producer warp: per item, once the stage is free, the H rows of the
// slice by bulk copy, then the tile's ids, packed into the stage; the bytes
// and each lane's arrival (after its ids) count on the stage's full barrier
template <typename T, int N>
__device__ void mt_produce(const T* __restrict__ H, const int* __restrict__ src,
                           const int* __restrict__ rev, const int* __restrict__ ptr,
                           const int* __restrict__ tiles, uint8_t* stages, uint32_t bars,
                           int n_items, int d, int first_pad, int n_stages) {
  constexpr int Q = MT_ROWS / 32;  // rows a lane holds
  constexpr int RB = N * (int)sizeof(T);
  const int lane = threadIdx.x % 32, slices = d / N;
  int c = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++c) {
    const int s = c % n_stages, t = item / slices, n0 = (item % slices) * N;
    const int r0 = __ldg(tiles + t);
    const int rows = max(0, min(__ldg(tiles + t + 1) - r0, MT_ROWS));
    const int real = max(0, min(rows, first_pad - r0));  // rows before the padding
    if (c >= n_stages) mbar_wait(bars + 8 * (n_stages + s), (c / n_stages - 1) & 1);
    const MtStage st = mt_stage(stages, s, RB);
    // the rows first: the copy needs only the tile table, and lands while
    // the ids are read
    const uint32_t full = bars + 8 * s, data = smem_addr(st.data);
    const uint32_t bytes = (uint32_t)real * RB;
    if (lane == 0) mbar_expect_tx(full, bytes);
    __syncwarp();  // the bytes are expected before any copy lands
    if (N == d) {  // the tile's rows are one stretch of memory
      if (lane == 0 && bytes > 0) bulk_load(data, H + (size_t)r0 * d, bytes, full);
    } else {
      for (int i = lane; i < real; i += 32)
        bulk_load(data + i * RB, H + (size_t)(r0 + i) * d + n0, RB, full);
    }
    int sv[Q], rv[Q], lo[Q], hi[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = lane + 32 * q;
      sv[q] = i < real ? __ldg(src + r0 + i) : 0;
      rv[q] = i < real ? __ldg(rev + r0 + i) - r0 : 0;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = lane + 32 * q;
      lo[q] = i < real ? __ldg(ptr + sv[q]) - r0 : 0;
      hi[q] = i < real ? __ldg(ptr + sv[q] + 1) - r0 : 0;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = lane + 32 * q;
      if (i < real) {
        // an in-edge range or a reverse outside the tile's real rows: the
        // row is flagged, and no read leaves the stage
        const bool bad = rv[q] < 0 || rv[q] >= real || lo[q] < 0 || hi[q] > real || lo[q] > hi[q];
        st.ids[i] = bad ? MT_BAD
                        : (uint32_t)rv[q] | (uint32_t)lo[q] << 8 | (uint32_t)hi[q] << 16;
      }
    }
    if (lane == 0) {
      st.hdr[0] = r0;
      st.hdr[1] = rows;
      st.hdr[2] = real;
    }
    mbar_arrive(full);  // each lane after its ids are in
  }
}

// the consumer warps: per item, each 16-byte chunk of each row of the slice
// from the stage (zeros past the real rows), one thread a chunk, all of a
// thread's chunks formed before the stage goes back, then stored
template <typename T, int N>
__device__ void mt_consume(T* __restrict__ M, uint8_t* stages, uint32_t bars, int n_items, int d,
                           int n_stages) {
  constexpr int RB = N * (int)sizeof(T);
  constexpr int CH = RB / 16;                          // chunks of a row of the slice
  constexpr int EL = 16 / (int)sizeof(T);               // values of a chunk
  constexpr int PER = MT_ROWS * CH / MT_CONSUMERS;      // chunks a thread takes at most
  static_assert(MT_ROWS * CH % MT_CONSUMERS == 0, "a slice's chunks split evenly");
  const int tid = threadIdx.x, lane = tid % 32, slices = d / N;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  int c = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++c) {
    const int s = c % n_stages, n0 = (item % slices) * N;
    mbar_wait(bars + 8 * s, (c / n_stages) & 1);
    const MtStage st = mt_stage(stages, s, RB);
    const int r0 = st.hdr[0], rows = st.hdr[1], real = st.hdr[2];
    auto chunk = [&](int i, int ch) {
      return *(reinterpret_cast<const uint4*>(st.data + i * RB) + ch);
    };
    // the in-edges in row order, the first four (most atoms have at most
    // four neighbours) read at once; then the reverse row subtracted
    uint4 out[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int task = tid + k * MT_CONSUMERS, i = task / CH, ch = task % CH;
      uint4 o4 = zero4;
      if (i < real) {
        const uint32_t id = st.ids[i];
        if (id & MT_BAD) {
          o4 = nan_chunk<T>();
        } else {
          const int lo = (id >> 8) & 0xFF, hi = (id >> 16) & 0xFF;
          uint4 v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = lo + q < hi ? chunk(lo + q, ch) : zero4;
          const uint4 x4 = chunk(id & 0xFF, ch);
          float t[EL];
#pragma unroll
          for (int k = 0; k < EL; ++k) t[k] = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (lo + q < hi) add_chunk(t, v[q]);
          for (int j = lo + 4; j < hi; ++j) add_chunk(t, chunk(j, ch));
          o4 = sub_chunk(t, x4);
        }
      }
      out[k] = o4;
    }
    // the stage goes back after this warp's last read of it, before the
    // stores
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (n_stages + s));
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int task = tid + k * MT_CONSUMERS, i = task / CH, ch = task % CH;
      if (i < rows) *(reinterpret_cast<uint4*>(M + (size_t)(r0 + i) * d + n0) + ch) = out[k];
    }
  }
}

// item i is slice i % (d / N) of tile i / (d / N); block b takes items b,
// b + gridDim.x, ...
template <typename T, int N>
__global__ void __launch_bounds__(MT_THREADS, 1)
    message_tiles_kernel(const T* __restrict__ H, const int* __restrict__ src,
                         const int* __restrict__ rev, const int* __restrict__ ptr,
                         const int* __restrict__ tiles, T* __restrict__ M, int d, int pad_node,
                         int n_tiles, int n_stages) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  const uint32_t bars = smem_addr(base);  // full[s], then empty[s]
  uint8_t* stages = base + MT_BARS;
  const int n_items = n_tiles * (d / N);
  const int first_pad = __ldg(ptr + pad_node);
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(bars + 8 * s, 32);                             // the producer's lanes, and the bytes
      mbar_init(bars + 8 * (n_stages + s), MT_CONSUMER_WARPS);  // one per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < MT_CONSUMERS)
    mt_consume<T, N>(M, stages, bars, n_items, d, n_stages);
  else
    mt_produce<T, N>(H, src, rev, ptr, tiles, stages, bars, n_items, d, first_pad, n_stages);
}

// the stages of rb-byte rows that fit a block
static int mt_stages(int rb) {
  const int s = (TILE_SMEM_MAX - 128 - MT_BARS) / mt_stage_bytes(rb);
  return s < MT_MAX_STAGES ? s : MT_MAX_STAGES;
}

static size_t mt_smem(int rb, int stages) {
  return 128 + MT_BARS + (size_t)stages * mt_stage_bytes(rb);
}

// the row bytes of a slice at width d and element size es: the widest of 768,
// 512 and 256 bytes whose slice divides d (the whole row up to 768 bytes:
// one copy per tile); every candidate leaves room for two stages
static int mt_row_bytes(int d, int es) {
  const int widths[3] = {768, 512, 256};
  for (int rb : widths)
    if (rb % es == 0 && d % (rb / es) == 0 && mt_stages(rb) >= 2) return rb;
  return 0;
}

template <typename T, int N>
static cudaError_t mt_launch(const void* H, const int* src, const int* rev, const int* ptr,
                             const int* tiles, void* M, int d, int pad_node, int n_tiles,
                             cudaStream_t stream, int* blocks_per_sm = nullptr) {
  constexpr int RB = N * (int)sizeof(T);
  const int stages = mt_stages(RB);
  const size_t smem = mt_smem(RB, stages);
  // the opt-in above 48 KB is per device and per size, so it is made at every launch (cheap)
  cudaError_t err = cudaFuncSetAttribute(message_tiles_kernel<T, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (blocks_per_sm != nullptr)  // how many blocks of it one SM runs at once
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                         message_tiles_kernel<T, N>, MT_THREADS,
                                                         smem);
  message_tiles_kernel<T, N><<<tile_grid(n_tiles * (d / N)), MT_THREADS, smem, stream>>>(
      (const T*)H, src, rev, ptr, tiles, (T*)M, d, pad_node, n_tiles, stages);
  return cudaGetLastError();
}

static cudaError_t mt_dispatch(int dtype, int rb, const void* H, const int* src, const int* rev,
                               const int* ptr, const int* tiles, void* M, int d, int pad_node,
                               int n_tiles, cudaStream_t stream, int* blocks_per_sm = nullptr) {
  if (dtype == DT_BF16) {
    switch (rb) {
      case 768: return mt_launch<bf16, 384>(H, src, rev, ptr, tiles, M, d, pad_node, n_tiles, stream, blocks_per_sm);
      case 512: return mt_launch<bf16, 256>(H, src, rev, ptr, tiles, M, d, pad_node, n_tiles, stream, blocks_per_sm);
      case 256: return mt_launch<bf16, 128>(H, src, rev, ptr, tiles, M, d, pad_node, n_tiles, stream, blocks_per_sm);
    }
  } else if (dtype == DT_F32) {
    switch (rb) {
      case 768: return mt_launch<float, 192>(H, src, rev, ptr, tiles, M, d, pad_node, n_tiles, stream, blocks_per_sm);
      case 512: return mt_launch<float, 128>(H, src, rev, ptr, tiles, M, d, pad_node, n_tiles, stream, blocks_per_sm);
    }
  }
  return cudaErrorInvalidValue;
}

// M from the edge table H [n_edges x d], float32 or bfloat16, d a multiple of
// 128 up to MAX_WIDTH, over a tile table of n_tiles tiles (ascending row
// offsets from 0 to n_edges, at most 128 rows each, no molecule in two
// tiles); rows 16-byte aligned
extern "C" int message_tiles(const void* H, const int* src, const int* rev, const int* ptr,
                             const int* tiles, void* M, int n_edges, int d, int pad_node,
                             int n_tiles, int dtype, cudaStream_t stream) {
  const int es = dtype_bytes(dtype);
  if (es == 0 || d % 128 != 0 || d > MAX_WIDTH || n_edges < 0 || tiles == nullptr ||
      n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  if (n_edges == 0) return 0;
  const int rb = mt_row_bytes(d, es);
  if (rb == 0) return (int)cudaErrorInvalidValue;
  return (int)mt_dispatch(dtype, rb, H, src, rev, ptr, tiles, M, d, pad_node, n_tiles, stream);
}

// the launch's shape at width d over n_tiles tiles, into info[0..5]: slice
// width N, slices, stages, shared-memory bytes per block, blocks of the grid,
// and blocks of the kernel that one SM runs at once
extern "C" int message_tiles_info(int d, int dtype, int n_tiles, int* info) {
  const int es = dtype_bytes(dtype);
  const int rb = es != 0 && d % 128 == 0 && d <= MAX_WIDTH ? mt_row_bytes(d, es) : 0;
  if (rb == 0 || n_tiles <= 0) return (int)cudaErrorInvalidValue;
  const int n = rb / es;
  info[0] = n;
  info[1] = d / n;
  info[2] = mt_stages(rb);
  info[3] = (int)mt_smem(rb, info[2]);
  info[4] = tile_grid(n_tiles * (d / n));
  return (int)mt_dispatch(dtype, rb, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, d, 0,
                          n_tiles, nullptr, &info[5]);
}
