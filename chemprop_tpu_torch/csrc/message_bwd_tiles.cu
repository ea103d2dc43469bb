// The masked transposed message over the molecule tiles, redesigned for
// Hopper:
//
//   gz[k]  = g[k] [y[k] > 0]                                    (no mask without y)
//   G[e]   = sum_{j in [ptr[v], ptr[v+1])} gz[rev[j]] - gz[rev[e]],  v = dst[e]
//   gz_out = gz + acc                                           (G takes gz, not gz_out)
//
// summed in f32 in the order of the rows j, from +0, and rounded once to g's
// dtype (float32 or bfloat16). Rows from ptr[pad_node] on (the padding
// edges) get exact zeros in G and gz_out, with no load. These are the sums
// and the bits of message_bwd.cu's node-warp form, row for row; without y
// and without gz_out it is the backward of the message itself.
//
// message_bwd_tiles replaces the Pallas TPU kernel _bwd_msg_kernel of
// chemprop_tpu/ops/fused_message.py (launched by _bwd_msg_impl, with its
// has_acc form), which forms (S - R)^T as a one-hot product over a sliding
// window of 128-edge chunks on the MXU.
//
// It is bound by bytes on the H100: g, y and acc read over the real rows, G
// and gz_out written over every row, dst and rev of the real rows, the tile
// table and one ptr entry (chip_smoke.bwd_message_bytes). At the benchmark
// batch ([123,392 x 384] edge tables, 120,482 real rows) that is about
// 0.112 ms in bf16, 0.140 ms with acc and 0.224 ms in f32 at 3.35 TB/s;
// three adds a row and element. The node-warp form follows a chain of
// dependent loads for each in-edge (ptr -> rev -> a g row and a y row) with
// 8 bytes a lane in bf16, reads every reverse row's g and y twice (for the
// node's sum and for G) and a node's own rows a third time (for gz), and has
// two or three in-edges of work in flight per warp. Here, as in A
// (message_tiles.cu) and G (bwd_nodes.cu):
//
// * One launch of persistent blocks over (tile, column slice) items of the
//   collate's tile table. A tile holds at most 128 rows and no molecule is
//   split, so every rev[j] and every in-edge of a row's dst lies in the
//   tile: the block stages the tile's rows of g, y and acc in shared memory
//   once and forms every row of G from there. No row is read twice from
//   device memory or L2, and no pointer is chased through device memory by
//   the warps that sum.
// * A producer warp starts the stage's copies as soon as it is free (they
//   need only the tile table), then reads dst and rev and packs each row's
//   reverse and its node's in-edge range, found by ballots over dst
//   (tiles.cuh, shared with bwd_nodes.cu). Two stages must fit 227 KB, so a
//   block takes a column slice of 384 bytes a row with y (two tables: bf16
//   192 columns, f32 96) and of 256 with acc too (three: bf16 128, f32 64);
//   the message's own backward stages g alone, up to 768 bytes a row. A
//   slice comes in by TMA boxes of 32 rows of a 2-d tensor map (one
//   instruction, not 32), and the rows past the last whole box by one bulk
//   copy each, so that no byte outside the tile's real rows is read; where a
//   block takes every column the tile is one stretch of memory and one bulk
//   copy brings it.
// * Sixteen consumer warps mask the staged g in place by the staged y
//   (16-byte accesses), so that the stage holds the unaccumulated gz that G
//   needs, and write gz_out = gz + acc, summed in registers, never into the
//   stage. After a barrier among them they form each 16-byte chunk of G
//   in one thread from the stage, give the stage back, then store. Every
//   output chunk is written by one thread in a fixed order with no atomics:
//   two calls give the same bits.
//
// What binds it on the card (experiments/torch_bwd_message.py and
// torch_bwd_message_parts.py, H100 SXM at 700 W; numbers in PERF.md): the
// memory system. At the benchmark batch it takes about 0.137 ms of device
// time in bf16 (0.82 of the bound), 0.172 with acc and 0.266-0.270 in f32,
// where the node-warp form takes 0.20, 0.27 and 0.29. Copies of the kernel
// without the copies took 0.059 ms less in bf16, without either store
// 0.037-0.040 less, without the sums about nothing. Slices brought in by one
// bulk copy a row instead of TMA boxes took 0.040 ms more (twice the time
// with acc); boxes of 16 or 64 rows, and slices of 256 bytes, came within 5%
// of boxes of 32 in no order that held from call to call. An earlier form
// that staged g alone (whole bf16 tiles) and read y and acc straight into
// registers, 16 bytes a thread, hit the 96 registers a thread of 544 may
// hold and spilled: 0.145 to 0.26 ms in bf16 and 0.21 to 0.30 with acc, as
// it grouped its consumer warps and its loads.
//
// Padding rows and padding tiles (which hold no molecule) are written as
// zeros without any load. With a table that breaks the collate's rule, every
// row of a node whose in-edges, or their reverses, are not all inside its
// tile gets NaN in G, whole; gz_out is formed from the row alone and stays
// whole.
//
// A split tile table (the collate's split_ptr: a molecule of more than 128
// rows cut at its nodes' boundaries, so one molecule spans several tiles)
// runs through the same launch, and three things keep its result right:
// * its tiles keep the rules tile_rows reads: ascending offsets, at most 128
//   rows a tile, and the rows of a node in one tile (no cut inside a node's
//   run, so bad_first and bad_last never fire). A row of G is flagged
//   (TILE_BAD) and written as NaN exactly when one of its node's in-edges has
//   its reverse in another tile: the collate's cross_rows, row for row;
// * a flagged row of G is written once, by this launch, and read by nothing:
//   the stage holds gz, never G. The caller then forms every such row again
//   with bwd_message_rows (message_bwd.cu) from g and y, in stream order
//   after this launch;
// * gz_out is formed from the row's own g, y and acc alone, so it is right on
//   every row, flagged or not, and the pass leaves it as it is; the pass
//   reads g and y, not gz_out, so that G takes the unaccumulated gz with
//   acc too.
// Without any tile table, or at a width that is not a multiple of 128, the
// caller takes message_bwd.cu.
#include "sm90.cuh"
#include "tiles.cuh"

constexpr int FT_CONSUMER_WARPS = 16;
constexpr int FT_CONSUMERS = 32 * FT_CONSUMER_WARPS;  // threads 0-511; the producer warp after
constexpr int FT_THREADS = FT_CONSUMERS + 32;
constexpr int FT_MAX_STAGES = 4;
constexpr int FT_BARS = 128;                 // bytes of the barriers: 2 per stage
constexpr int FT_IDS = 4 * (TILE_ROWS + 4);  // packed ids, then the header
constexpr int FT_BOX_ROWS = 32;              // rows of a TMA box of a column slice
constexpr int FT_BOX_MAX = 256;              // the most columns a TMA box holds

// the bytes of a stage of `tables` tables (g, then y with the mask, then acc
// with gz_out) whose rows are rb bytes (a row's column slice): each table's
// TILE_ROWS rows, then per row its packed id, then the header (first row,
// rows, real rows)
__host__ __device__ inline int ft_stage_bytes(int rb, int tables) {
  return (tables * TILE_ROWS * rb + FT_IDS + 127) & ~127;
}

struct FtStage {
  uint8_t* data;
  uint32_t* ids;
  int* hdr;
};

__device__ __forceinline__ FtStage ft_stage(uint8_t* stages, int s, int rb, int tables) {
  FtStage st;
  st.data = stages + s * ft_stage_bytes(rb, tables);
  st.ids = reinterpret_cast<uint32_t*>(st.data + tables * TILE_ROWS * rb);
  st.hdr = reinterpret_cast<int*>(st.ids + TILE_ROWS);
  return st;
}

// the slice's real rows [r0, r0 + real) of a [n_edges x d] table into the
// stage at dst, counted on `full`: one bulk copy where a block takes every
// column (WHOLE: the rows are one stretch of memory), else TMA boxes of
// FT_BOX_ROWS rows and the rows past the last whole box one bulk copy each
// (one bulk copy a row where a slice is wider than a box); all 32 lanes call
// it
template <typename T, int N, bool WHOLE>
__device__ __forceinline__ void ft_copy(uint32_t dst, const CUtensorMap* map,
                                        const T* __restrict__ table, int r0, int real, int d,
                                        int n0, uint32_t full) {
  constexpr int RB = N * (int)sizeof(T);
  const int lane = threadIdx.x % 32;
  if (WHOLE) {
    if (lane == 0 && real > 0) bulk_load(dst, table + (size_t)r0 * d, (uint32_t)real * RB, full);
    return;
  }
  int boxed = 0;
  if (N <= FT_BOX_MAX) {
    boxed = real / FT_BOX_ROWS * FT_BOX_ROWS;
    for (int b = lane; b * FT_BOX_ROWS < boxed; b += 32)
      tma_load_2d(dst + b * FT_BOX_ROWS * RB, map, full, n0, r0 + b * FT_BOX_ROWS);
  }
  for (int i = boxed + lane; i < real; i += 32)
    bulk_load(dst + i * RB, table + (size_t)(r0 + i) * d + n0, RB, full);
}

// the producer warp: per item, once the stage is free, the slice's rows of
// g, y and acc (those given) by bulk copies or TMA, then the tile's ids,
// packed into the stage; the bytes and each lane's arrival (after its ids)
// count on the stage's full barrier
template <typename T, int N, bool WHOLE>
__device__ void ft_produce(const CUtensorMap* maps, const T* __restrict__ g,
                           const T* __restrict__ y, const T* __restrict__ acc,
                           const int* __restrict__ dst, const int* __restrict__ rev,
                           const int* __restrict__ tiles, uint8_t* stages, uint32_t bars,
                           int n_items, int n_edges, int d, int first_pad, int n_stages) {
  constexpr int RB = N * (int)sizeof(T);
  const int lane = threadIdx.x % 32, slices = d / N;
  const int tables = 1 + (y != nullptr) + (acc != nullptr);
  if (!WHOLE && N <= FT_BOX_MAX && (lane == 0 || (lane == 1 && y != nullptr) ||
                                    (lane == 2 && acc != nullptr)))
    tma_prefetch_map(maps + lane);
  int c = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++c) {
    const int s = c % n_stages, t = item / slices, n0 = (item % slices) * N;
    const int r0 = __ldg(tiles + t);
    const int rows = max(0, min(__ldg(tiles + t + 1) - r0, TILE_ROWS));
    const int real = max(0, min(rows, first_pad - r0));  // rows before the padding
    if (c >= n_stages) mbar_wait(bars + 8 * (n_stages + s), (c / n_stages - 1) & 1);
    const FtStage st = ft_stage(stages, s, RB, tables);
    // the rows first: the copies need only the tile table, and land while
    // the ids are read
    const uint32_t full = bars + 8 * s, data = smem_addr(st.data);
    if (lane == 0) mbar_expect_tx(full, (uint32_t)(tables * real * RB));
    __syncwarp();  // the bytes are expected before any copy lands
    ft_copy<T, N, WHOLE>(data, maps, g, r0, real, d, n0, full);
    if (y != nullptr)
      ft_copy<T, N, WHOLE>(data + TILE_ROWS * RB, maps + 1, y, r0, real, d, n0, full);
    if (acc != nullptr)
      ft_copy<T, N, WHOLE>(data + (tables - 1) * TILE_ROWS * RB, maps + 2, acc, r0, real, d, n0,
                           full);
    const TileRows tr = tile_rows(dst, rev, r0, real, n_edges);
    tile_store_ids(tr, real, st.ids);
    if (lane == 0) {
      st.hdr[0] = r0;
      st.hdr[1] = rows;
      st.hdr[2] = real;
    }
    mbar_arrive(full);  // each lane after its ids are in
  }
}

// the consumer warps: per item, gz in place over the staged g and gz_out
// (zeros past the real rows), then each 16-byte chunk of G from the stage,
// one thread a chunk, all of a thread's chunks formed before the stage goes
// back, then stored. Task k of thread tid is chunk tid + k * FT_CONSUMERS of
// the slice, row by row: at that index in each table's rows in the stage,
// and in the tables in device memory too where a block takes every column
// (WHOLE: one base and constant offsets)
template <typename T, int N, bool WHOLE>
__device__ void ft_consume(bool masked, bool has_acc, T* __restrict__ G,
                           T* __restrict__ gz_out, uint8_t* stages, uint32_t bars, int n_items,
                           int d, int n_stages) {
  constexpr int RB = N * (int)sizeof(T);
  constexpr int CH = RB / 16;                         // chunks of a row of the slice
  constexpr int PER = TILE_ROWS * CH / FT_CONSUMERS;  // chunks a thread takes at most
  static_assert(TILE_ROWS * CH % FT_CONSUMERS == 0, "a slice's chunks split evenly");
  const int tid = threadIdx.x, lane = tid % 32, slices = d / N;
  const int tables = 1 + masked + has_acc;
  const int row4 = d * (int)sizeof(T) / 16;  // chunks of a whole row
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  int c = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++c) {
    const int s = c % n_stages, n0 = (item % slices) * N;
    mbar_wait(bars + 8 * s, (c / n_stages) & 1);
    const FtStage st = ft_stage(stages, s, RB, tables);
    const int r0 = st.hdr[0], rows = st.hdr[1], real = st.hdr[2];
    uint4* sg = reinterpret_cast<uint4*>(st.data);                // g, then gz
    const uint4* sy = sg + TILE_ROWS * CH;                        // y
    const uint4* sa = sg + (tables - 1) * TILE_ROWS * CH;         // acc
    const size_t first = (size_t)r0 * d + n0;  // the slice's first element in a table
    // the chunk of task `task` in a table, from the slice's first element
    auto at = [&](int task) { return WHOLE ? task : task / CH * row4 + task % CH; };

    // gz: the staged g masked in place; gz_out = gz (+ acc), zeros past the
    // real rows
    if (masked || gz_out != nullptr) {
      uint4* z4 = reinterpret_cast<uint4*>(gz_out + (gz_out != nullptr ? first : 0));
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int task = tid + k * FT_CONSUMERS;
        if (task >= rows * CH) break;
        if (task >= real * CH) {
          if (gz_out != nullptr) z4[at(task)] = zero4;
          continue;
        }
        uint4 z = sg[task];
        if (masked) {
          z = mask_chunk<T>(z, sy[task]);
          sg[task] = z;
        }
        if (gz_out != nullptr)
          z4[at(task)] = has_acc ? add_chunks<T>(z, sa[task]) : masked ? z : round_chunk<T>(z);
      }
      if (masked)  // the tile's gz is in
        asm volatile("bar.sync 1, %0;" ::"n"(FT_CONSUMERS) : "memory");
    }

    // G: the in-edges of the row's node in row order, less the row's reverse
    uint4 o[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int task = tid + k * FT_CONSUMERS;
      const int i = task / CH, ch = task % CH;
      o[k] = task < real * CH ? transposed_chunk<T, CH>(sg, st.ids, i, ch) : zero4;
    }
    // the stage goes back after this warp's last read of it (and its writes
    // of gz are ordered before the copies that refill it), before the stores
    if (masked) fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (n_stages + s));
    uint4* G4 = reinterpret_cast<uint4*>(G + first);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int task = tid + k * FT_CONSUMERS;
      if (task < rows * CH) G4[at(task)] = o[k];
    }
  }
}

// the TMA maps of g, y and acc, for slices that TMA boxes bring in
struct FtMaps {
  CUtensorMap m[3];
};

// item i is slice i % (d / N) of tile i / (d / N); block b takes items b,
// b + gridDim.x, ...
template <typename T, int N, bool WHOLE>
__global__ void __launch_bounds__(FT_THREADS, 1)
    bwd_tiles_kernel(const __grid_constant__ FtMaps maps, const T* __restrict__ g,
                     const T* __restrict__ y, const T* __restrict__ acc,
                     const int* __restrict__ dst, const int* __restrict__ rev,
                     const int* __restrict__ ptr, const int* __restrict__ tiles,
                     T* __restrict__ G, T* __restrict__ gz_out, int n_edges, int d,
                     int pad_node, int n_tiles, int n_stages) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  const uint32_t bars = smem_addr(base);  // full[s], then empty[s]
  uint8_t* stages = base + FT_BARS;
  const int n_items = n_tiles * (d / N);
  const int first_pad = __ldg(ptr + pad_node);
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(bars + 8 * s, 32);  // the producer's lanes, and the bytes
      mbar_init(bars + 8 * (n_stages + s), FT_CONSUMER_WARPS);  // one per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < FT_CONSUMERS)
    ft_consume<T, N, WHOLE>(y != nullptr, acc != nullptr, G, gz_out, stages, bars, n_items, d,
                            n_stages);
  else
    ft_produce<T, N, WHOLE>(maps.m, g, y, acc, dst, rev, tiles, stages, bars, n_items, n_edges,
                            d, first_pad, n_stages);
}

// the stages of `tables` tables of rb-byte rows that fit a block
static int ft_stages(int rb, int tables) {
  const int s = (TILE_SMEM_MAX - 128 - FT_BARS) / ft_stage_bytes(rb, tables);
  return s < FT_MAX_STAGES ? s : FT_MAX_STAGES;
}

static size_t ft_smem(int rb, int tables, int stages) {
  return 128 + FT_BARS + (size_t)stages * ft_stage_bytes(rb, tables);
}

// the row bytes of a slice at width d and element size es with `tables`
// tables staged: the widest of 768, 512, 384 and 256 bytes whose slice
// divides d and leaves room for two stages (the whole row where it fits:
// one copy per tile and table)
static int ft_row_bytes(int d, int es, int tables) {
  const int widths[4] = {768, 512, 384, 256};
  for (int rb : widths)
    if (d % (rb / es) == 0 && ft_stages(rb, tables) >= 2) return rb;
  return 0;
}

// [rows x d] row-major table at T of es-byte elements, in boxes of n
// columns x FT_BOX_ROWS rows, no swizzle: a box lands as FT_BOX_ROWS rows of
// n es bytes, one after another
static bool slice_map(CUtensorMap* map, const void* T, int rows, int d, int es, int n) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)d * es};
  cuuint32_t box[2] = {(cuuint32_t)n, (cuuint32_t)FT_BOX_ROWS}, elem[2] = {1, 1};
  return encode(map, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                2, const_cast<void*>(T), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct FtArgs {
  const void *g, *y, *acc;
  const int *dst, *rev, *ptr, *tiles;
  void *G, *gz_out;
  int n_edges, d, pad_node, n_tiles;
};

static int ft_tables(const FtArgs& a) { return 1 + (a.y != nullptr) + (a.acc != nullptr); }

template <typename T, int N, bool WHOLE>
static cudaError_t ft_launch_as(const FtArgs& a, cudaStream_t stream, int* blocks_per_sm) {
  constexpr int RB = N * (int)sizeof(T);
  const int tables = ft_tables(a), stages = ft_stages(RB, tables);
  const size_t smem = ft_smem(RB, tables, stages);
  auto kernel = bwd_tiles_kernel<T, N, WHOLE>;
  // the opt-in above 48 KB is per device and per size, so it is made at every launch (cheap)
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (blocks_per_sm != nullptr)  // how many blocks of it one SM runs at once
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, FT_THREADS,
                                                         smem);
  FtMaps maps = {};
  if (!WHOLE && N <= FT_BOX_MAX) {
    const void* t[3] = {a.g, a.y, a.acc};
    for (int k = 0; k < 3; ++k)
      if (t[k] != nullptr && !slice_map(&maps.m[k], t[k], a.n_edges, a.d, (int)sizeof(T), N))
        return cudaErrorInvalidValue;
  }
  kernel<<<tile_grid(a.n_tiles * (a.d / N)), FT_THREADS, smem, stream>>>(
      maps, (const T*)a.g, (const T*)a.y, (const T*)a.acc, a.dst, a.rev, a.ptr, a.tiles,
      (T*)a.G, (T*)a.gz_out, a.n_edges, a.d, a.pad_node, a.n_tiles, stages);
  return cudaGetLastError();
}

// a block takes every column of a row (one copy of each whole tile and
// table, linear addresses) where the slice is the row
template <typename T, int N>
static cudaError_t ft_launch(const FtArgs& a, cudaStream_t stream, int* blocks_per_sm) {
  if constexpr (N % 128 == 0)
    if (a.d == N) return ft_launch_as<T, N, true>(a, stream, blocks_per_sm);
  return ft_launch_as<T, N, false>(a, stream, blocks_per_sm);
}

static cudaError_t ft_dispatch(int dtype, int rb, const FtArgs& a, cudaStream_t stream,
                               int* blocks_per_sm) {
  if (dtype == DT_BF16) {
    switch (rb) {
      case 768: return ft_launch<bf16, 384>(a, stream, blocks_per_sm);
      case 512: return ft_launch<bf16, 256>(a, stream, blocks_per_sm);
      case 384: return ft_launch<bf16, 192>(a, stream, blocks_per_sm);
      case 256: return ft_launch<bf16, 128>(a, stream, blocks_per_sm);
    }
  } else if (dtype == DT_F32) {
    switch (rb) {
      case 768: return ft_launch<float, 192>(a, stream, blocks_per_sm);
      case 512: return ft_launch<float, 128>(a, stream, blocks_per_sm);
      case 384: return ft_launch<float, 96>(a, stream, blocks_per_sm);
      case 256: return ft_launch<float, 64>(a, stream, blocks_per_sm);
    }
  }
  return cudaErrorInvalidValue;
}

// (G, gz_out) from the edge cotangent g [n_edges x d], float32 or bfloat16,
// d a multiple of 128 up to MAX_WIDTH, over a tile table of n_tiles tiles
// (ascending row offsets from 0 to n_edges, at most 128 rows each, no
// molecule in two tiles); y (no mask when null), acc and gz_out (not written
// when null) are [n_edges x d] of g's dtype, acc read only with gz_out; rows
// 16-byte aligned
extern "C" int bwd_message_tiles(const void* g, const void* y, const void* acc, const int* dst,
                                 const int* rev, const int* ptr, const int* tiles, void* G,
                                 void* gz_out, int n_edges, int d, int pad_node, int n_tiles,
                                 int dtype, cudaStream_t stream) {
  const int es = dtype_bytes(dtype);
  if (es == 0 || d % 128 != 0 || d > MAX_WIDTH || n_edges < 0 || tiles == nullptr ||
      n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  if (n_edges == 0) return 0;
  const FtArgs a = {g,     y,  gz_out != nullptr ? acc : nullptr,
                    dst,   rev, ptr, tiles, G, gz_out, n_edges, d, pad_node, n_tiles};
  const int rb = ft_row_bytes(d, es, ft_tables(a));
  if (rb == 0) return (int)cudaErrorInvalidValue;
  return (int)ft_dispatch(dtype, rb, a, stream, nullptr);
}

// the launch's shape at width d with `tables` tables staged (1: the
// message's own backward, g alone; 2: with the mask, g and y; 3: with
// gz_acc too) over n_tiles tiles, into info[0..6]: slice width N, slices,
// stages, shared-memory bytes per block, blocks of the grid, blocks of the
// kernel that one SM runs at once, and the rows of a TMA box (0: one bulk
// copy of each whole tile and table, or one a row)
extern "C" int bwd_message_tiles_info(int d, int dtype, int tables, int n_tiles, int* info) {
  const int es = dtype_bytes(dtype);
  const int rb = es != 0 && d % 128 == 0 && d <= MAX_WIDTH && tables >= 1 && tables <= 3
                     ? ft_row_bytes(d, es, tables)
                     : 0;
  if (rb == 0 || n_tiles <= 0) return (int)cudaErrorInvalidValue;
  const int n = rb / es;
  info[0] = n;
  info[1] = d / n;
  info[2] = ft_stages(rb, tables);
  info[3] = (int)ft_smem(rb, tables, info[2]);
  info[4] = tile_grid(n_tiles * (d / n));
  info[6] = n != d && n <= FT_BOX_MAX ? FT_BOX_ROWS : 0;
  const int one = 1;  // a non-null stand-in, never read: it selects the tables' layout
  const FtArgs a = {nullptr, tables >= 2 ? &one : nullptr, tables >= 3 ? &one : nullptr,
                    nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, d, 0, n_tiles};
  return (int)ft_dispatch(dtype, rb, a, nullptr, &info[5]);
}
