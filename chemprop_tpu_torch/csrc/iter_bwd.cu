// The whole backward of one bfloat16 depth iteration y = relu(H0 + M(H) W),
// redesigned for Hopper: from the cotangent g, the saved output y, the
// iteration's input H ([E x d] bf16) and W ([d x d] bf16, (in, out) layout),
//
//   gz = g [y > 0]                                        (written: it is dH0)
//   G  = (S - R)^T gz, G[e] = sum_{j in [ptr[v], ptr[v+1])} gz[rev[j]] - gz[rev[e]],
//        v = dst[e], summed in f32 in the order of the rows j and rounded once
//        to bf16                                         (never written)
//   dH = G W^T in bf16 (f32 sums),   dW = H^T G in f32, H's padding rows left out.
//
// iter_bwd_tiles replaces the Pallas TPU kernel _iter_bwd_kernel of
// chemprop_tpu/ops/fused_message.py (launched by _iter_bwd_impl), which
// streams g and y once, masks each chunk in place into gz, and feeds each
// chunk's G to both products while it is still on chip, W^T resident and the
// [d x d] dW accumulated in VMEM across its sequential grid.
//
// Its bound on the H100 is bytes: g, y and H read over the real rows, dH and
// gz written over every row, W read and dW written once, about 469 MB at the
// benchmark batch ([123,392 x 384]), 0.140 ms at 3.35 TB/s, against the two
// products' 71 GFLOP (0.072 ms at the bf16 tensor peak). The form without a
// tile table (message_bwd.cu, three launches) gathers every row of G from
// device memory four times and runs its products on WMMA. Here:
//
// * One launch over the molecule tiles. The collate's tile table cuts the
//   dst-sorted rows into tiles of at most 128 rows with no molecule in two,
//   so every reverse and every in-edge a tile's row of G needs lies in the
//   tile. G is column-local: its column c needs column c of gz alone.
// * dW is the crux: a [384 x 384] f32 accumulator (590 KB) fits no block,
//   and float atomics would make runs differ. So the columns are cut into
//   d / 64 boxes, and a cluster of d / 64 CTAs (six at d = 384; 17 clusters
//   fit an H100, 102 of its 132 SMs) takes each tile together. CTA s owns
//   box s: g, y and H's box s of the tile come in by TMA (each byte of them
//   read from device memory once); G's box s is formed from shared memory
//   and pushed into the other CTAs' shared memory by bulk copies
//   (cp.async.bulk shared::cluster), so every CTA holds the tile's G, all
//   columns, and G never leaves the chip. Each CTA then keeps dW's rows of
//   box s, [64 x d], in registers for the whole launch (96 a thread at
//   d = 384, in two consumer warpgroups) and writes it as its cluster's
//   partial; a second launch adds the clusters' partials in a fixed order.
//   Partition and order depend on the card and the shapes alone, and there
//   are no atomics: two calls give the same bits.
// * Halves. A tile is taken 64 rows (wgmma's M) at a time into one of two
//   half buffers of G, [64 x d] each, so that the next half's G crosses the
//   cluster while this half is multiplied. Per half: dH's 64 rows in the
//   box's 64 columns (G as the K-major A operand, W's rows of the box,
//   resident, as the K-major B operand: W^T is never formed), in warpgroup 0
//   alone so that G is read once; dW's rows of the box (H's half as the
//   MN-major A operand, G as the MN-major B operand), split by columns over
//   both warpgroups. A full and a free barrier per half buffer hand it from
//   half to half across the cluster.
// * Warp roles, 512 threads: two consumer warpgroups (160 registers a
//   thread, by setmaxnreg), seven G warps and a producer warp (96). The
//   producer finds each tile's row ids by ballots over dst (each row's
//   reverse and its node's first row, as bwd_nodes.cu does) and issues the
//   TMA loads. The G warps mask g into gz in place (three SIMD operations a
//   word), write it out, form G per node (T[v] once, over its in-edges in
//   their order, then each of its rows less its reverse) into an own box,
//   copy it into the half buffer once the cluster is done with that buffer,
//   and push it, one lane per other CTA.
// * What binds it on the card (H100 SXM at 700 W; PERF.md has the numbers,
//   from experiments/torch_iter_bwd.py --trace and from
//   experiments/torch_iter_bwd_parts.py, which times copies of this kernel
//   with one part removed): each half is a chain, in series, of G's box in
//   the G warps, the pushes' arrival, the products and the barriers, whose
//   only slack is the second half buffer (a third does not fit beside W's
//   resident slice); the hand-over alone, every load, store, product and
//   push removed, takes a large share of the time, and everything else
//   crosses the SM's shared-memory path. Two things it taught: one thread
//   arriving on the cluster's barriers CTA after CTA was far slower than one
//   lane per CTA arriving side by side; and three G warps could not keep
//   up, so there are seven, with registers moved by setmaxnreg.
// * The same gz and G as the form without a table: the same select for gz
//   (for every g but a NaN), and G's f32 sums in the same order, rounded
//   once. dH and dW sum the same products in another order than
//   message_bwd.cu's WMMA and xtg.cuh's split product, so those two outputs
//   of the two forms are not bit-equal; both are held to iter_bwd_plain
//   within chip_smoke.py's limits.
//
// Padding rows (from ptr[pad_node] on) get exact zeros in dH and gz; tiles
// of padding rows take no loads, and H's rows there are zeroed in shared
// memory before they could reach dW. With a table that breaks the collate's
// rule, every row of a node that cannot be formed inside its tile gets NaN
// in G, so its row of dH is NaN: no row it cannot form comes out finite.
//
// Over a split tile table (BatchMolGraph.split_ptr: a molecule of more than
// 128 rows cut at its nodes' boundaries) those rows are the batch's cross
// rows (BatchMolGraph.cross_rows), and this launch forms them too:
// * What it replaced, and what bound that: the launch wrote zeros into
//   their G, and a second pass of three launches formed their G into a
//   compact table G_c, then dH[rows] = G_c W^T and H[rows]^T G_c as one more
//   f32 partial of dW, both on WMMA. At Tox21's 260 to 1,040 cross rows that
//   pass took 53-92 us of device time on an H100 SXM at 700 W (PERF.md)
//   against a bound under 1 us: three launches, and two small products at
//   about 1.3 TFLOP/s, repeating what the wgmma warpgroups here do for every
//   other row.
// * A cross row's G depends on g and y alone, never on this launch's
//   outputs. So one launch before this one (message_bwd.cu's iter_bwd_rows)
//   forms G_c, [n_cross x d] bf16 in the list's order, with the f32 sums in
//   the order and the one rounding every other row gets here, and writes the
//   map slot[cross[w]] = w. The G warps load a flagged row's chunk of their
//   column box from G_c into the own box, where they would have formed it;
//   from there the row goes the way of every row: pushed across the cluster,
//   through dH's wgmma and into the clusters' dW. What is left of the pass is
//   the G_c launch (one warp a listed row, a launch's latency), and the
//   G_c loads in the halves that hold cross rows.
// * The lookup stays off the G warps' serial chain (each half is a chain of
//   G's box, the pushes, the products and the barriers, above): the
//   producer warp, while it forms the ids of a tile that holds flagged rows,
//   reads the map at the tile's rows, keeps an entry only where cross[]
//   holds that row at that slot (so entries the G_c launch did not write are
//   harmless), and stores with the ids per row its slot less the tile's
//   first one, a byte (the tile's listed rows are at most 128 neighbours in
//   the ascending list), and that first slot. A map and not a search of the
//   list per tile: a list that is a superset of the flagged rows costs
//   nothing, and one that misses a row costs that row alone.
// * A flagged row that the list does not hold gets NaN in G, as without a
//   split table: no row the launch cannot form comes out finite. The branch
//   has no barrier. dH at every other row is the same bits as when the cross
//   rows were zeros (a row of dH depends on its own row of G alone); dH at
//   the cross rows and dW sum their products in the wgmma's order.
// Widths d = 128, 256 and 384 (clusters of 2, 4 and 6); the buffers of
// d = 512 would not fit a block's shared memory.
#include <climits>

#include "sm90.cuh"
#include "vec.cuh"

constexpr int IB_ROWS = 128;               // the most rows a tile holds
constexpr int IB_HALF = 64;                // rows of a half: wgmma's M
constexpr int IB_BOX = IB_ROWS * 128;      // a [128 x 64] bf16 box: a tile's g (then gz)
constexpr int IB_HBOX = IB_HALF * 128;     // a [64 x 64] bf16 box: a half of G or H, or of W
constexpr int IB_OWN = 2;                  // boxes of G formed ahead of their turn
constexpr int IB_HSTAGES = 2;              // halves of H in flight
constexpr int IB_G0 = 256;                 // first thread of the G warps
constexpr int IB_G_THREADS = 224;          // seven G warps
constexpr int IB_PRODUCER0 = IB_G0 + IB_G_THREADS;  // the producer warp, the last
constexpr int IB_THREADS = IB_PRODUCER0 + 32;       // 512 threads, four warpgroups
constexpr int IB_REGS_CONSUMER = 160;      // registers a thread: the two consumer warpgroups,
constexpr int IB_REGS_OTHER = 96;          // the other two (in all 65,536: the SM's registers)
constexpr int IB_MT = (IB_ROWS * 8 + IB_G_THREADS - 1) / IB_G_THREADS;  // a G thread's chunks of a tile
constexpr int IB_SMEM_MAX = 232448;        // a block's shared memory on sm_90
constexpr int IB_IDS = 400;                // a stage's ids: per row its reverse, the node starts, a header,
                                           // per row its slot in G_c (split tables)
constexpr int IB_BASE = 264;               // a stage's int: the tile's first slot in G_c
constexpr int IB_SLOTS = 272;              // a stage's bytes per row: the slot less that one
constexpr uint8_t IB_UNLISTED = 0xFF;      // slot byte: the cross list does not hold the row
constexpr uint8_t IB_BAD = 0x80;           // reverse flag: the row's node is not whole in the tile
constexpr long long IB_HANG = 1ll << 35;   // clock cycles (~17 s) after which a wait traps

// barriers, 8 bytes each after sm.bars
enum {
  B_ZFULL = 0,    // two: a tile's g box and its ids have landed (32 producer lanes + bytes)
  B_ZFREE = 2,    // two: the G warps are done with that stage (one per G warp)
  B_HFULL = 4,    // IB_HSTAGES: a half of H has landed
  B_HFREE = 6,    // IB_HSTAGES: the consumers have multiplied with it
  B_YFULL = 8,    // a tile's y box has landed
  B_YFREE = 9,    // the G warps have masked with it (one per G warp)
  B_WFULL = 10,   // W's rows of this CTA's box have landed
  B_GFULL = 11,   // two: a half of G is whole in this CTA (d / 64 boxes pushed in)
  B_GFREE = 13,   // two: every CTA of the cluster is done with that half
  B_COUNT = 15,
};

struct IbSmem {
  uint32_t g[2];   // two halves of G, d / 64 boxes each: every column of 64 rows
  uint32_t w;      // d / 64 boxes of W's rows of this CTA's box
  uint32_t own;    // IB_OWN boxes of this CTA's column box of G, formed ahead
  uint32_t z[2];   // a tile's g, then gz in place, in this CTA's column box
  uint32_t y;      // a tile's y in this CTA's column box
  uint32_t h;      // IB_HSTAGES halves of H's column box
  uint32_t ids;    // two stages of a tile's ids (IB_IDS bytes each)
  uint32_t bars;
};

__host__ __device__ constexpr int ib_smem_bytes(int nb) {
  return 1024 + 3 * nb * IB_HBOX + (IB_OWN + IB_HSTAGES) * IB_HBOX + 3 * IB_BOX +
         2 * IB_IDS + 8 * B_COUNT;
}
// d = 384 leaves 1,128 bytes of a block's shared memory: a larger stage of
// ids or one more box must give up a stage elsewhere, or that width goes
static_assert(ib_smem_bytes(6) <= IB_SMEM_MAX, "iter_bwd: d = 384 no longer fits a block");

__device__ __forceinline__ IbSmem ib_layout(uint32_t base, int nb) {
  IbSmem sm;
  sm.g[0] = base;
  sm.g[1] = sm.g[0] + nb * IB_HBOX;
  sm.w = sm.g[1] + nb * IB_HBOX;
  sm.own = sm.w + nb * IB_HBOX;
  sm.z[0] = sm.own + IB_OWN * IB_HBOX;
  sm.z[1] = sm.z[0] + IB_BOX;
  sm.y = sm.z[1] + IB_BOX;
  sm.h = sm.y + IB_BOX;
  sm.ids = sm.h + IB_HSTAGES * IB_HBOX;
  sm.bars = sm.ids + 2 * IB_IDS;
  return sm;
}

__device__ __forceinline__ uint32_t bar(const IbSmem& sm, int i) { return sm.bars + 8 * i; }

// Built with -DIB_TRACE (experiments/torch_iter_bwd.py --trace), the CTAs
// of the first cluster stamp the global timer (ns) at nine events of each of
// their first 64 halves: the G warps at a tile's loads landed (0), its mask
// done (1), a half begun (2), its node tasks done (3), its box done (4), the
// half buffer free (5), the pushes issued (6); the consumers at G whole (7)
// and the products done (8). The default build has no stamps
#ifdef IB_TRACE
__device__ long long ib_trace[8][64][9];
#define IB_STAMP(n, e)                                                     \
  do {                                                                     \
    if (blockIdx.x < 8 && (n) < 64) {                                      \
      long long t_;                                                        \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));               \
      ib_trace[blockIdx.x][n][e] = t_;                                     \
    }                                                                      \
  } while (0)
extern "C" int iter_bwd_trace(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, ib_trace, sizeof(ib_trace));
}
#else
#define IB_STAMP(n, e) \
  do {                 \
  } while (0)
#endif

// a wait that traps after IB_HANG cycles, so that a fault in the hand-over
// between the roles or the CTAs ends the launch with an error, not a hang;
// the clock is read once in 64 tries
template <bool CLUSTER = false>
__device__ __forceinline__ void ib_wait(uint32_t b, uint32_t parity) {
  const long long t0 = clock64();
  for (uint32_t i = 1;; ++i) {
    if (CLUSTER ? mbar_try_wait_cluster(b, parity) : mbar_try_wait(b, parity)) return;
    if (i % 64 == 0 && clock64() - t0 > IB_HANG) __trap();
  }
}

// rows [r0, r0 + rows) of a tile, of which the first `real` precede the
// padding; its halves with real rows, and the rows of G a half holds
// (rounded up to wgmma's K of 16: the rest of the half is never read)
struct IbTile {
  int r0, rows, real, halves;
  __device__ int g_rows(int h) const {
    return min(IB_HALF, ((real + 15) & ~15) - IB_HALF * h);
  }
};

__device__ __forceinline__ IbTile ib_bounds(int b0, int b1, int n_edges, int first_pad) {
  IbTile x;
  x.r0 = b0;
  x.rows = max(0, min(min(b1, n_edges) - b0, IB_ROWS));
  x.real = max(0, min(x.rows, first_pad - b0));
  x.halves = (x.real + IB_HALF - 1) / IB_HALF;
  return x;
}

__device__ __forceinline__ IbTile ib_tile(const int* __restrict__ tiles, int t, int n_edges,
                                          int first_pad) {
  return ib_bounds(__ldg(tiles + t), __ldg(tiles + t + 1), n_edges, first_pad);
}

// the cluster's next tile with real rows from tile t on (n_tiles if none)
__device__ __forceinline__ int ib_next(const int* __restrict__ tiles, int t, int step,
                                       int n_tiles, int n_edges, int first_pad, IbTile& x) {
  for (; t < n_tiles; t += step) {
    x = ib_tile(tiles, t, n_edges, first_pad);
    if (x.real > 0) break;
  }
  return t;
}

// byte offset of 16-byte chunk ch of row r in a 128-byte-swizzled box
__device__ __forceinline__ int sw(int r, int ch) { return r * 128 + ((ch ^ (r & 7)) << 4); }

// gz = g [y > 0] of two bf16 in a word, on their bits: y > 0 exactly where
// its bits lie in [0x0001, 0x7F80] (positive, +inf; not +-0, negative or
// NaN), and g passes whole or becomes +0. For every g but a NaN these are the
// bits of message_bwd.cu's mask4 and store4 (a select in f32, rounded back)
__device__ __forceinline__ uint32_t mask_word(uint32_t g, uint32_t y) {
  return g & __vcmpltu2(__vsub2(y, 0x00010001u), 0x7F807F80u);
}

__device__ __forceinline__ uint4 mask_chunk(uint4 g, uint4 y) {
  return make_uint4(mask_word(g.x, y.x), mask_word(g.y, y.y), mask_word(g.z, y.z),
                    mask_word(g.w, y.w));
}

__device__ __forceinline__ void add_chunk(float (&t)[8], uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack2(w[i]);
    t[2 * i] += f.x;
    t[2 * i + 1] += f.y;
  }
}

// ----------------------------------------------------------------- producer
// A tile's ids, IB_IDS bytes: per real row i its reverse in local rows (the
// row itself where the reverse is outside the tile), with IB_BAD on every row
// of a node whose in-edges or their reverses are not all in the tile (the
// rule of bwd_nodes.cu); at 128 the first row of each node of the tile, in
// order, and `real` after the last; at 260 the header: the nodes, the nodes
// that start before row 64, and those that start before row 65. Over a split
// table, in a tile with flagged rows, at IB_BASE the tile's first slot in G_c
// and from IB_SLOTS per row its slot less that one (tile_slots).
//
// The producer warp finds them with ballots over dst (a lane holds rows
// lane + 32 q): the rows of a node are contiguous, since dst is sorted.
struct IbIds {
  uint8_t rv[IB_ROWS / 32];
  uint32_t m[IB_ROWS / 32];  // the node starts, as ballots
};

__device__ __forceinline__ IbIds tile_ids(const int* __restrict__ dst, const int* __restrict__ rev,
                                          const IbTile& x, int n_edges) {
  constexpr int Q = IB_ROWS / 32;
  const int lane = threadIdx.x % 32, r0 = x.r0, real = x.real;
  IbIds o;
  int v[Q], rv[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = lane + 32 * q;
    v[q] = i < real ? __ldg(dst + r0 + i) : -1;
    rv[q] = i < real ? __ldg(rev + r0 + i) - r0 : 0;
  }
  const int before = r0 > 0 ? __ldg(dst + r0 - 1) : -1;
  const int after = r0 + real < n_edges ? __ldg(dst + r0 + real) : -1;
  uint32_t ob[Q];  // rows whose reverse is outside the tile
  int prev_last = -1;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    int up = __shfl_up_sync(~0u, v[q], 1);
    if (lane == 0) up = prev_last;
    prev_last = __shfl_sync(~0u, v[q], 31);
    const int i = lane + 32 * q;
    o.m[q] = __ballot_sync(~0u, i < real && (i == 0 || v[q] != up));
    ob[q] = __ballot_sync(~0u, i < real && (rv[q] < 0 || rv[q] >= real));
  }
  const int v_first = __shfl_sync(~0u, v[0], 0);
  int v_last = -1;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int src = (real - 1) - 32 * q;
    const int y = __shfl_sync(~0u, v[q], src >= 0 && src < 32 ? src : 0);
    if (src >= 0 && src < 32) v_last = y;
  }
  const bool bad_first = before >= 0 && before == v_first;
  const bool bad_last = after >= 0 && after == v_last;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = lane + 32 * q;
    const uint32_t le = (2u << lane) - 1;  // bits 0 .. lane
    o.rv[q] = 0;
    if (i >= real) continue;
    // the in-edge rows [lo, hi) of this row's node
    int lo = 0, hi = real;
    if (o.m[q] & le) {
      lo = 32 * q + 31 - __clz(o.m[q] & le);
    } else {
#pragma unroll
      for (int p = Q - 1; p >= 0; --p)
        if (p < q && lo == 0 && o.m[p] != 0) lo = 32 * p + 31 - __clz(o.m[p]);
    }
    if (o.m[q] & ~le) {
      hi = 32 * q + __ffs(o.m[q] & ~le) - 1;
    } else {
#pragma unroll
      for (int p = 0; p < Q; ++p)
        if (p > q && hi == real && o.m[p] != 0) hi = 32 * p + __ffs(o.m[p]) - 1;
    }
    const bool outside = rv[q] < 0 || rv[q] >= real;
    bool node_bad = false;
#pragma unroll
    for (int p = 0; p < Q; ++p) {
      const int a = max(lo - 32 * p, 0), b = min(hi - 32 * p, 32);
      if (a < b) node_bad |= ((ob[p] >> a) & (b - a == 32 ? ~0u : (1u << (b - a)) - 1)) != 0;
    }
    const bool bad = node_bad || (lo == 0 && bad_first) || (hi == real && bad_last);
    o.rv[q] = (uint8_t)(outside ? i : rv[q]) | (bad ? IB_BAD : 0);
  }
  return o;
}

// each lane's share of a tile's ids into a stage
__device__ __forceinline__ void write_ids(uint8_t* st, const IbIds& o, int real) {
  constexpr int Q = IB_ROWS / 32;
  const int lane = threadIdx.x % 32;
  int below = 0;  // node starts in the words before q
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = lane + 32 * q;
    if (i < real) st[i] = o.rv[q];
    if (o.m[q] >> lane & 1u) st[IB_ROWS + below + __popc(o.m[q] & ((1u << lane) - 1))] = (uint8_t)i;
    below += __popc(o.m[q]);
  }
  if (lane == 0) {
    const int lt64 = __popc(o.m[0]) + __popc(o.m[1]);
    st[IB_ROWS + below] = (uint8_t)real;
    st[260] = (uint8_t)below;
    st[261] = (uint8_t)lt64;
    st[262] = (uint8_t)(lt64 + (o.m[2] & 1u));
  }
}

// A tile's slots in G_c, over a split table (the map slot[] that the G_c
// launch wrote, slot[cross[w]] = w): per real row its slot less the tile's
// first, or IB_UNLISTED where cross[] does not hold the row at the map's
// entry (an entry the launch did not write, or a row the list does not hold)
struct IbSlots {
  uint8_t sl[IB_ROWS / 32];
  int base;
};

__device__ __forceinline__ IbSlots tile_slots(const int* __restrict__ slot,
                                              const int* __restrict__ cross, int n_cross,
                                              const IbTile& x) {
  constexpr int Q = IB_ROWS / 32;
  const int lane = threadIdx.x % 32;
  int k[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = lane + 32 * q;
    k[q] = i < x.real ? __ldg(slot + x.r0 + i) : -1;
  }
  int lo = INT_MAX;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = lane + 32 * q;
    const bool held = k[q] >= 0 && k[q] < n_cross && __ldg(cross + k[q]) == x.r0 + i;
    k[q] = held ? k[q] : -1;
    if (held) lo = min(lo, k[q]);
  }
  IbSlots o;
  o.base = __reduce_min_sync(~0u, lo);
#pragma unroll
  for (int q = 0; q < Q; ++q)
    o.sl[q] = k[q] >= 0 && k[q] - o.base < IB_UNLISTED ? (uint8_t)(k[q] - o.base) : IB_UNLISTED;
  return o;
}

// W's rows of this CTA's box once; then per tile with real rows its ids (and
// over a split table, where it holds flagged rows, its slots; both computed
// before the wait for a free stage), its g box into a stage and its y box,
// and per half its box of H into the ring, each as soon as its buffer is free
template <int NB>
__device__ void ib_produce(const CUtensorMap* tg, const CUtensorMap* ty, const CUtensorMap* th,
                           const CUtensorMap* tw,
                           const int* __restrict__ dst, const int* __restrict__ rev,
                           const int* __restrict__ tiles, const int* __restrict__ slot,
                           const int* __restrict__ cross, const IbSmem& sm, uint8_t* ids,
                           int rank, int n_edges, int first_pad, int n_tiles, int first, int step,
                           int n_cross) {
  const int lane = threadIdx.x % 32, c0 = 64 * rank;
  if (lane == 0) {
    tma_prefetch_map(tg);
    tma_prefetch_map(ty);
    tma_prefetch_map(th);
    tma_prefetch_map(tw);
    mbar_arrive_expect_tx(bar(sm, B_WFULL), NB * IB_HBOX);
    for (int kb = 0; kb < NB; ++kb)
      tma_load_2d(sm.w + kb * IB_HBOX, tw, bar(sm, B_WFULL), 64 * kb, c0);
  }
  IbTile x;
  int c = 0, n = 0;
  for (int tile = ib_next(tiles, first, step, n_tiles, n_edges, first_pad, x); tile < n_tiles;
       tile = ib_next(tiles, tile + step, step, n_tiles, n_edges, first_pad, x), ++c) {
    const int s = c & 1;
    const IbIds o = tile_ids(dst, rev, x, n_edges);
    bool flagged = false;
#pragma unroll
    for (int q = 0; q < IB_ROWS / 32; ++q) flagged |= (o.rv[q] & IB_BAD) != 0;
    flagged = n_cross > 0 && __any_sync(~0u, flagged);  // the same in every lane
    IbSlots sl;
    if (flagged) sl = tile_slots(slot, cross, n_cross, x);
    if (c >= 2) ib_wait(bar(sm, B_ZFREE + s), ((c >> 1) - 1) & 1);
    write_ids(ids + s * IB_IDS, o, x.real);
    if (flagged) {
      uint8_t* st = ids + s * IB_IDS;
#pragma unroll
      for (int q = 0; q < IB_ROWS / 32; ++q)
        if (lane + 32 * q < x.real) st[IB_SLOTS + lane + 32 * q] = sl.sl[q];
      if (lane == 0) *reinterpret_cast<int*>(st + IB_BASE) = sl.base;
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(bar(sm, B_ZFULL + s), IB_BOX);
      tma_load_2d(sm.z[s], tg, bar(sm, B_ZFULL + s), c0, x.r0);
      if (c >= 1) ib_wait(bar(sm, B_YFREE), (c - 1) & 1);
      mbar_arrive_expect_tx(bar(sm, B_YFULL), IB_BOX);
      tma_load_2d(sm.y, ty, bar(sm, B_YFULL), c0, x.r0);
      for (int h = 0; h < x.halves; ++h, ++n) {
        const int k = n % IB_HSTAGES;
        if (n >= IB_HSTAGES) ib_wait(bar(sm, B_HFREE + k), (n / IB_HSTAGES - 1) & 1);
        mbar_arrive_expect_tx(bar(sm, B_HFULL + k), IB_HBOX);
        tma_load_2d(sm.h + k * IB_HBOX, th, bar(sm, B_HFULL + k), c0, x.r0 + IB_HALF * h);
      }
    } else {
      mbar_arrive(bar(sm, B_ZFULL + s));  // each lane's ids are released by its arrival
      n += x.halves;
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------------ G warps
// chunk ch of row i of a tile's rows of this CTA's column box of T
__device__ __forceinline__ uint4* out_chunk(bf16* T, const IbTile& x, int i, int ch, int d,
                                            int c0) {
  return reinterpret_cast<uint4*>(T + (size_t)(x.r0 + i) * d + c0) + ch;
}

// the next tile with real rows from tile u on (n_tiles if none), with zeros
// out for the tiles of padding rows before it; u's bounds come from b0, b1
// where b0 >= 0 (loaded earlier)
__device__ __forceinline__ int g_next(const int* __restrict__ tiles, int u, int step, int n_tiles,
                                      int n_edges, int first_pad, int b0, int b1, IbTile& x,
                                      bf16* __restrict__ dH, bf16* __restrict__ gz_out, int d,
                                      int c0, int t) {
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (; u < n_tiles; u += step, b0 = -1) {
    x = b0 >= 0 ? ib_bounds(b0, b1, n_edges, first_pad) : ib_tile(tiles, u, n_edges, first_pad);
    if (x.real > 0) break;
    for (int task = t; task < x.rows * 8; task += IB_G_THREADS) {
      *out_chunk(gz_out, x, task >> 3, task & 7, d, c0) = zero4;
      *out_chunk(dH, x, task >> 3, task & 7, d, c0) = zero4;
    }
  }
  return u;
}

// gz's chunk ch at the reverse of row j, from the stage
__device__ __forceinline__ uint4 rev_chunk(const uint8_t* zs, const uint8_t* rvb, int j, int ch) {
  return *reinterpret_cast<const uint4*>(zs + sw(rvb[j] & 0x7F, ch));
}

// G's chunk ch of local row r of the own box: T less the row's reverse, rounded
__device__ __forceinline__ void put_g(uint8_t* ob, int r, int ch, const float (&T)[8], uint4 x4) {
  const uint32_t xw[4] = {x4.x, x4.y, x4.z, x4.w};
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 xr = unpack2(xw[q]);
    w[q] = pack2(T[2 * q] - xr.x, T[2 * q + 1] - xr.y);
  }
  *reinterpret_cast<uint4*>(ob + sw(r, ch)) = make_uint4(w[0], w[1], w[2], w[3]);
}

// per tile: gz in place over g, masked with y, and out; then per half its box
// of G from shared memory into an own box (a flagged row's from G_c over a
// split table), and, once every CTA of the cluster is done with the half
// buffer it goes to, copied into this CTA's and pushed from there into the
// others'. Tiles of padding rows: zeros out, no loads.
template <int NB>
__device__ void ib_form_g(const int* __restrict__ tiles, const bf16* __restrict__ Gc,
                          bf16* __restrict__ dH, bf16* __restrict__ gz_out, const IbSmem& sm,
                          uint8_t* smem, uint32_t smem_base, const uint8_t* ids, int rank, int d,
                          int n_edges, int first_pad, int n_tiles, int first, int step,
                          int n_cross) {
  const int t = threadIdx.x - IB_G0, lane = t % 32, c0 = 64 * rank;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  IbTile x, nx;
  int tile = g_next(tiles, first, step, n_tiles, n_edges, first_pad, -1, 0, x, dH, gz_out, d, c0, t);
  const uint8_t* ys = smem + (sm.y - smem_base);
  int c = 0, n = 0;
  for (; tile < n_tiles; ++c) {
    const int s = c & 1;
    uint8_t* zs = smem + (sm.z[s] - smem_base);
    // the next tile's bounds, in flight during the wait and the mask
    const int b0 = tile + step < n_tiles ? __ldg(tiles + tile + step) : -1;
    const int b1 = tile + step < n_tiles ? __ldg(tiles + tile + step + 1) : -1;
    ib_wait(bar(sm, B_ZFULL + s), (c >> 1) & 1);
    ib_wait(bar(sm, B_YFULL), c & 1);
    if (t == 0) IB_STAMP(n, 0);
#pragma unroll
    for (int m = 0; m < IB_MT; ++m) {
      const int task = t + IB_G_THREADS * m, i = task >> 3, ch = task & 7, off = sw(i, ch);
      if (i >= x.rows) continue;
      uint4 z = zero4;
      if (i < x.real) {
        z = mask_chunk(*reinterpret_cast<const uint4*>(zs + off),
                       *reinterpret_cast<const uint4*>(ys + off));
        *reinterpret_cast<uint4*>(zs + off) = z;
      }
      *out_chunk(gz_out, x, i, ch, d, c0) = z;
      if (i >= IB_HALF * x.halves) *out_chunk(dH, x, i, ch, d, c0) = zero4;  // no half holds it
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(sm, B_YFREE));
    if (t == 0) IB_STAMP(n, 1);
    const int tile_next = g_next(tiles, tile + step, step, n_tiles, n_edges, first_pad, b0, b1, nx,
                                 dH, gz_out, d, c0, t);
    asm volatile("bar.sync 3, %0;" ::"n"(IB_G_THREADS) : "memory");  // the tile's gz is in the stage
    const uint8_t* rvb = ids + s * IB_IDS;  // per row its reverse (and IB_BAD)
    const uint8_t* starts = rvb + IB_ROWS;  // per node its first row
    const int n_nodes = rvb[260], n_lt64 = rvb[261], n_le64 = rvb[262];
    for (int h = 0; h < x.halves; ++h, ++n) {
      if (t == 0) IB_STAMP(n, 2);
      const int b = n & 1, rows_g = x.g_rows(h), a = IB_HALF * h;
      const int real_end = min(x.real, a + IB_HALF);
      const uint32_t own = sm.own + (n % IB_OWN) * IB_HBOX;
      uint8_t* ob = smem + (own - smem_base);
      // the nodes with rows in the half: T[v] once, over its in-edges in
      // their order, then each of its rows in the half, less its reverse
      const int k0 = h == 0 ? 0 : n_le64 - 1, k1 = h == 0 ? n_lt64 : n_nodes;
      for (int task = t; task < (k1 - k0) * 8; task += IB_G_THREADS) {
        const int k = k0 + (task >> 3), ch = task & 7;
        const int st = starts[k], en = starts[k + 1];
        const int lo = max(st, a), hi = min(en, real_end);
        if (rvb[st] & IB_BAD) {  // G_c's row where the cross list holds it, else NaN
          const uint4 nan4 = make_uint4(0x7FC07FC0u, 0x7FC07FC0u, 0x7FC07FC0u, 0x7FC07FC0u);
          const int base = n_cross > 0 ? *reinterpret_cast<const int*>(rvb + IB_BASE) : 0;
#pragma unroll 4
          for (int j = lo; j < hi; ++j) {
            const int slot = n_cross > 0 ? rvb[IB_SLOTS + j] : IB_UNLISTED;
            *reinterpret_cast<uint4*>(ob + sw(j - a, ch)) =
                slot == IB_UNLISTED
                    ? nan4
                    : __ldg(reinterpret_cast<const uint4*>(Gc + (size_t)(base + slot) * d + c0) + ch);
          }
          continue;
        }
        // most atoms have at most four neighbours: their chunks loaded at once
        uint4 v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = st + q < en ? rev_chunk(zs, rvb, st + q, ch) : zero4;
        float T[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (st + q < en) add_chunk(T, v[q]);
        for (int j = st + 4; j < en; ++j) add_chunk(T, rev_chunk(zs, rvb, j, ch));
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (st + q >= lo && st + q < hi) put_g(ob, st + q - a, ch, T, v[q]);
        for (int j = max(lo, st + 4); j < hi; ++j) put_g(ob, j - a, ch, T, rev_chunk(zs, rvb, j, ch));
      }
      if (t == 0) IB_STAMP(n, 3);
      // rows past the real ones up to wgmma's K: zeros
      for (int task = t; task < (a + rows_g - real_end) * 8; task += IB_G_THREADS)
        *reinterpret_cast<uint4*>(ob + sw(real_end - a + (task >> 3), task & 7)) = zero4;
      // H's rows of the half that are padding rows never reach dW: they meet
      // zero rows of G, and are zeroed too, should they not be finite
      if (x.r0 + IB_HALF * (h + 1) > first_pad) {
        const int k = n % IB_HSTAGES;
        ib_wait(bar(sm, B_HFULL + k), (n / IB_HSTAGES) & 1);
        uint8_t* hs = smem + (sm.h + k * IB_HBOX - smem_base);
        for (int task = t; task < IB_HALF * 8; task += IB_G_THREADS)
          if (x.r0 + IB_HALF * h + (task >> 3) >= first_pad)
            *reinterpret_cast<uint4*>(hs + task * 16) = zero4;
      }
      if (t == 0) IB_STAMP(n, 4);
      // the half buffer is free in every CTA once all have multiplied with
      // the half before the last
      if (t == 0 && n >= 2) ib_wait<true>(bar(sm, B_GFREE + b), ((n >> 1) - 1) & 1);
      asm volatile("bar.sync 3, %0;" ::"n"(IB_G_THREADS) : "memory");
      if (t == 0) IB_STAMP(n, 5);
      // the own box into this CTA's half buffer; it then goes to the async
      // proxy (wgmma, and the pushes that read it), as do the stage's gz and
      // H's zeros (the TMA that refills them)
      const uint32_t bytes = rows_g * 128, dst = sm.g[b] + rank * IB_HBOX;
      uint8_t* gdst = smem + (dst - smem_base);
      for (int task = t; task < rows_g * 8; task += IB_G_THREADS)
        *reinterpret_cast<uint4*>(gdst + 16 * task) = *reinterpret_cast<const uint4*>(ob + 16 * task);
      fence_proxy_async();
      asm volatile("bar.sync 3, %0;" ::"n"(IB_G_THREADS) : "memory");
      if (t < 32) {  // one lane per other CTA: the pushes go out at once
        const uint32_t full = bar(sm, B_GFULL + b);
        if (t == 0) mbar_arrive_expect_tx(full, (NB - 1) * bytes);  // the other CTAs' boxes
        if (t >= 1 && t < NB) {
          const uint32_t q = (rank + t) % NB;
          bulk_copy_cluster(cluster_map(dst, q), dst, bytes, cluster_map(full, q));
        }
      }
      if (t == 0) IB_STAMP(n, 6);
    }
    if (lane == 0) mbar_arrive(bar(sm, B_ZFREE + s));
    tile = tile_next;
    x = nx;
  }
}

// -------------------------------------------------------------- consumers
// a half of a tile: its rows, and which half
struct IbHalf {
  int r0, rows, real, h;
};

// dH's rows of half y.h, columns c0 + 8 j (+ 7) for blocks j of J0 .. J0 + 3,
// from warpgroup 0's [64 x 64] accumulator: rows 16 (t / 32) + (t % 32) / 4
// (+ 8) of the half, where lane q = t % 4 of each quad holds columns
// 8 j + 2 q (+ 1); a transpose inside the quad gives it block J0 + q's eight
// columns, one 16-byte store a row. Rows past the real ones (padding rows
// of the tile) get zeros.
template <int J0>
__device__ __forceinline__ void store_dh(bf16* __restrict__ dH, const float (&acc)[32],
                                         const IbHalf& y, int d, int c0) {
  const int t = threadIdx.x % 128, q = t & 3, quad = (t % 32) & ~3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    uint32_t v[4], o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = pack2(acc[4 * (J0 + j) + 2 * hh], acc[4 * (J0 + j) + 2 * hh + 1]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // lane s sends its word of block (s - r) % 4; lane q takes lane
      // (q + r) % 4's, its word of block q
      const int js = (q - r) & 3;
      const uint32_t send = js == 0 ? v[0] : js == 1 ? v[1] : js == 2 ? v[2] : v[3];
      const uint32_t got = __shfl_sync(~0u, send, quad | ((q + r) & 3));
      const int src = (q + r) & 3;
#pragma unroll
      for (int u = 0; u < 4; ++u) o[u] = src == u ? got : o[u];
    }
    const int i = IB_HALF * y.h + 16 * (t / 32) + (t % 32) / 4 + 8 * hh;
    if (i < y.rows)
      *reinterpret_cast<uint4*>(dH + (size_t)(y.r0 + i) * d + c0 + 8 * (J0 + q)) =
          i < y.real ? make_uint4(o[0], o[1], o[2], o[3]) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// warpgroup w (0, 1), per half of a tile: dW's rows of this CTA's box in
// columns [w d / 2, (w + 1) d / 2) (K over the half's rows, from H's half and
// G's), and, in warpgroup 0 alone, dH's 64 rows in the 64 columns of the box
// (K over all d columns of G), both on wgmma from shared memory, so that each
// operand is read once; then the barriers, then dH out. At the end its dW
// slice into the cluster's partial.
template <int NB>
__device__ void ib_consume(const int* __restrict__ tiles, bf16* __restrict__ dH,
                           float* __restrict__ partial, const IbSmem& sm, int rank, int d,
                           int n_edges, int first_pad, int n_tiles, int first, int step) {
  constexpr int NW = 32 * NB;  // dW columns of this warpgroup
  const int w = __shfl_sync(~0u, (int)threadIdx.x / 128, 0), t = threadIdx.x % 128;
  const int c0 = 64 * rank;
  float acc_w[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc_w[i] = 0.f;
  float acc_h[32];
  ib_wait(bar(sm, B_WFULL), 0);
  IbTile x;
  int n = 0;
  // tile bounds are the same in every lane; a shuffle tells the compiler so
  for (int tile = __shfl_sync(~0u, ib_next(tiles, first, step, n_tiles, n_edges, first_pad, x), 0);
       tile < n_tiles;
       tile = __shfl_sync(~0u, ib_next(tiles, tile + step, step, n_tiles, n_edges, first_pad, x), 0)) {
    const int halves = __shfl_sync(~0u, x.halves, 0), real16 = __shfl_sync(~0u, (x.real + 15) & ~15, 0);
    for (int h = 0; h < halves; ++h, ++n) {
      const int b = n & 1, k = n % IB_HSTAGES;
      const uint32_t gb = sm.g[b], hs = sm.h + k * IB_HBOX;
      const uint32_t g_cols = gb + w * (NB / 2) * IB_HBOX;  // dW's B: G's columns w d / 2 ..
      const int kc = min(IB_HALF, real16 - IB_HALF * h) / 16;  // G's rows past these are zero
      ib_wait(bar(sm, B_HFULL + k), (n / IB_HSTAGES) & 1);
      ib_wait<true>(bar(sm, B_GFULL + b), (n >> 1) & 1);
      if (threadIdx.x == 0) IB_STAMP(n, 7);
      wgmma_fence();
      if (w == 0) {
#pragma unroll
        for (int kb = 0; kb < NB; ++kb)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_kk_m64n64k16(acc_h, desc_k_sw128(gb + kb * IB_HBOX + 32 * kk),
                               desc_k_sw128(sm.w + kb * IB_HBOX + 32 * kk), kb + kk > 0);
      }
      for (int kk = 0; kk < kc; ++kk) {
        const uint64_t a = desc_mn_sw128(hs + kk * 2048, IB_HBOX, 1024);
        const uint64_t bd = desc_mn_sw128(g_cols + kk * 2048, IB_HBOX, 1024);
        if constexpr (NW == 192) wgmma_m64n192k16(acc_w, a, bd);
        else if constexpr (NW == 128) wgmma_m64n128k16(acc_w, a, bd);
        else wgmma_m64n64k16(acc_w, a, bd);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (threadIdx.x == 0) IB_STAMP(n, 8);
      // both warpgroups are done with the half: H's stage goes back, and one
      // lane per CTA of the cluster tells that CTA, all at once (one thread
      // arriving CTA after CTA was far slower)
      asm volatile("bar.sync 1, 256;" ::: "memory");
      if (threadIdx.x == 0) mbar_arrive(bar(sm, B_HFREE + k));
      if (threadIdx.x < NB) mbar_arrive_cluster(cluster_map(bar(sm, B_GFREE + b), threadIdx.x));
      if (w == 0) {
        const IbHalf y = {x.r0, x.rows, x.real, h};
        store_dh<0>(dH, acc_h, y, d, c0);
        store_dh<4>(dH, acc_h, y, d, c0);
      }
    }
  }
  float* tile_out = partial + ((size_t)cluster_index() * d + c0) * d + w * NW + 2 * (t % 4);
  const int row = 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    *reinterpret_cast<float2*>(tile_out + (size_t)row * d + 8 * j) =
        make_float2(acc_w[4 * j], acc_w[4 * j + 1]);
    *reinterpret_cast<float2*>(tile_out + (size_t)(row + 8) * d + 8 * j) =
        make_float2(acc_w[4 * j + 2], acc_w[4 * j + 3]);
  }
}

// cluster c takes tiles c, c + clusters, ...; CTA s of it owns column box s
template <int NB>
__global__ void __launch_bounds__(IB_THREADS, 1)
    iter_bwd_kernel(const __grid_constant__ CUtensorMap tg, const __grid_constant__ CUtensorMap ty,
                    const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tw,
                    const int* __restrict__ dst, const int* __restrict__ rev,
                    const int* __restrict__ ptr, const int* __restrict__ tiles,
                    const bf16* __restrict__ Gc, const int* __restrict__ slot,
                    const int* __restrict__ cross, bf16* __restrict__ dH, bf16* __restrict__ gz,
                    float* __restrict__ partial, int n_edges, int d, int pad_node, int n_tiles,
                    int n_cross) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023) & ~1023u;
  const IbSmem sm = ib_layout(base, NB);
  const int rank = (int)cluster_rank(), first = (int)cluster_index(), step = (int)cluster_count();
  const int first_pad = __ldg(ptr + pad_node);
  uint8_t* ids = smem_raw + (sm.ids - raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar(sm, B_ZFULL + s), 32);  // the producer's lanes, and the box's bytes
      mbar_init(bar(sm, B_ZFREE + s), IB_G_THREADS / 32);  // one per G warp
      mbar_init(bar(sm, B_GFULL + s), 1);       // the G warps, and the other CTAs' bytes
      mbar_init(bar(sm, B_GFREE + s), NB);  // each CTA of the cluster
    }
    for (int k = 0; k < IB_HSTAGES; ++k) {
      mbar_init(bar(sm, B_HFULL + k), 1);
      mbar_init(bar(sm, B_HFREE + k), 1);
    }
    mbar_init(bar(sm, B_YFULL), 1);
    mbar_init(bar(sm, B_YFREE), IB_G_THREADS / 32);  // one per G warp
    mbar_init(bar(sm, B_WFULL), 1);
    mbar_fence_init();
  }
  cluster_sync();  // every CTA's barriers exist before any other CTA signals them
  // the role from a warp-uniform value (a shuffle), so that the compiler
  // sees no divergent path around the consumers' wgmma; the consumers' dW
  // and dH accumulators take most of the registers
  const int warp = __shfl_sync(~0u, (int)threadIdx.x / 32, 0);
  if (warp < IB_G0 / 32) {
    setmaxnreg_inc<IB_REGS_CONSUMER>();
    ib_consume<NB>(tiles, dH, partial, sm, rank, d, n_edges, first_pad, n_tiles, first, step);
  } else {
    setmaxnreg_dec<IB_REGS_OTHER>();
    if (warp < IB_PRODUCER0 / 32)
      ib_form_g<NB>(tiles, Gc, dH, gz, sm, smem_raw, raw, ids, rank, d, n_edges, first_pad,
                    n_tiles, first, step, n_cross);
    else
      ib_produce<NB>(&tg, &ty, &th, &tw, dst, rev, tiles, slot, cross, sm, ids, rank, n_edges,
                     first_pad, n_tiles, first, step, n_cross);
  }
  cluster_sync();  // no CTA leaves while another may still reach its shared memory
}

// dW = the clusters' partials added in the order of the clusters
__global__ void iter_bwd_reduce(const float* __restrict__ partial, float* __restrict__ out,
                                int clusters, int size) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= size) return;
  float4 acc = load4(partial + i);
  for (int c = 1; c < clusters; ++c) add4(acc, load4(partial + (size_t)c * size + i));
  store4(out + i, acc);
}

// ---------------------------------------------------------------------- host
template <int NB>
static cudaError_t ib_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int clusters,
                             cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(clusters * NB);
  cfg->blockDim = dim3(IB_THREADS);
  cfg->dynamicSmemBytes = ib_smem_bytes(NB);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = NB;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  // the opt-in above 48 KB is per device and per size, so it is made at every launch (cheap)
  return cudaFuncSetAttribute(iter_bwd_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              ib_smem_bytes(NB));
}

// the clusters the card runs at once, asked once
template <int NB>
static int ib_max_clusters() {
  static int n = -1;
  if (n < 0) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int c = 0;
    if (ib_config<NB>(&cfg, &attr, 1, nullptr) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&c, (void*)iter_bwd_kernel<NB>, &cfg) != cudaSuccess)
      c = 0;
    n = c;
  }
  return n;
}

static int ib_boxes(int d) {
  return (d == 128 || d == 256 || d == 384) && ib_smem_bytes(d / 64) <= IB_SMEM_MAX ? d / 64 : 0;
}

static int ib_clusters_for(int nb) {
  switch (nb) {
    case 2: return ib_max_clusters<2>();
    case 4: return ib_max_clusters<4>();
    case 6: return ib_max_clusters<6>();
  }
  return 0;
}

template <int NB>
static cudaError_t ib_launch(const CUtensorMap* maps, const int* dst, const int* rev,
                             const int* ptr, const int* tiles, const void* Gc, const int* slot,
                             const int* cross, void* dH, void* gz, float* partial, int n_edges,
                             int d, int pad_node, int n_tiles, int clusters, int n_cross,
                             cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = ib_config<NB>(&cfg, &attr, clusters, stream);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, iter_bwd_kernel<NB>, maps[0], maps[1], maps[2], maps[3],
                            dst, rev, ptr, tiles, (const bf16*)Gc, slot, cross, (bf16*)dH,
                            (bf16*)gz, partial, n_edges, d, pad_node, n_tiles, n_cross);
}

// the clusters a launch at width d over n_tiles tiles takes (the partials the
// caller allocates, d * d floats each), or 0 where the width is not taken or
// no cluster fits the card
extern "C" int iter_bwd_clusters(int d, int n_tiles) {
  const int nb = ib_boxes(d);
  if (nb == 0 || n_tiles < 1) return 0;
  const int n = ib_clusters_for(nb);
  return n < n_tiles ? n : n_tiles;
}

// (dH, gz, dW) from g, y, H [n_edges x d] and W [d x d] bfloat16 ((in, out)
// layout; rows 16-byte aligned), d one of 128, 256, 384, over a tile table of
// n_tiles tiles (ascending row offsets from 0 to n_edges, at most 128 rows
// each, no molecule in two tiles); partial holds clusters * d * d floats,
// clusters from iter_bwd_clusters. Over a split tile table n_cross > 0: the
// cross list (n_cross rows, ascending), G_c ([n_cross x d] bf16, their G in
// the list's order) and the map slot ([n_edges] int32), as iter_bwd_rows of
// message_bwd.cu writes them on the same stream before this launch
extern "C" int iter_bwd_tiles(const void* g, const void* y, const void* H, const void* W,
                              const int* dst, const int* rev, const int* ptr, const int* tiles,
                              const void* Gc, const int* slot, const int* cross, void* dH,
                              void* gz, float* partial, float* dW, int n_edges, int d,
                              int pad_node, int n_tiles, int clusters, int n_cross,
                              cudaStream_t stream) {
  const int nb = ib_boxes(d);
  if (nb == 0 || n_edges < 0 || tiles == nullptr || n_tiles < 1 || clusters < 1 ||
      n_cross < 0 || (n_cross > 0 && (Gc == nullptr || slot == nullptr || cross == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n_edges == 0) return (int)cudaMemsetAsync(dW, 0, (size_t)d * d * sizeof(float), stream);
  CUtensorMap maps[4];  // g and y in [128 x 64] boxes; H and W in [64 x 64] boxes
  if (!bf16_table_map(&maps[0], g, n_edges, d, IB_ROWS) ||
      !bf16_table_map(&maps[1], y, n_edges, d, IB_ROWS) ||
      !bf16_table_map(&maps[2], H, n_edges, d, IB_HALF) || !bf16_table_map(&maps[3], W, d, d, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  switch (nb) {
    case 2: err = ib_launch<2>(maps, dst, rev, ptr, tiles, Gc, slot, cross, dH, gz, partial, n_edges, d, pad_node, n_tiles, clusters, n_cross, stream); break;
    case 4: err = ib_launch<4>(maps, dst, rev, ptr, tiles, Gc, slot, cross, dH, gz, partial, n_edges, d, pad_node, n_tiles, clusters, n_cross, stream); break;
    case 6: err = ib_launch<6>(maps, dst, rev, ptr, tiles, Gc, slot, cross, dH, gz, partial, n_edges, d, pad_node, n_tiles, clusters, n_cross, stream); break;
  }
  if (err != cudaSuccess) return (int)err;
  // dW = the clusters' partials added in the order of the clusters
  const int size = d * d;
  iter_bwd_reduce<<<(size / 4 + 255) / 256, 256, 0, stream>>>(partial, dW, clusters, size);
  return (int)cudaGetLastError();
}

// the launch's shape at width d over n_tiles tiles, into info[0..3]: CTAs
// per cluster (d / 64 column boxes), shared-memory bytes per CTA, clusters
// of the grid, and clusters the card runs at once
extern "C" int iter_bwd_info(int d, int n_tiles, int* info) {
  const int nb = ib_boxes(d);
  if (nb == 0 || n_tiles < 1) return (int)cudaErrorInvalidValue;
  info[0] = nb;
  info[1] = ib_smem_bytes(nb);
  info[2] = iter_bwd_clusters(d, n_tiles);
  info[3] = ib_clusters_for(nb);
  return info[3] > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}
