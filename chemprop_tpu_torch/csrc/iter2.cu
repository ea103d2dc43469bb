// The first two depth iterations of the D-MPNN in one launch, redesigned for
// Hopper:
//
//   y1 = relu(H0 + bf16(M(relu(H0))) @ W [+ b]),
//   y2 = relu(H0 + bf16(M(y1)) @ W [+ b]),
//   M(H)[e] = sum_{k : dst[k] == src[e]} H[k] - H[rev[e]]
//
// for bf16 [E x d] tables and W [d x d] ((in, out) layout), with f32 sums,
// each message rounded to bf16 once before its product, and padding edges
// given a zero message (their rows are relu(H0 [+ b])). y1 and y2 equal two
// launches of fused_iter.cu (kernel B) bit for bit on every row, and every run
// gives the same bits.
//
// iter2 replaces the Pallas TPU kernel _iter2_kernel of
// chemprop_tpu/ops/fused_message.py (launched by _iter2_impl), which keeps a
// tile of whole molecules in VMEM and forms both iterations' messages there.
//
// It is bound by bytes: H0 read and y1, y2 written once are three edge tables
// (284 MB at [123,392 x 384]: 85 us at 3.35 TB/s; chip_smoke.fused_iter2_bytes
// counts them with W and the ids), against 71 GFLOP of products (72 us at the
// bf16 tensor peak). Two launches of B move six such tables, and each of B's
// two CTAs per 64-row tile gathers every message row again from device
// memory, a row of H per in-edge. The collate's tile table
// (BatchMolGraph.tile_ptr: tiles of at most 128 rows, no molecule in two) is
// what the TPU kernel has: every row a tile's message reads lies in the tile.
// So:
//
// * The tile in shared memory. A cluster has d / 128 CTAs (three at d = 384),
//   CTA s holding W's columns [128 s, 128 s + 128) resident (loaded once by
//   TMA). Of each tile's d / 64 blocks of 64 K columns, CTA s forms two, K
//   blocks s and s + d / 128: eight gather warps copy the block's rows of H0
//   (iteration 1) or y1 (iteration 2) into a staging buffer by cp.async (the
//   next block's copies in flight while this one forms; in iteration 1 each
//   thread then applies the ReLU to its own chunks in place, once per value),
//   and form the block's 128 message rows from shared memory: the in-edges
//   of a row's source summed in f32 in the order of the edges, less the
//   reverse edge, rounded once to bf16, into two stages (the tile's 64-row
//   halves, swizzled as B's) of a ring that every CTA of the cluster holds in
//   the same order. One bulk copy per other CTA sends both stages there,
//   counted on that CTA's full barrier of the pair. A row whose in-edges or
//   reverse edge leave its tile (a table that cuts a molecule) gets NaN. Over
//   a split table (BatchMolGraph.split_ptr) those are the collate's y1_rows,
//   and the y2_rows read them; the row pass of fused_iter.cu
//   (fused_iter_rows, B's own code) forms both lists again after the launch,
//   y1's first (ops.message.fused_iter2).
// * Two consumer warpgroups, one per half, multiply every stage of their
//   half, in the order of K, with the resident W slice on wgmma (A in
//   registers), add H0 (brought in by TMA while the product runs), the bias
//   and the ReLU in f32 from registers, and write y in whole 128-byte rows;
//   each stage goes back (a relaxed arrival: its reads are done, and a
//   release would wait for the warpgroup's stores to land) to the CTA that
//   forms the next stage of its slot. The product and its order of K are
//   B's (product_stage in fused_iter.cu), the epilogue is B's own
//   (fused_iter.cuh).
// * Iteration 2 of a tile needs y1 at every column of the tile, written by
//   every CTA of the cluster. After each iteration-1 tile, each consumer
//   warpgroup, past a barrier of its threads that orders their y1 stores
//   before it, stores its count of tiles done into a word of every CTA's
//   shared memory (st.release.cluster, one lane per CTA);
//   the gather warps read the words with ld.acquire.cluster before they copy
//   y1 (from L2, where it has just been written). Monotone counts cannot
//   alias, as reused barrier phases can. The clusters walk contiguous runs of
//   tiles; the walk issues iteration 2 of a tile `lag` tiles after its
//   iteration 1 (the ring's depth and two more), so that nobody waits:
//   meanwhile the gather warps form later tiles' iteration-1 blocks, whose
//   input is H0 alone. A warpgroup publishes a tile at the next tile's
//   epilogue (the release then finds the stores landed), unless the next
//   item needs it.
// * The same bits as B: every message row's sum is B's, the same values in
//   the same order (a missing in-edge adds +0 and the reverse edge is
//   subtracted directly: a sum that starts at +0 is never -0, so neither
//   changes a bit), and the product sums the same bf16 values in the same
//   order of K on wgmma m64nNk16 (N = 128 here, B's fi_width there, which
//   does not change an element's sum: the card checks every row). Rows past
//   the tile's end are not written.
//
// Widths: d = 128, 256, 384 and 512 (clusters of 1 to 4 CTAs; the W slice,
// two H0 halves, two staging buffers and the ring fill a CTA's shared memory
// at d = 512). The wrapper refuses a wider width before any launch, and
// loop_readout then takes two fused_iter launches (ops.message.ITER2_WIDTHS).
#include "fused_iter.cuh"

constexpr int I2_N = 128;                   // a CTA's slice of W's columns
constexpr int I2_NB = I2_N / 64;            // its 64-column boxes
constexpr int I2_TILE = 2 * FI_ROWS;        // the most rows a tile holds
constexpr int I2_STAGE_BYTES = I2_TILE * 128;  // a staging buffer: a tile's rows, 64 columns
constexpr int I2_H0_BYTES = I2_NB * FI_BOX;    // a half's H0 slice
constexpr int I2_GATHER = 256;              // eight gather warps
constexpr int I2_THREADS = 256 + I2_GATHER;  // and two consumer warpgroups
constexpr int I2_RSTEP = I2_GATHER / 8;     // a gather thread's rows: u / 8 + I2_RSTEP i
constexpr int I2_ROWS = (I2_TILE + I2_RSTEP - 1) / I2_RSTEP;  // rows a gather thread forms
constexpr int I2_MAX_STAGES = 16;
constexpr int I2_MAX_CLUSTER = 4;           // d <= 512
constexpr int I2_WORDS = 2 * I2_MAX_CLUSTER;  // progress words: one per consumer warpgroup
constexpr int I2_SMEM_MAX = 232448;         // a block's shared memory on sm_90
constexpr long long I2_HANG = 1ll << 35;    // clock cycles (~17 s) after which a wait traps
constexpr uint32_t I2_NAN2 = 0x7FC07FC0u;   // two bf16 NaNs

// a word of a CTA of the cluster (an address from cluster_map), released
__device__ __forceinline__ void st_release_cluster(uint32_t addr, uint32_t v) {
  asm volatile("st.release.cluster.shared::cluster.u32 [%0], %1;" ::"r"(addr), "r"(v)
               : "memory");
}

// a word of this CTA's shared memory, acquired at cluster scope
__device__ __forceinline__ uint32_t ld_acquire_cluster(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.acquire.cluster.shared::cta.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// the 8 bf16 of a 16-byte chunk added into (subtracted from) 8 f32 sums: a
// bf16 is the top half of its f32, so each is one shift or mask. The same
// values and order as add8 in fused_iter.cu (B's gather subtracts the
// reverse edge's row as 0 + x, which has the same bits as x here: a sum that
// is never -0)
__device__ __forceinline__ void i2_add8(float (&acc)[8], const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] += __uint_as_float(w[i] << 16);
    acc[2 * i + 1] += __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void i2_sub8(float (&acc)[8], const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] -= __uint_as_float(w[i] << 16);
    acc[2 * i + 1] -= __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// 16 bytes of global memory into shared memory, asynchronously and through
// L2 only (cp.async.cg), in this thread's current group
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

// this thread's copies so far landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// arrive on a barrier of a CTA of the cluster (an address from cluster_map),
// expecting `bytes` more to land in this phase; relaxed: the bytes' own
// completion orders them
__device__ __forceinline__ void mbar_arrive_expect_tx_cluster(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.relaxed.cluster.shared::cluster.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// arrive on a barrier of a CTA of the cluster without ordering this thread's
// earlier memory accesses (a release would wait for its stores to land)
__device__ __forceinline__ void mbar_arrive_relaxed_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// a wait on a barrier that other CTAs of the cluster complete
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait_cluster(bar, parity)) {
  }
}

// the 128 threads of consumer warpgroup wg (barriers 1, 2), or the gather
// warps (barrier 3)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void gather_sync() {
  asm volatile("bar.sync 3, %0;" ::"n"(I2_GATHER) : "memory");
}

// whether any gather thread holds p, in every gather thread (a barrier of
// the gather warps that reduces their predicates)
__device__ __forceinline__ bool gather_any(bool p) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred q, a;\n"
      "setp.ne.u32 q, %1, 0;\n"
      "bar.red.or.pred a, 3, %2, q;\n"
      "selp.u32 %0, 1, 0, a;\n}\n"
      : "=r"(r)
      : "r"((uint32_t)p), "n"(I2_GATHER)
      : "memory");
  return r != 0;
}

struct I2Smem {
  Smem sm;  // W slice, H0 halves, ring, full and empty barriers, W's barrier, H0's (two)
  uint32_t stage, prog;
};

// ------------------------------------------------------------------ the walk
// Cluster c takes tiles [n_tiles c / C, n_tiles (c + 1) / C); both roles walk
// them in one order: iteration 1 of each tile in turn, and iteration 2 of a
// tile once `lag` more tiles have had their iteration 1, or once there are
// none left (an empty tile passes through as a tile without rows). `ord`
// counts the items of each iteration: item `ord` is tile t0 + ord.
struct I2Item {
  int it, tile, ord;  // it 0: the walk is done
};

struct I2Walk {
  int t1, t2, end, n1, n2, lag;  // next tiles of iterations 1 and 2, their counts
};

__device__ __forceinline__ I2Walk i2_walk(int n_tiles, int lag) {
  const int c = (int)cluster_index(), n = (int)cluster_count();
  const int t0 = (int)((long long)n_tiles * c / n), end = (int)((long long)n_tiles * (c + 1) / n);
  return {t0, t0, end, 0, 0, lag};
}

__device__ __forceinline__ I2Item i2_next(I2Walk& w) {
  if (w.n2 < w.n1 && (w.t1 == w.end || w.n1 >= w.n2 + 1 + w.lag)) return {2, w.t2++, w.n2++};
  if (w.t1 < w.end) return {1, w.t1++, w.n1++};
  return {0, 0, 0};
}

// a tile's rows [r0, r1), at most I2_TILE of them
struct I2Rows {
  int r0, r1;
};

__device__ __forceinline__ I2Rows i2_clamp(int r0, int r1, int n_edges) {
  return {r0, min(min(r1, n_edges), r0 + I2_TILE)};
}

__device__ __forceinline__ I2Rows i2_rows(const int* __restrict__ tiles, const I2Item& x,
                                          int n_edges) {
  if (x.it == 0) return {0, 0};
  return i2_clamp(__ldg(tiles + x.tile), __ldg(tiles + x.tile + 1), n_edges);
}

// product_stage of fused_iter.cu for a ring that every CTA of the cluster
// fills: stage slot s in its round's phase `parity`, the full barrier (the
// even slot's: a K block's two stages share it) waited on with the cluster's
// acquire, and the stage given back to CTA `former`, which forms the slot's
// next stage
__device__ __forceinline__ void i2_product_stage(float (&acc)[I2_N / 2], uint32_t (&a)[4][4],
                                                 const Smem& sm, int s, uint32_t parity, int kb,
                                                 int former, int t) {
  const int lane = t % 32;
  const int row = 16 * (t / 32) + lane % 16;
  mbar_wait_cluster(sm.full + 8 * (s & ~1), parity);
  const uint32_t stage = sm.ring + s * FI_BOX + row * 128;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(a[kk], stage + (((2 * kk + lane / 16) ^ (row % 8)) << 4));
  __syncwarp();
  if (lane == 0)  // relaxed: its reads are done, and its y stores need not be
    mbar_arrive_relaxed_cluster(cluster_map(sm.empty + 8 * s, former));
  const uint32_t bw = sm.w + kb * I2_NB * FI_BOX;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rmn<I2_N>(acc, a[kk], desc_mn_sw128(bw + 2048 * kk, FI_BOX, 1024), kb + kk > 0);
  wgmma_commit();
  wgmma_wait<1>();
}

// -------------------------------------------------------------- consumers
// consumer warpgroup wg: the product of its half of every tile of the walk
// with the resident W slice, then y = relu(H0 + z [+ b]) into y1 or y2, with
// the half's H0 slice brought in by TMA meanwhile; after an iteration-1 tile,
// its count of them published to every CTA of the cluster
__device__ __forceinline__ void i2_consume(const CUtensorMap* th0, const bf16* __restrict__ b,
                                           bf16* y1, bf16* y2, const I2Smem& s,
                                           uint8_t* smem_raw, const int* __restrict__ tiles,
                                           int n_edges, int n_tiles, int d, int n0, int rank,
                                           int slices, int n_stages, int lag, int wg) {
  const int t = threadIdx.x % 128, nk = d / 64;
  const uint32_t h0 = s.sm.h0 + wg * I2_H0_BYTES, h0bar = s.sm.h0bar + 8 * wg;
  uint8_t* h0_ptr = smem_raw + (h0 - smem_addr(smem_raw));
  auto load_h0 = [&](int r0) {
    mbar_arrive_expect_tx(h0bar, I2_H0_BYTES);
#pragma unroll
    for (int j = 0; j < I2_NB; ++j)
      tma_load_2d(h0 + j * FI_BOX, th0, h0bar, n0 + 64 * j, r0 + wg * FI_ROWS);
  };
  // after a wg_sync (which orders every thread's y1 stores before it), one
  // lane per CTA of the cluster stores this warpgroup's count there, released
  auto publish = [&](int count) {
    if (t < slices) st_release_cluster(cluster_map(s.prog + 4 * (2 * rank + wg), t), count);
  };
  // the walk an item ahead, so that its loads of the tile table wait behind
  // a product
  I2Walk w = i2_walk(n_tiles, lag);
  I2Item x = i2_next(w), next = i2_next(w);
  I2Rows rows = i2_rows(tiles, x, n_edges), rows_next = i2_rows(tiles, next, n_edges);
  if (t == 0 && x.it != 0) load_h0(rows.r0);
  // this half's stages: stage c of the ring (two per K block, halves
  // alternating) is slot c % n_stages of round c / n_stages, and the slot's
  // next stage, c + n_stages, is K block (n_stages / 2 + kb) % nk of a later
  // tile: CTA ((n_stages / 2 + kb) % nk) % slices forms it (nk = 2 slices)
  int slot = wg, round = 0;
  auto advance = [&]() {
    slot += 2;
    if (slot >= n_stages) {
      slot -= n_stages;
      ++round;
    }
  };
  const int next_kb = (n_stages / 2) % nk;
  auto former = [&](int kb) {
    const int k = next_kb + kb < nk ? next_kb + kb : next_kb + kb - nk;
    return k < slices ? k : k - slices;
  };
  int pending = 0;     // a count of iteration-1 tiles written but not yet published
  for (int iter = 0; x.it != 0; ++iter) {
    const I2Item next2 = i2_next(w);
    // the item after next's rows, as loaded: used (clamped) a tile later
    const int r0_2 = next2.it != 0 ? __ldg(tiles + next2.tile) : 0;
    const int r1_2 = next2.it != 0 ? __ldg(tiles + next2.tile + 1) : 0;
    float acc[I2_N / 2];
    uint32_t a0[4][4], a1[4][4];  // two stages' fragments: one in flight, one loading
    for (int kb = 0; kb < nk; kb += 2) {  // this half's stages, in the order of K
      i2_product_stage(acc, a0, s.sm, slot, round & 1, kb, former(kb), t);
      advance();
      i2_product_stage(acc, a1, s.sm, slot, round & 1, kb + 1, former(kb + 1), t);
      advance();
    }
    wgmma_wait<0>();
    mbar_wait(h0bar, iter & 1);
    epilogue<I2_N>(acc, b, h0_ptr, n0, t);
    wg_sync(wg);
    if (pending) publish(pending);
    pending = 0;
    store_tile<I2_N>(x.it == 1 ? y1 : y2, h0_ptr, rows.r0 + wg * FI_ROWS, rows.r1, d, n0, t);
    // published now only if the next item needs it (or there is none)
    const bool now = x.it == 1 && (next.it == 0 || (next.it == 2 && next.ord == x.ord));
    wg_sync(wg);  // every thread is done with the buffer: the next H0 may land
    if (now)
      publish(x.ord + 1);
    else if (x.it == 1)
      pending = x.ord + 1;
    if (t == 0 && next.it != 0) load_h0(rows_next.r0);
    x = next;
    next = next2;
    rows = rows_next;
    rows_next = i2_clamp(r0_2, r1_2, n_edges);
  }
}

// ------------------------------------------------------------ gather warps
// gather thread u forms and stages, at 16-byte chunk u % 8 of each 64-column
// block, the tile rows u / 8 + I2_RSTEP i (i < I2_ROWS): rows of both halves
struct I2RowIds {
  int p0, p1, rv;  // in-edge rows [p0, p1) and the reverse edge, tile-relative; rv -1: zero
};

// the ids of tile row `row` (src s): its source's in-edge rows [p0, p1) and
// its reverse edge, as loaded (rv -1: a zero message, for padding edges and
// rows past the tile's end)
__device__ __forceinline__ I2RowIds i2_ids(const int* __restrict__ rev,
                                           const int* __restrict__ ptr, const I2Rows& rows,
                                           int row, int s, int pad_node) {
  const int e = rows.r0 + row;
  if (e >= rows.r1 || s == pad_node) return {0, 0, -1};
  return {ptr[s], ptr[s + 1], rev[e]};
}

// the same, relative to the tile's first row, and NaN-flagged (p0 = -1, rv =
// 0) where they leave the tile; used a tile after their loads were issued
__device__ __forceinline__ I2RowIds i2_relative(const I2RowIds& a, const I2Rows& rows) {
  if (a.rv < 0) return a;
  const int n = rows.r1 - rows.r0;
  const int p0 = a.p0 - rows.r0, p1 = a.p1 - rows.r0, rv = a.rv - rows.r0;
  if (p0 < 0 || p1 > n || rv < 0 || rv >= n) return {-1, -1, 0};
  return {p0, p1, rv};
}

__device__ __forceinline__ int i2_src(const int* __restrict__ src, const I2Rows& rows, int row,
                                      int pad_node) {
  const int e = rows.r0 + row;
  return e < rows.r1 ? src[e] : pad_node;
}

// whether every consumer warpgroup of the cluster has written its y1 rows of
// the first `need` iteration-1 tiles
__device__ __forceinline__ bool i2_y1_ready(uint32_t prog, int words, int need) {
  bool ready = true;
  for (int q = 0; q < words; ++q) ready &= (int)ld_acquire_cluster(prog + 4 * q) >= need;
  return ready;
}

// a gather wait until every consumer warpgroup of the cluster has written its
// y1 rows of the first `need` iteration-1 tiles; it traps after I2_HANG
// cycles, so that a fault in the hand-over ends the launch with an error
__device__ __forceinline__ void i2_wait_y1(uint32_t prog, int words, int need) {
  for (int q = 0; q < words; ++q) {
    if ((int)ld_acquire_cluster(prog + 4 * q) >= need) continue;
    const long long t0 = clock64();
    while ((int)ld_acquire_cluster(prog + 4 * q) < need) {
      __nanosleep(64);
      if (clock64() - t0 > I2_HANG) __trap();
    }
  }
}

__device__ __forceinline__ void i2_gather(const bf16* __restrict__ H0, const bf16* y1,
                                          const int* __restrict__ src,
                                          const int* __restrict__ rev,
                                          const int* __restrict__ ptr,
                                          const int* __restrict__ tiles, const I2Smem& s,
                                          const uint8_t* smem_raw, int n_edges, int n_tiles,
                                          int d, int pad_node, int rank, int slices,
                                          int n_stages, int lag) {
  const int u = threadIdx.x - 256, l8 = u % 8, g = u / 8;
  const int nk = d / 64;
  I2Walk w = i2_walk(n_tiles, lag);
  I2Item x = i2_next(w), next = i2_next(w);
  I2Rows rx = i2_rows(tiles, x, n_edges), rn = i2_rows(tiles, next, n_edges);
  I2RowIds ids[I2_ROWS];
  int s_next[I2_ROWS];
#pragma unroll
  for (int i = 0; i < I2_ROWS; ++i) {
    const int row = g + I2_RSTEP * i;
    ids[i] = i2_relative(i2_ids(rev, ptr, rx, row, i2_src(src, rx, row, pad_node), pad_node), rx);
    s_next[i] = i2_src(src, rn, g + I2_RSTEP * i, pad_node);
  }
  // K block kb of a tile's rows into staging buffer sb by asynchronous
  // copies, this thread's chunks of its rows; no register waits on them, and
  // no barrier's release orders them (a release orders the thread's earlier
  // loads: the ring's hand-over would wait for device memory). land_block
  // waits for them and, in iteration 1, applies the ReLU to each value of
  // this thread's chunks in place (fmaxf, as B's gather applies it to each
  // gathered value); a gather_sync then hands the block to every thread
  uint8_t* const staging = const_cast<uint8_t*>(smem_raw) + (s.stage - smem_addr(smem_raw));
  I2Rows landing = {0, 0};
  int landing_sb = 0;
  bool landing_relu = false;
  auto load_block = [&](const I2Item& it, const I2Rows& r, int kb, int sb) {
    const bf16* T = (it.it == 1 ? H0 : y1) + 64 * kb + 8 * l8;
#pragma unroll
    for (int i = 0; i < I2_ROWS; ++i) {
      const int row = g + I2_RSTEP * i;
      if (r.r0 + row < r.r1)
        cp_async16(s.stage + sb * I2_STAGE_BYTES + row * 128 + 16 * l8,
                   T + (size_t)(r.r0 + row) * d);
    }
    landing = r;
    landing_sb = sb;
    landing_relu = it.it == 1;
  };
  auto land_block = [&]() {
    cp_async_wait_all();
    if (!landing_relu) return;
#pragma unroll
    for (int i = 0; i < I2_ROWS; ++i) {
      const int row = g + I2_RSTEP * i;
      if (landing.r0 + row < landing.r1) {
        uint4* q = reinterpret_cast<uint4*>(staging + landing_sb * I2_STAGE_BYTES + row * 128 +
                                            16 * l8);
        uint4 v = *q;
        uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = unpack2(w[k]);
          w[k] = pack2(fmaxf(f.x, 0.f), fmaxf(f.y, 0.f));
        }
        *q = v;
      }
    }
    landing_relu = false;
  };

  // this CTA forms K blocks rank and rank + slices of every tile (nk = 2
  // slices): block j of a tile is K block rank + slices j
  if (x.it != 0) load_block(x, rx, rank, 0);
  land_block();
  gather_sync();
  int ui = 0, sb = 0;     // the tiles walked; the staging buffer
  uint32_t phases = 0;    // per ring slot: the parity of this CTA's next wait on it
  while (x.it != 0) {
    const I2Item next2 = i2_next(w);
    const I2Rows rn2 = i2_rows(tiles, next2, n_edges);
    I2RowIds ids_next[I2_ROWS];
    int most = 0;
#pragma unroll
    for (int i = 0; i < I2_ROWS; ++i) most = max(most, ids[i].p1 - ids[i].p0);
    bool after = false;  // the next tile's first block is loaded after this tile's last
    for (int j = 0; j < 2; ++j) {
      const int kb = rank + slices * j;
      // the next block's rows in flight while this block's messages form;
      // an iteration-2 tile's y1 not yet whole may wait for the tiles the
      // consumers are still to finish (this one among them): then it is
      // loaded once this tile's last stages are formed
      if (j == 0) {
        load_block(x, rx, kb + slices, sb ^ 1);
      } else if (next.it == 2 && gather_any(!i2_y1_ready(s.prog, 2 * slices, next.ord + 1))) {
        // one decision for every gather thread: each reads the progress
        // words on its own, and a thread that took the other branch would
        // skip the deferred load's gather_sync below
        after = true;
      } else if (next.it != 0) {
        load_block(next, rn, rank, sb ^ 1);
      }
      // the block's two stages (one per half) in every CTA's ring, once the
      // consumers of the stages that last held those slots are done
      const int c = 2 * (ui * nk + kb), s0 = c % n_stages, s1 = s0 + 1;
      if (c >= n_stages) {
        mbar_wait_cluster(s.sm.empty + 8 * s0, (phases >> s0) & 1);
        mbar_wait_cluster(s.sm.empty + 8 * s1, (phases >> s1) & 1);
        phases ^= 3u << s0;
      }
      // the message rows: f32 sums over the in-edges in order, less the
      // reverse edge, from the staging buffer (in iteration 1 of relu(H0))
      const uint8_t* stg =
          smem_raw + (s.stage - smem_addr(smem_raw)) + sb * I2_STAGE_BYTES + 16 * l8;
      // Branch-free: a row's missing in-edges add zeros (a sum that starts at
      // +0 and adds +0 keeps its bits)
      float acc[I2_ROWS][8];
      uint4 r[I2_ROWS];
#pragma unroll
      for (int i = 0; i < I2_ROWS; ++i) {
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;
        r[i] = make_uint4(0, 0, 0, 0);
        if (ids[i].rv >= 0) r[i] = *reinterpret_cast<const uint4*>(stg + ids[i].rv * 128);
      }
      for (int k = 0; k < most; ++k) {
        uint4 v[I2_ROWS];
#pragma unroll
        for (int i = 0; i < I2_ROWS; ++i) {
          v[i] = make_uint4(0, 0, 0, 0);
          if (ids[i].p0 + k < ids[i].p1)
            v[i] = *reinterpret_cast<const uint4*>(stg + (ids[i].p0 + k) * 128);
        }
#pragma unroll
        for (int i = 0; i < I2_ROWS; ++i) i2_add8(acc[i], v[i]);
      }
#pragma unroll
      for (int i = 0; i < I2_ROWS; ++i) {
        const int row = g + I2_RSTEP * i, rr = row % FI_ROWS;
        i2_sub8(acc[i], r[i]);  // minus the reverse edge's row (zeros for none)
        uint4 out = make_uint4(pack2(acc[i][0], acc[i][1]), pack2(acc[i][2], acc[i][3]),
                               pack2(acc[i][4], acc[i][5]), pack2(acc[i][6], acc[i][7]));
        if (ids[i].p0 < 0) out = make_uint4(I2_NAN2, I2_NAN2, I2_NAN2, I2_NAN2);
        if (row < I2_TILE)
          st_shared16(s.sm.ring + (row < FI_ROWS ? s0 : s1) * FI_BOX + rr * 128 +
                          ((l8 ^ (rr & 7)) << 4),
                      out);
      }
      fence_proxy_async();  // the stages' stores before the bulk copies read them
      if (j == 1) {  // the next tile's ids landed during this block: no release waits on them
#pragma unroll
        for (int i = 0; i < I2_ROWS; ++i) ids_next[i] = i2_relative(ids_next[i], rn);
      }
      land_block();
      gather_sync();
      // the block's two stages (adjacent slots, 16 KB) go out: this CTA's
      // consumers are told, and each other CTA of the cluster gets one bulk
      // copy of both, counted on its full barrier of the pair; one lane per
      // CTA, side by side
      if (u == 0) {
        mbar_arrive(s.sm.full + 8 * s0);
      } else if (u < slices) {
        const uint32_t q = (rank + u) % slices, stage = s.sm.ring + s0 * FI_BOX;
        const uint32_t full = cluster_map(s.sm.full + 8 * s0, q);
        mbar_arrive_expect_tx_cluster(full, 2 * FI_BOX);
        bulk_copy_cluster(cluster_map(stage, q), stage, 2 * FI_BOX, full);
      }
      // the next tile's first block, deferred: its copies into the other
      // buffer, which every gather thread is done with since the last
      // gather_sync, once this tile's last stages are out
      if (after) {
        i2_wait_y1(s.prog, 2 * slices, next.ord + 1);
        load_block(next, rn, rank, sb ^ 1);
        land_block();
        gather_sync();
      }
      if (j == 0) {  // the next tile's ids (its src came a tile ahead), after the arrivals
#pragma unroll
        for (int i = 0; i < I2_ROWS; ++i) {
          ids_next[i] = i2_ids(rev, ptr, rn, g + I2_RSTEP * i, s_next[i], pad_node);
          s_next[i] = i2_src(src, rn2, g + I2_RSTEP * i, pad_node);
        }
      }
      sb ^= 1;
    }
#pragma unroll
    for (int i = 0; i < I2_ROWS; ++i) ids[i] = ids_next[i];
    ++ui;
    x = next;
    rx = rn;
    next = next2;
    rn = rn2;
  }
}

// cluster c walks its run of tiles; its CTA of rank s holds W's columns
// [128 s, 128 s + 128)
__global__ void __launch_bounds__(I2_THREADS, 1)
    iter2_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap th0,
                 const bf16* __restrict__ H0, const bf16* __restrict__ b, bf16* y1, bf16* y2,
                 const int* __restrict__ src, const int* __restrict__ rev,
                 const int* __restrict__ ptr, const int* __restrict__ tiles, int n_edges,
                 int n_tiles, int d, int pad_node, int n_stages) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const int nk = d / 64, slices = d / I2_N;
  I2Smem s;
  s.sm.w = base;                                 // nk x 2 boxes of the W slice
  s.sm.h0 = s.sm.w + nk * I2_NB * FI_BOX;        // two halves' H0 slices
  s.stage = s.sm.h0 + 2 * I2_H0_BYTES;           // two staging buffers
  s.sm.ring = s.stage + 2 * I2_STAGE_BYTES;      // the message stages
  s.sm.full = s.sm.ring + n_stages * FI_BOX;     // their barriers
  s.sm.empty = s.sm.full + 8 * n_stages;
  s.sm.wbar = s.sm.empty + 8 * n_stages;
  s.sm.h0bar = s.sm.wbar + 8;                    // two
  s.prog = s.sm.h0bar + 16;                      // the progress words
  const int rank = (int)cluster_rank(), n0 = rank * I2_N;
  // the role from a warp-uniform value (a shuffle), so that the compiler
  // sees no divergent path around the consumers' wgmma
  const int warp = __shfl_sync(~0u, (int)threadIdx.x / 32, 0);
  // an iteration-2 tile waits for nothing if both consumer warpgroups have
  // finished and published the tiles it needs by the time the gather warps
  // reach it: they run at most the ring's K blocks ahead, and a tile is
  // published a tile late
  const int lag = (n_stages / 2 + nk - 1) / nk + 2;

  if (threadIdx.x == 0) {
    for (int i = 0; i < n_stages; ++i) {
      mbar_init(s.sm.full + 8 * i, 1);  // even slots: the former's arrival (and copy's bytes)
      mbar_init(s.sm.empty + 8 * i, 4 * slices);     // one per warp of a half's warpgroup, each CTA
    }
    mbar_init(s.sm.wbar, 1);
    mbar_init(s.sm.h0bar, 1);
    mbar_init(s.sm.h0bar + 8, 1);
    for (int i = 0; i < I2_WORDS; ++i)
      asm volatile("st.shared.u32 [%0], %1;" ::"r"(s.prog + 4 * i), "r"(0u) : "memory");
    mbar_fence_init();
  }
  cluster_sync();  // every CTA's barriers and words exist before another CTA writes them

  if (warp < 8) {
    if (threadIdx.x == 0) {  // the W slice, once for the whole launch
      tma_prefetch_map(&tw);
      tma_prefetch_map(&th0);
      mbar_arrive_expect_tx(s.sm.wbar, nk * I2_NB * FI_BOX);
      for (int k = 0; k < nk; ++k)
        for (int j = 0; j < I2_NB; ++j)
          tma_load_2d(s.sm.w + (k * I2_NB + j) * FI_BOX, &tw, s.sm.wbar, n0 + 64 * j, 64 * k);
    }
    mbar_wait(s.sm.wbar, 0);
    i2_consume(&th0, b, y1, y2, s, smem_raw, tiles, n_edges, n_tiles, d, n0, rank, slices,
               n_stages, lag, warp / 4);
  } else {
    i2_gather(H0, y1, src, rev, ptr, tiles, s, smem_raw, n_edges, n_tiles, d, pad_node, rank,
              slices, n_stages, lag);
  }
  cluster_sync();  // no CTA leaves while another may still write its progress words
}

// ---------------------------------------------------------------------- host
// the CTAs of a cluster (one per W slice) at width d, or 0 where the width is
// not taken: d a multiple of 128 up to 512
static int i2_slices(int d) {
  return d % I2_N == 0 && d >= I2_N && d / I2_N <= I2_MAX_CLUSTER ? d / I2_N : 0;
}

static int i2_fixed_bytes(int d) {  // everything but the ring
  return 1024 + d * I2_N * 2 + 2 * I2_H0_BYTES + 2 * I2_STAGE_BYTES +
         8 * (2 * I2_MAX_STAGES + 3) + 4 * I2_WORDS;
}

// the message stages that fit, an even number (stages alternate halves)
static int i2_stages(int d) {
  const int n = (I2_SMEM_MAX - i2_fixed_bytes(d)) / FI_BOX;
  return (n < I2_MAX_STAGES ? n : I2_MAX_STAGES) & ~1;
}

static size_t i2_smem(int d) {
  return (size_t)i2_fixed_bytes(d) + (size_t)i2_stages(d) * FI_BOX;
}

static cudaError_t i2_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int d,
                             int clusters, cudaStream_t stream) {
  const int slices = i2_slices(d);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(clusters * slices);
  cfg->blockDim = dim3(I2_THREADS);
  cfg->dynamicSmemBytes = i2_smem(d);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = slices;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  // the opt-in above 48 KB is per device and per size, so it is made at every launch (cheap)
  return cudaFuncSetAttribute(iter2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)i2_smem(d));
}

// the clusters the card runs at once at width d, asked once per width
static int i2_max_clusters(int d) {
  static int cache[I2_MAX_CLUSTER + 1] = {};  // by slices; 0: not asked yet
  int& n = cache[i2_slices(d)];
  if (n == 0) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int c = 0;
    if (i2_config(&cfg, &attr, d, 1, nullptr) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&c, (void*)iter2_kernel, &cfg) != cudaSuccess)
      c = 0;
    n = c > 0 ? c : -1;
  }
  return n > 0 ? n : 0;
}

// the clusters of a launch over n_tiles tiles: as many as run at once, no
// more than there are tiles
static int i2_clusters(int d, int n_tiles) {
  const int n = i2_max_clusters(d);
  return n < n_tiles ? n : n_tiles;
}

// y1 and y2 from H0 [n_edges x d] and W [d x d] bfloat16 ((in, out) layout;
// rows 16-byte aligned), b [d] or null, d one of 128, 256, 384, 512, over a
// tile table of n_tiles tiles (ascending row offsets from 0 to n_edges, at
// most 128 rows each, no molecule in two tiles)
extern "C" int iter2(const void* H0, const void* W, const void* b, const int* src,
                     const int* rev, const int* ptr, const int* tiles, void* y1, void* y2,
                     int n_edges, int n_tiles, int d, int pad_node, cudaStream_t stream) {
  if (i2_slices(d) == 0 || n_edges < 0 || tiles == nullptr || n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  if (n_edges == 0) return 0;
  const int clusters = i2_clusters(d, n_tiles);
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap maps[2];  // W, H0
  if (!bf16_table_map(&maps[0], W, d, d, 64) || !bf16_table_map(&maps[1], H0, n_edges, d, FI_ROWS))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = i2_config(&cfg, &attr, d, clusters, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaLaunchKernelEx(&cfg, iter2_kernel, maps[0], maps[1], (const bf16*)H0,
                                 (const bf16*)b, (bf16*)y1, (bf16*)y2, src, rev, ptr, tiles,
                                 n_edges, n_tiles, d, pad_node, i2_stages(d));
}

// the launch's shape at width d over n_tiles tiles, into info[0..5]: slice
// width, CTAs per cluster (the slices), message stages, shared-memory bytes
// per CTA, clusters of the grid, and clusters the card runs at once
extern "C" int iter2_info(int d, int n_tiles, int* info) {
  const int slices = i2_slices(d);
  if (slices == 0 || n_tiles < 1) return (int)cudaErrorInvalidValue;
  info[0] = I2_N;
  info[1] = slices;
  info[2] = i2_stages(d);
  info[3] = (int)i2_smem(d);
  info[4] = i2_clusters(d, n_tiles);
  info[5] = i2_max_clusters(d);
  return info[5] > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}
