// The premultiplied backward of an earlier depth iteration, redesigned for
// Hopper: from the next stage's cotangent G_in and the saved output y,
//
//   dh = G_in W^T (f32),  gz = dh [y > 0] rounded to bf16,
//   G  = (S - R)^T gz,    z  = gz, or with fold_h0 (the first iteration)
//                              z = gz + dh [H0 > 0] rounded once,
//
// where ((S - R)^T gz)[e] = sum_{j : dst[j] == dst[e]} gz[rev[j]] - gz[rev[e]]
// (edges sorted by dst, in-edges of node v in rows [ptr[v], ptr[v+1])).
//
// bwd_premul replaces the Pallas TPU kernel _bwd_msg_premul_kernel of
// chemprop_tpu/ops/fused_message.py (launched by _bwd_msg_premul_impl), whose
// W^T stays resident in VMEM while a ring of G_in chunks streams past it and
// gz never leaves the chip.
//
// It is bound by bytes on the H100: G_in, y (and H0) read once, G and z
// written once, five bf16 edge tables at [123,392 x 384] (474 MB, 0.14 ms at
// 3.35 TB/s), against 36 GFLOP on the tensor cores (37 us at their bf16
// peak). The earlier design took two launches, wrote gz to a scratch table
// and read it back twice per row, and re-read W from L2 for every 64 rows.
// Here:
//
// * One launch over the molecule tiles. The collate's tile table cuts the
//   dst-sorted rows into tiles of at most 128 rows with no molecule in two,
//   so every rev[j] and every in-edge of dst[j] of a tile's row j lies in the
//   tile. A block forms the tile's gz in shared memory and G from it there:
//   gz is never written out.
// * W^T resident. The output columns are cut into slices of 128 (three at
//   d = 384). A persistent block owns one slice for the whole launch: the
//   slice of W^T, 96 KB at d = 384, comes in once by TMA from W itself, whose
//   rows are W^T's columns: wgmma's K-major B operand, so W^T is never
//   formed. The blocks of a tile's slices run side by side, so G_in's rows
//   come from DRAM once and from L2 for the other slices.
// * Warp-specialised. A producer thread brings the tile's G_in rows in
//   64 x 64 boxes by TMA (128-byte swizzle) into a ring of stages; one
//   consumer warpgroup reads each stage with ldmatrix into registers and
//   multiplies it on wgmma against the W^T slice, 64 rows at a time (a tile
//   of more than 64 rows takes two), and stores bf16(dh) into one of two
//   [128 x slice] buffers in shared memory. Eleven node warps then read y and
//   H0 with 16-byte loads (issued a tile ahead), write z out and gz over dh
//   in the buffer, and form G row by row from the buffer: T[v] summed over
//   the in-edges of v in the order of the rows, in f32, less the row's own
//   reverse. Meanwhile the consumer fills the other buffer with the next
//   tile's dh. What bounds it on the card is the node warps (more of them,
//   and the second buffer, took it from 0.25 to 0.22 ms at d = 384): their
//   loads, the node pass and its stores. A slice of 192 would read G_in from
//   L2 twice, not three times, but its accumulator leaves registers for
//   seven node warps only, and shared memory for one buffer.
// * z from the rounded dh. With m = [y > 0] and m0 = [H0 > 0] in {0, 1},
//   bf16(dh m) = bf16(dh) m and bf16(dh m + dh m0) = bf16(dh) (m + m0):
//   doubling is exact, so rounding dh first gives the same bits (apart from
//   bf16 subnormals), and one bf16 buffer serves dh and gz.
//
// Padding rows (from ptr[pad_node] on) get exact zeros in G and z, and a tile
// of padding rows takes no product. Every output row is written by one block
// in one fixed order with no atomics: two calls give the same bits.
//
// With a split table, whose tiles cut a molecule of more than 128 rows at its
// nodes' boundaries, a row whose sum reads a row of another tile comes out
// wrong (NaN, or the sum of rows of its own tile); the caller, which knows
// those rows, forms them again from gz, which the launch then writes out too.
//
// Without a tile table (a batch holding a molecule of more than 128 rows) the
// same kernel runs over fixed 128-row tiles and writes gz out (into z itself
// without fold_h0); the caller then forms G with the node pass of
// message_bwd.cu, which sums in the same order: G and z of both forms are
// equal bit for bit.
#include "sm90.cuh"
#include "vec.cuh"

constexpr int PM_ROWS = 64;             // wgmma's M: one half of a tile
constexpr int PM_TILE = 2 * PM_ROWS;    // the most rows a tile holds
constexpr int PM_BOX = PM_ROWS * 128;   // one 64 x 64 bf16 box: a stage or a box of W
constexpr int PM_PRODUCER = 128;        // thread of the producer: the consumer is 0-127
constexpr int PM_NODE0 = 160;           // the first of the node warps' threads
constexpr int PM_NODE_THREADS = 352;    // eleven node warps
constexpr int PM_THREADS = PM_NODE0 + PM_NODE_THREADS;
constexpr int PM_MAX_STAGES = 16;
constexpr int PM_SMEM_MAX = 232448;     // a block's shared memory on sm_90
constexpr int PM_IDS = 2 * PM_TILE * 4; // two tiles' packed row ids, one per buffer
constexpr uint32_t PM_PAD = 1u << 24;   // id flag: a padding row (zeros)
constexpr uint32_t PM_BAD = 1u << 25;   // id flag: a neighbour outside the tile (NaN)

struct PmSmem {
  uint32_t w, buf, ring, ids, full, empty, wbar, ready, bfree;
};

// rows [r0, r1) of tile t, from the table or in fixed runs of PM_TILE rows,
// and the 64-row halves that hold a row before the padding
struct PmTile {
  int r0, r1, halves;
};

__device__ __forceinline__ PmTile tile_at(const int* __restrict__ tiles, int t, int n_edges,
                                          int first_pad) {
  PmTile x;
  x.r0 = tiles != nullptr ? tiles[t] : t * PM_TILE;
  const int end = tiles != nullptr ? tiles[t + 1] : n_edges;
  x.r1 = max(x.r0, min(min(end, n_edges), x.r0 + PM_TILE));  // within the buffer
  const int real = min(x.r1, first_pad) - x.r0;
  x.halves = real > 0 ? (real + PM_ROWS - 1) / PM_ROWS : 0;
  return x;
}

// 16-byte chunk ch (8 columns) of row r of the [PM_TILE x N] buffer, swizzled
// (chunk ch at ch ^ (r % 8)) so that neither the accumulator's stores nor the
// node warps' row reads conflict on banks
template <int N>
__device__ __forceinline__ uint4* buf_chunk(uint8_t* buf, int r, int ch) {
  return reinterpret_cast<uint4*>(buf + r * (2 * N) + ((ch ^ (r % 8)) << 4));
}

// the node pass's f32 sums: t += the 8 bf16 of a chunk
__device__ __forceinline__ void add8(float (&t)[8], uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = unpack2(w[i]);
    t[2 * i] += f.x;
    t[2 * i + 1] += f.y;
  }
}

// gz = dh [y > 0] and z = gz (+ dh [H0 > 0]) of one chunk, from the rounded dh
__device__ __forceinline__ void mask_chunk(uint4 dh, uint4 y, uint4 h0, bool fold, uint4& gz,
                                           uint4& z) {
  const uint32_t dw[4] = {dh.x, dh.y, dh.z, dh.w}, yw[4] = {y.x, y.y, y.z, y.w};
  const uint32_t hw[4] = {h0.x, h0.y, h0.z, h0.w};
  uint32_t g[4], o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 d = unpack2(dw[i]), m = unpack2(yw[i]);
    const float g0 = m.x > 0.f ? d.x : 0.f, g1 = m.y > 0.f ? d.y : 0.f;
    g[i] = pack2(g0, g1);
    if (fold) {
      const float2 m0 = unpack2(hw[i]);
      o[i] = pack2(g0 + (m0.x > 0.f ? d.x : 0.f), g1 + (m0.y > 0.f ? d.y : 0.f));
    } else {
      o[i] = g[i];
    }
  }
  gz = make_uint4(g[0], g[1], g[2], g[3]);
  z = make_uint4(o[0], o[1], o[2], o[3]);
}

// one stage of the consumer: this warp's A fragments from stage c (ldmatrix
// on the swizzled box), then four wgmma over its 64 K values against the
// resident W^T slice. The previous stage's group is then done, and with it
// the reads of that stage: it goes back to the producer only now, since the
// TMA that refills it is not ordered after a generic read (no proxy fence)
// until that read has been consumed.
template <int N>
__device__ __forceinline__ void product_stage(float (&acc)[N / 2], uint32_t (&a)[4][4],
                                              const PmSmem& sm, int c, int kb, int n_stages) {
  constexpr int NB = N / 64;
  const int s = c % n_stages, lane = threadIdx.x % 32;
  const int row = 16 * (threadIdx.x / 32) + lane % 16;
  mbar_wait(sm.full + 8 * s, (c / n_stages) & 1);
  const uint32_t stage = sm.ring + s * PM_BOX + row * 128;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(a[kk], stage + (((2 * kk + lane / 16) ^ (row % 8)) << 4));
  const uint32_t bw = sm.w + kb * NB * PM_BOX;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rkn<N>(acc, a[kk], desc_k_sw128(bw + 32 * kk), kb + kk > 0);
  wgmma_commit();
  wgmma_wait<1>();
  // the warpgroup's four warps release the previous stage of this half
  if (kb > 0 && lane == 0) mbar_arrive(sm.empty + 8 * ((c - 1) % n_stages));
}

// the consumer warpgroup: per tile and half, dh = G_in W^T on wgmma, then
// bf16(dh) into the tile's buffer once the node warps are done with the tile
// before the last, which had it
template <int N>
__device__ __forceinline__ void consume(const int* __restrict__ tiles, const PmSmem& sm,
                                        uint8_t* buf, int n_edges, int d, int first_pad,
                                        int n_tiles, int first, int step, int n_stages) {
  const int t = threadIdx.x, lane = t % 32, nk = d / 64;
  int c = 0, it = 0;
  for (int tile = first; tile < n_tiles; tile += step, ++it) {
    const PmTile x = tile_at(tiles, tile, n_edges, first_pad);
    const int b = it & 1;  // the buffer of this tile
    uint8_t* bb = buf + b * (PM_TILE * N * 2);
    for (int h = 0; h < 2; ++h) {
      float acc[N / 2];
      if (h < x.halves) {
        uint32_t a0[4][4], a1[4][4];  // two stages' fragments: one in flight, one loading
        for (int kb = 0; kb < nk; kb += 2, c += 2) {
          product_stage<N>(acc, a0, sm, c, kb, n_stages);
          product_stage<N>(acc, a1, sm, c + 1, kb + 1, n_stages);
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(sm.empty + 8 * ((c - 1) % n_stages));  // the half's last
      }
      if (h == 0 && it >= 2) mbar_wait(sm.bfree + 8 * b, ((it >> 1) - 1) & 1);  // tile it - 2
      if (h < x.halves) {
        // rows 64 h + 16 (t / 32) + (t % 32) / 4 (+ 8), columns 8 j + 2 (t % 4) (+ 1)
        const int row = PM_ROWS * h + 16 * (t / 32) + lane / 4;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row + 8 * hh;
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
            *reinterpret_cast<uint32_t*>(reinterpret_cast<uint8_t*>(buf_chunk<N>(bb, r, j)) +
                                         4 * (lane % 4)) =
                pack2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        }
      }
      mbar_arrive(sm.ready + 8 * (2 * b + h));  // every tile, both halves: phases in step
    }
  }
}

// the producer: the G_in boxes of every half the consumer multiplies, in its order
__device__ __forceinline__ void produce(const CUtensorMap* tg, const int* __restrict__ tiles,
                                        const PmSmem& sm, int n_edges, int d, int first_pad,
                                        int n_tiles, int first, int step, int n_stages) {
  const int nk = d / 64;
  int c = 0;
  for (int tile = first; tile < n_tiles; tile += step) {
    const PmTile x = tile_at(tiles, tile, n_edges, first_pad);
    for (int h = 0; h < x.halves; ++h)
      for (int kb = 0; kb < nk; ++kb, ++c) {
        const int s = c % n_stages;
        if (c >= n_stages) mbar_wait(sm.empty + 8 * s, (c / n_stages - 1) & 1);
        mbar_arrive_expect_tx(sm.full + 8 * s, PM_BOX);
        tma_load_2d(sm.ring + s * PM_BOX, tg, sm.full + 8 * s, 64 * kb, x.r0 + PM_ROWS * h);
      }
  }
}

// y and H0 of this node thread's chunks of half h of tile x, the
// chunks being (row, 16-byte piece) in the order of the rows; zeros where the
// thread has no chunk or the row is a padding row
template <int N, int MT>
__device__ __forceinline__ void load_half(uint4 (&yv)[MT], uint4 (&hv)[MT],
                                          const bf16* __restrict__ y,
                                          const bf16* __restrict__ H0, const PmTile& x, int h,
                                          int d, int n0, int first_pad) {
  constexpr int CH = N / 8;
  const int nt = threadIdx.x - PM_NODE0, tasks = min(x.r1 - x.r0 - PM_ROWS * h, PM_ROWS) * CH;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    yv[m] = hv[m] = make_uint4(0u, 0u, 0u, 0u);
    const int task = nt + PM_NODE_THREADS * m;
    const int e = x.r0 + PM_ROWS * h + task / CH;
    if (task < tasks && e < first_pad) {
      const size_t off = (size_t)e * d + n0 + 8 * (task % CH);
      yv[m] = __ldg(reinterpret_cast<const uint4*>(y + off));
      if (H0 != nullptr) hv[m] = __ldg(reinterpret_cast<const uint4*>(H0 + off));
    }
  }
}

// the mask of half h once its dh is in the buffer: z out, gz over dh (and out
// to gz_out, when given)
template <int N, int MT>
__device__ __forceinline__ void mask_half(const uint4 (&yv)[MT], const uint4 (&hv)[MT],
                                          bf16* __restrict__ z, bf16* __restrict__ gz_out,
                                          uint8_t* buf, const PmTile& x, int h, int d, int n0,
                                          int first_pad, bool fold) {
  constexpr int CH = N / 8;
  const int nt = threadIdx.x - PM_NODE0, tasks = min(x.r1 - x.r0 - PM_ROWS * h, PM_ROWS) * CH;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int task = nt + PM_NODE_THREADS * m;
    if (task >= tasks) continue;
    const int r = PM_ROWS * h + task / CH, ch = task % CH, e = x.r0 + r;
    uint4 gz = make_uint4(0u, 0u, 0u, 0u), zc = gz;
    uint4* slot = buf_chunk<N>(buf, r, ch);
    if (e < first_pad) mask_chunk(*slot, yv[m], hv[m], fold, gz, zc);
    *slot = gz;
    const size_t off = (size_t)e * d + n0 + 8 * ch;
    *reinterpret_cast<uint4*>(z + off) = zc;
    if (gz_out != nullptr) *reinterpret_cast<uint4*>(gz_out + off) = gz;
  }
}

// the node warps: per tile, the mask half by half, then G from the buffer
// with the tile's packed ids (reverse, in-edge range, in local rows; two
// tiles' worth, by parity). The next tile's dst and rev, and y and H0 of its
// halves, are loaded before this tile's node pass, so that their loads are in
// flight meanwhile.
template <int N>
__device__ __forceinline__ void node_pass(
    const bf16* __restrict__ y, const bf16* __restrict__ H0, const int* __restrict__ dst,
    const int* __restrict__ rev, const int* __restrict__ ptr, const int* __restrict__ tiles,
    bf16* __restrict__ G, bf16* __restrict__ z, bf16* __restrict__ gz_out, const PmSmem& sm,
    uint8_t* buf, uint32_t* ids2, int n_edges, int d, int n0, int first_pad, int n_tiles,
    int first, int step) {
  constexpr int CH = N / 8;  // 16-byte chunks of a row of the slice
  constexpr int MT = (PM_ROWS * CH + PM_NODE_THREADS - 1) / PM_NODE_THREADS;
  static_assert(PM_TILE <= PM_NODE_THREADS, "a node thread builds one row's ids");
  const int nt = threadIdx.x - PM_NODE0;
  const bool fold = H0 != nullptr;
  uint4 y0[MT], h0[MT], y1[MT], h1[MT];
  int vd = -1, vr = 0;  // dst and rev of this thread's row of the tile (-1: none)
  auto load_tile = [&](const PmTile& t) {
    load_half<N>(y0, h0, y, H0, t, 0, d, n0, first_pad);
    load_half<N>(y1, h1, y, H0, t, 1, d, n0, first_pad);
    const int e = t.r0 + nt;
    vd = -1;
    if (tiles != nullptr && nt < t.r1 - t.r0 && e < first_pad) {
      vd = dst[e];
      vr = rev[e];
    }
  };
  if (first >= n_tiles) return;
  PmTile x = tile_at(tiles, first, n_edges, first_pad);
  load_tile(x);
  int it = 0;
  for (int tile = first; tile < n_tiles; tile += step, ++it) {
    const int rows = x.r1 - x.r0, b = it & 1;
    uint32_t* ids = ids2 + b * PM_TILE;
    uint8_t* bb = buf + b * (PM_TILE * N * 2);
    if (tiles != nullptr && nt < rows) {
      uint32_t id = nt | PM_PAD;
      if (vd >= 0) {
        const int lo = ptr[vd] - x.r0, hi = ptr[vd + 1] - x.r0, rv = vr - x.r0;
        id = 0 <= lo && lo <= hi && hi <= rows && 0 <= rv && rv < rows
                 ? (uint32_t)(rv | lo << 8 | hi << 16)
                 : (uint32_t)nt | PM_BAD;
      }
      ids[nt] = id;
    }
    mbar_wait(sm.ready + 16 * b, (it >> 1) & 1);
    mask_half<N>(y0, h0, z, gz_out, bb, x, 0, d, n0, first_pad, fold);
    mbar_wait(sm.ready + 16 * b + 8, (it >> 1) & 1);
    mask_half<N>(y1, h1, z, gz_out, bb, x, 1, d, n0, first_pad, fold);
    const PmTile cur = x;
    if (tile + step < n_tiles) {
      x = tile_at(tiles, tile + step, n_edges, first_pad);
      load_tile(x);
    }
    if (tiles != nullptr) {
      asm volatile("bar.sync 1, %0;" ::"n"(PM_NODE_THREADS) : "memory");  // gz and ids are in
      for (int task = nt; task < rows * CH; task += PM_NODE_THREADS) {
        const int i = task / CH, ch = task % CH;
        const uint32_t id = ids[i];
        uint4 out = make_uint4(0u, 0u, 0u, 0u);
        if (id & PM_BAD) {
          out = make_uint4(0x7FC07FC0u, 0x7FC07FC0u, 0x7FC07FC0u, 0x7FC07FC0u);  // NaN
        } else if (!(id & PM_PAD)) {
          // T[dst] over the in-edges in their order; the first four of them
          // (most atoms have at most four neighbours) loaded at once
          const int lo = (id >> 8) & 0xFF, hi = (id >> 16) & 0xFF;
          uint4 v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[q] = lo + q < hi ? *buf_chunk<N>(bb, ids[lo + q] & 0x7F, ch) : out;
          const uint4 x4 = *buf_chunk<N>(bb, id & 0x7F, ch);  // minus the row's reverse
          float t[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (lo + q < hi) add8(t, v[q]);
          for (int j = lo + 4; j < hi; ++j) add8(t, *buf_chunk<N>(bb, ids[j] & 0x7F, ch));
          const uint32_t xw[4] = {x4.x, x4.y, x4.z, x4.w};
          uint32_t o[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 xr = unpack2(xw[q]);
            o[q] = pack2(t[2 * q] - xr.x, t[2 * q + 1] - xr.y);
          }
          out = make_uint4(o[0], o[1], o[2], o[3]);
        }
        *reinterpret_cast<uint4*>(G + (size_t)(cur.r0 + i) * d + n0 + 8 * ch) = out;
      }
    }
    mbar_arrive(sm.bfree + 8 * b);  // this thread is done with the tile's buffer
  }
}

// block b holds slice b % (d / N) and walks tiles b / (d / N), + gridDim.x /
// (d / N), ...
template <int N>
__global__ void __launch_bounds__(PM_THREADS, 1)
    bwd_premul_kernel(const __grid_constant__ CUtensorMap tw,
                      const __grid_constant__ CUtensorMap tg, const bf16* __restrict__ y,
                      const bf16* __restrict__ H0, const int* __restrict__ dst,
                      const int* __restrict__ rev, const int* __restrict__ ptr,
                      const int* __restrict__ tiles, bf16* __restrict__ G, bf16* __restrict__ z,
                      bf16* __restrict__ gz_out, int n_edges, int d, int pad_node, int n_tiles,
                      int n_stages) {
  constexpr int NB = N / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023) & ~1023u;
  const int nk = d / 64, slices = d / N;
  PmSmem sm;
  sm.w = base;                                // nk x NB boxes of W: the W^T slice
  sm.buf = sm.w + nk * NB * PM_BOX;           // two [PM_TILE x N] bf16: dh, then gz
  sm.ring = sm.buf + 2 * PM_TILE * N * 2;     // the G_in stages
  sm.ids = sm.ring + n_stages * PM_BOX;       // two tiles' packed row ids
  sm.full = sm.ids + PM_IDS;                  // the barriers
  sm.empty = sm.full + 8 * n_stages;
  sm.wbar = sm.empty + 8 * n_stages;
  sm.ready = sm.wbar + 8;                     // four: per buffer, one per half
  sm.bfree = sm.ready + 32;                   // two: one per buffer
  uint8_t* buf = smem_raw + (sm.buf - raw);
  const int n0 = (blockIdx.x % slices) * N;
  const int first = blockIdx.x / slices, step = gridDim.x / slices;
  const int first_pad = ptr[pad_node];

  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(sm.full + 8 * s, 1);   // the producer's arrival, and the box's bytes
      mbar_init(sm.empty + 8 * s, 4);  // one per consumer warp
    }
    mbar_init(sm.wbar, 1);
    for (int i = 0; i < 4; ++i) mbar_init(sm.ready + 8 * i, 128);
    mbar_init(sm.bfree, PM_NODE_THREADS);
    mbar_init(sm.bfree + 8, PM_NODE_THREADS);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    if (threadIdx.x == 0) {  // the W^T slice, once for the whole launch
      tma_prefetch_map(&tw);
      mbar_arrive_expect_tx(sm.wbar, nk * NB * PM_BOX);
      for (int k = 0; k < nk; ++k)
        for (int j = 0; j < NB; ++j)
          tma_load_2d(sm.w + (k * NB + j) * PM_BOX, &tw, sm.wbar, 64 * k, n0 + 64 * j);
    }
    mbar_wait(sm.wbar, 0);
    consume<N>(tiles, sm, buf, n_edges, d, first_pad, n_tiles, first, step, n_stages);
  } else if (threadIdx.x == PM_PRODUCER) {
    tma_prefetch_map(&tg);
    produce(&tg, tiles, sm, n_edges, d, first_pad, n_tiles, first, step, n_stages);
  } else if (threadIdx.x >= PM_NODE0) {
    node_pass<N>(y, H0, dst, rev, ptr, tiles, G, z, gz_out, sm, buf,
                 reinterpret_cast<uint32_t*>(smem_raw + (sm.ids - raw)), n_edges, d, n0,
                 first_pad, n_tiles, first, step);
  }
}

// the G_in stages that fit beside the W^T slice, the buffers, the ids, the
// barriers and the alignment
static int pm_stages(int d, int n) {
  int s = (PM_SMEM_MAX - 1024 - d * n * 2 - 2 * PM_TILE * n * 2 - PM_IDS -
           8 * (2 * PM_MAX_STAGES + 7)) / PM_BOX;
  return s < PM_MAX_STAGES ? s : PM_MAX_STAGES;
}

// the width of a block's W^T slice: 128, or 64 where a slice of 128 leaves
// room for fewer than two stages (d = 640 and up); a wider accumulator would
// leave the consumer too few registers at 512 threads
static int pm_width(int d) {
  const int widths[2] = {128, 64};
  for (int n : widths)
    if (d % n == 0 && pm_stages(d, n) >= 2) return n;
  return 0;
}

static size_t pm_smem(int d, int n, int stages) {
  return 1024 + (size_t)d * n * 2 + 2 * (size_t)PM_TILE * n * 2 + (size_t)stages * PM_BOX +
         PM_IDS + 8 * (2 * stages + 7);
}

// blocks of the grid: as many groups of d / N (one block per slice of a
// tile) as fit one block per SM, no more than there are tiles
static int pm_grid(int d, int n, int n_tiles) {
  const int slices = d / n;
  const int groups = sm_count() / slices > 0 ? sm_count() / slices : 1;
  return (n_tiles < groups ? n_tiles : groups) * slices;
}

template <int N>
static cudaError_t pm_launch(const CUtensorMap* maps, const void* y, const void* H0,
                             const int* dst, const int* rev, const int* ptr, const int* tiles,
                             void* G, void* z, void* gz_out, int n_edges, int d, int pad_node,
                             int n_tiles, cudaStream_t stream, int* blocks_per_sm = nullptr) {
  const int stages = pm_stages(d, N);
  const size_t smem = pm_smem(d, N, stages);
  // the opt-in above 48 KB is per device and per size, so it is made at every launch (cheap)
  cudaError_t err = cudaFuncSetAttribute(bwd_premul_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (blocks_per_sm != nullptr)  // how many blocks of it one SM runs at once
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, bwd_premul_kernel<N>,
                                                         PM_THREADS, smem);
  bwd_premul_kernel<N><<<pm_grid(d, N, n_tiles), PM_THREADS, smem, stream>>>(
      maps[0], maps[1], (const bf16*)y, (const bf16*)H0, dst, rev, ptr, tiles, (bf16*)G,
      (bf16*)z, (bf16*)gz_out, n_edges, d, pad_node, n_tiles, stages);
  return cudaGetLastError();
}

static cudaError_t pm_dispatch(int n, const CUtensorMap* maps, const void* y, const void* H0,
                               const int* dst, const int* rev, const int* ptr, const int* tiles,
                               void* G, void* z, void* gz_out, int n_edges, int d, int pad_node,
                               int n_tiles, cudaStream_t stream, int* blocks_per_sm = nullptr) {
  switch (n) {
    case 128: return pm_launch<128>(maps, y, H0, dst, rev, ptr, tiles, G, z, gz_out, n_edges, d, pad_node, n_tiles, stream, blocks_per_sm);
    case 64: return pm_launch<64>(maps, y, H0, dst, rev, ptr, tiles, G, z, gz_out, n_edges, d, pad_node, n_tiles, stream, blocks_per_sm);
  }
  return cudaErrorInvalidValue;
}

// the number of tiles the kernel walks: the table's, or fixed runs of PM_TILE rows
static int pm_tiles(int n_edges, int n_table) {
  return n_table > 0 ? n_table : (n_edges + PM_TILE - 1) / PM_TILE;
}

// From G_in, y (and H0, or null) bf16 [n_edges x d] and W [d x d] in (in,
// out) layout, d a multiple of 128 up to MAX_WIDTH:
// * with a tile table of n_table tiles (ascending row offsets from 0 to
//   n_edges, at most 128 rows each, no molecule in two tiles): G and z;
// * with tiles null (n_table 0): z, and gz into gz_out (null without H0:
//   then z is gz); the caller forms G from gz with bwd_message;
// * with a split table (a molecule cut at its nodes' boundaries) and gz_out
//   (or z, without H0): G at every row that reads only its tile, z, and gz;
//   the caller forms G at the other rows with bwd_message_rows
//   (message_bwd.cu).
extern "C" int bwd_premul(const void* G_in, const void* y, const void* H0, const void* W,
                          const int* dst, const int* rev, const int* ptr, const int* tiles,
                          void* G, void* z, void* gz_out, int n_edges, int d, int pad_node,
                          int n_table, cudaStream_t stream) {
  if (d % 128 != 0 || d > MAX_WIDTH || n_edges < 0) return (int)cudaErrorInvalidValue;
  if ((tiles == nullptr) != (n_table == 0) || (tiles != nullptr && G == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_edges == 0) return 0;
  const int n = pm_width(d);
  if (n == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];  // W, G_in
  if (!bf16_table_map(&maps[0], W, d, d, 64) || !bf16_table_map(&maps[1], G_in, n_edges, d, 64))
    return (int)cudaErrorInvalidValue;
  return (int)pm_dispatch(n, maps, y, H0, dst, rev, ptr, tiles, G, z, gz_out, n_edges, d,
                          pad_node, pm_tiles(n_edges, n_table), stream);
}

// the launch's shape at width d over n_tiles tiles, into info[0..5]: slice
// width N, slices, stages, shared-memory bytes per block, blocks of the grid,
// and blocks of the kernel that one SM runs at once
extern "C" int bwd_premul_info(int d, int n_tiles, int* info) {
  const int n = d % 128 == 0 && d <= MAX_WIDTH ? pm_width(d) : 0;
  if (n == 0 || n_tiles <= 0) return (int)cudaErrorInvalidValue;
  info[0] = n;
  info[1] = d / n;
  info[2] = pm_stages(d, n);
  info[3] = (int)pm_smem(d, n, info[2]);
  info[4] = pm_grid(d, n, n_tiles);
  return (int)pm_dispatch(n, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, nullptr, nullptr, 0, d, 0, n_tiles, nullptr, &info[5]);
}
