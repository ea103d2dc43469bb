// What the kernels over the molecule tiles share: the producer warp's reading
// of a tile's ids (bwd_nodes.cu, kernel G, and message_bwd_tiles.cu, kernel
// F), the arithmetic on 16-byte chunks of float32 or bfloat16 rows, and the
// host's sizing of a launch of persistent blocks (message_tiles.cu, kernel
// A, too).
//
// The collate's tile table cuts the dst-sorted edge rows into tiles of at
// most TILE_ROWS rows with no molecule in two, so every rev[j], and every
// in-edge of dst[j], of a tile's row j lies in the tile. The producer warp
// reads a tile's dst and rev (a lane to TILE_Q rows: row lane + 32 q), finds
// the first row of each node by a ballot over dst (the rows of a node are
// contiguous: dst is sorted), and packs for each row its reverse and the
// in-edge range of its node as rows of the tile. A row of a node whose
// in-edges, or their reverses, are not all inside the tile is flagged
// TILE_BAD: its sum cannot be formed from the tile, and no read of it leaves
// the tile's rows.
#pragma once

#include <stdint.h>

#include "sm90.cuh"
#include "vec.cuh"

constexpr int TILE_ROWS = 128;           // the most rows a tile holds
constexpr int TILE_Q = TILE_ROWS / 32;   // rows a lane of the producer holds
constexpr uint32_t TILE_BAD = 1u << 24;  // id flag: a neighbour outside the tile
constexpr int TILE_SMEM_MAX = 232448;    // a block's shared memory on sm_90

// the grid of a launch of persistent blocks over `items` items: one block per
// SM (the stages take most of its shared memory), no more blocks than items
static inline int tile_grid(int items) { return items < sm_count() ? items : sm_count(); }

// the bytes of an element of a dtype code, 0 for another code
static inline int dtype_bytes(int dtype) {
  return dtype == DT_BF16 ? 2 : dtype == DT_F32 ? 4 : 0;
}

// the producer's view of one tile, in registers: lane l holds rows l + 32 q
struct TileRows {
  int v[TILE_Q];        // dst of the row, -1 past the real rows
  uint32_t m[TILE_Q];   // ballots: bit l of m[q] marks row l + 32 q as its node's first
  uint32_t id[TILE_Q];  // reverse | first in-edge << 8 | end << 16 (| TILE_BAD), tile rows
  int n_nodes;          // nodes that own real rows
};

// reads dst and rev of the tile's real rows [r0, r0 + real) (the rows
// before the first padding row; n_edges rows in all) and forms every row's
// packed id; all 32 lanes of the warp call it
__device__ __forceinline__ TileRows tile_rows(const int* __restrict__ dst,
                                              const int* __restrict__ rev, int r0, int real,
                                              int n_edges) {
  constexpr int Q = TILE_Q;
  const int lane = threadIdx.x % 32;
  TileRows t;
  int rv[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = lane + 32 * q;
    t.v[q] = i < real ? __ldg(dst + r0 + i) : -1;
    rv[q] = i < real ? __ldg(rev + r0 + i) - r0 : 0;
  }
  // the rows just outside the tile: a node whose in-edges go on past the
  // tile's real rows is not whole in it
  const int before = real > 0 && r0 > 0 ? __ldg(dst + r0 - 1) : -1;
  const int after = real > 0 && r0 + real < n_edges ? __ldg(dst + r0 + real) : -1;
  // a node's first row: the first row, or a row whose dst differs from the row before
  int prev_last = -1;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    int up = __shfl_up_sync(~0u, t.v[q], 1);
    if (lane == 0) up = prev_last;
    prev_last = __shfl_sync(~0u, t.v[q], 31);
    const int i = lane + 32 * q;
    t.m[q] = __ballot_sync(~0u, i < real && (i == 0 || t.v[q] != up));
  }
  // rows whose reverse is not in the tile
  uint32_t ob[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = lane + 32 * q;
    ob[q] = __ballot_sync(~0u, i < real && (rv[q] < 0 || rv[q] >= real));
  }
  const int v_first = __shfl_sync(~0u, t.v[0], 0);
  int v_last = -1;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int src = (real - 1) - 32 * q;
    const int x = __shfl_sync(~0u, t.v[q], src >= 0 && src < 32 ? src : 0);
    if (src >= 0 && src < 32) v_last = x;
  }
  const bool bad_first = before >= 0 && before == v_first;
  const bool bad_last = after >= 0 && after == v_last;
  t.n_nodes = 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) t.n_nodes += __popc(t.m[q]);

#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = lane + 32 * q;
    const uint32_t le = (2u << lane) - 1;  // bits 0 .. lane
    t.id[q] = 0;
    if (i < real) {
      // the in-edge range of this row's node: its last start at or
      // before i, and its next start after i (or the real rows' end)
      int lo = 0, hi = real;
      if (t.m[q] & le) {
        lo = 32 * q + 31 - __clz(t.m[q] & le);
      } else {
#pragma unroll
        for (int p = Q - 1; p >= 0; --p)
          if (p < q && lo == 0 && t.m[p] != 0) lo = 32 * p + 31 - __clz(t.m[p]);
      }
      if (t.m[q] & ~le) {
        hi = 32 * q + __ffs(t.m[q] & ~le) - 1;
      } else {
#pragma unroll
        for (int p = 0; p < Q; ++p)
          if (p > q && hi == real && t.m[p] != 0) hi = 32 * p + __ffs(t.m[p]) - 1;
      }
      // a reverse outside the tile is replaced by the row itself, so that
      // no read leaves the tile; every row of a node that sums such a
      // row's reverse ([lo, hi) holds one) is flagged, not only that row
      const bool outside = rv[q] < 0 || rv[q] >= real;
      bool node_bad = false;
#pragma unroll
      for (int p = 0; p < Q; ++p) {
        const int a = max(lo - 32 * p, 0), b = min(hi - 32 * p, 32);
        if (a < b) node_bad |= ((ob[p] >> a) & (b - a == 32 ? ~0u : (1u << (b - a)) - 1)) != 0;
      }
      const bool bad = node_bad || (lo == 0 && bad_first) || (hi == real && bad_last);
      t.id[q] = (uint32_t)(outside ? i : rv[q]) | (uint32_t)lo << 8 | (uint32_t)hi << 16 |
                (bad ? TILE_BAD : 0u);
    }
  }
  return t;
}

// each row's packed id into ids[0 .. real)
__device__ __forceinline__ void tile_store_ids(const TileRows& t, int real, uint32_t* ids) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < TILE_Q; ++q)
    if (lane + 32 * q < real) ids[lane + 32 * q] = t.id[q];
}

// the node list: node k owns rows [starts[k], starts[k + 1]) and is nodes[k];
// starts[n_nodes] = real
__device__ __forceinline__ void tile_store_nodes(const TileRows& t, int real, int* starts,
                                                 int* nodes) {
  const int lane = threadIdx.x % 32;
  const uint32_t le = (2u << lane) - 1;  // bits 0 .. lane
  int below = 0;  // nodes that start in the words before q
#pragma unroll
  for (int q = 0; q < TILE_Q; ++q) {
    if (t.m[q] >> lane & 1u) {
      const int k = below + __popc(t.m[q] & (le >> 1));
      starts[k] = lane + 32 * q;
      nodes[k] = t.v[q];
    }
    below += __popc(t.m[q]);
  }
  if (lane == 0) starts[t.n_nodes] = real;
}

// ------------------------------------------------------ 16-byte chunks
// t += a chunk in f32: 8 bf16 or 4 float32 values
__device__ __forceinline__ void add_chunk(float (&t)[8], uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack2(w[i]);
    t[2 * i] += f.x;
    t[2 * i + 1] += f.y;
  }
}

__device__ __forceinline__ void add_chunk(float (&t)[4], uint4 v) {
  t[0] += __uint_as_float(v.x);
  t[1] += __uint_as_float(v.y);
  t[2] += __uint_as_float(v.z);
  t[3] += __uint_as_float(v.w);
}

// t - x, rounded once to the chunk's type
__device__ __forceinline__ uint4 sub_chunk(const float (&t)[8], uint4 x) {
  const uint32_t xw[4] = {x.x, x.y, x.z, x.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 r = unpack2(xw[i]);
    o[i] = pack2(t[2 * i] - r.x, t[2 * i + 1] - r.y);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ uint4 sub_chunk(const float (&t)[4], uint4 x) {
  return make_uint4(__float_as_uint(t[0] - __uint_as_float(x.x)),
                    __float_as_uint(t[1] - __uint_as_float(x.y)),
                    __float_as_uint(t[2] - __uint_as_float(x.z)),
                    __float_as_uint(t[3] - __uint_as_float(x.w)));
}

template <typename T>
__device__ __forceinline__ uint4 nan_chunk() {
  return sizeof(T) == 2 ? make_uint4(0x7FC07FC0u, 0x7FC07FC0u, 0x7FC07FC0u, 0x7FC07FC0u)
                        : make_uint4(0x7FC00000u, 0x7FC00000u, 0x7FC00000u, 0x7FC00000u);
}

// g [y > 0] of one chunk, selected in f32 and rounded back: the bits of
// message_bwd.cu's mask4 and store4
template <typename T>
__device__ __forceinline__ uint4 mask_chunk(uint4 g, uint4 y) {
  const uint32_t gw[4] = {g.x, g.y, g.z, g.w}, yw[4] = {y.x, y.y, y.z, y.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 2) {
      const float2 a = unpack2(gw[i]), m = unpack2(yw[i]);
      o[i] = pack2(m.x > 0.f ? a.x : 0.f, m.y > 0.f ? a.y : 0.f);
    } else {
      o[i] = __float_as_uint(__uint_as_float(yw[i]) > 0.f ? __uint_as_float(gw[i]) : 0.f);
    }
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// a + b in f32, rounded once: message_bwd.cu's add4 and store4
template <typename T>
__device__ __forceinline__ uint4 add_chunks(uint4 a, uint4 b) {
  const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 2) {
      const float2 x = unpack2(aw[i]), y = unpack2(bw[i]);
      o[i] = pack2(x.x + y.x, x.y + y.y);
    } else {
      o[i] = __float_as_uint(__uint_as_float(aw[i]) + __uint_as_float(bw[i]));
    }
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// a chunk through f32 and back: message_bwd.cu's load4 and store4
template <typename T>
__device__ __forceinline__ uint4 round_chunk(uint4 a) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = unpack2(aw[i]);
      o[i] = pack2(x.x, x.y);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  } else {
    return a;
  }
}

// chunk ch of G's row i from a stage that holds gz (rows of CH chunks, one
// after another) and the tile's packed ids: the sum over the in-edges j of
// the row's node, in row order, of the rows ids[j] & 0xFF (their reverses),
// less the row's own reverse, in f32 from +0 and rounded once; the first
// four terms (most atoms have at most four neighbours) read at once. NaN for
// a row flagged TILE_BAD
template <typename T, int CH>
__device__ __forceinline__ uint4 transposed_chunk(const uint4* stage, const uint32_t* ids, int i,
                                                  int ch) {
  const uint32_t id = ids[i];
  if (id & TILE_BAD) return nan_chunk<T>();
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  const int lo = (id >> 8) & 0xFF, hi = (id >> 16) & 0xFF;
  uint4 v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = lo + q < hi ? stage[(ids[lo + q] & 0xFF) * CH + ch] : zero4;
  const uint4 x4 = stage[(id & 0xFF) * CH + ch];
  float t[16 / sizeof(T)];
#pragma unroll
  for (int e = 0; e < (int)(16 / sizeof(T)); ++e) t[e] = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (lo + q < hi) add_chunk(t, v[q]);
  for (int j = lo + 4; j < hi; ++j) add_chunk(t, stage[(ids[j] & 0xFF) * CH + ch]);
  return sub_chunk(t, x4);
}
