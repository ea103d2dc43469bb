// Sorted segment sum, optionally with per-segment row counts.
//
// Replaces the Pallas TPU kernel chemprop_tpu/ops/sorted_segments.py
// (_make_kernel, launched by _sorted_segment_sum_fwd_impl; its with_counts
// variant serves sorted_segment_sum_counts). There, each output tile of 256
// segments streams its contiguous row range through a deep pipeline of
// asynchronous copies, and one-hot products on the MXU reduce the rows into
// the tile. Here the rows are sorted by segment, so segment s is the rows
// [ptr[s], ptr[s+1]) and a sum over contiguous rows needs no one-hot product.
//
// Bound on the H100: bytes. Each input row is read once and each output row
// written once, with ids and ptr; there is one add per element. The sums are
// deterministic and free of atomics on the data: every segment is summed in
// row order in f32 and cast once on store.
//
// Design. The rows are cut into ranges of about R rows (R a power of two,
// from the row width and the mean segment), and a range, not a segment, is
// the unit of work: its rows are one contiguous stretch of memory, so one
// bulk copy (cp.async.bulk, counted on an mbarrier) brings the whole range
// into shared memory with no per-row address work. A range starts at the
// first "cut" at or after k R, a cut being the start of a segment or a
// multiple of R inside a segment of more than R rows ("long"). So a segment
// of at most R rows lies in one range, a range holds fewer than 2R rows, and
// a long segment is cut into pieces at the multiples of R: its piece in
// range m is in [m R, (m + 1) R).
//
// Persistent blocks of three roles. One producer warp finds the cuts of 32
// of its ranges at once (a lane each: ids, then ptr of the segment there);
// then for each range it issues the bulk copy into a ring of stages and
// writes the range's ids, and the first row of each of its pieces (ballots
// over the ids), beside it. Eight consumer warps wait for a stage and sum
// every piece from shared memory: a warp to a piece, its lanes over the
// columns, when a range holds eight pieces or more (the M_v readout: two
// rows a segment); else every thread over every piece, in two columns each
// (the mean readout: one or two molecules a range). A whole segment's row
// goes straight to out; a long segment's piece goes, in f32, to its range's
// slot in the scratch table (slot 0: the piece that continues the segment
// from the range before; slot 1: the piece that starts it) and onto a queue
// in shared memory. One reducer warp takes the queue: the pieces of a long
// segment are the leaves of a fixed tree (eight children to a node), and the
// warp that brings the last child of a node, found by a counter per node,
// adds the node's children in order; the root's sum is the segment's row. So
// the order never depends on which block ran first, and no consumer waits
// for another block. The counters are zero before a launch, and the warp
// that adds a node's children sets its counter back to zero. Empty segments
// and the counts come from ptr, grid-strided over the segments, while the
// first copies are in flight. The ranges are taken from the last to the
// first, so that the padding segments at the end of a batch, the longest,
// are added up early instead of at the end.
//
// A row width whose bytes are not a multiple of 16 (bfloat16 widths of
// 4 mod 8) cannot be bulk-copied at every row offset; those rows are read by
// the consumers from global memory in the same ranges and order.
#include "sm90.cuh"
#include "vec.cuh"

constexpr int SEG_CONSUMERS = 8;                      // consumer warps per block
constexpr int SEG_THREADS = 32 * (SEG_CONSUMERS + 2);  // and a producer and a reducer warp
constexpr int SEG_MAX_RANGE = 64;                     // the largest R
constexpr int SEG_MAX_IDS = 2 * SEG_MAX_RANGE + 1;    // ids of a stage: rows a - 1 .. b
constexpr int SEG_QUEUE = 64;                         // long pieces waiting for the reducer
constexpr int SEG_FAN_IN = 8;                         // children of a node of the tree
constexpr int SEG_SMEM_LIMIT = 232448;
constexpr int SEG_DEVICES = 16;  // devices whose launch settings are kept

// the shared memory of a block: per stage a full and an empty barrier and a
// header (range index, first and end row, pieces); the queue of long pieces
// (segment, range) with its head, tail and end flag; per stage the ids of
// rows a - 1 .. b (-1 outside the table), the first row of each piece and,
// when staged, room for 2 R - 1 rows
struct SegLayout {
  int queue, sids, ids_stride, starts, data, data_stride, bytes;
};

__host__ __device__ inline SegLayout seg_layout(int R, int S, int staged_row_bytes) {
  SegLayout L;
  L.queue = 32 * S;
  L.sids = L.queue + 8 * SEG_QUEUE + 16;
  L.ids_stride = (2 * R + 1 + 3) & ~3;
  L.starts = L.sids + 4 * L.ids_stride * S;  // per stage: the rows where its pieces start
  L.data = (L.starts + 4 * 2 * R * S + 127) & ~127;
  L.data_stride = 2 * R * staged_row_bytes;
  L.bytes = L.data + S * L.data_stride;
  return L;
}

// the first cut at or after row k R: k R itself when a segment starts there
// or it lies inside a long segment, else the end of the short segment there
__device__ __forceinline__ int seg_cut(const int* __restrict__ ids, const int* __restrict__ ptr,
                                       int k, int R, int n) {
  const long long r = (long long)k * R;
  if (r >= n) return n;
  if (r == 0) return 0;
  const int s = __ldg(ids + r);
  if (__ldg(ids + r - 1) != s) return (int)r;
  const int p = __ldg(ptr + s), q = __ldg(ptr + s + 1);
  return q - p > R ? (int)r : q;
}

// two columns of a row as f32, and back
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

// the producer warp: cuts, then per range its bulk copy and its ids; the ids
// of the next range are loaded while the warp waits for a free stage
template <bool STAGED>
__device__ void seg_produce(const uint8_t* __restrict__ data, const int* __restrict__ ids,
                            const int* __restrict__ ptr, uint8_t* smem, const SegLayout& L,
                            int n, int n_ranges, int R, int S, int row_bytes) {
  constexpr int NI = (SEG_MAX_IDS + 31) / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t bars = smem_addr(smem);
  int* hdr = reinterpret_cast<int*>(smem + 16 * S);
  int* sids = reinterpret_cast<int*>(smem + L.sids);
  int* starts = reinterpret_cast<int*>(smem + L.starts);
  int c = 0;  // ranges issued by this block
  for (int base = blockIdx.x; base < n_ranges; base += 32 * gridDim.x) {
    const int mine = base + lane * gridDim.x;
    int k = 0, a = 0, b = 0;
    if (mine < n_ranges) {  // the ranges are taken from the last
      k = n_ranges - 1 - mine;
      a = seg_cut(ids, ptr, k, R, n);
      b = seg_cut(ids, ptr, k + 1, R, n);
      b = min(max(b, a), a + 2 * R - 1);  // holds for ids and ptr that agree; a stage's rows
    }
    const int count = min(32, (n_ranges - base + (int)gridDim.x - 1) / (int)gridDim.x);
    int v[NI], aj = 0, bj = 0;
    auto load_ids = [&](int j) {  // rows a - 1 .. b of range j, -1 outside the table
      aj = __shfl_sync(~0u, a, j);
      bj = __shfl_sync(~0u, b, j);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int t = lane + 32 * i, r = aj - 1 + t;
        v[i] = t <= bj - aj + 1 && r >= 0 && r < n ? __ldg(ids + r) : -1;
      }
    };
    load_ids(0);
    for (int j = 0; j < count; ++j, ++c) {
      const int s = c % S, kj = __shfl_sync(~0u, k, j), a0 = aj, b0 = bj;
      if (c >= S) mbar_wait(bars + 8 * (S + s), (c / S - 1) & 1);
      // entry t of the ids is row t - 1: a piece starts at row 0 and at
      // every row whose id differs from the row before
      int pieces = 0, prev = -2;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int t = lane + 32 * i;
        if (t <= b0 - a0 + 1) sids[s * L.ids_stride + t] = v[i];
        int up = __shfl_up_sync(~0u, v[i], 1);
        if (lane == 0) up = prev;
        prev = __shfl_sync(~0u, v[i], 31);
        const bool start = t >= 1 && t <= b0 - a0 && (t == 1 || v[i] != up);
        const uint32_t m = __ballot_sync(~0u, start);
        if (start) starts[s * 2 * R + pieces + __popc(m & ((1u << lane) - 1))] = t - 1;
        pieces += __popc(m);
      }
      if (lane == 0) {
        hdr[4 * s] = kj;
        hdr[4 * s + 1] = a0;
        hdr[4 * s + 2] = b0;
        hdr[4 * s + 3] = pieces;
        const uint32_t bytes = STAGED ? (uint32_t)(b0 - a0) * row_bytes : 0;
        mbar_arrive_expect_tx(bars + 8 * s, bytes);
        if (bytes > 0)
          bulk_load(smem_addr(smem + L.data + s * L.data_stride), data + (size_t)a0 * row_bytes,
                    bytes, bars + 8 * s);
      } else {
        mbar_arrive(bars + 8 * s);
      }
      if (j + 1 < count) load_ids(j + 1);
    }
  }
}

// the columns of consumer thread i: 2 i and 2 i + 1, and 512 further on
constexpr int SEG_COL_STEP = 2 * 32 * SEG_CONSUMERS;

// a consumer thread's sum of rows [t0, t1) of a range, in its columns
template <typename Tin>
__device__ __forceinline__ void seg_rows(float2 (&acc)[2], const Tin* rows, int t0, int t1, int d,
                                         int col) {
  acc[0] = acc[1] = make_float2(0.f, 0.f);
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = col + SEG_COL_STEP * u;
      if (c < d) {
        const float2 x = load2(rows + (size_t)t * d + c);
        acc[u].x += x.x;
        acc[u].y += x.y;
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void seg_store(T* row, const float2 (&acc)[2], int d, int col) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = col + SEG_COL_STEP * u;
    if (c < d) store2(row + c, acc[u]);
  }
}

// the consumer warps: empty segments and counts, then every range of the
// block; the long pieces go onto the reducer's queue
template <typename Tin, typename Tout, bool STAGED>
__device__ void seg_consume(const Tin* __restrict__ data, const int* __restrict__ ptr,
                            Tout* __restrict__ out, float* __restrict__ counts, float* scratch,
                            uint8_t* smem, const SegLayout& L, int n_seg, int n_ranges, int R,
                            int S, int d) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32 - 1, col = 2 * (threadIdx.x - 32);
  const int nv = d >> 2;
  {  // empty segments get zeros, every segment its count
    float4 zeros[MAXV];
    zero(zeros);
    const int step = 32 * SEG_CONSUMERS * gridDim.x;
    for (int s0 = 32 * (SEG_CONSUMERS * blockIdx.x + w); s0 < n_seg; s0 += step) {
      const int s = s0 + lane;
      int len = -1;
      if (s < n_seg) len = __ldg(ptr + s + 1) - __ldg(ptr + s);
      if (counts != nullptr && s < n_seg) counts[s] = (float)len;
      for (uint32_t e = __ballot_sync(~0u, len == 0); e != 0; e &= e - 1)
        store_row(out + (size_t)(s0 + __ffs(e) - 1) * d, zeros, lane, d >> 2);
    }
  }
  const uint32_t bars = smem_addr(smem);
  const int* hdr = reinterpret_cast<const int*>(smem + 16 * S);
  int* queue = reinterpret_cast<int*>(smem + L.queue);
  volatile int* qctl = queue + 2 * SEG_QUEUE;  // head, tail, end
  int head = 0, c = 0;
  for (int mine = blockIdx.x; mine < n_ranges; mine += gridDim.x, ++c) {
    const int st = c % S;
    mbar_wait(bars + 8 * st, (c / S) & 1);
    const int k = hdr[4 * st], a = hdr[4 * st + 1], len = hdr[4 * st + 2] - a;
    const int n_pieces = hdr[4 * st + 3];
    const int* sid = reinterpret_cast<const int*>(smem + L.sids) + st * L.ids_stride;
    const int* first = reinterpret_cast<const int*>(smem + L.starts) + st * 2 * R;
    const Tin* rows = STAGED ? reinterpret_cast<const Tin*>(smem + L.data + st * L.data_stride)
                             : data + (size_t)a * d;
    // piece j is rows [first[j], first[j + 1]) (the last ends at len), one
    // segment's; only the first may continue a long segment, and only the
    // last may go on past the range. Its row goes to out, or to the range's
    // slot: slot 0 for a piece that continues a segment, else slot 1
    bool wrote_long = false;
    auto target = [&](int j, int t0) -> float* {
      const int s = sid[t0 + 1];
      const bool before = j == 0 && sid[0] == s, after = j == n_pieces - 1 && sid[len + 1] == s;
      wrote_long |= before || after;
      return before || after ? scratch + (size_t)(2 * k + (before ? 0 : 1)) * d : nullptr;
    };
    if (n_pieces >= SEG_CONSUMERS) {  // many pieces: a warp each, its lanes over the columns
      for (int j = w; j < n_pieces; j += SEG_CONSUMERS) {
        const int t0 = first[j], t1 = j + 1 < n_pieces ? first[j + 1] : len;
        float4 acc[MAXV];
        zero(acc);
#pragma unroll 4
        for (int t = t0; t < t1; ++t) add_row(acc, rows + (size_t)t * d, lane, nv, false);
        float* slot = target(j, t0);
        if (slot != nullptr)
          store_row(slot, acc, lane, nv);
        else
          store_row(out + (size_t)sid[t0 + 1] * d, acc, lane, nv);
      }
    } else {  // a few: every thread sums every piece, in two columns
      for (int j = 0; j < n_pieces; ++j) {
        const int t0 = first[j], t1 = j + 1 < n_pieces ? first[j + 1] : len;
        float2 acc[2];
        seg_rows(acc, rows, t0, t1, d, col);
        float* slot = target(j, t0);
        if (slot != nullptr)
          seg_store(slot, acc, d, col);
        else
          seg_store(out + (size_t)sid[t0 + 1] * d, acc, d, col);
      }
    }
    if (wrote_long) __threadfence();  // the pieces, before the reducer counts them
    asm volatile("bar.sync 1, %0;" ::"n"(32 * SEG_CONSUMERS) : "memory");  // the stage is read
    if (threadIdx.x == 32) {
      // the range's long pieces: its first piece if it continues a segment,
      // its last if it goes on (one piece if the range lies inside a
      // segment), read before the stage goes back to the producer
      int pieces[2], m = 0;
      if (len > 0 && sid[0] == sid[1]) pieces[m++] = sid[1];
      if (len > 0 && sid[len + 1] == sid[len] && !(m == 1 && sid[len] == sid[1]))
        pieces[m++] = sid[len];
      mbar_arrive(bars + 8 * (S + st));
      for (int i = 0; i < m; ++i, ++head) {
        while (head - qctl[1] >= SEG_QUEUE) __nanosleep(64);  // the queue is full
        queue[2 * (head % SEG_QUEUE)] = pieces[i];
        queue[2 * (head % SEG_QUEUE) + 1] = k;
        __threadfence_block();
        qctl[0] = head + 1;
      }
    }
  }
  if (threadIdx.x == 32) {
    __threadfence_block();
    qctl[2] = 1;
  }
}

// the scratch row of a tree node: its first piece's slot (slot 1 of the
// segment's first range, slot 0 of any other)
__device__ __forceinline__ size_t seg_slot(int k0, int first_piece) {
  return (size_t)(2 * (k0 + first_piece) + (first_piece == 0 ? 1 : 0));
}

// the reducer warp. Node j of level l + 1 of segment s's tree spans pieces
// [8^(l+1) j, 8^(l+1) (j + 1)), its children are nodes 8 j .. 8 j + 7 of level
// l (level 0: the pieces), and its sum is kept in its first piece's slot;
// its counter is counters[2 l n_ranges + that slot] (a range may hold the
// last piece of one segment and the first of the next: the slots differ)
template <typename Tout>
__device__ void seg_reduce(const int* __restrict__ ptr, Tout* __restrict__ out, float* scratch,
                           int* __restrict__ counters, uint8_t* smem, const SegLayout& L,
                           int n_ranges, int R, int d) {
  const int lane = threadIdx.x % 32, nv = d >> 2;
  const int* queue = reinterpret_cast<const int*>(smem + L.queue);
  volatile int* qctl = reinterpret_cast<int*>(smem + L.queue) + 2 * SEG_QUEUE;
  int tail = 0;
  while (true) {
    const int end = qctl[2];
    __threadfence_block();
    const int head = qctl[0];
    if (head == tail) {
      if (end) break;
      __nanosleep(128);
      continue;
    }
    __threadfence_block();
    const int got = min(head - tail, 32);
    int s = 0, k = 0, p = 0, q = 0, last = 0;
    if (lane < got) {
      s = queue[2 * ((tail + lane) % SEG_QUEUE)];
      k = queue[2 * ((tail + lane) % SEG_QUEUE) + 1];
      p = __ldg(ptr + s);
      q = __ldg(ptr + s + 1);
    }
    __syncwarp();
    tail += got;
    if (lane == 0) qctl[1] = tail;
    // the consumers' stores of these pieces, before the counts that publish
    // them; each lane's piece arrives at its node of level 1
    __threadfence();
    if (lane < got) {
      const int k0 = p / R, np = (q - 1) / R - k0 + 1, first = (k - k0) / SEG_FAN_IN * SEG_FAN_IN;
      int* cnt = counters + seg_slot(k0, first);
      last = atomicAdd(cnt, 1) == min(np - first, SEG_FAN_IN) - 1;
      if (last) *cnt = 0;  // zero again for the next launch
    }
    // the lanes that brought a node's last child: the warp adds the node up
    // for each, and goes on up while it brings the last child of the next
    for (uint32_t ready = __ballot_sync(~0u, last); ready != 0; ready &= ready - 1) {
      const int src = __ffs(ready) - 1;
      const int ss = __shfl_sync(~0u, s, src), pp = __shfl_sync(~0u, p, src);
      const int qq = __shfl_sync(~0u, q, src), kk = __shfl_sync(~0u, k, src);
      const int k0 = pp / R, np = (qq - 1) / R - k0 + 1;
      int level = 0, span = SEG_FAN_IN, j = (kk - k0) / SEG_FAN_IN;
      __threadfence();
      while (true) {
        const int child_span = span / SEG_FAN_IN, first = j * SEG_FAN_IN;
        const int kids = min((np + child_span - 1) / child_span - first, SEG_FAN_IN);
        float4 acc[MAXV];
        zero(acc);
#pragma unroll
        for (int jj = 0; jj < MAXV; ++jj) {
          const int v = lane + 32 * jj;
          if (v < nv) {
            float4 x[SEG_FAN_IN];  // the children's loads in flight together
#pragma unroll
            for (int e = 0; e < SEG_FAN_IN; ++e)
              if (e < kids)
                x[e] = __ldcg(reinterpret_cast<const float4*>(
                    scratch + seg_slot(k0, (first + e) * child_span) * d + 4 * v));
#pragma unroll
            for (int e = 0; e < SEG_FAN_IN; ++e)
              if (e < kids) add4(acc[jj], x[e]);
          }
        }
        if (span >= np) {  // the root: the segment's row
          store_row(out + (size_t)ss * d, acc, lane, nv);
          break;
        }
        store_row(scratch + seg_slot(k0, j * span) * d, acc, lane, nv);
        __threadfence();
        const int up = j / SEG_FAN_IN * SEG_FAN_IN;  // the first sibling at this level
        const int up_kids = min((np + span - 1) / span - up, SEG_FAN_IN);
        ++level;
        int done = 0;
        if (lane == 0) {
          int* cnt = counters + (size_t)level * 2 * n_ranges + seg_slot(k0, up * span);
          done = atomicAdd(cnt, 1) == up_kids - 1;
          if (done) *cnt = 0;
        }
        if (!__shfl_sync(~0u, done, 0)) break;
        __threadfence();
        j /= SEG_FAN_IN;
        span *= SEG_FAN_IN;
      }
    }
  }
}

template <typename Tin, typename Tout, bool STAGED>
__global__ void __launch_bounds__(SEG_THREADS, 2)
    seg_kernel(const Tin* __restrict__ data, const int* __restrict__ ids,
               const int* __restrict__ ptr, Tout* __restrict__ out, float* __restrict__ counts,
               float* scratch, int* __restrict__ counters, int n, int n_seg, int d, int R, int S) {
  extern __shared__ __align__(128) uint8_t smem[];
  const SegLayout L = seg_layout(R, S, STAGED ? d * (int)sizeof(Tin) : 0);
  const int n_ranges = (n + R - 1) / R;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_addr(smem) + 8 * s, 32);       // the producer's lanes, and the copy
      mbar_init(smem_addr(smem) + 8 * (S + s), 1);  // the consumers, once all are done
    }
    int* qctl = reinterpret_cast<int*>(smem + L.queue) + 2 * SEG_QUEUE;
    qctl[0] = qctl[1] = qctl[2] = 0;
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  if (warp == 0)
    seg_produce<STAGED>(reinterpret_cast<const uint8_t*>(data), ids, ptr, smem, L, n, n_ranges,
                        R, S, d * (int)sizeof(Tin));
  else if (warp <= SEG_CONSUMERS)
    seg_consume<Tin, Tout, STAGED>(data, ptr, out, counts, scratch, smem, L, n_seg, n_ranges, R,
                                   S, d);
  else
    seg_reduce<Tout>(ptr, out, scratch, counters, smem, L, n_ranges, R, d);
}

// the launch's shared memory, grid and co-resident blocks per SM into info
// when it is not null, else the launch
template <typename Tin, typename Tout, bool STAGED>
static cudaError_t seg_launch(const void* data, const int* ids, const int* ptr, void* out,
                              float* counts, float* scratch, int* counters, int n, int n_seg,
                              int d, int R, int S, cudaStream_t stream, int* info) {
  const SegLayout L = seg_layout(R, S, STAGED ? d * (int)sizeof(Tin) : 0);
  if (L.bytes > SEG_SMEM_LIMIT) return cudaErrorInvalidValue;
  auto kernel = seg_kernel<Tin, Tout, STAGED>;
  // the opt-in above 48 KB and the occupancy, asked once per device and
  // size: a query at every launch costs more host time than the kernel takes
  static int opted[SEG_DEVICES] = {}, sized[SEG_DEVICES] = {}, blocks[SEG_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= SEG_DEVICES) return cudaErrorInvalidDevice;
  if (L.bytes > opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (err != cudaSuccess) return err;
    opted[dev] = L.bytes;
  }
  if (L.bytes != sized[dev]) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[dev], kernel, SEG_THREADS,
                                                        L.bytes);
    if (err != cudaSuccess) return err;
    sized[dev] = L.bytes;
  }
  const int per_sm = blocks[dev];
  if (per_sm < 1) return cudaErrorInvalidValue;
  // enough blocks for the ranges, and for the empty segments' pass
  const int n_ranges = (n + R - 1) / R;
  const int seg_blocks = (n_seg + 32 * SEG_CONSUMERS - 1) / (32 * SEG_CONSUMERS);
  int grid = n_ranges > seg_blocks ? n_ranges : seg_blocks;
  if (grid > per_sm * sm_count()) grid = per_sm * sm_count();
  if (grid < 1) grid = 1;
  if (info != nullptr) {
    info[0] = L.bytes;
    info[1] = grid;
    info[2] = per_sm;
    info[3] = STAGED;
    return cudaSuccess;
  }
  kernel<<<grid, SEG_THREADS, L.bytes, stream>>>((const Tin*)data, ids, ptr, (Tout*)out, counts,
                                                 scratch, counters, n, n_seg, d, R, S);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
static cudaError_t seg_dispatch(const void* data, const int* ids, const int* ptr, void* out,
                                float* counts, float* scratch, int* counters, int n, int n_seg,
                                int d, int R, int S, cudaStream_t stream, int* info) {
  if (d * sizeof(Tin) % 16 == 0)
    return seg_launch<Tin, Tout, true>(data, ids, ptr, out, counts, scratch, counters, n, n_seg,
                                       d, R, S, stream, info);
  return seg_launch<Tin, Tout, false>(data, ids, ptr, out, counts, scratch, counters, n, n_seg,
                                      d, R, S, stream, info);
}

static int seg_run(const void* data, const int* ids, const int* ptr, void* out, float* counts,
                   float* scratch, int* counters, int n, int n_seg, int d, int R, int S,
                   int in_dtype, int out_dtype, cudaStream_t stream, int* info) {
  if (d % 4 != 0 || d > MAX_WIDTH || n < 0 || n_seg < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  if (R < 1 || R > SEG_MAX_RANGE || (R & (R - 1)) != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (in_dtype == DT_F32 && out_dtype == DT_F32)
    err = seg_dispatch<float, float>(data, ids, ptr, out, counts, scratch, counters, n, n_seg, d,
                                     R, S, stream, info);
  else if (in_dtype == DT_BF16 && out_dtype == DT_F32)
    err = seg_dispatch<bf16, float>(data, ids, ptr, out, counts, scratch, counters, n, n_seg, d,
                                    R, S, stream, info);
  else if (in_dtype == DT_BF16 && out_dtype == DT_BF16)
    err = seg_dispatch<bf16, bf16>(data, ids, ptr, out, counts, scratch, counters, n, n_seg, d,
                                   R, S, stream, info);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

// out[s] = sum of data rows [ptr[s], ptr[s+1]) for s < n_seg, cast to out's
// dtype; counts[s] = ptr[s+1] - ptr[s] when counts is not null. The dtype
// pairs are those of the readouts: f32 -> f32, bf16 -> bf16 (M_v) and
// bf16 -> f32 (by graph). R (rows per range, a power of two up to 64) and S
// (stages) come from the caller. scratch holds 2 ceil(n / R) f32 rows of
// width d; counters levels x 2 ceil(n / R) ints, 8^levels >= ceil(n / R),
// that are zero, and are zero again after the launch.
extern "C" int seg_sum(const void* data, const int* ids, const int* ptr, void* out,
                       float* counts, float* scratch, int* counters, int n_rows, int n_seg, int d,
                       int range_rows, int stages, int in_dtype, int out_dtype,
                       cudaStream_t stream) {
  return seg_run(data, ids, ptr, out, counts, scratch, counters, n_rows, n_seg, d, range_rows,
                 stages, in_dtype, out_dtype, stream, nullptr);
}

// the launch's shape, into info[0..3]: shared-memory bytes per block, blocks
// of the grid, blocks one SM runs at once, and whether rows are bulk-copied
extern "C" int seg_sum_info(int n_rows, int n_seg, int d, int range_rows, int stages,
                            int in_dtype, int out_dtype, int* info) {
  return seg_run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, n_rows, n_seg, d,
                 range_rows, stages, in_dtype, out_dtype, nullptr, info);
}
