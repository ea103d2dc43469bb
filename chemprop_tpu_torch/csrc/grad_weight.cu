// The weight gradient of a dense layer over an edge table: dW = X^T G,
// [n x dx]^T [n x dg] -> [dx x dg] in float32 from bfloat16 tables.
//
// grad_weight replaces the Pallas TPU kernel _kernel of
// chemprop_tpu/ops/grad_weight.py (launched by grad_weight there). The TPU
// kernel walks the rows as one sequential grid and keeps the whole [dx x dg]
// accumulator in VMEM. Here blocks run in parallel and a [384 x 384] float32
// accumulator (590 KB) fits no block, so the rows are split and the output
// cut into 128 x BN tiles (gw_bn: 192 at [384 x 384], so six tiles; 128 at
// W_i's [128 x 384], three). One wave of blocks, one per SM, walks the
// (tile, split) items, tiles of a split next to each other (6 x 22 at
// [n x 384]^T [n x 384], 3 x 44 at W_i's [n x 128]^T [n x 384]), and writes
// each item's tile of its split's partial sum; a second launch adds the
// partials in a fixed order. The partition depends on the shapes and the
// card alone and there are no atomics, so the result is the same bit for bit
// in every run.
//
// It is bound by bytes: X and G read once (190 MB at [123,392 x 384]) take
// 57 us at 3.35 TB/s, the 36 GFLOP two thirds of that on the tensor cores at
// their peak. So the copies must never wait for the products, nor the
// products for the copies: one producer warp keeps a ring of GW_STAGES
// 64-row stages in flight with TMA (128-byte swizzle; rows past n arrive as
// zeros, so the ragged tail needs no branch), and two consumer warpgroups
// run wgmma on the stage that has landed, each 64 rows of the tile with the
// 64 x BN accumulator in registers. X^T is wgmma's MN-major A operand, read
// straight from the X tile (the transpose flag), so it is never formed.
// Each strip of X is read by dg / BN blocks and each strip of G by dx / 128;
// the later reads come from L2, the blocks sharing a split running together.
#include "sm90.cuh"
#include "vec.cuh"

constexpr int GW_ROWS = 64;                 // table rows per stage
constexpr int GW_BM = 128;                  // output rows per tile: two warpgroups of 64
constexpr int GW_BOX = 64;                  // columns per TMA box: the swizzle's 128 bytes
constexpr int GW_BOX_BYTES = GW_ROWS * GW_BOX * 2;
constexpr int GW_STAGES = 4;
constexpr int GW_THREADS = 2 * 128 + 32;    // two consumer warpgroups, one producer warp

template <int BN>
__device__ __forceinline__ void wgmma_rows16(float (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 256) wgmma_m64n256k16(d, a, b);
  else if constexpr (BN == 192) wgmma_m64n192k16(d, a, b);
  else wgmma_m64n128k16(d, a, b);
}

template <int BN>
constexpr int gw_smem_bytes() {
  // the stages, their full and empty barriers, and room to align to 1024
  return GW_STAGES * (GW_BM + BN) / GW_BOX * GW_BOX_BYTES + 2 * GW_STAGES * 8 + 1024;
}

// item t + tiles * s: output tile t of dx / 128 x dg / BN (row tiles
// fastest) over the 64-row steps [s * steps_per_split, min(n_steps,
// (s + 1) * steps_per_split)); block b takes items b, b + gridDim.x, ...
template <int BN>
__global__ void __launch_bounds__(GW_THREADS, 1)
    grad_weight_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tg, float* __restrict__ partial,
                       int dx, int dg, int n_steps, int steps_per_split, int splits) {
  constexpr int XB = GW_BM / GW_BOX, GB = BN / GW_BOX;
  constexpr uint32_t STAGE_BYTES = (XB + GB) * GW_BOX_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + GW_STAGES * STAGE_BYTES, empty = full + 8 * GW_STAGES;

  const int row_tiles = dx / GW_BM, tiles = row_tiles * (dg / BN), items = tiles * splits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GW_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's arrival, then the bytes
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  // k counts the block's steps over all its items: stage k % GW_STAGES, in
  // its (k / GW_STAGES)-th round
  if (warp == 8) {  // the producer
    if (lane == 0) {
      tma_prefetch_map(&tx);
      tma_prefetch_map(&tg);
      int k = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int m0 = (item % tiles % row_tiles) * GW_BM, n0 = (item % tiles / row_tiles) * BN;
        const int s0 = item / tiles * steps_per_split;
        for (int step = s0; step < min(n_steps, s0 + steps_per_split); ++step, ++k) {
          const int s = k % GW_STAGES;
          if (k >= GW_STAGES) mbar_wait(empty + 8 * s, (k / GW_STAGES - 1) & 1);
          const uint32_t stage = base + s * STAGE_BYTES, bar = full + 8 * s;
          mbar_arrive_expect_tx(bar, STAGE_BYTES);
#pragma unroll
          for (int b = 0; b < XB; ++b)
            tma_load_2d(stage + b * GW_BOX_BYTES, &tx, bar, m0 + b * GW_BOX, step * GW_ROWS);
#pragma unroll
          for (int b = 0; b < GB; ++b)
            tma_load_2d(stage + (XB + b) * GW_BOX_BYTES, &tg, bar, n0 + b * GW_BOX, step * GW_ROWS);
        }
      }
    }
  } else {
    // a consumer warpgroup: output rows m0 + 64 wg of the tile, from the wg-th
    // X box of each stage (A) and all of its G boxes (B); 16 rows per wgmma,
    // 2048 bytes into each box
    const int wg = warp / 4, t = threadIdx.x % 128;
    int k = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int m0 = (item % tiles % row_tiles) * GW_BM, n0 = (item % tiles / row_tiles) * BN;
      const int s0 = item / tiles * steps_per_split;
      float d[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
      for (int step = s0; step < min(n_steps, s0 + steps_per_split); ++step, ++k) {
        const int s = k % GW_STAGES;
        mbar_wait(full + 8 * s, (k / GW_STAGES) & 1);
        const uint32_t a = base + s * STAGE_BYTES + wg * GW_BOX_BYTES;
        const uint32_t b = base + s * STAGE_BYTES + XB * GW_BOX_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GW_ROWS / 16; ++kk)
          wgmma_rows16<BN>(d, desc_mn_sw128(a + kk * 2048, GW_BOX_BYTES, 1024),
                           desc_mn_sw128(b + kk * 2048, GW_BOX_BYTES, 1024));
        wgmma_commit();
        // the previous step's products are done: its stage goes back to the producer
        wgmma_wait<1>();
        if (k > 0 && t == 0) mbar_arrive(empty + 8 * ((k - 1) % GW_STAGES));
      }
      wgmma_wait<0>();

      float* tile = partial + (size_t)(item / tiles) * dx * dg;
      const int r = m0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4, c = n0 + 2 * (t % 4);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        *reinterpret_cast<float2*>(tile + (size_t)r * dg + c + 8 * j) = make_float2(d[4 * j], d[4 * j + 1]);
        *reinterpret_cast<float2*>(tile + (size_t)(r + 8) * dg + c + 8 * j) =
            make_float2(d[4 * j + 2], d[4 * j + 3]);
      }
    }
  }
}

// out = the sum of the splits' partials. Four lanes share a float4 of out:
// lane r adds the r-th quarter of the splits in order, eight loads in
// flight, and the four sums are added in the order of r
__global__ void grad_weight_reduce(const float* __restrict__ partial, float* __restrict__ out,
                                   int splits, int size) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = idx / 4 * 4, r = idx % 4, per = (splits + 3) / 4;
  const int s0 = min(splits, r * per), s1 = min(splits, s0 + per);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < size) {
    int s = s0;
    for (; s + 8 <= s1; s += 8) {
      float4 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = __ldcs(reinterpret_cast<const float4*>(partial + (size_t)(s + j) * size + i));
#pragma unroll
      for (int j = 0; j < 8; ++j) add4(acc, v[j]);
    }
    for (; s < s1; ++s) add4(acc, __ldcs(reinterpret_cast<const float4*>(partial + (size_t)s * size + i)));
  }
  // lane r = 0 of each four: ((q0 + q1) + q2) + q3
#pragma unroll
  for (int q = 1; q < 4; ++q) {
    float4 v;
    v.x = __shfl_down_sync(0xffffffffu, acc.x, q, 4);
    v.y = __shfl_down_sync(0xffffffffu, acc.y, q, 4);
    v.z = __shfl_down_sync(0xffffffffu, acc.z, q, 4);
    v.w = __shfl_down_sync(0xffffffffu, acc.w, q, 4);
    if (r == 0) add4(acc, v);
  }
  if (r == 0 && i < size) store4(out + i, acc);
}

// [rows x width] row-major bf16 at T, in boxes of 64 columns x GW_ROWS rows
static bool table_map(CUtensorMap* map, const void* T, int rows, int width) {
  return bf16_table_map(map, T, rows, width, GW_ROWS);
}

// the widest of 256, 192, 128 that divides dg and leaves at least three tiles:
// more tiles share a row strip, so the splits are fewer and longer, for a
// little more reading from L2 (at W_i's [123,392 x 128]^T [.. x 384] on an
// H100, three 128-wide tiles take 48.9 us, two 192-wide ones 51.5 us)
static int gw_bn(int dx, int dg) {
  const int widths[2] = {256, 192};
  for (int bn : widths)
    if (dg % bn == 0 && (dx / GW_BM) * (dg / bn) >= 3) return bn;
  return 128;
}

// the blocks of one wave, one per SM: a property of the card, asked once
static int gw_wave() {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      sms = 1;
  }
  return sms;
}

// 64-row steps per split: as few splits as fill one wave with (tile, split)
// items, one split where the tiles alone fill it
static int gw_steps_per_split(int n, int dx, int dg) {
  int steps = (n + GW_ROWS - 1) / GW_ROWS;
  int tiles = (dx / GW_BM) * (dg / gw_bn(dx, dg));
  int want = tiles >= gw_wave() ? 1 : gw_wave() / tiles;
  int per = (steps + want - 1) / want;
  return per > 0 ? per : 1;
}

// the number of [dx x dg] float32 partials the caller allocates for n rows
extern "C" int grad_weight_splits(int n, int dx, int dg) {
  if (n <= 0 || dx <= 0 || dg <= 0 || dx % 128 != 0 || dg % 128 != 0) return 0;
  int per = gw_steps_per_split(n, dx, dg);
  return ((n + GW_ROWS - 1) / GW_ROWS + per - 1) / per;
}

template <int BN>
static cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tg, float* partial, int n,
                          int dx, int dg, cudaStream_t stream) {
  static cudaError_t sized = cudaFuncSetAttribute(
      grad_weight_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, gw_smem_bytes<BN>());
  if (sized != cudaSuccess) return sized;
  const int splits = grad_weight_splits(n, dx, dg);
  const int items = (dx / GW_BM) * (dg / BN) * splits;
  grad_weight_kernel<BN><<<items < gw_wave() ? items : gw_wave(), GW_THREADS,
                           gw_smem_bytes<BN>(), stream>>>(
      tx, tg, partial, dx, dg, (n + GW_ROWS - 1) / GW_ROWS, gw_steps_per_split(n, dx, dg),
      splits);
  return cudaGetLastError();
}

// out[dx x dg] = X^T G; X [n x dx] and G [n x dg] bfloat16, 16-byte aligned,
// with dx and dg multiples of 128; partial holds grad_weight_splits(n, dx, dg)
// * dx * dg floats. With n = 0 the output is zeroed.
extern "C" int grad_weight(const void* X, const void* G, float* partial, float* out, int n,
                           int dx, int dg, cudaStream_t stream) {
  if (dx % 128 != 0 || dg % 128 != 0 || dx <= 0 || dg <= 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaMemsetAsync(out, 0, (size_t)dx * dg * sizeof(float), stream);
  CUtensorMap tx, tg;
  if (!table_map(&tx, X, n, dx) || !table_map(&tg, G, n, dg)) return (int)cudaErrorInvalidValue;
  int bn = gw_bn(dx, dg);
  cudaError_t err = bn == 256   ? launch<256>(tx, tg, partial, n, dx, dg, stream)
                    : bn == 192 ? launch<192>(tx, tg, partial, n, dx, dg, stream)
                                : launch<128>(tx, tg, partial, n, dx, dg, stream);
  if (err != cudaSuccess) return (int)err;
  const int size = dx * dg;  // four lanes per float4 of out
  grad_weight_reduce<<<(size + 255) / 256, 256, 0, stream>>>(partial, out,
                                                             grad_weight_splits(n, dx, dg), size);
  return (int)cudaGetLastError();
}
