// Exclusive prefix sum over int32, shared by the stitch/compaction
// kernel (lane offsets) and the splice+resolve kernel (token output
// offsets). Replaces the jnp.cumsum calls of tbz/ops/batched.py:271 and
// tbz/ops/fused.py:97 / tbz/ops/resolve.py:55.
//
// Bound: bytes (read n ints, write n ints). Design: each block scans a
// 4096-element tile (1024 threads x 4 items) with warp shuffles, writes
// its tile sum, the tile sums are scanned recursively, and a last pass
// adds each tile's offset. Three passes over the data: simple, not yet
// the single-pass decoupled look-back. Sums are taken modulo 2^32
// (unsigned arithmetic, stored as int32): the batched resolve scans all
// its rows at once and rebases each row by its first entry, which is
// exact while a row's own total stays below 2^31.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;

__global__ void scan_tiles(const int32_t* in, int32_t* out,
                           int64_t n, int32_t* __restrict__ tile_sum) {
  __shared__ uint32_t warp_sum[THREADS / 32];
  const int64_t base = (int64_t)blockIdx.x * TILE + threadIdx.x * ITEMS;
  uint32_t v[ITEMS];
  uint32_t local = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    v[j] = (base + j < n) ? (uint32_t)in[base + j] : 0u;
    local += v[j];
  }
  // inclusive scan of the thread sums inside the warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    uint32_t t = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += t;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    uint32_t ws = warp_sum[lane];
    uint32_t wi = ws;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      uint32_t t = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += t;
    }
    warp_sum[lane] = wi - ws;  // exclusive warp offsets
    if (lane == 31) tile_sum[blockIdx.x] = (int32_t)wi;
  }
  __syncthreads();
  uint32_t run = warp_sum[warp] + inc - local;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (base + j < n) out[base + j] = (int32_t)run;
    run += v[j];
  }
}

__global__ void add_tile_offsets(int32_t* out, int64_t n,
                                 const int32_t* __restrict__ tile_off) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    out[i] = (int32_t)((uint32_t)out[i] + (uint32_t)tile_off[i / TILE]);
}

__global__ void copy_one(const int32_t* src, int32_t* dst) { *dst = *src; }

}  // namespace

TBZ_API int64_t tbz_scan_scratch_ints(int64_t n) {
  if (n <= 0) return 1;
  int64_t nb = (n + TILE - 1) / TILE;
  return nb + (nb > 1 ? tbz_scan_scratch_ints(nb) : 0);
}

int tbz_exclusive_scan(const int32_t* in, int32_t* out, int64_t n,
                       int32_t* total, int32_t* scratch, cudaStream_t s) {
  if (n <= 0) {
    if (total) cudaMemsetAsync(total, 0, sizeof(int32_t), s);
    return (int)cudaGetLastError();
  }
  const int64_t nb = (n + TILE - 1) / TILE;
  scan_tiles<<<(unsigned)nb, THREADS, 0, s>>>(in, out, n, scratch);
  if (nb == 1) {
    if (total) copy_one<<<1, 1, 0, s>>>(scratch, total);
    return (int)cudaGetLastError();
  }
  int err = tbz_exclusive_scan(scratch, scratch, nb, total, scratch + nb, s);
  if (err) return err;
  add_tile_offsets<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(out, n,
                                                               scratch);
  return (int)cudaGetLastError();
}
