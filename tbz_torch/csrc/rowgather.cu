// The row-gather probes: gather, rotate and accumulate 128-byte rows.
//
// Replaces the four Pallas kernels of the closed TPU probe
// scripts/pallas_spike_r3.py: _copy_kernel (:39, pallas_call at :78),
// _rot_kernel (:47, :109), _accum_kernel (:59, :142) and `kern` in
// run_grid (:179, :191). They probe the row-gather primitive that the
// flat span resolver (spans.cu) was built on. A table row is 32 32-bit
// words (128 bytes), held in int32 with uint32's bits.
//
// On the TPU the spike walks the rows in a sequential fori_loop over a
// table staged whole in VMEM (copy, rot, accum), or one grid step a row
// with the row fetched by a scalar-prefetched BlockSpec DMA (grid). On
// Hopper rows are independent: one warp a row, lane w moves word w, so a
// row is one coalesced 128-byte load and one 128-byte store. The rotate
// is a warp shuffle; the accumulate is a 32-bit atomicAdd a word (integer
// adds commute, so the sum mod 2^32 is exact in any order). An index
// outside the table (or a destination outside the output) moves nothing:
// its row comes out zero, as in the plain versions.
//
// Bound: bytes (N·128 read + N·128 written + 4 B a row of each index
// vector read). The grid probe is the copy kernel launched one row a
// block, the spike's one grid step a row.
#include "common.cuh"

namespace {

__device__ __forceinline__ int64_t row_of() {
  return (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
}

__global__ void copy_rows(const int32_t* __restrict__ idx, int64_t N,
                          const int32_t* __restrict__ tbl, int64_t R,
                          int32_t* __restrict__ out) {
  const int64_t i = row_of();
  if (i >= N) return;
  const int lane = threadIdx.x & 31;
  const int64_t r = idx[i];
  out[i * 32 + lane] = (r >= 0 && r < R) ? tbl[r * 32 + lane] : 0;
}

__global__ void rot_rows(const int32_t* __restrict__ idx,
                         const int32_t* __restrict__ rot, int64_t N,
                         const int32_t* __restrict__ tbl, int64_t R,
                         int32_t* __restrict__ out) {
  const int64_t i = row_of();
  if (i >= N) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const int64_t r = idx[i];
  int32_t v = (r >= 0 && r < R) ? tbl[r * 32 + lane] : 0;
  // rotate left by rot[i] words: word w takes word (w + rot) mod 32
  v = __shfl_sync(0xffffffffu, v, (lane + rot[i]) & 31);
  out[i * 32 + lane] = v;
}

__global__ void accum_rows(const int32_t* __restrict__ idx,
                           const int32_t* __restrict__ dst, int64_t N,
                           const int32_t* __restrict__ tbl, int64_t R,
                           int32_t* __restrict__ out) {
  const int64_t i = row_of();
  if (i >= N) return;
  const int lane = threadIdx.x & 31;
  const int64_t r = idx[i], d = dst[i];
  if (r < 0 || r >= R || d < 0 || d >= N) return;
  atomicAdd(reinterpret_cast<unsigned*>(out) + d * 32 + lane,
            (unsigned)tbl[r * 32 + lane]);
}

constexpr int THREADS = 256;  // 8 rows a block

unsigned blocks(int64_t N, int rows_per_block) {
  return (unsigned)((N + rows_per_block - 1) / rows_per_block);
}

}  // namespace

// rows_per_block 8 (copy) or 1 (grid: one row a block)
TBZ_API int tbz_copy_rows(const int32_t* idx, int64_t N, const int32_t* tbl,
                          int64_t R, int rows_per_block, int32_t* out,
                          cudaStream_t s) {
  if (N <= 0) return 0;
  if (rows_per_block < 1 || rows_per_block > 32)
    return (int)cudaErrorInvalidValue;
  copy_rows<<<blocks(N, rows_per_block), 32 * rows_per_block, 0, s>>>(
      idx, N, tbl, R, out);
  return (int)cudaGetLastError();
}

TBZ_API int tbz_rot_rows(const int32_t* idx, const int32_t* rot, int64_t N,
                         const int32_t* tbl, int64_t R, int32_t* out,
                         cudaStream_t s) {
  if (N <= 0) return 0;
  rot_rows<<<blocks(N, THREADS / 32), THREADS, 0, s>>>(idx, rot, N, tbl, R,
                                                        out);
  return (int)cudaGetLastError();
}

// out: N rows, zeroed here, then out[dst[i]] += tbl[idx[i]] mod 2^32
TBZ_API int tbz_accum_rows(const int32_t* idx, const int32_t* dst, int64_t N,
                           const int32_t* tbl, int64_t R, int32_t* out,
                           cudaStream_t s) {
  if (N <= 0) return 0;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)N * 128, s);
  if (e != cudaSuccess) return (int)e;
  accum_rows<<<blocks(N, THREADS / 32), THREADS, 0, s>>>(idx, dst, N, tbl, R,
                                                          out);
  return (int)cudaGetLastError();
}
