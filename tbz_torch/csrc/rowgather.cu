// The row-gather probes: gather, rotate and accumulate 128-byte rows.
//
// Replaces the four Pallas kernels of the closed TPU probe
// scripts/pallas_spike_r3.py: _copy_kernel (:39, pallas_call at :78),
// _rot_kernel (:47, :109), _accum_kernel (:59, :142) and `kern` in
// run_grid (:179, :191). They probe the row-gather primitive that the
// flat span resolver (spans.cu) was built on. A table row is 32 32-bit
// words (128 bytes), held in int32 with uint32's bits. An index outside
// the table (or a destination outside the output) moves nothing: its row
// comes out zero, as in the plain versions.
//
// On the TPU the spike walks the rows in a sequential fori_loop over a
// table staged whole in VMEM (copy, rot, accum), or one grid step a row
// with the row fetched by a scalar-prefetched BlockSpec DMA (grid). On
// Hopper rows are independent, and every kernel is bound by bytes: at
// least 128 B a table row read once, 4 B an index, 128 B an output row
// written. The gathered rows are read again from HBM wherever the table
// outgrows the 50 MB L2, so 2 x 128 B a row is the count to beat there.
//
// copy_rows (the LSU gather): a gathered row is a latency-bound 128-byte
// random read (~0.7 us from HBM), so the bytes in flight set the rate.
// Eight lanes move a row as 16-byte vectors, so one warp instruction
// moves 4 rows, and each thread issues COPY_U rows' loads before it
// stores any; a warp loads the step's indices coalesced and spreads them
// by shuffles. A persistent grid strides over the rows; out is written
// with streaming stores (evict-first), so it does not push table rows
// out of L2.
//
// grid_rows (the bulk-copy engine): the spike's one DMA a grid step on
// Hopper's copy engine. A persistent grid of one-warp blocks takes tiles
// of GRID_ROWS output rows, each through a ring of GRID_STAGES slots in
// shared memory: lane l asks for its row with one cp.async.bulk, whose
// bytes an mbarrier a slot counts in; once a slot lands, lane 0 stores
// the whole tile (contiguous in out) with one bulk store, and a slot is
// refilled only after the store STORE_LAG tiles back has read it
// (cp.async.bulk.wait_group.read). A row outside the table is zeroed in
// its slot by its lane, and a table that is not 16-byte aligned (a view
// at a 4-byte offset) is copied into the slots by the lanes' own loads.
//
// COPY_U and COPY_THREADS, GRID_STAGES and STORE_LAG are the best of
// `python3 probe_rowgather.py OUT --sweep` on an H100 80GB HBM3 (PERF.md
// section 6): within 1-4% of each other at N=2^22, except ten stages (five
// blocks an SM fit, not seven: 8% slower).
#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// --- copy_rows ---------------------------------------------------------------
constexpr int COPY_THREADS = 128;
constexpr int COPY_U = 8;           // rows in flight a thread
constexpr int COPY_STEP = 4 * COPY_U;  // rows a warp step: 4 an instruction

template <bool ALIGNED>
__device__ __forceinline__ int4 load_row(const int32_t* row, int q) {
  if (ALIGNED) return __ldg(reinterpret_cast<const int4*>(row) + q);
  row += 4 * q;
  return make_int4(__ldg(row), __ldg(row + 1), __ldg(row + 2),
                   __ldg(row + 3));
}

// Warp w takes the steps w, w + warps, ...; in a step at row `base`, lane
// l holds the index of row base + l (base + l + 32 for COPY_U = 16), and
// its group g = l / 8 moves rows base + 4u + g, u < COPY_U, 16 bytes
// (words 4q..4q+3, q = l % 8) each.
template <bool ALIGNED>
__global__ void __launch_bounds__(COPY_THREADS)
    copy_rows(const int32_t* __restrict__ idx, int64_t N,
              const int32_t* __restrict__ tbl, int64_t R,
              int32_t* __restrict__ out) {
  constexpr int IDX_REGS = (COPY_STEP + 31) / 32;
  const int lane = threadIdx.x & 31, g = lane >> 3, q = lane & 7;
  const int64_t warps = (int64_t)gridDim.x * (COPY_THREADS / 32);
  for (int64_t base = ((int64_t)blockIdx.x * COPY_THREADS + threadIdx.x) /
                      32 * COPY_STEP;
       base < N; base += warps * COPY_STEP) {
    int32_t ix[IDX_REGS];
#pragma unroll
    for (int j = 0; j < IDX_REGS; ++j) {
      const int64_t i = base + 32 * j + lane;
      ix[j] = (32 * j + lane < COPY_STEP && i < N) ? __ldg(idx + i) : -1;
    }
    int4 v[COPY_U];
#pragma unroll
    for (int u = 0; u < COPY_U; ++u) {
      const int32_t r = __shfl_sync(FULL, ix[u >> 3], 4 * (u & 7) + g);
      v[u] = (r >= 0 && r < R) ? load_row<ALIGNED>(tbl + (int64_t)r * 32, q)
                               : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < COPY_U; ++u) {
      const int64_t i = base + 4 * u + g;
      if (i < N) __stcs(reinterpret_cast<int4*>(out + i * 32) + q, v[u]);
    }
  }
}

// --- grid_rows ---------------------------------------------------------------
constexpr int GRID_ROWS = 32;       // rows a tile: one a lane
constexpr int GRID_STAGES = 8;      // ring slots a block
constexpr int STORE_LAG = 1;        // bulk stores left reading their slots
constexpr int TILE_BYTES = GRID_ROWS * 128;
static_assert(STORE_LAG >= 1 && STORE_LAG < GRID_STAGES, "ring");

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ bool bar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok;
}

// Block b takes tiles b, b + grid, ...; its k-th tile goes through slot
// k % GRID_STAGES, whose mbarrier completes its (k / GRID_STAGES)-th
// phase when that tile's rows have landed. Iteration k stores tile k,
// then refills tile k - STORE_LAG's slot with tile k + GRID_STAGES -
// STORE_LAG, so GRID_STAGES - STORE_LAG tiles' loads stay in flight.
template <bool ALIGNED>
__global__ void __launch_bounds__(32)
    grid_rows(const int32_t* __restrict__ idx, int64_t N,
              const int32_t* __restrict__ tbl, int64_t R,
              int32_t* __restrict__ out) {
  __shared__ __align__(128) int4 ring[GRID_STAGES][TILE_BYTES / 16];
  __shared__ __align__(8) uint64_t full[GRID_STAGES];
  const int lane = threadIdx.x;
  const int64_t tiles = (N + GRID_ROWS - 1) / GRID_ROWS;
  if ((int64_t)blockIdx.x >= tiles) return;
  const int64_t mine = (tiles - 1 - blockIdx.x) / gridDim.x + 1;
  if (lane == 0) {
    for (int s = 0; s < GRID_STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem(&full[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  auto row_at = [&](int64_t k) {   // this lane's row of tile k
    return (blockIdx.x + k * gridDim.x) * GRID_ROWS + lane;
  };
  // tile k's rows into slot k % GRID_STAGES; r: this lane's index
  auto fetch = [&](int64_t k, int64_t r) {
    const int s = (int)(k % GRID_STAGES);
    const int64_t i = row_at(k);
    const bool ok = i < N && r >= 0 && r < R;
    int4* slot = &ring[s][lane * 8];
    const unsigned bulk = __ballot_sync(FULL, ok && ALIGNED);
    if (!ok || !ALIGNED) {   // written by this lane: zeros, or 4-byte loads
      if (ok)
        for (int q = 0; q < 8; ++q) slot[q] = load_row<false>(tbl + r * 32, q);
      else if (i < N)
        for (int q = 0; q < 8; ++q) slot[q] = make_int4(0, 0, 0, 0);
      // make the lane's writes visible to the bulk store (async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncwarp();
    const uint32_t bar = smem(&full[s]);
    if (lane == 0)
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"((uint32_t)__popc(bulk) * 128u)
          : "memory");
    __syncwarp();
    if (ok && ALIGNED)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], 128, [%2];\n" ::"r"(smem(slot)),
          "l"(tbl + r * 32), "r"(bar)
          : "memory");
  };
  auto index = [&](int64_t k) -> int64_t {
    const int64_t i = row_at(k);
    return k < mine && i < N ? (int64_t)__ldg(idx + i) : -1;
  };
  constexpr int AHEAD = GRID_STAGES - STORE_LAG;
  int64_t pre[AHEAD];   // the first tiles' indices, loaded all at once
#pragma unroll
  for (int k = 0; k < AHEAD; ++k) pre[k] = index(k);
#pragma unroll
  for (int k = 0; k < AHEAD; ++k)
    if (k < mine) fetch(k, pre[k]);
  int64_t next = index(AHEAD);   // loaded one iteration before its fetch
  for (int64_t k = 0; k < mine; ++k) {
    if (lane == 0) {
      const int s = (int)(k % GRID_STAGES);
      const uint32_t bar = smem(&full[s]);
      const uint32_t parity = (uint32_t)((k / GRID_STAGES) & 1);
      if (!bar_try_wait(bar, parity)) {
        const long long t0 = clock64();
        while (!bar_try_wait(bar, parity))
          if (clock64() - t0 > (1ll << 35)) __trap();  // ~20 s: a lost copy
      }
      const int64_t row0 = (blockIdx.x + k * gridDim.x) * GRID_ROWS;
      const int64_t rows = N - row0 < GRID_ROWS ? N - row0 : GRID_ROWS;
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
              out + row0 * 32),
          "r"(smem(&ring[s][0])), "r"((uint32_t)rows * 128u)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // the stores of tiles <= k - STORE_LAG have read their slots
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(STORE_LAG)
                   : "memory");
    }
    __syncwarp();
    if (k + AHEAD < mine) {
      const int64_t r = next;
      next = index(k + AHEAD + 1);
      fetch(k + AHEAD, r);
    }
  }
  // the block's shared memory stays until every bulk store is done
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// --- rot_rows, accum_rows: a warp a row ------------------------------------
__device__ __forceinline__ int64_t row_of() {
  return (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
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

// A persistent grid: as many blocks as fit on the card at once (asked of
// the occupancy calculator once a device and kernel), fewer where the
// rows need fewer. `want` is the blocks the rows could use.
template <typename K>
cudaError_t persistent_grid(K kernel, int threads, int64_t want,
                            int (&per_sm)[64], unsigned* grid) {
  static int sm_count[64];   // a device's SMs (0: not asked yet)
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int& sms = sm_count[dev & 63];
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  int& per = per_sm[dev & 63];
  if (per == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads,
                                                      0);
    if (e != cudaSuccess) return e;
    if (per < 1) return cudaErrorInvalidConfiguration;
  }
  const int64_t most = (int64_t)sms * per;
  *grid = (unsigned)(want < most ? want : most);
  return cudaSuccess;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// out (16-byte aligned, N rows) = tbl[idx]; tbl and idx 4-byte aligned
TBZ_API int tbz_copy_rows(const int32_t* idx, int64_t N, const int32_t* tbl,
                          int64_t R, int32_t* out, cudaStream_t s) {
  static int per_sm[2][64];
  if (N <= 0) return 0;
  if (!aligned16(out)) return (int)cudaErrorMisalignedAddress;
  const bool al = aligned16(tbl);
  constexpr int64_t ROWS_A_BLOCK = COPY_STEP * (COPY_THREADS / 32);
  const int64_t want = (N + ROWS_A_BLOCK - 1) / ROWS_A_BLOCK;
  unsigned grid = 0;
  cudaError_t e = al ? persistent_grid(copy_rows<true>, COPY_THREADS, want,
                                       per_sm[1], &grid)
                     : persistent_grid(copy_rows<false>, COPY_THREADS, want,
                                       per_sm[0], &grid);
  if (e != cudaSuccess) return (int)e;
  if (al)
    copy_rows<true><<<grid, COPY_THREADS, 0, s>>>(idx, N, tbl, R, out);
  else
    copy_rows<false><<<grid, COPY_THREADS, 0, s>>>(idx, N, tbl, R, out);
  return (int)cudaGetLastError();
}

// the same function through the bulk-copy engine
TBZ_API int tbz_grid_rows(const int32_t* idx, int64_t N, const int32_t* tbl,
                          int64_t R, int32_t* out, cudaStream_t s) {
  static int per_sm[2][64];
  if (N <= 0) return 0;
  if (!aligned16(out)) return (int)cudaErrorMisalignedAddress;
  const bool al = aligned16(tbl);
  const int64_t want = (N + GRID_ROWS - 1) / GRID_ROWS;
  unsigned grid = 0;
  cudaError_t e =
      al ? persistent_grid(grid_rows<true>, 32, want, per_sm[1], &grid)
         : persistent_grid(grid_rows<false>, 32, want, per_sm[0], &grid);
  if (e != cudaSuccess) return (int)e;
  if (al)
    grid_rows<true><<<grid, 32, 0, s>>>(idx, N, tbl, R, out);
  else
    grid_rows<false><<<grid, 32, 0, s>>>(idx, N, tbl, R, out);
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
