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
// copy_rows and rot_rows (the LSU gather, gather_rows): a gathered row is
// a latency-bound 128-byte random read (~0.7 us from HBM), so the bytes
// in flight set the rate. Eight lanes move a row as 16-byte vectors, so
// one warp instruction moves 4 rows, and each thread issues COPY_U rows'
// loads before it stores any; a warp loads the step's indices (and
// rotations) coalesced and spreads them by shuffles. rot_rows then
// rotates each row inside its 8-lane group: with s = rot & 31 = 4a + b,
// lane q needs words 4q + s .. 4q + s + 3, which lie in the group's lanes
// q + a and q + a + 1 (mod 8): two 16-byte shuffles and a select by b. A
// persistent grid strides over the rows; out is written with streaming
// stores (evict-first), so it does not push table rows out of L2.
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
// accum_rows (a sort by dst, then a pull): atomics into a zeroed output
// would write the output twice and read it back once (the RMW of every
// line an add touches, from HBM once out outgrows L2). Instead one
// cooperative launch sorts the valid rows by dst and writes each output
// row once. A sort is bound by random 4-byte L2 operations (on an H100,
// 4M of them take 50-75 us whatever the occupancy: `probe_rowgather.py
// OUT --phases`), so it sorts in two levels and keeps most of them in
// shared memory: each block counts its tile of rows by coarse bucket (a
// range of up to FINE_MAX output rows) in shared memory, one global
// atomic a (block, bucket); block 0 scans the counts; each block writes
// its rows' (idx, dst) into a run it claims in each bucket; then a block
// sorts a bucket by row in shared memory and pulls its rows from there.
// The pull walks the sorted idx rather than a bucket's rows one after
// another (a chain of dependent loads): a warp step's 32 output rows own
// one range of it, copied 32 table rows a chunk into shared memory by
// cp.async (copy_rows' split of a row over 8 lanes; two chunks in flight,
// no registers held), where each row sums its own entries, then stores
// once. A bucket of more than PIECE rows has the rest sorted and pulled
// a piece at a time after a grid barrier and added with no-return
// atomics: only such a bucket's rows are read back, a skew that sorting
// cannot spread. A launch sorts one round of ROUND output rows (the
// coarse counts' reach); larger N takes a launch a round.
//
// COPY_U and COPY_THREADS, GRID_STAGES and STORE_LAG are the best of
// `python3 probe_rowgather.py OUT --sweep` on an H100 80GB HBM3 (PERF.md
// section 6): within 1-4% of each other at N=2^22, except ten stages (five
// blocks an SM fit, not seven: 8% slower).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;

// --- copy_rows, rot_rows -----------------------------------------------------
constexpr int COPY_THREADS = 128;
constexpr int COPY_U = 8;           // rows in flight a thread
constexpr int COPY_STEP = 4 * COPY_U;  // rows a warp step: 4 an instruction
constexpr int IDX_REGS = (COPY_STEP + 31) / 32;

template <bool ALIGNED>
__device__ __forceinline__ int4 load_row(const int32_t* row, int q) {
  if (ALIGNED) return __ldg(reinterpret_cast<const int4*>(row) + q);
  row += 4 * q;
  return make_int4(__ldg(row), __ldg(row + 1), __ldg(row + 2),
                   __ldg(row + 3));
}

// A warp step's slice of v: lane l gets v[base + 32j + l] in x[j], `fill`
// past the step or past N.
__device__ __forceinline__ void load_step(const int32_t* __restrict__ v,
                                          int64_t base, int64_t N, int lane,
                                          int32_t fill,
                                          int32_t (&x)[IDX_REGS]) {
#pragma unroll
  for (int j = 0; j < IDX_REGS; ++j) {
    const int64_t i = base + 32 * j + lane;
    x[j] = (32 * j + lane < COPY_STEP && i < N) ? __ldg(v + i) : fill;
  }
}

// Lane q of an 8-lane group holds words 4q..4q+3 of the group's row;
// returns words 4q + s .. 4q + s + 3 (mod 32), s = 4a + b in [0, 32).
__device__ __forceinline__ int4 rotate_row(int4 v, int q, int s) {
  const int a = s >> 2, lo = (q + a) & 7, hi = (q + a + 1) & 7;
  const int4 A = make_int4(
      __shfl_sync(FULL, v.x, lo, 8), __shfl_sync(FULL, v.y, lo, 8),
      __shfl_sync(FULL, v.z, lo, 8), __shfl_sync(FULL, v.w, lo, 8));
  const int4 B = make_int4(
      __shfl_sync(FULL, v.x, hi, 8), __shfl_sync(FULL, v.y, hi, 8),
      __shfl_sync(FULL, v.z, hi, 8), __shfl_sync(FULL, v.w, hi, 8));
  // A.x A.y A.z A.w B.x B.y B.z shifted left by b: by 2, then by 1
  const bool two = s & 2;
  const int t0 = two ? A.z : A.x, t1 = two ? A.w : A.y, t2 = two ? B.x : A.z,
            t3 = two ? B.y : A.w, t4 = two ? B.z : B.x;
  return (s & 1) ? make_int4(t1, t2, t3, t4) : make_int4(t0, t1, t2, t3);
}

// Warp w takes the steps w, w + warps, ...; in a step at row `base`, lane
// l holds the index (and rotation) of row base + l (base + l + 32 for
// COPY_U = 16), and its group g = l / 8 moves rows base + 4u + g, u <
// COPY_U, 16 bytes (words 4q..4q+3, q = l % 8) each. ROT: rot_rows, else
// copy_rows (rot unread).
template <bool ALIGNED, bool ROT>
__global__ void __launch_bounds__(COPY_THREADS)
    gather_rows(const int32_t* __restrict__ idx,
                const int32_t* __restrict__ rot, int64_t N,
                const int32_t* __restrict__ tbl, int64_t R,
                int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31, g = lane >> 3, q = lane & 7;
  const int64_t warps = (int64_t)gridDim.x * (COPY_THREADS / 32);
  for (int64_t base = ((int64_t)blockIdx.x * COPY_THREADS + threadIdx.x) /
                      32 * COPY_STEP;
       base < N; base += warps * COPY_STEP) {
    int32_t ix[IDX_REGS], rx[IDX_REGS];
    load_step(idx, base, N, lane, -1, ix);
    if (ROT) load_step(rot, base, N, lane, 0, rx);
    int4 v[COPY_U];
#pragma unroll
    for (int u = 0; u < COPY_U; ++u) {
      const int32_t r = __shfl_sync(FULL, ix[u >> 3], 4 * (u & 7) + g);
      v[u] = (r >= 0 && r < R) ? load_row<ALIGNED>(tbl + (int64_t)r * 32, q)
                               : make_int4(0, 0, 0, 0);
    }
    if (ROT) {
#pragma unroll
      for (int u = 0; u < COPY_U; ++u)
        v[u] = rotate_row(
            v[u], q, __shfl_sync(FULL, rx[u >> 3], 4 * (u & 7) + g) & 31);
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

// --- accum_rows --------------------------------------------------------------
constexpr int ACCUM_THREADS = 128;
constexpr int WARPS = ACCUM_THREADS / 32;
// the sort: coarse buckets of up to FINE_MAX output rows, each sorted and
// pulled by a block in shared memory, PIECE rows at a time; a launch sorts
// the rows whose dst lies in one round of at most ROUND output rows
constexpr int FINE_MAX = 1024;
constexpr int PIECE = 2048;
constexpr int MAX_NB = 8192;        // coarse buckets
constexpr int64_t ROUND = (int64_t)FINE_MAX * MAX_NB;
constexpr int META = 3 * (MAX_NB + 1) + 1;   // starts, cursors, pieces, n
constexpr int SORT_B = 8;           // rows a thread reads at once

// Scratch: META ints, then int2 entries[N] (each valid row's idx and dst,
// by coarse bucket).
int64_t accum_scratch_ints(int64_t N) { return 2 * N + META; }

__device__ __forceinline__ void add4(int4& a, int4 v) {
  a.x = (int)((unsigned)a.x + (unsigned)v.x);
  a.y = (int)((unsigned)a.y + (unsigned)v.y);
  a.z = (int)((unsigned)a.z + (unsigned)v.z);
  a.w = (int)((unsigned)a.w + (unsigned)v.w);
}

__device__ __forceinline__ void red4(int32_t* o, int4 a) {
  unsigned* u = reinterpret_cast<unsigned*>(o);
  atomicAdd(u, (unsigned)a.x);
  atomicAdd(u + 1, (unsigned)a.y);
  atomicAdd(u + 2, (unsigned)a.z);
  atomicAdd(u + 3, (unsigned)a.w);
}

// The exclusive prefix of v over the block's ACCUM_THREADS threads;
// *total their sum.
__device__ __forceinline__ int32_t block_scan(int32_t v, int32_t* sh,
                                              int32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t t = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += t;
  }
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  int32_t before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    before += w < warp ? sh[w] : 0;
    all += sh[w];
  }
  __syncthreads();
  *total = all;
  return before + inc - v;
}

// Rows at base + stride * b, b < SORT_B: their idx in r, dst in d
// (streamed: read twice, kept out of L2's way), and whether each adds in
// this round (ok: idx in the table, dst in [d0, d0 + nr)); all loads
// issued before any is used.
__device__ __forceinline__ void sort_rows(const int32_t* __restrict__ idx,
                                          const int32_t* __restrict__ dst,
                                          int64_t base, int stride,
                                          int64_t end, int64_t R, int64_t d0,
                                          int64_t nr, int32_t (&r)[SORT_B],
                                          int32_t (&d)[SORT_B],
                                          bool (&ok)[SORT_B]) {
#pragma unroll
  for (int b = 0; b < SORT_B; ++b) {
    const int64_t i = base + (int64_t)stride * b;
    r[b] = i < end ? __ldcs(idx + i) : -1;
    d[b] = i < end ? __ldcs(dst + i) : -1;
  }
#pragma unroll
  for (int b = 0; b < SORT_B; ++b)
    ok[b] = r[b] >= 0 && r[b] < R && d[b] >= d0 && d[b] - d0 < nr;
}

// 16 table-row bytes (words 4q..4q+3 of row r) into shared memory, by
// cp.async: no registers held while the load is in flight.
template <bool ALIGNED>
__device__ __forceinline__ void copy_async(int4* dst,
                                           const int32_t* __restrict__ row) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (ALIGNED) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(row)
                 : "memory");
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       d + 4 * k),
                   "l"(row + k)
                   : "memory");
  }
}

// One warp step of the pull: lane l's row sums the table rows list[st,
// en) (list: sorted idx in shared memory). The step's rows' entries are
// one range of list, walked 32 entries a chunk with copy_rows' split (an
// index a lane, spread by shuffles; lane (g, q) moves words 4q..4q+3 of
// entries 4u + g) into the warp's two stages by cp.async, the next
// chunk's copies in flight while each row sums its own entries of this
// one. Lane (g, q) gets rows 4u + g, u < 8, words 4q..4q+3, in acc[u].
template <bool ALIGNED>
__device__ __forceinline__ void pull_step(const int32_t* list, int32_t st,
                                          int32_t en,
                                          const int32_t* __restrict__ tbl,
                                          int4 (*stage)[32][8], int lane,
                                          int4 (&acc)[8]) {
  const int g = lane >> 3, q = lane & 7;
  int32_t a[8], b[8];   // this thread's rows' entries: [a[u], b[u])
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    a[u] = __shfl_sync(FULL, st, 4 * u + g);
    b[u] = __shfl_sync(FULL, en, 4 * u + g);
    acc[u] = make_int4(0, 0, 0, 0);
  }
  const int32_t last = __shfl_sync(FULL, en, 31);
  auto issue = [&](int32_t p, int4 (*buf)[8]) {
    const int32_t ix = p + lane < last ? list[p + lane] : -1;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int32_t r = __shfl_sync(FULL, ix, 4 * u + g);
      if (r >= 0) copy_async<ALIGNED>(&buf[4 * u + g][q],
                                      tbl + (int64_t)r * 32 + 4 * q);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  int32_t p = __shfl_sync(FULL, st, 0);
  if (p < last) issue(p, stage[0]);
  for (int buf = 0; p < last; buf ^= 1, p += 32) {   // uniform over the warp
    issue(p + 32, stage[buf ^ 1]);   // an empty group past the end
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();   // chunk p has landed, for every lane
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int32_t k1 = min(b[u], p + 32);
      for (int32_t k = max(a[u], p); k < k1; ++k)
        add4(acc[u], stage[buf][k - p][q]);
    }
    __syncwarp();   // stage[buf] is free for the chunk after next
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The local sort's shared memory: the block's coarse histogram (phases
// A-C), then a bucket's fine counts, its sorted idx and the warps' stages.
union LocalSmem {
  int32_t hist[MAX_NB];
  struct {
    int32_t cnt[FINE_MAX];
    int32_t list[PIECE];
    int4 stage[WARPS][2][32][8];
  } d;
};

// Sorts entries [p0, p1) (all of rows row0 .. row0 + rows - 1) by row in
// shared memory, then pulls those rows (pull_step over the sorted idx
// there): each stored once (ADD false: a bucket's first piece, every
// row, empty ones zero) or, for a later piece, added with no-return
// atomics to the rows it has entries of.
template <bool ALIGNED, bool ADD>
__device__ __forceinline__ void local_pull(const int2* ent, int32_t p0,
                                           int32_t p1, int64_t row0, int rows,
                                           const int32_t* __restrict__ tbl,
                                           int32_t* __restrict__ out,
                                           LocalSmem& sm, int32_t* sh) {
  const int t = threadIdx.x, lane = t & 31, g = lane >> 3, q = lane & 7;
  constexpr int STEP = ACCUM_THREADS * SORT_B;
  int32_t* cnt = sm.d.cnt;
  for (int j = t; j < rows; j += ACCUM_THREADS) cnt[j] = 0;
  __syncthreads();
  for (int32_t i0 = p0 + t; i0 < p1; i0 += STEP) {
    int32_t d[SORT_B];
#pragma unroll
    for (int k = 0; k < SORT_B; ++k) {
      const int32_t i = i0 + k * ACCUM_THREADS;
      d[k] = i < p1 ? __ldcg(&ent[i].y) : -1;
    }
#pragma unroll
    for (int k = 0; k < SORT_B; ++k)
      if (d[k] >= 0) atomicAdd(&cnt[d[k] - row0], 1);
  }
  __syncthreads();
  // exclusive scan of cnt: thread t its run of `per` counts
  const int per = (rows + ACCUM_THREADS - 1) / ACCUM_THREADS;
  const int j0 = t * per < rows ? t * per : rows;
  const int j1 = j0 + per < rows ? j0 + per : rows;
  int32_t sum = 0;
  for (int j = j0; j < j1; ++j) sum += cnt[j];
  int32_t total;
  int32_t at = block_scan(sum, sh, &total);
  for (int j = j0; j < j1; ++j) {
    const int32_t c = cnt[j];
    cnt[j] = at;
    at += c;
  }
  __syncthreads();
  for (int32_t i0 = p0 + t; i0 < p1; i0 += STEP) {
    int2 v[SORT_B];
#pragma unroll
    for (int k = 0; k < SORT_B; ++k) {
      const int32_t i = i0 + k * ACCUM_THREADS;
      v[k] = i < p1 ? __ldcg(ent + i) : make_int2(0, -1);
    }
#pragma unroll
    for (int k = 0; k < SORT_B; ++k)
      if (v[k].y >= 0) sm.d.list[atomicAdd(&cnt[v[k].y - row0], 1)] = v[k].x;
  }
  __syncthreads();
  // cnt[j]: the end of row j's entries in list
  for (int s0 = (t >> 5) * 32; s0 < rows; s0 += 32 * WARPS) {
    const int j = s0 + lane;
    const int32_t en = cnt[j < rows ? j : rows - 1];
    const int32_t st = j >= rows ? en : j ? cnt[j - 1] : 0;
    int4 acc[8];
    pull_step<ALIGNED>(sm.d.list, st, en, tbl, sm.d.stage[t >> 5], lane,
                       acc);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int jr = s0 + 4 * u + g;
      if (jr >= rows) continue;
      int32_t* o = out + (row0 + jr) * 32 + 4 * q;
      if (!ADD)
        __stcs(reinterpret_cast<int4*>(o), acc[u]);
      else if (cnt[jr] > (jr ? cnt[jr - 1] : 0))
        red4(o, acc[u]);
    }
  }
  __syncthreads();   // the next piece reuses cnt, list and the stages
}

// One round of the sort, in one cooperative launch: the valid rows whose
// dst lies in [d0, d0 + nr), nr <= ROUND (coarse bucket: (d - d0) >> fb,
// F = 2^fb output rows; NB = ceil(nr / F) <= MAX_NB buckets), its phases
// split by grid barriers: 0 zero the coarse counts (and each block's
// histogram); A count the round's rows of the block's tile by
// coarse bucket in shared memory, then add each nonzero count to the
// global one; B block 0 scans the counts into the buckets' starts and
// cursors, and the pieces past each bucket's first PIECE rows; C each
// block claims a run of each bucket for its tile's rows (one returning
// atomic a bucket) and writes its rows' (idx, dst) there; D block b sorts
// bucket b's first piece by row and stores each of the bucket's output
// rows once (local_pull); E (only if a bucket has more than PIECE rows)
// the blocks sort each further piece and add it.
template <bool ALIGNED>
__global__ void __launch_bounds__(ACCUM_THREADS)
    accum_rows(const int32_t* __restrict__ idx,
               const int32_t* __restrict__ dst, int64_t N,
               const int32_t* __restrict__ tbl, int64_t R,
               int32_t* __restrict__ out, int32_t* ws, int64_t d0,
               int64_t nr, int fb) {
  __shared__ LocalSmem sm;
  __shared__ int32_t sh[WARPS];
  cg::grid_group grid = cg::this_grid();
  int32_t* start = ws;                         // [NB + 1]
  int32_t* cursor = ws + (MAX_NB + 1);         // [NB]
  int32_t* pieces = ws + 2 * (MAX_NB + 1);     // [NB + 1], exclusive
  int32_t* n_more = ws + 3 * (MAX_NB + 1);
  int2* ent = reinterpret_cast<int2*>(ws + META);
  const int t = threadIdx.x;
  const int NB = (int)((nr + (1 << fb) - 1) >> fb);
  const int64_t tile = (N + gridDim.x - 1) / gridDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * tile < N
                         ? (int64_t)blockIdx.x * tile : N;
  const int64_t t1 = t0 + tile < N ? t0 + tile : N;
  constexpr int STEP = ACCUM_THREADS * SORT_B;

  for (int64_t b = (int64_t)blockIdx.x * ACCUM_THREADS + t; b <= NB;   // 0
       b += (int64_t)gridDim.x * ACCUM_THREADS)
    start[b] = 0;
  for (int b = t; b < NB; b += ACCUM_THREADS) sm.hist[b] = 0;
  grid.sync();

  for (int64_t i0 = t0; i0 < t1; i0 += STEP) {   // A
    int32_t r[SORT_B], d[SORT_B];
    bool ok[SORT_B];
    sort_rows(idx, dst, i0 + t, ACCUM_THREADS, t1, R, d0, nr, r, d, ok);
#pragma unroll
    for (int b = 0; b < SORT_B; ++b)
      if (ok[b]) atomicAdd(&sm.hist[(d[b] - d0) >> fb], 1);
  }
  __syncthreads();
  for (int b = t; b < NB; b += ACCUM_THREADS)
    if (sm.hist[b]) atomicAdd(start + b, sm.hist[b]);
  grid.sync();

  if (blockIdx.x == 0) {   // B: 16 counts a thread, 2048 a round
    int32_t run = 0, runp = 0;
    for (int b0 = 0; b0 < NB; b0 += 16 * ACCUM_THREADS) {
      const int j = b0 + 16 * t;
      int32_t c[16], m[16];
      int32_t sc = 0, sp = 0;
#pragma unroll
      for (int k = 0; k < 16; k += 4) {
        const int4 v = __ldcg(reinterpret_cast<const int4*>(start + j + k));
        c[k] = v.x;
        c[k + 1] = v.y;
        c[k + 2] = v.z;
        c[k + 3] = v.w;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        c[k] = j + k < NB ? c[k] : 0;
        m[k] = c[k] > PIECE ? (c[k] - 1) / PIECE : 0;
        sc += c[k];
        sp += m[k];
      }
      int32_t tc, tp;
      int32_t at = run + block_scan(sc, sh, &tc);
      int32_t ap = runp + block_scan(sp, sh, &tp);
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (j + k < NB) {
          start[j + k] = cursor[j + k] = at;
          pieces[j + k] = ap;
          at += c[k];
          ap += m[k];
        }
      run += tc;
      runp += tp;
    }
    if (t == 0) {
      start[NB] = run;
      pieces[NB] = runp;
      *n_more = runp;
    }
  }
  grid.sync();

  for (int b0 = t; b0 < NB; b0 += SORT_B * ACCUM_THREADS) {   // C
    int32_t at[SORT_B];
#pragma unroll
    for (int k = 0; k < SORT_B; ++k) {
      const int b = b0 + k * ACCUM_THREADS;
      const int32_t c = b < NB ? sm.hist[b] : 0;
      at[k] = c ? atomicAdd(cursor + b, c) : 0;
    }
#pragma unroll
    for (int k = 0; k < SORT_B; ++k)
      if (b0 + k * ACCUM_THREADS < NB) sm.hist[b0 + k * ACCUM_THREADS] = at[k];
  }
  __syncthreads();
  for (int64_t i0 = t0; i0 < t1; i0 += STEP) {
    int32_t r[SORT_B], d[SORT_B];
    bool ok[SORT_B];
    sort_rows(idx, dst, i0 + t, ACCUM_THREADS, t1, R, d0, nr, r, d, ok);
#pragma unroll
    for (int b = 0; b < SORT_B; ++b)
      if (ok[b])
        ent[atomicAdd(&sm.hist[(d[b] - d0) >> fb], 1)] = make_int2(r[b], d[b]);
  }
  grid.sync();
  const int32_t more = __ldcg(n_more);   // the same in every thread

  for (int b = blockIdx.x; b < NB; b += gridDim.x) {   // D
    const int32_t s = __ldcg(start + b), e = __ldcg(start + b + 1);
    const int64_t row0 = d0 + ((int64_t)b << fb);
    const int rows =
        (int)(d0 + nr - row0 < (1 << fb) ? d0 + nr - row0 : (1 << fb));
    local_pull<ALIGNED, false>(ent, s, e - s < PIECE ? e : s + PIECE, row0,
                               rows, tbl, out, sm, sh);
  }
  if (more == 0) return;   // uniform over the grid
  grid.sync();

  for (int k = blockIdx.x; k < more; k += gridDim.x) {   // E
    int lo = 0, hi = NB;   // the last bucket b with pieces[b] <= k
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (__ldcg(pieces + mid) <= k) lo = mid; else hi = mid;
    }
    const int32_t s = __ldcg(start + lo) +
                      (1 + k - __ldcg(pieces + lo)) * PIECE;
    const int32_t e = __ldcg(start + lo + 1);
    const int64_t row0 = d0 + ((int64_t)lo << fb);
    const int rows =
        (int)(d0 + nr - row0 < (1 << fb) ? d0 + nr - row0 : (1 << fb));
    local_pull<ALIGNED, true>(ent, s, e - s < PIECE ? e : s + PIECE, row0,
                              rows, tbl, out, sm, sh);
  }
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

// out (16-byte aligned, N rows) = tbl[idx] (rot null), or each row rotated
// left by rot[i] & 31 words; tbl, idx and rot 4-byte aligned
int gather(const int32_t* idx, const int32_t* rot, int64_t N,
           const int32_t* tbl, int64_t R, int32_t* out, cudaStream_t s) {
  static int per_sm[4][64];
  if (N <= 0) return 0;
  if (!aligned16(out)) return (int)cudaErrorMisalignedAddress;
  const bool al = aligned16(tbl);
  constexpr int64_t ROWS_A_BLOCK = COPY_STEP * (COPY_THREADS / 32);
  const int64_t want = (N + ROWS_A_BLOCK - 1) / ROWS_A_BLOCK;
  void (*k)(const int32_t*, const int32_t*, int64_t, const int32_t*, int64_t,
            int32_t*) = gather_rows<false, false>;
  if (rot)
    k = al ? gather_rows<true, true> : gather_rows<false, true>;
  else if (al)
    k = gather_rows<true, false>;
  unsigned grid = 0;
  const cudaError_t e = persistent_grid(k, COPY_THREADS, want,
                                        per_sm[2 * (rot != nullptr) + al],
                                        &grid);
  if (e != cudaSuccess) return (int)e;
  k<<<grid, COPY_THREADS, 0, s>>>(idx, rot, N, tbl, R, out);
  return (int)cudaGetLastError();
}

}  // namespace

TBZ_API int tbz_copy_rows(const int32_t* idx, int64_t N, const int32_t* tbl,
                          int64_t R, int32_t* out, cudaStream_t s) {
  return gather(idx, nullptr, N, tbl, R, out, s);
}

TBZ_API int tbz_rot_rows(const int32_t* idx, const int32_t* rot, int64_t N,
                         const int32_t* tbl, int64_t R, int32_t* out,
                         cudaStream_t s) {
  return rot ? gather(idx, rot, N, tbl, R, out, s)
             : (int)cudaErrorInvalidValue;
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

// out: N rows, out[d] = the sum mod 2^32 of tbl[idx[i]] over the valid
// rows i with dst[i] = d; scratch: accum_scratch_ints(N) int32.
// One launch a round of ROUND output rows (one for N <= ROUND).
TBZ_API int tbz_accum_rows(const int32_t* idx, const int32_t* dst, int64_t N,
                           const int32_t* tbl, int64_t R, int32_t* out,
                           int32_t* scratch, int64_t scratch_ints,
                           cudaStream_t s) {
  static int per_sm[2][64];
  if (N <= 0) return 0;
  if (!aligned16(out) || !aligned16(scratch))
    return (int)cudaErrorMisalignedAddress;
  if (N > INT32_MAX || scratch_ints < accum_scratch_ints(N))
    return (int)cudaErrorInvalidValue;
  const bool al = aligned16(tbl);
  // phases A and C walk all N rows, whatever the round
  const int64_t want = (N + ACCUM_THREADS - 1) / ACCUM_THREADS;
  for (int64_t d0 = 0; d0 < N; d0 += ROUND) {
    int64_t nr = N - d0 < ROUND ? N - d0 : ROUND;
    unsigned grid = 0;
    const cudaError_t e =
        al ? persistent_grid(accum_rows<true>, ACCUM_THREADS, want,
                             per_sm[1], &grid)
           : persistent_grid(accum_rows<false>, ACCUM_THREADS, want,
                             per_sm[0], &grid);
    if (e != cudaSuccess) return (int)e;
    // fine buckets of F = 2^fb rows: about nr / grid, 32 to FINE_MAX
    int fb = 5;
    while ((1 << fb) < FINE_MAX && ((int64_t)2 << fb) * grid <= nr) ++fb;
    void* args[] = {(void*)&idx, (void*)&dst, &N, (void*)&tbl, &R, &out,
                    &scratch, &d0, &nr, &fb};
    const int err = (int)cudaLaunchCooperativeKernel(
        al ? (const void*)accum_rows<true> : (const void*)accum_rows<false>,
        grid, ACCUM_THREADS, args, 0, s);
    if (err) return err;
  }
  return 0;
}
