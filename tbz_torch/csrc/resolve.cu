// Kernel 4 (core) and kernel 7: LZ77 resolve of token tapes by pointer
// doubling, for one tape or a batch of S independent tapes (one per row).
//
// Replaces tbz/ops/resolve.py:37 _resolve_core and its while_loop at :109
// (shared there by _resolve_impl and the fused _splice_resolve) and, with
// a row dimension, tbz/parallel/shard.py:33 _resolve_batch (_resolve_impl
// under vmap, window stripped). The XLA version maps every output byte to
// its token with a scatter of marks + cumsum and a width-8 row gather (a
// TPU gather workaround), then runs P <- P[P] over the whole array until
// nothing moves.
//
// Coordinates (within a row): [0, W) is the carried window, [W, W + cap)
// the output. A match byte q of a token starting at tstart with distance
// d points at tstart - d + (q - tstart) % d (resolve.py:96: an
// overlapping run collapses to one hop); literal and stored bytes, the
// window and the bytes past the total are roots. Parents only point
// backwards, so the parents form a forest.
//
// Bound: bytes. The function must read the tape (12 B a token), the
// stored bytes and the window, and write the output: ~0.08 ms at 64 MiB.
// The old design (one thread per token, then every doubling pass over
// every byte, 28 passes enqueued at 64 MiB) took 7.07 ms. What it costs
// is the genealogy: on chip_smoke.py's 64 MiB L6 stream 39-59% of the
// words stay live through the first 10 of its 16 passes (PERF.md). This
// design:
//  - expand: a block a 1024-byte tile, four bytes a thread. mark_tiles
//    records the token that covers each tile's first byte; the block
//    marks its tokens' starts in shared memory and takes a running
//    maximum, so each byte finds its token without a search, and writes
//    one 32-bit word (common.cuh), 16 B a store: the root's value, or
//    the distance back to its parent.
//  - doubling: one cooperative kernel (a grid that the card holds at
//    once, grid.sync() between passes) runs tbz's Jacobi passes, words
//    double-buffered: pass k reads only pass k - 1's words (pass 1 fills
//    the second buffer). A warp takes
//    a group of 32 words (coalesced loads, and whole 32-byte sectors
//    stored: a partly written sector costs a fill read). A value never
//    changes again, so a pass skips it (after copying a value that the
//    last pass made into the other buffer), and each pass leaves a flag
//    a group for the next: a group that holds no pointer and no new
//    value is not read at all (~63% of the groups stay live through
//    the middle passes of that stream's 16 MiB prefix). A value word says whether it was a root from the start: a
//    pass "moves a pointer", as tbz counts, iff some pointer's target
//    is not an original root, so the pass count is tbz's exactly. The
//    loop ends after the first pass that moves nothing: no pass is
//    launched after the fixpoint, and nothing is read back by the host.
//  - output: one coalesced pass takes the low byte of every word (16 B
//    read, 4 B written a thread).
// K7 has two paths, chosen by out_capacity alone. A row of at most
// ONCHIP_CAP bytes (SAMv1 §4.1 caps a BGZF block at 64 KiB, so every
// BGZF bucket) fits one SM: onchip_rows resolves it in one block, its
// state in shared memory from tape to output (below), with no HBM
// round trip, no grid barrier and its own pass count; the grid-wide
// design's 2 x (W + cap) words a row, its barriers and its deepest-row
// pass count all go. A larger row takes the grid-wide design: K7 scans
// all its rows' lengths in one exclusive scan (scan.cu, modulo 2^32) and
// rebases each row by its first entry; the rows share the word buffers,
// the flags and the pass count. On both paths the batch's count is its
// deepest row's, as in tbz's vmapped while_loop. Row bases are 64-bit: a
// bucket of more than 2 GiB of rows overflows int32; within a row
// coordinates stay int32, as in tbz. Launches are counted by the
// wrappers (tbz_torch/_cuda.py count): resolve_core, resolve_batch (every
// K7 launch, either path), resolve_onchip (those that ran onchip_rows,
// as tbz_resolve_batch reports), and splice_resolve with resolve_core.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 1024;             // output bytes a block expands
constexpr int ITEMS = 8;               // groups a warp a doubling chunk
constexpr int GROUPS = WARPS * ITEMS;  // 32-word groups a chunk
constexpr int MAX_PASSES = 40;         // chains < 2^31 hops need <= 32
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t V = tbz::VALUE, R = tbz::ROOT;

inline unsigned blocks(int64_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }
inline int64_t tiles(int64_t cap) { return (cap + TILE - 1) / TILE; }

// K7's lengths: row r's tokens past n_rows[r] count 0
__global__ void mask_lens(const int32_t* __restrict__ ol, int64_t T,
                          const int32_t* __restrict__ n_rows, int32_t* lens) {
  const int64_t r = blockIdx.y;
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= T) return;
  lens[r * T + t] = t < n_rows[r] ? ol[r * T + t] : 0;
}

// a row's token start, relative to the row's first (the scan runs over
// every row at once, modulo 2^32)
__device__ __forceinline__ int64_t rel(const int32_t* st, int64_t t,
                                       uint32_t base) {
  return (int64_t)(uint32_t)((uint32_t)st[t] - base);
}

// tf[r * NT + k] = the token covering output byte k * TILE of row r (-1
// stays where no token does: past the total). Every byte lies in one
// token of positive length, so no two tokens write one entry.
__global__ void mark_tiles(const int32_t* __restrict__ lens,
                           const int32_t* __restrict__ starts, int64_t T,
                           int64_t cap, int64_t NT, int32_t* tf) {
  const int64_t r = blockIdx.y;
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= T) return;
  const int32_t* st = starts + r * T;
  const int64_t l = lens[r * T + t];
  if (l <= 0) return;
  const int64_t s = rel(st, t, (uint32_t)st[0]);
  const int64_t e = s + l < cap ? s + l : cap;
  for (int64_t q = (s + TILE - 1) / TILE * TILE; q < e; q += TILE)
    tf[r * NT + q / TILE] = (int32_t)t;
}

// one block a TILE of row r's coordinates [0, W + cap) of word buffer A
// (pass 1 fills B), four consecutive words a thread: window bytes are
// roots, output bytes a root or a pointer to their parent. Each byte's
// token comes from a map of the tile in shared memory (the token that
// starts at each byte, then a running maximum), not from a search.
__global__ void __launch_bounds__(THREADS)
expand(const int32_t* __restrict__ lens, const int32_t* __restrict__ di,
       const int32_t* __restrict__ rv, const int32_t* __restrict__ starts,
       int64_t T, const uint8_t* __restrict__ input, int64_t n_input,
       const uint8_t* __restrict__ window, int64_t cap,
       const int32_t* __restrict__ tf, int64_t NT, uint32_t* A) {
  __shared__ int32_t tok[TILE];
  __shared__ int32_t wmax[WARPS];
  const int64_t r = blockIdx.y;
  const int64_t n = tbz::W + cap;
  const int64_t b0 = (int64_t)blockIdx.x * TILE;
  const int j0 = threadIdx.x * 4;
  uint32_t w[4];
  if (b0 < tbz::W) {   // W is a multiple of TILE
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = tbz::root_word(window[r * tbz::W + b0 + j0 + i]);
  } else {
    const int64_t q0 = b0 - tbz::W, kt = q0 / TILE;
    const int32_t* st = starts + r * T;
    const uint32_t base = T > 0 ? (uint32_t)st[0] : 0u;
    const int64_t total =
        T > 0 ? (int64_t)(uint32_t)((uint32_t)st[T - 1]
                                    + (uint32_t)lens[r * T + T - 1] - base)
              : 0;
    const int32_t t_lo = tf[r * NT + kt];
    int32_t t_hi = kt + 1 < NT ? tf[r * NT + kt + 1] : -1;
    if (t_hi < 0) t_hi = (int32_t)(T - 1);
    // tok[x]: the token of positive length that starts at q0 + x; the
    // tile's first byte lies in t_lo
    for (int x = threadIdx.x; x < TILE; x += THREADS) tok[x] = -1;
    __syncthreads();
    for (int64_t t = (int64_t)t_lo + 1 + threadIdx.x; t_lo >= 0 && t <= t_hi;
         t += THREADS) {
      const int64_t s0 = rel(st, t, base);
      if (lens[r * T + t] > 0 && s0 < q0 + TILE) tok[s0 - q0] = (int32_t)t;
    }
    if (threadIdx.x == 0) tok[0] = t_lo;
    __syncthreads();
    // running maximum: each byte's token
    int32_t v[4];
    v[0] = tok[j0];
#pragma unroll
    for (int i = 1; i < 4; ++i) v[i] = max(v[i - 1], tok[j0 + i]);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int32_t m = v[3];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t x = __shfl_up_sync(FULL, m, d);
      if (lane >= d) m = max(m, x);
    }
    int32_t pre = __shfl_up_sync(FULL, m, 1);
    if (lane == 0) pre = -1;
    if (lane == 31) wmax[warp] = m;
    __syncthreads();
    for (int q = 0; q < warp; ++q) pre = max(pre, wmax[q]);
    const int32_t* dr = di + r * T;
    const int32_t* vr = rv + r * T;
    const uint8_t* in = input + r * n_input;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t q = q0 + j0 + i;
      const int32_t a = max(pre, v[i]);
      w[i] = tbz::root_word(0);
      if (a < 0 || q >= total) continue;
      const int64_t tstart = rel(st, a, base);
      const int d = dr[a], vv = vr[a];
      const int jj = (int)(q - tstart);
      if (d > 0) {
        int64_t p = tstart - d + (jj % d) + tbz::W;
        p = p < 0 ? 0 : (p > n - 1 ? n - 1 : p);
        w[i] = (uint32_t)(q + tbz::W - p);
      } else if (vv & tbz::STORED_FLAG) {
        const int64_t o = (int64_t)(vv & (tbz::STORED_FLAG - 1)) + jj;
        w[i] = tbz::root_word(o < n_input ? in[o] : 0);
      } else {
        w[i] = tbz::root_word((uint32_t)vv & 0xFF);
      }
    }
  }
  const int64_t x = r * n + b0 + j0;
  if ((n & 3) == 0 && b0 + j0 + 4 <= n) {
    *reinterpret_cast<uint4*>(A + x) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int i = 0; i < 4 && b0 + j0 + i < n; ++i) A[x + i] = w[i];
  }
}

// One chunk of doubling pass k: GROUPS groups of 32 words from group c,
// warp w taking groups c + j * WARPS + w, j < ITEMS. Bit j of `on` (the
// flags pass k - 1 left this warp; pass 1 takes every group) is clear
// for a group that holds only values both buffers share: it is skipped. In the
// others, a pointer takes its target's word from `cur` (a value, or the
// target's pointer added to its own) and writes it to `nxt`; a value
// that pass k - 1 made is copied to `nxt`. A warp stores whole 32-byte
// sectors (8 lanes' words) where any word changes: a partly written
// sector costs L2 a read from memory to fill it. Returns the flags for
// pass k + 1: bit j set if group j kept a pointer or made a value now
// (its copy is due next pass).
__device__ __forceinline__ unsigned pass_chunk(const uint32_t* cur,
                                               uint32_t* nxt, int64_t N,
                                               int64_t c, unsigned on,
                                               uint32_t k, unsigned& n_live,
                                               bool& moved) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t e[ITEMS];
  uint32_t w[ITEMS], t[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t x = (c + (int64_t)j * WARPS + warp) * 32 + lane;
    e[j] = ((on >> j) & 1) && x < N ? x : -1;
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    w[j] = e[j] >= 0 ? __ldcg(cur + e[j]) : V | R;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    t[j] = (w[j] & V) ? 0u : __ldcg(cur + e[j] - w[j]);
  unsigned keep = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    uint32_t nw = w[j];   // a value stays as it is
    bool write = k == 1, now = false;   // pass 1 fills all of `nxt`
    if (!(w[j] & V)) {
      if (t[j] & V) {
        nw = tbz::resolved_word(t[j], k);
        moved |= !(t[j] & R);
      } else {
        nw = w[j] + t[j];
        moved = true;
        ++n_live;
      }
      write = now = true;
    } else if (!(w[j] & R) && ((w[j] >> 8) & 63) == k - 1) {
      write = true;   // made by pass k - 1: copy it to the other buffer
    }
    const unsigned b = __ballot_sync(FULL, write);
    if (((b >> (lane & 24)) & 0xFF) && e[j] >= 0) nxt[e[j]] = nw;
    if (__any_sync(FULL, now)) keep |= 1u << j;
  }
  return keep;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The Jacobi passes, the output pass and the pass count, in one
// cooperative launch. live[k]: the pointers pass k left; moved[k]: pass
// k moved a pointer; stamp[k]: the card's clock (ns) after pass k
// (stamp[0]: block 0's start; stamp[MAX_PASSES + 1]: its end).
// probe_resolve.py reads them.
__global__ void __launch_bounds__(THREADS)
doubling(uint32_t* A, uint32_t* B, int64_t rows, int64_t n, int64_t lo,
         uint8_t* out, uint8_t* F0, uint8_t* F1, unsigned long long* live,
         unsigned long long* stamp, unsigned* moved, int32_t* passes) {
  cg::grid_group grid = cg::this_grid();
  const bool clock = blockIdx.x == 0 && threadIdx.x == 0;
  if (clock) stamp[0] = now_ns();
  const int64_t N = rows * n, NG = (N + 31) / 32;
  const int64_t NC = (NG + GROUPS - 1) / GROUPS;   // chunks
  // block b takes the chunks b, b + gridDim.x, ... (the grid sweeps the
  // words together, so the targets it gathers are often still in L2);
  // a warp loads the flags of 32 of its chunks at once, a lane each
  const int64_t n_it =
      blockIdx.x < NC ? (NC - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int k = 1;
  for (; k <= MAX_PASSES; ++k) {
    const uint32_t* cur = (k & 1) ? A : B;
    uint32_t* nxt = (k & 1) ? B : A;
    // warp w's flag for chunk ci: F[ci * WARPS + w], from pass k - 1 in
    // fcur (pass 1 takes every group), for pass k + 1 in fnxt
    const uint8_t* fcur = (k & 1) ? F1 : F0;
    uint8_t* fnxt = (k & 1) ? F0 : F1;
    unsigned n_live = 0;
    bool mv = false;
    for (int64_t it0 = 0; it0 < n_it; it0 += 32) {
      const int m_end = (int)(n_it - it0 < 32 ? n_it - it0 : 32);
      const int64_t mine = blockIdx.x + (it0 + lane) * gridDim.x;
      const unsigned flag =
          lane >= m_end ? 0u
                        : (k == 1 ? 0xFFu : __ldcg(fcur + mine * WARPS + warp));
      unsigned keep_mine = 0;
      for (int m = 0; m < m_end; ++m) {
        const unsigned on = __shfl_sync(FULL, flag, m);
        if (!on) continue;   // uniform over the warp
        const int64_t ci = blockIdx.x + (it0 + m) * gridDim.x;
        const unsigned keep = pass_chunk(cur, nxt, N, ci * GROUPS, on,
                                         (uint32_t)k, n_live, mv);
        if (lane == m) keep_mine = keep;
      }
      if (lane < m_end) fnxt[mine * WARPS + warp] = (uint8_t)keep_mine;
    }
    n_live = __reduce_add_sync(FULL, n_live);
    if ((threadIdx.x & 31) == 0 && n_live)
      atomicAdd(live + k, (unsigned long long)n_live);
    if (__syncthreads_or(mv) && threadIdx.x == 0) moved[k] = 1;
    grid.sync();
    if (clock) stamp[k] = now_ns();
    if (!__ldcg(moved + k)) break;   // the same value in every block
  }
  if (k > MAX_PASSES) k = MAX_PASSES;   // a cycle (a plan that breaks the
                                        // planner's rules) stops here
  // output: four words to four bytes a thread where out is aligned
  const uint32_t* fin = (k & 1) ? B : A;
  const int64_t m = n - lo;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * THREADS;
  for (int64_t r = 0; r < rows; ++r) {
    const uint32_t* pr = fin + r * n + lo;
    uint8_t* o = out + r * m;
    const bool vec = ((reinterpret_cast<uintptr_t>(o) |
                       reinterpret_cast<uintptr_t>(pr)) & 15) == 0;
    const int64_t m4 = vec ? m / 4 : 0;
    for (int64_t i = tid; i < m4; i += step) {
      const uint4 v = __ldcg(reinterpret_cast<const uint4*>(pr) + i);
      reinterpret_cast<uint32_t*>(o)[i] = (v.x & 0xFF) | (v.y & 0xFF) << 8 |
                                          (v.z & 0xFF) << 16 | v.w << 24;
    }
    for (int64_t i = 4 * m4 + tid; i < m; i += step)
      o[i] = (uint8_t)__ldcg(pr + i);
  }
  if (clock) {
    if (passes) *passes = k;
    stamp[MAX_PASSES + 1] = now_ns();
  }
}

// the doubling scratch: [A: N words | B: N words | live (MAX_PASSES + 1
// x 8 B) | stamp (MAX_PASSES + 2 x 8 B) | moved (MAX_PASSES + 1 x 4 B) |
// two flag arrays (a byte a warp and chunk of GROUPS groups)]
struct Layout {
  uint32_t *A, *B;
  unsigned long long *live, *stamp;
  unsigned* moved;
  uint8_t *F0, *F1;
};

constexpr size_t CTL_BYTES =
    (MAX_PASSES + 1) * (8 + 4) + (MAX_PASSES + 2) * 8;
int64_t flag_bytes(int64_t N) {
  return ((N + 31) / 32 + GROUPS - 1) / GROUPS * WARPS;
}

Layout layout(int32_t* scratch, int64_t N) {
  Layout L;
  L.A = reinterpret_cast<uint32_t*>(scratch);
  L.B = L.A + N;
  L.live = reinterpret_cast<unsigned long long*>(
      (reinterpret_cast<uintptr_t>(L.B + N) + 7) & ~(uintptr_t)7);
  L.stamp = L.live + MAX_PASSES + 1;
  L.moved = reinterpret_cast<unsigned*>(L.stamp + MAX_PASSES + 2);
  L.F0 = reinterpret_cast<uint8_t*>(L.live) + CTL_BYTES;
  L.F1 = L.F0 + flag_bytes(N);
  return L;
}

int64_t core_ints(int64_t S, int64_t cap) {
  return S * tiles(cap) + tbz_doubling_scratch_ints(S * (tbz::W + cap));
}

// Resolve S rows whose masked lengths `lens` have the exclusive scan
// `starts` (over all rows; each row is rebased by its first entry); row
// r of `out` gets coordinates [lo, W + cap) of row r, and *passes
// (device) the doubling pass count.
int resolve_rows(const int32_t* lens, const int32_t* di, const int32_t* rv,
                 const int32_t* starts, int64_t S, int64_t T,
                 const uint8_t* input, int64_t n_input,
                 const uint8_t* window, int64_t cap, uint8_t* out,
                 int64_t lo, int32_t* scratch, int32_t* passes,
                 cudaStream_t s) {
  const int64_t n = tbz::W + cap;
  if (n > 0x7FFFFFFF || cap < 0 || S <= 0 || S > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t NT = tiles(cap);
  int32_t* tf = scratch;
  int32_t* dbl = scratch + S * NT;
  if (NT > 0)
    cudaMemsetAsync(tf, 0xFF, (size_t)(S * NT) * sizeof(int32_t), s);
  if (T > 0 && NT > 0)
    mark_tiles<<<dim3(blocks(T), (unsigned)S), THREADS, 0, s>>>(
        lens, starts, T, cap, NT, tf);
  uint32_t* A = tbz_doubling_words(dbl);
  expand<<<dim3((unsigned)((n + TILE - 1) / TILE), (unsigned)S), THREADS, 0,
           s>>>(lens, di, rv, starts, T, input, n_input, window, cap, tf,
                NT, A);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return tbz_doubling(dbl, S, n, lo, out, passes, s);
}

// ---- K7 on one SM: a row of at most ONCHIP_CAP output bytes a block ----
//
// Row coordinates are [0, cap): the window never becomes state. After
// the tokens are read, a byte's state is a 16-bit parent par[q] and an
// 8-bit value val[q] in shared memory: par[q] == q an original root
// (literal, stored, past the total) with its value; par[q] < q a
// pointer to its parent; par[q] == SETTLED a match byte whose parent
// lies in the window, its value read from there (one hop to a root, as
// in tbz). Parents lie strictly before their bytes, so the row settles
// in order, a step of ON_STEP bytes at a time, each byte taking its
// value and its depth (hops to its root) from its parent; the deepest
// chain D gives tbz's Jacobi pass count, 1 + ceil(log2 D) (1 for D <=
// 1): tbz's pass j moves a pointer iff some byte lies deeper than
// 2^(j-1). The last byte (q == 65535) is never a parent, so its two
// readings of 0xFFFF (a root, or settled from the window: depth 0 or 1)
// never change D's count.
constexpr int ON_THREADS = 1024;
constexpr int ON_ITEMS = 8;                        // bytes a thread a step
constexpr int ON_STEP = ON_THREADS * ON_ITEMS;     // 8,192 bytes
// 16-bit parents; 3 B a byte and the staging fit 227 KB of shared memory
constexpr int64_t ONCHIP_CAP = 65536;
constexpr int ON_CHUNK = 2 * ON_THREADS;           // tokens staged at once
constexpr uint16_t SETTLED = 0xFFFF;
constexpr uint32_t SET = 0x80000000u;

__host__ __device__ inline int64_t pad16(int64_t cap) { return (cap + 15) / 16 * 16; }

// [par: uint16[pad16(cap)] | val: uint8[pad16(cap)] | staging: starts,
//  dist, rv int32[ON_CHUNK] each, once the tokens are read a step's hops
//  uint16[ON_STEP] in their place]
static_assert(2 * ON_STEP <= 3 * ON_CHUNK * 4, "a step's hops fit the staging");
inline size_t onchip_smem(int64_t cap) {
  return (size_t)(3 * pad16(cap)) + 3 * ON_CHUNK * sizeof(int32_t);
}

// Block-wide exclusive scan of a thread's two lengths (a, b) in int64;
// returns the thread's offset, *total the block's sum.
__device__ __forceinline__ int64_t scan_pair(int64_t a, int64_t b,
                                             int64_t* wsum, int64_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t s = a + b;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t x = __shfl_up_sync(FULL, s, d);
    if (lane >= d) s += x;
  }
  if (lane == 31) wsum[warp] = s;
  __syncthreads();
  if (warp == 0) {
    int64_t v = wsum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t x = __shfl_up_sync(FULL, v, d);
      if (lane >= d) v += x;
    }
    wsum[lane] = v;
  }
  __syncthreads();
  *total = wsum[31];
  return s - a - b + (warp ? wsum[warp - 1] : 0);
}

// One block resolves row blockIdx.x: tokens to initial states (chunks of
// ON_CHUNK tokens scanned in the block, each byte's token by a binary
// search over the chunk's starts), the steps in order, then the row's
// cap bytes out in 16-byte stores and its pass count into *passes by
// atomicMax.
__global__ void __launch_bounds__(ON_THREADS, 1)
onchip_rows(const int32_t* __restrict__ ol, const int32_t* __restrict__ di,
            const int32_t* __restrict__ rv, const int32_t* __restrict__ nts,
            int64_t T, const uint8_t* __restrict__ input, int64_t n_input,
            const uint8_t* __restrict__ window, int64_t cap, uint8_t* out,
            int32_t* passes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t wsum[32];
  __shared__ int deep_sh;
  const int64_t r = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t cp = pad16(cap);
  uint16_t* par = reinterpret_cast<uint16_t*>(smem);
  uint8_t* val = smem + 2 * cp;
  int32_t* st = reinterpret_cast<int32_t*>(smem + 3 * cp);
  int32_t* sd = st + ON_CHUNK;
  int32_t* sv = sd + ON_CHUNK;

  if (tid == 0) deep_sh = 0;
  // every byte a root of value 0 (the bytes past the total stay so)
  for (int64_t q = (int64_t)tid * 8; q < cp; q += 8 * ON_THREADS) {
    const uint32_t a = (uint32_t)q;
    *reinterpret_cast<uint4*>(par + q) =
        make_uint4(a | (a + 1) << 16, (a + 2) | (a + 3) << 16,
                   (a + 4) | (a + 5) << 16, (a + 6) | (a + 7) << 16);
    if ((q & 15) == 0) *reinterpret_cast<uint4*>(val + q) = make_uint4(0, 0, 0, 0);
  }

  // tokens, ON_CHUNK at a time, until the row's bytes pass cap
  const int64_t nt = nts[r] < 0 ? 0 : (nts[r] < T ? nts[r] : T);
  const int32_t *olr = ol + r * T, *dr = di + r * T, *vr = rv + r * T;
  const uint8_t* in = input + r * n_input;
  const uint8_t* win = window + r * tbz::W;
  int64_t off = 0;
  for (int64_t c0 = 0; c0 < nt && off < cap; c0 += ON_CHUNK) {
    const int m = (int)(nt - c0 < ON_CHUNK ? nt - c0 : ON_CHUNK);
    const int i0 = 2 * tid;
    const int64_t a = i0 < m ? max(olr[c0 + i0], 0) : 0;
    const int64_t b = i0 + 1 < m ? max(olr[c0 + i0 + 1], 0) : 0;
    int64_t total;
    const int64_t x = off + scan_pair(a, b, wsum, &total);
    if (i0 < m) {
      st[i0] = (int32_t)(x < cap ? x : cap);
      sd[i0] = dr[c0 + i0];
      sv[i0] = vr[c0 + i0];
    }
    if (i0 + 1 < m) {
      st[i0 + 1] = (int32_t)(x + a < cap ? x + a : cap);
      sd[i0 + 1] = dr[c0 + i0 + 1];
      sv[i0 + 1] = vr[c0 + i0 + 1];
    }
    __syncthreads();
    // within a row positions fit int32 (cap <= ONCHIP_CAP)
    const int cs = (int)off, ce = (int)(off + total < cap ? off + total : cap);
    // a thread a group of 8 bytes: the first byte's token by a binary
    // search, its fields held in registers while the next bytes lie in it
    for (int g = cs / 8 + tid; g * 8 < ce; g += ON_THREADS) {
      const int qa = max(g * 8, cs), qb = min(g * 8 + 8, ce);
      int lo = 0, hi = m - 1;   // the last token starting at or before qa
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (st[mid] <= qa) lo = mid; else hi = mid - 1;
      }
      int ts = st[lo], te = lo + 1 < m ? st[lo + 1] : ce;
      int d = sd[lo], v = sv[lo];
      uint16_t pv[8];
      uint8_t vv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = g * 8 + i;
        pv[i] = (uint16_t)q;
        vv[i] = 0;
        if (q < qa || q >= qb) continue;
        while (te <= q) {   // the next token of positive length
          ts = te;
          ++lo;
          te = lo + 1 < m ? st[lo + 1] : ce;
          d = sd[lo];
          v = sv[lo];
        }
        const int jj = q - ts;
        if (d > 0) {
          const int p = ts - d + (jj < d ? jj : (int)((unsigned)jj % (unsigned)d));
          if (p >= 0) {
            pv[i] = (uint16_t)p;
          } else {   // a parent in the window: settled at once
            pv[i] = SETTLED;
            vv[i] = win[p + tbz::W > 0 ? p + tbz::W : 0];
          }
        } else if (v & tbz::STORED_FLAG) {
          const int64_t o = (int64_t)(v & (tbz::STORED_FLAG - 1)) + jj;
          vv[i] = o < n_input ? in[o] : 0;
        } else {
          vv[i] = (uint8_t)(v & 0xFF);
        }
      }
      if (qa == g * 8 && qb == g * 8 + 8) {
        uint32_t w[4], u[2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = pv[2 * i] | (uint32_t)pv[2 * i + 1] << 16;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          u[i] = vv[4 * i] | (uint32_t)vv[4 * i + 1] << 8 |
                 (uint32_t)vv[4 * i + 2] << 16 | (uint32_t)vv[4 * i + 3] << 24;
        *reinterpret_cast<uint4*>(par + g * 8) = make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint2*>(val + g * 8) = make_uint2(u[0], u[1]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int q = g * 8 + i;
          if (q >= qa && q < qb) par[q] = pv[i], val[q] = vv[i];
        }
      }
    }
    off += total;
    __syncthreads();   // the next chunk overwrites the staging
  }

  // Steps of ON_STEP bytes in order: every parent before a step is
  // settled when it starts, so a byte whose parent lies there settles
  // in one round; a chain inside the step jumps (Jacobi, a barrier
  // between a round's reads and its writes), carrying its hops. A
  // settled byte's par holds its depth (hops to its root, saturated at
  // 65,535), the step's hop[] a pointer's hops (0: settled).
  uint16_t* hop = reinterpret_cast<uint16_t*>(smem + 3 * cp);  // staging's
  const int lim = (int)(off < cap ? off : cap);
  int deepest = 0;
  for (int b0 = 0; b0 < lim; b0 += ON_STEP) {
    unsigned live = 0;   // bit i: item i still points into the step
#pragma unroll
    for (int i = 0; i < ON_ITEMS; ++i) {
      const int q = b0 + i * ON_THREADS + tid;
      if (q >= lim) continue;
      const int p = par[q];
      if (p < q) {
        hop[q - b0] = 1;
        live |= 1u << i;
      } else {   // a root (depth 0) or a parent in the window (depth 1)
        par[q] = p > q;
        hop[q - b0] = 0;
        deepest = max(deepest, (int)(p > q));
      }
    }
    while (__syncthreads_or(live)) {
      uint32_t nw[ON_ITEMS];
#pragma unroll
      for (int i = 0; i < ON_ITEMS; ++i) {
        if (!((live >> i) & 1)) continue;
        const int q = b0 + i * ON_THREADS + tid;
        const int t = par[q], h = hop[q - b0];
        const int ht = t < b0 ? 0 : hop[t - b0];
        if (ht == 0) {   // the parent is settled: so is q
          const int d = min(h + (int)par[t], 0xFFFF);
          nw[i] = SET | (uint32_t)val[t] << 16 | d;
        } else {         // jump over the parent
          nw[i] = par[t] | (uint32_t)(h + ht) << 16;
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < ON_ITEMS; ++i) {
        if (!((live >> i) & 1)) continue;
        const int q = b0 + i * ON_THREADS + tid;
        par[q] = (uint16_t)nw[i];
        if (nw[i] & SET) {
          hop[q - b0] = 0;
          val[q] = (uint8_t)(nw[i] >> 16);
          deepest = max(deepest, (int)(nw[i] & 0xFFFF));
          live &= ~(1u << i);
        } else {
          hop[q - b0] = (uint16_t)(nw[i] >> 16);
        }
      }
    }
  }
  // tbz's count from the deepest chain D (at most 65,535: 17 passes)
  deepest = __reduce_max_sync(FULL, deepest);
  if ((tid & 31) == 0) atomicMax(&deep_sh, deepest);
  __syncthreads();
  const int D = deep_sh;
  const int k = D <= 1 ? 1 : 33 - __clz(D - 1);

  // the row's cap bytes, 16 at a time where the row is aligned
  uint8_t* o = out + r * cap;
  int64_t v16 = 0;
  if (((reinterpret_cast<uintptr_t>(o) | (uintptr_t)cap) & 15) == 0) {
    v16 = cap / 16;
    for (int64_t i = tid; i < v16; i += ON_THREADS)
      reinterpret_cast<uint4*>(o)[i] = reinterpret_cast<const uint4*>(val)[i];
  }
  for (int64_t i = 16 * v16 + tid; i < cap; i += ON_THREADS) o[i] = val[i];
  if (tid == 0) atomicMax(passes, k);
}

int resolve_onchip(const int32_t* ol, const int32_t* di, const int32_t* rv,
                   const int32_t* n_tokens, int64_t S, int64_t T,
                   const uint8_t* input, int64_t n_input,
                   const uint8_t* window, int64_t cap, uint8_t* out,
                   int32_t* passes, cudaStream_t s) {
  static bool raised[64];   // the shared-memory limit raised, a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (!raised[dev & 63]) {
    e = cudaFuncSetAttribute(onchip_rows,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)onchip_smem(ONCHIP_CAP));
    if (e != cudaSuccess) return (int)e;
    raised[dev & 63] = true;
  }
  e = cudaMemsetAsync(passes, 0, sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  onchip_rows<<<(unsigned)S, ON_THREADS, onchip_smem(cap), s>>>(
      ol, di, rv, n_tokens, T, input, n_input, window, cap, out, passes);
  return (int)cudaGetLastError();
}

}  // namespace

int64_t tbz_doubling_scratch_ints(int64_t N) {
  return 2 * N + 2 + CTL_BYTES / 4 + (2 * flag_bytes(N) + 3) / 4 + 1;
}

uint32_t* tbz_doubling_words(int32_t* scratch) {
  return reinterpret_cast<uint32_t*>(scratch);
}

int tbz_doubling(int32_t* scratch, int64_t rows, int64_t n, int64_t lo,
                 uint8_t* out, int32_t* passes, cudaStream_t s) {
  static int per_sm[64];   // blocks an SM, a device (0: not asked yet)
  Layout L = layout(scratch, rows * n);
  cudaError_t e = cudaMemsetAsync(L.live, 0, CTL_BYTES, s);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int& per = per_sm[dev & 63];
  if (per == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, doubling,
                                                      THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    if (per < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const int64_t want = (rows * n + 32 * GROUPS - 1) / (32 * GROUPS);  // chunks
  const int64_t most = (int64_t)sms * per;
  const unsigned grid = (unsigned)(want < 1 ? 1 : (want < most ? want : most));
  void* args[] = {&L.A, &L.B, &rows, &n, &lo, &out, &L.F0, &L.F1,
                  &L.live, &L.stamp, &L.moved, &passes};
  return (int)cudaLaunchCooperativeKernel((const void*)doubling, grid,
                                          THREADS, args, 0, s);
}

int64_t tbz_resolve_core_scratch_ints(int64_t cap) { return core_ints(1, cap); }

int tbz_resolve_from_starts(const int32_t* ol, const int32_t* di,
                            const int32_t* rv, const int32_t* starts,
                            int64_t T, const uint8_t* input, int64_t n_input,
                            const uint8_t* window, int64_t cap, uint8_t* out,
                            int32_t* scratch, int32_t* passes,
                            cudaStream_t s) {
  return resolve_rows(ol, di, rv, starts, 1, T, input, n_input, window, cap,
                      out, 0, scratch, passes, s);
}

TBZ_API int64_t tbz_resolve_scratch_ints(int64_t T, int64_t cap) {
  return T + tbz_scan_scratch_ints(T) + core_ints(1, cap);
}

// Tokens past n_tokens (the tape's padding) take no part: only the first
// n_tokens lengths are scanned and searched.
TBZ_API int tbz_resolve(const int32_t* ol, const int32_t* di,
                        const int32_t* rv, int64_t n_tokens, int64_t T,
                        const uint8_t* input, int64_t n_input,
                        const uint8_t* window, int64_t cap, uint8_t* out,
                        int32_t* scratch, int32_t* passes, cudaStream_t s) {
  const int64_t nt = n_tokens < 0 ? 0 : (n_tokens < T ? n_tokens : T);
  int32_t* starts = scratch;
  int32_t* scan_scratch = scratch + T;
  int32_t* core = scan_scratch + tbz_scan_scratch_ints(T);
  const int err = tbz_exclusive_scan(ol, starts, nt, nullptr, scan_scratch, s);
  if (err) return err;
  return tbz_resolve_from_starts(ol, di, rv, starts, nt, input, n_input,
                                 window, cap, out, core, passes, s);
}

TBZ_API int64_t tbz_resolve_onchip_cap() { return ONCHIP_CAP; }

TBZ_API int64_t tbz_resolve_batch_scratch_ints(int64_t S, int64_t T,
                                               int64_t cap) {
  if (cap <= ONCHIP_CAP) return 0;   // onchip_rows keeps its state on chip
  return 2 * S * T + tbz_scan_scratch_ints(S * T) + core_ints(S, cap);
}

// Kernel 7: S tapes int32[S, T] (row r valid below n_tokens[r], a device
// array), stored runs read from input uint8[S, n_input], windows
// uint8[S, W]; out uint8[S, cap] holds each row's output, window stripped.
// *onchip (host memory) reports the path taken: 1 onchip_rows, 0 the
// grid-wide chain.
TBZ_API int tbz_resolve_batch(const int32_t* ol, const int32_t* di,
                              const int32_t* rv, const int32_t* n_tokens,
                              int64_t S, int64_t T, const uint8_t* input,
                              int64_t n_input, const uint8_t* window,
                              int64_t cap, uint8_t* out, int32_t* scratch,
                              int32_t* passes, int32_t* onchip,
                              cudaStream_t s) {
  *onchip = 0;
  if (S <= 0 || S > 65535 || T <= 0 || cap < 0)
    return (int)cudaErrorInvalidValue;
  if (cap <= ONCHIP_CAP) {
    *onchip = 1;
    return resolve_onchip(ol, di, rv, n_tokens, S, T, input, n_input, window,
                          cap, out, passes, s);
  }
  int32_t* lens = scratch;
  int32_t* starts = scratch + S * T;
  int32_t* scan_scratch = scratch + 2 * S * T;
  int32_t* core = scan_scratch + tbz_scan_scratch_ints(S * T);
  mask_lens<<<dim3(blocks(T), (unsigned)S), THREADS, 0, s>>>(
      ol, T, n_tokens, lens);
  int err = (int)cudaGetLastError();
  if (err) return err;
  // one scan over every row; resolve_rows rebases each row
  err = tbz_exclusive_scan(lens, starts, S * T, nullptr, scan_scratch, s);
  if (err) return err;
  return resolve_rows(lens, di, rv, starts, S, T, input, n_input, window,
                      cap, out, tbz::W, core, passes, s);
}
