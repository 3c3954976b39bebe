// Kernel 1: flat 2^15-entry Huffman decode tables for all B candidate
// blocks of a stream, litlen and distance, in one launch.
//
// Replaces tbz/ops/tokenize_device.py:build_flat_table (vmapped at
// tbz/ops/batched.py:179-182), which fills each table by scatter +
// cumsum over the canonical order and one 2^15 permutation gather. Both
// tables take zlib's single-1-bit exception (allow_single), as tbz's
// batched decode builds them.
//
// Bound: bytes. The 2 x B tables of 128 KB each are the output; the
// code lengths (<= 288 ints a table) are noise beside them.
//
// What held the first port back (one 1024-thread block a table, staged
// through 128 KB of shared memory): one block fit an SM, so a B = 1 call
// used 2 SMs; thread 0 counted, summed and built next_code alone, each
// symbol's rank was an O(n) loop, the slots were filled symbol after
// symbol, and the attribute call ran on every launch.
//
// Design: the grid covers (table, root-slot range); a block of
// SLOTS_PER_BLOCK threads owns that many of the table's 1024 root slots.
// A thread owning root slot r writes the 32 slots r + 1024 j straight to
// global memory: the threads of a warp write 32 consecutive words for
// each j, so every store is coalesced and every output word is written
// once. Those 32 slots are the 15-bit code values V0 + u (V0 = rev10(r)
// << 5, u = rev5(j)), a run of 32 consecutive left-aligned code values,
// so one binary search over the sorted canonical starts finds the
// symbol at V0, and a forward walk covers the run (one step for every
// code of 10 bits or less, which spans the whole run). The per-table
// header (counts, Kraft sum, first code of each length, each symbol's
// canonical rank) is built by every block in parallel: __match_any_sync
// ranks the symbols of each 32-symbol chunk by length, a thread per
// length sums the chunks, and warp shuffles scan the 15 lengths. ~4 KB
// of static shared memory, no attribute call, several blocks an SM.
//
// Rules kept from the old builder: lengths clamped to 0..15; err =
// ERR_BAD_HUFFMAN for an over-subscribed code, and for an incomplete one
// unless it is a single 1-bit code; an uncovered slot holds
// INVALID_ENTRY; all-zero lengths give an all-invalid table with err 0.
// Where the Kraft sum is at most 2^15 (every complete or incomplete
// code) the table equals tbz's slot for slot. An over-subscribed code's
// table (err != 0, so its content is never trusted) keeps the canonical
// codes that fit in 15 bits and leaves out the ones past 2^15, where the
// old builders wrapped them onto earlier codes' slots. So every table this
// kernel writes is prefix-free: an entry of n bits repeats at every slot
// that shares its low n bits, and the first 2^n slots answer every code
// of n bits or less. lanes.cu's shared-memory roots rely on that.
#include "common.cuh"

namespace {

constexpr int SLOTS_PER_BLOCK = 128;           // threads a block
constexpr int BLOCKS_PER_TABLE = 1024 / SLOTS_PER_BLOCK;
constexpr int NWARPS = SLOTS_PER_BLOCK / 32;
constexpr int MAX_SYMS = 288;
constexpr int NCHUNKS = MAX_SYMS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(SLOTS_PER_BLOCK)
build_tables(const int32_t* __restrict__ lit_lens,
             const int32_t* __restrict__ dist_lens,
             const uint32_t* __restrict__ lit_c,
             const uint32_t* __restrict__ dist_c,
             int32_t* __restrict__ lit_tabs, int32_t* __restrict__ dist_tabs,
             int32_t* lit_errs, int32_t* dist_errs) {
  __shared__ int chunk_off[NCHUNKS][16];  // count, then exclusive offset
  __shared__ uint8_t sym_len[MAX_SYMS];
  __shared__ uint8_t sym_rank[MAX_SYMS];  // rank within its chunk
  __shared__ int first_pos[16];           // canonical index of length l
  __shared__ int first_code[16];          // left-aligned first code
  __shared__ int start[MAX_SYMS];         // canonical order, increasing
  __shared__ uint32_t entry[MAX_SYMS];
  __shared__ int n_used;

  const int b = blockIdx.x / BLOCKS_PER_TABLE;
  const int part = blockIdx.x % BLOCKS_PER_TABLE;
  const bool is_lit = blockIdx.y == 0;
  const int n_syms = is_lit ? 288 : 32;
  const int n_chunks = n_syms / 32;
  const int32_t* lens = (is_lit ? lit_lens : dist_lens) + (int64_t)b * n_syms;
  const uint32_t* consts = is_lit ? lit_c : dist_c;
  int32_t* out = (is_lit ? lit_tabs : dist_tabs) + ((int64_t)b << tbz::TBITS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. each chunk of 32 symbols: counts and ranks by length
  for (int c = warp; c < n_chunks; c += NWARPS) {
    const int i = c * 32 + lane;
    const int raw = lens[i];
    const int l = raw < 0 ? 0 : (raw > 15 ? 15 : raw);
    const unsigned same = __match_any_sync(FULL, l);
    sym_len[i] = (uint8_t)l;
    sym_rank[i] = (uint8_t)__popc(same & ((1u << lane) - 1u));
    if (lane < 16) chunk_off[c][lane] = 0;
    __syncwarp();
    if (l > 0 && lane == __ffs(same) - 1) chunk_off[c][l] = __popc(same);
  }
  __syncthreads();

  // 2. warp 0: sum the chunks per length (lane = length), then scan the
  // lengths: canonical index and left-aligned first code of each length
  if (warp == 0) {
    int cnt = 0;
    if (lane < 16) {
      for (int c = 0; c < n_chunks; ++c) {
        const int v = chunk_off[c][lane];
        chunk_off[c][lane] = cnt;
        cnt += v;
      }
    }
    if (lane == 0 || lane >= 16) cnt = 0;       // length 0 is unused
    const int mass = lane < 16 ? cnt << (15 - lane) : 0;
    int pos = cnt, code = mass;                  // inclusive scans
    for (int d = 1; d < 16; d <<= 1) {
      const int p = __shfl_up_sync(FULL, pos, d);
      const int q = __shfl_up_sync(FULL, code, d);
      if (lane >= d) {
        pos += p;
        code += q;
      }
    }
    if (lane < 16) {
      first_pos[lane] = pos - cnt;
      first_code[lane] = code - mass;
    }
    const int used = __shfl_sync(FULL, pos, 15);
    const int kraft = __shfl_sync(FULL, code, 15);
    const unsigned has = __ballot_sync(FULL, cnt > 0);
    if (lane == 0) {
      n_used = used;
      if (part == 0) {
        const int max_len = has ? 31 - __clz(has) : 0;
        const bool single_ok = max_len == 1 && used == 1;
        const bool bad = kraft > tbz::TSIZE ||
                         (kraft < tbz::TSIZE && used > 0 && !single_ok);
        (is_lit ? lit_errs : dist_errs)[b] = bad ? tbz::ERR_BAD_HUFFMAN : 0;
      }
    }
  }
  __syncthreads();

  // 3. every used symbol's place in canonical order and its start
  for (int i = tid; i < n_syms; i += SLOTS_PER_BLOCK) {
    const int l = sym_len[i];
    if (!l) continue;
    const int rank = chunk_off[i >> 5][l] + sym_rank[i];
    const int p = first_pos[l] + rank;
    start[p] = first_code[l] + (rank << (15 - l));
    entry[p] = consts[i] | (uint32_t)l;
  }
  __syncthreads();

  // 4. the 32 aliases of this thread's root slot
  const int r = part * SLOTS_PER_BLOCK + tid;
  const int n = n_used;
  const int v0 = (int)(__brev((unsigned)r) >> 22) << 5;
  int k = -1;
  if (n > 0) {  // the last symbol whose start is <= v0 (start[0] == 0)
    int lo = 0, hi = n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (start[mid] <= v0) lo = mid; else hi = mid - 1;
    }
    k = lo;
  }
  const auto span_end = [&](int i) {
    return start[i] + (1 << (15 - (int)(entry[i] & 0xF)));
  };
  if (k >= 0 && span_end(k) >= v0 + 32) {
    const int32_t e = (int32_t)entry[k];
    for (int j = 0; j < 32; ++j) out[r + (j << 10)] = e;
    return;
  }
  for (int u = 0; u < 32; ++u) {
    const int v = v0 + u;
    while (k >= 0 && k + 1 < n && start[k + 1] <= v) ++k;
    const uint32_t e =
        k >= 0 && v < span_end(k) ? entry[k] : tbz::INVALID_ENTRY;
    out[r + ((int)(__brev((unsigned)u) >> 27) << 10)] = (int32_t)e;
  }
}

}  // namespace

TBZ_API int tbz_build_tables(const int32_t* lit_lens, const int32_t* dist_lens,
                             int64_t B, const uint32_t* lit_c,
                             const uint32_t* dist_c, int32_t* lit_tabs,
                             int32_t* dist_tabs, int32_t* lit_errs,
                             int32_t* dist_errs, cudaStream_t s) {
  if (B <= 0) return 0;
  if (B > (int64_t)0x7FFFFFFF / BLOCKS_PER_TABLE) return (int)cudaErrorInvalidValue;
  build_tables<<<dim3((unsigned)(B * BLOCKS_PER_TABLE), 2), SLOTS_PER_BLOCK,
                 0, s>>>(lit_lens, dist_lens, lit_c, dist_c, lit_tabs,
                         dist_tabs, lit_errs, dist_errs);
  return (int)cudaGetLastError();
}
