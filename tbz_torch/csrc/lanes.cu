// Kernel 2: lockstep speculative decode of L lanes x S steps.
//
// Replaces tbz/ops/batched.py:_lanes_multi, a lax.scan over S steps that
// reads each symbol through an overlapping 3-word row view of the stream
// (one row gather per step, a TPU gather workaround).
//
// Bound: bytes. The lane tape (3 x L x S int32 written, the fill after a
// lane stops included) dominates; each lane's bits and its table entries
// are read once. The loop itself is a chain of dependent lookups (table
// entry -> bit position -> next entry), so at small L the time is S
// steps x the step's latency.
//
// What held the first port back: one thread a lane in 128-thread blocks
// (two blocks on the speculative tier's 256 lanes), and each step chained
// four dependent global loads (a 64-bit peek, the litlen entry, a peek,
// the distance entry) into 2 x B x 128 KB of tables, far past the L2.
//
// Design (probe_tables_lanes.py --variants times the alternatives):
// - Root tables in shared memory. The first 2^11 litlen and 2^9 distance
//   entries of a flat table built by tables.cu are exact roots: entry
//   peek & (2^n - 1) is the right one whenever its code length (e & 0xF)
//   is n or less (such an entry repeats at all its aliases; see
//   tables.cu). On the 1 MiB and 64 MiB L6 plans 0.09% of the lookups
//   miss an 11/9-bit root (0.36% a 10/10-bit one).
// - Misses off the fast path. A step runs both lookups from the roots;
//   if any lane of the warp met an entry past its root (a code of 12-15
//   bits, INVALID_ENTRY, or a lane whose table is not staged), the warp
//   redoes the step from the saved window with the 2^15 tables in global
//   memory. A branch per lookup, or a predicated global load, cost ~20%
//   of the step even where nothing missed.
// - Staging. A block of THREADS lanes stages the roots (10 KB a table) of
//   the first K runs of equal tbl_idx among its lanes; lanes of one
//   segment are contiguous (_plan_lanes) and padding lanes point at table
//   0, so 32 lanes span at most 3 tables on the 64 MiB plan. Any other
//   lane (a shuffled tbl_idx) is exact through the global path.
// - One warp a block and 30 KB of shared memory, so 7 blocks fit an SM
//   and the 64 MiB plan's ~680 real blocks run in one wave (64-lane
//   blocks staging 4 tables: 1.6x slower there); the 1 MiB plan (~350
//   real lanes) and the speculative tier (L <= 256) spread over 11 and 8
//   SMs.
// - A 64-bit window of the stream in registers (two words and the bits
//   consumed): a peek is one funnel shift, a drop one add, and a refill
//   moves the window a word on, the word after it loaded one refill
//   ahead. A refill before each of a step's two lookups leaves 32 bits or
//   more, and a lookup with its extra bits takes at most 28 (entries from
//   tables.cu: length extra <= 5, distance extra <= 13). Every load stays
//   inside the staging upload's 16 bytes of slack: a lane steps only from
//   a bit <= total_bits, a refill happens at most 28 bits past it and
//   loads the word after the window, at most 3 words past total_bits'.
// - Coalesced slot-major stores ([S, L], lane fastest): every lane of a
//   warp stores at the same step, a stopped lane its no-emit values
//   (-1, 0, 0); once a whole warp has stopped it fills the rest in a
//   tight loop.
//
// Emit rules are those of batched.py:136-152: invalid or underrun set
// `bad`; crossed is next_bit >= lane_end; packed = len 9 bits | literal 8
// bits at bit 9 | EOB flag at bit 17. A lane that starts at or past
// total_bits underruns at its first step (every entry has 1-15 bits), so
// it emits nothing and reads nothing.
#include "common.cuh"

namespace {

constexpr int THREADS = 32;
constexpr int K = 3;                    // staged tables a block
constexpr int LBITS = 11;               // litlen root: 2^11 entries
constexpr int DBITS = 9;                // distance root: 2^9 entries
constexpr int LSIZE = 1 << LBITS, DSIZE = 1 << DBITS;
constexpr int INV = K * (LSIZE + DSIZE);  // the invalid word's index
constexpr unsigned FULL = 0xFFFFFFFFu;

// A 64-bit window (lo, hi) of the stream and the bits of it consumed, o:
// a peek is one funnel shift while o < 32, and a refill moves the window
// one word on when o reaches 32.
struct BitBuf {
  uint32_t lo, hi;    // the window: stream words wi, wi + 1
  int o;              // consumed bits of the window
  uint32_t next;      // word wi + 2
  const uint32_t* p;  // word wi + 3

  __device__ __forceinline__ void init(const uint32_t* __restrict__ d,
                                       int bit) {
    const uint32_t* w = d + (bit >> 5);
    lo = __ldg(w);
    hi = __ldg(w + 1);
    next = __ldg(w + 2);
    p = w + 3;
    o = bit & 31;
  }
  __device__ __forceinline__ void refill(bool on) {
    if (on && o >= 32) {
      lo = hi;
      hi = next;
      next = __ldg(p++);
      o -= 32;
    }
  }
  // the 32 bits from o on (o < 32)
  __device__ __forceinline__ uint32_t peek() const {
    return __funnelshift_r(lo, hi, o);
  }
  __device__ __forceinline__ void drop(int n) { o += n; }
};

// A root entry: one shared load from a 32-bit shared address.
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// One lane's lookups and symbol, from the lane's window `bb` (advanced
// past the symbol). Fast (SLOW = false): both lookups from the shared
// roots, and `miss` says an entry lies past a root (the caller then redoes
// the step); slow: such an entry is read from the full table.
struct Lane {
  uint32_t lroot, droot, lmask, dmask;  // the roots' shared addresses
  const int32_t* lit;                   // the full tables of the lane
  const int32_t* dist;
};

struct Sym {
  int op, used, length, d;
  uint32_t e;
  bool is_match, invalid, miss;
};

template <bool SLOW>
__device__ __forceinline__ Sym decode(BitBuf& bb, const Lane& ln,
                                      bool active) {
  Sym r;
  bb.refill(active);
  const uint32_t pk = bb.peek();
  const uint32_t p = pk & 0x7FFF;
  uint32_t e = lds(ln.lroot + ((p & ln.lmask) << 2));
  const bool lmiss = (int)(e & 0xF) > LBITS;
  if (SLOW && lmiss) e = (uint32_t)__ldg(ln.lit + p);
  const int nb = tbz::e_nbits(e), ex = tbz::e_extra(e);
  const int exc = ex < 13 ? ex : 13;
  r.op = tbz::e_op(e);
  r.is_match = r.op == tbz::OP_MATCH;
  r.length = tbz::e_val(e) + (int)((pk >> nb) & ((1u << exc) - 1u));
  const int mex = r.is_match ? ex : 0;
  bb.drop(nb + mex);
  bb.refill(active);
  const uint32_t qk = bb.peek();
  const uint32_t q = qk & 0x7FFF;
  uint32_t de = lds(ln.droot + ((q & ln.dmask) << 2));
  const bool dmiss = r.is_match && (int)(de & 0xF) > DBITS;
  if (SLOW && dmiss) de = (uint32_t)__ldg(ln.dist + q);
  const int dnb = r.is_match ? tbz::e_nbits(de) : 0;
  const int dex = r.is_match ? tbz::e_extra(de) : 0;
  const int dexc = dex < 13 ? dex : 13;
  r.d = tbz::e_val(de) + (int)((qk >> dnb) & ((1u << dexc) - 1u));
  bb.drop(dnb + dex);
  r.used = nb + mex + dnb + dex;
  r.invalid = r.op == tbz::OP_INVALID ||
              (r.is_match && tbz::e_op(de) != tbz::OP_MATCH);
  r.e = e;
  r.miss = active && (lmiss || dmiss);
  return r;
}

__global__ void __launch_bounds__(THREADS)
lanes(const uint32_t* __restrict__ data, const int32_t* __restrict__ lit,
      const int32_t* __restrict__ dist, const int32_t* __restrict__ tbl_idx,
      const int32_t* __restrict__ lane_starts,
      const int32_t* __restrict__ lane_ends, int total_bits, int L, int S,
      int32_t* __restrict__ starts, int32_t* __restrict__ packed,
      int32_t* __restrict__ dists, int32_t* __restrict__ exits,
      int32_t* __restrict__ ok) {
  // litlen roots [K][LSIZE], distance roots [K][DSIZE], an invalid word
  __shared__ __align__(16) uint32_t roots[INV + 4];
  __shared__ int run_tbl[K];
  __shared__ int warp_runs[THREADS / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l = blockIdx.x * THREADS + tid;
  const bool real = l < L;
  const int t = real ? tbl_idx[l] : -1;

  // runs of equal tbl_idx among the block's lanes, numbered in order
  const int tp = (tid > 0 && real) ? tbl_idx[l - 1] : -1;
  const bool run_start = real && (tid == 0 || t != tp);
  const unsigned starts_mask = __ballot_sync(FULL, run_start);
  if (lane == 0) warp_runs[warp] = __popc(starts_mask);
  __syncthreads();
  int run = __popc(starts_mask & ((2u << lane) - 1u)) - 1;
  int n_runs = 0;
  for (int w = 0; w < THREADS / 32; ++w) {
    if (w < warp) run += warp_runs[w];
    n_runs += warp_runs[w];
  }
  if (run_start && run < K) run_tbl[run] = t;
  __syncthreads();

  // stage the roots of the first K runs (16-byte loads)
  const int staged = n_runs < K ? n_runs : K;
  uint4* roots4 = reinterpret_cast<uint4*>(roots);
  for (int i = tid; i < staged * (LSIZE / 4); i += THREADS) {
    const int k = i / (LSIZE / 4), q = i % (LSIZE / 4);
    roots4[i] = __ldg(reinterpret_cast<const uint4*>(
                          lit + ((int64_t)run_tbl[k] << tbz::TBITS)) + q);
  }
  for (int i = tid; i < staged * (DSIZE / 4); i += THREADS) {
    const int k = i / (DSIZE / 4), q = i % (DSIZE / 4);
    roots4[K * (LSIZE / 4) + i] = __ldg(reinterpret_cast<const uint4*>(
        dist + ((int64_t)run_tbl[k] << tbz::TBITS)) + q);
  }
  if (tid == 0) roots[INV] = tbz::INVALID_ENTRY;
  __syncthreads();

  // an unstaged lane looks up the invalid word, which sends it to the
  // full table
  const bool own = real && run < K;
  const int lbase = own ? run * LSIZE : INV;
  const int dbase = own ? K * LSIZE + run * DSIZE : INV;
  const uint32_t lmask = own ? LSIZE - 1 : 0, dmask = own ? DSIZE - 1 : 0;
  const uint32_t sroots = (uint32_t)__cvta_generic_to_shared(roots);
  const int64_t toff = (int64_t)(real ? t : 0) << tbz::TBITS;
  const Lane ln{sroots + 4 * lbase, sroots + 4 * dbase, lmask, dmask,
                lit + toff, dist + toff};
  const int end = real ? lane_ends[l] : 0;
  int bit = real ? lane_starts[l] : 0;
  bool active = real && bit < total_bits;
  bool bad = real && !active;
  BitBuf bb{0, 0, 0, 0, data};
  if (active) bb.init(data, bit);
  int32_t* o_starts = starts + l;
  int32_t* o_packed = packed + l;
  int32_t* o_dists = dists + l;

  int s = 0;
  for (; s < S; ++s, o_starts += L, o_packed += L, o_dists += L) {
    if (!__any_sync(FULL, active)) break;
    // every lane of the warp runs the step (a stopped lane's results are
    // dropped and it loads nothing); if a lane's entry lies past its root,
    // the warp redoes the step from the saved window with the full table
    const BitBuf saved = bb;
    Sym r = decode<false>(bb, ln, active);
    if (__any_sync(FULL, r.miss)) {
      bb = saved;
      r = decode<true>(bb, ln, active);
    }
    const int next_bit = bit + r.used;
    const bool emit = active && !r.invalid && next_bit <= total_bits;
    const bool is_end = r.op == tbz::OP_END;
    const int32_t v_start = emit ? bit : -1;
    const int32_t v_packed =
        !emit ? 0
        : is_end ? 1 << 17
        : r.op == tbz::OP_LITERAL ? 1 | (tbz::e_val(r.e) << 9) : r.length;
    const int32_t v_dist = emit && r.is_match ? r.d : 0;
    bad = active ? !emit : bad;
    bit = emit ? next_bit : bit;
    active = emit && !is_end && next_bit < end;
    if (real) {
      *o_starts = v_start;
      *o_packed = v_packed;
      *o_dists = v_dist;
    }
  }
  if (real) {
    for (; s < S; ++s, o_starts += L, o_packed += L, o_dists += L) {
      *o_starts = -1;
      *o_packed = 0;
      *o_dists = 0;
    }
    exits[l] = bit;
    ok[l] = bad ? 0 : 1;
  }
}

}  // namespace

TBZ_API int tbz_lanes(const uint32_t* data, const int32_t* lit,
                      const int32_t* dist, const int32_t* tbl_idx,
                      const int32_t* lane_starts, const int32_t* lane_ends,
                      int total_bits, int L, int S, int32_t* starts,
                      int32_t* packed, int32_t* dists, int32_t* exits,
                      int32_t* ok, cudaStream_t s) {
  if (L <= 0) return 0;
  lanes<<<(L + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      data, lit, dist, tbl_idx, lane_starts, lane_ends, total_bits, L, S,
      starts, packed, dists, exits, ok);
  return (int)cudaGetLastError();
}
