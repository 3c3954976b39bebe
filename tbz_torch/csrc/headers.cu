// The speculative dynamic-header scan on the card: every bit position p
// of a DEFLATE body in [0, 8 * nbytes - 17) is tested as the start of a
// dynamic block (BFINAL, BTYPE = 10, then the header), and every position
// whose header parses is returned, in bit order.
//
// Replaces no TPU kernel: tbz runs this scan on the host
// (tbz/native/frontend.cc `tbz_scan_headers`), and so did the port until
// now (tbz_torch/native/frontend.cc, which stays as the CPU path and the
// parity reference). Acceptance is that function's, rule for rule:
// precode_plausible as the pre-filter (HLIT/HDIST in range, the
// code-length code exactly Kraft-complete), then parse_dynamic_lens
// (code-length code, RLE repeats, missing end-of-block, litlen and
// distance Kraft as kraft_check has them). Bits past the body read as
// zero where peek64 zero-pads; any read that Br::get would take past the
// body's end rejects the position. The C++ scan's cap is gone: every
// accepted position comes back.
//
// Bound: bytes, the compressed body read once (the result is a few
// hundred rows). The work is one cheap test a bit position, ~2% of the
// positions a full header parse, and a handful of hits.
//
// Design, four passes on one stream with no host round trip between them:
// 1. prefilter: a thread a run of 32 positions. Their BTYPE bits come
//    from two words at once (a mask of ~24% of the run); each such
//    position gets precode_plausible from a 64-bit window (funnel shifts
//    of three words through L1). The run's survivors go out as a 32-bit
//    mask and a count.
// 2. scan.cu's exclusive sum of the counts: survivor i lies in the run
//    whose offset is the last one <= i.
// 3. parse: a grid-stride loop over the survivors (their count read on
//    the card), so whole warps run parses; each finds its run by binary
//    search over the offsets and its bit by rank in the mask, parses the
//    header without storing its lengths (counts a length, in registers
//    and a small local array), and marks an accepted position in a second
//    mask and count; a scan of those counts gives each hit its row.
// 4. rows, after the wrapper has read the two counts: each hit parsed
//    again, now writing its 320 lengths (zero past HLIT + HDIST) into its
//    row, in bit order.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROW_INTS = 85;   // hdr, sym, bfinal, hlit, hdist, 320 lengths
constexpr int MAX_BITS = 15;

__constant__ uint8_t kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                     11, 4, 12, 3, 13, 2, 14, 1, 15};

// The body as little-endian 32-bit words, read as zeros from byte nbytes
// on; no word past the body's last is ever loaded.
struct Body {
  const uint32_t* w;
  int64_t nbytes;

  __device__ __forceinline__ uint32_t word(int64_t i) const {
    const int64_t b = i * 4;
    if (b >= nbytes) return 0;
    uint32_t v = __ldg(w + i);
    if (nbytes - b < 4) v &= (1u << (8 * (nbytes - b))) - 1;
    return v;
  }
  // 64 bits from `bit` on (frontend.cc peek64)
  __device__ __forceinline__ uint64_t peek64(int64_t bit) const {
    const int64_t i = bit >> 5;
    const int s = (int)(bit & 31);
    const uint32_t a = word(i), b = word(i + 1), c = word(i + 2);
    return (uint64_t)__funnelshift_r(a, b, s)
           | ((uint64_t)__funnelshift_r(b, c, s) << 32);
  }
};

// Kraft test of the counts of lengths 1-7, each 8 bits of `cnt`: true
// where the code is exactly complete (neither over-subscribed nor
// incomplete; the empty code fails too).
__device__ __forceinline__ bool cl_complete(uint64_t cnt) {
  int left = 1;
#pragma unroll
  for (int l = 1; l <= 7; ++l) {
    left = 2 * left - (int)((cnt >> (8 * l)) & 0xFF);
    if (left < 0) return false;
  }
  return left == 0;
}

// frontend.cc precode_plausible at header bit hb (block start + 3).
__device__ bool precode_plausible(const Body& d, int64_t hb) {
  const uint64_t w0 = d.peek64(hb);
  if ((w0 & 31) > 29 || ((w0 >> 5) & 31) > 29) return false;
  const int ncl = (int)((w0 >> 10) & 15) + 4;
  const uint64_t w = w0 >> 14;
  uint64_t cnt = 0;
  const int first = ncl < 16 ? ncl : 16;
  for (int i = 0; i < first; ++i) cnt += 1ull << (8 * ((w >> (3 * i)) & 7));
  if (ncl > 16) {
    const uint64_t w1 = d.peek64(hb + 14 + 48);
    for (int i = 16; i < ncl; ++i)
      cnt += 1ull << (8 * ((w1 >> (3 * (i - 16))) & 7));
  }
  return cl_complete(cnt);
}

// kraft_check of a litlen or distance code from its counts of lengths
// 1-15: over-subscribed fails; incomplete fails unless the code is empty
// or a single code of one bit.
__device__ bool kraft_ok(const int* counts) {
  int used = 0, max_len = 0, left = 1;
  for (int l = 1; l <= MAX_BITS; ++l) {
    used += counts[l];
    if (counts[l]) max_len = l;
    left = 2 * left - counts[l];
    if (left < 0) return false;
  }
  return used == 0 || left == 0 || max_len == 1;
}

// frontend.cc parse_dynamic_lens from header bit p + 3. Returns whether
// the header is accepted; then *sym_bit is where its symbols start. With
// `lens` (320 bytes) it also writes the code lengths, zeros past
// hlit + hdist.
__device__ bool parse_header(const Body& d, int64_t p, uint8_t* lens,
                             int* hlit_out, int* hdist_out,
                             int64_t* sym_bit) {
  const int64_t nbits = d.nbytes * 8;
  int64_t pos = p + 3;
  if (pos + 14 > nbits) return false;
  const uint64_t h = d.peek64(pos);
  const int hlit = (int)(h & 31) + 257, hdist = (int)((h >> 5) & 31) + 1;
  const int hclen = (int)((h >> 10) & 15) + 4;
  if (hlit > 286 || hdist > 30) return false;
  pos += 14;
  if (pos + 3 * hclen > nbits) return false;

  // the code-length code: 3-bit lengths by symbol, 57 bits of `cl`
  uint64_t cl = 0, cnt = 0;
  const uint64_t a = d.peek64(pos), b = d.peek64(pos + 48);
  for (int i = 0; i < hclen; ++i) {
    const uint64_t v = (i < 16 ? a >> (3 * i) : b >> (3 * (i - 16))) & 7;
    cl |= v << (3 * kClOrder[i]);
    cnt += 1ull << (8 * v);
  }
  pos += 3 * hclen;
  if (!cl_complete(cnt)) return false;   // build_table's CODELEN rule
  // canonical codes, bit-reversed into a 7-bit lookup: sym | len << 5
  uint8_t table[128];
  uint64_t next = 0;   // first code of each length, 8 bits a length
  {
    uint32_t code = 0;
    for (int l = 2; l <= 7; ++l) {
      code = (code + (uint32_t)((cnt >> (8 * (l - 1))) & 0xFF)) << 1;
      next |= (uint64_t)code << (8 * l);
    }
  }
  for (int sym = 0; sym < 19; ++sym) {
    const int l = (int)((cl >> (3 * sym)) & 7);
    if (!l) continue;
    const uint32_t code = (uint32_t)((next >> (8 * l)) & 0xFF);
    next += 1ull << (8 * l);
    for (uint32_t i = __brev(code) >> (32 - l); i < 128; i += 1u << l)
      table[i] = (uint8_t)(sym | (l << 5));
  }

  // the lengths, run by run, counted by alphabet as they are written
  int lit_counts[MAX_BITS + 1] = {0}, dist_counts[MAX_BITS + 1] = {0};
  const int total = hlit + hdist;
  int i = 0, prev = 0;
  bool eob = false;
  uint64_t buf = 0;   // bits pos .. pos + avail - 1
  int avail = 0;
  while (i < total) {
    if (avail < 14) {   // a code (<= 7 bits) and its extra bits (<= 7)
      buf = d.peek64(pos);
      avail = 64;
    }
    const uint32_t e = table[buf & 127];
    const int len = e >> 5, sym = e & 31;
    int extra = sym < 16 ? 0 : sym == 16 ? 2 : sym == 17 ? 3 : 7;
    if (pos + len + extra > nbits) return false;   // Br::get past the end
    const uint32_t r = (uint32_t)(buf >> len) & ((1u << extra) - 1);
    buf >>= len + extra;
    avail -= len + extra;
    pos += len + extra;
    int v, rep;
    if (sym < 16) {
      v = sym;
      rep = 1;
    } else if (sym == 16) {
      if (i == 0) return false;
      v = prev;
      rep = 3 + (int)r;
    } else {
      v = 0;
      rep = (sym == 17 ? 3 : 11) + (int)r;
    }
    if (i + rep > total) return false;
    if (v) {
      const int in_lit = min(rep, max(hlit - i, 0));
      lit_counts[v] += in_lit;
      dist_counts[v] += rep - in_lit;
    }
    if (i <= 256 && 256 < i + rep) eob = v != 0;
    if (lens)
      for (int k = 0; k < rep; ++k) lens[i + k] = (uint8_t)v;
    i += rep;
    prev = v;
  }
  if (!eob) return false;   // missing end-of-block code
  if (!kraft_ok(lit_counts) || !kraft_ok(dist_counts)) return false;
  if (lens)
    for (int k = total; k < 320; ++k) lens[k] = 0;
  *hlit_out = hlit;
  *hdist_out = hdist;
  *sym_bit = pos;
  return true;
}

// Pass 1: run w holds positions 32w .. 32w + 31 below `hi`.
__global__ void prefilter(Body d, int64_t hi, int64_t runs,
                          uint32_t* __restrict__ surv_mask,
                          int32_t* __restrict__ surv_cnt,
                          uint32_t* __restrict__ acc_mask,
                          int32_t* __restrict__ acc_cnt) {
  const int64_t w = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (w >= runs) return;
  const int64_t p0 = w * 32;
  // bits p0 .. p0 + 63; position p0 + j is dynamic where bit j + 1 is 0
  // and bit j + 2 is 1
  const uint64_t bits = (uint64_t)d.word(w) | ((uint64_t)d.word(w + 1) << 32);
  uint32_t cand = (uint32_t)(~(bits >> 1) & (bits >> 2));
  if (hi - p0 < 32) cand &= (1u << (hi - p0)) - 1;
  uint32_t keep = 0;
  while (cand) {
    const int j = __ffs(cand) - 1;
    cand &= cand - 1;
    if (precode_plausible(d, p0 + j + 3)) keep |= 1u << j;
  }
  surv_mask[w] = keep;
  surv_cnt[w] = __popc(keep);
  acc_mask[w] = 0;
  acc_cnt[w] = 0;
}

// the run that holds item i: the last w with off[w] <= i (off[0] = 0)
__device__ __forceinline__ int64_t find_run(const int32_t* off, int64_t runs,
                                            int64_t i) {
  int64_t lo = 0, hi = runs - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) >> 1;
    if (off[mid] <= i) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// the bit of the k-th set bit of m
__device__ __forceinline__ int nth_bit(uint32_t m, int k) {
  for (; k > 0; --k) m &= m - 1;
  return __ffs(m) - 1;
}

// Pass 3: parse every survivor; mark the accepted.
__global__ void parse_survivors(Body d, int64_t runs,
                                const uint32_t* __restrict__ surv_mask,
                                const int32_t* __restrict__ surv_off,
                                const int32_t* __restrict__ counts,
                                uint32_t* acc_mask, int32_t* acc_cnt) {
  const int64_t n = counts[0];
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * THREADS) {
    const int64_t w = find_run(surv_off, runs, i);
    const int j = nth_bit(surv_mask[w], (int)(i - surv_off[w]));
    int hlit, hdist;
    int64_t sym;
    if (parse_header(d, w * 32 + j, nullptr, &hlit, &hdist, &sym)) {
      atomicOr(acc_mask + w, 1u << j);
      atomicAdd(acc_cnt + w, 1);
    }
  }
}

// Pass 4: hit i's row.
__global__ void write_rows(Body d, int64_t runs,
                           const uint32_t* __restrict__ acc_mask,
                           const int32_t* __restrict__ acc_off, int64_t n,
                           int32_t* __restrict__ rows) {
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * THREADS) {
    const int64_t w = find_run(acc_off, runs, i);
    const int j = nth_bit(acc_mask[w], (int)(i - acc_off[w]));
    const int64_t p = w * 32 + j;
    int32_t* row = rows + i * ROW_INTS;
    int hlit = 0, hdist = 0;
    int64_t sym = 0;
    parse_header(d, p, reinterpret_cast<uint8_t*>(row + 5), &hlit, &hdist,
                 &sym);
    row[0] = (int32_t)p;
    row[1] = (int32_t)sym;
    row[2] = (int32_t)((d.word(p >> 5) >> (p & 31)) & 1);
    row[3] = hlit;
    row[4] = hdist;
  }
}

int64_t runs_of(int64_t nbytes) {
  const int64_t hi = nbytes * 8 - 17;
  return hi > 0 ? (hi + 31) / 32 : 0;
}

int grid_for(int64_t n) {
  static const int sms = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  const int64_t want = (n + THREADS - 1) / THREADS;
  return (int)(want < 8 * sms ? (want > 0 ? want : 1) : 8 * sms);
}

}  // namespace

TBZ_API int64_t tbz_headers_scratch_ints(int64_t nbytes) {
  const int64_t runs = runs_of(nbytes);
  return 4 * runs + tbz_scan_scratch_ints(runs);
}

// Passes 1-3. counts (device, 2 int32) receives the survivors of the
// pre-filter and the accepted headers. scratch: tbz_headers_scratch_ints
// (nbytes) int32, kept for tbz_headers_rows.
TBZ_API int tbz_headers_count(const int32_t* data, int64_t nbytes,
                              int32_t* scratch, int32_t* counts,
                              cudaStream_t s) {
  const int64_t runs = runs_of(nbytes);
  if (runs == 0) {
    cudaMemsetAsync(counts, 0, 2 * sizeof(int32_t), s);
    return (int)cudaGetLastError();
  }
  const Body d{reinterpret_cast<const uint32_t*>(data), nbytes};
  uint32_t* surv_mask = reinterpret_cast<uint32_t*>(scratch);
  int32_t* surv_off = scratch + runs;
  uint32_t* acc_mask = reinterpret_cast<uint32_t*>(scratch + 2 * runs);
  int32_t* acc_off = scratch + 3 * runs;
  int32_t* tmp = scratch + 4 * runs;
  prefilter<<<(unsigned)((runs + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      d, nbytes * 8 - 17, runs, surv_mask, surv_off, acc_mask, acc_off);
  int err = tbz_exclusive_scan(surv_off, surv_off, runs, counts, tmp, s);
  if (err) return err;
  parse_survivors<<<grid_for(runs * 32), THREADS, 0, s>>>(
      d, runs, surv_mask, surv_off, counts, acc_mask, acc_off);
  err = (int)cudaGetLastError();
  if (err) return err;
  return tbz_exclusive_scan(acc_off, acc_off, runs, counts + 1, tmp, s);
}

// Pass 4: the n accepted headers' rows (int32 [n, 85]: hdr_bit, sym_bit,
// bfinal, hlit, hdist, then the 320 code lengths as bytes), in bit order.
TBZ_API int tbz_headers_rows(const int32_t* data, int64_t nbytes,
                             const int32_t* scratch, int64_t n,
                             int32_t* rows, cudaStream_t s) {
  const int64_t runs = runs_of(nbytes);
  if (n <= 0 || runs == 0) return (int)cudaGetLastError();
  const Body d{reinterpret_cast<const uint32_t*>(data), nbytes};
  write_rows<<<grid_for(n), THREADS, 0, s>>>(
      d, runs, reinterpret_cast<const uint32_t*>(scratch + 2 * runs),
      scratch + 3 * runs, n, rows);
  return (int)cudaGetLastError();
}
