// tbz native runtime: DEFLATE tokenizer, LZ77 matcher, tape resolver.
//
// The sequential-irreducible parts of the codec (bit-stream symbol walk,
// hash-chain match search) live here as the fast host path, feeding the
// TPU backend (resolver + checksums) with fixed-width token tapes. This
// plays the role the reference's SBCL-vop-tuned hot loops play
// (deflate.lisp:465-501, %copy-history) — reimplemented from the RFC,
// with the same two-level-table decode contract as ../huffman.py.
//
// Build: g++ -O3 -shared -fPIC -o libtbz.so frontend.cc

#include <sys/mman.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <thread>
#include <utility>
#include <vector>

// TBZ_PLAN_TIMING=1: phase timing of the flat planner to stderr.
static double now_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e3 + ts.tv_nsec * 1e-6;
}
static bool plan_timing() {
  static int v = -1;
  if (v < 0) {
    const char* e = std::getenv("TBZ_PLAN_TIMING");
    v = (e && e[0] == '1') ? 1 : 0;
  }
  return v == 1;
}

namespace {

// ---- error codes (mirror ../errors.py) -----------------------------------
enum {
  OK = 0,
  ERR_BAD_BLOCK_TYPE = 1,
  ERR_STORED_LEN_MISMATCH = 2,
  ERR_TRUNCATED = 3,
  ERR_BAD_HUFFMAN = 4,
  ERR_INVALID_CODE = 5,
  ERR_BAD_DISTANCE = 6,
  ERR_BAD_CL_REPEAT = 7,
  ERR_TOO_MANY_SYMBOLS = 8,
  ERR_TAPE_OVERFLOW = 11,
  ERR_PLAN_DEPTH = 12,
};

// ---- packed table entries (mirror ../constants.py) ------------------------
// OP_LIT2 is a C++-inflate-local extension: two fused literals in one
// root-table entry (val = b0 | b1<<8), produced by fuse_lit_pairs and
// consumed only by inflate_core — never by the tokenizer/gap decoder,
// whose tables stay unfused, so the shared entry contract is unchanged.
enum { OP_LITERAL = 0, OP_MATCH = 1, OP_END = 2, OP_INVALID = 3, OP_LINK = 4,
       OP_LIT2 = 5 };
constexpr uint32_t kInvalidEntry = 15u | (uint32_t(OP_INVALID) << 4);

inline uint32_t pack_entry(uint32_t op, uint32_t nbits, uint32_t extra,
                           uint32_t val) {
  return (nbits & 0xF) | (op << 4) | (extra << 7) | (val << 16);
}
inline uint32_t e_nbits(uint32_t e) { return e & 0xF; }
inline uint32_t e_op(uint32_t e) { return (e >> 4) & 0x7; }
inline uint32_t e_extra(uint32_t e) { return (e >> 7) & 0x1F; }
inline uint32_t e_val(uint32_t e) { return e >> 16; }

constexpr int kMaxBits = 15;
// Root 10 for litlen: at L6-typical code lengths (8-10 bits) a 9-bit
// root sends 20-40%% of lookups through the two-level LINK branch; 10
// almost never. 2048 is a generous bound over the exact ENOUGH (1332
// for 286 symbols, root 10; the classic 852 is the root-9 figure the
// Python tables keep, constants.py).
// Root 12 (round 4, was 10): two short literal codes (L1+L2 <= 12)
// fuse into one table entry for the inflate fast loop — common on text
// where frequent literals sit at 4-6 bits. LINK hops stay negligible.
// Roots 13/14 A/B'd (round 4): 13% / 40% SLOWER on text+mix despite
// more LIT2 fusion — the 32/64KB table falls out of L1 (root 12's
// 16KB fits). Do not widen again.
constexpr int kLitRoot = 12, kDistRoot = 6, kClRoot = 7;
constexpr int kEnoughLit = 6144, kEnoughDist = 592, kEnoughCl = 128;
constexpr int STORED_FLAG = 1 << 30;

const uint16_t kLenBase[29] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19,
                               23, 27, 31, 35, 43, 51, 59, 67, 83, 99, 115,
                               131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49,
                                65, 97, 129, 193, 257, 385, 513, 769, 1025,
                                1537, 2049, 3073, 4097, 6145, 8193, 12289,
                                16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5,
                                6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11,
                                12, 12, 13, 13};
const uint8_t kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                              11, 4, 12, 3, 13, 2, 14, 1, 15};

inline uint32_t bit_reverse(uint32_t code, int nbits) {
  uint32_t out = 0;
  for (int i = 0; i < nbits; i++) {
    out = (out << 1) | (code & 1);
    code >>= 1;
  }
  return out;
}

enum Kind { KIND_CODELEN = 0, KIND_LITLEN = 1, KIND_DIST = 2 };

uint32_t symbol_entry(int kind, int sym, int nbits) {
  if (kind == KIND_CODELEN) return pack_entry(OP_LITERAL, nbits, 0, sym);
  if (kind == KIND_LITLEN) {
    if (sym < 256) return pack_entry(OP_LITERAL, nbits, 0, sym);
    if (sym == 256) return pack_entry(OP_END, nbits, 0, 0);
    if (sym <= 285)
      return pack_entry(OP_MATCH, nbits, kLenExtra[sym - 257],
                        kLenBase[sym - 257]);
    return pack_entry(OP_INVALID, nbits, 0, 0);
  }
  if (sym <= 29)
    return pack_entry(OP_MATCH, nbits, kDistExtra[sym], kDistBase[sym]);
  return pack_entry(OP_INVALID, nbits, 0, 0);
}

// Build a two-level decode table; returns OK or ERR_BAD_HUFFMAN.
// Same canonical construction + validation rules as ../huffman.py.
int build_table(const uint8_t* lens, int n, int kind, int root,
                uint32_t* table, int table_size) {
  for (int i = 0; i < table_size; i++) table[i] = kInvalidEntry;
  int counts[kMaxBits + 1] = {0};
  for (int i = 0; i < n; i++) counts[lens[i]]++;
  int used = 0, max_len = 0;
  for (int l = 1; l <= kMaxBits; l++) {
    used += counts[l];
    if (counts[l]) max_len = l;
  }
  if (used == 0) return OK;  // empty table: all invalid
  int left = 1;
  for (int l = 1; l <= kMaxBits; l++) {
    left = (left << 1) - counts[l];
    if (left < 0) return ERR_BAD_HUFFMAN;
  }
  if (left > 0 && (kind == KIND_CODELEN || max_len != 1))
    return ERR_BAD_HUFFMAN;

  // canonical first-code per length
  uint32_t next_code[kMaxBits + 2] = {0};
  uint32_t code = 0;
  for (int l = 1; l <= kMaxBits; l++) {
    code = (code + (l > 1 ? counts[l - 1] : 0)) << 1;
    next_code[l] = code;
  }
  // first pass: short codes + discover subtable widths
  static_assert(kLitRoot <= 12 && kDistRoot <= 12 && kClRoot <= 12,
                "prefix arrays sized for root <= 12");
  int sub_width[1 << 12];  // indexed by root prefix
  for (int i = 0; i < (1 << root); i++) sub_width[i] = 0;
  uint32_t codes_of[320];
  for (int sym = 0; sym < n; sym++) {
    int l = lens[sym];
    if (!l) continue;
    codes_of[sym] = next_code[l]++;
    if (l > root) {
      uint32_t rev = bit_reverse(codes_of[sym], l);
      int prefix = rev & ((1 << root) - 1);
      if (l - root > sub_width[prefix]) sub_width[prefix] = l - root;
    }
  }
  // allocate subtables, emit link entries
  int sub_base[1 << 12];
  int off = 1 << root;
  for (int p = 0; p < (1 << root); p++) {
    if (!sub_width[p]) continue;
    if (off + (1 << sub_width[p]) > table_size) return ERR_BAD_HUFFMAN;
    sub_base[p] = off;
    table[p] = pack_entry(OP_LINK, root, sub_width[p], off);
    off += 1 << sub_width[p];
  }
  // fill
  for (int sym = 0; sym < n; sym++) {
    int l = lens[sym];
    if (!l) continue;
    uint32_t rev = bit_reverse(codes_of[sym], l);
    uint32_t entry = symbol_entry(kind, sym, l);
    if (l <= root) {
      for (int i = rev; i < (1 << root); i += (1 << l)) table[i] = entry;
    } else {
      int prefix = rev & ((1 << root) - 1);
      int w = sub_width[prefix];
      for (uint32_t i = rev >> root; i < (1u << w); i += (1u << (l - root)))
        table[sub_base[prefix] + i] = entry;
    }
  }
  return OK;
}

// ---- bit reader -----------------------------------------------------------
struct Br {
  const uint8_t* p;
  int64_t n;       // total bytes
  int64_t pos;     // next unread byte
  uint64_t buf;
  int nbits;

  void init(const uint8_t* data, int64_t size, int64_t bit_pos) {
    p = data;
    n = size;
    pos = bit_pos >> 3;
    buf = 0;
    nbits = 0;
    int rem = bit_pos & 7;
    if (rem && pos < n) {
      buf = p[pos++] >> rem;
      nbits = 8 - rem;
    }
  }
  inline void fill() {
    if (nbits <= 32 && pos + 8 <= n) {  // bulk 8-byte LE load
      uint64_t w;
      std::memcpy(&w, p + pos, 8);
      int take = (63 - nbits) >> 3;
      buf |= w << nbits;  // may truncate high bytes; advance what fits
      pos += take;
      nbits += take * 8;
      return;
    }
    while (nbits <= 56 && pos < n) {
      buf |= uint64_t(p[pos++]) << nbits;
      nbits += 8;
    }
  }
  // Branchless refill to 56-63 buffered bits. REQUIRES pos + 8 <= n
  // (fast regions check this before entry). One unaligned load; pos
  // advances by the whole bytes taken, and nbits |= 56 lands exactly
  // consistent with them (bit_position() is unchanged by a refill).
  inline void refill_fast() {
    uint64_t w;
    std::memcpy(&w, p + pos, 8);
    buf |= w << nbits;
    pos += (63 - nbits) >> 3;
    nbits |= 56;
  }
  inline int64_t bits_available() const { return (n - pos) * 8 + nbits; }
  inline int64_t bit_position() const { return pos * 8 - nbits; }
  inline uint32_t peek(int k) {
    if (nbits < k) fill();
    return uint32_t(buf) & ((1u << k) - 1);
  }
  inline void drop(int k) {
    buf >>= k;
    nbits -= k;
  }
  // consume k bits; returns false on underrun
  inline bool get(int k, uint32_t* out) {
    if (nbits < k) {
      fill();
      if (nbits < k) return false;
    }
    *out = uint32_t(buf) & ((1u << k) - 1);
    drop(k);
    return true;
  }
  inline void align_byte() {
    int rem = nbits & 7;
    buf >>= rem;
    nbits -= rem;
  }
};

// decode one symbol; returns 0 ok, ERR_TRUNCATED, ERR_INVALID_CODE
inline int decode_symbol(Br& br, const uint32_t* table, int root,
                         uint32_t* op, uint32_t* extra, uint32_t* val) {
  br.fill();
  uint32_t e = table[uint32_t(br.buf) & ((1u << root) - 1)];
  if (e_op(e) == OP_LINK) {
    uint32_t sub = (uint32_t(br.buf) >> root) & ((1u << e_extra(e)) - 1);
    e = table[e_val(e) + sub];
  }
  int nb = e_nbits(e);
  if (br.bits_available() < nb) return ERR_TRUNCATED;
  if (e_op(e) == OP_INVALID) return ERR_INVALID_CODE;
  br.drop(nb);
  *op = e_op(e);
  *extra = e_extra(e);
  *val = e_val(e);
  return OK;
}

struct Tables {
  uint32_t lit[kEnoughLit];
  uint32_t dist[kEnoughDist];
};

// Fixed tables, built once.
Tables g_fixed;
bool g_fixed_ready = false;
void ensure_fixed() {
  if (g_fixed_ready) return;
  uint8_t lens[320];
  for (int i = 0; i < 144; i++) lens[i] = 8;
  for (int i = 144; i < 256; i++) lens[i] = 9;
  for (int i = 256; i < 280; i++) lens[i] = 7;
  for (int i = 280; i < 288; i++) lens[i] = 8;
  build_table(lens, 288, KIND_LITLEN, kLitRoot, g_fixed.lit, kEnoughLit);
  for (int i = 0; i < 32; i++) lens[i] = 5;
  build_table(lens, 32, KIND_DIST, kDistRoot, g_fixed.dist, kEnoughDist);
  g_fixed_ready = true;
}

// Kraft acceptance test, EXACTLY build_table's rules (over-subscribed
// bad; incomplete bad unless empty, or a single 1-bit code for
// litlen/dist). Used by the header scanner so a candidate is accepted
// iff the real parse would accept it.
int kraft_check(const uint8_t* lens, int n, int kind) {
  int counts[kMaxBits + 1] = {0};
  for (int i = 0; i < n; i++) counts[lens[i]]++;
  int used = 0, max_len = 0;
  for (int l = 1; l <= kMaxBits; l++) {
    used += counts[l];
    if (counts[l]) max_len = l;
  }
  if (used == 0) return OK;
  int left = 1;
  for (int l = 1; l <= kMaxBits; l++) {
    left = (left << 1) - counts[l];
    if (left < 0) return ERR_BAD_HUFFMAN;
  }
  if (left > 0 && (kind == KIND_CODELEN || max_len != 1))
    return ERR_BAD_HUFFMAN;
  return OK;
}

// Parse a dynamic header's code lengths (after BFINAL/BTYPE) and fully
// validate them — cl code, RLE, missing EOB, litlen/dist Kraft — WITHOUT
// building the big decode tables. Fills lens[320] (litlen at 0, dist at
// hlit). Acceptance is identical to read_dynamic's.
int parse_dynamic_lens(Br& br, uint8_t* lens, int* hlit_out,
                       int* hdist_out) {
  uint32_t hlit5, hdist5, hclen4;
  if (!br.get(5, &hlit5) || !br.get(5, &hdist5) || !br.get(4, &hclen4))
    return ERR_TRUNCATED;
  int hlit = hlit5 + 257, hdist = hdist5 + 1, hclen = hclen4 + 4;
  if (hlit > 286 || hdist > 30) return ERR_TOO_MANY_SYMBOLS;
  uint8_t cl_lens[19] = {0};
  for (int i = 0; i < hclen; i++) {
    uint32_t v;
    if (!br.get(3, &v)) return ERR_TRUNCATED;
    cl_lens[kClOrder[i]] = v;
  }
  uint32_t cl_table[kEnoughCl];
  int err = build_table(cl_lens, 19, KIND_CODELEN, kClRoot, cl_table,
                        kEnoughCl);
  if (err) return err;
  int total = hlit + hdist;
  int i = 0;
  while (i < total) {
    uint32_t op, extra, sym;
    err = decode_symbol(br, cl_table, kClRoot, &op, &extra, &sym);
    if (err) return err;
    if (sym < 16) {
      lens[i++] = uint8_t(sym);
    } else if (sym == 16) {
      if (i == 0) return ERR_BAD_CL_REPEAT;
      uint32_t r;
      if (!br.get(2, &r)) return ERR_TRUNCATED;
      int rep = 3 + r;
      if (i + rep > total) return ERR_BAD_CL_REPEAT;
      uint8_t v = lens[i - 1];
      for (int k = 0; k < rep; k++) lens[i++] = v;
    } else {
      uint32_t r;
      int rep;
      if (sym == 17) {
        if (!br.get(3, &r)) return ERR_TRUNCATED;
        rep = 3 + r;
      } else {
        if (!br.get(7, &r)) return ERR_TRUNCATED;
        rep = 11 + r;
      }
      if (i + rep > total) return ERR_BAD_CL_REPEAT;
      for (int k = 0; k < rep; k++) lens[i++] = 0;
    }
  }
  if (lens[256] == 0) return ERR_BAD_HUFFMAN;  // missing end-of-block
  err = kraft_check(lens, hlit, KIND_LITLEN);
  if (err) return err;
  err = kraft_check(lens + hlit, hdist, KIND_DIST);
  if (err) return err;
  *hlit_out = hlit;
  *hdist_out = hdist;
  return OK;
}

// Parse a dynamic header into tables. Mirrors ../reference.py semantics.
int read_dynamic(Br& br, Tables* t) {
  uint8_t lens[320];
  int hlit, hdist;
  int err = parse_dynamic_lens(br, lens, &hlit, &hdist);
  if (err) return err;
  err = build_table(lens, hlit, KIND_LITLEN, kLitRoot, t->lit, kEnoughLit);
  if (err) return err;
  return build_table(lens + hlit, hdist, KIND_DIST, kDistRoot, t->dist,
                     kEnoughDist);
}

}  // namespace

extern "C" {

static int32_t inflate_core(const uint8_t* data, int64_t size,
                            int64_t start_bit, const uint8_t* window,
                            int64_t window_len, uint8_t** out_ptr,
                            int64_t* out_cap_ptr, int64_t* out_len,
                            int64_t* end_bit, int32_t* finished,
                            int32_t fixed_buf);

// Fused one-shot inflate; allocates the output (caller frees via
// tbz_free). Returns an error code; partial output remains valid.
int32_t tbz_inflate_alloc(const uint8_t* data, int64_t size,
                          int64_t start_bit, const uint8_t* window,
                          int64_t window_len, int64_t size_hint,
                          uint8_t** out_ptr, int64_t* out_len,
                          int64_t* end_bit, int32_t* finished) {
  int64_t cap = size_hint > 0 ? size_hint + 16 : size * 4 + (1 << 16);
  uint8_t* out = (uint8_t*)malloc(cap);
  if (!out) return ERR_TAPE_OVERFLOW;
#ifdef MADV_HUGEPAGE
  // big outputs: soft-fault 2MB pages instead of ~cap/4096 small ones
  // (measured: the 96MB single-stream path is fault-bound, not decode-
  // bound — per-thread rate on warm small buffers is ~40% higher)
  if (cap >= (2 << 20))
    madvise((void*)(((uintptr_t)out + 4095) & ~uintptr_t(4095)),
            size_t(cap - 4096), MADV_HUGEPAGE);
#endif
  int32_t err = inflate_core(data, size, start_bit, window, window_len,
                             &out, &cap, out_len, end_bit, finished, 0);
  *out_ptr = out;
  return err;
}

// Known-size fast path: inflate INTO a caller-provided buffer, zero
// copies (api.lisp:36-48 contract). The buffer is never grown; needing
// more than out_cap bytes is ERR_TAPE_OVERFLOW. NOTE: the decoder
// keeps 16 bytes of word-copy slack, so out_cap must be the real
// buffer size and the caller passes capacity = len(buffer).
int32_t tbz_inflate_into(const uint8_t* data, int64_t size,
                         int64_t start_bit, const uint8_t* window,
                         int64_t window_len, uint8_t* out, int64_t out_cap,
                         int64_t* out_len, int64_t* end_bit,
                         int32_t* finished) {
  return inflate_core(data, size, start_bit, window, window_len, &out,
                      &out_cap, out_len, end_bit, finished, 1);
}

void tbz_free(uint8_t* p) { free(p); }

// ---- paired inflate -------------------------------------------------------
// Two INDEPENDENT raw-deflate streams decoded in one interleaved loop.
// The single-stream literal chain is load-latency-bound (~4 ns/symbol:
// table load -> shift -> next load); interleaving a second independent
// chain hides most of that latency (measured 2.2x per-symbol in a
// skeleton probe). Used by the sharded host decoder, which always has
// many independent streams in flight per thread.
//
// Contract: BOTH streams must decode cleanly start-to-finish with no
// preset window into caller buffers of sufficient (hinted) size.
// ANY anomaly — bad data, truncation, undersized buffer, distance
// into a window — returns -1 ("bail") with buffer contents undefined,
// and the caller re-decodes through the single-stream path, which owns
// the exact error semantics. Success (0) guarantees bit-exact output
// and end positions identical to tbz_inflate_into on each stream.

static void fuse_lit_pairs(uint32_t* t);  // defined with inflate_core below

namespace pairlane {

struct Lane {
  Br br;
  Tables dyn;
  const uint32_t* lit_t = nullptr;
  const uint32_t* dist_t = nullptr;
  const uint8_t* data;
  int64_t size;
  uint8_t* out;
  int64_t cap;
  int64_t pos = 0;
  uint32_t bfinal = 0;
  enum { HDR, SYM, DONE } state = HDR;
  bool finished = false;
};

// Open the next block at the lane's bit position. Stored blocks are
// copied inline (looping until a coded block, stream end, or input
// runs out). Returns false to bail.
static bool open_block(Lane& L) {
  for (;;) {
    uint32_t bfinal, btype;
    if (!L.br.get(1, &bfinal) || !L.br.get(2, &btype)) return false;
    L.bfinal = bfinal;
    if (btype == 3) return false;
    if (btype == 0) {
      L.br.align_byte();
      uint32_t ln, nlen;
      if (!L.br.get(16, &ln) || !L.br.get(16, &nlen)) return false;
      if (ln != (~nlen & 0xFFFF)) return false;
      if (L.br.bits_available() < int64_t(ln) * 8) return false;
      if (L.pos + ln > L.cap) return false;
      int64_t off = L.br.bit_position() >> 3;
      std::memcpy(L.out + L.pos, L.data + off, ln);
      L.pos += ln;
      L.br.init(L.data, L.size, (off + ln) * 8);
      if (bfinal) {
        L.state = Lane::DONE;
        L.finished = true;
        return true;
      }
      continue;
    }
    if (btype == 1) {
      ensure_fixed();
      L.lit_t = g_fixed.lit;
      L.dist_t = g_fixed.dist;
    } else {
      if (read_dynamic(L.br, &L.dyn) != OK) return false;
      fuse_lit_pairs(L.dyn.lit);
      L.lit_t = L.dyn.lit;
      L.dist_t = L.dyn.dist;
    }
    L.state = Lane::SYM;
    return true;
  }
}

// Decode ONE token with per-field underrun checks (the stream-tail
// analog of inflate_core's careful region, minus resumability — any
// irregularity bails to the single-stream path). Returns false to bail.
static bool careful_token(Lane& L) {
  uint32_t op, extra, val;
  if (decode_symbol(L.br, L.lit_t, kLitRoot, &op, &extra, &val) != OK)
    return false;
  if (op == OP_END) {
    if (L.bfinal) {
      L.state = Lane::DONE;
      L.finished = true;
    } else {
      L.state = Lane::HDR;
    }
    return true;
  }
  if (op == OP_LITERAL || op == OP_LIT2) {
    int nb = (op == OP_LIT2) ? 2 : 1;
    if (L.pos + nb > L.cap) return false;
    L.out[L.pos++] = uint8_t(val);
    if (op == OP_LIT2) L.out[L.pos++] = uint8_t(val >> 8);
    return true;
  }
  if (op != OP_MATCH) return false;
  uint32_t ebits = 0;
  if (extra && !L.br.get(extra, &ebits)) return false;
  int len = int(val + ebits);
  uint32_t dop, dextra, dval;
  if (decode_symbol(L.br, L.dist_t, kDistRoot, &dop, &dextra, &dval) != OK ||
      dop != OP_MATCH)
    return false;
  uint32_t debits = 0;
  if (dextra && !L.br.get(dextra, &debits)) return false;
  int64_t d = dval + debits;
  int64_t src = L.pos - d;
  if (src < 0 || L.pos + len > L.cap) return false;  // no preset window
  for (int64_t k = 0; k < len; k++) L.out[L.pos + k] = L.out[src + k];
  L.pos += len;
  return true;
}

inline bool fast_ok(const Lane& L) {
  return L.state == Lane::SYM && L.br.pos + 8 <= L.br.n &&
         L.pos + 300 + 16 <= L.cap;
}

// Drain a lane's non-fast work: block headers and tail tokens. Returns
// false to bail. On return the lane is DONE or fast-eligible.
static bool advance_slow(Lane& L) {
  while (L.state != Lane::DONE && !fast_ok(L)) {
    if (L.state == Lane::HDR) {
      if (!open_block(L)) return false;
    } else {
      if (!careful_token(L)) return false;
    }
  }
  return true;
}

}  // namespace pairlane

int32_t tbz_inflate_pair(const uint8_t* d0, int64_t n0, uint8_t* o0,
                         int64_t c0, int64_t* w0, int64_t* e0,
                         const uint8_t* d1, int64_t n1, uint8_t* o1,
                         int64_t c1, int64_t* w1, int64_t* e1) {
  using pairlane::Lane;
  Lane lanes[2];
  lanes[0].data = d0; lanes[0].size = n0; lanes[0].out = o0; lanes[0].cap = c0;
  lanes[1].data = d1; lanes[1].size = n1; lanes[1].out = o1; lanes[1].cap = c1;
  lanes[0].br.init(d0, n0, 0);
  lanes[1].br.init(d1, n1, 0);

  // One fast token: a branchless refill leaves 56-63 buffered bits
  // (>=8 input bytes guaranteed by the fast-region bound) — a
  // worst-case token (48 bits) decodes from one refill. All hot state
  // lives in the caller's locals (no aliasing with the uint8_t
  // stores), so the two lanes' chains stay in registers and overlap
  // in the out-of-order window. MUST inline: as an outlined call the
  // lane state round-trips through the stack per token, which both
  // serializes the two chains and adds call overhead.
  // Returns: 0 = continue fast, 1 = left fast mode (recheck), -1 = bail.
  auto fast_token = [](const uint8_t* dp, int64_t dn, int64_t& ip,
                       uint64_t& bf, int& nb, uint8_t* out, int64_t& pos,
                       const uint32_t* lit_t, const uint32_t* dist_t,
                       Lane& L) __attribute__((always_inline)) -> int {
    (void)dn;
    // Branchless refill (requires ip + 8 <= dn): bits [nb, 63] fill
    // from one unaligned load; ip advances by the whole bytes taken,
    // nb lands in [56, 63] consistently with the bytes consumed.
    uint64_t w;
    std::memcpy(&w, dp + ip, 8);
    bf |= w << nb;
    ip += (63 - nb) >> 3;
    nb |= 56;
    uint32_t e = lit_t[uint32_t(bf) & ((1u << kLitRoot) - 1)];
    if (e_op(e) == OP_LINK)
      e = lit_t[e_val(e) +
                ((uint32_t(bf) >> kLitRoot) & ((1u << e_extra(e)) - 1))];
    uint32_t eop = e_op(e);
    if (eop == OP_LIT2) {
      bf >>= e_nbits(e);
      nb -= e_nbits(e);
      uint32_t v = e_val(e);
      out[pos] = uint8_t(v);
      out[pos + 1] = uint8_t(v >> 8);
      pos += 2;
      return 0;
    }
    if (eop == OP_LITERAL) {
      bf >>= e_nbits(e);
      nb -= e_nbits(e);
      out[pos++] = uint8_t(e_val(e));
      return 0;
    }
    if (eop == OP_END) {
      bf >>= e_nbits(e);
      nb -= e_nbits(e);
      if (L.bfinal) {
        L.state = Lane::DONE;
        L.finished = true;
      } else {
        L.state = Lane::HDR;
      }
      return 1;
    }
    if (eop != OP_MATCH) return -1;
    // match: 56 buffered bits cover code+extra (20) + dist code+extra
    // (28); same combined-consume scheme as inflate_core's fast region
    int len = int(e_val(e) +
                  (uint32_t(bf >> e_nbits(e)) & ((1u << e_extra(e)) - 1)));
    int drop = e_nbits(e) + e_extra(e);
    bf >>= drop;
    nb -= drop;
    uint32_t de = dist_t[uint32_t(bf) & ((1u << kDistRoot) - 1)];
    if (e_op(de) == OP_LINK)
      de = dist_t[e_val(de) +
                  ((uint32_t(bf) >> kDistRoot) & ((1u << e_extra(de)) - 1))];
    if (e_op(de) != OP_MATCH) return -1;
    int64_t d = e_val(de) +
                (uint32_t(bf >> e_nbits(de)) & ((1u << e_extra(de)) - 1));
    drop = e_nbits(de) + e_extra(de);
    bf >>= drop;
    nb -= drop;
    int64_t src = pos - d;
    if (src < 0) return -1;  // no preset window in the pair path
    if (d >= 16) {
      int64_t k = 0;
      do {
        uint64_t w0, w1;
        std::memcpy(&w0, out + src + k, 8);
        std::memcpy(&w1, out + src + k + 8, 8);
        std::memcpy(out + pos + k, &w0, 8);
        std::memcpy(out + pos + k + 8, &w1, 8);
        k += 16;
      } while (k < len);
    } else if (d >= 8) {
      int64_t k = 0;
      do {
        uint64_t w;
        std::memcpy(&w, out + src + k, 8);
        std::memcpy(out + pos + k, &w, 8);
        k += 8;
      } while (k < len);
    } else if (d == 1) {
      std::memset(out + pos, out[src], len);
    } else {
      for (int64_t k = 0; k < d; k++) out[pos + k] = out[src + k];
      int64_t filled = d;
      while (filled < len) {
        int64_t take = filled < len - filled ? filled : len - filled;
        std::memcpy(out + pos + filled, out + pos, size_t(take));
        filled += take;
      }
    }
    pos += len;
    return 0;
  };

  for (;;) {
    // drain headers / tails; lanes come back fast-eligible or DONE
    if (!pairlane::advance_slow(lanes[0])) return -1;
    if (!pairlane::advance_slow(lanes[1])) return -1;
    bool f0 = pairlane::fast_ok(lanes[0]);
    bool f1 = pairlane::fast_ok(lanes[1]);
    if (!f0 && !f1) break;  // both DONE (advance_slow ensures fast or done)

    // localize hot state
    Lane& A = lanes[0];
    Lane& B = lanes[1];
    int64_t ip0 = A.br.pos, ip1 = B.br.pos;
    uint64_t bf0 = A.br.buf, bf1 = B.br.buf;
    int nb0 = A.br.nbits, nb1 = B.br.nbits;
    int64_t pos0 = A.pos, pos1 = B.pos;
    int rc = 0;
    if (f0 && f1) {
      // interleaved: one token per lane per iteration; the two chains
      // share no state and overlap in the OOO window
      for (;;) {
        rc = fast_token(A.data, A.size, ip0, bf0, nb0, A.out, pos0,
                        A.lit_t, A.dist_t, A);
        if (rc < 0) return -1;
        int rc1 = fast_token(B.data, B.size, ip1, bf1, nb1, B.out, pos1,
                             B.lit_t, B.dist_t, B);
        if (rc1 < 0) return -1;
        if (rc || rc1) break;
        if (ip0 + 8 > A.size || pos0 + 300 + 16 > A.cap ||
            ip1 + 8 > B.size || pos1 + 300 + 16 > B.cap)
          break;
      }
    } else {
      // one lane left: solo fast loop (same token step)
      Lane& L = f0 ? A : B;
      int64_t& ip = f0 ? ip0 : ip1;
      uint64_t& bf = f0 ? bf0 : bf1;
      int& nb = f0 ? nb0 : nb1;
      int64_t& pos = f0 ? pos0 : pos1;
      for (;;) {
        rc = fast_token(L.data, L.size, ip, bf, nb, L.out, pos,
                        L.lit_t, L.dist_t, L);
        if (rc < 0) return -1;
        if (rc || ip + 8 > L.size || pos + 300 + 16 > L.cap) break;
      }
    }
    // write back
    A.br.pos = ip0; A.br.buf = bf0; A.br.nbits = nb0; A.pos = pos0;
    B.br.pos = ip1; B.br.buf = bf1; B.br.nbits = nb1; B.pos = pos1;
  }
  if (!lanes[0].finished || !lanes[1].finished) return -1;
  *w0 = lanes[0].pos;
  *e0 = lanes[0].br.bit_position();
  *w1 = lanes[1].pos;
  *e1 = lanes[1].br.bit_position();
  return 0;
}

// ---- block emission -------------------------------------------------------
// Pack a token range with the given codebooks (codes pre-bit-reversed by
// the caller, LSB-first shift-in). Carries bit-writer state so Python
// header emission interleaves. Returns bytes written, or -1 on overflow.
int64_t tbz_pack(const int32_t* out_len, const int32_t* dist,
                 const int32_t* lit, int64_t n_tok,
                 const uint32_t* lit_codes_rev, const uint8_t* lit_lens,
                 const uint32_t* dist_codes_rev, const uint8_t* dist_lens,
                 int32_t emit_eob, uint64_t init_bits, int32_t init_nbits,
                 uint8_t* out, int64_t out_cap, uint64_t* final_bits,
                 int32_t* final_nbits) {
  // length -> symbol index tables (built once)
  static uint8_t len_sym[259];   // match length 3..258 -> 0..28
  static uint8_t dist_sym_small[513];  // dist 1..512
  static bool ready = false;
  if (!ready) {
    for (int s = 28; s >= 0; s--)
      for (int l = kLenBase[s]; l <= 258 && (s == 28 || l < kLenBase[s + 1]);
           l++)
        len_sym[l] = s;
    len_sym[258] = 28;
    for (int s = 29; s >= 0; s--)
      for (int d = kDistBase[s]; d <= 512 &&
           (s == 29 || d < kDistBase[s + 1]); d++)
        dist_sym_small[d] = s;
    ready = true;
  }
  auto dist_sym = [&](int32_t d) -> int {
    if (d <= 512) return dist_sym_small[d];
    int s = 29;
    while (kDistBase[s] > d) s--;
    return s;
  };

  uint64_t buf = init_bits;
  int nbits = init_nbits;
  int64_t pos = 0;
  auto put = [&](uint32_t v, int n) {
    buf |= uint64_t(v) << nbits;
    nbits += n;
    while (nbits >= 8) {
      out[pos++] = uint8_t(buf);
      buf >>= 8;
      nbits -= 8;
    }
  };
  if (out_cap < n_tok * 6 + 64) return -1;  // worst case ~48 bits/token
  for (int64_t i = 0; i < n_tok; i++) {
    int32_t d = dist[i];
    if (d == 0) {
      int s = lit[i];
      put(lit_codes_rev[s], lit_lens[s]);
    } else {
      int l = out_len[i];
      int s = 257 + len_sym[l];
      put(lit_codes_rev[s], lit_lens[s]);
      int eb = kLenExtra[s - 257];
      if (eb) put(uint32_t(l - kLenBase[s - 257]), eb);
      int ds = dist_sym(d);
      put(dist_codes_rev[ds], dist_lens[ds]);
      int deb = kDistExtra[ds];
      if (deb) put(uint32_t(d - kDistBase[ds]), deb);
    }
  }
  if (emit_eob) put(lit_codes_rev[256], lit_lens[256]);
  *final_bits = buf;
  *final_nbits = nbits;
  return pos;
}

struct TokResult {
  int64_t n_tokens;
  int64_t end_bit;   // bit position of the clean resume point
  int64_t total_out;
  int32_t finished;
  int32_t err;
  int32_t suspended;  // stopped by max_out budget (tbz_tokenize_stream)
  int32_t pad_;
};

// Tokenize a raw-deflate stream into the tape convention of ../tape.py.
// produced_init/window_len feed distance validation for streaming resume.
// On ERR_TAPE_OVERFLOW the caller retries with a larger cap.
static int32_t tokenize_impl(const uint8_t* data, int64_t size,
                             int64_t start_bit, int64_t window_len,
                             int64_t produced_init, int32_t* out_len,
                             int32_t* dist, int32_t* root_val, int64_t cap,
                             int block_granular, TokResult* res) {
  ensure_fixed();
  Br br;
  br.init(data, size, start_bit);
  Tables dyn;
  int64_t nt = 0;
  int64_t produced = produced_init;
  res->finished = 0;
  res->err = OK;
  int64_t blk_bit = start_bit, blk_nt = 0, blk_prod = produced_init;

  for (;;) {
    int64_t block_start = br.bit_position();
    blk_bit = block_start;
    blk_nt = nt;
    blk_prod = produced;
    uint32_t bfinal, btype;
    if (!br.get(1, &bfinal) || !br.get(2, &btype)) {
      res->err = ERR_TRUNCATED;
      br.init(data, size, block_start);
      break;
    }
    const uint32_t* lit_t;
    const uint32_t* dist_t;
    if (btype == 3) {
      res->err = ERR_BAD_BLOCK_TYPE;
      break;
    }
    if (btype == 0) {
      br.align_byte();
      uint32_t ln, nlen;
      if (!br.get(16, &ln) || !br.get(16, &nlen)) {
        res->err = ERR_TRUNCATED;
        br.init(data, size, block_start);
        break;
      }
      if (ln != (~nlen & 0xFFFF)) {
        res->err = ERR_STORED_LEN_MISMATCH;
        break;
      }
      if (br.bits_available() < int64_t(ln) * 8) {
        res->err = ERR_TRUNCATED;
        br.init(data, size, block_start);
        break;
      }
      if (ln) {
        if (nt >= cap) {
          res->err = ERR_TAPE_OVERFLOW;
          break;
        }
        int64_t off = br.bit_position() >> 3;
        out_len[nt] = ln;
        dist[nt] = 0;
        root_val[nt] = STORED_FLAG | int32_t(off);
        nt++;
        produced += ln;
        // skip payload
        int skip_from_buf = br.nbits < int(ln) * 8 ? br.nbits : int(ln) * 8;
        // simplest: recompute position
        int64_t target = br.bit_position() + int64_t(ln) * 8;
        br.init(data, size, target);
      }
      goto block_end;
    }
    if (btype == 1) {
      lit_t = g_fixed.lit;
      dist_t = g_fixed.dist;
    } else {
      int err = read_dynamic(br, &dyn);
      if (err) {
        res->err = err;
        if (err == ERR_TRUNCATED) br.init(data, size, block_start);
        goto done;
      }
      lit_t = dyn.lit;
      dist_t = dyn.dist;
    }
    // symbol loop
    for (;;) {
      // Fast region (mirrors inflate_core): >=8 input bytes buffered
      // covers a worst-case 48-bit token after one fill, so code+extra
      // consume in combined drops and literals burst. Any boundary
      // condition (input tail, tape cap) falls through to the careful
      // path below with the bit position at a symbol start.
      if (br.pos + 8 <= br.n && nt < cap) {
        br.refill_fast();
        uint32_t e;
        for (;;) {
          e = lit_t[uint32_t(br.buf) & ((1u << kLitRoot) - 1)];
          if (e_op(e) == OP_LINK)
            e = lit_t[e_val(e) +
                      ((uint32_t(br.buf) >> kLitRoot) &
                       ((1u << e_extra(e)) - 1))];
          if (e_op(e) != OP_LITERAL) break;
          br.drop(e_nbits(e));
          out_len[nt] = 1;
          dist[nt] = 0;
          root_val[nt] = int32_t(e_val(e));
          nt++;
          produced++;
          // 20 bits covers the worst litlen code + length extra
          // (15 + 5); see inflate_core's burst for the bound argument
          if (br.nbits < 20 || nt >= cap) break;
        }
        if (e_op(e) == OP_LITERAL) continue;  // burst ended on bits/cap
        if (e_op(e) == OP_END) {
          br.drop(e_nbits(e));
          break;
        }
        if (e_op(e) == OP_INVALID) {
          res->err = ERR_INVALID_CODE;
          goto done;
        }
        if (nt < cap) {
          int64_t tok_bit = br.bit_position();
          int length = e_val(e) +
                       int(uint32_t(br.buf >> e_nbits(e)) &
                           ((1u << e_extra(e)) - 1));
          br.drop(e_nbits(e) + e_extra(e));
          if (br.pos + 8 <= br.n) {
            br.refill_fast();
          } else {
            br.fill();
            if (br.nbits < 28) {
              // dist code + extra (worst 28 bits) may be only partially
              // buffered this close to the end: replay via careful path
              br.init(data, size, tok_bit);
              continue;
            }
          }
          uint32_t de = dist_t[uint32_t(br.buf) & ((1u << kDistRoot) - 1)];
          if (e_op(de) == OP_LINK)
            de = dist_t[e_val(de) +
                        ((uint32_t(br.buf) >> kDistRoot) &
                         ((1u << e_extra(de)) - 1))];
          if (e_op(de) != OP_MATCH) {
            res->err = ERR_INVALID_CODE;
            goto done;
          }
          int64_t d = e_val(de) +
                      int64_t(uint32_t(br.buf >> e_nbits(de)) &
                              ((1u << e_extra(de)) - 1));
          br.drop(e_nbits(de) + e_extra(de));
          if (d > produced + window_len) {
            res->err = ERR_BAD_DISTANCE;
            goto done;
          }
          out_len[nt] = length;
          dist[nt] = int32_t(d);
          root_val[nt] = 0;
          nt++;
          produced += length;
          continue;
        }
        // nt == cap with a pending match: careful path re-decodes it
        // from the same position and reports the overflow
      }
      int64_t sym_start = br.bit_position();
      uint32_t op, extra, val;
      int err = decode_symbol(br, lit_t, kLitRoot, &op, &extra, &val);
      if (err) {
        res->err = err;
        if (err == ERR_TRUNCATED) br.init(data, size, sym_start);
        goto done;
      }
      if (op == OP_END) break;
      if (nt >= cap) {
        res->err = ERR_TAPE_OVERFLOW;
        br.init(data, size, sym_start);
        goto done;
      }
      if (op == OP_LITERAL) {
        out_len[nt] = 1;
        dist[nt] = 0;
        root_val[nt] = val;
        nt++;
        produced++;
        continue;
      }
      // match
      uint32_t ebits = 0;
      if (extra && !br.get(extra, &ebits)) {
        res->err = ERR_TRUNCATED;
        br.init(data, size, sym_start);
        goto done;
      }
      int length = val + ebits;
      uint32_t dop, dextra, dval;
      err = decode_symbol(br, dist_t, kDistRoot, &dop, &dextra, &dval);
      if (err) {
        res->err = err;
        if (err == ERR_TRUNCATED) br.init(data, size, sym_start);
        goto done;
      }
      uint32_t debits = 0;
      if (dextra && !br.get(dextra, &debits)) {
        res->err = ERR_TRUNCATED;
        br.init(data, size, sym_start);
        goto done;
      }
      int64_t d = dval + debits;
      if (d > produced + window_len) {
        res->err = ERR_BAD_DISTANCE;
        goto done;
      }
      out_len[nt] = length;
      dist[nt] = int32_t(d);
      root_val[nt] = 0;
      nt++;
      produced += length;
    }
  block_end:
    if (bfinal) {
      res->finished = 1;
      break;
    }
  }
done:
  if (block_granular && res->err == ERR_TRUNCATED) {
    // Roll back the incomplete block; caller resumes from end_bit.
    nt = blk_nt;
    produced = blk_prod;
    br.init(data, size, blk_bit);
    res->err = OK;
  }
  res->n_tokens = nt;
  res->end_bit = br.bit_position();
  res->total_out = produced - produced_init;
  return res->err;
}

int32_t tbz_tokenize(const uint8_t* data, int64_t size, int64_t start_bit,
                     int64_t window_len, int64_t produced_init,
                     int32_t* out_len, int32_t* dist, int32_t* root_val,
                     int64_t cap, TokResult* res) {
  return tokenize_impl(data, size, start_bit, window_len, produced_init,
                       out_len, dist, root_val, cap, 0, res);
}

// ---- resumable streaming tokenizer ----------------------------------------
// Token-granular suspend/resume with explicit state, the native analog of
// the reference's save-state protocol (deflate.lisp:114-137 via
// util.lisp:25-46): the caller owns a TokState; every call consumes input
// up to the last complete token (or the max_out output budget) and can be
// resumed later with fresh input — no per-chunk re-parse of block data
// (amortized O(n) for any chunking) and no unbounded output growth
// (max_out bounds work AND memory, README.md:80-93 cost model).
struct TokState {
  int32_t mode;  // 0 at-block-boundary, 1 in-data-block, 2 in-stored, 3 done
  int32_t bfinal;
  int32_t is_fixed;  // mode==1: tables are the static pair, not `tables`
  int32_t pad_;
  int64_t stored_remaining;
  Tables tables;  // dynamic tables carried across suspensions
};

int64_t tbz_state_size() { return (int64_t)sizeof(TokState); }
void tbz_state_init(TokState* st) { std::memset(st, 0, sizeof(TokState)); }

// Returns res->err (OK on clean suspend — input underrun or budget stop;
// res->suspended distinguishes the budget case, res->finished the end).
int32_t tbz_tokenize_stream(const uint8_t* data, int64_t size,
                            int64_t start_bit, int64_t window_len,
                            int64_t produced_init, int64_t max_out,
                            TokState* st, int32_t* out_len, int32_t* dist,
                            int32_t* root_val, int64_t cap, TokResult* res) {
  ensure_fixed();
  Br br;
  br.init(data, size, start_bit);
  int64_t nt = 0;
  int64_t produced = produced_init;
  res->finished = 0;
  res->err = OK;
  res->suspended = 0;
  auto budget_left = [&]() -> int64_t {
    return max_out > 0 ? max_out - (produced - produced_init) : INT64_MAX;
  };

  for (;;) {
    if (st->mode == 3) {
      res->finished = 1;
      break;
    }
    if (budget_left() <= 0) {
      res->suspended = 1;
      break;
    }
    if (st->mode == 0) {  // block boundary: header
      int64_t block_start = br.bit_position();
      uint32_t bfinal, btype;
      if (!br.get(1, &bfinal) || !br.get(2, &btype)) {
        br.init(data, size, block_start);
        break;  // underrun: resume at header
      }
      if (btype == 3) {
        res->err = ERR_BAD_BLOCK_TYPE;
        break;
      }
      st->bfinal = int32_t(bfinal);
      if (btype == 0) {
        br.align_byte();
        uint32_t ln, nlen;
        if (!br.get(16, &ln) || !br.get(16, &nlen)) {
          br.init(data, size, block_start);
          break;
        }
        if (ln != (~nlen & 0xFFFF)) {
          res->err = ERR_STORED_LEN_MISMATCH;
          break;
        }
        st->stored_remaining = ln;
        if (ln == 0) {
          st->mode = st->bfinal ? 3 : 0;
          continue;
        }
        st->mode = 2;
      } else if (btype == 1) {
        st->is_fixed = 1;
        st->mode = 1;
      } else {
        int err = read_dynamic(br, &st->tables);
        if (err == ERR_TRUNCATED) {  // header split: re-parse next call
          br.init(data, size, block_start);
          break;
        }
        if (err) {
          res->err = err;
          break;
        }
        st->is_fixed = 0;
        st->mode = 1;
      }
      continue;
    }
    if (st->mode == 2) {  // stored payload (byte-aligned here)
      int64_t avail = br.bits_available() >> 3;
      int64_t take = st->stored_remaining < avail ? st->stored_remaining
                                                  : avail;
      if (take > budget_left()) take = budget_left();
      if (take > 0) {
        if (nt >= cap) {
          res->err = ERR_TAPE_OVERFLOW;
          break;
        }
        int64_t off = br.bit_position() >> 3;
        out_len[nt] = int32_t(take);
        dist[nt] = 0;
        root_val[nt] = STORED_FLAG | int32_t(off);
        nt++;
        produced += take;
        st->stored_remaining -= take;
        br.init(data, size, (off + take) * 8);
      }
      if (st->stored_remaining > 0) {
        if (budget_left() <= 0) {
          res->suspended = 1;
        }
        break;  // need more input or budget
      }
      st->mode = st->bfinal ? 3 : 0;
      continue;
    }
    // mode 1: compressed data, symbol loop
    const uint32_t* lit_t = st->is_fixed ? g_fixed.lit : st->tables.lit;
    const uint32_t* dist_t = st->is_fixed ? g_fixed.dist : st->tables.dist;
    for (;;) {
      if (budget_left() <= 0) {
        res->suspended = 1;
        goto done;
      }
      int64_t sym_start = br.bit_position();
      uint32_t op, extra, val;
      int err = decode_symbol(br, lit_t, kLitRoot, &op, &extra, &val);
      if (err == ERR_TRUNCATED) {
        br.init(data, size, sym_start);
        goto done;
      }
      if (err) {
        res->err = err;
        goto done;
      }
      if (op == OP_END) {
        st->mode = st->bfinal ? 3 : 0;
        break;
      }
      if (nt >= cap) {
        res->err = ERR_TAPE_OVERFLOW;
        br.init(data, size, sym_start);
        goto done;
      }
      if (op == OP_LITERAL) {
        out_len[nt] = 1;
        dist[nt] = 0;
        root_val[nt] = int32_t(val);
        nt++;
        produced++;
        continue;
      }
      uint32_t ebits = 0;
      if (extra && !br.get(extra, &ebits)) {
        br.init(data, size, sym_start);
        goto done;
      }
      int length = val + ebits;
      uint32_t dop, dextra, dval;
      err = decode_symbol(br, dist_t, kDistRoot, &dop, &dextra, &dval);
      if (err == ERR_TRUNCATED) {
        br.init(data, size, sym_start);
        goto done;
      }
      if (err) {
        res->err = err;
        goto done;
      }
      uint32_t debits = 0;
      if (dextra && !br.get(dextra, &debits)) {
        br.init(data, size, sym_start);
        goto done;
      }
      int64_t d = dval + debits;
      if (d > produced + window_len) {
        res->err = ERR_BAD_DISTANCE;
        goto done;
      }
      out_len[nt] = length;
      dist[nt] = int32_t(d);
      root_val[nt] = 0;
      nt++;
      produced += length;
    }
  }
done:
  res->n_tokens = nt;
  res->end_bit = br.bit_position();
  res->total_out = produced - produced_init;
  return res->err;
}

// Resolve a token tape to bytes on the host (oracle/bench path).
// window: up to 32768 bytes of history. Returns 0 or error.
int32_t tbz_resolve(const uint8_t* data, int64_t data_size,
                    const int32_t* out_len, const int32_t* dist,
                    const int32_t* root_val, int64_t n_tokens,
                    const uint8_t* window, int64_t window_len,
                    uint8_t* out, int64_t out_cap) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n_tokens; i++) {
    int32_t ln = out_len[i];
    if (pos + ln > out_cap) return ERR_TAPE_OVERFLOW;
    int32_t d = dist[i];
    if (d) {
      int64_t src = pos - d;
      if (src < -window_len) return ERR_BAD_DISTANCE;
      int64_t k = 0;
      while (src + k < 0 && k < ln)
        out[pos + k] = window[window_len + src + k], k++;
      for (; k < ln; k++) out[pos + k] = out[src + k];
      pos += ln;
    } else if (root_val[i] & STORED_FLAG) {
      int64_t off = root_val[i] & (STORED_FLAG - 1);
      if (off + ln > data_size) return ERR_TRUNCATED;
      std::memcpy(out + pos, data + off, ln);
      pos += ln;
    } else {
      out[pos++] = uint8_t(root_val[i]);
    }
  }
  return OK;
}

// ---- fused inflate --------------------------------------------------------
// Single-pass decode: symbols materialize bytes immediately (the shape of
// the reference's hot loop, deflate.lisp:673-702, with word-wide copies in
// the spirit of %copy-history's specialization, deflate.lisp:244-335).
// Output buffer grows geometrically (api.lisp:49-65 contract).

// Post-pass on a freshly built litlen table: where a root index decodes
// a literal whose code leaves room for a SECOND complete literal code
// within the root bits, replace the entry with a fused OP_LIT2 pair.
// Reads from a snapshot so fusion order cannot chain.
static void fuse_lit_pairs(uint32_t* t) {
  constexpr int R = kLitRoot;
  static thread_local uint32_t snap[1 << R];
  std::memcpy(snap, t, sizeof(snap));
  for (uint32_t idx = 0; idx < (1u << R); idx++) {
    uint32_t e = snap[idx];
    if (e_op(e) != OP_LITERAL) continue;
    int l1 = e_nbits(e);
    // entry at (idx >> l1) has its high l1 bits zero; it is the right
    // continuation iff its code fits the remaining root bits
    uint32_t e2 = snap[idx >> l1];
    if (e_op(e2) != OP_LITERAL || e_nbits(e2) > R - l1) continue;
    t[idx] = pack_entry(OP_LIT2, uint32_t(l1 + e_nbits(e2)), 0,
                        e_val(e) | (e_val(e2) << 8));
  }
}

static int32_t inflate_core(const uint8_t* data, int64_t size,
                            int64_t start_bit, const uint8_t* window,
                            int64_t window_len, uint8_t** out_ptr,
                            int64_t* out_cap_ptr, int64_t* out_len,
                            int64_t* end_bit, int32_t* finished,
                            int32_t fixed_buf) {
  ensure_fixed();
  Br br;
  br.init(data, size, start_bit);
  Tables dyn;
  uint8_t* out = *out_ptr;
  int64_t cap = *out_cap_ptr;
  int64_t pos = 0;
  *finished = 0;
  int32_t err = OK;

  auto ensure = [&](int64_t need) -> bool {
    if (fixed_buf) return pos + need <= cap;  // exact-bound caller buffer
    if (pos + need + 16 <= cap) return true;
    int64_t ncap = cap ? cap * 2 : (1 << 20);
    while (ncap < pos + need + 16) ncap *= 2;
    uint8_t* nb = (uint8_t*)realloc(out, ncap);
    if (!nb) return false;
    out = nb;
    cap = ncap;
    return true;
  };

  for (;;) {
    int64_t block_start = br.bit_position();
    uint32_t bfinal, btype;
    if (!br.get(1, &bfinal) || !br.get(2, &btype)) {
      err = ERR_TRUNCATED;
      br.init(data, size, block_start);
      break;
    }
    if (btype == 3) {
      err = ERR_BAD_BLOCK_TYPE;
      break;
    }
    if (btype == 0) {
      br.align_byte();
      uint32_t ln, nlen;
      if (!br.get(16, &ln) || !br.get(16, &nlen)) {
        err = ERR_TRUNCATED;
        br.init(data, size, block_start);
        break;
      }
      if (ln != (~nlen & 0xFFFF)) {
        err = ERR_STORED_LEN_MISMATCH;
        break;
      }
      if (br.bits_available() < int64_t(ln) * 8) {
        err = ERR_TRUNCATED;
        br.init(data, size, block_start);
        break;
      }
      if (!ensure(ln)) {
        err = ERR_TAPE_OVERFLOW;
        break;
      }
      int64_t off = br.bit_position() >> 3;
      std::memcpy(out + pos, data + off, ln);
      pos += ln;
      br.init(data, size, (off + ln) * 8);
      if (bfinal) {
        *finished = 1;
        break;
      }
      continue;
    }
    const uint32_t* lit_t;
    const uint32_t* dist_t;
    if (btype == 1) {
      lit_t = g_fixed.lit;  // fixed lits are 8-9 bits: nothing fuses
      dist_t = g_fixed.dist;
    } else {
      err = read_dynamic(br, &dyn);
      if (err) {
        if (err == ERR_TRUNCATED) br.init(data, size, block_start);
        goto done;
      }
      fuse_lit_pairs(dyn.lit);
      lit_t = dyn.lit;
      dist_t = dyn.dist;
    }
    // ---- symbol loop with fast path ----
    for (;;) {
      // Fast region: enough input buffered for a worst-case token (48
      // bits) + headroom in out. Fill before each code; literals burst
      // while >=48 bits remain (a full worst-case token's budget).
      if (br.pos + 8 <= br.n && pos + 300 + 16 <= cap) {
        br.refill_fast();
        uint32_t e, eop;
        for (;;) {
          e = lit_t[uint32_t(br.buf) & ((1u << kLitRoot) - 1)];
          if (e_op(e) == OP_LINK)
            e = lit_t[e_val(e) +
                      ((uint32_t(br.buf) >> kLitRoot) &
                       ((1u << e_extra(e)) - 1))];
          eop = e_op(e);
          if (eop == OP_LIT2) {
            br.drop(e_nbits(e));
            uint32_t v = e_val(e);
            out[pos] = uint8_t(v);
            out[pos + 1] = uint8_t(v >> 8);
            pos += 2;
          } else if (eop == OP_LITERAL) {
            br.drop(e_nbits(e));
            out[pos++] = uint8_t(e_val(e));
          } else {
            break;
          }
          // 20 bits covers the worst litlen code + length extra
          // (15 + 5); peeks beyond nbits read zeros, never garbage,
          // so every lookup below stays within real bits.
          if (br.nbits < 20 || pos + 300 + 16 > cap) break;
        }
        if (eop == OP_LITERAL || eop == OP_LIT2)
          continue;  // burst ended on bits/space
        uint32_t op = e_op(e);
        if (op == OP_END) {
          br.drop(e_nbits(e));
          break;
        }
        if (op == OP_INVALID) {
          err = ERR_INVALID_CODE;
          goto done;
        }
        // combined code+extra consume (>=20 real bits guaranteed by
        // the burst condition): extra bits sit right above the code
        int64_t tok_bit = br.bit_position();
        int len = e_val(e) +
                  (uint32_t(br.buf >> e_nbits(e)) &
                   ((1u << e_extra(e)) - 1));
        br.drop(e_nbits(e) + e_extra(e));
        if (br.pos + 8 <= br.n) {
          br.refill_fast();
        } else {
          br.fill();
          if (br.nbits < 28) {
            // input nearly exhausted: the dist code + extra (worst 28
            // bits) may not be fully buffered — replay this token in
            // the careful region, which checks underrun per field
            br.init(data, size, tok_bit);
            continue;
          }
        }
        uint32_t de = dist_t[uint32_t(br.buf) & ((1u << kDistRoot) - 1)];
        if (e_op(de) == OP_LINK)
          de = dist_t[e_val(de) +
                      ((uint32_t(br.buf) >> kDistRoot) &
                       ((1u << e_extra(de)) - 1))];
        if (e_op(de) != OP_MATCH) {
          err = ERR_INVALID_CODE;
          goto done;
        }
        int64_t d = e_val(de) +
                    (uint32_t(br.buf >> e_nbits(de)) &
                     ((1u << e_extra(de)) - 1));
        br.drop(e_nbits(de) + e_extra(de));
        int64_t src = pos - d;
        if (src < 0) {
          if (src < -window_len) {
            err = ERR_BAD_DISTANCE;
            goto done;
          }
          int64_t k = 0;
          while (src + k < 0 && k < len)
            out[pos + k] = window[window_len + src + k], k++;
          for (; k < len; k++) out[pos + k] = out[src + k];
          pos += len;
        } else if (d >= 16) {
          // 16B copies with slack headroom (safe: no overlap within a
          // 16B chunk when d >= 16)
          int64_t k = 0;
          do {
            uint64_t w0, w1;
            std::memcpy(&w0, out + src + k, 8);
            std::memcpy(&w1, out + src + k + 8, 8);
            std::memcpy(out + pos + k, &w0, 8);
            std::memcpy(out + pos + k + 8, &w1, 8);
            k += 16;
          } while (k < len);
          pos += len;
        } else if (d >= 8) {
          // word copies with 16-byte slack headroom
          int64_t k = 0;
          do {
            uint64_t w;
            std::memcpy(&w, out + src + k, 8);
            std::memcpy(out + pos + k, &w, 8);
            k += 8;
          } while (k < len);
          pos += len;
        } else if (d == 1) {
          std::memset(out + pos, out[src], len);
          pos += len;
        } else {
          // 1 < d < 8: seed one period, then double it (each memcpy's
          // source range [pos, pos+filled) never overlaps its target)
          for (int64_t k = 0; k < d; k++) out[pos + k] = out[src + k];
          int64_t filled = d;
          while (filled < len) {
            int64_t take = filled < len - filled ? filled : len - filled;
            std::memcpy(out + pos + filled, out + pos, size_t(take));
            filled += take;
          }
          pos += len;
        }
        continue;
      }
      // Careful region (near input/output end).
      int64_t sym_start = br.bit_position();
      uint32_t op, extra, val;
      int derr = decode_symbol(br, lit_t, kLitRoot, &op, &extra, &val);
      if (derr) {
        err = derr;
        if (err == ERR_TRUNCATED) br.init(data, size, sym_start);
        goto done;
      }
      if (op == OP_END) break;
      if (op == OP_LITERAL || op == OP_LIT2) {
        if (!ensure(op == OP_LIT2 ? 2 : 1)) {
          err = ERR_TAPE_OVERFLOW;
          goto done;
        }
        out[pos++] = uint8_t(val);
        if (op == OP_LIT2) out[pos++] = uint8_t(val >> 8);
        continue;
      }
      uint32_t ebits = 0;
      if (extra && !br.get(extra, &ebits)) {
        err = ERR_TRUNCATED;
        br.init(data, size, sym_start);
        goto done;
      }
      int len = val + ebits;
      uint32_t dop, dextra, dval;
      derr = decode_symbol(br, dist_t, kDistRoot, &dop, &dextra, &dval);
      if (derr) {
        err = derr;
        if (err == ERR_TRUNCATED) br.init(data, size, sym_start);
        goto done;
      }
      uint32_t debits = 0;
      if (dextra && !br.get(dextra, &debits)) {
        err = ERR_TRUNCATED;
        br.init(data, size, sym_start);
        goto done;
      }
      int64_t d = dval + debits;
      int64_t src = pos - d;
      if (src < -window_len) {
        err = ERR_BAD_DISTANCE;
        goto done;
      }
      if (!ensure(len)) {
        err = ERR_TAPE_OVERFLOW;
        goto done;
      }
      int64_t k = 0;
      while (src + k < 0 && k < len)
        out[pos + k] = window[window_len + src + k], k++;
      for (; k < len; k++) out[pos + k] = out[src + k];
      pos += len;
    }
    if (bfinal) {
      *finished = 1;
      break;
    }
  }
done:
  *out_ptr = out;
  *out_cap_ptr = cap;
  *out_len = pos;
  *end_bit = br.bit_position();
  return err;
}

// ---- LZ77 matcher ---------------------------------------------------------
// Hash-chain lazy matcher. Returns token count, or -1 on cap overflow.
// Own implementation of the standard scheme (zlib-class quality).
int64_t tbz_match(const uint8_t* b, int64_t n, int32_t level,
                  int32_t* out_len, int32_t* dist, int32_t* lit,
                  int64_t cap) {
  struct Cfg {
    int good, lazy, nice, chain;
  };
  // Slightly deeper chains than zlib's config table at 6/7: the package-
  // merge entropy stage amortizes it, keeping sizes below libz at every
  // level with comparable speed.
  // Deeper than zlib's config table at the same level: the package-
  // merge entropy stage + DP parse (levels>=4 route to tbz_match_optimal)
  // amortize it, keeping sizes below libz at EVERY level.
  static const Cfg cfgs[10] = {
      {0, 0, 0, 0},        {4, 0, 16, 8},     {4, 0, 24, 16},
      {4, 0, 32, 32},      {4, 8, 32, 48},    {8, 24, 64, 96},
      {8, 32, 128, 256},   {16, 64, 258, 512}, {32, 128, 258, 1024},
      {32, 258, 258, 4096}};
  Cfg cfg = cfgs[level < 1 ? 1 : (level > 9 ? 9 : level)];
  constexpr int HBITS = 15, HSIZE = 1 << HBITS;
  constexpr int MIN_MATCH = 3, MAX_MATCH = 258, MAX_DIST = 32768;
  constexpr int TOO_FAR = 4096;  // reject len-3 matches farther than this

  int32_t* head = new int32_t[HSIZE];
  int32_t* prev = new int32_t[n > 0 ? n : 1];
  for (int i = 0; i < HSIZE; i++) head[i] = -1;

  auto hash3 = [&](int64_t i) -> uint32_t {
    return ((uint32_t(b[i]) << 10) ^ (uint32_t(b[i + 1]) << 5) ^
            b[i + 2]) & (HSIZE - 1);
  };
  auto insert = [&](int64_t i) {
    if (i + MIN_MATCH <= n) {
      uint32_t h = hash3(i);
      prev[i] = head[h];
      head[h] = int32_t(i);
    }
  };
  // find best match at i (i not yet inserted)
  auto find = [&](int64_t i, int* best_len, int64_t* best_dist,
                  int prev_len) {
    *best_len = 0;
    *best_dist = 0;
    if (i + MIN_MATCH > n) return;
    int max_len = int(n - i < MAX_MATCH ? n - i : MAX_MATCH);
    int chain = cfg.chain;
    if (prev_len >= cfg.good) chain >>= 2;
    int bl = MIN_MATCH - 1;
    int64_t cand = head[hash3(i)];
    while (cand >= 0 && i - cand <= MAX_DIST && chain-- > 0) {
      if (b[cand + bl] == b[i + bl] && b[cand] == b[i]) {
        int l = 0;
        while (l < max_len && b[cand + l] == b[i + l]) l++;
        if (l > bl && !(l == MIN_MATCH && i - cand > TOO_FAR)) {
          bl = l;
          *best_dist = i - cand;
          if (l >= cfg.nice) break;
        }
      }
      cand = prev[cand];
    }
    if (bl >= MIN_MATCH) *best_len = bl;
  };

  int64_t nt = 0;
  int64_t i = 0;
  auto emit_lit = [&](int64_t p) -> bool {
    if (nt >= cap) return false;
    out_len[nt] = 1;
    dist[nt] = 0;
    lit[nt] = b[p];
    nt++;
    return true;
  };
  int cur_len = 0;
  int64_t cur_dist = 0;
  while (i < n) {
    find(i, &cur_len, &cur_dist, 0);
    insert(i);
    if (cur_len >= MIN_MATCH && cfg.lazy && cur_len < cfg.lazy &&
        i + 1 < n) {
      int nl;
      int64_t nd;
      find(i + 1, &nl, &nd, cur_len);
      if (nl > cur_len) {
        if (!emit_lit(i)) goto overflow;
        i += 1;
        continue;
      }
    }
    if (cur_len >= MIN_MATCH) {
      if (nt >= cap) goto overflow;
      out_len[nt] = cur_len;
      dist[nt] = int32_t(cur_dist);
      lit[nt] = 0;
      nt++;
      for (int64_t k = i + 1; k < i + cur_len; k++) insert(k);
      i += cur_len;
    } else {
      if (!emit_lit(i)) goto overflow;
      i += 1;
    }
  }
  delete[] head;
  delete[] prev;
  return nt;
overflow:
  delete[] head;
  delete[] prev;
  return -1;
}

}  // extern "C"

// ---- speculative-lane gap decoder -----------------------------------------
// Host-side helper for the speculative device tokenizer
// (ops/speculative.py): decode symbols from a mid-block bit position
// with KNOWN code lengths, stopping when the position lands in a lane's
// visited set (self-synchronization merge), at the lane end, or at the
// block's end-of-block symbol (consumed). The python stitcher calls this
// instead of symbol-at-a-time python decode (~100x).

struct GapResult {
  int64_t n_tokens;
  int64_t end_bit;    // position after the last consumed symbol
  int64_t merge_idx;  // index into `visited` where we merged, or -1
  int32_t hit_eob;    // consumed the end-of-block symbol
  int32_t err;
};

extern "C" int32_t tbz_gap_decode(
    const uint8_t* data, int64_t size, int64_t start_bit,
    const uint8_t* lit_lens, int32_t n_lit,
    const uint8_t* dist_lens, int32_t n_dist,
    const int32_t* visited, int64_t n_visited, int64_t lane_end_bit,
    int32_t* out_len, int32_t* dist, int32_t* root_val, int64_t cap,
    GapResult* res) {
  Tables t;
  int err = build_table(lit_lens, n_lit, KIND_LITLEN, kLitRoot, t.lit,
                        kEnoughLit);
  if (!err)
    err = build_table(dist_lens, n_dist, KIND_DIST, kDistRoot, t.dist,
                      kEnoughDist);
  res->n_tokens = 0;
  res->merge_idx = -1;
  res->hit_eob = 0;
  res->end_bit = start_bit;
  if (err) {
    res->err = err;
    return err;
  }
  Br br;
  br.init(data, size, start_bit);
  int64_t nt = 0;
  for (;;) {
    int64_t p = br.bit_position();
    if (n_visited) {  // binary search the sorted visited positions
      int64_t lo = 0, hi = n_visited - 1;
      while (lo <= hi) {
        int64_t mid = (lo + hi) >> 1;
        if (visited[mid] == p) {
          res->merge_idx = mid;
          break;
        }
        if (visited[mid] < p)
          lo = mid + 1;
        else
          hi = mid - 1;
      }
      if (res->merge_idx >= 0) break;
    }
    if (p >= lane_end_bit) break;
    uint32_t op, extra, val;
    err = decode_symbol(br, t.lit, kLitRoot, &op, &extra, &val);
    if (err) break;
    if (op == OP_END) {
      res->hit_eob = 1;
      break;  // EOB consumed; bit position is past it
    }
    if (nt >= cap) {
      err = ERR_TAPE_OVERFLOW;
      br.init(data, size, p);  // resumable at this symbol
      break;
    }
    if (op == OP_LITERAL) {
      out_len[nt] = 1;
      dist[nt] = 0;
      root_val[nt] = int32_t(val);
      nt++;
      continue;
    }
    uint32_t ebits = 0;
    if (extra && !br.get(extra, &ebits)) {
      err = ERR_TRUNCATED;
      break;
    }
    uint32_t dop, dextra, dval;
    err = decode_symbol(br, t.dist, kDistRoot, &dop, &dextra, &dval);
    if (err) break;
    if (dop != OP_MATCH) {
      err = ERR_INVALID_CODE;
      break;
    }
    uint32_t debits = 0;
    if (dextra && !br.get(dextra, &debits)) {
      err = ERR_TRUNCATED;
      break;
    }
    out_len[nt] = int32_t(val + ebits);
    dist[nt] = int32_t(dval + debits);
    root_val[nt] = 0;
    nt++;
  }
  res->n_tokens = nt;
  res->end_bit = br.bit_position();
  res->err = err;
  return err;
}

// ---- speculative dynamic-header scanner (round 4) --------------------------
// rapidgzip-style block-boundary speculation (parallel-inflate
// literature, PAPERS.md): try every bit position as "BFINAL + BTYPE=10
// (dynamic) + full header"; a position survives iff parse_dynamic_lens
// accepts it — acceptance IDENTICAL to the real decoder by
// construction, so every true dynamic-block header in a valid stream is
// found, plus rare false positives that the chain walk in
// ops/batched.py culls. This removes the sequential header dependency
// that forced one device round trip per block (the reference's decode
// is strictly sequential, deflate.lisp:640-720; parallelism is ours).

// Little-endian 64-bit window starting at `bit`, zero-padded past end.
static inline uint64_t peek64(const uint8_t* data, int64_t size,
                              int64_t bit) {
  int64_t byte = bit >> 3;
  int sh = int(bit & 7);
  if (byte + 9 <= size) {
    uint64_t lo;
    std::memcpy(&lo, data + byte, 8);
    if (!sh) return lo;
    uint64_t hi8 = data[byte + 8];
    return (lo >> sh) | (hi8 << (64 - sh));
  }
  uint8_t tmp[9] = {0};
  if (byte < size) std::memcpy(tmp, data + byte, size_t(size - byte));
  uint64_t lo;
  std::memcpy(&lo, tmp, 8);
  if (!sh) return lo;
  return (lo >> sh) | (uint64_t(tmp[8]) << (64 - sh));
}

// Cheap pre-filter for a dynamic header at sym bit `hb` (= block start
// + 3): HLIT/HDIST in range and the code-length code exactly
// Kraft-complete. Never rejects a position parse_dynamic_lens accepts;
// rejects ~97-98% of random positions in ~two 64-bit loads.
static inline bool precode_plausible(const uint8_t* data, int64_t size,
                                     int64_t hb) {
  uint64_t w0 = peek64(data, size, hb);
  uint32_t hlit5 = uint32_t(w0) & 31;
  uint32_t hdist5 = uint32_t(w0 >> 5) & 31;
  uint32_t hclen4 = uint32_t(w0 >> 10) & 15;
  if (hlit5 > 29 || hdist5 > 29) return false;  // parse: TOO_MANY_SYMBOLS
  int ncl = int(hclen4) + 4;
  // cl lens: 3*ncl <= 57 bits starting at hb+14; w0 holds 50 of them
  uint64_t w = w0 >> 14;
  int counts[8] = {0};
  int i = 0;
  for (; i < 16 && i < ncl; i++) counts[(w >> (3 * i)) & 7]++;
  if (ncl > 16) {
    uint64_t w1 = peek64(data, size, hb + 14 + 48);
    for (; i < ncl; i++) counts[(w1 >> (3 * (i - 16))) & 7]++;
  }
  int left = 1;
  for (int l = 1; l <= 7; l++) {
    left = (left << 1) - counts[l];
    if (left < 0) return false;  // over-subscribed
  }
  return left == 0;  // must be exactly complete (all-zero fails too)
}

struct ScanHit {
  int64_t hdr_bit;  // bit index of the BFINAL bit
  int32_t bfinal;
  int32_t hlit, hdist;
  uint8_t lens[320];
  int32_t sym_off;  // symbol stream starts at hdr_bit + sym_off
};

// Scan [from_bit, to_bit) for plausible dynamic block headers. Results
// sorted by hdr_bit. Returns 0, or 1 if more than `cap` hits were found
// (first `cap` in scan order are returned; caller rescans with a larger
// cap). want_threads <= 0 means hardware_concurrency.
extern "C" int32_t tbz_scan_headers(
    const uint8_t* data, int64_t size, int64_t from_bit, int64_t to_bit,
    int32_t want_threads, int64_t* hdr_bits, int64_t* sym_bits,
    int32_t* bfinal_out, int32_t* hlit_out, int32_t* hdist_out,
    uint8_t* lens_out /* (cap, 320) */, int64_t cap, int64_t* n_found) {
  int64_t nbits = size * 8;
  if (to_bit > nbits) to_bit = nbits;
  if (from_bit < 0) from_bit = 0;
  *n_found = 0;
  // need at least 3 header bits + 14 size bits to be worth testing
  int64_t hi = to_bit - 17;
  if (hi <= from_bit) return 0;

  unsigned hw = std::thread::hardware_concurrency();
  int nt = want_threads > 0 ? want_threads : (hw ? int(hw) : 1);
  int64_t span = hi - from_bit;
  if (nt > 1 && span / nt < (64 << 10) * 8) nt = std::max<int64_t>(
      1, span / ((64 << 10) * 8));

  std::vector<std::vector<ScanHit>> hits(nt);
  auto scan_range = [&](int t, int64_t lo, int64_t up) {
    std::vector<ScanHit>& out = hits[t];
    for (int64_t p = lo; p < up; p++) {
      // BTYPE bits (LSB-first) at p+1, p+2 must be 0,1 => dynamic (2)
      int64_t q = p + 1;
      if (((data[q >> 3] >> (q & 7)) & 1) != 0) continue;
      q = p + 2;
      if (((data[q >> 3] >> (q & 7)) & 1) != 1) continue;
      if (!precode_plausible(data, size, p + 3)) continue;
      ScanHit h;
      Br br;
      br.init(data, size, p + 3);
      if (parse_dynamic_lens(br, h.lens, &h.hlit, &h.hdist) != OK)
        continue;
      h.hdr_bit = p;
      h.bfinal = int32_t((data[p >> 3] >> (p & 7)) & 1);
      h.sym_off = int32_t(br.bit_position() - p);
      out.push_back(h);
    }
  };
  if (nt == 1) {
    scan_range(0, from_bit, hi);
  } else {
    std::vector<std::thread> ths;
    int64_t step = (span + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
      int64_t lo = from_bit + t * step;
      int64_t up = std::min(hi, lo + step);
      if (lo >= up) break;
      ths.emplace_back(scan_range, t, lo, up);
    }
    for (auto& th : ths) th.join();
  }
  int64_t n = 0;
  int32_t overflow = 0;
  for (int t = 0; t < nt; t++) {  // ranges are disjoint and ordered
    for (const ScanHit& h : hits[t]) {
      if (n >= cap) {
        overflow = 1;
        break;
      }
      hdr_bits[n] = h.hdr_bit;
      sym_bits[n] = h.hdr_bit + h.sym_off;
      bfinal_out[n] = h.bfinal;
      hlit_out[n] = h.hlit;
      hdist_out[n] = h.hdist;
      std::memcpy(lens_out + n * 320, h.lens, 320);
      n++;
    }
    if (overflow) break;
  }
  *n_found = n;
  return overflow;
}

// The positions of [from_bit, to_bit - 17) that pass tbz_scan_headers'
// pre-filter (BTYPE = 10 and precode_plausible), i.e. reach its full
// header parse. One thread.
extern "C" int64_t tbz_scan_survivors(const uint8_t* data, int64_t size,
                                      int64_t from_bit, int64_t to_bit) {
  if (to_bit > size * 8) to_bit = size * 8;
  if (from_bit < 0) from_bit = 0;
  int64_t n = 0;
  for (int64_t p = from_bit; p < to_bit - 17; p++) {
    int64_t q = p + 1;
    if (((data[q >> 3] >> (q & 7)) & 1) != 0) continue;
    q = p + 2;
    if (((data[q >> 3] >> (q & 7)) & 1) != 1) continue;
    n += precode_plausible(data, size, p + 3);
  }
  return n;
}

// ---- flat span planner (round 3) ------------------------------------------
// Layout for the FLAT resolver kernel (ops/resolve_spans.py
// _resolve_flat_impl), designed from the round-3 on-chip profile of the
// grid kernel: per-step cost there was ~20 small ops (chunk-transition
// cond, local-table rebuild, publish DUS, 256B two-row frames), none
// dominant — op-soup overhead, not the gather primitive, was the floor.
// The flat form deletes the chunk machinery entirely:
//  - literal/stored bytes are written directly into the host-prefilled
//    output buffer (out0) and NEVER enter the kernel — only match spans
//    remain (typically 30-40% fewer slots);
//  - the device table IS the output array (256 window rows prepended),
//    in global row coordinates: no local table, no window carry, no
//    chunk transition, no publish;
//  - spans are chopped at 128B boundaries of BOTH dst and src, so every
//    slot is one single-row frame fetch (table[u], 32 words) + an
//    in-register barrel shift — src-chop costs only ~len/128 extra
//    spans (~4% at typical lengths);
//  - batches are G row-groups x K slots, list-scheduled GLOBALLY
//    (byte-granular last-writer over the whole output, no chunk
//    boundaries), so batch count ~ max(dependency depth, groups/G).
// Streams are limited to <2GB - 32KB by int32 table byte addresses.

// Full-flattening chase limits: measured on the bench mix (2MB), a
// split budget of 30x spans + 256 hops collapses the global dependency
// depth from 565 to ~50 at only +17% spans (saturates: 200x/1024 gives
// the same), which is what lets batches be big AND full.
#ifndef BUDX
#define BUDX 30
#endif
#ifndef HOPX
#define HOPX 256
#endif
struct FlatPlan {
  int64_t n_batches;
  int64_t total_out;
  int64_t n_spans;
  int32_t err;
};

extern "C" int32_t tbz_plan_spans_flat(
    const int32_t* out_len, const int32_t* dist, const int32_t* root_val,
    int64_t n_tokens, const uint8_t* input, int64_t input_size,
    int64_t window_len, int64_t G, int64_t K, int64_t seg_rows,
    int32_t* sp_srcaddr, int16_t* sp_lenoff, int64_t slot_cap,
    int32_t* g_row, int32_t* b_segrow, int64_t group_cap,
    int64_t batch_cap, uint8_t* out0, int64_t out0_cap, FlatPlan* plan) {
  (void)window_len;
  plan->n_batches = 0;
  plan->n_spans = 0;
  int64_t total = 0;
  for (int64_t i = 0; i < n_tokens; i++) total += out_len[i];
  plan->total_out = total;
  if (total > (int64_t(1) << 31) - 65536 || total > out0_cap) {
    plan->err = ERR_TAPE_OVERFLOW;
    return ERR_TAPE_OVERFLOW;
  }
  std::memset(out0, 0, size_t(total));
  double tp0 = plan_timing() ? now_ms() : 0.0;

  struct FSpan {
    int32_t src;  // global byte coord, may be negative (window/dict)
    int32_t dst;
    int32_t len;
  };
  std::vector<FSpan> spans;
  spans.reserve(size_t(n_tokens) + size_t(total >> 8) + 64);

  // --- phase 1: literals/stored straight into out0; matches to spans,
  // doubling decomposition + dst 128B-row chop
  int64_t p = 0;
  for (int64_t i = 0; i < n_tokens; i++) {
    int32_t l = out_len[i];
    int32_t d = dist[i];
    if (d == 0) {
      if (root_val[i] & STORED_FLAG) {
        int64_t off = root_val[i] & (STORED_FLAG - 1);
        if (off + l > input_size) {
          plan->err = ERR_TRUNCATED;
          return ERR_TRUNCATED;
        }
        std::memcpy(out0 + p, input + off, size_t(l));
      } else {
        out0[p] = uint8_t(root_val[i]);
      }
      p += l;
      continue;
    }
    int64_t c = 0;
    while (c < l) {
      int64_t D = int64_t(d) * (c / d + 1);  // non-overlap distance
      int64_t t = D < 128 ? D : 128;
      if (t > l - c) t = l - c;
      int64_t dst = p + c;
      int64_t room = 128 - (dst & 127);
      if (t > room) t = room;
      spans.push_back({int32_t(dst - D), int32_t(dst), int32_t(t)});
      c += t;
    }
    p += l;
  }

  double tp1 = plan_timing() ? now_ms() : 0.0;
  // --- phase 1b: source redirect, global reach (the table holds the
  // whole output, so any already-resolved source is addressable; chase
  // fully-contained sources to flat ancestors, split on straddles).
  // THREADED: contiguous span ranges chase in parallel against the
  // read-only pre-redirect list. The memo is shared single-writer-per-
  // entry (each index belongs to exactly one range): memo_src is
  // plain, memo_ok an acquire/release flag — a racy miss just means a
  // manual chase of the same (deterministic) value, so the flattened
  // sources are identical to the serial result except where HOPX caps
  // a chase that a memo hit would have shortcut (still byte-correct:
  // the scheduler orders ANY source layout via last-writer tracking).
  {
    int64_t ns0 = int64_t(spans.size());
    const std::vector<FSpan>& base = spans;
    // direct byte -> covering-span map (replaces a per-hop binary
    // search; bytes not covered by any match span map to -1 = gen 0).
    // Bulk-filled once: the chase loop's hops become O(1) loads.
    std::vector<int32_t> pos2span((size_t(total)));
    std::memset(pos2span.data(), 0xFF, size_t(total) * 4);
    for (int64_t i = 0; i < ns0; i++) {
      const FSpan& sp = base[size_t(i)];
      for (int64_t x = sp.dst; x < int64_t(sp.dst) + sp.len; x++)
        pos2span[size_t(x)] = int32_t(i);
    }
    auto find_span = [&pos2span, total](int64_t pos) -> int64_t {
      if (pos < 0 || pos >= total) return -1;
      return pos2span[size_t(pos)];
    };
    std::vector<int32_t> memo_src(size_t(ns0), 0);
    std::vector<std::atomic<uint8_t>> memo_ok((size_t(ns0)));
    for (auto& f : memo_ok) f.store(0, std::memory_order_relaxed);
    unsigned hw = std::thread::hardware_concurrency();
    unsigned T = std::min<unsigned>(hw ? hw : 4, 8);
    if (ns0 < 65536) T = 1;
    int64_t per = (ns0 + T - 1) / int64_t(T);
    std::vector<std::vector<FSpan>> flats(T);
    auto worker = [&](unsigned ti) {
      int64_t lo = int64_t(ti) * per;
      int64_t hi = std::min(ns0, lo + per);
      if (lo >= hi) return;
      std::vector<FSpan>& flat = flats[ti];
      flat.reserve(size_t(hi - lo) + size_t(hi - lo) / 2);
      int64_t split_budget = (hi - lo) * BUDX + 1024;
      std::vector<FSpan> pend;
      for (int64_t i = lo; i < hi; i++) {
        const FSpan& s0 = base[size_t(i)];
        FSpan cur = s0;
        bool was_split = false;
        pend.clear();
        for (;;) {
          for (int hops = 0; hops < HOPX; hops++) {
            if (cur.src < 0) break;  // window/dict, resolved from step 0
            int64_t tix = find_span(cur.src);
            if (tix < 0) break;
            const FSpan& t = base[size_t(tix)];
            int64_t t_end = int64_t(t.dst) + t.len;
            if (cur.src >= t_end) break;  // lit/stored bytes (gen 0)
            if (int64_t(cur.src) + cur.len <= t_end) {
              if (memo_ok[size_t(tix)].load(std::memory_order_acquire)) {
                cur.src = memo_src[size_t(tix)] + (cur.src - t.dst);
                break;  // memo target is already flat
              }
              cur.src -= t.dst - t.src;
            } else if (split_budget > 0) {
              int64_t l1 = t_end - cur.src;
              pend.push_back({int32_t(cur.src + l1),
                              int32_t(cur.dst + l1),
                              int32_t(cur.len - l1)});
              cur.len = int32_t(l1);
              split_budget--;
              was_split = true;
            } else {
              break;
            }
          }
          flat.push_back(cur);
          if (pend.empty()) break;
          cur = pend.back();
          pend.pop_back();
        }
        if (!was_split) {
          memo_src[size_t(i)] = flat.back().src;
          memo_ok[size_t(i)].store(1, std::memory_order_release);
        }
      }
    };
    if (T == 1) {
      worker(0);
    } else {
      std::vector<std::thread> ths;
      for (unsigned ti = 0; ti < T; ti++) ths.emplace_back(worker, ti);
      for (auto& th : ths) th.join();
    }
    size_t tot = 0;
    for (auto& f : flats) tot += f.size();
    std::vector<FSpan> flat;
    flat.reserve(tot);
    for (auto& f : flats)
      flat.insert(flat.end(), f.begin(), f.end());
    spans.swap(flat);
  }

  double tp2 = plan_timing() ? now_ms() : 0.0;
  // --- phase 1c: src 128B-row chop (single-row frame contract). Table
  // byte address = src + 32768 (window rows 0..255); a span must not
  // straddle a table row, and the window offset preserves 128-alignment.
  {
    std::vector<FSpan> chopped;
    chopped.reserve(spans.size() + spans.size() / 16);
    for (const FSpan& s : spans) {
      int32_t a = (s.src + 32768) & 127;
      if (a + s.len <= 128) {
        chopped.push_back(s);
      } else {
        int32_t l1 = 128 - a;
        chopped.push_back({s.src, s.dst, l1});
        chopped.push_back({s.src + l1, s.dst + l1, s.len - l1});
      }
    }
    spans.swap(chopped);
  }

  // --- phase 2: segmented list scheduling into (G x K) batches -------------
  // Batches are SEGMENT-PURE: every batch's dst rows live in one
  // seg_rows-row window of the output, so the device kernel scatter-adds
  // into a small dynamic slice of the table (measured: row scatter-add
  // into a >=4MB HBM table runs ~18M rows/s vs ~83M+ on VMEM-sized
  // targets; row GATHER is DMA-fast at every table size, so sources stay
  // global). Spans arrive in dst order, so all spans of one dst row are
  // consecutive: per-row open-group state is a small list reset at each
  // row change; open batches seal when dst crosses a segment boundary
  // (once per seg_rows*128 output bytes). last_w is byte-granular; bytes
  // of earlier segments are resolved before this segment's first batch
  // runs, so only same-segment writers constrain placement.
  double tp3 = plan_timing() ? now_ms() : 0.0;
  struct BatchBuf {
    std::vector<int32_t> rows;
    std::vector<int32_t> srcaddr;  // groups*K
    std::vector<int16_t> lenoff;
    std::vector<uint8_t> fill;
  };
  const int64_t seg_bytes = seg_rows * 128;
  const int64_t n_segs = total ? (total + seg_bytes - 1) / seg_bytes : 0;

  // segment boundaries in the dst-sorted span list
  std::vector<int64_t> seg_first(size_t(n_segs) + 1, int64_t(spans.size()));
  {
    int64_t seg = -1;
    for (int64_t i = 0; i < int64_t(spans.size()); i++) {
      int64_t s = spans[size_t(i)].dst / seg_bytes;
      while (seg < s) seg_first[size_t(++seg)] = i;
    }
    while (seg < n_segs) seg_first[size_t(++seg)] = int64_t(spans.size());
  }

  // THREADED per-segment list scheduling: segments are independent by
  // construction (earlier segments + the prefill are fully resolved
  // before a segment's first batch runs; only same-segment writers
  // constrain placement). Each worker schedules its segments into
  // local BatchBufs with a segment-local byte-granular last-writer
  // array; emission into the output arrays is serial in segment order.
  std::vector<std::vector<BatchBuf>> seg_bs((size_t(n_segs)));
  std::atomic<int64_t> next_seg{0};
  auto sched_worker = [&]() {
    std::vector<int32_t> last_w;
    std::vector<std::pair<int32_t, int32_t>> row_open;
    for (;;) {
      int64_t sg = next_seg.fetch_add(1);
      if (sg >= n_segs) return;
      int64_t seg_base = sg * seg_bytes;
      int64_t lim = std::min(seg_bytes, total - seg_base);
      last_w.assign(size_t(lim), -1);
      row_open.clear();
      std::vector<BatchBuf>& bs = seg_bs[size_t(sg)];
      int32_t cur_row = -1;
      for (int64_t i = seg_first[size_t(sg)];
           i < seg_first[size_t(sg) + 1]; i++) {
        const FSpan& s = spans[size_t(i)];
        int32_t drow = s.dst >> 7;
        if (drow != cur_row) {
          cur_row = drow;
          row_open.clear();
        }
        int32_t b0 = 0;
        {
          int64_t a = s.src < seg_base ? seg_base : int64_t(s.src);
          int64_t e = int64_t(s.src) + s.len;
          for (int64_t x = a; x < e; x++) {
            int32_t w = last_w[size_t(x - seg_base)];
            if (w >= b0) b0 = w + 1;
          }
        }
        int32_t chosen = -1, gidx = -1;
        for (;;) {
          if (b0 >= int32_t(bs.size())) bs.emplace_back();
          BatchBuf& B = bs[size_t(b0)];
          gidx = -1;
          for (auto& pr : row_open)
            if (pr.first == b0 && B.fill[size_t(pr.second)] < K) {
              gidx = pr.second;
              break;
            }
          if (gidx >= 0) {
            chosen = b0;
            break;
          }
          if (int64_t(B.rows.size()) < G) {
            gidx = int32_t(B.rows.size());
            B.rows.push_back(int32_t(drow - sg * seg_rows));
            B.srcaddr.resize(B.srcaddr.size() + size_t(K), 0);
            B.lenoff.resize(B.lenoff.size() + size_t(K), 0);
            B.fill.push_back(0);
            row_open.emplace_back(b0, gidx);
            chosen = b0;
            break;
          }
          b0++;
        }
        BatchBuf& B = bs[size_t(chosen)];
        int32_t slot = B.fill[size_t(gidx)]++;
        B.srcaddr[size_t(gidx) * K + slot] = s.src + 32768;
        B.lenoff[size_t(gidx) * K + slot] =
            int16_t(((s.dst & 127) << 8) | s.len);
        for (int64_t x = s.dst; x < int64_t(s.dst) + s.len; x++)
          last_w[size_t(x - seg_base)] = chosen;
      }
    }
  };
  {
    unsigned hw = std::thread::hardware_concurrency();
    unsigned T = std::min<unsigned>(
        {hw ? hw : 4, 8, unsigned(n_segs ? n_segs : 1)});
    if (int64_t(spans.size()) < 65536) T = 1;
    if (T <= 1) {
      sched_worker();
    } else {
      std::vector<std::thread> ths;
      for (unsigned ti = 0; ti < T; ti++) ths.emplace_back(sched_worker);
      for (auto& th : ths) th.join();
    }
  }

  // serial emission, segment order
  int64_t n_spans = int64_t(spans.size());
  int64_t nb = 0;
  for (int64_t sg = 0; sg < n_segs; sg++) {
    for (const BatchBuf& B : seg_bs[size_t(sg)]) {
      if (nb >= batch_cap || (nb + 1) * G > group_cap ||
          (nb + 1) * G * K > slot_cap) {
        plan->err = ERR_TAPE_OVERFLOW;
        return ERR_TAPE_OVERFLOW;
      }
      int64_t ng = int64_t(B.rows.size());
      if (ng)
        std::memcpy(g_row + nb * G, B.rows.data(), size_t(ng) * 4);
      std::memset(g_row + nb * G + ng, 0, size_t(G - ng) * 4);
      if (ng) {
        std::memcpy(sp_srcaddr + nb * G * K, B.srcaddr.data(),
                    size_t(ng) * size_t(K) * 4);
        std::memcpy(sp_lenoff + nb * G * K, B.lenoff.data(),
                    size_t(ng) * size_t(K) * 2);
      }
      std::memset(sp_srcaddr + (nb * G + ng) * K, 0,
                  size_t(G - ng) * size_t(K) * 4);
      std::memset(sp_lenoff + (nb * G + ng) * K, 0,
                  size_t(G - ng) * size_t(K) * 2);
      b_segrow[nb] = int32_t(256 + sg * seg_rows);
      nb++;
    }
  }

  plan->n_batches = nb;
  plan->n_spans = n_spans;
  plan->err = OK;
  if (plan_timing()) {
    double tp4 = now_ms();
    std::fprintf(stderr,
                 "[plan_flat] expand=%.1fms redirect=%.1fms chop=%.1fms "
                 "schedule=%.1fms total=%.1fms spans=%lld batches=%lld\n",
                 tp1 - tp0, tp2 - tp1, tp3 - tp2, tp4 - tp3, tp4 - tp0,
                 (long long)n_spans, (long long)nb);
  }
  return OK;
}

// ---- near-optimal parse ---------------------------------------------------
// Cost-model shortest-path parse (the zopfli/libdeflate family of
// techniques, implemented from the idea): forward DP over byte positions
// where edge costs are the actual DEFLATE bit costs of literals and
// (length, distance) pairs, iterated against the entropy stats of the
// previous parse. Greedy/lazy matchers lose exactly where a locally
// longer match buys nothing because the continuation was nearly free
// (e.g. run boundaries: (32,d+16) vs (16,d) before a dist-1 run costs
// one avoidable extra bit) — the DP sees the continuation and picks the
// globally cheapest tokenization, which is how levels 4-9 stay <= libz
// on every corpus rather than on average.

namespace {

inline int len_symbol_of(int l) {
  static uint8_t tbl[259];
  static bool ready = false;
  if (!ready) {
    for (int s = 0; s < 29; s++) {
      int hi = (s == 28) ? 258 : kLenBase[s + 1] - 1;
      for (int v = kLenBase[s]; v <= hi && v <= 258; v++) tbl[v] = s;
    }
    tbl[258] = 28;
    ready = true;
  }
  return tbl[l];
}

inline int dist_symbol_of(int d) {
  int s = 29;
  while (kDistBase[s] > d) s--;
  return s;
}

// Package-merge optimal length-limited code lengths (same algorithm as
// ../huffman_encode.py, reimplemented for the in-loop cost refresh).
void package_merge(const uint64_t* freqs, int n, int limit, uint8_t* lens) {
  struct Item {
    uint64_t w;
    uint32_t leaves_lo, leaves_hi;  // bitmask of symbol indices (n<=288)
    uint64_t mask2, mask3, mask4, mask5;
  };
  // Simpler counting variant: track per-symbol depth increments.
  int syms[288];
  int m = 0;
  for (int i = 0; i < n; i++) {
    lens[i] = 0;
    if (freqs[i]) syms[m++] = i;
  }
  if (m == 0) return;
  if (m == 1) {
    lens[syms[0]] = 1;
    return;
  }
  // coin collector: lists of (weight, set-of-leaf-counts) — represent
  // each package as weight + vector of contained leaves via parallel
  // count array built level by level.
  // We implement the standard boundary package-merge with explicit
  // package trees (small n makes this cheap).
  struct Node {
    uint64_t w;
    int sym;        // leaf symbol or -1
    int left, right;  // package children into pool
  };
  static thread_local Node pool[1 << 18];
  int pool_n = 0;
  auto mk = [&](uint64_t w, int sym, int l, int r) {
    pool[pool_n] = {w, sym, l, r};
    return pool_n++;
  };
  // sort leaves by weight
  int order[288];
  for (int i = 0; i < m; i++) order[i] = syms[i];
  for (int i = 1; i < m; i++) {  // insertion sort (m<=288)
    int v = order[i];
    int j = i - 1;
    while (j >= 0 && freqs[order[j]] > freqs[v]) order[j + 1] = order[j], j--;
    order[j + 1] = v;
  }
  int prev[640], prev_n = 0, cur[640], cur_n;
  // level `limit` .. 1
  for (int i = 0; i < m; i++) prev[i] = mk(freqs[order[i]], order[i], -1, -1);
  prev_n = m;
  for (int level = 1; level < limit; level++) {
    cur_n = 0;
    // merge leaves with packages of prev level (pairs)
    int li = 0, pi = 0;
    int pairs = prev_n / 2;
    int pk[320], pk_n = 0;
    for (int k = 0; k + 1 < prev_n; k += 2)
      pk[pk_n++] = mk(pool[prev[k]].w + pool[prev[k + 1]].w, -1, prev[k],
                      prev[k + 1]);
    while (li < m || pi < pk_n) {
      bool take_leaf =
          pi >= pk_n ||
          (li < m && freqs[order[li]] <= pool[pk[pi]].w);
      if (take_leaf) {
        cur[cur_n++] = mk(freqs[order[li]], order[li], -1, -1);
        li++;
      } else {
        cur[cur_n++] = pk[pi++];
      }
    }
    prev_n = cur_n;
    for (int i = 0; i < cur_n; i++) prev[i] = cur[i];
  }
  // take first 2m-2 items; count leaf occurrences -> code lengths
  int take = 2 * m - 2;
  // iterative stack walk
  int stack[1 << 16];
  int sp = 0;
  for (int i = 0; i < take && i < prev_n; i++) stack[sp++] = prev[i];
  while (sp) {
    Node& nd = pool[stack[--sp]];
    if (nd.sym >= 0) {
      lens[nd.sym]++;
    } else {
      stack[sp++] = nd.left;
      stack[sp++] = nd.right;
    }
  }
}

}  // namespace
extern "C" {
// Host-callable package-merge (the encoder's per-block code builder;
// same construction as ../huffman_encode.py, whose vectorized form
// still costs ~0.3ms/call in numpy — 2-3 calls per block add up).
void tbz_package_merge(const uint64_t* freqs, int32_t n, int32_t limit,
                       uint8_t* lens) {
  package_merge(freqs, n, limit, lens);
}

// Cost-aware block split (same algorithm as ../deflate_encode.py
// _plan_blocks): unit histograms + greedy pairwise entropy merges.
// Writes block END token indices; returns block count, or -1 if it
// exceeds cap (caller falls back to the numpy planner).
int64_t tbz_plan_blocks(const int32_t* ol, const int32_t* di,
                        const int32_t* li, int64_t n, int32_t unit,
                        int64_t* ends_out, int64_t cap) {
  if (n <= 2 * int64_t(unit)) {
    if (cap < 1) return -1;
    ends_out[0] = n;
    return 1;
  }
  int64_t U = (n + unit - 1) / unit;
  struct Unit {
    uint32_t lf[288];
    uint32_t df[30];
    double ex;
    int64_t end;
  };
  Unit* us = new Unit[U];
  std::memset(us, 0, sizeof(Unit) * size_t(U));
  for (int64_t u = 0; u < U; u++)
    us[u].end = std::min<int64_t>((u + 1) * unit, n);
  for (int64_t i = 0; i < n; i++) {
    Unit& u = us[i / unit];
    if (di[i] == 0) {
      u.lf[li[i]]++;
    } else {
      int ls = len_symbol_of(ol[i]);
      int ds = dist_symbol_of(di[i]);
      u.lf[257 + ls]++;
      u.df[ds]++;
      u.ex += kLenExtra[ls] + kDistExtra[ds];
    }
  }
  auto ent = [](const uint32_t* f, int m) -> double {
    double tot = 0, xlx = 0;
    for (int i = 0; i < m; i++)
      if (f[i]) {
        double v = double(f[i]);
        tot += v;
        xlx += v * std::log2(v);
      }
    return tot > 0 ? tot * std::log2(tot) - xlx : 0.0;
  };
  auto nnz = [](const uint32_t* f, int m) -> int {
    int c = 0;
    for (int i = 0; i < m; i++) c += f[i] != 0;
    return c;
  };
  auto cost = [&](const Unit& u) -> double {
    return ent(u.lf, 288) + ent(u.df, 30) + u.ex + 3.0 +
           80.0 + 4.0 * (nnz(u.lf, 288) + nnz(u.df, 30));
  };
  auto merged_cost = [&](const Unit& a, const Unit& b) -> double {
    uint32_t lf[288], df[30];
    for (int i = 0; i < 288; i++) lf[i] = a.lf[i] + b.lf[i];
    for (int i = 0; i < 30; i++) df[i] = a.df[i] + b.df[i];
    return ent(lf, 288) + ent(df, 30) + (a.ex + b.ex) + 3.0 +
           80.0 + 4.0 * (nnz(lf, 288) + nnz(df, 30));
  };
  double* C = new double[U];
  double* MC = new double[U];
  for (int64_t u = 0; u < U; u++) C[u] = cost(us[u]);
  for (int64_t u = 0; u + 1 < U; u++) MC[u] = merged_cost(us[u], us[u + 1]);
  bool* dirty = new bool[U];
  int64_t m = U;
  for (;;) {
    // left-to-right sweep: merge pair (i, i+1) when the merged cost
    // doesn't exceed the sum (same rule/tie-break as the numpy form)
    int64_t w = 0;
    bool changed = false;
    for (int64_t i = 0; i < m;) {
      if (i + 1 < m && MC[i] <= C[i] + C[i + 1]) {
        // merge into slot w
        for (int k = 0; k < 288; k++) us[w].lf[k] = us[i].lf[k] + us[i + 1].lf[k];
        for (int k = 0; k < 30; k++) us[w].df[k] = us[i].df[k] + us[i + 1].df[k];
        us[w].ex = us[i].ex + us[i + 1].ex;
        us[w].end = us[i + 1].end;
        C[w] = MC[i];
        MC[w] = MC[i];  // carried; dirty recompute below overwrites
        dirty[w] = true;
        i += 2;
        changed = true;
      } else {
        if (w != i) {
          us[w] = us[i];
          C[w] = C[i];
          MC[w] = MC[i];  // clean pair (w,w+1) == old pair (i,i+1)
        }
        dirty[w] = false;
        i += 1;
      }
      w++;
    }
    m = w;
    if (!changed || m <= 1) break;
    // pair costs for the next pass: every pair whose either side was
    // rebuilt needs a fresh cost; clean pairs keep their value (their
    // contents are unchanged — same carrying rule as the numpy form)
    for (int64_t i = 0; i + 1 < m; i++)
      if (dirty[i] || dirty[i + 1]) MC[i] = merged_cost(us[i], us[i + 1]);
  }
  int64_t nb = m;
  if (nb > cap) nb = -1;
  if (nb > 0)
    for (int64_t i = 0; i < m; i++) ends_out[i] = us[i].end;
  delete[] us;
  delete[] C;
  delete[] MC;
  delete[] dirty;
  return nb;
}
}  // extern "C"
namespace {

struct CostModel {
  // costs in bits (scaled x8 for sub-bit stat smoothing not needed; use
  // integer bits from code lengths + extra bits)
  uint16_t lit[256];
  uint16_t len_cost[259];   // full cost incl. extra bits
  uint16_t dist_sym_cost[30];
  void from_lengths(const uint8_t* lit_lens, const uint8_t* dist_lens) {
    for (int i = 0; i < 256; i++) lit[i] = lit_lens[i] ? lit_lens[i] : 14;
    for (int l = 3; l <= 258; l++) {
      int s = len_symbol_of(l);
      int c = lit_lens[257 + s] ? lit_lens[257 + s] : 14;
      len_cost[l] = uint16_t(c + kLenExtra[s]);
    }
    for (int s = 0; s < 30; s++)
      dist_sym_cost[s] =
          uint16_t((dist_lens[s] ? dist_lens[s] : 14) + kDistExtra[s]);
  }
  void init_default() {
    // pre-stats estimate: fixed-tree-ish costs
    for (int i = 0; i < 256; i++) lit[i] = i < 144 ? 8 : 9;
    for (int l = 3; l <= 258; l++) {
      int s = len_symbol_of(l);
      len_cost[l] = uint16_t(8 + kLenExtra[s]);
    }
    for (int s = 0; s < 30; s++)
      dist_sym_cost[s] = uint16_t(5 + kDistExtra[s]);
  }
};

}  // namespace

extern "C" {

// Near-optimal parse. iters: cost-model refinement rounds (>=1);
// max_chain bounds the per-position candidate walk; nice_len stops the
// walk once a match that long is found (<=0: never). Returns token
// count or -1 on cap overflow. Memory is O(segment), not O(n): the DP
// runs over ~2MB segments with a forced token break at each boundary
// (the 32KB match window still crosses segments via wrapped chains).
//
// Speed structure (round 3): candidates come from a 4-byte hash chain
// (an order of magnitude less false-candidate pollution than the
// 3-byte chain on text) plus a single most-recent 3-byte probe for the
// len-3 edge; match improvements are kept as (len, dist) BREAKPOINTS
// so the relax loop computes dist_symbol_of once per breakpoint
// segment instead of per length (the old per-length lookup was ~30 ops
// x up to 255 lengths per position on matchy data).
// sparse: fast-tier relax — only short lengths (3..9) and each
// breakpoint's top length get DP edges, instead of every length up to
// `best` (the full relax is the measured cost on matchy data: up to
// 255 dp writes per position). Loses the occasional mid-length split;
// callers guard the result against libz and rerun dense on a miss.
int64_t tbz_match_optimal(const uint8_t* b, int64_t n, int32_t max_chain,
                          int32_t iters, int32_t nice_len, int32_t sparse,
                          int32_t* out_len, int32_t* dist,
                          int32_t* lit, int64_t cap) {
  constexpr int H3BITS = 15, H3SIZE = 1 << H3BITS;
  constexpr int H4BITS = 16, H4SIZE = 1 << H4BITS;
  constexpr int MIN_MATCH = 3, MAX_MATCH = 258, MAX_DIST = 32768;
  constexpr int WMASK = 0xFFFF;  // wrapped prev-chain (2x window)
  constexpr int64_t SEG = 2 << 20;
  constexpr int CACHE_BP = 8;    // longest-match cache breakpoints
  constexpr int MAX_BP = 48;     // in-walk breakpoint cap
  if (n == 0) return 0;
  if (n < MIN_MATCH) {
    if (n > cap) return -1;
    for (int64_t i = 0; i < n; i++) {
      out_len[i] = 1;
      dist[i] = 0;
      lit[i] = b[i];
    }
    return n;
  }
  const int nice = nice_len > 0 ? nice_len : MAX_MATCH;

  int32_t* head4 = new int32_t[H4SIZE];
  int32_t* head3 = new int32_t[H3SIZE];
  int64_t* prev = new int64_t[WMASK + 1];
  int64_t seg_cap = n < SEG ? n : SEG;
  // dp packed as (cost<<25 | len<<16 | dist): branchless int64 mins in
  // the relax loop auto-vectorize, and backtracking reads len/dist from
  // the winning entry — one array instead of three
  uint64_t* dp = new uint64_t[seg_cap + 1];
  // longest-match cache: cost-model iterations >= 1 reuse iteration 0's
  // chain walks (the measured bottleneck — cost scales ~linearly with
  // chain depth) via breakpoints; positions with more than CACHE_BP
  // breakpoints stay uncached (rare)
  uint16_t* c_bp = nullptr;
  uint8_t* c_n = nullptr;
  if (iters > 1) {
    c_bp = new uint16_t[size_t(seg_cap) * CACHE_BP * 2];
    c_n = new uint8_t[size_t(seg_cap)];
  }
  constexpr uint64_t DP_INF = ~uint64_t(0);
  auto dp_cost = [](uint64_t v) -> uint64_t { return v >> 25; };
  auto dp_len = [](uint64_t v) -> int { return int((v >> 16) & 0x1FF); };
  auto dp_dist = [](uint64_t v) -> int { return int(v & 0xFFFF); };

  auto hash3 = [&](int64_t i) -> uint32_t {
    return ((uint32_t(b[i]) << 10) ^ (uint32_t(b[i + 1]) << 5) ^ b[i + 2]) &
           (H3SIZE - 1);
  };
  auto hash4 = [&](int64_t i) -> uint32_t {
    uint32_t w;
    std::memcpy(&w, b + i, 4);
    return (w * 0x9E3779B1u) >> (32 - H4BITS);
  };
  // insert position i into the tables it qualifies for
  const int64_t last4 = n - 4;   // max i with 4 bytes available
  const int64_t last3 = n - 3;
  auto insert = [&](int64_t i) {
    if (i <= last4) {
      uint32_t h = hash4(i);
      prev[i & WMASK] = head4[h];
      head4[h] = int32_t(i & 0x7FFFFFFF);
    }
    if (i <= last3) head3[hash3(i)] = int32_t(i & 0x7FFFFFFF);
  };

  CostModel cm;
  cm.init_default();
  int64_t nt = 0;
  if (iters < 1) iters = 1;
  int32_t bl[MAX_BP];  // breakpoints: nearest dist bd[k] reaches bl[k]
  int32_t bd[MAX_BP];

  for (int64_t s = 0; s < n; s += SEG) {
    int64_t e = s + SEG < n ? s + SEG : n;
    int64_t m = e - s;
    int64_t seg_nt_base = nt;
    if (c_n) std::memset(c_n, 0xFF, size_t(m));
    for (int iter = 0; iter < iters; iter++) {
      // hash chains rebuilt per iteration, warmed with the 32KB window
      // before the segment so matches reach back across the boundary
      for (int i = 0; i < H4SIZE; i++) head4[i] = -1;
      for (int i = 0; i < H3SIZE; i++) head3[i] = -1;
      int64_t warm = s > MAX_DIST ? s - MAX_DIST : 0;
      for (int64_t i = warm; i < s; i++) insert(i);
      dp[0] = 0;
      for (int64_t i = 1; i <= m; i++) dp[i] = DP_INF;

      for (int64_t i = s; i < e; i++) {
        int64_t r = i - s;  // dp index
        uint64_t base = dp_cost(dp[r]);
        uint64_t lc = ((base + cm.lit[b[i]]) << 25) | (1u << 16);
        if (lc < dp[r + 1]) dp[r + 1] = lc;
        // match edges: breakpoints (bl[k], bd[k]) = nearest distance
        // reaching length bl[k], ascending
        if (i <= last3) {
          // cap match length at the segment boundary (forced token break)
          int max_len = int(e - i < MAX_MATCH ? e - i : MAX_MATCH);
          if (max_len >= MIN_MATCH) {
            int best = MIN_MATCH - 1;
            int nbp = 0;
            if (c_n && iter > 0 && c_n[r] != 0xFF) {
              // cache hit: load breakpoints, skip the walk
              const uint16_t* bp = c_bp + size_t(r) * CACHE_BP * 2;
              nbp = c_n[r];
              for (int k = 0; k < nbp; k++) {
                bl[k] = bp[k * 2];
                bd[k] = bp[k * 2 + 1];
              }
              if (nbp) best = bl[nbp - 1];
            } else {
              bool bp_over = false;
              // len-3 edge: most recent 3-byte position (single probe)
              {
                int64_t c3 = head3[hash3(i)];
                if (c3 >= 0 && i - c3 <= MAX_DIST && c3 != i &&
                    b[c3] == b[i] && b[c3 + 1] == b[i + 1] &&
                    b[c3 + 2] == b[i + 2]) {
                  bl[0] = 3;
                  bd[0] = int32_t(i - c3);
                  nbp = 1;
                  best = 3;
                }
              }
              if (i <= last4 && best < max_len) {
                int64_t cand = head4[hash4(i)];
                int chain = max_chain;
                // libz-style: once a good match is in hand, spend less
                // effort improving it. Speed-tier only (nice < 258):
                // the quality tier keeps the full walk — cutting it
                // regressed the runs corpus at L8 (the far whole-unit
                // candidate sits beyond the cut).
                const int good = nice < MAX_MATCH ? nice >> 2 : MAX_MATCH;
                while (cand >= 0 && i - cand <= MAX_DIST && chain-- > 0) {
                  // load the next candidate before the compare work:
                  // the walk is a pointer chase, and the early load +
                  // prefetch overlaps the chase with the extension
                  // (~4% on the 4MB mix at L6 depth)
                  int64_t nxt = prev[cand & WMASK];
                  __builtin_prefetch(b + nxt, 0, 1);
                  if (b[cand + best] == b[i + best] && b[cand] == b[i]) {
                    // word-wise extension (8B per step, ctz on mismatch)
                    int l = 0;
                    while (l + 8 <= max_len) {
                      uint64_t wa, wb;
                      std::memcpy(&wa, b + cand + l, 8);
                      std::memcpy(&wb, b + i + l, 8);
                      uint64_t x = wa ^ wb;
                      if (x) {
                        l += __builtin_ctzll(x) >> 3;
                        break;
                      }
                      l += 8;
                    }
                    if (l + 8 > max_len)
                      while (l < max_len && b[cand + l] == b[i + l]) l++;
                    if (l > best && l >= 4) {
                      int32_t d = int32_t(i - cand);
                      // merge: equal-dist extension replaces the last bp
                      if (nbp && bd[nbp - 1] == d &&
                          bl[nbp - 1] >= best) {
                        bl[nbp - 1] = l;
                      } else if (nbp < MAX_BP) {
                        bl[nbp] = l;
                        bd[nbp] = d;
                        nbp++;
                      } else {
                        bp_over = true;
                      }
                      best = l;
                      if (l >= max_len || l >= nice) break;
                      if (l >= good && chain > 8) chain = 8;
                    }
                  }
                  cand = nxt;
                }
              }
              if (c_n && iter == 0) {
                if (bp_over || nbp > CACHE_BP) {
                  c_n[r] = 0xFF;
                } else {
                  uint16_t* bp = c_bp + size_t(r) * CACHE_BP * 2;
                  for (int k = 0; k < nbp; k++) {
                    bp[k * 2] = uint16_t(bl[k]);
                    bp[k * 2 + 1] = uint16_t(bd[k]);
                  }
                  c_n[r] = uint8_t(nbp);
                }
              }
            }
            if (best >= MIN_MATCH) {
              if (sparse) {
                // short lengths (the common split points) ...
                int k = 0;
                int short_hi = best < 9 ? best : 9;
                for (int l = MIN_MATCH; l <= short_hi; l++) {
                  while (k < nbp && bl[k] < l) k++;
                  if (k >= nbp) break;
                  uint64_t dc =
                      base + cm.dist_sym_cost[dist_symbol_of(bd[k])];
                  uint64_t c = ((dc + cm.len_cost[l]) << 25) |
                               (uint64_t(l) << 16) | uint64_t(bd[k]);
                  uint64_t cur = dp[r + l];
                  dp[r + l] = c < cur ? c : cur;
                }
                // ... plus each breakpoint's top length
                for (int k2 = 0; k2 < nbp; k2++) {
                  int l = bl[k2];
                  uint64_t dc =
                      base + cm.dist_sym_cost[dist_symbol_of(bd[k2])];
                  uint64_t c = ((dc + cm.len_cost[l]) << 25) |
                               (uint64_t(l) << 16) | uint64_t(bd[k2]);
                  uint64_t cur = dp[r + l];
                  dp[r + l] = c < cur ? c : cur;
                }
              } else {
              // relax per breakpoint segment: dist symbol computed once
              int prev_l = MIN_MATCH - 1;
              for (int k = 0; k < nbp; k++) {
                int hi = bl[k];
                uint64_t dc =
                    base + cm.dist_sym_cost[dist_symbol_of(bd[k])];
                uint64_t dv = uint64_t(bd[k]);
                for (int l = prev_l + 1; l <= hi; l++) {
                  uint64_t c = ((dc + cm.len_cost[l]) << 25) |
                               (uint64_t(l) << 16) | dv;
                  uint64_t cur = dp[r + l];
                  dp[r + l] = c < cur ? c : cur;
                }
                prev_l = hi;
              }
              }
              // long-run shortcut: inside a small-period run (e.g. a
              // byte or short-pattern repeat) the DP neighborhood
              // repeats; advance relaxing only the max-length + literal
              // edges (hash still maintained). Restricted to d0<=8:
              // with a large period the shortcut would lock out cheaper
              // near distances and starve the DP of good edges.
              if (best == MAX_MATCH && max_len == MAX_MATCH &&
                  bd[nbp - 1] <= 8) {
                int32_t d0 = bd[nbp - 1];
                insert(i);
                int64_t j = i + 1;
                uint32_t mc = cm.len_cost[MAX_MATCH] +
                              cm.dist_sym_cost[dist_symbol_of(d0)];
                while (j + MAX_MATCH <= e &&
                       b[j + MAX_MATCH - 1] == b[j + MAX_MATCH - 1 - d0]) {
                  int64_t rj = j - s;
                  uint64_t bj = dp_cost(dp[rj]);
                  uint64_t c2 = ((bj + mc) << 25) |
                                (uint64_t(MAX_MATCH) << 16) | uint64_t(d0);
                  if (c2 < dp[rj + MAX_MATCH]) dp[rj + MAX_MATCH] = c2;
                  uint64_t lc2 = ((bj + cm.lit[b[j]]) << 25) | (1u << 16);
                  if (lc2 < dp[rj + 1]) dp[rj + 1] = lc2;
                  insert(j);
                  j++;
                }
                if (j > i + 1) {
                  i = j - 1;
                  continue;
                }
                continue;  // hash already inserted
              }
              // (A nice-SKIP — jumping i past a >=nice match wholesale —
              // was tried and regressed runs corpora 23% at L8/9: the
              // skipped interior positions carry the cheap d=1 run
              // edges the DP needs, and losing them shifts the parse at
              // every unit boundary, fragmenting the symbol stats. Only
              // the walk CUTOFF at `nice` and the good-length chain
              // reduction are safe.)
            }
          }
        }
        insert(i);
      }

      // backtrack this segment (reversed, then reverse in place)
      nt = seg_nt_base;
      int64_t pos = m;
      bool overflow = false;
      while (pos > 0) {
        if (nt >= cap) {
          overflow = true;
          break;
        }
        int l = dp_len(dp[pos]);
        if (l == 1) {
          out_len[nt] = 1;
          dist[nt] = 0;
          lit[nt] = b[s + pos - 1];
          pos -= 1;
        } else {
          out_len[nt] = l;
          dist[nt] = dp_dist(dp[pos]);
          lit[nt] = 0;
          pos -= l;
        }
        nt++;
      }
      if (overflow) {
        delete[] head4;
        delete[] head3;
        delete[] prev;
        delete[] dp;
        delete[] c_bp;
        delete[] c_n;
        return -1;
      }
      for (int64_t a = seg_nt_base, z = nt - 1; a < z; a++, z--) {
        std::swap(out_len[a], out_len[z]);
        std::swap(dist[a], dist[z]);
        std::swap(lit[a], lit[z]);
      }
      if (iter + 1 >= iters) break;
      // refresh cost model from this segment's entropy-optimal codes
      uint64_t lit_freqs[288] = {0};
      uint64_t dist_freqs[30] = {0};
      for (int64_t t = seg_nt_base; t < nt; t++) {
        if (dist[t] == 0) {
          lit_freqs[lit[t]]++;
        } else {
          lit_freqs[257 + len_symbol_of(out_len[t])]++;
          dist_freqs[dist_symbol_of(dist[t])]++;
        }
      }
      lit_freqs[256]++;
      uint8_t lit_lens[288], dist_lens[30];
      package_merge(lit_freqs, 288, 15, lit_lens);
      package_merge(dist_freqs, 30, 15, dist_lens);
      cm.from_lengths(lit_lens, dist_lens);
    }
  }

  delete[] head4;
  delete[] head3;
  delete[] prev;
  delete[] dp;
  delete[] c_bp;
  delete[] c_n;
  return nt;
}

}  // extern "C"
