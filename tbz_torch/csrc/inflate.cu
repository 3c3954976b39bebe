// The sequential device tokenizer: one DEFLATE stream -> a token tape.
//
// Replaces tbz/ops/tokenize_device.py:191 tokenize_device_impl, a
// lax.while_loop whose body is a lax.switch over ten modes (block header,
// stored run, one litlen symbol (+ match), dynamic-header sizes, code-
// length-code lengths, their table, the code lengths, the litlen/dist
// tables, done, error), one symbol a step.
//
// Bound: latency. The decode is a dependent bit-serial chain (the next
// bit position needs this symbol's table entry), so one thread walks it;
// the bytes moved (the stream read, 12 B a token written) would take
// microseconds at the HBM rate. The design shortens each link of the
// chain:
// - thread 0 keeps the machine (bit position, mode, token count, output
//   count, error, stored length, header counters) in registers; only the
//   code lengths and the lengths of a requested table build live in shared
//   memory, where the block builds the table;
// - the stream is read through a 64-bit bit buffer in registers, shifted
//   on consume and refilled a word at a time from a ring of NBUF chunks of
//   CHUNK_WORDS words in shared memory. Thread 0 itself keeps the ring
//   NBUF - 1 chunks ahead with cp.async copies (one commit group a chunk),
//   so a refill is a shared load and the global reads are off the chain.
//   A stored block's jump past the ring drains it and refills it at the
//   target; every size takes this one path;
// - both Huffman tables are in shared memory: the flat 2^15-entry litlen
//   table (128 KB, packed entries) and a flat 2^15-entry distance table of
//   16-bit entries (64 KB: symbol 0:5 | code length 5:9), whose base and
//   extra bits are computed from the symbol (RFC 1951 3.2.5). So a literal
//   costs one shared load and a match two, plus register arithmetic;
// - the hot loop runs while no token can pass the end of the stream (a
//   token takes at most 48 bits) or of the tape, so it carries no
//   truncation or overflow checks; the tokens near either end take the
//   full step, every check in tbz's order.
// Every table build is block-wide (flat_table.cuh): thread 0 runs the
// machine until it needs a table and publishes the lengths in shared
// memory; all threads build; thread 0 goes on. Every thread reaches every
// __syncthreads: the loop is `thread 0 runs; sync; all build; sync`. The
// static tables are built once and kept while no other table replaced
// them.
//
// Semantics are tbz's, check by check and in tbz's order (parity is held
// by the plain version in tbz_torch/ops/tokenize_device.py and its tests):
// an emit on a full tape sets ERR_TAPE_OVERFLOW without storing; a match
// is stored before its truncation / invalid-distance / too-far checks;
// truncation beats an invalid code; the code-length table does not take
// zlib's single-1-bit exception. Bits are read as tbz reads them: words
// past the buffer as 0. Bit positions are int32, as in tbz (the wrapper
// takes < 256 MB).
#include <cuda_pipeline_primitives.h>

#include "flat_table.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int MAX_LENS = 320;
constexpr int NBUF = 4;                   // ring slots (a power of two)
constexpr int CHUNK_SHIFT = 10;           // 1024 words = 4 KB a chunk
constexpr int CHUNK_WORDS = 1 << CHUNK_SHIFT;
constexpr uint16_t DIST_INVALID = 31 | (15 << 5);  // an uncovered slot
constexpr int SMEM_BYTES = tbz::TSIZE * 4 + tbz::TSIZE * 2 +
                           NBUF * CHUNK_WORDS * 4;

enum Mode {
  M_BLOCK = 0, M_STORED, M_DATA, M_DHT_SIZES, M_DHT_CLLEN, M_DHT_BUILD_CL,
  M_DHT_LENS, M_DHT_BUILD, M_DONE, M_ERR
};
enum Need { NEED_NONE = 0, NEED_STATIC, NEED_CL, NEED_DYN };
enum Err {
  OK = 0, ERR_BAD_BLOCK_TYPE = 1, ERR_STORED_LEN_MISMATCH = 2,
  ERR_TRUNCATED = 3, ERR_INVALID_CODE = 5, ERR_BAD_DISTANCE = 6,
  ERR_BAD_CL_REPEAT = 7, ERR_TOO_MANY_SYMBOLS = 8, ERR_TAPE_OVERFLOW = 11
};

__constant__ int kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                 11, 4, 12, 3, 13, 2, 14, 1, 15};

// What the block shares: the code lengths and a requested build.
struct Shared {
  int lens[MAX_LENS];
  int tl[288];              // the lengths of the requested build
  int td[32];
  int need;                 // the table build thread 0 waits for
  int e1, e2;               // its error codes (litlen or CL, dist)
};

// Thread 0's machine state (registers).
struct Regs {
  int bit_pos, mode, bfinal, produced, n_tok, err, finished;
  int hlit, hdist, hclen, cl_i, lens_i, stored_len;
  bool static_tables;       // the tables in place are the static ones
};

struct Stream {
  const uint32_t* data;
  int64_t nwords;
  int total_bits, window_len;
  int64_t T;
  int32_t *ol, *di, *rv;
};

// Thread 0's view of the stream: the ring of chunks in shared memory and
// the 64-bit bit buffer. Invariant: buf holds the nb >= 0 bits at
// [pos, pos + nb) and pos + nb == 32 * next.
struct Bits {
  const uint32_t* data;
  int64_t nwords, nchunks;
  uint32_t* ring;
  int64_t cur;      // the chunk the last word read lies in
  int64_t next;     // the next word to pull into buf
  uint64_t buf;
  int nb;

  __device__ __forceinline__ void issue(int64_t c) {
    if (c < nchunks) {
      uint32_t* dst = ring + (c & (NBUF - 1)) * CHUNK_WORDS;
      const int64_t w0 = c << CHUNK_SHIFT;
      const int64_t n = nwords - w0 < CHUNK_WORDS ? nwords - w0 : CHUNK_WORDS;
      int i = 0;
      for (; i + 4 <= n; i += 4)
        __pipeline_memcpy_async(dst + i, data + w0 + i, 16);
      for (; i < n; ++i) __pipeline_memcpy_async(dst + i, data + w0 + i, 4);
    }
    __pipeline_commit();  // an empty group past the end keeps the count
  }

  // restart the ring at chunk c (the first call, and a jump past it)
  __device__ __forceinline__ void restart(int64_t c) {
    __pipeline_wait_prior(0);
    for (int k = 0; k < NBUF; ++k) issue(c + k);
    __pipeline_wait_prior(NBUF - 1);
    cur = c;
  }

  __device__ __forceinline__ uint32_t word(int64_t wi) {
    if (wi >= nwords) return 0u;
    const int64_t c = wi >> CHUNK_SHIFT;
    if (c != cur) {
      if (c == cur + 1) {
        // chunk c's group is the oldest of the NBUF - 1 in flight; its
        // slot's predecessor (chunk cur) is done with, so refill it
        __pipeline_wait_prior(NBUF - 2);
        issue(c + NBUF - 1);
        cur = c;
      } else {
        restart(c);
      }
    }
    return ring[(c & (NBUF - 1)) * CHUNK_WORDS + (wi & (CHUNK_WORDS - 1))];
  }

  // at least 32 bits in buf
  __device__ __forceinline__ void refill() {
    if (nb < 32) {
      buf |= (uint64_t)word(next++) << nb;
      nb += 32;
    }
  }

  // move the bit position from p0 forward to p (p >= p0)
  __device__ __forceinline__ void seek(int p0, int p) {
    const int k = p - p0;
    if (k < nb) {
      buf >>= k;
      nb -= k;
    } else {
      const int64_t wi = p >> 5;
      const uint64_t w = (uint64_t)word(wi) | ((uint64_t)word(wi + 1) << 32);
      buf = w >> (p & 31);
      nb = 64 - (p & 31);
      next = wi + 2;
    }
  }
};

__device__ __forceinline__ void emit(Regs& R, const Stream& s, int len,
                                     int d, int r) {
  if (R.n_tok >= s.T) {
    R.err = ERR_TAPE_OVERFLOW;
    return;
  }
  s.ol[R.n_tok] = len;
  s.di[R.n_tok] = d;
  s.rv[R.n_tok] = r;
  R.n_tok++;
  R.produced += len;
}

__device__ __forceinline__ void set_err(Regs& R, int code) {
  R.mode = M_ERR;
  R.err = code;
}

// consume k bits (k <= B.nb)
__device__ __forceinline__ void eat(Regs& R, Bits& B, int k) {
  B.buf >>= k;
  B.nb -= k;
  R.bit_pos += k;
}

__device__ __forceinline__ int low(uint64_t v, int n) {
  return (int)(v & ((1u << n) - 1u));
}

// A match whose litlen entry is e, at the bit position (its code not yet
// consumed; B.nb >= 32): consumes the code, the length's extra bits, the
// distance code and its extra bits. Sets len and d (d = 0 for an invalid
// distance code, whose entry has no base and no extra bits) and returns
// whether the distance code is valid.
__device__ __forceinline__ bool match(Regs& R, Bits& B, uint32_t e,
                                      const uint16_t* dtab, int& len,
                                      int& d) {
  const int nb = tbz::e_nbits(e), ex = tbz::e_extra(e);
  len = tbz::e_val(e) + low(B.buf >> nb, ex < 13 ? ex : 13);
  eat(R, B, nb + ex);
  B.refill();
  const int de = dtab[(uint32_t)B.buf & (tbz::TSIZE - 1)];
  const int dsym = de & 31, dnb = (de >> 5) & 15;
  const bool dvalid = dsym < 30;
  const int dex = dvalid && dsym >= 4 ? (dsym >> 1) - 1 : 0;
  const int dbase = !dvalid ? 0
                    : dsym < 4 ? dsym + 1 : ((2 | (dsym & 1)) << dex) + 1;
  d = dbase + low(B.buf >> dnb, dex);
  eat(R, B, dnb + dex);
  return dvalid;
}

// Thread 0: run the machine until it stops or needs a table (sh.need).
__device__ __forceinline__ void run(Regs& R, Bits& B, const Stream& s,
                                    Shared& sh, const uint32_t* stab,
                                    const uint16_t* dtab) {
  const int total_bits = s.total_bits;
  while (R.mode != M_DONE && R.mode != M_ERR && R.err == OK) {
    if (R.mode == M_DATA) {
      // the hot loop, in stretches of `budget` tokens that can neither run
      // past the end of the stream (a token takes at most 15 + 5 + 15 + 13
      // = 48 bits) nor fill the tape: no truncation or overflow checks; an
      // end-of-block, an invalid code and the distance checks leave it. At
      // the top of each step buf holds >= 32 bits and e is the entry there;
      // a literal looks its successor up before its own stores (>= 17 bits
      // are left), so the stores and the refill overlap that load.
      for (bool go = true; go;) {
        if (R.bit_pos > total_bits - 48 || R.n_tok >= s.T) break;
        int budget = (total_bits - 48 - R.bit_pos) / 48 + 1;
        if (s.T - R.n_tok < budget) budget = (int)(s.T - R.n_tok);
        B.refill();
        uint32_t e = stab[(uint32_t)B.buf & (tbz::TSIZE - 1)];
        for (; budget > 0; --budget) {
          const int op = tbz::e_op(e);
          if (op == tbz::OP_LITERAL) {
            eat(R, B, tbz::e_nbits(e));
            const uint32_t next = stab[(uint32_t)B.buf & (tbz::TSIZE - 1)];
            s.ol[R.n_tok] = 1;
            s.di[R.n_tok] = 0;
            s.rv[R.n_tok] = tbz::e_val(e);
            R.n_tok++;
            R.produced++;
            B.refill();
            e = next;
            continue;
          }
          if (op != tbz::OP_MATCH) {  // the full step below takes it
            go = false;
            break;
          }
          int len, d;
          const bool dvalid = match(R, B, e, dtab, len, d);
          const bool toofar = d > R.produced + s.window_len;
          emit(R, s, len, d, 0);
          if (!dvalid) set_err(R, ERR_INVALID_CODE);
          else if (toofar) set_err(R, ERR_BAD_DISTANCE);
          if (R.err != OK) {
            go = false;
            break;
          }
          B.refill();
          e = stab[(uint32_t)B.buf & (tbz::TSIZE - 1)];
        }
      }
      if (R.mode != M_DATA || R.err != OK) continue;
      // one full step, every check in tbz's order
      B.refill();
      const uint32_t e = stab[(uint32_t)B.buf & (tbz::TSIZE - 1)];
      const int nb = tbz::e_nbits(e), op = tbz::e_op(e);
      const bool ok = R.bit_pos + nb <= total_bits;
      if (op == tbz::OP_LITERAL) {
        emit(R, s, 1, 0, tbz::e_val(e));
        eat(R, B, nb);
      } else if (op == tbz::OP_MATCH) {
        int len, d;
        const bool dvalid = match(R, B, e, dtab, len, d);
        const bool toofar = d > R.produced + s.window_len;
        emit(R, s, len, d, 0);
        if (R.bit_pos > total_bits) set_err(R, ERR_TRUNCATED);
        else if (!dvalid) set_err(R, ERR_INVALID_CODE);
        else if (toofar) set_err(R, ERR_BAD_DISTANCE);
      } else if (op == tbz::OP_END) {
        eat(R, B, nb);
        R.mode = R.bfinal ? M_DONE : M_BLOCK;
        if (R.bfinal) R.finished = 1;
      } else {
        set_err(R, ERR_INVALID_CODE);
      }
      if (!ok) set_err(R, ERR_TRUNCATED);  // truncation beats invalid
      continue;
    }
    B.refill();
    switch (R.mode) {
      case M_BLOCK: {
        const bool ok = R.bit_pos + 3 <= total_bits;
        const int hdr = low(B.buf, 3);
        if (!ok) {  // a missing header wins over everything
          set_err(R, ERR_TRUNCATED);
          break;
        }
        R.bfinal = hdr & 1;
        const int btype = hdr >> 1;
        if (btype == 0) {
          const int pos = (R.bit_pos + 3 + 7) & ~7;
          B.seek(R.bit_pos, pos);
          R.bit_pos = pos;
          B.refill();
          const bool ok2 = pos + 32 <= total_bits;
          const int ln = low(B.buf, 16), nlen = low(B.buf >> 16, 16);
          const bool good = ln == (~nlen & 0xFFFF);
          const bool have = pos + 32 + ln * 8 <= total_bits;
          eat(R, B, 32);
          R.stored_len = ln;
          if (!ok2) set_err(R, ERR_TRUNCATED);
          else if (!good) set_err(R, ERR_STORED_LEN_MISMATCH);
          else if (!have) set_err(R, ERR_TRUNCATED);
          else R.mode = M_STORED;
        } else if (btype == 1) {
          if (R.static_tables) {
            eat(R, B, 3);
            R.mode = M_DATA;
            break;
          }
          for (int k = 0; k < 288; ++k)
            sh.tl[k] = k < 144 ? 8 : k < 256 ? 9 : k < 280 ? 7 : 8;
          for (int k = 0; k < 32; ++k) sh.td[k] = 5;
          sh.need = NEED_STATIC;  // then bit_pos += 3, M_DATA
          return;
        } else if (btype == 2) {
          eat(R, B, 3);
          R.mode = M_DHT_SIZES;
        } else {
          set_err(R, ERR_BAD_BLOCK_TYPE);
        }
        break;
      }
      case M_STORED: {
        if (R.stored_len > 0)
          emit(R, s, R.stored_len, 0, tbz::STORED_FLAG | (R.bit_pos >> 3));
        const int p = R.bit_pos + R.stored_len * 8;
        B.seek(R.bit_pos, p);
        R.bit_pos = p;
        R.mode = R.bfinal ? M_DONE : M_BLOCK;
        if (R.bfinal) R.finished = 1;
        break;
      }
      case M_DHT_SIZES: {
        const bool ok = R.bit_pos + 14 <= total_bits;
        const int v = low(B.buf, 14);
        R.hlit = (v & 31) + 257;
        R.hdist = ((v >> 5) & 31) + 1;
        R.hclen = ((v >> 10) & 15) + 4;
        if (ok) eat(R, B, 14);
        R.cl_i = 0;
        R.lens_i = 0;
        for (int k = 0; k < MAX_LENS; ++k) sh.lens[k] = 0;
        if (!ok) set_err(R, ERR_TRUNCATED);
        else if (R.hlit > 286 || R.hdist > 30)
          set_err(R, ERR_TOO_MANY_SYMBOLS);
        else R.mode = M_DHT_CLLEN;
        break;
      }
      case M_DHT_CLLEN: {
        const bool ok = R.bit_pos + 3 <= total_bits;
        const int v = low(B.buf, 3);
        sh.lens[300 + kClOrder[R.cl_i < 18 ? R.cl_i : 18]] = ok ? v : 0;
        if (ok) eat(R, B, 3);
        R.cl_i++;
        if (!ok) set_err(R, ERR_TRUNCATED);
        else R.mode = R.cl_i >= R.hclen ? M_DHT_BUILD_CL : M_DHT_CLLEN;
        break;
      }
      case M_DHT_BUILD_CL: {
        for (int k = 0; k < 19; ++k) sh.tl[k] = sh.lens[300 + k];
        sh.need = NEED_CL;
        return;
      }
      case M_DHT_LENS: {
        const uint32_t e = stab[B.buf & (tbz::TSIZE - 1)];
        const int nb = tbz::e_nbits(e);
        const bool ok = R.bit_pos + nb <= total_bits;
        const int sym = tbz::e_val(e);
        const bool invalid = tbz::e_op(e) == tbz::OP_INVALID;
        const int total = R.hlit + R.hdist;
        const int i = R.lens_i;
        const int rep_bits = sym == 16 ? 2 : sym == 17 ? 3 : 7;
        const int rb = low(B.buf >> nb, 7) & ((1 << rep_bits) - 1);
        const int rep = (sym == 16 || sym == 17) ? 3 + rb : 11 + rb;
        const int rep_val = sym == 16 ? sh.lens[i > 0 ? i - 1 : 0] : 0;
        const bool no_prev = sym == 16 && i == 0;
        const bool use_rep = sym >= 16;
        const bool overrun = use_rep && i + rep > total;
        const int consumed = nb + (use_rep ? rep_bits : 0);
        const bool ok2 = R.bit_pos + consumed <= total_bits;
        if (ok && ok2 && !invalid && !no_prev && !overrun) {
          if (use_rep) {
            for (int k = i; k < i + rep && k < MAX_LENS; ++k)
              sh.lens[k] = rep_val;
          } else {
            sh.lens[i < MAX_LENS - 1 ? i : MAX_LENS - 1] = sym;
          }
          R.lens_i = i + (use_rep ? rep : 1);
          eat(R, B, consumed);
        }
        const bool bad_lit_overflow = sym < 16 && i >= total;
        if (!(ok && ok2)) set_err(R, ERR_TRUNCATED);
        else if (invalid) set_err(R, ERR_INVALID_CODE);
        else if (no_prev || overrun || bad_lit_overflow)
          set_err(R, ERR_BAD_CL_REPEAT);
        else if (R.lens_i >= total) R.mode = M_DHT_BUILD;
        break;
      }
      case M_DHT_BUILD: {
        for (int k = 0; k < 288; ++k)
          sh.tl[k] = k < R.hlit ? sh.lens[k] : 0;
        for (int k = 0; k < 32; ++k) {
          const int j = k + R.hlit;
          sh.td[k] = k < R.hdist ? sh.lens[j < MAX_LENS ? j : MAX_LENS - 1]
                                 : 0;
        }
        sh.need = NEED_DYN;
        return;
      }
      default:
        return;
    }
  }
}

// Thread 0: the rest of the mode that asked for a table.
__device__ __forceinline__ void finish_build(Regs& R, Bits& B, Shared& sh) {
  if (sh.need == NEED_STATIC) {
    eat(R, B, 3);
    R.mode = M_DATA;
    R.static_tables = true;
  } else if (sh.need == NEED_CL) {
    if (sh.e1 != OK) set_err(R, sh.e1);
    else R.mode = M_DHT_LENS;
    for (int k = 300; k < MAX_LENS; ++k) sh.lens[k] = 0;
    R.static_tables = false;
  } else {
    // a missing end-of-block code first, then litlen, then dist
    const int e = sh.lens[256] == 0 ? tbz::ERR_BAD_HUFFMAN
                                    : (sh.e1 != OK ? sh.e1 : sh.e2);
    if (e != OK) set_err(R, e);
    else R.mode = M_DATA;
    R.static_tables = false;
  }
  sh.need = NEED_NONE;
}

__global__ void __launch_bounds__(THREADS)
inflate(Stream s, const uint32_t* __restrict__ consts, int32_t* res) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* stab = reinterpret_cast<uint32_t*>(smem);  // litlen or CL
  uint16_t* dtab = reinterpret_cast<uint16_t*>(smem + tbz::TSIZE * 4);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + tbz::TSIZE * 6);
  __shared__ Shared sh;
  __shared__ tbz::FlatTableScratch sc;
  Regs R;   // thread 0's
  Bits B;
  if (threadIdx.x == 0) {
    R.bit_pos = R.mode = R.bfinal = R.produced = R.n_tok = 0;
    R.err = OK;
    R.finished = R.hlit = R.hdist = R.hclen = R.cl_i = R.lens_i = 0;
    R.stored_len = 0;
    R.static_tables = false;
    sh.need = NEED_NONE;
    sh.e1 = sh.e2 = 0;
    for (int k = 0; k < MAX_LENS; ++k) sh.lens[k] = 0;
    B.data = s.data;
    B.nwords = s.nwords;
    B.nchunks = (s.nwords + CHUNK_WORDS - 1) >> CHUNK_SHIFT;
    B.ring = ring;
    B.cur = -2;
    B.restart(0);
    B.nb = 0;
    B.next = 0;
    B.buf = 0;
    B.seek(0, 0);
  }
  __syncthreads();
  for (;;) {
    if (threadIdx.x == 0) run(R, B, s, sh, stab, dtab);
    __syncthreads();
    const int need = sh.need;  // the same value in every thread
    if (need == NEED_NONE) break;
    if (need == NEED_CL) {
      tbz::build_flat_table_block(sh.tl, 19, consts + 320, false, stab, sc);
      if (threadIdx.x == 0) sh.e1 = sc.err;
    } else {
      tbz::build_flat_table_block(sh.tl, 288, consts, true, stab, sc);
      if (threadIdx.x == 0) sh.e1 = sc.err;
      tbz::build_flat_table_block_t<uint16_t>(
          sh.td, 32, [](int i, int l) { return i | (l << 5); },
          DIST_INVALID, true, dtab, sc);
      if (threadIdx.x == 0) sh.e2 = sc.err;
    }
    if (threadIdx.x == 0) finish_build(R, B, sh);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    __pipeline_wait_prior(0);
    res[0] = R.n_tok;
    res[1] = R.produced;
    res[2] = R.bit_pos;
    res[3] = R.err;
    res[4] = R.finished;
  }
}

}  // namespace

TBZ_API int tbz_inflate(const uint32_t* data, int64_t nwords, int total_bits,
                        int window_len, const uint32_t* consts, int64_t T,
                        int32_t* out_len, int32_t* dist, int32_t* root_val,
                        int32_t* res, cudaStream_t st) {
  if (((uintptr_t)data & 15) != 0) return (int)cudaErrorInvalidValue;
  // the shared-memory opt-in, once a device
  static uint64_t opted = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && !((__atomic_load_n(&opted, __ATOMIC_ACQUIRE) >> dev) & 1)) {
    e = cudaFuncSetAttribute(inflate,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    __atomic_fetch_or(&opted, 1ull << dev, __ATOMIC_ACQ_REL);
  }
  Stream s{data, nwords, total_bits, window_len, T, out_len, dist, root_val};
  inflate<<<1, THREADS, SMEM_BYTES, st>>>(s, consts, res);
  return (int)cudaGetLastError();
}
