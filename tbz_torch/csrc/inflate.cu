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
// microseconds at the HBM rate. Design: one block a call. Thread 0 runs
// the machine until it needs a table, publishes the lengths in shared
// memory, and the whole block builds the table with flat_table.cuh's
// builder; then thread 0 goes on. The litlen table (and, while a dynamic
// header is read, the code-length table, which is never needed at the
// same time) is built into 128 KB of dynamic shared memory, so the lookup
// of every symbol is a shared-memory load; the distance table goes to
// global scratch (2^15 words, an L2 hit). Every thread reaches every
// __syncthreads: the loop is `thread 0 runs; sync; all build; sync`.
//
// Semantics are tbz's, check by check and in tbz's order (parity is held
// by the plain version in tbz_torch/ops/tokenize_device.py and its tests):
// an emit on a full tape sets ERR_TAPE_OVERFLOW without storing; a match
// is stored before its truncation / invalid-distance / too-far checks;
// the code-length table does not take zlib's single-1-bit exception.
// Bit positions are int32, as in tbz (the wrapper takes < 256 MB).
#include "flat_table.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LENS = 320;

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

struct Machine {
  int bit_pos, mode, bfinal, produced, n_tok, err, finished;
  int hlit, hdist, hclen, cl_i, lens_i, stored_len;
  int need;                 // the table build thread 0 waits for
  int e1, e2;               // its error codes (litlen or CL, dist)
  int lens[MAX_LENS];
  int tl[288];              // the lengths of the requested build
  int td[32];
};

struct Stream {
  const uint32_t* data;
  int64_t nwords;
  int total_bits, window_len;
  int64_t T;
  int32_t *ol, *di, *rv;
};

// up to 16 bits LSB-first at bit p; words past the buffer read as 0 (the
// zero slack words, as tbz's clamped gather reads them)
__device__ __forceinline__ int peek(const Stream& s, int p, int n) {
  const int64_t wi = p >> 5;
  const uint64_t w0 = wi < s.nwords ? __ldg(s.data + wi) : 0u;
  const uint64_t w1 = wi + 1 < s.nwords ? __ldg(s.data + wi + 1) : 0u;
  return (int)(((w0 | (w1 << 32)) >> (p & 31)) & ((1u << n) - 1u));
}

__device__ __forceinline__ void emit(Machine& M, const Stream& s, int len,
                                     int d, int r) {
  if (M.n_tok >= s.T) {
    M.err = ERR_TAPE_OVERFLOW;
    return;
  }
  s.ol[M.n_tok] = len;
  s.di[M.n_tok] = d;
  s.rv[M.n_tok] = r;
  M.n_tok++;
  M.produced += len;
}

__device__ __forceinline__ void set_err(Machine& M, int code) {
  M.mode = M_ERR;
  M.err = code;
}

// Thread 0: run the machine until it stops or needs a table (M.need).
__device__ void run(Machine& M, const Stream& s, const uint32_t* stab,
                    const uint32_t* dist_tab) {
  while (M.mode != M_DONE && M.mode != M_ERR && M.err == OK) {
    switch (M.mode) {
      case M_BLOCK: {
        const bool ok = M.bit_pos + 3 <= s.total_bits;
        const int hdr = peek(s, M.bit_pos, 3);
        if (!ok) {  // a missing header wins over everything
          set_err(M, ERR_TRUNCATED);
          break;
        }
        M.bfinal = hdr & 1;
        const int btype = hdr >> 1;
        if (btype == 0) {
          const int pos = (M.bit_pos + 3 + 7) & ~7;
          const bool ok2 = pos + 32 <= s.total_bits;
          const int ln = peek(s, pos, 16), nlen = peek(s, pos + 16, 16);
          const bool good = ln == (~nlen & 0xFFFF);
          const bool have = pos + 32 + ln * 8 <= s.total_bits;
          M.bit_pos = pos + 32;
          M.stored_len = ln;
          if (!ok2) set_err(M, ERR_TRUNCATED);
          else if (!good) set_err(M, ERR_STORED_LEN_MISMATCH);
          else if (!have) set_err(M, ERR_TRUNCATED);
          else M.mode = M_STORED;
        } else if (btype == 1) {
          for (int k = 0; k < 288; ++k)
            M.tl[k] = k < 144 ? 8 : k < 256 ? 9 : k < 280 ? 7 : 8;
          for (int k = 0; k < 32; ++k) M.td[k] = 5;
          M.need = NEED_STATIC;  // then bit_pos += 3, M_DATA
          return;
        } else if (btype == 2) {
          M.bit_pos += 3;
          M.mode = M_DHT_SIZES;
        } else {
          set_err(M, ERR_BAD_BLOCK_TYPE);
        }
        break;
      }
      case M_STORED: {
        if (M.stored_len > 0)
          emit(M, s, M.stored_len, 0, tbz::STORED_FLAG | (M.bit_pos >> 3));
        M.bit_pos += M.stored_len * 8;
        M.mode = M.bfinal ? M_DONE : M_BLOCK;
        if (M.bfinal) M.finished = 1;
        break;
      }
      case M_DATA: {
        const uint32_t e = stab[peek(s, M.bit_pos, 15)];
        const int nb = tbz::e_nbits(e), op = tbz::e_op(e);
        const bool ok = M.bit_pos + nb <= s.total_bits;
        if (op == tbz::OP_INVALID) {
          set_err(M, ERR_INVALID_CODE);
        } else if (op == tbz::OP_LITERAL) {
          emit(M, s, 1, 0, tbz::e_val(e));
          M.bit_pos += nb;
        } else if (op == tbz::OP_END) {
          M.bit_pos += nb;
          M.mode = M.bfinal ? M_DONE : M_BLOCK;
          if (M.bfinal) M.finished = 1;
        } else {
          const int p1 = M.bit_pos + nb;
          const int ex = tbz::e_extra(e);
          const int length = tbz::e_val(e) +
              (peek(s, p1, 13) & ((1 << (ex < 13 ? ex : 13)) - 1));
          const int p2 = p1 + ex;
          const uint32_t de = dist_tab[peek(s, p2, 15)];
          const int p3 = p2 + tbz::e_nbits(de);
          const int dex = tbz::e_extra(de);
          const int d = tbz::e_val(de) +
              (peek(s, p3, 13) & ((1 << (dex < 13 ? dex : 13)) - 1));
          const int p4 = p3 + dex;
          const bool toofar = d > M.produced + s.window_len;
          emit(M, s, length, d, 0);
          M.bit_pos = p4;
          if (p4 > s.total_bits) set_err(M, ERR_TRUNCATED);
          else if (tbz::e_op(de) != tbz::OP_MATCH) set_err(M, ERR_INVALID_CODE);
          else if (toofar) set_err(M, ERR_BAD_DISTANCE);
        }
        if (!ok) set_err(M, ERR_TRUNCATED);  // truncation beats invalid
        break;
      }
      case M_DHT_SIZES: {
        const bool ok = M.bit_pos + 14 <= s.total_bits;
        const int v = peek(s, M.bit_pos, 14);
        M.hlit = (v & 31) + 257;
        M.hdist = ((v >> 5) & 31) + 1;
        M.hclen = ((v >> 10) & 15) + 4;
        if (ok) M.bit_pos += 14;
        M.cl_i = 0;
        M.lens_i = 0;
        for (int k = 0; k < MAX_LENS; ++k) M.lens[k] = 0;
        if (!ok) set_err(M, ERR_TRUNCATED);
        else if (M.hlit > 286 || M.hdist > 30) set_err(M, ERR_TOO_MANY_SYMBOLS);
        else M.mode = M_DHT_CLLEN;
        break;
      }
      case M_DHT_CLLEN: {
        const bool ok = M.bit_pos + 3 <= s.total_bits;
        const int v = peek(s, M.bit_pos, 3);
        M.lens[300 + kClOrder[M.cl_i < 18 ? M.cl_i : 18]] = ok ? v : 0;
        if (ok) M.bit_pos += 3;
        M.cl_i++;
        if (!ok) set_err(M, ERR_TRUNCATED);
        else M.mode = M.cl_i >= M.hclen ? M_DHT_BUILD_CL : M_DHT_CLLEN;
        break;
      }
      case M_DHT_BUILD_CL: {
        for (int k = 0; k < 19; ++k) M.tl[k] = M.lens[300 + k];
        M.need = NEED_CL;
        return;
      }
      case M_DHT_LENS: {
        const uint32_t e = stab[peek(s, M.bit_pos, 15)];
        const int nb = tbz::e_nbits(e);
        const bool ok = M.bit_pos + nb <= s.total_bits;
        const int sym = tbz::e_val(e);
        const bool invalid = tbz::e_op(e) == tbz::OP_INVALID;
        const int total = M.hlit + M.hdist;
        const int i = M.lens_i;
        const int rep_bits = sym == 16 ? 2 : sym == 17 ? 3 : 7;
        const int rb = peek(s, M.bit_pos + nb, 7) & ((1 << rep_bits) - 1);
        const int rep = (sym == 16 || sym == 17) ? 3 + rb : 11 + rb;
        const int rep_val = sym == 16 ? M.lens[i > 0 ? i - 1 : 0] : 0;
        const bool no_prev = sym == 16 && i == 0;
        const bool use_rep = sym >= 16;
        const bool overrun = use_rep && i + rep > total;
        const int consumed = nb + (use_rep ? rep_bits : 0);
        const bool ok2 = M.bit_pos + consumed <= s.total_bits;
        if (ok && ok2 && !invalid && !no_prev && !overrun) {
          if (use_rep) {
            for (int k = i; k < i + rep && k < MAX_LENS; ++k)
              M.lens[k] = rep_val;
          } else {
            M.lens[i < MAX_LENS - 1 ? i : MAX_LENS - 1] = sym;
          }
          M.lens_i = i + (use_rep ? rep : 1);
          M.bit_pos += consumed;
        }
        const bool bad_lit_overflow = sym < 16 && i >= total;
        if (!(ok && ok2)) set_err(M, ERR_TRUNCATED);
        else if (invalid) set_err(M, ERR_INVALID_CODE);
        else if (no_prev || overrun || bad_lit_overflow)
          set_err(M, ERR_BAD_CL_REPEAT);
        else if (M.lens_i >= total) M.mode = M_DHT_BUILD;
        break;
      }
      case M_DHT_BUILD: {
        for (int k = 0; k < 288; ++k) M.tl[k] = k < M.hlit ? M.lens[k] : 0;
        for (int k = 0; k < 32; ++k) {
          const int j = k + M.hlit;
          M.td[k] = k < M.hdist ? M.lens[j < MAX_LENS ? j : MAX_LENS - 1] : 0;
        }
        M.need = NEED_DYN;
        return;
      }
      default:
        return;
    }
  }
}

// Thread 0: the rest of the mode that asked for a table.
__device__ void finish_build(Machine& M) {
  if (M.need == NEED_STATIC) {
    M.bit_pos += 3;
    M.mode = M_DATA;
  } else if (M.need == NEED_CL) {
    if (M.e1 != OK) set_err(M, M.e1);
    else M.mode = M_DHT_LENS;
    for (int k = 300; k < MAX_LENS; ++k) M.lens[k] = 0;
  } else {
    // a missing end-of-block code first, then litlen, then dist
    const int e = M.lens[256] == 0 ? tbz::ERR_BAD_HUFFMAN
                                   : (M.e1 != OK ? M.e1 : M.e2);
    if (e != OK) set_err(M, e);
    else M.mode = M_DATA;
  }
  M.need = NEED_NONE;
}

__global__ void __launch_bounds__(THREADS)
inflate(Stream s, const uint32_t* __restrict__ consts, int32_t* res,
        uint32_t* dist_tab) {
  extern __shared__ uint32_t stab[];  // litlen or code-length table
  __shared__ Machine M;
  __shared__ tbz::FlatTableScratch sc;
  if (threadIdx.x == 0) {
    M.bit_pos = M.mode = M.bfinal = M.produced = M.n_tok = 0;
    M.err = OK;
    M.finished = M.hlit = M.hdist = M.hclen = M.cl_i = M.lens_i = 0;
    M.stored_len = M.need = M.e1 = M.e2 = 0;
    for (int k = 0; k < MAX_LENS; ++k) M.lens[k] = 0;
  }
  __syncthreads();
  for (;;) {
    if (threadIdx.x == 0) run(M, s, stab, dist_tab);
    __syncthreads();
    const int need = M.need;  // the same value in every thread
    if (need == NEED_NONE) break;
    if (need == NEED_CL) {
      tbz::build_flat_table_block(M.tl, 19, consts + 320, false, stab, sc);
      if (threadIdx.x == 0) M.e1 = sc.err;
    } else {
      tbz::build_flat_table_block(M.tl, 288, consts, true, stab, sc);
      if (threadIdx.x == 0) M.e1 = sc.err;
      tbz::build_flat_table_block(M.td, 32, consts + 288, true, dist_tab,
                                  sc);
      if (threadIdx.x == 0) M.e2 = sc.err;
    }
    if (threadIdx.x == 0) finish_build(M);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    res[0] = M.n_tok;
    res[1] = M.produced;
    res[2] = M.bit_pos;
    res[3] = M.err;
    res[4] = M.finished;
  }
}

}  // namespace

TBZ_API int tbz_inflate(const uint32_t* data, int64_t nwords, int total_bits,
                        int window_len, const uint32_t* consts, int64_t T,
                        int32_t* out_len, int32_t* dist, int32_t* root_val,
                        int32_t* res, uint32_t* dist_tab, cudaStream_t st) {
  const int smem = tbz::TSIZE * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      inflate, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  Stream s{data, nwords, total_bits, window_len, T, out_len, dist, root_val};
  inflate<<<1, THREADS, smem, st>>>(s, consts, res, dist_tab);
  return (int)cudaGetLastError();
}
