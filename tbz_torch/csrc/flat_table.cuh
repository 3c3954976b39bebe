// The flat 2^15-entry Huffman decode table, built by one thread block.
//
// Shared by tables.cu (kernel 1, B candidate blocks in one launch) and
// inflate.cu (the sequential device tokenizer, which builds its static,
// code-length and dynamic tables as it meets them). nvcc without -rdc
// cannot link a __device__ function across .cu files, hence a header.
//
// The port of tbz/ops/tokenize_device.py:build_flat_table, which fills
// the table by scatter + cumsum over the canonical order and one 2^15
// permutation gather, because TPU gathers are slow. Here each used symbol
// writes its own slots directly: a symbol of length l owns the slots
// rev_l(code) + j * 2^l. Code lengths -> bl_count, next_code, Kraft sum
// and err run in one thread (<= 288 steps).
#pragma once

#include "common.cuh"

namespace tbz {

constexpr int FT_MAX_SYMS = 288;

struct FlatTableScratch {
  int lens[FT_MAX_SYMS];
  uint32_t entry[FT_MAX_SYMS];
  int slot0[FT_MAX_SYMS];
  int counts[16];
  int next_code[16];
  int err;
};

// Every thread of the block must call this (it synchronizes the block
// four times). lens: n_syms code lengths (0 = unused); entry_of(i, l):
// symbol i's table entry for a code of l bits; invalid: the entry of an
// uncovered slot; tab: TSIZE entries (shared or global memory). On return
// sc.err is ERR_BAD_HUFFMAN for an over-subscribed code, or for an
// incomplete one unless allow_single and it is a single 1-bit code
// (zlib's exception), else 0; a table with err != 0 is never read.
template <typename T, typename EntryOf>
__device__ inline void build_flat_table_block_t(const int32_t* lens_in,
                                                int n_syms, EntryOf entry_of,
                                                T invalid, bool allow_single,
                                                T* tab,
                                                FlatTableScratch& sc) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < TSIZE; i += nt) tab[i] = invalid;
  for (int i = tid; i < n_syms; i += nt) {
    const int l = lens_in[i];
    sc.lens[i] = l < 0 ? 0 : (l > 15 ? 15 : l);
  }
  __syncthreads();

  if (tid == 0) {
    for (int l = 0; l < 16; ++l) sc.counts[l] = 0;
    int n_used = 0, max_len = 0;
    for (int i = 0; i < n_syms; ++i) {
      const int l = sc.lens[i];
      if (l > 0) {
        sc.counts[l]++;
        n_used++;
        max_len = l > max_len ? l : max_len;
      }
    }
    int64_t kraft = 0;
    for (int l = 1; l < 16; ++l) kraft += (int64_t)sc.counts[l] << (15 - l);
    const bool over = kraft > TSIZE;
    const bool single_ok = allow_single && max_len == 1 && n_used == 1;
    const bool incomplete_bad = kraft < TSIZE && n_used > 0 && !single_ok;
    sc.err = (over || incomplete_bad) ? ERR_BAD_HUFFMAN : 0;
    int code = 0;
    sc.next_code[0] = 0;
    for (int l = 1; l < 16; ++l) {
      code = (code + (l > 1 ? sc.counts[l - 1] : 0)) << 1;
      sc.next_code[l] = code;
    }
  }
  __syncthreads();

  // canonical code of each used symbol: next_code[len] + rank among the
  // symbols of the same length, bit-reversed into the stream's LSB-first
  // slot order
  for (int i = tid; i < n_syms; i += nt) {
    const int l = sc.lens[i];
    int rank = 0;
    for (int j = 0; j < i; ++j) rank += sc.lens[j] == l;
    const int code = l ? ((sc.next_code[l] + rank) & ((1 << l) - 1)) : 0;
    sc.slot0[i] = l ? (int)(__brev((unsigned)code) >> (32 - l)) : 0;
    sc.entry[i] = (uint32_t)entry_of(i, l);
  }
  __syncthreads();

  for (int i = 0; i < n_syms; ++i) {
    const int l = sc.lens[i];
    if (!l) continue;
    const int span = 1 << (15 - l);
    const T e = (T)sc.entry[i];
    for (int j = tid; j < span; j += nt) tab[sc.slot0[i] + (j << l)] = e;
  }
  __syncthreads();
}

// The packed-entry table (constants.py layout): consts holds each
// symbol's entry without its nbits.
__device__ inline void build_flat_table_block(const int32_t* lens_in,
                                              int n_syms,
                                              const uint32_t* consts,
                                              bool allow_single,
                                              uint32_t* tab,
                                              FlatTableScratch& sc) {
  build_flat_table_block_t<uint32_t>(
      lens_in, n_syms,
      [consts](int i, int l) { return consts[i] | (uint32_t)l; },
      INVALID_ENTRY, allow_single, tab, sc);
}

}  // namespace tbz
