// The split of a checksum range shared by kernels 5 (crc32.cu) and 6
// (adler32.cu), and their grid.
//
// A row's range [A, E) is read as:
//  - word 0 .. nw - 1: the 16-byte words of [floor16(A), floor16(E)).
//    Word 0 is the head when A is not aligned: its bytes before A read
//    as 0 (leading zeros change neither checksum) and are never loaded;
//  - the tail [max(A, floor16(E)), E), under 16 bytes, read by bytes.
// When E lies in A's word, nw = 0 and the whole range is the tail. No
// byte outside the range is read.
//
// The grid is (G, S): row s's words are cut into spans of `span` words,
// one a block, and the blocks past the row's last span return at once.
#pragma once

#include "common.cuh"

namespace tbz {
namespace checksum {

constexpr int THREADS = 256;
constexpr int64_t TARGET_BLOCKS = 4 * 132;  // about 4 blocks an H100 SM
constexpr int64_t MIN_SPAN = 256;           // words a block at least
constexpr int64_t MAX_SPAN = 1 << 20;       // and at most (16 MiB)

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// the grid's x extent for S rows of at most max_len bytes
inline int64_t grid_blocks(int64_t S, int64_t max_len) {
  if (S <= 0 || max_len < 0) return 1;
  const int64_t maxw = max_len / 16 + 1;  // bounds nw of every row
  int64_t g = ceil_div(TARGET_BLOCKS, S);
  if (g > ceil_div(maxw, MIN_SPAN)) g = ceil_div(maxw, MIN_SPAN);
  if (g < ceil_div(maxw, MAX_SPAN)) g = ceil_div(maxw, MAX_SPAN);
  return g > 0 ? g : 1;
}

struct Split {
  const uint4* words;    // word 0, at floor16(A)
  const uint8_t* begin;  // A
  const uint8_t* tail;   // the first tail byte
  const uint8_t* end;    // E
  int64_t nw;            // whole words (word 0 may be the head)
  int64_t span;          // words a block
  int64_t active;        // blocks with a span (at least 1: the fold)
  bool head;             // word 0 starts before A
};

__device__ __forceinline__ Split split(const uint8_t* a, int64_t n, int G) {
  const uint64_t A = (uint64_t)a, E = A + (uint64_t)n;
  const uint64_t P0 = A & ~(uint64_t)15, Pt = E & ~(uint64_t)15;
  Split r;
  r.words = (const uint4*)P0;
  r.begin = a;
  r.end = a + n;
  r.nw = (int64_t)((Pt - P0) >> 4);
  r.tail = r.nw ? (const uint8_t*)Pt : a;
  r.head = A != P0;
  r.span = (r.nw + G - 1) / G;
  if (r.span < MIN_SPAN) r.span = MIN_SPAN;
  r.active = r.nw ? (r.nw + r.span - 1) / r.span : 1;
  return r;
}

// word 0 with its bytes before A as 0, read byte by byte
__device__ __forceinline__ uint4 head_word(const Split& r) {
  const uint8_t* p0 = (const uint8_t*)r.words;
  uint32_t x[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (p0 + j >= r.begin) x[j >> 2] |= (uint32_t)p0[j] << (8 * (j & 3));
  return make_uint4(x[0], x[1], x[2], x[3]);
}

}  // namespace checksum
}  // namespace tbz
