// Shared declarations of the tbz_torch CUDA kernels (sm_90a).
//
// Every entry point has a plain C interface (bound with ctypes from
// tbz_torch/_cuda.py), launches on the stream it is given, allocates
// nothing (the Python wrapper passes outputs and scratch), and returns
// cudaGetLastError() so a refused launch raises in the wrapper.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TBZ_API extern "C" __attribute__((visibility("default")))

namespace tbz {

constexpr int TBITS = 15;              // flat decode tables: 2^15 slots
constexpr int TSIZE = 1 << TBITS;
constexpr int BIG = 0x7FFFFFFF;        // stitch sentinel (never matches)
constexpr int W = 32768;               // LZ77 window
constexpr int STORED_FLAG = 1 << 30;   // tape.STORED_FLAG

// packed table entry fields (constants.py layout)
constexpr int OP_LITERAL = 0;
constexpr int OP_MATCH = 1;
constexpr int OP_END = 2;
constexpr int OP_INVALID = 3;
constexpr uint32_t INVALID_ENTRY = 15u | (OP_INVALID << 4);
constexpr int ERR_BAD_HUFFMAN = 4;

__device__ __forceinline__ int e_nbits(uint32_t e) { return e & 0xF; }
__device__ __forceinline__ int e_op(uint32_t e) { return (e >> 4) & 0x7; }
__device__ __forceinline__ int e_extra(uint32_t e) { return (e >> 7) & 0x1F; }
__device__ __forceinline__ int e_val(uint32_t e) { return (int)(e >> 16); }

// Resolve words (resolve.cu, spans.cu): one 32-bit word a table byte.
// A value word has bit 31 set, the byte in bits 0-7, the doubling pass
// that resolved it in bits 8-13 (0: it was a root from the start), and
// bit 30 set for an original root (window, literal, stored, padding). A
// pointer word has bit 31 clear and the distance back to its parent in
// bits 0-30 (target = own index - back).
constexpr uint32_t VALUE = 1u << 31;
constexpr uint32_t ROOT = 1u << 30;
__device__ __forceinline__ uint32_t root_word(uint32_t byte) {
  return VALUE | ROOT | byte;
}
__device__ __forceinline__ uint32_t resolved_word(uint32_t byte,
                                                  uint32_t pass) {
  return VALUE | (pass << 8) | (byte & 0xFF);
}

}  // namespace tbz

// scan.cu: exclusive prefix sum of n int32 values (in may equal out).
// *total (device pointer, may be null) receives the sum. scratch holds
// tbz_scan_scratch_ints(n) int32 values.
TBZ_API int64_t tbz_scan_scratch_ints(int64_t n);
int tbz_exclusive_scan(const int32_t* in, int32_t* out, int64_t n,
                       int32_t* total, int32_t* scratch, cudaStream_t s);

// resolve.cu: pointer doubling of resolve words to their values, shared
// by the token-tape resolve and the flat span resolve. The caller writes
// every word into tbz_doubling_words(scratch): `rows` rows of n words
// each. Row r's words [lo, n) go to out[r * (n - lo) ...]; *passes
// (device, may be null) gets tbz's doubling pass count.
int64_t tbz_doubling_scratch_ints(int64_t words);
uint32_t* tbz_doubling_words(int32_t* scratch);
int tbz_doubling(int32_t* scratch, int64_t rows, int64_t n, int64_t lo,
                 uint8_t* out, int32_t* passes, cudaStream_t s);

// resolve.cu: LZ77 resolve of a token tape whose exclusive length scan
// `starts` is already computed (shared by the splice kernel).
int tbz_resolve_from_starts(const int32_t* ol, const int32_t* di,
                            const int32_t* rv, const int32_t* starts,
                            int64_t T, const uint8_t* input, int64_t n_input,
                            const uint8_t* window, int64_t cap, uint8_t* out,
                            int32_t* scratch, int32_t* passes,
                            cudaStream_t s);
int64_t tbz_resolve_core_scratch_ints(int64_t cap);
