// Kernel 5: CRC-32 (zlib's reflected polynomial) of a byte range of each
// row, continuing from a previous CRC; and crc32_combine.
//
// Replaces tbz/checksums.py:_crc32_device (:320, the last n bytes),
// _crc32_device_tail (:425, the first n bytes), the square-and-multiply
// shifts _crc_shift_dynamic_device (:175) and _crc_unshift_dynamic_device
// (:366), crc32_combine_device (:442), and the vmapped
// tbz/parallel/shard.py:_crc_batch (:46). The XLA version computes each
// 128-byte lane's CRC as one bit-matrix product on the MXU and undoes the
// trailing padding with inverse matrices; here table lookups do the
// bytes and only the range's own bytes are read.
//
// Math: with L(X) the register after X from a zero init,
// L(X || Y) = L(X)·x^(8|Y|) ^ L(Y), leading zero bytes leave L unchanged,
// and crc32(X, prev) = ~(L(X) ^ (~prev)·x^(8|X|)). A shift by x^(8m)
// applies the power matrices x^(8·2^k) of the set bits of m, a 64-bit
// byte count (tbz holds 8m in uint32, which wraps at m = 2^29 bytes).
//
// Bound: bytes (n read once a row, 8 bytes written). The first port
// staged bytes one at a time in shared memory and walked 128 of them a
// thread through one table, a dependent shared load a byte, at a quarter
// of the bytes bound. This one reads the range as checksum.cuh splits it
// (the zero-filled head word is free; no byte outside the range is
// read), in the grid of kernel 6:
//  - a thread takes the 16-byte words t, t + 256, ... of its block's
//    span (16-byte loads, four in flight, neighbouring threads on
//    neighbouring words) and keeps acc = acc·x^(8·4096) ^ L(word): the
//    shift by the stride of 4096 bytes is 4 lookups of byte tables, and
//    L(word) 16 byte steps through T_0 (checksums.py:crc_tables);
//  - the lookups bound it, not the bytes: 32 lanes reading random
//    entries of one 256-word table meet ~3.4-way bank conflicts. So T_0
//    is held once in every bank (entry e of lane l at 32e + l, 32 KB),
//    and a lane only reads its own bank: the 16 byte steps of a word
//    are conflict-free and only the stride's 4 lookups conflict. The
//    four words of a step give four independent byte chains. (Measured
//    on an H100, 640 MiB: slicing-by-16, 20 conflicted lookups a word,
//    0.387 ms; 5-bit tables in registers read by shuffles 0.49-0.52 ms;
//    this 0.266 ms);
//  - the thread shifts acc by the bytes after its last word in the span
//    (under 4096), the block XOR-reduces, and warp 0 shifts the block's
//    L by the bytes after its span (a warp-wide matrix product a set
//    bit: lane i takes column i), all from power matrices in shared
//    memory;
//  - the last block of the row (an atomic ticket after a fence) XORs the
//    spans, walks the tail bytes and conditions on prev: one launch (the
//    ticket that wraps to 0 leaves the row's counter ready).
#include "checksum.cuh"

namespace {

using namespace tbz::checksum;

constexpr int STRIDE_BYTES = 16 * THREADS;  // = checksums.py:_CRC_STRIDE
static_assert(STRIDE_BYTES == 4096, "the host builds the shift tables");
static_assert(THREADS == 256, "a thread stages one entry of T_0");

__device__ __forceinline__ uint32_t gf2_times(const uint32_t* m, uint32_t v) {
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) s ^= m[i] & (0u - ((v >> i) & 1u));
  return s;
}

// v·x^(8·nbytes) mod P; mats[32k .. 32k+31] are the columns of x^(8·2^k)
__device__ uint32_t shift_bytes(const uint32_t* mats, uint32_t v,
                                uint64_t nbytes) {
  for (int k = 0; nbytes; ++k, nbytes >>= 1)
    if (nbytes & 1) v = gf2_times(mats + 32 * k, v);
  return v;
}

// shift_bytes by a whole warp (every lane with the same v and nbytes):
// lane i takes column i, and a butterfly XORs the columns
__device__ uint32_t shift_bytes_warp(const uint32_t* mats, uint32_t v,
                                     uint64_t nbytes) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; nbytes; ++k, nbytes >>= 1) {
    if (!(nbytes & 1)) continue;
    uint32_t c = (v >> lane) & 1u ? mats[32 * k + lane] : 0u;
#pragma unroll
    for (int d = 16; d; d >>= 1) c ^= __shfl_xor_sync(0xffffffffu, c, d);
    v = c;
  }
  return v;
}

__device__ __forceinline__ uint32_t block_xor(uint32_t v, uint32_t* warp) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, d);
  if ((threadIdx.x & 31) == 0) warp[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < THREADS / 32 ? warp[threadIdx.x] : 0;
  if (threadIdx.x < 32) {
#pragma unroll
    for (int d = 16; d; d >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, d);
  }
  return v;  // valid in every lane of warp 0
}

// L(word) from a zero register, a byte at a time through T_0; `my` is
// this lane's bank of the table held once in every bank
__device__ __forceinline__ uint32_t word_crc(const uint32_t* my, uint4 v) {
  uint32_t c = v.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) c = my[(c & 255) << 5] ^ (c >> 8);
  c ^= v.y;
#pragma unroll
  for (int i = 0; i < 4; ++i) c = my[(c & 255) << 5] ^ (c >> 8);
  c ^= v.z;
#pragma unroll
  for (int i = 0; i < 4; ++i) c = my[(c & 255) << 5] ^ (c >> 8);
  c ^= v.w;
#pragma unroll
  for (int i = 0; i < 4; ++i) c = my[(c & 255) << 5] ^ (c >> 8);
  return c;
}

// acc·x^(8·STRIDE_BYTES): byte j of acc through the stride's table j
__device__ __forceinline__ uint32_t stride_shift(const uint32_t* sh,
                                                 uint32_t acc) {
  return sh[acc & 255] ^ sh[256 + ((acc >> 8) & 255)] ^
         sh[512 + ((acc >> 16) & 255)] ^ sh[768 + (acc >> 24)];
}

// params: int64[3, S] = (offset, length, prev) of each row; mats:
// uint32[64][32]; tables: uint32[5][256] (T_0, then the stride's byte
// tables); tickets: uint32[S], 0 before the launch and after; scratch:
// uint32 spans[S][G]
__global__ void __launch_bounds__(THREADS)
crc_rows(const uint8_t* __restrict__ base, int64_t stride, int64_t S,
         const int64_t* __restrict__ params, const uint32_t* __restrict__ mats,
         const uint32_t* __restrict__ tables, unsigned* __restrict__ tickets,
         uint32_t* __restrict__ scratch, int64_t* __restrict__ out) {
  __shared__ uint32_t lanetab[256 * 32];  // T_0, once in every bank
  __shared__ uint32_t sh[4 * 256];        // the stride's byte tables
  __shared__ uint32_t smat[64 * 32];      // the power matrices
  __shared__ uint32_t warp[THREADS / 32];
  __shared__ int last;
  const int64_t s = blockIdx.y;
  const int G = gridDim.x;
  const Split r = split(base + s * stride + params[s], params[S + s], G);
  const int64_t b = blockIdx.x;
  if (b >= r.active) return;  // uniform over the block
  const int t = threadIdx.x;
  {
    // entry t of T_0 into all 32 banks, lanes on distinct banks
    const uint32_t e = __ldg(tables + t);
#pragma unroll 8
    for (int j = 0; j < 32; ++j) lanetab[32 * t + ((j + t) & 31)] = e;
  }
  for (int i = t; i < 4 * 256; i += THREADS) sh[i] = __ldg(tables + 256 + i);
  for (int i = t; i < 64 * 32; i += THREADS) smat[i] = __ldg(mats + i);
  __syncthreads();
  const uint32_t* my = lanetab + (t & 31);
  const int64_t lo = b * r.span, hi = min(r.nw, lo + r.span);
  int64_t w = lo + t;
  uint32_t acc = 0;
  if (w == 0 && w < hi && r.head) {
    acc = word_crc(my, head_word(r));
    w += THREADS;
  }
  const uint4* __restrict__ words = r.words;
  for (; w + 3 * THREADS < hi; w += 4 * THREADS) {
    const uint4 v0 = __ldg(words + w), v1 = __ldg(words + w + THREADS),
                v2 = __ldg(words + w + 2 * THREADS),
                v3 = __ldg(words + w + 3 * THREADS);
    const uint32_t l0 = word_crc(my, v0), l1 = word_crc(my, v1),
                   l2 = word_crc(my, v2), l3 = word_crc(my, v3);
    acc = stride_shift(sh, acc) ^ l0;
    acc = stride_shift(sh, acc) ^ l1;
    acc = stride_shift(sh, acc) ^ l2;
    acc = stride_shift(sh, acc) ^ l3;
  }
  for (; w < hi; w += THREADS)
    acc = stride_shift(sh, acc) ^ word_crc(my, __ldg(words + w));
  if (lo + t < hi) {
    // words after this thread's last one (w - THREADS) in the span:
    // x^(8·16·2^j) is power matrix 4 + j
    const int d = (int)(hi - 1 - (w - THREADS));
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if ((d >> j) & 1) acc = gf2_times(smat + 32 * (4 + j), acc);
  }
  acc = block_xor(acc, warp);
  uint32_t* spans = scratch + s * G;
  if (t < 32) {
    // the span's L, shifted by the bytes after it up to floor16(E)
    acc = shift_bytes_warp(smat, acc, 16 * (uint64_t)(r.nw - hi));
    if (t == 0) {
      spans[b] = acc;
      __threadfence();
      // the last ticket wraps the row's back to 0 for the next launch
      const unsigned top = (unsigned)r.active - 1;
      last = atomicInc(tickets + s, top) == top;
    }
  }
  __syncthreads();
  if (!last) return;  // uniform over the block
  // the row's last block: XOR the spans, walk the tail, condition on prev
  uint32_t L = 0;
  for (int64_t c = t; c < r.active; c += THREADS) L ^= __ldcg(spans + c);
  L = block_xor(L, warp);
  if (t >= 32) return;
  for (const uint8_t* p = r.tail; p < r.end; ++p)  // under 16 bytes
    L = my[((L ^ *p) & 255) << 5] ^ (L >> 8);
  const int64_t n = params[S + s];
  const uint32_t prev = (uint32_t)params[2 * S + s];
  const uint32_t init = shift_bytes_warp(smat, ~prev, (uint64_t)n);
  if (t == 0) out[s] = (int64_t)(uint32_t)~(L ^ init);
}

// args: int64[3, count] = (crc1, crc2, len2); len2 = 0 gives crc1, as
// zlib's crc32_combine does
__global__ void crc_combine(const int64_t* __restrict__ args, int64_t count,
                            const uint32_t* __restrict__ mats,
                            int64_t* __restrict__ out) {
  for (int64_t i = threadIdx.x; i < count; i += blockDim.x) {
    const uint32_t c1 = (uint32_t)args[i];
    const uint64_t len2 = (uint64_t)args[2 * count + i];
    out[i] = (int64_t)(len2 ? shift_bytes(mats, c1, len2) ^
                                  (uint32_t)args[count + i]
                            : c1);
  }
}

}  // namespace

// int32 scratch of kernels 5 and 6: two words a block of the grid
// (kernel 6's pairs; kernel 5 uses one)
TBZ_API int64_t tbz_checksum_scratch_ints(int64_t S, int64_t max_len) {
  return 2 * S * grid_blocks(S, max_len);
}

TBZ_API int tbz_crc32_rows(const uint8_t* base, int64_t stride, int64_t S,
                           const int64_t* params, int64_t max_len,
                           const uint32_t* mats, const uint32_t* tables,
                           unsigned* tickets, uint32_t* scratch, int64_t* out,
                           cudaStream_t st) {
  const int64_t G = grid_blocks(S, max_len);
  if (S <= 0 || S > 65535 || G > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  crc_rows<<<dim3((unsigned)G, (unsigned)S), THREADS, 0, st>>>(
      base, stride, S, params, mats, tables, tickets, scratch, out);
  return (int)cudaGetLastError();
}

TBZ_API int tbz_crc32_combine(const int64_t* args, int64_t count,
                              const uint32_t* mats, int64_t* out,
                              cudaStream_t st) {
  crc_combine<<<1, THREADS, 0, st>>>(args, count, mats, out);
  return (int)cudaGetLastError();
}
