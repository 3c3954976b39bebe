// Kernel 6: Adler-32 of a byte range of each row, continuing from a
// previous Adler-32; and adler32_combine.
//
// Replaces tbz/checksums.py:_adler32_device (:211, the last n bytes),
// _adler32_device_tail (:385, the first n bytes, trailing padding removed
// by a weight correction), adler32_combine_device (:455), and the vmapped
// tbz/parallel/shard.py:_adler_batch (:53).
//
// Math: a range X of n bytes has sa = sum x_i and sb = sum (n - i)·x_i;
// two pieces merge as sa = sa_l + sa_r, sb = sb_l + |r|·sa_l + sb_r
// (mod 65521), so leading zero bytes change neither, and prev =
// (b0 << 16) | a0 folds in as a = a0 + sa, b = b0 + n·a0 + sb
// (tbz/checksums.py:413-417).
//
// Bound: bytes (n read once a row, 8 bytes written). The first design
// read a byte a thread a step with a 64-bit multiply and index math a
// byte, and was instruction-bound at a quarter of the bytes bound. This
// one (checksum.cuh's split, shared with kernel 5):
//  - the range [A, E) is cut at 16-byte boundaries into a head word (the
//    aligned word holding A, bytes before A read as 0: leading zeros are
//    free), the aligned words up to floor16(E), and a tail of under 16
//    bytes; no byte outside the range is read;
//  - the words are 16-byte loads (ld.global.nc, four in flight a thread),
//    neighbouring threads on neighbouring words; a grid of about four
//    blocks an SM, each block a contiguous span of a row, at least
//    MIN_SPAN words (a 1 MiB row gets 256 blocks);
//  - a word's sums are eight __dp4a: a_w = sum x_j and
//    w_w = sum (16 - j)·x_j, so the word adds a_w to sa and
//    after·a_w + w_w to sb, with `after` its bytes after it in the span
//    (one 32 x 32 -> 64-bit multiply-add a word, no modulo);
//  - the block reduces its (sa, sb) over warps, weights them by the
//    bytes after its span and stores the pair mod 65521; the last block
//    of the row (an atomic ticket after a fence) adds the pairs, walks
//    the tail bytes and folds in prev: one launch (the ticket that wraps
//    to 0 leaves the row's counter ready for the next launch).
// Overflow: a span holds at most MAX_SPAN = 2^20 words (16 MiB), so
// after < 2^24, a_w <= 16·255 < 2^12 and w_w <= 136·255 < 2^16: a word
// adds under 2^36 + 2^16 to sb, a thread's 2^12 words under 2^49 and the
// block's 2^20 words under 2^57. The 64-bit sums never wrap.
#include "checksum.cuh"

namespace {

using namespace tbz::checksum;

constexpr uint64_t MOD = 65521;

__device__ __forceinline__ uint64_t block_sum(uint64_t v, uint64_t* warp) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  if ((threadIdx.x & 31) == 0) warp[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < THREADS / 32 ? warp[threadIdx.x] : 0;
  if (threadIdx.x < 32) {
#pragma unroll
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  }
  __syncthreads();  // warp[] is reused by the next call
  return v;  // valid in thread 0
}

// the word's sums: a_w = sum x_j, w_w = sum (16 - j)·x_j
__device__ __forceinline__ void word_sums(uint4 v, uint32_t& a,
                                          uint32_t& w) {
  const uint32_t one = 0x01010101u;
  a = __dp4a(v.x, one, __dp4a(v.y, one, __dp4a(v.z, one,
                                                __dp4a(v.w, one, 0u))));
  w = __dp4a(v.x, 0x0D0E0F10u, __dp4a(v.y, 0x090A0B0Cu,
             __dp4a(v.z, 0x05060708u, __dp4a(v.w, 0x01020304u, 0u))));
}

__device__ __forceinline__ void add_word(uint4 v, uint32_t after,
                                         uint64_t& sa, uint64_t& sb) {
  uint32_t a, w;
  word_sums(v, a, w);
  sa += a;
  sb += (uint64_t)after * a + w;
}

// params: int64[3, S] = (offset, length, prev) of each row; scratch:
// uint32 pairs[S][G][2]; tickets: uint32[S], 0 before the launch and after
__global__ void __launch_bounds__(THREADS)
adler_rows(const uint8_t* __restrict__ base, int64_t stride, int64_t S,
           const int64_t* __restrict__ params,
           unsigned* __restrict__ tickets, uint32_t* __restrict__ scratch,
           int64_t* __restrict__ out) {
  __shared__ uint64_t warp[THREADS / 32];
  __shared__ int last;
  const int64_t s = blockIdx.y;
  const int G = gridDim.x;
  const Split r = split(base + s * stride + params[s], params[S + s], G);
  const int64_t b = blockIdx.x;
  if (b >= r.active) return;  // uniform over the block
  const int t = threadIdx.x;
  const int64_t lo = b * r.span, hi = min(r.nw, lo + r.span);
  int64_t w = lo + t;
  uint64_t sa = 0, sb = 0;
  // bytes after word w up to the span's end: 16·(hi - 1 - w) < 2^24
  uint32_t after = (uint32_t)(16 * (hi - 1 - w));
  if (w == 0 && w < hi && r.head) {
    add_word(head_word(r), after, sa, sb);
    w += THREADS;
    after -= 16 * THREADS;
  }
  const uint4* __restrict__ words = r.words;
  for (; w + 3 * THREADS < hi; w += 4 * THREADS) {
    const uint4 v0 = __ldg(words + w), v1 = __ldg(words + w + THREADS),
                v2 = __ldg(words + w + 2 * THREADS),
                v3 = __ldg(words + w + 3 * THREADS);
    add_word(v0, after, sa, sb);
    add_word(v1, after - 16 * THREADS, sa, sb);
    add_word(v2, after - 32 * THREADS, sa, sb);
    add_word(v3, after - 48 * THREADS, sa, sb);
    after -= 64 * THREADS;
  }
  for (; w < hi; w += THREADS, after -= 16 * THREADS)
    add_word(__ldg(words + w), after, sa, sb);
  sa = block_sum(sa, warp);
  sb = block_sum(sb, warp);
  uint32_t* pairs = scratch + 2 * (s * G);
  if (t == 0) {
    // weight the span by the words after it, up to floor16(E)
    const uint64_t a = sa % MOD;
    const uint64_t rest = (uint64_t)(16 * (r.nw - hi)) % MOD;
    pairs[2 * b] = (uint32_t)a;
    pairs[2 * b + 1] = (uint32_t)((sb % MOD + rest * a) % MOD);
    __threadfence();
    // the last ticket wraps the row's back to 0 for the next launch
    const unsigned top = (unsigned)r.active - 1;
    last = atomicInc(tickets + s, top) == top;
  }
  __syncthreads();
  if (!last) return;  // uniform over the block
  // the row's last block: add the spans' pairs, then the tail, then prev
  uint64_t a = 0, bb = 0;
  for (int64_t c = t; c < r.active; c += THREADS) {
    a += __ldcg(pairs + 2 * c);
    bb += __ldcg(pairs + 2 * c + 1);
  }
  a = block_sum(a, warp) % MOD;
  bb = block_sum(bb, warp) % MOD;
  if (t) return;
  for (const uint8_t* p = r.tail; p < r.end; ++p) {  // under 16 bytes
    a += *p;
    bb += a;
  }
  const int64_t n = params[S + s];
  const uint64_t prev = (uint64_t)params[2 * S + s];
  const uint64_t a0 = prev & 0xFFFF, b0 = (prev >> 16) & 0xFFFF;
  const uint64_t ra = (a0 + a) % MOD;
  const uint64_t rb = (b0 + ((uint64_t)n % MOD) * (a0 % MOD) + bb) % MOD;
  out[s] = (int64_t)((rb << 16) | ra);
}

// args: int64[3, count] = (adler1, adler2, len2), zlib's adler32_combine
__global__ void adler_combine(const int64_t* __restrict__ args,
                              int64_t count, int64_t* __restrict__ out) {
  for (int64_t i = threadIdx.x; i < count; i += blockDim.x) {
    const uint64_t a1 = (uint64_t)args[i], a2 = (uint64_t)args[count + i];
    const uint64_t rem = (uint64_t)args[2 * count + i] % MOD;
    const uint64_t s1_1 = a1 & 0xFFFF, s2_1 = (a1 >> 16) & 0xFFFF;
    const uint64_t s1_2 = a2 & 0xFFFF, s2_2 = (a2 >> 16) & 0xFFFF;
    const uint64_t s1 = (s1_1 + s1_2 + MOD - 1) % MOD;
    const uint64_t s2 = (s2_1 + s2_2 + rem * ((s1_1 + MOD - 1) % MOD)) % MOD;
    out[i] = (int64_t)((s2 << 16) | s1);
  }
}

}  // namespace

TBZ_API int tbz_adler32_rows(const uint8_t* base, int64_t stride, int64_t S,
                             const int64_t* params, int64_t max_len,
                             unsigned* tickets, uint32_t* scratch,
                             int64_t* out, cudaStream_t st) {
  const int64_t G = grid_blocks(S, max_len);
  if (S <= 0 || S > 65535 || G > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  adler_rows<<<dim3((unsigned)G, (unsigned)S), THREADS, 0, st>>>(
      base, stride, S, params, tickets, scratch, out);
  return (int)cudaGetLastError();
}

TBZ_API int tbz_adler32_combine(const int64_t* args, int64_t count,
                                int64_t* out, cudaStream_t st) {
  adler_combine<<<1, THREADS, 0, st>>>(args, count, out);
  return (int)cudaGetLastError();
}
