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
// (mod 65521), so leading zero bytes change neither. The range
// [off, off+n) is read as if front-padded with zeros to K whole 32 KiB
// chunks (no byte outside the range is read), and prev = (b0 << 16) | a0
// folds in as a = a0 + sa, b = b0 + n·a0 + sb (tbz/checksums.py:413-417).
//
// Bound: bytes (n read once a row). Design: pass 1, one block per chunk;
// thread t reads bytes t, t + 256, ... (coalesced) and sums x and
// (CHUNK - i)·x in 64 bits, the block adds them up, and the chunk's pair
// is stored reduced mod 65521; pass 2, one block per row, merges the
// pairs in order (a run per thread, then each run weighted by the bytes
// after it) and folds in prev. Sums stay below 2^63: no modulo inside a
// chunk.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 1 << 15;  // the chunk of kernel 5
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

// params: int64[3, S] = (offset, length, prev) of each row
__global__ void adler_chunks(const uint8_t* __restrict__ base, int64_t stride,
                             int64_t S, const int64_t* __restrict__ params,
                             int64_t kmax, uint32_t* __restrict__ partial) {
  __shared__ uint64_t warp[THREADS / 32];
  const int64_t s = blockIdx.y;
  const int64_t c = blockIdx.x;
  const int64_t n = params[S + s];
  const int64_t K = (n + CHUNK - 1) / CHUNK;
  if (c >= K) return;  // uniform over the block
  const int64_t pad = K * CHUNK - n;
  const uint8_t* row = base + s * stride + params[s];
  const int64_t p0 = c * CHUNK;
  uint64_t sa = 0, sb = 0;
  for (int i = threadIdx.x; i < CHUNK; i += THREADS) {
    const int64_t p = p0 + i;
    const uint64_t x = p >= pad ? row[p - pad] : 0;
    sa += x;
    sb += (uint64_t)(CHUNK - i) * x;
  }
  sa = block_sum(sa, warp);
  sb = block_sum(sb, warp);
  if (threadIdx.x == 0) {
    partial[2 * (s * kmax + c)] = (uint32_t)(sa % MOD);
    partial[2 * (s * kmax + c) + 1] = (uint32_t)(sb % MOD);
  }
}

__global__ void adler_finish(int64_t S, const int64_t* __restrict__ params,
                             int64_t kmax,
                             const uint32_t* __restrict__ partial,
                             int64_t* __restrict__ out) {
  __shared__ uint64_t warp[THREADS / 32];
  const int64_t s = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t n = params[S + s];
  const int64_t K = (n + CHUNK - 1) / CHUNK;
  const int64_t per = (K + THREADS - 1) / THREADS;
  const int64_t lo = min(K, t * per), hi = min(K, lo + per);
  uint64_t a = 0, b = 0;
  for (int64_t c = lo; c < hi; ++c) {
    const uint32_t* pc = partial + 2 * (s * kmax + c);
    b = (b + (CHUNK % MOD) * a + pc[1]) % MOD;
    a = (a + pc[0]) % MOD;
  }
  // this run is followed by (K - hi) chunks
  const uint64_t after = ((uint64_t)(K - hi) * CHUNK) % MOD;
  const uint64_t sa = block_sum(a, warp);
  const uint64_t sb = block_sum((b + after * a) % MOD, warp);
  if (t == 0) {
    const uint64_t prev = (uint64_t)params[2 * S + s];
    const uint64_t a0 = prev & 0xFFFF, b0 = (prev >> 16) & 0xFFFF;
    const uint64_t ra = (a0 + sa) % MOD;
    const uint64_t rb = (b0 + ((uint64_t)n % MOD) * (a0 % MOD) + sb) % MOD;
    out[s] = (int64_t)((rb << 16) | ra);
  }
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
                             uint32_t* scratch, int64_t* out,
                             cudaStream_t st) {
  int64_t kmax = (max_len + CHUNK - 1) / CHUNK;
  if (kmax < 1) kmax = 1;
  if (S <= 0 || S > 65535 || kmax > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  adler_chunks<<<dim3((unsigned)kmax, (unsigned)S), THREADS, 0, st>>>(
      base, stride, S, params, kmax, scratch);
  int err = (int)cudaGetLastError();
  if (err) return err;
  adler_finish<<<(unsigned)S, THREADS, 0, st>>>(S, params, kmax, scratch,
                                                out);
  return (int)cudaGetLastError();
}

TBZ_API int tbz_adler32_combine(const int64_t* args, int64_t count,
                                int64_t* out, cudaStream_t st) {
  adler_combine<<<1, THREADS, 0, st>>>(args, count, out);
  return (int)cudaGetLastError();
}
