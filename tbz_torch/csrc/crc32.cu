// Kernel 5: CRC-32 (zlib's reflected polynomial) of a byte range of each
// row, continuing from a previous CRC; and crc32_combine.
//
// Replaces tbz/checksums.py:_crc32_device (:320, the last n bytes),
// _crc32_device_tail (:425, the first n bytes), the square-and-multiply
// shifts _crc_shift_dynamic_device (:175) and _crc_unshift_dynamic_device
// (:366), crc32_combine_device (:442), and the vmapped
// tbz/parallel/shard.py:_crc_batch (:46). The XLA version computes each
// 128-byte lane's CRC as one bit-matrix product on the MXU and undoes the
// trailing padding with inverse matrices; here a table walk does the
// bytes and only the range's own bytes are read.
//
// Math: with L(X) the register after X from a zero init,
// L(X || Y) = L(X)·x^(8|Y|) ^ L(Y), leading zero bytes leave L unchanged,
// and crc32(X, prev) = ~(L(X) ^ (~prev)·x^(8|X|)). The range [off, off+n)
// of a row is read as if front-padded with zeros to K whole 32 KiB chunks
// (positions below the pad read as 0; no byte outside the range is read).
// A shift by x^(8m) applies the power matrices x^(8·2^k) of the set bits
// of m, a 64-bit byte count (tbz holds 8m in uint32, which wraps at
// m = 2^29 bytes).
//
// Bound: bytes (n read once a row, 8 bytes written). Design: pass 1, one
// block per 32 KiB chunk, stages the chunk in shared memory with
// coalesced loads; each thread walks its 128 bytes through a 256-entry
// shared table, shifts its CRC by x^(8·128·(255 - t)) and the block
// xor-reduces; pass 2, one block per row, folds the chunk CRCs in order
// (a Horner run per thread, then one shift and an xor-reduce) and
// conditions on prev. The table walk is a dependent chain of shared-memory
// lookups (latency, not bandwidth, limits it); slicing-by-8 or a
// carry-less multiply fold is later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LOG_SUB = 7;
constexpr int SUB = 1 << LOG_SUB;          // bytes a thread walks
constexpr int STRIDE = SUB + 4;            // shared row stride: no bank conflicts
constexpr int LOG_CHUNK = 15;
constexpr int CHUNK = 1 << LOG_CHUNK;      // = THREADS * SUB
static_assert(CHUNK == THREADS * SUB, "chunk = threads x sub-chunk");

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
  return v;  // valid in thread 0
}

// params: int64[3, S] = (offset, length, prev) of each row
__global__ void crc_chunks(const uint8_t* __restrict__ base, int64_t stride,
                           int64_t S, const int64_t* __restrict__ params,
                           const uint32_t* __restrict__ mats, int64_t kmax,
                           uint32_t* __restrict__ partial) {
  __shared__ uint32_t table[256];
  __shared__ uint32_t smat[8 * 32];  // x^(8·SUB·2^j), j < 8
  __shared__ uint8_t buf[THREADS * STRIDE];
  __shared__ uint32_t warp[THREADS / 32];
  const int64_t s = blockIdx.y;
  const int64_t c = blockIdx.x;
  const int64_t n = params[S + s];
  const int64_t K = (n + CHUNK - 1) / CHUNK;
  if (c >= K) return;  // uniform over the block
  const int t = threadIdx.x;
  uint32_t e = t;
#pragma unroll
  for (int b = 0; b < 8; ++b) e = (e >> 1) ^ (0xEDB88320u & (0u - (e & 1u)));
  table[t] = e;
  smat[t] = mats[32 * LOG_SUB + t];
  const int64_t pad = K * CHUNK - n;
  const uint8_t* row = base + s * stride + params[s];
  const int64_t p0 = c * CHUNK;
  for (int i = t; i < CHUNK; i += THREADS) {
    const int64_t p = p0 + i;
    buf[(i >> LOG_SUB) * STRIDE + (i & (SUB - 1))] =
        p >= pad ? row[p - pad] : 0;
  }
  __syncthreads();
  uint32_t crc = 0;
  const uint8_t* mine = buf + t * STRIDE;
#pragma unroll 8
  for (int j = 0; j < SUB; ++j) crc = table[(crc ^ mine[j]) & 0xFF] ^ (crc >> 8);
  const int r = THREADS - 1 - t;  // sub-chunks after this one
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if ((r >> j) & 1) crc = gf2_times(smat + 32 * j, crc);
  crc = block_xor(crc, warp);
  if (t == 0) partial[s * kmax + c] = crc;
}

__global__ void crc_finish(int64_t S, const int64_t* __restrict__ params,
                           const uint32_t* __restrict__ mats, int64_t kmax,
                           const uint32_t* __restrict__ partial,
                           int64_t* __restrict__ out) {
  __shared__ uint32_t mchunk[32];  // x^(8·CHUNK)
  __shared__ uint32_t warp[THREADS / 32];
  const int64_t s = blockIdx.x;
  const int t = threadIdx.x;
  if (t < 32) mchunk[t] = mats[32 * LOG_CHUNK + t];
  __syncthreads();
  const int64_t n = params[S + s];
  const int64_t K = (n + CHUNK - 1) / CHUNK;
  const int64_t per = (K + THREADS - 1) / THREADS;
  const int64_t lo = min(K, t * per), hi = min(K, lo + per);
  uint32_t acc = 0;
  for (int64_t c = lo; c < hi; ++c)
    acc = gf2_times(mchunk, acc) ^ partial[s * kmax + c];
  acc = shift_bytes(mats, acc, (uint64_t)(K - hi) * CHUNK);
  acc = block_xor(acc, warp);
  if (t == 0) {
    const uint32_t prev = (uint32_t)params[2 * S + s];
    const uint32_t init = shift_bytes(mats, ~prev, (uint64_t)n);
    out[s] = (int64_t)(uint32_t)~(acc ^ init);
  }
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

int64_t chunks_of(int64_t max_len) {
  const int64_t k = (max_len + CHUNK - 1) / CHUNK;
  return k > 0 ? k : 1;
}

}  // namespace

// int32 scratch of kernels 5 and 6 (Adler keeps two words a chunk)
TBZ_API int64_t tbz_checksum_scratch_ints(int64_t S, int64_t max_len) {
  return 2 * S * chunks_of(max_len);
}

TBZ_API int tbz_crc32_rows(const uint8_t* base, int64_t stride, int64_t S,
                           const int64_t* params, int64_t max_len,
                           const uint32_t* mats, uint32_t* scratch,
                           int64_t* out, cudaStream_t st) {
  const int64_t kmax = chunks_of(max_len);
  if (S <= 0 || S > 65535 || kmax > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  crc_chunks<<<dim3((unsigned)kmax, (unsigned)S), THREADS, 0, st>>>(
      base, stride, S, params, mats, kmax, scratch);
  int err = (int)cudaGetLastError();
  if (err) return err;
  crc_finish<<<(unsigned)S, THREADS, 0, st>>>(S, params, mats, kmax, scratch,
                                              out);
  return (int)cudaGetLastError();
}

TBZ_API int tbz_crc32_combine(const int64_t* args, int64_t count,
                              const uint32_t* mats, int64_t* out,
                              cudaStream_t st) {
  crc_combine<<<1, THREADS, 0, st>>>(args, count, mats, out);
  return (int)cudaGetLastError();
}
