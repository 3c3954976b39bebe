// Kernel 4: splice + distance check + resolve, in one call.
//
// Replaces tbz/ops/fused.py:_splice_resolve. The host chain walk emits a
// range plan: range r covers token-chain slots [dst[r], dst[r+1]); kind 0
// reads the on-device compact tape at src[r] + (i - dst[r]), kind 1 the
// uploaded host-token rows (stored runs, static blocks, junction joins).
// The XLA version finds each slot's range with a scatter of marks +
// cumsum and width-8 row gathers (TPU gather workarounds); here each
// slot binary-searches the sorted range starts and reads its token
// fields directly.
//
// Then: pref = exclusive scan of the lengths (scan.cu), first_bad = the
// first token with dist > pref + window_len (zlib's "distance too far
// back", in chain order, by atomicMin), and the resolve core
// (resolve.cu) on the same scan. Output: u8[4 + W + cap] =
// [first_bad int32 | window | output].
//
// Bound: bytes. The splice reads each compact token once and writes the
// three token arrays (12 bytes a token); the resolve core dominates (see
// resolve.cu).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

inline unsigned blocks(int64_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

__global__ void splice_tokens(const int32_t* __restrict__ compact,
                              int64_t n_compact,
                              const int32_t* __restrict__ rng_dst,
                              const int32_t* __restrict__ rng_src,
                              const int32_t* __restrict__ rng_kind, int R,
                              const int32_t* __restrict__ h_ol,
                              const int32_t* __restrict__ h_di,
                              const int32_t* __restrict__ h_rv, int H,
                              int64_t n_total, int64_t T, int32_t* ol,
                              int32_t* di, int32_t* rv) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= T) return;
  if (i >= n_total) {
    ol[i] = di[i] = rv[i] = 0;
    return;
  }
  // range id: the last range whose dst <= i (dst ascending; padding
  // ranges carry dst = T)
  int lo = 0, hi = R;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rng_dst[mid] <= i) lo = mid + 1; else hi = mid;
  }
  const int r = lo > 0 ? lo - 1 : 0;
  const int64_t pos = (int64_t)rng_src[r] + (i - rng_dst[r]);
  int o, d, v;
  if (rng_kind[r] == 1) {
    const int64_t h = pos < 0 ? 0 : (pos >= H ? H - 1 : pos);
    o = h_ol[h];
    d = h_di[h];
    v = h_rv[h];
  } else {
    const int tok = (pos >= 0 && pos < n_compact) ? compact[pos] : 0;
    o = tok & 0x1FF;
    const int fld = tok >> 9;
    d = o == 1 ? 0 : fld + 1;
    v = o == 1 ? fld : 0;
  }
  ol[i] = o;
  di[i] = o > 0 ? d : 0;
  rv[i] = v;
}

__global__ void set_big(int32_t* p) { *p = tbz::BIG; }

__global__ void find_first_bad(const int32_t* __restrict__ di,
                               const int32_t* __restrict__ pref, int64_t T,
                               int64_t window_len, int32_t* first_bad) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= T) return;
  const int d = di[i];
  if (d > 0 && d > (int64_t)pref[i] + window_len)
    atomicMin(first_bad, (int32_t)i);
}

}  // namespace

TBZ_API int64_t tbz_splice_scratch_ints(int64_t T, int64_t cap) {
  return 4 * T + 1 + tbz_scan_scratch_ints(T) +
         tbz_resolve_core_scratch_ints(cap);
}

TBZ_API int tbz_splice_resolve(
    const int32_t* compact, int64_t n_compact, const int32_t* rng_dst,
    const int32_t* rng_src, const int32_t* rng_kind, int R,
    const int32_t* h_ol, const int32_t* h_di, const int32_t* h_rv, int H,
    int64_t n_total, int64_t window_len, int64_t T, const uint8_t* input,
    int64_t n_input, const uint8_t* window, int64_t cap, uint8_t* out,
    int32_t* scratch, int32_t* passes, cudaStream_t s) {
  if (T <= 0 || R <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  int32_t *ol = scratch, *di = scratch + T, *rv = scratch + 2 * T,
          *pref = scratch + 3 * T, *first_bad = scratch + 4 * T,
          *scan_scratch = scratch + 4 * T + 1;
  int32_t* core = scan_scratch + tbz_scan_scratch_ints(T);
  // only the chain's n_total slots are assembled, scanned and resolved
  const int64_t nt = n_total < 0 ? 0 : (n_total < T ? n_total : T);
  if (nt > 0)
    splice_tokens<<<blocks(nt), THREADS, 0, s>>>(
        compact, n_compact, rng_dst, rng_src, rng_kind, R, h_ol, h_di, h_rv,
        H, nt, nt, ol, di, rv);
  set_big<<<1, 1, 0, s>>>(first_bad);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = tbz_exclusive_scan(ol, pref, nt, nullptr, scan_scratch, s);
  if (err) return err;
  if (nt > 0)
    find_first_bad<<<blocks(nt), THREADS, 0, s>>>(di, pref, nt, window_len,
                                                  first_bad);
  cudaMemcpyAsync(out, first_bad, sizeof(int32_t), cudaMemcpyDeviceToDevice,
                  s);
  err = (int)cudaGetLastError();
  if (err) return err;
  return tbz_resolve_from_starts(ol, di, rv, pref, nt, input, n_input, window,
                                 cap, out + 4, core, passes, s);
}
