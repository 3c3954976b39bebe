// Kernel 4 (core) and kernel 7: LZ77 resolve of token tapes by pointer
// doubling, for one tape or a batch of S independent tapes (one per row).
//
// Replaces tbz/ops/resolve.py:_resolve_core (shared there by
// _resolve_impl and the fused _splice_resolve) and, with a row index in
// the grid, tbz/parallel/shard.py:_resolve_batch (_resolve_impl under
// vmap, window stripped). The XLA version maps every output byte to its
// token with a scatter of marks + cumsum and a width-8 row gather (a TPU
// gather workaround); here one thread per token writes its own bytes'
// parent pointers and root values directly.
//
// Coordinates (within a row): [0, W) is the carried window, [W, W + cap)
// the output. A match byte q of a token starting at tstart with distance
// d points at tstart - d + (q - tstart) % d (resolve.py:96: an
// overlapping run collapses to one hop); literal and stored bytes and the
// window point at themselves. Doubling P <- P[P] runs to a fixpoint; the
// output is [window | roots][P].
//
// Bound: bytes. Each doubling pass reads P twice (one coalesced, one
// random gather) and writes it once: 12 x (W + cap) bytes a row a pass,
// over ~log2(genealogy depth) passes. Design: P is double-buffered so a
// pass never reads its own writes and the pass count is deterministic.
// The loop stays on the device: the host enqueues the most passes a
// fixpoint can need (P only points backwards or at itself, so
// ceil(log2(W + cap)) + 1), pass k sets changed[k] if it moved a pointer,
// and pass k > 0 returns at once when changed[k - 1] is unset (one flag a
// pass for the whole batch, so a batch runs as many passes as its deepest
// row). After the last real pass, which changed nothing, both buffers
// hold the fixpoint. Nothing is read back: the pass count stays on the
// device for the caller. Row bases (r x (W + cap), r x T, ...) are
// 64-bit: a bucket of more than 2 GiB of rows overflows int32; within a
// row coordinates stay int32, as in tbz.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PASSES = 64;     // changed[] slots; n < 2^31 needs <= 33
constexpr unsigned PASS_BLOCKS = 1024;  // a row's blocks a pass (grid-stride)

inline unsigned blocks(int64_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

// n_rows (device, one count a row) or, when null, the scalar n_tokens
__global__ void mask_lens(const int32_t* __restrict__ ol, int64_t T,
                          const int32_t* __restrict__ n_rows,
                          int64_t n_tokens, int32_t* lens) {
  const int64_t r = blockIdx.y;
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= T) return;
  const int64_t nt = n_rows ? n_rows[r] : n_tokens;
  lens[r * T + t] = t < nt ? ol[r * T + t] : 0;
}

__global__ void init_parents(int64_t n, int64_t cap, int32_t* P0, int32_t* P1,
                             uint8_t* roots) {
  const int64_t r = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  P0[r * n + i] = (int32_t)i;
  P1[r * n + i] = (int32_t)i;
  if (i >= tbz::W) roots[r * cap + i - tbz::W] = 0;
}

__global__ void expand_tokens(const int32_t* __restrict__ ol,
                              const int32_t* __restrict__ di,
                              const int32_t* __restrict__ rv,
                              const int32_t* __restrict__ starts, int64_t T,
                              const uint8_t* __restrict__ input,
                              int64_t n_input, int64_t cap, int32_t* P,
                              uint8_t* roots) {
  const int64_t r = blockIdx.y;
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= T) return;
  const int64_t k = r * T + t;
  const int n = ol[k];
  if (n <= 0) return;
  const int64_t tstart = starts[k];
  const int d = di[k];
  const int v = rv[k];
  const int64_t hi = (int64_t)tbz::W + cap - 1;
  int32_t* Pr = P + r * (tbz::W + cap);
  uint8_t* rootr = roots + r * cap;
  const uint8_t* in = input + r * n_input;
  for (int j = 0; j < n; ++j) {
    const int64_t q = tstart + j;
    if (q >= cap) break;
    if (d > 0) {
      int64_t p = tstart - d + (j % d) + tbz::W;
      Pr[q + tbz::W] = (int32_t)(p < 0 ? 0 : (p > hi ? hi : p));
    } else if (v & tbz::STORED_FLAG) {
      const int64_t o = (int64_t)(v & (tbz::STORED_FLAG - 1)) + j;
      rootr[q] = o < n_input ? in[o] : 0;
    } else {
      rootr[q] = (uint8_t)v;
    }
  }
}

// pass k: Pb = Pa[Pa] over [W, n) of every row, unless pass k - 1
// changed nothing (then Pa already holds the fixpoint)
__global__ void double_pass(const int32_t* __restrict__ Pa, int32_t* Pb,
                            int64_t n, int32_t* changed, int k) {
  if (k > 0 && !changed[k - 1]) return;  // uniform over the grid
  const int64_t r = blockIdx.y;
  const int32_t* pa = Pa + r * n;
  int32_t* pb = Pb + r * n;
  int moved = 0;
  for (int64_t i = tbz::W + (int64_t)blockIdx.x * THREADS + threadIdx.x;
       i < n; i += (int64_t)gridDim.x * THREADS) {
    const int32_t p = pa[i];
    const int32_t np = pa[p];
    pb[i] = np;
    moved |= np != p;
  }
  if (__syncthreads_or(moved) && threadIdx.x == 0) changed[k] = 1;
}

// passes = 1 + the first k whose pass changed nothing (the real passes)
__global__ void count_passes(const int32_t* changed, int K, int32_t* passes) {
  int k = 0;
  while (k < K && changed[k]) ++k;
  *passes = k + 1;
}

// out row r gets coordinates [lo, n) of row r
__global__ void gather_values(const int32_t* __restrict__ P, int64_t n,
                              int64_t lo, const uint8_t* __restrict__ window,
                              const uint8_t* __restrict__ roots, int64_t cap,
                              uint8_t* out, int64_t out_stride) {
  const int64_t r = blockIdx.y;
  const int64_t i = lo + (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int32_t p = P[r * n + i];
  out[r * out_stride + i - lo] =
      p < tbz::W ? window[r * tbz::W + p] : roots[r * cap + p - tbz::W];
}

int64_t core_ints(int64_t S, int64_t cap) {
  return 2 * S * (tbz::W + cap) + (S * cap + 3) / 4 + MAX_PASSES;
}

// Resolve S rows whose masked lengths `ol` have the exclusive scans
// `starts`; row r of `out` (stride out_stride) gets coordinates [lo, W+cap)
// and *passes (device) the doubling pass count.
int resolve_rows(const int32_t* ol, const int32_t* di, const int32_t* rv,
                 const int32_t* starts, int64_t S, int64_t T,
                 const uint8_t* input, int64_t n_input,
                 const uint8_t* window, int64_t cap, uint8_t* out,
                 int64_t lo, int64_t out_stride, int32_t* scratch,
                 int32_t* passes, cudaStream_t s) {
  const int64_t n = tbz::W + cap;
  if (n > 0x7FFFFFFF || S <= 0 || S > 65535)
    return (int)cudaErrorInvalidValue;
  const unsigned rows = (unsigned)S;
  int32_t* P0 = scratch;
  int32_t* P1 = scratch + S * n;
  uint8_t* roots = reinterpret_cast<uint8_t*>(scratch + 2 * S * n);
  int32_t* changed = scratch + 2 * S * n + (S * cap + 3) / 4;
  init_parents<<<dim3(blocks(n), rows), THREADS, 0, s>>>(n, cap, P0, P1,
                                                          roots);
  if (T > 0)
    expand_tokens<<<dim3(blocks(T), rows), THREADS, 0, s>>>(
        ol, di, rv, starts, T, input, n_input, cap, P0, roots);
  cudaMemsetAsync(changed, 0, MAX_PASSES * sizeof(int32_t), s);
  int err = (int)cudaGetLastError();
  if (err) return err;
  // chains are shorter than n, so ceil(log2 n) passes reach every root
  // and one more finds nothing to change
  int K = 1;
  while (((int64_t)1 << (K - 1)) < n) ++K;
  const unsigned pb = blocks(cap) < PASS_BLOCKS ? blocks(cap) : PASS_BLOCKS;
  for (int k = 0; k < K; ++k) {
    double_pass<<<dim3(pb, rows), THREADS, 0, s>>>(k % 2 ? P1 : P0,
                                                   k % 2 ? P0 : P1, n,
                                                   changed, k);
  }
  count_passes<<<1, 1, 0, s>>>(changed, K, passes);
  gather_values<<<dim3(blocks(n - lo), rows), THREADS, 0, s>>>(
      P0, n, lo, window, roots, cap, out, out_stride);
  return (int)cudaGetLastError();
}

}  // namespace

int64_t tbz_resolve_core_scratch_ints(int64_t cap) { return core_ints(1, cap); }

int tbz_resolve_from_starts(const int32_t* ol, const int32_t* di,
                            const int32_t* rv, const int32_t* starts,
                            int64_t T, const uint8_t* input, int64_t n_input,
                            const uint8_t* window, int64_t cap, uint8_t* out,
                            int32_t* scratch, int32_t* passes,
                            cudaStream_t s) {
  return resolve_rows(ol, di, rv, starts, 1, T, input, n_input, window, cap,
                      out, 0, tbz::W + cap, scratch, passes, s);
}

TBZ_API int64_t tbz_resolve_scratch_ints(int64_t T, int64_t cap) {
  return 2 * T + tbz_scan_scratch_ints(T) + core_ints(1, cap);
}

TBZ_API int tbz_resolve(const int32_t* ol, const int32_t* di,
                        const int32_t* rv, int64_t n_tokens, int64_t T,
                        const uint8_t* input, int64_t n_input,
                        const uint8_t* window, int64_t cap, uint8_t* out,
                        int32_t* scratch, int32_t* passes, cudaStream_t s) {
  int32_t* lens = scratch;
  int32_t* starts = scratch + T;
  int32_t* scan_scratch = scratch + 2 * T;
  int32_t* core = scan_scratch + tbz_scan_scratch_ints(T);
  if (T > 0)
    mask_lens<<<blocks(T), THREADS, 0, s>>>(ol, T, nullptr, n_tokens, lens);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = tbz_exclusive_scan(lens, starts, T, nullptr, scan_scratch, s);
  if (err) return err;
  return tbz_resolve_from_starts(lens, di, rv, starts, T, input, n_input,
                                 window, cap, out, core, passes, s);
}

TBZ_API int64_t tbz_resolve_batch_scratch_ints(int64_t S, int64_t T,
                                               int64_t cap) {
  return 2 * S * T + tbz_scan_scratch_ints(T) + core_ints(S, cap);
}

// Kernel 7: S tapes int32[S, T] (row r valid below n_tokens[r], a device
// array), stored runs read from input uint8[S, n_input], windows
// uint8[S, W]; out uint8[S, cap] holds each row's output, window stripped.
TBZ_API int tbz_resolve_batch(const int32_t* ol, const int32_t* di,
                              const int32_t* rv, const int32_t* n_tokens,
                              int64_t S, int64_t T, const uint8_t* input,
                              int64_t n_input, const uint8_t* window,
                              int64_t cap, uint8_t* out, int32_t* scratch,
                              int32_t* passes, cudaStream_t s) {
  if (S <= 0 || S > 65535 || T <= 0) return (int)cudaErrorInvalidValue;
  int32_t* lens = scratch;
  int32_t* starts = scratch + S * T;
  int32_t* scan_scratch = scratch + 2 * S * T;
  int32_t* core = scan_scratch + tbz_scan_scratch_ints(T);
  mask_lens<<<dim3(blocks(T), (unsigned)S), THREADS, 0, s>>>(
      ol, T, n_tokens, 0, lens);
  int err = (int)cudaGetLastError();
  if (err) return err;
  for (int64_t r = 0; r < S; ++r) {
    err = tbz_exclusive_scan(lens + r * T, starts + r * T, T, nullptr,
                             scan_scratch, s);
    if (err) return err;
  }
  return resolve_rows(lens, di, rv, starts, S, T, input, n_input, window,
                      cap, out, tbz::W, cap, core, passes, s);
}
