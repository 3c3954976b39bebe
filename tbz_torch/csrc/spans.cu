// The flat span resolver: LZ77 resolve of a host-planned span list.
//
// Replaces tbz/ops/resolve_spans.py:145 _resolve_flat_impl (and its :56
// _barrel_contrib). There, each slot of a (G row-groups x K slots) batch
// fetches its 128-byte source row, rotates it by (a - o) & 127, masks it
// to [o, o + ln), reduces the K slots of a group and scatter-adds the
// group into a segment-local accumulator, batch after batch: the TPU's
// row-gather fast path. The planner (native/frontend.cc
// tbz_plan_spans_flat) guarantees that a + ln <= 128 (the rotate never
// wraps), that every table byte is written by at most one slot and no
// slot writes a prefilled byte, and that a batch reads only bytes that
// are final before it. So destination byte (base + g_row) * 128 + o + j
// has exactly one parent, table byte srcaddr + j, which lies before it
// (the planner's sources are LZ77 sources or their ancestors), the plan
// is a forest, and its result does not depend on the order of the
// batches.
//
// Bound: bytes (the prefilled output and the window read once, 6 B a
// live slot and 4 B a group of plan read, the output written): ~0.09 ms
// for the 64 MiB static plan. The old design launched one kernel a batch
// from a host loop (2,963 at 64 MiB, ~5 us each): 13.85 ms. This design
// resolves the whole plan in three launches and a memset, with
// resolve.cu's machinery:
//  - init_table: every table byte [window | out0] becomes a root word;
//  - expand_slots: a warp takes 32 slots, scans their lengths and writes
//    their bytes' pointer words (back = dst - src) 32 bytes at a time,
//    each lane finding its slot by a binary search of the scan held in
//    the warp's registers; a batch's segment base comes from batch_base
//    (one int32 a batch, -1 for tbz's shape padding, uploaded by the
//    wrapper);
//  - tbz_doubling (resolve.cu): the cooperative doubling (its passes
//    after the first read only the 32-word groups that still hold a
//    pointer), then one coalesced pass writes the output rows. The
//    pass count is not needed.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// every table byte a root
__global__ void init_table(const uint8_t* __restrict__ window,
                           const uint8_t* __restrict__ out0, int64_t n_out,
                           uint32_t* A) {
  const int64_t n = tbz::W + n_out;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * THREADS)
    A[i] = tbz::root_word(i < tbz::W ? window[i] : out0[i - tbz::W]);
}

__global__ void __launch_bounds__(THREADS)
expand_slots(const int32_t* __restrict__ srcaddr,
             const int16_t* __restrict__ lenoff,
             const int32_t* __restrict__ g_rows,
             const int32_t* __restrict__ batch_base, int64_t NB, int G,
             int K, int64_t n_table, uint32_t* A) {
  const int64_t per_batch = (int64_t)G * K;
  const int64_t warp0 = ((int64_t)blockIdx.x * THREADS + threadIdx.x) & ~31ll;
  if (warp0 >= NB * per_batch) return;   // uniform over the warp
  const int64_t slot = warp0 + (threadIdx.x & 31);
  const int lane = threadIdx.x & 31;
  int ln = 0;
  long long src = 0, dst = 0;
  if (slot < NB * per_batch) {
    const int lo = lenoff[slot] & 0xFFFF;
    ln = lo & 255;
    const int64_t b = slot / per_batch;
    const int32_t base = ln ? batch_base[b] : -1;
    if (base < 0) {
      ln = 0;
    } else {
      const int64_t g = (slot - b * per_batch) / K;
      dst = ((int64_t)base + g_rows[b * G + g]) * 128 + ((lo >> 8) & 127);
      src = srcaddr[slot];
    }
  }
  int inc = ln;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += v;
  }
  const int total = __shfl_sync(FULL, inc, 31);
  const int exc = inc - ln;
  for (int k0 = 0; k0 < total; k0 += 32) {
    const int k = k0 + lane;
    // the slot of byte k: the number of lanes whose inclusive sum is <= k
    int at = 0;
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1) {
      if (__shfl_sync(FULL, inc, at + step - 1) <= k) at += step;
    }
    const long long s = __shfl_sync(FULL, src, at);
    const long long d = __shfl_sync(FULL, dst, at);
    const int j = k - __shfl_sync(FULL, exc, at);
    if (k < total && d > s && s + j >= 0 && d + j < n_table)
      A[d + j] = (uint32_t)(d - s);
  }
}

}  // namespace

TBZ_API int64_t tbz_resolve_flat_scratch_ints(int64_t n_out) {
  return tbz_doubling_scratch_ints(tbz::W + n_out);
}

// batch_base: int32[NB] on the device, each batch's segment base row (-1:
// in no segment). out: uint8[n_out], the output rows (window stripped).
TBZ_API int tbz_resolve_flat(const int32_t* srcaddr, const int16_t* lenoff,
                             const int32_t* g_rows, int64_t NB, int64_t G,
                             int64_t K, const int32_t* batch_base,
                             const uint8_t* window, const uint8_t* out0,
                             int64_t n_out, uint8_t* out, int32_t* scratch,
                             cudaStream_t s) {
  const int64_t n = tbz::W + n_out;
  if (n > 0x7FFFFFFF || n_out < 0 || G <= 0 || K <= 0 || NB < 0)
    return (int)cudaErrorInvalidValue;
  uint32_t* A = tbz_doubling_words(scratch);
  const int64_t nb = (n + THREADS - 1) / THREADS;
  init_table<<<(unsigned)(nb < 4096 ? nb : 4096), THREADS, 0, s>>>(
      window, out0, n_out, A);
  const int64_t slots = NB * G * K;
  if (slots > 0)
    expand_slots<<<(unsigned)((slots + THREADS - 1) / THREADS), THREADS, 0,
                   s>>>(srcaddr, lenoff, g_rows, batch_base, NB, (int)G,
                        (int)K, n, A);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return tbz_doubling(scratch, 1, n, tbz::W, out, nullptr, s);
}
