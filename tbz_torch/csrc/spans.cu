// The flat span resolver: LZ77 resolve of a host-planned span list.
//
// Replaces tbz/ops/resolve_spans.py:145 _resolve_flat_impl (and its :56
// _barrel_contrib). There, each slot of a (G row-groups x K slots) batch
// fetches its 128-byte source row, rotates it by (a - o) & 127, masks it
// to [o, o + ln), reduces the K slots of a group and scatter-adds the
// group into a segment-local accumulator: the TPU's row-gather fast path.
// The planner (native/frontend.cc tbz_plan_spans_flat) guarantees that
// a + ln <= 128 (the rotate never wraps), that no slot overlaps a
// prefilled literal byte or another slot, and that a batch reads only
// bytes written before it (earlier batches, earlier segments, the
// prefill, the window). So the masked, rotated frame is a plain copy:
// destination byte (base + g_row) * 128 + o + j takes table byte
// srcaddr + j, for 0 <= j < ln, and batches that run in order straight
// into the table give tbz's bytes without an accumulator.
//
// Bound: bytes (the prefilled output and the window read once, 6 B a
// slot and 4 B a group of plan read, the output written). Design: the
// table [256 window rows | output rows] is filled with two device
// copies, then one launch a batch (the stream orders them), one warp a
// slot, each lane copying bytes j, j + 32, ... of the span. Batches
// outside every segment's range (tbz's shape padding) are never
// launched.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
flat_batch(const int32_t* __restrict__ srcaddr,
           const int16_t* __restrict__ lenoff,
           const int32_t* __restrict__ g_rows, int G, int K, int64_t base,
           uint8_t* table) {
  const int64_t slot = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (slot >= (int64_t)G * K) return;
  const int lo = lenoff[slot] & 0xFFFF;
  const int ln = lo & 255;
  if (ln == 0) return;
  const int o = (lo >> 8) & 127;
  const int64_t src = srcaddr[slot];
  const int64_t dst = (base + g_rows[slot / K]) * 128 + o;
  for (int j = lane; j < ln; j += 32) table[dst + j] = table[src + j];
}

}  // namespace

TBZ_API int tbz_resolve_flat(const int32_t* srcaddr, const int16_t* lenoff,
                             const int32_t* g_rows, int64_t G, int64_t K,
                             const int32_t* seg_lo, const int32_t* seg_hi,
                             const int32_t* seg_base, int64_t S,
                             const uint8_t* window, const uint8_t* out0,
                             int64_t n_out, uint8_t* table, cudaStream_t s) {
  cudaError_t e = cudaMemcpyAsync(table, window, tbz::W,
                                  cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyAsync(table + tbz::W, out0, (size_t)n_out,
                      cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return (int)e;
  const int64_t slots = G * K;
  const unsigned blocks = (unsigned)((slots + WARPS - 1) / WARPS);
  for (int64_t sg = 0; sg < S; ++sg) {   // seg_* are host arrays
    for (int64_t b = seg_lo[sg]; b < seg_hi[sg]; ++b) {
      flat_batch<<<blocks, THREADS, 0, s>>>(
          srcaddr + b * slots, lenoff + b * slots, g_rows + b * G, (int)G,
          (int)K, (int64_t)seg_base[sg], table);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}
