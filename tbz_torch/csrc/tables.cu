// Kernel 1: flat 2^15-entry Huffman decode tables for all B candidate
// blocks of a stream, litlen and distance, in one launch.
//
// Replaces tbz/ops/tokenize_device.py:build_flat_table (vmapped at
// tbz/ops/batched.py:179-182). The build itself is flat_table.cuh's
// block-wide builder (shared with inflate.cu); litlen and distance
// tables take zlib's single-1-bit exception (allow_single), as tbz's
// batched decode builds them.
//
// Bound: bytes. Per table 2^15 x 4 output bytes dominate (lengths are
// <= 288 ints); 2B tables of 128 KB each. Design: one block per table
// (grid B x 2), the table is assembled in 128 KB of dynamic shared memory
// (no uncoalesced global scatter), then copied out with coalesced stores.
#include "flat_table.cuh"

namespace {

constexpr int THREADS = 1024;

__global__ void __launch_bounds__(THREADS)
build_tables(const int32_t* __restrict__ lit_lens,
             const int32_t* __restrict__ dist_lens,
             const uint32_t* __restrict__ lit_c,
             const uint32_t* __restrict__ dist_c,
             int32_t* lit_tabs, int32_t* dist_tabs,
             int32_t* lit_errs, int32_t* dist_errs) {
  extern __shared__ uint32_t tab[];  // TSIZE entries
  __shared__ tbz::FlatTableScratch sc;

  const int b = blockIdx.x;
  const bool is_lit = blockIdx.y == 0;
  const int n_syms = is_lit ? 288 : 32;
  const int32_t* src = is_lit ? lit_lens + (int64_t)b * 288
                              : dist_lens + (int64_t)b * 32;
  int32_t* out = (is_lit ? lit_tabs : dist_tabs) + ((int64_t)b << tbz::TBITS);

  tbz::build_flat_table_block(src, n_syms, is_lit ? lit_c : dist_c,
                              /*allow_single=*/true, tab, sc);
  if (threadIdx.x == 0) (is_lit ? lit_errs : dist_errs)[b] = sc.err;
  for (int i = threadIdx.x; i < tbz::TSIZE; i += THREADS)
    out[i] = (int32_t)tab[i];
}

}  // namespace

TBZ_API int tbz_build_tables(const int32_t* lit_lens, const int32_t* dist_lens,
                             int64_t B, const uint32_t* lit_c,
                             const uint32_t* dist_c, int32_t* lit_tabs,
                             int32_t* dist_tabs, int32_t* lit_errs,
                             int32_t* dist_errs, cudaStream_t s) {
  const int smem = tbz::TSIZE * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      build_tables, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0) return 0;
  build_tables<<<dim3((unsigned)B, 2), THREADS, smem, s>>>(
      lit_lens, dist_lens, lit_c, dist_c, lit_tabs, dist_tabs, lit_errs,
      dist_errs);
  return (int)cudaGetLastError();
}
