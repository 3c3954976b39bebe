// Kernel 3: lane stitch + token compaction.
//
// Replaces the stitch lax.scan and the compaction of
// tbz/ops/batched.py:_batched_kernel (lines 191-297). Output is the flat
// int32 buffer that tbz_torch/ops/batched.py:_parse_meta reads:
//   [mpos L | nv L | flags L | handoff L | exits L | off L | nbytes L |
//    lit_errs B | dist_errs B | total 1] + compact[n_out + 1]
// (exits and the err words are written there by kernels 2 and 1).
//
// Bound: bytes. The passes read the lane tape (3 x L x S int32, [S, L]
// layout) about twice and write the compact tape once.
//
// The stitch's sequential carry over lanes (tail, cur_seg, state) is
// taken apart, so that every pass runs in parallel over the lanes:
// - Lane l's tail is lane l-1's last TAIL starts below its n_syms, masked
//   by ti >= mpos[l-1], or the one-element virtual tail seg_sym[l] where l
//   opens a segment (a run of equal seg_id). A skipped lane never merges
//   (skip lasts to the end of its segment), so the tail a lane that can
//   merge meets is always its predecessor's.
// - A lane's emitted starts strictly increase and end at its first -1
//   (the lane kernel's tape), so head and tail are sorted and the first hit
//   (smallest head index m) is a sorted intersection: `match_lanes` gives
//   each lane a warp, stages head and tail in shared memory and binary-
//   searches the tail for each head start, without the mask.
// - The mask can remove that hit only if its tail index ti is below
//   mpos[l-1], which is 0 or one of lane l-1's own unmasked hits, so at
//   most hmax[l-1], the largest head index of those hits. Lanes with
//   ti < hmax[l-1] ("suspect") are rare; `carry_fix` walks each run of
//   consecutive suspect lanes in one thread from its known predecessor
//   and redoes the intersection with the mask by a merge where the mask
//   bites.
// - Skip is a per-segment fact: lane l skips iff an earlier lane of its
//   segment merged at an end-of-block. The exclusive scan of the segment-
//   start flags numbers the segments (slot 0 holds lanes before the
//   first start); each merging end-of-block lane atomicMin's its index
//   into its segment's slot; `finalize` compares.
// The compaction gives each lane a warp (its stores coalesced).
#include "common.cuh"

namespace {

constexpr int HEAD = 96;
constexpr int TAIL = 144;
constexpr int F_MERGED = 1, F_SKIP = 2, F_DEAD = 4, F_EOB = 8;
constexpr int THREADS = 128;  // thread-per-lane passes
constexpr int WARPS = 8;      // warp-per-lane passes: 8 lanes a block
constexpr unsigned NO_KEY = 0xFFFFFFFFu;

__global__ void lane_summary(const int32_t* __restrict__ starts,
                             const int32_t* __restrict__ packed,
                             const int32_t* __restrict__ ok,
                             const int32_t* __restrict__ tbl_idx,
                             const int32_t* __restrict__ lit_errs,
                             const int32_t* __restrict__ dist_errs, int L,
                             int S, int32_t* n_syms, int32_t* has_eob,
                             int32_t* usable) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  if (l >= L) return;
  int n = 0;
  for (int s = 0; s < S; ++s) n += starts[(int64_t)s * L + l] >= 0;
  int last = n - 1;
  last = last < 0 ? 0 : (last > S - 1 ? S - 1 : last);
  const int tb = tbl_idx[l];
  n_syms[l] = n;
  has_eob[l] = n > 0 && ((packed[(int64_t)last * L + l] >> 17) & 1);
  usable[l] = ok[l] && lit_errs[tb] == 0 && dist_errs[tb] == 0;
}

__device__ __forceinline__ int tail_base(int n, int S) {
  const int b = n - TAIL;
  return b < 0 ? 0 : (b > S - TAIL ? S - TAIL : b);
}

// Pass 1, a warp a lane: the first hit of the lane's head against its
// unmasked tail. Writes hm (head index or -1), hti (the hit's tail index
// in the predecessor's tape), hv (the start there or -1), hmax (the
// largest head index of any hit, or -1), new_seg, and clears the segment
// slots.
__global__ void __launch_bounds__(WARPS * 32)
match_lanes(const int32_t* __restrict__ starts,
            const int32_t* __restrict__ seg_id,
            const int32_t* __restrict__ seg_sym,
            const int32_t* __restrict__ n_syms, int L, int S, int32_t* hm,
            int32_t* hti, int32_t* hv, int32_t* hmax, int32_t* new_seg,
            int32_t* first) {
  __shared__ int head_s[WARPS][HEAD];
  __shared__ int tail_s[WARPS][TAIL];
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int l = blockIdx.x * WARPS + w;
  if (l >= L) return;  // the whole warp
  int* head = head_s[w];
  int* tail = tail_s[w];
  const bool ns = seg_id[l] != (l > 0 ? seg_id[l - 1] : -1);
  for (int m = t; m < HEAD; m += 32) {
    const int v = starts[(int64_t)m * L + l];
    head[m] = v < 0 ? tbz::BIG : v;
  }
  int base = 0;
  if (!ns && l == 0) {  // no segment opens at lane 0: an empty tail
    for (int i = t; i < TAIL; i += 32) tail[i] = tbz::BIG;
  } else if (!ns) {
    const int np = n_syms[l - 1];
    base = tail_base(np, S);
    for (int i = t; i < TAIL; i += 32) {
      const int ti = base + i;
      const int v = starts[(int64_t)ti * L + l - 1];
      tail[i] = ti < np && v >= 0 ? v : tbz::BIG;
    }
  }
  __syncwarp();
  const int vsym = seg_sym[l];
  unsigned key = NO_KEY;
  int last = -1;
  for (int m = t; m < HEAD; m += 32) {
    const int h = head[m];
    if (h == tbz::BIG) continue;
    int k = -1;
    if (ns) {
      k = h == vsym ? 0 : -1;
    } else {
      int lo = 0, hi = TAIL;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (tail[mid] < h) lo = mid + 1;
        else hi = mid;
      }
      k = lo < TAIL && tail[lo] == h ? lo : -1;
    }
    if (k >= 0) {
      if (key == NO_KEY) key = (unsigned)(m * TAIL + k);  // heads ascend
      last = m;
    }
  }
  key = __reduce_min_sync(0xffffffffu, key);
  last = __reduce_max_sync(0xffffffffu, last);
  if (t == 0) {
    const bool hit = key != NO_KEY;
    const int m = hit ? (int)(key / TAIL) : -1;
    const int ti = hit ? base + (int)(key % TAIL) : 0;
    hm[l] = m;
    hti[l] = ti;
    hv[l] = hit ? head[m] : -1;
    hmax[l] = last;
    new_seg[l] = ns;
    first[l + 1] = tbz::BIG;
    if (l == 0) first[0] = tbz::BIG;
  }
}

// A thread a lane: sus[l] when the mask ti >= mpos[l-1] may remove lane
// l's hit, i.e. its tail index lies below lane l-1's largest hit.
__global__ void mark_suspects(const int32_t* __restrict__ hm,
                              const int32_t* __restrict__ hti,
                              const int32_t* __restrict__ hmax,
                              const int32_t* __restrict__ new_seg,
                              const int32_t* __restrict__ usable, int L,
                              int32_t* sus) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  if (l >= L) return;
  const int bound = l > 0 && usable[l - 1] ? hmax[l - 1] : 0;
  sus[l] = !new_seg[l] && hm[l] >= 0 && hti[l] < bound;
}

__device__ __forceinline__ void note_eob(int j, const int32_t* usable,
                                         const int32_t* has_eob,
                                         const int32_t* hm,
                                         const int32_t* new_seg,
                                         const int32_t* seg_excl,
                                         int32_t* first) {
  if (usable[j] && hm[j] >= 0 && has_eob[j])
    atomicMin(&first[seg_excl[j] + new_seg[j]], j);
}

// Pass 2, a thread a lane: each run of suspect lanes is walked by the
// thread of its first lane, from the merge point of its predecessor
// (never suspect, so final); the other threads note their own lane.
__global__ void carry_fix(const int32_t* __restrict__ starts,
                          const int32_t* __restrict__ n_syms,
                          const int32_t* __restrict__ usable,
                          const int32_t* __restrict__ has_eob,
                          const int32_t* __restrict__ new_seg,
                          const int32_t* __restrict__ sus,
                          const int32_t* __restrict__ seg_excl, int L,
                          int S, int32_t* hm, int32_t* hti, int32_t* hv,
                          int32_t* first) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  if (l >= L) return;
  if (!sus[l]) {
    note_eob(l, usable, has_eob, hm, new_seg, seg_excl, first);
    return;
  }
  if (sus[l - 1]) return;  // suspect lanes have a predecessor: l > 0
  int m0p = usable[l - 1] && hm[l - 1] >= 0 ? hm[l - 1] : 0;
  for (int j = l; j < L && sus[j]; ++j) {
    if (hti[j] < m0p) {
      // the mask removes the hit: merge head against the tail at
      // ti >= m0p
      const int np = n_syms[j - 1];
      const int base = tail_base(np, S);
      const int lo = base > m0p ? base : m0p;
      const int hi = np < base + TAIL ? np : base + TAIL;
      int ti = lo, m = -1, v = -1;
      for (int mm = 0; mm < HEAD && ti < hi; ++mm) {
        const int h = starts[(int64_t)mm * L + j];
        if (h < 0) break;
        int tv = starts[(int64_t)ti * L + j - 1];
        while (tv < h && ++ti < hi) tv = starts[(int64_t)ti * L + j - 1];
        if (ti < hi && tv == h) {
          m = mm;
          v = h;
          break;
        }
      }
      hm[j] = m;
      hti[j] = m >= 0 ? ti : 0;
      hv[j] = v;
    }
    note_eob(j, usable, has_eob, hm, new_seg, seg_excl, first);
    m0p = usable[j] && hm[j] >= 0 ? hm[j] : 0;
  }
}

// Pass 3, a thread a lane: the stitch's outputs.
__global__ void finalize(const int32_t* __restrict__ hm,
                         const int32_t* __restrict__ hti,
                         const int32_t* __restrict__ hv,
                         const int32_t* __restrict__ new_seg,
                         const int32_t* __restrict__ seg_excl,
                         const int32_t* __restrict__ first,
                         const int32_t* __restrict__ usable,
                         const int32_t* __restrict__ has_eob, int L,
                         int32_t* mpos, int32_t* flags, int32_t* handoff,
                         int32_t* cut_prev) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  if (l >= L) return;
  const bool skip = first[seg_excl[l] + new_seg[l]] < l;
  const bool merged = usable[l] && !skip && hm[l] >= 0;
  const bool eob = has_eob[l] != 0;
  mpos[l] = merged ? hm[l] : 0;
  cut_prev[l] = merged && !new_seg[l] ? hti[l] : tbz::BIG;
  handoff[l] = merged ? hv[l] : -1;
  flags[l] = (merged ? F_MERGED : 0) | (skip ? F_SKIP : 0) |
             (!skip && !merged ? F_DEAD : 0) | (merged && eob ? F_EOB : 0);
}

__global__ void valid_counts(const int32_t* __restrict__ mpos,
                             const int32_t* __restrict__ flags,
                             const int32_t* __restrict__ cut_prev,
                             const int32_t* __restrict__ n_syms,
                             const int32_t* __restrict__ has_eob, int L,
                             int S, int32_t* nv) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  if (l >= L) return;
  const int cut_next = l + 1 < L ? cut_prev[l + 1] : tbz::BIG;
  const int last = n_syms[l] - (has_eob[l] ? 1 : 0);
  const int end_idx = cut_next < last ? cut_next : last;
  int v = end_idx - mpos[l];
  v = v < 0 ? 0 : (v > S ? S : v);
  nv[l] = (flags[l] & F_MERGED) ? v : 0;
}

__global__ void __launch_bounds__(WARPS * 32)
compact_tokens(const int32_t* __restrict__ packed,
               const int32_t* __restrict__ dists,
               const int32_t* __restrict__ mpos,
               const int32_t* __restrict__ nv,
               const int32_t* __restrict__ off, int L, int32_t* nbytes,
               int32_t* compact) {
  const int t = threadIdx.x & 31;
  const int l = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (l >= L) return;  // the whole warp
  const int m = mpos[l], n = nv[l], o = off[l];
  int sum = 0;
  for (int j = t; j < n; j += 32) {
    const int64_t src = (int64_t)(m + j) * L + l;
    const int p = packed[src];
    const int ln = p & 0x1FF;
    const int field = ln == 1 ? (p >> 9) & 0xFF : dists[src] - 1;
    compact[o + j] = ln | (field << 9);
    sum += ln;
  }
  sum = __reduce_add_sync(0xffffffffu, sum);
  if (t == 0) nbytes[l] = sum;
}

}  // namespace

TBZ_API int64_t tbz_stitch_scratch_ints(int64_t L) {
  return 12 * L + 1 + tbz_scan_scratch_ints(L);
}

TBZ_API int tbz_stitch_compact(const int32_t* starts, const int32_t* packed,
                               const int32_t* dists, const int32_t* ok,
                               const int32_t* tbl_idx, const int32_t* seg_id,
                               const int32_t* seg_sym, int L, int S, int B,
                               int32_t* flat, int32_t* scratch,
                               float* pass_ms, cudaStream_t s) {
  if (L <= 0 || S < TAIL || S < HEAD) return (int)cudaErrorInvalidValue;
  int32_t *mpos = flat, *nv = flat + L, *flg = flat + 2 * L,
          *handoff = flat + 3 * L, *off = flat + 5 * L,
          *nbytes = flat + 6 * L, *lit_errs = flat + 7 * L,
          *dist_errs = flat + 7 * L + B, *total = flat + 7 * L + 2 * B,
          *compact = flat + 7 * L + 2 * B + 1;
  int32_t *n_syms = scratch, *has_eob = scratch + L, *usable = scratch + 2 * L,
          *cut_prev = scratch + 3 * L, *hm = scratch + 4 * L,
          *hti = scratch + 5 * L, *hv = scratch + 6 * L,
          *new_seg = scratch + 7 * L, *sus = scratch + 8 * L,
          *seg_excl = scratch + 9 * L, *hmax = scratch + 10 * L,
          *first = scratch + 11 * L, *scan_scratch = scratch + 12 * L + 1;
  // pass_ms (may be null): the split [summary, match, carry, counts +
  // scan, compaction] in ms, on CUDA events, after a synchronize
  cudaEvent_t ev[6] = {};
  if (pass_ms) {
    for (auto& e : ev) {
      const cudaError_t r = cudaEventCreate(&e);
      if (r != cudaSuccess) return (int)r;
    }
  }
  auto mark = [&](int i) {
    if (pass_ms) cudaEventRecord(ev[i], s);
  };
  const unsigned grid = (L + THREADS - 1) / THREADS;
  const unsigned wgrid = (L + WARPS - 1) / WARPS;
  int err = 0;
  mark(0);
  lane_summary<<<grid, THREADS, 0, s>>>(starts, packed, ok, tbl_idx, lit_errs,
                                        dist_errs, L, S, n_syms, has_eob,
                                        usable);
  mark(1);
  match_lanes<<<wgrid, WARPS * 32, 0, s>>>(starts, seg_id, seg_sym, n_syms, L,
                                           S, hm, hti, hv, hmax, new_seg,
                                           first);
  mark(2);
  mark_suspects<<<grid, THREADS, 0, s>>>(hm, hti, hmax, new_seg, usable, L,
                                         sus);
  err = (int)cudaGetLastError();
  if (!err) err = tbz_exclusive_scan(new_seg, seg_excl, L, nullptr,
                                     scan_scratch, s);
  if (!err) {
    carry_fix<<<grid, THREADS, 0, s>>>(starts, n_syms, usable, has_eob,
                                       new_seg, sus, seg_excl, L, S, hm, hti,
                                       hv, first);
    finalize<<<grid, THREADS, 0, s>>>(hm, hti, hv, new_seg, seg_excl, first,
                                      usable, has_eob, L, mpos, flg, handoff,
                                      cut_prev);
    mark(3);
    valid_counts<<<grid, THREADS, 0, s>>>(mpos, flg, cut_prev, n_syms,
                                          has_eob, L, S, nv);
    err = (int)cudaGetLastError();
  }
  if (!err) err = tbz_exclusive_scan(nv, off, L, total, scan_scratch, s);
  if (!err) {
    mark(4);
    compact_tokens<<<wgrid, WARPS * 32, 0, s>>>(packed, dists, mpos, nv, off,
                                                L, nbytes, compact);
    mark(5);
    err = (int)cudaGetLastError();
  }
  if (pass_ms) {
    if (!err) err = (int)cudaEventSynchronize(ev[5]);
    for (int i = 0; i < 5 && !err; ++i)
      err = (int)cudaEventElapsedTime(&pass_ms[i], ev[i], ev[i + 1]);
    for (auto& e : ev) cudaEventDestroy(e);
  }
  return err;
}
