// Fused systematic resample -> table gather -> clone bookkeeping, in one
// launch.
//
// Replaces clone_chain_pallas (src/repro/kernels/clone_chain/kernel.py:96).
// From the inclusive weight CDF `cum` [n] (non-decreasing, cum[n-1] ==
// 1), one uniform `u`, and the block tables [n, mb] int32:
//   anc[j]       = min(lower_bound(cum, (float(j) + u) / n), n - 1)
//   new[j, c]    = tables[anc[j], c]
//   delta[b]     = #(new == b) - #(old == b),  member[b] = any(new == b)
// `delta` and `member` arrive zeroed; ids outside [0, nb) drop out.
//
// Exactness: the comb is comb.cuh's, formed and searched as the plain
// path does (IEEE division, torch.searchsorted's lower_bound loop), so
// the ancestors equal the plain version's bit for bit.
//
// What bounds it on the card: bytes.  The old tables are read (the
// ancestor's row and the row itself; the ancestor's rows come in runs,
// so they mostly hit L1 and L2) and the new tables written: 134 MB at
// the filter's 65,536 x 256.  The TPU kernel counts the comb with an
// O(n^2) compare and gathers rows with a one-hot f32 matmul.  Here the
// ancestors are sorted, so a column of the new table repeats one block
// down the particle axis in long runs, and so does the old table from
// the previous generation.  The design is refcount_update.cu's: the
// bookkeeping follows the runs (column_runs.cuh), so an entry costs no
// member store and no atomic, a run one of either.  The per-entry update
// this replaces (refcount_hist.cuh, one thread per entry, the comb in a
// launch of its own) read 0.95 ms a call at that shape on an H100; in
// refcount_update the same per-entry pattern spent 1.02 of 1.11 ms on
// its guarded member stores (scripts/torch_refcount_split.py).
//
// Work is cut into units of SEG rows x 32 * VEC columns, one warp each;
// a CTA takes WARPS consecutive units (segment-major).  Its threads
// first run the comb for the rows of its units (comb.cuh: an O(log n)
// binary search over a CDF that stays in L2) into shared memory, and the
// CTA that holds a segment's first column group writes the segment's
// ancestors out.  Then lane l of each warp walks VEC neighbouring columns
// down its segment: UNROLL rows of the ancestor's ids and of the old ids
// in flight as 16-byte loads (VEC = 4; 4-byte loads when the row length
// or a base does not allow them), the new row stored as 16-byte stores,
// and the three runs per column of column_runs.cuh.  No 64-bit division
// per entry.  One launch per call: the comb is fused.

#include <cstdint>
#include <cuda_runtime.h>

#include "column_runs.cuh"
#include "comb.cuh"

// Rows a warp walks, and rows it loads before walking them
// (scripts/torch_clone_chain_split.py builds other values to time them).
#ifndef CLONE_CHAIN_SEG
#define CLONE_CHAIN_SEG 64
#endif
#ifndef CLONE_CHAIN_UNROLL
#define CLONE_CHAIN_UNROLL 4
#endif

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SEG = CLONE_CHAIN_SEG;
constexpr int UNROLL = CLONE_CHAIN_UNROLL;

template <int VEC>
__global__ void __launch_bounds__(THREADS) clone_chain_kernel(
    const float* __restrict__ cum, const float* __restrict__ u, const int32_t* __restrict__ tables,
    int64_t n, int64_t mb, int32_t nb, int32_t* __restrict__ anc,
    int32_t* __restrict__ new_tables, int32_t* delta, uint8_t* member) {
  // A CTA's units span at most WARPS segments.
  __shared__ int32_t anc_s[WARPS * SEG];
  const int64_t n_cg = mb > 0 ? (mb + 32 * VEC - 1) / (32 * VEC) : 1;
  const int64_t n_units = (n + SEG - 1) / SEG * n_cg;
  const int64_t unit0 = static_cast<int64_t>(blockIdx.x) * WARPS;
  const int64_t unit1 = unit0 + WARPS < n_units ? unit0 + WARPS : n_units;
  const int64_t row0 = unit0 / n_cg * SEG;
  const int64_t row_end = ((unit1 - 1) / n_cg + 1) * SEG;
  const int64_t row1 = row_end < n ? row_end : n;

  const float uu = u[0];
  for (int64_t r = row0 + threadIdx.x; r < row1; r += THREADS) {
    const int32_t a = comb_ancestor(cum, uu, n, r);
    anc_s[r - row0] = a;
    if (r / SEG * n_cg >= unit0) anc[r] = a;  // this CTA holds column group 0
  }
  __syncthreads();

  const int64_t unit = unit0 + threadIdx.x / 32;
  if (unit >= unit1) return;
  const int64_t c0 = unit % n_cg * 32 * VEC + threadIdx.x % 32 * VEC;
  if (c0 >= mb) return;
  const int64_t r0 = unit / n_cg * SEG;
  const int64_t r1 = r0 + SEG < n ? r0 + SEG : n;

  ColumnRuns<VEC> runs;
  for (int64_t r = r0; r < r1; r += UNROLL) {
    int32_t a[UNROLL][VEC], b[UNROLL][VEC];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
      if (r + k < r1) {
        load_ids<VEC>(tables + static_cast<int64_t>(anc_s[r + k - row0]) * mb + c0, a[k]);
        load_ids<VEC>(tables + (r + k) * mb + c0, b[k]);
      }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (r + k >= r1) break;
      store_ids<VEC>(new_tables + (r + k) * mb + c0, a[k]);
      runs.add(a[k], b[k], nb, delta, member);
    }
  }
  runs.finish(delta);
}

template <int VEC>
void launch(const float* cum, const float* u, const int32_t* tables, int64_t n, int64_t mb,
            int32_t nb, int32_t* anc, int32_t* new_tables, int32_t* delta, uint8_t* member,
            cudaStream_t s) {
  const int64_t n_cg = mb > 0 ? (mb + 32 * VEC - 1) / (32 * VEC) : 1;
  const int64_t units = (n + SEG - 1) / SEG * n_cg;
  clone_chain_kernel<VEC><<<static_cast<unsigned>((units + WARPS - 1) / WARPS), THREADS, 0, s>>>(
      cum, u, tables, n, mb, nb, anc, new_tables, delta, member);
}

}  // namespace

extern "C" int clone_chain(const void* cum, const void* u, const void* tables,
                           int64_t n, int64_t mb, int64_t nb, void* anc,
                           void* new_tables, void* delta, void* member,
                           void* stream) {
  if (n > 0) {
    const auto* c = static_cast<const float*>(cum);
    const auto* uu = static_cast<const float*>(u);
    const auto* t = static_cast<const int32_t*>(tables);
    auto* a = static_cast<int32_t*>(anc);
    auto* nt = static_cast<int32_t*>(new_tables);
    auto* d = static_cast<int32_t*>(delta);
    auto* m = static_cast<uint8_t*>(member);
    const auto s = static_cast<cudaStream_t>(stream);
    const bool vec = mb % 4 == 0 && reinterpret_cast<uintptr_t>(t) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(nt) % 16 == 0;
    if (vec)
      launch<4>(c, uu, t, n, mb, static_cast<int32_t>(nb), a, nt, d, m, s);
    else
      launch<1>(c, uu, t, n, mb, static_cast<int32_t>(nb), a, nt, d, m, s);
  }
  return static_cast<int>(cudaGetLastError());
}
