// Clone bookkeeping: signed refcount histogram + membership.
//
// Replaces refcount_delta_pallas
// (src/repro/kernels/refcount_update/kernel.py:50).  Over tables new/old
// of `rows` x `cols` entries (row-major; a flat table is one row):
//   delta[b]  = #(new == b) - #(old == b)   (int32)
//   member[b] = any(new == b)               (bool, one byte)
// Entries outside [0, nb) — NULL = -1 — drop out.  `delta` and `member`
// arrive zeroed.
//
// What bounds it on the card: the bytes of the two tables (134 MB at the
// filter's 65,536 x 256), if the updates stay off the critical path.
// The TPU kernel one-hot compares every entry against every block id
// (O(e * nb)).  A per-entry update (refcount_hist.cuh, the form
// scripts/torch_refcount_split.py times) reads member[new] for every
// entry, stores it where it is still 0, and adds two atomics per entry
// whose ids differ.  The filter's tables make those collide: after
// systematic or stratified resampling the ancestors are sorted, so a
// column holds the same block down the particle axis in runs (~120
// entries on average at N = 65,536, with up to thousands of entries on
// one block), while one row's entries are all different blocks.  On an
// H100 the guarded member stores took 1.02 of the per-entry kernel's 1.11
// ms at that shape, the atomics 0.01 ms, the loads 0.07 ms
// (scripts/torch_refcount_split.py).
//
// So the update follows the runs (column_runs.cuh, which clone_chain.cu
// shares).  Each warp owns a segment of SEG rows and 32 * VEC columns;
// lane l owns VEC neighbouring columns and walks them down the segment.
// A warp's row load is one coalesced 32 * VEC word read (16-byte loads
// when the rows allow), UNROLL rows at a time for memory-level
// parallelism.

#include <cstdint>
#include <cuda_runtime.h>

#include "column_runs.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SEG = 128;   // rows a warp walks
constexpr int UNROLL = 8;  // rows loaded before they are walked

template <int VEC>
__global__ void __launch_bounds__(THREADS) refcount_runs_kernel(
    const int32_t* __restrict__ new_ids, const int32_t* __restrict__ old_ids, int64_t rows,
    int64_t cols, int32_t nb, int32_t* delta, uint8_t* member) {
  const int64_t n_cg = (cols + 32 * VEC - 1) / (32 * VEC);
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) / 32;
  const int64_t c0 = warp % n_cg * 32 * VEC + threadIdx.x % 32 * VEC;
  const int64_t r0 = warp / n_cg * SEG;
  if (r0 >= rows || c0 >= cols) return;
  const int64_t r1 = r0 + SEG < rows ? r0 + SEG : rows;

  ColumnRuns<VEC> runs;
  for (int64_t r = r0; r < r1; r += UNROLL) {
    int32_t a[UNROLL][VEC], b[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (r + u < r1) {
        load_ids<VEC>(new_ids + (r + u) * cols + c0, a[u]);
        load_ids<VEC>(old_ids + (r + u) * cols + c0, b[u]);
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r + u >= r1) break;
      runs.add(a[u], b[u], nb, delta, member);
    }
  }
  runs.finish(delta);
}

template <int VEC>
void launch(const int32_t* new_ids, const int32_t* old_ids, int64_t rows, int64_t cols, int32_t nb,
            int32_t* delta, uint8_t* member, cudaStream_t s) {
  const int64_t warps = (rows + SEG - 1) / SEG * ((cols + 32 * VEC - 1) / (32 * VEC));
  const int64_t blocks = (warps * 32 + THREADS - 1) / THREADS;
  refcount_runs_kernel<VEC><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      new_ids, old_ids, rows, cols, nb, delta, member);
}

}  // namespace

// new_ids / old_ids: `rows` x `cols` int32, row-major.
extern "C" int refcount_delta(const void* new_ids, const void* old_ids, int64_t rows,
                              int64_t cols, int64_t nb, void* delta, void* member,
                              void* stream) {
  if (rows > 0 && cols > 0) {
    const auto* a = static_cast<const int32_t*>(new_ids);
    const auto* b = static_cast<const int32_t*>(old_ids);
    const auto s = static_cast<cudaStream_t>(stream);
    auto* d = static_cast<int32_t*>(delta);
    auto* m = static_cast<uint8_t*>(member);
    const bool vec = cols % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(b) % 16 == 0;
    if (vec)
      launch<4>(a, b, rows, cols, static_cast<int32_t>(nb), d, m, s);
    else
      launch<1>(a, b, rows, cols, static_cast<int32_t>(nb), d, m, s);
  }
  return static_cast<int>(cudaGetLastError());
}
