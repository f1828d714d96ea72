// Clone bookkeeping: signed refcount histogram + membership.
//
// Replaces refcount_delta_pallas
// (src/repro/kernels/refcount_update/kernel.py:50).  Over flattened
// tables new/old of e entries:
//   delta[b]  = #(new == b) - #(old == b)   (int32)
//   member[b] = any(new == b)               (bool, one byte)
// Entries outside [0, nb) — NULL = -1 — drop out.  `delta` and `member`
// arrive zeroed.
//
// What bounds it on the card: the int32 atomics on delta, and the bytes
// of the two tables.  The TPU kernel one-hot compares every entry
// against every block id (O(e * nb): 16.8M x 1.95M on the filter's
// path); here each entry costs at most two atomicAdds
// (refcount_hist.cuh), and none where its new and old id agree.  How
// many entries that skip saves depends on the genealogy: chip_smoke.py
// prints the share of equal entries at the filter's shapes.

#include <cstdint>
#include <cuda_runtime.h>

#include "refcount_hist.cuh"

namespace {

__global__ void refcount_delta_kernel(const int32_t* __restrict__ new_ids,
                                      const int32_t* __restrict__ old_ids,
                                      int64_t e, int32_t nb, int32_t* delta,
                                      uint8_t* member) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < e; t += stride) {
    refcount_hist_entry(new_ids[t], old_ids[t], nb, delta, member);
  }
}

}  // namespace

extern "C" int refcount_delta(const void* new_ids, const void* old_ids,
                              int64_t e, int64_t nb, void* delta, void* member,
                              void* stream) {
  if (e > 0) {
    const int threads = 256;
    int64_t blocks = (e + threads - 1) / threads;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    refcount_delta_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(new_ids), static_cast<const int32_t*>(old_ids),
        e, static_cast<int32_t>(nb), static_cast<int32_t*>(delta),
        static_cast<uint8_t*>(member));
  }
  return static_cast<int>(cudaGetLastError());
}
