// The systematic comb's inverse-CDF lookup, shared by clone_chain.cu and
// resample.cu:
//   anc[j] = min(lower_bound(cum, (float(j) + u) / n), n - 1)
// The position is formed as the plain path forms it (float(j) + u
// rounded to f32, then an IEEE division by float(n); the build passes no
// --use_fast_math, so `/` is div.rn.f32), and the search is the loop
// torch.searchsorted(side="left") runs, so the ancestors equal the plain
// version's bit for bit.  O(log n) loads from a CDF that stays in L2.
#pragma once

#include <cstdint>

__device__ __forceinline__ int32_t comb_ancestor(const float* __restrict__ cum,
                                                 float u, int64_t n, int64_t j) {
  const float pos = (static_cast<float>(j) + u) / static_cast<float>(n);
  int64_t start = 0;
  int64_t end = n;
  while (start < end) {
    const int64_t mid = start + ((end - start) >> 1);
    if (!(cum[mid] >= pos)) {
      start = mid + 1;
    } else {
      end = mid;
    }
  }
  return static_cast<int32_t>(start < n ? start : n - 1);
}
