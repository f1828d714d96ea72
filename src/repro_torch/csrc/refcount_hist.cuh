// One table entry's share of the clone bookkeeping, per entry: the design
// refcount_update.cu and clone_chain.cu replaced with run-following
// (column_runs.cuh), kept for scripts/torch_refcount_split.py, which
// times it.
//
// The entry held block `b` before the clone and holds block `a` after it:
//   delta[a] += 1, delta[b] -= 1, member[a] = 1
// with ids outside [0, nb) (NULL = -1) dropping out.  An entry whose new
// and old id are equal adds +1 and -1 to the same counter, so it costs no
// atomic.  Membership is a plain store of 1, guarded by a read so a block
// held by many entries is written once, not once per entry.  Integer
// atomics commute, so the result is bit-exact whatever the order.

#pragma once

#include <cstdint>

__device__ __forceinline__ void refcount_hist_entry(int32_t a, int32_t b,
                                                    int32_t nb, int32_t* delta,
                                                    uint8_t* member) {
  const bool a_ok = a >= 0 && a < nb;
  if (a_ok && member[a] == 0) member[a] = 1;
  if (a == b) return;
  if (a_ok) atomicAdd(delta + a, 1);
  if (b >= 0 && b < nb) atomicAdd(delta + b, -1);
}
