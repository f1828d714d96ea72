// The run-following clone bookkeeping shared by refcount_update.cu and
// clone_chain.cu.
//
// After systematic or stratified resampling the ancestors are sorted, so
// a column of the block tables holds the same block down the particle
// axis in runs (~120 entries at N = 65,536), while one row's entries are
// all different blocks.  A lane that walks VEC neighbouring columns down
// a segment of rows keeps, per column, three runs of equal keys: the new
// id (membership), the new id where it differs from the old (+len) and
// the old id where it differs from the new (-len).  A run that ends
// issues one guarded member store or one atomicAdd of its length; an
// entry costs neither, and an entry whose new and old ids agree never
// costs an atomic.  Ids outside [0, nb) (NULL = -1) drop out.  Integer
// atomics commute, so the result is bit-exact whatever the order.
//
//   delta[b]  += #(new == b) - #(old == b)
//   member[b]  = 1 where any new == b
#pragma once

#include <cstdint>

struct Run {
  int32_t id = -1;  // -1: no run (or a run of entries that count nothing)
  int32_t len = 0;
};

__device__ __forceinline__ void extend(Run& run, int32_t key, int32_t sign, int32_t* delta) {
  if (key == run.id) {
    ++run.len;
    return;
  }
  if (run.id >= 0) atomicAdd(delta + run.id, sign * run.len);
  run.id = key;
  run.len = 1;
}

// VEC neighbouring ids: one 16-byte load (VEC = 4, the address 16-byte
// aligned) or one 4-byte load.
template <int VEC>
__device__ __forceinline__ void load_ids(const int32_t* __restrict__ p, int32_t (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_ids(int32_t* __restrict__ p, const int32_t (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(x[0], x[1], x[2], x[3]);
  } else {
    p[0] = x[0];
  }
}

// One lane's runs over its VEC columns.
template <int VEC>
struct ColumnRuns {
  int32_t seen[VEC];  // the last new id marked in member, per column
  Run plus[VEC], minus[VEC];

  __device__ __forceinline__ ColumnRuns() {
#pragma unroll
    for (int j = 0; j < VEC; ++j) seen[j] = -1;
  }

  // One row's entries: new ids `a`, old ids `b`.
  __device__ __forceinline__ void add(const int32_t (&a)[VEC], const int32_t (&b)[VEC], int32_t nb,
                                      int32_t* delta, uint8_t* member) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int32_t x = a[j], y = b[j];
      const bool x_ok = x >= 0 && x < nb, y_ok = y >= 0 && y < nb;
      if (x_ok && x != seen[j]) {
        if (member[x] == 0) member[x] = 1;
        seen[j] = x;
      }
      extend(plus[j], x_ok && x != y ? x : -1, 1, delta);
      extend(minus[j], y_ok && x != y ? y : -1, -1, delta);
    }
  }

  // Closes the open runs (at the end of the lane's segment).
  __device__ __forceinline__ void finish(int32_t* delta) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      extend(plus[j], -1, 1, delta);
      extend(minus[j], -1, -1, delta);
    }
  }
};
