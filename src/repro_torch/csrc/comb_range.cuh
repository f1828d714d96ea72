// The systematic comb over a tile of consecutive outputs, with the tile's
// source range found once by the whole CTA and staged in shared memory:
//   anc[j] = lower_bound(cum, (float(j) + u) / n)      (before the clip)
// The comb is monotone in j, so the ancestors of outputs [j0, j1) lie in
// [anc(j0), anc(j1 - 1)].  comb_tile_stage finds a range [a, b] holding
// both ends (a first guess around the tile's own indices, else
// comb_tile_range's THREADS-ary search over [0, n]) and stages it;
// count_below_staged, or count_below where the range stays in `cum`,
// then resolves each output within it.
//
// Bit-equal to torch.searchsorted(side="left") at the same positions on a
// non-decreasing `cum`: the position is formed as comb.cuh forms it, every
// comparison is comb.cuh's `!(cum[i] >= pos)`, and on sorted data the
// count of entries below a position does not depend on the order in which
// they are compared.  resample.cu uses it; clone_chain.cu keeps comb.cuh's
// search per row.
#pragma once

#include <cstdint>

// (float(j) + u) / float(n), as comb.cuh and the plain path form it: an
// f32 add, then an IEEE division (the build passes no --use_fast_math).
__device__ __forceinline__ float comb_position(float u, int64_t n, int64_t j) {
  return (static_cast<float>(j) + u) / static_cast<float>(n);
}

// The least power of two above x, for 0 <= x < 2^31.
__device__ __forceinline__ int pow2_above(int x) { return 1 << (32 - __clz(x)); }

// k[e] = #{i < len : !(s[i] >= p[e])} for a non-decreasing s, by binary
// lifting: the same number of steps for every e.  Each step issues the E
// loads (at clamped indices) before it compares any, and adds the step
// by a multiply rather than a branch, so the E searches of a thread
// overlap their load latencies.  For a range left in `cum`.
template <int E>
__device__ __forceinline__ void count_below(const float* __restrict__ s, int64_t len,
                                            const float (&p)[E], int64_t (&k)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) k[e] = 0;
  if (len <= 0) return;
  for (int64_t step = int64_t{1} << (63 - __clzll(len)); step > 0; step /= 2) {
    float v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = s[(k[e] + step < len ? k[e] + step : len) - 1];
#pragma unroll
    for (int e = 0; e < E; ++e)
      k[e] += static_cast<int64_t>((k[e] + step <= len) & !(v[e] >= p[e])) * step;
  }
}

// The same over a staged range s[0, len) that entries not below any p[e]
// follow up to s[pow2_above(len) - 2] (the next entry of `cum`, then
// stage_cdf's +inf padding): no bound to check, one load, compare and add
// a step for each e.
template <int E>
__device__ __forceinline__ void count_below_staged(const float* s, int len, const float (&p)[E],
                                                   int (&k)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) k[e] = 0;
  for (int step = pow2_above(len) / 2; step > 0; step /= 2) {
    float v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = s[k[e] + step - 1];
#pragma unroll
    for (int e = 0; e < E; ++e) k[e] += static_cast<int>(!(v[e] >= p[e])) * step;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) k[e] = k[e] < len ? k[e] : len;  // a NaN position passes the padding
}

// [a, b] holding lower_bound(cum, p_first) and lower_bound(cum, p_last),
// p_first <= p_last: the first round always (its probes are loaded), then
// more until b - a <= cap, or until a round fails to halve it: then the
// span between the two ends itself is wider than cap, and more rounds
// would not bring it under.  Each round, thread t
// probes cum[a + t * (b - a) / THREADS]; the probes below each position
// form a prefix (cum is sorted), counted by __syncthreads_count, and the
// probes on either side of each count become the new ends.  The caller
// loads the first round's probe, `first` = cum[threadIdx.x * n / THREADS],
// so that it can issue the load early.  Every thread of the CTA must
// call it; a and b come out the same in all of them.
template <int THREADS>
__device__ __forceinline__ void comb_tile_range(const float* __restrict__ cum, int64_t n,
                                                float p_first, float p_last, int64_t cap,
                                                float first, int64_t& a, int64_t& b) {
  a = 0;
  b = n;
  for (bool first_round = true; first_round || b - a > cap; first_round = false) {
    const int64_t w = b - a;
    const float v = first_round ? first : cum[a + static_cast<int64_t>(threadIdx.x) * w / THREADS];
    const int64_t below_first = __syncthreads_count(!(v >= p_first));
    const int64_t below_last = __syncthreads_count(!(v >= p_last));
    // Probe below_first - 1 lies below p_first; probe below_last does not
    // lie below p_last.
    const int64_t a_next = below_first > 0 ? a + (below_first - 1) * w / THREADS + 1 : a;
    if (below_last < THREADS) b = a + below_last * w / THREADS;
    a = a_next;
    if (2 * (b - a) > w) break;
  }
  if (b < a) b = a;  // only on a `cum` that is not sorted
}

// Stages cum[lo, hi) in shared memory at stage[i - base], base = lo
// rounded down to 4 entries, 16 bytes a load where cum is 16-byte
// aligned, and +inf at [hi, pad_to); returns base.  The caller keeps
// pad_to - base within the stage.  No barrier.
template <int THREADS>
__device__ __forceinline__ int64_t stage_cdf(const float* __restrict__ cum, int64_t n, int64_t lo,
                                             int64_t hi, int64_t pad_to, float* stage) {
  const int64_t base = lo & ~int64_t{3};
  const int len = static_cast<int>(hi - base);
  const bool vec = (reinterpret_cast<uintptr_t>(cum) & 15) == 0;
  for (int q = 4 * threadIdx.x; q < len; q += 4 * THREADS) {
    if (vec && base + q + 4 <= n) {
      *reinterpret_cast<float4*>(stage + q) = *reinterpret_cast<const float4*>(cum + base + q);
    } else {
      for (int r = 0; r < 4 && base + q + r < n; ++r) stage[q + r] = cum[base + q + r];
    }
  }
  for (int q = len + threadIdx.x; q < static_cast<int>(pad_to - base); q += THREADS)
    stage[q] = __int_as_float(0x7f800000);
  return base;
}

// The source range [a, b] of the comb's outputs [j0, j1), j1 - j0 <= TILE
// (positions computed from u), staged in shared memory when b - a <=
// STAGE / 2 - 4 (returns true: stage[i - base] = cum[i] for i in [a, b),
// then what count_below_staged needs after it), else left in `cum`
// (false).  One dependent round trip where the first guess holds: the
// tile's own indices widened by SLACK either side, staged with one entry
// beyond each end, hold the range when the entry below the guess lies
// below the tile's first position and the entry at its end does not lie
// below its last (true of every tile of a CDF whose ancestors stay within
// SLACK of their own index, and when n fits the guess).  The first probe
// round of comb_tile_range is loaded with the guess; where the guess
// misses, the probes find the range, which is then staged.  Every thread
// of the CTA must call it, with the same arguments.
template <int THREADS, int TILE, int STAGE, int SLACK>
__device__ __forceinline__ bool comb_tile_stage(const float* __restrict__ cum, int64_t n, float u,
                                                int64_t j0, int64_t j1, float* stage, int64_t& a,
                                                int64_t& b, int64_t& base) {
  static_assert(2 * (TILE + 2 * SLACK) < STAGE - 8, "the guess and its padding fit the stage");
  const float first = cum[static_cast<int64_t>(threadIdx.x) * n / THREADS];
  a = j0 > SLACK ? j0 - SLACK : 0;
  b = j1 + SLACK < n ? j1 + SLACK : n;
  base = stage_cdf<THREADS>(cum, n, a > 0 ? a - 1 : 0, b < n ? b + 1 : n,
                            a + pow2_above(static_cast<int>(b - a)) - 1, stage);
  const float p_first = comb_position(u, n, j0), p_last = comb_position(u, n, j1 - 1);
  __syncthreads();
  if ((a == 0 || !(stage[a - 1 - base] >= p_first)) && (b == n || stage[b - base] >= p_last))
    return true;
  __syncthreads();  // every thread has read the guess's ends
  comb_tile_range<THREADS>(cum, n, p_first, p_last, STAGE / 2 - 4, first, a, b);
  if (b - a > STAGE / 2 - 4) return false;
  base = stage_cdf<THREADS>(cum, n, a, b, a + pow2_above(static_cast<int>(b - a)) - 1, stage);
  __syncthreads();
  return true;
}
