// Systematic resampling from an inclusive weight CDF.
//
// Replaces resample_systematic_pallas (src/repro/kernels/resample/kernel.py:44):
//   anc[j] = min(#{i : cum[i] < (float(j) + u) / float(n)}, n - 1)
// The TPU kernel counts each output's comb position against the whole
// CDF in [256 x 256] compare tiles, O(n^2) work (4e9 compares at n =
// 65,536).  Bit-equal to torch.searchsorted at the same IEEE-divided
// positions (comb_range.cuh says why).
//
// What bounds it on the card: not the bytes (8 a particle: cum in, anc
// out) but chains of dependent loads.  One thread per output, each
// searching the whole CDF, made log2(n) of them (16 at n = 65,536, each
// waiting on L2).  Here a CTA takes TILE consecutive outputs; the comb
// being monotone, their ancestors lie in one source range, which
// comb_range.cuh's comb_tile_stage finds and stages in shared memory:
//   1. the tile's own indices, kSlack either side, are staged (16 bytes a
//      load) together with the first round of probes and u, one round
//      trip; they hold the range when the ancestors stay near their own
//      index;
//   2. elsewhere comb_tile_range narrows [0, n] by THREADS probes a round
//      (one round at n = 65,536, two at 2^20), and the range it finds is
//      staged;
//   3. each thread resolves TILE / THREADS outputs there by binary
//      lifting over the range padded to a power of two (no bound checks;
//      its searches overlap), clips to n - 1, and stores them as int4,
//      consecutive threads on consecutive 16 bytes.
// A range wider than the stage (a run of zero weights longer than it
// between two of the tile's ancestors) is searched in `cum` itself, within
// the range: the same answer, more dependent loads.

#include <cstdint>
#include <cuda_runtime.h>

#include "comb_range.cuh"

#ifndef RESAMPLE_TILE
#define RESAMPLE_TILE 512  // outputs per CTA: 512, 1024 or 2048
#endif

namespace {

constexpr int TILE = RESAMPLE_TILE;
constexpr int THREADS = TILE >= 1024 ? 256 : TILE / 4;
constexpr int GROUPS = TILE / (4 * THREADS);  // int4 stores per thread
constexpr int E = 4 * GROUPS;                 // outputs per thread
// Floats of shared memory for a tile's source range: ranges of up to
// kStage / 2 - 4 entries are staged, wider ones searched in `cum`.
constexpr int kStage = 8200;
// The first guess at a tile's source range: its own indices and this many
// either side (the guess then takes 2 * TILE - 24 entries: 10 search steps
// at TILE 512).
constexpr int kSlack = TILE / 2 - 12;
static_assert(TILE % (4 * THREADS) == 0 && THREADS % 32 == 0, "TILE: 512, 1024 or 2048");

__global__ void __launch_bounds__(THREADS)
    resample_kernel(const float* __restrict__ cum, const float* __restrict__ u, int64_t n,
                    int32_t* __restrict__ anc) {
  __shared__ __align__(16) float stage[kStage];
  const float uu = u[0];
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * TILE;
  const int64_t j1 = j0 + TILE < n ? j0 + TILE : n;
  int64_t a, b, base;
  const bool staged =
      comb_tile_stage<THREADS, TILE, kStage, kSlack>(cum, n, uu, j0, j1, stage, a, b, base);

  // Output g * 4 * THREADS + 4 * threadIdx.x + r of the tile is this
  // thread's 4 * g + r: each group of stores is one coalesced int4 row.
  float p[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int64_t j = j0 + (e / 4) * 4 * THREADS + 4 * threadIdx.x + e % 4;
    p[e] = comb_position(uu, n, j < n ? j : n - 1);
  }
  int64_t k[E];
  if (staged) {
    int ks[E];
    count_below_staged<E>(stage + (a - base), static_cast<int>(b - a), p, ks);
#pragma unroll
    for (int e = 0; e < E; ++e) k[e] = ks[e];
  } else {
    count_below<E>(cum + a, b - a, p, k);
  }

#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int64_t j = j0 + g * 4 * THREADS + 4 * threadIdx.x;
    int32_t out[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t i = a + k[4 * g + r];
      out[r] = static_cast<int32_t>(i < n ? i : n - 1);
    }
    if (j + 4 <= n) {
      *reinterpret_cast<int4*>(anc + j) = make_int4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (j + r < n) anc[j + r] = out[r];
    }
  }
}

}  // namespace

// anc must be 16-byte aligned (the wrapper allocates it).
extern "C" int resample_systematic(const void* cum, const void* u, int64_t n, void* anc,
                                   void* stream) {
  if (n > 0) {
    resample_kernel<<<static_cast<unsigned>((n + TILE - 1) / TILE), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cum), static_cast<const float*>(u), n,
        static_cast<int32_t*>(anc));
  }
  return static_cast<int>(cudaGetLastError());
}
