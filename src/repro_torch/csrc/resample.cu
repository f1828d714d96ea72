// Systematic resampling from an inclusive weight CDF.
//
// Replaces resample_systematic_pallas (src/repro/kernels/resample/kernel.py:44):
//   anc[j] = clip(#{i : cum[i] < (j + u) / n}, 0, n - 1)
// The TPU kernel counts each output's comb position against the whole
// CDF in [256 x 256] compare tiles, O(n^2) work (4e9 compares at n =
// 65,536).  Here each output is one binary search (comb.cuh, shared with
// clone_chain.cu), O(n log n), bit-exact with torch.searchsorted at the
// same IEEE-divided positions.
//
// What bounds it on the card: the n searches' dependent loads from the
// 256 KB CDF, which stays in L2; the bytes that must move (cum in,
// anc out) are 8 bytes a particle.  One thread per output.

#include <cstdint>
#include <cuda_runtime.h>

#include "comb.cuh"

namespace {

__global__ void resample_kernel(const float* __restrict__ cum,
                                const float* __restrict__ u, int64_t n,
                                int32_t* __restrict__ anc) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const float uu = u[0];
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    anc[j] = comb_ancestor(cum, uu, n, j);
  }
}

}  // namespace

extern "C" int resample_systematic(const void* cum, const void* u, int64_t n,
                                   void* anc, void* stream) {
  if (n > 0) {
    const int threads = 256;
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    resample_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cum), static_cast<const float*>(u), n,
        static_cast<int32_t*>(anc));
  }
  return static_cast<int>(cudaGetLastError());
}
