// Fused systematic resample -> table gather -> clone bookkeeping.
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
// What bounds it on the card: the bytes of the tables (read twice: the
// ancestor's row and the old row at the same position; written once)
// and the refcount atomics.  The TPU kernel counts the comb with an
// O(n^2) compare and gathers rows with a one-hot f32 matmul; here each
// ancestor is an O(log n) binary search over a CDF that stays in L2
// (256 KB at n = 65,536), the gather is a direct integer load, and the
// histogram is refcount_update.cu's per-entry update (refcount_hist.cuh).
// Two launches on one stream: one thread per row for the search, one
// thread per table entry for the gather and histogram.

#include <cstdint>
#include <cuda_runtime.h>

#include "comb.cuh"
#include "refcount_hist.cuh"

namespace {

__global__ void comb_kernel(const float* __restrict__ cum,
                            const float* __restrict__ u, int64_t n,
                            int32_t* __restrict__ anc) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const float uu = u[0];
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    anc[j] = comb_ancestor(cum, uu, n, j);
  }
}

__global__ void gather_hist_kernel(const int32_t* __restrict__ tables,
                                   const int32_t* __restrict__ anc, int64_t n,
                                   int64_t mb, int32_t nb,
                                   int32_t* __restrict__ new_tables,
                                   int32_t* delta, uint8_t* member) {
  const int64_t total = n * mb;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t j = t / mb;
    const int64_t c = t - j * mb;
    const int32_t a = tables[static_cast<int64_t>(anc[j]) * mb + c];
    new_tables[t] = a;
    refcount_hist_entry(a, tables[t], nb, delta, member);
  }
}

int64_t grid_for(int64_t total, int threads) {
  int64_t blocks = (total + threads - 1) / threads;
  return blocks > (1LL << 20) ? (1LL << 20) : blocks;
}

}  // namespace

extern "C" int clone_chain(const void* cum, const void* u, const void* tables,
                           int64_t n, int64_t mb, int64_t nb, void* anc,
                           void* new_tables, void* delta, void* member,
                           void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (n > 0) {
    comb_kernel<<<static_cast<unsigned>(grid_for(n, threads)), threads, 0, s>>>(
        static_cast<const float*>(cum), static_cast<const float*>(u), n,
        static_cast<int32_t*>(anc));
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if (n > 0 && mb > 0) {
    gather_hist_kernel<<<static_cast<unsigned>(grid_for(n * mb, threads)), threads,
                         0, s>>>(
        static_cast<const int32_t*>(tables), static_cast<const int32_t*>(anc), n,
        mb, static_cast<int32_t>(nb), static_cast<int32_t*>(new_tables),
        static_cast<int32_t*>(delta), static_cast<uint8_t*>(member));
  }
  return static_cast<int>(cudaGetLastError());
}
