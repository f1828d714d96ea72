// Gather pool blocks by a block table; NULL entries give zero blocks.
//
// Replaces cow_gather_pallas (src/repro/kernels/cow_gather/kernel.py:35).
//   out[i] = table[i] >= 0 ? pool[table[i]] : 0
// `pool` is [rows, row_words] 32-bit words, `table` [k] int32, `out`
// [k, row_words].  Ids past the last row are clamped to it, as an XLA
// gather clamps.  It backs trajectory read-out (materialize,
// materialize_batch) and pool compaction (pool_compact).
//
// What bounds it on the card: bytes — k table ids, the distinct blocks
// they name, and k output blocks.  The Pallas grid streams one block
// per grid step; here the gather is flat, one thread per 16-byte vector
// of an output row when rows are a multiple of four words and the
// buffers are 16-byte aligned (a 4 x f32 block is one vector), one
// thread per word otherwise.  Output stores are fully coalesced; the
// reads are as coalesced as the table is (a compacted pool or a shared
// genealogy prefix makes neighbouring ids neighbouring rows).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename V>
__global__ void cow_gather_kernel(const V* __restrict__ pool,
                                  const int32_t* __restrict__ table,
                                  V* __restrict__ out, int64_t k,
                                  int64_t row_vecs, int64_t rows) {
  const int64_t total = k * row_vecs;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t i = t / row_vecs;
    const int64_t j = t - i * row_vecs;
    const int64_t b = table[i];
    V v;
    if (b >= 0) {
      const int64_t r = b < rows ? b : rows - 1;
      v = pool[r * row_vecs + j];
    } else {
      v = V{};
    }
    out[t] = v;
  }
}

template <typename V>
void launch(const void* pool, const void* table, void* out, int64_t k,
            int64_t row_vecs, int64_t rows, cudaStream_t stream) {
  const int64_t total = k * row_vecs;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  cow_gather_kernel<V><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const V*>(pool), static_cast<const int32_t*>(table),
      static_cast<V*>(out), k, row_vecs, rows);
}

}  // namespace

extern "C" int cow_gather(const void* pool, const void* table, void* out,
                          int64_t k, int64_t row_words, int64_t rows,
                          void* stream) {
  if (k > 0 && row_words > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(pool) | reinterpret_cast<uintptr_t>(out)) %
         16) == 0;
    if (row_words % 4 == 0 && aligned) {
      launch<uint4>(pool, table, out, k, row_words / 4, rows, s);
    } else {
      launch<uint32_t>(pool, table, out, k, row_words, rows, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
