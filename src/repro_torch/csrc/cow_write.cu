// Fused copy-on-write + item write over the block pool, in place, in two
// variants.
//
// Replaces cow_write_pallas (src/repro/kernels/cow_write/kernel.py:123)
// and cow_write_delta_pallas (kernel.py:76).  Row i reads block
// data[src[i]], puts values[i] at item pos[i], and stores the block to
// data[dst[i]].  `data` is [num_blocks + 1, block_words] 32-bit words
// (the trailing row is the dump row); the wrapper re-zeroes the dump row
// afterwards, since every masked row self-copies it and those writes
// race.
//
// DELTA (sub-block delta COW): item s of row i is copied from the source
// only where keep[i, s] (bool bytes, [n, block_size]); the written item
// still lands at pos[i], and every other item is zeroed.  Rows whose
// destination is the dump row are skipped, and a row reads a source word
// only for a kept item, so a copy row with nothing to keep (routed to the
// dump row as its source) streams no source bytes: the byte saving that
// makes delta COW worth having.
//
// Live rows are race-free in place by the routing contract of
// store._write_impl: no row's src is another row's dst (copy sources are
// shared blocks or delta parents, destinations are fresh or exclusively
// owned), and a row with src == dst reads and writes each word from the
// same thread.
//
// What bounds it on the card: bytes.  A block is a few words (4 or 8 x
// f32 on the filter's path), so the Pallas grid of one step per row would
// leave the card idle.  The design is flat: one thread per (row, word),
// consecutive threads on consecutive words of a block, so one warp moves
// whole blocks and the ids are broadcast loads from L1.  The pool itself
// is never streamed; only the touched blocks are.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <bool DELTA>
__global__ void cow_write_kernel(uint32_t* data, const int32_t* __restrict__ src,
                                 const int32_t* __restrict__ dst,
                                 const int32_t* __restrict__ pos,
                                 const uint32_t* __restrict__ values,
                                 const uint8_t* __restrict__ keep, int64_t n,
                                 int64_t block_words, int64_t item_words,
                                 int64_t nb) {
  const int64_t total = n * block_words;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t block_size = block_words / item_words;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t i = t / block_words;
    const int64_t d = dst[i];
    if (DELTA && d == nb) continue;
    const int64_t w = t - i * block_words;
    const int64_t item = w / item_words;
    uint32_t v;
    if (item == pos[i]) {
      v = values[i * item_words + (w - item * item_words)];
    } else if (!DELTA || keep[i * block_size + item]) {
      v = data[static_cast<int64_t>(src[i]) * block_words + w];
    } else {
      v = 0u;
    }
    data[d * block_words + w] = v;
  }
}

}  // namespace

// keep == nullptr selects the whole-block variant.
extern "C" int cow_write(void* data, const void* src, const void* dst,
                         const void* pos, const void* values, const void* keep,
                         int64_t n, int64_t block_words, int64_t item_words,
                         int64_t nb, void* stream) {
  const int64_t total = n * block_words;
  if (total > 0) {
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    const auto s = static_cast<cudaStream_t>(stream);
    auto* d = static_cast<uint32_t*>(data);
    const auto* sr = static_cast<const int32_t*>(src);
    const auto* ds = static_cast<const int32_t*>(dst);
    const auto* ps = static_cast<const int32_t*>(pos);
    const auto* vs = static_cast<const uint32_t*>(values);
    const auto* ks = static_cast<const uint8_t*>(keep);
    if (keep == nullptr) {
      cow_write_kernel<false><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
          d, sr, ds, ps, vs, ks, n, block_words, item_words, nb);
    } else {
      cow_write_kernel<true><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
          d, sr, ds, ps, vs, ks, n, block_words, item_words, nb);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
