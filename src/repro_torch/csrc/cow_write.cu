// Fused copy-on-write + item write over the block pool, in place.
//
// Replaces cow_write_pallas (src/repro/kernels/cow_write/kernel.py:123).
// Row i reads block data[src[i]], puts values[i] at item pos[i], and
// stores the block to data[dst[i]].  `data` is [num_blocks + 1,
// block_words] 32-bit words (the trailing row is the dump row); the
// wrapper re-zeroes the dump row afterwards, since every masked row
// self-copies it and those writes race.
//
// Live rows are race-free in place by the routing contract of
// store._write_impl: no row's src is another row's dst (copy sources are
// shared blocks, destinations are fresh or exclusively owned), and a row
// with src == dst reads and writes each word from the same thread.
//
// What bounds it on the card: bytes.  A block is a few words (4 x f32 =
// 16 bytes on the filter's path), so the Pallas grid of one step per
// row would leave the card idle.  The design is flat: one thread per
// (row, word), consecutive threads on consecutive words of a block, so
// one warp moves whole blocks and the source/destination ids are
// broadcast loads from L1.  The pool itself is never streamed; only the
// touched blocks are.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void cow_write_kernel(uint32_t* data, const int32_t* __restrict__ src,
                                 const int32_t* __restrict__ dst,
                                 const int32_t* __restrict__ pos,
                                 const uint32_t* __restrict__ values, int64_t n,
                                 int64_t block_words, int64_t item_words) {
  const int64_t total = n * block_words;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t i = t / block_words;
    const int64_t w = t - i * block_words;
    const int64_t item = w / item_words;
    uint32_t v;
    if (item == pos[i]) {
      v = values[i * item_words + (w - item * item_words)];
    } else {
      v = data[static_cast<int64_t>(src[i]) * block_words + w];
    }
    data[static_cast<int64_t>(dst[i]) * block_words + w] = v;
  }
}

}  // namespace

extern "C" int cow_write(void* data, const void* src, const void* dst,
                         const void* pos, const void* values, int64_t n,
                         int64_t block_words, int64_t item_words,
                         void* stream) {
  const int64_t total = n * block_words;
  if (total > 0) {
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    cow_write_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(data), static_cast<const int32_t*>(src),
        static_cast<const int32_t*>(dst), static_cast<const int32_t*>(pos),
        static_cast<const uint32_t*>(values), n, block_words, item_words);
  }
  return static_cast<int>(cudaGetLastError());
}
