// Fused copy-on-write + item write over the block pool, in place, in two
// variants.
//
// Replaces cow_write_pallas (src/repro/kernels/cow_write/kernel.py:123)
// and cow_write_delta_pallas (kernel.py:76).  Row i reads block
// data[src[i]], puts values[i] at item pos[i], and stores the block to
// data[dst[i]].  `data` is [num_blocks + 1, block_words] 32-bit words;
// the trailing row is the dump row, where the store routes masked rows
// (dst == nb).  Both variants skip those rows.
//
// Live rows are race-free in place by the routing contract of
// store._write_impl: no row's src is another row's dst (copy sources are
// shared blocks or delta parents, destinations are fresh or exclusively
// owned), and a row with src == dst reads and writes each word from the
// same thread.  No live row touches the dump row: its dst is a valid
// block, and its src is either its dst or, where it copies (need_copy),
// the valid block it held; the delta variant's src may be the dump row,
// which it then reads no word of (nothing kept).
//
// What bounds it on the card: bytes (2.45 MB for 65,536 appends of one
// f32 into 4-word blocks, 0.73 us at 3.35 TB/s), but at that size the
// time is fixed costs: the launch and two dependent loads (a row's ids,
// then its source block) per row.
//
// Whole-block variant (cow_write_kernel): one thread per row, or per
// 16-byte chunk of a row where a block is longer than 4 words.  It loads
// src, dst, pos and (for one-word items) the value together up front,
// moves the chunk as one 16-byte load and store, and selects the written
// item in registers; the filter's 4/1 and the delta store's 8/1 words
// per block/item are template arguments, so no division is left.  Other
// shapes, and a pool whose base is not 16-byte aligned, take the same
// kernel with runtime sizes, one thread per 4-byte word.  CTA 0 zeroes
// the dump row in the same launch: no row writes it, so the call is one
// launch and the dump row is zero after it, whatever it held before.
//
// DELTA variant (cow_write_delta_kernel, sub-block delta COW): one thread
// per (row, word).  Item s of row i is copied from the source only where
// keep[i, s] (bool bytes, [n, block_size]); the written item still lands
// at pos[i], and every other item is zeroed.  A row reads a source word
// only for a kept item, so a copy row with nothing to keep (routed to the
// dump row as its source) streams no source bytes: the byte saving that
// makes delta COW worth having.  Its wrapper re-zeroes the dump row with
// a launch of its own.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// BW, IW: words per block and per item, a multiple of 4 and 1 (a thread
// moves one 16-byte chunk, which needs a 16-byte aligned pool), or 0 for
// the runtime bw, iw (a thread moves one word).
template <int BW, int IW>
__global__ void __launch_bounds__(THREADS) cow_write_kernel(
    uint32_t* data, const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const int32_t* __restrict__ pos, const uint32_t* __restrict__ values, int64_t n,
    int64_t bw_rt, int64_t iw_rt, int64_t nb) {
  constexpr int VEC = BW ? 4 : 1;
  const int64_t bw = BW ? BW : bw_rt;
  const int64_t iw = IW ? IW : iw_rt;
  const int64_t chunks = bw / VEC;
  if (blockIdx.x == 0)
    for (int64_t w = threadIdx.x; w < bw; w += THREADS) data[nb * bw + w] = 0u;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t i = t / chunks;
  if (i >= n) return;
  const int64_t w0 = (t - i * chunks) * VEC;
  const int64_t d = dst[i];
  const int64_t s = src[i];
  const int32_t p = pos[i];
  const uint32_t v1 = IW == 1 ? values[i] : 0u;
  if (d == nb) return;
  uint32_t x[VEC];
  if constexpr (VEC == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(data + s * bw + w0);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
    x[0] = data[s * bw + w0];
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int64_t w = w0 + j;
    const int64_t item = w / iw;
    if (item == p) x[j] = IW == 1 ? v1 : values[i * iw + (w - item * iw)];
  }
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint4*>(data + d * bw + w0) = make_uint4(x[0], x[1], x[2], x[3]);
  } else {
    data[d * bw + w0] = x[0];
  }
}

__global__ void cow_write_delta_kernel(uint32_t* data, const int32_t* __restrict__ src,
                                       const int32_t* __restrict__ dst,
                                       const int32_t* __restrict__ pos,
                                       const uint32_t* __restrict__ values,
                                       const uint8_t* __restrict__ keep, int64_t n,
                                       int64_t block_words, int64_t item_words, int64_t nb) {
  const int64_t total = n * block_words;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t block_size = block_words / item_words;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t i = t / block_words;
    const int64_t d = dst[i];
    if (d == nb) continue;
    const int64_t w = t - i * block_words;
    const int64_t item = w / item_words;
    uint32_t v;
    if (item == pos[i]) {
      v = values[i * item_words + (w - item * item_words)];
    } else if (keep[i * block_size + item]) {
      v = data[static_cast<int64_t>(src[i]) * block_words + w];
    } else {
      v = 0u;
    }
    data[d * block_words + w] = v;
  }
}

template <int BW, int IW>
void launch(uint32_t* data, const int32_t* src, const int32_t* dst, const int32_t* pos,
            const uint32_t* values, int64_t n, int64_t bw, int64_t iw, int64_t nb,
            cudaStream_t s) {
  const int64_t threads = BW ? n * (BW / 4) : n * bw;
  cow_write_kernel<BW, IW><<<static_cast<unsigned>((threads + THREADS - 1) / THREADS), THREADS,
                             0, s>>>(data, src, dst, pos, values, n, bw, iw, nb);
}

}  // namespace

// keep == nullptr selects the whole-block variant.
extern "C" int cow_write(void* data, const void* src, const void* dst,
                         const void* pos, const void* values, const void* keep,
                         int64_t n, int64_t block_words, int64_t item_words,
                         int64_t nb, void* stream) {
  if (n <= 0 || block_words <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  auto* d = static_cast<uint32_t*>(data);
  const auto* sr = static_cast<const int32_t*>(src);
  const auto* ds = static_cast<const int32_t*>(dst);
  const auto* ps = static_cast<const int32_t*>(pos);
  const auto* vs = static_cast<const uint32_t*>(values);
  if (keep != nullptr) {
    const int64_t total = n * block_words;
    int64_t blocks = (total + THREADS - 1) / THREADS;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    cow_write_delta_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        d, sr, ds, ps, vs, static_cast<const uint8_t*>(keep), n, block_words, item_words, nb);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t bw = block_words, iw = item_words;
  const bool aligned = reinterpret_cast<uintptr_t>(d) % 16 == 0;
  if (aligned && bw == 4 && iw == 1)
    launch<4, 1>(d, sr, ds, ps, vs, n, bw, iw, nb, s);
  else if (aligned && bw == 8 && iw == 1)
    launch<8, 1>(d, sr, ds, ps, vs, n, bw, iw, nb, s);
  else
    launch<0, 0>(d, sr, ds, ps, vs, n, bw, iw, nb, s);
  return static_cast<int>(cudaGetLastError());
}
