// Fused copy-on-write + item write over the block pool, in place, in two
// variants.
//
// Replaces cow_write_pallas (src/repro/kernels/cow_write/kernel.py:123)
// and cow_write_delta_pallas (kernel.py:76).  Row i reads block
// data[src[i]], puts values[i] at item pos[i], and stores the block to
// data[dst[i]].  `data` is [num_blocks + 1, block_words] 32-bit words;
// the trailing row is the dump row, where the store routes masked rows
// (dst == nb).  Both variants skip those rows.  The delta variant copies
// item s of row i from the source only where keep[i, s] (bool bytes,
// [n, block_size]) and zeroes every other item but the written one.
//
// Live rows are race-free in place by the routing contract of
// store._write_impl: no row's src is another row's dst (copy sources are
// shared blocks or delta parents, destinations are fresh or exclusively
// owned), and a row with src == dst reads and writes each word from the
// same thread.  No live row reads the dump row: its dst is a valid block,
// and its src is either its dst or, where it copies (need_copy), the
// valid block it held; the delta variant's src is the dump row only for a
// copy row that keeps nothing, and a chunk that keeps nothing reads no
// source byte.  So CTA 0 zeroes the dump row in the same launch, and the
// call is one launch with the dump row zero after it, whatever it held.
//
// What bounds it on the card: bytes (2.45 MB for 65,536 appends of one
// f32 into 4-word blocks, 0.73 us at 3.35 TB/s; 4.28 MB for the delta
// store's 8-word blocks with their keep bytes, 1.28 us), but at that size
// the time is fixed costs: the launch and two dependent loads (a row's
// ids, then its source block) per row.
//
// One body for both variants (cow_write_kernel, cow_write_delta_kernel):
// one thread per 16-byte chunk of a row (4 words).  It loads src, dst,
// pos, the one-word value and, under delta, the chunk's 4 keep bytes (one
// 32-bit load) together up front, returns on a masked row, moves the
// chunk as one 16-byte load and store, and selects the written item (and,
// under delta, the zeroed ones) in registers.  The filter's 4/1 and the delta store's 8/1 words per
// block/item are template arguments, so no division is left.  A delta
// chunk that keeps none of its slots (but the written one) reads no
// source byte; one that keeps some reads all 16 and drops the rest in
// registers, which moves no more DRAM bytes than reading the kept words
// alone, since DRAM moves 32-byte sectors either way.  Other shapes, and
// a pool (or keep mask) not aligned for the vector loads, take the same
// kernel with runtime sizes, one thread per 4-byte word, which reads its
// source word only where its item is kept and not the written one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// A thread's chunk.  BW, IW: words per block and per item, a multiple
// of 4 and 1 (a thread moves one 16-byte chunk, which needs a 16-byte
// aligned pool and, under DELTA, a 4-byte aligned keep mask), or 0 for
// the runtime bw, iw (a thread moves one word).
template <int BW, int IW, bool DELTA>
__device__ __forceinline__ void write_chunk(
    uint32_t* data, const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const int32_t* __restrict__ pos, const uint32_t* __restrict__ values,
    const uint8_t* __restrict__ keep, int64_t n, int64_t bw_rt, int64_t iw_rt, int64_t nb) {
  constexpr int VEC = BW ? 4 : 1;
  static_assert(VEC == 1 || IW == 1, "16-byte chunks take one-word items");
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
  // Keep byte of each word's item (VEC == 4: a word is an item, and the
  // chunk's 4 bytes are one aligned 32-bit word of the keep row).
  uint32_t kb = 0xffffffffu;
  if constexpr (DELTA) {
    if constexpr (VEC == 4)
      kb = *reinterpret_cast<const uint32_t*>(keep + i * BW + w0);
    else
      kb = keep[i * (bw / iw) + w0 / iw];
  }
  if (d == nb) return;
  bool written[VEC], kept[VEC];
  bool read = false;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    written[j] = (w0 + j) / iw == p;
    kept[j] = VEC == 4 ? ((kb >> (8 * j)) & 0xffu) != 0 : kb != 0;
    read |= kept[j] && !written[j];
  }
  uint32_t x[VEC] = {};
  if (read) {
    if constexpr (VEC == 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(data + s * bw + w0);
      x[0] = q.x;
      x[1] = q.y;
      x[2] = q.z;
      x[3] = q.w;
    } else {
      x[0] = data[s * bw + w0];
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if (written[j])
      x[j] = IW == 1 ? v1 : values[i * iw + (w0 + j - p * iw)];
    else if (!kept[j])
      x[j] = 0u;
  }
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint4*>(data + d * bw + w0) = make_uint4(x[0], x[1], x[2], x[3]);
  } else {
    data[d * bw + w0] = x[0];
  }
}

// The two variants under names of their own (a trace tells them apart).
template <int BW, int IW>
__global__ void __launch_bounds__(THREADS)
    cow_write_kernel(uint32_t* data, const int32_t* __restrict__ src,
                     const int32_t* __restrict__ dst, const int32_t* __restrict__ pos,
                     const uint32_t* __restrict__ values, const uint8_t* __restrict__ keep,
                     int64_t n, int64_t bw, int64_t iw, int64_t nb) {
  write_chunk<BW, IW, false>(data, src, dst, pos, values, keep, n, bw, iw, nb);
}

template <int BW, int IW>
__global__ void __launch_bounds__(THREADS)
    cow_write_delta_kernel(uint32_t* data, const int32_t* __restrict__ src,
                           const int32_t* __restrict__ dst, const int32_t* __restrict__ pos,
                           const uint32_t* __restrict__ values, const uint8_t* __restrict__ keep,
                           int64_t n, int64_t bw, int64_t iw, int64_t nb) {
  write_chunk<BW, IW, true>(data, src, dst, pos, values, keep, n, bw, iw, nb);
}

template <int BW, int IW, bool DELTA>
void launch(uint32_t* data, const int32_t* src, const int32_t* dst, const int32_t* pos,
            const uint32_t* values, const uint8_t* keep, int64_t n, int64_t bw, int64_t iw,
            int64_t nb, cudaStream_t s) {
  const int64_t threads = BW ? n * (BW / 4) : n * bw;
  const auto kernel = DELTA ? cow_write_delta_kernel<BW, IW> : cow_write_kernel<BW, IW>;
  kernel<<<static_cast<unsigned>((threads + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      data, src, dst, pos, values, keep, n, bw, iw, nb);
}

template <bool DELTA>
void dispatch(uint32_t* data, const int32_t* src, const int32_t* dst, const int32_t* pos,
              const uint32_t* values, const uint8_t* keep, int64_t n, int64_t bw, int64_t iw,
              int64_t nb, cudaStream_t s) {
  const bool aligned = reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                       (!DELTA || reinterpret_cast<uintptr_t>(keep) % 4 == 0);
  if (aligned && bw == 4 && iw == 1)
    launch<4, 1, DELTA>(data, src, dst, pos, values, keep, n, bw, iw, nb, s);
  else if (aligned && bw == 8 && iw == 1)
    launch<8, 1, DELTA>(data, src, dst, pos, values, keep, n, bw, iw, nb, s);
  else
    launch<0, 0, DELTA>(data, src, dst, pos, values, keep, n, bw, iw, nb, s);
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
  const auto* ks = static_cast<const uint8_t*>(keep);
  if (keep != nullptr)
    dispatch<true>(d, sr, ds, ps, vs, ks, n, block_words, item_words, nb, s);
  else
    dispatch<false>(d, sr, ds, ps, vs, ks, n, block_words, item_words, nb, s);
  return static_cast<int>(cudaGetLastError());
}
