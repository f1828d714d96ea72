// Single-token GQA attention over the paged, copy-on-write KV pool.
//
// Replaces paged_attention_pallas (src/repro/kernels/paged_attention/kernel.py:210)
// and, with DELTA, paged_attention_delta_pallas (kernel.py:142).
//   out[b, h] = softmax_s(q[b, h] . K[b, s] * scale) @ V[b, s]
// over the slots s < lengths[b] of row b's pages, read through its block
// table; NULL (-1) pages are skipped, and a row with no valid slot
// writes 0 (the TPU kernels' _finalize).  Under DELTA, slot s of page t
// reads page t where dirty[t, s], else parent[t] (t itself when
// parent[t] < 0): shared prefixes are attended in place, never copied.
// That address is the only difference between the variants, so they give
// bit-identical outputs whenever they resolve to the same bytes.
//
// Layout: q and out [B, H, D] contiguous; the pools are strided views
// (one layer's K or V slice of the [blocks, L, 2, bs, KVH, D] pool), so
// the element (t, s, h, d) sits at t*bstride + s*sstride + h*hstride + d.
// Nothing is made contiguous: that would copy the whole pool per layer.
//
// What bounds it on the card: bytes — each live K/V slot of the row is
// read once per KV head, plus q and out; the arithmetic is 4*G*D flops
// per slot, far below the bf16 tensor-core ridge.  The TPU kernel walks
// a sequential grid axis over pages with the softmax state in VMEM; here
// one block per (b, kv-head) loops over the row's pages itself, holding
// its G = H/KVH query heads, the online-softmax state (m, l) and the
// [G, D] accumulator in shared memory, all in f32.  Each page's K and V
// are staged in shared memory (rows padded to D+1 floats, so the score
// loop's column reads are conflict-free), loaded with neighbouring
// threads on neighbouring elements.  A simple first kernel: no split
// over the sequence, no tensor cores, no TMA.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, bool DELTA>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const int32_t* __restrict__ tables, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ parent, const uint8_t* __restrict__ dirty,
    T* __restrict__ out, int H, int KVH, int D, int BS, int NB, int64_t bstride,
    int64_t sstride, int64_t hstride, float scale) {
  extern __shared__ float smem[];
  const int G = H / KVH;
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int KS = D + 1;
  float* qs = smem;            // [G, D]
  float* ks = qs + G * D;      // [BS, KS]
  float* vs = ks + BS * KS;    // [BS, KS]
  float* sc = vs + BS * KS;    // [G, BS] scores, then probabilities
  float* acc = sc + G * BS;    // [G, D]
  float* m = acc + G * D;      // [G] running max
  float* l = m + G;            // [G] running denominator
  float* alpha = l + G;        // [G] this page's rescale

  const int64_t row = (static_cast<int64_t>(b) * H + static_cast<int64_t>(kh) * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    qs[i] = to_float(q[row + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }
  __syncthreads();

  const int len = lengths[b];
  int pages = len > 0 ? (len + BS - 1) / BS : 0;
  if (pages > NB) pages = NB;
  const int64_t hoff = static_cast<int64_t>(kh) * hstride;
  for (int j = 0; j < pages; ++j) {
    const int t = tables[static_cast<int64_t>(b) * NB + j];
    if (t < 0) continue;  // the same for every thread of the block
    int base = t;
    if (DELTA) {
      const int p = parent[t];
      base = p >= 0 ? p : t;
    }
    for (int i = tid; i < BS * D; i += blockDim.x) {
      const int s = i / D;
      const int d = i - s * D;
      int src = t;
      if (DELTA) src = dirty[static_cast<int64_t>(t) * BS + s] ? t : base;
      const int64_t off = static_cast<int64_t>(src) * bstride + s * sstride + hoff + d;
      ks[s * KS + d] = to_float(k_pool[off]);
      vs[s * KS + d] = to_float(v_pool[off]);
    }
    __syncthreads();
    for (int i = tid; i < G * BS; i += blockDim.x) {
      const int g = i / BS;
      const int s = i - g * BS;
      const float* qg = qs + g * D;
      const float* kr = ks + s * KS;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kr[d], dot);
      sc[i] = (j * BS + s < len) ? dot * scale : kNegInf;
    }
    __syncthreads();
    for (int g = tid; g < G; g += blockDim.x) {
      float* srow = sc + g * BS;
      float mx = m[g];
      for (int s = 0; s < BS; ++s) mx = fmaxf(mx, srow[s]);
      float sum = 0.f;
      for (int s = 0; s < BS; ++s) {
        const float p = expf(srow[s] - mx);
        srow[s] = p;
        sum += p;
      }
      const float a = expf(m[g] - mx);
      l[g] = a * l[g] + sum;
      m[g] = mx;
      alpha[g] = a;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D;
      const int d = i - g * D;
      const float* p = sc + g * BS;
      float pv = 0.f;
      for (int s = 0; s < BS; ++s) pv = fmaf(p[s], vs[s * KS + d], pv);
      acc[i] = acc[i] * alpha[g] + pv;
    }
    __syncthreads();
  }
  for (int i = tid; i < G * D; i += blockDim.x) {
    const float denom = l[i / D];
    store(out + row + i, acc[i] / (denom == 0.f ? 1.f : denom));
  }
}

template <typename T, bool DELTA>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* lengths, const void* parent,
                   const void* dirty, void* out, int B, int H, int KVH, int D, int BS,
                   int NB, int64_t bstride, int64_t sstride, int64_t hstride, float scale,
                   cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(G) * D +
                                       2 * static_cast<size_t>(BS) * (D + 1) +
                                       static_cast<size_t>(G) * BS + 3 * G);
  auto kernel = paged_attention_kernel<T, DELTA>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(B, KVH), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), static_cast<const int32_t*>(parent),
      static_cast<const uint8_t*>(dirty), static_cast<T*>(out), H, KVH, D, BS, NB,
      bstride, sstride, hstride, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_delta(int delta, const void* q, const void* k_pool,
                           const void* v_pool, const void* tables, const void* lengths,
                           const void* parent, const void* dirty, void* out, int B, int H,
                           int KVH, int D, int BS, int NB, int64_t bstride,
                           int64_t sstride, int64_t hstride, float scale,
                           cudaStream_t stream) {
  if (delta) {
    return launch<T, true>(q, k_pool, v_pool, tables, lengths, parent, dirty, out, B, H,
                           KVH, D, BS, NB, bstride, sstride, hstride, scale, stream);
  }
  return launch<T, false>(q, k_pool, v_pool, tables, lengths, parent, dirty, out, B, H,
                          KVH, D, BS, NB, bstride, sstride, hstride, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  delta: 0 = paged_attention_pallas,
// 1 = paged_attention_delta_pallas (parent and dirty are read).
extern "C" int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                               const void* tables, const void* lengths,
                               const void* parent, const void* dirty, void* out,
                               int64_t B, int64_t H, int64_t KVH, int64_t D, int64_t BS,
                               int64_t NB, int64_t bstride, int64_t sstride,
                               int64_t hstride, double scale, int dtype, int delta,
                               void* stream) {
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_delta<float>(delta, q, k_pool, v_pool, tables, lengths, parent, dirty,
                                out, B, H, KVH, D, BS, NB, bstride, sstride, hstride,
                                static_cast<float>(scale), s);
  } else if (dtype == 1) {
    err = dispatch_delta<__nv_bfloat16>(delta, q, k_pool, v_pool, tables, lengths, parent,
                                        dirty, out, B, H, KVH, D, BS, NB, bstride,
                                        sstride, hstride, static_cast<float>(scale), s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
