// Causal flash attention forward: sliding window, GQA, f32 accumulation.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention/kernel.py:94).
// q [B, H, Sq, d], k/v [B, KVH, Sk, d] (strided views: any batch, head
// and sequence strides, the last dimension contiguous), f32 or bf16;
// out in q's dtype and layout.  Query head h reads KV head h / (H / KVH).
// Key j is visible to query i where j <= i and, with window > 0,
// i - j < window; scores are (q . k) * scale.
//
// The TPU kernel walks the KV blocks of one query block along a
// sequential grid axis with the softmax state in VMEM scratch.  Here one
// CTA of 256 threads owns a (b, h, 64-query tile) and loops over the KV
// tiles inside itself, with the online-softmax state (m, l, acc) in
// registers: thread (ty, tx) of a 16 x 16 layout holds rows 4ty..4ty+3,
// score columns tx + 16j and output columns tx + 16jj.  A row's 16
// threads are one half-warp, so its max and sum are shuffle reductions
// and its P row goes through shared memory with only a warp barrier.
// KV tiles wholly outside the causal and window bounds are never loaded
// (kernel.py:51-56); partial tiles are masked element by element, as
// are keys past Sk.  A row that saw no key writes 0 (kernel.py:85-88).
//
// What bounds it on the card: operations (4 d flops per visible
// (query, key) pair; at S = 4,096 the inputs are a few MB).  This first
// version multiplies on the CUDA cores in f32 from shared memory, with
// 4 x 4 register tiles; the tensor cores (mma / wgmma) are the next step.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float half_warp_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
struct Tiles {
  static constexpr int BK = D > 128 ? 32 : 64;  // keys per KV tile
  static constexpr int QS = D + 1;               // padded row strides
  static constexpr int KS = D + 1;
  static constexpr int PS = BK + 1;
  static constexpr size_t smem_floats = BQ * QS + BK * KS + BK * D + BQ * PS;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int64_t sq, sk, h, kvh;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float scale;
  int64_t window;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(Args a) {
  using L = Tiles<D>;
  constexpr int BK = L::BK;
  constexpr int CJ = BK / 16;  // score columns per thread
  constexpr int DJ = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][QS]
  float* ks = qs + BQ * L::QS;      // [BK][KS]
  float* vs = ks + BK * L::KS;      // [BK][D]
  float* ps = vs + BK * D;          // [BQ][PS]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int64_t n_qt = (a.sq + BQ - 1) / BQ;
  const int64_t qt = n_qt - 1 - blockIdx.x;  // the longest rows first
  const int64_t hh = blockIdx.y, b = blockIdx.z;
  const int64_t kvh = hh / (a.h / a.kvh);
  const int64_t q0 = qt * BQ;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + hh * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* out = static_cast<T*>(a.out) + b * a.o_sb + hh * a.o_sh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    qs[r * L::QS + c] = q0 + r < a.sq ? to_f32(q[(q0 + r) * a.q_ss + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  const int64_t q_last = (q0 + BQ < a.sq ? q0 + BQ : a.sq) - 1;
  const int64_t k_end = q_last + 1 < a.sk ? q_last + 1 : a.sk;
  int64_t k_begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) k_begin = (q0 - a.window + 1) / BK * BK;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < a.sk;
      ks[r * L::KS + c] = in ? to_f32(k[(k0 + r) * a.k_ss + c]) : 0.f;
      vs[r * D + c] = in ? to_f32(v[(k0 + r) * a.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[4][CJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * L::QS + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = ks[(tx + 16 * j) * L::KS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q0 + 4 * ty + i;
      float mloc = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int64_t kpos = k0 + tx + 16 * j;
        const bool ok = kpos < a.sk && kpos <= qpos && (a.window <= 0 || qpos - kpos < a.window);
        s[i][j] = ok ? s[i][j] * a.scale : -INFINITY;
        mloc = fmaxf(mloc, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mloc));
      float rowsum = 0.f;
      if (m_new == -INFINITY) {  // no visible key yet: nothing changes
        alpha[i] = 1.f;
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
      } else {
        alpha[i] = expf(m[i] - m_new);
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
          rowsum += s[i][j];
        }
      }
      l[i] = alpha[i] * l[i] + half_warp_sum(rowsum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CJ; ++j) ps[(4 * ty + i) * L::PS + tx + 16 * j] = s[i][j];
    }
    __syncwarp();  // a row's P comes from its own half-warp

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha[i];
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * L::PS + kk];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float vv = vs[kk * D + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qpos = q0 + 4 * ty + i;
    if (qpos >= a.sq) continue;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) store(&out[qpos * a.o_ss + tx + 16 * jj], acc[i][jj] * inv);
  }
}

template <typename T, int D>
int launch(const Args& a, int64_t b, cudaStream_t s) {
  const size_t bytes = Tiles<D>::smem_floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.sq + BQ - 1) / BQ), static_cast<unsigned>(a.h),
                  static_cast<unsigned>(b));
  flash_kernel<T, D><<<grid, THREADS, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int64_t d, const Args& a, int64_t b, cudaStream_t s) {
  switch (d) {
    case 64: return launch<T, 64>(a, b, s);
    case 112: return launch<T, 112>(a, b, s);
    case 128: return launch<T, 128>(a, b, s);
    case 256: return launch<T, 256>(a, b, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: q, k, v, out, each (batch, head, sequence), in elements.
// dtype: 0 = f32, 1 = bf16.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int64_t b, int64_t h, int64_t kvh, int64_t sq, int64_t sk,
                               int64_t d, const int64_t* strides, double scale,
                               int64_t window, int dtype, void* stream) {
  if (b == 0 || h == 0 || sq == 0) return 0;
  Args a{q, k, v, out, sq, sk, h, kvh,
         strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
         static_cast<float>(scale), window};
  const auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch_d<float>(d, a, b, s) : dispatch_d<__nv_bfloat16>(d, a, b, s);
}
