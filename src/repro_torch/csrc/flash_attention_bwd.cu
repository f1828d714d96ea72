// Causal flash attention backward: sliding window, GQA, f32 accumulation.
//
// Replaces no TPU kernel.  The reference never differentiates through
// flash_attention_pallas (src/repro/kernels/flash_attention/kernel.py:94):
// its training step takes jax.grad through the plain attention_chunked.
// The port's forward runs csrc/flash_attention.cu on every CUDA tensor,
// and a CUDA tensor never falls back to a plain version, so training on
// the card needs this gradient (kernels/flash_attention/ops.py wraps both
// in one torch.autograd.Function).
//
// q, o, dout, dq [B, Sq, H, d]; k, v, dk, dv [B, Sk, KVH, d], contiguous,
// f32 or bf16 (one dtype); lse and delta [B, H, Sq] f32 scratch.  Query
// head h reads KV head h / (H / KVH); key j is visible to query i where
// j <= i and, with window > 0, i - j < window; scores are (q . k) * scale.
// With P = softmax(S) over the visible keys and dP = dO V^T:
//   dV = P^T dO,  dS = P o (dP - rowsum(dO o O)),  dK = scale dS^T Q,
//   dQ = scale dS K.
//
// Three launches, none with a float atomic, each output element written
// once by one thread after sums in a fixed order, so two calls on the same
// inputs are bit-equal:
//   1. prep, a CTA per (64-query tile, head, batch): the row log-sum-exp
//      of the scaled scores (recomputed here, so the tuned forward kernel
//      is untouched and stores nothing extra), and delta = rowsum(dO o O);
//   2. dkdv, a CTA per (key tile, KV head, batch): dK and dV in
//      registers, looping over the G query heads of its KV head and over
//      the query tiles that see the tile, in a fixed order;
//   3. dq, a CTA per (query tile, head, batch): dQ in registers, looping
//      over the key tiles its rows see.
// P is recomputed from the log-sum-exp in both 2 and 3.
//
// What bounds it: operations (the backward's five products, 10 d flops a
// visible (query, key) pair, plus the prep's 2 d).  This first version
// runs them on the CUDA cores in f32, as the forward's CUDA-core kernel
// does, with tiles staged in shared memory as f32 (bf16 widened as it
// arrives) and 4 x 4-style register tiles: thread (ty, tx) of 16 x 16
// holds rows R ty .. R ty + R - 1 of its CTA's own tile and columns
// tx + 16 j.  Tiles are 64 x 64 up to d 128 and 32 x 32 at d 256, where
// four f32 tiles of 257-float rows fill 140 KB.  Rows are padded to d + 1
// floats, so sixteen threads reading sixteen rows at one column hit
// sixteen banks.  Tensor cores (wgmma on bf16 P and dS) are rule-2 work.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Bwd {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;
  float* delta;
  int64_t sq, sk, h, kvh;
  float scale;
  int64_t window;
};

constexpr int THREADS = 256;

template <int D>
struct Cfg {
  static constexpr int BQ = D > 128 ? 32 : 64;  // query rows of a tile
  static constexpr int BK = D > 128 ? 32 : 64;  // keys of a tile
  static constexpr int RS = D + 1;              // padded row stride of Q, dO, K, V tiles
  static constexpr int RQ = BQ / 16;            // a thread's query rows (prep, dq)
  static constexpr int RK = BK / 16;            // a thread's key rows (dkdv)
  static constexpr int CQ = BQ / 16;            // a thread's query columns (dkdv)
  static constexpr int CK = BK / 16;            // a thread's key columns (prep, dq)
  static constexpr int DJ = D / 16;             // a thread's head-dim columns
  static constexpr size_t prep_floats = (BQ + BK) * RS;
  static constexpr size_t dkdv_floats = 2 * BK * RS + 2 * BQ * RS + 2 * BK * (BQ + 1) + 2 * BQ;
  static constexpr size_t dq_floats = 2 * BQ * RS + 2 * BK * RS + BQ * (BK + 1) + 2 * BQ;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// A row's 16 threads are one half-warp (tid = 16 ty + tx).
__device__ __forceinline__ float half_warp_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(const Bwd& a, int64_t i, int64_t j) {
  return i < a.sq && j < a.sk && j <= i && (a.window <= 0 || i - j < a.window);
}

// rows x D elements from row0 of a [rows, stride] view into a padded f32
// tile; rows at or past n_rows read as 0.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t row0, int rows,
                                          int64_t n_rows, int64_t stride) {
  for (int e = threadIdx.x; e < rows * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = row0 + r < n_rows ? to_f32(src[(row0 + r) * stride + c]) : 0.f;
  }
}

// The key tiles that the query tile [q0, q0 + BQ) sees: [begin, end).
template <int D>
__device__ __forceinline__ void key_range(const Bwd& a, int64_t q0, int64_t* begin, int64_t* end) {
  constexpr int BK = Cfg<D>::BK;
  const int64_t q_hi = q0 + Cfg<D>::BQ < a.sq ? q0 + Cfg<D>::BQ : a.sq;
  *end = q_hi < a.sk ? q_hi : a.sk;
  *begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) *begin = (q0 - a.window + 1) / BK * BK;
}

// 1. The row log-sum-exp of the scaled, masked scores and delta = rowsum(dO o O).
template <int D, typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_prep(Bwd a) {
  using C = Cfg<D>;
  constexpr int RQ = C::RQ, CK = C::CK, RS = C::RS, DJ = C::DJ;
  extern __shared__ float smem[];
  float* qs = smem;            // [BQ][RS]
  float* ks = qs + C::BQ * RS;  // [BK][RS]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t q0 = blockIdx.x * static_cast<int64_t>(C::BQ), hh = blockIdx.y, b = blockIdx.z;
  const int64_t kv = hh / (a.h / a.kvh), qrow = a.h * D, krow = a.kvh * D;
  const T* q = static_cast<const T*>(a.q) + (b * a.sq * a.h + hh) * D;
  const T* o = static_cast<const T*>(a.o) + (b * a.sq * a.h + hh) * D;
  const T* dout = static_cast<const T*>(a.dout) + (b * a.sq * a.h + hh) * D;
  const T* k = static_cast<const T*>(a.k) + (b * a.sk * a.kvh + kv) * D;
  load_tile<D>(qs, q, q0, C::BQ, a.sq, qrow);

  float m[RQ], l[RQ];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  int64_t k_begin, k_end;
  key_range<D>(a, q0, &k_begin, &k_end);
  for (int64_t k0 = k_begin; k0 < k_end; k0 += C::BK) {
    __syncthreads();  // the previous K tile is consumed
    load_tile<D>(ks, k, k0, C::BK, a.sk, krow);
    __syncthreads();
    float s[RQ][CK];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[RQ], kc[CK];
#pragma unroll
      for (int r = 0; r < RQ; ++r) qv[r] = qs[(ty * RQ + r) * RS + c];
#pragma unroll
      for (int j = 0; j < CK; ++j) kc[j] = ks[(tx + 16 * j) * RS + c];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[r][j] = fmaf(qv[r], kc[j], s[r][j]);
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int64_t i = q0 + ty * RQ + r;
      float mloc = -INFINITY;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        s[r][j] = visible(a, i, k0 + tx + 16 * j) ? s[r][j] * a.scale : -INFINITY;
        mloc = fmaxf(mloc, s[r][j]);
      }
      const float m_new = fmaxf(m[r], half_warp_max(mloc));
      float rowsum = 0.f;
      if (m_new != -INFINITY) {
#pragma unroll
        for (int j = 0; j < CK; ++j) rowsum += s[r][j] == -INFINITY ? 0.f : expf(s[r][j] - m_new);
      }
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[r] - m_new);
      l[r] = alpha * l[r] + half_warp_sum(rowsum);
      m[r] = m_new;
    }
  }

  float* lse = a.lse + (b * a.h + hh) * a.sq;
  float* delta = a.delta + (b * a.h + hh) * a.sq;
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int64_t i = q0 + ty * RQ + r;
    float dsum = 0.f;
    if (i < a.sq) {
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const int64_t c = i * qrow + tx + 16 * jj;
        dsum = fmaf(to_f32(dout[c]), to_f32(o[c]), dsum);
      }
    }
    dsum = half_warp_sum(dsum);
    if (tx == 0 && i < a.sq) {
      // A row that sees no key has P = 0 everywhere: exp(s - inf) = 0.
      lse[i] = l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
      delta[i] = dsum;
    }
  }
}

// 2. dK and dV of one key tile, summed over the G query heads of its KV
// head and the query tiles that see it, in that order.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv(Bwd a) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, RS = C::RS, RK = C::RK, CQ = C::CQ, DJ = C::DJ;
  constexpr int PS = BQ + 1;
  extern __shared__ float smem[];
  float* ks = smem;            // [BK][RS]
  float* vs = ks + BK * RS;    // [BK][RS]
  float* qs = vs + BK * RS;    // [BQ][RS]
  float* dos = qs + BQ * RS;   // [BQ][RS]
  float* pt = dos + BQ * RS;   // [BK][PS]  P^T
  float* dst = pt + BK * PS;   // [BK][PS]  dS^T
  float* lse_s = dst + BK * PS;  // [BQ]
  float* del_s = lse_s + BQ;     // [BQ]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t k0 = blockIdx.x * static_cast<int64_t>(BK), kv = blockIdx.y, b = blockIdx.z;
  const int64_t g = a.h / a.kvh, qrow = a.h * D, krow = a.kvh * D;
  const int64_t kbase = (b * a.sk * a.kvh + kv) * D;
  load_tile<D>(ks, static_cast<const T*>(a.k) + kbase, k0, BK, a.sk, krow);
  load_tile<D>(vs, static_cast<const T*>(a.v) + kbase, k0, BK, a.sk, krow);

  float dk[RK][DJ], dv[RK][DJ];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dk[r][jj] = dv[r][jj] = 0.f;

  const int64_t k_last = (k0 + BK < a.sk ? k0 + BK : a.sk) - 1;
  int64_t i_end = a.sq;
  if (a.window > 0 && k_last + a.window < i_end) i_end = k_last + a.window;
  const int64_t i_begin = k0 / BQ * BQ;
  for (int64_t gi = 0; gi < g; ++gi) {
    const int64_t hh = kv * g + gi;
    const T* q = static_cast<const T*>(a.q) + (b * a.sq * a.h + hh) * D;
    const T* dout = static_cast<const T*>(a.dout) + (b * a.sq * a.h + hh) * D;
    const float* lse = a.lse + (b * a.h + hh) * a.sq;
    const float* delta = a.delta + (b * a.h + hh) * a.sq;
    for (int64_t q0 = i_begin; q0 < i_end; q0 += BQ) {
      __syncthreads();  // the previous query tile, P^T and dS^T are consumed
      load_tile<D>(qs, q, q0, BQ, a.sq, qrow);
      load_tile<D>(dos, dout, q0, BQ, a.sq, qrow);
      for (int e = tid; e < BQ; e += THREADS) {
        const bool in = q0 + e < a.sq;
        lse_s[e] = in ? lse[q0 + e] : INFINITY;
        del_s[e] = in ? delta[q0 + e] : 0.f;
      }
      __syncthreads();
      float s[RK][CQ], dp[RK][CQ];
#pragma unroll
      for (int r = 0; r < RK; ++r)
#pragma unroll
        for (int j = 0; j < CQ; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 2
      for (int c = 0; c < D; ++c) {
        float kr[RK], vr[RK], qc[CQ], dc[CQ];
#pragma unroll
        for (int r = 0; r < RK; ++r) {
          kr[r] = ks[(ty * RK + r) * RS + c];
          vr[r] = vs[(ty * RK + r) * RS + c];
        }
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          qc[j] = qs[(tx + 16 * j) * RS + c];
          dc[j] = dos[(tx + 16 * j) * RS + c];
        }
#pragma unroll
        for (int r = 0; r < RK; ++r)
#pragma unroll
          for (int j = 0; j < CQ; ++j) {
            s[r][j] = fmaf(kr[r], qc[j], s[r][j]);
            dp[r][j] = fmaf(vr[r], dc[j], dp[r][j]);
          }
      }
#pragma unroll
      for (int r = 0; r < RK; ++r)
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          const int row = ty * RK + r, col = tx + 16 * j;
          const float p = visible(a, q0 + col, k0 + row) ? expf(s[r][j] * a.scale - lse_s[col]) : 0.f;
          pt[row * PS + col] = p;
          dst[row * PS + col] = p * (dp[r][j] - del_s[col]);
        }
      __syncthreads();
#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        float pr[RK], dr[RK];
#pragma unroll
        for (int r = 0; r < RK; ++r) {
          pr[r] = pt[(ty * RK + r) * PS + qq];
          dr[r] = dst[(ty * RK + r) * PS + qq];
        }
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          const float dov = dos[qq * RS + tx + 16 * jj];
          const float qv = qs[qq * RS + tx + 16 * jj];
#pragma unroll
          for (int r = 0; r < RK; ++r) {
            dv[r][jj] = fmaf(pr[r], dov, dv[r][jj]);
            dk[r][jj] = fmaf(dr[r], qv, dk[r][jj]);
          }
        }
      }
    }
  }

  T* dkp = static_cast<T*>(a.dk) + kbase;
  T* dvp = static_cast<T*>(a.dv) + kbase;
#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int64_t j = k0 + ty * RK + r;
    if (j >= a.sk) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int64_t c = j * krow + tx + 16 * jj;
      dkp[c] = from_f32<T>(dk[r][jj] * a.scale);
      dvp[c] = from_f32<T>(dv[r][jj]);
    }
  }
}

// 3. dQ of one query tile, summed over the key tiles its rows see.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq(Bwd a) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, RS = C::RS, RQ = C::RQ, CK = C::CK, DJ = C::DJ;
  constexpr int SS = BK + 1;
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][RS]
  float* dos = qs + BQ * RS;    // [BQ][RS]
  float* ks = dos + BQ * RS;    // [BK][RS]
  float* vs = ks + BK * RS;     // [BK][RS]
  float* dss = vs + BK * RS;    // [BQ][SS]  dS
  float* lse_s = dss + BQ * SS;  // [BQ]
  float* del_s = lse_s + BQ;     // [BQ]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t n_qt = (a.sq + BQ - 1) / BQ;
  const int64_t q0 = (n_qt - 1 - blockIdx.x) * BQ;  // the longest rows first
  const int64_t hh = blockIdx.y, b = blockIdx.z;
  const int64_t kv = hh / (a.h / a.kvh), qrow = a.h * D, krow = a.kvh * D;
  const int64_t qbase = (b * a.sq * a.h + hh) * D, kbase = (b * a.sk * a.kvh + kv) * D;
  load_tile<D>(qs, static_cast<const T*>(a.q) + qbase, q0, BQ, a.sq, qrow);
  load_tile<D>(dos, static_cast<const T*>(a.dout) + qbase, q0, BQ, a.sq, qrow);
  const float* lse = a.lse + (b * a.h + hh) * a.sq;
  const float* delta = a.delta + (b * a.h + hh) * a.sq;
  for (int e = tid; e < BQ; e += THREADS) {
    const bool in = q0 + e < a.sq;
    lse_s[e] = in ? lse[q0 + e] : INFINITY;
    del_s[e] = in ? delta[q0 + e] : 0.f;
  }

  float acc[RQ][DJ];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[r][jj] = 0.f;

  const T* k = static_cast<const T*>(a.k) + kbase;
  const T* v = static_cast<const T*>(a.v) + kbase;
  int64_t k_begin, k_end;
  key_range<D>(a, q0, &k_begin, &k_end);
  for (int64_t k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous K, V and dS are consumed
    load_tile<D>(ks, k, k0, BK, a.sk, krow);
    load_tile<D>(vs, v, k0, BK, a.sk, krow);
    __syncthreads();
    float s[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; ++c) {
      float qr[RQ], dr[RQ], kc[CK], vc[CK];
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        qr[r] = qs[(ty * RQ + r) * RS + c];
        dr[r] = dos[(ty * RQ + r) * RS + c];
      }
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        kc[j] = ks[(tx + 16 * j) * RS + c];
        vc[j] = vs[(tx + 16 * j) * RS + c];
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          s[r][j] = fmaf(qr[r], kc[j], s[r][j]);
          dp[r][j] = fmaf(dr[r], vc[j], dp[r][j]);
        }
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int row = ty * RQ + r, col = tx + 16 * j;
        const float p = visible(a, q0 + row, k0 + col) ? expf(s[r][j] * a.scale - lse_s[row]) : 0.f;
        dss[row * SS + col] = p * (dp[r][j] - del_s[row]);
      }
    __syncwarp();  // a row's dS comes from its own half-warp
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float dr[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r) dr[r] = dss[(ty * RQ + r) * SS + kk];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float kv_ = ks[kk * RS + tx + 16 * jj];
#pragma unroll
        for (int r = 0; r < RQ; ++r) acc[r][jj] = fmaf(dr[r], kv_, acc[r][jj]);
      }
    }
  }

  T* dq = static_cast<T*>(a.dq) + qbase;
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int64_t i = q0 + ty * RQ + r;
    if (i >= a.sq) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dq[i * qrow + tx + 16 * jj] = from_f32<T>(acc[r][jj] * a.scale);
  }
}

template <typename K>
int launch_one(K kernel, size_t floats, dim3 grid, const Bwd& a, cudaStream_t s) {
  const size_t bytes = floats * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int launch_bwd(const Bwd& a, int64_t b, cudaStream_t s) {
  using C = Cfg<D>;
  const unsigned bs = static_cast<unsigned>(b);
  const unsigned n_qt = static_cast<unsigned>((a.sq + C::BQ - 1) / C::BQ);
  const unsigned n_kt = static_cast<unsigned>((a.sk + C::BK - 1) / C::BK);
  int err = launch_one(flash_bwd_prep<D, T>, C::prep_floats, dim3(n_qt, static_cast<unsigned>(a.h), bs), a, s);
  if (err) return err;
  err = launch_one(flash_bwd_dkdv<D, T>, C::dkdv_floats, dim3(n_kt, static_cast<unsigned>(a.kvh), bs), a, s);
  if (err) return err;
  return launch_one(flash_bwd_dq<D, T>, C::dq_floats, dim3(n_qt, static_cast<unsigned>(a.h), bs), a, s);
}

template <typename T>
int dispatch(int64_t d, const Bwd& a, int64_t b, cudaStream_t s) {
  switch (d) {
    case 16: return launch_bwd<16, T>(a, b, s);
    case 32: return launch_bwd<32, T>(a, b, s);
    case 64: return launch_bwd<64, T>(a, b, s);
    case 112: return launch_bwd<112, T>(a, b, s);
    case 128: return launch_bwd<128, T>(a, b, s);
    case 256: return launch_bwd<256, T>(a, b, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Every tensor contiguous in the layout above;
// sq and sk at least 1 (the wrapper answers the empty cases itself).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
                                   int64_t b, int64_t h, int64_t kvh, int64_t sq, int64_t sk, int64_t d,
                                   double scale, int64_t window, int dtype, void* stream) {
  if (b == 0 || h == 0 || sq == 0 || sk == 0) return 0;
  Bwd a{q, k, v, o, dout, dq, dk, dv, static_cast<float*>(lse), static_cast<float*>(delta),
        sq, sk, h, kvh, static_cast<float>(scale), window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dispatch<__nv_bfloat16>(d, a, b, s) : dispatch<float>(d, a, b, s);
}
