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
// f32 or bf16 (one dtype).  Query head h reads KV head h / (H / KVH); key
// j is visible to query i where j <= i and, with window > 0, i - j <
// window; scores are (q . k) * scale.  With P = softmax(S) over the
// visible keys and dP = dO V^T:
//   dV = P^T dO,  dS = P o (dP - rowsum(dO o O)),  dK = scale dS^T Q,
//   dQ = scale dS K.
// No launch uses a float atomic, and every output element is written once
// by one thread after sums in a fixed order, so two calls on the same
// inputs are bit-equal.
//
// What bounds it: operations.  The five products take 10 d flops a
// visible (query, key) pair (5.2e11 at starcoder2-3b's training shape)
// against a few tens of MB of inputs and outputs.  So the dtype and head
// dim pick one of two routes, as the forward's do:
//
// * bf16 at d 64, 112, 128 and 256: the tensor cores (flash_bwd_delta,
//   flash_bwd_tc below), wgmma m64n64k16 with f32 accumulators.  The
//   row log-sum-exp is not recomputed: the forward kernel writes it (log2
//   units of the scaled scores) when autograd will need it, and
//   ops.py passes it in, so Q K^T is not formed a third time; a direct
//   call must pass it too (ops.forward_lse), else ops.py raises.  Two
//   launches: delta = rowsum(dO o O), one warp a row on the CUDA cores
//   (bytes); then one grid of one-warpgroup CTAs, the dK/dV tiles first,
//   those that the most queries see first, then the dQ tiles, the
//   longest rows first, so that dQ tiles fill the SMs the lighter dK/dV
//   tiles free (as two launches, SMs idled while the dK/dV launch waited
//   on its heaviest tiles; PERF.md section 6).  Causal key tile 0 still
//   sees every query tile of its G heads; splitting a dK/dV tile over
//   groups of heads, with f32 partials added by a third launch, was
//   slower in the form tried.
//   a. dkdv, a CTA per (64 keys, KV head, batch, half of d at d 256): K
//      and V land once by TMA; the Q and dO tiles of the G query heads
//      and of the query tiles that see the keys, with their lse and
//      delta, flow through two stages filled by TMA (full and
//      empty mbarriers; thread 0 refills a stage once every thread has
//      released it).  Per tile: S^T = K Q^T and dP^T = V dO^T by wgmma
//      from shared memory (both operands K-major, as the forward's
//      Q K^T); P^T = 2^(S^T scale log2 e - lse) and dS^T = P^T o (dP^T -
//      delta) on the accumulator fragment; both rounded to bf16 in
//      registers, where they are the register A operand of dV += P^T dO
//      and dK += dS^T Q, whose B operands dO and Q are read MN-major
//      through the descriptor with no transposed copy (as the forward's
//      O += P V reads V);
//   b. dq, a CTA per (64 queries, head, batch, half of d at d 256): Q and
//      dO land once; K and V tiles flow through two stages; S = Q K^T,
//      dP = dO V^T, dS as above, dQ += dS K with K read MN-major.
//   Tiles wholly outside the causal and window bounds are never loaded;
//   masks are applied only on tiles that cross the diagonal, the window
//   edge, Sq or Sk; TMA fills rows past Sq and Sk, and d 112's columns
//   112..127 (two 64-column boxes), with zeros.  Registers set the tiles:
//   at d 128 a thread holds dK and dV (64 + 64 f32) beside S^T and dP^T
//   (32 + 32), so a CTA is one warpgroup of 64 keys (two CTAs an SM); at
//   d 256 dK and dV alone would take 256 registers, so each CTA owns a
//   128-column half of them (and of dQ) and forms S and dP over all 256
//   columns, once per half.  Departure from the plain version: P and dS
//   are rounded to bf16 before their products, as the forward rounds P;
//   scores, the softmax terms and every accumulation stay f32.  TMA needs
//   16-byte aligned bases and strides; ops.py raises on a view without
//   them.
// * f32, and bf16 at d 16 and 32: the CUDA cores (flash_bwd_prep,
//   flash_bwd_dkdv, flash_bwd_dq below), by choice and not as a fallback:
//   the tensor cores take f32 only as TF32, whose 10-bit mantissa would
//   break the f32 limit of 1e-4, and one wgmma k-step is 16 wide, a K
//   tile a 64-column box.  Three launches: the row log-sum-exp
//   (recomputed, natural-log units) and delta; dK and dV a CTA per key
//   tile, looping over the G query heads and the query tiles that see it;
//   dQ a CTA per query tile.  Tiles are staged in shared memory as f32
//   (bf16 widened as it arrives) with 4 x 4-style register tiles: thread
//   (ty, tx) of 16 x 16 holds rows R ty .. R ty + R - 1 of its CTA's own
//   tile and columns tx + 16 j.  Tiles are 64 x 64 up to d 128 and 32 x
//   32 at d 256.  Rows are padded to d + 1 floats, so sixteen threads
//   reading sixteen rows at one column hit sixteen banks.

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

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

// -------------------------------------------------------------------------
// bf16 at d 64, 112, 128, 256: the tensor-core kernels.

constexpr int TC_THREADS = 128;            // one warpgroup
constexpr int TC_ROWS = 64;                // queries of a Q tile, keys of a K tile
constexpr int TILE_BOX = TC_ROWS * 128;    // bytes of one 64-row, 64-column bf16 box
constexpr int TC_STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct TcTiles {
  static constexpr int DP = (D + BOX_COLS - 1) / BOX_COLS * BOX_COLS;  // padded head dim
  static constexpr int NB = DP / BOX_COLS;        // boxes of a row
  static constexpr int DH = DP > 128 ? 128 : DP;  // gradient columns a CTA owns
  static constexpr int HB = DH / BOX_COLS;        // their boxes
  static constexpr int HALVES = DP / DH;          // 2 at d 256, else 1
  static constexpr int TILE = NB * TILE_BOX;      // one 64-row tile, every column
  // Two fixed tiles (dkdv: K, V; dq: Q, dO), then the stages of two tiles
  // each (dkdv: Q, dO; dq: K, V), then each stage's 64 lse and 64 delta
  // floats (dkdv), then the barriers; the boxes 1024-byte aligned.
  static constexpr int STAGE_OFF = 2 * TILE;
  static constexpr int VEC_OFF = STAGE_OFF + TC_STAGES * 2 * TILE;
  static constexpr int BAR_OFF = VEC_OFF + TC_STAGES * 2 * TC_ROWS * 4;
  static constexpr size_t smem_bytes = 1024 + BAR_OFF + (2 * TC_STAGES + 1) * 8;
};

// One 2-D TMA box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The 64 rows from row0 of one head of a [B, S, heads, d] map, all NB boxes.
template <int NB>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int64_t head,
                                         int64_t row0, int b) {
#pragma unroll
  for (int c = 0; c < NB; ++c)
    tma_load(dst + c * TILE_BOX, map, bar, c * BOX_COLS, static_cast<int>(head), static_cast<int>(row0), b);
}

// acc[64 x 64] = A B^T over the padded head dim, A and B 64-row tiles in
// shared memory, both K-major (the forward's Q K^T).
template <int NB>
__device__ __forceinline__ void issue_abt(float (&acc)[32], uint32_t ta, uint32_t tb) {
#pragma unroll
  for (int kk = 0; kk < NB * 4; ++kk) {
    const uint32_t off = (kk / 4) * TILE_BOX + (kk % 4) * 32;  // box, then 16 columns into its rows
    wgmma_ss(acc, desc(ta + off, 16), desc(tb + off, 16), kk > 0);
  }
}

// acc[c] += F B[:, boxes b0 + c], F a 64 x 64 bf16 fragment in registers, B
// a 64-row tile read MN-major (its rows are the sum's index), 16 rows a step.
template <int HB>
__device__ __forceinline__ void issue_fb(float (&acc)[HB][32], const uint32_t (&f)[4][4], uint32_t tb, int b0) {
#pragma unroll
  for (int c = 0; c < HB; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc[c], f[kk], desc(tb + (b0 + c) * TILE_BOX + kk * 2048, TILE_BOX));
}

// An accumulator fragment as the register A operand: bf16 pairs, 16
// columns a k-step.
__device__ __forceinline__ void to_frag(const float (&x)[32], uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) f[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// The thread's rows row0 and row0 + 8 of acc (HB boxes from column col0)
// times `mul`, as bf16, into rows of `ld` elements; rows past n_rows and
// columns past d are padding.  Element i of a fragment sits at row
// 16 warp + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2.
template <int HB>
__device__ __forceinline__ void store_rows(const float (&acc)[HB][32], __nv_bfloat16* base, int64_t ld,
                                           int64_t row0, int64_t n_rows, int col0, int d, float mul) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = row0 + 8 * r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < HB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + c * BOX_COLS + 8 * j + 2 * (lane % 4);
        if (col >= d) continue;
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(base + row * ld + col) =
            __floats2bfloat162_rn(acc[c][i] * mul, acc[c][i + 1] * mul);
      }
  }
}

// 1. delta[b, h, i] = rowsum(dO o O) for i < Sq, 0 for Sq <= i < lse_ld: a
// warp a row, each lane summing its column pairs in order, then a fixed
// shuffle tree.
__global__ void __launch_bounds__(256) flash_bwd_delta(Bwd a, int64_t lse_ld, int d) {
  const int64_t w = blockIdx.x * 8LL + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t b = blockIdx.y;
  if (w >= a.h * lse_ld) return;
  const int64_t hh = w / lse_ld, i = w % lse_ld;
  float sum = 0.f;
  if (i < a.sq) {
    const int64_t off = ((b * a.sq + i) * a.h + hh) * d;
    const auto* o = reinterpret_cast<const __nv_bfloat162*>(static_cast<const __nv_bfloat16*>(a.o) + off);
    const auto* g = reinterpret_cast<const __nv_bfloat162*>(static_cast<const __nv_bfloat16*>(a.dout) + off);
    for (int c = lane; c < d / 2; c += 32) {
      const float2 x = __bfloat1622float2(o[c]), y = __bfloat1622float2(g[c]);
      sum = fmaf(x.x, y.x, sum);
      sum = fmaf(x.y, y.y, sum);
    }
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) a.delta[(b * a.h + hh) * lse_ld + i] = sum;
}

// The tensor maps of the five inputs and of the two row vectors.
struct TcMaps {
  CUtensorMap q, dout, k, v, lse, delta;
};

// 2a. dK and dV of the 64 keys from k0 of KV head kv (one half of their
// columns at d 256), summed over the G query heads of the KV head and the
// query tiles that see the keys, in that order.
template <int D>
__device__ __forceinline__ void dkdv_tile(const Bwd& a, int64_t lse_ld, uint8_t* smem, const TcMaps& maps,
                                          int64_t k0, int kv, int b, int half) {
  using L = TcTiles<D>;
  const uint32_t s_k = smem_addr(smem), s_v = s_k + L::TILE;
  const uint32_t s_stage = s_k + L::STAGE_OFF;  // stage s: Q at s_stage + 2 s TILE, then dO
  const uint32_t s_vec = s_k + L::VEC_OFF;      // stage s: 64 lse, then 64 delta
  const float* vec = reinterpret_cast<const float*>(smem + L::VEC_OFF);
  const uint32_t bar_full = s_k + L::BAR_OFF, bar_empty = bar_full + 8 * TC_STAGES;
  const uint32_t bar_kv = bar_empty + 8 * TC_STAGES;

  const int64_t g = a.h / a.kvh;
  const int64_t k_last = (k0 + TC_ROWS < a.sk ? k0 + TC_ROWS : a.sk) - 1;
  int64_t i_end = a.sq;
  if (a.window > 0 && k_last + a.window < i_end) i_end = k_last + a.window;
  const int64_t n_q = i_end > k0 ? (i_end - k0 + TC_ROWS - 1) / TC_ROWS : 0;  // query tiles from k0
  const int n_t = static_cast<int>(g * n_q);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, TC_THREADS);
    }
    mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0: tile t's Q, dO, lse and delta into stage t % TC_STAGES.
  const CUtensorMap *mq = &maps.q, *mdo = &maps.dout, *ml = &maps.lse, *md = &maps.delta;
  auto issue = [&](int t) {
    const int s = t % TC_STAGES;
    const int64_t hh = kv * g + t / n_q, q0 = k0 + (t % n_q) * TC_ROWS;
    const uint32_t bar = bar_full + 8 * s, dst = s_stage + s * 2 * L::TILE;
    mbar_expect_tx(bar, 2 * L::TILE + 2 * TC_ROWS * 4);
    tma_tile<L::NB>(dst, mq, bar, hh, q0, b);
    tma_tile<L::NB>(dst + L::TILE, mdo, bar, hh, q0, b);
    const int row = static_cast<int>(b * a.h + hh);
    tma_load_2d(s_vec + s * 2 * TC_ROWS * 4, ml, bar, static_cast<int>(q0), row);
    tma_load_2d(s_vec + s * 2 * TC_ROWS * 4 + TC_ROWS * 4, md, bar, static_cast<int>(q0), row);
  };
  if (tid == 0 && n_t > 0) {
    mbar_expect_tx(bar_kv, 2 * L::TILE);
    tma_tile<L::NB>(s_k, &maps.k, bar_kv, kv, k0, b);
    tma_tile<L::NB>(s_v, &maps.v, bar_kv, kv, k0, b);
    for (int t = 0; t < TC_STAGES && t < n_t; ++t) issue(t);
  }
  __syncwarp();

  float dk[L::HB][32], dv[L::HB][32];
#pragma unroll
  for (int c = 0; c < L::HB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;
  const float scale2 = a.scale * LOG2E;          // scores in log2 units
  const int64_t key0 = k0 + 16 * warp + lane / 4;  // this thread's keys: key0, key0 + 8
  if (n_t > 0) mbar_wait(bar_kv, 0);
  for (int t = 0; t < n_t; ++t) {
    const int s = t % TC_STAGES;
    const int64_t q0 = k0 + (t % n_q) * TC_ROWS;
    const uint32_t tq = s_stage + s * 2 * L::TILE, tdo = tq + L::TILE;
    const float* lse_s = vec + s * 2 * TC_ROWS;
    const float* del_s = lse_s + TC_ROWS;
    mbar_wait(bar_full + 8 * s, (t / TC_STAGES) & 1);
    float st[32], dpt[32];
    wgmma_fence();
    issue_abt<L::NB>(st, s_k, tq);    // S^T = K Q^T
    issue_abt<L::NB>(dpt, s_v, tdo);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait();
    fence_regs(st);
    fence_regs(dpt);
    const bool masked = q0 < k0 + TC_ROWS - 1 || q0 + TC_ROWS > a.sq || k0 + TC_ROWS > a.sk ||
                        (a.window > 0 && q0 + TC_ROWS - 1 - k0 >= a.window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;  // query q0 + col
      const float p = exp2_approx(st[i] * scale2 - lse_s[col]);
      const float ds = p * (dpt[i] - del_s[col]);
      bool ok = true;
      if (masked) {
        const int64_t key = key0 + 8 * ((i / 2) % 2), qi = q0 + col;
        ok = qi < a.sq && key < a.sk && key <= qi && (a.window <= 0 || qi - key < a.window);
      }
      st[i] = ok ? p : 0.f;
      dpt[i] = ok ? ds : 0.f;
    }
    uint32_t pa[4][4], dsa[4][4];
    to_frag(st, pa);
    to_frag(dpt, dsa);
    wgmma_fence();
    issue_fb<L::HB>(dv, pa, tdo, half * L::HB);  // dV += P^T dO
    issue_fb<L::HB>(dk, dsa, tq, half * L::HB);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int c = 0; c < L::HB; ++c) {
      fence_regs(dv[c]);
      fence_regs(dk[c]);
    }
    mbar_arrive(bar_empty + 8 * s);
    if (tid == 0 && t + TC_STAGES < n_t) {
      mbar_wait(bar_empty + 8 * s, (t / TC_STAGES) & 1);  // every thread has released the stage
      issue(t + TC_STAGES);
    }
    __syncwarp();
  }

  const int64_t kbase = (static_cast<int64_t>(b) * a.sk * a.kvh + kv) * D;
  store_rows<L::HB>(dk, static_cast<__nv_bfloat16*>(a.dk) + kbase, a.kvh * D, key0, a.sk, half * L::DH, D,
                    a.scale);
  store_rows<L::HB>(dv, static_cast<__nv_bfloat16*>(a.dv) + kbase, a.kvh * D, key0, a.sk, half * L::DH, D,
                    1.f);
}

// 2b. dQ of the 64 queries from q0 of head hh (one half of its columns at
// d 256), summed over the key tiles its rows see, in order.
template <int D>
__device__ __forceinline__ void dq_tile(const Bwd& a, int64_t lse_ld, uint8_t* smem, const TcMaps& maps,
                                        int64_t q0, int hh, int b, int half) {
  using L = TcTiles<D>;
  const uint32_t s_q = smem_addr(smem), s_do = s_q + L::TILE;
  const uint32_t s_stage = s_q + L::STAGE_OFF;  // stage s: K at s_stage + 2 s TILE, then V
  const uint32_t bar_full = s_q + L::BAR_OFF, bar_empty = bar_full + 8 * TC_STAGES;
  const uint32_t bar_q = bar_empty + 8 * TC_STAGES;

  const int kvh = static_cast<int>(hh / (a.h / a.kvh));
  const int64_t q_last = (q0 + TC_ROWS < a.sq ? q0 + TC_ROWS : a.sq) - 1;
  const int64_t k_end = q_last + 1 < a.sk ? q_last + 1 : a.sk;
  int64_t k_begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) k_begin = (q0 - a.window + 1) / TC_ROWS * TC_ROWS;
  const int n_t = k_end > k_begin ? static_cast<int>((k_end - k_begin + TC_ROWS - 1) / TC_ROWS) : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, TC_THREADS);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0: key tile t's K and V into stage t % TC_STAGES.
  const CUtensorMap *mk = &maps.k, *mv = &maps.v;
  auto issue = [&](int t) {
    const int s = t % TC_STAGES;
    const uint32_t bar = bar_full + 8 * s, dst = s_stage + s * 2 * L::TILE;
    const int64_t k0 = k_begin + static_cast<int64_t>(t) * TC_ROWS;
    mbar_expect_tx(bar, 2 * L::TILE);
    tma_tile<L::NB>(dst, mk, bar, kvh, k0, b);
    tma_tile<L::NB>(dst + L::TILE, mv, bar, kvh, k0, b);
  };
  if (tid == 0 && n_t > 0) {
    mbar_expect_tx(bar_q, 2 * L::TILE);
    tma_tile<L::NB>(s_q, &maps.q, bar_q, hh, q0, b);
    tma_tile<L::NB>(s_do, &maps.dout, bar_q, hh, q0, b);
    for (int t = 0; t < TC_STAGES && t < n_t; ++t) issue(t);
  }
  __syncwarp();

  const int64_t row0 = q0 + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = row0 + 8 * r, at = (static_cast<int64_t>(b) * a.h + hh) * lse_ld + row;
    lse_r[r] = row < a.sq ? a.lse[at] : 0.f;
    del_r[r] = row < a.sq ? a.delta[at] : 0.f;
  }
  float dq[L::HB][32];
#pragma unroll
  for (int c = 0; c < L::HB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;
  const float scale2 = a.scale * LOG2E;
  if (n_t > 0) mbar_wait(bar_q, 0);
  for (int t = 0; t < n_t; ++t) {
    const int s = t % TC_STAGES;
    const int64_t k0 = k_begin + static_cast<int64_t>(t) * TC_ROWS;
    const uint32_t tk = s_stage + s * 2 * L::TILE, tv = tk + L::TILE;
    mbar_wait(bar_full + 8 * s, (t / TC_STAGES) & 1);
    float sc[32], dp[32];
    wgmma_fence();
    issue_abt<L::NB>(sc, s_q, tk);   // S = Q K^T
    issue_abt<L::NB>(dp, s_do, tv);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dp);
    const bool masked = k0 + TC_ROWS - 1 > q0 || k0 + TC_ROWS > a.sk || q0 + TC_ROWS > a.sq ||
                        (a.window > 0 && q0 + TC_ROWS - 1 - k0 >= a.window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      const float p = exp2_approx(sc[i] * scale2 - lse_r[r]);
      const float ds = p * (dp[i] - del_r[r]);
      bool ok = true;
      if (masked) {
        const int64_t row = row0 + 8 * r, key = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        ok = row < a.sq && key < a.sk && key <= row && (a.window <= 0 || row - key < a.window);
      }
      dp[i] = ok ? ds : 0.f;
    }
    uint32_t dsa[4][4];
    to_frag(dp, dsa);
    wgmma_fence();
    issue_fb<L::HB>(dq, dsa, tk, half * L::HB);  // dQ += dS K
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int c = 0; c < L::HB; ++c) fence_regs(dq[c]);
    mbar_arrive(bar_empty + 8 * s);
    if (tid == 0 && t + TC_STAGES < n_t) {
      mbar_wait(bar_empty + 8 * s, (t / TC_STAGES) & 1);
      issue(t + TC_STAGES);
    }
    __syncwarp();
  }

  const int64_t qbase = (static_cast<int64_t>(b) * a.sq * a.h + hh) * D;
  store_rows<L::HB>(dq, static_cast<__nv_bfloat16*>(a.dq) + qbase, a.h * D, row0, a.sq, half * L::DH, D,
                    a.scale);
}

// 2. One launch for both: CTA u < n_dkdv takes a key tile (2a), the rest a
// query tile (2b).  Blocks start in order, so the key tiles go first, those
// that the most queries see first (key tile 0), then the query tiles, the
// longest rows first: the query tiles fill the SMs that the lighter key
// tiles free, where two launches would leave them idle until the heaviest
// key tile ends.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_bwd_tc(Bwd a, int64_t lse_ld, int n_dkdv, int nb, const __grid_constant__ TcMaps maps) {
  using L = TcTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int u = blockIdx.x;
  if (u < n_dkdv) {  // (key tile, then batch, KV head, half), key tile 0 first
    const int per = static_cast<int>(a.kvh) * nb * L::HALVES;
    const int r = u % per;
    dkdv_tile<D>(a, lse_ld, smem, maps, static_cast<int64_t>(u / per) * TC_ROWS, r / L::HALVES % a.kvh,
                 r / (L::HALVES * static_cast<int>(a.kvh)), r % L::HALVES);
  } else {  // (query tile, then batch, head, half), the last query tile first
    const int v = u - n_dkdv, per = static_cast<int>(a.h) * nb * L::HALVES;
    const int r = v % per;
    const int64_t n_qt = (a.sq + TC_ROWS - 1) / TC_ROWS;
    dq_tile<D>(a, lse_ld, smem, maps, (n_qt - 1 - v / per) * TC_ROWS, r / L::HALVES % a.h,
               r / (L::HALVES * static_cast<int>(a.h)), r % L::HALVES);
  }
}

// A [B * H, lse_ld] f32 view as a 2-D tensor map, box (64 rows' values, 1).
bool make_vec_map(CUtensorMap* map, const float* base, int64_t ld, int64_t rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ld), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld * 4)};
  const cuuint32_t box[2] = {TC_ROWS, 1};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tc(const Bwd& a, int64_t b, int64_t lse_ld, cudaStream_t s) {
  using L = TcTiles<D>;
  const int64_t qs = a.h * D, ks = a.kvh * D;  // sequence strides, in elements
  TcMaps maps;
  if (!make_map(&maps.q, a.q, D, a.h, a.sq, b, D, qs, a.sq * qs, TC_ROWS) ||
      !make_map(&maps.dout, a.dout, D, a.h, a.sq, b, D, qs, a.sq * qs, TC_ROWS) ||
      !make_map(&maps.k, a.k, D, a.kvh, a.sk, b, D, ks, a.sk * ks, TC_ROWS) ||
      !make_map(&maps.v, a.v, D, a.kvh, a.sk, b, D, ks, a.sk * ks, TC_ROWS) ||
      !make_vec_map(&maps.lse, a.lse, lse_ld, b * a.h) || !make_vec_map(&maps.delta, a.delta, lse_ld, b * a.h))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned bs = static_cast<unsigned>(b);
  flash_bwd_delta<<<dim3(static_cast<unsigned>((a.h * lse_ld + 7) / 8), bs), 256, 0, s>>>(a, lse_ld, D);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_kt = (a.sk + TC_ROWS - 1) / TC_ROWS, n_qt = (a.sq + TC_ROWS - 1) / TC_ROWS;
  const int64_t n_dkdv = n_kt * a.kvh * b * L::HALVES, n_dq = n_qt * a.h * b * L::HALVES;
  flash_bwd_tc<D><<<static_cast<unsigned>(n_dkdv + n_dq), TC_THREADS, L::smem_bytes, s>>>(
      a, lse_ld, static_cast<int>(n_dkdv), static_cast<int>(b), maps);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int64_t d, bool bf16, const Bwd& a, int64_t b, int64_t lse_ld, cudaStream_t s) {
  switch (d) {
    case 16: return bf16 ? launch_bwd<16, __nv_bfloat16>(a, b, s) : launch_bwd<16, float>(a, b, s);
    case 32: return bf16 ? launch_bwd<32, __nv_bfloat16>(a, b, s) : launch_bwd<32, float>(a, b, s);
    case 64: return bf16 ? launch_tc<64>(a, b, lse_ld, s) : launch_bwd<64, float>(a, b, s);
    case 112: return bf16 ? launch_tc<112>(a, b, lse_ld, s) : launch_bwd<112, float>(a, b, s);
    case 128: return bf16 ? launch_tc<128>(a, b, lse_ld, s) : launch_bwd<128, float>(a, b, s);
    case 256: return bf16 ? launch_tc<256>(a, b, lse_ld, s) : launch_bwd<256, float>(a, b, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Every tensor contiguous in the layout above;
// sq and sk at least 1 (the wrapper answers the empty cases itself).
// lse and delta: f32 [B, H, lse_ld].  On the tensor-core route (bf16 at d
// 64 and above) lse holds the forward's log2-sum-exp2 of each row (lse_ld
// a multiple of 64, at least sq) and delta is scratch; on the CUDA-core
// route both are scratch with lse_ld = sq.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
                                   int64_t b, int64_t h, int64_t kvh, int64_t sq, int64_t sk, int64_t d,
                                   double scale, int64_t window, int dtype, int64_t lse_ld, void* stream) {
  if (b == 0 || h == 0 || sq == 0 || sk == 0) return 0;
  Bwd a{q, k, v, o, dout, dq, dk, dv, static_cast<float*>(lse), static_cast<float*>(delta),
        sq, sk, h, kvh, static_cast<float>(scale), window};
  return dispatch(d, dtype == 1, a, b, lse_ld, static_cast<cudaStream_t>(stream));
}
