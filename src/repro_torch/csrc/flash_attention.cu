// Causal flash attention forward: sliding window, GQA, f32 accumulation.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention/kernel.py:94).
// q [B, H, Sq, d], k/v [B, KVH, Sk, d] (strided views: any batch, head
// and sequence strides, the last dimension contiguous), f32 or bf16;
// out in q's dtype and layout.  Query head h reads KV head h / (H / KVH).
// Key j is visible to query i where j <= i and, with window > 0,
// i - j < window; scores are (q . k) * scale.  A row that sees no key
// writes 0 (kernel.py:85-88).
//
// What bounds it on the card: operations (4 d flops per visible
// (query, key) pair; at S = 4,096 the inputs are a few MB), so the
// tensor cores.  The dtype and head dim pick one of two kernels:
//
// * bf16 at d 64 and above: tensor cores (flash_wgmma below). A CTA owns 128 query rows of
//   one (b, h) as two consumer warpgroups of 64 rows (64 rows and one
//   consumer at d 256, whose 128-register O accumulator leaves no room for
//   a second: two spill, and setmaxnreg did not lift ptxas' 168-register
//   budget), plus one producer warp, of which one thread issues TMA
//   loads. Q is loaded once; K and V tiles of 64 keys flow through a ring
//   of 3 stages in shared memory, filled by TMA and handed over with
//   full/empty mbarriers. Tiles stay bf16 with the 128-byte swizzle, as
//   64-column boxes: d 112 is loaded as two boxes whose columns 112..127
//   lie past the tensor's edge, which TMA fills with zeros, so the padded
//   products add nothing. S = Q K^T is wgmma
//   m64n64k16 from shared memory into f32 registers; the online softmax
//   runs on the accumulator fragment (a row's max and sum over its four
//   threads by shuffles, exp2 of pre-scaled scores); P is rounded to bf16
//   in registers and is the register A operand of O += P V, whose B
//   operand is the V tile read MN-major through the descriptor (no
//   transposed copy). Within a warpgroup the steps of a tile run in turn;
//   the two warpgroups overlap each other's softmax with tensor-core work
//   (issuing tile t's Q K^T with tile t - 1's P V inside one warpgroup
//   gained nothing measurable). KV tiles wholly outside the causal and
//   window bounds are never loaded (kernel.py:51-56); a consumer skips the
//   tiles none of its rows sees; masks are applied only on tiles that
//   cross the diagonal, the window edge or Sk. TMA fills rows past Sq and
//   Sk with zeros. The longest rows go first. Departure from the
//   reference: P is rounded to bf16 before the PV product, where the
//   reference keeps it in f32 (kernel.py:61 casts v to f32, so
//   p.astype(v.dtype) at :78 is f32); scores, softmax and the accumulation
//   stay f32. TMA needs 16-byte aligned bases and strides; ops.py raises
//   on a view without them.
//   Where autograd will need it, the wrapper passes an `lse` buffer and
//   the kernel also writes each row's log-sum-exp in log2 units of the
//   scaled scores (m + log2 l, one store a row), which the tensor-core
//   backward (csrc/flash_attention_bwd.cu) reads in place of recomputing
//   Q K^T.
// * f32, and bf16 at d 16 and 32: CUDA cores (flash_simt below), by choice and not as a fallback:
//   the tensor cores take f32 only as TF32, whose 10-bit mantissa would
//   break the f32 contract (atol 2e-5 against the plain version).  One
//   CTA of 256 threads owns a (b, h, 64-query tile) with the softmax state
//   in registers and 4 x 4 register tiles from shared memory.  It is
//   built for d 16 and 32 too (the smoke configs' widths), which the bf16
//   kernel is not: one wgmma k-step is 16 wide and the K tile a 64-column
//   swizzled box.  So bf16 at d 16 and 32 runs here as well
//   (flash_simt<D, __nv_bfloat16>): bf16 loads widened to f32 as they
//   reach shared memory, the output rounded to bf16 as it is stored, and
//   everything between in f32 arithmetic.  P is not rounded to bf16 in
//   this kernel, as it is in the tensor-core one.

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int64_t sq, sk, h, kvh;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float scale;
  int64_t window;
  float* lse;      // null, or [B, H, lse_ld] f32: each row's log2-sum-exp2 (tensor-core kernel)
  int64_t lse_ld;
};

// -------------------------------------------------------------------------
// f32: the CUDA-core kernel.

constexpr int SIMT_BQ = 64;
constexpr int SIMT_THREADS = 256;

__device__ __forceinline__ float half_warp_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
struct SimtTiles {
  static constexpr int BK = D > 128 ? 32 : 64;  // keys per KV tile
  static constexpr int QS = D + 1;               // padded row strides
  static constexpr int KS = D + 1;
  static constexpr int PS = BK + 1;
  static constexpr size_t smem_floats = SIMT_BQ * QS + BK * KS + BK * D + SIMT_BQ * PS;
};

// Thread (ty, tx) of a 16 x 16 layout holds rows 4ty..4ty+3, score
// columns tx + 16j and output columns tx + 16jj.  A row's 16 threads are
// one half-warp, so its max and sum are shuffle reductions and its P row
// goes through shared memory with only a warp barrier.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// T is the element type of q, k, v and out (float or __nv_bfloat16);
// shared memory, scores, softmax and the accumulation are f32.
template <int D, typename T>
__global__ void __launch_bounds__(SIMT_THREADS) flash_simt(Args a) {
  using L = SimtTiles<D>;
  constexpr int BQ = SIMT_BQ;
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

  for (int e = tid; e < BQ * D; e += SIMT_THREADS) {
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
    for (int e = tid; e < BK * D; e += SIMT_THREADS) {
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
    for (int jj = 0; jj < DJ; ++jj) out[qpos * a.o_ss + tx + 16 * jj] = from_f32<T>(acc[i][jj] * inv);
  }
}

template <int D, typename T = float>
int launch_simt(const Args& a, int64_t b, cudaStream_t s) {
  const size_t bytes = SimtTiles<D>::smem_floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_simt<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.sq + SIMT_BQ - 1) / SIMT_BQ), static_cast<unsigned>(a.h),
                  static_cast<unsigned>(b));
  flash_simt<D, T><<<grid, SIMT_THREADS, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------------------------
// bf16: the tensor-core kernel.

constexpr int BN = 64;             // keys per KV tile
constexpr int WG_THREADS = 128;
constexpr int KV_BOX = BN * 128;   // bytes of one K or V box
constexpr float LOG2E = 1.4426950408889634f;

// Consumer warpgroups of 64 query rows: two, except at d 256, where one
// warpgroup's 128-register O accumulator leaves no room for a second
// within the register file.
constexpr int consumers_for(int d) { return d > 128 ? 1 : 2; }

template <int D>
struct Tiles {
  static constexpr int CONS = consumers_for(D);
  static constexpr int BM = 64 * CONS;  // query rows per CTA
  static constexpr int THREADS = CONS * WG_THREADS + 32;  // consumers, then the producer warp
  static constexpr int DP = (D + BOX_COLS - 1) / BOX_COLS * BOX_COLS;  // padded head dim
  static constexpr int NB = DP / BOX_COLS;                             // boxes per row
  static constexpr int Q_BOX = BM * 128;  // bytes of one Q box
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int KV_BYTES = NB * KV_BOX;  // one of K, V, one stage
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // 1024-byte alignment of the swizzled boxes, then the barriers.
  static constexpr size_t smem_bytes = 1024 + BAR_OFF + (2 * STAGES + 1) * 8;
};

// The KV tiles a CTA walks: [k_begin, k_begin + n * BN) covers every key
// some row of [q0, q0 + bm) sees.
struct KvRange {
  int64_t k_begin;
  int n;
};

__device__ __forceinline__ KvRange kv_range(const Args& a, int64_t q0, int bm) {
  const int64_t q_last = (q0 + bm < a.sq ? q0 + bm : a.sq) - 1;
  const int64_t k_end = q_last + 1 < a.sk ? q_last + 1 : a.sk;
  int64_t k_begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) k_begin = (q0 - a.window + 1) / BN * BN;
  const int64_t n = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;
  return {k_begin, static_cast<int>(n)};
}

// Accumulator fragment of wgmma m64nNk16 (f32): element i of thread
// (warp w, lane) sits at row 16w + lane/4 + 8 * ((i / 2) % 2) and column
// 8 * (i / 4) + 2 * (lane % 4) + i % 2 of the 64-row tile.
template <int D>
__global__ void __launch_bounds__(Tiles<D>::THREADS, 1)
    flash_wgmma(Args a, const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v) {
  using L = Tiles<D>;
  constexpr int NB = L::NB;
  constexpr int STAGES = L::STAGES;
  constexpr int CONSUMERS = L::CONS;
  constexpr int BM = L::BM;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_q = smem_addr(smem);
  const uint32_t s_k = s_q + L::K_OFF;
  const uint32_t s_v = s_q + L::V_OFF;
  const uint32_t bar_full = s_q + L::BAR_OFF;      // [STAGES]
  const uint32_t bar_empty = bar_full + STAGES * 8;  // [STAGES]
  const uint32_t bar_q = bar_empty + STAGES * 8;

  const int64_t n_qt = (a.sq + BM - 1) / BM;
  const int64_t q0 = (n_qt - 1 - blockIdx.x) * BM;  // the longest rows first
  const int hh = blockIdx.y, b = blockIdx.z;
  const int kvh = static_cast<int>(hh / (a.h / a.kvh));
  const KvRange range = kv_range(a, q0, BM);
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS * WG_THREADS);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer warp: one thread keeps the ring full ----
    if (threadIdx.x == CONSUMERS * WG_THREADS) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load(s_q + c * L::Q_BOX, &tm_q, bar_q, c * BOX_COLS, hh, static_cast<int>(q0), b);
      for (int t = 0; t < range.n; ++t) {
        const int s = t % STAGES;
        mbar_wait(bar_empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * L::KV_BYTES);
        const int k0 = static_cast<int>(range.k_begin) + t * BN;
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load(s_k + s * L::KV_BYTES + c * KV_BOX, &tm_k, bar_full + 8 * s, c * BOX_COLS, kvh,
                   k0, b);
          tma_load(s_v + s * L::KV_BYTES + c * KV_BOX, &tm_v, bar_full + 8 * s, c * BOX_COLS, kvh,
                   k0, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32, lane = tid % 32;
    const int64_t qa = q0 + 64 * wg;                 // this warpgroup's first row
    const int64_t row0 = qa + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
    const float scale = a.scale * LOG2E;             // scores in log2 units

    float o[NB][32];
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    auto key0 = [&](int t) { return range.k_begin + static_cast<int64_t>(t) * BN; };
    // Does some row of this warpgroup see a key of tile t?  Those tiles are
    // contiguous, [t_lo, t_hi); the others are only waited for and released.
    auto seen = [&](int t) {
      return qa < a.sq && key0(t) <= qa + 63 && (a.window <= 0 || key0(t) + BN - 1 > qa - a.window);
    };
    int t_lo = 0;
    while (t_lo < range.n && !seen(t_lo)) ++t_lo;
    int t_hi = t_lo;
    while (t_hi < range.n && seen(t_hi)) ++t_hi;

    auto wait_full = [&](int t) { mbar_wait(bar_full + 8 * (t % STAGES), (t / STAGES) & 1); };
    auto release = [&](int t) { mbar_arrive(bar_empty + 8 * (t % STAGES)); };
    // S = Q K^T over the padded head dim, 16 columns a step.
    auto issue_qk = [&](int t, float(&sc)[32]) {
      const uint32_t k_tile = s_k + (t % STAGES) * L::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < L::DP / 16; ++kk) {
        const uint32_t off = (kk / 4) * KV_BOX + (kk % 4) * 32;  // box, then 16 columns into its rows
        const uint32_t q_off = (kk / 4) * L::Q_BOX + wg * 64 * 128 + (kk % 4) * 32;
        wgmma_ss(sc, desc(s_q + q_off, 16), desc(k_tile + off, 16), kk > 0);
      }
    };
    // O += P V, 16 keys a step, for each 64-column box of O.
    auto issue_pv = [&](int t, const uint32_t(&pa)[4][4]) {
      const uint32_t v_tile = s_v + (t % STAGES) * L::KV_BYTES;
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(o[c], pa[kk], desc(v_tile + c * KV_BOX + kk * 2048, KV_BOX));
    };
    // The online softmax on the fragment of tile t: masks, the new row
    // maxima, P in bf16 (the A operand of P V), alpha for O, l.
    auto softmax = [&](int t, float(&sc)[32], uint32_t(&pa)[4][4], float(&alpha)[2]) {
      const int64_t k0 = key0(t);
      const bool masked = k0 + BN - 1 > qa || k0 + BN > a.sk || (a.window > 0 && qa + 63 - k0 >= a.window);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = sc[i] * scale;
        if (masked) {
          const int64_t row = row0 + 8 * ((i / 2) % 2);
          const int64_t col = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          const bool ok = col < a.sk && col <= row && (a.window <= 0 || row - col < a.window);
          x = ok ? x : -INFINITY;
        }
        sc[i] = x;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // rows row0 (r = 0) and row0 + 8 (r = 1)
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if ((i / 2) % 2 == r) mx = fmaxf(mx, sc[i]);
        const float m_new = fmaxf(m[r], quad_max(mx));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no visible key yet
        alpha[r] = exp2_approx(m[r] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if ((i / 2) % 2 == r) {
            sc[i] = exp2_approx(sc[i] - m_use);
            sum += sc[i];
          }
        l[r] = l[r] * alpha[r] + sum;  // this thread's share; summed over the quad at the end
        m[r] = m_new;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
    };

    float sc[32], alpha[2];
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    mbar_wait(bar_q, 0);
    for (int t = 0; t < t_lo; ++t) {
      wait_full(t);
      release(t);
    }
    for (int t = t_lo; t < t_hi; ++t) {
      wait_full(t);
      wgmma_fence();
      issue_qk(t, sc);
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);
      softmax(t, sc, pa, alpha);
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i / 2) % 2];
      wgmma_fence();
      issue_pv(t, pa);
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int c = 0; c < NB; ++c) fence_regs(o[c]);
      release(t);
    }
    for (int t = t_hi; t < range.n; ++t) {
      wait_full(t);
      release(t);
    }

    // O / l through the strided output view; columns past D are padding.
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + b * a.o_sb + hh * a.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t row = row0 + 8 * r;
      const float lr = quad_sum(l[r]);
      const float inv = lr == 0.f ? 0.f : 1.f / lr;
      if (row >= a.sq) continue;
      // For the backward: log2 of the row's sum of 2^(scaled score), +inf
      // where the row sees no key (its P is then 0 everywhere).
      if (a.lse != nullptr && lane % 4 == 0)
        a.lse[(b * a.h + hh) * a.lse_ld + row] = lr > 0.f ? m[r] + log2f(lr) : INFINITY;
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c * BOX_COLS + 8 * j + 2 * (lane % 4);
          if (col >= D) continue;
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(out + row * a.o_ss + col) =
              __floats2bfloat162_rn(o[c][i] * inv, o[c][i + 1] * inv);
        }
    }
  }
}

template <int D>
int launch_wgmma(const Args& a, int64_t b, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  // The maps index the [B, S, heads, d] views: a [B, H, S, d] stride
  // (batch, head, sequence) becomes (head, sequence, batch).
  if (!make_map(&tq, a.q, D, a.h, a.sq, b, a.q_sh, a.q_ss, a.q_sb, Tiles<D>::BM) ||
      !make_map(&tk, a.k, D, a.kvh, a.sk, b, a.k_sh, a.k_ss, a.k_sb, BN) ||
      !make_map(&tv, a.v, D, a.kvh, a.sk, b, a.v_sh, a.v_ss, a.v_sb, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = Tiles<D>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int BM = Tiles<D>::BM;
  const dim3 grid(static_cast<unsigned>((a.sq + BM - 1) / BM), static_cast<unsigned>(a.h),
                  static_cast<unsigned>(b));
  flash_wgmma<D><<<grid, Tiles<D>::THREADS, bytes, s>>>(a, tq, tk, tv);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int64_t d, bool bf16, const Args& a, int64_t b, cudaStream_t s) {
  switch (d) {
    case 16: return bf16 ? launch_simt<16, __nv_bfloat16>(a, b, s) : launch_simt<16>(a, b, s);
    case 32: return bf16 ? launch_simt<32, __nv_bfloat16>(a, b, s) : launch_simt<32>(a, b, s);
    case 64: return bf16 ? launch_wgmma<64>(a, b, s) : launch_simt<64>(a, b, s);
    case 112: return bf16 ? launch_wgmma<112>(a, b, s) : launch_simt<112>(a, b, s);
    case 128: return bf16 ? launch_wgmma<128>(a, b, s) : launch_simt<128>(a, b, s);
    case 256: return bf16 ? launch_wgmma<256>(a, b, s) : launch_simt<256>(a, b, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: q, k, v, out, each (batch, head, sequence), in elements.
// dtype: 0 = f32, 1 = bf16.  lse: null, or (the tensor-core kernel only)
// [B, H, lse_ld] f32 that receives each row's log-sum-exp in log2 units
// of the scaled scores, which csrc/flash_attention_bwd.cu reads.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int64_t b, int64_t h, int64_t kvh, int64_t sq, int64_t sk,
                               int64_t d, const int64_t* strides, double scale,
                               int64_t window, int dtype, void* lse, int64_t lse_ld,
                               void* stream) {
  if (b == 0 || h == 0 || sq == 0) return 0;
  Args a{q, k, v, out, sq, sk, h, kvh,
         strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
         static_cast<float>(scale), window, static_cast<float*>(lse), lse_ld};
  return dispatch(d, dtype == 1, a, b, static_cast<cudaStream_t>(stream));
}
