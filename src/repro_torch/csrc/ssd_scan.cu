// Mamba2 SSD chunked scan, one B/C group (G = 1).
//
// Replaces ssd_scan_pallas (src/repro/kernels/ssd_scan/kernel.py:92).
// x [B, S, H, P], B/C [B, S, N] (f32 or bf16), dt [B, S, H] and a [H]
// (f32) -> y [B, S, H, P] f32 and the final state [B, H, P, N] f32.
// Each chunk of Q steps sums the terms of kernel.py:48-87:
//   cum    = inclusive cumsum of dt * a within the chunk
//   S[i,j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   for i >= j, else 0
//   y_i    = sum_j S[i,j] x_j + exp(cum_i) * (C_i . h)
//   h      = exp(cum_Q) h + s_c,  s_c = sum_j x_j dt_j exp(cum_Q - cum_j) B_j^T
// (the exponential is taken only where i >= j: above the diagonal it is
// positive and can overflow, and inf * 0 is NaN).
//
// The TPU kernel carries h [P, N] in VMEM across a sequential chunk axis
// of its grid.  Here the work splits along the SSD decomposition of
// repro/models/ssm.py:77-108 into two launches:
//  1. ssd_chunk_kernel, chunk-parallel: one CTA per (b, chunk, group of
//     `heads` heads) computes each head's cum (a fixed-order warp scan,
//     all heads' up front) and its chunk state s_c [P, N] into an f32
//     scratch, the next head's x landing by cp.async while one computes;
//     one more CTA per (b, chunk) computes C B^T [Q, Q] once for all heads
//     (G = 1) into a second scratch.  B x S/Q x (H/heads + 1) CTAs: 896 at
//     mamba2-130m's B = 4, S = 2,048, H = 24, Q = 64 and 4 heads a CTA.
//  2. ssd_pass_kernel: one CTA per (b, h, tile of PT columns of P) walks
//     the chunks in order with h [PT, N] in shared memory.  The next
//     chunk's x tile, C, C B^T and dt land by cp.async while the current
//     one computes; its s_c tile lands while y is computed.  The scores
//     are made in registers as their product loads its fragments; y is
//     written once; then the h update.  B x H x P/PT CTAs: 96 at PT = 64,
//     the widest tile that divides P (scripts/torch_ssd_split.py: PT 16
//     and 32, with 384 and 192 CTAs, were slower: more CTAs load C and
//     C B^T and make the scores again for fewer columns each).
// Eight warps a CTA.  Every product runs on the tensor cores as mma.sync
// m16n8k8 TF32.  An f32 operand goes in as hi + lo, both rounded to TF32
// (to nearest, ties away, as cvt.rna does), and a tile takes three
// products (hi.hi + hi.lo + lo.hi; lo.lo, ~2^-22 relative, is dropped),
// so sums stay near f32 precision: a plain single-pass TF32 keeps ~3
// decimal digits and would not hold the 2e-4 the kernel is held to.  A
// bf16 operand is exact in TF32 (its lo is 0): a product with one bf16
// operand takes two passes, C B^T in bf16 one.  No float sum uses
// atomics, and the state sums over chunks in chunk order, so repeat
// calls are bit-equal.
//
// What bounds it on the card: bytes, 113 MB of inputs and outputs at
// mamba2-130m's widths (0.034 ms at 3.35 TB/s) against 8.9e9 flops (0.018
// ms at TF32's 495 TFLOP/s).  The split adds the s_c round trip through
// device memory, B x H x S/Q x P x N f32 written once and read once
// (2 x 101 MB, ~0.060 ms), and C B^T (2 MB); three products per tile
// triple the tensor-core work.  What sets its time is neither: each
// chunk step of the pass is a chain of dependent loads, products and
// barriers on one CTA an SM (PERF.md).
//
// Shared memory (bytes; T = 4 for f32, 2 for bf16; rows padded so that
// the fragment loads are free of bank conflicts, 16-byte aligned for
// cp.async; ssd_scan/ops.py's card_plan computes the same sizes):
//  chunk kernel: max(Q(N+8)T + QPT + 4Q(P+8) + 4 heads Q, 2Q(N+A)T),
//                A = 4 for f32, 8 for bf16
//  pass kernel:  2 (Q(PT+8)T + Q(N+A)T + 4Q(Q+4) + 4Q) + 8PT(N+4) + 8Q
// (each array rounded up to 16 bytes): 70,656 and 207,872 at
// mamba2-130m's widths in f32, 4 heads, PT = 64.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

// The launches a call makes: 1 the chunk-parallel kernel, 2 the pass, 3
// both (scripts/torch_ssd_split.py builds 1 and 2 to time them alone).
#ifndef SSD_SCAN_PHASES
#define SSD_SCAN_PHASES 3
#endif

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;  // exact in TF32
template <typename T>
constexpr int kPadA = sizeof(T) == 4 ? 4 : 8;  // row pad of an A operand read along its row

__host__ __device__ constexpr int64_t round16(int64_t bytes) { return (bytes + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// (r, c) of the elements threadIdx.x, threadIdx.x + blockDim.x, ... of a
// row-major range with `cols` columns, without a division a step.
struct Walk {
  int r, c;
  const int cols, dr, dc;
  __device__ explicit Walk(int cols_)
      : cols(cols_), dr(blockDim.x / cols_), dc(blockDim.x % cols_) {
    r = threadIdx.x / cols;
    c = threadIdx.x - r * cols;
  }
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// `rows` rows of `row_bytes` (a multiple of 16) from global memory, rows
// `src_ld` bytes apart, into shared memory, rows `dst_ld` bytes apart.
__device__ __forceinline__ void copy_rows(void* dst, int64_t dst_ld, const void* src,
                                          int64_t src_ld, int row_bytes, int rows) {
  for (Walk w(row_bytes / 16); w.r < rows; w.next())
    cp_async16(static_cast<char*>(dst) + w.r * dst_ld + w.c * 16,
               static_cast<const char*>(src) + w.r * src_ld + w.c * 16);
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the bits of cvt.rna.tf32.f32 on finite x, in two integer
// instructions, which the card issues faster than the conversion.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as hi + lo, each a TF32 value; an exact x is its own hi.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of a warp's product, the A fragment given as values (a0..a3
// below): hi.hi into hi, the lo products into la and lb.
template <int NT, bool AX, bool BX, typename TB>
__device__ __forceinline__ void mma_step(float (&hi)[NT][4], float (&la)[NT][4],
                                         float (&lb)[NT][4], const float (&av)[4],
                                         const TB* B, int sbk, int sbn, int n0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[4], al[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) split<AX>(av[r], ah[r], al[r]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const TB* bc = B + (n0 + 8 * nt + g) * sbn;
    uint32_t bh0, bl0, bh1, bl1;
    split<BX>(to_f32(bc[(k0 + t) * sbk]), bh0, bl0);
    split<BX>(to_f32(bc[(k0 + t + 4) * sbk]), bh1, bl1);
    if constexpr (!AX) mma_tf32(la[nt], al, bh0, bh1);
    if constexpr (!BX) mma_tf32(lb[nt], ah, bl0, bl1);
    mma_tf32(hi[nt], ah, bh0, bh1);
  }
}

// One warp: acc[nt] += A[m0 : m0 + 16, 0 : k_end] . B[0 : k_end, n0 + 8 nt : + 8]
// for nt < NT (k_end a multiple of 16), with b(k, n) = B[k * sbk + n * sbn]
// in shared memory and a(m, k) = a_at(m, k) (rows m0 + g and m0 + g + 8 of
// the lane).  AX, BX: the operand is exact in TF32 (its lo products are
// skipped).  The three products sum into accumulators of their own (and,
// for one n-tile, the even and odd k-steps too), so that no mma waits on
// the one before it; they are added in a fixed order at the end.
// Fragments of m16n8k8 TF32: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g); d0, d1 (g, 2t, 2t + 1),
// d2, d3 (g + 8, 2t, 2t + 1); g = lane / 4, t = lane % 4.
template <int NT, bool AX, bool BX, typename AAt, typename TB>
__device__ __forceinline__ void warp_mma_with(float (&acc)[NT][4], AAt a_at, const TB* B, int sbk,
                                              int sbn, int m0, int n0, int k_end) {
  constexpr int PAR = NT == 1 ? 2 : 1;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int i0 = m0 + g, i1 = i0 + 8;
  float p[3][PAR][NT][4] = {};
#pragma unroll 2
  for (int k0 = 0; k0 < k_end; k0 += 8 * PAR) {
#pragma unroll
    for (int q = 0; q < PAR; ++q) {
      const int k = k0 + 8 * q;
      const float av[4] = {a_at(i0, k + t), a_at(i1, k + t), a_at(i0, k + t + 4),
                           a_at(i1, k + t + 4)};
      mma_step<NT, AX, BX>(p[0][q], p[1][q], p[2][q], av, B, sbk, sbn, n0, k);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float lo = 0.f, hi = 0.f;
#pragma unroll
      for (int q = 0; q < PAR; ++q) {
        lo += p[1][q][nt][r] + p[2][q][nt][r];
        hi += p[0][q][nt][r];
      }
      acc[nt][r] += lo + hi;
    }
}

// warp_mma_with for an A in shared memory, a(m, k) = A[m * sam + k * sak].
template <int NT, bool AX, bool BX, typename TA, typename TB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const TA* A, int sam, int sak,
                                         const TB* B, int sbk, int sbn, int m0, int n0,
                                         int k_end) {
  warp_mma_with<NT, AX, BX>(
      acc, [=](int m, int k) { return to_f32(A[m * sam + k * sak]); }, B, sbk, sbn, m0, n0, k_end);
}

// A warp's [16, 8 NT] accumulator tile to rows m0.. and columns n0.. of a
// row-major f32 matrix with rows `ld` floats apart.
template <int NT>
__device__ __forceinline__ void store_tile(const float (&acc)[NT][4], float* out, int64_t ld,
                                           int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float* r = out + (m0 + g) * ld + n0 + 8 * nt + 2 * t;
    *reinterpret_cast<float2*>(r) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(r + 8 * ld) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// One warp: cum[i] = sum_{j <= i} dt[j * stride] * a for i < q, in a fixed
// order: each lane sums its run of consecutive terms, the warp scans the
// runs' sums with shuffles, and each lane adds its terms onto the sum of
// the runs before it.  No CUB: its order is not fixed.
__device__ __forceinline__ void chunk_cumsum(const float* dt, int64_t stride, float a, int q,
                                             float* cum) {
  const int lane = threadIdx.x & 31;
  const int per = (q + 31) / 32, j0 = lane * per;
  float run = 0.f;
  for (int e = 0; e < per; ++e)
    if (j0 + e < q) run += dt[(j0 + e) * stride] * a;
  float inc = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  float before = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) before = 0.f;
  for (int e = 0; e < per; ++e)
    if (j0 + e < q) {
      before += dt[(j0 + e) * stride] * a;
      cum[j0 + e] = before;
    }
}

// A chunk state s_c [P, N] = xd^T B into `out`, the warps taking tiles of
// 16 x 8 NT in turn (xd [Q][ldx] f32, B [Q][ldb] in shared memory).
template <int NT, typename T>
__device__ __forceinline__ void state_tiles(const float* xd, int ldx, const T* bs, int ldb,
                                            float* out, int P, int N, int Q) {
  const int warp = threadIdx.x >> 5, mt = P / 16, nt = N / (8 * NT);
  for (int u = warp; u < mt * nt; u += WARPS) {
    const int mi = u / nt, nj = u - mi * nt;
    float acc[NT][4] = {};
    warp_mma<NT, false, kExact<T>>(acc, xd, 1, ldx, bs, ldb, 1, mi * 16, nj * 8 * NT, Q);
    store_tile<NT>(acc, out, N, mi * 16, nj * 8 * NT);
  }
}

// Phase 1.  blockIdx = (head group, or `groups` for C B^T; chunk; b).
// cb: [B, S/Q, Q, Q] (only blocks on and below the diagonal are written);
// sc: [B, H, S/Q, P, N].
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const T* __restrict__ bm,
                     const T* __restrict__ cm, float* __restrict__ cb, float* __restrict__ sc,
                     int64_t S, int H, int P, int N, int Q, int heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nc = static_cast<int>(S / Q), c = blockIdx.y, warp = threadIdx.x >> 5;
  const int64_t b = blockIdx.z, row0 = b * S + static_cast<int64_t>(c) * Q;
  const int groups = gridDim.x - 1;

  if (blockIdx.x == groups) {  // C B^T, once per (b, chunk)
    const int ld = N + kPadA<T>;
    T* cs = reinterpret_cast<T*>(smem);
    T* bs = cs + Q * ld;
    copy_rows(cs, ld * sizeof(T), cm + row0 * N, N * sizeof(T), N * sizeof(T), Q);
    copy_rows(bs, ld * sizeof(T), bm + row0 * N, N * sizeof(T), N * sizeof(T), Q);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const int mt = Q / 16;
    float* out = cb + (b * nc + c) * static_cast<int64_t>(Q) * Q;
    for (int u = warp; u < mt * mt; u += WARPS) {
      const int mi = u / mt, nj = u - mi * mt;
      if (nj > mi) continue;  // wholly above the diagonal: never read
      float acc[2][4] = {};
      warp_mma<2, kExact<T>, kExact<T>>(acc, cs, ld, 1, bs, 1, ld, mi * 16, nj * 16, N);
      store_tile<2>(acc, out, Q, mi * 16, nj * 16);
    }
    return;
  }

  // s_c for each head of the group: s_c[p, n] = sum_j (x[j, p] dec_j) B[j, n].
  // B lands once; each head's x lands by cp.async while the head before it
  // computes; every head's dec_j = dt_j exp(cum_Q - cum_j) up front, a
  // warp a head.
  const int ldb = N + 8, ldx = P + 8, lane = threadIdx.x & 31;
  const int h0 = blockIdx.x * heads, nh = min(heads, H - h0);
  T* bs = reinterpret_cast<T*>(smem);                                   // [Q][N + 8]
  unsigned char* rest = smem + round16(static_cast<int64_t>(Q) * ldb * sizeof(T));
  T* xr = reinterpret_cast<T*>(rest);                                   // [Q][P] raw x
  rest += round16(static_cast<int64_t>(Q) * P * sizeof(T));
  float* xd = reinterpret_cast<float*>(rest);                           // [Q][P + 8]
  float* decs = reinterpret_cast<float*>(rest + round16(4LL * Q * ldx));  // [heads][Q]
  const int64_t x_ld = static_cast<int64_t>(H) * P * sizeof(T);
  copy_rows(bs, ldb * sizeof(T), bm + row0 * N, N * sizeof(T), N * sizeof(T), Q);
  copy_rows(xr, P * sizeof(T), x + (row0 * H + h0) * P, x_ld, P * sizeof(T), Q);
  cp_async_commit();
  for (int k = warp; k < nh; k += WARPS) {
    const float* dth = dt + row0 * H + h0 + k;
    float* dec = decs + k * Q;
    chunk_cumsum(dth, H, a[h0 + k], Q, dec);
    __syncwarp();
    const float total = dec[Q - 1];
    __syncwarp();
    for (int j = lane; j < Q; j += 32) dec[j] = dth[j * H] * expf(total - dec[j]);
  }
  for (int k = 0; k < nh; ++k) {
    cp_async_wait_all();
    __syncthreads();  // head k's x landed; head k - 1's products are done
    const float* dec = decs + k * Q;
    for (Walk w(P); w.r < Q; w.next()) xd[w.r * ldx + w.c] = to_f32(xr[w.r * P + w.c]) * dec[w.r];
    __syncthreads();
    if (k + 1 < nh) {
      copy_rows(xr, P * sizeof(T), x + (row0 * H + h0 + k + 1) * P, x_ld, P * sizeof(T), Q);
      cp_async_commit();
    }
    float* out = sc + ((b * H + h0 + k) * nc + c) * static_cast<int64_t>(P) * N;
    if (N % 32 == 0)
      state_tiles<4>(xd, ldx, bs, ldb, out, P, N, Q);
    else
      state_tiles<2>(xd, ldx, bs, ldb, out, P, N, Q);
  }
}

// The per-chunk inputs of the pass that are double-buffered, in shared
// memory (s_c, read once at the end of its chunk, has one buffer).
template <typename T, int PT>
struct Stage {
  T* xs;      // [Q][PT + 8]  x tile
  T* cs;      // [Q][N + A]   C
  float* qs;  // [Q][Q + 4]   C B^T
  float* ds;  // [Q]          dt

  __device__ Stage(unsigned char* p, int Q, int N) {
    xs = reinterpret_cast<T*>(p);
    p += round16(static_cast<int64_t>(Q) * (PT + 8) * sizeof(T));
    cs = reinterpret_cast<T*>(p);
    p += round16(static_cast<int64_t>(Q) * (N + kPadA<T>) * sizeof(T));
    qs = reinterpret_cast<float*>(p);
    p += round16(4LL * Q * (Q + 4));
    ds = reinterpret_cast<float*>(p);
  }
  static __host__ __device__ int64_t bytes(int Q, int N) {
    return round16(static_cast<int64_t>(Q) * (PT + 8) * sizeof(T)) +
           round16(static_cast<int64_t>(Q) * (N + kPadA<T>) * sizeof(T)) +
           round16(4LL * Q * (Q + 4)) + round16(4LL * Q);
  }
};

// Phase 2.  blockIdx = (P tile, head, b).  Each warp owns output units of
// 16 rows x 8 NT columns, (Q/16) x PT/(8 NT) of them a chunk.
template <typename T, int PT>
__global__ void __launch_bounds__(THREADS)
    ssd_pass_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ cm,
                    const float* __restrict__ cb, const float* __restrict__ sc,
                    float* __restrict__ y, float* __restrict__ hout, int64_t S, int H, int P,
                    int N, int Q) {
  constexpr int NT = PT / 16;  // two units of 16 x 8 NT to a 16-row tile
  constexpr int UNITS_PER_ROW = 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nc = static_cast<int>(S / Q), hh = blockIdx.y, p0 = blockIdx.x * PT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t b = blockIdx.z;
  const int ldx = PT + 8, ldc = N + kPadA<T>, ldq = Q + 4, ldh = N + 4;
  const int64_t stage_bytes = Stage<T, PT>::bytes(Q, N);
  float* ss = reinterpret_cast<float*>(smem + 2 * stage_bytes);  // [PT][N + 4] s_c tile
  float* hs = ss + PT * ldh;                                     // [PT][N + 4] h tile
  float* cum = hs + PT * ldh;
  float* ecum = cum + Q;
  const float ah = a[hh];

  auto issue = [&](int c, const Stage<T, PT>& st) {
    const int64_t row0 = b * S + static_cast<int64_t>(c) * Q;
    copy_rows(st.xs, ldx * sizeof(T), x + (row0 * H + hh) * P + p0, H * P * sizeof(T),
              PT * sizeof(T), Q);
    copy_rows(st.cs, ldc * sizeof(T), cm + row0 * N, N * sizeof(T), N * sizeof(T), Q);
    copy_rows(st.qs, ldq * 4, cb + (b * nc + c) * static_cast<int64_t>(Q) * Q, Q * 4, Q * 4, Q);
    for (int j = threadIdx.x; j < Q; j += THREADS) cp_async4(st.ds + j, dt + (row0 + j) * H + hh);
    cp_async_commit();
  };

  for (int e = threadIdx.x; e < PT * ldh; e += THREADS) hs[e] = 0.f;
  issue(0, Stage<T, PT>(smem, Q, N));
  for (int c = 0; c < nc; ++c) {
    const Stage<T, PT> st(smem + (c & 1) * stage_bytes, Q, N);
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; chunk c - 1 (its stage, its h update) is done
    copy_rows(ss, ldh * 4, sc + (((b * H + hh) * nc + c) * static_cast<int64_t>(P) + p0) * N,
              N * 4, N * 4, PT);
    cp_async_commit();
    if (c + 1 < nc) issue(c + 1, Stage<T, PT>(smem + ((c + 1) & 1) * stage_bytes, Q, N));
    if (warp == 0) {
      chunk_cumsum(st.ds, 1, ah, Q, cum);
      __syncwarp();
      for (int i = lane; i < Q; i += 32) ecum[i] = expf(cum[i]);
    }
    __syncthreads();
    // The scores S[i, j] = (C B^T)[i, j] exp(cum_i - cum_j) dt_j for i >= j,
    // else 0, made in registers as product 1 loads its A fragments (the
    // exponent is clamped at 0, which it never passes where i >= j, so no
    // exponential overflows).
    const float* qs = st.qs;
    const float* ds = st.ds;
    const auto score = [=](int i, int j) {
      return i >= j ? qs[i * ldq + j] * expf(fminf(cum[i] - cum[j], 0.f)) * ds[j] : 0.f;
    };
    for (int u = warp; u < (Q / 16) * UNITS_PER_ROW; u += WARPS) {
      const int m0 = u / UNITS_PER_ROW * 16, n0 = u % UNITS_PER_ROW * 8 * NT;
      float diag[NT][4] = {}, off[NT][4] = {};
      // scores . x over the keys up to the diagonal block, then C . h^T.
      warp_mma_with<NT, false, kExact<T>>(diag, score, st.xs, ldx, 1, m0, n0, m0 + 16);
      warp_mma<NT, kExact<T>, false>(off, st.cs, ldc, 1, hs, 1, ldh, m0, n0, N);
      const float e0 = ecum[m0 + g], e1 = ecum[m0 + g + 8];
      float* yr = y + ((b * S + static_cast<int64_t>(c) * Q + m0 + g) * H + hh) * P + p0 + n0;
      const int64_t row8 = 8LL * H * P;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float* r = yr + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(r) =
            make_float2(diag[nt][0] + e0 * off[nt][0], diag[nt][1] + e0 * off[nt][1]);
        *reinterpret_cast<float2*>(r + row8) =
            make_float2(diag[nt][2] + e1 * off[nt][2], diag[nt][3] + e1 * off[nt][3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // every read of h for this chunk's y is done; s_c landed
    const float decay = expf(cum[Q - 1]);
    for (Walk w(N / 4); w.r < PT; w.next()) {
      float4* h = reinterpret_cast<float4*>(hs + w.r * ldh) + w.c;
      const float4 v = reinterpret_cast<const float4*>(ss + w.r * ldh)[w.c];
      const float4 u = *h;
      *h = make_float4(decay * u.x + v.x, decay * u.y + v.y, decay * u.z + v.z, decay * u.w + v.w);
    }
  }
  __syncthreads();
  float* ho = hout + ((b * H + hh) * P + p0) * static_cast<int64_t>(N);
  for (Walk w(N); w.r < PT; w.next()) ho[static_cast<int64_t>(w.r) * N + w.c] = hs[w.r * ldh + w.c];
}

template <typename T>
int64_t chunk_smem(int P, int N, int Q, int heads) {
  const int64_t sc_role = round16(static_cast<int64_t>(Q) * (N + 8) * sizeof(T)) +
                          round16(static_cast<int64_t>(Q) * P * sizeof(T)) +
                          round16(4LL * Q * (P + 8)) + 4LL * heads * Q;
  const int64_t cb_role = 2 * static_cast<int64_t>(Q) * (N + kPadA<T>) * sizeof(T);
  return sc_role > cb_role ? sc_role : cb_role;
}

template <typename T, int PT>
int64_t pass_smem(int N, int Q) {
  return 2 * Stage<T, PT>::bytes(Q, N) + 8LL * PT * (N + 4) + 8LL * Q;
}

template <typename T, int PT>
int launch(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
           void* y, void* hout, void* scratch, int64_t B, int64_t S, int64_t H, int64_t P,
           int64_t N, int64_t Q, int64_t heads, cudaStream_t s) {
  const int64_t nc = S / Q;
  float* cb = static_cast<float*>(scratch);
  float* sc = cb + B * nc * Q * Q;
  const int64_t smem1 = chunk_smem<T>(P, N, Q, static_cast<int>(heads)), smem2 = pass_smem<T, PT>(N, Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem1));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_pass_kernel<T, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = static_cast<int>((H + heads - 1) / heads);
  if (SSD_SCAN_PHASES & 1)
    ssd_chunk_kernel<T><<<dim3(groups + 1, static_cast<unsigned>(nc), static_cast<unsigned>(B)),
                        THREADS, smem1, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(bm), static_cast<const T*>(cm), cb, sc, S, static_cast<int>(H),
      static_cast<int>(P), static_cast<int>(N), static_cast<int>(Q), static_cast<int>(heads));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (SSD_SCAN_PHASES & 2)
    ssd_pass_kernel<T, PT><<<dim3(static_cast<unsigned>(P / PT), static_cast<unsigned>(H),
                                static_cast<unsigned>(B)),
                           THREADS, smem2, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(cm), cb, sc, static_cast<float*>(y), static_cast<float*>(hout), S,
      static_cast<int>(H), static_cast<int>(P), static_cast<int>(N), static_cast<int>(Q));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tile(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                void* y, void* hout, void* scratch, int64_t B, int64_t S, int64_t H, int64_t P,
                int64_t N, int64_t Q, int64_t heads, int64_t p_tile, cudaStream_t s) {
  if (p_tile == 16)
    return launch<T, 16>(x, dt, a, bm, cm, y, hout, scratch, B, S, H, P, N, Q, heads, s);
  if (p_tile == 32)
    return launch<T, 32>(x, dt, a, bm, cm, y, hout, scratch, B, S, H, P, N, Q, heads, s);
  if (p_tile == 64)
    return launch<T, 64>(x, dt, a, bm, cm, y, hout, scratch, B, S, H, P, N, Q, heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype of x, B and C: 0 = f32, 1 = bf16.  S is a multiple of Q; Q, P and
// N are multiples of 16; p_tile (16 or 32) divides P; `scratch` holds
// B (S/Q) Q^2 + B H (S/Q) P N floats.  ssd_scan/ops.py checks all of it.
extern "C" int ssd_scan(const void* x, const void* dt, const void* a, const void* bm,
                        const void* cm, void* y, void* hout, void* scratch, int64_t B, int64_t S,
                        int64_t H, int64_t P, int64_t N, int64_t Q, int64_t heads, int64_t p_tile,
                        int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_tile<float>(x, dt, a, bm, cm, y, hout, scratch, B, S, H, P, N, Q,
                                         heads, p_tile, s)
                    : launch_tile<__nv_bfloat16>(x, dt, a, bm, cm, y, hout, scratch, B, S, H, P,
                                                 N, Q, heads, p_tile, s);
}
