// The mma.sync building blocks of the SSD scan kernels (csrc/ssd_scan.cu's
// forward, csrc/ssd_scan_bwd.cu's backward): cp.async row copies, m16n8k8
// TF32 products with f32 operands split into hi + lo TF32 parts (three
// products a tile, so sums stay near f32 precision), the fixed-order
// chunk cumsum and the chunk-state product.  Everything is inline in an
// anonymous namespace, so each kernel compiles it as its own code.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

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

}  // namespace
