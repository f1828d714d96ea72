// Single-token GQA attention over the paged, copy-on-write KV pool,
// split over the sequence (flash-decoding).
//
// Replaces paged_attention_pallas (src/repro/kernels/paged_attention/kernel.py:210)
// and, with DELTA, paged_attention_delta_pallas (kernel.py:142).
//   out[b, h] = softmax_s(q[b, h] . K[b, s] * scale) @ V[b, s]
// over the slots s < lengths[b] of row b's pages, read through its block
// table; NULL (-1) pages are skipped, and a row with no valid slot
// writes 0 (the TPU kernels' _finalize).  Under DELTA, slot s of page t
// reads page t where dirty[t, s], else parent[t] (t itself when
// parent[t] < 0): shared prefixes are attended in place, never copied.
// That address is the only difference between the variants: one
// template, one split and one order of arithmetic, so they give
// bit-identical outputs whenever they resolve to the same bytes.
//
// Layout: q and out [B, H, D] contiguous; the pools are strided views
// (one layer's K or V slice of the [blocks, L, 2, bs, KVH, D] pool), so
// the element (t, s, h, d) sits at t*bstride + s*sstride + h*hstride + d.
// Nothing is made contiguous: that would copy the whole pool per layer.
//
// What bounds it on the card: bytes.  Each live K/V slot is read once
// per KV head (512 bytes at d 128 in bf16) for 4*G*D flops, about 6
// flops a byte at starcoder2-3b's G = 12, far below the bf16 tensor-core
// ridge (~295).  At decode shapes the bytes are few (a few MB, 1.3 us at
// the memory rate), so what costs is latency: too few CTAs, and loads
// that wait on each other.  The design:
//
// * Split over the sequence.  The grid is (splits, KVH, B); CTA (sp, kh, b)
//   covers a fixed run of the row's pages (ops.py's split_plan picks the
//   run from the shapes alone, for at least two CTAs per SM at the serve
//   shape) and leaves its partial state (max m, sum l, acc[G, D], f32) in
//   a workspace.  paged_attention_combine, a second kernel, merges a
//   row's splits in split order, so a call's result does not depend on
//   which CTA finishes first and repeats bit for bit.  A split with no
//   valid slot leaves l = 0 and is skipped by the merge.
// * Loads in flight.  A CTA's warps take the split's tiles of 16 slots in
//   a fixed interleave (warp w: tiles w, w + W, ...), each warp with its
//   own ring of two stages in shared memory and no CTA barrier in the
//   loop.  Lanes 0..15 resolve a tile's 16 slots once (table, length and,
//   under DELTA, dirty and parent) to row offsets; the K and V rows then
//   move as 16-byte cp.async, neighbouring lanes on neighbouring 16-byte
//   chunks of a row, invalid slots zero-filled.  The next tile's loads
//   are issued before this tile's arithmetic.  The bytes are few, so a
//   CTA's chain of dependent loads sets its time: the first tile's table
//   entries load beside the length, a delta slot's dirty byte beside its
//   parent, and Q moves by cp.async beside the first tile.
// * Products on the tensor cores (bf16 pools).  mma.sync m16n8k16 with
//   the G <= 16 query heads of a KV head as the 16 rows (zero rows past
//   G): S = Q K^T with K's rows as stored as the B operand (ldmatrix),
//   then O += P V with V through ldmatrix.trans.  Q's fragments (d <= 128)
//   and O stay in registers; the online softmax runs on the accumulator
//   fragments with quad shuffles.  P is not rounded to bf16: it is split
//   into a bf16 high part and a bf16 remainder and both are multiplied,
//   so P keeps ~16 bits as the reference's f32 P (kernel.py:56-70) does.
// * f32 pools (the smoke config) use the same split, tiles and loads,
//   with f32 FMAs on the CUDA cores: TF32 would lose the f32 contract.
//
// Within a CTA the warps' states merge in warp order in shared memory
// (each warp's factor e^(m_w - M) computed once per head) before the
// workspace write.  Rows staged in shared memory are padded by 16 bytes,
// so ldmatrix's eight row addresses fall in distinct banks.  Built for
// d in {16, 64, 128, 256} (the dense configs') and G <= 16; ops.py raises
// on anything else.

#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;    // slots per warp tile
constexpr int kRows = 16;    // query-head rows of an mma tile (G <= 16)
constexpr int kStages = 2;   // per-warp ring depth
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* tables;
  const int32_t* lengths;
  const int32_t* parent;
  const uint8_t* dirty;
  void* out;
  float* ws;  // [B, KVH, splits, G * (D + 2)]: acc[G][D], m[G], l[G]
  int H, KVH, G, BS, NB, pages_per_split, splits;
  int64_t bstride, sstride, hstride;
  float scale;
};

template <typename T, int D>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kElem = sizeof(T);
  static constexpr int kStride = D + 16 / kElem;      // staged row, elements
  static constexpr int kChunks = D * kElem / 16;      // 16-byte chunks per row
  static constexpr int kStageElems = 2 * kTile * kStride;  // K rows, then V rows
  static constexpr int kRingBytes = kStages * kStageElems * kElem;  // per warp
  static constexpr int kWarps = kRingBytes <= 24 * 1024 ? 4 : 2;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kQBytes = kRows * kStride * kElem;
  // f32 only: a warp's P tile [16][17] and its 16 rescale factors.
  static constexpr int kScratchFloats = kF32 ? kRows * (kTile + 1) + kRows : 0;
  // The warps' states for the CTA merge reuse the ring.
  static constexpr int kMergeFloats = kRows * D + 2 * kRows;
  static_assert(kMergeFloats * 4 <= kRingBytes, "merge buffer must fit in the ring");
  static constexpr size_t kSmem =
      static_cast<size_t>(kQBytes) + kWarps * (kRingBytes + kScratchFloats * 4);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ok false nothing is read and the 16
// bytes are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as a bf16 pair plus the bf16 pair of what that rounding lost.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}
__device__ __forceinline__ float half_max(float x) {
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// The table entry of slot `lane` of `tile` (lanes < 16), -1 past the
// table.  It does not read the length, so the first tile's entries load
// beside it.
__device__ __forceinline__ int tile_page(const Params& p, int b, int tile, int lane) {
  const int j = (tile * kTile + lane) / p.BS;
  return lane < kTile && j < p.NB ? p.tables[static_cast<int64_t>(b) * p.NB + j] : -1;
}

// Resolves the 16 slots of `tile` (lane i < 16: slot i, on page entry t)
// to row offsets and issues their K and V rows into `stage` (K rows, then
// V rows) as 16-byte cp.async; slots past the length or on a NULL page
// are zero-filled.  Returns the mask of valid slots (0: nothing issued).
template <typename T, bool DELTA, int D>
__device__ __forceinline__ uint32_t issue_tile(const Params& p, int kh, int len, int tile, int t,
                                               T* stage, int lane) {
  using C = Cfg<T, D>;
  int64_t off = 0;
  bool valid = false;
  if (lane < kTile) {
    const int pos = tile * kTile + lane;
    if (pos < len && t >= 0) {
      const int s = pos % p.BS;
      int src = t;
      if (DELTA) {  // both loads in flight together
        const bool dirty = p.dirty[static_cast<int64_t>(t) * p.BS + s];
        const int par = p.parent[t];
        if (!dirty && par >= 0) src = par;
      }
      off = src * p.bstride + s * p.sstride + kh * p.hstride;
      valid = true;
    }
  }
  const uint32_t mask = __ballot_sync(kFull, valid);
  if (mask == 0) return 0;
  const char* kb = static_cast<const char*>(p.k);
  const char* vb = static_cast<const char*>(p.v);
  // 2 * 16 rows of kChunks chunks over 32 lanes: kChunks per lane.
#pragma unroll
  for (int i = 0; i < C::kChunks; ++i) {
    const int c = lane + 32 * i;
    const int which = c / (kTile * C::kChunks);
    const int r = (c / C::kChunks) % kTile;
    const int col = c % C::kChunks;
    const int64_t o = __shfl_sync(kFull, off, r);
    const bool ok = (mask >> r) & 1u;
    const char* src = (which ? vb : kb) + (ok ? o * C::kElem : 0) + col * 16;
    const T* dst = stage + (which * kTile + r) * C::kStride;
    cp_async16(smem_u32(dst) + col * 16, src, ok);
  }
  return mask;
}

// One warp's online-softmax state on the tensor cores (bf16).  Fragment
// rows are query heads (lane / 4 and lane / 4 + 8), columns slots or d.
template <int D>
struct MmaWarp {
  static constexpr bool kQRegs = D <= 128;  // d 256: Q fragments from shared memory
  static constexpr int kKSteps = D / 16;
  float m[2], l[2];
  float acc[D / 8][4];
  uint32_t qa[kQRegs ? kKSteps : 1][4];
  uint32_t q_addr;
  int G;

  __device__ __forceinline__ void init(const __nv_bfloat16* qs, int g, int lane) {
    using C = Cfg<__nv_bfloat16, D>;
    G = g;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    // A fragment x4: rows (lane / 8 & 1) * 8 + lane % 8, columns (lane / 16) * 8.
    q_addr = smem_u32(qs + (((lane >> 3) & 1) * 8 + (lane & 7)) * C::kStride + (lane >> 4) * 8);
    if constexpr (kQRegs) {
#pragma unroll
      for (int k = 0; k < kKSteps; ++k) ldmatrix_x4(qa[k], q_addr + k * 32);
    }
  }

  __device__ __forceinline__ void tile(const __nv_bfloat16* stage, uint32_t mask, float scale,
                                       int lane) {
    using C = Cfg<__nv_bfloat16, D>;
    const __nv_bfloat16* ks = stage;
    const __nv_bfloat16* vs = stage + kTile * C::kStride;
    // S = Q K^T: K x4 = slots (lane / 16) * 8 + lane % 8, d (lane / 8 & 1) * 8.
    float s[2][4] = {};
    const uint32_t k_addr =
        smem_u32(ks + ((lane >> 4) * 8 + (lane & 7)) * C::kStride + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int k = 0; k < kKSteps; ++k) {
      uint32_t a[4];
      if constexpr (kQRegs) {
        a[0] = qa[k][0]; a[1] = qa[k][1]; a[2] = qa[k][2]; a[3] = qa[k][3];
      } else {
        ldmatrix_x4(a, q_addr + k * 32);
      }
      uint32_t kb[4];
      ldmatrix_x4(kb, k_addr + k * 32);
      mma_bf16(s[0], a, kb[0], kb[1]);
      mma_bf16(s[1], a, kb[2], kb[3]);
    }
    // Online softmax on the fragments; slot n * 8 + 2 * (lane % 4) + (e & 1).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = n * 8 + (lane & 3) * 2 + (e & 1);
        const float x = (mask >> slot) & 1u ? s[n][e] * scale : -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));  // finite: the tile has a valid slot
      alpha[r] = expf(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = expf(s[n][e] - m[e >> 1]);
        s[n][e] = pv;
        sum[e >> 1] += pv;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }
    // P as the A operand (k = slot), in a bf16 high part and remainder.
    uint32_t ph[4], pl[4];
    split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
    split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
    split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
    split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
    // O += P V: V x4.trans = slots (lane / 8 & 1) * 8 + lane % 8, d (lane / 16) * 8.
    const uint32_t v_addr =
        smem_u32(vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * C::kStride + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, v_addr + n * 32);
      mma_bf16(acc[2 * n], ph, vb[0], vb[1]);
      mma_bf16(acc[2 * n], pl, vb[0], vb[1]);
      mma_bf16(acc[2 * n + 1], ph, vb[2], vb[3]);
      mma_bf16(acc[2 * n + 1], pl, vb[2], vb[3]);
    }
  }

  // acc[G][D], m[G], l[G] of this warp into `mb` (rows < G only).
  __device__ __forceinline__ void store(float* mb, int lane) {
    const float lt[2] = {quad_sum(l[0]), quad_sum(l[1])};
    const int r0 = lane >> 2, c0 = (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (r0 < G) *reinterpret_cast<float2*>(mb + r0 * D + n * 8 + c0) = make_float2(acc[n][0], acc[n][1]);
      if (r0 + 8 < G)
        *reinterpret_cast<float2*>(mb + (r0 + 8) * D + n * 8 + c0) = make_float2(acc[n][2], acc[n][3]);
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r0 + 8 * r < G) {
          mb[kRows * D + r0 + 8 * r] = m[r];
          mb[kRows * D + kRows + r0 + 8 * r] = lt[r];
        }
      }
    }
  }
};

// One warp's state on the CUDA cores (f32).  Scores: lane = (slot
// lane % 16, heads lane / 16 + 2i); P V: lane owns d-chunks of 4 floats
// lane + 32j for every head.
template <int D>
struct SimtWarp {
  static constexpr int kCh = (D / 4 + 31) / 32;
  float m[8], l[8];
  float4 acc[kRows][kCh];
  float* ps;     // [16][17] this tile's P
  float* alpha;  // [16]
  const float* qs;
  int G;

  __device__ __forceinline__ void init(const float* q_smem, float* scratch, int g) {
    qs = q_smem;
    ps = scratch;
    alpha = scratch + kRows * (kTile + 1);
    G = g;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
#pragma unroll
    for (int g2 = 0; g2 < kRows; ++g2)
#pragma unroll
      for (int j = 0; j < kCh; ++j) acc[g2][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  __device__ __forceinline__ void tile(const float* stage, uint32_t mask, float scale, int lane) {
    using C = Cfg<float, D>;
    const float* ks = stage;
    const float* vs = stage + kTile * C::kStride;
    const int sl = lane & 15, half = lane >> 4;
    const int pairs = (G + 1) / 2;  // head pairs; uniform across the warp
    float dot[8] = {};
    const float* krow = ks + sl * C::kStride;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i < pairs) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + (half + 2 * i) * C::kStride + d);
          dot[i] = fmaf(qv.x, kv.x, dot[i]);
          dot[i] = fmaf(qv.y, kv.y, dot[i]);
          dot[i] = fmaf(qv.z, kv.z, dot[i]);
          dot[i] = fmaf(qv.w, kv.w, dot[i]);
        }
      }
    }
    const bool ok = (mask >> sl) & 1u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < pairs) {
        const float x = ok ? dot[i] * scale : -INFINITY;
        const float mn = fmaxf(m[i], half_max(x));
        const float a = expf(m[i] - mn);
        const float pv = expf(x - mn);
        l[i] = l[i] * a + half_sum(pv);
        m[i] = mn;
        const int g = half + 2 * i;
        ps[g * (kTile + 1) + sl] = pv;
        if (sl == 0) alpha[g] = a;
      }
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      if (g < G) {
        const float a = alpha[g];
#pragma unroll
        for (int j = 0; j < kCh; ++j) {
          const int c = lane + 32 * j;
          if (c < D / 4) {
            float4 o = acc[g][j];
            o.x *= a; o.y *= a; o.z *= a; o.w *= a;
#pragma unroll
            for (int s = 0; s < kTile; ++s) {
              const float pv = ps[g * (kTile + 1) + s];
              const float4 v = *reinterpret_cast<const float4*>(vs + s * C::kStride + 4 * c);
              o.x = fmaf(pv, v.x, o.x);
              o.y = fmaf(pv, v.y, o.y);
              o.z = fmaf(pv, v.z, o.z);
              o.w = fmaf(pv, v.w, o.w);
            }
            acc[g][j] = o;
          }
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* mb, int lane) {
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      if (g < G) {
#pragma unroll
        for (int j = 0; j < kCh; ++j) {
          const int c = lane + 32 * j;
          if (c < D / 4) *reinterpret_cast<float4*>(mb + g * D + 4 * c) = acc[g][j];
        }
      }
    }
    if ((lane & 15) == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int g = (lane >> 4) + 2 * i;
        if (g < G) {
          mb[kRows * D + g] = m[i];
          mb[kRows * D + kRows + g] = l[i];
        }
      }
    }
  }
};

// Partial states (m, l, acc) merged in index order: M = max m over the
// parts with l > 0, L = sum l e^(m - M), A = sum acc e^(m - M).  Parts
// with l == 0 hold no valid slot and are skipped (their acc is unset).
struct Merge {
  float M = -INFINITY, L = 0.f, A = 0.f;
};

template <typename T, bool DELTA, int D>
__global__ void __launch_bounds__(Cfg<T, D>::kThreads) paged_attention_kernel(Params p) {
  using C = Cfg<T, D>;
  using Warp = typename std::conditional<C::kF32, SimtWarp<D>, MmaWarp<D>>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int sp = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = p.G;
  const int part = G * (D + 2);
  float* ws = p.ws + ((static_cast<int64_t>(b) * p.KVH + kh) * p.splits + sp) * part;
  const int tps = p.pages_per_split * p.BS / kTile;  // tiles per split
  const int tile0 = sp * tps;
  const int first = tile0 + warp;  // this warp's tiles: first, first + W, ...
  const int t_first = tile_page(p, b, first, lane);
  const int len = max(0, min(p.lengths[b], p.NB * p.BS));
  const int tile_end = min(tile0 + tps, (len + kTile - 1) / kTile);
  if (tile0 >= tile_end) {  // no slot of this row lies in this split
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      ws[G * D + g] = -INFINITY;
      ws[G * D + G + g] = 0.f;
    }
    return;
  }

  T* qs = reinterpret_cast<T*>(smem);
  T* ring = reinterpret_cast<T*>(smem + C::kQBytes);
  float* scratch = reinterpret_cast<float*>(smem + C::kQBytes + C::kWarps * C::kRingBytes);
  // The group's G query rows (zero rows up to 16), then each warp's first
  // tile, all in flight together: two cp.async groups per thread.
  const char* q = static_cast<const char*>(p.q) +
                  (static_cast<int64_t>(b) * p.H + static_cast<int64_t>(kh) * G) * D * C::kElem;
  for (int c = threadIdx.x; c < kRows * C::kChunks; c += blockDim.x) {
    const int r = c / C::kChunks, col = c % C::kChunks;
    cp_async16(smem_u32(qs + r * C::kStride) + col * 16,
               q + (r < G ? static_cast<int64_t>(r) * D * C::kElem + col * 16 : 0), r < G);
  }
  cp_async_commit();
  T* mine = ring + warp * kStages * C::kStageElems;
  const int n = first < tile_end ? (tile_end - first + C::kWarps - 1) / C::kWarps : 0;
  uint32_t next = 0;
  if (n > 0) next = issue_tile<T, DELTA, D>(p, kh, len, first, t_first, mine, lane);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's Q chunks
  __syncthreads();     // everyone's

  Warp st;
  if constexpr (C::kF32) {
    st.init(qs, scratch + warp * C::kScratchFloats, G);
  } else {
    st.init(qs, G, lane);
  }
  for (int i = 0; i < n; ++i) {
    const uint32_t mask = next;
    if (i + 1 < n) {
      const int tile = first + (i + 1) * C::kWarps;
      next = issue_tile<T, DELTA, D>(p, kh, len, tile, tile_page(p, b, tile, lane),
                                     mine + ((i + 1) & 1) * C::kStageElems, lane);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    if (mask) st.tile(mine + (i & 1) * C::kStageElems, mask, p.scale, lane);
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it becomes the merge buffer

  float* mb = reinterpret_cast<float*>(ring);
  st.store(mb + warp * C::kMergeFloats, lane);
  __syncthreads();
  // Per head, once: M, L and each warp's factor e^(m_w - M), into the Q
  // buffer (Q is read no more).
  float* fac = reinterpret_cast<float*>(qs);  // [kWarps][kRows] factors
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    Merge r;
    for (int w = 0; w < C::kWarps; ++w) {
      const float* s = mb + w * C::kMergeFloats + kRows * D;
      if (s[kRows + g] > 0.f) r.M = fmaxf(r.M, s[g]);
    }
    for (int w = 0; w < C::kWarps; ++w) {
      const float* s = mb + w * C::kMergeFloats + kRows * D;
      const float f = s[kRows + g] > 0.f ? expf(s[g] - r.M) : 0.f;
      r.L += s[kRows + g] * f;
      fac[w * kRows + g] = f;
    }
    ws[G * D + g] = r.M;
    ws[G * D + G + g] = r.L;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D;
    float a = 0.f;
    for (int w = 0; w < C::kWarps; ++w) {
      const float* s = mb + w * C::kMergeFloats;
      if (s[kRows * D + kRows + g] > 0.f) a += s[e] * fac[w * kRows + g];
    }
    ws[e] = a;
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Merges a row's splits in split order and writes out[b, kh*G + g, :]
// (0 where no split holds a valid slot): one CTA per (g, kv head, row),
// one thread per d.  Named apart from paged_attention_kernel, so a trace
// holds one record of that name per call.
template <typename T>
__global__ void __launch_bounds__(256) paged_attention_combine(Params p, int D) {
  extern __shared__ float sh[];  // [splits] l, then [splits] e^(m - M)
  const int g = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = p.G, S = p.splits;
  const int part = G * (D + 2);
  const float* base = p.ws + (static_cast<int64_t>(b) * p.KVH + kh) * S * part;
  float* ls = sh;
  float* f = sh + S;
  if (threadIdx.x < 32) {
    float M = -INFINITY;
    for (int s = threadIdx.x; s < S; s += 32) {
      const float* w = base + static_cast<int64_t>(s) * part + G * D;
      ls[s] = w[G + g];
      f[s] = w[g];
      if (ls[s] > 0.f) M = fmaxf(M, f[s]);
    }
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(kFull, M, o));
    for (int s = threadIdx.x; s < S; s += 32) f[s] = ls[s] > 0.f ? expf(f[s] - M) : 0.f;
  }
  __syncthreads();
  const int d = threadIdx.x;
  if (d >= D) return;
  const float* acc = base + g * D + d;
  Merge r;
  for (int s0 = 0; s0 < S; s0 += 8) {
    float v[8];  // eight splits' loads in flight, then summed in order
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = s0 + i;
      v[i] = s < S && ls[s] > 0.f ? acc[static_cast<int64_t>(s) * part] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = s0 + i;
      if (s < S && ls[s] > 0.f) {
        r.L += ls[s] * f[s];
        r.A += v[i] * f[s];
      }
    }
  }
  store_out(static_cast<T*>(p.out) +
                (static_cast<int64_t>(b) * p.H + static_cast<int64_t>(kh) * G + g) * D + d,
            r.L > 0.f ? r.A / r.L : 0.f);
}

template <typename T, bool DELTA, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<T, D>;
  auto kernel = paged_attention_kernel<T, DELTA, D>;
  if (C::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(p.splits, p.KVH, B), C::kThreads, C::kSmem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // At least one full warp: the first warp's shuffles take all 32 lanes.
  paged_attention_combine<T>
      <<<dim3(p.G, p.KVH, B), D < 32 ? 32 : D, 2 * p.splits * sizeof(float), stream>>>(p, D);
  return cudaGetLastError();
}

template <typename T, bool DELTA>
cudaError_t dispatch_dim(const Params& p, int B, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, DELTA, 16>(p, B, s);
    case 64: return launch<T, DELTA, 64>(p, B, s);
    case 128: return launch<T, DELTA, 128>(p, B, s);
    case 256: return launch<T, DELTA, 256>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_delta(int delta, const Params& p, int B, int D, cudaStream_t s) {
  return delta ? dispatch_dim<T, true>(p, B, D, s) : dispatch_dim<T, false>(p, B, D, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  delta: 0 = paged_attention_pallas,
// 1 = paged_attention_delta_pallas (parent and dirty are read).  ws: an
// f32 workspace of B * KVH * splits * G * (D + 2) floats; the row's pages
// are split into runs of pages_per_split (ops.py's split_plan).
extern "C" int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                               const void* tables, const void* lengths,
                               const void* parent, const void* dirty, void* out, void* ws,
                               int64_t B, int64_t H, int64_t KVH, int64_t D, int64_t BS,
                               int64_t NB, int64_t pages_per_split, int64_t splits,
                               int64_t bstride, int64_t sstride, int64_t hstride,
                               double scale, int dtype, int delta, void* stream) {
  if (B == 0) return static_cast<int>(cudaGetLastError());
  Params p;
  p.q = q;
  p.k = k_pool;
  p.v = v_pool;
  p.tables = static_cast<const int32_t*>(tables);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.parent = static_cast<const int32_t*>(parent);
  p.dirty = static_cast<const uint8_t*>(dirty);
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.H = static_cast<int>(H);
  p.KVH = static_cast<int>(KVH);
  p.G = static_cast<int>(H / KVH);
  p.BS = static_cast<int>(BS);
  p.NB = static_cast<int>(NB);
  p.pages_per_split = static_cast<int>(pages_per_split);
  p.splits = static_cast<int>(splits);
  p.bstride = bstride;
  p.sstride = sstride;
  p.hstride = hstride;
  p.scale = static_cast<float>(scale);
  if (p.G > kRows || p.splits < 1 || (p.pages_per_split * p.BS) % kTile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int d = static_cast<int>(D);
  const int b = static_cast<int>(B);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_delta<float>(delta, p, b, d, s);
  } else if (dtype == 1) {
    err = dispatch_delta<__nv_bfloat16>(delta, p, b, d, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
