// Mamba2 SSD chunked scan backward (one B/C group shared across heads).
//
// Replaces no TPU kernel.  The reference never differentiates through
// ssd_scan_pallas (src/repro/kernels/ssd_scan/kernel.py:92): its training
// step takes jax.grad through the plain ssd_chunked.  The port's forward
// runs csrc/ssd_scan.cu on every CUDA tensor, with no fallback to a plain
// version, so training on the card needs this gradient
// (kernels/ssd_scan/ops.py wraps both in one torch.autograd.Function).
//
// The forward, per (b, head), with the state h [P, N] and chunk c of q
// steps: cs_i = sum_{k <= i} dt_k a (within the chunk), L[i, j] =
// exp(cs_i - cs_j) for j <= i, and
//   y_i = sum_{j <= i} L[i, j] (C_i . B_j) dt_j x_j + exp(cs_i) h_in C_i,
//   h_out = exp(cs_end) h_in + sum_j exp(cs_end - cs_j) dt_j x_j B_j^T.
// Its gradient, with G the gradient of the chunk's final state (dh_final
// for the last chunk), M[i, j] = dy_i . x_j, CB[i, j] = C_i . B_j:
//   dx_j  = dt_j (sum_{i >= j} L CB[i, j] dy_i + exp(cs_end - cs_j) G B_j)
//   dB_j  = dt_j (sum_{i >= j} L M[i, j] C_i + exp(cs_end - cs_j) x_j^T G)
//   dC_i  = sum_{j <= i} L M[i, j] dt_j B_j + exp(cs_i) dy_i^T h_in
//   dcs_i = sum_j W[i, j] dt_j - dt_i sum_k W[k, i] + exp(cs_i) dy_i^T h_in C_i
//           - exp(cs_end - cs_i) dt_i x_i^T G B_i   (W = L o CB o M),
//   dcs_end += sum_j exp(cs_end - cs_j) dt_j x_j^T G B_j + exp(cs_end) <G, h_in>,
//   d(dt_k a) = sum_{i >= k} dcs_i,  ddt_k = a d(dt_k a) + sum_i W[i, k]
//           + exp(cs_end - cs_k) x_k^T G B_k,  da += sum_k dt_k d(dt_k a),
//   G_in  = exp(cs_end) G + sum_i exp(cs_i) dy_i C_i^T.
//
// The chain over chunks is only in h_in and G, and each is a linear
// recurrence whose increments need no state: s_c = sum_j exp(cs_end -
// cs_j) dt_j x_j B_j^T forward, u_c = sum_i exp(cs_i) dy_i C_i^T backward.
// So the work splits as the forward's does (csrc/ssd_scan.cu), into
// three launches:
//  1. ssd_bwd_states, chunk-parallel: a CTA per (head group, chunk, b)
//     loads B and C once and, for each head of its group, writes s_c and
//     u_c [P, N] to two scratch arrays and the chunk's sum of dt a;
//  2. ssd_bwd_recur: a thread per four (b, h, p, n) walks the chunks in
//     order, h_{c+1} = exp(cs_end,c) h_c + s_c, and back, G_{c-1} =
//     exp(cs_end,c) G_c + u_c from dh (or 0), overwriting each chunk's
//     s_c with its h_in and u_c with its G in place: a pass over bytes,
//     no products;
//  3. ssd_bwd_grads, chunk-parallel: a CTA per (head group, chunk, b)
//     forms C B^T once for the group (G = 1), then for each head M, the
//     masked L o CB and L o M, and every gradient term above, the
//     intra-chunk ones and those that read h_in and G, with dx written
//     once, ddt written per head after the q-step dcs chain (one thread,
//     in order), and dB and dC summed over the group's heads in order.
// Every product is mma.sync m16n8k8 TF32 with each f32 operand split
// into hi + lo TF32 parts, three products a tile (csrc/ssd_mma.cuh, the
// forward's helpers), so sums stay near f32: one TF32 pass keeps about
// three digits and would not hold the 1e-4 the gradient is held to.  No
// float atomic is used: dB and dC leave a partial per head group, da a
// partial per (b, chunk), which the wrapper reduces with one torch.sum
// each in a fixed order, so two calls are bit-equal.
//
// What bounds it: bytes.  At mamba2-130m's training microbatch [2, 4,096,
// 24 heads, P 64, N 128], chunk 64: 2.2e10 flops (0.045 ms at TF32's 495
// TFLOP/s; the three-pass split triples the tensor-core work) against
// the inputs and outputs (~0.06 ms at 3.35 TB/s), plus what the split
// adds: s_c and u_c written, read and rewritten as h_in and G, read again
// (B H (S/q) P N f32 each, 100.7 MB apiece, 8 passes ~0.24 ms).  The
// least time of the function itself, inputs and outputs once and its
// flops at TF32's rate, is the flops' (chip_smoke.py's bound_ms).
//
// Shared memory (f32 rows padded so that fragment reads spread over the
// banks, 16-byte aligned for cp.async; ssd_scan/ops.py's bwd_plan
// computes the same sizes):
//  states: 4 (2q(N+8) + 2q(P+8) + q)
//  grads:  4 (2q(N+4) + 3q(q+4) + 2q(P+4) + 2P(N+4) + 10q + q UX + q UN + 8),
//          UX = P / (8 NTP), UN = N / (8 NTN), NT 4 where 32 divides the width, else 2
// 106,752 and 226,336 bytes at mamba2-130m's widths.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "ssd_mma.cuh"

namespace {

struct SsdBwd {
  const float* x;    // [B, S, H, P]
  const float* dt;   // [B, S, H]
  const float* a;    // [H]
  const float* bm;   // [B, S, N]
  const float* cm;   // [B, S, N]
  const float* dy;   // [B, S, H, P]
  const float* dhf;  // [B, H, P, N] or null
  float* dx;         // [B, S, H, P]
  float* ddt;        // [B, S, H]
  float* da;         // [B, S / q, H] partials
  float* db;         // [H / heads, B, S, N] partials
  float* dc;         // [H / heads, B, S, N] partials
  float* st;         // [B, H, S / q, P, N]: s_c, then h_in
  float* ug;         // [B, H, S / q, P, N]: u_c, then G
  float* tot;        // [B, H, S / q]: the chunk's sum of dt a
  int64_t S;
  int H, P, N, Q, heads;
};

__host__ __device__ constexpr int nt_for(int width) { return width % 32 == 0 ? 4 : 2; }

// 1. s_c and u_c of each head of the group, and the chunk's sum of dt a.
__global__ void __launch_bounds__(THREADS) ssd_bwd_states(SsdBwd a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Q = a.Q, P = a.P, N = a.N, H = a.H;
  const int nc = static_cast<int>(a.S / Q), c = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = blockIdx.z, row0 = b * a.S + static_cast<int64_t>(c) * Q;
  const int h0 = blockIdx.x * a.heads, nh = min(a.heads, H - h0);
  const int ldb = N + 8, ldx = P + 8;
  float* bs = reinterpret_cast<float*>(smem);  // [Q][N + 8]
  float* cs = bs + Q * ldb;                    // [Q][N + 8]
  float* xd = cs + Q * ldb;                    // [Q][P + 8]  x_j dt_j exp(cs_end - cs_j)
  float* yd = xd + Q * ldx;                    // [Q][P + 8]  dy_i exp(cs_i)
  float* cum = yd + Q * ldx;                   // [Q]
  copy_rows(bs, ldb * 4, a.bm + row0 * N, N * 4, N * 4, Q);
  copy_rows(cs, ldb * 4, a.cm + row0 * N, N * 4, N * 4, Q);
  cp_async_commit();
  for (int k = 0; k < nh; ++k) {
    const int hh = h0 + k;
    const float* dth = a.dt + row0 * H + hh;
    __syncthreads();  // the previous head's products are done
    if (warp == 0) chunk_cumsum(dth, H, a.a[hh], Q, cum);
    __syncthreads();
    const float total = cum[Q - 1];
    if (threadIdx.x == 0) a.tot[(b * H + hh) * nc + c] = total;
    const float* x = a.x + (row0 * H + hh) * P;
    const float* dy = a.dy + (row0 * H + hh) * P;
    for (Walk w(P); w.r < Q; w.next()) {
      const int64_t at = static_cast<int64_t>(w.r) * H * P + w.c;
      xd[w.r * ldx + w.c] = x[at] * (dth[w.r * H] * expf(total - cum[w.r]));
      yd[w.r * ldx + w.c] = dy[at] * expf(cum[w.r]);
    }
    cp_async_wait_all();
    __syncthreads();
    const int64_t slot = ((b * H + hh) * nc + c) * static_cast<int64_t>(P) * N;
    if (nt_for(N) == 4) {
      state_tiles<4>(xd, ldx, bs, ldb, a.st + slot, P, N, Q);
      state_tiles<4>(yd, ldx, cs, ldb, a.ug + slot, P, N, Q);
    } else {
      state_tiles<2>(xd, ldx, bs, ldb, a.st + slot, P, N, Q);
      state_tiles<2>(yd, ldx, cs, ldb, a.ug + slot, P, N, Q);
    }
  }
}

// 2. The two recurrences over the chunks, in place, four (p, n) a thread.
constexpr int RUN = 8;

__global__ void __launch_bounds__(256) ssd_bwd_recur(SsdBwd a, int64_t n_vec) {
  const int64_t e = blockIdx.x * 256LL + threadIdx.x;
  const int64_t pn4 = static_cast<int64_t>(a.P) * a.N / 4;
  if (e >= n_vec) return;
  const int64_t bh = e / pn4, r = e % pn4;
  const int nc = static_cast<int>(a.S / a.Q);
  float4* s = reinterpret_cast<float4*>(a.st) + bh * nc * pn4 + r;
  float4* u = reinterpret_cast<float4*>(a.ug) + bh * nc * pn4 + r;
  const float* tot = a.tot + bh * nc;
  // RUN chunks' increments are loaded before any is used, so that RUN loads
  // are in flight a thread rather than one.
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += RUN) {
    float4 v[RUN];
#pragma unroll
    for (int i = 0; i < RUN; ++i)
      if (c0 + i < nc) v[i] = s[(c0 + i) * pn4];
#pragma unroll
    for (int i = 0; i < RUN; ++i)
      if (c0 + i < nc) {
        s[(c0 + i) * pn4] = h;
        const float d = expf(tot[c0 + i]);
        h = make_float4(d * h.x + v[i].x, d * h.y + v[i].y, d * h.z + v[i].z, d * h.w + v[i].w);
      }
  }
  float4 g = a.dhf != nullptr ? reinterpret_cast<const float4*>(a.dhf)[e] : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = nc - 1; c0 >= 0; c0 -= RUN) {
    float4 v[RUN];
#pragma unroll
    for (int i = 0; i < RUN; ++i)
      if (c0 - i >= 0) v[i] = u[(c0 - i) * pn4];
#pragma unroll
    for (int i = 0; i < RUN; ++i)
      if (c0 - i >= 0) {
        u[(c0 - i) * pn4] = g;
        const float d = expf(tot[c0 - i]);
        g = make_float4(d * g.x + v[i].x, d * g.y + v[i].y, d * g.z + v[i].z, d * g.w + v[i].w);
      }
  }
}

// Sum over a lane's quad (the four lanes that hold one fragment row).
__device__ __forceinline__ float quad_total(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 3. Every gradient of the chunk, for each head of the group.  Warps take
// output units of 16 rows x 8 NT columns in turn; a unit's products run
// over the whole of their k range (L o CB and L o M are 0 above the
// diagonal), starting at its own diagonal block where the factor is
// lower triangular.
template <int NTP, int NTN>
__global__ void __launch_bounds__(THREADS) ssd_bwd_grads(SsdBwd a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Q = a.Q, P = a.P, N = a.N, H = a.H;
  const int nc = static_cast<int>(a.S / Q), c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t b = blockIdx.z, row0 = b * a.S + static_cast<int64_t>(c) * Q;
  const int grp = blockIdx.x, h0 = grp * a.heads, nh = min(a.heads, H - h0);
  const int ldn = N + 4, ldq = Q + 4, ldx = P + 4;
  const int UX = P / (8 * NTP), UN = N / (8 * NTN);
  float* bs = reinterpret_cast<float*>(smem);  // [Q][N + 4]
  float* cs = bs + Q * ldn;                    // [Q][N + 4]
  float* cb = cs + Q * ldn;                    // [Q][Q + 4]  C B^T
  float* lcb = cb + Q * ldq;                   // [Q][Q + 4]  L o CB
  float* lm = lcb + Q * ldq;                   // [Q][Q + 4]  L o M
  float* xs = lm + Q * ldq;                    // [Q][P + 4]
  float* dys = xs + Q * ldx;                   // [Q][P + 4]
  float* hs = dys + Q * ldx;                   // [P][N + 4]  h_in
  float* gs = hs + P * ldn;                    // [P][N + 4]  G
  float* dtv = gs + P * ldn;                   // [Q]
  float* cum = dtv + Q;                        // [Q]
  float* ecs = cum + Q;                        // [Q]  exp(cs_i)
  float* toend = ecs + Q;                      // [Q]  exp(cs_end - cs_i)
  float* roww = toend + Q;                     // [Q]  sum_j W[i, j] dt_j
  float* colw = roww + Q;                      // [Q]  sum_k W[k, i]
  float* xgb = colw + Q;                       // [Q]  x_i^T G B_i
  float* dyhc = xgb + Q;                       // [Q]  dy_i^T h_in C_i
  float* ssum = dyhc + Q;                      // [Q]  S_i = sum_{k <= i} dt_k
  float* wda = ssum + Q;                       // [Q]  sum_j W[i, j] dt_j (S_i - S_j)
  float* xgbp = wda + Q;                       // [Q][UX] partials of xgb
  float* dyhcp = xgbp + Q * UX;                // [Q][UN] partials of dyhc
  float* red = dyhcp + Q * UN;                 // [8]

  copy_rows(bs, ldn * 4, a.bm + row0 * N, N * 4, N * 4, Q);
  copy_rows(cs, ldn * 4, a.cm + row0 * N, N * 4, N * 4, Q);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int mq = Q / 16;
  for (int u = warp; u < mq * mq; u += WARPS) {  // C B^T on and below the diagonal
    const int mi = u / mq, nj = u - mi * mq;
    if (nj > mi) continue;
    float acc[2][4] = {};
    warp_mma<2, false, false>(acc, cs, ldn, 1, bs, 1, ldn, mi * 16, nj * 16, N);
    store_tile<2>(acc, cb, ldq, mi * 16, nj * 16);
  }

  for (int k = 0; k < nh; ++k) {
    const int hh = h0 + k;
    const int64_t slot = ((b * H + hh) * nc + c) * static_cast<int64_t>(P) * N;
    __syncthreads();  // the previous head (or C B^T) is done with shared memory
    copy_rows(xs, ldx * 4, a.x + (row0 * H + hh) * P, static_cast<int64_t>(H) * P * 4, P * 4, Q);
    copy_rows(dys, ldx * 4, a.dy + (row0 * H + hh) * P, static_cast<int64_t>(H) * P * 4, P * 4, Q);
    copy_rows(hs, ldn * 4, a.st + slot, N * 4, N * 4, P);
    copy_rows(gs, ldn * 4, a.ug + slot, N * 4, N * 4, P);
    for (int j = threadIdx.x; j < Q; j += THREADS) cp_async4(dtv + j, a.dt + (row0 + j) * H + hh);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const float ah = a.a[hh];
    if (warp == 0) {
      chunk_cumsum(dtv, 1, ah, Q, cum);
      chunk_cumsum(dtv, 1, 1.f, Q, ssum);
      __syncwarp();
      const float cs_end = cum[Q - 1];
      for (int i = lane; i < Q; i += 32) {
        ecs[i] = expf(cum[i]);
        toend[i] = expf(cs_end - cum[i]);
      }
    }
    __syncthreads();

    // M = dy x^T on and below the diagonal; L o CB and L o M (0 above it).
    for (int u = warp; u < mq * mq; u += WARPS) {
      const int mi = u / mq, nj = u - mi * mq;
      float acc[2][4] = {};
      if (nj <= mi) warp_mma<2, false, false>(acc, dys, ldx, 1, xs, 1, ldx, mi * 16, nj * 16, P);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = mi * 16 + g + 8 * (e / 2), j = nj * 16 + 8 * nt + 2 * t + e % 2;
          const float l = j <= i ? expf(cum[i] - cum[j]) : 0.f;
          lcb[i * ldq + j] = j <= i ? l * cb[i * ldq + j] : 0.f;
          lm[i * ldq + j] = l * acc[nt][e];
        }
    }
    // <G, h_in>: each thread's elements in order, then a fixed tree.
    float gh = 0.f;
    for (int e = threadIdx.x; e < P * N; e += THREADS) {
      const int o = (e / N) * ldn + e % N;
      gh = fmaf(gs[o], hs[o], gh);
    }
    for (int o = 16; o > 0; o >>= 1) gh += __shfl_xor_sync(0xffffffffu, gh, o);
    if (lane == 0) red[warp] = gh;
    __syncthreads();

    // Row and column sums of W = L o CB o M = lm o cb; and each row's share
    // of da's intra-chunk term, sum_j W[i, j] dt_j (S_i - S_j), with S_i - S_j
    // summed from the dt between them.
    for (int i = threadIdx.x; i < 2 * Q; i += THREADS) {
      float sum = 0.f;
      if (i < Q) {
        float part = 0.f, between = 0.f;
        for (int j = i; j >= 0; --j) {
          const float w = lm[i * ldq + j] * cb[i * ldq + j] * dtv[j];
          sum += w;
          part = fmaf(w, between, part);
          between += dtv[j];
        }
        roww[i] = sum;
        wda[i] = part;
      } else {
        const int j = i - Q;
        for (int r = j; r < Q; ++r) sum += lm[r * ldq + j] * cb[r * ldq + j];
        colw[j] = sum;
      }
    }

    // dx_j = dt_j ((L o CB)^T dy)_j + dt_j exp(cs_end - cs_j) (G B_j).
    for (int u = warp; u < mq * UX; u += WARPS) {
      const int m0 = u / UX * 16, n0 = u % UX * 8 * NTP;
      float lo[NTP][4] = {}, gb[NTP][4] = {};
      warp_mma_with<NTP, false, false>(
          lo, [=](int m, int kk) { return lcb[(kk + m0) * ldq + m]; }, dys + m0 * ldx, ldx, 1, m0, n0, Q - m0);
      warp_mma<NTP, false, false>(gb, bs, ldn, 1, gs, 1, ldn, m0, n0, N);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = m0 + g + 8 * r;
        float part = 0.f;
        float* out = a.dx + ((row0 + j) * H + hh) * P + n0 + 2 * t;
#pragma unroll
        for (int nt = 0; nt < NTP; ++nt) {
          const int p = n0 + 8 * nt + 2 * t;
          const float g0 = gb[nt][2 * r], g1 = gb[nt][2 * r + 1];
          part = fmaf(xs[j * ldx + p], g0, part);
          part = fmaf(xs[j * ldx + p + 1], g1, part);
          *reinterpret_cast<float2*>(out + 8 * nt) =
              make_float2(dtv[j] * (lo[nt][2 * r] + toend[j] * g0), dtv[j] * (lo[nt][2 * r + 1] + toend[j] * g1));
        }
        part = quad_total(part);
        if (t == 0) xgbp[j * UX + u % UX] = part;
      }
    }

    // dB_j += dt_j ((L o M)^T C)_j + dt_j exp(cs_end - cs_j) (x_j^T G), and
    // dC_i += ((L o M) diag(dt) B)_i + exp(cs_i) (dy_i^T h_in), summed over
    // the group's heads in order in this CTA's own partial.
    float* dbp = a.db + (static_cast<int64_t>(grp) * gridDim.z * a.S + row0) * N;
    float* dcp = a.dc + (static_cast<int64_t>(grp) * gridDim.z * a.S + row0) * N;
    for (int u = warp; u < mq * UN; u += WARPS) {
      const int m0 = u / UN * 16, n0 = u % UN * 8 * NTN;
      float lo[NTN][4] = {}, xg[NTN][4] = {};
      warp_mma_with<NTN, false, false>(
          lo, [=](int m, int kk) { return lm[(kk + m0) * ldq + m]; }, cs + m0 * ldn, ldn, 1, m0, n0, Q - m0);
      warp_mma<NTN, false, false>(xg, xs, ldx, 1, gs, ldn, 1, m0, n0, P);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = m0 + g + 8 * r;
#pragma unroll
        for (int nt = 0; nt < NTN; ++nt) {
          float2* o = reinterpret_cast<float2*>(dbp + static_cast<int64_t>(j) * N + n0 + 8 * nt + 2 * t);
          float2 v = make_float2(dtv[j] * (lo[nt][2 * r] + toend[j] * xg[nt][2 * r]),
                                 dtv[j] * (lo[nt][2 * r + 1] + toend[j] * xg[nt][2 * r + 1]));
          if (k > 0) {
            const float2 w = *o;
            v = make_float2(w.x + v.x, w.y + v.y);
          }
          *o = v;
        }
      }
    }
    for (int u = warp; u < mq * UN; u += WARPS) {
      const int m0 = u / UN * 16, n0 = u % UN * 8 * NTN;
      float lo[NTN][4] = {}, dh[NTN][4] = {};
      warp_mma_with<NTN, false, false>(
          lo, [=](int m, int kk) { return lm[m * ldq + kk] * dtv[kk]; }, bs, ldn, 1, m0, n0, m0 + 16);
      warp_mma<NTN, false, false>(dh, dys, ldx, 1, hs, ldn, 1, m0, n0, P);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = m0 + g + 8 * r;
        float part = 0.f;
#pragma unroll
        for (int nt = 0; nt < NTN; ++nt) {
          const int n = n0 + 8 * nt + 2 * t;
          part = fmaf(dh[nt][2 * r], cs[i * ldn + n], part);
          part = fmaf(dh[nt][2 * r + 1], cs[i * ldn + n + 1], part);
          float2* o = reinterpret_cast<float2*>(dcp + static_cast<int64_t>(i) * N + n);
          float2 v = make_float2(lo[nt][2 * r] + ecs[i] * dh[nt][2 * r], lo[nt][2 * r + 1] + ecs[i] * dh[nt][2 * r + 1]);
          if (k > 0) {
            const float2 w = *o;
            v = make_float2(w.x + v.x, w.y + v.y);
          }
          *o = v;
        }
        part = quad_total(part);
        if (t == 0) dyhcp[i * UN + u % UN] = part;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < Q; i += THREADS) {
      float xs_ = 0.f, dh = 0.f;
      for (int v = 0; v < UX; ++v) xs_ += xgbp[i * UX + v];
      for (int v = 0; v < UN; ++v) dh += dyhcp[i * UN + v];
      xgb[i] = xs_;
      dyhc[i] = dh;
    }
    __syncthreads();

    // The cumulative-sum chain, on thread 0 (q steps, in order): ddt_k from
    // d(dt_k a) = sum_{i >= k} dcs_i.  The chunk's da is not summed as
    // sum_k dt_k d(dt_k a): its terms cancel (cs_i reaches tens, the decay
    // between neighbours is small) and f32 lost 2e-4 of it at 64 chunks.  It
    // is the same sum regrouped, sum_i S_i dcs_i with S_i = cs_i / a, whose
    // terms pair up as differences S_i - S_j taken from the dt between:
    //   sum_{j <= i} W[i, j] dt_j (S_i - S_j) + sum_i S_i exp(cs_i) dy_i^T h_in C_i
    //   + sum_j (S_end - S_j) exp(cs_end - cs_j) dt_j x_j^T G B_j + S_end exp(cs_end) <G, h_in>.
    if (threadIdx.x == 0) {
      float ghs = 0.f;
      for (int w = 0; w < WARPS; ++w) ghs += red[w];
      float tail = 0.f;
      for (int j = 0; j < Q; ++j) tail = fmaf(toend[j] * dtv[j], xgb[j], tail);
      float acc = 0.f, da_acc = ssum[Q - 1] * ecs[Q - 1] * ghs, after = 0.f;
      for (int kk = Q - 1; kk >= 0; --kk) {
        float dcs = roww[kk] - dtv[kk] * colw[kk] + ecs[kk] * dyhc[kk] - toend[kk] * dtv[kk] * xgb[kk];
        if (kk == Q - 1) dcs += tail + ecs[Q - 1] * ghs;
        acc += dcs;
        a.ddt[(row0 + kk) * H + hh] = acc * ah + colw[kk] + toend[kk] * xgb[kk];
        da_acc += wda[kk] + ssum[kk] * ecs[kk] * dyhc[kk] + after * toend[kk] * dtv[kk] * xgb[kk];
        after += dtv[kk];
      }
      a.da[(b * nc + c) * H + hh] = da_acc;
    }
  }
}

int64_t states_smem(int P, int N, int Q) { return 4LL * (2 * Q * (N + 8) + 2 * Q * (P + 8) + Q); }

int64_t grads_smem(int P, int N, int Q) {
  const int ux = P / (8 * nt_for(P)), un = N / (8 * nt_for(N));
  return 4LL * (2 * Q * (N + 4) + 3 * Q * (Q + 4) + 2 * Q * (P + 4) + 2 * P * (N + 4) + 10 * Q + Q * ux + Q * un + 8);
}

template <int NTP, int NTN>
int launch_grads(const SsdBwd& a, dim3 grid, cudaStream_t s) {
  const int64_t bytes = grads_smem(a.P, a.N, a.Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_grads<NTP, NTN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_grads<NTP, NTN><<<grid, THREADS, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every tensor f32 and contiguous; q, P and N multiples of 16, q dividing
// s; the wrapper has checked that the shared memory above fits
// (ssd_scan/ops.py's bwd_plan) and allocated the scratch.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                            const void* dy, const void* dhf, void* dx, void* ddt, void* da, void* db,
                            void* dc, void* st, void* ug, void* tot, int64_t b, int64_t s, int64_t h, int64_t p,
                            int64_t n, int64_t q, int64_t heads, void* stream) {
  if (b == 0 || s == 0 || h == 0) return 0;
  SsdBwd args{static_cast<const float*>(x),  static_cast<const float*>(dt), static_cast<const float*>(a),
              static_cast<const float*>(bm), static_cast<const float*>(cm), static_cast<const float*>(dy),
              static_cast<const float*>(dhf), static_cast<float*>(dx), static_cast<float*>(ddt),
              static_cast<float*>(da), static_cast<float*>(db), static_cast<float*>(dc),
              static_cast<float*>(st), static_cast<float*>(ug), static_cast<float*>(tot), s,
              static_cast<int>(h), static_cast<int>(p), static_cast<int>(n), static_cast<int>(q),
              static_cast<int>(heads)};
  const cudaStream_t str = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((h + heads - 1) / heads), static_cast<unsigned>(s / q),
                  static_cast<unsigned>(b));
  const int64_t smem1 = states_smem(args.P, args.N, args.Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_states, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_states<<<grid, THREADS, smem1, str>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_vec = b * h * p * n / 4;
  ssd_bwd_recur<<<static_cast<unsigned>((n_vec + 255) / 256), 256, 0, str>>>(args, n_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool p4 = nt_for(args.P) == 4, n4 = nt_for(args.N) == 4;
  if (p4 && n4) return launch_grads<4, 4>(args, grid, str);
  if (p4) return launch_grads<4, 2>(args, grid, str);
  if (n4) return launch_grads<2, 4>(args, grid, str);
  return launch_grads<2, 2>(args, grid, str);
}
