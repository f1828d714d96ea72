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
// One CTA of 256 threads per (P tile, head, batch).  A forward sweep over
// the chunks writes each chunk's starting state h_in [PT, N] to scratch
// that the wrapper allocates; the reverse sweep carries G [PT, N] in
// shared memory from the last chunk to the first and forms the
// intra-chunk terms from the masked q x q forms.  dx is the CTA's alone.
// dB, dC, ddt and da sum over heads (and P tiles): each CTA writes its
// partial to its own slice, and the wrapper reduces the slices with one
// torch.sum over the (head, P tile) axis, so no float atomic is used and
// two calls are bit-equal.
//
// What bounds it: at mamba2-130m's widths (q 64, PT 32, N 128) a chunk
// costs a CTA about 3 M multiply-adds in shared memory against 100 KB of
// its inputs, so operations; this first version runs them on the CUDA
// cores in f32, one output element a thread per pass, rows padded to an
// odd stride so a warp's reads fall in distinct banks.  Tensor cores are
// rule-2 work.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

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
  float* ddt;        // [NPT, B, S, H] partials
  float* da;         // [NPT, B, H] partials
  float* db;         // [H * NPT, B, S, N] partials
  float* dc;         // [H * NPT, B, S, N] partials
  float* hin;        // [B, H, NPT, S / q, PT, N] scratch
  int64_t b, s, h, p, n, q, pt;
};

constexpr int THREADS = 256;

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) total += red[w];  // fixed order
  return total;
}

__global__ void __launch_bounds__(THREADS) ssd_scan_bwd_kernel(SsdBwd a) {
  const int q = static_cast<int>(a.q), PT = static_cast<int>(a.pt), N = static_cast<int>(a.n);
  const int XS = PT + 1, NS = N + 1, QS = q + 1;
  extern __shared__ float sm[];
  float* xs = sm;             // [q][XS]  x_j[p]
  float* dys = xs + q * XS;   // [q][XS]  dy_i[p]
  float* gb = dys + q * XS;   // [q][XS]  (G B_j)[p]
  float* hc = gb + q * XS;    // [q][XS]  (h_in C_i)[p]
  float* bs = hc + q * XS;    // [q][NS]
  float* cs = bs + q * NS;    // [q][NS]
  float* ge = cs + q * NS;    // [PT][NS] the state (forward sweep), then G
  float* hs = ge + PT * NS;   // [PT][NS] h_in of the chunk
  float* a1 = hs + PT * NS;   // [q][QS]  CB, then L o CB
  float* a2 = a1 + q * QS;    // [q][QS]  M, then L o M
  float* w = a2 + q * QS;     // [q][QS]  L o CB o M
  float* dtv = w + q * QS;    // [q]
  float* csv = dtv + q;       // [q]
  float* ecs = csv + q;       // [q]  exp(cs_i)
  float* roww = ecs + q;      // [q]  sum_j W[i, j] dt_j (forward sweep: exp(cs_end - cs_j) dt_j)
  float* colw = roww + q;     // [q]  sum_k W[k, i]
  float* xgb = colw + q;      // [q]  x_i^T G B_i
  float* dyhc = xgb + q;      // [q]  dy_i^T h_in C_i
  float* red = dyhc + q;      // [THREADS / 32]

  const int tid = threadIdx.x;
  const int64_t pti = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int64_t npt = a.p / PT, nc = a.s / q, p0 = pti * PT;
  const float ah = a.a[hh];
  const int64_t xrow = a.h * a.p;
  const float* x = a.x + b * a.s * xrow + hh * a.p + p0;
  const float* dy = a.dy + b * a.s * xrow + hh * a.p + p0;
  float* dx = a.dx + b * a.s * xrow + hh * a.p + p0;
  const float* dtp = a.dt + b * a.s * a.h + hh;
  const float* bmp = a.bm + b * a.s * N;
  const float* cmp = a.cm + b * a.s * N;
  float* hin = a.hin + ((b * a.h + hh) * npt + pti) * nc * PT * N;
  const int64_t part = (hh * npt + pti) * a.b + b;
  float* db = a.db + part * a.s * N;
  float* dc = a.dc + part * a.s * N;
  float* ddt = a.ddt + (pti * a.b + b) * a.s * a.h + hh;

  auto load_chunk = [&](int64_t t0, bool reverse) {
    for (int e = tid; e < q * PT; e += THREADS) {
      const int i = e / PT, pp = e % PT;
      xs[i * XS + pp] = x[(t0 + i) * xrow + pp];
      if (reverse) dys[i * XS + pp] = dy[(t0 + i) * xrow + pp];
    }
    for (int e = tid; e < q * N; e += THREADS) {
      const int i = e / N, nn = e % N;
      bs[i * NS + nn] = bmp[(t0 + i) * N + nn];
      if (reverse) cs[i * NS + nn] = cmp[(t0 + i) * N + nn];
    }
    for (int i = tid; i < q; i += THREADS) dtv[i] = dtp[(t0 + i) * a.h];
  };
  auto cumsum = [&]() {  // thread 0; the caller synchronises
    if (tid == 0) {
      float acc = 0.f;
      for (int i = 0; i < q; ++i) {
        acc += dtv[i] * ah;
        csv[i] = acc;
        ecs[i] = expf(acc);
      }
    }
  };

  // -- forward sweep: the state entering each chunk, into scratch ---------
  for (int e = tid; e < PT * N; e += THREADS) ge[(e / N) * NS + e % N] = 0.f;
  for (int64_t c = 0; c < nc; ++c) {
    __syncthreads();  // the previous chunk is consumed
    load_chunk(c * q, false);
    __syncthreads();
    cumsum();
    for (int e = tid; e < PT * N; e += THREADS) hin[c * PT * N + e] = ge[(e / N) * NS + e % N];
    __syncthreads();
    const float cs_end = csv[q - 1];
    for (int j = tid; j < q; j += THREADS) roww[j] = expf(cs_end - csv[j]) * dtv[j];
    __syncthreads();
    const float dec = ecs[q - 1];
    for (int e = tid; e < PT * N; e += THREADS) {
      const int pp = e / N, nn = e % N;
      float acc = ge[pp * NS + nn] * dec;
      for (int j = 0; j < q; ++j) acc = fmaf(roww[j] * xs[j * XS + pp], bs[j * NS + nn], acc);
      ge[pp * NS + nn] = acc;
    }
  }

  // -- reverse sweep -------------------------------------------------------
  __syncthreads();
  for (int e = tid; e < PT * N; e += THREADS) {
    const int pp = e / N, nn = e % N;
    ge[pp * NS + nn] = a.dhf != nullptr ? a.dhf[((b * a.h + hh) * a.p + p0 + pp) * N + nn] : 0.f;
  }
  float da_acc = 0.f;  // thread 0's
  for (int64_t c = nc - 1; c >= 0; --c) {
    const int64_t t0 = c * q;
    __syncthreads();  // the previous chunk is consumed
    load_chunk(t0, true);
    for (int e = tid; e < PT * N; e += THREADS) hs[(e / N) * NS + e % N] = hin[c * PT * N + e];
    __syncthreads();
    cumsum();

    // CB and M (lower triangle), G B_j and h_in C_i.
    for (int e = tid; e < q * q; e += THREADS) {
      const int i = e / q, j = e % q;
      float cb = 0.f, m = 0.f;
      if (j <= i) {
        for (int nn = 0; nn < N; ++nn) cb = fmaf(cs[i * NS + nn], bs[j * NS + nn], cb);
        for (int pp = 0; pp < PT; ++pp) m = fmaf(dys[i * XS + pp], xs[j * XS + pp], m);
      }
      a1[i * QS + j] = cb;
      a2[i * QS + j] = m;
    }
    for (int e = tid; e < q * PT; e += THREADS) {
      const int j = e / PT, pp = e % PT;
      float g = 0.f, hcv = 0.f;
      for (int nn = 0; nn < N; ++nn) {
        g = fmaf(ge[pp * NS + nn], bs[j * NS + nn], g);
        hcv = fmaf(hs[pp * NS + nn], cs[j * NS + nn], hcv);
      }
      gb[j * XS + pp] = g;
      hc[j * XS + pp] = hcv;
    }
    __syncthreads();
    const float cs_end = csv[q - 1], e_end = ecs[q - 1];

    // L o CB, L o M and W.
    for (int e = tid; e < q * q; e += THREADS) {
      const int i = e / q, j = e % q;
      if (j <= i) {
        const float l = expf(csv[i] - csv[j]);
        const float cb = a1[i * QS + j], m = a2[i * QS + j];
        a1[i * QS + j] = l * cb;
        a2[i * QS + j] = l * m;
        w[i * QS + j] = l * cb * m;
      } else {
        w[i * QS + j] = 0.f;
      }
    }
    __syncthreads();

    // Per-step sums, and <G, h_in>.
    for (int i = tid; i < q; i += THREADS) {
      float rw = 0.f, cw = 0.f, xg = 0.f, dh = 0.f;
      for (int j = 0; j < q; ++j) {
        rw = fmaf(w[i * QS + j], dtv[j], rw);
        cw += w[j * QS + i];
      }
      for (int pp = 0; pp < PT; ++pp) {
        xg = fmaf(xs[i * XS + pp], gb[i * XS + pp], xg);
        dh = fmaf(dys[i * XS + pp], hc[i * XS + pp], dh);
      }
      roww[i] = rw;
      colw[i] = cw;
      xgb[i] = xg;
      dyhc[i] = dh;
    }
    float gh = 0.f;
    for (int e = tid; e < PT * N; e += THREADS) {
      const int o = (e / N) * NS + e % N;
      gh = fmaf(ge[o], hs[o], gh);
    }
    gh = block_sum(gh, red);  // synchronises: the sums above are visible

    // The cumulative-sum chain, on thread 0 (q steps).
    if (tid == 0) {
      float tail = 0.f;
      for (int j = 0; j < q; ++j) tail = fmaf(expf(cs_end - csv[j]) * dtv[j], xgb[j], tail);
      float acc = 0.f;
      for (int k = q - 1; k >= 0; --k) {
        const float to_end = expf(cs_end - csv[k]);
        float dcs = roww[k] - dtv[k] * colw[k] + ecs[k] * dyhc[k] - to_end * dtv[k] * xgb[k];
        if (k == q - 1) dcs += tail + e_end * gh;
        acc += dcs;
        ddt[(t0 + k) * a.h] = acc * ah + colw[k] + to_end * xgb[k];
        da_acc = fmaf(acc, dtv[k], da_acc);
      }
    }

    // dx, dB and dC of the chunk.
    for (int e = tid; e < q * PT; e += THREADS) {
      const int j = e / PT, pp = e % PT;
      float acc = 0.f;
      for (int i = j; i < q; ++i) acc = fmaf(a1[i * QS + j], dys[i * XS + pp], acc);
      dx[(t0 + j) * xrow + pp] = dtv[j] * (acc + expf(cs_end - csv[j]) * gb[j * XS + pp]);
    }
    for (int e = tid; e < q * N; e += THREADS) {
      const int j = e / N, nn = e % N;
      float lm = 0.f, xg = 0.f, lmb = 0.f, dh = 0.f;
      for (int i = j; i < q; ++i) lm = fmaf(a2[i * QS + j], cs[i * NS + nn], lm);
      for (int k = 0; k <= j; ++k) lmb = fmaf(a2[j * QS + k] * dtv[k], bs[k * NS + nn], lmb);
      for (int pp = 0; pp < PT; ++pp) {
        xg = fmaf(xs[j * XS + pp], ge[pp * NS + nn], xg);
        dh = fmaf(dys[j * XS + pp], hs[pp * NS + nn], dh);
      }
      db[(t0 + j) * N + nn] = dtv[j] * (lm + expf(cs_end - csv[j]) * xg);
      dc[(t0 + j) * N + nn] = lmb + ecs[j] * dh;
    }
    __syncthreads();  // G is read above and replaced below

    // G entering the chunk.
    for (int e = tid; e < PT * N; e += THREADS) {
      const int pp = e / N, nn = e % N;
      float acc = e_end * ge[pp * NS + nn];
      for (int i = 0; i < q; ++i) acc = fmaf(ecs[i] * dys[i * XS + pp], cs[i * NS + nn], acc);
      ge[pp * NS + nn] = acc;
    }
  }
  if (tid == 0) a.da[(pti * a.b + b) * a.h + hh] = da_acc;
}

}  // namespace

// Every tensor f32 and contiguous; q divides s, pt divides p, and the
// wrapper has checked that the shared memory below fits.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                            const void* dy, const void* dhf, void* dx, void* ddt, void* da, void* db,
                            void* dc, void* hin, int64_t b, int64_t s, int64_t h, int64_t p, int64_t n,
                            int64_t q, int64_t pt, void* stream) {
  if (b == 0 || s == 0 || h == 0) return 0;
  SsdBwd args{static_cast<const float*>(x),  static_cast<const float*>(dt), static_cast<const float*>(a),
              static_cast<const float*>(bm), static_cast<const float*>(cm), static_cast<const float*>(dy),
              static_cast<const float*>(dhf), static_cast<float*>(dx), static_cast<float*>(ddt),
              static_cast<float*>(da), static_cast<float*>(db), static_cast<float*>(dc),
              static_cast<float*>(hin), b, s, h, p, n, q, pt};
  const size_t floats = 4 * q * (pt + 1) + 2 * q * (n + 1) + 2 * pt * (n + 1) + 3 * q * (q + 1) + 7 * q +
                        THREADS / 32;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(p / pt), static_cast<unsigned>(h), static_cast<unsigned>(b));
  ssd_scan_bwd_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
