// Mamba2 SSD chunked scan, one B/C group (G = 1).
//
// Replaces ssd_scan_pallas (src/repro/kernels/ssd_scan/kernel.py:92).
// x [B, S, H, P], B/C [B, S, N] (f32 or bf16), dt [B, S, H] and a [H]
// (f32) -> y [B, S, H, P] f32 and the final state [B, H, P, N] f32.
//
// The TPU kernel carries the state h [P, N] in VMEM scratch across a
// sequential chunk axis of its grid.  Here one CTA owns a (b, h) and
// loops over the chunks itself, with h in shared memory (32 KB at
// mamba2-130m's P = 64, N = 128), beside the chunk's x [Q, P], B and C
// [Q, N], and its Q x Q scores: ~133 KB at Q = 64, so the kernel takes
// dynamic shared memory above the 48 KB default.  Each chunk follows
// kernel.py:48-87 step by step:
//   cum    = inclusive cumsum of dt * a within the chunk
//   S[i,j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   for i >= j, else 0
//   y_i    = sum_j S[i,j] x_j + exp(cum_i) * (C_i . h)
//   h      = exp(cum_Q) h + sum_j x_j B_j^T dt_j exp(cum_Q - cum_j)
// so sums run over the same terms as the chunked reference (a per-step
// recurrence would sum in another order and drift past the 2e-4 the
// tests hold it to).
//
// What bounds it on the card: operations.  Per chunk and head ~1.8 M
// multiply-adds against ~50 KB of inputs, in f32 on the CUDA cores from
// shared memory, one output element per thread step (padded rows keep
// the strided reads free of bank conflicts).  B x H CTAs (96 at B = 4,
// H = 24) leave some of the 132 SMs idle; splitting P across CTAs, or the
// tensor cores, is later work.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm,
               const T* __restrict__ cm, float* __restrict__ y,
               float* __restrict__ hout, int64_t S, int64_t H, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int NS = N + 1, QS = Q + 1;
  float* hs = smem;             // [P][NS]  the carried state
  float* xs = hs + P * NS;      // [Q][P]
  float* bs = xs + Q * P;       // [Q][NS]
  float* cs = bs + Q * NS;      // [Q][NS]
  float* sc = cs + Q * NS;      // [Q][QS]  scores
  float* dts = sc + Q * QS;     // [Q]
  float* cum = dts + Q;         // [Q]
  float* dec = cum + Q;         // [Q]      dt_j exp(cum_Q - cum_j)

  const int tid = threadIdx.x;
  const int64_t hh = blockIdx.x, b = blockIdx.y;
  const float ah = a[hh];
  for (int e = tid; e < P * N; e += THREADS) hs[(e / N) * NS + e % N] = 0.f;

  for (int64_t c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the previous chunk's reads are done
    for (int e = tid; e < Q * P; e += THREADS) {
      const int i = e / P, p = e % P;
      xs[e] = to_f32(x[((b * S + c0 + i) * H + hh) * P + p]);
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int i = e / N, n = e % N;
      const int64_t g = (b * S + c0 + i) * N + n;
      bs[i * NS + n] = to_f32(bm[g]);
      cs[i * NS + n] = to_f32(cm[g]);
    }
    for (int i = tid; i < Q; i += THREADS) dts[i] = dt[(b * S + c0 + i) * H + hh];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += dts[i] * ah;
        cum[i] = run;
      }
    }
    __syncthreads();
    const float total = cum[Q - 1];
    for (int j = tid; j < Q; j += THREADS) dec[j] = dts[j] * expf(total - cum[j]);
    for (int e = tid; e < Q * Q; e += THREADS) {
      const int i = e / Q, j = e % Q;
      float s = 0.f;
      if (i >= j) {
        float cb = 0.f;
        for (int n = 0; n < N; ++n) cb = fmaf(cs[i * NS + n], bs[j * NS + n], cb);
        s = cb * expf(cum[i] - cum[j]) * dts[j];
      }
      sc[i * QS + j] = s;
    }
    __syncthreads();
    for (int e = tid; e < Q * P; e += THREADS) {
      const int i = e / P, p = e % P;
      float yd = 0.f;
      for (int j = 0; j <= i; ++j) yd = fmaf(sc[i * QS + j], xs[j * P + p], yd);
      float yo = 0.f;
      for (int n = 0; n < N; ++n) yo = fmaf(cs[i * NS + n], hs[p * NS + n], yo);
      y[((b * S + c0 + i) * H + hh) * P + p] = yd + yo * expf(cum[i]);
    }
    __syncthreads();  // every read of h for this chunk's y is done
    const float decay = expf(total);
    for (int e = tid; e < P * N; e += THREADS) {
      const int p = e / N, n = e % N;
      float contrib = 0.f;
      for (int j = 0; j < Q; ++j) contrib = fmaf(xs[j * P + p], bs[j * NS + n] * dec[j], contrib);
      hs[p * NS + n] = decay * hs[p * NS + n] + contrib;
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += THREADS) {
    hout[((b * H + hh) * P + e / N) * N + e % N] = hs[(e / N) * NS + e % N];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
           void* y, void* hout, int64_t B, int64_t S, int64_t H, int64_t P, int64_t N,
           int64_t Q, cudaStream_t s) {
  const size_t bytes =
      sizeof(float) * (P * (N + 1) + Q * P + 2 * Q * (N + 1) + Q * (Q + 1) + 3 * Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(B));
  ssd_kernel<T><<<grid, THREADS, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(bm), static_cast<const T*>(cm), static_cast<float*>(y),
      static_cast<float*>(hout), S, H, static_cast<int>(P), static_cast<int>(N),
      static_cast<int>(Q));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype of x, B and C: 0 = f32, 1 = bf16.  S must be a multiple of Q.
extern "C" int ssd_scan(const void* x, const void* dt, const void* a, const void* bm,
                        const void* cm, void* y, void* hout, int64_t B, int64_t S, int64_t H,
                        int64_t P, int64_t N, int64_t Q, int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(x, dt, a, bm, cm, y, hout, B, S, H, P, N, Q, s)
                    : launch<__nv_bfloat16>(x, dt, a, bm, cm, y, hout, B, S, H, P, N, Q, s);
}
