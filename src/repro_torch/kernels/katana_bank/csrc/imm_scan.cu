// katana_imm_scan: the IMM replay scan on Hopper (K > 1), a whole stream
// of T frames per launch.
//
// Replaces repro/kernels/katana_bank/kernel.py:katana_bank_imm_scan_step
// (body make_imm_scan_kernel): per frame the mixing of the K
// model-conditioned states, K predict+updates with their measurement
// log-likelihoods, the mode posterior and the moment-matched combined
// estimate, with x, P and mu resident across frames. An optional valid
// stream (T, N) makes a False frame coast by the reference's mul/add
// select: x^/P^ kept, mu <- cbar. The K = 1 IMM replay runs the
// single-model scan (scan.cu).
//
// Design: one thread per (model, track), K * kTracks threads a block,
// the threads of one model in one warp (kTracks = 32), so every warp
// reads the same model constants. One thread per track would carry
// K*(n + n^2) = 360 floats (K=4, n=9) through the time loop and spill
// every frame. Here a thread carries only its track's mode probabilities
// (K floats, the same in all K threads of the track); the states live in
// shared memory, one slab per (model, track) holding x (n) and P's upper
// triangle (n(n+1)/2), padded to an odd stride so a warp's 32 slabs sit in
// 32 different banks (K=4, n=9: 4*32*55*4 = 28 KB a block). Per frame:
//   1. each thread mixes its target model from the K slabs of its track
//      in index order (imm.cuh) -- sync --
//   2. predicts and updates its model with the track's z, computes its
//      log-likelihood, applies the valid select, and writes its slab and
//      loglik -- sync --
//   3. every thread of the track forms the same mode posterior from the K
//      logliks in the plain version's order; thread (k, c) writes the
//      combined estimate's entries d = k, k + K, ... of xs[t, c].
// Layouts are canonical: x (K, N, n), P (K, N, n, n), mu (N, K),
// zs (T, N, m), xs (T, N, n); the xs store is spread over the K warps of
// a track block.
//
// What bounds it: ~5 k float32 operations per track-frame (ref.py's
// pruned op stream: the K x K mixing of the 45 covariance entries, K
// predicts of a 9-state model, K updates) against (m + n)*4 bytes per
// track-frame: at N = 131,072 the operations bound it, a few
// milliseconds per 300 frames at the card's float32 rate. The dense
// predict loops here multiply the zeros of F too.
//
// Built with --fmad=false: the plain PyTorch version (ref.py) and this
// code then round identically.

#include "imm.cuh"

namespace katana {

constexpr int kTracks = 32;

template <int N>
__host__ __device__ constexpr int tri(int r, int q) {  // r <= q
  return r * N - r * (r - 1) / 2 + (q - r);
}

template <int N>
__host__ __device__ constexpr int slab_stride() {
  return (N + N * (N + 1) / 2) | 1;
}

template <int N, int M, int K>
__global__ void __launch_bounds__(K * kTracks)
imm_scan(int Ntr, int T, const float* __restrict__ x,
         const float* __restrict__ P, const float* __restrict__ mu,
         const float* __restrict__ zs, const uint8_t* __restrict__ vs,
         const float* __restrict__ consts, float log2pi_m,
         float* __restrict__ xs, float* __restrict__ x_fin,
         float* __restrict__ P_fin, float* __restrict__ mu_fin) {
  constexpr int SS = slab_stride<N>();
  constexpr int stride = model_stride<N, M>();
  __shared__ float slab[K][kTracks][SS];
  __shared__ float sll[K][kTracks];
  const int j = threadIdx.x / kTracks;
  const int cl = threadIdx.x % kTracks;
  const int c_raw = blockIdx.x * kTracks + cl;
  // lanes past the last track compute on a copy of it and store nothing:
  // every thread must reach the block's barriers
  const bool live = c_raw < Ntr;
  const int c = live ? c_raw : Ntr - 1;
  const float* Pi = consts + K * stride;
  const float* Fc = consts + j * stride;
  const float* Qc = Fc + N * N;
  const float* Rc = Fc + 2 * N * N;

  float* own = slab[j][cl];
#pragma unroll
  for (int d = 0; d < N; ++d) own[d] = x[((size_t)j * Ntr + c) * N + d];
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int q = r; q < N; ++q)
      own[N + tri<N>(r, q)] = P[((size_t)j * Ntr + c) * N * N + r * N + q];
  float mu_i[K];
#pragma unroll
  for (int i = 0; i < K; ++i) mu_i[i] = mu[(size_t)c * K + i];
  __syncthreads();

  auto Pat = [&](int i, int r, int q) {
    return slab[i][cl][N + tri<N>(r, q)];
  };
  for (int t = 0; t < T; ++t) {
    const size_t tc = (size_t)t * Ntr + c;
    float cbar[K];
    markov_predict<K>(Pi, mu_i, cbar);
    float x0v[N], xt[N][K], xm[N], Pm[N][N];
#pragma unroll
    for (int d = 0; d < N; ++d) {
      x0v[d] = slab[0][cl][d];
      xt[d][0] = 0.0f;
    }
#pragma unroll
    for (int i = 1; i < K; ++i)
#pragma unroll
      for (int d = 0; d < N; ++d) xt[d][i] = slab[i][cl][d] - x0v[d];
    float cbar_j = cbar[0];  // cbar[j] without a runtime register index
#pragma unroll
    for (int k = 1; k < K; ++k) cbar_j = (k == j) ? cbar[k] : cbar_j;
    imm_mix_model<N, K>(Pi, mu_i, cbar_j, j, x0v, xt, Pat, xm, Pm);
    __syncthreads();  // every slab read before any is overwritten

    float z[M], xp[N], Pp[N][N], S[M][M], Si[M][M], y[M], xn[N], Pn[N][N];
#pragma unroll
    for (int r = 0; r < M; ++r) z[r] = zs[tc * M + r];
    predict_lane<N>(Fc, Qc, false, 0.0f, xm, Pm, xp, Pp);
    innovation<N, M>(Pp, Rc, S, Si);
    kalman_update<N, M>(xp, Pp, Si, z, y, xn, Pn);
    sll[j][cl] = gaussian_loglik<M>(S, Si, y, log2pi_m);
    float v = 1.0f;
    if (vs != nullptr) {
      v = vs[tc] ? 1.0f : 0.0f;
      const float nv = 1.0f - v;
#pragma unroll
      for (int d = 0; d < N; ++d) own[d] = v * xn[d] + nv * xp[d];
#pragma unroll
      for (int r = 0; r < N; ++r)
#pragma unroll
        for (int q = r; q < N; ++q)
          own[N + tri<N>(r, q)] = v * Pn[r][q] + nv * Pp[r][q];
    } else {
#pragma unroll
      for (int d = 0; d < N; ++d) own[d] = xn[d];
#pragma unroll
      for (int r = 0; r < N; ++r)
#pragma unroll
        for (int q = r; q < N; ++q) own[N + tri<N>(r, q)] = Pn[r][q];
    }
    __syncthreads();  // every slab and loglik of the frame written

    float ll[K];
#pragma unroll
    for (int k = 0; k < K; ++k) ll[k] = sll[k][cl];
    mode_posterior<K>(cbar, ll, mu_i);
    if (vs != nullptr) {
      const float nv = 1.0f - v;
#pragma unroll
      for (int k = 0; k < K; ++k) mu_i[k] = v * mu_i[k] + nv * cbar[k];
    }
    if (live) {
      for (int d = j; d < N; d += K) {
        float acc = mu_i[0] * slab[0][cl][d];
#pragma unroll
        for (int k = 1; k < K; ++k) acc = acc + mu_i[k] * slab[k][cl][d];
        xs[tc * N + d] = acc;
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int d = 0; d < N; ++d) x_fin[((size_t)j * Ntr + c) * N + d] = own[d];
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int q = r; q < N; ++q) {
      const float p = own[N + tri<N>(r, q)];
      P_fin[((size_t)j * Ntr + c) * N * N + r * N + q] = p;
      P_fin[((size_t)j * Ntr + c) * N * N + q * N + r] = p;
    }
  if (j == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) mu_fin[(size_t)c * K + k] = mu_i[k];
  }
}

}  // namespace katana

extern "C" {

// The whole stream of T frames for Ntr tracks, K > 1. Shapes (K, n, m) in
// {(4, 9, 3)}; any other shape returns cudaErrorInvalidValue without
// launching. vs may be null (every frame valid).
int katana_imm_scan_run(int K, int n, int m, int Ntr, int T, const void* x,
                        const void* P, const void* mu, const void* zs,
                        const void* vs, const void* consts, float log2pi_m,
                        void* xs, void* x_fin, void* P_fin, void* mu_fin,
                        void* stream) {
  using namespace katana;
  auto s = static_cast<cudaStream_t>(stream);
  if (K == 4 && n == 9 && m == 3) {
    const int blocks = (Ntr + kTracks - 1) / kTracks;
    imm_scan<9, 3, 4><<<blocks, 4 * kTracks, 0, s>>>(
        Ntr, T, (const float*)x, (const float*)P, (const float*)mu,
        (const float*)zs, (const uint8_t*)vs, (const float*)consts, log2pi_m,
        (float*)xs, (float*)x_fin, (float*)P_fin, (float*)mu_fin);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
