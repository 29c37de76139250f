// IMM algebra of one track, shared by the live IMM frame (imm_frame.cu),
// the IMM replay scan (imm_scan.cu) and the per-frame IMM bank step
// (imm_step.cu): the Markov prediction of the mode probabilities, the
// mixing of the K model-conditioned states for one target model, the
// per-model measurement log-likelihood and the mode posterior.
//
// Device-side translation of the reference emit
// (repro/kernels/katana_bank/kernel.py: _emit_imm_mix,
// _emit_mode_posterior, the loglik tail of _emit_update). Sums fold left
// in the emit's order, so with --fmad=false the results are the float32
// bits of the plain PyTorch version (ref.py: _imm_mix, _mode_posterior,
// _update).
//
// Mixing follows the reference kernel, not rewrites.imm_mix: the spread
// is the centred moment with model 0 as the per-track reference,
//   P_mix_j = sum_i w_ij (P_i + xt_i xt_i^T) - mt_j mt_j^T,
// with xt_i = x_i - x_0, mt_j = sum_i w_ij xt_i, x_mix_j = mt_j + x_0 and
// w_ij = (Pi_ij mu_i) / max(cbar_j, FLT_MIN).
#pragma once

#include "kalman.cuh"

namespace katana {

// cbar_j = sum_i Pi_ij mu_i, in index order.
template <int K>
__device__ __forceinline__ void markov_predict(const float* __restrict__ Pi,
                                               const float (&mu)[K],
                                               float (&cbar)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float acc = __ldg(Pi + j) * mu[0];
#pragma unroll
    for (int i = 1; i < K; ++i) acc = acc + __ldg(Pi + i * K + j) * mu[i];
    cbar[j] = acc;
  }
}

// The mixed state of target model j (cbar_j its predicted mode
// probability). x0v is model 0's mean, xt[d][i] =
// x_i[d] - x0v[d] (xt[d][0] = 0), Pat(i, r, q) reads P_i[r][q] for r <= q.
template <int N, int K, class PAt>
__device__ __forceinline__ void imm_mix_model(const float* __restrict__ Pi,
                                              const float (&mu)[K],
                                              float cbar_j, int j,
                                              const float (&x0v)[N],
                                              const float (&xt)[N][K],
                                              PAt Pat, float (&xm)[N],
                                              float (&Pm)[N][N]) {
  const float rden = 1.0f / fmaxf(cbar_j, FLT_MIN);
  float w[K];
#pragma unroll
  for (int i = 0; i < K; ++i) w[i] = (__ldg(Pi + i * K + j) * mu[i]) * rden;
  float mt[N];
#pragma unroll
  for (int d = 0; d < N; ++d) {
    float acc = w[0] * xt[d][0];
#pragma unroll
    for (int i = 1; i < K; ++i) acc = acc + w[i] * xt[d][i];
    mt[d] = acc;
    xm[d] = mt[d] + x0v[d];
  }
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int q = r; q < N; ++q) {
      float acc = w[0] * Pat(0, r, q);
#pragma unroll
      for (int i = 1; i < K; ++i) {
        const float A = Pat(i, r, q) + xt[r][i] * xt[q][i];
        acc = acc + w[i] * A;
      }
      acc = acc - mt[r] * mt[q];
      Pm[r][q] = acc;
      Pm[q][r] = acc;
    }
}

// log N(y; 0, S) from the update's innovation y and S^-1:
// -0.5 (y^T S^-1 y + log det S + m log 2 pi), S^-1 y first.
template <int M>
__device__ __forceinline__ float gaussian_loglik(const float (&S)[M][M],
                                                 const float (&Si)[M][M],
                                                 const float (&y)[M],
                                                 float log2pi_m) {
  float d = 0.0f;
#pragma unroll
  for (int r = 0; r < M; ++r) {
    float Sy = Si[r][0] * y[0];
#pragma unroll
    for (int q = 1; q < M; ++q) Sy = Sy + Si[r][q] * y[q];
    const float t = y[r] * Sy;
    d = (r == 0) ? t : d + t;
  }
  return -0.5f * ((d + logf(small_det<M>(S))) + log2pi_m);
}

// mu'_k = cbar_k exp(ll_k - max ll) / sum, the shift-stable posterior.
template <int K>
__device__ __forceinline__ void mode_posterior(const float (&cbar)[K],
                                               const float (&ll)[K],
                                               float (&mu)[K]) {
  float mx = ll[0];
#pragma unroll
  for (int k = 1; k < K; ++k) mx = fmaxf(mx, ll[k]);
  float ws[K];
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ws[k] = cbar[k] * expf(ll[k] - mx);
    s = (k == 0) ? ws[k] : s + ws[k];
  }
  const float rs = 1.0f / s;
#pragma unroll
  for (int k = 0; k < K; ++k) mu[k] = ws[k] * rs;
}

}  // namespace katana
