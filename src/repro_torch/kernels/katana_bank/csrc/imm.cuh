// IMM algebra of one track, shared by the live IMM frame (imm_frame.cu),
// the IMM replay scan (imm_scan.cu) and the per-frame IMM bank step
// (imm_step.cu): the Markov prediction of the mode probabilities and the
// mixing weights, the mixing of the K model-conditioned states for one
// target model, the per-model measurement log-likelihood and the mode
// posterior.
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

// cbar_k = sum_i Pi_ik mu_i (in index order) for every model k, and the
// mixing weights of target model j, w_i = (Pi_ij mu_i) / max(cbar_j,
// FLT_MIN). Pi(i, k) reads the Markov matrix. Returns cbar_j.
template <int K, class PI>
__device__ __forceinline__ float mix_weights(const PI& Pi,
                                             const float (&mu)[K], int j,
                                             float (&cbar)[K],
                                             float (&w)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float acc = Pi(0, k) * mu[0];
#pragma unroll
    for (int i = 1; i < K; ++i) acc = acc + Pi(i, k) * mu[i];
    cbar[k] = acc;
  }
  float cbar_j = cbar[0];  // cbar[j] without a runtime register index
#pragma unroll
  for (int k = 1; k < K; ++k) cbar_j = k == j ? cbar[k] : cbar_j;
  const float rden = 1.0f / fmaxf(cbar_j, FLT_MIN);
#pragma unroll
  for (int i = 0; i < K; ++i) w[i] = (Pi(i, j) * mu[i]) * rden;
  return cbar_j;
}

// The mixed state of a target model from its weights w, the terms of
// xt_0 = 0 pruned as ref._imm_mix prunes them: mt = sum_{i>=1} w_i xt_i,
// x_mix = mt + x_0, P_mix = sum_i w_i A_i - mt mt^T. xt(i, d) reads
// xt_i[d] (i >= 1), A(i, r, q) reads A_i[r][q], x0(d) model 0's mean.
// Sym (symmetrize=True): P_mix's upper triangle (A read at r <= q),
// mirrored; otherwise every entry (ref._imm_mix's ``sym``).
template <int N, int K, bool Sym = true, class XT, class AT, class X0>
__device__ __forceinline__ void mix_target(const float (&w)[K], const XT& xt,
                                           const AT& A, const X0& x0,
                                           float (&xm)[N], float (&Pm)[N][N]) {
  float mt[N];
#pragma unroll
  for (int d = 0; d < N; ++d) {
    float acc = w[1] * xt(1, d);
#pragma unroll
    for (int i = 2; i < K; ++i) acc = acc + w[i] * xt(i, d);
    mt[d] = acc;
    xm[d] = acc + x0(d);
  }
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int q = Sym ? r : 0; q < N; ++q) {
      float acc = w[0] * A(0, r, q);
#pragma unroll
      for (int i = 1; i < K; ++i) acc = acc + w[i] * A(i, r, q);
      acc = acc - mt[r] * mt[q];
      Pm[r][q] = acc;
      if constexpr (Sym) Pm[q][r] = acc;
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
