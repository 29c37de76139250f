// Per-track Kalman algebra shared by the tracking kernels, one track per
// thread: the observed rows of the selector H, the closed-form S^-1 and
// det S, the Mahalanobis distance of the cost tile and the Kalman update.
//
// Device-side translation of the reference Pallas emit
// (repro/kernels/katana_bank/kernel.py: _emit_small_inv, _emit_det,
// _emit_cost_tile, _emit_update). Sums fold left in the emit's index
// order, so with --fmad=false (no multiply-add contraction) the results
// are the same float32 bits as the emitted op stream and as the plain
// PyTorch version in ref.py. The predict and S = P'[obs][obs] + R follow
// the model set's compile-time pattern (pruned.cuh).
//
// Model constant table, per model k: F (N*N), Q (N*N), R (M*M), row
// major; after the K models, the Markov matrix trans (K*K).
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace katana {

// Observed state index of measurement row r. The supported selector H
// observe the leading positions; CTRA-8 (N=8, M=4) observes heading at 4.
template <int N, int M>
__host__ __device__ constexpr int obs(int r) {
  return (N == 8 && M == 4 && r == 3) ? 4 : r;
}

template <int N, int M>
__host__ __device__ constexpr int model_stride() {
  return 2 * N * N + M * M;
}

__device__ __forceinline__ void inv2(const float (&S)[2][2], float (&Si)[2][2]) {
  const float det = S[0][0] * S[1][1] - S[0][1] * S[1][0];
  const float r = 1.0f / det;
  Si[0][0] = S[1][1] * r;
  Si[0][1] = (-S[0][1]) * r;
  Si[1][0] = (-S[1][0]) * r;
  Si[1][1] = S[0][0] * r;
}

__device__ __forceinline__ void mul2(const float (&X)[2][2],
                                     const float (&Y)[2][2],
                                     float (&O)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) O[i][j] = X[i][0] * Y[0][j] + X[i][1] * Y[1][j];
}

// Cofactor inverse (M <= 3) / 2x2-block Schur inverse (M = 4).
template <int M>
__device__ __forceinline__ void small_inv(const float (&S)[M][M],
                                          float (&Si)[M][M]) {
  if constexpr (M == 1) {
    Si[0][0] = 1.0f / S[0][0];
  } else if constexpr (M == 2) {
    inv2(S, Si);
  } else if constexpr (M == 3) {
    const float c00 = S[1][1] * S[2][2] - S[1][2] * S[2][1];
    const float c01 = S[1][2] * S[2][0] - S[1][0] * S[2][2];
    const float c02 = S[1][0] * S[2][1] - S[1][1] * S[2][0];
    const float c10 = S[0][2] * S[2][1] - S[0][1] * S[2][2];
    const float c11 = S[0][0] * S[2][2] - S[0][2] * S[2][0];
    const float c12 = S[0][1] * S[2][0] - S[0][0] * S[2][1];
    const float c20 = S[0][1] * S[1][2] - S[0][2] * S[1][1];
    const float c21 = S[0][2] * S[1][0] - S[0][0] * S[1][2];
    const float c22 = S[0][0] * S[1][1] - S[0][1] * S[1][0];
    const float r = 1.0f / ((S[0][0] * c00 + S[0][1] * c01) + S[0][2] * c02);
    Si[0][0] = c00 * r; Si[0][1] = c10 * r; Si[0][2] = c20 * r;
    Si[1][0] = c01 * r; Si[1][1] = c11 * r; Si[1][2] = c21 * r;
    Si[2][0] = c02 * r; Si[2][1] = c12 * r; Si[2][2] = c22 * r;
  } else {
    static_assert(M == 4, "small_inv: M <= 4");
    float A[2][2], B[2][2], C[2][2], D[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        A[i][j] = S[i][j];
        B[i][j] = S[i][j + 2];
        C[i][j] = S[i + 2][j];
        D[i][j] = S[i + 2][j + 2];
      }
    float Di[2][2], BDi[2][2], BDiC[2][2], Sc[2][2], Sci[2][2], DiC[2][2];
    inv2(D, Di);
    mul2(B, Di, BDi);
    mul2(BDi, C, BDiC);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) Sc[i][j] = A[i][j] - BDiC[i][j];
    inv2(Sc, Sci);
    mul2(Di, C, DiC);
    float TR[2][2], BL[2][2], nTR[2][2], BDiT[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        TR[i][j] = -(Sci[i][0] * BDi[0][j] + Sci[i][1] * BDi[1][j]);
        BL[i][j] = -(DiC[i][0] * Sci[0][j] + DiC[i][1] * Sci[1][j]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nTR[i][j] = -TR[i][j];
    mul2(DiC, nTR, BDiT);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        Si[i][j] = Sci[i][j];
        Si[i][j + 2] = TR[i][j];
        Si[i + 2][j] = BL[i][j];
        Si[i + 2][j + 2] = Di[i][j] + BDiT[i][j];
      }
  }
}

// Closed-form determinant (cofactor expansion; Schur product for M = 4).
template <int M>
__device__ __forceinline__ float small_det(const float (&S)[M][M]) {
  if constexpr (M == 1) {
    return S[0][0];
  } else if constexpr (M == 2) {
    return S[0][0] * S[1][1] - S[0][1] * S[1][0];
  } else if constexpr (M == 3) {
    return (S[0][0] * (S[1][1] * S[2][2] - S[1][2] * S[2][1])
            + S[0][1] * (S[1][2] * S[2][0] - S[1][0] * S[2][2]))
           + S[0][2] * (S[1][0] * S[2][1] - S[1][1] * S[2][0]);
  } else {
    static_assert(M == 4, "small_det: M <= 4");
    float B[2][2], C[2][2], D[2][2], Di[2][2], BDi[2][2], Sc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        B[i][j] = S[i][j + 2];
        C[i][j] = S[i + 2][j];
        D[i][j] = S[i + 2][j + 2];
      }
    inv2(D, Di);
    mul2(B, Di, BDi);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        Sc[i][j] = S[i][j] - (BDi[i][0] * C[0][j] + BDi[i][1] * C[1][j]);
    const float dD = D[0][0] * D[1][1] - D[0][1] * D[1][0];
    const float dS = Sc[0][0] * Sc[1][1] - Sc[0][1] * Sc[1][0];
    return dD * dS;
  }
}

// y^T S^-1 y with y = z - z_pred: S^-1 y first, then y.
template <int M>
__device__ __forceinline__ float mahalanobis(const float (&Si)[M][M],
                                             const float (&zp)[M],
                                             const float* z) {
  float y[M];
#pragma unroll
  for (int r = 0; r < M; ++r) y[r] = z[r] - zp[r];
  float d = 0.0f;
#pragma unroll
  for (int r = 0; r < M; ++r) {
    float Sy = Si[r][0] * y[0];
#pragma unroll
    for (int c = 1; c < M; ++c) Sy = Sy + Si[r][c] * y[c];
    const float t = y[r] * Sy;
    d = (r == 0) ? t : d + t;
  }
  return d;
}

// Kalman update from the predicted state and the frame's S^-1:
// K = P'H^T S^-1, x = x' + K y, P = P' - K P'[obs, :] (Sym: the upper
// triangle, mirrored; otherwise every entry).
template <int N, int M, bool Sym = true>
__device__ __forceinline__ void kalman_update(const float (&xp)[N],
                                              const float (&Pp)[N][N],
                                              const float (&Si)[M][M],
                                              const float (&z)[M],
                                              float (&y)[M],
                                              float (&xn)[N],
                                              float (&Pn)[N][N]) {
#pragma unroll
  for (int r = 0; r < M; ++r) y[r] = z[r] - xp[obs<N, M>(r)];
  float K[N][M];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < M; ++r) {
      float acc = Pp[i][obs<N, M>(0)] * Si[0][r];
#pragma unroll
      for (int c = 1; c < M; ++c) acc = acc + Pp[i][obs<N, M>(c)] * Si[c][r];
      K[i][r] = acc;
    }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float acc = xp[i];
#pragma unroll
    for (int r = 0; r < M; ++r) acc = acc + K[i][r] * y[r];
    xn[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = Sym ? i : 0; j < N; ++j) {
      float acc = Pp[i][j];
#pragma unroll
      for (int r = 0; r < M; ++r) acc = acc - K[i][r] * Pp[obs<N, M>(r)][j];
      Pn[i][j] = acc;
      if constexpr (Sym) Pn[j][i] = acc;
    }
}

}  // namespace katana
