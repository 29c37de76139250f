// katana_imm_frame: the IMM live tracking frame on Hopper (K > 1).
//
// Replaces repro/kernels/katana_bank/kernel.py:katana_imm_frame_step (body
// make_imm_frame_kernel, with _emit_imm_mix, _emit_mode_posterior,
// _emit_det and the plan_imm_tables constants): mixing, K predicts, the
// cbar-weighted gate sum_k cbar_k d_k, the wave greedy, K updates with
// per-model log-likelihoods from the same S^-1, the shift-stable mode
// posterior and the moment-matched combined estimate. Coasting tracks keep
// x'/P' and take mu <- cbar. The K = 1 IMM runs the single-model frame
// (frame.cu) with mu passed through, so it is the same device code.
//
// Same three-launch split as frame.cu: imm_predict_cost (a thread per
// track mixes its K slabs, predicts every model into the outputs and
// writes its column of the weighted cost tile), the greedy,
// imm_update (a thread per track rebuilds each model's S / S^-1 from the
// stored P', updates, and forms mu' and x_c).
// What bounds it: per track ~K*(2 n^3) float32 operations for mixing and
// predict and K*C*M*(~4m^2) for the tile; at C=1024 this is far below the
// card's rate, so launch latency, the serial greedy waves and register
// spills of the K*n^2 working set bound it. Later work: keep the mixing in
// shared memory and fuse the launches.
//
// The mixing, the Markov prediction, the log-likelihood and the mode
// posterior are imm.cuh's, shared with the IMM replay scan and step.

#include "greedy.cuh"
#include "imm.cuh"

namespace katana {

constexpr int kThreads = 128;

template <int N, int M, int K>
__global__ void imm_predict_cost(int C, int Mz, const float* __restrict__ x,
                                 const float* __restrict__ P,
                                 const float* __restrict__ mu,
                                 const float* __restrict__ z,
                                 const float* __restrict__ consts,
                                 float* __restrict__ x_out,
                                 float* __restrict__ P_out,
                                 float* __restrict__ cost) {
  extern __shared__ float zs[];  // (Mz, M)
  for (int t = threadIdx.x; t < Mz * M; t += blockDim.x) zs[t] = z[t];
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  constexpr int stride = model_stride<N, M>();
  const float* Pi = consts + K * stride;
  float mu_i[K], cbar[K];
#pragma unroll
  for (int i = 0; i < K; ++i) mu_i[i] = mu[(size_t)c * K + i];
  markov_predict<K>(Pi, mu_i, cbar);
  float x0v[N], xt[N][K];
#pragma unroll
  for (int d = 0; d < N; ++d) {
    x0v[d] = x[(size_t)c * N + d];
    xt[d][0] = 0.0f;
  }
#pragma unroll
  for (int i = 1; i < K; ++i)
#pragma unroll
    for (int d = 0; d < N; ++d)
      xt[d][i] = x[((size_t)i * C + c) * N + d] - x0v[d];

  float Si_all[K][M][M], zp_all[K][M];
  auto Pat = [&](int i, int r, int q) {
    return P[((size_t)i * C + c) * N * N + r * N + q];
  };
  for (int j = 0; j < K; ++j) {
    float xm[N], Pm[N][N];
    imm_mix_model<N, K>(Pi, mu_i, cbar[j], j, x0v, xt, Pat, xm, Pm);
    const float* Fc = consts + j * stride;
    const float* Qc = Fc + N * N;
    const float* Rc = Fc + 2 * N * N;
    float xp[N], Pp[N][N], S[M][M];
    predict_lane<N>(Fc, Qc, false, 0.0f, xm, Pm, xp, Pp);
    store_lane<N>(x_out + ((size_t)j * C + c) * N,
                  P_out + ((size_t)j * C + c) * N * N, xp, Pp);
    innovation<N, M>(Pp, Rc, S, Si_all[j]);
#pragma unroll
    for (int r = 0; r < M; ++r) zp_all[j][r] = xp[obs<N, M>(r)];
  }
  for (int jm = 0; jm < Mz; ++jm) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float t = cbar[k] * mahalanobis<M>(Si_all[k], zp_all[k],
                                               zs + jm * M);
      acc = (k == 0) ? t : acc + t;
    }
    cost[(size_t)jm * C + c] = acc;
  }
}

template <int N, int M, int K>
__global__ void imm_update(int C, const float* __restrict__ z,
                           const uint8_t* __restrict__ act,
                           const float* __restrict__ mu,
                           const float* __restrict__ consts,
                           float log2pi_m,
                           const int* __restrict__ assoc,
                           float* __restrict__ x_out,
                           float* __restrict__ P_out,
                           float* __restrict__ mu_out,
                           float* __restrict__ xc_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  constexpr int stride = model_stride<N, M>();
  const float* Pi = consts + K * stride;
  float mu_i[K], cbar[K];
#pragma unroll
  for (int i = 0; i < K; ++i) mu_i[i] = mu[(size_t)c * K + i];
  markov_predict<K>(Pi, mu_i, cbar);
  const int a = assoc[c];
  const bool upd = a >= 0 && act[c];
  float xs[K][N], mu_sel[K];
  if (!upd) {
    // coasting: x'/P' stay as predicted, mu <- cbar
#pragma unroll
    for (int k = 0; k < K; ++k) {
      mu_sel[k] = cbar[k];
#pragma unroll
      for (int d = 0; d < N; ++d) xs[k][d] = x_out[((size_t)k * C + c) * N + d];
    }
  } else {
    float zk[M], ll[K];
#pragma unroll
    for (int r = 0; r < M; ++r) zk[r] = z[(size_t)a * M + r];
    for (int k = 0; k < K; ++k) {
      const float* Rc = consts + k * stride + 2 * N * N;
      float xp[N], Pp[N][N], S[M][M], Si[M][M], y[M], Pn[N][N];
      float* xo = x_out + ((size_t)k * C + c) * N;
      float* Po = P_out + ((size_t)k * C + c) * N * N;
      load_lane<N>(xo, Po, xp, Pp);
      innovation<N, M>(Pp, Rc, S, Si);
      kalman_update<N, M>(xp, Pp, Si, zk, y, xs[k], Pn);
      store_lane<N>(xo, Po, xs[k], Pn);
      ll[k] = gaussian_loglik<M>(S, Si, y, log2pi_m);
    }
    mode_posterior<K>(cbar, ll, mu_sel);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) mu_out[(size_t)c * K + k] = mu_sel[k];
#pragma unroll
  for (int d = 0; d < N; ++d) {
    float acc = mu_sel[0] * xs[0][d];
#pragma unroll
    for (int k = 1; k < K; ++k) acc = acc + mu_sel[k] * xs[k][d];
    xc_out[(size_t)c * N + d] = acc;
  }
}

template <int N, int M, int K>
cudaError_t run_imm_frame(int C, int Mz, const float* x, const float* P,
                          const float* mu, const float* z,
                          const uint8_t* zval, const uint8_t* act,
                          const float* consts, float gate, int rounds,
                          float log2pi_m, float* x_out, float* P_out,
                          float* mu_out, float* xc_out, int* assoc,
                          float* cost, void* scratch, int* waves,
                          cudaStream_t stream, void* ev0, void* ev1) {
  const int blocks = (C + kThreads - 1) / kThreads;
  const size_t zbytes = (size_t)Mz * M * sizeof(float);
  imm_predict_cost<N, M, K><<<blocks, kThreads, zbytes, stream>>>(
      C, Mz, x, P, mu, z, consts, x_out, P_out, cost);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_greedy(FrameTile{cost, act, zval, C, gate}, C, Mz, rounds,
                    scratch, assoc, waves, stream, ev0, ev1);
  if (e != cudaSuccess) return e;
  imm_update<N, M, K><<<blocks, kThreads, 0, stream>>>(
      C, z, act, mu, consts, log2pi_m, assoc, x_out, P_out, mu_out, xc_out);
  return cudaGetLastError();
}

}  // namespace katana

extern "C" {

// The whole IMM frame for K > 1. Shapes (K, n, m) in {(4, 9, 3)}; any
// other shape returns cudaErrorInvalidValue without launching. scratch,
// ev0 and ev1 as in katana_frame_run.
int katana_imm_frame_run(int K, int n, int m, int C, int Mz, const void* x,
                         const void* P, const void* mu, const void* z,
                         const void* zval, const void* act,
                         const void* consts, float gate, int rounds,
                         float log2pi_m, void* x_out, void* P_out,
                         void* mu_out, void* xc_out, void* assoc, void* cost,
                         void* scratch, void* waves, void* stream, void* ev0,
                         void* ev1) {
  using namespace katana;
  auto s = static_cast<cudaStream_t>(stream);
  if (K == 4 && n == 9 && m == 3)
    return (int)run_imm_frame<9, 3, 4>(
        C, Mz, (const float*)x, (const float*)P, (const float*)mu,
        (const float*)z, (const uint8_t*)zval, (const uint8_t*)act,
        (const float*)consts, gate, rounds, log2pi_m, (float*)x_out,
        (float*)P_out, (float*)mu_out, (float*)xc_out, (int*)assoc,
        (float*)cost, scratch, (int*)waves, s, ev0, ev1);
  return (int)cudaErrorInvalidValue;
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
