// katana_bank_imm: one multi-model bank step on Hopper.
//
// Replaces repro/kernels/katana_bank/kernel.py:katana_bank_imm_step (body
// make_imm_kernel / make_imm_step_fn): each of the K*N (model, track)
// lanes, model-major, takes one predict+update of its model with its
// track's measurement and emits the measurement log-likelihood from the
// same S^-1. The per-frame IMM driver (ops.imm_bank_sequence) runs it
// once per frame between the mixing and the mode posterior.
//
// Design: one thread per lane. Lane l's model is l / N, and its F, Q, R
// are that model's rows of the float32 constant table (ops._consts). The
// reference instead folds a per-lane (E, L) table of the entries that
// differ between models on the host (ops._imm_lane_table); the values
// each lane reads are the same. K = 1 also serves a nonlinear member
// (the CTRA-8 EKF) through predict_lane's hard-coded dynamics. Layouts
// are canonical: x (K, N, n), P (K, N, n, n), z (N, m), loglik (K, N).
//
// What bounds it: (n + n^2)*4*2 bytes per lane in and out against ~1 k
// float32 operations per lane: the bytes, at any N. The thread's loads
// and stores stride by n*4 and n^2*4 bytes (contiguous per warp in
// aggregate).
//
// Built with --fmad=false: the plain PyTorch version (ref.py) and this
// code then round identically.

#include "imm.cuh"

namespace katana {

constexpr int kThreads = 128;

template <int N, int M>
__global__ void __launch_bounds__(kThreads)
imm_step(int Ntr, int K, const float* __restrict__ x,
         const float* __restrict__ P, const float* __restrict__ z,
         const float* __restrict__ consts, int nonlinear, float dt,
         float log2pi_m, float* __restrict__ x_out,
         float* __restrict__ P_out, float* __restrict__ ll) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= K * Ntr) return;
  const int k = l / Ntr;
  const int c = l - k * Ntr;
  const float* Fc = consts + k * model_stride<N, M>();
  float xv[N], Pv[N][N], zv[M], xp[N], Pp[N][N], S[M][M], Si[M][M], y[M],
      xn[N], Pn[N][N];
  load_lane<N>(x + (size_t)l * N, P + (size_t)l * N * N, xv, Pv);
#pragma unroll
  for (int r = 0; r < M; ++r) zv[r] = z[(size_t)c * M + r];
  predict_lane<N>(Fc, Fc + N * N, nonlinear != 0, dt, xv, Pv, xp, Pp);
  innovation<N, M>(Pp, Fc + 2 * N * N, S, Si);
  kalman_update<N, M>(xp, Pp, Si, zv, y, xn, Pn);
  store_lane<N>(x_out + (size_t)l * N, P_out + (size_t)l * N * N, xn, Pn);
  ll[l] = gaussian_loglik<M>(S, Si, y, log2pi_m);
}

}  // namespace katana

extern "C" {

// One frame for K models x Ntr tracks. Shapes (n, m) in {(6, 3), (8, 4),
// (9, 3)}; any other shape returns cudaErrorInvalidValue without
// launching.
int katana_imm_step_run(int K, int n, int m, int Ntr, const void* x,
                        const void* P, const void* z, const void* consts,
                        int nonlinear, float dt, float log2pi_m, void* x_out,
                        void* P_out, void* ll, void* stream) {
  using namespace katana;
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (K * Ntr + kThreads - 1) / kThreads;
#define KATANA_IMM_STEP_CASE(N_, M_)                                        \
  if (n == N_ && m == M_) {                                                 \
    imm_step<N_, M_><<<blocks, kThreads, 0, s>>>(                           \
        Ntr, K, (const float*)x, (const float*)P, (const float*)z,          \
        (const float*)consts, nonlinear, dt, log2pi_m, (float*)x_out,       \
        (float*)P_out, (float*)ll);                                         \
    return (int)cudaGetLastError();                                         \
  }
  KATANA_IMM_STEP_CASE(6, 3)
  KATANA_IMM_STEP_CASE(8, 4)
  KATANA_IMM_STEP_CASE(9, 3)
#undef KATANA_IMM_STEP_CASE
  return (int)cudaErrorInvalidValue;
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
