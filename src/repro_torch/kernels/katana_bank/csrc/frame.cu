// katana_frame: the single-model live tracking frame on Hopper.
//
// Replaces repro/kernels/katana_bank/kernel.py:katana_frame_step (body
// make_frame_kernel): predict, innovation with one cofactor S^-1, the
// gated Mahalanobis cost tile, the wave greedy assignment and the Kalman
// update of the assigned, active tracks; every other track keeps its
// predicted x'/P'.
//
// The TPU kernel is one grid=(1,) program holding the whole bank and its
// (M, C) cost tile in VMEM. Here the tile (1 MiB at C=1024, M=256) does
// not fit one block's shared memory, so the frame is three launches on
// the caller's stream:
//   1. frame_predict_cost: a thread per track predicts, writes x'/P' into
//      the outputs and its column of the (M, C) cost tile (a scratch
//      tensor that stays in L2);
//   2. the greedy (greedy.cuh): the gated pairs of the tile compacted
//      into a candidate list, then one block runs the waves over it;
//   3. frame_update: a thread per assigned track rebuilds S^-1 from the
//      stored P' (same code, same bits) and overwrites x'/P' with the
//      update.
// What bounds it: per-track work is a few thousand float32 operations on
// registers and the tile pass is C*M*(~4m^2) operations, both far from
// the card's limits at these sizes; the frame is bound by launch latency
// and by the greedy's serial waves. Fusing into one
// persistent launch with a cluster-wide argmin is later work.
//
// Built with --fmad=false: the plain PyTorch version (ref.py) and this
// code then round identically, which keeps the association identical.

#include "greedy.cuh"
#include "kalman.cuh"

namespace katana {

constexpr int kThreads = 128;

template <int N, int M>
__global__ void frame_predict_cost(int C, int Mz, const float* __restrict__ x,
                                   const float* __restrict__ P,
                                   const float* __restrict__ z,
                                   const float* __restrict__ consts,
                                   int nonlinear, float dt,
                                   float* __restrict__ x_out,
                                   float* __restrict__ P_out,
                                   float* __restrict__ cost) {
  extern __shared__ float zs[];  // (Mz, M)
  for (int t = threadIdx.x; t < Mz * M; t += blockDim.x) zs[t] = z[t];
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float* Fc = consts;
  const float* Qc = consts + N * N;
  const float* Rc = consts + 2 * N * N;
  float xv[N], Pv[N][N], xp[N], Pp[N][N];
  load_lane<N>(x + (size_t)c * N, P + (size_t)c * N * N, xv, Pv);
  predict_lane<N>(Fc, Qc, nonlinear != 0, dt, xv, Pv, xp, Pp);
  store_lane<N>(x_out + (size_t)c * N, P_out + (size_t)c * N * N, xp, Pp);
  float S[M][M], Si[M][M], zp[M];
  innovation<N, M>(Pp, Rc, S, Si);
#pragma unroll
  for (int r = 0; r < M; ++r) zp[r] = xp[obs<N, M>(r)];
  for (int j = 0; j < Mz; ++j)
    cost[(size_t)j * C + c] = mahalanobis<M>(Si, zp, zs + j * M);
}

template <int N, int M>
__global__ void frame_update(int C, const float* __restrict__ z,
                             const uint8_t* __restrict__ act,
                             const float* __restrict__ consts,
                             const int* __restrict__ assoc,
                             float* __restrict__ x_out,
                             float* __restrict__ P_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int a = assoc[c];
  if (a < 0 || !act[c]) return;  // coasting: keeps the predicted x'/P'
  const float* Rc = consts + 2 * N * N;
  float xp[N], Pp[N][N], S[M][M], Si[M][M], zk[M], y[M], xn[N], Pn[N][N];
  load_lane<N>(x_out + (size_t)c * N, P_out + (size_t)c * N * N, xp, Pp);
  innovation<N, M>(Pp, Rc, S, Si);
#pragma unroll
  for (int r = 0; r < M; ++r) zk[r] = z[(size_t)a * M + r];
  kalman_update<N, M>(xp, Pp, Si, zk, y, xn, Pn);
  store_lane<N>(x_out + (size_t)c * N, P_out + (size_t)c * N * N, xn, Pn);
}

template <int N, int M>
cudaError_t run_frame(int C, int Mz, const float* x, const float* P,
                      const float* z, const uint8_t* zval, const uint8_t* act,
                      const float* consts, int nonlinear, float dt, float gate,
                      int rounds, float* x_out, float* P_out, int* assoc,
                      float* cost, void* scratch, int* waves,
                      cudaStream_t stream, void* ev0, void* ev1) {
  const int blocks = (C + kThreads - 1) / kThreads;
  const size_t zbytes = (size_t)Mz * M * sizeof(float);
  frame_predict_cost<N, M><<<blocks, kThreads, zbytes, stream>>>(
      C, Mz, x, P, z, consts, nonlinear, dt, x_out, P_out, cost);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_greedy(FrameTile{cost, act, zval, C, gate}, C, Mz, rounds,
                    scratch, assoc, waves, stream, ev0, ev1);
  if (e != cudaSuccess) return e;
  frame_update<N, M><<<blocks, kThreads, 0, stream>>>(C, z, act, consts,
                                                      assoc, x_out, P_out);
  return cudaGetLastError();
}

}  // namespace katana

extern "C" {

// The whole frame. Shapes (n, m) in {(6, 3), (8, 4), (9, 3)}; any other
// shape returns cudaErrorInvalidValue without launching. `scratch` holds
// greedy_scratch_bytes(C, Mz); ev0 / ev1 (null, or CUDA events) are
// recorded around the greedy's launches.
int katana_frame_run(int n, int m, int C, int Mz, const void* x,
                     const void* P, const void* z, const void* zval,
                     const void* act, const void* consts, int nonlinear,
                     float dt, float gate, int rounds, void* x_out,
                     void* P_out, void* assoc, void* cost, void* scratch,
                     void* waves, void* stream, void* ev0, void* ev1) {
  using namespace katana;
  auto s = static_cast<cudaStream_t>(stream);
#define KATANA_FRAME_CASE(N_, M_)                                           \
  if (n == N_ && m == M_)                                                   \
    return (int)run_frame<N_, M_>(                                          \
        C, Mz, (const float*)x, (const float*)P, (const float*)z,           \
        (const uint8_t*)zval, (const uint8_t*)act, (const float*)consts,    \
        nonlinear, dt, gate, rounds, (float*)x_out, (float*)P_out,          \
        (int*)assoc, (float*)cost, scratch, (int*)waves, s, ev0, ev1);
  KATANA_FRAME_CASE(6, 3)
  KATANA_FRAME_CASE(8, 4)
  KATANA_FRAME_CASE(9, 3)
#undef KATANA_FRAME_CASE
  return (int)cudaErrorInvalidValue;
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
