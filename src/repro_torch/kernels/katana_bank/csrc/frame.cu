// katana_frame: the single-model live tracking frame on Hopper.
//
// Replaces repro/kernels/katana_bank/kernel.py:katana_frame_step (body
// make_frame_kernel): predict, innovation with one cofactor S^-1, the
// gated Mahalanobis cost tile, the wave greedy assignment and the Kalman
// update of the assigned, active tracks; every other track keeps its
// predicted x'/P'. The K = 1 IMM frame runs this code too.
//
// What bounds it: at the serving shape (C = 1,024 tracks, M = 256, n/m
// 6/3 or 8/4) the frame moves ~0.35-0.6 MB and does ~1-2 M float32
// operations, a fraction of a microsecond of the card; each launch's time
// is the latency of one thread's dependent chain and the gaps between the
// launches, and the greedy's serial waves. A thread per track on 8 blocks,
// each computing the track's M = 256 distances in series, made the cost
// tile a chain of 256 distances, so the frame is spread over the card in
// four launches on the caller's stream, as the IMM frame (imm_frame.cu):
//   1. frame_predict: a thread per track, kTracks tracks a block (128
//      blocks at C = 1,024). It predicts on the model's compile-time
//      Pattern (pruned.cuh: the plain version's op stream, F's zeros
//      skipped; the CTRA-8 Jacobian built at the track's state), the same
//      code katana_bank and the replay scan run, forms S and S^-1, writes
//      x'/P' to the outputs and S^-1 and z_pred to a scratch of
//      (m^2 + m) * C floats (L2-resident);
//   2. frame_cost: the (M, C) tile on a 2-D grid of kCostTracks tracks x
//      kCostMeas measurements, z in shared memory, each thread's S^-1 and
//      z_pred in registers;
//   3. the greedy (greedy.cuh): the gated pairs of the tile compacted
//      into a candidate list, then one block runs the waves over it;
//   4. frame_update: a thread per assigned, active track, the blocks of
//      the predict: x', P' (its upper triangle) and S^-1 read back, the
//      Kalman update over x'/P'.
// x, P and x', P' move with 16-byte accesses where the address allows;
// the model's F, Q, R are the launch's parameters (ModelTable), read from
// the constant bank where they are used.
//
// Built with --fmad=false: the plain PyTorch version (ref.py) and this
// code then round identically, bit for bit, which keeps the association
// identical.

#include <string.h>
#include <type_traits>

#include "greedy.cuh"
#include "pruned.cuh"

namespace katana {

// tracks a block of frame_predict and frame_update
constexpr int kTracks = 8;
// tracks x measurements a block of frame_cost
constexpr int kCostTracks = 128;
constexpr int kCostMeas = 8;

// The scratch `inno` between the launches holds M * M + M floats per
// track: S^-1 (M*M) then z_pred (M); entry e of track c sits at e * C + c.

template <class Pat, bool NL>
__global__ void __launch_bounds__(kTracks)
frame_predict(int C, const float* __restrict__ x, const float* __restrict__ P,
              const __grid_constant__ ModelTable<Pat::N, Pat::M> tab,
              float dt, float* __restrict__ x_out, float* __restrict__ P_out,
              float* __restrict__ inno) {
  constexpr int N = Pat::N, M = Pat::M, NN = N * N;
  const int c = blockIdx.x * kTracks + threadIdx.x;
  if (c >= C) return;
  float xv[N], Pv[NN];
  load_vec<N>(x + (size_t)c * N, xv);
  load_vec<NN>(P + (size_t)c * NN, Pv);
  float xp[N], Pp[N][N], S[M][M], Si[M][M], Pf[NN];
  predict_pruned<Pat>(tab, NL, dt, xv,
                      [&](int r, int q) { return Pv[r * N + q]; }, xp, Pp);
  innovation_pruned<Pat>(Pp, [&](int r, int q) { return tab.R(r, q); }, S,
                         Si);
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int q = 0; q < N; ++q) Pf[r * N + q] = Pp[r][q];
  store_vec<N>(x_out + (size_t)c * N, xp);
  store_vec<NN>(P_out + (size_t)c * NN, Pf);
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int q = 0; q < M; ++q) inno[(size_t)(r * M + q) * C + c] = Si[r][q];
#pragma unroll
  for (int r = 0; r < M; ++r)
    inno[(size_t)(M * M + r) * C + c] = xp[obs<N, M>(r)];
}

template <int M>
__global__ void __launch_bounds__(kCostTracks)
frame_cost(int C, int Mz, const float* __restrict__ z,
           const float* __restrict__ inno, float* __restrict__ cost) {
  __shared__ float zs[kCostMeas * M];
  const int j0 = blockIdx.y * kCostMeas;
  const int nm = min(kCostMeas, Mz - j0);
  for (int t = threadIdx.x; t < nm * M; t += kCostTracks)
    zs[t] = z[(size_t)j0 * M + t];
  __syncthreads();
  const int c = blockIdx.x * kCostTracks + threadIdx.x;
  if (c >= C) return;
  float Si[M][M], zp[M];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int q = 0; q < M; ++q)
      Si[r][q] = __ldg(inno + (size_t)(r * M + q) * C + c);
#pragma unroll
  for (int r = 0; r < M; ++r)
    zp[r] = __ldg(inno + (size_t)(M * M + r) * C + c);
  for (int jj = 0; jj < nm; ++jj)
    cost[(size_t)(j0 + jj) * C + c] = mahalanobis<M>(Si, zp, zs + jj * M);
}

template <int N, int M>
__global__ void __launch_bounds__(kTracks)
frame_update(int C, const float* __restrict__ z,
             const uint8_t* __restrict__ act, const int* __restrict__ assoc,
             const float* __restrict__ inno, float* __restrict__ x_out,
             float* __restrict__ P_out) {
  constexpr int NN = N * N;
  const int c = blockIdx.x * kTracks + threadIdx.x;
  if (c >= C) return;
  const int a = assoc[c];
  if (a < 0 || !act[c]) return;  // coasting: keeps the predicted x'/P'
  float xp[N], Pv[NN], Pp[N][N], Si[M][M], zk[M], y[M], xn[N], Pn[N][N];
  load_vec<N>(x_out + (size_t)c * N, xp);
  load_vec<NN>(P_out + (size_t)c * NN, Pv);
  // P' is stored mirrored: its upper triangle is all of it
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int q = r; q < N; ++q) {
      Pp[r][q] = Pv[r * N + q];
      Pp[q][r] = Pp[r][q];
    }
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int q = 0; q < M; ++q)
      Si[r][q] = __ldg(inno + (size_t)(r * M + q) * C + c);
#pragma unroll
  for (int r = 0; r < M; ++r) zk[r] = z[(size_t)a * M + r];
  kalman_update<N, M>(xp, Pp, Si, zk, y, xn, Pn);
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int q = 0; q < N; ++q) Pv[r * N + q] = Pn[r][q];
  store_vec<N>(x_out + (size_t)c * N, xn);
  store_vec<NN>(P_out + (size_t)c * NN, Pv);
}

template <class Pat, bool NL>
cudaError_t run_frame(int C, int Mz, const float* x, const float* P,
                      const float* z, const uint8_t* zval, const uint8_t* act,
                      const ModelTable<Pat::N, Pat::M>& tab, float dt,
                      float gate, int rounds, float* x_out, float* P_out,
                      int* assoc, float* cost, float* inno, void* scratch,
                      int* waves, cudaStream_t stream, void* const* events) {
  constexpr int N = Pat::N, M = Pat::M;
  const int blocks = (C + kTracks - 1) / kTracks;
  cudaError_t e = record(events, 0, stream);
  if (e != cudaSuccess) return e;
  if (C > 0) {
    frame_predict<Pat, NL><<<blocks, kTracks, 0, stream>>>(
        C, x, P, tab, dt, x_out, P_out, inno);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  e = record(events, 1, stream);
  if (e != cudaSuccess) return e;
  if (C > 0 && Mz > 0) {
    const dim3 grid((C + kCostTracks - 1) / kCostTracks,
                    (Mz + kCostMeas - 1) / kCostMeas);
    frame_cost<M><<<grid, kCostTracks, 0, stream>>>(C, Mz, z, inno, cost);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  e = launch_greedy(FrameTile{cost, act, zval, C, gate}, C, Mz, rounds,
                    scratch, assoc, waves, stream,
                    events ? events[2] : nullptr,
                    events ? events[3] : nullptr);
  if (e != cudaSuccess) return e;
  if (C > 0) {
    frame_update<N, M><<<blocks, kTracks, 0, stream>>>(
        C, z, act, assoc, inno, x_out, P_out);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return record(events, 4, stream);
}

// The frame of an instantiated Pattern; `consts` is the model's F, Q, R
// in host memory, copied into the launches' parameters. A nonlinear
// model is the CTRA-8 (N = 8) only.
template <class Pat>
cudaError_t launch_frame(int C, int Mz, const void* x, const void* P,
                         const void* z, const void* zval, const void* act,
                         const void* consts, int nonlinear, float dt,
                         float gate, int rounds, void* x_out, void* P_out,
                         void* assoc, void* cost, void* inno, void* scratch,
                         void* waves, cudaStream_t s, void* const* events) {
  ModelTable<Pat::N, Pat::M> tab;
  memcpy(&tab, consts, sizeof tab);
  auto run = [&](auto nl) {
    return run_frame<Pat, decltype(nl)::value>(
        C, Mz, (const float*)x, (const float*)P, (const float*)z,
        (const uint8_t*)zval, (const uint8_t*)act, tab, dt, gate, rounds,
        (float*)x_out, (float*)P_out, (int*)assoc, (float*)cost,
        (float*)inno, scratch, (int*)waves, s, events);
  };
  if constexpr (Pat::N == 8) {
    if (nonlinear) return run(std::true_type{});
  }
  if (nonlinear) return cudaErrorInvalidValue;
  return run(std::false_type{});
}

}  // namespace katana

extern "C" {

// The whole frame of one model. `pattern` is the id of an instantiated
// Pattern of shape (n, m) (pruned.cuh, KATANA_IMM_PATTERNS); any other
// combination returns cudaErrorInvalidValue without launching. `consts`
// is the model's F, Q, R in HOST memory (ops._host_consts). `inno` holds
// (m^2 + m) * C floats, `scratch` greedy_scratch_bytes(C, Mz). `events`
// is null or five CUDA events (each may be null) recorded before
// frame_predict, after it, after frame_cost (the greedy's start), after
// the greedy and after frame_update.
int katana_frame_run(int n, int m, int pattern, int C, int Mz, const void* x,
                     const void* P, const void* z, const void* zval,
                     const void* act, const void* consts, int nonlinear,
                     float dt, float gate, int rounds, void* x_out,
                     void* P_out, void* assoc, void* cost, void* inno,
                     void* scratch, void* waves, void* stream,
                     void* const* events) {
  using namespace katana;
  auto s = static_cast<cudaStream_t>(stream);
#define KATANA_FRAME_CASE(id, name, n_, m_, ...)                             \
  if (pattern == id && n == n_ && m == m_)                                  \
    return (int)launch_frame<name>(C, Mz, x, P, z, zval, act, consts,       \
                                   nonlinear, dt, gate, rounds, x_out,      \
                                   P_out, assoc, cost, inno, scratch, waves, \
                                   s, events);
  KATANA_IMM_PATTERNS(KATANA_FRAME_CASE)
#undef KATANA_FRAME_CASE
  return (int)cudaErrorInvalidValue;
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
