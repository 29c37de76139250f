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
// Sym = false (symmetrize=False) is the reference's full-square contract:
// the predict computes every entry of P' (it stores all n^2 either way),
// the update reads P' whole and computes every entry of P, so an
// asymmetry of the float products is carried. The cost tile and the
// greedy do not see the contract. A fleet runs Sym only (ops.py).
// A fleet frame serves S sensors in the same four launches: x (S, C, n)
// is (S*C, n), so the predict and the update run over S*C tracks (track
// t of sensor t / C, which the update reads z and z_valid of); the cost
// grid gains a z axis of S, a block staging its own sensor's z into
// sensor s's (M, C) tile; the greedy runs S lists and S blocks of waves
// (greedy.cuh). A track's op stream does not depend on S, so each sensor
// is bit for bit its single-sensor frame. The sensor offsets are the
// compile-time Fleet route of the cost tile, the update and the greedy's
// tile: S = 1 runs the single-sensor code on its grids.
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
// track: S^-1 (M*M) then z_pred (M); entry e of track t (of the S*C
// tracks, SC) sits at e * SC + t.

template <class Pat, bool NL, bool Sym>
__global__ void __launch_bounds__(kTracks)
frame_predict(int SC, const float* __restrict__ x,
              const float* __restrict__ P,
              const __grid_constant__ ModelTable<Pat::N, Pat::M> tab,
              float dt, float* __restrict__ x_out, float* __restrict__ P_out,
              float* __restrict__ inno) {
  constexpr int N = Pat::N, M = Pat::M, NN = N * N;
  const int c = blockIdx.x * kTracks + threadIdx.x;
  if (c >= SC) return;
  float xv[N], Pv[NN];
  load_vec<N>(x + (size_t)c * N, xv);
  load_vec<NN>(P + (size_t)c * NN, Pv);
  float xp[N], Pp[N][N], S[M][M], Si[M][M], Pf[NN];
  predict_pruned<Pat, Sym>(tab, NL, dt, xv,
                           [&](int r, int q) { return Pv[r * N + q]; }, xp,
                           Pp);
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
    for (int q = 0; q < M; ++q) inno[(size_t)(r * M + q) * SC + c] = Si[r][q];
#pragma unroll
  for (int r = 0; r < M; ++r)
    inno[(size_t)(M * M + r) * SC + c] = xp[obs<N, M>(r)];
}

// Block (x, y, s): sensor s's tracks x * kCostTracks ... against its
// measurements y * kCostMeas ...; z is (S, Mz, M), the tile (S, Mz, C).
// Without Fleet, one sensor (SC = C).
template <int M, bool Fleet>
__global__ void __launch_bounds__(kCostTracks)
frame_cost(int C, int SC, int Mz, const float* __restrict__ z,
           const float* __restrict__ inno, float* __restrict__ cost) {
  __shared__ float zs[kCostMeas * M];
  if constexpr (Fleet) {
    const int s = blockIdx.z;
    z += (size_t)s * Mz * M;
    inno += (size_t)s * C;
    cost += (size_t)s * Mz * C;
  }
  const int ld = Fleet ? SC : C;  // inno's stride: every track's
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
      Si[r][q] = __ldg(inno + (size_t)(r * M + q) * ld + c);
#pragma unroll
  for (int r = 0; r < M; ++r)
    zp[r] = __ldg(inno + (size_t)(M * M + r) * ld + c);
  for (int jj = 0; jj < nm; ++jj)
    cost[(size_t)(j0 + jj) * C + c] = mahalanobis<M>(Si, zp, zs + jj * M);
}

// Track c of the S*C (SC): sensor c / C's z (Mz, M); act, assoc (S*C).
// Without Fleet, one sensor (SC = C).
template <int N, int M, bool Fleet, bool Sym>
__global__ void __launch_bounds__(kTracks)
frame_update(int C, int SC, int Mz, const float* __restrict__ z,
             const uint8_t* __restrict__ act, const int* __restrict__ assoc,
             const float* __restrict__ inno, float* __restrict__ x_out,
             float* __restrict__ P_out) {
  constexpr int NN = N * N;
  const int ld = Fleet ? SC : C;  // every track's
  const int c = blockIdx.x * kTracks + threadIdx.x;
  if (c >= ld) return;
  const int a = assoc[c];
  if (a < 0 || !act[c]) return;  // coasting: keeps the predicted x'/P'
  if constexpr (Fleet) z += (size_t)(c / C) * Mz * M;
  float xp[N], Pv[NN], Pp[N][N], Si[M][M], zk[M], y[M], xn[N], Pn[N][N];
  load_vec<N>(x_out + (size_t)c * N, xp);
  load_vec<NN>(P_out + (size_t)c * NN, Pv);
  // with Sym P' is stored mirrored: its upper triangle is all of it
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int q = Sym ? r : 0; q < N; ++q) {
      Pp[r][q] = Pv[r * N + q];
      if constexpr (Sym) Pp[q][r] = Pp[r][q];
    }
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int q = 0; q < M; ++q)
      Si[r][q] = __ldg(inno + (size_t)(r * M + q) * ld + c);
#pragma unroll
  for (int r = 0; r < M; ++r) zk[r] = z[(size_t)a * M + r];
  kalman_update<N, M, Sym>(xp, Pp, Si, zk, y, xn, Pn);
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int q = 0; q < N; ++q) Pv[r * N + q] = Pn[r][q];
  store_vec<N>(x_out + (size_t)c * N, xn);
  store_vec<NN>(P_out + (size_t)c * NN, Pv);
}

template <class Pat, bool NL, bool Fleet, bool Sym>
cudaError_t run_frame(int S, int C, int Mz, const float* x, const float* P,
                      const float* z, const uint8_t* zval, const uint8_t* act,
                      const ModelTable<Pat::N, Pat::M>& tab, float dt,
                      float gate, int rounds, float* x_out, float* P_out,
                      int* assoc, float* cost, float* inno, void* scratch,
                      int* waves, cudaStream_t stream, void* const* events) {
  constexpr int N = Pat::N, M = Pat::M;
  const int SC = S * C;
  const int blocks = (SC + kTracks - 1) / kTracks;
  cudaError_t e = record(events, 0, stream);
  if (e != cudaSuccess) return e;
  if (SC > 0) {
    frame_predict<Pat, NL, Sym><<<blocks, kTracks, 0, stream>>>(
        SC, x, P, tab, dt, x_out, P_out, inno);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  e = record(events, 1, stream);
  if (e != cudaSuccess) return e;
  if (SC > 0 && Mz > 0) {
    const dim3 grid((C + kCostTracks - 1) / kCostTracks,
                    (Mz + kCostMeas - 1) / kCostMeas, S);
    frame_cost<M, Fleet><<<grid, kCostTracks, 0, stream>>>(C, SC, Mz, z,
                                                            inno, cost);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  void* g0 = events ? events[2] : nullptr;
  void* g1 = events ? events[3] : nullptr;
  if constexpr (Fleet)
    e = launch_greedy(FleetTile{cost, act, zval, C, Mz, gate}, C, Mz, S,
                      rounds, scratch, assoc, waves, stream, g0, g1);
  else
    e = launch_greedy(FrameTile{cost, act, zval, C, gate}, C, Mz, 1, rounds,
                      scratch, assoc, waves, stream, g0, g1);
  if (e != cudaSuccess) return e;
  if (SC > 0) {
    frame_update<N, M, Fleet, Sym><<<blocks, kTracks, 0, stream>>>(
        C, SC, Mz, z, act, assoc, inno, x_out, P_out);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return record(events, 4, stream);
}

// The frame of an instantiated Pattern; `consts` is the model's F, Q, R
// in host memory, copied into the launches' parameters. A nonlinear
// model is the CTRA-8 (N = 8) only; the full square (sym 0) one sensor
// only.
template <class Pat>
cudaError_t launch_frame(int S, int C, int Mz, const void* x, const void* P,
                         const void* z, const void* zval, const void* act,
                         const void* consts, int nonlinear, float dt,
                         float gate, int rounds, void* x_out, void* P_out,
                         void* assoc, void* cost, void* inno, void* scratch,
                         void* waves, int sym, cudaStream_t s,
                         void* const* events) {
  ModelTable<Pat::N, Pat::M> tab;
  memcpy(&tab, consts, sizeof tab);
  if (!sym && S != 1) return cudaErrorInvalidValue;
  // S = 1: the single-sensor code (no sensor offsets)
  auto run = [&](auto nl) {
    auto go = [&](auto fleet, auto symm) {
      return run_frame<Pat, decltype(nl)::value, decltype(fleet)::value,
                       decltype(symm)::value>(
          S, C, Mz, (const float*)x, (const float*)P, (const float*)z,
          (const uint8_t*)zval, (const uint8_t*)act, tab, dt, gate, rounds,
          (float*)x_out, (float*)P_out, (int*)assoc, (float*)cost,
          (float*)inno, scratch, (int*)waves, s, events);
    };
    if (!sym) return go(std::false_type{}, std::false_type{});
    return S == 1 ? go(std::false_type{}, std::true_type{})
                  : go(std::true_type{}, std::true_type{});
  };
  if constexpr (Pat::N == 8) {
    if (nonlinear) return run(std::true_type{});
  }
  if (nonlinear) return cudaErrorInvalidValue;
  return run(std::false_type{});
}

}  // namespace katana

extern "C" {

// The whole frame of one model for S >= 1 sensors: x (S, C, n), P (S, C,
// n, n), z (S, Mz, m), zval (S, Mz), act and assoc (S, C), waves (S).
// `pattern` is the id of an instantiated Pattern of shape (n, m)
// (pruned.cuh, KATANA_IMM_PATTERNS); any other combination returns
// cudaErrorInvalidValue without launching. `consts` is the model's F, Q,
// R in HOST memory (ops._host_consts). `cost` holds S * Mz * C floats,
// `inno` (m^2 + m) * S * C, `scratch` greedy_scratch_bytes(C, Mz, S).
// `events` is null or five CUDA events (each may be null) recorded before
// frame_predict, after it, after frame_cost (the greedy's start), after
// the greedy and after frame_update. sym: 1 for symmetrize=True, 0 for
// the full square (S = 1 only).
int katana_frame_run(int n, int m, int pattern, int C, int Mz, const void* x,
                     const void* P, const void* z, const void* zval,
                     const void* act, const void* consts, int nonlinear,
                     float dt, float gate, int rounds, int S, void* x_out,
                     void* P_out, void* assoc, void* cost, void* inno,
                     void* scratch, void* waves, int sym, void* stream,
                     void* const* events) {
  using namespace katana;
  auto s = static_cast<cudaStream_t>(stream);
#define KATANA_FRAME_CASE(id, name, n_, m_, ...)                             \
  if (pattern == id && n == n_ && m == m_)                                  \
    return (int)launch_frame<name>(S, C, Mz, x, P, z, zval, act, consts,    \
                                   nonlinear, dt, gate, rounds, x_out,      \
                                   P_out, assoc, cost, inno, scratch, waves, \
                                   sym, s, events);
  KATANA_IMM_PATTERNS(KATANA_FRAME_CASE)
#undef KATANA_FRAME_CASE
  return (int)cudaErrorInvalidValue;
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
