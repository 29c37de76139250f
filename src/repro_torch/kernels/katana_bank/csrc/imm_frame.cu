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
// What bounds it: at the serving shape (C = 1,024 tracks, K = 4, n = 9,
// M = 256) the frame moves ~3 MB and does ~10 M float32 operations, about
// a microsecond of the card; each launch's time is the latency of one
// thread's dependent chain (a few thousand instructions, one warp an SM)
// and the gaps between the launches, and the greedy's serial waves. A
// thread per track (8 blocks on 132 SMs, each thread mixing K targets,
// predicting K models and computing 4 M distances in series, 255
// registers) made that chain K times as long, so the frame is spread over
// the card and over the K models, in four launches on the caller's stream:
//   1. imm_predict: a thread per (model, track), K * kTracks threads a
//      block (128 blocks at C = 1,024), as imm_scan.cu lays out a frame;
//      8 or 16 tracks a block, or the mixed P kept in registers, take the
//      same time on an H100.
//      A block's K spans of x and P (model k's tracks c0 ... c0 + 7 are
//      one contiguous span) come in through shared memory with coalesced
//      16-byte cp.async, at the odd strides n and n^2. Thread (i >= 1, c)
//      forms its share of the spread once for the K targets, xt_i = x_i -
//      x_0 and A_i = P_i + xt_i xt_i^T, in place; thread (j, c) then mixes
//      target j from the K slabs of its track in index order, predicts on
//      the model set's compile-time Pattern (pruned.cuh: the plain
//      version's op stream, F's shared zeros skipped) through its own
//      slab, forms S and S^-1, and writes x'/P' back over its slab, which
//      the block stores with 16-byte stores. Its S^-1, z_pred and cbar_j
//      go to a scratch of K * C * (m^2 + m + 1) floats (L2-resident);
//   2. imm_cost: the (M, C) tile on a 2-D grid of kCostTracks tracks x
//      kCostMeas measurements, z in shared memory, a thread per track
//      with the K models' scratch in registers: each entry is
//      cbar_0 d_0 + cbar_1 d_1 + ..., folded left in model order;
//   3. the greedy (greedy.cuh), as in frame.cu;
//   4. imm_update: a thread per (model, track), the same blocks. The
//      block stages x'/P' in (L2-resident); the track's K threads
//      each rebuild S / S^-1 from the stored P' (same code, same bits),
//      update and form their log-likelihood, pass the K log-likelihoods
//      through shared memory, so each forms the same mode posterior, and
//      split the combined estimate's entries d = k, k + K, ... A coasting
//      track keeps x'/P' and takes mu <- cbar; only a block that updates
//      a track stores its spans back.
// At most 128 registers a thread (launch bounds).
// Sym = false (symmetrize=False) is the reference's full-square contract:
// the spread A_i, the mixed P, the predict and the update cover every
// entry of P (the slabs hold all n^2 either way), and the update reads
// P' whole, so an asymmetry of the float products is carried. A fleet
// runs Sym only (ops.py).
// A fleet frame serves S sensors in the same four launches, as frame.cu:
// x (K, S, C, n) is (K, S*C, n), mu (S*C, K), so the predict and the
// update run over S*C tracks (track t of sensor t / C, whose z the update
// reads); the cost grid gains a z axis of S; the greedy runs S lists and
// S blocks of waves. Each sensor is bit for bit its single-sensor frame.
// The sensor offsets are the compile-time Fleet route of the cost tile,
// the update and the greedy's tile: S = 1 runs the single-sensor code.
//
// The Markov prediction and the mixing, the log-likelihood and the mode
// posterior are imm.cuh's, shared with the IMM replay scan and step.
// Built with --fmad=false: the plain PyTorch version (ref.py) and this
// code then round identically.

#include <type_traits>

#include "greedy.cuh"
#include "pruned.cuh"

namespace katana {

// tracks a block of imm_predict and imm_update (K * kTracks threads)
constexpr int kTracks = 8;
// tracks x measurements a block of imm_cost
constexpr int kCostTracks = 128;
constexpr int kCostMeas = 8;

// The scratch `inno` between the launches holds M * M + M + 1 floats per
// (model, track) lane: S^-1 (M*M), z_pred (M), cbar. Entry e of lane
// (k, t) sits at (e * K + k) * SC + t, t one of the S*C (SC) tracks. The
// predict and the update take SC for C.

// A block's K spans of x and P: lane (k, cl) at k * kTracks + cl, at the
// odd strides N and N * N.
template <int N, int K>
struct FrameShared {
  __align__(16) float x[K * kTracks * N];
  __align__(16) float P[K * kTracks * N * N];
  float ll[K][kTracks];
};

// The K spans of the block's tracks c0 .. c0 + nt - 1, in (call
// stage_wait() and sync before reading) or out.
template <int N, int K>
__device__ __forceinline__ void spans_in(FrameShared<N, K>& sm,
                                         const float* x, const float* P,
                                         int C, int c0, int nt, int tid) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t l0 = (size_t)k * C + c0;
    stage_in(sm.x + k * kTracks * N, x + l0 * N, nt * N, tid, K * kTracks);
    stage_in(sm.P + k * kTracks * N * N, P + l0 * N * N, nt * N * N, tid,
             K * kTracks);
  }
}

template <int N, int K>
__device__ __forceinline__ void spans_out(float* x, float* P,
                                          const FrameShared<N, K>& sm, int C,
                                          int c0, int nt, int tid) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t l0 = (size_t)k * C + c0;
    stage_out(x + l0 * N, sm.x + k * kTracks * N, nt * N, tid, K * kTracks);
    stage_out(P + l0 * N * N, sm.P + k * kTracks * N * N, nt * N * N, tid,
              K * kTracks);
  }
}

template <class Pat, int K, bool Sym>
__global__ void __launch_bounds__(K * kTracks, 512 / (K * kTracks))
imm_predict(int C, const float* __restrict__ x, const float* __restrict__ P,
            const float* __restrict__ mu, const float* __restrict__ consts,
            float* __restrict__ x_out, float* __restrict__ P_out,
            float* __restrict__ inno) {
  constexpr int N = Pat::N, M = Pat::M, NN = N * N;
  __shared__ FrameShared<N, K> sm;
  const int tid = threadIdx.x;
  const int j = tid / kTracks;  // this thread's model
  const int cl = tid % kTracks;
  const int c0 = blockIdx.x * kTracks;
  const int nt = min(kTracks, C - c0);
  const bool live = cl < nt;
  const int c = c0 + cl;
  spans_in(sm, x, P, C, c0, nt, tid);
  float mu_i[K];  // loaded while the spans come in
#pragma unroll
  for (int i = 0; i < K; ++i) mu_i[i] = live ? mu[(size_t)c * K + i] : 0.0f;
  stage_wait();
  __syncthreads();

  float* xo = sm.x + tid * N;  // this lane's slab
  float* Po = sm.P + tid * NN;
  const float* x0 = sm.x + cl * N;  // model 0's x of the track
  auto slab = [&](int i) { return sm.P + (i * kTracks + cl) * NN; };

  // 1. this model's share of the spread, in place: xt_j over x_j, A_j over
  // P_j's upper triangle, or with !Sym all of P_j (A_0 = P_0)
  if (live && j > 0) {
    float xt[N];
#pragma unroll
    for (int d = 0; d < N; ++d) xt[d] = xo[d] - x0[d];
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int q = Sym ? r : 0; q < N; ++q)
        Po[r * N + q] = Po[r * N + q] + xt[r] * xt[q];
#pragma unroll
    for (int d = 0; d < N; ++d) xo[d] = xt[d];
  }
  __syncthreads();

  // 2. the mixed state of target model j from the K slabs of its track
  const float* Pi = consts + K * model_stride<N, M>();
  float cbar_j = 0.0f, xm[N], Pm[N][N];
  if (live) {
    float cbar[K], w[K];
    cbar_j = mix_weights<K>(
        [&](int i, int k) { return __ldg(Pi + i * K + k); }, mu_i, j, cbar, w);
    mix_target<N, K, Sym>(
        w, [&](int i, int d) { return sm.x[(i * kTracks + cl) * N + d]; },
        [&](int i, int r, int q) { return slab(i)[r * N + q]; },
        [&](int d) { return x0[d]; }, xm, Pm);
  }
  __syncthreads();  // every slab read before any is overwritten

  // 3. predict model j from its own slab, innovation, scratch
  if (live) {
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int q = 0; q < N; ++q) Po[r * N + q] = Pm[r][q];
    const ConstsIn<N, M> cs{consts + j * model_stride<N, M>()};
    float xp[N], Pp[N][N], S[M][M], Si[M][M];
    predict_pruned<Pat, Sym>(cs, false, 0.0f, xm,
                             [&](int r, int q) { return Po[r * N + q]; }, xp,
                             Pp);
    innovation_pruned<Pat>(Pp, [&](int r, int q) { return cs.R(r, q); }, S,
                           Si);
#pragma unroll
    for (int d = 0; d < N; ++d) xo[d] = xp[d];
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int q = 0; q < N; ++q) Po[r * N + q] = Pp[r][q];
    float* out = inno + (size_t)j * C + c;
    const size_t step = (size_t)K * C;
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int q = 0; q < M; ++q) out[(r * M + q) * step] = Si[r][q];
#pragma unroll
    for (int r = 0; r < M; ++r) out[(M * M + r) * step] = xp[obs<N, M>(r)];
    out[(M * M + M) * step] = cbar_j;
  }
  __syncthreads();
  spans_out(x_out, P_out, sm, C, c0, nt, tid);
}

// Block (x, y, s): sensor s's tracks x * kCostTracks ... against its
// measurements y * kCostMeas ...; z is (S, Mz, M), the tile (S, Mz, C).
// Without Fleet, one sensor (SC = C).
template <int M, int K, bool Fleet>
__global__ void __launch_bounds__(kCostTracks)
imm_cost(int C, int SC, int Mz, const float* __restrict__ z,
         const float* __restrict__ inno, float* __restrict__ cost) {
  __shared__ float zs[kCostMeas * M];
  if constexpr (Fleet) {
    const int s = blockIdx.z;
    z += (size_t)s * Mz * M;
    inno += (size_t)s * C;
    cost += (size_t)s * Mz * C;
  }
  const int ld = Fleet ? SC : C;  // every track's
  const int j0 = blockIdx.y * kCostMeas;
  const int nm = min(kCostMeas, Mz - j0);
  for (int t = threadIdx.x; t < nm * M; t += kCostTracks)
    zs[t] = z[(size_t)j0 * M + t];
  __syncthreads();
  const int c = blockIdx.x * kCostTracks + threadIdx.x;
  if (c >= C) return;
  const size_t step = (size_t)K * ld;
  float Si[K][M][M], zp[K][M], cb[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float* in = inno + (size_t)k * ld + c;
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int q = 0; q < M; ++q) Si[k][r][q] = __ldg(in + (r * M + q) * step);
#pragma unroll
    for (int r = 0; r < M; ++r) zp[k][r] = __ldg(in + (M * M + r) * step);
    cb[k] = __ldg(in + (M * M + M) * step);
  }
  for (int jj = 0; jj < nm; ++jj) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float t = cb[k] * mahalanobis<M>(Si[k], zp[k], zs + jj * M);
      acc = (k == 0) ? t : acc + t;
    }
    cost[(size_t)(j0 + jj) * C + c] = acc;
  }
}

// C is the S*C tracks here, Cs a sensor's: track c reads sensor c / Cs's
// z (Mz, M). Without Fleet, one sensor (C = Cs).
template <class Pat, int K, bool Fleet, bool Sym>
__global__ void __launch_bounds__(K * kTracks, 512 / (K * kTracks))
imm_update(int Cs, int C, int Mz, const float* __restrict__ z,
           const uint8_t* __restrict__ act, const float* __restrict__ consts,
           float log2pi_m, const int* __restrict__ assoc,
           const float* __restrict__ inno, float* __restrict__ x_out,
           float* __restrict__ P_out, float* __restrict__ mu_out,
           float* __restrict__ xc_out) {
  constexpr int N = Pat::N, M = Pat::M, NN = N * N;
  __shared__ FrameShared<N, K> sm;
  const int tid = threadIdx.x;
  const int k = tid / kTracks;  // this thread's model
  const int cl = tid % kTracks;
  const int c0 = blockIdx.x * kTracks;
  const int nt = min(kTracks, C - c0);
  const bool live = cl < nt;
  const int c = c0 + cl;
  spans_in(sm, x_out, P_out, C, c0, nt, tid);
  // while the spans come in: the assignment and the track's cbar
  const int a = live ? assoc[c] : -1;
  const bool upd = a >= 0 && act[c];
  float cbar[K];
#pragma unroll
  for (int i = 0; i < K; ++i)
    cbar[i] = live ? __ldg(inno + ((size_t)(M * M + M) * K + i) * C + c)
                   : 0.0f;
  stage_wait();
  // the spans go back out only from a block that updates a track
  const bool any = __syncthreads_or(upd) != 0;

  float* xo = sm.x + tid * N;  // this lane's slab
  float* Po = sm.P + tid * NN;
  if (upd) {
    const float* Rc = consts + k * model_stride<N, M>() + 2 * NN;
    auto Rv = [&](int r, int q) { return __ldg(Rc + r * M + q); };
    float xp[N], Pp[N][N], S[M][M], Si[M][M], zk[M], y[M], xn[N], Pn[N][N];
#pragma unroll
    for (int d = 0; d < N; ++d) xp[d] = xo[d];
    // with Sym P' is stored mirrored: its upper triangle is all of it
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int q = Sym ? r : 0; q < N; ++q) {
        Pp[r][q] = Po[r * N + q];
        if constexpr (Sym) Pp[q][r] = Pp[r][q];
      }
    innovation_pruned<Pat>(Pp, Rv, S, Si);
#pragma unroll
    const float* zc = z;  // its sensor's z
    if constexpr (Fleet) zc += (size_t)(c / Cs) * Mz * M;
#pragma unroll
    for (int r = 0; r < M; ++r) zk[r] = zc[(size_t)a * M + r];
    kalman_update<N, M, Sym>(xp, Pp, Si, zk, y, xn, Pn);
#pragma unroll
    for (int d = 0; d < N; ++d) xo[d] = xn[d];
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int q = 0; q < N; ++q) Po[r * N + q] = Pn[r][q];
    sm.ll[k][cl] = gaussian_loglik<M>(S, Si, y, log2pi_m);
  }
  __syncthreads();  // every model's x and loglik of the track written

  if (live) {
    float mu_sel[K];
    if (upd) {
      float ll[K];
#pragma unroll
      for (int i = 0; i < K; ++i) ll[i] = sm.ll[i][cl];
      mode_posterior<K>(cbar, ll, mu_sel);
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) mu_sel[i] = cbar[i];
    }
    if (k == 0) {
#pragma unroll
      for (int i = 0; i < K; ++i) mu_out[(size_t)c * K + i] = mu_sel[i];
    }
    for (int d = k; d < N; d += K) {
      float acc = mu_sel[0] * sm.x[cl * N + d];
#pragma unroll
      for (int i = 1; i < K; ++i)
        acc = acc + mu_sel[i] * sm.x[(i * kTracks + cl) * N + d];
      xc_out[(size_t)c * N + d] = acc;
    }
  }
  if (any) spans_out(x_out, P_out, sm, C, c0, nt, tid);
}

template <class Pat, int K, bool Fleet, bool Sym>
cudaError_t run_imm_frame(int S, int C, int Mz, const float* x,
                          const float* P,
                          const float* mu, const float* z,
                          const uint8_t* zval, const uint8_t* act,
                          const float* consts, float gate, int rounds,
                          float log2pi_m, float* x_out, float* P_out,
                          float* mu_out, float* xc_out, int* assoc,
                          float* cost, float* inno, void* scratch, int* waves,
                          cudaStream_t stream, void* const* events) {
  constexpr int M = Pat::M;
  const int SC = S * C;
  const int blocks = (SC + kTracks - 1) / kTracks;
  cudaError_t e = record(events, 0, stream);
  if (e != cudaSuccess) return e;
  if (SC > 0) {
    imm_predict<Pat, K, Sym><<<blocks, K * kTracks, 0, stream>>>(
        SC, x, P, mu, consts, x_out, P_out, inno);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  e = record(events, 1, stream);
  if (e != cudaSuccess) return e;
  if (SC > 0 && Mz > 0) {
    const dim3 grid((C + kCostTracks - 1) / kCostTracks,
                    (Mz + kCostMeas - 1) / kCostMeas, S);
    imm_cost<M, K, Fleet><<<grid, kCostTracks, 0, stream>>>(C, SC, Mz, z,
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
    imm_update<Pat, K, Fleet, Sym><<<blocks, K * kTracks, 0, stream>>>(
        C, SC, Mz, z, act, consts, log2pi_m, assoc, inno, x_out, P_out,
        mu_out, xc_out);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return record(events, 4, stream);
}

// The frame of an instantiated Pattern: (K, n, m) = (4, 9, 3) only; the
// full square (sym 0) one sensor only.
template <class Pat>
cudaError_t launch_frame(int K, int S, int C, int Mz, const void* x,
                         const void* P,
                         const void* mu, const void* z, const void* zval,
                         const void* act, const void* consts, float gate,
                         int rounds, float log2pi_m, void* x_out,
                         void* P_out, void* mu_out, void* xc_out,
                         void* assoc, void* cost, void* inno, void* scratch,
                         void* waves, int sym, cudaStream_t s,
                         void* const* events) {
  if constexpr (Pat::N == 9 && Pat::M == 3) {
    if (K != 4 || (!sym && S != 1)) return cudaErrorInvalidValue;
    // S = 1: the single-sensor code (no sensor offsets)
    auto go = [&](auto fleet, auto symm) {
      return run_imm_frame<Pat, 4, decltype(fleet)::value,
                           decltype(symm)::value>(
          S, C, Mz, (const float*)x, (const float*)P, (const float*)mu,
          (const float*)z, (const uint8_t*)zval, (const uint8_t*)act,
          (const float*)consts, gate, rounds, log2pi_m, (float*)x_out,
          (float*)P_out, (float*)mu_out, (float*)xc_out, (int*)assoc,
          (float*)cost, (float*)inno, scratch, (int*)waves, s, events);
    };
    if (!sym) return go(std::false_type{}, std::false_type{});
    return S == 1 ? go(std::false_type{}, std::true_type{})
                  : go(std::true_type{}, std::true_type{});
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace katana

extern "C" {

// The whole IMM frame for K > 1 and S >= 1 sensors: x (K, S, C, n), P (K,
// S, C, n, n), mu (S, C, K), z (S, Mz, m), zval (S, Mz), act and assoc
// (S, C), x_c (S, C, n), waves (S). Shapes (K, n, m) in {(4, 9, 3)},
// `pattern` the id of an instantiated Pattern of that shape (pruned.cuh);
// any other combination returns cudaErrorInvalidValue without launching.
// `cost` holds S * Mz * C floats, `inno` K * S * C * (m^2 + m + 1),
// `scratch` greedy_scratch_bytes(C, Mz, S). `events` is null or five
// CUDA events (each may be null) recorded before imm_predict, after it,
// after imm_cost (the greedy's start), after the greedy and after
// imm_update. sym: 1 for symmetrize=True, 0 for the full square (S = 1
// only).
int katana_imm_frame_run(int K, int n, int m, int pattern, int C, int Mz,
                         const void* x, const void* P, const void* mu,
                         const void* z, const void* zval, const void* act,
                         const void* consts, float gate, int rounds, int S,
                         float log2pi_m, void* x_out, void* P_out,
                         void* mu_out, void* xc_out, void* assoc, void* cost,
                         void* inno, void* scratch, void* waves, int sym,
                         void* stream, void* const* events) {
  using namespace katana;
  auto s = static_cast<cudaStream_t>(stream);
#define KATANA_IMM_FRAME_CASE(id, name, n_, m_, ...)                         \
  if (pattern == id && n == n_ && m == m_)                                  \
    return (int)launch_frame<name>(K, S, C, Mz, x, P, mu, z, zval, act,     \
                                   consts, gate, rounds, log2pi_m, x_out,   \
                                   P_out, mu_out, xc_out, assoc, cost,      \
                                   inno, scratch, waves, sym, s, events);
  KATANA_IMM_PATTERNS(KATANA_IMM_FRAME_CASE)
#undef KATANA_IMM_FRAME_CASE
  return (int)cudaErrorInvalidValue;
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
