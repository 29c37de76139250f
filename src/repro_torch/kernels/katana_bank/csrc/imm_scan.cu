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
// What bounds it: ~6.2 k float32 operations per track-frame (ref.py's
// pruned op stream: the K x K mixing of the 45 covariance entries, K
// predicts of a 9-state model, K updates) against (m + n)*4 bytes per
// track-frame: at N = 131,072 the operations, 3.65 ms per 300 frames at
// the card's float32 peak. Built with --fmad=false, every one of them is
// an instruction of its own, so the issue rate, not the FMA pipes' peak,
// is the practical ceiling: half of that bound.
//
// Design: one thread per (model, track), K * Tracks threads a block, the
// threads of model j in warps j * Tracks / 32 onwards (Tracks = 32 or 64:
// a launch choice, ops.LANE_TILES, the tile table's; not 16, which would
// put two models' code paths in one warp), every warp on one code path;
// a track's bits do not depend on Tracks. A thread keeps its own x and P
// in registers across the frames; shared memory holds the copies the
// track's other threads read, one
// slab per (model, track) with x (n) and P's upper triangle (n(n+1)/2),
// padded to an odd stride so a warp's 32 slabs sit in 32 different banks
// (K=4, n=9: 4*32*55*4 = 28 KB a block of 32 tracks; all of ScanShared
// 42 KB, 85 KB at 64 tracks, dynamic shared memory past the 48 KB a
// launch gets without cudaFuncSetAttribute). Shared-memory traffic, not the
// float32 work alone, bounds a frame: the mixing reads K slabs for each
// of the K targets. Model j's constants are a runtime offset
// into the kernel's parameters (ImmTable, 2.8 KB), read from the constant
// bank where they are used, so none is held in a register across the
// time loop; the predict follows the model set's compile-time Pattern
// (pruned.cuh): the plain version's op stream, none of F's 59 shared
// zeros multiplied for make_imm(). At most 128 registers a thread: 4
// blocks of 32 tracks (16 warps) an SM, 2 of 64. Per frame, three
// barriers:
//   1. thread (i >= 1, c) forms its share of the spread, xt_i = x_i - x_0
//      and A_i = P_i + xt_i xt_i^T, once for the K targets (the plain
//      version's order), and writes A_i (A_0 = P_0) into its slab and xt_i
//      into a small xt slab;
//   2. each thread mixes its target model j from the K slabs of its
//      track in index order (P_mix = sum_i w_ij A_i - mt mt^T);
//   3. predicts and updates its model with the track's z (F P one row at
//      a time), computes its log-likelihood, applies the valid select, and
//      writes its x and loglik;
//   4. every thread of the track forms the same mode posterior from the K
//      logliks; thread (k, c) writes the combined estimate's entries
//      d = k, k + K, ... of xs[t, c]. Step 1 of the next frame writes
//      only P and xt, which step 4 does not read: no barrier between them.
// A model's P for the block's tracks is one contiguous span of device
// memory (10 KB at 32 tracks): it comes in and goes out through a staging
// buffer with 16-byte accesses, one model at a time. Layouts are canonical:
// x (K, N, n), P (K, N, n, n), mu (N, K), zs (T, N, m), xs (T, N, n).
// Sym = false (symmetrize=False) is the reference's full-square contract:
// a thread keeps all n^2 entries of its P, the seed is read whole, and
// the spread, the mixing, the predict, the update and the valid select
// cover every entry, so an asymmetry of the float products is carried.
// A slab then holds x and the whole P, (9 + 81) | 1 = 91 floats where the
// triangle takes 55: ScanShared is 59.5 KB at 32 tracks, 119 KB at 64 (one
// block an SM), within the 227 KB of dynamic shared memory a block gets.
//
// Built with --fmad=false: the plain PyTorch version (ref.py) and this
// code then round identically.

#include <string.h>
#include <type_traits>

#include "pruned.cuh"

namespace katana {

// the instantiated tiles (tracks a block); ops.LANE_TILES mirrors them
#define KATANA_IMM_SCAN_TILES(X) X(32) X(64)

// resident blocks an SM: at most 128 registers a thread (3 blocks of 32
// tracks were slower on the card with 168, 5 spilled at 96)
template <int K, int Tracks>
constexpr int imm_scan_min_blocks() {
  return 65536 / (K * Tracks * 128);
}

// a slab: x, then P's upper triangle (Sym) or all of P, padded odd
template <int N, bool Sym>
__host__ __device__ constexpr int slab_stride() {
  return (N + (Sym ? N * (N + 1) / 2 : N * N)) | 1;
}

// P[r][q]'s place in a slab after x (r <= q with Sym)
template <int N, bool Sym>
__host__ __device__ constexpr int slab_at(int r, int q) {
  return N + (Sym ? tri<N>(r, q) : r * N + q);
}

// The model constants as ops._host_consts lays them out: per model F, Q,
// R (row major), then the Markov matrix.
template <int N, int M, int K>
struct ImmTable {
  struct Model {
    float F[N * N];
    float Q[N * N];
    float R[M * M];
  } mdl[K];
  float Pi[K * K];
};

template <int N, int K, int Tracks, bool Sym>
struct ScanShared {
  // one model's P for the block's tracks, a contiguous span of device
  // memory, on its way in and out with 16-byte accesses
  __align__(16) float stage[Tracks * N * N];
  float slab[K][Tracks][slab_stride<N, Sym>()];
  float xt[K - 1][Tracks][N | 1];
  float ll[K][Tracks];
};

struct ScanArgs {
  int Ntr, T;
  const float* zs;
  const uint8_t* vs;
  float log2pi_m;
  float* xs;
};

template <int N, int M, int K, class Pat, bool Sym, int Tracks>
__global__ void __launch_bounds__(K * Tracks, imm_scan_min_blocks<K, Tracks>())
imm_scan(const __grid_constant__ ScanArgs a, const float* __restrict__ x,
         const float* __restrict__ P, const float* __restrict__ mu,
         float* __restrict__ x_fin, float* __restrict__ P_fin,
         float* __restrict__ mu_fin,
         const __grid_constant__ ImmTable<N, M, K> tab) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<ScanShared<N, K, Tracks, Sym>*>(smem_raw);
  const int Ntr = a.Ntr;
  const int j = threadIdx.x / Tracks;
  const int cl = threadIdx.x % Tracks;
  const int c_raw = blockIdx.x * Tracks + cl;
  // lanes past the last track compute on a copy of it and store nothing:
  // every thread must reach the block's barriers
  const bool live = c_raw < Ntr;
  const int c = live ? c_raw : Ntr - 1;
  const size_t lane = (size_t)j * Ntr + c;

  // model j's constants: a runtime offset into the parameters, read
  // where they are used (one constant-bank load each a frame)
  const auto& md = tab.mdl[j];
  auto Fv = [&](int i, int k) { return md.F[i * N + k]; };
  auto Qv = [&](int i, int k) { return md.Q[i * N + k]; };
  auto Rv = [&](int r, int q) { return md.R[r * M + q]; };
  float* own = sm.slab[j][cl];
  const float* x0s = sm.slab[0][cl];
  const int c0 = blockIdx.x * Tracks;
  const int nc = min(Tracks, Ntr - c0);
  const int tid = threadIdx.x;
  float* mine = sm.stage + (c - c0) * N * N;  // this lane's P when staged
  // the thread's own state stays in registers across the frames: the
  // slab holds the copies the other models' threads read
  float xs_own[N], Ps_own[N][N];
#pragma unroll
  for (int d = 0; d < N; ++d) {
    xs_own[d] = x[lane * N + d];
    own[d] = xs_own[d];
  }
  for (int m = 0; m < K; ++m) {
    stage_in(sm.stage, P + ((size_t)m * Ntr + c0) * N * N, nc * N * N, tid,
             K * Tracks);
    stage_wait();
    __syncthreads();
    if (j == m) {
#pragma unroll
      for (int r = 0; r < N; ++r)
#pragma unroll
        for (int q = Sym ? r : 0; q < N; ++q) Ps_own[r][q] = mine[r * N + q];
    }
    __syncthreads();
  }
  float mu_i[K];
#pragma unroll
  for (int i = 0; i < K; ++i) mu_i[i] = mu[(size_t)c * K + i];
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    const size_t tc = (size_t)t * Ntr + c;
    // 1. this model's share of the spread, into its slab
    if (j > 0) {
      float xt[N];
#pragma unroll
      for (int d = 0; d < N; ++d) {
        xt[d] = xs_own[d] - x0s[d];
        sm.xt[j - 1][cl][d] = xt[d];
      }
#pragma unroll
      for (int r = 0; r < N; ++r)
#pragma unroll
        for (int q = Sym ? r : 0; q < N; ++q)
          Ps_own[r][q] = Ps_own[r][q] + xt[r] * xt[q];
    }
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int q = Sym ? r : 0; q < N; ++q)
        own[slab_at<N, Sym>(r, q)] = Ps_own[r][q];
    __syncthreads();

    // 2. the mixed state of target model j from the K slabs of its track
    // (imm.cuh)
    float cbar[K], w[K], xm[N], Pm[N][N];
    mix_weights<K>([&](int i, int k) { return tab.Pi[i * K + k]; }, mu_i, j,
                   cbar, w);
    mix_target<N, K, Sym>(
        w, [&](int i, int d) { return sm.xt[i - 1][cl][d]; },
        [&](int i, int r, int q) {
          return sm.slab[i][cl][slab_at<N, Sym>(r, q)];
        },
        [&](int d) { return x0s[d]; }, xm, Pm);
    __syncthreads();  // every slab read before any is overwritten

    // 3. predict and update model j
    float z[M], xp[N], Pp[N][N], S[M][M], Si[M][M], y[M], xn[N], Pn[N][N];
#pragma unroll
    for (int r = 0; r < M; ++r) z[r] = a.zs[tc * M + r];
    predict_mean<Pat>(Fv, xm, xp);
    predict_cov_pruned<Pat, Sym>(Fv, Qv,
                                 [&](int r, int q) { return Pm[r][q]; }, Pp);
    innovation_pruned<Pat>(Pp, Rv, S, Si);
    kalman_update<N, M, Sym>(xp, Pp, Si, z, y, xn, Pn);
    sm.ll[j][cl] = gaussian_loglik<M>(S, Si, y, a.log2pi_m);
    float v = 1.0f;
    if (a.vs != nullptr) {
      v = a.vs[tc] ? 1.0f : 0.0f;
      const float nv = 1.0f - v;
#pragma unroll
      for (int d = 0; d < N; ++d) xs_own[d] = v * xn[d] + nv * xp[d];
#pragma unroll
      for (int r = 0; r < N; ++r)
#pragma unroll
        for (int q = Sym ? r : 0; q < N; ++q)
          Ps_own[r][q] = v * Pn[r][q] + nv * Pp[r][q];
    } else {
#pragma unroll
      for (int d = 0; d < N; ++d) xs_own[d] = xn[d];
#pragma unroll
      for (int r = 0; r < N; ++r)
#pragma unroll
        for (int q = Sym ? r : 0; q < N; ++q) Ps_own[r][q] = Pn[r][q];
    }
#pragma unroll
    for (int d = 0; d < N; ++d) own[d] = xs_own[d];
    __syncthreads();  // every slab and loglik of the frame written

    // 4. mode posterior and combined estimate
    float ll[K];
#pragma unroll
    for (int k = 0; k < K; ++k) ll[k] = sm.ll[k][cl];
    mode_posterior<K>(cbar, ll, mu_i);
    if (a.vs != nullptr) {
      const float nv = 1.0f - v;
#pragma unroll
      for (int k = 0; k < K; ++k) mu_i[k] = v * mu_i[k] + nv * cbar[k];
    }
    if (live) {
      for (int d = j; d < N; d += K) {
        float acc = mu_i[0] * sm.slab[0][cl][d];
#pragma unroll
        for (int k = 1; k < K; ++k) acc = acc + mu_i[k] * sm.slab[k][cl][d];
        a.xs[tc * N + d] = acc;
      }
    }
  }

  for (int m = 0; m < K; ++m) {
    if (j == m) {
#pragma unroll
      for (int r = 0; r < N; ++r)
#pragma unroll
        for (int q = Sym ? r : 0; q < N; ++q) {
          mine[r * N + q] = Ps_own[r][q];
          if constexpr (Sym) mine[q * N + r] = Ps_own[r][q];
        }
    }
    __syncthreads();
    stage_out(P_fin + ((size_t)m * Ntr + c0) * N * N, sm.stage, nc * N * N,
              tid, K * Tracks);
    __syncthreads();
  }
  if (!live) return;
#pragma unroll
  for (int d = 0; d < N; ++d) x_fin[lane * N + d] = xs_own[d];
  if (j == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) mu_fin[(size_t)c * K + k] = mu_i[k];
  }
}

template <class Pat, bool Sym, int Tracks>
int launch_scan(int K, int Ntr, int T, const void* x, const void* P,
                const void* mu, const void* zs, const void* vs,
                const void* consts, float log2pi_m, void* xs, void* x_fin,
                void* P_fin, void* mu_fin, cudaStream_t s) {
  if constexpr (Pat::N == 9 && Pat::M == 3) {
    if (K != 4) return (int)cudaErrorInvalidValue;
    ImmTable<9, 3, 4> tab;
    memcpy(&tab, consts, sizeof tab);
    const ScanArgs a{Ntr, T, (const float*)zs, (const uint8_t*)vs, log2pi_m,
                     (float*)xs};
    constexpr size_t bytes = sizeof(ScanShared<9, 4, Tracks, Sym>);
    auto* kernel = imm_scan<9, 3, 4, Pat, Sym, Tracks>;
    if constexpr (bytes > 48 * 1024) {
      static const cudaError_t set = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (set != cudaSuccess) return (int)set;
    }
    const int blocks = (Ntr + Tracks - 1) / Tracks;
    kernel<<<blocks, 4 * Tracks, bytes, s>>>(
        a, (const float*)x, (const float*)P, (const float*)mu, (float*)x_fin,
        (float*)P_fin, (float*)mu_fin, tab);
    return (int)cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace katana

extern "C" {

// The whole stream of T frames for Ntr tracks, K > 1. Shapes (K, n, m) in
// {(4, 9, 3)}, `pattern` the id of an instantiated Pattern of that shape
// (pruned.cuh); any other combination returns cudaErrorInvalidValue
// without launching, and so does a `tile` (tracks a block) outside
// KATANA_IMM_SCAN_TILES. `consts` is the constant table in HOST memory
// (ops._host_consts: per model F, Q, R, then the Markov matrix), copied
// into the launch's parameters. vs may be null (every frame valid). sym:
// 1 for symmetrize=True, 0 for the full square.
int katana_imm_scan_run(int K, int n, int m, int pattern, int Ntr, int T,
                        const void* x, const void* P, const void* mu,
                        const void* zs, const void* vs, const void* consts,
                        float log2pi_m, void* xs, void* x_fin, void* P_fin,
                        void* mu_fin, int sym, int tile, void* stream) {
  using namespace katana;
  auto s = static_cast<cudaStream_t>(stream);
  auto by_sym = [&](auto pat, auto symm) -> int {
    using Pat = decltype(pat);
    constexpr bool Sym = decltype(symm)::value;
#define KATANA_IMM_SCAN_TILE(t)                                              \
  if (tile == t)                                                            \
    return launch_scan<Pat, Sym, t>(K, Ntr, T, x, P, mu, zs, vs, consts,    \
                                    log2pi_m, xs, x_fin, P_fin, mu_fin, s);
    KATANA_IMM_SCAN_TILES(KATANA_IMM_SCAN_TILE)
#undef KATANA_IMM_SCAN_TILE
    return (int)cudaErrorInvalidValue;
  };
  auto by_tile = [&](auto pat) -> int {
    return sym ? by_sym(pat, std::true_type{})
               : by_sym(pat, std::false_type{});
  };
#define KATANA_IMM_SCAN_CASE(id, name, n_, m_, ...)                          \
  if (pattern == id && n == n_ && m == m_) return by_tile(name{});
  KATANA_IMM_PATTERNS(KATANA_IMM_SCAN_CASE)
#undef KATANA_IMM_SCAN_CASE
  return (int)cudaErrorInvalidValue;
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
