// katana_bank_imm / katana_bank / katana_bank_soa: one bank step on Hopper.
//
// Replaces repro/kernels/katana_bank/kernel.py:katana_bank_imm_step (body
// make_imm_kernel / make_imm_step_fn) and kernel.py:katana_bank_step (body
// make_kernel). Each of the K*N (model, track) lanes, model-major, takes
// one predict+update of its model with its track's measurement; the IMM
// step also emits the measurement log-likelihood from the same S^-1. The
// per-frame IMM loop (ops.imm_bank_sequence) runs it once per frame
// between the mixing and the mode posterior; katana_bank and
// katana_bank_soa are the same step with K = 1 and no log-likelihood.
//
// What bounds it: (n + n^2)*4 bytes per lane in and again out, against
// ~0.3-1 k float32 operations per lane: the bytes, at any N (K=4, n=9,
// N=131,072: 377 MB, 0.114 ms at 3.35 TB/s; K=1 CV6: 45.6 MB, 0.0136 ms).
//
// Design: one thread per lane, Tile lanes a block (64, 128 or 256: a
// launch choice, ops.LANE_TILES, the tile table's; a lane's bits do not
// depend on it). In the canonical layout the block's lanes of x and P are
// one contiguous span of device memory (41 KB of P at n=9, 18 KB at n=6
// for 128 lanes): the block stages both spans into dynamic shared memory
// (92 KB a block of 256 at n=9, past the 48 KB a launch gets without
// cudaFuncSetAttribute) with coalesced copies, each thread computes its lane
// from there, writes x' and P' over its own slots, and the block stores
// both spans back. A lane's slots sit at an odd stride in shared memory,
// so a warp's reads of one entry fall in 32 different banks: an odd width
// (n = 9, n^2 = 81) is copied flat with 16-byte cp.async and float4
// stores; an even one (x of 6 or 8, P of 36 or 64) is padded by one and
// copied with 4-byte cp.async and 4-byte stores (on an H100, 16-byte
// cp.async into rows padded to an odd count of float4 took the same time,
// synchronous 4-byte copies 1.15-1.3 times as long). The struct-of-arrays
// layout (katana_bank_soa: x (n, N), P (n, n, N), z (m, N)) is coalesced
// as it lies: a thread reads and writes its lane in place, no staging,
// at either Sym.
// Lane l's model is l / N: F, Q, R are that model's rows of the float32
// constant table (ops._consts), read where they are used. A lane runs
// pruned.cuh's step_lane, which the replay scan (scan.cu) runs too, on
// the compile-time Pattern of the model set: the plain version's op
// stream, F's shared zeros skipped (cv6 for the CV6
// LKF, ctra8 for the CTRA-8 EKF, imm9 for make_imm()). K = 1 also serves
// a nonlinear member (the CTRA-8 EKF): its Jacobian is built at the lane's
// state and pruned by the same Pattern. Layouts are canonical: x (K, N, n),
// P (K, N, n, n), z (N, m), loglik (K, N). P is read whole (the mixed P
// need not be symmetric to the bit). Sym (symmetrize=True, the default):
// P' is the upper triangle, mirrored; otherwise every entry of F P F^T + Q
// and of the update is computed (the reference's full square), so an
// asymmetric P stays asymmetric, at n(n-1)/2 more dot products a lane.
//
// Built with --fmad=false: the plain PyTorch version (ref.py) and this
// code then round identically.

#include <type_traits>

#include "pruned.cuh"

namespace katana {

// the instantiated tiles (lanes a block); ops.LANE_TILES mirrors them
#define KATANA_STEP_TILES(X) X(64) X(128) X(256)

// floats of shared memory a block of Tile lanes stages: x at the odd
// stride N | 1, then P at NN | 1 (Tile * (N | 1) floats: a multiple of 16
// bytes, so P's span starts 16-byte aligned)
template <int N, int Tile>
__host__ __device__ constexpr int step_smem_floats() {
  return Tile * ((N | 1) + ((N * N) | 1));
}

// Lanes' rows of width W, contiguous in device memory, into shared memory
// at the odd stride W | 1 (and back out), by the block's Tile threads.
template <int W, int Tile>
__device__ __forceinline__ void lanes_in(float* s, const float* g, int nl,
                                         int tid) {
  if constexpr (W % 2 == 1) {
    stage_in(s, g, nl * W, tid, Tile);
  } else {
    for (int e = tid; e < nl * W; e += Tile) {
      const uint32_t dst = static_cast<uint32_t>(
          __cvta_generic_to_shared(s + (e / W) * (W | 1) + e % W));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
                   "l"(g + e)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
}

template <int W, int Tile>
__device__ __forceinline__ void lanes_out(float* g, const float* s, int nl,
                                          int tid) {
  if constexpr (W % 2 == 1) {
    stage_out(g, s, nl * W, tid, Tile);
  } else {
    for (int e = tid; e < nl * W; e += Tile)
      g[e] = s[(e / W) * (W | 1) + e % W];
  }
}

// Canonical layout, staged through shared memory; LL: write the
// log-likelihood (the IMM step) or not (katana_bank).
template <class Pat, bool LL, bool Sym, int Tile>
__global__ void __launch_bounds__(Tile)
imm_step(int Ntr, int K, const float* __restrict__ x,
         const float* __restrict__ P, const float* __restrict__ z,
         const float* __restrict__ consts, int nonlinear, float dt,
         float log2pi_m, float* __restrict__ x_out,
         float* __restrict__ P_out, float* __restrict__ ll) {
  constexpr int N = Pat::N, M = Pat::M, NN = N * N;
  constexpr int SX = N | 1, SP = NN | 1;
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;
  float* sP = smem + Tile * SX;
  const int tid = threadIdx.x;
  const int l0 = blockIdx.x * Tile;
  const int nl = min(Tile, K * Ntr - l0);
  lanes_in<N, Tile>(sx, x + (size_t)l0 * N, nl, tid);
  lanes_in<NN, Tile>(sP, P + (size_t)l0 * NN, nl, tid);
  stage_wait();
  __syncthreads();

  if (tid < nl) {
    const int l = l0 + tid;
    const int k = l / Ntr;
    const int c = l - k * Ntr;
    float* xl = sx + tid * SX;
    float* Pl = sP + tid * SP;
    auto Pa = [&](int r, int q) { return Pl[r * N + q]; };
    float xv[N], zv[M], xp[N], Pp[N][N], S[M][M], Si[M][M], y[M], xn[N],
        Pn[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) xv[i] = xl[i];
#pragma unroll
    for (int r = 0; r < M; ++r) zv[r] = z[(size_t)c * M + r];
    step_lane<Pat, Sym>(ConstsIn<N, M>{consts + k * model_stride<N, M>()},
                        nonlinear != 0, dt, xv, Pa, zv, xp, Pp, xn, Pn, S, Si,
                        y);
    if constexpr (LL) ll[l] = gaussian_loglik<M>(S, Si, y, log2pi_m);
#pragma unroll
    for (int i = 0; i < N; ++i) xl[i] = xn[i];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) Pl[i * N + j] = Pn[i][j];
  }
  __syncthreads();
  lanes_out<N, Tile>(x_out + (size_t)l0 * N, sx, nl, tid);
  lanes_out<NN, Tile>(P_out + (size_t)l0 * NN, sP, nl, tid);
}

// Struct-of-arrays layout, one model: element e of lane c at e * Ntr + c.
template <class Pat, bool Sym, int Tile>
__global__ void __launch_bounds__(Tile)
bank_step_soa(int Ntr, const float* __restrict__ x,
              const float* __restrict__ P, const float* __restrict__ z,
              const float* __restrict__ consts, int nonlinear, float dt,
              float* __restrict__ x_out, float* __restrict__ P_out) {
  constexpr int N = Pat::N, M = Pat::M;
  const int c = blockIdx.x * Tile + threadIdx.x;
  if (c >= Ntr) return;
  auto at = [&](int e) { return (size_t)e * Ntr + c; };
  auto Pa = [&](int r, int q) { return P[at(r * N + q)]; };
  float xv[N], zv[M], xp[N], Pp[N][N], S[M][M], Si[M][M], y[M], xn[N],
      Pn[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) xv[i] = x[at(i)];
#pragma unroll
  for (int r = 0; r < M; ++r) zv[r] = z[at(r)];
  step_lane<Pat, Sym>(ConstsIn<N, M>{consts}, nonlinear != 0, dt, xv, Pa,
                      zv, xp, Pp, xn, Pn, S, Si, y);
#pragma unroll
  for (int i = 0; i < N; ++i) x_out[at(i)] = xn[i];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) P_out[at(i * N + j)] = Pn[i][j];
}

// One launch of imm_step<Pat, LL, Sym, Tile> with its dynamic shared
// memory; the first launch of an instantiation that needs more than 48 KB
// raises its limit.
template <class Pat, bool LL, bool Sym, int Tile>
cudaError_t launch_lanes(int K, int Ntr, const void* x, const void* P,
                         const void* z, const void* consts, int nonlinear,
                         float dt, float log2pi_m, void* x_out, void* P_out,
                         void* ll, cudaStream_t s) {
  constexpr size_t bytes = step_smem_floats<Pat::N, Tile>() * sizeof(float);
  if constexpr (bytes > 48 * 1024) {
    static const cudaError_t set = cudaFuncSetAttribute(
        imm_step<Pat, LL, Sym, Tile>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (set != cudaSuccess) return set;
  }
  const int blocks = (K * Ntr + Tile - 1) / Tile;
  imm_step<Pat, LL, Sym, Tile><<<blocks, Tile, bytes, s>>>(
      Ntr, K, (const float*)x, (const float*)P, (const float*)z,
      (const float*)consts, nonlinear, dt, log2pi_m, (float*)x_out,
      (float*)P_out, (float*)ll);
  return cudaGetLastError();
}

template <class Pat, bool Sym, int Tile>
cudaError_t launch_step(int K, int Ntr, const void* x, const void* P,
                        const void* z, const void* consts, int nonlinear,
                        float dt, float log2pi_m, void* x_out, void* P_out,
                        void* ll, cudaStream_t s) {
  return ll != nullptr
             ? launch_lanes<Pat, true, Sym, Tile>(K, Ntr, x, P, z, consts,
                                                  nonlinear, dt, log2pi_m,
                                                  x_out, P_out, ll, s)
             : launch_lanes<Pat, false, Sym, Tile>(K, Ntr, x, P, z, consts,
                                                   nonlinear, dt, log2pi_m,
                                                   x_out, P_out, nullptr, s);
}

template <class Pat, bool Sym, int Tile>
cudaError_t launch_soa(int Ntr, const void* x, const void* P, const void* z,
                       const void* consts, int nonlinear, float dt,
                       void* x_out, void* P_out, cudaStream_t s) {
  bank_step_soa<Pat, Sym, Tile><<<(Ntr + Tile - 1) / Tile, Tile, 0, s>>>(
      Ntr, (const float*)x, (const float*)P, (const float*)z,
      (const float*)consts, nonlinear, dt, (float*)x_out, (float*)P_out);
  return cudaGetLastError();
}

// A call of either entry: the canonical layout (soa false) or the
// struct-of-arrays one (K = 1, no log-likelihood).
struct StepCall {
  int K, Ntr;
  const void* x;
  const void* P;
  const void* z;
  const void* consts;
  int nonlinear;
  float dt, log2pi_m;
  void* x_out;
  void* P_out;
  void* ll;
  bool soa;
  cudaStream_t s;
};

// One tile's step of every instantiated Pattern at either sym
// (cudaErrorInvalidValue for another pattern or shape, without launching).
template <int Tile>
int step_tile(int n, int m, int pattern, int sym, const StepCall& c) {
  auto run = [&](auto pat, auto sy) -> int {
    using Pat = decltype(pat);
    constexpr bool Sym = decltype(sy)::value;
    if (c.soa)
      return (int)launch_soa<Pat, Sym, Tile>(c.Ntr, c.x, c.P, c.z, c.consts,
                                             c.nonlinear, c.dt, c.x_out,
                                             c.P_out, c.s);
    return (int)launch_step<Pat, Sym, Tile>(c.K, c.Ntr, c.x, c.P, c.z,
                                            c.consts, c.nonlinear, c.dt,
                                            c.log2pi_m, c.x_out, c.P_out,
                                            c.ll, c.s);
  };
#define KATANA_IMM_STEP_CASE(id, name, n_, m_, ...)                          \
  if (pattern == id && n == n_ && m == m_)                                  \
    return sym ? run(name{}, std::true_type{}) : run(name{}, std::false_type{});
  KATANA_IMM_PATTERNS(KATANA_IMM_STEP_CASE)
#undef KATANA_IMM_STEP_CASE
  return (int)cudaErrorInvalidValue;
}

// The build compiles this source in parts (kernels/build.py PARTS,
// -DKATANA_PART=i): part i defines step_at_tile for the tile
// KATANA_STEP_TILES lists i-th, part 0 also the C entries, which reach the
// others' through these declarations; built whole it holds them all.
#define KATANA_STEP_AT_TILE(t)                                               \
  int step_at_tile(std::integral_constant<int, t>, int n, int m,            \
                   int pattern, int sym, const StepCall& c)
#define KATANA_STEP_DECLARE(t) KATANA_STEP_AT_TILE(t);
KATANA_STEP_TILES(KATANA_STEP_DECLARE)
#undef KATANA_STEP_DECLARE
#define KATANA_STEP_DEFINE(t)                                                \
  KATANA_STEP_AT_TILE(t) { return step_tile<t>(n, m, pattern, sym, c); }
#define KATANA_STEP_ELEM(t) t,
constexpr int kStepTiles[] = {KATANA_STEP_TILES(KATANA_STEP_ELEM)};
#undef KATANA_STEP_ELEM
#ifdef KATANA_PART
KATANA_STEP_DEFINE(kStepTiles[KATANA_PART])
#else
KATANA_STEP_TILES(KATANA_STEP_DEFINE)
#endif
#undef KATANA_STEP_DEFINE

}  // namespace katana

#if !defined(KATANA_PART) || KATANA_PART == 0
namespace katana {

int step_by_tile(int tile, int n, int m, int pattern, int sym,
                 const StepCall& c) {
#define KATANA_STEP_TILE(t)                                                  \
  if (tile == t)                                                            \
    return step_at_tile(std::integral_constant<int, t>{}, n, m, pattern, sym, \
                        c);
  KATANA_STEP_TILES(KATANA_STEP_TILE)
#undef KATANA_STEP_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace katana

extern "C" {

// One frame for K models x Ntr tracks, canonical layout. `pattern` is the
// id of an instantiated Pattern of shape (n, m) (pruned.cuh,
// KATANA_IMM_PATTERNS) and `tile` (lanes a block) one of
// KATANA_STEP_TILES; any other combination returns cudaErrorInvalidValue
// without launching. ll null: no log-likelihood (katana_bank, K = 1). sym:
// 1 for symmetrize=True, 0 for the full square.
int katana_imm_step_run(int K, int n, int m, int pattern, int Ntr,
                        const void* x, const void* P, const void* z,
                        const void* consts, int nonlinear, float dt,
                        float log2pi_m, void* x_out, void* P_out, void* ll,
                        int sym, int tile, void* stream) {
  using namespace katana;
  return step_by_tile(tile, n, m, pattern, sym,
                      StepCall{K, Ntr, x, P, z, consts, nonlinear, dt,
                               log2pi_m, x_out, P_out, ll, false,
                               static_cast<cudaStream_t>(stream)});
}

// One frame for Ntr tracks of one model, struct-of-arrays layout: x (n, N),
// P (n, n, N), z (m, N). The patterns, sym and tiles of
// katana_imm_step_run.
int katana_bank_soa_run(int n, int m, int pattern, int Ntr, const void* x,
                        const void* P, const void* z, const void* consts,
                        int nonlinear, float dt, void* x_out, void* P_out,
                        int sym, int tile, void* stream) {
  using namespace katana;
  return step_by_tile(tile, n, m, pattern, sym,
                      StepCall{1, Ntr, x, P, z, consts, nonlinear, dt, 0.0f,
                               x_out, P_out, nullptr, true,
                               static_cast<cudaStream_t>(stream)});
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
#endif
