// katana_bank_scan: the single-model bank filter on Hopper, a whole
// replay stream per launch.
//
// Replaces repro/kernels/katana_bank/kernel.py:katana_bank_scan_step
// (body make_scan_kernel: a fori_loop over T with x/P resident in VMEM).
// An optional valid stream (T, N) makes a False frame keep the
// prediction, by the reference's mul/add select v*x' + (1-v)*x^: the K=1
// IMM replay runs this kernel.
//
// What bounds it: the scan moves (m + n)*4 bytes per track-frame (plus x/P
// once): 0.436 ms (lkf) / 0.586 ms (ekf) at N = 131,072, T = 300, over
// 3.35 TB/s. Its pruned op stream is ~0.4 k (CV6) / ~0.9 k (CTRA-8)
// float32 operations per track-frame; built with --fmad=false every one
// is an instruction of its own, so the issue rate (one warp instruction a
// cycle per SM quarter) sets a floor of the same order as the bytes.
//
// Design: one thread per track, Tile tracks a block (64, 128 or 256: a
// launch choice, ops.LANE_TILES, the tile table's; the bits do not depend
// on it). Per frame a
// thread runs pruned.cuh's step_lane on the model's compile-time Pattern
// (cv6, ctra8, imm9 or a dense one: ops.pick_pattern): the plain
// version's op stream, F's and Q's zeros skipped, the code of the
// per-frame step katana_bank (imm_step.cu), so T katana_bank calls give
// this scan's final state by construction. The state stays in registers
// across the frames: x and P's upper triangle (n(n+1)/2 floats; P is
// mirrored after every update). A seed P that is not symmetric to the
// bit is read whole by first_frame, a launch of its own ahead of the
// scan, which runs frame 0 for that lane's block (a second copy of the
// step for frame 0 in the scan kernel, inlined or called, cost the time
// loop registers: 24-76 bytes of spill for lkf, 112 for ekf, 3-8% of the
// scan's time on an H100; a per-lane branch around frame 0, 3%). Which
// lanes share a block, and so run frame 0 ahead, changes with the tile;
// a symmetric lane's bits do not (its P read whole or as the triangle
// are the same floats). F, Q and R are the launch's parameters
// (ModelTable), read from the constant bank where they are used, so none
// holds a register. Launch bounds cap the registers so that the lkf
// scan's 1,024 blocks of 128 fit one wave of 8 blocks an SM on 132 SMs;
// the cap is the same at every tile (scan_min_blocks).
// Sym = false (symmetrize=False, the rewrite stages' default) carries the
// whole n x n P in registers instead, computes every entry of the predict
// and the update (the reference's full square) and reads the seed whole
// in the loop, so it needs no first_frame; its cap allows more registers
// (6 / 4 blocks an SM for n <= 6 / n = 8) for the n(n-1)/2 more floats.
// Memory: the block's z of frame t + 1 (one contiguous span of zs (T, N,
// m)) comes into shared memory with cp.async while frame t computes
// (double-buffered); each thread writes its x of frame t into a shared
// span, which the block stores during frame t + 1 with 16-byte stores
// (also double-buffered): one barrier a frame. Layouts are canonical,
// zs (T, N, m) and xs (T, N, n).
//
// Built with --fmad=false: the plain PyTorch version (ref.py) and this
// code then round identically.

#include <string.h>
#include <type_traits>

#include "pruned.cuh"

namespace katana {

// the instantiated tiles (tracks a block); ops.LANE_TILES mirrors them
#define KATANA_SCAN_TILES(X) X(64) X(128) X(256)

// resident blocks of Tile threads an SM: the register cap 65,536 /
// (Tile * blocks) of blocks of 128 scaled to the tile, so every tile gets
// the cap of 128 (64 cv6 / 96 n >= 8 with Sym; 80 / 128 without). At 256
// the 5 blocks of 128 of n >= 8 with Sym round down to 2 (a cap of 128).
template <int N, bool Sym, int Tile>
constexpr int scan_min_blocks() {
  constexpr int at128 = Sym ? (N <= 6 ? 8 : 5) : (N <= 6 ? 6 : 4);
  return at128 * 128 / Tile > 0 ? at128 * 128 / Tile : 1;
}

struct ScanArgs {
  int Ntr, T;
  const float* x;
  const float* P;
  const float* zs;
  const uint8_t* vs;
  float dt;
  float* xs;
  float* x_fin;
  float* P_fin;
  uint8_t* first;  // a block's frame 0 done by first_frame
};

// Frame 0 of every lane of a block in which some lane's seed P is not
// symmetric to the bit, ahead of bank_scan (whose time loop reads P's
// upper triangle): step_lane with P read whole, the valid select, x into
// xs[0], x and P (mirrored) into x_fin and P_fin, where bank_scan takes
// them up, and the block's mark in `first`, so that bank_scan starts
// that block at frame 1. The blocks of bank_scan; its own launch, so
// bank_scan's loop holds one copy of the step and no per-lane branch.
template <class Pat, bool NL, bool VS, int Tile>
__global__ void __launch_bounds__(Tile)
first_frame(const __grid_constant__ ScanArgs a,
            const __grid_constant__ ModelTable<Pat::N, Pat::M> tab) {
  constexpr int N = Pat::N, M = Pat::M, NN = N * N;
  const int c = blockIdx.x * Tile + threadIdx.x;
  const bool live = c < a.Ntr;
  float Pv[NN];
  bool sym = true;
  if (live) {
    load_vec<NN>(a.P + (size_t)c * NN, Pv);
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int q = r + 1; q < N; ++q)
        sym = sym && __float_as_uint(Pv[r * N + q]) ==
                         __float_as_uint(Pv[q * N + r]);
  }
  const bool any = __syncthreads_or(!sym) != 0;
  if (threadIdx.x == 0) a.first[blockIdx.x] = any ? 1 : 0;
  if (!any || !live) return;
  float xv[N], zv[M], xp[N], Pp[N][N], xn[N], Pn[N][N], S[M][M], Si[M][M],
      y[M];
  load_vec<N>(a.x + (size_t)c * N, xv);
#pragma unroll
  for (int r = 0; r < M; ++r) zv[r] = __ldg(a.zs + (size_t)c * M + r);
  step_lane<Pat>(tab, NL, a.dt, xv,
                 [&](int r, int q) { return Pv[r * N + q]; }, zv, xp, Pp, xn,
                 Pn, S, Si, y);
  const float v = VS ? (a.vs[c] ? 1.0f : 0.0f) : 1.0f;
  const float nv = 1.0f - v;
#pragma unroll
  for (int i = 0; i < N; ++i) xv[i] = VS ? v * xn[i] + nv * xp[i] : xn[i];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i; j < N; ++j) {
      const float u = VS ? v * Pn[i][j] + nv * Pp[i][j] : Pn[i][j];
      Pv[i * N + j] = u;
      Pv[j * N + i] = u;
    }
  store_vec<N>(a.xs + (size_t)c * N, xv);
  store_vec<N>(a.x_fin + (size_t)c * N, xv);
  store_vec<NN>(a.P_fin + (size_t)c * NN, Pv);
}

// NL: the CTRA-8 dynamics; VS: a valid stream; Sym: P's upper triangle
// (symmetrize=True) or the whole square.
template <class Pat, bool NL, bool VS, bool Sym, int Tile>
__global__ void __launch_bounds__(Tile, scan_min_blocks<Pat::N, Sym, Tile>())
bank_scan(const __grid_constant__ ScanArgs a,
          const __grid_constant__ ModelTable<Pat::N, Pat::M> tab) {
  constexpr int N = Pat::N, M = Pat::M, NN = N * N, NT = N * (N + 1) / 2;
  // P[r][q]'s slot of the carried state
  auto at = [](int r, int q) {
    if constexpr (Sym) return r <= q ? tri<N>(r, q) : tri<N>(q, r);
    return r * N + q;
  };
  __shared__ __align__(16) float zb[2][Tile * M];
  __shared__ __align__(16) float xb[2][Tile * N];
  const int Ntr = a.Ntr, T = a.T, tid = threadIdx.x;
  const int c0 = blockIdx.x * Tile;
  const int nc = min(Tile, Ntr - c0);
  // threads past the last track compute on a copy of it and store
  // nothing: every thread must reach the block's barriers
  const int slot = min(tid, nc - 1);
  const size_t c = (size_t)c0 + slot;
  auto stage_z = [&](int t) {
    stage_in(zb[t & 1], a.zs + ((size_t)t * Ntr + c0) * M, nc * M, tid,
             Tile);
  };
  auto store_xs = [&](int t) {
    stage_out(a.xs + ((size_t)t * Ntr + c0) * N, xb[t & 1], nc * N, tid,
              Tile);
  };

  // the seed: x and P's upper triangle, which is all of P (a block with a
  // lane whose seed P is not symmetric to the bit had frame 0 from
  // first_frame: it starts at frame 1 from x_fin and P_fin); without Sym
  // x and the whole P
  const int t0 = Sym ? a.first[blockIdx.x] : 0;
  float xv[N], Pt[Sym ? NT : NN];
  if (t0 < T) stage_z(t0);
  bool valid = VS && t0 < T ? a.vs[(size_t)t0 * Ntr + c] != 0 : true;
  {
    const float* x0 = (t0 ? a.x_fin : a.x) + c * N;
    const float* P0 = (t0 ? a.P_fin : a.P) + c * NN;
    load_vec<N>(x0, xv);
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int q = Sym ? r : 0; q < N; ++q) Pt[at(r, q)] = P0[r * N + q];
  }

  // frame t: its z staged, the next frame's z and the last frame's xs on
  // their way, one predict+update on P's triangle, the valid select, x
  // into the xs span
  for (int t = t0; t < T; ++t) {
    stage_wait();
    __syncthreads();
    if (t + 1 < T) stage_z(t + 1);
    if (t > t0) store_xs(t - 1);
    float z[M];
#pragma unroll
    for (int r = 0; r < M; ++r) z[r] = zb[t & 1][slot * M + r];
    float xp[N], Pp[N][N], xn[N], Pn[N][N], S[M][M], Si[M][M], y[M];
    step_lane<Pat, Sym>(tab, NL, a.dt, xv,
                        [&](int r, int q) { return Pt[at(r, q)]; }, z, xp,
                        Pp, xn, Pn, S, Si, y);
    if constexpr (VS) {
      const float v = valid ? 1.0f : 0.0f;
      if (t + 1 < T) valid = a.vs[(size_t)(t + 1) * Ntr + c] != 0;
      const float nv = 1.0f - v;
#pragma unroll
      for (int i = 0; i < N; ++i) xv[i] = v * xn[i] + nv * xp[i];
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = Sym ? i : 0; j < N; ++j)
          Pt[at(i, j)] = v * Pn[i][j] + nv * Pp[i][j];
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) xv[i] = xn[i];
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = Sym ? i : 0; j < N; ++j) Pt[at(i, j)] = Pn[i][j];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) xb[t & 1][tid * N + i] = xv[i];
  }
  __syncthreads();
  if (t0 < T) store_xs(T - 1);
  if (tid >= nc) return;
  float Pf[NN];
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int q = 0; q < N; ++q) Pf[r * N + q] = Pt[at(r, q)];
  store_vec<N>(a.x_fin + c * N, xv);
  store_vec<NN>(a.P_fin + c * NN, Pf);
}

// The scan of an instantiated Pattern at `Tile` tracks a block:
// first_frame, then bank_scan (sym), or bank_scan alone (the full square);
// `consts` is the model's F, Q, R in host memory, copied into the
// launches' parameters. A nonlinear model is the CTRA-8 (N = 8) only.
template <class Pat, int Tile>
cudaError_t launch_scan(const ScanArgs& a, const void* consts, int nonlinear,
                        int sym, cudaStream_t s) {
  ModelTable<Pat::N, Pat::M> tab;
  memcpy(&tab, consts, sizeof tab);
  const int blocks = (a.Ntr + Tile - 1) / Tile;
  auto run = [&](auto nl, auto vs) {
    constexpr bool NL = decltype(nl)::value, VS = decltype(vs)::value;
    if (!sym) {
      bank_scan<Pat, NL, VS, false, Tile><<<blocks, Tile, 0, s>>>(a, tab);
      return cudaGetLastError();
    }
    first_frame<Pat, NL, VS, Tile><<<blocks, Tile, 0, s>>>(a, tab);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    bank_scan<Pat, NL, VS, true, Tile><<<blocks, Tile, 0, s>>>(a, tab);
    return cudaGetLastError();
  };
  auto with_vs = [&](auto nl) {
    return a.vs != nullptr ? run(nl, std::true_type{})
                           : run(nl, std::false_type{});
  };
  if constexpr (Pat::N == 8) {
    if (nonlinear) return with_vs(std::true_type{});
  }
  if (nonlinear) return cudaErrorInvalidValue;
  return with_vs(std::false_type{});
}

// One tile's scan of every instantiated Pattern (cudaErrorInvalidValue
// for another pattern or shape, without launching).
template <int Tile>
int scan_tile(int pattern, int n, int m, const ScanArgs& a,
              const void* consts, int nonlinear, int sym, cudaStream_t s) {
#define KATANA_SCAN_CASE(id, name, n_, m_, ...)                              \
  if (pattern == id && n == n_ && m == m_)                                  \
    return (int)launch_scan<name, Tile>(a, consts, nonlinear, sym, s);
  KATANA_IMM_PATTERNS(KATANA_SCAN_CASE)
#undef KATANA_SCAN_CASE
  return (int)cudaErrorInvalidValue;
}

// The build compiles this source in parts (kernels/build.py PARTS,
// -DKATANA_PART=i): part i defines scan_at_tile for the tile
// KATANA_SCAN_TILES lists i-th, part 0 also the C entry, which reaches the
// others' through these declarations; built whole it holds them all.
#define KATANA_SCAN_AT_TILE(t)                                               \
  int scan_at_tile(std::integral_constant<int, t>, int pattern, int n,      \
                   int m, const ScanArgs& a, const void* consts,            \
                   int nonlinear, int sym, cudaStream_t s)
#define KATANA_SCAN_DECLARE(t) KATANA_SCAN_AT_TILE(t);
KATANA_SCAN_TILES(KATANA_SCAN_DECLARE)
#undef KATANA_SCAN_DECLARE
#define KATANA_SCAN_DEFINE(t)                                                \
  KATANA_SCAN_AT_TILE(t) {                                                  \
    return scan_tile<t>(pattern, n, m, a, consts, nonlinear, sym, s);       \
  }
#define KATANA_SCAN_ELEM(t) t,
constexpr int kScanTiles[] = {KATANA_SCAN_TILES(KATANA_SCAN_ELEM)};
#undef KATANA_SCAN_ELEM
#ifdef KATANA_PART
KATANA_SCAN_DEFINE(kScanTiles[KATANA_PART])
#else
KATANA_SCAN_TILES(KATANA_SCAN_DEFINE)
#endif
#undef KATANA_SCAN_DEFINE

}  // namespace katana

#if !defined(KATANA_PART) || KATANA_PART == 0
extern "C" {

// The whole stream of T >= 1 frames for Ntr >= 1 tracks: first_frame,
// then bank_scan. `pattern` is the id of an instantiated Pattern of shape
// (n, m) (pruned.cuh, KATANA_IMM_PATTERNS); any other combination returns
// cudaErrorInvalidValue without launching, and so does a `tile` (tracks
// a block) outside KATANA_SCAN_TILES. `consts` is the model's F, Q, R in
// HOST memory (ops._host_consts). vs may be null (every frame valid).
// `first` holds a byte of scratch a block (read only with sym). sym: 1 for
// symmetrize=True, 0 for the full square.
int katana_bank_scan_run(int n, int m, int pattern, int Ntr, int T,
                         const void* x, const void* P, const void* zs,
                         const void* vs, const void* consts, int nonlinear,
                         float dt, void* xs, void* x_fin, void* P_fin,
                         void* first, int sym, int tile, void* stream) {
  using namespace katana;
  if (Ntr < 1 || T < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const ScanArgs a{Ntr, T, (const float*)x, (const float*)P,
                   (const float*)zs, (const uint8_t*)vs, dt, (float*)xs,
                   (float*)x_fin, (float*)P_fin, (uint8_t*)first};
#define KATANA_SCAN_TILE(t)                                                  \
  if (tile == t)                                                            \
    return scan_at_tile(std::integral_constant<int, t>{}, pattern, n, m, a, \
                        consts, nonlinear, sym, s);
  KATANA_SCAN_TILES(KATANA_SCAN_TILE)
#undef KATANA_SCAN_TILE
  return (int)cudaErrorInvalidValue;
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
#endif
