// katana_bank_scan: the single-model bank filter on Hopper, a whole
// replay stream per launch.
//
// Replaces repro/kernels/katana_bank/kernel.py:katana_bank_scan_step
// (body make_scan_kernel: a fori_loop over T with x/P resident in VMEM).
// The per-frame step of the same filter (kernel.py:katana_bank_step,
// ops.katana_bank / katana_bank_soa) is imm_step.cu's kernel at K = 1 on
// the model's compile-time Pattern (pruned.cuh). This scan keeps
// kalman.cuh's dense loops, which add the terms that pattern prunes:
// adding a product with a zero of F or Q is exact up to the sign of a
// zero, so T step launches still give the scan's final state, equal
// under a float compare (torch.equal).
//
// Design: one thread per track. The scan keeps the track's x (n) and P
// (n x n) in registers for the whole stream; per frame it reads the
// track's z (m floats) and writes its filtered x (n floats). Layouts are
// canonical, zs (T, N, m) and xs (T, N, n): a thread's floats are
// contiguous, so a warp's loads and stores of a frame cover one
// contiguous span of 32*m*4 and 32*n*4 bytes (all sectors used, at a
// stride of m*4 / n*4 bytes per instruction).
// An optional valid stream (T, N) makes a False frame keep the
// prediction, by the reference's mul/add select v*x' + (1-v)*x^: the K=1
// IMM replay runs this kernel.
//
// What bounds it: the scan moves (m + n)*4 bytes per track-frame (plus x/P
// once) and does ~0.5-1.5 k float32 operations per track-frame (the
// operation count of ref.py's pruned op stream; the dense loops here do
// more, on zeros of F). At N = 131,072 both bounds are a fraction of a
// millisecond per 300 frames; the per-thread dependency chain through T
// frames and the register footprint (n^2 carried floats plus the update's
// working set) bound what one SM can overlap: on an H100 the lkf scan
// takes 1.62 ms against its 0.436 ms byte bound. Its redesign is later
// work.
//
// Built with --fmad=false: the plain PyTorch version (ref.py) and this
// code then round identically.

#include "kalman.cuh"

namespace katana {

constexpr int kThreads = 128;

// One predict+update of the track's model.
template <int N, int M>
__device__ __forceinline__ void bank_update_lane(
    const float* __restrict__ consts, bool nonlinear, float dt,
    const float (&x)[N], const float (&P)[N][N], const float (&z)[M],
    float (&xp)[N], float (&Pp)[N][N], float (&xn)[N], float (&Pn)[N][N]) {
  float S[M][M], Si[M][M], y[M];
  predict_lane<N>(consts, consts + N * N, nonlinear, dt, x, P, xp, Pp);
  innovation<N, M>(Pp, consts + 2 * N * N, S, Si);
  kalman_update<N, M>(xp, Pp, Si, z, y, xn, Pn);
}

template <int N, int M>
__global__ void __launch_bounds__(kThreads)
bank_scan(int Ntr, int T, const float* __restrict__ x,
          const float* __restrict__ P, const float* __restrict__ zs,
          const uint8_t* __restrict__ vs, const float* __restrict__ consts,
          int nonlinear, float dt, float* __restrict__ xs,
          float* __restrict__ x_fin, float* __restrict__ P_fin) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Ntr) return;
  float xv[N], Pv[N][N];
  load_lane<N>(x + (size_t)c * N, P + (size_t)c * N * N, xv, Pv);
  for (int t = 0; t < T; ++t) {
    const size_t tc = (size_t)t * Ntr + c;
    float z[M], xp[N], Pp[N][N], xn[N], Pn[N][N];
#pragma unroll
    for (int r = 0; r < M; ++r) z[r] = zs[tc * M + r];
    bank_update_lane<N, M>(consts, nonlinear != 0, dt, xv, Pv, z, xp, Pp, xn,
                           Pn);
    if (vs != nullptr) {
      const float v = vs[tc] ? 1.0f : 0.0f;
      const float nv = 1.0f - v;
#pragma unroll
      for (int i = 0; i < N; ++i) xv[i] = v * xn[i] + nv * xp[i];
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = i; j < N; ++j) {
          const float p = v * Pn[i][j] + nv * Pp[i][j];
          Pv[i][j] = p;
          Pv[j][i] = p;
        }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) xv[i] = xn[i];
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) Pv[i][j] = Pn[i][j];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) xs[tc * N + i] = xv[i];
  }
  store_lane<N>(x_fin + (size_t)c * N, P_fin + (size_t)c * N * N, xv, Pv);
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace katana

extern "C" {

// The whole stream of T frames for Ntr tracks. Shapes (n, m) in
// {(6, 3), (8, 4), (9, 3)}; any other shape returns cudaErrorInvalidValue
// without launching. vs may be null (every frame valid).
int katana_bank_scan_run(int n, int m, int Ntr, int T, const void* x,
                         const void* P, const void* zs, const void* vs,
                         const void* consts, int nonlinear, float dt,
                         void* xs, void* x_fin, void* P_fin, void* stream) {
  using namespace katana;
  auto s = static_cast<cudaStream_t>(stream);
#define KATANA_SCAN_CASE(N_, M_)                                            \
  if (n == N_ && m == M_) {                                                 \
    bank_scan<N_, M_><<<blocks_for(Ntr), kThreads, 0, s>>>(                 \
        Ntr, T, (const float*)x, (const float*)P, (const float*)zs,         \
        (const uint8_t*)vs, (const float*)consts, nonlinear, dt,            \
        (float*)xs, (float*)x_fin, (float*)P_fin);                          \
    return (int)cudaGetLastError();                                         \
  }
  KATANA_SCAN_CASE(6, 3)
  KATANA_SCAN_CASE(8, 4)
  KATANA_SCAN_CASE(9, 3)
#undef KATANA_SCAN_CASE
  return (int)cudaErrorInvalidValue;
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
