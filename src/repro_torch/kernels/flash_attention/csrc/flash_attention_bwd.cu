// flash_attention_bwd: the gradient (dq, dk, dv) of flash_attention, in
// three passes, for the port's FlashAttention on a CUDA tensor.
//
// Replaces src/repro/kernels/flash_attention/ops.py:53 _bwd (the backward
// of the reference's custom_vjp: jnp that recomputes one query block of
// dense float32 scores over every key at a time; no pallas_call).
//
// Layout as the forward (flash_attention.cu): q, dO, dq (B, Sq, H, d);
// k, v, dk, dv (B, Sk, KH, d), KH dividing H, query head h on kv head
// h / (H / KH), read in place (nothing repeated, no (B, Sk, H, d) buffer).
// Scratch: lse and D, float32 (B, H, Sqp), Sqp = Sq rounded up to 128
// (LSE_ROWS); prep writes every row that a later pass reads. d a multiple
// of 8 up to 128; any Sq, Sk; causal or not; an optional window. A key is
// visible from a query as in ref.mask(Sq, Sk, causal, window); every
// query row and every key row gets its gradient, a ragged tail too.
//
// Bound: operations. A visible (query, key) pair needs five products of
// d (S = q.k, dP = dO.v, dV += P dO, dK += dS q, dQ += dS k): 10 d
// operations. At danube's layer (B 1, S 8,192, 32 / 8 heads of 80, window
// 4,096: 8.05e8 visible pairs) that is 6.44e11: 0.65 ms at the 989
// TFLOP/s bf16 tensor-core peak; in float32 each product is three TF32
// products (below), 1.93e12 at the 495 TFLOP/s TF32 peak: 3.9 ms;
// against 42 MB of q, k, v, dO, dq, dk, dv (0.013 ms).
//
// FA2's backward in three passes:
//
//   prep  a block a query tile of one (b, h): each row's log-sum-exp over
//         the visible keys and D = sum_j P_ij dP_ij, from q, k, v and dO
//         (S = Q K^T and dP = dO V^T over the key tiles, online as the
//         forward's softmax). The forward's output is not read, so the
//         backward is the same whichever forward ran.
//   dkdv  a block a key tile of one (b, kv head): for each of the G = H /
//         KH query heads of its group and each query tile that the causal
//         and window conditions leave (kernel.py:39-44 seen from the key
//         side), S^T = K Q^T, dP^T = V dO^T, P^T = exp(S^T - lse), dS^T =
//         P^T o (dP^T - D), dV += P^T dO, dK += dS^T Q.
//   dq    a block a query tile of one (b, h): over the live key tiles, S,
//         dP, dS as above, dQ += dS K; written once.
//
// Why three: fusing dq into dkdv saves the third S and dP, but sums dQ
// over key blocks, by atomics (whose order changes the bits from call to
// call) or through a float32 copy of dq a key block. So S and dP are
// recomputed: 18 d operations a pair (22 d in bf16, below). The three run
// in turn on the caller's stream. Only diagonal, window-edge and ragged
// tiles (edge_tile) apply the element mask; the others run a loop without
// it. Query tiles go out heaviest (last) first, key tiles lightest-key
// (first) first.
//
// bf16 (namespace wg): wgmma with TMA, the forward's shape (its helpers in
// hopper.cuh). Tiles sit in shared memory as boxes of 16 columns (the
// 32-byte swizzle; DP = d rounded up to 16, 32, 64, 80 or 128 columns, the
// tensor map's own d zero-filling the rest and the rows past Sq or Sk)
// and arrive by TMA into a ring of STAGES, completed on full / empty
// mbarriers.
//   - prep and dq: a warpgroup owns 64 query rows, three a block at
//     DP <= 80 and two above; the K and V tiles of 64 keys stream through
//     the ring; S and dP are wgmma m64n64k16, with Q and dO as register A
//     fragments in prep (DP <= 80) and from shared memory in dq; dq's
//     dQ += dS K is wgmma_rs m64nDPk16, dS_hi and dS_lo as A fragments, K
//     read transposed (the forward's PV).
//   - dkdv: two warpgroups of 64 keys; K and V as register A fragments at
//     DP <= 80 (shared memory at 128); the Q and dO tiles of each item
//     and their lse and D (a bulk copy) stream through the ring; S^T and
//     dP^T are wgmma, dV += P^T dO and dK += dS^T Q wgmma_rs with P^T and
//     dS^T as A fragments and dO, Q read transposed. A query tile is 64
//     rows at DP <= 80, 32 at 128, so dK, dV and the rest fit: 238
//     registers at d 80, 198 at 128, no spill.
//   - in a warpgroup the two score products are committed apart: P is
//     formed while dP still runs on the tensor cores, and dS while dV
//     runs (wgmma_wait<1>).
//   - no producer warp: a ninth warp caps every thread at 168 registers
//     (one of the SM's four register files holds three warps), and
//     setmaxnreg did not lift ptxas's allocation (USETMAXREG in the SASS,
//     the consumers still spilling at R165-R171), while dkdv needs ~220.
//     Thread 0 issues the TMA, refilling a stage one iteration after its
//     use, so that it seldom waits for the other warpgroups.
//   - rounding as the plain version states it (ref.py): the scores, the
//     exp (one ex2.approx of s scale log2(e) - lse2, lse kept in base 2),
//     lse and D float32; P enters dV as bf16(P); dS enters dQ and dK as
//     bf16(dS) + bf16(dS - bf16(dS)), two products into the same
//     accumulators, so dq and dk keep float32's accuracy up to their one
//     rounding.
//
// float32 (namespace tf32x3; its products and cp.async staging in
// tf32x3.cuh, which the float32 forward shares) runs on the tensor cores
// by 3xTF32, as the library's float32 attention backward does (CUTLASS's
// OpMultiplyAddFastF32): each operand x enters as big = tf32(x) and small
// = tf32(x - big) (tf32: cvt.rna, ties away from zero, (bits + 0x1000) &
// ~0x1fff), and a b as small.big + big.small + big.big, three mma.sync
// m16n8k8 tf32 into a fresh fragment that is then added to the running
// sum in float32. A TF32 product is exact in float32 and big + small
// carries x to 2^-22, so the dropped small.small and small's rounding
// leave ~2^-21 a term; the fresh fragment keeps the tensor core's own
// (truncating) accumulation to three terms, and every longer sum is a
// float32 add. dK and dV sum a query tile's G heads into a partial that
// joins the totals (in shared memory) when the tile ends, as the plain
// version's blocks do. ref.split_tf32 and flash_attention_bwd_plain repeat
// this arithmetic, so the float32 checks (2e-5 + 1e-4 |x| against the
// plain version and float64) stand as they were; the float64 distance
// stays below the torch-op backward's. mma.sync and not wgmma: TF32 wgmma
// takes only K-major operands from shared memory, and dO, Q and K enter
// dV, dK and dQ MN-major. 8 warps a block: 4 row blocks of 16 of a 64-row
// tile, each pair splitting the keys (prep, dq) or the queries (dkdv) of a
// tile and combining once at the end; tiles in shared memory at a row
// stride of DP + 4 floats (no bank conflict in either fragment's
// pattern), staged by cp.async a tile ahead. P^T and dS^T (dS in dq) stay
// in registers as the next product's A fragments: the accumulator's
// columns 2t, 2t + 1 are taken as k = t, t + 4, and B's rows are read in
// that order. expf, logf as the plain version.
//
// Measured (scripts/flash_bwd_probe.py, NVIDIA H100 80GB HBM3 at 700 W):
// danube's layer bf16 3.72 ms (17.5% of the bound; the mma.sync kernel
// 7.19), float32 33.7 ms (11.6%; the CUDA-core kernel 48.93, SDPA's
// backward 74.3); granite-moe's (1, 4,096, 16 / 8 heads of 64, causal)
// bf16 0.63 ms (1.26), float32 4.56 ms (7.65; SDPA's backward 5.8). dkdv
// on a second stream beside dq was 0.7-1.6% faster in bf16 and no faster
// in float32, and is not done.
//
// A row with no visible key (Sq > Sk + window - 1) gets lse = +inf, D = 0:
// no gradient, as the forward kernel gives it no output.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

// Built in four parts at once (kernels/build.py PARTS; -DKATANA_PART=i
// compiles part i, without it one object holds all): 0 the C entries and
// the float32 kernels at DP 16, 32 and 64, 1 the float32 kernels at DP 80
// and 128, 2 the bf16 kernels at DP 16, 32 and 64, 3 at DP 80 and 128.
#ifdef KATANA_PART
#define FAB_PART(i) (KATANA_PART == (i))
#else
#define FAB_PART(i) 1
#endif

namespace fab {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BK = 64;         // keys a tile of prep and dq
constexpr int LSE_ROWS = 128;  // lse and D rows are padded to a multiple

struct Shape {
  int Sq, Sk, H, KH, d, causal, window;
  int Sqp;  // the row stride of lse and D
  float scale;
};

__device__ __forceinline__ bool visible(const Shape& s, int qpos, int kpos) {
  bool ok = qpos < s.Sq && kpos < s.Sk;
  if (s.causal) ok = ok && kpos <= qpos;
  if (s.window > 0) ok = ok && qpos - kpos < s.window;
  return ok;
}

// the key tiles [*begin, *end) of BK keys that query rows [q0, q0 + rows)
// see (the forward's kv loop, kernel.py:39-44)
__device__ __forceinline__ void key_tiles(const Shape& s, int q0, int rows,
                                          int* begin, int* end) {
  int e = (s.Sk + BK - 1) / BK;
  if (s.causal) e = min(e, (q0 + rows - 1) / BK + 1);
  *begin = s.window > 0 ? max(q0 - s.window + 1, 0) / BK : 0;
  *end = e;
}

// the query tiles of ``rows`` rows that see keys [k0, k0 + keys): causal,
// queries at or after k0; windowed, queries before k0 + keys - 1 + window
__device__ __forceinline__ void query_tiles(const Shape& s, int k0, int keys,
                                            int rows, int* begin, int* end) {
  int e = (s.Sq + rows - 1) / rows;
  if (s.window > 0) e = min(e, (k0 + keys - 2 + s.window) / rows + 1);
  *begin = s.causal ? k0 / rows : 0;
  *end = e;
}

// some pair of query rows [q0, q0 + rows) and keys [k0, k0 + keys) is not
// visible (a diagonal, window-edge or ragged tile: the element mask runs)
__device__ __forceinline__ bool edge_tile(const Shape& s, int q0, int rows,
                                          int k0, int keys) {
  return q0 + rows > s.Sq || k0 + keys > s.Sk ||
         (s.causal && k0 + keys - 1 > q0) ||
         (s.window > 0 && q0 + rows - 1 - k0 >= s.window);
}

// ---------------------------------------------------------------------
// float32: tensor cores by 3xTF32 (mma.sync m16n8k8), cp.async
// ---------------------------------------------------------------------

namespace tf32x3 {

using namespace ::tf32x3;  // the 3xTF32 products and staging (tf32x3.cuh)

constexpr int THREADS = 256;  // 8 warps: 4 row blocks of 16 x 2 halves
constexpr int STAGES = 2;     // cp.async buffers of prep's and dq's K, V
constexpr int HALF = 32;      // keys (prep, dq) or queries (dkdv) a warp

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}

// the offsets of a (b, head) slice
struct Heads {
  long qrs, krs, qoff, koff;
  __device__ Heads(const Shape& s, int b, int h, int kh)
      : qrs((long)s.H * s.d),
        krs((long)s.KH * s.d),
        qoff((long)b * s.Sq * qrs + (long)h * s.d),
        koff((long)b * s.Sk * krs + (long)kh * s.d) {}
};

// prep: a block a 64-row query tile of one (b, h); warp w takes rows
// 16 (w & 3) and the key half 32 (w >> 2) of each key tile, keeps its own
// online (m, l, dD) and hands it to its partner at the end
template <int DP>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_prep(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   float* __restrict__ lse, float* __restrict__ dsum,
                   Shape s) {
  constexpr int LD = ld(DP);
  constexpr size_t T = ROWS * LD;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* os = qs + T;
  float* kv = os + T;  // STAGES x (K, V)
  const int bh = blockIdx.x, b = bh / s.H, h = bh - b * s.H;
  const int kh = h / (s.H / s.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // heaviest first
  const Heads o(s, b, h, kh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * (warp & 3), kc = HALF * (warp >> 2);
  int kt0, kt1;
  key_tiles(s, q0, ROWS, &kt0, &kt1);
  load_tile<DP, THREADS>(qs, q + o.qoff, q0, s.Sq, o.qrs, s.d);
  load_tile<DP, THREADS>(os, dout + o.qoff, q0, s.Sq, o.qrs, s.d);
  if (kt0 < kt1) {
    load_tile<DP, THREADS>(kv, k + o.koff, kt0 * BK, s.Sk, o.krs, s.d);
    load_tile<DP, THREADS>(kv + T, v + o.koff, kt0 * BK, s.Sk, o.krs, s.d);
  }
  cp_commit();

  // per row: the running max of s scale, and this thread's share of
  // l = sum exp(x - m) and of sum exp(x - m) dP over this warp's keys
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0, k0 = kt * BK;
    const float* ks = kv + (i & 1) * 2 * T;
    const float* vs = ks + T;
    if (kt + 1 < kt1) {
      float* nx = kv + ((i + 1) & 1) * 2 * T;
      load_tile<DP, THREADS>(nx, k + o.koff, k0 + BK, s.Sk, o.krs, s.d);
      load_tile<DP, THREADS>(nx + T, v + o.koff, k0 + BK, s.Sk, o.krs, s.d);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float sc[HALF / 8][4], dp[HALF / 8][4];
    scores<DP, HALF>(sc, qs, rw, ks + kc * LD);
    scores<DP, HALF>(dp, os, rw, vs + kc * LD);
    float mx[2] = {NEG_INF, NEG_INF};
    if (edge_tile(s, q0, ROWS, k0, BK)) {
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool ok = visible(s, q0 + rw + g + 8 * r,
                                  k0 + kc + 8 * j + 2 * t + (e & 1));
          sc[j][e] = ok ? sc[j][e] * s.scale : NEG_INF;
          mx[r] = fmaxf(mx[r], sc[j][e]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] *= s.scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      const float alpha = expf(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha;
      dd[r] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = sc[j][e] == NEG_INF ? 0.f : expf(sc[j][e] - m[r]);
        l[r] += p;
        dd[r] += p * dp[j][e];
      }
    __syncthreads();  // this tile's buffers are read
  }
  cp_wait<0>();  // a block that sees no key has Q and dO in flight
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 1);
    dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 2);
  }
  // the second key half's (m, l, dD) to the first's warps, which merge
  float* mg = kv;  // 64 rows x 3, the K / V buffers read by now
  __syncthreads();
  if (kc != 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* x = mg + 3 * (rw + g + 8 * r);
      x[0] = m[r];
      x[1] = l[r];
      x[2] = dd[r];
    }
  }
  __syncthreads();
  if (kc == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* x = mg + 3 * (rw + g + 8 * r);
      const float mn = fmaxf(m[r], x[0]);
      const float a0 = expf(m[r] - mn), a1 = expf(x[0] - mn);
      const float lt = l[r] * a0 + x[1] * a1, dt = dd[r] * a0 + x[2] * a1;
      const int row = q0 + rw + g + 8 * r;
      if (row < s.Sqp) {
        const bool seen = row < s.Sq && lt > 0.f;
        const long i = (long)bh * s.Sqp + row;
        lse[i] = seen ? mn + logf(lt) : INFINITY;
        dsum[i] = seen ? dt / lt : 0.f;
      }
    }
  }
}

// dq: a block a 64-row query tile of one (b, h); warp w takes rows
// 16 (w & 3) and the key half 32 (w >> 2) of each key tile; the second
// half's dQ is added to the first's at the end
template <int DP>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, float* __restrict__ dq,
                 Shape s) {
  constexpr int LD = ld(DP);
  constexpr size_t T = ROWS * LD;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* os = qs + T;
  float* kv = os + T;  // STAGES x (K, V)
  const int bh = blockIdx.x, b = bh / s.H, h = bh - b * s.H;
  const int kh = h / (s.H / s.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // heaviest first
  const Heads o(s, b, h, kh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * (warp & 3), kc = HALF * (warp >> 2);
  int kt0, kt1;
  key_tiles(s, q0, ROWS, &kt0, &kt1);
  load_tile<DP, THREADS>(qs, q + o.qoff, q0, s.Sq, o.qrs, s.d);
  load_tile<DP, THREADS>(os, dout + o.qoff, q0, s.Sq, o.qrs, s.d);
  if (kt0 < kt1) {
    load_tile<DP, THREADS>(kv, k + o.koff, kt0 * BK, s.Sk, o.krs, s.d);
    load_tile<DP, THREADS>(kv + T, v + o.koff, kt0 * BK, s.Sk, o.krs, s.d);
  }
  cp_commit();

  float L[2], D[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long i = (long)bh * s.Sqp + q0 + rw + g + 8 * r;
    L[r] = lse[i];  // rows past Sq: +inf (prep pads)
    D[r] = dsum[i];
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0, k0 = kt * BK;
    const float* ks = kv + (i & 1) * 2 * T;
    const float* vs = ks + T;
    if (kt + 1 < kt1) {
      float* nx = kv + ((i + 1) & 1) * 2 * T;
      load_tile<DP, THREADS>(nx, k + o.koff, k0 + BK, s.Sk, o.krs, s.d);
      load_tile<DP, THREADS>(nx + T, v + o.koff, k0 + BK, s.Sk, o.krs, s.d);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float sc[HALF / 8][4], dp[HALF / 8][4];
    scores<DP, HALF>(sc, qs, rw, ks + kc * LD);
    scores<DP, HALF>(dp, os, rw, vs + kc * LD);
    // dS = P o (dP - D), P = exp(s scale - lse)
    if (edge_tile(s, q0, ROWS, k0, BK)) {
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool ok = visible(s, q0 + rw + g + 8 * r,
                                  k0 + kc + 8 * j + 2 * t + (e & 1));
          const float p = ok ? expf(sc[j][e] * s.scale - L[r]) : 0.f;
          sc[j][e] = p * (dp[j][e] - D[r]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(sc[j][e] * s.scale - L[e >> 1]);
          sc[j][e] = p * (dp[j][e] - D[e >> 1]);
        }
    }
    product<DP, HALF>(acc, sc, ks + kc * LD);  // dQ += dS K
    __syncthreads();  // this tile's buffers are read
  }
  cp_wait<0>();

  // the second key half's dQ to the first's warps, which add and write
  float* red = kv;  // 64 x LD, the K / V buffers read by now
  __syncthreads();
  if (kc != 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        *reinterpret_cast<float2*>(red + (rw + g + 8 * r) * LD + 8 * j +
                                   2 * t) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
  }
  __syncthreads();
  if (kc != 0) return;
  float* out = dq + o.qoff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rw + g + 8 * r;
    if (row >= s.Sq) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < s.d) {
        const float2 x = *reinterpret_cast<const float2*>(
            red + (rw + g + 8 * r) * LD + 8 * j + 2 * t);
        *reinterpret_cast<float2*>(out + row * o.qrs + 8 * j + 2 * t) =
            make_float2((acc[j][2 * r] + x.x) * s.scale,
                        (acc[j][2 * r + 1] + x.y) * s.scale);
      }
  }
}

// the dkdv stages of Q and dO: two below DP 128, where the dK and dV
// totals would not fit beside them
__host__ __device__ constexpr int dkdv_stages(int dp) { return dp > 80 ? 1 : 2; }

// dkdv: a block a 64-key tile of one (b, kv head), K and V resident; for
// each live query tile and each head of the group (an item), warp w takes
// keys 16 (w & 3) and the query half 32 (w >> 2); its dK and dV are a
// partial over one query tile's G heads, added to the totals in shared
// memory when the tile ends, the first half's warps first
template <int DP>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, float* __restrict__ dk,
                   float* __restrict__ dv, Shape s) {
  constexpr int LD = ld(DP), STG = dkdv_stages(DP);
  // queries a product step: 16 at d above 64, so that the float32 dK and
  // dV partials and the steps' fragments fit the registers
  constexpr int QS = DP > 64 ? 16 : HALF;
  constexpr size_t T = ROWS * LD;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + T;
  float* tk = vs + T;              // the dK total (unscaled)
  float* tv = tk + T;              // the dV total
  float* qo = tv + T;              // STG x (Q, dO)
  float* ld_ = qo + STG * 2 * T;   // STG x (lse, D), 64 each
  const int bk = blockIdx.x, b = bk / s.KH, kh = bk - b * s.KH;
  const int G = s.H / s.KH;
  const int k0 = blockIdx.y * ROWS;  // the first (heaviest under causal) first
  const Heads o(s, b, kh * G, kh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * (warp & 3), qc = HALF * (warp >> 2);
  int qt0, qt1;
  query_tiles(s, k0, ROWS, ROWS, &qt0, &qt1);
  const int n = max(qt1 - qt0, 0) * G;  // (query tile, head) items

  // item it: query tile qt0 + it / G of head kh G + it % G into stage st
  auto stage = [&](int it, int st) {
    const int m0 = (qt0 + it / G) * ROWS, h = kh * G + it % G;
    const long qoff = (long)b * s.Sq * o.qrs + (long)h * s.d;
    float* dst = qo + st * 2 * T;
    load_tile<DP, THREADS>(dst, q + qoff, m0, s.Sq, o.qrs, s.d);
    load_tile<DP, THREADS>(dst + T, dout + qoff, m0, s.Sq, o.qrs, s.d);
    if (threadIdx.x < 2 * ROWS) {
      const float* src = threadIdx.x < ROWS ? lse : dsum;
      cp4(ld_ + st * 2 * ROWS + threadIdx.x,
          src + (long)(b * s.H + h) * s.Sqp + m0 + (threadIdx.x & (ROWS - 1)));
    }
  };
  for (int i = threadIdx.x; i < 2 * (int)T; i += THREADS) tk[i] = 0.f;
  load_tile<DP, THREADS>(ks, k + o.koff, k0, s.Sk, o.krs, s.d);
  load_tile<DP, THREADS>(vs, v + o.koff, k0, s.Sk, o.krs, s.d);
  if (STG == 2 && n > 0) stage(0, 0);
  cp_commit();

  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int m0 = (qt0 + it / G) * ROWS, st = STG == 2 ? (it & 1) : 0;
    if (STG == 1) {
      stage(it, 0);
      cp_commit();
      cp_wait<0>();
    } else if (it + 1 < n) {
      stage(it + 1, (it + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* qs = qo + st * 2 * T;
    const float* os = qs + T;
    const float* ls = ld_ + st * 2 * ROWS;
    const float* dl = ls + ROWS;
    const bool edge = edge_tile(s, m0, ROWS, k0, ROWS);
    // S^T and dP^T on this warp's 16 keys x its 32 queries, QS at a time
    // (interior tiles skip the element mask)
#pragma unroll 1
    for (int q1 = qc; q1 < qc + HALF; q1 += QS) {
      float st_[QS / 8][4], dpt[QS / 8][4];
      scores<DP, QS>(st_, ks, rw, qs + q1 * LD);
      scores<DP, QS>(dpt, vs, rw, os + q1 * LD);
      if (edge) {
#pragma unroll
        for (int j = 0; j < QS / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = q1 + 8 * j + 2 * t + (e & 1);
            const float p = visible(s, m0 + c, k0 + rw + g + 8 * (e >> 1))
                                ? expf(st_[j][e] * s.scale - ls[c])
                                : 0.f;
            st_[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - dl[c]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < QS / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = q1 + 8 * j + 2 * t + (e & 1);
            const float p = expf(st_[j][e] * s.scale - ls[c]);
            st_[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - dl[c]);
          }
      }
      product<DP, QS>(dva, st_, os + q1 * LD);  // dV += P^T dO
      product<DP, QS>(dka, dpt, qs + q1 * LD);  // dK += dS^T Q
    }
    if ((it + 1) % G == 0) {
      // the query tile's partial into the totals, the first half first
      for (int half = 0; half < 2; ++half) {
        if (qc == HALF * half) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int j = 0; j < DP / 8; ++j) {
              const int i = (rw + g + 8 * r) * LD + 8 * j + 2 * t;
              float2* xk = reinterpret_cast<float2*>(tk + i);
              float2* xv = reinterpret_cast<float2*>(tv + i);
              *xk = make_float2(xk->x + dka[j][2 * r],
                                xk->y + dka[j][2 * r + 1]);
              *xv = make_float2(xv->x + dva[j][2 * r],
                                xv->y + dva[j][2 * r + 1]);
            }
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
    }
    __syncthreads();  // this item's buffers are read
  }
  cp_wait<0>();  // a block that no query sees has K and V in flight
  __syncthreads();

  float* okb = dk + o.koff;
  float* ovb = dv + o.koff;
  for (int i = threadIdx.x; i < ROWS * (DP / 2); i += THREADS) {
    const int r = i / (DP / 2), c = 2 * (i - r * (DP / 2));
    if (k0 + r >= s.Sk || c >= s.d) continue;
    const long x = (k0 + r) * o.krs + c;
    *reinterpret_cast<float2*>(okb + x) = make_float2(
        tk[r * LD + c] * s.scale, tk[r * LD + c + 1] * s.scale);
    *reinterpret_cast<float2*>(ovb + x) =
        make_float2(tv[r * LD + c], tv[r * LD + c + 1]);
  }
}

template <int DP>
cudaError_t run(int B, const Shape& s, const void* q, const void* k,
                const void* v, const void* dout, void* dq, void* dk, void* dv,
                float* lse, float* dsum, cudaStream_t stream) {
  const size_t smem_q = (2 + 2 * STAGES) * tile_bytes(DP);
  const size_t smem_kv = (4 + 2 * dkdv_stages(DP)) * tile_bytes(DP) +
                         sizeof(float) * dkdv_stages(DP) * 2 * ROWS;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(flash_bwd_prep<DP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_q)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(flash_bwd_dq<DP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_q)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(flash_bwd_dkdv<DP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_kv)) != cudaSuccess)
    return err;
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v, *of = (const float*)dout;
  const dim3 gq(B * s.H, (s.Sq + ROWS - 1) / ROWS);
  const dim3 gk(B * s.KH, (s.Sk + ROWS - 1) / ROWS);
  flash_bwd_prep<DP><<<gq, THREADS, smem_q, stream>>>(qf, kf, vf, of, lse,
                                                       dsum, s);
  flash_bwd_dkdv<DP><<<gk, THREADS, smem_kv, stream>>>(
      qf, kf, vf, of, lse, dsum, (float*)dk, (float*)dv, s);
  flash_bwd_dq<DP><<<gq, THREADS, smem_q, stream>>>(qf, kf, vf, of, lse, dsum,
                                                     (float*)dq, s);
  return cudaGetLastError();
}

}  // namespace tf32x3

// ---------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA, mbarriers
// ---------------------------------------------------------------------

namespace wg {

using namespace ::hopper;

// Thread 0 issues the TMA loads (no producer warp: see the note at the
// top), refilling a stage one iteration after its use.
constexpr int STAGES = 4;  // the ring of streamed tiles
constexpr int DKDV_WGS = 2;
constexpr int BKV = 64 * DKDV_WGS;  // keys a block of dkdv
// dkdv holds K and V in registers (RS) where they fit beside dK and dV
__host__ __device__ constexpr bool dkdv_rs(int dp) { return dp <= 80; }
// warpgroups a block of prep and dq: three where their registers fit 384
// threads (d <= 80), as the forward's
__host__ __device__ constexpr int query_wgs(int dp) { return dp <= 80 ? 3 : 2; }
// queries a tile of dkdv: its float32 dK and dV (DP / 2 registers each)
// and S^T, dP^T (rows / 2 each) fit a thread's registers
__host__ __device__ constexpr int dkdv_rows(int dp) {
  return dp <= 80 ? 64 : 32;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// prep (DQ false: lse and D) and dq (DQ true) on shared device code: a
// block a tile of BQ query rows of one (b, h)
template <int DP, bool DQ>
__device__ __forceinline__ void query_side(
    const CUtensorMap& tmq, const CUtensorMap& tmo, const CUtensorMap& tmk,
    const CUtensorMap& tmv, const bf16* __restrict__ q,
    const bf16* __restrict__ dout, float* __restrict__ lse,
    float* __restrict__ dsum, bf16* __restrict__ dq, const Shape& s) {
  constexpr int NB = DP / 16;  // 16-column boxes of a row
  // prep holds Q and dO in registers as A fragments (its registers allow
  // it at d <= 80): S and dP read only K and V from shared memory
  constexpr bool RS = !DQ && DP <= 80;
  constexpr int CW = 4 * query_wgs(DP), BQ = 64 * query_wgs(DP);
  constexpr int QBOX = BQ * ROWB, KBOX = BK * ROWB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* os = qs + NB * QBOX;
  uint8_t* ks = os + NB * QBOX;           // STAGES x NB boxes
  uint8_t* vs = ks + STAGES * NB * KBOX;  // STAGES x NB boxes
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + STAGES * NB * KBOX);
  const uint32_t full = smem_u32(bars), empty = full + 8 * STAGES,
                 qbar = empty + 8 * STAGES;

  const int bh = blockIdx.x, b = bh / s.H, h = bh - b * s.H;
  const int kh = h / (s.H / s.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  int kt0, kt1;
  key_tiles(s, q0, BQ, &kt0, &kt1);
  const int n_tiles = max(kt1 - kt0, 0);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CW);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // K and V of key tile it into its stage (thread 0; the stage is free)
  auto issue = [&](int it) {
    const int st = it % STAGES, k0 = (kt0 + it) * BK;
    mbar_expect_tx(full + 8 * st, 2 * NB * KBOX);
    for (int j = 0; j < NB; ++j) {
      tma_load(smem_u32(ks + (st * NB + j) * KBOX), &tmk, full + 8 * st,
               16 * j, kh, k0, b);
      tma_load(smem_u32(vs + (st * NB + j) * KBOX), &tmv, full + 8 * st,
               16 * j, kh, k0, b);
    }
  };
  if (tid == 0 && n_tiles > 0) {
    if (!RS) {
      mbar_expect_tx(qbar, 2 * NB * QBOX);
      for (int j = 0; j < NB; ++j) {
        tma_load(smem_u32(qs + j * QBOX), &tmq, qbar, 16 * j, h, q0, b);
        tma_load(smem_u32(os + j * QBOX), &tmo, qbar, 16 * j, h, q0, b);
      }
    }
    for (int it = 0; it < min(STAGES, n_tiles); ++it) issue(it);
  }

  // warpgroup wg owns query rows r0 .. r0 + 63; in the wgmma accumulator
  // layout a thread holds rows ra and ra + 8, columns 8 j + 2 t4 + {0, 1}
  // of each 8-column block j
  const int wgi = warp >> 2, r0 = q0 + 64 * wgi;
  const int t4 = lane & 3, ra = r0 + 16 * (warp & 3) + (lane >> 2);
  const uint32_t qa = smem_u32(qs) + wgi * 64 * ROWB;
  const uint32_t oa = smem_u32(os) + wgi * 64 * ROWB;
  const float sl2 = s.scale * LOG2E;
  float L[2] = {0.f, 0.f}, D[2] = {0.f, 0.f};
  if constexpr (DQ) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra + 8 * r;
      L[r] = row < s.Sq ? lse[(long)bh * s.Sqp + row] : INFINITY;
      D[r] = row < s.Sq ? dsum[(long)bh * s.Sqp + row] : 0.f;
    }
  }
  // prep: per row the running max of s scale log2(e), and this thread's
  // share of l = sum 2^(x - m) and of sum 2^(x - m) dP
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  float acc[DQ ? DP / 2 : 1], sacc[32], pacc[32];
#pragma unroll
  for (int i = 0; i < (DQ ? DP / 2 : 1); ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
  uint32_t hi[4][4], lo[4][4];
  uint32_t aq[RS ? NB : 1][4], ao[RS ? NB : 1][4];
  if constexpr (RS) {
    const long rs = (long)s.H * s.d, off = (long)b * s.Sq * rs + (long)h * s.d;
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      load_frag_a(aq[kk], q + off, ra, s.Sq, rs, s.d, kk);
      load_frag_a(ao[kk], dout + off, ra, s.Sq, rs, s.d, kk);
    }
  }

  if (!RS && n_tiles > 0) mbar_wait(qbar, 0);
  __syncwarp();  // wgmma wants the warp converged
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES, k0 = (kt0 + it) * BK;
    const bool dead = (s.causal && k0 > r0 + 63) ||
                      (s.window > 0 && k0 + BK - 1 < r0 - s.window + 1);
    mbar_wait(full + 8 * st, (it / STAGES) & 1);
    __syncwarp();
    if (!dead) {
      const uint32_t ka = smem_u32(ks + st * NB * KBOX);
      const uint32_t va = smem_u32(vs + st * NB * KBOX);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NB; ++kk) {
        const uint64_t kd = desc_sw32(ka + kk * KBOX, 16, SBO);
        if constexpr (RS)
          wgmma_rs_k(sacc, aq[kk], kd, kk > 0);
        else
          wgmma_ss(sacc, desc_sw32(qa + kk * QBOX, 16, SBO), kd, kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < NB; ++kk) {
        const uint64_t vd = desc_sw32(va + kk * KBOX, 16, SBO);
        if constexpr (RS)
          wgmma_rs_k(pacc, ao[kk], vd, kk > 0);
        else
          wgmma_ss(pacc, desc_sw32(oa + kk * QBOX, 16, SBO), vd, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // S is in; dP still runs while P is formed
      hold(sacc);

      const bool edge = edge_tile(s, r0, 64, k0, BK);
      if constexpr (!DQ) {
        float mx[2] = {NEG_INF, NEG_INF};
        if (edge) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int half = (i >> 1) & 1;
            const bool ok = visible(s, ra + 8 * half,
                                    k0 + 8 * (i >> 2) + 2 * t4 + (i & 1));
            sacc[i] = ok ? sacc[i] * sl2 : NEG_INF;
            mx[half] = fmaxf(mx[half], sacc[i]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            sacc[i] *= sl2;
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float mn = fmaxf(m[r], mx[r]);
          const float alpha = exp2_approx(m[r] - mn);
          m[r] = mn;
          l[r] *= alpha;
          dd[r] *= alpha;
        }
        // a masked score gives 2^(-1e30 - m) = 0 once the row has seen a
        // key; before, 2^0 = 1, which the first seen key's alpha = 0 wipes,
        // and a row that never sees one keeps m = -1e30 (lse = inf below)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int half = (i >> 1) & 1;
          sacc[i] = exp2_approx(sacc[i] - m[half]);
          l[half] += sacc[i];
        }
        wgmma_wait<0>();
        hold(pacc);
#pragma unroll
        for (int i = 0; i < 32; ++i) dd[(i >> 1) & 1] += sacc[i] * pacc[i];
      } else {
        // dS = P o (dP - D), P = 2^(s scale log2(e) - lse2), as the A
        // fragments of the four k16 steps: dS = dS_hi + dS_lo
        if (edge) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int half = (i >> 1) & 1;
            const bool ok = visible(s, ra + 8 * half,
                                    k0 + 8 * (i >> 2) + 2 * t4 + (i & 1));
            sacc[i] = ok ? exp2_approx(sacc[i] * sl2 - L[half]) : 0.f;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            sacc[i] = exp2_approx(sacc[i] * sl2 - L[(i >> 1) & 1]);
        }
        wgmma_wait<0>();
        hold(pacc);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          sacc[i] = sacc[i] * (pacc[i] - D[(i >> 1) & 1]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float x0 = sacc[8 * kk + 2 * r],
                        x1 = sacc[8 * kk + 2 * r + 1];
            hi[kk][r] = pack_bf16(x0, x1);
            const __nv_bfloat162 hv =
                *reinterpret_cast<const __nv_bfloat162*>(&hi[kk][r]);
            lo[kk][r] =
                pack_bf16(x0 - __low2float(hv), x1 - __high2float(hv));
          }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dk = desc_sw32(ka + kk * 16 * ROWB, KBOX, SBO);
          wgmma_rs(acc, hi[kk], dk);
          wgmma_rs(acc, lo[kk], dk);
        }
        wgmma_commit();
        wgmma_wait_all();
        hold(acc);
        hold(hi);
        hold(lo);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
    // the last iteration's stage gets its next tile, once every warp has
    // released it (a stage late: the other warpgroups are seldom waited for)
    if (tid == 0 && it > 0 && it - 1 + STAGES < n_tiles) {
      mbar_wait(empty + 8 * ((it - 1) % STAGES), ((it - 1) / STAGES) & 1);
      issue(it - 1 + STAGES);
    }
  }

  if constexpr (!DQ) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 1);
      dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 2);
      const int row = ra + 8 * r;
      if (t4 == 0 && row < s.Sqp) {
        const bool seen = row < s.Sq && m[r] > NEG_INF;
        const long i = (long)bh * s.Sqp + row;
        lse[i] = seen ? m[r] + log2f(l[r]) : INFINITY;
        dsum[i] = seen ? dd[r] / l[r] : 0.f;
      }
    }
  } else {
    const long rstride = (long)s.H * s.d;
    bf16* ob = dq + (long)b * s.Sq * rstride + (long)h * s.d;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra + 8 * r;
      if (row >= s.Sq) continue;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        if (8 * j < s.d)
          *reinterpret_cast<__nv_bfloat162*>(ob + row * rstride + 8 * j +
                                             2 * t4) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * s.scale,
                                    acc[4 * j + 2 * r + 1] * s.scale);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(128 * query_wgs(DP), 1)
    flash_bwd_prep(const __grid_constant__ CUtensorMap tmq,
                   const __grid_constant__ CUtensorMap tmo,
                   const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv,
                   const bf16* __restrict__ q, const bf16* __restrict__ dout,
                   float* __restrict__ lse, float* __restrict__ dsum,
                   Shape s) {
  query_side<DP, false>(tmq, tmo, tmk, tmv, q, dout, lse, dsum, nullptr, s);
}

template <int DP>
__global__ void __launch_bounds__(128 * query_wgs(DP), 1)
    flash_bwd_dq(const __grid_constant__ CUtensorMap tmq,
                 const __grid_constant__ CUtensorMap tmo,
                 const __grid_constant__ CUtensorMap tmk,
                 const __grid_constant__ CUtensorMap tmv,
                 float* __restrict__ lse, float* __restrict__ dsum,
                 bf16* __restrict__ dq, Shape s) {
  query_side<DP, true>(tmq, tmo, tmk, tmv, nullptr, nullptr, lse, dsum, dq,
                       s);
}

// a block a tile of BKV keys of one (b, kv head); tmq / tmo in boxes of
// dkdv_rows(DP) rows, tmk / tmv of BKV
template <int DP>
__global__ void __launch_bounds__(128 * DKDV_WGS, 1)
    flash_bwd_dkdv(const __grid_constant__ CUtensorMap tmq,
                   const __grid_constant__ CUtensorMap tmo,
                   const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv,
                   const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, Shape s) {
  constexpr int NB = DP / 16, BM = dkdv_rows(DP), CW = 4 * DKDV_WGS;
  // K and V as A fragments in registers where they fit (d <= 80): S^T and
  // dP^T then read only Q and dO from shared memory, and K and V need none
  constexpr bool RS = dkdv_rs(DP);
  constexpr int KVBOX = BKV * ROWB, MBOX = BM * ROWB;
  constexpr int STAGE = 2 * NB * MBOX;  // bytes of a stage's Q and dO
  constexpr int NA = BM / 2;            // S^T accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + (RS ? 0 : NB * KVBOX);
  uint8_t* ring = vs + (RS ? 0 : NB * KVBOX);  // STAGES x (Q, dO NB boxes)
  float* lds = reinterpret_cast<float*>(ring + STAGES * STAGE);  // lse, D
  uint64_t* bars = reinterpret_cast<uint64_t*>(lds + STAGES * 2 * BM);
  const uint32_t full = smem_u32(bars), empty = full + 8 * STAGES,
                 kvbar = empty + 8 * STAGES;

  const int bk = blockIdx.x, b = bk / s.KH, kh = bk - b * s.KH;
  const int G = s.H / s.KH;
  const int k0 = blockIdx.y * BKV;  // the first (heaviest under causal) first
  int qt0, qt1;
  query_tiles(s, k0, BKV, BM, &qt0, &qt1);
  const int n = max(qt1 - qt0, 0) * G;  // (query tile, head) items

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CW);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Q, dO, lse and D of item it into its stage (thread 0; the stage is
  // free)
  auto issue = [&](int it) {
    const int st = it % STAGES, m0 = (qt0 + it / G) * BM;
    const int h = kh * G + it % G;
    const uint32_t bar = full + 8 * st;
    mbar_expect_tx(bar, STAGE + 2 * BM * sizeof(float));
    uint8_t* qd = ring + st * STAGE;
    for (int j = 0; j < NB; ++j) {
      tma_load(smem_u32(qd + j * MBOX), &tmq, bar, 16 * j, h, m0, b);
      tma_load(smem_u32(qd + (NB + j) * MBOX), &tmo, bar, 16 * j, h, m0, b);
    }
    const long row = (long)(b * s.H + h) * s.Sqp + m0;
    float* ld_ = lds + st * 2 * BM;
    bulk_load(smem_u32(ld_), lse + row, BM * sizeof(float), bar);
    bulk_load(smem_u32(ld_ + BM), dsum + row, BM * sizeof(float), bar);
  };
  if (tid == 0 && n > 0) {
    if (!RS) {
      mbar_expect_tx(kvbar, 2 * NB * KVBOX);
      for (int j = 0; j < NB; ++j) {
        tma_load(smem_u32(ks + j * KVBOX), &tmk, kvbar, 16 * j, kh, k0, b);
        tma_load(smem_u32(vs + j * KVBOX), &tmv, kvbar, 16 * j, kh, k0, b);
      }
    }
    for (int it = 0; it < min(STAGES, n); ++it) issue(it);
  }

  // warpgroup wg owns keys kw0 .. kw0 + 63; a thread holds key rows kr,
  // kr + 8 and query columns 8 j + 2 t4 + {0, 1}
  const int wgi = warp >> 2, kw0 = k0 + 64 * wgi;
  const int t4 = lane & 3, kr = kw0 + 16 * (warp & 3) + (lane >> 2);
  const uint32_t ka = smem_u32(ks) + wgi * 64 * ROWB;
  const uint32_t va = smem_u32(vs) + wgi * 64 * ROWB;
  const float sl2 = s.scale * LOG2E;
  float dka[DP / 2], dva[DP / 2], sacc[NA], pacc[NA];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NA; ++i) sacc[i] = pacc[i] = 0.f;
  uint32_t pf[BM / 16][4], hi[BM / 16][4], lo[BM / 16][4];
  uint32_t ak[RS ? NB : 1][4], av[RS ? NB : 1][4];
  if constexpr (RS) {
    const long rs = (long)s.KH * s.d, off = (long)b * s.Sk * rs + (long)kh * s.d;
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      load_frag_a(ak[kk], k + off, kr, s.Sk, rs, s.d, kk);
      load_frag_a(av[kk], v + off, kr, s.Sk, rs, s.d, kk);
    }
  }

  if (!RS && n > 0) mbar_wait(kvbar, 0);
  __syncwarp();
  for (int it = 0; it < n; ++it) {
    const int st = it % STAGES, m0 = (qt0 + it / G) * BM;
    const bool dead = kw0 >= s.Sk || (s.causal && m0 + BM - 1 < kw0) ||
                      (s.window > 0 && m0 >= kw0 + 63 + s.window);
    mbar_wait(full + 8 * st, (it / STAGES) & 1);
    __syncwarp();
    if (!dead) {
      const uint32_t qa = smem_u32(ring + st * STAGE);
      const uint32_t oa = qa + NB * MBOX;
      const float* ls = lds + st * 2 * BM;
      const float* dl = ls + BM;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NB; ++kk) {
        const uint64_t qd = desc_sw32(qa + kk * MBOX, 16, SBO);
        if constexpr (RS)
          wgmma_rs_k(sacc, ak[kk], qd, kk > 0);
        else
          wgmma_ss(sacc, desc_sw32(ka + kk * KVBOX, 16, SBO), qd, kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < NB; ++kk) {
        const uint64_t od = desc_sw32(oa + kk * MBOX, 16, SBO);
        if constexpr (RS)
          wgmma_rs_k(pacc, av[kk], od, kk > 0);
        else
          wgmma_ss(pacc, desc_sw32(va + kk * KVBOX, 16, SBO), od, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // S^T is in; dP^T still runs
      hold(sacc);

      // P^T = 2^(s scale log2(e) - lse2), and dV += P^T dO issued
      const bool edge = edge_tile(s, m0, BM, kw0, 64);
      if (edge) {
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
          const bool ok = visible(s, m0 + c, kr + 8 * ((i >> 1) & 1));
          sacc[i] = ok ? exp2_approx(sacc[i] * sl2 - ls[c]) : 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < NA; ++i)
          sacc[i] = exp2_approx(sacc[i] * sl2 - ls[8 * (i >> 2) + 2 * t4 + (i & 1)]);
      }
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pf[kk][r] = pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        wgmma_rs(dva, pf[kk], desc_sw32(oa + kk * 16 * ROWB, MBOX, SBO));
      wgmma_commit();
      wgmma_wait<1>();  // dP^T is in; dV still runs while dS^T is formed
      hold(pacc);

      // dS^T = P^T o (dP^T - D), and dK += dS^T Q (hi and lo)
#pragma unroll
      for (int i = 0; i < NA; ++i)
        pacc[i] = sacc[i] * (pacc[i] - dl[8 * (i >> 2) + 2 * t4 + (i & 1)]);
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          hi[kk][r] = pack_bf16(pacc[i], pacc[i + 1]);
          const __nv_bfloat162 hv =
              *reinterpret_cast<const __nv_bfloat162*>(&hi[kk][r]);
          lo[kk][r] = pack_bf16(pacc[i] - __low2float(hv),
                                pacc[i + 1] - __high2float(hv));
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        const uint64_t qb = desc_sw32(qa + kk * 16 * ROWB, MBOX, SBO);
        wgmma_rs(dka, hi[kk], qb);
        wgmma_rs(dka, lo[kk], qb);
      }
      wgmma_commit();
      wgmma_wait_all();
      hold(dka);
      hold(dva);
      hold(pf);
      hold(hi);
      hold(lo);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
    // the last iteration's stage gets its next item, once every warp has
    // released it (a stage late: the other warpgroup is seldom waited for)
    if (tid == 0 && it > 0 && it - 1 + STAGES < n) {
      mbar_wait(empty + 8 * ((it - 1) % STAGES), ((it - 1) / STAGES) & 1);
      issue(it - 1 + STAGES);
    }
  }

  const long krs = (long)s.KH * s.d;
  const long koff = (long)b * s.Sk * krs + (long)kh * s.d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kr + 8 * r;
    if (row >= s.Sk) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < s.d) {
        const long o = koff + row * krs + 8 * j + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(dk + o) =
            __floats2bfloat162_rn(dka[4 * j + 2 * r] * s.scale,
                                  dka[4 * j + 2 * r + 1] * s.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + o) =
            __floats2bfloat162_rn(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
  }
}

template <int DP>
cudaError_t run(int B, const Shape& s, const void* q, const void* k,
                const void* v, const void* dout, void* dq, void* dk, void* dv,
                float* lse, float* dsum, cudaStream_t stream) {
  constexpr int NB = DP / 16, BM = dkdv_rows(DP), BQ = 64 * query_wgs(DP);
  cudaError_t err = bind_context(q);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, to, tk, tv, tq2, to2, tk2, tv2;
  if (!tensor_map(&tq, q, B, s.Sq, s.H, s.d, BQ) ||
      !tensor_map(&to, dout, B, s.Sq, s.H, s.d, BQ) ||
      !tensor_map(&tk, k, B, s.Sk, s.KH, s.d, BK) ||
      !tensor_map(&tv, v, B, s.Sk, s.KH, s.d, BK) ||
      !tensor_map(&tq2, q, B, s.Sq, s.H, s.d, BM) ||
      !tensor_map(&to2, dout, B, s.Sq, s.H, s.d, BM) ||
      !tensor_map(&tk2, k, B, s.Sk, s.KH, s.d, BKV) ||
      !tensor_map(&tv2, v, B, s.Sk, s.KH, s.d, BKV))
    return cudaErrorInvalidValue;
  const size_t bars = 8 * (2 * STAGES + 1);
  const size_t smem_q =
      1024 + 2 * NB * BQ * ROWB + 2 * STAGES * NB * BK * ROWB + bars;
  const size_t smem_k = 1024 + (dkdv_rs(DP) ? 0 : 2 * NB * BKV * ROWB) +
                        2 * STAGES * NB * BM * ROWB +
                        STAGES * 2 * BM * sizeof(float) + bars;
  if ((err = cudaFuncSetAttribute(flash_bwd_prep<DP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_q)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(flash_bwd_dq<DP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_q)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(flash_bwd_dkdv<DP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_k)) != cudaSuccess)
    return err;
  const dim3 gq(B * s.H, (s.Sq + BQ - 1) / BQ);
  const dim3 gk(B * s.KH, (s.Sk + BKV - 1) / BKV);
  flash_bwd_prep<DP><<<gq, 2 * BQ, smem_q, stream>>>(
      tq, to, tk, tv, (const bf16*)q, (const bf16*)dout, lse, dsum, s);
  flash_bwd_dkdv<DP><<<gk, 128 * DKDV_WGS, smem_k, stream>>>(
      tq2, to2, tk2, tv2, (const bf16*)k, (const bf16*)v, lse, dsum,
      (bf16*)dk, (bf16*)dv, s);
  flash_bwd_dq<DP><<<gq, 2 * BQ, smem_q, stream>>>(tq, to, tk, tv, lse, dsum,
                                                    (bf16*)dq, s);
  return cudaGetLastError();
}

}  // namespace wg

// d rounded up to 16, 32, 64, 80 or 128: the tiles' width
constexpr int width(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 80 ? 80 : 128;
}

// the kernels of one type (0 float32, 1 bf16) at width dp <= 64 (narrow)
// or above (wide); each defined in its own part
typedef cudaError_t (*Runner)(int B, const Shape& s, const void* q,
                              const void* k, const void* v, const void* dout,
                              void* dq, void* dk, void* dv, float* lse,
                              float* dsum, cudaStream_t stream);
Runner f32_narrow(int dp);
Runner f32_wide(int dp);
Runner bf16_narrow(int dp);
Runner bf16_wide(int dp);

#if FAB_PART(0)
Runner f32_narrow(int dp) {
  return dp == 16 ? tf32x3::run<16> : dp == 32 ? tf32x3::run<32>
                                               : tf32x3::run<64>;
}
#endif
#if FAB_PART(1)
Runner f32_wide(int dp) {
  return dp == 80 ? tf32x3::run<80> : tf32x3::run<128>;
}
#endif
#if FAB_PART(2)
Runner bf16_narrow(int dp) {
  return dp == 16 ? wg::run<16> : dp == 32 ? wg::run<32> : wg::run<64>;
}
#endif
#if FAB_PART(3)
Runner bf16_wide(int dp) { return dp == 80 ? wg::run<80> : wg::run<128>; }
#endif

}  // namespace fab

#if FAB_PART(0)
extern "C" {

// dtype: 0 float32 (3xTF32, mma.sync), 1 bfloat16 (wgmma). window <= 0:
// none. lse, dsum: float32 (B, H, Sqp) scratch, Sqp = Sq rounded up to a
// multiple of 128 (flash_attention_bwd_lse_rows). Three launches on
// ``stream``: prep, dkdv, dq.
int flash_attention_bwd_run(int dtype, int B, int Sq, int Sk, int H, int KH,
                            int d, const void* q, const void* k,
                            const void* v, const void* dout, void* dq,
                            void* dk, void* dv, void* lse, void* dsum,
                            float scale, int causal, int window,
                            void* stream) {
  if (d % 8 || d < 8 || d > 128 || B < 1 || Sq < 1 || Sk < 1 || KH < 1 ||
      H % KH)
    return (int)cudaErrorInvalidValue;
  const int sqp = (Sq + fab::LSE_ROWS - 1) / fab::LSE_ROWS * fab::LSE_ROWS;
  const fab::Shape s{Sq,  Sk, H, KH, d, causal ? 1 : 0, window > 0 ? window : 0,
                     sqp, scale};
  const int dp = fab::width(d);
  const fab::Runner run =
      dtype == 1 ? (dp <= 64 ? fab::bf16_narrow(dp) : fab::bf16_wide(dp))
                 : (dp <= 64 ? fab::f32_narrow(dp) : fab::f32_wide(dp));
  return (int)run(B, s, q, k, v, dout, dq, dk, dv, (float*)lse, (float*)dsum,
                  static_cast<cudaStream_t>(stream));
}

// The row multiple of the lse and D scratch.
int flash_attention_bwd_lse_rows() { return fab::LSE_ROWS; }

// The tiling of a call of this type and head dim: out = {queries a block
// of prep and dq, keys a tile there, threads a block there, keys a block
// of dkdv, queries a tile there, threads a block there, stages of the
// streamed tiles, the instruction (1: wgmma m64nNk16 bf16; 2: mma.sync
// m16n8k8 tf32, three a product)}. Returns the number of values written.
int flash_attention_bwd_config(int dtype, int d, int* out) {
  using namespace fab;
  const bool b16 = dtype == 1;
  const int qw = wg::query_wgs(width(d));
  const int v[8] = {b16 ? 64 * qw : fab::tf32x3::ROWS,
                    BK,
                    b16 ? 128 * qw : fab::tf32x3::THREADS,
                    b16 ? wg::BKV : fab::tf32x3::ROWS,
                    b16 ? wg::dkdv_rows(width(d)) : fab::tf32x3::ROWS,
                    b16 ? 128 * wg::DKDV_WGS : fab::tf32x3::THREADS,
                    b16 ? wg::STAGES : fab::tf32x3::STAGES,
                    b16 ? 1 : 2};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 8;
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
#endif  // FAB_PART(0)
