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
// Scratch: lse and D, float32 (B, H, Sq). d a multiple of 8 up to 128;
// any Sq, Sk; causal or not; an optional window. A key is visible from a
// query as in ref.mask(Sq, Sk, causal, window); every query row and every
// key row gets its gradient, a ragged tail too.
//
// Bound: operations. A visible (query, key) pair needs five products of
// d (S = q.k, dP = dO.v, dV += P dO, dK += dS q, dQ += dS k): 10 d
// operations. At danube's layer (B 1, S 8,192, 32 / 8 heads of 80, window
// 4,096: 8.05e8 visible pairs) that is 6.44e11: 0.65 ms at the 989
// TFLOP/s bf16 tensor-core peak, 9.6 ms at the 67 TFLOP/s float32 CUDA-
// core peak, against 42 MB of q, k, v, dO, dq, dk, dv (0.013 ms).
//
// FA2's backward, split in three passes so that no sum goes through
// atomics and two calls agree to the bit:
//
//   flash_bwd_prep  a block a (64-query tile, b, h): the row's float32
//                   log-sum-exp over the visible keys and D = rowsum(dO o
//                   O) = sum_j P_ij dP_ij, from q, k, v and dO (S = Q K^T
//                   and dP = dO V^T over the key tiles, online as the
//                   forward's softmax). The forward's output is not read,
//                   so the backward is the same whichever forward ran.
//   flash_bwd_dkdv  a block a (64-key tile, b, kv head): K and V stay in
//                   shared memory; it walks the G = H / KH query heads of
//                   its group and, for each, only the query tiles that the
//                   causal and window conditions leave (the forward's tile
//                   tests, kernel.py:39-44, seen from the key side);
//                   S^T = K Q^T, dP^T = V dO^T, P^T = exp(S^T - lse),
//                   dS^T = P^T o (dP^T - D), dV += P^T dO, dK += dS^T Q in
//                   float32 registers over the whole group, rounded once
//                   (float32: a partial a query tile over the group's
//                   heads, added to the total tile by tile).
//   flash_bwd_dq    a block a (64-query tile, b, h): over the live key
//                   tiles, S, dP, dS as above, dQ += dS K; written once.
//
// That recomputes S and dP three times: 18 d operations a pair where the
// bound counts 10 d (22 d in bf16, below).
//
// bf16 (flash_bwd_prep / _dkdv / _dq<DP>) runs its products on the tensor
// cores with mma.sync m16n8k16 (bf16 in, float32 accumulators) and
// ldmatrix (.trans where the product's B is stored k-major, as dO, Q and
// K are for dV, dK and dQ): 4 warps a block, 16 rows of the tile each; the
// tiles sit in shared memory at a row stride of d + 8 bf16 (16 bytes more
// than the row: no two of ldmatrix's 8 rows fall on one bank), columns
// past d zero up to DP = d rounded up to 16, 32, 64, 80 or 128. P enters
// the tensor cores rounded to bf16 for dV, as the reference rounds it for
// PV; dS enters split, dS_hi = bf16(dS) and dS_lo = bf16(dS - dS_hi), two
// products into the same accumulators (as the forward splits P), so dq
// and dk keep float32's accuracy up to their one rounding, as the torch-op
// backward's (float32 products of dS) do; rounded once, dS's 2^-9 would
// add to it. That is 4 d more operations a pair (22 d). The scores, the
// exp and every sum stay float32; exp is one ex2.approx of s scale
// log2(e) - lse2 (lse kept in base 2). dkdv takes 32 queries a tile at
// DP = 128, 64 below, so its float32 dK and dV fit the registers.
//
// float32 (flash_bwd_prep_f32 / _dkdv_f32 / _dq_f32<NC>) stays on the CUDA
// cores, as flash_fwd_f32 does: the bf16 tensor cores would round it, and
// TF32 keeps 10 bits. 256 threads a 64 x 64 tile, each 4 rows x 4 columns
// (rows 4 grp + i, columns tx + 16 j); the score products read 16-byte
// vectors along d (row stride d + 4 floats: 8 distinct banks groups of a
// warp's rows); the d-wide products 4 rows x NC columns (tx + 16 cc).
// Every multiply-add is one __fmaf_rn; expf, logf.
//
// A row with no visible key (Sq > Sk + window - 1) gets lse = +inf, D = 0:
// no gradient, as the forward kernel gives it no output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Built in three parts at once (kernels/build.py PARTS; -DKATANA_PART=i
// compiles part i, without it one object holds all): 0 the float32
// kernels and the C entries, 1 the bf16 kernels at DP 16, 32 and 64, 2
// at DP 80 and 128.
#ifdef KATANA_PART
#define FAB_PART(i) (KATANA_PART == (i))
#else
#define FAB_PART(i) 1
#endif

namespace fab {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BK = 64;  // keys a tile, every kernel
constexpr int BQ = 64;  // queries a tile of prep and dq (and of the float32 dkdv)

struct Shape {
  int Sq, Sk, H, KH, d, causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(const Shape& s, int qpos, int kpos) {
  bool ok = qpos < s.Sq && kpos < s.Sk;
  if (s.causal) ok = ok && kpos <= qpos;
  if (s.window > 0) ok = ok && qpos - kpos < s.window;
  return ok;
}

// the key tiles [*begin, *end) that query rows [q0, q0 + rows) see (the
// forward's kv loop, kernel.py:39-44)
__device__ __forceinline__ void key_tiles(const Shape& s, int q0, int rows,
                                          int* begin, int* end) {
  int e = (s.Sk + BK - 1) / BK;
  if (s.causal) e = min(e, (q0 + rows - 1) / BK + 1);
  *begin = s.window > 0 ? max(q0 - s.window + 1, 0) / BK : 0;
  *end = e;
}

// the query tiles of ``rows`` rows that see keys [k0, k0 + BK): causal,
// queries at or after k0; windowed, queries before k0 + BK - 1 + window
__device__ __forceinline__ void query_tiles(const Shape& s, int k0, int rows,
                                            int* begin, int* end) {
  int e = (s.Sq + rows - 1) / rows;
  if (s.window > 0) e = min(e, (k0 + BK - 2 + s.window) / rows + 1);
  *begin = s.causal ? k0 / rows : 0;
  *end = e;
}

// ---------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), ldmatrix
// ---------------------------------------------------------------------

namespace tc {

constexpr int THREADS = 128;  // 4 warps x 16 rows
// queries a tile of dkdv: its float32 dK, dV (DP / 2 registers each) and
// S^T, dP^T (rows / 2 each) fit a thread's registers
__host__ __device__ constexpr int dkdv_rows(int dp) {
  return dp <= 80 ? 64 : 32;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^y on the special-function unit; 0 at y = -inf or far below
__device__ __forceinline__ float ex2(float y) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(y));
  return r;
}

// rows [r0, r0 + R) of one head of a (B, S, heads, d) tensor, ``src`` at
// (b, 0, head, 0), into R x (DP + 8): rows at or past S and columns d..DP
// zero
template <int R, int DP>
__device__ __forceinline__ void load_tile(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int r0, int S, long stride, int d) {
  constexpr int LD = DP + 8, CH = DP / 8;
  for (int i = threadIdx.x; i < R * CH; i += THREADS) {
    const int r = i / CH, c = 8 * (i - r * CH), row = r0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < S && c < d)
      x = __ldg(reinterpret_cast<const uint4*>(src + row * stride + c));
    *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
  }
}

// A (16 x 16) at rows r0, columns c0 of a row-major tile
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t,
                                       int r0, int c0) {
  const int l = threadIdx.x & 31;
  ldsm4(a, t + (r0 + (l & 7) + 8 * ((l >> 3) & 1)) * LD + c0 + 8 * (l >> 4));
}

// B of the two n8 tiles n0, n0 + 8 over k0 .. k0 + 15, from a tile stored
// [n][k] (b[0], b[1] the first tile's, b[2], b[3] the second's)
template <int LD>
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const bf16* t,
                                          int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm4(b, t + (n0 + (l & 7) + 8 * (l >> 4)) * LD + k0 + 8 * ((l >> 3) & 1));
}

// the same from a tile stored [k][n] (ldmatrix transposes)
template <int LD>
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const bf16* t,
                                          int k0, int n0) {
  const int l = threadIdx.x & 31;
  ldsm4t(b, t + (k0 + (l & 7) + 8 * ((l >> 3) & 1)) * LD + n0 + 8 * (l >> 4));
}

// acc (16 x N) += X[r0 .. r0 + 15][0 .. DP) Y[0 .. N)[0 .. DP)^T; in the
// accumulator layout a thread holds rows g, g + 8 (e >> 1) and columns
// 8 j + 2 t + (e & 1) of acc[j][e]
template <int DP, int N>
__device__ __forceinline__ void scores(float (&acc)[N / 8][4], const bf16* X,
                                       int r0, const bf16* Y) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    frag_a<LD>(a, X, r0, 16 * kk);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b[4];
      frag_b_nk<LD>(b, Y, 16 * np, 16 * kk);
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x DP) += p (16 x N, accumulator layout) Y[0 .. N)[0 .. DP) with
// Y stored [k][n]: the accumulators of two n8 tiles are the A fragment of
// one k16 step. p enters as bf16(p), or with LO as bf16(p) + bf16(p -
// bf16(p)) (two products into the same accumulators, p carried to 2^-16)
template <int DP, int N, bool LO>
__device__ __forceinline__ void product(float (&acc)[DP / 8][4],
                                        const float (&p)[N / 8][4],
                                        const bf16* Y) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = p[2 * kk + (r >> 1)][2 * (r & 1)];
      const float x1 = p[2 * kk + (r >> 1)][2 * (r & 1) + 1];
      hi[r] = pack(x0, x1);
      if (LO) {
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi[r]);
        lo[r] = pack(x0 - __low2float(h), x1 - __high2float(h));
      }
    }
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t b[4];
      frag_b_kn<LD>(b, Y, 16 * kk, 16 * np);
      mma(acc[2 * np], hi, b[0], b[1]);
      mma(acc[2 * np + 1], hi, b[2], b[3]);
      if (LO) {
        mma(acc[2 * np], lo, b[0], b[1]);
        mma(acc[2 * np + 1], lo, b[2], b[3]);
      }
    }
  }
}

// the two key-tile products of prep and dq: S = Q K^T and dP = dO V^T for
// this warp's 16 query rows
template <int DP>
__device__ __forceinline__ void row_scores(float (&sc)[BK / 8][4],
                                           float (&dp)[BK / 8][4],
                                           const bf16* qs, const bf16* os,
                                           const bf16* ks, const bf16* vs,
                                           int rw) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
  scores<DP, BK>(sc, qs, rw, ks);
  scores<DP, BK>(dp, os, rw, vs);
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_prep(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   float* __restrict__ lse, float* __restrict__ dsum,
                   Shape s) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* os = qs + BQ * LD;
  bf16* ks = os + BQ * LD;
  bf16* vs = ks + BK * LD;
  const int bh = blockIdx.y, b = bh / s.H, h = bh - b * s.H;
  const int kh = h / (s.H / s.KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const long qrs = (long)s.H * s.d, krs = (long)s.KH * s.d;
  const long qoff = (long)b * s.Sq * qrs + (long)h * s.d;
  const long koff = (long)b * s.Sk * krs + (long)kh * s.d;
  load_tile<BQ, DP>(qs, q + qoff, q0, s.Sq, qrs, s.d);
  load_tile<BQ, DP>(os, dout + qoff, q0, s.Sq, qrs, s.d);

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rw = 16 * (threadIdx.x >> 5);
  const float sl2 = s.scale * LOG2E;
  // per row: the running max of s scale log2(e), and this thread's share
  // of l = sum 2^(x - m) and of sum 2^(x - m) dP
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  int kt0, kt1;
  key_tiles(s, q0, BQ, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's ks / vs are read
    load_tile<BK, DP>(ks, k + koff, k0, s.Sk, krs, s.d);
    load_tile<BK, DP>(vs, v + koff, k0, s.Sk, krs, s.d);
    __syncthreads();
    float sc[BK / 8][4], dp[BK / 8][4];
    row_scores<DP>(sc, dp, qs, os, ks, vs, rw);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = visible(s, q0 + rw + g + 8 * r,
                                k0 + 8 * j + 2 * t + (e & 1));
        sc[j][e] = ok ? sc[j][e] * sl2 : NEG_INF;
        mx[r] = fmaxf(mx[r], sc[j][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      const float alpha = ex2(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha;
      dd[r] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = sc[j][e] == NEG_INF ? 0.f : ex2(sc[j][e] - m[r]);
        l[r] += p;
        dd[r] += p * dp[j][e];
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 1);
    dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 2);
    const int row = q0 + rw + g + 8 * r;
    if (t == 0 && row < s.Sq) {
      const long i = (long)bh * s.Sq + row;
      lse[i] = l[r] > 0.f ? m[r] + log2f(l[r]) : INFINITY;
      dsum[i] = l[r] > 0.f ? dd[r] / l[r] : 0.f;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, bf16* __restrict__ dq,
                 Shape s) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* os = qs + BQ * LD;
  bf16* ks = os + BQ * LD;
  bf16* vs = ks + BK * LD;
  const int bh = blockIdx.y, b = bh / s.H, h = bh - b * s.H;
  const int kh = h / (s.H / s.KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const long qrs = (long)s.H * s.d, krs = (long)s.KH * s.d;
  const long qoff = (long)b * s.Sq * qrs + (long)h * s.d;
  const long koff = (long)b * s.Sk * krs + (long)kh * s.d;
  load_tile<BQ, DP>(qs, q + qoff, q0, s.Sq, qrs, s.d);
  load_tile<BQ, DP>(os, dout + qoff, q0, s.Sq, qrs, s.d);

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rw = 16 * (threadIdx.x >> 5);
  const float sl2 = s.scale * LOG2E;
  float L[2], D[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rw + g + 8 * r;
    const long i = (long)bh * s.Sq + row;
    L[r] = row < s.Sq ? lse[i] : INFINITY;
    D[r] = row < s.Sq ? dsum[i] : 0.f;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int kt0, kt1;
  key_tiles(s, q0, BQ, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<BK, DP>(ks, k + koff, k0, s.Sk, krs, s.d);
    load_tile<BK, DP>(vs, v + koff, k0, s.Sk, krs, s.d);
    __syncthreads();
    float sc[BK / 8][4], dp[BK / 8][4];
    row_scores<DP>(sc, dp, qs, os, ks, vs, rw);
    // dS = P o (dP - D), P = 2^(s scale log2(e) - lse2)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = visible(s, q0 + rw + g + 8 * r,
                                k0 + 8 * j + 2 * t + (e & 1));
        const float p = ok ? ex2(sc[j][e] * sl2 - L[r]) : 0.f;
        sc[j][e] = p * (dp[j][e] - D[r]);
      }
    product<DP, BK, true>(acc, sc, ks);
  }

  bf16* out = dq + qoff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rw + g + 8 * r;
    if (row >= s.Sq) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < s.d)
        *reinterpret_cast<__nv_bfloat162*>(out + row * qrs + 8 * j + 2 * t) =
            __floats2bfloat162_rn(acc[j][2 * r] * s.scale,
                                  acc[j][2 * r + 1] * s.scale);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, Shape s) {
  constexpr int LD = DP + 8, BM = dkdv_rows(DP);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + BK * LD;
  bf16* qs = vs + BK * LD;
  bf16* os = qs + BM * LD;
  float* ls = reinterpret_cast<float*>(os + BM * LD);
  float* dl = ls + BM;
  const int bk = blockIdx.y, b = bk / s.KH, kh = bk - b * s.KH;
  const int G = s.H / s.KH;
  const int k0 = blockIdx.x * BK;  // the first (heaviest under causal) first
  const long qrs = (long)s.H * s.d, krs = (long)s.KH * s.d;
  const long koff = (long)b * s.Sk * krs + (long)kh * s.d;
  load_tile<BK, DP>(ks, k + koff, k0, s.Sk, krs, s.d);
  load_tile<BK, DP>(vs, v + koff, k0, s.Sk, krs, s.d);

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rw = 16 * (threadIdx.x >> 5);  // this warp's keys in the tile
  const float sl2 = s.scale * LOG2E;
  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  int qt0, qt1;
  query_tiles(s, k0, BM, &qt0, &qt1);
  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const long qoff = (long)b * s.Sq * qrs + (long)h * s.d;
    const float* lh = lse + (long)(b * s.H + h) * s.Sq;
    const float* dh = dsum + (long)(b * s.H + h) * s.Sq;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int m0 = qt * BM;
      __syncthreads();  // the last tile's qs / os / ls / dl are read
      load_tile<BM, DP>(qs, q + qoff, m0, s.Sq, qrs, s.d);
      load_tile<BM, DP>(os, dout + qoff, m0, s.Sq, qrs, s.d);
      for (int i = threadIdx.x; i < BM; i += THREADS) {
        const int row = m0 + i;
        ls[i] = row < s.Sq ? lh[row] : INFINITY;
        dl[i] = row < s.Sq ? dh[row] : 0.f;
      }
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T on this warp's 16 keys x BM queries
      float st[BM / 8][4], dpt[BM / 8][4];
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      scores<DP, BM>(st, ks, rw, qs);
      scores<DP, BM>(dpt, vs, rw, os);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const bool ok = visible(s, m0 + c, k0 + rw + g + 8 * (e >> 1));
          const float p = ok ? ex2(st[j][e] * sl2 - ls[c]) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dl[c]);
        }
      product<DP, BM, false>(dva, st, os);  // dV += P^T dO
      product<DP, BM, true>(dka, dpt, qs);  // dK += dS^T Q
    }
  }

  bf16* okb = dk + koff;
  bf16* ovb = dv + koff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + rw + g + 8 * r;
    if (row >= s.Sk) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < s.d) {
        const long o = row * krs + 8 * j + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(okb + o) = __floats2bfloat162_rn(
            dka[j][2 * r] * s.scale, dka[j][2 * r + 1] * s.scale);
        *reinterpret_cast<__nv_bfloat162*>(ovb + o) =
            __floats2bfloat162_rn(dva[j][2 * r], dva[j][2 * r + 1]);
      }
  }
}

template <int DP>
cudaError_t run(int B, const Shape& s, const void* q, const void* k,
                const void* v, const void* dout, void* dq, void* dk, void* dv,
                float* lse, float* dsum, cudaStream_t stream) {
  constexpr int LD = DP + 8, BM = dkdv_rows(DP);
  const size_t smem_q = (size_t)(2 * BQ + 2 * BK) * LD * sizeof(bf16);
  const size_t smem_kv =
      (size_t)(2 * BK + 2 * BM) * LD * sizeof(bf16) + 2 * BM * sizeof(float);
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
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v,
             *ob = (const bf16*)dout;
  const dim3 gq((s.Sq + BQ - 1) / BQ, B * s.H);
  const dim3 gk((s.Sk + BK - 1) / BK, B * s.KH);
  flash_bwd_prep<DP><<<gq, THREADS, smem_q, stream>>>(qb, kb, vb, ob, lse,
                                                       dsum, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv<DP><<<gk, THREADS, smem_kv, stream>>>(
      qb, kb, vb, ob, lse, dsum, (bf16*)dk, (bf16*)dv, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq<DP><<<gq, THREADS, smem_q, stream>>>(qb, kb, vb, ob, lse,
                                                     dsum, (bf16*)dq, s);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------

#if FAB_PART(0)
namespace f32 {

constexpr int THREADS = 256;  // 16 row groups x 16 column threads
constexpr int PLD = BK + 4;   // row stride of the P / dS tiles

// rows [r0, r0 + 64) of one head into 64 x ld (ld = d + 4), 16 bytes a
// load; rows at or past S zero
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int r0, int S, long stride, int d) {
  const int ch = d / 4;
  for (int i = threadIdx.x; i < 64 * ch; i += THREADS) {
    const int r = i / ch, c = 4 * (i - r * ch), row = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < S)
      x = __ldg(reinterpret_cast<const float4*>(src + row * stride + c));
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

__device__ __forceinline__ float part(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__device__ __forceinline__ float group16_max(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// a[i][j] = sum_c X[4 grp + i][c] Y[tx + 16 j][c], b likewise over X2, Y2
// (two 64-row tiles each, row-major, stride ld): the score products of a
// tile, 16 bytes of d a load
__device__ __forceinline__ void scores(float (&a)[4][4], float (&b)[4][4],
                                       const float* X, const float* Y,
                                       const float* X2, const float* Y2,
                                       int ld, int d) {
  const int grp = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = b[i][j] = 0.f;
  for (int c = 0; c < d; c += 4) {
    float4 x[4], y[4], x2[4], y2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = *reinterpret_cast<const float4*>(X + (4 * grp + i) * ld + c);
      x2[i] = *reinterpret_cast<const float4*>(X2 + (4 * grp + i) * ld + c);
      y[i] = *reinterpret_cast<const float4*>(Y + (tx + 16 * i) * ld + c);
      y2[i] = *reinterpret_cast<const float4*>(Y2 + (tx + 16 * i) * ld + c);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[i][j] = __fmaf_rn(part(x[i], u), part(y[j], u), a[i][j]);
          b[i][j] = __fmaf_rn(part(x2[i], u), part(y2[j], u), b[i][j]);
        }
  }
}

// acc[i][cc] += sum_j P[4 grp + i][j] Y[j][tx + 16 cc] over the tile's 64
// rows j of Y (row-major, stride ld), P a 64 x PLD tile, columns < d
template <int NC>
__device__ __forceinline__ void product(float (&acc)[4][NC], const float* P,
                                        const float* Y, int ld, int d) {
  const int grp = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int j = 0; j < BK; j += 4) {
    float4 pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pr[i] = *reinterpret_cast<const float4*>(P + (4 * grp + i) * PLD + j);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int c = tx + 16 * cc;
        if (c < d) {
          const float y = Y[(j + u) * ld + c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i][cc] = __fmaf_rn(part(pr[i], u), y, acc[i][cc]);
        }
      }
  }
}

__global__ void __launch_bounds__(THREADS)
    flash_bwd_prep_f32(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       float* __restrict__ lse, float* __restrict__ dsum,
                       Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int ld = s.d + 4;
  float* qs = smem;
  float* os = qs + BQ * ld;
  float* ks = os + BQ * ld;
  float* vs = ks + BK * ld;
  const int bh = blockIdx.y, b = bh / s.H, h = bh - b * s.H;
  const int kh = h / (s.H / s.KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const long qrs = (long)s.H * s.d, krs = (long)s.KH * s.d;
  const long qoff = (long)b * s.Sq * qrs + (long)h * s.d;
  const long koff = (long)b * s.Sk * krs + (long)kh * s.d;
  load_tile(qs, ld, q + qoff, q0, s.Sq, qrs, s.d);
  load_tile(os, ld, dout + qoff, q0, s.Sq, qrs, s.d);
  const int grp = threadIdx.x >> 4, tx = threadIdx.x & 15;

  float m[4], l[4], dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = dd[i] = 0.f;
  }
  int kt0, kt1;
  key_tiles(s, q0, BQ, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile(ks, ld, k + koff, k0, s.Sk, krs, s.d);
    load_tile(vs, ld, v + koff, k0, s.Sk, krs, s.d);
    __syncthreads();
    float sc[4][4], dp[4][4];
    scores(sc, dp, qs, ks, os, vs, ld, s.d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * grp + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = visible(s, row, k0 + tx + 16 * j) ? sc[i][j] * s.scale
                                                      : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float mn = fmaxf(m[i], group16_max(mx));
      const float alpha = expf(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha;
      dd[i] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = sc[i][j] == NEG_INF ? 0.f : expf(sc[i][j] - mn);
        l[i] += p;
        dd[i] += p * dp[i][j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lt = group16_sum(l[i]), dt = group16_sum(dd[i]);
    const int row = q0 + 4 * grp + i;
    if (tx == 0 && row < s.Sq) {
      const long o = (long)bh * s.Sq + row;
      lse[o] = lt > 0.f ? m[i] + logf(lt) : INFINITY;
      dsum[o] = lt > 0.f ? dt / lt : 0.f;
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_f32(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, float* __restrict__ dq,
                     Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int ld = s.d + 4;
  float* qs = smem;
  float* os = qs + BQ * ld;
  float* ks = os + BQ * ld;
  float* vs = ks + BK * ld;
  float* ps = vs + BK * ld;  // dS, BQ x PLD
  const int bh = blockIdx.y, b = bh / s.H, h = bh - b * s.H;
  const int kh = h / (s.H / s.KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const long qrs = (long)s.H * s.d, krs = (long)s.KH * s.d;
  const long qoff = (long)b * s.Sq * qrs + (long)h * s.d;
  const long koff = (long)b * s.Sk * krs + (long)kh * s.d;
  load_tile(qs, ld, q + qoff, q0, s.Sq, qrs, s.d);
  load_tile(os, ld, dout + qoff, q0, s.Sq, qrs, s.d);
  const int grp = threadIdx.x >> 4, tx = threadIdx.x & 15;

  float L[4], D[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * grp + i;
    const long o = (long)bh * s.Sq + row;
    L[i] = row < s.Sq ? lse[o] : INFINITY;
    D[i] = row < s.Sq ? dsum[o] : 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[i][cc] = 0.f;
  }
  int kt0, kt1;
  key_tiles(s, q0, BQ, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's ks / vs / ps are read
    load_tile(ks, ld, k + koff, k0, s.Sk, krs, s.d);
    load_tile(vs, ld, v + koff, k0, s.Sk, krs, s.d);
    __syncthreads();
    float sc[4][4], dp[4][4];
    scores(sc, dp, qs, ks, os, vs, ld, s.d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(s, q0 + 4 * grp + i, k0 + tx + 16 * j);
        const float p = ok ? expf(sc[i][j] * s.scale - L[i]) : 0.f;
        ps[(4 * grp + i) * PLD + tx + 16 * j] = p * (dp[i][j] - D[i]);
      }
    __syncthreads();
    product<NC>(acc, ps, ks, ld, s.d);  // dQ += dS K
  }

  float* out = dq + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * grp + i;
    if (row >= s.Sq) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = tx + 16 * cc;
      if (c < s.d) out[row * qrs + c] = acc[i][cc] * s.scale;
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_f32(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum,
                       float* __restrict__ dk, float* __restrict__ dv,
                       Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int ld = s.d + 4;
  float* ks = smem;
  float* vs = ks + BK * ld;
  float* qs = vs + BK * ld;
  float* os = qs + BQ * ld;
  float* pt = os + BQ * ld;  // P^T, BK x PLD
  float* dt = pt + BK * PLD; // dS^T
  float* ls = dt + BK * PLD;
  float* dl = ls + BQ;
  const int bk = blockIdx.y, b = bk / s.KH, kh = bk - b * s.KH;
  const int G = s.H / s.KH;
  const int k0 = blockIdx.x * BK;
  const long qrs = (long)s.H * s.d, krs = (long)s.KH * s.d;
  const long koff = (long)b * s.Sk * krs + (long)kh * s.d;
  load_tile(ks, ld, k + koff, k0, s.Sk, krs, s.d);
  load_tile(vs, ld, v + koff, k0, s.Sk, krs, s.d);
  const int grp = threadIdx.x >> 4, tx = threadIdx.x & 15;

  // dK and dV: a fresh float32 partial a query tile over the group's
  // heads, added to the total in tile order (one chain over G x the
  // visible queries, 16,384 terms at danube's layer, would lose ~5x the
  // accuracy of a blocked sum)
  float dka[4][NC], dva[4][NC], pk[4][NC], pv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) dka[i][cc] = dva[i][cc] = 0.f;
  int qt0, qt1;
  query_tiles(s, k0, BQ, &qt0, &qt1);
  for (int qt = qt0; qt < qt1; ++qt) {
    const int m0 = qt * BQ;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) pk[i][cc] = pv[i][cc] = 0.f;
    for (int gi = 0; gi < G; ++gi) {
      const int h = kh * G + gi;
      const long qoff = (long)b * s.Sq * qrs + (long)h * s.d;
      const float* lh = lse + (long)(b * s.H + h) * s.Sq;
      const float* dh = dsum + (long)(b * s.H + h) * s.Sq;
      __syncthreads();  // the last tile's qs / os / pt / dt / ls / dl are read
      load_tile(qs, ld, q + qoff, m0, s.Sq, qrs, s.d);
      load_tile(os, ld, dout + qoff, m0, s.Sq, qrs, s.d);
      for (int i = threadIdx.x; i < BQ; i += THREADS) {
        const int row = m0 + i;
        ls[i] = row < s.Sq ? lh[row] : INFINITY;
        dl[i] = row < s.Sq ? dh[row] : 0.f;
      }
      __syncthreads();
      // S^T and dP^T: rows the keys 4 grp + i, columns the queries tx + 16 j
      float st[4][4], dpt[4][4];
      scores(st, dpt, ks, qs, vs, os, ld, s.d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const bool ok = visible(s, m0 + c, k0 + 4 * grp + i);
          const float p = ok ? expf(st[i][j] * s.scale - ls[c]) : 0.f;
          pt[(4 * grp + i) * PLD + c] = p;
          dt[(4 * grp + i) * PLD + c] = p * (dpt[i][j] - dl[c]);
        }
      __syncthreads();
      product<NC>(pv, pt, os, ld, s.d);  // dV += P^T dO
      product<NC>(pk, dt, qs, ld, s.d);  // dK += dS^T Q
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        dka[i][cc] += pk[i][cc];
        dva[i][cc] += pv[i][cc];
      }
  }

  float* okb = dk + koff;
  float* ovb = dv + koff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * grp + i;
    if (row >= s.Sk) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = tx + 16 * cc;
      if (c < s.d) {
        okb[row * krs + c] = dka[i][cc] * s.scale;
        ovb[row * krs + c] = dva[i][cc];
      }
    }
  }
}

template <int NC>
cudaError_t run(int B, const Shape& s, const void* q, const void* k,
                const void* v, const void* dout, void* dq, void* dk, void* dv,
                float* lse, float* dsum, cudaStream_t stream) {
  const int ld = s.d + 4;
  const size_t smem_p = sizeof(float) * (size_t)(2 * BQ + 2 * BK) * ld;
  const size_t smem_q = smem_p + sizeof(float) * BQ * PLD;
  const size_t smem_kv = smem_p + sizeof(float) * (2 * BK * PLD + 2 * BQ);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(flash_bwd_prep_f32,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_p)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(flash_bwd_dq_f32<NC>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_q)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(flash_bwd_dkdv_f32<NC>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_kv)) != cudaSuccess)
    return err;
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v, *of = (const float*)dout;
  const dim3 gq((s.Sq + BQ - 1) / BQ, B * s.H);
  const dim3 gk((s.Sk + BK - 1) / BK, B * s.KH);
  flash_bwd_prep_f32<<<gq, THREADS, smem_p, stream>>>(qf, kf, vf, of, lse,
                                                       dsum, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_f32<NC><<<gk, THREADS, smem_kv, stream>>>(
      qf, kf, vf, of, lse, dsum, (float*)dk, (float*)dv, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq_f32<NC><<<gq, THREADS, smem_q, stream>>>(
      qf, kf, vf, of, lse, dsum, (float*)dq, s);
  return cudaGetLastError();
}

}  // namespace f32
#endif  // FAB_PART(0)

// d rounded up to 16, 32, 64, 80 or 128: the bf16 tiles' width, and 16
// times the float32 kernels' columns a thread
constexpr int width(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 80 ? 80 : 128;
}

// the bf16 kernels at width dp: DP 16, 32, 64 in part 1, 80, 128 in part 2
cudaError_t run_tc(int dp, int B, const Shape& s, const void* q,
                   const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, float* lse, float* dsum,
                   cudaStream_t stream);
cudaError_t run_tc_wide(int dp, int B, const Shape& s, const void* q,
                        const void* k, const void* v, const void* dout,
                        void* dq, void* dk, void* dv, float* lse, float* dsum,
                        cudaStream_t stream);

#if FAB_PART(1)
cudaError_t run_tc(int dp, int B, const Shape& s, const void* q,
                   const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, float* lse, float* dsum,
                   cudaStream_t stream) {
  switch (dp) {
    case 16:
      return tc::run<16>(B, s, q, k, v, dout, dq, dk, dv, lse, dsum, stream);
    case 32:
      return tc::run<32>(B, s, q, k, v, dout, dq, dk, dv, lse, dsum, stream);
    default:
      return tc::run<64>(B, s, q, k, v, dout, dq, dk, dv, lse, dsum, stream);
  }
}
#endif

#if FAB_PART(2)
cudaError_t run_tc_wide(int dp, int B, const Shape& s, const void* q,
                        const void* k, const void* v, const void* dout,
                        void* dq, void* dk, void* dv, float* lse, float* dsum,
                        cudaStream_t stream) {
  if (dp == 80)
    return tc::run<80>(B, s, q, k, v, dout, dq, dk, dv, lse, dsum, stream);
  return tc::run<128>(B, s, q, k, v, dout, dq, dk, dv, lse, dsum, stream);
}
#endif

}  // namespace fab

#if FAB_PART(0)
extern "C" {

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores). window <= 0:
// none. lse, dsum: float32 (B, H, Sq) scratch. Three launches on
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
  const fab::Shape s{Sq, Sk, H, KH, d, causal ? 1 : 0, window > 0 ? window : 0,
                     scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *l = (float*)lse, *ds = (float*)dsum;
  const int dp = fab::width(d);
  if (dtype == 1)
    return (int)(dp <= 64 ? fab::run_tc(dp, B, s, q, k, v, dout, dq, dk, dv,
                                        l, ds, st)
                          : fab::run_tc_wide(dp, B, s, q, k, v, dout, dq, dk,
                                             dv, l, ds, st));
  switch (dp) {
    case 16:
      return (int)fab::f32::run<1>(B, s, q, k, v, dout, dq, dk, dv, l, ds, st);
    case 32:
      return (int)fab::f32::run<2>(B, s, q, k, v, dout, dq, dk, dv, l, ds, st);
    case 64:
      return (int)fab::f32::run<4>(B, s, q, k, v, dout, dq, dk, dv, l, ds, st);
    case 80:
      return (int)fab::f32::run<5>(B, s, q, k, v, dout, dq, dk, dv, l, ds, st);
    default:
      return (int)fab::f32::run<8>(B, s, q, k, v, dout, dq, dk, dv, l, ds, st);
  }
}

// The tiling of a call of this type and head dim: out = {queries a tile
// of prep and dq, keys a tile, queries a tile of dkdv, threads a block,
// the MMA's k (16: mma.sync m16n8k16; 0: CUDA cores)}. Returns the number
// of values written.
int flash_attention_bwd_config(int dtype, int d, int* out) {
  const int v[5] = {
      fab::BQ, fab::BK,
      dtype == 1 ? fab::tc::dkdv_rows(fab::width(d)) : fab::BQ,
      dtype == 1 ? fab::tc::THREADS : fab::f32::THREADS, dtype == 1 ? 16 : 0};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 5;
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
#endif  // FAB_PART(0)
