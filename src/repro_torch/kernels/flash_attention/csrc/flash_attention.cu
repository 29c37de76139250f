// flash_attention: tiled online-softmax attention forward, causal and
// sliding-window masks with tile skipping, GQA read in place.
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention_bhsd
// (the Pallas TPU kernel behind models/attention.py impl "flash").
//
// Layout: q (B, Sq, H, d), k/v (B, Sk, KH, d) with KH dividing H, the
// model's own layouts: no transpose, no padding, no broadcast of the kv
// heads (query head h reads kv head h / (H / KH)). Output (B, Sq, H, d)
// in the input type. d a multiple of 8 up to 128.
//
// Bound: operations. At the serving shape (h2o-danube-1.8b prefill,
// B=4, S=8192, H=32, d=80, window 4096, bf16) a call does ~1.03e12 flops
// over ~0.42 GB: 1.04 ms at the 989 TFLOP/s bf16 tensor-core peak; in
// float32, three TF32 products a product (below), 6.2 ms at the 495
// TFLOP/s TF32 peak (15 ms at the 67 TFLOP/s CUDA-core peak). Both run on
// the tensor cores; bf16 Hopper's way (flash_fwd_wgmma):
//
//   - a block takes 192 queries of one (batch, head) where d <= 80, 128
//     above; three (two) consumer warpgroups own 64 query rows each, a
//     producer warp keeps the K and V tiles of 64 keys coming by TMA into
//     a ring of STAGES stages, completed on mbarriers (full: the bytes
//     arrived; empty: the consumer warps are done with the stage); Q is
//     loaded once;
//   - S = Q K^T is wgmma m64n64k16 with Q and K in shared memory, float32
//     accumulators; O += P V is wgmma m64nNk16 with P from registers and
//     V read transposed from shared memory (imm-trans-b), N = d rounded
//     up to 16, 32, 64, 80 or 128;
//   - the tiles sit in shared memory as boxes of 16 columns (32-byte
//     rows, the 32-byte swizzle): d = 80 is five whole boxes, so no
//     operand straddles a swizzle atom, and the tensor map's dimension of
//     d itself zero-fills the columns of a box past d (d = 8) and the
//     rows past Sq or Sk; QK^T runs one k16 step a box;
//   - the kv loop visits only the tiles that the causal and window
//     conditions leave (kernel.py:39-44), a warpgroup skips a tile that
//     is masked for all its rows, and only the diagonal, window-edge and
//     ragged tiles apply the element mask; the query tiles go out
//     heaviest (last) first, so the short causal tiles fill the tail;
//   - what is left on the CUDA cores is the softmax between the two
//     products, about as many issue slots as the products take: exp is
//     one ex2.approx of (s - m) scale log2 e (the running max m kept on
//     the unscaled q.k, the same order for scale > 0, which the wrapper
//     requires of a bf16 call), not expf's ten
//     instructions, and more warpgroups hide the rest: a third fits the
//     registers at d <= 80 (416 threads, at most 152 registers each; a
//     fourth would leave 120 and spill). Issuing the next tile's QK^T
//     before this tile's softmax (a software pipeline in each
//     warpgroup) was slower: the warpgroups already overlap one's
//     softmax with the others' products.
//
// Why P is split hi/lo: the reference forms p in float32 and multiplies
// it by v in float32 (kernel.py:50-72), and the port's check holds the
// output within one bf16 ulp of that. Rounding p to bf16 once (2^-8
// relative) moves rows with a few visible keys by more than an ulp of a
// small output. So p = p_hi + p_lo, p_hi = bf16(p), p_lo = bf16(p - p_hi),
// and two PV wgmmas go into the same accumulator: p is carried to 2^-16,
// every product of bf16 operands is exact, the sums are float32. The PV
// work doubles (6 d tensor-core operations per visible pair instead of
// 4 d). l is summed from the float32 p. QK^T is exact in its products:
// q and k arrive in bf16. The ex2 exp is within ~3e-6 of expf where p
// matters, far inside the same ulp.
//
// float32 (flash_fwd_tf32x3) runs by 3xTF32 on mma.sync m16n8k8, as the
// backward's float32 route (tf32x3.cuh, shared with it): float32 inputs
// cannot enter the bf16 tensor cores unrounded, and one TF32 product keeps
// 10 bits, so the float32 check (2e-5 against the plain version) would
// fail; each operand split into big = tf32(x) and small = tf32(x - big),
// and a product taken as small.big + big.small + big.big into a fresh
// fragment added in float32, keeps ~2^-21 a term (ref.mm_3xtf32,
// ref.flash_attention_tf32x3_plain). The bound is 3 x 4 d operations a
// visible pair at the TF32 peak. The C entry point dispatches on the type:
// bf16 runs flash_fwd_wgmma (a bf16 call that cannot launch returns its
// error; it never runs the float32 kernel), float32 flash_fwd_tf32x3:
//
//   - warps own 16 query rows each, 4 a block (64 queries) where DP <=
//     64, 8 (128 queries) at 80 and 128, where one block fills the shared
//     memory; K and V tiles of 64 keys are staged by cp.async a tile
//     ahead at the backward's row stride (DP + 4 floats), one barrier a
//     tile (two with the planes below); DP = d rounded up to 16, 32, 64,
//     80 or 128 as the bf16 route;
//   - Q's split A fragments stay in registers where d <= 80 (DP of
//     them); at 128 Q sits in shared memory and each k8 step's fragment
//     is split as it is reached, once for the tile's eight key blocks;
//   - where d <= 80 K and V are split once a tile, after the raw tile
//     lands, into big and small planes (K as stored, V transposed), so
//     that a B fragment is two 64-bit loads and no arithmetic: a k8
//     step's k = t and t + 4 are taken as adjacent columns 2 t, 2 t + 1,
//     Q's fragment alike; at 128 (no room for the planes) each B
//     fragment is split as it loads (tf32x3.cuh's frag_b_nk,
//     frag_b_kn), as the backward does;
//   - P goes from the S accumulator to PV's A fragment in registers (the
//     accumulator's columns 2t, 2t + 1 taken as k = t, t + 4, V's rows
//     read in that order), never through shared memory;
//   - row max and sum by quad shuffles; the causal and window tile
//     skipping of the bf16 route, a warp skipping a tile masked for all
//     its 16 rows, the element mask only on diagonal, window-edge and
//     ragged tiles; expf and base e, as the plain version.
//
// Arithmetic, both kernels, as the reference: s = q.k * scale, masked
// entries -1e30 (never -inf: a row whose first visited tile is all
// masked gets p = exp(0) = 1 there, which the first real score wipes
// with alpha = 0; -inf would give NaN), alpha = exp(m_old - m_new), the
// output acc / max(l, 1e-30) rounded to nearest even. Keys are masked by
// the true length Sk: nothing is padded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace fa {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------
// float32: tensor cores by 3xTF32 (mma.sync m16n8k8), cp.async
// ---------------------------------------------------------------------

namespace f32 {

using namespace ::tf32x3;  // the 3xTF32 products and staging (tf32x3.cuh)

constexpr int BK = ROWS;  // keys a tile

// The planes hold K as 64 keys x DP at a row stride of ldk(DP) and V
// transposed, DP rows of 64 keys at LDV, so that both products' B
// fragments are 64-bit loads: a k8 step's k = t and t + 4 are taken as
// the adjacent columns 2 t and 2 t + 1 (Q's A fragment likewise), and a
// stride of 8 or 24 words mod 32 keeps a half-warp's loads off each
// other's banks.
__host__ __device__ constexpr int ldk(int dp) { return dp + 8; }
constexpr int LDV = BK + 8;

// The tiling at width DP: WARPS warps of 16 query rows a block. Where DP
// <= 80 (QREG) Q's split fragments are held in registers (DP of them) and
// K and V are split once a tile into the planes: shared memory for one
// raw stage of K and V and the four planes. At 128 there is no room for
// the planes: two stages of raw K and V, then Q, read from shared memory
// and split a k8 step at a time, and each B fragment split as it loads.
// The planes measured 3.4% faster than the split at the load at d 64 and
// 6.8% at d 80 on an H100 (PERF.md §6).
template <int DP>
struct Plan {
  static constexpr bool QREG = DP <= 80;
  static constexpr int WARPS = DP > 64 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * WARPS;  // queries a block
  static constexpr int TILES = QREG ? 2 : 4;  // raw 64-row K, V tiles
  static constexpr int PLANES = QREG ? 2 * (BK * ldk(DP) + DP * LDV) : 0;
  static constexpr size_t SMEM = TILES * tile_bytes(DP) +
                                 sizeof(float) * PLANES +
                                 (QREG ? 0 : sizeof(float) * BQ * ld(DP));
};

// the raw K and V tiles (``raw``: K, then V) into their big and small
// TF32 planes (``planes``: K big, K small at ldk(DP); V big, V small
// transposed at LDV), four columns of a row a thread at a time: K's rows
// across a warp's threads, V's keys, so that its transposed stores fall
// on consecutive words
template <int DP, int NT>
__device__ __forceinline__ void split_tiles(uint32_t* planes,
                                            const float* raw) {
  constexpr int LD = ld(DP), LDK = ldk(DP), CH = DP / 4;
  constexpr int KP = BK * LDK, VP = DP * LDV;  // words of a plane
  uint32_t* vplanes = planes + 2 * KP;
  for (int i = threadIdx.x; i < 2 * BK * CH; i += NT) {
    const int m = i / (BK * CH), rc = i - m * BK * CH;
    const int r = m ? rc % BK : rc / CH;
    const int c = 4 * (m ? rc / BK : rc % CH);
    const float4 x =
        *reinterpret_cast<const float4*>(raw + m * BK * LD + r * LD + c);
    uint4 big, small;
    split(x.x, big.x, small.x);
    split(x.y, big.y, small.y);
    split(x.z, big.z, small.z);
    split(x.w, big.w, small.w);
    if (m == 0) {
      *reinterpret_cast<uint4*>(planes + r * LDK + c) = big;
      *reinterpret_cast<uint4*>(planes + KP + r * LDK + c) = small;
    } else {  // V: key r is column r of the rows c .. c + 3
      uint32_t* vb = vplanes + c * LDV + r;
      vb[0] = big.x;
      vb[LDV] = big.y;
      vb[2 * LDV] = big.z;
      vb[3 * LDV] = big.w;
      vb[VP] = small.x;
      vb[VP + LDV] = small.y;
      vb[VP + 2 * LDV] = small.z;
      vb[VP + 3 * LDV] = small.w;
    }
  }
}

// A block a BQ-query tile of one (b, h); warp w owns query rows r0 =
// q0 + 16 w .. r0 + 15 and walks the key tiles the causal and window
// conditions leave (kernel.py:39-44), skipping those masked for all its
// rows. S = Q K^T and O += P V by 3xTF32; in the accumulator layout a
// thread holds rows g and g + 8 (e >> 1), columns 8 j + 2 t + (e & 1) of
// s[j][e]; P goes from the S accumulator to PV's A fragment in registers.
template <int DP>
__global__ void __launch_bounds__(Plan<DP>::THREADS)
    flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int Sq, int Sk, int H, int KH, int d, float scale,
                     int causal, int window) {
  using P = Plan<DP>;
  constexpr int LD = ld(DP), T = ROWS * LD, NT = P::THREADS, BQ = P::BQ;
  constexpr int NJ = DP / 8;  // 8-column blocks of a row of d
  extern __shared__ __align__(16) float smem[];
  float* kv = smem;  // QREG: the raw (K, V); else 2 stages x (K, V)
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem + 2 * T);
  float* qs = smem + P::TILES * T + P::PLANES;  // BQ x LD where !QREG

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int kh = h / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 16 * warp;
  const long qrs = (long)H * d, krs = (long)KH * d;
  const float* qb = q + (long)b * Sq * qrs + (long)h * d;
  const float* kb = k + (long)b * Sk * krs + (long)kh * d;
  const float* vb = v + (long)b * Sk * krs + (long)kh * d;

  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK + 1);
  const int kt_begin = window > 0 ? max(q0 - window + 1, 0) / BK : 0;

  if constexpr (!P::QREG)
    for (int r = 0; r < BQ; r += ROWS)
      load_tile<DP, NT>(qs + r * LD, qb, q0 + r, Sq, qrs, d);
  if (kt_begin < kt_end) {
    load_tile<DP, NT>(kv, kb, kt_begin * BK, Sk, krs, d);
    load_tile<DP, NT>(kv + T, vb, kt_begin * BK, Sk, krs, d);
  }
  cp_commit();

  // Q's A fragments, split once (frag_a's rows g, g + 8; k = t and t + 4
  // at columns 8 kk + 2 t, 8 kk + 2 t + 1, as the planes hold K); rows
  // past Sq and columns past d zero
  uint32_t qbig[P::QREG ? NJ : 1][4], qsmall[P::QREG ? NJ : 1][4];
  if constexpr (P::QREG) {
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e & 1);
        const int col = 8 * kk + 2 * t + (e >> 1);
        split(row < Sq && col < d ? qb[row * qrs + col] : 0.f, qbig[kk][e],
              qsmall[kk][e]);
      }
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    // this tile's raw K and V; the next tile goes into the other stage
    // (QREG: into the raw stage once the planes are split from it),
    // which every warp is done with past the barrier
    const float* ks = kv + (P::QREG ? 0 : ((kt - kt_begin) & 1) * 2 * T);
    float* nx = kv + (P::QREG ? 0 : ((kt - kt_begin + 1) & 1) * 2 * T);
    cp_wait<0>();
    __syncthreads();  // the tile arrived; the last tile's stage is read
    if constexpr (P::QREG) {
      split_tiles<DP, NT>(planes, kv);
      __syncthreads();  // the planes are written; the raw stage is free
    }
    if (kt + 1 < kt_end) {
      load_tile<DP, NT>(nx, kb, k0 + BK, Sk, krs, d);
      load_tile<DP, NT>(nx + T, vb, k0 + BK, Sk, krs, d);
    }
    cp_commit();
    const float* vs = ks + T;
    constexpr int KP = BK * ldk(DP), VP = DP * LDV;
    const uint32_t *kbig = planes, *ksmall = planes + KP;
    const uint32_t *vbig = planes + 2 * KP, *vsmall = vbig + VP;

    const bool dead = r0 >= Sq || (causal && k0 > r0 + 15) ||
                      (window > 0 && k0 + BK - 1 < r0 - window + 1);
    if (!dead) {
      // S = Q K^T, K's B fragment (keys 8 j + g; against the planes
      // columns 8 kk + 2 t, + 1, else 8 kk + t, + 4)
      float s[BK / 8][4];
      if constexpr (P::QREG) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NJ; ++kk)
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            const int at = (8 * j + g) * ldk(DP) + 8 * kk + 2 * t;
            const uint2 xb = *reinterpret_cast<const uint2*>(kbig + at);
            const uint2 xs = *reinterpret_cast<const uint2*>(ksmall + at);
            const uint32_t bb[2] = {xb.x, xb.y}, bs[2] = {xs.x, xs.y};
            mma3(s[j], qbig[kk], qsmall[kk], bb, bs);
          }
      } else {
        scores<DP, BK>(s, qs, 16 * warp, ks);
      }

      // the masked, scaled scores and the online softmax (kernel.py:46-63):
      // only diagonal, window-edge and ragged tiles apply the element mask
      const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > r0) ||
                        (window > 0 && r0 + 15 - k0 >= window);
      float mx[2] = {NEG_INF, NEG_INF};
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + g + 8 * (e >> 1);
            const int col = k0 + 8 * j + 2 * t + (e & 1);
            bool ok = col < Sk;
            if (causal) ok = ok && col <= row;
            if (window > 0) ok = ok && row - col < window;
            s[j][e] = ok ? s[j][e] * scale : NEG_INF;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] *= scale;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e >> 1]);
          rs[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = l[r] * alpha[r] + rs[r];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

      // O += P V: p's k8 step kk split into its A fragment (k = t taking
      // key 2 t, k = t + 4 key 2 t + 1), V's B fragment read in that order
      if constexpr (P::QREG) {
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          uint32_t ab[4], as[4];
          split(s[kk][0], ab[0], as[0]);
          split(s[kk][2], ab[1], as[1]);
          split(s[kk][1], ab[2], as[2]);
          split(s[kk][3], ab[3], as[3]);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int at = (8 * j + g) * LDV + 8 * kk + 2 * t;
            const uint2 xb = *reinterpret_cast<const uint2*>(vbig + at);
            const uint2 xs = *reinterpret_cast<const uint2*>(vsmall + at);
            const uint32_t bb[2] = {xb.x, xb.y}, bs[2] = {xs.x, xs.y};
            mma3(acc[j], ab, as, bb, bs);
          }
        }
      } else {
        product<DP, BK>(acc, s, vs);
      }
    }
  }
  cp_wait<0>();  // a block that visits no tile has its loads in flight

  // out = acc / max(l, 1e-30), rows < Sq, columns < d
  float* ob = o + (long)b * Sq * qrs + (long)h * d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (8 * j < d)
        *reinterpret_cast<float2*>(ob + row * qrs + 8 * j + 2 * t) =
            make_float2(acc[j][2 * r] / denom, acc[j][2 * r + 1] / denom);
  }
}

template <int DP>
cudaError_t launch(int B, int Sq, int Sk, int H, int KH, int d,
                   const void* q, const void* k, const void* v, void* o,
                   float scale, int causal, int window,
                   cudaStream_t stream) {
  using P = Plan<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32x3<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)P::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + P::BQ - 1) / P::BQ);
  flash_fwd_tf32x3<DP><<<grid, P::THREADS, P::SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Sk,
      H, KH, d, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace f32


// ---------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA, mbarriers
// ---------------------------------------------------------------------

namespace hop {

using namespace ::hopper;

constexpr int BK = 64;           // keys a tile
constexpr int STAGES = 3;        // K/V ring
constexpr int KBOX = BK * ROWB;  // bytes of a 16-column box of K or V

// A block of NWG consumer warpgroups (64 query rows each) and a producer
// warp. Three where their registers fit 416 threads (d <= 80: one more
// warpgroup to run its products while the others are in the softmax),
// else two.
template <int NWG>
struct Tile {
  static constexpr int BQ = 64 * NWG;              // queries a block
  static constexpr int WARPS = 4 * NWG;            // consumer warps
  static constexpr int THREADS = 32 * WARPS + 32;  // + the producer warp
  static constexpr int QBOX = BQ * ROWB;  // bytes of a 16-column box of Q
};
constexpr int warpgroups(int dp) { return dp <= 80 ? 3 : 2; }

// DP: d rounded up to 16, 32, 64, 80 or 128 (the PV wgmma's N); NWG:
// consumer warpgroups.
template <int DP, int NWG>
__global__ void __launch_bounds__(Tile<NWG>::THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tmq,
                    const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv,
                    __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H,
                    int KH, int d, float scale, int causal, int window) {
  constexpr int NB = DP / 16;  // 16-column boxes of a row
  constexpr int NO = DP / 2;   // output accumulators a thread
  constexpr int BQ = Tile<NWG>::BQ, QBOX = Tile<NWG>::QBOX;
  constexpr int CONSUMER_WARPS = Tile<NWG>::WARPS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = qs + NB * QBOX;           // STAGES x NB boxes
  uint8_t* vs = ks + STAGES * NB * KBOX;  // STAGES x NB boxes
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + STAGES * NB * KBOX);
  const uint32_t full = smem_u32(bars), empty = full + 8 * STAGES,
                 qbar = empty + 8 * STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int kh = h / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  // the kv tiles this query tile needs (kernel.py:39-44)
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK + 1);
  const int kt_begin = window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  const int n_tiles = max(kt_end - kt_begin, 0);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // the producer
    if (lane == 0 && n_tiles > 0) {
      mbar_expect_tx(qbar, NB * QBOX);
      for (int j = 0; j < NB; ++j)
        tma_load(smem_u32(qs + j * QBOX), &tmq, qbar, 16 * j, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES, k0 = (kt_begin + it) * BK;
        if (it >= STAGES) mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * NB * KBOX);
        for (int j = 0; j < NB; ++j) {
          tma_load(smem_u32(ks + (s * NB + j) * KBOX), &tmk, full + 8 * s,
                   16 * j, kh, k0, b);
          tma_load(smem_u32(vs + (s * NB + j) * KBOX), &tmv, full + 8 * s,
                   16 * j, kh, k0, b);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns query rows r0 .. r0 + 63; in the
  // wgmma accumulator layout a thread holds rows ra and ra + 8, columns
  // 8 j + 2 t4 + {0, 1} of each 8-column block j
  const int wg = warp >> 2, r0 = q0 + 64 * wg;
  const int t4 = lane & 3, ra = r0 + 16 * (warp & 3) + (lane >> 2);
  const uint32_t qa = smem_u32(qs) + wg * 64 * ROWB;
  float oacc[NO], sacc[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
  // m is the running max of the unscaled q.k (scale > 0 keeps the order)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float sl2 = scale * 1.4426950408889634f;  // scale log2 e
  uint32_t p_hi[4][4], p_lo[4][4];

  if (n_tiles > 0) mbar_wait(qbar, 0);
  __syncwarp();  // wgmma wants the warp converged
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES, k0 = (kt_begin + it) * BK;
    const bool dead = (causal && k0 > r0 + 63) ||
                      (window > 0 && k0 + BK - 1 < r0 - window + 1);
    mbar_wait(full + 8 * s, (it / STAGES) & 1);
    __syncwarp();
    if (!dead) {
      const uint32_t ka = smem_u32(ks + s * NB * KBOX);
      const uint32_t va = smem_u32(vs + s * NB * KBOX);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NB; ++kk)
        wgmma_ss(sacc, desc_sw32(qa + kk * QBOX, 16, SBO),
                 desc_sw32(ka + kk * KBOX, 16, SBO), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      hold(sacc);

      const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > r0) ||
                        (window > 0 && r0 + 63 - k0 >= window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int half = (i >> 1) & 1, row = ra + 8 * half;
        const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        bool ok = true;
        if (edge) {
          ok = col < Sk;
          if (causal) ok = ok && col <= row;
          if (window > 0) ok = ok && row - col < window;
        }
        if (!ok) sacc[i] = NEG_INF;
        mx[half] = fmaxf(mx[half], sacc[i]);
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2_approx((m[r] - m_new) * sl2);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int half = (i >> 1) & 1;
        sacc[i] = exp2_approx((sacc[i] - m[half]) * sl2);
        rs[half] += sacc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = l[r] * alpha[r] + rs[r];
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) oacc[i] *= alpha[(i >> 1) & 1];
      // p as the A fragments of the four k16 steps: p = p_hi + p_lo
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = sacc[8 * kk + 2 * r], x1 = sacc[8 * kk + 2 * r + 1];
          p_hi[kk][r] = pack_bf16(x0, x1);
          const __nv_bfloat162 hv =
              *reinterpret_cast<const __nv_bfloat162*>(&p_hi[kk][r]);
          p_lo[kk][r] = pack_bf16(x0 - __low2float(hv),
                                  x1 - __high2float(hv));
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = desc_sw32(va + kk * 16 * ROWB, KBOX, SBO);
        wgmma_rs(oacc, p_hi[kk], dv);
        wgmma_rs(oacc, p_lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      hold(oacc);
      hold(p_hi);
      hold(p_lo);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // out = acc / max(l, 1e-30), bf16, rows < Sq, columns < d
  const long rstride = (long)H * d;
  __nv_bfloat16* ob = o + (long)b * Sq * rstride + (long)h * d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int col = 8 * j + 2 * t4;
      if (8 * j < d)
        *reinterpret_cast<__nv_bfloat162*>(ob + row * rstride + col) =
            __floats2bfloat162_rn(oacc[4 * j + 2 * r] / denom,
                                  oacc[4 * j + 2 * r + 1] / denom);
    }
  }
}

template <int DP>
cudaError_t launch(int B, int Sq, int Sk, int H, int KH, int d,
                   const void* q, const void* k, const void* v, void* o,
                   float scale, int causal, int window,
                   cudaStream_t stream) {
  constexpr int NB = DP / 16, NWG = warpgroups(DP);
  using T = Tile<NWG>;
  cudaError_t err = bind_context(q);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, Sq, H, d, T::BQ) ||
      !tensor_map(&tk, k, B, Sk, KH, d, BK) ||
      !tensor_map(&tv, v, B, Sk, KH, d, BK))
    return cudaErrorInvalidValue;
  const size_t smem =
      1024 + NB * T::QBOX + 2 * STAGES * NB * KBOX + 8 * (2 * STAGES + 1);
  err = cudaFuncSetAttribute(
      flash_fwd_wgmma<DP, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + T::BQ - 1) / T::BQ);
  flash_fwd_wgmma<DP, NWG><<<grid, T::THREADS, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, Sq, Sk, H, KH, d, scale, causal,
      window);
  return cudaGetLastError();
}

// the PV wgmma's N for a head dim
constexpr int pv_n(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 80 ? 80 : 128;
}

cudaError_t run(int B, int Sq, int Sk, int H, int KH, int d, const void* q,
                const void* k, const void* v, void* o, float scale,
                int causal, int window, cudaStream_t stream) {
  if (d % 8 || d > 128 || Sq < 1) return cudaErrorInvalidValue;
  switch (pv_n(d)) {
    case 16:
      return launch<16>(B, Sq, Sk, H, KH, d, q, k, v, o, scale, causal,
                        window, stream);
    case 32:
      return launch<32>(B, Sq, Sk, H, KH, d, q, k, v, o, scale, causal,
                        window, stream);
    case 64:
      return launch<64>(B, Sq, Sk, H, KH, d, q, k, v, o, scale, causal,
                        window, stream);
    case 80:
      return launch<80>(B, Sq, Sk, H, KH, d, q, k, v, o, scale, causal,
                        window, stream);
    default:
      return launch<128>(B, Sq, Sk, H, KH, d, q, k, v, o, scale, causal,
                         window, stream);
  }
}

}  // namespace hop

// float32 at d rounded up to 16, 32, 64, 80 or 128 (the bf16 route's
// widths)
cudaError_t run_f32(int B, int Sq, int Sk, int H, int KH, int d,
                    const void* q, const void* k, const void* v, void* o,
                    float scale, int causal, int window,
                    cudaStream_t stream) {
  if (d % 8 || d > 128 || Sq < 1) return cudaErrorInvalidValue;
  switch (hop::pv_n(d)) {
    case 16:
      return f32::launch<16>(B, Sq, Sk, H, KH, d, q, k, v, o, scale, causal,
                             window, stream);
    case 32:
      return f32::launch<32>(B, Sq, Sk, H, KH, d, q, k, v, o, scale, causal,
                             window, stream);
    case 64:
      return f32::launch<64>(B, Sq, Sk, H, KH, d, q, k, v, o, scale, causal,
                             window, stream);
    case 80:
      return f32::launch<80>(B, Sq, Sk, H, KH, d, q, k, v, o, scale, causal,
                             window, stream);
    default:
      return f32::launch<128>(B, Sq, Sk, H, KH, d, q, k, v, o, scale,
                              causal, window, stream);
  }
}

// the float32 tiling at width DP, as flash_attention_config writes it
template <int DP>
void f32_config(int* out) {
  using P = f32::Plan<DP>;
  const int v[8] = {P::BQ, f32::BK, P::QREG ? 1 : 2, P::THREADS, 8, 2,
                    P::QREG, P::QREG};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

}  // namespace fa

extern "C" {

// dtype: 0 float32 (flash_fwd_tf32x3), 1 bfloat16 (flash_fwd_wgmma).
// window <= 0: none.
int flash_attention_run(int dtype, int B, int Sq, int Sk, int H, int KH,
                        int d, const void* q, const void* k, const void* v,
                        void* o, float scale, int causal, int window,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)fa::hop::run(B, Sq, Sk, H, KH, d, q, k, v, o, scale, causal,
                             window, s);
  return (int)fa::run_f32(B, Sq, Sk, H, KH, d, q, k, v, o, scale, causal,
                          window, s);
}

// The tiling a call of this type and head dim runs: out = {queries a
// block, keys a tile, K/V stages, threads a block, the PV MMA's N, the
// products' instruction (1: wgmma m64nNk16 bf16; 2: mma.sync m16n8k8 tf32,
// three a product), Q's operand in registers (1) or shared memory (0), K
// and V split into TF32 planes at staging (1) or as each fragment loads
// (0; bf16: no split)}. Returns the number of values written.
int flash_attention_config(int dtype, int d, int* out) {
  if (dtype == 1) {
    const int n = fa::hop::pv_n(d), nwg = fa::hop::warpgroups(n);
    const int v[8] = {64 * nwg, fa::hop::BK, fa::hop::STAGES,
                      32 * (4 * nwg + 1), n, 1, 0, 0};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
    return 8;
  }
  switch (fa::hop::pv_n(d)) {
    case 16: fa::f32_config<16>(out); break;
    case 32: fa::f32_config<32>(out); break;
    case 64: fa::f32_config<64>(out); break;
    case 80: fa::f32_config<80>(out); break;
    default: fa::f32_config<128>(out);
  }
  return 8;
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
