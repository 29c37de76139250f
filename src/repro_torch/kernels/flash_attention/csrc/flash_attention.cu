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
// over ~0.42 GB: 1.04 ms at the 989 TFLOP/s bf16 tensor-core peak, 15 ms
// at the 67 TFLOP/s float32 CUDA-core peak. So bf16 runs on the tensor
// cores, Hopper's way (flash_fwd_wgmma):
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
// Why float32 keeps the CUDA-core kernel (flash_fwd_f32): float32 inputs
// cannot enter the bf16 tensor cores unrounded, and TF32 keeps 10 bits,
// so the float32 check (2e-5 against the plain version) would fail. The
// C entry point dispatches on the type: bf16 runs flash_fwd_wgmma (a bf16
// call that cannot launch returns its error; it never runs the float32
// kernel), float32 runs flash_fwd_f32, the file's first kernel: one
// block of 256 threads per (64-query tile, batch x head), the tiles in
// shared memory as float32 (row stride d + 1), 4 x 4 register blocks of
// scalar FMAs, expf.
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

namespace fa {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------

namespace f32 {

constexpr int BQ = 64;        // queries a block
constexpr int BK = 64;        // keys a tile
constexpr int THREADS = 256;  // 16 row groups x 16 column threads
constexpr int MAXD = 128;
constexpr int NCOL = MAXD / 16;  // output columns a thread, at most

// rows [r0, r0 + 64) of one head of a (B, S, heads, d) tensor, ``src``
// pointing at (b, 0, head, 0); rows at or past n read as zero
__device__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                          int r0, int n, long row_stride, int d) {
  for (int i = threadIdx.x; i < BQ * d; i += THREADS) {
    const int r = i / d, c = i - r * d, row = r0 + r;
    dst[r * ld + c] = row < n ? src[row * row_stride + c] : 0.f;
  }
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

__global__ void __launch_bounds__(THREADS)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int Sq,
                  int Sk, int H, int KH, int d, float scale, int causal,
                  int window) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;             // BQ x ld
  float* ks = qs + BQ * ld;     // BK x ld
  float* vs = ks + BK * ld;     // BK x ld
  float* ps = vs + BK * ld;     // BQ x (BK + 1)
  constexpr int PLD = BK + 1;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int kh = h / (H / KH);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, grp = tid >> 4, tx = tid & 15;
  const long qrs = (long)H * d, krs = (long)KH * d;
  const float* qb = q + (long)b * Sq * qrs + (long)h * d;
  const float* kb = k + (long)b * Sk * krs + (long)kh * d;
  const float* vb = v + (long)b * Sk * krs + (long)kh * d;

  load_tile(qs, ld, qb, q0, Sq, qrs, d);

  float m[4], l[4], acc[4][NCOL];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NCOL; ++cc) acc[i][cc] = 0.f;
  }

  // the kv tiles this query tile needs (kernel.py:39-44)
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0) kt_begin = max(q0 - window + 1, 0) / BK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's ks / vs / ps are read
    load_tile(ks, ld, kb, k0, Sk, krs, d);
    load_tile(vs, ld, vb, k0, Sk, krs, d);
    __syncthreads();

    // s = q k^T on this thread's rows 4 grp + i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * grp + i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * grp + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(4 * grp + i) * PLD + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + group16_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < NCOL; ++cc) acc[i][cc] *= alpha;
    }
    __syncthreads();

    // acc += p v on this thread's rows, columns tx + 16 cc
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * grp + i) * PLD + j];
#pragma unroll
      for (int cc = 0; cc < NCOL; ++cc) {
        const int c = tx + 16 * cc;
        if (c < d) {
          const float vv = vs[j * ld + c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i][cc] = __fmaf_rn(pv[i], vv, acc[i][cc]);
        }
      }
    }
  }

  float* ob = o + (long)b * Sq * qrs + (long)h * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * grp + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < NCOL; ++cc) {
      const int c = tx + 16 * cc;
      if (c < d) ob[row * qrs + c] = acc[i][cc] / denom;
    }
  }
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

cudaError_t run_f32(int B, int Sq, int Sk, int H, int KH, int d,
                    const void* q, const void* k, const void* v, void* o,
                    float scale, int causal, int window,
                    cudaStream_t stream) {
  using namespace f32;
  const size_t smem = sizeof(float) * (3 * BQ * (d + 1) + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_f32<<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Sk,
      H, KH, d, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace fa

extern "C" {

// dtype: 0 float32 (flash_fwd_f32), 1 bfloat16 (flash_fwd_wgmma).
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
// block, keys a tile, K/V stages, threads a block, the PV MMA's N (0: no
// tensor cores)}. Returns the number of values written.
int flash_attention_config(int dtype, int d, int* out) {
  if (dtype == 1) {
    const int n = fa::hop::pv_n(d), nwg = fa::hop::warpgroups(n);
    const int v[5] = {64 * nwg, fa::hop::BK, fa::hop::STAGES,
                      32 * (4 * nwg + 1), n};
    for (int i = 0; i < 5; ++i) out[i] = v[i];
  } else {
    const int v[5] = {fa::f32::BQ, fa::f32::BK, 1, fa::f32::THREADS, 0};
    for (int i = 0; i < 5; ++i) out[i] = v[i];
  }
  return 5;
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
