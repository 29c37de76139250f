// tf32x3.cuh: the float32 products by 3xTF32 on mma.sync m16n8k8 that
// flash_attention.cu (the float32 forward, flash_fwd_tf32x3) and
// flash_attention_bwd.cu (the float32 backward, namespace fab::tf32x3)
// share, with the cp.async staging of their 64-row tiles. One copy; every
// function is inline, so each of the backward's objects (kernels/build.py
// PARTS) may include it.
//
// Each operand x enters as big = tf32(x) and small = tf32(x - big) (tf32:
// cvt.rna, ties away from zero, (bits + 0x1000) & ~0x1fff; ref.split_tf32),
// and a b as small.big + big.small + big.big, three mma.sync m16n8k8 tf32
// into a fresh fragment that is then added to the running sum in float32
// (ref.mm_3xtf32). A TF32 product is exact in float32 and big + small
// carries x to 2^-22, so the dropped small.small and small's rounding
// leave ~2^-21 a term; the fresh fragment keeps the tensor core's own
// (truncating) accumulation to three terms, and every longer sum is a
// float32 add.
//
// Tiles sit in shared memory at a row stride of ld(DP) = DP + 4 floats:
// no bank conflict in either B fragment's pattern (frag_b_nk reads rows
// g, columns t; frag_b_kn rows 2t, columns g).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tf32x3 {

constexpr int ROWS = 64;  // rows of a staged tile (queries or keys)

__host__ __device__ constexpr int ld(int dp) { return dp + 4; }
__host__ __device__ constexpr size_t tile_bytes(int dp) {
  return sizeof(float) * ROWS * ld(dp);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + 64) of one head (``src`` at (b, 0, head, 0)) into a
// 64 x (DP + 4) tile by cp.async, the block's NT threads sharing the
// copy; rows at or past S and columns at or past d zero
template <int DP, int NT>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int S, long stride, int d) {
  constexpr int CH = DP / 4, LD = ld(DP);
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = 4 * (i - r * CH), row = r0 + r;
    const bool ok = row < S && c < d;
    cp16(dst + r * LD + c, ok ? src + row * stride + c : src, ok ? 16 : 0);
  }
}

// TF32 of x as cvt.rna.tf32.f32 gives it for a finite x: the 10-bit
// mantissa rounded to nearest, ties away from zero (ref.split_tf32)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32: big = tf32(x), small = tf32(x - big)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// c (16 x 8, float32) += a (16 x 8, tf32, row) b (8 x 8, tf32, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b by 3xTF32: small.big, big.small, then big.big into a fresh
// fragment, added to c in float32
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, as, bb[0], bb[1]);
  mma(t, ab, bs[0], bs[1]);
  mma(t, ab, bb[0], bb[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// the A fragment (16 x 8) at rows r0, columns 8 kk of a row-major tile
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&big)[4],
                                       uint32_t (&small)[4], const float* X,
                                       int r0, int kk) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
  const float* p = X + (r0 + g) * LD + 8 * kk + t;
  split(p[0], big[0], small[0]);
  split(p[8 * LD], big[1], small[1]);
  split(p[4], big[2], small[2]);
  split(p[8 * LD + 4], big[3], small[3]);
}

// the B fragment (8 x 8) of columns n0.., k 8 kk.. from a tile stored
// [n][k]
template <int LD>
__device__ __forceinline__ void frag_b_nk(uint32_t (&big)[2],
                                          uint32_t (&small)[2],
                                          const float* Y, int n0, int kk) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
  const float* p = Y + (n0 + g) * LD + 8 * kk + t;
  split(p[0], big[0], small[0]);
  split(p[4], big[1], small[1]);
}

// the same from a tile stored [k][n], k in the order of an A fragment
// taken from an accumulator (product): b0 row 2t, b1 row 2t + 1
template <int LD>
__device__ __forceinline__ void frag_b_kn(uint32_t (&big)[2],
                                          uint32_t (&small)[2],
                                          const float* Y, int kk, int n0) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
  const float* p = Y + (8 * kk + 2 * t) * LD + n0 + g;
  split(p[0], big[0], small[0]);
  split(p[LD], big[1], small[1]);
}

// acc[j] (16 x 8) = X[r0 .. r0 + 15][0 .. DP) Y[8 j .. 8 j + 7][0 .. DP)^T
// for j < N / 8: a row block's scores against N rows of Y; in the
// accumulator layout a thread holds rows g, g + 8 (e >> 1) and columns
// 8 j + 2 t + (e & 1) of acc[j][e]
template <int DP, int N>
__device__ __forceinline__ void scores(float (&acc)[N / 8][4], const float* X,
                                       int r0, const float* Y) {
  constexpr int LD = ld(DP);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t ab[4], as[4];
    frag_a<LD>(ab, as, X, r0, kk);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      uint32_t bb[2], bs[2];
      frag_b_nk<LD>(bb, bs, Y, 8 * j, kk);
      mma3(acc[j], ab, as, bb, bs);
    }
  }
}

// acc (16 x DP) += X (16 x N, an accumulator tile) Y[0 .. N)[0 .. DP)
// with Y stored [k][n]: X's k8 step kk is split into its A fragment as it
// is reached, k = t taking column 2 t and k = t + 4 column 2 t + 1
template <int DP, int N>
__device__ __forceinline__ void product(float (&acc)[DP / 8][4],
                                        const float (&x)[N / 8][4],
                                        const float* Y) {
  constexpr int LD = ld(DP);
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    uint32_t ab[4], as[4];
    split(x[kk][0], ab[0], as[0]);
    split(x[kk][2], ab[1], as[1]);
    split(x[kk][1], ab[2], as[2]);
    split(x[kk][3], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      uint32_t bb[2], bs[2];
      frag_b_kn<LD>(bb, bs, Y, kk, 8 * j);
      mma3(acc[j], ab, as, bb, bs);
    }
  }
}

}  // namespace tf32x3
