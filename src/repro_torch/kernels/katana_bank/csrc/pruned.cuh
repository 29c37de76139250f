// The plain version's pruned op stream for a model set whose constant
// pattern is known at compile time, shared by every tracking kernel that
// predicts: the bank steps (imm_step.cu: the IMM step and the
// single-model katana_bank), the replay scans (scan.cu, imm_scan.cu) and
// the live frames (frame.cu, imm_frame.cu).
//
// ref.py folds the model constants on the host (ref.plan_imm_tables): an
// entry of F, Q or R that every member model agrees on stays a Python
// float, pruned from its sum when it is 0.0 and its product elided when
// it is 1.0 (ref._dot, ref._predict_cov, ref._innovation). A kernel that
// skips exactly the entries its Pattern names issues that op stream
// itself, so it rounds as the plain version does, signed zeros included,
// and multiplies none of F's zeros.
//
// KATANA_IMM_PATTERNS lists the instantiated patterns; ops.py reads this
// list from this file and gives each launch the id of the pattern whose
// pruned entries the model set's shared zeros and ones cover (dense, with
// nothing pruned, covers every set).
#pragma once

#include "imm.cuh"

namespace katana {

// Bit i*N + j of FZ (QZ) is set where every member's F (Q) is 0: the
// term is pruned. Bit i*N + j of F1 is set where every member's F is
// 1.0: the product is elided. Bit r*M + c of RZ is set where every
// member's R is 0. Each mask is two 64-bit words (low, high).
template <int N_, int M_, uint64_t FZ0, uint64_t FZ1, uint64_t F10,
          uint64_t F11, uint64_t QZ0, uint64_t QZ1, uint32_t RZ>
struct Pattern {
  static constexpr int N = N_;
  static constexpr int M = M_;
  __host__ __device__ static constexpr bool bit(uint64_t lo, uint64_t hi,
                                                int b) {
    return ((b < 64 ? lo >> b : hi >> (b - 64)) & 1u) != 0;
  }
  __host__ __device__ static constexpr bool fz(int i, int j) {
    return bit(FZ0, FZ1, i * N + j);
  }
  __host__ __device__ static constexpr bool f1(int i, int j) {
    return bit(F10, F11, i * N + j);
  }
  __host__ __device__ static constexpr bool qz(int i, int j) {
    return bit(QZ0, QZ1, i * N + j);
  }
  __host__ __device__ static constexpr bool rz(int r, int c) {
    return ((RZ >> (r * M + c)) & 1u) != 0;
  }
  // every row of F keeps a term, so no entry of F x or F P is a
  // structural zero (ref._dot would return the constant 0.0 there)
  __host__ __device__ static constexpr bool rows_kept() {
    for (int i = 0; i < N; ++i) {
      bool any = false;
      for (int k = 0; k < N; ++k) any = any || !fz(i, k);
      if (!any) return false;
    }
    return true;
  }
};

// id, name, n, m, F zeros (low, high), F ones (low, high), Q zeros (low,
// high), R zeros. imm9 is make_imm() (CV9 + CA9 + CT9(+-w)): 22 of F's 81
// entries kept, 27 of Q's, R's diagonal. ctra8 is the CTRA-8 Jacobian
// (ref._predict_single: the identity and seven slots) with a diagonal Q.
// cv6 is the CV6 LKF: the identity and dt at (0,3), (1,4), (2,5), Q's
// diagonal and its (i, i+3) pairs, R's diagonal.
#define KATANA_IMM_PATTERNS(X)                                               \
  X(0, dense6, 6, 3, 0x0ull, 0x0ull, 0x0ull, 0x0ull, 0x0ull, 0x0ull, 0x0u)   \
  X(1, dense8, 8, 4, 0x0ull, 0x0ull, 0x0ull, 0x0ull, 0x0ull, 0x0ull, 0x0u)   \
  X(2, ctra8, 8, 4, 0x7fbfdfcfb77be5e6ull, 0x0ull, 0x8040201008040201ull,    \
    0x0ull, 0x7fbfdfeff7fbfdfeull, 0x0ull, 0x7bdeu)                          \
  X(3, dense9, 9, 3, 0x0ull, 0x0ull, 0x0ull, 0x0ull, 0x0ull, 0x0ull, 0x0u)   \
  X(4, imm9, 9, 3, 0xefdbf67d3b6ecba6ull, 0xffbfull, 0x4000000100401ull,     \
    0x0ull, 0xed9b76ddb36edbb6ull, 0xdbb6ull, 0xeeu)                         \
  X(5, cv6, 6, 3, 0x7efddbb76ull, 0x0ull, 0x810204081ull, 0x0ull,           \
    0x6edd9bb76ull, 0x0ull, 0xeeu)

#define KATANA_DECLARE_PATTERN(id, name, n, m, ...)                          \
  struct name : Pattern<n, m, __VA_ARGS__> {};                              \
  static_assert(name::rows_kept(), #name ": a row of F is all pruned");
KATANA_IMM_PATTERNS(KATANA_DECLARE_PATTERN)
#undef KATANA_DECLARE_PATTERN

// Index of (r, q), r <= q, in a row-major upper triangle of N x N.
template <int N>
__host__ __device__ constexpr int tri(int r, int q) {
  return r * N - r * (r - 1) / 2 + (q - r);
}

// One model's constants F, Q, R as ops._consts lays them out (row major),
// read where they are used: from device memory (ConstsIn) or from a
// kernel's parameters (ModelTable, passed __grid_constant__: a multiply
// then takes the constant bank as its operand, no load).
template <int N, int M>
struct ConstsIn {
  const float* p;
  __device__ __forceinline__ float F(int i, int j) const {
    return __ldg(p + i * N + j);
  }
  __device__ __forceinline__ float Q(int i, int j) const {
    return __ldg(p + N * N + i * N + j);
  }
  __device__ __forceinline__ float R(int r, int q) const {
    return __ldg(p + 2 * N * N + r * M + q);
  }
};

template <int N, int M>
struct ModelTable {
  float f[N * N];
  float q[N * N];
  float r[M * M];
  __device__ __forceinline__ float F(int i, int j) const {
    return f[i * N + j];
  }
  __device__ __forceinline__ float Q(int i, int j) const {
    return q[i * N + j];
  }
  __device__ __forceinline__ float R(int a, int b) const {
    return r[a * M + b];
  }
};

// sum_k F[i][k] * v(k) over the kept terms of row i, folded left in index
// order, the shared 1.0s elided (ref._dot). Fv(i, k) is read only for the
// kept entries that are not a shared 1.0.
template <class Pat, class FV, class V>
__device__ __forceinline__ float fdot(int i, const FV& Fv, const V& v) {
  float acc = 0.0f;
  bool have = false;
#pragma unroll
  for (int k = 0; k < Pat::N; ++k) {
    if (Pat::fz(i, k)) continue;
    const float t = Pat::f1(i, k) ? v(k) : Fv(i, k) * v(k);
    acc = have ? acc + t : t;
    have = true;
  }
  return acc;
}

// x' = F x (ref._matvec).
template <class Pat, class FV>
__device__ __forceinline__ void predict_mean(const FV& Fv,
                                             const float (&x)[Pat::N],
                                             float (&xp)[Pat::N]) {
#pragma unroll
  for (int i = 0; i < Pat::N; ++i)
    xp[i] = fdot<Pat>(i, Fv, [&](int k) { return x[k]; });
}

// P' = F P F^T + Q (ref._predict_cov): row i of F P, then
// P'[i][j] = F[j] . (F P)[i]. Sym (symmetrize=True): j >= i, mirrored;
// otherwise every j, so an asymmetry of the products is kept. Pa(k, j)
// reads P[k][j]; only one row of F P is live at a time.
template <class Pat, bool Sym = true, class FV, class QV, class PA>
__device__ __forceinline__ void predict_cov_pruned(const FV& Fv, const QV& Qv,
                                                   const PA& Pa,
                                                   float (&Pp)[Pat::N]
                                                              [Pat::N]) {
  constexpr int N = Pat::N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float FP[N];
#pragma unroll
    for (int j = 0; j < N; ++j)
      FP[j] = fdot<Pat>(i, Fv, [&](int k) { return Pa(k, j); });
#pragma unroll
    for (int j = Sym ? i : 0; j < N; ++j) {
      float acc = fdot<Pat>(j, Fv, [&](int k) { return FP[k]; });
      if (!Pat::qz(i, j)) acc = acc + Qv(i, j);
      Pp[i][j] = acc;
      if constexpr (Sym) Pp[j][i] = acc;
    }
  }
}

// S = P'[obs][obs] + R (shared zeros of R pruned) and its inverse
// (ref._innovation).
template <class Pat, class RV>
__device__ __forceinline__ void innovation_pruned(
    const float (&Pp)[Pat::N][Pat::N], const RV& Rv,
    float (&S)[Pat::M][Pat::M], float (&Si)[Pat::M][Pat::M]) {
  constexpr int N = Pat::N, M = Pat::M;
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < M; ++c) {
      const float p = Pp[obs<N, M>(r)][obs<N, M>(c)];
      S[r][c] = Pat::rz(r, c) ? p : p + Rv(r, c);
    }
  small_inv<M>(S, Si);
}

// The CTRA-8 Jacobian at (v, theta) as ref._predict_single builds it:
// the identity, c dt, -v s dt, s dt, v c dt, and dt at (2,7), (3,6), (4,5).
struct CtraJacobian {
  float c, s, v, dt;
  __device__ __forceinline__ float operator()(int i, int k) const {
    if (i == 0 && k == 3) return c * dt;
    if (i == 0 && k == 4) return ((-v) * s) * dt;
    if (i == 1 && k == 3) return s * dt;
    if (i == 1 && k == 4) return (v * c) * dt;
    if ((i == 2 && k == 7) || (i == 3 && k == 6) || (i == 4 && k == 5))
      return dt;
    return i == k ? 1.0f : 0.0f;
  }
};

// Time update of one lane on the Pattern: x' = F x and P' = F P F^T + Q
// with the constant F, or, for a nonlinear model (CTRA-8, N = 8 only),
// the hard-coded dynamics and their Jacobian at the lane's state
// (ref._predict_single). Pa(r, q) reads P[r][q]; every entry is read, so
// P need not be symmetric to the bit.
template <class Pat, bool Sym = true, class CS, class PA>
__device__ __forceinline__ void predict_pruned(const CS& cs, bool nonlinear,
                                               float dt,
                                               const float (&xv)[Pat::N],
                                               const PA& Pa,
                                               float (&xp)[Pat::N],
                                               float (&Pp)[Pat::N][Pat::N]) {
  auto Qv = [&](int i, int j) { return cs.Q(i, j); };
  if constexpr (Pat::N == 8) {
    if (nonlinear) {
      const float px = xv[0], py = xv[1], pz = xv[2], v = xv[3], th = xv[4],
                  om = xv[5], a = xv[6], vz = xv[7];
      const CtraJacobian J{cosf(th), sinf(th), v, dt};
      xp[0] = px + (v * J.c) * dt;
      xp[1] = py + (v * J.s) * dt;
      xp[2] = pz + vz * dt;
      xp[3] = v + a * dt;
      xp[4] = th + om * dt;
      xp[5] = om;
      xp[6] = a;
      xp[7] = vz;
      predict_cov_pruned<Pat, Sym>(J, Qv, Pa, Pp);
      return;
    }
  }
  auto Fv = [&](int i, int j) { return cs.F(i, j); };
  predict_mean<Pat>(Fv, xv, xp);
  predict_cov_pruned<Pat, Sym>(Fv, Qv, Pa, Pp);
}

// One predict+update of a lane: the prediction x', P', then S, S^-1, the
// innovation y and the updated x, P (Sym: upper triangle, mirrored; else
// every entry) from the measurement zv. The bank steps, the replay scan
// and (predict and update in two launches) the live frame all run this
// code, so T katana_bank calls give the scan's state by construction.
template <class Pat, bool Sym = true, class CS, class PA>
__device__ __forceinline__ void step_lane(
    const CS& cs, bool nonlinear, float dt, const float (&xv)[Pat::N],
    const PA& Pa, const float (&zv)[Pat::M], float (&xp)[Pat::N],
    float (&Pp)[Pat::N][Pat::N], float (&xn)[Pat::N],
    float (&Pn)[Pat::N][Pat::N], float (&S)[Pat::M][Pat::M],
    float (&Si)[Pat::M][Pat::M], float (&y)[Pat::M]) {
  predict_pruned<Pat, Sym>(cs, nonlinear, dt, xv, Pa, xp, Pp);
  innovation_pruned<Pat>(Pp, [&](int r, int q) { return cs.R(r, q); }, S,
                         Si);
  kalman_update<Pat::N, Pat::M, Sym>(xp, Pp, Si, zv, y, xn, Pn);
}

// W floats of one lane between device memory and registers: 16-byte (or
// 8-byte) accesses where the address allows, 4-byte ones otherwise.
template <int W>
__device__ __forceinline__ void load_vec(const float* __restrict__ g,
                                         float (&v)[W]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  if constexpr (W % 4 == 0) {
    if ((a & 15u) == 0) {
#pragma unroll
      for (int k = 0; k < W / 4; ++k) {
        const float4 u = __ldg(reinterpret_cast<const float4*>(g) + k);
        v[4 * k] = u.x;
        v[4 * k + 1] = u.y;
        v[4 * k + 2] = u.z;
        v[4 * k + 3] = u.w;
      }
      return;
    }
  }
  if constexpr (W % 2 == 0) {
    if ((a & 7u) == 0) {
#pragma unroll
      for (int k = 0; k < W / 2; ++k) {
        const float2 u = __ldg(reinterpret_cast<const float2*>(g) + k);
        v[2 * k] = u.x;
        v[2 * k + 1] = u.y;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < W; ++i) v[i] = __ldg(g + i);
}

template <int W>
__device__ __forceinline__ void store_vec(float* __restrict__ g,
                                          const float (&v)[W]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  if constexpr (W % 4 == 0) {
    if ((a & 15u) == 0) {
#pragma unroll
      for (int k = 0; k < W / 4; ++k)
        reinterpret_cast<float4*>(g)[k] =
            make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
      return;
    }
  }
  if constexpr (W % 2 == 0) {
    if ((a & 7u) == 0) {
#pragma unroll
      for (int k = 0; k < W / 2; ++k)
        reinterpret_cast<float2*>(g)[k] = make_float2(v[2 * k], v[2 * k + 1]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < W; ++i) g[i] = v[i];
}

// Copy `count` floats from device memory to shared memory with the
// block's threads, asynchronously: 16-byte cp.async when the source is
// 16-byte aligned and count a multiple of 4, 4-byte cp.async otherwise.
// `s` is 16-byte aligned. Call stage_wait() and sync before reading.
__device__ __forceinline__ void stage_in(float* s, const float* g, int count,
                                         int tid, int nthreads) {
  if ((reinterpret_cast<uintptr_t>(g) & 15u) == 0 && (count & 3) == 0) {
    for (int e = tid; e < count / 4; e += nthreads) {
      const uint32_t dst =
          static_cast<uint32_t>(__cvta_generic_to_shared(s + 4 * e));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                   "l"(g + 4 * e)
                   : "memory");
    }
  } else {
    for (int e = tid; e < count; e += nthreads) {
      const uint32_t dst =
          static_cast<uint32_t>(__cvta_generic_to_shared(s + e));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
                   "l"(g + e)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Copy `count` floats from shared memory (16-byte aligned) to device
// memory: 16-byte stores where the target allows, 4-byte ones otherwise.
__device__ __forceinline__ void stage_out(float* g, const float* s, int count,
                                          int tid, int nthreads) {
  if ((reinterpret_cast<uintptr_t>(g) & 15u) == 0 && (count & 3) == 0) {
    for (int e = tid; e < count / 4; e += nthreads)
      reinterpret_cast<float4*>(g)[e] = reinterpret_cast<const float4*>(s)[e];
  } else {
    for (int e = tid; e < count; e += nthreads) g[e] = s[e];
  }
}

}  // namespace katana
