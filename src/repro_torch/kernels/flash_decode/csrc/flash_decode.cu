// flash_decode_partial: one query token's attention over a KV cache,
// un-normalised: per (batch, head) the running max m, the denominator l
// and the weighted sum acc, for the caller to merge the current token
// (and, with a cache cut over several devices, the other parts) by the
// log-sum-exp algebra.
//
// Replaces repro/kernels/flash_decode/kernel.py:flash_decode_partial
// (the Pallas TPU kernel; its XLA twin is models/attention.py
// decode_attention, the model's decode step).
//
// Layout: q (B, H, d); k/v (B, T, KH, d), the model's cache, KH dividing
// H, d a multiple of 8 up to 128. Outputs float32: acc (B, H, d),
// m (B, H), l (B, H). The kv head of query head h is h / (H / KH): a
// block reads its kv head once for all G = H / KH query heads, never
// repeated to H heads.
//
// Bound: bytes. At the serving shape (h2o-danube-1.8b decode, B=4,
// T=4096, KH=8, d=80, bf16) k and v are 41.9 MB, 12.5 us at 3.35 TB/s,
// against 4 d flops per (head, key). The TPU kernel walks the cache in
// order on one core; on the H100 the bytes have to be in flight on all
// 132 SMs at once. So the cache is split over blocks in two passes, both
// on the caller's stream:
//
//   pass 1 (decode_split): grid (KH, n_split, B), one block per (kv head,
//     split of ``split`` keys, batch), the kv heads of a split side by
//     side in the launch order: 256 blocks at the serving shape (8 splits
//     of 512 keys), one wave at two blocks an SM; ops.choose_split
//     halves the split for small batches (scripts/lm_decode_probe.py
//     times 128 to 1024 keys a split with the L2 cold). The block
//     stages its split in shared memory as stored, by 16-byte cp.async
//     copies (neighbouring threads on neighbouring bytes of a 160-byte
//     row, the rows padded to 176 bytes): as many rows as the 112 KB
//     budget holds at once (256 in bf16 at the serving shape), chunk
//     after chunk, V after K; where the whole split fits, K and V go out
//     together and V arrives during the scores. Nothing of the cache is staged as
//     float32: 8 values at a time are widened in registers where they
//     are used. Scores: a thread a key row, the G heads' dots in
//     registers, q read as shared-memory broadcasts; then one warp a head
//     takes the split's max m_s, p = exp(s - m_s) and l_s = sum p. PV: a
//     half-warp a key row, lane c accumulating p v over its chunk of 8
//     columns for the heads; the two half-warps and the 8 warps are
//     summed through shared memory. The block writes the float32 partial
//     (acc_s, m_s, l_s) of each head to a scratch of shape
//     (B, H, n_split, d + 2).
//   pass 2 (decode_merge): one block per (batch, head) merges the
//     partials as ops.lse_merge does: m = max_s m_s,
//     l = sum_s l_s exp(m_s - m), acc = sum_s acc_s exp(m_s - m), the
//     weights exp(m_s - m) taken once, by one warp, into shared memory.
//
// The arithmetic is the reference's (kernel.py:23-56) cut at the split
// boundaries: s = q.k * scale, p and l float32, the split's maximum
// taken over its own keys, the merge's exp(m_s - m) the reference's
// alpha = exp(m_old - m_new); m starts at -1e30 in the merge, so T = 0
// gives m = -1e30, l = 0, acc = 0 as the reference does. A split ragged
// at the end of T holds only its true keys. The float32 cache takes the
// same path (a chunk is 8 values, 32 bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fd {

constexpr int THREADS = 256;  // 8 warps, 16 half-warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = THREADS / 16;  // key rows of a PV step (half-warps)
constexpr int UNROLL = 4;           // rows a half-warp takes a PV step
constexpr int VEC = 8;              // values of a chunk
constexpr int BUDGET = 112 * 1024;  // shared bytes a block: two an SM
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// chunk (8 values) from shared memory, widened to float32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// rows [0, m) of d values (row stride rs elements) into dst, row stride
// ``ld`` elements: one 16-byte cp.async a thread and step, neighbouring
// threads on neighbouring bytes of a row
template <typename E>
__device__ __forceinline__ void stage_rows(E* dst, int ld, const E* src,
                                           int m, long rs, int d) {
  const int per = d * (int)sizeof(E) / 16;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < m * per; i += THREADS) {
    const int r = i / per, p = i - r * per;
    const char* g = reinterpret_cast<const char*>(src + r * rs) + p * 16;
    const uint32_t a =
        smem_u32(reinterpret_cast<char*>(dst + r * ld) + p * 16);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
                 "l"(g)
                 : "memory");
  }
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Pass 1. GB: heads a register group (1, 2, 4 or 8); G > GB loops over
// groups of GB heads. ch: key rows staged at once (the whole split when
// it fits the budget: then V is loaded once, beside K).
template <typename E, int GB>
__global__ void __launch_bounds__(THREADS)
    decode_split(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, float* __restrict__ part,
                 int H, int KH, int T, int d, int split, int n_split,
                 int ch, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KH, nc = d / VEC;
  const int kh = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int h0 = kh * G, t0 = s * split, n = min(split, T - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = tid & 15, row = tid >> 4;
  const bool has = c < nc;
  // rows padded by 16 bytes: a thread's 16-byte reads of its own row
  // meet no bank twice in a quarter-warp
  const int ld = d + 16 / (int)sizeof(E);
  E* kbuf = reinterpret_cast<E*>(smem);  // ch x ld, as stored
  E* vbuf = kbuf + ch * ld;              // ch x ld
  float* qs = reinterpret_cast<float*>(vbuf + ch * ld);  // G x d
  float* sc = qs + G * d;      // G x split: scores, then p
  float* ml = sc + G * split;  // G maxima, G sums
  float* red = ml + 2 * G;     // WARPS x GB x d: the PV partial sums

  const long rs = (long)KH * d;  // elements between key rows
  const E* kb = k + ((long)b * T + t0) * rs + (long)kh * d;
  const E* vb = v + ((long)b * T + t0) * rs + (long)kh * d;
  const int n_ch = (n + ch - 1) / ch;
  const bool resident = n_ch == 1;

  // every byte of the split in flight at once where it fits
  stage_rows(kbuf, ld, kb, min(ch, n), rs, d);
  commit();
  if (resident) stage_rows(vbuf, ld, vb, n, rs, d);
  commit();
  for (int i = tid; i < G * d; i += THREADS)
    qs[i] = to_f(q[((long)b * H + h0) * d + i]);

  // -- scores: a thread per key row, no shuffles; q read as broadcasts --
  for (int ci = 0; ci < n_ch; ++ci) {
    const int c0 = ci * ch, m = min(ch, n - c0);
    if (ci > 0) {
      __syncthreads();  // the last chunk's rows are read
      stage_rows(kbuf, ld, kb + c0 * rs, m, rs, d);
      commit();
      commit();
    }
    wait_groups<1>();  // K is in; V may still be coming
    __syncthreads();
    for (int g0 = 0; g0 < G; g0 += GB) {
      for (int t = tid; t < m; t += THREADS) {
        float a[GB];
#pragma unroll
        for (int gg = 0; gg < GB; ++gg) a[gg] = 0.f;
#pragma unroll 2
        for (int cc = 0; cc < nc; ++cc) {
          float kf[VEC];
          load8(kbuf + t * ld + cc * VEC, kf);
#pragma unroll
          for (int gg = 0; gg < GB; ++gg) {
            const float* qg = qs + min(g0 + gg, G - 1) * d + cc * VEC;
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              a[gg] = __fmaf_rn(qg[j], kf[j], a[gg]);
          }
        }
#pragma unroll
        for (int gg = 0; gg < GB; ++gg)
          if (g0 + gg < G) sc[(g0 + gg) * split + c0 + t] = a[gg] * scale;
      }
    }
  }
  __syncthreads();

  // -- the split's max, p and l: a warp per head --
  for (int g = warp; g < G; g += WARPS) {
    float* sg = sc + g * split;
    float mx = NEG_INF;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, sg[t]);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(sg[t] - mx);
      sg[t] = p;
      sum += p;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ml[g] = mx;
      ml[G + g] = sum;
    }
  }

  // -- acc = p v: lane c its chunk, summed over rows, then warps --
  const int hs = n_split * (d + 2);  // floats between heads in part
  float* pb = part + ((long)b * H + h0) * hs + (long)s * (d + 2);
  for (int g0 = 0; g0 < G; g0 += GB) {
    float acc[GB][VEC];
#pragma unroll
    for (int gg = 0; gg < GB; ++gg)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[gg][j] = 0.f;
    for (int ci = 0; ci < n_ch; ++ci) {
      const int c0 = ci * ch, m = min(ch, n - c0);
      if (!resident) {
        __syncthreads();  // the last chunk's rows are read
        stage_rows(vbuf, ld, vb + c0 * rs, m, rs, d);
        commit();
      }
      wait_groups<0>();
      __syncthreads();  // V, and the p of every head, are in
      for (int tb = row; tb - row < m; tb += ROWS * UNROLL) {
        float vf[UNROLL][VEC];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int t = tb + u * ROWS;
          if (has && t < m) {
            load8(vbuf + t * ld + c * VEC, vf[u]);
          } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j) vf[u][j] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int t = tb + u * ROWS;
          if (t < m) {
#pragma unroll
            for (int gg = 0; gg < GB; ++gg) {
              const float p =
                  g0 + gg < G ? sc[(g0 + gg) * split + c0 + t] : 0.f;
#pragma unroll
              for (int j = 0; j < VEC; ++j)
                acc[gg][j] = __fmaf_rn(p, vf[u][j], acc[gg][j]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int gg = 0; gg < GB; ++gg)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[gg][j] += __shfl_xor_sync(0xffffffffu, acc[gg][j], 16);
    if (lane < 16 && has) {
#pragma unroll
      for (int gg = 0; gg < GB; ++gg)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          red[(warp * GB + gg) * d + c * VEC + j] = acc[gg][j];
    }
    __syncthreads();
    for (int i = tid; i < GB * d; i += THREADS) {
      const int gg = i / d, col = i - gg * d;
      if (g0 + gg < G) {
        float a = 0.f;
        for (int w = 0; w < WARPS; ++w) a += red[(w * GB + gg) * d + col];
        pb[(long)(g0 + gg) * hs + col] = a;
      }
    }
    __syncthreads();  // red is free again
  }
  for (int g = tid; g < G; g += THREADS) {
    pb[(long)g * hs + d] = ml[g];
    pb[(long)g * hs + d + 1] = ml[G + g];
  }
}

// Pass 2: one block per (batch, head). Warp 0 takes m = max_s m_s, the
// weights w_s = exp(m_s - m) (into shared memory) and l = sum_s l_s w_s,
// 32 splits a step; then a thread per column sums acc_s w_s.
__global__ void __launch_bounds__(128)
    decode_merge(const float* __restrict__ part, float* __restrict__ acc,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int d, int n_split) {
  extern __shared__ float w[];  // n_split weights
  const long bh = blockIdx.x;
  const int tid = threadIdx.x;
  const float* pb = part + bh * n_split * (d + 2);
  if (tid < 32) {
    float m = NEG_INF;
    for (int s = tid; s < n_split; s += 32) m = fmaxf(m, pb[s * (d + 2) + d]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int s = tid; s < n_split; s += 32) {
      w[s] = expf(pb[s * (d + 2) + d] - m);
      l += pb[s * (d + 2) + d + 1] * w[s];
    }
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (tid == 0) {
      m_out[bh] = m;
      l_out[bh] = l;
    }
  }
  __syncthreads();
  for (int col = tid; col < d; col += blockDim.x) {
    float a = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) a += pb[s * (d + 2) + col] * w[s];
    acc[bh * d + col] = a;
  }
}

template <typename E, int GB>
cudaError_t launch_split(int B, int H, int KH, int T, int d, int split,
                         int n_split, const void* q, const void* k,
                         const void* v, float* part, float scale,
                         cudaStream_t stream) {
  const int G = H / KH, rowb = d * (int)sizeof(E) + 16;  // padded row
  const size_t fixed = sizeof(float) * ((size_t)G * d + (size_t)G * split +
                                        2 * G + (size_t)WARPS * GB * d);
  // key rows staged at once: the whole split where it fits the budget
  int ch = split;
  if (fixed + 2 * (size_t)ch * rowb > BUDGET) {
    const long room = (long)BUDGET - (long)fixed;
    ch = max(ROWS, (int)(room / (2 * rowb)) / ROWS * ROWS);
  }
  const size_t smem = fixed + 2 * (size_t)ch * rowb;
  cudaError_t err = cudaFuncSetAttribute(
      decode_split<E, GB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  decode_split<E, GB><<<dim3(KH, n_split, B), THREADS, smem, stream>>>(
      (const E*)q, (const E*)k, (const E*)v, part, H, KH, T, d, split,
      n_split, ch, scale);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch(int B, int H, int KH, int T, int d, int split,
                   const void* q, const void* k, const void* v, void* part,
                   void* acc, void* m, void* l, float scale,
                   cudaStream_t stream) {
  if (d % VEC || d > 16 * VEC || split < 1 || H % KH)
    return cudaErrorInvalidValue;
  const int G = H / KH, n_split = (T + split - 1) / split;
  if (n_split > 0) {
    cudaError_t err;
    float* p = (float*)part;
    if (G == 1)
      err = launch_split<E, 1>(B, H, KH, T, d, split, n_split, q, k, v, p,
                               scale, stream);
    else if (G == 2)
      err = launch_split<E, 2>(B, H, KH, T, d, split, n_split, q, k, v, p,
                               scale, stream);
    else if (G <= 4)
      err = launch_split<E, 4>(B, H, KH, T, d, split, n_split, q, k, v, p,
                               scale, stream);
    else
      err = launch_split<E, 8>(B, H, KH, T, d, split, n_split, q, k, v, p,
                               scale, stream);
    if (err != cudaSuccess) return err;
  }
  const size_t wbytes = sizeof(float) * n_split;
  if (wbytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)wbytes);
    if (err != cudaSuccess) return err;
  }
  decode_merge<<<B * H, 128, wbytes, stream>>>(
      (const float*)part, (float*)acc, (float*)m, (float*)l, d, n_split);
  return cudaGetLastError();
}

}  // namespace fd

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k and v alike). part: float32 scratch
// of B * H * ceil(T / split) * (d + 2) values.
int flash_decode_partial_run(int dtype, int B, int H, int KH, int T, int d,
                             int split, const void* q, const void* k,
                             const void* v, void* part, void* acc, void* m,
                             void* l, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)fd::launch<__nv_bfloat16>(B, H, KH, T, d, split, q, k, v,
                                          part, acc, m, l, scale, s);
  return (int)fd::launch<float>(B, H, KH, T, d, split, q, k, v, part, acc,
                                m, l, scale, s);
}

// The first pass's block: out = {threads, key rows of a PV step, rows a
// half-warp takes a PV step, values a chunk, shared bytes budgeted}.
// Returns the number written.
int flash_decode_config(int* out) {
  const int v[5] = {fd::THREADS, fd::ROWS, fd::UNROLL, fd::VEC, fd::BUDGET};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 5;
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
