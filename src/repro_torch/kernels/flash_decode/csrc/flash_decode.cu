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
// H. A block serves one (batch, kv head) and its G = H / KH query heads:
// the kv head is read once, never repeated to H heads (the reference's
// jnp.repeat reads G times the bytes). Outputs float32: acc (B, H, d),
// m (B, H), l (B, H).
//
// Bound: bytes. At the serving shape (h2o-danube-1.8b decode, B=4,
// T=4096, KH=8, d=80) k and v are 41.9 MB against ~0.1 Mflop a head.
// This first kernel walks the cache in chunks of 128 keys: the chunk of
// K, then of V, staged in shared memory as float32 (coalesced loads,
// row stride d + 1), the G x 128 scores in shared memory, one warp per
// head for the chunk's max / alpha / p / l, one thread per output
// (head, column) for acc. The arithmetic is the reference's
// (kernel.py:23-56): m starts at -1e30, alpha = exp(m - m_new),
// p = exp(s - m_new), l = l alpha + sum p, acc = acc alpha + p v, all in
// float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fd {

constexpr int THREADS = 256;
constexpr int CH = 128;      // keys a chunk
constexpr int MAXOUT = 32;   // outputs (head, column) a thread: G d <= 8192
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// n rows of d values, row stride ``stride`` elements, into dst (stride ld)
template <typename E>
__device__ void load_rows(float* dst, int ld, const E* __restrict__ src,
                          int n, long stride, int d) {
  for (int i = threadIdx.x; i < n * d; i += THREADS) {
    const int r = i / d, c = i - r * d;
    dst[r * ld + c] = to_f(src[r * stride + c]);
  }
}

template <typename E>
__global__ void __launch_bounds__(THREADS)
    decode_partial(const E* __restrict__ q, const E* __restrict__ k,
                   const E* __restrict__ v, float* __restrict__ acc_out,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int H, int KH, int T, int d, float scale) {
  extern __shared__ float smem[];
  const int G = H / KH, ld = d + 1;
  float* qs = smem;             // G x d
  float* sc = qs + G * d;       // G x CH: scores, then p
  float* kv = sc + G * CH;      // CH x ld: the chunk of K, then of V
  float* ms = kv + CH * ld;     // G running max
  float* ls = ms + G;           // G running denominator
  float* al = ls + G;           // G this chunk's alpha

  const int kh = blockIdx.x, b = blockIdx.y, h0 = kh * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long rs = (long)KH * d;
  const E* kb = k + (long)b * T * rs + (long)kh * d;
  const E* vb = v + (long)b * T * rs + (long)kh * d;

  load_rows(qs, d, q + ((long)b * H + h0) * d, G, d, d);
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }
  float acc[MAXOUT];
#pragma unroll
  for (int r = 0; r < MAXOUT; ++r) acc[r] = 0.f;

  for (int t0 = 0; t0 < T; t0 += CH) {
    const int n = min(CH, T - t0);
    __syncthreads();  // the last chunk's V and p are read
    load_rows(kv, ld, kb + t0 * rs, n, rs, d);
    __syncthreads();
    for (int i = tid; i < G * n; i += THREADS) {
      const int g = i / n, t = i - g * n;
      float s = 0.f;
      for (int c = 0; c < d; ++c)
        s = __fmaf_rn(qs[g * d + c], kv[t * ld + c], s);
      sc[g * CH + t] = s * scale;
    }
    __syncthreads();
    // the chunk's V goes in while the warps turn scores into p
    load_rows(kv, ld, vb + t0 * rs, n, rs, d);
    for (int g = warp; g < G; g += THREADS / 32) {
      float mx = NEG_INF;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, sc[g * CH + t]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(ms[g], mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(sc[g * CH + t] - m_new);
        sc[g * CH + t] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(ms[g] - m_new);
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
        al[g] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MAXOUT; ++r) {
      const int o = tid + r * THREADS;
      if (o < G * d) {
        const int g = o / d, c = o - g * d;
        float a = acc[r] * al[g];
        for (int t = 0; t < n; ++t)
          a = __fmaf_rn(sc[g * CH + t], kv[t * ld + c], a);
        acc[r] = a;
      }
    }
  }

  const long base = ((long)b * H + h0);
#pragma unroll
  for (int r = 0; r < MAXOUT; ++r) {
    const int o = tid + r * THREADS;
    if (o < G * d) acc_out[base * d + o] = acc[r];
  }
  for (int g = tid; g < G; g += THREADS) {
    m_out[base + g] = ms[g];
    l_out[base + g] = ls[g];
  }
}

template <typename E>
cudaError_t launch(int B, int H, int KH, int T, int d, const void* q,
                   const void* k, const void* v, void* acc, void* m, void* l,
                   float scale, cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem =
      sizeof(float) * (G * d + G * CH + CH * (d + 1) + 3 * G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  decode_partial<E><<<dim3(KH, B), THREADS, smem, stream>>>(
      (const E*)q, (const E*)k, (const E*)v, (float*)acc, (float*)m,
      (float*)l, H, KH, T, d, scale);
  return cudaGetLastError();
}

}  // namespace fd

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k and v alike)
int flash_decode_partial_run(int dtype, int B, int H, int KH, int T, int d,
                             const void* q, const void* k, const void* v,
                             void* acc, void* m, void* l, float scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)fd::launch<__nv_bfloat16>(B, H, KH, T, d, q, k, v, acc, m, l,
                                          scale, s);
  return (int)fd::launch<float>(B, H, KH, T, d, q, k, v, acc, m, l, scale,
                                s);
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
