// flash_attention: tiled online-softmax attention forward, causal and
// sliding-window masks with tile skipping, GQA read in place.
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention_bhsd
// (the Pallas TPU kernel behind models/attention.py impl "flash").
//
// Layout: q (B, Sq, H, d), k/v (B, Sk, KH, d) with KH dividing H, the
// model's own layouts: no transpose, no padding, no broadcast of the kv
// heads (query head h reads kv head h / (H / KH)). Output (B, Sq, H, d)
// in the input type.
//
// Bound: operations. At the serving shape (h2o-danube-1.8b prefill,
// B=4, S=8192, H=32, d=80, window 4096) a call does ~1.03e12 flops over
// ~0.42 GB. This first kernel runs them in float32 on the CUDA cores (no
// tensor cores, no TMA): one block of 256 threads per (64-query tile,
// batch x head); the kv loop visits only the 64-key tiles that the
// causal and window conditions leave (kernel.py:39-44). Q, K and V tiles
// sit in shared memory as float32 (row stride d + 1: conflict-free
// column reads); each thread holds a 4 x 4 block of the score tile and
// 4 rows x ceil(d / 16) columns of the output accumulator in registers.
//
// Arithmetic as the reference: q/k/v to float32, s = q.k * scale, masked
// entries -1e30 (never -inf: a row whose first visited tile is all
// masked gets p = exp(0) = 1 there, which the first real score wipes
// with alpha = 0; -inf would give NaN), p stays float32 in the PV
// product, the output is acc / max(l, 1e-30) rounded to nearest even.
// Keys are masked by the true length Sk: nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fa {

constexpr int BQ = 64;        // queries a block
constexpr int BK = 64;        // keys a tile
constexpr int THREADS = 256;  // 16 row groups x 16 column threads
constexpr int MAXD = 128;
constexpr int NCOL = MAXD / 16;  // output columns a thread, at most
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// rows [r0, r0 + 64) of one head of a (B, S, heads, d) tensor, ``src``
// pointing at (b, 0, head, 0); rows at or past n read as zero
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                          int r0, int n, long row_stride, int d) {
  for (int i = threadIdx.x; i < BQ * d; i += THREADS) {
    const int r = i / d, c = i - r * d, row = r0 + r;
    dst[r * ld + c] = row < n ? to_f(src[row * row_stride + c]) : 0.f;
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
              int H, int KH, int d, float scale, int causal, int window) {
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
  const T* qb = q + (long)b * Sq * qrs + (long)h * d;
  const T* kb = k + (long)b * Sk * krs + (long)kh * d;
  const T* vb = v + (long)b * Sk * krs + (long)kh * d;

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

  T* ob = o + (long)b * Sq * qrs + (long)h * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * grp + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < NCOL; ++cc) {
      const int c = tx + 16 * cc;
      if (c < d) ob[row * qrs + c] = from_f<T>(acc[i][cc] / denom);
    }
  }
}

template <typename T>
cudaError_t launch(int B, int Sq, int Sk, int H, int KH, int d,
                   const void* q, const void* k, const void* v, void* o,
                   float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * BQ * (d + 1) + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Sk, H, KH, d, scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace fa

extern "C" {

// dtype: 0 float32, 1 bfloat16. window <= 0: none.
int flash_attention_run(int dtype, int B, int Sq, int Sk, int H, int KH,
                        int d, const void* q, const void* k, const void* v,
                        void* o, float scale, int causal, int window,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)fa::launch<__nv_bfloat16>(B, Sq, Sk, H, KH, d, q, k, v, o,
                                          scale, causal, window, s);
  return (int)fa::launch<float>(B, Sq, Sk, H, KH, d, q, k, v, o, scale,
                                causal, window, s);
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
