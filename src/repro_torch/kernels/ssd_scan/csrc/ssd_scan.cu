// ssd_scan: the chunked Mamba-2 SSD (state-space duality) scan, forward.
//
// Replaces repro/kernels/ssd_scan/kernel.py:ssd_scan_bhsp (the Pallas TPU
// kernel; grid (B, H, n_chunks), the running (P, N) state in VMEM scratch
// across the chunk axis). Here the chunk axis is a loop inside the block,
// with the state in shared memory: Hopper's blocks run in no order.
//
// Per (batch b, head h) and chunk of Q positions, in order over the
// chunks (kernel.py:19-53):
//   l = dt * A,  cum = inclusive prefix sum of l
//   y_i = exp(cum_i) (C_i . state_p)
//       + sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   state <- exp(cum_Q) state + sum_j x_j (B_j exp(cum_Q - cum_j) dt_j)
// and the final state is written out (float32), the counterpart of
// models/ssm.py:ssd_chunked's (y, S_fin).
//
// Layout: the model's own, read in place through its strides: x and y
// (B, S, H, P), dt (B, S, H) float32, B and C (B, S, N), A (H,) float32,
// state0 / state (B, H, P, N) float32. No transpose.
//
// Grid (B * H, P / PB): a block owns PB columns of the state (rows p of
// the (P, N) state are independent: y[:, p], state row p and its update
// read only column p of x), so the (B, H) = 192 pairs of the serving
// shape fill the 132 SMs in more, smaller blocks, at the cost of
// recomputing C B^T in each. Intra-chunk the SSD is causal attention with
// a decay mask; it is tiled like flash_attention.cu over 64-row query
// and key sub-tiles, visiting only the tiles on or below the diagonal.
// The decay exp(cum_i - cum_j) is computed only for i >= j: for i < j it
// is exp of a positive number and can overflow (the reference masks it
// with `where`, kernel.py:43-46; a 0/1 multiply would give inf * 0 =
// NaN).
//
// Bound: bytes at the serving shape (mamba2-130m prefill, B=8, S=32768,
// H=24, P=64, N=128, Q=256): x, y bf16, dt float32, B and C bf16 read
// once, ~1.8 GB a layer; C B^T counted once per (batch, chunk) and the
// rest per head, ~4e11 flops, which a tensor-core kernel would run under
// the byte time. This first kernel does all its arithmetic in float32 on
// the CUDA cores (no tensor cores, no TMA): it is bound by its own
// instruction issue, far above the bound.
//
// Numbers: inputs to float32, y rounded once to x's type. cum is the
// float32 rounding of the prefix sum accumulated in float64 (a warp
// scan), so the kernel and its plain version (ref.py:ssd_scan_plain,
// torch.cumsum in float64) agree whatever their summation order; an
// error in cum would be amplified by exp over long decays.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ssd {

constexpr int TQ = 64;        // rows of a query / key sub-tile
constexpr int THREADS = 256;  // 16 row groups x 16 column threads
constexpr int MAXN = 128;     // d_state
constexpr int MAXQ = 256;     // chunk length
constexpr int WLD = TQ + 4;   // row stride of the weight tile

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// a += u . v over four terms, in order
__device__ __forceinline__ float dot4(float4 u, float4 v, float a) {
  a = __fmaf_rn(u.x, v.x, a);
  a = __fmaf_rn(u.y, v.y, a);
  a = __fmaf_rn(u.z, v.z, a);
  return __fmaf_rn(u.w, v.w, a);
}

// rows [r0, r0 + TQ) of a row-major (rows, cols) view with ``stride``
// elements between rows, into dst (row stride ld) as float32; rows at or
// past ``n`` read as zero
template <typename T>
__device__ void load_rows(float* dst, int ld, const T* __restrict__ src,
                          int r0, int n, long stride, int cols) {
  for (int i = threadIdx.x; i < TQ * cols; i += THREADS) {
    const int r = i / cols, c = i - r * cols, row = r0 + r;
    dst[r * ld + c] = row < n ? to_f(src[row * stride + c]) : 0.f;
  }
}

// N: a power of two from 4 to MAXN (rows of N + 4 floats: 16-byte
// aligned, and float4 reads of 8 rows hit 32 distinct banks); a thread
// owns state entries (p, n) with n = tid % N, p = tid / N + k * 256 / N
template <typename T, int PB>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_fwd(const T* __restrict__ x, const float* __restrict__ dt,
                 const T* __restrict__ Bm, const T* __restrict__ Cm,
                 const float* __restrict__ A,
                 const float* __restrict__ state0, T* __restrict__ y,
                 float* __restrict__ state_out, int S, int H, int P, int N,
                 int Q) {
  constexpr int CP = PB / 16;                  // output columns a thread
  constexpr int KS = PB * MAXN / THREADS;      // state entries a thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = N + 4;
  float* sS = smem;                            // PB x ld   running state
  float* sC = sS + PB * ld;                    // TQ x ld   C sub-tile
  float* sB = sC + TQ * ld;                    // TQ x ld   B sub-tile
  float* sX = sB + TQ * ld;                    // TQ x PB   x sub-tile
  float* sW = sX + TQ * PB;                    // TQ x WLD  weights
  float* sDt = sW + TQ * WLD;                  // Q
  float* sCum = sDt + Q;                       // Q
  float* sEc = sCum + Q;                       // Q  exp(cum_i)
  float* sWe = sEc + Q;                        // Q  exp(cum_Q - cum_j) dt_j

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int p0 = blockIdx.y * PB;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_t = tid & (N - 1), p_t = tid / N, p_step = THREADS / N;
  const float Ah = A[h];
  const long xrs = (long)H * P;                // x / y row stride
  const T* xb = x + (long)b * S * xrs + (long)h * P + p0;
  T* yb = y + (long)b * S * xrs + (long)h * P + p0;
  const float* dtb = dt + (long)b * S * H + h;
  const T* Bb = Bm + (long)b * S * N;
  const T* Cb = Cm + (long)b * S * N;
  const long so = ((long)b * H + h) * P * N + (long)p0 * N;

  for (int e = tid; e < PB * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    sS[p * ld + n] = state0 ? state0[so + e] : 0.f;
  }

  const int nI = (Q + TQ - 1) / TQ;
  const int nc = S / Q;
  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    __syncthreads();  // the last chunk's state and tables are written
    for (int q = tid; q < Q; q += THREADS) sDt[q] = dtb[(long)(s0 + q) * H];
    __syncthreads();
    if (warp == 0) {
      // inclusive prefix sum of l = dt * A in float64: each lane a run of
      // ``per`` positions, then a scan of the runs' sums over the warp
      const int per = (Q + 31) / 32, q0 = lane * per;
      double run = 0.0;
      for (int k = 0; k < per; ++k)
        if (q0 + k < Q) run += (double)(sDt[q0 + k] * Ah);
      double incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      double acc = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) acc = 0.0;
      for (int k = 0; k < per; ++k)
        if (q0 + k < Q) {
          acc += (double)(sDt[q0 + k] * Ah);
          sCum[q0 + k] = (float)acc;
        }
    }
    __syncthreads();
    const float cum_last = sCum[Q - 1];
    for (int q = tid; q < Q; q += THREADS) {
      sEc[q] = expf(sCum[q]);
      sWe[q] = expf(cum_last - sCum[q]) * sDt[q];
    }

    float acc_s[KS];
#pragma unroll
    for (int k = 0; k < KS; ++k) acc_s[k] = 0.f;

    for (int I = 0; I < nI; ++I) {
      const int i0 = I * TQ;
      const bool last = I == nI - 1;
      load_rows(sC, ld, Cb + (long)s0 * N, i0, Q, N, N);
      __syncthreads();

      // inter-chunk: C_i . state_p on rows ty + 16 r, columns tx + 16 cc
      float yi[4][CP], ya[4][CP];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < CP; ++cc) yi[r][cc] = ya[r][cc] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], sv[CP];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ld4(sC + (ty + 16 * r) * ld + n);
#pragma unroll
        for (int cc = 0; cc < CP; ++cc)
          sv[cc] = ld4(sS + (tx + 16 * cc) * ld + n);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < CP; ++cc)
            yi[r][cc] = dot4(cv[r], sv[cc], yi[r][cc]);
      }

      for (int J = 0; J <= I; ++J) {
        const int j0 = J * TQ;
        load_rows(sB, ld, Bb + (long)s0 * N, j0, Q, N, N);
        load_rows(sX, PB, xb + (long)s0 * xrs, j0, Q, xrs, PB);
        __syncthreads();

        // W_ij = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i < Q
        float g[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) g[r][k] = 0.f;
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cv[r] = ld4(sC + (ty + 16 * r) * ld + n);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            bv[k] = ld4(sB + (tx + 16 * k) * ld + n);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) g[r][k] = dot4(cv[r], bv[k], g[r][k]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ty + 16 * r, gi = i0 + i;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = tx + 16 * k, gj = j0 + j;
            float w = 0.f;
            if (gj <= gi && gi < Q)
              w = g[r][k] * expf(sCum[gi] - sCum[gj]) * sDt[gj];
            sW[i * WLD + j] = w;
          }
        }
        __syncthreads();

        // intra-chunk: y_i += sum_j W_ij x_j
        for (int j = 0; j < TQ; j += 4) {
          float4 wv[4];
          float xv[4][CP];
#pragma unroll
          for (int r = 0; r < 4; ++r) wv[r] = ld4(sW + (ty + 16 * r) * WLD + j);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int cc = 0; cc < CP; ++cc)
              xv[jj][cc] = sX[(j + jj) * PB + tx + 16 * cc];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < CP; ++cc)
              ya[r][cc] = dot4(wv[r], make_float4(xv[0][cc], xv[1][cc],
                                                  xv[2][cc], xv[3][cc]),
                               ya[r][cc]);
        }

        // the last query tile visits every key tile: the state's input
        // sum_j x_jp (B_jn exp(cum_Q - cum_j) dt_j) rides along
        if (last) {
          const int jn = min(TQ, Q - j0);
          for (int j = 0; j < jn; ++j) {
            const float bw = sB[j * ld + n_t] * sWe[j0 + j];
#pragma unroll
            for (int k = 0; k < KS; ++k) {
              const int p = p_t + k * p_step;
              if (p < PB) acc_s[k] = __fmaf_rn(sX[j * PB + p], bw, acc_s[k]);
            }
          }
        }
        __syncthreads();  // sB, sX and sW are read
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gi = i0 + ty + 16 * r;
        if (gi >= Q) continue;
        const float ec = sEc[gi];
        T* yrow = yb + (long)(s0 + gi) * xrs;
#pragma unroll
        for (int cc = 0; cc < CP; ++cc)
          yrow[tx + 16 * cc] = from_f<T>(yi[r][cc] * ec + ya[r][cc]);
      }
    }

    // the carry: state <- exp(cum_Q) state + the input sum (own entries)
    const float decay = expf(cum_last);
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int p = p_t + k * p_step;
      if (p < PB) sS[p * ld + n_t] = sS[p * ld + n_t] * decay + acc_s[k];
    }
  }

  __syncthreads();
  for (int e = tid; e < PB * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    state_out[so + e] = sS[p * ld + n];
  }
}

inline size_t smem_bytes(int PB, int N, int Q) {
  return sizeof(float) *
         ((size_t)(PB + 2 * TQ) * (N + 4) + TQ * PB + TQ * WLD + 4 * Q);
}

template <typename T, int PB>
cudaError_t launch(int B, int S, int H, int P, int N, int Q, const void* x,
                   const void* dt, const void* Bm, const void* Cm,
                   const void* A, const void* state0, void* y, void* state,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(PB, N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_fwd<T, PB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, P / PB);
  ssd_scan_fwd<T, PB><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const float*)dt, (const T*)Bm, (const T*)Cm,
      (const float*)A, (const float*)state0, (T*)y, (float*)state, S, H, P,
      N, Q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_pb(int pb, int B, int S, int H, int P, int N, int Q,
                      const void* x, const void* dt, const void* Bm,
                      const void* Cm, const void* A, const void* state0,
                      void* y, void* state, cudaStream_t stream) {
  switch (pb) {
    case 16:
      return launch<T, 16>(B, S, H, P, N, Q, x, dt, Bm, Cm, A, state0, y,
                           state, stream);
    case 32:
      return launch<T, 32>(B, S, H, P, N, Q, x, dt, Bm, Cm, A, state0, y,
                           state, stream);
    case 64:
      return launch<T, 64>(B, S, H, P, N, Q, x, dt, Bm, Cm, A, state0, y,
                           state, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ssd

extern "C" {

// dtype (of x, B, C and y): 0 float32, 1 bfloat16. pb: state columns a
// block, 16, 32 or 64, dividing P. N a power of two from 4 to 128,
// 1 <= Q <= 256, S % Q == 0. state0 may be null (a zero state).
int ssd_scan_run(int dtype, int pb, int B, int S, int H, int P, int N,
                 int Q, const void* x, const void* dt, const void* Bm,
                 const void* Cm, const void* A, const void* state0, void* y,
                 void* state, void* stream) {
  if (P % pb || N < 4 || N > ssd::MAXN || (N & (N - 1)) || Q < 1 ||
      Q > ssd::MAXQ || S % Q)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)ssd::launch_pb<__nv_bfloat16>(pb, B, S, H, P, N, Q, x, dt,
                                              Bm, Cm, A, state0, y, state,
                                              s);
  return (int)ssd::launch_pb<float>(pb, B, S, H, P, N, Q, x, dt, Bm, Cm, A,
                                    state0, y, state, s);
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
