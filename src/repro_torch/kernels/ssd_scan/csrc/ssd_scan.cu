// ssd_scan: the chunked Mamba-2 SSD (state-space duality) scan, forward.
//
// Replaces repro/kernels/ssd_scan/kernel.py:ssd_scan_bhsp (the Pallas TPU
// kernel; grid (B, H, n_chunks), the running (P, N) state in VMEM scratch
// across the chunk axis).
//
// Per (batch b, head h) and chunk of Q positions (kernel.py:19-53):
//   l = dt * A,  cum = inclusive prefix sum of l
//   y_i = exp(cum_i) (C_i . state_p)
//       + sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   state <- exp(cum_Q) state + sum_j x_j (B_j exp(cum_Q - cum_j) dt_j)
// and the final state is written out (float32), the counterpart of
// models/ssm.py:ssd_chunked's (y, S_fin).
//
// Layout: the model's own, read in place: x and y (B, S, H, P), dt
// (B, S, H) float32, B and C (B, S, N), A (H,) float32, state0 / state
// (B, H, P, N) float32. No transpose.
//
// Two routes, by the type of x, B and C:
//
// * bfloat16, the serving route (ssd_scan_bf16_run): Mamba-2's own chunked
//   algorithm in four launches, every product on the tensor cores
//   (mma.sync m16n8k16, bf16 operands, float32 accumulation):
//     1. ssd_cum: cum for every (b, chunk, h), a thread each, into a
//        (B, S, H) float32 scratch;
//     2. ssd_chunk_state: a block per (b, chunk) keeps the chunk's B in
//        shared memory and, head by head, writes the chunk's state input
//        (x o w_end)^T B (P x N, w_end_j = exp(cum_Q - cum_j) dt_j) into a
//        (B, n_chunks, H, P, N) float32 scratch;
//     3. ssd_state_pass: a thread per 4 state entries of a (b, h) walks
//        the chunks (elementwise, the only sequential pass; the loads of 8
//        chunks in flight at once), writes the state at each chunk's start
//        as bf16 hi and lo planes into a second scratch of the same size,
//        and the final state in float32;
//     4. ssd_chunk_out: a block of 8 warps per (b, chunk, 64 query rows)
//        computes G = C B^T once for all the heads (its rows, the columns
//        on and below the diagonal, float32 in shared memory), then head
//        by head y = exp(cum_i) (C . state^T) + (G o decay o dt) x, two
//        warps to 16 rows, each summing half of the products.
//   The serving shape's 384 serial chains become 24,576 independent tiles.
//   Tiles reach shared memory by cp.async, every copy of a tile in flight
//   at once.
//   float32 operands enter a bf16 product as hi + lo halves (W = G o decay
//   o dt, x o w_end and the state: hi = bf16(v), lo = bf16(v - hi), so the
//   pair carries v to ~2^-16); bf16 x, B and C enter as they are. The
//   decay exp(cum_i - cum_j) is formed only where i >= j (above the
//   diagonal it is exp of a positive number and can overflow).
//   ref.py:ssd_scan_hilo_plain rounds the same way.
//
// * float32, a check route (ssd_scan_f32_run): one launch, grid
//   (B * H, P / PB); a block owns PB columns of the state and loops over
//   the chunks with the state in shared memory, everything in float32 on
//   the CUDA cores, tiled over 64-row sub-tiles on and below the diagonal.
//
// Bound: bytes at the serving shape (mamba2-130m prefill, B=8, S=32768,
// H=24, P=64, N=128, Q=256): x, y bf16, dt float32, B and C bf16 read
// once, ~1.8 GB a layer. The bf16 route also moves its scratches (cum;
// the chunks' state inputs, 0.8 GB of float32 written and read once; the
// states as hi and lo planes, 0.8 GB written once and read by each
// query-row block of their (b, chunk), from L2 where its neighbours just
// read them, like x).
//
// Numbers: cum is the float32 rounding of the prefix sum accumulated in
// float64, so the kernels and their plain versions (ref.py, torch.cumsum
// in float64) agree whatever their summation order; an error in cum would
// be amplified by exp over long decays. y is rounded once to x's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

// ---------------------------------------------------------------------------
// The float32 route on the CUDA cores.
// ---------------------------------------------------------------------------

namespace ssd {

constexpr int TQ = 64;        // rows of a query / key sub-tile
constexpr int THREADS = 256;  // 16 row groups x 16 column threads
constexpr int MAXN = 128;     // d_state
constexpr int MAXQ = 256;     // chunk length
constexpr int WLD = TQ + 4;   // row stride of the weight tile

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
__device__ void load_rows(float* dst, int ld, const float* __restrict__ src,
                          int r0, int n, long stride, int cols) {
  for (int i = threadIdx.x; i < TQ * cols; i += THREADS) {
    const int r = i / cols, c = i - r * cols, row = r0 + r;
    dst[r * ld + c] = row < n ? src[row * stride + c] : 0.f;
  }
}

// N: a power of two from 4 to MAXN (rows of N + 4 floats: 16-byte
// aligned, and float4 reads of 8 rows hit 32 distinct banks); a thread
// owns state entries (p, n) with n = tid % N, p = tid / N + k * 256 / N
template <int PB>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_fwd(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 const float* __restrict__ A,
                 const float* __restrict__ state0, float* __restrict__ y,
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
  const float* xb = x + (long)b * S * xrs + (long)h * P + p0;
  float* yb = y + (long)b * S * xrs + (long)h * P + p0;
  const float* dtb = dt + (long)b * S * H + h;
  const float* Bb = Bm + (long)b * S * N;
  const float* Cb = Cm + (long)b * S * N;
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
        float* yrow = yb + (long)(s0 + gi) * xrs;
#pragma unroll
        for (int cc = 0; cc < CP; ++cc)
          yrow[tx + 16 * cc] = yi[r][cc] * ec + ya[r][cc];
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

template <int PB>
cudaError_t launch(int B, int S, int H, int P, int N, int Q, const void* x,
                   const void* dt, const void* Bm, const void* Cm,
                   const void* A, const void* state0, void* y, void* state,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(PB, N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_fwd<PB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, P / PB);
  ssd_scan_fwd<PB><<<grid, THREADS, smem, stream>>>(
      (const float*)x, (const float*)dt, (const float*)Bm, (const float*)Cm,
      (const float*)A, (const float*)state0, (float*)y, (float*)state, S, H, P,
      N, Q);
  return cudaGetLastError();
}

cudaError_t launch_pb(int pb, int B, int S, int H, int P, int N, int Q,
                      const void* x, const void* dt, const void* Bm,
                      const void* Cm, const void* A, const void* state0,
                      void* y, void* state, cudaStream_t stream) {
  switch (pb) {
    case 16:
      return launch<16>(B, S, H, P, N, Q, x, dt, Bm, Cm, A, state0, y,
                           state, stream);
    case 32:
      return launch<32>(B, S, H, P, N, Q, x, dt, Bm, Cm, A, state0, y,
                           state, stream);
    case 64:
      return launch<64>(B, S, H, P, N, Q, x, dt, Bm, Cm, A, state0, y,
                           state, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ssd

// ---------------------------------------------------------------------------
// The bf16 route on the tensor cores.
// ---------------------------------------------------------------------------

namespace ssd_tc {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 128;  // 4 warps
constexpr int ROWS = 64;      // query rows of an output block: 16 a warp

__device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

// not volatile: the operands carry every dependency, so the compiler may
// interleave independent products
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed: lane l gives the address of row
// l % 8 of matrix l / 8 and receives, of matrix q, the elements (rows
// 2 (l % 4) and 2 (l % 4) + 1, column l / 4) in register q.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// (v0, v1) as bf16 pairs hi = bf16(v) and lo = bf16(v - hi)
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __float22bfloat162_rn(make_float2(v0, v1));
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l =
      __float22bfloat162_rn(make_float2(v0 - hf.x, v1 - hf.y));
  hi = pack(h.x, h.y);
  lo = pack(l.x, l.y);
}

__device__ __forceinline__ float lo_f(uint32_t r) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(r & 0xffffu)));
}
__device__ __forceinline__ float hi_f(uint32_t r) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(r >> 16)));
}

// 16 bytes global -> shared without a register round trip; zeros where
// `valid` is false (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 4 bytes global -> shared, zero where `valid` is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rows [0, rows) x columns [0, cols_pad) of a row-major bf16 view (row
// stride `stride` elements) into dst (row stride ld); rows at or past
// `valid` and columns at or past `cols` read as zero. 16-byte cp.async
// chunks, all in flight at once, where cols allows (the caller waits
// with cp_async_wait_all before its barrier), else elements. `threads`:
// the block's.
__device__ void load_bf16(bf16* dst, int ld, const bf16* __restrict__ src,
                          long stride, int rows, int valid, int cols,
                          int cols_pad, int threads = THREADS) {
  if (cols % 8 == 0) {
    const int vr = cols_pad / 8;
    for (int t = threadIdx.x; t < rows * vr; t += threads) {
      const int r = t / vr, c = (t - r * vr) * 8;
      const bool ok = r < valid && c < cols;
      cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int t = threadIdx.x; t < rows * cols_pad; t += threads) {
      const int r = t / cols_pad, c = t - r * cols_pad;
      dst[r * ld + c] = (r < valid && c < cols) ? src[r * stride + c]
                                                : __float2bfloat16_rn(0.f);
    }
  }
}

// 1. cum[b, s, h] for every position: the float32 rounding of the float64
// prefix sum of dt * A over its chunk (a thread per (b, chunk, h))
__global__ void ssd_cum(const float* __restrict__ dt,
                        const float* __restrict__ A, float* __restrict__ cum,
                        int B, int S, int H, int Q) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)B * (S / Q) * H) return;
  const int h = (int)(t % H);
  const long row0 = (t / H) * Q;  // b * S + c * Q
  const float Ah = A[h];
  double acc = 0.0;
  for (int i = 0; i < Q; ++i) {
    const long o = (row0 + i) * H + h;
    acc += (double)(dt[o] * Ah);
    cum[o] = (float)acc;
  }
}

// 2. The chunk's state input sum_j (x_j w_j)^T B_j, w_j = exp(cum_Q -
// cum_j) dt_j, for every head, into states[b, c, h] (P x N). A block per
// (b, chunk); the head's columns in passes of PB, a warp a 16-row tile of
// p over all NT * 8 (padded) columns of n.
template <int NT>
__global__ void __launch_bounds__(THREADS)
    ssd_chunk_state(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const bf16* __restrict__ Bm,
                    const float* __restrict__ cum, float* __restrict__ states,
                    int S, int H, int P, int N, int Q, int PB) {
  constexpr int NP = NT * 8;
  const int QP = round16(Q), ldb = NP + 8, ldx = PB + 8, nc = S / Q;
  extern __shared__ uint4 smem_a[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_a);  // QP x ldb
  bf16* Xs = Bs + QP * ldb;                      // QP x ldx
  float* w = reinterpret_cast<float*>(Xs + QP * ldx);  // QP
  const int bc = blockIdx.x, b = bc / nc, c = bc - b * nc;
  const long row0 = (long)bc * Q;  // b * S + c * Q
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, t4 = lane & 3, lm = lane >> 3, lr = lane & 7;

  load_bf16(Bs, ldb, Bm + row0 * N, N, QP, Q, N, NP);  // waited below
  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the last head's w and Xs are read
    const float last = cum[(row0 + Q - 1) * H + h];
    for (int j = threadIdx.x; j < QP; j += THREADS) {
      float v = 0.f;
      if (j < Q) {
        const long o = (row0 + j) * H + h;
        v = expf(last - cum[o]) * dt[o];
      }
      w[j] = v;
    }
    for (int p0 = 0; p0 < P; p0 += PB) {
      if (p0) __syncthreads();
      load_bf16(Xs, ldx, x + (row0 * H + h) * P + p0, (long)H * P, QP, Q, PB,
                PB);
      cp_async_wait_all();
      __syncthreads();
      if (warp * 16 >= PB) continue;
      const int pw = warp * 16;
      float acc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      for (int j0 = 0; j0 < QP; j0 += 16) {
        // A = (x o w)^T: rows p, columns j
        uint32_t xa[4], ahi[4], alo[4];
        ldsm_x4_trans(xa, Xs + (j0 + lr + ((lm >> 1) << 3)) * ldx + pw +
                              ((lm & 1) << 3));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + 2 * t4 + ((q >> 1) << 3);
          split(lo_f(xa[q]) * w[j], hi_f(xa[q]) * w[j + 1], ahi[q], alo[q]);
        }
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, Bs + (j0 + lr + ((lm & 1) << 3)) * ldb + n * 8 +
                                ((lm >> 1) << 3));
          mma(acc[n], ahi, bb[0], bb[1]);
          mma(acc[n], alo, bb[0], bb[1]);
          mma(acc[n + 1], ahi, bb[2], bb[3]);
          mma(acc[n + 1], alo, bb[2], bb[3]);
        }
      }
      float* out = states + (((long)bc * H + h) * P + p0 + pw) * N;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n * 8 + 2 * t4;
        if (col < N) {
          *reinterpret_cast<float2*>(out + gid * N + col) =
              make_float2(acc[n][0], acc[n][1]);
          *reinterpret_cast<float2*>(out + (gid + 8) * N + col) =
              make_float2(acc[n][2], acc[n][3]);
        }
      }
    }
  }
}

// 3. The chunks in order, elementwise: from each chunk's input
// inputs[b, c, h] (P x N float32), the state at the chunk's start goes to
// planes[b, c, h] as two bf16 (P x N) planes, hi = bf16(state) and lo =
// bf16(state - hi), the operand of the output kernel's C . state^T; the
// final state goes out in float32. A thread per 4 entries of a (b, h)
// state; the loads of 8 chunks are in flight together.
__global__ void ssd_state_pass(const float* __restrict__ state0,
                               const float* __restrict__ cum,
                               const float* __restrict__ inputs,
                               bf16* __restrict__ planes,
                               float* __restrict__ state_out, int B, int S,
                               int H, int PN4, int Q) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)B * H * PN4) return;
  const int e = (int)(t % PN4);
  const long bh = t / PN4;
  const int b = (int)(bh / H), h = (int)(bh - (long)b * H), nc = S / Q;
  const float4* in4 = reinterpret_cast<const float4*>(inputs);
  uint2* pl = reinterpret_cast<uint2*>(planes);  // 4 bf16 a thread
  float4 st = state0 ? reinterpret_cast<const float4*>(state0)[t]
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int G = 8;
  for (int c0 = 0; c0 < nc; c0 += G) {
    float4 a[G];
    float d[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const long bc = (long)b * nc + min(c0 + k, nc - 1);
      a[k] = in4[(bc * H + h) * PN4 + e];
      d[k] = cum[(bc * Q + Q - 1) * H + h];
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (c0 + k >= nc) break;
      const long o = ((((long)b * nc + c0 + k) * H + h) * 2) * PN4 + e;
      uint2 hi, lo;
      split(st.x, st.y, hi.x, lo.x);
      split(st.z, st.w, hi.y, lo.y);
      pl[o] = hi;
      pl[o + PN4] = lo;
      const float dk = expf(d[k]);
      st.x = __fadd_rn(__fmul_rn(st.x, dk), a[k].x);
      st.y = __fadd_rn(__fmul_rn(st.y, dk), a[k].y);
      st.z = __fadd_rn(__fmul_rn(st.z, dk), a[k].z);
      st.w = __fadd_rn(__fmul_rn(st.w, dk), a[k].w);
    }
  }
  reinterpret_cast<float4*>(state_out)[t] = st;
}

// 4. y for 64 query rows of a (b, chunk), every head. G = C B^T of those
// rows (the columns up to each row group's last row) is computed once into
// shared memory; then per head and pass of PB columns of p:
// y = exp(cum_i) (C . state^T) + (G o exp(cum_i - cum_j) o dt_j, i >= j) x.
// 8 warps: a pair of warps owns 16 rows and splits their work (G's column
// tiles, C . state^T's depth, W x's column steps), the second adding its
// sum to the first's through shared memory before y is written. The
// (head, pass) items' tiles (x, the state planes, cum and dt) are double
// buffered: the next item's cp.async copies fly while this one computes.
template <int KS, int PB>
__global__ void __launch_bounds__(2 * THREADS)
    ssd_chunk_out(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                  const float* __restrict__ cum,
                  const bf16* __restrict__ planes, bf16* __restrict__ y,
                  int S, int H, int P, int N, int Q) {
  constexpr int NP = KS * 16, NB = PB / 8, OT = 2 * THREADS;
  const int QP = round16(Q), ldn = NP + 8, ldg = QP + 8, ldx = PB + 8;
  const int ldr = PB + 4;  // the partial sums' rows
  const int nc = S / Q, nrt = (Q + ROWS - 1) / ROWS;
  const int rt = nrt - 1 - (int)blockIdx.x;  // the heaviest tiles first
  const int i0 = rt * ROWS, bc = blockIdx.y;
  const long row0 = (long)bc * Q;  // b * S + c * Q
  const int jrows = min(i0 + ROWS, QP);
  extern __shared__ uint4 smem_y[];
  float* G = reinterpret_cast<float*>(smem_y);              // ROWS x ldg
  // C's rows, then (once C is in registers) the second warps' sums
  char* cr = reinterpret_cast<char*>(G + ROWS * ldg);
  bf16* Cs = reinterpret_cast<bf16*>(cr);                   // ROWS x ldn
  float* red = reinterpret_cast<float*>(cr);                // ROWS x ldr
  // B's rows for G, then two buffers of an item's tiles
  char* ur = cr + max(ROWS * ldn * 2, ROWS * ldr * 4);
  bf16* Bs = reinterpret_cast<bf16*>(ur);                    // QP x ldn
  const int buf_bytes = QP * 8 + QP * ldx * 2 + 2 * PB * ldn * 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = warp >> 2;                  // 0 or 1 of the pair
  const int gid = lane >> 2, t4 = lane & 3, lm = lane >> 3, lr = lane & 7;
  const int r0 = (warp & 3) * 16;              // the pair's rows in the tile
  const int jend = min(i0 + r0 + 16, QP);      // columns j they need
  const int gi0 = i0 + r0 + gid, gi1 = gi0 + 8;  // a thread's two rows

  load_bf16(Cs, ldn, Cm + (row0 + i0) * N, N, ROWS, Q - i0, N, NP, OT);
  load_bf16(Bs, ldn, Bm + row0 * N, N, jrows, Q, N, NP, OT);
  cp_async_wait_all();
  __syncthreads();

  uint32_t ca[KS][4];  // the pair's rows of C as A fragments
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const bf16* c0 = Cs + (r0 + gid) * ldn + k * 16 + 2 * t4;
    ca[k][0] = *reinterpret_cast<const uint32_t*>(c0);
    ca[k][1] = *reinterpret_cast<const uint32_t*>(c0 + 8 * ldn);
    ca[k][2] = *reinterpret_cast<const uint32_t*>(c0 + 8);
    ca[k][3] = *reinterpret_cast<const uint32_t*>(c0 + 8 * ldn + 8);
  }
  for (int jt = 8 * half; jt < jend; jt += 16) {
    float g[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* b0 = Bs + (jt + gid) * ldn + 2 * t4;
#pragma unroll
    for (int k = 0; k < KS; ++k)
      mma(g, ca[k], *reinterpret_cast<const uint32_t*>(b0 + k * 16),
          *reinterpret_cast<const uint32_t*>(b0 + k * 16 + 8));
    float* gr = G + (r0 + gid) * ldg + jt + 2 * t4;
    *reinterpret_cast<float2*>(gr) = make_float2(g[0], g[1]);
    *reinterpret_cast<float2*>(gr + 8 * ldg) = make_float2(g[2], g[3]);
  }
  __syncthreads();  // G is whole; Bs and Cs are dead

  // item it = (head it / passes, pass it % passes) in buffer it % 2
  const int passes = P / PB, items = H * passes;
  auto issue = [&](int it) {
    char* bb = ur + (it & 1) * buf_bytes;
    const int h = it / passes, p0 = (it - h * passes) * PB;
    float* cs = reinterpret_cast<float*>(bb);
    for (int j = threadIdx.x; j < QP; j += OT) {
      const long o = (row0 + (j < Q ? j : 0)) * H + h;
      cp_async4(cs + j, cum + o, j < Q);
      cp_async4(cs + QP + j, dt + o, j < Q);
    }
    bf16* xs = reinterpret_cast<bf16*>(cs + 2 * QP);
    const bf16* pl = planes + ((long)bc * H + h) * 2 * P * N;
    load_bf16(xs, ldx, x + (row0 * H + h) * P + p0, (long)H * P, jrows, Q,
              PB, PB, OT);
    load_bf16(xs + QP * ldx, ldn, pl + (long)p0 * N, N, PB, PB, N, NP, OT);
    load_bf16(xs + QP * ldx + PB * ldn, ldn, pl + (long)(P + p0) * N, N, PB,
              PB, N, NP, OT);
    cp_async_commit();
  };
  const int k_lo = half ? KS / 2 : 0, k_hi = half ? KS : KS / 2;
  issue(0);
  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) {
      issue(it + 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    {
      const int h = it / passes, p0 = (it - h * passes) * PB;
      char* bb = ur + (it & 1) * buf_bytes;
      const float* cum_s = reinterpret_cast<const float*>(bb);
      const float* dt_s = cum_s + QP;
      const bf16* Xs = reinterpret_cast<const bf16*>(dt_s + QP);
      const bf16* Sh = Xs + QP * ldx;
      const bf16* Sl = Sh + PB * ldn;

      float acc[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      // C . state^T over this warp's half of the depth, the state as hi + lo
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        if (k < k_lo || k >= k_hi) continue;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const int o = (n * 8 + gid) * ldn + k * 16 + 2 * t4;
          mma(acc[n], ca[k], *reinterpret_cast<const uint32_t*>(Sh + o),
              *reinterpret_cast<const uint32_t*>(Sh + o + 8));
          mma(acc[n], ca[k], *reinterpret_cast<const uint32_t*>(Sl + o),
              *reinterpret_cast<const uint32_t*>(Sl + o + 8));
        }
      }
      const float c_0 = cum_s[min(gi0, QP - 1)];
      const float c_1 = cum_s[min(gi1, QP - 1)];
      const float e0 = expf(c_0), e1 = expf(c_1);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        acc[n][0] *= e0;
        acc[n][1] *= e0;
        acc[n][2] *= e1;
        acc[n][3] *= e1;
      }
      // + W x over this warp's column steps, W = G o exp(cum_i - cum_j) o
      // dt_j where j <= i < Q (expf: the faster __expf put y two bf16 ulps
      // from the plain version at the serving shape)
      for (int j0 = 16 * half; j0 < jend; j0 += 32) {
        uint32_t whi[4], wlo[4];
#pragma unroll
        for (int jh = 0; jh < 2; ++jh) {  // columns j, j + 1 of two rows
          const int j = j0 + 2 * t4 + 8 * jh;
          const float2 cj = *reinterpret_cast<const float2*>(cum_s + j);
          const float2 dj = *reinterpret_cast<const float2*>(dt_s + j);
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int gi = rh ? gi1 : gi0;
            const float ci = rh ? c_1 : c_0;
            const float2 gv = *reinterpret_cast<const float2*>(
                G + (r0 + gid + 8 * rh) * ldg + j);
            float w0 = 0.f, w1 = 0.f;
            if (gi < Q) {
              if (j <= gi) w0 = gv.x * expf(ci - cj.x) * dj.x;
              if (j + 1 <= gi) w1 = gv.y * expf(ci - cj.y) * dj.y;
            }
            split(w0, w1, whi[2 * jh + rh], wlo[2 * jh + rh]);
          }
        }
#pragma unroll
        for (int n = 0; n < NB; n += 2) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, Xs + (j0 + lr + ((lm & 1) << 3)) * ldx + n * 8 +
                                ((lm >> 1) << 3));
          mma(acc[n], whi, bb[0], bb[1]);
          mma(acc[n], wlo, bb[0], bb[1]);
          mma(acc[n + 1], whi, bb[2], bb[3]);
          mma(acc[n + 1], wlo, bb[2], bb[3]);
        }
      }
      // the second warp of the pair hands its sum to the first
      float* rr = red + (r0 + gid) * ldr + 2 * t4;
      if (half) {
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          *reinterpret_cast<float2*>(rr + n * 8) =
              make_float2(acc[n][0], acc[n][1]);
          *reinterpret_cast<float2*>(rr + 8 * ldr + n * 8) =
              make_float2(acc[n][2], acc[n][3]);
        }
      }
      __syncthreads();
      if (!half) {
        bf16* yb = y + (row0 * H + h) * P + p0 + 2 * t4;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const float2 u = *reinterpret_cast<const float2*>(rr + n * 8);
          const float2 v =
              *reinterpret_cast<const float2*>(rr + 8 * ldr + n * 8);
          if (gi0 < Q)
            *reinterpret_cast<__nv_bfloat162*>(yb + (long)gi0 * H * P +
                                               n * 8) =
                __floats2bfloat162_rn(acc[n][0] + u.x, acc[n][1] + u.y);
          if (gi1 < Q)
            *reinterpret_cast<__nv_bfloat162*>(yb + (long)gi1 * H * P +
                                               n * 8) =
                __floats2bfloat162_rn(acc[n][2] + v.x, acc[n][3] + v.y);
        }
      }
      __syncthreads();  // this buffer and red are read
    }
  }
}

inline int round16h(int v) { return (v + 15) & ~15; }

inline size_t state_smem(int NP, int Q, int PB) {
  const int QP = round16h(Q);
  return (size_t)QP * (NP + 8) * 2 + (size_t)QP * (PB + 8) * 2 + QP * 4;
}

inline size_t out_smem(int NP, int Q, int PB) {
  const int QP = round16h(Q);
  const size_t buf = (size_t)QP * 8 + (size_t)QP * (PB + 8) * 2 +
                     (size_t)PB * (NP + 8) * 4;
  const size_t u = std::max((size_t)QP * (NP + 8) * 2, 2 * buf);
  const size_t cs = std::max((size_t)ROWS * (NP + 8) * 2,
                             (size_t)ROWS * (PB + 4) * 4);
  return (size_t)ROWS * (QP + 8) * 4 + cs + u;
}

template <int KS, int PB>
cudaError_t launch_out(int B, int S, int H, int P, int N, int Q,
                       const void* x, const void* dt, const void* Bm,
                       const void* Cm, const void* cum, const void* planes,
                       void* y, cudaStream_t stream) {
  const size_t smem = out_smem(KS * 16, Q, PB);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_out<KS, PB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Q + ROWS - 1) / ROWS, B * (S / Q));
  ssd_chunk_out<KS, PB><<<grid, 2 * THREADS, smem, stream>>>(
      (const bf16*)x, (const float*)dt, (const bf16*)Bm, (const bf16*)Cm,
      (const float*)cum, (const bf16*)planes, (bf16*)y, S, H, P, N, Q);
  return cudaGetLastError();
}

template <int KS>
cudaError_t run(int PB, int B, int S, int H, int P, int N, int Q,
                const void* x, const void* dt, const void* Bm, const void* Cm,
                const void* A, const void* state0, void* y, void* state,
                void* cum, void* inputs, void* planes, cudaStream_t stream) {
  constexpr int NP = KS * 16;
  const long chains = (long)B * (S / Q) * H;
  ssd_cum<<<(unsigned)((chains + 255) / 256), 256, 0, stream>>>(
      (const float*)dt, (const float*)A, (float*)cum, B, S, H, Q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t sm_a = state_smem(NP, Q, PB);
  e = cudaFuncSetAttribute(ssd_chunk_state<NP / 8>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sm_a);
  if (e != cudaSuccess) return e;
  ssd_chunk_state<NP / 8><<<B * (S / Q), THREADS, sm_a, stream>>>(
      (const bf16*)x, (const float*)dt, (const bf16*)Bm, (const float*)cum,
      (float*)inputs, S, H, P, N, Q, PB);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const long quads = (long)B * H * P * N / 4;
  ssd_state_pass<<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(
      (const float*)state0, (const float*)cum, (const float*)inputs,
      (bf16*)planes, (float*)state, B, S, H, P * N / 4, Q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  switch (PB) {
    case 16:
      return launch_out<KS, 16>(B, S, H, P, N, Q, x, dt, Bm, Cm, cum, planes,
                                y, stream);
    case 32:
      return launch_out<KS, 32>(B, S, H, P, N, Q, x, dt, Bm, Cm, cum, planes,
                                y, stream);
    case 64:
      return launch_out<KS, 64>(B, S, H, P, N, Q, x, dt, Bm, Cm, cum, planes,
                                y, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ssd_tc

extern "C" {

// The float32 route. pb: state columns a block, 16, 32 or 64, dividing P.
// N a power of two from 4 to 128, 1 <= Q <= 256, S % Q == 0. state0 may
// be null (a zero state).
int ssd_scan_f32_run(int pb, int B, int S, int H, int P, int N, int Q,
                     const void* x, const void* dt, const void* Bm,
                     const void* Cm, const void* A, const void* state0,
                     void* y, void* state, void* stream) {
  if (P % pb || N < 4 || N > ssd::MAXN || (N & (N - 1)) || Q < 1 ||
      Q > ssd::MAXQ || S % Q)
    return (int)cudaErrorInvalidValue;
  return (int)ssd::launch_pb(pb, B, S, H, P, N, Q, x, dt, Bm, Cm, A, state0, y,
                             state, static_cast<cudaStream_t>(stream));
}

// The bf16 route. pb: columns of p a pass, 16, 32 or 64, dividing P; N a
// power of two from 4 to 128; 1 <= Q <= 256, S % Q == 0; x, B, C 16-byte
// aligned. Scratch: cum (B, S, H) float32; inputs (B, S / Q, H, P, N)
// float32, the chunks' state inputs; planes (B, S / Q, H, 2, P, N) bf16,
// the states at the chunks' starts as hi and lo. state0 may be null (a
// zero state).
int ssd_scan_bf16_run(int pb, int B, int S, int H, int P, int N, int Q,
                      const void* x, const void* dt, const void* Bm,
                      const void* Cm, const void* A, const void* state0,
                      void* y, void* state, void* cum, void* inputs,
                      void* planes, void* stream) {
  if ((pb != 16 && pb != 32 && pb != 64) || P % pb || N < 4 ||
      N > ssd::MAXN || (N & (N - 1)) || Q < 1 || Q > ssd::MAXQ || S % Q)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N < 16 ? 16 : N) {
    case 16:
      return (int)ssd_tc::run<1>(pb, B, S, H, P, N, Q, x, dt, Bm, Cm, A,
                                 state0, y, state, cum, inputs, planes, s);
    case 32:
      return (int)ssd_tc::run<2>(pb, B, S, H, P, N, Q, x, dt, Bm, Cm, A,
                                 state0, y, state, cum, inputs, planes, s);
    case 64:
      return (int)ssd_tc::run<4>(pb, B, S, H, P, N, Q, x, dt, Bm, Cm, A,
                                 state0, y, state, cum, inputs, planes, s);
    default:
      return (int)ssd_tc::run<8>(pb, B, S, H, P, N, Q, x, dt, Bm, Cm, A,
                                 state0, y, state, cum, inputs, planes, s);
  }
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
