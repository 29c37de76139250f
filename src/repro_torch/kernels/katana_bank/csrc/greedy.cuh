// Wave-scheduled greedy assignment, one block over the whole bank.
//
// Replaces the in-kernel assignment of the reference frame kernels
// (repro/kernels/katana_bank/kernel.py:_emit_greedy_assign, also the
// body of greedy_assign_step). Every wave commits each (measurement j,
// track c) pair that is the first-occurrence argmin of both track c's
// column and measurement j's row of the masked cost tile; committed
// rows and columns are then masked out. The loop ends when a wave
// commits nothing or after `rounds` waves. Same gate test
// (cost <= gate, NaN fails), same FLT_MAX sentinel, same tie-break
// (lowest index), same early exit, so the result equals the sequential
// global-argmin greedy.
//
// Bound: each wave reads the surviving (M, C) tile once (1 MiB at
// C=1024, M=256, L2-resident after the cost pass), so the kernel is
// bound by those reads and by the wave count. One block of up to 1024
// threads owns every column (a thread per track, looping when C > 1024):
// the row argmin of a track is a register loop; the column argmin of a
// measurement is a warp shuffle-min of 64-bit keys (order-preserving
// float bits high, track index low) followed by one shared-memory
// atomicMin per warp and row.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace katana {

// Masked entry of the frame's (M, C) cost tile: track active, measurement
// valid, cost within the gate.
struct FrameTile {
  const float* cost;
  const uint8_t* act;
  const uint8_t* zval;
  int C;
  float gate;
  __device__ __forceinline__ float operator()(int j, int c) const {
    const float v = cost[(size_t)j * C + c];
    return (act[c] && zval[j] && v <= gate) ? v : FLT_MAX;
  }
};

// Masked entry of a canonical (C, M) cost with a (C, M) pair-validity mask.
struct PairTile {
  const float* cost;
  const uint8_t* valid;
  int M;
  float gate;
  __device__ __forceinline__ float operator()(int j, int c) const {
    const size_t o = (size_t)c * M + j;
    const float v = cost[o];
    return (valid[o] && v <= gate) ? v : FLT_MAX;
  }
};

__device__ __forceinline__ unsigned int ordered_bits(float v) {
  if (v == 0.0f) v = 0.0f;  // -0 ties with +0, as a float compare does
  const unsigned int u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__host__ __device__ inline size_t greedy_smem_bytes(int C, int M) {
  return (size_t)M * 8 + (size_t)C * 8 + (size_t)M + (size_t)C;
}

__host__ inline int greedy_threads(int C) {
  const int t = ((C + 31) / 32) * 32;
  return t < 1024 ? (t > 0 ? t : 32) : 1024;
}

template <class Tile>
__global__ void greedy_waves_kernel(Tile tile, int C, int M, int rounds,
                                    int* __restrict__ assoc,
                                    int* __restrict__ waves_out) {
  extern __shared__ __align__(8) unsigned char smem[];
  unsigned long long* colkey = reinterpret_cast<unsigned long long*>(smem);
  int* targ = reinterpret_cast<int*>(colkey + M);
  float* tmin = reinterpret_cast<float*>(targ + C);
  uint8_t* row_dead = reinterpret_cast<uint8_t*>(tmin + C);  // meas taken
  uint8_t* col_dead = row_dead + M;                          // track taken
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const int lane = tid & 31;
  const int chunks = (C + bd - 1) / bd;
  for (int c = tid; c < C; c += bd) {
    col_dead[c] = 0;
    assoc[c] = -1;
  }
  for (int j = tid; j < M; j += bd) row_dead[j] = 0;
  __syncthreads();

  int r = 0;
  bool go = true;
  while (go && r < rounds) {
    for (int j = tid; j < M; j += bd) colkey[j] = ~0ull;
    __syncthreads();
    for (int ch = 0; ch < chunks; ++ch) {
      const int c = ch * bd + tid;
      const bool live = c < C;
      const bool open = live && !col_dead[c];
      float best = FLT_MAX;
      int arg = 0;
      for (int j = 0; j < M; ++j) {
        const float v = (open && !row_dead[j]) ? tile(j, c) : FLT_MAX;
        if (j == 0 || v < best) {
          best = v;
          arg = j;
        }
        unsigned long long key =
            live ? ((unsigned long long)ordered_bits(v) << 32) | (unsigned)c
                 : ~0ull;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
          key = o < key ? o : key;
        }
        if (lane == 0) atomicMin(&colkey[j], key);
      }
      if (live) {
        tmin[c] = best;
        targ[c] = arg;
      }
    }
    __syncthreads();
    int committed = 0;
    for (int c = tid; c < C; c += bd) {
      const int j = targ[c];
      if (tmin[c] < FLT_MAX &&
          (unsigned)(colkey[j] & 0xffffffffull) == (unsigned)c) {
        assoc[c] = j;
        col_dead[c] = 1;
        row_dead[j] = 1;
        committed = 1;
      }
    }
    ++r;
    go = __syncthreads_or(committed) != 0;
  }
  if (tid == 0) *waves_out = r;
}

template <class Tile>
inline cudaError_t launch_greedy(const Tile& tile, int C, int M, int rounds,
                                 int* assoc, int* waves, cudaStream_t stream) {
  const size_t smem = greedy_smem_bytes(C, M);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        greedy_waves_kernel<Tile>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  greedy_waves_kernel<Tile><<<1, greedy_threads(C), smem, stream>>>(
      tile, C, M, rounds, assoc, waves);
  return cudaGetLastError();
}

}  // namespace katana
