// Wave-scheduled greedy assignment over the gated candidate pairs.
//
// Replaces the in-kernel assignment of the reference frame kernels
// (repro/kernels/katana_bank/kernel.py:_emit_greedy_assign, also the
// body of greedy_assign_step). Every wave commits each (measurement j,
// track c) pair that is the first-occurrence argmin of both track c's
// column and measurement j's row of the masked cost tile; committed
// rows and columns are then masked out. The loop ends when a wave
// commits nothing or after `rounds` waves. Same gate test
// (cost <= gate, NaN fails), same tie-break (lowest index), same early
// exit, so the result and the wave count equal the sequential
// global-argmin greedy's.
//
// Only gated pairs carry information: a pair can commit only if its
// entry is below the FLT_MAX sentinel, and then the argmins of its row
// and column are below it too. So two launches:
//   1. greedy_candidates: a thread per tile entry, many blocks, writes
//      every pair with entry < FLT_MAX to a flat list in a scratch
//      (64-bit key = order-preserving float bits high, j low; and c);
//      a block reserves its slots with one atomicAdd on the count;
//   2. greedy_candidate_waves: one block runs the waves over the list.
//      A wave is one pass over the live candidates with two
//      shared-memory atomicMins each: the track's key (bits, j) (its
//      minimum is the row's first-occurrence argmin) and the
//      measurement's key (bits, c) (the column's). Then a pass over the
//      tracks commits the mutual minima. Two barriers a wave; the work
//      scales with the gated pairs, not with C x M. The keys are
//      double-buffered, so the buffer of the next wave is reset while
//      this one is read.
// The list's order is the blocks' arrival order; the minima do not
// depend on it. Frames, IMM frames and the standalone greedy share this
// code; only the tile accessor differs.
//
// A fleet frame serves S sensors at once: the tile is (S, M, C)
// (FleetTile), the candidate grid gains a y axis of S (a block lists one
// sensor's entries into that sensor's own list and count), and the waves
// run on S blocks, block s over list s into assoc[s] and waves[s]. A
// sensor's candidates and minima are those of its own frame, so each
// sensor's assoc and wave count equal its single-sensor greedy's, bit for
// bit. S = 1 launches the single-sensor grids on FrameTile.
//
// Bound: one read of the masked tile (L2-resident after the cost pass)
// and, per wave, one read of the candidate list; at the serving shape
// (C=1024, M=256, a few hundred gated pairs) launch latency and the
// waves' barriers bound it.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace katana {

// Masked entry of the frame's (M, C) cost tile: track active, measurement
// valid, cost within the gate. Entry e of the tile in memory order is
// (j, c) = (e / C, e % C). One sensor (s is 0).
struct FrameTile {
  const float* cost;
  const uint8_t* act;
  const uint8_t* zval;
  int C;
  float gate;
  __device__ __forceinline__ float at(int, size_t e, int& j, int& c) const {
    j = (int)(e / C);
    c = (int)(e - (size_t)j * C);
    const float v = cost[e];
    return (act[c] && zval[j] && v <= gate) ? v : FLT_MAX;
  }
};

// FrameTile of a fleet: sensor s's (M, C) tile of the (S, M, C) cost, its
// act (S, C) and zval (S, M) rows.
struct FleetTile {
  const float* cost;
  const uint8_t* act;
  const uint8_t* zval;
  int C;
  int M;
  float gate;
  __device__ __forceinline__ float at(int s, size_t e, int& j,
                                      int& c) const {
    j = (int)(e / C);
    c = (int)(e - (size_t)j * C);
    const float v = cost[(size_t)s * M * C + e];
    return (act[(size_t)s * C + c] && zval[(size_t)s * M + j] && v <= gate)
               ? v
               : FLT_MAX;
  }
};

// Masked entry of a canonical (C, M) cost with a (C, M) pair-validity mask
// (one sensor): entry e is (j, c) = (e % M, e / M).
struct PairTile {
  const float* cost;
  const uint8_t* valid;
  int M;
  float gate;
  __device__ __forceinline__ float at(int, size_t e, int& j, int& c) const {
    c = (int)(e / M);
    j = (int)(e - (size_t)c * M);
    const float v = cost[e];
    return (valid[e] && v <= gate) ? v : FLT_MAX;
  }
};

__device__ __forceinline__ unsigned int ordered_bits(float v) {
  if (v == 0.0f) v = 0.0f;  // -0 ties with +0, as a float compare does
  const unsigned int u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

constexpr unsigned long long kNone = ~0ull;
constexpr unsigned long long kLow = 0xffffffffull;
constexpr int kCandThreads = 256;
constexpr int kCandPerThread = 8;

// The scratch the wrapper allocates for S sensors: keys (S*C*M x 8
// bytes), tracks (S*C*M x 4), the counts (S x 4); sensor s's list is
// entries s*C*M ... of keys and tracks.
__host__ __device__ inline size_t greedy_scratch_bytes(int C, int M,
                                                       int S = 1) {
  return ((size_t)C * M * 12 + 4) * S;
}

__host__ __device__ inline size_t greedy_smem_bytes(int C, int M) {
  return (size_t)C * 16 + (size_t)M * 16 + (size_t)M + (size_t)C;
}

__host__ inline int greedy_threads(int n) {
  const int t = ((n + 31) / 32) * 32;
  return t < 1024 ? (t > 0 ? t : 32) : 1024;
}

// Block (x, s) lists entries x * kCandThreads * kCandPerThread ... of
// sensor s's `entries` into list s.
template <class Tile>
__global__ void __launch_bounds__(kCandThreads)
    greedy_candidates(Tile tile, size_t entries,
                      unsigned long long* __restrict__ keys,
                      int* __restrict__ tracks, int* __restrict__ count) {
  __shared__ int s_n, s_base;
  const int s = blockIdx.y;
  keys += (size_t)s * entries;
  tracks += (size_t)s * entries;
  count += s;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  const size_t e0 =
      (size_t)blockIdx.x * kCandThreads * kCandPerThread + threadIdx.x;
  unsigned long long key[kCandPerThread];
  int trk[kCandPerThread], slot[kCandPerThread];
#pragma unroll
  for (int k = 0; k < kCandPerThread; ++k) {
    const size_t e = e0 + (size_t)k * kCandThreads;
    slot[k] = -1;
    if (e < entries) {
      int j, c;
      const float v = tile.at(s, e, j, c);
      if (v < FLT_MAX) {
        key[k] = ((unsigned long long)ordered_bits(v) << 32) | (unsigned)j;
        trk[k] = c;
        slot[k] = atomicAdd(&s_n, 1);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) s_base = s_n ? atomicAdd(count, s_n) : 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kCandPerThread; ++k)
    if (slot[k] >= 0) {
      keys[s_base + slot[k]] = key[k];
      tracks[s_base + slot[k]] = trk[k];
    }
}

// Block s runs sensor s's waves over its list into assoc[s] (C) and
// waves_out[s].
__global__ void greedy_candidate_waves(int C, int M, int rounds,
                                       const unsigned long long* __restrict__
                                           keys,
                                       const int* __restrict__ tracks,
                                       const int* __restrict__ count,
                                       int* __restrict__ assoc,
                                       int* __restrict__ waves_out) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int s = blockIdx.x;
  keys += (size_t)s * C * M;
  tracks += (size_t)s * C * M;
  count += s;
  assoc += (size_t)s * C;
  waves_out += s;
  unsigned long long* rowkey = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* colkey = rowkey + 2 * C;            // 2 x M
  uint8_t* row_dead = reinterpret_cast<uint8_t*>(colkey + 2 * M);  // meas
  uint8_t* col_dead = row_dead + M;                                // track
  const int tid = threadIdx.x, bd = blockDim.x;
  const int n = *count;
  for (int c = tid; c < C; c += bd) {
    assoc[c] = -1;
    col_dead[c] = 0;
    rowkey[c] = rowkey[C + c] = kNone;
  }
  for (int j = tid; j < M; j += bd) {
    row_dead[j] = 0;
    colkey[j] = colkey[M + j] = kNone;
  }
  __syncthreads();

  int r = 0;
  bool go = true;
  while (go && r < rounds) {
    unsigned long long* rk = rowkey + (r & 1) * C;
    unsigned long long* ck = colkey + (r & 1) * M;
    for (int i = tid; i < n; i += bd) {
      const unsigned long long key = __ldg(keys + i);
      const int c = __ldg(tracks + i), j = (int)(key & kLow);
      if (!row_dead[j] && !col_dead[c]) {
        atomicMin(&rk[c], key);
        atomicMin(&ck[j], (key & ~kLow) | (unsigned)c);
      }
    }
    __syncthreads();
    unsigned long long* rk_next = rowkey + ((r + 1) & 1) * C;
    unsigned long long* ck_next = colkey + ((r + 1) & 1) * M;
    int committed = 0;
    for (int c = tid; c < C; c += bd) {
      const unsigned long long key = rk[c];
      if (key != kNone) {
        const int j = (int)(key & kLow);
        if ((int)(ck[j] & kLow) == c) {
          assoc[c] = j;
          col_dead[c] = 1;
          row_dead[j] = 1;
          committed = 1;
        }
      }
      rk_next[c] = kNone;
    }
    for (int j = tid; j < M; j += bd) ck_next[j] = kNone;
    ++r;
    go = __syncthreads_or(committed) != 0;
  }
  if (tid == 0) *waves_out = r;
}

// Record events[i] on the stream, where events and events[i] are not
// null (a frame's per-launch events).
inline cudaError_t record(void* const* events, int i, cudaStream_t stream) {
  if (events == nullptr || events[i] == nullptr) return cudaSuccess;
  return cudaEventRecord(static_cast<cudaEvent_t>(events[i]), stream);
}

// The greedy's launches on `stream` for S sensors: the S counts reset, the
// candidate lists, the waves (one block a sensor). `scratch` holds
// greedy_scratch_bytes(C, M, S); assoc is (S, C), waves (S). ev_start /
// ev_end, when not null, are CUDA events recorded just before and after
// (the greedy's device time inside a frame).
template <class Tile>
inline cudaError_t launch_greedy(const Tile& tile, int C, int M, int S,
                                 int rounds, void* scratch, int* assoc,
                                 int* waves, cudaStream_t stream,
                                 void* ev_start, void* ev_end) {
  const size_t entries = (size_t)C * M;
  auto* keys = static_cast<unsigned long long*>(scratch);
  auto* tracks = reinterpret_cast<int*>(keys + entries * S);
  int* count = tracks + entries * S;
  const size_t smem = greedy_smem_bytes(C, M);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(greedy_candidate_waves,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (ev_start) {
    e = cudaEventRecord(static_cast<cudaEvent_t>(ev_start), stream);
    if (e != cudaSuccess) return e;
  }
  e = cudaMemsetAsync(count, 0, sizeof(int) * S, stream);
  if (e != cudaSuccess) return e;
  if (entries > 0) {
    const size_t per_block = (size_t)kCandThreads * kCandPerThread;
    const dim3 blocks((unsigned)((entries + per_block - 1) / per_block), S);
    greedy_candidates<Tile><<<blocks, kCandThreads, 0, stream>>>(
        tile, entries, keys, tracks, count);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  greedy_candidate_waves<<<S, greedy_threads(C > M ? C : M), smem, stream>>>(
      C, M, rounds, keys, tracks, count, assoc, waves);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (ev_end) e = cudaEventRecord(static_cast<cudaEvent_t>(ev_end), stream);
  return e;
}

}  // namespace katana
