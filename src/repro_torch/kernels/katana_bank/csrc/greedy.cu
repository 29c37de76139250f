// greedy_assign: the frames' in-kernel greedy assignment as its own
// launch, over a canonical (C, M) cost and (C, M) pair-validity mask.
//
// Replaces repro/kernels/katana_bank/kernel.py:greedy_assign_step, the
// test surface that holds the wave greedy against the sequential
// reference. Same device code as the frames (greedy.cuh); only the tile
// accessor differs (invalid pairs read as the FLT_MAX sentinel).
// Bound: one read of the cost tile, then the waves over the gated
// candidates (see greedy.cuh).

#include "greedy.cuh"

extern "C" {

// `scratch` holds greedy_scratch_bytes(C, Mz); ev0 / ev1 (null, or CUDA
// events) are recorded around the greedy's launches.
int greedy_assign_run(int C, int Mz, const void* cost, const void* valid,
                      float gate, int rounds, void* scratch, void* assoc,
                      void* waves, void* stream, void* ev0, void* ev1) {
  using namespace katana;
  return (int)launch_greedy(
      PairTile{(const float*)cost, (const uint8_t*)valid, Mz, gate}, C, Mz,
      1, rounds, scratch, (int*)assoc, (int*)waves,
      static_cast<cudaStream_t>(stream), ev0, ev1);
}

const char* katana_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
