// Shared device helpers for the MCPrioQ kernels (sm_90a, plain C interface).
//
// Every exported entry point takes raw device pointers plus a CUDA stream,
// launches on that stream without synchronising or allocating, and returns
// cudaGetLastError() as an int (0 = launched).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MCQ_EMPTY (-1)
#define MCQ_TOMB (-2)
#define MCQ_FULL_MASK 0xffffffffu
#define MCQ_WARP 32

// splitmix32-style avalanche in wrap-around uint32 arithmetic; the same
// function as repro_torch.core.hashtable.hash_u32.
__device__ __forceinline__ uint32_t mcq_hash_u32(int32_t key) {
  uint32_t x = static_cast<uint32_t>(key);
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x = x ^ (x >> 16);
  return x;
}

// Index of the lowest set bit of a ballot mask (mask != 0).
__device__ __forceinline__ int mcq_first_lane(unsigned mask) {
  return __ffs(static_cast<int>(mask)) - 1;
}

static inline int mcq_launch_status() {
  return static_cast<int>(cudaGetLastError());
}
