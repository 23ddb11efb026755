// The open-addressing probe of one key by one thread, shared by every kernel
// that looks a key up (probe.cu, walk.cu), so that their probes cannot drift.
//
// From the home slot hash_u32(key) & (size-1) the chain is walked for at most
// max_probes slots (wrapping with & (size-1)); it stops at the first EMPTY
// (missing) or at the key (found) and walks through TOMB.  EMPTY is tested
// before the key: probing for the EMPTY value itself is a miss.
#pragma once

#include "common.cuh"

// Returns whether key is in the table; *val gets its value when it is.
__device__ __forceinline__ bool mcq_probe_chain(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ vals,
    int table_size, int32_t key, int max_probes, int32_t* val) {
  const uint32_t mask = static_cast<uint32_t>(table_size - 1);
  const uint32_t h0 = mcq_hash_u32(key) & mask;
  for (int p = 0; p < max_probes; ++p) {
    const uint32_t idx = (h0 + static_cast<uint32_t>(p)) & mask;
    const int32_t k = keys[idx];
    if (k == MCQ_EMPTY) return false;
    if (k == key) {
      *val = vals[idx];
      return true;
    }
  }
  return false;
}
