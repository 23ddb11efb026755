// The open-addressing probe of one key by one thread, shared by the kernels
// that look a key up one thread each (probe.cu, slow_path.cu's lookup
// launch), so that their probes cannot drift; walk.cu probes the same chain
// with several lanes at once, and the plain versions hold it to the same
// answers.
//
// From the home slot hash_u32(key) & (size-1) the chain is walked for at most
// max_probes slots (wrapping with & (size-1)); it stops at the first EMPTY
// (missing) or at the key (found) and walks through TOMB.  Probing for the
// EMPTY value itself is a miss, decided without reading the table (EMPTY is
// never a stored key); update_batch hands the probe many such keys.
//
// Bound on this card: latency.  A lookup moves a few bytes from a table far
// larger than the cache, so its time is the number of dependent DRAM round
// trips.  Each probed slot's key and value loads are issued together: at
// load factor <= 0.25 most keys sit at their home slot, so a hit costs one
// round trip (the value read of a miss is in bounds, since idx is masked,
// and is ignored); the chain goes on only past a non-matching, non-EMPTY key.
//
// The loads are read-only (ld.global.nc, mcq_load_nc), which is right only
// where no thread of the same launch writes the table: probe.cu and walk.cu
// never write it, and slow_path.cu's lookup launch A1 runs before its chain
// launch A2 inserts.  A caller that probes and inserts in one launch must
// not use this function: the non-coherent cache may keep a stale slot.
#pragma once

#include "common.cuh"

// One read-only load, issued where it stands: asm volatile keeps the compiler
// from sinking it into the branch that uses it, which would add a round trip.
__device__ __forceinline__ int32_t mcq_load_nc(const int32_t* p) {
  int32_t v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Returns whether key is in the table; *val gets its value when it is.
__device__ __forceinline__ bool mcq_probe_chain(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ vals,
    int table_size, int32_t key, int max_probes, int32_t* val) {
  if (key == MCQ_EMPTY) return false;
  const uint32_t mask = static_cast<uint32_t>(table_size - 1);
  const uint32_t h0 = mcq_hash_u32(key) & mask;
  for (int p = 0; p < max_probes; ++p) {
    const uint32_t idx = (h0 + static_cast<uint32_t>(p)) & mask;
    const int32_t k = mcq_load_nc(keys + idx);
    const int32_t v = mcq_load_nc(vals + idx);  // beside the key: one trip
    if (k == key) {
      *val = v;
      return true;
    }
    if (k == MCQ_EMPTY) return false;
  }
  return false;
}
