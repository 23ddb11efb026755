// The open-addressing probe of one key by a whole warp, for the kernels that
// probe and write a table in one launch: slow_path.cu's chain launch (A2,
// the src table) and row launch (B2, the per-row dst hash), and
// dh_rebuild.cu (a row hash staged in shared memory).  One definition, so
// that their inserts and deletes cannot drift from each other or from
// repro_torch.core.hashtable.insert / delete.
//
// The window is max_probes slots from the home slot hash_u32(key) &
// (size-1), wrapping with & (size-1); lane L reads position p0 + L of each
// round of 32, and two ballots find the first position holding the key or
// EMPTY (the stop) and the first TOMB before it.  The loads are volatile,
// never ld.global.nc: the caller writes the table between two probes of one
// launch (lane 0 writes, the warp syncs, the next probe must see it), so the
// read-only cache of probe.cuh would be wrong here.  A generic pointer, so
// the same code probes global or shared memory.
#pragma once

#include "common.cuh"

// stop_p: first position holding the key or EMPTY (max_probes if none);
// tomb_p: first TOMB before stop_p (max_probes if none).
struct McqProbe {
  int stop_p;
  int tomb_p;
  int32_t stop_key;
  int32_t stop_val;  // vals at stop_p (loaded beside the key)
  uint32_t h0;
};

__device__ __forceinline__ McqProbe mcq_probe_window(
    const volatile int32_t* keys, const volatile int32_t* vals,
    uint32_t mask, int32_t key, int max_probes, int lane) {
  McqProbe pr;
  pr.stop_p = max_probes;
  pr.tomb_p = max_probes;
  pr.stop_key = MCQ_EMPTY;
  pr.stop_val = MCQ_EMPTY;
  pr.h0 = mcq_hash_u32(key) & mask;
  for (int p0 = 0; p0 < max_probes; p0 += MCQ_WARP) {
    const int p = p0 + lane;
    int32_t k = MCQ_TOMB - 1;  // matches nothing
    int32_t v = MCQ_EMPTY;
    const bool in_win = p < max_probes;
    if (in_win) {
      const uint32_t idx = (pr.h0 + static_cast<uint32_t>(p)) & mask;
      k = keys[idx];
      v = vals[idx];
    }
    const unsigned stops =
        __ballot_sync(MCQ_FULL_MASK, in_win && (k == key || k == MCQ_EMPTY));
    unsigned tombs = __ballot_sync(MCQ_FULL_MASK, in_win && k == MCQ_TOMB);
    if (stops) {
      const int first = mcq_first_lane(stops);
      tombs &= (1u << first) - 1u;  // only TOMBs before the stop
      if (pr.tomb_p == max_probes && tombs)
        pr.tomb_p = p0 + mcq_first_lane(tombs);
      pr.stop_p = p0 + first;
      pr.stop_key = __shfl_sync(MCQ_FULL_MASK, k, first);
      pr.stop_val = __shfl_sync(MCQ_FULL_MASK, v, first);
      break;
    }
    if (pr.tomb_p == max_probes && tombs)
      pr.tomb_p = p0 + mcq_first_lane(tombs);
  }
  return pr;
}

__device__ __forceinline__ bool mcq_landed_on(const McqProbe& pr, int32_t key,
                                              int max_probes) {
  return pr.stop_p < max_probes && pr.stop_key == key;
}

// Where insert writes `key`: its own slot or the first EMPTY, unless a TOMB
// came first and the walk did not land on the key (the key is then absent:
// also when the window holds no stop); max_probes when there is no place.
__device__ __forceinline__ int mcq_insert_pos(const McqProbe& pr, int32_t key,
                                              int max_probes) {
  return pr.tomb_p < max_probes && !mcq_landed_on(pr, key, max_probes)
             ? pr.tomb_p
             : pr.stop_p;
}

// The warp inserts key -> val into one table (every lane calls; lane 0
// writes; an insert with no place drops the key).
__device__ __forceinline__ void mcq_table_insert(volatile int32_t* keys,
                                                 volatile int32_t* vals,
                                                 uint32_t mask, int32_t key,
                                                 int32_t val, int max_probes,
                                                 int lane) {
  const McqProbe pr = mcq_probe_window(keys, vals, mask, key, max_probes, lane);
  const int p = mcq_insert_pos(pr, key, max_probes);
  if (lane == 0 && p < max_probes) {
    const uint32_t idx = (pr.h0 + static_cast<uint32_t>(p)) & mask;
    keys[idx] = key;
    vals[idx] = val;
  }
  __syncwarp();
}

// The warp deletes key from one table: its slot, if the chain holds it,
// becomes TOMB (every lane calls; lane 0 writes).
__device__ __forceinline__ void mcq_table_delete(volatile int32_t* keys,
                                                 const volatile int32_t* vals,
                                                 uint32_t mask, int32_t key,
                                                 int max_probes, int lane) {
  const McqProbe pr = mcq_probe_window(keys, vals, mask, key, max_probes, lane);
  if (lane == 0 && mcq_landed_on(pr, key, max_probes))
    keys[(pr.h0 + static_cast<uint32_t>(pr.stop_p)) & mask] = MCQ_TOMB;
  __syncwarp();
}
