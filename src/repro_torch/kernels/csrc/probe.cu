// Batched open-addressing probe: one flat table keys/vals[H] (rows null, the
// src table at the head of every update and query), or a stack of tables
// keys/vals[N, H] picked per query by rows[B] (rows < 0 = padding, the
// per-row dst hash).
//
// One thread per query, one launch per batch.  A query touches only its own
// probe chain (mcq_probe_chain in probe.cuh, shared with slow_path.cu):
// from the home slot hash_u32(key) & (H-1) it walks at most max_probes slots,
// stops at the key (found) or at the first EMPTY (missing) and walks through
// TOMB; the key -1 (EMPTY) is a miss without a table read.
//
// Bound on this card: latency and launches.  The outputs are written in the
// caller's final form — found as bool, slot = the value, or `miss` where
// not found (EMPTY for ht_find / dh_find, 0 for lookup_rows) — so a lookup
// is this one launch and nothing around it.  A home-slot hit costs the
// query's own key load and one round trip for the slot's key and value.
#include "probe.cuh"

// Threads per block.  Every size from 32 to 512 timed within 0.0002 ms of
// the others on an H100 at B = 65,536 and B = 4,096 (PERF.md): the time is
// the launch and the round trips, not occupancy.
#define MCQ_PROBE_THREADS 128

template <bool kFlat>
__global__ void __launch_bounds__(MCQ_PROBE_THREADS) mcq_probe_find_kernel(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ keys_q,
    const int32_t* __restrict__ tab_keys, const int32_t* __restrict__ tab_vals,
    int32_t* __restrict__ slots, uint8_t* __restrict__ found, int batch,
    int table_size, int max_probes, int32_t miss) {
  const int i = blockIdx.x * MCQ_PROBE_THREADS + threadIdx.x;
  if (i >= batch) return;
  const int32_t key = mcq_load_nc(keys_q + i);
  size_t base = 0;
  bool live = true;
  if (!kFlat) {
    const int32_t row = mcq_load_nc(rows + i);
    live = row >= 0;
    base = static_cast<size_t>(live ? row : 0) * table_size;
  }
  int32_t val = miss;
  const bool hit = live && mcq_probe_chain(tab_keys + base, tab_vals + base,
                                           table_size, key, max_probes, &val);
  slots[i] = hit ? val : miss;
  found[i] = hit ? 1 : 0;
}

extern "C" int mcq_probe_find(const void* rows, const void* keys_q,
                              const void* tab_keys, const void* tab_vals,
                              void* slots, void* found, int batch,
                              int table_size, int max_probes, int miss,
                              void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + MCQ_PROBE_THREADS - 1) / MCQ_PROBE_THREADS;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto r = static_cast<const int32_t*>(rows);
  const auto q = static_cast<const int32_t*>(keys_q);
  const auto tk = static_cast<const int32_t*>(tab_keys);
  const auto tv = static_cast<const int32_t*>(tab_vals);
  const auto out = static_cast<int32_t*>(slots);
  const auto hit = static_cast<uint8_t*>(found);
  if (rows == nullptr)
    mcq_probe_find_kernel<true><<<blocks, MCQ_PROBE_THREADS, 0, s>>>(
        r, q, tk, tv, out, hit, batch, table_size, max_probes, miss);
  else
    mcq_probe_find_kernel<false><<<blocks, MCQ_PROBE_THREADS, 0, s>>>(
        r, q, tk, tv, out, hit, batch, table_size, max_probes, miss);
  return mcq_launch_status();
}
