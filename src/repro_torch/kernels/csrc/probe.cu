// Batched open-addressing probe over a stack of tables keys/vals[N, H].
//
// One thread per query.  A query touches only its own probe chain (the loop
// is mcq_probe_chain in probe.cuh, shared with the draft walk): from the home
// slot hash_u32(key) & (H-1) it walks at most max_probes slots, stops at the
// key (found) or at the first EMPTY (missing) and walks through TOMB.
// rows[i] < 0 marks padding: slot EMPTY, found 0.
#include "probe.cuh"

__global__ void mcq_probe_find_kernel(const int32_t* __restrict__ rows,
                                      const int32_t* __restrict__ keys_q,
                                      const int32_t* __restrict__ tab_keys,
                                      const int32_t* __restrict__ tab_vals,
                                      int32_t* __restrict__ slots,
                                      int32_t* __restrict__ found,
                                      int batch, int table_size,
                                      int max_probes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch) return;
  const int32_t row = rows[i];
  int32_t slot = MCQ_EMPTY;
  int32_t hit = 0;
  if (row >= 0) {
    const size_t base = static_cast<size_t>(row) * table_size;
    hit = mcq_probe_chain(tab_keys + base, tab_vals + base, table_size,
                          keys_q[i], max_probes, &slot)
              ? 1
              : 0;
  }
  slots[i] = slot;
  found[i] = hit;
}

extern "C" int mcq_probe_find(const void* rows, const void* keys_q,
                              const void* tab_keys, const void* tab_vals,
                              void* slots, void* found, int batch,
                              int table_size, int max_probes, void* stream) {
  if (batch <= 0) return 0;
  const int threads = 128;
  const int blocks = (batch + threads - 1) / threads;
  mcq_probe_find_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(keys_q),
      static_cast<const int32_t*>(tab_keys),
      static_cast<const int32_t*>(tab_vals), static_cast<int32_t*>(slots),
      static_cast<int32_t*>(found), batch, table_size, max_probes);
  return mcq_launch_status();
}
