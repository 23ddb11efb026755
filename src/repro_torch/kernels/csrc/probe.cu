// Batched open-addressing probe over a stack of tables keys/vals[N, H].
//
// One thread per query.  A query touches only its own probe chain: from the
// home slot hash_u32(key) & (H-1) it walks at most max_probes slots (wrapping
// with & (H-1)), stops at the key (found) or at the first EMPTY (missing) and
// walks through TOMB.  rows[i] < 0 marks padding: slot EMPTY, found 0.
#include "common.cuh"

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
    const int32_t key = keys_q[i];
    const uint32_t mask = static_cast<uint32_t>(table_size - 1);
    const uint32_t h0 = mcq_hash_u32(key) & mask;
    const size_t base = static_cast<size_t>(row) * table_size;
    for (int p = 0; p < max_probes; ++p) {
      const uint32_t idx = (h0 + static_cast<uint32_t>(p)) & mask;
      const int32_t k = tab_keys[base + idx];
      // EMPTY first: probing for the EMPTY value itself is a miss
      if (k == MCQ_EMPTY) break;
      if (k == key) {
        slot = tab_vals[base + idx];
        hit = 1;
        break;
      }
    }
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
