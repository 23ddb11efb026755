// k-step greedy draft walk of the n-gram drafter (speculative decoding).
//
// One thread per sequence walks its k dependent steps:
//   1. hash the current window newest first (h = h * 1000003 + hash_u32(tok)
//      in uint32, then clear the top bit), the context id observe() learned;
//   2. probe the flat src table for it (mcq_probe_chain, the probe of
//      probe.cu);
//   3. read the order head order[row * ord_stride] — the approximate argmax —
//      and cnt/dst at that slot;
//   4. emit dst if cnt > 0 and dst != EMPTY, and shift it into the window.
// The window of step s is tokens s .. s+order-1 of (window ++ emitted), so the
// thread reads the tokens it emitted back from its own output row.  A lane
// whose step fails writes token 0 / ok 0 for every later step and stops
// probing.  The chain is read-only for the launch.
#include "probe.cuh"

#define MCQ_WALK_THREADS 64

__device__ __forceinline__ uint32_t mcq_ctx_hash_fold(uint32_t h,
                                                      int32_t tok) {
  return h * 1000003u + mcq_hash_u32(tok);
}

__global__ void mcq_draft_walk_kernel(
    const int32_t* __restrict__ window, long long win_stride, int order,
    const int32_t* __restrict__ ht_keys, const int32_t* __restrict__ ht_vals,
    int table_size, const int32_t* __restrict__ cnt,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ ord0,
    long long ord_stride, int num_rows, int capacity, int steps,
    int max_probes, int32_t* __restrict__ toks, uint8_t* __restrict__ oks,
    int batch) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= batch) return;
  const int32_t* win = window + i * win_stride;
  int32_t* tq = toks + i * steps;
  uint8_t* oq = oks + i * steps;
  int s = 0;
  for (; s < steps; ++s) {
    uint32_t h = 0;
    for (int j = order - 1; j >= 0; --j) {  // newest first
      const int p = s + j;
      h = mcq_ctx_hash_fold(h, p < order ? win[p] : tq[p - order]);
    }
    const int32_t src = static_cast<int32_t>(h & 0x7FFFFFFFu);
    int32_t row = 0;
    if (!mcq_probe_chain(ht_keys, ht_vals, table_size, src, max_probes, &row))
      break;
    row = min(max(row, 0), num_rows - 1);
    const int32_t slot = ord0[row * ord_stride];
    const size_t at = static_cast<size_t>(row) * capacity + slot;
    const int32_t c = cnt[at];
    const int32_t d = dst[at];
    if (!(c > 0 && d != MCQ_EMPTY)) break;
    tq[s] = d;
    oq[s] = 1;
  }
  for (; s < steps; ++s) {  // the dead lane's tail
    tq[s] = 0;
    oq[s] = 0;
  }
}

extern "C" int mcq_draft_walk(const void* window, long long win_stride,
                              int order, const void* ht_keys,
                              const void* ht_vals, int table_size,
                              const void* cnt, const void* dst,
                              const void* ord0, long long ord_stride,
                              int num_rows, int capacity, int steps,
                              int max_probes, void* toks, void* oks, int batch,
                              void* stream) {
  if (batch <= 0 || steps <= 0) return 0;
  const int blocks = (batch + MCQ_WALK_THREADS - 1) / MCQ_WALK_THREADS;
  mcq_draft_walk_kernel<<<blocks, MCQ_WALK_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(window), win_stride, order,
      static_cast<const int32_t*>(ht_keys),
      static_cast<const int32_t*>(ht_vals), table_size,
      static_cast<const int32_t*>(cnt), static_cast<const int32_t*>(dst),
      static_cast<const int32_t*>(ord0), ord_stride, num_rows, capacity, steps,
      max_probes, static_cast<int32_t*>(toks), static_cast<uint8_t*>(oks),
      batch);
  return mcq_launch_status();
}
