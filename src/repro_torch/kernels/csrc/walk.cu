// k-step greedy draft walk of the n-gram drafter (speculative decoding).
//
// Each sequence walks its k dependent steps:
//   1. hash the current window newest first (h = h * 1000003 + hash_u32(tok)
//      in uint32, then clear the top bit), the context id observe() learned;
//   2. probe the flat src table for it (the probe of probe.cu);
//   3. read the order head order[row * ord_stride] — the approximate argmax —
//      and cnt/dst at that slot;
//   4. emit dst if cnt > 0 and dst != EMPTY, and shift it into the window.
// A sequence whose step fails writes token 0 / ok 0 for every later step and
// stops probing.  The chain is read-only for the launch.
//
// Bound on this card: latency.  A step moves a few bytes from tables far
// larger than the cache, and each read depends on the one before, so a
// draft's time is k times the dependent DRAM round trips of a step.  The
// window lives in registers as its tokens' hashes (shifted, never re-read
// from memory), and MCQ_WALK_LANES lanes walk each sequence: they probe that
// many slots of the chain at once (one trip for any chain that short), then
// issue the order head together with coalesced loads of the row's cnt and
// dst (C = 64 is 2 x 256 B) and pick the slot by shuffle — two trips per
// step, for C * 8 bytes per step instead of 8.  One thread per sequence
// (three trips: slot, order head, cnt and dst) was slower where a server
// meets a draft, right after a learner step (PERF.md).
#include "probe.cuh"

#define MCQ_WALK_LANES 16       // lanes per sequence; < 32, divides the warp
#define MCQ_WALK_THREADS 256    // threads per block
#define MCQ_WALK_MAX_ORDER 16   // window positions held in registers
#define MCQ_WALK_ROW_REGS 8     // row entries each lane holds

// The window as the hashes of its tokens, oldest first, in registers (every
// index is static after unrolling).
struct McqWindow {
  uint32_t hw[MCQ_WALK_MAX_ORDER];

  __device__ __forceinline__ void load(const int32_t* win, int order) {
#pragma unroll
    for (int j = 0; j < MCQ_WALK_MAX_ORDER; ++j)
      if (j < order) hw[j] = mcq_hash_u32(mcq_load_nc(win + j));
  }

  // the context id: fold newest first, top bit cleared
  __device__ __forceinline__ int32_t src(int order) const {
    uint32_t h = 0;
#pragma unroll
    for (int j = MCQ_WALK_MAX_ORDER - 1; j >= 0; --j)
      if (j < order) h = h * 1000003u + hw[j];
    return static_cast<int32_t>(h & 0x7FFFFFFFu);
  }

  __device__ __forceinline__ void push(int32_t tok, int order) {
    const uint32_t t = mcq_hash_u32(tok);
#pragma unroll
    for (int j = 0; j < MCQ_WALK_MAX_ORDER; ++j) {
      if (j + 1 < order)
        hw[j] = hw[j + 1];
      else if (j + 1 == order)
        hw[j] = t;
    }
  }
};

// The probe of mcq_probe_chain, G = MCQ_WALK_LANES slots at a time: lane l
// reads position p0 + l; the first position holding the key or EMPTY
// decides.  Every lane of the group returns the same result.
__device__ __forceinline__ bool mcq_probe_lanes(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ vals,
    int table_size, int32_t key, int max_probes, int lane, unsigned gmask,
    int gbase, int32_t* val) {
  constexpr int G = MCQ_WALK_LANES;
  if (key == MCQ_EMPTY) return false;
  const uint32_t mask = static_cast<uint32_t>(table_size - 1);
  const uint32_t h0 = mcq_hash_u32(key) & mask;
  for (int p0 = 0; p0 < max_probes; p0 += G) {
    const bool in = p0 + lane < max_probes;
    int32_t k = 0, v = 0;
    if (in) {
      const uint32_t idx = (h0 + static_cast<uint32_t>(p0 + lane)) & mask;
      k = mcq_load_nc(keys + idx);
      v = mcq_load_nc(vals + idx);
    }
    const unsigned hit = __ballot_sync(gmask, in && k == key) >> gbase;
    const unsigned end = __ballot_sync(gmask, in && k == MCQ_EMPTY) >> gbase;
    if (hit | end) {
      const int first_hit = hit ? mcq_first_lane(hit) : G;
      const int first_end = end ? mcq_first_lane(end) : G;
      if (first_hit > first_end) return false;
      *val = __shfl_sync(gmask, v, first_hit, G);
      return true;
    }
  }
  return false;
}

__global__ void __launch_bounds__(MCQ_WALK_THREADS) mcq_draft_walk_kernel(
    const int32_t* __restrict__ window, long long win_stride, int order,
    const int32_t* __restrict__ ht_keys, const int32_t* __restrict__ ht_vals,
    int table_size, const int32_t* __restrict__ cnt,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ ord0,
    long long ord_stride, int num_rows, int capacity, int steps,
    int max_probes, int32_t* __restrict__ toks, uint8_t* __restrict__ oks,
    int batch) {
  constexpr int G = MCQ_WALK_LANES;
  constexpr int R = MCQ_WALK_ROW_REGS;
  const long long i =
      (static_cast<long long>(blockIdx.x) * MCQ_WALK_THREADS + threadIdx.x) /
      G;
  if (i >= batch) return;  // a group leaves whole: G divides the warp
  const int lane = threadIdx.x & (G - 1);
  const int gbase = (threadIdx.x & (MCQ_WARP - 1)) & ~(G - 1);
  const unsigned gmask = ((1u << G) - 1u) << gbase;
  McqWindow w;
  w.load(window + i * win_stride, order);
  int32_t* tq = toks + i * steps;
  uint8_t* oq = oks + i * steps;
  int s = 0;
  for (; s < steps; ++s) {
    int32_t row = 0;
    if (!mcq_probe_lanes(ht_keys, ht_vals, table_size, w.src(order),
                         max_probes, lane, gmask, gbase, &row))
      break;
    row = min(max(row, 0), num_rows - 1);
    const int32_t* crow = cnt + static_cast<size_t>(row) * capacity;
    const int32_t* drow = dst + static_cast<size_t>(row) * capacity;
    // the order head and the row's first G * R entries, all issued together
    const int32_t slot = mcq_load_nc(ord0 + row * ord_stride);
    int32_t cv[R], dv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      cv[r] = 0;
      dv[r] = MCQ_EMPTY;
      if (lane + r * G < capacity) {
        cv[r] = mcq_load_nc(crow + lane + r * G);
        dv[r] = mcq_load_nc(drow + lane + r * G);
      }
    }
    int32_t c, d;
    if (slot < G * R) {
      c = 0;
      d = MCQ_EMPTY;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (lane + r * G == slot) {
          c = cv[r];
          d = dv[r];
        }
      }
      c = __shfl_sync(gmask, c, slot % G, G);
      d = __shfl_sync(gmask, d, slot % G, G);
    } else {  // a row wider than the group holds: one more trip
      c = mcq_load_nc(crow + slot);
      d = mcq_load_nc(drow + slot);
    }
    if (!(c > 0 && d != MCQ_EMPTY)) break;
    if (lane == 0) {
      tq[s] = d;
      oq[s] = 1;
    }
    w.push(d, order);
  }
  for (s += lane; s < steps; s += G) {  // the dead sequence's tail
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
  if (order < 1 || order > MCQ_WALK_MAX_ORDER)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(batch) * MCQ_WALK_LANES;
  const int blocks =
      static_cast<int>((threads + MCQ_WALK_THREADS - 1) / MCQ_WALK_THREADS);
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
