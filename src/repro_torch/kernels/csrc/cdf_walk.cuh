// The cumulative-probability walk of one query by one warp (paper §II.B):
// mcq_cdf_scan / mcq_cdf_emit, 32 * V positions held in registers at once,
// shared by the pre-ordered kernel (cdf_query.cu) and the fused row-gather
// kernel (cdf_gather.cu).
//
// The walk runs in exact integer count space: position j (priority order) is
// needed iff float32(sum of counts before j) < float32(t) * float32(tot) and
// cnt_j > 0 (top-k mode: cnt_j > 0).  The prefix is a uint32 scan plus a
// uint32 carry (the int32 wrap-around in any order), so any chunking gives
// the same bits; the only float ops are the per-row t * tot and the
// per-item cnt / tot, both IEEE round-to-nearest.  A kernel leaves its walk
// once the carry has crossed t * tot (mcq_cdf_crossed): prefix counts are
// monotone, so no later position can be needed.  Every output element is
// written (EMPTY / 0.0 defaults: mcq_cdf_fill_tail, mcq_cdf_write_empty).
#pragma once

#include "common.cuh"

// One step of the walk over 32 * V priority positions already in registers:
// lane L holds the counts c[] of positions j0 .. j0 + V - 1 (0 past the row).
// A per-lane inclusive scan over its V counts, then one __shfl_up scan of the
// lane totals, give every position's prefix; the sums are uint32 (the int32
// wrap-around in any order).  Returns the lane's needed positions as a bit
// mask (bit v: position j0 + v), adds the step's needed positions to
// n_needed and its counts to carry.
template <int V>
__device__ __forceinline__ unsigned mcq_cdf_scan(const int32_t (&c)[V],
                                                 float tcnt, bool topk,
                                                 uint32_t& carry,
                                                 int& n_needed) {
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  uint32_t incl[V];
  uint32_t run = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    run += static_cast<uint32_t>(c[v]);
    incl[v] = run;
  }
  uint32_t scan = run;  // inclusive scan of the lane totals
#pragma unroll
  for (int off = 1; off < MCQ_WARP; off <<= 1) {
    const uint32_t up = __shfl_up_sync(MCQ_FULL_MASK, scan, off);
    if (lane >= off) scan += up;
  }
  const uint32_t lane_before = carry + scan - run;
  unsigned mask = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int32_t before = static_cast<int32_t>(
        lane_before + incl[v] - static_cast<uint32_t>(c[v]));
    if (c[v] > 0 && (topk || __int2float_rn(before) < tcnt)) mask |= 1u << v;
  }
  n_needed += __reduce_add_sync(MCQ_FULL_MASK, __popc(mask));
  carry += __shfl_sync(MCQ_FULL_MASK, scan, MCQ_WARP - 1);
  return mask;
}

// Once the prefix has crossed t * tot (threshold mode) no later position is
// needed: prefix counts are monotone.
__device__ __forceinline__ bool mcq_cdf_crossed(uint32_t carry, float tcnt,
                                                bool topk) {
  return !topk && !(__int2float_rn(static_cast<int32_t>(carry)) < tcnt);
}

// dst/prob of the lane's positions j0 .. j0 + V - 1 below capacity and
// max_items: d[v] and c[v] / tot where needed, EMPTY / 0.0 elsewhere.
template <int V>
__device__ __forceinline__ void mcq_cdf_emit(
    const int32_t (&c)[V], const int32_t (&d)[V], unsigned mask, int j0,
    int capacity, float totf, int max_items, int32_t* __restrict__ dst_out,
    float* __restrict__ prob_out) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = j0 + v;
    if (j < capacity && j < max_items) {
      const bool needed = (mask >> v) & 1u;
      dst_out[j] = needed ? d[v] : MCQ_EMPTY;
      prob_out[j] = needed ? __fdiv_rn(__int2float_rn(c[v]), totf) : 0.0f;
    }
  }
}

// Positions j0 .. max_items - 1 that no round wrote: EMPTY / 0.0.
__device__ __forceinline__ void mcq_cdf_fill_tail(int j0, int max_items,
                                                  int32_t* __restrict__ dq,
                                                  float* __restrict__ pq) {
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  for (int j = j0 + lane; j < max_items; j += MCQ_WARP) {
    dq[j] = MCQ_EMPTY;
    pq[j] = 0.0f;
  }
}

// Defaults of a query whose src is unknown.
__device__ __forceinline__ void mcq_cdf_write_empty(
    int max_items, int32_t* __restrict__ dst_out,
    float* __restrict__ prob_out, int32_t* __restrict__ n_out) {
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  for (int j = lane; j < max_items; j += MCQ_WARP) {
    dst_out[j] = MCQ_EMPTY;
    prob_out[j] = 0.0f;
  }
  if (lane == 0) *n_out = 0;
}
