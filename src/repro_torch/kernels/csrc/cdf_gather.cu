// Fused row gather + CDF threshold walk (paper §II.B).
//
// One warp per query; trip 1: every lane loads rows[q] and found[q] (bool).
// The cost at a few thousand queries is the DRAM sectors touched and the
// dependent trips, so the walk reads as little of the row as it needs: in
// rounds of 32 * V priority positions, the round's order positions, then
// cnt[order[j]] and, below max_items, dst[order[j]] gathered together.
//
//   threshold mode: 32 positions per round (V = 1), and the walk stops once
//     the prefix has crossed t * tot, so the traffic follows CDF^-1(t):
//     three trips when the first 32 positions cross, as they do for most
//     rows;
//   top-k mode (every position is walked): the whole row in one round of
//     32 * V positions (V = 2 at C = 64, 4 at C = 128); rows wider than 256
//     positions walk 256 per round.
//
// The walk is mcq_cdf_scan / mcq_cdf_emit in cdf_walk.cuh, with its
// exactness contract.
#include <stdint.h>

#include "cdf_walk.cuh"

#define MCQ_CDF_WARPS 4

// V consecutive int32 of p starting at j0 (0 past capacity).
template <int V>
__device__ __forceinline__ void mcq_load_chunk(const int32_t* __restrict__ p,
                                               int j0, int capacity,
                                               int32_t (&out)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v)
    out[v] = j0 + v < capacity ? __ldg(p + j0 + v) : 0;
}

// The walk in rounds of 32 * V positions gathered from device memory: the
// round's order positions, then their counts and (below max_items) dsts
// together; stops after the round whose prefix crosses t * tot.
template <int V>
__device__ __forceinline__ void mcq_cdf_gather_walk(
    const int32_t* __restrict__ cnt_row, const int32_t* __restrict__ dst_row,
    const int32_t* __restrict__ order_row, int capacity, float tcnt,
    float totf, bool topk, int max_items, int32_t* __restrict__ dq,
    float* __restrict__ pq, int& n_needed) {
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  uint32_t carry = 0;
  int s0 = 0;
  int32_t o[V];  // the first round's positions: predicated loads, no branch
  mcq_load_chunk<V>(order_row, lane * V, capacity, o);
  for (;;) {
    const int j0 = s0 + lane * V;
    int32_t c[V], d[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = j0 + v;
      c[v] = j < capacity ? __ldg(cnt_row + o[v]) : 0;
      d[v] = j < capacity && j < max_items ? __ldg(dst_row + o[v]) : MCQ_EMPTY;
    }
    s0 += V * MCQ_WARP;
    const unsigned mask = mcq_cdf_scan<V>(c, tcnt, topk, carry, n_needed);
    mcq_cdf_emit<V>(c, d, mask, j0, capacity, totf, max_items, dq, pq);
    if (s0 >= capacity || mcq_cdf_crossed(carry, tcnt, topk)) break;
    mcq_load_chunk<V>(order_row, s0 + lane * V, capacity, o);
  }
  mcq_cdf_fill_tail(s0 < capacity ? s0 : capacity, max_items, dq, pq);
}

// V = the top-k walk's positions per lane: rows of C <= 32 * V are read in
// one round, wider rows (V = 8) in rounds of 256 positions.
template <int V>
__global__ void __launch_bounds__(MCQ_CDF_WARPS * MCQ_WARP)
    mcq_cdf_query_fused_kernel(
        const int32_t* __restrict__ rows, const uint8_t* __restrict__ found,
        const int32_t* __restrict__ cnt, const int32_t* __restrict__ dst,
        const int32_t* __restrict__ order, const int32_t* __restrict__ tot,
        float t, int topk, int32_t* __restrict__ dst_out,
        float* __restrict__ prob_out, int32_t* __restrict__ n_out, int batch,
        int capacity, int max_items) {
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  const int warp = threadIdx.x / MCQ_WARP;
  const long long q = static_cast<long long>(blockIdx.x) * MCQ_CDF_WARPS + warp;
  if (q >= batch) return;  // whole warp leaves together
  int32_t* dq = dst_out + static_cast<size_t>(q) * max_items;
  float* pq = prob_out + static_cast<size_t>(q) * max_items;
  const bool hit = found[q] != 0;
  const int32_t r = rows[q];
  if (!hit) {
    mcq_cdf_write_empty(max_items, dq, pq, n_out + q);
    return;
  }
  const int32_t row = r > 0 ? r : 0;
  const size_t base = static_cast<size_t>(row) * capacity;
  const int32_t total = __ldg(tot + row);
  const float totf = __int2float_rn(total > 1 ? total : 1);
  const float tcnt = __fmul_rn(t, totf);
  int n_needed = 0;
  if (topk == 0)
    mcq_cdf_gather_walk<1>(cnt + base, dst + base, order + base, capacity,
                           tcnt, totf, false, max_items, dq, pq, n_needed);
  else
    mcq_cdf_gather_walk<V>(cnt + base, dst + base, order + base, capacity,
                           tcnt, totf, true, max_items, dq, pq, n_needed);
  if (lane == 0) n_out[q] = n_needed;
}

template <int V>
static void mcq_cdf_fused_launch(int blocks, cudaStream_t stream,
                                 const int32_t* rows, const uint8_t* found,
                                 const int32_t* cnt, const int32_t* dst,
                                 const int32_t* order, const int32_t* tot,
                                 float t, int topk, int32_t* dst_out,
                                 float* prob_out, int32_t* n_out, int batch,
                                 int capacity, int max_items) {
  mcq_cdf_query_fused_kernel<V><<<blocks, MCQ_CDF_WARPS * MCQ_WARP, 0,
                                  stream>>>(
      rows, found, cnt, dst, order, tot, t, topk, dst_out, prob_out, n_out,
      batch, capacity, max_items);
}

extern "C" int mcq_cdf_query_fused(const void* rows, const void* found,
                                   const void* cnt, const void* dst,
                                   const void* order, const void* tot, float t,
                                   int topk, void* dst_out, void* prob_out,
                                   void* n_out, int batch, int capacity,
                                   int max_items, void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + MCQ_CDF_WARPS - 1) / MCQ_CDF_WARPS;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* f = static_cast<const uint8_t*>(found);
  const auto* c = static_cast<const int32_t*>(cnt);
  const auto* d = static_cast<const int32_t*>(dst);
  const auto* o = static_cast<const int32_t*>(order);
  const auto* tt = static_cast<const int32_t*>(tot);
  auto* dout = static_cast<int32_t*>(dst_out);
  auto* pout = static_cast<float*>(prob_out);
  auto* nout = static_cast<int32_t*>(n_out);
#define MCQ_CDF_CASE(V)                                                        \
  mcq_cdf_fused_launch<V>(blocks, s, r, f, c, d, o, tt, t, topk, dout, pout,   \
                          nout, batch, capacity, max_items)
  if (capacity <= 32) MCQ_CDF_CASE(1);
  else if (capacity <= 64) MCQ_CDF_CASE(2);
  else if (capacity <= 128) MCQ_CDF_CASE(4);
  else MCQ_CDF_CASE(8);
#undef MCQ_CDF_CASE
  return mcq_launch_status();
}
