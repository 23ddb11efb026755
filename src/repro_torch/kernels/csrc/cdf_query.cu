// CDF threshold walk over pre-ordered rows (paper §II.B), the unfused read.
//
// One warp per query.  Row q of c_ord/d_ord[B, C] already holds the counts and
// dsts in priority order (zeros for unknown srcs), contiguous, so the warp
// reads the whole row straight: tot[q], the counts of the first 32 * V
// positions (lane L: positions L*V .. L*V + V - 1) and the dsts of those
// below max_items are independent loads, all issued before any arithmetic —
// one DRAM round trip per query.  V = ceil(C / 32) up to 8 (C <= 256: the
// whole row in one round; wider rows in rounds of 256 positions, each
// round's counts and dsts loaded together).  A lane's V positions are one or
// two 16-B loads (8 B at V = 2) when the rows are 16-B aligned and C % 4 ==
// 0, scalar loads otherwise.
//
// The walk in registers is mcq_cdf_scan / mcq_cdf_emit / mcq_cdf_crossed of
// cdf_walk.cuh, with its exactness contract, shared with the fused kernel.
// Threshold mode stops after the round whose prefix crosses t * tot; by the
// integer-walk contract the bits equal the TPU kernel's block-granular exit.
#include "cdf_walk.cuh"

#define MCQ_CDF_WARPS 4

// V consecutive int32 of p from position j0, ``fill`` at and past ``limit``.
// kVec: p is 16-B aligned and j0 a multiple of min(V, 4), so a run inside
// the limit is read as V / 4 int4 loads (one int2 at V = 2).
template <int V, bool kVec>
__device__ __forceinline__ void mcq_load_run(const int32_t* __restrict__ p,
                                             int j0, int limit, int32_t fill,
                                             int32_t (&out)[V]) {
  if constexpr (kVec && V % 4 == 0) {
    if (j0 + V <= limit) {
#pragma unroll
      for (int u = 0; u < V / 4; ++u) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(p + j0) + u);
        out[4 * u] = x.x;
        out[4 * u + 1] = x.y;
        out[4 * u + 2] = x.z;
        out[4 * u + 3] = x.w;
      }
      return;
    }
  } else if constexpr (kVec && V == 2) {
    if (j0 + V <= limit) {
      const int2 x = __ldg(reinterpret_cast<const int2*>(p + j0));
      out[0] = x.x;
      out[1] = x.y;
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
    out[v] = j0 + v < limit ? __ldg(p + j0 + v) : fill;
}

template <int V, bool kVec>
__global__ void __launch_bounds__(MCQ_CDF_WARPS * MCQ_WARP)
    mcq_cdf_query_kernel(const int32_t* __restrict__ c_ord,
                         const int32_t* __restrict__ d_ord,
                         const int32_t* __restrict__ tot, float t, int topk,
                         int32_t* __restrict__ dst_out,
                         float* __restrict__ prob_out,
                         int32_t* __restrict__ n_out, int batch, int capacity,
                         int max_items) {
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  const long long q = static_cast<long long>(blockIdx.x) * MCQ_CDF_WARPS +
                      (threadIdx.x / MCQ_WARP);
  if (q >= batch) return;  // whole warp leaves together
  const size_t base = static_cast<size_t>(q) * capacity;
  const int32_t* c_row = c_ord + base;
  const int32_t* d_row = d_ord + base;
  int32_t* dq = dst_out + static_cast<size_t>(q) * max_items;
  float* pq = prob_out + static_cast<size_t>(q) * max_items;
  const int emit = max_items < capacity ? max_items : capacity;
  // one trip: tot, the round's counts, the dsts it may emit
  const int32_t total = __ldg(tot + q);
  int s0 = 0;
  int32_t c[V], d[V];
  mcq_load_run<V, kVec>(c_row, lane * V, capacity, 0, c);
  mcq_load_run<V, kVec>(d_row, lane * V, emit, MCQ_EMPTY, d);
  const float totf = __int2float_rn(total > 1 ? total : 1);
  const float tcnt = __fmul_rn(t, totf);
  const bool is_topk = topk != 0;
  uint32_t carry = 0;
  int n_needed = 0;
  for (;;) {
    const int j0 = s0 + lane * V;
    const unsigned mask = mcq_cdf_scan<V>(c, tcnt, is_topk, carry, n_needed);
    mcq_cdf_emit<V>(c, d, mask, j0, capacity, totf, max_items, dq, pq);
    s0 += V * MCQ_WARP;
    if (s0 >= capacity || mcq_cdf_crossed(carry, tcnt, is_topk)) break;
    mcq_load_run<V, kVec>(c_row, s0 + lane * V, capacity, 0, c);
    mcq_load_run<V, kVec>(d_row, s0 + lane * V, emit, MCQ_EMPTY, d);
  }
  mcq_cdf_fill_tail(s0 < capacity ? s0 : capacity, max_items, dq, pq);
  if (lane == 0) n_out[q] = n_needed;
}

template <int V>
static void mcq_cdf_query_launch(bool vec, int blocks, cudaStream_t stream,
                                 const int32_t* c_ord, const int32_t* d_ord,
                                 const int32_t* tot, float t, int topk,
                                 int32_t* dst_out, float* prob_out,
                                 int32_t* n_out, int batch, int capacity,
                                 int max_items) {
  if (vec)
    mcq_cdf_query_kernel<V, true><<<blocks, MCQ_CDF_WARPS * MCQ_WARP, 0,
                                    stream>>>(
        c_ord, d_ord, tot, t, topk, dst_out, prob_out, n_out, batch, capacity,
        max_items);
  else
    mcq_cdf_query_kernel<V, false><<<blocks, MCQ_CDF_WARPS * MCQ_WARP, 0,
                                     stream>>>(
        c_ord, d_ord, tot, t, topk, dst_out, prob_out, n_out, batch, capacity,
        max_items);
}

extern "C" int mcq_cdf_query(const void* c_ord, const void* d_ord,
                             const void* tot, float t, int topk, void* dst_out,
                             void* prob_out, void* n_out, int batch,
                             int capacity, int max_items, void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + MCQ_CDF_WARPS - 1) / MCQ_CDF_WARPS;
  const bool vec = capacity % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(c_ord) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(d_ord) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int32_t*>(c_ord);
  const auto* d = static_cast<const int32_t*>(d_ord);
  const auto* tt = static_cast<const int32_t*>(tot);
  auto* dout = static_cast<int32_t*>(dst_out);
  auto* pout = static_cast<float*>(prob_out);
  auto* nout = static_cast<int32_t*>(n_out);
#define MCQ_CDF_CASE(V)                                                        \
  mcq_cdf_query_launch<V>(vec, blocks, s, c, d, tt, t, topk, dout, pout,       \
                          nout, batch, capacity, max_items)
  if (capacity <= 32) MCQ_CDF_CASE(1);
  else if (capacity <= 64) MCQ_CDF_CASE(2);
  else if (capacity <= 128) MCQ_CDF_CASE(4);
  else MCQ_CDF_CASE(8);
#undef MCQ_CDF_CASE
  return mcq_launch_status();
}
