// Fused row gather + CDF threshold walk (paper §II.B).
//
// One warp per query.  The warp loads its own rows[q] / found[q], then walks
// the row in priority order: cnt[row, order[row, j]] for the counts, and
// dst[row, order[row, j]] only for needed positions inside the max_items
// emission window.  Only queried rows are touched, and only as far as the
// walk goes (see cdf_walk.cuh for the walk and its exactness contract).
#include "cdf_walk.cuh"

#define MCQ_CDF_WARPS 4

struct McqSlabRowSource {
  const int32_t* cnt_row;
  const int32_t* dst_row;
  const int32_t* order_row;
  __device__ __forceinline__ int32_t count(int j, int32_t* token) const {
    const int32_t slot = order_row[j];
    *token = slot;
    return cnt_row[slot];
  }
  __device__ __forceinline__ int32_t dst(int j, int32_t token) const {
    return dst_row[token];
  }
};

__global__ void mcq_cdf_query_fused_kernel(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ found,
    const int32_t* __restrict__ cnt, const int32_t* __restrict__ dst,
    const int32_t* __restrict__ order, const int32_t* __restrict__ tot,
    float t, int topk, int32_t* __restrict__ dst_out,
    float* __restrict__ prob_out, int32_t* __restrict__ n_out, int batch,
    int capacity, int max_items) {
  const long long q = static_cast<long long>(blockIdx.x) * MCQ_CDF_WARPS +
                      (threadIdx.x / MCQ_WARP);
  if (q >= batch) return;  // whole warp leaves together
  int32_t* dq = dst_out + static_cast<size_t>(q) * max_items;
  float* pq = prob_out + static_cast<size_t>(q) * max_items;
  if (found[q] == 0) {
    mcq_cdf_write_empty(max_items, dq, pq, n_out + q);
    return;
  }
  const int32_t row = rows[q] > 0 ? rows[q] : 0;
  const size_t base = static_cast<size_t>(row) * capacity;
  const McqSlabRowSource source{cnt + base, dst + base, order + base};
  mcq_cdf_walk_warp(source, capacity, tot[row], t, topk != 0, max_items, dq,
                    pq, n_out + q);
}

extern "C" int mcq_cdf_query_fused(const void* rows, const void* found,
                                   const void* cnt, const void* dst,
                                   const void* order, const void* tot, float t,
                                   int topk, void* dst_out, void* prob_out,
                                   void* n_out, int batch, int capacity,
                                   int max_items, void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + MCQ_CDF_WARPS - 1) / MCQ_CDF_WARPS;
  mcq_cdf_query_fused_kernel<<<blocks, MCQ_CDF_WARPS * MCQ_WARP, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(found),
      static_cast<const int32_t*>(cnt), static_cast<const int32_t*>(dst),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(tot), t,
      topk, static_cast<int32_t*>(dst_out), static_cast<float*>(prob_out),
      static_cast<int32_t*>(n_out), batch, capacity, max_items);
  return mcq_launch_status();
}
