// CDF threshold walk over pre-ordered rows (paper §II.B), the unfused read.
//
// One warp per query.  Row q of c_ord/d_ord[B, C] already holds the counts and
// dsts in priority order (zeros for unknown srcs), so the warp walks them
// straight from device memory with the same walk as the fused kernel
// (cdf_walk.cuh): an int32 warp scan per 32 positions, an int32 carry, and an
// exit once the carry has crossed t * tot.  The exit is per query; by the
// integer-walk contract the bits equal the TPU kernel's block-granular exit.
#include "cdf_walk.cuh"

#define MCQ_CDF_WARPS 4

struct McqOrderedRowSource {
  const int32_t* c_row;
  const int32_t* d_row;
  __device__ __forceinline__ int32_t count(int j, int32_t* token) const {
    *token = j;
    return c_row[j];
  }
  __device__ __forceinline__ int32_t dst(int j, int32_t token) const {
    return d_row[token];
  }
};

__global__ void mcq_cdf_query_kernel(
    const int32_t* __restrict__ c_ord, const int32_t* __restrict__ d_ord,
    const int32_t* __restrict__ tot, float t, int topk,
    int32_t* __restrict__ dst_out, float* __restrict__ prob_out,
    int32_t* __restrict__ n_out, int batch, int capacity, int max_items) {
  const long long q = static_cast<long long>(blockIdx.x) * MCQ_CDF_WARPS +
                      (threadIdx.x / MCQ_WARP);
  if (q >= batch) return;  // whole warp leaves together
  const size_t base = static_cast<size_t>(q) * capacity;
  const McqOrderedRowSource source{c_ord + base, d_ord + base};
  mcq_cdf_walk_warp(source, capacity, tot[q], t, topk != 0, max_items,
                    dst_out + static_cast<size_t>(q) * max_items,
                    prob_out + static_cast<size_t>(q) * max_items, n_out + q);
}

extern "C" int mcq_cdf_query(const void* c_ord, const void* d_ord,
                             const void* tot, float t, int topk, void* dst_out,
                             void* prob_out, void* n_out, int batch,
                             int capacity, int max_items, void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + MCQ_CDF_WARPS - 1) / MCQ_CDF_WARPS;
  mcq_cdf_query_kernel<<<blocks, MCQ_CDF_WARPS * MCQ_WARP, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(c_ord), static_cast<const int32_t*>(d_ord),
      static_cast<const int32_t*>(tot), t, topk,
      static_cast<int32_t*>(dst_out), static_cast<float*>(prob_out),
      static_cast<int32_t*>(n_out), batch, capacity, max_items);
  return mcq_launch_status();
}
