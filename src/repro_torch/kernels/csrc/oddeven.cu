// Odd-even transposition passes over every slab row (the paper's lock-free
// bubble sort), into order_out: a fresh tensor, or order itself.
//
// One warp per row.  The warp gathers the row's counts into priority order
// (c[j] = cnt[row, order[row, j]]) into shared memory ONCE, runs all
// `passes` x (even, odd) compare-exchange sweeps there (a lane per pair,
// __syncwarp between half-passes), and writes the order back once: one global
// read of cnt and order and at most one write of order per row whatever
// `passes` is.  Descending target, strict <, so equal counts never swap.  Any
// capacity >= 1 (an unpaired tail element just stays).
//
// In place (order_out == order) a row in which no pair swapped is the row it
// was -- a swap only removes an inversion -- so its warp writes nothing; a
// row that changed is written and flagged in dirty (uint8 per row, or null).
// The whole row is read into shared memory before any of it is written, so
// order and order_out carry no __restrict__.
#include "common.cuh"

#define MCQ_ODDEVEN_WARPS 4

__global__ void mcq_oddeven_kernel(const int32_t* __restrict__ cnt,
                                   const int32_t* order, int32_t* order_out,
                                   uint8_t* __restrict__ dirty,
                                   long long num_rows, int capacity,
                                   int passes) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  const int warp = threadIdx.x / MCQ_WARP;
  const long long row =
      static_cast<long long>(blockIdx.x) * MCQ_ODDEVEN_WARPS + warp;
  if (row >= num_rows) return;  // whole warp leaves together
  int32_t* c = smem + static_cast<size_t>(warp) * 2 * capacity;
  int32_t* o = c + capacity;
  const size_t base = static_cast<size_t>(row) * capacity;
  for (int j = lane; j < capacity; j += MCQ_WARP) {
    const int32_t slot = order[base + j];
    o[j] = slot;
    c[j] = cnt[base + slot];
  }
  __syncwarp();
  bool swapped = false;
  for (int pass = 0; pass < passes; ++pass) {
    for (int start = 0; start < 2; ++start) {
      for (int left = start + 2 * lane; left + 1 < capacity;
           left += 2 * MCQ_WARP) {
        const int32_t cl = c[left], cr = c[left + 1];
        if (cl < cr) {
          const int32_t ol = o[left], orr = o[left + 1];
          c[left] = cr;
          c[left + 1] = cl;
          o[left] = orr;
          o[left + 1] = ol;
          swapped = true;
        }
      }
      __syncwarp();
    }
  }
  const bool changed = __ballot_sync(MCQ_FULL_MASK, swapped) != 0;
  if (!changed && order_out == order) return;
  for (int j = lane; j < capacity; j += MCQ_WARP) order_out[base + j] = o[j];
  if (changed && dirty != nullptr && lane == 0) dirty[row] = 1;
}

extern "C" int mcq_oddeven(const void* cnt, const void* order,
                           void* order_out, void* dirty, long long num_rows,
                           int capacity, int passes, void* stream) {
  if (num_rows <= 0 || capacity <= 0) return 0;
  const size_t smem =
      static_cast<size_t>(MCQ_ODDEVEN_WARPS) * 2 * capacity * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mcq_oddeven_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks =
      (num_rows + MCQ_ODDEVEN_WARPS - 1) / MCQ_ODDEVEN_WARPS;
  mcq_oddeven_kernel<<<static_cast<unsigned>(blocks),
                       MCQ_ODDEVEN_WARPS * MCQ_WARP, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cnt), static_cast<const int32_t*>(order),
      static_cast<int32_t*>(order_out), static_cast<uint8_t*>(dirty), num_rows,
      capacity, passes);
  return mcq_launch_status();
}
