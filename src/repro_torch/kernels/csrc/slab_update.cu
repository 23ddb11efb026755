// Fast-path batched increment of existing edges, in place.
//
// One warp per item (row, dst, w).  The warp scans dst_slab[row, :] 32 slots
// at a time (coalesced), takes the LOWEST matching slot (ballot + ffs) and
// lane 0 adds w to cnt[row, slot] and tot[row] with int32 atomics, and sets
// dirty[row] (uint8 per row, or null).  Integer atomics are exact and
// order-free, so duplicate items and several items on one row need no
// ordering.  cnt/tot are the caller's own (the state's owner, or a copy the
// functional wrapper made); absent edges and rows < 0 are no-ops.  Any
// capacity >= 1.
#include "common.cuh"

__global__ void mcq_slab_update_kernel(const int32_t* __restrict__ rows,
                                       const int32_t* __restrict__ dsts,
                                       const int32_t* __restrict__ w,
                                       const int32_t* __restrict__ dst_slab,
                                       int32_t* cnt, int32_t* tot,
                                       uint8_t* __restrict__ dirty, int batch,
                                       int capacity) {
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  const int warps_per_block = blockDim.x / MCQ_WARP;
  const long long item =
      static_cast<long long>(blockIdx.x) * warps_per_block +
      (threadIdx.x / MCQ_WARP);
  if (item >= batch) return;  // whole warp leaves together
  const int32_t row = rows[item];
  if (row < 0) return;
  const int32_t d = dsts[item];
  const size_t base = static_cast<size_t>(row) * capacity;
  for (int c0 = 0; c0 < capacity; c0 += MCQ_WARP) {
    const int j = c0 + lane;
    const bool hit = (j < capacity) && (dst_slab[base + j] == d);
    const unsigned hits = __ballot_sync(MCQ_FULL_MASK, hit);
    if (hits) {
      if (lane == 0) {
        const int32_t wi = w[item];
        atomicAdd(cnt + base + c0 + mcq_first_lane(hits), wi);
        atomicAdd(tot + row, wi);
        if (dirty != nullptr) dirty[row] = 1;
      }
      return;
    }
  }
}

extern "C" int mcq_slab_update(const void* rows, const void* dsts,
                               const void* w, const void* dst_slab, void* cnt,
                               void* tot, void* dirty, int batch, int capacity,
                               void* stream) {
  if (batch <= 0) return 0;
  const int threads = 256;
  const int warps_per_block = threads / MCQ_WARP;
  const int blocks = (batch + warps_per_block - 1) / warps_per_block;
  mcq_slab_update_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(dsts),
      static_cast<const int32_t*>(w), static_cast<const int32_t*>(dst_slab),
      static_cast<int32_t*>(cnt), static_cast<int32_t*>(tot),
      static_cast<uint8_t*>(dirty), batch, capacity);
  return mcq_launch_status();
}
