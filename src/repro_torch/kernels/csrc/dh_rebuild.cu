// Rebuild every row's dst hash from the slab (paper §II.2), decided on the
// device.
//
// Replaces src/repro/core/mcprioq.py:196 _dh_rebuild_all under the lax.cond
// of :608-616: when dh_tombstones > threshold (threshold =
// int32(dh_rebuild_fraction * num_rows * H)), every row's table becomes a
// fresh EMPTY table and dst[r, i] -> i is inserted for i ascending wherever
// cnt[r, i] > 0; then dh_tombstones = 0 and dh_rebuilds += 1.
// counters = {dh_rebuilds, dh_tombstones}, two int32 of the state.
//
// One warp per row.  The row's table (H keys and H values, H * 8 bytes) is
// staged in shared memory: the warp fills it with EMPTY, reads the row's cnt
// and dst 32 slots at a time (coalesced), inserts the live slots in slot
// order -- each insert one warp-wide probe of the window, a ballot over 32
// positions (probe_window.cuh, the same probe as the new-edge pass) -- and
// writes the table out once (coalesced).  So device memory sees one read of
// cnt/dst and one write of the row hashes.
//
// The decision is taken on the device: the row launch follows the decay's
// repair in stream order, reads dh_tombstones and fire (a device bool, or
// null for "always") and returns at once when either says no; the counters
// are written by a one-thread launch after the rows, since every warp of
// the row launch reads dh_tombstones.  dirty (uint8 per row, or null): every
// row is flagged when the rebuild runs.
#include "probe_window.cuh"

#define MCQ_DHR_WARPS 4         // warps (rows) per block
#define MCQ_DHR_BLOCKS 2048     // grid cap; warps stride over the rows
#define MCQ_DHR_SMEM_DEFAULT (48 * 1024)

__device__ __forceinline__ bool mcq_dh_rebuild_due(
    const int32_t* counters, const uint8_t* fire, int threshold) {
  return (fire == nullptr || *fire != 0) && counters[1] > threshold;
}

__global__ void __launch_bounds__(MCQ_DHR_WARPS * MCQ_WARP)
    mcq_dh_rebuild_rows_kernel(const int32_t* __restrict__ cnt,
                               const int32_t* __restrict__ dst,
                               int32_t* __restrict__ dh_keys,
                               int32_t* __restrict__ dh_vals,
                               const int32_t* counters,
                               const uint8_t* __restrict__ fire,
                               uint8_t* __restrict__ dirty,
                               long long num_rows, int capacity, int dh_size,
                               int max_probes, int threshold) {
  extern __shared__ int32_t tables[];
  if (!mcq_dh_rebuild_due(counters, fire, threshold)) return;
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  const int warp = threadIdx.x / MCQ_WARP;
  volatile int32_t* sk = tables + static_cast<size_t>(warp) * 2 * dh_size;
  volatile int32_t* sv = sk + dh_size;
  const uint32_t mask = static_cast<uint32_t>(dh_size - 1);
  const long long stride = static_cast<long long>(gridDim.x) * MCQ_DHR_WARPS;
  for (long long row = static_cast<long long>(blockIdx.x) * MCQ_DHR_WARPS + warp;
       row < num_rows; row += stride) {
    for (int j = lane; j < dh_size; j += MCQ_WARP) {
      sk[j] = MCQ_EMPTY;
      sv[j] = MCQ_EMPTY;
    }
    __syncwarp();
    const size_t base = static_cast<size_t>(row) * capacity;
    for (int c0 = 0; c0 < capacity; c0 += MCQ_WARP) {
      const int j = c0 + lane;
      const bool in_row = j < capacity;
      const int32_t c = in_row ? cnt[base + j] : 0;
      const int32_t d = in_row ? dst[base + j] : MCQ_EMPTY;
      unsigned live = __ballot_sync(MCQ_FULL_MASK, c > 0);
      while (live) {  // warp-uniform: the live slots in slot order
        const int t = mcq_first_lane(live);
        live &= live - 1u;
        const int32_t key = __shfl_sync(MCQ_FULL_MASK, d, t);
        mcq_table_insert(sk, sv, mask, key, c0 + t, max_probes, lane);
      }
    }
    const size_t hb = static_cast<size_t>(row) * dh_size;
    for (int j = lane; j < dh_size; j += MCQ_WARP) {
      dh_keys[hb + j] = sk[j];
      dh_vals[hb + j] = sv[j];
    }
    if (lane == 0 && dirty != nullptr) dirty[row] = 1;
    __syncwarp();  // the table is refilled for the warp's next row
  }
}

// After every warp of the row launch has read the counters.
__global__ void mcq_dh_rebuild_done_kernel(int32_t* counters,
                                           const uint8_t* __restrict__ fire,
                                           int threshold) {
  if (!mcq_dh_rebuild_due(counters, fire, threshold)) return;
  counters[0] += 1;
  counters[1] = 0;
}

// counters: int32[2] = {dh_rebuilds, dh_tombstones}; fire, dirty: null or
// as above.  1 <= dh_size, a power of two; the wrapper bounds it by the
// shared memory a block may use.
extern "C" int mcq_dh_rebuild(const void* cnt, const void* dst, void* dh_keys,
                              void* dh_vals, void* counters, const void* fire,
                              void* dirty, long long num_rows, int capacity,
                              int dh_size, int max_probes, int threshold,
                              void* stream) {
  if (num_rows <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      static_cast<size_t>(MCQ_DHR_WARPS) * 2 * dh_size * sizeof(int32_t);
  if (smem > MCQ_DHR_SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        mcq_dh_rebuild_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  long long blocks = (num_rows + MCQ_DHR_WARPS - 1) / MCQ_DHR_WARPS;
  if (blocks > MCQ_DHR_BLOCKS) blocks = MCQ_DHR_BLOCKS;
  auto* ctr = static_cast<int32_t*>(counters);
  const auto* f = static_cast<const uint8_t*>(fire);
  mcq_dh_rebuild_rows_kernel<<<static_cast<unsigned>(blocks),
                               MCQ_DHR_WARPS * MCQ_WARP, smem, s>>>(
      static_cast<const int32_t*>(cnt), static_cast<const int32_t*>(dst),
      static_cast<int32_t*>(dh_keys), static_cast<int32_t*>(dh_vals), ctr, f,
      static_cast<uint8_t*>(dirty), num_rows, capacity, dh_size, max_probes,
      threshold);
  const int status = mcq_launch_status();
  if (status != 0) return status;
  mcq_dh_rebuild_done_kernel<<<1, 1, 0, s>>>(ctr, f, threshold);
  return mcq_launch_status();
}
