// Catch a back buffer up with its front: the copy of read-copy-update, made
// a copy of the rows that changed instead of a copy of the table.
//
// The learner keeps two states, the published front and a private back that
// differs from it only in the rows flagged in dirty (uint8 per row: the rows
// the last write changed).  For each flagged row the row's cnt, dst and order
// and its tot are copied from front to back, and its row hash
// (dh_keys/dh_vals[N, H], when given: the per-row dst hash of paper §II.2,
// written under the same flags), and the flag is cleared; the src table (keys
// and vals) and the state's scalars are copied whole.
//
// Rows: one warp per 32 rows.  Lane L reads the flag of row base + L (one
// coalesced 32-byte load); the warp walks the set bits of the ballot and
// copies each flagged row with all 32 lanes (coalesced), loads before
// stores.  So the launch reads the N bytes of flags once and moves only the
// flagged rows.  Table: the blocks after the row blocks copy keys and vals,
// and then the scalars (ten per shard of a stacked state, any number), each
// with a grid-stride loop.  Front and back are distinct tensors.
#include "common.cuh"

#define MCQ_COPY_WARPS 8        // warps per block; a warp covers 32 rows
#define MCQ_COPY_TABLE_BLOCKS 512

__global__ void __launch_bounds__(MCQ_COPY_WARPS * MCQ_WARP)
    mcq_copy_dirty_rows_kernel(
        const int32_t* __restrict__ f_cnt, const int32_t* __restrict__ f_dst,
        const int32_t* __restrict__ f_order, const int32_t* __restrict__ f_tot,
        const int32_t* __restrict__ f_keys, const int32_t* __restrict__ f_vals,
        const int32_t* __restrict__ f_scalars, int32_t* __restrict__ b_cnt,
        int32_t* __restrict__ b_dst, int32_t* __restrict__ b_order,
        int32_t* __restrict__ b_tot, int32_t* __restrict__ b_keys,
        int32_t* __restrict__ b_vals, int32_t* __restrict__ b_scalars,
        const int32_t* __restrict__ f_dhk, const int32_t* __restrict__ f_dhv,
        int32_t* __restrict__ b_dhk, int32_t* __restrict__ b_dhv,
        uint8_t* __restrict__ dirty, long long num_rows, int capacity,
        long long table_size, int n_scalars, int dh_size,
        long long row_blocks) {
  if (blockIdx.x >= row_blocks) {
    const long long t = (blockIdx.x - row_blocks) * blockDim.x + threadIdx.x;
    const long long stride =
        static_cast<long long>(gridDim.x - row_blocks) * blockDim.x;
    for (long long i = t; i < table_size; i += stride) {
      const int32_t k = f_keys[i], v = f_vals[i];
      b_keys[i] = k;
      b_vals[i] = v;
    }
    for (long long i = t; i < n_scalars; i += stride)
      b_scalars[i] = f_scalars[i];
    return;
  }
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  const long long base =
      (static_cast<long long>(blockIdx.x) * MCQ_COPY_WARPS +
       threadIdx.x / MCQ_WARP) * MCQ_WARP;
  const long long mine = base + lane;
  const bool flagged = mine < num_rows && dirty[mine] != 0;
  unsigned rows = __ballot_sync(MCQ_FULL_MASK, flagged);
  while (rows) {
    const long long row = base + mcq_first_lane(rows);
    rows &= rows - 1;
    const size_t off = static_cast<size_t>(row) * capacity;
    for (int j = lane; j < capacity; j += MCQ_WARP) {
      const int32_t c = f_cnt[off + j], d = f_dst[off + j],
                    o = f_order[off + j];
      b_cnt[off + j] = c;
      b_dst[off + j] = d;
      b_order[off + j] = o;
    }
    if (lane == 0) b_tot[row] = f_tot[row];
    if (f_dhk != nullptr) {
      const size_t hb = static_cast<size_t>(row) * dh_size;
      for (int j = lane; j < dh_size; j += MCQ_WARP) {
        const int32_t k = f_dhk[hb + j], v = f_dhv[hb + j];
        b_dhk[hb + j] = k;
        b_dhv[hb + j] = v;
      }
    }
  }
  if (flagged) dirty[mine] = 0;
}

extern "C" int mcq_copy_dirty_rows(
    const void* f_cnt, const void* f_dst, const void* f_order,
    const void* f_tot, const void* f_keys, const void* f_vals,
    const void* f_scalars, void* b_cnt, void* b_dst, void* b_order,
    void* b_tot, void* b_keys, void* b_vals, void* b_scalars,
    const void* f_dh_keys, const void* f_dh_vals, void* b_dh_keys,
    void* b_dh_vals, void* dirty, long long num_rows, int capacity,
    long long table_size, int n_scalars, int dh_size, void* stream) {
  if (num_rows < 0 || capacity <= 0 || table_size < 0 || n_scalars < 0 ||
      (f_dh_keys != nullptr && dh_size <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows_per_block = MCQ_COPY_WARPS * MCQ_WARP;
  const long long row_blocks = (num_rows + rows_per_block - 1) / rows_per_block;
  const long long threads = MCQ_COPY_WARPS * MCQ_WARP;
  const long long table_items = table_size > n_scalars ? table_size : n_scalars;
  long long table_blocks = (table_items + threads - 1) / threads;
  if (table_blocks > MCQ_COPY_TABLE_BLOCKS) table_blocks = MCQ_COPY_TABLE_BLOCKS;
  if (table_blocks < 1) table_blocks = 1;  // the scalars
  mcq_copy_dirty_rows_kernel<<<static_cast<unsigned>(row_blocks + table_blocks),
                               static_cast<unsigned>(threads), 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(f_cnt), static_cast<const int32_t*>(f_dst),
      static_cast<const int32_t*>(f_order), static_cast<const int32_t*>(f_tot),
      static_cast<const int32_t*>(f_keys), static_cast<const int32_t*>(f_vals),
      static_cast<const int32_t*>(f_scalars), static_cast<int32_t*>(b_cnt),
      static_cast<int32_t*>(b_dst), static_cast<int32_t*>(b_order),
      static_cast<int32_t*>(b_tot), static_cast<int32_t*>(b_keys),
      static_cast<int32_t*>(b_vals), static_cast<int32_t*>(b_scalars),
      static_cast<const int32_t*>(f_dh_keys),
      static_cast<const int32_t*>(f_dh_vals), static_cast<int32_t*>(b_dh_keys),
      static_cast<int32_t*>(b_dh_vals), static_cast<uint8_t*>(dirty), num_rows,
      capacity, table_size, n_scalars, dh_size, row_blocks);
  return mcq_launch_status();
}
