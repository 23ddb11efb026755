// The two kernels that csrc/oddeven.cu and csrc/copy_rows.cu replaced, kept
// under other entry names as the yardstick chip_smoke.py times each redesign
// against, in the same run and on the same inputs (not built into the
// package's library, and on no path):
//   mcq_base_oddeven          one warp a row, four rows a block; the counts
//                             gathered into priority order from device
//                             memory (c[j] = cnt[row, order[row, j]]);
//   mcq_base_copy_dirty_rows  one warp walks the flags of its 32 rows one
//                             flagged row at a time, and the src table is
//                             copied whole.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I src/repro_torch/kernels/csrc -o LIB this file
#include "common.cuh"

#define MCQ_BASE_OE_WARPS 4

__global__ void mcq_base_oddeven_kernel(const int32_t* __restrict__ cnt,
                                   const int32_t* order, int32_t* order_out,
                                   uint8_t* __restrict__ dirty,
                                   long long num_rows, int capacity,
                                   int passes) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  const int warp = threadIdx.x / MCQ_WARP;
  const long long row =
      static_cast<long long>(blockIdx.x) * MCQ_BASE_OE_WARPS + warp;
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

extern "C" int mcq_base_oddeven(const void* cnt, const void* order,
                           void* order_out, void* dirty, long long num_rows,
                           int capacity, int passes, void* stream) {
  if (num_rows <= 0 || capacity <= 0) return 0;
  const size_t smem =
      static_cast<size_t>(MCQ_BASE_OE_WARPS) * 2 * capacity * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mcq_base_oddeven_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks =
      (num_rows + MCQ_BASE_OE_WARPS - 1) / MCQ_BASE_OE_WARPS;
  mcq_base_oddeven_kernel<<<static_cast<unsigned>(blocks),
                       MCQ_BASE_OE_WARPS * MCQ_WARP, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cnt), static_cast<const int32_t*>(order),
      static_cast<int32_t*>(order_out), static_cast<uint8_t*>(dirty), num_rows,
      capacity, passes);
  return mcq_launch_status();
}

#define MCQ_BASE_COPY_WARPS 8        // warps per block; a warp covers 32 rows
#define MCQ_BASE_COPY_TABLE_BLOCKS 512

__global__ void __launch_bounds__(MCQ_BASE_COPY_WARPS * MCQ_WARP)
    mcq_base_copy_dirty_rows_kernel(
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
      (static_cast<long long>(blockIdx.x) * MCQ_BASE_COPY_WARPS +
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

extern "C" int mcq_base_copy_dirty_rows(
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
  const long long rows_per_block = MCQ_BASE_COPY_WARPS * MCQ_WARP;
  const long long row_blocks = (num_rows + rows_per_block - 1) / rows_per_block;
  const long long threads = MCQ_BASE_COPY_WARPS * MCQ_WARP;
  const long long table_items = table_size > n_scalars ? table_size : n_scalars;
  long long table_blocks = (table_items + threads - 1) / threads;
  if (table_blocks > MCQ_BASE_COPY_TABLE_BLOCKS) table_blocks = MCQ_BASE_COPY_TABLE_BLOCKS;
  if (table_blocks < 1) table_blocks = 1;  // the scalars
  mcq_base_copy_dirty_rows_kernel<<<static_cast<unsigned>(row_blocks + table_blocks),
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
