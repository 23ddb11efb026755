// The new-edge pass of update_batch (the paper's rare case), row-parallel.
//
// Replaces src/repro/core/mcprioq.py:311 _slow_path, a lax.scan over the
// items: per active item (src s, dst d, weight w), in item order,
//   * look s up in the src table; if missing (or stored with an EMPTY value)
//     and a row is free, insert s -> n_rows (first TOMB reused when the key is
//     absent) and take the row; no free row counts dropped_rows, an exhausted
//     probe window dropped_probes, and the item ends there;
//   * in the row: the slot already holding d, else the first free slot
//     (cnt == 0), else the order tail (Space-Saving: the newcomer inherits the
//     victim's count; counts evictions);  cnt[row, slot] = base + w,
//     dst[row, slot] = d, tot[row] += w.
// counters = {n_rows, dropped_rows, dropped_probes, evictions}.  The tables
// are updated in place: the caller passes buffers it owns.  dirty (uint8 per
// row, or null) is set for every row the pass writes, which takes in every
// row it allocates: an item that gets a row is applied to it.  table_dirty
// (uint8 per group of min(32, T) src-table slots, or null) is set for the
// group of every slot the pass writes: the pass is the only writer of the
// src table, so the back-buffer learner copies those groups and no other.
//
// An item depends on earlier ones in two ways only: a missing src takes the
// next row (and a later item with that src finds it), and items on one row
// share its slots.  Items on different rows never see each other, and
// `order` is read-only here.  So the pass is four launches, with one short
// sequential part:
//   A1 lookup  one thread per item probes the pre-state table (probe.cuh)
//              and writes a key (row << 32 | item); a miss gets the row
//              MCQ_SP_MISSING, an inactive item MCQ_SP_NONE;
//   A2 chain   one block gathers the keys that have a row into a second
//              list, and finds the misses in item order; one warp walks
//              them: look up again (an earlier miss may have inserted the
//              src), else insert, else count the drop; an item that gets a
//              row joins the list.  When every row is taken at the start no
//              insert can happen, and the chain is a count of the misses.
//              The list's length (n_with) is read by B1 and B2 on the
//              device, so the sort's work follows the items that have a
//              row, and an empty pass costs short launches, no host sync;
//   B1 sort    the listed keys by (row, item): a bitonic sort of up to 8,192
//              keys per block in shared memory, then rank merges of sorted
//              runs (one launch per doubling) when there are more;
//   B2 rows    one warp per row: the warp whose key heads a run of its row
//              caches the row's dst/cnt in shared memory and applies the
//              run's items in item order; evictions are summed with integer
//              atomics, tot[row] and dirty[row] are written by that warp
//              alone.  With the per-row dst hash (dh_keys/dh_vals[N, H],
//              paper §II.2; null without it) the same warp then edits its
//              row's table per item: delete the evicted dst where the tail
//              was replaced, then insert d -> slot where d was not in the
//              row (the insert may reuse the TOMB the delete made).  Its
//              probes read what it wrote a step before: probe_window.cuh,
//              volatile loads.
// No float and no order between rows enters a result, so the state is the
// scan's, bit for bit.
//
// Bound on this card: bytes -- the items, their probe windows and the rows
// they touch -- so the launches are bound by latency: a few dependent round
// trips per launch, the sort's barriers, and a row's run of items on its
// warp.  (The functional wrapper's copies of the src table and dst_slab are
// its own; the state's owner passes its tensors and pays none.)
#include <limits.h>

#include "probe.cuh"
#include "probe_window.cuh"

#define MCQ_SP_MISSING 0x7FFFFFFE  // row field: src missing, before A2
#define MCQ_SP_NONE 0x7FFFFFFF     // row field: inactive item
#define MCQ_SP_TILE 8192           // keys one block sorts in shared memory
#define MCQ_SP_CHAIN_THREADS 1024
#define MCQ_SP_ROW_WARPS 4         // warps per block of B2
#define MCQ_SP_ROW_BLOCKS 8192     // B2 grid cap; warps stride over the keys
#define MCQ_SP_SMEM_DEFAULT (48 * 1024)  // dynamic smem without opting in;
                                         // B2 caches 2 * capacity int32 per
                                         // warp in it: capacity <= 1,536

__device__ __forceinline__ long long mcq_sp_key(int32_t row, int item) {
  return (static_cast<long long>(row) << 32) | static_cast<unsigned>(item);
}

__device__ __forceinline__ int32_t mcq_sp_row(long long key) {
  return static_cast<int32_t>(key >> 32);
}

// ---- A1: parallel lookups in the pre-state table ---------------------------

__global__ void mcq_sp_lookup_kernel(const int32_t* __restrict__ src,
                                     const int32_t* __restrict__ active,
                                     int n_items,
                                     const int32_t* __restrict__ tab_keys,
                                     const int32_t* __restrict__ tab_vals,
                                     int table_size, int max_probes,
                                     long long* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  int32_t row = MCQ_SP_NONE;
  if (active[i] != 0) {
    int32_t val = MCQ_EMPTY;
    // a stored EMPTY value reads as a miss
    const bool hit = mcq_probe_chain(tab_keys, tab_vals, table_size, src[i],
                                     max_probes, &val);
    row = hit && val != MCQ_EMPTY ? val : MCQ_SP_MISSING;
  }
  keys[i] = mcq_sp_key(row, i);
}

// ---- A2: the misses, in item order, on one warp ------------------------------

// One block.  Every thread looks at one key per round (a round is 1,024
// consecutive items).  Keys that have a row are appended to `with_row`
// (order free: B1 sorts them); the misses of a round are listed in item
// order in shared memory and walked by warp 0, so one round's chain ends
// before the next round's begins.
__global__ void mcq_sp_chain_kernel(const int32_t* __restrict__ src,
                                    int n_items,
                                    const long long* __restrict__ keys,
                                    long long* __restrict__ with_row,
                                    volatile int32_t* tab_keys,
                                    volatile int32_t* tab_vals,
                                    uint8_t* __restrict__ table_dirty,
                                    int table_size, int32_t* counters,
                                    int num_rows, int max_probes,
                                    int32_t* n_with_out) {
  __shared__ int list[MCQ_SP_CHAIN_THREADS];
  __shared__ int warp_misses[MCQ_SP_CHAIN_THREADS / MCQ_WARP];
  __shared__ int n_out;
  const int tid = threadIdx.x;
  const int lane = tid & (MCQ_WARP - 1);
  const int warp = tid / MCQ_WARP;
  const uint32_t mask = static_cast<uint32_t>(table_size - 1);
  int32_t n_rows = counters[0];
  int32_t dropped_rows = counters[1];
  int32_t dropped_probes = counters[2];
  // with every row taken no insert can happen: the chain is a count
  const bool full = n_rows >= num_rows;
  if (tid == 0) n_out = 0;
  __syncthreads();

  for (int base = 0; base < n_items; base += MCQ_SP_CHAIN_THREADS) {
    const int i = base + tid;
    const long long key = i < n_items ? keys[i] : mcq_sp_key(MCQ_SP_NONE, 0);
    const int32_t row = mcq_sp_row(key);
    const bool miss = row == MCQ_SP_MISSING;
    const unsigned has = __ballot_sync(MCQ_FULL_MASK, row < MCQ_SP_MISSING);
    if (has) {
      int at = 0;
      if (lane == 0) at = atomicAdd(&n_out, __popc(has));
      at = __shfl_sync(MCQ_FULL_MASK, at, 0);
      if (row < MCQ_SP_MISSING)
        with_row[at + __popc(has & ((1u << lane) - 1u))] = key;
    }
    const int total = __syncthreads_count(miss);
    if (total == 0) continue;
    if (full) {  // every miss is a dropped row
      if (tid == 0) dropped_rows += total;
      continue;
    }
    const unsigned ballot = __ballot_sync(MCQ_FULL_MASK, miss);
    if (lane == 0) warp_misses[warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    for (int w2 = 0; w2 < warp; ++w2) before += warp_misses[w2];
    if (miss) list[before + __popc(ballot & ((1u << lane) - 1u))] = i;
    __syncthreads();
    if (warp == 0) {
      for (int j0 = 0; j0 < total; j0 += MCQ_WARP) {
        const int my_item = j0 + lane < total ? list[j0 + lane] : 0;
        const int32_t my_s = src[my_item];
        const int here = min(MCQ_WARP, total - j0);
        for (int t = 0; t < here; ++t) {
          const int item = __shfl_sync(MCQ_FULL_MASK, my_item, t);
          const int32_t s = __shfl_sync(MCQ_FULL_MASK, my_s, t);
          const McqProbe pr =
              mcq_probe_window(tab_keys, tab_vals, mask, s, max_probes, lane);
          int32_t got =
              mcq_landed_on(pr, s, max_probes) ? pr.stop_val : MCQ_EMPTY;
          if (got == MCQ_EMPTY) {
            if (n_rows >= num_rows) {
              ++dropped_rows;
              continue;
            }
            const int ins_p = mcq_insert_pos(pr, s, max_probes);
            if (ins_p >= max_probes) {
              ++dropped_probes;
              continue;
            }
            got = n_rows++;
            if (lane == 0) {
              const uint32_t idx =
                  (pr.h0 + static_cast<uint32_t>(ins_p)) & mask;
              tab_keys[idx] = s;
              tab_vals[idx] = got;
              if (table_dirty != nullptr)
                table_dirty[idx / min(MCQ_WARP, table_size)] = 1;
            }
          }
          if (lane == 0) with_row[atomicAdd(&n_out, 1)] = mcq_sp_key(got, item);
          __syncwarp();
        }
      }
    }
    __syncthreads();  // `list` is rewritten by the next round
  }
  __syncthreads();
  if (tid == 0) {  // thread 0 walked the chain: its counts are the block's
    *n_with_out = n_out;
    counters[0] = n_rows;
    counters[1] = dropped_rows;
    counters[2] = dropped_probes;
  }
}

// ---- B1: sort the keys that have a row, by (row, item) ---------------------

// Each block sorts one tile of at most `tile` keys in shared memory (padded
// with LLONG_MAX, above every key, to a power of two).
__global__ void mcq_sp_sort_tiles_kernel(long long* keys, int tile,
                                         const int32_t* __restrict__ n_with) {
  extern __shared__ long long sk[];
  const int base = blockIdx.x * tile;
  const int n = min(tile, *n_with - base);
  if (n <= 1) return;
  int size = 2;
  while (size < n) size <<= 1;
  for (int j = threadIdx.x; j < size; j += blockDim.x)
    sk[j] = j < n ? keys[base + j] : LLONG_MAX;
  __syncthreads();
  for (int k = 2; k <= size; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < size / 2; t += blockDim.x) {
        const int lo = 2 * t - (t & (j - 1));
        const int hi = lo + j;
        const long long a = sk[lo];
        const long long b = sk[hi];
        if ((a > b) == ((lo & k) == 0)) {
          sk[lo] = b;
          sk[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) keys[base + j] = sk[j];
}

// Sorted runs of `run` keys merged pairwise: every key finds its place by
// counting the keys below it in the other run (keys are distinct: they hold
// the item's index).
__global__ void mcq_sp_merge_kernel(const long long* __restrict__ in,
                                    long long* __restrict__ out, int run,
                                    const int32_t* __restrict__ n_with) {
  const int n = *n_with;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const long long key = in[p];
  const long long pair = 2LL * run;
  const int base = static_cast<int>((p / pair) * pair);
  const int mid = static_cast<int>(
      min(static_cast<long long>(base) + run, static_cast<long long>(n)));
  const int end = static_cast<int>(
      min(static_cast<long long>(base) + pair, static_cast<long long>(n)));
  const bool in_a = p < mid;
  int lo = in_a ? mid : base;  // search the other run for keys below `key`
  int hi = in_a ? end : mid;
  const int first = lo;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (in[m] < key) lo = m + 1;
    else hi = m;
  }
  const int own = in_a ? p - base : p - mid;
  out[base + own + (lo - first)] = key;
}

// ---- B2: one warp per row --------------------------------------------------

// The row is cached in shared memory (the wrapper refuses rows too wide for
// MCQ_SP_SMEM_DEFAULT): its scans read the cache, its writes go to both.
__global__ void mcq_sp_rows_kernel(const long long* __restrict__ keys,
                                   const int32_t* __restrict__ n_with_in,
                                   const int32_t* __restrict__ dst,
                                   const int32_t* __restrict__ w,
                                   int32_t* __restrict__ dst_slab,
                                   int32_t* __restrict__ cnt, int32_t* tot,
                                   const int32_t* __restrict__ order,
                                   int32_t* counters,
                                   uint8_t* __restrict__ dirty, int num_rows,
                                   int capacity, int32_t* dh_keys,
                                   int32_t* dh_vals, int dh_size,
                                   int max_probes) {
  extern __shared__ int32_t row_cache[];
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  const int warp_in_block = threadIdx.x / MCQ_WARP;
  const int n_with = *n_with_in;
  volatile int32_t* sd = row_cache + warp_in_block * 2 * capacity;
  volatile int32_t* sc = sd + capacity;
  const int n_warps = gridDim.x * MCQ_SP_ROW_WARPS;
  for (int p = blockIdx.x * MCQ_SP_ROW_WARPS + warp_in_block; p < n_with;
       p += n_warps) {
    const int32_t row = mcq_sp_row(keys[p]);
    // a warp works only where a row's run of keys begins
    if (p > 0 && mcq_sp_row(keys[p - 1]) == row) continue;
    if (row < 0 || row >= num_rows) continue;
    const size_t base = static_cast<size_t>(row) * capacity;
    volatile int32_t* hk = nullptr;
    volatile int32_t* hv = nullptr;
    if (dh_keys != nullptr) {
      hk = dh_keys + static_cast<size_t>(row) * dh_size;
      hv = dh_vals + static_cast<size_t>(row) * dh_size;
    }
    const uint32_t dh_mask = static_cast<uint32_t>(dh_size - 1);
    // no other warp writes this row, and this launch has not written it yet
    for (int j = lane; j < capacity; j += MCQ_WARP) {
      sd[j] = dst_slab[base + j];
      sc[j] = cnt[base + j];
    }
    const int32_t tail = order[base + capacity - 1];
    int32_t row_tot = tot[row];
    int evictions = 0;
    __syncwarp();
    for (int q = p;; q += MCQ_WARP) {
      const int idx = q + lane;
      const long long kq = idx < n_with ? keys[idx] : LLONG_MAX;
      const bool in_run = idx < n_with && mcq_sp_row(kq) == row;
      const int here = __popc(__ballot_sync(MCQ_FULL_MASK, in_run));
      const int item = static_cast<int>(kq & 0xFFFFFFFFLL);
      const int32_t my_d = in_run ? dst[item] : 0;
      const int32_t my_w = in_run ? w[item] : 0;
      for (int t = 0; t < here; ++t) {
        const int32_t d = __shfl_sync(MCQ_FULL_MASK, my_d, t);
        const int32_t wi = __shfl_sync(MCQ_FULL_MASK, my_w, t);
        int slot_eq = -1;
        int slot_free = -1;
        for (int c0 = 0; c0 < capacity; c0 += MCQ_WARP) {
          const int j = c0 + lane;
          const bool in_row = j < capacity;
          const int32_t dj = in_row ? sd[j] : MCQ_EMPTY;
          const int32_t cj = in_row ? sc[j] : 1;
          const unsigned eqs = __ballot_sync(MCQ_FULL_MASK, in_row && dj == d);
          const unsigned frs = __ballot_sync(MCQ_FULL_MASK, in_row && cj == 0);
          if (slot_free < 0 && frs) slot_free = c0 + mcq_first_lane(frs);
          if (eqs) {
            slot_eq = c0 + mcq_first_lane(eqs);
            break;
          }
        }
        const bool evict = slot_eq < 0 && slot_free < 0;
        const int slot = slot_eq >= 0 ? slot_eq : slot_free >= 0 ? slot_free : tail;
        int32_t evicted = MCQ_EMPTY;
        if (lane == 0) {
          evicted = sd[slot];
          const int32_t value = (slot_eq < 0 && slot_free >= 0 ? 0 : sc[slot]) + wi;
          sc[slot] = value;
          sd[slot] = d;
          cnt[base + slot] = value;
          dst_slab[base + slot] = d;
        }
        evicted = __shfl_sync(MCQ_FULL_MASK, evicted, 0);
        row_tot += wi;
        evictions += evict;
        __syncwarp();
        if (hk != nullptr && slot_eq < 0) {
          if (evict)
            mcq_table_delete(hk, hv, dh_mask, evicted, max_probes, lane);
          mcq_table_insert(hk, hv, dh_mask, d, slot, max_probes, lane);
        }
      }
      if (here < MCQ_WARP) break;
    }
    if (lane == 0) {
      tot[row] = row_tot;
      if (dirty != nullptr) dirty[row] = 1;
      if (evictions) atomicAdd(&counters[3], evictions);
    }
    __syncwarp();  // the cache is refilled for the warp's next row
  }
}

static int mcq_next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// keys, with_row: int64 scratch of n_items each; n_with: int32 scratch of
// one; dirty: null, or uint8 per row; table_dirty: null, or uint8 per group
// of min(32, table_size) slots; dh_keys/dh_vals: null, or the row hashes
// [num_rows, dh_size] (dh_size a power of two).
extern "C" int mcq_slow_path(const void* src, const void* dst, const void* w,
                             const void* active, int n_items, void* tab_keys,
                             void* tab_vals, int table_size, void* dst_slab,
                             void* cnt, void* tot, const void* order,
                             void* counters, void* dirty, int num_rows,
                             int capacity,
                             int max_probes, void* keys, void* with_row,
                             void* n_with, void* dh_keys, void* dh_vals,
                             int dh_size, void* table_dirty, void* stream) {
  if (n_items <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* k_items = static_cast<long long*>(keys);
  long long* k0 = static_cast<long long*>(with_row);
  int32_t* nw = static_cast<int32_t*>(n_with);

  mcq_sp_lookup_kernel<<<(n_items + 255) / 256, 256, 0, st>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(active),
      n_items, static_cast<const int32_t*>(tab_keys),
      static_cast<const int32_t*>(tab_vals), table_size, max_probes, k_items);
  mcq_sp_chain_kernel<<<1, MCQ_SP_CHAIN_THREADS, 0, st>>>(
      static_cast<const int32_t*>(src), n_items, k_items, k0,
      static_cast<volatile int32_t*>(tab_keys),
      static_cast<volatile int32_t*>(tab_vals),
      static_cast<uint8_t*>(table_dirty), table_size,
      static_cast<int32_t*>(counters), num_rows, max_probes, nw);

  // how many keys have a row is known on the device only: the grids are
  // sized for all n_items, and blocks past the count leave at once
  const int tile = min(mcq_next_pow2(n_items), MCQ_SP_TILE);
  const size_t tile_bytes = static_cast<size_t>(tile) * sizeof(long long);
  if (tile_bytes > MCQ_SP_SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        mcq_sp_sort_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tile_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mcq_sp_sort_tiles_kernel<<<(n_items + tile - 1) / tile,
                             min(MCQ_SP_CHAIN_THREADS, max(MCQ_WARP, tile / 2)),
                             tile_bytes, st>>>(k0, tile, nw);
  long long* k1 = k_items;  // the lookups' keys are no longer needed
  for (long long run = tile; run < n_items; run *= 2) {
    mcq_sp_merge_kernel<<<(n_items + 255) / 256, 256, 0, st>>>(
        k0, k1, static_cast<int>(run), nw);
    long long* swap = k0;
    k0 = k1;
    k1 = swap;
  }

  const size_t cache_bytes =
      static_cast<size_t>(MCQ_SP_ROW_WARPS) * 2 * capacity * sizeof(int32_t);
  const int row_blocks = min(MCQ_SP_ROW_BLOCKS,
                             (n_items + MCQ_SP_ROW_WARPS - 1) / MCQ_SP_ROW_WARPS);
  mcq_sp_rows_kernel<<<row_blocks, MCQ_SP_ROW_WARPS * MCQ_WARP, cache_bytes,
                       st>>>(
      k0, nw, static_cast<const int32_t*>(dst),
      static_cast<const int32_t*>(w), static_cast<int32_t*>(dst_slab),
      static_cast<int32_t*>(cnt), static_cast<int32_t*>(tot),
      static_cast<const int32_t*>(order), static_cast<int32_t*>(counters),
      static_cast<uint8_t*>(dirty), num_rows, capacity,
      static_cast<int32_t*>(dh_keys), static_cast<int32_t*>(dh_vals), dh_size,
      max_probes);
  return mcq_launch_status();
}
