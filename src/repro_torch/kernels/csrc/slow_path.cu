// Sequential insert pass for new edges / new rows (the paper's rare case).
//
// Strictly in item order, so ONE warp of ONE block walks the items: the
// lanes share each item's probe-window and row scans (lowest index wins, by
// ballot + ffs) and lane 0 does the writes; __syncwarp() after an item's
// writes makes them visible to the next item's reads.  How far the active
// items reach is read from the mask in device memory (by all warps of the
// block, before the others leave), and the walking warp takes the items 32 at
// a time up to there, so a pass with no active item costs one short launch
// and no device->host synchronisation.
//
// Per active item (src s, dst d, weight w):
//   * look s up in the src table; if missing and a row is free, insert
//     s -> n_rows (first TOMB reused when the key is absent) and take the row;
//     no free row counts dropped_rows, an exhausted probe window
//     dropped_probes, and the item ends there;
//   * in the row: the slot already holding d, else the first free slot
//     (cnt == 0), else the order tail (Space-Saving: the newcomer inherits the
//     victim's count; counts evictions);  cnt[row, slot] = base + w,
//     dst[row, slot] = d, tot[row] += w.
// All tables are updated in place: the caller passes fresh copies.
// counters = {n_rows, dropped_rows, dropped_probes, evictions}.
//
// The pass is one dependent chain, so its cost is round trips to memory, not
// bytes.  Two things keep them few and short.  (1) Before the warp walks a
// group of 32 items, every lane looks its OWN item up (read-only, a few
// probes, which also pull its table slots into L2) and prefetches into L2 the
// lines that item will touch: its row of dst/cnt, its tot and its order tail
// (for an item that looks new, those of the row it will be given).  The guess
// may be stale (an earlier item of the group may insert first); a prefetch
// changes no result, a wrong one only misses.  (2) Per item, loads that do not
// depend on each other are started together: table values with table keys, and
// tot and the order tail with the row scan.
#include "common.cuh"

// Probe window of `key` from its home slot, shared by the warp.
// stop_p: first position holding the key or EMPTY (max_probes if none);
// tomb_p: first TOMB before stop_p (max_probes if none).
struct McqProbe {
  int stop_p;
  int tomb_p;
  int32_t stop_key;
  int32_t stop_val;  // tab_vals at stop_p (loaded beside the key)
  uint32_t h0;
};

__device__ __forceinline__ McqProbe mcq_probe_window(
    const volatile int32_t* tab_keys, const volatile int32_t* tab_vals,
    uint32_t mask, int32_t key, int max_probes, int lane) {
  McqProbe pr;
  pr.stop_p = max_probes;
  pr.tomb_p = max_probes;
  pr.stop_key = MCQ_EMPTY;
  pr.stop_val = MCQ_EMPTY;
  pr.h0 = mcq_hash_u32(key) & mask;
  for (int p0 = 0; p0 < max_probes; p0 += MCQ_WARP) {
    const int p = p0 + lane;
    int32_t k = MCQ_TOMB - 1;  // matches nothing
    int32_t v = MCQ_EMPTY;
    const bool in_win = p < max_probes;
    if (in_win) {
      const uint32_t idx = (pr.h0 + static_cast<uint32_t>(p)) & mask;
      k = tab_keys[idx];
      v = tab_vals[idx];
    }
    const unsigned stops =
        __ballot_sync(MCQ_FULL_MASK, in_win && (k == key || k == MCQ_EMPTY));
    unsigned tombs = __ballot_sync(MCQ_FULL_MASK, in_win && k == MCQ_TOMB);
    if (stops) {
      const int first = mcq_first_lane(stops);
      tombs &= (1u << first) - 1u;  // only TOMBs before the stop
      if (pr.tomb_p == max_probes && tombs)
        pr.tomb_p = p0 + mcq_first_lane(tombs);
      pr.stop_p = p0 + first;
      pr.stop_key = __shfl_sync(MCQ_FULL_MASK, k, first);
      pr.stop_val = __shfl_sync(MCQ_FULL_MASK, v, first);
      break;
    }
    if (pr.tomb_p == max_probes && tombs)
      pr.tomb_p = p0 + mcq_first_lane(tombs);
  }
  return pr;
}

__device__ __forceinline__ void mcq_prefetch_l2(const volatile void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Lines of row `row` that an item's slot search will read.
__device__ __forceinline__ void mcq_prefetch_row(
    const volatile int32_t* dst_slab, const volatile int32_t* cnt,
    const volatile int32_t* tot, const int32_t* order, int32_t row,
    int capacity) {
  const size_t base = static_cast<size_t>(row) * capacity;
  for (int j = 0; j < capacity; j += 32) {  // 32 ints = one 128-byte line
    mcq_prefetch_l2(dst_slab + base + j);
    mcq_prefetch_l2(cnt + base + j);
  }
  mcq_prefetch_l2(tot + row);
  mcq_prefetch_l2(order + base + capacity - 1);
}

#define MCQ_WARM_PROBES 4
#define MCQ_SCAN_THREADS 256  // block size; only warp 0 walks the items

__global__ void mcq_slow_path_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const int32_t* __restrict__ w, const int32_t* __restrict__ active,
    int n_items,
    volatile int32_t* tab_keys, volatile int32_t* tab_vals,
    int table_size, volatile int32_t* dst_slab, volatile int32_t* cnt,
    volatile int32_t* tot, const int32_t* __restrict__ order,
    int32_t* counters, int num_rows, int capacity, int max_probes) {
  // All warps of the block find where the last active item sits; then warp 0
  // alone walks that far (the caller partitions active items to the front),
  // so a pass with no active item ends here.
  __shared__ int n_walk_shared;
  if (threadIdx.x == 0) n_walk_shared = 0;
  __syncthreads();
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  int last = 0;
  for (int i = threadIdx.x; i < n_items; i += blockDim.x)
    if (active[i] != 0) last = i + 1;
  for (int off = MCQ_WARP / 2; off > 0; off >>= 1)
    last = max(last, __shfl_xor_sync(MCQ_FULL_MASK, last, off));
  if (lane == 0 && last > 0) atomicMax(&n_walk_shared, last);
  __syncthreads();
  if (threadIdx.x >= MCQ_WARP) return;
  const int n_walk = n_walk_shared;
  const uint32_t mask = static_cast<uint32_t>(table_size - 1);
  int32_t n_rows = counters[0];
  int32_t dropped_rows = counters[1];
  int32_t dropped_probes = counters[2];
  int32_t evictions = counters[3];

  for (int i0 = 0; i0 < n_walk; i0 += MCQ_WARP) {
    const int i = i0 + lane;
    const bool in_items = i < n_walk;
    const int32_t my_s = in_items ? src[i] : 0;
    const int32_t my_d = in_items ? dst[i] : 0;
    const int32_t my_w = in_items ? w[i] : 0;
    const bool my_act = in_items && active[i] != 0;
    unsigned todo = __ballot_sync(MCQ_FULL_MASK, my_act);

    // warm the cache for this group: each lane guesses its own item's row
    bool guess_new = false;
    if (my_act) {
      const uint32_t h0 = mcq_hash_u32(my_s) & mask;
      int32_t guess = -1;
      for (int p = 0; p < MCQ_WARM_PROBES && p < max_probes; ++p) {
        const uint32_t idx = (h0 + static_cast<uint32_t>(p)) & mask;
        const int32_t k = tab_keys[idx];
        if (k == MCQ_EMPTY) {
          guess_new = true;
          break;
        }
        if (k == my_s) {
          guess = tab_vals[idx];
          break;
        }
      }
      if (guess >= 0 && guess < num_rows)
        mcq_prefetch_row(dst_slab, cnt, tot, order, guess, capacity);
    }
    // items that look new will take the next free rows, in item order
    const unsigned news = __ballot_sync(MCQ_FULL_MASK, guess_new);
    if (guess_new) {
      const long long guess =
          static_cast<long long>(n_rows) + __popc(news & ((1u << lane) - 1u));
      if (guess < num_rows)
        mcq_prefetch_row(dst_slab, cnt, tot, order,
                         static_cast<int32_t>(guess), capacity);
    }

    while (todo) {
      const int cur = mcq_first_lane(todo);
      todo &= todo - 1u;
      const int32_t s = __shfl_sync(MCQ_FULL_MASK, my_s, cur);
      const int32_t d = __shfl_sync(MCQ_FULL_MASK, my_d, cur);
      const int32_t wi = __shfl_sync(MCQ_FULL_MASK, my_w, cur);

      // --- src row (lookup or allocate) --------------------------------
      const McqProbe pr =
          mcq_probe_window(tab_keys, tab_vals, mask, s, max_probes, lane);
      int32_t row = -1;
      // the key sits before any EMPTY; a stored EMPTY value reads as a miss
      if (pr.stop_p < max_probes && pr.stop_key == s) row = pr.stop_val;
      if (row == MCQ_EMPTY) {
        if (n_rows >= num_rows) {
          ++dropped_rows;
          continue;
        }
        // insert: the key's own slot or the first EMPTY, unless a TOMB came
        // first and the walk did not land on the key
        int ins_p = pr.stop_p;
        const bool landed_on_key =
            pr.stop_p < max_probes && pr.stop_key == s;
        if (pr.tomb_p < max_probes && !landed_on_key) ins_p = pr.tomb_p;
        if (ins_p >= max_probes) {
          ++dropped_probes;
          continue;
        }
        row = n_rows;
        if (lane == 0) {
          const uint32_t idx = (pr.h0 + static_cast<uint32_t>(ins_p)) & mask;
          tab_keys[idx] = s;
          tab_vals[idx] = row;
        }
        ++n_rows;
      }

      // --- dst slot (find / free / Space-Saving tail replace) ----------
      const size_t base = static_cast<size_t>(row) * capacity;
      // independent of the scan, so started beside it (lane 0 uses them)
      const int32_t tot_old = tot[row];
      const int32_t tail = order[base + capacity - 1];
      int slot_eq = -1;
      int slot_free = -1;
      int32_t cnt_eq = 0;  // count in slot_eq, from the scanning lane
      for (int c0 = 0; c0 < capacity; c0 += MCQ_WARP) {
        const int j = c0 + lane;
        const bool in_row = j < capacity;
        const int32_t dj = in_row ? dst_slab[base + j] : MCQ_EMPTY;
        const int32_t cj = in_row ? cnt[base + j] : 1;
        const unsigned eqs = __ballot_sync(MCQ_FULL_MASK, in_row && dj == d);
        const unsigned frs = __ballot_sync(MCQ_FULL_MASK, in_row && cj == 0);
        if (slot_free < 0 && frs) slot_free = c0 + mcq_first_lane(frs);
        if (eqs) {
          const int first = mcq_first_lane(eqs);
          slot_eq = c0 + first;
          cnt_eq = __shfl_sync(MCQ_FULL_MASK, cj, first);
          break;
        }
      }
      if (lane == 0) {
        int slot;
        int32_t base_cnt;
        if (slot_eq >= 0) {
          slot = slot_eq;
          base_cnt = cnt_eq;
        } else if (slot_free >= 0) {
          slot = slot_free;
          base_cnt = 0;
        } else {
          slot = tail;
          base_cnt = cnt[base + slot];
        }
        cnt[base + slot] = base_cnt + wi;
        dst_slab[base + slot] = d;
        tot[row] = tot_old + wi;
      }
      if (slot_eq < 0 && slot_free < 0) ++evictions;
      __syncwarp();
    }
  }
  if (lane == 0) {
    counters[0] = n_rows;
    counters[1] = dropped_rows;
    counters[2] = dropped_probes;
    counters[3] = evictions;
  }
}

extern "C" int mcq_slow_path(const void* src, const void* dst, const void* w,
                             const void* active, int n_items, void* tab_keys,
                             void* tab_vals, int table_size, void* dst_slab,
                             void* cnt, void* tot, const void* order,
                             void* counters, int num_rows, int capacity,
                             int max_probes, void* stream) {
  mcq_slow_path_kernel<<<1, MCQ_SCAN_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<const int32_t*>(w), static_cast<const int32_t*>(active),
      n_items, static_cast<volatile int32_t*>(tab_keys),
      static_cast<volatile int32_t*>(tab_vals), table_size,
      static_cast<volatile int32_t*>(dst_slab),
      static_cast<volatile int32_t*>(cnt), static_cast<volatile int32_t*>(tot),
      static_cast<const int32_t*>(order), static_cast<int32_t*>(counters), num_rows,
      capacity, max_probes);
  return mcq_launch_status();
}
