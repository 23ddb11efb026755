// The sharded chain's global top-n in one pass over the stacked slabs: every
// row's min(n, C)-item priority window, each block's best n window entries
// and the live counts.
//
// Replaces the plain torch of core/sharded.py's topn_lists on the card —
// the windows' gather, a stable descending torch.sort of all S * N * k
// window entries and a count_nonzero over the whole slab — which stood for
// the reference's per-shard body src/repro/core/sharded.py:270 _topn_local
// (take_along_axis, lax.top_k, the live count).  No Pallas kernel.
//
// Bound on this card: bytes.  Every row's C counts (for the live count),
// its k order heads and its total are read once: at S = 4, N = 2^20,
// C = 128, n = 16 that is 2.43 GB, 0.73 ms at 3.35 TB/s.  So the kernel
// streams: block s * B + b owns a contiguous tile of shard s's rows, split
// in contiguous runs over its 8 warps; each warp takes its rows a group at
// a time (about 64 window entries: 4 rows at k = 16, so a step's fixed
// costs, the copies' issue, the waits, the ballots, are shared) and keeps
// groups in flight through a ring of shared-memory slots filled by
// cp.async (16-B copies where C % 4 == 0 on 16-B aligned slabs, 4-B ones
// else).  A row in a slot gives its live count and its k window
// probabilities
// (cnt[order[j]] / max(tot, 1), IEEE float32: __int2float_rn, __fdiv_rn)
// with no second read of the slab.  Each warp keeps its best n entries,
// sorted, in shared memory, under the key (prob bits << 32) | (0xFFFFFFFF -
// (row * k + j)): non-negative floats order as their bits, so the key
// orders (prob desc, flat position asc), lax.top_k's order; it needs
// N * k <= 2^32.  A candidate is admitted only when its key beats the
// warp's n-th (one compare and a ballot per 32 entries): on the chain's
// data almost every entry is rejected there.  The block merges its warps'
// lists by rank and writes list s * B + b (0 past its live entries); one
// atomic per counter per block adds its live edges and live window entries
// to its shard's counts.  Dead window entries never enter a list: their
// picks in the reference are EMPTY / 0.0 and counted by the counts.
//
// The merge of the S * B lists and the winners' labels are the next two
// launches (csrc/topn_merge.cu: mcq_topn_merge_windows, mcq_topn_label).
#include "common.cuh"

#define MCQ_TW_THREADS 256
#define MCQ_TW_WARPS (MCQ_TW_THREADS / MCQ_WARP)

__device__ __forceinline__ void mcq_cp_async16(void* smem, const void* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(gmem) : "memory");
}

__device__ __forceinline__ void mcq_cp_async4(void* smem, const void* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
               "l"(gmem) : "memory");
}

__device__ __forceinline__ void mcq_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void mcq_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Insert ``cand`` (above list[n - 1]) into the warp's descending list.
__device__ __forceinline__ void mcq_tw_insert(unsigned long long* list, int n,
                                              unsigned long long cand) {
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  int above = 0;
  for (int i = lane; i < n; i += MCQ_WARP) above += list[i] > cand;
  const int pos = __reduce_add_sync(MCQ_FULL_MASK, above);
  for (int base = (n - 1) / MCQ_WARP * MCQ_WARP; base >= 0 && base + MCQ_WARP > pos;
       base -= MCQ_WARP) {  // shift [pos, n - 1) up by one, top chunk first
    const int i = base + lane;
    const bool move = i >= pos && i < n - 1;
    const unsigned long long v = move ? list[i] : 0ull;
    __syncwarp();
    if (move) list[i + 1] = v;
    __syncwarp();
  }
  if (lane == 0) list[pos] = cand;
  __syncwarp();
}

// Entries of a descending list of ``len`` unique keys that are above ``key``.
__device__ __forceinline__ int mcq_tw_above(const unsigned long long* list,
                                            int len, unsigned long long key) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] > key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ unsigned long long mcq_tw_warp_sum(
    unsigned long long x) {
  for (int off = MCQ_WARP / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(MCQ_FULL_MASK, x, off);
  return x;
}

// Shared memory of a block: the warps' lists, then the ring of row slots
// (``slot`` ints each: the padded counts, the padded order heads, the
// totals).
__host__ __device__ inline size_t mcq_tw_stream_smem(int n, int slot,
                                                     int depth) {
  return sizeof(unsigned long long) * MCQ_TW_WARPS * n +
         sizeof(int32_t) * static_cast<size_t>(MCQ_TW_WARPS) * depth * slot;
}

template <bool VEC, int DEPTH>
__global__ void __launch_bounds__(MCQ_TW_THREADS, 4)
mcq_topn_windows_kernel(
    const int32_t* __restrict__ cnt, const int32_t* __restrict__ order,
    const int32_t* __restrict__ tot, int rows, int cap, int k, int n,
    int blocks, int tile, int cpad, int kpad, int group,
    unsigned long long* lists, unsigned long long* counts) {
  extern __shared__ __align__(16) unsigned char tw_smem[];
  __shared__ int held_of[MCQ_TW_WARPS];
  __shared__ unsigned long long live_of[MCQ_TW_WARPS], shown_of[MCQ_TW_WARPS];
  const int warp = threadIdx.x / MCQ_WARP;
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  // a slot: the group's counts (cpad each), order heads (kpad each), totals
  const int heads_at = group * cpad, tots_at = group * (cpad + kpad);
  const int slot_ints = tots_at + 8;
  unsigned long long* all_lists = reinterpret_cast<unsigned long long*>(tw_smem);
  unsigned long long* list = all_lists + static_cast<size_t>(warp) * n;
  int32_t* ring = reinterpret_cast<int32_t*>(all_lists + MCQ_TW_WARPS * n) +
                  static_cast<size_t>(warp) * DEPTH * slot_ints;
  const int s = blockIdx.x / blocks;
  const int b = blockIdx.x - s * blocks;
  const long long first = min(static_cast<long long>(b) * tile,
                              static_cast<long long>(rows));
  const int r0 = static_cast<int>(first);
  const int r1 = static_cast<int>(min(first + tile, static_cast<long long>(rows)));
  const int per_warp = (r1 - r0 + MCQ_TW_WARPS - 1) / MCQ_TW_WARPS;
  const int w0 = min(r1, r0 + warp * per_warp);
  const int w1 = min(r1, w0 + per_warp);
  const long long shard = static_cast<long long>(s) * rows;

  for (int i = lane; i < n; i += MCQ_WARP) list[i] = 0ull;
  __syncwarp();

  // the copies of the group of rows from ``row`` (its last may be short)
  auto issue = [&](int row, int32_t* slot) {
    const int g = min(group, w1 - row);
    const int32_t* c = cnt + (shard + row) * cap;
    const int32_t* o = order + (shard + row) * cap;
    if (VEC) {   // the group's rows are contiguous, and so are their slots
      for (int q = lane; q < g * cap / 4; q += MCQ_WARP)
        mcq_cp_async16(slot + 4 * q, c + 4 * q);
      const int per = kpad / 4;
      for (int q = lane; q < g * per; q += MCQ_WARP) {
        const int r = q / per, at = 4 * (q - r * per);
        mcq_cp_async16(slot + heads_at + r * kpad + at, o + r * cap + at);
      }
    } else {
      for (int r = 0; r < g; ++r) {
        for (int q = lane; q < cap; q += MCQ_WARP)
          mcq_cp_async4(slot + r * cpad + q, c + r * cap + q);
        for (int q = lane; q < k; q += MCQ_WARP)
          mcq_cp_async4(slot + heads_at + r * kpad + q, o + r * cap + q);
      }
    }
    if (lane < g) mcq_cp_async4(slot + tots_at + lane, tot + shard + row + lane);
  };

  for (int d = 0; d < DEPTH - 1; ++d) {
    if (w0 + d * group < w1) issue(w0 + d * group, ring + d * slot_ints);
    mcq_cp_commit();
  }
  unsigned long long thr = 0ull;   // the list's n-th key (0: not full)
  int held = 0;                    // keys in the list
  unsigned live = 0u, shown = 0u;  // this lane's live edges, live window entries
  for (int row = w0, i = 0; row < w1; row += group, ++i) {
    const int ahead = row + (DEPTH - 1) * group;
    if (ahead < w1) issue(ahead, ring + ((i + DEPTH - 1) % DEPTH) * slot_ints);
    mcq_cp_commit();
    mcq_cp_wait<DEPTH - 1>();  // this lane's copies of group i have landed
    __syncwarp();              // and every lane's
    const int32_t* sl = ring + (i % DEPTH) * slot_ints;
    const int g = min(group, w1 - row);
    if (VEC) {
      for (int q = lane; q < g * cap / 4; q += MCQ_WARP) {
        const int4 v = reinterpret_cast<const int4*>(sl)[q];
        live += (v.x > 0) + (v.y > 0) + (v.z > 0) + (v.w > 0);
      }
    } else {
      for (int r = 0; r < g; ++r)
        for (int q = lane; q < cap; q += MCQ_WARP) live += sl[r * cpad + q] > 0;
    }
    // the group's windows, entry e = r * k + j: flat position row * k + e
    const unsigned flat0 = static_cast<unsigned>(row) * static_cast<unsigned>(k);
    for (int e0 = 0; e0 < g * k; e0 += MCQ_WARP) {
      const int e = e0 + lane;
      unsigned long long key = 0ull;
      if (e < g * k) {
        const int r = e / k, j = e - r * k;
        const int slot = sl[heads_at + r * kpad + j];
        const int c = static_cast<unsigned>(slot) < static_cast<unsigned>(cap)
                          ? sl[r * cpad + slot] : 0;
        if (c > 0) {
          ++shown;
          const int t = sl[tots_at + r];
          const float p = __fdiv_rn(__int2float_rn(c),
                                    __int2float_rn(t > 1 ? t : 1));
          key = (static_cast<unsigned long long>(__float_as_uint(p)) << 32) |
                (0xFFFFFFFFu - (flat0 + e));
        }
      }
      unsigned want = __ballot_sync(MCQ_FULL_MASK, key > thr);
      while (want) {   // rare once the list is full
        const int from = mcq_first_lane(want);
        mcq_tw_insert(list, n, __shfl_sync(MCQ_FULL_MASK, key, from));
        held = min(n, held + 1);
        thr = held == n ? list[n - 1] : 0ull;
        if (lane == from) key = 0ull;
        want = __ballot_sync(MCQ_FULL_MASK, key > thr);
      }
    }
    __syncwarp();   // the slot is refilled DEPTH - 1 groups on
  }
  mcq_cp_wait<0>();
  const unsigned long long wlive = mcq_tw_warp_sum(live);
  const unsigned long long wshown = mcq_tw_warp_sum(shown);
  if (lane == 0) {
    held_of[warp] = held;
    live_of[warp] = wlive;
    shown_of[warp] = wshown;
  }
  __syncthreads();

  // the block's list: each warp key at its rank among all the warps' keys
  unsigned long long* out = lists + static_cast<size_t>(blockIdx.x) * n;
  int total = 0;
  for (int w = 0; w < MCQ_TW_WARPS; ++w) total += held_of[w];
  for (int e = threadIdx.x; e < MCQ_TW_WARPS * n; e += blockDim.x) {
    const int w = e / n, at = e - w * n;
    if (at < held_of[w]) {
      const unsigned long long key = all_lists[e];
      int rank = at;
      for (int v = 0; v < MCQ_TW_WARPS; ++v)
        if (v != w) rank += mcq_tw_above(all_lists + v * n, held_of[v], key);
      if (rank < n) out[rank] = key;
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (i >= total) out[i] = 0ull;
  if (threadIdx.x == 0) {
    unsigned long long sl = 0ull, ss = 0ull;
    for (int w = 0; w < MCQ_TW_WARPS; ++w) {
      sl += live_of[w];
      ss += shown_of[w];
    }
    atomicAdd(counts + 2 * s, sl);
    atomicAdd(counts + 2 * s + 1, ss);
  }
}

template <bool VEC, int DEPTH>
static int mcq_tw_launch(const int32_t* cnt, const int32_t* order,
                         const int32_t* tot, int shards, int rows, int cap,
                         int k, int n, int blocks, int cpad, int kpad,
                         int group, size_t smem, unsigned long long* lists,
                         unsigned long long* counts, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mcq_topn_windows_kernel<VEC, DEPTH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tile = (rows + blocks - 1) / blocks;
  mcq_topn_windows_kernel<VEC, DEPTH><<<shards * blocks, MCQ_TW_THREADS, smem,
                                        stream>>>(
      cnt, order, tot, rows, cap, k, n, blocks, tile, cpad, kpad, group,
      lists, counts);
  return mcq_launch_status();
}

static int mcq_tw_pad(int x) { return (x + 3) / 4 * 4; }

static bool mcq_tw_vec(const void* cnt, const void* order, int cap) {
  return cap % 4 == 0 && reinterpret_cast<uintptr_t>(cnt) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(order) % 16 == 0;
}

static int mcq_tw_slot(int cpad, int kpad, int group) {
  return group * (cpad + kpad) + 8;
}

// Rows a warp takes a step: about 64 window entries (two ballots), at most
// 8, fewer while a block's ring of 2 slots would pass 48 KB.
static int mcq_tw_group(int cpad, int kpad, int k, int n) {
  int group = 64 / k;
  group = group < 1 ? 1 : group > 8 ? 8 : group;
  while (group > 1 &&
         mcq_tw_stream_smem(n, mcq_tw_slot(cpad, kpad, group), 2) > 48 * 1024)
    group /= 2;
  return group;
}

// Slots in a warp's ring: 4 (3 groups in flight) while a block's ring stays
// under 48 KB (four blocks an SM), else 2.
static int mcq_tw_depth(int n, int slot) {
  return mcq_tw_stream_smem(n, slot, 4) <= 48 * 1024 ? 4 : 2;
}

// Blocks per shard: two resident blocks an SM (measured faster than four
// at phase sharded's shape: fewer lists, longer runs a warp), at most
// max_lists / shards (the merge's lists in one launch), at most one per
// 64 rows, at least 1.  -1 on a bad shape.
extern "C" int mcq_topn_windows_blocks(int shards, int rows, int cap, int k,
                                       int n, int max_lists) {
  if (shards < 1 || rows < 1 || cap < 1 || k < 1 || k > cap || n < k ||
      max_lists < shards)
    return -1;
  const int cpad = mcq_tw_pad(cap), kpad = mcq_tw_pad(k);
  const int slot = mcq_tw_slot(cpad, kpad, mcq_tw_group(cpad, kpad, k, n));
  const int depth = mcq_tw_depth(n, slot);
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return -1;
  const size_t smem = mcq_tw_stream_smem(n, slot, depth);
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mcq_topn_windows_kernel<true, 4>, MCQ_TW_THREADS, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    per_sm = 1;
  }
  per_sm = per_sm < 1 ? 1 : per_sm > 2 ? 2 : per_sm;
  long long want = (static_cast<long long>(sms) * per_sm + shards - 1) / shards;
  const long long by_rows = (rows + 63) / 64;
  if (want > max_lists / shards) want = max_lists / shards;
  if (want > by_rows) want = by_rows;
  return want < 1 ? 1 : static_cast<int>(want);
}

// cnt / order int32 [shards, rows, cap], tot int32 [shards, rows], k =
// min(n, cap) <= 1,024, rows * k <= 2^32.  lists uint64 [shards * blocks,
// n] (written), counts uint64 [2 * shards] zeroed (the shards' live edges
// and live window entries).
extern "C" int mcq_topn_windows(const void* cnt, const void* order,
                                const void* tot, int shards, int rows,
                                int cap, int k, int n, int blocks, void* lists,
                                void* counts, void* stream) {
  if (shards < 1 || rows < 1 || cap < 1 || cap > 1024 || k < 1 || k > cap ||
      n < k || blocks < 1 ||
      static_cast<unsigned long long>(rows) * k > 0x100000000ull)
    return -1;
  const bool vec = mcq_tw_vec(cnt, order, cap);
  const int cpad = vec ? cap : mcq_tw_pad(cap);
  const int kpad = mcq_tw_pad(k);
  const int group = mcq_tw_group(cpad, kpad, k, n);
  const int slot = mcq_tw_slot(cpad, kpad, group);
  const int depth = mcq_tw_depth(n, slot);
  const size_t smem = mcq_tw_stream_smem(n, slot, depth);
  auto c = static_cast<const int32_t*>(cnt);
  auto o = static_cast<const int32_t*>(order);
  auto t = static_cast<const int32_t*>(tot);
  auto l = static_cast<unsigned long long*>(lists);
  auto cn = static_cast<unsigned long long*>(counts);
  auto st = static_cast<cudaStream_t>(stream);
#define MCQ_TW_LAUNCH(V, D)                                                 \
  return mcq_tw_launch<V, D>(c, o, t, shards, rows, cap, k, n, blocks, cpad, \
                             kpad, group, smem, l, cn, st)
  if (vec) {
    if (depth == 4) MCQ_TW_LAUNCH(true, 4);
    MCQ_TW_LAUNCH(true, 2);
  }
  if (depth == 4) MCQ_TW_LAUNCH(false, 4);
  MCQ_TW_LAUNCH(false, 2);
#undef MCQ_TW_LAUNCH
}
