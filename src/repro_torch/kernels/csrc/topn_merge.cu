// Cross-shard top-n merge: the k-way head-pointer merge of L lists into one
// list of n.
//
// The merge: n steps over L lists of length m; each step reads the L list
// heads (a pointer past the end reads 0.0), takes the first maximum under
// jnp.argmax's order (NaN above every number, -0.0 equal to 0.0, the lowest
// list on ties) and advances that list's pointer, whatever its head holds.
//
// One block merges up to 32 * 32 lists in two levels.  Level 1: each warp
// merges a group of 32 consecutive lists, lane l holding list 32 g + l's
// pointer and its next four heads in registers (the load of the fourth is
// in flight while the lane waits for its next win), and records the
// group's n steps — the head as read and its position — in shared memory.
// Level 2: warp 0 merges the groups' step lists the same way.  A group's
// steps are the steps the flat merge takes on its lists, in order (a flat
// step's winner is the first maximum of its group too, and only the
// winner's pointer moves), and the flat merge takes, at each step, the
// first maximum of the groups' next steps, the lowest group on ties
// (groups are consecutive lists): the two levels are the flat merge on any
// input, descending or not.  With one group, level 1 is skipped.
//
// A step is one warp-wide max of a 32-bit key (__reduce_max_sync) and one
// ballot: the key orders floats as jnp.argmax does and leaves 0 to a lane
// that holds no list.
//
// mcq_topn_merge: probs float32 [L, M], row-major.  Block b merges lists
// [lpb * b, lpb * b + lpb) in two levels (a warp per group of 32 lists, then
// warp 0 over the groups), lpb = 32 * groups lists, groups <= 32 and
// groups * n <= MCQ_MERGE_REC_STEPS when groups > 1: one launch merges up to
// 1,024 lists for n <= 256, the round between the groups in shared memory.
// A launch that is not the last (emit = 0) writes each block's n steps raw —
// the head as read (NaN, zero and negative heads too) and its position in
// the original [S, M] lists (pos_in maps a position of this launch's lists
// to it; null in the first) — as the next launch's lists.  The last (emit =
// 1, one block) turns a head that is not > 0 into EMPTY / EMPTY / 0.0 and
// gathers the others' srcs and dsts.  Every grouping of consecutive lists
// is the flat merge (see above), so the launches give the reference's
// lax.scan steps on any input, for any L.
//
// mcq_topn_merge_windows: the merge of the window kernel's block lists
// (csrc/topn_windows.cu), their dsts and the dropped count, in one block;
// mcq_topn_label: the winners' srcs, one pass over the src tables.
#include "common.cuh"

#define MCQ_MERGE_REC_STEPS 8192  // level-1 steps a block keeps (groups * n)
#define MCQ_MERGE_ROUND 256       // output steps between two write-outs

// Lists of a group and groups of a block.
#define MCQ_MERGE_GROUP MCQ_WARP

__device__ __forceinline__ uint32_t mcq_merge_ord(float x) {
  if (isnan(x)) return 0xFFFFFFFFu;             // above every number
  uint32_t b = __float_as_uint(x);
  if (b == 0x80000000u) b = 0u;                 // -0.0 == 0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);  // >= 0x007FFFFF
}

// The lane of the first maximum of ``ord`` over the warp.
__device__ __forceinline__ int mcq_merge_winner(uint32_t ord) {
  const uint32_t top = __reduce_max_sync(MCQ_FULL_MASK, ord);
  return mcq_first_lane(__ballot_sync(MCQ_FULL_MASK, ord == top));
}

// One lane's list: its pointer and the heads at ptr .. ptr + 3.
struct McqMergeLane {
  float h0, h1, h2, h3;
  int ptr;
};

template <class Head>
__device__ __forceinline__ void mcq_merge_start(McqMergeLane& c,
                                                const Head& head, bool valid,
                                                long long list, int m) {
  c.ptr = 0;
  c.h0 = valid && m > 0 ? head(list, 0) : 0.0f;
  c.h1 = valid && m > 1 ? head(list, 1) : 0.0f;
  c.h2 = valid && m > 2 ? head(list, 2) : 0.0f;
  c.h3 = valid && m > 3 ? head(list, 3) : 0.0f;
}

// ``steps`` steps of the warp's merge; the winner of step t records its
// head in rec_p[t] and its position (list * m + pointer, -1 past the end)
// in rec_at[t].
template <class Head>
__device__ __forceinline__ void mcq_merge_run(McqMergeLane& c,
                                              const Head& head, bool valid,
                                              long long list, int m,
                                              int steps, float* rec_p,
                                              long long* rec_at) {
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  for (int t = 0; t < steps; ++t) {
    const int w = mcq_merge_winner(valid ? mcq_merge_ord(c.h0) : 0u);
    if (lane == w) {
      rec_p[t] = c.h0;
      rec_at[t] = c.ptr < m ? list * m + c.ptr : -1;
      ++c.ptr;
      c.h0 = c.h1;
      c.h1 = c.h2;
      c.h2 = c.h3;
      c.h3 = c.ptr + 3 < m ? head(list, c.ptr + 3) : 0.0f;
    }
  }
}

// Shared memory mcq_merge_block needs for L lists and n steps.
__host__ __device__ inline size_t mcq_merge_smem(int lists, int n) {
  const int groups = (lists + MCQ_MERGE_GROUP - 1) / MCQ_MERGE_GROUP;
  const size_t rec = groups > 1 ? static_cast<size_t>(groups) * n : 0;
  return (rec + MCQ_MERGE_ROUND) * (sizeof(long long) + sizeof(float));
}

// n steps of the flat merge of lists [0, L) of length m (head(list, p)
// reads head p of a list, p < m), by the whole block: L <= 32 * 32, and
// groups * n <= MCQ_MERGE_REC_STEPS when L > 32.  emit(i, p, at) is called
// once for every step i, by some thread of the block, with the head taken
// and its position (list * m + pointer, -1 past the end).  ``smem`` holds
// mcq_merge_smem(L, n) bytes, 8-byte aligned.
template <class Head, class Emit>
__device__ void mcq_merge_block(const Head& head, int num_lists, int m, int n,
                                unsigned char* smem, const Emit& emit) {
  const int warp = threadIdx.x / MCQ_WARP;
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  const int warps = blockDim.x / MCQ_WARP;
  const int groups = (num_lists + MCQ_MERGE_GROUP - 1) / MCQ_MERGE_GROUP;
  const size_t rec = groups > 1 ? static_cast<size_t>(groups) * n : 0;
  long long* rec_at = reinterpret_cast<long long*>(smem);
  long long* win_at = rec_at + rec;
  float* rec_p = reinterpret_cast<float*>(win_at + MCQ_MERGE_ROUND);
  float* win_p = rec_p + rec;
  if (groups > 1) {  // level 1: a warp per group of 32 lists
    for (int g = warp; g < groups; g += warps) {
      const long long list = static_cast<long long>(g) * MCQ_MERGE_GROUP + lane;
      const bool valid = list < num_lists;
      McqMergeLane c;
      mcq_merge_start(c, head, valid, list, m);
      mcq_merge_run(c, head, valid, list, m, n, rec_p + static_cast<size_t>(g) * n,
                    rec_at + static_cast<size_t>(g) * n);
    }
    __syncthreads();
  }
  auto rec_head = [rec_p, n](long long g, int p) {
    return rec_p[g * n + p];
  };
  const bool valid = lane < (groups > 1 ? groups : num_lists);
  McqMergeLane c;
  if (warp == 0) {
    if (groups > 1) mcq_merge_start(c, rec_head, valid, lane, n);
    else mcq_merge_start(c, head, valid, lane, m);
  }
  for (int base = 0; base < n; base += MCQ_MERGE_ROUND) {
    const int steps = min(MCQ_MERGE_ROUND, n - base);
    if (warp == 0) {  // the last level
      if (groups > 1) mcq_merge_run(c, rec_head, valid, lane, n, steps, win_p, win_at);
      else mcq_merge_run(c, head, valid, lane, m, steps, win_p, win_at);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < steps; i += blockDim.x) {
      long long at = win_at[i];
      if (groups > 1 && at >= 0) at = rec_at[at];  // a group's step -> list
      emit(base + i, win_p[i], at);
    }
    __syncthreads();
  }
}

// The window lists' merge and labels (csrc/topn_windows.cu writes the
// lists): L = S * B lists of n keys, list s * B + b the block b of shard
// s, each key (prob bits << 32) | (0xFFFFFFFF - (row * k + j)) of a live
// window entry, descending, 0 past the block's live entries.  Blocks own
// consecutive rows, so the flat merge of the lists by prob (the lowest list
// on ties) takes the entries in (prob desc, shard, row, window position)
// order: the reference's per-shard lax.top_k and cross-shard merge.  Each
// winner is labelled from the slab (dst at the slot order[s, row, j]); a
// head that is not > 0 is EMPTY / EMPTY / 0.0.  Every src is left EMPTY
// for the label pass (mcq_topn_label below), which reads
// the src tables once: win int32 [3 n] gets each output's flat row s * N +
// row (INT_MAX where dead), then those rows sorted and, beside them, their
// output positions.  counts[2 s], counts[2 s + 1]: shard s's live edges
// and live window entries; dropped = sum_s (live_s - min(n, window
// live_s)).
__global__ void __launch_bounds__(1024) mcq_topn_merge_windows_kernel(
    const unsigned long long* __restrict__ lists,
    const unsigned long long* __restrict__ counts, int num_shards, int blocks,
    int n, int k, int rows, int cap, const int32_t* __restrict__ order,
    const int32_t* __restrict__ dst, int32_t* win, int32_t* out_src,
    int32_t* out_dst, float* out_p, int32_t* out_dropped) {
  extern __shared__ __align__(16) unsigned char merge_smem[];
  auto head = [lists, n](long long list, int p) {
    return __uint_as_float(
        static_cast<uint32_t>(lists[list * n + p] >> 32));
  };
  mcq_merge_block(head, num_shards * blocks, n, n, merge_smem,
                  [&](int i, float p, long long at) {
    out_src[i] = MCQ_EMPTY;
    if (p > 0.0f) {   // a live key: at >= 0
      const unsigned long long key = lists[at];
      const long long s = at / n / blocks;
      const uint32_t flat = 0xFFFFFFFFu - static_cast<uint32_t>(key);
      const long long row = s * rows + flat / k;
      const int32_t slot = order[row * cap + flat % k];
      win[i] = static_cast<int32_t>(row);
      out_dst[i] = dst[row * cap + slot];
      out_p[i] = p;
    } else {
      win[i] = 0x7FFFFFFF;
      out_dst[i] = MCQ_EMPTY;
      out_p[i] = 0.0f;
    }
  });
  // the rows sorted (by rank: n is small), each beside its output position
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int32_t r = win[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const int32_t q = win[j];
      rank += q < r || (q == r && j < i);
    }
    win[n + rank] = r;
    win[2 * n + rank] = i;
  }
  if (threadIdx.x == 0) {
    long long dropped = 0;
    for (int s = 0; s < num_shards; ++s) {
      const long long live = static_cast<long long>(counts[2 * s]);
      const long long shown = static_cast<long long>(counts[2 * s + 1]);
      dropped += live - (shown < n ? shown : n);
    }
    *out_dropped = static_cast<int32_t>(dropped);
  }
}

#define MCQ_TOPN_MIN_THREADS 128

__global__ void __launch_bounds__(1024) mcq_topn_merge_kernel(
    const float* __restrict__ probs, const long long* __restrict__ pos_in,
    const int32_t* __restrict__ dsts, const int32_t* __restrict__ srcs,
    int num_lists, int m, int n, int lists_per_block, int emit,
    int32_t* __restrict__ out_src, int32_t* __restrict__ out_dst,
    float* __restrict__ out_p, long long* __restrict__ out_pos) {
  extern __shared__ __align__(16) unsigned char merge_smem[];
  const long long first = static_cast<long long>(blockIdx.x) * lists_per_block;
  const int lists = min(static_cast<long long>(lists_per_block),
                        num_lists - first);
  const float* base = probs + first * m;
  auto head = [base, m](long long list, int p) {
    return __ldg(base + list * m + p);
  };
  const size_t out0 = static_cast<size_t>(blockIdx.x) * n;
  mcq_merge_block(head, lists, m, n, merge_smem,
                  [&](int i, float p, long long at) {
    const long long here = at < 0 ? -1 : at + first * m;
    const long long orig =
        here < 0 ? -1 : pos_in != nullptr ? pos_in[here] : here;
    if (emit) {
      const bool live = p > 0.0f;  // the pointer was inside its list
      out_src[i] = live ? srcs[orig] : MCQ_EMPTY;
      out_dst[i] = live ? dsts[orig] : MCQ_EMPTY;
      out_p[i] = live ? p : 0.0f;
    } else {
      out_p[out0 + i] = p;
      out_pos[out0 + i] = orig;
    }
  });
}

// The label pass: every valid lane (key >= 0, 0 <= val < rows) of shard
// blockIdx.y's src table whose row s * rows + val is a winner's writes its
// key as that winner's src — the reference's row -> src scatter, read for
// the n winners only.  Blocks stride over the values, four lanes a thread
// with 16-B loads where the table allows; the sorted winner rows are found
// by binary search in shared memory, and only a lane that names a winner's
// row reads its key.
__device__ __forceinline__ void mcq_label_lane(const int32_t* sorted, int n,
                                               int32_t row0, int rows,
                                               const int32_t* key, int32_t val,
                                               int32_t* out_src) {
  if (val < 0 || val >= rows) return;
  const int32_t r = row0 + val;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sorted[mid] < r) lo = mid + 1;
    else hi = mid;
  }
  if (lo == n || sorted[lo] != r) return;
  const int32_t k = *key;
  if (k < 0) return;
  for (; lo < n && sorted[lo] == r; ++lo) out_src[sorted[n + lo]] = k;
}

template <bool VEC>
__global__ void __launch_bounds__(256) mcq_topn_label_kernel(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ vals,
    int table, int rows, const int32_t* __restrict__ win, int n,
    int32_t* __restrict__ out_src) {
  extern __shared__ int32_t sorted[];   // rows [n], then positions [n]
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) sorted[i] = win[n + i];
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.y) * table;
  const int32_t row0 = blockIdx.y * rows;
  const int32_t* k = keys + base;
  const int step = gridDim.x * blockDim.x;
  if (VEC) {
    const int4* v4 = reinterpret_cast<const int4*>(vals + base);
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < table / 4;
         e += step) {
      const int4 v = v4[e];
      mcq_label_lane(sorted, n, row0, rows, k + 4 * e, v.x, out_src);
      mcq_label_lane(sorted, n, row0, rows, k + 4 * e + 1, v.y, out_src);
      mcq_label_lane(sorted, n, row0, rows, k + 4 * e + 2, v.z, out_src);
      mcq_label_lane(sorted, n, row0, rows, k + 4 * e + 3, v.w, out_src);
    }
  } else {
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < table; e += step)
      mcq_label_lane(sorted, n, row0, rows, k + e, vals[base + e], out_src);
  }
}

static int mcq_merge_threads(int lists) {
  const int groups = (lists + MCQ_MERGE_GROUP - 1) / MCQ_MERGE_GROUP;
  const int threads = groups > 1 ? groups * MCQ_WARP : MCQ_WARP;
  return threads < MCQ_TOPN_MIN_THREADS ? MCQ_TOPN_MIN_THREADS : threads;
}

template <class Kernel>
static int mcq_merge_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// One launch: blocks of lists_per_block lists (a multiple of 32, at most
// 1,024, with lists_per_block / 32 * n <= MCQ_MERGE_REC_STEPS when above
// 32).  emit = 1 is the last (num_lists <= lists_per_block, writes out_src /
// out_dst / out_p [n]); emit = 0 writes out_p float32 and out_pos int64
// [ceil(num_lists / lists_per_block), n].
extern "C" int mcq_topn_merge(const void* probs, const void* pos_in,
                              const void* dsts, const void* srcs,
                              int num_lists, int m, int n,
                              int lists_per_block, int emit, void* out_src,
                              void* out_dst, void* out_p, void* out_pos,
                              void* stream) {
  if (n <= 0) return 0;
  const int groups = lists_per_block / MCQ_MERGE_GROUP;
  if (num_lists < 1 || m < 1 || groups < 1 || groups > MCQ_MERGE_GROUP ||
      groups * MCQ_MERGE_GROUP != lists_per_block ||
      (groups > 1 && static_cast<long long>(groups) * n > MCQ_MERGE_REC_STEPS) ||
      (emit && num_lists > lists_per_block))
    return -1;
  const int blocks = (num_lists + lists_per_block - 1) / lists_per_block;
  const int widest = num_lists < lists_per_block ? num_lists : lists_per_block;
  const size_t smem = mcq_merge_smem(widest, n);
  const int status = mcq_merge_allow_smem(mcq_topn_merge_kernel, smem);
  if (status != 0) return status;
  mcq_topn_merge_kernel<<<blocks, mcq_merge_threads(widest), smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(probs), static_cast<const long long*>(pos_in),
      static_cast<const int32_t*>(dsts), static_cast<const int32_t*>(srcs),
      num_lists, m, n, lists_per_block, emit, static_cast<int32_t*>(out_src),
      static_cast<int32_t*>(out_dst), static_cast<float*>(out_p),
      static_cast<long long*>(out_pos));
  return mcq_launch_status();
}

// The window lists' merge: lists uint64 [num_shards * blocks, n], counts
// uint64 [num_shards, 2], order / dst int32 [num_shards, rows, cap]; writes
// out_dst / out_p [n], out_dropped (one int32), out_src [n] EMPTY and win
// int32 [3 n] for mcq_topn_label.
extern "C" int mcq_topn_merge_windows(const void* lists, const void* counts,
                                      int num_shards, int blocks, int n,
                                      int k, int rows, int cap,
                                      const void* order, const void* dst,
                                      void* win, void* out_src, void* out_dst,
                                      void* out_p, void* out_dropped,
                                      void* stream) {
  const int num_lists = num_shards * blocks;
  const int groups = (num_lists + MCQ_MERGE_GROUP - 1) / MCQ_MERGE_GROUP;
  if (n <= 0 || k <= 0 || num_shards < 1 || blocks < 1 ||
      groups > MCQ_MERGE_GROUP ||
      (groups > 1 && static_cast<long long>(groups) * n > MCQ_MERGE_REC_STEPS))
    return -1;
  const size_t smem = mcq_merge_smem(num_lists, n);
  const int status = mcq_merge_allow_smem(mcq_topn_merge_windows_kernel, smem);
  if (status != 0) return status;
  mcq_topn_merge_windows_kernel<<<1, mcq_merge_threads(num_lists), smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(lists),
      static_cast<const unsigned long long*>(counts), num_shards, blocks, n, k,
      rows, cap, static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(dst), static_cast<int32_t*>(win),
      static_cast<int32_t*>(out_src), static_cast<int32_t*>(out_dst),
      static_cast<float*>(out_p), static_cast<int32_t*>(out_dropped));
  return mcq_launch_status();
}

// The winners' srcs from the src tables keys / vals int32 [num_shards,
// table] (rows per shard ``rows``, num_shards * rows < 2^31 - 1) and win as
// mcq_topn_merge_windows wrote it: out_src [n].
extern "C" int mcq_topn_label(const void* keys, const void* vals,
                              int num_shards, int table, int rows,
                              const void* win, int n, void* out_src,
                              void* stream) {
  if (num_shards < 1 || num_shards > 65535 || table < 1 || rows < 1 ||
      n < 1 || n > 4096)
    return -1;
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess)
      return -1;
  }
  const bool vec =
      table % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  // about 8 blocks of 256 an SM over all shards, at most one per 256 loads
  long long per_shard = (8LL * sms + num_shards - 1) / num_shards;
  const long long by_table = (table / (vec ? 4 : 1) + 255) / 256;
  if (per_shard > by_table) per_shard = by_table;
  const dim3 grid(static_cast<unsigned>(per_shard < 1 ? 1 : per_shard),
                  num_shards);
  const size_t smem = 2 * n * sizeof(int32_t);
  auto st = static_cast<cudaStream_t>(stream);
  auto k = static_cast<const int32_t*>(keys);
  auto v = static_cast<const int32_t*>(vals);
  auto w = static_cast<const int32_t*>(win);
  auto o = static_cast<int32_t*>(out_src);
  if (vec)
    mcq_topn_label_kernel<true><<<grid, 256, smem, st>>>(k, v, table, rows, w,
                                                         n, o);
  else
    mcq_topn_label_kernel<false><<<grid, 256, smem, st>>>(k, v, table, rows,
                                                          w, n, o);
  return mcq_launch_status();
}
