// Decay of slab rows (paper §II.C) in one pass: halve every count, evict the
// edges whose count reaches 0, re-sum the row and fully re-sort its order.
//
// One warp per row, one read and one write of the row.  The warp loads the
// row's cnt, dst and order once (coalesced), writes cnt >> 1 and the evicted
// dst straight back out, sums the halved counts with a warp reduction
// (uint32, so the int32 wrap-around gives the same bits in any order), and
// stages the halved counts and the order row in shared memory.
//
// The new order is the stable descending sort of the halved counts in
// priority order -- what C//2+1 odd-even transposition passes (strict <, so
// ties never swap) compute -- which is the sort by the unique key (count
// descending, priority position e ascending).  A row whose halved counts are
// already non-increasing keeps its order (the update's odd-even pass keeps
// most rows so).  Any other row is sorted by that key with a bitonic network
// in registers, padded to a power of two P = 32 * V with keys that sort
// last; the keys are unique, so any network gives the same bits.  A key is
// 64 bits, -count * 2^32 + e.
// Lane L holds positions L*V .. L*V+V-1: a step of distance j < V is a
// compare-exchange between two registers of one lane, a step of j >= V one
// __shfl_xor_sync with lane L ^ (j / V).
//
// In place: each output may be its input (the state's owner decays its own
// tensors).  Element j of a row is read and then written by the same lane,
// and order is staged whole in shared memory before any of it is written, so
// the aliased pairs carry no __restrict__.
//
// Rolling mode (cursor != null): the block of rows is found on the device --
// cur = cursor mod ceil(n / r), row0 = min(cur * r, n - r), the clamped last
// block of the reference -- and cur + 1 is written back to the cursor by a
// one-thread launch after the block: every warp of the block launch reads the
// cursor, so none of them may move it.  Rows outside the block are not
// touched.  fire (a device bool, or null for "always"): when it is false the
// launches return at once and the cursor stays.  dirty (uint8 per row, or
// null): set to 1 for every row decayed.
//
// The per-row dst hash (dh_keys/dh_vals[N, H], paper §II.2; null without
// it) is repaired in the same pass, as src/repro/core/mcprioq.py:580
// _dh_repair_rows does after a block decays: with the row's halved counts
// staged in shared memory, the warp reads the row's H lanes (coalesced) and
// makes every occupied lane (key >= 0) whose slot clip(val, 0, C-1) now
// holds count 0 a TOMB; their number is added to *tombstones with one
// integer atomic per row (a sum in any order gives the same bits).
#include <climits>

#include "common.cuh"

#define MCQ_DECAY_WARPS 4
#define MCQ_DECAY_MAX_V 32  // capacity <= 32 * 32 = 1024

__device__ __forceinline__ long long mcq_decay_key(int32_t count, int pos) {
  // halved counts lie in [-2^30, 2^30), so -count * 2^32 + pos cannot overflow
  return -static_cast<long long>(count) * 4294967296LL + pos;
}

// Ascending bitonic sort of the warp's 32 * V keys, lane L holding keys
// L*V .. L*V+V-1.  A step of distance j < V compares two registers of one
// lane, a step of j >= V the same register of lane L ^ (j / V).
template <int LOG_V>
__device__ __forceinline__ void mcq_bitonic_sort(long long (&key)[1 << LOG_V],
                                                 int lane) {
  constexpr int V = 1 << LOG_V;
  constexpr int LOG_P = LOG_V + 5;
#pragma unroll
  for (int ks = 1; ks <= LOG_P; ++ks) {
    const int k = 1 << ks;
#pragma unroll
    for (int js = ks - 1; js >= 0; --js) {
      const int j = 1 << js;
      if (j >= V) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int e = lane * V + v;
          const long long other = __shfl_xor_sync(MCQ_FULL_MASK, key[v], j / V);
          const bool keep_min = ((e & j) == 0) == ((e & k) == 0);
          const bool lower = key[v] < other;
          key[v] = keep_min == lower ? key[v] : other;
        }
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if ((v & j) == 0) {
            const bool ascending = ((lane * V + v) & k) == 0;
            const long long a = key[v], b = key[v | j];
            const bool swap = ascending ? (a > b) : (a < b);
            key[v] = swap ? b : a;
            key[v | j] = swap ? a : b;
          }
        }
      }
    }
  }
}

// The block the cursor selects: cursor mod ceil(n / r), a floor mod as
// jnp.remainder.
__device__ __forceinline__ long long mcq_decay_block(int32_t cursor,
                                                     long long num_rows,
                                                     long long block_rows) {
  const long long n_blocks = (num_rows + block_rows - 1) / block_rows;
  long long cur = static_cast<long long>(cursor) % n_blocks;
  if (cur < 0) cur += n_blocks;
  return cur;
}

// The cursor moves after every warp of the block launch has read it.
__global__ void mcq_decay_cursor_kernel(int32_t* cursor,
                                        const uint8_t* __restrict__ fire,
                                        long long num_rows,
                                        long long block_rows) {
  if (fire != nullptr && *fire == 0) return;
  *cursor = static_cast<int32_t>(
      mcq_decay_block(*cursor, num_rows, block_rows) + 1);
}

template <int LOG_V>
__global__ void __launch_bounds__(MCQ_DECAY_WARPS * MCQ_WARP)
    mcq_decay_sort_kernel(const int32_t* cnt, const int32_t* dst,
                          const int32_t* order, int32_t* cnt_out,
                          int32_t* dst_out, int32_t* order_out,
                          int32_t* __restrict__ tot_out,
                          const int32_t* __restrict__ cursor,
                          const uint8_t* __restrict__ fire,
                          uint8_t* __restrict__ dirty, long long num_rows,
                          long long block_rows, int capacity,
                          int32_t* __restrict__ dh_keys,
                          const int32_t* __restrict__ dh_vals, int dh_size,
                          int32_t* __restrict__ tombstones) {
  constexpr int V = 1 << LOG_V;
  constexpr int P = V * MCQ_WARP;
  __shared__ int32_t smem[MCQ_DECAY_WARPS][2][P];
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  const int warp = threadIdx.x / MCQ_WARP;
  const long long local =
      static_cast<long long>(blockIdx.x) * MCQ_DECAY_WARPS + warp;
  if (local >= block_rows) return;  // whole warp leaves together
  if (fire != nullptr && *fire == 0) return;
  long long row0 = 0;
  if (cursor != nullptr) {
    const long long cur = mcq_decay_block(*cursor, num_rows, block_rows);
    const long long first = cur * block_rows, last = num_rows - block_rows;
    row0 = first < last ? first : last;
  }
  const size_t base = static_cast<size_t>(row0 + local) * capacity;
  int32_t* s_cnt = smem[warp][0];
  int32_t* s_ord = smem[warp][1];

  // one read of the row: halve, evict, sum.  Every load is issued before
  // any store: the outputs may be the inputs, so the compiler may not move a
  // later load above an earlier store itself.
  int32_t c[V], d[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = lane + i * MCQ_WARP;
    if (j < capacity) {
      c[i] = cnt[base + j] >> 1;
      d[i] = dst[base + j];
      s_ord[j] = order[base + j];
    }
  }
  uint32_t part = 0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = lane + i * MCQ_WARP;
    if (j < capacity) {
      s_cnt[j] = c[i];
      cnt_out[base + j] = c[i];
      dst_out[base + j] = c[i] == 0 ? MCQ_EMPTY : d[i];
      part += static_cast<uint32_t>(c[i]);
    }
  }
  const uint32_t total = __reduce_add_sync(MCQ_FULL_MASK, part);
  if (lane == 0) {
    tot_out[row0 + local] = static_cast<int32_t>(total);
    if (dirty != nullptr) dirty[row0 + local] = 1;
  }
  __syncwarp();

  // the row hash: a lane whose slot died becomes TOMB
  if (dh_keys != nullptr) {
    const size_t hb = static_cast<size_t>(row0 + local) * dh_size;
    int dead = 0;
#pragma unroll 4
    for (int j = lane; j < dh_size; j += MCQ_WARP) {
      const int32_t k = dh_keys[hb + j];
      const int32_t v = dh_vals[hb + j];
      if (k >= 0 && s_cnt[min(max(v, 0), capacity - 1)] == 0) {
        dh_keys[hb + j] = MCQ_TOMB;
        ++dead;
      }
    }
    dead = __reduce_add_sync(MCQ_FULL_MASK, dead);
    if (lane == 0 && dead != 0) atomicAdd(tombstones, dead);
  }

  // the halved counts in priority order; a row already non-increasing keeps
  // its order (a stable sort of a sorted row is the identity)
  int32_t h[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int e = lane * V + v;
    h[v] = e < capacity ? s_cnt[s_ord[e]] : INT_MIN;
  }
  bool in_order = true;
#pragma unroll
  for (int v = 0; v + 1 < V; ++v) in_order = in_order && h[v] >= h[v + 1];
  const int32_t next = __shfl_down_sync(MCQ_FULL_MASK, h[0], 1);
  if (lane + 1 < MCQ_WARP) in_order = in_order && h[V - 1] >= next;
  const bool sorted = __all_sync(MCQ_FULL_MASK, in_order);

  // keys in priority position order (count desc, position asc), padded with
  // keys that sort last; then the sorted position e takes the slot of the
  // position its key carries
  int pos[V];
  if (sorted) {
#pragma unroll
    for (int v = 0; v < V; ++v) pos[v] = lane * V + v;
  } else {
    long long key[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int e = lane * V + v;
      key[v] = e < capacity ? mcq_decay_key(h[v], e) : LLONG_MAX;
    }
    mcq_bitonic_sort<LOG_V>(key, lane);
#pragma unroll
    for (int v = 0; v < V; ++v)
      pos[v] = static_cast<int>(key[v] & 0xffffffffLL);
  }
  __syncwarp();
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int e = lane * V + v;
    if (e < capacity) s_cnt[e] = s_ord[pos[v]];
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = lane + i * MCQ_WARP;
    if (j < capacity) order_out[base + j] = s_cnt[j];
  }
}

template <int LOG_V>
static void mcq_decay_sort_launch(unsigned blocks, cudaStream_t stream,
                                  const int32_t* cnt, const int32_t* dst,
                                  const int32_t* order, int32_t* cnt_out,
                                  int32_t* dst_out, int32_t* order_out,
                                  int32_t* tot_out, const int32_t* cursor,
                                  const uint8_t* fire, uint8_t* dirty,
                                  long long num_rows, long long block_rows,
                                  int capacity, int32_t* dh_keys,
                                  const int32_t* dh_vals, int dh_size,
                                  int32_t* tombstones) {
  mcq_decay_sort_kernel<LOG_V><<<blocks, MCQ_DECAY_WARPS * MCQ_WARP, 0,
                                 stream>>>(
      cnt, dst, order, cnt_out, dst_out, order_out, tot_out, cursor, fire,
      dirty, num_rows, block_rows, capacity, dh_keys, dh_vals, dh_size,
      tombstones);
}

// cursor == null: rows 0 .. block_rows (block_rows == num_rows, the whole
// table), one launch.  Otherwise the rolling block the cursor selects
// (1 <= block_rows <= num_rows), then the cursor's launch.  Outputs may be
// the inputs.  1 <= capacity <= 1024.  dh_keys/dh_vals: null, or the row
// hashes [num_rows, dh_size], repaired, with tombstones (int32) counting.
extern "C" int mcq_decay_sort(const void* cnt, const void* dst,
                              const void* order, void* cnt_out, void* dst_out,
                              void* order_out, void* tot_out, void* cursor,
                              const void* fire, void* dirty,
                              long long num_rows, long long block_rows,
                              int capacity, void* dh_keys, const void* dh_vals,
                              int dh_size, void* tombstones, void* stream) {
  if (block_rows <= 0 || capacity <= 0 || capacity > MCQ_DECAY_MAX_V * MCQ_WARP)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(
      (block_rows + MCQ_DECAY_WARPS - 1) / MCQ_DECAY_WARPS);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int32_t*>(cnt);
  const auto* d = static_cast<const int32_t*>(dst);
  const auto* o = static_cast<const int32_t*>(order);
  auto* co = static_cast<int32_t*>(cnt_out);
  auto* dout = static_cast<int32_t*>(dst_out);
  auto* oo = static_cast<int32_t*>(order_out);
  auto* to = static_cast<int32_t*>(tot_out);
  auto* cur = static_cast<int32_t*>(cursor);
  const auto* f = static_cast<const uint8_t*>(fire);
  auto* dr = static_cast<uint8_t*>(dirty);
  auto* hk = static_cast<int32_t*>(dh_keys);
  const auto* hv = static_cast<const int32_t*>(dh_vals);
  auto* tb = static_cast<int32_t*>(tombstones);
  const int v = (capacity + MCQ_WARP - 1) / MCQ_WARP;
#define MCQ_DECAY_CASE(LOG_V)                                                  \
  mcq_decay_sort_launch<LOG_V>(blocks, s, c, d, o, co, dout, oo, to, cur, f,   \
                               dr, num_rows, block_rows, capacity, hk, hv,     \
                               dh_size, tb)
  if (v <= 1) MCQ_DECAY_CASE(0);
  else if (v <= 2) MCQ_DECAY_CASE(1);
  else if (v <= 4) MCQ_DECAY_CASE(2);
  else if (v <= 8) MCQ_DECAY_CASE(3);
  else if (v <= 16) MCQ_DECAY_CASE(4);
  else MCQ_DECAY_CASE(5);
#undef MCQ_DECAY_CASE
  if (cur != nullptr) {
    const int status = mcq_launch_status();
    if (status != 0) return status;
    mcq_decay_cursor_kernel<<<1, 1, 0, s>>>(cur, f, num_rows, block_rows);
  }
  return mcq_launch_status();
}
