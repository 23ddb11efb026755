// Fast-path batched increment of existing edges, in place.
//
// Each warp (one per block) takes a tile of 32 consecutive items (row, dst,
// w; fewer for a small batch: mcq_su_tile) and keeps many of their loads in
// flight at once:
//   trip 1  rows/dsts/w of the tile, one coalesced load each;
//   trip 2  the first 32 slots of every item's dst_slab row.  Lane group
//           g (lanes 8g .. 8g+7) scans items 8g .. 8g+7; each lane reads 4
//           consecutive slots of each of the 8 rows (one 16-B int4 load per
//           row when the rows are 16-B aligned, 4 scalar loads otherwise),
//           so a lane has 8 independent loads issued before any compare;
//   later   32 slots more per step, only for items not found yet (rows
//           wider than 32 slots whose dst lies further in).
// The LOWEST matching slot wins (a group min over the 8 lanes), as in the
// reference (hit & (cumsum(hit) == 1)).  Then every found item adds w to
// cnt[row, slot] with an int32 atomic, and the items of one row combine
// their tot increments in the warp (__match_any_sync on the row, a sum over
// the matching lanes): one tot atomic and one dirty-flag store per distinct
// row per warp.  The update hands the items sorted by (src, dst), so a
// row's items are neighbours and mostly share a warp.  int32 wrap-around
// addition is exact in any order, so duplicate items and the order of the
// atomics change no bit.  Absent edges and rows < 0 are no-ops.  Any
// capacity >= 1.  What bounds it on the card is the random accesses (a row
// read, a cnt and a tot read-modify-write per found item, anywhere in the
// state), not the bytes they move.
#include "common.cuh"

#define MCQ_SU_GROUP 8  // lanes per item in the row scan; items per group

// Slots j .. j+3 of row p into x, those inside the row (live items only).
template <bool kVec>
__device__ __forceinline__ void mcq_su_load4(const int32_t* __restrict__ p,
                                             int j, int capacity, bool live,
                                             int32_t (&x)[4]) {
  if (kVec) {  // capacity % 4 == 0 and p 16-B aligned: j < capacity covers 4
    if (live && j < capacity) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(p + j));
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (live && j + v < capacity) x[v] = __ldg(p + j + v);
  }
}

// One warp per block, ``tile`` items per warp.
template <bool kVec>
__global__ void __launch_bounds__(MCQ_WARP) mcq_slab_update_kernel(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ dsts,
    const int32_t* __restrict__ w, const int32_t* __restrict__ dst_slab,
    int32_t* cnt, int32_t* tot, uint8_t* __restrict__ dirty, int batch,
    int capacity, int tile) {
  const int lane = threadIdx.x;
  const int sub = lane & (MCQ_SU_GROUP - 1);
  const long long i = static_cast<long long>(blockIdx.x) * tile + lane;
  // trip 1: the tile's items (lane L holds item L)
  const bool in = lane < tile && i < batch;
  const int32_t row = in ? __ldg(rows + i) : -1;
  const int32_t d = in ? __ldg(dsts + i) : 0;
  const int32_t wi = in ? __ldg(w + i) : 0;

  // the group's 8 items: item k of group g is lane 8g + k's
  int32_t grow[MCQ_SU_GROUP], gd[MCQ_SU_GROUP];
  int slot[MCQ_SU_GROUP];  // lowest matching slot, capacity if none (yet)
  unsigned pending = 0;     // bit k: item k has a row and no hit yet
#pragma unroll
  for (int k = 0; k < MCQ_SU_GROUP; ++k) {
    grow[k] = __shfl_sync(MCQ_FULL_MASK, row, k, MCQ_SU_GROUP);
    gd[k] = __shfl_sync(MCQ_FULL_MASK, d, k, MCQ_SU_GROUP);
    slot[k] = capacity;
    if (grow[k] >= 0) pending |= 1u << k;
  }

  // trip 2 (and on): 32 slots of every pending item's row per step, all
  // loads of a step issued before any compare
  for (int s0 = 0; s0 < capacity && __any_sync(MCQ_FULL_MASK, pending != 0);
       s0 += MCQ_SU_GROUP * 4) {
    const int j = s0 + 4 * sub;
    int32_t x[MCQ_SU_GROUP][4] = {};
#pragma unroll
    for (int k = 0; k < MCQ_SU_GROUP; ++k) {
      const bool live = (pending >> k) & 1u;
      const int32_t r = live ? grow[k] : 0;
      mcq_su_load4<kVec>(dst_slab + static_cast<size_t>(r) * capacity, j,
                         capacity, live, x[k]);
    }
#pragma unroll
    for (int k = 0; k < MCQ_SU_GROUP; ++k) {
      int cand = capacity;  // this lane's lowest hit among its 4 slots
#pragma unroll
      for (int v = 3; v >= 0; --v)
        if (((pending >> k) & 1u) && j + v < capacity && x[k][v] == gd[k])
          cand = j + v;
#pragma unroll
      for (int off = MCQ_SU_GROUP / 2; off > 0; off >>= 1)
        cand = min(cand, __shfl_xor_sync(MCQ_FULL_MASK, cand, off,
                                         MCQ_SU_GROUP));
      if (cand < capacity) {
        slot[k] = cand;
        pending &= ~(1u << k);
      }
    }
  }

  // back to lane L's own item (k = L % 8 of its group)
  int own = capacity;
#pragma unroll
  for (int k = 0; k < MCQ_SU_GROUP; ++k)
    if (k == sub) own = slot[k];
  const bool found = row >= 0 && own < capacity;
  if (found)
    atomicAdd(cnt + static_cast<size_t>(row) * capacity + own, wi);
  // one tot atomic and one flag per distinct row of the warp
  const unsigned peers = __match_any_sync(MCQ_FULL_MASK, found ? row : -1);
  const unsigned sum = __reduce_add_sync(
      peers, found ? static_cast<unsigned>(wi) : 0u);
  if (found && lane == mcq_first_lane(peers)) {
    atomicAdd(tot + row, static_cast<int32_t>(sum));
    if (dirty != nullptr) dirty[row] = 1;
  }
}

// Items per warp: 32, halved (down to 1) while the batch would give fewer
// than two warps per SM.  More items per warp keep more of the scattered
// row and cnt accesses in flight, which pays at 65,536 items (0.0168 ms at
// 32 items per warp, 0.0202 at 8), but a small batch then leaves most SMs
// idle (190 items: 0.0093 ms at 32, 0.0070 at 1; H100 at 700 W,
// scripts/kernel_ablation.py).
static int mcq_su_tile(int batch) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int tile = MCQ_WARP;
  while (tile > 1 && (batch + tile - 1) / tile < 2 * sms) tile >>= 1;
  return tile;
}

extern "C" int mcq_slab_update(const void* rows, const void* dsts,
                               const void* w, const void* dst_slab, void* cnt,
                               void* tot, void* dirty, int batch, int capacity,
                               void* stream) {
  if (batch <= 0) return 0;
  const int tile = mcq_su_tile(batch);
  const int blocks = (batch + tile - 1) / tile;
  const bool vec = capacity % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(dst_slab) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* dd = static_cast<const int32_t*>(dsts);
  const auto* ww = static_cast<const int32_t*>(w);
  const auto* ds = static_cast<const int32_t*>(dst_slab);
  auto* c = static_cast<int32_t*>(cnt);
  auto* t = static_cast<int32_t*>(tot);
  auto* f = static_cast<uint8_t*>(dirty);
  if (vec)
    mcq_slab_update_kernel<true><<<blocks, MCQ_WARP, 0, s>>>(
        r, dd, ww, ds, c, t, f, batch, capacity, tile);
  else
    mcq_slab_update_kernel<false><<<blocks, MCQ_WARP, 0, s>>>(
        r, dd, ww, ds, c, t, f, batch, capacity, tile);
  return mcq_launch_status();
}
