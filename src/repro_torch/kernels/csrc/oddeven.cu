// Odd-even transposition passes over every slab row (the paper's lock-free
// bubble sort), into order_out: a fresh tensor, or order itself.
//
// A row takes only the lanes it uses: lanes = next_pow2(ceil(C/2)), at most
// 32, so a warp holds 32 / lanes rows (four at C = 16, one from C = 64 up),
// and a lane owns one compare-exchange pair of a half-pass (C <= 64).  The
// row's cnt and order are loaded together into shared memory, as
// independent loads (16-byte vectors when C % 4 == 0 and the tensors are
// 16-byte aligned: at C = 16 each of a row's 8 lanes loads one vector, the
// first 4 of cnt, the others of order).  The count of position j is
// cnt_s[order_s[j]], so the priority gather never waits on device memory.
// Where a lane owns one pair (C <= 2 * lanes, i.e. C <= 64) it gathers its
// two (count, slot) pairs once and runs every pass in registers: the even
// half-pass within the lane, the odd one with its neighbour by shuffles
// over the row's lanes.  Wider rows run the passes in shared memory,
// synchronised over the row's lanes alone (__syncwarp(row mask)).  One
// global read of cnt and order and at most one write of order per row
// whatever `passes` is.  Descending target, strict <, so equal counts never
// swap; an unpaired tail element just stays.
//
// The grid is the blocks the card holds at once (the occupancy calculator's
// blocks an SM times the SMs), and a row's lanes walk rows a grid apart, so
// no block is launched per handful of rows.  A lane keeps the loads of rows
// still to come in flight in registers while the current row sorts: its
// vector of each of the next two rows where a row is a vector a lane
// (C <= 64), its two vectors of the next row up to C = 128, its int32 pairs
// of the next row where the rows are not 16-byte vectors (C <= 64); wider
// rows load in a loop.
//
// In place (order_out == order) a row in which no pair swapped is the row it
// was -- a swap only removes an inversion -- so its lanes write nothing; a
// row that changed (a ballot over its lanes) is written and flagged in dirty
// (uint8 per row, or null).  The whole row is read into shared memory before
// any of it is written, so order and order_out carry no __restrict__.
//
// Shared memory: 2 * C int32 a row, (32 / lanes) rows a warp, up to
// MCQ_OE_WARPS warps a block, fewer when the rows do not fit (one warp of
// one row up to C = 29,056).
#include "common.cuh"

#define MCQ_OE_WARPS 8
#define MCQ_OE_SMEM_MAX 232448  // dynamic shared memory one block can ask for

// How a row reaches shared memory: a lane's one vector of each of the next
// two rows held in registers (MCQ_OE_VEC_DEEP), its two vectors or int32
// pairs of the next row (MCQ_OE_VEC_STAGED, MCQ_OE_INT_STAGED), or the row
// loaded in a loop (MCQ_OE_VEC_LOOP, MCQ_OE_INT_LOOP).
enum {
  MCQ_OE_VEC_DEEP,
  MCQ_OE_VEC_STAGED,
  MCQ_OE_INT_STAGED,
  MCQ_OE_VEC_LOOP,
  MCQ_OE_INT_LOOP
};

__device__ __forceinline__ int4 mcq_oe_load4(const int32_t* p) {
  return *reinterpret_cast<const int4*>(p);
}

template <int kMode>
__global__ void __launch_bounds__(MCQ_OE_WARPS * MCQ_WARP)
    mcq_oddeven_kernel(const int32_t* __restrict__ cnt, const int32_t* order,
                       int32_t* order_out, uint8_t* __restrict__ dirty,
                       long long num_rows, int capacity, int passes,
                       int lanes) {
  extern __shared__ __align__(16) int32_t smem[];
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  const int per_warp = MCQ_WARP / lanes;
  const int group = lane / lanes, sub = lane % lanes;
  const int slot = (threadIdx.x / MCQ_WARP) * per_warp + group;  // in block
  const long long stride =
      static_cast<long long>(gridDim.x) * (blockDim.x / lanes);
  long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / lanes) +
                  slot;
  const unsigned mask =
      lanes == MCQ_WARP ? MCQ_FULL_MASK
                        : ((1u << lanes) - 1u) << (group * lanes);
  int32_t* c = smem + static_cast<size_t>(slot) * 2 * capacity;
  int32_t* o = c + capacity;
  int4* c4 = reinterpret_cast<int4*>(c);  // c and o as 2v vectors
  // rows of at most 2 * lanes slots: a lane owns one pair, sorted in
  // registers (the modes chosen only for such rows)
  constexpr bool kPairs =
      kMode == MCQ_OE_VEC_DEEP || kMode == MCQ_OE_INT_STAGED;
  const int v = capacity >> 2;
  // this lane's share of a row: vectors u0, u1 of the 2v (cnt's first,
  // then order's) or elements u0, u1 of each of cnt and order; x0, x1 hold
  // the next row's two vectors, or one vector of each of the next two rows
  const int u0 = sub, u1 = sub + lanes;
  int4 x0 = make_int4(0, 0, 0, 0), x1 = x0;
  int32_t e0 = 0, e1 = 0, e2 = 0, e3 = 0;
  auto unit = [&](long long r, int u) {  // vector u of row r
    const size_t base = static_cast<size_t>(r) * capacity;
    return u < v ? mcq_oe_load4(cnt + base + 4 * u)
                 : mcq_oe_load4(order + base + 4 * (u - v));
  };
  auto fetch = [&](long long r) {
    const size_t base = static_cast<size_t>(r) * capacity;
    if (kMode == MCQ_OE_VEC_STAGED) {
      if (u0 < 2 * v) x0 = unit(r, u0);
      if (u1 < 2 * v) x1 = unit(r, u1);
    } else if (kMode == MCQ_OE_INT_STAGED) {
      if (u0 < capacity) {
        e0 = cnt[base + u0];
        e1 = order[base + u0];
      }
      if (u1 < capacity) {
        e2 = cnt[base + u1];
        e3 = order[base + u1];
      }
    }
  };
  if (kMode == MCQ_OE_VEC_STAGED || kMode == MCQ_OE_INT_STAGED) {
    if (row < num_rows) fetch(row);
  } else if (kMode == MCQ_OE_VEC_DEEP && u0 < 2 * v) {
    if (row < num_rows) x0 = unit(row, u0);
    if (row + stride < num_rows) x1 = unit(row + stride, u0);
  }
  for (; row < num_rows; row += stride) {  // a row's lanes run it together
    const size_t base = static_cast<size_t>(row) * capacity;
    if (kMode == MCQ_OE_VEC_DEEP) {
      if (u0 < 2 * v) {
        c4[u0] = x0;
        x0 = x1;
        if (row + 2 * stride < num_rows) x1 = unit(row + 2 * stride, u0);
      }
    } else if (kMode == MCQ_OE_VEC_STAGED) {
      if (u0 < 2 * v) c4[u0] = x0;
      if (u1 < 2 * v) c4[u1] = x1;
      if (row + stride < num_rows) fetch(row + stride);
    } else if (kMode == MCQ_OE_INT_STAGED) {
      if (u0 < capacity) {
        c[u0] = e0;
        o[u0] = e1;
      }
      if (u1 < capacity) {
        c[u1] = e2;
        o[u1] = e3;
      }
    } else if (kMode == MCQ_OE_VEC_LOOP) {
      for (int u = sub; u < 2 * v; u += lanes) c4[u] = unit(row, u);
    } else {
      for (int j = sub; j < capacity; j += lanes) {
        const int32_t x = cnt[base + j], y = order[base + j];
        c[j] = x;
        o[j] = y;
      }
    }
    if (kMode == MCQ_OE_INT_STAGED) {
      if (row + stride < num_rows) fetch(row + stride);
    }
    __syncwarp(mask);
    bool swapped = false;
    if (kPairs) {
      // a lane holds positions j0, j1 of the row in registers: (count,
      // slot) pairs gathered from shared memory once; the even half-pass
      // swaps within a lane, the odd one across two neighbours (shuffles
      // within the row's lanes)
      const int j0 = 2 * sub, j1 = j0 + 1;
      int32_t oa = 0, ob = 0, ca = 0, cb = 0;
      if (j0 < capacity) {
        oa = o[j0];
        ca = c[oa];
      }
      if (j1 < capacity) {
        ob = o[j1];
        cb = c[ob];
      }
      for (int pass = 0; pass < passes; ++pass) {
        if (j1 < capacity && ca < cb) {
          const int32_t t = ca, s = oa;
          ca = cb;
          oa = ob;
          cb = t;
          ob = s;
          swapped = true;
        }
        const int32_t nc = __shfl_down_sync(mask, ca, 1, lanes);
        const int32_t no = __shfl_down_sync(mask, oa, 1, lanes);
        const bool swap = j0 + 2 < capacity && cb < nc;
        const int32_t pc = __shfl_up_sync(mask, cb, 1, lanes);
        const int32_t po = __shfl_up_sync(mask, ob, 1, lanes);
        const bool took = __shfl_up_sync(mask, swap ? 1 : 0, 1, lanes) != 0;
        if (swap) {
          cb = nc;
          ob = no;
          swapped = true;
        }
        if (sub > 0 && took) {
          ca = pc;
          oa = po;
        }
      }
      const bool changed = (__ballot_sync(mask, swapped) & mask) != 0;
      if (changed || order_out != order) {
        if (kMode == MCQ_OE_VEC_DEEP && j1 < capacity) {
          *reinterpret_cast<int2*>(order_out + base + j0) = make_int2(oa, ob);
        } else {
          if (j0 < capacity) order_out[base + j0] = oa;
          if (j1 < capacity) order_out[base + j1] = ob;
        }
        if (changed && dirty != nullptr && sub == 0) dirty[row] = 1;
      }
    } else {
      for (int pass = 0; pass < passes; ++pass) {
        for (int start = 0; start < 2; ++start) {
          for (int left = start + 2 * sub; left + 1 < capacity;
               left += 2 * lanes) {
            const int32_t ol = o[left], orr = o[left + 1];
            if (c[ol] < c[orr]) {
              o[left] = orr;
              o[left + 1] = ol;
              swapped = true;
            }
          }
          __syncwarp(mask);
        }
      }
      const bool changed = (__ballot_sync(mask, swapped) & mask) != 0;
      if (changed || order_out != order) {
        if (kMode == MCQ_OE_VEC_STAGED || kMode == MCQ_OE_VEC_LOOP) {
          for (int u = sub; u < v; u += lanes)
            *reinterpret_cast<int4*>(order_out + base + 4 * u) = c4[v + u];
        } else {
          for (int j = sub; j < capacity; j += lanes)
            order_out[base + j] = o[j];
        }
        if (changed && dirty != nullptr && sub == 0) dirty[row] = 1;
      }
    }
    __syncwarp(mask);  // the row's shared memory is rewritten next
  }
}

// Lanes a row takes: next_pow2(ceil(C / 2)), at most a warp.
static int mcq_oe_lanes(int capacity) {
  const int half = (capacity + 1) / 2;
  int lanes = 1;
  while (lanes < half && lanes < MCQ_WARP) lanes <<= 1;
  return lanes;
}

static bool mcq_oe_aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

extern "C" int mcq_oddeven(const void* cnt, const void* order,
                           void* order_out, void* dirty, long long num_rows,
                           int capacity, int passes, void* stream) {
  if (num_rows <= 0 || capacity <= 0) return 0;
  const int lanes = mcq_oe_lanes(capacity);
  const int per_warp = MCQ_WARP / lanes;
  const size_t row_bytes = static_cast<size_t>(2) * capacity * sizeof(int32_t);
  long long warps = MCQ_OE_SMEM_MAX / (row_bytes * per_warp);
  if (warps > MCQ_OE_WARPS) warps = MCQ_OE_WARPS;
  const long long need_warps =
      (num_rows + per_warp - 1) / per_warp;  // no idle warps on small tables
  if (warps > need_warps) warps = need_warps;
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(warps) * per_warp * row_bytes;
  const bool vec = capacity % 4 == 0 && mcq_oe_aligned(cnt) &&
                   mcq_oe_aligned(order) && mcq_oe_aligned(order_out);
  // a lane's share of a row: one vector (C <= 2 lanes), two (<= 4 lanes),
  // or more, loaded in a loop
  auto kernel =
      vec ? (capacity <= 2 * lanes   ? mcq_oddeven_kernel<MCQ_OE_VEC_DEEP>
             : capacity <= 4 * lanes ? mcq_oddeven_kernel<MCQ_OE_VEC_STAGED>
                                     : mcq_oddeven_kernel<MCQ_OE_VEC_LOOP>)
          : (capacity <= 2 * lanes ? mcq_oddeven_kernel<MCQ_OE_INT_STAGED>
                                   : mcq_oddeven_kernel<MCQ_OE_INT_LOOP>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // every block resident at once: a block queued behind the others would
  // walk its rows alone at the end
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, static_cast<int>(warps * MCQ_WARP), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long rows_per_block = warps * per_warp;
  long long blocks = (num_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > static_cast<long long>(sms) * per_sm)
    blocks = static_cast<long long>(sms) * per_sm;
  kernel<<<static_cast<unsigned>(blocks),
           static_cast<unsigned>(warps * MCQ_WARP), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cnt), static_cast<const int32_t*>(order),
      static_cast<int32_t*>(order_out), static_cast<uint8_t*>(dirty), num_rows,
      capacity, passes, lanes);
  return mcq_launch_status();
}
