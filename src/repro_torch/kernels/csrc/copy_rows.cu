// Catch a back buffer up with its front: the copy of read-copy-update, made
// a copy of what changed instead of a copy of the state.
//
// The learner keeps two states, the published front and a private back that
// differs from it only where the last write flagged: dirty (uint8 per slab
// row: the rows whose cnt, dst, order, tot or row hash it changed) and
// table_dirty (uint8 per group of `group` src-table slots, 32 or the whole
// smaller table: the slots the new-edge pass wrote, the one writer of the
// table).  For each flagged row the row's cnt, dst and order, its tot and
// its row hash (dh_keys/dh_vals[N, H], when given: the per-row dst hash of
// paper §II.2) are copied from front to back; for each flagged group its
// keys and vals; then the state's scalars (ten per shard of a stacked state,
// any number); the flags are cleared.  No table is copied whole.
//
// Rows in balanced blocks: a block reads the flags of MCQ_CU_ITEMS rows
// (coalesced, two a thread), clears them, and compacts the flagged ones into
// a list in shared memory with a ballot and a popc prefix; its warps then
// share that list, so new rows -- which take consecutive rows and cluster --
// spread over the block's 16 warps instead of falling to one warp.  A row
// takes `lanes` lanes (next_pow2 of its vectors, at most 32: 16 at C = 64),
// lanes move 16-byte vectors (C % 4 == 0 and the tensors 16-byte aligned;
// int32 otherwise), and each group of lanes holds two rows in flight: both
// rows' cnt, dst and order loads (and tot's) are issued before their stores.
// The blocks after the row blocks do the same over the table flags, a
// group's slots a lane each, two groups in flight a warp; the last block
// copies the scalars.
//
// Bound on this card: bytes -- the row and table flags read once, each
// flagged row (and group) read and written once.  Front and back are
// distinct tensors (the wrapper checks), so every pointer is __restrict__.
#include "common.cuh"

#define MCQ_CU_THREADS 512  // 16 warps
#define MCQ_CU_ITEMS 1024   // rows (or table groups) whose flags a block reads
#define MCQ_CU_WARPS (MCQ_CU_THREADS / MCQ_WARP)

// The arguments, bound once by the learner (kernels/copy_rows.py builds the
// same struct with ctypes): front, back, the flags, the sizes.
struct McqCatchUp {
  const int32_t* f_cnt;
  const int32_t* f_dst;
  const int32_t* f_order;
  const int32_t* f_tot;
  const int32_t* f_keys;
  const int32_t* f_vals;
  const int32_t* f_scalars;
  const int32_t* f_dhk;  // null without row hashes
  const int32_t* f_dhv;
  int32_t* b_cnt;
  int32_t* b_dst;
  int32_t* b_order;
  int32_t* b_tot;
  int32_t* b_keys;
  int32_t* b_vals;
  int32_t* b_scalars;
  int32_t* b_dhk;
  int32_t* b_dhv;
  uint8_t* dirty;        // [num_rows]
  uint8_t* table_dirty;  // [table_size / group]
  long long num_rows;
  long long table_size;  // src-table slots (S * T of a stacked state)
  int capacity;          // C
  int dh_size;           // H, 0 without row hashes
  int n_scalars;
  int group;             // table slots a table flag stands for, 1..32
  int device;            // the CUDA device of every tensor
  int pad_;
};

// Reads the flags of items [first, first + count) (count <= MCQ_CU_ITEMS),
// clears the set ones and lists their offsets from `first` in `list`;
// returns how many (the same in every thread).
__device__ __forceinline__ int mcq_cu_compact(uint8_t* __restrict__ flags,
                                              long long first, int count,
                                              int* list, int* n_list) {
  const int tid = threadIdx.x, lane = tid & (MCQ_WARP - 1);
  if (tid == 0) *n_list = 0;
  uint8_t f[MCQ_CU_ITEMS / MCQ_CU_THREADS];
#pragma unroll
  for (int k = 0; k < MCQ_CU_ITEMS / MCQ_CU_THREADS; ++k) {
    const int at = tid + k * MCQ_CU_THREADS;
    f[k] = at < count ? flags[first + at] : 0;
  }
  __syncthreads();  // n_list zeroed
#pragma unroll
  for (int k = 0; k < MCQ_CU_ITEMS / MCQ_CU_THREADS; ++k) {
    const bool set = f[k] != 0;
    const unsigned ballot = __ballot_sync(MCQ_FULL_MASK, set);
    if (ballot == 0) continue;
    int at = 0;
    if (lane == 0) at = atomicAdd(n_list, __popc(ballot));
    at = __shfl_sync(MCQ_FULL_MASK, at, 0);
    if (set) {
      const int item = tid + k * MCQ_CU_THREADS;
      list[at + __popc(ballot & ((1u << lane) - 1u))] = item;
      flags[first + item] = 0;
    }
  }
  __syncthreads();
  return *n_list;
}

template <typename V>
__device__ __forceinline__ V mcq_cu_load(const int32_t* p, long long at) {
  return __ldg(reinterpret_cast<const V*>(p) + at);
}

template <typename V>
__device__ __forceinline__ void mcq_cu_store(int32_t* p, long long at, V x) {
  reinterpret_cast<V*>(p)[at] = x;
}

// The listed rows, two in flight per group of `lanes` lanes.  VC moves the
// slab rows, VH the row hashes (int4 or int32 each).
template <typename VC, typename VH>
__device__ void mcq_cu_rows(const McqCatchUp& a, long long first,
                            const int* list, int n, int lanes) {
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  const int warp = threadIdx.x / MCQ_WARP;
  const int groups = MCQ_WARP / lanes;  // rows a warp takes side by side
  const int g = lane / lanes, sub = lane % lanes;
  const int vc = a.capacity * 4 / static_cast<int>(sizeof(VC));
  const int vh = a.dh_size * 4 / static_cast<int>(sizeof(VH));
  for (int k = warp * 2 * groups; k < n; k += MCQ_CU_WARPS * 2 * groups) {
    const int e0 = k + g, e1 = k + groups + g;
    if (e0 >= n) break;  // e1 > e0: nothing left for this group
    const bool two = e1 < n;
    const long long r0 = first + list[e0];
    const long long r1 = two ? first + list[e1] : r0;
    int32_t t0 = 0, t1 = 0;
    if (sub == 0) {
      t0 = __ldg(a.f_tot + r0);
      if (two) t1 = __ldg(a.f_tot + r1);
    }
    for (int j = sub; j < vc; j += lanes) {
      const long long i0 = r0 * vc + j, i1 = r1 * vc + j;
      const VC c0 = mcq_cu_load<VC>(a.f_cnt, i0);
      const VC d0 = mcq_cu_load<VC>(a.f_dst, i0);
      const VC o0 = mcq_cu_load<VC>(a.f_order, i0);
      VC c1 = c0, d1 = d0, o1 = o0;
      if (two) {
        c1 = mcq_cu_load<VC>(a.f_cnt, i1);
        d1 = mcq_cu_load<VC>(a.f_dst, i1);
        o1 = mcq_cu_load<VC>(a.f_order, i1);
      }
      mcq_cu_store<VC>(a.b_cnt, i0, c0);
      mcq_cu_store<VC>(a.b_dst, i0, d0);
      mcq_cu_store<VC>(a.b_order, i0, o0);
      if (two) {
        mcq_cu_store<VC>(a.b_cnt, i1, c1);
        mcq_cu_store<VC>(a.b_dst, i1, d1);
        mcq_cu_store<VC>(a.b_order, i1, o1);
      }
    }
    if (sub == 0) {
      a.b_tot[r0] = t0;
      if (two) a.b_tot[r1] = t1;
    }
    if (a.f_dhk != nullptr) {
      for (int j = sub; j < vh; j += lanes) {
        const long long i0 = r0 * vh + j, i1 = r1 * vh + j;
        const VH k0 = mcq_cu_load<VH>(a.f_dhk, i0);
        const VH v0 = mcq_cu_load<VH>(a.f_dhv, i0);
        VH k1 = k0, v1 = v0;
        if (two) {
          k1 = mcq_cu_load<VH>(a.f_dhk, i1);
          v1 = mcq_cu_load<VH>(a.f_dhv, i1);
        }
        mcq_cu_store<VH>(a.b_dhk, i0, k0);
        mcq_cu_store<VH>(a.b_dhv, i0, v0);
        if (two) {
          mcq_cu_store<VH>(a.b_dhk, i1, k1);
          mcq_cu_store<VH>(a.b_dhv, i1, v1);
        }
      }
    }
  }
}

// The listed table groups: a slot a lane, two groups in flight a warp.
__device__ void mcq_cu_groups(const McqCatchUp& a, long long first,
                              const int* list, int n) {
  const int lane = threadIdx.x & (MCQ_WARP - 1);
  const int warp = threadIdx.x / MCQ_WARP;
  if (lane >= a.group) return;
  for (int k = warp * 2; k < n; k += MCQ_CU_WARPS * 2) {
    const bool two = k + 1 < n;
    const long long s0 = (first + list[k]) * a.group + lane;
    const long long s1 = two ? (first + list[k + 1]) * a.group + lane : s0;
    const int32_t k0 = __ldg(a.f_keys + s0), v0 = __ldg(a.f_vals + s0);
    const int32_t k1 = __ldg(a.f_keys + s1), v1 = __ldg(a.f_vals + s1);
    a.b_keys[s0] = k0;
    a.b_vals[s0] = v0;
    if (two) {
      a.b_keys[s1] = k1;
      a.b_vals[s1] = v1;
    }
  }
}

template <typename VC, typename VH>
__global__ void __launch_bounds__(MCQ_CU_THREADS)
    mcq_catch_up_kernel(const McqCatchUp a, long long row_blocks,
                        long long table_blocks, int lanes) {
  __shared__ int list[MCQ_CU_ITEMS];
  __shared__ int n_list;
  const long long b = blockIdx.x;
  if (b < row_blocks) {
    const long long first = b * MCQ_CU_ITEMS;
    const long long left = a.num_rows - first;
    const int count = left < MCQ_CU_ITEMS ? static_cast<int>(left)
                                          : MCQ_CU_ITEMS;
    const int n = mcq_cu_compact(a.dirty, first, count, list, &n_list);
    if (n > 0) mcq_cu_rows<VC, VH>(a, first, list, n, lanes);
  } else if (b < row_blocks + table_blocks) {
    const long long first = (b - row_blocks) * MCQ_CU_ITEMS;
    const long long left = a.table_size / a.group - first;
    const int count = left < MCQ_CU_ITEMS ? static_cast<int>(left)
                                          : MCQ_CU_ITEMS;
    const int n = mcq_cu_compact(a.table_dirty, first, count, list, &n_list);
    if (n > 0) mcq_cu_groups(a, first, list, n);
  } else {
    for (int i = threadIdx.x; i < a.n_scalars; i += MCQ_CU_THREADS)
      a.b_scalars[i] = __ldg(a.f_scalars + i);
  }
}

static bool mcq_cu_aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename VC, typename VH>
static void mcq_cu_launch(const McqCatchUp& a, long long row_blocks,
                          long long table_blocks, cudaStream_t stream) {
  const int vc = a.capacity * 4 / static_cast<int>(sizeof(VC));
  int lanes = 1;
  while (lanes < vc && lanes < MCQ_WARP) lanes <<= 1;
  mcq_catch_up_kernel<VC, VH>
      <<<static_cast<unsigned>(row_blocks + table_blocks + 1), MCQ_CU_THREADS,
         0, stream>>>(a, row_blocks, table_blocks, lanes);
}

// One launch: the flagged rows, the flagged table groups, the scalars.
extern "C" int mcq_copy_dirty_rows(const McqCatchUp* args, void* stream) {
  const McqCatchUp& a = *args;
  if (a.num_rows < 0 || a.capacity <= 0 || a.table_size < 0 ||
      a.n_scalars < 0 || a.group < 1 || a.group > MCQ_WARP ||
      a.table_size % a.group != 0 || (a.f_dhk != nullptr && a.dh_size <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != a.device && (err = cudaSetDevice(a.device)) != cudaSuccess)
    return static_cast<int>(err);
  const long long row_blocks = (a.num_rows + MCQ_CU_ITEMS - 1) / MCQ_CU_ITEMS;
  const long long table_blocks =
      (a.table_size / a.group + MCQ_CU_ITEMS - 1) / MCQ_CU_ITEMS;
  const bool vc = a.capacity % 4 == 0 && mcq_cu_aligned(a.f_cnt) &&
                  mcq_cu_aligned(a.f_dst) && mcq_cu_aligned(a.f_order) &&
                  mcq_cu_aligned(a.b_cnt) && mcq_cu_aligned(a.b_dst) &&
                  mcq_cu_aligned(a.b_order);
  const bool vh = a.f_dhk != nullptr && a.dh_size % 4 == 0 &&
                  mcq_cu_aligned(a.f_dhk) && mcq_cu_aligned(a.f_dhv) &&
                  mcq_cu_aligned(a.b_dhk) && mcq_cu_aligned(a.b_dhv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vc && vh)
    mcq_cu_launch<int4, int4>(a, row_blocks, table_blocks, st);
  else if (vc)
    mcq_cu_launch<int4, int32_t>(a, row_blocks, table_blocks, st);
  else if (vh)
    mcq_cu_launch<int32_t, int4>(a, row_blocks, table_blocks, st);
  else
    mcq_cu_launch<int32_t, int32_t>(a, row_blocks, table_blocks, st);
  const int status = mcq_launch_status();
  if (current != a.device) cudaSetDevice(current);
  return status;
}
