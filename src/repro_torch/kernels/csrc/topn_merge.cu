// Cross-shard top-n merge: the k-way head-pointer merge of S per-shard top
// lists into one list of n, in rounds of one warp per group of 32 lists.
//
// probs float32 [L, M], row-major: L lists.  Block b merges lists
// [32 b, 32 b + 32).  It first stages the prefix of each of its lists'
// probabilities that the merge can reach (a pointer moves at most n times,
// and past M it reads 0) into shared memory, so the dependent steps read
// shared memory and not DRAM.  Then warp 0 alone merges: lane s holds list
// 32 b + s's pointer and head; each step is a butterfly shuffle reduction
// over (valid desc, NaN first, prob desc, lane asc) — a strict total order,
// so every lane ends with the same winner — after which the winning lane
// records the step (its head as read and the head's position, -1 past the
// end of its list), advances its pointer whatever its head held, and reads
// its next head.  No step waits on a load from DRAM: the steps are recorded
// in shared memory, MCQ_TOPN_ROUND at a time, and the whole block then
// writes them out in parallel.
//
// A round that is not the last (emit = 0) writes each group's n steps raw:
// the head as read (NaN, zero and negative heads too) and its position in
// the original [S, M] lists (pos_in maps a position of this round's lists
// to it; null in the first round).  Those G = ceil(L / 32) lists of n are
// the next round's lists.  The last round (emit = 1, one block, L <= 32)
// turns a head that is not > 0 into EMPTY / EMPTY / 0.0 and gathers the
// others' srcs and dsts.  A group's steps are the steps the flat merge takes
// on that group's lists, in order (a flat step's winner is the maximum of
// its group too, and only the winner's pointer moves), and the flat merge
// takes, at each step, the first maximum of those groups' next steps under
// the same order, the lowest group on ties (groups are consecutive lists).
// So the rounds give the reference's lax.scan steps on any input,
// descending or not (jnp.argmax: NaN above every number, the first
// occurrence on ties, -0.0 equal to 0.0), for any S.
#include "common.cuh"

#define MCQ_TOPN_THREADS 256
#define MCQ_TOPN_ROUND 1024           // steps recorded between two write-outs
#define MCQ_TOPN_SMEM_FLOATS 9216     // 36 KiB of staged heads (dynamic)

__device__ __forceinline__ bool mcq_topn_better(bool va, bool na, float a,
                                                int ia, bool vb, bool nb,
                                                float b, int ib) {
  if (va != vb) return va;
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

__global__ void mcq_topn_merge_kernel(
    const float* __restrict__ probs, const long long* __restrict__ pos_in,
    const int32_t* __restrict__ dsts, const int32_t* __restrict__ srcs,
    int num_lists, int m, int n, int staged, int emit,
    int32_t* __restrict__ out_src, int32_t* __restrict__ out_dst,
    float* __restrict__ out_p, long long* __restrict__ out_pos) {
  extern __shared__ float tile[];  // [lists of this block, staged]
  __shared__ long long win_at[MCQ_TOPN_ROUND];  // position, -1 past the end
  __shared__ float win_p[MCQ_TOPN_ROUND];
  const int first = blockIdx.x * MCQ_WARP;
  const int lists = min(MCQ_WARP, num_lists - first);
  for (int i = threadIdx.x; i < lists * staged; i += blockDim.x) {
    const int s = i / staged;
    tile[i] = probs[static_cast<size_t>(first + s) * m + (i - s * staged)];
  }
  __syncthreads();
  const int lane = threadIdx.x;
  const bool valid = lane < lists;
  const long long row = static_cast<long long>(first + lane) * m;
  int ptr = 0;
  float head = 0.0f;
  if (valid) head = tile[lane * staged];
  const size_t out0 = static_cast<size_t>(blockIdx.x) * n;
  for (int base = 0; base < n; base += MCQ_TOPN_ROUND) {
    const int steps = min(MCQ_TOPN_ROUND, n - base);
    if (threadIdx.x < MCQ_WARP) {
      for (int step = 0; step < steps; ++step) {
        bool bv = valid, bn = isnan(head);
        float bp = head;
        int bl = lane;
        for (int off = MCQ_WARP / 2; off > 0; off >>= 1) {
          const bool ov =
              __shfl_xor_sync(MCQ_FULL_MASK, static_cast<int>(bv), off);
          const bool on =
              __shfl_xor_sync(MCQ_FULL_MASK, static_cast<int>(bn), off);
          const float op = __shfl_xor_sync(MCQ_FULL_MASK, bp, off);
          const int ol = __shfl_xor_sync(MCQ_FULL_MASK, bl, off);
          if (mcq_topn_better(ov, on, op, ol, bv, bn, bp, bl)) {
            bv = ov;
            bn = on;
            bp = op;
            bl = ol;
          }
        }
        if (lane == bl) {  // the winner
          win_at[step] = ptr < m ? row + ptr : -1;
          win_p[step] = head;
          ++ptr;
          head = ptr >= m ? 0.0f : ptr < staged ? tile[lane * staged + ptr]
                                                : probs[row + ptr];
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < steps; i += blockDim.x) {
      const long long local = win_at[i];
      const long long at =
          local < 0 ? -1 : pos_in != nullptr ? pos_in[local] : local;
      const float p = win_p[i];
      if (emit) {
        const bool live = p > 0.0f;  // ptr < m and at >= 0 whenever p > 0
        out_src[base + i] = live ? srcs[at] : MCQ_EMPTY;
        out_dst[base + i] = live ? dsts[at] : MCQ_EMPTY;
        out_p[base + i] = live ? p : 0.0f;
      } else {
        out_p[out0 + base + i] = p;
        out_pos[out0 + base + i] = at;
      }
    }
    __syncthreads();
  }
}

// One round: emit = 1 is the last (num_lists <= 32, one block, writes
// out_src / out_dst / out_p [n]); emit = 0 writes out_p float32 and out_pos
// int64 [ceil(num_lists / 32), n].
extern "C" int mcq_topn_merge(const void* probs, const void* pos_in,
                              const void* dsts, const void* srcs,
                              int num_lists, int m, int n, int emit,
                              void* out_src, void* out_dst, void* out_p,
                              void* out_pos, void* stream) {
  if (n <= 0) return 0;
  if (num_lists < 1 || m < 1 || (emit && num_lists > MCQ_WARP)) return -1;
  const int groups = (num_lists + MCQ_WARP - 1) / MCQ_WARP;
  const int widest = num_lists < MCQ_WARP ? num_lists : MCQ_WARP;
  int staged = m < n ? m : n;
  if (staged > MCQ_TOPN_SMEM_FLOATS / widest)
    staged = MCQ_TOPN_SMEM_FLOATS / widest;
  const size_t smem = sizeof(float) * static_cast<size_t>(widest) * staged;
  mcq_topn_merge_kernel<<<groups, MCQ_TOPN_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(probs), static_cast<const long long*>(pos_in),
      static_cast<const int32_t*>(dsts), static_cast<const int32_t*>(srcs),
      num_lists, m, n, staged, emit, static_cast<int32_t*>(out_src),
      static_cast<int32_t*>(out_dst), static_cast<float*>(out_p),
      static_cast<long long*>(out_pos));
  return mcq_launch_status();
}
