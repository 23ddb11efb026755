// Cross-shard top-n merge: the k-way head-pointer merge of S per-shard top
// lists into one list of n, in one block.
//
// probs float32 / dsts / srcs int32 [S, M], row-major.  The block first
// stages the prefix of every list's probabilities that the merge can reach
// (a pointer moves at most n times, and past M it reads 0) into shared
// memory, so the dependent steps read shared memory and not DRAM.  Then
// warp 0 alone merges: lane s (s < S) holds shard s's pointer and head;
// each step is a butterfly shuffle reduction over (valid desc, NaN first,
// prob desc, lane asc) — a strict total order, so every lane ends with the
// same winner — after which the winning lane records the step (the flat
// position of its head if the head is > 0, else -1, and the probability
// or 0.0), advances its pointer whatever its head held, and reads its next
// head.  No step waits on a load from DRAM: the steps are recorded in
// shared memory, MCQ_TOPN_ROUND at a time, and the whole block then writes
// those outputs, gathering their srcs and dsts in parallel.  These are the
// steps of the reference's lax.scan on any input, descending or not
// (jnp.argmax: NaN above every number, the first occurrence on ties, -0.0
// equal to 0.0).  S <= 32.
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

__global__ void mcq_topn_merge_kernel(const float* __restrict__ probs,
                                      const int32_t* __restrict__ dsts,
                                      const int32_t* __restrict__ srcs,
                                      int num_lists, int m, int n, int staged,
                                      int32_t* __restrict__ out_src,
                                      int32_t* __restrict__ out_dst,
                                      float* __restrict__ out_p) {
  extern __shared__ float tile[];  // [num_lists, staged]
  __shared__ long long win_at[MCQ_TOPN_ROUND];  // flat position, -1 = dead
  __shared__ float win_p[MCQ_TOPN_ROUND];
  for (int i = threadIdx.x; i < num_lists * staged; i += blockDim.x) {
    const int s = i / staged;
    tile[i] = probs[static_cast<size_t>(s) * m + (i - s * staged)];
  }
  __syncthreads();
  const int lane = threadIdx.x;
  const bool valid = lane < num_lists;
  const long long row = static_cast<long long>(lane) * m;
  int ptr = 0;
  float head = 0.0f;
  if (valid) head = tile[lane * staged];
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
        if (lane == bl) {  // the winner; ptr < m whenever its head is > 0
          const bool live = head > 0.0f;
          win_at[step] = live ? row + ptr : -1;
          win_p[step] = live ? head : 0.0f;
          ++ptr;
          head = ptr >= m ? 0.0f : ptr < staged ? tile[lane * staged + ptr]
                                                : probs[row + ptr];
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < steps; i += blockDim.x) {
      const long long at = win_at[i];
      out_src[base + i] = at >= 0 ? srcs[at] : MCQ_EMPTY;
      out_dst[base + i] = at >= 0 ? dsts[at] : MCQ_EMPTY;
      out_p[base + i] = win_p[i];
    }
    __syncthreads();
  }
}

extern "C" int mcq_topn_merge(const void* probs, const void* dsts,
                              const void* srcs, int num_lists, int m, int n,
                              void* out_src, void* out_dst, void* out_p,
                              void* stream) {
  if (n <= 0) return 0;
  if (num_lists < 1 || num_lists > MCQ_WARP || m < 1) return -1;
  int staged = m < n ? m : n;
  if (staged > MCQ_TOPN_SMEM_FLOATS / num_lists)
    staged = MCQ_TOPN_SMEM_FLOATS / num_lists;
  const size_t smem = sizeof(float) * static_cast<size_t>(num_lists) * staged;
  mcq_topn_merge_kernel<<<1, MCQ_TOPN_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(probs), static_cast<const int32_t*>(dsts),
      static_cast<const int32_t*>(srcs), num_lists, m, n, staged,
      static_cast<int32_t*>(out_src), static_cast<int32_t*>(out_dst),
      static_cast<float*>(out_p));
  return mcq_launch_status();
}
