// TERNARY frontier scorer for Hopper (sm_90a): for each query b, the ternary
// dot of the query's sign planes with each of the R neighbor planes cached in
// node cur[b]'s row,
//   pop(q+ & v+) - pop(q+ & v-) - pop(q- & v+) + pop(q- & v-).
//
// Replaces the TPU kernels
//   duckdb_lm_diskann_tpu/experiments/pallas_kernels.py::ternary_frontier_scores
//     (_ternary_score_kernel, one BlockSpec-pipelined row DMA per grid step) and
//   ...::ternary_frontier_scores_deep
//     (_ternary_deep_kernel, the same contract with K row DMAs in flight).
// Both compute the same function; on Hopper the rows in flight come from
// many resident blocks, so one kernel serves both.
//
// Contract (same as the Pallas kernels; int32 words carry the u32 bits):
//   cur      i32[B]         node slot per query (clamped into [0, C))
//   q_pos    i32[B, W]      query planes, W = 2*ceil(D/64) words
//   q_neg    i32[B, W]
//   edge_pos i32[C, R, W]   cached neighbor planes (zero for an empty slot)
//   edge_neg i32[C, R, W]
//   out      i32[B, R]      the integer score; similarity -> distance stays
//                           outside the kernel, as in the JAX package
// Integer sums: the result equals the plain version's exactly.
//
// What bounds it: per hop it gathers B*R*W*4*2 bytes of planes, 15.7 MB at
// B=1024, R=64, W=30 (D=960): ~4.7 us at the H100's 3.35 TB/s. The integer
// work (4 AND + 4 POPC + 4 adds per word) is far below the issue rate, so
// the kernel is bound by bytes and by row-gather latency. The design keeps
// many rows in flight (one block per query, B blocks of 256 threads) and
// reads each row with consecutive lanes on consecutive words.
//
// Design: one block per query row, 256 threads. The block reads cur[b]
// itself and stages the two query planes in shared memory. A warp splits
// into 32/G groups of G lanes, G the power of two >= min(W, 32): a group
// scores one neighbor row (lane j of the group takes words j, j+G, ...), so
// at W=30 one row per warp, at W=4 eight rows per warp, and a warp's reads
// stay contiguous. The group reduces with __shfl_xor_sync over offsets < G,
// which never mixes two rows' words; lanes past W add 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
ternary_frontier_kernel(const int32_t* __restrict__ cur,
                        const uint32_t* __restrict__ q_pos,
                        const uint32_t* __restrict__ q_neg,
                        const uint32_t* __restrict__ edge_pos,
                        const uint32_t* __restrict__ edge_neg,
                        int32_t* __restrict__ out,
                        int C, int R, int W) {
  extern __shared__ uint32_t q_sm[];  // [2 * W]: pos plane, then neg plane
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < W; i += kThreads) {
    q_sm[i] = q_pos[(size_t)b * W + i];
    q_sm[W + i] = q_neg[(size_t)b * W + i];
  }
  __syncthreads();

  int node = cur[b];
  node = node < 0 ? 0 : (node >= C ? C - 1 : node);
  const size_t row0 = (size_t)node * R * W;
  const uint32_t* ep = edge_pos + row0;
  const uint32_t* en = edge_neg + row0;

  int G = 1;
  while (G < W && G < 32) G <<= 1;
  const int rows_per_warp = 32 / G;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane / G;  // row within the warp's step
  const int j = lane % G;  // first word of this lane

  // The loop bound is uniform across a warp, so every lane reaches the
  // shuffles below.
  for (int r0 = warp * rows_per_warp; r0 < R; r0 += kWarps * rows_per_warp) {
    const int r = r0 + g;
    int acc = 0;
    if (r < R) {
      const uint32_t* vp = ep + (size_t)r * W;
      const uint32_t* vn = en + (size_t)r * W;
      for (int w = j; w < W; w += G) {
        const uint32_t qp = q_sm[w];
        const uint32_t qn = q_sm[W + w];
        const uint32_t p = vp[w];
        const uint32_t n = vn[w];
        acc += (__popc(qp & p) - __popc(qp & n)) -
               (__popc(qn & p) - __popc(qn & n));
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (r < R && j == 0) out[(size_t)b * R + r] = acc;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns cudaGetLastError().
extern "C" int lmd_ternary_frontier_scores(const int32_t* cur,
                                           const int32_t* q_pos,
                                           const int32_t* q_neg,
                                           const int32_t* edge_pos,
                                           const int32_t* edge_neg,
                                           int32_t* out, int B, int C, int R,
                                           int W, void* stream) {
  if (B == 0) return 0;
  const size_t smem = (size_t)2 * W * sizeof(uint32_t);
  ternary_frontier_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cur, reinterpret_cast<const uint32_t*>(q_pos),
      reinterpret_cast<const uint32_t*>(q_neg),
      reinterpret_cast<const uint32_t*>(edge_pos),
      reinterpret_cast<const uint32_t*>(edge_neg), out, C, R, W);
  return (int)cudaGetLastError();
}
