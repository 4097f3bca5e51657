// INT4 frontier scorer for Hopper (sm_90a): for each query b, the distance
// from queries[b] to each of the R dequantized INT4 neighbor codes cached in
// node cur[b]'s row.
//
// Replaces the TPU kernels
//   duckdb_lm_diskann_tpu/experiments/pallas_kernels.py::int4_frontier_scores
//     (_int4_score_kernel, one BlockSpec-pipelined row DMA per grid step) and
//   ...::int4_frontier_scores_deep
//     (_int4_deep_kernel, the same contract with K row DMAs in flight).
// Both compute the same function; on Hopper the rows in flight come from
// many resident blocks, so one kernel serves both.
//
// Contract (same as the Pallas kernels):
//   cur     i32[B]          node slot per query (clamped into [0, C))
//   queries f32[B, D]
//   codes   i32[C, R, DW]   planar INT4 words, DW = ceil(D/8): nibble slot s
//                           of word w holds dim s*DW + w, two's complement
//   scale   f32[C, R]       per-edge scale (0 for an empty edge slot)
//   out     f32[B, R]       L2: sqrt(max(sum (q-v)^2, 0)); IP: -dot;
//                           COSINE: 1 - clamp(cos, -1, 1), 1.0 on a zero norm
// Nibbles of dims >= D are ignored, so any D works whatever the pad bits.
//
// What bounds it: per hop it gathers B*R*(4*DW + 4) bytes of codes and
// scales, about 4.4 MB at B=1024, R=64, D=128. At the H100's 3.35 TB/s that
// is ~1.3 us of bandwidth, so a hop is bound by row-gather latency and
// launch cost, not by bytes. The design hides row latency with many resident
// blocks (one per query, B=1024 blocks of 256 threads); deeper staging
// (cp.async / TMA rings) is later work.
//
// Design: one block per query row, 256 threads. The block reads cur[b]
// itself and stages the (zero-padded) query in shared memory. One warp per
// edge row (8 warps stride over R): lane j reads words j, j+32, ... of the
// row (coalesced, 4*DW bytes), unpacks 8 nibbles per word, accumulates in
// f32, and the warp reduces with __shfl_xor_sync; lane 0 applies the metric
// epilogue of _metric_distance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kL2 = 0;
constexpr int kIP = 1;
constexpr int kCosine = 2;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int METRIC>
__global__ void __launch_bounds__(kThreads)
int4_frontier_kernel(const int32_t* __restrict__ cur,
                     const float* __restrict__ queries,
                     const int32_t* __restrict__ codes,
                     const float* __restrict__ scale,
                     float* __restrict__ out,
                     int D, int C, int R, int DW) {
  extern __shared__ float q_sm[];  // [8 * DW], dim-major like the words
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int DP = 8 * DW;
  const float* q = queries + (size_t)b * D;
  for (int i = tid; i < DP; i += kThreads) q_sm[i] = (i < D) ? q[i] : 0.0f;
  __syncthreads();

  int node = cur[b];
  node = node < 0 ? 0 : (node >= C ? C - 1 : node);
  const int32_t* rows = codes + (size_t)node * R * DW;
  const float* srow = scale + (size_t)node * R;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  float q_sq = 0.0f;
  if (METRIC == kCosine) {
    for (int i = lane; i < DP; i += 32) q_sq += q_sm[i] * q_sm[i];
    q_sq = warp_sum(q_sq);
  }

  for (int r = warp; r < R; r += kThreads / 32) {
    const float s = srow[r];
    const int32_t* row = rows + (size_t)r * DW;
    float acc = 0.0f;    // L2: sum (q-v)^2; IP/COSINE: sum q*v
    float v_sq = 0.0f;   // COSINE only
    for (int w = lane; w < DW; w += 32) {
      const int32_t word = row[w];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int dim = k * DW + w;
        if (dim < D) {
          const int nib = (((word >> (4 * k)) & 0xF) ^ 8) - 8;
          const float v = (float)nib * s;
          const float qv = q_sm[dim];
          if (METRIC == kL2) {
            const float d = qv - v;
            acc += d * d;
          } else {
            acc += qv * v;
            if (METRIC == kCosine) v_sq += v * v;
          }
        }
      }
    }
    acc = warp_sum(acc);
    if (METRIC == kCosine) v_sq = warp_sum(v_sq);
    if (lane == 0) {
      float res;
      if (METRIC == kL2) {
        res = sqrtf(fmaxf(acc, 0.0f));
      } else if (METRIC == kIP) {
        res = -acc;
      } else {
        const float norm = sqrtf(q_sq) * sqrtf(v_sq);
        float cs = acc / (norm > 0.0f ? norm : 1.0f);
        cs = fminf(fmaxf(cs, -1.0f), 1.0f);
        res = (q_sq <= 0.0f || v_sq <= 0.0f) ? 1.0f : 1.0f - cs;
      }
      out[(size_t)b * R + r] = res;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). metric: 0 = L2, 1 = IP,
// 2 = COSINE. Launches on `stream` and returns cudaGetLastError().
extern "C" int lmd_int4_frontier_scores(const int32_t* cur, const float* queries,
                                        const int32_t* codes, const float* scale,
                                        float* out, int B, int D, int C, int R,
                                        int DW, int metric, void* stream) {
  if (B == 0) return 0;
  const size_t smem = (size_t)8 * DW * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kL2:
      int4_frontier_kernel<kL2><<<B, kThreads, smem, st>>>(cur, queries, codes, scale, out, D, C, R, DW);
      break;
    case kIP:
      int4_frontier_kernel<kIP><<<B, kThreads, smem, st>>>(cur, queries, codes, scale, out, D, C, R, DW);
      break;
    case kCosine:
      int4_frontier_kernel<kCosine><<<B, kThreads, smem, st>>>(cur, queries, codes, scale, out, D, C, R, DW);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
