// INT8 frontier scorer for Hopper (sm_90a): for each query b, the distance
// from queries[b] to each of the R dequantized INT8 neighbor codes cached in
// node cur[b]'s row.
//
// Replaces the TPU kernel
//   duckdb_lm_diskann_tpu/experiments/pallas_kernels.py::int8_frontier_scores
//     (_int8_score_kernel, one BlockSpec-pipelined row DMA per grid step).
//
// Contract (same as the Pallas kernel):
//   cur     i32[B]         node slot per query (clamped into [0, C))
//   queries f32[B, D]
//   codes   i8[C, R, D]    abs-max codes in [-127, 127]
//   scale   f32[C, R]      per-edge scale (0 for an empty edge slot)
//   out     f32[B, R]      L2: sqrt(max(sum (q-v)^2, 0)); IP: -dot;
//                          COSINE: 1 - clamp(cos, -1, 1), 1.0 on a zero norm
//                          (_metric_distance of the Pallas kernels)
// v = code * scale in f32; the sums run in another order than the plain
// PyTorch version's, so the two agree to f32 rounding (rtol 1e-5).
//
// What bounds it: per hop it gathers B*R*(D + 4) bytes of codes and scales,
// 8.65 MB at B=1024, R=64, D=128: ~2.6 us at the H100's 3.35 TB/s; the f32
// work (~4 operations per code) is far below the card's rate. So it is bound
// by bytes and by row-gather latency; many resident blocks keep rows in
// flight.
//
// Design: one block per query row, 256 threads. The block reads cur[b]
// itself and stages the query in shared memory. One warp per edge row (8
// warps stride over R). When D % 4 == 0 and the codes are 4-byte aligned,
// lane j reads the row's 32-bit words j, j+32, ... (4 codes each; one
// 128-byte line per warp step at D=128) and the matching float4 of the
// staged query; otherwise lane j reads bytes j, j+32, .... The warp reduces
// with __shfl_xor_sync; lane 0 applies the metric epilogue.

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
__device__ __forceinline__ void accumulate(float qv, float v, float& acc,
                                           float& v_sq) {
  if (METRIC == kL2) {
    const float d = qv - v;
    acc += d * d;
  } else {
    acc += qv * v;
    if (METRIC == kCosine) v_sq += v * v;
  }
}

template <int METRIC, bool VEC4>
__global__ void __launch_bounds__(kThreads)
int8_frontier_kernel(const int32_t* __restrict__ cur,
                     const float* __restrict__ queries,
                     const int8_t* __restrict__ codes,
                     const float* __restrict__ scale,
                     float* __restrict__ out,
                     int D, int C, int R) {
  extern __shared__ float4 q_sm4[];  // [ceil(D/4)] float4: the query
  float* q_sm = reinterpret_cast<float*>(q_sm4);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* q = queries + (size_t)b * D;
  for (int i = tid; i < D; i += kThreads) q_sm[i] = q[i];
  __syncthreads();

  int node = cur[b];
  node = node < 0 ? 0 : (node >= C ? C - 1 : node);
  const int8_t* rows = codes + (size_t)node * R * D;
  const float* srow = scale + (size_t)node * R;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  float q_sq = 0.0f;
  if (METRIC == kCosine) {
    for (int i = lane; i < D; i += 32) q_sq += q_sm[i] * q_sm[i];
    q_sq = warp_sum(q_sq);
  }

  for (int r = warp; r < R; r += kThreads / 32) {
    const float s = srow[r];
    const int8_t* row = rows + (size_t)r * D;
    float acc = 0.0f;   // L2: sum (q-v)^2; IP/COSINE: sum q*v
    float v_sq = 0.0f;  // COSINE only
    if (VEC4) {
      const int32_t* words = reinterpret_cast<const int32_t*>(row);
      for (int w = lane; w < D / 4; w += 32) {
        const int32_t word = words[w];
        const float4 qv = q_sm4[w];
        accumulate<METRIC>(qv.x, (float)(int8_t)(word & 0xFF) * s, acc, v_sq);
        accumulate<METRIC>(qv.y, (float)(int8_t)((word >> 8) & 0xFF) * s, acc, v_sq);
        accumulate<METRIC>(qv.z, (float)(int8_t)((word >> 16) & 0xFF) * s, acc, v_sq);
        accumulate<METRIC>(qv.w, (float)(int8_t)((word >> 24) & 0xFF) * s, acc, v_sq);
      }
    } else {
      for (int d = lane; d < D; d += 32)
        accumulate<METRIC>(q_sm[d], (float)row[d] * s, acc, v_sq);
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

template <int METRIC>
void launch(bool vec4, dim3 grid, size_t smem, cudaStream_t st,
            const int32_t* cur, const float* queries, const int8_t* codes,
            const float* scale, float* out, int D, int C, int R) {
  if (vec4)
    int8_frontier_kernel<METRIC, true><<<grid, kThreads, smem, st>>>(
        cur, queries, codes, scale, out, D, C, R);
  else
    int8_frontier_kernel<METRIC, false><<<grid, kThreads, smem, st>>>(
        cur, queries, codes, scale, out, D, C, R);
}

}  // namespace

// Plain C entry point (loaded with ctypes). metric: 0 = L2, 1 = IP,
// 2 = COSINE. Launches on `stream` and returns cudaGetLastError().
extern "C" int lmd_int8_frontier_scores(const int32_t* cur, const float* queries,
                                        const int8_t* codes, const float* scale,
                                        float* out, int B, int D, int C, int R,
                                        int metric, void* stream) {
  if (B == 0) return 0;
  const size_t smem = (size_t)((D + 3) / 4) * sizeof(float4);
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kL2:
      launch<kL2>(vec4, B, smem, st, cur, queries, codes, scale, out, D, C, R);
      break;
    case kIP:
      launch<kIP>(vec4, B, smem, st, cur, queries, codes, scale, out, D, C, R);
      break;
    case kCosine:
      launch<kCosine>(vec4, B, smem, st, cur, queries, codes, scale, out, D, C, R);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
