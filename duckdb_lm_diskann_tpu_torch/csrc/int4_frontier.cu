// INT4 frontier scorer for Hopper (sm_90a): for each query b, the distance
// from queries[b] to each of the R dequantized INT4 neighbor codes cached in
// node cur[b]'s row.
//
// Replaces the TPU kernels
//   duckdb_lm_diskann_tpu/experiments/pallas_kernels.py::int4_frontier_scores
//     (_int4_score_kernel, one BlockSpec-pipelined row DMA per grid step) and
//   ...::int4_frontier_scores_deep
//     (_int4_deep_kernel, the same contract with K row DMAs in flight).
// Both compute the same function; here the K rows in flight are the stages
// of a shared-memory ring (ring.cuh), so one kernel serves both.
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
// Per dimension the arithmetic is the plain version's: v = nib * s rounded
// (no contraction), then q - v rounded; the D terms are summed with fused
// multiply-adds in another order (rtol = atol = 1e-5 against the plain
// version).
//
// What bounds it: latency, then bytes. Per hop it gathers B*R*(4*DW + 4)
// bytes of codes and scales, 4.4 MB at B=1024, R=64, D=128: ~1.3 us at
// 3.35 TB/s, less than one launch and a few HBM round trips. Each query's
// R x D codes are used once against one query (~2 operations per byte), so
// tensor cores (a 64-row tile sharing one operand, ~295 op/byte to pay) do
// not apply. The first version ran one block per query whose 8 warps each
// read their 8 rows (and each row's scale) one after another behind the
// query staging and the read of cur: ~10 dependent HBM round trips per
// block, and half of each warp idle at DW = 16. This design removes that
// chain.
//
// Design: persistent blocks of 128 threads (grid = min(B, k * SMs), k <= 8,
// from the wrapper's launch plan) walk their queries through a ring of S
// stages.
// A stage holds the node's code block (R*DW*4 bytes, contiguous in the
// table), its R scales and the query row; in the bulk branch each is one
// 1-D bulk copy, so a query's whole row arrives in one round trip while the
// block scores the previous one. Scoring reads shared memory only: a group
// of G lanes per edge row, G the power of two <= 128/R and <= the row's
// units, each lane taking 16-byte chunks (4 words, 32 nibbles, the query as
// 8 float4) where D == 8 * DW and DW % 4 == 0, and words otherwise; at
// D = 128, R = 64 that is 2 lanes x 64 nibbles per row, reduced with one
// shuffle.
// A nibble becomes a float without a conversion
// instruction: the bits 0x4B000000 | (u ^ 8) are the float 2^23 + (u ^ 8),
// and subtracting 2^23 + 8 leaves the signed nibble exactly. Group leaders
// write a query's R distances as one contiguous run. Node offsets are
// 64-bit.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8; KernelLibrary.build_log): 63
// registers for row_full (every metric; the cap that
// __launch_bounds__(128, 8) sets is 64) and 40 for row_any, 0 bytes of
// spill stores and loads, 128 bytes of static shared memory (the
// mbarriers).

#include "ring.cuh"

namespace {

using ring::Copy;
using ring::pad16;

// 128 threads a block, at most 8 blocks a SM (registers capped at 64): at
// B=1024 each block then holds about one query, so the queries of a SM are
// scored side by side instead of one after another in a block (less card
// time than 256 x 4 at B=1024 and 2048, PERF.md).
constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 8;  // kernels/int4_frontier.py: BLOCKS_PER_SM

constexpr int kL2 = 0;
constexpr int kIP = 1;
constexpr int kCosine = 2;

// Stage layout: [code block][scales][query window], each region 16-byte
// aligned; the window holds the query row and up to 12 bytes around it.
struct Layout {
  uint32_t block, scale, q, bytes;
  Layout() = default;
  __host__ __device__ Layout(int R, int D, int DW) {
    block = (uint32_t)R * DW * 4;
    scale = pad16(block);
    q = scale + pad16((uint32_t)R * 4);
    bytes = q + pad16((uint32_t)D * 4) + 16;
  }
};

// The signed nibble `k` of `word` as an exact float.
__device__ __forceinline__ float nibble(uint32_t word, int k) {
  return __int_as_float(((word >> (4 * k)) & 0xFu) ^ 0x4B000008u) - 8388616.0f;
}

// FULL: D == 8 * DW with DW % 4 == 0 (row_full); else row_any.
template <int METRIC, bool FULL>
struct Int4Job {
  const char* queries;
  const char* codes;
  const char* scale;
  float* out;
  int B, D, R, DW;
  Layout lay;
  int G;      // lanes per edge row
  bool bulk;  // the branch: bulk copies, or cp.async by every thread

  __device__ int copies(int b, int node, Copy* c) const {
    c[0] = {codes + (size_t)node * lay.block, 0, lay.block, true};
    c[1] = {scale + (size_t)node * R * 4, lay.scale, (uint32_t)R * 4, true};
    const size_t rb = (size_t)D * 4;
    const size_t start = (size_t)b * rb;
    if (!bulk) {
      c[2] = {queries + start, lay.q, (uint32_t)rb, true};
      return 3;
    }
    const size_t lo = start & ~(size_t)15;
    const size_t hi = (start + rb + 15) & ~(size_t)15;
    if (hi <= (size_t)B * rb) {
      c[2] = {queries + lo, lay.q, (uint32_t)(hi - lo), true};
    } else {  // the window would pass the table's end: plain loads
      c[2] = {queries + start, lay.q + (uint32_t)(start & 15), (uint32_t)rb, false};
    }
    return 3;
  }

  // One dimension: v = nib * s rounded, then (q - v)^2 or q * v summed.
  __device__ __forceinline__ void term(float qv, float nib, float s, float& acc, float& v_sq,
                                       float& q_sq) const {
    const float v = __fmul_rn(nib, s);
    if (METRIC == kL2) {
      const float d = __fsub_rn(qv, v);
      acc = fmaf(d, d, acc);
    } else {
      acc = fmaf(qv, v, acc);
      if (METRIC == kCosine) {
        v_sq = fmaf(v, v, v_sq);
        q_sq = fmaf(qv, qv, q_sq);
      }
    }
  }

  // Any D and DW: word by word, nibbles of dims >= D skipped.
  __device__ __forceinline__ void row_any(const uint32_t* row, int j, const float* q, float s,
                                          float& acc, float& v_sq, float& q_sq) const {
    for (int w = j; w < DW; w += G) {
      const uint32_t word = row[w];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int dim = k * DW + w;
        if (dim < D) term(q[dim], nibble(word, k), s, acc, v_sq, q_sq);
      }
    }
  }

  // D == 8 * DW and DW % 4 == 0 (D = 128: one unit a lane): 16-byte units of
  // 4 words, the query read as one float4 per nibble slot (its row starts
  // 16-byte aligned), and two sum chains.
  __device__ __forceinline__ void row_full(const uint32_t* row, int j, const float* q, float s,
                                           float& acc, float& v_sq, float& q_sq) const {
    float acc1 = 0.0f;
    for (int u = j; u < DW / 4; u += G) {
      const uint4 x = reinterpret_cast<const uint4*>(row)[u];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float4 qv = *reinterpret_cast<const float4*>(q + k * DW + 4 * u);
        float& a = (k & 1) ? acc1 : acc;
        term(qv.x, nibble(x.x, k), s, a, v_sq, q_sq);
        term(qv.y, nibble(x.y, k), s, a, v_sq, q_sq);
        term(qv.z, nibble(x.z, k), s, a, v_sq, q_sq);
        term(qv.w, nibble(x.w, k), s, a, v_sq, q_sq);
      }
    }
    acc += acc1;
  }

  __device__ void compute(const unsigned char* stage, int b) const {
    const uint32_t qoff = bulk ? (uint32_t)(((size_t)b * D * 4) & 15) : 0;
    const float* q = reinterpret_cast<const float*>(stage + lay.q + qoff);
    const float* sc = reinterpret_cast<const float*>(stage + lay.scale);
    const int tid = threadIdx.x;
    const int g = tid / G, j = tid % G;
    const int rows_per_pass = kThreads / G;
    // The loop bound is uniform across the block, so every lane reaches
    // the shuffles.
    for (int r0 = 0; r0 < R; r0 += rows_per_pass) {
      const int r = r0 + g;
      float acc = 0.0f, v_sq = 0.0f, q_sq = 0.0f;
      if (r < R) {
        const float s = sc[r];
        const uint32_t* row = reinterpret_cast<const uint32_t*>(stage) + (size_t)r * DW;
        if (FULL)
          row_full(row, j, q, s, acc, v_sq, q_sq);
        else
          row_any(row, j, q, s, acc, v_sq, q_sq);
      }
      for (int off = G >> 1; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (METRIC == kCosine) {
          v_sq += __shfl_xor_sync(0xffffffffu, v_sq, off);
          q_sq += __shfl_xor_sync(0xffffffffu, q_sq, off);
        }
      }
      if (r < R && j == 0) {
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
};

template <int METRIC, bool FULL>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
int4_frontier_kernel(Int4Job<METRIC, FULL> job, const int32_t* __restrict__ cur, int C, int S,
                     uint32_t stage_bytes) {
  ring::run<kThreads>(job, cur, job.B, C, S, stage_bytes);
}

// Lanes per edge row: the largest power of two <= 32 that fits R rows in
// one pass of the block and does not exceed the row's units.
int lanes_per_row(int R, int units) {
  int G = 1;
  while (G < 32 && 2 * G * R <= kThreads && G < units) G <<= 1;
  return G;
}

template <int METRIC, bool FULL>
int launch(const float* queries, const int32_t* codes, const float* scale, float* out,
           const int32_t* cur, int B, int D, int C, int R, int DW, int grid, int S,
           uint32_t stage_bytes, bool bulk, cudaStream_t st) {
  Int4Job<METRIC, FULL> job{};
  job.queries = reinterpret_cast<const char*>(queries);
  job.codes = reinterpret_cast<const char*>(codes);
  job.scale = reinterpret_cast<const char*>(scale);
  job.out = out;
  job.B = B;
  job.D = D;
  job.R = R;
  job.DW = DW;
  job.lay = Layout(R, D, DW);
  job.G = lanes_per_row(R, FULL ? DW / 4 : DW);
  job.bulk = bulk;
  const size_t smem = (size_t)S * stage_bytes;
  const int err = ring::allow_smem(int4_frontier_kernel<METRIC, FULL>, smem);
  if (err != 0) return err;
  int4_frontier_kernel<METRIC, FULL><<<grid, kThreads, smem, st>>>(job, cur, C, S,
                                                                        stage_bytes);
  return (int)cudaGetLastError();
}

template <int METRIC>
int launch_metric(const float* queries, const int32_t* codes, const float* scale, float* out,
                  const int32_t* cur, int B, int D, int C, int R, int DW, int grid, int S,
                  uint32_t stage_bytes, bool bulk, cudaStream_t st) {
  if (D == 8 * DW && DW % 4 == 0)
    return launch<METRIC, true>(queries, codes, scale, out, cur, B, D, C, R, DW, grid, S,
                             stage_bytes, bulk, st);
  return launch<METRIC, false>(queries, codes, scale, out, cur, B, D, C, R, DW, grid, S,
                           stage_bytes, bulk, st);
}

}  // namespace

// Plain C entry point (loaded with ctypes). metric: 0 = L2, 1 = IP,
// 2 = COSINE. grid, stages, stage_bytes and bulk come from the wrapper's
// launch plan (kernels/_build.py::ring_plan); stage_bytes below this
// layout's size is refused. Launches on `stream` and returns the CUDA error
// of the shared-memory attribute call or the launch.
extern "C" int lmd_int4_frontier_scores(const int32_t* cur, const float* queries,
                                        const int32_t* codes, const float* scale, float* out,
                                        int B, int D, int C, int R, int DW, int metric,
                                        int grid, int stages, int stage_bytes, int bulk,
                                        void* stream) {
  if (B == 0) return 0;
  const Layout lay(R, D, DW);
  if (stages < 1 || stages > ring::kMaxStages || grid < 1 || stage_bytes < (int)lay.bytes ||
      stage_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t sb = (uint32_t)stage_bytes;
  switch (metric) {
    case kL2:
      return launch_metric<kL2>(queries, codes, scale, out, cur, B, D, C, R, DW, grid, stages,
                                sb, bulk != 0, st);
    case kIP:
      return launch_metric<kIP>(queries, codes, scale, out, cur, B, D, C, R, DW, grid, stages,
                                sb, bulk != 0, st);
    case kCosine:
      return launch_metric<kCosine>(queries, codes, scale, out, cur, B, D, C, R, DW, grid,
                                    stages, sb, bulk != 0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
