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
//   codes   i8[C, R, D]    abs-max codes in [-127, 127] (any byte is taken)
//   scale   f32[C, R]      per-edge scale (0 for an empty edge slot)
//   out     f32[B, R]      L2: sqrt(max(sum (q-v)^2, 0)); IP: -dot;
//                          COSINE: 1 - clamp(cos, -1, 1), 1.0 on a zero norm
//                          (_metric_distance of the Pallas kernels)
// Per dimension the arithmetic is the plain version's: v = code * scale
// rounded (no contraction), then q - v rounded; the D terms are summed with
// fused multiply-adds in another order (rtol = atol = 1e-5 against the
// plain version).
//
// What bounds it: bytes and latency, then issue slots. Per hop it gathers
// B*R*(D + 4) bytes of codes and scales, 8.65 MB at B=1024, R=64, D=128:
// ~2.6 us at the H100's 3.35 TB/s. Each query's R x D codes meet one query
// (~2 operations per byte), so tensor cores (a 64-row tile sharing one
// operand, ~295 op/byte to pay) do not apply; the ~6 instructions a code
// (byte to float, v, q - v, the fused multiply-add, a share of the loads)
// add to the time the bytes take, less than the bytes do. The first
// version ran one block of 256 threads per query: the block staged the
// query and read cur, then each of its 8 warps read its 8 rows (and each
// row's scale) one after another: ~10 dependent HBM round trips per query.
// This design removes that chain.
//
// Design: persistent blocks of 128 threads (grid = min(items, k * SMs),
// k <= 8, from the wrapper's launch plan) walk their items through a ring
// of S stages (ring.cuh). An item is a query; a stage holds the node's code
// block (R*D bytes, contiguous in the table), its R scales and the query
// row; in the bulk branch each is one 1-D bulk copy, so a query's whole row
// arrives in one round trip while the block scores the previous one. A
// node's block too large for two stages of a block (R=64 from D = 1,705 on,
// R=128 from D = 877) is split into pieces of `rows` rows (the wrapper's
// stage_rows; from 4 on a multiple of 4), and an item is then one piece of
// one query: any R works until one row and the query no longer fit a
// stage, above D = 46,456. Scoring reads shared memory only: a group of G
// lanes per edge row, G the power of two <= 128/rows and <= the row's
// units; at D = 128, R = 64 that is 2 lanes x 64 codes a row, reduced with
// one shuffle. Where D % 4 == 0 a lane takes the row's 4-byte words j, j+G,
// ... (4 codes against one float4 of the query, two sum chains). Where
// every lane has the same power of two N <= 16 of words (D = 128: N = 16)
// the walk is a template, fully unrolled, and its order is XOR-swizzled by
// the lane group: the 16 rows of a warp then read 32 different banks of
// codes, and the 8 lanes of each quarter-warp 8 different 16-byte bank
// groups of the query. (16-byte code units, 4 float4 of the query each,
// would conflict 4-way on one side or the other: 16-byte units of 128-byte
// rows all start in the same bank group, and 8 units of one query row span
// only two. This choice rests on that count; no 16-byte variant was timed.)
// Other D take a plain loop over words or, where D % 4 != 0, bytes. A byte
// becomes a float without a conversion instruction: the bits 0x4B000000 |
// (u ^ 0x80) are the float 2^23 + 128 + code, and subtracting 2^23 + 128
// leaves the signed code exactly. Group leaders write a stage's distances
// as one contiguous run. Node offsets are 64-bit (node * R * D reaches 8.6
// GB at 2^20 rows). Side by side on the card (experiments/int8_ab.py, which
// builds copies of this file with other kThreads / kBlocksPerSm; PERF.md):
// 128 x 8 beat 128 x 6 (S = 4) and 256 x 4 at B = 1024 and 2048.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8; KernelLibrary.build_log): 56
// registers for every walk and metric but two (48: IP over any words, IP
// over bytes), under the cap of 64 that __launch_bounds__(128, 8) sets; no
// stack frame (no spills), 128 bytes of static shared memory (the
// mbarriers).

#include "ring.cuh"

namespace {

using ring::Copy;
using ring::pad16;

// 128 threads a block, at most kBlocksPerSm blocks a SM: at B=1024 each
// block then holds about one query, and a SM's queries are scored side by
// side.
constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 8;  // kernels/int8_frontier.py: BLOCKS_PER_SM

constexpr int kL2 = 0;
constexpr int kIP = 1;
constexpr int kCosine = 2;

// Stage layout for `rows` rows of a node: [codes][scales][query window],
// each region 16-byte aligned; the window holds the query row and up to 12
// bytes around it.
struct Layout {
  uint32_t block, scale, q, bytes;
  Layout() = default;
  __host__ __device__ Layout(int rows, int D) {
    block = (uint32_t)rows * D;
    scale = pad16(block);
    q = scale + pad16((uint32_t)rows * 4);
    bytes = q + pad16((uint32_t)D * 4) + 16;
  }
};

// Byte k of a code word whose sign bits were flipped (word ^ 0x80808080)
// as the exact float of the signed code.
__device__ __forceinline__ float code_of(uint32_t flipped, int k) {
  return __int_as_float(__byte_perm(flipped, 0x4B00u, 0x5440u | k)) - 8388736.0f;
}

// How a lane walks its rows: N = kBytes (any D: bytes), kAnyWords (D % 4
// == 0: 4-byte words, in order), or N > 0 (every lane has exactly N words
// of a row, N a power of two: a fully unrolled, swizzled walk).
constexpr int kBytes = -1;
constexpr int kAnyWords = 0;

template <int METRIC, int N>
struct Int8Job {
  const char* queries;
  const char* codes;
  const char* scale;
  float* out;
  int B, D, R;
  int rows;    // rows of a node a stage holds (R, or a piece of the node)
  int chunks;  // pieces a node's block is split into: ceil(R / rows)
  Layout lay;  // of `rows` rows
  int G;       // lanes per edge row
  bool bulk;   // the branch: bulk copies, or cp.async by every thread

  // Item -> query b and its first row r0 and row count nr in this stage.
  __device__ __forceinline__ void piece(int item, int& b, int& r0, int& nr) const {
    b = chunks == 1 ? item : item / chunks;
    r0 = (item - b * chunks) * rows;
    nr = min(rows, R - r0);
  }

  __device__ int copies(int item, int node, Copy* c) const {
    int b, r0, nr;
    piece(item, b, r0, nr);
    const size_t first = (size_t)node * R + r0;  // 64-bit: node * R * D passes 2^31
    c[0] = {codes + first * D, 0, (uint32_t)nr * D, true};
    c[1] = {scale + first * 4, lay.scale, (uint32_t)nr * 4, true};
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

  // One dimension: v = code * s rounded, then (q - v)^2 or q * v summed.
  __device__ __forceinline__ void term(float qv, float code, float s, float& acc, float& v_sq,
                                       float& q_sq) const {
    const float v = __fmul_rn(code, s);
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

  // D % 4 == 0: lane j takes words j, j+G, ... of the row (4 codes a word,
  // against one float4 of the query, whose row starts 16-byte aligned), in
  // two sum chains. With N words a lane, the i-th is word
  // j + G * (i ^ (g & (N - 1))): the XOR spreads a warp's lane groups over
  // the banks.
  __device__ __forceinline__ void row_words(const uint32_t* row, int g, int j, const float* q,
                                            float s, float& acc, float& v_sq,
                                            float& q_sq) const {
    float acc1 = 0.0f;
    auto word = [&](int w) {
      const uint32_t c = row[w] ^ 0x80808080u;
      const float4 qv = reinterpret_cast<const float4*>(q)[w];
      term(qv.x, code_of(c, 0), s, acc, v_sq, q_sq);
      term(qv.y, code_of(c, 1), s, acc1, v_sq, q_sq);
      term(qv.z, code_of(c, 2), s, acc, v_sq, q_sq);
      term(qv.w, code_of(c, 3), s, acc1, v_sq, q_sq);
    };
    if constexpr (N > 0) {
      const int x = g & (N - 1);
#pragma unroll
      for (int i = 0; i < N; ++i) word(j + G * (i ^ x));
    } else {
      for (int w = j; w < (D >> 2); w += G) word(w);
    }
    acc += acc1;
  }

  // Any D: byte by byte.
  __device__ __forceinline__ void row_bytes(const int8_t* row, int j, const float* q, float s,
                                            float& acc, float& v_sq, float& q_sq) const {
    for (int d = j; d < D; d += G) term(q[d], (float)row[d], s, acc, v_sq, q_sq);
  }

  __device__ void compute(const unsigned char* stage, int item) const {
    int b, r_first, nr;
    piece(item, b, r_first, nr);
    const uint32_t qoff = bulk ? (uint32_t)(((size_t)b * D * 4) & 15) : 0;
    const float* q = reinterpret_cast<const float*>(stage + lay.q + qoff);
    const float* sc = reinterpret_cast<const float*>(stage + lay.scale);
    const int tid = threadIdx.x;
    const int g = tid / G, j = tid % G;
    const int rows_per_pass = kThreads / G;
    // The loop bound is uniform across the block, so every lane reaches
    // the shuffles.
    for (int r0 = 0; r0 < nr; r0 += rows_per_pass) {
      const int r = r0 + g;
      float acc = 0.0f, v_sq = 0.0f, q_sq = 0.0f;
      if (r < nr) {
        const unsigned char* row = stage + (size_t)r * D;
        if constexpr (N == kBytes)
          row_bytes(reinterpret_cast<const int8_t*>(row), j, q, sc[r], acc, v_sq, q_sq);
        else
          row_words(reinterpret_cast<const uint32_t*>(row), g, j, q, sc[r], acc, v_sq, q_sq);
      }
      for (int off = G >> 1; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (METRIC == kCosine) {
          v_sq += __shfl_xor_sync(0xffffffffu, v_sq, off);
          q_sq += __shfl_xor_sync(0xffffffffu, q_sq, off);
        }
      }
      if (r < nr && j == 0) {
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
        out[(size_t)b * R + r_first + r] = res;
      }
    }
  }
};

template <int METRIC, int N>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
int8_frontier_kernel(Int8Job<METRIC, N> job, const int32_t* __restrict__ cur, int C, int S,
                     uint32_t stage_bytes) {
  ring::run<kThreads>(job, cur, job.B, C, S, stage_bytes, job.chunks);
}

// Lanes per edge row: the largest power of two <= 32 that fits a stage's
// rows in one pass of the block and does not exceed the row's units.
int lanes_per_row(int rows, int units) {
  int G = 1;
  while (G < 32 && 2 * G * rows <= kThreads && G < units) G <<= 1;
  return G;
}

template <int METRIC, int N>
int launch(const float* queries, const int8_t* codes, const float* scale, float* out,
           const int32_t* cur, int B, int D, int C, int R, int rows, int G, int grid, int S,
           uint32_t stage_bytes, bool bulk, cudaStream_t st) {
  Int8Job<METRIC, N> job{};
  job.queries = reinterpret_cast<const char*>(queries);
  job.codes = reinterpret_cast<const char*>(codes);
  job.scale = reinterpret_cast<const char*>(scale);
  job.out = out;
  job.B = B;
  job.D = D;
  job.R = R;
  job.rows = rows;
  job.chunks = (R + rows - 1) / rows;
  job.lay = Layout(rows, D);
  job.G = G;
  job.bulk = bulk;
  const size_t smem = (size_t)S * stage_bytes;
  const int err = ring::allow_smem(int8_frontier_kernel<METRIC, N>, smem);
  if (err != 0) return err;
  int8_frontier_kernel<METRIC, N><<<grid, kThreads, smem, st>>>(job, cur, C, S, stage_bytes);
  return (int)cudaGetLastError();
}

// The walk (kBytes, kAnyWords or N words a lane) for D and a stage's rows.
template <int METRIC>
int launch_metric(const float* queries, const int8_t* codes, const float* scale, float* out,
                  const int32_t* cur, int B, int D, int C, int R, int rows, int grid, int S,
                  uint32_t stage_bytes, bool bulk, cudaStream_t st) {
#define LMD_INT8_LAUNCH(N_) \
  return launch<METRIC, N_>(queries, codes, scale, out, cur, B, D, C, R, rows, G, grid, S, \
                            stage_bytes, bulk, st)
  if (D % 4 != 0) {
    const int G = lanes_per_row(rows, D);
    LMD_INT8_LAUNCH(kBytes);
  }
  const int W = D / 4;
  const int G = lanes_per_row(rows, W);
  switch (W % G == 0 ? W / G : 0) {
    case 1: LMD_INT8_LAUNCH(1);
    case 2: LMD_INT8_LAUNCH(2);
    case 4: LMD_INT8_LAUNCH(4);
    case 8: LMD_INT8_LAUNCH(8);
    case 16: LMD_INT8_LAUNCH(16);
    default: LMD_INT8_LAUNCH(kAnyWords);
  }
#undef LMD_INT8_LAUNCH
}

}  // namespace

// Plain C entry point (loaded with ctypes). metric: 0 = L2, 1 = IP,
// 2 = COSINE. rows (the rows of a node a stage holds, 1..R), grid, stages,
// stage_bytes and bulk come from the wrapper's launch plan
// (kernels/int8_frontier.py, kernels/_build.py::ring_plan); stage_bytes
// below this layout's size is refused. Launches on `stream` and returns the
// CUDA error of the shared-memory attribute call or the launch.
extern "C" int lmd_int8_frontier_scores(const int32_t* cur, const float* queries,
                                        const int8_t* codes, const float* scale, float* out,
                                        int B, int D, int C, int R, int metric, int rows,
                                        int grid, int stages, int stage_bytes, int bulk,
                                        void* stream) {
  if (B == 0) return 0;
  if (rows < 1 || rows > R) return (int)cudaErrorInvalidValue;
  const Layout lay(rows, D);
  const long long items = (long long)B * ((R + rows - 1) / rows);
  if (stages < 1 || stages > ring::kMaxStages || grid < 1 || stage_bytes < (int)lay.bytes ||
      stage_bytes % 16 != 0 || items > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t sb = (uint32_t)stage_bytes;
  switch (metric) {
    case kL2:
      return launch_metric<kL2>(queries, codes, scale, out, cur, B, D, C, R, rows, grid, stages,
                                sb, bulk != 0, st);
    case kIP:
      return launch_metric<kIP>(queries, codes, scale, out, cur, B, D, C, R, rows, grid, stages,
                                sb, bulk != 0, st);
    case kCosine:
      return launch_metric<kCosine>(queries, codes, scale, out, cur, B, D, C, R, rows, grid,
                                    stages, sb, bulk != 0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
