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
// Both compute the same function; here the K rows in flight are the stages
// of a shared-memory ring (ring.cuh), so one kernel serves both.
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
// What bounds it: bytes and latency. Per hop it gathers B*R*W*4*2 bytes of
// planes, 15.7 MB at B=1024, R=64, W=30 (D=960): ~4.7 us at 3.35 TB/s. The
// work is ~8 logic ops + 2 POPC + 2 adds per word pair (word_dot); POPC
// runs at 16 a clock on an SM, so the four POPC a word of the first version
// cost about as much time as the bytes. Each query's R x W planes
// are used once against one query, ~1.5 operations per byte, so tensor
// cores (which need a 64-row tile sharing one operand, and ~295 op/byte to
// pay) do not apply. The design removes the latency chain of the first
// version (one block per query; the block read cur only after staging the
// query, then each warp read its 8 rows one after another: ~10 dependent
// HBM round trips per block).
//
// Design: persistent blocks of 256 threads (grid = min(B, k * SMs), from
// the wrapper's launch plan) walk their queries through a ring of S stages.
// A stage holds the node's two plane blocks (R*W*4 bytes each, contiguous
// in the table) and the two query planes; in the bulk branch each is one
// 1-D bulk copy, so a query's whole row arrives in one round trip while the
// block scores the previous one. Scoring reads shared memory only: a lane
// group of G lanes per edge row, G the power of two <= 256/R and <= the
// row's units (8-byte word pairs when W is even), so at R=64, W=30 four
// lanes take 15 word pairs and reduce with two shuffles; lanes past the row
// add 0. Group leaders write a query's R scores as one contiguous run.
// Node offsets are 64-bit (node * R * W * 4 passes 2^31 in the GIST table).
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8; KernelLibrary.build_log): 40
// registers (word pairs, W even, and single words), 0 bytes of spill
// stores and loads, 128 bytes of static shared memory (the mbarriers);
// __launch_bounds__(256, 4) caps registers at 64.

#include <type_traits>

#include "ring.cuh"

namespace {

using ring::Copy;
using ring::pad16;

// 256 threads a block, at most 4 blocks a SM (registers capped at 64): at
// W=30 a stage is 15.6 KB, so four blocks keep 3 stages each.
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;  // kernels/ternary_frontier.py: BLOCKS_PER_SM

// Stage layout: [pos block][neg block][q_pos window][q_neg window], each
// region 16-byte aligned; a window holds the query plane and up to 12 bytes
// around it.
struct Layout {
  uint32_t block, neg, qp, qn, bytes;
  Layout() = default;
  __host__ __device__ Layout(int R, int W) {
    block = (uint32_t)R * W * 4;
    neg = pad16(block);
    qp = 2 * pad16(block);
    qn = qp + pad16((uint32_t)W * 4) + 16;
    bytes = qn + pad16((uint32_t)W * 4) + 16;
  }
};

// pop(a&p) - pop(a&n) - pop(m&p) + pop(m&n) with two POPC instead of four
// (POPC issues at a quarter of the logic rate): per bit the sum is
// (a - m)(p - n), which is +1, -1 or 0, so it is the count of the +1 bits
// less the count of the -1 bits. Exact for any bits, also where a plane
// pair overlaps.
__device__ __forceinline__ int word_dot(uint32_t a, uint32_t m, uint32_t p, uint32_t n) {
  const uint32_t qa = a & ~m, qm = m & ~a;  // query bits of +1 and -1
  const uint32_t vp = p & ~n, vn = n & ~p;  // edge bits of +1 and -1
  return __popc((qa & vp) | (qm & vn)) - __popc((qa & vn) | (qm & vp));
}

template <int VEC>  // words per unit: 2 (uint2) when W is even, else 1
struct TernaryJob {
  const char* q_pos;
  const char* q_neg;
  const char* edge_pos;
  const char* edge_neg;
  int32_t* out;
  int B, R, W;
  Layout lay;
  int G;     // lanes per edge row
  bool bulk;  // the branch: bulk copies, or cp.async by every thread

  __device__ int copies(int b, int node, Copy* c) const {
    const size_t blk = (size_t)node * lay.block;
    c[0] = {edge_pos + blk, 0, lay.block, true};
    c[1] = {edge_neg + blk, lay.neg, lay.block, true};
    const size_t rb = (size_t)W * 4;
    const size_t start = (size_t)b * rb;
    if (!bulk) {
      c[2] = {q_pos + start, lay.qp, (uint32_t)rb, true};
      c[3] = {q_neg + start, lay.qn, (uint32_t)rb, true};
      return 4;
    }
    const size_t lo = start & ~(size_t)15;
    const size_t hi = (start + rb + 15) & ~(size_t)15;
    if (hi <= (size_t)B * rb) {
      c[2] = {q_pos + lo, lay.qp, (uint32_t)(hi - lo), true};
      c[3] = {q_neg + lo, lay.qn, (uint32_t)(hi - lo), true};
    } else {  // the window would pass the table's end: plain loads
      const uint32_t off = (uint32_t)(start & 15);
      c[2] = {q_pos + start, lay.qp + off, (uint32_t)rb, false};
      c[3] = {q_neg + start, lay.qn + off, (uint32_t)rb, false};
    }
    return 4;
  }

  __device__ void compute(const unsigned char* stage, int b) const {
    using Unit = typename std::conditional<VEC == 2, uint2, uint32_t>::type;
    const uint32_t qoff = bulk ? (uint32_t)(((size_t)b * W * 4) & 15) : 0;
    const Unit* ep = reinterpret_cast<const Unit*>(stage);
    const Unit* en = reinterpret_cast<const Unit*>(stage + lay.neg);
    const Unit* qp = reinterpret_cast<const Unit*>(stage + lay.qp + qoff);
    const Unit* qn = reinterpret_cast<const Unit*>(stage + lay.qn + qoff);
    const int U = W / VEC;
    const int tid = threadIdx.x;
    const int g = tid / G, j = tid % G;
    const int rows_per_pass = kThreads / G;
    // The loop bound is uniform across the block, so every lane reaches
    // the shuffles.
    for (int r0 = 0; r0 < R; r0 += rows_per_pass) {
      const int r = r0 + g;
      int acc = 0;
      if (r < R) {
        const Unit* vp = ep + (size_t)r * U;
        const Unit* vn = en + (size_t)r * U;
        for (int u = j; u < U; u += G) {
          const Unit a = qp[u], m = qn[u], p = vp[u], n = vn[u];
          if constexpr (VEC == 2) {
            acc += word_dot(a.x, m.x, p.x, n.x) + word_dot(a.y, m.y, p.y, n.y);
          } else {
            acc += word_dot(a, m, p, n);
          }
        }
      }
      for (int off = G >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (r < R && j == 0) out[(size_t)b * R + r] = acc;
    }
  }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
ternary_frontier_kernel(TernaryJob<VEC> job, const int32_t* __restrict__ cur, int C, int S,
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

template <int VEC>
int launch(TernaryJob<VEC> job, const int32_t* cur, int C, int grid, int S,
           uint32_t stage_bytes, cudaStream_t st) {
  job.G = lanes_per_row(job.R, job.W / VEC);
  const size_t smem = (size_t)S * stage_bytes;
  const int err = ring::allow_smem(ternary_frontier_kernel<VEC>, smem);
  if (err != 0) return err;
  ternary_frontier_kernel<VEC><<<grid, kThreads, smem, st>>>(job, cur, C, S, stage_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). grid, stages, stage_bytes and
// bulk come from the wrapper's launch plan (kernels/_build.py::ring_plan);
// stage_bytes below this layout's size is refused. Launches on `stream` and
// returns the CUDA error of the shared-memory attribute call or the launch.
extern "C" int lmd_ternary_frontier_scores(const int32_t* cur, const int32_t* q_pos,
                                           const int32_t* q_neg, const int32_t* edge_pos,
                                           const int32_t* edge_neg, int32_t* out, int B,
                                           int C, int R, int W, int grid, int stages,
                                           int stage_bytes, int bulk, void* stream) {
  if (B == 0) return 0;
  const Layout lay(R, W);
  if (stages < 1 || stages > ring::kMaxStages || grid < 1 || stage_bytes < (int)lay.bytes ||
      stage_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fill = [&](auto& job) {
    job.q_pos = reinterpret_cast<const char*>(q_pos);
    job.q_neg = reinterpret_cast<const char*>(q_neg);
    job.edge_pos = reinterpret_cast<const char*>(edge_pos);
    job.edge_neg = reinterpret_cast<const char*>(edge_neg);
    job.out = out;
    job.B = B;
    job.R = R;
    job.W = W;
    job.lay = lay;
    job.G = 1;
    job.bulk = bulk != 0;
  };
  if (W % 2 == 0) {
    TernaryJob<2> job{};
    fill(job);
    return launch(job, cur, C, grid, stages, (uint32_t)stage_bytes, st);
  }
  TernaryJob<1> job{};
  fill(job);
  return launch(job, cur, C, grid, stages, (uint32_t)stage_bytes, st);
}
