// A bulk-copy variant of the row gather (csrc/row_gather.cu), for Hopper
// (sm_90a): out_t[b] = src_t[clamp(idx[b], 0, C-1)] for 1 to 4 tables.
// It is not on any path of the port: experiments/row_gather_ab.py copies it
// with csrc/ring.cuh into _build/ab/, builds it, holds it against the plain
// version and times it in turns with the shipped kernel and index_select.
// In those runs it was faster than the shipped register copy at B = 256,
// level at 1024 and 4096 and slower at 16,384 (PERF.md): not faster at
// every size, so it is kept here and not shipped.
//
// Design: Hopper's counterpart of the TPU kernel's DMA ring is the
// bulk-copy (TMA) engine, so no thread touches the bytes.
//
// - Persistent one-warp blocks: `grid` blocks (row_gather_ab's plan:
//   min(B, k * SMs)), rows dealt b -> block b % grid.
// - The block's first L lanes (the plan: L = min(kMaxLanes, its rows)) are
//   issuers; lane l takes the block's rows l, l + L, ... through one stage
//   of its own that holds one row of every table. For each row it arms the
//   stage's mbarrier with the row's bytes and issues one 1-D bulk load
//   (global -> shared) per table; when the barrier completes it issues one
//   1-D bulk store (shared -> global) per table to out_t[b] and commits a
//   bulk group; it refills the stage once that store has read it
//   (cp.async.bulk.wait_group.read 0). The next row's idx loads while the
//   lane waits for the current one.
// - Every table must be 16-byte aligned with rows a non-zero multiple of 16
//   bytes, and L stages must fit a block's shared memory: the entry point
//   refuses anything else. The grid's blocks a SM and L are the plan's
//   (row_gather_ab --shapes), so one build serves every shape.
//
// Fences (PTX memory model, one proxy per kind of access):
// - fence.mbarrier_init after the barrier's init, so the async proxy (the
//   bulk loads' complete_tx) sees it initialised.
// - fence.proxy.async.shared::cta between the wait on the stage's barrier
//   and the bulk store that reads it: the load's bytes reach the thread
//   through the barrier in the generic proxy, and the store reads them
//   through the async proxy (row_gather_ab --no-fence times the copy
//   without it).
// - No fence before a refill: the stage was last read by a bulk store (async
//   proxy) that wait_group.read has seen finish, and the refill writes it in
//   the same proxy. No thread reads or writes a stage with plain loads.
// - Before it exits, a lane waits until its last bulk store has read the
//   stage: shared memory must outlive the reads. The stores' writes to
//   global memory are complete when the grid is.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ring.cuh"

namespace {

constexpr int kMaxLanes = 32;  // the most issuing lanes: one warp
constexpr int kThreads = 32;  // one warp a block
constexpr int kMaxTables = 4;

struct Table {
  const char* src;
  char* out;
  long long bytes;  // per row
  uint32_t off;     // the row's offset in a stage
};

struct Tables {
  Table t[kMaxTables];
  uint32_t stage_bytes;  // one row of every table
  uint32_t ring_off;     // the stages' offset (after the barriers)
  int n;
};

__device__ __forceinline__ long long clamp_row(long long r, long long C) {
  return r < 0 ? 0 : (r >= C ? C - 1 : r);
}

// 1-D bulk copy from shared to global memory, tracked by the issuing
// thread's bulk groups. Addresses and size are multiples of 16 bytes.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(ring::smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until none of this thread's bulk groups still reads shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
row_gather_bulk_kernel(const int32_t* __restrict__ idx, Tables tabs, int B, long long C,
                       int L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x;
  const long long grid = gridDim.x;
  const long long n_mine = ((long long)B - 1 - blockIdx.x) / grid + 1;  // grid <= B
  if (lane >= L || lane >= n_mine) return;
  const long long n_lane = (n_mine - 1 - lane) / L + 1;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem) + lane;
  unsigned char* st = smem + tabs.ring_off + (size_t)lane * tabs.stage_bytes;
  auto row = [&](long long m) { return blockIdx.x + (lane + m * L) * grid; };
  auto src_row = [&](long long m) { return clamp_row(idx[row(m)], C); };
  auto load = [&](long long r) {
    ring::mbar_arrive_expect_tx(full, tabs.stage_bytes);
#pragma unroll
    for (int t = 0; t < kMaxTables; ++t)
      if (t < tabs.n)
        ring::bulk_copy(st + tabs.t[t].off, tabs.t[t].src + r * tabs.t[t].bytes,
                        (uint32_t)tabs.t[t].bytes, full);
  };

  const long long r0 = src_row(0);
  ring::mbar_init(full, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  load(r0);
  uint32_t phase = 0;
  for (long long m = 0; m < n_lane; ++m) {
    const bool refill = m + 1 < n_lane;
    const long long r = refill ? src_row(m + 1) : 0;  // its idx loads during the wait
    ring::mbar_wait(full, phase);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const long long b = row(m);
#pragma unroll
    for (int t = 0; t < kMaxTables; ++t)
      if (t < tabs.n)
        bulk_store(tabs.t[t].out + b * tabs.t[t].bytes, st + tabs.t[t].off,
                   (uint32_t)tabs.t[t].bytes);
    bulk_commit();
    phase ^= 1u;
    if (refill) {
      bulk_wait_read();
      load(r);
    }
  }
  bulk_wait_read();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Plain C entry point (loaded with ctypes). Tables 0..n_tables-1 are used
// (x_t words a row); src/out of the others may be null. `grid` and `lanes`
// are row_gather_ab's plan. Refuses (cudaErrorInvalidValue) a width not a
// non-zero multiple of 4 words, a pointer not 16-byte aligned, or stages
// past a block's 227 KB of shared memory. Launches on `stream` and returns
// the launch's CUDA error.
extern "C" int lmd_row_gather_bulk(const int32_t* idx, const void* src0, void* out0,
                                   const void* src1, void* out1, const void* src2,
                                   void* out2, const void* src3, void* out3, long long x0,
                                   long long x1, long long x2, long long x3, int n_tables,
                                   int B, long long C, int grid, int lanes, void* stream) {
  if (B == 0) return 0;
  if (n_tables < 1 || n_tables > kMaxTables || B < 0 || C < 1 || grid < 1 || grid > B ||
      lanes < 1 || lanes > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  const void* srcs[kMaxTables] = {src0, src1, src2, src3};
  void* outs[kMaxTables] = {out0, out1, out2, out3};
  const long long xs[kMaxTables] = {x0, x1, x2, x3};
  Tables tabs{};
  tabs.n = n_tables;
  long long stage = 0;
  for (int t = 0; t < n_tables; ++t) {
    if (xs[t] <= 0 || xs[t] % 4 != 0 || !aligned16(srcs[t]) || !aligned16(outs[t]))
      return (int)cudaErrorInvalidValue;
    tabs.t[t] = Table{static_cast<const char*>(srcs[t]), static_cast<char*>(outs[t]),
                      4 * xs[t], (uint32_t)stage};
    stage += 4 * xs[t];
  }
  tabs.ring_off = (8u * lanes + 127u) & ~127u;
  const long long smem = tabs.ring_off + (long long)lanes * stage;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  tabs.stage_bytes = (uint32_t)stage;
  const int err = ring::allow_smem(row_gather_bulk_kernel, (size_t)smem);
  if (err) return err;
  row_gather_bulk_kernel<<<grid, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      idx, tabs, B, C, lanes);
  return (int)cudaGetLastError();
}
