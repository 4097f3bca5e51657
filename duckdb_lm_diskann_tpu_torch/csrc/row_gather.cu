// Row gather for Hopper (sm_90a): out_t[b] = src_t[clamp(idx[b], 0, C-1)]
// for one table (t = 0) or up to four tables that share the index, in one
// launch.
//
// Replaces the TPU kernels of the hop profiler
//   benchmarks/profile_hop.py:251 _pipelined_gather  (one combined table,
//     a ring of K HBM->HBM row DMAs in flight over a sequential grid) and
//   benchmarks/profile_hop.py:313 _pipelined_gather4 (the same index over
//     four SoA tables, four DMAs per row sharing one semaphore slot).
// Both compute the same function, so one kernel serves both.
//
// Contract:
//   idx      i32[B]                   row per output (clamped into [0, C))
//   src_t    i32[C, X_t]              u32 bits stored as int32
//   out_t    i32[B, X_t]
//   n_flight rows whose loads a thread has in flight before its first store
//            (4, 8 or 16, the depths the hop profiler measures)
//
// What bounds it: pure data movement. At B = 1024, X = 1280 words it reads
// 5.24 MB of scattered 5,120-byte rows and writes 5.24 MB: ~3.13 us at the
// H100's 3.35 TB/s. Reaching that needs several MB of loads in flight
// (Little's law: ~1 us of HBM latency x 3.35 TB/s), which the TPU kernel got
// from its DMA ring.
//
// Design: a parallel grid in place of the sequential one. The rows are cut
// into groups of n_flight; each thread owns one column unit (16 bytes, or 4
// bytes where the table does not allow 16) of every row of its group, and
// neighbouring threads own neighbouring units of the same rows, so loads
// and stores are coalesced. A thread issues the n_flight loads (unrolled,
// staged in registers) before its first store, so at B = 1024, X = 1280 the
// whole gather (B * X * 4 bytes) is in flight at once from ~1024 / n_flight
// * 320 threads. 16-byte units (uint4) are used where X_t % 4 == 0 and both
// pointers are 16-byte aligned; 4-byte words otherwise (a ragged X). Row
// offsets are 64-bit: a 2^20 x 1280-word table holds 1.34e9 words, and a row
// index above ~1.6M would wrap a 32-bit offset. The launch geometry is
// mirrored by the wrapper's plan (kernels/_build.py, gather_plan; kThreads
// is row_gather.py's THREADS).
//
// A bulk-copy design (each row through shared memory by 1-D cp.async.bulk
// loads and stores on mbarrier stages, experiments/row_gather_bulk.cu) was
// timed beside this copy (experiments/row_gather_ab.py, PERF.md): faster at
// B = 256, level at 1024 and 4096, slower at 16,384, and never faster than
// index_select at B <= 1024. It is not faster at every size, so this copy
// stays.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // kernels/row_gather.py: THREADS
constexpr int kMaxTables = 4;

struct Table {
  const void* src;
  void* out;
  long long units;  // per row, in 16-byte units if vec, else 4-byte words
  int vec;
};

struct Tables {
  Table t[kMaxTables];
  long long start[kMaxTables + 1];  // prefix sums of units: a group's work
  int n;
};

template <int NF, typename T>
__device__ __forceinline__ void copy_unit(const Table& tab, const int32_t* __restrict__ idx,
                                          long long group, long long c, int B, long long C) {
  const T* __restrict__ src = static_cast<const T*>(tab.src);
  T* __restrict__ out = static_cast<T*>(tab.out);
  const long long w = tab.units;
  T v[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const long long b = group * NF + j;
    if (b < B) {
      long long r = idx[b];
      r = r < 0 ? 0 : (r >= C ? C - 1 : r);
      v[j] = src[r * w + c];
    }
  }
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const long long b = group * NF + j;
    if (b < B) out[b * w + c] = v[j];
  }
}

template <int NF>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const int32_t* __restrict__ idx, Tables tabs, int B, long long C,
                  long long total) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= total) return;
  const long long per_group = tabs.start[tabs.n];
  const long long group = g / per_group;
  const long long u_all = g - group * per_group;
  // The table this unit belongs to (constant indices only, so the
  // parameter struct is never copied to local memory).
  Table tab = tabs.t[0];
  long long u = u_all;
#pragma unroll
  for (int i = 1; i < kMaxTables; ++i) {
    if (i < tabs.n && u_all >= tabs.start[i]) {
      tab = tabs.t[i];
      u = u_all - tabs.start[i];
    }
  }
  if (tab.vec)
    copy_unit<NF, uint4>(tab, idx, group, u, B, C);
  else
    copy_unit<NF, int32_t>(tab, idx, group, u, B, C);
}

template <int NF>
cudaError_t launch(const int32_t* idx, const Tables& tabs, int B, long long C,
                   cudaStream_t st) {
  const long long groups = (B + NF - 1) / NF;
  const long long total = groups * tabs.start[tabs.n];
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  row_gather_kernel<NF><<<(unsigned)blocks, kThreads, 0, st>>>(idx, tabs, B, C, total);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Plain C entry point (loaded with ctypes). Tables 0..n_tables-1 are used;
// src/out of the others may be null. Launches on `stream` and returns the
// launch's CUDA error (cudaErrorInvalidValue for a bad n_flight or count).
extern "C" int lmd_row_gather(const int32_t* idx, const void* src0, void* out0,
                              const void* src1, void* out1, const void* src2,
                              void* out2, const void* src3, void* out3,
                              long long x0, long long x1, long long x2,
                              long long x3, int n_tables, int B, long long C,
                              int n_flight, void* stream) {
  if (B == 0) return 0;
  if (n_tables < 1 || n_tables > kMaxTables || B < 0 || C < 1)
    return (int)cudaErrorInvalidValue;
  const void* srcs[kMaxTables] = {src0, src1, src2, src3};
  void* outs[kMaxTables] = {out0, out1, out2, out3};
  const long long xs[kMaxTables] = {x0, x1, x2, x3};
  Tables tabs{};
  tabs.n = n_tables;
  tabs.start[0] = 0;
  for (int t = 0; t < n_tables; ++t) {
    const bool vec = xs[t] % 4 == 0 && aligned16(srcs[t]) && aligned16(outs[t]);
    tabs.t[t] = Table{srcs[t], outs[t], vec ? xs[t] / 4 : xs[t], vec ? 1 : 0};
    tabs.start[t + 1] = tabs.start[t] + tabs.t[t].units;
  }
  for (int t = n_tables; t < kMaxTables; ++t) tabs.start[t + 1] = tabs.start[t];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_flight) {
    case 4: return (int)launch<4>(idx, tabs, B, C, st);
    case 8: return (int)launch<8>(idx, tabs, B, C, st);
    case 16: return (int)launch<16>(idx, tabs, B, C, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
