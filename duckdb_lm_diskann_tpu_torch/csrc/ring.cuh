// A ring of shared-memory stages for the frontier scorers (sm_90a): each
// persistent block walks the items i = blockIdx.x, i += gridDim.x and keeps
// the next S-1 items' rows in flight while it scores the current one. An
// item is a query, or, where a scorer splits each node's block into
// `chunks` pieces (a block too large for a stage), piece i % chunks of
// query i / chunks.
//
// A scorer describes one item's stage as a few copies (a node's contiguous
// code block or a piece of it, its scales, the query row) and scores a
// stage once it has landed. Two branches move the bytes:
//
// - bulk: one thread arms the stage's full mbarrier with the byte count
//   (arrive.expect_tx) and issues one 1-D bulk copy per region
//   (cp.async.bulk ... mbarrier::complete_tx::bytes): one round trip per
//   query, no registers spent on the copy. Needs 16-byte aligned addresses
//   and sizes, so the wrapper takes it only where every table base is
//   16-byte aligned and every per-node block is a multiple of 16 bytes; a
//   query row of another size is fetched as the 16-byte window around it,
//   and the window that would pass the end of the query table (the last
//   row) is copied by the arming thread with plain loads before it arrives.
// - vector: every thread issues cp.async copies of 16 bytes where the
//   region allows it and of 4 bytes otherwise, one commit group per stage,
//   all of a query's loads issued before any is used (a ragged R, a
//   misaligned view of a table); a region that is not even 4-byte aligned
//   (an INT8 block of R*D bytes that is not a multiple of 4, a view a byte
//   off) is copied byte by byte with plain loads.
//
// A stage is refilled only after __syncthreads (every thread has finished
// reading it) and, in the bulk branch, fence.proxy.async.shared::cta, so the
// async proxy never writes a stage that a thread still reads. The k-th use
// of stage s waits for mbarrier parity k & 1.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ring {

constexpr int kMaxStages = 4;
constexpr int kMaxCopies = 4;

// One region of a stage: `bytes` from global `src` to stage offset `dst`.
// In the bulk branch `bulk` = false marks a region that the arming thread
// copies with plain 4-byte loads (the last query row's window).
struct Copy {
  const char* src;
  uint32_t dst;
  uint32_t bytes;
  bool bulk;
};

__host__ __device__ constexpr uint32_t pad16(uint32_t n) { return (n + 15u) & ~15u; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0 .. kMaxStages-1) commit groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Bulk branch, one thread: plain regions first (their stores are released
// by the arrive), then arm the barrier with the bulk bytes, then the copies.
template <class Job>
__device__ __forceinline__ void issue_bulk(const Job& job, unsigned char* stage, int b,
                                           int node, uint64_t* bar) {
  Copy c[kMaxCopies];
  const int n = job.copies(b, node, c);
  uint32_t tx = 0;
  for (int k = 0; k < n; ++k) {
    if (c[k].bulk) {
      tx += c[k].bytes;
    } else {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(c[k].src);
      uint32_t* dst = reinterpret_cast<uint32_t*>(stage + c[k].dst);
      for (uint32_t w = 0; w < c[k].bytes / 4; ++w) dst[w] = src[w];
    }
  }
  mbar_arrive_expect_tx(bar, tx);
  for (int k = 0; k < n; ++k)
    if (c[k].bulk) bulk_copy(stage + c[k].dst, c[k].src, c[k].bytes, bar);
}

// Vector branch, every thread: its share of each region (16-byte units where
// both ends are 16-byte aligned and the size a multiple of 16, else words
// where they are 4-byte aligned, else bytes by plain loads and stores,
// which the wait's __syncthreads publishes with the stage).
template <int THREADS, class Job>
__device__ __forceinline__ void issue_vector(const Job& job, unsigned char* stage, int b,
                                             int node) {
  Copy c[kMaxCopies];
  const int n = job.copies(b, node, c);
  for (int k = 0; k < n; ++k) {
    unsigned char* dst = stage + c[k].dst;
    const char* src = c[k].src;
    const uint32_t ends = (uint32_t)reinterpret_cast<uintptr_t>(src) | c[k].dst | c[k].bytes;
    if ((ends & 15) == 0) {
      for (uint32_t o = 16 * threadIdx.x; o < c[k].bytes; o += 16 * THREADS)
        cp_async16(dst + o, src + o);
    } else if ((ends & 3) == 0) {
      for (uint32_t o = 4 * threadIdx.x; o < c[k].bytes; o += 4 * THREADS)
        cp_async4(dst + o, src + o);
    } else {
      for (uint32_t o = threadIdx.x; o < c[k].bytes; o += THREADS) dst[o] = src[o];
    }
  }
}

// The persistent loop over B * chunks items (chunks = 1: item b is query
// b). `job` provides
//   bool bulk                                   the branch (uniform)
//   int copies(int item, int node, Copy* out)   the stage's regions
//   void compute(const unsigned char* stage, int item)   score, write out
// cur is read for query item / chunks and clamped into [0, C) here. Every
// thread of the block (THREADS of them) calls this.
template <int THREADS, class Job>
__device__ __forceinline__ void run(const Job& job, const int32_t* __restrict__ cur, int B,
                                    int C, int S, uint32_t stage_bytes, int chunks = 1) {
  const bool bulk = job.bulk;
  extern __shared__ __align__(128) unsigned char ring_smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  const int tid = threadIdx.x;
  const int n_items = B * chunks;
  const int n_mine =
      (int)blockIdx.x < n_items ? (n_items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  auto query = [&](int i) { return (int)blockIdx.x + i * (int)gridDim.x; };
  auto node_of = [&](int item) {
    const int n = cur[chunks == 1 ? item : item / chunks];
    return n < 0 ? 0 : (n >= C ? C - 1 : n);
  };
  auto stage = [&](int s) { return ring_smem + (size_t)s * stage_bytes; };

  if (bulk) {
    if (tid == 0) {
      for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // Lanes 0..S-1 read their item's cur together and fill one stage each.
    if (tid < S && tid < n_mine) {
      const int b = query(tid);
      issue_bulk(job, stage(tid), b, node_of(b), &full[tid]);
    }
  } else {
    int nodes[kMaxStages];
#pragma unroll
    for (int s = 0; s < kMaxStages; ++s)
      if (s < S && s < n_mine) nodes[s] = node_of(query(s));
#pragma unroll
    for (int s = 0; s < kMaxStages; ++s) {
      if (s < S) {
        if (s < n_mine) issue_vector<THREADS>(job, stage(s), query(s), nodes[s]);
        cp_async_commit();
      }
    }
  }

  for (int i = 0; i < n_mine; ++i) {
    const int s = i % S;
    const bool refill = i + S < n_mine;
    // The refill's cur is read now: its latency hides behind this item.
    int next = 0;
    if (refill && (!bulk || tid == 0)) next = node_of(query(i + S));
    if (bulk) {
      mbar_wait(&full[s], (uint32_t)(i / S) & 1u);
    } else {
      cp_async_wait(S - 1);
      __syncthreads();
    }
    job.compute(stage(s), query(i));
    __syncthreads();  // every thread is done with stage s
    if (bulk) {
      if (tid == 0 && refill) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue_bulk(job, stage(s), query(i + S), next, &full[s]);
      }
    } else {
      if (refill) issue_vector<THREADS>(job, stage(s), query(i + S), next);
      cp_async_commit();
    }
  }
}

// Allow `smem` bytes of dynamic shared memory for `kernel` where that is
// above the default 48 KB. Returns the CUDA error (0 on success).
template <class Kernel>
inline int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace ring
