// Beam merge of one search hop for Hopper (sm_90a): for every lane b, the
// R candidates of each of the E nodes the hop visited are tested against
// the lane's beam and its visited seeds, the survivors are merged into the
// (distance, slot)-sorted beam, and the best L entries are written back
// over the beam row, in place.
//
// Replaces no TPU kernel. The JAX package leaves this step to XLA's sort
// (duckdb_lm_diskann_tpu/ops/topk.py::merge_beams inside its jitted hop).
// The port's hop runs eagerly, one PyTorch launch per operation, and the
// merge was about 30 of them a hop (membership compares and reductions,
// masks, two stable radix sorts and their gathers): the hop is bound by the
// host issuing launches, not by the card. This kernel is the whole merge in
// one launch.
//
// Contract (kernels/beam_merge.py, beam_merge_plain, the same function):
//   beam_dist f32[B, L], beam_slot i32[B, L], beam_vis u8[B, L]  in and out
//   nbrs      i32[B, C]   C = E * R candidate slots (the E nodes' rows)
//   edge_dist f32[B, C]   their approximate distances
//   live      u8[B, C]    the candidate's edge exists and its node is live
//   seeds     i32[B, S], seed_vis u8[B, S]  the lane's seeds, visited flags
//   dedup     E > 1: of candidates that share a slot keep the one first in
//             (distance, input position) order
// A candidate is kept iff live, its slot is not a slot >= 0 of the beam and
// not a visited seed; a rejected one becomes (+inf, -1). The beam (first)
// and the candidates (after it) are ordered lexicographically by
// (distance, slot) as torch's stable sort orders them: -0.0 and +0.0 tie,
// every NaN ties with every other NaN and follows +inf, and entries that
// tie on both keep input order. With dedup, each later copy of a slot
// becomes (+inf, -1) where the copies were sorted by (slot, distance,
// position), and such entries follow, at equal (distance, slot), the
// entries that had slot -1 from the start, among themselves in that sorted
// order: the plain form's two stable passes. The visited flags ride with
// their entries (candidates carry 0), and every +inf or -inf entry that
// lands in the first L gets slot -1. No value is computed, only compared
// and moved, so the output is bit-identical to the plain form's.
//
// What bounds it: nothing of the card's. A lane moves under 3 KB (at L =
// 100, C = 64: 2,381 bytes read and written, 2.44 MB over B = 1,024,
// ~0.73 us at 3.35 TB/s). The work is the merge's compares.
//
// Design: one block of 256 threads per lane, everything in shared memory.
// The beam, the candidate slots and the seeds are loaded once; the
// membership test spreads the C x (L + S) compares over the block (each
// candidate's compares cut into G = 256 / C interleaved runs, whose
// threads read one beam entry at a time, a broadcast). Each entry then
// takes its rank by counting the n = L + C entries before it in the order
// above: a 64-bit key (order-preserving distance bits, biased slot bits)
// and the input position break every tie, so the ranks are a permutation
// and each output position has one writer. With dedup a first pass ranks
// by (slot, distance, position) to mark the later copies and record the
// order among them, and the second ranks by the final keys. Every entry
// whose rank is below L writes its row position; all reads of the row
// precede the first barrier, so writing in place is safe, and nothing is
// allocated.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // kernels/beam_merge.py: THREADS
constexpr size_t kMaxShared = 232448;      // kernels/_build.py: BLOCK_SHARED_BYTES
constexpr size_t kDefaultShared = 48 * 1024;

// Dynamic shared memory of one block (kernels/beam_merge.py: smem_bytes):
// two u64 keys, distance, slot and tie per entry, C reject flags, S seed
// slots, then a visited byte per entry and per seed.
size_t smem_bytes(int L, int C, int S) {
  const size_t n = (size_t)L + C;
  return n * (8 + 8 + 4 + 4 + 4) + (size_t)C * 4 + (size_t)S * 4 + n + S;
}

// torch.sort's ascending order of a float as an unsigned key.
__device__ __forceinline__ uint32_t dist_key(float d) {
  if (d != d) return 0xFFFFFFFFu;        // NaN: after +inf, all equal
  if (d == 0.0f) return 0x80000000u;      // -0.0 == +0.0
  const uint32_t b = __float_as_uint(d);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ uint32_t slot_key(int32_t s) {
  return (uint32_t)s ^ 0x80000000u;
}

__device__ __forceinline__ bool before(uint64_t kj, int tj, uint64_t ki, int ti) {
  return (kj < ki) | ((kj == ki) & (tj < ti));
}

template <bool kDedup>
__global__ void __launch_bounds__(kThreads)
beam_merge_kernel(float* __restrict__ beam_dist, int32_t* __restrict__ beam_slot,
                  uint8_t* __restrict__ beam_vis, const int32_t* __restrict__ nbrs,
                  const float* __restrict__ edge_dist, const uint8_t* __restrict__ live,
                  const int32_t* __restrict__ seeds, const uint8_t* __restrict__ seed_vis,
                  int L, int C, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = L + C;
  uint64_t* key = reinterpret_cast<uint64_t*>(smem);
  uint64_t* key2 = key + n;
  float* dist = reinterpret_cast<float*>(key2 + n);
  int32_t* slot = reinterpret_cast<int32_t*>(dist + n);
  int32_t* tie = slot + n;
  int32_t* rej = tie + n;
  int32_t* seed = rej + C;
  uint8_t* vis = reinterpret_cast<uint8_t*>(seed + S);
  uint8_t* svis = vis + n;

  const long long b = blockIdx.x;
  float* row_dist = beam_dist + b * L;
  int32_t* row_slot = beam_slot + b * L;
  uint8_t* row_vis = beam_vis + b * L;
  const int tid = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);

  for (int i = tid; i < L; i += kThreads) {
    dist[i] = row_dist[i];
    slot[i] = row_slot[i];
    vis[i] = row_vis[i];
  }
  for (int c = tid; c < C; c += kThreads) {
    slot[L + c] = nbrs[b * C + c];
    rej[c] = 0;
  }
  for (int s = tid; s < S; s += kThreads) {
    seed[s] = seeds[b * S + s];
    svis[s] = seed_vis[b * S + s];
  }
  __syncthreads();

  // Membership: candidate c against the beam's slots >= 0 and the visited
  // seeds, in G interleaved runs.
  const int G = C < kThreads ? kThreads / C : 1;
  for (int w = tid; w < C * G; w += kThreads) {
    const int c = w % C, g = w / C;
    const int32_t v = slot[L + c];
    bool hit = false;
    for (int l = g; l < L; l += G) {
      const int32_t s = slot[l];
      hit |= (s >= 0) & (s == v);
    }
    for (int s = g; s < S; s += G) hit |= (svis[s] != 0) & (seed[s] == v);
    if (hit) rej[c] = 1;
  }
  __syncthreads();

  for (int c = tid; c < C; c += kThreads) {
    const bool ok = live[b * C + c] != 0 && rej[c] == 0;
    dist[L + c] = ok ? edge_dist[b * C + c] : inf;
    if (!ok) slot[L + c] = -1;
    vis[L + c] = 0;
  }
  __syncthreads();

  for (int i = tid; i < n; i += kThreads) {
    const uint64_t dk = dist_key(dist[i]), sk = slot_key(slot[i]);
    key[i] = kDedup ? (sk << 32 | dk) : (dk << 32 | sk);
  }
  __syncthreads();

  const uint64_t* rank_key = key;
  if (kDedup) {
    // Pass 1 in (slot, distance, position) order: an entry with slot >= 0
    // and an earlier entry of the same slot is a later copy.
    const uint64_t dropped = (uint64_t)dist_key(inf) << 32 | slot_key(-1);
    for (int i = tid; i < n; i += kThreads) {
      const uint64_t ki = key[i];
      const uint32_t si = (uint32_t)(ki >> 32);
      int r = 0;
      bool copy = false;
      for (int j = 0; j < n; ++j) {
        const uint64_t kj = key[j];
        const bool less = before(kj, j, ki, i);
        r += less;
        copy |= less & ((uint32_t)(kj >> 32) == si);
      }
      copy &= slot[i] >= 0;
      if (copy) {
        dist[i] = inf;
        slot[i] = -1;
      }
      key2[i] = copy ? dropped : ((uint64_t)dist_key(dist[i]) << 32 | slot_key(slot[i]));
      tie[i] = copy ? n + r : i;
    }
    __syncthreads();
    rank_key = key2;
  }

  for (int i = tid; i < n; i += kThreads) {
    const uint64_t ki = rank_key[i];
    const int ti = kDedup ? tie[i] : i;
    int r = 0;
    for (int j = 0; j < n; ++j) r += before(rank_key[j], kDedup ? tie[j] : j, ki, ti);
    if (r < L) {
      const float d = dist[i];
      row_dist[r] = d;
      row_slot[r] = isinf(d) ? -1 : slot[i];
      row_vis[r] = vis[i];
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches one block per lane on
// `stream` and returns the launch's CUDA error (cudaErrorInvalidValue for a
// bad size or a lane too large for shared memory).
extern "C" int lmd_beam_merge(float* beam_dist, int32_t* beam_slot, uint8_t* beam_vis,
                              const int32_t* nbrs, const float* edge_dist,
                              const uint8_t* live, const int32_t* seeds,
                              const uint8_t* seed_vis, int B, int L, int C, int S,
                              int dedup, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || L < 1 || C < 1 || S < 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(L, C, S);
  if (bytes > kMaxShared) return (int)cudaErrorInvalidValue;
  void (*kernel)(float*, int32_t*, uint8_t*, const int32_t*, const float*, const uint8_t*,
                 const int32_t*, const uint8_t*, int, int, int) =
      dedup ? beam_merge_kernel<true> : beam_merge_kernel<false>;
  if (bytes > kDefaultShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)B, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      beam_dist, beam_slot, beam_vis, nbrs, edge_dist, live, seeds, seed_vis, L, C, S);
  return (int)cudaGetLastError();
}
