// Deposit of a truly ragged entry stream into a bit tile, for Hopper (sm_90a).
//
// Replaces tools/ragged_probe.py::scalar_deposit_rate (:37, pallas_call
// :65). The TPU kernel reads (row, lane, bit) int32 triples from scalar
// memory one at a time and ORs 1 << bit into word (row, lane) of a zeroed
// (8, 128) int32 tile in VMEM: the TPU's scalar core is the only unit there
// that can consume a ragged stream. On the card every SM can, with
// shared-memory atomics, so the stream is spread over the whole card:
//   * the wrapper plans the grid (ternary_spgemm_tpu_torch/tools/
//     ragged_probe.py::deposit_plan): a multiple of kCluster blocks, up to
//     two an SM, each taking per_block consecutive entries (a multiple of
//     four; the last blocks may take fewer or none);
//   * each block zeroes its own (8, 128) tile in shared memory and reads
//     its entries with 16-byte loads, three a thread for four entries (48
//     bytes), two such groups in flight a thread. Entries before the first
//     16-byte boundary (an unaligned base: the phase is the same in every
//     block, since per_block is a multiple of four) and the last n % 4 go
//     one a thread;
//   * each entry is one shared-memory atomicOr of 1 << bit into its word;
//   * the kCluster blocks of a thread block cluster merge their tiles over
//     distributed shared memory, each block ORing one eighth of the words
//     across the cluster's tiles. A lone cluster stores its words; several
//     OR theirs into the output with global atomics, onto a tile the C
//     entry zeroes first on the same stream (cudaMemsetAsync). Atomics that
//     every block sent to the same 1,024 words would serialise at the L2
//     (csrc/stream.cu saw it), so a cluster sends one set.
// OR is associative, commutative and idempotent, so the order in which the
// blocks, warps and atomics land changes nothing: the tile is bitwise the
// plain version's, with no tolerance.
//
// What bounds it: the bytes, each entry's 12 read once and the tile's 4096
// written once, 12 n + 4096 at 3.35 TB/s. The shared-memory atomics (one an
// entry, spread over 1,024 words) sit below that at the probe's sizes; a
// stream whose entries all hit one word serialises each block's atomics on
// that word. Below ~10^6 entries a call costs what a launch of the grid,
// the memset and the clusters' merge cost (chip_smoke.py phase 10 prints
// each size's time beside its bound).
//
// ternary_scalar_deposit launches ``blocks`` blocks of ``per_block``
// entries (the plan: blocks a positive multiple of kCluster, per_block a
// positive multiple of 4, blocks * per_block >= n; else
// cudaErrorInvalidValue). Returns cudaGetLastError(); the Python wrapper
// raises on anything but 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 8;
constexpr int kLanes = 128;
constexpr int kWords = kRows * kLanes;
constexpr int kThreads = 256;
constexpr int kCluster = 8;
constexpr int kUnroll = 2;   // groups of four entries in flight a thread

__device__ __forceinline__ void deposit(unsigned* tile, int r, int c, int b) {
  atomicOr(&tile[(r & (kRows - 1)) * kLanes + (c & (kLanes - 1))],
           1u << (b & 31));
}

// four entries from their 48 bytes
__device__ __forceinline__ void deposit4(unsigned* tile, const int4& a,
                                         const int4& b, const int4& c) {
  deposit(tile, a.x, a.y, a.z);
  deposit(tile, a.w, b.x, b.y);
  deposit(tile, b.z, b.w, c.x);
  deposit(tile, c.y, c.z, c.w);
}

__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kThreads, 2)
scalar_deposit_kernel(const int* __restrict__ ents, int n, int per_block,
                      int* __restrict__ out) {
  __shared__ unsigned tile[kWords];
  const int t = threadIdx.x;
  for (int i = t; i < kWords; i += kThreads) tile[i] = 0u;
  __syncthreads();

  const long long lo = (long long)blockIdx.x * per_block;
  const long long hi = max(lo, min((long long)n, lo + per_block));
  // the first entry at a 16-byte boundary: entry e sits at byte 12 e of
  // the stream, and lo is a multiple of four
  const long long phase = (reinterpret_cast<uintptr_t>(ents) >> 2) & 3;
  const long long head = min(hi, lo + phase);
  const int groups = (int)((hi - head) >> 2);
  const long long tail = head + 4LL * groups;
  if (t < 3 && lo + t < head) {
    const int* e = ents + 3 * (lo + t);
    deposit(tile, e[0], e[1], e[2]);
  } else if (t >= 3 && t < 6 && tail + (t - 3) < hi) {
    const int* e = ents + 3 * (tail + (t - 3));
    deposit(tile, e[0], e[1], e[2]);
  }
  const int4* g = reinterpret_cast<const int4*>(ents + 3 * head);
  int i = t;
  for (; i + (kUnroll - 1) * kThreads < groups; i += kUnroll * kThreads) {
    int4 v[kUnroll][3];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        v[u][k] = __ldg(g + 3 * (size_t)(i + u * kThreads) + k);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      deposit4(tile, v[u][0], v[u][1], v[u][2]);
  }
  for (; i < groups; i += kThreads) {
    const int4* q = g + 3 * (size_t)i;
    deposit4(tile, __ldg(q), __ldg(q + 1), __ldg(q + 2));
  }

  // every tile of the cluster complete and visible to the cluster
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  constexpr int kSlice = kWords / kCluster;
  const int w = (int)cluster.block_rank() * kSlice + t;
  if (t < kSlice) {
    unsigned v = 0u;
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      v |= cluster.map_shared_rank(tile, r)[w];
    if (gridDim.x == kCluster)
      out[w] = (int)v;
    else if (v)
      atomicOr(out + w, (int)v);
  }
  // no block leaves while another reads its tile
  cluster.sync();
}

}  // namespace

extern "C" int ternary_scalar_deposit(const int* ents, int n, int blocks,
                                      int per_block, int* out, void* stream) {
  if (n < 0 || blocks <= 0 || blocks % kCluster || per_block <= 0
      || per_block % 4 || (long long)blocks * per_block < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > kCluster) {
    const cudaError_t err = cudaMemsetAsync(out, 0, kWords * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  scalar_deposit_kernel<<<blocks, kThreads, 0, s>>>(ents, n, per_block, out);
  return (int)cudaGetLastError();
}
