// Scalar-deposit probe of a truly ragged entry stream, for Hopper (sm_90a).
//
// Replaces tools/ragged_probe.py::scalar_deposit_rate (:37, pallas_call
// :65). The TPU kernel reads (row, lane, bit) int32 triples from scalar
// memory one at a time and ORs 1 << bit into word (row, lane) of a zeroed
// (8, 128) int32 tile in VMEM: a dependent read-modify-write per entry, the
// best rate any consumer of a per-column ragged stream can reach. Here:
//   * one block; warps 1-7 stage the (n, 3) int32 entries from device memory
//     into shared memory in chunks of 4096, each triple packed into one word
//     (row: 3 bits, lane: 7 bits, bit: 5 bits), double-buffered so that the
//     next chunk is staged while the current one is walked. 4096 triples
//     unpacked would take 48 KB, the whole static shared memory; packed, two
//     chunks and the tile take 36 KB, and any n streams through them;
//   * thread 0 walks the chunk's entries in order, a shared-memory load, an
//     OR and a store per entry on the shared-memory tile (each entry's word
//     loaded one entry ahead, off that chain).
//     Entries that hit the same word depend on each other through
//     that word, and that dependence is what the probe measures, so the walk
//     stays serial (the compiler cannot reorder the tile's loads and stores,
//     whose addresses come from the data);
//   * then the tile is written out.
//
// What bounds it: the latency of a dependent shared-memory load, OR and
// store per entry on one thread; the bytes (12 an entry, read once)
// are far below it.
//
// Returns cudaGetLastError(); the Python wrapper raises on anything but 0.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;
constexpr int kLanes = 128;
constexpr int kChunk = 4096;
constexpr int kThreads = 256;
constexpr int kLoaders = kThreads - 32;   // warps 1-7

__device__ __forceinline__ unsigned pack_entry(const int* e) {
  return (unsigned)(e[0] & 7) | ((unsigned)(e[1] & 127) << 3)
         | ((unsigned)(e[2] & 31) << 10);
}

__device__ __forceinline__ void stage_chunk(const int* __restrict__ ents,
                                            int n, int chunk, unsigned* dst) {
  const int base = chunk * kChunk;
  const int m = min(kChunk, n - base);
  for (int i = (int)threadIdx.x - 32; i < m; i += kLoaders)
    dst[i] = pack_entry(ents + 3 * ((size_t)base + i));
}

__global__ void __launch_bounds__(kThreads)
scalar_deposit_kernel(const int* __restrict__ ents, int n,
                      int* __restrict__ out) {
  __shared__ unsigned stage[2][kChunk];
  __shared__ unsigned tile[kRows * kLanes];
  for (int i = threadIdx.x; i < kRows * kLanes; i += kThreads) tile[i] = 0u;
  const int chunks = (n + kChunk - 1) / kChunk;
  const bool loader = threadIdx.x >= 32;
  if (loader && chunks > 0) stage_chunk(ents, n, 0, stage[0]);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const unsigned* cur = stage[c & 1];
    const int m = min(kChunk, n - c * kChunk);
    if (loader) {
      if (c + 1 < chunks) stage_chunk(ents, n, c + 1, stage[(c + 1) & 1]);
    } else if (threadIdx.x == 0 && m > 0) {
      // the next entry's word is loaded before this entry's deposit, so
      // that only the tile's read-modify-write chain is serial (the TPU
      // reads its entries from scalar memory, off that chain)
      unsigned w = cur[0];
      for (int i = 0; i < m; ++i) {
        const unsigned next = cur[min(i + 1, m - 1)];
        tile[(w & 7u) * kLanes + ((w >> 3) & 127u)] |= 1u << (w >> 10);
        w = next;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < kRows * kLanes; i += kThreads)
    out[i] = (int)tile[i];
}

}  // namespace

extern "C" int ternary_scalar_deposit(const int* ents, int n, int* out,
                                      void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  scalar_deposit_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ents, n, out);
  return (int)cudaGetLastError();
}
