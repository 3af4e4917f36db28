// Device-memory streaming probe, for Hopper (sm_90a).
//
// Replaces tools/membench.py::stream_rate (:84, bodies _stream_kernel_4d /
// _stream_kernel_2d :62-81). The TPU kernel DMAs every (tk, tn) tile of an
// int8 array through VMEM, one sequential grid step a tile, and
// wraparound-adds the tile's int32 words into an (8, 128) checksum, so that
// no byte can be elided. Here a tile is cut into steps of 4096 bytes (256
// threads, 16 bytes each, neighbouring threads on neighbouring addresses),
// and each block of 256 threads reads a run of steps of one tile, so that
// the block count fits the card whatever the tile count: about two an SM
// (``sms``, the card's count, from the wrapper), none with fewer than
// kMinSteps steps unless its tile is shorter, the runs of a tile as even
// as the steps allow. Every 32-bit
// word is wraparound-added into one of 1,024 buckets, the word's flat index
// modulo 1024. The checksum is thus a function of the array's bytes alone,
// the same for both layouts and any cut, and it is an output the caller
// compares: nothing the kernel reads is dead.
//   layout 0, tiled4d: (gk, gn, tk, tn), a tile is tk * tn contiguous bytes
//     (a multiple of 4096);
//   layout 1, rowmajor: (gk * tk, gn * tn), a tile is tk rows of tn bytes
//     (tn a multiple of 4096) gn * tn bytes apart.
// Either way a step lies within one tile row and starts at a multiple of
// 4096 bytes, so thread t's loads all lie at 16 t modulo 4096 and it keeps
// the four buckets 4t .. 4t + 3 in registers.
//
// What bounds it: the array's bytes at the card's memory rate. Eight loads
// are in flight a thread (the loop is unrolled by eight), 32 KB a block,
// and about two blocks an SM: more than the rate needs at the card's
// latency. A block's buckets go out as atomics, and atomics on one address
// serialise: with one copy of the buckets and ~1,000 blocks a 16 MB pass
// took 56 us, 0.30 TB/s (H100 80GB HBM3, 700 W; tools/membench.py). So
// the blocks add into ``replicas`` copies (block b into copy b % replicas),
// and a second launch folds the copies into the output.
//
// ternary_stream_rate zeroes ``scratch`` (replicas x 1,024 int32 from the
// wrapper) and adds the checksum into ``out`` (1,024 int32, which the
// caller fills first). Returns cudaGetLastError() (or
// cudaErrorInvalidValue for a geometry the buckets do not fit); the Python
// wrapper raises on anything but 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStreamThreads = 256;
constexpr int kStepQuads = kStreamThreads;   // 4096 bytes a step
constexpr int kBuckets = 1024;
constexpr size_t kMinSteps = 16;

__global__ void __launch_bounds__(kStreamThreads)
stream_kernel(const uint4* __restrict__ a, int gn, int tk, int tn, int layout,
              int chunk, int splits, int replicas, unsigned* scratch) {
  const int t = threadIdx.x;
  const size_t tile = blockIdx.x / splits;
  const int part = (int)(blockIdx.x - tile * splits);
  const size_t i = tile / gn, j = tile - i * gn;
  const size_t qpr = (size_t)tn / 16;             // quads a tile row
  const int steps = (int)((size_t)tk * qpr / kStepQuads);
  const int s0 = part * chunk, n = min(chunk, steps - s0);
  // a tile as rows of ``row`` quads, ``pitch`` quads apart: tiled4d rows
  // are the steps themselves, back to back; rowmajor rows are the tile's
  const uint4* p;
  size_t row, pitch;
  if (layout == 0) {
    p = a + tile * steps * kStepQuads;
    row = pitch = kStepQuads;
  } else {
    p = a + i * tk * gn * qpr + j * qpr;
    row = qpr;
    pitch = gn * qpr;
  }
  const size_t first = (size_t)s0 * kStepQuads;   // the run's first quad
  size_t r = first / row, c = first - r * row + t;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 8
  for (int k = 0; k < n; ++k) {
    const uint4 v = __ldg(p + r * pitch + c);
    acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    c += kStepQuads;
    if (c >= row) { c -= row; ++r; }
  }
  unsigned* o = scratch + (size_t)(blockIdx.x % replicas) * kBuckets + 4 * t;
  atomicAdd(o, acc.x);
  atomicAdd(o + 1, acc.y);
  atomicAdd(o + 2, acc.z);
  atomicAdd(o + 3, acc.w);
}

// out[q] += the sum of the copies of bucket q (one thread a bucket)
__global__ void __launch_bounds__(kStreamThreads)
fold_kernel(const unsigned* scratch, int replicas, unsigned* out) {
  const int q = blockIdx.x * kStreamThreads + threadIdx.x;
  unsigned s = 0;
  for (int k = 0; k < replicas; ++k) s += scratch[(size_t)k * kBuckets + q];
  out[q] += s;
}

}  // namespace

extern "C" int ternary_stream_rate(const int8_t* arr, int gk, int gn, int tk,
                                   int tn, int layout, int sms, int* scratch,
                                   int replicas, int* out, void* stream) {
  const bool fits = layout == 0 ? ((size_t)tk * tn) % 4096 == 0
                                : layout == 1 && tn % 4096 == 0;
  if (!fits || gk < 1 || gn < 1 || tk < 1 || tn < 16 || sms < 1 ||
      replicas < 1 || reinterpret_cast<uintptr_t>(arr) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t tiles = (size_t)gk * gn, steps = (size_t)tk * tn / 4096;
  const size_t target = 2 * (size_t)sms;       // blocks: two an SM
  size_t chunk = (tiles * steps + target - 1) / target;
  chunk = chunk < kMinSteps ? kMinSteps : chunk;
  chunk = chunk > steps ? steps : chunk;
  const size_t splits = (steps + chunk - 1) / chunk;
  chunk = (steps + splits - 1) / splits;       // even runs within a tile
  if (tiles * splits > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* rep = reinterpret_cast<unsigned*>(scratch);
  int err = (int)cudaMemsetAsync(rep, 0, sizeof(unsigned) * kBuckets *
                                 (size_t)replicas, s);
  if (err != 0) return err;
  stream_kernel<<<(unsigned)(tiles * splits), kStreamThreads, 0, s>>>(
      reinterpret_cast<const uint4*>(arr), gn, tk, tn, layout, (int)chunk,
      (int)splits, replicas, rep);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  fold_kernel<<<kBuckets / kStreamThreads, kStreamThreads, 0, s>>>(
      rep, replicas, reinterpret_cast<unsigned*>(out));
  return (int)cudaGetLastError();
}
