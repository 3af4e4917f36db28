// Decode-rate probe of the bitplane core, for Hopper (sm_90a).
//
// Replaces tools/decode_roofline.py::measure_decode_rate (:32, its kernel
// :47-64). The TPU probe times the magic-multiply bit deposit of its Pallas
// kernels on a VMEM-resident plane tile. What this port's kernels run is
// bitplane_core.cuh's decode: load_row (the pos and neg bytes of a byte-row)
// and decode_half (four weights a half), each weight then multiplied into
// MT rows of staged activations. So this probe times that
// sequence on a shared-memory-resident tile, with no device-memory traffic
// in the timed loop:
//   * the (2*tkb, tns) uint8 plane tile and an (8, B = 8*tkb) int32 X are
//     staged in shared memory once;
//   * repetition r decodes the tile perturbed as (p + r) & 0xFF (as the TPU
//     probe does, so that no repetition can be hoisted or folded), and
//     every decoded weight is consumed by an int32 multiply-add into each of
//     the 8 rows, the core's inner loop at an M-tile of 8:
//       out[m, n] = sum_r sum_k X[m, k] * W_r[k, n],
//     W_r the tile's dense weights (row h*4*tkb + 4t + j of byte-row t, as
//     the core maps them);
//   * one thread a column, 256 threads a block; every block computes the
//     whole (8, tns) result from the same tile and stores it (all blocks
//     store the same values), so a launch of ``blocks`` blocks measures
//     ``blocks`` SMs at one block each (the tile and X take 160 KB of shared
//     memory at tkb = 128: one block an SM).
//
// What bounds it: instruction issue (two byte loads, two perturbations and
// ~12 decode operations a byte-row and lane, then eight 16-byte shared loads
// and 32 multiply-adds a half), the quantity it measures.
//
// Returns cudaGetLastError() (or the error of the shared-memory attribute,
// for a tile that does not fit); the Python wrapper raises on anything but 0.

#include "bitplane_core.cuh"

namespace {

constexpr int kDecodeRows = 8;

__global__ void __launch_bounds__(ternary::kThreads)
decode_rate_kernel(const uint8_t* __restrict__ plane, int tkb, int tns,
                   const int* __restrict__ x, int reps, int* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = 8 * tkb;
  int* xs = reinterpret_cast<int*>(smem);                     // (8, B)
  uint8_t* ps = smem + sizeof(int) * kDecodeRows * B;         // (2*tkb, tns)
  for (int i = threadIdx.x; i < kDecodeRows * B; i += blockDim.x) xs[i] = x[i];
  for (int i = threadIdx.x; i < 2 * tkb * tns; i += blockDim.x) ps[i] = plane[i];
  __syncthreads();

  const size_t neg_off = (size_t)tkb * tns;
  for (int n = threadIdx.x; n < tns; n += blockDim.x) {
    int acc[kDecodeRows];
#pragma unroll
    for (int m = 0; m < kDecodeRows; ++m) acc[m] = 0;
    for (int r = 0; r < reps; ++r) {
#pragma unroll 4
      for (int t = 0; t < tkb; ++t) {
        uint2 raw = ternary::load_row(ps, (size_t)t * tns + n, neg_off);
        raw.x = (raw.x + (unsigned)r) & 0xFFu;
        raw.y = (raw.y + (unsigned)r) & 0xFFu;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int w[4];
          ternary::decode_half(raw, h, w);
#pragma unroll
          for (int m = 0; m < kDecodeRows; ++m) {
            const int4 xv = *reinterpret_cast<const int4*>(
                &xs[m * B + h * 4 * tkb + 4 * t]);
            acc[m] += w[0] * xv.x + w[1] * xv.y + w[2] * xv.z + w[3] * xv.w;
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kDecodeRows; ++m) out[(size_t)m * tns + n] = acc[m];
  }
}

}  // namespace

extern "C" int ternary_decode_rate(const uint8_t* plane, int tkb, int tns,
                                   const int* x, int reps, int blocks,
                                   int* out, void* stream) {
  if (tkb < 1 || tns < 1 || reps < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * kDecodeRows * 8 * (size_t)tkb
                      + 2 * (size_t)tkb * tns;
  int err = (int)cudaFuncSetAttribute(
      decode_rate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != 0) return err;
  decode_rate_kernel<<<blocks, ternary::kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      plane, tkb, tns, x, reps, out);
  return (int)cudaGetLastError();
}
