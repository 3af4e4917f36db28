// Y = bf16(X) . W + b [PReLU] over the TiledBitplane container, for Hopper
// (sm_90a).
//
// Replaces ternary_spgemm_tpu/ops/pallas_kernels.py::
// pallas_tiled_bitplane_bf16_kernel (:1602, body _tiled_bitplane_b16_kernel
// :1572): X cast to bf16 (round to nearest even), the planes decoded to
// {-1, 0, +1}, one bf16 dot with f32 accumulation on the TPU's matrix unit,
// f32 epilogue. Here the same product runs on dense_mma.cuh's bf16
// tensor-core tile (mma.sync m16n8k16) over its Bitplane layout: a chunk of
// KQ byte-rows of a slab stages two runs of 4*KQ X columns (the low half of
// the K-block's rows and the high half, 4*tkb rows on), each rounded to one
// bf16 piece (kStageBf16), and decodes the pos and neg bytes of each column
// into the eight int8 weight rows of the two runs, pbit | 0xFF * nbit, as
// it stages them. The products are exact (w is +-1 or 0) and the sums f32:
// groups of kSumSteps k-steps by the tensor cores, added on the CUDA cores,
// in a fixed order. X is neither floored nor clamped: the kernel takes any
// float, and the rounding to bf16 is its only approximation. On integer X
// with |x| <= 256 every value and partial sum is an exact f32 integer, so
// the result is bitwise the plain version's (ops/cuda_kernels.py);
// elsewhere the two differ only in f32 summation order. Each run is masked
// at tkb (16 byte-rows for K <= 128, under the Narrow tiles' 32-byte-row
// chunk) and at K (the container pads K to nb*8*tkb), a k-step past either
// skipped.
//
// What bounds it: at the north star the 2 bits a weight of device memory,
// under the latency of the chunks each block walks in series; at M = 512
// the one tensor-core pass (dense_mma.cuh).
//
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a geometry that
// does not hold K and N; the Python wrapper raises on anything but 0.

#include "dense_mma.cuh"

namespace dmma = ternary::dmma;

extern "C" int ternary_bitplane_bf16(const float* x, int M, int K,
                                     const uint8_t* plane, int nb, int gn,
                                     int tkb, int tile_n, int N,
                                     const float* bias, const float* alpha,
                                     float* y, void* stream) {
  return dmma::run_slabs<ternary::kStageBf16, dmma::Bitplane>(
      x, M, K, plane, nb, gn, tkb, tile_n, N, bias, alpha, y, stream);
}
