// Y = X . W + b [PReLU] over the stride-packed containers PackedTernary2Bit
// and PackedTernary53, f32 X as it is, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of ternary_spgemm_tpu/ops/pallas_kernels.py:
//   * pallas_packed2_kernel (:264) and pallas_packed53_kernel (:275), body
//     _packed_kernel (:190): decode the 2-bit (factor 4) or base-3 (factor
//     5) codes of a (Kq, N) uint8 plane, then one f32 dot per field at
//     precision HIGHEST, which the TPU runs as multi-pass bf16 products.
// So does this kernel: dense_mma.cuh's bf16 tensor-core tile (mma.sync
// m16n8k16) over the slab layout with one slab (Slabs<4>, Slabs<5>: the
// wrapper passes nb = gn = 1, tkq = Kq, tile_n = N), the codes decoded as
// a chunk is staged, f32 X split as it is staged into three bf16 pieces
// that sum back to it exactly (kStageF32, as CudaDense), three passes with
// every product exact and the sums in f32 in a fixed order (groups of
// kSumSteps k-steps summed by the tensor cores, added on the CUDA cores):
// deterministic, and bitwise the plain version's on integer X (every
// partial sum an exact f32 integer). K pads only to factor*Kq, and a
// field's Kq rows are rarely a multiple of 16: each field's run is masked
// at Kq and at K, a k-step past either skipped. At factor 5 a chunk's 20
// k-steps split raggedly over the Narrow tiles' 8 warps and the Wide
// tile's 10 fall into groups of 4, 4 and 2 (dense_mma.cuh's Chunk). The
// i8 forms of these kernels (pallas_packed2_i8_kernel :502,
// pallas_packed53_i8_kernel :513) are the kStageI8 instantiations of the
// same walk (blockpacked.cu).
//
// What bounds it: at the north star 2 (factor 4) or 1.6 (factor 5) bits a
// weight of device memory, under the latency of the chunks each block
// walks in series; at M = 512 the three tensor-core passes (dense_mma.cuh).
//
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a factor other
// than 4 or 5 or a geometry that does not hold K and N; the Python wrapper
// raises on anything but 0.

#include "dense_mma.cuh"

namespace dmma = ternary::dmma;

extern "C" int ternary_packed_f32(const float* x, int M, int K,
                                  const uint8_t* packed, int nb, int gn,
                                  int tkq, int tile_n, int factor, int N,
                                  const float* bias, const float* alpha,
                                  float* y, void* stream) {
  if (factor == 4)
    return dmma::run_slabs<ternary::kStageF32, dmma::Slabs<4>>(
        x, M, K, packed, nb, gn, tkq, tile_n, N, bias, alpha, y, stream);
  if (factor == 5)
    return dmma::run_slabs<ternary::kStageF32, dmma::Slabs<5>>(
        x, M, K, packed, nb, gn, tkq, tile_n, N, bias, alpha, y, stream);
  return (int)cudaErrorInvalidValue;
}
