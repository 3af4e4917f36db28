// Y = i8(X) . W + b [PReLU] over the block-packed containers
// (BlockPackedTernary, TiledBlockPacked), for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of ternary_spgemm_tpu/ops/pallas_kernels.py:
//   * pallas_blockpacked_i8_kernel (:596, body _blockpacked_i8_kernel :553,
//     decode _decode_block :530) over BlockPackedTernary (nb*tile_kq, N)
//     uint8: the wrapper passes gn = 1, tile_n = N;
//   * pallas_tiled_blockpacked_i8_kernel (:886, _tiled_blockpacked_i8(s)_
//     kernel :840-876) over TiledBlockPacked (nb, gn, tile_kq, tile_n) uint8.
// and, with one block (nb = gn = 1, tile_kq = Kq, tile_n = N), the global
// stride layout of PackedTernary2Bit / PackedTernary53 (Kq, N) uint8:
//   * pallas_packed2_i8_kernel (:502) and pallas_packed53_i8_kernel (:513),
//     body _packed_i8_kernel :424.
// Both decode factor = 4 two-bit or factor = 5 base-3 codes (a kernel
// parameter: one instantiation each) and stage X as floor(x + 512) - 512,
// the value of the TPU's int8 split, accumulated in int32 directly (no
// split, no wsum correction, no (a; r) stacking): exact for integer
// |x| <= 512, non-integer X floored. Layout, masking and decoding are
// packed_core.cuh's.
//
// What bounds it: 2 (factor 4) or 1.6 (factor 5) bits a weight of device
// memory, but the decode (2 or 4 integer ops a weight) and the issue bound
// of packed_core.cuh come first.
//
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a factor other
// than 4 or 5; the Python wrapper raises on anything but 0.

#include "packed_core.cuh"

extern "C" int ternary_blockpacked_i8(const float* x, int M, int K,
                                      const uint8_t* packed, int nb, int gn,
                                      int tile_kq, int tile_n, int factor,
                                      int N, const float* bias,
                                      const float* alpha, float* y,
                                      void* stream) {
  if (factor == 4)
    return ternary::run_packed<ternary::kStageI8, 4>(
        x, M, K, packed, nb, gn, tile_kq, tile_n, N, bias, alpha, y, stream);
  if (factor == 5)
    return ternary::run_packed<ternary::kStageI8, 5>(
        x, M, K, packed, nb, gn, tile_kq, tile_n, N, bias, alpha, y, stream);
  return (int)cudaErrorInvalidValue;
}
