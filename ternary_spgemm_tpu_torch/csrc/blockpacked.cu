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
// All run dense_mma.cuh's bf16 tensor-core tile (mma.sync m16n8k16) over
// the slab layout with factor = 4 two-bit or factor = 5 base-3 codes
// (Slabs<4>, Slabs<5>: one instantiation each), kStageI8: X staged as
// floor(x + 512) - 512, the value of the TPU's int8 split, as two exact
// bf16 pieces (no wsum correction, no (a; r) stacking); exact for integer
// |x| <= 512, non-integer X floored, bitwise the plain versions'. A chunk
// stages KQ packed rows of one block, decodes their F fields into F runs
// of int8 weight rows and the X of each field beside them, each run masked
// at tile_kq (the stride-packed Kq is rarely a multiple of 16) and at K.
//
// What bounds it: at the north star 2 (factor 4) or 1.6 (factor 5) bits a
// weight of device memory, under the latency of the chunks each block
// walks in series; at M = 512 the two tensor-core passes; the decode (a
// few integer instructions a byte and field) is done once a chunk as the
// weights are staged (dense_mma.cuh).
//
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a factor other
// than 4 or 5 or a geometry that does not hold K and N; the Python wrapper
// raises on anything but 0.

#include "dense_mma.cuh"

namespace dmma = ternary::dmma;

extern "C" int ternary_blockpacked_i8(const float* x, int M, int K,
                                      const uint8_t* packed, int nb, int gn,
                                      int tile_kq, int tile_n, int factor,
                                      int N, const float* bias,
                                      const float* alpha, float* y,
                                      void* stream) {
  if (factor == 4)
    return dmma::run_slabs<ternary::kStageI8, dmma::Slabs<4>>(
        x, M, K, packed, nb, gn, tile_kq, tile_n, N, bias, alpha, y, stream);
  if (factor == 5)
    return dmma::run_slabs<ternary::kStageI8, dmma::Slabs<5>>(
        x, M, K, packed, nb, gn, tile_kq, tile_n, N, bias, alpha, y, stream);
  return (int)cudaErrorInvalidValue;
}
