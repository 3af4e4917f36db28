// Y = X . W + b [PReLU] over the TiledDenseTernary container, for Hopper
// (sm_90a).
//
// Replaces two Pallas TPU kernels of ternary_spgemm_tpu/ops/pallas_kernels.py:
//   * ternary_tiled_dense_i8 <- pallas_tiled_dense_i8_kernel (:777, body
//     _tiled_dense_i8_kernel :669 through _tiled_call :686): exact for
//     integer |x| <= 512; X staged as floor(x + 512) - 512, the value of the
//     TPU's int8 split, as two exact bf16 pieces (no wsum correction);
//   * ternary_tiled_dense_x8 <- pallas_tiled_dense_x8_kernel (:821, body
//     _tiled_dense_x8_kernel :797): X rounded half to even and clamped to
//     +-127 (_to_x8, :1536), one exact bf16 piece.
// Both run dense_mma.cuh's bf16 tensor-core tile (mma.sync m16n8k16) over
// the slab layout with one field (Slabs<1>), kStageI8 / kStageX8: every
// partial sum an exact integer on the domain, so the kernels are bitwise
// the plain versions'.
//
// The weights are one int8 a weight in tile-contiguous slabs (gk, gn,
// tile_k, tile_n): nb = gk blocks of tkq = tile_k rows. A chunk of the
// tile stops at its K-tile (tile_k = min(256, round_up(K, 32)) may be
// under the Narrow tile's 256-row chunk), and a block's columns lie in one
// N-tile (tile_n a multiple of 128). K pads to gk*tile_k and N to
// gn*tile_n with zeros; the tile masks rows past K and never writes past N.
//
// What bounds them: at the north star the W bytes (8 bits a weight) under
// the latency of the chunks each block walks in series; at M = 512 the
// tensor-core passes (two for i8, one for x8): dense_mma.cuh.
//
// Every entry point returns cudaGetLastError() (or cudaErrorInvalidValue
// for a geometry that does not hold K and N); the Python wrapper raises on
// anything but 0.

#include "dense_mma.cuh"

namespace dmma = ternary::dmma;

extern "C" int ternary_tiled_dense_i8(const float* x, int M, int K,
                                      const int8_t* tiles, int gk, int gn,
                                      int tile_k, int tile_n, int N,
                                      const float* bias, const float* alpha,
                                      float* y, void* stream) {
  return dmma::run_slabs<ternary::kStageI8, dmma::Slabs<1>>(
      x, M, K, tiles, gk, gn, tile_k, tile_n, N, bias, alpha, y, stream);
}

extern "C" int ternary_tiled_dense_x8(const float* x, int M, int K,
                                      const int8_t* tiles, int gk, int gn,
                                      int tile_k, int tile_n, int N,
                                      const float* bias, const float* alpha,
                                      float* y, void* stream) {
  return dmma::run_slabs<ternary::kStageX8, dmma::Slabs<1>>(
      x, M, K, tiles, gk, gn, tile_k, tile_n, N, bias, alpha, y, stream);
}
