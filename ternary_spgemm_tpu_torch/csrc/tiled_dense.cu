// Y = X . W + b [PReLU] over the TiledDenseTernary container, for Hopper
// (sm_90a).
//
// Replaces two Pallas TPU kernels of ternary_spgemm_tpu/ops/pallas_kernels.py:
//   * ternary_tiled_dense_i8 <- pallas_tiled_dense_i8_kernel (:777, body
//     _tiled_dense_i8_kernel :669 through _tiled_call :686): exact for
//     integer |x| <= 512; X staged as floor(x + 512) - 512, the value of the
//     TPU's int8 split, and accumulated in int32 directly (no split, no
//     wsum correction);
//   * ternary_tiled_dense_x8 <- pallas_tiled_dense_x8_kernel (:821, body
//     _tiled_dense_x8_kernel :797): X rounded half to even and clamped to
//     +-127 (_to_x8, :1536), int32 accumulation.
// One templated body serves both (packed_core.cuh, F = 1).
//
// The weights are one int8 a weight in tile-contiguous slabs (gk, gn,
// tile_k, tile_n): the packed-row layout with one field, nb = gk blocks of
// tkq = tile_k rows (packed_core.cuh), so a warp's load of one tile row is
// one 32-byte sector. K pads to gk*tile_k and N to gn*tile_n with zeros;
// padded rows meet zero activations and padded columns are never written.
//
// What bounds it: 8 bits per weight of device memory (4x the bitplane) and
// the issue bound of packed_core.cuh; the int8 tensor cores are the later,
// faster design.
//
// Every entry point returns cudaGetLastError(); the Python wrapper raises on
// anything but 0.

#include "packed_core.cuh"

extern "C" int ternary_tiled_dense_i8(const float* x, int M, int K,
                                      const int8_t* tiles, int gk, int gn,
                                      int tile_k, int tile_n, int N,
                                      const float* bias, const float* alpha,
                                      float* y, void* stream) {
  return ternary::run_packed<ternary::kStageI8, 1>(
      x, M, K, tiles, gk, gn, tile_k, tile_n, N, bias, alpha, y, stream);
}

extern "C" int ternary_tiled_dense_x8(const float* x, int M, int K,
                                      const int8_t* tiles, int gk, int gn,
                                      int tile_k, int tile_n, int N,
                                      const float* bias, const float* alpha,
                                      float* y, void* stream) {
  return ternary::run_packed<ternary::kStageX8, 1>(
      x, M, K, tiles, gk, gn, tile_k, tile_n, N, bias, alpha, y, stream);
}
