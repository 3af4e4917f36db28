// Y = stage(X) . W + b [PReLU] over the DenseTernary container, for Hopper
// (sm_90a).
//
// Replaces three Pallas TPU kernels of ternary_spgemm_tpu/ops/pallas_kernels.py:
//   * ternary_dense_f32 <- pallas_dense_kernel (:173, body _dense_kernel
//     :113): an exact f32 dot (the TPU runs it at precision HIGHEST); here
//     f32 X as it is, products with w in {-1, 0, +1} (exact) summed in f32
//     in a fixed order, so the kernel is deterministic, and bitwise the plain
//     version's on integer X (every partial sum an exact f32 integer);
//   * ternary_dense_bf16 <- pallas_dense_bf16_kernel (:181, the same body
//     with bf16=True): X rounded to bf16 (nearest even) and widened back,
//     f32 sums; X is neither floored nor clamped;
//   * ternary_dense_i8 <- pallas_dense_i8_kernel (:420, _dense_i8(s)_kernel
//     :310-343): X staged as floor(x + 512) - 512, the value of the TPU's
//     int8 split x = 8a + r - 512, and accumulated in int32 directly (no
//     split, no wsum correction); exact for integer |x| <= 512.
// One templated body serves all three (packed_core.cuh, F = 1).
//
// DenseTernary is unpadded: dense is exactly (K, N) int8, one weight a byte,
// rows in order. The kernel reads it as one block of tkq = K packed rows of
// one field, a row stride of N bytes, and masks both ragged edges itself
// (packed_core.cuh); the wrapper passes nb = gn = 1, tkq = K, tile_n = N.
//
// What bounds it: 8 bits a weight of device memory and the issue bound of
// packed_core.cuh; the f32 / bf16 / int8 tensor cores are the later design.
//
// Every entry point returns cudaGetLastError(); the Python wrapper raises on
// anything but 0.

#include "packed_core.cuh"

extern "C" int ternary_dense_f32(const float* x, int M, int K,
                                 const int8_t* dense, int nb, int gn,
                                 int tkq, int tile_n, int N,
                                 const float* bias, const float* alpha,
                                 float* y, void* stream) {
  return ternary::run_packed<ternary::kStageF32, 1>(
      x, M, K, dense, nb, gn, tkq, tile_n, N, bias, alpha, y, stream);
}

extern "C" int ternary_dense_bf16(const float* x, int M, int K,
                                  const int8_t* dense, int nb, int gn,
                                  int tkq, int tile_n, int N,
                                  const float* bias, const float* alpha,
                                  float* y, void* stream) {
  return ternary::run_packed<ternary::kStageBf16, 1>(
      x, M, K, dense, nb, gn, tkq, tile_n, N, bias, alpha, y, stream);
}

extern "C" int ternary_dense_i8(const float* x, int M, int K,
                                const int8_t* dense, int nb, int gn, int tkq,
                                int tile_n, int N, const float* bias,
                                const float* alpha, float* y, void* stream) {
  return ternary::run_packed<ternary::kStageI8, 1>(
      x, M, K, dense, nb, gn, tkq, tile_n, N, bias, alpha, y, stream);
}
