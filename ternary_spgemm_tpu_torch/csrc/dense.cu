// Y = stage(X) . W + b [PReLU] over the DenseTernary container, for Hopper
// (sm_90a).
//
// Replaces three Pallas TPU kernels of ternary_spgemm_tpu/ops/pallas_kernels.py:
//   * ternary_dense_f32 <- pallas_dense_kernel (:173, body _dense_kernel
//     :113): an exact f32 dot, which the TPU runs at precision HIGHEST as
//     multi-pass bf16 products. So does this kernel: dense_mma.cuh splits f32
//     X into three bf16 pieces as it stages it and runs the three passes on
//     the bf16 tensor cores (mma.sync m16n8k16), every product exact and the
//     sums in f32 in a fixed order, so the kernel is deterministic and
//     bitwise the plain version's on integer X (every partial sum an exact
//     f32 integer);
//   * ternary_dense_bf16 <- pallas_dense_bf16_kernel (:181, the same body
//     with bf16=True): X rounded to bf16 (nearest even), one pass of the
//     same tile, f32 sums; X is neither floored nor clamped;
//   * ternary_dense_i8 <- pallas_dense_i8_kernel (:420, _dense_i8(s)_kernel
//     :310-343): X staged as floor(x + 512) - 512, the value of the TPU's
//     int8 split x = 8a + r - 512, as two exact bf16 pieces (no wsum
//     correction); exact for integer |x| <= 512. DenseTernary is the slab
//     layout with one slab (Slabs<1>, nb = gn = 1, tkq = K, tile_n = N), so
//     this is the instantiation that ternary_tiled_dense_i8 runs
//     (tiled_dense.cu).
//
// DenseTernary is unpadded: dense is exactly (K, N) int8, one weight a byte,
// rows in order. The kernels mask both ragged edges themselves; the wrapper
// makes no padded copy.
//
// What bounds them: the tensor-core passes (three for f32, two for i8, one
// for bf16) at large M and the W bytes under the chunks' latency at small
// M (dense_mma.cuh).
//
// Every entry point returns cudaGetLastError(); the Python wrapper raises on
// anything but 0.

#include "dense_mma.cuh"

namespace dmma = ternary::dmma;

// x (M, K) f32, dense (K, N) int8, bias and alpha (N,) f32 (alpha may be
// null), y (M, N) f32
extern "C" int ternary_dense_f32(const float* x, int M, int K,
                                 const int8_t* dense, int N,
                                 const float* bias, const float* alpha,
                                 float* y, void* stream) {
  return dmma::run_dense<ternary::kStageF32>(
      x, M, K, dense, N, N, bias, alpha, y, static_cast<cudaStream_t>(stream));
}

extern "C" int ternary_dense_bf16(const float* x, int M, int K,
                                  const int8_t* dense, int N,
                                  const float* bias, const float* alpha,
                                  float* y, void* stream) {
  return dmma::run_dense<ternary::kStageBf16>(
      x, M, K, dense, N, N, bias, alpha, y, static_cast<cudaStream_t>(stream));
}

extern "C" int ternary_dense_i8(const float* x, int M, int K,
                                const int8_t* dense, int nb, int gn, int tkq,
                                int tile_n, int N, const float* bias,
                                const float* alpha, float* y, void* stream) {
  return dmma::run_slabs<ternary::kStageI8, dmma::Slabs<1>>(
      x, M, K, dense, nb, gn, tkq, tile_n, N, bias, alpha, y, stream);
}
