// Y = bf16(X) . W + b [PReLU] over the TiledBitplane container, for Hopper
// (sm_90a).
//
// Replaces ternary_spgemm_tpu/ops/pallas_kernels.py::
// pallas_tiled_bitplane_bf16_kernel (:1602, body _tiled_bitplane_b16_kernel
// :1572): X cast to bf16 (round to nearest even), the planes decoded to
// {-1, 0, +1}, one bf16 dot with f32 accumulation, f32 epilogue. The TPU
// kernel runs that dot on its matrix unit; here each staged activation is
// rounded with __float2bfloat16_rn and widened back to f32, and the
// products (exact: w is +-1 or 0) are summed in f32. X is neither floored
// nor clamped: the kernel takes any float, and the rounding to bf16 is its
// only approximation. On integer X with |x| <= 256 every value and partial
// sum is an exact f32 integer, so the result is bitwise the plain version's
// (ops/cuda_kernels.py); elsewhere the two differ only in f32 summation
// order.
//
// What bounds it: as the integer bitplane kernels (bitplane_core.cuh), an
// issue-rate bound of ~(3 + MT) instructions per weight and lane, f32
// multiply-adds in place of integer ones. The TPU built it for large M,
// where a bf16 tensor-core (wgmma) design is the later, faster one.
//
// Returns cudaGetLastError(); the Python wrapper raises on anything but 0.

#include "bitplane_core.cuh"

extern "C" int ternary_bitplane_bf16(const float* x, int M, int K,
                                     const uint8_t* plane, int nb, int gn,
                                     int tkb, int tile_n, int N,
                                     const float* bias, const float* alpha,
                                     float* y, void* stream) {
  return ternary::run_spmm<ternary::kStageBf16, ternary::kWBitplane>(
      x, M, K, plane, nb, gn, tkb, tile_n, N, bias, alpha, y, stream);
}
