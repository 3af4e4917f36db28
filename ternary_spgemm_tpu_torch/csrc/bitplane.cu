// Y = X . W + b [PReLU] over the TiledBitplane container, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of ternary_spgemm_tpu/ops/pallas_kernels.py:
//   * ternary_bitplane_x8 <- pallas_tiled_bitplane_x8_kernel (:1552, body
//     _tiled_bitplane_x8_kernel :1518): X rounded half-to-even and clamped
//     to int8 +-127 (_to_x8, :1536), one int32 dot, f32 epilogue. The A8
//     serving path's merged QKV and wo projections.
//   * ternary_bitplane_i8 <- pallas_tiled_bitplane_i8_kernel (:1277, bodies
//     _bitplane_i8fs/_i8fu/_i8s/_i8u_kernel :1172-1264): exact for integer
//     |x| <= 512. The TPU splits x = 8a + r - 512 into two int8 operands for
//     its int8 matrix unit and corrects with -512 * wsum; that split is an
//     artifact of the TPU. Here each element is staged as the integer the
//     split represents, floor(x + 512) - 512 (the truncating casts of
//     _int8_split_reg make it floor(x) for non-integer x), and accumulated
//     in int32 directly; wsum is not read.
//
// Both accumulate exact integers, so the result is bitwise equal to the
// plain PyTorch version (ops/cuda_kernels.py).
//
// What bounds it on an H100: at decode sizes (M <= 32) the floor is the
// weight bytes, 2 bits per weight at 3.35 TB/s (3.8 us for the 7B merged
// QKV). This first design decodes each byte pair once per lane and reuses
// it for a whole M-tile, but still issues ~(3 + MT) integer instructions
// per weight, so it is bound by issue rate well above that floor; the
// design notes are in bitplane_core.cuh.
//
// Every entry point returns cudaGetLastError(); the Python wrapper raises on
// anything but 0.

#include "bitplane_core.cuh"

extern "C" int ternary_bitplane_x8(const float* x, int M, int K,
                                   const uint8_t* plane, int nb, int gn,
                                   int tkb, int tile_n, int N,
                                   const float* bias, const float* alpha,
                                   float* y, void* stream) {
  return ternary::run_spmm<ternary::kStageX8, ternary::kWBitplane>(
      x, M, K, plane, nb, gn, tkb, tile_n, N, bias, alpha, y, stream);
}

extern "C" int ternary_bitplane_i8(const float* x, int M, int K,
                                   const uint8_t* plane, int nb, int gn,
                                   int tkb, int tile_n, int N,
                                   const float* bias, const float* alpha,
                                   float* y, void* stream) {
  return ternary::run_spmm<ternary::kStageI8, ternary::kWBitplane>(
      x, M, K, plane, nb, gn, tkb, tile_n, N, bias, alpha, y, stream);
}
