// Y = X . W + b [PReLU] over the TiledBitplane container, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of ternary_spgemm_tpu/ops/pallas_kernels.py:
//   * ternary_bitplane_x8 and ternary_bitplane_x8_mma <-
//     pallas_tiled_bitplane_x8_kernel (:1552, body _tiled_bitplane_x8_kernel
//     :1518): X rounded half-to-even and clamped to int8 +-127 (_to_x8,
//     :1536), one int32 dot, f32 epilogue. The A8 serving path's merged QKV
//     and wo projections.
//
// Each kernel has two entry points split by M (the wrapper's X8_MMA_MIN_M
// and I8_MMA_MIN_M): the decode kernel below for small M, the int8
// tensor-core kernel of bitplane_mma.cuh above it.
//   * ternary_bitplane_i8 and ternary_bitplane_i8_mma <-
//     pallas_tiled_bitplane_i8_kernel (:1277, bodies
//     _bitplane_i8fs/_i8fu/_i8s/_i8u_kernel :1172-1264): exact for integer
//     |x| <= 512. The TPU splits x = 8a + r - 512 into two int8 operands for
//     its int8 matrix unit and corrects with -512 * wsum; that split is an
//     artifact of the TPU. Here each element is staged as the integer the
//     split represents, floor(x + 512) - 512 (the truncating casts of
//     _int8_split_reg make it floor(x) for non-integer x); wsum is not read.
//     The decode kernel accumulates it in int32 directly; the tensor-core
//     kernel (bitplane_mma.cuh, above the wrapper's I8_MMA_MIN_M) splits it
//     as 32*hi + lo into two int8 operands of the same int32 sums (exact for
//     v in [-4096, 4095]; outside, its hi byte wraps: see there).
//
// All accumulate exact integers, so the result is bitwise equal to the
// plain PyTorch version (ops/cuda_kernels.py) on the domain.
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
#include "bitplane_mma.cuh"

extern "C" int ternary_bitplane_x8(const float* x, int M, int K,
                                   const uint8_t* plane, int nb, int gn,
                                   int tkb, int tile_n, int N,
                                   const float* bias, const float* alpha,
                                   float* y, void* stream) {
  return ternary::run_spmm<ternary::kStageX8>(
      x, M, K, plane, nb, gn, tkb, tile_n, N, bias, alpha, y, stream);
}

// ``xq``: int8 scratch of M x (nb * 2 * round_up(4*tkb, 128)) bytes for
// the rounded X (bitplane_mma.cuh, stage_kernel)
extern "C" int ternary_bitplane_x8_mma(const float* x, int M, int K,
                                       const uint8_t* plane, int nb, int gn,
                                       int tkb, int tile_n, int N,
                                       const float* bias, const float* alpha,
                                       float* y, void* stream, int8_t* xq) {
  return ternary::mma8::run_spmm_mma<ternary::kStageX8, ternary::mma8::TileX8>(
      x, M, K, plane, nb, gn, tkb, tile_n, N, bias, alpha, y, xq,
      static_cast<cudaStream_t>(stream));
}

extern "C" int ternary_bitplane_i8(const float* x, int M, int K,
                                   const uint8_t* plane, int nb, int gn,
                                   int tkb, int tile_n, int N,
                                   const float* bias, const float* alpha,
                                   float* y, void* stream) {
  return ternary::run_spmm<ternary::kStageI8>(
      x, M, K, plane, nb, gn, tkb, tile_n, N, bias, alpha, y, stream);
}

// ``xq``: int8 scratch of 2 x M x (nb * 2 * round_up(4*tkb, 128)) bytes,
// the hi plane of X then its lo plane (bitplane_mma.cuh, stage_kernel)
extern "C" int ternary_bitplane_i8_mma(const float* x, int M, int K,
                                       const uint8_t* plane, int nb, int gn,
                                       int tkb, int tile_n, int N,
                                       const float* bias, const float* alpha,
                                       float* y, void* stream, int8_t* xq) {
  return ternary::mma8::run_spmm_mma<ternary::kStageI8, ternary::mma8::TileI8>(
      x, M, K, plane, nb, gn, tkb, tile_n, N, bias, alpha, y, xq,
      static_cast<cudaStream_t>(stream));
}
