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
// and I8_MMA_MIN_M): the streaming decode body of gemv_core.cuh for small
// M (one launch, split-K across blocks), the int8 tensor-core kernel of
// bitplane_mma.cuh above it.
//   * ternary_bitplane_i8 and ternary_bitplane_i8_mma <-
//     pallas_tiled_bitplane_i8_kernel (:1277, bodies
//     _bitplane_i8fs/_i8fu/_i8s/_i8u_kernel :1172-1264): exact for integer
//     |x| <= 512. The TPU splits x = 8a + r - 512 into two int8 operands for
//     its int8 matrix unit and corrects with -512 * wsum; that split is an
//     artifact of the TPU. Here each element is staged as the integer the
//     split represents, floor(x + 512) - 512 (the truncating casts of
//     _int8_split_reg make it floor(x) for non-integer x); wsum is not read.
//     Both branches stage it as 32*hi + lo, two int8 operands of the same
//     int32 sums (exact for v in [-4096, 4095]; outside, the hi byte wraps
//     in both alike: bitplane_mma.cuh), so they give the same bits on
//     every input.
//
// All accumulate exact integers, so the result is bitwise equal to the
// plain PyTorch version (ops/cuda_kernels.py) on the domain.
//
// What bounds it on an H100: at decode sizes the floor is the weight
// bytes, 2 bits per weight at 3.35 TB/s (3.8 us for the 7B merged QKV);
// the decode body streams them with loads kept in flight and about 3
// integer instructions a weight at M = 4 (ternary4 and __dp4a); the design
// notes are in gemv_core.cuh.
//
// Every entry point returns cudaGetLastError(); the Python wrapper raises on
// anything but 0.

#include "bitplane_mma.cuh"
#include "gemv_core.cuh"

namespace {

ternary::gemv::Args gemv_args(const float* x, int M, int K,
                              const uint8_t* plane, int nb, int gn, int tkb,
                              int tile_n, int N, const float* bias,
                              const float* alpha, float* y, int* part,
                              int* counters) {
  ternary::gemv::Args a{};
  a.x = x; a.M = M; a.K = K;
  a.plane = plane; a.nb = nb; a.gn = gn; a.tkb = tkb; a.tile_n = tile_n;
  a.N = N; a.bias = bias; a.alpha = alpha; a.y = y;
  a.part = part; a.counters = counters;
  return a;
}

}  // namespace

// ``parts``: the S parts of the byte-row walk (ops/fused_ffn.py
// gemv_parts); with S > 1, ``part``: int32 scratch of S * M * N elements
// and ``counters``: one int32 a (column tile, row tile), zero, left zero
extern "C" int ternary_bitplane_x8(const float* x, int M, int K,
                                   const uint8_t* plane, int nb, int gn,
                                   int tkb, int tile_n, int N,
                                   const float* bias, const float* alpha,
                                   float* y, void* stream, int* part,
                                   int* counters, int parts) {
  return ternary::gemv::run<ternary::kStageX8>(
      gemv_args(x, M, K, plane, nb, gn, tkb, tile_n, N, bias, alpha, y, part,
                counters),
      parts, static_cast<cudaStream_t>(stream));
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

// the arguments after ``stream`` as ternary_bitplane_x8's
extern "C" int ternary_bitplane_i8(const float* x, int M, int K,
                                   const uint8_t* plane, int nb, int gn,
                                   int tkb, int tile_n, int N,
                                   const float* bias, const float* alpha,
                                   float* y, void* stream, int* part,
                                   int* counters, int parts) {
  return ternary::gemv::run<ternary::kStageI8>(
      gemv_args(x, M, K, plane, nb, gn, tkb, tile_n, N, bias, alpha, y, part,
                counters),
      parts, static_cast<cudaStream_t>(stream));
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
