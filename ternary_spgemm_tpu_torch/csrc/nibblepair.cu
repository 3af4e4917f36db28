// Y = floor(X) . W + b [PReLU] over the TiledNibblePair container, for
// Hopper (sm_90a).
//
// Replaces ternary_spgemm_tpu/ops/pallas_kernels.py::
// pallas_tiled_nibblepair_i8_kernel (:1463; bodies _nibpair_i8fs/_i8s/_i8u
// :1383-1451 through _bitplane_call :1116). The weights are 4-bit two's-
// complement nibbles, eight to an int32 word: dense row r of a K-block of
// B = 8*tkb rows is word row (r mod 4*tkb) / 4, little-endian byte r % 4,
// the LOW nibble for r < 4*tkb and the HIGH nibble above. Each lane loads
// one word per byte-row and sign-extends its eight nibbles with
// ((v + 8) & 0xF) - 8 (bitplane_core.cuh decode_half<kWNibble>). A wrong
// byte map would still round-trip through to_dense, so the card test holds
// the kernel bitwise to the plain version, which decodes with torch ops.
//
// Activations follow the i8 rule of the bitplane kernel, floor(x + 512) -
// 512 (the value of the TPU's int8 split x = 8a + r - 512), accumulated in
// int32 directly: exact for integer |x| <= 512. The TPU's split and wsum
// correction are not ported; wsum stays in the container, unread.
//
// What bounds it: the decode is ~1 instruction per weight (the TPU's point
// for this layout), but the (3 + MT) multiply-add issue bound of
// bitplane_core.cuh is the same, at twice the plane bytes of the bitplane.
//
// Returns cudaGetLastError(); the Python wrapper raises on anything but 0.

#include "bitplane_core.cuh"

extern "C" int ternary_nibblepair_i8(const float* x, int M, int K,
                                     const int32_t* words, int nb, int gn,
                                     int tkb, int tile_n, int N,
                                     const float* bias, const float* alpha,
                                     float* y, void* stream) {
  return ternary::run_spmm<ternary::kStageI8, ternary::kWNibble>(
      x, M, K, words, nb, gn, tkb, tile_n, N, bias, alpha, y, stream);
}
