// Y = floor(X) . W + b [PReLU] over the TiledNibblePair container, for
// Hopper (sm_90a).
//
// Replaces ternary_spgemm_tpu/ops/pallas_kernels.py::
// pallas_tiled_nibblepair_i8_kernel (:1463; bodies _nibpair_i8fs/_i8s/_i8u
// :1383-1451 through _bitplane_call :1116). The weights are 4-bit two's-
// complement nibbles, eight to an int32 word: dense row r of a K-block of
// B = 8*tkb rows is word row (r mod 4*tkb) / 4, little-endian byte r % 4,
// the LOW nibble for r < 4*tkb and the HIGH nibble above: the bit planes'
// row map with four bytes a column. The product runs on dense_mma.cuh's
// bf16 tensor-core tile (mma.sync m16n8k16) over its Nibble layout: a chunk
// of KQ word rows of a slab stages two runs of 4*KQ X columns (the low half
// of the K-block's rows and the high half, 4*tkb rows on), and decodes each
// group of four columns' words as it stages them: a 4 x 4 byte transpose
// (one word a dense row, a byte a column), then each nibble to its weight
// byte (0x1 -> 0x01, 0xF -> 0xFF, 0 -> 0). A wrong byte map would still
// round-trip through to_dense, so the card test holds the kernel bitwise to
// the plain version, which decodes with torch ops, and the CPU tests
// emulate the decode and the tile's lanes (tests/test_torch_packed_mma.py).
//
// Activations follow the i8 rule, floor(x + 512) - 512 (the value of the
// TPU's int8 split x = 8a + r - 512), staged as two exact bf16 pieces (as
// CudaBlockPacked_i8): every partial sum an exact integer for integer
// |x| <= 512, so the result is bitwise the plain version's. The TPU's split
// and wsum correction are not ported; wsum stays in the container, unread.
// Each run is masked at tkb (16 word rows for K <= 128, under the Narrow
// tiles' 32-row chunk) and at K (the container pads K to nb*8*tkb), a
// k-step past either skipped; the Narrow16 tile up to 16 rows of X, Narrow
// up to 32, Wide above: one branch at every M.
//
// What bounds it: at the north star the 4 bits a weight of device memory
// (twice the bit planes'), under the latency of the chunks each block walks
// in series; at M = 512 the two tensor-core passes (dense_mma.cuh).
//
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a geometry that
// does not hold K and N; the Python wrapper raises on anything but 0.

#include "dense_mma.cuh"

namespace dmma = ternary::dmma;

extern "C" int ternary_nibblepair_i8(const float* x, int M, int K,
                                     const int32_t* words, int nb, int gn,
                                     int tkb, int tile_n, int N,
                                     const float* bias, const float* alpha,
                                     float* y, void* stream) {
  return dmma::run_slabs<ternary::kStageI8, dmma::Nibble>(
      x, M, K, words, nb, gn, tkb, tile_n, N, bias, alpha, y, stream);
}
