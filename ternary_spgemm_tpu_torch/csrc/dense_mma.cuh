// Y = stage(X) . W + b [PReLU] over ternary weights held as bytes or bits,
// on Hopper's bf16 tensor cores (mma.sync m16n8k16, bf16 x bf16 -> f32):
// one tile, used by
//   * CudaDense (dense.cu, ternary_dense_f32): kStageF32, f32 X exact;
//   * CudaDense_bf16 (dense.cu, ternary_dense_bf16): kStageBf16;
//   * the ring all-gather SpMM's compute warps (ring.cu), f32 X exact, on
//     the slot they hold and the rank's column shard of W;
// those three over the row-major (K, N) int8 plane (RowMajor), and
//   * CudaTiledDense_i8 / _x8 (tiled_dense.cu) and CudaDense_i8 (dense.cu,
//     ternary_dense_i8): kStageI8 / kStageX8 over one-byte weights in slabs
//     (Slabs<1>: TiledDenseTernary, DenseTernary as its one slab);
//   * CudaBlockPacked_i8, CudaTiledBlockPacked_i8, CudaPacked2Bit_i8 and
//     CudaPacked53_i8 (blockpacked.cu, ternary_blockpacked_i8): kStageI8
//     over 2-bit (F = 4) or base-3 (F = 5) codes (Slabs<4>, Slabs<5>);
//   * CudaPacked2Bit and CudaPacked53 (packed.cu, ternary_packed_f32):
//     kStageF32 over the same codes, the stride-packed containers;
//   * CudaTiledBitplane_bf16 (bitplane_bf16.cu, ternary_bitplane_bf16):
//     kStageBf16 over TiledBitplane's pos and neg bit planes (Bitplane);
//   * CudaTiledNibblePair_i8 (nibblepair.cu, ternary_nibblepair_i8):
//     kStageI8 over TiledNibblePair's signed-nibble words (Nibble).
//
// Replaces the products of ternary_spgemm_tpu/ops/pallas_kernels.py
// _dense_kernel (:113; launched by pallas_dense_kernel :173 and
// pallas_dense_bf16_kernel :181), of ternary_spgemm_tpu/parallel/
// ring_kernel.py::_ring_kernel (:42), of pallas_tiled_dense_i8_kernel
// (:777), pallas_tiled_dense_x8_kernel (:821), pallas_dense_i8_kernel
// (:420), pallas_blockpacked_i8_kernel (:596), pallas_tiled_blockpacked_
// i8_kernel (:886), pallas_packed2/53_i8_kernel (:502, :513),
// pallas_packed2/53_kernel (:264, :275), pallas_tiled_bitplane_bf16_
// kernel (:1602) and pallas_tiled_nibblepair_i8_kernel (:1463). The f32
// ones take the TPU's own route to an exact f32 product: "the TPU MXU
// computes f32 dots via multi-pass bf16 products" (Precision.HIGHEST,
// pallas_kernels.py:124-131); the int8 ones issue int8 dots into int32
// accumulators, exact on their domain. Here:
//   * a ternary weight is exact in bf16 (0, 0x3F80 or 0xBF80; the
//     int8 containers hold no other byte, and another would decode
//     wrongly; the codes decode to those bytes first, below);
//   * X is staged by its rule (stage_x, the plain versions' ops/api.py
//     to_x8 / to_i8, in f32): kStageX8 rounds half to even and clamps to
//     +-127, kStageI8 takes floor(x + 512) - 512 (the value of the TPU's
//     int8 split), f32 and bf16 take x as it is;
//   * the staged value v splits into NP bf16 pieces, hi = bf16(v), mid =
//     bf16(v - hi), lo = bf16(v - hi - mid) (round to nearest even; each
//     remainder exact in f32); hi not finite (v inf or NaN, or rounding to
//     inf) gives mid = lo = 0, so inf * 0 makes the NaN that the plain f32
//     product makes (ops/cuda_kernels.py split_bf16 is the Python twin):
//       - kStageF32, three pieces: v == hi + mid + lo exactly for every v
//         with 2**-110 <= |v| < 0x1.FFp127 (3 x 8 significant bits cover
//         f32's 24; below 2**-110 lo may lose bits under bf16's smallest
//         subnormal, 2**-133; from 0x1.FFp127 on hi rounds to inf);
//       - kStageBf16, one piece: X rounded to bf16 as _dense_kernel's
//         bf16=True branch (:119-122) and ops/api.py to_bf16;
//       - kStageX8, one piece: every integer |v| <= 127 is exact in bf16;
//       - kStageI8, two pieces: v is an integer; hi = bf16(v) keeps 8
//         significant bits and v - hi is an integer below half of hi's
//         spacing, so two pieces hold every integer |v| < 2**17 exactly
//         (the domain, |x| <= 512, gives |v| <= 512 and v - hi in {-1, 0,
//         1}); from 2**17 on (|x| > 130560) the remainder may need more
//         than 8 bits and v - hi - (v - hi)' is dropped;
//   * X.W = sum over the pieces: every product exact, the sums in f32 by
//     the tensor cores. On integer staged values (x8, i8 always; f32 and
//     bf16 on integer X) every partial sum is an integer, exact while it
//     stays below 2**24: K * max|v| < 2**24, at the domain's |v| <= 512
//     for every K < 32768 (K <= 4096 in every shape that runs). Then the
//     result is exact whatever the order or the accumulator's rounding,
//     and bitwise the plain version's; from K * |v| >= 2**24 on (|v| >=
//     4096 at K = 4096) sums may round, in another order than the plain
//     matmul's. Off the integers (f32 and bf16 only) the tensor cores' f32
//     accumulation need not round as a CUDA-core add does; each group of
//     kSumSteps k-steps (64 rows of K) is summed into a zeroed fragment
//     (its error at the group's magnitude), and the groups are added into
//     an f32 accumulator on the CUDA cores (round to nearest); the exact
//     rules take all of a warp's k-steps of a chunk as one group. Every sum
//     has a fixed order, so the kernels are deterministic.
//
// The weight layouts (a trait, the B operand's bytes). The walk over K is
// a walk over nb K-blocks, each of tkq packed rows, each block's dense rows
// cut into R runs of D*tkq rows: packed row q of block kb holds D dense
// rows of each run r < R, kb*R*D*tkq + r*D*tkq + D*q + j for j < D
// (ternary_spgemm_tpu_torch/formats/packed.py, tiled.py, bitplane.py):
//   * RowMajor: the (K, N) int8 plane, row stride ldw (R = D = 1, one block
//     of tkq = K rows): DenseTernary for f32 and bf16 X, the ring's shard.
//     Slabs<1> with nb = gn = 1 covers the same bytes, but its per-k-step
//     checks cost these kernels 4-25% at M >= 32 and the ring 4-5% on an
//     H100 (PERF.md), so they keep this walk;
//   * Slabs<F>: bytes (nb, gn, tkq, tile_n) of F fields (R = F runs, D =
//     1), slab (kb, g) holding columns [g*tile_n, (g+1)*tile_n) of block
//     kb; packed row q, column n of slab (kb, g) is
//     w[((kb*gn + g)*tkq + q)*tile_n + n]:
//       - F = 1 TiledDenseTernary (nb = gk, tkq = tile_k) and DenseTernary
//         for i8 X (nb = gn = 1, tkq = K, tile_n = N);
//       - F = 4 / 5 TiledBlockPacked, BlockPackedTernary (gn = 1, tile_n =
//         N) and the stride-packed PackedTernary2Bit / PackedTernary53
//         (nb = gn = 1, tkq = Kq = ceil(K / F), tile_n = N);
//   * Bitplane: TiledBitplane's plane (nb, gn, 2*tkb, tile_n) uint8, tkq =
//     tkb byte-rows a block (R = 2 halves, D = 4): in slab (kb, g) pos
//     byte-row t < tkb and neg byte-row tkb + t hold, in bit 4h + j, the
//     +1 and -1 flags of dense row kb*8*tkb + h*4*tkb + 4t + j;
//   * Nibble: TiledNibblePair's words (nb, gn, tkb, tile_n) int32, the
//     bit planes' row map with four bytes a column (CB = 4): little-endian
//     byte j of word row t holds, in nibble h (low, high), the 4-bit two's
//     complement weight of dense row kb*8*tkb + h*4*tkb + 4t + j.
//     Every other layout has one byte a column (CB = 1).
//     A block's columns lie in one slab (tile_n a multiple of the tile's
//     width where gn > 1). A chunk is KQ packed rows of one K-block: it
//     stages R runs of D*KQ columns of X side by side (a field's, or a
//     half's), and decodes its packed rows into R runs of D*KQ int8 rows
//     of W, so a k-step (16 staged columns) pairs the X of one run with
//     that run's weights; each run is masked at D*tkq and at K (tkq % 16
//     != 0, K not a multiple of F or of a block, tkb = 16 under the Narrow
//     chunk's 32 byte-rows), and a k-step whose rows all lie past either
//     is skipped.
// Decoding (exact for every byte the packers emit, ops/pallas_kernels.py
// _decode_block :530; ops/cuda_kernels.py swar_decode is the Python twin),
// four bytes at a time: d is a byte's code or digit, and its weight byte
// is (d & 1) | 0xFF * ((d >> 1) & 1), so 1 -> +1 and 2 or 3 -> -1:
//   * F = 4: d = (word >> 2j) & 0x03030303, codes {0, 1, 3} -> {0, 1, -1};
//   * F = 5: the bytes in two 16-bit lanes each of two words (even and odd
//     bytes), qn = (q*171) >> 9 (= q / 3 for q < 512, below 2**16 for
//     every byte), d = q - 3*qn, q = qn, field by field;
//   * bit planes: the words of four columns of a pos and a neg byte-row,
//     bit o of each byte -> pbit | 0xFF * nbit (the planes never share a
//     bit), eight words of weight bytes;
//   * nibbles: the four words of four columns of a word row, transposed
//     byte for byte (byte j of each column's word -> one word of the four
//     columns' bytes j), then each nibble n -> sign_bytes(n): the packer
//     emits only 0x0, 0x1 and 0xF (formats/bitplane.py), which become 0,
//     0x01 and 0xFF; another nibble would decode wrongly.
//
// What bounds it on an H100: at M = 512 (L: 512 x 4096 x 4096) the NP
// passes are NP x 17.2 G bf16 operations, 17-52 us at the 989 TFLOP/s
// peak, and the bytes ~14 us: the operations. At M <= 32 (the north star,
// 32 x 1024 x 4096) the W bytes (8, 4, 2 or 1.6 bits a weight; 1.25 us at
// 3.35 TB/s for one byte a weight), under the latency of the chunks each
// block walks in series. A CUDA-core body (bitplane_core.cuh's, which the
// small-M branches of the x8, i8 and fused FFN kernels still run) spends MT
// multiply-adds and MT/4 shared loads a weight and lane, zeros included:
// only the tensor cores take the product under one f32 torch.matmul. This
// first tile still pays each chunk's round trip to memory in series, and
// its staging (X split again for every tile of N) does not overlap its
// mma: a cp.async or TMA pipeline and wgmma are what would take it toward
// the passes' bound (PERF.md).
//
// Design, simple first (no cp.async or TMA pipeline, no wgmma: later work):
//   * 8 warps, each a 32 x 32 tile of Y (2 m16 x 4 n8 fragments); two
//     geometries: Narrow, 32 x 32 a block with the 8 warps splitting each
//     chunk's k-steps (a split-K inside the block, reduced in shared memory
//     in warp order): N/32 blocks, 128 at the north star, for M <= 32;
//     Wide, 64 x 128 a block (2 x 4 warps) above; over slabs a third,
//     Narrow16 (16 x 32, one m16 fragment a warp) for M <= 16;
//   * the exact rules (x8, i8) sum straight into the accumulators, which
//     saves the zeroed fragments' 32 registers a thread; a k-step whose
//     rows all lie past tkq or K is skipped (Slabs, Bitplane, Nibble);
//   * a chunk of KC rows of K (KC / 4 packed rows for the codes, KC / 8
//     byte-rows or word rows for the bit planes and the nibbles) at a
//     time: X staged from f32 (16-byte loads where K, tkq and the address
//     allow), its rule applied and
//     split into its pieces as it is staged, one bf16 plane a piece; W
//     staged with 16-byte loads (8- or 4-byte ones for the codes' and the
//     bit planes' smaller chunks, so that every thread decodes; byte loads
//     where N or the row stride is not a multiple of 16), the codes and
//     bits decoded as they are stored; all of a chunk's loads in flight
//     before its first store to shared memory. A fragments by ldmatrix,
//     each feeding four n8 fragments;
//   * B fragments from the int8 bytes: a B register holds two consecutive
//     k of one column, two bytes a row stride apart. A lane reads four
//     32-bit words (rows 2t, 2t+1, 2t+8, 2t+9 of the k-step, columns
//     4g..4g+3) and interleaves them into the registers of four n8
//     fragments, so n8 fragment f holds the tile columns 4j + f (j < 8):
//     14 integer instructions for 16 weights, reused for every m-fragment
//     and every piece; lane (g, t)'s accumulators then cover columns 8t to
//     8t + 7 of its rows;
//   * the ragged edges are masked here: rows of X past M and columns past
//     K (or past their run's end) stage as 0, rows of W past tkq and columns
//     past N as 0, the epilogue writes only inside (M, N). The wrapper
//     makes no padded copy;
//   * the epilogue goes through shared memory (the split-K's reduction):
//     float(acc) + b[col], then y > 0 ? y : alpha[col] * y (epi_bias, in
//     ops/api.py finish's order; nothing that contracts into an FMA),
//     coalesced stores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitplane_core.cuh"

namespace ternary {
namespace dmma {

constexpr int kThreads = 256;   // 8 warps
// bf16 pieces of a staged value, by X rule (the file's note)
template <int STAGE>
constexpr int kPieces = STAGE == kStageF32 ? 3 : STAGE == kStageI8 ? 2 : 1;
// the rules whose staged values are integers (every partial sum exact on
// the domain, in any grouping)
template <int STAGE>
constexpr bool kExact = STAGE == kStageI8 || STAGE == kStageX8;
// k-steps (16 rows of K each) whose passes the tensor cores sum into one
// zeroed fragment: their f32 sums need not round as a CUDA-core add does
// (one accumulator across all of K = 4096 missed rtol=1e-5, atol=1e-3 at
// 512 x 4096 x 4096 on non-integer X on an H100), so each group's error
// stays at the group's magnitude and the groups are added on the CUDA
// cores, rounding to nearest
constexpr int kSumSteps = 4;

// A block's geometry: WM x WN warps over the output tile, the other
// 8 / (WM*WN) warps splitting each chunk's k-steps; KC rows of K a chunk
// (one byte a weight).
template <int WM_, int WN_, int KC_, int MF_ = 2>
struct Tile {
  static constexpr int WM = WM_, WN = WN_, KC = KC_;
  static constexpr int WK = 8 / (WM * WN);
  static constexpr int MF = MF_, NF = 4;      // a warp: 16*MF x 32
  static constexpr int BM = 16 * MF * WM, BN = 32 * WN;
  static_assert(WM * WN * WK == 8, "8 warps");
  static constexpr int kWS = BN + 16;         // W row stride, bytes
  static constexpr int kRS = BN + 1;          // reduction row stride, floats
};
using Narrow = Tile<1, 1, 256>;         // 32 x 32, the 8 warps split K
using Wide = Tile<2, 4, 128>;           // 64 x 128
using Narrow16 = Tile<1, 1, 256, 1>;    // 16 x 32, the 8 warps split K
// the largest M the Narrow tile takes, and the Narrow16 tile (slabs only:
// at M <= 16 it halves the staging and the passes of the 32-row tile,
// PERF.md)
constexpr int kNarrowMaxM = 32;
constexpr int kNarrow16MaxM = 16;

struct Args {
  const float* x;        // (M, K) f32, row stride K
  int M, K;
  const int8_t* w;       // the weight bytes (layout by the trait)
  int ldw, N;            // bytes from one row of W to the next; Y's columns
  int nb, gn, tkq;       // slabs: K-blocks, N-slabs, packed rows a block
  const float* bias;     // (N,)
  const float* alpha;    // (N,) PReLU slopes, or null
  float* y;              // (M, N) f32, row stride ldy
  int ldy;
  bool xvec, wvec;       // 16-byte loads of X rows / W rows are aligned
};

// Four codes or digits d (one a byte) -> their weight bytes: 1 -> 0x01,
// 2 or 3 -> 0xFF, 0 -> 0.
__device__ __forceinline__ uint32_t sign_bytes(uint32_t d) {
  return (d & 0x01010101u) | (((d >> 1) & 0x01010101u) * 0xFFu);
}

// The F fields of the four packed bytes of ``word``: out[f] holds, byte for
// byte, the int8 weight of field f (the file's note; ops/cuda_kernels.py
// swar_decode).
template <int F>
__device__ __forceinline__ void decode_word(uint32_t word, uint32_t out[F]) {
  if constexpr (F == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = sign_bytes((word >> (2 * j)) & 0x03030303u);
  } else {
    static_assert(F == 5, "factor 4 or 5");
    uint32_t e = word & 0x00FF00FFu, o = (word >> 8) & 0x00FF00FFu;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const uint32_t en = ((e * 171u) >> 9) & 0x007F007Fu;
      const uint32_t on = ((o * 171u) >> 9) & 0x007F007Fu;
      out[j] = sign_bytes((e - 3u * en) | ((o - 3u * on) << 8));
      e = en;
      o = on;
    }
  }
}

// The weight layouts (the file's note): R runs of D*KQ staged columns a
// chunk of KQ = KC / KDIV packed rows, each packed row holding D dense rows
// of each run in NW planes of CB bytes a column; the K-blocks, the packed
// rows a block, and the bytes of block kb from the tile's first column n0
// (rows ldw bytes apart; a second plane tkq rows on). ``decode`` turns a
// packed row's NW words (four columns each; Nibble: one column each, four
// columns) into its R*D words of weight bytes, output o holding dense row
// D*q + o % D of run o / D.
struct RowMajor {
  static constexpr int R = 1, D = 1, KDIV = 1, NW = 1, CB = 1;
  static constexpr bool kSlabs = false;
  __device__ static int blocks(const Args&) { return 1; }
  __device__ static int rows(const Args& a) { return a.K; }
  __device__ static const int8_t* block(const Args& a, int, int n0) {
    return a.w + n0;
  }
};
template <int F>
struct Slabs {
  static_assert(F == 1 || F == 4 || F == 5, "factor 1, 4 or 5");
  static constexpr int R = F, D = 1, KDIV = F == 1 ? 1 : 4, NW = 1, CB = 1;
  static constexpr bool kSlabs = true;
  __device__ static int blocks(const Args& a) { return a.nb; }
  __device__ static int rows(const Args& a) { return a.tkq; }
  __device__ static const int8_t* block(const Args& a, int kb, int n0) {
    const int g = n0 / a.ldw;
    return a.w + ((size_t)kb * a.gn + g) * a.tkq * a.ldw + (n0 - g * a.ldw);
  }
  __device__ static void decode(const uint32_t w[1], uint32_t out[F]) {
    decode_word<F>(w[0], out);
  }
};
struct Bitplane {
  static constexpr int R = 2, D = 4, KDIV = 8, NW = 2, CB = 1;
  static constexpr bool kSlabs = true;
  __device__ static int blocks(const Args& a) { return a.nb; }
  __device__ static int rows(const Args& a) { return a.tkq; }
  __device__ static const int8_t* block(const Args& a, int kb, int n0) {
    const int g = n0 / a.ldw;
    return a.w + ((size_t)kb * a.gn + g) * 2 * a.tkq * a.ldw +
           (n0 - g * a.ldw);
  }
  // bit o = 4h + j of the pos byte w[0] and the neg byte w[1] -> output o,
  // dense row 4q + j of run h: pbit | 0xFF * nbit (the two never share a
  // bit, so 1 -> 0x01, -1 -> 0xFF, 0 -> 0)
  __device__ static void decode(const uint32_t w[2], uint32_t out[8]) {
#pragma unroll
    for (int o = 0; o < 8; ++o)
      out[o] = ((w[0] >> o) & 0x01010101u) |
               (((w[1] >> o) & 0x01010101u) * 0xFFu);
  }
};
struct Nibble {
  static constexpr int R = 2, D = 4, KDIV = 8, NW = 1, CB = 4;
  static constexpr bool kSlabs = true;
  __device__ static int blocks(const Args& a) { return a.nb; }
  __device__ static int rows(const Args& a) { return a.tkq; }
  __device__ static const int8_t* block(const Args& a, int kb, int n0) {
    const int tn = a.ldw / CB, g = n0 / tn;
    return a.w + ((size_t)kb * a.gn + g) * a.tkq * a.ldw +
           CB * (n0 - g * tn);
  }
  // the words w[0..3] of four columns -> output o = 4h + j, dense row 4q +
  // j of run h: byte e the weight of column e, from nibble h of byte j of
  // w[e]. A 4 x 4 byte transpose, then sign_bytes of each nibble (its bits
  // 0 and 1; 0x0 -> 0, 0x1 -> 0x01, 0xF -> 0xFF, the packer's only nibbles)
  __device__ static void decode(const uint32_t w[4], uint32_t out[8]) {
    const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
    const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
    const uint32_t t[4] = {__byte_perm(lo01, lo23, 0x5410),
                           __byte_perm(lo01, lo23, 0x7632),
                           __byte_perm(hi01, hi23, 0x5410),
                           __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[j] = sign_bytes(t[j]);
      out[4 + j] = sign_bytes(t[j] >> 4);
    }
  }
};

// A chunk of the walk for tile T, rule STAGE and layout L: KQ packed rows,
// CW staged columns of X (R runs of RL) and decoded rows of W, KS k-steps
// split over the WK warps NJ at a time, PS of them summed into one zeroed
// fragment (the exact rules: all NJ straight into the accumulators). A
// ragged split (KS not a multiple of WK: the codes' 20 k-steps at F = 5 for
// the Narrow tiles' 8 warps) and a ragged last group (NJ not a multiple of
// PS: F = 5's 10 on the Wide tile, groups of 4, 4 and 2) are harmless for
// every rule: a k-step past KS or NJ is skipped and adds nothing, and which
// k-steps a warp takes, in which group, is fixed at compile time, so every
// sum keeps one order and a group never holds more than kSumSteps k-steps.
// (The alternative, a chunk of whole k-steps a warp, doubles the Narrow f32
// F = 5 chunk to ~155 KB of shared memory, one block an SM: CudaPacked53
// took 0.0282 ms against 0.0209 at 32 x 1024 x 4096 on an H100, PERF.md.)
// W is staged in groups of GB bytes a thread: 16, or 8 or 4 where more
// would leave threads without a group (the codes' and the bit planes'
// Narrow chunks, the bit planes' Wide one), so that the decode is spread
// over all of them; the nibbles' 16 bytes are four columns of a word row.
template <class T, int STAGE, class L>
struct Chunk {
  static constexpr int NP = kPieces<STAGE>;
  static constexpr int KQ = T::KC / L::KDIV;
  static constexpr int RL = L::D * KQ;
  static constexpr int CW = L::R * RL;
  static constexpr int KS = CW / 16;
  static constexpr int NJ = cdiv(KS, T::WK);
  static constexpr int PS = kExact<STAGE> || NJ < kSumSteps ? NJ : kSumSteps;
  static constexpr int GB = KQ * T::BN * L::CB / 16 >= kThreads ? 16
                            : KQ * T::BN * L::CB / 8 >= kThreads ? 8 : 4;
  static_assert(RL % 16 == 0, "whole k-steps a run");
  static_assert(L::CB == 1 || GB == 4 * L::CB, "a word a column, 4 columns");
  static constexpr int kAS = CW + 8;          // X piece row stride, bf16
  // the NP X pieces and the W rows of a chunk, then (reusing them) the WK
  // partial tiles of the reduction
  static constexpr int smem() {
    const int stage = NP * T::BM * kAS * 2 + CW * T::kWS;
    const int red = T::WK * T::BM * T::kRS * 4;
    return stage > red ? stage : red;
  }
};

// X staged by its rule, in f32 (ops/api.py to_x8, to_i8; the clamp keeps a
// NaN, as torch.clamp does).
template <int STAGE>
__device__ __forceinline__ float stage_x(float x) {
  if constexpr (STAGE == kStageX8) {
    const float v = rintf(x);
    return v < -127.0f ? -127.0f : (v > 127.0f ? 127.0f : v);
  } else if constexpr (STAGE == kStageI8) {
    return __fsub_rn(floorf(__fadd_rn(x, 512.0f)), 512.0f);
  } else {
    static_assert(STAGE == kStageF32 || STAGE == kStageBf16, "an X rule");
    return x;
  }
}

// The NP bf16 pieces of v (the file's note; ops/cuda_kernels.py split_bf16).
template <int NP>
__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16 p[NP]) {
  static_assert(NP >= 1 && NP <= 3, "one to three pieces");
  p[0] = __float2bfloat16_rn(v);
  if constexpr (NP > 1) {
    const float h = __bfloat162float(p[0]);
    const float r1 = isfinite(h) ? __fsub_rn(v, h) : 0.0f;
    p[1] = __float2bfloat16_rn(r1);
    if constexpr (NP == 3)
      p[2] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(p[1])));
  }
}

// The B registers of four n8 fragments from two rows of W: ``ra`` (row k)
// and ``rb`` (row k + 1) each hold columns 4g..4g+3 as bytes 0..3; out[f]
// is bf16(ra.f) | bf16(rb.f) << 16. A byte w in {0, 1, -1} has the bf16
// high byte H = 0x3F | (w & 0x80) and low byte L = 0x80 when w != 0.
__device__ __forceinline__ void b_pairs(uint32_t ra, uint32_t rb,
                                        uint32_t out[4]) {
  const uint32_t lo = __byte_perm(ra, rb, 0x5140);   // ra.0 rb.0 ra.1 rb.1
  const uint32_t hi = __byte_perm(ra, rb, 0x7362);   // ra.2 rb.2 ra.3 rb.3
  const uint32_t nl = lo & 0x01010101u, nh = hi & 0x01010101u;
  const uint32_t hl = nl * 0x3Fu + (lo & 0x80808080u);
  const uint32_t hh = nh * 0x3Fu + (hi & 0x80808080u);
  const uint32_t ll = nl << 7, lh = nh << 7;
  out[0] = __byte_perm(ll, hl, 0x5140);
  out[1] = __byte_perm(ll, hl, 0x7362);
  out[2] = __byte_perm(lh, hh, 0x5140);
  out[3] = __byte_perm(lh, hh, 0x7362);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t a[4], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Whether k-step ``ks`` (its first staged column) of the chunk whose run 0
// starts at dense row ``k00``, ``r0`` rows into the block's runs of ``rs``
// rows, holds a row inside its run and inside K: the k-steps that fail
// stage zeros and are skipped.
template <class C>
__device__ __forceinline__ bool live_step(const Args& a, int rs, int k00,
                                          int r0, int ks) {
  const int q = ks % C::RL;
  return r0 + q < rs && k00 + (ks / C::RL) * rs + q < a.K;
}

// Store the GW words ``w`` (GW = 4, 2 or 1) at ``p`` as one 16-, 8- or
// 4-byte store.
template <int GW>
__device__ __forceinline__ void store_words(uint8_t* p, const uint32_t w[GW]) {
  if constexpr (GW == 4)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (GW == 2)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(p) = w[0];
}

// Stage the chunk of packed rows [q0, q0 + KQ) of K-block kb for the
// block's tile at (m0, n0): X by its rule, split into NP planes, its R runs
// side by side; W, each packed row decoded into its rows of each run. Every
// load of the chunk is issued before the first store to shared memory, so
// the chunk waits for one round trip to device memory, not one a load.
template <class T, int STAGE, class L>
__device__ __forceinline__ void stage_chunk(const Args& a, int m0, int n0,
                                            int kb, int q0, int tid,
                                            __nv_bfloat16* xs, uint8_t* ws) {
  using C = Chunk<T, STAGE, L>;
  constexpr int NP = C::NP;
  constexpr int Q = C::CW / 4;                  // 4-column groups a row
  constexpr int XL = T::BM * Q / kThreads;      // X groups a thread
  constexpr int GW = C::GB / 4;                 // W words a group
  constexpr int G = T::BN * L::CB / C::GB;      // W groups a row
  constexpr int WT = C::KQ * G;                 // W groups a chunk
  constexpr int WL = cdiv(WT, kThreads);        // W groups a thread
  static_assert(T::BM * Q % kThreads == 0, "whole X groups a thread");
  const int tkq = L::rows(a);
  const int rs = L::D * tkq;                    // dense rows a run
  const int k00 = kb * L::R * rs + L::D * q0;   // dense row of run 0
  float4 v[XL];
#pragma unroll
  for (int j = 0; j < XL; ++j) {
    const int i = tid + j * kThreads, r = i / Q, c = 4 * (i % Q);
    const int q = c % C::RL;                    // row D*q0 + q of its run
    const int k = k00 + (c / C::RL) * rs + q;
    // RowMajor: tkq is K, so a row inside K is inside the block
    const int left = L::kSlabs ? min(rs - L::D * q0 - q, a.K - k) : a.K - k;
    v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (m0 + r < a.M && left > 0) {
      const float* src = a.x + (size_t)(m0 + r) * a.K + k;
      if (a.xvec) {
        v[j] = *reinterpret_cast<const float4*>(src);
      } else {
        v[j].x = src[0];
        if (left > 1) v[j].y = src[1];
        if (left > 2) v[j].z = src[2];
        if (left > 3) v[j].w = src[3];
      }
    }
  }
  // W: GB bytes (GB / CB columns) of one packed row a group (of each of its
  // NW planes), one 16-, 8- or 4-byte load where aligned, GB byte loads
  // (each column masked) elsewhere; c is the group's first byte of the row
  const int8_t* wb = L::block(a, kb, n0);
  uint32_t u[WL][L::NW][GW];
#pragma unroll
  for (int j = 0; j < WL; ++j) {
    const int i = tid + j * kThreads, r = i / G, c = C::GB * (i % G);
#pragma unroll
    for (int p = 0; p < L::NW; ++p)
#pragma unroll
      for (int e = 0; e < GW; ++e) u[j][p][e] = 0u;
    if ((WT % kThreads == 0 || i < WT) && q0 + r < tkq &&
        n0 + c / L::CB < a.N) {
#pragma unroll
      for (int p = 0; p < L::NW; ++p) {
        const int8_t* src = wb + (size_t)(p * tkq + q0 + r) * a.ldw + c;
        if (a.wvec) {
          if constexpr (GW == 4) {
            const uint4 t = *reinterpret_cast<const uint4*>(src);
            u[j][p][0] = t.x; u[j][p][1] = t.y;
            u[j][p][2] = t.z; u[j][p][3] = t.w;
          } else if constexpr (GW == 2) {
            const uint2 t = *reinterpret_cast<const uint2*>(src);
            u[j][p][0] = t.x; u[j][p][1] = t.y;
          } else {
            u[j][p][0] = *reinterpret_cast<const uint32_t*>(src);
          }
        } else {
#pragma unroll
          for (int e = 0; e < C::GB; ++e)
            if (n0 + c / L::CB + e / L::CB < a.N)
              u[j][p][e / 4] |= (uint32_t)(uint8_t)src[e] << (8 * (e % 4));
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < WL; ++j) {
    const int i = tid + j * kThreads, r = i / G, c = C::GB * (i % G);
    if (WT % kThreads == 0 || i < WT) {
      if constexpr (L::R * L::D == 1) {
        store_words<GW>(ws + r * T::kWS + c, u[j][0]);
      } else if constexpr (L::CB > 1) {
        // the group's GW words are GW columns: one word a decoded row
        constexpr int O = L::R * L::D;
        uint32_t d[O];
        L::decode(u[j][0], d);
#pragma unroll
        for (int o = 0; o < O; ++o)
          store_words<1>(ws + ((o / L::D) * C::RL + L::D * r + o % L::D) *
                                  T::kWS + c / L::CB, &d[o]);
      } else {
        constexpr int O = L::R * L::D;          // decoded rows a packed row
        uint32_t d[O][GW];
#pragma unroll
        for (int e = 0; e < GW; ++e) {
          uint32_t w[L::NW], out[O];
#pragma unroll
          for (int p = 0; p < L::NW; ++p) w[p] = u[j][p][e];
          L::decode(w, out);
#pragma unroll
          for (int o = 0; o < O; ++o) d[o][e] = out[o];
        }
#pragma unroll
        for (int o = 0; o < O; ++o)
          store_words<GW>(ws + ((o / L::D) * C::RL + L::D * r + o % L::D) *
                                   T::kWS + c, d[o]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < XL; ++j) {
    const int i = tid + j * kThreads, r = i / Q, c = 4 * (i % Q);
    // rows past M, and columns past K or past a field's tkq, stage as the
    // zeros loaded above
    const float f[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
    __nv_bfloat16 p[4][NP];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_bf16<NP>(stage_x<STAGE>(f[e]), p[e]);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      __nv_bfloat162 lo2, hi2;
      lo2.x = p[0][q]; lo2.y = p[1][q];
      hi2.x = p[2][q]; hi2.y = p[3][q];
      uint2 w2;
      w2.x = *reinterpret_cast<const uint32_t*>(&lo2);
      w2.y = *reinterpret_cast<const uint32_t*>(&hi2);
      *reinterpret_cast<uint2*>(xs + (q * T::BM + r) * C::kAS + c) = w2;
    }
  }
}

// One block's tile of Y: rows [m0, m0 + BM) and columns [n0, n0 + BN),
// y[gm * ldy + col] = stage(X) . W + b [PReLU] inside (M, N). ``tid`` is the
// thread's index among the tile's kThreads threads, ``smem`` the
// Chunk<T, STAGE, L>::smem() bytes of dynamic shared memory and ``sync`` a
// barrier of those threads: the whole block in dense_kernel, the compute
// warps beside the copy warps in ring.cu. Every write to smem follows a
// sync, so consecutive calls may share it.
template <class T, int STAGE, class L, class Sync>
__device__ __forceinline__ void dense_tile(const Args& a, int m0, int n0,
                                           int tid, uint8_t* smem, Sync sync) {
  using C = Chunk<T, STAGE, L>;
  constexpr int NP = C::NP;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* ws = smem + NP * T::BM * C::kAS * 2;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wk = warp / (T::WM * T::WN), wmn = warp % (T::WM * T::WN);
  const int wm = 16 * T::MF * (wmn / T::WN), wn = 32 * (wmn % T::WN);

  float acc[T::MF][T::NF][4];
#pragma unroll
  for (int i = 0; i < T::MF; ++i)
#pragma unroll
    for (int f = 0; f < T::NF; ++f)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][f][r] = 0.0f;

  const int nb = L::blocks(a), tkq = L::rows(a);
  for (int kb = 0; kb < nb; ++kb) {
    for (int q0 = 0; q0 < tkq; q0 += C::KQ) {
      const int k00 = kb * L::R * L::D * tkq + L::D * q0;   // run 0's row
      sync();   // the previous chunk (or tile) is consumed
      stage_chunk<T, STAGE, L>(a, m0, n0, kb, q0, tid, xs, ws);
      sync();
      // the warp's k-steps of the chunk, PS at a time: each group's passes
      // summed into the zeroed fragments ``part``, then added into acc (the
      // exact rules: straight into acc). Slabs, Bitplane: the k-steps that
      // are not live are skipped; every m16 fragment is computed, rows past
      // M too
#pragma unroll
      for (int s0 = 0; s0 < C::NJ; s0 += C::PS) {
        float part[T::MF][T::NF][4];
        if constexpr (!kExact<STAGE>) {
#pragma unroll
          for (int i = 0; i < T::MF; ++i)
#pragma unroll
            for (int f = 0; f < T::NF; ++f)
#pragma unroll
              for (int r = 0; r < 4; ++r) part[i][f][r] = 0.0f;
        }
#pragma unroll
        for (int s = s0; s < s0 + C::PS; ++s) {
          const int ks = 16 * (wk + s * T::WK);
          if (C::NJ % C::PS != 0 && s >= C::NJ) continue;
          if (C::KS % T::WK != 0 && ks >= C::CW) continue;
          if (L::kSlabs && !live_step<C>(a, L::D * tkq, k00, L::D * q0, ks))
            continue;
          const uint8_t* wp = ws + (ks + 2 * t) * T::kWS + wn + 4 * g;
          uint32_t b[2][4];   // [k half][n8 fragment]
          b_pairs(*reinterpret_cast<const uint32_t*>(wp),
                  *reinterpret_cast<const uint32_t*>(wp + T::kWS), b[0]);
          b_pairs(*reinterpret_cast<const uint32_t*>(wp + 8 * T::kWS),
                  *reinterpret_cast<const uint32_t*>(wp + 9 * T::kWS), b[1]);
#pragma unroll
          for (int i = 0; i < T::MF; ++i) {
#pragma unroll
            for (int q = 0; q < NP; ++q) {
              uint32_t af[4];
              ldmatrix_x4(af, xs + (q * T::BM + wm + 16 * i + (lane & 15)) *
                                       C::kAS + ks + 8 * (lane >> 4));
#pragma unroll
              for (int f = 0; f < T::NF; ++f) {
                const uint32_t bf[2] = {b[0][f], b[1][f]};
                mma_bf16(kExact<STAGE> ? acc[i][f] : part[i][f], af, bf);
              }
            }
          }
        }
        if constexpr (!kExact<STAGE>) {
#pragma unroll
          for (int i = 0; i < T::MF; ++i)
#pragma unroll
            for (int f = 0; f < T::NF; ++f)
#pragma unroll
              for (int r = 0; r < 4; ++r)
                acc[i][f][r] = __fadd_rn(acc[i][f][r], part[i][f][r]);
        }
      }
    }
  }

  // acc[i][f][r] is row wm + 16i + g + 8(r >> 1), column wn + 8t + 4(r & 1)
  // + f of the tile; the WK partial tiles are added in warp order
  float* red = reinterpret_cast<float*>(smem);
  sync();
#pragma unroll
  for (int i = 0; i < T::MF; ++i)
#pragma unroll
    for (int f = 0; f < T::NF; ++f)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        red[(wk * T::BM + wm + 16 * i + g + 8 * (r >> 1)) * T::kRS + wn +
            8 * t + 4 * (r & 1) + f] = acc[i][f][r];
  sync();
  for (int e = tid; e < T::BM * T::BN; e += kThreads) {
    const int row = e / T::BN, col = e % T::BN;
    const int gm = m0 + row, gc = n0 + col;
    if (gm < a.M && gc < a.N) {
      float s = red[row * T::kRS + col];
#pragma unroll
      for (int w = 1; w < T::WK; ++w)
        s = __fadd_rn(s, red[(w * T::BM + row) * T::kRS + col]);
      a.y[(size_t)gm * a.ldy + gc] = epi_bias(s, a.bias, a.alpha, gc);
    }
  }
}

template <class T, int STAGE, class L>
__global__ void __launch_bounds__(kThreads, 2) dense_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  dense_tile<T, STAGE, L>(a, blockIdx.y * T::BM, blockIdx.x * T::BN,
                          threadIdx.x, smem, [] { __syncthreads(); });
}

// Whether 16-byte loads of X (row stride K; and, in slabs, runs of tkq
// columns) and of W (row stride ldw, ``cols`` bytes of a row from ``w``)
// stay aligned.
__host__ __device__ inline bool x_vec(const float* x, int K) {
  return K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}
__host__ __device__ inline bool w_vec(const int8_t* w, int ldw, int cols) {
  return ldw % 16 == 0 && cols % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

template <class T, int STAGE, class L>
int launch(const Args& a, cudaStream_t s) {
  const int bytes = Chunk<T, STAGE, L>::smem();
  cudaError_t err = cudaFuncSetAttribute(
      dense_kernel<T, STAGE, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dense_kernel<T, STAGE, L><<<dim3(cdiv(a.N, T::BN), cdiv(a.M, T::BM)),
                              kThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// Y = stage(X) . W + b [PReLU] over a DenseTernary (K, N) int8 plane of
// row stride ldw (RowMajor): the Narrow tile up to kNarrowMaxM rows of X,
// Wide above.
template <int STAGE>
int run_dense(const float* x, int M, int K, const int8_t* w, int ldw, int N,
              const float* bias, const float* alpha, float* y,
              cudaStream_t s) {
  Args a{};
  a.x = x; a.M = M; a.K = K;
  a.w = w; a.ldw = ldw; a.N = N;
  a.bias = bias; a.alpha = alpha;
  a.y = y; a.ldy = N;
  a.xvec = x_vec(x, K);
  a.wvec = w_vec(w, ldw, N);
  return M <= kNarrowMaxM ? launch<Narrow, STAGE, RowMajor>(a, s)
                          : launch<Wide, STAGE, RowMajor>(a, s);
}

// Y = stage(X) . W + b [PReLU] over bytes in slabs, layout L (the file's
// note): Slabs<F>, (nb, gn, tkq, tile_n) of F fields a byte, Bitplane,
// (nb, gn, 2*tkq, tile_n) with tkq = tkb, or Nibble, (nb, gn, tkq, tile_n)
// words with tkq = tkb. The Narrow16 tile up to
// kNarrow16MaxM rows of X, Narrow up to kNarrowMaxM, Wide above.
// cudaErrorInvalidValue for a geometry that does not hold K and N, or
// slabs narrower than the tile's columns.
template <int STAGE, class L>
int run_slabs(const float* x, int M, int K, const void* w, int nb, int gn,
              int tkq, int tile_n, int N, const float* bias,
              const float* alpha, float* y, void* stream) {
  const int bn = M <= kNarrowMaxM ? Narrow::BN : Wide::BN;
  if (nb < 1 || gn < 1 || tkq < 1 || tile_n < 1 ||
      (long long)nb * L::R * L::D * tkq < K || (long long)gn * tile_n < N ||
      (gn > 1 && tile_n % bn != 0))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x; a.M = M; a.K = K;
  a.w = static_cast<const int8_t*>(w); a.ldw = tile_n * L::CB; a.N = N;
  a.nb = nb; a.gn = gn; a.tkq = tkq;
  a.bias = bias; a.alpha = alpha;
  a.y = y; a.ldy = N;
  a.xvec = x_vec(x, K) && L::D * tkq % 4 == 0;
  a.wvec = w_vec(a.w, a.ldw, N * L::CB);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= kNarrow16MaxM) return launch<Narrow16, STAGE, L>(a, s);
  return M <= kNarrowMaxM ? launch<Narrow, STAGE, L>(a, s)
                          : launch<Wide, STAGE, L>(a, s);
}

}  // namespace dmma
}  // namespace ternary
