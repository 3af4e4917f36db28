// Y = stage(X) . W + b [PReLU] over the ELL containers (TiledEllTCSC,
// TiledEllDeposit, BlockedEllTCSC), for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of ternary_spgemm_tpu/ops/pallas_kernels.py:
//   * ternary_tiled_ell_f32 <- pallas_tiled_ell_kernel (:1839, body
//     _tiled_ell_kernel :1784): split-sign lane gather of f32 X by local
//     offsets, the sentinel gathering a reserved zero lane, slot loops
//     bounded by the exact per-tile caps;
//   * ternary_ell_deposit_i8 <- pallas_ell_deposit_i8_kernel (:1703, body
//     _ell_deposit_kernel :1634): on the TPU each offset is deposited as a
//     bit, the words decoded as bitplanes and fed to one int8-split MXU dot
//     a 248-row superblock; here the same offsets are gathered directly,
//     X staged as floor(x + 512) - 512 (the value of the int8 split) in
//     int16 and summed in int32: exact for integer |x| <= 512, non-integer
//     X floored.
//     The deposit-then-dot chain, the (a; r) stacking, the -512*wsum
//     correction and the row permutation are TPU plumbing and not ported;
//     wsum is not read;
//   * ternary_blocked_ell_f32 <- pallas_ell_gather_kernel (:1890, body
//     _ell_kernel :1758): gather by local offsets with the -1 slots masked,
//     f32; here -1 names a staged zero.
// The f32 kernels sum the products of f32 X in a fixed order: deterministic,
// and bitwise the plain version's on integer X. Layouts, staging and the
// bound are ell_core.cuh's.
//
// One argument list for all three (the wrapper maps each container onto
// it): x, M, K, the pos and neg sections, the cap tables, nb, gn, the slot
// rows of a pos and of a neg slab, slab_n, cap_tile, ncaps, block_k, N,
// bias, alpha, y, stream. Each returns cudaGetLastError() (or
// cudaErrorInvalidValue for a K-block the stage cannot hold); the Python
// wrapper raises on anything but 0.

#include "ell_core.cuh"

namespace {

ternary::EllArgs ell_args(const float* x, int M, int K, const int8_t* pos,
                          const int8_t* neg, const int* cap_pos,
                          const int* cap_neg, int nb, int gn, int rows_pos,
                          int rows_neg, int slab_n, int cap_tile, int ncaps,
                          int block_k, int N, const float* bias,
                          const float* alpha, float* y) {
  ternary::EllArgs a{};
  a.x = x; a.M = M; a.K = K;
  a.pos = pos; a.neg = neg; a.cap_pos = cap_pos; a.cap_neg = cap_neg;
  a.nb = nb; a.gn = gn; a.rows_pos = rows_pos; a.rows_neg = rows_neg;
  a.slab_n = slab_n; a.cap_tile = cap_tile; a.ncaps = ncaps;
  a.block_k = block_k; a.N = N;
  a.bias = bias; a.alpha = alpha; a.y = y;
  return a;
}

}  // namespace

#define TERNARY_ELL_ENTRY(NAME, LAYOUT)                                       \
  extern "C" int NAME(const float* x, int M, int K, const int8_t* pos,        \
                      const int8_t* neg, const int* cap_pos,                  \
                      const int* cap_neg, int nb, int gn, int rows_pos,       \
                      int rows_neg, int slab_n, int cap_tile, int ncaps,      \
                      int block_k, int N, const float* bias,                  \
                      const float* alpha, float* y, void* stream) {           \
    return ternary::run_ell<LAYOUT>(                                          \
        ell_args(x, M, K, pos, neg, cap_pos, cap_neg, nb, gn, rows_pos,       \
                 rows_neg, slab_n, cap_tile, ncaps, block_k, N, bias, alpha,  \
                 y),                                                          \
        stream);                                                              \
  }

TERNARY_ELL_ENTRY(ternary_tiled_ell_f32, ternary::kEllTiled)
TERNARY_ELL_ENTRY(ternary_ell_deposit_i8, ternary::kEllDeposit)
TERNARY_ELL_ENTRY(ternary_blocked_ell_f32, ternary::kEllBlocked)
