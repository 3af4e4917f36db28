// The deposit study's kernel ladder: the ELL deposit gather of ell_core.cuh
// with parts removed for attribution, for Hopper (sm_90a).
//
// Replaces tools/deposit_study.py::deposit_variant (:144, bodies
// _make_variant_kernel :78). The TPU ladder removes, in turn, the bit-deposit
// loop ("nodeposit") and the bitplane decode ("nodecode") of its kernel, and
// unrolls its loops to the global caps ("staticcap"). The H100 kernel
// (CudaEllDeposit_i8) deposits no bits: it gathers staged X at each slot's
// offset. So its ladder removes what it does instead (EllVariant in
// ell_core.cuh):
//   mode 0 full       the registered kernel's work (per-tile caps, each
//                     warp stopping at the first slot row that is the
//                     sentinel in all its lanes);
//   mode 1 staticcap  loops to the global cap_p_max / cap_n_max, no early
//                     exit; sentinel slots add 0 (stands in for JAX's
//                     staticcap);
//   mode 2 nogather   slot bytes staged and consumed, X read lane-
//                     contiguously: no random-offset bank conflicts; loops
//                     to the per-tile caps without the early exit (stands
//                     in for nodeposit);
//   mode 3 noslots    no slot copies or loads; X staging and the adds to
//                     the per-tile caps only (stands in for nodecode).
// staticcap - full is then what the per-tile caps and the early exit save,
// nogather - noslots the cost of the slot bytes' copies and loads, noslots
// the staging and the adds of the cap walk; full - nogather is the gather
// at random offsets (bank conflicts, the load-to-address dependency) less
// what the early exit saves over the cap walk. The functions modes 2 and 3
// compute are defined in deposit_study.py, beside their plain versions.
//
// What bounds it: as ell_core.cuh; no PReLU. Returns cudaGetLastError() (or
// cudaErrorInvalidValue for an unknown mode); the Python wrapper raises on
// anything but 0.

#include "ell_core.cuh"

extern "C" int ternary_deposit_variant(const float* x, int M, int K,
                                       const int8_t* pos, const int8_t* neg,
                                       const int* cap_pos, const int* cap_neg,
                                       int nsb, int gn, int rows, int tile_n,
                                       int static_pos, int static_neg, int N,
                                       const float* bias, float* y, int mode,
                                       void* stream) {
  ternary::EllArgs a{};
  a.x = x; a.M = M; a.K = K;
  a.pos = pos; a.neg = neg; a.cap_pos = cap_pos; a.cap_neg = cap_neg;
  a.nb = nsb; a.gn = gn; a.rows_pos = rows; a.rows_neg = rows;
  a.slab_n = tile_n; a.cap_tile = tile_n; a.ncaps = gn;
  a.block_k = 248;      // formats/ell_deposit.py SB_ROWS
  a.N = N;
  a.static_pos = static_pos; a.static_neg = static_neg;
  a.bias = bias; a.alpha = nullptr; a.y = y;
  using namespace ternary;
  switch (mode) {
    case kVarFull: return run_ell<kEllDeposit, kVarFull>(a, stream);
    case kVarStaticCap: return run_ell<kEllDeposit, kVarStaticCap>(a, stream);
    case kVarNoGather: return run_ell<kEllDeposit, kVarNoGather>(a, stream);
    case kVarNoSlots: return run_ell<kEllDeposit, kVarNoSlots>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
