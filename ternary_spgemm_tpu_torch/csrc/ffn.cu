// The fused ternary PReLU FFN block (the reference-epilogue block), for
// Hopper (sm_90a).
//
// Replaces ternary_spgemm_tpu/ops/fused_ffn.py::fused_bitplane_ffn (:229,
// body _ffn_kernel :121). The TPU kernel keeps the (M, N1) f32 hidden state
// in VMEM across a sequential 1-D grid; blocks on an H100 run in parallel
// in no order and share no such scratch, so the one call makes two
// launches of gemv_core.cuh's streaming split-K decode body on one stream:
//   phase 1: X staged by the i8 rule (floor(x + 512) - 512 as 32*hi + lo:
//     exact for the integer |x| <= 512 of the contract) and summed in int32
//     against W1's planes; the epilogue kEpiBiasRmax is _i8_epilogue's
//     (:168-175): h = float(acc) + b1/gamma1, then where(h > 0, h, alpha1 *
//     h); f32 h is written to a scratch tensor (unscaled: gamma1 rides only
//     in the output scale) and the per-row absmax folded with one
//     atomicMax a warp and row on the int bits of |h|, by the block that
//     adds a tile's parts, so over the finished h of all N1 columns;
//   phase 2: each h element is requantized as it is staged (kStageRequant),
//     rint(h / ((rmax + 1e-12) / 127)) with an IEEE division, summed in
//     int32 against W2's planes, then the epilogue kEpiScaleBias: y = acc *
//     (((rmax + 1e-12) / 127) * (gamma1 * gamma2)) + b2 and the optional
//     PReLU with alpha2 (:187-191), with rounded multiplies and adds (no
//     FMA), as the plain version rounds.
// Hidden columns at or past N1 stage as 0 in phase 2 (the TPU kernel
// zero-pads b1/alpha1 and zero-fills the scratch tail for the same end).
// The caller passes b1/gamma1 (one IEEE division) and gamma1 * gamma2 (one
// product rounded once to f32), as the JAX wrapper folds them.
//
// Each phase's byte-row walk is split into ``parts1`` / ``parts2`` parts
// (ops/fused_ffn.py gemv_parts, grid z; the last part of a tile adds them in
// order), so that phase 2's cdiv(N2, 128) column tiles fill the card. The
// two phases share the int32 scratch and the counters: phase 1's folding
// blocks leave the counters at 0 before phase 2 runs on the same stream.
//
// What bounds it: the plane bytes (2 bits a weight at 3.35 TB/s) under a
// floor a launch (gemv_core.cuh).
//
// Returns cudaGetLastError(); the Python wrapper raises on anything but 0.

#include "gemv_core.cuh"

// ``part``: int32 scratch of max(parts1 * M * N1, parts2 * M * N2)
// elements (null when both are 1); ``counters``: one int32 a (column tile,
// row tile) of the larger phase, zero, left zero
extern "C" int ternary_prelu_ffn(const float* x, int M, int K,
                                 const uint8_t* plane1, int nb1, int gn1,
                                 int tkb1, int tile_n1, int N1,
                                 const float* b1g, const float* alpha1,
                                 const uint8_t* plane2, int nb2, int gn2,
                                 int tkb2, int tile_n2, int N2,
                                 const float* b2, const float* alpha2,
                                 float gamma12, float* h, int* rmax, float* y,
                                 void* stream, int* part, int* counters,
                                 int parts1, int parts2) {
  namespace gemv = ternary::gemv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = (int)cudaMemsetAsync(rmax, 0, sizeof(int) * (size_t)M, s);
  if (err != 0) return err;

  gemv::Args p1{};
  p1.x = x; p1.M = M; p1.K = K;
  p1.plane = plane1;
  p1.nb = nb1; p1.gn = gn1; p1.tkb = tkb1; p1.tile_n = tile_n1; p1.N = N1;
  p1.bias = b1g; p1.alpha = alpha1;
  p1.y = h;
  p1.part = part; p1.counters = counters;
  p1.rmax_out = rmax;
  err = gemv::run<ternary::kStageI8, ternary::kEpiBiasRmax>(p1, parts1, s);
  if (err != 0) return err;

  gemv::Args p2{};
  p2.x = h; p2.M = M; p2.K = N1;
  p2.plane = plane2;
  p2.nb = nb2; p2.gn = gn2; p2.tkb = tkb2; p2.tile_n = tile_n2; p2.N = N2;
  p2.bias = b2; p2.alpha = alpha2;
  p2.y = y;
  p2.part = part; p2.counters = counters;
  p2.rmax_in = rmax;
  p2.gamma0 = gamma12;
  return gemv::run<ternary::kStageRequant, ternary::kEpiScaleBias>(p2, parts2,
                                                                   s);
}
