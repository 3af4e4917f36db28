// Y = X . W + b [PReLU] over the stride-packed containers PackedTernary2Bit
// and PackedTernary53, f32 X as it is, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of ternary_spgemm_tpu/ops/pallas_kernels.py:
//   * pallas_packed2_kernel (:264) and pallas_packed53_kernel (:275), body
//     _packed_kernel (:190): decode the 2-bit (factor 4) or base-3 (factor
//     5) codes of a (Kq, N) uint8 plane, then one f32 dot per field at
//     precision HIGHEST.
// Here the products w * x with w in {-1, 0, +1} are exact and summed in f32
// in a fixed order: deterministic, and bitwise the plain version's on
// integer X (every partial sum an exact f32 integer).
//
// The global stride layout (field j of packed row k' is dense row
// j*Kq + k') is packed_core.cuh's block layout with one block: the wrapper
// passes nb = gn = 1, tkq = Kq, tile_n = N. K pads only to factor*Kq, so
// the core stages x = 0 for rows at or past K. The i8 forms of these
// kernels (pallas_packed2_i8_kernel :502, pallas_packed53_i8_kernel :513)
// launch ternary_blockpacked_i8 (blockpacked.cu) with the same geometry.
//
// What bounds it: 2 (factor 4) or 1.6 (factor 5) bits a weight of device
// memory, but the decode and the issue bound of packed_core.cuh come
// first; f32 tensor cores are the later design.
//
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a factor other
// than 4 or 5; the Python wrapper raises on anything but 0.

#include "packed_core.cuh"

extern "C" int ternary_packed_f32(const float* x, int M, int K,
                                  const uint8_t* packed, int nb, int gn,
                                  int tkq, int tile_n, int factor, int N,
                                  const float* bias, const float* alpha,
                                  float* y, void* stream) {
  if (factor == 4)
    return ternary::run_packed<4>(
        x, M, K, packed, nb, gn, tkq, tile_n, N, bias, alpha, y, stream);
  if (factor == 5)
    return ternary::run_packed<5>(
        x, M, K, packed, nb, gn, tkq, tile_n, N, bias, alpha, y, stream);
  return (int)cudaErrorInvalidValue;
}
