// The whole ternary SwiGLU FFN of a BitNet W1.58-A8 block, for Hopper (sm_90a).
//
// Replaces ternary_spgemm_tpu/ops/fused_ffn.py::fused_bitplane_swiglu (:384,
// body _swiglu_kernel :316). The TPU kernel keeps the (M, ff) f32 hidden
// state in VMEM across a sequential 1-D grid: phase 1 streams the gate and
// up planes, phase 2 the down planes. On an H100 that cannot carry over: at
// 7B width 128 x 11008 x 4 B is 5.6 MB, far above a block's 227 KB of
// shared memory, and blocks run in parallel in no order. So the one call
// makes two launches on one stream:
//   phase 1: gate and up dots over int8 xq in int32 (both planes decoded in
//     the same pass, sharing the staged activations), the silu-mul epilogue
//     in the JAX op order (:362-366) with the sigmoid evaluated in f64 and
//     rounded once (so the card and the CPU agree bit for bit; expf and
//     torch's f32 sigmoid differ in the last ULP), f32 h written to a scratch tensor
//     (it stays in the 50 MB L2 at serving sizes), and the per-row absmax
//     folded with one atomicMax per warp and row on the int bits of |h|
//     (max is order-free, so rmax is bitwise the JAX value);
//   phase 2: each h element is requantized as it is staged,
//     rint(h / ((rmax + 1e-12) / 127)) with an IEEE division (:106-113),
//     accumulated in int32 against the down planes, and scaled by
//     ((rmax + 1e-12) / 127) * gamma_down (:116-118, :378-381).
// Rows are independent, so there is no M <= 128 limit.
//
// Two entry points split by M (the wrapper's SWIGLU_MMA_MIN_M), with the
// same contract and the same bits: ternary_swiglu, the streaming split-K
// decode body of gemv_core.cuh, for small M; ternary_swiglu_mma, the int8
// tensor-core core of bitplane_mma.cuh, above it.
//
// ternary_swiglu makes three launches on one stream: the memset of rmax;
// phase 1 on two plane sets a block (gate and up: a lane loads both
// planes' words of a byte-row, each staged xq word feeds both accumulator
// sets; xq staged once a block by the truncating rule, one int8 plane;
// M-tiles of 4 and 8 rows) with the epilogue kEpiSwiglu; phase 2, the
// requantizing rule kStageRequant with kEpiScale. Each phase's byte-row
// walk is split into ``parts1`` / ``parts2`` parts (ops/fused_ffn.py
// gemv_parts, grid z), so that the column tiles fill the card; the last
// part of a tile to arrive adds the parts' int32 sums ((S, 2, M, N1) in
// phase 1) in part order, exact, and applies the epilogue, so y, h and
// rmax keep their bits for every S and rmax is the max over all N1
// finished columns. The two phases share the scratch and the counters:
// phase 1's folding blocks leave the counters at 0 before phase 2 runs.
//
// ternary_swiglu_mma makes four launches on one stream: the memset of
// rmax; the truncating pre-pass of xq into an int8 scratch and the
// gate-and-up product (two accumulator sets) with the silu-mul epilogue;
// the requantizing pre-pass of h into a second int8 scratch (it reads the
// rmax the product left); the down product with the scale epilogue. Its
// integer sums are exact and its epilogues are the decode body's
// expressions (bitplane_core.cuh, epi_*), so y, h and rmax are bitwise
// equal between the two.
//
// What bounds it: the plane bytes, 2 bits a weight at 3.35 TB/s (gate, up
// and down 33.8 MB at 7B width: 10.1 us), under the decode body's floor a
// launch (gemv_core.cuh) at decode; the hidden round trip through L2 costs
// 8 bytes a hidden element against ~1.3 KB of plane bytes a hidden column,
// the split's partial sums another 4 * S * NP bytes an output element, in
// L2.
//
// Returns cudaGetLastError(); the Python wrapper raises on anything but 0.

#include "bitplane_mma.cuh"
#include "gemv_core.cuh"

namespace {

// The tensor-core entry point's two products: gate and up over xq into h,
// with the row absmax into rmax (p1); down over h requantized by rmax into
// y (p2).
void swiglu_args(const float* xq, const float* sx, int M, int K,
                 const uint8_t* plane_gate, const uint8_t* plane_up, int nb1,
                 int gn1, int tkb1, int tile_n1, int N1,
                 const uint8_t* plane_down, int nb2, int gn2, int tkb2,
                 int tile_n2, int N2, float gamma_gate, float gamma_up,
                 float gamma_down, float* h, int* rmax, float* y,
                 ternary::Args* p1, ternary::Args* p2) {
  *p1 = ternary::Args{};
  p1->x = xq; p1->M = M; p1->K = K;
  p1->plane0 = plane_gate; p1->plane1 = plane_up;
  p1->nb = nb1; p1->gn = gn1; p1->tkb = tkb1; p1->tile_n = tile_n1; p1->N = N1;
  p1->sx = sx; p1->rmax_out = rmax;
  p1->gamma0 = gamma_gate; p1->gamma1 = gamma_up;
  p1->y = h;

  *p2 = ternary::Args{};
  p2->x = h; p2->M = M; p2->K = N1;
  p2->plane0 = plane_down; p2->plane1 = nullptr;
  p2->nb = nb2; p2->gn = gn2; p2->tkb = tkb2; p2->tile_n = tile_n2; p2->N = N2;
  p2->rmax_in = rmax;
  p2->gamma0 = gamma_down;
  p2->y = y;
}

}  // namespace

// ``part``: int32 scratch of max(parts1 * 2 * M * N1, parts2 * M * N2)
// elements (null when both are 1); ``counters``: one int32 a (column
// tile, row tile) of the larger phase, zero, left zero; ``parts1``,
// ``parts2``: the parts S of phase 1 and phase 2
extern "C" int ternary_swiglu(const float* xq, const float* sx, int M, int K,
                              const uint8_t* plane_gate,
                              const uint8_t* plane_up, int nb1, int gn1,
                              int tkb1, int tile_n1, int N1,
                              const uint8_t* plane_down, int nb2, int gn2,
                              int tkb2, int tile_n2, int N2,
                              float gamma_gate, float gamma_up,
                              float gamma_down, float* h, int* rmax,
                              float* y, void* stream, int* part,
                              int* counters, int parts1, int parts2) {
  namespace gemv = ternary::gemv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = (int)cudaMemsetAsync(rmax, 0, sizeof(int) * (size_t)M, s);
  if (err != 0) return err;

  gemv::Args2 p1{};
  p1.x = xq; p1.M = M; p1.K = K;
  p1.plane = plane_gate; p1.plane1 = plane_up;
  p1.nb = nb1; p1.gn = gn1; p1.tkb = tkb1; p1.tile_n = tile_n1; p1.N = N1;
  p1.sx = sx; p1.gamma0 = gamma_gate; p1.gamma1 = gamma_up;
  p1.y = h;
  p1.part = part; p1.counters = counters;
  p1.rmax_out = rmax;
  err = gemv::run<ternary::kStageTrunc, ternary::kEpiSwiglu>(p1, parts1, s);
  if (err != 0) return err;

  gemv::Args p2{};
  p2.x = h; p2.M = M; p2.K = N1;
  p2.plane = plane_down;
  p2.nb = nb2; p2.gn = gn2; p2.tkb = tkb2; p2.tile_n = tile_n2; p2.N = N2;
  p2.gamma0 = gamma_down;
  p2.y = y;
  p2.part = part; p2.counters = counters;
  p2.rmax_in = rmax;
  return gemv::run<ternary::kStageRequant, ternary::kEpiScale>(p2, parts2, s);
}

// ``xq8``: int8 scratch of M x (nb1 * 2 * round_up(4*tkb1, 128)) bytes for
// the truncated xq; ``hq8``: M x (nb2 * 2 * round_up(4*tkb2, 128)) bytes for
// the requantized h (bitplane_mma.cuh, stage_kernel)
extern "C" int ternary_swiglu_mma(const float* xq, const float* sx, int M,
                                  int K, const uint8_t* plane_gate,
                                  const uint8_t* plane_up, int nb1, int gn1,
                                  int tkb1, int tile_n1, int N1,
                                  const uint8_t* plane_down, int nb2, int gn2,
                                  int tkb2, int tile_n2, int N2,
                                  float gamma_gate, float gamma_up,
                                  float gamma_down, float* h, int* rmax,
                                  float* y, void* stream, int8_t* xq8,
                                  int8_t* hq8) {
  namespace mma8 = ternary::mma8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = (int)cudaMemsetAsync(rmax, 0, sizeof(int) * (size_t)M, s);
  if (err != 0) return err;
  ternary::Args p1, p2;
  swiglu_args(xq, sx, M, K, plane_gate, plane_up, nb1, gn1, tkb1, tile_n1, N1,
              plane_down, nb2, gn2, tkb2, tile_n2, N2, gamma_gate, gamma_up,
              gamma_down, h, rmax, y, &p1, &p2);
  err = mma8::run<ternary::kStageTrunc, mma8::TileGateUp, ternary::kEpiSwiglu>(
      p1, xq8, s);
  if (err != 0) return err;
  return mma8::run<ternary::kStageRequant, mma8::TileX8, ternary::kEpiScale>(
      p2, hq8, s);
}
