// What the port's integer SpMM cores share over the bit-plane container:
// the X rules (stage_value), the epilogues' per-element expressions
// (epi_*), the requantize scale (requant_scale), the row absmax's int bits
// (abs_bits), the rule and epilogue enums, the tensor-core core's
// arguments (Args, spmm_args) and cdiv. gemv_core.cuh's streaming decode body (the x8 and
// i8 bitplane kernels' decode branches, both phases of the fused PReLU FFN
// and of the fused SwiGLU's decode branch), bitplane_mma.cuh's int8
// tensor-core core, dense_mma.cuh's bf16 one and ell_core.cuh include it,
// so that the branches of a kernel stage and finish with one expression
// and give the same bits. It holds no kernel.
//
// The container (ternary_spgemm_tpu_torch/formats/bitplane.py),
// TiledBitplane: plane (nb, gn, 2*tkb, tile_n) uint8, tile-contiguous, a
// K-block of B = 8*tkb dense rows by a storage tile of tile_n columns per
// slab. Bit 4h + j of byte-row t of the pos plane (rows [0, tkb)) is the +1
// flag of dense row h*4*tkb + 4t + j, the neg plane (rows [tkb, 2*tkb)) the
// -1 flag: the low half (h = 0) and the high half of the block, in the row
// order of the TPU's int32 -> int8 bitcast
// (ternary_spgemm_tpu/ops/pallas_kernels.py:966-1023).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ternary {

// ell_core.cuh's block: output columns, one a lane, and warps
constexpr int kCols = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kCols * kWarps;

constexpr float kRqEps = 1e-12f;   // ops/fused_ffn.py _RQ_EPS
constexpr float kRqAbsmax = 127.0f;

enum StageMode { kStageX8 = 0, kStageI8 = 1, kStageTrunc = 2, kStageRequant = 3,
                 kStageBf16 = 4, kStageF32 = 5 };
// kEpiBias: + b [PReLU]; kEpiSwiglu: the silu-mul of two planes + row
// absmax; kEpiScale: the requantized product's scale; kEpiBiasRmax: + b
// [PReLU] + row absmax; kEpiScaleBias: scale, then + b [PReLU]
enum EpiMode { kEpiBias = 0, kEpiSwiglu = 1, kEpiScale = 2, kEpiBiasRmax = 3,
               kEpiScaleBias = 4 };

// The ELL core's sums by X rule (ell_core.cuh): f32 X in f32, the integer
// rules in int
template <int STAGE>
using Acc = typename std::conditional<STAGE == kStageF32, float, int>::type;

struct Args {
  const float* x;           // (M, K) f32 activations, row-major
  int M, K;
  const uint8_t* plane0;    // the weights (TiledBitplane's plane)
  const uint8_t* plane1;    // second plane of the same geometry (NP == 2)
  int nb, gn, tkb, tile_n, N;
  const float* bias;        // bitplane_mma.cuh's kEpiBias: (N,)
  const float* alpha;       // the same: (N,) PReLU slopes, or null
  const float* sx;          // kEpiSwiglu: (M,) input row scales
  const int* rmax_in;       // kStageRequant / kEpiScale: (M,) row absmax bits
  int* rmax_out;            // kEpiSwiglu: (M,) row absmax bits, pre-zeroed
  float gamma0, gamma1;
  float* y;                 // (M, N) f32 output
};

// Per-row requantize scale, the op order of ops/fused_ffn.py
// _load_hidden_q / _phase2_scale: (rowmax + eps) / 127 (IEEE division).
__device__ __forceinline__ float requant_scale(const int* rmax, int m) {
  return (__int_as_float(rmax[m]) + kRqEps) / kRqAbsmax;
}

// The staged value of one activation by this core's rules (the float
// rules, kStageBf16 and kStageF32, are dense_mma.cuh's and ell_core.cuh's).
template <int STAGE>
__device__ __forceinline__ int stage_value(float v, float scale) {
  if constexpr (STAGE == kStageX8)       // _to_x8: round half to even, clamp
    return (int)fminf(fmaxf(rintf(v), -127.0f), 127.0f);
  else if constexpr (STAGE == kStageI8)  // the 8a + r - 512 split's value
    return (int)floorf(v + 512.0f) - 512;
  else if constexpr (STAGE == kStageTrunc)   // astype(int8) of integer floats
    return (int)v;
  else {
    static_assert(STAGE == kStageRequant, "an integer X rule");
    return (int)rintf(v / scale);
  }
}

// The epilogues' per-element expressions, shared by the decode body
// (gemv_core.cuh) and the tensor-core core (bitplane_mma.cuh) so that both
// branches of a kernel give the same bits: multiplies or one add, nothing
// that contracts into an FMA.

// _epilogue: float(acc) + b, then where(y > 0, y, alpha * y)
__device__ __forceinline__ float epi_bias(float acc, const float* bias,
                                          const float* alpha, int col) {
  float v = acc + bias[col];
  if (alpha != nullptr) v = v > 0.0f ? v : alpha[col] * v;
  return v;
}

// ops/fused_ffn.py:362-366: g = gg * (sx * acc_g), u = gu * (sx * acc_u),
// h = (g * sigmoid(g)) * u; sigmoid = 1 / (1 + exp(-g)) evaluated in f64 and
// rounded once to f32, as the plain version does (sigmoid_f32)
__device__ __forceinline__ float epi_swiglu(float acc_g, float acc_u, float sx,
                                            float gamma_g, float gamma_u) {
  const float gv = gamma_g * (sx * acc_g);
  const float uv = gamma_u * (sx * acc_u);
  const float sig = (float)(1.0 / (1.0 + exp(-(double)gv)));
  return (gv * sig) * uv;
}

// _phase2_scale: acc * (((rmax + eps) / 127) * gamma_down)
__device__ __forceinline__ float epi_scale(float acc, float rs, float gamma) {
  return acc * (rs * gamma);
}

// The int bits of |v|, which order like the floats (|v| >= 0): the running
// row absmax folds them with atomicMax
__device__ __forceinline__ int abs_bits(float v) {
  return __float_as_int(fabsf(v));
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The arguments of one SpMM, Y = stage(X) . W + b [PReLU], over one weight
// container (bitplane_mma.cuh run_spmm_mma): ``w`` is the container's
// weight tensor, (nb, gn, ...) its first two dimensions, ``tkb`` its
// byte-rows per K-block.
inline Args spmm_args(const float* x, int M, int K, const void* w, int nb,
                      int gn, int tkb, int tile_n, int N, const float* bias,
                      const float* alpha, float* y) {
  Args a{};
  a.x = x; a.M = M; a.K = K;
  a.plane0 = static_cast<const uint8_t*>(w); a.plane1 = nullptr;
  a.nb = nb; a.gn = gn; a.tkb = tkb; a.tile_n = tile_n; a.N = N;
  a.bias = bias; a.alpha = alpha;
  a.y = y;
  return a;
}

}  // namespace ternary
