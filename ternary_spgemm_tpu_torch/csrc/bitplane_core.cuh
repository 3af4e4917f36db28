// Shared core of the CUDA-core SpMM kernels over the bit-plane and
// nibble-pair containers: one templated kernel that decodes the ternary
// weights straight from the container bytes and accumulates the dot
// products in exact int32 (every rule it runs stages integers). Its users:
// the x8 and i8 bitplane kernels up to their tensor-core splits
// (bitplane.cu), CudaTiledNibblePair_i8 (nibblepair.cu), the fused FFNs'
// decode branches (ffn.cu, swiglu.cu).
//
// Containers (ternary_spgemm_tpu_torch/formats/), all tile-contiguous, a
// K-block of B = 8*tkb dense rows by a storage tile of tile_n columns per
// slab. The core reads every one as tkb "byte-rows" t, each holding the
// weights of dense rows 4t + j (the low half) and 4*tkb + 4t + j (the high
// half) for j < 4 — the row order of the TPU's int32 -> int8 bitcast
// (ternary_spgemm_tpu/ops/pallas_kernels.py:966-1023):
//   * kWBitplane, TiledBitplane: plane (nb, gn, 2*tkb, tile_n) uint8; bit
//     4h + j of byte-row t of the pos plane (rows [0, tkb)) is the +1 flag
//     of dense row h*4*tkb + 4t + j, the neg plane (rows [tkb, 2*tkb)) the
//     -1 flag;
//   * kWNibble, TiledNibblePair: words (nb, gn, tkb, tile_n) int32 of 4-bit
//     two's-complement nibbles; little-endian byte j of word row t holds
//     dense row 4t + j in its low nibble and 4*tkb + 4t + j in its high one
//     (formats/bitplane.py:176-180, 208-214 of the JAX package).
// The int8, packed-code and bf16 bitplane kernels run dense_mma.cuh's bf16
// tensor-core tile instead.
//
// Design, simple first:
//   * one output column per lane: a warp reads 32 neighbouring elements of
//     a slab row (one 32-byte sector for the byte formats), coalesced;
//   * a block is 32 columns x 8 warps; the 8 warps split each staged chunk's
//     byte-rows and their partial sums are added in shared memory at the end
//     (in a fixed warp order);
//   * an M-tile of MT <= 32 rows of activations is staged per chunk of 32
//     byte-rows in shared memory, already converted by the STAGE rule (x8
//     round+clamp, i8 floor, truncation, or the per-row requantize); the
//     four dense rows of one half of a byte-row are adjacent, so one 16-byte
//     shared load feeds four multiply-adds per row;
//   * each lane loads a byte-row's bits once (load_row), decodes each half
//     into four w in {-1, 0, +1} (decode_half) and reuses them for all MT
//     rows; w * x is one multiply-add.
//
// What bounds it on an H100: at decode sizes (M <= 32) the weight bytes are
// the floor — 2 bits per weight (bitplane) or 4 (nibble) at
// 3.35 TB/s — but this first kernel spends about (3 + MT) instructions per
// weight and lane, so it is bound by issue rate, not by memory. The tensor
// cores (int8 / bf16 mma, wgmma) and a pipelined TMA stream of the weights
// are the later, faster design.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ternary {

constexpr int kCols = 32;          // output columns per block, one per lane
constexpr int kWarps = 8;          // warps per block, splitting the byte-rows
constexpr int kThreads = kCols * kWarps;
constexpr int kTC = 32;            // byte-rows per staged chunk
constexpr int kHalf = 4 * kTC;     // staged activation columns per half
constexpr int kCW = 8 * kTC;       // staged activation columns per chunk
static_assert(kCW == kWarps * kCols, "reduction buffer reuses the stage buffer");

constexpr float kRqEps = 1e-12f;   // ops/fused_ffn.py _RQ_EPS
constexpr float kRqAbsmax = 127.0f;

enum StageMode { kStageX8 = 0, kStageI8 = 1, kStageTrunc = 2, kStageRequant = 3,
                 kStageBf16 = 4, kStageF32 = 5 };
// kEpiBias: + b [PReLU]; kEpiSwiglu: the silu-mul of two planes + row
// absmax; kEpiScale: the requantized product's scale; kEpiBiasRmax: + b
// [PReLU] + row absmax; kEpiScaleBias: scale, then + b [PReLU]
enum EpiMode { kEpiBias = 0, kEpiSwiglu = 1, kEpiScale = 2, kEpiBiasRmax = 3,
               kEpiScaleBias = 4 };
enum WeightFmt { kWBitplane = 0, kWNibble = 1 };

// The ELL core's sums by X rule (ell_core.cuh): f32 X in f32, the integer
// rules in int
template <int STAGE>
using Acc = typename std::conditional<STAGE == kStageF32, float, int>::type;

struct Args {
  const float* x;           // (M, K) f32 activations, row-major
  int M, K;
  const uint8_t* plane0;    // the weights (layout by WeightFmt)
  const uint8_t* plane1;    // second plane of the same geometry (NP == 2)
  int nb, gn, tkb, tile_n, N;
  const float* bias;        // kEpiBias / BiasRmax / ScaleBias: (N,)
  const float* alpha;       // the same: (N,) PReLU slopes, or null
  const float* sx;          // kEpiSwiglu: (M,) input row scales
  const int* rmax_in;       // kStageRequant / kEpiScale(Bias): (M,) row absmax bits
  int* rmax_out;            // kEpiSwiglu / BiasRmax: (M,) row absmax bits, pre-zeroed
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

// The raw bits of one byte-row, read once per lane from element ``off``:
// the pos and neg bytes (kWBitplane; the neg plane ``second`` bytes on) or
// the nibble word (kWNibble).
template <int WFMT>
__device__ __forceinline__ uint2 load_row(const uint8_t* base, size_t off,
                                          size_t second) {
  if constexpr (WFMT == kWBitplane) {
    return make_uint2(base[off], base[off + second]);
  } else {
    return make_uint2((unsigned)reinterpret_cast<const int32_t*>(base)[off],
                      0u);
  }
}

// Weights of half h of a loaded byte-row: w[j] is dense row
// h*4*tkb + 4t + j of the block.
template <int WFMT>
__device__ __forceinline__ void decode_half(uint2 r, int h, int w[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (WFMT == kWBitplane) {
      const int b = 4 * h + j;
      w[j] = (int)((r.x >> b) & 1u) - (int)((r.y >> b) & 1u);
    } else {                                   // sign extend: ((v+8)&0xF)-8
      w[j] = (int)(((r.x >> (8 * j + 4 * h)) + 8u) & 0xFu) - 8;
    }
  }
}

// The epilogues' per-element expressions, shared with the tensor-core core
// (bitplane_mma.cuh) so that both branches of a kernel give the same bits:
// multiplies or one add, nothing that contracts into an FMA.

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

template <int MT, int STAGE, int NP, int EPI, int WFMT>
__global__ void __launch_bounds__(kThreads) bitplane_kernel(const Args a) {
  using A = int;
  __shared__ __align__(16) A xs[MT * kCW];
  __shared__ float rs[MT];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kCols + lane;
  const int col = blockIdx.x * kCols + lane;
  const int m0 = blockIdx.y * MT;
  const bool col_ok = col < a.N;
  const int g = col_ok ? col / a.tile_n : 0;
  const int n = col_ok ? col - g * a.tile_n : 0;
  const int B = 8 * a.tkb;

  if (STAGE == kStageRequant || EPI == kEpiScale || EPI == kEpiScaleBias) {
    if (tid < MT) rs[tid] = (m0 + tid < a.M) ? requant_scale(a.rmax_in, m0 + tid) : 1.0f;
  }

  A acc0[MT], acc1[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) { acc0[m] = 0; acc1[m] = 0; }

  // elements (of the format's type) of one (K-block, N-tile) slab; the neg
  // plane lies neg_off elements after the pos plane
  const size_t slab_elems = (size_t)(WFMT == kWBitplane ? 2 : 1) * a.tkb * a.tile_n;
  const size_t neg_off = (size_t)a.tkb * a.tile_n;

  for (int kb = 0; kb < a.nb; ++kb) {
    const size_t at = ((size_t)kb * a.gn + g) * slab_elems + n;
    for (int t0 = 0; t0 < a.tkb; t0 += kTC) {
      const int tc = min(kTC, a.tkb - t0);
      __syncthreads();   // previous chunk consumed (and rs[] written)
      for (int i = tid; i < MT * kCW; i += kThreads) {
        const int m = i / kCW, c = i - m * kCW;
        const int h = c / kHalf, cc = c - h * kHalf;
        const int gm = m0 + m;
        const int k = kb * B + h * 4 * a.tkb + 4 * t0 + cc;
        A v = 0;
        if (cc < 4 * tc && gm < a.M && k < a.K)
          v = stage_value<STAGE>(a.x[(size_t)gm * a.K + k],
                                 STAGE == kStageRequant ? rs[m] : 1.0f);
        xs[i] = v;
      }
      __syncthreads();
      if (col_ok) {
#pragma unroll 4
        for (int tl = warp; tl < tc; tl += kWarps) {
          const size_t off = at + (size_t)(t0 + tl) * a.tile_n;
          const uint2 r0 = load_row<WFMT>(a.plane0, off, neg_off);
          uint2 r1 = make_uint2(0u, 0u);
          if constexpr (NP == 2)
            r1 = load_row<WFMT>(a.plane1, off, neg_off);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int w0[4], w1[4];
            decode_half<WFMT>(r0, h, w0);
            if constexpr (NP == 2) decode_half<WFMT>(r1, h, w1);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const int4 xv = *reinterpret_cast<const int4*>(
                  &xs[m * kCW + h * kHalf + 4 * tl]);
              acc0[m] += w0[0] * xv.x + w0[1] * xv.y + w0[2] * xv.z + w0[3] * xv.w;
              if constexpr (NP == 2)
                acc1[m] += w1[0] * xv.x + w1[1] * xv.y + w1[2] * xv.z + w1[3] * xv.w;
            }
          }
        }
      }
    }
  }

  // add the 8 warps' partial sums; warp w finishes rows w, w + 8, ...
  constexpr int RPT = (MT + kWarps - 1) / kWarps;
  A* red = xs;
  A s0[RPT], s1[RPT];
#pragma unroll
  for (int pass = 0; pass < NP; ++pass) {
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MT; ++m)
      red[(warp * MT + m) * kCols + lane] = pass == 0 ? acc0[m] : acc1[m];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int m = warp + r * kWarps;
      A s = 0;
      if (m < MT)
        for (int w = 0; w < kWarps; ++w) s += red[(w * MT + m) * kCols + lane];
      if (pass == 0) s0[r] = s; else s1[r] = s;
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int m = warp + r * kWarps;
    const int gm = m0 + m;
    const bool row_ok = m < MT && gm < a.M;
    const bool ok = row_ok && col_ok;
    const size_t o = (size_t)gm * a.N + col;
    if (EPI == kEpiBias || EPI == kEpiBiasRmax) {
      float yv = 0.0f;
      if (ok) {
        yv = epi_bias((float)s0[r], a.bias, a.alpha, col);
        a.y[o] = yv;
      }
      if (EPI == kEpiBiasRmax) {   // the running row absmax, as kEpiSwiglu
        const int bits = __reduce_max_sync(0xffffffffu, abs_bits(yv));
        if (lane == 0 && row_ok) atomicMax(&a.rmax_out[gm], bits);
      }
    } else if (EPI == kEpiSwiglu) {
      float hv = 0.0f;
      if (ok) {
        hv = epi_swiglu((float)s0[r], (float)s1[r], a.sx[gm], a.gamma0,
                        a.gamma1);
        a.y[o] = hv;
      }
      const int bits = __reduce_max_sync(0xffffffffu, abs_bits(hv));
      if (lane == 0 && row_ok) atomicMax(&a.rmax_out[gm], bits);
    } else if (EPI == kEpiScale) {
      if (ok) a.y[o] = epi_scale((float)s0[r], rs[m], a.gamma0);
    } else {
      // ops/fused_ffn.py:189-191: acc * (((rmax + eps) / 127) * gamma) + b,
      // then PReLU; rounded products and sums, never one FMA, so that the
      // card rounds twice as the plain version does
      if (ok) {
        float yv = __fadd_rn(__fmul_rn((float)s0[r], __fmul_rn(rs[m], a.gamma0)),
                             a.bias[col]);
        if (a.alpha != nullptr) yv = yv > 0.0f ? yv : a.alpha[col] * yv;
        a.y[o] = yv;
      }
    }
  }
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Launch with the smallest M-tile that holds M (more row tiles above 32).
template <int STAGE, int NP, int EPI, int WFMT = kWBitplane>
int launch_bitplane(const Args& a, cudaStream_t stream) {
  const dim3 block(kCols, kWarps);
  if (a.M <= 4) {
    bitplane_kernel<4, STAGE, NP, EPI, WFMT><<<dim3(cdiv(a.N, kCols), cdiv(a.M, 4)), block, 0, stream>>>(a);
  } else if (a.M <= 8) {
    bitplane_kernel<8, STAGE, NP, EPI, WFMT><<<dim3(cdiv(a.N, kCols), cdiv(a.M, 8)), block, 0, stream>>>(a);
  } else if (a.M <= 16) {
    bitplane_kernel<16, STAGE, NP, EPI, WFMT><<<dim3(cdiv(a.N, kCols), cdiv(a.M, 16)), block, 0, stream>>>(a);
  } else {
    bitplane_kernel<32, STAGE, NP, EPI, WFMT><<<dim3(cdiv(a.N, kCols), cdiv(a.M, 32)), block, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// The arguments of one SpMM, Y = stage(X) . W + b [PReLU], over one weight
// container: ``w`` is the container's weight tensor, (nb, gn, ...) its first
// two dimensions, ``tkb`` its byte-rows per K-block.
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

// The entry point of every SpMM kernel on this core.
template <int STAGE, int WFMT>
int run_spmm(const float* x, int M, int K, const void* w, int nb, int gn,
             int tkb, int tile_n, int N, const float* bias,
             const float* alpha, float* y, void* stream) {
  return launch_bitplane<STAGE, 1, kEpiBias, WFMT>(
      spmm_args(x, M, K, w, nb, gn, tkb, tile_n, N, bias, alpha, y),
      static_cast<cudaStream_t>(stream));
}

}  // namespace ternary
