// Shared core of the TiledBitplane kernels: one templated kernel that
// decodes the split-sign bitplanes (2 bits per weight) straight from the
// container bytes and accumulates exact int32 dot products.
//
// Container (ternary_spgemm_tpu_torch/formats/bitplane.py): plane
// (nb, gn, 2*tkb, tile_n) uint8; byte-row t of a K-block's pos plane (rows
// [0, tkb)) holds in bit j the +1 flag of dense row 4t + j (j < 4) or
// 4*tkb + 4t + (j - 4) (j >= 4); the neg plane (rows [tkb, 2*tkb)) the -1
// flags. That map is the TPU bitcast's byte order
// (ternary_spgemm_tpu/ops/pallas_kernels.py:966-1023).
//
// Design, simple first:
//   * one output column per lane: a warp reads 32 neighbouring bytes of a
//     plane row (one 32-byte sector), coalesced;
//   * a block is 32 columns x 8 warps; the 8 warps split each staged chunk's
//     byte-rows and their partial sums are added in shared memory at the
//     end (integer sums, so the result is exact and order-free);
//   * an M-tile of MT <= 32 rows of activations is staged per chunk of 32
//     byte-rows in shared memory, already converted to int32 by the STAGE
//     rule (x8 round+clamp, i8 floor, truncation, or the per-row
//     requantize); the four dense rows of one nibble are adjacent, so one
//     16-byte shared load feeds four multiply-adds per row;
//   * each lane decodes a byte pair into w in {-1, 0, +1} once and reuses it
//     for all MT rows; w * x is one integer multiply-add.
//
// What bounds it on an H100: at decode sizes (M <= 32) the weight bytes are
// the floor — 2 bits per weight at 3.35 TB/s — but this first kernel spends
// about (3 + MT) integer instructions per weight and lane, so it is bound by
// issue rate, not by memory. The tensor cores (int8 mma / wgmma) and a
// pipelined TMA stream of the planes are the later, faster design.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ternary {

constexpr int kCols = 32;          // output columns per block, one per lane
constexpr int kWarps = 8;          // warps per block, splitting the byte-rows
constexpr int kThreads = kCols * kWarps;
constexpr int kTC = 32;            // byte-rows per staged chunk
constexpr int kHalf = 4 * kTC;     // staged activation columns per nibble half
constexpr int kCW = 8 * kTC;       // staged activation columns per chunk
static_assert(kCW == kWarps * kCols, "reduction buffer reuses the stage buffer");

constexpr float kRqEps = 1e-12f;   // ops/fused_ffn.py _RQ_EPS
constexpr float kRqAbsmax = 127.0f;

enum StageMode { kStageX8 = 0, kStageI8 = 1, kStageTrunc = 2, kStageRequant = 3 };
enum EpiMode { kEpiBias = 0, kEpiSwiglu = 1, kEpiScale = 2 };

struct Args {
  const float* x;           // (M, K) f32 activations, row-major
  int M, K;
  const uint8_t* plane0;    // (nb, gn, 2*tkb, tile_n)
  const uint8_t* plane1;    // second plane of the same geometry (NP == 2)
  int nb, gn, tkb, tile_n, N;
  const float* bias;        // kEpiBias: (N,)
  const float* alpha;       // kEpiBias: (N,) PReLU slopes, or null
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

template <int STAGE>
__device__ __forceinline__ int stage_value(float v, float scale) {
  if (STAGE == kStageX8)      // _to_x8: round half to even, clamp +-127
    return (int)fminf(fmaxf(rintf(v), -127.0f), 127.0f);
  if (STAGE == kStageI8)      // the 8a + r - 512 split's value: floor(x)
    return (int)floorf(v + 512.0f) - 512;
  if (STAGE == kStageTrunc)   // astype(int8) of integer-valued floats
    return (int)v;
  return (int)rintf(v / scale);   // kStageRequant
}

template <int MT, int STAGE, int NP, int EPI>
__global__ void __launch_bounds__(kThreads) bitplane_kernel(const Args a) {
  __shared__ __align__(16) int xs[MT * kCW];
  __shared__ float rs[MT];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kCols + lane;
  const int col = blockIdx.x * kCols + lane;
  const int m0 = blockIdx.y * MT;
  const bool col_ok = col < a.N;
  const int g = col_ok ? col / a.tile_n : 0;
  const int n = col_ok ? col - g * a.tile_n : 0;
  const int B = 8 * a.tkb;

  if (STAGE == kStageRequant || EPI == kEpiScale) {
    if (tid < MT) rs[tid] = (m0 + tid < a.M) ? requant_scale(a.rmax_in, m0 + tid) : 1.0f;
  }

  int acc0[MT], acc1[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) { acc0[m] = 0; acc1[m] = 0; }

  const size_t slab_bytes = (size_t)2 * a.tkb * a.tile_n;
  const size_t neg_off = (size_t)a.tkb * a.tile_n;

  for (int kb = 0; kb < a.nb; ++kb) {
    const size_t slab = ((size_t)kb * a.gn + g) * slab_bytes + n;
    for (int t0 = 0; t0 < a.tkb; t0 += kTC) {
      const int tc = min(kTC, a.tkb - t0);
      __syncthreads();   // previous chunk consumed (and rs[] written)
      for (int i = tid; i < MT * kCW; i += kThreads) {
        const int m = i / kCW, c = i - m * kCW;
        const int h = c / kHalf, cc = c - h * kHalf;
        const int gm = m0 + m;
        const int k = kb * B + h * 4 * a.tkb + 4 * t0 + cc;
        int v = 0;
        if (cc < 4 * tc && gm < a.M && k < a.K)
          v = stage_value<STAGE>(a.x[(size_t)gm * a.K + k],
                                 STAGE == kStageRequant ? rs[m] : 1.0f);
        xs[i] = v;
      }
      __syncthreads();
      if (col_ok) {
#pragma unroll 4
        for (int tl = warp; tl < tc; tl += kWarps) {
          const size_t off = slab + (size_t)(t0 + tl) * a.tile_n;
          const unsigned p0 = a.plane0[off], q0 = a.plane0[off + neg_off];
          unsigned p1 = 0, q1 = 0;
          if (NP == 2) { p1 = a.plane1[off]; q1 = a.plane1[off + neg_off]; }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int w0[4], w1[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int b = 4 * h + j;
              w0[j] = (int)((p0 >> b) & 1u) - (int)((q0 >> b) & 1u);
              w1[j] = (int)((p1 >> b) & 1u) - (int)((q1 >> b) & 1u);
            }
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const int4 xv = *reinterpret_cast<const int4*>(
                  &xs[m * kCW + h * kHalf + 4 * tl]);
              acc0[m] += w0[0] * xv.x + w0[1] * xv.y + w0[2] * xv.z + w0[3] * xv.w;
              if (NP == 2)
                acc1[m] += w1[0] * xv.x + w1[1] * xv.y + w1[2] * xv.z + w1[3] * xv.w;
            }
          }
        }
      }
    }
  }

  // add the 8 warps' partial sums; warp w finishes rows w, w + 8, ...
  constexpr int RPT = (MT + kWarps - 1) / kWarps;
  int* red = xs;
  int s0[RPT], s1[RPT];
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
      int s = 0;
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
    if (EPI == kEpiBias) {
      // _epilogue: float(acc) + b, then where(y > 0, y, alpha * y)
      if (ok) {
        float yv = (float)s0[r] + a.bias[col];
        if (a.alpha != nullptr) yv = yv > 0.0f ? yv : a.alpha[col] * yv;
        a.y[o] = yv;
      }
    } else if (EPI == kEpiSwiglu) {
      // ops/fused_ffn.py:362-366: g = gg * (sx * acc_g), u = gu * (sx * acc_u),
      // h = (g * sigmoid(g)) * u; sigmoid = 1 / (1 + exp(-g)) evaluated in
      // f64 and rounded once to f32, as the plain version does (sigmoid_f32)
      float hv = 0.0f;
      if (ok) {
        const float sxm = a.sx[gm];
        const float gv = a.gamma0 * (sxm * (float)s0[r]);
        const float uv = a.gamma1 * (sxm * (float)s1[r]);
        const float sig = (float)(1.0 / (1.0 + exp(-(double)gv)));
        hv = (gv * sig) * uv;
        a.y[o] = hv;
      }
      // running row absmax: |h| >= 0, so its int bits order like the floats
      const int bits = __reduce_max_sync(0xffffffffu, __float_as_int(fabsf(hv)));
      if (lane == 0 && row_ok) atomicMax(&a.rmax_out[gm], bits);
    } else {
      // _phase2_scale: acc * (((rmax + eps) / 127) * gamma_down)
      if (ok) a.y[o] = (float)s0[r] * (rs[m] * a.gamma0);
    }
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Launch with the smallest M-tile that holds M (more row tiles above 32).
template <int STAGE, int NP, int EPI>
int launch_bitplane(const Args& a, cudaStream_t stream) {
  const dim3 block(kCols, kWarps);
  if (a.M <= 4) {
    bitplane_kernel<4, STAGE, NP, EPI><<<dim3(cdiv(a.N, kCols), cdiv(a.M, 4)), block, 0, stream>>>(a);
  } else if (a.M <= 8) {
    bitplane_kernel<8, STAGE, NP, EPI><<<dim3(cdiv(a.N, kCols), cdiv(a.M, 8)), block, 0, stream>>>(a);
  } else if (a.M <= 16) {
    bitplane_kernel<16, STAGE, NP, EPI><<<dim3(cdiv(a.N, kCols), cdiv(a.M, 16)), block, 0, stream>>>(a);
  } else {
    bitplane_kernel<32, STAGE, NP, EPI><<<dim3(cdiv(a.N, kCols), cdiv(a.M, 32)), block, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace ternary
