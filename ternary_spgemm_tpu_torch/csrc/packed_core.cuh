// Core of the f32 stride-packed SpMM kernels (packed.cu: CudaPacked2Bit and
// CudaPacked53, F = 4 two-bit or F = 5 base-3 codes a byte, f32 X as it
// is). Args and the constants are bitplane_core.cuh's. The int8-X kernels
// over the packed-row containers (the tiled-dense, dense i8, block-packed
// and stride-packed i8 ones) run dense_mma.cuh's bf16 tensor-core tile,
// as do the f32 and bf16 dense kernels.
//
// The layout (ternary_spgemm_tpu_torch/formats/packed.py, tiled.py): the K
// axis is cut into nb blocks of B = F*tkq dense rows, the N axis into gn
// storage tiles of tile_n columns; packed row kq of block kb, tile g,
// column n is the byte
//     w[((kb*gn + g)*tkq + kq)*tile_n + n]
// and holds, in field f < F, the weight of dense row kb*B + f*tkq + kq.
// PackedTernary2Bit / PackedTernary53 (Kq, N) uint8, the global stride, is
// it with one block: nb = gn = 1, tkq = Kq, tile_n = N.
// The F weights of one byte are tkq dense rows apart, not adjacent, so the
// bitplane core's staging (four adjacent rows under one 16-byte shared load)
// does not fit. Here a chunk of KTQ packed rows stages its X as F runs of
// KTQ columns, one run per field, and a warp takes four consecutive packed
// rows at a time: per field and row of X, one 16-byte shared load feeds the
// four multiply-adds of those rows.
//
// Design, simple first (as bitplane_core.cuh):
//   * one output column per lane, 32 columns x 8 warps a block; a warp's
//     load of one packed row is one 32-byte sector;
//   * an M-tile of MT <= 32 rows of X is staged per chunk in shared memory;
//   * the 8 warps split each chunk's groups of four packed rows; their
//     partial sums are added in shared memory in a fixed warp order, so the
//     f32 sums are deterministic;
//   * the ragged edges are masked here, not padded: a packed row at or past
//     tkq is not read, a dense row at or past K stages x = 0 (K pads only
//     to B), a column at or past N is neither read nor written. The wrapper
//     makes no padded copy.
//
// Decoding, exact for every byte the packers emit (ops/pallas_kernels.py
// _decode_block :530):
//   * F = 4: the arithmetic sign-extend (p << (30 - 2j)) >> 30, codes
//     {0, 1, 3} -> {0, +1, -1};
//   * F = 5: qn = (q*171) >> 9 (= q / 3 for q < 512), d = q - 3*qn, q = qn,
//     w = d - 3*(d >> 1), digits {0, 1, 2} -> {0, +1, -1}.
//
// What bounds it on an H100: at M <= 32 the floor is the weight bytes (2
// or 1.6 bits a weight) at 3.35 TB/s, but like the bitplane core it
// issues, per weight and lane, MT multiply-adds and MT/4 shared loads plus
// the decode, far above that floor; at N = 4096 its grid is also only
// N/32 = 128 blocks. dense_mma.cuh's tile, with three bf16 pieces of f32
// X, is the design that replaces it (ROADMAP.md).
#pragma once

#include "bitplane_core.cuh"

namespace ternary {

template <int F>
struct PackedGeom {
  static_assert(F == 4 || F == 5, "factor 4 or 5");
  static constexpr int KTQ = 64;                  // packed rows a chunk
  static constexpr int CW = F * KTQ;              // staged X columns a chunk
  // the stage buffer also holds the 8 warps' partial sums (kCW per row)
  static constexpr int XS = CW > kCW ? CW : kCW;
  static_assert(KTQ % 4 == 0, "groups of four packed rows");
};

// The F weights of one packed byte ``p``.
template <int F>
__device__ __forceinline__ void decode_packed(unsigned p, int w[F]) {
  if constexpr (F == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = (int)(p << (30 - 2 * j)) >> 30;
  } else {
    static_assert(F == 5, "factor 4 or 5");
    unsigned q = p;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const unsigned qn = (q * 171u) >> 9;
      const int d = (int)(q - 3u * qn);
      q = qn;
      w[j] = d - 3 * (d >> 1);
    }
  }
}

// One block's tile of Y: rows [m0, m0 + MT), m0 = blockIdx.y * MT, and the
// kCols columns from blockIdx.x * kCols (one a lane, kWarps warps),
// y[gm * N + col] = X . W + b [PReLU] (col < a.N, gm < a.M).
template <int MT, int F>
__global__ void __launch_bounds__(kThreads) packed_kernel(const Args a) {
  using A = float;
  using G = PackedGeom<F>;
  __shared__ __align__(16) A xs[MT * G::XS];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kCols + lane;
  const int col = blockIdx.x * kCols + lane;
  const int m0 = blockIdx.y * MT;
  const bool col_ok = col < a.N;
  const int g = col_ok ? col / a.tile_n : 0;
  const int n = col_ok ? col - g * a.tile_n : 0;
  const int tkq = a.tkb;            // packed rows a block
  const int B = F * tkq;            // dense rows a block

  A acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0;

  for (int kb = 0; kb < a.nb; ++kb) {
    const uint8_t* wb =
        a.plane0 + ((size_t)kb * a.gn + g) * tkq * a.tile_n + n;
    for (int q0 = 0; q0 < tkq; q0 += G::KTQ) {
      const int tc = min(G::KTQ, tkq - q0);
      __syncthreads();   // previous chunk consumed
      for (int i = tid; i < MT * G::CW; i += kThreads) {
        const int m = i / G::CW, c = i - m * G::CW;
        const int f = c / G::KTQ, q = c - f * G::KTQ;
        const int gm = m0 + m;
        const int k = kb * B + f * tkq + q0 + q;
        A v = 0;
        if (q < tc && gm < a.M && k < a.K)
          v = a.x[(size_t)gm * a.K + k];
        xs[i] = v;
      }
      __syncthreads();
      if (col_ok) {
#pragma unroll 2
        for (int q = 4 * warp; q < tc; q += 4 * kWarps) {
          A w[4][F];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const unsigned p =
                q + r < tc ? wb[(size_t)(q0 + q + r) * a.tile_n] : 0u;
            int wi[F];
            decode_packed<F>(p, wi);
#pragma unroll
            for (int f = 0; f < F; ++f) w[r][f] = (A)wi[f];
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
#pragma unroll
            for (int f = 0; f < F; ++f) {
              const float4 xv = *reinterpret_cast<const float4*>(
                  &xs[m * G::CW + f * G::KTQ + q]);
              acc[m] += w[0][f] * xv.x + w[1][f] * xv.y + w[2][f] * xv.z +
                        w[3][f] * xv.w;
            }
          }
        }
      }
    }
  }

  // add the 8 warps' partial sums (warp w finishes rows w, w + 8, ...) and
  // apply _epilogue: float(acc) + b, then where(y > 0, y, alpha * y)
  constexpr int RPT = (MT + kWarps - 1) / kWarps;
  A* red = xs;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m) red[(warp * MT + m) * kCols + lane] = acc[m];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int m = warp + r * kWarps;
    const int gm = m0 + m;
    if (m < MT && gm < a.M && col_ok) {
      A s = 0;
      for (int w = 0; w < kWarps; ++w) s += red[(w * MT + m) * kCols + lane];
      float yv = (float)s + a.bias[col];
      if (a.alpha != nullptr) yv = yv > 0.0f ? yv : a.alpha[col] * yv;
      a.y[(size_t)gm * a.N + col] = yv;
    }
  }
}

// Y = X . W + b [PReLU] over a packed-row container (layout above),
// launched with the smallest M-tile that holds M (more row tiles above 32).
template <int F>
int run_packed(const float* x, int M, int K, const void* w, int nb, int gn,
               int tkq, int tile_n, int N, const float* bias,
               const float* alpha, float* y, void* stream) {
  Args a{};
  a.x = x; a.M = M; a.K = K;
  a.plane0 = static_cast<const uint8_t*>(w); a.plane1 = nullptr;
  a.nb = nb; a.gn = gn; a.tkb = tkq; a.tile_n = tile_n; a.N = N;
  a.bias = bias; a.alpha = alpha;
  a.y = y;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kCols, kWarps);
  if (M <= 4) {
    packed_kernel<4, F><<<dim3(cdiv(N, kCols), cdiv(M, 4)), block, 0, s>>>(a);
  } else if (M <= 8) {
    packed_kernel<8, F><<<dim3(cdiv(N, kCols), cdiv(M, 8)), block, 0, s>>>(a);
  } else if (M <= 16) {
    packed_kernel<16, F><<<dim3(cdiv(N, kCols), cdiv(M, 16)), block, 0, s>>>(a);
  } else {
    packed_kernel<32, F><<<dim3(cdiv(N, kCols), cdiv(M, 32)), block, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace ternary
