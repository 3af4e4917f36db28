// Core of the packed-row SpMM kernels: the int8 containers DenseTernary and
// TiledDenseTernary (one weight a byte, F = 1) and the block-packed
// containers BlockPackedTernary and TiledBlockPacked (F = 4 two-bit or F = 5
// base-3 codes a byte). The X rules, Args and the constants are
// bitplane_core.cuh's.
//
// One layout covers the four containers (ternary_spgemm_tpu_torch/formats/
// packed.py, tiled.py). The K axis is cut into nb blocks of B = F*tkq dense
// rows, the N axis into gn storage tiles of tile_n columns; packed row kq of
// block kb, tile g, column n is the byte
//     w[((kb*gn + g)*tkq + kq)*tile_n + n]
// and holds, in field f < F, the weight of dense row kb*B + f*tkq + kq:
//   * DenseTernary (K, N) int8: F = 1, nb = gn = 1, tkq = K, tile_n = N
//     (CudaDense_i8 only: the f32 and bf16 dense kernels and the ring's
//     products run on dense_mma.cuh's bf16 tensor-core tile);
//   * TiledDenseTernary (gk, gn, tile_k, tile_n) int8: F = 1, nb = gk,
//     tkq = tile_k;
//   * BlockPackedTernary (nb*tile_kq, N) uint8: gn = 1, tile_n = N;
//   * TiledBlockPacked (nb, gn, tile_kq, tile_n) uint8;
//   * PackedTernary2Bit / PackedTernary53 (Kq, N) uint8, the global stride:
//     nb = gn = 1, tkq = Kq, tile_n = N.
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
//   * an M-tile of MT <= 32 rows of X is staged per chunk in shared memory,
//     converted by the STAGE rule (f32 as is, bf16 rounding, i8 floor, x8
//     round and clamp);
//   * the 8 warps split each chunk's groups of four packed rows; their
//     partial sums are added in shared memory in a fixed warp order, so the
//     f32 sums are deterministic;
//   * the ragged edges are masked here, not padded: a packed row at or past
//     tkq is not read (DenseTernary's last group when K % 4 != 0), a dense
//     row at or past K stages x = 0 (K pads only to B), a column at or past
//     N is neither read nor written. The wrapper makes no padded copy.
//
// Decoding, exact for every byte the packers emit (ops/pallas_kernels.py
// _decode_block :530):
//   * F = 4: the arithmetic sign-extend (p << (30 - 2j)) >> 30, codes
//     {0, 1, 3} -> {0, +1, -1};
//   * F = 5: qn = (q*171) >> 9 (= q / 3 for q < 512), d = q - 3*qn, q = qn,
//     w = d - 3*(d >> 1), digits {0, 1, 2} -> {0, +1, -1}.
//
// What bounds it on an H100: at M <= 32 the floor is the weight bytes (8
// bits a weight for the int8 containers, 2 or 1.6 for the codes) at
// 3.35 TB/s, but like the bitplane core it issues, per weight and lane, MT
// multiply-adds and MT/4 shared loads plus the decode, far above that
// floor; at N = 4096 its grid is also only N/32 = 128 blocks. Tensor cores
// (as dense_mma.cuh's tile now does for f32 and bf16 X over DenseTernary),
// more blocks and a pipelined weight stream are the later, faster design.
#pragma once

#include "bitplane_core.cuh"

namespace ternary {

template <int F>
struct PackedGeom {
  static constexpr int KTQ = F == 1 ? kCW : 64;   // packed rows a chunk
  static constexpr int CW = F * KTQ;              // staged X columns a chunk
  // the stage buffer also holds the 8 warps' partial sums (kCW per row)
  static constexpr int XS = CW > kCW ? CW : kCW;
  static_assert(KTQ % 4 == 0, "groups of four packed rows");
};

// The F weights of one packed byte ``p`` (F = 1: the raw int8 weight).
template <int F>
__device__ __forceinline__ void decode_packed(unsigned p, int w[F]) {
  if constexpr (F == 1) {
    w[0] = (int)(int8_t)(uint8_t)p;
  } else if constexpr (F == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = (int)(p << (30 - 2 * j)) >> 30;
  } else {
    static_assert(F == 5, "factor 1, 4 or 5");
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
// y[gm * N + col] = stage(X) . W + b [PReLU] (col < a.N, gm < a.M).
template <int MT, int STAGE, int F>
__global__ void __launch_bounds__(kThreads) packed_kernel(const Args a) {
  using A = Acc<STAGE>;
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
          v = stage_value<STAGE>(a.x[(size_t)gm * a.K + k], 1.0f);
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
              const Acc4<STAGE> xv = *reinterpret_cast<const Acc4<STAGE>*>(
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

// Y = stage(X) . W + b [PReLU] over a packed-row container (layout above),
// launched with the smallest M-tile that holds M (more row tiles above 32).
template <int STAGE, int F>
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
    packed_kernel<4, STAGE, F><<<dim3(cdiv(N, kCols), cdiv(M, 4)), block, 0, s>>>(a);
  } else if (M <= 8) {
    packed_kernel<8, STAGE, F><<<dim3(cdiv(N, kCols), cdiv(M, 8)), block, 0, s>>>(a);
  } else if (M <= 16) {
    packed_kernel<16, STAGE, F><<<dim3(cdiv(N, kCols), cdiv(M, 16)), block, 0, s>>>(a);
  } else {
    packed_kernel<32, STAGE, F><<<dim3(cdiv(N, kCols), cdiv(M, 32)), block, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace ternary
