// Y = x8(X) . W + b [PReLU] over the TiledBitplane container on Hopper's
// int8 tensor cores (mma.sync m16n8k32 s8 x s8 -> s32): the prefill branch
// of CudaTiledBitplane_x8, for M above the decode kernel's range.
//
// Replaces, at prefill sizes, pallas_tiled_bitplane_x8_kernel
// (ternary_spgemm_tpu/ops/pallas_kernels.py:1552; body
// _tiled_bitplane_x8_kernel :1518), which decodes the two halves of each
// K-block to int8 and issues one int8 MXU dot into an int32 accumulator.
// The same function here: X rounded half to even and clamped to +-127
// (_to_x8 :1536, stage_value<kStageX8>), an exact int32 dot with
// W in {-1, 0, +1}, the f32 epilogue float(acc) + b, then PReLU. The sums
// are exact, so Y is bitwise the plain version's (ops/cuda_kernels.py).
//
// What bounds it on an H100: at M = 512 on the merged QKV (512 x 4096 x
// 12288) the bytes are ~14 us at 3.35 TB/s but the product is 51.5 G int8
// operations as a tensor core runs them (zeros included): 26 us at the
// 1,979 TOP/s peak. So the operations bound it, and they must run on the
// tensor cores; the decode kernel (bitplane_core.cuh) spends ~(3 + MT)
// scalar instructions per weight and decodes all of W again for each
// 32-row tile.
//
// Design, simple first (no cp.async or TMA pipeline, no wgmma, no
// split-K: later work):
//   * a pre-pass (stage_x8) writes the x8-rounded X once, as int8, into a
//     scratch the wrapper allocates: row pitch P = nb * 2 * Hp, where each
//     K-block contributes its low half (dense rows [0, 4*tkb)) and its high
//     half ([4*tkb, 8*tkb)), each zero-padded to Hp = round_up(4*tkb, 128)
//     bytes and zero past K. A staged chunk's X is then two aligned
//     128-byte runs a row, whatever tkb is; the product reads 1 byte an
//     activation instead of 4 and rounds once instead of once per N-tile;
//   * a block computes a 128 x 128 tile of Y with 8 warps, each 64 x 32
//     (4 m16 x 4 n8 fragments, 64 int32 accumulators a thread). For each
//     chunk of 32 byte-rows of a K-block it stages, with 16-byte loads,
//     the int8 X tile (128 rows x 128 low-half and 128 high-half k, rows
//     padded against bank conflicts) and the RAW pos and neg plane bytes
//     (32 byte-rows x 128 columns each: 4x fewer bytes than decoded int8);
//   * the plane bytes decode straight into B fragments: a B register holds
//     4 consecutive k of one column, and byte-row t's low nibble holds
//     dense rows 4t..4t+3 of the block (its high nibble 4*tkb + 4t..+3).
//     For the k-step at 32s of a half, lane (g, t4) reads the pos and neg
//     bytes of byte-rows 8s + t4 and 8s + 4 + t4 of column g; the low
//     nibbles give the low half's B fragment, the high nibbles the high
//     half's, so one byte load feeds two k-steps. A nibble decodes with
//     one multiply that spreads its 4 bits to 4 bytes and a bytewise
//     pos - neg, ~8 instructions for 4 weights, used by 4 m-fragments;
//   * A fragments come from shared memory by ldmatrix (16 x 32 int8 is the
//     b16 8x8 x4 layout);
//   * any geometry the container can have: byte-rows past tkb in the last
//     chunk and columns past the last tile are zero-filled, each staged
//     16-column group finds its own (tile, column) when tile_n is a
//     multiple of 16 (byte loads otherwise), rows past M stage as zeros,
//     and the epilogue masks the ragged edges.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bitplane_core.cuh"

namespace ternary {
namespace mma8 {

constexpr int kBM = 128, kBN = 128;            // output tile of a block
constexpr int kWarpsM = 2, kWarpsN = 4;        // 8 warps, each 64 x 32
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWM = kBM / kWarpsM, kWN = kBN / kWarpsN;
constexpr int kMF = kWM / 16, kNF = kWN / 8;   // m16 and n8 fragments a warp
constexpr int kTC = 32;                        // byte-rows per staged chunk
constexpr int kHalf = 4 * kTC;                 // k of one half per chunk
constexpr int kXS = 2 * kHalf + 16;            // X tile row stride, bytes
constexpr int kWS = kBN + 16;                  // plane tile row stride, bytes

struct Args {
  const int8_t* xq;         // (M, P) int8 scratch written by stage_x8
  int M, P, Hp;             // rows, row pitch, padded half length (bytes)
  const uint8_t* plane;     // (nb, gn, 2*tkb, tile_n) uint8
  int nb, gn, tkb, tile_n, N;
  const float* bias;        // (N,)
  const float* alpha;       // (N,) PReLU slopes, or null
  float* y;                 // (M, N) f32
};

// The scratch: x8(X[m, kb*8*tkb + h*4*tkb + c]) at byte m*P + (2*kb + h)*Hp
// + c for c < 4*tkb (and inside K), 0 elsewhere; four bytes a thread.
__global__ void stage_x8(const float* __restrict__ x, int M, int K, int tkb,
                         int Hp, int P, char4* __restrict__ xq) {
  const int H = 4 * tkb, B = 8 * tkb, words = P / 4;
  const size_t total = (size_t)M * words;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / words);
    const int c = 4 * (int)(i - (size_t)m * words);
    const int seg = c / Hp, cc = c - seg * Hp;      // seg = 2*kb + h
    const int k = (seg >> 1) * B + (seg & 1) * H + cc;
    int v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (cc < H && k + j < K)
                 ? stage_value<kStageX8>(x[(size_t)m * K + k + j], 1.0f) : 0;
    xq[i] = make_char4((signed char)v[0], (signed char)v[1],
                       (signed char)v[2], (signed char)v[3]);
  }
}

// Four weights as packed int8 {-1, 0, +1}, byte j = pos bit j - neg bit j:
// the multiply spreads a nibble's bits to bit 0 of bytes 0..3; 0x80 + pos -
// neg per byte borrows across no byte, and ^0x80 makes it an int8.
__device__ __forceinline__ uint32_t ternary4(uint32_t p, uint32_t n) {
  const uint32_t sp = (p * 0x00204081u) & 0x01010101u;
  const uint32_t sn = (n * 0x00204081u) & 0x01010101u;
  return ((sp | 0x80808080u) - sn) ^ 0x80808080u;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t a[4], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// VEC: the plane is 16-byte aligned and tile_n a multiple of 16, so a
// staged 16-column group lies in one tile and loads as one uint4.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2) x8_mma_kernel(const Args a) {
  __shared__ __align__(16) int8_t xs[kBM * kXS];
  __shared__ __align__(16) uint8_t ws[2 * kTC * kWS];  // pos rows, neg rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp / kWarpsN) * kWM, wn = (warp % kWarpsN) * kWN;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[kMF][kNF][4];
#pragma unroll
  for (int i = 0; i < kMF; ++i)
#pragma unroll
    for (int f = 0; f < kNF; ++f)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][f][r] = 0;

  const int chunks = a.Hp / kHalf;
  const size_t slab = (size_t)2 * a.tkb * a.tile_n;   // one (K-block, tile)
  for (int kb = 0; kb < a.nb; ++kb) {
    for (int ci = 0; ci < chunks; ++ci) {
      const int t0 = ci * kTC;
      __syncthreads();   // the previous chunk is consumed
      for (int i = tid; i < kBM * 16; i += kThreads) {
        const int r = i >> 4, h = (i >> 3) & 1, q = i & 7;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < a.M)
          v = *reinterpret_cast<const uint4*>(
              a.xq + (size_t)(m0 + r) * a.P + (size_t)(2 * kb + h) * a.Hp +
              4 * t0 + 16 * q);
        *reinterpret_cast<uint4*>(xs + r * kXS + h * kHalf + 16 * q) = v;
      }
      if constexpr (VEC) {
        for (int i = tid; i < 2 * kTC * (kBN / 16); i += kThreads) {
          const int r = i / (kBN / 16), q = i % (kBN / 16);
          const int pl = r / kTC, t = t0 + r % kTC;
          const int c = n0 + 16 * q, gg = c / a.tile_n;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (t < a.tkb && gg < a.gn)
            v = *reinterpret_cast<const uint4*>(
                a.plane + ((size_t)kb * a.gn + gg) * slab +
                (size_t)(pl * a.tkb + t) * a.tile_n + (c - gg * a.tile_n));
          *reinterpret_cast<uint4*>(ws + r * kWS + 16 * q) = v;
        }
      } else {
        for (int i = tid; i < 2 * kTC * kBN; i += kThreads) {
          const int r = i / kBN, j = i % kBN;
          const int pl = r / kTC, t = t0 + r % kTC;
          const int c = n0 + j, gg = c / a.tile_n;
          uint8_t v = 0;
          if (t < a.tkb && gg < a.gn)
            v = a.plane[((size_t)kb * a.gn + gg) * slab +
                        (size_t)(pl * a.tkb + t) * a.tile_n + (c - gg * a.tile_n)];
          ws[r * kWS + j] = v;
        }
      }
      __syncthreads();

#pragma unroll
      for (int s = 0; s < kTC / 8; ++s) {
        // B fragments of the k-steps at 32s of the low and the high half
        uint32_t b[2][kNF][2];
#pragma unroll
        for (int f = 0; f < kNF; ++f) {
          const uint8_t* w = ws + wn + 8 * f + g;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t p = w[(8 * s + 4 * r + t4) * kWS];
            const uint32_t n = w[(kTC + 8 * s + 4 * r + t4) * kWS];
            b[0][f][r] = ternary4(p & 15u, n & 15u);
            b[1][f][r] = ternary4(p >> 4, n >> 4);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int i = 0; i < kMF; ++i) {
            uint32_t af[4];
            ldmatrix_x4(af, xs + (wm + 16 * i + (lane & 15)) * kXS +
                                h * kHalf + 32 * s + 16 * (lane >> 4));
#pragma unroll
            for (int f = 0; f < kNF; ++f) mma_s8(acc[i][f], af, b[h][f]);
          }
        }
      }
    }
  }

  // _epilogue: float(acc) + b, then where(y > 0, y, alpha * y)
#pragma unroll
  for (int i = 0; i < kMF; ++i)
#pragma unroll
    for (int f = 0; f < kNF; ++f)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + 16 * i + g + 8 * (r >> 1);
        const int col = n0 + wn + 8 * f + 2 * t4 + (r & 1);
        if (row < a.M && col < a.N) {
          float v = (float)acc[i][f][r] + a.bias[col];
          if (a.alpha != nullptr) v = v > 0.0f ? v : a.alpha[col] * v;
          a.y[(size_t)row * a.N + col] = v;
        }
      }
}

// The pre-pass, then the product; returns cudaGetLastError().
inline int run_x8_mma(const float* x, int M, int K, const uint8_t* plane,
                      int nb, int gn, int tkb, int tile_n, int N,
                      const float* bias, const float* alpha, float* y,
                      int8_t* xq, cudaStream_t stream) {
  Args a{};
  a.Hp = cdiv(4 * tkb, kHalf) * kHalf;
  a.P = nb * 2 * a.Hp;
  a.xq = xq; a.M = M;
  a.plane = plane; a.nb = nb; a.gn = gn; a.tkb = tkb; a.tile_n = tile_n;
  a.N = N; a.bias = bias; a.alpha = alpha; a.y = y;
  const size_t words = (size_t)M * a.P / 4;
  const int blocks = (int)std::min<size_t>((words + 255) / 256, 4096);
  stage_x8<<<blocks, 256, 0, stream>>>(x, M, K, tkb, a.Hp, a.P,
                                       reinterpret_cast<char4*>(xq));
  const dim3 grid(cdiv(N, kBN), cdiv(M, kBM));
  if (tile_n % 16 == 0 && reinterpret_cast<uintptr_t>(plane) % 16 == 0)
    x8_mma_kernel<true><<<grid, kThreads, 0, stream>>>(a);
  else
    x8_mma_kernel<false><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace mma8
}  // namespace ternary
