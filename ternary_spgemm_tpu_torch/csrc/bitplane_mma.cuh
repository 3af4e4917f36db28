// Y = X . W over the TiledBitplane container on Hopper's int8 tensor cores
// (mma.sync m16n8k32 s8 x s8 -> s32): one core, the prefill branch of three
// kernels, each an instantiation with its own pre-pass and epilogue:
//   * CudaTiledBitplane_x8 (ternary_bitplane_x8_mma): kStageX8, kEpiBias;
//   * CudaTiledBitplane_i8 (ternary_bitplane_i8_mma): kStageI8, kEpiBias;
//   * fused_bitplane_swiglu (swiglu.cu, ternary_swiglu_mma): the gate and up
//     product (kStageTrunc, two weight planes, kEpiSwiglu), then the down
//     product (kStageRequant, kEpiScale).
//
// Replaces, at prefill sizes, pallas_tiled_bitplane_x8_kernel
// (ternary_spgemm_tpu/ops/pallas_kernels.py:1552; body
// _tiled_bitplane_x8_kernel :1518), pallas_tiled_bitplane_i8_kernel (:1277;
// bodies :1172-1264) and ternary_spgemm_tpu/ops/fused_ffn.py::
// fused_bitplane_swiglu (:384, body _swiglu_kernel :316), which decode the
// two halves of each K-block to int8 and issue int8 MXU dots into int32
// accumulators. The same functions here, every sum an exact int32, every
// epilogue the decode body's expression in its op order (bitplane_core.cuh
// epi_*; multiplies or one add, nothing that contracts into an FMA), so
// Y, the SwiGLU's h and its row absmax are bitwise the decode branch's and
// the integer products bitwise the plain versions' (ops/cuda_kernels.py,
// ops/fused_ffn.py):
//   * x8: X rounded half to even and clamped to +-127 (_to_x8 :1536);
//   * i8: v = floor(x + 512) - 512 (the value of the TPU's split) as two
//     int8 planes, hi = v >> 5 in [-16, 16] and lo = v & 31 in [0, 31] for
//     |v| <= 512, with 32*hi + lo == v; x.w = hi.(32w) + lo.w and 32w is
//     still int8, so each k-step issues two mma into the same accumulators.
//     Out of the domain hi is stored as the low byte of v >> 5, so the
//     branch is exact for v in [-4096, 4095] and beyond it computes with
//     32*int8(v >> 5) + (v & 31), which differs from v by a multiple of
//     8192 (the TPU kernel's own split wraps beyond +-512 too);
//   * SwiGLU: xq truncated to int8 (|xq| <= 127, the requantize's output),
//     g and u from two accumulator sets, h = (g * sigmoid(g)) * u written to
//     the f32 scratch h, the row absmax folded by atomicMax on the bits of
//     |h| once a warp and row (max is order-free); then h requantized as it
//     is staged, rint(h / ((rmax + 1e-12) / 127)) with an IEEE division, and
//     the down product scaled by ((rmax + 1e-12) / 127) * gamma_down.
//
// What bounds it on an H100: at M = 512 on the merged QKV (512 x 4096 x
// 12288) the bytes are ~14 us at 3.35 TB/s but the product is 51.5 G int8
// operations as a tensor core runs them (zeros included): 26 us at the
// 1,979 TOP/s peak. So the operations bound it, and they must run on the
// tensor cores; the decode body (gemv_core.cuh) spends a __dp4a per four
// weights and row on the CUDA cores and decodes all of W again for each
// row tile of 16 (8 with the SwiGLU's two plane sets).
//
// Design, simple first (no cp.async or TMA pipeline, no wgmma, no split-K:
// later work; each block walks its chunks of K in series, synchronously,
// which sets a floor of ~0.07 ms at K = 4096 whatever M is):
//   * a pre-pass (stage_kernel) writes the staged X once, as int8, into a
//     scratch the wrapper allocates: NA planes (i8: hi, then lo) of M rows
//     of pitch P = nb * 2 * Hp, where each K-block contributes its low half
//     (dense rows [0, 4*tkb)) and its high half ([4*tkb, 8*tkb)), each
//     zero-padded to Hp = round_up(4*tkb, 128) bytes and zero past K. A
//     staged chunk's X is then two aligned 128-byte runs a row and plane,
//     whatever tkb is; the product reads 1 byte an activation and plane
//     instead of 4 and stages once instead of once per N-tile;
//   * a block computes a kBM x kBN tile of Y with 8 warps (2 x 4), each MF
//     m16 x NF n8 fragments for each of its NB weight planes: 128 x 128 and
//     64 x 32 a warp for one plane; 128 x 64 and 64 x 16 a warp for the
//     SwiGLU's gate and up, whose two accumulator sets then hold as many
//     registers as one. For each chunk of 32 byte-rows of a K-block it
//     stages, with 16-byte loads, the int8 X tile (kBM rows x NA planes x
//     128 low-half and 128 high-half k, rows padded against bank conflicts)
//     and the RAW pos and neg plane bytes of each weight plane (32
//     byte-rows x kBN columns each: 4x fewer bytes than decoded int8). The
//     tiles under 48 KB (x8 and the SwiGLU's down product 44,032 bytes,
//     gate and up 45,056) take static shared memory; the i8 tile stages
//     twice the X bytes, in 76,800 bytes of dynamic shared memory (two
//     blocks an SM still fit), so that it walks as many chunks as the x8
//     tile;
//   * the plane bytes decode straight into B fragments: a B register holds
//     4 consecutive k of one column, and byte-row t's low nibble holds
//     dense rows 4t..4t+3 of the block (its high nibble 4*tkb + 4t..+3).
//     For the k-step at 32s of a half, lane (g, t4) reads the pos and neg
//     bytes of byte-rows 8s + t4 and 8s + 4 + t4 of column g; the low
//     nibbles give the low half's B fragment, the high nibbles the high
//     half's, so one byte load feeds two k-steps. A nibble decodes with
//     one multiply that spreads its 4 bits to 4 bytes and a bytewise
//     pos - neg, ~8 instructions for 4 weights, used by MF m-fragments
//     (and, for i8, shifted once to 32w for the hi plane);
//   * A fragments come from shared memory by ldmatrix (16 x 32 int8 is the
//     b16 8x8 x4 layout), each one feeding every weight plane's mma;
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
#include "ternary4.cuh"   // ternary4, times32

namespace ternary {
namespace mma8 {

constexpr int kThreads = 256;                  // 8 warps
constexpr int kTC = 32;                        // byte-rows per staged chunk
constexpr int kHalf = 4 * kTC;                 // k of one half per chunk

// The tile of one instantiation: NA int8 planes of X (i8: hi and lo), NB
// weight planes that share them (the SwiGLU's gate and up), 8 warps as
// 2 x 4, each MF m16 x NF n8 fragments a weight plane.
template <int NA_, int NB_, int MF_, int NF_>
struct Tile {
  static constexpr int NA = NA_, NB = NB_, MF = MF_, NF = NF_;
  static constexpr int kWarpsM = 2, kWarpsN = 4;
  static constexpr int kWM = 16 * MF, kWN = 8 * NF;
  static constexpr int kBM = kWarpsM * kWM, kBN = kWarpsN * kWN;
  static constexpr int kXS = NA * 2 * kHalf + 16;   // X tile row stride, bytes
  static constexpr int kWS = kBN + 16;              // plane tile row stride
  // the X tile, then per weight plane its pos rows and its neg rows
  static constexpr int kSmem = kBM * kXS + NB * 2 * kTC * kWS;
  // static shared memory up to the 48 KB a launch gets by default; above
  // it, dynamic, with the limit raised before the launch
  static constexpr bool kStaticSmem = kSmem <= 48 * 1024;
};
using TileX8 = Tile<1, 1, 4, 4>;       // 128 x 128; also the SwiGLU's down
using TileI8 = Tile<2, 1, 4, 4>;       // 128 x 128, X as hi and lo
using TileGateUp = Tile<1, 2, 4, 2>;   // 128 x 64, gate and up

// The decode core's arguments (the weight planes plane0 and, for NB == 2,
// plane1; the geometry; the epilogue's operands; y), whose x the pre-pass
// reads, plus the scratch the product reads instead.
struct Args : ternary::Args {
  const int8_t* xq;         // NA planes of (M, P) int8, written by stage_kernel
  size_t plane_stride;      // bytes from one plane of xq to the next: M * P
  int P, Hp;                // row pitch, padded half length (bytes)
};

// The scratch's padded half length Hp for a container of tkb byte-rows a
// K-block; its row pitch is P = nb * 2 * Hp (ops/cuda_kernels.py
// mma_row_bytes).
inline int half_pad(int tkb) { return cdiv(4 * tkb, kHalf) * kHalf; }

// The scratch: plane a of STAGE(X[m, kb*8*tkb + h*4*tkb + c]) at byte
// a*M*P + m*P + (2*kb + h)*Hp + c for c < 4*tkb (and inside K), 0
// elsewhere; four bytes of each plane a thread. kStageRequant reads the row
// absmax ``rmax``; kStageI8 writes two planes (hi, lo), every other rule one.
template <int STAGE>
__global__ void stage_kernel(const float* __restrict__ x, int M, int K,
                             int tkb, int Hp, int P,
                             const int* __restrict__ rmax,
                             char4* __restrict__ xq) {
  const int H = 4 * tkb, B = 8 * tkb, words = P / 4;
  const size_t total = (size_t)M * words;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / words);
    const int c = 4 * (int)(i - (size_t)m * words);
    const int seg = c / Hp, cc = c - seg * Hp;      // seg = 2*kb + h
    const int k = (seg >> 1) * B + (seg & 1) * H + cc;
    float scale = 1.0f;
    if constexpr (STAGE == kStageRequant) scale = requant_scale(rmax, m);
    int v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (cc < H && k + j < K)
                 ? stage_value<STAGE>(x[(size_t)m * K + k + j], scale) : 0;
    if constexpr (STAGE == kStageI8) {
      // v = 32 * (v >> 5) + (v & 31); the hi byte wraps outside [-4096, 4095]
      xq[i] = make_char4((signed char)(v[0] >> 5), (signed char)(v[1] >> 5),
                         (signed char)(v[2] >> 5), (signed char)(v[3] >> 5));
      xq[total + i] = make_char4((signed char)(v[0] & 31), (signed char)(v[1] & 31),
                                 (signed char)(v[2] & 31), (signed char)(v[3] & 31));
    } else {
      xq[i] = make_char4((signed char)v[0], (signed char)v[1],
                         (signed char)v[2], (signed char)v[3]);
    }
  }
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

// VEC: the planes are 16-byte aligned and tile_n a multiple of 16, so a
// staged 16-column group lies in one tile and loads as one uint4.
template <class T, int EPI, bool VEC>
__global__ void __launch_bounds__(kThreads, 2) mma_kernel(const Args a) {
  __shared__ __align__(16) uint8_t smem_static[T::kStaticSmem ? T::kSmem : 16];
  extern __shared__ __align__(16) uint8_t smem_dynamic[];
  uint8_t* const smem = T::kStaticSmem ? smem_static : smem_dynamic;
  int8_t* xs = reinterpret_cast<int8_t*>(smem);   // kBM rows of kXS bytes
  uint8_t* ws = smem + T::kBM * T::kXS;           // NB x (pos, neg) x kTC rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp / T::kWarpsN) * T::kWM, wn = (warp % T::kWarpsN) * T::kWN;
  const int m0 = blockIdx.y * T::kBM, n0 = blockIdx.x * T::kBN;

  int acc[T::NB][T::MF][T::NF][4];
#pragma unroll
  for (int p = 0; p < T::NB; ++p)
#pragma unroll
    for (int i = 0; i < T::MF; ++i)
#pragma unroll
      for (int f = 0; f < T::NF; ++f)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[p][i][f][r] = 0;

  constexpr int XG_LOG = T::NA == 2 ? 5 : 4;      // 16-byte groups a row, log2
  constexpr int WG = T::kBN / 16;                 // 16-column groups
  const int chunks = a.Hp / kHalf;
  const size_t slab = (size_t)2 * a.tkb * a.tile_n;   // one (K-block, tile)
  for (int kb = 0; kb < a.nb; ++kb) {
    for (int ci = 0; ci < chunks; ++ci) {
      const int t0 = ci * kTC;
      __syncthreads();   // the previous chunk is consumed
      for (int i = tid; i < T::kBM << XG_LOG; i += kThreads) {
        // row r, plane and half ah = 2*plane + h, 16 bytes q
        const int r = i >> XG_LOG, ah = (i >> 3) & (2 * T::NA - 1), q = i & 7;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < a.M) {
          const int8_t* src = a.xq + (size_t)(m0 + r) * a.P +
                              (size_t)(2 * kb + (ah & 1)) * a.Hp + 4 * t0 +
                              16 * q;
          if constexpr (T::NA == 2) src += (ah >> 1) * a.plane_stride;
          v = *reinterpret_cast<const uint4*>(src);
        }
        *reinterpret_cast<uint4*>(xs + r * T::kXS + ah * kHalf + 16 * q) = v;
      }
      // weight row r: plane r / (2*kTC), pos or neg, byte-row t0 + r % kTC
      if constexpr (VEC) {
        for (int i = tid; i < T::NB * 2 * kTC * WG; i += kThreads) {
          const int r = i / WG, q = i % WG;
          const uint8_t* w = (T::NB == 2 && r >= 2 * kTC) ? a.plane1 : a.plane0;
          const int pl = (r / kTC) & 1, t = t0 + r % kTC;
          const int c = n0 + 16 * q, gg = c / a.tile_n;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (t < a.tkb && gg < a.gn)
            v = *reinterpret_cast<const uint4*>(
                w + ((size_t)kb * a.gn + gg) * slab +
                (size_t)(pl * a.tkb + t) * a.tile_n + (c - gg * a.tile_n));
          *reinterpret_cast<uint4*>(ws + r * T::kWS + 16 * q) = v;
        }
      } else {
        for (int i = tid; i < T::NB * 2 * kTC * T::kBN; i += kThreads) {
          const int r = i / T::kBN, j = i % T::kBN;
          const uint8_t* w = (T::NB == 2 && r >= 2 * kTC) ? a.plane1 : a.plane0;
          const int pl = (r / kTC) & 1, t = t0 + r % kTC;
          const int c = n0 + j, gg = c / a.tile_n;
          uint8_t v = 0;
          if (t < a.tkb && gg < a.gn)
            v = w[((size_t)kb * a.gn + gg) * slab +
                  (size_t)(pl * a.tkb + t) * a.tile_n + (c - gg * a.tile_n)];
          ws[r * T::kWS + j] = v;
        }
      }
      __syncthreads();

#pragma unroll
      for (int s = 0; s < kTC / 8; ++s) {
        // B fragments of the k-steps at 32s of the low and the high half,
        // for each weight plane
        uint32_t b[T::NB][2][T::NF][2];
#pragma unroll
        for (int p = 0; p < T::NB; ++p)
#pragma unroll
          for (int f = 0; f < T::NF; ++f) {
            const uint8_t* w = ws + p * 2 * kTC * T::kWS + wn + 8 * f + g;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const uint32_t pos = w[(8 * s + 4 * r + t4) * T::kWS];
              const uint32_t neg = w[(kTC + 8 * s + 4 * r + t4) * T::kWS];
              b[p][0][f][r] = ternary4(pos & 15u, neg & 15u);
              b[p][1][f][r] = ternary4(pos >> 4, neg >> 4);
            }
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t b32[T::NB][T::NF][2];   // i8: the hi plane's 32 w
          if constexpr (T::NA == 2) {
#pragma unroll
            for (int p = 0; p < T::NB; ++p)
#pragma unroll
              for (int f = 0; f < T::NF; ++f)
#pragma unroll
                for (int r = 0; r < 2; ++r) b32[p][f][r] = times32(b[p][h][f][r]);
          }
#pragma unroll
          for (int i = 0; i < T::MF; ++i) {
            uint32_t af[T::NA][4];
#pragma unroll
            for (int pa = 0; pa < T::NA; ++pa)
              ldmatrix_x4(af[pa], xs + (wm + 16 * i + (lane & 15)) * T::kXS +
                                      (2 * pa + h) * kHalf + 32 * s +
                                      16 * (lane >> 4));
#pragma unroll
            for (int f = 0; f < T::NF; ++f)
#pragma unroll
              for (int p = 0; p < T::NB; ++p) {
                if constexpr (T::NA == 2) {   // hi . 32w + lo . w
                  mma_s8(acc[p][i][f], af[0], b32[p][f]);
                  mma_s8(acc[p][i][f], af[1], b[p][h][f]);
                } else {
                  mma_s8(acc[p][i][f], af[0], b[p][h][f]);
                }
              }
          }
        }
      }
    }
  }

  // the fragment layout: acc[p][i][f][r] is row wm + 16i + g + 8(r >> 1),
  // column wn + 8f + 2t4 + (r & 1) of the block's tile; the expressions are
  // the decode body's (bitplane_core.cuh, epi_*)
#pragma unroll
  for (int i = 0; i < T::MF; ++i) {
    const int row0 = m0 + wm + 16 * i + g;
    float rs[2] = {1.0f, 1.0f}, sxm[2] = {0.0f, 0.0f};
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      if (row0 + 8 * rh >= a.M) continue;
      if constexpr (EPI == kEpiScale) rs[rh] = requant_scale(a.rmax_in, row0 + 8 * rh);
      if constexpr (EPI == kEpiSwiglu) sxm[rh] = a.sx[row0 + 8 * rh];
    }
    int bits[2] = {0, 0};   // kEpiSwiglu: this lane's absmax of h on each row
#pragma unroll
    for (int f = 0; f < T::NF; ++f)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = row0 + 8 * (r >> 1);
        const int col = n0 + wn + 8 * f + 2 * t4 + (r & 1);
        if (row >= a.M || col >= a.N) continue;
        const size_t o = (size_t)row * a.N + col;
        if constexpr (EPI == kEpiBias) {
          a.y[o] = epi_bias((float)acc[0][i][f][r], a.bias, a.alpha, col);
        } else if constexpr (EPI == kEpiSwiglu) {
          const float hv = epi_swiglu((float)acc[0][i][f][r],
                                      (float)acc[1][i][f][r], sxm[r >> 1],
                                      a.gamma0, a.gamma1);
          a.y[o] = hv;
          bits[r >> 1] = max(bits[r >> 1], abs_bits(hv));
        } else {
          a.y[o] = epi_scale((float)acc[0][i][f][r], rs[r >> 1], a.gamma0);
        }
      }
    if constexpr (EPI == kEpiSwiglu) {
      // each row's four lanes (t4 = 0..3), then one atomicMax a warp and row
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        int b = max(bits[rh], __shfl_xor_sync(0xffffffffu, bits[rh], 1));
        b = max(b, __shfl_xor_sync(0xffffffffu, b, 2));
        if (t4 == 0 && row0 + 8 * rh < a.M) atomicMax(&a.rmax_out[row0 + 8 * rh], b);
      }
    }
  }
}

// The pre-pass of a.x (a.M x a.K f32) into the int8 scratch xq, T::NA
// planes of a.M x P bytes (kStageRequant reads a.rmax_in), then the product
// over it; returns cudaGetLastError() (or the error of raising the
// shared-memory limit).
template <int STAGE, class T, int EPI>
int run(const ternary::Args& base, int8_t* xq, cudaStream_t stream) {
  Args a{};
  static_cast<ternary::Args&>(a) = base;
  a.xq = xq;
  a.Hp = half_pad(a.tkb);
  a.P = a.nb * 2 * a.Hp;
  a.plane_stride = (size_t)a.M * a.P;
  const size_t words = a.plane_stride / 4;
  const int blocks = (int)std::min<size_t>((words + 255) / 256, 4096);
  stage_kernel<STAGE><<<blocks, 256, 0, stream>>>(
      a.x, a.M, a.K, a.tkb, a.Hp, a.P, a.rmax_in,
      reinterpret_cast<char4*>(xq));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const bool vec = a.tile_n % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.plane0) % 16 == 0 &&
                   (T::NB == 1 || reinterpret_cast<uintptr_t>(a.plane1) % 16 == 0);
  void (*kernel)(const Args) =
      vec ? &mma_kernel<T, EPI, true> : &mma_kernel<T, EPI, false>;
  if constexpr (!T::kStaticSmem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(cdiv(a.N, T::kBN), cdiv(a.M, T::kBM));
  kernel<<<grid, kThreads, T::kStaticSmem ? 0 : T::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Y = STAGE(X) . W + b [PReLU]: the tensor-core branch of an SpMM kernel
// over one TiledBitplane.
template <int STAGE, class T>
int run_spmm_mma(const float* x, int M, int K, const uint8_t* plane, int nb,
                 int gn, int tkb, int tile_n, int N, const float* bias,
                 const float* alpha, float* y, int8_t* xq,
                 cudaStream_t stream) {
  return run<STAGE, T, kEpiBias>(
      spmm_args(x, M, K, plane, nb, gn, tkb, tile_n, N, bias, alpha, y), xq,
      stream);
}

}  // namespace mma8
}  // namespace ternary
