// Y = stage(X) . W + b [PReLU] over the unpadded (K, N) int8 DenseTernary
// plane on Hopper's bf16 tensor cores (mma.sync m16n8k16, bf16 x bf16 ->
// f32): one tile, used by
//   * CudaDense (dense.cu, ternary_dense_f32): kF32Pieces, f32 X exact;
//   * CudaDense_bf16 (dense.cu, ternary_dense_bf16): kBf16Pieces;
//   * the ring all-gather SpMM's compute warps (ring.cu), f32 X exact, on
//     the slot they hold and the rank's column shard of W.
//
// Replaces the product of ternary_spgemm_tpu/ops/pallas_kernels.py
// _dense_kernel (:113; launched by pallas_dense_kernel :173 and
// pallas_dense_bf16_kernel :181) and of ternary_spgemm_tpu/parallel/
// ring_kernel.py::_ring_kernel (:42). Both take the TPU's own route to an
// exact f32 product: "the TPU MXU computes f32 dots via multi-pass bf16
// products" (Precision.HIGHEST, pallas_kernels.py:124-131). Here:
//   * a ternary weight is exact in bf16 (0, 0x3F80 or 0xBF80; the
//     container holds no other byte, and another would decode wrongly);
//   * a finite f32 x splits into three bf16 pieces, hi = bf16(x), mid =
//     bf16(x - hi), lo = bf16(x - hi - mid) (round to nearest even; each
//     remainder exact in f32), and x == hi + mid + lo exactly for every x
//     with 2**-110 <= |x| < 0x1.FFp127 (3 x 8 significant bits cover f32's
//     24; below 2**-110 lo may lose bits under bf16's smallest subnormal,
//     2**-133; from 0x1.FFp127 on hi rounds to inf). hi not finite (x inf or NaN, or
//     rounding to inf) gives mid = lo = 0, so inf * 0 makes the NaN that
//     the plain f32 product makes (ops/cuda_kernels.py split_bf16 is the
//     Python twin);
//   * X.W = hi.W + mid.W + lo.W: every product exact, the sums in f32 by the
//     tensor cores. kBf16Pieces takes hi only: X rounded to bf16 as
//     _dense_kernel's bf16=True branch (:119-122) and ops/api.py to_bf16;
//   * on integer X every partial sum is an integer below 2**24, so the
//     result is exact whatever the order or the accumulator's rounding, and
//     bitwise the plain version's. Off the integers the tensor cores' f32
//     accumulation need not round as a CUDA-core add does; each group of
//     kSumSteps k-steps (64 rows of K) is summed into a zeroed fragment (its
//     error at the group's magnitude), and the groups are added into an
//     f32 accumulator on the CUDA cores (round to nearest). Every sum has a
//     fixed order, so the kernels are deterministic.
//
// What bounds it on an H100: at M = 512 (L: 512 x 4096 x 4096) the three
// passes are 51.5 G bf16 operations, 52 us at the 989 TFLOP/s peak, and the
// bytes ~14 us: the operations. At M <= 32 (the north star, 32 x 1024 x
// 4096) the W bytes, 1.25 us at 3.35 TB/s, under the latency of the
// chunks each block walks in series. The CUDA-core body it replaces
// (packed_core.cuh) spent MT f32 multiply-adds and MT/4 shared loads a
// weight and lane, zeros included: 0.26 ms at L even at the 67 TFLOP/s f32
// peak, against 0.45 ms for one f32 torch.matmul; only the tensor cores
// can take it under that. This first tile still pays each chunk's round
// trip to memory in series, and its staging (X split again for every tile
// of N) does not overlap its mma: a cp.async or TMA pipeline and wgmma are
// what would take it toward the passes' bound (PERF.md).
//
// Design, simple first (no cp.async or TMA pipeline, no wgmma: later work):
//   * 8 warps, each a 32 x 32 tile of Y (2 m16 x 4 n8 fragments); two
//     geometries: Narrow, 32 x 32 a block with the 8 warps splitting each
//     chunk's k-steps (a split-K inside the block, reduced in shared memory
//     in warp order): N/32 blocks, 128 at the north star, for M <= 32;
//     Wide, 64 x 128 a block (2 x 4 warps) above;
//   * a chunk of KC rows of K at a time: X staged from f32 (16-byte loads
//     where K allows), split into its pieces as it is staged, one bf16
//     plane a piece; W staged raw with 16-byte loads (byte loads where N or
//     the row stride is not a multiple of 16); all of a chunk's loads in
//     flight before its first store to shared memory. A fragments by
//     ldmatrix, each feeding four n8 fragments;
//   * B fragments decoded from the int8 bytes: a B register holds two
//     consecutive k of one column, two bytes a row stride apart. A lane
//     reads four 32-bit words (rows 2t, 2t+1, 2t+8, 2t+9 of the k-step,
//     columns 4g..4g+3) and interleaves them into the registers of four n8
//     fragments, so n8 fragment f holds the tile columns 4j + f (j < 8):
//     14 integer instructions for 16 weights, reused for every m-fragment
//     and every piece; lane (g, t)'s accumulators then cover columns 8t to
//     8t + 7 of its rows;
//   * the ragged edges are masked here: rows of X past M and columns of K
//     past K stage as 0, rows of W past K and columns past N as 0, the
//     epilogue writes only inside (M, N). The wrapper makes no padded copy;
//   * the epilogue goes through shared memory (the split-K's reduction):
//     float(acc) + b[col], then y > 0 ? y : alpha[col] * y (epi_bias, in
//     ops/api.py finish's order; nothing that contracts into an FMA),
//     coalesced stores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitplane_core.cuh"

namespace ternary {
namespace dmma {

constexpr int kThreads = 256;   // 8 warps
constexpr int kF32Pieces = 3;   // f32 X: hi, mid, lo
constexpr int kBf16Pieces = 1;  // X rounded to bf16
// k-steps (16 rows of K each) whose passes the tensor cores sum into one
// zeroed fragment: their f32 sums need not round as a CUDA-core add does
// (one accumulator across all of K = 4096 missed rtol=1e-5, atol=1e-3 at
// 512 x 4096 x 4096 on non-integer X on an H100), so each group's error
// stays at the group's magnitude and the groups are added on the CUDA
// cores, rounding to nearest
constexpr int kSumSteps = 4;

// A block's geometry: WM x WN warps over the output tile, the other
// 8 / (WM*WN) warps splitting each chunk's k-steps; KC rows of K a chunk.
template <int WM_, int WN_, int KC_>
struct Tile {
  static constexpr int WM = WM_, WN = WN_, KC = KC_;
  static constexpr int WK = 8 / (WM * WN);
  static constexpr int MF = 2, NF = 4;        // a warp: 32 x 32
  static constexpr int BM = 32 * WM, BN = 32 * WN;
  static constexpr int KS = KC / 16;          // k-steps a chunk
  static_assert(WM * WN * WK == 8 && KS % WK == 0, "8 warps, whole k-steps");
  // a warp's k-steps a zeroed fragment sums before it is added into the
  // f32 accumulator (kSumSteps, or all of the warp's steps of a chunk)
  static constexpr int PS = KS / WK < kSumSteps ? KS / WK : kSumSteps;
  static_assert(KS / WK % PS == 0, "whole groups of k-steps");
  static constexpr int kAS = KC + 8;          // X piece row stride, bf16
  static constexpr int kWS = BN + 16;         // W row stride, bytes
  static constexpr int kRS = BN + 1;          // reduction row stride, floats
  // the NP X pieces and the W rows of a chunk, then (reusing them) the WK
  // partial tiles of the reduction
  static constexpr int smem(int np) {
    const int stage = np * BM * kAS * 2 + KC * kWS;
    const int red = WK * BM * kRS * 4;
    return stage > red ? stage : red;
  }
};
using Narrow = Tile<1, 1, 256>;   // 32 x 32, the 8 warps split K
using Wide = Tile<2, 4, 128>;     // 64 x 128
// the largest M the Narrow tile takes
constexpr int kNarrowMaxM = 32;

struct Args {
  const float* x;        // (M, K) f32, row stride K
  int M, K;
  const int8_t* w;       // (K, N) int8, row stride ldw
  int ldw, N;
  const float* bias;     // (N,)
  const float* alpha;    // (N,) PReLU slopes, or null
  float* y;              // (M, N) f32, row stride ldy
  int ldy;
  bool xvec, wvec;       // 16-byte loads of X rows / W rows are aligned
};

// The NP bf16 pieces of x (the file's note; ops/cuda_kernels.py split_bf16).
template <int NP>
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16 p[NP]) {
  p[0] = __float2bfloat16_rn(x);
  if constexpr (NP == kF32Pieces) {
    const float h = __bfloat162float(p[0]);
    const float r1 = isfinite(h) ? __fsub_rn(x, h) : 0.0f;
    p[1] = __float2bfloat16_rn(r1);
    p[2] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(p[1])));
  } else {
    static_assert(NP == kBf16Pieces, "one or three pieces");
  }
}

// The B registers of four n8 fragments from two rows of W: ``ra`` (row k)
// and ``rb`` (row k + 1) each hold columns 4g..4g+3 as bytes 0..3; out[f]
// is bf16(ra.f) | bf16(rb.f) << 16. A byte w in {0, 1, -1} has the bf16
// high byte H = 0x3F | (w & 0x80) and low byte L = 0x80 when w != 0.
__device__ __forceinline__ void b_pairs(uint32_t ra, uint32_t rb,
                                        uint32_t out[4]) {
  const uint32_t lo = __byte_perm(ra, rb, 0x5140);   // ra.0 rb.0 ra.1 rb.1
  const uint32_t hi = __byte_perm(ra, rb, 0x7362);   // ra.2 rb.2 ra.3 rb.3
  const uint32_t nl = lo & 0x01010101u, nh = hi & 0x01010101u;
  const uint32_t hl = nl * 0x3Fu + (lo & 0x80808080u);
  const uint32_t hh = nh * 0x3Fu + (hi & 0x80808080u);
  const uint32_t ll = nl << 7, lh = nh << 7;
  out[0] = __byte_perm(ll, hl, 0x5140);
  out[1] = __byte_perm(ll, hl, 0x7362);
  out[2] = __byte_perm(lh, hh, 0x5140);
  out[3] = __byte_perm(lh, hh, 0x7362);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t a[4], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [k0, k0 + KC) of X (split into NP planes) and of W for the
// block's tile at (m0, n0). Every load of the chunk is issued before the
// first store to shared memory, so the chunk waits for one round trip to
// device memory, not one a load.
template <class T, int NP>
__device__ __forceinline__ void stage_chunk(const Args& a, int m0, int n0,
                                            int k0, int tid,
                                            __nv_bfloat16* xs, uint8_t* ws) {
  constexpr int Q = T::KC / 4;                  // 4-column groups a row
  constexpr int XL = T::BM * Q / kThreads;      // X groups a thread
  constexpr int G = T::BN / 16;                 // 16-column groups a row
  constexpr int WL = T::KC * G / kThreads;      // W groups a thread
  static_assert(T::BM * Q % kThreads == 0 && T::KC * G % kThreads == 0,
                "whole groups a thread");
  float4 v[XL];
#pragma unroll
  for (int j = 0; j < XL; ++j) {
    const int i = tid + j * kThreads, r = i / Q, k = k0 + 4 * (i % Q);
    v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (m0 + r < a.M && k < a.K) {
      const float* src = a.x + (size_t)(m0 + r) * a.K + k;
      if (a.xvec) {
        v[j] = *reinterpret_cast<const float4*>(src);
      } else {
        v[j].x = src[0];
        if (k + 1 < a.K) v[j].y = src[1];
        if (k + 2 < a.K) v[j].z = src[2];
        if (k + 3 < a.K) v[j].w = src[3];
      }
    }
  }
  // W: 16 columns of one row a group, one 16-byte load where aligned, 16
  // byte loads (each column masked) elsewhere
  uint4 u[WL];
#pragma unroll
  for (int j = 0; j < WL; ++j) {
    const int i = tid + j * kThreads, k = k0 + i / G, c = n0 + 16 * (i % G);
    u[j] = make_uint4(0u, 0u, 0u, 0u);
    if (k < a.K && c < a.N) {
      const int8_t* src = a.w + (size_t)k * a.ldw + c;
      if (a.wvec) {
        u[j] = *reinterpret_cast<const uint4*>(src);
      } else {
        uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (c + e < a.N) wd[e / 4] |= (uint32_t)(uint8_t)src[e] << (8 * (e % 4));
        u[j] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < WL; ++j) {
    const int i = tid + j * kThreads;
    *reinterpret_cast<uint4*>(ws + (i / G) * T::kWS + 16 * (i % G)) = u[j];
  }
#pragma unroll
  for (int j = 0; j < XL; ++j) {
    const int i = tid + j * kThreads, r = i / Q, c = 4 * (i % Q);
    const float f[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
    __nv_bfloat16 p[4][NP];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_bf16<NP>(f[e], p[e]);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      __nv_bfloat162 lo2, hi2;
      lo2.x = p[0][q]; lo2.y = p[1][q];
      hi2.x = p[2][q]; hi2.y = p[3][q];
      uint2 w2;
      w2.x = *reinterpret_cast<const uint32_t*>(&lo2);
      w2.y = *reinterpret_cast<const uint32_t*>(&hi2);
      *reinterpret_cast<uint2*>(xs + (q * T::BM + r) * T::kAS + c) = w2;
    }
  }
}

// One block's tile of Y: rows [m0, m0 + BM) and columns [n0, n0 + BN),
// y[gm * ldy + col] = stage(X) . W + b [PReLU] inside (M, N). ``tid`` is the
// thread's index among the tile's kThreads threads, ``smem`` the
// T::smem(NP) bytes of dynamic shared memory and ``sync`` a barrier of those
// threads: the whole block in dense_kernel, the compute warps beside the
// copy warps in ring.cu. Every write to smem follows a sync, so
// consecutive calls may share it.
template <class T, int NP, class Sync>
__device__ __forceinline__ void dense_tile(const Args& a, int m0, int n0,
                                           int tid, uint8_t* smem, Sync sync) {
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* ws = smem + NP * T::BM * T::kAS * 2;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wk = warp / (T::WM * T::WN), wmn = warp % (T::WM * T::WN);
  const int wm = 32 * (wmn / T::WN), wn = 32 * (wmn % T::WN);

  float acc[T::MF][T::NF][4];
#pragma unroll
  for (int i = 0; i < T::MF; ++i)
#pragma unroll
    for (int f = 0; f < T::NF; ++f)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][f][r] = 0.0f;

  for (int k0 = 0; k0 < a.K; k0 += T::KC) {
    sync();   // the previous chunk (or tile) is consumed
    stage_chunk<T, NP>(a, m0, n0, k0, tid, xs, ws);
    sync();
    // the warp's k-steps of the chunk, kSumSteps at a time: each group's
    // passes summed into the zeroed fragments ``part``, then added into acc
#pragma unroll
    for (int s0 = 0; s0 < T::KS / T::WK; s0 += T::PS) {
      float part[T::MF][T::NF][4];
#pragma unroll
      for (int i = 0; i < T::MF; ++i)
#pragma unroll
        for (int f = 0; f < T::NF; ++f)
#pragma unroll
          for (int r = 0; r < 4; ++r) part[i][f][r] = 0.0f;
#pragma unroll
      for (int s = s0; s < s0 + T::PS; ++s) {
        const int ks = 16 * (wk + s * T::WK);
        const uint8_t* wp = ws + (ks + 2 * t) * T::kWS + wn + 4 * g;
        uint32_t b[2][4];   // [k half][n8 fragment]
        b_pairs(*reinterpret_cast<const uint32_t*>(wp),
                *reinterpret_cast<const uint32_t*>(wp + T::kWS), b[0]);
        b_pairs(*reinterpret_cast<const uint32_t*>(wp + 8 * T::kWS),
                *reinterpret_cast<const uint32_t*>(wp + 9 * T::kWS), b[1]);
#pragma unroll
        for (int i = 0; i < T::MF; ++i)
#pragma unroll
          for (int q = 0; q < NP; ++q) {
            uint32_t af[4];
            ldmatrix_x4(af, xs + (q * T::BM + wm + 16 * i + (lane & 15)) *
                                     T::kAS + ks + 8 * (lane >> 4));
#pragma unroll
            for (int f = 0; f < T::NF; ++f) {
              const uint32_t bf[2] = {b[0][f], b[1][f]};
              mma_bf16(part[i][f], af, bf);
            }
          }
      }
#pragma unroll
      for (int i = 0; i < T::MF; ++i)
#pragma unroll
        for (int f = 0; f < T::NF; ++f)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[i][f][r] = __fadd_rn(acc[i][f][r], part[i][f][r]);
    }
  }

  // acc[i][f][r] is row wm + 16i + g + 8(r >> 1), column wn + 8t + 4(r & 1)
  // + f of the tile; the WK partial tiles are added in warp order
  float* red = reinterpret_cast<float*>(smem);
  sync();
#pragma unroll
  for (int i = 0; i < T::MF; ++i)
#pragma unroll
    for (int f = 0; f < T::NF; ++f)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        red[(wk * T::BM + wm + 16 * i + g + 8 * (r >> 1)) * T::kRS + wn +
            8 * t + 4 * (r & 1) + f] = acc[i][f][r];
  sync();
  for (int e = tid; e < T::BM * T::BN; e += kThreads) {
    const int row = e / T::BN, col = e % T::BN;
    const int gm = m0 + row, gc = n0 + col;
    if (gm < a.M && gc < a.N) {
      float s = red[row * T::kRS + col];
#pragma unroll
      for (int w = 1; w < T::WK; ++w)
        s = __fadd_rn(s, red[(w * T::BM + row) * T::kRS + col]);
      a.y[(size_t)gm * a.ldy + gc] = epi_bias(s, a.bias, a.alpha, gc);
    }
  }
}

template <class T, int NP>
__global__ void __launch_bounds__(kThreads, 2) dense_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  dense_tile<T, NP>(a, blockIdx.y * T::BM, blockIdx.x * T::BN, threadIdx.x,
                    smem, [] { __syncthreads(); });
}

// Whether 16-byte loads of X (row stride K) and of W (row stride ldw,
// ``cols`` columns from ``w``) stay aligned.
__host__ __device__ inline bool x_vec(const float* x, int K) {
  return K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}
__host__ __device__ inline bool w_vec(const int8_t* w, int ldw, int cols) {
  return ldw % 16 == 0 && cols % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

template <class T, int NP>
int launch(const Args& a, cudaStream_t s) {
  const int bytes = T::smem(NP);
  cudaError_t err = cudaFuncSetAttribute(
      dense_kernel<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dense_kernel<T, NP><<<dim3(cdiv(a.N, T::BN), cdiv(a.M, T::BM)), kThreads,
                        bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// Y = stage(X) . W + b [PReLU] over a DenseTernary (K, N) int8 plane of
// row stride ldw: the Narrow tile up to kNarrowMaxM rows of X, Wide above.
template <int NP>
int run_dense(const float* x, int M, int K, const int8_t* w, int ldw, int N,
              const float* bias, const float* alpha, float* y,
              cudaStream_t s) {
  Args a{x, M, K, w, ldw, N, bias, alpha, y, N, x_vec(x, K), w_vec(w, ldw, N)};
  return M <= kNarrowMaxM ? launch<Narrow, NP>(a, s) : launch<Wide, NP>(a, s);
}

}  // namespace dmma
}  // namespace ternary
