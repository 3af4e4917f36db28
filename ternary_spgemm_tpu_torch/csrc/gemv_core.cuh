// The streaming decode body over the bit-plane container at small M: Y =
// stage(X) . W + epilogue, the decode branches of CudaTiledBitplane_x8 and
// CudaTiledBitplane_i8 (bitplane.cu: ternary_bitplane_x8, _i8; epi_bias)
// and both phases of the fused PReLU FFN block (ffn.cu: the i8 rule with
// kEpiBiasRmax, then the requantizing rule with kEpiScaleBias). One
// templated kernel, one launch a product; the X rule and the epilogue are
// its only differences. Above the wrappers' X8_MMA_MIN_M / I8_MMA_MIN_M
// rows the int8 tensor-core core (bitplane_mma.cuh) takes the x8 and i8
// kernels over.
//
// The container (formats/bitplane.py): plane (nb, gn, 2*tkb, tile_n)
// uint8; byte-row t of slab (kb, g) is tile_n contiguous bytes, one a
// column; bit 4h + j of a pos byte is the +1 flag of dense row
// kb*8*tkb + h*4*tkb + 4t + j, the neg plane lies tkb*tile_n bytes after
// the pos plane. The four dense rows 4t..4t+3 of one nibble are four
// consecutive k, so one 32-bit word of X staged as int8 in natural order
// pairs with one nibble.
//
// What bounds it on an H100: at M <= 16 a product is a matrix-vector walk
// far below the card's ops-per-byte line; the floor is the plane bytes, 2
// bits a weight at 3.35 TB/s (3.8 us for the 7B merged QKV, 1.3 us for
// wo). The bitplane_core.cuh body it replaces walked 16 chunks a block in
// series, each re-staging f32 X between two __syncthreads, with one byte
// of each plane a lane (32-byte sectors a warp) and cdiv(N, 32) blocks: ~16
// chunk round trips whatever the size. This design streams the planes:
//   * a block is 8 warps on kCols = 128 columns, 4 a lane: each lane reads
//     one 32-bit word of the pos plane and one of the neg plane a byte-row
//     (__ldg), so a warp-load covers 128 contiguous bytes; the 8 warps
//     take the byte-rows of the block's part in turn (w0 + warp + 8i);
//   * loads kept in flight: two register sets of kBatch byte-rows a warp,
//     the first two issued before X is staged, and each set refilled while
//     the other is consumed; no __syncthreads and no staging inside the
//     weight loop;
//   * X staged once a block, before the loop, for the block's K range only:
//     the MT rows of each byte-row's two halves as int8 words in shared
//     memory, kStageX8 rounded and clamped (one plane), kStageI8 as two
//     planes hi = int8(v >> 5), lo = v & 31 with v = floor(x + 512) - 512,
//     as bitplane_mma.cuh's stage_kernel stages them (32*hi + lo == v for
//     v in [-4096, 4095]; beyond, hi wraps as it does there), so the i8
//     kernel's two branches give the same bits on every input, not only
//     on its domain; kStageRequant (the FFN's phase 2, X its f32 hidden
//     state) as one plane rint(h / scale), the staging thread's row scale
//     (rmax + 1e-12) / 127 computed once by IEEE division from rmax_in;
//   * products with __dp4a: each nibble pair becomes four signed bytes
//     (ternary4, ternary4.cuh: pos - neg on every byte pair, both flags
//     set included), reused for the MT rows; x8 and the requantized rule
//     one __dp4a a row against the staged word, i8 two, dp4a(32w, hi) +
//     dp4a(w, lo) (times32); every sum an exact int32 (wrapping adds are
//     associative, so any order gives the same bits);
//   * split-K across blocks, exact: grid z holds S parts of the byte-row
//     walk (W = nb * tkb byte-rows, part s taking [s*W/S, (s+1)*W/S)), so
//     that cdiv(N, 128) column tiles fill the card (ops/fused_ffn.py
//     gemv_parts); the 8 warps' sums are added in shared memory in warp
//     order, each part writes its int32 sums to ``part`` (S, M, N), and the
//     last part of a (column, row) tile to arrive, found with an atomic
//     counter that it resets to 0, adds the S parts in part order and
//     applies the epilogue: one launch a product. With S = 1 the block
//     applies it in place;
//   * the epilogues (bitplane_core.cuh's expressions, so that Y is bitwise
//     the plain version's and the tensor-core branch's): kEpiBias, + b
//     [PReLU]; kEpiBiasRmax, the same written to y, then the row's absmax
//     folded into rmax_out (pre-zeroed) with one atomicMax a warp on the
//     int bits of |y| (a warp's 32 threads hold 32 consecutive columns of
//     one row of the block's output map), by the block that folds (or the
//     S = 1 block) only, so rmax is the max over all N columns of the
//     finished sums; kEpiScaleBias, acc * (scale * gamma0) + b [PReLU]
//     with rounded multiplies and adds and no FMA, as the plain version;
//   * M-tiles of 4, 8 and 16 rows (grid y holds more row tiles above 16),
//     each lane holding 4 x MT accumulators.
// Any geometry the container can have: tile_n not a multiple of 4, or a
// plane not 4-byte aligned, takes byte loads (VEC false); columns past N,
// rows past M and activations past K stage or load as zeros.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitplane_core.cuh"   // stage_value, epi_bias, requant_scale, abs_bits,
                               // cdiv, the stages and epilogues
#include "ternary4.cuh"        // ternary4, times32

namespace ternary {
namespace gemv {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kColsLane = 4;                // columns a lane: a word a plane row
constexpr int kCols = 32 * kColsLane;       // columns a block
constexpr int kBatch = 4;                   // byte-rows a register set (two sets)
constexpr int kXWords = 8192;               // shared words: staged X, then sums
constexpr int kRedRows = kXWords / (kWarps * kCols);   // rows a reduction pass

// X planes a rule stages: i8 two (hi, lo), x8 one
template <int STAGE>
__host__ __device__ constexpr int planes() { return STAGE == kStageI8 ? 2 : 1; }

// staged X words a byte-row: (row m, half h, plane a) at (m*2 + h)*NA + a
template <int MT, int STAGE>
__host__ __device__ constexpr int row_words() { return 2 * planes<STAGE>() * MT; }

// the longest part (byte-rows) whose staged X fits: ops/fused_ffn.py
// gemv_part_max
template <int MT, int STAGE>
__host__ __device__ constexpr int part_max() { return kXWords / row_words<MT, STAGE>(); }

struct Args {
  const float* x;           // (M, K) f32 activations, row-major
  int M, K;
  const uint8_t* plane;     // TiledBitplane's plane
  int nb, gn, tkb, tile_n, N;
  const float* bias;        // (N,)
  const float* alpha;       // (N,) PReLU slopes, or null
  float* y;                 // (M, N) f32 output
  int* part;                // S > 1: (S, M, N) int32 sums of the parts
  int* counters;            // S > 1: one a (column, row) tile, 0 between calls
  const int* rmax_in;       // kStageRequant / kEpiScaleBias: (M,) row absmax bits
  int* rmax_out;            // kEpiBiasRmax: (M,) row absmax bits, pre-zeroed
  float gamma0;             // kEpiScaleBias: the output scale's gamma
};

// The byte-rows of one warp in walk order: walk index w = kb*tkb + t, the
// warp's next one kWarps on.
struct RowIter {
  int kb, t;
  __device__ __forceinline__ size_t next(const Args& a, size_t kb_stride) {
    const size_t off = (size_t)kb * kb_stride + (size_t)t * a.tile_n;
    t += kWarps;
    while (t >= a.tkb) { t -= a.tkb; ++kb; }
    return off;
  }
};

// The pos or neg word of a lane's four columns in the byte-row at ``off``:
// VEC one aligned word at col_off[0]; else a byte each (0 past N).
template <bool VEC>
__device__ __forceinline__ uint32_t load_word(const uint8_t* plane, size_t off,
                                              const long long col_off[kColsLane]) {
  if constexpr (VEC) {
    return col_off[0] < 0 ? 0u
        : __ldg(reinterpret_cast<const unsigned int*>(plane + off + col_off[0]));
  } else {
    uint32_t w = 0;
#pragma unroll
    for (int c = 0; c < kColsLane; ++c)
      if (col_off[c] >= 0)
        w |= (uint32_t)__ldg(plane + off + col_off[c]) << (8 * c);
    return w;
  }
}

// Rows i0 .. i0 + kBatch - 1 of the warp (those below cnt) into p (pos) and
// q (neg), in walk order.
template <bool VEC>
__device__ __forceinline__ void load_batch(uint32_t p[kBatch], uint32_t q[kBatch],
                                           int i0, int cnt, RowIter& it,
                                           const Args& a, size_t kb_stride,
                                           size_t neg,
                                           const long long col_off[kColsLane]) {
#pragma unroll
  for (int r = 0; r < kBatch; ++r) {
    p[r] = 0u;
    q[r] = 0u;
    if (i0 + r < cnt) {
      const size_t off = it.next(a, kb_stride);
      p[r] = load_word<VEC>(a.plane, off, col_off);
      q[r] = load_word<VEC>(a.plane, off + neg, col_off);
    }
  }
}

// Consume rows i0 .. of the warp: byte c of a word is column c, its low
// nibble the block's low half (4t..4t+3), its high nibble the high half.
template <int MT, int STAGE>
__device__ __forceinline__ void consume(const uint32_t p[kBatch],
                                        const uint32_t q[kBatch], int i0,
                                        int cnt, int warp, const int* xs,
                                        int (&acc)[kColsLane][MT]) {
  constexpr int RW = row_words<MT, STAGE>();
#pragma unroll
  for (int r = 0; r < kBatch; ++r) {
    if (i0 + r >= cnt) break;
    const int* xr = xs + (warp + kWarps * (i0 + r)) * RW;
    uint32_t w[kColsLane][2];
#pragma unroll
    for (int c = 0; c < kColsLane; ++c) {
      const uint32_t pb = (p[r] >> (8 * c)) & 0xFFu, nb = (q[r] >> (8 * c)) & 0xFFu;
      w[c][0] = ternary4(pb & 15u, nb & 15u);
      w[c][1] = ternary4(pb >> 4, nb >> 4);
    }
    if constexpr (planes<STAGE>() == 1) {
      // an int4: (m, low), (m, high), (m + 1, low), (m + 1, high)
#pragma unroll
      for (int m = 0; m < MT; m += 2) {
        const int4 xv = *reinterpret_cast<const int4*>(xr + 2 * m);
#pragma unroll
        for (int c = 0; c < kColsLane; ++c) {
          acc[c][m] = __dp4a((int)w[c][0], xv.x, acc[c][m]);
          acc[c][m] = __dp4a((int)w[c][1], xv.y, acc[c][m]);
          acc[c][m + 1] = __dp4a((int)w[c][0], xv.z, acc[c][m + 1]);
          acc[c][m + 1] = __dp4a((int)w[c][1], xv.w, acc[c][m + 1]);
        }
      }
    } else {
      // an int4: (m, low, hi), (m, low, lo), (m, high, hi), (m, high, lo);
      // x . w = hi . 32w + lo . w
      uint32_t w32[kColsLane][2];
#pragma unroll
      for (int c = 0; c < kColsLane; ++c) {
        w32[c][0] = times32(w[c][0]);
        w32[c][1] = times32(w[c][1]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int4 xv = *reinterpret_cast<const int4*>(xr + 4 * m);
#pragma unroll
        for (int c = 0; c < kColsLane; ++c) {
          acc[c][m] = __dp4a((int)w32[c][0], xv.x, acc[c][m]);
          acc[c][m] = __dp4a((int)w[c][0], xv.y, acc[c][m]);
          acc[c][m] = __dp4a((int)w32[c][1], xv.z, acc[c][m]);
          acc[c][m] = __dp4a((int)w[c][1], xv.w, acc[c][m]);
        }
      }
    }
  }
}

__device__ __forceinline__ int pack4(const int v[4]) {
  return (int)((uint32_t)(v[0] & 0xFF) | (uint32_t)(v[1] & 0xFF) << 8 |
               (uint32_t)(v[2] & 0xFF) << 16 | (uint32_t)(v[3] & 0xFF) << 24);
}

// Element (gm, gc) of the output from its int32 sum ``acc`` by the FFN's
// epilogues. kEpiBias stays inline where it is stored, so that the x8 and
// i8 bodies compile as they did before these epilogues. The whole warp
// calls it: kEpiBiasRmax reduces the row's |y| bits over its 32 columns.
template <int EPI>
__device__ __forceinline__ void store_ffn(const Args& a, int acc, int gm,
                                          int gc, bool col_ok, int lane) {
  const bool ok = col_ok && gm < a.M;
  if constexpr (EPI == kEpiBiasRmax) {
    float hv = 0.0f;
    if (ok) {
      hv = epi_bias((float)acc, a.bias, a.alpha, gc);
      a.y[(size_t)gm * a.N + gc] = hv;
    }
    const int bits = __reduce_max_sync(0xffffffffu, abs_bits(hv));
    if (lane == 0 && gm < a.M) atomicMax(a.rmax_out + gm, bits);
  } else {
    // ops/fused_ffn.py:189-191 of the JAX package: acc * (((rmax + eps) /
    // 127) * gamma) + b, then PReLU; rounded products and sums, never one
    // FMA, so that the card rounds twice as the plain version does
    static_assert(EPI == kEpiScaleBias, "the FFN's epilogues");
    if (ok) {
      const float rs = requant_scale(a.rmax_in, gm);
      float yv = __fadd_rn(__fmul_rn((float)acc, __fmul_rn(rs, a.gamma0)),
                           a.bias[gc]);
      if (a.alpha != nullptr) yv = yv > 0.0f ? yv : a.alpha[gc] * yv;
      a.y[(size_t)gm * a.N + gc] = yv;
    }
  }
}

// One block: kCols columns x MT rows of Y over part blockIdx.z of the walk
// (the file's note). Blocks an SM by the accumulators: 4 at MT = 4 (64
// registers), 3 at 8, 2 at 16.
template <int MT, int STAGE, int EPI, bool VEC>
__global__ void __launch_bounds__(kThreads, MT == 4 ? 4 : (MT == 8 ? 3 : 2))
    gemv_kernel(const Args a) {
  constexpr int NA = planes<STAGE>();
  constexpr int RW = row_words<MT, STAGE>();
  constexpr int G = 2 * MT;                 // (row, half) groups a byte-row
  constexpr int RSTEP = kThreads / G;       // byte-rows a staging step
  constexpr int SU = MT == 4 ? 4 : 8;       // staging steps a pass
  static_assert(kThreads % G == 0 && MT % 2 == 0, "the M-tiles 4, 8, 16");
  __shared__ __align__(16) int xs[kXWords];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * MT;
  const int S = gridDim.z;
  const int walk = a.nb * a.tkb;
  const int w0 = (int)((long long)blockIdx.z * walk / S);
  const int len = (int)((long long)(blockIdx.z + 1) * walk / S) - w0;
  // this warp's byte-rows of the part: w0 + warp + kWarps * i, i < cnt
  const int cnt = len > warp ? (len - warp + kWarps - 1) / kWarps : 0;

  // the lane's columns: the offset of each in a K-block's slab row (-1
  // past N); a slab of one K-block and all gn tiles is kb_stride bytes
  const size_t kb_stride = (size_t)a.gn * 2 * a.tkb * a.tile_n;
  const size_t neg = (size_t)a.tkb * a.tile_n;
  const int col0 = blockIdx.x * kCols + kColsLane * lane;
  long long col_off[kColsLane];
#pragma unroll
  for (int c = 0; c < kColsLane; ++c) {
    const int cc = col0 + c;
    const int g = cc / a.tile_n;
    col_off[c] = cc < a.N ? (long long)g * 2 * a.tkb * a.tile_n + (cc - g * a.tile_n)
                          : -1;
  }

  // the first two register sets in flight before X is staged
  RowIter it{0, 0};
  if (cnt > 0) {
    it.kb = (w0 + warp) / a.tkb;
    it.t = w0 + warp - it.kb * a.tkb;
  }
  uint32_t p0[kBatch], q0[kBatch], p1[kBatch], q1[kBatch];
  load_batch<VEC>(p0, q0, 0, cnt, it, a, kb_stride, neg, col_off);
  load_batch<VEC>(p1, q1, kBatch, cnt, it, a, kb_stride, neg, col_off);

  // X staged once: thread tid stages row m, half h of byte-rows tid / G,
  // + RSTEP, ...; its four activations k .. k + 3 of the block's dense
  // rows (one 16-byte load where X's rows allow it), all of a pass's SU
  // loads before its stores
  {
    const int m = (tid % G) >> 1, h = tid & 1, gm = m0 + m;
    float scale = 1.0f;   // the x8 and i8 rules take none
    if constexpr (STAGE == kStageRequant) {
      if (gm < a.M) scale = requant_scale(a.rmax_in, gm);
    }
    const bool vec_x = a.K % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
    const float* xrow = a.x + (size_t)(gm < a.M ? gm : 0) * a.K;
    int rel = tid / G;
    int kb = (w0 + rel) / a.tkb;
    int t = w0 + rel - kb * a.tkb;
    for (; rel < len; rel += SU * RSTEP) {
      float4 v[SU];
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int k = kb * 8 * a.tkb + h * 4 * a.tkb + 4 * t;
        v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (rel + u * RSTEP < len && gm < a.M) {
          if (vec_x && k < a.K) {
            v[u] = __ldg(reinterpret_cast<const float4*>(xrow + k));
          } else {
            if (k < a.K) v[u].x = __ldg(xrow + k);
            if (k + 1 < a.K) v[u].y = __ldg(xrow + k + 1);
            if (k + 2 < a.K) v[u].z = __ldg(xrow + k + 2);
            if (k + 3 < a.K) v[u].w = __ldg(xrow + k + 3);
          }
        }
        t += RSTEP;
        while (t >= a.tkb) { t -= a.tkb; ++kb; }
      }
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        if (rel + u * RSTEP >= len) break;
        const int s[4] = {stage_value<STAGE>(v[u].x, scale),
                          stage_value<STAGE>(v[u].y, scale),
                          stage_value<STAGE>(v[u].z, scale),
                          stage_value<STAGE>(v[u].w, scale)};
        int* dst = xs + (rel + u * RSTEP) * RW + (tid % G) * NA;
        if constexpr (NA == 2) {
          // 32 * (v >> 5) + (v & 31) == v; the hi byte wraps outside
          // [-4096, 4095], as bitplane_mma.cuh's stage_kernel
          int hi[4], lo[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) { hi[j] = s[j] >> 5; lo[j] = s[j] & 31; }
          *reinterpret_cast<int2*>(dst) = make_int2(pack4(hi), pack4(lo));
        } else {
          *dst = pack4(s);
        }
      }
    }
  }
  __syncthreads();

  int acc[kColsLane][MT];
#pragma unroll
  for (int c = 0; c < kColsLane; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[c][m] = 0;
  for (int i0 = 0; i0 < cnt; i0 += 2 * kBatch) {
    consume<MT, STAGE>(p0, q0, i0, cnt, warp, xs, acc);
    if (i0 + 2 * kBatch < cnt)
      load_batch<VEC>(p0, q0, i0 + 2 * kBatch, cnt, it, a, kb_stride, neg, col_off);
    if (i0 + kBatch < cnt) {
      consume<MT, STAGE>(p1, q1, i0 + kBatch, cnt, warp, xs, acc);
      if (i0 + 3 * kBatch < cnt)
        load_batch<VEC>(p1, q1, i0 + 3 * kBatch, cnt, it, a, kb_stride, neg, col_off);
    }
  }

  // the 8 warps' sums, added in warp order, RG rows a pass; thread tid
  // then holds element (row pass*RG + e*kThreads/kCols + tid/kCols, column
  // tid % kCols) of the block's tile in out[pass][e]
  constexpr int RG = MT < kRedRows ? MT : kRedRows;
  constexpr int PASSES = MT / RG;
  constexpr int EPT = RG * kCols / kThreads;
  int out[PASSES][EPT];
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
    __syncthreads();   // the staged X (or the previous pass) is consumed
#pragma unroll
    for (int mm = 0; mm < RG; ++mm)
      *reinterpret_cast<int4*>(xs + (warp * RG + mm) * kCols + kColsLane * lane) =
          make_int4(acc[0][pass * RG + mm], acc[1][pass * RG + mm],
                    acc[2][pass * RG + mm], acc[3][pass * RG + mm]);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = tid + e * kThreads;
      int s = 0;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) s += xs[wp * RG * kCols + i];
      out[pass][e] = s;
    }
  }

  const int cl = tid % kCols, gc = blockIdx.x * kCols + cl;
  const bool col_ok = gc < a.N;
  if (S == 1) {
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass)
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int gm = m0 + pass * RG + (tid + e * kThreads) / kCols;
        if constexpr (EPI == kEpiBias) {
          if (col_ok && gm < a.M)
            a.y[(size_t)gm * a.N + gc] = epi_bias((float)out[pass][e], a.bias,
                                                  a.alpha, gc);
        } else {
          store_ffn<EPI>(a, out[pass][e], gm, gc, col_ok, lane);
        }
      }
    return;
  }
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass)
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int gm = m0 + pass * RG + (tid + e * kThreads) / kCols;
      if (col_ok && gm < a.M)
        a.part[((size_t)blockIdx.z * a.M + gm) * a.N + gc] = out[pass][e];
    }
  // the last part of this tile to arrive folds the S parts
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = a.counters + blockIdx.y * gridDim.x + blockIdx.x;
    is_last = atomicAdd(ctr, 1) == S - 1;
    if (is_last) *ctr = 0;   // ready for the next call
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  int sum[PASSES][EPT];
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass)
#pragma unroll
    for (int e = 0; e < EPT; ++e) sum[pass][e] = 0;
  const size_t plane_mn = (size_t)a.M * a.N;
#pragma unroll 4
  for (int z = 0; z < S; ++z)
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass)
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int gm = m0 + pass * RG + (tid + e * kThreads) / kCols;
        if (col_ok && gm < a.M)
          sum[pass][e] += __ldcg(a.part + z * plane_mn + (size_t)gm * a.N + gc);
      }
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass)
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int gm = m0 + pass * RG + (tid + e * kThreads) / kCols;
      if constexpr (EPI == kEpiBias) {
        if (col_ok && gm < a.M)
          a.y[(size_t)gm * a.N + gc] = epi_bias((float)sum[pass][e], a.bias,
                                                a.alpha, gc);
      } else {
        store_ffn<EPI>(a, sum[pass][e], gm, gc, col_ok, lane);
      }
    }
}

template <int MT, int STAGE, int EPI>
int launch_tile(const Args& a, int parts, cudaStream_t stream) {
  const dim3 grid(cdiv(a.N, kCols), cdiv(a.M, MT), parts);
  const bool vec = a.tile_n % kColsLane == 0 &&
                   reinterpret_cast<uintptr_t>(a.plane) % kColsLane == 0;
  if (cdiv(a.nb * a.tkb, parts) > part_max<MT, STAGE>())
    return (int)cudaErrorInvalidValue;   // a part's X would not fit
  if (vec)
    gemv_kernel<MT, STAGE, EPI, true><<<grid, kThreads, 0, stream>>>(a);
  else
    gemv_kernel<MT, STAGE, EPI, false><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Y = STAGE(X) . W, then EPI (default + b [PReLU]), as ``parts`` parts of
// the walk (1: no scratch, no counters), the smallest M-tile that holds M
// (row tiles of 16 above 16 rows).
template <int STAGE, int EPI = kEpiBias>
int run(const Args& a, int parts, cudaStream_t stream) {
  if (parts < 1) return (int)cudaErrorInvalidValue;
  if (a.M <= 4) return launch_tile<4, STAGE, EPI>(a, parts, stream);
  if (a.M <= 8) return launch_tile<8, STAGE, EPI>(a, parts, stream);
  return launch_tile<16, STAGE, EPI>(a, parts, stream);
}

}  // namespace gemv
}  // namespace ternary
