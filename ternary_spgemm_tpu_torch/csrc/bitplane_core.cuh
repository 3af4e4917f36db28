// Shared core of the CUDA-core SpMM kernels over the bit-plane container:
// one templated kernel that decodes the ternary weights straight from the
// plane bytes and accumulates the dot products in exact int32 (every rule
// it runs stages integers). Its one user: the fused SwiGLU's decode branch
// (swiglu.cu, a split walk, below). The x8 and i8 bitplane kernels' decode
// branches and the fused PReLU FFN stream the planes on gemv_core.cuh;
// every other SpMM body runs dense_mma.cuh's bf16 tensor-core tile,
// bitplane_mma.cuh's int8 one or ell_core.cuh. The X rules (stage_value),
// the epilogues' expressions (epi_*), requant_scale and abs_bits here are
// shared with those cores.
//
// The container (ternary_spgemm_tpu_torch/formats/bitplane.py),
// TiledBitplane: plane (nb, gn, 2*tkb, tile_n) uint8, tile-contiguous, a
// K-block of B = 8*tkb dense rows by a storage tile of tile_n columns per
// slab. Bit 4h + j of byte-row t of the pos plane (rows [0, tkb)) is the +1
// flag of dense row h*4*tkb + 4t + j, the neg plane (rows [tkb, 2*tkb)) the
// -1 flag: the low half (h = 0) and the high half of the block, in the row
// order of the TPU's int32 -> int8 bitcast
// (ternary_spgemm_tpu/ops/pallas_kernels.py:966-1023).
//
// Design, simple first:
//   * one output column per lane: a warp reads 32 neighbouring elements of
//     a slab row (one 32-byte sector), coalesced;
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
//     rows; w * x is one multiply-add;
//   * the split walk (SPLIT, launch_split): the blocks' (K-block, chunk)
//     walk cut into S contiguous parts as a third grid dimension, part s
//     taking chunks [s*W/S, (s+1)*W/S) of the W, its int32 sums written to
//     a (S, NP, M, N) buffer; split_finish_kernel adds the S parts in part
//     order (exact integers: the same bits in any order) and applies the
//     epilogue, so Y is bitwise the unsplit kernel's. It puts more blocks
//     on the SMs where N/32 blocks each walking all of K would leave most
//     of them idle (the SwiGLU's down product at decode: 128 blocks).
//
// What bounds it on an H100: at decode sizes (M <= 32) the weight bytes are
// the floor — 2 bits per weight at 3.35 TB/s — but this kernel spends
// about (3 + MT) instructions per weight and lane, and each block waits on
// its chunks' loads in series, so it is bound by issue rate and latency,
// not by memory. The tensor cores (int8 / bf16 mma, wgmma) and a pipelined
// TMA stream of the weights are the later, faster design.
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

// The raw bits of one byte-row, read once per lane from element ``off``:
// the pos and neg bytes (the neg plane ``second`` bytes on).
__device__ __forceinline__ uint2 load_row(const uint8_t* base, size_t off,
                                          size_t second) {
  return make_uint2(base[off], base[off + second]);
}

// Weights of half h of a loaded byte-row: w[j] is dense row
// h*4*tkb + 4t + j of the block.
__device__ __forceinline__ void decode_half(uint2 r, int h, int w[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int b = 4 * h + j;
    w[j] = (int)((r.x >> b) & 1u) - (int)((r.y >> b) & 1u);
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

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// One block's tile of Y: 32 columns x MT rows (the file's note). SPLIT:
// part blockIdx.z of the gridDim.z parts of the (K-block, chunk) walk, its
// int32 sums written to ``part`` (S, NP, M, N) in place of the epilogue.
// Written so (``a`` by value; the unsplit walk's two loops, the split's
// skip of other parts' chunks under if constexpr), the unsplit
// instantiations compile to the same SASS as a kernel without the split;
// ``a`` by reference, or the chunk as a lambda, changed it.
template <int MT, int STAGE, int NP, int EPI, bool SPLIT>
__device__ __forceinline__ void bitplane_body(const Args a, int* part) {
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

  if (STAGE == kStageRequant || EPI == kEpiScale) {
    if (tid < MT) rs[tid] = (m0 + tid < a.M) ? requant_scale(a.rmax_in, m0 + tid) : 1.0f;
  }

  A acc0[MT], acc1[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) { acc0[m] = 0; acc1[m] = 0; }

  // bytes of one (K-block, N-tile) slab; the neg plane lies neg_off bytes
  // after the pos plane
  const size_t slab_elems = (size_t)2 * a.tkb * a.tile_n;
  const size_t neg_off = (size_t)a.tkb * a.tile_n;

  // SPLIT: chunks [s*W/S, (s+1)*W/S) of the blocks' W = nb * cdiv(tkb, kTC)
  int part_begin = 0, part_end = 0;
  if constexpr (SPLIT) {
    const int walk = a.nb * cdiv(a.tkb, kTC);
    part_begin = (int)((long long)blockIdx.z * walk / gridDim.z);
    part_end = (int)((long long)(blockIdx.z + 1) * walk / gridDim.z);
  }

  for (int kb = 0; kb < a.nb; ++kb) {
    const size_t at = ((size_t)kb * a.gn + g) * slab_elems + n;
    for (int t0 = 0; t0 < a.tkb; t0 += kTC) {
      if constexpr (SPLIT) {   // another part's chunk
        const int w = kb * cdiv(a.tkb, kTC) + t0 / kTC;
        if (w < part_begin || w >= part_end) continue;
      }
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
          const uint2 r0 = load_row(a.plane0, off, neg_off);
          uint2 r1 = make_uint2(0u, 0u);
          if constexpr (NP == 2)
            r1 = load_row(a.plane1, off, neg_off);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int w0[4], w1[4];
            decode_half(r0, h, w0);
            if constexpr (NP == 2) decode_half(r1, h, w1);
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

  if constexpr (SPLIT) {   // this part's sums, for split_finish_kernel
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int m = warp + r * kWarps, gm = m0 + m;
      if (m < MT && gm < a.M && col_ok) {
        const size_t o = ((size_t)blockIdx.z * NP * a.M + gm) * a.N + col;
        part[o] = s0[r];
        if constexpr (NP == 2) part[o + (size_t)a.M * a.N] = s1[r];
      }
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int m = warp + r * kWarps;
    const int gm = m0 + m;
    const bool row_ok = m < MT && gm < a.M;
    const bool ok = row_ok && col_ok;
    const size_t o = (size_t)gm * a.N + col;
    if (EPI == kEpiSwiglu) {
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
    }
  }
}

template <int MT, int STAGE, int NP, int EPI>
__global__ void __launch_bounds__(kThreads) bitplane_kernel(const Args a) {
  bitplane_body<MT, STAGE, NP, EPI, false>(a, nullptr);
}

// The split walk's parts: grid z the S parts, sums into ``part``. At the
// decode tile (MT = 4) held to 64 registers, 4 blocks an SM: its parts
// fill the card in waves of 4 * SMs blocks (ops/fused_ffn.py
// SPLIT_BLOCKS_PER_SM), as the unsplit kernel's 64 registers do.
template <int MT, int STAGE, int NP, int EPI>
__global__ void __launch_bounds__(kThreads, MT == 4 ? 4 : 1)
    bitplane_split_kernel(const Args a, int* part) {
  bitplane_body<MT, STAGE, NP, EPI, true>(a, part);
}

// The split walk's epilogue: a thread an element of Y (M, N), a block
// kThreads columns of one row. The S = ``parts`` int32 sums of ``part`` are
// added in part order, then EPI's expression as bitplane_body applies it:
// kEpiSwiglu writes h and folds each warp's row absmax into rmax_out,
// kEpiScale scales the requantized product.
template <int NP, int EPI>
__global__ void __launch_bounds__(kThreads)
    split_finish_kernel(const Args a, const int* part, int parts) {
  const int gm = blockIdx.y, col = blockIdx.x * kThreads + threadIdx.x;
  const bool ok = col < a.N;
  const size_t plane = (size_t)a.M * a.N, o = (size_t)gm * a.N + col;
  int s0 = 0, s1 = 0;
  if (ok) {
    for (int s = 0; s < parts; ++s) {
      s0 += part[s * NP * plane + o];
      if constexpr (NP == 2) s1 += part[(s * NP + 1) * plane + o];
    }
  }
  if constexpr (EPI == kEpiSwiglu) {
    float hv = 0.0f;
    if (ok) {
      hv = epi_swiglu((float)s0, (float)s1, a.sx[gm], a.gamma0, a.gamma1);
      a.y[o] = hv;
    }
    const int bits = __reduce_max_sync(0xffffffffu, abs_bits(hv));
    if (threadIdx.x % 32 == 0) atomicMax(&a.rmax_out[gm], bits);
  } else {
    static_assert(EPI == kEpiScale, "the SwiGLU's epilogues");
    if (ok)
      a.y[o] = epi_scale((float)s0, requant_scale(a.rmax_in, gm), a.gamma0);
  }
}

template <int MT, int STAGE, int NP, int EPI, bool SPLIT>
void launch_tile(const Args& a, cudaStream_t stream, int* part, int parts) {
  const dim3 grid(cdiv(a.N, kCols), cdiv(a.M, MT), parts);
  const dim3 block(kCols, kWarps);
  if constexpr (SPLIT)
    bitplane_split_kernel<MT, STAGE, NP, EPI><<<grid, block, 0, stream>>>(
        a, part);
  else
    bitplane_kernel<MT, STAGE, NP, EPI><<<grid, block, 0, stream>>>(a);
}

// Launch with the smallest M-tile that holds M (more row tiles above 32);
// SPLIT: the split walk's ``parts`` parts, their sums into ``part``.
template <int STAGE, int NP, int EPI, bool SPLIT = false>
int launch_bitplane(const Args& a, cudaStream_t stream, int* part = nullptr,
                    int parts = 1) {
  if (a.M <= 4)
    launch_tile<4, STAGE, NP, EPI, SPLIT>(a, stream, part, parts);
  else if (a.M <= 8)
    launch_tile<8, STAGE, NP, EPI, SPLIT>(a, stream, part, parts);
  else if (a.M <= 16)
    launch_tile<16, STAGE, NP, EPI, SPLIT>(a, stream, part, parts);
  else
    launch_tile<32, STAGE, NP, EPI, SPLIT>(a, stream, part, parts);
  return (int)cudaGetLastError();
}

// One product as a split walk of ``parts`` parts and its finishing kernel
// (``part``: parts * NP * M * N int32), or with one part the unsplit
// kernel, its epilogue in place. Y is the same bits either way.
template <int STAGE, int NP, int EPI>
int launch_split(const Args& a, int* part, int parts, cudaStream_t stream) {
  if (parts <= 1) return launch_bitplane<STAGE, NP, EPI>(a, stream);
  const int err = launch_bitplane<STAGE, NP, EPI, true>(a, stream, part, parts);
  if (err != 0) return err;
  split_finish_kernel<NP, EPI><<<dim3(cdiv(a.N, kThreads), a.M), kThreads, 0,
                                 stream>>>(a, part, parts);
  return (int)cudaGetLastError();
}

// The arguments of one SpMM, Y = stage(X) . W + b [PReLU], over one weight
// container (bitplane_mma.cuh run_spmm_mma): ``w`` is the container's weight tensor, (nb, gn, ...) its first
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

}  // namespace ternary
