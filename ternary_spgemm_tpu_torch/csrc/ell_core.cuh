// Core of the ELL gather SpMM kernels: one signed gather-sum over the three
// ELL containers, Y = stage(X) . W + b [PReLU]. The X rules, the constants
// and Acc/Acc4 are bitplane_core.cuh's.
//
// Every container stores, per K-block and column, the local row offsets of
// the column's nonzeros as int8 slots, one section of slot rows a sign; a
// slot past the column's own count holds a sentinel. Slab (kb, g) of a
// section starts at element ((kb*gn + g)*rows)*slab_n, slot row r of column
// col = g*slab_n + n at + r*slab_n + n (ternary_spgemm_tpu_torch/formats/):
//   * kEllTiled, TiledEllTCSC plane (nb, gn, CAPS, tile_n): slab_n = tile_n,
//     rows = CAPS for both sections, the neg one starting at row cap_p_max;
//     offsets 0..block_k-1, sentinel block_k (<= 127);
//   * kEllDeposit, TiledEllDeposit plane (nsb, gn, 8*CAPS, tile_n): K-blocks
//     of 248 rows, 8 words of 31; slot s of word w is row 8*s + w of its
//     section (the neg one at row 8*cap_p_max); offsets 0..30 within the
//     word's rows, sentinel 31;
//   * kEllBlocked, BlockedEllTCSC idx_pos / idx_neg (nb, CAP, N_pad): two
//     planes (gn = 1, slab_n = N_pad, rows = CAP_p / CAP_n); offsets
//     0..block_k-1 (<= 128), sentinel -1 (read as a signed byte).
// The caps (nb, ncaps) int32 count slots per (K-block, N-tile of cap_tile
// columns): a loop bound only.
//
// Design, simple first (as packed_core.cuh):
//   * one output column per lane, 32 columns x 8 warps a block; a warp's
//     load of one slot row is 32 consecutive bytes;
//   * for each K-block an M-tile of MT <= 32 rows of X is staged in shared
//     memory by the STAGE rule (f32 as is, or the i8 floor), offset-major:
//     entry e holds the MT rows of one dense row, so a lane reads four rows
//     of X in one 16-byte load at the entry its slot names. Every sentinel
//     names a staged zero (entry block_k, entry 31 of each 32-entry word,
//     or, for BlockedEllTCSC, entry 0 with every offset moved up by one),
//     so a padding slot adds exactly 0 with no branch; rows at or past K
//     stage 0 too;
//   * an entry is MT + 4 words apart (4 at MT = 4): at a stride of MT, a
//     multiple of 32 words at MT = 32, every lane's load would fall on the
//     same four banks whatever its offset; at an odd number of 16-byte
//     quads the offsets spread over the eight quads, and the conflicts left
//     are those of the random offsets, the nature of the format;
//   * the 8 warps split the slot rows (for the deposit plane, warp w takes
//     word w), bounded by the largest cap among the warp's columns (all 32
//     lie in one tile but in BlockedEllTCSC with a tile_n that is not a
//     multiple of 32); pos slots add, neg slots subtract; the warps' partial
//     sums are added in shared memory in a fixed order, so the f32 sums are
//     deterministic;
//   * a column at or past N is neither read nor written.
//
// What bounds it on an H100: the slot bytes (one a nonzero, padded to the
// tile caps) at 3.35 TB/s, far below the issue of MT/4 shared loads, MT adds
// and one byte load a slot and lane, the bank conflicts of random offsets,
// and the staging of X once per K-block and M-tile. At N = 4096 the grid is
// only N/32 = 128 blocks.
#pragma once

#include "bitplane_core.cuh"

namespace ternary {

enum EllLayout { kEllTiled = 0, kEllDeposit = 1, kEllBlocked = 2 };

// The kernel's work, and the attribution ladder of the deposit study
// (ternary_spgemm_tpu_torch/tools/deposit_study.py; deposit layout only):
//   kVarFull: the registered kernels, slot loops to the per-tile caps;
//   kVarStaticCap: the loops run to the whole section (static_pos /
//     static_neg slot rows); the extra sentinel slots add 0;
//   kVarNoGather: slot bytes loaded and summed into every row's result,
//     but X read at entry (r & 7) * 32 + lane, lane-contiguous (no
//     random-offset bank conflicts);
//   kVarNoSlots: no slot loads; X read as kVarNoGather.
enum EllVariant { kVarFull = 0, kVarStaticCap = 1, kVarNoGather = 2,
                  kVarNoSlots = 3 };

constexpr int kEllEntries = 256;   // staged entries a K-block, at most

struct EllArgs {
  const float* x;           // (M, K) f32 activations, row-major
  int M, K;
  const int8_t* pos;        // the +1 section's first slab
  const int8_t* neg;        // the -1 section's first slab
  const int* cap_pos;       // (nb, ncaps) slot counts
  const int* cap_neg;
  int nb, gn, rows_pos, rows_neg, slab_n, cap_tile, ncaps, block_k, N;
  int static_pos, static_neg;  // kVarStaticCap: slot rows of each section
  const float* bias;        // (N,)
  const float* alpha;       // (N,) PReLU slopes, or null
  float* y;                 // (M, N) f32 output
};

template <int L>
struct EllTraits;

template <>
struct EllTraits<kEllTiled> {
  static constexpr int kStage = kStageF32;
  static constexpr int kRowsPerSlot = 1;
  __host__ __device__ static int entries(int block_k) { return block_k + 1; }
  // dense row of staged entry e of K-block kb; -1 for the zero entry
  __device__ static int row(int e, int kb, int block_k) {
    return e < block_k ? kb * block_k + e : -1;
  }
  // staged entry of offset ``off`` in slot row r of a section
  __device__ static int entry(int off, int) { return off; }
};

template <>
struct EllTraits<kEllDeposit> {
  static constexpr int kStage = kStageI8;
  static constexpr int kRowsPerSlot = 8;
  __host__ __device__ static int entries(int) { return 256; }
  __device__ static int row(int e, int kb, int block_k) {
    const int o = e & 31;
    return o < 31 ? kb * block_k + (e >> 5) * 31 + o : -1;
  }
  __device__ static int entry(int off, int r) { return (r & 7) * 32 + off; }
};

template <>
struct EllTraits<kEllBlocked> {
  static constexpr int kStage = kStageF32;
  static constexpr int kRowsPerSlot = 1;
  __host__ __device__ static int entries(int block_k) { return block_k + 1; }
  __device__ static int row(int e, int kb, int block_k) {
    return e > 0 ? kb * block_k + e - 1 : -1;
  }
  __device__ static int entry(int off, int) { return off + 1; }
};

// Add (or, NEG, subtract) the staged rows that ``rows`` slot rows of one
// column name; warp w takes rows w, w + 8, ... (VAR: the entry each slot
// row reads, and whether its byte is loaded; kVarNoGather sums the bytes
// into ``osum``)
template <int MT, int S, int L, bool NEG, int VAR, typename A>
__device__ __forceinline__ void ell_gather(const int8_t* p, int stride,
                                           int rows, int warp, int lane,
                                           const A* xs, A (&acc)[MT],
                                           int& osum) {
  using A4 = Acc4<EllTraits<L>::kStage>;
#pragma unroll 4
  for (int r = warp; r < rows; r += kWarps) {
    int e;
    if constexpr (VAR == kVarNoSlots) {
      e = EllTraits<L>::entry(lane, r);
    } else {
      const int off = (int)p[(size_t)r * stride];
      if constexpr (VAR == kVarNoGather) {
        osum += off;
        e = EllTraits<L>::entry(lane, r);
      } else {
        e = EllTraits<L>::entry(off, r);
      }
    }
    const A4* xv = reinterpret_cast<const A4*>(xs + e * S);
#pragma unroll
    for (int j = 0; j < MT / 4; ++j) {
      const A4 v = xv[j];
      if constexpr (NEG) {
        acc[4 * j] -= v.x; acc[4 * j + 1] -= v.y;
        acc[4 * j + 2] -= v.z; acc[4 * j + 3] -= v.w;
      } else {
        acc[4 * j] += v.x; acc[4 * j + 1] += v.y;
        acc[4 * j + 2] += v.z; acc[4 * j + 3] += v.w;
      }
    }
  }
}

template <int MT, int L, int VAR>
__global__ void __launch_bounds__(kThreads) ell_kernel(const EllArgs a) {
  static_assert(VAR == kVarFull || L == kEllDeposit,
                "the attribution ladder is the deposit layout's");
  using T = EllTraits<L>;
  using A = Acc<T::kStage>;
  constexpr int S = MT == 4 ? 4 : MT + 4;     // words an entry, S/4 odd
  static_assert(kEllEntries * S >= kWarps * MT * kCols,
                "the reduction reuses the stage buffer");
  __shared__ __align__(16) A xs[kEllEntries * S];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kCols + lane;
  const int col = blockIdx.x * kCols + lane;
  const int m0 = blockIdx.y * MT;
  const bool col_ok = col < a.N;
  const int g = col_ok ? col / a.slab_n : 0;
  const int n = col_ok ? col - g * a.slab_n : 0;
  const int ci = col_ok ? col / a.cap_tile : 0;
  const int E = T::entries(a.block_k);

  A acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0;
  int osum = 0;

  for (int kb = 0; kb < a.nb; ++kb) {
    // slot rows to walk: the largest cap among the warp's columns
    const int cp = col_ok ? a.cap_pos[kb * a.ncaps + ci] * T::kRowsPerSlot : 0;
    const int cn = col_ok ? a.cap_neg[kb * a.ncaps + ci] * T::kRowsPerSlot : 0;
    int rp = __reduce_max_sync(0xffffffffu, cp);
    int rn = __reduce_max_sync(0xffffffffu, cn);
    if constexpr (VAR == kVarStaticCap) {
      rp = a.static_pos;
      rn = a.static_neg;
    }
    __syncthreads();   // previous K-block's stage consumed
    for (int i = tid; i < E * MT; i += kThreads) {
      const int e = i / MT, m = i - e * MT;
      const int row = T::row(e, kb, a.block_k);
      const int gm = m0 + m;
      A v = 0;
      if (row >= 0 && row < a.K && gm < a.M)
        v = stage_value<T::kStage>(a.x[(size_t)gm * a.K + row], 1.0f);
      xs[e * S + m] = v;
    }
    __syncthreads();
    if (col_ok) {
      const size_t slab = (size_t)kb * a.gn + g;
      ell_gather<MT, S, L, false, VAR>(
          a.pos + slab * a.rows_pos * a.slab_n + n, a.slab_n, rp, warp, lane,
          xs, acc, osum);
      ell_gather<MT, S, L, true, VAR>(
          a.neg + slab * a.rows_neg * a.slab_n + n, a.slab_n, rn, warp, lane,
          xs, acc, osum);
    }
  }
  if constexpr (VAR == kVarNoGather) {
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] += osum;
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

// Launch over one ELL layout with the smallest M-tile that holds M (more
// row tiles above 32); cudaErrorInvalidValue if the K-block does not fit
// the stage.
template <int L, int VAR = kVarFull>
int run_ell(const EllArgs& a, void* stream) {
  if (a.block_k < 1 || EllTraits<L>::entries(a.block_k) > kEllEntries ||
      a.slab_n < 1 || a.cap_tile < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kCols, kWarps);
  const int gx = cdiv(a.N, kCols);
  if (a.M <= 4) {
    ell_kernel<4, L, VAR><<<dim3(gx, cdiv(a.M, 4)), block, 0, s>>>(a);
  } else if (a.M <= 8) {
    ell_kernel<8, L, VAR><<<dim3(gx, cdiv(a.M, 8)), block, 0, s>>>(a);
  } else if (a.M <= 16) {
    ell_kernel<16, L, VAR><<<dim3(gx, cdiv(a.M, 16)), block, 0, s>>>(a);
  } else {
    ell_kernel<32, L, VAR><<<dim3(gx, cdiv(a.M, 32)), block, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace ternary
