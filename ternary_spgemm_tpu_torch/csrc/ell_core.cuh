// Core of the ELL gather SpMM kernels: one signed gather-sum over the three
// ELL containers, Y = stage(X) . W + b [PReLU]. The X rules, the constants
// and Acc are bitplane_core.cuh's.
//
// Every container stores, per K-block and column, the local row offsets of
// the column's nonzeros as int8 slots, one section of slot rows a sign; a
// slot past the column's own count holds a sentinel, so in every column the
// real slots of a section (of a word, for the deposit) come first and the
// sentinels after them. Slab (kb, g) of a section starts at element
// ((kb*gn + g)*rows)*slab_n, slot row r of column col = g*slab_n + n at
// + r*slab_n + n (ternary_spgemm_tpu_torch/formats/):
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
// Design:
//   * one output column per lane, 32 columns x 8 warps a block, an M-tile
//     of MT <= 32 rows of X;
//   * X is staged in two steps a K-block. cp.async copies the K-block's
//     rows of X, row-major as they lie in device memory (16 bytes a thread,
//     neighbouring threads on neighbouring addresses along K; 4 bytes a
//     thread where K is not a multiple of 4), into one of two raw buffers,
//     together with the slot rows the block's warps will walk (32 bytes a
//     row, the block's 32 columns). Block kb + 1 is copied while block kb
//     is transposed and walked. The block transposes the raw rows into the
//     offset-major stage by the STAGE rule: entry e holds the MT rows of
//     one dense row (f32 as is; for the deposit the i8 floor as int16, two
//     rows a 32-bit word, added a word at a time into packed sums that are
//     unpacked into int32 every kEllPackRows slot rows: exact for floor(x)
//     in [-512, 512], the kernel's domain), so a lane reads the MT rows its
//     slot names in MT/4 (f32) or MT/8 (int16) 16-byte loads. Every
//     sentinel names a staged zero (entry block_k, entry 31 of each
//     32-entry word, or, for BlockedEllTCSC, entry 0 with every offset
//     moved up by one), so a padding slot adds exactly 0 with no branch;
//     rows at or past K and M stage 0 too (the copies zero-fill them);
//   * an entry is an odd number of 16-byte quads apart (or 16 / 8 bytes
//     when it is one quad or less): random offsets then spread over the
//     eight quads of a shared-memory wavefront, and the transpose's 16-byte
//     stores of neighbouring entries fall on distinct banks;
//   * the 8 warps split the slot rows (for the deposit plane, warp w takes
//     word w), bounded by the largest cap among the warp's columns, and
//     read them 4 at a time from the staged slots. A warp stops as soon as
//     every lane's slot is the sentinel (kVarFull): the rows after it are
//     sentinels too. pos slots add, neg slots subtract; the warps' partial
//     sums are added in shared memory in a fixed order, so the f32 sums
//     are deterministic (the early exit drops only adds of a staged 0);
//   * a column at or past N is not written.
//
// What bounds it on an H100: not the bytes (one slot byte a nonzero, X and
// Y: ~1.6 MB at 32x1024x4096 s=4, 0.5 us at 3.35 TB/s) but the per-K-block
// staging of X: L2 traffic of M*K*4 bytes for every 32 columns, the copies'
// latency, the transposes into the offset-major stage and two barriers a
// K-block, which the copy one K-block ahead does not hide. The deposit
// ladder (tools/deposit_study.py) measured it on an H100: its "noslots"
// rung, which stages X and walks to the caps without gathering, takes
// 85-94% of the time of the full kernel. The shared-memory gather comes
// second: each slot a lane walks reads MT staged values from a random
// entry, 64 bytes at MT = 32 in int16, 128 in f32, with the bank conflicts
// of random offsets, and the MT (f32) or MT/2 (packed int16) adds it
// feeds; the walk visits about 1.5-2x the nonzeros (the sentinels up to
// the warp's longest column). At N = 4096 the grid is only N/32 = 128
// blocks, one on each SM.
#pragma once

#include "bitplane_core.cuh"

namespace ternary {

enum EllLayout { kEllTiled = 0, kEllDeposit = 1, kEllBlocked = 2 };

// The kernel's work, and the attribution ladder of the deposit study
// (ternary_spgemm_tpu_torch/tools/deposit_study.py; deposit layout only):
//   kVarFull: the registered kernels, slot loops to the per-tile caps with
//     the warp's early exit at the sentinels;
//   kVarStaticCap: the loops run to the whole section (static_pos /
//     static_neg slot rows), no early exit; the extra sentinel slots add 0;
//   kVarNoGather: slot bytes staged and summed into every row's result, X
//     read at entry (r & 7) * 32 + lane, lane-contiguous (no random-offset
//     bank conflicts); loops to the per-tile caps, no early exit (a
//     sentinel's byte is part of the sum);
//   kVarNoSlots: no slot copies or loads; X read as kVarNoGather.
enum EllVariant { kVarFull = 0, kVarStaticCap = 1, kVarNoGather = 2,
                  kVarNoSlots = 3 };

constexpr int kEllEntries = 256;   // staged entries a K-block, at most
constexpr int kEllUnroll = 4;      // slot rows a warp reads at once
constexpr int kMaxSmem = 232448;   // shared memory a block may opt into

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
  static constexpr bool kOnePlane = true;   // both sections in one slab
  __host__ __device__ static int entries(int block_k) { return block_k + 1; }
  // staged entry of local dense row j < block_k of a K-block
  __device__ static int entry_of(int j) { return j; }
  // staged entry of offset ``off`` in slot row r of a section
  __device__ static int entry(int off, int) { return off; }
  __device__ static int sentinel(int block_k) { return block_k; }
};

template <>
struct EllTraits<kEllDeposit> {
  static constexpr int kStage = kStageI8;
  static constexpr int kRowsPerSlot = 8;
  static constexpr bool kOnePlane = true;
  __host__ __device__ static int entries(int) { return 256; }
  __device__ static int entry_of(int j) { return (j / 31) * 32 + j % 31; }
  __device__ static int entry(int off, int r) { return (r & 7) * 32 + off; }
  __device__ static int sentinel(int) { return 31; }
};

template <>
struct EllTraits<kEllBlocked> {
  static constexpr int kStage = kStageF32;
  static constexpr int kRowsPerSlot = 1;
  static constexpr bool kOnePlane = false;
  __host__ __device__ static int entries(int block_k) { return block_k + 1; }
  __device__ static int entry_of(int j) { return j + 1; }
  __device__ static int entry(int off, int) { return off + 1; }
  __device__ static int sentinel(int) { return -1; }
};

// The dynamic shared memory of one block: the stage (entries x kSB bytes),
// two raw X buffers (MT rows of raw_w floats; the warps' partial sums reuse
// them after the last K-block) and two slot buffers (the rows of both
// sections, 32 bytes each)
template <int MT, int L>
struct EllSmem {
  static constexpr int kStage = EllTraits<L>::kStage;
  static constexpr int kElt = kStage == kStageF32 ? 4 : 2;  // staged bytes
  static constexpr int kEB = MT * kElt;                     // an entry's rows
  static constexpr int kSB =
      kEB <= 16 ? kEB : ((kEB / 16) % 2 ? kEB : kEB + 16);  // entry stride
  // rows of MT a thread transposes into one 16-byte (int16 MT=4: 8) store
  static constexpr int kV = kStage == kStageF32 ? 4 : (MT < 8 ? MT : 8);
  __host__ __device__ static int r16(int b) { return (b + 15) & ~15; }
  // floats a raw row: the K-block and up to 3 rows before it (alignment)
  __host__ __device__ static int raw_w(int block_k) {
    return (block_k + 3 + 3) & ~3;
  }
  __host__ __device__ static int xs_bytes(int block_k) {
    return r16(EllTraits<L>::entries(block_k) * kSB);
  }
  __host__ __device__ static int raw_bytes(int block_k) {
    const int raw = 2 * MT * raw_w(block_k) * 4;
    const int red = kWarps * MT * kCols * 4;
    return raw > red ? raw : red;
  }
  __host__ __device__ static int slot_rows(const EllArgs& a) {
    return EllTraits<L>::kOnePlane ? a.rows_pos : a.rows_pos + a.rows_neg;
  }
  __host__ __device__ static int bytes(const EllArgs& a) {
    return xs_bytes(a.block_k) + raw_bytes(a.block_k) +
           2 * slot_rows(a) * kCols;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A lane's MT sums. f32: added entry by entry. int16 (the deposit): each
// staged word packs rows 2i (low half, biased by +512 so that it is never
// negative) and 2i + 1 (high half), and the walk adds or subtracts whole
// words into MT/2 packed sums, one add a word. After at most kEllPackRows
// slot rows the low halves differ by at most kEllPackRows * 1024 < 2^15 and
// the high halves sum to less than 2^15 in magnitude, so flush() recovers
// both exactly (the low one less 512 for each pos row and plus 512 for
// each neg row) into the int32 sums.
template <int MT, int STAGE>
struct EllAcc {
  float v[MT];
  __device__ void init() {
#pragma unroll
    for (int m = 0; m < MT; ++m) v[m] = 0.0f;
  }
  template <bool NEG>
  __device__ __forceinline__ void add(const uint8_t* xs) {
    const float4* q4 = reinterpret_cast<const float4*>(xs);
#pragma unroll
    for (int j = 0; j < MT / 4; ++j) {
      const float4 q = q4[j];
      if constexpr (NEG) {
        v[4 * j] -= q.x; v[4 * j + 1] -= q.y;
        v[4 * j + 2] -= q.z; v[4 * j + 3] -= q.w;
      } else {
        v[4 * j] += q.x; v[4 * j + 1] += q.y;
        v[4 * j + 2] += q.z; v[4 * j + 3] += q.w;
      }
    }
  }
  __device__ __forceinline__ void room(int) {}
  __device__ void flush() {}
};

constexpr int kEllPackRows = 28;   // slot rows between flushes, at most
constexpr int kEllPackBias = 512;  // added to a staged word's low half

template <int MT>
struct EllAcc<MT, kStageI8> {
  int v[MT];
  int p[MT / 2];
  int rows, bias;           // rows added since the flush; pos less neg
  __device__ void init() {
#pragma unroll
    for (int m = 0; m < MT; ++m) v[m] = 0;
#pragma unroll
    for (int i = 0; i < MT / 2; ++i) p[i] = 0;
    rows = bias = 0;
  }
  template <bool NEG>
  __device__ __forceinline__ void add(const uint8_t* xs) {
    int w[MT / 2];
    if constexpr (MT == 4) {
      const int2 q = *reinterpret_cast<const int2*>(xs);
      w[0] = q.x; w[1] = q.y;
    } else {
      const int4* q4 = reinterpret_cast<const int4*>(xs);
#pragma unroll
      for (int j = 0; j < MT / 8; ++j) {
        const int4 q = q4[j];
        w[4 * j] = q.x; w[4 * j + 1] = q.y;
        w[4 * j + 2] = q.z; w[4 * j + 3] = q.w;
      }
    }
#pragma unroll
    for (int i = 0; i < MT / 2; ++i) p[i] = NEG ? p[i] - w[i] : p[i] + w[i];
    ++rows;
    bias += NEG ? -1 : 1;
  }
  // flush first if ``n`` more rows could overflow a packed low half
  __device__ __forceinline__ void room(int n) {
    if (rows + n > kEllPackRows) flush();
  }
  __device__ void flush() {
#pragma unroll
    for (int i = 0; i < MT / 2; ++i) {
      const int lo = (int)(short)p[i];
      v[2 * i] += lo - kEllPackBias * bias;
      v[2 * i + 1] += (p[i] - lo) >> 16;
      p[i] = 0;
    }
    rows = bias = 0;
  }
};

// Add (or, NEG, subtract) the staged rows that ``rows`` slot rows of one
// column name, the slot bytes at sl[r * 32 + lane]; warp w takes rows w,
// w + 8, ..., kEllUnroll at a time, and (kVarFull) stops after the first
// group in which some row is the sentinel in every lane (VAR: the entry
// each slot row reads, and whether its byte is read; kVarNoGather sums the
// bytes into ``osum``)
template <int MT, int L, bool NEG, int VAR, typename Acc_>
__device__ __forceinline__ void ell_walk(const int8_t* sl, int rows, int sent,
                                         int warp, int lane,
                                         const uint8_t* xs, Acc_& acc,
                                         int& osum) {
  using T = EllTraits<L>;
  using Sm = EllSmem<MT, L>;
  constexpr bool kExit = VAR == kVarFull;
  for (int r0 = warp; r0 < rows; r0 += kEllUnroll * kWarps) {
    int off[kEllUnroll];
#pragma unroll
    for (int u = 0; u < kEllUnroll; ++u) {
      const int r = r0 + u * kWarps;
      off[u] = (VAR == kVarNoSlots || r >= rows) ? sent
                                                 : (int)sl[r * kCols + lane];
    }
    int live = kEllUnroll;
    if constexpr (kExit) {   // a lane's real slots are a prefix of the group
      int n = 0;
#pragma unroll
      for (int u = 0; u < kEllUnroll; ++u) n += off[u] != sent;
      live = __reduce_max_sync(0xffffffffu, n);
    }
    acc.room(kEllUnroll);
#pragma unroll
    for (int u = 0; u < kEllUnroll; ++u) {
      const int r = r0 + u * kWarps;
      if (u < live && r < rows) {          // uniform across the warp
        int e;
        if constexpr (VAR == kVarNoSlots) {
          e = T::entry(lane, r);
        } else if constexpr (VAR == kVarNoGather) {
          osum += off[u];
          e = T::entry(lane, r);
        } else {
          e = T::entry(off[u], r);
        }
        acc.template add<NEG>(xs + e * Sm::kSB);
      }
    }
    if (kExit && live < kEllUnroll) break;
  }
}

// f(q, j) for the cells of a rows x width grid that thread tid takes,
// kThreads apart in row-major order, with no division a step
template <class F>
__device__ __forceinline__ void grid_walk(int rows, int width, int tid,
                                          F&& f) {
  const int dq = kThreads / width, dj = kThreads - dq * width;
  int q = tid / width, j = tid - q * width;
  while (q < rows) {
    f(q, j);
    j += dj;
    q += dq;
    if (j >= width) {
      j -= width;
      ++q;
    }
  }
}

template <int MT, int L, int VAR>
__global__ void __launch_bounds__(kThreads) ell_kernel(const EllArgs a) {
  static_assert(VAR == kVarFull || L == kEllDeposit,
                "the attribution ladder is the deposit layout's");
  using T = EllTraits<L>;
  using Sm = EllSmem<MT, L>;
  using A = Acc<T::kStage>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const xs = smem;
  float* const raw = reinterpret_cast<float*>(smem + Sm::xs_bytes(a.block_k));
  int8_t* const slots = reinterpret_cast<int8_t*>(
      smem + Sm::xs_bytes(a.block_k) + Sm::raw_bytes(a.block_k));
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kCols + lane;
  const int col0 = blockIdx.x * kCols;
  const int col = col0 + lane;
  const int m0 = blockIdx.y * MT;
  const bool col_ok = col < a.N;
  const int ci = col_ok ? col / a.cap_tile : 0;
  const int sent = T::sentinel(a.block_k);
  const int rw = Sm::raw_w(a.block_k);
  const int srows = Sm::slot_rows(a);
  // 16-byte copies where the addresses allow them: X rows on 16-byte
  // boundaries, and all 32 columns of the block in one slab on 16 bytes
  const bool vec_x =
      a.K % 4 == 0 && (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
  const bool vec_s = a.slab_n % kCols == 0 &&
                     ((reinterpret_cast<uintptr_t>(a.pos) |
                       reinterpret_cast<uintptr_t>(a.neg)) & 15) == 0;
  const int g0 = col0 / a.slab_n, n0 = col0 - g0 * a.slab_n;

  // slot rows to walk in a K-block: the largest cap among the warp's
  // columns (the same 32 columns in every warp), or the whole sections
  auto walk_rows = [&](int cap) {
    return __reduce_max_sync(0xffffffffu, cap * T::kRowsPerSlot);
  };
  auto load_caps = [&](int kb, int& cp, int& cn) {
    cp = cn = 0;
    if (VAR != kVarStaticCap && col_ok) {
      cp = a.cap_pos[kb * a.ncaps + ci];
      cn = a.cap_neg[kb * a.ncaps + ci];
    }
  };
  auto bounds = [&](int cp, int cn, int& rp, int& rn) {
    if constexpr (VAR == kVarStaticCap) {
      rp = a.static_pos;
      rn = a.static_neg;
    } else {
      rp = walk_rows(cp);
      rn = walk_rows(cn);
    }
  };

  // copy K-block kb's rows of X into raw buffer buf
  auto stage_x = [&](int kb, int buf) {
    float* rb = raw + buf * MT * rw;
    const int k0 = kb * a.block_k;
    if (vec_x) {
      const int c0 = k0 & ~3;
      grid_walk(MT, rw / 4, tid, [&](int m, int c) {
        const int k = c0 + 4 * c, gm = m0 + m;
        const bool ok = gm < a.M && k < a.K;
        cp_async16(rb + m * rw + 4 * c, ok ? a.x + (size_t)gm * a.K + k : a.x,
                   ok ? 16 : 0);
      });
    } else {
      grid_walk(MT, a.block_k, tid, [&](int m, int j) {
        const int k = k0 + j, gm = m0 + m;
        const bool ok = gm < a.M && k < a.K;
        cp_async4(rb + m * rw + j, ok ? a.x + (size_t)gm * a.K + k : a.x,
                  ok ? 4 : 0);
      });
    }
  };
  // copy K-block kb's rp pos and rn neg slot rows into slot buffer buf
  auto stage_slots = [&](int kb, int buf, int rp, int rn) {
    if constexpr (VAR != kVarNoSlots) {
      int8_t* sb = slots + buf * srows * kCols;
      if (vec_s) {
        const size_t slab = (size_t)kb * a.gn + g0;
        const int8_t* ps = a.pos + slab * a.rows_pos * a.slab_n + n0;
        const int8_t* ns = a.neg + slab * a.rows_neg * a.slab_n + n0;
        for (int i = tid; i < 2 * (rp + rn); i += kThreads) {
          const int r = i >> 1, h = (i & 1) * 16;
          const int8_t* src = r < rp ? ps + (size_t)r * a.slab_n
                                     : ns + (size_t)(r - rp) * a.slab_n;
          cp_async16(sb + r * kCols + h, src + h, 16);
        }
      } else {            // byte loads; a column at or past N reads sentinels
        for (int i = tid; i < (rp + rn) * kCols; i += kThreads) {
          const int r = i / kCols, c = col0 + (i - r * kCols);
          int8_t v = (int8_t)sent;
          if (c < a.N) {
            const int g = c / a.slab_n, n = c - g * a.slab_n;
            const size_t slab = (size_t)kb * a.gn + g;
            v = r < rp ? a.pos[(slab * a.rows_pos + r) * a.slab_n + n]
                       : a.neg[(slab * a.rows_neg + r - rp) * a.slab_n + n];
          }
          sb[i] = v;
        }
      }
    }
  };

  // the raw rows of K-block kb (buffer buf) -> the offset-major stage
  auto transpose = [&](int kb, int buf) {
    constexpr int V = Sm::kV;
    const float* rb = raw + buf * MT * rw + (vec_x ? (kb * a.block_k) & 3 : 0);
    grid_walk(MT / V, a.block_k, tid, [&](int mg, int j) {
      const float* src = rb + mg * V * rw + j;
      uint8_t* dst = xs + T::entry_of(j) * Sm::kSB + mg * V * Sm::kElt;
      if constexpr (T::kStage == kStageF32) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(src[0], src[rw], src[2 * rw], src[3 * rw]);
      } else {
        int w[V / 2];
#pragma unroll
        for (int p = 0; p < V / 2; ++p) {
          const int lo = stage_value<kStageI8>(src[2 * p * rw], 1.0f);
          const int hi = stage_value<kStageI8>(src[(2 * p + 1) * rw], 1.0f);
          w[p] = (int)((unsigned)hi << 16) + lo + kEllPackBias;
        }
        if constexpr (V == 8) {
          *reinterpret_cast<int4*>(dst) = make_int4(w[0], w[1], w[2], w[3]);
        } else {
          *reinterpret_cast<int2*>(dst) = make_int2(w[0], w[1]);
        }
      }
    });
  };

  // the zero entries the sentinels name are never written by a transpose
  // (an int16 word of two zero rows holds the low half's bias)
  const int zero = T::kStage == kStageF32 ? 0 : kEllPackBias;
  for (int i = tid; i < Sm::xs_bytes(a.block_k) / 16; i += kThreads)
    reinterpret_cast<int4*>(xs)[i] = make_int4(zero, zero, zero, zero);

  int rp, rn;
  {
    int cp, cn;
    load_caps(0, cp, cn);
    stage_x(0, 0);                // in flight while the caps arrive
    bounds(cp, cn, rp, rn);
    stage_slots(0, 0, rp, rn);
    cp_async_commit();
  }

  EllAcc<MT, T::kStage> acc;
  acc.init();
  int osum = 0;

  for (int kb = 0; kb < a.nb; ++kb) {
    const int buf = kb & 1;
    const bool next = kb + 1 < a.nb;
    int cpn = 0, cnn = 0;
    if (next) load_caps(kb + 1, cpn, cnn);   // in flight through the wait
    cp_async_wait_all();
    __syncthreads();   // block kb's copies landed; block kb-1's walk done
    // block kb + 1's copies go into the buffers block kb - 1 used, and
    // overlap the transpose and the walk of block kb
    if (next) stage_x(kb + 1, buf ^ 1);
    transpose(kb, buf);
    int rpn = 0, rnn = 0;
    if (next) {
      bounds(cpn, cnn, rpn, rnn);
      stage_slots(kb + 1, buf ^ 1, rpn, rnn);
      cp_async_commit();
    }
    __syncthreads();   // the stage holds block kb
    const int8_t* sb = slots + buf * srows * kCols;
    ell_walk<MT, L, false, VAR>(sb, rp, sent, warp, lane, xs, acc, osum);
    ell_walk<MT, L, true, VAR>(sb + rp * kCols, rn, sent, warp, lane, xs, acc,
                               osum);
    rp = rpn;
    rn = rnn;
  }
  acc.flush();
  if constexpr (VAR == kVarNoGather) {
#pragma unroll
    for (int m = 0; m < MT; ++m) acc.v[m] += osum;
  }

  // add the 8 warps' partial sums (warp w finishes rows w, w + 8, ...) and
  // apply _epilogue: float(acc) + b, then where(y > 0, y, alpha * y)
  constexpr int RPT = (MT + kWarps - 1) / kWarps;
  A* red = reinterpret_cast<A*>(raw);
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m) red[(warp * MT + m) * kCols + lane] = acc.v[m];
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

template <int MT, int L, int VAR>
int launch_ell(const EllArgs& a, cudaStream_t s) {
  const int smem = EllSmem<MT, L>::bytes(a);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  void (*kernel)(const EllArgs) = &ell_kernel<MT, L, VAR>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(cdiv(a.N, kCols), cdiv(a.M, MT)), dim3(kCols, kWarps), smem,
           s>>>(a);
  return (int)cudaGetLastError();
}

// Launch over one ELL layout with the smallest M-tile that holds M (more
// row tiles above 32); cudaErrorInvalidValue if the K-block does not fit
// the stage or the slot rows do not fit shared memory.
template <int L, int VAR = kVarFull>
int run_ell(const EllArgs& a, void* stream) {
  if (a.block_k < 1 || EllTraits<L>::entries(a.block_k) > kEllEntries ||
      a.slab_n < 1 || a.cap_tile < 1 || a.rows_pos < 0 || a.rows_neg < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.M <= 4) return launch_ell<4, L, VAR>(a, s);
  if (a.M <= 8) return launch_ell<8, L, VAR>(a, s);
  if (a.M <= 16) return launch_ell<16, L, VAR>(a, s);
  return launch_ell<32, L, VAR>(a, s);
}

}  // namespace ternary
