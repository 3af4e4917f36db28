// Decode-rate probe of the streaming decode body, for Hopper (sm_90a).
//
// Replaces tools/decode_roofline.py::measure_decode_rate (:32, its kernel
// :47-64). The TPU probe times the magic-multiply bit deposit of its Pallas
// kernels on a VMEM-resident plane tile. What the port's decode branch of
// CudaTiledBitplane_i8 (the tool's flagship; gemv_core.cuh) runs for each
// byte-row is its inner step: a lane's 32-bit pos and neg words (four
// columns), ternary4 (ternary4.cuh) on each nibble pair, and the i8 rule's
// two __dp4a a row, dp4a(32w, hi) + dp4a(w, lo), against X staged as int8
// hi = v >> 5, lo = v & 31. This probe runs that step (gemv::consume, at an
// M-tile of 8 rows) on a shared-memory-resident tile, with no device-memory
// traffic in the timed loop:
//   * the (2*tkb, tns) uint8 plane tile, its rows padded with zeros to a
//     multiple of 128 columns, and the (8, B = 8*tkb) int32 X, staged as
//     the body stages it (words (byte-row, row, half, hi / lo) of four
//     activations k .. k + 3), are put in shared memory once; X is int32 in
//     [-127, 127] at the interface, where 32*hi + lo == v exactly;
//   * repetition r decodes the tile perturbed as (p + r) & 0xFF byte by byte
//     (__vadd4 on the words; as the TPU probe does, so that no repetition
//     can be hoisted or folded):
//       out[m, n] = sum_r sum_k X[m, k] * W_r[k, n],
//     W_r the tile's dense weights (row h*4*tkb + 4t + j of byte-row t);
//   * a block is the body's 8 warps: warp w takes byte-rows w, w + 8, ...
//     (the body's walk order), kBatch words a set, lane l columns 128c +
//     4l .. + 3 of column tile c, the column tiles in turn; the warps' sums
//     are added in shared memory (exact int32 sums: any order gives the
//     same bits) and the block stores the (8, tns) result (all blocks store
//     the same values), so a launch of ``blocks`` blocks measures ``blocks``
//     SMs at one block each (the tile, X and the sums take 160 KB of shared
//     memory at tkb = 128, tns = 512: one block an SM).
//
// What bounds it: one SM's integer issue: a lane and byte-row take 128
// __dp4a (4 columns x 8 rows x 2 halves x hi and lo) beside 8 ternary4, 8
// times32, the bytes' extraction and two perturbations.
//
// Returns cudaGetLastError() (or the error of the shared-memory attribute,
// for a tile that does not fit); the Python wrapper raises on anything but 0.

#include "gemv_core.cuh"

namespace {

namespace gemv = ternary::gemv;

constexpr int kDecodeRows = 8;
// staged X words a byte-row: 8 rows x 2 halves x (hi, lo)
constexpr int kRowWords = gemv::row_words<kDecodeRows, ternary::kStageI8>();

__host__ __device__ constexpr int padded_cols(int tns) {
  return ternary::cdiv(tns, gemv::kCols) * gemv::kCols;
}

__host__ __device__ constexpr size_t smem_bytes(int tkb, int tns) {
  return sizeof(int) * ((size_t)tkb * kRowWords + (size_t)kDecodeRows * padded_cols(tns))
         + 2 * (size_t)tkb * padded_cols(tns);
}

__global__ void __launch_bounds__(gemv::kThreads, 1)
decode_rate_kernel(const uint8_t* __restrict__ plane, int tkb, int tns,
                   const int* __restrict__ x, int reps, int* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TS = padded_cols(tns);
  const int B = 8 * tkb;
  int* xs = reinterpret_cast<int*>(smem);                     // tkb x kRowWords
  int* red = xs + (size_t)tkb * kRowWords;                    // (8, TS)
  uint8_t* ps = reinterpret_cast<uint8_t*>(red + kDecodeRows * TS);   // (2*tkb, TS)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // X as the body stages it: word (t, m, h, a) holds activations k .. k + 3,
  // k = h*4*tkb + 4t, of row m; a = 0 the hi bytes, 1 the lo bytes
  for (int i = tid; i < tkb * 2 * kDecodeRows; i += blockDim.x) {
    const int t = i / (2 * kDecodeRows), mh = i % (2 * kDecodeRows);
    const int m = mh >> 1, h = mh & 1;
    const int* xr = x + (size_t)m * B + h * 4 * tkb + 4 * t;
    int hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) { hi[j] = xr[j] >> 5; lo[j] = xr[j] & 31; }
    xs[t * kRowWords + mh * 2] = gemv::pack4(hi);
    xs[t * kRowWords + mh * 2 + 1] = gemv::pack4(lo);
  }
  for (int i = tid; i < 2 * tkb * TS; i += blockDim.x) {
    const int row = i / TS, c = i - row * TS;
    ps[i] = c < tns ? plane[(size_t)row * tns + c] : 0;
  }
  for (int i = tid; i < kDecodeRows * TS; i += blockDim.x) red[i] = 0;
  __syncthreads();

  // this warp's byte-rows: warp + kWarps * i, i < cnt
  const int cnt = tkb > warp ? (tkb - warp + gemv::kWarps - 1) / gemv::kWarps : 0;
  const uint32_t* pw = reinterpret_cast<const uint32_t*>(ps);
  const int tsw = TS / gemv::kColsLane;                       // words a tile row
  for (int c0 = 0; c0 < TS; c0 += gemv::kCols) {
    const int cw = (c0 + gemv::kColsLane * lane) / gemv::kColsLane;
    int acc[gemv::kColsLane][kDecodeRows];
#pragma unroll
    for (int c = 0; c < gemv::kColsLane; ++c)
#pragma unroll
      for (int m = 0; m < kDecodeRows; ++m) acc[c][m] = 0;
    for (int r = 0; r < reps; ++r) {
      const uint32_t rr = (uint32_t)(r & 0xFF) * 0x01010101u;
      for (int i0 = 0; i0 < cnt; i0 += gemv::kBatch) {
        uint32_t p[gemv::kBatch], q[gemv::kBatch];
#pragma unroll
        for (int j = 0; j < gemv::kBatch; ++j) {
          const int t = warp + gemv::kWarps * (i0 + j);
          p[j] = 0u;
          q[j] = 0u;
          if (i0 + j < cnt) {
            p[j] = __vadd4(pw[(size_t)t * tsw + cw], rr);
            q[j] = __vadd4(pw[(size_t)(tkb + t) * tsw + cw], rr);
          }
        }
        gemv::consume<kDecodeRows, ternary::kStageI8>(p, q, i0, cnt, warp, xs,
                                                      acc);
      }
    }
#pragma unroll
    for (int c = 0; c < gemv::kColsLane; ++c)
#pragma unroll
      for (int m = 0; m < kDecodeRows; ++m)
        atomicAdd(red + m * TS + c0 + gemv::kColsLane * lane + c, acc[c][m]);
  }
  __syncthreads();
  for (int i = tid; i < kDecodeRows * tns; i += blockDim.x)
    out[i] = red[(i / tns) * TS + i % tns];
}

}  // namespace

extern "C" int ternary_decode_rate(const uint8_t* plane, int tkb, int tns,
                                   const int* x, int reps, int blocks,
                                   int* out, void* stream) {
  if (tkb < 1 || tns < 1 || reps < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(tkb, tns);
  int err = (int)cudaFuncSetAttribute(
      decode_rate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != 0) return err;
  decode_rate_kernel<<<blocks, gemv::kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      plane, tkb, tns, x, reps, out);
  return (int)cudaGetLastError();
}
