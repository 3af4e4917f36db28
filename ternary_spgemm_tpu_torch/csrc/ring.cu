// Ring all-gather SpMM over d ranks on one card, for Hopper (sm_90a).
//
// Replaces ternary_spgemm_tpu/parallel/ring_kernel.py::ring_allgather_spgemm
// (:92; its kernel _ring_kernel :42, pallas_call :113). Y = X @ W + b with X
// (M, K) f32 cut row-wise into d chunks of mc = M/d rows, and W (K, N) int8
// ternary (DenseTernary) and b (N,) f32 cut column-wise into d shards of
// NL = N/d columns. Rank r holds chunk r and shard r. At each of d steps
// it starts copying the chunk it holds to its right neighbour, multiplies
// the same chunk by its shard while the copy is in flight, and writes rows
// owner*mc of its Y columns, owner = (r - t) mod d. After d steps each rank
// has seen every chunk; Y is the (M, N) array that JAX's P(None, axis)
// output assembles to.
//
// On the TPU each rank is a chip and the copy a remote DMA. Here the d
// ranks are d groups of B blocks in ONE cooperative launch (blocks
// [r*B, (r+1)*B) play rank r), every "remote" buffer lies in the same
// device memory, and the copies and flags are real device-memory traffic:
// the emulation the JAX tests run in Pallas interpret mode, on a card.
//
// The protocol is the TPU kernel's (:11-17, :49-89):
//   * buf (d, 2, mc, K): double-buffered chunk slots a rank; rank r first
//     copies its X chunk into buf[r][0] (each block a slice);
//   * a neighbour barrier: no block starts step 0 before every block of its
//     rank and of both neighbours has entered (ready[]);
//   * step t reads slot t % 2. Before it, the step's data must have arrived
//     (recv[r][t%2] counts the left neighbour's copied slices);
//   * copy warps (2 a block, warp specialisation: the overlap is in the
//     block's structure) copy their slice of buf[r][t%2] into
//     buf[right][(t+1)%2] while the compute warps (8 a block) run the
//     product; the copy waits first, when t >= 1, for the right neighbour's
//     ack that it has consumed that slot (its step t-1): ranks can lag each
//     other by up to d-1 steps, so two slots need the explicit ack;
//   * after the step every block acks its slot to the left neighbour
//     (ack[r][t%2]), only when t <= d-3 (only the acks someone waits for).
//     The ack comes after the block's copy too, not only its product (the
//     TPU kernel signals it before rdma.wait()): the copy reads the slot as
//     well, and the left neighbour's next write must not overtake it.
// Flags are counters in global memory, zeroed by the launcher before every
// launch (so back-to-back launches are independent). A writer stores its
// data, fences (__threadfence by every writing thread), meets its group at a
// barrier, and one thread adds one to the flag; a reader's one thread polls
// with ld.acquire.gpu, then its block meets at a barrier, and only then are
// the data read. Every spin is bounded (5 s on the global timer) and traps when
// the bound is exceeded, so a protocol fault fails the launch instead of
// hanging it. The launch is cooperative: it fails outright when the d*B
// blocks cannot all be resident, and B comes from the occupancy API, so it
// never deadlocks on a block that was not scheduled.
//
// The product is dense_mma.cuh's tile (the one CudaDense runs, f32 X split
// into three bf16 pieces, kStageF32 over RowMajor) on the rank's column
// shard of W: the compute warps call dense_tile on the held slot, splitting
// it as they stage it, one tile of Y at a time (Narrow, 32 x 32, for mc <=
// 32; Wide, 64 x 128, above), with their own named barrier and the tile's
// dynamic shared memory. Every product is exact and the sums are f32 in a fixed order (the
// TPU kernel's dot at Precision.HIGHEST, itself multi-pass bf16); on
// integer X every partial sum is an integer below 2**24, so any order is
// exact. The slot is read with plain loads: the reader's acquire at gpu
// scope and the block barrier after it order them after the writer's
// release (the pattern of a grid-wide barrier).
//
// What bounds it on an H100: the products, 2*M*nnz operations of f32 work,
// which the tile runs as three bf16 tensor-core passes (6*M*nnz at the 989
// TFLOP/s bf16 peak; the tile multiplies zeros too, so 6*M*K*N in fact);
// the copies (M*K*4 bytes a step, in L2) and W (K*N bytes a step) are far
// below.
//
// Returns the launch's cudaError_t (or that of the flag reset or the
// shared-memory limit); the Python wrapper raises on anything but 0.

#include "dense_mma.cuh"

namespace {

namespace dmma = ternary::dmma;
constexpr int kComputeThreads = dmma::kThreads;      // dense_tile's 8 warps
constexpr int kCopyThreads = 64;                     // 2 warps
constexpr int kThreads = kComputeThreads + kCopyThreads;
constexpr unsigned long long kSpinLimitNs = 5000000000ull;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One thread: spin until *p >= target; trap after kSpinLimitNs.
__device__ void wait_geq(const int* p, int target) {
  if (ld_acquire(p) >= target) return;
  const unsigned long long t0 = global_ns();
  while (ld_acquire(p) < target) {
    __nanosleep(64);
    if (global_ns() - t0 > kSpinLimitNs) __trap();
  }
}

__device__ __forceinline__ void group_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// Named barriers (0 is __syncthreads).
__device__ __forceinline__ void copy_sync() { group_sync(1, kCopyThreads); }
__device__ __forceinline__ void compute_sync() {
  group_sync(2, kComputeThreads);
}

// The slice [lo, hi) of n float4s that block bi of B copies.
__device__ __forceinline__ void slice(size_t n, int bi, int B, size_t* lo,
                                      size_t* hi) {
  *lo = n * bi / B;
  *hi = n * (bi + 1) / B;
}

// T: the tile of dense_mma.cuh (Narrow for mc <= 32, Wide above). One
// block an SM: beside the copy warps the compute warps want 168 (Wide) and
// 162 (Narrow) registers, none spilled; capped at two blocks an SM (96) they
// spilled 188 and 112 bytes, and at 512x4096x12288 on an H100
// (chip_smoke.py phase 11, each cap) the ring ran 0.70 / 0.93 / 0.94 ms at
// ranks 2 / 4 / 8 under this cap against 0.83 / 0.82 / 1.18 under that one.
template <class T>
__global__ void __launch_bounds__(kThreads, 1)
ring_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ y,
            float* buf, int* flags, int d, int B, int mc, int K, int N) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int r = blockIdx.x / B;
  const int bi = blockIdx.x % B;
  const int right = (r + 1) % d;
  const int left = (r + d - 1) % d;
  const int NL = N / d;
  const size_t chunk = (size_t)mc * K;          // floats a slot
  const size_t chunk4 = chunk / 4;              // mc is a multiple of 8
  int* ready = flags;                           // (d,)
  int* recv = flags + d;                        // (d, 2)
  int* ack = flags + 3 * d;                     // (d, 2)
  float* mine = buf + (size_t)r * 2 * chunk;    // buf[r][slot]
  float* theirs = buf + (size_t)right * 2 * chunk;

  // buf[r][0] = X chunk r (this block's slice), then the neighbour barrier
  {
    size_t lo, hi;
    slice(chunk4, bi, B, &lo, &hi);
    const float4* src = reinterpret_cast<const float4*>(x + (size_t)r * chunk);
    float4* dst = reinterpret_cast<float4*>(mine);
    for (size_t i = lo + tid; i < hi; i += kThreads) __stcg(dst + i, src[i]);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      atomicAdd(&ready[r], 1);
      wait_geq(&ready[r], B);
      wait_geq(&ready[left], B);
      wait_geq(&ready[right], B);
    }
    __syncthreads();
  }

  // tiles run down a column of row tiles first: the blocks at work at once
  // share a few column strips of W, so W comes from device memory about
  // once a step and from L2 for the other row tiles (in row order, the
  // full width ran ~10% slower on an H100)
  const int tilesM = ternary::cdiv(mc, T::BM);
  const int tiles = tilesM * ternary::cdiv(NL, T::BN);
  for (int t = 0; t < d; ++t) {
    const int slot = t & 1;
    const float* held = mine + (size_t)slot * chunk;
    if (t >= 1) {                       // this step's chunk has arrived
      if (tid == 0) wait_geq(&recv[2 * r + slot], B * ((t + 1) / 2));
      __syncthreads();
    }
    if (tid >= kComputeThreads) {
      // copy warps: buf[r][slot] -> buf[right][(t+1)%2]
      if (t < d - 1) {
        const int ct = tid - kComputeThreads;
        if (t >= 1) {   // the right neighbour has consumed that slot
          if (ct == 0) wait_geq(&ack[2 * right + ((t - 1) & 1)],
                                B * ((t + 1) / 2));
          copy_sync();
        }
        size_t lo, hi;
        slice(chunk4, bi, B, &lo, &hi);
        const float4* src = reinterpret_cast<const float4*>(held);
        float4* dst = reinterpret_cast<float4*>(
            theirs + (size_t)((t + 1) & 1) * chunk);
        for (size_t i = lo + ct; i < hi; i += kCopyThreads)
          __stcg(dst + i, __ldcg(src + i));
        __threadfence();
        copy_sync();
        if (ct == 0) atomicAdd(&recv[2 * right + ((t + 1) & 1)], 1);
      }
    } else {
      // compute warps: rows owner*mc of Y's columns [r*NL, (r+1)*NL)
      dmma::Args a{};
      a.x = held; a.M = mc; a.K = K;
      a.w = w + (size_t)r * NL; a.ldw = N; a.N = NL;
      a.bias = bias + (size_t)r * NL;
      a.alpha = nullptr;
      a.y = y + (size_t)((r - t + d) % d) * mc * N + (size_t)r * NL;
      a.ldy = N;
      a.xvec = dmma::x_vec(held, K);
      a.wvec = dmma::w_vec(a.w, N, NL);
      for (int tile = bi; tile < tiles; tile += B)
        dmma::dense_tile<T, ternary::kStageF32, dmma::RowMajor>(
            a, (tile % tilesM) * T::BM, (tile / tilesM) * T::BN, tid, smem,
            [] { compute_sync(); });
    }
    __syncthreads();                    // the block is done with the slot
    if (t <= d - 3 && tid == 0) {
      __threadfence();
      atomicAdd(&ack[2 * r + slot], 1);
    }
  }
}

// One cooperative launch of ring_kernel<T> (see ternary_ring_spgemm); the
// same dynamic shared memory for the limit, the occupancy and the launch.
template <class T>
int launch_ring(const float* x, const int8_t* w, const float* bias, float* y,
                float* buf, int* flags, int d, int mc, int K, int N,
                int* blocks_out, cudaStream_t s) {
  const int smem = dmma::Chunk<T, ternary::kStageF32, dmma::RowMajor>::smem();
  int dev = 0, sms = 0, per_sm = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = (int)cudaFuncSetAttribute(
      ring_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (!err) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ring_kernel<T>, kThreads, smem);
  if (err) return err;
  const int tiles = ternary::cdiv(mc, T::BM) * ternary::cdiv(N / d, T::BN);
  int B = per_sm * sms / d;
  if (B > tiles) B = tiles;
  if (B < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks_out = B;
  err = (int)cudaMemsetAsync(flags, 0, sizeof(int) * 5 * (size_t)d, s);
  if (err) return err;
  void* args[] = {&x, &w, &bias, &y, &buf, &flags, &d, &B, &mc, &K, &N};
  err = (int)cudaLaunchCooperativeKernel((const void*)ring_kernel<T>,
                                         dim3(d * B), dim3(kThreads), args,
                                         smem, s);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// x (d*mc, K) f32, w (K, N) int8, bias (N,) f32, y (d*mc, N) f32, buf
// (d, 2, mc, K) f32 scratch, flags (5*d,) int32 scratch; *blocks_out gets B,
// the blocks a rank.
extern "C" int ternary_ring_spgemm(const float* x, const int8_t* w,
                                   const float* bias, float* y, float* buf,
                                   int* flags, int d, int mc, int K, int N,
                                   int* blocks_out, void* stream) {
  if (d < 1 || mc < 8 || mc % 8 || K < 1 || N < d || N % d)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mc <= dmma::kNarrowMaxM)
    return launch_ring<dmma::Narrow>(x, w, bias, y, buf, flags, d, mc, K, N,
                                     blocks_out, s);
  return launch_ring<dmma::Wide>(x, w, bias, y, buf, flags, d, mc, K, N,
                                 blocks_out, s);
}
