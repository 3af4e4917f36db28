// Ring all-gather SpMM over d ranks, for Hopper (sm_90a).
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
// On the TPU each rank is a chip and the copy a remote DMA. Here one body
// (ring_body) runs in two modes:
//   * the group mode (ternary_ring_spgemm): the d ranks are d groups of B
//     blocks in ONE cooperative launch (blocks [r*B, (r+1)*B) play rank r),
//     every "remote" buffer in the same device memory: the emulation the
//     JAX tests run in Pallas interpret mode, on a card;
//   * the rank mode (ternary_ring_rank): one launch is one rank, made by its
//     own process, which reaches its right neighbour's slots and flags and
//     its left neighbour's flags through peer pointers (CUDA IPC,
//     ternary_ipc_*). That is the TPU kernel's topology: one rank a card,
//     the copies over NVLink. Ranks may also share a card, each in its own
//     process; without MPS the card then time-slices their kernels.
// The modes differ only in where the pointers come from, how r and the
// block's index bi are derived, the memory scope and the epoch.
//
// The protocol is the TPU kernel's (:11-17, :49-89). A rank's buffers are
// its two chunk slots (2, mc, K) and a flag block of int32 counters
// [ready, recv[2], ack[2]]:
//   * rank r first copies its X chunk into its slot 0 (each block a slice);
//   * a neighbour barrier: no block starts step 0 before every block of its
//     rank and of both neighbours has entered (ready);
//   * step t reads slot t % 2. Before it, the step's data must have arrived
//     (r's recv[t%2] counts the left neighbour's copied slices);
//   * copy warps (2 a block, warp specialisation: the overlap is in the
//     block's structure) copy their slice of r's slot t%2 into the right
//     neighbour's slot (t+1)%2 while the compute warps (8 a block) run the
//     product; the copy waits first, when t >= 1, for the right neighbour's
//     ack that it has consumed that slot (its step t-1): ranks can lag each
//     other by up to d-1 steps, so two slots need the explicit ack;
//   * after the step every block acks its slot to the left neighbour (r's
//     ack[t%2]), only when t <= d-3 (only the acks someone waits for).
//     The ack comes after the block's copy too, not only its product (the
//     TPU kernel signals it before rdma.wait()): the copy reads the slot as
//     well, and the left neighbour's next write must not overtake it.
// So rank r waits on its own ready and recv, its neighbours' ready and its
// right neighbour's ack, and adds to its own ready and ack and its right
// neighbour's recv: its own flag block and its neighbours' cover them all.
//
// Flags are counters. In the group mode the launcher zeroes them before
// every launch. In the rank mode that would race (a neighbour one call
// ahead could signal before the reset and lose its signal), so the
// counters are cumulative: they are zeroed once, when the communicator is
// made, and every wait target is offset by what the communicator's earlier
// calls added. A call adds to each counter a fixed count a block of each
// rank (call_adds), so the launcher passes one number, the blocks that the
// earlier calls launched a rank (the epoch, kept by parallel/ring_kernel.py
// and the same on every rank, since all make the same calls in order), and
// the offset is the epoch times call_adds. Targets are compared modulo
// 2**32, so the counters may wrap.
//
// A writer stores its data, fences (every writing thread), meets its group
// at a barrier, and one thread adds one to the flag; a reader's one thread
// polls with ld.acquire, then its block meets at a barrier, and only then
// are the data read. In the rank mode a writer may sit on another card,
// reached over NVLink, so there the fences are __threadfence_system, the
// polls ld.acquire.sys and the signals atomicAdd_system: a rule of the code,
// not of the tests (on one card gpu scope would pass them). Every spin is
// bounded (5 s on the global timer) and traps when the bound is exceeded,
// so a protocol fault, or ranks that never run at the same time, fails the
// launch instead of hanging it. Both launches are cooperative, so the B
// blocks of a rank are resident together (B from the occupancy API).
//
// The product is dense_mma.cuh's tile (the one CudaDense runs, f32 X split
// into three bf16 pieces, kStageF32 over RowMajor) on the rank's column
// shard of W: the compute warps call dense_tile on the held slot, splitting
// it as they stage it, one tile of Y at a time (Narrow, 32 x 32, for mc <=
// 32; Wide, 64 x 128, above), with their own named barrier and the tile's
// dynamic shared memory. Every product is exact and the sums are f32 in a
// fixed order (the TPU kernel's dot at Precision.HIGHEST, itself multi-pass
// bf16), the same in both modes; on integer X every partial sum is an
// integer below 2**24, so any order is exact. The slot is read with plain
// loads: the reader's acquire and the block barrier after it order them
// after the writer's release (the pattern of a grid-wide barrier).
//
// What bounds it on an H100: the products, 2*M*nnz operations of f32 work,
// which the tile runs as three bf16 tensor-core passes (6*M*nnz at the 989
// TFLOP/s bf16 peak; the tile multiplies zeros too, so 6*M*K*N in fact);
// the copies (M*K*4 bytes a step, in L2 or over NVLink) and W (K*N bytes a
// step) are far below.
//
// The entry points return the launch's cudaError_t (or that of the flag
// reset, the shared-memory limit or the IPC call); the Python wrapper
// raises on anything but 0.

#include <cstring>

#include "dense_mma.cuh"

namespace {

namespace dmma = ternary::dmma;
constexpr int kComputeThreads = dmma::kThreads;      // dense_tile's 8 warps
constexpr int kCopyThreads = 64;                     // 2 warps
constexpr int kThreads = kComputeThreads + kCopyThreads;
constexpr unsigned long long kSpinLimitNs = 5000000000ull;
// a rank's flag block: ready, recv[2], ack[2]
constexpr int kReady = 0, kRecv = 1, kAck = 3, kFlags = 5;

// What one rank's blocks work on: the group mode derives it from the
// rank's place in the shared buffers, the rank mode takes it as given.
struct Ring {
  const float* x;     // the rank's X chunk (mc, K)
  const int8_t* w;    // its W columns (K, NL), row stride ldw
  const float* bias;  // its bias columns (NL,)
  float* y;           // its Y columns (M, NL), row stride ldy
  int ldw, ldy;
  float* mine;        // its slots (2, mc, K)
  float* theirs;      // the right neighbour's slots
  int* me;            // its flag block
  const int* left;    // the left neighbour's flag block
  int* right;         // the right neighbour's flag block
};

// What one call adds to counter c of a rank's flag block, for each block
// of the rank (ring_body's schedule): its own one ready; recv[s] the left
// neighbour's copies into slot s, at the steps t <= d-2 with (t+1)%2 == s;
// ack[s] its acks of slot s, at the steps t <= d-3 with t%2 == s.
__device__ __forceinline__ unsigned call_adds(int c, int d) {
  switch (c) {
    case kReady: return 1;
    case kRecv: return (d - 1) / 2;
    case kRecv + 1: return d / 2;
    case kAck: return d > 1 ? (d - 1) / 2 : 0;
    default: return d > 2 ? (d - 2) / 2 : 0;
  }
}

// kSys: system scope (the rank mode), else gpu scope (the group mode).
template <bool kSys>
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  if constexpr (kSys)
    asm volatile("ld.acquire.sys.global.s32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <bool kSys>
__device__ __forceinline__ void fence() {
  if constexpr (kSys) __threadfence_system(); else __threadfence();
}

template <bool kSys>
__device__ __forceinline__ void signal(int* p) {
  if constexpr (kSys) atomicAdd_system(p, 1); else atomicAdd(p, 1);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool reached(int v, unsigned target) {
  return (int)((unsigned)v - target) >= 0;
}

// One thread: spin until the counter *p reaches target; trap after
// kSpinLimitNs.
template <bool kSys>
__device__ void wait_geq(const int* p, unsigned target) {
  if (reached(ld_acquire<kSys>(p), target)) return;
  const unsigned long long t0 = global_ns();
  while (!reached(ld_acquire<kSys>(p), target)) {
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

// Block bi of the B blocks of rank r of d (the file's note).
template <class T, bool kSys>
__device__ __forceinline__ void ring_body(Ring g, unsigned epoch, int d,
                                          int r, int B, int bi, int mc, int K,
                                          int NL) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const size_t chunk = (size_t)mc * K;          // floats a slot
  const size_t chunk4 = chunk / 4;              // mc is a multiple of 8

  // slot 0 = the X chunk (this block's slice), then the neighbour barrier
  {
    size_t lo, hi;
    slice(chunk4, bi, B, &lo, &hi);
    const float4* src = reinterpret_cast<const float4*>(g.x);
    float4* dst = reinterpret_cast<float4*>(g.mine);
    for (size_t i = lo + tid; i < hi; i += kThreads) __stcg(dst + i, src[i]);
    fence<kSys>();
    __syncthreads();
    if (tid == 0) {
      signal<kSys>(g.me + kReady);
      const unsigned all = epoch * call_adds(kReady, d) + B;
      wait_geq<kSys>(g.me + kReady, all);
      wait_geq<kSys>(g.left + kReady, all);
      wait_geq<kSys>(g.right + kReady, all);
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
    const float* held = g.mine + (size_t)slot * chunk;
    if (t >= 1) {                       // this step's chunk has arrived
      if (tid == 0) wait_geq<kSys>(g.me + kRecv + slot,
                                   epoch * call_adds(kRecv + slot, d) +
                                       B * ((t + 1) / 2));
      __syncthreads();
    }
    if (tid >= kComputeThreads) {
      // copy warps: my slot t%2 -> the right neighbour's slot (t+1)%2
      if (t < d - 1) {
        const int ct = tid - kComputeThreads;
        const int next = (t + 1) & 1;
        if (t >= 1) {   // the right neighbour has consumed that slot
          if (ct == 0) wait_geq<kSys>(g.right + kAck + next,
                                      epoch * call_adds(kAck + next, d) +
                                          B * ((t + 1) / 2));
          copy_sync();
        }
        size_t lo, hi;
        slice(chunk4, bi, B, &lo, &hi);
        const float4* src = reinterpret_cast<const float4*>(held);
        float4* dst = reinterpret_cast<float4*>(g.theirs + (size_t)next * chunk);
        for (size_t i = lo + ct; i < hi; i += kCopyThreads)
          __stcg(dst + i, __ldcg(src + i));
        fence<kSys>();
        copy_sync();
        if (ct == 0) signal<kSys>(g.right + kRecv + next);
      }
    } else {
      // compute warps: rows owner*mc of the rank's Y columns
      dmma::Args a{};
      a.x = held; a.M = mc; a.K = K;
      a.w = g.w; a.ldw = g.ldw; a.N = NL;
      a.bias = g.bias;
      a.alpha = nullptr;
      a.y = g.y + (size_t)((r - t + d) % d) * mc * g.ldy;
      a.ldy = g.ldy;
      a.xvec = dmma::x_vec(held, K);
      a.wvec = dmma::w_vec(a.w, g.ldw, NL);
      for (int tile = bi; tile < tiles; tile += B)
        dmma::dense_tile<T, ternary::kStageF32, dmma::RowMajor>(
            a, (tile % tilesM) * T::BM, (tile / tilesM) * T::BN, tid, smem,
            [] { compute_sync(); });
    }
    __syncthreads();                    // the block is done with the slot
    if (t <= d - 3 && tid == 0) {
      fence<kSys>();
      signal<kSys>(g.me + kAck + slot);
    }
  }
}

// T: the tile of dense_mma.cuh (Narrow for mc <= 32, Wide above). One
// block an SM: beside the copy warps the compute warps want 168 (Wide) and
// 162 (Narrow) registers, none spilled; capped at two blocks an SM (96) they
// spilled 188 and 112 bytes, and at 512x4096x12288 on an H100
// (chip_smoke.py phase 11, each cap) the ring ran 0.70 / 0.93 / 0.94 ms at
// ranks 2 / 4 / 8 under this cap against 0.83 / 0.82 / 1.18 under that one.
//
// The group mode: x (d*mc, K), w (K, N), bias (N,), y (d*mc, N), buf
// (d, 2, mc, K), flags (d, kFlags).
template <class T>
__global__ void __launch_bounds__(kThreads, 1)
ring_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ y,
            float* buf, int* flags, int d, int B, int mc, int K, int N) {
  const int r = blockIdx.x / B;
  const int right = (r + 1) % d;
  const int left = (r + d - 1) % d;
  const int NL = N / d;
  const size_t chunk = (size_t)mc * K;
  Ring g;
  g.x = x + (size_t)r * chunk;
  g.w = w + (size_t)r * NL;
  g.bias = bias + (size_t)r * NL;
  g.y = y + (size_t)r * NL;
  g.ldw = N;
  g.ldy = N;
  g.mine = buf + (size_t)r * 2 * chunk;
  g.theirs = buf + (size_t)right * 2 * chunk;
  g.me = flags + kFlags * r;
  g.left = flags + kFlags * left;
  g.right = flags + kFlags * right;
  ring_body<T, false>(g, 0u, d, r, B, blockIdx.x % B, mc, K, NL);
}

// The rank mode: one launch is rank r, its B blocks the grid.
template <class T>
__global__ void __launch_bounds__(kThreads, 1)
ring_rank_kernel(Ring g, unsigned epoch, int d, int r, int mc, int K,
                 int NL) {
  ring_body<T, true>(g, epoch, d, r, gridDim.x, blockIdx.x, mc, K, NL);
}

// The blocks of kern (kThreads each, smem bytes of dynamic shared memory)
// that the card holds at once, after raising its shared-memory limit.
template <class Kern>
int resident_blocks(Kern kern, int smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (!err) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, kThreads, smem);
  *out = per_sm * sms;
  return err;
}

template <class T>
int tile_smem() {
  return dmma::Chunk<T, ternary::kStageF32, dmma::RowMajor>::smem();
}

// One cooperative launch of ring_kernel<T> (see ternary_ring_spgemm); the
// same dynamic shared memory for the limit, the occupancy and the launch.
template <class T>
int launch_ring(const float* x, const int8_t* w, const float* bias, float* y,
                float* buf, int* flags, int d, int mc, int K, int N,
                int* blocks_out, cudaStream_t s) {
  const int smem = tile_smem<T>();
  int resident = 0;
  int err = resident_blocks(ring_kernel<T>, smem, &resident);
  if (err) return err;
  const int tiles = ternary::cdiv(mc, T::BM) * ternary::cdiv(N / d, T::BN);
  int B = resident / d;
  if (B > tiles) B = tiles;
  if (B < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks_out = B;
  err = (int)cudaMemsetAsync(flags, 0, sizeof(int) * kFlags * (size_t)d, s);
  if (err) return err;
  void* args[] = {&x, &w, &bias, &y, &buf, &flags, &d, &B, &mc, &K, &N};
  err = (int)cudaLaunchCooperativeKernel((const void*)ring_kernel<T>,
                                         dim3(d * B), dim3(kThreads), args,
                                         smem, s);
  if (err) return err;
  return (int)cudaGetLastError();
}

// One cooperative launch of ring_rank_kernel<T> (see ternary_ring_rank):
// the rank's B blocks as many as the card holds, at most one a tile.
template <class T>
int launch_rank(Ring g, unsigned epoch, int d, int r, int mc, int K, int NL,
                int* blocks_out, cudaStream_t s) {
  const int smem = tile_smem<T>();
  int B = 0;
  int err = resident_blocks(ring_rank_kernel<T>, smem, &B);
  if (err) return err;
  const int tiles = ternary::cdiv(mc, T::BM) * ternary::cdiv(NL, T::BN);
  if (B > tiles) B = tiles;
  if (B < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks_out = B;
  void* args[] = {&g, &epoch, &d, &r, &mc, &K, &NL};
  err = (int)cudaLaunchCooperativeKernel((const void*)ring_rank_kernel<T>,
                                         dim3(B), dim3(kThreads), args, smem,
                                         s);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// The group mode. x (d*mc, K) f32, w (K, N) int8, bias (N,) f32, y (d*mc,
// N) f32, buf (d, 2, mc, K) f32 scratch, flags (5*d,) int32 scratch;
// *blocks_out gets B, the blocks a rank.
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

// The rank mode: rank r of d. x (mc, K) f32 its chunk (16-byte aligned), w
// (K, NL) int8 its W columns, bias (NL,) f32, y (d*mc, NL) f32 its Y
// columns; mine / theirs the slots (2, mc, K) f32 of this rank and of its
// right neighbour (16-byte aligned), flags_me / flags_left / flags_right
// the flag blocks (5 int32) of this rank and its neighbours; epoch the
// blocks a rank that the communicator's earlier calls launched, modulo
// 2**32. *blocks_out gets B, the blocks of the launch: every rank must get
// the same, so the ranks run on cards of one model.
extern "C" int ternary_ring_rank(const float* x, const int8_t* w,
                                 const float* bias, float* y, float* mine,
                                 float* theirs, int* flags_me,
                                 const int* flags_left, int* flags_right,
                                 int d, int r, int mc, int K, int NL,
                                 unsigned epoch, int* blocks_out,
                                 void* stream) {
  if (d < 1 || r < 0 || r >= d || mc < 8 || mc % 8 || K < 1 || NL < 1)
    return (int)cudaErrorInvalidValue;
  Ring g;
  g.x = x; g.w = w; g.bias = bias; g.y = y;
  g.ldw = NL; g.ldy = NL;
  g.mine = mine; g.theirs = theirs;
  g.me = flags_me; g.left = flags_left; g.right = flags_right;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mc <= dmma::kNarrowMaxM)
    return launch_rank<dmma::Narrow>(g, epoch, d, r, mc, K, NL, blocks_out,
                                     s);
  return launch_rank<dmma::Wide>(g, epoch, d, r, mc, K, NL, blocks_out, s);
}

// A rank's IPC buffer (flags and slots), outside PyTorch's caching
// allocator so that its handle names exactly this allocation: cudaMalloc,
// zeroed, and the device synchronised, so that the zeros are in place
// before the handle is shared.
extern "C" int ternary_ipc_alloc(size_t bytes, void** ptr) {
  *ptr = nullptr;
  int err = (int)cudaMalloc(ptr, bytes);
  if (!err) err = (int)cudaMemset(*ptr, 0, bytes);
  if (!err) err = (int)cudaDeviceSynchronize();
  return err;
}

// The 64-byte cudaIpcMemHandle_t of ptr (a ternary_ipc_alloc pointer).
extern "C" int ternary_ipc_handle(void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  const int err = (int)cudaIpcGetMemHandle(&h, ptr);
  if (!err) std::memcpy(handle, &h, sizeof(h));
  return err;
}

// Map another process's buffer into this one (once a handle a process; a
// process never opens its own).
extern "C" int ternary_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  *ptr = nullptr;
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int ternary_ipc_close(void* ptr) {
  return (int)cudaIpcCloseMemHandle(ptr);
}

extern "C" int ternary_ipc_free(void* ptr) { return (int)cudaFree(ptr); }
