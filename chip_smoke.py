#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

Run from the repository root on a machine with a card::

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line if any fails, or if no GPU is visible):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. the build: ``csrc/*.cu`` compiled with nvcc for sm_90a
   (``ternary_spgemm_tpu_torch/ops/_build.py``);
3. every kernel of the path against its plain PyTorch version on the card,
   at the BitNet-7B path shapes (d=4096, ff=11008): the x8 kernel on the
   merged QKV (4096 -> 12288) and wo (4096 -> 4096) at M in {4, 256, 512}
   (decode, and the serve's 4 x 128-token prefill) and at M =
   ``X8_MMA_MIN_M`` and one more row (the two sides of its split between
   the decode and the tensor-core branch), the i8 kernel at the north star
   32x1024x4096 and at 32x4096x11008 (gn=3), both bitwise equal with PReLU
   on and off and a random bias and slope per column; the x8 kernel's
   crossover: both branches, each bitwise, timed on the merged QKV at M in
   {4, 8, 16, 32, 48, 64, 128}; the i8 kernel's two branches bitwise at every
   phase-6 shape, PReLU on and off, on integer X with the +-512 edges and
   on non-integer X, and its crossover: both timed, each bitwise, at the
   north star and 32x4096x11008's K and N for M in {4, 8, 16, 32, 48, 64,
   128, 512}; the x8 and i8 decode body (``csrc/gemv_core.cuh``): both kernels'
   branches bitwise on random plane bytes (pos and neg both set in
   places; tile_n 4096, 96 and 30, M in {1, 4, 7, 16, 33}, PReLU on and
   off), the body's split-K parts S swept at the merged QKV and wo (M = 4)
   and at 4096 -> 11008 (M = 4, 16), each S bitwise, beside the rule's
   choice (``fused_ffn.gemv_parts``), and the kernels a call of each
   branch launches (``torch.profiler``: one for the decode body); the
   SwiGLU kernel at M in {4, 128, 512} (its two branches' y, h
   and rmax bitwise equal; at most 1e-4 of the requantized hidden values
   may flip against the plain version, each by 1, and every row without a
   flip agrees within rtol=1e-5, atol=0.01) and its crossover: both
   branches timed, bitwise equal to each other, at M in {4, 8, 16, 32, 64,
   128}; the SwiGLU's decode branch, a split walk, at M in {1, 4}: y, h
   and rmax bitwise equal to the tensor-core branch for the rule's parts
   (``fused_ffn.split_parts``) and for every other count of parts timed,
   each phase's parts swept with the other phase unsplit; the PReLU
   FFN kernel (both phases on ``csrc/gemv_core.cuh``) at the ffn_bench
   blocks (M = 32, 1024 -> 4096 -> 1024 and 2048 -> 4096 -> 2048) and at M
   in {1, 33, 128}, PReLU2 off and on, with a random bias and slope per
   column, its hidden state, requantized hidden values and output bitwise
   equal, each phase's parts (``fused_ffn.gemv_parts``) printed beside its
   time, and at M = 32 each phase's parts swept with the other at the
   rule's, each bitwise. Median
   times from CUDA events, with a 1 GiB buffer written between launches
   so that the weights come from device memory as they do in serving (and
   the card, writing it for ~0.3 ms, stays behind the host, so that no
   wrapper's host path lands between the events: the decode body's calls
   take less device time than their host path);
   beside each, two yardsticks: ``library_ms``, one ``torch.matmul`` of the
   staged X by the dense f32 W decoded beforehand (TF32 off; none for the
   fused SwiGLU), and ``bound_ms``, the least time the card could take: the
   larger of the bytes (weights, f32 X and Y, bias; for an ELL container
   one byte a nonzero plus its cap tables) at 3.35 TB/s and the operations
   the product needs (2*M*nnz: a zero weight needs none) at 1,979 TOP/s,
   the int8 peak, with which of the two bounds it;
4. whole-model parity: a small model (2 layers, d=256, 4 heads, ff=512,
   vocab 64) from a numpy-seeded parameter tree in the shape of the JAX
   ``BitTransformerLM.init``, built once, one copy on the CPU (plain
   versions) and one on the card (kernels): identical greedy tokens, prefill
   logits within rtol=atol=1e-4;
5. the serving path, counted: the headline SpMM through ``ternary_spgemm``'s
   default dispatch at the north star, then BitNet-7B width (all 32 layers,
   random ternary weights from a seed, built on the card) serving 4
   requests of 128 prompt tokens each, greedy-decoding 32 new tokens each
   through ``generate`` with an int8 KV cache. The launch counters must
   match the path (x8 twice and the SwiGLU once per layer per forward, the
   x8 kernel's tensor-core branch twice and the SwiGLU's once per layer in
   the prefill and never in decode, so the decode steps' x8 launches are
   all on the decode body; i8 on the headline op, on its
   tensor-core branch when its 32 rows are above ``I8_MMA_MIN_M``) and no
   plain version may run on a CUDA tensor. That counted run is the eager
   loop (``graph=False``); then the captured loop (``models/graphs.py``,
   ``generate``'s default on the card) on the same prompt: tokens
   identical to the eager loop's, the launches counted while its decode
   step was captured equal to one eager decode step's (x8 twice on the
   decode body and the SwiGLU once a layer, nothing on the tensor cores)
   and its prefill capture's to the eager prefill's; a sampled run
   (temperature 0.8, top-k 50, top-p 0.95, one seed) captured and eager,
   token for token; eager and captured prefill (tokens/s) and decode
   (ms a step) timed in the order eager, graph, graph, eager, and each
   loop's ``max_memory_allocated``, beside the card's name and power limit;
5b. the rest of the serving path on phase 5's LM, each part counted:
   (a) ``save_lm_bundle`` of the full-depth LM into a temporary directory
   (the JAX package's bundle format; the merged QKV's wq / wk / wv
   derived), ``load_lm_bundle`` onto the card: every tensor and setting
   equal, the loaded LM's captured greedy tokens phase 5's, its warm-ups'
   and captures' launches one prefill's and one step's (each three
   times), and its captured decode ms a step beside the original's; (b)
   a 512-token prompt, batch 4, prefilled whole and by
   ``chunked_prefill`` at chunks of 8 (32 rows: x8 on the decode body), 9
   (36 rows: x8 on the tensor cores) and 128: the same next greedy
   token, each call's kernels on the branch its rows select, tokens/s,
   peak memory and the last logits' max |diff| against unchunked; (c)
   phase 5's blocks as a window-128 model, a 64-token prompt and 192 new
   tokens: ``generate(ring=True)`` gives the full cache's tokens, eager
   and captured, each cache's bytes and captured decode ms a step; (d) phase 5's blocks with a bf16
   embedding: f32 logits, the head within rtol=atol=0.05 of the f32 head
   on the same hidden states, the whole model's logits against the f32
   head's, the greedy tokens that agree and each head's captured decode
   ms a step;
6. every other hand-written SpMM kernel of the registry (bf16 bitplane,
   nibble-pair i8, tiled-dense i8 and x8, dense f32, bf16 and i8,
   block-packed and tiled block-packed i8 at factor 4 and 5, stride-packed
   f32 and i8 at factor 4 and 5, ELL deposit i8, tiled ELL and blocked ELL
   f32) against its plain version on the card, at the north star
   32x1024x4096 (s=4), at the BitNet-7B up-projection 32x4096x11008 (s=2,
   several N-tiles), at the large-M 512x4096x4096 (s=2) and at a ragged
   7x999x1000 (s=3; K not a multiple of 4, 5, 8, 127, 128, 248 or a block,
   N not of 32 or 128): bitwise equal on integer X in each kernel's domain
   with PReLU on and off, and on non-integer X (uniform in +-2) within
   rtol=1e-5, atol=1e-3 (the x8 and i8 rules round or floor it as the plain
   versions do; the f32 and bf16 kernels sum it in another order than the
   plain matmul; each shape's max |diff| there is printed); the
   yardsticks of phase 3 for every kernel at every shape; then the
   kernels on ``csrc/dense_mma.cuh``'s bf16 tensor-core tile
   (``DENSE_KERNELS``: dense f32 and bf16, the int8-X tiled-dense, dense,
   block-packed, tiled block-packed and stride-packed ones, the f32
   stride-packed ones, the bf16 bitplane one and the nibble-pair one)
   timed, each bitwise on
   integer X, at M in ``DENSE_ROWS`` at the
   north star's K and N (``phase_dense_rows``, which also runs against a
   parent tree's package to time the bodies the tile replaced);
7. the benchmark entry point, counted: ``python -m ternary_spgemm_tpu_torch
   -M 32 -K 1024 -N 4096 -s 4 -correctness`` with PReLU off and on
   (in-process, ``__main__.main``): all 31 kernels, a counterpart of each
   of the JAX registry's, correct (the hand-written ones and the torch
   ops: BaseTCSC, BaseTCSR, BlockedTCSC, InterleavedTCSC,
   InterleavedBlockedTCSC, EllTCSC, BlockedEllTCSC, DenseMXU*,
   PackedMXU_*, PackedCSC; the six formulations ported last each printed
   with its time, correct at abs 1e-5 on integer X), no ERROR line, each
   hand-written SpMM kernel launched and no plain version on a CUDA
   tensor; then the headline (``python -m
   ternary_spgemm_tpu_torch.bench.headline``) over all 19 of ``bench.py``'s
   default kernels, whose JSON line is printed, with the stacked
   marginal's ``stacked_*`` keys (``bench/stacked.py``: 8 and 16 chained
   ``CudaTiledBitplane_i8`` layers, each chain one CUDA graph) and no
   ``stacked_error``;
8. the FFN-block benchmark, counted: ``python -m
   ternary_spgemm_tpu_torch.tools.ffn_bench`` in-process at its default
   blocks (two PReLU, four SwiGLU, the JAX tool's): every row correct, both
   fused kernels launched, no plain version on a CUDA tensor;
9. the probes: the stream kernel (every geometry of the membench sweep
   below and a small tile; timed at 512 MB), the decode-rate kernel
   (random and all-ones X, one block and one an SM) and every rung of the
   deposit ladder (each of deposit_study's three configs and a ragged
   shape) bitwise against their plain versions, the decode-rate kernel's
   one-SM time beside its bound (its ``__dp4a`` at one SM's integer rate,
   ``SM_DP4A_PER_S``); then, counted,
   ``tools.membench`` over 16/64/256/512 MB x two tiles x both layouts (no
   config recorded as failed, no rate above 1.05 x 3.35 TB/s: the L2 flush
   holds at 16 MB), ``tools.decode_roofline`` at its four configs (both
   branches of the i8 kernel, a roofline row each) and
   ``tools.deposit_study`` (bytes audit and ladder; full and staticcap
   exact), each in-process, no plain version on a CUDA tensor;
10. the ragged probe: the scalar-deposit kernel's tile bitwise equal to its
    plain version at 4096 entries (the probe's, seed 0) and 65,536, its
    entries/s beside its latency bound (4096 dependent shared-memory
    read-modify-writes on one thread, each at least ``SMEM_RMW_CYCLES``,
    a shared-memory load's and a dependent integer op's latency, at the SM
    clock read under load); then, counted, ``tools.ragged_probe`` in-process: both
    ``CudaTiledBitplane_i8`` and ``CudaEllDeposit_i8`` launched on each of
    its six configs (M = 32, K = N in {4096, 11008}, s in {16, 32, 64}), no
    row with an error, no plain version on a CUDA tensor;
11. the ring all-gather SpMM: one cooperative launch for the whole ring at
    ranks in {2, 4, 8}, at the JAX test's shape (K=64, NL=128, mc=8) and at
    full width (M = 512, the serve's 4 x 128 prefill rows; K = 4096, N =
    12288, BitNet-7B's merged QKV): bitwise equal to the plain schedule on
    integer X from ``generate_x`` (every partial sum an integer below
    2**24), within rtol=1e-5, atol=1e-3 on non-integer X, and the same Y
    over 20 back-to-back launches, with a seeded integer bias that differs
    from column to column; timed at full width beside ``library_ms`` and
    ``bound_ms`` (the card's route to an exact f32 product of ternary
    weights: three bf16 tensor-core passes, 6*M*nnz operations at 989
    TFLOP/s); then, counted, the entry point
    ``parallel.ring_allgather_spgemm`` at each ranks, one launch a call,
    equal to ``X @ W + b``;
12. the serving tool (``tools/serving_bench.py``) in-process at bitnet3b,
    full depth (26 layers, d=3200, 32 heads of 100, ff=8640, vocab 32000:
    K pads to 4096 rows on QKV, wo, gate and up and 8640 to 9216 on down),
    batch 4, the preset's 512-token prompt and 64 new tokens, A8, int8
    cache, captured, each run counted: with both fast paths, with none,
    and with both and 8 K/V heads. Each prints prefill tokens/s, decode ms
    a step, one step, block and head ms, peak memory, the FFN branch the
    JAX rule picks (the fused SwiGLU at bitnet3b; launched or not, as the
    variant says) and the kernels it launched; no plain version on a CUDA
    tensor. The greedy tokens of the fused and the unfused variant are set
    side by side (the JAX tests hold the two block by block, not as
    tokens of a deep model), and the fast paths are taken apart on one
    bitnet3b block at 4 and 512 rows: the merged QKV against wq, wk and wv,
    the fused FFN against its three linears, and the block with each fast
    path alone against the block with none, at the JAX tests' tolerance,
    naming the fast path the block's divergence follows;
13. autotune: ``ternary_spgemm(kernel="auto")`` at the north star over
    TiledBitplane and BlockedEllTCSC (each candidate's time and the
    winner printed; the result equal to ``X @ W + b``), then
    ``autotune_serving_flags`` at bitnet3b, 4 rows, with a cache file
    under ``build/``, and a second call that the file answers without a
    probe; any candidate that raised fails the phase;
14. training, counted: (a) QAT at bitnet3b's widths, the depth cut from 26
    to 4 layers, a fixed batch of 4 x 512 seeded tokens: 3 steps of
    ``make_lm_train_step`` with ``torch.optim.Adam(lr=1e-3)`` (every loss
    finite, the third below the first), then from the same parameters 3
    steps with ``remat=True`` (the first step's loss within 1e-5 relative
    of the plain one's) and 3 with ``compute_dtype="bfloat16"`` (within
    5%); for each the ms of the two steps after the first (CUDA events),
    the peak memory and the peak above what was resident when they began;
    one plain step traced (``torch.profiler``, device time by aten op);
    (b) block 0 of the trained
    tree exported A8 into TiledBitplane with its transposed containers, no
    fast paths, ``(block(x)**2).sum()`` backpropagated to x at 4 rows and
    at 2048: each backward SpMM (the x8 kernel on ``fmt_t``, decode body at
    4 rows, tensor cores at 2048) bitwise equal to the f32 product of its
    integer-valued cotangent by the decoded ``Wq^T``, the 4-row x grad
    against the same block on the CPU (plain versions) within rtol=atol=
    2e-3, the 2048-row one against an f32 dense mirror of the A8 block
    (exact cotangent) within 5e-2 relative L2, its share of elements
    within 1% printed; (c) the exact path: 3 ``make_train_step`` (mse)
    steps of ``TernaryMLP([1024, 4096, 1024])``, exported into DenseTernary
    as ``ExportedMLP``, its x, bias and slope grads at 32 and 2048 rows
    against f32 dense autodiff at rtol=1e-4, atol=1e-3, on the PReLU
    branch the kernels' forward took (the pre-activations on the other side
    of 0 in the dense forward counted). The wrappers' launches in one
    backward of (b) and of (c) counted (one a linear, the x8 kernel's
    ``/mma`` too at 2048 rows; one ``CudaDense`` a dense layer), and the
    kernels a launch runs named by ``torch.profiler`` (x8's decode body,
    or its pre-pass and ``mma.sync``; the dense tile), with the trace's
    kernel records against its launch calls;
15. the MoE FFN, counted, at bitnet3b's widths with 8 experts routed top
    2 and a capacity factor of 4 (C = S: no token dropped): (a) QAT, the
    depth cut to 2 layers, 3 ``make_lm_train_step`` Adam steps on one
    seeded 4 x 256 batch (losses finite and falling, the balance loss
    finite before and after), ms a step and peak memory; (b) the trained
    tree exported into DenseTernary (``ExportedTransformerLM.from_params``,
    the dense kernel): its full forward within rtol=atol=1e-5 of the QAT
    forward, its prefill and 4 decode steps within 2e-4 of ``lm_prefill``
    / ``lm_decode_step``, 28 dense launches a layer a forward; (c) a fresh
    4-layer model exported A8 over TiledBitplane with the merged QKV,
    serving 4 requests of 128 prompt tokens, 32 new, greedy, int8 cache:
    the captured tokens the eager loop's, 26 x8 launches a layer a decode
    step (the merged QKV, wo and 8 x 3 experts, all on the decode body) and
    each capture's launches one eager prefill's and step's, E G G E
    prefill tokens/s and decode ms a step, peak memory; then one expert's
    gate (3200 -> 8640) on the x8 kernel at 4 and 512 rows bitwise its
    plain version, beside ``library_ms`` and ``bound_ms``;
16. the parallel layer (``parallel/``, the sharded train step and
    checkpoints) on one card: (a) an NCCL group of one rank on a TCP
    store at 127.0.0.1, ``make_mesh({"model": 1})`` on ``cuda``; counted,
    at bitnet7b widths (d 4096, ff 11008): the column-sharded x8 merged
    QKV (4 x 4096 -> 12288), the row-sharded x8 wo (4096 -> 4096, with
    and without ``scatter_output``), ``overlapped_gather_spgemm`` at 512
    rows and ``tensor_parallel_fused_swiglu`` (gate and up at tile_n 128,
    down at tkb 16) at 4 and 512 rows, each bitwise the single-device call
    (as is the column scheme over ``container_from_local_shard``), their
    launches exactly x8 4 (1 on the tensor cores) and the SwiGLU 2 (1),
    each scheme's ms beside the single call's; then
    ``make_sharded_lm_train_step`` with sequence parallelism and ZeRO-1
    on a data 1 x model 1 mesh at phase 14's configuration, 3 steps from
    the parameters of 3 unsharded steps in the same call: losses within
    rtol 1e-5, the ms of steps 2-3 of each; its parameters saved with
    ``save_sharded_pytree`` and restored byte-equal; the same step pair
    over MoE blocks at phase 15's training configuration (losses within
    rtol 1e-5); (b) the shard shapes
    of d-way splits rank by rank in this process, at 4 and 512 rows: the
    QKV by columns over 4 (3072 columns a rank, tile_n 3072), wo by rows
    over 4 (1024 rows), the SwiGLU FFN over 2 (5504 hidden, down at tkb
    16): each rank's call bitwise its plain version (the SwiGLU by phase
    3's rule), the columns assembled bitwise the unsharded kernel, the
    wo partials summed in rank order plus the bias bitwise it (integer
    X), the FFN shards' sum bitwise the per-shard plain reference where no
    hq value flips and by phase 3's rule on the rows with none where some
    do; each rank's ms and ``bound_ms`` beside the unsharded
    call's, with the card's name and power limit. Collectives between
    cards are not measured (one card).

Each phase's seconds are printed as it ends, and all of them before the
last lines.

The hand-written kernels, their CUDA sources and plain versions come from
the registry (``KernelSpec.source``, ``KernelSpec.plain``), the fused FFNs'
module (``ops/fused_ffn.py``), the study tools' modules
(``tools/membench.py``, ``decode_roofline.py``, ``deposit_study.py``,
``ragged_probe.py``) and ``parallel/ring_kernel.py``; phase 16 adds none
(its schemes run the x8 and SwiGLU kernels on shards).

The last lines are the headline JSON, the kernels JSON (the x8 kernel's
entry: its decode figures at M = 4 and a ``prefill`` object for the merged
QKV at M = 512, ``moe`` and ``moe_prefill`` objects for an expert's gate
at 4 and 512 rows; the SwiGLU's: M = 4 and a ``prefill`` object at M = 512;
the i8 kernel's: the north star and a ``u`` object at 32x4096x11008;
phase 6's: the north star, ``u`` and an ``l`` object at 512x4096x4096, the
block-packed ones at factor 4), the card line, and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
#: the serve path's SpMM kernels, which phase 3 holds at the serving shapes
#: and phase 5 counts; phase 6 takes every other hand-written SpMM kernel of
#: the registry, so a new kernel needs no entry here
SERVE_KERNELS = ("CudaTiledBitplane_x8", "CudaTiledBitplane_i8")
#: phase 6 shapes (M, K, N, s), held for every kernel: the north star, the
#: BitNet-7B up-projection (three N-tiles), the large-M shape, and a ragged
#: one (K not a multiple of 4, 8 or a block, N not of 32)
BENCH_SHAPES = [(32, 1024, 4096, 4), (32, 4096, 11008, 2),
                (512, 4096, 4096, 2), (7, 999, 1000, 3)]
#: the H100 SXM's device-memory rate at its 700 W limit (NVIDIA's data
#: sheet); its int8 peak is the port's ``bench.instrument.INT8_OPS_PER_S``
HBM_BYTES_PER_S = 3.35e12
#: the H100 SXM's f32 rate outside the tensor cores at 700 W (NVIDIA's data
#: sheet): phase 11 prints the ring's bound at it too (2*M*nnz), the bound
#: of its CUDA-core products before they went to the tensor cores
F32_FLOPS_PER_S = 67e12
#: the H100 SXM's dense bf16 tensor-core rate at 700 W (NVIDIA's data
#: sheet): the card's route to an exact f32 product of ternary weights is
#: three bf16 passes (f32 X split into three exact bf16 pieces), so the
#: ring's bound (phase 11) counts 6*M*nnz operations at this rate
BF16_FLOPS_PER_S = 989e12
#: bf16 passes of an exact f32 product (``ops.cuda_kernels.split_bf16``)
F32_BF16_PASSES = 3
#: one H100 SM's __dp4a rate, assumed: 64 a clock, the CUDA C++
#: Programming Guide's arithmetic-instruction throughput for compute
#: capability 9.0 for 32-bit integer multiply-add (the guide's table has no
#: __dp4a row, so that __dp4a issues at this rate is an assumption, not a
#: cited figure), at the H100 SXM's 1,980 MHz boost clock (NVIDIA's data
#: sheet); phase 9 bounds the decode-rate probe by it and prints the
#: probe's own rate at one SM and at all SMs, which reads below it
SM_DP4A_PER_S = 64 * 1.98e9
#: phase 3's sweep of the PReLU FFN's parts at M = 32, 1024 -> 4096 ->
#: 1024: each phase's S with the other at the rule's
FFN_SPLIT_S = (1, 2, 4, 8, 16)
#: phase 6's dense rows: the M at which the kernels on dense_mma.cuh's
#: tile (``DENSE_KERNELS``) are timed at the north star's K and N
DENSE_ROWS = (1, 4, 7, 16, 32, 512)
#: the kernels on dense_mma.cuh's bf16 tensor-core tile, which phase 6
#: times at ``DENSE_ROWS``: the dense f32 and bf16 kernels, the int8-X
#: kernels over the packed-row containers (the block-packed ones at factor
#: 4 and 5), the f32 stride-packed ones, the bf16 bitplane one and the
#: nibble-pair one
DENSE_KERNELS = ("CudaDense", "CudaDense_bf16", "CudaTiledDense_i8",
                 "CudaTiledDense_x8", "CudaDense_i8", "CudaBlockPacked_i8",
                 "CudaTiledBlockPacked_i8", "CudaPacked2Bit_i8",
                 "CudaPacked53_i8", "CudaPacked2Bit", "CudaPacked53",
                 "CudaTiledBitplane_bf16", "CudaTiledNibblePair_i8")
#: phase 3's x8 crossover: the M at which both branches are timed on the
#: merged QKV
X8_CROSSOVER_M = (4, 8, 16, 32, 48, 64, 128)
#: phase 3's i8 crossover: the M at which both branches are timed at the
#: north star (K = 1024) and the up-projection (K = 4096)
I8_CROSSOVER_M = (4, 8, 16, 32, 48, 64, 128, 512)
#: phase 3's sweep of the x8 and i8 decode body's parts S (``gemv_core.cuh``;
#: each within what the walk allows): (kernel, M, K, N) at the merged QKV
#: and wo at decode's M = 4, and the up-projection's K and N at M = 4, 16
GEMV_SPLIT_CASES = (("x8", 4, 4096, 12288), ("x8", 4, 4096, 4096),
                    ("i8", 4, 4096, 11008), ("i8", 16, 4096, 11008))
GEMV_SPLIT_S = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)
#: phase 3's SwiGLU crossover: the M at which both branches are timed at
#: 4096 -> 11008 -> 4096
SWIGLU_CROSSOVER_M = (4, 8, 16, 32, 64, 128)
#: phase 3's SwiGLU split walk: the decode M at which its parts are timed,
#: and the parts swept for gate and up (S1, a walk of 16 chunks at 7B width)
#: and for down (S2, 44 chunks), the other phase unsplit
SWIGLU_SPLIT_M = (1, 4)
SWIGLU_SPLIT_S1 = (1, 2, 3, 4, 6, 8, 16)
SWIGLU_SPLIT_S2 = (1, 2, 4, 6, 8, 11, 16, 22, 44)
#: phase 11's ring sizes, at the JAX test's shape and at full width, and
#: the full width (M, K, N): the serve's 4 x 128 prefill rows through
#: BitNet-7B's merged QKV
RING_RANKS = (2, 4, 8)
RING_FULL = (512, 4096, 12288)
#: phase 5b's long prompt (the JAX serving tool's T0, which phase 5 cuts to
#: 128) and its chunks: 8 (32 rows, up to ``X8_MMA_MIN_M``: the x8 decode
#: body), 9 (36 rows: its tensor cores) and 128
LONG_T0 = 512
LONG_CHUNKS = (8, 9, 128)
#: phase 5b's ring: the window, prompt and new tokens (the generation runs
#: past the window, so the ring wraps) and the layers it runs
RING_WINDOW, RING_T0, RING_NEW, RING_LAYERS = 128, 64, 192, 32
#: phase 5b's bf16 head against the f32 head (the JAX package's own
#: tolerance, ``tests/test_decode.py``)
BF16_HEAD_TOL = 0.05
#: phase 10's latency bound of the ragged probe's chain: the cycles of one
#: dependent shared-memory read-modify-write on one thread, a shared-memory
#: load's latency (19 cycles) and a dependent integer op's (4), the figures
#: Jia et al. measured on Volta ("Dissecting the NVIDIA Volta GPU
#: Architecture via Microbenchmarking", arXiv:1804.06826); that Hopper's
#: are no shorter is an assumption. The bound is 4096 entries of it at the
#: SM clock read under load
SMEM_RMW_CYCLES = 19 + 4
#: phase 12's serving tool runs at bitnet3b (full depth, batch 4, the
#: preset's 512-token prompt and 64 new tokens, int8 cache, captured): the
#: fast paths both, none, and both with 8 shared K/V heads
SERVE_3B_ARGS = ["--preset", "bitnet3b", "--batch", "4", "--cache-dtype",
                 "int8", "--repeats", "2"]
SERVE_3B_VARIANTS = {"both": ["--fast-paths", "both"],
                     "none": ["--fast-paths", "none"],
                     "gqa8": ["--fast-paths", "both", "--kv-heads", "8"]}
#: the JAX package's tolerances for a block with and without the fast
#: paths (``tests/test_fused_ffn.py``: the merged QKV rtol=1e-5, atol=1e-4,
#: the fused FFN rtol=atol=1e-5): phase 12 reads a bitnet3b block's parts at
#: them
FUSED_BLOCK_TOL = dict(rtol=1e-5, atol=1e-4)
#: phase 7's six torch-op formulations of the last XLA kernels
XLA_FORMULATIONS = ("BaseTCSR", "BlockedTCSC", "InterleavedTCSC",
                    "InterleavedBlockedTCSC", "EllTCSC", "PackedCSC")
#: the stacked marginal's keys in the headline (``bench/stacked.py``)
STACKED_KEYS = ("stacked_marginal_seconds", "stacked_spread",
                "stacked_depths", "stacked_gflops",
                "stacked_roofline_fraction", "stacked_kernel")
#: phase 14's QAT model: bitnet3b's widths, its depth cut from 26 layers to
#: 4; a batch of 4 x 512 tokens; Adam at lr 1e-3
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_T = 4, 512
TRAIN_LR = 1e-3
#: phase 14 (a): the remat step's loss against the plain step's (relative),
#: the bf16 step's (the JAX test's 0.05)
REMAT_TOL, BF16_LOSS_TOL = 1e-5, 0.05
#: phase 14 (b): the rows a bitnet3b block backpropagates at (decode's 4,
#: the batch's 2048), the tolerance of the 4-row x grad against the same
#: block on the CPU (the CPU tests' block tolerance), and the bound on the
#: relative L2 error of the 2048-row x grad against the f32 dense mirror
#: (an exact, unquantized cotangent), stated in PERF.md before the run
TRAIN_BLOCK_ROWS = ((1, 4), (TRAIN_BATCH, TRAIN_T))
BLOCK_CPU_TOL = dict(rtol=2e-3, atol=2e-3)
MIRROR_REL_L2 = 5e-2
#: phase 14 (c): the exact path, a TernaryMLP at the PReLU FFN's shapes,
#: exported into DenseTernary; its grads at these rows, against f32 dense
#: autodiff at the JAX test's tolerance (``tests/test_models.py:149``)
TRAIN_MLP = (1024, 4096, 1024)
TRAIN_MLP_ROWS = (32, 2048)
EXACT_GRAD_TOL = dict(rtol=1e-4, atol=1e-3)
#: phase 15's MoE configuration: bitnet3b's widths with Mixtral's expert
#: count and routing (8 experts, top 2, arXiv:2401.04088) and a capacity
#: factor of E / top_k, which makes C = S: no token is dropped, so the
#: prefill equals stepwise decode. Its QAT model keeps 2 of the 26 layers
#: (~1.5 G parameters: with grads, Adam's moments and the STE weights ~35
#: GiB), its serve 4; the batches: 4 x 256 tokens for training, 4 requests
#: of 128 prompt tokens and 32 new for the serve
MOE_EXPERTS, MOE_TOP_K, MOE_CAPACITY = 8, 2, 4.0
MOE_TRAIN_LAYERS, MOE_SERVE_LAYERS = 2, 4
MOE_TRAIN_BATCH, MOE_TRAIN_T = 4, 256
MOE_SERVE_B, MOE_SERVE_T0, MOE_SERVE_NEW = 4, 128, 32
#: phase 15 (b): the exact export's full forward against the QAT forward
#: (``tests/test_moe.py:170-182``), its prefill and decode steps against
#: the QAT backend's (``tests/test_decode.py:110-125``)
MOE_EXPORT_TOL = dict(rtol=1e-5, atol=1e-5)
MOE_DECODE_TOL = dict(rtol=2e-4, atol=2e-4)
#: phase 16: the parallel layer on one card at bitnet7b's widths
#: (``models/serving.py`` ``PRESETS["bitnet7b"]``: d 4096, ff 11008), at
#: decode's 4 rows and the prefill's 512; (b)'s d-way splits, rank by rank:
#: the merged QKV by columns over 4 (3072 columns a rank, one storage tile
#: a rank), wo by rows over 4 (1024 rows a rank, one K-block), the SwiGLU
#: FFN over 2 (5504 hidden a rank: gate and up at tile_n 128, 43 tiles a
#: rank; down at tkb 16, 128-row K-blocks: 5504 is no multiple of 1024).
#: The FFN's containers at tile_n 128 and tkb 16 in (a) too: its width at
#: the default tile (4096) pads 11008 to 12288, which JAX's TP check
#: refuses at any d
PAR_ROWS = (4, 512)
PAR_QKV_D = 4
PAR_WO_D = 4
PAR_FFN_D, PAR_FFN_TILE, PAR_FFN_TKB = 2, 128, 16
#: phase 16 (a): the sharded train step's losses against the unsharded
#: step's from the same parameters (relative)
PAR_TRAIN_TOL = 1e-5
#: phase 9's membench sweep (MB, tiles; both layouts): every geometry it
#: times is first held against the plain version
SWEEP_SIZES_MB = (16, 64, 256, 512)
SWEEP_TILES = ((256, 4096), (512, 4096))


def _is_ell(fmt) -> bool:
    from ternary_spgemm_tpu_torch.formats import (
        BlockedEllTCSC, TiledEllDeposit, TiledEllTCSC)

    return isinstance(fmt, (BlockedEllTCSC, TiledEllDeposit, TiledEllTCSC))


def weight_bytes(fmt) -> int:
    """The weight bytes a kernel over ``fmt`` must read once, for the K x N
    weights alone: a container's padding of K to its blocks and of N to its
    tiles is never read. For an ELL container one byte a nonzero plus the
    cap tables (the slots the nonzeros need, not the cap padding); for the
    others each column's K rows at the container's density: one byte a row
    (the int8 containers), one byte a group of ``factor`` rows (the packed
    codes), and for each group of 8 rows two bytes (the bit planes) or four
    (the nibble-pair words)."""
    from ternary_spgemm_tpu_torch.formats import (
        TiledBitplane, TiledNibblePair)

    if _is_ell(fmt):
        return fmt.nnz + sum(4 * t.numel() for n, t in fmt.arrays().items()
                             if "cap" in n)
    K, N = fmt.shape
    if isinstance(fmt, (TiledBitplane, TiledNibblePair)):
        return (2 if isinstance(fmt, TiledBitplane) else 4) * -(-K // 8) * N
    rows = getattr(fmt, "factor", None) or getattr(fmt, "FACTOR", 1)
    return -(-K // rows) * N


def spmm_ops(M: int, fmt) -> int:
    """Operations that Y = X.W over ``fmt`` needs: a multiply-add for each
    nonzero weight and row of X, 2*M*nnz (a zero weight needs none, whether
    or not a kernel skips it)."""
    return 2 * M * fmt.nnz


def bound(nbytes: int, ops: int, ops_per_s: float = None):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of ``nbytes`` at the memory rate and ``ops`` at ``ops_per_s`` (default
    the int8 peak)."""
    from ternary_spgemm_tpu_torch.bench.instrument import INT8_OPS_PER_S

    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (ops_per_s or INT8_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def spmm_bound(M: int, fmt):
    """:func:`bound` of one SpMM call: the weights, f32 X and Y, the bias."""
    K, N = fmt.shape
    return bound(weight_bytes(fmt) + 4 * (M * K + M * N + N),
                 spmm_ops(M, fmt))


def library_ms(xs, fmt, flush) -> float:
    """The yardstick: one ``torch.matmul`` of the staged X ``xs`` by the
    container's dense f32 W, decoded before the timed region (TF32 off) —
    the PyTorch call that computes the same product; the port never calls
    it."""
    import torch

    from ternary_spgemm_tpu_torch.bench.timing import event_ms

    w = fmt.to_dense().to(torch.float32)
    return event_ms(lambda: torch.matmul(xs, w), flush=flush)


def spmm_kernels() -> dict:
    """The hand-written SpMM kernels, name -> ``KernelSpec``: every
    registered kernel with a CUDA source (the torch-op formulations of the
    JAX package's XLA kernels have none)."""
    from ternary_spgemm_tpu_torch.ops import all_kernels

    return {n: s for n, s in all_kernels().items() if s.source}


def factor_variants(spec) -> list:
    """The packer arguments phase 6 holds a kernel at: the block-packed
    containers at factor 4 and 5, every other container as it is."""
    if "factor" in spec.format_cls.__dataclass_fields__:
        return [{"factor": 4}, {"factor": 5}]
    return [{}]


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def phase_kernels(dev, card: str) -> dict:
    """Phase 3: each kernel against its plain version at the path shapes."""
    import torch

    from ternary_spgemm_tpu_torch.bench.timing import event_ms
    from ternary_spgemm_tpu_torch.formats import TiledBitplane
    from ternary_spgemm_tpu_torch.models.serving import random_ternary
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
    from ternary_spgemm_tpu_torch.ops import fused_ffn
    from ternary_spgemm_tpu_torch.ops.fused_ffn import (
        FFN_KERNEL_NAME, KERNEL_NAME, _swiglu_lanes, _swiglu_mma,
        requantize_rows, swiglu_launch, swiglu_plain)

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=dev)
    stats = {name: {"max_abs_err": 0.0} for name in (*SERVE_KERNELS,
                                                     KERNEL_NAME)}

    def fmt(K, N, s=2):
        return TiledBitplane.from_dense(random_ternary(K, N, s, gen, dev))

    def spmm_case(name, kern, plain, stage, M, K, N, *, s, x, record=None):
        f = fmt(K, N, s)
        # a bias and a PReLU slope per column, so that an epilogue that
        # indexes them by the wrong column shows
        b = 4.0 * torch.rand((N,), generator=gen, device=dev) - 2.0
        a = 0.25 * torch.rand((N,), generator=gen, device=dev)
        for alpha in (None, a):
            got = kern(x, f, b, alpha)
            want = plain(x, f, b, alpha)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"{name} {M}x{K}x{N} prelu={alpha is not None}: kernel != "
                  f"plain (max |diff| {float((got - want).abs().max())})")
            err = float((got - want).abs().max())
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        ms = event_ms(lambda: kern(x, f, b, None), flush=flush)
        pms = event_ms(lambda: plain(x, f, b, None), flush=flush)
        lms = library_ms(stage(x), f, flush)
        bms, by = spmm_bound(M, f)
        split = (ck.X8_MMA_MIN_M if name == "CudaTiledBitplane_x8"
                 else ck.I8_MMA_MIN_M)
        branch = (" (tensor-core branch)" if M > split
                  else " (decode branch)")
        print(f"kernel {name} {M}x{K}x{N}{branch}: bitwise equal (PReLU "
              f"on/off); {ms:.4f} ms vs plain {pms:.4f} ms, library "
              f"{lms:.4f} ms, bound {bms:.4f} ms ({by}) [{card}]", flush=True)
        if record is not None:
            record.update(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                          bound_by=by)

    x8 = stats["CudaTiledBitplane_x8"]
    x8["prefill"] = {}
    split = ck.X8_MMA_MIN_M
    for M in sorted({4, split, split + 1, 256, 512}):
        # A8 activations: floats that round and clamp to int8
        for K, N, what in ((4096, 12288, "qkv"), (4096, 4096, "wo")):
            x = 60.0 * torch.randn((M, K), generator=gen, device=dev)
            rec = {(4, "qkv"): x8, (512, "qkv"): x8["prefill"]}.get((M, what))
            spmm_case("CudaTiledBitplane_x8", ck.cuda_tiled_bitplane_x8_kernel,
                      ck.bitplane_x8_plain, ck.to_x8, M, K, N, s=2, x=x,
                      record=rec)
    phase_x8_crossover(dev, card, gen, flush)
    i8 = stats["CudaTiledBitplane_i8"]
    i8["u"] = {}
    for K, N, s in ((1024, 4096, 4), (4096, 11008, 2)):
        x = torch.randint(-512, 513, (32, K), generator=gen,
                          device=dev).to(torch.float32)
        spmm_case("CudaTiledBitplane_i8", ck.cuda_tiled_bitplane_i8_kernel,
                  ck.bitplane_i8_plain, ck.to_i8, 32, K, N, s=s, x=x,
                  record=i8 if K == 1024 else i8["u"])
    phase_i8_branches(dev, card, gen, flush)
    phase_gemv(dev, card, gen, flush)

    fg, fu, fd = fmt(4096, 11008), fmt(4096, 11008), fmt(11008, 4096)
    kw = dict(gamma_gate=0.03, gamma_up=0.03, gamma_down=0.03)
    for M in (4, 128, 512):
        x = torch.randn((M, 4096), generator=gen, device=dev)
        xq, sx = requantize_rows(x)
        # the two branches give the same bits (exact sums, one epilogue)
        lanes = _swiglu_lanes(xq, sx, fg, fu, fd, **kw)
        mma = _swiglu_mma(xq, sx, fg, fu, fd, **kw)
        torch.cuda.synchronize()
        for got, want, what in zip(mma, lanes, ("y", "h", "rmax")):
            check(torch.equal(got, want),
                  f"SwiGLU M={M}: the branches' {what} differ")
        del lanes, mma
        y, h, rmax = swiglu_launch(xq, sx, fg, fu, fd, **kw)
        want = swiglu_plain(xq, sx, fg, fu, fd, **kw)
        flips, n_hq, err, clean = swiglu_rule(
            y, want, h, rmax, xq, sx, fg, fu, f"SwiGLU M={M}", **kw)
        n_clean = int(clean.sum())
        stats[KERNEL_NAME]["max_abs_err"] = max(
            stats[KERNEL_NAME]["max_abs_err"], err)
        ms = event_ms(lambda: swiglu_launch(xq, sx, fg, fu, fd, **kw),
                      flush=flush)
        pms = event_ms(lambda: swiglu_plain(xq, sx, fg, fu, fd, **kw),
                       flush=flush)
        branch = ("tensor-core" if M > fused_ffn.SWIGLU_MMA_MIN_M
                  else "decode")
        print(f"kernel fused_bitplane_swiglu M={M} 4096->11008->4096 "
              f"({branch} branch; y, h and rmax of both branches bitwise "
              f"equal): {flips} of {n_hq} hq flips, max |err| "
              f"{err:.3g} in {n_clean}/{M} clean rows; {ms:.4f} ms "
              f"vs plain {pms:.4f} ms [{card}]", flush=True)
        # three planes, xq and y (M, 4096) f32, sx; gate, up and down
        # products; no single PyTorch call computes the fused FFN
        bms, by = bound(sum(weight_bytes(t) for t in (fg, fu, fd))
                        + 4 * (2 * M * 4096 + M),
                        sum(spmm_ops(M, t) for t in (fg, fu, fd)))
        print(f"  SwiGLU M={M} bound {bms:.4f} ms ({by})", flush=True)
        rec = dict(ms=ms, plain_ms=pms, library_ms=None, bound_ms=bms,
                   bound_by=by)
        if M == 4:
            stats[KERNEL_NAME].update(rec)
        elif M == 512:
            stats[KERNEL_NAME]["prefill"] = rec
    phase_swiglu_crossover(card, fg, fu, fd, kw, gen, flush)
    phase_swiglu_split(card, fg, fu, fd, kw, gen, flush)
    stats[FFN_KERNEL_NAME] = phase_prelu_ffn(dev, card, flush)
    del flush
    return stats


def phase_x8_crossover(dev, card: str, gen, flush) -> None:
    """Phase 3, the x8 kernel's split: both branches (the decode kernel and
    the tensor-core kernel) bitwise against the plain version and timed on
    the merged QKV at each ``X8_CROSSOVER_M``."""
    import torch

    from ternary_spgemm_tpu_torch.bench.timing import event_ms
    from ternary_spgemm_tpu_torch.formats import TiledBitplane
    from ternary_spgemm_tpu_torch.models.serving import random_ternary
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck

    K, N = 4096, 12288
    f = TiledBitplane.from_dense(random_ternary(K, N, 2, gen, dev))
    b = 4.0 * torch.rand((N,), generator=gen, device=dev) - 2.0
    rows = []
    for M in X8_CROSSOVER_M:
        x = 60.0 * torch.randn((M, K), generator=gen, device=dev)
        want = ck.bitplane_x8_plain(x, f, b)
        times = {}
        for branch, fn in (("decode", ck._bitplane_x8_lanes),
                           ("mma", ck._bitplane_x8_mma)):
            got = fn(x, f, b)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"x8 {branch} branch {M}x{K}x{N}: kernel != plain")
            times[branch] = event_ms(lambda: fn(x, f, b), flush=flush)
        rows.append(f"M={M} {times['decode']:.4f} vs {times['mma']:.4f} ms")
    print("x8 crossover on the merged QKV, decode vs tensor-core branch, "
          "both bitwise equal to plain: " + "; ".join(rows)
          + f" (X8_MMA_MIN_M = {ck.X8_MMA_MIN_M}) [{card}]", flush=True)


def phase_i8_branches(dev, card: str, gen, flush) -> None:
    """Phase 3, the i8 kernel's split: both branches (the decode kernel and
    the tensor-core kernel) bitwise against the plain version at every
    ``BENCH_SHAPES`` shape, PReLU on and off, on integer X in +-512 (its
    edges on every seventh column) and on non-integer X (floored); then
    both timed, each bitwise, at the north star and the up-projection at
    each ``I8_CROSSOVER_M``."""
    import torch

    from ternary_spgemm_tpu_torch.bench.timing import event_ms
    from ternary_spgemm_tpu_torch.formats import TiledBitplane
    from ternary_spgemm_tpu_torch.models.serving import random_ternary
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck

    branches = (("decode", ck._bitplane_i8_lanes),
                ("mma", ck._bitplane_i8_mma))
    fmts = {}
    for M, K, N, s in BENCH_SHAPES:
        f = fmts.setdefault((K, N), TiledBitplane.from_dense(
            random_ternary(K, N, s, gen, dev)))
        x = torch.randint(-512, 513, (M, K), generator=gen,
                          device=dev).to(torch.float32)
        x[:, ::7], x[:, 3::7] = 512.0, -512.0
        xf = 1024.0 * torch.rand((M, K), generator=gen, device=dev) - 512.0
        b = 4.0 * torch.rand((N,), generator=gen, device=dev) - 2.0
        a = 0.25 * torch.rand((N,), generator=gen, device=dev)
        for xx, what in ((x, "integer"), (xf, "non-integer")):
            for alpha in (None, a):
                want = ck.bitplane_i8_plain(xx, f, b, alpha)
                for branch, fn in branches:
                    got = fn(xx, f, b, alpha)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want),
                          f"i8 {branch} branch {M}x{K}x{N} {what} X prelu="
                          f"{alpha is not None}: kernel != plain")
    print(f"i8 branches: decode and tensor-core bitwise equal to plain at "
          f"{', '.join('x'.join(map(str, sh[:3])) for sh in BENCH_SHAPES)} "
          f"(integer X with the +-512 edges and non-integer X, PReLU "
          f"on/off) [{card}]", flush=True)
    for K, N in ((1024, 4096), (4096, 11008)):
        f, rows = fmts[(K, N)], []
        b = 4.0 * torch.rand((N,), generator=gen, device=dev) - 2.0
        for M in I8_CROSSOVER_M:
            x = torch.randint(-512, 513, (M, K), generator=gen,
                              device=dev).to(torch.float32)
            want = ck.bitplane_i8_plain(x, f, b)
            times = {}
            for branch, fn in branches:
                got = fn(x, f, b)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"i8 {branch} branch {M}x{K}x{N}: kernel != plain")
                times[branch] = event_ms(lambda: fn(x, f, b), flush=flush)
            rows.append(f"M={M} {times['decode']:.4f} vs {times['mma']:.4f} "
                        "ms")
        print(f"i8 crossover at Mx{K}x{N}, decode vs tensor-core branch, both "
              f"bitwise equal to plain: " + "; ".join(rows)
              + f" (I8_MMA_MIN_M = {ck.I8_MMA_MIN_M}) [{card}]", flush=True)


def phase_gemv(dev, card: str, gen, flush) -> None:
    """Phase 3, the x8 and i8 decode body (``csrc/gemv_core.cuh``): both
    kernels' two branches bitwise against the plain version on random plane
    bytes (pos and neg both set in places), PReLU on and off; the body's
    parts S swept at ``GEMV_SPLIT_CASES``, each S bitwise, beside the rule's
    choice (``ops.fused_ffn.gemv_parts``); and the kernels each branch's call
    launches, counted by ``torch.profiler``."""
    import dataclasses

    import torch

    from ternary_spgemm_tpu_torch.bench.timing import event_ms
    from ternary_spgemm_tpu_torch.formats import TiledBitplane
    from ternary_spgemm_tpu_torch.models.serving import random_ternary
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
    from ternary_spgemm_tpu_torch.ops import fused_ffn
    from ternary_spgemm_tpu_torch.tools.serve_trace import traced
    from ternary_spgemm_tpu_torch.utils.device import sm_count

    kernels = {
        "x8": (ck._bitplane_x8_lanes, ck._bitplane_x8_mma,
               ck.bitplane_x8_plain, 1),
        "i8": (ck._bitplane_i8_lanes, ck._bitplane_i8_mma,
               ck.bitplane_i8_plain, 2)}

    def x_for(rule, M, K):
        if rule == "x8":
            return 60.0 * torch.randn((M, K), generator=gen, device=dev)
        return torch.randint(-512, 513, (M, K), generator=gen,
                             device=dev).to(torch.float32)

    for K, N, tile_n in ((4096, 12288, 4096), (999, 1000, 96), (200, 77, 30)):
        f = TiledBitplane.from_dense(random_ternary(K, N, 2, gen, dev),
                                     tile_n=tile_n)
        f = dataclasses.replace(f, plane=torch.randint(
            0, 256, tuple(f.plane.shape), generator=gen, device=dev,
            dtype=torch.uint8))
        b = 4.0 * torch.rand((N,), generator=gen, device=dev) - 2.0
        a = 0.25 * torch.rand((N,), generator=gen, device=dev)
        for rule, (lanes, mma, plain, _) in kernels.items():
            for M in (1, 4, 7, 16, 33):
                x = x_for(rule, M, K)
                for alpha in (None, a):
                    want = plain(x, f, b, alpha)
                    for branch, fn in (("decode", lanes), ("mma", mma)):
                        got = fn(x, f, b, alpha)
                        torch.cuda.synchronize()
                        check(torch.equal(got, want),
                              f"{rule} {branch} branch on random plane bytes "
                              f"{M}x{K}x{N} prelu={alpha is not None}: "
                              f"kernel != plain")
    print("x8 and i8 on random plane bytes (pos and neg both set in places): "
          "decode and tensor-core branches bitwise equal to plain at "
          "Mx4096x12288, Mx999x1000 (tile_n 96) and Mx200x77 (tile_n 30, byte "
          f"loads), M in 1, 4, 7, 16, 33, PReLU on/off [{card}]", flush=True)

    sms = sm_count(dev)
    for rule, M, K, N in GEMV_SPLIT_CASES:
        lanes, _, plain, planes = kernels[rule]
        f = TiledBitplane.from_dense(random_ternary(K, N, 2, gen, dev))
        b = 4.0 * torch.rand((N,), generator=gen, device=dev) - 2.0
        x = x_for(rule, M, K)
        nb = f.plane.shape[0]
        walk = nb * f.tkb
        lo = -(-walk // fused_ffn.gemv_part_max(M, planes))
        rule_s = fused_ffn.gemv_parts(M, N, nb, f.tkb, sms, planes)
        want = plain(x, f, b)
        times = {}
        for S in sorted({rule_s, *(t for t in GEMV_SPLIT_S
                                   if lo <= t <= walk)}):
            got = lanes(x, f, b, parts=S)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"{rule} decode {M}x{K}x{N} parts={S}: kernel != plain")
            times[S] = event_ms(lambda: lanes(x, f, b, parts=S), flush=flush)
        best = min(times, key=times.get)
        print(f"{rule} decode body {M}x{K}x{N}, S parts, each bitwise equal to "
              f"plain: rule S = {rule_s} {times[rule_s]:.4f} ms, fastest S = "
              f"{best} {times[best]:.4f} ms; "
              + ", ".join(f"{t} {ms:.4f}" for t, ms in times.items())
              + f" ms [{card}]", flush=True)

    rows = []
    for rule, (lanes, mma, _, _) in kernels.items():
        f = TiledBitplane.from_dense(random_ternary(4096, 4096, 2, gen, dev))
        b = torch.zeros((4096,), device=dev)
        for branch, fn, M in (("decode", lanes, 4), ("tensor-core", mma, 64)):
            x = x_for(rule, M, 4096)
            n = traced(lambda: fn(x, f, b), dev)["kernels"]
            if branch == "decode":
                check(n == 1, f"{rule} decode body: {n} kernels a call, not 1")
            rows.append(f"{rule} {branch} {n}")
    print("kernels a call (torch.profiler, Mx4096x4096): " + ", ".join(rows)
          + f" [{card}]", flush=True)


def phase_swiglu_crossover(card: str, fg, fu, fd, kw, gen, flush) -> None:
    """Phase 3, the SwiGLU's split: both branches timed at each
    ``SWIGLU_CROSSOVER_M`` over the 4096 -> 11008 -> 4096 block, their y, h
    and rmax bitwise equal to each other."""
    import torch

    from ternary_spgemm_tpu_torch.bench.timing import event_ms
    from ternary_spgemm_tpu_torch.ops import fused_ffn

    rows = []
    for M in SWIGLU_CROSSOVER_M:
        x = torch.randn((M, fg.K), generator=gen, device=fg.plane.device)
        xq, sx = fused_ffn.requantize_rows(x)
        times, outs = {}, {}
        for branch, fn in (("decode", fused_ffn._swiglu_lanes),
                           ("mma", fused_ffn._swiglu_mma)):
            outs[branch] = fn(xq, sx, fg, fu, fd, **kw)
            times[branch] = event_ms(lambda: fn(xq, sx, fg, fu, fd, **kw),
                                     flush=flush)
        torch.cuda.synchronize()
        for got, want, what in zip(outs["mma"], outs["decode"],
                                   ("y", "h", "rmax")):
            check(torch.equal(got, want),
                  f"SwiGLU M={M}: the branches' {what} differ")
        rows.append(f"M={M} {times['decode']:.4f} vs {times['mma']:.4f} ms")
    print("SwiGLU crossover at 4096->11008->4096, decode vs tensor-core "
          "branch, y, h and rmax bitwise equal: " + "; ".join(rows)
          + f" (SWIGLU_MMA_MIN_M = {fused_ffn.SWIGLU_MMA_MIN_M}) [{card}]",
          flush=True)


def phase_swiglu_split(card: str, fg, fu, fd, kw, gen, flush) -> None:
    """Phase 3, the SwiGLU decode branch's split walk at each
    ``SWIGLU_SPLIT_M`` over the 4096 -> 11008 -> 4096 block: the rule's
    parts (S1, S2) against the unsplit kernel, each phase split alone, and
    each phase's sweep (``SWIGLU_SPLIT_S1`` with S2 = 1,
    ``SWIGLU_SPLIT_S2`` with S1 = 1); every run's y, h and rmax bitwise
    equal to the tensor-core branch's."""
    import torch

    from ternary_spgemm_tpu_torch.bench.timing import event_ms
    from ternary_spgemm_tpu_torch.ops import fused_ffn
    from ternary_spgemm_tpu_torch.utils.device import sm_count

    dev = fg.plane.device
    for M in SWIGLU_SPLIT_M:
        x = torch.randn((M, fg.K), generator=gen, device=dev)
        xq, sx = fused_ffn.requantize_rows(x)
        want = fused_ffn._swiglu_mma(xq, sx, fg, fu, fd, **kw)
        rule = tuple(fused_ffn.split_parts(M, f.N, f.plane.shape[0], f.tkb,
                                           sm_count(dev)) for f in (fg, fd))
        times = {}
        for parts in {(1, 1), rule, (rule[0], 1), (1, rule[1]),
                      *((s, 1) for s in SWIGLU_SPLIT_S1),
                      *((1, s) for s in SWIGLU_SPLIT_S2)}:
            got = fused_ffn._swiglu_lanes(xq, sx, fg, fu, fd, parts=parts,
                                          **kw)
            torch.cuda.synchronize()
            for g, w, what in zip(got, want, ("y", "h", "rmax")):
                check(torch.equal(g, w), f"SwiGLU decode M={M} parts={parts}:"
                      f" {what} differs from the tensor-core branch")
            times[parts] = event_ms(lambda: fused_ffn._swiglu_lanes(
                xq, sx, fg, fu, fd, parts=parts, **kw), flush=flush)
        t11 = times[(1, 1)]
        print(f"SwiGLU decode split M={M} 4096->11008->4096, y, h and rmax "
              f"bitwise equal to the tensor-core branch at every parts: rule "
              f"(S1, S2) = {rule} {times[rule]:.4f} ms vs unsplit {t11:.4f} "
              f"ms; gate and up alone (S1 = {rule[0]}, 1) "
              f"{times[(rule[0], 1)]:.4f} ms (saves "
              f"{t11 - times[(rule[0], 1)]:.4f}), down alone (1, S2 = "
              f"{rule[1]}) {times[(1, rule[1])]:.4f} ms (saves "
              f"{t11 - times[(1, rule[1])]:.4f}); sweep S1 (S2 = 1): "
              + ", ".join(f"{s} {times[(s, 1)]:.4f}" for s in SWIGLU_SPLIT_S1)
              + "; sweep S2 (S1 = 1): "
              + ", ".join(f"{s} {times[(1, s)]:.4f}" for s in SWIGLU_SPLIT_S2)
              + f" ms [{card}]", flush=True)


def phase_prelu_ffn(dev, card: str, flush) -> dict:
    """Phase 3, the PReLU FFN: the kernel against its plain version at the
    ffn_bench blocks (M = 32) and at M in {1, 33, 128}, PReLU2 off and on;
    the hidden state, its requantized values and the output bitwise."""
    import torch

    from ternary_spgemm_tpu_torch.bench.timing import event_ms
    from ternary_spgemm_tpu_torch.formats import TiledBitplane
    from ternary_spgemm_tpu_torch.models.serving import random_ternary
    from ternary_spgemm_tpu_torch.ops import fused_ffn
    from ternary_spgemm_tpu_torch.ops.fused_ffn import (
        ffn_hidden_plain, ffn_launch, ffn_plain, requantize_rows, true_div)
    from ternary_spgemm_tpu_torch.utils.device import sm_count

    gen = torch.Generator(device=dev)
    gen.manual_seed(5678)
    stat = {"max_abs_err": 0.0}
    kw = dict(gamma1=0.037, gamma2=1.9)
    cases = [(32, 1024, 4096, 1024), (32, 2048, 4096, 2048),
             (1, 1024, 4096, 1024), (33, 1024, 4096, 1024),
             (128, 1024, 4096, 1024)]
    for M, K, N1, N2 in cases:
        f1 = TiledBitplane.from_dense(random_ternary(K, N1, 4, gen, dev))
        f2 = TiledBitplane.from_dense(random_ternary(N1, N2, 4, gen, dev))
        x = torch.randint(-512, 513, (M, K), generator=gen,
                          device=dev).to(torch.float32)
        # a bias and a PReLU slope per column, so that an indexing slip in
        # an epilogue shows
        b1, b2 = (4.0 * torch.rand((n,), generator=gen, device=dev) - 2.0
                  for n in (N1, N2))
        a1, a2_on = (0.25 * torch.rand((n,), generator=gen, device=dev)
                     for n in (N1, N2))
        h_plain = ffn_hidden_plain(x, f1, b1, a1, gamma1=kw["gamma1"])
        hq_plain, _ = requantize_rows(h_plain)
        plain_off = None    # (y, h, rmax) of the plain version, PReLU2 off
        for a2 in (None, a2_on):
            y, h, rmax = ffn_launch(x, f1, b1, a1, f2, b2, a2, **kw)
            want = ffn_plain(x, f1, b1, a1, f2, b2, a2, **kw)
            hq = torch.round(h / true_div(rmax[:, None] + 1e-12, 127.0))
            if a2 is None:
                plain_off = (want, h_plain, h_plain.abs().amax(1))
            torch.cuda.synchronize()
            what = f"PReLU FFN M={M} {K}->{N1}->{N2} prelu2={a2 is not None}"
            check(torch.equal(h, h_plain), f"{what}: hidden h != plain")
            check(torch.equal(hq, hq_plain), f"{what}: requantized h != plain")
            err = float((y - want).abs().max())
            check(torch.equal(y, want), f"{what}: y != plain (max |diff| {err})")
            stat["max_abs_err"] = max(stat["max_abs_err"], err)
        args = (x, f1, b1, a1, f2, b2, None)
        ms = event_ms(lambda: ffn_launch(*args, **kw), flush=flush)
        pms = event_ms(lambda: ffn_plain(*args, **kw), flush=flush)
        # two planes, X and Y f32, b1 and alpha1, b2; up and down products;
        # no single PyTorch call computes the fused block
        bms, by = bound(weight_bytes(f1) + weight_bytes(f2)
                        + 4 * (M * K + M * N2 + 2 * N1 + N2),
                        spmm_ops(M, f1) + spmm_ops(M, f2))
        rule = tuple(fused_ffn.gemv_parts(M, f.N, f.plane.shape[0], f.tkb,
                                          sm_count(dev), planes)
                     for f, planes in ((f1, 2), (f2, 1)))
        print(f"kernel fused_bitplane_ffn M={M} {K}->{N1}->{N2}: h, hq and y "
              f"bitwise equal (PReLU2 on/off); {ms:.4f} ms vs plain {pms:.4f} "
              f"ms, bound {bms:.6f} ms ({by}); parts (S1, S2) = {rule} "
              f"[{card}]", flush=True)
        if (M, K) == (32, 1024):
            phase_ffn_split(card, args, kw, rule, plain_off, flush)
            stat.update(ms=ms, plain_ms=pms, library_ms=None, bound_ms=bms,
                        bound_by=by)
    return stat


def phase_ffn_split(card: str, args, kw, rule, plain, flush) -> None:
    """Phase 3, the PReLU FFN's split walks on ``args``' block: each
    phase's parts S at ``FFN_SPLIT_S`` (those its walk and staged X allow)
    with the other phase at the rule's, each run's y, h and rmax bitwise
    equal to ``plain``, the plain version's, timed."""
    import torch

    from ternary_spgemm_tpu_torch.bench.timing import event_ms
    from ternary_spgemm_tpu_torch.ops import fused_ffn

    x, f1, _, _, f2 = args[:5]
    M = x.shape[0]
    rows = []
    for i, (f, planes) in enumerate(((f1, 2), (f2, 1))):
        walk = f.plane.shape[0] * f.tkb
        lo = -(-walk // fused_ffn.gemv_part_max(M, planes))
        times = {}
        for S in (t for t in FFN_SPLIT_S if lo <= t <= walk):
            parts = (S, rule[1]) if i == 0 else (rule[0], S)
            got = fused_ffn.ffn_launch(*args, **kw, parts=parts)
            torch.cuda.synchronize()
            for g, w, what in zip(got, plain, ("y", "h", "rmax")):
                check(torch.equal(g, w), f"PReLU FFN parts={parts}: {what} "
                      "!= plain")
            times[S] = event_ms(lambda: fused_ffn.ffn_launch(
                *args, **kw, parts=parts), flush=flush)
        rows.append(f"S{i + 1} (S{2 - i} = {rule[1 - i]}): " + ", ".join(
            f"{t} {ms:.4f}" for t, ms in times.items()))
    print(f"PReLU FFN split M={M} {f1.K}->{f1.N}->{f2.N}, each bitwise equal "
          f"to plain (the rule's parts {rule}): " + "; ".join(rows) + f" ms [{card}]",
          flush=True)


def small_tree(cfg, seed: int) -> dict:
    """A latent parameter tree in the shape of the JAX BitTransformerLM.init
    (``ternary_spgemm_tpu/models/transformer.py:256-265``), from numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d, ff, kvw = cfg.d_model, cfg.d_ff, cfg.kv_width

    def lin(K, N):
        return {"w": (rng.standard_normal((K, N)) * math.sqrt(2.0 / K)
                      ).astype(np.float32),
                "b": np.zeros(N, np.float32)}

    blocks = [{"wq": lin(d, d), "wk": lin(d, kvw), "wv": lin(d, kvw),
               "wo": lin(d, d), "w_gate": lin(d, ff), "w_up": lin(d, ff),
               "w_down": lin(ff, d), "norm_attn": np.ones(d, np.float32),
               "norm_ffn": np.ones(d, np.float32)}
              for _ in range(cfg.n_layers)]
    embed = (rng.standard_normal((cfg.vocab, d)) * d ** -0.5).astype(np.float32)
    return {"embed": embed, "blocks": blocks,
            "norm_out": np.ones(d, np.float32)}


def phase_model_parity(dev) -> None:
    """Phase 4: the CPU copy (plain versions) and the card copy (kernels) of
    one small model give identical greedy tokens. The kernels are exact and
    the glue is device-independent (``models/transformer.py``), so the two
    copies agree bit for bit up to the f32 logits head, whose dot products
    sum in another order on the card: logits within rtol=atol=1e-4."""
    import numpy as np
    import torch

    from ternary_spgemm_tpu_torch.models import (
        BitTransformerConfig, generate, init_cache, lm_from_jax_params)
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck

    cfg = BitTransformerConfig(vocab=64, d_model=256, n_heads=4, d_ff=512,
                               n_layers=2)
    lm_cpu = lm_from_jax_params(cfg, small_tree(cfg, seed=7), a8=True,
                                fused_qkv=True, fused_ffn=True, device="cpu")
    lm_gpu = copy.deepcopy(lm_cpu).to(dev)
    prompt = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (4, 16)))
    before = sum(ck.launches.values())
    logits = []
    for lm, p in ((lm_cpu, prompt), (lm_gpu, prompt.to(dev))):
        caches = init_cache(cfg, 4, 16, torch.int8, device=p.device)
        logits.append(lm.prefill(p, caches)[0].cpu())
    check(sum(ck.launches.values()) > before,
          "the card copy launched no kernel")
    diff = (logits[0] - logits[1]).abs()
    err = float(diff.max())
    close = float((diff <= 1e-4 + 1e-4 * logits[0].abs()).float().mean())
    rows_off = int((diff.amax(dim=-1) > 1e-4).sum())
    print(f"model parity: prefill logits max |diff| {err:.4g}, "
          f"{close:.4%} within rtol=atol=1e-4, {rows_off} of "
          f"{diff.shape[0] * diff.shape[1]} positions with a larger diff",
          flush=True)
    check(close == 1.0,
          f"prefill logits differ between CPU and card by {err}")
    toks_cpu = generate(lm_cpu, prompt, 16, cache_dtype=torch.int8)
    toks_gpu = generate(lm_gpu, prompt.to(dev), 16,
                        cache_dtype=torch.int8).cpu()
    check(torch.equal(toks_cpu, toks_gpu),
          f"greedy tokens differ:\n{toks_cpu}\n{toks_gpu}")
    print(f"model parity (2 layers, d=256): prefill logits max |diff| "
          f"{err:.3g}; greedy tokens identical ({tuple(toks_gpu.shape)})",
          flush=True)


def phase_serve(dev, card: str) -> dict:
    """Phase 5: the counted main path at BitNet-7B width, eager; then the
    captured loop against it."""
    import torch

    from ternary_spgemm_tpu_torch.formats import TiledBitplane
    from ternary_spgemm_tpu_torch.models import (
        BitTransformerConfig, build_serving_lm, generate, init_cache)
    from ternary_spgemm_tpu_torch.models.serving import (
        preset_config, random_ternary)
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
    from ternary_spgemm_tpu_torch.ops import fused_ffn, ternary_spgemm

    B, T0, n_new = 4, 128, 32
    cfg = preset_config("bitnet7b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(42)
    t0 = time.perf_counter()
    lm = build_serving_lm(cfg, s=2, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    f_ns = TiledBitplane.from_dense(random_ternary(1024, 4096, 4, gen, dev))
    x_ns = torch.randint(-512, 513, (32, 1024), generator=gen,
                         device=dev).to(torch.float32)
    b_ns = torch.full((4096,), 2.0, device=dev)
    prompt = torch.randint(0, cfg.vocab, (B, T0), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    ck.reset_counts()
    with warnings.catch_warnings():
        # default dispatch warns that non-integer X would be rounded; this
        # X is integer-valued
        warnings.simplefilter("ignore", UserWarning)
        y_ns = ternary_spgemm(x_ns, f_ns, b_ns)      # default dispatch -> i8
    t1 = time.perf_counter()
    toks = generate(lm, prompt, n_new, cache_dtype=torch.int8, graph=False)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t1
    counts = dict(ck.launches)
    plain = dict(ck.plain_on_cuda)
    peak = torch.cuda.max_memory_allocated(dev)

    L, F = cfg.n_layers, 1 + (n_new - 1)
    print(f"serve launches: {counts}; plain versions on CUDA: {plain}",
          flush=True)
    check(not plain, f"a plain version ran on a CUDA tensor: {plain}")
    check(counts.get("CudaTiledBitplane_x8") == 2 * L * F,
          f"x8 launches {counts.get('CudaTiledBitplane_x8')} != 2*{L}*{F}")
    # the prefill's B*T0 rows take the tensor-core branch, decode's B rows
    # the decode kernel
    check(B * T0 > ck.X8_MMA_MIN_M >= B,
          f"X8_MMA_MIN_M = {ck.X8_MMA_MIN_M} does not split prefill "
          f"({B * T0} rows) from decode ({B})")
    check(counts.get(ck.X8_MMA_COUNT, 0) == 2 * L,
          f"x8 tensor-core launches {counts.get(ck.X8_MMA_COUNT, 0)} != "
          f"2*{L} (the prefill's; none in decode)")
    x8_decode = counts["CudaTiledBitplane_x8"] - counts[ck.X8_MMA_COUNT]
    check(x8_decode == 2 * L * (F - 1),
          f"x8 decode-body launches {x8_decode} != 2*{L}*{F - 1}")
    print(f"serve: {x8_decode} x8 launches on the decode body "
          f"(csrc/gemv_core.cuh, {B} rows a step), {counts[ck.X8_MMA_COUNT]} "
          f"on the tensor cores (the prefill's {B * T0} rows)", flush=True)
    check(counts.get("fused_bitplane_swiglu") == L * F,
          f"SwiGLU launches {counts.get('fused_bitplane_swiglu')} != {L}*{F}")
    check(B * T0 > fused_ffn.SWIGLU_MMA_MIN_M >= B,
          f"SWIGLU_MMA_MIN_M = {fused_ffn.SWIGLU_MMA_MIN_M} does not split "
          f"prefill ({B * T0} rows) from decode ({B})")
    check(counts.get(fused_ffn.SWIGLU_MMA_COUNT, 0) == L,
          f"SwiGLU tensor-core launches "
          f"{counts.get(fused_ffn.SWIGLU_MMA_COUNT, 0)} != {L} (the "
          f"prefill's; none in decode)")
    check(counts.get("CudaTiledBitplane_i8") == 1,
          f"i8 launches {counts.get('CudaTiledBitplane_i8')} != 1")
    # the headline op's 32 rows: the tensor-core branch above I8_MMA_MIN_M
    i8_mma = int(x_ns.shape[0] > ck.I8_MMA_MIN_M)
    check(counts.get(ck.I8_MMA_COUNT, 0) == i8_mma,
          f"i8 tensor-core launches {counts.get(ck.I8_MMA_COUNT, 0)} != "
          f"{i8_mma} (32 rows, I8_MMA_MIN_M = {ck.I8_MMA_MIN_M})")
    check(tuple(toks.shape) == (B, T0 + n_new), f"tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "token out of vocab")
    check(torch.equal(toks[:, :T0], prompt), "prompt not kept")
    check(bool(torch.isfinite(y_ns).all()), "headline SpMM not finite")
    print(f"serve bitnet7b (32 layers, d=4096, ff=11008), batch {B}, prompt "
          f"{T0}, {n_new} new tokens, eager: build {build_s:.2f} s; generate "
          f"{gen_s:.3f} s; max_memory_allocated {peak / 2**30:.3f} GiB "
          f"[{card}]", flush=True)
    phase_serve_graph(dev, card, lm, prompt, toks, n_new, peak)
    return counts, lm, prompt, toks


def phase_serve_graph(dev, card: str, lm, prompt, toks, n_new: int,
                      eager_peak: int) -> None:
    """Phase 5, the captured loop: the eager loop's greedy tokens and one
    eager step's launches from the captures, sampled tokens captured and
    eager for one seed, then E G G E timings of prefill and decode."""
    import torch

    from ternary_spgemm_tpu_torch.models import generate
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
    from ternary_spgemm_tpu_torch.ops import fused_ffn

    cfg = lm.cfg
    L = cfg.n_layers
    (B, T0), int8 = prompt.shape, torch.int8
    eager = eager_launches(lm, prompt, n_new, int8)
    check(eager["step"] == {"CudaTiledBitplane_x8": 2 * L,
                            "fused_bitplane_swiglu": L},
          f"one eager decode step launched {eager['step']}")

    lm._captured.clear()
    ck.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    got = generate(lm, prompt, n_new, cache_dtype=int8)    # captures
    first_s = time.perf_counter() - t0
    graph_peak = torch.cuda.max_memory_allocated(dev)
    check(not ck.plain_on_cuda,
          f"a plain version ran on a CUDA tensor: {dict(ck.plain_on_cuda)}")
    check(torch.equal(got, toks), "captured greedy tokens differ from the "
          f"eager loop's:\n{got.cpu()}\n{toks.cpu()}")
    (loop,) = lm._captured.values()
    captured = {k: dict(v) for k, v in loop.launches.items()}
    print(f"serve captured: launches while capturing {captured}; one eager "
          f"prefill {eager['prefill']}, one eager step {eager['step']}",
          flush=True)
    for name in ("prefill", "step"):
        check(captured[name] == eager[name],
              f"the {name} capture launched {captured[name]}, one eager "
              f"{name} {eager[name]}")
    check(captured["prefill"].get(ck.X8_MMA_COUNT) == 2 * L
          and captured["prefill"].get(fused_ffn.SWIGLU_MMA_COUNT) == L,
          "the prefill capture is not on the tensor cores")
    t0 = time.perf_counter()
    again = generate(lm, prompt, n_new, cache_dtype=int8)  # replays
    again_s = time.perf_counter() - t0
    check(torch.equal(again, toks) and len(lm._captured) == 1,
          "a second captured generate did not replay the first's graphs")

    kw = dict(cache_dtype=int8, temperature=0.8, top_k=50, top_p=0.95)
    sampled = []
    for graph in (False, True):
        g = torch.Generator(device=dev)
        g.manual_seed(1234)
        sampled.append(generate(lm, prompt, n_new, generator=g, graph=graph,
                                **kw))
    check(torch.equal(sampled[0], sampled[1]), "captured sampled tokens "
          f"differ from the eager loop's:\n{sampled[1].cpu()}\n"
          f"{sampled[0].cpu()}")
    check(bool(((sampled[0] >= 0) & (sampled[0] < cfg.vocab)).all()),
          "sampled token out of vocab")
    print(f"serve sampled (T=0.8, top_k=50, top_p=0.95, seed 1234): "
          f"captured and eager tokens identical; "
          f"{int((sampled[0][:, T0:] != toks[:, T0:]).sum())} of "
          f"{B * n_new} differ from greedy", flush=True)

    runs = egge_runs(lm, loop, prompt, toks, n_new, int8)
    print(f"serve bitnet7b, batch {B}, prompt {T0}, {n_new} new tokens, int8 "
          f"cache, E G G E: " + "; ".join(runs) + f"; captured generate "
          f"{first_s:.3f} s the first call (capture included), "
          f"{again_s:.3f} s the second; max_memory_allocated eager "
          f"{eager_peak / 2**30:.3f} GiB, captured {graph_peak / 2**30:.3f} "
          f"GiB [{card}]", flush=True)
    lm._captured.clear()


def eager_launches(lm, prompt, n_new: int, cache_dtype) -> dict:
    """The launches of one eager prefill of ``prompt`` and of the decode
    step after it: ``{"prefill": counts, "step": counts}``."""
    import torch

    from ternary_spgemm_tpu_torch.models import init_cache
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck

    B, T0 = prompt.shape
    with torch.no_grad():
        caches = init_cache(lm.cfg, B, T0 + n_new, cache_dtype,
                            device=prompt.device)
        ck.reset_counts()
        logits, caches = lm.prefill(prompt, caches)
        out = {"prefill": dict(ck.launches)}
        ck.reset_counts()
        lm.decode_step(torch.argmax(logits[:, -1], dim=-1), caches, T0)
        out["step"] = dict(ck.launches)
    return out


def eager_serve_s(lm, prompt, n_new: int, cache_dtype) -> tuple:
    """(prefill s, decode s a step) of ``lm``'s eager loop on ``prompt``
    (host clock around synchronized calls)."""
    import torch

    from ternary_spgemm_tpu_torch.models import init_cache

    B, T0 = prompt.shape
    with torch.no_grad():
        caches = init_cache(lm.cfg, B, T0 + n_new, cache_dtype,
                            device=prompt.device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, caches = lm.prefill(prompt, caches)
        cur = torch.argmax(logits[:, -1], dim=-1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
        t = time.perf_counter()
        for pos in range(T0, T0 + n_new - 1):
            logits, caches = lm.decode_step(cur, caches, pos)
            cur = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    return prefill_s, (time.perf_counter() - t) / (n_new - 1)


def graph_serve_s(loop, prompt, toks, n_new: int) -> tuple:
    """(prefill s, decode s a step) of the captured ``loop``'s replays on
    ``prompt``; its tokens must be ``toks``'."""
    import torch

    T0 = prompt.shape[1]
    loop.load(prompt)
    torch.cuda.synchronize()
    t = time.perf_counter()
    loop.call("prefill")
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(n_new - 1):
        loop.call("step")
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / (n_new - 1)
    check(torch.equal(loop.tokens[:, T0:T0 + n_new], toks[:, T0:]),
          "the timed replays gave other tokens")
    return prefill_s, step_s


def egge_runs(lm, loop, prompt, toks, n_new: int, cache_dtype) -> list:
    """The eager and captured loops timed in the order eager, graph, graph,
    eager: one line each, prefill ms and tokens/s, decode ms a step."""
    B, T0 = prompt.shape
    timers = {"eager": lambda: eager_serve_s(lm, prompt, n_new, cache_dtype),
              "graph": lambda: graph_serve_s(loop, prompt, toks, n_new)}
    runs = []
    for name in ("eager", "graph", "graph", "eager"):
        prefill_s, step_s = timers[name]()
        runs.append(f"{name} prefill {prefill_s * 1e3:.2f} ms = "
                    f"{B * T0 / prefill_s:.1f} tokens/s, decode "
                    f"{step_s * 1e3:.3f} ms a step")
    return runs


def path_launches(counts: dict) -> dict:
    """The serve's kernels' launches by branch: x8 and the SwiGLU on the
    decode body and on the tensor cores (``/mma``)."""
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
    from ternary_spgemm_tpu_torch.ops import fused_ffn

    out = {}
    for name, mma in (("CudaTiledBitplane_x8", ck.X8_MMA_COUNT),
                      ("fused_bitplane_swiglu", fused_ffn.SWIGLU_MMA_COUNT)):
        out[name] = {"decode": counts.get(name, 0) - counts.get(mma, 0),
                     "mma": counts.get(mma, 0)}
    return out


def counted(fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after; raises if a plain version ran on a CUDA tensor. Returns (its
    result, the counts)."""
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck

    ck.reset_counts()
    out = fn()
    counts = dict(ck.launches)
    check(not ck.plain_on_cuda,
          f"a plain version ran on a CUDA tensor: {dict(ck.plain_on_cuda)}")
    return out, counts


def graph_step_ms(lm, prompt, n_new: int, ring: bool = False) -> float:
    """ms a decode step of ``lm``'s captured greedy loop for ``prompt``
    (int8 cache, a ring or not; captured by an earlier ``generate``),
    replays timed."""
    import torch

    (loop,) = [v for v in lm._captured.values()
               if v.prompt.shape == prompt.shape
               and ("pos_tab" in v.caches[0]) == ring]
    loop.load(prompt)
    loop.call("prefill")
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n_new - 1):
        loop.call("step")
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / (n_new - 1) * 1e3


def phase_serve_more(dev, card: str, lm, prompt, toks) -> dict:
    """Phase 5b: the rest of the serving path on phase 5's BitNet-7B LM,
    each part counted: (a) the LM through a serving bundle and back, (b) a
    512-token prompt prefilled whole and in chunks, (c) the ring cache
    past its window, (d) the bf16 head. Returns the launches of all four."""
    import torch

    total = collections.Counter()
    for part in (phase_bundle, phase_chunked, phase_ring_cache,
                 phase_bf16_head):
        total.update(part(dev, card, lm, prompt, toks))
        torch.cuda.empty_cache()
    return dict(total)


def phase_bundle(dev, card: str, lm, prompt, toks) -> dict:
    """Phase 5b (a): ``save_lm_bundle`` of the full-depth LM into a
    temporary directory and ``load_lm_bundle`` onto the card: every tensor
    of the loaded LM equal to the original's, every setting the same, and
    its captured greedy tokens phase 5's."""
    import zipfile

    import torch

    from ternary_spgemm_tpu_torch.checkpoint import (
        load_lm_bundle, save_lm_bundle)
    from ternary_spgemm_tpu_torch.models import generate

    tmp = tempfile.mkdtemp(prefix="chip_smoke_bundle_")
    try:
        path = os.path.join(tmp, "bitnet7b.npz")
        torch.cuda.synchronize()
        t = time.perf_counter()
        save_lm_bundle(path, lm)
        save_s = time.perf_counter() - t
        nbytes = os.path.getsize(path)
        parts = collections.Counter()
        with zipfile.ZipFile(path) as z:
            for info in z.infolist():
                key = info.filename[:-len(".npy")]
                kind = ("derived wq/wk/wv" if key.split(".")[1:2] in
                        (["wq"], ["wk"], ["wv"]) else
                        "embedding" if key == "embed" else
                        "planes" if key.endswith(".plane") else "other")
                parts[kind] += info.file_size
        t = time.perf_counter()
        back = load_lm_bundle(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp)
    want, got = lm.state_dict(), back.state_dict()
    check(list(got) == list(want), "the loaded LM's tensors are not the "
          f"original's: {sorted(set(got) ^ set(want))[:8]}")
    for k, v in want.items():
        check(got[k].device == v.device and got[k].dtype == v.dtype
              and torch.equal(got[k], v), f"loaded tensor {k} differs")
    for a, b in zip(lm.blocks, back.blocks):
        check((a.fused_ffn, a.a8, a.kernel) == (b.fused_ffn, b.a8, b.kernel),
              "a loaded block's settings differ")
        for n, lin in a.linears.items():
            other = b.linears[n]
            check((lin.gamma, lin.a8, lin.kernel) ==
                  (other.gamma, other.a8, other.kernel),
                  f"loaded linear {n}'s settings differ")
    tensor_bytes = sum(v.numel() * v.element_size() for v in want.values())
    print(f"bundle bitnet7b ({lm.cfg.n_layers} layers): {nbytes} bytes on disk "
          f"({dict(parts)}); save {save_s:.2f} s, load onto the card "
          f"{load_s:.2f} s; {len(want)} tensors ({tensor_bytes} bytes) "
          f"equal to the original's [{card}]", flush=True)

    n_new = toks.shape[1] - prompt.shape[1]
    got_toks, counts = counted(
        lambda: generate(back, prompt, n_new, cache_dtype=torch.int8))
    check(torch.equal(got_toks, toks), "the loaded LM's captured greedy "
          f"tokens differ from phase 5's:\n{got_toks.cpu()}\n{toks.cpu()}")
    want_counts = capture_launches(lm.cfg.n_layers)
    check(counts == want_counts, f"the loaded LM's warm-ups and captures "
          f"launched {counts}, not {want_counts}")
    generate(lm, prompt, n_new, cache_dtype=torch.int8)   # captures lm's
    ms = [(name, graph_step_ms(m, prompt, n_new))
          for name, m in (("original", lm), ("loaded", back),
                          ("loaded", back), ("original", lm))]
    print(f"bundle: the loaded LM's captured greedy tokens are phase 5's "
          f"({tuple(toks.shape)}); launches of its warm-ups and captures "
          f"{path_launches(counts)}; captured decode ms a step "
          + ", ".join(f"{n} {v:.3f}" for n, v in ms) + f" [{card}]",
          flush=True)
    lm._captured.clear()
    del back
    return counts


def serve_launches(L: int, steps: int) -> dict:
    """The launches of a greedy generate of an ``L``-layer A8 serve, eager:
    its prefill (on the tensor cores) and ``steps`` decode steps (on the
    decode body)."""
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
    from ternary_spgemm_tpu_torch.ops import fused_ffn

    return {"CudaTiledBitplane_x8": 2 * L * (1 + steps),
            ck.X8_MMA_COUNT: 2 * L,
            "fused_bitplane_swiglu": L * (1 + steps),
            fused_ffn.SWIGLU_MMA_COUNT: L}


def capture_launches(L: int) -> dict:
    """The launches of a first captured generate of that serve: each of its
    two bodies (the prefill, one decode step) run ``graphs.WARMUP`` times
    and captured once; the replays launch through the graphs, uncounted."""
    from ternary_spgemm_tpu_torch.models.graphs import WARMUP

    return {k: (WARMUP + 1) * v for k, v in serve_launches(L, 1).items()}


def phase_chunked(dev, card: str, lm, prompt, toks) -> dict:
    """Phase 5b (b): a 512-token prompt, batch 4, prefilled whole and by
    ``chunked_prefill`` at each of ``LONG_CHUNKS``: the same next greedy
    token from each, each chunk's kernels on the branch its rows select
    (x8 above ``X8_MMA_MIN_M`` rows on the tensor cores, the SwiGLU above
    ``SWIGLU_MMA_MIN_M``); tokens/s, peak memory and launches of each."""
    import torch

    from ternary_spgemm_tpu_torch.models import init_cache
    from ternary_spgemm_tpu_torch.models.generate import chunked_prefill
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
    from ternary_spgemm_tpu_torch.ops import fused_ffn

    cfg = lm.cfg
    B, T, L = prompt.shape[0], LONG_T0, cfg.n_layers
    gen = torch.Generator(device=dev)
    gen.manual_seed(512)
    long_prompt = torch.randint(0, cfg.vocab, (B, T), generator=gen,
                                device=dev)
    total = collections.Counter()
    ref = None
    for chunk in (None,) + LONG_CHUNKS:
        caches = init_cache(cfg, B, T, torch.int8, device=dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

        def run():
            with torch.no_grad():
                if chunk is None:
                    logits = lm.prefill(long_prompt, caches)[0]
                else:
                    logits = chunked_prefill(lm, long_prompt, caches,
                                             chunk)[0]
                last = logits[:, -1].clone()
            torch.cuda.synchronize()
            return last

        t = time.perf_counter()
        last, counts = counted(run)
        secs = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated(dev)
        total.update(counts)
        check(bool(torch.isfinite(last).all()), "prefill logits not finite")
        starts = range(0, T, chunk or T)
        rows = [B * min(chunk or T, T - s) for s in starts]
        want = {"CudaTiledBitplane_x8": 2 * L * len(rows),
                ck.X8_MMA_COUNT: 2 * L * sum(
                    r > ck.X8_MMA_MIN_M for r in rows),
                "fused_bitplane_swiglu": L * len(rows),
                fused_ffn.SWIGLU_MMA_COUNT: L * sum(
                    r > fused_ffn.SWIGLU_MMA_MIN_M for r in rows)}
        want = {k: v for k, v in want.items() if v}
        name = "unchunked" if chunk is None else f"chunk {chunk}"
        check(counts == want, f"{name} launched {counts}, not {want}")
        nxt = torch.argmax(last, dim=-1)
        if ref is None:
            ref = (last, nxt)
            diff = ""
        else:
            check(torch.equal(nxt, ref[1]), f"{name}'s next greedy tokens "
                  f"{nxt.tolist()} differ from unchunked {ref[1].tolist()}")
            diff = (f", last logits max |diff| against unchunked "
                    f"{float((last - ref[0]).abs().max()):.6g}")
        print(f"prefill {T} tokens x {B}, {name} ({len(rows)} calls of "
              f"{sorted(set(rows))} rows): {secs:.3f} s = {B * T / secs:.1f} "
              f"tokens/s; max_memory_allocated {peak / 2**30:.3f} GiB "
              f"({(peak - base) / 2**30:.3f} GiB above the model and "
              f"caches); launches {path_launches(counts)}; next greedy "
              f"tokens {nxt.tolist()}{diff} [{card}]", flush=True)
        del caches
    return dict(total)


def phase_ring_cache(dev, card: str, lm, prompt, toks) -> dict:
    """Phase 5b (c): phase 5's blocks (``RING_LAYERS`` of them) as a
    sliding-window model (``RING_WINDOW``) generating ``RING_NEW`` tokens
    after a ``RING_T0``-token prompt, so the ring wraps: ``generate(ring=
    True)`` gives the full cache's tokens, eager and captured; the cache
    bytes of each."""
    import torch

    from ternary_spgemm_tpu_torch.models import (
        ExportedTransformerLM, generate, init_cache)

    cfg = dataclasses.replace(lm.cfg, window=RING_WINDOW,
                              n_layers=RING_LAYERS)
    lm_w = ExportedTransformerLM(cfg, list(lm.blocks)[:RING_LAYERS],
                                 lm.embed, lm.norm_out)
    p = prompt[:, :RING_T0]
    B, L = p.shape[0], RING_LAYERS
    total = collections.Counter()
    out, secs = {}, {}
    for ring in (False, True):
        for graph in (False, True):
            def run():
                got = generate(lm_w, p, RING_NEW, cache_dtype=torch.int8,
                               ring=ring, graph=graph)
                torch.cuda.synchronize()
                return got
            t = time.perf_counter()
            out[ring, graph], counts = counted(run)
            secs[ring, graph] = time.perf_counter() - t
            total.update(counts)
            want = (capture_launches(L) if graph
                    else serve_launches(L, RING_NEW - 1))
            check(counts == want, f"ring={ring} graph={graph} launched "
                  f"{counts}, not {want}")
    full = out[False, False]
    check(tuple(full.shape) == (B, RING_T0 + RING_NEW), "ring tokens shape")
    for key, got in out.items():
        check(torch.equal(got, full), f"ring={key[0]} graph={key[1]} tokens "
              f"differ from the eager full cache's")
    ms = [(ring, graph_step_ms(lm_w, p, RING_NEW, ring=ring))
          for ring in (False, True, True, False)]
    nbytes = {ring: sum(t.numel() * t.element_size()
                        for c in init_cache(cfg, B, RING_T0 + RING_NEW,
                                            torch.int8, ring=ring, device=dev)
                        for t in c.values())
              for ring in (False, True)}
    print(f"ring: {L} layers of bitnet7b, window {RING_WINDOW}, batch {B}, "
          f"prompt {RING_T0}, {RING_NEW} new tokens: tokens identical for "
          f"the full cache and the ring, eager and captured; cache bytes "
          f"full {nbytes[False]}, ring {nbytes[True]}; generate s "
          + ", ".join(f"{'ring' if r else 'full'} {'graph' if g else 'eager'}"
                      f" {v:.3f}" for (r, g), v in secs.items())
          + " (graph: capture included); captured decode ms a step "
          + ", ".join(f"{'ring' if r else 'full'} {v:.3f}" for r, v in ms)
          + f" [{card}]", flush=True)
    lm_w._captured.clear()
    return dict(total)


def phase_bf16_head(dev, card: str, lm, prompt, toks) -> dict:
    """Phase 5b (d): phase 5's blocks with a bf16 embedding: f32 logits;
    the bf16 head within ``BF16_HEAD_TOL`` of the f32 head on the f32
    model's final hidden states; the whole model's logits against the f32
    model's, the greedy tokens that agree, and the captured decode ms a
    step of each head (f32, bf16, bf16, f32)."""
    import torch

    from ternary_spgemm_tpu_torch.models import (
        ExportedTransformerLM, generate, init_cache)

    hidden = {}

    class Probe(ExportedTransformerLM):
        def _head(self, x):
            hidden["x"] = x
            return super()._head(x)

    cfg = lm.cfg
    (B, T0), n_new = prompt.shape, toks.shape[1] - prompt.shape[1]
    f32 = Probe(cfg, lm.blocks, lm.embed, lm.norm_out)
    bf16 = ExportedTransformerLM(cfg, lm.blocks, lm.embed, lm.norm_out,
                                 head_dtype=torch.bfloat16)
    check(bf16.embed.dtype == torch.bfloat16, "the embedding is not bf16")
    with torch.no_grad():
        l32 = f32.prefill(prompt, init_cache(cfg, B, T0, torch.int8,
                                             device=dev))[0]
        l16 = bf16.prefill(prompt, init_cache(cfg, B, T0, torch.int8,
                                              device=dev))[0]
        x = hidden["x"]
        h16, h32 = bf16._head(x), f32._head(x)
    check(l16.dtype == torch.float32 and h16.dtype == torch.float32,
          f"bf16 head logits are {l16.dtype}")
    head_err = float((h16 - h32).abs().max())
    check(bool(torch.isclose(h16, h32, rtol=BF16_HEAD_TOL,
                             atol=BF16_HEAD_TOL).all()),
          f"the bf16 head is {head_err} from the f32 head")
    diff = (l16 - l32).abs()
    within = float((diff <= BF16_HEAD_TOL + BF16_HEAD_TOL * l32.abs())
                   .float().mean())

    got, counts = counted(lambda: generate(bf16, prompt, n_new,
                                           cache_dtype=torch.int8))
    want = generate(bf16, prompt, n_new, cache_dtype=torch.int8, graph=False)
    check(torch.equal(got, want), "the bf16 head's captured tokens differ "
          "from its eager loop's")
    generate(lm, prompt, n_new, cache_dtype=torch.int8)     # captures f32
    agree = int((got[:, T0:] == toks[:, T0:]).sum())
    first = [next((i for i in range(n_new) if got[b, T0 + i] != toks[b, T0 + i]),
                  n_new) for b in range(B)]
    ms = [(name, graph_step_ms(m, prompt, n_new))
          for name, m in (("f32", lm), ("bf16", bf16), ("bf16", bf16),
                          ("f32", lm))]
    print(f"bf16 head: f32 logits; the head alone on the f32 model's hidden "
          f"states max |diff| {head_err:.6g} (within rtol=atol="
          f"{BF16_HEAD_TOL}); the whole model's prefill logits max |diff| "
          f"{float(diff.max()):.6g}, {within:.4%} within rtol=atol="
          f"{BF16_HEAD_TOL}; greedy tokens agreeing with the f32 head "
          f"{agree} of {B * n_new} (first difference per row at new token "
          f"{first}); captured decode ms a step "
          + ", ".join(f"{n} {v:.3f}" for n, v in ms) + f" [{card}]",
          flush=True)
    lm._captured.clear()
    bf16._captured.clear()
    return counts


def phase_bench_kernels(dev, card: str) -> dict:
    """Phase 6: every hand-written SpMM kernel that phase 3 does not hold,
    against its plain version on the card, at the benchmark path's shapes;
    the block-packed containers at factor 4 and 5."""
    import torch

    from ternary_spgemm_tpu_torch.bench.timing import event_ms
    from ternary_spgemm_tpu_torch.models.serving import random_ternary

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    kernels = {n: s for n, s in spmm_kernels().items()
               if n not in SERVE_KERNELS}
    stats = {name: {"max_abs_err": 0.0} for name in kernels}
    extras = {BENCH_SHAPES[1][:3]: "u", BENCH_SHAPES[2][:3]: "l"}
    for M, K, N, s in BENCH_SHAPES:
        W = random_ternary(K, N, s, gen, dev)
        fmts = {}
        b = torch.full((N,), 2.0, device=dev)
        a = torch.full((N,), 0.1, device=dev)
        for name, spec in kernels.items():
            kern, plain = spec.fn, spec.plain
            vr = spec.x_absmax or 512
            xs = [torch.randint(-vr, vr + 1, (M, K), generator=gen,
                                device=dev).to(torch.float32),
                  4.0 * torch.rand((M, K), generator=gen, device=dev) - 2.0]
            variants = factor_variants(spec)
            for kw in variants:
                key = (spec.format_cls, tuple(kw.items()))
                if key not in fmts:
                    fmts[key] = spec.format_cls.from_dense(W, **kw)
                f = fmts[key]
                shape_err = 0.0     # this shape's max |diff|, non-integer X
                for i, x in enumerate(xs):
                    for alpha in (None, a):
                        got = kern(x, f, b, alpha)
                        want = plain(x, f, b, alpha)
                        torch.cuda.synchronize()
                        err = float((got - want).abs().max())
                        what = (f"{name} {kw or ''} {M}x{K}x{N} prelu="
                                f"{alpha is not None} "
                                f"{'integer' if i == 0 else 'non-integer'} X")
                        if i == 0:
                            check(torch.equal(got, want),
                                  f"{what}: kernel != plain (max |diff| "
                                  f"{err})")
                        else:
                            bad = (got - want).abs() > 1e-3 + 1e-5 * want.abs()
                            check(not bool(bad.any()),
                                  f"{what}: {int(bad.sum())} outputs outside "
                                  f"rtol=1e-5, atol=1e-3 (max |diff| {err})")
                            shape_err = max(shape_err, err)
                        stats[name]["max_abs_err"] = max(
                            stats[name]["max_abs_err"], err)
                x = xs[0]      # integer, in the domain: every X rule keeps it
                ms = event_ms(lambda: kern(x, f, b, None), flush=flush)
                pms = event_ms(lambda: plain(x, f, b, None), flush=flush)
                bms, by = spmm_bound(M, f)
                # the yardsticks at every shape; the kernels line keeps the
                # first factor's at the north star, U and L
                lms = library_ms(x, f, flush)
                rec = dict(ms=ms, plain_ms=pms, library_ms=lms,
                           bound_ms=bms, bound_by=by)
                if kw == variants[0] and (M, K, N) in extras:
                    stats[name][extras[(M, K, N)]] = rec
                elif kw == variants[0] and (M, K, N) == BENCH_SHAPES[0][:3]:
                    stats[name].update(rec)
                print(f"kernel {name}{''.join(f' {k}={v}' for k, v in kw.items())} "
                      f"{M}x{K}x{N} s={s}: bitwise equal on integer X (PReLU "
                      f"on/off), non-integer X within tolerance (max |diff| "
                      f"{shape_err:.3g}); {ms:.4f} ms vs plain {pms:.4f} ms"
                      f", library {lms:.4f} ms, bound {bms:.4f} ms ({by}) "
                      f"[{card}]", flush=True)
        del W, fmts
    del flush
    phase_dense_rows(dev, card)
    return stats


def phase_dense_rows(dev, card: str) -> None:
    """Phase 6's row sweep: the kernels of ``DENSE_KERNELS`` (the
    block-packed ones at factor 4 and 5) timed at M in ``DENSE_ROWS`` at
    the north star's K and N (s=4), each bitwise equal to its plain version
    on integer X first. It calls the kernels through the registry only, so
    that a copy of this script runs it against another tree's package too
    (the bodies the tile replaced)."""
    import torch

    from ternary_spgemm_tpu_torch.bench.timing import event_ms
    from ternary_spgemm_tpu_torch.models.serving import random_ternary
    from ternary_spgemm_tpu_torch.ops import all_kernels

    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    _, K, N, s = BENCH_SHAPES[0]
    W = random_ternary(K, N, s, gen, dev)
    b = torch.full((N,), 2.0, device=dev)
    cases = []      # (label, spec, container)
    for name in DENSE_KERNELS:
        spec = all_kernels()[name]
        for kw in factor_variants(spec):
            label = name + "".join(f" {k}={v}" for k, v in kw.items())
            cases.append((label, spec, spec.format_cls.from_dense(W, **kw)))
    for M in DENSE_ROWS:
        x = torch.randint(-256, 257, (M, K), generator=gen,
                          device=dev).to(torch.float32)
        times = []
        for label, spec, f in cases:
            got, want = spec.fn(x, f, b), spec.plain(x, f, b)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{label} M={M}x{K}x{N}: kernel "
                  f"!= plain (max |diff| {float((got - want).abs().max())})")
            times.append(f"{label} {event_ms(lambda: spec.fn(x, f, b), flush=flush):.4f} ms")
        print(f"dense rows M={M}x{K}x{N} s={s}: {', '.join(times)} "
              f"(bitwise on integer X) [{card}]", flush=True)
    del flush


def run_main(main, argv):
    """``main(argv)`` in-process -> (exit code, what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def phase_entry_point(dev) -> dict:
    """Phase 7: the benchmark CLI (correctness on, PReLU off and on), then
    the headline; returns the CLI runs' launch counts."""
    from ternary_spgemm_tpu_torch import __main__ as cli
    from ternary_spgemm_tpu_torch.bench import headline
    from ternary_spgemm_tpu_torch.ops import all_kernels
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck

    run = run_main
    ck.reset_counts()
    for extra in ([], ["-prelu"]):
        argv = ["-M", "32", "-K", "1024", "-N", "4096", "-s", "4",
                "-correctness", *extra]
        rc, out = run(cli.main, argv)
        print(f"$ python -m ternary_spgemm_tpu_torch {' '.join(argv)}\n"
              f"{out}", end="", flush=True)
        check(rc == 0, f"the CLI exited {rc}")
        check("ERROR" not in out, "the CLI reported an ERROR")
        lines = out.splitlines()
        check(len(all_kernels()) == 31 and lines[1] == (
            "# 31 kernels, the port's registry: a counterpart of every "
            "kernel of the JAX registry"), f"the CLI header: {lines[:2]}")
        for name in all_kernels():
            mine = [ln for ln in lines if ln.split()[:1] == [name]]
            check(len(mine) == 1 and mine[0].endswith("correct=True"),
                  f"{name} not reported correct: {mine}")
        # the six torch-op formulations: correct at abs 1e-5 (the CLI's
        # gate) on integer X, each with its time
        times = {n: float([ln for ln in lines if ln.split()[:1] == [n]][0]
                          .split()[1]) for n in XLA_FORMULATIONS}
        print(f"the six formulations ({' '.join(extra) or 'no PReLU'}), "
              "each correct at abs 1e-5 against the dense reference on "
              "integer X: " + ", ".join(f"{n} {t:.2f} us"
                                        for n, t in times.items()),
              flush=True)
    counts = dict(ck.launches)
    plain = dict(ck.plain_on_cuda)
    print(f"entry-point launches: {counts}; plain versions on CUDA: {plain}",
          flush=True)
    check(not plain, f"a plain version ran on a CUDA tensor: {plain}")
    for name in spmm_kernels():
        check(counts.get(name, 0) > 0, f"{name} was not launched")
    check({n.split("/")[0] for n in counts} <= set(spmm_kernels()),
          f"launches counted for kernels that are not hand-written: {counts}")

    rc, out = run(headline.main, [])
    check(rc == 0, f"the headline exited {rc}:\n{out}")
    check(not ck.plain_on_cuda, "a plain version ran on a CUDA tensor: "
          f"{dict(ck.plain_on_cuda)}")
    check(len(headline.DEFAULT_KERNELS) == 19 and
          "# bench.py's 19 default kernels, each by its counterpart here"
          in out.splitlines() and "incomplete" not in out,
          f"the headline does not compete bench.py's 19 kernels:\n{out}")
    rec = [ln for ln in out.splitlines() if ln.startswith("{")]
    check(len(rec) == 1, f"no headline JSON line:\n{out}")
    head = json.loads(rec[0])
    check(head.get("value", 0) > 0, f"headline {rec[0]}")
    print(out, end="", flush=True)
    print(f"headline best_kernel {head['best_kernel']}, best_any_kernel "
          f"{head['best_any_kernel']}", flush=True)
    # the stacked marginal at the north star: bench.py's stacked_* keys, no
    # stacked_error (the headline would print one and carry on)
    check("stacked_error" not in head and all(k in head for k in
                                              STACKED_KEYS),
          f"the headline's stacked keys: {rec[0]}")
    check(head["stacked_marginal_seconds"] > 0,
          f"stacked marginal {head['stacked_marginal_seconds']}")
    print("stacked marginal: " + ", ".join(f"{k} {head[k]}"
                                           for k in STACKED_KEYS)
          + f" [{card_line()}]", flush=True)
    # the launches of the whole phase: the CLI's and the headline's (its
    # stacked chains counted once each, at their capture)
    return dict(ck.launches)


def phase_ffn_bench(card: str) -> dict:
    """Phase 8: the FFN-block benchmark (``tools.ffn_bench``) in-process at
    its default blocks, counted; returns its launch counts."""
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
    from ternary_spgemm_tpu_torch.ops.fused_ffn import (
        FFN_KERNEL_NAME, KERNEL_NAME)
    from ternary_spgemm_tpu_torch.tools import ffn_bench

    ck.reset_counts()
    rc, out = run_main(ffn_bench.main, [])
    counts, plain = dict(ck.launches), dict(ck.plain_on_cuda)
    print(f"$ python -m ternary_spgemm_tpu_torch.tools.ffn_bench\n{out}",
          end="", flush=True)
    rec = json.loads(out.splitlines()[-1])
    rows = rec["blocks"]
    check(rc == 0 and len(rows) == 6 and all(r["correct"] for r in rows),
          f"ffn_bench: a block is not correct (exit {rc})")
    print(f"ffn_bench launches: {counts}; plain versions on CUDA: {plain} "
          f"[{card}]", flush=True)
    check(not plain, f"a plain version ran on a CUDA tensor: {plain}")
    for name in (FFN_KERNEL_NAME, KERNEL_NAME):
        check(counts.get(name, 0) > 0, f"ffn_bench did not launch {name}")
    return counts


def phase_probes(dev, card: str):
    """Phase 9: each probe kernel (stream, decode rate, the deposit ladder)
    bitwise against its plain version on the card, timed beside its
    yardsticks; then the three study tools in-process, counted. Returns
    (stats, launch counts of the tools' runs)."""
    import torch

    from ternary_spgemm_tpu_torch.bench.timing import event_ms
    from ternary_spgemm_tpu_torch.formats import TiledEllDeposit
    from ternary_spgemm_tpu_torch.models.serving import random_ternary
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
    from ternary_spgemm_tpu_torch.tools import decode_roofline as dr
    from ternary_spgemm_tpu_torch.tools import deposit_study as ds
    from ternary_spgemm_tpu_torch.tools import membench
    from ternary_spgemm_tpu_torch.utils.device import sm_count

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    stats = {}

    # the stream probe: every geometry of the membench sweep below, on the
    # array the tool times (seed 0), and a small tile of many blocks' runs
    sweep = [(layout, tk, tn, mb, 0) for layout in membench.LAYOUTS
             for tk, tn in SWEEP_TILES for mb in SWEEP_SIZES_MB]
    for layout, tk, tn, mb, seed in [("tiled4d", 16, 256, 1, 1), *sweep]:
        gk, gn = membench.grid_for(mb * 2**20, tk, tn)
        arr = membench.make_array(gk, gn, tk, tn, layout, dev, seed=seed)
        x = torch.randint(-2**31, 2**31 - 1, (8, 128), generator=gen,
                          device=dev, dtype=torch.int32)
        got = membench.stream_checksum(arr, tk, tn, layout, x)
        want = membench.stream_plain(arr, x)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"stream {layout} ({tk}, {tn}) {mb} MB: checksum != plain")
        del arr
    # timed at 512 MB, tiled4d (256, 4096)
    layout, tk, tn = "tiled4d", 256, 4096
    gk, gn = membench.grid_for(512 * 2**20, tk, tn)
    arr = membench.make_array(gk, gn, tk, tn, layout, dev)
    nbytes = arr.numel()
    out = x.clone()
    ms = event_ms(lambda: membench.stream_launch(arr, tk, tn, layout, out),
                  flush=flush)
    pms = event_ms(lambda: membench.stream_plain(arr, x), flush=flush)
    words = arr.view(-1).view(torch.int32).view(-1, membench.BUCKETS)
    lms = event_ms(lambda: torch.sum(words, dim=0, dtype=torch.int32),
                   flush=flush)
    bms, by = bound(nbytes + 2 * 4096, nbytes // 4)
    stats[membench.KERNEL_NAME] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms,
                                       library_ms=lms, bound_ms=bms,
                                       bound_by=by)
    print(f"kernel stream_rate: checksums bitwise equal ({len(sweep) + 1} "
          f"geometries, both layouts); 512 MB tiled4d (256, 4096): "
          f"{ms:.4f} ms = "
          f"{nbytes / ms / 1e9:.3f} TB/s vs plain {pms:.4f} ms, library "
          f"(torch.sum) {lms:.4f} ms, bound {bms:.4f} ms ({by}) [{card}]",
          flush=True)
    del arr, words

    # the decode-rate probe: random and all-ones X, one SM and all of them
    tkb, tns, reps = 128, 512, 64
    plane, ones = dr.probe_inputs(tkb, tns, dev, seed=1)
    xr = torch.randint(-127, 128, ones.shape, generator=gen, device=dev,
                       dtype=torch.int32)
    sms = sm_count(dev)
    for xx in (xr, ones):
        want = dr.decode_rate_plain(plane, xx, reps)
        for blocks in (1, sms):
            got = dr.decode_rate(plane, xx, reps, blocks)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"decode rate blocks={blocks}: kernel != plain")
    ms = event_ms(lambda: dr.decode_rate_launch(plane, ones, reps, 1))
    all_ms = event_ms(lambda: dr.decode_rate_launch(plane, ones, reps, sms))
    pms = event_ms(lambda: dr.decode_rate_plain(plane, ones, reps))
    # one block computes the (8, tns) output on one SM: the i8 rule's two
    # __dp4a (four products each) for each weight, row and repetition, at
    # one SM's integer rate; the tile, X and the output once
    dp4a = 2 * 8 * reps * 8 * tkb * tns // 4
    bms, by = bound(plane.numel() + 4 * (ones.numel() + 8 * tns), dp4a,
                    SM_DP4A_PER_S)
    stats[dr.KERNEL_NAME] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms,
                                 library_ms=None, bound_ms=bms, bound_by=by)
    print(f"kernel decode_rate: bitwise equal (random and all-ones X, 1 and "
          f"{sms} blocks); one SM {ms:.4f} ms = "
          f"{reps * 8 * tkb * tns / ms / 1e6:.2f} G weights/s, "
          f"{dp4a / ms / 1e6:.2f} G __dp4a/s; {sms} SMs {all_ms:.4f} ms = "
          f"{dp4a / all_ms / 1e6:.2f} G __dp4a/s an SM; vs plain {pms:.4f} "
          f"ms, bound {bms:.6f} ms ({by}: {dp4a} __dp4a at "
          f"{SM_DP4A_PER_S / 1e9:.2f} G/s, one SM) [{card}]", flush=True)

    # the deposit ladder: every mode at each of deposit_study's configs
    # (the north star among them) and at a ragged shape
    for M, K, N, s in (*ds.LADDER_CONFIGS, (7, 999, 1000, 3)):
        fmt = TiledEllDeposit.from_dense(random_ternary(K, N, s, gen, dev))
        x = torch.randint(-512, 513, (M, K), generator=gen,
                          device=dev).to(torch.float32)
        b = torch.full((N,), 2.0, device=dev)
        for mode in ds.MODES:
            got = ds.deposit_variant(x, fmt, b, mode=mode)
            want = ds.deposit_variant_plain(x, fmt, b, mode=mode)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"deposit ladder {mode} {M}x{K}x{N}: kernel != plain")
        if (M, K, N, s) == (32, 1024, 4096, 4):
            times = {m: event_ms(lambda m=m: ds.deposit_variant_launch(
                x, fmt, b, mode=m), flush=flush) for m in ds.MODES}
            pms = event_ms(lambda: ds.deposit_variant_plain(
                x, fmt, b, mode="full"), flush=flush)
            lms = library_ms(x, fmt, flush)
            bms, by = spmm_bound(M, fmt)
            stats[ds.KERNEL_NAME] = dict(
                max_abs_err=0.0, ms=times["full"], plain_ms=pms,
                library_ms=lms, bound_ms=bms, bound_by=by)
            print(f"kernel deposit_variant {M}x{K}x{N} s={s}: every mode "
                  f"bitwise equal; " + ", ".join(
                      f"{m} {t:.4f} ms" for m, t in times.items())
                  + f"; plain (full) {pms:.4f} ms, library {lms:.4f} ms, "
                  f"bound {bms:.4f} ms ({by}) [{card}]", flush=True)
        else:
            print(f"kernel deposit_variant {M}x{K}x{N} s={s}: every mode "
                  f"bitwise equal", flush=True)
        del fmt
    del flush

    # the study tools, counted
    ck.reset_counts()
    argv = ["--sizes-mb", ",".join(map(str, SWEEP_SIZES_MB)),
            "--tiles", ";".join(f"{tk},{tn}" for tk, tn in SWEEP_TILES)]
    rc, out = run_main(membench.main, argv)
    print(f"$ python -m ternary_spgemm_tpu_torch.tools.membench "
          f"{' '.join(argv)}\n{out}", end="", flush=True)
    recs = json.loads(out.splitlines()[-1])["records"]
    check(rc == 0 and len(recs) == 2 * len(SWEEP_TILES) * len(SWEEP_SIZES_MB),
          f"membench: exit {rc}")
    # the tool records a failing config and sweeps on: a row with an error
    # is a kernel that failed on the card
    failed = [r for r in recs if "error" in r]
    check(not failed, f"membench: configs failed: {failed}")
    top = max(r["gbps"] for r in recs)
    check(top <= 1.05 * HBM_BYTES_PER_S / 1e9,
          f"membench: {top:.1f} GB/s is above the card's memory rate")
    rc, out = run_main(dr.main, [])
    print(f"$ python -m ternary_spgemm_tpu_torch.tools.decode_roofline\n"
          f"{out}", end="", flush=True)
    rec = json.loads(out.splitlines()[-1])
    check(rc == 0 and not any("error" in r for r in rec["configs"])
          and [(r["config"], r["branch"]) for r in rec["configs"]]
          == [(c, b) for c in dr.DEFAULT_CONFIGS for b in dr.BRANCHES],
          f"decode_roofline: exit {rc}, or a config or branch failed")
    rc, out = run_main(ds.main, [])
    print(f"$ python -m ternary_spgemm_tpu_torch.tools.deposit_study\n"
          f"{out}", end="", flush=True)
    rec = json.loads(out.splitlines()[-1])
    check(rc == 0 and len(rec["ladder"]) == 3
          and all(r["correct"] == {"full": True, "staticcap": True}
                  for r in rec["ladder"]),
          f"deposit_study: exit {rc}, or full / staticcap not exact")
    counts, plain = dict(ck.launches), dict(ck.plain_on_cuda)
    print(f"study-tool launches: {counts}; plain versions on CUDA: {plain} "
          f"[{card}]", flush=True)
    check(not plain, f"a plain version ran on a CUDA tensor: {plain}")
    for name in (membench.KERNEL_NAME, dr.KERNEL_NAME, ds.KERNEL_NAME):
        check(counts.get(name, 0) > 0, f"the study tools did not launch {name}")
    return stats, counts


def sm_clock_under_load(dev) -> float:
    """The SM clock in MHz, read by ``nvidia-smi`` while the card works
    through a queue of f32 matmuls (an idle card drops its clock)."""
    import torch

    a = torch.randn((8192, 8192), device=dev)
    for _ in range(64):
        a = torch.matmul(a, a).clamp_(-1.0, 1.0)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    torch.cuda.synchronize()
    return float(out)


def phase_ragged(dev, card: str):
    """Phase 10: the ragged probe's kernel bitwise against its plain version
    (4096 entries, the probe's, and 65,536), timed beside its bound; then ``tools.ragged_probe``
    in-process, counted, both SpMM kernels launched on each of its six
    configs. Returns (stats, launch counts of the tool's run)."""
    import torch

    from ternary_spgemm_tpu_torch.bench.timing import event_ms
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
    from ternary_spgemm_tpu_torch.tools import ragged_probe as rp

    for entries in (4096, 65536):
        ents = torch.from_numpy(rp.scalar_entries(entries)).to(dev)
        want = rp.scalar_deposit_plain(ents)
        got = rp.scalar_deposit_launch(ents)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"scalar deposit, {entries} entries: tile != plain")
    ents = torch.from_numpy(rp.scalar_entries(4096)).to(dev)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    ms = event_ms(lambda: rp.scalar_deposit_launch(ents), flush=flush)
    pms = event_ms(lambda: rp.scalar_deposit_plain(ents), flush=flush)
    del flush
    mhz = sm_clock_under_load(dev)
    # the entries read once and the tile written once; 4096 dependent
    # shared-memory read-modify-writes on one thread, each at least a
    # load's and a dependent integer op's latency (SMEM_RMW_CYCLES)
    bms, by = bound(ents.numel() * 4 + 8 * 128 * 4,
                    ents.shape[0] * SMEM_RMW_CYCLES, mhz * 1e6)
    stats = {rp.KERNEL_NAME: dict(max_abs_err=0.0, ms=ms, plain_ms=pms,
                                  library_ms=None, bound_ms=bms, bound_by=by)}
    print(f"kernel scalar_deposit_rate: tile bitwise equal (4096 and 65536 "
          f"entries); 4096 entries {ms:.4f} ms = {4096 / ms * 1e3:.4g} "
          f"entries/s; plain {pms:.4f} ms; latency bound {bms:.6f} ms ({by}: "
          f"4096 x {SMEM_RMW_CYCLES} cycles, SM clock {mhz:.0f} MHz under "
          f"load) [{card}]", flush=True)

    ck.reset_counts()
    per_config, run_config = [], rp.run_config

    def counted(cfg, **kw):
        before = dict(ck.launches)
        out = run_config(cfg, **kw)
        per_config.append({k: ck.launches[k] - before.get(k, 0)
                           for k in rp.KERNELS})
        return out

    rp.run_config = counted
    try:
        rc, out = run_main(rp.main, [])
    finally:
        rp.run_config = run_config
    counts, plain = dict(ck.launches), dict(ck.plain_on_cuda)
    print(f"$ python -m ternary_spgemm_tpu_torch.tools.ragged_probe\n{out}",
          end="", flush=True)
    rec = json.loads(out.splitlines()[-1])
    rows = rec["high_sparsity"]
    check(rc == 0 and len(rows) == 12 and len(per_config) == 6,
          f"ragged_probe: exit {rc}, {len(rows)} rows")
    check(not any(r["error"] for r in rows),
          f"ragged_probe: a kernel failed: {[r for r in rows if r['error']]}")
    check(all(n > 0 for c in per_config for n in c.values()),
          f"ragged_probe: a config did not launch both kernels: {per_config}")
    check(all(v is not None and v > 0 for v in
              rec["ragged_floor_analysis"]["floors_seconds"].values()),
          "ragged_probe: a floor is missing")
    print(f"ragged_probe launches: {counts} (by config: {per_config}); plain "
          f"versions on CUDA: {plain}; entries_per_s "
          f"{rec['scalar_deposit']['entries_per_s']:.6g} [{card}]", flush=True)
    check(not plain, f"a plain version ran on a CUDA tensor: {plain}")
    check(counts.get(rp.KERNEL_NAME, 0) > 0, "the probe's kernel was not "
          "launched")
    return stats, counts


def phase_ring(dev, card: str):
    """Phase 11: the ring's one cooperative launch against the plain
    schedule at ranks in {2, 4, 8}, at the JAX test's shape (K=64, NL=128,
    mc=8) and at full width (M = 512, the serve's 4 x 128 prefill rows; K =
    4096, N = 12288, BitNet-7B's merged QKV): bitwise on integer X, within
    rtol=1e-5, atol=1e-3 on non-integer X, the same Y over 20 back-to-back
    launches, the bias a seeded integer per column (a kernel that took the
    wrong rank's bias columns would show); timed at full width. Then the entry point, counted. Returns
    (stats, launch counts of the entry point's run)."""
    import torch

    from ternary_spgemm_tpu_torch.bench.timing import event_ms
    from ternary_spgemm_tpu_torch.formats import (
        DenseTernary, generate_ternary, generate_x)
    from ternary_spgemm_tpu_torch.models.serving import random_ternary
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
    from ternary_spgemm_tpu_torch.parallel import ring_kernel as rk

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    def column_bias(N):
        # integers, so that integer X stays exact in f32
        return torch.randint(-64, 65, (N,), generator=gen, device=dev).to(
            torch.float32)

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    stat = {"max_abs_err": 0.0}
    FM, FK, FN = RING_FULL
    full = DenseTernary.from_dense(random_ternary(FK, FN, 2, gen, dev))
    for shape in ("small", "full"):
        for d in RING_RANKS:
            if shape == "small":
                M, K, N = 8 * d, 64, 128 * d
                fmt = DenseTernary.from_dense(
                    generate_ternary(K, N, 4, seed=3), device=dev)
            else:
                (M, K, N), fmt = RING_FULL, full
            X = torch.from_numpy(generate_x(M, K, seed=4)).to(dev)
            b = column_bias(N)
            got, blocks = rk.ring_launch(X, fmt, b, ranks=d)
            want = rk.ring_allgather_spgemm_plain(X, fmt, b, ranks=d)
            again = [rk.ring_launch(X, fmt, b, ranks=d)[0] for _ in range(20)]
            torch.cuda.synchronize()
            what = f"ring {shape} ranks={d} {M}x{K}x{N}"
            check(torch.equal(got, want),
                  f"{what}: kernel != plain (max |diff| "
                  f"{float((got - want).abs().max())})")
            check(all(torch.equal(y, got) for y in again),
                  f"{what}: 20 back-to-back launches differ")
            del again
            Xf = 4.0 * torch.rand((M, K), generator=gen, device=dev) - 2.0
            gf = rk.ring_launch(Xf, fmt, b, ranks=d)[0]
            wf = rk.ring_allgather_spgemm_plain(Xf, fmt, b, ranks=d)
            torch.cuda.synchronize()
            err = float((gf - wf).abs().max())
            bad = (gf - wf).abs() > 1e-3 + 1e-5 * wf.abs()
            check(not bool(bad.any()),
                  f"{what}: {int(bad.sum())} outputs outside rtol=1e-5, "
                  f"atol=1e-3 on non-integer X (max |diff| {err})")
            stat["max_abs_err"] = max(stat["max_abs_err"], err)
            line = (f"kernel ring_allgather_spgemm {shape} ranks={d} "
                    f"{M}x{K}x{N} ({blocks} blocks a rank): bitwise equal on "
                    f"integer X, 20 launches identical, non-integer X within "
                    f"tolerance (max |diff| {err:.3g})")
            if shape == "full":
                ms = event_ms(lambda: rk.ring_launch(X, fmt, b, ranks=d),
                              flush=flush)
                pms = event_ms(lambda: rk.ring_allgather_spgemm_plain(
                    X, fmt, b, ranks=d), flush=flush)
                lms = library_ms(X, fmt, flush)
                # X, W, bias read once and Y written once; a multiply-add
                # a nonzero weight and row, as three bf16 passes
                bms, by = bound(4 * (M * K + N + M * N) + K * N,
                                F32_BF16_PASSES * spmm_ops(M, fmt),
                                BF16_FLOPS_PER_S)
                # the bound before the products went to the tensor cores
                f32ms, _ = bound(0, spmm_ops(M, fmt), F32_FLOPS_PER_S)
                line += (f"; {ms:.4f} ms vs plain {pms:.4f} ms, library "
                         f"{lms:.4f} ms, bound {bms:.4f} ms ({by}; at the "
                         f"f32 rate {f32ms:.4f} ms)")
                if d == RING_RANKS[-1]:
                    stat.update(ms=ms, plain_ms=pms, library_ms=lms,
                                bound_ms=bms, bound_by=by)
            print(f"{line} [{card}]", flush=True)
    del flush

    # the entry point, counted: one launch a ring call
    ck.reset_counts()
    X = torch.from_numpy(generate_x(FM, FK, seed=5)).to(dev)
    b = column_bias(FN)
    ys = [rk.ring_allgather_spgemm(X, full, b, ranks=d) for d in RING_RANKS]
    torch.cuda.synchronize()
    counts, plain = dict(ck.launches), dict(ck.plain_on_cuda)
    want = torch.matmul(X, full.dense.to(torch.float32)) + b
    for d, y in zip(RING_RANKS, ys):
        check(tuple(y.shape) == (FM, FN) and bool(torch.isfinite(y).all())
              and torch.equal(y, want),
              f"ring entry point ranks={d}: not X @ W + b")
    print(f"ring entry-point launches: {counts}; plain versions on CUDA: "
          f"{plain} [{card}]", flush=True)
    check(not plain, f"a plain version ran on a CUDA tensor: {plain}")
    check(counts.get(rk.KERNEL_NAME) == len(RING_RANKS),
          f"ring launches {counts.get(rk.KERNEL_NAME)} != {len(RING_RANKS)}")
    return {rk.KERNEL_NAME: stat}, counts


def phase_serve_3b(dev, card: str) -> dict:
    """Phase 12: the serving tool (``tools/serving_bench.py``) in-process at
    bitnet3b, full depth, in each of ``SERVE_3B_VARIANTS``, counted: its
    figures, the FFN branch the JAX rule picks, the kernels each variant
    launched, no plain version on a CUDA tensor; the greedy tokens of the
    fused and the unfused variant set side by side, and the fast paths
    taken apart on one bitnet3b block (:func:`phase_3b_parts`). Returns the
    launch counts of the three runs."""
    import numpy as np
    import torch

    from ternary_spgemm_tpu_torch.ops import fused_ffn
    from ternary_spgemm_tpu_torch.tools import serving_bench as sb

    phase_3b_kernels(dev, card)
    total = collections.Counter()
    recs = {}
    for tag, extra in SERVE_3B_VARIANTS.items():
        argv = SERVE_3B_ARGS + extra
        (rc, out), counts = counted(lambda: run_main(sb.main, argv))
        print(f"$ python -m ternary_spgemm_tpu_torch.tools.serving_bench "
              f"{' '.join(argv)}\n"
              + "\n".join(out.splitlines()[:-1]), flush=True)
        check(rc == 0, f"serving_bench {tag} exited {rc}")
        rec = recs[tag] = json.loads(out.splitlines()[-1])
        check(not rec["plain_on_cuda"], f"{tag}: a plain version ran on a "
              f"CUDA tensor: {rec['plain_on_cuda']}")
        ffn, _ = sb.FAST_PATHS[extra[1]]
        # the JAX rule at bitnet3b: TiledBitplane, biasless, and the output
        # projection (d = 3200) within one 4096-column storage tile
        check(rec["ffn_branch"] == ("fused" if ffn else "unfused"),
              f"{tag}: FFN branch {rec['ffn_branch']}")
        sw = counts.get(fused_ffn.KERNEL_NAME, 0)
        check((sw > 0) == ffn and counts.get("CudaTiledBitplane_x8", 0) > 0,
              f"{tag}: launches {counts}")
        a = rec["attribution_us"]
        c = rec["config"]
        print(f"serve bitnet3b {tag} ({c['n_layers']} layers, d="
              f"{c['d_model']}, {c['n_heads']} heads of "
              f"{c['d_model'] // c['n_heads']}, kv_heads {rec['kv_heads']}, "
              f"ff={c['d_ff']}), batch {rec['batch']}, prompt {c['T0']}, "
              f"{c['n_new']} new, int8 cache, captured: FFN {rec['ffn_branch']} "
              f"({fused_ffn.KERNEL_NAME} {sw} launches); prefill "
              f"{rec['prefill']['seconds'] * 1e3:.3f} ms = "
              f"{rec['prefill']['aggregate_tokens_per_s']:.1f} tokens/s; "
              f"decode {rec['decode']['seconds_per_token'] * 1e3:.4f} ms a "
              f"step; one step alone "
              f"{rec['decode_single_dispatch']['seconds'] * 1e3:.4f} ms; "
              f"block {a['per_block'] / 1e3:.4f} ms, head "
              f"{a['head'] / 1e3:.4f} ms, glue {a['glue_fraction']:.1%}; "
              f"peak {(rec['peak_memory_bytes'] or 0) / 2**30:.3f} GiB; build "
              f"{rec['build_seconds']:.1f} s; launches (captures and graphs "
              f"counted once) {counts}; an eager prefill of 8 and 3 steps "
              f"{rec['launches']} [{card}]", flush=True)
        total.update(counts)
    a = np.array(recs["both"]["greedy_tokens"])
    b = np.array(recs["none"]["greedy_tokens"])
    same = a == b
    first = [int(np.argmin(r)) if not r.all() else None for r in same]
    print(f"greedy tokens, fused against unfused: {int(same.sum())} of "
          f"{same.size} agree (first difference per row at new token "
          f"{first}). The JAX package's own tests hold the two only block "
          f"by block (rtol={FUSED_BLOCK_TOL['rtol']}, "
          f"atol={FUSED_BLOCK_TOL['atol']}), not tokens of a deep model; "
          "one bitnet3b block's parts follow", flush=True)

    phase_3b_parts(dev, card)
    torch.cuda.empty_cache()
    return dict(total)


def phase_3b_parts(dev, card: str, cfg=None) -> dict:
    """Phase 12's fast paths taken apart: one block at bitnet3b width
    (``cfg``: another preset), the same draw and the same input, at 4 rows
    and at 512 (4 x 128): the merged QKV against the separate wq, wk and
    wv; the fused FFN against its three linears; and the block with each
    fast path alone and with both against the block with none. Prints, for
    each, the share of outputs that differ at all, the max |diff| and the
    share within ``FUSED_BLOCK_TOL``, and which fast path the block's
    divergence follows. Returns ``{rows: {part: (differ, max_diff,
    within)}}``."""
    import torch

    from ternary_spgemm_tpu_torch.models.serving import (
        build_serving_lm, preset_config)
    from ternary_spgemm_tpu_torch.models.transformer import rms_norm

    one = dataclasses.replace(cfg or preset_config("bitnet3b"), n_layers=1)
    d = one.d_model
    blocks = {(f, q): build_serving_lm(one, seed=0, device=dev, fused_ffn=f,
                                       fused_qkv=q).blocks[0]
              for f in (True, False) for q in (True, False)}
    none = blocks[False, False]
    tol = FUSED_BLOCK_TOL

    def cmp(got, want):
        check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
              f"a {one.d_model}-wide block part is not finite")
        diff = (got - want).abs()
        return (float((diff > 0).float().mean()), float(diff.max()),
                float((diff <= tol["atol"] + tol["rtol"] * want.abs()
                       ).float().mean()))

    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    with torch.no_grad():
        for T in (1, 128):
            x = torch.randn((4, T, d), generator=gen, device=dev)
            h = rms_norm(x, none.norm_attn).reshape(4 * T, d)
            hf = rms_norm(x, none.norm_ffn).reshape(4 * T, d)
            res = {
                "merged QKV vs wq/wk/wv": cmp(
                    torch.cat(blocks[False, True]._qkv(h), 1),
                    torch.cat(none._qkv(h), 1)),
                "fused FFN vs three linears": cmp(
                    blocks[True, False]._ffn(hf), none._ffn(hf)),
                "block, merged QKV alone": cmp(blocks[False, True](x),
                                               none(x)),
                "block, fused FFN alone": cmp(blocks[True, False](x),
                                              none(x)),
                "block, both": cmp(blocks[True, True](x), none(x))}
            out[4 * T] = res
            for part, (differ, mx, within) in res.items():
                print(f"bitnet3b {part}, {4 * T} rows: {differ:.4%} of "
                      f"outputs differ, max |diff| {mx:.6g}, {within:.4%} "
                      f"within rtol={tol['rtol']}, atol={tol['atol']} "
                      f"[{card}]", flush=True)
            outside = {p: 1.0 - res[f"block, {p} alone"][2]
                       for p in ("merged QKV", "fused FFN")}
            carrier = max(outside, key=outside.get)
            print(f"bitnet3b block, {4 * T} rows: "
                  + ("within the tolerance with either fast path alone"
                     if not any(outside.values()) else
                     f"the divergence follows the {carrier} ("
                     + ", ".join(f"{p} alone {v:.4%} outside"
                                 for p, v in outside.items()) + ")"),
                  flush=True)
    return out


def phase_3b_kernels(dev, card: str) -> None:
    """Phase 12's kernels at bitnet3b's shapes, which pad K (3200 -> 4096
    rows; the hidden 8640 -> 9216) before the serve runs them: x8 bitwise
    against its plain version on the merged QKV (3200 -> 9600), wo, and the
    unfused down projection (8640 -> 3200), and the SwiGLU's two branches
    bitwise against each other and against its plain version within phase
    3's rule (hq flips by at most 1 in at most 1e-4 of the values; rows
    without one within rtol=1e-5, atol=0.01), at decode's 4 rows and the
    prefill's 512 (both sides of each split)."""
    import torch

    from ternary_spgemm_tpu_torch.formats import TiledBitplane
    from ternary_spgemm_tpu_torch.models.serving import random_ternary
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
    from ternary_spgemm_tpu_torch.ops.fused_ffn import (
        _swiglu_lanes, _swiglu_mma, requantize_rows, swiglu_launch,
        swiglu_plain)

    gen = torch.Generator(device=dev).manual_seed(3200)
    d, ff = 3200, 8640

    def fmt(K, N):
        return TiledBitplane.from_dense(random_ternary(K, N, 2, gen, dev))

    for K, N, what in ((d, 3 * d, "qkv"), (d, d, "wo"), (ff, d, "down")):
        f = fmt(K, N)
        b = 4.0 * torch.rand((N,), generator=gen, device=dev) - 2.0
        a = 0.25 * torch.rand((N,), generator=gen, device=dev)
        for M in (4, 512):
            x = 60.0 * torch.randn((M, K), generator=gen, device=dev)
            for alpha in (None, a):
                got = ck.cuda_tiled_bitplane_x8_kernel(x, f, b, alpha)
                want = ck.bitplane_x8_plain(x, f, b, alpha)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"x8 bitnet3b {what} "
                      f"{M}x{K}x{N}: kernel != plain (max |diff| "
                      f"{float((got - want).abs().max())})")
        print(f"kernel CudaTiledBitplane_x8 bitnet3b {what} {K}->{N} (K "
              f"padded to {f.plane.shape[0] * 8 * f.tkb}): bitwise equal at "
              f"M = 4 and 512, PReLU on/off [{card}]", flush=True)
    fg, fu, fd = fmt(d, ff), fmt(d, ff), fmt(ff, d)
    kw = dict(gamma_gate=0.03, gamma_up=0.03, gamma_down=0.03)
    for M in (4, 512):
        x = torch.randn((M, d), generator=gen, device=dev)
        xq, sx = requantize_rows(x)
        lanes = _swiglu_lanes(xq, sx, fg, fu, fd, **kw)
        mma = _swiglu_mma(xq, sx, fg, fu, fd, **kw)
        torch.cuda.synchronize()
        for got, want, what in zip(mma, lanes, ("y", "h", "rmax")):
            check(torch.equal(got, want),
                  f"SwiGLU bitnet3b M={M}: the branches' {what} differ")
        del lanes, mma
        y, h, rmax = swiglu_launch(xq, sx, fg, fu, fd, **kw)
        want = swiglu_plain(xq, sx, fg, fu, fd, **kw)
        flips, n_hq, _, _ = swiglu_rule(y, want, h, rmax, xq, sx, fg, fu,
                                        f"SwiGLU bitnet3b M={M}", **kw)
        print(f"kernel fused_bitplane_swiglu bitnet3b {d}->{ff}->{d} M={M}: "
              f"branches bitwise; {flips} of {n_hq} hq values flip "
              f"against the plain version (by 1) [{card}]", flush=True)


def phase_autotune(dev, card: str) -> dict:
    """Phase 13: autotune. ``ternary_spgemm(kernel="auto")`` at the north
    star over TiledBitplane and BlockedEllTCSC (each candidate's time and
    the winner printed; the result exact), then ``autotune_serving_flags``
    at bitnet3b, 4 rows, with a cache file under ``build/``, and a second
    call that the file answers without a probe. Fails on any candidate
    that raised. Returns the launch counts."""
    import importlib

    import torch

    from ternary_spgemm_tpu_torch.formats import BlockedEllTCSC, TiledBitplane
    from ternary_spgemm_tpu_torch.models import autotune_serving_flags
    from ternary_spgemm_tpu_torch.models.serving import (
        build_serving_lm, preset_config, random_ternary)
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
    from ternary_spgemm_tpu_torch.ops import ternary_spgemm

    at = importlib.import_module("ternary_spgemm_tpu_torch.ops.autotune")
    M, K, N, s = BENCH_SHAPES[0]
    gen = torch.Generator(device=dev).manual_seed(77)
    W = random_ternary(K, N, s, gen, dev)
    x = torch.randint(-512, 513, (M, K), generator=gen,
                      device=dev).to(torch.float32)
    b = torch.full((N,), 2.0, device=dev)
    want = x @ W.to(torch.float32) + b     # exact: integers below 2**24
    at._CACHE.clear()
    ck.reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for fmt in (TiledBitplane.from_dense(W), BlockedEllTCSC.from_dense(W)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                name = at.autotune(x, fmt, b, verbose=True)
            y = ternary_spgemm(x, fmt, b, kernel="auto")     # the memo's
            check(torch.equal(y, want), f"kernel='auto' over "
                  f"{type(fmt).__name__} ({name}) != X @ W + b")
            print(f"autotune {type(fmt).__name__} {M}x{K}x{N} s={s}: "
                  + "; ".join(buf.getvalue().split("\n")[:-1])
                  + f"; winner {name} [{card}]", flush=True)

        cfg = preset_config("bitnet3b")
        one = dataclasses.replace(cfg, n_layers=1)
        built = []

        def builder(ffn, qkv):
            built.append((ffn, qkv))
            return build_serving_lm(one, seed=0, device=dev, fused_ffn=ffn,
                                    fused_qkv=qkv).blocks[0]

        cache = os.path.join(ROOT, "build", "autotune_serving.json")
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        if os.path.exists(cache):
            os.remove(cache)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            picks = autotune_serving_flags(cfg, None, builder=builder, rows=4,
                                           cache_path=cache, device=dev,
                                           verbose=True)
        with open(cache) as f:
            disk = json.load(f)
        print(f"autotune_serving_flags bitnet3b, 4 rows: "
              + "; ".join(buf.getvalue().split("\n")[:-1])
              + f"; picks {picks}; {os.path.relpath(cache, ROOT)} {disk} "
              f"[{card}]", flush=True)
        check(len(built) == 4, f"variants built: {built}")
        at._CACHE.clear()
        built.clear()
        probe = at.time_call
        at.time_call = lambda *a, **k: check(False, "the file did not answer")
        try:
            again = autotune_serving_flags(cfg, None, builder=builder, rows=4,
                                           cache_path=cache, device=dev)
        finally:
            at.time_call = probe
        check(again == picks and not built,
              f"second call {again} (built {built}), first {picks}")
        print("autotune_serving_flags again: the file answered, no probe",
              flush=True)
    failed = [str(w.message) for w in caught
              if "autotune: candidate" in str(w.message)]
    check(not failed, f"an autotune candidate failed: {failed}")
    check(not ck.plain_on_cuda, "a plain version ran on a CUDA tensor: "
          f"{dict(ck.plain_on_cuda)}")
    at._CACHE.clear()
    torch.cuda.empty_cache()
    return dict(ck.launches)


#: the runtime calls that launch a kernel, in a chrome trace
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def traced_ops(fn, dev, kinds=()) -> tuple:
    """``fn()`` under ``torch.profiler``, synchronised -> (the port's
    kernels by name, from the trace's kernel records; ``{aten op: device
    ms of the kernels it launched}``; the traces taken; the trace's kernel
    records and its kernel-launch calls). The profiler (torch 2.11 on an
    H100) delivers fewer kernel records than launch calls in some traces
    (phase 14's block backward: 133 for 159), so a trace in which a kernel
    of ``kinds`` (name fragments) has no record at all is taken again, up
    to three times, ``fn`` called again each time (it must be
    repeatable)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ternary_spgemm_tpu_torch.tools.serve_trace import PORT_NAMESPACE

    for n in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(dev)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        records = [e for e in events
                   if e.get("ph") == "X" and e.get("cat") == "kernel"]
        kernels = collections.Counter(e["name"] for e in records
                                      if PORT_NAMESPACE in e["name"])
        calls = sum(1 for e in events if e.get("ph") == "X"
                    and e.get("cat") == "cuda_runtime"
                    and e.get("name") in LAUNCH_CALLS)
        if records and all(any(k in name for name in kernels)
                           for k in kinds):
            break
    # the aten ops that launched kernels (each kernel's time once: the
    # kernels' own rows and the annotations' ranges are left out)
    ops = {a.key: a.self_device_time_total / 1e3
           for a in prof.key_averages()
           if a.key.startswith("aten::") and a.self_device_time_total > 0}
    return kernels, ops, n, (len(records), calls)


def check_traced(kern, kinds, launched: int, what: str) -> str:
    """The port's kernels a trace delivered for ``launched`` wrapper
    launches (``ck.launches``, the count that decides): each of ``kinds``
    (name fragments: the kernels one launch runs) present, no other port
    kernel, and no more than ``launched`` of each; returns a summary."""
    check(all(any(k in n for n in kern) for k in kinds)
          and all(any(k in n for k in kinds) for n in kern)
          and sum(kern.values()) <= launched * len(kinds),
          f"{what}: the port's kernels in the trace {dict(kern)}, not "
          f"{launched} each of {kinds}")
    return (f"{dict(kern)}: {sum(kern.values())} of the "
            f"{launched * len(kinds)} kernels of {launched} launches")


#: phase 14's trace of a QAT step, its aten ops by what they compute
STEP_PARTS = (("matmuls (linears, head)", ("aten::mm", "aten::addmm")),
              ("attention dots", ("aten::bmm",)),
              ("softmax", ("softmax",)),
              ("Adam", ("aten::_foreach", "aten::_fused_adam")))


def step_breakdown(ops: dict) -> dict:
    """A traced step's self device ms by :data:`STEP_PARTS`; the rest is
    the glue (quantizers, norms, rotary, elementwise, copies)."""
    out = {part: 0.0 for part, _ in STEP_PARTS}
    out["glue"] = 0.0
    for op, ms in ops.items():
        part = next((p for p, keys in STEP_PARTS
                     if any(k in op for k in keys)), "glue")
        out[part] += ms
    return out


def dense_mirror(lin):
    """An A8 linear of phase 14's f32 dense mirror: ``lin``'s forward on
    its decoded weights (the same requantize, an exact f32 product), and
    the straight-through backward ``gamma * (g @ Wq^T)`` on the exact f32
    cotangent: what the kernels' backward computes but for the
    cotangent's per-row requantization."""
    import torch

    from ternary_spgemm_tpu_torch.models.exported import _requantize_a8

    W = lin.fmt.to_dense().to(torch.float32)
    WT = W.t().contiguous()

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            xq, s = _requantize_a8(x)
            return (xq @ W) * (s * lin.gamma) + lin.bias

        @staticmethod
        def backward(ctx, g):
            return (g @ WT) * lin.gamma

    mirror = torch.nn.Module()
    mirror.bias = lin.bias
    mirror.forward = Fn.apply
    return mirror


def phase_train(dev, card: str) -> dict:
    """Phase 14: QAT steps at bitnet3b width (4 of its 26 layers), the
    exported block's backward through the x8 kernel on the transposed
    containers, and the exact path through the dense kernel (module
    docstring). Returns the launch counts."""
    import torch

    from ternary_spgemm_tpu_torch.formats import DenseTernary, TiledBitplane
    from ternary_spgemm_tpu_torch.models import (
        BitTransformerLM, ExportedBitLinear, ExportedMLP,
        ExportedTransformerBlock, TernaryMLP, jax_tree, make_lm_train_step,
        make_train_step)
    from ternary_spgemm_tpu_torch.models import exported as ex
    from ternary_spgemm_tpu_torch.models.serving import preset_config
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck

    cfg = dataclasses.replace(preset_config("bitnet3b"),
                              n_layers=TRAIN_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(14)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_T), generator=gen,
                         device=dev)
    ck.reset_counts()

    # (a) QAT: plain, remat and bf16 from the same parameters
    lm = BitTransformerLM(cfg, generator=gen, device=dev)
    init = {k: v.clone() for k, v in lm.state_dict().items()}
    n_params = sum(p.numel() for p in lm.parameters())

    def train(model, steps):
        """(step, losses, step ms, peak, peak above the memory resident at
        the timed steps' start: the parameters, grads and moments there)"""
        step = make_lm_train_step(model, torch.optim.Adam(
            model.parameters(), lr=TRAIN_LR))
        losses = [float(step(toks))]        # the warm-up step
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev)
        ms = []
        for _ in range(steps - 1):
            s0 = torch.cuda.Event(enable_timing=True)
            s1 = torch.cuda.Event(enable_timing=True)
            s0.record()
            loss = step(toks)
            s1.record()
            s1.synchronize()
            ms.append(s0.elapsed_time(s1))
            losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated(dev)
        return step, losses, ms, peak, peak - resident

    step, losses, ms, peak, above = train(lm, 3)
    check(all(math.isfinite(v) for v in losses) and losses[2] < losses[0],
          f"QAT losses {losses}")
    print(f"QAT bitnet3b widths (d={cfg.d_model}, {cfg.n_heads} heads, "
          f"ff={cfg.d_ff}, vocab {cfg.vocab}), {TRAIN_LAYERS} of 26 layers, "
          f"{n_params} parameters, batch {TRAIN_BATCH}x{TRAIN_T}, Adam "
          f"lr={TRAIN_LR}, f32 (TF32 off): losses {losses}; step ms "
          f"{[round(v, 3) for v in ms]}; peak {peak / 2**30:.3f} GiB, "
          f"{above / 2**30:.3f} above the resident [{card}]", flush=True)
    _, ops, _, _ = traced_ops(lambda: step(toks), dev)
    parts = step_breakdown(ops)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
    print("QAT step traced (torch.profiler, self device ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f", total {sum(ops.values()):.3f}; top ops "
          + ", ".join(f"{k} {v:.3f}" for k, v in top) + f" [{card}]",
          flush=True)
    del step
    lm.zero_grad(set_to_none=True)
    for what, variant in (("remat", dict(remat=True)),
                          ("bf16", dict(compute_dtype="bfloat16"))):
        model = BitTransformerLM(dataclasses.replace(cfg, **variant),
                                 generator=gen, device=dev)
        model.load_state_dict(init)
        vstep, vl, vms, vpeak, vabove = train(model, 3)
        del vstep, model        # the step holds the optimizer's moments
        torch.cuda.empty_cache()
        tol = REMAT_TOL if what == "remat" else BF16_LOSS_TOL
        rel = abs(vl[0] - losses[0]) / abs(losses[0])
        check(all(math.isfinite(v) for v in vl) and rel <= tol,
              f"{what} loss {vl[0]} against the plain {losses[0]} "
              f"(relative {rel:.3g}, tolerance {tol})")
        print(f"QAT {what}: first-step loss {vl[0]} (plain {losses[0]}, "
              f"relative {rel:.3g} <= {tol}); step ms "
              f"{[round(v, 3) for v in vms]}; peak {vpeak / 2**30:.3f} GiB, "
              f"{vabove / 2**30:.3f} above the resident [{card}]", flush=True)
    del init

    # (b) block 0 of the trained tree, exported A8 with its transposes
    block = ExportedTransformerBlock.from_params(
        cfg, jax_tree(lm.blocks[0], numpy=False), TiledBitplane, a8=True,
        with_transpose=True, device=dev)
    del lm
    torch.cuda.empty_cache()
    mirror = ExportedTransformerBlock(
        cfg, {n: dense_mirror(l) for n, l in block.linears.items()},
        block.norm_attn, block.norm_ffn, a8=True)
    cpu_block = copy.deepcopy(block).to("cpu")
    seen = []
    spgemm = ex.ternary_spgemm

    def recording(X, fmt, bias, alpha=None, *, kernel=None):
        Y = spgemm(X, fmt, bias, alpha, kernel=kernel)
        seen.append((X, fmt, kernel, Y))
        return Y

    for B, T in TRAIN_BLOCK_ROWS:
        rows = B * T
        x0 = torch.randn((B, T, cfg.d_model), generator=gen, device=dev)
        x = x0.clone().requires_grad_()
        loss = (block(x) ** 2).sum()
        got = collections.Counter()

        def backward():
            x.grad = None
            seen.clear()
            before = collections.Counter(ck.launches)
            loss.backward(retain_graph=True)
            got.clear()
            got.update(collections.Counter(ck.launches) - before)

        mma = rows > ck.X8_MMA_MIN_M
        kinds = (("mma8::stage_kernel", "mma8::mma_kernel") if mma
                 else ("gemv::gemv_kernel",))
        ex.ternary_spgemm = recording
        try:
            kern, _, traces, (recs, calls) = traced_ops(backward, dev, kinds)
        finally:
            ex.ternary_spgemm = spgemm
        want = {"CudaTiledBitplane_x8": 7, **({ck.X8_MMA_COUNT: 7} if mma
                                               else {})}
        check(dict(got) == want, f"block backward at {rows} rows launched "
              f"{dict(got)}, not {want}")
        traced = check_traced(kern, kinds, 7,
                              f"block backward at {rows} rows")
        check(len(seen) == 7, f"{len(seen)} backward SpMMs, not 7")
        for X, fmt, kname, Y in seen:
            check(kname == "CudaTiledBitplane_x8"
                  and bool((X == torch.round(X)).all())
                  and float(X.abs().max()) <= 127.0,
                  f"backward SpMM {kname} on a cotangent that is not int8")
            W = fmt.to_dense().to(torch.float32)
            check(torch.equal(Y, X @ W), f"backward SpMM {rows}x"
                  f"{fmt.shape[0]}x{fmt.shape[1]} != the integer product")
        del seen[:]
        if rows == TRAIN_BLOCK_ROWS[0][0] * TRAIN_BLOCK_ROWS[0][1]:
            xc = x0.cpu().requires_grad_()
            (cpu_block(xc) ** 2).sum().backward()
            gd = (x.grad.cpu() - xc.grad).abs()
            check(bool((gd <= BLOCK_CPU_TOL["atol"] + BLOCK_CPU_TOL["rtol"]
                        * xc.grad.abs()).all()),
                  f"block x grad at {rows} rows: card against CPU max |diff| "
                  f"{float(gd.max())}")
            vs = f"the CPU block's within rtol=atol=2e-3 (max |diff| " \
                 f"{float(gd.max()):.3g})"
        else:
            xm = x0.clone().requires_grad_()
            (mirror(xm) ** 2).sum().backward()
            ref = xm.grad
            diff = (x.grad - ref).abs()
            rel = float(torch.linalg.vector_norm(x.grad - ref)
                        / torch.linalg.vector_norm(ref))
            rms = float(torch.sqrt(torch.mean(ref ** 2)))
            within = float((diff <= 0.01 * ref.abs() + 0.01 * rms)
                           .float().mean())
            check(rel <= MIRROR_REL_L2, f"block x grad at {rows} rows: "
                  f"relative L2 {rel:.4g} against the dense mirror")
            vs = (f"the f32 dense mirror: relative L2 {rel:.4g} <= "
                  f"{MIRROR_REL_L2}, {within:.4%} of elements within 1% "
                  f"(+1% of the rms)")
        print(f"exported bitnet3b block backward, {rows} rows: 7 x8 SpMMs on "
              f"fmt_t bitwise the integer products; launches {dict(got)}; "
              f"torch.profiler: {traced} (traces taken {traces}; the "
              f"trace's kernel records {recs} for {calls} launch calls); x "
              f"grad against {vs} [{card}]", flush=True)
        del x, loss
    del block, mirror, cpu_block
    torch.cuda.empty_cache()

    # (c) the exact path: TernaryMLP -> ExportedMLP over DenseTernary
    mlp = TernaryMLP(TRAIN_MLP, generator=gen, device=dev)
    xs = torch.randn((TRAIN_MLP_ROWS[-1], TRAIN_MLP[0]), generator=gen,
                     device=dev)
    ys = torch.randn((TRAIN_MLP_ROWS[-1], TRAIN_MLP[-1]), generator=gen,
                     device=dev)
    step = make_train_step(mlp, torch.optim.Adam(mlp.parameters(),
                                                 lr=TRAIN_LR))
    mse = [float(step(xs, ys)) for _ in range(3)]
    check(all(math.isfinite(v) for v in mse), f"mse losses {mse}")
    exp = ExportedMLP.from_params(jax_tree(mlp, numpy=False), DenseTernary,
                                  device=dev)
    dense = [l.fmt.to_dense().to(torch.float32) * l.gamma
             for l in exp.layers]
    for rows in TRAIN_MLP_ROWS:
        x0 = torch.randn((rows, TRAIN_MLP[0]), generator=gen, device=dev)
        leaves = [x0.clone().requires_grad_()] + [
            t.detach().clone().requires_grad_()
            for l in exp.layers for t in (l.bias, l.alpha) if t is not None]
        refs = [t.detach().clone().requires_grad_() for t in leaves]

        def net(ls):
            it = iter(ls[1:])
            layers = [ExportedBitLinear(l.fmt, l.gamma, next(it),
                                        next(it) if l.alpha is not None
                                        else None, fmt_t=l.fmt_t)
                      for l in exp.layers]
            return ExportedMLP(layers)(ls[0])

        # the kernels' forward pre-activations pick the PReLU branch the
        # mirror differentiates: where the two forwards, rounded in other
        # orders, straddle the kink at 0, neither derivative is wrong, and
        # the grads would differ by (1 - alpha) g there
        with torch.no_grad():
            masks, z = [], x0
            for l in exp.layers:
                y, _ = l._linear(z, l.bias)
                masks.append(y > 0)
                z = (torch.where(masks[-1], y, l.alpha * y)
                     if l.alpha is not None else y)
        flips = 0

        def mirror_net(ls):
            nonlocal flips
            it = iter(ls[1:])
            z = ls[0]
            for l, W, mask in zip(exp.layers, dense, masks):
                z = z @ W + next(it)
                if l.alpha is not None:
                    flips += int((mask != (z > 0)).sum())
                    z = torch.where(mask, z, next(it) * z)
            return z

        loss = (net(leaves) ** 2).sum()
        got = collections.Counter()

        def backward():
            for t in leaves:
                t.grad = None
            before = collections.Counter(ck.launches)
            loss.backward(retain_graph=True)
            got.clear()
            got.update(collections.Counter(ck.launches) - before)

        kinds = ("dmma::dense_kernel",)
        kern, _, traces, (recs, calls) = traced_ops(backward, dev, kinds)
        check(dict(got) == {"CudaDense": len(exp.layers)},
              f"ExportedMLP backward at {rows} rows: launches {dict(got)}")
        traced = check_traced(kern, kinds, len(exp.layers),
                              f"ExportedMLP backward at {rows} rows")
        (mirror_net(refs) ** 2).sum().backward()
        worst = 0.0
        for t, r, what in zip(leaves, refs, ("x", "b0", "alpha0", "b1")):
            d = (t.grad - r.grad).abs()
            bad = d > EXACT_GRAD_TOL["atol"] + EXACT_GRAD_TOL["rtol"] \
                * r.grad.abs()
            check(not bool(bad.any()), f"ExportedMLP {what} grad at {rows} "
                  f"rows: {int(bad.sum())} outside, max |diff| "
                  f"{float(d.max())}")
            worst = max(worst, float(d.max()))
        print(f"ExportedMLP {TRAIN_MLP} over DenseTernary (mse losses {mse}), "
              f"{rows} rows: x, bias and slope grads within rtol=1e-4, "
              f"atol=1e-3 of f32 dense autodiff on the kernels' PReLU "
              f"branch (max |diff| {worst:.3g}; {flips} pre-activations on "
              f"the other side of 0 in the dense forward); launches "
              f"{dict(got)}; torch.profiler: {traced} (traces taken "
              f"{traces}; the trace's kernel records {recs} for {calls} "
              f"launch calls) [{card}]", flush=True)
    check(not ck.plain_on_cuda, "a plain version ran on a CUDA tensor: "
          f"{dict(ck.plain_on_cuda)}")
    torch.cuda.empty_cache()
    return dict(ck.launches)


def moe_lm_config(layers: int):
    """Phase 15's MoE model: bitnet3b's widths, ``layers`` of its 26."""
    from ternary_spgemm_tpu_torch.models.serving import preset_config

    return dataclasses.replace(
        preset_config("bitnet3b"), n_layers=layers, moe_experts=MOE_EXPERTS,
        moe_top_k=MOE_TOP_K, moe_capacity_factor=MOE_CAPACITY)


def within(got, want, tol: dict) -> tuple:
    """(every element of ``got`` within ``tol`` of ``want``, max |diff|)."""
    d = (got - want).abs()
    return (bool((d <= tol["atol"] + tol["rtol"] * want.abs()).all()),
            float(d.max()))


def phase_moe(dev, card: str) -> tuple:
    """Phase 15: the MoE FFN at bitnet3b width with 8 experts, top 2. (a)
    QAT, 2 of 26 layers, 3 Adam steps on one seeded 4 x 256 batch; (b) the
    trained tree exported exactly (DenseTernary, the dense kernel) against
    the QAT forward and the QAT backend's prefill and decode steps; (c) a
    fresh 4-layer model exported A8 over TiledBitplane (merged QKV, A8
    experts on the x8 kernel) serving 4 requests of 128 tokens, 32 new,
    captured against eager, and one expert's x8 call at decode and prefill
    rows against its plain version. Returns (the x8 kernel's expert
    figures, the launch counts of the MoE path's runs)."""
    import torch

    from ternary_spgemm_tpu_torch.bench.timing import event_ms
    from ternary_spgemm_tpu_torch.formats import DenseTernary, TiledBitplane
    from ternary_spgemm_tpu_torch.models import (
        BitTransformerLM, ExportedTransformerLM, generate, init_cache,
        jax_tree, lm_decode_step, lm_prefill, make_lm_train_step)
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
    from ternary_spgemm_tpu_torch.ops.fused_ffn import requantize_rows

    gen = torch.Generator(device=dev).manual_seed(15)
    counts = collections.Counter()
    E = MOE_EXPERTS
    what = (f"bitnet3b widths, {E} experts top {MOE_TOP_K}, capacity "
            f"factor {MOE_CAPACITY}")

    # (a) QAT
    cfg = moe_lm_config(MOE_TRAIN_LAYERS)
    L = cfg.n_layers
    toks = torch.randint(0, cfg.vocab, (MOE_TRAIN_BATCH, MOE_TRAIN_T),
                         generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    lm = BitTransformerLM(cfg, generator=gen, device=dev)
    n_params = sum(p.numel() for p in lm.parameters())
    step = make_lm_train_step(lm, torch.optim.Adam(lm.parameters(),
                                                   lr=TRAIN_LR))

    def aux_now():
        with torch.no_grad():
            return float(lm.forward_with_aux(toks)[1])

    auxes, losses, ms = [aux_now()], [], []
    for i in range(3):
        s0 = torch.cuda.Event(enable_timing=True)
        s1 = torch.cuda.Event(enable_timing=True)
        s0.record()
        loss = step(toks)
        s1.record()
        s1.synchronize()
        losses.append(float(loss))
        if i:
            ms.append(s0.elapsed_time(s1))
    auxes.append(aux_now())
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(v) for v in losses + auxes)
          and losses[2] < losses[0], f"MoE QAT losses {losses}, aux {auxes}")
    print(f"MoE QAT ({what}), {L} of 26 layers, {n_params} parameters, "
          f"batch {MOE_TRAIN_BATCH}x{MOE_TRAIN_T}, Adam lr={TRAIN_LR}, f32: "
          f"losses {losses}; aux before and after {auxes}; step ms "
          f"{[round(v, 3) for v in ms]} (steps 2-3); peak "
          f"{peak / 2**30:.3f} GiB [{card}]", flush=True)
    del step
    lm.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # (b) the exact export of the trained tree, on the dense kernel
    exp = ExportedTransformerLM.from_params(cfg, jax_tree(lm, numpy=False),
                                            DenseTernary, device=dev)
    t, T0 = toks[:2, :64], 60
    with torch.no_grad():
        want = lm(t)
        got, c = counted(lambda: exp(t))
        counts.update(c)
        ok, fwd_diff = within(got, want, MOE_EXPORT_TOL)
        check(ok, f"MoE DenseTernary export against the QAT forward: max "
                  f"|diff| {fwd_diff} outside {MOE_EXPORT_TOL}")
        cq = init_cache(cfg, 2, 64, device=dev)
        ce = init_cache(cfg, 2, 64, device=dev)
        lq, cq = lm_prefill(lm, t[:, :T0], cq)
        (le, ce), c = counted(lambda: exp.prefill(t[:, :T0], ce))
        counts.update(c)
        diffs = [within(le, lq, MOE_DECODE_TOL)]
        for pos in range(T0, 64):
            lq, cq = lm_decode_step(lm, t[:, pos], cq, pos)
            (le, ce), c = counted(
                lambda: exp.decode_step(t[:, pos], ce, pos))
            counts.update(c)
            diffs.append(within(le, lq, MOE_DECODE_TOL))
    check(all(ok for ok, _ in diffs), f"MoE export prefill / decode "
          f"against the QAT backend: {diffs} ({MOE_DECODE_TOL})")
    per_fwd = 4 + 3 * E                  # wq, wk, wv, wo and the experts
    want_c = {"CudaDense": per_fwd * L * (2 + 64 - T0)}
    check(dict(counts) == want_c, f"MoE export launched {dict(counts)}, "
          f"not {want_c}")
    print(f"MoE DenseTernary export of the trained tree: full forward 2x64 "
          f"within {MOE_EXPORT_TOL} of the QAT forward (max |diff| "
          f"{fwd_diff:.3g}); prefill 2x{T0} and {64 - T0} decode steps "
          f"within {MOE_DECODE_TOL} of lm_prefill / lm_decode_step (max "
          f"|diff| {max(d for _, d in diffs):.3g}); launches {dict(counts)} "
          f"({per_fwd} a layer a forward) [{card}]", flush=True)
    del exp, lm, want, got, cq, ce
    torch.cuda.empty_cache()

    # (c) the A8 serve: merged QKV and A8 experts on the x8 kernel
    cfg = moe_lm_config(MOE_SERVE_LAYERS)
    L = cfg.n_layers
    t0 = time.perf_counter()
    qat = BitTransformerLM(cfg, generator=gen, device=dev)
    lm = ExportedTransformerLM.from_params(
        cfg, jax_tree(qat, numpy=False), TiledBitplane, a8=True,
        fused_qkv=True, with_transpose=False, device=dev)
    del qat
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    check(all(lin.a8 for b in lm.blocks for ex in b.moe.experts
              for lin in ex.values()), "an expert of the A8 export is not A8")
    B, T0, n_new, int8 = (MOE_SERVE_B, MOE_SERVE_T0, MOE_SERVE_NEW,
                          torch.int8)
    prompt = torch.randint(0, cfg.vocab, (B, T0), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    toks, c = counted(lambda: generate(lm, prompt, n_new, cache_dtype=int8,
                                       graph=False))
    eager_peak = torch.cuda.max_memory_allocated(dev)
    counts.update(c)
    per_layer = 2 + 3 * E                # merged QKV, wo, the experts
    check(B * T0 > ck.X8_MMA_MIN_M >= B, "the x8 split does not part the "
          "prefill's expert rows from decode's")
    want_c = {"CudaTiledBitplane_x8": per_layer * L * n_new,
              ck.X8_MMA_COUNT: per_layer * L}
    check(c == want_c, f"MoE A8 serve launched {c}, not {want_c}")
    check(tuple(toks.shape) == (B, T0 + n_new)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all())
          and torch.equal(toks[:, :T0], prompt), "MoE serve tokens")
    eager = eager_launches(lm, prompt, n_new, int8)
    check(eager["step"] == {"CudaTiledBitplane_x8": per_layer * L},
          f"one eager MoE decode step launched {eager['step']}, not "
          f"{per_layer} x8 a layer")
    lm._captured.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    got, c = counted(lambda: generate(lm, prompt, n_new, cache_dtype=int8))
    graph_peak = torch.cuda.max_memory_allocated(dev)
    counts.update(c)
    check(torch.equal(got, toks), "captured MoE greedy tokens differ from "
          f"the eager loop's:\n{got.cpu()}\n{toks.cpu()}")
    (loop,) = lm._captured.values()
    captured = {k: dict(v) for k, v in loop.launches.items()}
    check(captured == eager, f"the MoE captures launched {captured}, one "
          f"eager prefill and step {eager}")
    runs = egge_runs(lm, loop, prompt, toks, n_new, int8)
    print(f"MoE A8 serve ({what}), {L} layers, TiledBitplane, merged QKV, "
          f"build {build_s:.2f} s; batch {B}, prompt {T0}, {n_new} new, int8 "
          f"cache, greedy: captured tokens equal the eager loop's; x8 "
          f"launches a decode step {eager['step']} ({per_layer} a layer: "
          f"the merged QKV, wo and {E} x 3 experts at {B} rows), a prefill "
          f"{eager['prefill']}; E G G E: " + "; ".join(runs)
          + f"; max_memory_allocated eager {eager_peak / 2**30:.3f} GiB, "
          f"captured {graph_peak / 2**30:.3f} GiB [{card}]", flush=True)
    lm._captured.clear()

    # one expert's x8 call at decode's and the prefill's rows
    f = lm.blocks[0].moe.experts[0]["w_gate"].fmt
    K, N = f.shape
    zeros = torch.zeros((N,), device=dev)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=dev)
    stats = {}
    for M, key in ((B, "moe"), (B * T0, "moe_prefill")):
        x, _ = requantize_rows(torch.randn((M, K), generator=gen, device=dev))
        kern = lambda: ck.cuda_tiled_bitplane_x8_kernel(x, f, zeros, None)
        plain = lambda: ck.bitplane_x8_plain(x, f, zeros, None)
        y, yp = kern(), plain()
        torch.cuda.synchronize()
        check(torch.equal(y, yp), f"x8 MoE expert {M}x{K}x{N}: kernel != "
              f"plain (max |diff| {float((y - yp).abs().max())})")
        bms, by = spmm_bound(M, f)
        stats[key] = dict(ms=event_ms(kern, flush=flush),
                          plain_ms=event_ms(plain, flush=flush),
                          library_ms=library_ms(x, f, flush), bound_ms=bms,
                          bound_by=by)
        r = stats[key]
        print(f"kernel CudaTiledBitplane_x8 MoE expert gate {M}x{K}x{N} "
              f"({'decode body' if M <= ck.X8_MMA_MIN_M else 'tensor cores'}"
              f"): bitwise equal; {r['ms']:.4f} ms vs plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {bms:.4f} ms ({by}) [{card}]", flush=True)
    del lm, flush
    torch.cuda.empty_cache()
    return stats, dict(counts)


def free_port() -> int:
    """A free TCP port on 127.0.0.1 for a process group's store."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def swiglu_rule(y, want, h, rmax, xq, sx, fg, fu, what: str, **kw):
    """Phase 3's rule for the fused SwiGLU's output ``y`` (hidden state
    ``h``, its row maxima ``rmax``) against its plain version ``want``:
    the requantized hidden values flip by at most 1 in at most 1e-4 of
    them, and every row without a flip agrees within rtol=1e-5,
    atol=0.01. Returns (flips, hidden values, max |err| on the clean rows,
    the mask of clean rows)."""
    import torch

    from ternary_spgemm_tpu_torch.ops.fused_ffn import (
        requantize_rows, swiglu_hidden_plain, true_div)

    hq = torch.round(h / true_div(rmax[:, None] + 1e-12, 127.0))
    hq_plain, _ = requantize_rows(swiglu_hidden_plain(
        xq, sx, fg, fu, gamma_gate=kw["gamma_gate"], gamma_up=kw["gamma_up"]))
    torch.cuda.synchronize()
    diff = (hq - hq_plain).abs()
    flips = int((diff > 0).sum())
    check(float(diff.max()) <= 1.0, f"{what}: hq differs by > 1")
    check(flips <= 1e-4 * diff.numel(),
          f"{what}: {flips} of {diff.numel()} hq values flip")
    clean = ~(diff > 0).any(dim=1)
    yc, wc = y[clean], want[clean]
    bad = (yc - wc).abs() > 0.01 + 1e-5 * wc.abs()
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} outputs outside "
          "rtol=1e-5, atol=0.01")
    err = float((yc - wc).abs().max()) if yc.numel() else 0.0
    return flips, diff.numel(), err, clean


def phase_parallel(dev, card: str) -> dict:
    """Phase 16: the parallel layer (``parallel/``, the sharded train step
    and checkpoints) on one card through the real collectives (an NCCL
    group of one rank), and the shard shapes of d-way splits rank by rank
    (module docstring). Returns the launch counts of the schemes' run."""
    import torch
    import torch.distributed as dist

    from ternary_spgemm_tpu_torch.bench.timing import event_ms
    from ternary_spgemm_tpu_torch.checkpoint import (
        _leaves, restore_sharded_pytree, save_sharded_pytree)
    from ternary_spgemm_tpu_torch.formats import TiledBitplane
    from ternary_spgemm_tpu_torch.models import (
        BitTransformerLM, make_lm_train_step, make_sharded_lm_train_step)
    from ternary_spgemm_tpu_torch.models.convert import _unflat
    from ternary_spgemm_tpu_torch.models.serving import (
        preset_config, random_ternary)
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
    from ternary_spgemm_tpu_torch.ops.fused_ffn import (
        fused_bitplane_swiglu, requantize_rows, swiglu_launch, swiglu_plain)
    from ternary_spgemm_tpu_torch.parallel import (
        column_sharded_spgemm, container_from_local_shard, init_distributed,
        make_mesh, overlapped_gather_spgemm, row_sharded_spgemm,
        tensor_parallel_fused_swiglu)
    from ternary_spgemm_tpu_torch.parallel.ffn import swiglu_local
    from ternary_spgemm_tpu_torch.parallel.spgemm import column_local, row_local

    x8 = "CudaTiledBitplane_x8"
    cfg7 = preset_config("bitnet7b")
    d, ff = cfg7.d_model, cfg7.d_ff
    gen = torch.Generator(device=dev).manual_seed(16)
    tern = lambda K, N: random_ternary(K, N, 2, gen, dev)
    W_qkv, W_o = tern(d, 3 * d), tern(d, d)
    W_g, W_u, W_d = tern(d, ff), tern(d, ff), tern(ff, d)
    f_qkv, f_o = TiledBitplane.from_dense(W_qkv), TiledBitplane.from_dense(W_o)
    f_g, f_u = (TiledBitplane.from_dense(W, tile_n=PAR_FFN_TILE)
                for W in (W_g, W_u))
    f_d = TiledBitplane.from_dense(W_d, tkb=PAR_FFN_TKB)
    b_qkv = torch.round(4.0 * torch.randn((3 * d,), generator=gen,
                                          device=dev))
    b_o = torch.round(4.0 * torch.randn((d,), generator=gen, device=dev))
    kw = dict(gamma_gate=0.03, gamma_up=0.03, gamma_down=0.03)
    xs = {M: torch.round(60.0 * torch.randn((M, d), generator=gen,
                                            device=dev)).clamp_(-127, 127)
          for M in PAR_ROWS}
    qs = {M: requantize_rows(torch.randn((M, d), generator=gen, device=dev))
          for M in PAR_ROWS}
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=dev)
    lo, hi = PAR_ROWS

    init_distributed(0, 1, f"tcp://127.0.0.1:{free_port()}", dev.type)
    try:
        check(dev.type != "cuda" or dist.get_backend() == "nccl",
              "the card's group is not NCCL")
        mesh = make_mesh({"model": 1}, device_type=dev.type)
        col = lambda M, f=f_qkv: column_sharded_spgemm(
            xs[M], f, b_qkv, mesh=mesh, axis="model", kernel=x8)
        row = lambda M, sc: row_sharded_spgemm(
            xs[M], f_o, b_o, mesh=mesh, axis="model", scatter_output=sc,
            kernel=x8)
        ring = lambda M: overlapped_gather_spgemm(
            xs[M], f_qkv, b_qkv, mesh=mesh, axis="model", kernel=x8)
        tp = lambda M: tensor_parallel_fused_swiglu(
            *qs[M], f_g, f_u, f_d, mesh=mesh, axis="model", **kw)

        # (a) the schemes, counted: the main path of this phase
        def schemes():
            return {"column": col(lo), "row": row(lo, False),
                    "row_scatter": row(lo, True), "ring": ring(hi),
                    "tp_lo": tp(lo), "tp_hi": tp(hi)}

        outs, counts = counted(schemes)
        want_c = {x8: 4, ck.X8_MMA_COUNT: 1,
                  "fused_bitplane_swiglu": 2, "fused_bitplane_swiglu/mma": 1}
        check(counts == want_c, f"the schemes launched {counts}, not "
              f"{want_c}")
        single = {
            "column": ck.cuda_tiled_bitplane_x8_kernel(xs[lo], f_qkv, b_qkv),
            "row": ck.cuda_tiled_bitplane_x8_kernel(xs[lo], f_o, b_o),
            "ring": ck.cuda_tiled_bitplane_x8_kernel(xs[hi], f_qkv, b_qkv),
            "tp_lo": fused_bitplane_swiglu(*qs[lo], f_g, f_u, f_d, **kw),
            "tp_hi": fused_bitplane_swiglu(*qs[hi], f_g, f_u, f_d, **kw)}
        single["row_scatter"] = single["row"]
        # a container whose leaves are DTensors from the rank's own shard
        # (on one rank the shard is all of W)
        f_dt = container_from_local_shard(f_qkv, mesh, "model", dim="N",
                                          K=d, N=3 * d)
        outs["local_shard"] = col(lo, f_dt)
        single["local_shard"] = single["column"]
        for k, y in outs.items():
            y = y.full_tensor()
            check(torch.equal(y, single[k]), f"the {k} scheme at d = 1 "
                  f"differs from the single-device call (max |diff| "
                  f"{float((y - single[k]).abs().max())})")
        sms = {k: event_ms(fn, flush=flush) for k, fn in (
            ("column", lambda: col(lo)), ("row", lambda: row(lo, False)),
            ("ring", lambda: ring(hi)), ("tp_hi", lambda: tp(hi)))}
        one = {k: event_ms(fn, flush=flush) for k, fn in (
            ("column", lambda: ck.cuda_tiled_bitplane_x8_kernel(
                xs[lo], f_qkv, b_qkv)),
            ("row", lambda: ck.cuda_tiled_bitplane_x8_kernel(xs[lo], f_o,
                                                             b_o)),
            ("ring", lambda: ck.cuda_tiled_bitplane_x8_kernel(
                xs[hi], f_qkv, b_qkv)),
            ("tp_hi", lambda: fused_bitplane_swiglu(*qs[hi], f_g, f_u, f_d,
                                                    **kw)))}
        print(f"parallel (a), NCCL group of 1, mesh model=1, bitnet7b "
              f"widths: column x8 QKV {lo}x{d}->{3 * d}, row x8 wo "
              f"{d}->{d} (all_reduce and reduce_scatter), ring at {hi} rows, "
              f"TP SwiGLU {d}->{ff}->{d} at {lo} and {hi} rows, the column "
              f"scheme over container_from_local_shard: each bitwise the "
              f"single-device call; launches {counts}; scheme vs single "
              f"call ms " + ", ".join(f"{k} {sms[k]:.4f}/{one[k]:.4f}"
                                      for k in sms) + f" [{card}]",
              flush=True)

        # (a) the sharded train step at phase 14's configuration
        cfg3 = dataclasses.replace(preset_config("bitnet3b"),
                                   n_layers=TRAIN_LAYERS)
        toks = torch.randint(0, cfg3.vocab, (TRAIN_BATCH, TRAIN_T),
                             generator=gen, device=dev)

        def steps(step, batch):
            losses, ms = [float(step(batch))], []
            for _ in range(2):
                s0 = torch.cuda.Event(enable_timing=True)
                s1 = torch.cuda.Event(enable_timing=True)
                s0.record()
                loss = step(batch)
                s1.record()
                s1.synchronize()
                ms.append(s0.elapsed_time(s1))
                losses.append(float(loss))
            return losses, ms

        mesh2 = make_mesh({"data": 1, "model": 1}, device_type=dev.type)

        def plain_and_sharded(cfg, toks):
            """Three Adam steps unsharded, then three sharded (SP, ZeRO-1)
            from the same init; returns the sharded model, the losses and
            the ms of both."""
            lm = BitTransformerLM(cfg, generator=gen, device=dev)
            init = {k: v.clone() for k, v in lm.state_dict().items()}
            plain, plain_ms = steps(make_lm_train_step(lm, torch.optim.Adam(
                lm.parameters(), lr=TRAIN_LR)), toks)
            del lm
            torch.cuda.empty_cache()
            lm = BitTransformerLM(cfg, generator=gen, device=dev)
            lm.load_state_dict(init)
            del init
            opt = torch.optim.Adam(lm.parameters(), lr=TRAIN_LR)
            step, place = make_sharded_lm_train_step(
                lm, opt, mesh2, sequence_parallel=True, zero1=True)
            sharded, sharded_ms = steps(step, place(toks))
            rel = max(abs(a - b) / abs(b) for a, b in zip(sharded, plain))
            check(rel <= PAR_TRAIN_TOL, f"sharded losses {sharded} against "
                  f"the unsharded {plain}")
            return lm, (sharded, plain, rel), (sharded_ms, plain_ms)

        lm, (sharded, plain, rel), (sharded_ms, plain_ms) = \
            plain_and_sharded(cfg3, toks)
        print(f"parallel (a) make_sharded_lm_train_step(sequence_parallel, "
              f"zero1) on a data 1 x model 1 mesh, bitnet3b widths, "
              f"{TRAIN_LAYERS} layers, batch {TRAIN_BATCH}x{TRAIN_T}, Adam "
              f"lr={TRAIN_LR}, f32: losses {sharded} against the unsharded "
              f"step's {plain} (max rel {rel:.3g}); step ms (steps 2-3) "
              f"sharded {[round(v, 3) for v in sharded_ms]}, unsharded "
              f"{[round(v, 3) for v in plain_ms]} [{card}]", flush=True)
        tree = _unflat(dict(lm.named_parameters()))
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            save_sharded_pytree(os.path.join(tmp, "params"), tree)
            t1 = time.perf_counter()
            back = restore_sharded_pytree(os.path.join(tmp, "params"), tree)
            t2 = time.perf_counter()
            nbytes = os.path.getsize(os.path.join(tmp, "params.shard0.npz"))
        same = all(b.placements == a.placements
                   and torch.equal(a.to_local(), b.to_local())
                   for a, b in zip(_leaves(tree), _leaves(back)))
        check(same, "restored parameters differ from the saved ones")
        print(f"parallel (a) save_sharded_pytree / restore_sharded_pytree "
              f"of the trained parameters: {nbytes / 2**30:.3f} GiB in "
              f"params.shard0.npz, byte-equal after the round trip; save "
              f"{t1 - t0:.2f} s, restore {t2 - t1:.2f} s (host clock, warm "
              f"page cache)", flush=True)
        del lm, tree, back
        torch.cuda.empty_cache()

        # (a) the sharded step over MoE blocks at phase 15's configuration
        # (the expert stacks' route, gather and combine on DTensors)
        cfg_m = moe_lm_config(MOE_TRAIN_LAYERS)
        toks = torch.randint(0, cfg_m.vocab, (MOE_TRAIN_BATCH, MOE_TRAIN_T),
                             generator=gen, device=dev)
        lm, (sharded, plain, rel), (sharded_ms, plain_ms) = \
            plain_and_sharded(cfg_m, toks)
        print(f"parallel (a) make_sharded_lm_train_step(sequence_parallel, "
              f"zero1) over MoE blocks ({MOE_EXPERTS} experts, top "
              f"{MOE_TOP_K}, {MOE_TRAIN_LAYERS} layers, batch "
              f"{MOE_TRAIN_BATCH}x{MOE_TRAIN_T}) on the data 1 x model 1 "
              f"mesh: losses {sharded} against the unsharded step's "
              f"{plain} (max rel {rel:.3g}); step ms sharded "
              f"{[round(v, 3) for v in sharded_ms]}, unsharded "
              f"{[round(v, 3) for v in plain_ms]} [{card}]", flush=True)
        del lm
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # (b) the shard shapes of d-way splits, rank by rank in this process
    def report(what, M, rank, shape, fn, f):
        bms, by = spmm_bound(M, f)
        ms = event_ms(fn, flush=flush)
        print(f"  {what} M={M} rank {rank}: {tuple(shape)} bitwise its "
              f"plain version; {ms:.4f} ms, bound {bms:.4f} ms ({by})",
              flush=True)

    for M in PAR_ROWS:
        x = xs[M]
        whole = lambda: ck.cuda_tiled_bitplane_x8_kernel(x, f_qkv, b_qkv)
        unsharded, parts = whole(), []
        w = 3 * d // PAR_QKV_D
        print(f"parallel (b) column x8 QKV over {PAR_QKV_D} ranks "
              f"({w} columns, tile_n {w}); unsharded {M}x{d}->{3 * d} "
              f"{event_ms(whole, flush=flush):.4f} ms, bound "
              f"{spmm_bound(M, f_qkv)[0]:.4f} ms [{card}]", flush=True)
        for r in range(PAR_QKV_D):
            cols = slice(r * w, (r + 1) * w)
            f = TiledBitplane.from_dense(W_qkv[:, cols], tile_n=w)
            y = column_local(x, f, b_qkv[cols], kernel=x8)
            yp = ck.bitplane_x8_plain(x, f, b_qkv[cols], None)
            check(torch.equal(y, yp), f"QKV rank {r} M={M}: kernel != plain")
            report("QKV column shard", M, r, y.shape, lambda: column_local(
                x, f, b_qkv[cols], kernel=x8), f)
            parts.append(y)
        check(torch.equal(torch.cat(parts, dim=1), unsharded),
              f"QKV M={M}: the columns assembled differ from the unsharded "
              "kernel")
        k = d // PAR_WO_D
        whole = lambda: ck.cuda_tiled_bitplane_x8_kernel(x, f_o, b_o)
        unsharded, total = whole(), None
        print(f"parallel (b) row x8 wo over {PAR_WO_D} ranks ({k} rows); "
              f"unsharded {M}x{d}->{d} {event_ms(whole, flush=flush):.4f} "
              f"ms, bound {spmm_bound(M, f_o)[0]:.4f} ms [{card}]",
              flush=True)
        for r in range(PAR_WO_D):
            rows = slice(r * k, (r + 1) * k)
            f = TiledBitplane.from_dense(W_o[rows])
            xr = x[:, rows].contiguous()
            y = row_local(xr, f, kernel=x8)
            yp = ck.bitplane_x8_plain(xr, f, torch.zeros(d, device=dev),
                                      None)
            check(torch.equal(y, yp), f"wo rank {r} M={M}: kernel != plain")
            report("wo row shard", M, r, y.shape,
                   lambda: row_local(xr, f, kernel=x8), f)
            total = y if total is None else total + y
        check(torch.equal(total + b_o, unsharded), f"wo M={M}: the partial "
              "sums in rank order plus the bias differ from the unsharded "
              "kernel (integer X: exact)")
        h = ff // PAR_FFN_D
        xq, sx = qs[M]
        ys, plains, flips, clean = [], [], 0, None
        whole = lambda: fused_bitplane_swiglu(xq, sx, f_g, f_u, f_d, **kw)
        print(f"parallel (b) TP SwiGLU over {PAR_FFN_D} ranks ({h} hidden, "
              f"gate/up tile_n {PAR_FFN_TILE}, down tkb {PAR_FFN_TKB}); "
              f"unsharded {M}x{d}->{ff}->{d} "
              f"{event_ms(whole, flush=flush):.4f} ms [{card}]", flush=True)
        for r in range(PAR_FFN_D):
            hid = slice(r * h, (r + 1) * h)
            fg = TiledBitplane.from_dense(W_g[:, hid], tile_n=PAR_FFN_TILE)
            fu = TiledBitplane.from_dense(W_u[:, hid], tile_n=PAR_FFN_TILE)
            fd = TiledBitplane.from_dense(W_d[hid], tkb=PAR_FFN_TKB)
            y = swiglu_local(xq, sx, fg, fu, fd, d, **kw)
            yk, hk, rk = swiglu_launch(xq, sx, fg, fu, fd, **kw)
            yp = swiglu_plain(xq, sx, fg, fu, fd, **kw)
            check(torch.equal(y, yk[:, :d]), f"SwiGLU rank {r} M={M}: the "
                  "local call differs from the kernel")
            nf, _, _, ck_r = swiglu_rule(yk, yp, hk, rk, xq, sx, fg, fu,
                                         f"SwiGLU rank {r} M={M}", **kw)
            flips += nf
            clean = ck_r if clean is None else clean & ck_r
            bms, by = bound(sum(weight_bytes(t) for t in (fg, fu, fd))
                            + 4 * (2 * M * d + M),
                            sum(spmm_ops(M, t) for t in (fg, fu, fd)))
            ms = event_ms(lambda: swiglu_local(xq, sx, fg, fu, fd, d, **kw),
                          flush=flush)
            print(f"  SwiGLU shard M={M} rank {r}: {ms:.4f} ms, bound "
                  f"{bms:.4f} ms ({by})", flush=True)
            ys.append(y)
            plains.append(yp[:, :d])
        got, want = ys[0] + ys[1], plains[0] + plains[1]
        if flips == 0:
            check(torch.equal(got, want), f"SwiGLU M={M}: the shards' sum "
                  "differs from the per-shard plain reference")
            how = "bitwise"
        else:
            # phase 3's rule on the sum: the rows with no flip in any
            # shard agree within rtol=1e-5, atol=0.01
            gc, wc = got[clean], want[clean]
            bad = (gc - wc).abs() > 0.01 + 1e-5 * wc.abs()
            check(not bool(bad.any()), f"SwiGLU M={M}: {int(bad.sum())} "
                  "summed outputs on the clean rows outside rtol=1e-5, "
                  "atol=0.01")
            err = float((gc - wc).abs().max()) if gc.numel() else 0.0
            how = (f"within phase 3 rule ({int(clean.sum())}/{M} clean "
                   f"rows, max |err| {err:.3g}) of")
        print(f"parallel (b) TP SwiGLU M={M}: the shards' sum {how} the "
              f"per-shard plain reference ({flips} hq flips) [{card}]",
              flush=True)
    del flush
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check runs only on "
              "the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import ternary_spgemm_tpu_torch as pkg
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    check(os.path.abspath(pkg.__file__).startswith(ROOT + os.sep),
          f"imported the port from {pkg.__file__}, not from {ROOT}")
    check("jax" not in sys.modules, "jax was imported")

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)

    from ternary_spgemm_tpu_torch.ops import _build
    _build.load()
    print(f"build: {_build.last_build['seconds']:.2f} s "
          f"({'compiled' if _build.last_build['built'] else 'cached'} "
          f"{os.path.relpath(_build.last_build['path'], ROOT)})", flush=True)

    from ternary_spgemm_tpu_torch.ops import fused_ffn
    from ternary_spgemm_tpu_torch.parallel import ring_kernel
    from ternary_spgemm_tpu_torch.tools import (
        decode_roofline, deposit_study, membench, ragged_probe)
    #: every hand-written kernel: name -> (its CUDA source, the TPU kernel
    #: it replaces)
    sources = {n: (s.source, s.reference) for n, s in spmm_kernels().items()}
    sources[fused_ffn.KERNEL_NAME] = (fused_ffn.SOURCE, fused_ffn.REFERENCE)
    sources[fused_ffn.FFN_KERNEL_NAME] = (fused_ffn.FFN_SOURCE,
                                          fused_ffn.FFN_REFERENCE)
    for mod in (membench, decode_roofline, deposit_study, ragged_probe,
                ring_kernel):
        sources[mod.KERNEL_NAME] = (mod.SOURCE, mod.REFERENCE)
    for src, _ in sources.values():
        check(os.path.isfile(os.path.join(ROOT, src)), f"no source {src}")
    seconds = {}

    def timed(phase, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[phase] = time.perf_counter() - t
        print(f"phase {phase}: {seconds[phase]:.1f} s", flush=True)
        return out

    stats = timed("3", phase_kernels, dev, card)
    timed("4", phase_model_parity, dev)
    serve_counts, lm, prompt, toks = timed("5", phase_serve, dev, card)
    more_counts = timed("5b", phase_serve_more, dev, card, lm, prompt, toks)
    del lm
    torch.cuda.empty_cache()
    stats.update(timed("6", phase_bench_kernels, dev, card))
    bench_counts = timed("7", phase_entry_point, dev)
    ffn_counts = timed("8", phase_ffn_bench, card)
    probe_stats, probe_counts = timed("9", phase_probes, dev, card)
    stats.update(probe_stats)
    ragged_stats, ragged_counts = timed("10", phase_ragged, dev, card)
    stats.update(ragged_stats)
    ring_stats, ring_counts = timed("11", phase_ring, dev, card)
    stats.update(ring_stats)
    serve3b_counts = timed("12", phase_serve_3b, dev, card)
    tune_counts = timed("13", phase_autotune, dev, card)
    train_counts = timed("14", phase_train, dev, card)
    moe_stats, moe_counts = timed("15", phase_moe, dev, card)
    stats["CudaTiledBitplane_x8"].update(moe_stats)
    par_counts = timed("16", phase_parallel, dev, card)
    check("jax" not in sys.modules, "jax was imported")
    print(f"phase seconds: {json.dumps(seconds)}", flush=True)

    runs = (serve_counts, more_counts, bench_counts, ffn_counts,
            probe_counts, ragged_counts, ring_counts, serve3b_counts,
            tune_counts, train_counts, moe_counts, par_counts)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": ref,
                "launches": sum(c.get(name, 0) for c in runs),
                **{k: stats[name][k] for k in ("max_abs_err", *keys)},
                **{extra: {k: stats[name][extra][k] for k in keys}
                   for extra in ("prefill", "u", "l", "moe", "moe_prefill")
                   if extra in stats[name]}}
               for name, (src, ref) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
