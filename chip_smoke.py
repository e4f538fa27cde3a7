#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/*/csrc`` with
nvcc (one compiler per source, all started together), holds each against its
plain PyTorch version on the card, then drives the port's paths (SVM
training, LM serving of every model family, LM training) through their
entry points and holds every run to its plain-version twin:

1. device, versions, kernel build times and the compiler's register report;
2. the hinge kernels against their plain version at the ``TestHinge``
   shapes and the blocks the SVM paths give them, as worker-major views
   (epsilon's (32, 64, 2,000) with a shared, a per-worker and a stride-0 w,
   webspam's (8, 64, 254), srdms's ijcnn1 (512, 22)), rtol 1e-4 / atol
   1e-5, two launches bitwise equal, each case's route checked (the cluster
   kernel for 16-byte rows of up to 2,048 columns, ``hinge.cu`` for the
   rest); with the time of each, the plain version's and the bound, and
   wherever the cluster kernel runs ``hinge.cu``'s time on the same inputs;
3. the SVM path: ``dms`` with 32 workers, block 64, 2 epochs on the epsilon
   stand-in (400,000 × 2,000), each epoch one CUDA graph replay (the first
   call captures, the next replays the capture ``dms`` kept), and the same
   with ``graphs=False``, bitwise equal; the main path's counted run, a
   first call under the profiler: the hinge launches the host makes (the
   capture records an epoch's), every one on the cluster kernel, and the
   cluster kernel's runs by the profiler (every epoch's: the kernels
   line's count), with its device activities a block; the epochs alone:
   the capture, each replay, the replays' idle share, the replays under
   the sync debug mode "error"; then (b) the SVM block ladder on the same
   data: ``dms_block_ladder``
   rungs (32, 64, 128), epoch 1 at 64, ``dms_ladder_switch``, epoch 2 at
   128, held to the plain-gradient chain (accuracy within 0.005, relative
   L2 1e-3), two kernel runs bitwise equal, the hinge launches exactly the
   blocks on the kernel ``kernel_for`` names; without a switch bitwise
   ``dms``; walls and idle shares of the ladder and of ``dms``; then
   ``dms_timed_steps`` at 64 into a ``BlockTelemetry`` and an
   ``AdaptiveController`` over the rungs (its T_step, T_sync and pick);
4. every ``dms`` mode on the webspam stand-in (350,000 × 254, K=8, block 64,
   one epoch), the graphed epoch bitwise the eager one in every mode but
   async gossip (which runs eagerly), ``srdms`` and ``seq_sgd`` on the
   ijcnn1 stand-in (n=4,000),
   the hinge launches all on ``hinge.cu`` (254 and 22 columns: rows no bulk
   copy can move), with ``hinge.cu``'s time at the blocks both hand it;
   then phase dist, model synchronization across processes that share
   the one card (``repro_torch.launch.mesh.spawn``, gloo; each rank's
   device, backend, host-staged ops and peak memory printed): (d1)
   ``dms(backend="dist")`` on epsilon across 8 ranks (block 64, one epoch),
   the model bitwise equal on every rank and held to the one-process
   ``dms(backend="vmap", workers=8)`` (relative L2 1e-3, accuracy 0.005),
   every hinge launch counted on each rank, all on the cluster kernel;
   (d2) the webspam modes (delayed, chunked, ring, pairwise, async
   pairwise held the same way, async gossip to the one-process stepper;
   async ring overflowing in both); (d3) ``dms_timed_steps`` across the 8
   ranks at blocks 16, 64, 256 and 1,024 (T_step a point, T_sync a block,
   the max over the ranks, the block ``choose_period`` picks), and the
   port's all-gather mean timed alone beside the reference's all-reduce
   on the same w; (d4) the
   local-SGD trainer on smollm-360m at its widths, its depth cut to 4 of
   32 layers for the time limit, across 2 ranks (H 4,
   int8, 1 × 2,048 tokens a replica step, 2 blocks) against the
   one-process trainer at K = 2 (losses, params, the first sync's int8
   payloads bitwise, 22 quant launches a block on each rank, the ranks'
   peaks under 75 GB together); (d5) hierarchical at smoke width on a
   (pod 2, data 2) mesh against the one-process periodic trainer at K = 2;
   (d6) ``dms(backend="dist")`` on an NCCL world of one rank against
   ``srdms`` (relative 1e-6), every hinge launch counted on ``hinge.cu``;
   then the adaptive path across ranks: (d7), on (d4)'s two ranks, the
   adaptive trainer on (d4)'s model (ladder (1, 2, 4) from H = 4): a
   scripted move 4 -> 2 after block 2 held bitwise on each rank to the
   one-process K = 2 run's replica (sha256 of every params, opt and sync
   leaf and of the first sync's int8 payloads and scales), then 6 blocks
   under the live controller (trajectory, T_step and T_sync as the max
   over the ranks, no compile after the warmup on any rank, 22 quant
   launches a block, the small all-reduces' count and time a block, the
   ranks' peaks under 75 GB together); (d8), on (d5)'s four ranks, phase
   (c) across ranks: a fault on rank 1 only after the first checkpoint
   and before it, each replay bitwise on every rank to phase (c)'s
   one-process run, checkpoints written by rank 0 only, a 2 s hold-up on
   rank 1 recorded by every rank's watchdog; (d9), on (d1)'s eight ranks,
   the SVM block ladder on epsilon (an epoch at 64, the switch, one at
   128) bitwise the one-process K = 8 ladder, every hinge launch on the
   cluster kernel, and (d3)'s block-64 times feeding a controller over the
   rungs on every rank, its pick agreed; ``--dist-only`` runs the build
   and this phase alone, with no result line;
5. the flash-attention kernels against their plain version: the f32
   split-TF32 kernel (wgmma, TMA) at the ``TestFlashAttention`` shapes and
   the three full-width f32 prefills, zamba2-1.2b's, smollm-360m's and
   llama32-3b's (rtol 1e-4 / atol 2e-5), each beside the f32 CUDA-core
   kernel and SDPA on the same inputs and both bounds (the function's
   flops on the TF32 tensor cores and on the f32 CUDA cores), and the
   split's own floor (three TF32 products) beside them; the bf16 tensor-core kernel (wgmma, TMA) at ragged, GQA,
   prefix and dh 32–256 cases and the serving paths' prefill shapes,
   smollm-360m's and zamba2-1.2b's, and phase families' (llama3.2-3b's,
   qwen3-moe's GQA group 16, phi3.5-moe's 32/8 heads of 128,
   paligemma-3b's dh 256 causal ∪ prefix,
   whisper's encoder and its cross-attention of 384 rows over 1,500 keys)
   (rtol 2**-7 / atol 1e-4, one bf16 ulp,
   a limit SDPA must fail at smollm's); inputs no TMA map can describe (an
   f32 q, k, v 4 bytes into a fused projection, bf16 at dh 70) on the
   CUDA-core kernel; each launch counted on the kernel it must take, with
   its time, the plain version's, the bound, and at the bf16 serving
   shapes SDPA's as a yardstick, the achieved TFLOP/s and the share of the
   bound;
6. the serving path: ``ServeEngine.generate`` on smollm-360m at full width
   (32 layers, bf16, seeded random weights), 4 prompts of 1,920 tokens and
   128 new tokens each, the decode step a CUDA graph replay, flash launches
   counted (one per layer per prefill, all on the tensor-core kernel); the
   same requests again (one capture over both calls) and through an engine
   with ``graphs=False``: tokens identical, the teacher-forced logits of the
   replayed step bitwise the eager step's; ms a step of each (the replays
   under the sync debug mode "error"), new tokens/s, peak memory, and the
   device busy time and idle share of 16 steps of each; the kernel path
   against the plain path (``attn_impl="torch"``); then one f32 prefill at
   full width, its 32
   flash launches all on the split-TF32 kernel, its logits held to the
   plain f32 path's at relative L2 1e-2, with its wall and idle share;
7. the int8 quant kernels against their plain version at the ``TestQuant``
   shapes, a K-batched (4, 1,000,003) case and the trainer's largest leaf
   (4, 78,643,200): int8 payload, scale, residual and dequantized values
   bitwise equal, round-trip error at most scale/2, two launches bitwise
   equal; with their time, the plain version's, ``torch.quantize_per_channel``
   / ``torch.dequantize``'s as a yardstick, and the bound; then leaves
   holding a NaN, +inf or −inf (alone, or one bad row among good ones),
   with and without the residual: bitwise the plain version's (NaN as NaN),
   scale NaN or inf, q 0, dequantized NaN, as the reference gives;
8. the LM trainer: local SGD on smollm-360m at its widths, its depth cut
   to 4 of 32 layers for the time limit (bf16 compute, f32 master params), K = 4 replicas, H = 4, int8 sync with error
   feedback, AdamW, 2 sequences of 2,048 tokens per replica a step: 2 blocks
   on the kernel path (quant launches counted: one quantize and one
   dequantize per leaf per sync) and 2 on the plain path from the same state
   and batches, held to each other (losses relative 1e-3, params relative L2
   1e-3) and the first sync's int8 payloads, scales and error-feedback
   residuals bitwise (the quantize launch the trainer makes, against the
   plain version a replica row at a time); then one profiled
   block, and 4 ``make_ddp_step`` steps (MSF = 1) at the same global batch;
   then (a) the adaptive trainer on the same model: ``sync.adaptive`` over
   the ladder (1, 2, 4) from H = 4, one forced switch after block 1 held
   bitwise to ``ladder_switch_state`` of the pre-switch snapshot and the
   next block bitwise to a fresh ``make_train_step`` from the switched
   snapshot, then 8 blocks through ``StepRunner`` (checkpoints off): the H
   trajectory, walls and trained tokens/s per rung, the telemetry's
   T_step / T_sync, no compile after the ladder's warmup, 22 quant
   launches a block, peak memory under 75 GB and one profiled block; and
   (c) fault and restart at smoke width (int8 on the quant kernel, a
   scripted move 2 → 1, checkpoints every 3 blocks): a fault after the
   checkpoint and one before it both replay bitwise the run without one;
9. every other sync mode (delayed, chunked, ring, pairwise, async ring,
   int16) at smoke width, kernel path against plain path; then phase
   train_ssm, training the SSM and hybrid families through
   ``build_trainer``: (t1) zamba2-1.2b at full width, its depth cut to 6
   of 38 layers for the time limit (the shared block after the sixth),
   local SGD with K = 2, H = 4, the int8 sync on the
   quant kernel and ``remat="full"``, 4 × 2,048 tokens a microbatch (2
   sequences a replica step), 2 blocks, then the plain path from the same
   state and batches: held as phase 8 holds smollm (losses relative 1e-3,
   params relative L2 1e-3), the first sync's int8 payloads, scales and
   residuals bitwise, quant launches ``2 × leaves × blocks`` (their count
   on a line of its own), peak memory under 75 GB, with the block wall, trained
   tokens/s, sync ms a block and one profiled block's idle share; (t2)
   mamba2-2.7b at full width (64 layers) on one replica, every step
   synchronized (MSF = 1), ``remat="full"``, 2 steps of 2 × 2,048 tokens:
   finite losses, step wall, tokens/s, peak memory under 75 GB; (t3) one
   loss and gradient at full width with the depth cut to 4 layers
   (zamba2's to 6, the period of its shared block) under ``remat="none"``
   against ``"full"`` (and ``"dots"`` for smollm-360m), bitwise or within
   relative 1e-6 with the leaves named, the peak memory of each; and
   ``ssd_chunked``'s checkpointed chunks against the unchecked loop at
   mamba2's width, one layer, bitwise;
10. the SSD chunk-scan kernels: the CUDA-core one (``ssd.cu``) against the
    exact recurrence at the ``TestSSD`` shapes in f32 (rtol 1e-3 / atol
    2e-4); the tensor-core one (``ssd_tc.cu``) at the same shapes in bf16
    against the exact recurrence on the same inputs (state rtol 1e-3 / atol
    2e-4, y rtol 2**-7 / atol 2e-4) and at the two serving prefill shapes
    against the plain chunked scan (y within rtol 2**-7 / atol 2e-4, the
    f32 state within the f32 bound); each launch counted on the kernel it
    must take, two launches bitwise equal; with the time of each, the
    chunked scan's and the bound, and at the serving shapes the CUDA-core
    kernel's time on the same bf16 inputs;
11. the SSM serving path: ``ServeEngine.generate`` on mamba2-2.7b at its
    widths, its depth cut to 8 of 64 layers for the time limit (bf16,
    seeded random weights), 4 prompts of 1,920
    tokens and 128 new tokens each, graph against eager as in 6, SSD
    launches counted (one per layer per
    prefill, all on the tensor-core kernel in bf16 and none of them in f32;
    decode runs the plain recurrence step), and the kernel path against
    the plain path (``ssd_impl="torch"``): in bf16 layer 0's cache held
    (conv tails bitwise, the SSM state within the SSD bound); in f32,
    prefill and 16 teacher-forced decode steps' logits within relative L2
    1e-2; and the bf16 kernel path's logits (prefill and those 16 steps)
    within 1.5× the bf16 plain path's own relative L2 to the f32 plain
    path;
12. the hybrid serving path: the same, graph against eager too, on
    zamba2-1.2b at its widths, its depth cut to 12 of 38 Mamba2 layers for
    the time limit (the shared attention block after every 6: 12 SSD and 2
    flash launches per prefill, on the tensor-core kernels in bf16; in f32
    the SSD ones on ``ssd.cu`` and the flash ones on the split-TF32
    kernel);
13. phase families, every other family the port serves, each at full
    width in bf16 on seeded weights drawn leaf by leaf, 4 requests: the
    dense llama3.2-3b, internlm2-1.8b and qwen2.5-3b (1,920 prompt tokens
    + 16 new); the MoE phi3.5-moe (depth cut to 8 of 32
    layers) and qwen3-moe (4 of 94), 1,920 + 16; the prefix-LM VLM
    paligemma-3b (seeded patches of 256 positions + 1,920 + 16); the
    encoder-decoder whisper-base (seeded frames of 1,500, 384 + 64). Each
    as phase 6 holds smollm: ``generate`` with graph replays, flash
    launches counted a prefill (one an attention, whisper's three a
    layer, all on the bf16 tensor-core kernel), peak memory under 75 GB, a
    second call with no capture, and engines with ``graphs=False`` and on
    the plain path on the same copy of the weights: tokens identical,
    teacher-forced logits bitwise graph against eager, the kernel path
    against the plain path at relative L2 0.1 for every model (an MoE's
    routing agreement by layer printed); each MoE also in f32 at depth 4,
    the split-TF32 kernel path against the plain path at relative L2 1e-2.
    Before them, equal gates over 16 and 128 experts route on the card to
    experts 0..k-1, as the reference's top-k picks them;
14. phase mesh_serve, serving on a (data 2, model 2) process mesh of 4 gloo
    ranks that share the card: ``ServeEngine(mesh=)`` on phi3.5-moe at its
    published widths, its depth cut to 1 of 32 layers for the time limit, each
    rank drawing every leaf from the seed and keeping its shards of every
    weight as the serving rules split it (the attention's 32 / 8 heads, the
    router and the expert and embedding tables over model, each d_model dim
    over data; the cache's sequence), the layers tensor and sequence parallel;
    the main path's counted run, a bf16 ``generate`` of 16 prompts of 2,048
    tokens (T = 32,768: the vocab-parallel embedding and the all-to-all MoE
    once a layer) and 8 new tokens (the one-hot MoE once a layer a step, the
    seq-sharded decode attention), 1 flash launch a layer a rank on the bf16
    tensor-core kernel, on its 16 of 32 query heads; then in bf16 and in f32
    the prefill and 8 steps teacher-forced on the one-process f32 engine's
    tokens, held to the one-process engine at the same depth, seed and prompts
    (f32 logits within relative L2 1e-3 and the same argmax at every position,
    against a one-process run of the sharded capacity rule where slots drop;
    bf16 within 0.1), the slots dropped on both paths, the paths taken, the
    walls beside the one-process engine's, each collective's ms and bytes by op
    (a weight's FSDP gather apart), the host-staged ops, the weight bytes a
    rank against the whole model's and the peaks a rank;
15. phase mesh_families, serving the SSM, hybrid, VLM and audio families on the
    same mesh of 4 gloo ranks (one spawn for the four models):
    ``ServeEngine(mesh=)`` at their published widths, mamba2-2.7b cut to 4 of
    64 layers, zamba2-1.2b to 6 of 38 (one application of its shared block),
    paligemma-3b to 2 of 18, whisper-base whole (6 + 6), each rank drawing
    every leaf from the seed and keeping its shards of every weight as the
    serving rules split it (the attention's heads, the MLP's columns, the
    Mamba2 mixers' heads, the vocab over model, each d_model dim over data; the
    attention caches' sequence where it tiles the model axis: the self caches
    by ``max_len``, rounded up to a multiple of 2, and whisper's 1,500-frame
    cross cache; the Mamba2 state and x conv tails by heads), the layers tensor
    and sequence parallel; the main path's counted run, a bf16 ``generate`` of
    16 prompts of 2,048 tokens (T = 32,768: the vocab-parallel embedding;
    paligemma's 256 seeded patch positions before them) or whisper's 16 of 384
    over 1,500 seeded frames (its odd vocab held whole, the masked lookup over
    data), 8 new tokens, with the flash and SSD launches a rank on their routes
    (all on the bf16 tensor-core kernels, each on the rank's half of the heads;
    its prefill timed, counted and kept), and in f32 the prefill and 8 steps
    teacher-forced on the one-process f32 engine's tokens, held to the
    one-process engine at the same depth, seed, prompts and extras (f32 logits
    within relative L2 1e-3 and the same argmax at every position, on
    ``flash_attention_tc32.cu`` for zamba2 and whisper, ``flash_attention.cu``
    for paligemma's head dim 256 and ``ssd.cu``; bf16 within 0.1), the walls
    beside the one-process engine's (a bf16 step: the counted ``generate``'s
    wall less the prefill's, over its steps), each collective's ms and bytes by
    op (a weight's FSDP gather apart), the host-staged ops, the weight bytes a
    rank against the whole model's and the peaks a rank; ``--mesh-serve-only``
    runs the build and phases mesh_serve and mesh_families alone, with no
    result line;
16. phase mesh_train, training on a process mesh of 4 gloo ranks that
    share the card, phi3.5-moe at its published widths, its depth cut to 1
    of 32 layers, f32, remat full, (m1) AdamW and (m2) sgd (the MTRAIN
    comment), each rank drawing every leaf from
    the seed and keeping its shard of every leaf as the reference's
    training rules split it (the attention's 32 / 8 heads, the router and
    the expert, embedding and output tables over model, each d_model dim
    over data), its moments and sync state alike, the layers tensor and
    sequence parallel under autograd, the CE vocab-parallel: (m1)
    ``build_trainer``'s DDP step on (data 2,
    model 2), 32 x 1,024 tokens a step (T = 32,768: the all-to-all
    MoE and the vocab-parallel embedding), 1 step, held to the
    one-process ``make_ddp_step`` under the sharded capacity rule (losses
    and aux relative 1e-3, the params put back together relative L2
    1e-3), the paths a rank, the slots dropped, each collective's ms and
    bytes, the weight bytes and the peaks a rank, the walls beside the
    twin's; (m2) the
    local-SGD block on (pod 2, data 1, model 2), K = 2, H = 2, the int8
    sync on each rank's shards, 2 x
    2,048 tokens a replica step (the one-hot MoE), 2 blocks, held to the
    one-process K = 2 block the same way; its first sync's int8 payloads
    each rank's block of the quant kernel's whole-leaf quantization of the
    same values, bitwise, and within one int8 step of the twin's; each
    gradient leaf's norm at the first step within 1e-3 of the twin's (both
    parts); quant
    launches a rank 2 x leaves x blocks, the amax and the pack given it
    once a split leaf a block (every leaf but those the rules hold whole);
    the sync's ms (CUDA events); then the shard path's quant entry points
    against their plain version at the main path's expert and
    query-projection blocks, the expert block timed beside it and a
    PyTorch call; ``--probe-train-adamw`` runs the build and (m1) and
    paligemma's (n1) on the 4 ranks alone (each run's losses, weight
    bytes and peak a rank, or its error), with no result line;
17. phase mesh_train_families, mesh_train's two parts on the SSM, hybrid,
    VLM and audio families (MTF_RUNS) at their published widths, f32,
    remat full, (n1) AdamW, (n2) AdamW for mamba2 and whisper and sgd
    for paligemma:
    mamba2-2.7b cut to 2 of 64 layers, zamba2-1.2b to 6 of 38
    (one application of its shared block), paligemma-3b to 2 of 18,
    whisper-base whole (6 + 6); the
    one-process twins first, then every part of every family in one spawn
    of 4 gloo ranks on the card, each rank drawing every leaf from the
    seed and keeping its shard of every leaf as mesh_train's do (the
    attention's heads, the MLP's columns, the Mamba2 mixers' heads, the
    vocab over model where they divide, each d_model dim over data; the
    layers tensor and sequence parallel, the CE vocab-parallel on the
    table's shard), the stub inputs seeded on the global batch before a
    rank takes
    its rows (``SeededExtras``): (n1) ``build_trainer``'s DDP step on
    (data 2, model 2), one step, and (n2) the local-SGD block on (pod 2,
    data 1, model 2), K = 2, H = 2, int8, 2 blocks (paligemma's 1; zamba2
    has none, for the time limit), each held to its twin as mesh_train's
    parts are (losses and the params put back together relative 1e-3,
    ranks that hold a block bitwise alike,
    the first step's gradient norms a leaf, (n2)'s first sync's payloads
    within one int8 step of the twin's under sgd and under AdamW within
    what AdamW makes of the first block's gradients, which are held to the
    twin's blocks at relative L2 1e-3 (``_payload_against_twin``), its
    quant launches a rank: the amax and the pack given it on every split
    leaf's block, the whole-leaf pack on every leaf held whole,
    whisper's odd-vocab table too); the walls beside the twins', each
    collective's ms and bytes, the sync's ms, the weight bytes and the
    peaks a rank;
    ``--probe-vlm-t32k`` runs the build and paligemma's (n1) at
    VLM_PROBE_SHAPES alone (T >= 32,768), each run's peak or its error,
    with no result line;
18. phase tooling: (t1) the roofline of three whole calls, each counted by
    ``repro_torch.launch.roofline.WorkCounter`` in a run apart from its
    phase's timed ones: the epsilon ``dms`` call of phase 3 with
    ``graphs=False`` (a replay hides its ops; against the median of 3
    timed eager calls), the bf16 smollm-360m prefill of phase 6 (against
    its median of 3) and one train block of phase 8 (against block 2's
    wall): products by dtype, bytes, the eager ops' bound and what sets
    it, mfu and the share of that bound (the prefill also counted on the
    meta device, as the dry run counts it), the kernels' records held equal
    to the launches
    the phase counted (312 hinge, 32 flash, 11 quantize and 11 dequantize);
    (t2) ``repro_torch.simsync`` on uniform profiles of phase (b)'s and
    (d3)'s measured T_step and T_sync (latencies: no bytes term), each
    with ``oracle_h``, ``choose_period``'s pick and the controller's
    trajectory, and the four built-in profiles' replay digests held to the
    CPU's; (t3) the dry run of every arch × cell on one card and the two
    reference meshes, on the meta device in a worker process a CPU core,
    started as the phase starts: the count of ok / skip / error (an error
    fails), each cell's fits_80g and bound.

The line before the last is the kernels' JSON record (seven entries: the
flash route twice, bf16 and f32, and quant's shard path's two entry points
beside its whole-leaf pair; the bf16 flash and the SSD entries also carry
``mesh_families_launches``, phase mesh_families's counted launches a rank
over its four models, and the three quant entries
``mesh_train_families_launches``, phase mesh_train_families' counted
launches over its ranks); the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that line. Without CUDA it exits 1 at once. It imports
no JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

# the H100 terms, named once in the port (NVIDIA's H100 SXM data sheet)
from repro_torch.launch.roofline import BF16_FLOPS as BF16_FLOPS_PER_S  # noqa: E402,E501
from repro_torch.launch.roofline import F32_FLOPS as FP32_FLOPS_PER_S  # noqa: E402,E501
from repro_torch.launch.roofline import compute_s  # noqa: E402
L2_BYTES = 50 * 2 ** 20
RTOL, ATOL = 1e-4, 1e-5       # tests/test_kernels.py::TestHinge
# tests/test_kernels.py::TestQuant's shapes (one scale each), then stacked
# rows (one scale each): a ragged K-batched case and the trainer's largest
# leaf, mlp.w_up of smollm-360m (32 · 960 · 2,560) for K = 4 replicas
QUANT_SHAPES = [((100,), False), ((33, 7), False), ((2, 3, 5), False),
                ((4096,), False), ((128, 128), False),
                ((4, 1_000_003), True)]
QUANT_MAIN = ((4, 32 * 960 * 2560), True)
# trainer, kernel path against plain path: the two differ only where CUDA's
# embedding backward (atomics) makes a rounding flip in a gradient and a
# later int8 value moves one step; a wrong scale or sync is O(1)
TRAIN_LOSS_REL, TRAIN_PARAMS_REL_L2 = 1e-3, 1e-3
TRAIN_K, TRAIN_H, TRAIN_SEQ, TRAIN_BATCH = 4, 4, 2048, 8
# phases 8 and (a): smollm-360m at its widths, the depth cut from 32 to this
# many layers for the script's time limit (8 for phase mesh_train's room,
# then 4 for phase mesh_families')
TRAIN_DEPTH = 4
# phase train_ssm: (t1) zamba2-1.2b, K = 2, H = 4, 2 sequences a replica
# step; (t3) remat at full width, the depth cut to this many layers
TRAIN_SSM_K, TRAIN_SSM_H, TRAIN_SSM_BATCH = 2, 4, 4
# (t1)'s zamba2-1.2b cut from 38 to 6 of its layers (one shared block)
# for the script's time limit
TRAIN_SSM_T1_DEPTH = 6
REMAT_DEPTH = 4
TRAIN_SSM_PEAK_GB = 75.0
# phase train_families, at published widths: (f1) whisper-base, K = 4,
# H = 4, 8 sequences of its 448-token context (1,500 seeded frames each) a
# replica step; (f2) phi3.5-moe with its depth cut to FAM_MOE_LAYERS, one
# replica, 2 x 2,048 tokens a step: its local SGD at K = 2 runs out of the
# card's memory at one layer, at 2 and at 4 sequences a replica step (on an
# H100 80GB HBM3, 700 W: scripts/train_peak_memory.py --arch
# phi3.5-moe-42b-a6.6b --layers 1 --replicas 2 --batch 4|2 --remat full);
# (f3) paligemma-3b, one replica, 2 x (256 seeded patches + 1,920 text
# tokens) a step
FAM_AUDIO_K, FAM_AUDIO_H, FAM_AUDIO_BATCH, FAM_AUDIO_SEQ = 4, 4, 8, 448
FAM_MOE_LAYERS, FAM_MOE_BATCH = 2, 2
FAM_VLM_TEXT = 1920
W_REL_L2, ACC_DIFF = 1e-3, 0.005
HINGE_SHAPES = [(8, 8), (100, 22), (257, 254), (512, 2000), (64, 128), (33, 7)]
# tests/test_kernels.py::TestFlashAttention: (b, sq, sk, h, kv, dh, causal,
# prefix), f32 at rtol 1e-4 / atol 2e-5, and its bf16 case
FLASH_SHAPES = [(1, 128, 128, 4, 2, 64, True, 0),
                (2, 256, 256, 8, 8, 128, True, 0),
                (1, 200, 200, 6, 2, 64, True, 0),
                (1, 128, 128, 4, 1, 64, True, 32),
                (2, 64, 300, 4, 4, 64, False, 0),
                (1, 512, 512, 2, 2, 32, True, 0)]
FLASH_BF16 = (1, 128, 128, 4, 2, 64, True, 0)
# bf16 on the tensor-core kernel besides the serving shapes: ragged S/T,
# GQA groups 1, 3 and 4, causal ∪ prefix, non-causal prefix, dh 32 to 256
FLASH_TC_SHAPES = [(1, 200, 300, 4, 2, 64, False, 0),
                   (1, 1000, 1000, 6, 2, 64, True, 0),
                   (1, 300, 300, 9, 3, 64, True, 0),
                   (1, 256, 256, 4, 1, 64, True, 40),
                   (1, 192, 320, 4, 2, 64, False, 100),
                   (1, 512, 512, 2, 2, 32, True, 0),
                   (1, 70, 100, 3, 3, 96, False, 0),
                   (2, 256, 256, 8, 8, 128, True, 0),
                   (1, 300, 300, 4, 1, 256, True, 0)]
# the serving path's prefill: smollm-360m, 4 prompts of 1,920 tokens; and
# zamba2-1.2b's shared attention block on the same prompts
FLASH_MAIN = (4, 1920, 1920, 15, 5, 64, True, 0)
FLASH_HYBRID = (4, 1920, 1920, 32, 32, 64, True, 0)
# the f32 prefills on the split-TF32 kernel at full width: zamba2-1.2b's
# shared block (the f32 route's kernels-line row), smollm-360m's and
# llama32-3b's (24/8 heads of 128, src/repro/configs/llama32_3b.py)
FLASH_F32_FULL = [FLASH_HYBRID, FLASH_MAIN,
                  (4, 1920, 1920, 24, 8, 128, True, 0)]
# bf16 prefill shapes of the families phase: llama3.2-3b's (24/8 heads of
# 128), qwen3-moe's (GQA group 16), phi3.5-moe's (32/8 heads of 128),
# paligemma-3b's (one KV head of 256,
# causal ∪ its 256 image positions over 256 + 1,920 positions), whisper's
# encoder (1,500 frames, full) and its decoder's cross-attention (384
# tokens over the 1,500 frames)
FLASH_FAMILY_SHAPES = [(4, 1920, 1920, 24, 8, 128, True, 0),
                       (4, 1920, 1920, 64, 4, 128, True, 0),
                       (4, 1920, 1920, 32, 8, 128, True, 0),
                       (4, 2176, 2176, 8, 1, 256, True, 256),
                       (4, 1500, 1500, 8, 8, 64, False, 0),
                       (4, 384, 1500, 8, 8, 64, False, 0)]
# bf16: the kernel and the plain version both compute in f32 and round only
# the output, so they differ by a rounding flip, at most one bf16 ulp
# (rtol 2**-7 is at least one ulp of any value), and near zero by the two
# f32 sums' difference (~1e-7). A version that rounds the probabilities to
# bf16, as SDPA does, fails this limit at the main shape, and must.
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-4
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 1920, 128
# kernel path against plain path, relative L2 of the logits: the plain path
# rounds scores and probabilities to bf16 in every layer, the kernel keeps
# them in f32; on the CPU at full width and 32 layers (256 tokens) the two
# are 0.037 apart, and a wrong mask or softmax is O(1)
LOGITS_REL_L2 = 0.1
# tests/test_kernels.py::TestSSD: (b, l, h, p, n, chunk), f32 against the
# exact recurrence at its bound rtol 1e-3 / atol 2e-4 (the chunked form sums
# and exponentiates in another order than the recurrence)
SSD_SHAPES = [(1, 128, 2, 64, 128, 64), (2, 256, 4, 64, 128, 128),
              (1, 200, 2, 64, 64, 128), (1, 512, 1, 128, 128, 256),
              (2, 64, 3, 32, 16, 32)]
SSD_F32_TOL = dict(rtol=1e-3, atol=2e-4)
# the serving prefills, bf16 x/B/C: mamba2-2.7b (the main path) and
# zamba2-1.2b, 4 prompts of 1,920 tokens, chunk 256, against the plain
# chunked scan on the same inputs: both compute in f32 and round only y, so
# y differs by a rounding flip (rtol 2**-7, one bf16 ulp) and near zero by
# the f32 sums' difference; the f32 state within the f32 bound
SSD_MAIN = (4, 1920, 80, 64, 128, 256)
SSD_PREFILLS = [SSD_MAIN, (4, 1920, 64, 64, 64, 256)]
SSD_BF16_Y_TOL = dict(rtol=2 ** -7, atol=2e-4)
# kernel path against plain path of the SSM and hybrid serving, relative L2
# of the logits. The two differ by the SSD's f32 sum order. In bf16 that
# flips roundings of y in every layer, and a deep random-weight model
# amplifies the flips: on the CPU at full width the two paths (the kernel
# path is the exact recurrence there) were 0.026–0.043 apart over 8 mamba2
# layers and 0.080–0.101 over 24, growing with depth, so the bf16 paths are
# not held to each other. In f32 the same comparison was 7.6e-6–2.5e-5
# apart over 8 mamba2 layers, 4.9e-5–1.0e-4 over 24 and 5.7e-5–1.3e-4 over
# 12 zamba2 layers, so f32 logits are held to 1e-2; a wrong mask or decay is
# O(1).
SSM_F32_LOGITS_REL_L2 = 1e-2
# each bf16 path against the f32 plain path on the same weights (prefill
# and the f32 run's teacher-forced decode steps, relative L2 over all their
# logits): the kernel path within this factor of the plain path's own
# distance. Both round every activation to bf16 and differ from f32 by
# like amounts: on an H100 80GB HBM3 (700 W) the kernel and plain paths
# were 0.525 and 0.509 from f32 at mamba2-2.7b (1.03x) and 0.389 and 0.377
# at zamba2-1.2b (1.03x). A subtly wrong kernel lands O(1) away (unrelated
# logits of equal norm are ~1.4 apart), above 1.5 x 0.509 = 0.76.
SSM_BF16_VS_F32_FACTOR = 1.5
# phases 11 and 12: mamba2-2.7b and zamba2-1.2b served at their widths with
# the depth cut from 64 and 38 to these many layers (zamba2's two shared
# blocks) for the script's time limit (phase mesh_train's room; mamba2 from
# 16 to 8 for phase mesh_families')
SSM_SERVE_DEPTH, HYBRID_SERVE_DEPTH = 8, 12
# phase families: (arch, layers kept (None: all), prompt tokens, new tokens)
# a request, 4 requests; an MoE's f32 check at MOE_F32_DEPTH layers over
# MOE_F32_STEPS decode steps
FAMILY_RUNS = [("llama3.2-3b", None, 1920, 16),
               ("internlm2-1.8b", None, 1920, 16),
               ("qwen2.5-3b", None, 1920, 16),
               ("phi3.5-moe-42b-a6.6b", 8, 1920, 16),
               ("qwen3-moe-235b-a22b", 4, 1920, 16),
               ("paligemma-3b", None, 1920, 16),
               ("whisper-base", None, 384, 64)]
FAMILY_PEAK_GB = 75.0
MOE_F32_DEPTH, MOE_F32_STEPS = 4, 16
# phase dist: K ranks on the one card, gloo between them
DIST_K, DIST_BS, DIST_EPOCHS = 8, 64, 1
DIST_MODES = [("delayed", "all", False), ("chunked", "all", False),
              ("none", "ring", False), ("none", "pairwise", False),
              ("none", "pairwise", True), ("none", "ring", True)]
DIST_TIMED_BS, DIST_TIMED_BLOCKS = (16, 64, 256, 1024), 12
# (d3)'s collectives alone: calls of each, in turns, after one warm-up
DIST_COLL_CALLS = 50
DIST_TRAIN_K, DIST_TRAIN_H, DIST_TRAIN_BLOCKS = 2, 4, 2
# (d4) and (d7): smollm-360m at its widths, the depth cut from 32 to this
# many layers for the script's time limit (phase mesh_train's room)
D4_DEPTH = 4
DIST_PEAK_GB = 75.0
# phase mesh_serve: phi3.5-moe cut to 1 of its 32 layers for the time
# limit (2 until phase mesh_train came), 16 prompts of 2,048 tokens (T = 32,768, the all-to-all path's
# threshold) and 8 new tokens on a (data 2, model 2) mesh of gloo ranks
MESH_SHAPE = (2, 2)
MESH_ARCH, MESH_DEPTH = "phi3.5-moe-42b-a6.6b", 1
MESH_BATCH, MESH_PROMPT, MESH_GEN, MESH_SEED = 16, 2048, 8, 7
MESH_F32_REL_L2 = 1e-3
# phase mesh_families: the SSM, hybrid, VLM and audio families at their
# published widths on the same mesh, each (arch, layers kept of its depth for
# the time limit or None for all, prompt tokens): 16 x 2,048 (T = 32,768,
# the vocab-parallel lookup's threshold; paligemma's 256 seeded patch
# positions before them) or whisper's 16 x 384 over 1,500 seeded frames, 8
# new tokens each
MFAM_RUNS = [("mamba2-2.7b", 4, 2048), ("zamba2-1.2b", 6, 2048),
             ("paligemma-3b", 2, 2048), ("whisper-base", None, 384)]
MFAM_BATCH, MFAM_GEN, MFAM_SEED = 16, 8, 17
# phase mesh_train: phi3.5-moe at its published widths cut to 1 of its 32
# layers, f32, remat full, 4 gloo ranks on the card. (m1) takes AdamW (lr
# 1e-4, eps 1e-6): with every leaf split the four ranks hold its moments
# (15.06 GiB a rank, 64.70 GB in all, on an H100 80GB HBM3 at 700 W, where
# with the dense leaves whole on every rank a rank ran out at 17.51 GiB
# asking 1 GiB more). (m2) takes sgd lr 0.1 (the reference's own mesh
# test's optimizer). Every part's first gradient is held to the twin's leaf
# by leaf (its norm); a sgd part's first sync's payloads within one int8
# step of the twin's, an AdamW part's within what AdamW makes of the two
# gradients (_payload_against_twin). (m1) DDP on (data 2, model 2), 32 x 1,024
# tokens a step (T = 32,768: moe_ffn_sharded and embed_sharded; at 16 x
# 2,048 a rank's plain attention ran out too, at 17.27 GiB asking 0.78 GiB
# more with 77.81 GiB in use), 1 step (2 until phase mesh_families came);
# (m2) local SGD on (pod 2, data 1, model 2), K = 2, H = 2, int8, 2 x 2,048
# tokens a replica step (the one-hot MoE), 2 blocks; each held to its
# one-process twin at the trainer's bounds
MTRAIN_DEPTH, MTRAIN_REL = 1, 1e-3
# (sequences, tokens a sequence) a step, over all ranks
MTRAIN_M1_MESH, MTRAIN_M1_SHAPE, MTRAIN_M1_STEPS = (2, 2), (32, 1024), 1
MTRAIN_M2_MESH, MTRAIN_M2_SHAPE = (2, 1, 2), (4, 2048)
MTRAIN_M2_H, MTRAIN_M2_BLOCKS = 2, 2
# phase mesh_train_families: mesh_train's (m1) and (m2) on the SSM, hybrid,
# VLM and audio families at their published widths, depths cut, f32, remat
# full, 4 gloo ranks on the card in one spawn: (arch, layers or None for
# all, (n1)'s and (n2)'s (sequences, tokens a sequence) a step over all
# ranks, (n2)'s blocks, (n2)'s optimizer: AdamW lr 1e-4, eps 1e-6, as
# every (n1), or sgd lr 0.1, as (m2)). (n1) takes T = 32,768 tokens (the vocab-parallel
# lookup), but paligemma 8 x 4,320 (T = 34,560 after 256 seeded patch
# positions: its CE chunk of 480 divides the text; at 32 x 1,024 it does
# not, and every rank's unchunked whole-vocab logits ran the card out of
# memory, as did the twin's; at 8 x 4,320 the four ranks peaked at 68.39
# GB) and whisper 16 x 448 over 1,500 seeded frames; (n2) 2 sequences a
# replica step. paligemma's (n1) AdamW fits now (10.04 GiB a rank, 43.12
# GB in all, where its whole dense leaves reached 75.30 GB); its (n2) keeps
# sgd, so that one family part holds sgd's local SGD too. For the script's
# time limit
# paligemma's (n2) takes one block (its tied table's transport made a
# block 21-25 s) and zamba2 has no (n2) (None): the CPU test holds its
# local SGD on the mesh to the reference, and mamba2's (n2) runs the same
# Mamba2 layers here
MTF_RUNS = [("mamba2-2.7b", 2, (16, 2048), (4, 2048), 2, "adamw"),
            ("zamba2-1.2b", 6, (16, 2048), None, 0, None),
            ("paligemma-3b", 2, (8, 4320), (4, 1920), 1, "sgd"),
            ("whisper-base", None, (16, 448), (4, 448), 2, "adamw")]
MTF_SEED = 29
# --probe-vlm-t32k: paligemma-3b's (n1) of MTF_RUNS at these (sequences,
# text tokens a sequence) a step, T >= 32,768 (the vocab-parallel lookup):
# 32 x 1,024 (the CE unchunked: 480 does not divide 1,024) and 8 x 4,320
# (nine chunks of 480)
VLM_PROBE_SHAPES = [(32, 1024), (8, 4320)]
# (d7): the adaptive trainer across the two ranks: a scripted move 4 -> 2
# after block 2 over 3 blocks, then blocks under the live controller
D7_SCRIPT, D7_SCRIPTED_BLOCKS, D7_LIVE_BLOCKS = {2: 2}, 3, 6
# (d8): fault and restart across 4 ranks; rank 1 held up this long before
# the last step of the straggle run (the deadline is half of it)
D8_K, D8_STRAGGLE_S = 4, 2.0
# (d9): the SVM block ladder across the 8 ranks, an epoch at each size
D9_SIZES = (64, 128)
# host arrays of the SVM data sets, kept by phases 3 and 4 for phase dist
_HOST = {}
# what the earlier phases hand phase tooling: the three calls' work counters
# with their measured walls, and the timed T_step / T_sync of (b) and (d3)
_TOOLING = {}
# phase tooling (t2): digests of the four built-in simsync profiles' replay
# (simsync_digest), as the CPU gives them (tests/test_torch_roofline.py
# holds these to the CPU's)
SIMSYNC_DIGESTS = {"dcn_default": "3b1eaf215aa3d3c8",
                   "dcn_straggler": "2010d88b9e644afa",
                   "dcn_transient": "f71da57b490fb28d",
                   "ici_pod": "bdf9e5a3ca19c264"}
# phase tooling (t3): the script's own clock (from main's start) by which
# the dry run must have ended, so that the script ends inside its 1,200 s
# limit with room for the start before that clock (imports, ~5 s) and the
# lines after (under a second)
DRYRUN_DEADLINE_S = 1150
# device_ms's side stream, made at its first call
_SIDE = {}
DMS_MODES = [("none", "all", False), ("delayed", "all", False),
             ("chunked", "all", False), ("none", "ring", False),
             ("none", "pairwise", False), ("none", "ring", True),
             ("none", "pairwise", True)]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def device_ms(torch, fn, arg_sets, runs: int = 21) -> float:
    """Device time of one ``fn(*args)`` call: a CUDA graph of one call per
    argument set (distinct buffers, more bytes than L2 holds where the shape
    allows, so every call reads cold data, as the training loop does) is
    replayed ``runs`` times after warm-up; the median run over its calls.
    The warm-up runs on one kept side stream: each new stream would get a
    cuBLAS workspace of its own, which stays allocated."""
    side = _SIDE.setdefault("stream", torch.cuda.Stream())
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in arg_sets:
            fn(*args)
    for _ in range(3):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(arg_sets))
    return float(np.median(times))


def device_busy(torch, fn):
    """Run ``fn()`` once under ``torch.profiler`` and return (device busy
    s, span s, device activities, top kernels, activities by name), all of
    that one run (a CUDA graph's replays show each kernel they run): busy is
    the sum of the durations of the device's kernels, copies and fills (one
    stream, so they do not overlap); span is the device time from a CUDA
    event recorded before ``fn`` to one recorded after it, so busy/span is
    the share of that window the device worked. The profiler slows the
    host, so the idle share it gives is an upper bound of the unprofiled
    run's. It records the device's activities alone and reads the
    profiler's raw records, not its parsed events, which take minutes to
    build for a run of hundreds of thousands of kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    span = start.elapsed_time(end) * 1e-3
    by_name, counts = {}, {}
    device = [(e.name(), e.duration_ns() * 1e-9)
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    check(bool(device), "the profiler recorded no device activity")
    for name, secs in device:
        by_name[name] = by_name.get(name, 0.0) + secs
        counts[name] = counts.get(name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return sum(by_name.values()), span, len(device), top, counts


def log_busy(label, busy, span, count, top, counts=None):
    """One line: the device's busy and idle share of one profiled run's
    span, unclamped (a busy time above the span would show as a negative
    idle share), and where the device time went."""
    names = "; ".join(f"{n[:48]} {1e3 * t:.3f} ms" for n, t in top)
    log(f"{label}: device busy {1e3 * busy:.3f} ms of a {1e3 * span:.3f} ms "
        f"span (one profiled run, device activities alone), idle share "
        f"{100 * (1 - busy / span):.1f}%; "
        f"{count} device activities; top: {names}")


def hinge_inputs(torch, dev, seed, x_shape, w_shape, copies=1):
    """``copies`` independent (w, x, y) sets, made with numpy from ``seed``.
    A batched x (K, n, d) is block i of one (K, copies·n, d) array, the
    worker-major view ``xb[:, i]`` that ``dms`` hands the kernel; a w shape
    ``(K, 0)`` stands for the stride-0 ``w.expand(K, d)`` of K equal rows
    that ``dms``'s carry holds under the blocking mean and the delayed mode
    starts from."""
    rng = np.random.default_rng(seed)
    batched = len(x_shape) == 3
    if batched:
        k, n, d = x_shape
        xs = torch.from_numpy(rng.normal(size=(k, copies * n, d)).astype(
            np.float32)).to(dev)
        ys = torch.from_numpy(np.where(rng.random((k, copies * n)) > 0.5,
                                       1.0, -1.0).astype(np.float32)).to(dev)
    out = []
    for i in range(copies):
        if batched:
            x, y = xs[:, i * n:(i + 1) * n], ys[:, i * n:(i + 1) * n]
        else:
            x = torch.from_numpy(rng.normal(size=x_shape).astype(
                np.float32)).to(dev)
            y = torch.from_numpy(np.where(rng.random(x_shape[:-1]) > 0.5,
                                          1.0, -1.0).astype(np.float32)
                                 ).to(dev)
        stride0 = w_shape[-1] == 0
        w = torch.from_numpy(rng.normal(
            size=x_shape[-1:] if stride0 else w_shape).astype(np.float32)
        ).to(dev)
        out.append((w.expand(x_shape[0], -1) if stride0 else w, x, y))
    return out


def work_bound(work):
    """(bound_ms, bound_by) of a kernel call's work
    (:mod:`repro_torch.kernels.work`), priced by
    :func:`repro_torch.launch.roofline.work_bound`: its bytes over the HBM
    rate or its operations over their unit's peak, whichever is larger."""
    from repro_torch.launch.roofline import work_bound as priced
    seconds, by = priced(work)
    return 1e3 * seconds, by


def hinge_bound(x_shape, w_shape):
    """(bound_ms, bound_by): bytes read once and written once over HBM rate,
    or the flops (two GEMVs) over the float32 rate, whichever is larger. A
    stride-0 w (``w_shape`` (K, 0)) is one row read once."""
    from repro_torch.kernels.hinge.ops import hinge_work
    k = x_shape[0] if len(x_shape) == 3 else 1
    n, d = x_shape[-2:]
    w_rows = 1 if w_shape[-1] == 0 or len(w_shape) == 1 else w_shape[0]
    return work_bound(hinge_work(k, n, d, w_rows))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.hinge import ops as hinge_ops
    from repro_torch.kernels.quant import ops as quant_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    kernels = {"hinge": hinge_ops, "flash_attention": flash_ops,
               "quant": quant_ops, "ssd": ssd_ops}
    # one library for each source, named by its stem as its wrapper loads it
    sources = {src.stem: src for ops in kernels.values()
               for src in getattr(ops, "SOURCES", (ops.SOURCE,))}

    def build(name):
        t0 = time.perf_counter()
        lib = nvcc.build(name, [sources[name]])
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources)))
    log(f"kernels built in parallel: {time.perf_counter() - t0:.2f} s")
    for ops in kernels.values():
        ops.load_library()
    flash_ops.load_tc_library()
    flash_ops.load_tc32_library()
    ssd_ops.load_tc_library()
    g, rows, stage_rows, slots = hinge_ops.cluster_plan(64, 2000)
    plan = (2000, g, stage_rows, slots)
    cluster_lib = hinge_ops.load_cluster_library()
    active = cluster_lib.hinge_cluster_max_active(*plan)
    check(active > 0, f"hinge cluster occupancy query failed: {active}")
    log(f"hinge cluster kernel at epsilon's block (32 clusters of {g} CTAs "
        f"of {rows} rows; stages of {stage_rows} rows, {slots} in the "
        f"ring): {cluster_lib.hinge_cluster_smem_bytes(*plan)} bytes of "
        f"dynamic shared memory a CTA; {active} clusters fit on the card "
        f"at once")
    for name, (lib, secs) in built.items():
        log(f"{name} kernel build: {secs:.2f} s "
            f"({os.path.relpath(lib, REPO)})")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")
    return card


# dms hands the kernel the carry of K equal rows, a stride-0 view
HINGE_MAIN = "K=32,n=64,d=2000,stride-0 w"


def phase_kernel(torch, dev):
    """The kernels against the plain version; returns the main path's row.
    Every case's route is checked; where the cluster kernel runs,
    ``hinge.cu`` is also run and timed on the same inputs through
    ``run_kernel("simt", ...)``."""
    from repro_torch.kernels.hinge import ops, ref
    # (x shape, w shape, C, label, route): 16-byte rows of at most 2,048
    # columns take the cluster kernel, other rows hinge.cu
    cases = [((n, d), (d,), 1.0, f"n={n},d={d},C=1",
              "simt" if d % 4 else "cluster") for n, d in HINGE_SHAPES]
    cases += [((64, 16), (16,), c, f"n=64,d=16,C={c}", "cluster")
              for c in (0.1, 1.0, 10.0)]
    cases += [((32, 64, 2000), (32, 0), 1.0, HINGE_MAIN, "cluster"),
              ((32, 64, 2000), (2000,), 1.0, "K=32,n=64,d=2000,shared w",
               "cluster"),
              ((32, 64, 2000), (32, 2000), 1.0,
               "K=32,n=64,d=2000,per-worker w", "cluster"),
              ((8, 64, 254), (254,), 1.0, "K=8,n=64,d=254,shared w", "simt"),
              ((8, 64, 254), (8, 254), 1.0, "K=8,n=64,d=254,per-worker w",
               "simt"),
              ((512, 22), (22,), 1.0, "n=512,d=22 (srdms ijcnn1)", "simt"),
              ((2, 40, 5000), (5000,), 1.0, "K=2,n=40,d=5000 (wide)",
               "simt")]
    main_row = None
    for i, (x_shape, w_shape, c, label, expect) in enumerate(cases):
        per_set = 4 * int(np.prod(x_shape))
        copies = int(min(64, max(2, -(-2 * L2_BYTES // per_set))))
        sets = hinge_inputs(torch, dev, 100 + i, x_shape, w_shape, copies)
        w, x, y = sets[0]
        route = ops.kernel_for(w, x, y)
        check(route == expect, f"{label}: route {route}, expected {expect}")
        before = ops.LAUNCHES, ops.CLUSTER_LAUNCHES
        got = ops.hinge_block_grad(w, x, y, c)
        again = ops.hinge_block_grad(w, x, y, c)
        want = ref.hinge_block_grad(w, x, y, c)
        torch.cuda.synchronize()
        cluster = 2 * (route == "cluster")
        check((ops.LAUNCHES, ops.CLUSTER_LAUNCHES) ==
              (before[0] + 2, before[1] + cluster),
              f"{label}: launches counted {ops.LAUNCHES - before[0]} / "
              f"{ops.CLUSTER_LAUNCHES - before[1]}")
        err = float((got - want).abs().max())
        check(torch.equal(got, again), f"{label}: two launches differ")
        check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
              f"{label}: kernel vs plain max abs err {err}")
        ms = device_ms(torch, lambda a, b, e: ops.hinge_block_grad(a, b, e, c),
                       sets)
        plain_ms = device_ms(
            torch, lambda a, b, e: ref.hinge_block_grad(a, b, e, c), sets)
        bound_ms, bound_by = hinge_bound(x_shape, w_shape)
        simt = ""
        if route == "cluster":
            got_simt = ops.run_kernel("simt", w, x, y, c)
            torch.cuda.synchronize()
            err_simt = float((got_simt - want).abs().max())
            check(torch.allclose(got_simt, want, rtol=RTOL, atol=ATOL),
                  f"{label}: hinge.cu vs plain max abs err {err_simt}")
            simt_ms = device_ms(
                torch, lambda a, b, e: ops.run_kernel("simt", a, b, e, c),
                sets)
            simt = (f" hinge.cu {simt_ms * 1e3:.4f} us (max_abs_err "
                    f"{err_simt:.3e}, {simt_ms / ms:.2f}x the kernel's time)")
        if label == HINGE_MAIN:
            main_row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
        log(f"hinge {label} [{route}]: max_abs_err {err:.3e} "
            f"bitwise-repeatable kernel {ms * 1e3:.4f} us plain "
            f"{plain_ms * 1e3:.4f} us bound {bound_ms * 1e3:.4f} us "
            f"({bound_by}, {100 * bound_ms / ms:.1f}% of it){simt} "
            f"[{copies} input sets]")
    return main_row


def async_growth(workers: int, topology: str) -> float:
    """Spectral radius of ``M − αI`` at α = 1 (epoch 0): the async gossip
    recurrence is ``w ← (M − αI)·w + α·g``, so above 1 a mode grows by this
    factor every block, in the reference as in the port."""
    from repro_torch.core import costmodel
    return max(float(np.abs(np.linalg.eigvals(m - np.eye(workers))).max())
               for m in costmodel.mixing_matrices(workers, topology))


def _dms_pair(torch, dev, ds, label, expect_launches, route, **kw):
    """``dms`` on the kernel path, as a user calls it (on the card the first
    call captures an epoch and replays it an epoch a call; the second call
    replays the capture ``dms`` kept; every launch on the kernel ``route``
    names), the same eagerly (``graphs=False``), the three held bitwise,
    and on the plain path; holds the kernel path to the plain one by the
    relative-L2 and accuracy bounds. The host counts the launches it makes:
    the capture records an epoch's once, a call on the kept capture makes
    none, an eager call every block's (``expect_launches``). Async gossip
    stays eager (its mixing matrix is picked on the host), so there the
    kernel-path runs are all eager. Where the async recurrence grows in
    epoch 0, the reference itself overflows over a long epoch
    (``tests/test_torch_svm.py::test_async_ring_diverges_like_reference``):
    there both paths must end non-finite, as the reference does."""
    from repro_torch.core import svm
    from repro_torch.kernels.hinge import ops
    from repro_torch.runtime import graphs as G
    x, y, xt, yt = ds
    w0 = torch.zeros(x.shape[1], device=dev)
    graphed = not kw.get("gossip_async")
    per_epoch = expect_launches // kw["epochs"]
    made = {"kernel": per_epoch if graphed else expect_launches,
            "again": 0 if graphed else expect_launches,
            "eager": expect_launches, "torch": 0}
    svm.DMS_GRAPHS.clear()              # the first call captures
    out = {}
    for impl, graphs in (("kernel", None), ("again", None), ("eager", False),
                         ("torch", None)):
        torch.cuda.synchronize()
        ops.LAUNCHES = ops.CLUSTER_LAUNCHES = 0
        captures = G.CAPTURES
        t0 = time.perf_counter()
        w = svm.dms(w0, x, y, grad_impl="torch" if impl == "torch" else
                    "kernel", device=dev, graphs=graphs, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.LAUNCHES
        # the plain path is graphed too: its first call captures its own
        check(G.CAPTURES - captures == (graphed and impl != "again" and
                                        graphs is None),
              f"{label} {impl}: {G.CAPTURES - captures} captures")
        check(launches == made[impl],
              f"{label} {impl}: {launches} hinge launches made on the host, "
              f"expected {made[impl]}")
        check(ops.CLUSTER_LAUNCHES == (launches if route == "cluster" else 0),
              f"{label} {impl}: {ops.CLUSTER_LAUNCHES} of {launches} hinge "
              f"launches on the cluster kernel, expected all on {route}")
        check(w.shape == w0.shape, f"{label} {impl}: model shape {w.shape}")
        acc = float(svm.accuracy(w, xt, yt))
        out[impl] = (w, acc, wall, launches)
    wk, acck, wallk, launches_k = out["kernel"]
    wa, _, walla, _ = out["again"]
    we, _, walle, launches = out["eager"]
    wt, acct, wallt, launches_t = out["torch"]
    # async: every kernel-path run eager
    same = not graphed or (torch.equal(wk, we) and torch.equal(wa, we))
    how = (("graph, the call that captures", "the kept capture")
           if graphed else ("eager", "eager"))
    walls = (f"wall kernel {wallk:.4f} s ({how[0]}), again {walla:.4f} s "
             f"({how[1]}), eager {walle:.4f} s, plain {wallt:.4f} s")
    check(same, f"{label}: the graphed epochs differ from the eager ones "
          f"(max abs diff {float((wk - we).abs().max()):.3e}, again "
          f"{float((wa - we).abs().max()):.3e})")
    growth = (async_growth(kw["workers"], kw["topology"])
              if kw.get("gossip_async") else 0.0)
    if growth > 1.0:
        finite = [bool(torch.isfinite(v).all()) for v in (wk, wt)]
        log(f"dms {label}: async growth {growth:.4f} per block at alpha=1 "
            f"over {expect_launches} blocks; model finite kernel {finite[0]} "
            f"plain {finite[1]} (the reference overflows here too); eager "
            f"launches {launches} (expected {expect_launches}), plain-path "
            f"launches {launches_t}; {walls}")
        check(finite == [False, False],
              f"{label}: expected both paths to overflow as the reference "
              f"does, got finite={finite}")
        check(launches == expect_launches and launches_t == 0,
              f"{label}: launches {launches}/{launches_t}")
        return wk, acck, wallk, launches
    for impl, v in (("kernel", wk), ("torch", wt)):
        check(bool(torch.isfinite(v).all()), f"{label} {impl}: not finite")
    rel = float((wk - wt).norm() / wt.norm())
    log(f"dms {label}: eager launches {launches} (expected "
        f"{expect_launches}, all on {route}), the first call's "
        f"{launches_k} ({how[0]}), plain-path launches {launches_t}; graph "
        f"vs eager "
        f"bitwise "
        f"{'yes' if graphed else 'n/a (async gossip runs eagerly)'}; test acc "
        f"kernel {acck:.4f} plain {acct:.4f}; rel L2(w) {rel:.3e}; {walls}")
    check(launches == expect_launches,
          f"{label}: {launches} kernel launches, expected {expect_launches}")
    check(launches_t == 0, f"{label}: the plain path launched the kernel")
    check(rel <= W_REL_L2, f"{label}: rel L2 {rel} > {W_REL_L2}")
    check(abs(acck - acct) <= ACC_DIFF,
          f"{label}: accuracy {acck} vs {acct}")
    return wk, acck, wallk, launches


def _load(torch, dev, name, keep=False, **kw):
    """The data set on the card as (x, y, x_test, y_test); with ``keep``
    its host arrays stay in :data:`_HOST` for phase dist."""
    from repro_torch.data import make_svm_dataset
    t0 = time.perf_counter()
    ds = make_svm_dataset(name, seed=0, **kw)
    gen = time.perf_counter() - t0
    if keep:
        _HOST[name] = ds
    t0 = time.perf_counter()
    arrays = tuple(torch.from_numpy(a).to(dev) for a in
                   (ds.x_train, ds.y_train, ds.x_test, ds.y_test))
    torch.cuda.synchronize()
    log(f"data {name}: train {tuple(ds.x_train.shape)} test "
        f"{tuple(ds.x_test.shape)}; generated in {gen:.1f} s, to the card in "
        f"{time.perf_counter() - t0:.2f} s")
    return arrays


def phase_main(torch, dev, n_override=None):
    """dms(K=32, block 64, 2 epochs) on epsilon: the paper's main path, an
    epoch a CUDA graph replay (:func:`_dms_pair`); then the main path's
    counted run, a first call under the profiler with the counts set to 0
    just before it: the host counts the launches the capture records, the
    profiler the cluster kernel's runs (the kernels line's count); then its
    epochs alone: the capture, each replay, the replays under the sync
    debug mode "error"."""
    from repro_torch.core import svm
    from repro_torch.kernels.hinge import ops
    from repro_torch.runtime import graphs as G
    k, bs, epochs = 32, 64, 2
    if n_override:
        log(f"epsilon cut to n={n_override} (published 400,000)")
    ds = _load(torch, dev, "epsilon", keep=True, n_override=n_override)
    n_local = ds[0].shape[0] // k
    blocks = n_local // bs
    w, acc, wall, _ = _dms_pair(
        torch, dev, ds, "epsilon K=32 block=64 epochs=2",
        epochs * blocks, "cluster", workers=k, epochs=epochs, block_size=bs)
    obj = float(svm.hinge_objective(w, ds[0], ds[1]))
    check(np.isfinite(obj), "epsilon objective not finite")
    w0 = torch.zeros(ds[0].shape[1], device=dev)
    svm.DMS_GRAPHS.clear()              # a first call: it captures
    captures = G.CAPTURES
    ops.LAUNCHES = ops.CLUSTER_LAUNCHES = 0
    busy = device_busy(torch, lambda: svm.dms(
        w0, ds[0], ds[1], workers=k, epochs=epochs, block_size=bs,
        device=dev))
    made, made_cluster = ops.LAUNCHES, ops.CLUSTER_LAUNCHES
    launches = sum(n for name, n in busy[4].items() if "hinge_cluster" in name)
    log_busy("dms epsilon (capture and replays)", *busy)
    log(f"dms epsilon, the main path's counted run (a first call, under the "
        f"profiler): {busy[2] / (epochs * blocks):.2f} device activities a "
        f"block over {epochs * blocks} blocks; hinge launches made on the "
        f"host {made} ({made_cluster} on the cluster kernel: the capture "
        f"records an epoch's once), cluster-kernel runs by the profiler "
        f"{launches} ({epochs} replays x {blocks})")
    check(G.CAPTURES - captures == 1,
          f"dms epsilon: {G.CAPTURES - captures} captures in a first call")
    check(made == made_cluster == blocks,
          f"dms epsilon: {made} / {made_cluster} launches made on the host, "
          f"expected {blocks} on the cluster kernel")
    check(launches == epochs * blocks,
          f"dms epsilon: {launches} cluster-kernel runs by the profiler, "
          f"expected {epochs * blocks}")

    # the epochs alone: the capture, then each replay waited for
    d = ds[0].shape[1]
    xs, ys = svm._shard_data(ds[0], ds[1], k)
    xb = xs[:, :blocks * bs].reshape(k, blocks, bs, d)
    yb = ys[:, :blocks * bs].reshape(k, blocks, bs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = svm.DmsEpochs(w0, xb, yb, c=1.0, grad_impl="kernel", graphs=True)
    torch.cuda.synchronize()
    capture = time.perf_counter() - t0
    replays = []
    for t in range(epochs):
        t0 = time.perf_counter()
        run.epoch(t)
        torch.cuda.synchronize()
        replays.append(time.perf_counter() - t0)
    check(torch.equal(run.model(), w),
          "dms epsilon: DmsEpochs differs from dms's graph")
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(epochs):
            run.epoch(t)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"dms epsilon epochs as a graph: capture {1e3 * capture:.3f} ms "
        f"(host; {1e3 * run.compiled.capture_s:.3f} ms in the capture call, "
        f"of which {1e3 * run.compiled.end_s:.3f} ms ended it, instantiating "
        f"the graph), first replay {1e3 * replays[0]:.3f} ms, "
        f"then {', '.join(f'{1e3 * r:.3f}' for r in replays[1:])} ms an "
        f"epoch (host clock, each waited for); {epochs} replays ran under "
        f"the sync debug mode 'error'")
    log_busy(f"dms epsilon, {epochs} replayed epochs", *device_busy(
        torch, lambda: [run.epoch(t) for t in range(epochs)]))
    log(f"main path: epsilon test acc {acc:.4f} objective {obj:.6e} "
        f"wall {wall:.4f} s ({1e6 * wall / (epochs * blocks):.1f} us a block; "
        f"the call that captures) launches {launches} ({epochs} epochs x "
        f"{blocks} blocks, by the profiler)")
    # phase tooling (t1): the eager twin of the call (graphs=False: a
    # replay hides its ops) under the work counter, apart from 3 timed runs
    def eager():
        return svm.dms(w0, ds[0], ds[1], workers=k, epochs=epochs,
                       block_size=bs, device=dev, graphs=False)
    counter = count_call(torch, eager)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    hinge = ops.hinge_work(k, bs, d, 1)
    _TOOLING["dms"] = dict(
        what=f"dms epsilon K={k} block {bs} {epochs} epochs, graphs=False",
        counter=counter, wall=float(np.median(walls)), walls=walls,
        records={"hinge_block_grad": launches},
        model_flops=epochs * blocks * hinge.flops["float32"],
        peak=("float32", FP32_FLOPS_PER_S))
    return launches, ds


def count_call(torch, fn):
    """The :class:`repro_torch.launch.roofline.WorkCounter` of one call of
    ``fn`` on the card (its ops run as they do uncounted)."""
    from repro_torch.launch.roofline import WorkCounter
    counter = WorkCounter()
    with counter:
        fn()
    torch.cuda.synchronize()
    return counter


def count_meta_prefill(cfg, batch, prompt_len):
    """The :class:`repro_torch.launch.roofline.WorkCounter` of the same bf16
    prefill on the meta device, built as the dry run builds it:
    ``model.prefill`` with no engine, so no decode cache is zeroed or
    written."""
    import torch
    from repro_torch.launch.roofline import count
    from repro_torch.models import layers as L
    from repro_torch.models.registry import build_model
    model = build_model(cfg, attn_impl="kernel", ssd_impl="kernel")
    params = L.empty_params(model.param_defs(), torch.bfloat16, "meta")
    tokens = torch.zeros((batch, prompt_len), dtype=torch.long,
                         device="meta")
    with torch.no_grad():
        return count(model.prefill, params, {"tokens": tokens})[1]


def hinge_cu_time(torch, ops, sets, x_shape, w_shape, label):
    """One timed ``hinge.cu`` call on argument sets a main path hands it
    (its route checked), beside its bound."""
    check(all(ops.kernel_for(*a) == "simt" for a in sets),
          f"hinge {label}: not on hinge.cu")
    ms = device_ms(torch, lambda a, b, e: ops.hinge_block_grad(a, b, e, 1.0),
                   sets)
    bound_ms, bound_by = hinge_bound(x_shape, w_shape)
    log(f"hinge.cu at the {label}: {ms * 1e3:.4f} us a call, bound "
        f"{bound_ms * 1e3:.4f} us ({bound_by}, {100 * bound_ms / ms:.1f}% of "
        f"it) [{len(sets)} input sets]")


def phase_modes(torch, dev, n_override=None, ijcnn_n=4000):
    from repro_torch.core import svm
    from repro_torch.kernels.hinge import ops
    ds = _load(torch, dev, "webspam", keep=True, n_override=n_override)
    k, bs = 8, 64
    blocks = (ds[0].shape[0] // k) // bs
    for overlap, topology, gossip_async in DMS_MODES:
        label = f"webspam {overlap}/{topology}{'/async' if gossip_async else ''}"
        # 254 columns: rows no bulk copy can move, so hinge.cu
        _dms_pair(torch, dev, ds, label, blocks, "simt", workers=k, epochs=1,
                  block_size=bs, overlap=overlap, topology=topology,
                  gossip_async=gossip_async)
    # hinge.cu at the blocks these modes hand it: worker-major views of the
    # webspam data, the carry a stride-0 w
    n_local = ds[0].shape[0] // k
    d = ds[0].shape[1]
    xb = ds[0][:k * n_local].reshape(k, n_local, d)
    yb = ds[1][:k * n_local].reshape(k, n_local)
    w = torch.from_numpy(np.random.default_rng(7).normal(size=d).astype(
        np.float32)).to(dev).expand(k, d)
    sets = [(w, xb[:, i * bs:(i + 1) * bs], yb[:, i * bs:(i + 1) * bs])
            for i in range(min(64, blocks))]
    hinge_cu_time(torch, ops, sets, (k, bs, d), (k, 0),
                  f"webspam dms block (K={k}, {bs}, {d}), {blocks} launches "
                  f"a mode")

    x, y, xt, yt = _load(torch, dev, "ijcnn1", n_override=ijcnn_n)
    w0 = torch.zeros(x.shape[1], device=dev)
    epochs, bs = 5, 512
    res = {}
    for impl in ("kernel", "torch"):
        ops.LAUNCHES = ops.CLUSTER_LAUNCHES = 0
        res[impl] = svm.srdms(w0, x, y, epochs=epochs, block_size=bs,
                              grad_impl=impl, device=dev)
        res[impl + "_launches"] = ops.LAUNCHES
        check(ops.CLUSTER_LAUNCHES == 0,
              f"srdms {impl}: {ops.CLUSTER_LAUNCHES} hinge launches on the "
              f"cluster kernel; 22 columns take hinge.cu")
    rel = float((res["kernel"] - res["torch"]).norm() / res["torch"].norm())
    expect = epochs * (x.shape[0] // bs)
    hinge_cu_time(torch, ops, [(w0 + 0.01, x[i * bs:(i + 1) * bs],
                                y[i * bs:(i + 1) * bs])
                               for i in range(x.shape[0] // bs)],
                  (bs, x.shape[1]), (x.shape[1],),
                  f"ijcnn1 srdms block ({bs}, {x.shape[1]}), {expect} "
                  f"launches")
    log(f"srdms ijcnn1 block=512 epochs=5: launches {res['kernel_launches']} "
        f"(expected {expect}); rel L2(w) vs plain {rel:.3e}; test acc "
        f"{float(svm.accuracy(res['kernel'], xt, yt)):.4f}")
    check(res["kernel_launches"] == expect and res["torch_launches"] == 0,
          "srdms launch count")
    check(rel <= W_REL_L2, f"srdms rel L2 {rel}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w_seq = svm.seq_sgd(w0, x, y, epochs=1, device=dev)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    w_cpu = svm.seq_sgd(w0.cpu(), x.cpu(), y.cpu(), epochs=1, device="cpu")
    err = float((w_seq.cpu() - w_cpu).abs().max())
    log(f"seq_sgd ijcnn1 n={x.shape[0]} epochs=1: {seq_s:.2f} s on the card; "
        f"max abs diff vs the CPU run {err:.3e}; test acc "
        f"{float(svm.accuracy(w_seq, xt, yt)):.4f}")
    # per-point updates reset w at α=1: a flipped kink is one point's step
    check(err <= 1e-4, f"seq_sgd card vs CPU {err}")


def flash_inputs(torch, dev, seed, shape, dtype, copies=1):
    """``copies`` independent (q, k, v) sets, made with numpy from ``seed``."""
    b, sq, sk, h, kv, dh = shape[:6]
    rng = np.random.default_rng(seed)
    return [tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  .to(dev, dtype)
                  for s in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)))
            for _ in range(copies)]


def _flash_work(shape, dtype, tf32=False):
    from repro_torch.kernels.flash_attention.ops import flash_work
    return flash_work(*shape, dtype=dtype, tf32=tf32)


def flash_bound(shape, itemsize):
    """(bound_ms, bound_by): q, k, v read once and o written once over the
    HBM rate, or 4·dh flops for every visible (row, key) pair over the
    tensor-core rate of the inputs' type (float32 on the CUDA cores)."""
    import torch
    return work_bound(_flash_work(
        shape, torch.bfloat16 if itemsize == 2 else torch.float32))


def flash_bound_tc32(shape):
    """(bound_ms, bound_by) of the function in f32 on the tensor cores: q,
    k, v read once and o written once (f32) over the HBM rate, or its
    flops, counted once as :func:`flash_bound` counts them, over the TF32
    tensor-core rate. The split-TF32 route takes each product three times,
    so its own floor is 3× the operations' time (:func:`flash_flops`)."""
    import torch
    return work_bound(_flash_work(shape, torch.float32, tf32=True))


def flash_flops(shape):
    """4·dh flops for every visible (row, key) pair: the function's
    products, Q·Kᵀ and P·V."""
    import torch
    return sum(_flash_work(shape, torch.float32).flops.values())


def flash_counts(ops):
    return ops.LAUNCHES, ops.TC_LAUNCHES, ops.TC32_LAUNCHES


def hold_flash(torch, ops, ref, q, k, v, causal, prefix, kind, rtol, atol,
               label):
    """Two launches of the wrapper: both on kernel ``kind`` and counted
    there, bitwise equal, within (rtol, atol) of the plain version. Returns
    (the output, the plain version's, the max abs error)."""
    before = flash_counts(ops)
    got = ops.flash_attention(q, k, v, causal=causal, prefix_len=prefix)
    again = ops.flash_attention(q, k, v, causal=causal, prefix_len=prefix)
    want = ref.flash_attention(q, k, v, causal=causal, prefix_len=prefix)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(ops.kernel_for(q, k, v) == kind and flash_counts(ops) == (
              before[0] + 2, before[1] + 2 * (kind == "tc"),
              before[2] + 2 * (kind == "tc32")),
          f"flash {label}: expected two launches of the {kind} kernel")
    check(got.shape == q.shape and got.dtype == q.dtype,
          f"flash {label}: output {tuple(got.shape)} {got.dtype}")
    check(torch.equal(got, again), f"flash {label}: two launches differ")
    check(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol),
          f"flash {label}: kernel vs plain max abs err {err}")
    return got, want, err


def phase_flash(torch, dev):
    """The flash kernels against their plain version (f32 cases on the
    split-TF32 kernel, bf16 on the bf16 tensor-core one, TMA-unaligned
    inputs of both types on the CUDA-core one, each launch counted on the
    kernel it must take); returns the bf16 and f32 main rows."""
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = [(shape, torch.float32, 1e-4, 2e-5)
             for shape in FLASH_SHAPES + FLASH_F32_FULL]
    cases += [(shape, torch.bfloat16, BF16_RTOL, BF16_ATOL)
              for shape in [FLASH_BF16] + FLASH_TC_SHAPES +
              [FLASH_MAIN, FLASH_HYBRID] + FLASH_FAMILY_SHAPES]
    rows = {}
    for i, (shape, dtype, rtol, atol) in enumerate(cases):
        causal, prefix = shape[6], shape[7]
        itemsize = torch.finfo(dtype).bits // 8
        b, sq, sk, h, kv, dh = shape[:6]
        per_set = itemsize * dh * (2 * b * sq * h + 2 * b * sk * kv)
        copies = int(min(64, max(2, -(-2 * L2_BYTES // per_set))))
        sets = flash_inputs(torch, dev, 200 + i, shape, dtype, copies)
        q, k, v = sets[0]
        kind = "tc" if dtype == torch.bfloat16 else "tc32"
        label = (f"b={b},sq={sq},sk={sk},h={h},kv={kv},dh={dh},"
                 f"causal={causal},prefix={prefix},{str(dtype)[6:]}")
        got, want, err = hold_flash(torch, ops, ref, q, k, v, causal, prefix,
                                    kind, rtol, atol, label)

        def kernel(q, k, v):
            return ops.flash_attention(q, k, v, causal=causal,
                                       prefix_len=prefix)

        def plain(q, k, v):
            return ref.flash_attention(q, k, v, causal=causal,
                                       prefix_len=prefix)

        ms = device_ms(torch, kernel, sets)
        plain_ms = device_ms(torch, plain, sets)
        if dtype == torch.float32:
            bound_ms, bound_by = flash_bound_tc32(shape)
        else:
            bound_ms, bound_by = flash_bound(shape, itemsize)
        log(f"flash {label}: {kind} kernel, max_abs_err {err:.3e} "
            f"bitwise-repeatable, kernel {ms * 1e3:.4f} us plain "
            f"{plain_ms * 1e3:.4f} us bound {bound_ms * 1e3:.4f} us "
            f"({bound_by}) [{copies} input sets]")
        if dtype == torch.float32:
            # beside it on the same f32 inputs: the CUDA-core kernel
            # (flash_attention.cu, which every other f32 input takes) and
            # the yardstick SDPA, the mask given where a prefix widens the
            # causal one (columns below the prefix seen by every row)
            def simt(q, k, v):
                return ops.run_kernel("simt", q, k, v, causal=causal,
                                      prefix_len=prefix)
            simt_out = simt(q, k, v)
            simt_err = float((simt_out - want).abs().max())
            check(torch.allclose(simt_out, want, rtol=rtol, atol=atol),
                  f"flash {label}: flash_attention.cu vs plain max abs err "
                  f"{simt_err}")
            simt_ms = device_ms(torch, simt, sets)
            mask = None
            if prefix:
                rows_ = torch.arange(sq, device=dev)[:, None]
                cols = torch.arange(sk, device=dev)[None]
                mask = (cols <= rows_) | (cols < prefix)

            def library(q, k, v):
                return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), attn_mask=mask,
                            is_causal=causal and mask is None,
                            enable_gqa=True)
            lib_err = float((library(q, k, v).transpose(1, 2) - want)
                            .abs().max())
            library_ms = device_ms(torch, library, sets)
            cc_ms, cc_by = flash_bound(shape, itemsize)
            flops = flash_flops(shape)
            split_ms = 3e3 * compute_s({"tf32": flops})
            log(f"flash {label}: tc32 {ms * 1e3:.4f} us, flash_attention.cu "
                f"{simt_ms * 1e3:.4f} us (max_abs_err {simt_err:.3e}), SDPA "
                f"f32 {library_ms * 1e3:.4f} us (max abs diff vs plain "
                f"{lib_err:.3e}), plain {plain_ms * 1e3:.4f} us; bounds: "
                f"TF32 tensor cores {bound_ms * 1e3:.4f} us ({bound_by}), "
                f"f32 CUDA cores {cc_ms * 1e3:.4f} us ({cc_by}); tc32 at "
                f"{100 * bound_ms / ms:.2f}% of the TF32 bound and "
                f"{100 * cc_ms / ms:.2f}% of the CUDA-core one; the split's "
                f"own floor (3 TF32 products) {split_ms * 1e3:.4f} us, "
                f"{100 * split_ms / ms:.2f}% of it; "
                f"{flops / ms * 1e-9:.1f} TFLOP/s of the function's "
                f"{flops / 1e9:.2f} GFLOP; SDPA takes {library_ms / ms:.2f}x "
                f"its time, flash_attention.cu {simt_ms / ms:.2f}x")
            if shape == FLASH_F32_FULL[0]:
                rows["f32"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   library_ms=library_ms)
            continue
        if shape in [FLASH_MAIN, FLASH_HYBRID] + FLASH_FAMILY_SHAPES:
            # the yardstick: one PyTorch call for the same function (heads
            # first, as it takes them; the mask given where a prefix widens
            # the causal one); the port never calls it
            mask = None
            if prefix:
                rows_ = torch.arange(sq, device=dev)[:, None]
                cols = torch.arange(sk, device=dev)[None]
                mask = (cols <= rows_) | (cols < prefix)

            def library(q, k, v):
                return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), attn_mask=mask,
                            is_causal=causal and mask is None,
                            enable_gqa=True)
            lib_out = library(q, k, v).transpose(1, 2)
            lib_err = float((lib_out.float() - want.float()).abs().max())
            library_ms = device_ms(torch, library, sets)
            flops = flash_flops(shape)
            log(f"flash {label}: SDPA {library_ms * 1e3:.4f} us (max abs "
                f"diff vs plain {lib_err:.3e}); kernel "
                f"{flops / ms * 1e-9:.1f} TFLOP/s of the function's "
                f"{flops / 1e9:.2f} GFLOP ({1.5 * flops / ms * 1e-9:.1f} "
                f"TFLOP/s counting the split P·V it computes), "
                f"{100 * bound_ms / ms:.2f}% of its bound; SDPA "
                f"{flops / library_ms * 1e-9:.1f} TFLOP/s")
        if shape == FLASH_MAIN:
            # elements over the limit, and over one of atol 8e-3 (about
            # two ulps at the outputs' scale) for comparison
            over = {(name, a): int((o.float() - want.float()).abs().gt(
                        a + rtol * want.float().abs()).sum())
                    for name, o in (("kernel", got), ("SDPA", lib_out))
                    for a in (atol, 8e-3)}
            log(f"flash main shape: SDPA {library_ms * 1e3:.4f} us "
                f"(max abs diff vs plain {lib_err:.3e}); elements of "
                f"{want.numel()} over rtol {rtol:g} / atol {atol:g}: kernel "
                f"{over['kernel', atol]}, SDPA {over['SDPA', atol]}; over "
                f"atol 8e-3: kernel {over['kernel', 8e-3]}, SDPA "
                f"{over['SDPA', 8e-3]}; kernel at "
                f"{100 * bound_ms / ms:.2f}% of its bound")
            check(over["SDPA", atol] > 0, "the main shape's limit passes "
                  "SDPA's bf16 probabilities: it cannot tell them from f32")
            rows["bf16"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=library_ms)

    # inputs no TMA map can describe stay on flash_attention.cu: an f32 q,
    # k, v sliced 4 bytes into a fused (B, S, 8·64 + 1) projection, and
    # bf16 rows of 140 bytes (dh 70)
    rng = np.random.default_rng(300)
    fused = torch.from_numpy(rng.normal(size=(2, 300, 8 * 64 + 1)).astype(
        np.float32)).to(dev)
    heads = fused[..., 1:].unflatten(-1, (8, 64))
    bf16 = flash_inputs(torch, dev, 301, (1, 130, 130, 4, 2, 70),
                        torch.bfloat16)[0]
    for (q, k, v), (rtol, atol), label in (
            ((heads[:, :, :4], heads[:, :, 4:6], heads[:, :, 6:]),
             (1e-4, 2e-5), "f32 fused qkv 4 bytes in (b=2,sq=300,h=4,kv=2,"
                           "dh=64)"),
            (bf16, (BF16_RTOL, BF16_ATOL), "bf16 dh=70 (b=1,sq=130,h=4,"
                                           "kv=2)")):
        _, _, err = hold_flash(torch, ops, ref, q, k, v, True, 0, "simt",
                               rtol, atol, label)
        log(f"flash {label}: simt kernel (TMA cannot describe it), "
            f"max_abs_err {err:.3e} bitwise-repeatable")
    return rows


def rel_l2(torch, a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def serve_launches(cfg, bf16=True):
    """Kernel launches one prefill makes on the kernel path: the flash
    kernels once per attention application (the enc-dec's three a decoder
    layer and encoder layer together), the SSD kernels once per Mamba2
    layer. In bf16 all on the tensor-core kernels; in f32 the flash ones on
    the split-TF32 kernel and the SSD ones on ``ssd.cu``."""
    if cfg.family == "ssm":
        flash, ssd = 0, cfg.n_layers
    elif cfg.family == "hybrid":
        flash, ssd = cfg.n_layers // cfg.shared_block_every, cfg.n_layers
    elif cfg.family == "audio":
        # the encoder's layers, and each decoder layer's self- and cross-
        flash, ssd = cfg.n_encoder_layers + 2 * cfg.n_layers, 0
    else:
        flash, ssd = cfg.n_layers, 0
    return {"flash_attention": flash,
            "flash_attention_tc": flash if bf16 else 0,
            "flash_attention_tc32": 0 if bf16 else flash, "ssd": ssd,
            "ssd_tc": ssd if bf16 else 0}


def serve_counters():
    """The launch counters a serve run reads, by name: (module, attr)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return {"flash_attention": (flash_ops, "LAUNCHES"),
            "flash_attention_tc": (flash_ops, "TC_LAUNCHES"),
            "flash_attention_tc32": (flash_ops, "TC32_LAUNCHES"),
            "ssd": (ssd_ops, "LAUNCHES"),
            "ssd_tc": (ssd_ops, "TC_LAUNCHES")}


def reset(counters):
    for ops, attr in counters.values():
        setattr(ops, attr, 0)


def read(counters):
    return {name: getattr(ops, attr) for name, (ops, attr) in
            counters.items()}


def layer0(cfg, cache):
    """Layer 0's cache leaves, copied, each with whether the kernel path
    must give the plain path's bits: the attention k, v and the conv tails
    are computed before any kernel; the SSM state comes out of the SSD
    kernel."""
    if cfg.family == "dense":
        return {k: (cache[k][0].clone(), True) for k in ("k", "v")}
    mamba = cache["mamba"] if cfg.family == "hybrid" else cache
    return {k: (v[0].clone(), k != "ssm") for k, v in mamba.items()}


def _serve_paths(torch, engines, prompts, forced, counters, timed):
    """Prefill then decode teacher-forced on ``forced`` through each engine
    (the kernel path and the plain path) by its decode loop (graph replays
    on the card); per path the logits of the prefill and of every step,
    layer 0's cache after the prefill, the prefill's launches and, if
    ``timed``, the prefill (median of 3 more) and decode times."""
    runs = {}
    prompt_len, gen = prompts.shape[1], forced.shape[1]
    for impl, eng in engines.items():
        torch.cuda.synchronize()
        reset(counters)
        t0 = time.perf_counter()
        logits, cache = eng.prefill(prompts)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = read(counters)
        first = layer0(eng.cfg, cache)
        eng.decode_loop(prompts.shape[0])     # captured here, not timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = _forced_steps(eng, logits, prompt_len, forced)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        del cache
        runs[impl] = dict(logits=logits, layer0=first, steps=steps,
                          launches=launches)
        if not timed:
            continue
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.prefill(prompts)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        runs[impl].update(prefill_s=float(np.median(times)),
                          decode_ms=1e3 * decode_s / gen)
        b = prompts.shape[0]
        log(f"serve {eng.cfg.name} {impl} path: prefill "
            f"{runs[impl]['prefill_s']:.4f} s (median of 3; first "
            f"{prefill_s:.4f} s), decode {runs[impl]['decode_ms']:.3f} ms a "
            f"step ({b} tokens, teacher-forced, graphs "
            f"{eng.graphs}), {1e3 * b / runs[impl]['decode_ms']:.1f} "
            f"tokens/s in decode; launches in prefill {launches}")
    return runs["kernel"], runs["torch"]


def _hold_paths(torch, cfg, kr, tr, label, rel_bound):
    """The kernel path against the plain path: layer 0's cache after the
    prefill (bitwise where no kernel ran yet, the SSM state within the SSD
    bound), and the logits' relative L2 (checked where ``rel_bound`` is
    given). Returns (prefill rel L2, max step rel L2)."""
    notes = []
    for name, (got, exact) in kr["layer0"].items():
        want = tr["layer0"][name][0]
        if exact:
            check(torch.equal(got, want),
                  f"{label}: layer 0 cache {name} differs between the paths")
            notes.append(f"{name} bitwise")
        else:
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, **SSD_F32_TOL),
                  f"{label}: layer 0 SSM state max abs err {err} over the "
                  f"SSD bound")
            notes.append(f"{name} max abs err {err:.3e} (max "
                         f"{float(want.abs().max()):.3e})")
    for t in [kr["logits"]] + kr["steps"]:
        check(bool(torch.isfinite(t).all()),
              f"{label}: kernel path logits not finite")
    prefill_rel = rel_l2(torch, kr["logits"], tr["logits"])
    step_rel = [rel_l2(torch, a, b) for a, b in zip(kr["steps"], tr["steps"])]
    agree = float((torch.argmax(kr["logits"], -1)
                   == torch.argmax(tr["logits"], -1)).float().mean())
    bound = (rel_bound if rel_bound is not None
             else "none: each bf16 path is held to f32 below")
    log(f"{label} kernel vs plain: prefill logits rel L2 {prefill_rel:.4e}, "
        f"{len(step_rel)} decode steps rel L2 max {max(step_rel):.4e} median "
        f"{float(np.median(step_rel)):.4e} (bound {bound}); "
        f"first-token agreement {agree:.2f}; layer 0 after the prefill: "
        f"{', '.join(notes)}")
    if rel_bound is not None:
        check(prefill_rel <= rel_bound,
              f"{label}: prefill logits rel L2 {prefill_rel} > {rel_bound}")
        check(max(step_rel) <= rel_bound,
              f"{label}: decode logits rel L2 {max(step_rel)} > {rel_bound}")
    return prefill_rel, max(step_rel)


def phase_serve(torch, dev, cfg, batch, prompt_len, gen, bf16_rel_l2,
                f32_rel_l2=None, f32_steps=16, bf16_factor=None,
                count_prefill=False):
    """``ServeEngine.generate`` through the kernel path (flash and SSD
    launches counted; the decode loop as CUDA graph replays), that against
    ``graphs=False`` (:func:`_graph_against_eager`, and the replayed step
    teacher-forced against the eager step's logits, bitwise), then the
    kernel path against the plain path
    (``attn_impl="torch"``, ``ssd_impl="torch"``) in bf16, on the kernel
    path's tokens: prefill logits, layer 0's cache after the prefill, every
    decode step's logits teacher-forced (held to ``bf16_rel_l2`` where it is
    given). With ``f32_rel_l2``, the same comparison once more with both
    engines in f32 over ``f32_steps`` decode steps, held to that bound; with
    ``bf16_factor`` too, each bf16 path's logits (prefill and those steps)
    against the f32 plain path's: the kernel path's relative L2 within
    ``bf16_factor`` times the plain path's. Returns the launches of the
    generate run, and of the f32 kernel path's prefill (None without
    ``f32_rel_l2``). With ``count_prefill``, one kernel-path prefill under
    the work counter for phase tooling, apart from the timed ones."""
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models.registry import analytic_param_count
    from repro_torch.runtime import graphs as G
    counters = serve_counters()
    expect = serve_launches(cfg)
    none = {name: 0 for name in counters}
    max_len = prompt_len + gen + 1

    def build(dtype):
        """Both engines, params and activations in ``dtype``."""
        c = dataclasses.replace(cfg, dtype=str(dtype).split(".")[-1])
        return {impl: ServeEngine(c, dev, max_len=max_len, dtype=dtype,
                                  attn_impl=impl, ssd_impl=impl)
                for impl in ("kernel", "torch")}

    t0 = time.perf_counter()
    engines = build(torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engines["kernel"].params.parameters())
    log(f"serve {cfg.name} ({cfg.family}): {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B "
        f"params, bf16; two engines built in {time.perf_counter() - t0:.2f} s")
    pk, pt = (e.params.state_dict() for e in engines.values())
    check(all(torch.equal(pk[n], pt[n]) for n in pk),
          "the two engines' seeded weights differ")
    del pk, pt
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(batch, prompt_len))).to(dev)

    # the main path, as a user calls it: the decode loop as graph replays
    engine = engines["kernel"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset(counters)
    captures = G.CAPTURES
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, gen)
    wall = time.perf_counter() - t0
    launches = read(counters)
    peak = torch.cuda.max_memory_allocated()
    check(tokens.shape == (batch, gen), f"tokens {tokens.shape}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "generated token ids out of range")
    check(launches == expect, f"{cfg.name}: launches in one generate "
          f"{launches}, expected {expect} (one prefill; decode runs none)")
    log(f"serve {cfg.name} generate (graphs): {batch} x {prompt_len} prompt "
        f"tokens, {gen} new tokens each: wall {wall:.4f} s, "
        f"{tokens.size / wall:.1f} new tokens/s (the first call: it captures "
        f"the step); launches {launches} (one prefill); peak memory "
        f"{peak / 2**30:.2f} GiB, {(peak - held) / 2**30:.2f} GiB above the "
        f"{held / 2**30:.2f} GiB held before it (the kernel and plain "
        f"engines' weights)")
    eager, gen_walls = _graph_against_eager(
        torch, dev, cfg, engine, prompts, gen, tokens, captures)

    # kernel path and plain path, step by step on the kernel path's tokens
    forced = torch.from_numpy(tokens).to(dev).long()
    kr, tr = _serve_paths(torch, engines, prompts, forced, counters, True)
    check(kr["launches"] == expect and tr["launches"] == none,
          f"prefill launches {kr['launches']} / {tr['launches']}")
    if count_prefill:
        _TOOLING["prefill"] = dict(
            what=f"{cfg.name} bf16 prefill {batch} x {prompt_len}",
            counter=count_call(torch, lambda: engine.prefill(prompts)),
            wall=kr["prefill_s"],
            records={"flash_attention": launches["flash_attention"]},
            model_flops=2.0 * analytic_param_count(cfg, True) * batch
            * prompt_len, peak=("bfloat16", BF16_FLOPS_PER_S),
            meta=lambda: count_meta_prefill(cfg, batch, prompt_len))
    greedy = torch.stack([torch.argmax(s, dim=-1) for s in
                          [kr["logits"]] + kr["steps"][:-1]], dim=1)
    check(torch.equal(greedy, forced),
          "the kernel path's logits do not reproduce its generated tokens")
    _hold_paths(torch, cfg, kr, tr, f"serve {cfg.name} bf16", bf16_rel_l2)
    bf16_logits = {impl: [r["logits"]] + r["steps"][:f32_steps]
                   for impl, r in (("kernel", kr), ("torch", tr))}
    # the eager step teacher-forced on the same tokens: the replayed
    # steps' logits (the kernel path's above), bitwise
    logits, _ = eager.prefill(prompts)
    eager_steps = _forced_steps(eager, logits, prompt_len, forced)
    same = [torch.equal(a, b) for a, b in zip(kr["steps"], eager_steps)]
    log(f"serve {cfg.name} teacher-forced logits, graph replays vs eager "
        f"steps: {sum(same)} of {len(same)} steps bitwise")
    check(all(same), f"{cfg.name}: graphed decode logits differ from the "
          f"eager step's at steps {[i for i, v in enumerate(same) if not v]}")
    del eager_steps
    n_prof = min(16, gen)
    log_busy(f"serve {cfg.name} kernel-path prefill",
             *device_busy(torch, lambda: engine.prefill(prompts)))
    busy = {}
    for name, eng in (("eager", eager), ("graph", engine)):
        logits, _ = eng.prefill(prompts)
        loop = eng.decode_loop(batch)
        loop.start(logits, prompt_len)
        busy[name] = device_busy(torch, lambda: [loop.step()
                                                 for _ in range(n_prof)])
        log_busy(f"serve {cfg.name} {name} decode, {n_prof} steps",
                 *busy[name])
    busy_e, busy_g = busy["eager"], busy["graph"]
    log(f"serve {cfg.name} decode device busy a step: graph "
        f"{1e3 * busy_g[0] / n_prof:.3f} ms, eager "
        f"{1e3 * busy_e[0] / n_prof:.3f} ms; new tokens/s of generate: "
        f"graph {gen_walls['graph']:.1f} (a call after the capture), eager "
        f"{gen_walls['eager']:.1f}")
    del engines, engine, eager, kr, tr, loop
    torch.cuda.empty_cache()

    if f32_rel_l2 is not None:
        engines = build(torch.float32)
        kr, tr = _serve_paths(torch, engines, prompts, forced[:, :f32_steps],
                              counters, False)
        expect = serve_launches(cfg, bf16=False)
        check(kr["launches"] == expect and tr["launches"] == none,
              f"f32 prefill launches {kr['launches']} / {tr['launches']}")
        _hold_paths(torch, cfg, kr, tr, f"serve {cfg.name} f32", f32_rel_l2)
        if bf16_factor is not None:
            hold_bf16_to_f32(torch, cfg, bf16_logits,
                             [tr["logits"]] + tr["steps"], bf16_factor)
        f32_launches = kr["launches"]
        del engines, kr, tr
        torch.cuda.empty_cache()
        return launches, f32_launches
    return launches, None


def _forced_steps(engine, logits, prompt_len, forced):
    """The logits of each step of ``engine``'s decode loop, teacher-forced
    on ``forced`` after a prefill of ``prompt_len`` tokens that gave
    ``logits``."""
    loop = engine.decode_loop(forced.shape[0])
    loop.start(logits, prompt_len)
    steps = []
    for i in range(forced.shape[1]):
        loop.token.copy_(forced[:, i:i + 1])
        steps.append(loop.step().clone())
    return steps


def _graph_against_eager(torch, dev, cfg, engine, prompts, gen, tokens,
                         captures):
    """After the main path's ``generate`` (graphs): the same requests once
    more (no new capture: one a batch size), and through an engine of the
    same weights with ``graphs=False``; both give the main path's tokens.
    Then the decode loop alone, a prefill then ``gen`` steps on each engine
    (the replays under the sync debug mode "error"): ms a step. Returns the
    eager engine and the new tokens/s of each path's ``generate``."""
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.runtime import graphs as G
    b, prompt_len = prompts.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = engine.generate(prompts, gen)
    wall_g = time.perf_counter() - t0
    check(G.CAPTURES - captures == 1, f"{cfg.name}: {G.CAPTURES - captures} "
          f"captures over two generate calls of batch {b}")
    check(np.array_equal(again, tokens),
          f"{cfg.name}: a second generate gave other tokens")
    eager = ServeEngine(engine.cfg, dev, max_len=engine.max_len,
                        dtype=engine.dtype, graphs=False)
    pe, pg = eager.params.state_dict(), engine.params.state_dict()
    check(all(torch.equal(pe[n], pg[n]) for n in pe),
          "the eager engine's seeded weights differ")
    del pe, pg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tokens_e = eager.generate(prompts, gen)
    wall_e = time.perf_counter() - t0
    peak_e = torch.cuda.max_memory_allocated() - held
    check(G.CAPTURES - captures == 1, f"{cfg.name}: the eager engine "
          f"captured")
    check(np.array_equal(tokens_e, tokens),
          f"{cfg.name}: graphs=False generated other tokens "
          f"({int((tokens_e != tokens).sum())} of {tokens.size} differ)")
    ms, n_steps = {}, {"graph": gen, "eager": min(16, gen)}
    for name, eng in (("graph", engine), ("eager", eager)):
        logits, _ = eng.prefill(prompts)
        loop = eng.decode_loop(b)
        loop.start(logits, prompt_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "graph":
            torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(n_steps[name]):
                loop.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0) / n_steps[name]
        check(np.array_equal(loop.tokens(prompt_len, n_steps[name]),
                             tokens[:, :n_steps[name]]),
              f"{cfg.name}: the {name} decode loop gave other tokens")
    compiled = engine.decode_loop(b).compiled
    log(f"serve {cfg.name} decode step capture: {compiled.capture_s:.4f} s "
        f"(no warm-up: recording, and {compiled.end_s:.4f} s ending the "
        f"capture, which instantiates the graph)")
    log(f"serve {cfg.name} generate again (graphs, no capture): wall "
        f"{wall_g:.4f} s, {tokens.size / wall_g:.1f} new tokens/s; "
        f"graphs=False: wall {wall_e:.4f} s, {tokens.size / wall_e:.1f} new "
        f"tokens/s, peak memory {peak_e / 2**30:.2f} GiB above the "
        f"{held / 2**30:.2f} GiB held before it; tokens identical; 1 capture "
        f"over both graph calls")
    log(f"serve {cfg.name} decode loop, steps of {b} tokens: graph "
        f"{ms['graph']:.3f} ms a step over {n_steps['graph']} "
        f"({1e3 * b / ms['graph']:.1f} tokens/s; the replays under the sync "
        f"debug mode 'error'), eager {ms['eager']:.3f} ms a step over "
        f"{n_steps['eager']} ({1e3 * b / ms['eager']:.1f} tokens/s), "
        f"{ms['eager'] / ms['graph']:.2f}x")
    return eager, {"graph": tokens.size / wall_g,
                   "eager": tokens.size / wall_e}


def phase_prefill_f32(torch, dev, cfg, batch, prompt_len, rel_bound):
    """One f32 prefill of ``cfg`` at full width on the kernel path (flash
    launches counted: all on the split-TF32 kernel) and on the plain path
    (``attn_impl="torch"``, full f32 products), the logits held to each
    other at relative L2 ``rel_bound``; the kernel path's wall (median of
    3 more) and one profiled run's idle share. Returns its launches."""
    from repro_torch.launch.serve import ServeEngine
    counters = serve_counters()
    c = dataclasses.replace(cfg, dtype="float32")
    engines = {impl: ServeEngine(c, dev, max_len=prompt_len + 1,
                                 dtype=torch.float32, attn_impl=impl,
                                 ssd_impl=impl)
               for impl in ("kernel", "torch")}
    pk, pt = (e.params.state_dict() for e in engines.values())
    check(all(torch.equal(pk[n], pt[n]) for n in pk),
          "the two engines' seeded weights differ")
    del pk, pt
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(batch, prompt_len))).to(dev)
    engine = engines["kernel"]
    torch.cuda.synchronize()
    reset(counters)
    t0 = time.perf_counter()
    logits, cache = engine.prefill(prompts)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = read(counters)
    del cache
    expect = serve_launches(cfg, bf16=False)
    check(launches == expect, f"{cfg.name} f32 prefill launches {launches}, "
          f"expected {expect}")
    reset(counters)
    want, cache = engines["torch"].prefill(prompts)
    del cache
    check(read(counters) == {name: 0 for name in counters},
          f"{cfg.name} f32 plain prefill launched a kernel")
    check(bool(torch.isfinite(logits).all()),
          f"{cfg.name} f32 kernel-path logits not finite")
    rel = rel_l2(torch, logits, want)
    agree = float((torch.argmax(logits, -1) == torch.argmax(want, -1))
                  .float().mean())
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        engine.prefill(prompts)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    log(f"serve {cfg.name} f32 prefill, {batch} x {prompt_len} tokens: "
        f"kernel path {float(np.median(times)):.4f} s (median of 3; first "
        f"{first:.4f} s); launches {launches}; logits vs the plain f32 path "
        f"rel L2 {rel:.4e} (bound {rel_bound}), first-token agreement "
        f"{agree:.2f}")
    check(rel <= rel_bound, f"{cfg.name} f32 prefill logits rel L2 {rel} > "
          f"{rel_bound}")
    log_busy(f"serve {cfg.name} f32 kernel-path prefill",
             *device_busy(torch, lambda: engine.prefill(prompts)))
    del engines, engine, logits, want
    torch.cuda.empty_cache()
    return launches


def hold_bf16_to_f32(torch, cfg, bf16_logits, f32_logits, factor):
    """Each bf16 path's logits (prefill, then the teacher-forced steps)
    against the f32 plain path's on the same weights and tokens: the kernel
    path's relative L2 at most ``factor`` times the plain path's own."""
    want = torch.stack([t.float() for t in f32_logits])
    dist, agree = {}, {}
    for impl, logits in bf16_logits.items():
        got = torch.stack([t.float() for t in logits[:len(f32_logits)]])
        dist[impl] = rel_l2(torch, got, want)
        agree[impl] = float((torch.argmax(got[0], -1)
                             == torch.argmax(want[0], -1)).float().mean())
    log(f"serve {cfg.name} bf16 vs the f32 plain path ({len(f32_logits)} "
        f"logit rows: prefill + {len(f32_logits) - 1} decode steps): rel L2 "
        f"kernel path {dist['kernel']:.4e}, plain path {dist['torch']:.4e} "
        f"(ratio {dist['kernel'] / dist['torch']:.3f}, bound {factor}); "
        f"first-token agreement with f32: kernel path {agree['kernel']:.2f}, "
        f"plain path {agree['torch']:.2f}")
    check(dist["kernel"] <= factor * dist["torch"],
          f"serve {cfg.name}: the bf16 kernel path is {dist['kernel']} from "
          f"f32, over {factor} x the bf16 plain path's {dist['torch']}")


class RoutingRecorder:
    """Within ``with``: the expert indices (T, k) of every MoE routing the
    port makes, in call order (one call a layer in a prefill), copied;
    ``repro_torch.models.moe.top_k_routing`` wrapped, and restored on
    exit."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []

    def __enter__(self):
        route = self.orig = self.moe.top_k_routing

        def recorded(logits, k):
            weights, indices = route(logits, k)
            self.calls.append(indices.clone())
            return weights, indices
        self.moe.top_k_routing = recorded
        return self

    def __exit__(self, *exc):
        self.moe.top_k_routing = self.orig


def family_extras(torch, dev, cfg, batch, seed):
    """The VLM's patch embeddings or the audio family's frame embeddings
    (the stub frontends' outputs), numpy-seeded normal draws in bf16."""
    rng = np.random.default_rng(seed)
    size = {"vlm": ("patches", cfg.num_image_tokens),
            "audio": ("frames", cfg.n_audio_frames)}.get(cfg.family)
    if size is None:
        return {}
    return {size[0]: torch.from_numpy(rng.normal(
        size=(batch, size[1], cfg.d_model)).astype(np.float32)).to(
            dev, torch.bfloat16)}


def _family_paths(torch, engines, prompts, extras, forced, counters, route):
    """Prefill, then the decode loop teacher-forced on ``forced``, through
    each engine: per path the prefill's logits, launches and wall, every
    step's logits and the decode's ms a step; with ``route`` the MoE
    routings of the prefill."""
    runs = {}
    start = engines["graph"].start(prompts.shape[1])
    for name, eng in engines.items():
        torch.cuda.synchronize()
        reset(counters)
        recorder = RoutingRecorder() if route else None
        t0 = time.perf_counter()
        if recorder is not None:
            with recorder:
                logits, _ = eng.prefill(prompts, extras)
        else:
            logits, _ = eng.prefill(prompts, extras)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = read(counters)
        eng.decode_loop(prompts.shape[0])     # captured here, not timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = _forced_steps(eng, logits, start, forced)
        torch.cuda.synchronize()
        runs[name] = dict(
            logits=logits, steps=steps, launches=launches,
            prefill_s=prefill_s, routes=recorder.calls if route else None,
            decode_ms=1e3 * (time.perf_counter() - t0) / forced.shape[1])
    return runs


def _moe_f32(torch, dev, cfg, prompts, extras, forced, counters):
    """The MoE config at MOE_F32_DEPTH layers in f32: the kernel path (the
    split-TF32 flash kernel) against the plain path on one copy of the
    weights, prefill and teacher-forced steps' logits held to
    SSM_F32_LOGITS_REL_L2, with the routing agreement."""
    from repro_torch.launch.serve import ServeEngine
    c = dataclasses.replace(cfg, n_layers=MOE_F32_DEPTH, dtype="float32")
    max_len = prompts.shape[1] + forced.shape[1] + 1
    kernel = ServeEngine(c, dev, max_len=max_len, dtype=torch.float32,
                         graphs=False)
    engines = {"graph": kernel,
               "plain": ServeEngine(c, dev, max_len=max_len,
                                    dtype=torch.float32, attn_impl="torch",
                                    graphs=False, params=kernel.params)}
    runs = _family_paths(torch, engines, prompts, extras, forced, counters,
                         True)
    expect = serve_launches(c, bf16=False)
    check(runs["graph"]["launches"] == expect,
          f"{cfg.name} f32 prefill launches {runs['graph']['launches']}, "
          f"expected {expect}")
    kr, tr = runs["graph"], runs["plain"]
    rels = [rel_l2(torch, a, b) for a, b in
            zip([kr["logits"]] + kr["steps"], [tr["logits"]] + tr["steps"])]
    agree = [float((a == b).float().mean())
             for a, b in zip(kr["routes"], tr["routes"])]
    log(f"family {cfg.name} f32 at depth {MOE_F32_DEPTH}, kernel vs plain: "
        f"prefill logits rel L2 {rels[0]:.4e}, {len(rels) - 1} decode steps "
        f"max {max(rels[1:]):.4e} (bound {SSM_F32_LOGITS_REL_L2}); routing "
        f"agreement by layer {[round(a, 6) for a in agree]}; launches "
        f"{kr['launches']}")
    check(max(rels) <= SSM_F32_LOGITS_REL_L2,
          f"{cfg.name} f32 kernel vs plain logits rel L2 {max(rels)}")
    del engines, kernel, runs, kr, tr
    torch.cuda.empty_cache()


def phase_family(torch, dev, arch, depth, prompt_len, gen, seed):
    """One family model at full width (``depth`` layers kept, all if None)
    served as phase 6 serves smollm: ``generate`` on the kernel path with
    the decode loop as graph replays (flash launches counted: one an
    attention a prefill, all on the bf16 tensor-core kernel; peak memory
    under FAMILY_PEAK_GB), once more (no capture), then an engine with
    ``graphs=False`` and one on the plain path (``attn_impl="torch"``),
    both on the first engine's weights (one copy): tokens identical, the
    teacher-forced logits of the replayed step bitwise the eager step's,
    the kernel path against the plain path (relative L2 LOGITS_REL_L2 for
    every family; an MoE's routing agreement by layer is logged, and an MoE
    also runs the f32 check at MOE_F32_DEPTH layers)."""
    from repro_torch.config import get_arch
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.runtime import graphs as G
    cfg = get_arch(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    counters = serve_counters()
    expect = serve_launches(cfg)
    t_model = time.perf_counter()
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(SERVE_BATCH, prompt_len))).to(dev)
    extras = family_extras(torch, dev, cfg, SERVE_BATCH, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = cfg.num_image_tokens if cfg.family == "vlm" else 0
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, dev, max_len=before + prompt_len + gen + 1)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.params.parameters())
    weights = sum(p.numel() * p.element_size()
                  for p in engine.params.parameters())
    log(f"family {cfg.name} ({cfg.family}): {cfg.n_layers} layers"
        f"{f' (of {get_arch(arch).n_layers})' if depth else ''}, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, {n_params / 1e9:.3f} B params, bf16 "
        f"weights {weights / 1e9:.2f} GB drawn leaf by leaf in "
        f"{time.perf_counter() - t0:.2f} s ({resident / 1e9:.2f} GB held on the "
        f"card before them); {SERVE_BATCH} x ({before} image "
        f"positions + {prompt_len} prompt tokens + {gen} new), "
        f"{cfg.n_audio_frames} audio frames")

    # the main path, as a user calls it: the decode loop as graph replays
    reset(counters)
    captures = G.CAPTURES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, gen, extras)
    wall = time.perf_counter() - t0
    launches = read(counters)
    peak = torch.cuda.max_memory_allocated()
    check(tokens.shape == (SERVE_BATCH, gen), f"tokens {tokens.shape}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          f"{cfg.name}: generated token ids out of range")
    check(launches == expect, f"{cfg.name}: launches in one generate "
          f"{launches}, expected {expect} (one prefill; decode runs none)")
    check(peak < FAMILY_PEAK_GB * 1e9, f"{cfg.name}: peak {peak / 1e9:.2f} "
          f"GB over {FAMILY_PEAK_GB} GB")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = engine.generate(prompts, gen, extras)
    wall_again = time.perf_counter() - t0
    check(G.CAPTURES - captures == 1, f"{cfg.name}: {G.CAPTURES - captures} "
          f"captures over two generate calls")
    check(np.array_equal(again, tokens),
          f"{cfg.name}: a second generate gave other tokens")
    eager = ServeEngine(cfg, dev, max_len=engine.max_len, graphs=False,
                        params=engine.params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens_e = eager.generate(prompts, gen, extras)
    wall_e = time.perf_counter() - t0
    check(np.array_equal(tokens_e, tokens),
          f"{cfg.name}: graphs=False generated other tokens "
          f"({int((tokens_e != tokens).sum())} of {tokens.size} differ)")
    check(G.CAPTURES - captures == 1, f"{cfg.name}: the eager engine "
          f"captured")
    log(f"family {cfg.name} generate (graphs): wall {wall:.4f} s, "
        f"{tokens.size / wall:.1f} new tokens/s (the first call: it "
        f"captures the step); again {wall_again:.4f} s, "
        f"{tokens.size / wall_again:.1f} new tokens/s (no capture); "
        f"graphs=False {wall_e:.4f} s, {tokens.size / wall_e:.1f} new "
        f"tokens/s; tokens identical; 1 capture; flash launches in the "
        f"prefill {launches['flash_attention_tc']} of "
        f"{launches['flash_attention']} on the bf16 tensor-core kernel; "
        f"peak memory {peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB; weights "
        f"{weights / 1e9:.2f} GB)")

    # graph, eager and plain paths, step by step on the graph's tokens
    plain = ServeEngine(cfg, dev, max_len=engine.max_len, attn_impl="torch",
                        graphs=False, params=engine.params)
    forced = torch.from_numpy(tokens).to(dev).long()
    runs = _family_paths(torch, {"graph": engine, "eager": eager,
                                 "plain": plain}, prompts, extras, forced,
                         counters, cfg.is_moe)
    none = {name: 0 for name in counters}
    check(runs["graph"]["launches"] == expect
          and runs["eager"]["launches"] == expect
          and runs["plain"]["launches"] == none,
          f"{cfg.name}: prefill launches "
          f"{[r['launches'] for r in runs.values()]}")
    gr, er, pr = runs["graph"], runs["eager"], runs["plain"]
    same = [torch.equal(a, b) for a, b in zip(gr["steps"], er["steps"])]
    check(torch.equal(gr["logits"], er["logits"]) and all(same),
          f"{cfg.name}: graphed decode logits differ from the eager step's "
          f"at steps {[i for i, v in enumerate(same) if not v]}")
    greedy = torch.stack([torch.argmax(t, dim=-1) for t in
                          [gr["logits"]] + gr["steps"][:-1]], dim=1)
    check(torch.equal(greedy, forced),
          f"{cfg.name}: the logits do not reproduce the generated tokens")
    for t in [gr["logits"]] + gr["steps"]:
        check(bool(torch.isfinite(t).all()), f"{cfg.name}: logits not finite")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.prefill(prompts, extras)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rels = [rel_l2(torch, a, b) for a, b in
            zip([gr["logits"]] + gr["steps"], [pr["logits"]] + pr["steps"])]
    agree = float((torch.argmax(gr["logits"], -1)
                   == torch.argmax(pr["logits"], -1)).float().mean())
    routing = ""
    if cfg.is_moe:
        by_layer = [float((a == b).float().mean())
                    for a, b in zip(gr["routes"], pr["routes"])]
        check(len(by_layer) == cfg.n_layers, f"{cfg.name}: "
              f"{len(by_layer)} routings recorded of {cfg.n_layers} layers")
        routing = (f"; MoE routing agreement of the (token, slot) experts, "
                   f"kernel vs plain prefill, by layer "
                   f"{[round(a, 6) for a in by_layer]} (min "
                   f"{min(by_layer):.6f})")
    log(f"family {cfg.name} prefill {float(np.median(times)):.4f} s (median "
        f"of 3; first {gr['prefill_s']:.4f} s, eager engine "
        f"{er['prefill_s']:.4f} s, plain path {pr['prefill_s']:.4f} s); "
        f"decode teacher-forced: graph {gr['decode_ms']:.3f} ms a step "
        f"({1e3 * SERVE_BATCH / gr['decode_ms']:.1f} tokens/s), eager "
        f"{er['decode_ms']:.3f} ms ({1e3 * SERVE_BATCH / er['decode_ms']:.1f}"
        f" tokens/s), {er['decode_ms'] / gr['decode_ms']:.2f}x; "
        f"teacher-forced logits graph vs eager: {sum(same)} of {len(same)} "
        f"steps bitwise")
    log(f"family {cfg.name} bf16 kernel vs plain: prefill logits rel L2 "
        f"{rels[0]:.4e}, {len(rels) - 1} decode steps max "
        f"{max(rels[1:]):.4e} median {float(np.median(rels[1:])):.4e} "
        f"(bound {LOGITS_REL_L2}); first-token agreement "
        f"{agree:.2f}{routing}")
    check(max(rels) <= LOGITS_REL_L2, f"{cfg.name}: bf16 kernel vs plain "
          f"logits rel L2 {max(rels)} > {LOGITS_REL_L2}")
    peak_all = torch.cuda.max_memory_allocated()
    check(peak_all < FAMILY_PEAK_GB * 1e9, f"{cfg.name}: peak "
          f"{peak_all / 1e9:.2f} GB over {FAMILY_PEAK_GB} GB")
    del engine, eager, plain, runs, gr, er, pr
    torch.cuda.empty_cache()
    if cfg.is_moe:
        _moe_f32(torch, dev, cfg, prompts, extras,
                 forced[:, :MOE_F32_STEPS], counters)
    log(f"family {cfg.name}: peak memory of the three engines "
        f"{peak_all / 1e9:.2f} GB; {time.perf_counter() - t_model:.1f} s")
    return launches


def phase_families(torch, dev):
    """Every family the port serves beside smollm, mamba2 and zamba2, each
    through :func:`phase_family` (FAMILY_RUNS), after a check on the card
    that equal gates route to the lowest experts (the reference's order);
    returns the flash launches of each model's generate. The SVM phases'
    kept captures and cuBLAS's workspaces (32 MiB a stream it ran on) are
    dropped first: an MoE's peak nears FAMILY_PEAK_GB."""
    from repro_torch.core import svm
    from repro_torch.models import moe
    svm.DMS_GRAPHS.clear()
    _release(torch)
    held = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    _release(torch)
    log(f"families: {held / 1e9:.3f} GB held on the card at the start, "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB once cuBLAS's "
        f"workspaces (one a stream it ran on) were dropped")
    for e, k in ((16, 2), (128, 8)):
        _, idx = moe.top_k_routing(torch.zeros((SERVE_BATCH * SERVE_PROMPT,
                                                e), device=dev), k)
        check(torch.equal(idx, torch.arange(k, device=dev).expand_as(idx)),
              f"equal gates over {e} experts routed to {idx[0].tolist()}")
        logits = torch.from_numpy(np.random.default_rng(e).normal(
            size=(SERVE_BATCH * SERVE_PROMPT, e)).astype(np.float32))
        _, on_card = moe.top_k_routing(logits.to(dev), k)
        _, on_cpu = moe.top_k_routing(logits, k)
        check(torch.equal(on_card.cpu(), on_cpu),
              f"top-{k} of {e} experts differs between the card and the CPU")
    log("families: equal gates over 16 and 128 experts route to experts "
        "0..k-1 on the card; random gates route as on the CPU")
    launches = {}
    for i, (arch, depth, prompt_len, gen) in enumerate(FAMILY_RUNS):
        launches[arch] = phase_family(torch, dev, arch, depth, prompt_len,
                                      gen, 700 + i)
    return launches


def ssd_inputs(torch, dev, seed, shape, dtype, copies=1):
    """``copies`` independent (x, dt, a, B, C) sets, TestSSD's draws made
    with numpy from ``seed``: x, B, C in ``dtype``, Δ and A float32."""
    b, l, h, p, n = shape[:5]
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)
    return [(t(rng.normal(size=(b, l, h, p)), dtype),
             t(rng.uniform(0.001, 0.1, size=(b, l, h))),
             t(-rng.uniform(0.5, 2.0, size=(h,))),
             t(rng.normal(size=(b, l, n)), dtype),
             t(rng.normal(size=(b, l, n)), dtype)) for _ in range(copies)]


def ssd_bound(shape, itemsize):
    """(bound_ms, bound_by): x, B, C read once, Δ and A read once, y and
    the f32 state written once, over the HBM rate; or the chunked
    algorithm's products over the tensor-core rate of the inputs' type
    (float32 on the CUDA cores): per chunk of q rows the causal triangle of
    the scores (C Bᵀ, once per batch and chunk: no head in it) and of their
    product with x, the inter-chunk C·S and the state's Bᵀ·x."""
    import torch
    from repro_torch.kernels.ssd.ops import ssd_work
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    return work_bound(ssd_work(*shape, dtype=dtype))


def phase_ssd(torch, dev):
    """The SSD kernels against their plain versions: the CUDA-core kernel at
    the TestSSD shapes in f32 and the tensor-core kernel at the same shapes
    in bf16, both against the exact recurrence; the tensor-core kernel at
    the serving prefill shapes against the plain chunked scan, timed beside
    the CUDA-core kernel on the same inputs. Returns the main row
    (mamba2-2.7b's prefill), timed against the chunked scan, the plain path
    the model takes."""
    from repro_torch.kernels.ssd import ops, ref
    from repro_torch.models.ssm import ssd_chunked
    cases = [(shape, torch.float32) for shape in SSD_SHAPES]
    cases += [(shape, torch.bfloat16) for shape in SSD_SHAPES + SSD_PREFILLS]
    main_row = None
    for i, (shape, dtype) in enumerate(cases):
        b, l, h, p, n, chunk = shape
        itemsize = torch.finfo(dtype).bits // 8
        per_set = itemsize * (2 * b * l * h * p + 2 * b * l * n)
        copies = int(min(64, max(2, -(-2 * L2_BYTES // per_set))))
        sets = ssd_inputs(torch, dev, 400 + i, shape, dtype, copies)
        args = sets[0]
        kind = "tc" if dtype == torch.bfloat16 else "simt"
        serving = shape in SSD_PREFILLS
        launches, tc_launches = ops.LAUNCHES, ops.TC_LAUNCHES
        y, s = ops.ssd_scan(*args, chunk=chunk)
        y2, s2 = ops.ssd_scan(*args, chunk=chunk)
        check(ops.kernel_for(args[0], args[3], args[4]) == kind and
              ops.LAUNCHES == launches + 2 and
              ops.TC_LAUNCHES == tc_launches + 2 * (kind == "tc"),
              f"ssd {shape} {dtype}: expected two launches of the {kind} "
              f"kernel")
        if serving:
            yr, sr = ssd_chunked(*args, chunk)
            y_tol, versus = SSD_BF16_Y_TOL, "chunked scan"
        else:
            yr, sr = ref.ssd_scan(*args)
            y_tol = SSD_F32_TOL if kind == "simt" else SSD_BF16_Y_TOL
            versus = "recurrence"
        torch.cuda.synchronize()
        label = f"b={b},l={l},h={h},p={p},n={n},chunk={chunk},{str(dtype)[6:]}"
        check(y.shape == yr.shape and y.dtype == dtype
              and s.shape == (b, h, n, p) and s.dtype == torch.float32,
              f"ssd {label}: outputs {tuple(y.shape)} {y.dtype}, "
              f"{tuple(s.shape)} {s.dtype}")
        check(torch.equal(y, y2) and torch.equal(s, s2),
              f"ssd {label}: two launches differ")
        err = float((y.float() - yr.float()).abs().max())
        s_err = float((s - sr).abs().max())
        check(torch.allclose(y.float(), yr.float(), **y_tol),
              f"ssd {label}: y max abs err {err} vs the plain {versus}")
        check(torch.allclose(s, sr, **SSD_F32_TOL),
              f"ssd {label}: state max abs err {s_err} vs the plain "
              f"{versus}")
        del y, s, y2, s2, yr, sr

        def kernel(*a):
            return ops.ssd_scan(*a, chunk=chunk)

        def plain(*a):
            return ssd_chunked(*a, chunk)

        ms = device_ms(torch, kernel, sets)
        plain_ms = device_ms(torch, plain, sets)
        bound_ms, bound_by = ssd_bound(shape, itemsize)
        log(f"ssd {label}: {kind} kernel vs the plain {versus} y max_abs_err "
            f"{err:.3e}, state {s_err:.3e}; bitwise-repeatable; kernel "
            f"{ms * 1e3:.4f} us, plain chunked scan {plain_ms * 1e3:.4f} us, "
            f"bound {bound_ms * 1e3:.4f} us ({bound_by}), kernel at "
            f"{100 * bound_ms / ms:.2f}% of it [{copies} input sets]")
        if serving:
            # the CUDA-core kernel that served these inputs before, timed on
            # the same inputs in the same run
            def simt(*a):
                return ops.run_kernel("simt", *a, chunk)
            simt_ms = device_ms(torch, simt, sets)
            log(f"ssd {label}: tensor-core kernel {ms * 1e3:.4f} us "
                f"({100 * bound_ms / ms:.2f}% of the bound), CUDA-core "
                f"kernel on the same inputs {simt_ms * 1e3:.4f} us "
                f"({100 * bound_ms / simt_ms:.2f}%), {simt_ms / ms:.1f}x")
        if shape == SSD_MAIN:
            recurrence_ms = device_ms(torch, ref.ssd_scan, sets[:1], runs=3)
            log(f"ssd main shape: the exact recurrence {recurrence_ms:.3f} "
                f"ms a call (the CPU path's plain version, {l:,} steps)")
            main_row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None)
        del sets, args
        torch.cuda.empty_cache()
    return main_row


def event_ms(torch, fn, args, runs: int = 11) -> float:
    """Device time of one ``fn(*args)`` call from CUDA events around each of
    ``runs`` calls after one warm-up call (no CUDA graph, for a library call
    that may not be capturable); the median."""
    fn(*args)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def quant_bound(numel: int, residual: bool):
    """(bound_ms, bound_by) of one quantize call (4 bytes read, 1 written an
    element, 4 more written with the residual) and of one dequantize call
    (1 read, 4 written): bytes over the HBM rate."""
    from repro_torch.kernels.quant.ops import dequantize_work, quantize_work
    return (work_bound(quantize_work(numel, residual))[0],
            work_bound(dequantize_work(numel))[0])


def phase_quant(torch, dev):
    """The quant kernels against their plain version; returns the main
    row: one quantize (with the residual, as the sync calls it) and one
    dequantize of the trainer's largest leaf."""
    import warnings
    from repro_torch.kernels.quant import ops, ref
    main_row = None
    for i, (shape, rows) in enumerate(QUANT_SHAPES + [QUANT_MAIN]):
        numel = int(np.prod(shape))
        copies = int(min(16, max(1, -(-2 * L2_BYTES // (4 * numel)))))
        rng = np.random.default_rng(300 + i)
        sets = [(torch.from_numpy((rng.normal(size=shape) * 0.01)
                                  .astype(np.float32)).to(dev),)
                for _ in range(copies)]
        x = sets[0][0]
        q, s, res = ops.quantize(x, rows=rows, residual=True)
        q2, s2, res2 = ops.quantize(x, rows=rows, residual=True)
        deq = ops.dequantize(q, s)
        qr, sr = ref.quantize(x, rows=rows)
        deqr = ref.dequantize(qr, sr)
        torch.cuda.synchronize()
        label = f"{'rows ' if rows else ''}{shape}"
        for name, a, b in (("int8", q, qr), ("scale", s, sr),
                           ("dequantized", deq, deqr),
                           ("residual", res, x - deqr)):
            check(torch.equal(a, b), f"quant {label}: {name} differs from the "
                  f"plain version")
        check(torch.equal(q, q2) and torch.equal(s, s2)
              and torch.equal(res, res2), f"quant {label}: two launches differ")
        half = s.reshape(s.shape + (1,) * (x.dim() - s.dim())) / 2
        check(bool(((deq - x).abs() <= half + 1e-6).all()),
              f"quant {label}: round-trip error above scale/2")
        err = float((deq - deqr).abs().max())
        del q, s, res, q2, s2, res2, deq, qr, sr, deqr

        def kernel_q(t):
            return ops.quantize(t, rows=rows, residual=True)

        def plain_q(t):
            qq, ss = ref.quantize(t, rows=rows)
            return qq, ss, t - ref.dequantize(qq, ss)

        ms_q = device_ms(torch, kernel_q, sets)
        plain_q_ms = device_ms(torch, plain_q, sets)
        qs = [ops.quantize(t, rows=rows) for (t,) in sets]
        ms_d = device_ms(torch, ops.dequantize, qs)
        plain_d_ms = device_ms(torch, ref.dequantize, qs)
        bound_q, bound_d = quant_bound(numel, True)
        log(f"quant {label}: bitwise equal to the plain version, "
            f"bitwise-repeatable; quantize+residual kernel {ms_q * 1e3:.4f} "
            f"us plain {plain_q_ms * 1e3:.4f} us bound {bound_q * 1e3:.4f} "
            f"us; dequantize kernel {ms_d * 1e3:.4f} us plain "
            f"{plain_d_ms * 1e3:.4f} us bound {bound_d * 1e3:.4f} us (bytes) "
            f"[{copies} input sets]")
        if (shape, rows) == QUANT_MAIN:
            # the yardstick: PyTorch's own int8 quantization given the scale
            # (it multiplies by the inverse scale, so it need not be bitwise
            # equal); the port never calls it
            s_main = ops.quantize(x, rows=True)[1].double()
            zeros = torch.zeros(shape[0], dtype=torch.long, device=dev)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                try:
                    lib_q = event_ms(torch, lambda t: torch.quantize_per_channel(
                        t, s_main, zeros, 0, torch.qint8), (x,))
                    qx = torch.quantize_per_channel(x, s_main, zeros, 0,
                                                    torch.qint8)
                    lib_d = event_ms(torch, torch.dequantize, (qx,))
                    library_ms = lib_q + lib_d
                    lib_note = (f"quantize_per_channel {lib_q * 1e3:.4f} us, "
                                f"dequantize {lib_d * 1e3:.4f} us")
                    del qx
                except (RuntimeError, NotImplementedError) as exc:
                    library_ms = None
                    lib_note = f"not available on this card: {exc}"
            log(f"quant main leaf {shape}: PyTorch {lib_note}; kernel pair at "
                f"{100 * (bound_q + bound_d) / (ms_q + ms_d):.2f}% of its "
                f"bound")
            main_row = dict(max_abs_err=err, ms=ms_q + ms_d,
                            plain_ms=plain_q_ms + plain_d_ms,
                            bound_ms=bound_q + bound_d, bound_by="bytes",
                            library_ms=library_ms)
        del sets, qs, x
        torch.cuda.empty_cache()
    quant_nonfinite(torch, dev)
    return main_row


def same_or_nan(torch, a, b) -> bool:
    """Bitwise equal where not NaN, NaN where the other is NaN."""
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan], b[~nan]))


def quant_nonfinite(torch, dev):
    """A leaf holding a NaN, +inf or −inf (alone, or one bad row among
    good ones): the kernel's q, scale, residual and dequantized values are
    the plain version's (NaN as NaN), with and without the residual, and
    the bad leaf or row has scale NaN or inf, q 0 and dequantizes to NaN,
    as the reference (``repro.core.compression.quantize``) gives."""
    from repro_torch.kernels.quant import ops, ref
    cases = [((4096,), False), ((1_000_003,), False), ((4, 1_000_003), True),
             ((5, 6), True)]
    for i, (shape, rows) in enumerate(cases):
        for bad in (float("nan"), float("inf"), float("-inf")):
            rng = np.random.default_rng(500 + i)
            x = torch.from_numpy((rng.normal(size=shape) * 0.01).astype(
                np.float32)).to(dev)
            flat = (x[1] if rows else x).view(-1)
            flat[min(7, flat.numel() - 1)] = bad
            q, s, res = ops.quantize(x, rows=rows, residual=True)
            q2, s2 = ops.quantize(x, rows=rows)
            deq = ops.dequantize(q, s)
            qr, sr = ref.quantize(x, rows=rows)
            deqr = ref.dequantize(qr, sr)
            torch.cuda.synchronize()
            label = f"quant {'rows ' if rows else ''}{shape} holding {bad}"
            check(torch.equal(q, qr) and torch.equal(q2, qr),
                  f"{label}: int8 differs from the plain version")
            check(same_or_nan(torch, s, sr) and same_or_nan(torch, s2, sr),
                  f"{label}: scale differs from the plain version")
            check(same_or_nan(torch, deq, deqr)
                  and same_or_nan(torch, res, x - deqr),
                  f"{label}: dequantized or residual differs")
            bq, bs, bd = (q[1], s[1], deq[1]) if rows else (q, s, deq)
            check(bool((bq == 0).all()) and not bool(torch.isfinite(bs))
                  and bool(torch.isnan(bd).all()),
                  f"{label}: the bad leaf is not scale NaN/inf, q 0, NaN")
            if rows:
                good = [r for r in range(shape[0]) if r != 1]
                check(bool(torch.isfinite(s[good]).all())
                      and bool(torch.isfinite(deq[good]).all()),
                      f"{label}: a good row was touched")
    log(f"quant non-finite leaves: NaN, +inf, -inf in {len(cases)} cases "
        f"(per tensor and one bad row among good ones), with and without "
        f"the residual: bitwise the plain version's (NaN as NaN); the bad "
        f"leaf or row scale NaN/inf, q 0, dequantized NaN")


def _tree_rel_l2(torch, got, want) -> float:
    """Relative L2 of ``got`` to ``want`` over all leaves; a leaf on the
    host is brought to the card one at a time."""
    from repro_torch import tree as T
    num = sum(float((a.to(b.device).float() - b.float()).square().sum())
              for a, b in zip(T.leaves(got), T.leaves(want)))
    den = sum(float(b.float().square().sum()) for b in T.leaves(want))
    return (num / den) ** 0.5


def _train_cfg(model_cfg, sync, seq_len, global_batch, replicas):
    from repro_torch.config import (DataConfig, MeshConfig, OptimizerConfig,
                                    TrainConfig)
    return TrainConfig(
        model=model_cfg,
        mesh=MeshConfig(shape=(replicas,), axis_names=("pod",),
                        replica_axis="pod"),
        sync=sync,
        optimizer=OptimizerConfig(name="adamw", learning_rate=1e-3,
                                  schedule="cosine", total_steps=1000),
        data=DataConfig(seq_len=seq_len, global_batch=global_batch))


def _seed_stubs(torch, batches, seed, dev):
    """The stub frontends' inputs of each batch (the VLM's patches, the
    audio frames) drawn from ``seed`` in their dtype, in place of the
    pipeline's zeros."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    for batch in batches:
        for key in ("patches", "frames"):
            if key in batch:
                batch[key] = torch.randn(batch[key].shape, generator=gen,
                                         device=dev).to(batch[key].dtype)


def _run_blocks(torch, cfg, dev, impl, blocks, on_block=None, mesh=None,
                stub_seed=None):
    """``blocks`` train steps through ``build_trainer`` on path ``impl``
    from the seeded state (with a ``mesh``, this rank's replica and rows;
    with a ``stub_seed``, the stub inputs drawn from it); returns (state,
    losses, walls, sync_ms, launches)."""
    from repro_torch.core import sync
    from repro_torch.kernels.quant import ops
    from repro_torch.launch.train import build_trainer
    step, state, make_pipeline, _, _, _ = build_trainer(cfg, dev, mesh,
                                                        quant_impl=impl)
    pipe = make_pipeline(0)
    batches = [next(pipe) for _ in range(blocks)]
    if stub_seed is not None:
        _seed_stubs(torch, batches, stub_seed, dev)
    inner, events = sync.sync_point, []

    def timed_sync(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    losses, walls = [], []
    sync.sync_point = timed_sync
    try:
        torch.cuda.synchronize()
        ops.LAUNCHES = 0
        for b in range(blocks):
            t0 = time.perf_counter()
            state, metrics = step(state, batches[b])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            if on_block is not None:
                on_block(b)
        launches = ops.LAUNCHES
    finally:
        sync.sync_point = inner
    sync_ms = [a.elapsed_time(b) for a, b in events]
    return state, step, batches, losses, walls, sync_ms, launches


def phase_train(torch, dev, model_cfg, seq_len, global_batch, replicas, h):
    """The trainer's main path: local SGD with the int8 sync on the kernel
    path, then the plain path from the same state and batches."""
    from repro_torch import tree as T
    from repro_torch.config import SyncConfig
    from repro_torch.core import compression, local_sgd
    blocks = 2
    sync_cfg = SyncConfig(strategy="periodic", period=h, compression="int8")
    cfg = _train_cfg(model_cfg, sync_cfg, seq_len, global_batch, replicas)
    tokens = h * global_batch * seq_len
    log(f"train {model_cfg.name}: {model_cfg.n_layers} layers, d_model "
        f"{model_cfg.d_model}, vocab {model_cfg.vocab_size}, "
        f"{model_cfg.dtype} compute, f32 master params; K={replicas} "
        f"replicas, H={h}, {sync_cfg.msf_label}; AdamW lr 1e-3 cosine; "
        f"{global_batch} x {seq_len} tokens a microbatch "
        f"({global_batch // replicas} sequences a replica)")

    # the first sync's int8 payloads, scales and residuals, kernel and plain
    same = []
    inner, capture = _first_sync_check(torch, same)
    torch.cuda.reset_peak_memory_stats()
    compression.compress_tree = capture
    try:
        state, step, batches, losses_k, walls_k, sync_k, launches = \
            _run_blocks(torch, cfg, dev, "kernel", blocks)
    finally:
        compression.compress_tree = inner
    peak = torch.cuda.max_memory_allocated()
    n_leaves = len(T.leaves(state["params"]))
    expect = 2 * blocks * n_leaves
    log(f"train kernel path: losses {losses_k} (first beside ln "
        f"{model_cfg.vocab_size} = {np.log(model_cfg.vocab_size):.4f}); "
        f"block wall {walls_k} s, sync {sync_k} ms, "
        f"{tokens / walls_k[-1]:.1f} trained tokens/s in block {blocks}; "
        f"quant launches {launches} (expected {expect}: one quantize and one "
        f"dequantize per leaf per sync); peak memory {peak / 2**30:.2f} GiB")
    check(launches == expect, f"train: {launches} quant launches, expected "
          f"{expect}")
    check(all(np.isfinite(losses_k)), f"train: losses {losses_k}")
    check(losses_k[1] < losses_k[0], f"train: block 2's loss {losses_k[1]} "
          f"is not below block 1's {losses_k[0]}")
    params = state["params"]
    for leaf in T.leaves(params):
        check(torch.equal(leaf[0], leaf[-1]), "train: replicas differ after "
              "a blocking sync")
    kept = T.map(lambda x: x[0].clone(), params)

    check(len(same) == n_leaves and all(same),
          f"train: the first sync's int8 payloads of {same.count(False)} of "
          f"{len(same)} leaves differ between the kernel and the plain "
          f"version")
    log(f"train first sync: the int8 payloads, scales and residuals of all "
        f"{n_leaves} leaves (K={replicas} rows each) bitwise equal, kernel "
        f"and plain")

    # one profiled block on the kernel path
    busy = device_busy(torch, lambda: step(state, batches[-1]))
    log_busy(f"train block (kernel path, {h} x {replicas} replica steps)",
             *busy)
    # phase tooling (t1): one more block under the work counter
    from repro_torch.models.registry import analytic_param_count
    _TOOLING["train"] = dict(
        what=f"{model_cfg.name} train block K={replicas} H={h} int8, "
             f"{global_batch} x {seq_len} a microbatch (block 2's wall)",
        counter=count_call(torch, lambda: step(state, batches[-1])),
        wall=walls_k[-1], records={"quantize": launches // (2 * blocks),
                                   "dequantize": launches // (2 * blocks)},
        model_flops=6.0 * analytic_param_count(model_cfg, True) * tokens,
        peak=("bfloat16", BF16_FLOPS_PER_S))
    del state, params, step
    torch.cuda.empty_cache()

    state_p, _, _, losses_p, walls_p, sync_p, launches_p = _run_blocks(
        torch, cfg, dev, "torch", blocks)
    check(launches_p == 0, "train: the plain path launched the quant kernel")
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p))
    rel = _tree_rel_l2(torch, kept, T.map(lambda x: x[0],
                                          state_p["params"]))
    log(f"train plain path: losses {losses_p}; block wall {walls_p} s, sync "
        f"{sync_p} ms; kernel vs plain: losses rel {rel_loss:.3e} (bound "
        f"{TRAIN_LOSS_REL}), params rel L2 {rel:.3e} (bound "
        f"{TRAIN_PARAMS_REL_L2})")
    check(rel_loss <= TRAIN_LOSS_REL, f"train losses rel {rel_loss}")
    check(rel <= TRAIN_PARAMS_REL_L2, f"train params rel L2 {rel}")
    del state_p, kept
    torch.cuda.empty_cache()

    # MSF = 1: every step synchronized, the same global batch, the gradient
    # over 4 slices of it
    from repro_torch.launch.train import build_trainer
    ddp_cfg = _train_cfg(model_cfg, SyncConfig(), seq_len, global_batch,
                         replicas)
    _, state, make_pipeline, model, _, _ = build_trainer(ddp_cfg, dev)
    ddp = local_sgd.make_ddp_step(model, ddp_cfg, grad_accum=replicas)
    pipe = make_pipeline(0)
    ddp_batches = [next(pipe) for _ in range(h)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ddp_losses = []
    for batch in ddp_batches:
        state, metrics = ddp(state, batch)
        ddp_losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    ddp_wall = time.perf_counter() - t0
    log(f"train make_ddp_step (MSF=1), {h} steps of {global_batch} x "
        f"{seq_len} tokens: losses {ddp_losses}; wall {ddp_wall:.4f} s, "
        f"{tokens / ddp_wall:.1f} trained tokens/s (local SGD block "
        f"{walls_k[-1]:.4f} s)")
    check(all(np.isfinite(ddp_losses)), f"ddp losses {ddp_losses}")
    del state
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the adaptive-MSF path: the SVM block ladder, the adaptive trainer, restarts
# ---------------------------------------------------------------------------

SVM_RUNGS = (32, 64, 128)


def _svm_chain(torch, dev, ds, sizes, impl, k, rungs=SVM_RUNGS):
    """``dms``'s blocking path as the block-size ladder: epoch t on the rung
    ``sizes[t]``, ``dms_ladder_switch`` where the size changes. Returns (the
    final carry's w, wall s, hinge launches, cluster launches, switches)."""
    from repro_torch.core import svm
    from repro_torch.kernels.hinge import ops
    x, y = ds[0], ds[1]
    d = x.shape[1]
    xs, ys = svm._shard_data(x, y, k)
    w0 = torch.zeros(d, device=dev)
    ladder = svm.dms_block_ladder(d=d, workers=k, block_sizes=rungs,
                                  grad_impl=impl, device=dev)
    carry = svm.dms_stepper_init(w0, k)
    switches = 0
    torch.cuda.synchronize()
    ops.LAUNCHES = ops.CLUSTER_LAUNCHES = 0
    t0 = time.perf_counter()
    for t, bs in enumerate(sizes):
        if t and bs != sizes[t - 1]:
            carry = svm.dms_ladder_switch(carry, d=d)
            switches += 1
        nb = xs.shape[1] // bs
        xb = xs[:, :nb * bs].reshape(k, nb, bs, d)
        yb = ys[:, :nb * bs].reshape(k, nb, bs)
        alpha = svm._alpha(t, w0.dtype)
        for i in range(nb):
            carry = ladder[bs](carry, xb[:, i], yb[:, i], alpha)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    w = carry["w"]
    check(torch.equal(w, w[:1].expand(w.shape)),
          f"svm ladder {impl} {sizes}: the workers' models differ after a "
          f"blocking sync")
    return w[0], wall, ops.LAUNCHES, ops.CLUSTER_LAUNCHES, switches


def phase_svm_ladder(torch, dev, ds, k=32):
    """(b) The SVM block ladder on epsilon: epoch 1 at block 64, the switch,
    epoch 2 at 128; held to the plain-gradient chain, bitwise repeatable,
    bitwise ``dms`` without a switch; then ``dms_timed_steps`` at 64 feeds
    a ``BlockTelemetry`` and an ``AdaptiveController`` over the rungs."""
    from repro_torch.config import SyncConfig
    from repro_torch.core import autotune, svm
    from repro_torch.core.telemetry import BlockTelemetry
    from repro_torch.kernels.hinge import ops
    x, y, xt, yt = ds
    d = x.shape[1]
    n_local = x.shape[0] // k
    sizes = (64, 128)
    expect = sum(n_local // bs for bs in sizes)
    xs, ys = svm._shard_data(x, y, k)
    routes = {bs: ops.kernel_for(torch.zeros((k, d), device=dev),
                                 xs[:, :bs], ys[:, :bs]) for bs in sizes}
    wk, wall_k, n, n_cluster, switches = _svm_chain(torch, dev, ds, sizes,
                                                    "kernel", k)
    wk2, _, n2, _, _ = _svm_chain(torch, dev, ds, sizes, "kernel", k)
    wt, wall_t, n_t, _, _ = _svm_chain(torch, dev, ds, sizes, "torch", k)
    check(bool(torch.isfinite(wk).all()), "svm ladder: model not finite")
    acc_k = float(svm.accuracy(wk, xt, yt))
    acc_t = float(svm.accuracy(wt, xt, yt))
    rel = float((wk - wt).norm() / wt.norm())
    log(f"svm ladder epsilon K={k} rungs {SVM_RUNGS}: epoch 1 at 64, "
        f"{switches} switch, epoch 2 at 128; hinge launches {n} (expected "
        f"{expect}: the blocks), {n_cluster} on the cluster kernel (routes "
        f"{routes}); plain-path launches {n_t}; test acc kernel {acc_k:.4f} "
        f"plain {acc_t:.4f}; rel L2(w) {rel:.3e}; wall kernel {wall_k:.4f} s "
        f"plain {wall_t:.4f} s")
    check(switches == 1, f"svm ladder: {switches} switches")
    check(n == n2 == expect and n_t == 0,
          f"svm ladder: launches {n}/{n2}/{n_t}, expected {expect}")
    check(n_cluster == (n if set(routes.values()) == {"cluster"} else
                        sum(n_local // bs for bs in sizes
                            if routes[bs] == "cluster")),
          f"svm ladder: {n_cluster} of {n} launches on the cluster kernel, "
          f"routes {routes}")
    check(torch.equal(wk, wk2), "svm ladder: two kernel runs differ")
    check(rel <= W_REL_L2, f"svm ladder: rel L2 {rel} > {W_REL_L2}")
    check(abs(acc_k - acc_t) <= ACC_DIFF,
          f"svm ladder: accuracy {acc_k} vs {acc_t}")

    # without a switch the ladder is dms: the same blocks, sync and alpha
    w64, wall64, n64, _, _ = _svm_chain(torch, dev, ds, (64, 64), "kernel", k)
    w0 = torch.zeros(d, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wd = svm.dms(w0, x, y, workers=k, epochs=2, block_size=64, device=dev)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    same = torch.equal(w64, wd)
    log(f"svm ladder at 64 without a switch vs dms(block 64, 2 epochs): "
        f"bitwise {same}, max abs diff {float((w64 - wd).abs().max()):.3e}; "
        f"{n64} launches; wall ladder {wall64:.4f} s dms {wall_d:.4f} s")
    check(same, "svm ladder at 64 differs from dms(backend='vmap')")

    busy = device_busy(torch, lambda: _svm_chain(torch, dev, ds, sizes,
                                                 "kernel", k))
    log_busy("svm ladder (64, switch, 128)", *busy)
    busy = device_busy(torch, lambda: svm.dms(
        w0, x, y, workers=k, epochs=2, block_size=64, device=dev))
    log_busy("dms epsilon (block 64, 2 epochs)", *busy)

    # the paper's Figs 10-12 method: compute and sync timed apart, feeding
    # the telemetry and a controller over the rungs
    tel = BlockTelemetry()
    compute, sync = svm.dms_timed_steps(block_size=64, telemetry=tel)
    ctrl = autotune.AdaptiveController(
        SyncConfig(strategy="periodic", period=64), param_bytes_per_chip=4 * d,
        replicas=k, telemetry=tel, ladder=SVM_RUNGS, h0=64)
    nb = n_local // 64
    xb = xs[:, :nb * 64].reshape(k, nb, 64, d)
    yb = ys[:, :nb * 64].reshape(k, nb, 64)
    ops.LAUNCHES = 0
    w = w0
    for i in range(nb):
        w = sync(compute(w, xb[:, i], yb[:, i], svm._alpha(0, w0.dtype)))
        ctrl.observe_block()
    t_step, t_sync = tel.estimates()
    _TOOLING["svm_timed"] = dict(t_step=t_step, t_sync=t_sync, k=k, d=d,
                                 block=64)
    log(f"svm timed steps at 64 ({nb} blocks, {ops.LAUNCHES} hinge "
        f"launches): T_step {1e6 * t_step:.4f} us a point, T_sync "
        f"{1e6 * t_sync:.4f} us a block (host clock, each call waited for); "
        f"the controller over {SVM_RUNGS} picks block size {ctrl.h} "
        f"(history {ctrl.history})")
    check(ops.LAUNCHES == nb, f"svm timed steps: {ops.LAUNCHES} launches")
    check(ctrl.h in SVM_RUNGS, f"svm controller picked {ctrl.h}")
    return n


def _host(torch, tree):
    """A copy of ``tree`` in page-locked host memory (a full-width state is
    ~23 GB: a pageable copy runs at ~1 GB/s)."""
    from repro_torch import tree as T

    def copy(x):
        if not isinstance(x, torch.Tensor):
            return x
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
        return h.copy_(x)
    return T.map(copy, tree)


def _device(torch, tree, dev):
    from repro_torch import tree as T
    return T.map(lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x,
                 tree)


def _same(torch, got, want, what):
    """Bitwise: every leaf of ``got`` equals ``want``'s (either may lie on
    the host or the card; compared a leaf at a time where ``want``'s
    lies)."""
    from repro_torch import tree as T
    a, b = T.leaves(got), T.leaves(want)
    check(len(a) == len(b), f"{what}: {len(a)} leaves against {len(b)}")
    for x, z in zip(a, b):
        if isinstance(x, torch.Tensor):
            check(torch.equal(x.to(z.device), z), f"{what}: a leaf differs")
        else:
            check(x == z, f"{what}: {x} != {z}")


def _rung_walls(runner, ladder):
    """{H: [wall s of each block run at H]} from the runner's log and the
    ladder's trajectory."""
    walls = {}
    for m in runner.metrics_log:
        h = [h for b, h in ladder.trajectory if b <= m["step"]][-1]
        walls.setdefault(h, []).append(m["elapsed"])
    return walls


def phase_adaptive_train(torch, dev, model_cfg, seq_len, global_batch,
                         replicas, blocks=8):
    """(a) The adaptive trainer at full width: a forced switch at the first
    block boundary held bitwise to ``ladder_switch_state`` and to a fresh
    ``make_train_step``, then ``blocks`` blocks through ``StepRunner`` with
    the live controller over the ladder (1, 2, 4)."""
    from repro_torch import tree as T
    from repro_torch.config import FaultToleranceConfig, SyncConfig
    from repro_torch.core import local_sgd
    from repro_torch.kernels.quant import ops
    from repro_torch.launch.train import build_trainer
    from repro_torch.runtime import StepRunner
    sync_cfg = SyncConfig(strategy="periodic", period=4, compression="int8",
                          adaptive=True, adapt_ladder=(1, 2, 4),
                          adapt_every=2)
    cfg = _train_cfg(model_cfg, sync_cfg, seq_len, global_batch, replicas)
    log(f"adaptive train {model_cfg.name}: K={replicas}, "
        f"{sync_cfg.msf_label}, ladder {sync_cfg.ladder_rungs()}, re-solve "
        f"every {sync_cfg.adapt_every} blocks; {global_batch} x {seq_len} "
        f"tokens a microbatch")

    # the forced switch at the first block boundary: the pre-switch
    # snapshot on the card, the switched one on the host (the next block
    # needs the card's memory)
    t0 = time.perf_counter()
    step, state, make_pipeline, model, _, ladder = build_trainer(cfg, dev)
    pipe = make_pipeline(0)
    state, _ = ladder.rungs[4](state, next(pipe))
    pre = T.map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                state)
    switched = ladder.switch_fn(state)
    del state
    want = local_sgd.ladder_switch_state(pre, cfg)
    _same(torch, switched, want, "forced switch vs ladder_switch_state")
    del want, pre
    sw = _host(torch, switched)
    batch = next(ttrain_blocked(cfg, 2, pipe.state()["step"], dev))
    got, m_rung = ladder.rungs[2](switched, batch)
    loss_rung = float(m_rung["loss"])
    got = _host(torch, got)
    del switched
    torch.cuda.empty_cache()
    fresh = local_sgd.make_train_step(model, cfg)
    ref_state, m_fresh = fresh(_device(torch, sw, dev), batch)
    _same(torch, got, ref_state, "rung 2 after the switch vs a fresh "
          "make_train_step")
    check(loss_rung == float(m_fresh["loss"]), "forced switch: losses differ")
    log(f"adaptive train forced switch 4 -> 2 after block 1: the switched "
        f"state bitwise ladder_switch_state of the pre-switch snapshot; the "
        f"next block on rung 2 bitwise a fresh make_train_step from the "
        f"switched snapshot (loss {loss_rung}); "
        f"{time.perf_counter() - t0:.1f} s")
    del ref_state, got, sw, step, ladder, fresh, m_rung, m_fresh
    torch.cuda.empty_cache()

    # the live run: StepRunner over the ladder, checkpoints off. The quant
    # library is dropped first, as in a fresh process, so that the ladder's
    # warmup must load it and the compile counter has a load to hear
    torch.cuda.reset_peak_memory_stats()
    ops._LIB = None
    step, state, make_pipeline, _, telemetry, ladder = build_trainer(cfg, dev)
    n_leaves = len(T.leaves(state["params"]))
    runner = StepRunner(step, None, FaultToleranceConfig(max_restarts=0), 1,
                        make_pipeline, ladder=ladder)
    torch.cuda.synchronize()
    ops.LAUNCHES = 0
    t0 = time.perf_counter()
    state, end = runner.run(state, 0, blocks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    ad = ladder.to_dict()
    walls = _rung_walls(runner, ladder)
    per_rung = "; ".join(
        f"H={h}: {len(w)} blocks, wall {w} s, "
        f"{h * global_batch * seq_len / min(w):.1f} trained tokens/s "
        f"(fastest block)" for h, w in sorted(walls.items()))
    est = telemetry.estimates()
    log(f"adaptive train: {end} blocks in {wall:.3f} s; H trajectory "
        f"{ad['h_trajectory']}, {ad['switches']} switches, controller "
        f"history {ladder.controller.history}; {per_rung}")
    log(f"adaptive train telemetry: T_step {est[0]:.6f} s a replica-set "
        f"step, T_sync {1e3 * est[1]:.3f} ms a sync (CUDA events around "
        f"sync_point); {telemetry.to_dict()}; compiles total "
        f"{ad['compiles_total']}, after warmup {ad['compiles_after_warmup']}; "
        f"quant launches {launches} ({launches / end:.1f} a block, expected "
        f"{2 * n_leaves}); peak memory {peak / 2**30:.2f} GiB")
    check(peak <= 75e9, f"adaptive train: peak memory {peak / 1e9:.2f} GB "
          f"over 75 GB")
    check(ad["compiles_total"] > 0,
          "adaptive train: the compile counter heard no load in the warmup")
    check(ad["compiles_after_warmup"] == 0,
          f"adaptive train: {ad['compiles_after_warmup']} compiles after "
          f"warmup")
    check(all(h in ad["ladder"] for _, h in ad["h_trajectory"]),
          f"adaptive train: a rung outside the ladder {ad['h_trajectory']}")
    check(end == blocks and launches == 2 * n_leaves * blocks,
          f"adaptive train: {launches} quant launches over {end} blocks, "
          f"expected {2 * n_leaves} a block")
    losses = [m["loss"] for m in runner.metrics_log]
    check(all(np.isfinite(losses)), f"adaptive train: losses {losses}")
    check(losses[-1] < losses[0], f"adaptive train: losses {losses}")
    log(f"adaptive train losses: {losses}")

    pipe = make_pipeline(runner.metrics_log[-1]["step"] + 1)
    batch = next(pipe)
    busy = device_busy(torch, lambda: ladder.step_fn(state, batch))
    log_busy(f"adaptive train block (rung H={ladder.h}, {ladder.h} x "
             f"{replicas} replica steps)", *busy)
    del state, step, ladder, runner, batch
    torch.cuda.empty_cache()
    return launches


def ttrain_blocked(cfg, h, start, dev, mesh=None):
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.train import _Blocked
    return _Blocked(DataPipeline(cfg.data, cfg.model, device=dev,
                                 start_step=start, mesh=mesh), h)


class ScriptedController:
    """A controller whose moves are a script {block: H}, so that runs with
    and without a fault take the same rungs (the live controller moves on
    measured times)."""

    def __init__(self, h0, script):
        self.h = h0
        self.script = dict(script)
        self._blocks = 0
        self.history = [(0, h0)]

    def observe_block(self, **_kw):
        self._blocks += 1
        if self._blocks in self.script:
            self.h = self.script[self._blocks]
            self.history.append((self._blocks, self.h))
        return self.h


FAULT_SCRIPT, FAULT_STEPS, FAULT_CKPT_EVERY = {2: 1, 3: 2}, 6, 3


def _fault_cfg(model_cfg, replicas):
    from repro_torch.config import SyncConfig
    return _train_cfg(model_cfg, SyncConfig(
        strategy="periodic", period=2, compression="int8", adaptive=True,
        adapt_ladder=(1, 2)), 64, 2 * replicas, replicas)


def _fault_run(torch, dev, cfg, fault, directory, mesh=None):
    """``StepRunner`` over a ladder that moves 2 -> 1 after block 2 and back
    1 -> 2 after block 3, a checkpoint every 3 blocks into ``directory``,
    ``fault`` (a ``FaultToleranceConfig``) injected; with a ``mesh`` this
    rank's runner. Returns (final state, step reached, runner, ladder,
    quant launches, the steps this process wrote a checkpoint at)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import CheckpointConfig, config_fingerprint
    from repro_torch.kernels.quant import ops
    from repro_torch.launch.train import build_trainer
    from repro_torch.runtime import LadderRuntime, StepRunner
    step, state, _, _, tel, live = build_trainer(cfg, dev, mesh)
    ladder = LadderRuntime(live.rungs, live.switch_fn,
                           ScriptedController(2, FAULT_SCRIPT),
                           telemetry=tel, device=dev,
                           compile_counter=live.compile_counter, mesh=mesh)

    def blocked(start):
        return ttrain_blocked(cfg, ladder.h, start, dev, mesh)

    ckpt = CheckpointManager(CheckpointConfig(
        directory=directory, interval_steps=FAULT_CKPT_EVERY), mesh=mesh)
    writes, write = [], ckpt._write
    ckpt._write = lambda at, *a: (writes.append(at), write(at, *a))[1]
    runner = StepRunner(step, ckpt, fault, FAULT_CKPT_EVERY, blocked,
                        fingerprint=config_fingerprint(cfg), ladder=ladder,
                        mesh=mesh)
    ops.LAUNCHES = 0
    state, end = runner.run(state, 0, FAULT_STEPS)
    torch.cuda.synchronize()
    return state, end, runner, ladder, ops.LAUNCHES, writes


def phase_fault_restart(torch, dev, model_cfg, replicas=4):
    """(c) Fault and restart on the card at smoke width, int8 on the quant
    kernel: ``StepRunner`` over a ladder that moves 2 -> 1 after block 2
    and back 1 -> 2 after block 3, on the checkpoint every 3 blocks; a
    fault after that checkpoint (step 4) and one before it (step 2, after
    the first move) both replay bitwise the run without one, the rung
    restored."""
    from repro_torch import tree as T
    from repro_torch.config import FaultToleranceConfig
    steps = FAULT_STEPS
    cfg = _fault_cfg(model_cfg, replicas)
    finals = {}
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        for fail_at in (-1, 4, 2):
            state, end, runner, ladder, launches, _ = _fault_run(
                torch, dev, cfg, FaultToleranceConfig(
                    inject_failure_at=fail_at),
                os.path.join(tmp, f"f{fail_at}"))
            ckpts = runner.ckpt.all_steps()
            finals[fail_at] = _host(torch, state)
            log(f"fault/restart (fault at step {fail_at}): {end} steps, "
                f"{runner.restarts} restarts, checkpoints {ckpts}, H "
                f"trajectory {ladder.trajectory}, rung at the end "
                f"{ladder.h}, quant launches {launches}, compiles after "
                f"warmup {ladder.to_dict()['compiles_after_warmup']}")
            check(end == steps and runner.restarts == (fail_at >= 0),
                  f"fault at {fail_at}: {end} steps, {runner.restarts} "
                  f"restarts")
            check(ladder.h == 2, f"fault at {fail_at}: rung {ladder.h}")
            check(launches > 0, f"fault at {fail_at}: no quant launch")
            if fail_at < 0:
                n_leaves = len(T.leaves(finals[fail_at]["params"]))
                check(launches == 2 * n_leaves * steps,
                      f"fault/restart: {launches} quant launches, expected "
                      f"{2 * n_leaves} a block")
            del state, ladder, runner
    for fail_at in (4, 2):
        _same(torch, finals[fail_at], finals[-1],
              f"fault at step {fail_at}: the replay vs the run without one")
    log("fault/restart: a fault after the step-3 checkpoint (which holds the "
        "move taken at that step) and one before it both replay bitwise the "
        "run without a fault (params, opt, sync, step)")


TRAIN_MODES = [dict(overlap="delayed", compression="int8"),
               dict(overlap="chunked", compression="int8"),
               dict(topology="ring", compression="int8"),
               dict(topology="pairwise", compression="int8"),
               dict(topology="ring", gossip_async=True, compression="int8"),
               dict(compression="int16")]


def phase_train_modes(torch, dev, model_cfg, replicas=4, h=2, blocks=3):
    """Every other sync mode at smoke width: kernel path against plain
    path from the same state and batches."""
    from repro_torch.config import SyncConfig
    for mode in TRAIN_MODES:
        sync_cfg = SyncConfig(strategy="periodic", period=h, chunks=3, **mode)
        cfg = _train_cfg(model_cfg, sync_cfg, 64, 2 * replicas, replicas)
        runs = {impl: _run_blocks(torch, cfg, dev, impl, blocks)
                for impl in ("kernel", "torch")}
        (sk, _, _, lk, _, _, nk), (sp, _, _, lp, _, _, np_) = (
            runs["kernel"], runs["torch"])
        rel_loss = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
        rel = _tree_rel_l2(torch, sk["params"], sp["params"])
        log(f"train mode {sync_cfg.msf_label}: losses kernel {lk} plain {lp}; "
            f"rel {rel_loss:.3e}, params rel L2 {rel:.3e}; quant launches "
            f"kernel {nk} plain {np_}")
        check(all(np.isfinite(lk)) and all(np.isfinite(lp)),
              f"{sync_cfg.msf_label}: losses not finite")
        check(rel_loss <= TRAIN_LOSS_REL and rel <= TRAIN_PARAMS_REL_L2,
              f"{sync_cfg.msf_label}: kernel vs plain rel {rel_loss} / {rel}")
        int8 = sync_cfg.compression == "int8"
        check(np_ == 0 and (nk > 0) == int8,
              f"{sync_cfg.msf_label}: quant launches {nk} / {np_}")
        del runs, sk, sp
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase train_ssm: training the SSM and hybrid families, remat
# ---------------------------------------------------------------------------

def _peak_line(peak) -> str:
    return f"{peak / 2**30:.2f} GiB = {peak / 1e9:.2f} GB"


def _release(torch) -> None:
    """Collect what is unreachable, then hand the card's cached blocks
    back before the next full-width run."""
    gc.collect()
    torch.cuda.empty_cache()


def _ssd_heads(model_cfg) -> int:
    return model_cfg.ssm.expand * model_cfg.d_model // model_cfg.ssm.head_dim


def _first_sync_check(torch, results):
    """A ``compress_tree`` stand-in that, at the first sync only, holds
    every leaf's int8 payload, scales and error-feedback residual from the
    launch the trainer makes (the quantize that writes the residual in the
    same pass) to the plain version's, bitwise, one leaf at a time (no copy
    of the tree is kept); ``results`` gets one bool a leaf. The plain
    version runs a replica row at a time (each row is quantized alone), so
    the check holds less of a large leaf at once. The comparison's own
    launches are taken off the count."""
    from repro_torch import tree as T
    from repro_torch.core import collectives as CL
    from repro_torch.core import compression
    from repro_torch.kernels.quant import ops
    inner = compression.compress_tree

    def capture(delta, ef, **kw):
        if not results:
            before = ops.LAUNCHES
            for d, e in zip(T.leaves(delta), T.leaves(ef)):
                v = d.float() + e
                got = compression.quantize_shard(
                    v, CL.WHOLE, rows=True, impl="kernel", residual=True)
                same = True
                for r in range(v.shape[0]):
                    want = compression.quantize_shard(
                        v[r:r + 1], CL.WHOLE, rows=True, impl="torch",
                        residual=True)
                    same &= all(torch.equal(g[r:r + 1], w)
                                for g, w in zip(got, want))
                    del want
                results.append(same)
                del v, got
            ops.LAUNCHES = before
        return inner(delta, ef, **kw)
    return inner, capture


def _train_local(torch, dev, label, model_cfg, about, k, h, seq_len, batch,
                 blocks, tokens, stub_seed=None):
    """Local SGD at full width with the int8 sync on the quant kernel and
    ``remat="full"``, then the plain path from the same state and batches:
    the losses, the params after ``blocks`` blocks and the first sync's
    int8 payloads held to the plain path's, the quant launches counted, the
    peak held, one block profiled. ``tokens`` are the trained tokens a block
    (the text alone for the VLM). Returns the kernel path's quant
    launches."""
    from repro_torch import tree as T
    from repro_torch.config import SyncConfig
    from repro_torch.core import compression
    sync_cfg = SyncConfig(strategy="periodic", period=h, compression="int8")
    cfg = dataclasses.replace(
        _train_cfg(model_cfg, sync_cfg, seq_len, batch, k), remat="full")
    log(f"{label} {model_cfg.name}: {about}; {model_cfg.dtype} compute, f32 "
        f"master params, remat=full; K={k} replicas, H={h}, "
        f"{sync_cfg.msf_label}; AdamW; {batch} x {seq_len} tokens a "
        f"microbatch ({batch // k} sequences a replica step)")
    same = []
    inner, capture = _first_sync_check(torch, same)
    torch.cuda.reset_peak_memory_stats()
    compression.compress_tree = capture
    t0 = time.perf_counter()
    try:
        state, step, batches, losses_k, walls_k, sync_k, launches = \
            _run_blocks(torch, cfg, dev, "kernel", blocks,
                        stub_seed=stub_seed)
    finally:
        compression.compress_tree = inner
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_leaves = len(T.leaves(state["params"]))
    expect = 2 * blocks * n_leaves
    log(f"{label} kernel path ({run_s:.1f} s with the trainer's build and "
        f"the first sync's check): losses {losses_k} (first beside ln "
        f"{model_cfg.vocab_size} = {np.log(model_cfg.vocab_size):.4f}); "
        f"block wall {walls_k} s, sync {sync_k} ms a block (CUDA events), "
        f"{tokens / walls_k[-1]:.1f} trained tokens/s in block {blocks}; "
        f"peak memory {_peak_line(peak)} (bound {TRAIN_SSM_PEAK_GB} GB)")
    log(f"{label} quant launches: {launches} (expected {expect}: one "
        f"quantize and one dequantize per leaf per sync, {n_leaves} leaves, "
        f"{blocks} blocks)")
    check(launches == expect, f"{label}: {launches} quant launches, "
          f"expected {expect}")
    check(all(np.isfinite(losses_k)), f"{label}: losses {losses_k}")
    check(peak < TRAIN_SSM_PEAK_GB * 1e9, f"{label}: peak {peak} B")
    check(len(same) == n_leaves and all(same),
          f"{label}: the first sync's int8 payloads of {same.count(False)} "
          f"of {len(same)} leaves differ between the kernel and the plain "
          f"version")
    log(f"{label} first sync: the int8 payloads, scales and residuals of "
        f"all {n_leaves} leaves (K={k} rows each) bitwise equal, kernel and "
        f"plain")
    for leaf in T.leaves(state["params"]):
        check(torch.equal(leaf[0], leaf[-1]), f"{label}: replicas differ "
              f"after a blocking sync")
    # replica 0's params on the host: the plain path's run needs the card
    kept = T.map(lambda x: x[0].to("cpu", copy=True), state["params"])
    t0 = time.perf_counter()
    busy = device_busy(torch, lambda: step(state, batches[-1]))
    log_busy(f"{label} block (kernel path, {h} x {k} replica steps; "
             f"{time.perf_counter() - t0:.1f} s with the profiler's "
             f"processing)", *busy)
    del state, step
    _release(torch)

    state_p, _, _, losses_p, walls_p, sync_p, launches_p = _run_blocks(
        torch, cfg, dev, "torch", blocks, stub_seed=stub_seed)
    check(launches_p == 0, f"{label}: the plain path launched the quant "
          f"kernel")
    plain = T.map(lambda x: x[0], state_p["params"])
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p))
    rel = _tree_rel_l2(torch, kept, plain)
    bitwise = losses_k == losses_p and all(
        torch.equal(a.to(b.device), b)
        for a, b in zip(T.leaves(kept), T.leaves(plain)))
    log(f"{label} plain path: losses {losses_p}; block wall {walls_p} s, "
        f"sync {sync_p} ms; kernel vs plain: losses rel {rel_loss:.3e} "
        f"(bound {TRAIN_LOSS_REL}), params rel L2 {rel:.3e} (bound "
        f"{TRAIN_PARAMS_REL_L2}); the whole run bitwise (losses and every "
        f"param after {blocks} blocks): {'yes' if bitwise else 'no'}")
    check(rel_loss <= TRAIN_LOSS_REL, f"{label} losses rel {rel_loss}")
    check(rel <= TRAIN_PARAMS_REL_L2, f"{label} params rel L2 {rel}")
    del state_p, kept, plain
    _release(torch)
    return launches


def _train_every_step(torch, dev, label, model_cfg, about, seq_len, batch,
                      steps, tokens, stub_seed=None, repeat=False):
    """One replica at full width, every step synchronized (MSF = 1),
    ``remat="full"``: finite losses, the peak held, one step profiled.
    ``tokens`` are the trained tokens a step. With ``repeat`` the first
    step's loss and gradient are taken twice at the start params and held
    bitwise."""
    from repro_torch import tree as T
    from repro_torch.config import SyncConfig
    from repro_torch.core import local_sgd
    from repro_torch.launch.train import build_trainer
    cfg = dataclasses.replace(
        _train_cfg(model_cfg, SyncConfig(), seq_len, batch, 1),
        remat="full")
    log(f"{label} {model_cfg.name}: {about}; remat=full; one replica, "
        f"sync_every_step (MSF = 1), AdamW, {batch} x {seq_len} tokens a "
        f"step")
    torch.cuda.reset_peak_memory_stats()
    step, state, make_pipeline, model, _, _ = build_trainer(cfg, dev)
    pipe = make_pipeline(0)
    batches = [next(pipe) for _ in range(steps)]
    if stub_seed is not None:
        _seed_stubs(torch, batches, stub_seed, dev)
    if repeat:
        # both takes on the card: a host copy of the gradients would stay
        # in the page-locked cache beside earlier phases' and fill the
        # host's memory
        takes = [local_sgd.value_and_grad(model, state["params"], batches[0])
                 for _ in range(2)]
        losses = [float(t[0]) for t in takes]
        differ = [i for i, (a, b) in enumerate(zip(T.leaves(takes[0][2]),
                                                   T.leaves(takes[1][2])))
                  if not torch.equal(a, b)]
        log(f"{label} step 1's loss and gradient taken twice at the start "
            f"params: losses {losses[0]} / {losses[1]}, the "
            f"{len(T.leaves(takes[0][2]))} gradient leaves bitwise equal: "
            f"{'yes' if not differ else f'no, leaves {differ}'}")
        check(not differ and losses[0] == losses[1],
              f"{label}: a repeated gradient differs in leaves {differ}")
        del takes
    losses, walls, aux = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        if "aux" in metrics:
            aux.append(float(metrics["aux"]))
    peak = torch.cuda.max_memory_allocated()
    log(f"{label} losses {losses} (first beside ln {model_cfg.vocab_size} = "
        f"{np.log(model_cfg.vocab_size):.4f}); step wall {walls} s, "
        f"{tokens / walls[-1]:.1f} trained tokens/s in step {steps}; peak "
        f"memory {_peak_line(peak)} (bound {TRAIN_SSM_PEAK_GB} GB)")
    if aux:
        log(f"{label} the MoE's load-balance term (aux, the mean over the "
            f"layers) a step: {aux}")
    check(all(np.isfinite(losses)), f"{label}: losses {losses}")
    check(peak < TRAIN_SSM_PEAK_GB * 1e9, f"{label}: peak {peak} B")
    t0 = time.perf_counter()
    busy = device_busy(torch, lambda: step(state, batches[-1]))
    log_busy(f"{label} step ({time.perf_counter() - t0:.1f} s with the "
             f"profiler's processing)", *busy)
    del state, step, model, batches
    _release(torch)


def _grad_runs(torch, dev, model_cfg, remats, seq_len, batch):
    """{remat: (loss, grads, peak bytes, bytes held before)}: one
    loss-and-gradient of each remat on the same seeded params and tokens
    (and stub inputs), the earlier runs' gradients kept."""
    from repro_torch.config import SyncConfig
    from repro_torch.core import local_sgd
    from repro_torch.models.registry import build_model
    cfg = _train_cfg(model_cfg, SyncConfig(), seq_len, batch, 1)
    model = build_model(model_cfg, attn_impl="torch", ssd_impl="torch")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = local_sgd.init_state(model, cfg, gen)["params"]
    tokens = torch.randint(0, model_cfg.vocab_size, (batch, seq_len + 1),
                           generator=gen, device=dev)
    data = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    from repro_torch.data.pipeline import stub_inputs
    dtype = getattr(torch, model_cfg.dtype)
    data.update({k: torch.from_numpy(v).to(dev, dtype)
                 for k, v in stub_inputs(model_cfg, batch).items()})
    _seed_stubs(torch, [data], 1, dev)
    out = {}
    for remat in remats:
        m = build_model(model_cfg, attn_impl="torch", ssd_impl="torch",
                        remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        loss, _, grads = local_sgd.value_and_grad(m, params, data)
        torch.cuda.synchronize()
        out[remat] = (loss, grads, torch.cuda.max_memory_allocated(), held)
        del grads
    return out


def _hold_bitwise(torch, label, runs, tag="train_ssm (t3)"):
    """Every run's loss and gradient leaves against ``"none"``'s: bitwise,
    or within relative 1e-6 with the leaves that differ named; each run's
    peak memory above what was held before it (the earlier runs'
    gradients among that)."""
    from repro_torch import tree as T
    loss0, grads0 = runs["none"][:2]
    added = {r: run[2] - run[3] for r, run in runs.items()}
    names = [k for k, _ in _named_leaves(grads0)]
    for remat, (loss, grads, _, _) in runs.items():
        if remat == "none":
            continue
        differ = []
        for name, a, b in zip(names, T.leaves(grads), T.leaves(grads0)):
            if not torch.equal(a, b):
                rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
                differ.append((name, rel))
        loss_rel = abs(float(loss - loss0)) / abs(float(loss0))
        same = (f"bitwise, the loss and all {len(names)} gradient leaves"
                if torch.equal(loss, loss0) and not differ else
                f"differ: loss rel {loss_rel:.3e}, leaves {differ}")
        log(f"{tag} {label} remat={remat} vs none: loss "
            f"{float(loss):.6f} / {float(loss0):.6f}, {same}; peak memory "
            f"above what was held before the run {_peak_line(added[remat])} "
            f"against {_peak_line(added['none'])}")
        check(loss_rel <= 1e-6 and all(rel <= 1e-6 for _, rel in differ),
              f"{tag} {label} remat={remat}: {differ}")


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in _named_leaves(tree[key], f"{prefix}/{key}")]
    return [(prefix, tree)]


def _remat_on_the_card(torch, dev, depth, seq_len, batch):
    """(t3): remat none against full (and dots for the dense family) at
    full width and a cut depth, and the checkpointed SSD chunks against the
    unchecked loop at mamba2's width, one layer."""
    from repro_torch.config import get_arch
    from repro_torch.models import ssm
    # the products' deterministic algorithms (the embedding's backward
    # without atomics); warn only where cuBLAS asks for a workspace setting
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for arch, remats, layers in (
                ("mamba2-2.7b", ("none", "full"), depth),
                # the shared block follows every 6th layer: 6 is the
                # smallest depth that has it
                ("zamba2-1.2b", ("none", "full"), 6),
                ("smollm-360m", ("none", "full", "dots"), depth)):
            cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
            runs = _grad_runs(torch, dev, cfg, remats, seq_len, batch)
            _hold_bitwise(torch, f"{arch} (full width, depth cut to "
                          f"{layers})", runs)
            del runs
            torch.cuda.empty_cache()

        s = get_arch("mamba2-2.7b").ssm
        h = s.expand * get_arch("mamba2-2.7b").d_model // s.head_dim
        gen = torch.Generator(device=dev).manual_seed(1)

        def draw(*shape, scale=1.0, shift=0.0):
            return (torch.randn(shape, generator=gen, device=dev) * scale
                    + shift)
        inputs = [draw(batch, seq_len, h, s.head_dim),
                  torch.nn.functional.softplus(draw(batch, seq_len, h)),
                  -torch.exp(draw(h, scale=0.5)),
                  draw(batch, seq_len, s.state_dim),
                  draw(batch, seq_len, s.state_dim)]
        gy = draw(batch, seq_len, h, s.head_dim)
        gs = draw(batch, h, s.state_dim, s.head_dim)
        got = {}
        real = ssm.checkpoint
        for label, ckpt in (("checkpointed", real),
                            ("unchecked", lambda fn, *a, **kw: fn(*a))):
            ssm.checkpoint = ckpt
            try:
                leaves = [t.detach().requires_grad_() for t in inputs]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                y, state = ssm.ssd_chunked(*leaves, s.chunk_size)
                grads = torch.autograd.grad(
                    (y * gy).sum() + (state * gs).sum(), leaves)
                torch.cuda.synchronize()
                got[label] = ([y.detach(), state.detach(), *grads],
                              torch.cuda.max_memory_allocated())
            finally:
                ssm.checkpoint = real
            del y, state, grads, leaves
        a, b = got["checkpointed"][0], got["unchecked"][0]
        names = ["y", "state", "dx", "ddt", "da", "dB", "dC"]
        differ = [n for n, u, v in zip(names, a, b) if not torch.equal(u, v)]
        finite = all(bool(torch.isfinite(t).all()) for t in a)
        log(f"train_ssm (t3) ssd_chunked at mamba2's width ({batch} x "
            f"{seq_len}, {h} heads of {s.head_dim}, state {s.state_dim}, "
            f"chunk {s.chunk_size}), checkpointed chunks vs the unchecked "
            f"loop: " + ("bitwise, y, state and the 5 gradients" if not
                         differ else f"differ in {differ}")
            + f"; finite {finite}; peak memory "
            f"{_peak_line(got['checkpointed'][1])} against "
            f"{_peak_line(got['unchecked'][1])}")
        check(not differ and finite, f"train_ssm (t3) ssd_chunked: {differ}")
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()


def phase_train_ssm(torch, dev):
    """Training the SSM and hybrid families through ``build_trainer``:
    (t1) the hybrid's local SGD with the int8 sync, (t2) the SSM every
    step, (t3) remat on the card. Returns (t1)'s quant launches."""
    from repro_torch.config import get_arch
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch("zamba2-1.2b"),
                              n_layers=TRAIN_SSM_T1_DEPTH)
    launches = _train_local(
        torch, dev, "train_ssm (t1)", cfg,
        f"{cfg.n_layers} of {get_arch('zamba2-1.2b').n_layers} Mamba2 "
        f"layers (depth cut for the time limit), d_model {cfg.d_model}, "
        f"{_ssd_heads(cfg)} SSD heads, the shared attention block after "
        f"every {cfg.shared_block_every}", TRAIN_SSM_K, TRAIN_SSM_H,
        TRAIN_SEQ, TRAIN_SSM_BATCH, 2,
        TRAIN_SSM_H * TRAIN_SSM_BATCH * TRAIN_SEQ)
    log(f"train_ssm (t1): {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    from repro_torch.models.registry import analytic_param_count
    cfg = get_arch("mamba2-2.7b")
    copy_gb = 4 * analytic_param_count(cfg) / 1e9
    _train_every_step(
        torch, dev, "train_ssm (t2)", cfg,
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {_ssd_heads(cfg)} "
        f"SSD heads, state {cfg.ssm.state_dim}. One replica: local SGD "
        f"keeps about five f32 copies of the params a replica (params, the "
        f"block's start copy, two moments, the error-feedback residual) at "
        f"{copy_gb:.2f} GB a copy, so K = 2 ({10 * copy_gb:.1f} GB) does "
        f"not fit on one card", TRAIN_SEQ, 2, 2, 2 * TRAIN_SEQ)
    log(f"train_ssm (t2): {time.perf_counter() - t1:.1f} s")
    t2 = time.perf_counter()
    _remat_on_the_card(torch, dev, REMAT_DEPTH, TRAIN_SEQ, 2)
    log(f"train_ssm (t3): {time.perf_counter() - t2:.1f} s; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase train_families: training the MoE, VLM and audio families
# ---------------------------------------------------------------------------

def _expert_wire(torch, dev, model_cfg, k, seed=3):
    """The int8 sync's wire on a full-size stacked MoE expert leaf of one
    layer, (K, 1, E, D, F): ``compress_tree`` and the replica mean of the
    dequantized payloads on the quant kernel against the plain version,
    bitwise. Returns the kernel's launches (outside the main path's
    count)."""
    from repro_torch.core import compression
    from repro_torch.kernels.quant import ops
    e, d, f = model_cfg.moe.num_experts, model_cfg.d_model, model_cfg.d_ff
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (k, 1, e, d, f)
    delta = {"w_up": torch.randn(shape, generator=gen, device=dev) * 1e-3}
    ef = {"w_up": torch.randn(shape, generator=gen, device=dev) * 1e-5}
    before = ops.LAUNCHES
    got = compression.compress_tree(delta, ef, rows=True, impl="kernel")
    mean = compression.allgather_mean_dequant(got[0], got[1], impl="kernel")
    torch.cuda.synchronize()
    launches = ops.LAUNCHES - before
    ops.LAUNCHES = before
    want = compression.compress_tree(delta, ef, rows=True, impl="torch")
    same = [(part, torch.equal(g["w_up"], w["w_up"])) for part, g, w in
            zip(("q", "scale", "residual"), got, want)]
    plain = compression.allgather_mean_dequant(want[0], want[1],
                                               impl="torch")
    same.append(("mean", torch.equal(mean["w_up"], plain["w_up"])))
    log(f"train_families (f2) the int8 wire on {model_cfg.name}'s expert "
        f"leaf w_up {shape} ({k * e * d * f / 1e6:.1f} M values, "
        f"{e * d * f / 1e6:.1f} M a replica), quant kernel vs plain: "
        + ", ".join(f"{p} {'bitwise' if ok else 'DIFFER'}" for p, ok in same)
        + f"; {launches} kernel launches (a check, not counted on the main "
        f"path)")
    check(all(ok for _, ok in same), f"train_families (f2) expert wire: "
          f"{same}")
    del delta, ef, got, mean, want, plain
    _release(torch)
    return launches


def phase_train_families(torch, dev):
    """Training the MoE, VLM and audio families through ``build_trainer``:
    (f1) whisper-base's local SGD with the int8 sync on the quant kernel,
    (f2) phi3.5-moe at a cut depth and the int8 wire on its expert leaf,
    (f3) paligemma-3b every step, (f4) remat at full width. Returns (f1)'s
    quant launches."""
    from repro_torch import tree as T
    from repro_torch.config import get_arch
    from repro_torch.models.registry import analytic_param_count
    t0 = time.perf_counter()
    cfg = get_arch("whisper-base")
    k, h, rows = FAM_AUDIO_K, FAM_AUDIO_H, FAM_AUDIO_BATCH
    seq = FAM_AUDIO_SEQ
    launches = _train_local(
        torch, dev, "train_families (f1)", cfg,
        f"{cfg.n_encoder_layers} encoder and {cfg.n_layers} decoder layers, "
        f"d_model {cfg.d_model}, {cfg.n_audio_frames} seeded frames a "
        f"sequence, its {seq}-token context, "
        f"{analytic_param_count(cfg) / 1e6:.1f} M params", k, h, seq,
        rows * k, 2, h * rows * k * seq, stub_seed=11)
    log(f"train_families (f1): {time.perf_counter() - t0:.1f} s")

    t1 = time.perf_counter()
    cfg = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b"),
                              n_layers=FAM_MOE_LAYERS)
    full = get_arch("phi3.5-moe-42b-a6.6b")
    _train_every_step(
        torch, dev, "train_families (f2)", cfg,
        f"depth cut to {FAM_MOE_LAYERS} of {full.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.moe.num_experts} experts of d_ff "
        f"{cfg.d_ff}, top-{cfg.moe.top_k}, "
        f"{analytic_param_count(cfg) / 1e9:.3f} B params "
        f"({4 * analytic_param_count(cfg) / 1e9:.2f} GB a f32 copy). One "
        f"replica: local SGD at K = 2 runs out of the card's memory at one "
        f"layer (five f32 copies a replica, 62.5 GB, and a step's "
        f"gradients and the optimizer's temporaries beside them)",
        TRAIN_SEQ, FAM_MOE_BATCH, 2, FAM_MOE_BATCH * TRAIN_SEQ, repeat=True)
    _expert_wire(torch, dev, full, 2)
    log(f"train_families (f2): {time.perf_counter() - t1:.1f} s")

    t2 = time.perf_counter()
    cfg = get_arch("paligemma-3b")
    _train_every_step(
        torch, dev, "train_families (f3)", cfg,
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_image_tokens} seeded patches before {FAM_VLM_TEXT} text "
        f"tokens, vocab {cfg.vocab_size}, "
        f"{analytic_param_count(cfg) / 1e9:.3f} B params. One replica: at "
        f"about five f32 copies a replica K = 2 does not fit on one card",
        FAM_VLM_TEXT, 2, 2, 2 * FAM_VLM_TEXT, stub_seed=12)
    log(f"train_families (f3): {time.perf_counter() - t2:.1f} s")

    t3 = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for arch, layers, seq in (("whisper-base", 2, FAM_AUDIO_SEQ),
                                  ("phi3.5-moe-42b-a6.6b", 1, TRAIN_SEQ),
                                  ("paligemma-3b", 2, FAM_VLM_TEXT)):
            cfg = get_arch(arch)
            cuts = {"n_layers": layers}
            if cfg.family == "audio":
                cuts["n_encoder_layers"] = layers
            cfg = dataclasses.replace(cfg, **cuts)
            runs = _grad_runs(torch, dev, cfg, ("none", "full", "dots"), seq,
                              2)
            _hold_bitwise(torch, f"{arch} (full width, depth cut to "
                          f"{layers})", runs, tag="train_families (f4)")
            if cfg.family == "audio":
                # the enc-dec checkpoints each layer whole for any remat
                # but none: dots is full's run, value for value
                same = torch.equal(runs["dots"][0], runs["full"][0]) and all(
                    torch.equal(a, b) for a, b in zip(
                        T.leaves(runs["dots"][1]), T.leaves(runs["full"][1])))
                log(f"train_families (f4) {arch}: dots against full, the "
                    f"whole-layer checkpoint of both stacks, as the "
                    f"reference's: the loss and every gradient bitwise "
                    f"{'yes' if same else 'no'}")
                check(same, f"train_families (f4) {arch}: dots differs from "
                      f"full")
            del runs
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"train_families (f4): {time.perf_counter() - t3:.1f} s; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase dist: model synchronization across processes
# ---------------------------------------------------------------------------

def _wait(torch, dev):
    torch.cuda.synchronize(dev)


def _peak(torch, dev) -> int:
    return torch.cuda.max_memory_allocated(dev)


def _rank_setup(torch):
    """A rank's products as the parent's: full float32, never TF32; and one
    host thread for its operators (the K ranks share the host's cores)."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rank_report(torch, mesh, what):
    """This rank's device, backend, host-staged ops and peak memory."""
    from repro_torch.core import collectives as CL
    return {"what": what, "rank": mesh.rank(), "device": str(mesh.device),
            "backend": mesh.backend, "staged": dict(CL.STAGED),
            "peak": _peak(torch, mesh.device)}


def _log_ranks(reports):
    for r in reports:
        log(f"dist {r['what']} rank {r['rank']}: device {r['device']}, "
            f"backend {r['backend']}, host-staged ops {r['staged'] or 'none'}, "
            f"peak memory {r['peak'] / 2**30:.2f} GiB")


def _dist_svm_rank(paths, timed_bs, timed_blocks):
    """(d1)–(d3) and (d9) on one of the K ranks: epsilon dms, the timed pair
    at each block size (at block DIST_BS feeding the SVM ladder's
    controller), the SVM block ladder, and the webspam modes."""
    import torch
    import torch.distributed as dist
    from repro_torch.config import SyncConfig
    from repro_torch.core import autotune, svm
    from repro_torch.core import collectives as CL
    from repro_torch.core.telemetry import BlockTelemetry
    from repro_torch.kernels.hinge import ops
    from repro_torch.launch import mesh as M
    _rank_setup(torch)
    mesh = M.make_mesh((DIST_K,), ("data",))
    dev, r = mesh.device, mesh.rank("data")
    out = {}
    x = np.load(paths["eps_x"], mmap_mode="c")
    y = np.load(paths["eps_y"], mmap_mode="c")
    w0 = torch.zeros(x.shape[1])
    xs, ys = svm._shard_data(x, y, DIST_K)
    _wait(torch, dev)
    t0 = time.perf_counter()
    shard = (torch.as_tensor(xs[r:r + 1], device=dev),
             torch.as_tensor(ys[r:r + 1], device=dev))
    _wait(torch, dev)
    copy_s = time.perf_counter() - t0

    # (d1): the counts set to 0 just before, read just after
    dist.barrier()
    _wait(torch, dev)
    ops.LAUNCHES = ops.CLUSTER_LAUNCHES = 0
    t0 = time.perf_counter()
    w = svm.dms(w0, x, y, workers=DIST_K, epochs=DIST_EPOCHS,
                block_size=DIST_BS, backend="dist", mesh=mesh)
    _wait(torch, dev)
    out["d1"] = dict(w=w.cpu().numpy(), wall=time.perf_counter() - t0,
                     copy_s=copy_s, launches=ops.LAUNCHES,
                     cluster=ops.CLUSTER_LAUNCHES)

    # (d3): compute and sync timed apart on this rank's epsilon rows
    d = x.shape[1]
    alpha = svm._alpha(0, torch.float32)
    out["d3"] = {}
    for bs in timed_bs:
        tel = BlockTelemetry()
        compute, sync = svm.dms_timed_steps(mesh, "data", block_size=bs,
                                            telemetry=tel)
        wt = torch.zeros(d, device=dev)
        for i in range(timed_blocks):
            wt = sync(compute(wt, shard[0][:, i * bs:(i + 1) * bs],
                              shard[1][:, i * bs:(i + 1) * bs], alpha))
        sync.flush()
        out["d3"][bs] = tel.estimates()
        if bs == DIST_BS:
            # (d9): this run's times, the max over the ranks, feed a
            # controller over the SVM rungs on every rank; its pick agreed
            ctrl = autotune.AdaptiveController(
                SyncConfig(strategy="periodic", period=bs),
                param_bytes_per_chip=4 * d, replicas=DIST_K, telemetry=tel,
                ladder=SVM_RUNGS, h0=bs)
            for _ in range(timed_blocks):
                ctrl.observe_block()
            CL.agree({"block size": ctrl.h})
            out["d9_pick"] = dict(h=ctrl.h, history=ctrl.history,
                                  est=tel.estimates())

    # (d9): the block ladder, an epoch at each of D9_SIZES, the switch
    # between them; the counts set to 0 just before, read just after
    ladder = svm.dms_block_ladder(d=d, workers=DIST_K, block_sizes=SVM_RUNGS,
                                  mesh=mesh)
    carry = svm.dms_stepper_init(torch.zeros(d, device=dev), 1)
    n_local = shard[0].shape[1]
    dist.barrier()
    _wait(torch, dev)
    ops.LAUNCHES = ops.CLUSTER_LAUNCHES = 0
    t0 = time.perf_counter()
    for t, bs in enumerate(D9_SIZES):
        if t:
            carry = svm.dms_ladder_switch(carry, d=d, mesh=mesh)
        nb = n_local // bs
        xb = shard[0][:, :nb * bs].reshape(1, nb, bs, d)
        yb = shard[1][:, :nb * bs].reshape(1, nb, bs)
        alpha = svm._alpha(t, torch.float32)
        for i in range(nb):
            carry = ladder[bs](carry, xb[:, i], yb[:, i], alpha)
    _wait(torch, dev)
    out["d9"] = dict(w=carry["w"][0].cpu().numpy(),
                     wall=time.perf_counter() - t0, launches=ops.LAUNCHES,
                     cluster=ops.CLUSTER_LAUNCHES)
    del shard, carry
    # the port's pmean (all-gather, stacked mean) beside the reference's
    # (psum / K: an all-reduce) on the same w, in turns, each call waited
    # for on the host and the card
    rep = CL.replicas(mesh, "data")
    colls = {"all-gather mean": rep.mean,
             "all-reduce mean": lambda v: CL._div_exact(rep.sum(v), DIST_K)}
    wt = torch.full((1, d), 0.5, device=dev)
    spent = dict.fromkeys(colls, 0.0)
    for i in range(DIST_COLL_CALLS + 1):
        for name, fn in colls.items():
            dist.barrier()
            _wait(torch, dev)
            t0 = time.perf_counter()
            fn(wt)
            _wait(torch, dev)
            spent[name] += (time.perf_counter() - t0) if i else 0.0
    out["coll"] = dict(zip(colls, CL.max_over(
        [spent[name] / DIST_COLL_CALLS for name in colls])))

    # (d2): every webspam mode, one epoch
    xw = np.load(paths["web_x"], mmap_mode="c")
    yw = np.load(paths["web_y"], mmap_mode="c")
    out["d2"] = []
    for overlap, topology, gossip_async in DIST_MODES:
        dist.barrier()
        _wait(torch, dev)
        ops.LAUNCHES = ops.CLUSTER_LAUNCHES = 0
        t0 = time.perf_counter()
        w = svm.dms(torch.zeros(xw.shape[1]), xw, yw, workers=DIST_K,
                    epochs=1, block_size=DIST_BS, backend="dist", mesh=mesh,
                    overlap=overlap, topology=topology,
                    gossip_async=gossip_async)
        _wait(torch, dev)
        out["d2"].append(dict(w=w.cpu().numpy(),
                              wall=time.perf_counter() - t0,
                              launches=ops.LAUNCHES,
                              cluster=ops.CLUSTER_LAUNCHES))
    out["report"] = _rank_report(torch, mesh, "svm")
    return out


def _digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.contiguous().view(-1).cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def _dist_train_rank(paths, h, blocks):
    """(d4) on one of two ranks: the local-SGD trainer at smollm's widths
    (D4_DEPTH layers), one replica a rank, its first sync's int8 payloads
    kept."""
    import torch
    from repro_torch import tree as T
    from repro_torch.config import SyncConfig
    from repro_torch.core import collectives as CL
    from repro_torch.core import compression
    from repro_torch.kernels.quant import ops, ref
    from repro_torch.launch import mesh as M
    _rank_setup(torch)
    mesh = M.make_mesh((DIST_TRAIN_K,), ("pod",))
    dev, r = mesh.device, mesh.rank("pod")
    sync_cfg = SyncConfig(strategy="periodic", period=h, compression="int8")
    cfg = _train_cfg(_d4_model(), sync_cfg, TRAIN_SEQ, DIST_TRAIN_K,
                     DIST_TRAIN_K)
    captured = []
    inner = compression.compress_tree

    def capture(delta, ef, **kw):
        q, scale, new_ef = inner(delta, ef, **kw)
        if not captured:
            captured.append([d.float() + e for d, e in
                             zip(T.leaves(delta), T.leaves(ef))])
            captured.append((T.leaves(q), T.leaves(scale)))
        return q, scale, new_ef

    torch.cuda.reset_peak_memory_stats(dev)
    compression.compress_tree = capture
    try:
        state, _, _, losses, walls, sync_ms, launches = _run_blocks(
            torch, cfg, dev, "kernel", blocks, mesh=mesh)
    finally:
        compression.compress_tree = inner
    peak = _peak(torch, dev)
    values, (qs, scales) = captured
    # the kernel's payload bitwise the plain version's on the same values
    before = ops.LAUNCHES
    plain_same = all(
        torch.equal(q, qp) and torch.equal(s_, sp)
        for v, q, s_ in zip(values, qs, scales)
        for qp, sp in [ref.quantize(v, rows=True)])
    ops.LAUNCHES = before
    # the wire: every rank's payload as the others gathered it
    rep = CL.replicas(mesh, "pod")
    gathered = [[_digest(row) for row in rep.gather(q)] for q in qs]
    own = [_digest(q) for q in qs]
    # against the one-process run at K = 2: its replica r's first payloads
    # and its final params
    with np.load(paths["train_ref"]) as want:
        diff_q, max_dq, scale_rel = 0, 0, 0.0
        for i, (q, s_) in enumerate(zip(qs, scales)):
            wq = torch.from_numpy(want[f"q{i}"][r:r + 1]).to(dev)
            ws = torch.from_numpy(want[f"s{i}"][r:r + 1]).to(dev)
            dq = (q.int() - wq.int()).abs()
            diff_q += int((dq > 0).sum())
            max_dq = max(max_dq, int(dq.max()))
            scale_rel = max(scale_rel, float(((s_ - ws).abs() / ws.abs())
                                             .max()))
        num = den = 0.0
        for i, p in enumerate(T.leaves(state["params"])):
            wp = torch.from_numpy(want[f"p{i}"]).to(dev)
            num += float((p[0].float() - wp.float()).square().sum())
            den += float(wp.float().square().sum())
    n_q = sum(q.numel() for q in qs)
    params_digest = _digest(torch.cat([p.reshape(-1).float() for p in
                                       T.leaves(state["params"])]))
    del state, values, qs, scales, captured
    report = _rank_report(torch, mesh, "train")
    report["peak"] = peak
    return dict(losses=losses, walls=walls, sync_ms=sync_ms,
                launches=launches, plain_same=plain_same, gathered=gathered,
                own=own, diff_q=diff_q, n_q=n_q, max_dq=max_dq,
                scale_rel=scale_rel, params_rel=(num / den) ** 0.5,
                params_digest=params_digest, report=report)


def _dist_hier_rank(blocks):
    """(d5) on one of four ranks, a (pod 2, data 2) mesh: hierarchical
    local SGD at smoke width; returns the replicas' gathered params."""
    import torch
    from repro_torch import tree as T
    from repro_torch.config import SyncConfig, get_smoke
    from repro_torch.core import local_sgd
    from repro_torch.launch import mesh as M
    _rank_setup(torch)
    mesh = M.make_mesh((2, 2), ("pod", "data"))
    cfg = _train_cfg(get_smoke("smollm-360m"),
                     SyncConfig(strategy="hierarchical", period=2,
                                compression="int8"), 64, 8, 2)
    state, _, _, losses, walls, _, launches = _run_blocks(
        torch, cfg, mesh.device, "kernel", blocks, mesh=mesh)
    params = local_sgd.gather_replicas(state, mesh)["params"]
    return dict(losses=losses, walls=walls, launches=launches,
                params=T.map(lambda p: p.cpu(), params),
                report=_rank_report(torch, mesh, "hierarchical"))


def _digests(torch, tree):
    """The sha256 of each tensor leaf's bytes, in leaf order, each leaf
    copied to the host through one page-locked buffer."""
    import hashlib
    from repro_torch import tree as T
    leaves = [x for x in T.leaves(tree) if isinstance(x, torch.Tensor)]
    most = max(x.numel() * x.element_size() for x in leaves)
    buf = torch.empty(most, dtype=torch.uint8,
                      pin_memory=leaves[0].is_cuda)
    out = []
    for x in leaves:
        n = x.numel() * x.element_size()
        buf[:n].copy_(x.detach().contiguous().view(-1).view(torch.uint8))
        out.append(hashlib.sha256(buf[:n].numpy()).hexdigest()[:16])
    return out


def _d4_model():
    """(d4)'s and (d7)'s smollm-360m: its widths, the depth cut to
    D4_DEPTH layers for the script's time limit."""
    from repro_torch.config import get_arch
    return dataclasses.replace(get_arch("smollm-360m"), n_layers=D4_DEPTH)


def _d7_cfg():
    from repro_torch.config import SyncConfig
    return _train_cfg(_d4_model(), SyncConfig(
        strategy="periodic", period=4, compression="int8", adaptive=True,
        adapt_ladder=(1, 2, 4), adapt_every=2), TRAIN_SEQ, DIST_TRAIN_K,
        DIST_TRAIN_K)


def _scripted_adaptive(torch, dev, cfg, mesh=None):
    """(d7)'s scripted run: the adaptive trainer's ladder with its move
    4 -> 2 after block 2 scripted, D7_SCRIPTED_BLOCKS blocks through
    ``StepRunner`` (checkpoints off); with a ``mesh`` this rank's replica.
    Returns each replica's sha256 digests of its state leaves (params, opt,
    sync) and of its first sync's int8 payloads and scales, with the
    losses, the trajectory, the quant launches and the compiles after the
    warmup."""
    from repro_torch import tree as T
    from repro_torch.config import FaultToleranceConfig
    from repro_torch.core import compression
    from repro_torch.kernels.quant import ops
    from repro_torch.launch.train import build_trainer
    from repro_torch.runtime import LadderRuntime, StepRunner
    step, state, _, _, tel, live = build_trainer(cfg, dev, mesh)
    ladder = LadderRuntime(live.rungs, live.switch_fn,
                           ScriptedController(4, D7_SCRIPT), telemetry=tel,
                           device=dev, compile_counter=live.compile_counter,
                           mesh=mesh)
    runner = StepRunner(step, None, FaultToleranceConfig(max_restarts=0), 1,
                        lambda start: ttrain_blocked(cfg, ladder.h, start,
                                                     dev, mesh),
                        ladder=ladder, mesh=mesh)
    first, inner = [], compression.compress_tree

    def capture(delta, ef, **kw):
        q, scale, new_ef = inner(delta, ef, **kw)
        if not first:
            first.append(T.leaves(q) + T.leaves(scale))
        return q, scale, new_ef

    compression.compress_tree = capture
    ops.LAUNCHES = 0
    try:
        state, end = runner.run(state, 0, D7_SCRIPTED_BLOCKS)
    finally:
        compression.compress_tree = inner
    torch.cuda.synchronize()
    parts = {key: state[key] for key in ("params", "opt", "sync")}
    k = T.leaves(parts["params"])[0].shape[0]
    digests = [_digests(torch, T.map(lambda x: x[r:r + 1], parts))
               + _digests(torch, [x[r:r + 1] for x in first[0]])
               for r in range(k)]
    return dict(digests=digests, step=state["step"], end=end,
                losses=[m["loss"] for m in runner.metrics_log],
                trajectory=ladder.trajectory, launches=ops.LAUNCHES,
                compiles=ladder.compile_counter.since_mark,
                n_leaves=len(T.leaves(parts["params"])))


def _dist_adaptive_rank():
    """(d7) on one of the two ranks: the scripted run (its digests), then
    D7_LIVE_BLOCKS blocks under the live controller, every small
    all-reduce of the run (times and agreements) timed."""
    import torch
    from repro_torch.config import FaultToleranceConfig
    from repro_torch.core import collectives as CL
    from repro_torch.kernels.quant import ops
    from repro_torch.launch import mesh as M
    from repro_torch.launch.train import build_trainer
    from repro_torch.runtime import StepRunner
    _rank_setup(torch)
    mesh = M.make_mesh((DIST_TRAIN_K,), ("pod",))
    dev = mesh.device
    cfg = _d7_cfg()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"scripted": _scripted_adaptive(torch, dev, cfg, mesh)}
    out["scripted"]["wall"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # the live run; the quant library dropped first, as in a fresh process,
    # so that the ladder's warmup must load it
    torch.cuda.reset_peak_memory_stats(dev)
    ops._LIB = None
    step, state, make_pipeline, _, tel, ladder = build_trainer(cfg, dev, mesh)
    runner = StepRunner(step, None, FaultToleranceConfig(max_restarts=0), 1,
                        make_pipeline, ladder=ladder, mesh=mesh)
    calls, inner = [], CL.max_over

    def timed(values, group=None):
        t1 = time.perf_counter()
        got = inner(values, group)
        calls.append(time.perf_counter() - t1)
        return got

    CL.max_over = timed
    ops.LAUNCHES = 0
    try:
        t0 = time.perf_counter()
        state, end = runner.run(state, 0, D7_LIVE_BLOCKS)
        _wait(torch, dev)
        wall = time.perf_counter() - t0
    finally:
        CL.max_over = inner
    launches = ops.LAUNCHES
    peak = _peak(torch, dev)
    own = ladder.compile_counter.since_mark
    ad = ladder.to_dict()
    out["live"] = dict(
        end=end, wall=wall, trajectory=ad["h_trajectory"],
        history=ladder.controller.history, est=tel.estimates(),
        compiles_total=ad["compiles_total"],
        compiles_after_warmup=ad["compiles_after_warmup"], own=own,
        ranks=ad["ranks"], launches=launches, peak=peak,
        walls=[m["elapsed"] for m in runner.metrics_log],
        losses=[m["loss"] for m in runner.metrics_log],
        small_calls=len(calls), small_s=sum(calls))
    del state, step, ladder, runner
    torch.cuda.empty_cache()
    out["report"] = _rank_report(torch, mesh, "adaptive train")
    out["report"]["peak"] = peak
    return out


def _dist_trainers_rank(paths, h, blocks):
    """(d4), then (d7), on the same two ranks."""
    return {"d4": _dist_train_rank(paths, h, blocks),
            "d7": _dist_adaptive_rank()}


def _dist_fault_rank(tmp, straggle_s):
    """(d8) on one of D8_K ranks: phase (c)'s runs across the ranks, the
    fault (or the straggle) on rank 1 only; returns each run's gathered
    final state (on the host), restarts, watchdog events, the steps this
    rank wrote a checkpoint at, trajectory and quant launches."""
    import torch
    from repro_torch import tree as T
    from repro_torch.config import FaultToleranceConfig, get_smoke
    from repro_torch.core import local_sgd
    from repro_torch.launch import mesh as M
    _rank_setup(torch)
    mesh = M.make_mesh((D8_K,), ("pod",))
    r = mesh.rank()
    cfg = _fault_cfg(get_smoke("smollm-360m"), D8_K)
    runs = {
        "none": FaultToleranceConfig(),
        "fault@4": FaultToleranceConfig(inject_failure_at=4 if r == 1
                                        else -1),
        "fault@2": FaultToleranceConfig(inject_failure_at=2 if r == 1
                                        else -1),
        "straggle": FaultToleranceConfig(
            step_deadline_sec=straggle_s / 2,
            inject_straggle_sec=straggle_s if r == 1 else 0.0,
            inject_failure_at=FAULT_STEPS if r == 1 else -1)}
    out = {}
    for name, fault in runs.items():
        state, end, runner, ladder, launches, writes = _fault_run(
            torch, mesh.device, cfg, fault, os.path.join(tmp, f"d8_{name}"),
            mesh)
        whole = local_sgd.gather_replicas(state, mesh)
        out[name] = dict(
            end=end, restarts=runner.restarts, events=runner.watchdog.events,
            writes=writes, trajectory=ladder.trajectory, launches=launches,
            compiles=ladder.compile_counter.since_mark,
            final=T.map(lambda x: x.cpu() if isinstance(x, torch.Tensor)
                        else x, {k: whole[k] for k in ("params", "opt",
                                                       "sync", "step")}))
        del state, whole, runner, ladder
    out["report"] = _rank_report(torch, mesh, "fault")
    return out


def _dist_four_rank(blocks, tmp, straggle_s):
    """(d5), then (d8), on the same four ranks (the (d8) mesh is the world
    on one ``pod`` axis)."""
    return {"d5": _dist_hier_rank(blocks),
            "d8": _dist_fault_rank(tmp, straggle_s)}


def _dist_nccl_rank(paths):
    """(d6) the one rank of an NCCL world: dms(backend="dist") at K = 1."""
    import torch
    from repro_torch.core import svm
    from repro_torch.kernels.hinge import ops
    from repro_torch.launch import mesh as M
    _rank_setup(torch)
    mesh = M.make_mesh((1,), ("data",))
    x = np.load(paths["web_x"], mmap_mode="c")
    y = np.load(paths["web_y"], mmap_mode="c")
    ops.LAUNCHES = ops.CLUSTER_LAUNCHES = 0
    w = svm.dms(torch.zeros(x.shape[1]), x, y, workers=1, epochs=1,
                block_size=DIST_BS, backend="dist", mesh=mesh)
    return dict(w=w.cpu().numpy(), launches=ops.LAUNCHES,
                cluster=ops.CLUSTER_LAUNCHES,
                report=_rank_report(torch, mesh, "nccl"))


def _stepper_dms(torch, svm, x, y, topology):
    """Async gossip over K workers on one card through
    ``dms_block_stepper``, the arithmetic the ranks run (neighbour sums,
    the bank as ``mixbuf + (M_ii − 1)·sent``). ``dms(backend="vmap")`` runs
    async gossip as the reference's ``_dms_vmap`` does, by the mixing
    matrix's product, which rounds differently; at α = 1 every block
    rebuilds w from its gradient alone, entries that cancel to zero in one
    rounding are ±1e-9 in the other, and on webspam's one-feature rows the
    sign of such an entry decides a row's prediction."""
    d = x.shape[1]
    xs, ys = svm._shard_data(x, y, DIST_K)
    nb = xs.shape[1] // DIST_BS
    step = svm.dms_block_stepper(d=d, topology=topology, gossip_async=True)
    carry = svm.dms_stepper_init(torch.zeros(d, device=x.device), DIST_K,
                                 topology=topology, gossip_async=True)
    alpha = svm._alpha(0, x.dtype)
    for i in range(nb):
        sl = slice(i * DIST_BS, (i + 1) * DIST_BS)
        carry = step(carry, xs[:, sl], ys[:, sl], alpha)
    return carry["w"].mean(dim=0)


def phase_dist(torch, dev, tmp):
    """Phase dist: ``dms(backend="dist")``, the timed pair and the trainer
    across processes that share the one card (gloo), each held to its
    one-process twin; then one NCCL world of one rank. The kernels are
    built and loaded here first, so no rank compiles them."""
    from repro_torch.config import SyncConfig, get_smoke
    from repro_torch.core import autotune, costmodel, svm
    from repro_torch.kernels.hinge import ops as hinge_ops
    from repro_torch.kernels.quant import ops as quant_ops
    from repro_torch.launch import mesh as M
    from repro_torch import tree as T
    t_phase = time.perf_counter()
    hinge_ops.load_library()
    hinge_ops.load_cluster_library()
    quant_ops.load_library()
    from repro_torch.data import make_svm_dataset
    eps, web = (_HOST.get(name) or make_svm_dataset(name, seed=0)
                for name in ("epsilon", "webspam"))
    paths = {}
    t0 = time.perf_counter()
    for tag, ds in (("eps", eps), ("web", web)):
        for part, arr in (("x", ds.x_train), ("y", ds.y_train)):
            paths[f"{tag}_{part}"] = os.path.join(tmp, f"{tag}_{part}.npy")
            np.save(paths[f"{tag}_{part}"], arr)
    log(f"dist: data written for the ranks in {time.perf_counter() - t0:.1f} "
        f"s (each rank maps it and copies its own row block to the card)")

    # the one-process twins, on the card, before any rank starts
    def on_card(ds):
        return tuple(torch.from_numpy(a).to(dev) for a in
                     (ds.x_train, ds.y_train, ds.x_test, ds.y_test))
    x, y, xt, yt = on_card(eps)
    d = x.shape[1]
    n_local = x.shape[0] // DIST_K
    blocks = n_local // DIST_BS
    w_one = svm.dms(torch.zeros(d, device=dev), x, y, workers=DIST_K,
                    epochs=DIST_EPOCHS, block_size=DIST_BS, device=dev)
    acc_one = float(svm.accuracy(w_one, xt, yt))
    eps_test = (xt, yt)
    # (d9)'s twin: the block ladder on one process at K = DIST_K
    w_lad, wall_lad, n_lad, _, _ = _svm_chain(torch, dev, (x, y, xt, yt),
                                              D9_SIZES, "kernel", DIST_K)
    del x, y
    xw, yw, xwt, ywt = on_card(web)
    web_one = [svm.dms(torch.zeros(xw.shape[1], device=dev), xw, yw,
                       workers=DIST_K, epochs=1, block_size=DIST_BS,
                       overlap=ov, topology=topo, gossip_async=ga, device=dev)
               if not ga else _stepper_dms(torch, svm, xw, yw, topo)
               for ov, topo, ga in DIST_MODES]
    w_srdms = svm.srdms(torch.zeros(xw.shape[1], device=dev), xw, yw,
                        epochs=1, block_size=DIST_BS, device=dev)
    del xw, yw

    # (d4)'s twin: the one-process trainer at K = 2 on the same rows
    model_cfg = _d4_model()
    sync_cfg = SyncConfig(strategy="periodic", period=DIST_TRAIN_H,
                          compression="int8")
    cfg = _train_cfg(model_cfg, sync_cfg, TRAIN_SEQ, DIST_TRAIN_K,
                     DIST_TRAIN_K)
    from repro_torch.core import compression
    first = []
    inner = compression.compress_tree

    def capture(delta, ef, **kw):
        q, scale, new_ef = inner(delta, ef, **kw)
        if not first:
            first.append((T.leaves(q), T.leaves(scale)))
        return q, scale, new_ef

    compression.compress_tree = capture
    try:
        state, _, _, losses_one, walls_one, _, _ = _run_blocks(
            torch, cfg, dev, "kernel", DIST_TRAIN_BLOCKS)
    finally:
        compression.compress_tree = inner
    arrays = {}
    for i, (q, s_) in enumerate(zip(*first[0])):
        arrays[f"q{i}"], arrays[f"s{i}"] = q.cpu().numpy(), s_.cpu().numpy()
    for i, p in enumerate(T.leaves(state["params"])):
        arrays[f"p{i}"] = p[0].cpu().numpy()
    paths["train_ref"] = os.path.join(tmp, "train_ref.npz")
    np.savez(paths["train_ref"], **arrays)
    del state, first, arrays
    # (d5)'s twin: periodic at K = 2, each replica both data ranks' rows
    hier_cfg = _train_cfg(get_smoke("smollm-360m"), SyncConfig(
        strategy="periodic", period=2, compression="int8"), 64, 8, 2)
    hier_one, _, _, hier_losses_one, _, _, _ = _run_blocks(
        torch, hier_cfg, dev, "kernel", 3)
    hier_one = T.map(lambda p: p.cpu(), hier_one["params"])
    # (d7)'s twin: the scripted adaptive run at K = 2 on one process
    t0 = time.perf_counter()
    d7_one = _scripted_adaptive(torch, dev, _d7_cfg())
    d7_one["wall"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # (d8)'s twin: phase (c)'s run without a fault, K = D8_K on one process
    from repro_torch.config import FaultToleranceConfig
    c_state, _, _, c_ladder, _, _ = _fault_run(
        torch, dev, _fault_cfg(get_smoke("smollm-360m"), D8_K),
        FaultToleranceConfig(), os.path.join(tmp, "c_one"))
    c_one = _host(torch, {k: c_state[k] for k in ("params", "opt", "sync",
                                                  "step")})
    c_trajectory = c_ladder.trajectory
    del c_state, c_ladder
    _wait(torch, dev)
    torch.cuda.empty_cache()
    log(f"dist: one-process twins done in "
        f"{time.perf_counter() - t_phase:.1f} s; the parent holds "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB on the card")

    # (d1)-(d3): K gloo ranks on the one card
    t0 = time.perf_counter()
    ranks = M.spawn(_dist_svm_rank, DIST_K, backend="gloo",
                    args=(paths, DIST_TIMED_BS, DIST_TIMED_BLOCKS),
                    timeout_s=900)
    spawn_s = time.perf_counter() - t0
    _log_ranks([o["report"] for o in ranks])
    w0 = ranks[0]["d1"]["w"]
    same = all(o["d1"]["w"].tobytes() == w0.tobytes() for o in ranks)
    w_dist = torch.from_numpy(w0).to(dev)
    rel = float((w_dist - w_one).norm() / w_one.norm())
    acc = float(svm.accuracy(w_dist, *eps_test))
    per_rank = DIST_EPOCHS * blocks
    launches = [o["d1"]["launches"] for o in ranks]
    cluster = [o["d1"]["cluster"] for o in ranks]
    walls = [o["d1"]["wall"] for o in ranks]
    log(f"(d1) dms epsilon K={DIST_K} ranks (gloo, one card) block "
        f"{DIST_BS} epochs {DIST_EPOCHS} (n_train {eps.x_train.shape[0]}, "
        f"{blocks} blocks an epoch a rank): w bitwise equal on all "
        f"{DIST_K} ranks {same}; rel L2(w) vs the one-process vmap run "
        f"{rel:.3e} (bound {W_REL_L2}), bitwise "
        f"{bool(torch.equal(w_dist, w_one))}; test acc dist {acc:.4f} one-process "
        f"{acc_one:.4f}; hinge launches {sum(launches)} (expected "
        f"{DIST_K * per_rank}: {DIST_K} ranks x {DIST_EPOCHS} x {blocks}), "
        f"{sum(cluster)} on the cluster kernel; wall (host clock, waited "
        f"for, with the rank's row block copied to the card) max "
        f"{max(walls):.4f} s min {min(walls):.4f} s, "
        f"{1e6 * max(walls) / per_rank:.1f} us a block; the row block's "
        f"copy alone max {max(o['d1']['copy_s'] for o in ranks):.4f} s; the "
        f"{DIST_K} ranks' spawn and phase {spawn_s:.1f} s")
    check(same, "(d1): the ranks' models differ")
    check(rel <= W_REL_L2, f"(d1): rel L2 {rel} > {W_REL_L2}")
    check(abs(acc - acc_one) <= ACC_DIFF, f"(d1): accuracy {acc} vs "
          f"{acc_one}")
    check(launches == [per_rank] * DIST_K == cluster,
          f"(d1): launches {launches}, cluster {cluster}, expected "
          f"{per_rank} a rank on the cluster kernel")

    for i, (ov, topo, ga) in enumerate(DIST_MODES):
        label = f"{ov}/{topo}{'/async' if ga else ''}"
        got = [o["d2"][i] for o in ranks]
        w_d = torch.from_numpy(got[0]["w"]).to(dev)
        n_launch = [g["launches"] for g in got]
        wall = max(g["wall"] for g in got)
        check(n_launch == [web.x_train.shape[0] // DIST_K // DIST_BS] * DIST_K
              and all(g["cluster"] == 0 for g in got),
              f"(d2) {label}: launches {n_launch}")
        one = web_one[i]
        if ga and async_growth(DIST_K, topo) > 1.0:
            finite = (bool(torch.isfinite(w_d).all()),
                      bool(torch.isfinite(one).all()))
            log(f"(d2) dms webspam {label} K={DIST_K} ranks: model finite "
                f"dist {finite[0]} one-process {finite[1]} (async growth "
                f"{async_growth(DIST_K, topo):.4f} a block at alpha=1: both "
                f"overflow, as the reference does); launches "
                f"{sum(n_launch)}; wall max {wall:.4f} s")
            check(finite == (False, False), f"(d2) {label}: {finite}")
            continue
        rel = float((w_d - one).norm() / one.norm())
        acc_d = float(svm.accuracy(w_d, xwt, ywt))
        acc_o = float(svm.accuracy(one, xwt, ywt))
        twin = "one-process stepper" if ga else "one-process vmap run"
        log(f"(d2) dms webspam {label} K={DIST_K} ranks: rel L2(w) vs the "
            f"{twin} {rel:.3e}, bitwise {bool(torch.equal(w_d, one))}; test "
            f"acc dist {acc_d:.4f} one-process {acc_o:.4f}; hinge launches "
            f"{sum(n_launch)} (hinge.cu); wall max {wall:.4f} s")
        check(rel <= W_REL_L2, f"(d2) {label}: rel L2 {rel}")
        check(abs(acc_d - acc_o) <= ACC_DIFF, f"(d2) {label}: accuracy")

    # the mean is an all-gather of each rank's w, then the stacked mean:
    # (K − 1) · 4d bytes in on each rank, against the cost model's ring
    # all-reduce, 2 · 4d · (K − 1) / K
    bytes_in = (DIST_K - 1) * 4 * d
    bytes_all = costmodel.wire_bytes_per_sync(
        4 * d, DIST_K, SyncConfig(strategy="periodic"))
    for bs in DIST_TIMED_BS:
        ests = [o["d3"][bs] for o in ranks]
        check(all(e == ests[0] for e in ests),
              f"(d3) {bs}: the ranks' reduced times differ")
        t_step, t_sync = ests[0]
        check(np.isfinite(t_step) and np.isfinite(t_sync) and t_step > 0
              and t_sync > 0, f"(d3) {bs}: T_step {t_step} T_sync {t_sync}")
        pick = autotune.choose_period(
            autotune.TuneInputs(param_bytes_per_chip=4 * d, replicas=DIST_K,
                                step_time_s=t_step),
            SyncConfig(strategy="periodic", period=bs),
            sync_time_override=t_sync)
        # the block at which the sync is choose_period's 5% of the compute,
        # before its drift cap
        h_comm = int(np.ceil(t_sync / (0.05 * t_step)))
        log(f"(d3) dms_timed_steps epsilon K={DIST_K} ranks block {bs} "
            f"({DIST_TIMED_BLOCKS} blocks, the first the warm-up): T_step "
            f"{1e6 * t_step:.4f} us a point, T_sync {1e6 * t_sync:.4f} us a "
            f"block (max over the ranks; host clock, waited for on the host "
            f"and the card); the mean's all-gather takes in {bytes_in} B a "
            f"rank ({4 * d} B from each other rank), the cost model's ring "
            f"all-reduce {bytes_all:.0f} B; compute "
            f"{1e6 * t_step * bs:.1f} us against sync {1e6 * t_sync:.1f} us "
            f"a block; choose_period picks block size {pick} (the sync is "
            f"5% of the compute from block {h_comm})")
    # the collective alone: the port's all-gather mean against the
    # reference's all-reduce, and the block each would have choose_period
    # pick at block DIST_BS's T_step
    colls = ranks[0]["coll"]
    check(all(o["coll"] == colls for o in ranks),
          "(d3): the ranks' reduced collective times differ")
    t_step = ranks[0]["d3"][DIST_BS][0]
    _TOOLING["dist_timed"] = dict(t_step=t_step,
                                  t_sync=ranks[0]["d3"][DIST_BS][1],
                                  k=DIST_K, d=d, block=DIST_BS)
    picks = {name: autotune.choose_period(
        autotune.TuneInputs(param_bytes_per_chip=4 * d, replicas=DIST_K,
                            step_time_s=t_step),
        SyncConfig(strategy="periodic", period=DIST_BS),
        sync_time_override=t) for name, t in colls.items()}
    log(f"(d3) the mean of a ({d},) f32 w alone across the {DIST_K} ranks, "
        f"{DIST_COLL_CALLS} calls of each in turns (max over the ranks of "
        f"each rank's mean; host clock, waited for on the host and the "
        f"card): " + "; ".join(
            f"{name} {1e6 * t:.1f} us a call, choose_period picks {picks[name]}"
            for name, t in colls.items())
        + f" (at block {DIST_BS}'s T_step); bytes in a rank: all-gather "
        f"{bytes_in} B, ring all-reduce {bytes_all:.0f} B")
    check(all(np.isfinite(t) and t > 0 for t in colls.values()),
          f"(d3): collective times {colls}")

    # (d9): the SVM block ladder across the ranks against its one-process
    # twin, and the controller's agreed pick
    d9 = [o["d9"] for o in ranks]
    w9 = d9[0]["w"]
    same = all(o["w"].tobytes() == w9.tobytes() for o in d9)
    twin = bool(torch.equal(torch.from_numpy(w9).to(dev), w_lad))
    per_rank = sum(n_local // bs for bs in D9_SIZES)
    launches = [o["launches"] for o in d9]
    cluster = [o["cluster"] for o in d9]
    picks = [o["d9_pick"] for o in ranks]
    t_step, t_sync = picks[0]["est"]
    log(f"(d9) svm block ladder epsilon across {DIST_K} ranks (gloo, one "
        f"card), rungs {SVM_RUNGS}: an epoch at {D9_SIZES[0]}, the switch, "
        f"an epoch at {D9_SIZES[1]}: w bitwise equal on all ranks {same}, "
        f"bitwise the one-process K={DIST_K} ladder {twin} (one process "
        f"{n_lad} launches, {wall_lad:.4f} s); hinge launches a rank "
        f"{launches} (expected {per_rank}), on the cluster kernel {cluster}; "
        f"wall max {max(o['wall'] for o in d9):.4f} s, "
        f"{1e3 * max(o['wall'] for o in d9) / per_rank:.2f} ms a block")
    log(f"(d9) the controller over {SVM_RUNGS} on every rank, fed (d3)'s "
        f"block-{DIST_BS} run ({DIST_TIMED_BLOCKS} blocks, the max over the "
        f"ranks): T_step {1e6 * t_step:.4f} us a point, T_sync "
        f"{1e6 * t_sync:.4f} us a block; picks {[p['h'] for p in picks]} "
        f"(agreed), history {picks[0]['history']}; phase (b) runs the same "
        f"controller on one card")
    check(same and twin, "(d9): the ladder's model differs across ranks or "
          "from the one-process ladder")
    check(launches == [per_rank] * DIST_K == cluster,
          f"(d9): launches {launches}, cluster {cluster}, expected "
          f"{per_rank} a rank on the cluster kernel")
    check(all(p == picks[0] for p in picks) and picks[0]["h"] in SVM_RUNGS,
          f"(d9): picks {picks}")

    # (d4): the trainer across two ranks at full width, then (d7) on them
    t0 = time.perf_counter()
    both = M.spawn(_dist_trainers_rank, DIST_TRAIN_K, backend="gloo",
                   args=(paths, DIST_TRAIN_H, DIST_TRAIN_BLOCKS),
                   timeout_s=1200)
    train_s = time.perf_counter() - t0
    tr = [o["d4"] for o in both]
    ad = [o["d7"] for o in both]
    _log_ranks([o["report"] for o in tr])
    n_leaves = len(tr[0]["own"])
    expect = DIST_TRAIN_BLOCKS * n_leaves * 2
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(tr[0]["losses"],
                                                       losses_one))
    peak_gb = sum(o["report"]["peak"] for o in tr) / 1e9
    wire_ok = all(o["gathered"][i][j] == tr[j]["own"][i]
                  for o in tr for i in range(n_leaves)
                  for j in range(DIST_TRAIN_K))
    log(f"(d4) train {model_cfg.name} across {DIST_TRAIN_K} ranks "
        f"(gloo, one card): K={DIST_TRAIN_K}, H={DIST_TRAIN_H}, int8, 1 x "
        f"{TRAIN_SEQ} tokens a replica step, {DIST_TRAIN_BLOCKS} blocks: "
        f"losses {tr[0]['losses']} (one-process {losses_one}), rel "
        f"{rel_loss:.3e} (bound {TRAIN_LOSS_REL}); params rel L2 "
        f"{[round(o['params_rel'], 9) for o in tr]} (bound "
        f"{TRAIN_PARAMS_REL_L2}); params equal on both ranks "
        f"{tr[0]['params_digest'] == tr[1]['params_digest']}; block walls "
        f"{[o['walls'] for o in tr]} s (one-process {walls_one} s), sync "
        f"{[o['sync_ms'] for o in tr]} ms; quant launches "
        f"{[o['launches'] for o in tr]} (expected {expect} a rank); the "
        f"first sync's payloads: kernel bitwise the plain version on every "
        f"rank {all(o['plain_same'] for o in tr)}, every rank's payload "
        f"gathered bitwise by every rank {wire_ok}, against the one-process "
        f"run's: {[o['diff_q'] for o in tr]} of {tr[0]['n_q']} int8 values "
        f"differ (max |dq| {max(o['max_dq'] for o in tr)}), scales rel "
        f"{max(o['scale_rel'] for o in tr):.3e}; peak memory "
        f"{[round(o['report']['peak'] / 2**30, 2) for o in tr]} GiB, "
        f"{peak_gb:.2f} GB in all (bound {DIST_PEAK_GB}); the spawn and "
        f"phase {train_s:.1f} s")
    check(rel_loss <= TRAIN_LOSS_REL, f"(d4): losses rel {rel_loss}")
    check(all(o["params_rel"] <= TRAIN_PARAMS_REL_L2 for o in tr),
          "(d4): params rel L2")
    check(tr[0]["params_digest"] == tr[1]["params_digest"],
          "(d4): the replicas differ after a blocking sync")
    check(all(o["launches"] == expect for o in tr),
          "(d4): quant launches")
    check(all(o["plain_same"] for o in tr) and wire_ok,
          "(d4): the first sync's payloads")
    check(all(o["diff_q"] == 0 for o in tr)
          and max(o["scale_rel"] for o in tr) == 0.0,
          "(d4): the first sync's payloads differ from the one-process "
          "run's")
    check(peak_gb < DIST_PEAK_GB, f"(d4): peak {peak_gb} GB")

    # (d7): the scripted move held to the one-process twin, then the live
    # controller
    _log_ranks([o["report"] for o in ad])
    sc = [o["scripted"] for o in ad]
    digest_ok = [o["digests"][0] == d7_one["digests"][r]
                 for r, o in enumerate(sc)]
    n_dig = len(d7_one["digests"][0])
    log(f"(d7) adaptive train {model_cfg.name} across {DIST_TRAIN_K} ranks "
        f"(gloo, one card), int8, 1 x {TRAIN_SEQ} tokens a replica step, "
        f"ladder (1, 2, 4) from H=4: the scripted move {D7_SCRIPT} over "
        f"{D7_SCRIPTED_BLOCKS} blocks, trajectory {sc[0]['trajectory']} "
        f"(one process {d7_one['trajectory']}); each rank's params, opt, "
        f"sync and first sync's int8 payloads and scales ({n_dig} sha256 "
        f"digests) bitwise the one-process K={DIST_TRAIN_K} run's replica "
        f"{digest_ok}; losses {sc[0]['losses']} (one process "
        f"{d7_one['losses']}); quant launches a rank "
        f"{[o['launches'] for o in sc]} (one process {d7_one['launches']}); "
        f"compiles after warmup {[o['compiles'] for o in sc]}; wall max "
        f"{max(o['wall'] for o in sc):.1f} s (one process "
        f"{d7_one['wall']:.1f} s, with digests)")
    check(all(digest_ok), "(d7): the scripted run differs from the "
          "one-process run")
    check(all(o["losses"] == d7_one["losses"] for o in sc),
          "(d7): the scripted run's losses differ")
    check(all(o["trajectory"] == d7_one["trajectory"] ==
              [(0, 4), (2, 2)] for o in sc),
          f"(d7): trajectories {[o['trajectory'] for o in sc]}")
    n_leaves = d7_one["n_leaves"]
    expect_sc = 2 * n_leaves * D7_SCRIPTED_BLOCKS
    check(all(o["launches"] == expect_sc for o in sc)
          and all(o["compiles"] == 0 for o in sc),
          f"(d7): scripted launches {[o['launches'] for o in sc]}, expected "
          f"{expect_sc}")
    lv = [o["live"] for o in ad]
    t_step, t_sync = lv[0]["est"]
    peak_gb = sum(o["peak"] for o in lv) / 1e9
    per_block = lv[0]["small_calls"] / lv[0]["end"]
    small_ms = 1e3 * max(o["small_s"] for o in lv) / lv[0]["end"]
    block_s = sum(max(o["walls"][i] for o in lv)
                  for i in range(lv[0]["end"])) / lv[0]["end"]
    log(f"(d7) the live controller, {D7_LIVE_BLOCKS} blocks: H trajectory "
        f"{lv[0]['trajectory']}, history {lv[0]['history']}; T_step "
        f"{t_step:.6f} s a replica step, T_sync {1e3 * t_sync:.3f} ms a sync "
        f"(the max over the ranks; CUDA events around sync_point; phase (a) "
        f"runs the same ladder on one card); block walls "
        f"{[round(w, 4) for w in lv[0]['walls']]} s (max over the ranks); "
        f"losses {lv[0]['losses']}; compiles after warmup a rank "
        f"{[o['own'] for o in lv]} (to_dict's max "
        f"{lv[0]['compiles_after_warmup']}, total "
        f"{lv[0]['compiles_total']}); quant launches a rank "
        f"{[o['launches'] for o in lv]} (expected {2 * n_leaves} a block); "
        f"small all-reduces (block times, watchdog, agreements) "
        f"{per_block:.1f} a block, {small_ms:.2f} ms a block (host clock, "
        f"the wait for the other rank in it), "
        f"{100 * small_ms / 1e3 / block_s:.3f}% of a {block_s:.3f} s block; "
        f"peak memory "
        f"{[round(o['peak'] / 2**30, 2) for o in lv]} GiB, {peak_gb:.2f} GB "
        f"in all (bound {DIST_PEAK_GB}); the spawn of (d4) and (d7) "
        f"{train_s:.1f} s")
    check(all(o["trajectory"] == lv[0]["trajectory"]
              and o["est"] == lv[0]["est"] for o in lv),
          "(d7): the ranks' trajectories or telemetry differ")
    check(all(o["end"] == D7_LIVE_BLOCKS and o["own"] == 0 for o in lv)
          and lv[0]["compiles_after_warmup"] == 0
          and lv[0]["compiles_total"] > 0 and lv[0]["ranks"] == DIST_TRAIN_K,
          f"(d7): blocks / compiles {[(o['end'], o['own']) for o in lv]}")
    check(all(h in (1, 2, 4) for _, h in lv[0]["trajectory"]),
          f"(d7): a rung outside the ladder {lv[0]['trajectory']}")
    check(all(o["launches"] == 2 * n_leaves * D7_LIVE_BLOCKS for o in lv),
          f"(d7): live quant launches {[o['launches'] for o in lv]}")
    check(all(np.isfinite(o["losses"]).all() for o in lv),
          "(d7): losses not finite")
    check(np.isfinite(t_step) and np.isfinite(t_sync) and t_step > 0
          and t_sync > 0, f"(d7): T_step {t_step} T_sync {t_sync}")
    check(peak_gb < DIST_PEAK_GB, f"(d7): peak {peak_gb} GB")

    # (d5): hierarchical at smoke width, (pod 2, data 2); then (d8), fault
    # and restart, on the same four ranks
    t0 = time.perf_counter()
    four = M.spawn(_dist_four_rank, 4, backend="gloo",
                   args=(3, tmp, D8_STRAGGLE_S), timeout_s=900)
    four_s = time.perf_counter() - t0
    hr = [o["d5"] for o in four]
    _log_ranks([o["report"] for o in hr])
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(hr[0]["losses"],
                                                       hier_losses_one))
    rel = _tree_rel_l2(torch, hr[0]["params"], hier_one)
    log(f"(d5) hierarchical smollm smoke on a (pod 2, data 2) mesh of 4 "
        f"ranks, int8, H=2, 3 blocks: losses {hr[0]['losses']} against the "
        f"one-process periodic K=2 run's {hier_losses_one}, rel "
        f"{rel_loss:.3e}; params rel L2 {rel:.3e}; quant launches a rank "
        f"{[o['launches'] for o in hr]}; {time.perf_counter() - t0:.1f} s")
    check(rel_loss <= TRAIN_LOSS_REL and rel <= TRAIN_PARAMS_REL_L2,
          f"(d5): rel {rel_loss} / {rel}")

    fr = [o["d8"] for o in four]
    _log_ranks([o["report"] for o in fr])
    n_leaves = len(T.leaves(c_one["params"]))
    for name in ("none", "fault@4", "fault@2", "straggle"):
        runs = [o[name] for o in fr]
        seen = [[(e["step"], round(e["elapsed"], 3)) for e in o["events"]]
                for o in runs]
        log(f"(d8) fault/restart across {D8_K} ranks, smollm smoke, int8, "
            f"run {name} (on rank 1 only): steps {[o['end'] for o in runs]}, "
            f"restarts {[o['restarts'] for o in runs]}, trajectory "
            f"{runs[0]['trajectory']}, checkpoint writes a rank "
            f"{[o['writes'] for o in runs]}, watchdog events a rank "
            f"{seen}, "
            f"quant launches a rank {[o['launches'] for o in runs]}, "
            f"compiles after warmup {[o['compiles'] for o in runs]}")
        for r, o in enumerate(runs):
            _same(torch, o["final"], c_one, f"(d8) {name} rank {r} vs phase "
                  f"(c)'s one-process run")
        # a restart before the first checkpoint goes back to the start rung,
        # which the trajectory records
        check(all(o["end"] == FAULT_STEPS and o["compiles"] == 0
                  and o["trajectory"] == runs[0]["trajectory"] for o in runs)
              and runs[0]["trajectory"][-1] == c_trajectory[-1]
              and (runs[0]["trajectory"] == c_trajectory
                   or name == "fault@2"),
              f"(d8) {name}: steps, compiles or trajectory")
        check([o["restarts"] for o in runs]
              == [int(name.startswith("fault"))] * D8_K,
              f"(d8) {name}: restarts {[o['restarts'] for o in runs]}")
        check(all(o["launches"] > 0 for o in runs),
              f"(d8) {name}: no quant launch")
        if name != "straggle":
            check(runs[0]["writes"] == [3, 6]
                  and all(o["writes"] == [] for o in runs[1:]),
                  f"(d8) {name}: checkpoint writes "
                  f"{[o['writes'] for o in runs]}")
    none = [o["none"] for o in fr]
    check(all(o["launches"] == 2 * n_leaves * FAULT_STEPS for o in none),
          f"(d8): quant launches {[o['launches'] for o in none]}")
    events = [o["straggle"]["events"] for o in fr]
    last = [e for e in events[0] if e["step"] == FAULT_STEPS - 1]
    check(all(e == events[0] for e in events) and last
          and last[0]["elapsed"] >= D8_STRAGGLE_S / 2,
          f"(d8): watchdog events {events}")
    log(f"(d8): every run on every rank bitwise phase (c)'s one-process "
        f"K={D8_K} run without a fault (params, opt, sync, step): the fault "
        f"on rank 1 after the step-3 checkpoint (rank 0's file restored on "
        f"every rank) and before it (each rank's own start copy); rank 1's "
        f"{D8_STRAGGLE_S} s hold-up before step {FAULT_STEPS - 1}, outside "
        f"its own clock, recorded by every rank; the spawn of (d5) and (d8) "
        f"{four_s:.1f} s")

    # (d6): one NCCL world of one rank
    t0 = time.perf_counter()
    (nc,) = M.spawn(_dist_nccl_rank, 1, backend="nccl", args=(paths,),
                    timeout_s=600)
    _log_ranks([nc["report"]])
    w_n = torch.from_numpy(nc["w"]).to(dev)
    n_web = web.x_train.shape[0] // DIST_BS
    rel = float((w_n - w_srdms).norm() / w_srdms.norm())
    log(f"(d6) dms(backend='dist') K=1 on an NCCL world of one rank, webspam "
        f"block {DIST_BS}, one epoch: rel L2(w) vs srdms {rel:.3e} (bound "
        f"1e-6), bitwise {bool(torch.equal(w_n, w_srdms))}; hinge launches "
        f"{nc['launches']} (expected {n_web}), {nc['cluster']} on the "
        f"cluster kernel; {time.perf_counter() - t0:.1f} s")
    check(rel <= 1e-6, f"(d6): rel {rel}")
    check(nc["launches"] == n_web and nc["cluster"] == 0,
          f"(d6): launches {nc['launches']}, cluster {nc['cluster']}, "
          f"expected {n_web} on hinge.cu")
    log(f"dist: phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase mesh_serve: serving on a (data, model) process mesh
# ---------------------------------------------------------------------------

class SeededExtras:
    """Within ``with``: the pipeline's stub inputs (the VLM's ``patches``,
    the audio ``frames``: zeros) drawn in each global batch from ``seed``
    and the data step, normal f32 on the host, before the pipeline takes
    a process's rows: a rank's rows are the one process's same rows."""

    def __init__(self, seed: int):
        self.seed = seed

    def __enter__(self):
        from repro_torch.data import pipeline
        self.cls, self.orig = pipeline.DataPipeline, \
            pipeline.DataPipeline._host_batch
        orig, seed = self.orig, self.seed

        def host_batch(pipe, step):
            batch = orig(pipe, step)
            rng = np.random.default_rng((seed, step))
            for key in ("patches", "frames"):
                if key in batch:
                    batch[key] = rng.standard_normal(
                        batch[key].shape, dtype=np.float32)
            return batch
        self.cls._host_batch = host_batch
        return self

    def __exit__(self, *exc):
        self.cls._host_batch = self.orig


class DropCounter:
    """Within ``with``: the slots every MoE routing of this process dropped
    (``repro_torch.models.moe.routing`` wrapped, restored on exit); each
    call's count stays on the device until :attr:`dropped` reads them."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig, self.counts = moe, moe.routing, []

        def routing(logits, cfg, capacity_factor=moe.CAPACITY_FACTOR):
            out = self.orig(logits, cfg, capacity_factor)
            self.counts.append((out[2] >= out[3]).sum())
            return out
        moe.routing = routing
        return self

    def __exit__(self, *exc):
        self.moe.routing = self.orig

    @property
    def dropped(self) -> int:
        return sum(int(c) for c in self.counts)


class ShardedCapacity:
    """Within ``with``: ``moe_ffn`` on T ≥ 32,768 tokens runs on each (data,
    model) block of MESH_SHAPE apart (rows over data, the sequence over
    model), so each block routes with the mesh path's capacity C_s: a
    one-process run of the sharded capacity rule. A training loss's
    load-balance term is the sharded path's: E · Σ_e (the blocks' mean gate
    mass) · (their mean routed share)."""

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.moe_ffn
        n_data, n_model = MESH_SHAPE

        def blocks(params, x, cfg, capacity_factor=moe.CAPACITY_FACTOR,
                   return_aux=False, seq=None):
            b, s, _ = x.shape
            if seq is not None:
                raise ValueError("ShardedCapacity runs one process's "
                                 "whole sequence")
            if b * s < moe.SHARDED_MIN_TOKENS:
                return self.orig(params, x, cfg, capacity_factor,
                                 return_aux)
            rows, mes, ces = [], [], []
            for row in x.chunk(n_data, 0):
                parts = []
                for blk in row.chunk(n_model, 1):
                    parts.append(self.orig(params, blk, cfg,
                                           capacity_factor))
                    if return_aux:
                        logits = moe.router_logits(params, blk)
                        me, ce = moe._load_terms(logits, moe.top_k_routing(
                            logits, cfg.moe.top_k)[1], cfg)
                        mes.append(me)
                        ces.append(ce)
                rows.append(torch.cat(parts, 1))
            out = torch.cat(rows, 0)
            if not return_aux:
                return out
            return out, cfg.moe.num_experts * torch.sum(
                torch.stack(mes).mean(0) * torch.stack(ces).mean(0))
        moe.moe_ffn = blocks
        return self

    def __exit__(self, *exc):
        self.moe.moe_ffn = self.orig


class CollectiveTimer:
    """Every mesh collective of this process (``Group``'s ``all_to_all``,
    ``gather_dim``, ``sum_scatter_dim``, ``sum``, ``maximum``, ``sum_``: the
    trainer's gradient reduction), and the ops the autograd backward runs
    as their transposes (``_all_to_all``, ``_gather_dim``,
    ``_sum_scatter_dim``, ``_all_reduce`` called other than from inside
    one of those: recorded as ``<op> (backward)``; the trainer's global
    norm sums its squares so too, a few bytes a step), waited for on both
    sides and timed on the host clock: ``records`` holds (op, input shape,
    input bytes, seconds). Installed for the life of a rank."""

    OPS = ("all_to_all", "gather_dim", "sum_scatter_dim", "sum", "maximum",
           "sum_")
    TRANSPOSES = {"_all_to_all": "all_to_all", "_gather_dim": "gather_dim",
                  "_sum_scatter_dim": "sum_scatter_dim", "_all_reduce": "sum"}

    def __init__(self, torch):
        from repro_torch.core import collectives as CL
        self.records = []
        self.depth = 0
        for name in self.OPS:
            setattr(CL.Group, name, self._timed(torch, name,
                                                getattr(CL.Group, name)))
        for name, op in self.TRANSPOSES.items():
            setattr(CL.Group, name, self._timed(
                torch, f"{op} (backward)", getattr(CL.Group, name),
                inner=True))

    def _timed(self, torch, name, fn, inner=False):
        def timed(group, x, *args):
            if inner and self.depth:
                return fn(group, x, *args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.depth += 1
            try:
                y = fn(group, x, *args)
            finally:
                self.depth -= 1
            torch.cuda.synchronize()
            self.records.append((name, tuple(x.shape),
                                 x.numel() * x.element_size(),
                                 time.perf_counter() - t0,
                                 isinstance(x, torch.nn.Parameter)))
            return y
        return timed

    def take(self, fsdp_shapes=()):
        """The records so far, summed: ms and bytes by op, the FSDP gathers
        (``gather_dim`` of a serving engine's weight, or of a shard of one
        of ``fsdp_shapes``: a trainer's expert table) apart; then
        cleared."""
        out = {}
        for name, shape, nbytes, sec, weight in self.records:
            if name == "gather_dim" and (weight or shape in fsdp_shapes):
                name = "fsdp_gather"
            ms, b, n = out.get(name, (0.0, 0, 0))
            out[name] = (ms + 1e3 * sec, b + nbytes, n + 1)
        self.records.clear()
        return out


def _weight_bytes(eng):
    """(the bytes of the weights a mesh engine's rank holds, the whole
    model's at the engine's dtype)."""
    from repro_torch import sharding as S
    held = sum(t.numel() * t.element_size() for t in eng.params.parameters())
    size = next(eng.params.parameters()).element_size()
    whole = sum(size * math.prod(p.shape)
                for p in S.flat_keys(eng.model.param_defs()).values())
    return held, whole


def _head_shards(cfg) -> str:
    """The heads a mesh rank's flash and SSD launches take, as the serving
    rules split them on MESH_SHAPE."""
    from repro_torch.launch.serve import serving_rules

    class Mesh:
        axes, shape = ("data", "model"), MESH_SHAPE
    rules = serving_rules(cfg, Mesh, MESH_SHAPE[1])
    parts = []
    if cfg.family != "ssm":
        m = MESH_SHAPE[1] if rules.mesh_axes_for("heads") else 1
        parts.append(f"flash on {cfg.n_heads // m} of {cfg.n_heads} query "
                     f"heads")
    if cfg.family in ("ssm", "hybrid"):
        h = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        m = MESH_SHAPE[1] if rules.mesh_axes_for("ssm_heads") else 1
        parts.append(f"SSD on {h // m} of {h} heads")
    return ", ".join(parts) + " a rank"


def _weights_line(runs):
    held = [r["weights"][0] for r in runs]
    whole = runs[0]["weights"][1]
    return (f"weights a rank {[round(h / 1e9, 3) for h in held]} GB of the "
            f"whole model's {whole / 1e9:.3f} GB (a rank "
            f"{max(held) / whole:.3f} of it)")


def _mesh_cfg(dtype: str):
    from repro_torch.config import get_arch
    return dataclasses.replace(get_arch(MESH_ARCH), n_layers=MESH_DEPTH,
                               dtype=dtype)


def _mesh_one_process(torch, dev, dtype, prompts, forced, sharded=False):
    """The one-process engine at the mesh phase's depth: the prefill's
    logits and wall, then decode steps (eager) greedy (``forced`` None) or
    teacher-forced on ``forced``; the slots its routings dropped. With
    ``sharded`` the MoE takes the mesh path's capacity rule
    (:class:`ShardedCapacity`)."""
    import contextlib
    from repro_torch.launch.serve import ServeEngine
    eng = ServeEngine(_mesh_cfg(dtype), dev, max_len=MESH_PROMPT + MESH_GEN,
                      dtype=getattr(torch, dtype), graphs=False)
    with DropCounter() as drops, (ShardedCapacity() if sharded
                                  else contextlib.nullcontext()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = eng.prefill(prompts)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if forced is None:
            loop = eng.decode_loop(prompts.shape[0])
            loop.start(logits, MESH_PROMPT)
            steps = [loop.step().clone() for _ in range(MESH_GEN)]
        else:
            steps = _forced_steps(eng, logits, MESH_PROMPT, forced)
        torch.cuda.synchronize()
        decode_ms = 1e3 * (time.perf_counter() - t0) / MESH_GEN
    logits = [x.float().cpu() for x in [logits] + steps]
    out = dict(logits=logits, prefill_s=prefill_s, decode_ms=decode_ms,
               drops=drops.dropped,
               argmax=torch.stack([x.argmax(-1) for x in logits], 1))
    del eng, steps
    torch.cuda.empty_cache()
    return out


def _mesh_serve_rank(prompts, forced):
    """One rank of phase mesh_serve's (data, model) mesh: per dtype a
    ``ServeEngine(mesh=)`` drawn from the seed (its shards kept), the
    prefill and the steps teacher-forced on ``forced`` (this rank's rows)
    with every collective timed; in bf16 first the main path's counted run,
    ``generate``."""
    import torch
    from repro_torch.core import collectives as CL
    from repro_torch.launch import mesh as M
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import moe
    _rank_setup(torch)
    mesh = M.make_mesh(MESH_SHAPE, ("data", "model"))
    dev = mesh.device
    timer = CollectiveTimer(torch)
    counters = serve_counters()
    prompts = torch.from_numpy(prompts).to(dev)
    rows = MESH_BATCH // MESH_SHAPE[0]
    forced = torch.from_numpy(forced).to(dev).narrow(
        0, mesh.rank("data") * rows, rows)
    out = dict(rank=mesh.rank(), data=mesh.rank("data"),
               model=mesh.rank("model"), device=str(dev))
    for dtype in ("bfloat16", "float32"):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        eng = ServeEngine(_mesh_cfg(dtype), dev,
                          max_len=MESH_PROMPT + MESH_GEN,
                          dtype=getattr(torch, dtype), mesh=mesh)
        _wait(torch, dev)
        run = dict(draw_s=time.perf_counter() - t0,
                   weights=_weight_bytes(eng))
        if dtype == "bfloat16":
            # the main path's counted run: the counts set to 0 just before
            # and read just after
            reset(counters)
            moe.PATHS.clear()
            t0 = time.perf_counter()
            tokens = eng.generate(prompts, MESH_GEN)
            _wait(torch, dev)
            run["generate"] = dict(tokens=tokens,
                                   wall=time.perf_counter() - t0,
                                   launches=read(counters),
                                   paths=dict(moe.PATHS))
        timer.take()
        with DropCounter() as drops:
            reset(counters)
            moe.PATHS.clear()
            t0 = time.perf_counter()
            logits, _ = eng.prefill(prompts)
            _wait(torch, dev)
            run["prefill_s"] = time.perf_counter() - t0
            run["prefill"] = dict(launches=read(counters),
                                  paths=dict(moe.PATHS),
                                  coll=timer.take())
            moe.PATHS.clear()
            t0 = time.perf_counter()
            loop = eng.decode_loop(MESH_BATCH)
            loop.start(logits, MESH_PROMPT)
            steps = []
            for i in range(MESH_GEN):
                loop.token.copy_(forced[:, i:i + 1])
                steps.append(loop.step().clone())
            _wait(torch, dev)
            run["decode_ms"] = 1e3 * (time.perf_counter() - t0) / MESH_GEN
            run["decode"] = dict(paths=dict(moe.PATHS),
                                 coll=timer.take())
        run["drops"] = drops.dropped
        run["logits"] = np.stack([x.float().cpu().numpy()
                                  for x in [logits] + steps])
        run["peak"] = _peak(torch, dev)
        out[dtype] = run
        del eng, logits, steps, loop
        torch.cuda.empty_cache()
    out["staged"] = dict(CL.STAGED)
    out["staged_bytes"] = dict(CL.STAGED_BYTES)
    return out


def _coll_ranks(runs, key, per=1):
    """Each rank's collectives of one part (``key``: prefill or decode),
    summed over the ops: ms and MB in, divided by ``per``."""
    return "; ".join(
        f"rank {i} {sum(ms for ms, _, _ in r[key]['coll'].values()) / per:.1f}"
        f" ms, {sum(b for _, b, _ in r[key]['coll'].values()) / per / 1e6:.1f}"
        f" MB" for i, r in enumerate(runs))


def _coll_line(coll, per=1):
    return ", ".join(f"{name} {ms / per:.3f} ms ({n / per:g} calls, "
                     f"{b / per / 1e6:.2f} MB in)"
                     for name, (ms, b, n) in sorted(coll.items()))


def phase_mesh_serve(torch, dev):
    """Phase mesh_serve: ``ServeEngine(mesh=)`` on phi3.5-moe at its
    published widths, MESH_DEPTH layers, 4 gloo ranks sharing the card on a
    (data 2, model 2) mesh: the prefill of MESH_BATCH prompts of MESH_PROMPT
    tokens (T = 32,768: the vocab-parallel embedding and the all-to-all MoE
    once a layer), MESH_GEN steps (the one-hot MoE once a layer a step, the
    seq-sharded decode attention); held to the one-process engine at the
    same depth, seed and prompts: f32 logits within MESH_F32_REL_L2 and the
    same tokens, bf16 within LOGITS_REL_L2; every staged op counted."""
    from repro_torch.config import get_arch
    from repro_torch.launch import mesh as M
    t_phase = time.perf_counter()
    cfg = _mesh_cfg("float32")
    prompts = np.random.default_rng(MESH_SEED).integers(
        1, cfg.vocab_size, (MESH_BATCH, MESH_PROMPT)).astype(np.int64)
    on_card = torch.from_numpy(prompts).to(dev)
    log(f"mesh_serve: {cfg.name} at its published widths (d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), "
        f"{MESH_DEPTH} of {get_arch(MESH_ARCH).n_layers} layers; "
        f"{MESH_BATCH} x "
        f"{MESH_PROMPT} prompt tokens (T = {MESH_BATCH * MESH_PROMPT}), "
        f"{MESH_GEN} new; mesh (data {MESH_SHAPE[0]}, model "
        f"{MESH_SHAPE[1]}), {MESH_SHAPE[0] * MESH_SHAPE[1]} gloo ranks on "
        f"the one card")
    # the one-process engine: f32 greedy gives the tokens every other run
    # is teacher-forced on
    one = {"float32": _mesh_one_process(torch, dev, "float32", on_card,
                                        None)}
    forced = one["float32"]["argmax"][:, :MESH_GEN]
    one["bfloat16"] = _mesh_one_process(torch, dev, "bfloat16", on_card,
                                        forced.to(dev))
    del on_card
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = M.spawn(_mesh_serve_rank, MESH_SHAPE[0] * MESH_SHAPE[1],
                    backend="gloo", args=(prompts, forced.numpy()),
                    timeout_s=900)
    spawn_s = time.perf_counter() - t0
    n_layers, n_steps = MESH_DEPTH, MESH_GEN
    for dtype in ("bfloat16", "float32"):
        runs = [r[dtype] for r in ranks]
        # the two model ranks of a data row hold its rows bitwise alike
        same = all(np.array_equal(runs[i]["logits"], runs[i + 1]["logits"])
                   for i in range(0, len(runs), MESH_SHAPE[1]))
        check(same, f"mesh_serve {dtype}: the model ranks of a data row "
                    f"differ")
        got = torch.from_numpy(np.concatenate(
            [runs[i]["logits"] for i in range(0, len(runs), MESH_SHAPE[1])],
            axis=1))
        for r in runs:
            check(r["prefill"]["paths"] == {"sharded": n_layers},
                  f"mesh_serve {dtype}: prefill paths {r['prefill']['paths']}"
                  f", expected the all-to-all path {n_layers} times")
            check(r["decode"]["paths"] == {"onehot": n_layers * n_steps},
                  f"mesh_serve {dtype}: decode paths {r['decode']['paths']}, "
                  f"expected the one-hot path {n_layers * n_steps} times")
            kind = ("flash_attention_tc" if dtype == "bfloat16"
                    else "flash_attention_tc32")
            check(r["prefill"]["launches"][kind] == n_layers
                  and r["prefill"]["launches"]["flash_attention"] == n_layers,
                  f"mesh_serve {dtype}: flash launches a prefill "
                  f"{r['prefill']['launches']}, expected {n_layers} on "
                  f"{kind}")
        ref = one[dtype]
        mesh_drops = sum(r["drops"] for r in runs)
        label = "the one-process engine"
        if dtype == "float32" and (mesh_drops or ref["drops"]):
            ref = _mesh_one_process(torch, dev, "float32",
                                    torch.from_numpy(prompts).to(dev),
                                    forced.to(dev), sharded=True)
            label = ("a one-process run of the sharded capacity rule (slots "
                     "dropped)")
        want = torch.stack(ref["logits"])
        rels = [rel_l2(torch, a, b) for a, b in zip(got, want)]
        bound = MESH_F32_REL_L2 if dtype == "float32" else LOGITS_REL_L2
        argmax = got.argmax(-1).T
        same_tokens = bool((argmax == ref["argmax"]).all())
        also = (f", the sharded capacity rule's run {ref['drops']}"
                if ref is not one[dtype] else "")
        log(f"mesh_serve {dtype} against {label}: prefill logits rel L2 "
            f"{rels[0]:.4e}, {n_steps} steps max {max(rels[1:]):.4e} (bound "
            f"{bound}); tokens identical {same_tokens}; slots dropped: mesh "
            f"{mesh_drops} over the ranks' prefills and steps (C_s per "
            f"source shard), the one-process engine {one[dtype]['drops']} "
            f"(global C){also}; model ranks bitwise alike {same}")
        check(max(rels) <= bound, f"mesh_serve {dtype}: logits rel L2 "
                                  f"{max(rels)} > {bound}")
        if dtype == "float32":
            check(same_tokens, "mesh_serve float32: tokens differ from the "
                               "one-process engine's")
        pre = [r["prefill_s"] for r in runs]
        dec = [r["decode_ms"] for r in runs]
        draw = max(r["draw_s"] for r in runs)
        r0 = runs[0]
        log(f"mesh_serve {dtype} walls: prefill {max(pre):.4f} s (max over "
            f"the ranks; min {min(pre):.4f}) against one process "
            f"{one[dtype]['prefill_s']:.4f} s; decode {max(dec):.3f} ms a "
            f"step against {one[dtype]['decode_ms']:.3f} ms (both eager); "
            f"the draw of each rank's shards {draw:.1f} s")
        log(f"mesh_serve {dtype} rank 0's collectives, prefill: "
            f"{_coll_line(r0['prefill']['coll'])}; a decode step: "
            f"{_coll_line(r0['decode']['coll'], n_steps)} (each waited for "
            f"on both sides, host clock); every rank's, prefill: "
            f"{_coll_ranks(runs, 'prefill')}; a decode step: "
            f"{_coll_ranks(runs, 'decode', n_steps)}")
        peaks = [r["peak"] for r in runs]
        log(f"mesh_serve {dtype} peak memory a rank "
            f"{[round(p / 2**30, 2) for p in peaks]} GiB, "
            f"{sum(peaks) / 1e9:.2f} GB in all; {_weights_line(runs)}")
    gen = [r["bfloat16"]["generate"] for r in ranks]
    toks = gen[0]["tokens"]
    check(toks.shape == (MESH_BATCH, MESH_GEN)
          and all(np.array_equal(g["tokens"], toks) for g in gen),
          "mesh_serve: generate's tokens differ across the ranks")
    check(all(g["launches"]["flash_attention_tc"] == n_layers
              and g["paths"] == {"sharded": n_layers,
                                 "onehot": n_layers * n_steps} for g in gen),
          f"mesh_serve: the counted generate's launches and paths "
          f"{[(g['launches'], g['paths']) for g in gen]}")
    log(f"mesh_serve the main path's counted run (bf16 generate, counts 0 "
        f"just before, read just after): flash launches a rank "
        f"{[g['launches']['flash_attention_tc'] for g in gen]} on the bf16 "
        f"tensor-core kernel ({_head_shards(_mesh_cfg('float32'))}); paths "
        f"a rank {gen[0]['paths']}; wall "
        f"{max(g['wall'] for g in gen):.4f} s (max over the ranks), "
        f"{MESH_BATCH * MESH_GEN / max(g['wall'] for g in gen):.1f} new "
        f"tokens/s; tokens identical on every rank")
    for r in ranks:
        log(f"mesh_serve rank {r['rank']} (data {r['data']}, model "
            f"{r['model']}) on {r['device']}: host-staged ops "
            f"{r['staged'] or 'none'}, staged bytes "
            f"{r['staged_bytes'] or 'none'}")
    log(f"mesh_serve: the ranks' spawn and run {spawn_s:.1f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase mesh_families: the SSM, hybrid, VLM and audio families on a mesh
# ---------------------------------------------------------------------------

def _mfam_cfg(arch: str, depth, dtype: str):
    """``arch`` at its published widths, its depth cut to ``depth`` layers
    (None: all of them), activations in ``dtype``."""
    from repro_torch.config import get_arch
    cfg = get_arch(arch)
    return dataclasses.replace(cfg, n_layers=depth or cfg.n_layers,
                               dtype=dtype)


def _mfam_sizes(cfg, prompt_len: int):
    """(the position decoding starts at, ``max_len``): the prompt's
    positions after the VLM's image prefix, the new tokens and one more,
    rounded up to a multiple of the model axis so the self-attention caches
    split over it."""
    start = prompt_len + (cfg.num_image_tokens if cfg.family == "vlm" else 0)
    n = start + MFAM_GEN + 1
    return start, n + -n % MESH_SHAPE[1]


def _mfam_launches(cfg, bf16: bool):
    """The kernel launches a prefill makes (:func:`serve_launches`); in f32
    the flash kernel at a head dim past 128 (paligemma's 256) runs on
    ``flash_attention.cu``."""
    want = serve_launches(cfg, bf16)
    if not bf16 and want["flash_attention"] and cfg.resolved_head_dim > 128:
        want["flash_attention_tc32"] = 0
    return want


def _mfam_one(torch, dev, cfg, prompts, extras, start, max_len, forced):
    """The one-process engine: the prefill's logits and wall, then
    MFAM_GEN eager steps, greedy (``forced`` None) or teacher-forced on
    ``forced``; the logits (steps + 1, B, V) on the host."""
    from repro_torch.launch.serve import ServeEngine
    eng = ServeEngine(cfg, dev, max_len=max_len,
                      dtype=getattr(torch, cfg.dtype), graphs=False)
    on_card = torch.from_numpy(prompts).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = eng.prefill(on_card, extras)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if forced is None:
        loop = eng.decode_loop(MFAM_BATCH)
        loop.start(logits, start)
        steps = [loop.step().clone() for _ in range(MFAM_GEN)]
    else:
        steps = _forced_steps(eng, logits, start, forced)
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / MFAM_GEN
    out = torch.stack([x.float() for x in [logits] + steps]).cpu()
    del eng, logits, steps
    torch.cuda.empty_cache()
    return dict(logits=out, prefill_s=prefill_s, decode_ms=decode_ms,
                argmax=out.argmax(-1).T)


def _mfam_rank(runs, tmp):
    """One rank of phase mesh_families's (data, model) mesh, each model of
    ``runs`` in turn, per dtype a ``ServeEngine(mesh=)`` drawn from the
    seed (its shards kept): in bf16 the main path's counted run,
    ``generate``, whose prefill is timed, counted and kept; in f32 the
    prefill and MFAM_GEN steps
    teacher-forced on the one-process f32 engine's tokens (this rank's
    rows); every collective timed. The first model rank of each data row
    writes its logits to ``tmp`` (.npy); every rank returns their
    digest."""
    import hashlib
    import torch
    from repro_torch.core import collectives as CL
    from repro_torch.launch import mesh as M
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import layers as L
    _rank_setup(torch)
    mesh = M.make_mesh(MESH_SHAPE, ("data", "model"))
    dev = mesh.device
    timer = CollectiveTimer(torch)
    counters = serve_counters()
    # the vocab-parallel lookup's calls (T >= 32,768 and S tiling model)
    sharded = [0]
    embed_sharded = L.embed_sharded

    def counted(*args, **kw):
        sharded[0] += 1
        return embed_sharded(*args, **kw)
    L.embed_sharded = counted
    rows = MFAM_BATCH // MESH_SHAPE[0]
    out = dict(rank=mesh.rank(), data=mesh.rank("data"),
               model=mesh.rank("model"), device=str(dev), runs={})
    for run in runs:
        arch = run["arch"]
        prompts = torch.from_numpy(run["prompts"]).to(dev)
        extras = {k: torch.from_numpy(v) for k, v in run["extras"].items()}
        forced = torch.from_numpy(run["forced"]).to(dev).narrow(
            0, mesh.rank("data") * rows, rows)
        res = {}
        for dtype in ("bfloat16", "float32"):
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            eng = ServeEngine(_mfam_cfg(arch, run["depth"], dtype), dev,
                              max_len=run["max_len"],
                              dtype=getattr(torch, dtype), mesh=mesh)
            _wait(torch, dev)
            r = dict(draw_s=time.perf_counter() - t0,
                     table=tuple(eng.params["embed"]["embedding"].shape),
                     weights=_weight_bytes(eng))
            timer.take()
            reset(counters)
            sharded[0] = 0
            prefill = eng.prefill

            def timed_prefill(*args):
                # the prefill's wall, logits, launches and collectives,
                # the counts set to 0 just before it
                _wait(torch, dev)
                t0 = time.perf_counter()
                out = prefill(*args)
                _wait(torch, dev)
                r["prefill_s"] = time.perf_counter() - t0
                r["prefill"] = dict(launches=read(counters),
                                    sharded=sharded[0], coll=timer.take(),
                                    logits=out[0].clone())
                return out
            eng.prefill = timed_prefill
            if dtype == "bfloat16":
                # the main path's counted run: the counts set to 0 just
                # before and read just after; its prefill is the bf16
                # prefill held to one process
                t0 = time.perf_counter()
                tokens = eng.generate(prompts, MFAM_GEN, extras)
                _wait(torch, dev)
                r["generate"] = dict(tokens=tokens,
                                     wall=time.perf_counter() - t0,
                                     launches=read(counters),
                                     sharded=sharded[0])
                r["decode"] = dict(coll=timer.take())
            else:
                eng.prefill(prompts, extras)
            logits = r["prefill"].pop("logits")
            steps = []
            if dtype == "bfloat16":
                # the counted generate's steps: its wall less its prefill's
                r["decode_ms"] = 1e3 * (r["generate"]["wall"]
                                        - r["prefill_s"]) / MFAM_GEN
            else:
                t0 = time.perf_counter()
                loop = eng.decode_loop(MFAM_BATCH)
                loop.start(logits, run["start"])
                for i in range(MFAM_GEN):
                    loop.token.copy_(forced[:, i:i + 1])
                    steps.append(loop.step().clone())
                _wait(torch, dev)
                r["decode_ms"] = 1e3 * (time.perf_counter() - t0) / MFAM_GEN
                r["decode"] = dict(coll=timer.take())
                del loop
            arr = np.stack([x.float().cpu().numpy()
                            for x in [logits] + steps])
            r["digest"] = hashlib.sha256(arr.tobytes()).hexdigest()
            if mesh.rank("model") == 0:
                np.save(os.path.join(tmp, f"{arch}-{dtype}-"
                                          f"{mesh.rank('data')}.npy"), arr)
            r["peak"] = _peak(torch, dev)
            res[dtype] = r
            del eng, logits, steps, arr
            torch.cuda.empty_cache()
        out["runs"][arch] = res
    L.embed_sharded = embed_sharded
    out["staged"] = dict(CL.STAGED)
    out["staged_bytes"] = dict(CL.STAGED_BYTES)
    return out


def _mfam_hold(torch, run, one, ranks, tmp):
    """Hold one model's mesh runs to the one-process engine's and log
    them; its counted ``generate``'s launches a rank by counter."""
    arch, cfg = run["arch"], run["cfg"]
    for dtype in ("bfloat16", "float32"):
        runs = [r["runs"][arch][dtype] for r in ranks]
        same = all(runs[i]["digest"] == runs[i + 1]["digest"]
                   for i in range(0, len(runs), MESH_SHAPE[1]))
        check(same, f"mesh_families {arch} {dtype}: the model ranks of a "
                    f"data row differ")
        got = torch.from_numpy(np.concatenate(
            [np.load(os.path.join(tmp, f"{arch}-{dtype}-{d}.npy"))
             for d in range(MESH_SHAPE[0])], axis=1))
        ref = one[dtype]
        rels = [rel_l2(torch, a, b) for a, b in zip(got, ref["logits"])]
        bound = MESH_F32_REL_L2 if dtype == "float32" else LOGITS_REL_L2
        same_tokens = bool((got.argmax(-1).T
                            == ref["argmax"][:, :len(got)]).all())
        want = _mfam_launches(cfg, dtype == "bfloat16")
        for r in runs:
            check(r["prefill"]["launches"] == want,
                  f"mesh_families {arch} {dtype}: launches a prefill "
                  f"{r['prefill']['launches']}, expected {want}")
        steps = (f", {MFAM_GEN} steps max {max(rels[1:]):.4e}"
                 if len(rels) > 1 else "")
        log(f"mesh_families {arch} {dtype} against the one-process engine: "
            f"prefill logits rel L2 {rels[0]:.4e}{steps} (bound {bound}); "
            f"argmax identical at every position {same_tokens}; "
            f"model ranks bitwise alike "
            f"{same}; launches a rank a prefill {runs[0]['prefill']['launches']}"
            f", vocab-parallel lookups a prefill "
            f"{[r['prefill']['sharded'] for r in runs]}")
        check(max(rels) <= bound, f"mesh_families {arch} {dtype}: logits "
                                  f"rel L2 {max(rels)} > {bound}")
        if dtype == "float32":
            check(same_tokens, f"mesh_families {arch} float32: argmax "
                               f"differs from the one-process engine's")
        pre = [r["prefill_s"] for r in runs]
        dec = [r["decode_ms"] for r in runs]
        r0 = runs[0]
        how = ("the counted generate's wall less the prefill's, over its "
               "steps" if dtype == "bfloat16" else "teacher-forced")
        log(f"mesh_families {arch} {dtype} walls: prefill {max(pre):.4f} s "
            f"(max over the ranks; min {min(pre):.4f}) against one process "
            f"{ref['prefill_s']:.4f} s; decode {max(dec):.3f} ms a step "
            f"({how}) against {ref['decode_ms']:.3f} ms (teacher-forced; "
            f"both eager); the draw of "
            f"each rank's shards {max(r['draw_s'] for r in runs):.1f} s; "
            f"the table shard a rank {r0['table']}")
        step = (f"; a decode step: "
                f"{_coll_line(r0['decode']['coll'], MFAM_GEN)}"
                if "decode" in r0 else "")
        log(f"mesh_families {arch} {dtype} rank 0's collectives, prefill: "
            f"{_coll_line(r0['prefill']['coll'])}{step} (each waited for on "
            f"both sides, host clock; fsdp_gather: a weight's shard gathered "
            f"over data); every rank's, prefill: "
            f"{_coll_ranks(runs, 'prefill')}")
        peaks = [r["peak"] for r in runs]
        log(f"mesh_families {arch} {dtype} peak memory a rank "
            f"{[round(p / 2**30, 2) for p in peaks]} GiB, "
            f"{sum(peaks) / 1e9:.2f} GB in all; {_weights_line(runs)}")
    gen = [r["runs"][arch]["bfloat16"]["generate"] for r in ranks]
    toks = gen[0]["tokens"]
    want = _mfam_launches(cfg, True)
    check(toks.shape == (MFAM_BATCH, MFAM_GEN)
          and all(np.array_equal(g["tokens"], toks) for g in gen),
          f"mesh_families {arch}: generate's tokens differ across the ranks")
    check(all(g["launches"] == want for g in gen),
          f"mesh_families {arch}: the counted generate's launches "
          f"{[g['launches'] for g in gen]}, expected {want} a rank")
    wall = max(g["wall"] for g in gen)
    log(f"mesh_families {arch} the main path's counted run (bf16 generate, "
        f"counts 0 just before, read just after): launches a rank "
        f"{gen[0]['launches']} (flash on the bf16 tensor-core kernel, SSD "
        f"on ssd_tc.cu; {_head_shards(cfg)}), vocab-parallel lookups "
        f"{gen[0]['sharded']}; wall "
        f"{wall:.4f} s (max over the ranks), "
        f"{MFAM_BATCH * MFAM_GEN / wall:.1f} new tokens/s; tokens identical "
        f"on every rank")
    return [g["launches"] for g in gen]


def phase_mesh_families(torch, dev):
    """Phase mesh_families: ``ServeEngine(mesh=)`` on the SSM, hybrid, VLM
    and audio families (MFAM_RUNS: published widths, depths cut), 4 gloo
    ranks sharing the card on a (data 2, model 2) mesh, one spawn for the
    four models: each held to the one-process engine at the same depth,
    seed, prompts and extras (f32 logits within MESH_F32_REL_L2 and the
    same argmax at every position, bf16 within LOGITS_REL_L2); launches a
    rank by counter; walls, collectives and peaks a rank. Returns the
    counted runs' launches a rank, by counter, summed over the models."""
    from repro_torch.config import get_arch
    from repro_torch.launch import mesh as M
    t_phase = time.perf_counter()
    runs, one = [], {}
    for i, (arch, depth, prompt_len) in enumerate(MFAM_RUNS):
        cfg = _mfam_cfg(arch, depth, "float32")
        start, max_len = _mfam_sizes(cfg, prompt_len)
        prompts = np.random.default_rng(MFAM_SEED + i).integers(
            1, cfg.vocab_size, (MFAM_BATCH, prompt_len)).astype(np.int64)
        extras = family_extras(torch, dev, cfg, MFAM_BATCH, MFAM_SEED + i)
        log(f"mesh_families: {arch} at its published widths (d_model "
            f"{cfg.d_model}, vocab {cfg.vocab_size}), {cfg.n_layers} of "
            f"{get_arch(arch).n_layers} layers; {MFAM_BATCH} x {prompt_len} "
            f"prompt tokens (T = {MFAM_BATCH * prompt_len})"
            + "".join(f", {k} {tuple(v.shape)}" for k, v in extras.items())
            + f", {MFAM_GEN} new from position {start}, max_len {max_len}")
        t0 = time.perf_counter()
        o32 = _mfam_one(torch, dev, cfg, prompts, extras, start, max_len,
                        None)
        forced = o32["argmax"][:, :MFAM_GEN]
        o16 = _mfam_one(torch, dev, _mfam_cfg(arch, depth, "bfloat16"),
                        prompts, extras, start, max_len, forced.to(dev))
        one[arch] = {"float32": o32, "bfloat16": o16}
        runs.append(dict(arch=arch, depth=depth, cfg=cfg, prompts=prompts,
                         extras={k: v.float().cpu().numpy()
                                 for k, v in extras.items()},
                         forced=forced.numpy(), start=start,
                         max_len=max_len))
        log(f"mesh_families {arch}: the one-process engines "
            f"{time.perf_counter() - t0:.1f} s")
        del extras
    torch.cuda.empty_cache()
    log(f"mesh_families: mesh (data {MESH_SHAPE[0]}, model "
        f"{MESH_SHAPE[1]}), {MESH_SHAPE[0] * MESH_SHAPE[1]} gloo ranks on "
        f"the one card, one spawn for the four models")
    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = M.spawn(_mfam_rank, MESH_SHAPE[0] * MESH_SHAPE[1],
                        backend="gloo", args=(runs, tmp), timeout_s=900)
        spawn_s = time.perf_counter() - t0
        for run in runs:
            for r, counts in enumerate(_mfam_hold(torch, run, one[run["arch"]],
                                                  ranks, tmp)):
                for name, n in counts.items():
                    totals.setdefault(name, [0] * len(ranks))[r] += n
    for r in ranks:
        log(f"mesh_families rank {r['rank']} (data {r['data']}, model "
            f"{r['model']}) on {r['device']}: host-staged ops "
            f"{r['staged'] or 'none'}, staged bytes "
            f"{r['staged_bytes'] or 'none'}")
    log(f"mesh_families: the counted runs' launches a rank over the four "
        f"models {totals}; the ranks' spawn and run {spawn_s:.1f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return totals


# ---------------------------------------------------------------------------
# phase mesh_train: training on a (pod, data, model) process mesh
# ---------------------------------------------------------------------------

def _mtrain_cfg(part: str, shape, twin: bool = False, run=None):
    """(m1)'s or (m2)'s TrainConfig: ``run`` (an MTF_RUNS entry: arch,
    layers or None for all, ..., (n2)'s optimizer; None: phase mesh_train's
    phi3.5-moe at MTRAIN_DEPTH layers) at its published widths, f32
    activations and params, remat full, ``shape`` (sequences, tokens a
    sequence) a step, on its mesh, (m1) with AdamW and (m2) with sgd or
    the run's (the MTRAIN and MTF comments); ``twin`` the one-process
    twin's (no model axis)."""
    from repro_torch.config import (DataConfig, MeshConfig, OptimizerConfig,
                                    SyncConfig, TrainConfig, get_arch)
    from repro_torch.launch.mesh import mesh_config
    arch, depth = (MESH_ARCH, MTRAIN_DEPTH) if run is None else run[:2]
    model = get_arch(arch)
    model = dataclasses.replace(model, n_layers=depth or model.n_layers,
                                dtype="float32")
    optimizer = (OptimizerConfig(name="adamw", learning_rate=1e-4, eps=1e-6)
                 if part == "m1" or (run is not None and run[5] == "adamw")
                 else OptimizerConfig(name="sgd", learning_rate=0.1))
    data = DataConfig(seq_len=shape[1], global_batch=shape[0])
    if part == "m1":
        mesh = (MeshConfig() if twin
                else mesh_config(MTRAIN_M1_MESH, ("data", "model")))
        return TrainConfig(model=model, mesh=mesh,
                           sync=SyncConfig(strategy="sync_every_step"),
                           optimizer=optimizer, data=data, remat="full")
    mesh = (MeshConfig(shape=(2,), axis_names=("pod",), replica_axis="pod")
            if twin else mesh_config(MTRAIN_M2_MESH,
                                     ("pod", "data", "model")))
    return TrainConfig(
        model=model, mesh=mesh,
        sync=SyncConfig(strategy="periodic", period=MTRAIN_M2_H,
                        compression="int8"),
        optimizer=optimizer, data=data, remat="full")


def _mtrain_steps(part, run=None) -> int:
    """The steps (m1) or the blocks (m2) of a run (MTF_RUNS' entry, or
    None: phase mesh_train's)."""
    if part == "m1":
        return MTRAIN_M1_STEPS
    return MTRAIN_M2_BLOCKS if run is None else run[4]


def _take_grads(torch, out, norms: int, keep: int, p0: bool):
    """Wraps the trainers' optimizer step (``local_sgd.apply_updates_``,
    handed each step's reduced gradient) to record on the card, at its
    first ``norms`` calls, each gradient leaf's norm
    (``out["grad_norms"]``, one {key: 0-dim} a call), and at its first
    ``keep`` a copy of every gradient leaf (``out["grads"]``, one {key:
    tensor} a call), with the params before the first update
    (``out["p0"]``) where ``p0``. Returns the function that unwraps it."""
    from repro_torch import sharding as S
    from repro_torch.core import local_sgd as LS
    inner = LS.apply_updates_
    out.update(grad_norms=[], grads=[], p0=None)

    def take(opt_cfg, grads, opt, params, step, **kw):
        flat = S.flat_keys(grads)
        if len(out["grad_norms"]) < norms:
            out["grad_norms"].append({k: torch.linalg.vector_norm(g)
                                      for k, g in flat.items()})
        if len(out["grads"]) < keep:
            if p0 and out["p0"] is None:
                out["p0"] = {k: t.clone()
                             for k, t in S.flat_keys(params).items()}
            out["grads"].append({k: g.clone() for k, g in flat.items()})
        return inner(opt_cfg, grads, opt, params, step, **kw)
    LS.apply_updates_ = take
    return lambda: setattr(LS, "apply_updates_", inner)


def _mtrain_twin(torch, dev, part, shape, run=None):
    """The one-process twin of (m1) (``make_ddp_step`` under
    :class:`ShardedCapacity`) or (m2) (the K = 2 local-SGD block, its
    first sync's int8 payloads and scales kept on the host), the stub
    inputs seeded (:class:`SeededExtras`): losses, walls, peak, drops,
    the final params on the host (one replica), each gradient leaf's norm
    at each step of the first block (replica by replica under (m2)), and
    under (m2) with AdamW those gradients and the params they started
    from, on the host."""
    from repro_torch import sharding as S
    from repro_torch import tree as T
    from repro_torch.core import compression
    from repro_torch.launch.train import build_trainer
    cfg = _mtrain_cfg(part, shape, twin=True, run=run)
    _wait(torch, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step, state, make_pipeline, model, _, _ = build_trainer(cfg, dev)
    n = _mtrain_steps(part, run)
    with SeededExtras(MTF_SEED):
        pipe = make_pipeline(0)
        batches = [next(pipe) for _ in range(n)]
    out = dict(losses=[], aux=[], walls=[], payload=None)
    inner = compression.compress_tree
    if part == "m2":
        def capture(delta, ef, **kw):
            got = inner(delta, ef, **kw)
            if out["payload"] is None:
                out["payload"] = (
                    {k: q.cpu() for k, q in S.flat_keys(got[0]).items()},
                    {k: s.cpu() for k, s in S.flat_keys(got[1]).items()})
            return got
        compression.compress_tree = capture
    # the first block's optimizer steps: K = 2 replicas of H steps (m2)
    calls = 1 if part == "m1" else 2 * MTRAIN_M2_H
    untake = _take_grads(torch, out, calls, calls if (
        part == "m2" and cfg.optimizer.name == "adamw") else 0, p0=True)
    import contextlib
    try:
        with DropCounter() as drops, (ShardedCapacity() if part == "m1"
                                      else contextlib.nullcontext()):
            for b in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, batches[b])
                torch.cuda.synchronize()
                out["walls"].append(time.perf_counter() - t0)
                out["losses"].append(float(metrics["loss"]))
                if "aux" in metrics:
                    out["aux"].append(float(metrics["aux"]))
    finally:
        compression.compress_tree = inner
        untake()
    out["drops"] = drops.dropped
    out["peak"] = _peak(torch, dev)
    out["grad_norms"] = [{k: float(n) for k, n in x.items()}
                         for x in out["grad_norms"]]
    out["grads"] = [{k: g.cpu() for k, g in x.items()}
                    for x in out["grads"]]
    if out["p0"] is not None:
        out["p0"] = {k: t.cpu() for k, t in out["p0"].items()}
    params = state["params"]
    if part == "m2":
        params = T.map(lambda t: t[0], params)
    out["params"] = T.map(lambda t: t.to("cpu"), params)
    del state, params, step, batches, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mtrain_rank(jobs, tmp):
    """One rank of phase mesh_train's (m1) or (m2), or of phase
    mesh_train_families' runs: :func:`_mtrain_job` for each (part, shape,
    run) of ``jobs`` in turn, in the one world, every collective timed
    (:class:`CollectiveTimer`); the results in the jobs' order."""
    import torch
    t_start = time.time()
    _rank_setup(torch)
    timer = CollectiveTimer(torch)
    outs = []
    for part, shape, run in jobs:
        outs.append(_mtrain_job(torch, part, shape, run, tmp, timer,
                                t_start if not outs else time.time()))
        gc.collect()
        torch.cuda.empty_cache()
    return outs


def _mtrain_job(torch, part, shape, run, tmp, timer, t_start):
    """(m1) or (m2) on this rank: ``build_trainer`` on its mesh (each leaf
    drawn from the seed and its shard kept), the steps or blocks on the
    seeded stub inputs with every collective timed, the slots dropped and
    the paths taken, the sync's CUDA-event time, the quant launches of the
    counted run, the peak; (m2)'s first sync's int8 blocks and scales;
    each gradient leaf's block's norm at the first step, and under (m2)
    with AdamW the first block's gradient blocks;
    this rank's blocks of the final params (every rank of pod 0; rank 0
    also the whole leaves), with a digest of every block. Arrays go to
    ``tmp`` (one .npy each, named in the result): the parent maps them
    from the host's page cache, where a result through ``spawn``'s queue
    is pickled and copied three times."""
    from repro_torch import sharding as S
    from repro_torch.core import collectives as CL
    from repro_torch.core import compression
    from repro_torch.core import local_sgd as LS
    from repro_torch.core import sync as SY
    from repro_torch.kernels.quant import ops as quant_ops
    from repro_torch.launch import mesh as M
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import moe
    mesh_shape, axes = ((MTRAIN_M1_MESH, ("data", "model")) if part == "m1"
                        else (MTRAIN_M2_MESH, ("pod", "data", "model")))
    mesh = M.make_mesh(mesh_shape, axes)
    dev = mesh.device
    cfg = _mtrain_cfg(part, shape, run=run)
    CL.STAGED.clear()
    CL.STAGED_BYTES.clear()
    _wait(torch, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    step, state, make_pipeline, model, _, _ = build_trainer(cfg, dev, mesh)
    _wait(torch, dev)
    out = dict(rank=mesh.rank(), coords=S.coords_of(mesh),
               draw_s=time.perf_counter() - t0, losses=[], aux=[], walls=[],
               sync_ms=[], payload=None)
    specs = LS.rank_state_specs(model, cfg, mesh, state)["params"]
    n = _mtrain_steps(part, run)
    with SeededExtras(MTF_SEED):
        pipe = make_pipeline(0)
        batches = [next(pipe) for _ in range(n)]
    fsdp = set()
    if cfg.model.is_moe:
        e_loc = cfg.model.moe.num_experts // mesh.size("model")
        d_loc = cfg.model.d_model // mesh.size("data")
        fsdp = {(e_loc, d_loc, cfg.model.d_ff), (e_loc, cfg.model.d_ff,
                                                  d_loc)}
    inner_c, inner_s, events = compression.compress_tree, SY.sync_point, []
    name = part + ("" if run is None else "_" + run[0])

    def save(key, t):
        path = os.path.join(tmp, f"{name}_r{mesh.rank()}_{key}.npy")
        np.save(path, t.cpu().numpy())
        return path

    def capture(delta, ef, **kw):
        got = inner_c(delta, ef, **kw)
        if out["payload"] is None:
            out["payload"] = (
                {k: save(f"q_{k}", q[0]) for k, q in
                 S.flat_keys(got[0]).items()},
                {k: float(x[0]) for k, x in S.flat_keys(got[1]).items()})
        return got

    def timed_sync(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = inner_s(*args, **kw)
        end.record()
        events.append((start, end))
        return got
    compression.compress_tree, SY.sync_point = capture, timed_sync
    untake = _take_grads(torch, out, 1, MTRAIN_M2_H if (
        part == "m2" and cfg.optimizer.name == "adamw") else 0, p0=False)
    timer.take(fsdp)
    out["t_ready"] = time.time() - t_start
    try:
        with DropCounter() as drops:
            # the main path's counted run: the counts 0 just before
            quant_ops.LAUNCHES = quant_ops.AMAX_LAUNCHES = 0
            quant_ops.GIVEN_LAUNCHES = 0
            moe.PATHS.clear()
            for b in range(n):
                _wait(torch, dev)
                t0 = time.perf_counter()
                state, metrics = step(state, batches[b])
                _wait(torch, dev)
                out["walls"].append(time.perf_counter() - t0)
                out["losses"].append(float(metrics["loss"]))
                if "aux" in metrics:
                    out["aux"].append(float(metrics["aux"]))
            out["launches"] = dict(quant=quant_ops.LAUNCHES,
                                   amax=quant_ops.AMAX_LAUNCHES,
                                   given=quant_ops.GIVEN_LAUNCHES)
            out["paths"] = dict(moe.PATHS)
    finally:
        compression.compress_tree, SY.sync_point = inner_c, inner_s
        untake()
    out["t_steps"] = time.time() - t_start - out["t_ready"]
    out["grad_norms"] = {k: float(n) for k, n in out["grad_norms"][0].items()}
    out["grads"] = [{k: save(f"g{j}_{k}", g) for k, g in x.items()}
                    for j, x in enumerate(out["grads"])]
    out["drops"] = drops.dropped
    out["coll"] = timer.take(fsdp)
    out["sync_ms"] = [a.elapsed_time(b) for a, b in events]
    out["peak"] = _peak(torch, dev)
    flat, flat_specs = S.flat_keys(state["params"]), S.flat_keys(specs)
    out["n_leaves"] = len(flat)
    out["n_split"] = sum(1 for s in flat_specs.values() if any(s))
    # the params a rank holds (one replica's under (m2)) and the whole
    # model's, both f32
    out["weights"] = (sum(t.numel() * t.element_size()
                          for t in flat.values()),
                      sum(4 * math.prod(p.shape) for p in
                          S.flat_keys(model.param_defs()).values()))
    keep = part == "m1" or mesh.rank("pod") == 0
    out["blocks"] = {k: save(f"p_{k}", t[0] if part == "m2" else t)
                     for k, t in flat.items()
                     if keep and (any(flat_specs[k]) or mesh.rank() == 0)}
    out["block_digests"] = dict(zip(flat, _digests(torch,
                                                   list(flat.values()))))
    out["specs"] = {k: (tuple(s[1:]) if part == "m2" else s)
                    for k, s in flat_specs.items()}
    out["staged"] = dict(CL.STAGED)
    out["t_end"] = time.time() - t_start
    del state, step, batches
    return out


def _load_array(torch, dev, path):
    """A rank's array (its .npy, mapped from the page cache) on the card."""
    return torch.from_numpy(np.load(path, mmap_mode="r")).to(dev)


def _mtrain_hold(torch, dev, label, one, ranks, mesh_cfg):
    """(m1)/(m2)'s checks against the one-process twin: losses (and aux)
    within MTRAIN_REL; the final params, each rank's blocks against the
    same blocks of the twin's leaves (each block once, a whole leaf from
    rank 0), within relative L2 MTRAIN_REL over the whole tree; the ranks
    that hold one block bitwise alike. Returns (the worst loss rel, params
    rel L2)."""
    from repro_torch import sharding as S
    rel_loss = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["losses"], one["losses"]))
    check(rel_loss <= MTRAIN_REL, f"{label}: losses "
          f"{[r['losses'] for r in ranks]} against the twin's "
          f"{one['losses']}")
    if one["aux"]:
        rel_aux = max(abs(a - b) / abs(b) for r in ranks
                      for a, b in zip(r["aux"], one["aux"]))
        check(rel_aux <= MTRAIN_REL, f"{label}: aux "
              f"{[r['aux'] for r in ranks]} against {one['aux']}")
    want = S.flat_keys(one["params"])
    check(sorted(ranks[0]["specs"]) == sorted(want), f"{label}: "
          f"leaves {sorted(ranks[0]['specs'])} against {sorted(want)}")
    num = den = 0.0
    for key, w in want.items():
        w = w.to(dev)
        den += float(w.square().sum())
        spec = ranks[0]["specs"][key]
        for r in (ranks if any(spec) else ranks[:1]):
            if key in r["blocks"]:
                blk = S.block_of(w, spec, r["coords"], mesh_cfg)
                num += float((_load_array(torch, dev, r["blocks"][key])
                              - blk).square().sum())
        del w
    rel = (num / den) ** 0.5
    check(rel <= MTRAIN_REL, f"{label}: params rel L2 {rel}")
    by_block = {}
    for r in ranks:
        for key, spec in r["specs"].items():
            coord = tuple(r["coords"][a] for a in sorted(S.spec_axes(spec)))
            by_block.setdefault((key, coord), set()).add(
                r["block_digests"][key])
    check(all(len(d) == 1 for d in by_block.values()),
          f"{label}: ranks that hold one block differ")
    return rel_loss, rel


def _grad_norms_against_twin(label, one, ranks, part):
    """Each gradient leaf's norm at the first step (each replica's under
    (m2)) against the twin's: the ranks' blocks' norms put together (each
    block once) within MTRAIN_REL of the twin's plus 1e-6 of the whole
    tree's (a leaf below that is f32 noise beside the rest). A leaf summed
    over the wrong ranks, or
    divided by the wrong count, misses it by a factor of the mesh's. AdamW
    hides such a factor from the losses and the params (its update is
    lr·m̂/(√v̂ + eps) an element, whatever the gradient's scale). Returns
    (the largest |Δ| over its bound, the whole tree's norm relative to the
    twin's)."""
    from repro_torch import sharding as S
    step = MTRAIN_M2_H if part == "m2" else 1
    blocks = {}
    for r in ranks:
        pod = r["coords"]["pod"] if part == "m2" else 0
        for key, spec in r["specs"].items():
            coord = tuple(r["coords"][a] for a in sorted(S.spec_axes(spec)))
            blocks.setdefault((pod, key), {})[coord] = r["grad_norms"][key]
    worst, sq = 0.0, [0.0, 0.0]
    for (pod, key), got in sorted(blocks.items()):
        mesh_n = math.sqrt(sum(n * n for n in got.values()))
        twins = one["grad_norms"][pod * step]
        twin_n = twins[key]
        bound = MTRAIN_REL * twin_n + 1e-6 * math.sqrt(
            sum(n * n for n in twins.values()))
        check(abs(mesh_n - twin_n) <= bound,
              f"{label}: {key}'s gradient norm at the first step (replica "
              f"{pod}) {mesh_n} against the twin's {twin_n} (bound {bound})")
        worst = max(worst, abs(mesh_n - twin_n) / bound)
        sq[0] += mesh_n * mesh_n
        sq[1] += twin_n * twin_n
    return worst, abs(math.sqrt(sq[0]) / math.sqrt(sq[1]) - 1.0)


def _norms_line(worst, norm_rel):
    return (f"the first step's gradient norms a leaf within "
            f"{worst:.3f} of their bounds of the twin's (MTRAIN_REL and 1e-6 "
            f"of the tree's), the tree's rel {norm_rel:.3e}")


def _adamw_sum(opt, grads):
    """The sum of AdamW's updates lr·m̂/(√v̂ + eps) an element over steps of
    ``grads`` (one tensor a step, from zero moments, no weight decay, a
    constant lr), in f64: ``optim._leaf_update_``'s, exactly but for its
    f32 rounding."""
    m = v = u = 0.0
    for t, g in enumerate(grads, 1):
        g = g.double()
        m = opt.beta1 * m + (1 - opt.beta1) * g
        v = opt.beta2 * v + (1 - opt.beta2) * g * g
        u = u + opt.learning_rate * (m / (1 - opt.beta1 ** t)) / (
            (v / (1 - opt.beta2 ** t)).sqrt() + opt.eps)
    return u


def _payload_against_twin(torch, dev, ranks, twin, mesh_cfg, opt):
    """The ranks' first-sync int8 blocks and scales against the twin's
    (K, …) payload: int8 values that differ, the largest |dq|, the largest
    relative scale difference; whether the model ranks of a replica packed
    each leaf with one scale (the whole leaf's); and each value's allowance
    ``D`` in steps, past the one step that rounding gives. Under sgd ``D``
    is 0: the update is lr·g, and the gradients' last-bit differences move
    a value by a small share of a step. Under AdamW (``opt``) the update
    is lr·m̂/(√v̂ + eps) an element: where a gradient element is itself
    near its last bits (a sum that cancels) that difference moves the
    update by up to 2·lr a step. There ``D`` is what AdamW makes of the
    two gradients (the ranks' blocks of the first block's H steps and the
    twin's, :func:`_adamw_sum` of each), plus the f32 rounding of the
    updates and the params, over the rank's step, plus the two scales'
    difference (127 steps times it at most). A value may differ by
    1 + ``D`` steps (``over`` counts those past it), and the values that
    differ may number 1e-4 of them, as under sgd, plus Σ min(1, the
    predicted difference in steps) (``expected``: AdamW's normalization
    moves a value across a .5 boundary about as often as its predicted
    move is a share of a step; the rounding and the scales' difference are
    left to the 1e-4, as under sgd).
    Under AdamW also the gradient blocks' relative L2 against the twin's
    at each step (``grad_rel``) and the values whose ``D`` is a step or
    more (``loose``)."""
    from repro_torch import sharding as S
    twin_q, twin_s = twin["payload"]
    adamw = opt.name == "adamw"
    if adamw:
        assert not (opt.weight_decay or opt.grad_clip or opt.warmup_steps
                    or opt.schedule != "constant"), opt
    h = MTRAIN_M2_H
    differ = values = max_dq = over = loose = 0
    scale_rel = expected = 0.0
    grad_sq = np.zeros((2, h))
    for r in ranks:
        paths, scales = r["payload"]
        pod = r["coords"]["pod"]
        for key, path in paths.items():
            spec = ("pod",) + tuple(r["specs"][key])
            want = S.block_of(twin_q[key], spec, r["coords"],
                              mesh_cfg)[0].to(dev)
            dq = (_load_array(torch, dev, path).to(torch.int16)
                  - want.to(torch.int16)).abs()
            differ += int((dq > 0).sum())
            values += dq.numel()
            max_dq = max(max_dq, int(dq.max()))
            w = float(twin_s[key][pod])
            rel = abs(scales[key] - w) / abs(w)
            scale_rel = max(scale_rel, rel)
            allow = torch.zeros((), device=dev)
            if adamw:
                def block(t):
                    return S.block_of(t, spec[1:], r["coords"],
                                      mesh_cfg).to(dev)
                mine = [_load_array(torch, dev, x[key]) for x in r["grads"]]
                theirs = [block(x[key]) for x in
                          twin["grads"][pod * h:(pod + 1) * h]]
                for j, (a, b) in enumerate(zip(mine, theirs)):
                    grad_sq[0, j] += float((a.double() - b).square().sum())
                    grad_sq[1, j] += float(b.double().square().sum())
                lr = opt.learning_rate
                # each side's H steps round p to f32 (half its spacing at
                # |p| < |p0| + 2·H·lr a step) and its update (2^-20 lr)
                ulp = torch.exp2((torch.frexp(block(twin["p0"][key]).abs()
                                              + 2 * h * lr).exponent
                                  - 24).double())
                rounding = h * ulp + 2 * h * lr * 2.0 ** -20
                moved = (_adamw_sum(opt, mine) - _adamw_sum(opt, theirs)
                         ).abs() / scales[key]
                allow = moved + rounding / scales[key] + 127 * rel
                loose += int((allow >= 1).sum())
                expected += float(moved.clamp(max=1.0).sum())
                del mine, theirs, ulp, rounding, moved
            over += int((dq > 1 + allow).sum())
            del want, dq, allow
    one_scale = all(
        a["payload"][1] == b["payload"][1] for a in ranks for b in ranks
        if a["coords"]["pod"] == b["coords"]["pod"])
    grad_rel = ([float(x) for x in np.sqrt(grad_sq[0] / grad_sq[1])]
                if adamw else None)
    return dict(differ=differ, values=values, max_dq=max_dq, over=over,
                expected=expected, loose=loose, grad_rel=grad_rel,
                scale_rel=scale_rel, one_scale=one_scale)


def _quant_shard_rows(torch, dev, shape, others=()):
    """The shard path's quant entry points on the card: at small shapes,
    at ``others`` (more of the main path's blocks) and at ``shape`` (the
    main path's expert block), the amax and the pack
    given it bitwise the plain version's, a leaf packed block by block with
    the blocks' max amax bitwise the whole-leaf quantization (also a leaf
    of two main-path blocks, as (m2)'s two model ranks hold the expert
    tables); the main shape timed beside the plain version and a PyTorch
    call. Returns the kernels-line rows of ``quant_amax`` and
    ``quant_int8_given_amax``."""
    import warnings
    from repro_torch.kernels.quant import ops, ref
    from repro_torch.kernels.quant.ops import amax_work, quantize_work
    for i, rshape in enumerate([(4, 33, 7), (2, 1_000_003), (3, 1),
                                *others]):
        x = torch.from_numpy(np.random.default_rng(400 + i).normal(
            size=rshape).astype(np.float32)).to(dev)
        a = ops.amax(x, rows=True)
        check(torch.equal(a, ref.amax(x, rows=True)),
              f"quant shards {rshape}: amax differs from the plain version")
        got = ops.quantize_given_amax(x, a, rows=True, residual=True)
        want = ref.quantize_given_amax(x, a)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
              and torch.equal(got[2], x - ref.dequantize(*want)),
              f"quant shards {rshape}: the pack differs from the plain "
              f"version")
        # the leaf split in two along its last dim, each block on its own
        # amax maxed with the other's: the whole leaf's payload
        blocks = x.chunk(2, -1) if rshape[-1] > 1 else [x]
        whole = torch.stack([ops.amax(b.contiguous(), rows=True)
                             for b in blocks]).amax(0)
        parts = [ops.quantize_given_amax(b.contiguous(), whole, rows=True)
                 for b in blocks]
        wq, ws = ops.quantize(x, rows=True)
        check(torch.equal(torch.cat([p[0] for p in parts], -1), wq)
              and all(torch.equal(p[1], ws) for p in parts),
              f"quant shards {rshape}: the blocks' payloads are not the "
              f"whole leaf's")
    # a leaf of two main-path blocks, each packed with their maxed amax
    leaf = torch.randn((shape[0], 2 * shape[1]), device=dev,
                       generator=torch.Generator(dev).manual_seed(411))
    halves = [h.contiguous() for h in leaf.chunk(2, -1)]
    whole = torch.maximum(*[ops.amax(h, rows=True) for h in halves])
    wq, ws = ops.quantize(leaf, rows=True)
    for i, h in enumerate(halves):
        q, s = ops.quantize_given_amax(h, whole, rows=True)
        check(torch.equal(q, wq.narrow(1, i * shape[1], shape[1]))
              and torch.equal(s, ws), f"quant shards: block {i} of a "
              f"{tuple(leaf.shape)} leaf is not its block of the whole "
              f"leaf's payload")
    del leaf, halves, wq, q
    torch.cuda.empty_cache()
    rng = np.random.default_rng(410)
    sets = [(torch.from_numpy((rng.normal(size=shape) * 0.01)
                              .astype(np.float32)).to(dev),)]
    x = sets[0][0]
    numel = x.numel()
    a = ops.amax(x, rows=True)
    check(torch.equal(a, ref.amax(x, rows=True)),
          f"quant shards {shape}: amax differs from the plain version")
    q, s, res = ops.quantize_given_amax(x, a, rows=True, residual=True)
    qr, sr = ref.quantize_given_amax(x, a)
    deqr = ref.dequantize(qr, sr)
    check(torch.equal(q, qr) and torch.equal(s, sr)
          and torch.equal(res, x - deqr),
          f"quant shards {shape}: the pack differs from the plain version")
    err = float((ops.dequantize(q, s) - deqr).abs().max())
    del q, s, res, qr, sr, deqr
    amax_ms = device_ms(torch, lambda t: ops.amax(t, rows=True), sets)
    amax_plain = device_ms(torch, lambda t: ref.amax(t, rows=True), sets)
    amax_lib = event_ms(torch, lambda t: torch.linalg.vector_norm(
        t, float("inf")), (x,))
    pack_ms = device_ms(torch, lambda t: ops.quantize_given_amax(
        t, a, rows=True, residual=True), sets)

    def plain_pack(t):
        qq, ss = ref.quantize_given_amax(t, a)
        return qq, ss, t - ref.dequantize(qq, ss)
    pack_plain = device_ms(torch, plain_pack, sets)
    scale = float(ref.quantize_given_amax(x[:1, :1], a)[1][0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            pack_lib = event_ms(torch, lambda t: torch.quantize_per_tensor(
                t, scale, 0, torch.qint8), (x,))
        except (RuntimeError, NotImplementedError) as exc:
            log(f"quant shards: torch.quantize_per_tensor not available on "
                f"this card: {exc}")
            pack_lib = None
    amax_bound, amax_by = work_bound(amax_work(numel))
    pack_bound, pack_by = work_bound(quantize_work(numel, True))
    log(f"quant shards {shape} (the main path's expert block): amax and the "
        f"pack given it bitwise the plain version; amax kernel "
        f"{amax_ms * 1e3:.4f} us plain {amax_plain * 1e3:.4f} us "
        f"torch.linalg.vector_norm(inf) {amax_lib * 1e3:.4f} us bound "
        f"{amax_bound * 1e3:.4f} us ({amax_by}); pack+residual kernel "
        f"{pack_ms * 1e3:.4f} us plain {pack_plain * 1e3:.4f} us "
        f"torch.quantize_per_tensor "
        f"{'n/a' if pack_lib is None else f'{pack_lib * 1e3:.4f} us'} "
        f"bound {pack_bound * 1e3:.4f} us ({pack_by})")
    del sets, x, a
    torch.cuda.empty_cache()
    return (dict(max_abs_err=0.0, ms=amax_ms, plain_ms=amax_plain,
                 bound_ms=amax_bound, bound_by=amax_by, library_ms=amax_lib),
            dict(max_abs_err=err, ms=pack_ms, plain_ms=pack_plain,
                 bound_ms=pack_bound, bound_by=pack_by,
                 library_ms=pack_lib))


def _mtrain_log_ranks(label, unit, ranks, one, spawn_s, held_s):
    walls = np.array([r["walls"] for r in ranks]).max(0)
    log(f"{label} the ranks' {spawn_s:.1f} s: start-up (the "
        f"process, CUDA, gloo, the draw of the shards) "
        f"{max(r['t_ready'] for r in ranks):.1f} s, the {unit}s "
        f"{max(r['t_steps'] for r in ranks):.1f} s, the results written "
        f"and digested {max(r['t_end'] - r['t_ready'] - r['t_steps'] for r in ranks):.1f}"
        f" s (max over the ranks); the checks against the twin "
        f"{held_s:.1f} s")
    log(f"{label} walls: a {unit} {[round(float(w), 3) for w in walls]} s "
        f"(max over the ranks) against the twin's "
        f"{[round(w, 3) for w in one['walls']]} s; the draw of each rank's "
        f"shards {max(r['draw_s'] for r in ranks):.1f} s")
    log(f"{label} rank 0's collectives a {unit}: "
        f"{_coll_line(ranks[0]['coll'], len(one['walls']))} (each waited "
        f"for on both sides, host clock)")
    log(f"{label} {_weights_line(ranks)}, f32; the moments and the sync "
        f"state split as their params")
    peaks = [r["peak"] for r in ranks]
    log(f"{label} peak memory a rank "
        f"{[round(p / 2**30, 2) for p in peaks]} GiB, {sum(peaks) / 1e9:.2f} "
        f"GB in all; the twin {one['peak'] / 2**30:.2f} GiB; host-staged "
        f"ops a rank {[r['staged'] or 'none' for r in ranks]}")


def _mtrain_spawn(jobs, tmp):
    """The 4 ranks of ``jobs`` (:func:`_mtrain_rank`), their allocators
    growing segments in place (the four share the card's memory; set in
    their environment before they start); per rank its results in the
    jobs' order."""
    from repro_torch.launch import mesh as M
    key = "PYTORCH_CUDA_ALLOC_CONF"
    before = os.environ.get(key)
    os.environ[key] = "expandable_segments:True"
    try:
        return M.spawn(_mtrain_rank, 4, backend="gloo", args=(jobs, tmp),
                       timeout_s=900)
    finally:
        if before is None:
            del os.environ[key]
        else:
            os.environ[key] = before


def _lookup(cfg, tokens: int) -> str:
    """The mesh embedding path a DDP step of ``tokens`` takes."""
    from repro_torch.models.layers import SHARDED_MIN_TOKENS
    split = cfg.model.vocab_size % MTRAIN_M1_MESH[1] == 0
    return ("the vocab-parallel lookup"
            if split and tokens >= SHARDED_MIN_TOKENS else
            "the masked lookup" + ("" if split else
                                   " (the odd vocab whole over model)"))


def _mtrain_check_ddp(torch, dev, label, one, ranks, shape, run, twin_s,
                      spawn_s):
    """(m1)'s checks and log lines: the MoE's paths a rank, then
    :func:`_mtrain_hold` and :func:`_grad_norms_against_twin` against the
    twin."""
    cfg = _mtrain_cfg("m1", shape, run=run)
    rows, seq = shape
    t0 = time.perf_counter()
    # the MoE's all-to-all path a layer, forward and the remat's recompute
    paths = ({"sharded": 2 * cfg.model.n_layers * MTRAIN_M1_STEPS}
             if cfg.model.is_moe else {})
    for r in ranks:
        check(r["paths"] == paths, f"{label}: rank {r['rank']} paths "
              f"{r['paths']}, expected {paths}")
    rel_loss, rel = _mtrain_hold(torch, dev, label, one, ranks, cfg.mesh)
    worst, norm_rel = _grad_norms_against_twin(label, one, ranks, "m1")
    log(f"{label} DDP on (data {MTRAIN_M1_MESH[0]}, model "
        f"{MTRAIN_M1_MESH[1]}), {cfg.optimizer.name} lr "
        f"{cfg.optimizer.learning_rate}, {rows} x {seq} tokens a step (T = "
        f"{rows * seq}: {_lookup(cfg, rows * seq)}), {MTRAIN_M1_STEPS} "
        f"steps: losses {ranks[0]['losses']} against the one-process "
        f"twin's {one['losses']} (make_ddp_step"
        f"{' under the sharded capacity rule' if cfg.model.is_moe else ''}"
        f"), rel {rel_loss:.3e} (bound {MTRAIN_REL}); aux {ranks[0]['aux']} "
        f"against {one['aux']}; params rel L2 {rel:.3e} (bound "
        f"{MTRAIN_REL}); {_norms_line(worst, norm_rel)}; paths a rank "
        f"{ranks[0]['paths']}; slots dropped "
        f"{sum(r['drops'] for r in ranks)} over the ranks, the twin "
        f"{one['drops']}; twin {twin_s:.1f} s, the ranks' spawn and run "
        f"{spawn_s:.1f} s")
    _mtrain_log_ranks(label, "step", ranks, one, spawn_s,
                      time.perf_counter() - t0)


def _mtrain_check_local(torch, dev, label, one, ranks, shape, run, twin_s,
                        spawn_s):
    """(m2)'s checks and log lines: the MoE's paths and drops a rank, the
    first sync's payloads against the twin's (:func:`_payload_against_twin`),
    each gradient leaf's norm at the first step against the twin's
    (:func:`_grad_norms_against_twin`), the quant launches a rank
    (2 x leaves x blocks, the amax and the pack given it once a split
    leaf a block), :func:`_mtrain_hold`. Returns each rank's launches."""
    cfg = _mtrain_cfg("m2", shape, run=run)
    rows, seq = shape
    blocks = _mtrain_steps("m2", run)
    t0 = time.perf_counter()
    mesh_cfg = cfg.mesh
    paths = ({"onehot": 2 * cfg.model.n_layers * MTRAIN_M2_H * blocks}
             if cfg.model.is_moe else {})
    for r in ranks:
        check(r["paths"] == paths, f"{label}: rank {r['rank']} paths "
              f"{r['paths']}, expected {paths}")
    pay = _payload_against_twin(torch, dev, ranks, one, mesh_cfg,
                                cfg.optimizer)
    check(pay["one_scale"], f"{label}: the model ranks of a replica packed "
                            f"a leaf with different scales")
    check(pay["over"] == 0
          and pay["differ"] <= 1e-4 * pay["values"] + pay["expected"]
          and pay["scale_rel"] <= MTRAIN_REL
          and all(x <= MTRAIN_REL for x in pay["grad_rel"] or ()),
          f"{label}: the first sync's payloads against the twin's {pay}")
    worst, norm_rel = _grad_norms_against_twin(label, one, ranks, "m2")
    mesh_drops = sum(r["drops"] for r in ranks)
    check(mesh_drops == MTRAIN_M2_MESH[2] * one["drops"],
          f"{label}: slots dropped {mesh_drops}, expected the twin's "
          f"{one['drops']} on each of the {MTRAIN_M2_MESH[2]} model ranks")
    launches = [r["launches"] for r in ranks]
    for r in ranks:
        want = dict(quant=2 * r["n_leaves"] * blocks,
                    amax=r["n_split"] * blocks, given=r["n_split"] * blocks)
        check(r["launches"] == want, f"{label}: rank {r['rank']} quant "
              f"launches {r['launches']}, expected {want}")
    rel_loss, rel = _mtrain_hold(torch, dev, label, one, ranks, mesh_cfg)
    sync_ms = np.array([r["sync_ms"] for r in ranks]).max(0)
    split = sorted(k for k, s in ranks[0]["specs"].items() if any(s))
    log(f"{label} local SGD on (pod {MTRAIN_M2_MESH[0]}, data "
        f"{MTRAIN_M2_MESH[1]}, model {MTRAIN_M2_MESH[2]}), K = 2, H = "
        f"{MTRAIN_M2_H}, int8, {cfg.optimizer.name} lr "
        f"{cfg.optimizer.learning_rate}, {rows // 2} x {seq} tokens a "
        f"replica step, {blocks} blocks: losses "
        f"{ranks[0]['losses']} against the one-process K = 2 block's "
        f"{one['losses']}, rel {rel_loss:.3e} (bound {MTRAIN_REL}); params "
        f"rel L2 {rel:.3e} (bound {MTRAIN_REL}); the first sync's int8 "
        f"payloads: the {ranks[0]['n_leaves']} leaves' blocks packed with "
        f"one scale a leaf on a replica's model ranks (the blocks' amax "
        f"maxed; split leaves {split or 'none'}, the rest packed whole); "
        f"against the twin's (whose deltas differ in their last bits: the "
        f"mesh sums the gradient in another order) {pay['differ']} of "
        f"{pay['values']} int8 values differ (max |dq| {pay['max_dq']}; "
        f"allowed 1e-4 of them plus {pay['expected']:.1f}, past 1 + D "
        f"steps {pay['over']}"
        + (f"; AdamW: D a step or more at {pay['loose']} values, the "
           f"gradient blocks rel L2 "
           f"{[f'{x:.3e}' for x in pay['grad_rel']]} a step (bound "
           f"{MTRAIN_REL})" if pay["grad_rel"] else "")
        + f"), scales rel {pay['scale_rel']:.3e}; "
        f"{_norms_line(worst, norm_rel)}; quant launches a rank "
        f"{launches} (expected quant 2 x {ranks[0]['n_leaves']} leaves x "
        f"{blocks} blocks, amax and given {ranks[0]['n_split']} "
        f"split leaves x {blocks}); sync "
        f"{[round(float(x), 2) for x in sync_ms]} ms a block (CUDA events, "
        f"max over the ranks); slots dropped {mesh_drops} over the ranks, "
        f"the twin {one['drops']}; twin {twin_s:.1f} s, the ranks' spawn "
        f"and run {spawn_s:.1f} s")
    _mtrain_log_ranks(label, "block", ranks, one, spawn_s,
                      time.perf_counter() - t0)
    return launches


def _mtrain_jobs(torch, dev, jobs, label):
    """Each job's (part, shape, run) one-process twin, one after another on
    the card, then every job in one spawn of the 4 ranks, then each job's
    checks against its twin (``label(part, run)`` names it in the log).
    Returns (the twins' seconds, the spawn's, each job's quant launches a
    rank: (m2)'s, None for (m1))."""
    twins, twin_s = [], []
    for part, shape, run in jobs:
        t0 = time.perf_counter()
        twins.append(_mtrain_twin(torch, dev, part, shape, run))
        twin_s.append(time.perf_counter() - t0)
    launches = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = _mtrain_spawn(jobs, tmp)
        spawn_s = time.perf_counter() - t0
        for j, (part, shape, run) in enumerate(jobs):
            check_part = (_mtrain_check_ddp if part == "m1"
                          else _mtrain_check_local)
            launches.append(check_part(
                torch, dev, label(part, run), twins[j],
                [r[j] for r in ranks], shape, run, twin_s[j], spawn_s))
            twins[j] = None
    del ranks
    gc.collect()
    torch.cuda.empty_cache()
    return sum(twin_s), spawn_s, launches


def phase_mesh_train(torch, dev):
    """Phase mesh_train (the docstring, item 16): (m1) DDP on (data 2, model
    2) and (m2) local SGD on (pod 2, data 1, model 2), phi3.5-moe at its
    published widths, MTRAIN_DEPTH layer, the twins first, then both parts
    in one spawn of 4 gloo ranks on the card, each held to its one-process
    twin. Returns the kernels-line rows of the
    quant shard entry points with their launches in (m2)'s counted run."""
    from repro_torch.config import get_arch
    t_phase = time.perf_counter()
    free, total = torch.cuda.mem_get_info(dev)
    log(f"mesh_train: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free on "
        f"the card at the start, this process's allocator reserving "
        f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB")
    cfg = _mtrain_cfg("m1", MTRAIN_M1_SHAPE).model
    log(f"mesh_train: {cfg.name} at its published widths (d_model "
        f"{cfg.d_model}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), "
        f"{MTRAIN_DEPTH} of {get_arch(MESH_ARCH).n_layers} layers, f32, "
        f"remat full; 4 gloo ranks on the one card")
    launches = _mtrain_jobs(
        torch, dev, [("m1", MTRAIN_M1_SHAPE, None),
                     ("m2", MTRAIN_M2_SHAPE, None)],
        lambda part, _: f"mesh_train ({part})")[2][1]
    e_loc = cfg.moe.num_experts // MTRAIN_M2_MESH[2]
    # (m2)'s blocks a rank: an expert table's, and the query projection's
    # (its heads over model)
    wq = MTRAIN_DEPTH * cfg.d_model * cfg.n_heads * cfg.resolved_head_dim
    amax_row, given_row = _quant_shard_rows(
        torch, dev, (1, MTRAIN_DEPTH * e_loc * cfg.d_model * cfg.d_ff),
        [(1, wq // MTRAIN_M2_MESH[2])])
    amax_row["launches"] = sum(x["amax"] for x in launches)
    given_row["launches"] = sum(x["given"] for x in launches)
    log(f"mesh_train: phase {time.perf_counter() - t_phase:.1f} s")
    return amax_row, given_row


# ---------------------------------------------------------------------------
# phase mesh_train_families: training the SSM, hybrid, VLM and audio
# families on the (pod, data, model) process mesh
# ---------------------------------------------------------------------------

def phase_mesh_train_families(torch, dev):
    """Phase mesh_train_families (the docstring, item 17): mesh_train's
    (m1) and (m2), here (n1) and (n2), on each family of MTF_RUNS, the
    one-process twins first, then every part of every family in one spawn
    of 4 gloo ranks on the card, each held to its twin. Returns the quant
    launches (whole-leaf packs and dequantizes, amax, packs given it) over
    the ranks' counted runs."""
    from repro_torch.config import get_arch
    t_phase = time.perf_counter()
    free, total = torch.cuda.mem_get_info(dev)
    log(f"mesh_train_families: {free / 2**30:.2f} of {total / 2**30:.2f} "
        f"GiB free on the card at the start")
    jobs = []
    for run in MTF_RUNS:
        arch, depth, n1, n2 = run[:4]
        full = get_arch(arch)
        cfg = _mtrain_cfg("m1", n1, run=run).model
        extra = {"vlm": f", {cfg.num_image_tokens} seeded patch positions "
                        f"before the text",
                 "audio": f", {cfg.n_audio_frames} seeded frames a "
                          f"sequence"}.get(cfg.family, "")
        log(f"mesh_train_families: {arch} ({cfg.family}) at its published "
            f"widths (d_model {cfg.d_model}, vocab {cfg.vocab_size}), "
            f"{'all' if depth is None else depth} of {full.n_layers} layers"
            f"{extra}, f32, remat full")
        jobs += [("m1", n1, run)] + ([("m2", n2, run)] if n2 else [])
    twin_s, spawn_s, launches = _mtrain_jobs(
        torch, dev, jobs, lambda part, run: f"mesh_train_families "
        f"({'n1' if part == 'm1' else 'n2'}, {run[0]})")
    totals = {k: sum(x[k] for job in launches for x in job or ())
              for k in ("quant", "amax", "given")}
    log(f"mesh_train_families: quant launches over the ranks' counted runs "
        f"{totals}; twins {twin_s:.1f} s, the ranks' spawn and run "
        f"{spawn_s:.1f} s; phase {time.perf_counter() - t_phase:.1f} s")
    return totals


def probe_train_adamw(torch, dev):
    """``--probe-train-adamw``: phase mesh_train's (m1) and paligemma's
    (n1) of MTF_RUNS, both AdamW, on the 4 ranks alone (no twin): each
    run's losses, step wall, weight bytes and peak a rank, or the error it
    raised (out of memory)."""
    pali = next(r for r in MTF_RUNS if r[0] == "paligemma-3b")
    for shape, run in [(MTRAIN_M1_SHAPE, None), (pali[2], pali)]:
        label = (f"probe {MESH_ARCH if run is None else run[0]} (m1) adamw, "
                 f"{shape[0]} x {shape[1]} tokens")
        with tempfile.TemporaryDirectory() as tmp:
            try:
                ranks = [r[0] for r in _mtrain_spawn([("m1", shape, run)],
                                                     tmp)]
                peaks = [r["peak"] for r in ranks]
                log(f"{label}, the 4 ranks: losses "
                    f"{[r['losses'] for r in ranks]}, a step "
                    f"{max(r['walls'][0] for r in ranks):.3f} s (max over "
                    f"the ranks), {_weights_line(ranks)}; peak a rank "
                    f"{[round(p / 2**30, 2) for p in peaks]} GiB, "
                    f"{sum(peaks) / 1e9:.2f} GB in all")
            except Exception as exc:    # noqa: BLE001 - logged, the probe
                log(f"{label}, the 4 ranks: {type(exc).__name__}: "
                    f"{str(exc)[:400]}")
        gc.collect()
        torch.cuda.empty_cache()


def probe_vlm_t32k(torch, dev):
    """``--probe-vlm-t32k``: paligemma-3b's (n1) at each shape of
    VLM_PROBE_SHAPES, the one-process twin, then the 4 ranks (nothing held
    between them): each run's losses, step wall and peak, or the error it
    raised (out of memory)."""
    run = next(r for r in MTF_RUNS if r[0] == "paligemma-3b")
    for rows, seq in VLM_PROBE_SHAPES:
        label = (f"probe paligemma-3b (n1) adamw, {rows} x {seq} text "
                 f"tokens (T = {rows * seq})")
        try:
            one = _mtrain_twin(torch, dev, "m1", (rows, seq), run)
            log(f"{label}, the twin: losses {one['losses']}, a step "
                f"{one['walls']} s, peak {one['peak'] / 2**30:.2f} GiB")
        except torch.cuda.OutOfMemoryError as exc:
            log(f"{label}, the twin: out of memory: {str(exc)[:400]}")
        one = None
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            try:
                ranks = [r[0] for r in _mtrain_spawn(
                    [("m1", (rows, seq), run)], tmp)]
                peaks = [r["peak"] for r in ranks]
                log(f"{label}, the 4 ranks: losses "
                    f"{[r['losses'] for r in ranks]}, a step "
                    f"{max(r['walls'][0] for r in ranks):.3f} s (max over "
                    f"the ranks), peak a rank "
                    f"{[round(p / 2**30, 2) for p in peaks]} GiB, "
                    f"{sum(peaks) / 1e9:.2f} GB in all")
            except Exception as exc:    # noqa: BLE001 - logged, the probe
                log(f"{label}, the 4 ranks: {type(exc).__name__}: "
                    f"{str(exc)[:400]}")


# ---------------------------------------------------------------------------
# phase tooling: the roofline of whole calls, simsync on the card's times,
# the dry run
# ---------------------------------------------------------------------------

def simsync_digest(profile) -> str:
    """A digest of one profile's replay: the summary and Chrome trace of
    ``simulate`` at H = 8 over 512 steps, and its ``oracle_h``."""
    import hashlib
    from repro_torch import simsync
    res = simsync.simulate(profile, h=8, steps=512, seed=0,
                           record_timeline=True)
    doc = json.dumps([res.summary(), simsync.chrome_trace(res),
                      simsync.oracle_h(profile, steps=512)], sort_keys=True)
    return hashlib.sha256(doc.encode()).hexdigest()[:16]


def start_dryrun(out_dir):
    """``python -m repro_torch.launch.dryrun --all`` in the background, one
    worker a CPU core (on the meta device: no card), its output into
    ``out_dir``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    log_file = open(os.path.join(out_dir, "dryrun.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--workers", str(os.cpu_count() or 1), "--out", out_dir],
        cwd=REPO, env=env, stdout=log_file, stderr=subprocess.STDOUT,
        start_new_session=True)
    proc.log_file = log_file
    return proc


def stop_dryrun(proc) -> None:
    """Kill the dry run's process group (its pool's workers too) if it has
    not ended."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    proc.log_file.close()


def _tooling_roofline(card):
    """(t1): each counted call's work against its phase's measured wall."""
    from repro_torch.launch import roofline as R
    for name in ("dms", "prefill", "train"):
        got = _TOOLING[name]
        c = got["counter"]
        terms = R.compute_terms(c.cost(), total_devices=1,
                                model_flops=got["model_flops"])
        bound, wall = terms.bound_s(), got["wall"]
        peak_name, peak = got["peak"]
        mfu = R.mfu(got["model_flops"], wall, peak)
        records = {n: c.kernels.get(n, 0) for n in got["records"]}
        flops = ", ".join(f"{d} {n / 1e12:.4f} TFLOP"
                          for d, n in sorted(c.flops.items()))
        log(f"tooling (t1) {got['what']} [{card}]: products {flops} "
            f"(kernel records {c.kernel_flops / 1e12:.4f} of them), "
            f"{c.bytes / 1e9:.3f} GB moved ({c.kernel_bytes / 1e9:.3f} by "
            f"kernel records), {c.ops} aten ops counted, peak "
            f"{c.peak_bytes / 1e9:.3f} GB made inside; bound "
            f"{1e3 * bound:.4f} ms ({terms.dominant}: compute "
            f"{1e3 * terms.compute_s:.4f} ms, memory "
            f"{1e3 * terms.memory_s:.4f} ms) against the measured wall "
            f"{1e3 * wall:.4f} ms: share of the eager ops' bound "
            f"{bound / wall:.4f}; model "
            f"FLOPs {got['model_flops'] / 1e12:.4f} T, mfu {mfu:.5f} (at the "
            f"{peak_name} peak {peak / 1e12:.1f} TFLOP/s); kernel records "
            f"{records}, launches counted in its phase {got['records']}")
        if "meta" in got:
            m = got["meta"]()
            log(f"tooling (t1) {got['what']} on the meta device, as the dry "
                f"run counts it (model.prefill, no engine cache): products "
                f"{m.product_flops / 1e12:.4f} TFLOP, {m.bytes / 1e9:.3f} GB "
                f"moved; the card's count less it: "
                f"{(c.product_flops - m.product_flops) / 1e12:.4f} TFLOP, "
                f"{(c.bytes - m.bytes) / 1e9:.3f} GB (the engine zeroes and "
                f"writes its decode cache)")
        check(records == got["records"],
              f"tooling (t1) {name}: kernel records {records}, launches "
              f"{got['records']}")
        check(0 < bound < wall, f"tooling (t1) {name}: bound {bound} s "
              f"against wall {wall} s")


def _tooling_simsync(card):
    """(t2): uniform profiles of the card's measured T_step and T_sync (a
    one-card T_sync, and the 8 ranks' on the card, are latencies: no
    bytes term), each replayed: ``oracle_h``, ``choose_period``'s pick on
    the same inputs, the port's controller's trajectory; then the built-in
    profiles' digests against the CPU's."""
    from repro_torch import simsync
    from repro_torch.config import SyncConfig
    from repro_torch.core import autotune
    cfg = SyncConfig(strategy="periodic")
    for key, label in (("svm_timed", "one card, (b)"),
                       ("dist_timed", "8 ranks on the card, (d3)")):
        t = _TOOLING[key]
        hops = simsync.engine._latency_hops(cfg, t["k"])
        prof = simsync.uniform_profile(
            f"h100 {label}", t["k"], step_time=t["t_step"], jitter=0.0,
            bandwidth=float("inf"), latency=t["t_sync"] / hops,
            param_bytes=4 * t["d"])
        oracle = simsync.oracle_h(prof, cfg)
        pick = autotune.choose_period(
            autotune.TuneInputs(param_bytes_per_chip=4 * t["d"],
                                replicas=t["k"], step_time_s=t["t_step"]),
            dataclasses.replace(cfg, period=t["block"]),
            sync_time_override=t["t_sync"])
        ctrl = autotune.AdaptiveController(
            cfg, param_bytes_per_chip=4 * t["d"], replicas=t["k"],
            h0=t["block"], adapt_every=4)
        res, hist = simsync.simulate_adaptive(prof, cfg, ctrl, blocks=64)
        log(f"tooling (t2) simsync on {label} [{card}]: K={t['k']}, T_step "
            f"{1e6 * t['t_step']:.4f} us a point, T_sync "
            f"{1e6 * t['t_sync']:.4f} us a block (measured at block "
            f"{t['block']}); oracle_h {oracle}, choose_period picks {pick}, "
            f"the controller's trajectory from {t['block']}: {hist} "
            f"(simulated {res.per_step_s * 1e6:.4f} us a point, comm "
            f"{res.comm_fraction:.4f} of it)")
        check(oracle >= 1 and pick >= 1 and hist,
              f"tooling (t2) {label}: oracle {oracle}, pick {pick}")
    digests = {name: simsync_digest(p)
               for name, p in sorted(simsync.PROFILES.items())}
    log(f"tooling (t2) built-in profiles' digests (the reference's TPU-fabric "
        f"profiles, replayed here): {digests}")
    check(digests == SIMSYNC_DIGESTS,
          f"tooling (t2): digests {digests} differ from the CPU's "
          f"{SIMSYNC_DIGESTS}")


def _tooling_dryrun(proc, out_dir, t_start):
    """(t3): the background dry run's records: the count of ok / skip /
    error and each cell's fits_80g and bound; an error fails, and so does a
    dry run not ended by :data:`DRYRUN_DEADLINE_S` on the script's clock
    (``t_start``, main's start)."""
    t0 = time.perf_counter()
    budget = DRYRUN_DEADLINE_S - (t0 - t_start)
    try:
        proc.wait(timeout=max(1.0, budget))
    except subprocess.TimeoutExpired:
        stop_dryrun(proc)
        raise AssertionError(f"tooling (t3): the dry run had not ended at "
                             f"{DRYRUN_DEADLINE_S} s of the script "
                             f"({budget:.1f} s of waiting)")
    waited = time.perf_counter() - t0
    if proc.returncode != 0:
        with open(os.path.join(out_dir, "dryrun.log")) as f:
            log("tooling (t3) the dry run's log ends:\n"
                + "".join(f.readlines()[-40:]))
    records = []
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                records.append(json.load(f))
    counts = {st: sum(r["status"] == st for r in records)
              for st in ("ok", "skip", "error")}
    for r in records:
        if r["status"] == "ok":
            log(f"tooling (t3) [{r['mesh']}] {r['arch']} x {r['shape']}: "
                f"fits_80g {r['fits_80g']} "
                f"({r['resident_bytes_per_card'] / 1e9:.2f} GB a card), "
                f"{r['roofline']['dominant']}-bound, counted in "
                f"{r['count_s']} s")
        elif r["status"] == "error":
            log(f"tooling (t3) [{r['mesh']}] {r['arch']} x {r['shape']}: "
                f"ERROR {r['error'][:300]}")
    log(f"tooling (t3) dry run --all on the meta device: {counts['ok']} ok / "
        f"{counts['skip']} skip / {counts['error']} error over "
        f"{len(records)} cells; exit code {proc.returncode}; waited "
        f"{waited:.1f} s for it here")
    check(counts["error"] == 0 and proc.returncode == 0 and len(records) ==
          40 * 3, f"tooling (t3): {counts}, exit {proc.returncode}")


def phase_tooling(card, t_start):
    """(t1) the roofline of three measured calls, (t2) simsync calibrated
    on the card, (t3) the dry run of every cell: started first, in its own
    processes, and waited for last (nothing is timed meanwhile) until
    :data:`DRYRUN_DEADLINE_S` on the script's clock (from ``t_start``)."""
    with tempfile.TemporaryDirectory() as out_dir:
        dryrun = start_dryrun(out_dir)
        try:
            _tooling_roofline(card)
            _tooling_simsync(card)
            _tooling_dryrun(dryrun, out_dir, t_start)
        finally:
            stop_dryrun(dryrun)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    # the plain version's products run in full float32 on the card, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def done(phase):
        log(f"[{time.perf_counter() - t_start:.1f} s] {phase} done; "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")

    # --dist-only: the build and phase dist alone, and no result line
    dist_only = "--dist-only" in sys.argv[1:]
    card = phase_device(torch)
    done("build")
    if "--mesh-serve-only" in sys.argv[1:]:
        phase_mesh_serve(torch, dev)
        done("mesh_serve")
        phase_mesh_families(torch, dev)
        done("mesh_families")
        log("--mesh-serve-only: the other phases skipped, no result line")
        return 0
    if "--probe-train-adamw" in sys.argv[1:]:
        probe_train_adamw(torch, dev)
        log("--probe-train-adamw: the phases skipped, no result line")
        return 0
    if "--probe-vlm-t32k" in sys.argv[1:]:
        probe_vlm_t32k(torch, dev)
        log("--probe-vlm-t32k: the phases skipped, no result line")
        return 0
    if not dist_only:
        row = phase_kernel(torch, dev)
        launches, eps = phase_main(torch, dev)
        phase_svm_ladder(torch, dev, eps)
        del eps
        torch.cuda.empty_cache()
        phase_modes(torch, dev)
        done("SVM")
    with tempfile.TemporaryDirectory() as tmp:
        phase_dist(torch, dev, tmp)
    _HOST.clear()
    torch.cuda.empty_cache()
    done("dist")
    if dist_only:
        log("--dist-only: the later phases skipped, no result line")
        return 0
    flash_rows = phase_flash(torch, dev)
    done("flash")
    from repro_torch.config import get_arch
    flash_launches = phase_serve(
        torch, dev, get_arch("smollm-360m"), SERVE_BATCH, SERVE_PROMPT,
        SERVE_GEN, LOGITS_REL_L2, count_prefill=True)[0]["flash_attention_tc"]
    phase_prefill_f32(torch, dev, get_arch("smollm-360m"), SERVE_BATCH,
                      SERVE_PROMPT, SSM_F32_LOGITS_REL_L2)
    done("smollm serving")
    quant_row = phase_quant(torch, dev)
    from repro_torch.config import get_smoke
    train_model = dataclasses.replace(get_arch("smollm-360m"),
                                      n_layers=TRAIN_DEPTH)
    quant_launches = phase_train(torch, dev, train_model, TRAIN_SEQ,
                                 TRAIN_BATCH, TRAIN_K, TRAIN_H)
    phase_adaptive_train(torch, dev, train_model, TRAIN_SEQ, TRAIN_BATCH,
                         TRAIN_K)
    phase_fault_restart(torch, dev, get_smoke("smollm-360m"))
    phase_train_modes(torch, dev, get_smoke("smollm-360m"))
    done("quant and training")
    ssm_quant_launches = phase_train_ssm(torch, dev)
    log(f"train_ssm quant launches (t1, on the quant kernel): "
        f"{ssm_quant_launches}")
    done("train_ssm")
    family_quant_launches = phase_train_families(torch, dev)
    log(f"train_families quant launches (f1, on the quant kernel): "
        f"{family_quant_launches}")
    done("train_families")
    ssd_row = phase_ssd(torch, dev)
    ssd_launches = phase_serve(
        torch, dev, dataclasses.replace(get_arch("mamba2-2.7b"),
                                        n_layers=SSM_SERVE_DEPTH),
        SERVE_BATCH, SERVE_PROMPT,
        SERVE_GEN, None, SSM_F32_LOGITS_REL_L2,
        bf16_factor=SSM_BF16_VS_F32_FACTOR)[0]["ssd_tc"]
    # the f32 route's launches: zamba2's f32 prefill, the row's shape
    tc32_launches = phase_serve(
        torch, dev, dataclasses.replace(get_arch("zamba2-1.2b"),
                                        n_layers=HYBRID_SERVE_DEPTH),
        SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, None, SSM_F32_LOGITS_REL_L2,
        bf16_factor=SSM_BF16_VS_F32_FACTOR)[1]["flash_attention_tc32"]
    done("SSM and hybrid serving")
    t_families = time.perf_counter()
    family_launches = phase_families(torch, dev)
    log(f"families: flash launches a generate {family_launches}; phase "
        f"{time.perf_counter() - t_families:.1f} s")
    done("families")
    phase_mesh_serve(torch, dev)
    done("mesh_serve")
    mfam_launches = phase_mesh_families(torch, dev)
    done("mesh_families")
    amax_row, given_row = phase_mesh_train(torch, dev)
    done("mesh_train")
    mtf_launches = phase_mesh_train_families(torch, dev)
    done("mesh_train_families")
    t_tooling = time.perf_counter()
    phase_tooling(card, t_start)
    log(f"tooling: phase {time.perf_counter() - t_tooling:.1f} s")
    done("tooling")
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "hinge_block_grad", "route": "cuda",
        "source": "src/repro_torch/kernels/hinge/csrc/hinge_cluster.cu",
        "replaces": "src/repro/kernels/hinge/kernel.py:27",
        "launches": launches, "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_tc.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:32",
        "launches": flash_launches, **flash_rows["bf16"],
        "mesh_families_launches": mfam_launches["flash_attention_tc"]}, {
        "name": "flash_attention_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_tc32.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:32",
        "launches": tc32_launches, **flash_rows["f32"]}, {
        "name": "quant", "route": "cuda",
        "source": "src/repro_torch/kernels/quant/csrc/quant.cu",
        "replaces": "src/repro/kernels/quant/kernel.py:18",
        "launches": quant_launches, **quant_row,
        "mesh_train_families_launches": mtf_launches["quant"]}, {
        "name": "quant_amax", "route": "cuda",
        "source": "src/repro_torch/kernels/quant/csrc/quant.cu",
        "replaces": "src/repro/kernels/quant/ops.py:28",
        **amax_row, "mesh_train_families_launches": mtf_launches["amax"]}, {
        "name": "quant_int8_given_amax", "route": "cuda",
        "source": "src/repro_torch/kernels/quant/csrc/quant.cu",
        "replaces": "src/repro/kernels/quant/kernel.py:29",
        **given_row,
        "mesh_train_families_launches": mtf_launches["given"]}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_tc.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:32",
        "launches": ssd_launches, **ssd_row,
        "mesh_families_launches": mfam_launches["ssd_tc"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
