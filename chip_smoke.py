#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (``dmhomo_torch``) on one NVIDIA card.

  python3 chip_smoke.py [--seed 0]

Phases, each printing its results; any failure exits non-zero:

1. device: a CUDA card or fail; its name, count and power limit; TF32 off.
2. build: the window-attention kernels from ``dmhomo_torch/csrc/`` with nvcc
   for sm_90a; ptxas registers and spills and the dynamic shared memory of
   every instantiation (forward: dtype x head dim x mask; backward: dtype x
   head dim; the dbias reduction); then, in their machine code (cuobjdump's
   SASS), the tensor-core instructions of each (a bf16 one without any, or
   an fp32 one with any, fails) and the atomic instructions of the backward
   and its reduction (any one fails).
3. kernel vs plain: the kernel and its plain PyTorch version at every
   window-attention shape of the shipped HEM estimator (B=32), with and
   without the SW-MSA mask, fp32 and bf16: each shape's plan (the
   library's, logged; ``launch_plan`` must equal it), max abs error against the stated tolerance, and CUDA-event
   times of the kernel, the plain version and one
   ``scaled_dot_product_attention`` call (a yardstick only), beside the
   least time the card could take (bytes over 3.35 TB/s or flops over the
   dtype's peak); then the kernel at the training step's shapes (B=8, bf16,
   with and without the mask): error, its device time by torch.profiler
   (the calls' host time exceeds it at some of these shapes; CUDA events
   over the calls beside it) and bound, weighted by each shape's launches
   per step as phase 8 counts them.
4. slice: the shipped-config estimator with seeded random weights through
   ``eval_forward`` on 32 synthetic pairs (numpy, from ``--seed``): finite
   point errors, exactly 40 kernel launches per forward, batch time, pairs/s
   and peak memory.
5. card vs CPU: the same weights on 2 pairs at 320x576 on the card (kernel)
   and on the CPU (plain version): max abs difference of flows and masks.
6. profile: one ``eval_forward`` under ``torch.profiler``: device time by
   kernel, and the device's idle share of phase 4's unprofiled batch time.
7. backward kernel vs plain: the backward kernel and its plain PyTorch
   version at every window-attention shape of a training microbatch
   (B=8), with and without the mask, fp32 and bf16: max abs errors of dqkv
   and dbias against the stated tolerances, and CUDA-event times of the
   kernel, the plain backward and one yardstick (``torch.autograd.grad``
   through one ``scaled_dot_product_attention`` call whose additive bias
   requires grad; the backend's kernels are printed), beside the bound;
   each shape's plan as in phase 3.  Per step, each shape's time weighted
   by its launches as phase 8 counts them.
8. training slice: ``HEMTrainer`` at the shipped config (bf16, grad_accum
   4, B=32) on 32 synthetic 360x640 pairs (numpy, from ``--seed``): a few
   warm-up steps, then timed steps; the loss is finite and falls, exactly
   160 forward and 160 backward kernel launches per step, counted by shape
   (the weights of phases 3 and 7 per step); step ms, pairs/s and peak
   memory.
9. training card vs CPU: one fp32 step's loss and gradients (grad_accum 1,
   2 pairs at 320x576, the same weights, layer scales 0.5) on the card
   (kernels) and on the CPU (plain versions), each gradient held against
   the CPU's own change when the input moves by 1e-7.
10. training profile: one step under ``torch.profiler``: device time by
    kernel, and the idle share of phase 8's unprofiled step time.
8b. graph training slice: phase 8's trainer, from where phase 10 left it,
    on phase 8's batch: one eager step on the batch already on the card
    under ``torch.cuda.set_sync_debug_mode('error')`` (any host sync fails
    it); then ``HEMTrainer.train_steps``, one call per step (the first runs
    its step eagerly and captures the step as a CUDA graph; 2 more warm up;
    10 timed replays, host clock around ``synchronize()``), and one call of
    10 steps: step ms, pairs/s, peak memory (the graph's pool included); the
    launches per replay counted at capture must be phase 8's 160 + 160 (and
    its counts by shape), the wrappers' counters must not move on a replay,
    and a profiled replay must show as many device launches of each kernel,
    by name; its device busy time and idle share.
8c. graph vs eager: one fp32 step at the shipped shape (TF32 off) through
    ``train_steps`` (the first step eager, then one replay) against
    ``train_step`` from the same seed: losses within 1e-5 relative, weights
    within 2 lr, BatchNorm statistics within 1e-5 of their largest value;
    a second eager run beside them gives the eager step's own spread.
11. linear-attention build: registers, spills and dynamic shared memory of
    each variant of ``dmhomo_torch/csrc/linear_attention.cu`` (built in
    phase 2, in parallel with the window-attention source): the fp32
    CUDA-core kernels and the bf16 tensor-core kernels.
12. linear-attention kernels vs plain: pass 1, pass 2 and both together
    against their plain PyTorch versions at the 8 LinearAttention sites of
    the shipped UNet (B=50, the CFG-doubled batch of 25; prenorm folded;
    the UNet's NCHW layout), fp32 and bf16: errors against the stated
    tolerances, and CUDA-event times of each pass (the wrapper's call, its
    bf16 weight preparation included; the median of 5 bursts of 5 calls,
    with their spread), its plain version and one cuBLAS
    ``x @ W_qkv`` (a yardstick only: no one PyTorch call computes linear
    attention), beside each pass's bound and the share of it reached; in
    bf16 the launch plan of each pass (loader, heads per block, ring), and
    a failure if a site takes the element-wise loader.
13. generation slice: ``dgm_sample``'s generate step at its defaults (bf16,
    bs 25, 32 DDIM steps, CFG 3, 256x256, seeded random weights) on
    synthetic conditions (numpy, from ``--seed``): one warm-up batch, then 2
    timed ones; images finite and in [0, 1], exactly 8 + 8 kernel launches
    per UNet forward, none through the element-wise loader, fitted H within
    1e-2 px of the condition flow;
    samples/s, ms per batch and per DDIM step, peak memory.
14. generation card vs CPU: one fp32 CFG UNet forward at 256x256 (1
    condition, doubled) with the same weights on the card (kernels) and on
    the CPU (plain versions), held against the CPU's own change for an
    input nudged by 1e-7; ``fit_homography_to_flow`` of that condition on
    both.
15. generation profile: one DDIM step under ``torch.profiler``: device time
    by kernel, and the idle share of phase 13's unprofiled step.
16. whole-block kernel vs plain: registers, spills and dynamic shared memory
    of each variant of ``dmhomo_torch/csrc/swin_block.cu`` (built in phase
    2), and the tensor-core instructions (HMMA, HGMMA) in each forward
    instantiation's machine code (cuobjdump's SASS; a bf16 one without any,
    or an fp32 one with any, fails the phase); then the kernel and its plain
    PyTorch version at every Swin-block shape of the shipped estimator
    (B=32), with and without the shift and its mask, fp32 and bf16: each
    shape's ``forward_plan`` (logged), the library's shared memory and the
    blocks per SM the card's occupancy calculator gives, error against the
    stated tolerance, and CUDA-event
    times of the kernel, the plain version and the port's unfused
    ``SwinBlock`` on the card (window-attention kernel, cuBLAS, LayerNorm; a
    yardstick only: no one PyTorch call computes a Swin block), beside the
    bound.
17. whole-block slice: the shipped estimator with ``attn_impl='fused_block'``
    and phase 4's seeded weights through ``eval_forward`` on phase 4's 32
    pairs: finite point errors, exactly 40 whole-block launches and no
    window-attention launch per forward, batch time, pairs/s, peak memory
    and a profile; flows against phase 4's model, both with layer scales
    0.5.
18. whole-block card vs CPU: phase 5 for the ``fused_block`` model (layer
    scales 0.5).
19. whole-block backward vs plain: registers, spills and dynamic shared
    memory of each of the backward's five kernels in ``csrc/swin_block.cu``,
    and the atomic instructions in their machine code (cuobjdump's SASS of
    the library; any one fails the phase); then the backward (its five
    launches) and its plain PyTorch version at every Swin-block shape of a
    training microbatch (B=8), with and without the shift and its mask,
    fp32 and bf16: each shape's ``backward_plan`` (grids, windows or tokens
    per block, shared memory, blocks per SM, scratch, the replaced
    per-window kernel's atomics by its formula), errors of dx and the 13
    parameter gradients against the stated tolerance, and CUDA-event times
    of the backward, the plain backward and the port's unfused
    ``SwinBlock`` forward + backward on the card (a yardstick only), beside
    the bound.
20. whole-block training slice: ``HEMTrainer(HEMTrainConfig(attn_impl=
    'fused_block'))``, otherwise shipped (remat resolves on, as in JAX), on
    phase 8's batch: the loss is finite and falls; exactly 320 whole-block
    forward launches per step (160 forwards and their 160 remat recomputes),
    160 backward launches and no window-attention launch; step ms, pairs/s,
    peak memory, a profile (each backward kernel's device time), and the I/O
    dtype of each block in one forward; before the step, the whole-block
    forward's CUDA-event time at each of the step's shapes (B=8, at the
    step's dtypes); after it, the forward's and phase 19's backward's time
    per step, each shape weighted by the launches the wrappers counted for
    it in the timed steps (the rows must cover all 320 and 160), beside the
    forward's bound.
20b. phase 8b for phase 20's trainer (``fused_block``): 320 + 160
    whole-block launches per replay, none of the window kernels.
20c. phase 8c with ``attn_impl='fused_block'``.
21. whole-block training card vs CPU: phase 9 with ``attn_impl='fused_block'``.
22. DGM training slice: ``DGMTrainer(DGMTrainConfig())`` as shipped (bf16,
    global batch 128, 256x256, UNet dim 64, mults (1, 2, 4, 8), 5 classes,
    seeded random weights) on synthetic conditions made on the card before
    timing, with the fewest microbatches that fit (microbatch 32, then 16;
    remat only if neither fits): 3 warm-up steps, then 13 timed steps, the
    plain linear attention made to raise meanwhile; step ms, training
    samples/s, peak memory; exactly 8 (16 with remat) launches of each
    linear-attention kernel per microbatch; the loss finite, and lower
    after the timed steps than before on one held-out batch with fixed
    draws of (t, noise, keep-mask); the EMA after 16 steps equal to the
    weights after step 10 (decay 0 before step 100, an update every 10).
23. DGM training profile: one shipped step under ``torch.profiler``: device
    busy and the idle share of phase 22's unprofiled step, the top device
    ops, and the linear-attention forward kernels, the backward's ops (its
    profiler range), GroupNorm and the convolutions.
24. linear-attention backward vs plain: ``LinearAttentionFunction`` (the
    kernels forward, the explicit backward) at the UNet's 8 sites at phase
    22's microbatch, channel-major, prenorm, fp32 and bf16: the output
    (kernels 3 and 4 at the training shapes) against the plain version
    within LA_TOL, dx, dW and dg against ``torch.autograd.grad`` of the
    plain version (tolerances stated; in bf16 both beside their distance to the fp32 gradient at the
    same inputs), CUDA-event times of the backward (the median of 5 bursts)
    and of the plain version's autograd backward (a yardstick only: it is
    not on the training path) beside the backward's bound.
25. DGM training card vs CPU: one fp32 step of the full-width UNet at
    64x64, batch 4 in 2 microbatches, the same weights and injected draws
    on the card (kernels) and on the CPU (plain versions): the loss, each
    gradient held against the CPU's own change when the conditions move by
    1e-7, then the clipped Adam update and the EMA.
26. the data pipeline end to end, under a temporary directory in
    ``build/``: (a) ``make_conditions --synthetic 100`` on the card at
    360x640 -> 256 (the cache's shape, 20 per scene class; ms per condition
    of the CLI and of ``build_conditions`` alone; the card against the CPU
    on the same raw pairs: images and rgb_flow 1e-5, the mask exact, the
    flow 1e-4 px); (b) ``dgm_sample --conditions`` at its defaults, 4
    batches of 25, seeded random weights: 256 + 256 linear-attention
    launches per batch, none element-wise, the plain version made to raise,
    each fitted H within 1e-2 px of its condition's flow; (c)
    ``make_samples``: 100 files that ``HEMTrainDataset`` reads (its host
    pipeline against ``device_build_patches`` on one sample); (d)
    ``HEMTrainConfig()`` streamed from the files as ``hem_train --samples``
    streams it (4 worker threads, prefetch 2, pinned): ``train_steps`` with
    one loader batch per call, 3 warm-up then 10 timed steps; the loader
    alone with 0 and 4 workers; a profiled streamed step: idle share, 160 +
    160 window kernels per replay; a streamed step profiled in a fresh
    process (``--streamed-step-copies``): its host-to-device copies from
    pinned memory on a stream the window kernels do not run on; (e) ``hem_train
    --samples --steps 4 --fuse-steps 2`` writes its checkpoint.
27. data parallel (``dmhomo_torch/parallel/``), under a temporary directory
    in ``build/``: (a) the shipped HEM graph step (bf16, B=32) inside a
    one-rank ``nccl`` group, where the BatchNorm moments, the NLL counts and
    the gradient all-reduce all run: the all-reduces of an eager step and of
    the captured step (equal), 160 + 160 window launches per replay at
    capture and by name in a profiled replay, the NCCL kernels found there
    (a one-rank in-place all-reduce launches none), step ms with and
    without the group; one fp32 step as a graph and eagerly under the group
    and eagerly without it, within phase 8c's rule of each other; (b) 2
    ranks in child processes (``--dp-rank``), ``nccl`` with a card each
    when there are 2, else ``gloo`` with both on card 0 (printed): on each
    rank's rows of the global batch, one fp32 eager HEM step (B=32, 16 per
    rank, grad_accum 4) within phase 8c's rule of one process on the whole
    batch, 160 + 160 window launches per rank; one fp32 DGM step at phase
    25's shape with the same injected draws within phase 25's rule, 16 + 16
    linear-attention launches per rank (8 a microbatch); ``evaluate`` of
    half of 32 pairs per rank, merged, equal to one process's of all 32;
    only rank 0's checkpoint file; (c) with 2 cards, the shipped HEM graph
    step (B=32) and DGM step (128, microbatches of 32 per rank) over both
    against card 0 alone, the idle share per rank; on one card it says it
    did not run.
28. the HEM kernels at every window and width (the generic variants,
    ``csrc/window_attention_any.cu`` and ``csrc/swin_block_any.cu``, built
    in phase 2): (a) their registers and spills, no atomic instruction in
    their machine code; the window attention forward and backward against
    the plain versions at N = 1, 4, 16, 49, 144 and hd = 4, 6, 8, 12, 64,
    fp32 and bf16, +-mask (ATTN_TOL, BWD_TOL), the whole block forward and
    backward at windows 1, 2, 4, 7, 12, C = 8, 24, 96, 384 and MLPs of 2-4 C
    (SWIN_TOL, dx SWIN_DX_TOL in fp32; an fp32 gradient within SWIN_TOL or
    phase 9's rule, STEP_NOISE_FACTOR times the plain version's own change
    for its input nudged by STEP_INPUT_NOISE: at a 1x1 window dbias is a sum
    that cancels to 0), each plan the library's, a second
    run bit-identical, and the generic variant forced at a shipped shape
    against the tuned kernels; (b) ``hem_train --tiny --synthetic 64 --steps
    10`` in a child process under ``--attn auto`` and ``fused_block``, eager
    and ``--fuse-steps 5`` (the plain versions made to raise): exit 0,
    finite losses, a held batch's loss lower after than before, only generic
    launches (per replay too), a profiled step's kernels; (c) the shipped
    config with window 4 under both: ``eval_forward`` on phase 4's pairs (40
    generic launches a forward), its idle share, flows card vs CPU; the
    bf16 training step eager and as a graph (step ms, idle share, peak
    memory, launches per step and per replay); one fp32 step card vs CPU
    (phase 9's rule); (d) each generic kernel at every shape (c)'s paths
    gave it (the counters' keys), forward and backward, fp32 and bf16,
    against its plain version at (a)'s tolerances, reruns bit-identical;
    then the median of 5 bursts, its plain version, its yardstick (SDPA at
    N = 16; the unfused SwinBlock) and bound, per eval forward and per
    training step.  (b)'s children run beside (a).  ``--only-generic`` runs
    phases 1-2 and 28 alone.
29. kernels 3 and 4 at any heads / dim_head (the generic variant,
    ``csrc/linear_attention_any.cu``, built in phase 2) and the unconditional
    twin (``models/unet_uncond.py``, ``diffusion/uncond.py``): (a) the
    library's registers and spills, no atomic instruction in its machine
    code; the generic kernels against their plain versions over heads
    {1, 2, 3, 8, 16} x dim_head {8, 12, 24, 64, 128} (heads * dim_head <=
    1024), each twice (fp32 and bf16) with N in {256, 1024, 16384}, C in
    {64, 256, 512}, the three prenorm modes and both layouts cycling (LA_TOL),
    a rerun bit-identical, the backward through ``LinearAttentionFunction``
    against autograd of the plain version (LA_BWD_TOL); the generic variant
    forced at (4, 32) against the tuned kernels; (b) the twin as shipped
    (``UncondUNetConfig()``, ``UncondDiffusionConfig()``: dim 64, 128x128,
    fp32, 250 DDIM steps; seeded random weights, the final conv at
    UNCOND_OUT_SCALE): UNCOND_BS samples (finite, in [0, 1]; samples/s, ms
    per DDIM step, peak memory, the idle share of a profiled step), 8 + 8
    tuned launches per UNet forward and none of the plain version; 13 steps
    of loss + backward + Adam (step ms, peak; the loss on a held batch with
    fixed (t, noise) falls); one self-conditioned step; card vs CPU at
    64x64, full width: one fp32 forward and one loss with its gradients
    (phase 9's rule); (c) the same twin at attn (8, 64) with every launch
    generic, its forward card vs CPU; the conditional DGM UNet at (8, 64):
    one generation batch at ``dgm_sample``'s defaults (bf16) and 3
    ``DGMTrainer`` steps of the shipped config, every launch generic, one
    fp32 forward card vs CPU; (d) each generic kernel at the sites of (c)'s
    sampling paths (the twin B=16 fp32, the conditional B=50 bf16): errors,
    the median of 5 bursts, the plain version's time and the bound.
    ``--only-uncond`` runs phases 1-2 and 29 alone.
30. the rest of the DGM trainer, under a temporary directory in ``build/``:
    (a) the shipped ``DGMTrainConfig()`` (bf16, 128 in microbatches of 32)
    eagerly and as a CUDA graph (``train_steps``, one call per step: the
    first an eager step and the capture, then 3 warm-up and 10 timed
    replays): step ms of both, the idle share of a profiled replay, peak
    memory with the graph's pool, 32 + 32 linear-attention launches per
    replay (at capture and by name in the profile) and none generic or of
    the plain version; (b) phase 25's fp32 config at 64x64 with the
    shipped EMA rule: 3 steps eagerly (twice) and by ``train_steps`` from
    generators seeded alike, within phase 8c's rule (losses 1e-5 relative,
    weights 2 lr), the generators' offsets equal after them (each replay
    drew anew), then the graph on to 16 steps: its EMA equals its weights
    after step 10; (c) ``shard_params`` over (data 1, model 2) in child
    processes (``--shard-rank``; ``nccl`` with a card each when there are 2,
    else ``gloo`` on card 0): phase 25's fp32 step against one process
    under phase 25's rule, each rank's share of the sharded leaves'
    parameter, Adam and EMA elements (1/2), the checkpoint (one file)
    loaded back by the ranks and by one replicated trainer; with 2 cards
    the shipped step as a graph sharded over (1, 2) beside the replicated
    2-card step, with 4 also over (2, 2), and per-rank peak memory; (d)
    ``dgm_train --fuse-steps 5 --preview-every 5`` (10 steps) and then
    ``dgm_sample --ckpt <its root> --preview-every 1`` at a small config in
    child processes: exit 0, each preview PNG parses (signature, IHDR size,
    IDAT inflating to H * (1 + 3W) bytes), the logged photometric errors
    finite.  ``--only-dgm-steps`` runs phases 1-2 and 30 alone,
    ``--only-shard-params`` phases 1-2 and 30c.
31. the rest of the JAX package, under a temporary directory in ``build/``:
    (a) BasesHomo at full width (``models/baseshomo.py``: crop 320x576,
    layers (3, 4, 6, 3), 16 basis maps, seeded random weights, B=32, fp32
    with TF32 off): pairs/s (host clock around ``synchronize()``, the median
    of 3 after one), peak memory, the idle share within a profiled call's
    own span; card vs CPU stage by stage (B=2: the shared features, the
    stem with layers 1-3 end to end, layer 4 and conv_last, each Subspace
    stage with cond(V^T V) beside it; at random init V^T V is too
    ill-conditioned for a whole forward to compare) within BH_STAGE_TOL or
    BH_COND_TOL x cond; a reference-format state dict loaded ``strict``;
    (b) ``hem_eval --mask-vis`` in a child process (``--mask-vis-child``) on
    VIS_PAIRS PNG pairs at 360x640 whose videos fall in the five scene
    categories, the shipped estimator: 40 window-attention launches a
    forward, the files JAX's ``mask_vis_categories`` names, each JPEG from
    SOI to EOI, each GIF of 2 frames, loop 0, 50 cs; (c) phase 26's
    ``make_samples`` call with ``--warp-check``: a GIF per shard, parsed
    alike (with ``--only-rest``: two small random shards); (d) kernel 3's
    repair: 0 atomic instructions in the tuned library's machine code,
    K3_RERUNS calls per site and dtype bit-identical at the DGM training
    sites (B=32) and the generation sites (B=50), its bf16 time per
    generation batch and per DGM step beside the parent's (K3_OLD_MS).
    (b)'s child runs beside (a).  ``--only-rest`` runs phases 1-2 and 31
    alone.

The line before the last is a JSON object with the six kernels' numbers
(kernels 3 and 4 with their launches per DGM training step, eager and per
replay of the graph step, the HEM
kernels with their launches per replayed step, and under ``generic`` the
generic variants': the HEM kernels' at window 4, kernels 3 and 4 at the
twin's (8, 64) sites); the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

BATCH = 32  # the eval CLI's default batch; also the shipped training batch
MICROBATCH = 8  # the shipped grad_accum 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # CUDA-core fp32; dense bf16 tensor
ATTN_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# backward, relative to max(1, largest value): fp32 summation order (dbias
# is summed with atomics, in an order that changes from run to run); bf16
# a rounding of e, gg or dsim landing on the other side
BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# card (cuDNN / kernel summation order) vs CPU, through three coarse-to-fine
# levels, fp32 with TF32 off
SLICE_TOL = {"flow_f": 2e-3, "flow_b": 2e-3, "mask_f": 1e-4}
# one fp32 training step, card vs CPU: the loss (relative), and each
# gradient relative to that tensor's largest value: within STEP_GRAD_TOL, or
# within STEP_NOISE_FACTOR times the change the CPU's own gradient makes when
# the input moves by STEP_INPUT_NOISE (some gradients, such as the finest
# encoder's, sum many terms that nearly cancel: there a change in the last
# bit of an input moves them by ~1e-2)
STEP_LOSS_TOL = 1e-4
STEP_GRAD_TOL = 1e-3
STEP_INPUT_NOISE = 1e-7
STEP_NOISE_FACTOR = 10.0
WARMUP_STEPS, TIMED_STEPS = 3, 10
# DGM generation at dgm_sample's defaults: --bs 25 (CFG runs a doubled batch
# of 50), 32 DDIM steps, 256x256, bf16 activations
GEN_BS, GEN_STEPS, GEN_SIZE = 25, 32, 256
GEN_TIMED_BATCHES = 2
# linear-attention kernels vs plain, relative to the largest plain value
# (stricter than relative to max(1, |ref|): the outputs are far below 1):
# fp32 summation order (E and s are summed in the kernels' own fixed order);
# bf16 one rounding of q, k, v, e or the output landing on the other side
LA_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
FIT_TOL_PX = 1e-2  # fitted H vs the condition's own flow, fp32
# fp32 CFG UNet forward, card vs CPU, relative to the largest output: within
# GEN_CPU_TOL, or GEN_NOISE_FACTOR times the CPU's own change for an input
# moved by GEN_INPUT_NOISE; fit_homography_to_flow within FIT_CPU_TOL_PX
GEN_CPU_TOL = 1e-4
GEN_INPUT_NOISE = 1e-7
GEN_NOISE_FACTOR = 10.0
FIT_CPU_TOL_PX = 1e-3
# whole-block kernel vs plain, relative to max(1, largest |plain value|):
# fp32 summation order through five projections and the attention; bf16 a
# rounding of n1, qkv, e, the attention output, h, n2 or the GELU output
# landing on the other side.  The unfused block in fp32 (its own LayerNorm
# statistics and cuBLAS order) within SWIN_UNFUSED_TOL
SWIN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SWIN_UNFUSED_TOL = 1e-4
SWIN_DX_TOL = 1e-4  # the whole-block backward's fp32 dx, absolute
FUSED_FLOW_TOL_PX = 2e-3  # the fused_block estimator's flows vs phase 4's model
TIMING_BURSTS = 5  # per-site kernel times: the median of this many bursts of calls
# DGM training at DGMTrainConfig's shipped batch of 128: microbatches tried in
# this order, then the last with remat
DGM_MICROBATCHES = (32, 16)
DGM_WARMUP_STEPS, DGM_TIMED_STEPS = 3, 13
DGM_HELD_OUT = 32  # conditions of the held-out batch the loss is read on
# the linear-attention backward vs autograd of the plain version, relative to
# the largest plain gradient: fp32 summation order; bf16 the forward's LA_TOL:
# dW sums terms that largely cancel, so one rounding of qkv landing on the
# other side (the kernel computes the statistics in its own order) moves it
# by ~1e-2; each bf16 gradient is itself 1-2e-2 from the fp32 one
LA_BWD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# one fp32 DGM step, card vs CPU, at 64x64, batch 4 in 2 microbatches; the
# STEP_* rule of the HEM step; the parameters after Adam's first update
# within 2 lr (an element whose gradient is near zero may move the other way)
DGM_CPU_SIZE, DGM_CPU_BATCH, DGM_CPU_ACCUM = 64, 4, 2


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# synthetic CAHomo-like pairs (numpy only)
# ---------------------------------------------------------------------------


def _half_pixel_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) half-pixel bilinear resize matrix (cv2 INTER_LINEAR)."""
    M = np.zeros((n_out, n_in), np.float64)
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    M[np.arange(n_out), np.clip(lo, 0, n_in - 1)] += 1.0 - frac
    M[np.arange(n_out), np.clip(lo + 1, 0, n_in - 1)] += frac
    return M


def _resize(img: np.ndarray, out_hw) -> np.ndarray:
    Mh = _half_pixel_matrix(img.shape[0], out_hw[0])
    Mw = _half_pixel_matrix(img.shape[1], out_hw[1])
    y = np.tensordot(Mh, img, axes=(1, 0))  # (oh, w, c)
    return np.tensordot(Mw, y, axes=(1, 1)).transpose(1, 0, 2)


def _homography_4pt(h: int, w: int, off: np.ndarray) -> np.ndarray:
    """H mapping the image corners to corners + off, by an 8x8 DLT solve."""
    src = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], np.float64)
    dst = src + off
    A, b = [], []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b += [u, v]
    return np.append(np.linalg.solve(np.array(A), np.array(b)), 1.0).reshape(3, 3)


def _apply(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    p = np.concatenate([pts, np.ones_like(pts[..., :1])], -1) @ H.T
    return p[..., :2] / p[..., 2:]


def _sample_border(img: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Bilinear sample (H, W, C) at (h, w, 2) (x, y) positions, clamped."""
    Hh, Ww = img.shape[:2]
    x = np.clip(coords[..., 0], 0, Ww - 1)
    y = np.clip(coords[..., 1], 0, Hh - 1)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = np.minimum(x0 + 1, Ww - 1)
    y1 = np.minimum(y0 + 1, Hh - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    return ((1 - fx) * (1 - fy) * img[y0, x0] + fx * (1 - fy) * img[y0, x1]
            + (1 - fx) * fy * img[y1, x0] + fx * fy * img[y1, x1])


def make_pairs(n: int, ori_hw, crop_hw, seed: int, max_offset: float = 16.0):
    """n pairs of a smooth random texture and its warp by a random
    homography, as the eval loader gives them: normalized gray patches
    (n, ch, cw, 2) and 6 matched points per pair (n, 6, 2, 2) at ori_hw."""
    from dmhomo_torch.data.hem_data import normalize_gray

    rng = np.random.default_rng(seed)
    oh, ow = ori_hw
    grid = np.stack(np.meshgrid(np.arange(ow), np.arange(oh)), -1).astype(np.float64)
    patches, pts = [], []
    for _ in range(n):
        small = rng.uniform(0, 255, (oh // 8, ow // 8, 3))
        img1 = np.clip(_resize(small, ori_hw), 0, 255)
        H = _homography_4pt(oh, ow, rng.uniform(-max_offset, max_offset, (4, 2)))
        # a feature at x in img1 sits at H(x) in img2: img2(y) = img1(H^-1 y)
        img2 = _sample_border(img1, _apply(np.linalg.inv(H), grid))
        gray = [_resize(normalize_gray(im), crop_hw) for im in (img1, img2)]
        patches.append(np.concatenate(gray, -1))
        src = rng.uniform([32, 32], [ow - 32, oh - 32], (6, 2))
        pts.append(np.stack([src, _apply(H, src)], 1))
    return np.stack(patches).astype(np.float32), np.stack(pts).astype(np.float32)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def burst_ms(fn, iters: int, bursts: int = TIMING_BURSTS, warmup: int = 1):
    """(median, list) of the ms per call of ``bursts`` CUDA-event bursts of
    ``iters`` calls each: one slow burst does not move the median."""
    times = [cuda_ms(fn, iters, warmup=warmup if i == 0 else 0) for i in range(bursts)]
    return float(np.median(times)), times


def spread(times) -> str:
    return f"{min(times):.4f}-{max(times):.4f}"


def kernel_events(averages) -> list:
    """The device kernels and copies of a profile's ``key_averages()``,
    without the device spans of profiler ranges (``record_function``, the
    optimizer's step), which overlap the kernels inside them."""
    return [e for e in averages if e.device_type.name == "CUDA"
            and not getattr(e, "is_user_annotation", False)]


def profiled_ms(fn, iters: int, name_part: str) -> float:
    """Device time per call of the kernels whose name holds ``name_part``,
    by torch.profiler over ``iters`` calls after one warm-up: the kernel's
    own time where the calls' host time exceeds it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in kernel_events(prof.key_averages())
                if name_part in e.key)
    if total <= 0:
        raise SystemExit(f"the profiler saw no {name_part} kernel")
    return total / 1e3 / iters


def attention_shapes(model, batch: int):
    """Window-attention launch shapes of one estimator forward, from the
    model's Swin blocks: one entry per (encoder, sub-level) with its launch
    counts per forward (h_net runs twice)."""
    shapes = {}
    for enc, layer in enumerate(model.h_net.encoder_layers):
        sub = 0
        for m in layer.layer:
            if not hasattr(m, "attn"):  # PatchMerging closes a sub-level
                sub += 1
                continue
            H, W = m.resolution
            ws = m.window_size
            key = (enc, sub)
            s = shapes.setdefault(key, {
                "level": f"enc{enc} sub{sub}", "H": H, "W": W,
                "C": m.norm1.normalized_shape[0], "heads": m.attn.num_heads,
                "nW": (H // ws) * (W // ws), "ws": ws, "shift": ws // 2,
                "plain_launches": 0, "masked_launches": 0})
            s["hd"] = s["C"] // s["heads"]
            s["Bn"] = batch * s["nW"]
            s["masked_launches" if m.shift_size > 0 else "plain_launches"] += 2
    return list(shapes.values())


def bound(qkv, bias, mask, backward: bool = False):
    """(ms, 'bytes' | 'operations'): inputs read once, outputs written once.
    Forward: qkv in, out (C per token) out, two 64x64xhd products per window
    and head.  Backward: qkv and gout in, dqkv and the fp32 dbias out, six
    such products."""
    Bn, N, C3 = qkv.shape
    C = C3 // 3
    el = qkv.element_size()
    nbytes = (qkv.numel() * el + bias.numel() * 4
              + (mask.numel() * 4 if mask is not None else 0) + Bn * N * C * el)
    flops = 4.0 * Bn * N * N * C
    if backward:
        nbytes += qkv.numel() * el + bias.numel() * 4  # dqkv, dbias
        flops *= 3
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(qkv.dtype).split(".")[-1]]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs the port on the card")
    from dmhomo_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device={name} count={torch.cuda.device_count()} "
        f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return dev, name, smi


def phase_build():
    """Builds every kernel library at once (one nvcc per source, in
    parallel), then reports the window-attention one."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from dmhomo_torch.ops import linear_attention as la
    from dmhomo_torch.ops import swin_block as sb
    from dmhomo_torch.ops import window_attention as wa

    t0 = time.perf_counter()
    builds = (wa.build, la.build, sb.build, wa.build_generic, sb.build_generic, la.build_generic)
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = list(pool.map(lambda build: build(), builds))
    for lib in libs:
        log(f"[build] {os.path.relpath(lib)}: all built in {time.perf_counter() - t0:.1f} s")
    entry = None
    for line in wa.build_log().splitlines():
        key = wa.kernel_key(line)
        if key is not None or "window_attention_dbias_kernel" in line:
            # window_attention_fwd_kernel<T, HD, MASK>, the fp32 row kernel
            # window_attention_fwd_rows_kernel<HD, MASK>, window_attention_bwd_kernel<T,
            # HD> (the mask a runtime argument), window_attention_dbias_kernel
            if key is None:
                new = "dbias reduction"
            else:
                direction, dt, hd, mask = key
                new = f"{direction} {dt} hd={hd}" + ("" if mask is None else f" mask={int(mask)}")
            if new != entry:  # ptxas names each kernel on two lines
                if key is None:
                    smem = 0
                else:  # what the library asks for at this instantiation (shapes only)
                    smem = wa.library_plan(
                        torch.empty(1, 64, 3 * hd, dtype=getattr(torch, dt)), 1,
                        backward=direction == "bwd",
                        mask=torch.empty(1, 64, 64) if mask else None)["smem"]
                log(f"[build] {new}: {smem} bytes dynamic shared memory")
            entry = new
        elif entry and ("registers" in line or "spill" in line):
            log(f"[build] {entry}: {line.split(':', 1)[-1].strip()}")


def phase_window_sass():
    """Tensor-core instructions of every window-attention instantiation (a
    bf16 one without any, or an fp32 one with any, fails) and atomic
    instructions of every window-attention kernel, the backward's dbias
    reduction included (any one fails), in the library's machine code.
    Returns the tensor-core counts by instantiation and the atomic counts
    summed by kernel."""
    from dmhomo_torch.ops import window_attention as wa

    tc = wa.tensor_core_instructions()
    bad = []
    for (direction, dt, hd, mask), n in sorted(tc.items(), key=str):
        m = "" if mask is None else f" mask={int(mask)}"
        log(f"[build-sass] {direction} {dt} hd={hd}{m}: {n} tensor-core instructions")
        if (n > 0) != (dt == "bfloat16"):
            bad.append((direction, dt, hd, mask, n))
    atomics = wa.atomic_instructions_by_kernel()
    for name, n in atomics.items():
        log(f"[build-sass] {name[:90]}: {n} atomic instructions")
    if bad or any(atomics.values()):
        raise SystemExit(f"window-attention machine code: tensor cores where they should not be "
                         f"or missing {bad}; atomics {atomics}")
    by_kernel = {}
    for name, n in atomics.items():
        kernel = re.search(r"window_attention_(?:fwd_rows|fwd|bwd|dbias)_kernel", name).group(0)
        by_kernel[kernel] = by_kernel.get(kernel, 0) + n
    return ({f"{d} {dt} hd={hd}" + ("" if mk is None else f" mask={int(mk)}"): n
             for (d, dt, hd, mk), n in tc.items()}, by_kernel)


def checked_plan(qkv, heads, mask, backward: bool) -> dict:
    """The library's plan of a window-attention launch (what it launches
    with); fails unless ``launch_plan`` gives the same, key for key."""
    from dmhomo_torch.ops.window_attention import launch_plan, library_plan

    got = library_plan(qkv, heads, backward, mask)
    want = launch_plan(qkv, heads, backward, mask)
    if got != want:
        raise SystemExit(f"window-attention plan {want} is not the library's {got}")
    return got


def plan_text(p: dict) -> str:
    """One window-attention launch plan, for the log."""
    return " ".join(f"{k}={v}" for k, v in p.items())


def phase_kernels(shapes, dev, seed: int, step_shapes):
    import torch
    import torch.nn.functional as F

    from dmhomo_torch.models.swin import shifted_window_mask
    from dmhomo_torch.ops.window_attention import window_attention, window_attention_reference

    gen = torch.Generator(device=dev).manual_seed(seed)
    results = []
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for s in shapes:
        Bn, C, h, hd, nW = s["Bn"], s["C"], s["heads"], s["hd"], s["nW"]
        qkv32 = torch.randn(Bn, 64, 3 * C, generator=gen, device=dev)
        bias = 0.5 * torch.randn(h, 64, 64, generator=gen, device=dev)
        mask_np = shifted_window_mask(s["H"], s["W"], s["ws"], s["shift"])
        mask_full = torch.from_numpy(mask_np).to(dev)
        for dtype in ("float32", "bfloat16"):
            qkv = qkv32.to(getattr(torch, dtype))
            for masked in (False, True):
                mask = mask_full if masked else None
                kw = dict(num_heads=h)
                log(f"[plan] fwd {s['level']} Bn={Bn} {dtype} mask={int(masked)}: "
                    f"{plan_text(checked_plan(qkv, h, mask, False))} (launch_plan = library)")
                got = window_attention(qkv, bias, mask, **kw)
                want = window_attention_reference(qkv, bias, mask, **kw)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                ok = err <= ATTN_TOL[dtype] and bool(torch.isfinite(got).all())
                worst[dtype] = max(worst[dtype], err)
                # yardstick: one SDPA call on the same q, k, v and additive mask
                q, k, v = qkv.view(Bn, 64, 3, h, hd).permute(2, 0, 3, 1, 4).unbind(0)
                am = bias[None] if mask is None else (bias[None] + mask[:, None]).repeat(
                    Bn // nW, 1, 1, 1)
                am = am.to(qkv.dtype)
                ms = cuda_ms(lambda: window_attention(qkv, bias, mask, **kw), iters=20)
                plain_ms = cuda_ms(lambda: window_attention_reference(qkv, bias, mask, **kw),
                                   iters=5)
                lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=am, scale=hd**-0.5), iters=10)
                b_ms, b_by = bound(qkv, bias, mask)
                r = {"level": s["level"], "Bn": Bn, "C": C, "heads": h, "hd": hd, "nW": nW,
                     "dtype": dtype, "mask": masked,
                     "launches_per_forward": s["masked_launches" if masked else "plain_launches"],
                     "max_abs_err": err, "tol": ATTN_TOL[dtype], "ms": ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                     "bound_by": b_by}
                results.append(r)
                log(f"[kernel] {s['level']} C={C} h={h} hd={hd} nW={nW} Bn={Bn} {dtype} "
                    f"mask={int(masked)}: err={err:.3g} (tol {ATTN_TOL[dtype]:g}) "
                    f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                    f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"kernel disagrees with its plain version: {r}")
                del q, k, v, am
        del qkv32, qkv
        torch.cuda.empty_cache()
    # the training step's forward launches: B=8, bf16 (autocast hands the
    # kernel bf16 qkv at every shape), four microbatches a step
    step_rows = []
    for s in step_shapes:
        Bn, C, h, nW = s["Bn"], s["C"], s["heads"], s["nW"]
        qkv = torch.randn(Bn, 64, 3 * C, generator=gen, device=dev).to(torch.bfloat16)
        bias = 0.5 * torch.randn(h, 64, 64, generator=gen, device=dev)
        mask_full = torch.from_numpy(
            shifted_window_mask(s["H"], s["W"], s["ws"], s["shift"])).to(dev)
        for masked in (False, True):
            mask = mask_full if masked else None
            kw = dict(num_heads=h)
            plan = checked_plan(qkv, h, mask, False)
            got = window_attention(qkv, bias, mask, **kw)
            want = window_attention_reference(qkv, bias, mask, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ok = err <= ATTN_TOL["bfloat16"] and bool(torch.isfinite(got).all())
            worst["bfloat16"] = max(worst["bfloat16"], err)
            # at B=8 a call's host time can exceed the kernel's: the kernel's own
            # time from the profiler, the calls' rate from CUDA events beside it
            call = lambda: window_attention(qkv, bias, mask, **kw)  # noqa: E731
            ms = profiled_ms(call, 20, "window_attention_fwd")
            event_ms = cuda_ms(call, iters=20)
            b_ms, b_by = bound(qkv, bias, mask)
            # launches_per_step: counted in phase 8's timed steps
            r = {"level": s["level"], "Bn": Bn, "C": C, "heads": h, "hd": s["hd"], "nW": nW,
                 "dtype": "bfloat16", "mask": masked, "max_abs_err": err,
                 "tol": ATTN_TOL["bfloat16"], "ms": ms, "event_ms": event_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "plan": plan}
            step_rows.append(r)
            log(f"[kernel-step] {s['level']} C={C} h={h} hd={s['hd']} Bn={Bn} bfloat16 "
                f"mask={int(masked)}: err={err:.3g} (tol {ATTN_TOL['bfloat16']:g}) ms={ms:.4f} "
                f"(profiled; CUDA events over the calls {event_ms:.4f}) bound_ms={b_ms:.4f} "
                f"({b_by}); library plan {plan_text(plan)} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"kernel disagrees with its plain version: {r}")
        del qkv, got, want
        torch.cuda.empty_cache()
    return results, worst, step_rows


def eval_pairs(cfg, dev, batch: int, seed: int):
    """The eval slice's synthetic pairs, on the card: (patch, pts)."""
    import torch

    t0 = time.perf_counter()
    patch_np, pts_np = make_pairs(batch, cfg.ori_size, cfg.crop_size, seed)
    log(f"[slice] {batch} synthetic pairs {patch_np.shape} in {time.perf_counter() - t0:.1f} s")
    return torch.from_numpy(patch_np).to(dev), torch.from_numpy(pts_np).to(dev)


def phase_slice(model, pairs, counters: dict, tag: str = "slice", reps: int = 3):
    """``eval_forward`` once, then ``reps`` timed runs; each counter of
    ``counters`` (name -> wrapper with a ``launches`` count) is set to 0 just
    before and read just after.  Returns (launches by name, forwards,
    point errors, batch ms, peak bytes)."""
    import torch

    from dmhomo_torch.cli.hem_eval import eval_forward

    cfg = model.config
    patch, pts = pairs
    batch = patch.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for fn in counters.values():  # count the main path only
        fn.launches = 0
    t0 = time.perf_counter()
    err = eval_forward(model, patch, pts, cfg.ori_size)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        eval_forward(model, patch, pts, cfg.ori_size)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    launches = {name: fn.launches for name, fn in counters.items()}
    forwards = 1 + reps

    err = err.cpu().numpy()
    if err.shape != (batch,) or not np.isfinite(err).all():
        raise SystemExit(f"point errors not finite of shape ({batch},): {err}")
    peak = torch.cuda.max_memory_allocated()
    batch_ms = float(np.median(times))
    log(f"[{tag}] eval_forward B={batch} {cfg.crop_size}->{cfg.ori_size}: first {first_ms:.1f} ms, "
        f"steady {batch_ms:.2f} ms (runs {', '.join(f'{t:.2f}' for t in times)}), "
        f"{1e3 * batch / batch_ms:.2f} pairs/s, peak {peak / 2**30:.2f} GiB")
    log(f"[{tag}] point errors: mean {err.mean():.4f} px, min {err.min():.4f}, "
        f"max {err.max():.4f} (random weights)")
    for name, n in launches.items():
        log(f"[{tag}] {name} launches: {n} over {forwards} forwards = {n / forwards:g} per forward")
    return launches, forwards, err, batch_ms, peak


def phase_card_vs_cpu(model, seed: int, tag: str = "card-vs-cpu"):
    import copy

    import torch

    cfg = model.config
    patch_np, _ = make_pairs(2, cfg.ori_size, cfg.crop_size, seed + 1)
    cpu_model = copy.deepcopy(model).to("cpu")
    with torch.inference_mode():
        gpu = model(torch.from_numpy(patch_np).to(next(model.parameters()).device))
        cpu = cpu_model(torch.from_numpy(patch_np))
    diffs = {}
    for key, tol in SLICE_TOL.items():
        d = float((gpu[key].cpu() - cpu[key]).abs().max())
        diffs[key] = d
        log(f"[{tag}] {key} {tuple(cpu[key].shape)}: max |card - cpu| = {d:.3g} "
            f"(tol {tol:g}), max |value| {float(cpu[key].abs().max()):.3g}")
        if not d <= tol:
            raise SystemExit(f"card and CPU forwards disagree on {key}: {d} > {tol}")
    return diffs


def phase_profile(model, pairs, batch_ms: float, tag: str = "profile"):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dmhomo_torch.cli.hem_eval import eval_forward

    cfg = model.config
    patch, pts = pairs
    eval_forward(model, patch, pts, cfg.ori_size)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eval_forward(model, patch, pts, cfg.ori_size)
        torch.cuda.synchronize()
    events = kernel_events(prof.key_averages())
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if dev_ms <= 0:
        raise SystemExit("the profiler saw no device time")
    # the profiler slows the host, so the idle share is taken against the
    # unprofiled batch time of phase 4
    idle = max(0.0, 1.0 - dev_ms / batch_ms)
    log(f"[{tag}] one forward: device busy {dev_ms:.2f} ms of the {batch_ms:.2f} ms "
        f"unprofiled batch: idle {100 * idle:.1f}%")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"[{tag}] {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return dev_ms, idle


def sdpa_kernels(fn) -> str:
    """The device kernels one call of ``fn`` runs, by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = kernel_events(prof.key_averages())
    events.sort(key=lambda e: -e.self_device_time_total)
    return "; ".join(e.key[:80] for e in events[:3])


def phase_backward_kernels(shapes, dev, seed: int):
    import torch
    import torch.nn.functional as F

    from dmhomo_torch.models.swin import shifted_window_mask
    from dmhomo_torch.ops.window_attention import (
        window_attention_backward,
        window_attention_backward_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    results = []
    worst = {}
    backend = None
    for s in shapes:
        Bn, C, h, hd, nW = s["Bn"], s["C"], s["heads"], s["hd"], s["nW"]
        qkv32 = torch.randn(Bn, 64, 3 * C, generator=gen, device=dev)
        gout32 = torch.randn(Bn, 64, C, generator=gen, device=dev)
        bias = 0.5 * torch.randn(h, 64, 64, generator=gen, device=dev)
        mask_full = torch.from_numpy(
            shifted_window_mask(s["H"], s["W"], s["ws"], s["shift"])).to(dev)
        for dtype in ("float32", "bfloat16"):
            qkv = qkv32.to(getattr(torch, dtype))
            gout = gout32.to(qkv.dtype)
            for masked in (False, True):
                mask = mask_full if masked else None
                args = (qkv, bias, mask, gout)
                kw = dict(num_heads=h)
                plan = checked_plan(qkv, h, mask, True)
                log(f"[plan] bwd {s['level']} Bn={Bn} {dtype} mask={int(masked)}: "
                    f"{plan_text(plan)} (launch_plan = library)")
                dqkv, dbias = window_attention_backward(*args, **kw)
                want_dqkv, want_dbias = window_attention_backward_reference(*args, **kw)
                torch.cuda.synchronize()
                errs = {}
                for name, got, want in (("dqkv", dqkv, want_dqkv), ("dbias", dbias, want_dbias)):
                    err = float((got.float() - want.float()).abs().max())
                    errs[name] = err
                    errs[name + "_rel"] = err / max(1.0, float(want.float().abs().max()))
                    key = (dtype, name)
                    worst[key] = max(worst.get(key, 0.0), err)
                ok = (max(errs["dqkv_rel"], errs["dbias_rel"]) <= BWD_TOL[dtype]
                      and bool(torch.isfinite(dqkv).all()) and bool(torch.isfinite(dbias).all()))
                # yardstick: one SDPA call, forward and backward, on the same q, k, v,
                # with the additive bias (+ mask) as a full tensor that requires grad
                q, k, v = (t.detach().clone().requires_grad_() for t in
                           qkv.view(Bn, 64, 3, h, hd).permute(2, 0, 3, 1, 4).unbind(0))
                am = bias[None].expand(Bn, h, 64, 64)
                if mask is not None:
                    am = (am.reshape(Bn // nW, nW, h, 64, 64) + mask[None, :, None]).reshape(
                        Bn, h, 64, 64)
                am = am.to(qkv.dtype).contiguous().requires_grad_()
                g4 = gout.view(Bn, 64, h, hd).transpose(1, 2)

                def sdpa():
                    out = F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=hd**-0.5)
                    return torch.autograd.grad(out, (q, k, v, am), g4)

                if backend is None:
                    backend = sdpa_kernels(sdpa)
                    log(f"[bwd-kernel] SDPA yardstick kernels: {backend}")
                ms = cuda_ms(lambda: window_attention_backward(*args, **kw), iters=10)
                plain_ms = cuda_ms(lambda: window_attention_backward_reference(*args, **kw),
                                   iters=3, warmup=1)
                lib_ms = cuda_ms(sdpa, iters=5, warmup=1)
                b_ms, b_by = bound(qkv, bias, mask, backward=True)
                # launches_per_step: counted in phase 8's timed steps
                r = {"level": s["level"], "Bn": Bn, "C": C, "heads": h, "hd": hd, "nW": nW,
                     "dtype": dtype, "mask": masked, "max_abs_err_dqkv": errs["dqkv"], "max_abs_err_dbias": errs["dbias"],
                     "rel_err": max(errs["dqkv_rel"], errs["dbias_rel"]),
                     "tol": BWD_TOL[dtype], "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by, "plan": plan}
                results.append(r)
                log(f"[bwd-kernel] {s['level']} C={C} h={h} hd={hd} nW={nW} Bn={Bn} {dtype} "
                    f"mask={int(masked)}: err dqkv={errs['dqkv']:.3g} dbias={errs['dbias']:.3g} "
                    f"(rel {r['rel_err']:.3g}, tol {BWD_TOL[dtype]:g}) ms={ms:.4f} "
                    f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} "
                    f"({b_by}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"backward kernel disagrees with its plain version: {r}")
                del q, k, v, am, g4, dqkv, dbias, want_dqkv, want_dbias
        del qkv32, gout32, qkv, gout
        torch.cuda.empty_cache()
    return results, worst, backend


def synthetic_train_batch(n: int, seed: int, crop_hw=(320, 576), ori_hw=(360, 640)):
    """n synthetic training pairs (numpy, no OpenCV) collated into a batch."""
    from dmhomo_torch.data.hem_data import SyntheticHomoPairs
    from dmhomo_torch.data.loader import collate

    ds = SyntheticHomoPairs(n=n, crop_size=crop_hw, ori_size=ori_hw, seed=seed)
    items = [ds[i] for i in range(n)]
    return {k: collate([it[k] for it in items]) for k in ("imgs_gray_patch", "flow_gt_patch")}


def phase_train(dev, seed: int):
    import torch

    from dmhomo_torch.ops.window_attention import window_attention, window_attention_backward
    from dmhomo_torch.train.config import HEMTrainConfig
    from dmhomo_torch.train.hem_trainer import HEMTrainer

    cfg = HEMTrainConfig()  # shipped: bf16, grad_accum 4, remat auto (off), Adam 1e-4
    t0 = time.perf_counter()
    batch = synthetic_train_batch(BATCH, seed)
    log(f"[train] {BATCH} synthetic pairs {batch['imgs_gray_patch'].shape} in "
        f"{time.perf_counter() - t0:.1f} s; config bf16={cfg.bf16} grad_accum={cfg.grad_accum} "
        f"remat={cfg.remat} lr={cfg.lr}")
    trainer = HEMTrainer(cfg, steps_per_epoch=1000, device=dev)
    trainer.init_state(seed)
    if trainer.model.h_net.encoder_layers[0].remat:
        raise SystemExit("the shipped config recomputes the Swin blocks (remat)")
    losses, times, launches = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for step in range(WARMUP_STEPS + TIMED_STEPS):
        if step == WARMUP_STEPS:  # count the timed steps of the main path only
            for fn in (window_attention, window_attention_backward):
                fn.launches = 0
                fn.launches_by_shape.clear()
        f0, b0 = window_attention.launches, window_attention_backward.launches
        t0 = time.perf_counter()
        out = trainer.train_step(batch)
        loss = float(out["total"])  # waits for the step
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        launches.append((window_attention.launches - f0, window_attention_backward.launches - b0))
        log(f"[train] step {step + 1}: loss {loss:.5f} (nll {float(out['nll']):.5f}), "
            f"{times[-1]:.1f} ms, launches fwd/bwd {launches[-1][0]}/{launches[-1][1]}")
    fwd_total, bwd_total = window_attention.launches, window_attention_backward.launches
    by_shape = {"fwd": dict(window_attention.launches_by_shape),
                "bwd": dict(window_attention_backward.launches_by_shape)}
    peak = torch.cuda.max_memory_allocated()
    timed = times[WARMUP_STEPS:]
    step_ms = float(np.median(timed))
    if not np.isfinite(losses).all():
        raise SystemExit(f"training loss not finite: {losses}")
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    if not last < first:
        raise SystemExit(f"training loss did not fall: first steps {first}, last steps {last}")
    per_step = 40 * (BATCH // MICROBATCH)
    if any(fb != (per_step, per_step) for fb in launches[WARMUP_STEPS:]) or \
            (fwd_total, bwd_total) != (per_step * TIMED_STEPS, per_step * TIMED_STEPS):
        raise SystemExit(f"launches per step {launches}, expected {per_step} forward and "
                         f"{per_step} backward")
    log(f"[train] shipped config B={BATCH} (microbatches of {MICROBATCH}), bf16: first step "
        f"{times[0]:.1f} ms, steady {step_ms:.2f} ms "
        f"(timed {', '.join(f'{t:.1f}' for t in timed)}), "
        f"{1e3 * BATCH / step_ms:.2f} training pairs/s, peak {peak / 2**30:.2f} GiB")
    log(f"[train] loss mean of the first 3 steps {first:.5f} > last 3 {last:.5f}; "
        f"window-attention launches over {TIMED_STEPS} timed steps: {fwd_total} forward, "
        f"{bwd_total} backward = {per_step} + {per_step} per step")
    return {"trainer": trainer, "batch": batch, "step_ms": step_ms, "peak": peak,
            "fwd_launches": fwd_total, "bwd_launches": bwd_total, "by_shape": by_shape}


def window_key(r) -> tuple:
    """A row's key in the window-attention wrappers' ``launches_by_shape``."""
    return (r["Bn"], r["C"], r["heads"], r["nW"] if r["mask"] else 0, r["dtype"])


def count_step_launches(rows, by_shape: dict, want: int, tag: str):
    """Each row's launches per training step, as the wrappers counted them
    over phase 8's timed steps; fails unless the rows cover all ``want``
    launches of a step."""
    for r in rows:
        r["launches_per_step"] = by_shape.get(window_key(r), 0) / TIMED_STEPS
    if sum(r["launches_per_step"] for r in rows) != want:
        raise SystemExit(f"{tag} launches per shape {by_shape} do not cover the rows "
                         f"{[window_key(r) for r in rows]}")
    log(f"[{tag}] launches per training step, counted: " + ", ".join(
        f"{r['level']} {r['dtype']} mask={int(r['mask'])} x{r['launches_per_step']:g}"
        for r in rows if r["launches_per_step"]))


def phase_train_card_vs_cpu(dev, seed: int, attn_impl: str = "auto",
                            tag: str = "train-card-vs-cpu", config=None):
    import copy
    import dataclasses

    import torch

    from dmhomo_torch.losses.hem_losses import compute_losses
    from dmhomo_torch.train.config import HEMTrainConfig
    from dmhomo_torch.train.hem_trainer import HEMTrainer

    cfg = dataclasses.replace(config or HEMTrainConfig(), bf16=False, grad_accum=1, remat=False,
                              attn_impl=attn_impl)
    trainer = HEMTrainer(cfg, device=dev)
    trainer.init_state(seed + 1)
    with torch.no_grad():  # trained-looking layer scales: the init's 1e-5 would leave the
        for n, p in trainer.model.named_parameters():  # encoders a vanishing gradient
            if n.rsplit(".", 1)[-1] in ("gamma_1", "gamma_2"):
                p.fill_(0.5)
    cpu_model = copy.deepcopy(trainer.model).to("cpu")
    batch = synthetic_train_batch(2, seed + 1)
    imgs = batch["imgs_gray_patch"]
    nudge = STEP_INPUT_NOISE * np.random.default_rng(seed).normal(size=imgs.shape)
    runs = {"card": (trainer.model, imgs), "cpu": (cpu_model, imgs),
            "cpu, input nudged": (cpu_model, (imgs + nudge).astype(np.float32))}
    results = {}
    for where, (model, x) in runs.items():
        d = next(model.parameters()).device
        model.train()
        model.zero_grad(set_to_none=True)
        out = model(torch.from_numpy(x).to(d))
        loss = compute_losses({"flow_gt_patch": torch.from_numpy(batch["flow_gt_patch"]).to(d)},
                              out, cfg.loss)["total"]
        loss.backward()
        results[where] = (float(loss.detach()),
                          {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    (loss_card, g_card), (loss_cpu, g_cpu), (_, g_nudged) = results.values()
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    log(f"[{tag}] attn_impl={attn_impl!r}: fp32 loss card {loss_card:.7f} cpu {loss_cpu:.7f}: "
        f"rel {loss_rel:.3g} (tol {STEP_LOSS_TOL:g})")

    def rel(a, g):
        return float((a - g).abs().max()) / max(float(g.abs().max()), 1e-30)

    rels = {n: rel(g_card[n], g) for n, g in g_cpu.items()}
    noise = {n: rel(g_nudged[n], g) for n, g in g_cpu.items()}
    tols = {n: max(STEP_GRAD_TOL, STEP_NOISE_FACTOR * noise[n]) for n in g_cpu}
    # the first two blocks' position-bias tables take their gradient from the
    # backward kernel's dbias (W-MSA, then SW-MSA with the mask)
    named = ("h_net.encoder_layers.0.layer.0.attn.relative_position_bias_table",
             "h_net.encoder_layers.0.layer.1.attn.relative_position_bias_table",
             "h_net.encoder_layers.0.layer.0.attn.qkv.weight",
             "h_net.encoder_layers.0.layer.1.attn.qkv.weight", "h_net.head2.weight",
             "mask_generator.conv1.0.weight")
    for n in named:
        log(f"[{tag}] grad {n} {tuple(g_cpu[n].shape)}: max |card - cpu| / "
            f"max |cpu| = {rels[n]:.3g}; the CPU's own change for an input nudged by "
            f"{STEP_INPUT_NOISE:g}: {noise[n]:.3g}; tol {tols[n]:.3g}")
    order = sorted(rels, key=lambda n: -rels[n] / tols[n])
    log(f"[{tag}] closest to their tolerance of all {len(rels)} parameters: "
        + ", ".join(f"{n} {rels[n]:.3g} (tol {tols[n]:.3g})" for n in order[:3]))
    bad = [n for n in order if not rels[n] <= tols[n]]
    if bad or not loss_rel <= STEP_LOSS_TOL:
        raise SystemExit(f"card and CPU training steps disagree: loss {loss_rel}, "
                         f"gradients {[(n, rels[n], tols[n]) for n in bad]}")
    return {"loss_rel": loss_rel, "grad_rel": {n: rels[n] for n in named},
            "grad_rel_nudged_cpu": {n: noise[n] for n in named}}


def phase_train_profile(trainer, batch, step_ms: float):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    events = kernel_events(prof.key_averages())
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if dev_ms <= 0:
        raise SystemExit("the profiler saw no device time")
    idle = max(0.0, 1.0 - dev_ms / step_ms)
    attn = {d: sum(e.self_device_time_total for e in events
                   if f"window_attention_{d}_kernel" in e.key) / 1e3 for d in ("fwd", "bwd")}
    log(f"[train-profile] one step: device busy {dev_ms:.2f} ms of the {step_ms:.2f} ms "
        f"unprofiled step: idle {100 * idle:.1f}%; window attention forward kernel "
        f"{attn['fwd']:.2f} ms, backward kernel {attn['bwd']:.2f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
        log(f"[train-profile] {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    return dev_ms, idle, attn


# ---------------------------------------------------------------------------
# DGM generation (phases 11-15)
# ---------------------------------------------------------------------------


def linear_attention_sites(cfg, image_size: int):
    """(site, H=W, C) of every LinearAttention of the UNet, in call order of
    the down path, then the up path."""
    dims = [cfg.dim] + [cfg.dim * m for m in cfg.dim_mults]
    n = len(cfg.dim_mults)
    return ([(f"down_{i}", image_size >> i, dims[i]) for i in range(n)]
            + [(f"up_{i}", image_size >> (n - 1 - i), dims[n - i]) for i in range(n)])


def linear_bound(x, pass_: int, heads: int = 4, dim_head: int = 32):
    """(ms, 'bytes' | 'operations') of one pass at x (B, N, C): pass 1 reads
    x, the k and v columns of W and g and writes the (E, s) sums and the
    LayerNorm statistics; pass 2 reads x, the q columns, g, the statistics
    and the sums and writes the (B, N, heads*dim_head) output.  Operations:
    the projection (2*C flops per token and column), and 2*heads*dim_head^2
    per token for E (pass 1) or for eq . context (pass 2)."""
    from dmhomo_torch.ops.linear_attention import sums_width

    B, N, C = x.shape
    el = x.element_size()
    hd = heads * dim_head
    cols = 2 * hd if pass_ == 1 else hd
    nbytes = B * N * C * el + C * cols * 4 + C * 4 + B * sums_width(heads, dim_head) * 4 + B * N * 8
    if pass_ == 2:
        nbytes += B * N * hd * el
    flops = 2.0 * B * N * (C * cols + heads * dim_head * dim_head)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(x.dtype).split(".")[-1]]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_linear_build():
    from dmhomo_torch.ops import linear_attention as la

    entry = None
    for line in la.build_log().splitlines():
        fp32 = re.search(r"linear_attention_pass(1|2)_kernelIfLb([01])E(?:Lb([01])E)?", line)
        tc = re.search(r"linear_attention_pass(1|2)_kernel_tcILb([01])ELb([01])E"
                       r"(?:Lb([01])ELi(\d)E)?", line)
        if fp32:  # pass1<float, PRENORM, COMPUTE_STATS>, pass2<float, PRENORM>
            new = f"pass{fp32.group(1)} fp32 prenorm={fp32.group(2)}" + (
                f" stats={fp32.group(3)}" if fp32.group(3) is not None else "")
            if new != entry:
                smem = la.shared_memory_bytes(int(fp32.group(1)))
                log(f"[la-build] {new}: {smem} bytes dynamic shared memory")
            entry = new
        elif tc:  # tc::pass1<PRENORM, STATS, ALIGNED, HG>, tc::pass2<PRENORM, ALIGNED>
            if tc.group(1) == "1":
                new = (f"pass1 bf16 tensor cores prenorm={tc.group(2)} stats={tc.group(3)} "
                       f"aligned={tc.group(4)} heads={tc.group(5)}")
            else:
                new = f"pass2 bf16 tensor cores prenorm={tc.group(2)} aligned={tc.group(3)}"
            if new != entry:
                log(f"[la-build] {new}: dynamic shared memory by plan (phase 12)")
            entry = new
        elif "linear_attention_reduce_kernel" in line:  # pass 1's fixed-order sums
            entry = "pass1 reduction " + ("bf16 (per-warp slots)" if "_tc" in line else "fp32")
        elif entry and ("registers" in line or "spill" in line):
            log(f"[la-build] {entry}: {line.split(':', 1)[-1].strip()}")


def phase_linear_kernels(sites, dev, seed: int):
    """Both kernels vs their plain versions at every UNet site, B = 2 * bs,
    prenorm folded, the UNet's channel-major layout, fp32 and bf16."""
    import torch

    from dmhomo_torch.ops import linear_attention as la

    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    B = 2 * GEN_BS
    results, worst = [], {}
    for site, hw, C in sites:
        N = hw * hw
        x32 = (1.5 * torch.randn(B, C, N, generator=gen, device=dev) + 0.3).transpose(1, 2)
        w = torch.randn(C, 3 * la.HIDDEN, generator=gen, device=dev) / C**0.5
        g = 0.5 + torch.rand(C, generator=gen, device=dev)
        pn = (g,)
        for dtype in ("float32", "bfloat16"):
            x = x32.to(getattr(torch, dtype))
            want = la.linear_attention_reference(x, w, prenorm=pn)
            got = la.linear_attention(x, w, prenorm=pn)
            # each pass on its own against its plain version
            sums_ref = la.linear_attention_pass1_reference(x, w, prenorm=pn)
            sums = torch.zeros_like(sums_ref)
            mean = torch.empty((B, N), device=dev)
            rstd = torch.empty_like(mean)
            la.linear_attention_pass1(x, w, g, mean, rstd, True, sums)
            out_ref = la.linear_attention_pass2_reference(x, w, sums_ref, prenorm=pn)
            out = torch.empty((B, la.HIDDEN, N), dtype=x.dtype, device=dev).transpose(1, 2)
            la.linear_attention_pass2(x, w, g, mean, rstd, sums_ref, out)
            torch.cuda.synchronize()
            errs = {}
            for name, a, b in (("out", got, want), ("pass1", sums, sums_ref),
                               ("pass2", out, out_ref)):
                e = float((a.float() - b.float()).abs().max())
                errs[name] = e
                errs[name + "_rel"] = e / float(b.float().abs().max())
                worst[(dtype, name)] = max(worst.get((dtype, name), 0.0), e)
            finite = bool(torch.isfinite(got).all()) and bool(torch.isfinite(sums).all())
            ok = finite and max(errs["out_rel"], errs["pass1_rel"], errs["pass2_rel"]) <= LA_TOL[dtype]
            sums_t = torch.zeros_like(sums)
            ms1, bursts1 = burst_ms(
                lambda: la.linear_attention_pass1(x, w, g, mean, rstd, True, sums_t), iters=5)
            ms2, bursts2 = burst_ms(
                lambda: la.linear_attention_pass2(x, w, g, mean, rstd, sums_ref, out), iters=5)
            plain1 = cuda_ms(lambda: la.linear_attention_pass1_reference(x, w, prenorm=pn),
                             iters=2, warmup=1)
            plain2 = cuda_ms(lambda: la.linear_attention_pass2_reference(x, w, sums_ref, prenorm=pn),
                             iters=2, warmup=1)
            wd = w.to(x.dtype)
            gemm = cuda_ms(lambda: torch.matmul(x, wd), iters=5, warmup=1)
            (b1, by1), (b2, by2) = linear_bound(x, 1), linear_bound(x, 2)
            r = {"site": site, "H": hw, "W": hw, "N": N, "C": C, "B": B, "dtype": dtype,
                 "err_out": errs["out"], "rel_err_out": errs["out_rel"],
                 "err_pass1": errs["pass1"], "rel_err_pass1": errs["pass1_rel"],
                 "err_pass2": errs["pass2"], "rel_err_pass2": errs["pass2_rel"],
                 "tol": LA_TOL[dtype], "pass1_ms": ms1, "pass2_ms": ms2,
                 "pass1_ms_bursts": bursts1, "pass2_ms_bursts": bursts2,
                 "plain1_ms": plain1, "plain2_ms": plain2, "gemm_ms": gemm,
                 "bound1_ms": b1, "bound1_by": by1, "bound2_ms": b2, "bound2_by": by2,
                 "share1": b1 / ms1, "share2": b2 / ms2}
            plans = ""
            if dtype == "bfloat16":  # the tensor-core kernels' plans, as the UNet's call takes them
                r["plan1"] = la.launch_plan(x, 1)
                r["plan2"] = la.launch_plan(x, 2, (mean, rstd), out)
                for p in (1, 2):
                    r[f"plan{p}"]["blocks_per_sm"] = la.blocks_per_sm(p, r[f"plan{p}"])
                plans = "; " + "; ".join(
                    f"pass{p} {pl['loader']} loader{' / ' + pl['store'] + ' stores' if 'store' in pl else ''}, "
                    f"{pl['heads_per_block'] if p == 1 else 4} heads per block, {pl['chunks']} x "
                    f"{pl['chunk']} channels per tile, {pl['stages']} slots, {pl['weights']} "
                    f"weights, {pl['smem']} bytes, {pl['blocks_per_sm']} blocks per SM"
                    for p, pl in ((1, r["plan1"]), (2, r["plan2"])))
                if "elementwise" in (r["plan1"]["loader"], r["plan2"]["loader"], r["plan2"]["store"]):
                    ok = False
            results.append(r)
            log(f"[la-kernel] {site} {hw}x{hw} N={N} C={C} B={B} {dtype}: rel err out "
                f"{errs['out_rel']:.3g} pass1 {errs['pass1_rel']:.3g} pass2 {errs['pass2_rel']:.3g} "
                f"(abs {errs['out']:.3g}; tol {LA_TOL[dtype]:g}) pass1 {ms1:.4f} ms (bursts "
                f"{spread(bursts1)}; bound {b1:.4f} {by1}: {100 * b1 / ms1:.1f}% of it; plain "
                f"{plain1:.4f}) pass2 {ms2:.4f} ms (bursts {spread(bursts2)}; bound {b2:.4f} {by2}: "
                f"{100 * b2 / ms2:.1f}%; plain {plain2:.4f}) cuBLAS x@W_qkv "
                f"{gemm:.4f} ms{plans} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("linear-attention kernels disagree with their plain versions, or "
                                 f"a main-path site took the element-wise loader: {r}")
            del want, got, sums_ref, sums, sums_t, out_ref, out, mean, rstd, x, wd
        del x32
        torch.cuda.empty_cache()
    return results, worst


def phase_generate(dev, seed: int):
    """The generate step at the shipped config: one warm-up batch, then
    GEN_TIMED_BATCHES timed ones, each counted from zero."""
    import torch

    from dmhomo_torch.cli.dgm_sample import build_sampler, generate
    from dmhomo_torch.data.conditions import synthetic_condition_batches
    from dmhomo_torch.geometry.homography import homography_to_flow
    from dmhomo_torch.ops import linear_attention as la

    t0 = time.perf_counter()
    gd = build_sampler(device=dev, seed=seed)  # dgm_sample's defaults: bf16, 256², 32 steps
    batches = synthetic_condition_batches(2 * GEN_BS, GEN_SIZE, GEN_BS, 1, seed)
    conds = [next(batches) for _ in range(1 + GEN_TIMED_BATCHES)]
    log(f"[gen] UNet {sum(p.numel() for p in gd.model.parameters()):,} parameters "
        f"(seeded random), {len(conds)} batches of {GEN_BS} synthetic conditions, set-up "
        f"{time.perf_counter() - t0:.1f} s")
    forwards = [0]
    gd.model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    gen = torch.Generator(device=dev).manual_seed(seed)

    def run(cond, classes):
        return generate(gd, torch.from_numpy(cond).to(dev),
                        torch.from_numpy(classes.astype(np.int64)).to(dev), gen)

    t0 = time.perf_counter()
    run(*conds[0])
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts from zero just before it, read just after
    la.linear_attention_pass1.launches = la.linear_attention_pass1.elementwise = 0
    la.linear_attention_pass2.launches = la.linear_attention_pass2.elementwise = 0
    forwards[0] = 0
    times, per_batch, outs = [], [], []
    for cond, classes in conds[1:]:
        c1, c2, f0 = la.linear_attention_pass1.launches, la.linear_attention_pass2.launches, forwards[0]
        t0 = time.perf_counter()
        imgs, homos = run(cond, classes)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        per_batch.append((la.linear_attention_pass1.launches - c1,
                          la.linear_attention_pass2.launches - c2, forwards[0] - f0))
        outs.append((imgs, homos, cond))
    launches = (la.linear_attention_pass1.launches, la.linear_attention_pass2.launches)
    elementwise = (la.linear_attention_pass1.elementwise, la.linear_attention_pass2.elementwise)
    peak = torch.cuda.max_memory_allocated()
    if elementwise != (0, 0):
        raise SystemExit(f"(pass 1, pass 2) took the element-wise loader {elementwise} times")
    n_sites = len(linear_attention_sites(gd.model.config, GEN_SIZE))
    want = (n_sites * GEN_STEPS, n_sites * GEN_STEPS, GEN_STEPS)
    if any(p != want for p in per_batch):
        raise SystemExit(f"per batch (pass 1, pass 2, UNet forwards) {per_batch}, expected {want}")
    fit_err = 0.0
    for imgs, homos, cond in outs:
        if imgs.shape != (GEN_BS, GEN_SIZE, GEN_SIZE, 6) or not bool(torch.isfinite(imgs).all()):
            raise SystemExit(f"generated images not finite of shape {imgs.shape}")
        lo, hi = float(imgs.min()), float(imgs.max())
        if lo < 0.0 or hi > 1.0:
            raise SystemExit(f"generated images outside [0, 1]: {lo} .. {hi}")
        flow = homography_to_flow(homos.float(), GEN_SIZE, GEN_SIZE).cpu().numpy()
        fit_err = max(fit_err, float(np.abs(flow - cond[..., 10:12]).max()))
    if not fit_err <= FIT_TOL_PX:
        raise SystemExit(f"fitted homographies miss the condition flows by {fit_err} px")
    batch_ms = float(np.median(times))
    log(f"[gen] shipped config (bf16, bs {GEN_BS} -> CFG batch {2 * GEN_BS}, {GEN_STEPS} DDIM "
        f"steps, {GEN_SIZE}x{GEN_SIZE}): first batch {first_ms:.1f} ms, timed "
        f"{', '.join(f'{t:.1f}' for t in times)} ms: {batch_ms:.1f} ms per batch, "
        f"{batch_ms / GEN_STEPS:.2f} ms per DDIM step, {1e3 * GEN_BS / batch_ms:.3f} samples/s, "
        f"peak {peak / 2**30:.2f} GiB")
    log(f"[gen] images in [{lo:.3f}, {hi:.3f}], finite; fitted H reproduces the condition flow "
        f"to {fit_err:.3g} px (tol {FIT_TOL_PX:g}); launches over {GEN_TIMED_BATCHES} batches: "
        f"pass 1 {launches[0]}, pass 2 {launches[1]} = {n_sites} + {n_sites} per UNet forward "
        f"({per_batch[0][2]} forwards per batch), every one through the aligned loader")
    return {"gd": gd, "cond": conds[0], "batch_ms": batch_ms, "step_ms": batch_ms / GEN_STEPS,
            "peak": peak, "launches": launches, "fit_err": fit_err, "first_ms": first_ms}


def phase_gen_card_vs_cpu(gd, cond_batch, seed: int):
    """One fp32 CFG UNet forward at 256² on 1 condition (doubled to 2), the
    same weights on the card (kernels) and on the CPU (plain versions), and
    fit_homography_to_flow of that condition on both."""
    import copy
    import dataclasses

    import torch

    from dmhomo_torch.geometry.homography import fit_homography_to_flow, homography_to_flow
    from dmhomo_torch.models.unet import ConditionalUNet

    dev = gd.schedule.betas.device
    cpu_model = ConditionalUNet(dataclasses.replace(gd.model.config, dtype=torch.float32))
    cpu_model.load_state_dict({k: v.cpu() for k, v in gd.model.state_dict().items()})
    cpu_model.eval()
    card_model = copy.deepcopy(cpu_model).to(dev)
    cond, classes = cond_batch
    rng = np.random.default_rng(seed + 14)
    x = rng.normal(size=(1, GEN_SIZE, GEN_SIZE, 6)).astype(np.float32)
    nudge = (GEN_INPUT_NOISE * rng.normal(size=x.shape)).astype(np.float32)
    c = torch.from_numpy(cond[:1])

    def inputs(xx, d):
        two = lambda t: torch.cat([t, t]).to(d)  # noqa: E731
        return (two(torch.from_numpy(xx)), two(torch.full((1,), 500)),
                two(torch.from_numpy(classes[:1].astype(np.int64))), two(c[..., 7:10] * 2 - 1),
                two(c[..., 6:7]), torch.tensor([True, False], device=d))

    with torch.inference_mode():
        card = card_model(*inputs(x, dev)).cpu()
        cpu = cpu_model(*inputs(x, "cpu"))
        nudged = cpu_model(*inputs(x + nudge, "cpu"))
    scale = float(cpu.abs().max())
    diff = float((card - cpu).abs().max()) / scale
    noise = float((nudged - cpu).abs().max()) / scale
    tol = max(GEN_CPU_TOL, GEN_NOISE_FACTOR * noise)
    log(f"[gen-card-vs-cpu] fp32 CFG UNet forward (2, {GEN_SIZE}, {GEN_SIZE}, 6): max |card - cpu| "
        f"/ max |cpu| = {diff:.3g} (max |cpu| {scale:.3g}); the CPU's own change for an input "
        f"nudged by {GEN_INPUT_NOISE:g}: {noise:.3g}; tol {tol:.3g}")
    flow = c[..., 10:12]
    H_card = fit_homography_to_flow(flow.to(dev)).cpu()
    H_cpu = fit_homography_to_flow(flow)
    fit_diff = float((homography_to_flow(H_card, GEN_SIZE, GEN_SIZE)
                      - homography_to_flow(H_cpu, GEN_SIZE, GEN_SIZE)).abs().max())
    log(f"[gen-card-vs-cpu] fit_homography_to_flow: flows of the card's and the CPU's H differ "
        f"by {fit_diff:.3g} px (tol {FIT_CPU_TOL_PX:g}); max |H_card - H_cpu| "
        f"{float((H_card - H_cpu).abs().max()):.3g}")
    if not diff <= tol or not fit_diff <= FIT_CPU_TOL_PX:
        raise SystemExit(f"card and CPU disagree: UNet {diff} (tol {tol}), fit {fit_diff} px")
    return {"unet_rel": diff, "unet_rel_nudged_cpu": noise, "unet_tol": tol,
            "fit_px": fit_diff}


def phase_gen_profile(gd, cond_batch, step_ms: float):
    """One DDIM step (a CFG UNet forward at B = 2 * bs and the update) under
    torch.profiler; idle share against phase 13's unprofiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dmhomo_torch.diffusion.schedules import ddim_time_pairs

    dev = gd.schedule.betas.device
    cond, classes = (torch.from_numpy(a).to(dev) for a in cond_batch)
    shape = (GEN_BS, GEN_SIZE, GEN_SIZE, 6)
    img, noise = torch.randn(shape, device=dev), torch.randn(shape, device=dev)
    time_, time_next = (int(t) for t in ddim_time_pairs(1000, GEN_STEPS)[0])
    args = (img, time_, time_next, classes.long(), cond[..., 7:10] * 2 - 1, cond[..., 6:7], noise)
    with torch.inference_mode():
        gd.ddim_step(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            gd.ddim_step(*args)
            torch.cuda.synchronize()
    events = kernel_events(prof.key_averages())
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if dev_ms <= 0:
        raise SystemExit("the profiler saw no device time")
    idle = max(0.0, 1.0 - dev_ms / step_ms)
    la_ms = {p: sum(e.self_device_time_total for e in events
                    if f"linear_attention_pass{p}_kernel" in e.key) / 1e3 for p in (1, 2)}
    log(f"[gen-profile] one DDIM step: device busy {dev_ms:.2f} ms of the {step_ms:.2f} ms "
        f"unprofiled step: idle {100 * idle:.1f}%; linear attention pass 1 {la_ms[1]:.2f} ms, "
        f"pass 2 {la_ms[2]:.2f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
        log(f"[gen-profile] {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return dev_ms, idle, la_ms


# ---------------------------------------------------------------------------
# the whole-block Swin kernel (phases 16-18)
# ---------------------------------------------------------------------------


def block_bound(x, params, mask):
    """(ms, 'bytes' | 'operations') of one whole Swin block on x (B, H, W,
    C): x read and y written once, every parameter and the mask read once;
    per token 2*C*(4C + 2*hidden) flops of projections and 4*64*C of
    attention (two N x N x hd products per head, N = 64 at 8x8 windows)."""
    B, H, W, C = x.shape
    hidden, N = params[10].shape[0], params[4].shape[-1]
    el = x.element_size()
    nbytes = (2 * x.numel() * el + sum(p.numel() * 4 for p in params)
              + (mask.numel() * 4 if mask is not None else 0))
    flops = 2.0 * B * H * W * C * (4 * C + 2 * hidden + 2 * N)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(x.dtype).split(".")[-1]]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_swin_build(direction: str = "fwd", tag: str = "sb-build"):
    """ptxas's registers and spills of each forward (or backward) variant of
    ``csrc/swin_block.cu``, with its dynamic shared memory (MLP 3C)."""
    import torch

    from dmhomo_torch.ops import swin_block as sb

    entry = None
    for line in sb.build_log().splitlines():
        # swin_block_fwd_kernel<T, C, HD>; swin_block_bwd_<part>_kernel<T, C[, HD]>
        m = re.search(r"swin_block_(fwd|bwd_([a-z]+))_kernel"
                      r"(?:I(f|13__nv_bfloat16)Li(\d+)E(?:Li(\d+)E)?)?", line)
        if m:
            kind = "fwd" if m.group(1) == "fwd" else "bwd"
            dt = {"f": "fp32", None: ""}.get(m.group(3), "bf16")
            C, hd = int(m.group(4) or 0), int(m.group(5) or 8)
            new = f"{m.group(1)} {dt} C={C}" + (f" hd={m.group(5)}" if m.group(5) else "")
            if kind == direction and new != entry:
                smem = (sb.shared_memory_bytes(
                            C, 3 * C, torch.float32 if dt == "fp32" else torch.bfloat16)
                        if kind == "fwd" else
                        sb.backward_shared_memory_bytes(
                            C, hd, m.group(2), torch.float32 if dt == "fp32" else torch.bfloat16)
                        if C else 0)
                log(f"[{tag}] {new}: {smem} bytes dynamic shared memory (MLP 3C)")
            entry = new if kind == direction else None
        elif entry and ("registers" in line or "spill" in line):
            log(f"[{tag}] {entry}: {line.split(':', 1)[-1].strip()}")


def phase_swin_fwd_sass():
    """Tensor-core instructions in each forward instantiation's machine code:
    the bf16 ones run every product on tensor cores, the fp32 ones none (TF32
    stays off); either way round fails the phase."""
    from dmhomo_torch.ops import swin_block as sb

    counts = sb.forward_tensor_core_instructions()
    flat = {f"{'bf16' if dt == 'bfloat16' else 'fp32'} C={C} hd={hd}": n
            for (dt, C, hd), n in sorted(counts.items())}
    log(f"[sb-sass] tensor-core instructions (HMMA, HGMMA) per forward instantiation: "
        f"{json.dumps(flat)}")
    bad = {k: n for k, n in flat.items() if (n == 0) == k.startswith("bf16")}
    if bad:
        raise SystemExit(f"forward instantiations on the wrong units (bf16 without tensor-core "
                         f"instructions, or fp32 with some): {bad}")
    return flat


def seeded_swin_blocks(s, dev, gen):
    """The unfused SwinBlock of a shape, W-MSA and SW-MSA (shift ws/2 and its
    mask), sharing trained-looking weights drawn from ``gen``."""
    import torch

    from dmhomo_torch.models.swin import SwinBlock

    blocks = [SwinBlock(s["C"], (s["H"], s["W"]), s["heads"], s["ws"], shift, 3.0).to(dev).eval()
              for shift in (0, s["shift"])]
    with torch.no_grad():
        for name, p in blocks[0].named_parameters():
            if name.endswith(("norm1.weight", "norm2.weight")):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=gen, device=dev))
            elif name.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) / p.shape[1]**0.5)
            elif name.endswith("relative_position_bias_table"):
                p.copy_(0.5 * torch.randn(p.shape, generator=gen, device=dev))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen, device=dev))
    blocks[1].load_state_dict(blocks[0].state_dict())
    return blocks


def phase_swin_kernels(shapes, dev, seed: int):
    """The whole-block kernel vs its plain version at every Swin-block shape
    of the shipped estimator, B=32, ±shift, fp32 and bf16."""
    import torch

    from dmhomo_torch.ops import swin_block as sb

    gen = torch.Generator(device=dev).manual_seed(seed + 16)
    results, worst = [], {"float32": 0.0, "bfloat16": 0.0}
    for s in shapes:
        B, H, W, C, h = BATCH, s["H"], s["W"], s["C"], s["heads"]
        blocks = seeded_swin_blocks(s, dev, gen)
        x32 = torch.randn(B, H, W, C, generator=gen, device=dev)
        for dtype in ("float32", "bfloat16"):
            x = x32.to(getattr(torch, dtype))
            for masked in (False, True):
                blk = blocks[masked]
                with torch.inference_mode():
                    params = blk.fused_params()
                    mask, shift = blk.attn_mask, blk.shift_size
                    kw = dict(num_heads=h, shift=shift)
                    got = sb.swin_block(x, params, mask, **kw)
                    want = sb.swin_block_reference(x, params, mask, **kw)

                    def unfused():
                        with torch.autocast("cuda", torch.bfloat16, enabled=dtype == "bfloat16"):
                            return blk(x.reshape(B, H * W, C))

                    torch.cuda.synchronize()
                    scale = max(1.0, float(want.float().abs().max()))
                    err = float((got.float() - want.float()).abs().max())
                    ok = err / scale <= SWIN_TOL[dtype] and bool(torch.isfinite(got).all())
                    unfused_rel = None
                    if dtype == "float32":
                        unfused_rel = float((unfused().reshape(B, H, W, C) - got).abs().max()) / scale
                        ok = ok and unfused_rel <= SWIN_UNFUSED_TOL
                    worst[dtype] = max(worst[dtype], err)
                    ms = cuda_ms(lambda: sb.swin_block(x, params, mask, **kw), iters=10)
                    plain_ms = cuda_ms(lambda: sb.swin_block_reference(x, params, mask, **kw),
                                       iters=3, warmup=1)
                    unfused_ms = cuda_ms(unfused, iters=5, warmup=1)
                    b_ms, b_by = block_bound(x, params, mask)
                    del got, want
                smem = sb.shared_memory_bytes(C, 3 * C, x.dtype)  # what the launch asks for
                occupancy = sb.forward_blocks_per_sm(C, h, x.dtype)
                if not masked:
                    log(f"[sb-plan] {s['level']} {H}x{W} C={C} h={h} B={B} {dtype}: "
                        f"{json.dumps(sb.forward_plan(x, h, 3 * C))}; the library's shared "
                        f"memory {smem} bytes, blocks per SM on this card {occupancy}")
                r = {"level": s["level"], "B": B, "H": H, "W": W, "C": C, "heads": h,
                     "hd": s["hd"], "dtype": dtype, "mask": masked,
                     "launches_per_forward": s["masked_launches" if masked else "plain_launches"],
                     "max_abs_err": err, "rel_err": err / scale, "tol": SWIN_TOL[dtype],
                     "unfused_rel_err": unfused_rel, "ms": ms, "plain_ms": plain_ms,
                     "unfused_ms": unfused_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "smem": smem, "blocks_per_sm": occupancy}
                results.append(r)
                log(f"[sb-kernel] {s['level']} {H}x{W} C={C} h={h} hd={s['hd']} B={B} {dtype} "
                    f"shift={shift}: err={err:.3g} (rel {err / scale:.3g}, tol "
                    f"{SWIN_TOL[dtype]:g}"
                    + (f"; unfused rel {unfused_rel:.3g}, tol {SWIN_UNFUSED_TOL:g}"
                       if unfused_rel is not None else "")
                    + f") ms={ms:.4f} plain_ms={plain_ms:.4f} unfused_ms={unfused_ms:.4f} "
                    f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"whole-block kernel disagrees with its plain version: {r}")
        del blocks, x32, x
        torch.cuda.empty_cache()
    return results, worst


def phase_fused_slice(dev, pairs, seed: int, window_batch_ms: float):
    """``eval_forward`` of the fused_block estimator (phase 4's weights), its
    launches and a profile; then, with trained-looking layer scales of 0.5 in
    both models (the init's 1e-5 leaves the flows nearly blind to the
    encoders), its flows against phase 4's model.  Returns that model for
    phase 18."""
    import torch

    from dmhomo_torch.cli.hem_eval import eval_forward
    from dmhomo_torch.config import EstimatorConfig, SwinConfig
    from dmhomo_torch.models.estimator import build_estimator, upsample_outputs
    from dmhomo_torch.ops.swin_block import swin_block
    from dmhomo_torch.ops.window_attention import window_attention

    def seeded(cfg):
        return build_estimator(cfg, device=dev, generator=torch.Generator().manual_seed(seed))

    fused = seeded(EstimatorConfig(swin=SwinConfig(attn_impl="fused_block")))
    window = seeded(EstimatorConfig())
    for (k, a), b in zip(fused.state_dict().items(), window.state_dict().values()):
        if not torch.equal(a, b):
            raise SystemExit(f"the fused_block estimator's {k} differs from phase 4's")
    counts, forwards, err, batch_ms, peak = phase_slice(
        fused, pairs, {"whole-block": swin_block, "window-attention": window_attention},
        tag="sb-slice")
    per_forward = {k: n / forwards for k, n in counts.items()}
    if per_forward != {"whole-block": 40, "window-attention": 0}:
        raise SystemExit(f"launches per forward {per_forward}, expected 40 whole-block and "
                         "no window-attention launch")
    dev_ms, idle = phase_profile(fused, pairs, batch_ms, tag="sb-profile")
    patch, pts = pairs
    ori = fused.config.ori_size
    with torch.inference_mode():
        for model in (fused, window):
            for n, p in model.named_parameters():
                if n.rsplit(".", 1)[-1] in ("gamma_1", "gamma_2"):
                    p.fill_(0.5)
        err = eval_forward(fused, patch, pts, ori).cpu().numpy()
        out_f = upsample_outputs(fused(patch), ori)
        out_w = upsample_outputs(window(patch), ori)
        err_w = eval_forward(window, patch, pts, ori).cpu().numpy()
    flow_px = {k: float((out_f[k] - out_w[k]).abs().max()) for k in ("flow_f", "flow_b")}
    mask_diff = float((out_f["mask_f"] - out_w["mask_f"]).abs().max())
    log(f"[sb-slice] against phase 4's window-attention model with the same weights, layer "
        f"scales 0.5: max |flow diff| {json.dumps(flow_px)} px (tol {FUSED_FLOW_TOL_PX:g}; max "
        f"|flow_f| {float(out_w['flow_f'].abs().max()):.3g} px), mask_f {mask_diff:.3g}, point "
        f"errors {float(np.abs(err - err_w).max()):.3g} px; batch {batch_ms:.2f} ms against "
        f"{window_batch_ms:.2f} ms")
    if not max(flow_px.values()) <= FUSED_FLOW_TOL_PX:
        raise SystemExit(f"fused_block flows differ from the window-attention model: {flow_px}")
    del window
    return {"model": fused, "launches": counts["whole-block"], "batch_ms": batch_ms,
            "peak": peak, "flow_px": flow_px, "idle": idle, "dev_ms": dev_ms}


def block_bwd_bound(x, params, mask):
    """(ms, 'bytes' | 'operations') of one whole Swin block backward on x (B,
    H, W, C), counting the Pallas ``_bwd_kernel``'s own work: x and dy read
    and dx written once, every parameter and the mask read once and every
    fp32 parameter gradient written once; per token the forward recompute
    without its last product (2*C*(4C + hidden) flops of projections, two
    64 x 64 x hd attention products per head), two products per projection
    (2*2*C*(4C + 2*hidden)) and six N x N x hd products per head (N = 64 at
    8x8 windows)."""
    B, H, W, C = x.shape
    hidden, N = params[10].shape[0], params[4].shape[-1]
    el = x.element_size()
    nbytes = (3 * x.numel() * el + 2 * sum(p.numel() * 4 for p in params)
              + (mask.numel() * 4 if mask is not None else 0))
    flops = 2.0 * B * H * W * C * (12 * C + 5 * hidden + 8 * N)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(x.dtype).split(".")[-1]]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def shape_key(r) -> tuple:
    """A row's key in the whole-block wrappers' ``launches_by_shape``."""
    return (r["B"], r["H"], r["W"], r["C"], r["heads"], r["dtype"], r["mask"])


def train_block_dtype(sub: int) -> str:
    """The I/O dtype of a Swin block of sub-level ``sub`` in the bf16
    training step: each encoder level's tokens enter in bf16 (both halves of
    the concat cast to the autocast dtype, as the JAX bf16 estimator casts
    them), and a PatchMerging's BatchNorm hands the next sub-level fp32."""
    return "bfloat16" if sub == 0 else "float32"


def train_block_dtypes(model) -> list:
    """``train_block_dtype`` of each Swin block of one estimator forward, in
    call order: the encoder levels coarsest first, twice (``h_net`` runs
    once per direction)."""
    out = []
    for layer in reversed(model.h_net.encoder_layers):
        sub = 0
        for m in layer.layer:
            if hasattr(m, "attn"):
                out.append(train_block_dtype(sub))
            else:  # PatchMerging closes a sub-level
                sub += 1
    return out * 2


def phase_swin_bwd_sass():
    """Atomic instructions in the built backward kernels' machine code
    (cuobjdump's SASS of the library): any one fails the phase, since the
    design sums every gradient without atomics; none means no launch makes
    a global atomic."""
    from dmhomo_torch.ops import swin_block as sb

    counts = sb.backward_atomic_instructions()
    log(f"[sb-bwd-sass] atomic instructions (ATOM, ATOMG, ATOMS, RED, REDG) in the backward "
        f"kernels' SASS, over their instantiations: {json.dumps(counts)}")
    if any(counts.values()):
        raise SystemExit(f"the backward kernels' machine code holds atomics: {counts}")
    return counts


def phase_swin_bwd_kernels(shapes, dev, seed: int):
    """The whole-block backward kernel vs its plain version at every
    Swin-block shape of a training microbatch (B=8), +-shift, fp32 and bf16."""
    import torch

    from dmhomo_torch.ops import swin_block as sb

    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    results, worst = [], {}
    for s in shapes:
        B, H, W, C, h = MICROBATCH, s["H"], s["W"], s["C"], s["heads"]
        blocks = seeded_swin_blocks(s, dev, gen)
        x32 = torch.randn(B, H, W, C, generator=gen, device=dev)
        dy32 = torch.randn(B, H, W, C, generator=gen, device=dev)
        for dtype in ("float32", "bfloat16"):
            x, dy = x32.to(getattr(torch, dtype)), dy32.to(getattr(torch, dtype))
            for masked in (False, True):
                blk = blocks[masked]
                params = tuple(p.detach() for p in blk.fused_params())
                mask, shift = blk.attn_mask, blk.shift_size
                kw = dict(num_heads=h, shift=shift)
                dx, grads = sb.swin_block_backward(x, params, mask, dy, **kw)
                want_dx, want = sb.swin_block_backward_reference(x, params, mask, dy, **kw)
                torch.cuda.synchronize()
                errs, rels, finite = {}, {}, True
                for name, got, w in zip(("dx",) + sb.PARAM_NAMES, (dx,) + grads, (want_dx,) + want):
                    errs[name] = float((got.float() - w.float()).abs().max())
                    rels[name] = errs[name] / max(1.0, float(w.float().abs().max()))
                    finite = finite and bool(torch.isfinite(got).all())
                    worst[(dtype, name)] = max(worst.get((dtype, name), 0.0), errs[name])
                rel = max(rels.values())
                ok = finite and rel <= BWD_TOL[dtype]
                del dx, grads, want_dx, want
                xu = x.reshape(B, H * W, C).detach().requires_grad_()
                dyu = dy.reshape(B, H * W, C)
                weights = list(blk.parameters())

                def unfused():
                    with torch.autocast(dev.type, torch.bfloat16, enabled=dtype == "bfloat16"):
                        y = blk(xu)
                    return torch.autograd.grad(y, [xu] + weights, dyu)

                ms = cuda_ms(lambda: sb.swin_block_backward(x, params, mask, dy, **kw), iters=10)
                plain_ms = cuda_ms(lambda: sb.swin_block_backward_reference(x, params, mask, dy,
                                                                            **kw),
                                   iters=3, warmup=1)
                unfused_ms = cuda_ms(unfused, iters=5, warmup=1)
                b_ms, b_by = block_bwd_bound(x, params, mask)
                plan = sb.backward_plan(x, h, params[10].shape[0], mask)
                kplan = {k: {kk: v for kk, v in kern.items() if kk != "threads"}
                         for k, kern in plan["kernels"].items()}
                r = {"level": s["level"], "B": B, "H": H, "W": W, "C": C, "heads": h,
                     "hd": s["hd"], "dtype": dtype, "mask": masked,
                     "train_dtype": train_block_dtype(int(s["level"][-1])), "max_abs_err": errs,
                     "rel_err": rel,
                     "worst": max(rels, key=rels.get), "tol": BWD_TOL[dtype], "ms": ms,
                     "plain_ms": plain_ms, "unfused_ms": unfused_ms, "bound_ms": b_ms,
                     "bound_by": b_by}
                results.append(r)
                log(f"[sb-bwd-plan] {s['level']} {H}x{W} C={C} h={h} B={B} {dtype} "
                    f"shift={shift}: {json.dumps(kplan)}; scratch {plan['scratch_bytes']} bytes "
                    f"(partials {plan['partial_bytes']}); global atomics per launch "
                    f"{plan['atomics']} by design (the machine code: phase 19's sb-bwd-sass), "
                    f"the per-window kernel's by its formula {plan['atomics_old']}")
                log(f"[sb-bwd-kernel] {s['level']} {H}x{W} C={C} h={h} hd={s['hd']} B={B} "
                    f"{dtype} shift={shift}: rel err {rel:.3g} (worst {r['worst']}; dx "
                    f"{rels['dx']:.3g}, bias {rels['bias']:.3g}, wq {rels['wq']:.3g}; tol "
                    f"{BWD_TOL[dtype]:g}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"unfused_ms={unfused_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"whole-block backward kernel disagrees with its plain "
                                     f"version: {r}")
        del blocks, x32, dy32, x, dy
        torch.cuda.empty_cache()
    return results, worst


def time_forward_per_step(shapes, dev, seed: int):
    """CUDA-event ms of the whole-block forward at every Swin-block shape of a
    training microbatch (B=8), each at its bf16-step dtype, with and without
    the shift and its mask; rows with the bound (the step's launches of each
    are counted in phase 20)."""
    import torch

    from dmhomo_torch.ops import swin_block as sb

    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    rows = []
    for s in shapes:
        B, H, W, C, h = MICROBATCH, s["H"], s["W"], s["C"], s["heads"]
        dtype = train_block_dtype(int(s["level"][-1]))
        blocks = seeded_swin_blocks(s, dev, gen)
        x = torch.randn(B, H, W, C, generator=gen, device=dev).to(getattr(torch, dtype))
        for masked in (False, True):
            with torch.inference_mode():
                params = blocks[masked].fused_params()
                mask, shift = blocks[masked].attn_mask, blocks[masked].shift_size
                kw = dict(num_heads=h, shift=shift)
                ms = cuda_ms(lambda: sb.swin_block(x, params, mask, **kw), iters=20)
                b_ms, b_by = block_bound(x, params, mask)
            rows.append({"level": s["level"], "B": B, "H": H, "W": W, "C": C, "heads": h,
                         "dtype": dtype, "mask": masked, "ms": ms, "bound_ms": b_ms,
                         "bound_by": b_by})
            log(f"[sb-train-fwd] {s['level']} {H}x{W} C={C} h={h} B={B} {dtype} shift={shift}: "
                f"ms={ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
        del blocks, x
    torch.cuda.empty_cache()
    return rows


def phase_train_fused(dev, batch, seed: int, window_step_ms: float, shapes, bwd_rows):
    """Phase 8 with ``attn_impl='fused_block'``: every Swin block of the step
    is one whole-block forward launch (and one more in the remat recompute)
    and one backward launch.  First the forward's CUDA-event time at the
    step's shapes (``time_forward_per_step``); each of those rows and of
    phase 19's (``bwd_rows``) gains its launches per step as the wrappers
    counted them in the timed steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import dmhomo_torch.models.swin as swin_mod
    from dmhomo_torch.ops import swin_block as sb
    from dmhomo_torch.ops import window_attention as wa
    from dmhomo_torch.train.config import HEMTrainConfig
    from dmhomo_torch.train.hem_trainer import HEMTrainer

    fwd_rows = time_forward_per_step(shapes, dev, seed)

    cfg = HEMTrainConfig(attn_impl="fused_block")
    trainer = HEMTrainer(cfg, steps_per_epoch=1000, device=dev)
    trainer.init_state(seed)
    swin = trainer.model.h_net.config
    if swin.attn_impl != "fused_block" or not swin.remat:
        raise SystemExit(f"attn_impl={swin.attn_impl!r} remat={swin.remat}: expected "
                         "'fused_block' with remat on, as the JAX trainer resolves it")
    counters = {"fwd": sb.swin_block, "bwd": sb.swin_block_backward,
                "wa_fwd": wa.window_attention, "wa_bwd": wa.window_attention_backward}
    blocks = sum(isinstance(m, swin_mod.SwinBlock) for m in trainer.model.h_net.modules())
    per_step = 2 * blocks * (BATCH // MICROBATCH)  # h_net runs twice per forward: 160
    want = {"fwd": 2 * per_step, "bwd": per_step, "wa_fwd": 0, "wa_bwd": 0}
    log(f"[sb-train] config bf16={cfg.bf16} grad_accum={cfg.grad_accum} "
        f"attn_impl={swin.attn_impl!r} remat={swin.remat}")
    losses, times, launches = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for step in range(WARMUP_STEPS + TIMED_STEPS):
        if step == WARMUP_STEPS:  # count the timed steps of the main path only
            for fn in counters.values():
                fn.launches = 0
            for fn in (sb.swin_block, sb.swin_block_backward):
                fn.launches_by_shape.clear()
        before = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        out = trainer.train_step(batch)
        loss = float(out["total"])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        launches.append({k: fn.launches - before[k] for k, fn in counters.items()})
        log(f"[sb-train] step {step + 1}: loss {loss:.5f}, {times[-1]:.1f} ms, launches "
            f"{launches[-1]}")
    totals = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.median(times[WARMUP_STEPS:]))
    if not np.isfinite(losses).all():
        raise SystemExit(f"training loss not finite: {losses}")
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    if not last < first:
        raise SystemExit(f"training loss did not fall: first steps {first}, last steps {last}")
    if any(n != want for n in launches[WARMUP_STEPS:]) or \
            totals != {k: v * TIMED_STEPS for k, v in want.items()}:
        raise SystemExit(f"launches per step {launches}, expected {want}")
    log(f"[sb-train] fused_block B={BATCH} (microbatches of {MICROBATCH}), bf16: first step "
        f"{times[0]:.1f} ms, steady {step_ms:.2f} ms (timed "
        f"{', '.join(f'{t:.1f}' for t in times[WARMUP_STEPS:])}), {1e3 * BATCH / step_ms:.2f} "
        f"training pairs/s, peak {peak / 2**30:.2f} GiB; phase 8's window-attention step "
        f"{window_step_ms:.2f} ms")
    log(f"[sb-train] loss mean of the first 3 steps {first:.5f} > last 3 {last:.5f}; launches "
        f"over {TIMED_STEPS} timed steps {totals} = per step {per_step} whole-block forwards, "
        f"{per_step} remat recomputes of them, {per_step} backwards, no window attention")
    # each shape's launches per step, as the wrappers counted them over the timed steps
    by_shape = {d: dict(fn.launches_by_shape)
                for d, fn in (("fwd", sb.swin_block), ("bwd", sb.swin_block_backward))}
    for d, rows in (("fwd", fwd_rows), ("bwd", bwd_rows)):
        step_rows = [r for r in rows if r.get("train_dtype", r["dtype"]) == r["dtype"]]
        for r in rows:
            r["launches_per_step"] = by_shape[d].get(shape_key(r), 0) / TIMED_STEPS
        if not all(r["launches_per_step"] for r in step_rows) or \
                sum(r["launches_per_step"] for r in rows) != want[d]:
            raise SystemExit(f"{d} launches per shape {by_shape[d]} do not cover the step's "
                             f"rows {[shape_key(r) for r in step_rows]}")
    fwd_step = {k: sum(r[k] * r["launches_per_step"] for r in fwd_rows)
                for k in ("ms", "bound_ms")}
    bwd_ms_per_step = sum(r["ms"] * r["launches_per_step"] for r in bwd_rows)
    log(f"[sb-train-fwd] whole-block forward per fused_block step by CUDA events, each shape "
        f"weighted by its counted launches: {fwd_step['ms']:.3f} ms over "
        f"{sum(r['launches_per_step'] for r in fwd_rows):g} launches (bound "
        f"{fwd_step['bound_ms']:.3f} ms, {100 * fwd_step['bound_ms'] / fwd_step['ms']:.1f}% of "
        f"it); the backward's per step (phase 19) {bwd_ms_per_step:.3f} ms; per shape "
        + ", ".join(f"{r['level']} C={r['C']} h={r['heads']} {r['dtype']} mask={r['mask']} "
                    f"x{r['launches_per_step']:g}" for r in fwd_rows))

    # the I/O dtype of each whole-block call of one step, in call order
    seen = []
    block = swin_mod.swin_block

    def spy(x, *args, **kw):
        seen.append(str(x.dtype).split(".")[-1])
        return block(x, *args, **kw)

    swin_mod.swin_block = spy
    try:
        trainer.train_step(batch)
    finally:
        swin_mod.swin_block = block
    expected = train_block_dtypes(trainer.model)
    # every forward of the step (4 microbatches, each recomputed) has that mix
    forwards = len(seen) // len(expected)
    counts = {d: seen.count(d) for d in sorted(set(seen))}
    if seen[:len(expected)] != expected or len(seen) != forwards * len(expected) or \
            counts != {d: forwards * expected.count(d) for d in counts}:
        raise SystemExit(f"block I/O dtypes of one forward {seen[:len(expected)]}, expected "
                         f"{expected}; {counts} over the step")
    log(f"[sb-train] block I/O dtypes of one forward (in call order, matching the JAX bf16 "
        f"estimator): {' '.join('bf16' if d == 'bfloat16' else 'f32' for d in expected[:20])} "
        f"(x2); the {len(seen)} whole-block forward calls of the step: {counts}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    events = kernel_events(prof.key_averages())
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if dev_ms <= 0:
        raise SystemExit("the profiler saw no device time")
    idle = max(0.0, 1.0 - dev_ms / step_ms)
    kern = {d: sum(e.self_device_time_total for e in events
                   if f"swin_block_{d}_" in e.key) / 1e3 for d in ("fwd", "bwd")}
    parts = {p: sum(e.self_device_time_total for e in events
                    if f"swin_block_bwd_{p}_kernel" in e.key) / 1e3
             for p in sb.BACKWARD_KERNELS}
    log(f"[sb-train-profile] one step: device busy {dev_ms:.2f} ms of the {step_ms:.2f} ms "
        f"unprofiled step: idle {100 * idle:.1f}%; whole-block forward kernel {kern['fwd']:.2f} "
        f"ms, backward kernels {kern['bwd']:.2f} ms ({', '.join(f'{p} {t:.2f}' for p, t in parts.items())})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
        log(f"[sb-train-profile] {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    return {"trainer": trainer, "by_shape": by_shape,
            "step_ms": step_ms, "peak": peak, "launches": totals, "idle": idle,
            "dev_ms": dev_ms, "kernel_ms": kern, "bwd_parts_ms": parts, "dtypes": expected[:20],
            "fwd_ms_per_step": fwd_step["ms"], "fwd_bound_ms_per_step": fwd_step["bound_ms"],
            "fwd_step_shapes": fwd_rows}


# ---------------------------------------------------------------------------
# the HEM step as a CUDA graph (phases 8b-8c, 20b-20c)
# ---------------------------------------------------------------------------

# each wrapper's kernel as the profiler names it (one device launch per call:
# the backwards' first kernel)
DEVICE_KERNEL = {"window_attention": "window_attention_fwd",
                 "window_attention_backward": "window_attention_bwd_kernel",
                 "swin_block": "swin_block_fwd_kernel",
                 "swin_block_backward": "swin_block_bwd_recompute_kernel"}
# graph vs eager, one fp32 step at the shipped shape (phase 25's rule): the
# losses relative, the BatchNorm statistics relative to their largest value,
# the weights within GRAPH_LR_FACTOR lr (an element whose gradient is near
# zero may move either way)
GRAPH_LOSS_TOL = 1e-5
GRAPH_BN_TOL = 1e-5
GRAPH_LR_FACTOR = 2.0
GRAPH_STEPS = 2  # the first eager (the warm-up before capture), then one replay


def phase_train_graph(trainer, batch, eager: dict, want: dict, by_shape: dict, tag: str):
    """Phases 8b and 20b: the eager phase's trainer, from where it left
    off, on its batch.  One eager step on the batch already on the card with
    any host sync an error; then ``train_steps``, one call per step: the
    first runs its step eagerly and captures the graph, 2 more warm up, 10
    are timed (host clock around ``synchronize()``); one call of 10 steps;
    the launches each replay makes (counted at capture, and by kernel name
    in a profiled replay) against the eager step's ``want``; device busy and
    idle share of the profiled replay."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dmhomo_torch.train.hem_trainer import LAUNCH_COUNTERS

    dev_batch = {k: torch.from_numpy(v).to(trainer.device) for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.train_step(dev_batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"[{tag}] one eager step on a batch already on the card under "
        "torch.cuda.set_sync_debug_mode('error'): no host sync")
    del dev_batch

    counted = {fn.__name__: fn.launches for fn in LAUNCH_COUNTERS}
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for step in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        out = trainer.train_steps([batch])
        loss = float(out["total"][0])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        if step == 0:
            # the first call's step ran eagerly (the wrappers counted it); no
            # replay ran Python, so nothing after it moves their counters
            moved = {fn.__name__: fn.launches - counted[fn.__name__] for fn in LAUNCH_COUNTERS}
            counted = {fn.__name__: fn.launches for fn in LAUNCH_COUNTERS}
    after = {fn.__name__: fn.launches - counted[fn.__name__] for fn in LAUNCH_COUNTERS}
    sg = trainer.step_graph
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved()
    timed = times[WARMUP_STEPS:]
    step_ms = float(np.median(timed))
    if not np.isfinite(losses).all():
        raise SystemExit(f"graph training loss not finite: {losses}")
    if sg.launches != want or moved != want or any(after.values()):
        raise SystemExit(f"launches per replay counted at capture {sg.launches}, by the "
                         f"eager first step {moved}, by the replays {after}; expected {want}")
    shapes = {n: {k: v / TIMED_STEPS for k, v in c.items()} for n, c in by_shape.items()}
    if {n: dict(sg.launches_by_shape[n]) for n in shapes} != shapes:
        raise SystemExit(f"launches per replay by shape {sg.launches_by_shape}, eager {shapes}")
    log(f"[{tag}] train_steps, one call per step: first call (an eager step, then the "
        f"capture) {times[0]:.1f} ms, steady {step_ms:.2f} ms (timed "
        f"{', '.join(f'{t:.1f}' for t in timed)}), {1e3 * BATCH / step_ms:.2f} training "
        f"pairs/s; eager step (this trainer's phase) {eager['step_ms']:.2f} ms; peak allocated "
        f"{peak / 2**30:.2f} GiB, reserved {reserved / 2**30:.2f} GiB (the graph's pool "
        f"included); losses {losses[0]:.5f} -> {losses[-1]:.5f}")
    shapes_seen = {n: {str(k): v for k, v in c.items()} for n, c in sg.launches_by_shape.items()
                   if c}
    log(f"[{tag}] launches per replay, counted at capture: {sg.launches} (the eager step's); "
        f"by shape {json.dumps(shapes_seen)}")

    t0 = time.perf_counter()
    out = trainer.train_steps([batch] * TIMED_STEPS)
    last = float(out["total"][-1])
    torch.cuda.synchronize()
    fused_ms = 1e3 * (time.perf_counter() - t0) / TIMED_STEPS
    log(f"[{tag}] train_steps of {TIMED_STEPS} steps in one call: {fused_ms:.2f} ms per step, "
        f"{1e3 * BATCH / fused_ms:.2f} training pairs/s (last loss {last:.5f})")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_steps([batch])
        torch.cuda.synchronize()
    events = kernel_events(prof.key_averages())
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if dev_ms <= 0:
        raise SystemExit("the profiler saw no device time in a replay")
    idle = max(0.0, 1.0 - dev_ms / step_ms)
    device = {n: sum(e.count for e in events if part in e.key)
              for n, part in DEVICE_KERNEL.items()}
    kernel_ms = {n: sum(e.self_device_time_total for e in events if part in e.key) / 1e3
                 for n, part in DEVICE_KERNEL.items()}
    if device != want:
        raise SystemExit(f"device-side launches in a profiled replay {device}, expected {want}")
    log(f"[{tag}-profile] one replayed step: device busy {dev_ms:.2f} ms of the {step_ms:.2f} ms "
        f"unprofiled step: idle {100 * idle:.1f}% (eager step idle "
        f"{100 * eager['idle']:.1f}%); device-side launches by kernel name {device}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[{tag}-profile] {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    return {"step_ms": step_ms, "pairs_per_s": 1e3 * BATCH / step_ms, "first_call_ms": times[0],
            "timed_ms": timed, "fused_call_ms_per_step": fused_ms, "idle": idle,
            "dev_ms": dev_ms, "peak_bytes": peak, "reserved_bytes": reserved,
            "launches_per_step": sg.launches, "device_launches": device,
            "kernel_ms": kernel_ms, "eager_step_ms": eager["step_ms"], "eager_idle": eager["idle"]}


def trainer_state(trainer) -> dict:
    """A HEM trainer's weights and BatchNorm running statistics, detached."""
    return {"params": {n: p.detach() for n, p in trainer.model.named_parameters()},
            "bn": {n: b.detach() for n, b in trainer.model.named_buffers() if "running_" in n}}


def step_diff(a_losses, a_state, b_losses, b_state) -> dict:
    """Phase 8c's measures of two training runs: the losses relative, the
    weights' largest difference, the BatchNorm statistics relative to their
    largest value."""
    import torch

    with torch.no_grad():
        loss = float(((a_losses.cpu() - b_losses.cpu()).abs() / b_losses.cpu().abs()).max())
        w = max(float((p.cpu() - b_state["params"][n].cpu()).abs().max())
                for n, p in a_state["params"].items())
        bn = max(float((v.cpu() - b_state["bn"][n].cpu()).abs().max())
                 / float(b_state["bn"][n].abs().max()) for n, v in a_state["bn"].items())
    return {"loss_rel": loss, "weight_abs": w, "bn_rel": bn}


def within_graph_rule(d: dict, lr: float) -> bool:
    return (d["loss_rel"] <= GRAPH_LOSS_TOL and d["weight_abs"] <= GRAPH_LR_FACTOR * lr
            and d["bn_rel"] <= GRAPH_BN_TOL)


def phase_graph_vs_eager(dev, batch, seed: int, attn_impl: str, tag: str):
    """Phases 8c and 20c: one fp32 graph step at the shipped shape (TF32
    off) against an eager one.  Three trainers from the same seed take
    GRAPH_STEPS steps on the batch: two by ``train_step``, one by one
    ``train_steps`` call (its first step eager, then one replay, whose
    forward reads the first step's weights and whose Adam update moves
    them): the losses, the BatchNorm statistics and the weights after it.
    The two eager trainers give the run-to-run spread of the eager step
    (cuDNN's backward is not bit-reproducible) beside it."""
    import dataclasses

    import torch

    from dmhomo_torch.train.config import HEMTrainConfig
    from dmhomo_torch.train.hem_trainer import HEMTrainer

    cfg = dataclasses.replace(HEMTrainConfig(), bf16=False, attn_impl=attn_impl)
    eager, again, graph = (HEMTrainer(cfg, steps_per_epoch=1000, device=dev) for _ in range(3))
    for t in (eager, again, graph):
        t.init_state(seed + 2)
    start = {n: p.detach().clone() for n, p in eager.model.named_parameters()}
    want = torch.stack([eager.train_step(batch)["total"] for _ in range(GRAPH_STEPS)])
    spread = torch.stack([again.train_step(batch)["total"] for _ in range(GRAPH_STEPS)])
    got = graph.train_steps([batch] * GRAPH_STEPS)["total"]
    torch.cuda.synchronize()

    def differ(a, b):
        return step_diff(a[0], trainer_state(a[1]), b[0], trainer_state(b[1]))

    d = differ((got, graph), (want, eager))
    noise = differ((spread, again), (want, eager))
    with torch.no_grad():
        moved = max(float((p - start[n]).abs().max()) for n, p in eager.model.named_parameters())
    log(f"[{tag}] attn_impl={attn_impl!r}, fp32, B={BATCH} in microbatches of {MICROBATCH}: "
        f"{GRAPH_STEPS} steps eager vs train_steps (step 1 eager, then a replay): losses "
        f"{', '.join(f'{x:.8f}' for x in want.tolist())} vs "
        f"{', '.join(f'{x:.8f}' for x in got.tolist())}: rel {d['loss_rel']:.3g} (tol "
        f"{GRAPH_LOSS_TOL:g}); weights max |graph - eager| {d['weight_abs']:.3g} (tol "
        f"{GRAPH_LR_FACTOR:g} lr = {GRAPH_LR_FACTOR * cfg.lr:g}; the steps moved them by up to "
        f"{moved:.3g}); BatchNorm statistics {d['bn_rel']:.3g} of their largest value (tol "
        f"{GRAPH_BN_TOL:g}); two eager runs differ by {json.dumps(noise)}")
    if not within_graph_rule(d, cfg.lr):
        raise SystemExit(f"graph and eager steps disagree: {d}")
    del eager, again, graph
    torch.cuda.empty_cache()
    return {**d, "eager_vs_eager": noise, "weights_moved": moved}


# ---------------------------------------------------------------------------
# DGM training (phases 22-25)
# ---------------------------------------------------------------------------


def dgm_condition_pool(n: int, size: int, classes: int, seed: int, dev):
    """n synthetic conditions (numpy draws from ``seed``) and their classes,
    on the device."""
    import torch

    from dmhomo_torch.data.conditions import synthetic_condition_batches

    cond, cls = next(synthetic_condition_batches(n, size, n, classes, seed))
    return torch.from_numpy(cond).to(dev), torch.from_numpy(cls.astype(np.int64)).to(dev)


def la_counts():
    from dmhomo_torch.ops import linear_attention as la

    return la.linear_attention_pass1.launches, la.linear_attention_pass2.launches


class PlainLinearAttentionRefused:
    """Inside it, the plain linear-attention passes raise: the DGM training
    and generation paths on the card must not reach them."""

    NAMES = ("linear_attention_pass1_reference", "linear_attention_pass2_reference",
             "linear_attention_reference")

    def __enter__(self):
        from dmhomo_torch.ops import linear_attention as la

        def refuse(*_, **__):
            raise SystemExit("the plain linear attention ran on a path of the card's kernels")

        self.saved = {n: getattr(la, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(la, n, refuse)
        return self

    def __exit__(self, *exc):
        from dmhomo_torch.ops import linear_attention as la

        for n, fn in self.saved.items():
            setattr(la, n, fn)
        return False


def dgm_trainer_that_fits(base, dev, seed: int, batch_of):
    """The shipped config with the fewest microbatches that fit (the first
    step of DGM_MICROBATCHES that does not run out of memory; remat on at
    the last only if none does), after its first step: (trainer, first
    step ms, the attempts)."""
    import dataclasses
    import gc

    import torch

    from dmhomo_torch.train.dgm_trainer import DGMTrainer

    B = base.train_batch_size
    tries = [(mb, False) for mb in DGM_MICROBATCHES] + [(DGM_MICROBATCHES[-1], True)]
    attempts = []
    for mb, remat in tries:
        cfg = dataclasses.replace(base, gradient_accumulate_every=B // mb,
                                  unet=dataclasses.replace(base.unet, remat=remat))
        trainer = DGMTrainer(cfg, device=dev)
        trainer.init_state(seed)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        t0 = time.perf_counter()
        try:
            with PlainLinearAttentionRefused():
                out = trainer.train_step(*batch_of(0), generator=gen)
                float(out["loss"])
            first_ms = 1e3 * (time.perf_counter() - t0)
            attempts.append((mb, remat, "fits"))
            return trainer, gen, first_ms, attempts
        except torch.cuda.OutOfMemoryError:
            attempts.append((mb, remat, "out of memory"))
        log(f"[dgm-train] microbatch {mb} (accum {B // mb}, remat {remat}) does not fit the card")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    raise SystemExit(f"no DGM training microbatch fits the card: {attempts}")


def phase_dgm_train(dev, seed: int):
    """The shipped DGM training step: the fewest microbatches that fit, 3
    warm-up steps, then 13 timed ones counted from zero."""
    import torch

    from dmhomo_torch.train.config import DGMTrainConfig

    base = DGMTrainConfig()  # shipped: bf16, batch 128, 256x256, dim 64, 5 classes
    B, S = base.train_batch_size, base.diffusion.image_size
    t0 = time.perf_counter()
    cond, cls = dgm_condition_pool(B + DGM_HELD_OUT, S, base.unet.num_classes, seed, dev)
    train_c, train_k, held_c, held_k = cond[:B], cls[:B], cond[B:], cls[B:]
    rng = np.random.default_rng(seed)
    idx = [torch.from_numpy(rng.integers(0, B, B)).to(dev)
           for _ in range(DGM_WARMUP_STEPS + DGM_TIMED_STEPS)]

    def batch_of(step):
        return train_c[idx[step]], train_k[idx[step]]

    log(f"[dgm-train] {B + DGM_HELD_OUT} synthetic conditions {tuple(cond.shape)} on the card "
        f"in {time.perf_counter() - t0:.1f} s; config bf16={base.bf16} batch {B} lr={base.lr} "
        f"clip {base.grad_clip_norm} EMA {base.ema_beta} every {base.ema_update_every}")
    trainer, gen, first_ms, attempts = dgm_trainer_that_fits(base, dev, seed, batch_of)
    cfg = trainer.config
    accum, remat = cfg.gradient_accumulate_every, cfg.unet.remat
    mb = B // accum
    n_params = sum(p.numel() for p in trainer.model.parameters())
    log(f"[dgm-train] UNet {n_params:,} parameters; microbatch {mb} (accum {accum}, remat "
        f"{remat}) after {attempts}; first step {first_ms:.1f} ms")
    held_draws = trainer.gd.draw(DGM_HELD_OUT, S, torch.Generator(device=dev).manual_seed(seed + 7),
                                 dev)

    def held_loss():
        with torch.no_grad():
            return float(trainer.gd.loss(held_c, held_k, draws=held_draws))

    losses = []
    for step in range(1, DGM_WARMUP_STEPS):
        losses.append(float(trainer.train_step(*batch_of(step), generator=gen)["loss"]))
    before = held_loss()
    from dmhomo_torch.models.unet import LinearAttention

    n_sites = sum(isinstance(m, LinearAttention) for m in trainer.model.modules())  # 8 as shipped
    per_step = n_sites * accum * (2 if remat else 1)
    times, launches, at_step_10 = [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    from dmhomo_torch.ops import linear_attention as la

    # the main path: counts from zero just before it, read just after
    la.linear_attention_pass1.launches = la.linear_attention_pass2.launches = 0
    with PlainLinearAttentionRefused():
        for step in range(DGM_WARMUP_STEPS, DGM_WARMUP_STEPS + DGM_TIMED_STEPS):
            c0 = la_counts()
            t0 = time.perf_counter()
            out = trainer.train_step(*batch_of(step), generator=gen)
            losses.append(float(out["loss"]))  # waits for the step
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            launches.append(tuple(b - a for a, b in zip(c0, la_counts())))
            if trainer.step == 10:
                at_step_10 = [p.detach().clone() for p in trainer.model.parameters()]
            log(f"[dgm-train] step {trainer.step}: loss {losses[-1]:.5f}, grad norm "
                f"{float(out['grad_norm']):.4f}, {times[-1]:.1f} ms, launches pass 1/2 "
                f"{launches[-1][0]}/{launches[-1][1]}")
    total = la_counts()
    peak = torch.cuda.max_memory_allocated()
    after = held_loss()
    step_ms = float(np.median(times))
    if not np.isfinite(losses).all() or not np.isfinite([before, after]).all():
        raise SystemExit(f"DGM training loss not finite: {losses}, held-out {before} {after}")
    if not after < before:
        raise SystemExit(f"DGM training loss did not fall on the held-out batch: {before} -> {after}")
    if any(l != (per_step, per_step) for l in launches) or \
            total != (per_step * DGM_TIMED_STEPS,) * 2:
        raise SystemExit(f"linear-attention launches per step {launches}, expected {per_step} "
                         f"of each ({n_sites} sites x {accum} microbatches"
                         f"{' x 2 (remat)' if remat else ''})")
    ema_ok = trainer.ema.step == trainer.step == DGM_WARMUP_STEPS + DGM_TIMED_STEPS and all(
        torch.equal(e, p) for e, p in zip(trainer.ema.params, at_step_10))
    if not ema_ok:
        raise SystemExit("the EMA after 16 steps is not the weights after step 10 (decay 0 "
                         "before step 100, an update every 10 steps)")
    log(f"[dgm-train] shipped config B={B} (microbatches of {mb}, remat {remat}), bf16: steady "
        f"{step_ms:.2f} ms per step (timed {', '.join(f'{t:.1f}' for t in times)}), "
        f"{1e3 * B / step_ms:.3f} training samples/s, peak {peak / 2**30:.2f} GiB "
        f"({peak / 2**30 / mb:.3f} GiB per sample of a microbatch)")
    log(f"[dgm-train] held-out loss (fixed t, noise, keep-mask; {DGM_HELD_OUT} conditions) "
        f"{before:.5f} before the timed steps > {after:.5f} after; linear-attention launches "
        f"over {DGM_TIMED_STEPS} timed steps: pass 1 {total[0]}, pass 2 {total[1]} = {per_step} "
        f"+ {per_step} per step, none of the plain version; the EMA after step "
        f"{trainer.step} equals the weights after step 10")
    return {"trainer": trainer, "gen": gen, "batch": batch_of(0), "step_ms": step_ms,
            "samples_per_s": 1e3 * B / step_ms, "peak": peak, "microbatch": mb,
            "accum": accum, "remat": remat, "attempts": attempts, "launches": total,
            "launches_per_step": per_step, "held_loss": [before, after], "losses": losses,
            "first_ms": first_ms, "times": times}


# device-op categories of the DGM step's profile, by kernel name
DGM_OP_GROUPS = {
    "linear-attention pass 1": r"linear_attention_(pass1|reduce)",
    "linear-attention pass 2": r"linear_attention_pass2",
    "GroupNorm": r"(?i)group_?norm",
    "convolutions": r"(?i)conv|cudnn|xmma|implicit_?gemm|dgrad|wgrad|fprop",
}


def phase_dgm_profile(dgm):
    """One shipped DGM step under torch.profiler; idle share against phase
    22's unprofiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trainer = dgm["trainer"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(*dgm["batch"], generator=dgm["gen"])
        torch.cuda.synchronize()
    averages = prof.key_averages()
    events = kernel_events(averages)
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if dev_ms <= 0:
        raise SystemExit("the profiler saw no device time")
    idle = max(0.0, 1.0 - dev_ms / dgm["step_ms"])
    groups = {name: sum(e.self_device_time_total for e in events if re.search(pat, e.key)) / 1e3
              for name, pat in DGM_OP_GROUPS.items()}
    # the kernels launched inside the backward's range, by its host-side event
    bwd = [e for e in averages if e.key == "linear_attention_backward"
           and e.device_type.name == "CPU"]
    groups["linear-attention backward (its profiler range)"] = (
        sum(e.device_time_total for e in bwd) / 1e3 if bwd else None)
    log(f"[dgm-profile] one step: device busy {dev_ms:.2f} ms of the {dgm['step_ms']:.2f} ms "
        f"unprofiled step: idle {100 * idle:.1f}%; " + "; ".join(
            f"{k} {'not measured' if v is None else f'{v:.2f} ms'}" for k, v in groups.items()))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        log(f"[dgm-profile] {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    # launches by kernel name: pass 1, its reduction (one after each pass-1
    # launch), pass 2
    by_name = {n: sum(e.count for e in events if n in e.key)
               for n in ("linear_attention_pass1", "linear_attention_reduce",
                         "linear_attention_pass2")}
    ok = all(v == dgm["launches_per_step"] for v in by_name.values())
    log(f"[dgm-profile] launches by name {by_name}, expected {dgm['launches_per_step']} each "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"the profiled DGM step launched {by_name}")
    return {"busy_ms": dev_ms, "idle": idle, "groups_ms": groups, "launches_by_name": by_name}


def la_backward_bound(x, pass_dtype: str):
    """(ms, 'bytes' | 'operations') of one backward with the prenorm at x
    (B, N, C), counting what ``linear_attention_backward`` reads and writes:
    reads x, w_qkv, g, the fp32 statistics and dout, writes dx, dW and dg;
    operations per token: the recomputed projection and the dx and dW
    products (2*C*384 flops each), the six per-head products (E, num, deq,
    dC, v.dE^T, ek.dE: 2*4*32*32 each) and the statistics' two products
    with u = g.W (2*384 each)."""
    from dmhomo_torch.ops.linear_attention import HIDDEN

    B, N, C = x.shape
    F = 3 * HIDDEN
    el = x.element_size()
    nbytes = (2 * B * N * C * el + 2 * (C * F * 4 + C * 4) + B * N * 8 + B * N * HIDDEN * el)
    flops = 2.0 * B * N * (3 * C * F + 6 * 4096 + 2 * F)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[pass_dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def phase_la_backward(sites, dev, seed: int, B: int):
    """The Function's backward vs autograd of the plain version at every
    UNet site, B = the training microbatch, channel-major, prenorm."""
    import torch

    from dmhomo_torch.ops import linear_attention as la

    gen = torch.Generator(device=dev).manual_seed(seed + 24)
    rows, worst = [], {}
    for site, hw, C in sites:
        N = hw * hw
        x32 = (1.5 * torch.randn(B, C, N, generator=gen, device=dev) + 0.3).transpose(1, 2)
        w = torch.randn(C, 3 * la.HIDDEN, generator=gen, device=dev) / C**0.5
        g = 0.5 + torch.rand(C, generator=gen, device=dev)
        dout32 = torch.randn(B, la.HIDDEN, N, generator=gen, device=dev).transpose(1, 2)
        for dtype in ("float32", "bfloat16"):
            x = x32.to(getattr(torch, dtype)).requires_grad_()
            wl, gl = w.clone().requires_grad_(), g.clone().requires_grad_()
            dout = dout32.to(x.dtype)
            c0 = la_counts()
            out = la.linear_attention(x, wl, prenorm=(gl,))
            launched = tuple(b - a for a, b in zip(c0, la_counts()))
            got = torch.autograd.grad(out, (x, wl, gl), dout, retain_graph=True)
            ms, bursts = burst_ms(lambda: torch.autograd.grad(out, (x, wl, gl), dout,
                                                               retain_graph=True), iters=3)
            ref = la.linear_attention_reference(x, wl, prenorm=(gl,))
            out_err = rel_err(out.detach(), ref.detach())
            worst[(dtype, "out")] = max(worst.get((dtype, "out"), 0.0), out_err)
            want = torch.autograd.grad(ref, (x, wl, gl), dout, retain_graph=True)
            plain_ms, _ = burst_ms(lambda: torch.autograd.grad(ref, (x, wl, gl), dout,
                                                               retain_graph=True),
                                   iters=1, bursts=3)
            del ref
            torch.cuda.synchronize()
            errs, truth_errs = {}, {}
            for name, a, b in zip(("dx", "dW", "dg"), got, want):
                errs[name] = rel_err(a, b)
                worst[(dtype, name)] = max(worst.get((dtype, name), 0.0), errs[name])
            if dtype == "bfloat16":  # both against the fp32 gradient at the same bf16 inputs
                xt = x.detach().float().requires_grad_()
                truth = torch.autograd.grad(la.linear_attention_reference(xt, wl, prenorm=(gl,)),
                                            (xt, wl, gl), dout.float())
                for name, a, b, t in zip(("dx", "dW", "dg"), got, want, truth):
                    truth_errs[name] = (rel_err(a, t), rel_err(b, t))
                del xt, truth
            finite = all(bool(torch.isfinite(a).all()) for a in (out, *got))
            bnd, by = la_backward_bound(x, dtype)
            truth_log = "".join(f"; {k} to the fp32 gradient: {f:.3g} (plain bf16 {p:.3g})"
                            for k, (f, p) in truth_errs.items())
            ok = finite and launched == (1, 1) and out_err <= LA_TOL[dtype] \
                and max(errs.values()) <= LA_BWD_TOL[dtype] and got[0].stride(1) == 1
            rows.append({"site": site, "N": N, "C": C, "B": B, "dtype": dtype,
                         "rel_err_out": out_err, "out_tol": LA_TOL[dtype], **{
                f"rel_err_{k}": v for k, v in errs.items()}, "tol": LA_BWD_TOL[dtype],
                "rel_err_to_fp32_function_plain": truth_errs,
                "ms": ms, "ms_bursts": bursts, "plain_autograd_ms": plain_ms,
                "bound_ms": bnd, "bound_by": by})
            log(f"[la-bwd] {site} N={N} C={C} B={B} {dtype}: forward rel err {out_err:.3g} "
                f"(tol {LA_TOL[dtype]:g}); rel err dx {errs['dx']:.3g} dW "
                f"{errs['dW']:.3g} dg {errs['dg']:.3g} (tol {LA_BWD_TOL[dtype]:g}){truth_log}; backward "
                f"{ms:.4f} ms (bursts {spread(bursts)}; bound {bnd:.4f} {by}: "
                f"{100 * bnd / ms:.1f}% of it); autograd of the plain version {plain_ms:.4f} ms; "
                f"forward launches {launched} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"the linear-attention forward or backward disagrees with the "
                                 f"plain version, or dx lost x's layout: {rows[-1]}")
            del x, wl, gl, out, got, want, dout
        del x32, dout32
        torch.cuda.empty_cache()
    return rows, worst


def phase_dgm_card_vs_cpu(dev, seed: int):
    """One fp32 DGM step of the full-width UNet at DGM_CPU_SIZE², the same
    weights and injected draws on the card and on the CPU."""
    import dataclasses

    import torch

    from dmhomo_torch.data.conditions import synthetic_condition_batches
    from dmhomo_torch.train.config import DGMTrainConfig
    from dmhomo_torch.train.dgm_trainer import DGMTrainer

    base = DGMTrainConfig()
    cfg = dataclasses.replace(
        base, bf16=False, train_batch_size=DGM_CPU_BATCH, gradient_accumulate_every=DGM_CPU_ACCUM,
        ema_update_every=1, diffusion=dataclasses.replace(base.diffusion, image_size=DGM_CPU_SIZE))
    S, mb = DGM_CPU_SIZE, DGM_CPU_BATCH // DGM_CPU_ACCUM
    cond, cls = next(synthetic_condition_batches(DGM_CPU_BATCH, S, DGM_CPU_BATCH,
                                                 base.unet.num_classes, seed + 25))
    rng = np.random.default_rng(seed + 25)
    draws = [(rng.integers(0, base.diffusion.timesteps, (mb,)),
              rng.normal(size=(mb, S, S, base.unet.channels)).astype(np.float32),
              np.array([True, False][:mb])) for _ in range(DGM_CPU_ACCUM)]
    nudged = (cond + STEP_INPUT_NOISE * rng.normal(size=cond.shape)).astype(np.float32)
    trainers = {"card": DGMTrainer(cfg, device=dev), "cpu": DGMTrainer(cfg, device="cpu")}
    for tr in trainers.values():
        tr.init_state(seed + 25)
    t0 = time.perf_counter()
    trainers["cpu"].loss_and_grads(nudged, cls, draws=draws)
    g_nudged = {n: p.grad.clone() for n, p in trainers["cpu"].model.named_parameters()}
    results = {}
    for where, tr in trainers.items():
        loss = float(tr.loss_and_grads(cond, cls, draws=draws))
        results[where] = (loss, {n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()})
    cpu_s = time.perf_counter() - t0
    (loss_card, g_card), (loss_cpu, g_cpu) = results["card"], results["cpu"]
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)

    def rel(a, g):
        return float((a - g).abs().max()) / max(float(g.abs().max()), 1e-30)

    rels = {n: rel(g_card[n], g) for n, g in g_cpu.items()}
    noise = {n: rel(g_nudged[n], g) for n, g in g_cpu.items()}
    tols = {n: max(STEP_GRAD_TOL, STEP_NOISE_FACTOR * noise[n]) for n in g_cpu}
    order = sorted(rels, key=lambda n: -rels[n] / tols[n])
    named = ("downs.0.2.fn.fn.to_qkv.weight", "downs.0.2.fn.norm.g", "ups.1.2.fn.fn.to_qkv.weight",
             "mid_attn.fn.fn.to_qkv.weight", "init_conv.weight", "final_conv.weight")
    log(f"[dgm-card-vs-cpu] fp32 step at {S}x{S}, batch {DGM_CPU_BATCH} in {DGM_CPU_ACCUM} "
        f"microbatches: loss card {loss_card:.7f} cpu {loss_cpu:.7f}: rel {loss_rel:.3g} (tol "
        f"{STEP_LOSS_TOL:g}); the CPU's three passes {cpu_s:.1f} s")
    for n in named:
        log(f"[dgm-card-vs-cpu] grad {n} {tuple(g_cpu[n].shape)}: {rels[n]:.3g} of its largest "
            f"value; the CPU's own change for conditions nudged by {STEP_INPUT_NOISE:g}: "
            f"{noise[n]:.3g}; tol {tols[n]:.3g}")
    log(f"[dgm-card-vs-cpu] closest to their tolerance of all {len(rels)} parameters: "
        + ", ".join(f"{n} {rels[n]:.3g} (tol {tols[n]:.3g})" for n in order[:3]))
    bad = [n for n in order if not rels[n] <= tols[n]]
    if bad or not loss_rel <= STEP_LOSS_TOL:
        raise SystemExit(f"card and CPU DGM steps disagree: loss {loss_rel}, gradients "
                         f"{[(n, rels[n], tols[n]) for n in bad]}")
    upd = {w: tr.apply_gradients() for w, tr in trainers.items()}
    norm_rel = abs(float(upd["card"]["grad_norm"]) - float(upd["cpu"]["grad_norm"])) / float(
        upd["cpu"]["grad_norm"])
    scale_rel = abs(float(upd["card"]["clip_scale"]) - float(upd["cpu"]["clip_scale"])) / float(
        upd["cpu"]["clip_scale"])
    lr = cfg.lr
    p_card = [p.detach().cpu() for p in trainers["card"].model.parameters()]
    p_cpu = [p.detach() for p in trainers["cpu"].model.parameters()]
    d = torch.cat([(a - b).abs().flatten() for a, b in zip(p_card, p_cpu)])
    off = float((d > 1e-6).float().mean())
    ema_same = all(torch.equal(e.cpu(), p) for e, p in zip(trainers["card"].ema.params, p_card)) \
        and all(torch.equal(e, p) for e, p in zip(trainers["cpu"].ema.params, p_cpu))
    log(f"[dgm-card-vs-cpu] clip: global norm {float(upd['cpu']['grad_norm']):.5f} (card rel "
        f"{norm_rel:.3g}), scale rel {scale_rel:.3g}; after Adam the weights differ by at most "
        f"{float(d.max()):.3g} (2 lr = {2 * lr:g}), {100 * off:.3f}% of them by more than 1e-6; "
        f"the EMA (update every step, decay 0) equals the weights on both: {ema_same}")
    if not (norm_rel <= STEP_GRAD_TOL and scale_rel <= STEP_GRAD_TOL
            and float(d.max()) <= 2 * lr + 1e-6 and off < 0.01 and ema_same):
        raise SystemExit("card and CPU disagree on the clipped Adam update or the EMA")
    return {"loss_rel": loss_rel, "grad_rel": {n: rels[n] for n in named},
            "grad_rel_nudged_cpu": {n: noise[n] for n in named}, "norm_rel": norm_rel,
            "param_max_diff": float(d.max()), "param_frac_over_1e-6": off}


# ---------------------------------------------------------------------------
# phase 26: the data pipeline end to end
# ---------------------------------------------------------------------------

PIPE_N = 100  # synthetic raw pairs at 360x640: 4 generation batches of GEN_BS
PIPE_SRC_HW = (360, 640)
COND_TOL = {"image": 1e-5, "rgb_flow": 1e-5, "flow": 1e-4}  # card vs CPU; the mask exact
COND_CHANNELS = {"image": slice(0, 6), "mask": slice(6, 7), "rgb_flow": slice(7, 10),
                 "flow": slice(10, 12)}
PIPE_WORKERS, PIPE_PREFETCH = 4, 2  # hem_train's loader
HOST_GRAY_TOL = 0.03  # host pipeline's uint8 resize vs the device's float resize


def trace_copies(prof, path: str, compute_part: str):
    """From a profile's trace: the host-to-device copies (name, stream, bytes,
    ms) and the streams that ran kernels whose name holds ``compute_part``."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    copies = [(e["name"], e.get("args", {}).get("stream"), e.get("args", {}).get("bytes", 0),
               e.get("dur", 0) / 1e3)
              for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    compute = {e.get("args", {}).get("stream") for e in events
               if e.get("cat") == "kernel" and compute_part in e.get("name", "")}
    return copies, compute


def streamed_step_copies(samples: str, seed: int) -> dict:
    """The host-to-device copies of one streamed replay of the shipped HEM
    step, by torch.profiler's trace, in the process that runs this (a fresh
    one: after earlier profiler sessions and a graph capture in the same
    process the trace carries no copies at all, as phase 8b's profile of the
    full run shows): the trainer from the files of ``samples`` as phase 26
    builds it, one eager step, two replays, then a profiled replay."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dmhomo_torch.data.hem_data import HEMTrainDataset
    from dmhomo_torch.data.loader import DataLoader, cycle
    from dmhomo_torch.train.config import HEMTrainConfig
    from dmhomo_torch.train.hem_trainer import HEMTrainer
    from dmhomo_torch.utils.device import resolve_device

    cfg = HEMTrainConfig()
    est = cfg.estimator
    ds = HEMTrainDataset(samples, est.crop_size, est.ori_size, cfg.rho,
                         rng=np.random.default_rng(seed))
    dl = DataLoader(ds, cfg.train_batch_size, seed=seed, num_workers=PIPE_WORKERS,
                    prefetch=PIPE_PREFETCH, pin_memory=True)
    stream = cycle(dl)
    trainer = HEMTrainer(cfg, steps_per_epoch=len(dl), device=resolve_device("cuda"))
    trainer.init_state(seed)
    for _ in range(3):
        trainer.train_steps([next(stream)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_steps([next(stream)])
        torch.cuda.synchronize()
    copies, compute = trace_copies(prof, os.path.join(os.path.dirname(samples), "step.json"),
                                   "window_attention")
    stream.close()
    dl.close()
    return {"copies": copies, "compute_streams": sorted(compute)}


def phase_pipeline(dev, seed: int, tmp: str):
    """make_conditions -> dgm_sample --conditions -> make_samples -> HEM
    training streamed from the per-sample files, through the CLIs' entry
    points, under ``tmp``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dmhomo_torch.cli import dgm_sample, hem_train, make_conditions, make_samples
    from dmhomo_torch.models.unet import UNetConfig
    from dmhomo_torch.data.conditions import build_conditions
    from dmhomo_torch.data.hem_data import HEMTrainDataset, device_build_patches
    from dmhomo_torch.data.loader import DataLoader, collate, cycle
    from dmhomo_torch.data.shards import load_generation_shard
    from dmhomo_torch.geometry.homography import homography_to_flow
    from dmhomo_torch.ops import linear_attention as la
    from dmhomo_torch.train.config import HEMTrainConfig
    from dmhomo_torch.train.hem_trainer import LAUNCH_COUNTERS, HEMTrainer
    from dmhomo_torch.utils.checkpoint import checkpoint_path

    t_phase = time.perf_counter()
    out = {}
    # a. conditions on the card, through the CLI; then the build alone, and the CPU's
    cdir = os.path.join(tmp, "conditions")
    t0 = time.perf_counter()
    cache = make_conditions.main(["--synthetic", str(PIPE_N), "--out", cdir, "--seed", str(seed),
                                  "--src-hw", ",".join(map(str, PIPE_SRC_HW)),
                                  "--image-size", str(GEN_SIZE)])
    cli_ms = 1e3 * (time.perf_counter() - t0)
    counts = np.bincount(cache.classes, minlength=5).tolist()
    if cache.conditions.shape != (PIPE_N, GEN_SIZE, GEN_SIZE, 12) or counts != [PIPE_N // 5] * 5:
        raise SystemExit(f"condition cache {cache.conditions.shape}, class counts {counts}")
    t0 = time.perf_counter()
    raw = list(make_conditions.synthetic_raw_samples(PIPE_N, PIPE_SRC_HW, seed))
    raw_ms = 1e3 * (time.perf_counter() - t0)
    cols = list(zip(*raw))[:4]
    times = []
    for _ in range(3):  # the first builds the device tables
        t0 = time.perf_counter()
        for b in range(0, PIPE_N, 32):
            build_conditions(*(c[b:b + 32] for c in cols), GEN_SIZE, PIPE_SRC_HW, device=dev)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    cond_ms = float(np.median(times[1:])) / PIPE_N
    cpu = np.concatenate([build_conditions(*(c[b:b + 32] for c in cols), GEN_SIZE, PIPE_SRC_HW,
                                           device="cpu").numpy() for b in range(0, PIPE_N, 32)])
    card = np.asarray(cache.conditions)
    diffs = {k: float(np.abs(card[..., sl] - cpu[..., sl]).max())
             for k, sl in COND_CHANNELS.items()}
    log(f"[pipe-conditions] make_conditions --synthetic {PIPE_N} at {PIPE_SRC_HW} -> "
        f"{GEN_SIZE}: cache {cache.conditions.shape}, class counts RE/LT/LL/SF/LF {counts}; the "
        f"CLI {cli_ms:.1f} ms ({cli_ms / PIPE_N:.2f} ms per condition, the raw pairs' numpy "
        f"draws {raw_ms / PIPE_N:.2f} of it); build_conditions on the card in batches of 32 "
        f"(host upload included) {cond_ms:.3f} ms per condition (runs "
        f"{', '.join(f'{t:.1f}' for t in times)} ms)")
    log(f"[pipe-conditions] card vs CPU on the same {PIPE_N} raw pairs: {json.dumps(diffs)} "
        f"(tolerances {json.dumps(COND_TOL)}, the mask exact)")
    if diffs["mask"] != 0.0 or any(not diffs[k] <= tol for k, tol in COND_TOL.items()):
        raise SystemExit(f"conditions on the card and the CPU disagree: {diffs}")
    out["conditions"] = {"cli_ms": cli_ms, "raw_ms": raw_ms, "build_ms_per_condition": cond_ms,
                         "build_runs_ms": times, "card_vs_cpu": diffs, "class_counts": counts}
    del cpu, card, raw, cols

    # b. generation on the built conditions at dgm_sample's defaults
    gdir = os.path.join(tmp, "gen")
    la.linear_attention_pass1.launches = la.linear_attention_pass1.elementwise = 0
    la.linear_attention_pass2.launches = la.linear_attention_pass2.elementwise = 0
    t0 = time.perf_counter()
    with PlainLinearAttentionRefused():
        gen = dgm_sample.main(["--conditions", cdir, "--num-classes", "5",
                               "--batches", str(PIPE_N // GEN_BS),
                               "--exp", "pipeline", "--out", gdir, "--seed", str(seed)])
    torch.cuda.synchronize()
    gen_ms = 1e3 * (time.perf_counter() - t0)
    launches = la_counts()
    elementwise = (la.linear_attention_pass1.elementwise, la.linear_attention_pass2.elementwise)
    batches = PIPE_N // GEN_BS
    want = GEN_STEPS * len(linear_attention_sites(UNetConfig(), GEN_SIZE)) * batches
    if launches != (want, want) or elementwise != (0, 0) or gen["samples"] != PIPE_N:
        raise SystemExit(f"generation: {gen['samples']} samples, launches {launches} "
                         f"(element-wise loader {elementwise}), expected {want} each")
    homos = np.concatenate([np.asarray(b["homos"]) for p in gen["shards"]
                            for b in load_generation_shard(p)])
    flows = homography_to_flow(torch.from_numpy(homos).float(), GEN_SIZE, GEN_SIZE).numpy()
    fit_err = float(np.abs(flows - np.asarray(cache.conditions[..., 10:12])).max())
    log(f"[pipe-generate] dgm_sample --conditions ({batches} batches of {GEN_BS}, defaults: "
        f"bf16, {GEN_STEPS} DDIM steps, CFG {3.0:g}, seeded random weights): {gen_ms:.0f} ms "
        f"with the sampler's set-up, {gen['samples_per_s']:.3f} samples/s after the first "
        f"batch; linear-attention launches {launches} = {want // batches} + {want // batches} "
        f"per batch, none element-wise, the plain version never called; fitted H within "
        f"{fit_err:.3g} px of the condition flows (tol {FIT_TOL_PX:g})")
    if not fit_err <= FIT_TOL_PX:
        raise SystemExit(f"fitted homographies miss the condition flows by {fit_err} px")
    out["generate"] = {"ms": gen_ms, "samples_per_s": gen["samples_per_s"],
                       "launches": launches, "launches_per_batch": want // batches,
                       "fit_px": fit_err}

    # c. per-sample files
    sdir = os.path.join(tmp, "samples")
    n = make_samples.main(["--shards", os.path.join(gdir, "pipeline", "dataset", "*.npy"),
                           "--out", sdir, "--warp-check", os.path.join(tmp, "warp_check")])
    # phase 31 (c): a warp-consistency GIF per shard, from this same call
    out["warp_check"] = warp_check_files(
        os.path.join(tmp, "warp_check"),
        len(glob.glob(os.path.join(gdir, "pipeline", "dataset", "*.npy"))), "pipe-warp")
    cfg = HEMTrainConfig()
    est = cfg.estimator
    ds = HEMTrainDataset(sdir, est.crop_size, est.ori_size, cfg.rho,
                         rng=np.random.default_rng(seed))
    host = HEMTrainDataset(sdir, est.crop_size, est.ori_size, cfg.rho,
                           rng=np.random.default_rng(seed), device_pipeline=False)
    if n != PIPE_N or len(ds) != PIPE_N:
        raise SystemExit(f"make_samples wrote {n} files, HEMTrainDataset reads {len(ds)}")
    item, host_item = ds[0], host[0]
    built = device_build_patches(*(torch.from_numpy(collate([item])[k]).to(dev) for k in
                                   ("img12", "homo", "homo_inv", "start")),
                                 est.crop_size, est.ori_size)
    gray_diff = float(np.abs(built["imgs_gray_patch"][0].cpu().numpy()
                             - host_item["imgs_gray_patch"]).max())
    flow_diff = float(np.abs(built["flow_gt_patch"][0].cpu().numpy()
                             - host_item["flow_gt_patch"]).max())
    log(f"[pipe-samples] make_samples: {n} files; HEMTrainDataset reads them (img12 "
        f"{item['img12'].shape} {item['img12'].dtype}); its host pipeline (native kernels, "
        f"fixed-point resize) vs device_build_patches on sample 0: gray {gray_diff:.3g} (tol "
        f"{HOST_GRAY_TOL:g}), flow {flow_diff:.3g} px")
    if not gray_diff <= HOST_GRAY_TOL or not flow_diff <= 2e-3:
        raise SystemExit(f"host and device pipelines disagree: gray {gray_diff}, flow {flow_diff}")

    # d. the shipped HEM config streamed from the files
    loader_ms = {}
    for workers in (0, PIPE_WORKERS):
        dl = DataLoader(ds, cfg.train_batch_size, seed=seed, num_workers=workers, prefetch=0,
                        pin_memory=True)
        t0, nb = time.perf_counter(), 0
        for _ in range(2):
            for batch in dl:
                nb += 1
        loader_ms[workers] = 1e3 * (time.perf_counter() - t0) / nb
        dl.close()
    dl = DataLoader(ds, cfg.train_batch_size, seed=seed, num_workers=PIPE_WORKERS,
                    prefetch=PIPE_PREFETCH, pin_memory=True)
    stream = cycle(dl)
    trainer = HEMTrainer(cfg, steps_per_epoch=len(dl), device=dev)
    trainer.init_state(seed)
    before = {fn.__name__: fn.launches for fn in LAUNCH_COUNTERS}
    losses, times = [], []
    for _ in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        step_out = trainer.train_steps([next(stream)])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(step_out["total"][0]))
    eager = {k: fn.launches - before[k] for k, fn in
             ((fn.__name__, fn) for fn in LAUNCH_COUNTERS)}
    per_replay = trainer.step_graph.launches
    want_step = {"window_attention": 40 * (BATCH // MICROBATCH),
                 "window_attention_backward": 40 * (BATCH // MICROBATCH),
                 "swin_block": 0, "swin_block_backward": 0}
    step_ms = float(np.median(times[WARMUP_STEPS:]))
    if per_replay != want_step or eager != want_step or not np.isfinite(losses).all():
        raise SystemExit(f"streamed steps: launches per replay {per_replay}, by the eager first "
                         f"step {eager}, expected {want_step}; losses {losses}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_steps([next(stream)])
        torch.cuda.synchronize()
    events = kernel_events(prof.key_averages())
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    device = {n: sum(e.count for e in events if part in e.key)
              for n, part in DEVICE_KERNEL.items()}
    stream.close()
    dl.close()
    del trainer
    torch.cuda.empty_cache()
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--streamed-step-copies",
                            sdir, "--seed", str(seed)], capture_output=True, text=True,
                           timeout=600)
    if child.returncode != 0:
        raise SystemExit(f"the streamed step's profile in a fresh process failed "
                         f"({child.returncode}):\n{child.stdout[-3000:]}\n{child.stderr[-3000:]}")
    traced = json.loads(child.stdout.strip().splitlines()[-1])
    copies, compute = traced["copies"], set(traced["compute_streams"])
    copy_ms = sum(c[3] for c in copies)
    idle = max(0.0, 1.0 - dev_ms / step_ms)
    log(f"[pipe-train] HEMTrainConfig() (bf16, B={cfg.train_batch_size}, grad_accum "
        f"{cfg.grad_accum}) from {n} files, loader with {PIPE_WORKERS} worker threads, prefetch "
        f"{PIPE_PREFETCH}, pinned: train_steps one call per step, first {times[0]:.1f} ms, "
        f"steady {step_ms:.2f} ms (timed {', '.join(f'{t:.1f}' for t in times[WARMUP_STEPS:])}), "
        f"{1e3 * cfg.train_batch_size / step_ms:.2f} training pairs/s; losses {losses[0]:.5f} "
        f"-> {losses[-1]:.5f}")
    log(f"[pipe-train] the loader alone (prefetch 0, pinned): {loader_ms[0]:.2f} ms per batch "
        f"with 0 workers, {loader_ms[PIPE_WORKERS]:.2f} with {PIPE_WORKERS}")
    log(f"[pipe-train] profiled streamed step: device busy {dev_ms:.2f} ms of the {step_ms:.2f} "
        f"ms unprofiled step: idle {100 * idle:.1f}%; launches per replay {per_replay} (at "
        f"capture), {device} by kernel name")
    log(f"[pipe-train] a streamed replay profiled in a fresh process: host-to-device copies "
        f"{[(c[0], c[1], c[2]) for c in copies]}: {copy_ms:.3f} ms on the card (phase 8b "
        f"copies a 141 MB patch batch from pageable memory instead), on streams "
        f"{sorted({c[1] for c in copies})}, the window kernels on {sorted(compute)}")
    if (device != want_step or not copies or any("Pinned" not in c[0] for c in copies)
            or {c[1] for c in copies} & compute):
        raise SystemExit(f"the streamed replay: launches {device}, copies {copies}, compute "
                         f"streams {compute}")
    out["train"] = {"step_ms": step_ms, "pairs_per_s": 1e3 * cfg.train_batch_size / step_ms,
                    "first_call_ms": times[0], "timed_ms": times[WARMUP_STEPS:],
                    "losses": losses, "idle": idle, "dev_ms": dev_ms, "copy_ms": copy_ms,
                    "copies": copies, "loader_ms_per_batch": loader_ms,
                    "launches_per_replay": per_replay,
                    "replays": WARMUP_STEPS + TIMED_STEPS, "launches_eager": eager}
    # the first call's step ran eagerly; every later call, the profiled one
    # included, replayed the graph
    out["train"]["launches"] = {k: eager[k] + v * out["train"]["replays"]
                                for k, v in per_replay.items()}

    # e. the CLI
    hdir = os.path.join(tmp, "hem")
    t0 = time.perf_counter()
    tr = hem_train.main(["--samples", sdir, "--steps", "4", "--fuse-steps", "2", "--out", hdir,
                         "--seed", str(seed)])
    torch.cuda.synchronize()
    cli_train_ms = 1e3 * (time.perf_counter() - t0)
    ckpt = checkpoint_path(hdir, "latest")
    if tr.step != 4 or not os.path.exists(ckpt):
        raise SystemExit(f"hem_train stopped at step {tr.step}; {ckpt} written: "
                         f"{os.path.exists(ckpt)}")
    log(f"[pipe-hem-train] hem_train --samples --steps 4 --fuse-steps 2: {cli_train_ms:.0f} ms "
        f"(set-up and capture included), wrote {os.path.basename(ckpt)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    out["hem_train_cli_ms"] = cli_train_ms
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 27: data parallel
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_TIMEOUT_S = 300.0  # a collective that waits longer raises in the rank
DP_JOIN_S = 900  # the ranks' whole run; then they are killed and the phase fails
DP_EVAL_PAIRS = 32  # evaluated in halves, one per rank, and merged
DP_DGM_SPEED_MICROBATCH = 32  # per rank at the shipped batch of 128 (phase 22's microbatch)
DP_DGM_WARMUP, DP_DGM_TIMED = 2, 5
HEM_STEP_LAUNCHES = {"window_attention": 40 * (BATCH // MICROBATCH),
                     "window_attention_backward": 40 * (BATCH // MICROBATCH),
                     "swin_block": 0, "swin_block_backward": 0}


def graph_step_times(trainer, batch):
    """``train_steps`` one call per step: the first (an eager step, then the
    capture), WARMUP_STEPS - 1 more, TIMED_STEPS timed (host clock around
    ``synchronize()``).  Returns (median ms of the timed, all times)."""
    import torch

    times = []
    for _ in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        out = trainer.train_steps([batch])
        float(out["total"][0])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times[WARMUP_STEPS:])), times


def profile_replay(trainer, batch):
    """One replayed step under torch.profiler: (device ms, launches of each
    counted kernel by name, NCCL kernels' (count, device ms), top events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_steps([batch])
        torch.cuda.synchronize()
    events = kernel_events(prof.key_averages())
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = {n: sum(e.count for e in events if part in e.key)
                for n, part in DEVICE_KERNEL.items()}
    nccl = [e for e in events if "nccl" in e.key.lower()]
    return (dev_ms, launches,
            (sum(e.count for e in nccl), sum(e.self_device_time_total for e in nccl) / 1e3,
             sorted({e.key[:60] for e in nccl})))


def phase_dp_one_rank(dev, batch, seed: int, tmp: str):
    """27a: the shipped HEM graph step and the fp32 step inside a one-rank
    ``nccl`` group, where every collective of the data-parallel step runs,
    against the same steps with no group."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from dmhomo_torch.parallel import distributed as pd
    from dmhomo_torch.train.config import HEMTrainConfig
    from dmhomo_torch.train.hem_trainer import HEMTrainer

    shipped, fp32 = HEMTrainConfig(), dataclasses.replace(HEMTrainConfig(), bf16=False)
    # no group: the shipped graph step's time, and the fp32 eager steps
    plain = HEMTrainer(shipped, steps_per_epoch=1000, device=dev)
    plain.init_state(seed)
    no_group_ms, _ = graph_step_times(plain, batch)
    del plain
    ref = HEMTrainer(fp32, steps_per_epoch=1000, device=dev)
    ref.init_state(seed + 2)
    ref_losses = torch.stack([ref.train_step(batch)["total"] for _ in range(GRAPH_STEPS)])
    ref_state = {k: {n: v.clone() for n, v in d.items()} for k, d in trainer_state(ref).items()}
    del ref
    torch.cuda.empty_cache()

    pd.maybe_initialize_distributed(backend="nccl", init_method=f"file://{tmp}/pg-27a",
                                    world_size=1, rank=0, device=dev, timeout_s=DP_TIMEOUT_S)
    try:
        tr = HEMTrainer(shipped, steps_per_epoch=1000, device=dev)
        tr.init_state(seed)
        if tr._grads is None or tr.mesh.data != 1:
            raise SystemExit("the trainer under a one-rank group is not data-parallel")
        c0 = pd.all_reduce_.calls
        tr.train_step(batch)
        eager_calls = pd.all_reduce_.calls - c0
        torch.cuda.synchronize()
        c0 = pd.all_reduce_.calls
        group_ms, times = graph_step_times(tr, batch)
        # the first call ran one eager step, then captured the step; replays run no Python
        captured = pd.all_reduce_.calls - c0 - eager_calls
        sg = tr.step_graph
        dev_ms, device, (n_nccl, nccl_ms, nccl_names) = profile_replay(tr, batch)
        idle = max(0.0, 1.0 - dev_ms / group_ms)
        if sg.launches != HEM_STEP_LAUNCHES or device != HEM_STEP_LAUNCHES:
            raise SystemExit(f"one-rank group: launches per replay at capture {sg.launches}, by "
                             f"name in a profiled replay {device}; expected {HEM_STEP_LAUNCHES}")
        if captured != eager_calls or captured < 3:
            raise SystemExit(f"the captured step holds {captured} all-reduces, the eager step "
                             f"{eager_calls}")
        log(f"[dp-1] one-rank nccl group, shipped config B={BATCH} (bf16, microbatches of "
            f"{MICROBATCH}): graph step {group_ms:.2f} ms (timed "
            f"{', '.join(f'{t:.1f}' for t in times[WARMUP_STEPS:])}), no group {no_group_ms:.2f} "
            f"ms (this phase, same card); {1e3 * BATCH / group_ms:.2f} pairs/s; idle "
            f"{100 * idle:.1f}%")
        n_grad = sum(p.numel() for p in tr.model.parameters())
        log(f"[dp-1] all-reduces per step: {eager_calls} eager, {captured} captured in the graph "
            f"(BatchNorm moments forward and backward, the NLL counts, one gradient buffer of "
            f"{n_grad:,} fp32 values, {4 * n_grad / 1e6:.2f} MB, and 5 loss terms); "
            f"launches per replay {sg.launches}, by name {device}; NCCL kernels in a profiled "
            f"replay: {n_nccl} ({nccl_ms:.3f} ms) {nccl_names} (NCCL runs a one-rank in-place "
            "all-reduce as no kernel)")
        del tr
        torch.cuda.empty_cache()
        # fp32: eager and graph under the group, against each other and the no-group eager
        eager = HEMTrainer(fp32, steps_per_epoch=1000, device=dev)
        eager.init_state(seed + 2)
        eager_losses = torch.stack([eager.train_step(batch)["total"]
                                    for _ in range(GRAPH_STEPS)])
        eager_state = trainer_state(eager)
        graph = HEMTrainer(fp32, steps_per_epoch=1000, device=dev)
        graph.init_state(seed + 2)
        graph_losses = graph.train_steps([batch] * GRAPH_STEPS)["total"]
        torch.cuda.synchronize()
        d_graph = step_diff(graph_losses, trainer_state(graph), eager_losses, eager_state)
        d_plain = step_diff(eager_losses, eager_state, ref_losses, ref_state)
        log(f"[dp-1] fp32, {GRAPH_STEPS} steps: graph vs eager under the group "
            f"{json.dumps(d_graph)}; eager under the group vs eager with no group "
            f"{json.dumps(d_plain)} (phase 8c's rule: losses {GRAPH_LOSS_TOL:g}, weights "
            f"{GRAPH_LR_FACTOR:g} lr, BatchNorm {GRAPH_BN_TOL:g})")
        if not (within_graph_rule(d_graph, fp32.lr) and within_graph_rule(d_plain, fp32.lr)):
            raise SystemExit(f"one-rank group: graph vs eager {d_graph}, vs no group {d_plain}")
        del eager, graph
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"step_ms": group_ms, "no_group_step_ms": no_group_ms, "idle": idle,
            "all_reduces_eager": eager_calls, "all_reduces_captured": captured,
            "gradient_values": n_grad,
            "nccl_kernels_per_replay": n_nccl, "nccl_ms_per_replay": nccl_ms,
            "launches_per_replay": sg.launches, "graph_vs_eager": d_graph,
            "eager_vs_no_group": d_plain}


def dp_eval_samples(cfg, seed: int) -> dict:
    """DP_EVAL_PAIRS synthetic eval pairs with a video name of each
    category in turn (numpy, as the loader collates them)."""
    from dmhomo_torch.evaluation.metrics import TEST_CATEGORIES

    patch, pts = make_pairs(DP_EVAL_PAIRS, cfg.ori_size, cfg.crop_size, seed)
    names = [ids[0] for ids in TEST_CATEGORIES.values()]
    return {"imgs_gray_patch": patch, "pt_set": pts,
            "video_names": [names[i % len(names)] for i in range(DP_EVAL_PAIRS)]}


def dgm_dp_setup(seed: int):
    """Phase 25's fp32 DGM step config (full-width UNet at DGM_CPU_SIZE,
    batch DGM_CPU_BATCH in DGM_CPU_ACCUM microbatches) and its global
    conditions, classes and draws (numpy)."""
    import dataclasses

    from dmhomo_torch.data.conditions import synthetic_condition_batches
    from dmhomo_torch.train.config import DGMTrainConfig

    base = DGMTrainConfig()
    cfg = dataclasses.replace(
        base, bf16=False, train_batch_size=DGM_CPU_BATCH, gradient_accumulate_every=DGM_CPU_ACCUM,
        ema_update_every=1, diffusion=dataclasses.replace(base.diffusion, image_size=DGM_CPU_SIZE))
    S, mb = DGM_CPU_SIZE, DGM_CPU_BATCH // DGM_CPU_ACCUM
    cond, cls = next(synthetic_condition_batches(DGM_CPU_BATCH, S, DGM_CPU_BATCH,
                                                 base.unet.num_classes, seed + 27))
    rng = np.random.default_rng(seed + 27)
    draws = [(rng.integers(0, base.diffusion.timesteps, (mb,)),
              rng.normal(size=(mb, S, S, base.unet.channels)).astype(np.float32),
              np.array([True, False][:mb])) for _ in range(DGM_CPU_ACCUM)]
    return cfg, cond, cls, draws


def dp_rank(rank: int, world: int, root: str, backend: str, seed: int) -> None:
    """27b/27c, one rank (a child process of the phase): joins the group
    through ``root``, runs the cases on its rows, writes
    ``root/rank<rank>.pt``; with its own card under nccl, then times the
    shipped HEM graph step and DGM step."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from dmhomo_torch.ops.window_attention import window_attention, window_attention_backward
    from dmhomo_torch.parallel import distributed as pd
    from dmhomo_torch.parallel.mesh import accum_for, shard_batch
    from dmhomo_torch.train.config import HEMTrainConfig
    from dmhomo_torch.train.dgm_trainer import DGMTrainer
    from dmhomo_torch.train.hem_trainer import HEMTrainer

    speed = backend == "nccl"
    dev = torch.device("cuda", rank if speed else 0)
    pd.maybe_initialize_distributed(backend=backend, init_method=f"file://{root}/pg",
                                    world_size=world, rank=rank, device=dev,
                                    timeout_s=DP_TIMEOUT_S)
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "device": str(dev), "card": torch.cuda.get_device_name(dev)}
    try:
        cfg = dataclasses.replace(HEMTrainConfig(), bf16=False)
        tr = HEMTrainer(cfg, steps_per_epoch=1000, device=dev)
        tr.init_state(seed + 3)
        ev = dp_eval_samples(cfg.estimator, seed + 3)
        out["eval"] = tr.evaluate(iter([{k: v[rank::world] for k, v in ev.items()}]))
        batch = synthetic_train_batch(BATCH, seed)
        accum = accum_for(BATCH // world, world, cfg.grad_accum)
        rows = shard_batch(batch, rank, world, accum)
        for fn in (window_attention, window_attention_backward):
            fn.launches = 0
        losses = tr.train_step(rows)
        out["hem"] = {"accum": accum, "rows": int(rows["imgs_gray_patch"].shape[0]),
                      "losses": losses["total"].reshape(1).cpu(),
                      "launches": (window_attention.launches, window_attention_backward.launches),
                      "state": {k: {n: v.cpu() for n, v in d.items()}
                                for k, d in trainer_state(tr).items()}}
        out["ckpt"] = tr.save(os.path.join(root, "ckpt"))
        del tr
        torch.cuda.empty_cache()

        dcfg, cond, cls, draws = dgm_dp_setup(seed)
        dt = DGMTrainer(dcfg, device=dev)
        dt.init_state(seed + 27)
        c0 = la_counts()
        with PlainLinearAttentionRefused():
            loss = dt.loss_and_grads(shard_batch(cond, rank, world, DGM_CPU_ACCUM),
                                     shard_batch(cls, rank, world, DGM_CPU_ACCUM), draws=draws)
        launches = tuple(b - a for a, b in zip(c0, la_counts()))
        grads = {n: p.grad.detach().cpu().clone() for n, p in dt.model.named_parameters()}
        upd = dt.apply_gradients()
        out["dgm"] = {"loss": float(loss), "grads": grads, "launches": launches,
                      "gradient_values": sum(p.numel() for p in dt.model.parameters()),
                      "grad_norm": float(upd["grad_norm"]),
                      "params": [p.detach().cpu() for p in dt.model.parameters()],
                      "ema_is_params": all(torch.equal(e, p) for e, p in
                                           zip(dt.ema.params, dt.model.parameters()))}
        del dt
        torch.cuda.empty_cache()
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
        if speed:
            dp_speed(rank, world, root, dev, seed)
    finally:
        dist.destroy_process_group()


def dp_speed(rank: int, world: int, root: str, dev, seed: int) -> None:
    """27c, one rank on its own card: once the parent says so (``root/go``),
    the shipped HEM graph step at the global batch of 32 and the shipped DGM
    step at the global batch of 128 (microbatches of DP_DGM_SPEED_MICROBATCH
    per rank); the idle share of a profiled HEM replay.  Writes
    ``root/speed<rank>.json``."""
    import dataclasses

    import torch

    from dmhomo_torch.parallel import distributed as pd
    from dmhomo_torch.parallel.mesh import accum_for, shard_batch
    from dmhomo_torch.train.config import DGMTrainConfig, HEMTrainConfig
    from dmhomo_torch.train.dgm_trainer import DGMTrainer
    from dmhomo_torch.train.hem_trainer import HEMTrainer

    deadline = time.time() + DP_TIMEOUT_S
    while not os.path.exists(os.path.join(root, "go")):
        if time.time() > deadline:
            raise SystemExit("the parent never said go")
        time.sleep(0.2)
    cfg = HEMTrainConfig()
    tr = HEMTrainer(cfg, steps_per_epoch=1000, device=dev)
    tr.init_state(seed)
    batch = synthetic_train_batch(BATCH, seed)
    rows = shard_batch(batch, rank, world, accum_for(BATCH // world, world, cfg.grad_accum))
    pd.all_reduce_(torch.zeros(1, device=dev))  # start together
    hem_ms, times = graph_step_times(tr, rows)
    dev_ms, device, nccl = profile_replay(tr, rows)
    del tr
    torch.cuda.empty_cache()
    base = DGMTrainConfig()
    B = base.train_batch_size
    dcfg = dataclasses.replace(base, gradient_accumulate_every=B // world // DP_DGM_SPEED_MICROBATCH)
    cond, cls = dgm_condition_pool(B, base.diffusion.image_size, base.unet.num_classes, seed, dev)
    c, k = (shard_batch(x, rank, world, dcfg.gradient_accumulate_every) for x in (cond, cls))
    dt = DGMTrainer(dcfg, device=dev)
    dt.init_state(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1 + rank)
    dgm_ms, dgm_times = dgm_step_times(dt, c, k, gen)
    peak = torch.cuda.max_memory_allocated(dev)
    with open(os.path.join(root, f"speed{rank}.json"), "w") as f:
        json.dump({"hem_step_ms": hem_ms, "hem_times": times, "hem_idle": max(0.0, 1 - dev_ms / hem_ms),
                   "hem_launches_by_name": device, "nccl_kernels_per_replay": nccl[0],
                   "nccl_ms_per_replay": nccl[1], "nccl_names": nccl[2],
                   "dgm_step_ms": dgm_ms, "dgm_times": dgm_times, "dgm_microbatch": DP_DGM_SPEED_MICROBATCH,
                   "peak_bytes": peak}, f)


def dgm_step_times(trainer, cond, cls, gen):
    """DP_DGM_WARMUP + DP_DGM_TIMED DGM steps, each timed by the host clock
    around ``synchronize()``: (median ms of the timed, all times)."""
    import torch

    times = []
    for _ in range(DP_DGM_WARMUP + DP_DGM_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(trainer.train_step(cond, cls, generator=gen)["loss"])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times[DP_DGM_WARMUP:])), times


def one_card_speed(dev, seed: int) -> dict:
    """27c's baseline on card 0 with no group: the shipped HEM graph step at
    B=32 and the shipped DGM step at 128 in microbatches of
    DP_DGM_SPEED_MICROBATCH."""
    import dataclasses

    import torch

    from dmhomo_torch.train.config import DGMTrainConfig, HEMTrainConfig
    from dmhomo_torch.train.dgm_trainer import DGMTrainer
    from dmhomo_torch.train.hem_trainer import HEMTrainer

    tr = HEMTrainer(HEMTrainConfig(), steps_per_epoch=1000, device=dev)
    tr.init_state(seed)
    batch = synthetic_train_batch(BATCH, seed)
    hem_ms, _ = graph_step_times(tr, batch)
    dev_ms, _, _ = profile_replay(tr, batch)
    del tr
    torch.cuda.empty_cache()
    base = DGMTrainConfig()
    B = base.train_batch_size
    dt = DGMTrainer(dataclasses.replace(base, gradient_accumulate_every=B // DP_DGM_SPEED_MICROBATCH),
                    device=dev)
    dt.init_state(seed)
    cond, cls = dgm_condition_pool(B, base.diffusion.image_size, base.unet.num_classes, seed, dev)
    dgm_ms, times = dgm_step_times(dt, cond, cls, torch.Generator(device=dev).manual_seed(seed + 1))
    del dt
    torch.cuda.empty_cache()
    return {"hem_step_ms": hem_ms, "hem_idle": max(0.0, 1 - dev_ms / hem_ms),
            "dgm_step_ms": dgm_ms, "dgm_times": times}


def phase_dp_ranks(dev, seed: int, tmp: str):
    """27b and 27c: DP_WORLD ranks in child processes (``nccl``, one card
    each, when there are enough cards; else ``gloo`` with every rank on card
    0), held against one process on the same global batch; with nccl, then
    the step times over the ranks' cards against card 0 alone."""
    import dataclasses

    import torch

    from dmhomo_torch.train.config import HEMTrainConfig
    from dmhomo_torch.train.dgm_trainer import DGMTrainer
    from dmhomo_torch.train.hem_trainer import HEMTrainer

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= DP_WORLD else "gloo"
    log(f"[dp-2] {DP_WORLD} ranks, backend {backend} ({cards} card(s): "
        f"{'one card per rank' if backend == 'nccl' else 'both ranks on card 0'})")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--seed", str(seed),
                               "--dp-rank", str(r), "--dp-world", str(DP_WORLD), "--dp-dir", tmp,
                               "--dp-backend", backend],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(DP_WORLD)]
    try:
        # meanwhile, one process on the global batch: the same seeds and draws
        cfg = dataclasses.replace(HEMTrainConfig(), bf16=False)
        tr = HEMTrainer(cfg, steps_per_epoch=1000, device=dev)
        tr.init_state(seed + 3)
        want_eval = tr.evaluate(iter([dp_eval_samples(cfg.estimator, seed + 3)]))
        want_losses = tr.train_step(synthetic_train_batch(BATCH, seed))["total"].reshape(1).cpu()
        want_state = {k: {n: v.cpu() for n, v in d.items()} for k, d in trainer_state(tr).items()}
        del tr
        torch.cuda.empty_cache()
        dcfg, cond, cls, draws = dgm_dp_setup(seed)
        nudged = (cond + STEP_INPUT_NOISE * np.random.default_rng(seed).normal(size=cond.shape)
                  ).astype(np.float32)
        dt = DGMTrainer(dcfg, device=dev)
        dt.init_state(seed + 27)
        dt.loss_and_grads(nudged, cls, draws=draws)
        g_nudged = {n: p.grad.detach().cpu().clone() for n, p in dt.model.named_parameters()}
        want_dgm = float(dt.loss_and_grads(cond, cls, draws=draws))
        g_want = {n: p.grad.detach().cpu().clone() for n, p in dt.model.named_parameters()}
        upd = dt.apply_gradients()
        p_want = [p.detach().cpu() for p in dt.model.parameters()]
        del dt
        torch.cuda.empty_cache()
        if backend == "nccl":
            open(os.path.join(tmp, "go"), "w").close()
        logs = [p.communicate(timeout=DP_JOIN_S)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise SystemExit(f"rank {r} failed ({p.returncode}):\n{text[-4000:]}")
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(DP_WORLD)]
    out = {"backend": backend, "cards": cards}
    for r, got in enumerate(ranks):
        h = got["hem"]
        d = step_diff(h["losses"], h["state"], want_losses, want_state)
        if h["launches"] != (HEM_STEP_LAUNCHES["window_attention"],) * 2 or \
                not within_graph_rule(d, cfg.lr) or got["backend"] != backend:
            raise SystemExit(f"rank {r}: HEM step against one process {d}, launches "
                             f"{h['launches']}, backend {got['backend']}")
        log(f"[dp-2] rank {r} on {got['device']} ({got['card']}): HEM fp32 eager step, "
            f"{h['rows']} of the global {BATCH} rows in {h['accum']} microbatches, against one "
            f"process on the whole batch: {json.dumps(d)} (phase 8c's rule); window-attention "
            f"launches forward/backward {h['launches'][0]}/{h['launches'][1]}")
        out[f"rank{r}_hem"] = {**d, "launches": h["launches"]}
        g = got["dgm"]
        loss_rel = abs(g["loss"] - want_dgm) / abs(want_dgm)
        rels = {n: float((g["grads"][n] - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                for n, v in g_want.items()}
        tols = {n: max(STEP_GRAD_TOL, STEP_NOISE_FACTOR * float((g_nudged[n] - v).abs().max())
                       / max(float(v.abs().max()), 1e-30)) for n, v in g_want.items()}
        bad = [n for n in rels if not rels[n] <= tols[n]]
        diff = torch.cat([(a - b).abs().flatten() for a, b in zip(g["params"], p_want)])
        norm_rel = abs(g["grad_norm"] - float(upd["grad_norm"])) / float(upd["grad_norm"])
        per_step = (8 * DGM_CPU_ACCUM,) * 2  # 8 sites a microbatch
        worst = max(rels, key=lambda n: rels[n] / tols[n])
        log(f"[dp-2] rank {r}: DGM fp32 step ({DGM_CPU_SIZE}x{DGM_CPU_SIZE}, global batch "
            f"{DGM_CPU_BATCH} in {DGM_CPU_ACCUM} microbatches) against one process with the same "
            f"draws: loss rel {loss_rel:.3g} (tol {STEP_LOSS_TOL:g}); closest gradient {worst} "
            f"{rels[worst]:.3g} (tol {tols[worst]:.3g}); global norm rel {norm_rel:.3g}; weights "
            f"after Adam max {float(diff.max()):.3g} (2 lr = {2 * dcfg.lr:g}); gradient all-reduce "
            f"of {g['gradient_values']:,} fp32 values ({4 * g['gradient_values'] / 1e6:.2f} MB, the "
            f"shipped UNet's); linear-attention "
            f"launches pass 1/2 {g['launches'][0]}/{g['launches'][1]}; EMA = weights "
            f"{g['ema_is_params']}")
        if bad or loss_rel > STEP_LOSS_TOL or norm_rel > STEP_GRAD_TOL or \
                float(diff.max()) > 2 * dcfg.lr + 1e-6 or \
                float((diff > 1e-6).float().mean()) >= 0.01 or g["launches"] != per_step or \
                not g["ema_is_params"]:
            raise SystemExit(f"rank {r}: DGM step against one process: loss {loss_rel}, "
                             f"gradients {[(n, rels[n], tols[n]) for n in bad]}, norm {norm_rel}, "
                             f"launches {g['launches']} (expected {per_step})")
        out[f"rank{r}_dgm"] = {"loss_rel": loss_rel, "grad_norm_rel": norm_rel,
                               "param_max_diff": float(diff.max()), "launches": g["launches"]}
        bad_eval = [k for k, v in want_eval.items()
                    if not (np.isnan(v) and np.isnan(got["eval"][k])
                            or abs(got["eval"][k] - v) <= 1e-6 * abs(v))]
        log(f"[dp-2] rank {r}: merged evaluate of {DP_EVAL_PAIRS // DP_WORLD} pairs per rank "
            f"{json.dumps(got['eval'])} vs one process {json.dumps(want_eval)}")
        if bad_eval:
            raise SystemExit(f"rank {r}: merged evaluate differs in {bad_eval}")
    ckpt = os.path.join(tmp, "ckpt")
    files = sorted(os.listdir(ckpt))
    paths = {got["ckpt"] for got in ranks}
    log(f"[dp-2] checkpoint: every rank returned {sorted(paths)}; files written {files}")
    if files != ["model_latest.pth"] or paths != {os.path.join(ckpt, "model_latest.pth")}:
        raise SystemExit(f"checkpoint writers: files {files}, paths {paths}")
    out["launches_per_rank"] = {"window_attention": HEM_STEP_LAUNCHES["window_attention"],
                                "linear_attention_per_microbatch": 8}
    if backend != "nccl":
        log(f"[dp-3] speed over {DP_WORLD} cards: not run ({cards} card(s); {DP_WORLD} ranks "
            "sharing one card measure no scaling)")
        return out
    speed = [json.load(open(os.path.join(tmp, f"speed{r}.json"))) for r in range(DP_WORLD)]
    one = one_card_speed(dev, seed)
    hem_ms = max(s["hem_step_ms"] for s in speed)
    dgm_ms = max(s["dgm_step_ms"] for s in speed)
    log(f"[dp-3] HEM graph step, global B={BATCH}: {DP_WORLD} cards {hem_ms:.2f} ms "
        f"({1e3 * BATCH / hem_ms:.2f} pairs/s; per rank "
        f"{[round(s['hem_step_ms'], 2) for s in speed]} ms, idle "
        f"{[round(100 * s['hem_idle'], 1) for s in speed]}%, NCCL kernels per replay "
        f"{[s['nccl_kernels_per_replay'] for s in speed]} "
        f"({[round(s['nccl_ms_per_replay'], 3) for s in speed]} ms) {speed[0]['nccl_names']}) vs "
        f"one card {one['hem_step_ms']:.2f} ms ({1e3 * BATCH / one['hem_step_ms']:.2f} pairs/s, "
        f"idle {100 * one['hem_idle']:.1f}%)")
    log(f"[dp-3] DGM step, global batch 128 in microbatches of {DP_DGM_SPEED_MICROBATCH} per "
        f"rank: {DP_WORLD} cards {dgm_ms:.2f} ms ({1e3 * 128 / dgm_ms:.3f} samples/s; per rank "
        f"{[round(s['dgm_step_ms'], 2) for s in speed]}) vs one card {one['dgm_step_ms']:.2f} ms "
        f"({1e3 * 128 / one['dgm_step_ms']:.3f} samples/s)")
    for s in speed:
        if s["hem_launches_by_name"] != HEM_STEP_LAUNCHES or s["nccl_kernels_per_replay"] == 0:
            raise SystemExit(f"a rank's profiled replay: launches {s['hem_launches_by_name']}, "
                             f"NCCL kernels {s['nccl_kernels_per_replay']}")
    out["speed"] = {"ranks": speed, "one_card": one, "hem_step_ms": hem_ms, "dgm_step_ms": dgm_ms}
    return out


def phase_data_parallel(dev, batch, seed: int):
    """Phase 27, under a temporary directory in ``build/``."""
    import tempfile

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dp_", dir=build) as tmp:
        one = phase_dp_one_rank(dev, batch, seed, tmp)
        ranks = phase_dp_ranks(dev, seed, tmp)
    out = {"one_rank": one, "ranks": ranks, "phase_s": time.perf_counter() - t0}
    log(f"[dp-summary] " + json.dumps(out))
    return out



# ---------------------------------------------------------------------------
# the HEM kernels at every window and width: the generic variants (phase 28)
# ---------------------------------------------------------------------------

GENERIC_N = (1, 4, 16, 49, 144)  # window tokens: windows 1, 2, 4, 7, 12
GENERIC_HD = (4, 6, 8, 12, 64)
# (C, heads) of the whole-block cases: head dims 4, 6, 12, 64
GENERIC_WIDTHS = ((8, 2), (24, 4), (96, 8), (384, 6))
GENERIC_WINDOWS = (1, 2, 4, 7, 12)
WINDOW4 = 4  # the shipped config's window in phase 28's params.json
TINY_STEPS = 10


def _plain_raises():
    """Makes the plain window-attention and whole-block versions raise: on
    the card the main path runs the kernels or nothing."""
    from dmhomo_torch.ops import swin_block as sb
    from dmhomo_torch.ops import window_attention as wa

    def refuse(*args, **kwargs):
        raise RuntimeError("a plain window-attention or whole-block version ran on the card")

    for mod, names in ((wa, ("window_attention_reference", "window_attention_backward_reference")),
                       (sb, ("swin_block_reference", "swin_block_backward_reference"))):
        for n in names:
            setattr(mod, n, refuse)


def json_keys(obj):
    """``obj`` with every dict key a string (the counters key by shape tuples)."""
    if isinstance(obj, dict):
        return {k if isinstance(k, str) else str(k): json_keys(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_keys(v) for v in obj]
    return obj


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def _block_params(C, heads, hidden, N, dev, gen):
    """Trained-looking whole-block parameters in the port's layout."""
    import torch

    shapes = {"g1": (C,), "b1": (C,), "wq": (3 * C, C), "bq": (3 * C,), "bias": (heads, N, N),
              "wp": (C, C), "bp": (C,), "g2": (C,), "b2": (C,), "w1": (hidden, C),
              "c1": (hidden,), "w2": (C, hidden), "c2": (C,)}
    out = []
    for name, shape in shapes.items():
        v = torch.randn(shape, generator=gen, device=dev)
        if name in ("wq", "wp", "w1", "w2"):
            v = v / shape[1]**0.5
        elif name in ("g1", "g2"):
            v = 1 + 0.1 * v
        else:
            v = (0.5 if name == "bias" else 0.1) * v
        out.append(v.contiguous())
    return tuple(out)


class _GenericChecks:
    """Phase 28's comparisons of the generic kernels with their plain
    versions.  Each case runs forward and backward twice (the two runs
    bit-identical), and the first run is held to the plain version at the
    tuned kernels' tolerances; an fp32 gradient within its tolerance or
    phase 9's rule (STEP_NOISE_FACTOR times the plain version's own change
    for its input nudged by STEP_INPUT_NOISE).  ``worst`` keeps the largest
    error by (check, dtype), ``fails`` every miss, ``noisy`` the fp32
    gradients that took phase 9's rule."""

    def __init__(self, dev, gen):
        self.dev, self.gen = dev, gen
        self.fails, self.worst, self.noisy = [], {}, []

    def note(self, key, err, tol, what):
        self.worst[key] = max(self.worst.get(key, 0.0), err)
        if not err <= tol:
            self.fails.append(f"{what}: {err:.3g} > {tol:g}")

    def nudged(self, t):
        """t moved by STEP_INPUT_NOISE relative, as phase 9 moves its input."""
        import torch

        return t + STEP_INPUT_NOISE * t.abs() * torch.randn(t.shape, generator=self.gen,
                                                            device=self.dev).to(t.dtype)

    def _reruns(self, runs, what):
        import torch

        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            self.fails.append(f"{what}: two runs differ")
        return runs[0]

    def window_attention(self, qkv, bias, mask, gout, h, what):
        from dmhomo_torch.ops import window_attention as wa

        runs = [(wa.window_attention(qkv, bias, mask, num_heads=h),
                 *wa.window_attention_backward(qkv, bias, mask, gout, num_heads=h))
                for _ in range(2)]
        out, dqkv, dbias = self._reruns(runs, what)
        del runs
        dtype = str(qkv.dtype).split(".")[-1]
        want = wa.window_attention_reference(qkv, bias, mask, num_heads=h)
        w_dqkv, w_dbias = wa.window_attention_backward_reference(qkv, bias, mask, gout,
                                                                 num_heads=h)
        tols = [BWD_TOL[dtype]] * 2
        if dtype == "float32":  # the plain version's own change for qkv nudged
            n_dqkv, n_dbias = wa.window_attention_backward_reference(
                self.nudged(qkv), bias, mask, gout, num_heads=h)
            tols = [max(t, STEP_NOISE_FACTOR * _rel(a, b))
                    for t, a, b in zip(tols, (n_dqkv, n_dbias), (w_dqkv, w_dbias))]
        self.note(("wa_fwd", dtype), float((out.float() - want.float()).abs().max()),
                  ATTN_TOL[dtype], what + " out")
        self.note(("wa_bwd", dtype), _rel(dqkv, w_dqkv), tols[0], what + " dqkv")
        self.note(("wa_dbias", dtype), _rel(dbias, w_dbias), tols[1], what + " dbias")

    def block(self, x, params, mask, dy, kw, what):
        from dmhomo_torch.ops import swin_block as sb

        runs = []
        for _ in range(2):
            y = sb.swin_block(x, params, mask, **kw)
            dx, grads = sb.swin_block_backward(x, params, mask, dy, **kw)
            runs.append((y, dx) + tuple(grads))
        y, dx, *grads = self._reruns(runs, what)
        del runs
        dtype = str(x.dtype).split(".")[-1]
        want = sb.swin_block_reference(x, params, mask, **kw)
        w_dx, w_grads = sb.swin_block_backward_reference(x, params, mask, dy, **kw)
        tols = [SWIN_TOL[dtype]] * len(w_grads)
        if dtype == "float32":  # the plain version's own change for x nudged
            _, n_grads = sb.swin_block_backward_reference(self.nudged(x), params, mask, dy, **kw)
            tols = [max(t, STEP_NOISE_FACTOR * _rel(a, b))
                    for t, a, b in zip(tols, n_grads, w_grads)]
        self.note(("sb_fwd", dtype), _rel(y, want), SWIN_TOL[dtype], what + " y")
        if dtype == "float32":
            self.note(("sb_dx", dtype), float((dx - w_dx).abs().max()), SWIN_DX_TOL, what + " dx")
        else:
            self.note(("sb_dx", dtype), _rel(dx, w_dx), SWIN_TOL[dtype], what + " dx")
        for n, g, w, t in zip(sb.PARAM_NAMES, grads, w_grads, tols):
            self.note(("sb_grads", dtype), _rel(g, w), t, f"{what} d{n}")
            if t > SWIN_TOL[dtype]:
                self.noisy.append(f"{what} d{n} {_rel(g, w):.3g} (tol {t:.3g})")

    def worst_text(self, prefix: str) -> str:
        return ", ".join(f"{k[0]} {k[1]} {v:.3g}" for k, v in sorted(self.worst.items())
                         if k[0].startswith(prefix))

    def raise_on_fails(self, tag: str) -> None:
        if self.fails:
            for f in self.fails[:40]:
                log(f"[{tag}] FAIL {f}")
            raise SystemExit(f"{len(self.fails)} generic-kernel checks failed")


def phase_generic(dev, pairs, batch, seed: int) -> dict:
    """Phase 28: the generic window-attention and whole-block kernels (a)
    against their plain versions, (b) in ``hem_train --tiny``, (c) at the
    shipped config with window 4, (d) timed per site."""
    t0 = time.perf_counter()
    # (b)'s children take tens of seconds: they run beside (a), which times
    # nothing
    children = start_tiny_children(seed)
    try:
        worst = generic_kernel_checks(dev, seed)
    finally:
        tiny = generic_tiny_train(*children)
    w4 = generic_window4(dev, pairs, batch, seed)
    main_worst = generic_main_path_checks(dev, seed, w4)
    times = generic_site_times(dev, seed, w4)
    phase_s = time.perf_counter() - t0
    log(f"[generic] phase 28 in {phase_s:.1f} s")
    return {"worst": worst, "tiny": tiny, "w4": w4, "main_path_worst": main_worst,
            "times": times, "phase_s": phase_s}


def generic_kernel_checks(dev, seed: int) -> dict:
    """Phase 28 (a): the generic libraries' registers and spills, no atomic
    instruction in their machine code; every generic kernel against its plain
    version at the envelope's shapes (forward and backward, fp32 and bf16,
    +-mask), its plan against the library's, a second run bit-identical; the
    generic variant forced at a shipped shape against the tuned kernels."""
    import torch

    from dmhomo_torch.models.swin import shifted_window_mask
    from dmhomo_torch.ops import swin_block as sb
    from dmhomo_torch.ops import window_attention as wa

    t0 = time.perf_counter()
    for name, log_text in (("window attention", wa.build_log(generic=True)),
                           ("whole block", sb.build_generic().with_suffix(".log").read_text())):
        entry = None
        for line in log_text.splitlines():
            m = re.search(r"Function properties for \S*?((?:window_attention|swin_block)_any_"
                          r"[a-z_]+_kernel)(?:I(f|13__nv_bfloat16)E)?", line)
            if m:
                entry = m.group(1) + {"f": "<float>", "13__nv_bfloat16": "<bf16>"}.get(
                    m.group(2), "")
            elif entry and ("registers" in line or "spill" in line):
                log(f"[generic-build] {name} {entry}: {line.split(':', 1)[-1].strip()}")
    atomics = {**wa.atomic_instructions_by_kernel(generic=True), **sb.generic_atomic_instructions()}
    if any(atomics.values()):
        raise SystemExit(f"atomic instructions in the generic kernels: {atomics}")
    log(f"[generic-sass] atomic instructions in {len(atomics)} generic kernels' machine code: "
        f"{sum(atomics.values())}")

    chk = _GenericChecks(dev, torch.Generator(device=dev).manual_seed(seed))
    gen, note = chk.gen, chk.note
    for N in GENERIC_N:
        for hd in GENERIC_HD:
            for dtype in ("float32", "bfloat16"):
                for masked in (False, True):
                    h, nW = 2, 3
                    dt = getattr(torch, dtype)
                    qkv = torch.randn(2 * nW, N, 3 * h * hd, generator=gen, device=dev).to(dt)
                    bias = 0.5 * torch.randn(h, N, N, generator=gen, device=dev)
                    gout = torch.randn(2 * nW, N, h * hd, generator=gen, device=dev).to(dt)
                    mask = None
                    if masked:
                        mask = torch.where(torch.rand(nW, N, N, generator=gen, device=dev) < 0.3,
                                           -100.0, 0.0)
                    what = f"window attention N={N} hd={hd} {dtype} mask={int(masked)}"
                    for bwd in (False, True):
                        if wa.launch_plan(qkv, h, bwd, mask) != wa.library_plan(qkv, h, bwd, mask):
                            chk.fails.append(f"{what}: plan is not the library's")
                    chk.window_attention(qkv, bias, mask, gout, h, what)
    # forced at a shipped shape (level 1 of a training microbatch, masked)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        qkv = torch.randn(8 * 720, 64, 72, generator=gen, device=dev).to(dt)
        bias = 0.5 * torch.randn(3, 64, 64, generator=gen, device=dev)
        mask = torch.from_numpy(shifted_window_mask(160, 288, 8, 4)).to(dev)
        gout = torch.randn(8 * 720, 64, 24, generator=gen, device=dev).to(dt)
        tuned = (wa.window_attention(qkv, bias, mask, num_heads=3),
                 *wa.window_attention_backward(qkv, bias, mask, gout, num_heads=3))
        forced = (wa.window_attention(qkv, bias, mask, num_heads=3, _generic=True),
                  *wa.window_attention_backward(qkv, bias, mask, gout, num_heads=3,
                                                _generic=True))
        torch.cuda.synchronize()
        what = f"window attention forced generic vs tuned, 160x288 C=24 {dtype}"
        note(("wa_forced", dtype), float((forced[0].float() - tuned[0].float()).abs().max()),
             ATTN_TOL[dtype], what + " out")
        for name, a, b in zip(("dqkv", "dbias"), forced[1:], tuned[1:]):
            note(("wa_forced_bwd", dtype), _rel(a, b), BWD_TOL[dtype], f"{what} {name}")
    log(f"[generic-wa] {len(GENERIC_N) * len(GENERIC_HD) * 4} shapes x dtypes x masks, "
        f"forward and backward, against the plain versions; worst {chk.worst_text('wa')}")

    n_blocks = 0
    for ws in GENERIC_WINDOWS:
        for C, heads in GENERIC_WIDTHS:
            for k in (2, 3, 4):
                for dtype in ("float32", "bfloat16"):
                    B, H, W, shift, N = 2, 2 * ws, 3 * ws, ws // 2, ws * ws
                    dt = getattr(torch, dtype)
                    params = _block_params(C, heads, k * C, N, dev, gen)
                    x = torch.randn(B, H, W, C, generator=gen, device=dev).to(dt)
                    dy = torch.randn(B, H, W, C, generator=gen, device=dev).to(dt)
                    mask = (torch.from_numpy(shifted_window_mask(H, W, ws, shift)).to(dev)
                            if shift else None)
                    kw = dict(num_heads=heads, window_size=ws, shift=shift)
                    what = f"whole block ws={ws} C={C} hidden={k}C {dtype}"
                    if sb.variant(ws, C, heads, k * C) != "generic":
                        chk.fails.append(f"{what}: not the generic variant")
                    for bwd in (False, True):
                        plan = (sb.generic_backward_plan if bwd else sb.generic_forward_plan)(
                            x, heads, k * C, ws)
                        lib = sb.generic_library_plan(x, heads, k * C, ws, bwd)
                        if any((v["grid"], v["threads"], v["smem"]) != (
                                plan["launches"][n]["grid"], plan["launches"][n]["threads"],
                                plan["launches"][n]["smem"]) for n, v in lib["launches"].items()) \
                                or lib["scratch"]["bytes"] != plan["scratch_bytes"]:
                            chk.fails.append(f"{what}: plan is not the library's")
                    chk.block(x, params, mask, dy, kw, what)
                    n_blocks += 1
    for dtype in ("float32", "bfloat16"):  # forced at a shipped shape
        dt = getattr(torch, dtype)
        params = _block_params(96, 24, 288, 64, dev, gen)
        x = torch.randn(1, 40, 72, 96, generator=gen, device=dev).to(dt)
        dy = torch.randn(1, 40, 72, 96, generator=gen, device=dev).to(dt)
        mask = torch.from_numpy(shifted_window_mask(40, 72, 8, 4)).to(dev)
        kw = dict(num_heads=24, shift=4)
        tuned = (sb.swin_block(x, params, mask, **kw),
                 *sb.swin_block_backward(x, params, mask, dy, **kw)[:1])
        forced = (sb.swin_block(x, params, mask, _generic=True, **kw),
                  *sb.swin_block_backward(x, params, mask, dy, _generic=True, **kw)[:1])
        torch.cuda.synchronize()
        want = sb.swin_block_reference(x, params, mask, **kw)
        what = f"whole block forced generic, 40x72 C=96 {dtype}"
        note(("sb_forced", dtype), _rel(forced[0], want), SWIN_TOL[dtype], what + " y vs plain")
        note(("sb_forced", dtype), _rel(forced[0], tuned[0]), SWIN_TOL[dtype],
             what + " y vs tuned")
        note(("sb_forced", dtype), _rel(forced[1], tuned[1]),
             SWIN_DX_TOL if dtype == "float32" else SWIN_TOL[dtype], what + " dx vs tuned")
    if chk.noisy:
        log("[generic-sb] fp32 gradients whose tolerance is phase 9's rule (STEP_NOISE_FACTOR "
            "times the plain version's own change for x nudged by STEP_INPUT_NOISE; at a 1x1 "
            "window dbias is a sum that cancels to 0): " + "; ".join(chk.noisy))
    log(f"[generic-sb] {n_blocks} block shapes x dtypes (windows {GENERIC_WINDOWS}, C "
        f"{[c for c, _ in GENERIC_WIDTHS]}, MLPs 2-4 C), forward and backward, against the "
        f"plain versions; worst {chk.worst_text('sb')}")
    chk.raise_on_fails("generic")
    log(f"[generic] (a) done in {time.perf_counter() - t0:.1f} s")
    return {f"{k[0]} {k[1]}": v for k, v in chk.worst.items()}


def _tiny_held_batch(cfg, seed: int) -> dict:
    """16 synthetic pairs at the tiny config's sizes, none of the training
    set's: the batch phase 28 (b) reads the loss on before and after."""
    from dmhomo_torch.data.hem_data import SyntheticHomoPairs
    from dmhomo_torch.data.loader import collate

    ds = SyntheticHomoPairs(n=16, crop_size=cfg.estimator.crop_size,
                            ori_size=cfg.estimator.ori_size, rho=min(cfg.rho, 3), seed=seed + 1)
    items = [ds[i] for i in range(16)]
    return {k: collate([it[k] for it in items]) for k in ("imgs_gray_patch", "flow_gt_patch")}


def _held_loss(trainer, batch) -> float:
    """The training loss of ``trainer``'s model on ``batch``, without a step."""
    import torch

    from dmhomo_torch.losses.hem_losses import compute_losses

    d = trainer.device
    with torch.no_grad(), torch.autocast(d.type, dtype=torch.bfloat16,
                                         enabled=trainer.config.bf16):
        out = trainer.model(torch.from_numpy(batch["imgs_gray_patch"]).to(d))
        loss = compute_losses({"flow_gt_patch": torch.from_numpy(batch["flow_gt_patch"]).to(d)},
                              out, trainer.config.loss)["total"]
    return float(loss)


def tiny_train_child(attn: str, fuse: int, seed: int) -> dict:
    """Phase 28 (b)'s child: ``hem_train --tiny --synthetic 64 --steps 10`` on
    the card (through ``hem_train.main``, the plain versions made to raise),
    each step's loss recorded, and the loss on a held batch before the first
    step and after the last; with fuse 1, one more step profiled."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dmhomo_torch.cli import hem_train
    from dmhomo_torch.ops import swin_block as sb
    from dmhomo_torch.ops import window_attention as wa
    from dmhomo_torch.train.hem_trainer import HEMTrainer

    _plain_raises()
    losses, inside, held = [], [], {}
    step, steps = HEMTrainer.train_step, HEMTrainer.train_steps

    def before(trainer):
        if "batch" not in held:
            held["batch"] = _tiny_held_batch(trainer.config, seed)
            held["before"] = _held_loss(trainer, held["batch"])

    def one(self, batch):
        before(self)
        out = step(self, batch)
        if not inside:
            losses.append(out["total"].detach().clone())
        return out

    def many(self, batches):
        before(self)
        inside.append(1)
        try:
            out = steps(self, batches)
        finally:
            inside.pop()
        losses.extend(out["total"].detach().clone().unbind())
        return out

    HEMTrainer.train_step, HEMTrainer.train_steps = one, many
    counters = (wa.window_attention, wa.window_attention_backward, sb.swin_block,
                sb.swin_block_backward)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="tiny_", dir=build) as out:
        trainer = hem_train.main(["--synthetic", "64", "--tiny", "--steps", str(TINY_STEPS),
                                  "--attn", attn, "--fuse-steps", str(fuse), "--out", out,
                                  "--seed", str(seed)])
    result = {"losses": [float(v) for v in losses],
              "held": [held["before"], _held_loss(trainer, held["batch"])],
              "launches": {fn.__name__: dict(fn.launches_by_variant) for fn in counters}}
    if fuse > 1:
        result["per_replay"] = {k: dict(v) for k, v in
                                trainer.step_graph.launches_by_variant.items()}
        return result
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        HEMTrainer.train_step = step  # this step's loss is not one of the run's
        trainer.train_step(held["batch"])
        torch.cuda.synchronize()
    kernels = sorted({e.key for e in kernel_events(prof.key_averages())})
    N = WINDOW4 * WINDOW4
    # the plain window attention's products take (windows x heads, N, N) logits
    plain_ops = sorted({f"{e.key} {e.input_shapes}"
                        for e in prof.key_averages(group_by_input_shape=True)
                        if e.key in ("aten::bmm", "aten::baddbmm", "aten::_softmax",
                                     "aten::softmax")
                        and any(len(sh) >= 2 and sh[-1] == N and sh[-2] == N
                                for sh in e.input_shapes)})
    result["profile"] = {
        "generic": [k for k in kernels if "_any_" in k],
        "tuned": [k for k in kernels
                  if re.search(r"window_attention_(fwd|bwd|dbias)|swin_block_(fwd|bwd)_", k)],
        "bmm_softmax": sorted({k for k in kernels
                               if "bmm" in k.lower() or "softmax" in k.lower()}),
        "plain_window_ops": plain_ops}
    return result


TINY_RUNS = tuple((attn, fuse) for attn in ("auto", "fused_block") for fuse in (1, 5))


def start_tiny_children(seed: int) -> tuple:
    """Phase 28 (b)'s four children, started at once (each is a few seconds
    of card work after its start): (the processes, their start time)."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tiny-train-child",
                               f"{attn},{fuse}", "--seed", str(seed)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for attn, fuse in TINY_RUNS]
    return procs, time.perf_counter()


def generic_tiny_train(procs, t0: float) -> dict:
    """Phase 28 (b): ``hem_train --tiny --synthetic 64 --steps 10`` on the card
    in a child process under ``--attn auto`` and ``fused_block``, eagerly and
    with ``--fuse-steps 5`` (``start_tiny_children``; this waits for them):
    exit 0, finite losses, the loss on a held batch lower after the 10 steps
    than before, only generic kernels launched; a profiled eager step shows
    the generic kernels by name and no plain-path product of window logits.
    The step losses' first 3 and last 3 are logged beside it: each is the
    loss of another batch, and at 10 steps their spread exceeds what the
    steps move (the plain path on the CPU gives 8.00 then 8.63)."""
    out = {}
    try:
        outputs = [proc.communicate(timeout=600) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for (attn, fuse), proc, (stdout, stderr) in zip(TINY_RUNS, procs, outputs):
        tag = f"{attn} fuse={fuse}"
        if proc.returncode != 0:
            log(stdout[-3000:] + stderr[-6000:])
            raise SystemExit(f"hem_train --tiny --attn {tag} exited {proc.returncode}")
        r = json.loads(stdout.strip().splitlines()[-1])
        losses = r["losses"]
        if len(losses) != TINY_STEPS or not np.isfinite(losses).all():
            raise SystemExit(f"hem_train --tiny {tag}: losses {losses}")
        first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
        if not r["held"][1] < r["held"][0]:
            raise SystemExit(f"hem_train --tiny {tag}: the held batch's loss did not fall: "
                             f"{r['held']}")
        tuned = {n: v.get("tuned", 0) for n, v in r["launches"].items()}
        generic = {n: v.get("generic", 0) for n, v in r["launches"].items()}
        want = ("window_attention", "window_attention_backward") if attn == "auto" else \
            ("swin_block", "swin_block_backward")
        if any(tuned.values()) or not all(generic[n] > 0 for n in want):
            raise SystemExit(f"hem_train --tiny {tag}: launches by variant {r['launches']}")
        msg = (f"[generic-tiny] hem_train --tiny --attn {attn} --fuse-steps {fuse}: exit 0, "
               f"step losses {' '.join(f'{v:.4f}' for v in losses)} (first 3 {first:.4f}, "
               f"last 3 {last:.4f}); held batch {r['held'][0]:.4f} -> {r['held'][1]:.4f}; "
               f"eager-step launches by variant {generic}")
        if "per_replay" in r:
            per = r["per_replay"]
            if any(v.get("tuned", 0) for v in per.values()) or \
                    not all(per[n].get("generic", 0) > 0 for n in want):
                raise SystemExit(f"hem_train --tiny {tag}: launches per replay {per}")
            msg += f"; per replay {per}"
        if "profile" in r:
            p = r["profile"]
            if p["tuned"] or p["plain_window_ops"] or not p["generic"]:
                raise SystemExit(f"hem_train --tiny {tag}: profiled kernels {p}")
            msg += (f"; profiled step: generic kernels {p['generic']}, none of the tuned, no "
                    f"bmm/softmax on window logits (those by name: {p['bmm_softmax']}, the "
                    "class attention's)")
        log(msg)
        out[tag] = r
    log(f"[generic] (b) done {time.perf_counter() - t0:.1f} s after its children started "
        f"(they ran beside (a))")
    return out


def window4_train_config(attn: str, **kw):
    """The shipped HEM training config with the params.json window 4."""
    import dataclasses

    from dmhomo_torch.train.config import HEMTrainConfig

    base = HEMTrainConfig()
    est = dataclasses.replace(base.estimator, swin=dataclasses.replace(
        base.estimator.swin, window_size=WINDOW4))
    return dataclasses.replace(base, estimator=est, attn_impl=attn, **kw)


def _reset_counters(fns) -> None:
    for fn in fns:
        fn.launches = 0
        fn.launches_by_shape.clear()
        fn.launches_by_variant.clear()


def window4_train(dev, batch, seed: int, attn: str) -> dict:
    """Phase 28 (c)'s training: the shipped config (bf16, B=32, grad_accum 4)
    at window 4: eager steps (1 warm-up, 3 timed) with their launches per
    step by variant and by shape, a profiled eager step, then ``train_steps``
    (the capture, 1 warm-up, 3 timed replays) with the launches per replay
    counted at capture and a profiled replay."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dmhomo_torch.train.hem_trainer import LAUNCH_COUNTERS, HEMTrainer

    trainer = HEMTrainer(window4_train_config(attn), steps_per_epoch=1000, device=dev)
    trainer.init_state(seed)
    tag = f"w4-{attn}-train"
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for step in range(1 + 3):
        if step == 1:
            _reset_counters(LAUNCH_COUNTERS)
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(batch)["total"]))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    per_step = {fn.__name__: fn.launches / 3 for fn in LAUNCH_COUNTERS}
    by_variant = {fn.__name__: dict(fn.launches_by_variant) for fn in LAUNCH_COUNTERS}
    by_shape = {fn.__name__: {k: v / 3 for k, v in fn.launches_by_shape.items()}
                for fn in LAUNCH_COUNTERS}
    if not np.isfinite(losses).all() or any(v.get("tuned") for v in by_variant.values()):
        raise SystemExit(f"[{tag}] losses {losses}, launches by variant {by_variant}")
    step_ms = float(np.median(times[1:]))

    def profiled(fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = kernel_events(prof.key_averages())
        dev_ms = sum(e.self_device_time_total for e in events) / 1e3
        if dev_ms <= 0:
            raise SystemExit(f"[{tag}] the profiler saw no device time")
        generic = {k: sum(e.self_device_time_total for e in events if k in e.key) / 1e3
                   for k in ("window_attention_any_fwd", "window_attention_any_bwd",
                             "window_attention_any_reduce", "swin_block_any_")}
        return dev_ms, events, generic

    dev_ms, events, generic_ms = profiled(lambda: trainer.train_step(batch))
    idle = max(0.0, 1.0 - dev_ms / step_ms)
    log(f"[{tag}] eager: steps {', '.join(f'{t:.1f}' for t in times)} ms (median of the timed "
        f"{step_ms:.2f}), {1e3 * BATCH / step_ms:.2f} pairs/s, peak {peak / 2**30:.2f} GiB, "
        f"losses {', '.join(f'{v:.5f}' for v in losses)}; launches per step {per_step}, all "
        f"generic {by_variant}; profiled step: device busy {dev_ms:.2f} ms, idle "
        f"{100 * idle:.1f}%, generic kernels {json.dumps(generic_ms)}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[{tag}-profile] {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")

    gtimes = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + 1 + 3):
        t0 = time.perf_counter()
        out = trainer.train_steps([batch])
        losses.append(float(out["total"][0]))
        torch.cuda.synchronize()
        gtimes.append(1e3 * (time.perf_counter() - t0))
    sg = trainer.step_graph
    gpeak = torch.cuda.max_memory_allocated()
    g_ms = float(np.median(gtimes[2:]))
    if sg.launches != {k: round(v) for k, v in per_step.items()} or any(
            v.get("tuned") for v in sg.launches_by_variant.values()):
        raise SystemExit(f"[{tag}] launches per replay {sg.launches} "
                         f"{sg.launches_by_variant}, eager {per_step}")
    g_dev_ms, _, g_generic_ms = profiled(lambda: trainer.train_steps([batch]))
    g_idle = max(0.0, 1.0 - g_dev_ms / g_ms)
    if not np.isfinite(losses).all():
        raise SystemExit(f"[{tag}] graph losses {losses}")
    log(f"[{tag}] graph: first call (eager step + capture) {gtimes[0]:.1f} ms, replays "
        f"{', '.join(f'{t:.1f}' for t in gtimes[1:])} ms (median of the timed {g_ms:.2f}), "
        f"{1e3 * BATCH / g_ms:.2f} pairs/s, peak {gpeak / 2**30:.2f} GiB; launches per replay "
        f"{sg.launches} {json.dumps({k: dict(v) for k, v in sg.launches_by_variant.items()})}; "
        f"profiled replay: device busy {g_dev_ms:.2f} ms, idle {100 * g_idle:.1f}%")
    per_replay = dict(sg.launches)
    del trainer, sg
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "idle": idle, "peak_bytes": peak, "launches_per_step": per_step,
            "by_shape": by_shape, "dev_ms": dev_ms, "generic_ms": generic_ms,
            "graph_step_ms": g_ms, "graph_idle": g_idle, "graph_peak_bytes": gpeak,
            "graph_dev_ms": g_dev_ms, "graph_generic_ms": g_generic_ms,
            "launches_per_replay": per_replay, "losses": losses}


def generic_window4(dev, pairs, batch, seed: int) -> dict:
    """Phase 28 (c): the shipped estimator with the params.json window 4 (full
    width, every level's window 4x4) under ``--attn auto`` (the window
    kernels) and ``fused_block``: ``eval_forward`` on phase 4's 32 pairs
    (fp32; 40 generic launches a forward, none tuned), its profile, its flows
    against the CPU; the shipped training step at window 4 (``window4_train``);
    one fp32 training step card vs CPU (phase 9's rule)."""
    import torch

    from dmhomo_torch.config import EstimatorConfig, SwinConfig
    from dmhomo_torch.models.estimator import build_estimator
    from dmhomo_torch.ops import swin_block as sb
    from dmhomo_torch.ops import window_attention as wa

    t0 = time.perf_counter()
    out = {}
    counters = {"window_attention": wa.window_attention, "swin_block": sb.swin_block}
    for attn in ("auto", "fused_block"):
        impl = "xla" if attn == "auto" else attn  # 'auto' on the card: the window kernels
        cfg = EstimatorConfig(swin=SwinConfig(window_size=WINDOW4, attn_impl=impl))
        model = build_estimator(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
        _reset_counters(counters.values())
        launches, forwards, _, batch_ms, peak = phase_slice(model, pairs, counters,
                                                            tag=f"w4-{attn}-slice", reps=2)
        per_fwd = {n: v / forwards for n, v in launches.items()}
        variants = {n: dict(fn.launches_by_variant) for n, fn in counters.items()}
        want = {"window_attention": 40.0, "swin_block": 0.0} if attn == "auto" else \
            {"window_attention": 0.0, "swin_block": 40.0}
        if per_fwd != want or any(v.get("tuned") for v in variants.values()):
            raise SystemExit(f"[w4-{attn}-slice] launches per forward {per_fwd} by variant "
                             f"{variants}, expected {want}, all generic")
        eval_shapes = {n: {k: v / forwards for k, v in fn.launches_by_shape.items()}
                       for n, fn in counters.items()}
        dev_ms, idle = phase_profile(model, pairs, batch_ms, tag=f"w4-{attn}-profile")
        diffs = phase_card_vs_cpu(model, seed, tag=f"w4-{attn}-card-vs-cpu")
        del model
        torch.cuda.empty_cache()
        train = window4_train(dev, batch, seed, attn)
        step_diffs = phase_train_card_vs_cpu(dev, seed, attn_impl=attn,
                                             tag=f"w4-{attn}-train-card-vs-cpu",
                                             config=window4_train_config(attn))
        torch.cuda.empty_cache()
        out[attn] = {"batch_ms": batch_ms, "pairs_per_s": 1e3 * BATCH / batch_ms,
                     "eval_peak_bytes": peak, "eval_idle": idle, "eval_dev_ms": dev_ms,
                     "launches_per_forward": per_fwd, "eval_shapes": eval_shapes,
                     "card_vs_cpu": diffs, "train": train, "step_card_vs_cpu": step_diffs}
    log(f"[generic] (c) done in {time.perf_counter() - t0:.1f} s")
    return out


def generic_main_path_checks(dev, seed: int, w4: dict) -> dict:
    """Phase 28 (d), first: each generic kernel against its plain version at
    every shape phase 28 (c)'s paths gave it (the counters' keys of the eval
    forward and of the training step: B=32 and the microbatch of 8, every
    level, W-MSA and SW-MSA), forward and backward, in fp32 and in bf16,
    with the levels' own shifted-window masks and trained-looking block
    weights, at (a)'s tolerances (``_GenericChecks``); a miss fails the
    phase."""
    import torch

    from dmhomo_torch.models.swin import shifted_window_mask

    t0 = time.perf_counter()
    chk = _GenericChecks(dev, torch.Generator(device=dev).manual_seed(seed + 27))
    gen, N, shift = chk.gen, WINDOW4 * WINDOW4, WINDOW4 // 2
    a, f = w4["auto"], w4["fused_block"]
    wa_keys = [a["eval_shapes"]["window_attention"], a["train"]["by_shape"]["window_attention"],
               a["train"]["by_shape"]["window_attention_backward"]]
    sb_keys = [f["eval_shapes"]["swin_block"], f["train"]["by_shape"]["swin_block"],
               f["train"]["by_shape"]["swin_block_backward"]]
    wa_shapes = sorted({k[:4] for d in wa_keys for k in d})  # (Bn, C, heads, nW)
    sb_shapes = sorted({k[:5] + k[6:] for d in sb_keys for k in d})  # (B, H, W, C, heads, masked)
    levels = {(H // WINDOW4) * (W // WINDOW4): (H, W) for _, H, W, *_ in sb_shapes}
    for Bn, C, h, nW in wa_shapes:
        mask = (torch.from_numpy(shifted_window_mask(*levels[nW], WINDOW4, shift)).to(dev)
                if nW else None)
        bias = 0.5 * torch.randn(h, N, N, generator=gen, device=dev)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            qkv = torch.randn(Bn, N, 3 * C, generator=gen, device=dev).to(dt)
            gout = torch.randn(Bn, N, C, generator=gen, device=dev).to(dt)
            chk.window_attention(qkv, bias, mask, gout, h,
                                 f"window attention at Bn={Bn} C={C} heads={h} nW={nW} {dtype}")
            del qkv, gout
    for B, H, W, C, heads, masked in sb_shapes:
        s = {"C": C, "H": H, "W": W, "heads": heads, "ws": WINDOW4, "shift": shift}
        block = seeded_swin_blocks(s, dev, gen)[int(masked)]
        params = tuple(p.detach().contiguous() for p in block.fused_params())
        kw = dict(num_heads=heads, window_size=WINDOW4, shift=shift if masked else 0)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            x = torch.randn(B, H, W, C, generator=gen, device=dev).to(dt)
            dy = torch.randn(B, H, W, C, generator=gen, device=dev).to(dt)
            chk.block(x, params, block.attn_mask, dy, kw,
                      f"whole block at {B}x{H}x{W}x{C} heads={heads} shift={kw['shift']} {dtype}")
            del x, dy
        del block, params
    torch.cuda.empty_cache()
    if chk.noisy:
        log("[generic-main] fp32 gradients whose tolerance is phase 9's rule: "
            + "; ".join(chk.noisy))
    log(f"[generic-main] {len(wa_shapes)} window-attention and {len(sb_shapes)} whole-block "
        f"shapes of (c)'s paths, each in fp32 and bf16, forward and backward, against the "
        f"plain versions, reruns bit-identical; worst {chk.worst_text('')}")
    chk.raise_on_fails("generic-main")
    log(f"[generic] (d) checks done in {time.perf_counter() - t0:.1f} s")
    return {f"{k[0]} {k[1]}": v for k, v in chk.worst.items()}


def _wa_inputs(key, dev, gen):
    """qkv, bias, mask, gout at a window-attention counter key."""
    import torch

    Bn, C, heads, nW, dtype = key
    N = WINDOW4 * WINDOW4
    dt = getattr(torch, dtype)
    qkv = torch.randn(Bn, N, 3 * C, generator=gen, device=dev).to(dt)
    bias = 0.5 * torch.randn(heads, N, N, generator=gen, device=dev)
    gout = torch.randn(Bn, N, C, generator=gen, device=dev).to(dt)
    mask = None
    if nW:
        mask = torch.where(torch.rand(nW, N, N, generator=gen, device=dev) < 0.3, -100.0, 0.0)
    return qkv, bias, mask, gout


def generic_site_times(dev, seed: int, w4: dict) -> dict:
    """Phase 28 (d): each generic kernel at every shape phase 28 (c)'s paths
    gave it (their counters' keys): the median of 5 bursts of CUDA-event
    timed calls, its plain version, its yardstick (SDPA at N = 16 for the
    window attention, forward or forward + backward; the port's unfused
    SwinBlock for the whole block) and its bound; per eval forward and per
    training step, each shape weighted by its launches there."""
    import torch
    import torch.nn.functional as F

    from dmhomo_torch.models.swin import shifted_window_mask
    from dmhomo_torch.ops import swin_block as sb
    from dmhomo_torch.ops import window_attention as wa

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 28)
    N = WINDOW4 * WINDOW4
    rows = []

    def wa_row(key, per, where, backward):
        qkv, bias, mask, gout = _wa_inputs(key, dev, gen)
        Bn, C, h, nW, dtype = key
        hd = C // h
        q, k, v = (t.detach().clone().requires_grad_(backward) for t in
                   qkv.view(Bn, N, 3, h, hd).permute(2, 0, 3, 1, 4).unbind(0))
        am = bias[None].expand(Bn, h, N, N)
        if mask is not None:
            am = (am.reshape(Bn // nW, nW, h, N, N) + mask[None, :, None]).reshape(Bn, h, N, N)
        am = am.to(qkv.dtype).contiguous().requires_grad_(backward)
        if backward:
            g4 = gout.view(Bn, N, h, hd).transpose(1, 2)
            fn = lambda: wa.window_attention_backward(qkv, bias, mask, gout, num_heads=h)  # noqa
            plain = lambda: wa.window_attention_backward_reference(  # noqa: E731
                qkv, bias, mask, gout, num_heads=h)

            def lib():
                o = F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=hd**-0.5)
                return torch.autograd.grad(o, (q, k, v, am), g4)
        else:
            fn = lambda: wa.window_attention(qkv, bias, mask, num_heads=h)  # noqa: E731
            plain = lambda: wa.window_attention_reference(qkv, bias, mask, num_heads=h)  # noqa
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=am, scale=hd**-0.5)
        ms, times = burst_ms(fn, 5)
        plain_ms = burst_ms(plain, 2)[0]
        lib_ms = burst_ms(lib, 3)[0]
        b_ms, b_by = bound(qkv, bias, mask, backward)
        rows.append({"kernel": "window_attention_" + ("bwd" if backward else "fwd"),
                     "where": where, "Bn": Bn, "C": C, "heads": h, "nW": nW, "dtype": dtype,
                     "per": per, "ms": ms, "spread": spread(times), "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by})

    def sb_row(key, per, where, backward):
        B, H, W, C, heads, dtype, masked = key
        dt = getattr(torch, dtype)
        s = {"C": C, "H": H, "W": W, "heads": heads, "ws": WINDOW4, "shift": WINDOW4 // 2}
        blocks = seeded_swin_blocks(s, dev, gen)
        block = blocks[1 if masked else 0]
        params = tuple(p.detach().contiguous() for p in block.fused_params())
        mask = block.attn_mask
        x = torch.randn(B, H, W, C, generator=gen, device=dev).to(dt)
        dy = torch.randn(B, H, W, C, generator=gen, device=dev).to(dt)
        kw = dict(num_heads=heads, window_size=WINDOW4, shift=WINDOW4 // 2 if masked else 0)
        xt = x.reshape(B, H * W, C)
        if backward:
            fn = lambda: sb.swin_block_backward(x, params, mask, dy, **kw)  # noqa: E731
            plain = lambda: sb.swin_block_backward_reference(x, params, mask, dy, **kw)  # noqa
            xg = xt.detach().clone().requires_grad_()
            ps = [p for p in block.parameters() if p.requires_grad]

            def lib():
                with torch.autocast("cuda", dtype=dt, enabled=dt == torch.bfloat16):
                    y = block(xg)
                return torch.autograd.grad(y, [xg] + ps, dy.reshape(B, H * W, C).to(y.dtype))
            b_ms, b_by = block_bwd_bound(x, params, mask)
        else:
            fn = lambda: sb.swin_block(x, params, mask, **kw)  # noqa: E731
            plain = lambda: sb.swin_block_reference(x, params, mask, **kw)  # noqa: E731

            def lib():
                with torch.no_grad(), torch.autocast("cuda", dtype=dt,
                                                     enabled=dt == torch.bfloat16):
                    return block(xt)
            b_ms, b_by = block_bound(x, params, mask)
        ms, times = burst_ms(fn, 3)
        plain_ms = burst_ms(plain, 1)[0]
        lib_ms = burst_ms(lib, 2)[0]
        rows.append({"kernel": "swin_block_" + ("bwd" if backward else "fwd"), "where": where,
                     "B": B, "H": H, "W": W, "C": C, "heads": heads, "dtype": dtype,
                     "masked": masked, "per": per, "ms": ms, "spread": spread(times),
                     "plain_ms": plain_ms, "unfused_ms": lib_ms, "bound_ms": b_ms,
                     "bound_by": b_by})

    ev, tr = w4["auto"]["eval_shapes"], w4["auto"]["train"]["by_shape"]
    for key, per in ev["window_attention"].items():
        wa_row(key, per, "eval", False)
    for key, per in tr["window_attention"].items():
        wa_row(key, per, "step", False)
    for key, per in tr["window_attention_backward"].items():
        wa_row(key, per, "step", True)
    ev, tr = w4["fused_block"]["eval_shapes"], w4["fused_block"]["train"]["by_shape"]
    for key, per in ev["swin_block"].items():
        sb_row(key, per, "eval", False)
    for key, per in tr["swin_block"].items():
        sb_row(key, per, "step", False)
    for key, per in tr["swin_block_backward"].items():
        sb_row(key, per, "step", True)
    torch.cuda.empty_cache()
    totals = {}
    for r in rows:
        t = totals.setdefault((r["kernel"], r["where"]), {
            "launches": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
            "bound_by": set()})
        t["launches"] += r["per"]
        for k in ("ms", "plain_ms", "bound_ms"):
            t[k] += r[k] * r["per"]
        t["library_ms"] += r.get("library_ms", r.get("unfused_ms")) * r["per"]
        t["bound_by"].add(r["bound_by"])
        log(f"[generic-time] {r['kernel']} {r['where']} "
            + " ".join(f"{k}={r[k]}" for k in ("Bn", "B", "H", "W", "C", "heads", "nW",
                                               "dtype", "masked") if k in r)
            + f" x{r['per']:g}: {r['ms']:.4f} ms (bursts {r['spread']}), plain "
            f"{r['plain_ms']:.4f}, {'SDPA' if 'library_ms' in r else 'unfused'} "
            f"{r.get('library_ms', r.get('unfused_ms')):.4f}, bound {r['bound_ms']:.4f} "
            f"({r['bound_by']})")
    out = {}
    for (kernel, where), t in totals.items():
        t["bound_by"] = "bytes" if t["bound_by"] == {"bytes"} else "operations"
        out[f"{kernel} per {'forward' if where == 'eval' else 'step'}"] = t
        per = ("eval forward (B=32, fp32)" if where == "eval"
               else "training step (B=32 in 4 microbatches, the step's dtypes)")
        log(f"[generic-time] {kernel} per {per}: "
            f"{t['launches']:g} launches, {t['ms']:.3f} ms, plain {t['plain_ms']:.3f}, yardstick "
            f"{t['library_ms']:.3f}, bound {t['bound_ms']:.3f} ({t['bound_by']})")
    log(f"[generic] (d) done in {time.perf_counter() - t0:.1f} s")
    return {"totals": out, "rows": rows}


# ---------------------------------------------------------------------------
# phase 29: kernels 3-4 at any heads / dim_head, and the unconditional twin
# ---------------------------------------------------------------------------

LA_ANY_HEADS = (1, 2, 3, 8, 16)
LA_ANY_DIM_HEAD = (8, 12, 24, 64, 128)
LA_ANY_N = (256, 1024, 16384)
LA_ANY_C = (64, 256, 512)
LA_ANY_B = 2
# the twin at its shipped width (UncondUNetConfig(), UncondDiffusionConfig():
# dim 64, mults (1, 2, 4, 8), 128x128, fp32, 1000 steps, 250 DDIM steps)
UNCOND_BS = 16
UNCOND_TRAIN_STEPS = 13
UNCOND_LR = 1e-4
UNCOND_GENERIC = (8, 64)  # (attn_heads, attn_dim_head) of the generic paths
# the sampled twin's final_conv is drawn at this share of the LeCun scale:
# with the full scale the untrained noise prediction carries the image with a
# gain near 2 (the skip from init_conv through final_res_block's res_conv),
# so the 250-step DDIM chain grows about 1.5x a step and overflows, the plain
# version on the CPU as well (|img| 4.4 -> 2e19 in 80 steps, NaN at step 86);
# at 0.1 it stays near 1.2 through all 250 steps at both (4, 32) and (8, 64)
UNCOND_OUT_SCALE = 0.1
UNCOND_CPU_SIZE, UNCOND_CPU_BATCH = 64, 2  # card vs CPU, full width
GENERIC_DGM_STEPS = 3  # DGMTrainer steps of the conditional UNet at (8, 64)


def la_any_cases():
    """(heads, dim_head, N, C, dtype, prenorm, channel_major) of phase 29 (a):
    every (heads, dim_head) of the grid inside the envelope twice, once per
    dtype, with N, C, the prenorm mode and the layout cycling so that each
    value meets each other."""
    cases = []
    grid = [(h, d) for h in LA_ANY_HEADS for d in LA_ANY_DIM_HEAD if h * d <= 1024]
    for i, (h, d) in enumerate(grid):
        for j, dtype in enumerate(("float32", "bfloat16")):
            k = 2 * i + j
            cases.append((h, d, LA_ANY_N[k % 3], LA_ANY_C[(k // 3) % 3], dtype,
                          ("none", "gain", "stats")[(k // 2) % 3], k % 4 < 2))
    return cases


def _la_inputs(B, N, C, hd, dtype, channel_major, dev, gen):
    import torch

    x = 1.5 * torch.randn(B, C, N, generator=gen, device=dev) + 0.3
    x = (x.transpose(1, 2) if channel_major else x.transpose(1, 2).contiguous())
    w = torch.randn(C, 3 * hd, generator=gen, device=dev) / C**0.5
    g = 0.5 + torch.rand(C, generator=gen, device=dev)
    return x.to(getattr(torch, dtype)), w, g


def phase_la_any_kernels(dev, seed: int) -> dict:
    """(a): the generic kernels against their plain versions over the grid,
    forward (both passes, reruns bit-identical) and the backward through
    LinearAttentionFunction against autograd of the plain version; the
    generic variant forced at (4, 32) against the tuned kernels; the
    registers and spills of the library and the atomics in its machine
    code."""
    import torch

    from dmhomo_torch.ops import linear_attention as la

    t0 = time.perf_counter()
    entry = None
    for line in la.build_log(generic=True).splitlines():
        m = re.search(r"linear_attention_any_(pass1|pass2|reduce)_kernel(?:I(f|13__nv_bfloat16)"
                      r"Lb([01])E(?:Lb([01])E)?)?", line)
        if m:
            entry = m.group(1) + ("" if m.group(2) is None else
                                  f" {'fp32' if m.group(2) == 'f' else 'bf16'} prenorm={m.group(3)}"
                                  + ("" if m.group(4) is None else f" stats={m.group(4)}"))
        elif entry and ("registers" in line or "spill" in line):
            log(f"[la-any-build] {entry}: {line.split(':', 1)[-1].strip()}")
    atomics = la.atomic_instructions_any()
    for name, n in atomics.items():
        log(f"[la-any-sass] {name[:90]}: {n} atomic instructions")
    if any(atomics.values()):
        raise SystemExit(f"atomic instructions in the generic linear-attention kernels: {atomics}")

    gen = torch.Generator(device=dev).manual_seed(seed + 29)
    worst, rows = {}, []

    def note(key, value):
        worst[key] = max(worst.get(key, 0.0), value)

    for heads, dh, N, C, dtype, prenorm, cm in la_any_cases():
        hd = heads * dh
        x, w, g = _la_inputs(LA_ANY_B, N, C, hd, dtype, cm, dev, gen)
        pn = {"none": None, "gain": (g,), "stats": (*la.layer_norm_stats(x), g)}[prenorm]
        c0 = (la.linear_attention_pass1.generic, la.linear_attention_pass2.generic)
        got = la.linear_attention(x, w, heads, dh, prenorm=pn)
        again = la.linear_attention(x, w, heads, dh, prenorm=pn)
        launched = (la.linear_attention_pass1.generic - c0[0],
                    la.linear_attention_pass2.generic - c0[1])
        want = la.linear_attention_reference(x, w, heads, dh, prenorm=pn)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        same = torch.equal(got, again)
        layout_ok = (got.stride(1) == 1) == cm
        note(f"fwd {dtype}", err)
        r = {"heads": heads, "dim_head": dh, "N": N, "C": C, "dtype": dtype, "prenorm": prenorm,
             "channel_major": cm, "rel_err": err, "rerun_identical": same}
        ok = (bool(torch.isfinite(got).all()) and err <= LA_TOL[dtype] and same and layout_ok
              and launched == (2, 2))
        bwd = ""
        if prenorm != "stats":  # the Function takes no prenorm or (g,)
            dout = torch.randn(got.shape, generator=gen, device=dev).to(x.dtype)
            grads = []
            for fn in (la.linear_attention, la.linear_attention_reference):
                leaves = [x.detach().clone().requires_grad_(), w.clone().requires_grad_()]
                if prenorm == "gain":
                    leaves.append(g.clone().requires_grad_())
                out = fn(leaves[0], leaves[1], heads, dh,
                         prenorm=(leaves[2],) if prenorm == "gain" else None)
                grads.append(torch.autograd.grad(out, leaves, dout))
            berr = max(rel_err(a, b) for a, b in zip(*grads))
            note(f"bwd {dtype}", berr)
            r["bwd_rel_err"] = berr
            ok = ok and berr <= LA_BWD_TOL[dtype]
            bwd = f", backward {berr:.3g} (tol {LA_BWD_TOL[dtype]:g})"
            del grads, dout
        rows.append(r)
        log(f"[la-any] heads={heads} dim_head={dh} N={N} C={C} {dtype} prenorm={prenorm} "
            f"{'channel' if cm else 'token'}-major: rel err {err:.3g} (tol {LA_TOL[dtype]:g}){bwd}; "
            f"rerun identical {same}; generic launches {launched} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"generic linear attention disagrees with its plain version: {r}")
        del x, w, g, pn, got, again, want
    # forced generic at the tuned shape, the UNet's call, against the tuned kernels
    for N, C in ((16384, 64), (1024, 512)):
        for dtype in ("float32", "bfloat16"):
            x, w, g = _la_inputs(8, N, C, 128, dtype, True, dev, gen)
            tuned = la.linear_attention(x, w, prenorm=(g,))
            forced = la.linear_attention(x, w, prenorm=(g,), _generic=True)
            want = la.linear_attention_reference(x, w, prenorm=(g,))
            torch.cuda.synchronize()
            e_f, e_t, e_ft = rel_err(forced, want), rel_err(tuned, want), rel_err(forced, tuned)
            note(f"forced {dtype}", e_f)
            log(f"[la-any] forced generic at (4, 32) N={N} C={C} B=8 {dtype}: rel err "
                f"{e_f:.3g} against the plain version, the tuned kernels {e_t:.3g}; forced vs "
                f"tuned {e_ft:.3g} (tol {LA_TOL[dtype]:g} each against the plain version)")
            if not (e_f <= LA_TOL[dtype] and e_t <= LA_TOL[dtype]):
                raise SystemExit("the forced generic or the tuned kernels miss the plain version")
    log(f"[la-any] {len(rows)} grid cases, worst {json.dumps(worst)}; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"worst": worst, "rows": rows, "atomics": atomics}


def la_sites(model) -> int:
    """LinearAttention modules of a UNet: each runs both passes once a forward."""
    from dmhomo_torch.models.unet import LinearAttention

    return sum(isinstance(m, LinearAttention) for m in model.modules())


def _reset_la_counters():
    from dmhomo_torch.ops import linear_attention as la

    for fn in (la.linear_attention_pass1, la.linear_attention_pass2):
        fn.launches = fn.generic = fn.elementwise = 0


def _la_read_counters():
    from dmhomo_torch.ops import linear_attention as la

    return {"pass1": la.linear_attention_pass1.launches,
            "pass2": la.linear_attention_pass2.launches,
            "generic1": la.linear_attention_pass1.generic,
            "generic2": la.linear_attention_pass2.generic}


def _check_la_counts(counts, want: int, generic: bool, what: str):
    want_generic = want if generic else 0
    if (counts["pass1"], counts["pass2"]) != (want, want) or \
            (counts["generic1"], counts["generic2"]) != (want_generic, want_generic):
        raise SystemExit(f"{what}: linear-attention launches {counts}, expected {want} of each "
                         f"pass, {want_generic} of them generic")


def _synthetic_images(n: int, size: int, seed: int, dev):
    """n smooth (B, size, size, 3) images in [0, 1] made on the card from
    ``seed``: bilinear-upsampled 8x8 noise through a sigmoid."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(seed)
    low = torch.randn(n, 3, 8, 8, generator=gen, device=dev) * 1.5
    img = torch.sigmoid(F.interpolate(low, size=(size, size), mode="bilinear",
                                      align_corners=False))
    return img.permute(0, 2, 3, 1).contiguous()


def uncond_twin(dev, seed: int, heads: int, dim_head: int, tag: str) -> dict:
    """(b) or (c): the twin at its shipped width with (heads, dim_head) (its
    final_conv at UNCOND_OUT_SCALE of the random scale):
    UNCOND_BS samples through the 250 DDIM steps (counts from zero just
    before, read just after: 8 + 8 launches per UNet forward, generic
    exactly where (heads, dim_head) != (4, 32), the plain version made to
    raise), one profiled DDIM step for the idle share; UNCOND_TRAIN_STEPS
    steps of loss + backward + Adam at UNCOND_BS, the loss on a held batch
    with fixed (t, noise) before and after."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dmhomo_torch.diffusion.schedules import ddim_time_pairs
    from dmhomo_torch.diffusion.uncond import UncondDiffusionConfig, UnconditionalGaussianDiffusion
    from dmhomo_torch.models.unet_uncond import UncondUNetConfig, build_uncond_unet
    from dmhomo_torch.ops import linear_attention as la

    generic = la.variant(heads, dim_head) == "generic"
    cfg = dataclasses.replace(UncondUNetConfig(), attn_heads=heads, attn_dim_head=dim_head)
    dcfg = UncondDiffusionConfig()
    S, steps = dcfg.image_size, dcfg.sampling_timesteps
    model = build_uncond_unet(cfg, device=dev, generator=torch.Generator().manual_seed(seed + 29))
    with torch.no_grad():
        model.final_conv.weight.mul_(UNCOND_OUT_SCALE)
    gd = UnconditionalGaussianDiffusion(model, dcfg)
    n_sites = la_sites(model)
    n_params = sum(p.numel() for p in model.parameters())
    forwards = [0]
    model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    shape = (UNCOND_BS, S, S, dcfg.channels)
    # warm-up: two DDIM steps (cuDNN's algorithm choice, the kernels' first launches)
    pairs = ddim_time_pairs(dcfg.timesteps, steps)
    wgen = torch.Generator(device=dev).manual_seed(seed)
    img, x_sc = torch.randn(shape, device=dev, generator=wgen), torch.zeros(shape, device=dev)
    noise = torch.randn(shape, device=dev, generator=wgen)
    with torch.inference_mode(), PlainLinearAttentionRefused():
        for time_, time_next in pairs[:2]:
            img, x_sc = gd.ddim_step(img, x_sc, int(time_), int(time_next), noise)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    # the main path: counts from zero just before it, read just after
    _reset_la_counters()
    forwards[0] = 0
    t0 = time.perf_counter()
    with PlainLinearAttentionRefused():
        imgs = gd.sample(UNCOND_BS, generator=gen)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    counts = _la_read_counters()
    peak = torch.cuda.max_memory_allocated()
    if forwards[0] != steps:
        raise SystemExit(f"{tag}: {forwards[0]} UNet forwards in {steps} DDIM steps")
    _check_la_counts(counts, n_sites * steps, generic, f"{tag} sampling")
    if imgs.shape != shape or not bool(torch.isfinite(imgs).all()):
        raise SystemExit(f"{tag}: samples not finite of shape {tuple(imgs.shape)}")
    lo, hi = float(imgs.min()), float(imgs.max())
    if lo < 0.0 or hi > 1.0:
        raise SystemExit(f"{tag}: samples outside [0, 1]: {lo} .. {hi}")
    inside = float(((imgs > 0) & (imgs < 1)).float().mean())  # not clipped by x0's [-1, 1]
    step_ms = 1e3 * sample_s / steps
    time_, time_next = (int(t) for t in pairs[1])
    with torch.inference_mode():
        gd.ddim_step(img, x_sc, time_, time_next, noise)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            gd.ddim_step(img, x_sc, time_, time_next, noise)
            torch.cuda.synchronize()
    events = kernel_events(prof.key_averages())
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if dev_ms <= 0:
        raise SystemExit("the profiler saw no device time")
    idle = max(0.0, 1.0 - dev_ms / step_ms)
    la_ms = sum(e.self_device_time_total for e in events
                if "linear_attention" in e.key) / 1e3
    log(f"[{tag}] UncondUNet {n_params:,} parameters (seeded random), attn {heads} x "
        f"{dim_head} ({'generic' if generic else 'tuned'} kernels), fp32, {S}x{S}: "
        f"{UNCOND_BS} samples in {steps} DDIM steps: {1e3 * sample_s:.1f} ms, "
        f"{UNCOND_BS / sample_s:.3f} samples/s, {step_ms:.2f} ms per DDIM step, peak "
        f"{peak / 2**30:.2f} GiB; a profiled step: device busy {dev_ms:.2f} ms, idle "
        f"{100 * idle:.1f}%, linear attention {la_ms:.2f} ms; samples in [{lo:.3f}, {hi:.3f}], "
        f"{100 * inside:.1f}% strictly inside; "
        f"launches {counts} = {n_sites} + {n_sites} per UNet forward")
    del imgs, img, x_sc, noise
    # training: Adam at lr UNCOND_LR on UNCOND_BS images, fresh draws a step
    model.train()
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=UNCOND_LR)
    train_img = _synthetic_images(UNCOND_BS, S, seed + 2, dev)
    held_img = _synthetic_images(UNCOND_BS, S, seed + 3, dev)
    held_draws = gd.draw(held_img.shape, torch.Generator(device=dev).manual_seed(seed + 4), dev)
    tgen = torch.Generator(device=dev).manual_seed(seed + 5)

    def held_loss():
        with torch.no_grad():
            return float(gd.loss(held_img, draws=held_draws))

    before = held_loss()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_la_counters()
    times, losses = [], []
    with PlainLinearAttentionRefused():
        for _ in range(UNCOND_TRAIN_STEPS):
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = gd.loss(train_img, generator=tgen)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
    counts_train = _la_read_counters()
    train_peak = torch.cuda.max_memory_allocated()
    after = held_loss()
    _check_la_counts(counts_train, n_sites * UNCOND_TRAIN_STEPS, generic, f"{tag} training")
    train_ms = float(np.median(times[1:]))
    if not np.isfinite(losses).all() or not after < before:
        raise SystemExit(f"{tag}: training losses {losses}; held batch {before} -> {after}")
    log(f"[{tag}] training, batch {UNCOND_BS}, Adam lr {UNCOND_LR:g}: {UNCOND_TRAIN_STEPS} steps, "
        f"{train_ms:.2f} ms per step (median after the first, {times[0]:.1f} ms), peak "
        f"{train_peak / 2**30:.2f} GiB; losses {', '.join(f'{l:.4f}' for l in losses)}; held "
        f"batch (fixed t, noise) {before:.5f} -> {after:.5f}; launches {counts_train}")
    out = {"heads": heads, "dim_head": dim_head, "variant": "generic" if generic else "tuned",
           "sample_ms": 1e3 * sample_s, "samples_per_s": UNCOND_BS / sample_s,
           "ms_per_ddim_step": step_ms, "peak_bytes": peak, "idle": idle,
           "profiled_step_device_ms": dev_ms, "profiled_step_la_ms": la_ms,
           "inside_share": inside, "launches": counts, "launches_per_forward": n_sites,
           "train_step_ms": train_ms,
           "train_times_ms": times, "train_peak_bytes": train_peak, "train_losses": losses,
           "held_loss": [before, after], "train_launches": counts_train, "sites": n_sites}
    del opt, model, gd, train_img, held_img
    torch.cuda.empty_cache()
    return out


def uncond_self_condition_step(dev, seed: int) -> dict:
    """(b): one training step of the twin with ``self_condition``, the coin
    set: the stop-gradient estimate and the step's forward (8 + 8 launches
    each)."""
    import dataclasses

    import torch

    from dmhomo_torch.diffusion.uncond import UncondDiffusionConfig, UnconditionalGaussianDiffusion
    from dmhomo_torch.models.unet_uncond import UncondUNetConfig, build_uncond_unet

    cfg = dataclasses.replace(UncondUNetConfig(), self_condition=True)
    dcfg = dataclasses.replace(UncondDiffusionConfig(), self_condition=True)
    model = build_uncond_unet(cfg, device=dev, generator=torch.Generator().manual_seed(seed + 30))
    model.train()
    gd = UnconditionalGaussianDiffusion(model, dcfg)
    opt = torch.optim.Adam(model.parameters(), lr=UNCOND_LR)
    img = _synthetic_images(UNCOND_BS, dcfg.image_size, seed + 6, dev)
    t, noise, _ = gd.draw(img.shape, torch.Generator(device=dev).manual_seed(seed + 7), dev)
    coin = torch.ones((), dtype=torch.bool, device=dev)
    _reset_la_counters()
    t0 = time.perf_counter()
    with PlainLinearAttentionRefused():
        loss = gd.loss(img, draws=(t, noise, coin))
        loss.backward()
        opt.step()
    value = float(loss.detach())
    ms = 1e3 * (time.perf_counter() - t0)
    counts = _la_read_counters()
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    log(f"[uncond-selfcond] one self-conditioned step (coin set), batch {UNCOND_BS}: loss "
        f"{value:.5f}, {ms:.1f} ms, weights finite {finite}, launches {counts}")
    n_sites = la_sites(model)
    _check_la_counts(counts, 2 * n_sites, False, "self-conditioned step")
    if not (np.isfinite(value) and finite):
        raise SystemExit("the self-conditioned step is not finite")
    del model, opt, gd
    torch.cuda.empty_cache()
    return {"loss": value, "ms": ms, "launches": counts}


def _grad_rule(g_card, g_cpu, g_nudged, what):
    """Phase 9's rule for each gradient: within STEP_GRAD_TOL of its largest
    value, or STEP_NOISE_FACTOR times the CPU's own change for the nudged
    input.  Returns the worst (name, rel, tol)."""
    def rel(a, g):
        return float((a - g).abs().max()) / max(float(g.abs().max()), 1e-30)

    rels = {n: rel(g_card[n], g) for n, g in g_cpu.items()}
    tols = {n: max(STEP_GRAD_TOL, STEP_NOISE_FACTOR * rel(g_nudged[n], g))
            for n, g in g_cpu.items()}
    order = sorted(rels, key=lambda n: -rels[n] / tols[n])
    bad = [n for n in order if not rels[n] <= tols[n]]
    log(f"[{what}] gradients of {len(rels)} parameters; closest to their tolerance: "
        + ", ".join(f"{n} {rels[n]:.3g} (tol {tols[n]:.3g})" for n in order[:3]))
    if bad:
        raise SystemExit(f"{what}: gradients disagree {[(n, rels[n], tols[n]) for n in bad]}")
    return [(n, rels[n], tols[n]) for n in order[:3]]


def uncond_card_vs_cpu(dev, seed: int, heads: int, dim_head: int, with_loss: bool) -> dict:
    """One fp32 forward of the twin at full width (UNCOND_CPU_SIZE²,
    UNCOND_CPU_BATCH images) with the same weights on the card (kernels)
    and on the CPU (plain versions), held against the CPU's own change for
    an input nudged by GEN_INPUT_NOISE; with ``with_loss`` also one loss
    with injected draws and its gradients, under phase 9's rule."""
    import copy
    import dataclasses

    import torch

    from dmhomo_torch.diffusion.uncond import UncondDiffusionConfig, UnconditionalGaussianDiffusion
    from dmhomo_torch.models.unet_uncond import UncondUNetConfig, build_uncond_unet

    tag = f"uncond-card-vs-cpu {heads}x{dim_head}"
    cfg = dataclasses.replace(UncondUNetConfig(), attn_heads=heads, attn_dim_head=dim_head)
    dcfg = dataclasses.replace(UncondDiffusionConfig(), image_size=UNCOND_CPU_SIZE)
    cpu_model = build_uncond_unet(cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(seed + 31))
    card_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.default_rng(seed + 31)
    shape = (UNCOND_CPU_BATCH, UNCOND_CPU_SIZE, UNCOND_CPU_SIZE, 3)
    x = rng.normal(size=shape).astype(np.float32)
    nudge = (GEN_INPUT_NOISE * rng.normal(size=shape)).astype(np.float32)
    t = torch.tensor([17, 600])
    t0 = time.perf_counter()
    with torch.inference_mode():
        card = card_model(torch.from_numpy(x).to(dev), t.to(dev)).cpu()
        cpu = cpu_model(torch.from_numpy(x), t)
        nudged = cpu_model(torch.from_numpy(x + nudge), t)
    scale = float(cpu.abs().max())
    diff = float((card - cpu).abs().max()) / scale
    noise = float((nudged - cpu).abs().max()) / scale
    tol = max(GEN_CPU_TOL, GEN_NOISE_FACTOR * noise)
    log(f"[{tag}] fp32 forward {shape}: max |card - cpu| / max |cpu| = {diff:.3g}; the CPU's own "
        f"change for an input nudged by {GEN_INPUT_NOISE:g}: {noise:.3g}; tol {tol:.3g}")
    if not diff <= tol:
        raise SystemExit(f"{tag}: card and CPU forwards disagree: {diff} (tol {tol})")
    out = {"forward_rel": diff, "forward_rel_nudged_cpu": noise, "forward_tol": tol}
    if with_loss:
        img = rng.uniform(size=shape).astype(np.float32)
        draws = (rng.integers(0, dcfg.timesteps, (UNCOND_CPU_BATCH,)),
                 rng.normal(size=shape).astype(np.float32), False)
        img_nudged = (img + STEP_INPUT_NOISE * rng.normal(size=shape)).astype(np.float32)
        results = {}
        for where, model, d, im in (("card", card_model, dev, img), ("cpu", cpu_model, "cpu", img),
                                    ("nudged", cpu_model, "cpu", img_nudged)):
            model.zero_grad(set_to_none=True)
            gd = UnconditionalGaussianDiffusion(model, dcfg, device=d)
            loss = gd.loss(torch.from_numpy(im).to(d), draws=draws)
            loss.backward()
            results[where] = (float(loss.detach()), {n: p.grad.detach().cpu().clone()
                                            for n, p in model.named_parameters()})
        loss_rel = abs(results["card"][0] - results["cpu"][0]) / abs(results["cpu"][0])
        log(f"[{tag}] fp32 loss with injected draws: card {results['card'][0]:.7f} cpu "
            f"{results['cpu'][0]:.7f}: rel {loss_rel:.3g} (tol {STEP_LOSS_TOL:g})")
        if not loss_rel <= STEP_LOSS_TOL:
            raise SystemExit(f"{tag}: card and CPU losses disagree: {loss_rel}")
        out["loss_rel"] = loss_rel
        out["grad_closest"] = _grad_rule(results["card"][1], results["cpu"][1],
                                         results["nudged"][1], tag)
    out["cpu_s"] = time.perf_counter() - t0
    del card_model
    torch.cuda.empty_cache()
    return out


def cond_generic_path(dev, seed: int) -> dict:
    """(c): the conditional DGM UNet with attn (8, 64) at the shipped DGM
    config in bf16: one generate batch at dgm_sample's defaults and
    GENERIC_DGM_STEPS DGMTrainer steps (all linear-attention launches
    generic; the plain version made to raise), then one fp32 forward card
    vs CPU at UNCOND_CPU_SIZE²."""
    import copy
    import dataclasses

    import torch

    from dmhomo_torch.cli.dgm_sample import generate
    from dmhomo_torch.data.conditions import synthetic_condition_batches
    from dmhomo_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
    from dmhomo_torch.models.unet import UNetConfig, build_unet
    from dmhomo_torch.train.config import DGMTrainConfig

    heads, dh = UNCOND_GENERIC
    # generation: dgm_sample's defaults with the attention's heads and dim_head changed
    cfg = UNetConfig(dim=64, num_classes=1, dim_mults=(1, 2, 4, 8), dtype=torch.bfloat16,
                     attn_heads=heads, attn_dim_head=dh)
    model = build_unet(cfg, device=dev, generator=torch.Generator().manual_seed(seed + 32))
    gd = GaussianDiffusion(model, DiffusionConfig(
        image_size=GEN_SIZE, timesteps=1000, sampling_timesteps=GEN_STEPS, objective="pred_x0",
        cond_scale=3.0), device=dev)
    cond, classes = next(synthetic_condition_batches(GEN_BS, GEN_SIZE, GEN_BS, 1, seed + 32))
    cond_t = torch.from_numpy(cond).to(dev)
    cls_t = torch.from_numpy(classes.astype(np.int64)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_la_counters()
    t0 = time.perf_counter()
    with PlainLinearAttentionRefused():
        imgs, homos = generate(gd, cond_t, cls_t, gen)
    torch.cuda.synchronize()
    batch_ms = 1e3 * (time.perf_counter() - t0)
    counts = _la_read_counters()
    gen_peak = torch.cuda.max_memory_allocated()
    n_sites = la_sites(model)  # 8 as shipped
    _check_la_counts(counts, n_sites * GEN_STEPS, True, "conditional generation at (8, 64)")
    if not bool(torch.isfinite(imgs).all()) or float(imgs.min()) < 0 or float(imgs.max()) > 1:
        raise SystemExit("conditional generation at (8, 64): images not finite in [0, 1]")
    log(f"[cond-generic] conditional UNet attn {heads} x {dh}, bf16, dgm_sample's defaults (bs "
        f"{GEN_BS}, CFG batch {2 * GEN_BS}, {GEN_STEPS} DDIM steps, {GEN_SIZE}x{GEN_SIZE}), "
        f"without warm-up: {batch_ms:.1f} ms per batch, {batch_ms / GEN_STEPS:.2f} ms per DDIM "
        f"step, {1e3 * GEN_BS / batch_ms:.3f} samples/s, peak {gen_peak / 2**30:.2f} GiB; "
        f"launches {counts}")
    out = {"gen_batch_ms": batch_ms, "gen_ms_per_ddim_step": batch_ms / GEN_STEPS,
           "gen_samples_per_s": 1e3 * GEN_BS / batch_ms, "gen_peak_bytes": gen_peak,
           "gen_launches": counts}
    cpu_state = {k: v.cpu() for k, v in model.state_dict().items()}
    del model, gd, imgs, homos
    torch.cuda.empty_cache()
    # training: the shipped DGM config with the attention changed
    base = DGMTrainConfig()
    base = dataclasses.replace(base, unet=dataclasses.replace(base.unet, attn_heads=heads,
                                                              attn_dim_head=dh))
    B, S = base.train_batch_size, base.diffusion.image_size
    pool_c, pool_k = dgm_condition_pool(B, S, base.unet.num_classes, seed + 33, dev)

    def batch_of(step):
        return pool_c, pool_k

    trainer, tgen, first_ms, attempts = dgm_trainer_that_fits(base, dev, seed + 33, batch_of)
    accum, remat = trainer.config.gradient_accumulate_every, trainer.config.unet.remat
    per_step = n_sites * accum * (2 if remat else 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_la_counters()
    times, losses = [], []
    with PlainLinearAttentionRefused():
        for step in range(1, GENERIC_DGM_STEPS):
            t0 = time.perf_counter()
            res = trainer.train_step(*batch_of(step), generator=tgen)
            losses.append(float(res["loss"]))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
    counts_t = _la_read_counters()
    train_peak = torch.cuda.max_memory_allocated()
    _check_la_counts(counts_t, per_step * (GENERIC_DGM_STEPS - 1), True,
                     "DGM training at (8, 64)")
    if not np.isfinite(losses).all():
        raise SystemExit(f"DGM training at (8, 64): losses {losses}")
    step_ms = float(np.median(times))
    log(f"[cond-generic] DGMTrainer, shipped config with attn {heads} x {dh} (bf16, batch {B} in "
        f"microbatches of {B // accum}, remat {remat}; {attempts}): first step {first_ms:.1f} ms, "
        f"then {', '.join(f'{t:.1f}' for t in times)} ms ({1e3 * B / step_ms:.3f} training "
        f"samples/s), peak {train_peak / 2**30:.2f} GiB; losses {losses}; launches {counts_t} = "
        f"{per_step} + {per_step} per step, all generic")
    out.update({"train_first_ms": first_ms, "train_step_ms": step_ms, "train_times_ms": times,
                "train_samples_per_s": 1e3 * B / step_ms, "train_peak_bytes": train_peak,
                "train_losses": losses, "train_launches": counts_t, "microbatch": B // accum,
                "remat": remat})
    del trainer, pool_c, pool_k
    torch.cuda.empty_cache()
    # card vs CPU: one fp32 CFG forward at full width, UNCOND_CPU_SIZE²
    from dmhomo_torch.models.unet import ConditionalUNet

    cpu_model = ConditionalUNet(dataclasses.replace(cfg, dtype=torch.float32))
    cpu_model.load_state_dict(cpu_state)
    cpu_model.eval()
    card_model = copy.deepcopy(cpu_model).to(dev)
    S = UNCOND_CPU_SIZE
    rng = np.random.default_rng(seed + 34)
    x = rng.normal(size=(2, S, S, 6)).astype(np.float32)
    nudge = (GEN_INPUT_NOISE * rng.normal(size=x.shape)).astype(np.float32)
    rgb = rng.uniform(-1, 1, (2, S, S, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, S, S, 1)) > 0.2).astype(np.float32)

    def inputs(xx, d):
        return (torch.from_numpy(xx).to(d), torch.tensor([500, 500], device=d),
                torch.zeros(2, dtype=torch.long, device=d), torch.from_numpy(rgb).to(d),
                torch.from_numpy(mask).to(d), torch.tensor([True, False], device=d))

    with torch.inference_mode():
        card = card_model(*inputs(x, dev)).cpu()
        cpu = cpu_model(*inputs(x, "cpu"))
        nudged = cpu_model(*inputs(x + nudge, "cpu"))
    scale = float(cpu.abs().max())
    diff = float((card - cpu).abs().max()) / scale
    noise = float((nudged - cpu).abs().max()) / scale
    tol = max(GEN_CPU_TOL, GEN_NOISE_FACTOR * noise)
    log(f"[cond-generic] fp32 CFG forward (2, {S}, {S}, 6) at attn {heads} x {dh}: max |card - "
        f"cpu| / max |cpu| = {diff:.3g}; the CPU's own change for an input nudged by "
        f"{GEN_INPUT_NOISE:g}: {noise:.3g}; tol {tol:.3g}")
    if not diff <= tol:
        raise SystemExit(f"conditional UNet at (8, 64): card and CPU disagree {diff} (tol {tol})")
    out.update({"forward_rel": diff, "forward_rel_nudged_cpu": noise, "forward_tol": tol})
    del card_model
    torch.cuda.empty_cache()
    return out


def generic_la_site_times(dev, seed: int) -> dict:
    """(d): each generic kernel at the sites of (c)'s paths, as the UNet
    calls it (channel-major, prenorm, statistics computed by pass 1): the
    twin's sampling (B = UNCOND_BS, fp32, 128²) and the conditional
    generation (B = 2 * GEN_BS, bf16, 256²), both at (8, 64): errors against
    the plain version, the median of TIMING_BURSTS bursts, the plain
    version's time and the bound."""
    import torch

    from dmhomo_torch.models.unet import UNetConfig
    from dmhomo_torch.ops import linear_attention as la

    heads, dh = UNCOND_GENERIC
    hd = heads * dh
    gen = torch.Generator(device=dev).manual_seed(seed + 35)
    rows = []
    paths = (("uncond sampling", UNCOND_BS, "float32", 128),
             ("conditional generation", 2 * GEN_BS, "bfloat16", GEN_SIZE))
    for path, B, dtype, size in paths:
        for site, hw, C in linear_attention_sites(UNetConfig(), size):
            N = hw * hw
            x, w, g = _la_inputs(B, N, C, hd, dtype, True, dev, gen)
            want_sums = la.linear_attention_pass1_reference(x, w, heads, dh, (g,))
            want = la.linear_attention_pass2_reference(x, w, want_sums, heads, dh, (g,))
            sums = torch.empty_like(want_sums)
            mean = torch.empty((B, N), device=dev)
            rstd = torch.empty_like(mean)
            out = torch.empty((B, hd, N), dtype=x.dtype, device=dev).transpose(1, 2)

            def p1():
                la.linear_attention_pass1(x, w, g, mean, rstd, True, sums, heads, dh)

            def p2():
                la.linear_attention_pass2(x, w, g, mean, rstd, want_sums, out, heads, dh)

            p1()
            p2()
            torch.cuda.synchronize()
            e1, e2 = rel_err(sums, want_sums), rel_err(out, want)
            ms1, b1s = burst_ms(p1, iters=5)
            ms2, b2s = burst_ms(p2, iters=5)
            del want
            plain1 = cuda_ms(lambda: la.linear_attention_pass1_reference(x, w, heads, dh, (g,)),
                             iters=1, warmup=1)
            plain2 = cuda_ms(lambda: la.linear_attention_pass2_reference(x, w, want_sums, heads,
                                                                         dh, (g,)),
                             iters=1, warmup=1)
            (bd1, by1), (bd2, by2) = (linear_bound(x, p, heads, dh) for p in (1, 2))
            ok = e1 <= LA_TOL[dtype] and e2 <= LA_TOL[dtype]
            rows.append({"path": path, "site": site, "B": B, "N": N, "C": C, "dtype": dtype,
                         "heads": heads, "dim_head": dh, "rel_err_pass1": e1, "rel_err_pass2": e2,
                         "pass1_ms": ms1, "pass2_ms": ms2, "pass1_ms_bursts": b1s,
                         "pass2_ms_bursts": b2s, "plain1_ms": plain1, "plain2_ms": plain2,
                         "bound1_ms": bd1, "bound1_by": by1, "bound2_ms": bd2, "bound2_by": by2,
                         "plan1": la.generic_launch_plan(1, B, N, C, heads, dh),
                         "plan2": la.generic_launch_plan(2, B, N, C, heads, dh)})
            log(f"[la-any-site] {path} {site} {hw}x{hw} N={N} C={C} B={B} {dtype}: rel err pass1 "
                f"{e1:.3g} pass2 {e2:.3g} (tol {LA_TOL[dtype]:g}); pass1 {ms1:.3f} ms (bursts "
                f"{spread(b1s)}; bound {bd1:.3f} {by1}: {100 * bd1 / ms1:.1f}%; plain "
                f"{plain1:.3f}) pass2 {ms2:.3f} ms (bursts {spread(b2s)}; bound {bd2:.3f} {by2}: "
                f"{100 * bd2 / ms2:.1f}%; plain {plain2:.3f}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"generic kernels at {path} {site} disagree: {e1} {e2}")
            del x, w, g, sums, mean, rstd, out, want_sums
            torch.cuda.empty_cache()
    totals = {}
    for path, *_ in paths:
        pr = [r for r in rows if r["path"] == path]
        for p in (1, 2):
            totals[f"{path} pass{p}"] = {
                "ms": sum(r[f"pass{p}_ms"] for r in pr),
                "plain_ms": sum(r[f"plain{p}_ms"] for r in pr),
                "bound_ms": sum(r[f"bound{p}_ms"] for r in pr),
                "bound_by": ("bytes" if all(r[f"bound{p}_by"] == "bytes" for r in pr)
                             else "operations"),
                "max_rel_err": max(r[f"rel_err_pass{p}"] for r in pr)}
    for k, v in totals.items():
        log(f"[la-any-site] per UNet forward, {k}: {v['ms']:.3f} ms (bound {v['bound_ms']:.3f} "
            f"{v['bound_by']}, plain {v['plain_ms']:.3f})")
    return {"rows": rows, "totals": totals}


def phase_uncond(dev, seed: int) -> dict:
    """Phase 29: (a) the generic kernels over the grid, (b) the twin with
    the tuned kernels, (c) the generic kernels on the twin and the
    conditional UNet at (8, 64), (d) the generic kernels' times at (c)'s
    sites."""
    import torch

    t0 = time.perf_counter()
    grid = phase_la_any_kernels(dev, seed)
    torch.cuda.empty_cache()
    tuned = uncond_twin(dev, seed, 4, 32, "uncond-tuned")
    selfcond = uncond_self_condition_step(dev, seed)
    tuned_cpu = uncond_card_vs_cpu(dev, seed, 4, 32, with_loss=True)
    generic = uncond_twin(dev, seed, *UNCOND_GENERIC, "uncond-generic")
    generic_cpu = uncond_card_vs_cpu(dev, seed, *UNCOND_GENERIC, with_loss=False)
    cond = cond_generic_path(dev, seed)
    sites = generic_la_site_times(dev, seed)
    phase_s = time.perf_counter() - t0
    log(f"[uncond] phase 29 in {phase_s:.1f} s")
    return {"grid": grid, "tuned": tuned, "self_condition": selfcond, "tuned_card_vs_cpu": tuned_cpu,
            "generic": generic, "generic_card_vs_cpu": generic_cpu, "cond": cond,
            "sites": sites, "phase_s": phase_s}


def uncond_summary(u: dict) -> None:
    """The [summary] and [uncond-summary] lines of phase 29."""
    for key in ("tuned", "generic"):
        r = u[key]
        log(f"[summary] uncond twin ({r['heads']} x {r['dim_head']}, {r['variant']} kernels, fp32, "
            f"128x128, batch {UNCOND_BS}): {r['samples_per_s']:.3f} samples/s, "
            f"{r['ms_per_ddim_step']:.2f} ms per DDIM step, peak {r['peak_bytes'] / 2**30:.2f} "
            f"GiB, idle {100 * r['idle']:.1f}%; training step {r['train_step_ms']:.2f} ms, peak "
            f"{r['train_peak_bytes'] / 2**30:.2f} GiB, held loss {r['held_loss'][0]:.5f} -> "
            f"{r['held_loss'][1]:.5f}")
    c = u["cond"]
    log(f"[summary] conditional UNet at {UNCOND_GENERIC[0]} x {UNCOND_GENERIC[1]} (bf16): "
        f"generation {c['gen_batch_ms']:.1f} ms per batch of {GEN_BS} ({c['gen_samples_per_s']:.3f} "
        f"samples/s), DGM step {c['train_step_ms']:.1f} ms ({c['train_samples_per_s']:.3f} "
        f"samples/s, peak {c['train_peak_bytes'] / 2**30:.2f} GiB); phase 29 {u['phase_s']:.1f} s")
    log("[uncond-summary] " + json.dumps(json_keys(u), default=str))


def generic_la_entries(u: dict) -> list:
    """The ``generic`` entries of kernels 3 and 4 in the kernels line: per
    UNet forward of the twin at (8, 64) (B = UNCOND_BS, fp32, 128²), with
    the conditional generation's forward (B = 2 * GEN_BS, bf16) beside it."""
    out = []
    for p in (1, 2):
        t = u["sites"]["totals"][f"uncond sampling pass{p}"]
        c = u["sites"]["totals"][f"conditional generation pass{p}"]
        out.append({
            "source": "dmhomo_torch/csrc/linear_attention_any.cu",
            "launches": u["generic"]["launches"][f"generic{p}"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "max_abs_err": t["max_rel_err"],
            "max_rel_err_grid": {k: v for k, v in u["grid"]["worst"].items()},
            "unit": (f"sum over the 8 sites of one UncondUNet forward at attn "
                     f"{UNCOND_GENERIC[0]} x {UNCOND_GENERIC[1]}, B={UNCOND_BS}, fp32, 128x128; "
                     "max_abs_err is relative to the largest plain value"),
            "launches_train": u["generic"]["train_launches"][f"generic{p}"],
            "launches_cond_generation": u["cond"]["gen_launches"][f"generic{p}"],
            "launches_cond_dgm_steps": u["cond"]["train_launches"][f"generic{p}"],
            "cond_generation": {"ms": c["ms"], "plain_ms": c["plain_ms"],
                                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                                "max_rel_err": c["max_rel_err"],
                                "unit": (f"one conditional UNet forward at B={2 * GEN_BS}, "
                                         "bf16, 256x256")},
            "atomic_instructions": u["grid"]["atomics"],
        })
    return out


# ---------------------------------------------------------------------------
# phase 30: the rest of the DGM trainer (the graph step, shard_params, the
# milestone previews and dgm_sample --ckpt)
# ---------------------------------------------------------------------------

DGMS_MICROBATCH = 32  # phase 22's fit of the shipped batch of 128
DGMS_EAGER_STEPS = 3  # eager steps timed beside the graph's, after one warm-up
DGMS_WARMUP, DGMS_TIMED = 3, 10  # graph replays: the median of 10 after 3
DGMS_VS_EAGER_STEPS = 3  # fp32: the first eager, then two replays
DGMS_EMA_STEPS = 16  # fp32 graph steps before the EMA check (an update every 10)
SHARD_MODEL = 2
SHARD_SPEED_WARMUP, SHARD_SPEED_TIMED = 2, 5
DGMS_SPREAD_RUNS = 6  # 30e: fresh trainers per mode, and kernel 3 calls per dtype
DGMS_CHILD_S = 600  # a child's whole run; then it is killed and the phase fails
PREVIEW_STEPS, PREVIEW_EVERY = 10, 5
DGMS_TINY = ["--synthetic", "8", "--dim", "16", "--dim-mults", "1,2", "--image-size", "32"]


def dgm_graph_shipped(dev, seed: int) -> dict:
    """30a: the shipped config (bf16, 128 in microbatches of 32) eagerly
    (DGMS_EAGER_STEPS after a warm-up) and as a graph (one ``train_steps``
    call per step: the first an eager step and the capture, DGMS_WARMUP
    replays, DGMS_TIMED timed); launches per replay at capture and by name
    in a profiled replay; the idle share within that replay's wall span,
    unclamped; a profiled eager step's kernels against the replay's; peak
    memory with the graph's pool."""
    import dataclasses

    import torch

    from dmhomo_torch.ops import linear_attention as la
    from dmhomo_torch.train.config import DGMTrainConfig
    from dmhomo_torch.train.dgm_trainer import DGMTrainer

    base = DGMTrainConfig()
    B, S = base.train_batch_size, base.diffusion.image_size
    cfg = dataclasses.replace(base, gradient_accumulate_every=B // DGMS_MICROBATCH)
    cond, cls = dgm_condition_pool(B, S, base.unet.num_classes, seed + 30, dev)
    tr = DGMTrainer(cfg, device=dev)
    tr.init_state(seed + 30)
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    eager = []
    with PlainLinearAttentionRefused():
        for _ in range(1 + DGMS_EAGER_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(tr.train_step(cond, cls, generator=gen)["loss"])
            torch.cuda.synchronize()
            eager.append(1e3 * (time.perf_counter() - t0))
    eager_ms = float(np.median(eager[1:]))
    # a profiled eager step (before the capture: with the graph's pool held
    # an eager step does not fit) and, below, a profiled replay: the idle
    # share within each one's own wall span (profiling lengthens the
    # kernels), and where the eager step's extra device time goes
    profiled = {"eager": profiled_step(lambda: tr.train_step(cond, cls, generator=gen))}
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts from zero just before it, read just after
    for fn in (la.linear_attention_pass1, la.linear_attention_pass2):
        fn.launches = fn.generic = 0
    times, losses = [], []
    with PlainLinearAttentionRefused():
        for _ in range(1 + DGMS_WARMUP + DGMS_TIMED):
            t0 = time.perf_counter()
            losses.append(float(tr.train_steps(cond[None], cls[None], generator=gen)[0]))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
    counted = la_counts()
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    graph_ms = float(np.median(times[1 + DGMS_WARMUP:]))
    sg = tr.step_graph
    profiled["graph"] = profiled_step(
        lambda: tr.train_steps(cond[None], cls[None], generator=gen))
    events, prof_ms = profiled["graph"]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    by_name = {p: sum(e.count for e in events if f"linear_attention_pass{p}" in e.key)
               for p in (1, 2)}
    # kernel 3's reduction: one launch after each pass-1 launch
    by_name["reduce"] = sum(e.count for e in events if "linear_attention_reduce" in e.key)
    idle = 1.0 - busy / prof_ms
    eager_events, eager_prof_ms = profiled["eager"]
    eager_busy = sum(e.self_device_time_total for e in eager_events) / 1e3
    breakdown = eager_vs_graph_kernels(eager_events, events)
    per = len(linear_attention_sites(cfg.unet, S)) * cfg.gradient_accumulate_every
    want = {"linear_attention_pass1": per, "linear_attention_pass2": per,
            "linear_attention_pass1_generic": 0, "linear_attention_pass2_generic": 0}
    ok = (sg.launches == want and by_name == {1: per, 2: per, "reduce": per}
          and counted == (per, per) and busy > 0 and np.isfinite(losses).all())
    log(f"[dgm-steps] shipped config, B={B} in microbatches of {DGMS_MICROBATCH}, bf16: graph "
        f"step {graph_ms:.2f} ms (timed {', '.join(f'{t:.1f}' for t in times[1 + DGMS_WARMUP:])};"
        f" the first call, an eager step and the capture, {times[0]:.1f} ms), eager step "
        f"{eager_ms:.2f} ms (timed {', '.join(f'{t:.1f}' for t in eager[1:])}); "
        f"{1e3 * B / graph_ms:.3f} vs {1e3 * B / eager_ms:.3f} training samples/s; a profiled "
        f"replay: device busy {busy:.2f} ms of its {prof_ms:.2f} ms wall span, idle "
        f"{100 * idle:.2f}% (against the unprofiled median {100 * (1 - busy / graph_ms):.2f}%); "
        f"a profiled eager step: busy {eager_busy:.2f} ms of {eager_prof_ms:.2f}, idle "
        f"{100 * (1 - eager_busy / eager_prof_ms):.2f}%; peak {peak / 2**30:.2f} GiB with the "
        f"graph's pool (reserved {reserved / 2**30:.2f})")
    log(f"[dgm-steps] device time eager - graph, profiled: {eager_busy - busy:.2f} ms over "
        f"{breakdown['kernels_eager']} vs {breakdown['kernels_graph']} kernels; the largest "
        f"differences by kernel name (ms, eager - graph; count eager/graph) "
        f"{json.dumps(breakdown['largest'])}")
    log(f"[dgm-steps] linear-attention launches per replay at capture {sg.launches}, by name in "
        f"the profiled replay pass 1/2 {by_name[1]}/{by_name[2]} (pass 1's reduction "
        f"{by_name['reduce']}); counted over the main path "
        f"(the first call's eager step; replays run no Python) {counted}; expected {per} of each "
        f"({per // cfg.gradient_accumulate_every} sites x {cfg.gradient_accumulate_every} "
        f"microbatches), none generic or plain {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the DGM graph step launched other kernels than the eager step, or "
                         f"its loss is not finite: {losses}")
    del tr
    torch.cuda.empty_cache()
    return {"graph_step_ms": graph_ms, "graph_times": times, "eager_step_ms": eager_ms,
            "eager_times": eager, "idle": idle, "busy_ms": busy, "profiled_replay_ms": prof_ms,
            "eager_busy_ms": eager_busy, "profiled_eager_ms": eager_prof_ms,
            "eager_vs_graph_kernels": breakdown, "peak_bytes": peak,
            "reserved_bytes": reserved, "launches_per_replay": sg.launches,
            "launches_by_name": by_name, "launches_counted": counted, "losses": losses}


def profiled_step(step) -> tuple:
    """One call of ``step`` under torch.profiler: (its device kernels,
    its wall ms from before the call to the card's end)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with PlainLinearAttentionRefused():
            step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    return kernel_events(prof.key_averages()), wall


def eager_vs_graph_kernels(eager_events, graph_events, top: int = 8) -> dict:
    """Two profiles' device kernels by name: the counts, and the names whose
    total device time differs most (eager minus graph, ms)."""
    def by_name(events):
        out = {}
        for e in events:
            ms, n = out.get(e.key, (0.0, 0))
            out[e.key] = (ms + e.self_device_time_total / 1e3, n + e.count)
        return out

    a, b = by_name(eager_events), by_name(graph_events)
    diff = {k: (a.get(k, (0.0, 0))[0] - b.get(k, (0.0, 0))[0], a.get(k, (0.0, 0))[1],
                b.get(k, (0.0, 0))[1]) for k in set(a) | set(b)}
    largest = sorted(diff.items(), key=lambda kv: -abs(kv[1][0]))[:top]
    return {"kernels_eager": sum(n for _, n in a.values()),
            "kernels_graph": sum(n for _, n in b.values()),
            "largest": [(k[:90], round(d, 3), ne, ng) for k, (d, ne, ng) in largest]}


def dgm_graph_vs_eager(dev, seed: int) -> dict:
    """30b: phase 25's fp32 config (full width, 64x64, batch 4 in 2
    microbatches) with the shipped EMA rule: DGMS_VS_EAGER_STEPS steps by
    ``train_step`` (twice: the spread of eager runs) and by ``train_steps``
    (the first eager, then replays), the draws from generators seeded
    alike: phase 8c's rule; the generators' offsets after the steps equal
    (each replay drew anew, as each eager step did); then the graph trainer
    on to DGMS_EMA_STEPS steps: its EMA is its weights after step 10."""
    import dataclasses

    import torch

    from dmhomo_torch.train.dgm_trainer import DGMTrainer

    cfg, _, _, _ = dgm_dp_setup(seed)
    cfg = dataclasses.replace(cfg, ema_update_every=10)
    B, S = cfg.train_batch_size, cfg.diffusion.image_size
    cond, cls = dgm_condition_pool(B * DGMS_EMA_STEPS, S, cfg.unet.num_classes, seed + 32, dev)
    cond, cls = cond.reshape(DGMS_EMA_STEPS, B, S, S, 12), cls.reshape(DGMS_EMA_STEPS, B)
    n = DGMS_VS_EAGER_STEPS
    runs = {}
    for name in ("eager", "again", "graph"):
        tr = DGMTrainer(cfg, device=dev)
        tr.init_state(seed + 32)
        gen = torch.Generator(device=dev).manual_seed(seed + 33)
        with PlainLinearAttentionRefused():
            if name == "graph":
                losses = tr.train_steps(cond[:n], cls[:n], generator=gen)
            else:
                losses = torch.stack([tr.train_step(cond[k], cls[k], generator=gen)["loss"]
                                      for k in range(n)])
        torch.cuda.synchronize()
        runs[name] = (tr, losses, gen.get_offset())

    def differ(a, b):
        """Phase 8c's measures without BatchNorm: the losses relative, the
        weights' largest difference."""
        (ta, la_, _), (tb, lb, _) = runs[a], runs[b]
        with torch.no_grad():
            w = max(float((p - q).abs().max())
                    for p, q in zip(ta.model.parameters(), tb.model.parameters()))
        return {"loss_rel": float(((la_ - lb).abs() / lb.abs()).max()), "weight_abs": w}

    d, noise = differ("graph", "eager"), differ("again", "eager")
    offsets = {k: v[2] for k, v in runs.items()}
    graph = runs["graph"][0]
    launches = graph.step_graph.launches
    graph.train_steps(cond[n:10], cls[n:10], generator=runs["graph"][0].step_graph.generator)
    after_10 = [p.detach().clone() for p in graph.model.parameters()]
    graph.train_steps(cond[10:], cls[10:], generator=graph.step_graph.generator)
    torch.cuda.synchronize()
    ema_ok = graph.ema.step == graph.step == DGMS_EMA_STEPS and all(
        torch.equal(e, p) for e, p in zip(graph.ema.params, after_10))
    ok = (d["loss_rel"] <= GRAPH_LOSS_TOL and d["weight_abs"] <= GRAPH_LR_FACTOR * cfg.lr
          and offsets["graph"] == offsets["eager"] and ema_ok
          and launches["linear_attention_pass1"] == 8 * cfg.gradient_accumulate_every)
    want, got = runs["eager"][1], runs["graph"][1]
    log(f"[dgm-steps] fp32 {S}x{S}, batch {B} in {cfg.gradient_accumulate_every} microbatches, "
        f"{n} steps eager vs train_steps (step 1 eager, then replays), draws from generators "
        f"seeded alike: losses {', '.join(f'{x:.8f}' for x in want.tolist())} vs "
        f"{', '.join(f'{x:.8f}' for x in got.tolist())}: rel {d['loss_rel']:.3g} (tol "
        f"{GRAPH_LOSS_TOL:g}); weights max |graph - eager| {d['weight_abs']:.3g} (tol "
        f"{GRAPH_LR_FACTOR:g} lr = {GRAPH_LR_FACTOR * cfg.lr:g}); two eager runs differ by "
        f"{json.dumps(noise)}; generator offsets after the steps {offsets} (each replay drew "
        f"anew); launches per replay {launches}; the EMA after {DGMS_EMA_STEPS} graph steps "
        f"equals the weights after step 10: {ema_ok} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"the DGM graph step disagrees with the eager one: {d}, offsets "
                         f"{offsets}, EMA {ema_ok}, launches {launches}")
    del runs, graph
    torch.cuda.empty_cache()
    return {**d, "eager_vs_eager": noise, "generator_offsets": offsets, "ema_ok": ema_ok}


def _rank_state(tr) -> dict:
    """What a trainer stores (its masters, Adam's moments, its EMA), on
    the CPU, in the UNet's parameter order."""
    st = tr.optimizer.state
    return {"masters": [m.detach().cpu().clone() for m in tr.masters],
            "ema": [e.cpu().clone() for e in tr.ema.params],
            "moments": [(st[m]["exp_avg"].cpu().clone(), st[m]["exp_avg_sq"].cpu().clone())
                        for m in tr.masters],
            "step": tr.step, "ema_step": tr.ema.step}


def _same_state(a: dict, b: dict) -> bool:
    import torch

    return a["step"] == b["step"] and a["ema_step"] == b["ema_step"] and all(
        torch.equal(x, y) for key in ("masters", "ema") for x, y in zip(a[key], b[key])) and all(
        torch.equal(x[i], y[i]) for x, y in zip(a["moments"], b["moments"]) for i in (0, 1))


def shard_rank(rank: int, world: int, model: int, root: str, backend: str, seed: int,
               check: bool, dev=None) -> None:
    """30c, one rank (a child process of the phase): joins the group
    through ``root``, makes the (world / model, model) mesh; with ``check``,
    phase 25's fp32 step with ``shard_params`` on its data index's rows and
    the global draws, what it stores, and its checkpoint saved (rank 0
    writes) and loaded back into a new sharded trainer; writes
    ``root/rank<rank>.pt``.  With ``nccl`` (a card each), then
    :func:`shard_speed`."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from dmhomo_torch.parallel import distributed as pd
    from dmhomo_torch.parallel.mesh import make_mesh, shard_batch
    from dmhomo_torch.train.dgm_trainer import DGMTrainer

    speed = backend == "nccl"
    dev = dev or torch.device("cuda", rank if speed else 0)
    pd.maybe_initialize_distributed(backend=backend, init_method=f"file://{root}/pg",
                                    world_size=world, rank=rank, device=dev,
                                    timeout_s=DP_TIMEOUT_S)
    try:
        mesh = make_mesh(model=model)
        out = {"backend": dist.get_backend(), "world": world, "device": str(dev),
               "mesh": (mesh.data, mesh.model, mesh.data_index, mesh.model_index)}
        if check:
            dcfg, cond, cls, draws = dgm_dp_setup(seed)
            cfg = dataclasses.replace(dcfg, shard_params=True,
                                      results_dir=os.path.join(root, "ckpt"))
            tr = DGMTrainer(cfg, mesh=mesh, device=dev)
            tr.init_state(seed + 27)
            rows = [shard_batch(x, mesh.data_index, mesh.data, cfg.gradient_accumulate_every)
                    for x in (cond, cls)]
            c0 = la_counts()
            with PlainLinearAttentionRefused():
                loss = tr.loss_and_grads(*rows, draws=draws)
            launches = tuple(b - a for a, b in zip(c0, la_counts()))
            grads = {n: p.grad.detach().cpu().clone() for n, p in tr.model.named_parameters()}
            upd = tr.apply_gradients()
            sd = tr.state_dict()
            names = [n for n, _ in tr.model.named_parameters()]
            out["dgm"] = {
                "loss": float(loss), "grads": grads, "launches": launches,
                "grad_norm": float(upd["grad_norm"]),
                "params": [sd["model"][f"model.{n}"] for n in names],
                "ema_is_params": all(torch.equal(sd["ema"][f"ema_model.model.{n}"],
                                                 sd["model"][f"model.{n}"]) for n in names),
                "stored": tr.stored_elements(),
                "per_leaf": {n: (m.numel(), e.numel(), p.numel()) for n, m, e, p in
                             zip(names, tr.masters, tr.ema.params, tr.model.parameters())}}
            out["ckpt"] = tr.save()
            kept = _rank_state(tr)
            back = DGMTrainer(cfg, mesh=mesh, device=dev)
            back.init_state(seed + 99)
            back.load()
            out["roundtrip"] = _same_state(_rank_state(back), kept)
            del tr, back
            torch.cuda.empty_cache()
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
        if speed:
            shard_speed(rank, world, mesh, root, dev, seed, replicated_too=check)
    finally:
        dist.destroy_process_group()


def _timed_graph_steps(tr, cond, cls, gen, warmup: int, timed: int):
    """One ``train_steps`` call per step: (median ms of the timed, all,
    the losses)."""
    import torch

    times, losses = [], []
    for _ in range(1 + warmup + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(tr.train_steps(cond[None], cls[None], generator=gen)[0]))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times[1 + warmup:])), times, losses


def shard_graph_vs_eager(mesh, dev, seed: int) -> dict:
    """30c under ``nccl``, one rank: phase 25's fp32 config with
    ``shard_params`` over ``mesh`` (an EMA update every step),
    DGMS_VS_EAGER_STEPS steps by ``train_step`` and by ``train_steps`` (the
    first eager, then replays of a graph that holds the gathers, the data
    group's sum and the model group's sum of the clip norm), on this rank's
    rows, the draws from generators seeded alike by the data index, and a
    second eager run beside them (the spread of eager runs: kernel 3's
    atomic sums and Adam's first steps, which follow the signs of
    near-zero gradients): the measures of phase 8c's rule on the losses
    and on this rank's slices of the weights and the EMA, the generators'
    offsets, the launches."""
    import dataclasses

    import torch

    from dmhomo_torch.parallel.mesh import shard_stacked_batch
    from dmhomo_torch.train.dgm_trainer import DGMTrainer

    cfg, _, _, _ = dgm_dp_setup(seed)
    cfg = dataclasses.replace(cfg, shard_params=True)
    B, S, n = cfg.train_batch_size, cfg.diffusion.image_size, DGMS_VS_EAGER_STEPS
    cond, cls = dgm_condition_pool(B * n, S, cfg.unet.num_classes, seed + 36, dev)
    cond, cls = (shard_stacked_batch(x.reshape(n, B, *x.shape[1:]), mesh.data_index, mesh.data,
                                     cfg.gradient_accumulate_every) for x in (cond, cls))
    runs = {}
    for name in ("eager", "again", "graph"):
        tr = DGMTrainer(cfg, mesh=mesh, device=dev)
        tr.init_state(seed + 36)
        gen = torch.Generator(device=dev).manual_seed(seed + 37 + mesh.data_index)
        with PlainLinearAttentionRefused():
            if name == "graph":
                losses = tr.train_steps(cond, cls, generator=gen)
            else:
                losses = torch.stack([tr.train_step(cond[k], cls[k], generator=gen)["loss"]
                                      for k in range(n)])
        torch.cuda.synchronize()
        runs[name] = {"losses": losses.cpu(), "masters": [m.detach().cpu() for m in tr.masters],
                      "ema": [e.cpu() for e in tr.ema.params], "offset": gen.get_offset(),
                      "launches": None if tr.step_graph is None else tr.step_graph.launches}
        del tr
        torch.cuda.empty_cache()
    def differ(a, b):
        return {"loss_rel": float(((a["losses"] - b["losses"]).abs() / b["losses"].abs()).max()),
                "weight_abs": max(float((x - y).abs().max())
                                  for x, y in zip(a["masters"], b["masters"])),
                "ema_abs": max(float((x - y).abs().max()) for x, y in zip(a["ema"], b["ema"]))}

    e, g = runs["eager"], runs["graph"]
    return {"losses_eager": e["losses"].tolist(), "losses_graph": g["losses"].tolist(),
            **differ(g, e), "eager_vs_eager": differ(runs["again"], e),
            "offsets": [r["offset"] for r in runs.values()], "launches_per_replay": g["launches"],
            "accum": cfg.gradient_accumulate_every, "lr": cfg.lr, "mesh": mesh.shape}


def shard_loss_tol(c: dict) -> float:
    """Phase 8c's loss tolerance, or STEP_NOISE_FACTOR times the two eager
    runs' spread where that is the larger (phase 25's noise rule)."""
    return max(GRAPH_LOSS_TOL, STEP_NOISE_FACTOR * c["eager_vs_eager"]["loss_rel"])


def shard_graph_ok(c: dict) -> bool:
    """Phase 8c's rule on :func:`shard_graph_vs_eager`'s measures, the
    losses against :func:`shard_loss_tol`."""
    per = 8 * c["accum"]
    return (np.isfinite(c["losses_graph"]).all() and c["loss_rel"] <= shard_loss_tol(c)
            and c["weight_abs"] <= GRAPH_LR_FACTOR * c["lr"]
            and c["ema_abs"] <= GRAPH_LR_FACTOR * c["lr"] and len(set(c["offsets"])) == 1
            and c["launches_per_replay"] == {
                "linear_attention_pass1": per, "linear_attention_pass2": per,
                "linear_attention_pass1_generic": 0, "linear_attention_pass2_generic": 0})


def shard_speed(rank: int, world: int, mesh, root: str, dev, seed: int,
                replicated_too: bool) -> None:
    """30c, one rank on its own card: first :func:`shard_graph_vs_eager`;
    then the shipped DGM step (bf16, global batch 128, microbatches of
    DGMS_MICROBATCH per rank) as a graph with ``shard_params`` over
    ``mesh``; with ``replicated_too``, first the same step replicated over
    the ranks' ``data`` axis (``make_mesh()``).  Step times, the losses,
    per-rank peak memory and what the rank stores; writes
    ``root/speed<rank>.json``."""
    import dataclasses

    import torch

    from dmhomo_torch.parallel import distributed as pd
    from dmhomo_torch.parallel.mesh import make_mesh, shard_batch
    from dmhomo_torch.train.config import DGMTrainConfig
    from dmhomo_torch.train.dgm_trainer import DGMTrainer

    base = DGMTrainConfig()
    B, S = base.train_batch_size, base.diffusion.image_size
    cond, cls = dgm_condition_pool(B, S, base.unet.num_classes, seed + 34, dev)
    out = {"graph_vs_eager": shard_graph_vs_eager(mesh, dev, seed)}
    for name, m, shard in ((("replicated", make_mesh(), False),) if replicated_too else ()) + (
            ("sharded", mesh, True),):
        accum = B // m.data // DGMS_MICROBATCH
        cfg = dataclasses.replace(base, gradient_accumulate_every=accum, shard_params=shard)
        rows = [shard_batch(x, m.data_index, m.data, accum) for x in (cond, cls)]
        tr = DGMTrainer(cfg, mesh=m, device=dev)
        tr.init_state(seed + 34)
        gen = torch.Generator(device=dev).manual_seed(seed + 35 + m.data_index)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        pd.all_reduce_(torch.zeros(1, device=dev))  # start together
        ms, times, losses = _timed_graph_steps(tr, *rows, gen, SHARD_SPEED_WARMUP,
                                               SHARD_SPEED_TIMED)
        out[name] = {"mesh": m.shape, "step_ms": ms, "times": times, "losses": losses,
                     "accum": accum,
                     "peak_bytes": torch.cuda.max_memory_allocated(dev),
                     "stored": tr.stored_elements(),
                     "launches_per_replay": tr.step_graph.launches}
        del tr
        torch.cuda.empty_cache()
    with open(os.path.join(root, f"speed{rank}.json"), "w") as f:
        json.dump(out, f)


def _start_children(args_of, n: int):
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), *args_of(r)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(n)]


def _join(procs, what: str, timeout: float = DGMS_CHILD_S) -> list:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise SystemExit(f"{what} {i} failed ({p.returncode}):\n{text[-4000:]}")
    return logs


def dgm_shard_params(dev, seed: int, tmp: str) -> dict:
    """30c: (data 1, model SHARD_MODEL) in child processes (``nccl`` with a
    card each when there are 2, else ``gloo`` on card 0), phase 25's fp32
    step with ``shard_params`` against one process under phase 25's rule;
    each rank's share of the sharded leaves' parameter, Adam and EMA
    elements; the checkpoint (one file) loaded back by the ranks and by one
    process.  With 2 cards the shipped step sharded over (1, 2) beside the
    replicated 2-card step; with 4, also over (2, 2)."""
    import dataclasses

    import torch

    from dmhomo_torch.train.dgm_trainer import DGMTrainer

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= SHARD_MODEL else "gloo"
    root = os.path.join(tmp, "shard")
    os.makedirs(root)

    def child(world, model, d, check):
        return lambda r: ["--seed", str(seed), "--shard-rank", str(r), "--shard-world",
                          str(world), "--shard-model", str(model), "--shard-dir", d,
                          "--shard-backend", backend] + (["--shard-check"] if check else [])

    procs = _start_children(child(SHARD_MODEL, SHARD_MODEL, root, True), SHARD_MODEL)
    # meanwhile, one process: the same seeds and draws
    dcfg, cond, cls, draws = dgm_dp_setup(seed)
    nudged = (cond + STEP_INPUT_NOISE * np.random.default_rng(seed).normal(size=cond.shape)
              ).astype(np.float32)
    dt = DGMTrainer(dcfg, device=dev)
    dt.init_state(seed + 27)
    dt.loss_and_grads(nudged, cls, draws=draws)
    g_nudged = {n: p.grad.detach().cpu().clone() for n, p in dt.model.named_parameters()}
    want_loss = float(dt.loss_and_grads(cond, cls, draws=draws))
    g_want = {n: p.grad.detach().cpu().clone() for n, p in dt.model.named_parameters()}
    upd = dt.apply_gradients()
    p_want = [p.detach().cpu() for p in dt.model.parameters()]
    del dt
    _join(procs, "shard_params rank")
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(SHARD_MODEL)]
    out = {"backend": backend, "cards": cards, "ranks": []}
    for r, got in enumerate(ranks):
        g = got["dgm"]
        loss_rel = abs(g["loss"] - want_loss) / abs(want_loss)
        rels = {n: float((g["grads"][n] - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                for n, v in g_want.items()}
        tols = {n: max(STEP_GRAD_TOL, STEP_NOISE_FACTOR * float((g_nudged[n] - v).abs().max())
                       / max(float(v.abs().max()), 1e-30)) for n, v in g_want.items()}
        bad = [n for n in rels if not rels[n] <= tols[n]]
        diff = torch.cat([(a - b).abs().flatten() for a, b in zip(g["params"], p_want)])
        norm_rel = abs(g["grad_norm"] - float(upd["grad_norm"])) / float(upd["grad_norm"])
        st = g["stored"]
        share = {"params": st["sharded_stored"] / st["sharded_full"]}
        halves = all(m * SHARD_MODEL == p and e == m for m, e, p in g["per_leaf"].values()
                     if m != p)
        share["adam"] = (st["adam"] / 2 - st["replicated"]) / st["sharded_full"]
        share["ema"] = (st["ema"] - st["replicated"]) / st["sharded_full"]
        worst = max(rels, key=lambda n: rels[n] / tols[n])
        ok = (not bad and loss_rel <= STEP_LOSS_TOL and norm_rel <= STEP_GRAD_TOL
              and float(diff.max()) <= 2 * dcfg.lr + 1e-6
              and float((diff > 1e-6).float().mean()) < 0.01 and g["ema_is_params"]
              and g["launches"] == (8 * dcfg.gradient_accumulate_every,) * 2 and got["roundtrip"]
              and halves and all(abs(v - 1 / SHARD_MODEL) < 1e-12 for v in share.values())
              and got["backend"] == backend)
        log(f"[dgm-shard] rank {r} {got['mesh']} (data, model, data index, model index) on "
            f"{got['device']}, {backend}: fp32 step with shard_params against one process: loss "
            f"rel {loss_rel:.3g} (tol {STEP_LOSS_TOL:g}); closest gradient {worst} "
            f"{rels[worst]:.3g} (tol {tols[worst]:.3g}); global norm rel {norm_rel:.3g}; "
            f"weights after Adam max {float(diff.max()):.3g} (2 lr = {2 * dcfg.lr:g}); EMA = "
            f"weights {g['ema_is_params']}; linear-attention launches {g['launches']}; stores "
            f"{st['sharded_leaves']} of {st['leaves']} leaves sharded: share of their elements "
            f"held {json.dumps(share)} (each sharded leaf halved: {halves}); replicated "
            f"{st['replicated']:,} elements; checkpoint saved and loaded back by the ranks: "
            f"{got['roundtrip']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"rank {r}: the shard_params step or its state disagrees: loss "
                             f"{loss_rel}, gradients {[(n, rels[n], tols[n]) for n in bad]}, "
                             f"norm {norm_rel}, share {share}")
        out["ranks"].append({"loss_rel": loss_rel, "grad_norm_rel": norm_rel,
                             "param_max_diff": float(diff.max()), "share": share,
                             "stored": st, "mesh": got["mesh"]})
    files = sorted(os.listdir(os.path.join(root, "ckpt")))
    one = DGMTrainer(dataclasses.replace(dcfg, results_dir=os.path.join(root, "ckpt")),
                     device=dev)
    one.init_state(seed + 98)
    one.load()
    loaded = [p.detach().cpu() for p in one.model.parameters()]
    same = files == ["model-1.pt"] and all(torch.equal(a, b) for a, b in
                                           zip(loaded, ranks[0]["dgm"]["params"]))
    log(f"[dgm-shard] checkpoint files {files}; loaded into one replicated trainer: the ranks' "
        f"gathered weights {same}")
    if not same:
        raise SystemExit("the sharded checkpoint did not load into a replicated trainer")
    del one
    torch.cuda.empty_cache()
    out["checkpoint_loads_replicated"] = same
    if backend != "nccl":
        log(f"[dgm-shard] the shipped step sharded over (1, {SHARD_MODEL}): not run ({cards} "
            f"card(s); ranks sharing one card measure no step)")
        return out
    speeds = [json.load(open(os.path.join(root, f"speed{r}.json"))) for r in range(SHARD_MODEL)]
    out["speed"] = {"1x2": speeds}
    if cards >= 4:
        root4 = os.path.join(tmp, "shard4")
        os.makedirs(root4)
        _join(_start_children(child(4, SHARD_MODEL, root4, False), 4), "(2, 2) rank")
        out["speed"]["2x2"] = [json.load(open(os.path.join(root4, f"speed{r}.json")))
                               for r in range(4)]
    for name, ranks_speed in out["speed"].items():
        checks = [s["graph_vs_eager"] for s in ranks_speed]
        ok = all(shard_graph_ok(c) for c in checks)
        log(f"[dgm-shard] fp32 {DGM_CPU_SIZE}x{DGM_CPU_SIZE} step with shard_params over mesh "
            f"{checks[0]['mesh']}, {DGMS_VS_EAGER_STEPS} steps eager vs train_steps (step 1 "
            f"eager, then replays of a graph holding the gathers and the collectives), draws "
            f"from generators seeded alike, per rank: losses rel "
            f"{[c['loss_rel'] for c in checks]} (tol {[shard_loss_tol(c) for c in checks]}: "
            f"{GRAPH_LOSS_TOL:g}, or {STEP_NOISE_FACTOR:g} x the two eager runs' "
            f"{[c['eager_vs_eager']['loss_rel'] for c in checks]}); weight slices max "
            f"{[c['weight_abs'] for c in checks]} (eager runs "
            f"{[c['eager_vs_eager']['weight_abs'] for c in checks]}), EMA slices max "
            f"{[c['ema_abs'] for c in checks]} (tol {GRAPH_LR_FACTOR:g} lr = "
            f"{GRAPH_LR_FACTOR * checks[0]['lr']:g}); generator offsets (eager, again, graph) "
            f"{[c['offsets'] for c in checks]}; launches per replay "
            f"{checks[0]['launches_per_replay']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the sharded graph step disagrees with the eager one: {checks}")
        for kind in ("replicated", "sharded"):
            rows = [s[kind] for s in ranks_speed if kind in s]
            if not rows:
                continue
            if not all(np.isfinite(r["losses"]).all() for r in rows):
                raise SystemExit(f"the shipped {kind} step's losses over {name} are not finite: "
                                 f"{[r['losses'] for r in rows]}")
            log(f"[dgm-shard] shipped DGM step ({kind}, mesh {rows[0]['mesh']}, {len(rows)} "
                f"cards, bf16, global batch 128, microbatches of {DGMS_MICROBATCH} per rank, "
                f"accum {rows[0]['accum']}) as a graph: "
                f"{max(r['step_ms'] for r in rows):.2f} ms (per rank "
                f"{[round(r['step_ms'], 2) for r in rows]}), per-rank peak "
                f"{[round(r['peak_bytes'] / 2**30, 2) for r in rows]} GiB; losses (finite) "
                f"{rows[0]['losses']}; stored elements "
                f"{rows[0]['stored']}; launches per replay {rows[0]['launches_per_replay']}")
    return out


def _png_ok(path: str) -> dict:
    """A PNG's signature, IHDR size and IDAT inflating to H * (1 + 3W) bytes."""
    import struct
    import zlib

    data = open(path, "rb").read()
    ok = data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while ok and pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        chunks[data[pos + 4:pos + 8]] = chunks.get(data[pos + 4:pos + 8], b"") + \
            data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h = struct.unpack(">II", chunks[b"IHDR"][:8])
    raw = zlib.decompress(chunks[b"IDAT"])
    return {"ok": ok and len(raw) == h * (1 + 3 * w), "w": w, "h": h}


def start_preview_child(tmp: str):
    """30d's training child: ``dgm_train`` at a small config, PREVIEW_STEPS
    steps by ``--fuse-steps 5``, previews every PREVIEW_EVERY."""
    results = os.path.join(tmp, "train")
    cmd = [sys.executable, "-m", "dmhomo_torch.cli.dgm_train", *DGMS_TINY, "--batch-size", "4",
           "--accum", "2", "--steps", str(PREVIEW_STEPS), "--save-every", str(PREVIEW_EVERY),
           "--fuse-steps", str(PREVIEW_EVERY), "--preview-every", str(PREVIEW_EVERY),
           "--results", results]
    cwd = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), results


def dgm_previews(train_proc, results: str, tmp: str) -> dict:
    """30d: the training child's previews and logged photometric errors,
    then ``dgm_sample --ckpt <its root> --preview-every 1``."""
    t0 = time.perf_counter()
    train_log = _join([train_proc], "dgm_train child")[0]
    errs = [float(x) for x in re.findall(r"photometric error (\S+)", train_log)]
    cmd = [sys.executable, "-m", "dmhomo_torch.cli.dgm_sample", "--ckpt", results, *DGMS_TINY,
           "--s-step", "4", "--bs", "2", "--batches", "2", "--exp", "e", "--preview-every", "1",
           "--out", os.path.join(tmp, "gen")]
    sample = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    sample_log = _join([sample], "dgm_sample child")[0]
    previews = {os.path.relpath(p, tmp): _png_ok(p) for p in sorted(
        [os.path.join(results, "previews", f) for f in os.listdir(os.path.join(results, "previews"))]
        + [os.path.join(tmp, "gen", "e", "previews", f)
           for f in os.listdir(os.path.join(tmp, "gen", "e", "previews"))])}
    want = [f"train/previews/sample-{s}.png" for s in range(PREVIEW_EVERY, PREVIEW_STEPS + 1,
                                                             PREVIEW_EVERY)] + \
        [f"gen/e/previews/shard_00_batch_{b:05d}.png" for b in range(2)]
    ok = (sorted(previews) == sorted(want) and all(v["ok"] for v in previews.values())
          and len(errs) == len(want) - 2 and np.isfinite(errs).all()
          and "loaded reference checkpoint" in sample_log)
    log(f"[dgm-previews] dgm_train --fuse-steps {PREVIEW_EVERY} --preview-every {PREVIEW_EVERY} "
        f"({PREVIEW_STEPS} steps) and dgm_sample --ckpt <its root> --preview-every 1 in child "
        f"processes, both exit 0: previews {json.dumps(previews)}; photometric errors {errs} "
        f"{'ok' if ok else 'FAIL'} ({time.perf_counter() - t0:.1f} s after training started)")
    if not ok:
        raise SystemExit(f"previews: {previews}, errors {errs}\n{train_log[-2000:]}\n"
                         f"{sample_log[-2000:]}")
    return {"previews": previews, "photometric_errors": errs}


def dgm_step_spread(dev, seed: int) -> dict:
    """30e, no gate: how far one DGM step's gradients move from run to run
    on the card.  The small config of ``tests/test_torch_dgm_train_cli.py``'s
    remat test (dim 16, mults (1, 2), 32x32, batch 4 in 2 microbatches,
    fp32) with the same draws, DGMS_SPREAD_RUNS fresh trainers each without
    remat, with remat, and without remat under cuDNN's deterministic
    algorithms: each run's largest gradient difference from the first run
    without remat, relative to that gradient's largest value; then
    kernel 3's sums at that config's 16x16 sites (B 2, N 256, C 32) over
    DGMS_SPREAD_RUNS calls on one input, in both dtypes: how many differ
    bitwise from the first call (none since its partials are summed in a
    fixed order; phase 31 (d) holds it to that).
    Its launches are taken back off the counters: no main path runs here."""
    import torch

    from dmhomo_torch.diffusion.gaussian import DiffusionConfig
    from dmhomo_torch.models.unet import UNetConfig
    from dmhomo_torch.ops import linear_attention as la
    from dmhomo_torch.train.config import DGMTrainConfig
    from dmhomo_torch.train.dgm_trainer import DGMTrainer

    counters = [(fn, fn.launches, fn.generic)
                for fn in (la.linear_attention_pass1, la.linear_attention_pass2)]
    rng = np.random.default_rng(seed + 38)
    cond, cls = dgm_condition_pool(4, 32, 2, seed + 38, dev)
    draws = [(rng.integers(0, 1000, (2,)), rng.normal(size=(2, 32, 32, 6)).astype(np.float32),
              np.array([True, False])) for _ in range(2)]
    runs = {}
    for mode in ("no_remat", "remat", "no_remat_cudnn_deterministic"):
        cfg = DGMTrainConfig(unet=UNetConfig(dim=16, dim_mults=(1, 2), num_classes=2,
                                             remat=mode == "remat"),
                             diffusion=DiffusionConfig(image_size=32, sampling_timesteps=4),
                             train_batch_size=4, gradient_accumulate_every=2, bf16=False)
        torch.backends.cudnn.deterministic = mode.endswith("deterministic")
        try:
            for _ in range(DGMS_SPREAD_RUNS):
                tr = DGMTrainer(cfg, device=dev)
                tr.init_state(seed + 38)
                with PlainLinearAttentionRefused():
                    loss = float(tr.loss_and_grads(cond, cls, draws=draws))
                runs.setdefault(mode, []).append((loss, {
                    n: p.grad.detach().cpu().clone() for n, p in tr.model.named_parameters()}))
        finally:
            torch.backends.cudnn.deterministic = False
    ref = runs["no_remat"][0][1]

    def worst(grads):
        return max((float((g - ref[n]).abs().max()) / (float(ref[n].abs().max()) + 1e-30), n)
                   for n, g in grads.items())

    # the first run without remat is the reference
    spread = {mode: [worst(g) for _, g in (rs[1:] if mode == "no_remat" else rs)]
              for mode, rs in runs.items()}
    losses = sorted({loss for rs in runs.values() for loss, _ in rs})
    gen = torch.Generator(device=dev).manual_seed(seed + 39)
    x32 = torch.randn(2, 32, 256, device=dev, generator=gen).transpose(1, 2)
    w = torch.randn(32, 384, device=dev, generator=gen) * 32 ** -0.5
    g = torch.rand(32, device=dev, generator=gen) + 0.5
    sums = {}
    for dt in (torch.float32, torch.bfloat16):
        x = x32.to(dt)
        outs = []
        for _ in range(DGMS_SPREAD_RUNS):
            s = torch.zeros(2, la.sums_width(4, 32), device=dev)
            la.linear_attention_pass1(x, w, g, torch.empty(2, 256, device=dev),
                                      torch.empty(2, 256, device=dev), True, s)
            outs.append(s)
        sums[str(dt)[6:]] = {
            "differ_bitwise": sum(not torch.equal(o, outs[0]) for o in outs[1:]),
            "max_rel": max(float((o - outs[0]).abs().max() / outs[0].abs().max())
                           for o in outs[1:])}
    for fn, launches, generic in counters:
        fn.launches, fn.generic = launches, generic
    log(f"[dgm-steps] run-to-run spread of one fp32 step (dim 16, 32x32, batch 4 in 2 "
        f"microbatches, the same draws), {DGMS_SPREAD_RUNS} fresh trainers each: distinct losses "
        f"{losses}; each run's largest gradient difference from the first run without remat, "
        f"relative to that gradient's largest value: {json.dumps(spread)}; kernel 3's sums "
        f"(B 2, N 256, C 32) over {DGMS_SPREAD_RUNS} calls on one input: {json.dumps(sums)} ("
        + ("bit-identical" if not any(v["differ_bitwise"] for v in sums.values())
           else "NOT bit-identical") + ")")
    if not np.isfinite(losses).all():
        raise SystemExit(f"the small DGM step's loss is not finite: {losses}")
    return {"losses": losses, "grad_spread": spread, "kernel3_sums": sums}


def phase_dgm_steps(dev, seed: int) -> dict:
    """Phase 30, under a temporary directory in ``build/``."""
    import tempfile

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dgm_steps_", dir=build) as tmp:
        shipped = dgm_graph_shipped(dev, seed)
        train_proc, results = start_preview_child(tmp)
        try:
            vs_eager = dgm_graph_vs_eager(dev, seed)
            shard = dgm_shard_params(dev, seed, tmp)
            spread = dgm_step_spread(dev, seed)
        except BaseException:
            train_proc.kill()
            train_proc.wait()
            raise
        previews = dgm_previews(train_proc, results, tmp)
    out = {"shipped": shipped, "vs_eager": vs_eager, "shard_params": shard, "spread": spread,
           "previews": previews, "phase_s": time.perf_counter() - t0}
    log(f"[dgm-steps] phase 30 {out['phase_s']:.1f} s")
    log("[dgm-steps-summary] " + json.dumps(out, default=str))
    return out


def dgm_steps_summary(d: dict, phase22_ms) -> None:
    """One line: phase 30's graph step beside the eager step."""
    sh = d["shipped"]
    beside = "" if phase22_ms is None else f"; phase 22's eager step {phase22_ms:.2f} ms"
    log(f"[summary] DGM graph step (phase 30): {sh['graph_step_ms']:.2f} ms, eager "
        f"{sh['eager_step_ms']:.2f} ms in this phase{beside}; idle {100 * sh['idle']:.2f}%, peak "
        f"{sh['peak_bytes'] / 2**30:.2f} GiB with the graph's pool; launches per replay "
        f"{sh['launches_per_replay']}; graph vs eager (fp32) {json.dumps(d['vs_eager'])}; "
        f"shard_params ({d['shard_params']['backend']}) shares "
        f"{[r['share'] for r in d['shard_params']['ranks']]}; previews "
        f"{len(d['previews']['previews'])}; phase {d['phase_s']:.1f} s")


# ---------------------------------------------------------------------------
# phase 31: the rest of the JAX package, and kernel 3 without atomics
# ---------------------------------------------------------------------------

BH_BATCH = 32  # BasesHomo at full width: pairs per forward
BH_CPU_BATCH = 2  # card vs CPU, stage by stage
# a stage's card-vs-CPU difference relative to its largest CPU value: fp32
# summation order (cuDNN and the CPU), TF32 off; a Subspace stage may also
# amplify a rounding by cond(V^T V): within max(BH_STAGE_TOL, BH_COND_TOL x cond)
BH_STAGE_TOL = 1e-4
BH_COND_TOL = 1e-6
VIS_PAIRS, VIS_BATCH = 5, 2  # hem_eval --mask-vis: one pair per scene category
VIS_HW = (360, 640)
K3_RERUNS = 6  # calls of kernel 3 per site and dtype that must give the same bits
# kernel 3 with atomics (PERF.md, its row): ms per generation batch (phase
# 12's per-site bursts) and per DGM step (phase 22's profile)
K3_OLD_MS = {"generation batch": 109.68, "DGM step": 8.81}


def gif_info(path: str) -> dict:
    """Frames, NETSCAPE loop count and each frame's delay (hundredths) of a
    GIF89a file, by walking its blocks (no image library on the card)."""
    data = open(path, "rb").read()
    if data[:6] != b"GIF89a":
        raise ValueError(f"{path}: not a GIF89a file")
    flags = data[10]
    pos = 13 + (3 * 2 ** ((flags & 7) + 1) if flags & 0x80 else 0)
    info = {"frames": 0, "loop": None, "delays": []}

    def skip_subblocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            label = data[pos + 1]
            if label == 0xF9:
                info["delays"].append(int.from_bytes(data[pos + 4:pos + 6], "little"))
            elif label == 0xFF and data[pos + 3:pos + 14] == b"NETSCAPE2.0":
                info["loop"] = int.from_bytes(data[pos + 16:pos + 18], "little")
            pos = skip_subblocks(pos + 2)
        elif data[pos] == 0x2C:
            lflags = data[pos + 9]
            pos += 10 + (3 * 2 ** ((lflags & 7) + 1) if lflags & 0x80 else 0)
            pos = skip_subblocks(pos + 1)  # the LZW minimum code size, then the data
            info["frames"] += 1
        else:
            raise ValueError(f"{path}: unknown block {data[pos]:#x} at {pos}")
    return info


def flip_gif_ok(path: str) -> bool:
    g = gif_info(path)
    return g["frames"] == 2 and g["loop"] == 0 and g["delays"] == [50, 50]


def bh_stages(model, x, z, w3, w4) -> dict:
    """BasesHomo stage by stage: the shared features and the stem with
    layers 1-3 end to end on the pair x (B, 2, H, W); layer 4 and conv_last
    on z; each Subspace stage (its basis maps, cond(V^T V), its output) on
    w3, w4.  NCHW, fp32."""
    import torch

    from dmhomo_torch.models.baseshomo import vtv_condition

    with torch.no_grad():
        f = torch.cat([model.share_feature(x[:, :1]), model.share_feature(x[:, 1:])], 1)
        out = {"share_feature": f,
               "stem_layers_1_3": model.layer3(model.layer2(model.layer1(model.stem(f))))}
        out["layer4"] = model.layer4(z)
        out["conv_last"] = model.conv_last(out["layer4"])
        for name, w in (("sp_layer3", w3), ("sp_layer4", w4)):
            stage = getattr(model, name)
            out[f"{name} maps"] = stage.Block(w)
            out[f"{name} cond"] = vtv_condition(out[f"{name} maps"])
            out[name] = stage(w)
    return out


def rest_baseshomo(dev, seed: int) -> dict:
    """31a: BasesHomo at full width (crop 320x576, layers (3, 4, 6, 3), 16
    basis maps, seeded random weights) on the card, fp32 with TF32 off."""
    import torch

    from dmhomo_torch.models.baseshomo import BasesHomoConfig, BasesHomoNet, build_baseshomo
    from dmhomo_torch.models.convert import load_baseshomo_state_dict

    cfg = BasesHomoConfig()
    model = build_baseshomo(cfg, device=dev, generator=torch.Generator().manual_seed(seed + 31))
    rng = np.random.default_rng(seed + 31)
    ph, pw = cfg.crop_size
    x = torch.from_numpy(rng.normal(0, 0.5, (BH_BATCH, ph, pw, 2)).astype(np.float32)).to(dev)
    times = []
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(x)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        events, wall = profiled_step(lambda: model(x))
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(times[1:]))
    busy = sum(e.self_device_time_total for e in events) / 1e3
    finite = {k: bool(torch.isfinite(v).all()) for k, v in out.items()}
    shapes_ok = (tuple(out["homo_f"].shape) == (BH_BATCH, 3, 3)
                 and tuple(out["offset_b"].shape) == (BH_BATCH, 8))

    # card vs CPU, stage by stage, the same weights
    cpu = BasesHomoNet(cfg).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
    xs = torch.from_numpy(rng.normal(0, 0.5, (BH_CPU_BATCH, 2, ph, pw)).astype(np.float32))
    z = torch.from_numpy(rng.normal(0, 0.5, (BH_CPU_BATCH, 256, ph // 16, pw // 16))
                         .astype(np.float32))
    w3 = torch.from_numpy(rng.normal(0, 0.2, z.shape).astype(np.float32))
    w4 = torch.from_numpy(rng.normal(0, 0.2, (BH_CPU_BATCH, 512, ph // 32, pw // 32))
                          .astype(np.float32))
    want = bh_stages(cpu, xs, z, w3, w4)
    got = bh_stages(model, *(t.to(dev) for t in (xs, z, w3, w4)))
    stages, ok = {}, shapes_ok
    for k, w in want.items():
        if k.endswith("cond"):
            continue
        rel = float((got[k].cpu() - w).abs().max() / w.abs().max())
        cond = float(want[f"{k} cond"].max()) if f"{k} cond" in want else None
        tol = BH_STAGE_TOL if cond is None else max(BH_STAGE_TOL, BH_COND_TOL * cond)
        stages[k] = {"rel": rel, "tol": tol, "cond_vtv": cond}
        ok = ok and rel <= tol

    # a reference-format state dict (DDP prefix, the dead keys) loads strict
    sd = {f"module.{k}": v.clone() for k, v in model.state_dict().items()}
    sd["module.subspace_block.conv0.weight"] = torch.zeros(16, 256, 1, 1)
    sd["module.basis"] = torch.zeros(1, 8, ph * pw)
    fresh = BasesHomoNet(cfg).to(dev)
    load_baseshomo_state_dict(fresh, sd)
    loaded = all(torch.equal(fresh.state_dict()[k], v) for k, v in model.state_dict().items())
    ok = ok and loaded
    res = {"pairs_per_s": 1e3 * BH_BATCH / ms, "batch_ms": ms, "times_ms": times[1:],
           "peak_bytes": peak, "busy_ms": busy, "profiled_ms": wall, "idle": 1 - busy / wall,
           "outputs_finite": finite, "stages": stages, "strict_load": loaded}
    log(f"[rest-bh] BasesHomo full width (320x576, layers (3, 4, 6, 3), 16 maps), B={BH_BATCH}, "
        f"fp32: {res['pairs_per_s']:.2f} pairs/s ({ms:.2f} ms a batch; timed "
        f"{', '.join(f'{t:.1f}' for t in times[1:])}), peak {peak / 2**30:.2f} GiB, a profiled "
        f"call: busy {busy:.2f} of {wall:.2f} ms, idle {100 * res['idle']:.2f}%; outputs finite "
        f"{finite}; card vs CPU by stage (B={BH_CPU_BATCH}; rel. to the largest CPU value, "
        f"cond(V^T V) beside each Subspace): " + "; ".join(
            f"{k} {v['rel']:.3g} (tol {v['tol']:.3g}"
            + (f", cond {v['cond_vtv']:.3g})" if v["cond_vtv"] is not None else ")")
            for k, v in stages.items())
        + f"; reference-format state dict strict {loaded} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"BasesHomo on the card: {res}")
    del model, fresh, x, out
    torch.cuda.empty_cache()
    return res


def mask_vis_child(tmp: str) -> dict:
    """31b's child: ``hem_eval --mask-vis`` on the card through its ``main``,
    the plain window attention made to raise; the report and kernel 1's
    launches."""
    from dmhomo_torch.cli import hem_eval
    from dmhomo_torch.ops import window_attention as wa

    _plain_raises()
    wa.window_attention.launches = 0
    report = hem_eval.main(["--test-data", os.path.join(tmp, "cahomo"), "--torch-ckpt",
                            os.path.join(tmp, "HEM.pth"), "--batch-size", str(VIS_BATCH),
                            "--mask-vis", os.path.join(tmp, "vis")])
    return {"report": report, "launches": wa.window_attention.launches}


def start_mask_vis_child(tmp: str, seed: int):
    """31b: a CAHomo-format test set of VIS_PAIRS PNG pairs at 360x640 (one
    video of each scene category) and the shipped estimator's seeded weights
    as a reference-layout checkpoint, then the child started."""
    import torch

    from dmhomo_torch.config import EstimatorConfig
    from dmhomo_torch.data.hem_data import write_synthetic_cahomo
    from dmhomo_torch.models.estimator import build_estimator

    lines = write_synthetic_cahomo(os.path.join(tmp, "cahomo"), VIS_PAIRS, VIS_HW, seed + 32)
    model = build_estimator(EstimatorConfig(), device="cpu",
                            generator=torch.Generator().manual_seed(seed + 32))
    torch.save({"state_dict": model.state_dict()}, os.path.join(tmp, "HEM.pth"))
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mask-vis-child", tmp],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, lines


def rest_mask_vis(proc, lines, tmp: str) -> dict:
    """31b: the child's exit, kernel 1's 40 launches a forward, the files
    JAX's ``mask_vis_categories`` names, each JPEG from SOI to EOI, each GIF
    two frames, loop 0, 50 cs a frame."""
    from dmhomo_torch.evaluation.metrics import TEST_CATEGORIES

    (text,) = _join([proc], "hem_eval --mask-vis child", timeout=300)
    child = json.loads(text.strip().splitlines()[-1])
    forwards = -(-len(lines) // VIS_BATCH)
    vis = os.path.join(tmp, "vis")
    want = set()
    for i, line in enumerate(lines):
        vid = line.split("/")[0]
        cat = next(c for c, ids in TEST_CATEGORIES.items() if vid in ids)
        want |= {f"{cat}/{vid}_{i % VIS_BATCH}{s}" for s in
                 ("_img1.jpg", "_img2.jpg", "_mask_1.jpg", "_mask_2.jpg", ".gif")}
    got = {os.path.relpath(os.path.join(d, f), vis) for d, _, fs in os.walk(vis) for f in fs}
    jpegs = sorted(n for n in got if n.endswith(".jpg"))
    gifs = sorted(n for n in got if n.endswith(".gif"))
    bad_jpeg = [n for n in jpegs if not (lambda b: b[:2] == b"\xff\xd8" and b[-2:] == b"\xff\xd9")(
        open(os.path.join(vis, n), "rb").read())]
    bad_gif = [n for n in gifs if not flip_gif_ok(os.path.join(vis, n))]
    ok = (got == want and not bad_jpeg and not bad_gif
          and child["launches"] == 40 * forwards and np.isfinite(child["report"]["AVG"]))
    log(f"[rest-vis] hem_eval --mask-vis (child, shipped estimator, {len(lines)} PNG pairs at "
        f"{VIS_HW[0]}x{VIS_HW[1]}, batch {VIS_BATCH}): report {json.dumps(child['report'])}; "
        f"window-attention launches {child['launches']} (40 x {forwards} forwards); files "
        f"{len(got)} = the {len(want)} JAX names {got == want}; {len(jpegs)} JPEGs SOI..EOI, "
        f"bad {bad_jpeg}; {len(gifs)} GIFs of 2 frames, loop 0, 50 cs, bad {bad_gif} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"hem_eval --mask-vis: missing {sorted(want - got)}, extra "
                         f"{sorted(got - want)}, child {child}")
    return {"files": len(got), "jpegs": len(jpegs), "gifs": len(gifs),
            "launches": child["launches"], "forwards": forwards, "report": child["report"]}


def warp_check_files(wdir: str, n_shards: int, tag: str) -> dict:
    """31c: one flip GIF per shard from ``make_samples --warp-check``."""
    gifs = sorted(f for f in os.listdir(wdir) if f.endswith(".gif"))
    infos = {f: gif_info(os.path.join(wdir, f)) for f in gifs}
    ok = len(gifs) == n_shards and all(flip_gif_ok(os.path.join(wdir, f)) for f in gifs)
    log(f"[{tag}] make_samples --warp-check: {len(gifs)} GIFs for {n_shards} shards, each "
        f"2 frames, loop 0, 50 cs: {ok} ({json.dumps(infos)[:300]})")
    if not ok:
        raise SystemExit(f"make_samples --warp-check wrote {gifs}: {infos}")
    return {"gifs": len(gifs)}


def rest_warp_check_alone(tmp: str, seed: int) -> dict:
    """31c without phase 26 (``--only-rest``): two shards of random pairs."""
    from dmhomo_torch.cli import make_samples
    from dmhomo_torch.data.shards import save_generation_shard, shard_filename

    rng = np.random.default_rng(seed + 33)
    sdir = os.path.join(tmp, "shards")
    os.makedirs(sdir)
    for i in range(2):
        H = np.eye(3) + np.diag([0.02, -0.02, 0.0]) + np.array(
            [[0, 0, rng.normal(0, 3)], [0, 0, rng.normal(0, 3)], [0, 0, 0]])
        save_generation_shard(os.path.join(sdir, shard_filename(i, 0, 0, 2)), [
            {"imgs": rng.integers(0, 256, (2, 6, 256, 256), dtype=np.uint8),
             "homos": np.stack([H, H]).astype(np.float32)}])
    wdir = os.path.join(tmp, "warp_check")
    make_samples.main(["--shards", os.path.join(sdir, "*.npy"), "--out",
                       os.path.join(tmp, "samples"), "--warp-check", wdir])
    return warp_check_files(wdir, 2, "rest-warp")


def rest_kernel3(dev, seed: int) -> dict:
    """31d: the tuned kernel 3 without atomics: its library's machine code
    holds none; K3_RERUNS calls per site and dtype give the same bits at the
    DGM training sites (microbatch 32) and the generation sites (B = 50);
    pass 1's time per generation batch and per DGM step (the sum over the
    sites' medians of bursts, times the calls a batch or a step makes)
    beside the parent's.  Its launches are taken back off the counters: no
    main path runs here."""
    import torch

    from dmhomo_torch.models.unet import UNetConfig
    from dmhomo_torch.ops import linear_attention as la
    from dmhomo_torch.ops.build import atomic_instructions

    atomics = atomic_instructions(la.build(), "linear_attention")
    saved = [(fn, fn.launches, fn.generic, fn.elementwise)
             for fn in (la.linear_attention_pass1, la.linear_attention_pass2)]
    sites = linear_attention_sites(UNetConfig(), GEN_SIZE)
    gen = torch.Generator(device=dev).manual_seed(seed + 34)
    reruns, ms = {}, {"generation batch": 0.0, "DGM step": 0.0}
    for where, B, calls in (("DGM step", DGMS_MICROBATCH, 4), ("generation batch", 2 * GEN_BS,
                                                               GEN_STEPS)):
        for site, hw, C in sites:
            N = hw * hw
            x32 = (1.5 * torch.randn(B, C, N, generator=gen, device=dev) + 0.3).transpose(1, 2)
            w = torch.randn(C, 3 * la.HIDDEN, generator=gen, device=dev) / C**0.5
            g = 0.5 + torch.rand(C, generator=gen, device=dev)
            mean, rstd = (torch.empty(B, N, device=dev) for _ in range(2))
            for dt in ("float32", "bfloat16"):
                x = x32.to(getattr(torch, dt))
                outs = []
                for _ in range(K3_RERUNS):
                    s = torch.full((B, la.SUMS), float("nan"), device=dev)
                    la.linear_attention_pass1(x, w, g, mean, rstd, True, s)
                    outs.append(s)
                torch.cuda.synchronize()
                key = f"{where} {site} {dt}"
                reruns[key] = sum(not torch.equal(o, outs[0]) for o in outs[1:])
                if dt == "bfloat16":
                    s = outs[0]
                    t, _ = burst_ms(lambda: la.linear_attention_pass1(x, w, g, mean, rstd, True, s),
                                    iters=5)
                    ms[where] += calls * t
                del outs, x
            del x32
    for fn, launches, generic, elementwise in saved:
        fn.launches, fn.generic, fn.elementwise = launches, generic, elementwise
    ok = not any(atomics.values()) and atomics and not any(reruns.values())
    log(f"[rest-k3] kernel 3 (tuned): atomic instructions in its library's machine code "
        f"{sum(atomics.values())} over {len(atomics)} kernels; {K3_RERUNS} calls per site and "
        f"dtype ({len(reruns)} cases) differ bitwise from the first in {sum(reruns.values())}; "
        f"bf16 pass 1 (its reduction included) {ms['generation batch']:.2f} ms per generation "
        f"batch (with atomics {K3_OLD_MS['generation batch']}), {ms['DGM step']:.3f} ms per "
        f"DGM step by CUDA events (with atomics {K3_OLD_MS['DGM step']} by profile) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"kernel 3: atomics {atomics}, reruns differing {reruns}")
    return {"atomic_instructions": atomics, "reruns_differing": reruns, "ms": ms,
            "old_ms": K3_OLD_MS}


def phase_rest(dev, seed: int, warp_check=None) -> dict:
    """Phase 31, under a temporary directory in ``build/``; (b)'s child runs
    beside (a).  ``warp_check``: phase 26's (c), else it runs alone."""
    import tempfile

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="rest_", dir=build) as tmp:
        proc, lines = start_mask_vis_child(tmp, seed)
        try:
            bh = rest_baseshomo(dev, seed)
        except BaseException:
            proc.kill()
            proc.wait()
            raise
        vis = rest_mask_vis(proc, lines, tmp)
        if warp_check is None:
            warp_check = rest_warp_check_alone(tmp, seed)
        k3 = rest_kernel3(dev, seed)
    out = {"baseshomo": bh, "mask_vis": vis, "warp_check": warp_check, "kernel3": k3,
           "phase_s": time.perf_counter() - t0}
    log(f"[rest] phase 31 {out['phase_s']:.1f} s")
    log("[rest-summary] " + json.dumps(out, default=str))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--streamed-step-copies", metavar="SAMPLES", default=None,
                        help="phase 26's child: profile one streamed step, print its copies")
    parser.add_argument("--dp-rank", type=int, default=None,
                        help="phase 27's child: this rank of --dp-world, through --dp-dir")
    parser.add_argument("--dp-world", type=int, default=DP_WORLD)
    parser.add_argument("--dp-dir", type=str, default=None)
    parser.add_argument("--dp-backend", type=str, default="gloo", choices=("nccl", "gloo"))
    parser.add_argument("--only-data-parallel", action="store_true",
                        help="phases 1-2 (device, build), then phase 27 alone; prints no "
                             "final line")
    parser.add_argument("--tiny-train-child", metavar="ATTN,FUSE", default=None,
                        help="phase 28's child: hem_train --tiny on the card, its losses")
    parser.add_argument("--only-generic", action="store_true",
                        help="phases 1-2 (device, build), then phase 28 alone; prints no "
                             "final line")
    parser.add_argument("--only-uncond", action="store_true",
                        help="phases 1-2 (device, build), then phase 29 alone; prints no "
                             "final line")
    parser.add_argument("--only-dgm-steps", action="store_true",
                        help="phases 1-2 (device, build), then phase 30 alone; prints no "
                             "final line")
    parser.add_argument("--only-shard-params", action="store_true",
                        help="phases 1-2 (device, build), then phase 30c alone (the path "
                             "across cards); prints no final line")
    parser.add_argument("--shard-rank", type=int, default=None,
                        help="phase 30's child: this rank of --shard-world, through --shard-dir")
    parser.add_argument("--shard-world", type=int, default=SHARD_MODEL)
    parser.add_argument("--shard-model", type=int, default=SHARD_MODEL)
    parser.add_argument("--shard-dir", type=str, default=None)
    parser.add_argument("--shard-backend", type=str, default="gloo", choices=("nccl", "gloo"))
    parser.add_argument("--shard-check", action="store_true",
                        help="phase 30's child: the fp32 step and checkpoint checks too")
    parser.add_argument("--only-rest", action="store_true",
                        help="phases 1-2 (device, build), then phase 31 alone; prints no "
                             "final line")
    parser.add_argument("--mask-vis-child", metavar="DIR", default=None,
                        help="phase 31's child: hem_eval --mask-vis on DIR's test set")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.streamed_step_copies:
        print(json.dumps(streamed_step_copies(args.streamed_step_copies, args.seed)), flush=True)
        return
    if args.dp_rank is not None:
        dp_rank(args.dp_rank, args.dp_world, args.dp_dir, args.dp_backend, args.seed)
        return
    if args.tiny_train_child:
        attn, fuse = args.tiny_train_child.split(",")
        print(json.dumps(tiny_train_child(attn, int(fuse), args.seed)), flush=True)
        return
    if args.shard_rank is not None:
        shard_rank(args.shard_rank, args.shard_world, args.shard_model, args.shard_dir,
                   args.shard_backend, args.seed, args.shard_check)
        return
    if args.mask_vis_child:
        print(json.dumps(mask_vis_child(args.mask_vis_child)), flush=True)
        return
    t_start = time.perf_counter()

    dev, name, smi = phase_device()
    phase_build()
    if args.only_data_parallel:
        phase_data_parallel(dev, synthetic_train_batch(BATCH, args.seed), args.seed)
        log(smi)
        return
    if args.only_generic:
        from dmhomo_torch.config import EstimatorConfig

        phase_generic(dev, eval_pairs(EstimatorConfig(), dev, BATCH, args.seed),
                      synthetic_train_batch(BATCH, args.seed), args.seed)
        log(smi)
        return
    if args.only_uncond:
        uncond_summary(phase_uncond(dev, args.seed))
        log(smi)
        return
    if args.only_dgm_steps:
        dgm_steps_summary(phase_dgm_steps(dev, args.seed), None)
        log(smi)
        return
    if args.only_shard_params:
        import tempfile

        build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
        os.makedirs(build, exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="dgm_shard_", dir=build) as tmp:
            log("[dgm-shard-summary] " + json.dumps(dgm_shard_params(dev, args.seed, tmp),
                                                    default=str))
        log(smi)
        return
    if args.only_rest:
        phase_rest(dev, args.seed)
        log(smi)
        return
    wa_sass, wa_atomics = phase_window_sass()

    import torch

    from dmhomo_torch.config import EstimatorConfig
    from dmhomo_torch.models.estimator import build_estimator
    from dmhomo_torch.ops.window_attention import window_attention as wa_fwd

    model = build_estimator(EstimatorConfig(), device=dev,
                            generator=torch.Generator().manual_seed(args.seed))
    shapes = attention_shapes(model, BATCH)
    train_shapes = attention_shapes(model, MICROBATCH)
    expected = sum(s["plain_launches"] + s["masked_launches"] for s in shapes)
    results, worst, step_rows = phase_kernels(shapes, dev, args.seed, train_shapes)
    pairs = eval_pairs(model.config, dev, BATCH, args.seed)
    counts, forwards, _, batch_ms, peak = phase_slice(model, pairs, {"window-attention": wa_fwd})
    launches = counts["window-attention"]
    if launches != expected * forwards:
        raise SystemExit(f"window attention launched {launches} times in {forwards} forwards, "
                         f"expected {expected} per forward")
    diffs = phase_card_vs_cpu(model, args.seed)
    phase_profile(model, pairs, batch_ms)
    del model
    torch.cuda.empty_cache()

    bwd_results, bwd_worst, sdpa_backend = phase_backward_kernels(train_shapes, dev, args.seed)
    train = phase_train(dev, args.seed)
    step_diffs = phase_train_card_vs_cpu(dev, args.seed)
    dev_ms, idle, attn_ms = phase_train_profile(train["trainer"], train["batch"],
                                                train["step_ms"])
    train_batch = train.pop("batch")
    per_step_launches = 40 * (BATCH // MICROBATCH)
    count_step_launches(step_rows, train["by_shape"]["fwd"], per_step_launches, "kernel-step")
    count_step_launches(bwd_results, train["by_shape"]["bwd"], per_step_launches, "bwd-kernel")
    graph = phase_train_graph(
        train.pop("trainer"), train_batch, {"step_ms": train["step_ms"], "idle": idle},
        {"window_attention": per_step_launches, "window_attention_backward": per_step_launches,
         "swin_block": 0, "swin_block_backward": 0},
        {"window_attention": train["by_shape"]["fwd"],
         "window_attention_backward": train["by_shape"]["bwd"]}, "graph-train")
    torch.cuda.empty_cache()
    graph["vs_eager"] = phase_graph_vs_eager(dev, train_batch, args.seed, "auto",
                                             "graph-vs-eager")

    from dmhomo_torch.models.unet import UNetConfig

    phase_linear_build()
    sites = linear_attention_sites(UNetConfig(), GEN_SIZE)
    la_results, la_worst = phase_linear_kernels(sites, dev, args.seed)
    gen = phase_generate(dev, args.seed)
    gen_diffs = phase_gen_card_vs_cpu(gen["gd"], gen["cond"], args.seed)
    gen_dev_ms, gen_idle, gen_la_ms = phase_gen_profile(gen["gd"], gen["cond"], gen["step_ms"])
    del gen["gd"]
    torch.cuda.empty_cache()

    phase_swin_build()
    sb_sass = phase_swin_fwd_sass()
    sb_results, sb_worst = phase_swin_kernels(shapes, dev, args.seed)
    sb_slice = phase_fused_slice(dev, pairs, args.seed, batch_ms)
    sb_diffs = phase_card_vs_cpu(sb_slice.pop("model"), args.seed, tag="sb-card-vs-cpu")
    torch.cuda.empty_cache()

    phase_swin_build("bwd", tag="sb-bwd-build")
    sbb_atomics = phase_swin_bwd_sass()
    sbb_results, sbb_worst = phase_swin_bwd_kernels(train_shapes, dev, args.seed)
    sb_train = phase_train_fused(dev, train_batch, args.seed, train["step_ms"], train_shapes,
                                 sbb_results)
    sb_launches_step = {k: v // TIMED_STEPS for k, v in sb_train["launches"].items()}
    sb_graph = phase_train_graph(
        sb_train.pop("trainer"), train_batch,
        {"step_ms": sb_train["step_ms"], "idle": sb_train["idle"]},
        {"window_attention": sb_launches_step["wa_fwd"],
         "window_attention_backward": sb_launches_step["wa_bwd"],
         "swin_block": sb_launches_step["fwd"], "swin_block_backward": sb_launches_step["bwd"]},
        {"swin_block": sb_train["by_shape"]["fwd"],
         "swin_block_backward": sb_train["by_shape"]["bwd"]}, "sb-graph-train")
    torch.cuda.empty_cache()
    sb_graph["vs_eager"] = phase_graph_vs_eager(dev, train_batch, args.seed, "fused_block",
                                                "sb-graph-vs-eager")
    sb_step_diffs = phase_train_card_vs_cpu(dev, args.seed, attn_impl="fused_block",
                                            tag="sb-train-card-vs-cpu")
    torch.cuda.empty_cache()

    dgm = phase_dgm_train(dev, args.seed)
    dgm_prof = phase_dgm_profile(dgm)
    for k in ("trainer", "gen", "batch"):
        del dgm[k]
    torch.cuda.empty_cache()
    la_bwd_rows, la_bwd_worst = phase_la_backward(sites, dev, args.seed, dgm["microbatch"])
    dgm_diffs = phase_dgm_card_vs_cpu(dev, args.seed)
    torch.cuda.empty_cache()

    import tempfile

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="pipeline_", dir=build) as tmp:
        pipe = phase_pipeline(dev, args.seed, tmp)
    dp = phase_data_parallel(dev, train_batch, args.seed)
    generic = phase_generic(dev, pairs, train_batch, args.seed)
    torch.cuda.empty_cache()
    uncond = phase_uncond(dev, args.seed)
    torch.cuda.empty_cache()
    dgm_steps = phase_dgm_steps(dev, args.seed)
    torch.cuda.empty_cache()
    rest = phase_rest(dev, args.seed, pipe["warp_check"])

    # per-forward totals at the eval path's dtype (fp32) and launch mix
    main = [r for r in results if r["dtype"] == "float32"]

    def per_fwd(key):
        return sum(r[key] * r["launches_per_forward"] for r in main)

    # per-training-step totals at the training dtype (bf16), microbatches of 8
    train_rows = [r for r in bwd_results if r["dtype"] == "bfloat16"]

    def per_step(key):
        return sum(r[key] * r["launches_per_step"] for r in train_rows)

    kernel = {
        "name": "window_attention_fwd", "route": "cuda",
        "source": "dmhomo_torch/csrc/window_attention.cu",
        "replaces": "dmhomo_tpu/ops/window_attention.py:91",
        "launches": launches, "max_abs_err": worst["float32"],
        "ms": per_fwd("ms"), "plain_ms": per_fwd("plain_ms"), "bound_ms": per_fwd("bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in main) else "operations",
        "library_ms": per_fwd("library_ms"),
        "unit": f"sum over the {expected} launches of one estimator forward, B={BATCH}, fp32",
        "max_abs_err_bf16": worst["bfloat16"],
        "launches_train": train["fwd_launches"],
        # launches per replay of the captured training step (phase 8b)
        "launches_per_graph_step": graph["launches_per_step"]["window_attention"],
        # phase 26: HEM training streamed from generated samples
        "launches_pipeline": pipe["train"]["launches"]["window_attention"],
        # phase 27: per replay inside a one-rank group, per step on each of 2 ranks
        "launches_per_graph_step_one_rank_group": dp["one_rank"]["launches_per_replay"][
            "window_attention"],
        "launches_per_step_each_rank": dp["ranks"]["rank0_hem"]["launches"][0],
        # per training step: the 160 launches at B=8, bf16
        "ms_per_step": sum(r["ms"] * r["launches_per_step"] for r in step_rows),
        "bound_ms_per_step": sum(r["bound_ms"] * r["launches_per_step"] for r in step_rows),
        # counted in the built machine code; phase 2 fails on any
        "atomic_instructions": {k: n for k, n in wa_atomics.items() if "_fwd_" in k},
        "tensor_core_instructions": {k: n for k, n in wa_sass.items() if k.startswith("fwd")},
        "step_shapes": step_rows,
        "shapes": results,
    }
    bwd_kernel = {
        "name": "window_attention_bwd", "route": "cuda",
        "source": "dmhomo_torch/csrc/window_attention.cu",
        "replaces": "dmhomo_tpu/ops/window_attention.py:117",
        "launches": train["bwd_launches"], "max_abs_err": bwd_worst[("bfloat16", "dqkv")],
        "launches_per_graph_step": graph["launches_per_step"]["window_attention_backward"],
        "launches_pipeline": pipe["train"]["launches"]["window_attention_backward"],
        "launches_per_graph_step_one_rank_group": dp["one_rank"]["launches_per_replay"][
            "window_attention_backward"],
        "launches_per_step_each_rank": dp["ranks"]["rank0_hem"]["launches"][1],
        "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
        "bound_ms": per_step("bound_ms"),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in train_rows)
                     else "operations"),
        "library_ms": per_step("library_ms"),
        "library": f"torch.autograd.grad through scaled_dot_product_attention ({sdpa_backend})",
        "unit": (f"sum over the {40 * BATCH // MICROBATCH} launches of one training step, "
                 f"B={BATCH} in microbatches of {MICROBATCH}, bf16"),
        "max_abs_err_dbias": bwd_worst[("bfloat16", "dbias")],
        "max_abs_err_fp32": bwd_worst[("float32", "dqkv")],
        "max_abs_err_dbias_fp32": bwd_worst[("float32", "dbias")],
        "profiled_ms_per_step": attn_ms["bwd"],
        "ms_per_step": per_step("ms"),
        "bound_ms_per_step": per_step("bound_ms"),
        # counted in the built machine code; phase 2 fails on any
        "atomic_instructions": {k: n for k, n in wa_atomics.items() if "_fwd_" not in k},
        "tensor_core_instructions": {k: n for k, n in wa_sass.items() if k.startswith("bwd")},
        "shapes": bwd_results,
    }
    log(f"[summary] eval slice {1e3 * BATCH / batch_ms:.2f} pairs/s, batch {batch_ms:.2f} ms, "
        f"peak {peak / 2**30:.2f} GiB; window attention {kernel['ms']:.3f} ms per forward "
        f"(bound {kernel['bound_ms']:.3f}), {kernel['ms_per_step']:.3f} per training step "
        f"(bound {kernel['bound_ms_per_step']:.3f}); card-vs-cpu {json.dumps(diffs)}")
    log(f"[summary] training {1e3 * BATCH / train['step_ms']:.2f} pairs/s, step "
        f"{train['step_ms']:.2f} ms, peak {train['peak'] / 2**30:.2f} GiB, device idle "
        f"{100 * idle:.1f}%; backward kernel {bwd_kernel['ms']:.3f} ms per step (bound "
        f"{bwd_kernel['bound_ms']:.3f}, plain {bwd_kernel['plain_ms']:.3f}, SDPA fwd+bwd "
        f"{bwd_kernel['library_ms']:.3f}); step card-vs-cpu {json.dumps(step_diffs)}")

    # per-batch totals of generation (bf16): each site runs once per UNet
    # forward, GEN_STEPS forwards per batch
    gen_rows = [r for r in la_results if r["dtype"] == "bfloat16"]

    def per_batch(key):
        return GEN_STEPS * sum(r[key] for r in gen_rows)

    gemm_ms = per_batch("gemm_ms")
    la_kernels = []
    for p, line in ((1, 145), (2, 163)):
        la_kernels.append({
            "name": f"linear_attention_pass{p}", "route": "cuda",
            "source": "dmhomo_torch/csrc/linear_attention.cu",
            "replaces": f"dmhomo_tpu/ops/linear_attention.py:{line}",
            "launches": gen["launches"][p - 1],
            "max_abs_err": la_worst[("bfloat16", f"pass{p}")],
            "ms": per_batch(f"pass{p}_ms"), "plain_ms": per_batch(f"plain{p}_ms"),
            "bound_ms": per_batch(f"bound{p}_ms"),
            "bound_by": ("bytes" if all(r[f"bound{p}_by"] == "bytes" for r in gen_rows)
                         else "operations"),
            "library_ms": None,
            "library": ("none: no one PyTorch call computes linear attention; yardstick "
                        f"gemm_ms = cuBLAS x @ W_qkv (all 384 columns) per batch, {gemm_ms:.3f}"),
            "gemm_ms": gemm_ms,
            "unit": (f"sum over one generation batch: {len(sites)} sites x {GEN_STEPS} UNet "
                     f"forwards at B={2 * GEN_BS} (CFG-doubled bs {GEN_BS}), bf16, prenorm"),
            "launches_per_batch": len(sites) * GEN_STEPS,
            # phase 26: generation on the built conditions
            "launches_pipeline": pipe["generate"]["launches"][p - 1],
            "max_abs_err_fp32": la_worst[("float32", f"pass{p}")],
            "max_abs_err_output_bf16": la_worst[("bfloat16", "out")],
            "max_abs_err_output_fp32": la_worst[("float32", "out")],
            "profiled_ms_per_step": gen_la_ms[p],
            # DGM training (phase 22): launches over the timed steps and per step
            "launches_train": dgm["launches"][p - 1],
            "launches_per_dgm_step": dgm["launches_per_step"],
            # phase 27: one fp32 DGM step on each of 2 ranks, 2 microbatches
            "launches_per_dgm_step_each_rank": dp["ranks"]["rank0_dgm"]["launches"][p - 1],
            "dgm_step_profiled_ms": dgm_prof["groups_ms"][f"linear-attention pass {p}"],
            # the output at phase 24's training shapes (both passes), relative to the plain
            "max_rel_err_output_dgm_train": {dt: la_bwd_worst[(dt, "out")]
                                             for dt in ("float32", "bfloat16")},
            "shapes": la_results,
        })
    log(f"[summary] generation {1e3 * GEN_BS / gen['batch_ms']:.3f} samples/s, "
        f"{gen['batch_ms']:.1f} ms per batch of {GEN_BS}, {gen['step_ms']:.2f} ms per DDIM step, "
        f"peak {gen['peak'] / 2**30:.2f} GiB, device idle {100 * gen_idle:.1f}%; linear attention "
        f"pass 1 {la_kernels[0]['ms']:.1f} ms + pass 2 {la_kernels[1]['ms']:.1f} ms per batch "
        f"(bounds {la_kernels[0]['bound_ms']:.1f} + {la_kernels[1]['bound_ms']:.1f}, plain "
        f"{la_kernels[0]['plain_ms']:.1f} + {la_kernels[1]['plain_ms']:.1f}, cuBLAS x@W_qkv "
        f"{gemm_ms:.1f}); card-vs-cpu {json.dumps(gen_diffs)}")

    # per-forward totals of the fused_block eval path (fp32, 40 launches)
    sb_main = [r for r in sb_results if r["dtype"] == "float32"]

    def sb_per_fwd(key):
        return sum(r[key] * r["launches_per_forward"] for r in sb_main)

    sb_launches = sum(r["launches_per_forward"] for r in sb_main)
    unfused_ms = sb_per_fwd("unfused_ms")
    sb_kernel = {
        "name": "swin_block_fwd", "route": "cuda",
        "source": "dmhomo_torch/csrc/swin_block.cu",
        "replaces": "dmhomo_tpu/ops/swin_block.py:119",
        "launches": sb_slice["launches"], "max_abs_err": sb_worst["float32"],
        "ms": sb_per_fwd("ms"), "plain_ms": sb_per_fwd("plain_ms"),
        "bound_ms": sb_per_fwd("bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in sb_main) else "operations",
        "library_ms": None,
        "library": ("none: no one PyTorch call computes a Swin block; yardstick unfused_ms = the "
                    "port's unfused SwinBlock on the card (window-attention kernel, cuBLAS, "
                    f"LayerNorm) per forward, {unfused_ms:.3f}"),
        "unfused_ms": unfused_ms,
        "unit": (f"sum over the {sb_launches} launches of one estimator forward with "
                 f"attn_impl='fused_block', B={BATCH}, fp32"),
        "max_abs_err_bf16": sb_worst["bfloat16"],
        "eval_batch_ms": sb_slice["batch_ms"],
        "launches_train": sb_train["launches"]["fwd"],
        "launches_per_graph_step": sb_graph["launches_per_step"]["swin_block"],
        # per fused_block training step: the 320 launches at B=8 and the step's dtypes
        "ms_per_step": sb_train["fwd_ms_per_step"],
        "bound_ms_per_step": sb_train["fwd_bound_ms_per_step"],
        "profiled_ms_per_step": sb_train["kernel_ms"]["fwd"],
        "tensor_core_instructions": sb_sass,
        "step_shapes": sb_train["fwd_step_shapes"],
        "shapes": sb_results,
    }
    log(f"[summary] fused_block eval slice {1e3 * BATCH / sb_slice['batch_ms']:.2f} pairs/s, batch "
        f"{sb_slice['batch_ms']:.2f} ms (window-attention model {batch_ms:.2f}), peak "
        f"{sb_slice['peak'] / 2**30:.2f} GiB, device idle {100 * sb_slice['idle']:.1f}%; whole-block "
        f"kernel {sb_kernel['ms']:.3f} ms per forward (bound {sb_kernel['bound_ms']:.3f}, plain "
        f"{sb_kernel['plain_ms']:.3f}, unfused SwinBlock {unfused_ms:.3f}), per fused_block "
        f"training step {sb_kernel['ms_per_step']:.3f} ms (bound "
        f"{sb_kernel['bound_ms_per_step']:.3f}); flows vs phase 4 "
        f"{json.dumps(sb_slice['flow_px'])}; card-vs-cpu {json.dumps(sb_diffs)}")

    # per-training-step totals of the fused_block step: each block shape at
    # the dtype the bf16 step gives it, launches per step of microbatches of 8
    sbb_main = [r for r in sbb_results if r["dtype"] == r["train_dtype"]]

    def sbb_per_step(key):
        return sum(r[key] * r["launches_per_step"] for r in sbb_main)

    sbb_launches = sum(r["launches_per_step"] for r in sbb_main)
    sbb_unfused_ms = sbb_per_step("unfused_ms")
    sbb_kernel = {
        "name": "swin_block_bwd", "route": "cuda",
        "source": "dmhomo_torch/csrc/swin_block.cu",
        "replaces": "dmhomo_tpu/ops/swin_block.py:158",
        "launches": sb_train["launches"]["bwd"],
        "launches_per_graph_step": sb_graph["launches_per_step"]["swin_block_backward"],
        "max_abs_err": max(v for (dt, _), v in sbb_worst.items() if dt == "bfloat16"),
        "ms": sbb_per_step("ms"), "plain_ms": sbb_per_step("plain_ms"),
        "bound_ms": sbb_per_step("bound_ms"),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in sbb_main)
                     else "operations"),
        "library_ms": None,
        "library": ("none: no one PyTorch call computes a Swin block's backward; yardstick "
                    "unfused_ms = the port's unfused SwinBlock forward + backward on the card "
                    f"(window-attention kernels, cuBLAS, LayerNorm) per step, {sbb_unfused_ms:.3f}"),
        "unfused_ms": sbb_unfused_ms,
        "unit": (f"sum over the {sbb_launches:g} launches (counted) of one training step with "
                 f"attn_impl='fused_block', B={BATCH} in microbatches of {MICROBATCH}, each "
                 "block at its bf16-step dtype (each encoder level's first sub-level bf16, the "
                 "rest fp32)"),
        "max_abs_err_fp32": max(v for (dt, _), v in sbb_worst.items() if dt == "float32"),
        "max_rel_err": {dt: max(r["rel_err"] for r in sbb_results if r["dtype"] == dt)
                        for dt in ("float32", "bfloat16")},
        "max_abs_err_by_output": {f"{dt} {n}": v for (dt, n), v in sbb_worst.items()},
        "profiled_ms_per_step": sb_train["kernel_ms"]["bwd"],
        "profiled_ms_per_step_by_kernel": sb_train["bwd_parts_ms"],
        "train_step_ms": sb_train["step_ms"],
        "train_peak_bytes": sb_train["peak"],
        "train_idle": sb_train["idle"],
        # counted in the built machine code; phase 19 fails on any, so the step runs none
        "atomic_instructions": sbb_atomics,
        "atomics_per_step": 0,
        "shapes": sbb_results,
    }
    log(f"[summary] fused_block training {1e3 * BATCH / sb_train['step_ms']:.2f} pairs/s, step "
        f"{sb_train['step_ms']:.2f} ms (window-attention step {train['step_ms']:.2f}), peak "
        f"{sb_train['peak'] / 2**30:.2f} GiB, device idle {100 * sb_train['idle']:.1f}%; "
        f"whole-block backward kernel {sbb_kernel['ms']:.3f} ms per step (bound "
        f"{sbb_kernel['bound_ms']:.3f}, plain {sbb_kernel['plain_ms']:.3f}, unfused SwinBlock "
        f"fwd+bwd {sbb_unfused_ms:.3f}; profiled {sb_train['kernel_ms']['bwd']:.2f}; atomic "
        f"instructions in its machine code {sum(sbb_atomics.values())}, so global atomics per "
        f"step {sbb_kernel['atomics_per_step']}); step "
        f"card-vs-cpu {json.dumps(sb_step_diffs)}; total {time.perf_counter() - t_start:.0f} s")
    # the explicit backward per DGM training step: each site once per microbatch
    bwd_rows = [r for r in la_bwd_rows if r["dtype"] == "bfloat16"]
    bwd_step = {k: dgm["accum"] * sum(r[k] for r in bwd_rows)
                for k in ("ms", "plain_autograd_ms", "bound_ms")}
    log(f"[summary] DGM training {dgm['samples_per_s']:.3f} samples/s, step "
        f"{dgm['step_ms']:.2f} ms (batch 128 in microbatches of {dgm['microbatch']}, remat "
        f"{dgm['remat']}), peak {dgm['peak'] / 2**30:.2f} GiB, device idle "
        f"{100 * dgm_prof['idle']:.1f}%; held-out loss {dgm['held_loss'][0]:.5f} -> "
        f"{dgm['held_loss'][1]:.5f}; linear-attention backward {bwd_step['ms']:.3f} ms per step "
        f"(bound {bwd_step['bound_ms']:.3f}, autograd of the plain version "
        f"{bwd_step['plain_autograd_ms']:.3f}); card-vs-cpu {json.dumps(dgm_diffs)}")
    log("[dgm-summary] " + json.dumps({
        "step_ms": dgm["step_ms"], "samples_per_s": dgm["samples_per_s"],
        "peak_bytes": dgm["peak"], "microbatch": dgm["microbatch"], "accum": dgm["accum"],
        "remat": dgm["remat"], "attempts": dgm["attempts"], "first_step_ms": dgm["first_ms"],
        "timed_step_ms": dgm["times"], "held_loss": dgm["held_loss"], "losses": dgm["losses"],
        "launches_per_step": dgm["launches_per_step"], "profile": dgm_prof,
        "backward_per_step": bwd_step,
        "backward_max_rel_err": {f"{dt} {n}": v for (dt, n), v in la_bwd_worst.items()},
        "backward_sites": la_bwd_rows, "card_vs_cpu": dgm_diffs}))
    for model_name, g in (("window kernels", graph), ("fused_block", sb_graph)):
        log(f"[summary] graph training step ({model_name}): {g['step_ms']:.2f} ms, "
            f"{g['pairs_per_s']:.2f} pairs/s, idle {100 * g['idle']:.1f}%, peak "
            f"{g['peak_bytes'] / 2**30:.2f} GiB (reserved {g['reserved_bytes'] / 2**30:.2f}); "
            f"eager {g['eager_step_ms']:.2f} ms, idle {100 * g['eager_idle']:.1f}%; "
            f"{g['fused_call_ms_per_step']:.2f} ms per step at {TIMED_STEPS} steps per call; "
            f"graph vs eager {json.dumps(g['vs_eager'])}")
    log("[graph-summary] " + json.dumps({"window": graph, "fused_block": sb_graph}))
    pt = pipe["train"]
    log(f"[summary] pipeline: {pipe['conditions']['build_ms_per_condition']:.3f} ms per "
        f"condition on the card; generation {pipe['generate']['samples_per_s']:.3f} samples/s; "
        f"streamed HEM step {pt['step_ms']:.2f} ms, {pt['pairs_per_s']:.2f} pairs/s, idle "
        f"{100 * pt['idle']:.1f}%, its batch's copy {pt['copy_ms']:.3f} ms from pinned memory; "
        f"loader {pt['loader_ms_per_batch'][0]:.2f} / {pt['loader_ms_per_batch'][PIPE_WORKERS]:.2f}"
        f" ms per batch with 0 / {PIPE_WORKERS} workers; phase {pipe['phase_s']:.1f} s")
    log("[pipeline-summary] " + json.dumps(pipe))
    one, ranks = dp["one_rank"], dp["ranks"]
    log(f"[summary] data parallel: one-rank nccl group graph step {one['step_ms']:.2f} ms (no group "
        f"{one['no_group_step_ms']:.2f}), {one['all_reduces_captured']} all-reduces captured per "
        f"step; {DP_WORLD} ranks ({ranks['backend']}, {ranks['cards']} card(s)) within phase 8c's "
        f"and 25's rules of one process; phase {dp['phase_s']:.1f} s")
    # the generic variants (phase 28): at the shipped config with window 4
    gt, gw, gm = generic["times"]["totals"], generic["worst"], generic["main_path_worst"]
    units = {"forward": f"per estimator forward at window 4, B={BATCH}, fp32",
             "step": (f"per training step at window 4, B={BATCH} in microbatches of "
                      f"{MICROBATCH}, the step's dtypes")}
    for entry, kname, errs in ((kernel, "window_attention_fwd", ("wa_fwd",)),
                               (bwd_kernel, "window_attention_bwd", ("wa_bwd", "wa_dbias")),
                               (sb_kernel, "swin_block_fwd", ("sb_fwd",)),
                               (sbb_kernel, "swin_block_bwd", ("sb_dx", "sb_grads"))):
        window = kname.startswith("window")
        g = {"source": ("dmhomo_torch/csrc/window_attention_any.cuh" if window
                        else "dmhomo_torch/csrc/swin_block_any.cu"),
             "max_abs_err": {dt: max(gw[f"{e} {dt}"] for e in errs)
                             for dt in ("float32", "bfloat16")},
             "max_abs_err_main_path": {dt: max(gm[f"{e} {dt}"] for e in errs)
                                       for dt in ("float32", "bfloat16")},
             "library": "SDPA at N = 16" if window else "the port's unfused SwinBlock on the card"}
        for where in ("forward", "step"):
            t = gt.get(f"{kname} per {where}")
            if t is not None:
                g[where] = {"launches": t["launches"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                            "library_ms": t["library_ms"], "unit": units[where]}
        entry["generic"] = g
    w4a, w4f = generic["w4"]["auto"], generic["w4"]["fused_block"]
    log(f"[summary] window 4 (phase 28): eval {w4a['pairs_per_s']:.2f} / {w4f['pairs_per_s']:.2f} "
        f"pairs/s (window kernels / fused_block; idle {100 * w4a['eval_idle']:.1f}% / "
        f"{100 * w4f['eval_idle']:.1f}%); training step {w4a['train']['step_ms']:.2f} / "
        f"{w4f['train']['step_ms']:.2f} ms eager, {w4a['train']['graph_step_ms']:.2f} / "
        f"{w4f['train']['graph_step_ms']:.2f} ms as a graph; phase {generic['phase_s']:.1f} s")
    log("[generic-summary] " + json.dumps(json_keys({
        "worst": gw, "main_path_worst": gm, "tiny": generic["tiny"], "window4": generic["w4"], "totals": gt}),
        default=str))
    # kernels 3 and 4 at any heads / dim_head (phase 29)
    for entry, g in zip(la_kernels, generic_la_entries(uncond)):
        entry["generic"] = g
    uncond_summary(uncond)
    # the DGM step as a CUDA graph (phase 30): launches per replay
    for p, entry in enumerate(la_kernels, start=1):
        entry["launches_per_dgm_graph_step"] = dgm_steps["shipped"]["launches_per_replay"][
            f"linear_attention_pass{p}"]
    dgm_steps_summary(dgm_steps, dgm["step_ms"])
    # phase 31: kernel 3 without atomics (counted in its machine code; the
    # reduction launch of each pass-1 call is one of its kernels)
    k3 = rest["kernel3"]
    la_kernels[0]["atomic_instructions"] = k3["atomic_instructions"]
    la_kernels[0]["reruns_differing"] = sum(k3["reruns_differing"].values())
    la_kernels[0]["rest_ms"] = k3["ms"]
    bh = rest["baseshomo"]
    log(f"[summary] phase 31: BasesHomo {bh['pairs_per_s']:.2f} pairs/s at B={BH_BATCH}, peak "
        f"{bh['peak_bytes'] / 2**30:.2f} GiB, idle {100 * bh['idle']:.2f}%; hem_eval --mask-vis "
        f"{rest['mask_vis']['files']} files; make_samples --warp-check "
        f"{rest['warp_check']['gifs']} GIFs; kernel 3 {sum(k3['atomic_instructions'].values())} "
        f"atomic instructions, reruns differing {sum(k3['reruns_differing'].values())}, "
        f"{k3['ms']['generation batch']:.2f} ms per generation batch, {k3['ms']['DGM step']:.3f} "
        f"per DGM step; phase {rest['phase_s']:.1f} s; total {time.perf_counter() - t_start:.0f} s")
    log(smi)  # nvidia-smi: card name, power limit
    log(json.dumps({"kernels": [kernel, bwd_kernel] + la_kernels + [sb_kernel, sbb_kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
