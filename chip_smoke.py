#!/usr/bin/env python3
"""Drives the PyTorch port (``src/repro_torch``) on one CUDA card and checks it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package.  Each phase
prints one JSON record on a line of its own; any failure raises and the
script exits non-zero without its result line.  The phases:

 1. device and toolchain: the card and its power limit, torch, CUDA, nvcc,
    scipy (the planner's ILP engine);
 2. build: the kernels from ``src/repro_torch/kernels/csrc``, with each
    kernel's registers, shared memory and spills from ptxas;
 3. every kernel against its plain version on the card, in bf16, at the
    shapes the serving paths give it (and danube's head shapes): rmsnorm
    in bf16 and float32 at widths 1024, 2048, 3840 and 1000 with 8, 4096
    and 5000 rows (5000: off its persistent grid), at a width off 16 bytes,
    one beyond its row kernel and an input off 16 bytes, and its gated form
    at mamba2-370m's decode and prefill with z strided as ``torch.chunk``
    gives it; flash
    attention also at a ragged length (S 129) and GQA 7, decode attention
    also at the edges of its cache splits, with splits left empty, calls
    back to back and calls on two streams at once (each stream has its own
    workspace), the fused attention-sublayer chain in the growing,
    boundary and wrapped ring states, the SSD scan at mamba2-370m's
    prefill, at a ragged length, at the edges of its own chunk of 64
    tokens (L 1, L 65) and at the reduced config's widths (P8 N16); and
    nemotron-4-15b's and deepseek-coder-33b's serving shapes: the chain at
    widths 6144 and 7168 at B 8 and 16, flash prefill and decode attention
    at H48/KV8 and H56/KV8; and seamless-m4t-medium's, in bf16 and float32:
    flash not causal at H16 KV16 D64 with Sq = Sk = 1024, Sq 128 and 2048
    against Sk 1024 and a ragged Sk 1000, decode attention over the cross
    cache (B8, C 1024 and 1000) and the chain at D1024 H16 KV16 hd64;
 4. serving: the port's ``LMServer`` on qwen2.5-3b and on mamba2-370m, each
    at full width, random weights from a seed, 8 requests of 64-400 prompt
    tokens, 32 new tokens each; the launch counts are reset just before
    each round and read just after, and every kernel of that path must
    have launched (the qwen decode step through the fused chain, never
    through `_composed_step`);
 5. A/B, for each model: two of those requests through the oracle route
    (``impl="ref"``) and the kernel route in lockstep; logits must agree
    within the stated tolerance at every step, tokens up to the first
    near-tie (mamba2-370m in float32, beside the spread that a change of
    summation order alone gives its stack in bf16 and in float32); and one
    mamba2-370m block at full width in bf16, prefill at the serving bucket
    and 4 decode steps, both routes;
 6. times: each kernel's device time at its serving shape (from
    ``torch.profiler``, over many launches on input copies that overflow
    the L2 cache), beside its bound, its plain version and one library
    call that computes the same function (for the fused chain, whose
    function no single PyTorch call computes, the yardstick is
    `_composed_step`); the chain's two GEMV launches as rows of their own
    (out_residual beside ``torch.addmm``, qkv_rope beside ``F.rms_norm`` +
    ``torch.addmm``); how decode attention's time scales with the batch and
    the live cache, with its split plan; and how the GEMVs' time scales
    with the batch, the width, one block alone, the split and the tile
    width (``gemv_scaling``); the SSD scan's time at B 1 and 8 and L 512
    and 2048, with the blocks an SM (``ssd_scaling``); rmsnorm at (8,
    1024), (8, 2048) and (4096, 2048) and its gated form at (8, 2048) and
    (4096, 2048), each beside an empty kernel on the same grid (the launch
    floor), and rmsnorm's time with other plans (``rmsnorm_scaling``);
    flash, decode attention, the chain's GEMVs and rmsnorm (8 rows) also at
    the two large dense decoders' serving shapes (``times_large``), and
    flash not causal (the encoder's B8 S1024 and the cross B8 Sq128 Sk1024,
    H16 KV16 D64, beside SDPA not causal), decode attention over the cross
    cache and the chain's GEMVs at seamless-m4t-medium's D1024
    (``times_prefix``); the forwards past the row kernel on the cluster
    kernel (jamba's gated norm at 16384 in bf16 and float32, the plain norm
    at 16384 and at 8192 in float32, over 8 and 4096 rows): each checked
    against its plain version, its route by the counters, called twice and
    compared bitwise, and timed beside the wide kernel forced in the same
    call, its bound, ``F.rms_norm`` or the gated norm's yardstick and the
    launch floor (``kernel_time_cluster_forward``);
 7. where a decode step's device time goes, for each model, from
    ``torch.profiler``, and the device's idle share against the wall time
    of unprofiled steps; the same for one mamba2-370m prefill at the
    serving bucket, with the scan's share of the device time;
 8. pipeline: the same 8 requests through ``LMServer(max_batch=4,
    pipeline=DecodePipeline(...))`` on the same weights, the plan from the
    port's planner on a decode shape (B 4, 512 tokens) priced on the H100,
    every slice placed on the one card: qwen2.5-3b with 9 layers a stage
    (embed, four block stages, head), unfused, fused (``"auto"``) and
    unfused with ``overlap=False``; mamba2-370m with 12 layers a stage.
    Each serve must give the tokens of the single-device
    ``LMServer(max_batch=4)`` exactly, run no program at a new (shape,
    thread, stream) inside the serve (``compile_stats.late == 0``: the
    warm-up ran each on the worker thread and stream its ops run on),
    launch every kernel of its path (counts reset just before the serve,
    read just after) and, overlapped, run on more than one stream.
    Printed beside the single-device serve: tok/s, wall time, ``slo()``,
    the engine's in-flight high water, stage seconds and firings,
    launches a generated token, peak memory and the memory a serve leaves
    allocated; for qwen2.5-3b's unfused pipeline, one more serve,
    profiled (the device's busy time, the union of kernel intervals over
    all streams, and idle share) and traced (each stage's waits); and the
    phase's own seconds (this phase runs after 6 and 7: run before them,
    it left the profiler recording less kernel time there);
 9. resilience, on phase 8's weights, requests and plans: drills through
    the pipeline (two groups of 4, 32 new tokens), each holding its tokens
    to the single-device ``LMServer(max_batch=4)``'s exactly, with no first
    call inside a serve (``late == 0``) and every kernel of its path
    launched (counts reset just before each drill, read just after).
    qwen2.5-3b, 9 layers a stage: a crash of ``blocks01`` r1 at token 6,
    overlapped; a crash of ``blocks00`` r0 at its third op, serial; a
    stalled ``blocks00`` r0 driving a ``HealthController`` (a migration and
    re-plan advice); a pause after 8 tokens resumed on the same pipeline,
    and another resumed on the successor that ``rescale_serving`` builds
    at 12 layers a stage with the advice (caches replayed); a crash of the
    lone embed replica, which must raise ``PipelineFailure`` with its
    diagnostic bundle, then a plain serve on the same pipeline.
    mamba2-370m, 12 layers a stage: the first crash drill.  Each crash
    drill's first cache replay runs again alone, twice: its launches, its
    time and the two rebuilt caches bitwise equal.  Also ``compare_lm`` of
    phase 8's traced qwen2.5-3b serve and what ``measured_replan`` changes;
    each drill's peak memory over what was resident, and the phase's
    seconds;
10. training, after the serving models are freed: the backward kernels
    against the plain version's autograd gradients in bf16 and float32:
    flash attention at qwen2.5-3b's training shape (B 2, S 4096, H 16, KV
    2, D 128, causal), danube's heads (D 120, window 256, S 1024), GQA 7
    and a ragged S 129, and not causal at seamless-m4t-medium's encoder
    (B 2, S 1024, H 16, KV 16, D 64) and at Sq != Sk (512 against 1024,
    1024 against 1000); rmsnorm at (8192, 2048), width 1000 and a row off
    16 bytes; the SSD scan at mamba2-370m's training shape (B 2, L 4096, H
    32, P 64, N 128), L 129, L 1, L 65 and the reduced widths (P 8, N 16),
    b and c strided as ``Mamba._proj`` slices them; the gated norm at
    (8192, 2048) with z strided as ``torch.chunk`` gives it, and at width
    1000; each of the last two also called twice and compared bitwise;
    the cluster kernels (rows past the row kernels): the plain gradient at
    (8192, D) for D 5120, 6144, 7168 and 8192 and jamba's gated gradient
    (16384) at 8 and 4096 rows, checked in both dtypes, called twice
    through autograd and compared bitwise, and timed beside the wide
    kernels they replace (the plans forced to them in the same call) and
    ``F.rms_norm``'s backward (``train_kernel_time_cluster``).
    Their times at the training shapes beside their bounds, the plain
    versions' autograd and the library's (SDPA's backward, ``F.rms_norm``'s;
    none computes the scan's or the gated norm's); one train step (accum 2)
    of qwen2.5-3b and of mamba2-370m at full width cut to 2 layers, kernel
    route against ``impl="ref"`` from the same float32 masters and batch
    (loss and every leaf's gradient norm, float32 and bf16; mamba2-370m's
    beside the oracle's spread with its scan's chunk halved);
    qwen2.5-3b (36 layers, 3.40 B parameters) and mamba2-370m (48 layers,
    368 M) at full width and depth, AdamW on float32 masters, through
    ``train_loop``: the bigram pipeline at seq 4096, global batch 8,
    grad_accum 4, remat "full", one warm-up step, 4 timed steps (launch
    counts set to 0 just before them and read just after; every forward
    and backward kernel of the model must launch and no plain version be
    called), one step profiled (device idle share); and a crash-restart
    drill on qwen2.5-3b ``reduced()`` (checkpoint every 2 steps, crash at
    step 3) whose final float32 parameters must be bitwise an
    uninterrupted run's;
11. the paper's STG path on the host: JPEG planned by the heuristic and
    the ILP at v 4, each plan materialised and streamed through the
    interpreter (sink streams bitwise ``simulate.run_functional``'s and
    ``jpeg.reference_pipeline``'s, measured inverse throughput within 15%
    of ``throughput.analyze``), the same for StreamIt's FFT, filterbank and
    autocorrelation, 1F1B and interleaved 1F1B simulated against their
    bubble models, ``verify_graph`` on each committed graph; each part's
    seconds;
12. the two large dense decoders, after training is freed:
    nemotron-4-15b (32 layers, d_model 6144, 48 heads on 8, vocab 256000)
    and deepseek-coder-33b (62 layers, d_model 7168, 56 heads on 8) at
    full width and depth on random bf16 weights, one at a time (the
    memory allocated before each must be under 2 GB): nemotron-4-15b
    first through ``repro_torch.launch.serve.main``, then phase 4's
    traffic at ``max_batch`` 8 for both and 16 requests at ``max_batch``
    16 for deepseek-coder-33b, every kernel of the path launched in each
    counted round and the decode step always through the fused chain;
    the A/B of phase 5 at full depth; tok/s, decode step p50 / p90,
    resident weights and peak memory over them, a profiled decode step's
    idle share;
13. training through the port's microbatch pipeline (``LMPipeline``), the
    plan from the port's planner on a training shape priced on the H100,
    every slice on the one card: qwen2.5-3b at full width and depth, 9
    layers a stage, float32 masters and bf16 activations, 8 microbatches
    of (1, 1024) tokens, the loss a float32 mean of the logits' squares,
    through the sequential oracle, 1F1B, 1F1B with ``overlap=False``,
    interleaved 1F1B (2 programs x 3 chunks: (3 x 2) would need a number
    of microbatches that 3 divides) and a fill-drain serve; mamba2-370m at
    full width and depth, 12 layers a stage, 8 microbatches of (1, 2048),
    through the oracle and 1F1B.  Each run warmed, then counted (every
    kernel of its path launched, no plain version called, ``late == 0``,
    more than one stream when overlapped); every schedule's gradients and
    losses bitwise the oracle's, the serve's logits bitwise
    ``reference()``'s; tok/s and wall seconds beside the oracle's, stage
    inverse and host µs, ``max_inflight``, peak memory over resident, the
    bubble beside ``interleaved_bubble``, ``compare_lm``'s ratios, a
    profiled 1F1B run's device idle share, and the memory left after
    ``close()`` (within 64 MB of where it was); a 2-layer full-width
    qwen2.5-3b pipeline, kernel route against ``impl="ref"``, the losses
    and each leaf's gradient norm within phase 10's bf16 tolerance;
14. the families that read an input other than tokens (`prefix_families`):
    seamless-m4t-medium (12 encoder and 12 decoder layers, d_model 1024, 16
    heads on 16, vocab 256206) served at full width and depth through
    ``build_model(cfg).prefill`` / ``.decode_step`` (8 sequences of 128
    tokens and 1024 frames, 31 greedy steps, the cross caches bitwise
    unchanged by them), its A/B with frames, trained at full width and
    depth through `make_train_step` (AdamW, float32 masters, grad_accum 4,
    global batch 8 of 1024 tokens and 1024 frames: a warm-up and 3 timed
    steps) and a 2 + 2-layer step A/B'd against ``impl="ref"``;
    internvl2-26b (48 layers, d_model 6144, 48 heads on 8, 19.9 B
    parameters) served at full width and depth, first text-only through
    ``repro_torch.launch.serve.main``, then with 256 prefix embeddings ahead
    of 8 prompts of 128 tokens, its A/B with the prefix strict at full
    depth, a profiled decode step, and one train step of a 2-layer
    full-width cut with the prefix A/B'd against ``impl="ref"``.  Every
    counted run launches every kernel of its path and calls no plain
    version;
15. the MoE decoders (`moe_serving`), at full width on random bf16
    weights, one at a time: llama4-scout-17b-a16e cut to 12 of its 48
    layers (16 experts, top-1, a shared expert; 57 GB) and
    llama4-maverick-400b-a17b cut to one (dense, MoE) period of 2 layers
    (128 experts; 37 GB), each serving phase 4's traffic through
    ``LMServer`` (counted: every attention kernel launched, no plain
    version called); each MoE layer's prefill drops (the GShard capacity
    a row, pads first) and the experts a decode step hits; phase 5's A/B
    at full width with each MoE sublayer's routing compared under both
    routes, and a float32 A/B of a 2-layer cut with every routing decision
    equal; a profiled decode step (the expert products beside the bounds
    of all experts' bytes and of the hit experts'); scout's 2-layer train
    step, kernel route against ``impl="ref"``.  Phase 3 checks and phase
    6 times (``times_moe``) their attention shape, H40 KV8 hd128 at
    d_model 5120;
16. the hybrid (`hybrid_serving`): jamba-1.5-large-398b cut to its first
    four layers at full width (attention/dense, mamba/moe, mamba/dense,
    mamba/moe; 256 SSM heads of 64, 16 experts top-2; 22.98 B parameters,
    46 GB of bf16 weights) serving phase 4's traffic through ``LMServer``
    (counted: every kernel launched, no plain version called), a profiled
    decode step, each MoE sublayer's routing under both routes on one
    input, phase 5's A/B in bf16 with every route on the oracle's routing
    (the kernel route no farther from float32 than 1.25 times the bf16
    oracle's largest distance), a float32 A/B
    of a 2-layer cut with every routing decision equal, the
    same requests through ``DecodePipeline`` (one period a stage) with the
    single-device server's tokens, a train step of the 2-layer cut with
    bf16 masters against ``impl="ref"``, and the host's FLOP and byte
    counts (``step_cost.count_step`` on the meta device, ``analyze_step``)
    of its decode step and prefill and of qwen2.5-3b's decode step beside
    the measured times.  Phase 3 checks, and phase 6 (``times_hybrid``) and
    10 (``train_kernel_time_hybrid``) time, its kernels' shapes: the scan
    at B8 L512 H256 P64 N128 and its backward at B1 L4096, the gated norm
    at width 16384 (8 and 4096 rows) and its backward, rmsnorm at (8,
    8192), flash at B8 S512 H64 KV8 D128 and its backward, decode attention
    at C544 and the chain at D 8192;
18. the one-rank mesh (`mesh_phase`, run after 16): a NCCL process group
    of world 1 and a (1, 1) ("data", "model") ``DeviceMesh``; qwen2.5-3b at
    full width and depth trained by ``train_loop`` for 3 steps at phase
    10's shape without a mesh and then with ``mesh=`` and ``fsdp=True``
    (parameters and optimizer state DTensors placed by the JAX specs; the
    losses bitwise or within 1e-3 relative, the record says which), and
    served for one round of phase 4's requests by ``LMServer(seed=0)``
    without and with ``mesh=`` (the tokens equal each other and phase
    4's); the meshed runs counted (every kernel of the path launched, no
    plain version called), the step and decode times of both beside the
    card (DTensor's cost at world 1); and the dry run's arguments of the
    training cell made on the card and placed on the mesh by the dry
    run's own placement (record ``"mesh_placed"``: their local bytes and
    the allocator's growth);
19. the pipelines over ranks (`ranks_phase`, run after 18): two processes
    share the card as ranks 0 and 1 of a gloo group (NCCL refuses two ranks
    on one card; gloo sends host copies of the card's tensors; two
    processes on one card are not a multi-card measurement), each loading
    the kernel library phase 2 built; the card's compute mode recorded (a
    refused second context fails the phase).  qwen2.5-3b at full width cut
    to 8 layers through an `LMPipeline` over both ranks (a stage a layer,
    the plan's slices alternating ranks), 1F1B and interleaved 1F1B, 8
    microbatches of (1, 1024), its losses and every gradient bitwise the
    one-rank `LMPipeline`'s run after it in rank 0; qwen2.5-3b and
    mamba2-370m at full width and depth through a `DecodePipeline` over
    both ranks (9 and 12 layers a stage) with phase 4's 8 requests in one
    group: tokens equal to phase 4's and to the one-rank pipeline's; each
    two-rank run with every rank's plain versions counted (none may run)
    and every kernel of each rank's stages launched there.  Recorded: wall
    seconds and tok/s beside the one-rank pipeline's, the bytes each rank
    sent, launches and host seconds by rank, peak memory by rank.  Then
    phase 9's drills on the same two ranks (`rank_drills`; records
    ``"ranks_drill"``, ``"ranks_escalation"``): qwen2.5-3b at full width
    and depth, 9 layers a stage, two groups of 4: crashes (overlapped and
    serial), a stall driving a ``HealthController`` (a slice moved rank to
    rank), the lone embed replica's crash, a pause resumed on the same
    pool, and one resumed on a successor on rank 0 alone at 12 layers a
    stage; each drill's tokens equal the uninterrupted two-rank serve's
    and phase 4's, every kernel of each rank's stages launched (replays
    included), no plain version;
    and (i) gains a crash that escalates, then a 1F1B run bitwise the
    first.  tp > 1 needs collectives that gloo lacks for CUDA tensors: it
    runs on the CPU only (``tests/test_torch_pipe_ranks.py``);
20. the dry run (`dryrun_phase`, run after 19), a host computation:
    ``python -m repro_torch.launch.dryrun --no-save`` in processes of its
    own, at once, for qwen2.5-3b's three runnable cells at 16x16 and
    jamba-1.5-large's ``long_500k`` at 2x16x16 (one process as rank 0 of a
    fake group of 256 or 512 ranks, meta tensors, no device work), and
    phase 18's training cell at (1, 1): every cell [OK], qwen2.5-3b's FSDP
    training moving all-gather and reduce-scatter traffic, and that
    cell's argument bytes equal to what phase 18 placed on the card and
    covered by the allocator's growth there, which exceeds them by at
    most 0.1%.
    Records ``"dryrun_cell"`` (a cell: the bottleneck, the three terms,
    wire bytes by kind, argument GB a device, seconds), ``"dryrun_card_check"``
    and ``"dryrun_phase"``, each beside the card's name and power limit
    and marked a host computation; no kernel is launched;
17. the ``kernels`` record (with phase 18's ``mesh_launches`` and phase
    19's ``rank_launches``, its drills' among them), the card's name and
    power limit, and last the
    result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
F32_FLOP_PER_S = 67e12          # H100 SXM float32 rate outside the tensor cores
L2_BYTES = 50 * 2 ** 20
SPIN_HZ = 2e9                   # clocks a second of `torch.cuda._sleep`: at least the H100's 1.98 GHz
# the two large dense decoders that phase 12 serves
LARGE = ("nemotron-4-15b", "deepseek-coder-33b")
# the two MoE decoders that phase 15 serves (their attention is one shape)
MOE = ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b")
# the hybrid that phase 16 serves
JAMBA = "jamba-1.5-large-398b"

# kernel vs plain, bf16: |kernel - plain| <= ATOL + RTOL * |plain|, two bf16
# steps at magnitude 1, since both round a float32 result to bf16
ATOL = RTOL = 2e-2
# the same in float32 (the norms): both sum float32 squares in another order
F32_TOL = 2e-5
# the SSD scan's float32 state against the plain version's: both sum float32
# products of the same bf16 inputs in another order, so an entry may be off by
# ~1e-4 of the largest one (STATE_ATOL is taken of the state's largest value)
STATE_ATOL = STATE_RTOL = 1e-4
# kernel route vs oracle route, bf16 logits after 36 layers: eight bf16 steps
# at the logits' magnitude (~4); a greedy token may part where the oracle's
# top-2 margin is under twice that, since each side may move by LOGIT_TOL
LOGIT_TOL = 0.25
TIE_MARGIN = 2 * LOGIT_TOL
# mamba2-370m's A/B runs its full width and depth in float32: in bf16 the
# random 48-layer stack carries a mere change of summation order into logits
# as different as the logits themselves (the oracle against itself with its
# chunk halved; phase 5 prints that spread for both dtypes).  In float32 that
# spread is ~0.006 at logits of magnitude ~2.5; the kernel route (the scan
# and norms summing in their own order) is held to 8 times it.
MAMBA_LOGIT_TOL = 0.05
# one mamba2-370m block in bf16, kernel route vs oracle route: its output
# within ATOL + RTOL |ref|, two bf16 steps at its magnitude.  Both routes
# round it once to bf16; what differs inside (the order of the scan's and
# the norms' sums, moving single bf16 roundings of y and of the normalised
# gate) reaches it through w_out, a sum of 2048 inputs at weights ~2048^-1/2.

# backward kernels against the plain version's autograd gradients, as a share
# of the gradient's largest entry: bf16, about three bf16 steps (both round
# each gradient to bf16 once, and the flash kernel takes rowsum(dO o) from the
# forward's bf16 output o where the plain version's autograd has the float32
# one); float32, sums of up to 4096 float32 terms (and the scan's 32 heads)
# taken in another order
GRAD_TOL = {"bfloat16": 3e-2, "float32": 2e-4}
# da at L 1 is 0 in exact arithmetic (no token decays another): the plain
# version's autograd gives float32 noise of the terms that cancel there (up to
# 1.8e-4 seen in a card test), so the kernel's is held to 0 within 1e-5
VANISHING_GRAD = 1e-5
# the 2-layer full-width train step, kernel route against impl="ref" from the
# same float32 masters and batch: the loss and each leaf's gradient norm,
# relative.  float32: the routes sum float32 products in another order; bf16:
# the routes round at other points (the flash forward rounds P to bf16 for its
# P V product, the oracle rounds the float32 output once), and a leaf's norm
# averages those single-step differences, as do mamba2-370m's (the scan's
# backward also runs its float32 operands through TF32).  mamba2-370m's step
# is printed beside the spread of the oracle against itself with its scan's
# chunk halved: what a change of summation order alone gives (its 2 layers
# moved a leaf's norm by 1.4e-3 so in bf16 on the card)
TRAIN_AB_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
# the MoE decoders' 2-layer float32 A/B (phase 15): the routes sum float32
# products in another order; ~1e-5 at logits of magnitude ~5, held to 1e-3
MOE_F32_LOGIT_TOL = 1e-3


def attention_shape(name: str) -> tuple:
    """(d_model, heads, KV heads, head dim) of a registered config."""
    from repro_torch.configs import get_config

    cfg = get_config(name)
    return cfg.d_model, cfg.attn.n_heads, cfg.attn.n_kv_heads, cfg.attn.head_dim


def jamba_mamba_shape() -> tuple:
    """(SSM heads, head dim, state width) of jamba's Mamba2 mixers."""
    from repro_torch.configs import get_config

    cfg = get_config(JAMBA)
    return cfg.mamba.n_ssm_heads(cfg.d_model), cfg.mamba.head_dim, cfg.mamba.d_state


def large_shapes() -> dict:
    """(d_model, heads, KV heads, head dim) of each of LARGE, from its config."""
    return {name: attention_shape(name) for name in LARGE}


def emit(phase: str, **record) -> None:
    print(json.dumps({"phase": phase, **record}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """``decode_attention_kernel<bf16,4>`` from an Itanium-mangled kernel
    name (nested in nvcc's per-file anonymous namespace), with its template
    arguments (float, bf16, an int or a bool as 0/1); the mangled name where
    it does not parse."""
    i, name = 3, None
    if not mangled.startswith("_ZN"):
        return mangled
    while (m := re.match(r"\d+", mangled[i:])):       # <length><identifier> ...
        start = i + m.end()
        name, i = mangled[start:start + int(m.group())], start + int(m.group())
    if name is None or not mangled.startswith("I", i):
        return name or mangled
    args, i = [], i + 1
    while (t := re.match(r"L[ib](-?\d+)E|f|13__nv_bfloat16", mangled[i:])):
        args.append(t.group(1) or {"f": "float"}.get(t.group(0), "bf16"))
        i += t.end()
    return f"{name}<{','.join(args)}>" if mangled.startswith("E", i) else mangled


def ptxas_report(log: str) -> dict:
    """Registers, shared memory and spills of each compiled kernel."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name]["stack_bytes"] = int(m.group(1))
            out[name]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def sass_record(lib_path, names) -> dict:
    """Per kernel whose name starts with one of ``names``: its count of
    warpgroup products (HGMMA), tensor copies (UTMALDG) and bulk copies
    (UBLKCP) in the library's machine code, from ``cuobjdump -sass``."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            name = name if name.startswith(tuple(names)) else None
            if name:
                out[name] = dict(HGMMA=0, UTMALDG=0, UBLKCP=0)
            continue
        if name:
            for op in out[name]:
                if op in line:
                    out[name][op] += 1
    return out


def counted(fn, kernels, require=True):
    """Run ``fn`` once, every launch count set to 0 just before it and
    read just after, the peak-memory mark reset just before it.  Returns
    its result and a record: wall seconds (the card synchronized at both
    ends), launches, the peak and what stayed allocated over what was
    allocated before.  ``require``: True, every kernel must have
    launched; else the names of those that must."""
    import torch
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    rec = dict(wall_s=time.perf_counter() - t0,
               launches={name: k.launches for name, k in kernels.items()},
               peak_over_start=torch.cuda.max_memory_allocated() - before,
               left_allocated=torch.cuda.memory_allocated() - before)
    need = kernels if require is True else (require or ())
    missing = [name for name in need if rec["launches"][name] == 0]
    if missing:
        raise AssertionError(f"no {missing} kernel launched")
    return out, rec


def run_counted(what, fn, kernels, rounds, absent=None):
    """`counted`, with every plain version and `_composed_step` counted too:
    none may run; nor may the kernels that ``absent`` counts ({name:
    counter}).  Keeps the launches in ``rounds[what]``; returns ``fn``'s
    result."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_decode as fd
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ss

    plain = [(fa, "flash_attention_plain"), (da, "decode_attention_plain"),
             (rn, "rmsnorm_plain"), (fd, "fused_decode_plain"), (fd, "qkv_plain"),
             (fd, "out_residual_plain"), (ref, "mha_reference"), (ref, "decode_attention_ref"),
             (ref, "rmsnorm_reference"), (ss, "ssd_scan_plain"), (ref, "ssd_chunked"),
             (rn, "rmsnorm_gated_plain")]
    calls, originals = {}, {(m, a): getattr(m, a) for m, a in plain}

    def counting(name, f):
        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return f(*a, **kw)
        return wrapped
    for m, a in plain:
        setattr(m, a, counting(a, originals[(m, a)]))
    fd._composed_step.calls = 0
    try:
        out, rec = counted(fn, dict(kernels, **(absent or {})), require=list(kernels))
    finally:
        for m, a in plain:
            setattr(m, a, originals[(m, a)])
    if calls or fd._composed_step.calls:
        raise AssertionError(f"{what}: plain versions called {calls}, _composed_step "
                             f"{fd._composed_step.calls} times: the path left its kernels")
    launched = {k: rec["launches"][k] for k in absent or () if rec["launches"][k]}
    if launched:
        raise AssertionError(f"{what}: launched {launched}, which this path must not")
    rounds[what] = rec["launches"]
    return out


def refuse_above_2gb(record: str, name: str, smi) -> None:
    """Frees what the allocator caches, prints the memory allocated, and
    refuses to build ``name`` beside more than 2 GB."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    emit(record, config=name, memory_allocated_gb=before / 1e9, card=smi)
    if before > 2e9:
        raise AssertionError(f"{name}: {before / 1e9:.2f} GB already allocated")


def resilience(cfg, params, prompts, pps, ctx, kernels, *, full, device="cuda",
               rescale_pps=12):
    """Phase 9: drills on phase 8's weights, requests and plan, through the
    pipeline at ``pps`` periods a stage, two groups of 4, 32 new tokens.
    Each drill must give the single-device server's tokens exactly, make
    no first call inside a serve (``late == 0``) and launch every kernel
    of the path (counts reset just before the drill, read just after).
    Both models: a crash of ``blocks01`` r1 at token 6, overlapped, and
    that crash's cache replay run again alone, twice (launches, time, and
    the two rebuilt caches bitwise equal).  ``full`` (qwen2.5-3b) adds: a
    crash of ``blocks00`` r0 at its third op with ``overlap=False``; a
    stall of ``blocks00`` r0 driving a `HealthController` (a migration
    and re-plan advice); ``pause_after_tokens=8`` resumed on the same
    pipeline (caches handed off), and again resumed on the successor
    `rescale_serving` builds at ``rescale_pps`` layers a stage with the advice
    (caches replayed); a crash of the lone embed replica, which must
    raise `PipelineFailure` with its bundle, and a plain serve on the
    same pipeline after it; and `compare_lm` of phase 8's traced serve
    with what `measured_replan` changes.  Returns the first crash drill's
    launches and its replay's."""
    import torch

    from repro_torch.analysis.roofline import HW_H100
    from repro_torch.runtime.elastic import rescale_serving
    from repro_torch.runtime.failures import PipelineFailure, ReplicaFaultPlan
    from repro_torch.runtime.pipeline import (DecodePipeline, HealthController,
                                              PipelineReport, Tracer, as_selection,
                                              compare_lm, measured_replan)
    from repro_torch.runtime.server import LMServer, Request

    plan, stg, shape, want = ctx["plan"], ctx["stg"], ctx["shape"], ctx["want"]
    reqs = [Request(uid=i, prompt=p, max_new=32) for i, p in enumerate(prompts)]
    replays: list = []

    def recorded(pipe):
        """Keep each cache replay's arguments and host seconds."""
        real = pipe._replay_cache

        def replay(g, s, k, reps, overlap):
            t0 = time.perf_counter()
            out = real(g, s, k, reps, overlap)
            replays.append(dict(group=g, stage=pipe.stage_names[s], s=s, k=k,
                                reps=list(reps), overlap=overlap,
                                host_s=time.perf_counter() - t0))
            return out
        pipe._replay_cache = replay
        pipe.real_replay = real
        return pipe

    def warmed(pipe):
        pipe.warm(prompts, 32, group_size=4)
        pipe.warm(prompts, 32, group_size=4, overlap=False)
        return pipe

    pipe = warmed(recorded(DecodePipeline(cfg, stg, plan, params=params,
                                          periods_per_stage=pps, device=device)))
    pipes = [pipe]

    def via_server(**kw):
        server = LMServer(cfg, max_batch=4, pipeline=pipe, device=device, **kw)
        return [o.tokens for o in server.serve(reqs)], server.last_run

    def via_pipe(target, fn):
        run = fn(target)
        return run.tokens, run

    def drill(label, fn, *, check_tokens=True, require=True, **extra):
        replays.clear()
        (tokens, run), rec = counted(fn, kernels, require)
        late = sum(p.compile_stats.late for p in pipes)
        emit("resilience", config=cfg.name, drill=label, periods_per_stage=pps,
             tokens_equal=tokens == want if check_tokens else None, late=late,
             failovers=run.failovers, streams_used=run.streams_used,
             replays=[{k: v for k, v in r.items() if k != "group"} for r in replays],
             paused=run.paused, **rec, **extra)
        if check_tokens and tokens != want:
            bad = [j for j, t in enumerate(tokens) if t != want[j]]
            raise AssertionError(f"{cfg.name} drill {label}: requests {bad} differ from "
                                 f"the single-device server")
        if late:
            raise AssertionError(f"{cfg.name} drill {label}: {late} first launches inside "
                                 f"a serve")
        return run, rec, list(replays)

    def crash(label, spec, **kw):
        inj = ReplicaFaultPlan.parse(spec)
        out = drill(label, lambda: via_server(injector=inj) if not kw else
                    via_pipe(pipe, lambda p: p.serve(prompts, 32, group_size=4,
                                                     injector=inj, **kw)))
        run, _, reps = out
        if inj.fired != 1 or len(run.failovers) != 1 or not reps:
            raise AssertionError(f"{cfg.name} drill {label}: fired {inj.fired}, "
                                 f"failovers {run.failovers}, replays {len(reps)}")
        return out

    def replay_alone(r):
        """A drill's cache replay again, on the idle pipeline, twice."""
        caches = []
        for _ in range(2):
            cache, rec = counted(lambda: pipe.real_replay(r["group"], r["s"], r["k"], r["reps"],
                                                          r["overlap"]), kernels, require=False)
            caches.append(cache)
        flat = [[c["pos"]] + [t for layer in c["layers"] for t in layer.values()]
                for c in caches]
        same = all(torch.equal(a, b) for a, b in zip(*flat))
        emit("resilience_replay", config=cfg.name, stage=r["stage"], k=r["k"], reps=r["reps"],
             overlap=r["overlap"], bitwise_repeatable=same, **rec)
        if not same:
            raise AssertionError(f"{cfg.name}: a cache replay is not bitwise repeatable")
        return rec["launches"]

    run, rec, reps = crash("crash blocks01:r1@tok6", "blocks01:r1@tok6=crash")
    first_launches = rec["launches"]
    first_replay = replay_alone(reps[0])
    if not full:
        pipe.close()
        return first_launches, first_replay

    crash("crash blocks00:r0@op3 overlap=False", "blocks00:r0@op3=crash", overlap=False)

    tracer = Tracer()
    hc = HealthController(tracer=tracer, threshold=1.5, min_samples=4, check_every=8,
                          replan_after=2)
    stall = ReplicaFaultPlan.parse("blocks00:r0@op1=stall:0.03x999")
    drill("stall blocks00:r0@op1 x0.03s, health", lambda: via_server(
        tracer=tracer, injector=stall, health=hc))
    emit("resilience_health", config=cfg.name, ticks=hc.ticks, migrations=hc.migrations,
         advice=hc.replan_advice, strikes={f"{s}/r{r}": n for (s, r), n in hc.strikes.items()},
         reports=[r.describe() for r in hc.reports[-4:]], log=hc.log)
    if hc.migrations < 1 or not hc.replan_advice:
        raise AssertionError(f"health drill: {hc.migrations} migrations, advice "
                             f"{hc.replan_advice}")

    def pause():
        return via_pipe(pipe, lambda p: p.serve(prompts, 32, group_size=4, pause_after_tokens=8))

    run, _, _ = drill("pause after 8 tokens", pause, check_tokens=False)
    # no prefill on this path: the caches are adopted, not replayed
    drill("resume on the same pipeline", lambda: via_pipe(
        pipe, lambda p: p.resume(run.resume_state)),
        require=[k for k in kernels if k != "flash_attention"])
    run, _, _ = drill("pause after 8 tokens", pause, check_tokens=False)
    t0 = time.perf_counter()
    rs = rescale_serving(pipe, cfg, shape, plan, new_chips=1, stg=stg,
                         periods_per_stage=rescale_pps,
                         measured_ratio=hc.replan_advice, hw=HW_H100, max_tp=1)
    rescale_s = time.perf_counter() - t0
    succ = warmed(recorded(rs.pipe))
    pipes.append(succ)
    drill(f"resume on the successor, {rescale_pps} layers a stage", lambda: via_pipe(
        succ, lambda p: p.resume(run.resume_state)), rescale=rs.summary(),
        rescale_s=rescale_s, stages=succ.stage_names)
    succ.close()

    try:
        pipe.serve(prompts, 32, group_size=4,
                   injector=ReplicaFaultPlan.parse("embed:r0@op2=crash"))
        raise AssertionError("a crash of the lone embed replica did not raise")
    except PipelineFailure as e:
        keys = sorted(e.diagnostics)
        emit("resilience_escalation", config=cfg.name, stage=e.stage, replica=e.replica,
             reason=e.reason, bundle_keys=keys, lost_ops=e.diagnostics.get("lost_ops"))
        need = {"fifo_occupancy", "waiting", "schedule", "reorder_occupancy", "lost_ops",
                "failovers", "static_preflight"}
        if (e.stage, e.replica) != ("embed", 0) or not need <= set(keys):
            raise AssertionError(f"escalation: {e.stage}/r{e.replica}, bundle {keys}")
    drill("plain serve after the escalation", via_server)
    pipe.close()

    traced, stage_map = ctx["traced"]
    report = compare_lm(stg, as_selection(plan), traced, stage_map=stage_map)
    changed = {}
    for budget in (plan.total_chips, 2 * plan.total_chips):
        base = measured_replan(stg, PipelineReport(), area_budget=budget).selection.choices
        got = measured_replan(stg, report, area_budget=budget).selection.choices
        changed[str(budget)] = {n: [list(base[n]), list(c)] for n, c in got.items()
                                if c != base[n]}
    emit("resilience_measure", config=cfg.name, ratios=report.ratios(),
         accuracy=report.accuracy, v_app_measured_us=report.v_app_measured,
         v_app_analytic_us=report.v_app_analytic,
         bottleneck_measured=report.bottleneck_measured,
         bottleneck_analytic=report.bottleneck_analytic,
         measured_replan_changes=changed)
    return first_launches, first_replay


def training(check, copies, bound, smi, *, full=True, device="cuda"):
    """Phase 10: training.  The backward kernels against the plain version's
    autograd gradients (flash attention and rmsnorm at qwen2.5-3b's training
    shapes, flash also not causal at seamless-m4t-medium's encoder and
    cross-attention shapes; the SSD scan and the gated norm at mamba2-370m's, each also
    called twice and compared bitwise), and their times at those shapes;
    one train step (accum 2) of qwen2.5-3b and of mamba2-370m at full width
    cut to 2 layers, kernel route against ``impl="ref"`` from the same
    float32 masters and batch, in float32 and bf16 (mamba2-370m's beside
    the spread of the oracle against itself with its scan's chunk halved);
    qwen2.5-3b and mamba2-370m at full width and depth through
    `train_loop` (AdamW, float32 masters, the bigram pipeline at seq 4096,
    global batch 8, grad_accum 4, remat "full"): a warm-up step, 4 timed
    steps with the launch counts set to 0 just before them and read just
    after (every forward and backward kernel of the model must launch and
    no plain version be called), then one step profiled; and a
    `run_resilient` drill on qwen2.5-3b ``reduced()``, a checkpoint every 2
    steps and a crash at step 3, whose final float32 parameters must be
    bitwise those of an uninterrupted run.  ``full`` False: small shapes,
    for a rehearsal on the CPU.  Returns the kernel rows and the timed
    steps' launches (the SSD scan's and the gated norm's from
    mamba2-370m's run, the others from qwen2.5-3b's)."""
    import dataclasses
    import shutil

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data import make_pipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_backward,
                                                     flash_attention_forward,
                                                     flash_attention_plain)
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_backward, rmsnorm_gated,
                                             rmsnorm_gated_backward, rmsnorm_gated_plain,
                                             rmsnorm_plain)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_backward, ssd_scan_plain
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.probes.wide_norms import wide_plans
    from repro_torch.runtime.failures import FailureInjector
    from repro_torch.runtime.trainer import TrainLoopConfig, run_resilient, train_loop

    dev = torch.device(device)
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(4321)
    kernels = {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_backward,
               "rmsnorm": rmsnorm, "rmsnorm_bwd": rmsnorm_backward}
    mamba_kernels = {"rmsnorm": rmsnorm, "rmsnorm_bwd": rmsnorm_backward, "ssd_scan": ssd_scan,
                     "ssd_scan_bwd": ssd_scan_backward, "rmsnorm_gated": rmsnorm_gated,
                     "rmsnorm_gated_bwd": rmsnorm_gated_backward}

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def timed(fn, arg_sets, iters=10):
        """Device ms a call: CUDA events around ``iters`` calls cycling
        through ``arg_sets``, after a call on each, queued while the card
        spins (`torch.cuda._sleep`) for twice the time the host took to
        issue them once: the card then runs them back to back, and the
        events read its time, not the host's, however short a call (one
        launch of a backward's passes takes less than its wrapper's host
        work).  ``torch.profiler`` read less kernel time than the calls
        take here once phase 8 had run (PERF.md §7)."""
        if device != "cuda":          # a rehearsal on the CPU times nothing
            return 0.0
        for args in arg_sets:
            fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2 * host_s * SPIN_HZ))
        start.record()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    # -- the backward kernels against the plain version's autograd ----------
    def grads(fn, inputs, dout, **kw):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        fn(*leaves, **kw).backward(dout)
        return [t.grad for t in leaves]

    def check_grad(kernel, case, got, want, dtype, floor=0.0):
        tol = GRAD_TOL[str(dtype).removeprefix("torch.")]
        check(kernel, case, got, want, tol * float(want.float().abs().max()) + floor, tol)

    attn_shapes = ((((2, 4096, 16, 2, 128, None), "qwen's training shape"),
                    ((1, 1024, 32, 8, 120, 256), "danube's heads, window 256"),
                    ((2, 200, 14, 2, 128, None), "GQA 7"),
                    ((2, 129, 16, 2, 128, None), "ragged S 129")) if full else
                   (((1, 70, 4, 2, 16, None), "small"), ((1, 40, 4, 1, 16, 8), "small window")))
    cross_shapes = ((((2, 1024, 1024, 16, 16, 64), "seamless's encoder"),
                     ((2, 512, 1024, 16, 16, 64), "cross-attention, Sq < Sk"),
                     ((2, 1024, 1000, 16, 16, 64), "cross-attention, a ragged Sk")) if full else
                    (((1, 40, 24, 4, 4, 16), "small cross"),))
    width = 2048 if full else 64
    norm_shapes = ((((8192, 2048), "qwen's training rows"), ((8192, 1000), "width 1000"))
                   if full else (((64, 32), "small"),))
    for dtype in (bf16, f32):
        for (b, s_, h, kv, d, window), label in attn_shapes:
            q, k, v, do = (randn(b, s_, h, d, dtype=dtype), randn(b, s_, kv, d, dtype=dtype),
                           randn(b, s_, kv, d, dtype=dtype), randn(b, s_, h, d, dtype=dtype))
            got = grads(flash_attention, (q, k, v), do, window=window)
            want = grads(flash_attention_plain, (q, k, v), do, window=window)
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                check_grad("flash_attention_bwd", f"{label}: B{b} S{s_} H{h} KV{kv} D{d} "
                           f"causal window={window} {dtype}: {name}", g, w, dtype)
            del q, k, v, do, got, want
        # not causal, as seamless-m4t-medium trains it: its encoder's shape,
        # and cross-attention's Sq != Sk
        for (b, sq, sk, h, kv, d), label in cross_shapes:
            q, k, v, do = (randn(b, sq, h, d, dtype=dtype), randn(b, sk, kv, d, dtype=dtype),
                           randn(b, sk, kv, d, dtype=dtype), randn(b, sq, h, d, dtype=dtype))
            got = grads(flash_attention, (q, k, v), do, causal=False)
            want = grads(flash_attention_plain, (q, k, v), do, causal=False)
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                check_grad("flash_attention_bwd", f"{label}: B{b} Sq{sq} Sk{sk} H{h} KV{kv} "
                           f"D{d} not causal {dtype}: {name}", g, w, dtype)
            del q, k, v, do, got, want
        cases = [(randn(*shape, dtype=dtype), label) for shape, label in norm_shapes]
        cases.append((randn(8 * width + 1, dtype=dtype)[1:].view(8, width),
                      f"(8, {width}), a row off 16 bytes"))
        for x, label in cases:
            w = 1.0 + 0.1 * randn(x.shape[-1], dtype=f32)
            g = randn(*x.shape, dtype=dtype)
            got, want = grads(rmsnorm, (x, w), g), grads(rmsnorm_plain, (x, w), g)
            for name, a, b_ in zip(("dx", "dw"), got, want):
                check_grad("rmsnorm_bwd", f"{label} {dtype}: {name}", a, b_, dtype)
        del cases
    if device == "cuda":
        torch.cuda.empty_cache()

    # the SSD scan's and the gated norm's backward: mamba2-370m's training
    # shape, the scan also at a ragged length, at the edges of its chunk of
    # 64 tokens and at the reduced widths; b and c strided as `Mamba._proj`
    # slices them, z as ``torch.chunk`` gives it; trained Mamba2's long
    # memory (dt ~ 0.02, a ~ -0.14); the loss, as in training, uses y and
    # not the final state.  Each case also calls the backward twice and
    # compares the two bitwise.
    def ssd_in(b, L, h, p, n, dtype):
        bc = randn(b, L, 2 * n + h, dtype=dtype)
        return (randn(b, L, h, p, dtype=dtype), F.softplus(randn(b, L, h, dtype=f32) - 4.0),
                -torch.exp(-2.0 + 0.5 * randn(h, dtype=f32)), bc, randn(b, L, h, p, dtype=dtype))

    def ssd_grads(fn, x, dt, a, bc, dy):
        n = (bc.shape[-1] - x.shape[2]) // 2
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, dt, a, bc)]
        fn(*leaves[:3], leaves[3][..., :n], leaves[3][..., n:2 * n])[0].backward(dy)
        return [t.grad for t in leaves]

    def gate_in(lead, h, p, dtype):
        return (randn(*lead, h, p, dtype=dtype), randn(*lead, h, p, dtype=dtype),
                1.0 + 0.1 * randn(h, dtype=f32), randn(*lead, 2 * h * p, dtype=dtype),
                1.0 + 0.1 * randn(h * p, dtype=f32), randn(*lead, h * p, dtype=dtype))

    def gate_grads(fn, y, xh, d, xz, w, g):
        leaves = [t.detach().clone().requires_grad_(True) for t in (y, xh, d, xz, w)]
        fn(*leaves[:3], torch.chunk(leaves[3], 2, dim=-1)[1], leaves[4]).backward(g)
        return [t.grad for t in leaves]

    bitwise = []
    ssd_shapes = ((((2, 4096, 32, 64, 128), "mamba2-370m's training shape"),
                   ((2, 129, 32, 64, 128), "ragged L 129"), ((2, 1, 32, 64, 128), "L 1"),
                   ((2, 65, 32, 64, 128), "L 65"), ((2, 100, 16, 8, 16), "reduced widths"))
                  if full else (((1, 70, 4, 8, 16), "small"),))
    gate_shapes = ((((2, 4096), 32, 64, "mamba2-370m's training rows"),
                    ((2, 4096), 4, 250, "width 1000")) if full else (((4, 8), 4, 8, "small"),))
    for dtype in (bf16, f32):
        for (b, L, h, p, n), label in ssd_shapes:
            x, dt, a, bc, dy = ssd_in(b, L, h, p, n, dtype)
            got = ssd_grads(ssd_scan, x, dt, a, bc, dy)
            want = ssd_grads(ssd_scan_plain, x, dt, a, bc, dy)
            if L == 1:
                want[2] = torch.zeros_like(want[2])
            for name, g, w in zip(("dx", "ddt", "da", "d(b, c) projection"), got, want):
                check_grad("ssd_scan_bwd", f"{label}: B{b} L{L} H{h} P{p} N{n} {dtype}, b and c "
                           f"strided: {name}", g, w, dtype, VANISHING_GRAD)
            args = (x, dt, a, bc[..., :n], bc[..., n:2 * n], dy)
            first, second = ssd_scan_backward(*args), ssd_scan_backward(*args)
            bitwise.append((f"ssd_scan_bwd {label} {dtype}",
                            all(torch.equal(u, v) for u, v in zip(first, second))))
            del x, dt, a, bc, dy, got, want, first, second
        for lead, h, p, label in gate_shapes:
            y, xh, d, xz, w, g = gate_in(lead, h, p, dtype)
            got = gate_grads(rmsnorm_gated, y, xh, d, xz, w, g)
            want = gate_grads(rmsnorm_gated_plain, y, xh, d, xz, w, g)
            for name, a_, b_ in zip(("dy", "dxh", "dd_skip", "d(x, z) projection", "dw"), got,
                                    want):
                check_grad("rmsnorm_gated_bwd", f"{label}: {lead} H{h} P{p} {dtype}, z rows "
                           f"{2 * h * p} apart: {name}", a_, b_, dtype)
            args = (y, xh, d, torch.chunk(xz, 2, dim=-1)[1], w, g)
            first, second = rmsnorm_gated_backward(*args), rmsnorm_gated_backward(*args)
            bitwise.append((f"rmsnorm_gated_bwd {label} {dtype}",
                            all(torch.equal(u, v) for u, v in zip(first, second))))
            del y, xh, d, xz, w, g, got, want, first, second
    emit("train_bitwise", what="each backward called twice on the same inputs",
         cases={k: v for k, v in bitwise}, ok=all(v for _, v in bitwise))
    if not all(v for _, v in bitwise):
        raise AssertionError(f"a backward kernel gave other bits on a second call: "
                             f"{[k for k, v in bitwise if not v]}")
    if device == "cuda":
        torch.cuda.empty_cache()

    # -- times at qwen2.5-3b's training shape -------------------------------
    def with_graph(fn, *inputs):
        """``fn``'s output with its autograd graph, its leaves, and a dO."""
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        return out, leaves, torch.randn(out.shape, generator=gen, device=dev).to(out.dtype)

    def backward_only(out, leaves, dout):
        torch.autograd.grad(out, leaves, dout, retain_graph=True)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=True,
                                              enable_gqa=True)

    rows = []
    b, s_, h, kv, d = (2, 4096, 16, 2, 128) if full else (1, 64, 4, 2, 16)
    live = b * h * s_ * (s_ + 1) // 2                      # causal (query, key) pairs
    qkv_bytes = 2 * (b * s_ * h * d + 2 * b * s_ * kv * d)
    sets = copies(lambda: (randn(b, s_, h, d), randn(b, s_, kv, d), randn(b, s_, kv, d)),
                  qkv_bytes)
    # reads q, k, v, writes o and the float32 logsumexp; QK^T and PV
    b_ms, b_by = bound(qkv_bytes + 2 * b * s_ * h * d + 4 * b * h * s_, 4 * d * live,
                       BF16_FLOP_PER_S)
    fwd = dict(ms=timed(lambda q, k, v: flash_attention_forward(q, k, v, with_lse=True),
                        sets, iters=5),
               plain_ms=timed(flash_attention_plain, sets[:1], iters=2),
               library_ms=timed(sdpa, sets, iters=5), bound_ms=b_ms, bound_by=b_by)
    emit("train_kernel_time", kernel="flash_attention forward with logsumexp",
         shape=f"B{b} S{s_} H{h} KV{kv} D{d} causal bf16", card=smi, **fwd)
    bwd_sets = []
    for q, k, v in sets:
        o, lse = flash_attention_forward(q, k, v, with_lse=True)
        bwd_sets.append((q, k, v, o, randn(b, s_, h, d), lse))
    # reads q, k, v, o, dO and the logsumexp, writes dq, dk, dv; five products
    # a live pair (S and dP again, dV, dK, dQ)
    b_ms, b_by = bound(2 * qkv_bytes + 2 * 2 * b * s_ * h * d + 4 * b * h * s_, 10 * d * live,
                       BF16_FLOP_PER_S)
    def passes(mask):
        return lambda *a: flash_attention_backward(*a, passes=mask)

    # the row pass alone, and each product kernel after it, less the row pass
    rows_ms = timed(passes(fa.ROWS_PASS), bwd_sets, iters=3)
    bwd = dict(ms=timed(flash_attention_backward, bwd_sets, iters=3),
               plain_ms=timed(backward_only, [with_graph(flash_attention_plain, *sets[0])],
                              iters=2),
               library_ms=timed(backward_only, [with_graph(sdpa, *t) for t in sets], iters=3),
               bound_ms=b_ms, bound_by=b_by, rows_ms=rows_ms,
               dkdv_ms=timed(passes(fa.ROWS_PASS | fa.DKDV_PASS), bwd_sets, iters=3) - rows_ms,
               dq_ms=timed(passes(fa.ROWS_PASS | fa.DQ_PASS), bwd_sets, iters=3) - rows_ms,
               plan=fa.bwd_plan(b, s_, s_, h, kv, d, bf16=True, aligned=True)._asdict())
    emit("train_kernel_time", kernel="flash_attention backward",
         shape=f"B{b} S{s_} H{h} KV{kv} D{d} causal bf16", card=smi, **bwd)
    del sets, bwd_sets
    rows.append(("flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:85", dict(bwd, forward_with_lse=fwd)))

    n, dn = (8192, 2048) if full else (64, 32)
    nsets = copies(lambda: (randn(n, dn), 1.0 + 0.1 * randn(dn, dtype=f32), randn(n, dn)),
                   3 * 2 * n * dn)
    # reads x, g and w, writes dx and dw
    b_ms, b_by = bound(3 * 2 * n * dn + 8 * dn, 10 * n * dn, F32_FLOP_PER_S)
    norm = dict(ms=timed(rmsnorm_backward, nsets),
                plain_ms=timed(backward_only, [with_graph(rmsnorm_plain, x, w)
                                               for x, w, _ in nsets]),
                library_ms=timed(backward_only, [with_graph(
                    lambda x_, w_: F.rms_norm(x_, (dn,), w_, 1e-5), x, w.to(bf16))
                    for x, w, _ in nsets]),
                bound_ms=b_ms, bound_by=b_by)
    emit("train_kernel_time", kernel="rmsnorm backward", shape=f"({n}, {dn}) bf16", card=smi,
         **norm)
    del nsets
    rows.append(("rmsnorm_bwd", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                 "src/repro/kernels/rmsnorm.py:18", norm))
    if device == "cuda":
        torch.cuda.empty_cache()

    # -- times at mamba2-370m's training shape ------------------------------
    b, L, h, p, n = (2, 4096, 32, 64, 128) if full else (1, 128, 4, 8, 16)
    chunks, q = -(-L // ss.CHUNK), ss.CHUNK
    tri = q * (q + 1) // 2
    # reads x, dy, b, c, dt (and a), writes dx, db, dc, ddt (and da)
    ssd_bytes = 3 * 2 * b * L * h * p + 4 * 2 * b * L * n + 2 * 4 * b * L * h + 2 * 4 * h
    # the chunked algorithm's products, the causal ones on the lower
    # triangle: a (sequence, chunk, head)'s dy x^T and M^T dy (P deep), W^T C
    # and W B (N deep), dS B, x dS, dy S and the two state recurrences (P N
    # each a token); a (sequence, chunk)'s C B^T
    ssd_flops = b * chunks * (h * (4 * tri * p + 4 * tri * n + 10 * q * p * n) + 2 * tri * n)
    ssets = copies(lambda: (lambda x, dt, a, bc, dy: (x, dt, a, bc[..., :n], bc[..., n:2 * n], dy))(
        *ssd_in(b, L, h, p, n, bf16)), ssd_bytes)
    b_ms, b_by = bound(ssd_bytes, ssd_flops, BF16_FLOP_PER_S)
    # the design's own floor: the states, each chunk's S and dS (32 KB a
    # slot: float32, or bf16 hi + lo) written once by the states pass and
    # read once by the chunk kernel
    state_bytes = 2 * 2 * 4 * b * h * chunks * ss.SLOT

    def scan_pass(mask):
        return lambda *a: ssd_scan_backward(*a, passes=mask)

    scan = dict(ms=timed(ssd_scan_backward, ssets, iters=10),
                plain_ms=timed(backward_only, [with_graph(
                    lambda *t: ssd_scan_plain(*t)[0], *ssets[0][:5])], iters=2),
                library_ms=None, library="none: no single PyTorch call computes this function",
                bound_ms=b_ms, bound_by=b_by, bytes=ssd_bytes, flops=ssd_flops,
                state_bytes=state_bytes, state_floor_ms=state_bytes / HBM_BYTES_PER_S * 1e3,
                # each launch alone, by CUDA events (the chunk kernel and da
                # read the scratch the last whole call left)
                parts={name: dict(ms=timed(scan_pass(mask), ssets, iters=10)) for name, mask in (
                    ("ssd_bwd_states_kernel", ss.STATES_PASS),
                    ("ssd_bwd_chunk_mma_kernel", ss.CHUNK_PASS),
                    ("ssd_bwd_da_kernel", ss.DA_PASS))})
    emit("train_kernel_time", kernel="ssd_scan backward",
         shape=f"B{b} L{L} H{h} P{p} N{n} bf16, b and c strided", card=smi, **scan)
    del ssets
    rows.append(("ssd_scan_bwd", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:69", scan))

    lead, h, p = ((2, 4096), 32, 64) if full else ((4, 8), 4, 8)
    n, dn = lead[0] * lead[1], h * p
    # reads y, xh, z and g, writes dy, dxh and dz; w, d_skip, dw, dd_skip
    gate_bytes = 7 * 2 * n * dn + 2 * 4 * dn + 2 * 4 * h
    gsets = copies(lambda: (lambda y, xh, d, xz, w, g: (y, xh, d, torch.chunk(xz, 2, dim=-1)[1],
                                                        w, g))(*gate_in(lead, h, p, bf16)),
                   gate_bytes)
    b_ms, b_by = bound(gate_bytes, 30 * n * dn, F32_FLOP_PER_S)

    def gate_pass(mask):
        return lambda *a: rmsnorm_gated_backward(*a, passes=mask)

    gate = dict(ms=timed(rmsnorm_gated_backward, gsets),
                plain_ms=timed(backward_only, [with_graph(rmsnorm_gated_plain, *t[:5])
                                               for t in gsets]),
                library_ms=None, library="none: no single PyTorch call computes this function",
                bound_ms=b_ms, bound_by=b_by, bytes=gate_bytes,
                plan=rn.norm_bwd_plan(n, dn, 2, aligned=True, card=rn.card_of(0) if
                                      device == "cuda" else rn.Card(132, 2048, 65536),
                                      gated=True)._asdict(),
                parts={name: dict(ms=timed(gate_pass(mask), gsets)) for name, mask in (
                    ("rmsnorm_gated_bwd_rows_kernel", rn.GATED_ROWS_PASS),
                    ("rmsnorm_gated_tail_kernel", rn.GATED_TAIL_PASS))})
    emit("train_kernel_time", kernel="rmsnorm_gated backward",
         shape=f"({n}, {dn}) bf16, H{h} P{p}, z rows {2 * dn} apart", card=smi, **gate)
    del gsets
    rows.append(("rmsnorm_gated_bwd", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                 "src/repro/kernels/rmsnorm.py:18", gate))
    if device == "cuda":
        torch.cuda.empty_cache()

    # -- jamba-1.5-large's shapes (phase 16): checked, then timed ------------
    # flash causal at its prefill bucket (B8 S512 H64 KV8 D128, GQA 8); the
    # scan at one sequence of 4096 over its 256 heads of 64 (N 128); the
    # gated norm over 4096 rows of width 16384; in bf16 and float32 against
    # the plain versions' autograd, then each timed in bf16 beside its bound,
    # its plain version's autograd and the library's (SDPA's backward)
    jh, jkv, jd = 64, 8, 128
    mh, mp, mn = jamba_mamba_shape()
    jb, js, sb, sl, glead = 8, 512, 1, 4096, (1, 4096)
    for dtype in (bf16, f32):
        q, k, v, do = (randn(jb, js, jh, jd, dtype=dtype), randn(jb, js, jkv, jd, dtype=dtype),
                       randn(jb, js, jkv, jd, dtype=dtype), randn(jb, js, jh, jd, dtype=dtype))
        got = grads(flash_attention, (q, k, v), do)
        want = grads(flash_attention_plain, (q, k, v), do)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            check_grad("flash_attention_bwd", f"jamba B{jb} S{js} H{jh} KV{jkv} D{jd} causal "
                       f"{dtype}: {name}", g, w, dtype)
        del q, k, v, do, got, want
        x, dt, a, bc, dy = ssd_in(sb, sl, mh, mp, mn, dtype)
        got = ssd_grads(ssd_scan, x, dt, a, bc, dy)
        want = ssd_grads(ssd_scan_plain, x, dt, a, bc, dy)
        for name, g, w in zip(("dx", "ddt", "da", "d(b, c) projection"), got, want):
            check_grad("ssd_scan_bwd", f"jamba B{sb} L{sl} H{mh} P{mp} N{mn} {dtype}, b and c "
                       f"strided: {name}", g, w, dtype, VANISHING_GRAD)
        del x, dt, a, bc, dy, got, want
        y, xh, d, xz, w, g = gate_in(glead, mh, mp, dtype)
        got = gate_grads(rmsnorm_gated, y, xh, d, xz, w, g)
        want = gate_grads(rmsnorm_gated_plain, y, xh, d, xz, w, g)
        for name, a_, b_ in zip(("dy", "dxh", "dd_skip", "d(x, z) projection", "dw"), got, want):
            check_grad("rmsnorm_gated_bwd", f"jamba {glead} H{mh} P{mp} {dtype}, z rows "
                       f"{2 * mh * mp} apart: {name}", a_, b_, dtype)
        del y, xh, d, xz, w, g, got, want
        if device == "cuda":
            torch.cuda.empty_cache()

    def bwd_row(name):
        return next(t for n_, _, _, t in rows if n_ == name)

    live = jb * jh * js * (js + 1) // 2
    qkv_bytes = 2 * (jb * js * jh * jd + 2 * jb * js * jkv * jd)
    sets = copies(lambda: (randn(jb, js, jh, jd), randn(jb, js, jkv, jd), randn(jb, js, jkv, jd)),
                  qkv_bytes)
    bwd_sets = []
    for q, k, v in sets:
        o, lse = flash_attention_forward(q, k, v, with_lse=True)
        bwd_sets.append((q, k, v, o, randn(jb, js, jh, jd), lse))
    b_ms, b_by = bound(2 * qkv_bytes + 2 * 2 * jb * js * jh * jd + 4 * jb * jh * js, 10 * jd * live,
                       BF16_FLOP_PER_S)
    bwd_row("flash_attention_bwd")["hybrid_shapes"] = {
        f"jamba B{jb} S{js} H{jh} KV{jkv} D{jd} causal": dict(
            ms=timed(flash_attention_backward, bwd_sets, iters=5),
            plain_ms=timed(backward_only, [with_graph(flash_attention_plain, *sets[0])],
                           iters=2),
            library_ms=timed(backward_only, [with_graph(sdpa, *t) for t in sets], iters=5),
            bound_ms=b_ms, bound_by=b_by,
            plan=fa.bwd_plan(jb, js, js, jh, jkv, jd, bf16=True, aligned=True)._asdict())}
    del sets, bwd_sets
    chunks, q_ = -(-sl // ss.CHUNK), ss.CHUNK
    tri = q_ * (q_ + 1) // 2
    sbytes = 3 * 2 * sb * sl * mh * mp + 4 * 2 * sb * sl * mn + 2 * 4 * sb * sl * mh + 2 * 4 * mh
    sflops = sb * chunks * (mh * (4 * tri * mp + 4 * tri * mn + 10 * q_ * mp * mn) + 2 * tri * mn)
    ssets = copies(lambda: (lambda x, dt, a, bc, dy: (x, dt, a, bc[..., :mn], bc[..., mn:2 * mn],
                                                      dy))(*ssd_in(sb, sl, mh, mp, mn, bf16)),
                   sbytes)
    b_ms, b_by = bound(sbytes, sflops, BF16_FLOP_PER_S)
    bwd_row("ssd_scan_bwd")["hybrid_shapes"] = {f"jamba B{sb} L{sl} H{mh} P{mp} N{mn}": dict(
        ms=timed(ssd_scan_backward, ssets, iters=5),
        plain_ms=timed(backward_only, [with_graph(lambda *t: ssd_scan_plain(*t)[0],
                                                  *ssets[0][:5])], iters=2),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=sbytes, flops=sflops)}
    del ssets
    n, dn = glead[0] * glead[1], mh * mp
    gbytes = 7 * 2 * n * dn + 2 * 4 * dn + 2 * 4 * mh
    gsets = copies(lambda: (lambda y, xh, d, xz, w, g: (y, xh, d, torch.chunk(xz, 2, dim=-1)[1],
                                                        w, g))(*gate_in(glead, mh, mp, bf16)),
                   gbytes)
    b_ms, b_by = bound(gbytes, 30 * n * dn, F32_FLOP_PER_S)
    bwd_row("rmsnorm_gated_bwd")["hybrid_shapes"] = {f"jamba ({n}, {dn})": dict(
        ms=timed(rmsnorm_gated_backward, gsets),
        plain_ms=timed(backward_only, [with_graph(rmsnorm_gated_plain, *t[:5]) for t in gsets]),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=gbytes)}
    del gsets
    emit("train_kernel_time_hybrid", card=smi, **{k: bwd_row(k)["hybrid_shapes"] for k in (
        "flash_attention_bwd", "ssd_scan_bwd", "rmsnorm_gated_bwd")})
    if device == "cuda":
        torch.cuda.empty_cache()

    # -- the cluster kernels: gradient rows past the row kernels -------------
    # the plain gradient at (8192, D), D 5120 (the llama4 decoders), 6144
    # (nemotron-4-15b, internvl2-26b), 7168 (deepseek-coder-33b) and 8192
    # (jamba), and jamba's gated gradient (16384) at 8 and 4096 rows: each
    # checked in bf16 and float32 against the plain version's autograd (the
    # kernel named by the plan's route) and called twice through autograd and
    # compared bitwise; then timed in bf16 beside the wide kernels they
    # replace (``wide_ms``: the plans forced to them, in the same call), the
    # bound, the plain version's autograd, ``F.rms_norm``'s backward (the
    # plain gradient) and an empty kernel on the cluster grid
    card = rn.card_of(0) if device == "cuda" else rn.Card(132, 2048, 65536)
    wn, wide_widths = (8192, (5120, 6144, 7168, 8192)) if full else (16, (1056,))
    g_rows = (8, 4096) if full else (8, 40)

    def routed(base, plan):
        return f"{base}_cluster" if plan.cluster else base

    def wide_ms(fn, sets):
        """``fn``'s ms with the plans forced to the wide kernels."""
        with wide_plans():
            return timed(fn, sets)

    twice = []
    for dtype in (bf16, f32):
        elem = 2 if dtype == bf16 else 4
        for d_ in wide_widths:
            x, w, g = randn(wn, d_, dtype=dtype), 1.0 + 0.1 * randn(d_, dtype=f32), \
                randn(wn, d_, dtype=dtype)
            kernel = routed("rmsnorm_bwd", rn.norm_bwd_plan(wn, d_, elem, aligned=True,
                                                            card=card))
            got, want = grads(rmsnorm, (x, w), g), grads(rmsnorm_plain, (x, w), g)
            for name, a_, b_ in zip(("dx", "dw"), got, want):
                check_grad(kernel, f"({wn}, {d_}) {dtype}: {name}", a_, b_, dtype)
            twice.append((f"{kernel} ({wn}, {d_}) {dtype}", all(
                torch.equal(u, v) for u, v in zip(got, grads(rmsnorm, (x, w), g)))))
            del x, w, g, got, want
        for n_rows in g_rows:
            y, xh, d, xz, w, g = gate_in((n_rows,), mh, mp, dtype)
            kernel = routed("rmsnorm_gated_bwd", rn.norm_bwd_plan(
                n_rows, mh * mp, elem, aligned=True, card=card, gated=True))
            got = gate_grads(rmsnorm_gated, y, xh, d, xz, w, g)
            want = gate_grads(rmsnorm_gated_plain, y, xh, d, xz, w, g)
            for name, a_, b_ in zip(("dy", "dxh", "dd_skip", "d(x, z) projection", "dw"), got,
                                    want):
                check_grad(kernel, f"jamba ({n_rows}, {mh * mp}) H{mh} P{mp} {dtype}, z rows "
                           f"{2 * mh * mp} apart: {name}", a_, b_, dtype)
            twice.append((f"{kernel} jamba ({n_rows}, {mh * mp}) {dtype}", all(
                torch.equal(u, v) for u, v in zip(got, gate_grads(rmsnorm_gated, y, xh, d, xz,
                                                                  w, g)))))
            del y, xh, d, xz, w, g, got, want
        if device == "cuda":
            torch.cuda.empty_cache()
    emit("train_bitwise_cluster", cases=dict(twice), ok=all(v for _, v in twice),
         what="each gradient through autograd twice on the same inputs")
    if not all(v for _, v in twice):
        raise AssertionError(f"a gradient gave other bits on a second call: "
                             f"{[k for k, v in twice if not v]}")

    by_shape = {}
    for d_ in wide_widths:
        nbytes = 3 * 2 * wn * d_ + 2 * 4 * d_        # x, g read, dx written; w read, dw written
        sets = copies(lambda: (randn(wn, d_), 1.0 + 0.1 * randn(d_, dtype=f32), randn(wn, d_)),
                      nbytes)
        plan = rn.norm_bwd_plan(wn, d_, 2, aligned=True, card=card)
        b_ms, b_by = bound(nbytes, 10 * wn * d_, F32_FLOP_PER_S)
        by_shape[f"({wn}, {d_})"] = dict(
            ms=timed(rmsnorm_backward, sets), wide_ms=wide_ms(rmsnorm_backward, sets),
            plain_ms=timed(backward_only, [with_graph(rmsnorm_plain, x, w)
                                           for x, w, _ in sets[:2]], iters=4),
            library_ms=timed(backward_only, [with_graph(
                lambda x_, w_: F.rms_norm(x_, (d_,), w_, 1e-5), x, w.to(bf16))
                for x, w, _ in sets]),
            floor_ms=timed(lambda *_: rn.launch_floor(plan), sets) if device == "cuda" else 0.0,
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, plan=plan._asdict(),
            clusters=(rn.clusters_launched(plan, 2, gated=False, backward=True)
                      if device == "cuda" else None))
        del sets
    emit("train_kernel_time_cluster", kernel="rmsnorm backward", card=smi, shapes=by_shape)
    rows.append(("rmsnorm_bwd_cluster", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                 "src/repro/kernels/rmsnorm.py:18",
                 dict(by_shape[f"({wn}, {wide_widths[-1]})"], by_shape=by_shape)))

    g_by_shape = {}
    for n_rows in g_rows:
        dn = mh * mp
        # y, xh, z, g read, dy, dxh, dz written; w, d_skip read, dw, dd_skip written
        nbytes = 7 * 2 * n_rows * dn + 2 * 4 * dn + 2 * 4 * mh
        sets = copies(lambda: (lambda y, xh, d, xz, w, g: (
            y, xh, d, torch.chunk(xz, 2, dim=-1)[1], w, g))(*gate_in((n_rows,), mh, mp, bf16)),
            nbytes)
        plan = rn.norm_bwd_plan(n_rows, dn, 2, aligned=True, card=card, gated=True)
        b_ms, b_by = bound(nbytes, 30 * n_rows * dn, F32_FLOP_PER_S)
        g_by_shape[f"jamba ({n_rows}, {dn})"] = dict(
            ms=timed(rmsnorm_gated_backward, sets),
            wide_ms=wide_ms(rmsnorm_gated_backward, sets),
            plain_ms=timed(backward_only, [with_graph(rmsnorm_gated_plain, *t[:5])
                                           for t in sets[:2]], iters=4),
            library_ms=None, library="none: no single PyTorch call computes this function",
            floor_ms=timed(lambda *_: rn.launch_floor(plan), sets) if device == "cuda" else 0.0,
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, plan=plan._asdict(),
            clusters=(rn.clusters_launched(plan, 2, gated=True, backward=True)
                      if device == "cuda" else None),
            parts={name: dict(ms=timed(gate_pass(mask), sets)) for name, mask in (
                ("rmsnorm_gated_bwd_cluster_kernel", rn.GATED_ROWS_PASS),
                ("rmsnorm_gated_tail_kernel", rn.GATED_TAIL_PASS))})
        del sets
    emit("train_kernel_time_cluster", kernel="rmsnorm_gated backward", card=smi,
         shapes=g_by_shape)
    head = g_by_shape[f"jamba ({g_rows[-1]}, {mh * mp})"]
    rows.append(("rmsnorm_gated_bwd_cluster", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                 "src/repro/kernels/rmsnorm.py:18", dict(head, by_shape=g_by_shape)))
    if device == "cuda":
        torch.cuda.empty_cache()

    # -- one train step at full width: kernel route against impl="ref" -----
    qwen, mamba = get_config("qwen2.5-3b"), get_config("mamba2-370m")
    ab_seq = 1024 if full else 32

    def one_step(cfg, impl, batch, kernels):
        model = lm.init_params(cfg, device=dev, param_dtype=f32,
                               generator=torch.Generator(device=dev).manual_seed(0))
        opt, step_fn = make_train_step(cfg, grad_accum=2, impl=impl, warmup=1)
        state = opt.init(dict(model.named_parameters()))
        # kernels launch on the card only (a rehearsal on the CPU runs the
        # plain versions)
        metrics, rec = counted(lambda: step_fn(model, state, 0, batch), kernels,
                               require=True if impl is None and device == "cuda" else ())
        norms = {k: float(p.grad.norm()) for k, p in model.named_parameters()}
        return float(metrics["loss"]), norms, rec

    def rel_diffs(loss, norms, loss_r, norms_r):
        rel = {k: abs(norms[k] - norms_r[k]) / max(norms_r[k], 1e-30) for k in norms_r}
        worst = max(rel, key=rel.get)
        return abs(loss - loss_r) / abs(loss_r), worst, rel[worst], len(rel)

    def scan_chunk_64(fn):
        """``fn()`` with the oracle's scan at chunk 64 instead of 128: a
        change of summation order alone."""
        ssd = ops.ssd
        ops.ssd = lambda *a, impl=None, chunk=128: ssd(*a, impl=impl, chunk=64)
        try:
            return fn()
        finally:
            ops.ssd = ssd

    for base, kset in ((qwen, kernels), (mamba, mamba_kernels)):
        ab_cfg = dataclasses.replace(base, n_layers=2) if full else base.reduced()
        for dt in ("float32", "bfloat16"):
            cfg = dataclasses.replace(ab_cfg, compute_dtype=dt)
            pipe = make_pipeline("bigram", cfg, ShapeCfg("ab", ab_seq, 4, "train"), seed=3,
                                 accum=2)
            batch = {k: torch.from_numpy(v).to(dev, torch.long)
                     for k, v in pipe.host_batch(pipe.init_state()).items()}
            loss_k, norms_k, rec_k = one_step(cfg, None, batch, kset)
            loss_r, norms_r, rec_r = one_step(cfg, "ref", batch, kset)
            if any(rec_r["launches"].values()):
                raise AssertionError(f"the impl='ref' step launched kernels: {rec_r['launches']}")
            loss_rel, worst, worst_rel, leaves = rel_diffs(loss_k, norms_k, loss_r, norms_r)
            # mamba2-370m: the oracle against itself with its scan's chunk
            # halved, the spread a change of summation order alone gives
            extra = {}
            if cfg.mamba is not None:
                loss_o, norms_o, _ = scan_chunk_64(lambda: one_step(cfg, "ref", batch, kset))
                o_loss, o_worst, o_rel, _ = rel_diffs(loss_o, norms_o, loss_r, norms_r)
                extra = dict(order_only=dict(what="impl='ref' with its scan at chunk 64 vs 128",
                                             loss_rel_diff=o_loss, worst_grad_norm_leaf=o_worst,
                                             worst_grad_norm_rel_diff=o_rel))
            tol = TRAIN_AB_TOL[dt]
            ok = loss_rel <= tol and worst_rel <= tol
            emit("train_ab", config=f"{cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
                 f"d_ff {cfg.d_ff}, vocab {cfg.vocab}", compute_dtype=dt, seq=ab_seq,
                 global_batch=4, grad_accum=2, loss_kernels=loss_k, loss_ref=loss_r,
                 loss_rel_diff=loss_rel, worst_grad_norm_leaf=worst,
                 worst_grad_norm_rel_diff=worst_rel, tolerance=tol, leaves=leaves,
                 launches_kernels=rec_k["launches"], kernel_step_s=rec_k["wall_s"],
                 ref_step_s=rec_r["wall_s"], ok=ok, **extra)
            if not ok:
                raise AssertionError(f"train step of {cfg.name}, {dt}: kernel route and "
                                     f"impl='ref' differ (loss {loss_k} vs {loss_r}; {worst} "
                                     f"{worst_rel})")
            del batch
        if device == "cuda":
            torch.cuda.empty_cache()

    # -- each model at full width and depth through train_loop --------------
    def full_run(cfg, kernels, plain_fns):
        """6 steps of `train_loop`: a warm-up, 4 timed with the launch counts
        set to 0 just before them and read just after and the plain
        versions counted, then one profiled.  Emits the ``train`` and
        ``train_profile`` records; returns the timed steps' launches."""
        seq, gbatch, accum = (4096, 8, 4) if full else (32, 4, 2)
        plain_calls = {}
        originals = {(m, a): getattr(m, a) for m, a in plain_fns}

        def counting(name, fn):
            def wrapped(*a, **kw):
                plain_calls[name] = plain_calls.get(name, 0) + 1
                return fn(*a, **kw)
            return wrapped

        timed_launches, prof_box = {}, {}

        def on_metrics(rec):
            if rec["step"] == 0:                     # the warm-up step is done
                if device == "cuda":
                    torch.cuda.synchronize()
                for k_ in kernels.values():
                    k_.launches = 0
                for m, a in plain_fns:
                    setattr(m, a, counting(a, originals[(m, a)]))
            elif rec["step"] == 4:                   # the 4 timed steps are done
                timed_launches.update({name: k_.launches for name, k_ in kernels.items()})
                for m, a in plain_fns:
                    setattr(m, a, originals[(m, a)])
                act = [torch.profiler.ProfilerActivity.CUDA if device == "cuda"
                       else torch.profiler.ProfilerActivity.CPU]
                prof_box["p"] = torch.profiler.profile(activities=act)
                prof_box["p"].start()
            elif rec["step"] == 5:
                prof_box["p"].stop()

        resident = 0
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
        loop = TrainLoopConfig(steps=6, seq_len=seq, global_batch=gbatch, grad_accum=accum,
                               lr=3e-4, warmup=2, log_interval=1, seed=0, data_kind="bigram",
                               on_metrics=on_metrics)
        try:
            t0 = time.perf_counter()
            summary = train_loop(cfg, loop, device=device)
            loop_s = time.perf_counter() - t0
        finally:
            for m, a in plain_fns:
                setattr(m, a, originals[(m, a)])
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
        n_params = sum(p.numel() for p in summary.model.parameters())
        # the lookup is no product; a tied embedding is also the head, which is one
        n_matmul = n_params - (0 if cfg.tie_embeddings else summary.model.embed.numel())
        tokens = seq * gbatch
        flops = 6 * n_matmul * tokens
        if cfg.attn is not None:
            live_pairs = seq * (seq + 1) // 2
            flops += 12 * cfg.attn.head_dim * cfg.attn.n_heads * cfg.n_layers * live_pairs * gbatch
        losses = [summary.losses[i] for i in range(6)]
        step_s = [summary.step_seconds[i] for i in range(6)]
        timed_s = step_s[1:5]
        prof = prof_box["p"]
        kern = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        busy_s = sum(e.device_time_total for e in kern) / 1e6
        top = sorted(kern, key=lambda e: e.device_time_total, reverse=True)[:10]
        median_s = sorted(timed_s)[len(timed_s) // 2]
        emit("train", config=f"{cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
             f"d_ff {cfg.d_ff}, vocab {cfg.vocab}", params=n_params, optimizer=cfg.optimizer,
             param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype, remat=cfg.remat,
             data="bigram", seq=seq, global_batch=gbatch, grad_accum=accum,
             cuts=["global batch 8, not train_4k's 256"], losses=losses, step_s=step_s,
             warmup_step_s=step_s[0], timed_steps=4, timed_step_s_median=median_s,
             tok_per_s=tokens / median_s, model_flops_per_step=flops,
             model_flops="6 N tokens" + (" + attention's 12 d H layers live pairs" if cfg.attn
                                         else "; the SSD scan's own products not counted"),
             model_flop_per_s=flops / median_s,
             bf16_peak_share=flops / median_s / BF16_FLOP_PER_S,
             max_memory_allocated=peak, peak_over_resident=peak - resident if peak else None,
             loop_s=loop_s, launches_timed_steps=timed_launches,
             plain_calls_timed_steps=plain_calls, card=smi)
        emit("train_profile", what=f"train step 5 of {cfg.name}", wall_s=step_s[5],
             device_busy_s=busy_s, device_idle_share=max(0.0, 1 - busy_s / step_s[5]),
             kernel_launches=sum(e.count for e in kern),
             top_kernels=[{"name": e.key[:90], "ms": e.device_time_total / 1e3,
                           "calls": e.count} for e in top], card=smi)
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"non-finite training loss of {cfg.name}: {losses}")
        missing = [k_ for k_, n_ in timed_launches.items() if n_ == 0]
        if device == "cuda" and (missing or plain_calls):
            raise AssertionError(f"{cfg.name}: the timed steps launched no {missing} kernel, "
                                 f"or called a plain version: {plain_calls}")
        del summary, prof, prof_box
        if device == "cuda":
            torch.cuda.empty_cache()
        return timed_launches

    qwen_launches = full_run(qwen if full else qwen.reduced(), kernels,
                             [(fa, "flash_attention_plain"), (rn, "rmsnorm_plain"),
                              (ref, "mha_reference"), (ref, "rmsnorm_reference")])
    mamba_launches = full_run(mamba if full else mamba.reduced(), mamba_kernels,
                              [(ss, "ssd_scan_plain"), (ss, "ssd_chunked_backward"),
                               (ref, "ssd_chunked"), (rn, "rmsnorm_gated_plain"),
                               (rn, "rmsnorm_gated_backward_plain"), (rn, "rmsnorm_plain"),
                               (ref, "rmsnorm_reference")])
    timed_launches = dict(qwen_launches, **{k: mamba_launches[k] for k in (
        "ssd_scan", "ssd_scan_bwd", "rmsnorm_gated", "rmsnorm_gated_bwd")})

    # -- a crash and restart, bitwise ----------------------------------------
    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    base = dict(steps=6, seq_len=64 if full else 16, global_batch=4, grad_accum=2,
                ckpt_interval=2, log_interval=1, warmup=2, lr=1e-3, seed=0)
    small = qwen.reduced()
    try:
        clean = train_loop(small, TrainLoopConfig(**base, ckpt_dir=str(root / "clean")),
                           device=device)
        failed = run_resilient(small, TrainLoopConfig(**base, ckpt_dir=str(root / "crash"),
                                                      failures=FailureInjector({3: "crash"})),
                               max_restarts=1, device=device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = dict(clean.model.named_parameters())
    got = dict(failed["summaries"][-1].model.named_parameters())
    differ = [k_ for k_ in want if not torch.equal(want[k_], got[k_])]
    emit("train_drill", config=small.name, steps=6, ckpt_interval=2, crash_at=3,
         restarts=failed["restarts"], restored_from=failed["summaries"][-1].restored_from,
         losses_clean=[clean.losses[i] for i in range(6)],
         losses_crashed={int(k_): v for k_, v in failed["losses"].items()},
         leaves=len(want), leaves_differing=len(differ), first_differing_leaf=(
             differ[0] if differ else None), bitwise_equal=not differ)
    if differ or failed["restarts"] != 1:
        raise AssertionError(f"the restarted run's parameters differ from the uninterrupted "
                             f"run's, first at {differ[:1]} ({len(differ)} leaves)")
    return rows, timed_launches


def pipelined_training(smi):
    """Phase 13: training through the port's microbatch pipeline
    (`LMPipeline`), the plan from the port's planner on a training shape
    (B 8) priced on the H100 with every slice on the one card.
    qwen2.5-3b at full width and depth, 9 layers a stage (embed, four
    block stages, head), float32 masters, bf16 activations, 8 microbatches
    of (1, 1024) tokens drawn from a seed, the loss a float32 mean of the
    logits' squares: the sequential oracle (`LMPipeline.sequential`),
    1F1B overlapped, 1F1B with ``overlap=False``, interleaved 1F1B (2
    programs x 3 chunks) and a fill-drain serve; mamba2-370m at full width
    and depth, 12 layers a stage, 8 microbatches of (1, 2048): the oracle
    and 1F1B overlapped.  Every run is warmed first (``warm``) and
    counted: the launch counts set to 0 just before it and read just
    after, each plain version counted; every kernel of its path must
    launch, no plain version be called, no program run a first call
    inside it (``late == 0``) and, overlapped, more than one stream run
    ops.  Gradients and losses of every schedule bitwise the oracle's, the
    serve's logits bitwise ``reference()``'s.  Printed: tok/s and wall
    seconds of each run beside the oracle's, stage inverse and host µs,
    ``max_inflight``, peak memory over resident, the bubble measured
    beside ``interleaved_bubble``, `compare_lm`'s per-stage ratios, the
    device idle share of one more profiled 1F1B run; after ``close()``,
    memory must be back within 64 MB of where it was before the pipeline
    was built.  Then a 2-layer full-width qwen2.5-3b pipeline, kernel
    route against ``impl="ref"`` on shared weights: the losses and each
    leaf's gradient norm within phase 10's bf16 A/B tolerance.  Returns the
    launches of qwen2.5-3b's 1F1B run, with mamba2-370m's for the scan
    and the gated norm."""
    import numpy as np
    import torch

    from repro_torch import bridge
    from repro_torch.analysis.roofline import HW_H100
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import planner
    from repro_torch.graphs import lm_graph
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_backward
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_backward, rmsnorm_gated,
                                             rmsnorm_gated_backward)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_backward
    from repro_torch.probes.busy import kernel_busy
    from repro_torch.runtime.pipeline import (LMPipeline, build_lm_stages, compare_lm,
                                              interleaved_1f1b, interleaved_bubble,
                                              measured_bubble, selection_from_plan)

    qwen_kernels = {"flash_attention": flash_attention,
                    "flash_attention_bwd": flash_attention_backward,
                    "rmsnorm": rmsnorm, "rmsnorm_bwd": rmsnorm_backward}
    mamba_kernels = {"rmsnorm": rmsnorm, "rmsnorm_bwd": rmsnorm_backward,
                     "ssd_scan": ssd_scan, "ssd_scan_bwd": ssd_scan_backward,
                     "rmsnorm_gated": rmsnorm_gated,
                     "rmsnorm_gated_bwd": rmsnorm_gated_backward}
    qwen_plain = [(fa, "flash_attention_plain"), (rn, "rmsnorm_plain"),
                  (ref, "mha_reference"), (ref, "rmsnorm_reference")]
    mamba_plain = [(ss, "ssd_scan_plain"), (ss, "ssd_chunked_backward"), (ref, "ssd_chunked"),
                   (rn, "rmsnorm_gated_plain"), (rn, "rmsnorm_gated_backward_plain"),
                   (rn, "rmsnorm_plain"), (ref, "rmsnorm_reference")]

    def loss_fn(lg):
        return torch.mean(lg.float() ** 2)

    def allocated():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    def counted_run(fn, kernels, plain_fns, need):
        """``fn()`` once, the launch counts set to 0 just before it and read
        just after, each plain version counted, the peak-memory mark
        reset: (its result, a record).  On the card every kernel of
        ``need`` must launch and no plain version be called."""
        calls, originals = {}, {(m, a): getattr(m, a) for m, a in plain_fns}

        def counting(name, f):
            def wrapped(*a, **kw):
                calls[name] = calls.get(name, 0) + 1
                return f(*a, **kw)
            return wrapped

        for k in kernels.values():
            k.launches = 0
        resident = allocated()
        stats0 = torch.cuda.memory_stats()
        torch.cuda.reset_peak_memory_stats()
        for m, a in plain_fns:
            setattr(m, a, counting(a, originals[(m, a)]))
        t0 = time.perf_counter()
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            for m, a in plain_fns:
                setattr(m, a, originals[(m, a)])
        peak = torch.cuda.max_memory_allocated()
        stats = torch.cuda.memory_stats()
        rec = dict(call_s=time.perf_counter() - t0,
                   launches={n: k.launches for n, k in kernels.items()}, plain_calls=calls,
                   max_memory_allocated=peak, peak_over_resident=peak - resident,
                   reserved=torch.cuda.memory_reserved(),
                   # the caching allocator meanwhile: flushes of its cache
                   # (each a sync of every stream), device mallocs and frees
                   allocator={k: stats.get(k, 0) - stats0.get(k, 0) for k in (
                       "num_alloc_retries", "num_device_alloc", "num_device_free")})
        missing = [n for n in need if rec["launches"][n] == 0]
        if missing or calls:
            raise AssertionError(f"a pipelined run launched no {missing} kernel or called "
                                 f"a plain version: {calls}")
        return out, rec

    def host_copy(grads):
        """The oracle's gradients in pinned host memory: the card holds one
        run's gradients beside the masters, not two."""
        out = {}
        for n, t in grads.items():
            out[n] = {}
            for k, v in bridge.flat_tree(t).items():
                out[n][k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                out[n][k].copy_(v)
        return out

    def differing(grads, want):
        """The leaves of ``grads`` not bitwise ``want``'s, each compared on
        the card against its host copy brought back."""
        return [f"{n}.{k}" for n, t in grads.items() for k, v in bridge.flat_tree(t).items()
                if not torch.equal(v, want[n][k].to(v.device, non_blocking=True))]

    def one_model(name, lps, seq, runs, kernels, plain_fns):
        cfg = get_config(name)
        shape = ShapeCfg("train_pipe", seq, 8, "train")
        t0 = time.perf_counter()
        plan = planner.plan(cfg, shape, chips=1, hw=HW_H100, max_tp=1)
        stg, _ = lm_graph.build_stg(cfg, shape, hw=HW_H100, max_tp=1)
        plan_s = time.perf_counter() - t0
        rng = np.random.default_rng(2024)
        mbs = [rng.integers(0, cfg.vocab, (1, seq)).astype(np.int32) for _ in range(8)]
        gc.collect()
        before = allocated()
        pipe = LMPipeline(cfg, stg, plan, layers_per_stage=lps, device="cuda")
        weights = allocated() - before
        head = dict(config=f"{cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
                           f"d_ff {cfg.d_ff}, vocab {cfg.vocab}",
                    layers_per_stage=lps, stages=[st.name for st in pipe.stages],
                    replicas=[len(st.devices) for st in pipe.stages], microbatches=8,
                    microbatch=[1, seq], card=smi)
        emit("pipe_train_plan", **head, plan=plan.summary().splitlines()[0], plan_s=plan_s,
             weights_bytes=weights)
        pipe.sequential(mbs[:1], loss_fn=loss_fn)      # the oracle's first calls
        (grads, losses), rec = counted_run(lambda: pipe.sequential(mbs, loss_fn=loss_fn),
                                           kernels, plain_fns, kernels)
        want, want_losses, oracle_s = host_copy(grads), losses, rec["call_s"]
        del grads
        emit("pipe_train_run", **head, run="sequential oracle", **rec,
             tok_per_s=8 * seq / rec["call_s"])
        launches = None
        for label, kw in runs:
            train = kw.get("train", False)
            overlap = kw.get("overlap", True)
            pipe.warm(mbs, **kw)
            late0 = pipe.compile_stats.late
            res, rec = counted_run(lambda: pipe.run(mbs, **kw), kernels, plain_fns,
                                   [k for k in kernels if train or not k.endswith("_bwd")])
            late = pipe.compile_stats.late - late0
            sched = kw.get("schedule")
            p, v = (sched.n_stages, sched.n_chunks) if sched else (pipe.n_stages, 1)
            out = dict(**head, run=label, **rec, wall_s=res.wall_s, lanes=pipe.lanes.n,
                       tok_per_s=res.tokens_per_s(seq), oracle_s=oracle_s,
                       max_inflight=res.max_inflight, streams_used=res.streams_used,
                       stage_inverse_us={n: res.stage_inverse_us(n) for n in res.stage_firings},
                       stage_host_us={n: res.stage_host_us(n) for n in res.stage_firings},
                       bubble_measured=measured_bubble(res),
                       bubble_model=interleaved_bubble(p, 8, v), late=late,
                       compile_stats=pipe.compile_stats.summary())
            if train:
                bad = differing(res.grads, want)
                out.update(grad_leaves_differing=len(bad), losses_equal=res.losses == want_losses)
                if bad or res.losses != want_losses:
                    raise AssertionError(f"{cfg.name} {label}: gradients {bad[:3]} ({len(bad)} "
                                         f"leaves) or losses differ from the sequential oracle")
            else:
                outs = pipe.reference(mbs)
                same = all(torch.equal(a, b) for a, b in zip(res.outputs, outs))
                out.update(outputs_equal_reference=same)
                del outs
                if not same:
                    raise AssertionError(f"{cfg.name} {label}: logits differ from reference()")
            if label == "1f1b":
                launches = rec["launches"]
                out["compare_lm_ratios"] = compare_lm(
                    stg, selection_from_plan(plan), res,
                    stage_map=pipe.graph_stage_map()).ratios()
            emit("pipe_train_run", **out)
            if late:
                raise AssertionError(f"{cfg.name} {label}: {late} first calls inside the run")
            if overlap and res.streams_used < 2:
                raise AssertionError(f"{cfg.name} {label}: ops ran on {res.streams_used} "
                                     f"stream(s)")
            del res
        # one more 1F1B run, profiled: the device's busy time (the union of
        # kernel intervals over all streams) against the run's wall time
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            res = pipe.run(mbs, train=True, loss_fn=loss_fn)
            torch.cuda.synchronize()
        busy_ms, summed_ms, n_kern = kernel_busy(prof)
        emit("pipe_train_profile", **head, run="1f1b, profiled", wall_s=res.wall_s,
             device_busy_ms=busy_ms, kernel_ms_summed=summed_ms, kernels=n_kern,
             device_idle_share=(max(0.0, 1 - busy_ms / 1e3 / res.wall_s)
                                if busy_ms else None))
        del res, prof, want
        pipe.close()
        del pipe
        gc.collect()
        left = allocated() - before
        emit("pipe_train_close", **head, left_allocated=left)
        if left > 64 << 20:
            raise AssertionError(f"{cfg.name}: {left} bytes left allocated after close()")
        return launches

    train = dict(train=True, loss_fn=loss_fn)
    t0 = time.perf_counter()
    qwen = one_model("qwen2.5-3b", 9, 1024, [
        ("1f1b", train), ("1f1b, overlap=False", dict(train, overlap=False)),
        ("interleaved_1f1b(2, 8, 3)", dict(train, schedule=interleaved_1f1b(2, 8, 3))),
        ("fill_drain serve", {})], qwen_kernels, qwen_plain)
    qwen_s = time.perf_counter() - t0
    mamba = one_model("mamba2-370m", 12, 2048, [("1f1b", train)],
                      mamba_kernels, mamba_plain)
    mamba_s = time.perf_counter() - t0 - qwen_s

    # a 2-layer full-width qwen2.5-3b pipeline on shared weights, the kernel
    # route against impl="ref": losses and each leaf's gradient norm
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=2)
    shape = ShapeCfg("train_pipe_ab", 1024, 8, "train")
    plan = planner.plan(cfg, shape, chips=1, hw=HW_H100, max_tp=1)
    stg, _ = lm_graph.build_stg(cfg, shape, hw=HW_H100, max_tp=1)
    _, modules = build_lm_stages(cfg, device="cuda", seed=7)
    rng = np.random.default_rng(7)
    mbs = [rng.integers(0, cfg.vocab, (1, shape.seq_len)).astype(np.int32) for _ in range(4)]
    got = {}
    for impl in (None, "ref"):
        pipe = LMPipeline(cfg, stg, plan, params=modules, device="cuda", impl=impl)
        res, rec = counted_run(lambda: pipe.run(mbs, train=True, loss_fn=loss_fn),
                               qwen_kernels, [] if impl else qwen_plain,
                               qwen_kernels if impl is None else ())
        if impl == "ref" and any(rec["launches"].values()):
            raise AssertionError(f"the impl='ref' pipeline launched kernels: {rec['launches']}")
        got[impl] = (res.losses, {f"{n}.{k}": float(v.float().norm()) for n, t in
                                  res.grads.items() for k, v in bridge.flat_tree(t).items()})
        pipe.close()
        del pipe, res
    (lk, nk), (lr, nr) = got[None], got["ref"]
    loss_rel = max(abs(lk[m] - lr[m]) / abs(lr[m]) for m in lr)
    rel = {k: abs(nk[k] - nr[k]) / max(nr[k], 1e-30) for k in nr}
    worst = max(rel, key=rel.get)
    tol = TRAIN_AB_TOL["bfloat16"]
    emit("pipe_train_ab", config=f"{cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}",
         microbatches=4, microbatch=[1, shape.seq_len], loss_rel_diff=loss_rel,
         worst_grad_norm_leaf=worst, worst_grad_norm_rel_diff=rel[worst], tolerance=tol,
         leaves=len(rel), card=smi)
    if loss_rel > tol or rel[worst] > tol:
        raise AssertionError(f"pipelined {cfg.name}: kernel route and impl='ref' differ "
                             f"(loss {loss_rel}, {worst} {rel[worst]})")
    del modules
    gc.collect()
    emit("pipe_train_phase_parts", qwen_s=qwen_s, mamba_s=mamba_s,
         ab_s=time.perf_counter() - t0 - qwen_s - mamba_s)
    return dict(qwen, **{k: mamba[k] for k in ("ssd_scan", "ssd_scan_bwd", "rmsnorm_gated",
                                                "rmsnorm_gated_bwd")})


def stg_phase() -> None:
    """Phase 11: the paper's own STG path on this machine's host (Python,
    numpy and the scipy the ILP solves with).  JPEG planned with the
    heuristic and the ILP at v 4 under the calibrated router model, each
    selection materialised and streamed through the interpreter: its sink
    stream must equal `simulate.run_functional` and the materialised
    graph's, and `jpeg.reference_pipeline`, bitwise, and its measured
    inverse throughput `throughput.analyze`'s within 15%.  The same for
    StreamIt's FFT, filterbank and autocorrelation under the literal
    router model.  Then 1F1B and interleaved 1F1B simulated as data
    against their bubble models, and `verify_graph` on each committed
    graph.  Prints each part's seconds."""
    import numpy as np

    from repro_torch.core import heuristic, ilp, simulate, throughput, transform, verify
    from repro_torch.core.fork_join import JPEG_CALIBRATED, LITERAL
    from repro_torch.core.stg import Selection
    from repro_torch.graphs import jpeg, nbody, streamit
    from repro_torch.runtime.pipeline import (compare, execute, interleaved_1f1b,
                                              interleaved_bubble, one_f_one_b,
                                              simulate_schedule)

    def same(a, b) -> bool:
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            a, b = np.asarray(a), np.asarray(b)
            return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return type(a) is type(b) and a == b

    def streamed(name, g, src, sink, blocks, v_tgt, fj, reference=None):
        """Plan ``g`` with both solvers at ``v_tgt``; run each plan."""
        for solver in (heuristic, ilp):
            t0 = time.perf_counter()
            res = solver.min_area(g, v_tgt, fj)
            plan_s = time.perf_counter() - t0
            if not res.feasible:
                raise AssertionError(f"{name}: {solver.__name__} found no plan at v {v_tgt}")
            rg = transform.materialize(g, res.selection, fj)
            t0 = time.perf_counter()
            run = execute(g, res.selection, {src: blocks}, fj=fj)
            run_s = time.perf_counter() - t0
            want = simulate.run_functional(g, res.selection, {src: blocks})[sink]
            replicated = simulate.run_functional(rg.stg, rg.selection, {src: blocks})[sink]
            rep = compare(g, res.selection, run)
            v_app = throughput.analyze(g, res.selection).v_app
            ok = {"simulator": same(run.outputs[sink], want),
                  "materialised_graph": same(replicated, want),
                  "reference": reference is None or same(want, reference(blocks)),
                  "throughput": abs(rep.v_app_measured - v_app) <= 0.15 * v_app}
            emit("stg", graph=name, solver=solver.__name__.rsplit(".", 1)[1], v_tgt=v_tgt,
                 total_area=res.total_area, overhead_area=res.overhead_area,
                 replicas={n: nr for n, (_, nr) in res.selection.choices.items() if nr > 1},
                 tokens=len(blocks), sink_tokens=len(run.outputs[sink]),
                 v_app_analytic=v_app, v_app_measured=rep.v_app_measured,
                 cycles=run.cycles, plan_s=plan_s, execute_s=run_s, ok=ok)
            if not all(ok.values()):
                raise AssertionError(f"{name} under the {solver.__name__} plan: {ok}")

    t0 = time.perf_counter()
    streamed("jpeg", jpeg.build_stg(), "camera", "bitstream", jpeg.random_blocks(192), 4,
             JPEG_CALIBRATED, jpeg.reference_pipeline)
    jpeg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    for name, g, n_in in (("fft", streamit.build_fft(), 8),
                          ("filterbank", streamit.build_filterbank(), 16),
                          ("autocor", streamit.build_autocor(), 16)):
        streamed(name, g, "src", "out", [rng.normal(size=n_in) for _ in range(96)], 4, LITERAL)
    streamit_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    p, m, v = 4, 8, 2
    runs = {"1f1b": (simulate_schedule(one_f_one_b(p, m), f_cost=float(v)),
                     interleaved_bubble(p, m, 1)),
            "interleaved_1f1b": (simulate_schedule(interleaved_1f1b(p, m, v)),
                                 interleaved_bubble(p, m, v))}
    sched_s = time.perf_counter() - t0
    emit("stg_schedules", stages=p, micro=m, chunks=v, seconds=sched_s,
         **{k: dict(makespan=r.makespan, bubble=r.bubble, analytic_bubble=b)
            for k, (r, b) in runs.items()})
    if any(abs(r.bubble - b) > 1e-9 for r, b in runs.values()) or \
            not runs["interleaved_1f1b"][0].bubble < runs["1f1b"][0].bubble:
        raise AssertionError(f"simulated bubbles off their models: {runs}")

    t0 = time.perf_counter()
    graphs = {"jpeg": jpeg.build_stg(), "fft": streamit.build_fft(),
              "filterbank": streamit.build_filterbank(), "autocor": streamit.build_autocor(),
              "nbody": nbody.build_stg()}
    reports = {n: verify.verify_graph(g, Selection.fastest(g)) for n, g in graphs.items()}
    verify_s = time.perf_counter() - t0
    emit("stg_verify", seconds=verify_s, errors={n: len(r.errors()) for n, r in reports.items()},
         checks={n: r.checks for n, r in reports.items()})
    bad = {n: r.render() for n, r in reports.items() if not r.ok()}
    if bad:
        raise AssertionError(f"verify_graph refused committed graphs: {bad}")
    emit("stg_phase", jpeg_s=jpeg_s, streamit_s=streamit_s, schedules_s=sched_s,
         verify_s=verify_s)


def large_serving(ab, profile_decode, kernels, smi):
    """Phase 12: nemotron-4-15b and then deepseek-coder-33b served at full
    width and depth on random bf16 weights from a seed, each built only
    once nothing else is resident (the memory allocated is printed first,
    and above 2 GB the phase refuses to start) and freed before the next.
    nemotron-4-15b is built and first served through the entry point,
    ``repro_torch.launch.serve.main`` (8 requests of 4-400 prompt tokens,
    32 new each); both then serve phase 4's traffic (8 requests of 64-400
    prompt tokens, 32 new tokens each, greedy) at ``max_batch`` 8 after a
    warm-up round, and deepseek-coder-33b 16 such requests at ``max_batch``
    16 (two batch groups in the chain's GEMVs).  Around each counted serve
    the launch counts are set to 0 just before and read just after: flash,
    rmsnorm, decode attention, ``qkv_rope`` and ``out_residual`` must all
    launch, and ``_composed_step`` never run.  Each model's A/B (phase 5's,
    two requests, both routes in lockstep) runs at full depth, held to
    eight bf16 steps at the logits' magnitude.  Prints tok/s, the decode
    step's p50 / p90, the weights resident and the peak over them, and one
    profiled decode step's idle share, each with the card's name and power
    limit.  Returns the launches of each counted round, by round."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_decode as fd
    from repro_torch.launch import serve as serve_cli
    from repro_torch.runtime.server import LMServer, Request, ServeStats, _bucket

    gb = 1e9
    prompt_lens = np.random.default_rng(0).integers(64, 401, 8)      # phase 4's traffic
    more_lens = np.random.default_rng(1).integers(64, 401, 8)
    rounds = {}

    def reset():
        for fn in kernels.values():
            fn.launches = 0
        fd._composed_step.calls = 0

    def read(what):
        launches = {k: fn.launches for k, fn in kernels.items()}
        missing = [k for k, n in launches.items() if n == 0]
        if missing or fd._composed_step.calls or \
                launches["fused_qkv_rope"] != launches["fused_out_residual"]:
            raise AssertionError(f"{what}: launches {launches}, _composed_step called "
                                 f"{fd._composed_step.calls} times: the path left its kernels")
        return launches

    def counted(server, prompts, resident):
        reqs = [Request(uid=i, prompt=p_, max_new=32) for i, p_ in enumerate(prompts)]
        server.serve([Request(uid=r.uid, prompt=r.prompt, max_new=2) for r in reqs])
        server.stats = ServeStats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        outs = server.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cfg = server.cfg
        launches = read(f"{cfg.name} at max_batch {server.max_batch}")
        for o in outs:
            if not 1 <= len(o.tokens) <= 32 or not all(0 <= t < cfg.padded_vocab
                                                         for t in o.tokens):
                raise AssertionError(f"{cfg.name} request {o.uid}: bad completion {o.tokens}")
        steps = np.array(server.stats.decode_step_s)
        summary = server.stats.summary()
        groups = -(-min(server.max_batch, len(reqs)) // fd.BATCH_GROUP)
        a = cfg.attn
        emit("large_serve", config=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
             heads=a.n_heads, kv_heads=a.n_kv_heads, max_batch=server.max_batch,
             requests=len(reqs), prompt_lens=[len(p_) for p_ in prompts],
             bucket=_bucket(max(map(len, prompts))), completion_lens=[len(o.tokens) for o in outs],
             serve_s=wall, prefill_tok_per_s=summary["prefill_tok_per_s"],
             decode_tok_per_s=summary["decode_tok_per_s"], decode_steps=len(steps),
             decode_step_p50_ms=float(np.percentile(steps, 50) * 1e3),
             decode_step_p90_ms=float(np.percentile(steps, 90) * 1e3),
             prefill_s=server.stats.prefill_s, weights_resident_gb=resident / gb,
             peak_over_resident_gb=(torch.cuda.max_memory_allocated() - resident) / gb,
             max_memory_allocated_gb=torch.cuda.max_memory_allocated() / gb,
             launches=launches, composed_step_calls=fd._composed_step.calls,
             qkv_rope_plan=fd.gemv_plan(a.n_heads + 2 * a.n_kv_heads, fd.tile_width(a.head_dim),
                                        cfg.d_model, groups, sms, dtype=torch.bfloat16,
                                        norm=True)._asdict(),
             card=smi)
        return launches

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in LARGE:
        refuse_above_2gb("large_serve_start", name, smi)
        cfg = get_config(name)
        argv = ["--arch", name, "--max-new", "32", "--prompt-len", "400", "--seed", "0"]
        t0 = time.perf_counter()
        if name == "nemotron-4-15b":
            reset()
            server, outs = serve_cli.main(argv + ["--requests", "8", "--max-batch", "8"])
            torch.cuda.synchronize()
            rounds[f"{name} serve.main"] = read(f"serve.main {name}")
            emit("large_serve_cli", config=cfg.name, argv=argv + ["--requests", "8"],
                 seconds=time.perf_counter() - t0, completion_lens=[len(o.tokens) for o in outs],
                 stats=server.stats.summary(), launches=rounds[f"{name} serve.main"], card=smi)
        else:
            server = LMServer(cfg, max_batch=8, seed=0)
            torch.cuda.synchronize()
            emit("large_serve_init", config=cfg.name, seconds=time.perf_counter() - t0)
        params = server.params
        resident = sum(t.numel() * t.element_size() for t in params.parameters())
        prompts = [np.random.default_rng(n).integers(2, cfg.vocab, n).tolist()
                   for n in prompt_lens]
        rounds[f"{name} B8"] = counted(server, prompts, resident)
        if name == "deepseek-coder-33b":
            more = [np.random.default_rng(1000 + n).integers(2, cfg.vocab, n).tolist()
                    for n in more_lens]
            wide = LMServer(cfg, max_batch=16, params=params)
            rounds[f"{name} B16"] = counted(wide, prompts + more, resident)
            del wide
        del server

        # the A/B at full depth: eight bf16 steps at the logits' magnitude
        # (phase 5's rule: LOGIT_TOL is that at ~4)
        ab(cfg, params, prompts, lambda ref_logits: max(LOGIT_TOL,
                                                        float(ref_logits.abs().max()) / 16))
        profile_decode(cfg, params, prompts)
        del params
    gc.collect()
    torch.cuda.empty_cache()
    return rounds


def prefix_families(ab, profile_decode, kernels, smi):
    """Phase 14: the two families that read an input other than tokens, at
    full width and depth on random weights from a seed, one model at a time
    (the memory allocated before each must be under 2 GB).

    seamless-m4t-medium (12 encoder and 12 decoder layers, 0.88 B
    parameters): served through ``build_model(cfg).prefill`` and
    ``.decode_step`` (8 sequences of 128 tokens and 1024 frames of width
    1024, capacity 160, 31 greedy steps; a warm-up round that also holds
    the cross caches bitwise unchanged by the steps, then a counted one);
    the A/B of phase 5 on 2 of them with their frames; trained through
    `make_train_step` (AdamW on float32 masters, grad_accum 4, global batch
    8 of 1024 frames and 1024 tokens, remat "full": one warm-up step and 3
    counted); a 2 + 2-layer full-width step, kernel route against
    ``impl="ref"`` (loss and each leaf's gradient norm).

    internvl2-26b (48 layers, d_model 6144, 19.9 B parameters): first
    through ``repro_torch.launch.serve.main`` text-only (8 requests, 32 new
    tokens), then one prefill of 256 prefix embeddings ahead of 8 prompts
    of 128 tokens and 31 greedy steps, counted; the A/B of phase 5, strict
    at full depth, on 2 of them with their prefix; a profiled decode step;
    then one train step of a full-width 2-layer cut with the prefix, kernel
    route against ``impl="ref"``.

    Every counted run: launch counts set to 0 just before and read just
    after, every kernel of the path launched, no plain version called, and
    ``_composed_step`` never run.  Returns each counted run's launches."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_backward
    from repro_torch.kernels.rmsnorm import rmsnorm_backward
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm

    dev, bf16, f32, gb = torch.device("cuda"), torch.bfloat16, torch.float32, 1e9
    train_kernels = {"flash_attention": kernels["flash_attention"],
                     "flash_attention_bwd": flash_attention_backward,
                     "rmsnorm": kernels["rmsnorm"], "rmsnorm_bwd": rmsnorm_backward}
    rounds = {}

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def fresh(name):
        refuse_above_2gb("prefix_start", name, smi)

    def generate(model, params, batch, capacity, steps, check_cross=False):
        """A prefill and ``steps`` greedy decode steps, each step's wall time
        taken at its token read (one sync a step)."""
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, batch, capacity=capacity)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            tokens = [tok.tolist()]
            prefill_s = time.perf_counter() - t0
            cross = [(c["cross_k"].clone(), c["cross_v"].clone()) for c in cache["layers"]
                     ] if check_cross else []
            step_s = []
            for _ in range(steps):
                t1 = time.perf_counter()
                logits, cache = model.decode_step(params, cache, tok)
                tok = logits[:, -1].argmax(-1, keepdim=True)
                tokens.append(tok.tolist())
                step_s.append(time.perf_counter() - t1)
            unchanged = all(torch.equal(k, c["cross_k"]) and torch.equal(v, c["cross_v"])
                            for (k, v), c in zip(cross, cache["layers"]))
            finite = bool(torch.isfinite(logits).all())
        toks = np.array(tokens)[:, :, 0].T                         # (B, 1 + steps)
        if not finite or toks.min() < 0 or toks.max() >= model.cfg.padded_vocab:
            raise AssertionError(f"{model.cfg.name}: logits not finite or tokens out of range")
        return dict(prefill_s=prefill_s, decode_steps=steps,
                    decode_step_p50_ms=float(np.percentile(step_s, 50) * 1e3),
                    decode_step_p90_ms=float(np.percentile(step_s, 90) * 1e3),
                    decode_tok_per_s=toks.shape[0] * steps / sum(step_s),
                    cross_caches_unchanged=unchanged if check_cross else None,
                    first_tokens=toks[:2, :8].tolist())

    def train_ab(cfg, batch, n_layers, enc_layers=0):
        """One step (accum 2) of a full-width cut, kernel route against
        impl="ref" from the same float32 masters and batch: the loss and
        each leaf's gradient norm within phase 10's bf16 tolerance."""
        cut = dataclasses.replace(cfg, n_layers=n_layers, enc_layers=enc_layers)
        out = {}
        for impl in (None, "ref"):
            model = lm.init_params(cut, device=dev, param_dtype=f32, generator=gen(0))
            opt, step_fn = make_train_step(cut, grad_accum=2, impl=impl, warmup=1)
            state = opt.init(dict(model.named_parameters()))
            if impl is None:
                metrics = run_counted(f"{cfg.name} train A/B", lambda: step_fn(
                    model, state, 0, batch), train_kernels, rounds)
            else:
                metrics, rec = counted(lambda: step_fn(model, state, 0, batch),
                                       train_kernels, require=())
                if any(rec["launches"].values()):
                    raise AssertionError(f"the impl='ref' step launched kernels: "
                                         f"{rec['launches']}")
            out[impl] = (float(metrics["loss"]),
                         {k: float(p.grad.norm()) for k, p in model.named_parameters()})
            del model, state, opt
        (loss_k, norms_k), (loss_r, norms_r) = out[None], out["ref"]
        rel = {k: abs(norms_k[k] - norms_r[k]) / max(norms_r[k], 1e-30) for k in norms_r}
        worst = max(rel, key=rel.get)
        loss_rel = abs(loss_k - loss_r) / abs(loss_r)
        tol = TRAIN_AB_TOL[cfg.compute_dtype]
        ok = loss_rel <= tol and rel[worst] <= tol
        emit("prefix_train_ab", config=f"{cfg.name}, {n_layers} + {enc_layers} layers, full "
             "width", batch={k: list(v.shape) for k, v in batch.items()}, loss_kernels=loss_k,
             loss_ref=loss_r, loss_rel_diff=loss_rel, worst_grad_norm_leaf=worst,
             worst_grad_norm_rel_diff=rel[worst], leaves=len(rel), tolerance=tol, ok=ok,
             card=smi)
        if not ok:
            raise AssertionError(f"train step of a {cfg.name} cut: kernel route and "
                                 f"impl='ref' differ (loss {loss_k} vs {loss_r}; {worst} "
                                 f"{rel[worst]})")

    # -- seamless-m4t-medium: serving ---------------------------------------
    cfg = get_config("seamless-m4t-medium")
    fresh(cfg.name)
    model = lm.build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(device=dev, generator=gen(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident = sum(p.numel() * p.element_size() for p in params.parameters())
    g = gen(1)
    B, S, new = 8, 128, 32
    batch = {"tokens": torch.randint(2, cfg.vocab, (B, S), generator=g, device=dev),
             "frames": torch.randn((B, cfg.num_prefix, cfg.d_model), generator=g,
                                   device=dev).to(bf16)}
    warm = generate(model, params, batch, S + new, new - 1, check_cross=True)
    if not warm["cross_caches_unchanged"]:
        raise AssertionError(f"{cfg.name}: a decode step wrote the cross caches")
    rec = run_counted(f"{cfg.name} serve", lambda: generate(model, params, batch, S + new,
                                                            new - 1), kernels, rounds)
    emit("prefix_serve", config=cfg.name, layers=cfg.n_layers, enc_layers=cfg.enc_layers,
         d_model=cfg.d_model, heads=cfg.attn.n_heads, kv_heads=cfg.attn.n_kv_heads,
         params=sum(p.numel() for p in params.parameters()), init_s=init_s, batch=B,
         prompt_tokens=S, frames=cfg.num_prefix, capacity=S + new,
         cross_caches_unchanged_by_decode=warm["cross_caches_unchanged"], **rec,
         weights_resident_gb=resident / gb,
         peak_over_resident_gb=(torch.cuda.max_memory_allocated() - resident) / gb,
         launches=rounds[f"{cfg.name} serve"], card=smi)
    ab(cfg, params, batch["tokens"][:2].tolist(),
       lambda ref_logits: max(LOGIT_TOL, float(ref_logits.abs().max()) / 16),
       extra={"frames": batch["frames"][:2]})
    del params, batch

    # -- seamless-m4t-medium: training at full width and depth --------------
    fresh(cfg.name + " training")
    seq, gbatch, accum = 1024, 8, 4
    master = lm.init_params(cfg, device=dev, param_dtype=f32, generator=gen(0))
    opt, step_fn = make_train_step(cfg, grad_accum=accum, warmup=2)
    state = opt.init(dict(master.named_parameters()))
    resident = torch.cuda.memory_allocated()

    def train_batch(step, lead=(accum, gbatch // accum), n_tok=seq):
        g_ = gen(100 + step)
        return {"tokens": torch.randint(0, cfg.vocab, (*lead, n_tok), generator=g_, device=dev),
                "labels": torch.randint(0, cfg.vocab, (*lead, n_tok), generator=g_, device=dev),
                "frames": torch.randn((*lead, cfg.num_prefix, cfg.d_model), generator=g_,
                                      device=dev).to(bf16)}

    losses, step_s = [], []

    def steps(first, n):
        for i in range(first, first + n):
            b_ = train_batch(i)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses.append(float(step_fn(master, state, i, b_)["loss"]))
            step_s.append(time.perf_counter() - t1)

    steps(0, 1)                                  # the warm-up step
    run_counted(f"{cfg.name} train", lambda: steps(1, 3), train_kernels, rounds)
    median_s = sorted(step_s[1:])[1]
    n_params = sum(p.numel() for p in master.parameters())
    emit("prefix_train", config=cfg.name, layers=cfg.n_layers, enc_layers=cfg.enc_layers,
         params=n_params, optimizer=cfg.optimizer, param_dtype=cfg.param_dtype,
         compute_dtype=cfg.compute_dtype, remat=cfg.remat, seq=seq, frames=cfg.num_prefix,
         global_batch=gbatch, grad_accum=accum, losses=losses, step_s=step_s,
         timed_steps=3, timed_step_s_median=median_s, tok_per_s=gbatch * seq / median_s,
         frames_per_s=gbatch * cfg.num_prefix / median_s,
         resident_gb=resident / gb,
         peak_over_resident_gb=(torch.cuda.max_memory_allocated() - resident) / gb,
         launches=rounds[f"{cfg.name} train"], card=smi)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite training loss of {cfg.name}: {losses}")
    del master, state, opt
    fresh(cfg.name + " training A/B")
    train_ab(cfg, train_batch(0, lead=(2, 2)), 2, 2)

    # -- internvl2-26b: serving at full width and depth ---------------------
    cfg = get_config("internvl2-26b")
    fresh(cfg.name)
    argv = ["--arch", cfg.name, "--requests", "8", "--max-batch", "8", "--max-new", "32",
            "--prompt-len", "400", "--seed", "0"]
    t0 = time.perf_counter()
    server, outs = run_counted(f"{cfg.name} serve.main", lambda: serve_cli.main(argv), kernels,
                               rounds)
    emit("prefix_serve_cli", config=cfg.name, argv=argv, seconds=time.perf_counter() - t0,
         completion_lens=[len(o.tokens) for o in outs], stats=server.stats.summary(),
         launches=rounds[f"{cfg.name} serve.main"], card=smi)
    params, model = server.params, server.model
    del server, outs
    resident = sum(p.numel() * p.element_size() for p in params.parameters())
    g = gen(2)
    batch = {"tokens": torch.randint(2, cfg.vocab, (B, S), generator=g, device=dev),
             "prefix_embeds": torch.randn((B, cfg.num_prefix, cfg.d_model), generator=g,
                                          device=dev).to(bf16)}
    capacity = cfg.num_prefix + S + new
    generate(model, params, batch, capacity, 2)                  # warm-up
    rec = run_counted(f"{cfg.name} prefix", lambda: generate(model, params, batch, capacity,
                                                             new - 1), kernels, rounds)
    emit("prefix_serve", config=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         heads=cfg.attn.n_heads, kv_heads=cfg.attn.n_kv_heads,
         params=sum(p.numel() for p in params.parameters()), batch=B, prompt_tokens=S,
         prefix=cfg.num_prefix, capacity=capacity, **rec, weights_resident_gb=resident / gb,
         peak_over_resident_gb=(torch.cuda.max_memory_allocated() - resident) / gb,
         launches=rounds[f"{cfg.name} prefix"], card=smi)
    ab(cfg, params, batch["tokens"][:2].tolist(),
       lambda ref_logits: max(LOGIT_TOL, float(ref_logits.abs().max()) / 16),
       extra={"prefix_embeds": batch["prefix_embeds"][:2]})
    profile_decode(cfg, params, batch["tokens"].tolist())
    del params, model, batch

    # -- internvl2-26b: one train step of a 2-layer full-width cut ----------
    fresh(cfg.name + " training A/B")
    g = gen(3)
    lead = (2, 2)
    train_ab(cfg, {"tokens": torch.randint(0, cfg.vocab, (*lead, 512), generator=g, device=dev),
                   "labels": torch.randint(0, cfg.vocab, (*lead, 512), generator=g, device=dev),
                   "prefix_embeds": torch.randn((*lead, cfg.num_prefix, cfg.d_model), generator=g,
                                                device=dev).to(bf16)}, 2)
    gc.collect()
    torch.cuda.empty_cache()
    return rounds


def moe_layers(model):
    """The MoE sublayers of a model, in layer order."""
    return [layer.mlp for layer in model.layers if layer.moe]


def captured(model, fn):
    """``fn()``'s result and the input of each MoE layer in its last call."""
    seen = {}
    hooks = [m.register_forward_pre_hook(lambda _m, args, i=i: seen.__setitem__(i, args[0]))
             for i, m in enumerate(moe_layers(model))]
    try:
        out = fn()
    finally:
        for hook in hooks:
            hook.remove()
    return out, [seen[i] for i in range(len(hooks))]


def replayed_rounds(moe, probs, choices):
    """`MoE._rounds` with each round's experts (B, S) taken from
    ``choices``, as another run of the layer chose them, in place of the
    argmax: gates, slots and drops follow from ``probs``."""
    import torch

    B, S, E = probs.shape
    cap = moe.capacity(S)
    experts = torch.arange(E, device=probs.device)
    occupancy = torch.zeros((B, 1, E), dtype=torch.long, device=probs.device)
    remaining, rounds = probs, []
    for idx in choices:
        gate = remaining.gather(-1, idx[..., None])[..., 0]
        onehot = (idx[..., None] == experts).long()
        pos = torch.cumsum(onehot, dim=1) - onehot + occupancy
        slot = pos.gather(-1, idx[..., None])[..., 0]
        keep = slot < cap
        occupancy = occupancy + (onehot * keep[..., None]).sum(dim=1, keepdim=True)
        remaining = remaining.scatter(-1, idx[..., None], 0.0)
        rounds.append((idx, gate, slot, keep))
    return rounds


def padded(prompts, device):
    """The server's batch: prompts right-aligned in their bucket after
    pad token 0; and the pad mask."""
    import numpy as np
    import torch

    from repro_torch.runtime.server import _bucket
    bucket = _bucket(max(map(len, prompts)))
    toks = np.zeros((len(prompts), bucket), np.int64)
    for i, p_ in enumerate(prompts):
        toks[i, bucket - len(p_):] = p_
    return torch.from_numpy(toks).to(device), torch.from_numpy(toks == 0).to(device)


def routing_ab(cfg, params, prompts, strict, smi):
    """Each MoE sublayer fed its kernel-route input (a prefill of two
    requests, then one decode step), its routing under both routes: a
    differing expert fails unless its router logit is within 8 bf16
    steps (at the row's largest logit) of the oracle's choice's;
    ``strict``: any difference fails."""
    import torch

    from repro_torch.models import lm
    toks, _ = padded(prompts[:2], params.embed.device)
    flips, worst, inputs = 0, 0.0, []
    with torch.no_grad():
        (_, cache), xs = captured(params, lambda: lm.prefill(
            cfg, params, {"tokens": toks}, capacity=toks.shape[1] + 1))
        inputs += xs
        _, xs = captured(params, lambda: lm.decode_step(cfg, params, cache, toks[:, -1:]))
        inputs += xs
        layers = moe_layers(params) * 2
        for m, x in zip(layers, inputs):
            rk, rr = m.routing(x), m.routing(x, impl="ref")
            diff = rk["experts"] != rr["experts"]
            if not diff.any():
                continue
            logits = rr["logits"][None].expand(*rk["experts"].shape, -1)
            gap = (logits.gather(-1, rk["experts"][..., None]) -
                   logits.gather(-1, rr["experts"][..., None]))[..., 0].abs()[diff]
            top = logits.abs().amax(-1)[diff]
            steps = 8 * torch.exp2(torch.floor(torch.log2(top)) - 7)
            flips += int(diff.sum())
            worst = max(worst, float(gap.max()))
            if strict or bool((gap >= steps).any()):
                raise AssertionError(f"{cfg.name}: {int(diff.sum())} routing choices differ "
                                     f"between the routes, router-logit gap up to "
                                     f"{float(gap.max())}")
    emit("moe_routing_ab", config=cfg.name, layers=cfg.n_layers,
         compute_dtype=cfg.compute_dtype, sublayer_calls=len(inputs), flips=flips,
         largest_flip_logit_gap=worst, strict=strict, card=smi)


def cut_train_ab(cut, masters, kernels, rounds, record, smi):
    """One train step of a full-width cut (B 2 x S 1024, no optimizer
    state) from the same ``masters``-dtype weights and batch, kernel route
    against ``impl="ref"``: the loss and each leaf's gradient norm within
    phase 10's tolerance for the compute dtype; only the first route's
    norms are kept while the second runs.  The kernel route is counted
    (every kernel of ``kernels`` launched, no plain version called), the
    oracle's launches none.  Prints ``<record>_train_ab``."""
    import torch

    from repro_torch.models import lm
    dev, gb, seq = torch.device("cuda"), 1e9, 1024
    g = torch.Generator(device=dev).manual_seed(3)
    batch = {k: torch.randint(0, cut.vocab, (2, seq), generator=g, device=dev)
             for k in ("tokens", "labels")}
    what = f"{cut.name} train A/B"
    out = {}
    for impl in (None, "ref"):
        refuse_above_2gb(f"{record}_start", f"{cut.name}, {cut.n_layers} layers, training, "
                         f"impl={impl}", smi)
        model = lm.init_params(cut, device=dev, param_dtype=masters,
                               generator=torch.Generator(device=dev).manual_seed(0))
        resident = torch.cuda.memory_allocated()

        def step():
            loss, _ = lm.loss_fn(cut, model, batch, impl=impl)
            loss.backward()
            return float(loss.detach())
        if impl is None:
            loss = run_counted(what, step, kernels, rounds)
        else:
            loss, rec = counted(step, kernels, require=())
            if any(rec["launches"].values()):
                raise AssertionError(f"the impl='ref' step launched kernels: {rec['launches']}")
        out[impl] = (loss, {k: float(p.grad.float().norm()) for k, p in model.named_parameters()},
                     (torch.cuda.max_memory_allocated() - resident) / gb, resident / gb)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    (loss_k, norms_k, peak, res), (loss_r, norms_r, _, _) = out[None], out["ref"]
    rel = {k: abs(norms_k[k] - norms_r[k]) / max(norms_r[k], 1e-30) for k in norms_r}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_r) / abs(loss_r)
    tol = TRAIN_AB_TOL[cut.compute_dtype]
    ok = loss_rel <= tol and rel[worst] <= tol
    emit(f"{record}_train_ab", config=f"{cut.name}, {cut.n_layers} layers, full width",
         batch=[2, seq], remat=cut.remat, masters=str(masters).removeprefix("torch."),
         loss_kernels=loss_k, loss_ref=loss_r, loss_rel_diff=loss_rel,
         worst_grad_norm_leaf=worst, worst_grad_norm_rel_diff=rel[worst], leaves=len(rel),
         tolerance=tol, ok=ok, masters_resident_gb=res, peak_over_resident_gb=peak,
         launches=rounds[what], card=smi)
    if not ok:
        raise AssertionError(f"train step of a {cut.name} cut: kernel route and impl='ref' "
                             f"differ (loss {loss_k} vs {loss_r}; {worst} {rel[worst]})")


def moe_serving(ab, kernels, smi):
    """Phase 15: the llama4 MoE decoders at full width on random bf16
    weights from a seed, one model at a time (the memory allocated before
    each must be under 2 GB): llama4-scout-17b-a16e cut to 12 of its 48
    layers (57 GB of weights) and llama4-maverick-400b-a17b cut to one
    (dense, MoE) period of 2 layers (37 GB).

    Each serves phase 4's traffic through ``LMServer`` (8 requests of
    64-400 prompt tokens, 32 new, greedy, ``max_batch`` 8) after a warm-up
    round; around the counted round every launch count is set to 0 just
    before and read just after: flash, rmsnorm, decode attention,
    ``qkv_rope`` and ``out_residual`` must all launch, no plain version be
    called and ``_composed_step`` never run.  For each MoE layer the
    prefill's tokens routed and dropped (capacity 40 a row for scout, 5 for
    maverick), the drops of pad positions and the pad expert's share of
    the drops; the experts a decode step hits.  Then phase 5's A/B (two
    requests, both routes in lockstep, logits within max(LOGIT_TOL,
    |logits| / 16)) and each MoE sublayer's routing under both routes on
    the kernel route's inputs (`routing_ab`); a float32 A/B of a 2-layer
    cut in which every routing decision agrees; one profiled decode step
    (idle share; the MoE's batched expert products beside the bounds of
    all experts' bytes and of the hit experts'; the rest of the MoE:
    routing, dispatch and combine).  scout also takes one train step of a
    2-layer full-width cut (float32 masters, B 2 x S 1024, remat "full", no
    optimizer state), kernel route against ``impl="ref"``: the loss and
    each leaf's gradient norm within phase 10's bf16 tolerance.  Returns
    each counted run's launches."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.flash_attention import flash_attention_backward
    from repro_torch.kernels.rmsnorm import rmsnorm_backward
    from repro_torch.models import blocks, lm
    from repro_torch.runtime.server import LMServer, Request, ServeStats, _bucket

    dev, gb = torch.device("cuda"), 1e9
    # scout's norm (5120) trains past the row kernel: the cluster kernel
    train_kernels = {"flash_attention": kernels["flash_attention"],
                     "flash_attention_bwd": flash_attention_backward,
                     "rmsnorm": kernels["rmsnorm"], "rmsnorm_bwd": rmsnorm_backward,
                     "rmsnorm_bwd_cluster": rn.rmsnorm_bwd_cluster}
    prompt_lens = np.random.default_rng(0).integers(64, 401, 8)      # phase 4's traffic
    rounds = {}

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def routing_stats(cfg, params, prompts):
        """Each MoE layer's prefill over the round's batch: tokens routed,
        dropped, pads dropped, the drops on a row's pad expert; and the
        experts one decode step hits."""
        toks, pad = padded(prompts, dev)
        with torch.no_grad():
            (_, cache), xs = captured(params, lambda: lm.prefill(
                cfg, params, {"tokens": toks}, capacity=toks.shape[1] + 1))
            layers = []
            for m, x in zip(moe_layers(params), xs):
                r = m.routing(x)
                experts, dropped = r["experts"], ~r["kept"]               # (k, B, S)
                pad_expert = experts[0, :, :1]                            # a row's pads' choice
                on_pad = dropped & (experts == pad_expert) & pad.any(-1, keepdim=True)
                layers.append(dict(routed=int(experts.numel()), dropped=int(dropped.sum()),
                                   pads_dropped=int((dropped & pad).sum()),
                                   dropped_on_pad_expert=int(on_pad.sum())))
            feed = toks[:, -1:]
            _, xs = captured(params, lambda: lm.decode_step(cfg, params, cache, feed))
            hit = [int(torch.unique(m.routing(x)["experts"]).numel())
                   for m, x in zip(moe_layers(params), xs)]
        drops = sum(l_["dropped"] for l_ in layers)
        return dict(capacity_a_row=moe_layers(params)[0].capacity(toks.shape[1]),
                    bucket=toks.shape[1], prefill_layers=layers,
                    routed=sum(l_["routed"] for l_ in layers), dropped=drops,
                    dropped_share=drops / sum(l_["routed"] for l_ in layers),
                    pad_expert_share_of_drops=sum(l_["dropped_on_pad_expert"] for l_ in layers)
                    / max(drops, 1),
                    decode_experts_hit=hit)

    def profile_step(cfg, params, prompts, hit):
        """Decode steps after a prefill of the round's batch: the wall time
        of unprofiled ones, then one profiled (``torch.profiler``, CPU and
        CUDA): device busy and idle share; the MoE layers' batched expert
        products (``moe.experts``), shared experts (``moe.shared``) and the
        rest of the sublayer (``moe`` less both: norm, router, dispatch and
        combine), each ms a step, ranges marked by ``record_function``
        only for this step."""
        toks, _ = padded(prompts, dev)
        e = cfg.moe
        expert_bytes = 3 * cfg.d_model * e.d_ff * 2
        n_moe = len(moe_layers(params))
        forward, ffn = blocks.MoE.forward, blocks.FFN.forward

        def marked(name_of, f):
            def wrapped(self, *a, **kw):
                with torch.profiler.record_function(name_of(self)):
                    return f(self, *a, **kw)
            return wrapped
        with torch.no_grad():
            _, cache = lm.prefill(cfg, params, {"tokens": toks}, capacity=toks.shape[1] + 16)
            feed = toks[:, -1:]
            lm.decode_step(cfg, params, cache, feed)
            torch.cuda.synchronize()
            n_steps = 4
            t0 = time.perf_counter()
            for _ in range(n_steps):
                lm.decode_step(cfg, params, cache, feed)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
            blocks.MoE.forward = marked(lambda _: "moe", forward)
            blocks.FFN.forward = marked(
                lambda m: "moe.experts" if m.w_up.dim() == 3 else "moe.shared", ffn)
            try:
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    lm.decode_step(cfg, params, cache, feed)
                    torch.cuda.synchronize()
            finally:
                blocks.MoE.forward, blocks.FFN.forward = forward, ffn
        # kernels alone (the device's user-annotation ranges left out); each
        # range's kernel time twice: from the kernels under its host range,
        # and from the kernels inside its device range (none if the
        # profiler records no device ranges)
        names = ("moe", "moe.experts", "moe.shared")
        kernels_, host, device = [], dict.fromkeys(names, 0.0), {n: [] for n in names}
        for x in prof.events():
            on_card = str(x.device_type).endswith("CUDA")
            if on_card and x.is_user_annotation:
                if x.name in device:
                    device[x.name].append((x.time_range.start, x.time_range.end))
            elif on_card:
                kernels_.append((x.time_range.start, x.time_range.end))
            elif x.name in host:
                host[x.name] += x.device_time_total / 1e3
        busy_ms = sum(b_ - a_ for a_, b_ in kernels_) / 1e3
        ranged = {n: sum(b_ - a_ for a_, b_ in kernels_
                         if any(s_ <= a_ and b_ <= t_ for s_, t_ in device[n])) / 1e3
                  for n in names} if all(device.values()) else {}
        span = ranged or host
        emit("moe_profile", config=cfg.name, what=f"decode_step, B{toks.shape[0]}, cache "
             f"{toks.shape[1] + 16}", wall_ms_per_step=wall_ms, device_busy_ms=busy_ms,
             device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
             moe_ms=span["moe"], experts_ms=span["moe.experts"],
             shared_ms=span["moe.shared"],
             rest_ms=span["moe"] - span["moe.experts"] - span["moe.shared"],
             ranges_from="device ranges" if ranged else "host ranges",
             host_range_ms=host, device_range_ms=ranged or None,
             experts_bound_all_ms=n_moe * e.n_experts * expert_bytes / HBM_BYTES_PER_S * 1e3,
             experts_bound_hit_ms=sum(hit) * expert_bytes / HBM_BYTES_PER_S * 1e3,
             experts_hit=hit, moe_layers=n_moe, experts=e.n_experts,
             launches_per_step=len(kernels_), card=smi)

    def serve(cfg):
        """Phase 4's traffic through `LMServer` at full width, a warm-up
        round, then a counted one; returns the weights and the prompts."""
        refuse_above_2gb("moe_start", cfg.name, smi)
        t0 = time.perf_counter()
        server = LMServer(cfg, max_batch=8, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        params = server.params
        resident = sum(p.numel() * p.element_size() for p in params.parameters())
        prompts = [np.random.default_rng(n).integers(2, cfg.vocab, n).tolist()
                   for n in prompt_lens]
        reqs = [Request(uid=i, prompt=p_, max_new=32) for i, p_ in enumerate(prompts)]
        server.serve([Request(uid=r.uid, prompt=r.prompt, max_new=2) for r in reqs])
        server.stats = ServeStats()
        outs = run_counted(f"{cfg.name} serve", lambda: server.serve(reqs), kernels, rounds)
        for o in outs:
            if not 1 <= len(o.tokens) <= 32 or not all(0 <= t < cfg.padded_vocab
                                                         for t in o.tokens):
                raise AssertionError(f"{cfg.name} request {o.uid}: bad completion {o.tokens}")
        steps = np.array(server.stats.decode_step_s)
        summary = server.stats.summary()
        e = cfg.moe
        emit("moe_serve", config=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
             experts=e.n_experts, top_k=e.top_k, pattern=cfg.block_pattern,
             params=sum(p.numel() for p in params.parameters()), init_s=init_s,
             max_batch=8, requests=len(reqs), prompt_lens=[len(p_) for p_ in prompts],
             bucket=_bucket(max(map(len, prompts))), completion_lens=[len(o.tokens) for o in outs],
             prefill_tok_per_s=summary["prefill_tok_per_s"],
             decode_tok_per_s=summary["decode_tok_per_s"], decode_steps=len(steps),
             decode_step_p50_ms=float(np.percentile(steps, 50) * 1e3),
             decode_step_p90_ms=float(np.percentile(steps, 90) * 1e3),
             prefill_s=server.stats.prefill_s, weights_resident_gb=resident / gb,
             peak_over_resident_gb=(torch.cuda.max_memory_allocated() - resident) / gb,
             launches=rounds[f"{cfg.name} serve"], card=smi)
        del server
        return params, prompts

    def float32_ab(cfg, prompts):
        """Phase 5's A/B of a 2-layer full-width cut in float32, every
        routing decision equal under both routes."""
        cut = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
        refuse_above_2gb("moe_start", f"{cfg.name}, 2 layers, float32", smi)
        params = lm.init_params(cut, device=dev, generator=gen(0))
        ab(cut, params, prompts, lambda _: MOE_F32_LOGIT_TOL)
        routing_ab(cut, params, prompts, strict=True, smi=smi)
        del params

    for name, n_layers in zip(MOE, (12, 2)):
        cfg = dataclasses.replace(get_config(name), n_layers=n_layers)
        params, prompts = serve(cfg)
        stats = routing_stats(cfg, params, prompts)
        emit("moe_routing", config=cfg.name, layers=cfg.n_layers, card=smi, **stats)
        ab(cfg, params, prompts, lambda ref_logits: max(LOGIT_TOL,
                                                        float(ref_logits.abs().max()) / 16))
        routing_ab(cfg, params, prompts, strict=False, smi=smi)
        profile_step(cfg, params, prompts, stats["decode_experts_hit"])
        del params
        float32_ab(cfg, prompts)
        if name == MOE[0]:
            cut_train_ab(dataclasses.replace(cfg, n_layers=2, remat="full"), torch.float32,
                         train_kernels, rounds, "moe", smi)
    gc.collect()
    torch.cuda.empty_cache()
    return rounds


def hybrid_serving(ab, profile_decode, kernels, smi, *, decode_ms):
    """Phase 16: jamba-1.5-large-398b (attention and Mamba2 mixers in one
    stack, an MoE after every second layer) cut to its first four layers
    at full width (attention/dense, mamba/moe, mamba/dense, mamba/moe:
    22.98 B parameters, 46 GB of bf16 weights) on random bf16 weights from
    a seed, with under 2 GB allocated before it.

    Serves phase 4's traffic through ``LMServer`` at ``max_batch`` 8 after a
    warm-up round; the counted round launches every kernel of the path
    (flash, rmsnorm, the gated norm on its cluster kernel, the SSD scan,
    decode attention, the chain's ``qkv_rope`` and ``out_residual``),
    neither norm's wide kernel, no plain version and never
    `_composed_step`; tok/s, decode step p50 / p90 beside its bound
    (`decode_stage_bytes` of the bf16 weights: every weight but the
    embedding table once, the SSM states and the KV cache, at the round's
    last step) and beside the bytes as `MoE.decode` reads them (every
    expert once a round), ``prefill_s``, the
    resident weights and the peak over them; a profiled decode step (idle
    share).  Each MoE sublayer's routing under both routes on the kernel
    route's inputs (`routing_ab`: a differing choice only at a near-tie);
    phase 5's A/B of the cut with every route on the oracle's routing
    (`ab_on_oracle_routing`); a float32 A/B of a 2-layer cut (phase 5's
    `ab`), every routing decision equal.  The same requests through ``LMServer(max_batch=4,
    pipeline=DecodePipeline(...))``, one period (the cut's four layers) a
    stage, planned on the H100: tokens equal to the single-device
    ``LMServer(max_batch=4)``'s, ``late == 0``, every kernel launched (the
    gated norm's cluster kernel among them; no wide kernel).  One
    train step of the 2-layer cut with bf16 masters and no optimizer state
    (float32 ones and their gradients would take 95 GB), kernel route
    against ``impl="ref"``: the loss and each leaf's gradient norm within
    phase 10's bf16 tolerance.  And the host's counts (`count_step` of the
    plain versions on the meta device, `analyze_step` on the H100's rates)
    of the cut's decode step and prefill and of qwen2.5-3b's phase-4 decode
    step, beside the measured times (``decode_ms``: qwen2.5-3b's p50 from
    phase 4).  Returns each counted run's launches."""
    import numpy as np
    import torch

    from repro_torch.analysis import HW_H100, analyze_step, count_step, decode_stage_bytes
    from repro_torch.configs import first_layers, get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import planner
    from repro_torch.graphs import lm_graph
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.flash_attention import flash_attention_backward
    from repro_torch.kernels.rmsnorm import rmsnorm_backward, rmsnorm_gated_backward
    from repro_torch.kernels.ssd_scan import ssd_scan_backward
    from repro_torch.launch import steps
    from repro_torch.models import blocks, lm
    from repro_torch.runtime.pipeline import DecodePipeline
    from repro_torch.runtime.server import LMServer, Request, ServeStats, _bucket

    dev, gb = torch.device("cuda"), 1e9
    full = get_config(JAMBA)
    cfg = first_layers(full, 4)
    rounds = {}
    # the gated norm's rows (16384) are past the row kernel: the served
    # rounds launch its cluster kernel, and neither norm's wide kernel
    kernels = dict(kernels, rmsnorm_gated_cluster=rn.rmsnorm_gated_cluster)
    no_wide = {"rmsnorm_wide": rn.rmsnorm_wide, "rmsnorm_gated_wide": rn.rmsnorm_gated_wide}
    prompt_lens = np.random.default_rng(0).integers(64, 401, 8)      # phase 4's traffic
    prompts = [np.random.default_rng(n).integers(2, cfg.vocab, n).tolist() for n in prompt_lens]
    bucket = _bucket(max(map(len, prompts)))

    def requests(max_new):
        return [Request(uid=i, prompt=p_, max_new=max_new) for i, p_ in enumerate(prompts)]

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def check_outs(outs, what):
        for o in outs:
            if not 1 <= len(o.tokens) <= 32 or not all(0 <= t < cfg.padded_vocab
                                                         for t in o.tokens):
                raise AssertionError(f"{what} request {o.uid}: bad completion {o.tokens}")

    def ab_on_oracle_routing(cfg, params, prompts, steps=8):
        """Phase 5's A/B in bf16 on the oracle's routing, beside float32: a
        prefill of two requests and ``steps`` decode steps through the
        kernel route, the oracle (``impl="ref"``) and the oracle in float32
        on the same bf16 weights (each cast up at its use), all fed the
        oracle's tokens.  At each step the bf16 oracle runs first and the
        others replay its MoE sublayers' expert choices (`replayed_rounds`:
        gates, slots and drops from their own probabilities), so that all
        three are one model; `routing_ab` holds the routing itself, on one
        input, and the float32 A/B of the 2-layer cut below holds every
        choice.  The bf16 stack itself lies far from float32 (a bf16 step
        of the Mamba2 mixers' large outputs, carried on in their states),
        so the claim held is that the kernel route lies no farther: at
        every step its largest logit distance from the float32 oracle
        within 1.25 times the bf16 oracle's largest over the run.  How
        many choices each bf16 route would have made otherwise on its own
        input, counted."""
        toks, _ = padded(prompts[:2], params.embed.device)
        rounds = blocks.MoE._rounds
        recorded, diffs, kernel_err, oracle_err = [], [], [], []
        own = {"kernel": 0, "ref": 0}
        cfgs = {"ref": cfg, "kernel": cfg,
                "float32": dataclasses.replace(cfg, compute_dtype="float32")}
        impls = {"ref": "ref", "kernel": None, "float32": "ref"}

        def call(route, fn):
            """``fn`` on ``route``: the bf16 oracle recording its choices,
            or a route replaying them; and its MoE inputs."""
            replay = iter(list(recorded))

            def recording(self, probs):
                out = rounds(self, probs)
                recorded.append([r[0] for r in out])
                return out

            def replaying(self, probs):
                return replayed_rounds(self, probs, next(replay))
            if route == "ref":
                recorded.clear()
            blocks.MoE._rounds = recording if route == "ref" else replaying
            try:
                return captured(params, fn)
            finally:
                blocks.MoE._rounds = rounds
        with torch.no_grad():
            runs, xs = {}, {}
            for r_ in impls:
                runs[r_], xs[r_] = call(r_, lambda: lm.prefill(
                    cfgs[r_], params, {"tokens": toks}, capacity=toks.shape[1] + steps,
                    impl=impls[r_]))
            for step in range(steps + 1):
                for r_ in own:
                    for m, x, want in zip(moe_layers(params), xs[r_], recorded):
                        mine = m.routing(x, impl=impls[r_])["experts"]
                        own[r_] += int((mine != torch.stack(want)).sum())
                lk, lr, l32 = (runs[r_][0][:, -1].float() for r_ in ("kernel", "ref", "float32"))
                diffs.append(float((lk - lr).abs().max()))
                kernel_err.append(float((lk - l32).abs().max()))
                oracle_err.append(float((lr - l32).abs().max()))
                if step == steps:
                    break
                feed = lr.argmax(-1)[:, None]             # every route gets the oracle's
                for r_ in impls:
                    runs[r_], xs[r_] = call(r_, lambda: lm.decode_step(
                        cfgs[r_], params, runs[r_][1], feed, impl=impls[r_]))
        limit = 1.25 * max(oracle_err)
        over = [t for t, e in enumerate(kernel_err) if e > limit]
        emit("hybrid_ab", config=cfg.name, layers=cfg.n_layers, compute_dtype=cfg.compute_dtype,
             requests=2, steps=steps, routing="the bf16 oracle's, replayed",
             kernel_from_float32=kernel_err, oracle_from_float32=oracle_err,
             kernel_from_float32_limit=limit, max_abs_logit_diff=diffs,
             logits_abs_max=float(lr.abs().max()), other_choices_on_own_input=own,
             ok=not over, card=smi)
        if over:
            raise AssertionError(f"A/B {cfg.name}: at steps {over} the kernel route lies "
                                 f"{[kernel_err[t] for t in over]} from float32, beyond 1.25 "
                                 f"times the bf16 oracle's largest distance ({limit})")

    # -- the cut served ------------------------------------------------------
    refuse_above_2gb("hybrid_start", f"{cfg.name}, 4 layers", smi)
    t0 = time.perf_counter()
    server = LMServer(cfg, max_batch=8, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = server.params
    resident = sum(p.numel() * p.element_size() for p in params.parameters())
    server.serve(requests(2))
    server.stats = ServeStats()
    outs = run_counted(f"{cfg.name} serve", lambda: server.serve(requests(32)), kernels, rounds,
                       absent=no_wide)
    check_outs(outs, cfg.name)
    steps_s = np.array(server.stats.decode_step_s)
    summary = server.stats.summary()
    def served_bytes(c, cache_len):
        """`decode_stage_bytes` of a decode step at B 8 over the weights as
        the server holds them (the compute dtype, not float32 masters)."""
        return decode_stage_bytes(dataclasses.replace(c, param_dtype=c.compute_dtype), 8,
                                  cache_len, span=(0, c.n_periods), has_embed=True,
                                  has_head=True)

    step_bytes = served_bytes(cfg, bucket + 32)
    # as `MoE.decode` reads them: every expert once a round (top-k rounds)
    e = cfg.moe
    expert_bytes = 3 * cfg.d_model * e.d_ff * 2 * e.n_experts
    n_moe = sum(mlp == "moe" for _, mlp in cfg.block_pattern) * cfg.n_periods
    read_bytes = step_bytes + (e.top_k - 1) * n_moe * expert_bytes
    served = dict(
        decode_step_p50_ms=float(np.percentile(steps_s, 50) * 1e3),
        decode_step_p90_ms=float(np.percentile(steps_s, 90) * 1e3),
        prefill_s=server.stats.prefill_s)
    emit("hybrid_serve", config=cfg.name, layers=cfg.n_layers, pattern=cfg.block_pattern,
         d_model=cfg.d_model, ssm_heads=cfg.mamba.n_ssm_heads(cfg.d_model),
         experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
         params=sum(p.numel() for p in params.parameters()), init_s=init_s, max_batch=8,
         requests=len(prompts), prompt_lens=[len(p_) for p_ in prompts], bucket=bucket,
         completion_lens=[len(o.tokens) for o in outs],
         prefill_tok_per_s=summary["prefill_tok_per_s"],
         decode_tok_per_s=summary["decode_tok_per_s"], decode_steps=len(steps_s),
         decode_step_bytes=step_bytes,
         decode_step_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
         decode_step_bytes_as_read=read_bytes,
         decode_step_bound_as_read_ms=read_bytes / HBM_BYTES_PER_S * 1e3,
         weights_resident_gb=resident / gb,
         peak_over_resident_gb=(torch.cuda.max_memory_allocated() - resident) / gb,
         launches=rounds[f"{cfg.name} serve"], card=smi, **served)
    del server
    profile_decode(cfg, params, prompts)
    routing_ab(cfg, params, prompts, strict=False, smi=smi)
    ab_on_oracle_routing(cfg, params, prompts)

    # -- the same requests through the decode pipeline, one period a stage ---
    t0 = time.perf_counter()
    shape = ShapeCfg("serve_decode", 512, 4, "decode")
    plan = planner.plan(cfg, shape, chips=1, hw=HW_H100, max_tp=1)
    stg, _ = lm_graph.build_stg(cfg, shape, hw=HW_H100, max_tp=1)
    plan_s = time.perf_counter() - t0
    single = LMServer(cfg, max_batch=4, params=params)
    single.serve(requests(2))
    want = [o.tokens for o in single.serve(requests(32))]
    pipe = DecodePipeline(cfg, stg, plan, params=params, periods_per_stage=1)
    try:
        server = LMServer(cfg, max_batch=4, pipeline=pipe)
        pipe.warm(prompts, 32, group_size=4)
        got = run_counted(f"{cfg.name} pipelined serve", lambda: server.serve(requests(32)),
                          kernels, rounds, absent=no_wide)
        check_outs(got, f"{cfg.name} pipelined")
        run, late = server.last_run, pipe.compile_stats.late
        emit("hybrid_pipeline", config=cfg.name, stages=pipe.stage_names,
             replicas=[len(d) for d in pipe.stage_devices], plan_s=plan_s,
             groups=len(run.groups), streams_used=run.streams_used, wall_s=run.wall_s,
             stage_seconds=run.stage_seconds, late=late,
             tokens_equal=[o.tokens for o in got] == want,
             launches=rounds[f"{cfg.name} pipelined serve"], card=smi)
        if [o.tokens for o in got] != want:
            bad = [j for j, o in enumerate(got) if o.tokens != want[j]]
            raise AssertionError(f"{cfg.name} pipelined: requests {bad} differ from the "
                                 f"single-device server")
        if late:
            raise AssertionError(f"{cfg.name} pipelined: {late} first launches inside the serve")
    finally:
        pipe.close()
    del pipe, server, single

    # -- the host's counts beside the measured steps --------------------------
    def counted_cell(c, shape_, measured_s, bound_bytes=None):
        b = steps.input_specs(c, shape_, impl="ref", serving=True)
        t_ = time.perf_counter()
        cost = count_step(b.fn, *b.arg_specs)
        tokens = shape_.global_batch * (1 if shape_.kind == "decode" else shape_.seq_len)
        rep = analyze_step(arch=c.name, shape_name=shape_.name, kind=shape_.kind, cfg=c,
                           tokens=tokens, step_flops=cost.flops, step_bytes=cost.major_bytes)
        emit("step_count", config=c.name, layers=c.n_layers, cell=shape_.name,
             kind=shape_.kind, batch=shape_.global_batch, seq=shape_.seq_len,
             flops=cost.flops, major_bytes=cost.major_bytes, count_s=time.perf_counter() - t_,
             compute_ms=rep.compute_s * 1e3, memory_ms=rep.memory_s * 1e3,
             bottleneck=rep.bottleneck, step_time_bound_ms=rep.step_time_bound_s * 1e3,
             model_flops=rep.model_flops, useful_flops_ratio=rep.useful_flops_ratio,
             measured_ms=measured_s * 1e3, measured_over_bound=measured_s / max(
                 rep.step_time_bound_s, 1e-30),
             decode_stage_bytes=bound_bytes, hw=HW_H100.name, note=rep.note, card=smi)

    counted_cell(cfg, ShapeCfg(f"decode_B8_C{bucket + 32}", bucket + 32, 8, "decode"),
                 served["decode_step_p50_ms"] / 1e3, step_bytes)
    counted_cell(cfg, ShapeCfg(f"prefill_B8_S{bucket}", bucket, 8, "prefill"),
                 served["prefill_s"])
    qwen = get_config("qwen2.5-3b")
    counted_cell(qwen, ShapeCfg("decode_B8_C544", 544, 8, "decode"), decode_ms / 1e3,
                 served_bytes(qwen, 544))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # -- a float32 A/B of a 2-layer cut: every routing decision equal ---------
    cut = dataclasses.replace(first_layers(full, 2), compute_dtype="float32")
    refuse_above_2gb("hybrid_start", f"{cut.name}, 2 layers, float32", smi)
    params = lm.init_params(cut, device=dev, generator=gen(0))
    ab(cut, params, prompts, lambda _: MOE_F32_LOGIT_TOL)
    routing_ab(cut, params, prompts, strict=True, smi=smi)
    del params

    # -- one train step of the 2-layer cut, bf16 masters ----------------------
    # jamba's norms train past the row kernels: the plain gradient at 8192
    # and the gated at 16384 each on their cluster kernel
    train_kernels = dict(kernels, flash_attention_bwd=flash_attention_backward,
                         rmsnorm_bwd=rmsnorm_backward, ssd_scan_bwd=ssd_scan_backward,
                         rmsnorm_gated_bwd=rmsnorm_gated_backward,
                         rmsnorm_bwd_cluster=rn.rmsnorm_bwd_cluster,
                         rmsnorm_gated_bwd_cluster=rn.rmsnorm_gated_bwd_cluster)
    for k in ("fused_qkv_rope", "fused_out_residual", "decode_attention"):
        train_kernels.pop(k, None)
    cut_train_ab(dataclasses.replace(first_layers(full, 2), remat="full"), torch.bfloat16,
                 train_kernels, rounds, "hybrid", smi)
    gc.collect()
    torch.cuda.empty_cache()
    return rounds


def mesh_phase(cfg, prompts, smi, *, seq=4096, global_batch=8, grad_accum=4,
               max_new=32):
    """Phase 18: the one-rank mesh.  A process group of world 1 (NCCL on
    the card, from a file store under ``build/``) and `local_mesh(1)`, a
    (1, 1) ("data", "model") mesh; then

      (a) ``cfg`` trained by `train_loop` for 3 steps (the bigram data at
          ``seq``, ``global_batch``, ``grad_accum``; AdamW on float32
          masters), first without a mesh, then with ``mesh=`` and
          ``fsdp=True`` (parameters and optimizer state DTensors placed by
          the JAX specs): the losses must be equal bitwise or within 1e-3
          relative (the record says which);
      (b) one round of ``prompts`` (B 8, ``max_new`` tokens each) through
          ``LMServer(seed=0)`` without a mesh, then ``LMServer(seed=0,
          mesh=)``, each after a warm-up round: the tokens must be equal;
      (c) the meshed runs counted (`run_counted`): every kernel of the path
          launched (flash forward and backward, rmsnorm and its backward;
          rmsnorm, flash, decode attention and the chain's two GEMVs) and no
          plain version or `_composed_step` called, so DTensor ran the
          kernels on its local tensors and decomposed none;
      (d) step and decode times with and without the mesh beside the card;
      (e) the dry run's arguments of (a)'s training cell (`mesh_cell`) made
          on the card and placed on the mesh by the dry run's own
          `place_args`: the bytes of their local shards, and the
          allocator's growth over the placement (phase 20 holds the dry
          run's argument bytes of the same cell to both).

    Returns (the meshed round's tokens, {"train": launches, "serve":
    launches}, {"local_bytes", "allocated_growth_bytes"} of (e))."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_backward
    from repro_torch.kernels.fused_decode import out_residual, qkv_rope
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_backward
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.runtime.server import LMServer, Request
    from repro_torch.runtime.trainer import TrainLoopConfig, local_mesh, train_loop

    store = ROOT / "build" / "chip_smoke_mesh"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    init_distributed("cuda", rank=0, world_size=1,
                     store=dist.FileStore(str(store / "store"), 1))
    rounds: dict = {}
    try:
        mesh = local_mesh(1, device="cuda")
        backend = dist.get_backend()
        # (a) training without and with the mesh
        train_kernels = {"flash_attention": flash_attention,
                         "flash_attention_bwd": flash_attention_backward,
                         "rmsnorm": rmsnorm, "rmsnorm_bwd": rmsnorm_backward}
        base = dict(steps=3, seq_len=seq, global_batch=global_batch, grad_accum=grad_accum,
                    lr=3e-4, warmup=2, log_interval=1, seed=0, data_kind="bigram")
        plain = train_loop(cfg, TrainLoopConfig(**base), device="cuda")
        plain_losses = [plain.losses[i] for i in range(3)]
        plain_steps = [plain.step_seconds[i] for i in range(3)]
        del plain
        gc.collect()
        torch.cuda.empty_cache()
        meshed = run_counted("train", lambda: train_loop(
            cfg, TrainLoopConfig(**base, fsdp=True), device="cuda", mesh=mesh),
            train_kernels, rounds)
        mesh_losses = [meshed.losses[i] for i in range(3)]
        layout = {k: [repr(x) for x in p.placements]
                  for k, p in list(meshed.model.named_parameters())[:3]}
        dtensors = all(hasattr(p, "placements") for p in meshed.model.parameters())
        mesh_steps = [meshed.step_seconds[i] for i in range(3)]
        del meshed
        gc.collect()
        torch.cuda.empty_cache()
        rel = max(abs(a - b) / abs(b) for a, b in zip(mesh_losses, plain_losses))
        bitwise = mesh_losses == plain_losses
        emit("mesh_train", config=f"{cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}",
             mesh=f"(1, 1) data x model, {backend} world 1", fsdp=True, remat=cfg.remat, seq=seq,
             global_batch=global_batch, grad_accum=grad_accum, losses_plain=plain_losses,
             losses_mesh=mesh_losses, bitwise=bitwise, max_rel_diff=rel, tolerance=1e-3,
             params_are_dtensors=dtensors, placements=layout, step_s_plain=plain_steps,
             step_s_mesh=mesh_steps, launches=rounds["train"], card=smi)
        if not dtensors or not (bitwise or rel <= 1e-3):
            raise AssertionError(f"the meshed loop's losses {mesh_losses} differ from "
                                 f"{plain_losses} (rel {rel}), or its parameters are not "
                                 f"DTensors ({dtensors})")

        # (b) one serving round without and with the mesh
        serve_kernels = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
                         "fused_qkv_rope": qkv_rope, "decode_attention": decode_attention,
                         "fused_out_residual": out_residual}
        reqs = [Request(uid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
        warm = [Request(uid=i, prompt=p, max_new=2) for i, p in enumerate(prompts)]
        out = {}
        for label, kw in (("plain", dict(device="cuda")), ("mesh", dict(mesh=mesh))):
            server = LMServer(cfg, max_batch=8, seed=0, **kw)
            server.serve(warm)
            server.stats.decode_step_s.clear()
            if label == "mesh":
                comps = run_counted("serve", lambda: server.serve(reqs), serve_kernels, rounds)
            else:
                comps, rec = counted(lambda: server.serve(reqs), serve_kernels)
            steps = np.array(server.stats.decode_step_s)
            out[label] = dict(tokens=[c.tokens for c in comps],
                              decode_step_p50_ms=float(np.percentile(steps, 50) * 1e3),
                              decode_step_p90_ms=float(np.percentile(steps, 90) * 1e3),
                              prefill_s=comps[0].prefill_s, decode_s=comps[0].decode_s,
                              weights_are_dtensors=hasattr(server.params.embed, "placements"))
            del server, comps
            gc.collect()
            torch.cuda.empty_cache()
        same = out["mesh"]["tokens"] == out["plain"]["tokens"]
        emit("mesh_serve", config=f"{cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}",
             mesh=f"(1, 1) data x model, {backend} world 1", batch=len(reqs), max_new=max_new,
             tokens_equal=same, launches=rounds["serve"], card=smi,
             **{f"{k}_{label}": v[k] for label, v in out.items() for k in (
                 "decode_step_p50_ms", "decode_step_p90_ms", "prefill_s", "decode_s",
                 "weights_are_dtensors")})
        if not same or not out["mesh"]["weights_are_dtensors"]:
            raise AssertionError("the meshed server's tokens differ from the plain server's, "
                                 "or its weights are not DTensors")

        # (e) the dry run's arguments of (a)'s cell, made on the card and placed
        from repro_torch.launch import dryrun, steps
        from repro_torch.launch.sharding import tree_map
        cell_cfg, shape, policy = mesh_cell(cfg, seq, global_batch, grad_accum)
        b = steps.input_specs(cell_cfg, shape, impl="ref")

        def to_card(tree):
            return tree_map(lambda t: torch.empty_like(t, device="cuda"), tree)

        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        placed_args = dryrun.place_args(
            b.kind, (b.arg_specs[0].to_empty(device="cuda"), to_card(b.arg_specs[1]),
                     b.arg_specs[2], to_card(b.arg_specs[3])), mesh, cell_cfg, policy)
        torch.cuda.synchronize()
        placed = {"local_bytes": dryrun.local_bytes(placed_args),
                  "allocated_growth_bytes": torch.cuda.memory_allocated() - before}
        emit("mesh_placed", cell=f"{cell_cfg.name} train, seq {seq}, batch {global_batch}, "
             f"accum {grad_accum}, fsdp", mesh=f"(1, 1) data x model, {backend} world 1",
             **placed, card=smi)
        del placed_args, b
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return out["mesh"]["tokens"], rounds, placed


def mesh_cell(cfg, seq=4096, global_batch=8, grad_accum=4):
    """Phase 18's training cell of ``cfg`` as the dry run takes it: phase
    18's accumulation, its (seq, batch) shape, FSDP on."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch.sharding import ShardingPolicy
    return (dataclasses.replace(cfg, grad_accum=grad_accum),
            ShapeCfg("mesh_train", seq, global_batch, "train"), ShardingPolicy(fsdp=True))


# -- phase 20: the dry run, a host computation --------------------------------
DRYRUN_WHERE = ("host: one process as rank 0 of a fake process group, meta tensors; "
                "no device work")


def dryrun_mesh_cell() -> None:
    """Phase 20's run of `mesh_cell` (a process of its own): the dry run on
    a fake world of one, at the (1, 1) mesh; prints its result."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import device_mesh
    cfg, shape, policy = mesh_cell(get_config("qwen2.5-3b"))
    dryrun.join_fake_group(1)
    mesh = device_mesh((1, 1), ("data", "model"), device="cpu")
    print(json.dumps(dryrun.dry_run(cfg, shape, mesh, policy, arch=cfg.name, mesh_name="1x1")),
          flush=True)


def dryrun_phase(smi, placed: dict) -> None:
    """Phase 20: ``python -m repro_torch.launch.dryrun --no-save`` in
    processes of their own (this one holds no default group it could
    lend), at once: qwen2.5-3b's three runnable cells at 16x16 and jamba's
    ``long_500k`` at 2x16x16; and `mesh_cell` at (1, 1).  Each cell must
    print [OK]; qwen2.5-3b's FSDP training must move all-gather and
    reduce-scatter traffic; `mesh_cell`'s argument bytes must equal the
    local bytes phase 18 placed on the card, and the allocator's growth
    there (the independent witness) must cover them, by at most 0.1%
    more.  One record a cell (the bottleneck, the three terms, wire bytes
    by kind, argument GB a device, its process's seconds to its exit),
    each a host computation."""
    cli = [sys.executable, "-m", "repro_torch.launch.dryrun", "--no-save"]
    runs = {"qwen2.5-3b": cli + ["--arch", "qwen2.5-3b"],
            "jamba": cli + ["--arch", "jamba-1.5-large-398b", "--shape", "long_500k",
                            "--multi-pod"],
            "mesh_cell": [sys.executable, "-c", "import chip_smoke; chip_smoke.dryrun_mesh_cell()"]}
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(cmd, cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE) for k, cmd in runs.items()}
    outs, seconds = {}, {}

    def wait(k, p):     # each process's seconds from the common start to its own exit
        outs[k] = p.communicate(timeout=600)
        seconds[k] = time.perf_counter() - t0

    waits = [threading.Thread(target=wait, args=kp) for kp in procs.items()]
    try:
        for w in waits:
            w.start()
        for w in waits:
            w.join()
        if set(outs) != set(procs):
            raise AssertionError(f"dry runs {sorted(set(procs) - set(outs))} did not end "
                                 "within 600 s")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = {k: (p.returncode, [line for line in outs[k][0].splitlines()
                                 if line.startswith("[FAIL]")] or outs[k][1][-2000:])
              for k, p in procs.items() if p.returncode != 0 or "[FAIL]" in outs[k][0]}
    if failed:
        raise AssertionError(f"dry runs failed: {failed}")
    results = {k: [json.loads(line) for line in out.splitlines() if line.startswith("{")]
               for k, (out, _) in outs.items()}
    want = {("qwen2.5-3b", s, "16x16") for s in ("train_4k", "prefill_32k", "decode_32k")}
    want |= {("jamba-1.5-large-398b", "long_500k", "2x16x16"),
             ("qwen2.5-3b", "mesh_train", "1x1")}
    got = {(r["arch"], r["shape"], r["mesh"]): r for rs in results.values() for r in rs}
    if set(got) != want:
        raise AssertionError(f"the dry run's cells {sorted(got)} are not {sorted(want)}")
    for k, rs in results.items():
        for r in rs:
            roof = r["roofline"]
            emit("dryrun_cell", arch=r["arch"], shape=r["shape"], mesh=r["mesh"], kind=r["kind"],
                 n_devices=r["n_devices"], where=DRYRUN_WHERE, bottleneck=roof["bottleneck"],
                 compute_s=roof["compute_s"], memory_s=roof["memory_s"],
                 collective_s=roof["collective_s"], hlo_flops=roof["hlo_flops"],
                 hlo_bytes=roof["hlo_bytes"], wire_bytes=roof["collectives"]["wire_bytes"],
                 collective_counts=roof["collectives"]["counts"],
                 argument_gb=r["memory"]["argument_size"] / 1e9,
                 output_gb=r["memory"]["output_size"] / 1e9, lower_s=r["lower_s"],
                 process_s=seconds[k], card=smi)
    kinds = set(got["qwen2.5-3b", "train_4k", "16x16"]["roofline"]["collectives"]["counts"])
    if not {"all-gather", "reduce-scatter"} <= kinds:
        raise AssertionError(f"qwen2.5-3b's FSDP training moved {sorted(kinds)}, no "
                             "all-gather and reduce-scatter")
    # the independent witness is the allocator: what placement took on the card
    # must cover the dry run's argument bytes, above them by at most 0.1%
    args = got["qwen2.5-3b", "mesh_train", "1x1"]["memory"]["argument_size"]
    growth = placed["allocated_growth_bytes"]
    within = args <= growth <= args * 1.001
    emit("dryrun_card_check", cell="phase 18's training cell at (1, 1)",
         dry_run_argument_bytes=args, placed_local_bytes=placed["local_bytes"],
         placed_allocated_growth_bytes=growth, growth_over_args_bytes=growth - args,
         equal=args == placed["local_bytes"], growth_within_0p1pct=within, card=smi)
    if args != placed["local_bytes"]:
        raise AssertionError(f"the dry run's argument bytes {args} are not the "
                             f"{placed['local_bytes']} phase 18 placed on the card")
    if not within:
        raise AssertionError(f"the allocator grew by {growth} bytes placing the dry run's "
                             f"{args} argument bytes: not within [args, args + 0.1%]")


# -- phase 19: the pipelines over two ranks that share the card ---------------
# each rank's checks: the plain versions and `_composed_step` counted, set by
# `rank_count_begin` and read by `rank_count_end` on every rank's worker thread


def _plain_versions() -> list:
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_decode as fd
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ss
    return [(fa, "flash_attention_plain"), (da, "decode_attention_plain"),
            (rn, "rmsnorm_plain"), (fd, "fused_decode_plain"), (fd, "qkv_plain"),
            (fd, "out_residual_plain"), (ref, "mha_reference"), (ref, "decode_attention_ref"),
            (ref, "rmsnorm_reference"), (ss, "ssd_scan_plain"), (ref, "ssd_chunked"),
            (rn, "rmsnorm_gated_plain"), (ss, "ssd_chunked_backward"),
            (rn, "rmsnorm_gated_backward_plain")]


def rank_count_begin(pipe) -> None:
    """On one rank: every plain version counted from now on."""
    from repro_torch.kernels import fused_decode as fd
    calls = {}
    originals = {(m, a): getattr(m, a) for m, a in _plain_versions()}

    def counting(name, f):
        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return f(*a, **kw)
        return wrapped
    for (m, a), f in originals.items():
        setattr(m, a, counting(a, f))
    fd._composed_step.calls = 0
    pipe.plain_counted = (calls, originals)


def rank_count_end(pipe) -> dict:
    """On one rank: the plain versions restored; how often each ran, and
    `_composed_step`."""
    from repro_torch.kernels import fused_decode as fd
    calls, originals = pipe.plain_counted
    for (m, a), f in originals.items():
        setattr(m, a, f)
    return {"plain_calls": dict(calls), "composed_step": fd._composed_step.calls}


def rank_loss(lg):
    return (lg.float() ** 2).mean()


def _rank_kernels(pipe, names: list, res) -> dict:
    """{rank: kernels its ops must have launched}: the block stages'
    (``names``), and rmsnorm for the head; a serve's from the replicas its
    ops ran on (``res.op_trace``), a training run's from every replica (its
    microbatches reach each)."""
    out = {}
    if hasattr(pipe, "stage_ranks"):
        ran = {(name, rep) for name, _, _, rep, _, _ in res.op_trace}
        pairs = [(desc.span is not None, desc.has_head,
                  {ranks[rep] for rep in range(len(ranks)) if (desc.name, rep) in ran})
                 for desc, ranks in zip(pipe.stage_descs, pipe.stage_ranks)]
    else:
        pairs = [(st.name.startswith("block"), st.name == "head",
                  {r for sl in st.ranks for r in sl}) for st in pipe.stages]
    for blocks_, head, ranks in pairs:
        for r in ranks:
            need = out.setdefault(r, set())
            need |= set(names) if blocks_ else set()
            need |= {"rmsnorm"} if head else set()
    return {r: sorted(v) for r, v in out.items()}


def _rank_counted(pipe, fn, names, what):
    """Run ``fn`` on the controller with each rank's plain versions counted
    (none may run) and its launches read from the run's per-rank record;
    every rank must have launched the kernels of its stages."""
    pipe.call_ranks(rank_count_begin)
    try:
        out = fn()
    finally:
        counts = pipe.call_ranks(rank_count_end)
    costs = out.ranks
    need = _rank_kernels(pipe, names, out)
    for r, c in counts.items():
        if c["plain_calls"] or c["composed_step"]:
            raise AssertionError(f"{what}: rank {r} ran plain versions {c['plain_calls']}, "
                                 f"_composed_step {c['composed_step']} times")
        missing = [k for k in need.get(r, ()) if not costs[r]["launches"].get(k)]
        if missing:
            raise AssertionError(f"{what}: rank {r} launched no {missing}: "
                                 f"{costs[r]['launches']}")
    return out, {r: costs[r]["launches"] for r in sorted(costs)}


def rank_peak_reset(pipe) -> None:
    """On one rank: its process's peak-memory mark reset."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def rank_peak(pipe) -> int:
    """On one rank: its process's peak allocated bytes since the reset."""
    import torch
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def rank_drills(rank: int, pool, spec: dict):
    """Phase 19's (iv): phase 9's drills over the two ranks, qwen2.5-3b at
    full width and (ii)'s depth through a `DecodePipeline` at a quarter of
    its layers a stage (9 at full depth; each block stage's replicas
    alternate ranks, so ``blocks01`` r0 is on rank 0 and r1 on rank 1),
    phase 4's 8 requests in two groups of 4 (a failover needs a group on
    each replica), 32 new tokens: the uninterrupted serve; a crash of
    ``blocks01`` r1 at token 6 (its group's slices replayed on rank 0); a
    crash of ``blocks00`` r0 at its third op, serial; a stall of
    ``blocks01`` r1 driving a `HealthController` (a slice moved from rank 1
    to rank 0, re-plan advice); the lone embed replica's crash
    (`PipelineFailure`, then a plain serve; before the rescale, which lets
    rank 1's weights go); a pause after 8 tokens resumed on the same pool;
    another resumed on the successor `rescale_serving` builds at one chip
    on a pool of rank 0 alone at a third of the layers a stage (12) with
    the advice (the weights rank 0 lacks moved from rank 1, the slices
    replayed).  Each counted (`_rank_counted`), its peak memory by rank.
    On rank 0 returns the records, else None."""
    from repro_torch.analysis.roofline import HW_H100
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import planner
    from repro_torch.graphs import lm_graph
    from repro_torch.runtime.elastic import rescale_serving
    from repro_torch.runtime.failures import PipelineFailure, ReplicaFaultPlan
    from repro_torch.runtime.pipeline import DecodePipeline, HealthController, Tracer

    cfg = get_config("qwen2.5-3b")
    if spec["serve_layers"]:
        cfg = dataclasses.replace(cfg, n_layers=spec["serve_layers"])
    # four block stages (two at a cut: a stage needs two layers, so two replicas)
    pps, rescale_pps = max(2, cfg.n_layers // 4), max(1, cfg.n_layers // 3)
    shape = ShapeCfg("serve_decode", 512, 4, "decode")
    plan = planner.plan(cfg, shape, chips=1, hw=HW_H100, max_tp=1)
    stg, _ = lm_graph.build_stg(cfg, shape, hw=HW_H100, max_tp=1)
    pipe = DecodePipeline(cfg, stg, plan, devices=pool, seed=0, periods_per_stage=pps)
    if rank != 0:
        pipe.work()
        return None
    names = ["rmsnorm", "flash_attention", "fused_qkv_rope", "decode_attention",
             "fused_out_residual"]
    prompts = spec["prompts"]["qwen2.5-3b"]
    pipe.warm(prompts, 32, group_size=4)
    pipe.warm(prompts, 32, group_size=4, overlap=False)
    out = {"stages": pipe.stage_names, "stage_ranks": pipe.stage_ranks, "drills": [],
           "launches": {}}

    def drill(label, target, fn, need=names, **extra):
        target.call_ranks(rank_peak_reset)
        t0 = time.perf_counter()
        res, by_rank = _rank_counted(target, fn, need, f"2-rank drill {label}")
        rec = dict(drill=label, seconds=time.perf_counter() - t0, tokens=res.tokens,
                   paused=res.paused, late=target.compile_stats.late,
                   failovers=res.failovers, migrations=res.migrations, adopted=res.adopted,
                   launches_by_rank=by_rank,
                   bytes_sent_by_rank={r: c["bytes_sent"] for r, c in res.ranks.items()},
                   bytes_moved_by_rank={r: c["bytes_moved"] for r, c in res.ranks.items()},
                   host_s_by_rank={r: c["host_s"] for r, c in res.ranks.items()},
                   drill_peak_memory_by_rank=target.call_ranks(rank_peak), **extra)
        out["drills"].append(rec)
        out["launches"][f"drill {label}"] = by_rank
        if rec["late"]:
            raise AssertionError(f"2-rank drill {label}: {rec['late']} late calls")
        return res, rec

    drill("uninterrupted, two groups of 4", pipe,
          lambda: pipe.serve(prompts, 32, group_size=4))
    for label, fault, kw in (("crash blocks01:r1@tok6", "blocks01:r1@tok6=crash", {}),
                             ("crash blocks00:r0@op3 overlap=False", "blocks00:r0@op3=crash",
                              {"overlap": False})):
        inj = ReplicaFaultPlan.parse(fault)
        res, rec = drill(label, pipe, lambda: pipe.serve(prompts, 32, group_size=4,
                                                         injector=inj, **kw))
        rec["fired"] = inj.fired
        if inj.fired != 1 or len(res.failovers) != 1:
            raise AssertionError(f"2-rank drill {label}: fired {inj.fired}, "
                                 f"failovers {res.failovers}")

    tracer = Tracer()
    hc = HealthController(tracer=tracer, threshold=1.5, min_samples=4, check_every=1,
                          replan_after=2)
    stall = ReplicaFaultPlan.parse("blocks01:r1@op1=stall:0.03x999")
    res, rec = drill("stall blocks01:r1@op1 x0.03s, health", pipe, lambda: pipe.serve(
        prompts, 32, group_size=4, tracer=tracer, injector=stall, health=hc))
    rec.update(fired=stall.fired, health_migrations=hc.migrations, advice=hc.replan_advice,
               stage_host_s_by_rank={f"{s}@{r}": v for (s, r), v in tracer.rank_host_s.items()})
    slow = pipe.stage_ranks[pipe.stage_names.index("blocks01")][1]     # rank 1 at 9 a stage
    away = [m for m in res.migrations if m["from_rank"] == slow != m["to_rank"]]
    rec["moved_away"] = away
    if not away or not hc.replan_advice:
        raise AssertionError(f"2-rank health drill: migrations {res.migrations}, advice "
                             f"{hc.replan_advice}")

    try:
        pipe.serve(prompts, 32, group_size=4,
                   injector=ReplicaFaultPlan.parse("embed:r0@op2=crash"))
        raise AssertionError("2-rank drill: a crash of the lone embed replica did not raise")
    except PipelineFailure as e:
        need = {"fifo_occupancy", "waiting", "schedule", "reorder_occupancy", "lost_ops",
                "failovers", "static_preflight"}
        out["escalation"] = dict(stage=e.stage, replica=e.replica, reason=e.reason,
                                 bundle_keys=sorted(e.diagnostics),
                                 lost_ops=e.diagnostics.get("lost_ops"))
        if (e.stage, e.replica) != ("embed", 0) or not need <= set(e.diagnostics):
            raise AssertionError(f"2-rank escalation: {out['escalation']}")
    drill("plain serve after the escalation", pipe,
          lambda: pipe.serve(prompts, 32, group_size=4))

    def pause():
        return pipe.serve(prompts, 32, group_size=4, pause_after_tokens=8)

    paused, _ = drill("pause after 8 tokens, to resume here", pipe, pause)
    # no prefill on this path: every slice adopted where it is
    drill("resume on the same pool", pipe, lambda: pipe.resume(paused.resume_state),
          need=[k for k in names if k != "flash_attention"])
    paused, _ = drill("pause after 8 tokens, to rescale", pipe, pause)
    t0 = time.perf_counter()
    rs = rescale_serving(pipe, cfg, shape, plan, new_chips=1, stg=stg, devices=[0],
                         periods_per_stage=rescale_pps,
                         measured_ratio=hc.replan_advice, hw=HW_H100, max_tp=1)
    rescale_s = time.perf_counter() - t0
    succ = rs.pipe
    succ.warm(prompts, 32, group_size=4)        # and its preflight (plain versions)
    drill("resume on the successor, rank 0 alone", succ,
          lambda: succ.resume(paused.resume_state), layers_a_stage=rescale_pps,
          rescale=rs.summary(),
          rescale_s=rescale_s, successor_stages=succ.stage_names,
          weights_moved=succ.weights_moved, weights_held=succ.weights_held)
    succ.close()
    pipe.close()
    return out


def ranks_child(rank: int, spec: dict) -> None:
    """One of the two ranks of phase 19 (a process of its own): a gloo group
    of world 2 on the one card, a pool of both ranks with host-staged gloo
    transfers; (i) training, (ii) and (iii) serving, as `ranks_phase`
    says.  Rank 0 writes what it measured to ``spec["out"]``."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.analysis.roofline import HW_H100
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import planner
    from repro_torch.graphs import lm_graph
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import init_distributed, rank_pool
    from repro_torch.runtime.failures import (PipelineFailure, ReplicaFaultPlan,
                                              ReplicaFaultSpec)
    from repro_torch.runtime.pipeline import (DecodePipeline, LMPipeline, interleaved_1f1b,
                                              selection_from_plan)
    from repro_torch.runtime.server import Request

    torch.set_num_threads(4)
    init_distributed("cuda", rank=rank, world_size=2, backend="gloo", card=0,
                     init_method=f"file://{spec['store']}")
    out = {"rank": rank, "device": torch.cuda.get_device_name(0)}
    try:
        lib = build.BUILD_ROOT / build._digest() / "libkernels.so"
        out["library"] = {"path": str(lib.relative_to(ROOT)), "built_before": lib.exists()}
        build.library()
        pool = rank_pool(device="cuda", transport="gloo", timeout_s=900)
        train_kernels = ["flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd"]

        # (i) training, qwen2.5-3b at full width cut in depth
        cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=spec["layers"])
        shape = ShapeCfg("train_rank", 1024, 8, "train")
        plan = planner.plan(cfg, shape, chips=1, hw=HW_H100, max_tp=1)
        stg, _ = lm_graph.build_stg(cfg, shape, hw=HW_H100, max_tp=1)
        sel = selection_from_plan(plan)
        M = cfg.n_layers + 2
        rng = np.random.default_rng(19)
        mbs = [rng.integers(0, cfg.vocab, (1, 1024)).astype(np.int64) for _ in range(8)]
        sched = interleaved_1f1b(2, 8, M // 2)
        pipe = LMPipeline(cfg, stg, sel, devices=pool)
        train = {"config": f"{cfg.name} cut to {cfg.n_layers} layers, d_model {cfg.d_model}",
                 "stages": M, "slices": [st.ranks for st in pipe.stages],
                 "held": {rank: sorted(pipe.modules)}}
        if rank != 0:
            pipe.work()
        else:
            runs = {}
            for label, kw in (("1f1b", {}), ("interleaved", {"schedule": sched})):
                pipe.warm(mbs, train=True, loss_fn=rank_loss, **kw)
                res, launches = _rank_counted(
                    pipe, lambda: pipe.run(mbs, train=True, loss_fn=rank_loss, **kw),
                    train_kernels, f"2-rank {label}")
                runs[label] = res
                train[label] = {"wall_s": res.wall_s, "tok_per_s": res.tokens_per_s(1024),
                                "launches_by_rank": launches,
                                "bytes_sent_by_rank": {r: c["bytes_sent"]
                                                       for r, c in res.ranks.items()},
                                "host_s_by_rank": {r: c["host_s"] for r, c in res.ranks.items()},
                                "late": pipe.compile_stats.late, "streams": res.streams_used}
            # a crash on a single-replica block stage escalates (no failover
            # hook); every rank drained, the pool's next 1F1B run is clean
            inj = ReplicaFaultPlan(faults=[ReplicaFaultSpec(pipe.stages[1].name, 0, at=2)])
            t0 = time.perf_counter()
            try:
                pipe.run(mbs, train=True, loss_fn=rank_loss, injector=inj)
                raise AssertionError("2-rank training: an injected crash did not escalate")
            except PipelineFailure as e:
                esc = dict(stage=e.stage, replica=e.replica, reason=e.reason,
                           no_failover_hook="no failover hook" in str(e),
                           bundle_keys=sorted(e.diagnostics),
                           lost_ops=e.diagnostics.get("lost_ops"),
                           seconds=time.perf_counter() - t0)
            again, launches = _rank_counted(
                pipe, lambda: pipe.run(mbs, train=True, loss_fn=rank_loss), train_kernels,
                "2-rank 1f1b after the escalation")
            first = runs["1f1b"]
            esc.update(again_wall_s=again.wall_s, launches_by_rank=launches,
                       late=pipe.compile_stats.late, losses_bitwise=again.losses == first.losses,
                       grads_bitwise=all(torch.equal(g, first.grads[n][k])
                                         for n, tree in again.grads.items()
                                         for k, g in tree.items()))
            train["escalation"] = esc
            del again
            pipe.close()
            del pipe
            gc.collect()
            one = LMPipeline(cfg, stg, sel, devices=["cuda"])
            for label, kw in (("1f1b", {}), ("interleaved", {"schedule": sched})):
                one.warm(mbs, train=True, loss_fn=rank_loss, **kw)
                ref = one.run(mbs, train=True, loss_fn=rank_loss, **kw)
                got = runs[label]
                differ = [f"{n}.{k}" for n, tree in ref.grads.items() for k, g in tree.items()
                          if not torch.equal(g, got.grads[n][k])]
                train[label].update(one_rank_wall_s=ref.wall_s,
                                    one_rank_tok_per_s=ref.tokens_per_s(1024),
                                    losses_bitwise=got.losses == ref.losses,
                                    grads_bitwise=not differ, grads_differ=differ[:8],
                                    n_grad_leaves=sum(len(t) for t in ref.grads.values()))
                del ref
            one.close()
            # every gradient of the cut, fetched here: let it go before (ii)-(iv)
            del one, runs, res, first, got
        gc.collect()
        torch.cuda.empty_cache()
        out["train"] = train

        # (ii), (iii) serving at full width and depth, phase 4's requests
        for name, pps, names in (("qwen2.5-3b", 9, ["rmsnorm", "flash_attention",
                                                     "fused_qkv_rope", "decode_attention",
                                                     "fused_out_residual"]),
                                 ("mamba2-370m", 12, ["rmsnorm", "ssd_scan", "rmsnorm_gated"])):
            cfg = get_config(name)
            if spec["serve_layers"]:
                cfg = dataclasses.replace(cfg, n_layers=spec["serve_layers"])
            pps = min(pps, cfg.n_periods)
            shape = ShapeCfg("serve_decode", 512, 8, "decode")
            plan = planner.plan(cfg, shape, chips=1, hw=HW_H100, max_tp=1)
            stg, _ = lm_graph.build_stg(cfg, shape, hw=HW_H100, max_tp=1)
            reqs = [Request(uid=i, prompt=p, max_new=32)
                    for i, p in enumerate(spec["prompts"][name])]
            pipe = DecodePipeline(cfg, stg, plan, devices=pool, seed=0, periods_per_stage=pps)
            rec = {"stages": pipe.stage_names, "stage_ranks": pipe.stage_ranks,
                   "held": {rank: sum(p.numel() for p in pipe.params.parameters()
                                      if p.device.type != "meta")}}
            if rank != 0:
                pipe.work()
            else:
                prompts = [r.prompt for r in reqs]
                pipe.warm(prompts, 32, group_size=8)
                res, launches = _rank_counted(
                    pipe, lambda: pipe.serve(prompts, 32, group_size=8),
                    names, f"2-rank {name} serve")
                gen = res.decode_tokens
                rec.update(tokens=res.tokens, wall_s=res.wall_s, generated=gen,
                           tok_per_s=gen / res.wall_s, launches_by_rank=launches,
                           bytes_sent_by_rank={r: c["bytes_sent"] for r, c in res.ranks.items()},
                           host_s_by_rank={r: c["host_s"] for r, c in res.ranks.items()},
                           late=pipe.compile_stats.late, streams=res.streams_used)
                pipe.close()
                del pipe
                gc.collect()
                one = DecodePipeline(cfg, stg, plan, devices=["cuda"], seed=0,
                                     periods_per_stage=pps)
                one.warm(prompts, 32, group_size=8)
                ref = one.serve(prompts, 32, group_size=8)
                rec.update(one_rank_wall_s=ref.wall_s,
                           one_rank_tok_per_s=ref.decode_tokens / ref.wall_s,
                           one_rank_tokens_equal=ref.tokens == res.tokens)
                one.close()
                del one
            gc.collect()
            torch.cuda.empty_cache()
            out[name] = rec

        # (iv) the drills, on the same two ranks
        out["peak_memory"] = torch.cuda.max_memory_allocated()
        out["drills"] = rank_drills(rank, pool, spec)
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    with open(spec["out"] + f".rank{rank}", "wb") as fh:
        pickle.dump(out, fh)


def ranks_phase(smi, prompts: dict, *, layers: int = 8,
                serve_layers: int | None = None) -> tuple[dict, dict]:
    """Phase 19: the pipelines over ranks, two processes sharing the one card
    (gloo: NCCL refuses two ranks on one card, and gloo sends host copies
    of the card's tensors).  ``prompts``: phase 4's, by model.  The ranks
    (`ranks_child`) run
      (i) qwen2.5-3b at full width cut to ``layers`` layers, an
          `LMPipeline` over both ranks (the stage a layer, the plan's slices
          alternating ranks), 1F1B and interleaved 1F1B (2 programs),
          8 microbatches of (1, 1024), then the one-rank `LMPipeline` on the
          same weights in rank 0: losses and every gradient bitwise;
      (ii) qwen2.5-3b and (iii) mamba2-370m at full width and depth through
          a `DecodePipeline` over both ranks (9 and 12 layers a stage),
          phase 4's 8 requests in one group of 8, then the one-rank
          pipeline in rank 0;
      (iv) phase 9's drills over the two ranks (`rank_drills`): each
          drill's tokens equal the uninterrupted two-rank serve's in two
          groups of 4 (which the caller holds to phase 4's); and (i) gains
          a crash that escalates, then a 1F1B run bitwise the first;
    each two-rank run counted: every rank ran no plain version and launched
    every kernel of its stages.  tp > 1 needs the collectives gloo lacks
    for CUDA tensors, so it runs on the CPU only (tests).  Returns the
    served tokens by model (and (iv)'s, under ``"drills"``), and the
    per-rank launches by run.
    ``serve_layers`` cuts (ii), (iii) and (iv) in depth (a card test's
    short run)."""
    import pickle
    import shutil

    import torch
    import torch.multiprocessing as mp

    from repro_torch.kernels import build
    build.build()                         # the ranks load this library, built once
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    work = ROOT / "build" / "chip_smoke_ranks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    spec = {"store": str(work / "store"), "out": str(work / "out"), "layers": layers,
            "prompts": prompts, "serve_layers": serve_layers}
    t0 = time.perf_counter()
    ctx = None
    try:
        ctx = mp.start_processes(ranks_child, args=(spec,), nprocs=2, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + 900
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError("phase 19's ranks did not finish in 900 s")
        results = []
        for r in range(2):
            with open(spec["out"] + f".rank{r}", "rb") as fh:
                results.append(pickle.load(fh))
    finally:
        for proc in ctx.processes if ctx is not None else ():
            if proc.is_alive():
                proc.kill()
                proc.join()
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t0
    r0 = results[0]
    base = dict(card=smi, compute_mode=mode, world=2, transport="gloo, host-staged copies",
                note="two processes on one card: not a multi-card measurement",
                library={r["rank"]: r["library"] for r in results},
                peak_memory_by_rank={r["rank"]: r["peak_memory"] for r in results})
    train = dict(r0["train"])
    for r in results[1:]:
        train["held"].update(r["train"]["held"])
    emit("ranks_train", **base, **train)
    if not all(r["library"]["built_before"] for r in results):
        raise AssertionError(f"a rank built its own kernel library: {base['library']}")
    for label in ("1f1b", "interleaved"):
        t = train[label]
        if not (t["losses_bitwise"] and t["grads_bitwise"]) or t["late"]:
            raise AssertionError(f"the 2-rank {label} run differs from the one-rank pipeline "
                                 f"(losses bitwise {t['losses_bitwise']}, leaves "
                                 f"{t['grads_differ']}) or made {t['late']} late calls")
    tokens, launches = {}, {f"train {k}": train[k]["launches_by_rank"]
                            for k in ("1f1b", "interleaved")}
    for name in ("qwen2.5-3b", "mamba2-370m"):
        rec = dict(r0[name])
        for r in results[1:]:
            rec["held"].update(r[name]["held"])
        emit("ranks_serve", **base, config=name, **{k: v for k, v in rec.items()
                                                    if k != "tokens"})
        if not rec["one_rank_tokens_equal"] or rec["late"]:
            raise AssertionError(f"the 2-rank {name} serve differs from the one-rank "
                                 f"pipeline's, or made {rec['late']} late calls")
        tokens[name] = rec["tokens"]
        launches[f"serve {name}"] = rec["launches_by_rank"]
    esc = train["escalation"]
    if not (esc["no_failover_hook"] and esc["losses_bitwise"]
                                and esc["grads_bitwise"] and not esc["late"]):
        raise AssertionError(f"2-rank training escalation: {esc}")
    tokens["drills"] = rank_drill_records(base, r0["drills"])
    launches.update(r0["drills"]["launches"])
    emit("ranks_phase_wall", seconds=wall, card=smi)
    return tokens, launches


def rank_drill_records(base: dict, drills: dict) -> list:
    """Emit (iv)'s records, hold each drill's tokens (the pauses aside) to
    the uninterrupted two-rank serve's, and return those."""
    ref = drills["drills"][0]["tokens"]
    for rec in drills["drills"]:
        checked = not rec["paused"]
        emit("ranks_drill", **base, config="qwen2.5-3b", stages=drills["stages"],
             stage_ranks=drills["stage_ranks"],
             tokens_equal_uninterrupted=rec["tokens"] == ref if checked else None,
             **{k: v for k, v in rec.items() if k != "tokens"})
        if checked and rec["tokens"] != ref:
            raise AssertionError(f"2-rank drill {rec['drill']}: tokens differ from the "
                                 "uninterrupted serve's")
    emit("ranks_escalation", **base, config="qwen2.5-3b", **drills["escalation"])
    return ref


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import fused_decode as fd
    from repro_torch.kernels.decode_attention import (decode_attention, decode_attention_plain,
                                                      split_plan)
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_decode import (fused_decode, fused_decode_plain,
                                                  out_residual, qkv_rope)
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_gated, rmsnorm_gated_plain,
                                             rmsnorm_plain)
    from repro_torch.kernels.ssd_scan import blocks_per_sm, ssd_scan, ssd_scan_plain
    from repro_torch.probes.wide_norms import wide_plans
    from repro_torch.analysis.roofline import HW_H100
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import planner
    from repro_torch.graphs import lm_graph
    from repro_torch.models import blocks, lm
    from repro_torch.runtime.pipeline import DecodePipeline, Tracer, stall_bottleneck
    from repro_torch.probes.busy import kernel_busy
    from repro_torch.runtime.server import LMServer, Request, ServeStats, _bucket

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    smi = nvidia_smi_line()

    # -- 1. device and toolchain ------------------------------------------
    nvcc_v = subprocess.run([build.nvcc(), "--version"], capture_output=True, text=True,
                            timeout=60).stdout.strip().splitlines()[-2:]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    try:
        import scipy
        scipy_v = scipy.__version__
    except ImportError:
        scipy_v = None
    emit("toolchain", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc_v,
         python=sys.version.split()[0], triton=triton_v, scipy=scipy_v)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build()
    build_s = time.perf_counter() - t0
    build.library()
    # the bf16 flash backward must run on wgmma, fed by tensor copies
    sass = sass_record(lib_path, ("flash_bwd_", "rmsnorm_bwd"))
    emit("build", seconds=round(build_s, 3), library=str(lib_path.relative_to(ROOT)),
         flags=build.FLAGS, ptxas=ptxas_report(build.build_log()), sass=sass)
    for name in ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel"):
        found = [c for k, c in sass.items() if k.startswith(name)]
        if not found or not all(c["HGMMA"] and c["UTMALDG"] for c in found):
            raise AssertionError(f"{name}: no HGMMA or no UTMALDG in its machine code: {sass}")

    # -- 3. kernels against their plain versions on the card ---------------
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    errors: dict[str, float] = {}

    def check(kernel: str, case: str, got, want, atol=ATOL, rtol=RTOL):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        bad = int((err > atol + rtol * want.float().abs()).sum())
        emit("check", kernel=kernel, case=case, max_abs_err=float(err.max()),
             tolerance=f"|d| <= {atol} + {rtol}*|plain|", ok=bad == 0)
        if bad:
            raise AssertionError(f"{kernel} {case}: {bad} elements out of tolerance")
        errors[kernel] = max(errors.get(kernel, 0.0), float(err.max()))

    # the norms: mamba2-370m's width (1024), qwen's (2048), danube's (3840)
    # and 1000 (a ragged number of 16-byte pieces a lane) at decode and
    # prefill rows and at 5000 (rows off the persistent grid); widths off 16
    # bytes (1001) and beyond the row kernel (20000), an input off 16 bytes
    def norm_check(case, x, w):
        tol = ATOL if x.dtype == bf16 else F32_TOL
        check("rmsnorm", f"{case} {x.dtype}", rmsnorm(x, w), rmsnorm_plain(x, w), tol, tol)

    for dtype in (bf16, torch.float32):
        for d in (1024, 2048, 3840, 1000):
            for rows in (8, 8 * 512, 5000):
                norm_check(f"({rows}, {d})", randn(rows, d, dtype=dtype),
                           randn(d, dtype=torch.float32))
        for rows, d in ((3, 1001), (2, 20000)):
            norm_check(f"({rows}, {d})", randn(rows, d, dtype=dtype), randn(d, dtype=torch.float32))
        norm_check("(8, 2048) off 16 bytes", randn(8 * 2048 + 1, dtype=dtype)[1:].view(8, 2048),
                   randn(2048, dtype=torch.float32))

    # the gated form at mamba2-370m's decode (8 rows) and prefill (8 x 512),
    # H32 P64, z the second half of the in-projection (rows 4096 apart); and
    # mamba2-2.7b's width (5120), beyond the row kernel
    def gated_inputs(lead, h=32, p=64, dtype=bf16):
        return (randn(*lead, h, p, dtype=dtype), randn(*lead, h, p, dtype=dtype),
                1.0 + 0.1 * randn(h, dtype=torch.float32),
                torch.chunk(randn(*lead, 2 * h * p, dtype=dtype), 2, dim=-1)[1],
                1.0 + 0.1 * randn(h * p, dtype=torch.float32))

    for dtype in (bf16, torch.float32):
        tol = ATOL if dtype == bf16 else F32_TOL
        for lead, h in (((8,), 32), ((8, 512), 32), ((2, 3), 80)):
            args = gated_inputs(lead, h, dtype=dtype)
            check("rmsnorm_gated", f"{lead} H{h} P64 {dtype}, z rows {args[3].stride(-2)} apart",
                  rmsnorm_gated(*args), rmsnorm_gated_plain(*args), tol, tol)
    # qwen's and danube's prefill, then a length off every tile (Sq 129) and GQA 7
    for b, s, h, kv, d, window in ((8, 512, 16, 2, 128, None), (2, 512, 32, 8, 120, 64),
                                   (2, 129, 16, 2, 128, None), (2, 200, 14, 2, 128, None)):
        q, k, v = randn(b, s, h, d), randn(b, s, kv, d), randn(b, s, kv, d)
        check("flash_attention", f"B{b} S{s} H{h} KV{kv} D{d} causal window={window}",
              flash_attention(q, k, v, window=window),
              flash_attention_plain(q, k, v, window=window))
    b, h, kv, hd, c = 8, 16, 2, 128, 544
    q, kc, vc = randn(b, h, hd), randn(b, c, kv, hd), randn(b, c, kv, hd)
    for lens in (1, 100, 544, [1, 37, 100, 255, 256, 400, 543, 544]):
        clen = torch.tensor(lens, dtype=torch.int32, device=dev)
        check("decode_attention", f"B{b} H{h} KV{kv} hd{hd} C{c} cache_len={lens}",
              decode_attention(q, kc, vc, clen), decode_attention_plain(q, kc, vc, clen))
    # the split edges of this shape's plan (L slots a split): cache_len at L -
    # 1, L and L + 1, a window straddling splits 1 and 2, per-sequence lengths
    # that leave whole splits empty; then those calls back to back on one
    # workspace, each result checked after the last (the merge counters reset)
    L = split_plan(b, kv, c, torch.cuda.get_device_properties(dev).multi_processor_count).length
    split_cases = [(L - 1, None), (L, None), (L + 1, None), (2 * L + 10, L),
                   ([1, L, 3 * L + 5, c, 2, L + 1, 100, 7 * L], None)]
    for lens, window in split_cases:
        clen = torch.tensor(lens, dtype=torch.int32, device=dev)
        check("decode_attention", f"B{b} H{h} KV{kv} hd{hd} C{c} split {L}: cache_len={lens} "
              f"window={window}", decode_attention(q, kc, vc, clen, window=window),
              decode_attention_plain(q, kc, vc, clen, window=window))
    lens = [torch.tensor(n, dtype=torch.int32, device=dev) for n, _ in split_cases]
    outs = [decode_attention(q, kc, vc, n, window=w) for n, (_, w) in zip(lens, split_cases)]
    for n, (_, w), got in zip(lens, split_cases, outs):
        check("decode_attention", f"B{b} H{h} KV{kv} hd{hd} C{c} back to back: "
              f"cache_len={n.tolist()} window={w}", got,
              decode_attention_plain(q, kc, vc, n, window=w))
    # two streams at once at this shape (the pipeline's stages and replicas
    # run decode attention so): each stream has its own partial sums and
    # merge counters; calls alternate between the streams, and every
    # result is checked after the last
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    calls = [[(randn(b, h, hd), randn(b, c, kv, hd), randn(b, c, kv, hd),
               torch.tensor(n, dtype=torch.int32, device=dev)) for n, _ in split_cases]
             for _ in streams]
    torch.cuda.synchronize()
    outs = [[], []]
    for i in range(len(split_cases)):
        for s_, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                outs[s_].append(decode_attention(*calls[s_][i]))
    torch.cuda.synchronize()
    for s_ in range(2):
        for args, got in zip(calls[s_], outs[s_]):
            check("decode_attention", f"B{b} H{h} KV{kv} hd{hd} C{c} two streams at once, "
                  f"stream {s_}: cache_len={args[3].tolist()}", got,
                  decode_attention_plain(*args))
    del streams, calls, outs
    q, kc, vc = randn(4, 32, 120), randn(4, 300, 8, 120), randn(4, 300, 8, 120)
    clen = torch.tensor([300, 120, 64, 9], dtype=torch.int32, device=dev)
    check("decode_attention", "B4 H32 KV8 hd120 C300 per-sequence lengths window=64",
          decode_attention(q, kc, vc, clen, window=64),
          decode_attention_plain(q, kc, vc, clen, window=64))

    # the fused chain: qwen's sublayer (with bias) in the growing (C544 pos
    # 300), boundary (C64 pos 64) and wrapped (C64 pos 200) ring states,
    # and danube's (no bias, hd 120)
    def sublayer(b, d, h, kv, hd, c, bias, dtype=bf16):
        def mat(*shape, fan=None):
            return (torch.randn(shape, generator=gen, device=dev) *
                    (fan ** -0.5 if fan else 1.0)).to(dtype)
        w = dict(norm=1.0 + 0.1 * randn(d, dtype=torch.float32),
                 wq=mat(d, h * hd, fan=d), wk=mat(d, kv * hd, fan=d), wv=mat(d, kv * hd, fan=d),
                 wo=mat(h * hd, d, fan=h * hd), bq=mat(h * hd, fan=100) if bias else None,
                 bk=mat(kv * hd, fan=100) if bias else None,
                 bv=mat(kv * hd, fan=100) if bias else None)
        return (randn(b, 1, d, dtype=dtype), randn(b, c, kv, hd, dtype=dtype),
                randn(b, c, kv, hd, dtype=dtype),
                dict(w, n_heads=h, head_dim=hd, eps=1e-6, theta=1e6, scale=hd ** -0.5))

    for label, (d, h, kv, hd, bias) in (("qwen", (2048, 16, 2, 128, True)),
                                         ("danube", (3840, 32, 8, 120, False))):
        for c, pos in ((544, 300), (64, 64), (64, 200)):
            x, kc, vc, kw = sublayer(8, d, h, kv, hd, c, bias)
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            want, k_new, v_new = fused_decode_plain(x[:, 0], kc, vc, p, **kw)
            k0, v0 = kc.clone(), vc.clone()
            got = fused_decode(x, kc, vc, p, **kw)
            case = f"{label} B8 D{d} H{h} KV{kv} hd{hd} bias={bias} C{c} pos {pos}"
            check("fused_decode", case + ": out", got[:, 0], want)
            check("fused_decode", case + ": slot k", kc[:, pos % c], k_new)
            check("fused_decode", case + ": slot v", vc[:, pos % c], v_new)
            rest = [i for i in range(c) if i != pos % c]
            if not (torch.equal(kc[:, rest], k0[:, rest]) and torch.equal(vc[:, rest], v0[:, rest])):
                raise AssertionError(f"fused_decode {case}: a slot other than pos % C changed")

    # nemotron-4-15b's and deepseek-coder-33b's serving shapes (phase 12):
    # the chain at widths 6144 and 7168 (qkv_rope's 64 and 72 tiles, at B 16
    # two batch groups, where deepseek-coder-33b's block needs two splits to
    # fit shared memory), flash prefill and decode attention at H48/KV8 and
    # H56/KV8, hd 128
    for label, (d, h, kv, hd) in large_shapes().items():
        for b_ in (8, 16):
            x, kc, vc, kw = sublayer(b_, d, h, kv, hd, 544, False)
            p = torch.tensor(543, dtype=torch.int32, device=dev)
            want, k_new, v_new = fused_decode_plain(x[:, 0], kc, vc, p, **kw)
            got = fused_decode(x, kc, vc, p, **kw)
            case = f"{label} B{b_} D{d} H{h} KV{kv} hd{hd} C544 pos 543"
            check("fused_decode", case + ": out", got[:, 0], want)
            check("fused_decode", case + ": slot k", kc[:, 543], k_new)
            check("fused_decode", case + ": slot v", vc[:, 543], v_new)
            del x, kc, vc, kw
        q, k, v = randn(2, 512, h, hd), randn(2, 512, kv, hd), randn(2, 512, kv, hd)
        check("flash_attention", f"{label} B2 S512 H{h} KV{kv} D{hd} causal",
              flash_attention(q, k, v), flash_attention_plain(q, k, v))
        q, kc, vc = randn(8, h, hd), randn(8, 544, kv, hd), randn(8, 544, kv, hd)
        for lens in (544, [1, 37, 100, 255, 256, 400, 543, 544]):
            clen = torch.tensor(lens, dtype=torch.int32, device=dev)
            check("decode_attention", f"{label} B8 H{h} KV{kv} hd{hd} C544 cache_len={lens}",
                  decode_attention(q, kc, vc, clen), decode_attention_plain(q, kc, vc, clen))
        del q, k, v, kc, vc

    # the llama4 MoE decoders' attention (phase 15): H40 KV8 hd128 (GQA 5) at
    # d_model 5120, in bf16 and float32: flash causal over the prefill bucket
    # (B8 S512) and a ragged length (B2 S300), decode attention at the
    # round's last step (C544) and at ragged lengths, the chain at B 8 and 16
    # (two batch groups of the GEMVs) at the round's last step
    d, h, kv, hd = attention_shape(MOE[0])
    for dtype in (bf16, torch.float32):
        tol = ATOL if dtype == bf16 else F32_TOL
        for b, s in ((8, 512), (2, 300)):
            q = randn(b, s, h, hd, dtype=dtype)
            k, v = randn(b, s, kv, hd, dtype=dtype), randn(b, s, kv, hd, dtype=dtype)
            check("flash_attention", f"llama4 B{b} S{s} H{h} KV{kv} D{hd} causal {dtype}",
                  flash_attention(q, k, v), flash_attention_plain(q, k, v), tol, tol)
        q, kc, vc = (randn(8, h, hd, dtype=dtype), randn(8, 544, kv, hd, dtype=dtype),
                     randn(8, 544, kv, hd, dtype=dtype))
        for lens in (544, [1, 37, 100, 255, 256, 400, 543, 544]):
            clen = torch.tensor(lens, dtype=torch.int32, device=dev)
            check("decode_attention", f"llama4 B8 H{h} KV{kv} hd{hd} C544 cache_len={lens} "
                  f"{dtype}", decode_attention(q, kc, vc, clen),
                  decode_attention_plain(q, kc, vc, clen), tol, tol)
        for b in (8, 16):
            x, kc, vc, kw = sublayer(b, d, h, kv, hd, 544, False, dtype)
            p = torch.tensor(543, dtype=torch.int32, device=dev)
            want, k_new, v_new = fused_decode_plain(x[:, 0], kc, vc, p, **kw)
            got = fused_decode(x, kc, vc, p, **kw)
            case = f"llama4 B{b} D{d} H{h} KV{kv} hd{hd} C544 pos 543 {dtype}"
            check("fused_decode", case + ": out", got[:, 0], want, tol, tol)
            check("fused_decode", case + ": slot k", kc[:, 543], k_new, tol, tol)
            check("fused_decode", case + ": slot v", vc[:, 543], v_new, tol, tol)
        del q, k, v, kc, vc, x

    # seamless-m4t-medium's shapes (phase 14), in bf16 and float32: flash not
    # causal at the encoder's self-attention (Sq = Sk = 1024, H16 KV16 D64)
    # and at cross-attention's Sq != Sk (128 and 2048 queries against 1024
    # frames, 1024 against a ragged 1000); decode attention over the cross
    # cache (B8, C 1024 and a ragged 1000, all of it live); the chain at
    # D1024 H16 KV16 hd64 (GQA 1) in the growing and wrapped ring states
    for dtype in (bf16, torch.float32):
        tol = ATOL if dtype == bf16 else F32_TOL
        for b, sq, sk in ((2, 1024, 1024), (2, 128, 1024), (1, 2048, 1024), (2, 1024, 1000)):
            q = randn(b, sq, 16, 64, dtype=dtype)
            k, v = randn(b, sk, 16, 64, dtype=dtype), randn(b, sk, 16, 64, dtype=dtype)
            check("flash_attention", f"seamless B{b} Sq{sq} Sk{sk} H16 KV16 D64 not causal "
                  f"{dtype}", flash_attention(q, k, v, causal=False),
                  flash_attention_plain(q, k, v, causal=False), tol, tol)
        for c in (1024, 1000):
            q, kc, vc = (randn(8, 16, 64, dtype=dtype), randn(8, c, 16, 64, dtype=dtype),
                         randn(8, c, 16, 64, dtype=dtype))
            clen = torch.tensor(c, dtype=torch.int32, device=dev)
            check("decode_attention", f"seamless cross B8 H16 KV16 hd64 C{c} cache_len={c} "
                  f"{dtype}", decode_attention(q, kc, vc, clen),
                  decode_attention_plain(q, kc, vc, clen), tol, tol)
        for c, pos in ((160, 140), (64, 200)):
            x, kc, vc, kw = sublayer(8, 1024, 16, 16, 64, c, False, dtype)
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            want, k_new, v_new = fused_decode_plain(x[:, 0], kc, vc, p, **kw)
            got = fused_decode(x, kc, vc, p, **kw)
            case = f"seamless B8 D1024 H16 KV16 hd64 C{c} pos {pos} {dtype}"
            check("fused_decode", case + ": out", got[:, 0], want, tol, tol)
            check("fused_decode", case + ": slot k", kc[:, pos % c], k_new, tol, tol)
            check("fused_decode", case + ": slot v", vc[:, pos % c], v_new, tol, tol)
        del q, k, v, kc, vc, x

    # the SSD scan at mamba2-370m's prefill (B8 L512 H32 P64 N128) and a
    # ragged length; b and c are strided slices of one projection, as there.
    # Short memory (dt ~ 0.8, a ~ -1: the state decays ~e^-50 over a chunk of
    # 64) checks the work within a chunk; long memory (dt ~ 0.02, a ~ -0.14,
    # as trained Mamba2 steps are: the state lives for hundreds of tokens)
    # checks the state carried from chunk to chunk.
    def ssd_inputs(b, L, h=32, p=64, n=128, memory="short"):
        bc = randn(b, L, 2 * n + h)
        shift, log_a = (0.0, 0.0) if memory == "short" else (4.0, -2.0)
        return (randn(b, L, h, p), F.softplus(randn(b, L, h, dtype=torch.float32) - shift),
                -torch.exp(log_a + 0.5 * randn(h, dtype=torch.float32)), bc[..., :n],
                bc[..., n:2 * n])

    # then the edges of the kernel's own chunk of 64 tokens (L 1, L 65: a
    # second chunk of one token) and the reduced config's widths (H16 P8
    # N16: b and c rows 48 elements apart, padded inside one mma tile)
    for (b, L, h, p, n), memory in (((8, 512, 32, 64, 128), "short"),
                                    ((8, 300, 32, 64, 128), "short"),
                                    ((8, 512, 32, 64, 128), "long"),
                                    ((8, 1, 32, 64, 128), "long"),
                                    ((8, 65, 32, 64, 128), "long"),
                                    ((2, 100, 16, 8, 16), "long")):
        args = ssd_inputs(b, L, h, p, n, memory=memory)
        (y, s), (want_y, want_s) = ssd_scan(*args), ssd_scan_plain(*args, chunk=128)
        case = f"B{b} L{L} H{h} P{p} N{n} bf16, chunk 128, {memory} memory"
        check("ssd_scan", case + ": y", y, want_y)
        check("ssd_scan", case + ": state (float32)", s, want_s, STATE_ATOL * float(
            want_s.abs().max()), STATE_RTOL)

    # jamba-1.5-large's shapes (phase 16), in bf16 and float32: the scan at
    # its prefill (B8 L512, 256 heads of 64, N 128) and a ragged length;
    # the gated norm at its decode and prefill rows (width 16384, z the
    # second half of the in-projection); rmsnorm at its decode rows (width
    # 8192); flash causal over the prefill bucket (B8 S512 H64 KV8 D128,
    # GQA 8); decode attention at the round's last step (C544) and at
    # ragged lengths; the chain at D 8192 (B 8 and 16)
    d, h, kv, hd = attention_shape(JAMBA)
    mh, mp, mn = jamba_mamba_shape()
    for dtype in (bf16, torch.float32):
        tol = ATOL if dtype == bf16 else F32_TOL
        for b, L in ((8, 512), (8, 300)):
            bc = randn(b, L, 2 * mn + mh, dtype=dtype)
            args = (randn(b, L, mh, mp, dtype=dtype),
                    F.softplus(randn(b, L, mh, dtype=torch.float32) - 4.0),
                    -torch.exp(-2.0 + 0.5 * randn(mh, dtype=torch.float32)), bc[..., :mn],
                    bc[..., mn:2 * mn])
            (y, s_), (want_y, want_s) = ssd_scan(*args), ssd_scan_plain(*args, chunk=128)
            case = f"jamba B{b} L{L} H{mh} P{mp} N{mn} {dtype}, long memory"
            if dtype == bf16:
                check("ssd_scan", case + ": y", y, want_y)
            else:       # sums as large as the largest y in another order
                check("ssd_scan", case + ": y", y, want_y,
                      STATE_ATOL * float(want_y.abs().max()), STATE_RTOL)
            check("ssd_scan", case + ": state (float32)", s_, want_s, STATE_ATOL * float(
                want_s.abs().max()), STATE_RTOL)
            del args, bc, y, s_, want_y, want_s
        for lead in ((8,), (8, 512)):
            args = gated_inputs(lead, mh, mp, dtype=dtype)
            check("rmsnorm_gated", f"jamba {lead} H{mh} P{mp} {dtype}, z rows "
                  f"{args[3].stride(-2)} apart", rmsnorm_gated(*args), rmsnorm_gated_plain(*args),
                  tol, tol)
        norm_check(f"jamba (8, {d})", randn(8, d, dtype=dtype), randn(d, dtype=torch.float32))
        q = randn(8, 512, h, hd, dtype=dtype)
        k, v = randn(8, 512, kv, hd, dtype=dtype), randn(8, 512, kv, hd, dtype=dtype)
        check("flash_attention", f"jamba B8 S512 H{h} KV{kv} D{hd} causal {dtype}",
              flash_attention(q, k, v), flash_attention_plain(q, k, v), tol, tol)
        q, kc, vc = (randn(8, h, hd, dtype=dtype), randn(8, 544, kv, hd, dtype=dtype),
                     randn(8, 544, kv, hd, dtype=dtype))
        for lens in (544, [1, 37, 100, 255, 256, 400, 543, 544]):
            clen = torch.tensor(lens, dtype=torch.int32, device=dev)
            check("decode_attention", f"jamba B8 H{h} KV{kv} hd{hd} C544 cache_len={lens} "
                  f"{dtype}", decode_attention(q, kc, vc, clen),
                  decode_attention_plain(q, kc, vc, clen), tol, tol)
        for b in (8, 16):
            x, kc, vc, kw = sublayer(b, d, h, kv, hd, 544, False, dtype)
            p = torch.tensor(543, dtype=torch.int32, device=dev)
            want, k_new, v_new = fused_decode_plain(x[:, 0], kc, vc, p, **kw)
            got = fused_decode(x, kc, vc, p, **kw)
            case = f"jamba B{b} D{d} H{h} KV{kv} hd{hd} C544 pos 543 {dtype}"
            check("fused_decode", case + ": out", got[:, 0], want, tol, tol)
            check("fused_decode", case + ": slot k", kc[:, 543], k_new, tol, tol)
            check("fused_decode", case + ": slot v", vc[:, 543], v_new, tol, tol)
        del q, k, v, kc, vc, x, kw
    torch.cuda.empty_cache()

    # -- 4. serving at full width -------------------------------------------
    rng = np.random.default_rng(0)
    prompt_lens = rng.integers(64, 401, 8)
    decode_p50_ms = {}
    served_tokens = {}

    def serve(name, kernels):
        """A warm-up round, then one counted round with every launch count
        reset just before and read just after; each must be above 0."""
        cfg = get_config(name)
        t0 = time.perf_counter()
        server = LMServer(cfg, max_batch=8, seed=0, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in server.params.parameters())
        prompts = [np.random.default_rng(n).integers(2, cfg.vocab, n).tolist()
                   for n in prompt_lens]
        reqs = [Request(uid=i, prompt=p, max_new=32) for i, p in enumerate(prompts)]
        server.serve([Request(uid=i, prompt=p, max_new=2) for i, p in enumerate(prompts)])
        server.stats = ServeStats()                  # the warm-up round is not counted
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs = server.serve(reqs)
        serve_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        steps = np.array(server.stats.decode_step_s)
        summary = server.stats.summary()
        decode_p50_ms[cfg.name] = float(np.percentile(steps, 50) * 1e3)
        emit("serve", config=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
             params=n_params, weights_dtype=str(server.params.embed.dtype),
             init_s=round(init_s, 3), serve_s=round(serve_s, 3),
             prompt_lens=[len(p) for p in prompts], bucket=_bucket(max(map(len, prompts))),
             completion_lens=[len(o.tokens) for o in outs],
             prefill_tok_per_s=summary["prefill_tok_per_s"],
             decode_tok_per_s=summary["decode_tok_per_s"], decode_steps=len(steps),
             decode_step_p50_ms=float(np.percentile(steps, 50) * 1e3),
             decode_step_p90_ms=float(np.percentile(steps, 90) * 1e3),
             prefill_s=server.stats.prefill_s,
             max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches)
        for o in outs:
            if not 1 <= len(o.tokens) <= 32 or not all(0 <= t < cfg.padded_vocab
                                                         for t in o.tokens):
                raise AssertionError(f"{name} request {o.uid}: bad completion {o.tokens}")
        missing = [k for k, n in launches.items() if n == 0]
        if missing:
            raise AssertionError(f"the {name} serving path launched no {missing} kernel")
        served_tokens[cfg.name] = [o.tokens for o in outs]
        return cfg, server.params, prompts, launches

    # `_composed_step` counts its own calls: both qwen rounds must make none
    fd._composed_step.calls = 0
    cfg, params, prompts, launches = serve("qwen2.5-3b", {
        "rmsnorm": rmsnorm, "flash_attention": flash_attention,
        "fused_qkv_rope": qkv_rope, "decode_attention": decode_attention,
        "fused_out_residual": out_residual})
    emit("composed_step", config=cfg.name, calls=fd._composed_step.calls)
    if fd._composed_step.calls or launches["fused_qkv_rope"] != launches["fused_out_residual"]:
        raise AssertionError(f"the qwen decode step left the fused chain: {launches}, "
                             f"_composed_step called {fd._composed_step.calls} times")
    m_cfg, m_params, m_prompts, m_launches = serve(
        "mamba2-370m", {"rmsnorm": rmsnorm, "rmsnorm_gated": rmsnorm_gated, "ssd_scan": ssd_scan})

    # -- 5. A/B: oracle route vs kernel route, lockstep --------------------
    def ab(cfg, params, prompts, tol_of, extra=None):
        """Prefill and 8 decode steps of two requests through both routes,
        each fed the oracle's tokens; ``tol_of(ref_logits)`` is the bound on
        the logits' difference at a step, twice it the near-tie margin.
        ``extra``: the two requests' frames or prefix embeddings, for the
        batch."""
        ab = prompts[:2]
        bucket = _bucket(max(map(len, ab)))
        toks = np.zeros((2, bucket), np.int64)
        for i, p in enumerate(ab):
            toks[i, bucket - len(p):] = p
        batch = dict(extra or {}, tokens=torch.from_numpy(toks).to(dev))
        prefix = batch["prefix_embeds"].shape[1] if "prefix_embeds" in batch else 0
        with torch.no_grad():
            runs = {impl: lm.prefill(cfg, params, batch, capacity=prefix + bucket + 8,
                                     impl=impl)
                    for impl in (None, "ref")}
            diffs, tols, margins, parted, agree = [], [], [], [False, False], [0, 0]
            for step in range(8):
                lk, lr = runs[None][0][:, -1].float(), runs["ref"][0][:, -1].float()
                diffs.append(float((lk - lr).abs().max()))
                tols.append(tol_of(lr))
                top2 = torch.topk(lr, 2, dim=-1).values
                margin = (top2[:, 0] - top2[:, 1]).tolist()
                margins.append(min(margin))
                tk, tr = lk.argmax(-1).tolist(), lr.argmax(-1).tolist()
                for i in range(2):
                    if parted[i]:
                        continue
                    if tk[i] == tr[i]:
                        agree[i] += 1
                    elif margin[i] < 2 * tols[-1]:
                        parted[i] = True
                    else:
                        raise AssertionError(f"A/B {cfg.name}: row {i} step {step}: tokens "
                                             f"{tk[i]} vs {tr[i]} at top-2 margin {margin[i]}")
                if diffs[-1] > tols[-1]:
                    raise AssertionError(f"A/B {cfg.name}: step {step}: logits differ by "
                                         f"{diffs[-1]} > {tols[-1]}")
                feed = torch.tensor(tr, device=dev)[:, None]  # both routes get the oracle's
                runs = {impl: lm.decode_step(cfg, params, runs[impl][1], feed, impl=impl)
                        for impl in runs}
        emit("ab", config=cfg.name, layers=cfg.n_layers, requests=2, steps=8,
             max_abs_logit_diff=diffs, logit_tol=tols, min_top2_margin=margins,
             tie_margin=[2 * t for t in tols], tokens_agreeing=agree,
             parted_at_near_tie=parted, logits_abs_max=float(lr.abs().max()),
             batch=sorted(batch), prefix=prefix)

    ab(cfg, params, prompts, lambda ref_logits: LOGIT_TOL)

    def order_only_spread(cfg, params, prompts):
        """Largest prefill-logit difference between the oracle route and the
        same route with the chunk of its scan halved (64): what a change of
        summation order alone does to this stack."""
        bucket = _bucket(max(map(len, prompts[:2])))
        toks = np.zeros((2, bucket), np.int64)
        for i, p in enumerate(prompts[:2]):
            toks[i, bucket - len(p):] = p
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        ssd = ops.ssd
        with torch.no_grad():
            want, _ = lm.prefill(cfg, params, batch, impl="ref")
            ops.ssd = lambda *a, impl=None, chunk=128: ssd(*a, impl=impl, chunk=64)
            try:
                got, _ = lm.prefill(cfg, params, batch, impl="ref")
            finally:
                ops.ssd = ssd
        return float((got.float() - want.float()).abs().max()), float(want.abs().max())

    m32_cfg = dataclasses.replace(m_cfg, compute_dtype="float32")
    m32_params = lm.init_params(m32_cfg, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(0))
    spread = {name: order_only_spread(c, p, m_prompts)
              for name, c, p in (("bfloat16", m_cfg, m_params),
                                 ("float32", m32_cfg, m32_params))}
    emit("order_only_spread", config=m_cfg.name, what="oracle route, scan chunk 64 vs 128, "
         "prefill logits of 2 requests", max_abs_logit_diff_and_logits_abs_max=spread)
    ab(m32_cfg, m32_params, m_prompts, lambda ref_logits: MAMBA_LOGIT_TOL)
    del m32_params

    # one mamba2-370m block at full width in bf16: a prefill of 8 sequences
    # at the serving bucket, then 4 decode steps, each route on its own caches
    layer = blocks.Mamba(m_cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    bucket = _bucket(max(map(len, m_prompts)))
    xs = [randn(8, bucket, m_cfg.d_model)] + [randn(8, 1, m_cfg.d_model) for _ in range(4)]
    outs = {}
    with torch.no_grad():
        for impl in (None, "ref"):
            y, (conv, ssm) = layer(xs[0], impl=impl)
            cache = {"conv": conv.clone(), "ssm": ssm.clone()}
            outs[impl] = [y] + [layer.decode(t, cache, impl=impl)[0] for t in xs[1:]]
    diffs, bad = [], []
    for step, (got, want) in enumerate(zip(outs[None], outs["ref"])):
        err = (got.float() - want.float()).abs()
        diffs.append(float(err.max()))
        if (err > ATOL + RTOL * want.float().abs()).any():
            bad.append(step)
    emit("ab_layer", config=m_cfg.name, block="Mamba", dtype="bfloat16", batch=8,
         prefill_tokens=bucket, decode_steps=4, max_abs_diff=diffs,
         out_abs_max=[float(o.float().abs().max()) for o in outs["ref"]],
         tolerance=f"|d| <= {ATOL} + {RTOL}*|ref|", ok=not bad)
    if bad:
        raise AssertionError(f"A/B of one {m_cfg.name} block in bf16: steps {bad} (0: the "
                             f"prefill) out of tolerance, largest differences {diffs}")
    del layer, outs

    # -- 6. times at the serving shapes ------------------------------------
    def timed_by_kernel(fn, arg_sets, iters=50) -> dict:
        """Device ms a call, by kernel name: the kernel time ``torch.profiler``
        records over ``iters`` calls cycling through the input copies in
        ``arg_sets`` (chosen to overflow the L2 cache).  Device time, not
        events around the loop: a small kernel finishes faster than the
        host launches the next, and events would time the host."""
        for args in arg_sets:
            fn(*args)
        torch.cuda.synchronize()
        for _ in range(3):          # a profiler window now and then records nothing
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
                for i in range(iters):
                    fn(*arg_sets[i % len(arg_sets)])
                torch.cuda.synchronize()
            by = {e.key[:80]: e.device_time_total / iters / 1e3 for e in p.key_averages()
                  if str(e.device_type).endswith("CUDA") and e.device_time_total > 0}
            if by:
                return by
        raise RuntimeError("the profiler recorded no kernel time in 3 windows")

    def timed(fn, arg_sets, iters=50) -> float:
        return sum(timed_by_kernel(fn, arg_sets, iters).values())

    def copies(make, nbytes):
        return [make() for _ in range(max(2, min(32, -(-2 * L2_BYTES // nbytes))))]

    def bound(nbytes, flops, flop_rate):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    def timed_with_norm_plan(plan, fn, arg_sets):
        """Device ms of ``fn`` with `norm_plan` swapped for one that returns
        ``plan``."""
        norm_plan = rn.norm_plan
        rn.norm_plan = lambda *_, **__: plan
        try:
            return timed(fn, arg_sets)
        finally:
            rn.norm_plan = norm_plan

    # the norms at the serving shapes: mamba2-370m's and qwen's decode rows,
    # qwen's prefill; each beside an empty kernel on the grid its plan takes.
    # The bound reads the rows and the weight once and writes the rows.
    card = rn.card_of(torch.cuda.current_device())
    times = {}
    rows = []
    norm_times = {}
    for shape in ((8, 1024), (8, 2048), (8 * 512, 2048)):
        n, d = shape[0] * shape[1], shape[1]
        nbytes = 2 * n * 2 + d * 4
        sets = copies(lambda: (randn(*shape), randn(d, dtype=torch.float32)), nbytes)
        plan = rn.norm_plan(*shape, 2, gated=False, aligned=True, card=card)
        b_ms, b_by = bound(nbytes, 4 * n, F32_FLOP_PER_S)
        norm_times[str(shape)] = dict(
            ms=timed(lambda x, w: rmsnorm(x, w), sets),
            plain_ms=timed(lambda x, w: rmsnorm_plain(x, w), sets),
            library_ms=timed(lambda x, w: F.rms_norm(x, (d,), w, 1e-5), sets),
            library_bf16_weight_ms=timed(lambda x, w: F.rms_norm(x, (d,), w.to(bf16), 1e-5),
                                         sets),
            floor_ms=timed(lambda *_: rn.launch_floor(plan), sets),
            bound_ms=b_ms, bound_by=b_by, plan=plan._asdict(), bytes=nbytes)
    times["rmsnorm"] = dict(norm_times["(8, 2048)"], by_shape=norm_times)
    rows.append(("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                 "src/repro/kernels/rmsnorm.py:11", times["rmsnorm"]))

    # the gated form at mamba2-370m's decode and prefill: the bound reads y,
    # xh, z (half of its projection's row), d_skip and the weight once and
    # writes the rows; the yardstick is what the block ran before it: the
    # torch ops of the body, then the norm kernel
    def unfused(y, xh, ds, z, w):
        g = y + xh * ds[:, None].to(xh.dtype)
        return rmsnorm(g.reshape(z.shape) * F.silu(z), w)

    gated_times = {}
    for lead in ((8,), (8, 512)):
        n_rows = int(np.prod(lead))
        n = n_rows * 2048
        nbytes = 4 * n * 2 + 2048 * 4 + 32 * 4
        sets = copies(lambda: gated_inputs(lead), nbytes + n * 2)
        plan = rn.norm_plan(n_rows, 2048, 2, gated=True, aligned=True, card=card)
        b_ms, b_by = bound(nbytes, 11 * n, F32_FLOP_PER_S)
        gated_times[f"({n_rows}, 2048)"] = dict(
            ms=timed(lambda *a: rmsnorm_gated(*a), sets),
            plain_ms=timed(lambda *a: rmsnorm_gated_plain(*a), sets), library_ms=None,
            yardstick_ms=timed(unfused, sets),
            yardstick="the op-by-op torch body (5 launches) then the rmsnorm kernel",
            floor_ms=timed(lambda *_: rn.launch_floor(plan), sets),
            bound_ms=b_ms, bound_by=b_by, plan=plan._asdict(), bytes=nbytes)
    times["rmsnorm_gated"] = dict(gated_times["(8, 2048)"], by_shape=gated_times)
    rows.append(("rmsnorm_gated", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                 "src/repro/kernels/rmsnorm.py:11", times["rmsnorm_gated"]))

    # what sets the norm's time: the decode rows of mamba2-370m, qwen and the
    # gated form split over other warps a row (a block a row); qwen's prefill
    # with 1 and 2 blocks an SM and with no grid stride (1024 blocks of 4
    # rows, four waves), and with 4 and 8 warps a row; beside it a copy of
    # the same rows (``copy_``: the rate the memory gives one read and one
    # write stream of these bytes)
    norm_ms = {}
    for d, warps in ((1024, (1, 2, 4)), (2048, (2, 4, 8))):
        x_dec = [(randn(8, d), randn(d, dtype=torch.float32))]
        for w in warps:
            norm_ms[f"(8, {d}) {w} warps a row"] = timed_with_norm_plan(
                rn.NormPlan(w, d // 256 // w, 1, 8), rmsnorm, x_dec)
    g_dec = [gated_inputs((8,))]
    for w, u in ((4, 2), (8, 1)):
        norm_ms[f"gated (8, 2048) {w} warps a row"] = timed_with_norm_plan(
            rn.NormPlan(w, u, 1, 8), lambda *a: rmsnorm_gated(*a), g_dec)
    x_pre = copies(lambda: (randn(4096, 2048), randn(2048, dtype=torch.float32)), 2 * 4096 * 4096)
    for plan in ((2, 4, 4, card.sms), (2, 4, 4, 2 * card.sms), (2, 4, 4, 1024),
                 (4, 2, 2, 2 * card.sms), (8, 1, 1, 2 * card.sms)):
        norm_ms[f"(4096, 2048) {rn.NormPlan(*plan)}"] = timed_with_norm_plan(
            rn.NormPlan(*plan), rmsnorm, x_pre)
    norm_ms["(4096, 2048) copy_ of the rows"] = timed(
        lambda x, w: torch.empty_like(x).copy_(x), x_pre)
    # the same with every output kept, so no call writes where the last one
    # did (above, the allocator hands each call the block the last one
    # freed, whose lines may still sit in L2)
    kept = []
    norm_ms["(4096, 2048) outputs kept"] = timed(lambda x, w: kept.append(rmsnorm(x, w)), x_pre)
    kept.clear()
    norm_ms["(4096, 2048) copy_ of the rows, outputs kept"] = timed(
        lambda x, w: kept.append(torch.empty_like(x).copy_(x)), x_pre)
    kept.clear()
    gkept, g_pre = [], copies(lambda: gated_inputs((8, 512)), 4 * 4096 * 2048 * 2)
    norm_ms["gated (4096, 2048) outputs kept"] = timed(
        lambda *a: gkept.append(rmsnorm_gated(*a)), g_pre)
    emit("rmsnorm_scaling", ms=norm_ms, sms=card.sms, card=smi)
    del x_pre, g_pre, gkept

    b, s, h, kv, d = 8, 512, 16, 2, 128
    nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kv * d)
    sets = copies(lambda: (randn(b, s, h, d), randn(b, s, kv, d), randn(b, s, kv, d)), nbytes)
    live_pairs = s * (s + 1) // 2                       # causal
    b_ms, b_by = bound(nbytes, 4 * d * b * h * live_pairs, BF16_FLOP_PER_S)
    times["flash_attention"] = dict(
        ms=timed(lambda q, k, v: flash_attention(q, k, v), sets, iters=10),
        plain_ms=timed(lambda q, k, v: flash_attention_plain(q, k, v), sets, iters=10),
        library_ms=timed(lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True), sets, iters=10),
        bound_ms=b_ms, bound_by=b_by)
    rows.append(("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:28", times["flash_attention"]))
    # what sets its time: twice the key tiles (not causal); one head of one
    # sequence, 8 blocks whose longest walks 8 key tiles; one block, one tile
    lone = [tuple(randn(1, n, 1, d) for _ in range(3)) for n in (512, 64)]
    emit("flash_attention_scaling", ms={
        "B8 S512 H16 KV2 D128 not causal": timed(
            lambda q, k, v: flash_attention(q, k, v, causal=False), sets, iters=10),
        "B1 S512 H1 KV1 D128 causal": timed(flash_attention, lone[:1], iters=10),
        "B1 S64 H1 KV1 D128 causal": timed(flash_attention, lone[1:], iters=10)})

    b, h, kv, hd, c = 8, 16, 2, 128, 544
    clen = torch.tensor(c, dtype=torch.int32, device=dev)   # the round's last step
    nbytes = 2 * (2 * b * h * hd + 2 * b * c * kv * hd)
    sets = copies(lambda: (randn(b, h, hd), randn(b, c, kv, hd), randn(b, c, kv, hd)), nbytes)
    b_ms, b_by = bound(nbytes, 4 * hd * h * b * c, BF16_FLOP_PER_S)
    times["decode_attention"] = dict(
        ms=timed(lambda q, k, v: decode_attention(q, k, v, clen), sets),
        plain_ms=timed(lambda q, k, v: decode_attention_plain(q, k, v, clen), sets),
        library_ms=timed(lambda q, k, v: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), enable_gqa=True), sets),
        bound_ms=b_ms, bound_by=b_by)
    rows.append(("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention.py:45", times["decode_attention"]))
    # how decode attention scales: over the batch (blocks on the card) and
    # the live cache (32 slots: one stage of one split), inputs warm in L2,
    # and at cache_len 544 with the plan's split length halved and doubled
    def timed_with_plan(plan, args):
        """Device ms of decode attention with `split_plan` swapped for one
        that returns ``plan``."""
        da.split_plan = lambda *_: plan
        try:
            return timed(decode_attention, [args])
        finally:
            da.split_plan = split_plan

    scaling, splits, other_plans = {}, {}, {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b in (8, 64):
        plan = split_plan(b, kv, c, sms)
        splits[f"B{b}"] = {"length": plan.length, "splits": plan.splits,
                           "blocks": b * kv * plan.splits}
        for n in (32, 544):
            args = (randn(b, h, hd), randn(b, c, kv, hd), randn(b, c, kv, hd),
                    torch.tensor(n, dtype=torch.int32, device=dev))
            scaling[f"B{b} cache_len {n}"] = timed(decode_attention, [args])
        for length in (plan.length // 2, plan.length * 2):
            other = da.SplitPlan(length, -(-c // length))
            if da.MIN_SPLIT <= length and other.splits <= da.MAX_SPLITS:
                other_plans[f"B{b} cache_len 544 L{length} S{other.splits}"] = \
                    timed_with_plan(other, args)
    # a lone split per (sequence, KV head) streaming 1 to 8 stages of 32 slots
    # (B8, splits of 256 slots, only the first live): a stage's time and the
    # fixed cost of a call
    qkv = (randn(8, h, hd), randn(8, c, kv, hd), randn(8, c, kv, hd))
    by_stages = {f"B8 L256 cache_len {n}": timed_with_plan(
        da.SplitPlan(256, -(-c // 256)), (*qkv, torch.tensor(n, dtype=torch.int32, device=dev)))
        for n in (1, 32, 64, 128, 256)}
    emit("decode_attention_scaling", ms=scaling, splits=splits, sms=sms,
         ms_other_splits=other_plans, ms_lone_split=by_stages,
         shape=f"H{h} KV{kv} hd{hd} C{c} bf16")

    # the fused chain at qwen's decode, the round's last step (pos 543, so
    # cache_len 544 of C 544); the bound reads the weights, the biases and
    # the live cache once, x in, out and the new rows out
    d, b, h, kv, hd, c = 2048, 8, 16, 2, 128, 544
    n_w = d * (h + 2 * kv) * hd + h * hd * d
    nbytes = 2 * (n_w + (h + 2 * kv) * hd + 2 * b * c * kv * hd + 2 * b * d + 2 * b * kv * hd)
    sets = copies(lambda: sublayer(b, d, h, kv, hd, c, True), nbytes)
    pos = torch.tensor(c - 1, dtype=torch.int32, device=dev)
    b_ms, b_by = bound(nbytes, 2 * b * n_w + 4 * b * h * hd * c, BF16_FLOP_PER_S)
    chain = timed_by_kernel(lambda x, k, v, kw: fused_decode(x, k, v, pos, **kw), sets)
    times["fused_decode"] = dict(
        ms=sum(chain.values()), ms_by_kernel=chain,
        plain_ms=timed(lambda x, k, v, kw: fused_decode_plain(x[:, 0], k, v, pos, **kw), sets),
        library_ms=None,
        yardstick_ms=timed(lambda x, k, v, kw: fd._composed_step(x, k, v, pos, **kw), sets),
        yardstick="_composed_step: cuBLAS GEMVs and torch elementwise ops around the port's "
                  "rmsnorm and decode-attention kernels (no single PyTorch call computes "
                  "the sublayer)",
        bound_ms=b_ms, bound_by=b_by)
    rows.append(("fused_decode", "src/repro_torch/kernels/csrc/fused_decode.cu",
                 "src/repro/kernels/fused_decode.py:91", times["fused_decode"]))

    # the chain's two GEMVs as rows of their own at the same shapes: qkv_rope
    # reads x, norm, the Q/K/V weights and biases once and writes q and the
    # new k and v rows; out_residual reads o, wo and x once and writes out
    def gemv_sets(b, d, h, kv, hd, bias=True):
        """qkv_rope's and out_residual's inputs, copies that overflow L2."""
        n_qkv = (h + 2 * kv) * hd
        qkv_bytes = 2 * (d * n_qkv + (n_qkv if bias else 0) + b * d + b * n_qkv) + 4 * d
        out_bytes = 2 * (h * hd * d + b * h * hd + 2 * b * d)

        def qkv_set():
            x, kc, vc, kw = sublayer(b, d, h, kv, hd, 64, bias)
            return x[:, 0], kc, vc, kw
        qkv = copies(qkv_set, qkv_bytes)
        out = copies(lambda: (randn(b, h * hd), randn(h * hd, d) * (h * hd) ** -0.5,
                              randn(b, d)), out_bytes)
        return qkv, qkv_bytes, out, out_bytes

    def run_qkv(x2, kc, vc, kw):
        return qkv_rope(x2, kc, vc, pos, norm=kw["norm"], wq=kw["wq"], wk=kw["wk"],
                        wv=kw["wv"], bq=kw["bq"], bk=kw["bk"], bv=kw["bv"],
                        n_heads=kw["n_heads"], eps=kw["eps"], theta=kw["theta"])

    def plain_qkv(x2, kc, vc, kw):
        return fd.qkv_plain(x2, pos, **{n: kw[n] for n in (
            "norm", "wq", "wk", "wv", "bq", "bk", "bv", "n_heads", "head_dim", "eps", "theta")})

    qkv_sets, qkv_bytes, out_sets, out_bytes = gemv_sets(b, d, h, kv, hd)
    # yardstick: F.rms_norm and one addmm over the concatenated weights
    # (two PyTorch calls; the rope and the slot write are left out)
    cat_sets = [(x2, kw["norm"].to(bf16), torch.cat([kw["wq"], kw["wk"], kw["wv"]], 1),
                 torch.cat([kw["bq"], kw["bk"], kw["bv"]])) for x2, _, _, kw in qkv_sets]
    qkv_b_ms, qkv_b_by = bound(qkv_bytes, 2 * b * d * (h + 2 * kv) * hd, BF16_FLOP_PER_S)
    out_b_ms, out_b_by = bound(out_bytes, 2 * b * h * hd * d, BF16_FLOP_PER_S)
    chain_parts = {
        "fused_qkv_rope": dict(
            ms=timed(run_qkv, qkv_sets), plain_ms=timed(plain_qkv, qkv_sets), library_ms=None,
            yardstick_ms=timed(lambda x2, nw, w, bb: torch.addmm(
                bb, F.rms_norm(x2, (d,), nw, 1e-6), w), cat_sets),
            yardstick="F.rms_norm + torch.addmm over wq|wk|wv (no rope, no slot write)",
            bound_ms=qkv_b_ms, bound_by=qkv_b_by, bytes=qkv_bytes),
        "fused_out_residual": dict(
            ms=timed(out_residual, out_sets), plain_ms=timed(fd.out_residual_plain, out_sets),
            library_ms=timed(lambda o, wo, x2: torch.addmm(x2, o, wo), out_sets),
            library="torch.addmm(x, o, wo)", bound_ms=out_b_ms, bound_by=out_b_by,
            bytes=out_bytes)}
    times["fused_decode"]["parts"] = chain_parts

    # the same kernels at the two large dense decoders' serving shapes (phase
    # 12) and at the llama4 MoE decoders' (phase 15): flash over the prefill
    # bucket (B8 S512), decode attention at the round's last step (C544) and
    # the chain's GEMVs at B 8, each beside its bound, its plain version and
    # the library call; bounds as above
    def shape_times(label, d_, h_, kv_, hd_) -> dict:
        """{kernel: {case: record}} at one model's attention shape."""
        out = {}
        b_, s_, c_ = 8, 512, 544
        nb = 2 * (2 * b_ * s_ * h_ * hd_ + 2 * b_ * s_ * kv_ * hd_)
        sets = copies(lambda: (randn(b_, s_, h_, hd_), randn(b_, s_, kv_, hd_),
                               randn(b_, s_, kv_, hd_)), nb)
        b_ms, b_by = bound(nb, 4 * hd_ * b_ * h_ * (s_ * (s_ + 1) // 2), BF16_FLOP_PER_S)
        out["flash_attention"] = {f"{label} B{b_} S{s_} H{h_} KV{kv_} D{hd_} causal": dict(
            ms=timed(lambda q, k, v: flash_attention(q, k, v), sets, iters=10),
            plain_ms=timed(lambda q, k, v: flash_attention_plain(q, k, v), sets, iters=10),
            library_ms=timed(lambda q, k, v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                enable_gqa=True), sets, iters=10),
            bound_ms=b_ms, bound_by=b_by)}
        clen_ = torch.tensor(c_, dtype=torch.int32, device=dev)
        nb = 2 * (2 * b_ * h_ * hd_ + 2 * b_ * c_ * kv_ * hd_)
        sets = copies(lambda: (randn(b_, h_, hd_), randn(b_, c_, kv_, hd_),
                               randn(b_, c_, kv_, hd_)), nb)
        b_ms, b_by = bound(nb, 4 * hd_ * h_ * b_ * c_, BF16_FLOP_PER_S)
        out["decode_attention"] = {f"{label} B{b_} H{h_} KV{kv_} hd{hd_} C{c_}": dict(
            ms=timed(lambda q, k, v: decode_attention(q, k, v, clen_), sets),
            plain_ms=timed(lambda q, k, v: decode_attention_plain(q, k, v, clen_), sets),
            library_ms=timed(lambda q, k, v: F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), enable_gqa=True), sets),
            bound_ms=b_ms, bound_by=b_by)}
        q_sets, q_bytes, o_sets, o_bytes = gemv_sets(b_, d_, h_, kv_, hd_, bias=False)
        q_cat = [(x2, kw["norm"].to(bf16), torch.cat([kw["wq"], kw["wk"], kw["wv"]], 1))
                 for x2, _, _, kw in q_sets]
        qb_ms, qb_by = bound(q_bytes, 2 * b_ * d_ * (h_ + 2 * kv_) * hd_, BF16_FLOP_PER_S)
        ob_ms, ob_by = bound(o_bytes, 2 * b_ * h_ * hd_ * d_, BF16_FLOP_PER_S)
        out["fused_decode"] = {f"{label} B{b_} D{d_}": {
            "fused_qkv_rope": dict(
                ms=timed(run_qkv, q_sets), plain_ms=timed(plain_qkv, q_sets), library_ms=None,
                yardstick_ms=timed(lambda x2, nw, w: F.rms_norm(x2, (d_,), nw, 1e-6) @ w, q_cat),
                yardstick="F.rms_norm + torch.mm over wq|wk|wv (no rope, no slot write)",
                bound_ms=qb_ms, bound_by=qb_by, bytes=q_bytes, plan=fd.gemv_plan(
                    h_ + 2 * kv_, fd.tile_width(hd_), d_, 1, sms, dtype=torch.bfloat16,
                    norm=True)._asdict()),
            "fused_out_residual": dict(
                ms=timed(out_residual, o_sets), plain_ms=timed(fd.out_residual_plain, o_sets),
                library_ms=timed(lambda o, wo, x2: torch.addmm(x2, o, wo), o_sets),
                library="torch.addmm(x, o, wo)", bound_ms=ob_ms, bound_by=ob_by,
                bytes=o_bytes, plan=fd.gemv_plan(-(-d_ // fd.OUT_WIDTH), fd.OUT_WIDTH, h_ * hd_,
                                                 1, sms, dtype=torch.bfloat16,
                                                 norm=False)._asdict())}}
        del sets, q_sets, o_sets, q_cat
        # rmsnorm over a decode step's 8 rows at the model's width, as the
        # serving-shape rows above (the empty kernel on its grid beside it)
        nbytes = 2 * 8 * d_ * 2 + d_ * 4
        sets = copies(lambda: (randn(8, d_), randn(d_, dtype=torch.float32)), nbytes)
        plan = rn.norm_plan(8, d_, 2, gated=False, aligned=True, card=card)
        b_ms, b_by = bound(nbytes, 4 * 8 * d_, F32_FLOP_PER_S)
        out["rmsnorm"] = {f"{label} (8, {d_})": dict(
            ms=timed(lambda x, w: rmsnorm(x, w), sets),
            plain_ms=timed(lambda x, w: rmsnorm_plain(x, w), sets),
            library_ms=timed(lambda x, w: F.rms_norm(x, (d_,), w, 1e-5), sets),
            floor_ms=timed(lambda *_: rn.launch_floor(plan), sets),
            bound_ms=b_ms, bound_by=b_by, plan=plan._asdict(), bytes=nbytes)}
        return out

    for label, shape in large_shapes().items():
        for k_, cases in shape_times(label, *shape).items():
            times[k_].setdefault("large_shapes", {}).update(cases)
    emit("times_large", card=smi, **{k: times[k]["large_shapes"] for k in (
        "flash_attention", "decode_attention", "fused_decode", "rmsnorm")})
    for k_, cases in shape_times("llama4", *attention_shape(MOE[0])).items():
        times[k_]["moe_shapes"] = cases
    emit("times_moe", card=smi, **{k: times[k]["moe_shapes"] for k in (
        "flash_attention", "decode_attention", "fused_decode", "rmsnorm")})

    # seamless-m4t-medium's shapes (phase 14's serving round): flash not
    # causal over the encoder's 1024 frames (B8, H16 KV16 D64) and in the
    # decoder's cross-attention (128 queries against them), decode attention
    # over the cross cache (B8 C1024, all live) and the chain's GEMVs at
    # D1024, H16 KV16 hd64, B 8; each beside its bound, its plain version and
    # the library call (SDPA not causal; ``addmm``); bounds as above, the
    # attention products over every (query, key) pair
    def sdpa_full(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=False)

    prefix_times = {k: {} for k in ("flash_attention", "decode_attention", "fused_decode")}
    for label, (b_, sq_, sk_) in (("encoder", (8, 1024, 1024)), ("cross", (8, 128, 1024))):
        nb = 2 * (2 * b_ * sq_ * 16 * 64 + 2 * b_ * sk_ * 16 * 64)
        sets = copies(lambda: (randn(b_, sq_, 16, 64), randn(b_, sk_, 16, 64),
                               randn(b_, sk_, 16, 64)), nb)
        b_ms, b_by = bound(nb, 4 * 64 * b_ * 16 * sq_ * sk_, BF16_FLOP_PER_S)
        prefix_times["flash_attention"][
            f"seamless {label} B{b_} Sq{sq_} Sk{sk_} H16 KV16 D64 not causal"] = dict(
            ms=timed(lambda q, k, v: flash_attention(q, k, v, causal=False), sets, iters=10),
            plain_ms=timed(lambda q, k, v: flash_attention_plain(q, k, v, causal=False), sets,
                           iters=10),
            library_ms=timed(sdpa_full, sets, iters=10), bound_ms=b_ms, bound_by=b_by)
        del sets
    clen_ = torch.tensor(1024, dtype=torch.int32, device=dev)
    nb = 2 * (2 * 8 * 16 * 64 + 2 * 8 * 1024 * 16 * 64)
    sets = copies(lambda: (randn(8, 16, 64), randn(8, 1024, 16, 64), randn(8, 1024, 16, 64)),
                  nb)
    b_ms, b_by = bound(nb, 4 * 64 * 16 * 8 * 1024, BF16_FLOP_PER_S)
    prefix_times["decode_attention"]["seamless cross B8 H16 KV16 hd64 C1024"] = dict(
        ms=timed(lambda q, k, v: decode_attention(q, k, v, clen_), sets),
        plain_ms=timed(lambda q, k, v: decode_attention_plain(q, k, v, clen_), sets),
        library_ms=timed(lambda q, k, v: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)), sets),
        bound_ms=b_ms, bound_by=b_by, plan=split_plan(8, 16, 1024, sms)._asdict())
    q_sets, q_bytes, o_sets, o_bytes = gemv_sets(8, 1024, 16, 16, 64, bias=False)
    q_cat = [(x2, kw["norm"].to(bf16), torch.cat([kw["wq"], kw["wk"], kw["wv"]], 1))
             for x2, _, _, kw in q_sets]
    qb_ms, qb_by = bound(q_bytes, 2 * 8 * 1024 * 48 * 64, BF16_FLOP_PER_S)
    ob_ms, ob_by = bound(o_bytes, 2 * 8 * 1024 * 1024, BF16_FLOP_PER_S)
    prefix_times["fused_decode"]["seamless B8 D1024 H16 KV16 hd64"] = {
        "fused_qkv_rope": dict(
            ms=timed(run_qkv, q_sets), plain_ms=timed(plain_qkv, q_sets), library_ms=None,
            yardstick_ms=timed(lambda x2, nw, w: F.rms_norm(x2, (1024,), nw, 1e-6) @ w, q_cat),
            yardstick="F.rms_norm + torch.mm over wq|wk|wv (no rope, no slot write)",
            bound_ms=qb_ms, bound_by=qb_by, bytes=q_bytes, plan=fd.gemv_plan(
                48, fd.tile_width(64), 1024, 1, sms, dtype=torch.bfloat16, norm=True)._asdict()),
        "fused_out_residual": dict(
            ms=timed(out_residual, o_sets), plain_ms=timed(fd.out_residual_plain, o_sets),
            library_ms=timed(lambda o, wo, x2: torch.addmm(x2, o, wo), o_sets),
            library="torch.addmm(x, o, wo)", bound_ms=ob_ms, bound_by=ob_by, bytes=o_bytes,
            plan=fd.gemv_plan(-(-1024 // fd.OUT_WIDTH), fd.OUT_WIDTH, 1024, 1, sms,
                              dtype=torch.bfloat16, norm=False)._asdict())}
    del sets, q_sets, o_sets, q_cat
    for k_, v_ in prefix_times.items():
        times[k_]["prefix_shapes"] = v_
    emit("times_prefix", card=smi, **prefix_times)

    # what sets the GEMVs' time: qwen's and danube's widths at B 1 and 8,
    # with the split plans taken; one block alone streaming a 128-column
    # tile of 256 and of 2048 rows (out_residual, its plan swapped for one
    # split); qwen's B 8 with other split counts (clusters) than the plan's
    gemv_ms, gemv_plans = {}, {}
    for label, (d_, h_, kv_, hd_, bias_) in (("qwen", (2048, 16, 2, 128, True)),
                                             ("danube", (3840, 32, 8, 120, False))):
        for b_ in (1, 8):
            q_sets, _, o_sets, _ = gemv_sets(b_, d_, h_, kv_, hd_, bias_)
            key = f"{label} B{b_} D{d_}"
            gemv_ms[f"qkv_rope {key}"] = timed(run_qkv, q_sets)
            gemv_ms[f"out_residual {key}"] = timed(out_residual, o_sets)
            gemv_plans[f"qkv_rope {key}"] = dict(fd.gemv_plan(
                h_ + 2 * kv_, fd.tile_width(hd_), d_, 1, sms, dtype=torch.bfloat16,
                norm=True)._asdict(), tiles=h_ + 2 * kv_)
            gemv_plans[f"out_residual {key}"] = dict(fd.gemv_plan(
                -(-d_ // fd.OUT_WIDTH), fd.OUT_WIDTH, h_ * hd_, 1, sms, dtype=torch.bfloat16,
                norm=False)._asdict(),
                tiles=-(-d_ // fd.OUT_WIDTH))
            del q_sets, o_sets
    def timed_with_splits(splits, fn, arg_sets):
        """Device ms of ``fn`` with `gemv_plan` swapped for one of ``splits``
        splits."""
        plan = fd.gemv_plan

        def forced(tiles, width, rows, groups, sm_count, **_):
            slice_ = -(-rows // splits)
            return fd.GemvPlan(width, -(-slice_ // 16) * 16 if splits > 1 else rows, splits)
        fd.gemv_plan = forced
        try:
            return timed(fn, arg_sets)
        finally:
            fd.gemv_plan = plan

    for k_ in (256, 2048):
        lone = [(randn(8, k_), randn(k_, fd.OUT_WIDTH) * k_ ** -0.5, randn(8, fd.OUT_WIDTH))]
        gemv_ms[f"out_residual one block B8 K{k_} N{fd.OUT_WIDTH}"] = timed_with_splits(
            1, out_residual, lone)
    # out_residual's tiles at 64 columns (128-byte rows: one L1 line; 32
    # tiles x 4 splits) and 32, against the 128 taken
    out_width = fd.OUT_WIDTH
    for width_ in (64, 32):
        fd.OUT_WIDTH = width_
        try:
            gemv_ms[f"out_residual qwen B8 D2048 width {width_}"] = timed(out_residual, out_sets)
        finally:
            fd.OUT_WIDTH = out_width
    for splits_ in (4, 6, 8):
        gemv_ms[f"out_residual qwen B8 D2048 splits {splits_}"] = timed_with_splits(
            splits_, out_residual, out_sets)
        gemv_ms[f"qkv_rope qwen B8 D2048 splits {splits_}"] = timed_with_splits(
            splits_, run_qkv, qkv_sets)
    # the large decoders' qkv_rope at B 8 with other split counts than the
    # plan's 2: at one block an SM (over 116 KB of shared memory a block up
    # to 4 splits), 72 tiles x 2 splits is 144 blocks, 12 past one wave of
    # 132, where nemotron-4-15b's 64 x 2 fit one
    for label, (d_, h_, kv_, hd_) in large_shapes().items():
        q_sets, _, _, _ = gemv_sets(8, d_, h_, kv_, hd_, bias=False)
        for splits_ in (2, 3, 4, 8):
            gemv_ms[f"qkv_rope {label} B8 D{d_} splits {splits_}"] = timed_with_splits(
                splits_, run_qkv, q_sets)
        del q_sets
    emit("gemv_scaling", ms=gemv_ms, plans=gemv_plans, sms=sms, dtype="bf16", card=smi)

    # the SSD scan at mamba2-370m's prefill; operations as the kernel's
    # chunks of 64 need them: C.B^T, W x, C S^T and the state update
    b, L, h, p, n, q = 8, 512, 32, 64, 128, 64
    nbytes = 2 * (2 * b * L * h * p + 2 * b * L * n) + 4 * (b * L * h + h + b * h * p * n)
    sets = copies(lambda: ssd_inputs(b, L), nbytes)
    flops = 2 * b * h * (L // q) * (q * q * n + q * q * p + 2 * q * p * n)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    times["ssd_scan"] = dict(
        ms=timed(lambda *a: ssd_scan(*a), sets, iters=10),
        plain_ms=timed(lambda *a: ssd_scan_plain(*a, chunk=128), sets, iters=10),
        library_ms=None, library="none: no PyTorch call computes the SSD scan",
        bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes)
    rows.append(("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:27", times["ssd_scan"]))
    # how the scan's time scales: the batch (blocks: H x B, 1 or 2 waves'
    # worth of SMs) and the length (chunks walked in order by each block)
    ssd_ms = {}
    for b_, L_ in ((1, 512), (8, 512), (1, 2048), (8, 2048)):
        nb = nbytes * b_ * L_ // (b * L)
        ssd_ms[f"B{b_} L{L_}"] = timed(lambda *a: ssd_scan(*a),
                                      copies(lambda: ssd_inputs(b_, L_), nb), iters=10)
    emit("ssd_scaling", ms=ssd_ms, shape=f"H{h} P{p} N{n} bf16", sms=sms,
         blocks_per_sm=blocks_per_sm(bf16), blocks_per_sm_float32=blocks_per_sm(torch.float32),
         card=smi)
    # jamba-1.5-large's shapes (phase 16): the attention kernels, the chain's
    # GEMVs and rmsnorm at its D 8192, H64 KV8 hd128 (as above); the scan at
    # its prefill (B8 L512, 256 heads of 64, N 128) and the gated norm at its
    # decode and prefill rows (width 16384), bounds, plain versions and
    # yardsticks as at mamba2-370m's shapes below
    for k_, cases in shape_times("jamba", *attention_shape(JAMBA)).items():
        times[k_]["hybrid_shapes"] = cases
    mh, mp, mn = jamba_mamba_shape()
    b_, L_, q_ = 8, 512, 64
    nb = 2 * (2 * b_ * L_ * mh * mp + 2 * b_ * L_ * mn) + 4 * (b_ * L_ * mh + mh
                                                                + b_ * mh * mp * mn)
    fl = 2 * b_ * mh * (L_ // q_) * (q_ * q_ * mn + q_ * q_ * mp + 2 * q_ * mp * mn)
    b_ms, b_by = bound(nb, fl, BF16_FLOP_PER_S)
    sets = copies(lambda: ssd_inputs(b_, L_, mh, mp, mn, memory="long"), nb)
    times["ssd_scan"]["hybrid_shapes"] = {f"jamba B{b_} L{L_} H{mh} P{mp} N{mn}": dict(
        ms=timed(lambda *a: ssd_scan(*a), sets, iters=10),
        plain_ms=timed(lambda *a: ssd_scan_plain(*a, chunk=128), sets[:2], iters=4),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, flops=fl, bytes=nb)}
    del sets
    gated_jamba = {}
    for lead in ((8,), (8, 512)):
        n_rows = int(np.prod(lead))
        dn = mh * mp
        n = n_rows * dn
        nb = 4 * n * 2 + dn * 4 + mh * 4
        sets = copies(lambda: gated_inputs(lead, mh, mp), nb + n * 2)
        plan = rn.norm_plan(n_rows, dn, 2, gated=True, aligned=True, card=card)
        b_ms, b_by = bound(nb, 11 * n, F32_FLOP_PER_S)
        gated_jamba[f"jamba ({n_rows}, {dn})"] = dict(
            ms=timed(lambda *a: rmsnorm_gated(*a), sets),
            plain_ms=timed(lambda *a: rmsnorm_gated_plain(*a), sets), library_ms=None,
            yardstick_ms=timed(unfused, sets),
            # a row of 16384 is past the row kernel: the cluster kernel, an
            # empty kernel on its plan's grid (in clusters) beside it
            floor_ms=timed(lambda *_: rn.launch_floor(plan), sets) if plan.warps else None,
            kernel="cluster" if plan.cluster else "row" if plan.warps else "wide",
            bound_ms=b_ms, bound_by=b_by, plan=plan._asdict(), bytes=nb)
        del sets
    times["rmsnorm_gated"]["hybrid_shapes"] = gated_jamba
    emit("times_hybrid", card=smi, **{k: times[k]["hybrid_shapes"] for k in (
        "flash_attention", "decode_attention", "fused_decode", "rmsnorm", "ssd_scan",
        "rmsnorm_gated")})
    torch.cuda.empty_cache()

    # the forwards past the row kernel, on the cluster kernel: jamba's gated
    # norm (16384) and the plain norm at 16384 and 8192 (float32) over a
    # decode step's 8 rows and a prefill's 4096, in bf16 and float32: each
    # checked against its plain version, its route by the counters, called
    # twice and compared bitwise; then timed beside the wide kernel it
    # replaces (``wide_ms``: the plans forced to it, in the same call), the
    # bound, the plain version, ``F.rms_norm`` (the plain norm) or the
    # yardstick (the gated: the op-by-op torch body, then the norm) and an
    # empty kernel on its grid
    def forward_inputs(gated, rows, d, dtype):
        if gated:
            return gated_inputs((rows,), mh, mp, dtype=dtype)
        return randn(rows, d, dtype=dtype), 1.0 + 0.1 * randn(d, dtype=torch.float32)

    forward_shapes = [(gated, d, rows, dtype) for gated, d, dtypes in (
        (True, mh * mp, (bf16, torch.float32)), (False, 16384, (bf16, torch.float32)),
        (False, 8192, (torch.float32,))) for dtype in dtypes for rows in (8, 4096)]
    twice, fwd_by_shape = [], {}
    for gated, d, n_rows, dtype in forward_shapes:
        name = "rmsnorm_gated" if gated else "rmsnorm"
        fn = rmsnorm_gated if gated else rmsnorm
        counter = rn.rmsnorm_gated_cluster if gated else rn.rmsnorm_cluster
        elem = 2 if dtype == bf16 else 4
        case = f"({n_rows}, {d}) {str(dtype)[6:]}"
        args = forward_inputs(gated, n_rows, d, dtype)
        before = counter.launches
        got = fn(*args)
        torch.cuda.synchronize()
        if counter.launches != before + 1:
            raise AssertionError(f"{name} {case}: the cluster kernel did not launch")
        tol = ATOL if dtype == bf16 else F32_TOL
        check(name, f"{case} on the cluster kernel", got,
              (rmsnorm_gated_plain if gated else rmsnorm_plain)(*args), tol, tol)
        twice.append((f"{name} {case}", torch.equal(got, fn(*args))))
        del args, got
        # y, xh, z read and the rows written (gated), or x read and written;
        # the weight (and d_skip) read
        nb = (4 if gated else 2) * elem * n_rows * d + 4 * d + (4 * mh if gated else 0)
        sets = copies(lambda: forward_inputs(gated, n_rows, d, dtype),
                      nb + (elem * n_rows * d if gated else 0))
        plan = rn.norm_plan(n_rows, d, elem, gated=gated, aligned=True, card=card)
        b_ms, b_by = bound(nb, (11 if gated else 4) * n_rows * d, F32_FLOP_PER_S)
        with wide_plans():
            wide = timed(lambda *a: fn(*a), sets)
        plain = rmsnorm_gated_plain if gated else rmsnorm_plain
        fwd_by_shape[f"{name} {case}"] = dict(
            ms=timed(lambda *a: fn(*a), sets), wide_ms=wide,
            plain_ms=timed(lambda *a: plain(*a), sets[:2], iters=10),
            **(dict(yardstick_ms=timed(unfused, sets), library_ms=None) if gated else dict(
                library_ms=timed(lambda x, w: F.rms_norm(x, (d,), w, 1e-5), sets),
                library_same_dtype_weight_ms=timed(
                    lambda x, w: F.rms_norm(x, (d,), w.to(dtype), 1e-5), sets))),
            floor_ms=timed(lambda *_: rn.launch_floor(plan), sets),
            bound_ms=b_ms, bound_by=b_by, bytes=nb, plan=plan._asdict(),
            clusters=rn.clusters_launched(plan, elem, gated=gated, backward=False))
        del sets
    emit("forward_bitwise_cluster", cases=dict(twice), ok=all(v for _, v in twice),
         what="each forward twice on the same inputs")
    if not all(v for _, v in twice):
        raise AssertionError(f"a forward gave other bits on a second call: "
                             f"{[k for k, v in twice if not v]}")
    emit("kernel_time_cluster_forward", card=smi, shapes=fwd_by_shape)
    torch.cuda.empty_cache()

    emit("times", shapes={"rmsnorm": "(8, 2048) decode (by_shape: also (8, 1024) and "
                                     "(4096, 2048) prefill), bf16, float32 weight",
                          "rmsnorm_gated": "(8, 2048) decode (by_shape: also (4096, 2048) "
                                           "prefill), H32 P64, bf16, z rows 4096 apart",
                          "flash_attention": "B8 S512 H16 KV2 D128 causal bf16",
                          "decode_attention": "B8 H16 KV2 hd128 C544 cache_len 544 bf16",
                          "fused_decode": "qwen sublayer B8 D2048 H16 KV2 hd128 bias C544 "
                                          "pos 543 bf16",
                          "ssd_scan": "B8 L512 H32 P64 N128 bf16"},
         times=times, card=smi)

    # -- 7. where a decode step's device time goes -------------------------
    def profile_decode(cfg, params, prompts):
        """Device busy a step from ``torch.profiler`` (the card alone, so the
        profiler adds no host work to the steps), and the idle share against
        the wall time of as many steps run with no profiler at all."""
        with torch.no_grad():
            full = {"tokens": torch.from_numpy(
                np.stack([np.resize(p, 512) for p in prompts])).to(dev)}
            _, cache = lm.prefill(cfg, params, full, capacity=512 + 8)
            feed = torch.zeros((8, 1), dtype=torch.long, device=dev)
            lm.decode_step(cfg, params, cache, feed)
            torch.cuda.synchronize()
            n_steps = 8
            t0 = time.perf_counter()
            for _ in range(n_steps):
                lm.decode_step(cfg, params, cache, feed)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n_steps):
                    lm.decode_step(cfg, params, cache, feed)
                torch.cuda.synchronize()
                profiled_wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        kern = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        busy_us = sum(e.device_time_total for e in kern) / n_steps
        top = sorted(kern, key=lambda e: e.device_time_total, reverse=True)[:10]
        emit("profile", what=f"decode_step, {cfg.name}, B8, cache 520", steps=n_steps,
             wall_ms_per_step=wall_ms, profiled_wall_ms_per_step=profiled_wall_ms,
             device_busy_ms_per_step=busy_us / 1e3,
             device_idle_share=max(0.0, 1 - busy_us / 1e3 / wall_ms),
             kernel_launches_per_step=sum(e.count for e in kern) / n_steps,
             top_kernels=[{"name": e.key[:90],
                           "ms_per_step": e.device_time_total / n_steps / 1e3,
                           "calls_per_step": e.count / n_steps} for e in top])

    profile_decode(cfg, params, prompts)
    profile_decode(m_cfg, m_params, m_prompts)

    def profile_prefill(cfg, params, prompts, scan="ssd_scan_kernel"):
        """One prefill of the serving round's 8 prompts at its bucket: device
        busy from ``torch.profiler`` against the wall time of unprofiled
        prefills, and the scan's share of the busy time."""
        bucket = _bucket(max(map(len, prompts)))
        toks = np.zeros((len(prompts), bucket), np.int64)
        for i, p_ in enumerate(prompts):
            toks[i, bucket - len(p_):] = p_
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        n_runs = 4
        with torch.no_grad():
            lm.prefill(cfg, params, batch, capacity=bucket + 32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_runs):
                lm.prefill(cfg, params, batch, capacity=bucket + 32)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n_runs
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(n_runs):
                    lm.prefill(cfg, params, batch, capacity=bucket + 32)
                torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        busy_ms = sum(e.device_time_total for e in kern) / n_runs / 1e3
        scan_ms = sum(e.device_time_total for e in kern if scan in e.key) / n_runs / 1e3
        top = sorted(kern, key=lambda e: e.device_time_total, reverse=True)[:8]
        emit("profile", what=f"prefill, {cfg.name}, B{len(prompts)}, bucket {bucket}",
             runs=n_runs, wall_ms=wall_ms, device_busy_ms=busy_ms,
             device_idle_share=max(0.0, 1 - busy_ms / wall_ms), scan_ms=scan_ms,
             scan_share_of_busy=scan_ms / busy_ms if busy_ms else None,
             kernel_launches=sum(e.count for e in kern) / n_runs,
             top_kernels=[{"name": e.key[:90], "ms": e.device_time_total / n_runs / 1e3,
                           "calls": e.count / n_runs} for e in top])

    profile_prefill(m_cfg, m_params, m_prompts)

    # -- 8. pipelined serving on the same weights ---------------------------
    # after the timing and profiling phases: run before them (right after
    # phase 4), it left torch.profiler recording less kernel time in
    # phase 6 (flash attention 0.013-0.032 ms where it takes 0.065, the
    # SSD scan 0.010-0.025 ms, under its bytes bound); the cause is not
    # known
    def timed_serve(server, reqs, kernels, profile=False):
        """One counted serve: launch counts and the peak-memory mark reset
        just before it, read just after (the peak, the peak over what was
        allocated before: the other model's weights stay resident, and
        what the serve left allocated: the pipeline's last logits a
        group); with ``profile`` under ``torch.profiler`` (the card
        alone)."""
        server.stats = ServeStats()
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) \
            if profile else None
        if prof is not None:
            prof.__enter__()
        t0 = time.perf_counter()
        outs = server.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        launches = {k: fn.launches for k, fn in kernels.items()}
        missing = [k for k, n in launches.items() if n == 0]
        if missing:
            raise AssertionError(f"a {server.cfg.name} serve launched no {missing} kernel")
        gen = sum(len(o.tokens) for o in outs)
        summary = server.stats.summary()
        rec = dict(wall_s=wall, prefill_tok_per_s=summary["prefill_tok_per_s"],
                   decode_tok_per_s=summary["decode_tok_per_s"], generated_tokens=gen,
                   launches=launches, port_kernel_launches_per_token=sum(launches.values()) / gen,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   peak_over_start=torch.cuda.max_memory_allocated() - before,
                   left_allocated=torch.cuda.memory_allocated() - before)
        if prof is not None:
            busy, total, n_kern = kernel_busy(prof)
            if not n_kern:          # a profiler window now and then records nothing
                busy = total = None
            rec.update(profiled_wall_s=wall, device_busy_ms=busy, kernel_ms_summed=total,
                       device_idle_share=None if busy is None
                       else max(0.0, 1 - busy / 1e3 / wall),
                       kernel_launches_per_token=n_kern / gen)
        return outs, rec

    def pipelined(name, params, prompts, pps, kernels, variants, profile=False):
        """The requests through the single-device server at max_batch 4,
        then through the pipeline in each variant: tokens must be equal.
        ``profile``: serve the first variant once more, profiled and
        traced (the profiler's events take seconds to read back).
        Returns what the resilience phase reuses: the plan, its graph and
        shape, the single-device tokens, the first variant's launches and
        the traced serve with its stage map."""
        cfg = get_config(name)
        shape = ShapeCfg("serve_decode", 512, 4, "decode")
        t0 = time.perf_counter()
        # one card: no node can split across cards (max_tp 1); the budget is
        # the card, and the plan still takes a chip a node, all on this one
        plan = planner.plan(cfg, shape, chips=1, hw=HW_H100, max_tp=1)
        stg, _ = lm_graph.build_stg(cfg, shape, hw=HW_H100, max_tp=1)
        plan_s = time.perf_counter() - t0
        reqs = [Request(uid=i, prompt=p_, max_new=32) for i, p_ in enumerate(prompts)]
        warm = [Request(uid=i, prompt=p_, max_new=2) for i, p_ in enumerate(prompts)]
        single = LMServer(cfg, max_batch=4, params=params, device="cuda")
        single.serve(warm)
        want, rec = timed_serve(single, reqs, kernels)
        want_tokens = [o.tokens for o in want]
        steps = np.array(single.stats.decode_step_s)
        emit("pipeline", config=cfg.name, backend="single-device LMServer(max_batch=4)",
             decode_step_p50_ms=float(np.percentile(steps, 50) * 1e3), **rec)
        emit("plan", config=cfg.name, shape="decode B4 512 tokens", hw=HW_H100.name,
             chips=1, max_tp=1, seconds=plan_s, summary=plan.summary().splitlines()[0],
             choices=sorted({(s_.impl, s_.replicas) for s_ in plan.stages}),
             nodes=len(plan.stages))
        for i, variant in enumerate(variants):
            pipe = DecodePipeline(cfg, stg, plan, params=params, periods_per_stage=pps,
                                  device="cuda", **variant)
            server = LMServer(cfg, max_batch=4, pipeline=pipe, device="cuda")
            pipe.warm([r.prompt for r in reqs], 32, group_size=4)
            warm_compiles = pipe.compile_stats.compiles
            got, rec = timed_serve(server, reqs, kernels)
            run = server.last_run
            late = pipe.compile_stats.late
            emit("pipeline", config=cfg.name, backend="DecodePipeline", periods_per_stage=pps,
                 variant={k: str(v) for k, v in variant.items()}, stages=pipe.stage_names,
                 replicas=[len(d) for d in pipe.stage_devices], groups=len(run.groups),
                 streams_used=run.streams_used, max_inflight=run.max_inflight,
                 stage_seconds=run.stage_seconds, stage_firings=run.stage_firings,
                 stage_host_us={n: run.stage_host_us(n) for n in pipe.stage_names},
                 slo=run.slo(), compile_stats=pipe.compile_stats.summary(), late=late,
                 compiles_in_serve=pipe.compile_stats.compiles - warm_compiles,
                 tokens_equal=[o.tokens for o in got] == want_tokens, **rec)
            if [o.tokens for o in got] != want_tokens:
                bad = [j for j, o in enumerate(got) if o.tokens != want_tokens[j]]
                raise AssertionError(f"{cfg.name} pipelined {variant}: requests {bad} differ "
                                     f"from the single-device server")
            if late:
                raise AssertionError(f"{cfg.name} pipelined {variant}: {late} first launches "
                                     f"inside the serve")
            if pipe.overlap and run.streams_used < 2:
                raise AssertionError(f"{cfg.name} pipelined {variant}: ops ran on "
                                     f"{run.streams_used} stream(s)")
            if i == 0:
                ctx = dict(plan=plan, stg=stg, shape=shape, want=want_tokens,
                           launches=rec["launches"], traced=None)
            if i == 0 and profile:
                # profiled and traced: how long each stage waited, and on what
                server.tracer = Tracer()
                _, rec = timed_serve(server, reqs, kernels, profile=True)
                run = server.last_run
                emit("pipeline_profile", config=cfg.name, backend="DecodePipeline",
                     periods_per_stage=pps, variant={}, traced=True, **rec)
                emit("pipeline_trace", config=cfg.name, periods_per_stage=pps, variant={},
                     wall_s=rec["wall_s"], stage_wait_s=run.stage_wait_s,
                     stall_share={n: sum(w.values()) / run.wall_s
                                  for n, w in run.stage_wait_s.items()},
                     busy_share={n: t / run.wall_s for n, t in run.stage_seconds.items()},
                     bottleneck=stall_bottleneck(server.tracer))
                server.tracer = None
                ctx["traced"] = (run, pipe.graph_stage_map())
            pipe.close()
            del pipe, server
        return ctx

    t_phase = time.perf_counter()
    fd._composed_step.calls = 0
    qwen_kernels = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
                    "fused_qkv_rope": qkv_rope, "decode_attention": decode_attention,
                    "fused_out_residual": out_residual}
    qwen_ctx = pipelined("qwen2.5-3b", params, prompts, 9, qwen_kernels,
                         [{}, {"fusion_plan": "auto"}, {"overlap": False}], profile=True)
    pipe_launches = qwen_ctx["launches"]
    if fd._composed_step.calls:
        raise AssertionError(f"a pipelined qwen decode step left the fused chain: "
                             f"_composed_step called {fd._composed_step.calls} times")
    mamba_kernels = {"rmsnorm": rmsnorm, "rmsnorm_gated": rmsnorm_gated, "ssd_scan": ssd_scan}
    mamba_ctx = pipelined("mamba2-370m", m_params, m_prompts, 12, mamba_kernels, [{}])
    m_pipe_launches = mamba_ctx["launches"]
    emit("pipeline_phase", seconds=time.perf_counter() - t_phase)

    # -- 9. resilience on phase 8's weights, requests and plans -------------
    t_phase = time.perf_counter()
    fd._composed_step.calls = 0
    drill_launches, replay_launches = resilience(
        get_config("qwen2.5-3b"), params, prompts, 9, qwen_ctx, qwen_kernels, full=True)
    m_drill_launches, m_replay_launches = resilience(
        get_config("mamba2-370m"), m_params, m_prompts, 12, mamba_ctx, mamba_kernels,
        full=False)
    if fd._composed_step.calls:
        raise AssertionError(f"a drill's qwen decode step left the fused chain: "
                             f"_composed_step called {fd._composed_step.calls} times")
    emit("resilience_phase", seconds=time.perf_counter() - t_phase)

    # -- 10. training, after the serving models are freed -------------------
    # the pipelines' close() freed the cuBLAS workspaces of their threads
    # and streams; what is left is the serving models and their contexts
    before = torch.cuda.memory_allocated()
    del params, m_params, qwen_ctx, mamba_ctx
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    emit("train_phase_start", memory_allocated_before=before,
         memory_allocated=torch.cuda.memory_allocated())
    train_rows, train_launches = training(check, copies, bound, smi)
    rows.extend(train_rows)
    emit("train_phase", seconds=time.perf_counter() - t_phase)

    # -- 11. the paper's STG path on the host --------------------------------
    t_phase = time.perf_counter()
    stg_phase()
    emit("stg_phase_seconds", seconds=time.perf_counter() - t_phase)

    # -- 12. the two large dense decoders, served at full width and depth ----
    t_phase = time.perf_counter()
    large_rounds = large_serving(ab, profile_decode, qwen_kernels, smi)
    emit("large_phase", seconds=time.perf_counter() - t_phase)

    # -- 13. training through the microbatch pipeline -----------------------
    # what phase 12 left cached goes back to the card first: the pipeline's
    # stage streams draw on the cache of their own
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    pipe_train_launches = pipelined_training(smi)
    emit("pipe_train_phase", seconds=time.perf_counter() - t_phase)

    # -- 14. the prefix families: seamless-m4t-medium and internvl2-26b ------
    t_phase = time.perf_counter()
    prefix_rounds = prefix_families(ab, profile_decode, qwen_kernels, smi)
    emit("prefix_phase", seconds=time.perf_counter() - t_phase)

    # -- 15. the MoE decoders: llama4-scout (12 layers) and -maverick (2) ---
    t_phase = time.perf_counter()
    moe_rounds = moe_serving(ab, qwen_kernels, smi)
    emit("moe_phase", seconds=time.perf_counter() - t_phase)

    # -- 16. the hybrid: jamba-1.5-large, its first four layers --------------
    t_phase = time.perf_counter()
    hybrid_rounds = hybrid_serving(
        ab, profile_decode, dict(qwen_kernels, rmsnorm_gated=rmsnorm_gated, ssd_scan=ssd_scan),
        smi, decode_ms=decode_p50_ms["qwen2.5-3b"])
    emit("hybrid_phase", seconds=time.perf_counter() - t_phase)

    # -- 18. the one-rank mesh: qwen2.5-3b trained and served through it ----
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    mesh_tokens, mesh_rounds, mesh_placed = mesh_phase(get_config("qwen2.5-3b"), prompts, smi)
    same = mesh_tokens == served_tokens["qwen2.5-3b"]
    emit("mesh_phase", seconds=time.perf_counter() - t_phase, tokens_equal_phase_4=same)
    if not same:
        raise AssertionError("the meshed server's tokens differ from phase 4's")

    # -- 19. the pipelines over two ranks that share the card ----------------
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    rank_tokens, rank_rounds = ranks_phase(smi, {"qwen2.5-3b": prompts,
                                                 "mamba2-370m": m_prompts})
    want = dict(served_tokens, drills=served_tokens["qwen2.5-3b"])
    same = {name: rank_tokens[name] == want[name] for name in rank_tokens}
    emit("ranks_phase", seconds=time.perf_counter() - t_phase, tokens_equal_phase_4=same,
         card=smi)
    if not all(same.values()):
        raise AssertionError(f"the 2-rank pipelines' tokens differ from phase 4's: {same}")

    # -- 20. the dry run: the production meshes on a fake group (host) -------
    t_phase = time.perf_counter()
    dryrun_phase(smi, mesh_placed)
    emit("dryrun_phase", seconds=time.perf_counter() - t_phase, where=DRYRUN_WHERE, card=smi)

    # -- 17. the record of the kernels, the card, the result ----------------
    # launches from the serving round that runs each kernel: qwen's for the
    # attention kernels, rmsnorm and the chain (counted once a chain, by its
    # first kernel; its other two launched as often), mamba2-370m's for the
    # scan and the gated norm; ``pipeline_launches`` the same from the
    # first pipelined serve of each model (phase 8), ``drill_launches``
    # from each model's first crash drill and ``replay_launches`` from
    # that drill's cache replay run again alone (phase 9); ``train_launches``
    # from the 4 timed steps of qwen2.5-3b's training (phase 10), and of
    # mamba2-370m's for the SSD scan, the gated norm and their backward;
    # the backward kernels' ``launches`` come from there (each of their calls
    # launches the kernels listed); ``large_launches`` from each counted
    # round of phase 12; ``pipe_train_launches`` from qwen2.5-3b's 1F1B run
    # through the microbatch pipeline (phase 13), and mamba2-370m's for the
    # SSD scan, the gated norm and their backward; ``prefix_launches`` from
    # each counted run of phase 14, ``moe_launches`` from each of phase 15,
    # ``hybrid_launches`` from each of phase 16, ``mesh_launches`` from the
    # meshed train loop and serving round of phase 18, ``rank_launches``
    # from each two-rank run of phase 19, by rank
    cuda_kernels = {
        "rmsnorm": ["rmsnorm_rows_kernel", "rmsnorm_cluster_kernel", "rmsnorm_wide_kernel"],
        "rmsnorm_gated": ["rmsnorm_rows_kernel", "rmsnorm_cluster_kernel", "rmsnorm_wide_kernel"],
        "flash_attention": ["flash_attention_mma_kernel"],
        "decode_attention": ["decode_attention_kernel"],
        "fused_decode": ["fused_qkv_rope_kernel", "decode_attention_kernel",
                         "fused_out_residual_kernel"],
        "ssd_scan": ["ssd_scan_kernel"],
        "flash_attention_bwd": ["flash_bwd_rows_kernel", "flash_bwd_dkdv_wgmma_kernel",
                                "flash_bwd_dq_wgmma_kernel", "flash_bwd_dot_kernel",
                                "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"],
        "rmsnorm_bwd": ["rmsnorm_bwd_rows_kernel", "rmsnorm_bwd_cluster_kernel",
                        "rmsnorm_bwd_kernel", "rmsnorm_dw_kernel"],
        "rmsnorm_bwd_cluster": ["rmsnorm_bwd_cluster_kernel", "rmsnorm_dw_kernel"],
        "ssd_scan_bwd": ["ssd_bwd_states_kernel", "ssd_bwd_chunk_mma_kernel", "ssd_bwd_da_kernel",
                         "ssd_bwd_chunk_kernel"],
        "rmsnorm_gated_bwd": ["rmsnorm_gated_bwd_rows_kernel",
                              "rmsnorm_gated_bwd_cluster_kernel", "rmsnorm_gated_bwd_kernel",
                              "rmsnorm_gated_tail_kernel"],
        "rmsnorm_gated_bwd_cluster": ["rmsnorm_gated_bwd_cluster_kernel",
                                      "rmsnorm_gated_tail_kernel"]}
    backward = ("flash_attention_bwd", "rmsnorm_bwd", "ssd_scan_bwd", "rmsnorm_gated_bwd")
    cluster = ("rmsnorm_bwd_cluster", "rmsnorm_gated_bwd_cluster")
    not_served = dict.fromkeys(backward + cluster, 0)
    # the cluster kernels' launches: jamba's train A/B (phase 16), whose norms
    # are past the row kernels
    jamba_train = next(n for r, n in hybrid_rounds.items() if r.endswith("train A/B"))
    served = dict(launches, fused_decode=launches["fused_qkv_rope"],
                  ssd_scan=m_launches["ssd_scan"], rmsnorm_gated=m_launches["rmsnorm_gated"],
                  **{k: train_launches[k] for k in backward},
                  **{k: jamba_train[k] for k in cluster})
    piped = dict(not_served, **pipe_launches, fused_decode=pipe_launches["fused_qkv_rope"],
                 ssd_scan=m_pipe_launches["ssd_scan"],
                 rmsnorm_gated=m_pipe_launches["rmsnorm_gated"])
    drilled = dict(not_served, **drill_launches, fused_decode=drill_launches["fused_qkv_rope"],
                   ssd_scan=m_drill_launches["ssd_scan"],
                   rmsnorm_gated=m_drill_launches["rmsnorm_gated"])
    replayed = dict(not_served, **replay_launches,
                    fused_decode=replay_launches["fused_qkv_rope"],
                    ssd_scan=m_replay_launches["ssd_scan"],
                    rmsnorm_gated=m_replay_launches["rmsnorm_gated"])
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "cuda_kernels": cuda_kernels[name], "launches": served[name],
         "pipeline_launches": piped[name], "drill_launches": drilled[name],
         "replay_launches": replayed[name], "train_launches": train_launches.get(name, 0),
         "pipe_train_launches": pipe_train_launches.get(name, 0),
         "large_launches": {r: dict(n, fused_decode=n["fused_qkv_rope"]).get(name, 0)
                            for r, n in large_rounds.items()},
         "prefix_launches": {r: dict(n, fused_decode=n.get("fused_qkv_rope", 0)).get(name, 0)
                             for r, n in prefix_rounds.items()},
         "moe_launches": {r: dict(n, fused_decode=n.get("fused_qkv_rope", 0)).get(name, 0)
                          for r, n in moe_rounds.items()},
         "hybrid_launches": {r: dict(n, fused_decode=n.get("fused_qkv_rope", 0)).get(name, 0)
                             for r, n in hybrid_rounds.items()},
         "mesh_launches": {r: dict(n, fused_decode=n.get("fused_qkv_rope", 0)).get(name, 0)
                           for r, n in mesh_rounds.items()},
         "rank_launches": {run: {rank: dict(n, fused_decode=n.get("fused_qkv_rope", 0)).get(
             name, 0) for rank, n in by_rank.items()} for run, by_rank in rank_rounds.items()},
         "max_abs_err": errors[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
         **({"yardstick_ms": t["yardstick_ms"]} if "yardstick_ms" in t else {}),
         **({"large_shapes": t["large_shapes"]} if "large_shapes" in t else {}),
         **({"prefix_shapes": t["prefix_shapes"]} if "prefix_shapes" in t else {}),
         **({"moe_shapes": t["moe_shapes"]} if "moe_shapes" in t else {}),
         **({"hybrid_shapes": t["hybrid_shapes"]} if "hybrid_shapes" in t else {}),
         **({"forward_with_lse": t["forward_with_lse"]} if "forward_with_lse" in t else {}),
         **{k: t[k] for k in ("rows_ms", "dkdv_ms", "dq_ms") if k in t},
         **({"floor_ms": t["floor_ms"], "by_shape": {s: {k: v[k] for k in (
             "ms", "floor_ms", "plain_ms", "bound_ms", "library_ms")} for s, v in
             t["by_shape"].items()}} if "by_shape" in t else {}),
         **({"parts": [dict(name=part, **({"launches": launches[part]} if part in launches
                                          else {}), **{
             k: p[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                               "yardstick_ms") if k in p})
             for part, p in t["parts"].items()]} if "parts" in t else {})}
        for name, source, replaces, t in rows]}), flush=True)
    emit("elapsed", seconds=round(time.perf_counter() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
