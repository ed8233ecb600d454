#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card, end to end.

    python3 chip_smoke.py [--out results.json]

Phases, each of which raises on failure (nothing is caught and skipped):

1. Device and build: the card's name and power limit (``nvidia-smi``), and
   the ``rir_matmul``, ``gqa_decode``, ``linear_scan`` and ``birrd_apply``
   CUDA kernels built from ``src/repro_torch/kernels/csrc``, one ``nvcc``
   each, started together (seconds and ``ptxas`` report printed).
2. Planning: ResNet-50 and MobileNet-V3 at batch 8 with the serve engine's
   planner options, through one plan cache the engine then reuses.
3. Kernel vs plain on the card: ``rir_matmul`` against
   ``repro_torch.kernels.ref.rir_matmul`` over the JAX kernel sweep's shapes
   in f32 and bf16, with and without residual, random and identity perms,
   ragged M/K, and at each of the twelve ResNet-50 batch-8 plan steps, where
   it is also timed against the plain version, ``torch.matmul`` (yardstick
   only) and the card's bound.
4. Networks on the card: ``execute_network`` on ResNet-50 and MobileNet-V3
   at batch 8 against ``execute_network_reference`` on the CPU, one kernel
   launch per layer.
5. Serving (the main path): ``api.ServeEngine`` on ResNet-50 at
   ``max_batch=8`` with 2 workers; ragged requests, then the same requests
   one at a time; bit-identical outputs, 12 launches per batch.
6. Throughput and profile: the same serving with tracing off, three
   windows of 400 requests for requests/s and its spread, then one more
   under ``torch.profiler``: the device's busy share and its time by kernel.
7. ``gqa_decode`` against ``repro_torch.kernels.ref.gqa_decode`` on the
   card: the JAX sweep's shapes in f32 and bf16 with lengths in [S/2, S],
   a ragged S, length 1 and lengths on split boundaries, zamba2's decode
   shape (B 8, Hq = Hkv = 32, D 80, lengths 64-80); then the
   llama3.2-3b decode shape (B 8, Hq 24, Hkv 8, D 128, S 1024, lengths
   960-1023, bf16), timed over one cache per layer (as decode reads them)
   against the plain version, ``scaled_dot_product_attention`` (yardstick
   only) and the byte bound: each by device time (its kernels' profiler
   events), queued behind a spin kernel and in CUDA events.
8. LM serving (the LM path): ``api.ServeEngine`` on llama3.2-3b at full
   width (28 layers, random weights from a seed) at ``max_batch=8``,
   ``prompt_len=960``, ``gen=64``: 16 requests, 1764 ``gqa_decode``
   launches a batch; 4 of them again one a batch, identical tokens; one
   batch under ``torch.profiler``, whose only ``gqa`` device kernel is the
   decode kernel, with no more events than launches; decode logits at 4
   teacher-forced steps against ``hidden_states`` + ``logits`` of the
   whole sequence (bf16).
9. The dense LM in f32 at reduced depth (llama3.2-3b widths, 2 layers, TF32
   off): prefill and 7 decode steps on the card against the same weights
   on the CPU (plain path), rtol/atol 2e-4.
10. ``linear_scan`` against its plain versions on the card: the JAX sweep's
    shapes and dk != dv in f32 and bf16 against
    ``repro_torch.kernels.ref.linear_scan_chunked``, ragged T against the
    stepwise ``ref.linear_scan``, a -60 log decay; then the rwkv6-1.6b
    training shape (B 8, H 32, T 1024, dk = dv = 64, bf16 q/k/v, f32 log
    decay), checked and timed (device time and CUDA events) against the
    plain chunked version and the card's bound; then the autograd
    Function's gradient against autograd through the plain chunked
    version.
11. Training (the training path): ``api.make_train_step`` on rwkv6-1.6b
    at full width (24 layers, random bf16 weights from a seed, f32 AdamW
    state) with the WSD schedule over ``SyntheticLMStream`` at batch 8 x
    seq 1024 for 8 steps: finite losses, the first within 0.5 of ln 65536,
    the last below the first, 48 ``linear_scan`` launches a step (24 in the
    forward, 24 in the remat recompute); step ms, tokens/s, peak memory and
    the share of bf16 peak; one more step under ``torch.profiler``, its
    device time split between the scan's plain backward, AdamW (their
    profiler ranges) and the rest.  Then
    2 layers at rwkv6 widths in f32 (TF32 off): loss and gradients on the
    card against the CPU within 2e-4 of max |g|.
12. rwkv6 serving: ``api.ServeEngine`` at full width with weights drawn
    at 0.05 (at the 0.02 init the scan's output lies below the ``ln_x``
    norm's epsilon and no logits check sees it), ``max_batch=8``, prompt
    128 (scanned in through ``decode_step``), gen 32, 16 requests; 2 of
    them again one a batch, identical tokens.  In bf16, ``hidden_states``
    of a served sequence: each layer's ``linear_scan`` output against the
    plain chunked version on that layer's inputs, within 2e-2 x its max;
    recorded beside it, the logits with the kernel, with the
    plain version and from 4 teacher-forced decode steps after the scan-in
    (in bf16 these three differ by ~3% of max |logit|: rounding carried
    through 24 layers).  Then all 24 layers in f32: decode over 68 tokens
    (the exact recurrence) against ``hidden_states`` within 2e-4 x max
    |logit|.  Each asserts that zeroing the scan's output moves the logits
    by at least 0.1 of their max.

13. ``birrd_apply`` against its plain versions on the card: the JAX
    sweep's cases ((8, 128), (16, 256), (16, 512) with pairs; the pure
    reorder at aw 8), every width 2-64 (a structured relayout routed in
    closed form at 32 and 64), a ragged d and bf16, bit for bit against
    the plain stage loop and within 1e-5 of the RIR oracle; random dense
    stage matrices within 1e-5; then the full-size case (aw 16, the demo's
    groups of 4 to ports 0, 4, 8, 12, d = 401,408 columns, one ResNet-50
    batch-8 conv2 activation) timed against the plain version, one
    ``torch.matmul(P, x)`` with the program composed on the host
    (yardstick only) and the byte bound.  Its times are device time, from
    the kernel events of a ``torch.profiler`` loop (CUDA events around
    the same loop printed beside them; the plain version and the
    yardstick timed with their launches queued behind a spin kernel).
14. The co-switching path: ``repro_torch.launch.coswitch`` parts 1-5 on
    the card (planning, ``rir_matmul``'s epilogue layout and
    ``birrd_reduce`` against the oracle, the planned GEMM chain, ResNet-50
    through ``execute_network``, the joint tile co-search), each check
    asserted; at least 1 ``birrd_apply`` and 3 + 12 ``rir_matmul``
    launches.
15. zamba2 serving: ``api.ServeEngine`` on zamba2-2.7b at full width (54
    Mamba2 layers, d_model 2560, 80 SSM heads, the shared attention block
    9 times, random bf16 weights from a seed at 0.08) at ``max_batch=8``,
    prompt 64 scanned in through ``decode_step``, gen 16, 8 requests: 9
    ``gqa_decode`` launches a step (at B 8, Hq = Hkv = 32, D 80); 2 of
    them again one a batch, identical tokens; one batch under
    ``torch.profiler`` for the device's busy share.  ``gqa_decode`` timed
    at that decode shape as in 7, beside SDPA.  Then
    ``hidden_states`` in bf16 over a served sequence extended to 1024
    tokens: each layer's ``linear_scan`` output
    (H 80, dk = dv = 64) against the plain chunked version on that layer's
    inputs within 2e-2 x its max, the kernel timed at that shape (device
    time) against its plain version and its bound.  Then all 54 layers in f32 (TF32
    off): decode over 68 tokens against ``hidden_states`` within 2e-4 x
    max |logit|.  Each asserts that zeroing the scan's output moves the
    logits by at least 0.1 of their max.
16. The serve CLI: ``repro_torch.launch.serve.main`` with ``--graph
    resnet50 --batch 8 --workers 2`` (its checksum, 12 ``rir_matmul``
    launches a batch, two outputs against the CPU reference) and with
    ``--arch llama3p2_3b --batch 8 --prompt-len 128 --gen 16`` (full width
    and depth, random weights; 28 x 15 ``gqa_decode`` launches a batch:
    the engine's decode loop runs gen - 1 steps after prefill), and with
    ``--arch whisper_small --batch 8`` (2 x 12 x 15 launches a batch).
17. The smokes and the report: ``repro_torch.serve.smoke`` and
    ``repro_torch.obs.smoke --graph resnet50 --check-identical`` on the
    card, the trace through ``repro_torch.obs.report --validate``, and
    the per-step calibration table (measured ``exec.step`` against the
    plan's modeled cycles, ``rel``) of that cold batch-1 run and of 5 warm
    traced runs of the served batch-8 plan.
18. Chaos: ``repro_torch.runtime.chaos --seed 0 --graph resnet50 --arch
    llama3p2_3b`` on the card: every scheduled fault fires, none escapes,
    outputs bit-identical at tier <= 1; its counters, and its
    ``rir_matmul`` and ``gqa_decode`` launches.
19. Resume: ``repro_torch.launch.train --layers 2`` on rwkv6-1.6b at full
    width, batch 8 x 1024: 8 steps straight, then 4 with ``--ckpt-every
    4`` and a resume to 8 in a fresh model that saves at step 6 and 8
    (final loss within rel 1e-4; each step's seconds and the host seconds
    between steps from the trainer's ``train.step`` spans, so the save's
    block of the loop shows at step 6; restore seconds, checkpoint
    bytes); the checkpoint restored into a fresh model gives back every
    bf16 parameter and f32 state bit for bit.  The checkpoints go to a
    temporary directory, removed after.
20. ``gqa_decode`` at the MoE and whisper shapes: G 6 (dbrx, 48/8), G 5
    (llama4-scout, 40/8) and G 1 at D 64 (whisper, 12/12), each at S 1500
    (not a multiple of the split) with full and ragged rows, f32 and bf16,
    against the plain version; whisper's cross-attention shape (B 8, S
    1500) and dbrx's decode shape (B 8, S 144) timed as in 7, beside SDPA.
21. whisper-small served at full width and depth (12 + 12 layers, random
    bf16 weights from a seed, zero stub frames): ``max_batch=8``, prompt
    64, gen 32, 16 requests, 31 x 24 = 744 ``gqa_decode`` launches a
    batch; one batch profiled.  Then the whole model in f32 (TF32 off),
    card against CPU: prefill and 3 teacher-forced decode steps at rtol
    1e-4 / atol 1e-3 and within 2e-4 x max |logit|.
22. dbrx-132b, then llama4-scout, at full width and 4 layers (bf16, random
    weights from a seed; each freed before the next): prefill at batch 8 x
    128 and 15 greedy decode steps through ``build_model`` -> ``prefill``
    -> ``decode_step``, 4 ``gqa_decode`` launches a step; each prefill
    layer's capacity and dropped assignments; 4 teacher-forced bf16 steps
    against the same model with the plain ``ref.gqa_decode`` swapped in
    (rows whose routing flips reported, not held); peak memory.  Then the
    dispatch in f32 at SMOKE widths, card against CPU: identical routing
    wherever the router's k-th and (k+1)-th logits are more than 1e-5
    apart (near-tie flips reported), logits at 2e-4.  Inside dbrx's model
    lifetime (phase 23's third check): one 8 x 128 prefill with each
    layer's MoE block run both through ``moe_apply`` and through the
    expert-parallel ``moe_apply_ep`` on the one-rank NCCL mesh (its
    all-to-alls and gathers called): the same capacity, routing and drops
    (at one rank the shard's capacity is the global one), outputs within
    2e-2 of max |out|.
23. The mesh: one rank over NCCL, a (1, 1) ``("data", "model")`` mesh,
    every block's collective called.  llama3.2-3b at full width and depth
    (bf16, B 8, prompt 960): ``prefill_step`` and 16 ``serve_step``s
    against ``LMModel.prefill``/``decode_step`` on the same weights:
    identical greedy tokens, max |dlogit|, decode ms a token both ways,
    the collectives a step (counted, and their device ms from one
    profiled step) and 28 ``gqa_decode`` launches a step on the local
    head shards.  rwkv6-1.6b at full width and 2 layers, batch 8 x 1024:
    4 steps of ``make_train_step(model, mesh, layout_mode=...)`` in
    ``coswitch`` and in ``fixed`` against the one-device step from the
    same weights, losses within 1e-6 relative, 4 ``linear_scan`` launches
    a step; the step runs ZeRO-1 (every leaf's state a data block, whole
    at one rank: the gradients reduce-scattered onto it, the parameters
    all-gathered from it).
24. Analysis: four cells of ``repro_torch.launch.dryrun`` (llama3.2-3b
    and dbrx-132b ``train_4k``, llama3.2-3b and phi3-mini ``decode_32k``,
    on a fake 16x16 world, one microbatch), each in a subprocess with its
    own time limit,
    their per-device bytes, FLOPs, collective bytes by kind and roofline
    terms printed; ``core.trace_cost.Counter`` on the card's real steps at
    full width (the llama3.2-3b decode step at phase 8's shape, one
    rwkv6-1.6b train step at phase 11's), each counted again on fake CUDA
    tensors of the same shapes (equal, bit for bit) and held against its
    profiled device time (at least 0.95 x its roofline bound on the
    data-sheet rates), its peak of live bytes beside
    ``max_memory_allocated`` less the arguments; and the host cost of
    ``ops.gqa_decode``, a registered ``torch.library`` operator, against
    the kernel's binding called directly, over 1,000 calls.  llama3.2-3b's
    ``decode_32k`` cell keeps its cache split by sequence over the 16 model
    ranks; each cell's roofline row is printed through
    ``repro_torch.launch.roofline``.
25. Attention over the model ranks where the heads do not divide them,
    the split math held on one device (NCCL takes no two ranks on one
    card): (i) ``gqa_decode_partial`` against ``ref.gqa_decode_partial``
    on out, m and l at llama3.2-3b's decode shape (B 8, 24/8, D 128, S
    1024), dbrx's (48/8, S 144) and whisper's cross shape (12/12, D 64, S
    1500), f32 and bf16, rows of length 0 (``(0, -inf, 0)``) among them,
    and timed at llama's against ``ops.gqa_decode`` (profiler events, one
    cache a layer); (ii) llama3.2-3b's ``decode_32k`` attention at full
    width (B 8, S 32768, bf16, 1.07 GB of K+V) as 16 sequence blocks, each
    rank's share through ``blocks.seq_block_partial`` (16
    ``gqa_decode_partial`` launches, counted from 0 around the path) and
    the log-sum-exp merge (``common.merge_partials``), against one whole
    ``gqa_decode`` call within phase 7's bf16 tolerance, and the 16 calls
    plus the merge timed against the one call; (iii) ``chunked_attention``
    at llama's ``train_4k`` width (T 4096, 24/8, dh 128, f32): the 16
    query blocks at their offsets, each over the keys up to its last
    query, against the whole call; (iv) the mesh code's split route on the
    one-rank NCCL mesh: llama3.2-3b at full width and depth through
    ``prefill_step`` and 8 ``serve_step``s with its cache placed split by
    sequence and its attention routed as heads that do not divide the
    model axis (sequence-split prefill; decode's q/k/v rows gathered,
    ``gqa_decode_partial`` on the rank's block, the merge's collectives,
    ``wo``'s row block), against the one-device model on the same weights:
    identical greedy tokens, 28 ``gqa_decode_partial`` launches a step and
    no ``gqa_decode`` launch (the kernel line's launches).

The last two lines are the kernel record and ``{"ok": true, "device": ...}``.
Without CUDA, or without the repository's sources beside it, the script
exits non-zero and prints no result.  TF32 is switched off for PyTorch's
matmul and cuDNN, so every float32 comparison is float32 on both sides.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the spin that holds the card while ``queued_ms`` issues its calls:
# ~0.1 s at the H100's 1.98 GHz boost clock
QUEUE_SPIN_CYCLES = 200_000_000
REPLACES = "src/repro/kernels/rir_matmul.py:66"
SOURCE = "src/repro_torch/kernels/csrc/rir_matmul.cu"
GQA_REPLACES = "src/repro/kernels/gqa_decode.py:61"
GQA_SOURCE = "src/repro_torch/kernels/csrc/gqa_decode.cu"
# float32 sums in another order than cuBLAS's: 2e-4 (the JAX kernel sweep's
# tolerance); bf16 keeps 8 mantissa bits and the plain version rounds before
# the residual add where the kernel adds in f32: 2e-2
TOL = {"f32": 2e-4, "bf16": 2e-2}
# network outputs against the CPU reference: the JAX executor tests' bound,
# and, since MobileNet-V3's ReLU outputs average a few 1e-3 (near that atol),
# also max |err| <= NET_REL x max |y_ref|
NET_TOL = dict(rtol=1e-4, atol=1e-3)
NET_REL = 1e-4
DEV = "cuda"        # where the port runs; the plain reference runs on "cpu"
BATCH = 8           # the serve engine's max_batch: the plans' batch extent
N_REQUESTS = 20     # the bit-identity check's requests
N_WINDOW = 400      # requests per untraced throughput window (50 batches)
N_WINDOWS = 3
# gqa_decode against its plain version: the JAX sweep's tolerances (softmax
# sums in another order, merged across splits)
GQA_TOL = {"f32": 5e-4, "bf16": 3e-2}
# the LM path: llama3.2-3b at full width, random weights from LM_SEED
LM_ARCH = "llama3p2_3b"
LM_SMOKE = False
LM_BATCH = 8
LM_PROMPT = 960
LM_GEN = 64                 # max_seq 1024: a multiple of 512, as in JAX
LM_REQUESTS = 16
LM_SEQ_REQUESTS = 4
LM_SEED = 0
LM_TF_STEPS = 4             # teacher-forced decode steps checked
LM_TF_REL = 2e-2            # max |dlogit| <= LM_TF_REL * max |logit| (bf16)
LM_F32 = {"n_layers": 2, "batch": 2, "prompt": 64, "gen": 8}
LM_F32_TOL = 2e-4           # the JAX test_models.py prefill/decode bound
SCAN_REPLACES = "src/repro/kernels/linear_scan.py:82"
SCAN_SOURCE = "src/repro_torch/kernels/csrc/linear_scan.cu"
# linear_scan against the plain chunked version: the same algorithm in f32,
# sums in another order (1e-4); bf16 q/k/v and output (2e-2); against the
# stepwise recurrence, the JAX sweep's 3e-3
SCAN_TOL = {"f32": 1e-4, "bf16": 2e-2}
SCAN_STEP_TOL = 3e-3
SCAN_TRAIN_SHAPE = (8, 32, 1024, 64, 64)    # B, H, T, dk, dv of rwkv6 training
# the training path: rwkv6-1.6b at full width, random weights from TRAIN_SEED
TRAIN_ARCH = "rwkv6_1p6b"
TRAIN_SMOKE = False
TRAIN_BATCH = 8
TRAIN_SEQ = 1024
TRAIN_STEPS = 8
TRAIN_SEED = 0
TRAIN_LR = 2e-3             # WSD: warmup 2, stable 4, decay 2 (the launcher's)
# 2 layers in f32; weights at 0.05, not the 0.02 init: at 0.02 the scan's
# output lies below the ln_x norm's epsilon and barely moves the loss
TRAIN_F32 = {"n_layers": 2, "batch": 2, "seq": 128, "scale": 0.05}
TRAIN_F32_TOL = 2e-4        # x max |g| per gradient; relative for the loss
# rwkv6 serving: a short prompt, since SSM prefill is a host-bound scan-in;
# weights at 0.05, not the 0.02 init, so that the scan moves the logits (the
# ratio of SSM_F32's note) and the teacher-forced check sees the kernel
SSM_SCALE = 0.05
SSM_BATCH = 8
SSM_PROMPT = 128
SSM_GEN = 32
SSM_REQUESTS = 16
SSM_SEQ_REQUESTS = 2
# rwkv6-1.6b at full width in f32 with weights at SSM_SCALE (the scan then
# moves the logits by ~50%): stepwise decode against the kernel's chunked path
SSM_F32 = {"batch": 2, "seq": 68, "scale": SSM_SCALE}
SSM_F32_TOL = 2e-4          # x max |logit|
# zeroing the scan must move the logits by this x max |logit|, so that the
# checks of phase 12 run where the scan's output matters
SSM_MIN_SCAN_EFFECT = 0.1
BIRRD_REPLACES = "src/repro/kernels/birrd_reduce.py:90"
BIRRD_SOURCE = "src/repro_torch/kernels/csrc/birrd_apply.cu"
# BIRRD against its plain version: routed programs are exact (every stage
# an exact copy or one f32 sum of two values), so bit for bit; against the
# RIR oracle (another summation order) and on dense stage matrices, the
# JAX sweep's 1e-5
BIRRD_TOL = 1e-5
# the full-size case: the paper's array width, the demo's pattern (groups
# of 4 to ports 0, 4, 8, 12), one ResNet-50 batch-8 conv2 activation
# (8 x 56 x 56 x 256 values) spread over the 16 wires
BIRRD_FULL = (16, 8 * 56 * 56 * 256 // 16)
# zamba2-2.7b served at full width, random weights from ZAMBA_SEED drawn at
# ZAMBA_SCALE: at the 0.02 init the mamba2 mixer's y * silu(z) lies below
# its output norm's epsilon and no logits check sees the scan
ZAMBA_ARCH = "zamba2_2p7b"
ZAMBA_SMOKE = False
ZAMBA_SCALE = 0.08
ZAMBA_SEED = 0
ZAMBA_BATCH = 8
ZAMBA_PROMPT = 64
ZAMBA_GEN = 16
ZAMBA_SEQ_REQUESTS = 2
ZAMBA_SCAN_T = 1024          # the bf16 forward the kernel is held on
# all 54 layers in f32: decode over every token against hidden_states
ZAMBA_F32 = {"batch": 2, "seq": 68, "scale": ZAMBA_SCALE}
ZAMBA_F32_TOL = 2e-4         # x max |logit|
# phases 16-19: the runtime around the main path, through its entry points
CLI_NET = ["--graph", "resnet50", "--batch", "8", "--workers", "2"]
CLI_LM = ["--arch", "llama3p2_3b", "--batch", "8", "--prompt-len", "128",
          "--gen", "16"]
OBS_GRAPH = "resnet50"
CALIB_RUNS = 5                  # warm traced runs of the served plan
CHAOS_GRAPH = "resnet50"
CHAOS_ARCH = "llama3p2_3b"      # its SMOKE config: the chaos serve phase's
CHAOS_GEN = 4                   # the chaos serve phase's tokens a request
# rwkv6-1.6b at full width and reduced depth: straight against save+resume
RESUME_ARCH = "rwkv6_1p6b"
RESUME_SMOKE = False
RESUME_LAYERS = 2
RESUME_BATCH = 8
RESUME_SEQ = 1024
RESUME_STEPS = 8
RESUME_REL = 1e-4               # the final loss, as tests/test_system.py asks
# phases 20-22: the MoE family and the whisper encoder-decoder.  20:
# gqa_decode at their decode shapes, each at S = 1500 (whisper's encoder
# frames, not a multiple of the kernel's split) in full and ragged rows
GQA_NEW_SHAPES = {"dbrx G 6": (48, 8, 128), "llama4 G 5": (40, 8, 128),
                  "whisper G 1, D 64": (12, 12, 64)}
GQA_NEW_S = 1500
# 21: whisper-small at full width and depth served, random weights from
# WHISPER_SEED; every decode step launches gqa_decode twice a layer
WHISPER_ARCH = "whisper_small"
WHISPER_SMOKE = False
WHISPER_SEED = 0
WHISPER_BATCH = 8
WHISPER_PROMPT = 64
WHISPER_GEN = 32
WHISPER_REQUESTS = 16
WHISPER_SEQ_REQUESTS = 2
# the whole model in f32 (TF32 off), card against CPU: prefill and 3
# teacher-forced decode steps at the stated tolerance, and max |err| within
# WHISPER_F32_REL x max |logit| (the logits are ~1e-2 at the 0.02 init)
WHISPER_F32 = {"batch": 2, "prompt": 16, "steps": 3}
WHISPER_F32_TOL = dict(rtol=1e-4, atol=1e-3)
WHISPER_F32_REL = 2e-4
CLI_WHISPER = ["--arch", "whisper_small", "--batch", "8"]
# 22: dbrx-132b and llama4-scout at full width and MOE_LAYERS layers (no
# MoE config fits one card whole), one after the other
MOE_ARCHS = ("dbrx_132b", "llama4_scout_17b")
MOE_SMOKE = False
MOE_LAYERS = 4
MOE_SEED = 0
MOE_BATCH = 8
MOE_PROMPT = 128
MOE_GEN = 16
# the dispatch logic in f32 at SMOKE widths (2 layers), card against CPU,
# weights at 0.2 so the router is far from uniform; routing must agree
# wherever the k-th and (k+1)-th router logits differ by more than
# MOE_ROUTE_MARGIN, and flips inside it are reported
MOE_F32 = {"batch": 8, "prompt": 32, "steps": 4, "scale": 0.2}
MOE_ROUTE_MARGIN = 1e-5
# phase 23: the mesh (one NCCL rank); dbrx's EP check runs in phase 22
MESH_LM_STEPS = 16
MESH_TRAIN_LAYERS = 2
MESH_TRAIN_STEPS = 4
MESH_TRAIN_REL = 1e-6
MESH_EP_REL = 2.0 ** -8   # one bf16 rounding of max |out|
# phase 24 (analysis): the dry-run's cells, each a subprocess of its own
# (the fake world of 256 ranks cannot share a process with phase 23's NCCL
# group), traced with one microbatch
DRY_CELLS = (("llama3p2_3b", "train_4k"), ("dbrx_132b", "train_4k"),
             ("llama3p2_3b", "decode_32k"),
             ("phi3_mini_3p8b", "decode_32k"))
DRY_ACCUM = 1
DRY_TIMEOUT_S = 300
ROOF_MIN = 0.95           # device time >= ROOF_MIN x the step's bound
GQA_HOST_CALLS = 1000
# phase 25: the split paths on one device
SPLIT_SHAPES = {"llama decode": (24, 8, 128, 1024),
                "dbrx decode": (48, 8, 128, 144),
                "whisper cross": (12, 12, 64, 1500)}
SPLIT_RANKS = 16             # the production mesh's model axis
SPLIT_DECODE_S = 32768       # decode_32k
SPLIT_TRAIN_T = 4096         # train_4k
SPLIT_ML_TOL = {"m": 1e-5, "l": 1e-4}   # f32 sums in another order
SPLIT_MESH_STEPS = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back calls."""
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


def kernel_ms(fn, kernels, iters: int = 50, warmup: int = 5,
              attempts: int = 3):
    """Device milliseconds of one call of ``fn()``, from the kernel events
    of a ``torch.profiler`` loop of ``iters`` calls: the mean duration of
    the events of each name in ``kernels`` (each launched once a call),
    summed.  ``kernels=None`` takes every device event of the loop, each
    name weighted by its launches a call (its events over ``iters``,
    rounded: the yardsticks' own kernels).  The host's time to issue a call
    is left out.  The profiler may keep only some of a loop's events (37 of
    50 in one run), so the mean per event is taken, not the loop's sum over
    ``iters``; now and then it keeps none of a kernel's, and the loop is
    profiled again, up to ``attempts`` times.  Returns the time and
    ``[name, device ms in all, events kept]`` a kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name, _ = device_time_by_kernel(prof)
        if kernels is None:
            if by_name:
                return (sum(us / n * max(1, round(n / iters))
                            for us, _, n in by_name) / 1e3,
                        [[name[:60], round(us / 1e3, 4), n]
                         for us, name, n in by_name])
            kernel = "device"
            log(f"[profile] no device event kept (attempt {attempt + 1} of "
                f"{attempts})")
            continue
        ms, seen = 0.0, []
        for kernel in kernels:
            us = sum(u for u, name, _ in by_name if kernel in name)
            n = sum(c for _, name, c in by_name if kernel in name)
            if not n:
                break
            ms += us / n / 1e3
            seen.append([kernel, round(us / 1e3, 4), n])
        else:
            return ms, seen
        log(f"[profile] no {kernel} event kept (attempt {attempt + 1} of "
            f"{attempts})")
    raise AssertionError(f"the profiler saw no {kernel} event in "
                         f"{attempts} attempts")


def queued_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back
    calls issued while a spin kernel holds the device: the calls queue up
    behind it, so the CUDA events around them time the device's work and
    not the host's pace of issuing calls, which ``cuda_ms`` measures
    wherever a call's kernels are shorter than its host cost.  A call that
    waits for the device ends the queue and is timed as ``cuda_ms``
    times it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def gqa_bound(B, Hq, Hkv, D, n_valid) -> dict:
    """``gqa_decode``'s bound in bf16 (``gqa_decode.work`` over the
    ``n_valid`` K/V rows the lengths cover, on the data sheet's rates
    that the dry-run divides by too: ``core.gpu_cost.bound_ms``)."""
    from repro_torch.core import gpu_cost
    from repro_torch.kernels import gqa_decode as gk
    w = gk.work(B, Hq, Hkv, D, n_valid, 2)
    return {**gpu_cost.bound_ms(w), "mbytes": w.bytes / 1e6,
            "mflop": w.flops / 1e6}


def gqa_per_step(cfg) -> int:
    """``gqa_decode`` launches a decode step: one a layer, two for an
    encoder-decoder (self- and cross-attention)."""
    return cfg.n_layers * (2 if cfg.family == "encdec" else 1)


def cycling(fn, n: int):
    """A call of ``fn(i)`` for i = 0, 1, ..., n-1, 0, ... at every call:
    each call finds its own operands (one cache a layer) cold in L2."""
    order = itertools.cycle(range(n))
    return lambda: fn(next(order))


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check_close(name: str, got, want, rtol: float, atol: float) -> float:
    import torch
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: max |err| {max_err(got, want):.3e} "
                             f"beyond rtol={rtol} atol={atol}")
    return max_err(got, want)


def check_network(name: str, got, want) -> dict:
    """NET_TOL, and max |err| against the reference's own scale."""
    err = check_close(name, got, want, **NET_TOL)
    scale = float(want.abs().max())
    if not err <= NET_REL * scale:
        raise AssertionError(f"{name}: max |err| {err:.3e} beyond "
                             f"{NET_REL} x max |y_ref| {scale:.3e}")
    return {"max_abs_err": err, "ref_mean_abs": float(want.abs().mean()),
            "ref_max_abs": scale}


def device_time_by_kernel(prof):
    """``[(device us, name, count)]`` of the device's own events (kernels,
    copies, memsets) from a ``torch.profiler`` run, largest first, and
    their sum in ms (the device's busy time).  Host ops are left out: an
    op that launched a kernel carries that kernel's time too, so counting
    both would count it twice (the autograd backward's ops do); and so are
    the device's copies of host ranges (``record_function``), which share
    the range's name and span its kernels and the gaps between them."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == DeviceType.CPU}
    by_name = sorted(((dev_us(e), e.key, e.count) for e in events
                      if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                      and e.key not in host), reverse=True)
    return by_name, sum(us for us, _, _ in by_name) / 1e3


def range_device_ms(prof, name: str):
    """Device ms of the kernels launched under the ``torch.profiler`` range
    ``name`` (its host-side events: the device's own copy of a range would
    count its span, not its kernels), and how often the range ran."""
    from torch.autograd import DeviceType
    ms, n = 0.0, 0
    for e in prof.key_averages():
        if e.key == name and e.device_type == DeviceType.CPU:
            ms += getattr(e, "device_time_total",
                          getattr(e, "cuda_time_total", 0.0)) / 1e3
            n += e.count
    return ms, n


def stack_frames(build_log: str) -> dict:
    """``{kernel: bytes of stack frame}`` from ``nvcc -Xptxas -v``'s
    report."""
    frames, name = {}, None
    for line in build_log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif name and "bytes stack frame" in line:
            frames[name] = int(line.split("bytes stack frame")[0].split()[-1])
            name = None
    return frames


# ------------------------------------------------------------------- phases
def phase_build(rk, gk, lk, bk) -> dict:
    import torch
    name = card_line()
    log(f"[device] {name}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as ex:   # one nvcc each, at once
        for fut in [ex.submit(m.load) for m in (rk, gk, lk, bk)]:
            fut.result()
    secs = time.perf_counter() - t0
    for m in (rk, gk, lk, bk):
        log(f"[build] {m.library_path().name}: nvcc {m.build_seconds:.1f} s")
        for line in m.build_log.splitlines():
            if "entry function" in line:
                log(f"[build] {line.strip()[:110]}")
            elif "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {line.strip()}")
    log(f"[build] all four libraries built and loaded in {secs:.1f} s")
    if bk.build_log:
        frames = stack_frames(bk.build_log)
        switch = {k: v for k, v in frames.items() if bk.SWITCH_KERNEL in k}
        if len(switch) != 2 * len(bk.WIDTHS) or any(switch.values()):
            raise AssertionError(f"{bk.SWITCH_KERNEL}: want 0 bytes of stack "
                                 f"frame in each of {2 * len(bk.WIDTHS)} "
                                 f"instantiations, ptxas says {switch}")
        log(f"[build] {bk.SWITCH_KERNEL}: 0 bytes stack frame in all "
            f"{len(switch)} instantiations")
    return {"card": name, "build_s": secs,
            "nvcc_s": {"rir_matmul": rk.build_seconds,
                       "gqa_decode": gk.build_seconds,
                       "linear_scan": lk.build_seconds,
                       "birrd_apply": bk.build_seconds}}


def phase_plan(api):
    from repro_torch.serve.engine import _planner_options
    cache = api.PlanCache()
    cfg = api.ServeConfig(graph="resnet50", max_batch=BATCH, device=DEV)
    opts = _planner_options(cfg)
    nets = {}
    for name, fn in (("resnet50", api.resnet50_graph),
                     ("mobv3", api.mobilenet_v3_graph)):
        graph = fn().with_batch(BATCH)
        t0 = time.perf_counter()
        resolved = api.resolve_plan(graph, api.EvalConfig(), opts=opts,
                                    cache=cache)
        if resolved.tier > 1:
            raise AssertionError(f"{name}: plan degraded to "
                                 f"{resolved.tier_name}: {resolved.reason}")
        log(f"[plan] {name} batch {BATCH}: {len(resolved.plan.steps)} steps, tier "
            f"{resolved.tier_name}, {time.perf_counter() - t0:.1f} s")
        nets[name] = (graph, resolved.plan)
    return cache, nets


def phase_kernel_sweep(torch, ops, ref) -> float:
    """The JAX sweep's shapes plus ragged M/K, f32 and bf16, +/- residual."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    shapes = [(128, 128, 256, 128), (256, 384, 512, 128),
              (256, 256, 1024, 256),                       # the JAX sweep
              (100, 147, 256, 128), (1000, 77, 384, 128),  # ragged M and K
              (7, 4608, 512, 128)]
    worst, n = 0.0, 0
    for m, k, n_cols, bn in shapes:
        for dt, tdt in dts.items():
            for with_res in (False, True):
                for ident in (False, True):
                    a = torch.randn(m, k, generator=gen).to(DEV, tdt)
                    b = torch.randn(k, n_cols, generator=gen).to(DEV, tdt)
                    r = torch.randn(m, n_cols, generator=gen).to(
                        DEV, tdt) if with_res else None
                    nb = n_cols // bn
                    perm = list(range(nb)) if ident else \
                        torch.randperm(nb, generator=gen).tolist()
                    y = ops.rir_matmul(a, b, None if ident else perm,
                                       residual=r, block_n=bn)
                    torch.cuda.synchronize()
                    want = ref.rir_matmul(a, b, perm, bn, residual=r)
                    name = f"sweep {m}x{k}x{n_cols}/{bn} {dt} res={with_res}"
                    if y.dtype != tdt or y.shape != (m, n_cols):
                        raise AssertionError(f"{name}: {y.dtype} {y.shape}")
                    err = check_close(name, y, want, TOL[dt], TOL[dt])
                    if dt == "f32":
                        worst = max(worst, err)
                    n += 1
    log(f"[kernel] sweep: {n} cases within tolerance (f32 {TOL['f32']}, "
        f"bf16 {TOL['bf16']}); worst f32 |err| {worst:.3e}")
    # a perm tensor ops.device_perm did not check is refused before launch
    bad = torch.tensor([0, 5], dtype=torch.int32, device=DEV)
    a = torch.zeros(8, 16, device=DEV)
    try:
        ops.rir_matmul(a, torch.zeros(16, 256, device=DEV), bad)
    except ValueError:
        log("[kernel] an unchecked perm tensor is refused before launch")
    else:
        raise AssertionError("an unchecked perm tensor reached the kernel")
    return worst


def phase_kernel_resnet(torch, api, ops, ref, rk, nets) -> dict:
    """Each ResNet-50 plan step's GEMM at batch 8: checked and timed by
    device time (the kernel's profiler events; the plain version and
    ``torch.matmul`` queued behind a spin kernel), with the CUDA events
    around back-to-back calls beside as ``event_ms``.  Then the split-K
    shape's rows against the same rows inside the batch, bit for bit."""
    from repro_torch.core import gpu_cost
    graph, plan = nets["resnet50"]
    weights = api.init_graph_weights(list(graph.layers), seed=0)
    prepared = api.prepare_network(plan, graph, weights, device=DEV)
    gen = torch.Generator(device="cpu").manual_seed(1)
    rows, tot = [], {"ms": 0.0, "event_ms": 0.0, "plain_ms": 0.0,
                     "library_ms": 0.0, "bound_ms": 0.0, "flop_ms": 0.0,
                     "byte_ms": 0.0, "gflop": 0.0, "gbytes": 0.0}
    worst = 0.0
    for i, st in enumerate(prepared.steps):
        a = torch.randn(st.rows_out, st.k_width, generator=gen).to(DEV)
        b = st.w_eff
        bn = st.block_n
        fused = any(j.fused for j in st.joins)
        r = torch.randn(st.rows_out, b.shape[1], generator=gen).to(DEV) \
            if fused else None
        perm_t = st.perm_dev
        perm = list(range(b.shape[1] // bn)) if perm_t is None \
            else perm_t.tolist()
        y = ops.rir_matmul(a, b, perm_t, residual=r, block_n=bn)
        torch.cuda.synchronize()
        want = ref.rir_matmul(a, b, perm, bn, residual=r)
        err = check_close(f"resnet50 step {i}", y, want, TOL["f32"],
                          TOL["f32"])
        worst = max(worst, err)
        M, K = a.shape
        # the bound counts the work the layer needs: its own output width,
        # not the columns the weight is padded with to whole perm blocks
        N = st.wl.M
        work = rk.work(M, K, N, 4, fused, len(perm))
        flops, nbytes = work.flops, work.bytes
        bd = gpu_cost.bound_ms(work)
        flop_ms, byte_ms = bd["op_ms"], bd["byte_ms"]
        call = lambda: ops.rir_matmul(  # noqa: E731
            a, b, perm_t, residual=r, block_n=bn)
        cut = rk.launch_plan(M, K, b.shape[1], bn)
        ms, seen = kernel_ms(call, cut.kernels)
        row = {"step": i, "layer": st.wl.name, "M": M, "K": K, "N": N,
               "N_launched": b.shape[1], "block_n": bn, "residual": fused,
               "plan": vars(cut),
               "kernel_ms": ms, "device_kernels": seen,
               "event_ms": cuda_ms(call),
               "plain_ms": queued_ms(lambda: ref.rir_matmul(
                   a, b, perm, bn, residual=r), iters=20, warmup=3),
               "library_ms": queued_ms(lambda: torch.matmul(a, b)),
               "bound_ms": max(flop_ms, byte_ms),
               "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
               "max_abs_err": err}
        rows.append(row)
        log("[kernel] " + json.dumps(row))
        for key in ("event_ms", "plain_ms", "library_ms", "bound_ms"):
            tot[key] += row[key]
        tot["ms"] += row["kernel_ms"]
        tot["flop_ms"] += flop_ms
        tot["byte_ms"] += byte_ms
        tot["gflop"] += flops / 1e9
        tot["gbytes"] += nbytes / 1e9
    tot["max_abs_err"] = worst
    tot["bound_by"] = "operations" if tot["flop_ms"] >= tot["byte_ms"] \
        else "bytes"
    tot["slower_than_library"] = [r["step"] for r in rows
                                  if r["kernel_ms"] > r["library_ms"]]
    log(f"[kernel] resnet50 batch {BATCH}, {len(rows)} steps "
        f"({tot['gflop']:.2f} GFLOP, {tot['gbytes']:.3f} GB), device time: "
        f"kernel {tot['ms']:.4f} ms (events back to back "
        f"{tot['event_ms']:.4f} ms), plain {tot['plain_ms']:.4f} ms, "
        f"torch.matmul {tot['library_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}); steps slower than "
        f"torch.matmul: {tot['slower_than_library']}")
    # the split-K shape (step 11's): a request's rows give the same bits
    # alone as inside the batch
    a = torch.randn(392, 4608, generator=gen).to(DEV)
    b = torch.randn(4608, 512, generator=gen).to(DEV)
    r = torch.randn(392, 512, generator=gen).to(DEV)
    perm = (2, 0, 3, 1)
    full = ops.rir_matmul(a, b, perm, residual=r)
    for lo, hi in ((0, 7), (1, 8), (49, 98)):
        part = ops.rir_matmul(a[lo:hi].contiguous(), b, perm,
                              residual=r[lo:hi].contiguous())
        if not torch.equal(full[lo:hi], part):
            raise AssertionError(f"392x4608x512: rows {lo}-{hi - 1} alone "
                                 f"differ from the same rows in the batch")
    check_close("392x4608x512", full, ref.rir_matmul(a, b, perm, 128,
                                                     residual=r),
                TOL["f32"], TOL["f32"])
    log("[kernel] 392x4608x512 (split-K shape): rows 0-6, 1-7 and 49-97 "
        "alone == the same rows in the batch, bit for bit")
    return {"steps": rows, "total": tot}


def phase_networks(torch, api, rk, obs, nets) -> dict:
    out = {}
    for name, (graph, plan) in nets.items():
        weights = api.init_graph_weights(list(graph.layers), seed=0)
        x = torch.randn(graph.input_shape(),
                        generator=torch.Generator().manual_seed(2))
        prepared = api.prepare_network(plan, graph, weights, device=DEV)
        rk.reset_launch_count()
        y = api.execute_network(plan, graph, x, weights, prepared=prepared,
                                activation=torch.relu, device=DEV)
        torch.cuda.synchronize()
        launches = rk.launch_count()
        if launches != len(graph.layers) or y.device.type != DEV:
            raise AssertionError(f"{name}: {launches} launches for "
                                 f"{len(graph.layers)} layers, {y.device}")
        y_ref = api.execute_network_reference(graph, x, weights,
                                              activation=torch.relu,
                                              device="cpu")
        if tuple(y.shape) != tuple(y_ref.shape) or \
                not torch.isfinite(y).all():
            raise AssertionError(f"{name}: shape {tuple(y.shape)} vs "
                                 f"{tuple(y_ref.shape)} or non-finite")
        acc = check_network(f"{name} network", y.cpu(), y_ref)
        x_dev = x.to(DEV)
        batch_ms = cuda_ms(lambda: prepared(x_dev, activation=torch.relu),
                           iters=10)
        # one traced run: per-step wall clock, each step fenced
        obs.reset()
        obs.enable()
        prepared(x_dev, activation=torch.relu)
        steps = [round(e["dur"] / 1e3, 4) for e in obs.events()
                 if e.get("ev") == "span" and e["name"] == "exec.step"]
        obs.reset()
        rec = {"network": name, "batch": graph.input_shape()[0],
               "launches": launches, **acc,
               "batch_ms": batch_ms, "exec_step_ms": steps}
        log("[network] " + json.dumps(rec))
        out[name] = rec
    return out


def phase_serve(torch, api, rk, obs, cache, nets) -> dict:
    """The main path: plan (cached) -> executor -> engine, on the card."""
    import numpy as np
    graph, plan = nets["resnet50"]
    n_req = N_REQUESTS
    rng = torch.Generator().manual_seed(3)
    reqs = [torch.randn(graph.input_shape()[1:], generator=rng).numpy()
            for _ in range(n_req)]
    cfg = api.ServeConfig(graph="resnet50", max_batch=BATCH, workers=2,
                          device=DEV)
    seq_cfg = api.ServeConfig(graph="resnet50", max_batch=BATCH, workers=1,
                              assemble_max=1, device=DEV)
    results = {}
    for label, c in (("batched", cfg), ("sequential", seq_cfg)):
        obs.reset()
        obs.enable()
        with api.ServeEngine(c, cache=cache) as eng:
            if eng.resolved.tier > 1 or eng.resolved.plan != plan:
                raise AssertionError(f"serve plan tier "
                                     f"{eng.resolved.tier_name}")
            eng.serve(reqs[:2])                    # warm the engine's path
            obs.reset()
            obs.enable()
            rk.reset_launch_count()                # main path starts here
            t0 = time.perf_counter()
            outs = eng.serve(reqs)
            secs = time.perf_counter() - t0
            launches = rk.launch_count()           # ... and ends here
            batches = int(obs.counter_value("serve.batches"))
            e2e = obs.hist_stats("serve.e2e_ms")
            sizes = obs.hist_samples("serve.batch_size")
        if launches != len(graph.layers) * batches or launches == 0:
            raise AssertionError(f"{label}: {launches} launches for "
                                 f"{batches} batches")
        want_shape = graph.layers[-1]
        for o in outs:
            if o.shape != (want_shape.P, want_shape.Q, want_shape.M) or \
                    not (o == o).all():
                raise AssertionError(f"{label}: bad output {o.shape}")
        results[label] = {"outs": outs, "launches": launches,
                          "batches": batches, "requests": n_req,
                          "seconds": secs, "requests_per_s": n_req / secs,
                          "e2e_ms_p50": e2e["p50"], "e2e_ms_p99": e2e["p99"],
                          "batch_sizes": sizes}
        log("[serve] " + json.dumps({"mode": label, **{
            k: v for k, v in results[label].items() if k != "outs"}}))
    obs.reset()
    for i, (a, b) in enumerate(zip(results["batched"]["outs"],
                                   results["sequential"]["outs"])):
        if not (a == b).all():
            raise AssertionError(f"request {i}: batched != sequential")
    log(f"[serve] {n_req} requests: batched == sequential bit-identical")
    # the served outputs are right: the first two against the CPU reference
    weights = api.init_graph_weights(list(graph.layers), seed=0)
    y_ref = api.execute_network_reference(
        graph, torch.from_numpy(np.stack(reqs[:2])),
        weights, device="cpu")
    for i in range(2):
        check_network(f"served request {i}",
                      torch.from_numpy(results["batched"]["outs"][i]),
                      y_ref[i])
    for r in results.values():
        r.pop("outs")
    return results


def phase_profile(torch, api, obs, cache, nets) -> dict:
    """Serve with tracing off: ``N_WINDOWS`` windows of ``N_WINDOW``
    requests for requests/s and its spread, then one more under
    ``torch.profiler`` for where the wall time goes and the device's busy
    share."""
    from torch.profiler import ProfilerActivity, profile
    graph, _ = nets["resnet50"]
    reqs = list(torch.randn((N_WINDOW,) + tuple(graph.input_shape()[1:]),
                            generator=torch.Generator().manual_seed(4))
                .numpy())
    obs.reset()                                    # no per-step fences
    cfg = api.ServeConfig(graph="resnet50", max_batch=BATCH, workers=2,
                          device=DEV)
    rates = []
    with api.ServeEngine(cfg, cache=cache) as eng:
        eng.serve(reqs[:4 * BATCH])
        for _ in range(N_WINDOWS):
            t0 = time.perf_counter()
            eng.serve(reqs)
            rates.append(N_WINDOW / (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.serve(reqs)
            wall_s = time.perf_counter() - t0

    by_name, busy_ms = device_time_by_kernel(prof)
    rec = {"requests": N_WINDOW,
           "requests_per_s_untraced": rates,
           "profiled_requests_per_s": N_WINDOW / wall_s,
           "profiled_wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / (wall_s * 1e3) if busy_ms else None,
           "top_device_ms": [[name[:60], round(us / 1e3, 4), n]
                             for us, name, n in by_name[:8]]}
    log("[profile] " + json.dumps(rec))
    return rec


def phase_gqa_sweep(torch, ops, ref) -> dict:
    """The JAX sweep's shapes, a ragged S, length 1 and lengths on split
    boundaries, in f32 and bf16, against the plain version."""
    from repro_torch.kernels.gqa_decode import SPLIT
    gen = torch.Generator(device="cpu").manual_seed(5)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    cases = [(2, 8, 2, 64, 512, None), (1, 4, 4, 128, 1024, None),
             (3, 8, 1, 64, 2048, None),                     # the JAX sweep
             (2, 8, 2, 128, 1000, None),                    # ragged S
             (5, 6, 2, 128, 5 * SPLIT,                      # length 1, on
              [1, SPLIT, SPLIT + 1, 2 * SPLIT, 5 * SPLIT]),  # split edges
             (ZAMBA_BATCH, 32, 32, 80, ZAMBA_PROMPT + ZAMBA_GEN,  # zamba2's
              list(range(ZAMBA_PROMPT, ZAMBA_PROMPT + ZAMBA_GEN,   # decode
                         ZAMBA_GEN // ZAMBA_BATCH)))]               # shape
    worst, n = {"f32": 0.0, "bf16": 0.0}, 0
    for b, hq, hkv, d, S, lens in cases:
        for dt, tdt in dts.items():
            q = torch.randn(b, hq, d, generator=gen).to(DEV, tdt)
            k = torch.randn(b, S, hkv, d, generator=gen).to(DEV, tdt)
            v = torch.randn(b, S, hkv, d, generator=gen).to(DEV, tdt)
            ln = torch.tensor(lens, dtype=torch.int32) if lens else \
                torch.randint(S // 2, S + 1, (b,), generator=gen,
                              dtype=torch.int32)
            ln = ln.to(DEV)
            y = ops.gqa_decode(q, k, v, ln)
            torch.cuda.synchronize()
            name = f"gqa sweep {b}x{hq}/{hkv}x{d} S={S} {dt}"
            if y.dtype != tdt or y.shape != q.shape:
                raise AssertionError(f"{name}: {y.dtype} {y.shape}")
            err = check_close(name, y, ref.gqa_decode(q, k, v, ln),
                              GQA_TOL[dt], GQA_TOL[dt])
            worst[dt] = max(worst[dt], err)
            n += 1
    log(f"[gqa] sweep: {n} cases within tolerance (f32 {GQA_TOL['f32']}, "
        f"bf16 {GQA_TOL['bf16']}); worst |err| f32 {worst['f32']:.3e}, "
        f"bf16 {worst['bf16']:.3e}")
    return {"cases": n, "worst": worst}


def gqa_times(torch, ops, ref, kernels, B, Hq, Hkv, D, S, lens,
              n_caches, seed) -> dict:
    """``gqa_decode`` at one decode shape in bf16 over ``n_caches`` K/V
    caches taken in turn (each cold in the 50 MB L2, as a decode step finds
    its layer's cache): held against the plain version and SDPA, then the
    kernel (whose device kernels are ``kernels``), the plain version and
    ``scaled_dot_product_attention`` (the yardstick, not on the path: the
    same caches as (B, H, S, D) views, length mask) timed by device time
    (``kernel_ms``), queued behind a spin kernel (``queued_ms``) and in
    CUDA events around back-to-back calls (``cuda_ms``)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn(B, Hq, D, generator=gen, device=DEV).to(torch.bfloat16)
    ks = [torch.randn(B, S, Hkv, D, generator=gen, device=DEV)
          .to(torch.bfloat16) for _ in range(n_caches)]
    vs = [torch.randn(B, S, Hkv, D, generator=gen, device=DEV)
          .to(torch.bfloat16) for _ in range(n_caches)]
    lens = torch.as_tensor(lens, dtype=torch.int32, device=DEV)
    mask = (torch.arange(S, device=DEV)[None, :] < lens[:, None]
            )[:, None, None, :]

    def kern(i):
        return ops.gqa_decode(q, ks[i], vs[i], lens)

    def plain(i):
        return ref.gqa_decode(q, ks[i], vs[i], lens)

    def sdpa(i):
        return F.scaled_dot_product_attention(
            q[:, :, None, :], ks[i].transpose(1, 2), vs[i].transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0, :]
    want = plain(0)
    err = check_close("gqa decode shape", kern(0), want, GQA_TOL["bf16"],
                      GQA_TOL["bf16"])
    sdpa_err = check_close("sdpa yardstick", sdpa(0), want, GQA_TOL["bf16"],
                           GQA_TOL["bf16"])
    n = n_caches
    k_loop, p_loop, s_loop = (cycling(f, n) for f in (kern, plain, sdpa))
    ms, seen = kernel_ms(k_loop, kernels, iters=4 * n, warmup=n)
    plain_ms, _ = kernel_ms(p_loop, None, iters=2 * n, warmup=2)
    library_ms, lib_seen = kernel_ms(s_loop, None, iters=4 * n, warmup=n)
    gb = gqa_bound(B, Hq, Hkv, D, int(lens.sum()))
    rec = {"B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "S": S,
           "lengths": lens.tolist(), "caches": n, "max_abs_err": err,
           "sdpa_max_abs_err": sdpa_err, "ms": ms, "device_kernels": seen,
           "queued_ms": queued_ms(k_loop, iters=4 * n, warmup=n),
           "event_ms": cuda_ms(k_loop, iters=4 * n, warmup=n),
           "plain_ms": plain_ms,
           "plain_queued_ms": queued_ms(p_loop, iters=2 * n, warmup=2),
           "library_ms": library_ms, "library_kernels": lib_seen,
           "library_queued_ms": queued_ms(s_loop, iters=4 * n, warmup=n),
           "library_event_ms": cuda_ms(s_loop, iters=4 * n, warmup=n),
           **gb, "achieved_gb_s": gb["mbytes"] * 1e6 / (ms * 1e-3) / 1e9}
    del ks, vs
    torch.cuda.empty_cache()
    return rec


def phase_gqa_llama(torch, api, ops, ref, gk) -> dict:
    """``gqa_decode`` at the llama3.2-3b decode shape, bf16: checked, then
    timed over one K/V cache per layer (0.94 GB in all, so each launch
    finds its cache cold in the 50 MB L2, as a decode step does)."""
    cfg = api.get_config(LM_ARCH, smoke=LM_SMOKE)
    B, S = LM_BATCH, LM_PROMPT + LM_GEN
    lens = torch.randint(LM_PROMPT, S, (B,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(6))
    rec = gqa_times(torch, ops, ref, [gk.KERNEL], B, cfg.n_heads,
                    cfg.n_kv_heads, cfg.head_dim, S, lens, cfg.n_layers, 6)
    log("[gqa] llama shape " + json.dumps(rec))
    return rec


def lm_teacher_forced(torch, model, prompts, gen_tokens) -> dict:
    """Decode logits at ``LM_TF_STEPS`` steps fed the served tokens, against
    ``hidden_states`` + ``logits`` of the whole sequence at the same
    positions; max |d| <= LM_TF_REL * max |ref|."""
    import numpy as np
    P, n = len(prompts[0]), LM_TF_STEPS
    toks = torch.from_numpy(np.stack(prompts).astype(np.int64)).to(DEV)
    fed = torch.from_numpy(np.stack(gen_tokens)[:, :n].astype(np.int64)
                           ).to(DEV)
    with torch.inference_mode():
        cache, _ = model.prefill(toks, P + n)
        dec = []
        for j in range(n):
            cache, logits = model.decode_step(cache, fed[:, j])
            dec.append(logits.float())
        dec = torch.stack(dec, dim=1)                       # (B, n, V)
        hid = model.hidden_states(torch.cat([toks, fed], dim=1))
        full = model.logits(hid[:, P:P + n]).float()        # (B, n, V)
    err = float((dec - full).abs().max())
    scale = float(full.abs().max())
    rec = {"steps": n, "max_abs_err": err, "ref_max_abs": scale,
           "ratio": err / scale, "limit": LM_TF_REL}
    if not err <= LM_TF_REL * scale:
        raise AssertionError(f"teacher-forced decode: max |err| {err:.3e} "
                             f"beyond {LM_TF_REL} x {scale:.3e}")
    return rec


def phase_lm_serve(torch, api, gk, obs) -> dict:
    """The LM path: llama3.2-3b served at full width on the card."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    cfg = api.get_config(LM_ARCH, smoke=LM_SMOKE)
    rng = np.random.default_rng(7)
    reqs = [rng.integers(0, cfg.vocab, LM_PROMPT).astype(np.int32)
            for _ in range(LM_REQUESTS)]
    kw = dict(arch=LM_ARCH, smoke=LM_SMOKE, max_batch=LM_BATCH,
              prompt_len=LM_PROMPT, gen=LM_GEN, seed=LM_SEED, device=DEV)
    per_batch = (LM_GEN - 1) * cfg.n_layers
    t0 = time.perf_counter()
    eng = api.ServeEngine(api.ServeConfig(workers=1, **kw))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model = eng.model
    n_params = sum(p.numel() for p in model.params().values())
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
           "init_s": init_s, "requests": LM_REQUESTS, "batch": LM_BATCH,
           "prompt_len": LM_PROMPT, "gen": LM_GEN}
    with eng:
        eng.serve(reqs[:1])                        # warm the path
        obs.reset()
        obs.enable()
        gk.reset_launch_count()                    # the LM path starts here
        t0 = time.perf_counter()
        outs = eng.serve(reqs)
        secs = time.perf_counter() - t0
        launches = gk.launch_count()               # ... and ends here
        batches = int(obs.counter_value("serve.batches"))
        prefill = obs.hist_stats("serve.prefill_ms")
        decode = obs.hist_stats("serve.decode_ms_per_token")
        obs.reset()                                # profile untraced
        before = gk.launch_count()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.serve(reqs[:LM_BATCH])
            wall_s = time.perf_counter() - t0
        prof_launches = gk.launch_count() - before
    if launches != per_batch * batches or launches == 0:
        raise AssertionError(f"LM serve: {launches} gqa_decode launches for "
                             f"{batches} batches ({per_batch} a batch)")
    by_name, busy_ms = device_time_by_kernel(prof)
    # one device kernel a launch: the profiled batch's only gqa kernel is
    # the decode kernel, with no more events than launches (the profiler
    # may drop some events, never add)
    gqa_kernels = [[name, n] for _, name, n in by_name if "gqa" in name]
    if len(gqa_kernels) != 1 or gk.KERNEL not in gqa_kernels[0][0] \
            or not 0 < gqa_kernels[0][1] <= prof_launches:
        raise AssertionError(f"LM serve: {prof_launches} gqa_decode launches"
                             f" in the profiled batch, device kernels "
                             f"{gqa_kernels}")
    for o in outs:
        if o.shape != (LM_GEN,) or o.min() < 0 or o.max() >= cfg.vocab:
            raise AssertionError(f"LM serve: bad tokens {o.shape}")
    rec.update({
        "gqa_launches": launches, "batches": batches,
        "profiled_gqa_launches": prof_launches,
        "profiled_gqa_kernels": [[n[:60], c] for n, c in gqa_kernels],
        "gqa_launches_per_batch": launches / batches, "seconds": secs,
        "requests_per_s": LM_REQUESTS / secs,
        "generated_tokens_per_s": LM_REQUESTS * LM_GEN / secs,
        "prefill_ms": prefill, "decode_ms_per_token": decode,
        "profiled_batch_wall_ms": wall_s * 1e3,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (wall_s * 1e3),
        "device_ops": sum(n for _, _, n in by_name),
        "top_device_ms": [[name[:60], round(us / 1e3, 4), n]
                          for us, name, n in by_name[:12]]})
    log("[lm] " + json.dumps(rec))
    # the same requests one a batch, through an engine given the same
    # weights: identical tokens
    with api.ServeEngine(api.ServeConfig(workers=1, assemble_max=1, **kw),
                         weights=model.params()) as seq:
        seq_outs = seq.serve(reqs[:LM_SEQ_REQUESTS])
    for i, (a, b) in enumerate(zip(outs, seq_outs)):
        if not np.array_equal(a, b):
            raise AssertionError(f"LM request {i}: batched != sequential")
    log(f"[lm] {LM_SEQ_REQUESTS} requests served one a batch: tokens "
        f"identical to the batched run")
    rec["teacher_forced"] = lm_teacher_forced(
        torch, model, reqs[:LM_BATCH], outs[:LM_BATCH])
    log("[lm] teacher-forced bf16 " + json.dumps(rec["teacher_forced"]))
    del eng, model
    torch.cuda.empty_cache()
    return rec


def phase_lm_f32(torch, api, gk) -> dict:
    """llama3.2-3b widths in f32 at reduced depth: the port on the card
    against the port on the CPU (plain path), teacher-forced with the CPU's
    greedy tokens."""
    import numpy as np
    c = LM_F32
    cfg = dataclasses.replace(api.get_config(LM_ARCH, smoke=LM_SMOKE),
                              n_layers=c["n_layers"], dtype="float32")
    cpu = api.build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(8))
    dev = api.build_model(cfg, device=DEV).load_params(cpu.params())
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, size=(c["batch"], c["prompt"])))
    S = c["prompt"] + c["gen"]
    worst, scale, launches = 0.0, 0.0, 0
    with torch.inference_mode():
        c_cpu, l_cpu = cpu.prefill(toks, S)
        c_dev, l_dev = dev.prefill(toks.to(DEV), S)
        for step in range(c["gen"]):
            if step:
                tok = torch.argmax(l_cpu, dim=-1)
                c_cpu, l_cpu = cpu.decode_step(c_cpu, tok)
                before = gk.launch_count()
                c_dev, l_dev = dev.decode_step(c_dev, tok.to(DEV))
                launches += gk.launch_count() - before
            got = l_dev.cpu()
            worst = max(worst, check_close(f"f32 LM step {step}", got, l_cpu,
                                           LM_F32_TOL, LM_F32_TOL))
            scale = max(scale, float(l_cpu.abs().max()))
    if launches != (c["gen"] - 1) * cfg.n_layers:
        raise AssertionError(f"f32 LM: {launches} gqa_decode launches")
    rec = {**c, "d_model": cfg.d_model, "max_abs_err": worst,
           "ref_max_abs": scale, "tol": LM_F32_TOL, "gqa_launches": launches}
    log("[lm-f32] " + json.dumps(rec))
    return rec


def scan_inputs(torch, b, h, t, dk, dv, dtype, seed, decay=None):
    """q, k, v ~ N(0, 1) in ``dtype`` and a log decay of -|N(0, 1)| * 0.2 in
    f32 (the JAX sweep's), or the constant ``decay``, on the card."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn(b, h, t, dk, generator=gen, device=DEV).to(dtype)
    k = torch.randn(b, h, t, dk, generator=gen, device=DEV).to(dtype)
    v = torch.randn(b, h, t, dv, generator=gen, device=DEV).to(dtype)
    w = torch.full((b, h, t, dk), float(decay), device=DEV) if decay \
        is not None else -(torch.randn(b, h, t, dk, generator=gen,
                                       device=DEV).abs() * 0.2)
    return q, k, v, w


def scan_bound(q, k, v, w, out) -> dict:
    """``linear_scan``'s bound (``linear_scan.work``): its operands read
    once and the output (``out``: v's shape and type) written once,
    against its operations at the fp32 rate."""
    from repro_torch.core import gpu_cost
    from repro_torch.kernels import linear_scan as lk
    work = lk.work(*q.shape, v.shape[-1], q.element_size(),
                   w.element_size())
    return {**gpu_cost.bound_ms(work), "gflop": work.flops / 1e9,
            "gbytes": work.bytes / 1e9}


def scan_times(torch, ops, ref, kernels, q, k, v, w) -> dict:
    """``linear_scan`` at one shape, timed: the kernel (whose device kernels
    are ``kernels``) by device time (``kernel_ms``) and in CUDA events
    around back-to-back calls, the plain chunked version by device time;
    and the bound."""
    def kern():
        return ops.linear_scan(q, k, v, w)
    ms, seen = kernel_ms(kern, kernels, iters=20, warmup=3)
    plain_ms, _ = kernel_ms(lambda: ref.linear_scan_chunked(q, k, v, w),
                            None, iters=5, warmup=1)
    sb = scan_bound(q, k, v, w, v)          # out: v's shape and type
    B, H, T, dk = q.shape
    return {"B": B, "H": H, "T": T, "dk": dk, "dv": v.shape[-1],
            "dtype": str(q.dtype).replace("torch.", ""), "ms": ms,
            "device_kernels": seen, "event_ms": cuda_ms(kern, iters=20),
            "plain_ms": plain_ms, "library_ms": None, **sb,
            "achieved_tflop_s": sb["gflop"] / ms}


def phase_scan_sweep(torch, ops, ref, lk) -> dict:
    """``linear_scan`` against the plain versions: the sweep in f32 and
    bf16, ragged T, a -60 log decay, the training shape (timed), and the
    Function's gradient."""
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    cases = [(2, 3, 128, 32, 64), (1, 2, 256, 64, 64), (2, 1, 192, 16, 16),
             (2, 4, 128, 64, 16), (1, 2, 64, 16, 32)]
    worst, n = {"f32": 0.0, "bf16": 0.0}, 0
    for i, (b, h, t, dk, dv) in enumerate(cases):
        for dt, tdt in dts.items():
            q, k, v, w = scan_inputs(torch, b, h, t, dk, dv, tdt, 10 + i)
            y = ops.linear_scan(q, k, v, w)
            torch.cuda.synchronize()
            name = f"scan sweep {b}x{h}x{t} dk={dk} dv={dv} {dt}"
            if y.dtype != tdt or y.shape != v.shape:
                raise AssertionError(f"{name}: {y.dtype} {y.shape}")
            err = check_close(name, y, ref.linear_scan_chunked(q, k, v, w),
                              SCAN_TOL[dt], SCAN_TOL[dt])
            worst[dt] = max(worst[dt], err)
            n += 1
    for t in (1, 37, 100, 200):                       # ragged T
        q, k, v, w = scan_inputs(torch, 2, 2, t, 32, 32, torch.float32, t)
        err = check_close(f"scan ragged T={t}", ops.linear_scan(q, k, v, w),
                          ref.linear_scan(q, k, v, w), SCAN_STEP_TOL,
                          SCAN_STEP_TOL)
        worst["f32_stepwise"] = max(worst.get("f32_stepwise", 0.0), err)
        n += 1
    q, k, v, w = scan_inputs(torch, 1, 2, 128, 16, 16, torch.float32, 3,
                             decay=-60.0)
    y = ops.linear_scan(q, k, v, w)
    expect = torch.einsum("bhtd,bhtd->bht", q, k)[..., None] * v
    if not torch.isfinite(y).all():
        raise AssertionError("scan with -60 log decay: non-finite output")
    check_close("scan -60 log decay", y, expect, 1e-4, 1e-4)
    n += 1
    log(f"[scan] sweep: {n} cases within tolerance (f32 {SCAN_TOL['f32']}, "
        f"bf16 {SCAN_TOL['bf16']}, stepwise {SCAN_STEP_TOL}); worst |err| "
        + json.dumps(worst))

    # the rwkv6-1.6b training shape, bf16 q/k/v, f32 log decay
    B, H, T, dk, dv = SCAN_TRAIN_SHAPE
    q, k, v, w = scan_inputs(torch, B, H, T, dk, dv, torch.bfloat16, 20)
    want = ref.linear_scan_chunked(q, k, v, w)
    err = check_close("scan training shape", ops.linear_scan(q, k, v, w),
                      want, SCAN_TOL["bf16"], SCAN_TOL["bf16"])
    rec = {"max_abs_err": err, "ref_max_abs": float(want.abs().max()),
           **scan_times(torch, ops, ref, [lk.KERNEL], q, k, v, w)}
    log("[scan] training shape " + json.dumps(rec))
    del q, k, v, w, want

    # the autograd Function: kernel forward, plain chunked backward
    ins = scan_inputs(torch, 2, 2, 128, 32, 64, torch.float32, 21)
    g = torch.randn(2, 2, 128, 64, device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(22))
    a = [x.clone().requires_grad_(True) for x in ins]
    b = [x.clone().requires_grad_(True) for x in ins]
    before = lk.launch_count()
    ga = torch.autograd.grad(ops.linear_scan(*a), a, g)
    if lk.launch_count() != before + 1:
        raise AssertionError("the Function's forward did not launch")
    gb = torch.autograd.grad(ref.linear_scan_chunked(*b), b, g)
    grad_rel = 0.0
    for name, x, y in zip("qkvw", ga, gb):
        scale = float(y.abs().max())
        e = max_err(x, y)
        if not (torch.isfinite(x).all() and e <= 1e-4 * scale):
            raise AssertionError(f"scan grad d{name}: max |err| {e:.3e} "
                                 f"beyond 1e-4 x {scale:.3e}")
        grad_rel = max(grad_rel, e / scale)
    log(f"[scan] gradient through the Function within 1e-4 of max |g| "
        f"(worst ratio {grad_rel:.2e})")
    torch.cuda.empty_cache()
    return {"cases": n, "worst": worst, "train_shape": rec,
            "grad_ratio": grad_rel}


def phase_train(torch, api, lk, obs) -> dict:
    """The training path: rwkv6-1.6b at full width, ``TRAIN_STEPS`` steps
    of ``make_train_step`` with the WSD schedule, then one profiled."""
    import gc
    import math

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import gpu_cost
    from repro_torch.kernels.ops import BACKWARD_RANGE
    from repro_torch.optim.adamw import UPDATE_RANGE
    gc.collect()
    torch.cuda.empty_cache()
    cfg = api.get_config(TRAIN_ARCH, smoke=TRAIN_SMOKE)
    t0 = time.perf_counter()
    model = api.build_model(cfg, device=DEV)
    model.init(torch.Generator(device=DEV).manual_seed(TRAIN_SEED))
    opt = api.adamw_init(model.params())
    steps = TRAIN_STEPS

    def sched(s):
        return api.wsd_schedule(s, peak_lr=TRAIN_LR,
                                warmup=max(2, steps // 10),
                                stable=steps // 2, decay=max(1, steps // 3))

    step = api.make_train_step(model, schedule=sched)
    stream = api.SyntheticLMStream(api.DataConfig(
        vocab=cfg.vocab, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.params().values())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    losses, lrs, step_ms, per_step = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    lk.reset_launch_count()                        # the training path starts
    for s in range(steps):
        before = lk.launch_count()
        t1 = time.perf_counter()
        opt, m = step(opt, stream.batch_at(s))
        losses.append(float(m["loss"]))            # syncs on the loss
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        per_step.append(lk.launch_count() - before)
        lrs.append(m["lr"])
    launches = lk.launch_count()                   # ... and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log("[train] " + json.dumps({"losses": losses, "lr": lrs,
                                 "step_ms": step_ms,
                                 "launches_per_step": per_step}))
    want = 2 * cfg.n_layers                        # forward + remat recompute
    if any(c != want for c in per_step):
        raise AssertionError(f"linear_scan launches a step {per_step}, "
                             f"expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(losses[0] - math.log(cfg.vocab)) > 0.5:
        raise AssertionError(f"first loss {losses[0]:.3f} not within 0.5 of "
                             f"ln {cfg.vocab} = {math.log(cfg.vocab):.3f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    steady = float(np.median(step_ms[1:])) if steps > 1 else step_ms[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        opt, m = step(opt, stream.batch_at(steps))
        float(m["loss"])
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t1
    by_name, busy_ms = device_time_by_kernel(prof)
    scan_ms = sum(us for us, name, _ in by_name if lk.KERNEL in name) / 1e3
    # the step's device time under the scan's plain backward and under
    # AdamW (profiler ranges), and the rest
    split = {}
    for name in (BACKWARD_RANGE, UPDATE_RANGE):
        ms, n = range_device_ms(prof, name)
        split[name] = {"device_ms": ms, "calls": n}
    split["rest"] = {"device_ms": busy_ms - sum(
        r["device_ms"] for r in split.values())}
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": steps,
           "init_s": init_s, "losses": losses, "lr": lrs,
           "step_ms": step_ms, "step_ms_median_after_first": steady,
           "tokens_per_s": tokens / (steady / 1e3),
           "peak_mem_gb": peak_gb,
           "bf16_peak_share_6NT": 6.0 * n_params * tokens
           / (steady / 1e3) / gpu_cost.BF16_PEAK_FLOPS,
           "scan_launches": launches, "scan_launches_per_step": want,
           "profiled_step_wall_ms": prof_wall_s * 1e3,
           "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / (prof_wall_s * 1e3),
           "scan_kernel_ms_in_step": scan_ms, "step_device_split": split,
           "device_ops": sum(c for _, _, c in by_name),
           "top_device_ms": [[name[:60], round(us / 1e3, 4), c]
                             for us, name, c in by_name[:12]]}
    log("[train] " + json.dumps({k: v for k, v in rec.items()
                                 if k not in ("losses", "lr", "step_ms")}))
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_train_f32(torch, api, lk) -> dict:
    """rwkv6 widths in f32 at reduced depth: loss and every gradient on the
    card against the same weights on the CPU."""
    import numpy as np
    c = TRAIN_F32
    cfg = dataclasses.replace(api.get_config(TRAIN_ARCH, smoke=TRAIN_SMOKE),
                              n_layers=c["n_layers"], dtype="float32")
    cpu = api.build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(30), scale=c["scale"])
    dev = api.build_model(cfg, device=DEV).load_params(cpu.params())
    toks = torch.from_numpy(np.random.default_rng(31).integers(
        0, cfg.vocab, size=(c["batch"], c["seq"] + 1)))
    out = {}
    for name, m, t in (("cpu", cpu, toks), ("cuda", dev, toks.to(DEV))):
        m.requires_grad_(True)
        params = list(m.params().values())
        before = lk.launch_count()
        loss = m.loss({"tokens": t})
        grads = torch.autograd.grad(loss, params)
        out[name] = (float(loss.detach()), grads, lk.launch_count() - before)
    if out["cuda"][2] != 2 * cfg.n_layers or out["cpu"][2]:
        raise AssertionError(f"f32 train: {out['cuda'][2]} launches on the "
                             f"card, {out['cpu'][2]} on the CPU")
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    if not loss_rel <= TRAIN_F32_TOL:
        raise AssertionError(f"f32 train loss: card {out['cuda'][0]} CPU "
                             f"{out['cpu'][0]}")
    worst = 0.0
    for (name, _), gd, gc_ in zip(cpu.params().items(), out["cuda"][1],
                                  out["cpu"][1]):
        scale = float(gc_.abs().max())
        e = max_err(gd.cpu(), gc_)
        if not e <= TRAIN_F32_TOL * scale:
            raise AssertionError(f"f32 train grad {name}: max |err| {e:.3e} "
                                 f"beyond {TRAIN_F32_TOL} x {scale:.3e}")
        worst = max(worst, e / scale)
    rec = {**c, "d_model": cfg.d_model, "loss_cpu": out["cpu"][0],
           "loss_cuda": out["cuda"][0], "loss_rel_err": loss_rel,
           "worst_grad_ratio": worst, "tol": TRAIN_F32_TOL,
           "scan_launches": out["cuda"][2]}
    log("[train-f32] " + json.dumps(rec))
    del cpu, dev, out
    torch.cuda.empty_cache()
    return rec


def logits_with_scan(model, toks, scan, pos=slice(None)):
    """f32 logits at positions ``pos`` of ``toks`` with ``scan`` in place of
    ``ops.linear_scan`` in every layer."""
    from repro_torch.models import ssm
    real_scan = ssm.ops.linear_scan
    ssm.ops.linear_scan = scan
    try:
        return model.logits(model.hidden_states(toks)[:, pos]).float()
    finally:
        ssm.ops.linear_scan = real_scan


def scan_effect(torch, model, toks, full, pos=slice(None)) -> float:
    """max |logits with the scan's output zeroed - ``full``| / max |full|,
    at positions ``pos`` of ``toks``: how far a check against ``full`` sees
    the scan."""
    no_scan = logits_with_scan(model, toks,
                               lambda q, k, v, w: torch.zeros_like(v), pos)
    return max_err(no_scan, full) / float(full.abs().max())


def phase_ssm_serve(torch, api, lk, obs) -> dict:
    """rwkv6 served at full width with weights at ``SSM_SCALE``: a scan-in
    through ``decode_step``, then greedy decode; in bf16, every layer's
    ``linear_scan`` output on a served sequence against its plain version
    on the same inputs, the logits with either scan and a teacher-forced
    decode recorded beside it; the scan must move the logits."""
    import numpy as np
    from repro_torch.kernels import ref
    cfg = api.get_config(TRAIN_ARCH, smoke=TRAIN_SMOKE)
    rng = np.random.default_rng(40)
    reqs = [rng.integers(0, cfg.vocab, SSM_PROMPT).astype(np.int32)
            for _ in range(SSM_REQUESTS)]
    kw = dict(arch=TRAIN_ARCH, smoke=TRAIN_SMOKE, max_batch=SSM_BATCH,
              prompt_len=SSM_PROMPT, gen=SSM_GEN, seed=TRAIN_SEED,
              device=DEV)
    eng = api.ServeEngine(api.ServeConfig(workers=1, **kw))
    model = eng.model.init(torch.Generator(device=DEV).manual_seed(TRAIN_SEED),
                           scale=SSM_SCALE)
    rec = {"arch": cfg.name, "requests": SSM_REQUESTS, "batch": SSM_BATCH,
           "prompt_len": SSM_PROMPT, "gen": SSM_GEN, "scale": SSM_SCALE}
    with eng:
        eng.serve(reqs[:1])                        # warm the path
        obs.reset()
        obs.enable()
        t0 = time.perf_counter()
        outs = eng.serve(reqs)
        secs = time.perf_counter() - t0
        batches = int(obs.counter_value("serve.batches"))
        rec.update({"batches": batches, "seconds": secs,
                    "requests_per_s": SSM_REQUESTS / secs,
                    "generated_tokens_per_s": SSM_REQUESTS * SSM_GEN / secs,
                    "prefill_ms": obs.hist_stats("serve.prefill_ms"),
                    "decode_ms_per_token":
                        obs.hist_stats("serve.decode_ms_per_token")})
        obs.reset()
    for o in outs:
        if o.shape != (SSM_GEN,) or o.min() < 0 or o.max() >= cfg.vocab:
            raise AssertionError(f"rwkv6 serve: bad tokens {o.shape}")
    log("[ssm] " + json.dumps(rec))
    with api.ServeEngine(api.ServeConfig(workers=1, assemble_max=1, **kw),
                         weights=model.params()) as seq:
        seq_outs = seq.serve(reqs[:SSM_SEQ_REQUESTS])
    for i, (a, b) in enumerate(zip(outs, seq_outs)):
        if not np.array_equal(a, b):
            raise AssertionError(f"rwkv6 request {i}: batched != sequential")
    log(f"[ssm] {SSM_SEQ_REQUESTS} requests served one a batch: tokens "
        f"identical to the batched run")
    # a served sequence (the prompt and LM_TF_STEPS served tokens) through
    # the chunked path, each layer's scan inputs and output kept; the
    # decode fed the same tokens (teacher-forced)
    from repro_torch.models import ssm
    P, n = SSM_PROMPT, LM_TF_STEPS
    toks = torch.from_numpy(np.stack(reqs[:SSM_BATCH]).astype(np.int64)
                            ).to(DEV)
    fed = torch.from_numpy(np.stack(outs[:SSM_BATCH])[:, :n]
                           .astype(np.int64)).to(DEV)
    seq_toks = torch.cat([toks, fed], dim=1)
    calls, real_scan = [], ssm.ops.linear_scan

    def kept(*ins):
        out = real_scan(*ins)
        calls.append((ins, out))
        return out

    with torch.inference_mode():
        cache = model.init_cache(SSM_BATCH, P + n)
        dec = []
        for t in range(P + n):
            cache, logits = model.decode_step(cache, seq_toks[:, t])
            if t >= P:
                dec.append(logits.float())
        dec = torch.stack(dec, dim=1)                       # (B, n, V)
        before = lk.launch_count()
        full = logits_with_scan(model, seq_toks, kept)
        launches = lk.launch_count() - before
        worst = 0.0                  # max |err| / max |plain| over layers
        for i, (ins, out) in enumerate(calls):
            want = ref.linear_scan_chunked(*ins)
            e, top = max_err(out, want), float(want.abs().max())
            if out.shape != want.shape or not e <= SCAN_TOL["bf16"] * top:
                raise AssertionError(
                    f"rwkv6 layer {i} scan {tuple(out.shape)}: max |err| "
                    f"{e:.3e} beyond {SCAN_TOL['bf16']} x {top:.3e}")
            worst = max(worst, e / top)
        dk, dv = calls[0][0][0].shape[-1], calls[0][1].shape[-1]
        del calls
        plain = logits_with_scan(model, seq_toks, ref.linear_scan_chunked)
        effect = scan_effect(torch, model, seq_toks, full)
    if launches != cfg.n_layers:
        raise AssertionError(f"hidden_states: {launches} linear_scan "
                             f"launches for {cfg.n_layers} layers")
    scale = float(plain.abs().max())
    tf_scale = float(full[:, P:].abs().max())
    kp = {"positions": P + n, "layers": launches, "dtype": cfg.dtype,
          "dk": dk, "dv": dv,
          "scan_worst_ratio": worst, "scan_limit": SCAN_TOL["bf16"],
          "scan_effect_ratio": effect,
          "logits_kernel_vs_plain": max_err(full, plain) / scale,
          "teacher_forced": {
              "steps": n, "ref_max_abs": tf_scale,
              "ratio_vs_kernel": max_err(dec, full[:, P:]) / tf_scale,
              "ratio_vs_plain": max_err(dec, plain[:, P:]) / tf_scale}}
    rec["bf16_scan_in_model"] = kp
    log("[ssm] bf16, the kernel on every layer's inputs " + json.dumps(kp))
    if not effect >= SSM_MIN_SCAN_EFFECT:
        raise AssertionError(f"rwkv6 bf16: the scan moves the logits by "
                             f"only {effect:.2e} of their max")
    del eng, model
    torch.cuda.empty_cache()
    return rec


def phase_ssm_f32(torch, api, lk) -> dict:
    """rwkv6-1.6b at full width in f32 (TF32 off): decode over every token
    (the exact recurrence) against ``hidden_states`` (the ``linear_scan``
    kernel, a ragged last chunk included) + ``logits``; and the logits with
    the scan's output replaced by zeros, to show the comparison sees it."""
    import numpy as np
    c = SSM_F32
    cfg = dataclasses.replace(api.get_config(TRAIN_ARCH, smoke=TRAIN_SMOKE),
                              dtype="float32")
    model = api.build_model(cfg, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(50), scale=c["scale"])
    toks = torch.from_numpy(np.random.default_rng(51).integers(
        0, cfg.vocab, size=(c["batch"], c["seq"]))).to(DEV)
    with torch.inference_mode():
        cache = model.init_cache(c["batch"], c["seq"])
        dec = []
        for t in range(c["seq"]):
            cache, logits = model.decode_step(cache, toks[:, t])
            dec.append(logits)
        dec = torch.stack(dec, dim=1)
        before = lk.launch_count()
        full = model.logits(model.hidden_states(toks))
        launches = lk.launch_count() - before
        effect = scan_effect(torch, model, toks, full)
    scale = float(full.abs().max())
    err = max_err(dec, full)
    rec = {**c, "n_layers": cfg.n_layers, "max_abs_err": err,
           "ref_max_abs": scale, "ratio": err / scale, "limit": SSM_F32_TOL,
           "scan_effect_ratio": effect, "scan_launches": launches}
    log("[ssm-f32] " + json.dumps(rec))
    if launches != cfg.n_layers:
        raise AssertionError(f"ssm f32: {launches} linear_scan launches for "
                             f"{cfg.n_layers} layers")
    if not err <= SSM_F32_TOL * scale:
        raise AssertionError(f"ssm f32 decode vs chunked: max |err| "
                             f"{err:.3e} beyond {SSM_F32_TOL} x {scale:.3e}")
    if not effect >= SSM_MIN_SCAN_EFFECT:
        raise AssertionError(f"ssm f32: the scan moves the logits by only "
                             f"{effect:.2e} of their max; the check is blind")
    del model, cache
    torch.cuda.empty_cache()
    return rec


def birrd_plain(ref, x, mats, ports):
    """The plain version of ``ops.birrd_reduce``: the stage loop, then the
    rows no group targets set to 0."""
    from repro_torch.kernels.birrd_reduce import _out_port_mask
    return ref.birrd_apply(x, mats, _out_port_mask(
        x.shape[0], tuple(ports), x.device))


def birrd_case(torch, ops, ref, aw, gids, ports, d, dtype, seed) -> float:
    """One routed pattern on the card, through the switch kernel: bit for
    bit against the plain stage loop and the plain switch walk, within
    BIRRD_TOL (bf16: its rounding) of the RIR oracle; returns max |err|
    against the plain version (0)."""
    from repro_torch.kernels import birrd_reduce as bk
    x = torch.randn(aw, d, generator=torch.Generator().manual_seed(seed)
                    ).to(DEV, dtype)
    before = bk.switch_launch_count()
    y = ops.birrd_reduce(x, gids, ports)
    torch.cuda.synchronize()
    name = f"birrd aw={aw} d={d} {dtype} groups={len(ports)}"
    if y.dtype != dtype or y.shape != (aw, d) or \
            bk.switch_launch_count() != before + 1:
        raise AssertionError(f"{name}: {y.dtype} {tuple(y.shape)}, "
                             f"{bk.switch_launch_count() - before} switch "
                             f"kernel launches")
    mats = bk._routed_stage_mats(aw, tuple(gids), tuple(ports), x.device)
    plain = birrd_plain(ref, x, mats, ports)
    walk = ref.birrd_switch(x, bk._routed_configs(aw, tuple(gids),
                                                  tuple(ports)),
                            bk._out_port_mask(aw, tuple(ports), x.device))
    if not torch.equal(y, plain) or not torch.equal(y, walk):
        raise AssertionError(f"{name}: not bit-identical to the plain "
                             f"versions (max |err| {max_err(y, plain):.3e}, "
                             f"{max_err(y, walk):.3e})")
    oracle = ref.birrd_reduce(x.float(), torch.tensor(gids),
                              torch.tensor(ports), aw)
    tol = BIRRD_TOL if dtype == torch.float32 else TOL["bf16"]
    check_close(f"{name} vs the RIR oracle", y, oracle, tol, tol)
    return max_err(y, plain)


def phase_birrd(torch, ops, ref, bk) -> dict:
    """``birrd_apply`` on the card: the JAX sweep's cases, every width, a
    ragged d and bf16 through the switch kernel, dense stage matrices
    through the dense kernel; then the full-size case, both kernels
    timed."""
    import math

    import numpy as np
    from repro_torch.core import gpu_cost
    from repro_torch.core.birrd import Birrd
    before = (bk.switch_launch_count(), bk.launch_count())
    n = 0
    worst = 0.0
    for aw, d in ((8, 128), (16, 256), (16, 512)):          # the JAX sweep
        gids = [i // 2 for i in range(aw)]
        worst = max(worst, birrd_case(torch, ops, ref, aw, gids,
                                      [2 * g for g in range(aw // 2)], d,
                                      torch.float32, aw + d))
        n += 1
    perm = [int(p) for p in np.random.default_rng(60).permutation(8)]
    x = torch.randn(8, 128, generator=torch.Generator().manual_seed(61)
                    ).to(DEV)
    y = ops.birrd_reduce(x, list(range(8)), perm)
    moved = torch.zeros_like(x)
    moved[perm] = x
    if not torch.equal(y, moved):
        raise AssertionError("birrd pure reorder at aw 8: values not moved "
                             "exactly")
    n += 1
    # every width: a swap, a full reduction, pairs to scattered ports, the
    # demo's groups of 4, and structured relayouts routed in closed form
    patterns = {2: ([0, 1], [1, 0]), 4: ([0, 0, 0, 0], [3]),
                8: ([0, 0, 1, 1, 2, 2, 3, 3], [6, 0, 2, 4]),
                16: ([i // 4 for i in range(16)], [0, 4, 8, 12])}
    for aw in (32, 64):
        k = int(math.log2(aw))
        patterns[aw] = (list(range(aw)),
                        [((i << 2) | (i >> (k - 2))) & (aw - 1)
                         for i in range(aw)])
    widths = []
    for aw, (gids, ports) in patterns.items():
        for d, dtype in ((1000, torch.float32), (77, torch.float32),
                         (1000, torch.bfloat16)):
            worst = max(worst, birrd_case(torch, ops, ref, aw, gids, ports,
                                          d, dtype, 62 + aw + d))
            n += 1
        widths.append(aw)
    dense_worst = 0.0
    for aw in (4, 8, 16, 32, 64):
        S = len(Birrd(aw).perms)
        gen = torch.Generator().manual_seed(63 + aw)
        mats = (torch.randn(S, aw, aw, generator=gen) / aw ** 0.5).to(DEV)
        x = torch.randn(aw, 1000, generator=gen).to(DEV)
        n_dense = bk.launch_count()
        y = ops.birrd_apply_p(x, mats)
        want = ref.birrd_apply(x, mats)
        if bk.launch_count() != n_dense + 1:
            raise AssertionError("birrd_apply_p did not launch the dense "
                                 "kernel")
        scale = float(want.abs().max())
        err = max_err(y, want)
        if not err <= BIRRD_TOL * scale:
            raise AssertionError(f"birrd dense aw={aw}: max |err| {err:.3e}"
                                 f" beyond {BIRRD_TOL} x {scale:.3e}")
        dense_worst = max(dense_worst, err / scale)
        n += 1
    log(f"[birrd] sweep: {n} cases, widths {widths}; routed programs "
        f"through the switch kernel bit for bit against the plain versions, "
        f"within {BIRRD_TOL} of the RIR oracle; dense stage matrices through "
        f"the dense kernel, worst |err| / max {dense_worst:.2e}")

    # the full-size case, f32
    aw, d = BIRRD_FULL
    gids, ports = [i // 4 for i in range(aw)], [0, 4, 8, 12]
    x = torch.randn(aw, d, generator=torch.Generator().manual_seed(64)
                    ).to(DEV)
    mats = bk._routed_stage_mats(aw, tuple(gids), tuple(ports), x.device)
    mask = bk._out_port_mask(aw, tuple(ports), x.device)
    y = ops.birrd_reduce(x, gids, ports)
    plain = birrd_plain(ref, x, mats, ports)
    dense = bk.birrd_apply_cuda(x, mats, port_mask=mask)
    if not torch.equal(y, plain) or not torch.equal(dense, plain):
        raise AssertionError("birrd full size: a kernel is not bit-identical "
                             "to the plain version")
    err = max_err(y, plain)
    check_close("birrd full size vs the RIR oracle", y, ref.birrd_reduce(
        x, torch.tensor(gids), torch.tensor(ports), aw), BIRRD_TOL,
        BIRRD_TOL)
    # the yardstick: one product with the program composed on the host and
    # the non-target rows zeroed (entries are small integers: exact)
    m64 = mats.double().cpu()
    P = m64[0]
    for m in m64[1:]:
        P = m @ P
    keep = torch.zeros(aw, 1, dtype=torch.float64)
    keep[ports] = 1.0
    P = (P * keep).float().to(DEV)
    lib = torch.matmul(P, x)
    check_close("birrd full size: torch.matmul(P, x)", lib, plain,
                BIRRD_TOL, BIRRD_TOL)
    # device times: each kernel's from its profiler events, the plain
    # version's and the yardstick's with their launches queued; the CUDA
    # events around back-to-back calls are printed beside them
    reduce_ = lambda: ops.birrd_reduce(x, gids, ports)  # noqa: E731
    dense_ = lambda: bk.birrd_apply_cuda(  # noqa: E731
        x, mats, port_mask=mask)
    event_ms = cuda_ms(reduce_, iters=50, warmup=5)
    ms, kernels_seen = kernel_ms(reduce_, [bk.SWITCH_KERNEL])
    dense_ms, dense_seen = kernel_ms(dense_, [bk.DENSE_KERNEL])
    plain_ms = queued_ms(lambda: birrd_plain(ref, x, mats, ports),
                         iters=20, warmup=3)
    library_ms = queued_ms(lambda: torch.matmul(P, x))
    S = mats.shape[0]
    # the function's own work: one addition a wire and stage whose row of
    # the routed program holds two entries (the others are copies)
    work = bk.work(aw, d, x.element_size(), bk.program_adds(
        aw, bk._routed_configs(aw, tuple(gids), tuple(ports))))
    nbytes, adds = work.bytes, work.flops
    bd = gpu_cost.bound_ms(work)
    dense_flops = 2.0 * S * aw * aw * d      # what the dense FMA loop does
    rec = {"aw": aw, "d": d, "stages": S, "dtype": "f32",
           "max_abs_err": err, "ms": ms, "event_ms": event_ms,
           "queued_ms": queued_ms(reduce_), "device_kernels": kernels_seen,
           "dense_ms": dense_ms, "dense_event_ms": cuda_ms(dense_),
           "dense_device_kernels": dense_seen,
           "plain_ms": plain_ms, "plain_event_ms": cuda_ms(
               lambda: birrd_plain(ref, x, mats, ports)),
           "library_event_ms": cuda_ms(lambda: torch.matmul(P, x)),
           "library_ms": library_ms, **bd,
           "mbytes": nbytes / 1e6, "madds": adds / 1e6,
           "dense_gflop": dense_flops / 1e9,
           "dense_fp32_ms": dense_flops / gpu_cost.FP32_PEAK_FLOPS * 1e3,
           "dense_tflop_s": dense_flops / (dense_ms * 1e-3) / 1e12,
           "achieved_gb_s": nbytes / (ms * 1e-3) / 1e9,
           "dense_gb_s": nbytes / (dense_ms * 1e-3) / 1e9,
           "ratio_to_bound": ms / bd["bound_ms"],
           "dense_ratio_to_bound": dense_ms / bd["bound_ms"],
           "cases": n, "dense_worst_ratio": dense_worst,
           "switch_launches_in_phase": bk.switch_launch_count() - before[0],
           "dense_launches_in_phase": bk.launch_count() - before[1]}
    log("[birrd] full size " + json.dumps(rec))
    del x, y, plain, dense, lib
    torch.cuda.empty_cache()
    return rec


def phase_coswitch(torch, rk, bk) -> dict:
    """The co-switching demo's path on the card, every check asserted."""
    from repro_torch.launch import coswitch
    rk.reset_launch_count()
    bk.reset_launch_count()                       # the demo's path starts
    t0 = time.perf_counter()
    rec = coswitch.run(DEV)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rec.update({"seconds": secs, "rir_matmul_launches": rk.launch_count(),
                "birrd_launches": bk.switch_launch_count(),
                "birrd_dense_launches": bk.launch_count()})  # ... and ends
    log("[coswitch] " + json.dumps(rec))
    if rec["birrd_launches"] < 1 or rec["rir_matmul_launches"] < 3 + 12:
        raise AssertionError(f"coswitch: {rec['birrd_launches']} "
                             f"{bk.SWITCH_KERNEL} and "
                             f"{rec['rir_matmul_launches']} rir_matmul "
                             f"launches (want >= 1 and >= 15)")
    return rec


def phase_zamba_serve(torch, api, ops, ref, gk, lk, obs) -> dict:
    """zamba2 served at full width: scan-in, greedy decode, batched ==
    sequential tokens, ``gqa_decode`` at its decode shape timed, and in
    bf16 every layer's ``linear_scan`` on a 1024-token forward against its
    plain version on the same inputs (the kernel timed there)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import ssm
    cfg = api.get_config(ZAMBA_ARCH, smoke=ZAMBA_SMOKE)
    rng = np.random.default_rng(70)
    reqs = [rng.integers(0, cfg.vocab, ZAMBA_PROMPT).astype(np.int32)
            for _ in range(ZAMBA_BATCH)]
    kw = dict(arch=ZAMBA_ARCH, smoke=ZAMBA_SMOKE, max_batch=ZAMBA_BATCH,
              prompt_len=ZAMBA_PROMPT, gen=ZAMBA_GEN, seed=ZAMBA_SEED,
              device=DEV)
    t0 = time.perf_counter()
    eng = api.ServeEngine(api.ServeConfig(workers=1, **kw))
    model = eng.model.init(torch.Generator(device=DEV)
                           .manual_seed(ZAMBA_SEED), scale=ZAMBA_SCALE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.params().values())
    steps = ZAMBA_PROMPT + ZAMBA_GEN - 1          # scan-in + decode steps
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
           "scale": ZAMBA_SCALE, "init_s": init_s,
           "requests": ZAMBA_BATCH, "batch": ZAMBA_BATCH,
           "prompt_len": ZAMBA_PROMPT, "gen": ZAMBA_GEN,
           "shared_invocations": model.n_invocations}
    with eng:
        eng.serve(reqs[:1])                        # warm the path
        obs.reset()
        obs.enable()
        gk.reset_launch_count()                    # the hybrid path starts
        lk.reset_launch_count()
        t0 = time.perf_counter()
        outs = eng.serve(reqs)
        secs = time.perf_counter() - t0
        launches = gk.launch_count()               # ... and ends here
        scan_launches = lk.launch_count()
        batches = int(obs.counter_value("serve.batches"))
        prefill = obs.hist_stats("serve.prefill_ms")
        decode = obs.hist_stats("serve.decode_ms_per_token")
        obs.reset()                                # profile untraced
        t_prof = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.serve(reqs)                        # one batch of 8
            wall_s = time.perf_counter() - t0
    by_name, busy_ms = device_time_by_kernel(prof)
    profile_s = time.perf_counter() - t_prof
    del prof
    want = steps * model.n_invocations * batches
    if launches != want or launches == 0:
        raise AssertionError(f"zamba2 serve: {launches} gqa_decode launches "
                             f"for {batches} batches (want {want})")
    for o in outs:
        if o.shape != (ZAMBA_GEN,) or o.min() < 0 or o.max() >= cfg.vocab:
            raise AssertionError(f"zamba2 serve: bad tokens {o.shape}")
    rec.update({"gqa_launches": launches, "batches": batches,
                "gqa_launches_per_step": launches / (steps * batches),
                "scan_launches": scan_launches, "seconds": secs,
                "requests_per_s": ZAMBA_BATCH / secs,
                "generated_tokens_per_s": ZAMBA_BATCH * ZAMBA_GEN / secs,
                "prefill_ms": prefill,
                "scan_in_ms_per_token": prefill["p50"] / ZAMBA_PROMPT,
                "decode_ms_per_token": decode,
                "profiled_batch_wall_ms": wall_s * 1e3,
                "device_busy_ms": busy_ms,
                "device_busy_share": busy_ms / (wall_s * 1e3),
                "device_ops": sum(n for _, _, n in by_name),
                "top_device_ms": [[name[:60], round(us / 1e3, 4), n]
                                  for us, name, n in by_name[:12]],
                "profile_s": profile_s})
    log("[zamba] " + json.dumps(rec))
    with api.ServeEngine(api.ServeConfig(workers=1, assemble_max=1, **kw),
                         weights=model.params()) as seq:
        seq_outs = seq.serve(reqs[:ZAMBA_SEQ_REQUESTS])
    for i, (a, b) in enumerate(zip(outs, seq_outs)):
        if not np.array_equal(a, b):
            raise AssertionError(f"zamba2 request {i}: batched != "
                                 f"sequential")
    log(f"[zamba] {ZAMBA_SEQ_REQUESTS} requests served one a batch: tokens "
        f"identical to the batched run")

    # gqa_decode at zamba2's decode shape, timed over one cache an
    # invocation (cold in L2, as a decode step finds them), beside SDPA
    inv, S = model.n_invocations, ZAMBA_PROMPT + ZAMBA_GEN
    lens = torch.arange(ZAMBA_PROMPT, S, ZAMBA_GEN // ZAMBA_BATCH,
                        dtype=torch.int32)
    rec["gqa_decode_shape"] = gqa_times(
        torch, ops, ref, [gk.KERNEL], ZAMBA_BATCH, cfg.n_heads,
        cfg.n_kv_heads, cfg.head_dim, S, lens, inv, 71)
    log("[zamba] gqa_decode at the decode shape "
        + json.dumps(rec["gqa_decode_shape"]))

    # bf16 forward of a served sequence, extended to ZAMBA_SCAN_T tokens:
    # each layer's scan held on its own inputs against the plain version
    T = ZAMBA_SCAN_T
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (ZAMBA_BATCH, T))
                            ).to(DEV)
    toks[:, :ZAMBA_PROMPT] = torch.from_numpy(np.stack(reqs)).to(DEV)
    toks[:, ZAMBA_PROMPT:S] = torch.from_numpy(np.stack(outs)).to(DEV)
    real_scan = ssm.ops.linear_scan
    seen = {"n": 0, "worst": 0.0, "first": None}

    def held(q_, k_, v_, w_):
        out = real_scan(q_, k_, v_, w_)
        want = ref.linear_scan_chunked(q_, k_, v_, w_)
        e, top = max_err(out, want), float(want.abs().max())
        if out.shape != want.shape or not e <= SCAN_TOL["bf16"] * top:
            raise AssertionError(
                f"zamba2 layer {seen['n']} scan {tuple(out.shape)}: max "
                f"|err| {e:.3e} beyond {SCAN_TOL['bf16']} x {top:.3e}")
        seen["worst"] = max(seen["worst"], e / top)
        if seen["first"] is None:
            seen["first"] = (q_, k_, v_, w_, e)
        seen["n"] += 1
        return out

    with torch.inference_mode():
        before = lk.launch_count()
        full = logits_with_scan(model, toks, held, slice(0, S))
        launches_fwd = lk.launch_count() - before
        effect = scan_effect(torch, model, toks, full, slice(0, S))
    if launches_fwd != cfg.n_layers or seen["n"] != cfg.n_layers:
        raise AssertionError(f"zamba2 hidden_states: {launches_fwd} "
                             f"linear_scan launches for {cfg.n_layers} "
                             f"layers")
    q_, k_, v_, w_, err = seen.pop("first")
    rec["bf16_scan_in_model"] = {
        "positions": T, "layers": launches_fwd,
        "scan_worst_ratio": seen["worst"], "scan_limit": SCAN_TOL["bf16"],
        "layer0_max_abs_err": err, "scan_effect_ratio": effect,
        **scan_times(torch, ops, ref, [lk.KERNEL], q_, k_, v_, w_)}
    log("[zamba] bf16, the kernel on every layer's inputs "
        + json.dumps(rec["bf16_scan_in_model"]))
    if not effect >= SSM_MIN_SCAN_EFFECT:
        raise AssertionError(f"zamba2 bf16: the scan moves the logits by "
                             f"only {effect:.2e} of their max")
    del eng, model, q_, k_, v_, w_, seen, full
    torch.cuda.empty_cache()
    return rec


def phase_zamba_f32(torch, api, gk, lk) -> dict:
    """zamba2-2.7b at full width in f32 (TF32 off): decode over every token
    (the exact recurrence and ``gqa_decode``) against ``hidden_states``
    (``linear_scan``, a ragged last chunk) + ``logits``; and the logits
    with the scan's output zeroed, to show the comparison sees it."""
    import gc

    import numpy as np
    gc.collect()
    torch.cuda.empty_cache()
    c = ZAMBA_F32
    cfg = dataclasses.replace(api.get_config(ZAMBA_ARCH, smoke=ZAMBA_SMOKE),
                              dtype="float32")
    model = api.build_model(cfg, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(72), scale=c["scale"])
    toks = torch.from_numpy(np.random.default_rng(73).integers(
        0, cfg.vocab, size=(c["batch"], c["seq"]))).to(DEV)
    with torch.inference_mode():
        cache = model.init_cache(c["batch"], c["seq"])
        dec = []
        before = gk.launch_count()
        for t in range(c["seq"]):
            cache, logits = model.decode_step(cache, toks[:, t])
            dec.append(logits)
        gqa = gk.launch_count() - before
        dec = torch.stack(dec, dim=1)
        before = lk.launch_count()
        full = model.logits(model.hidden_states(toks))
        launches = lk.launch_count() - before
        effect = scan_effect(torch, model, toks, full)
    scale = float(full.abs().max())
    err = max_err(dec, full)
    rec = {**c, "n_layers": cfg.n_layers, "max_abs_err": err,
           "ref_max_abs": scale, "ratio": err / scale,
           "limit": ZAMBA_F32_TOL, "scan_effect_ratio": effect,
           "scan_launches": launches, "gqa_launches": gqa}
    log("[zamba-f32] " + json.dumps(rec))
    if launches != cfg.n_layers or gqa != c["seq"] * model.n_invocations:
        raise AssertionError(f"zamba2 f32: {launches} linear_scan, {gqa} "
                             f"gqa_decode launches")
    if not err <= ZAMBA_F32_TOL * scale:
        raise AssertionError(f"zamba2 f32 decode vs chunked: max |err| "
                             f"{err:.3e} beyond {ZAMBA_F32_TOL} x "
                             f"{scale:.3e}")
    if not effect >= SSM_MIN_SCAN_EFFECT:
        raise AssertionError(f"zamba2 f32: the scan moves the logits by "
                             f"only {effect:.2e} of their max; the check "
                             f"is blind")
    del model, cache
    torch.cuda.empty_cache()
    return rec


def phase_serve_cli(torch, api, rk, gk, obs) -> dict:
    """16. ``python -m repro_torch.launch.serve`` through ``main(argv)``:
    ResNet-50 (12 ``rir_matmul`` launches a batch, the checksum, the first
    two outputs against the CPU reference), llama3.2-3b and whisper-small
    at full width and depth (``gqa_decode`` launches = the launches of a
    decode step x (gen - 1) a batch: the engine's decode loop runs gen - 1
    steps after prefill)."""
    import gc

    import numpy as np

    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import build_graph
    rec = {}
    for label, argv in (("network", CLI_NET), ("lm", CLI_LM),
                        ("whisper", CLI_WHISPER)):
        obs.reset()
        obs.enable()                         # the batch counter counts
        kernel = rk if label == "network" else gk
        kernel.reset_launch_count()          # the CLI's path starts here
        t0 = time.perf_counter()
        out = serve_cli.main(argv + ["--device", DEV])
        secs = time.perf_counter() - t0
        launches = kernel.launch_count()     # ... and ends here
        batches = int(obs.counter_value("serve.batches"))
        obs.reset()
        config, outs = out["config"], out["outputs"]
        if label == "network":
            graph = build_graph(config.graph).with_batch(config.max_batch)
            want = len(graph.layers) * batches
            last = graph.layers[-1]
            for o in outs:
                if o.shape != (last.P, last.Q, last.M) or \
                        not np.isfinite(o).all():
                    raise AssertionError(f"serve CLI: bad output {o.shape}")
            # the CLI's samples: default_rng(seed), as it draws them
            rng = np.random.default_rng(config.seed)
            xs = np.stack([rng.standard_normal(graph.input_shape()[1:])
                           .astype(np.float32) for _ in range(2)])
            y_ref = api.execute_network_reference(
                graph, torch.from_numpy(xs),
                api.init_graph_weights(list(graph.layers), seed=config.seed),
                device="cpu")
            checks = [check_network(f"serve CLI request {i}",
                                    torch.from_numpy(outs[i]), y_ref[i])
                      for i in range(2)]
            r = {"launches": launches, "batches": batches,
                 "checksum": float(np.sum(np.stack(outs))),
                 "max_abs_err": max(c["max_abs_err"] for c in checks)}
        else:
            cfg = api.get_config(config.arch, smoke=config.smoke)
            want = gqa_per_step(cfg) * (config.gen - 1) * batches
            for o in outs:
                if o.shape != (config.gen,) or o.min() < 0 or \
                        o.max() >= cfg.vocab:
                    raise AssertionError(f"serve CLI: bad tokens {o}")
            r = {"launches": launches, "batches": batches,
                 "n_layers": cfg.n_layers, "gen": config.gen,
                 "sample_tokens": outs[0][:12].tolist()}
        if launches != want or launches == 0:
            raise AssertionError(f"serve CLI {label}: {launches} launches, "
                                 f"want {want} ({batches} batches)")
        r.update(requests=len(outs), seconds=secs)
        rec[label] = r
        log("[serve_cli] " + json.dumps({"mode": label, **r}))
        del out, outs
        gc.collect()
        if DEV == "cuda":
            torch.cuda.empty_cache()
    return rec


def calibration(report, events) -> dict:
    """The report's per-step table (measured ``exec.step`` us against the
    plan's modeled us at 1 GHz, ``gap`` = measured / modeled, ``rel`` =
    gap / median gap) and its spread."""
    rep = report.build_report(events)
    table = [{"step": r["step"], "layer": r["layer"], "runs": r["runs"],
              "modeled_us": r["modeled_us"], "measured_us": r["measured_us"],
              "gap": r["gap"], "rel": r["rel_gap"]} for r in rep["steps"]]
    rels = [r["rel"] for r in table]
    gaps = [r["gap"] for r in table]
    return {"steps": table, "median_gap": rep["totals"]["median_gap"],
            "rel_min": min(rels), "rel_max": max(rels),
            "gap_spread": max(gaps) / min(gaps)}


def phase_smokes(torch, api, rk, obs, nets) -> dict:
    """17. ``repro_torch.serve.smoke`` and ``repro_torch.obs.smoke --graph
    resnet50 --check-identical`` on the card, the trace through
    ``repro_torch.obs.report --validate``, and the per-step calibration:
    each ``exec.step``'s measured ms against the plan's modeled cycles, on
    the smoke's one cold traced run (batch 1) and on CALIB_RUNS warm traced
    runs of the served batch-8 plan."""
    import contextlib
    import io

    from repro_torch.obs import report
    from repro_torch.obs import smoke as obs_smoke
    from repro_torch.serve import smoke as serve_smoke
    rk.reset_launch_count()                  # the serve smoke starts
    if serve_smoke.main(["--device", DEV]) != 0:
        raise AssertionError("serve smoke failed")
    serve_launches = rk.launch_count()       # ... and ends
    obs.reset()
    with tempfile.TemporaryDirectory(prefix="obs-smoke-") as tmp:
        path = pathlib.Path(tmp) / "trace.jsonl"
        rk.reset_launch_count()              # the obs smoke starts
        rc = obs_smoke.main(["--graph", OBS_GRAPH, "--check-identical",
                             "--out", str(path), "--device", DEV])
        launches = rk.launch_count()         # ... and ends
        obs.reset()
        if rc != 0:
            raise AssertionError(f"obs smoke exited {rc}")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = report.main([str(path), "--validate"])
        if rc != 0:
            raise AssertionError("the obs smoke's trace fails "
                                 "repro_torch.obs.report --validate")
        cold = calibration(report, obs.read_trace(path))
    # traced and untraced: one launch a plan step each
    n = len(cold["steps"])
    if launches != 2 * n or not n or serve_launches == 0:
        raise AssertionError(f"obs smoke: {launches} launches for {n} "
                             f"steps; serve smoke {serve_launches}")
    graph, plan = nets["resnet50"]
    weights = api.init_graph_weights(list(graph.layers), seed=0)
    prepared = api.prepare_network(plan, graph, weights, device=DEV)
    x = torch.randn(graph.input_shape(),
                    generator=torch.Generator().manual_seed(4)).to(DEV)
    prepared(x)                              # warm: allocations, first use
    obs.reset()
    obs.enable()
    for _ in range(CALIB_RUNS):
        prepared(x)
    warm = calibration(report, obs.events())
    obs.reset()
    rec = {"serve_smoke_launches": serve_launches, "obs_launches": launches,
           "cold_b1": cold, "warm_b8": warm}
    for label in ("cold_b1", "warm_b8"):
        for r in rec[label]["steps"]:
            log(f"[calibration {label}] " + json.dumps(r))
        log(f"[smokes {label}] " + json.dumps(
            {k: v for k, v in rec[label].items() if k != "steps"}))
    return rec


def phase_chaos(torch, api, rk, gk, obs) -> dict:
    """18. ``repro_torch.runtime.chaos --seed 0 --graph resnet50 --arch
    llama3p2_3b`` on the card: every scheduled fault fires, none escapes,
    outputs bit-identical at tier <= 1; the kernels' launches in it."""
    from repro_torch.runtime import chaos
    with tempfile.TemporaryDirectory(prefix="chaos-") as tmp:
        out = pathlib.Path(tmp) / "chaos.json"
        rk.reset_launch_count()
        gk.reset_launch_count()              # the chaos run starts
        rc = chaos.main(["--seed", "0", "--graph", CHAOS_GRAPH, "--arch",
                         CHAOS_ARCH, "--device", DEV, "--report", str(out)])
        launches = {"rir_matmul": rk.launch_count(),
                    "gqa_decode": gk.launch_count()}   # ... and ends
        obs.reset()
        if rc != 0:
            raise AssertionError(f"chaos exited {rc}")
        rep = json.loads(out.read_text())
    # the serve phase's two decode passes, gen - 1 steps each
    cfg = api.get_config(CHAOS_ARCH, smoke=True)
    want_gqa = 2 * cfg.n_layers * (CHAOS_GEN - 1)
    if launches["rir_matmul"] == 0 or launches["gqa_decode"] != want_gqa:
        raise AssertionError(f"chaos launches {launches}, want rir_matmul "
                             f"> 0 and gqa_decode {want_gqa}")
    rec = {"launches": launches, "counters": rep["counters"],
           "tiers": {k: rep[k]["faulted_tier"] for k in ("network", "serve")},
           "injected": {k: rep[k]["sites"] for k in
                        ("network", "engine", "serve")}}
    log("[chaos] " + json.dumps(rec))
    return rec


def _bits(t):
    """A tensor's bit patterns, for a bit-for-bit comparison."""
    import torch
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def phase_resume(torch, api, lk, obs) -> dict:
    """19. The rwkv6 trainer at full width and RESUME_LAYERS layers:
    RESUME_STEPS steps straight, then half of them with a checkpoint and
    a resume to RESUME_STEPS in a fresh model: the final loss within
    RESUME_REL; the checkpoint restored into a fresh model gives back
    every bf16 parameter and f32 state bit for bit.  Each run is traced,
    so its ``train.step`` spans give each step's seconds and the host time
    between steps, where the save of a checkpoint blocks the loop (the
    resumed run saves at the middle step, to be seen there)."""
    import gc
    import shutil

    from repro_torch.launch import train as tl
    base = ["--arch", RESUME_ARCH, "--layers", str(RESUME_LAYERS),
            "--batch", str(RESUME_BATCH), "--seq", str(RESUME_SEQ),
            "--log-every", "1", "--device", DEV]
    base += ["--smoke"] if RESUME_SMOKE else []
    half = RESUME_STEPS // 2

    def run(steps, *extra):
        """The launcher's result, its seconds, each step's seconds
        (``step_s``), the host seconds before each step since the last
        one ended (``gap_s``: set-up and restore before the first; a save
        after the one before), and the seconds after the last step
        (``tail_s``: the end-of-run save and the wait for the writes)."""
        obs.reset()
        obs.enable()
        t0, us0 = time.perf_counter(), obs.now_us()
        out = tl.train(tl.parse_args(base + ["--steps", str(steps),
                                             *extra]))
        us1 = obs.now_us()
        out["seconds"] = time.perf_counter() - t0
        spans = [e for e in obs.events()
                 if e.get("ev") == "span" and e["name"] == "train.step"]
        obs.reset()
        prev = us0
        out["step_s"], out["gap_s"] = {}, {}
        for e in spans:
            step = e["attrs"]["step"]
            out["gap_s"][step] = (e["ts"] - prev) / 1e6
            out["step_s"][step] = e["dur"] / 1e6
            prev = e["ts"] + e["dur"]
        out["tail_s"] = (us1 - prev) / 1e6
        return out

    def free():
        gc.collect()
        if DEV == "cuda":
            torch.cuda.empty_cache()

    straight = run(RESUME_STEPS)
    cfg = straight["model"].cfg
    if cfg.n_layers != RESUME_LAYERS:
        raise AssertionError(f"--layers {RESUME_LAYERS} built "
                             f"{cfg.n_layers} layers")
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "params": sum(p.numel() for p in straight["model"].params()
                         .values()),
           "batch": RESUME_BATCH, "seq": RESUME_SEQ,
           "straight_losses": straight["losses"],
           "straight_s": straight["seconds"],
           "straight_step_s": straight["step_s"]}
    del straight["model"], straight["opt_state"]
    free()
    with tempfile.TemporaryDirectory(prefix="resume-") as tmp:
        rec["disk_free_gb"] = shutil.disk_usage(tmp).free / 1e9
        first = run(half, "--ckpt-dir", tmp, "--ckpt-every", str(half))
        saved = {n: p.detach().clone()
                 for n, p in first["model"].params().items()}
        saved_opt = first["opt_state"]
        rec.update(first_s=first["seconds"], first_tail_s=first["tail_s"],
                   ckpt_bytes=sum(p.stat().st_size for p in
                                  pathlib.Path(tmp).rglob("*")
                                  if p.is_file()))
        del first
        free()
        # a fresh model from another seed: nothing matches by accident
        fresh = api.build_model(cfg, device=DEV)
        fresh.init(torch.Generator(device=fresh.device).manual_seed(1))
        fresh_opt = api.adamw_init(fresh.params())
        t0 = time.perf_counter()
        mgr = api.CheckpointManager(tmp)
        step = tl.restore_into(mgr, fresh, fresh_opt, cfg)
        mgr.close()
        rec["restore_s"] = time.perf_counter() - t0
        if step != half or fresh_opt.step != saved_opt.step:
            raise AssertionError(f"restored step {step}/{fresh_opt.step}, "
                                 f"want {half}")
        got = fresh.params()
        bad = [n for n, p in saved.items()
               if not torch.equal(_bits(got[n]), _bits(p))]
        for field in ("mu", "nu", "master"):
            own, back = getattr(saved_opt, field), getattr(fresh_opt, field)
            bad += [f"{field}.{n}" for n, t in own.items()
                    if not torch.equal(_bits(back[n]), _bits(t))]
        if bad:
            raise AssertionError(f"restore is not bit-exact: {bad[:5]}")
        rec["bit_exact_leaves"] = len(saved) * 4
        rec["param_dtype"] = str(next(iter(saved.values())).dtype)
        del saved, saved_opt, fresh, fresh_opt, got
        free()
        lk.reset_launch_count()              # the resumed run starts
        mid = half + half // 2
        resumed = run(RESUME_STEPS, "--ckpt-dir", tmp, "--ckpt-every",
                      str(mid - half))
        launches = lk.launch_count()         # ... and ends
        gaps = resumed["gap_s"]
        rec.update(resumed_losses=resumed["losses"],
                   resumed_s=resumed["seconds"],
                   resumed_step_s=resumed["step_s"], resumed_gap_s=gaps,
                   resumed_tail_s=resumed["tail_s"],
                   setup_and_restore_s=gaps[half],
                   save_block_s=gaps[mid],
                   other_gap_s=max(gaps[s] for s in gaps
                                   if s not in (half, mid)),
                   scan_launches=launches)
        if resumed["start"] != half:
            raise AssertionError(f"resumed at {resumed['start']}")
        del resumed
        free()
    want = 2 * cfg.n_layers * (RESUME_STEPS - half)   # forward + remat
    if launches != want:
        raise AssertionError(f"resumed run: {launches} linear_scan "
                             f"launches, want {want}")
    a, b = rec["straight_losses"], rec["resumed_losses"]
    last = RESUME_STEPS - 1
    rec["max_abs_dloss"] = max(abs(a[s] - b[s])
                               for s in range(half, RESUME_STEPS))
    rec["final_rel"] = abs(a[last] - b[last]) / abs(a[last])
    log("[resume] " + json.dumps(rec))
    if not rec["final_rel"] <= RESUME_REL:
        raise AssertionError(f"resumed final loss {b[last]} vs straight "
                             f"{a[last]}: rel {rec['final_rel']:.3e}")
    return rec


# ------------------------------------------ phases 20-22: MoE and whisper
def phase_gqa_new(torch, api, ops, ref, gk) -> dict:
    """20. ``gqa_decode`` at the new families' shapes: G 6 (dbrx), G 5
    (llama4-scout) and G 1 at D 64 (whisper), each at S = 1500 with every
    row at full length and at ragged lengths, f32 and bf16, against the
    plain version; then timed (``gqa_times``) at whisper's cross-attention
    shape (B 8, 12/12, D 64, S 1500, full rows; one cache a decoder layer)
    and at dbrx's decode shape (B 8, 48/8, D 128, S 144; one cache a
    layer of the full 40)."""
    gen = torch.Generator(device="cpu").manual_seed(80)
    S = GQA_NEW_S
    worst, n = {"f32": 0.0, "bf16": 0.0}, 0
    for label, (hq, hkv, d) in GQA_NEW_SHAPES.items():
        for rows, lens in (("full", [S] * 8),
                           ("ragged", [1, 255, 256, 257, 700, 1023, 1499,
                                       1500])):
            for dt, tdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                q = torch.randn(8, hq, d, generator=gen).to(DEV, tdt)
                k = torch.randn(8, S, hkv, d, generator=gen).to(DEV, tdt)
                v = torch.randn(8, S, hkv, d, generator=gen).to(DEV, tdt)
                ln = torch.tensor(lens, dtype=torch.int32).to(DEV)
                y = ops.gqa_decode(q, k, v, ln)
                name = f"gqa {label} S={S} {rows} {dt}"
                if y.dtype != tdt or y.shape != q.shape:
                    raise AssertionError(f"{name}: {y.dtype} {y.shape}")
                err = check_close(name, y, ref.gqa_decode(q, k, v, ln),
                                  GQA_TOL[dt], GQA_TOL[dt])
                worst[dt] = max(worst[dt], err)
                n += 1
    log(f"[gqa-new] {n} cases at S={S} within tolerance; worst |err| f32 "
        f"{worst['f32']:.3e}, bf16 {worst['bf16']:.3e}")
    rec = {"cases": n, "worst": worst}
    wc = api.get_config(WHISPER_ARCH, smoke=WHISPER_SMOKE)
    rec["whisper_cross"] = gqa_times(
        torch, ops, ref, [gk.KERNEL], WHISPER_BATCH, wc.n_heads,
        wc.n_kv_heads, wc.head_dim, wc.enc_frames,
        [wc.enc_frames] * WHISPER_BATCH, wc.n_layers, 81)
    log("[gqa-new] whisper cross shape " + json.dumps(rec["whisper_cross"]))
    dc = api.get_config(MOE_ARCHS[0], smoke=MOE_SMOKE)
    S = MOE_PROMPT + MOE_GEN
    lens = list(range(MOE_PROMPT, S, MOE_GEN // MOE_BATCH))
    rec["dbrx_decode"] = gqa_times(
        torch, ops, ref, [gk.KERNEL], MOE_BATCH, dc.n_heads, dc.n_kv_heads,
        dc.head_dim, S, lens, dc.n_layers, 82)
    log("[gqa-new] dbrx decode shape " + json.dumps(rec["dbrx_decode"]))
    return rec


def phase_whisper_serve(torch, api, gk, obs) -> dict:
    """21. whisper-small served at full width and depth: 16 requests at
    ``max_batch=8``, prompt 64, gen 32; (gen - 1) x 24 ``gqa_decode``
    launches a batch (12 self-, 12 cross-attention); one batch under
    ``torch.profiler`` for the device's busy share, its only ``gqa``
    device kernel the decode kernel; the encoder alone timed over a
    batch of stub frames (most of a prefill); 2 requests again one a
    batch, identical tokens (whisper's rows are independent, unlike an
    MoE's)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    cfg = api.get_config(WHISPER_ARCH, smoke=WHISPER_SMOKE)
    rng = np.random.default_rng(83)
    reqs = [rng.integers(0, cfg.vocab, WHISPER_PROMPT).astype(np.int32)
            for _ in range(WHISPER_REQUESTS)]
    kw = dict(arch=WHISPER_ARCH, smoke=WHISPER_SMOKE,
              max_batch=WHISPER_BATCH, prompt_len=WHISPER_PROMPT,
              gen=WHISPER_GEN, seed=WHISPER_SEED, device=DEV)
    per_batch = (WHISPER_GEN - 1) * gqa_per_step(cfg)
    t0 = time.perf_counter()
    eng = api.ServeEngine(api.ServeConfig(workers=1, **kw))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in eng.model.params().values())
    rec = {"arch": cfg.name, "enc_layers": cfg.enc_layers,
           "n_layers": cfg.n_layers, "enc_frames": cfg.enc_frames,
           "params": n_params, "init_s": init_s,
           "requests": WHISPER_REQUESTS, "batch": WHISPER_BATCH,
           "prompt_len": WHISPER_PROMPT, "gen": WHISPER_GEN}
    with eng:
        eng.serve(reqs[:1])                        # warm the path
        obs.reset()
        obs.enable()
        gk.reset_launch_count()                    # the whisper path starts
        t0 = time.perf_counter()
        outs = eng.serve(reqs)
        secs = time.perf_counter() - t0
        launches = gk.launch_count()               # ... and ends here
        batches = int(obs.counter_value("serve.batches"))
        prefill = obs.hist_stats("serve.prefill_ms")
        decode = obs.hist_stats("serve.decode_ms_per_token")
        obs.reset()                                # profile untraced
        before = gk.launch_count()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.serve(reqs[:WHISPER_BATCH])
            wall_s = time.perf_counter() - t0
        prof_launches = gk.launch_count() - before
    # the encoder alone over a batch of zero stub frames: prefill's share
    frames = torch.zeros((WHISPER_BATCH, cfg.enc_frames, cfg.d_model),
                         dtype=getattr(torch, cfg.dtype), device=DEV)
    with torch.inference_mode():
        eng.model.encode(frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            eng.model.encode(frames)
        torch.cuda.synchronize()
        encode_ms = (time.perf_counter() - t0) / 3 * 1e3
    del frames
    if launches != per_batch * batches or launches == 0:
        raise AssertionError(f"whisper serve: {launches} gqa_decode "
                             f"launches for {batches} batches ({per_batch}"
                             f" a batch)")
    by_name, busy_ms = device_time_by_kernel(prof)
    del prof
    gqa_kernels = [[name, n] for _, name, n in by_name if "gqa" in name]
    if len(gqa_kernels) != 1 or gk.KERNEL not in gqa_kernels[0][0] \
            or not 0 < gqa_kernels[0][1] <= prof_launches:
        raise AssertionError(f"whisper serve: {prof_launches} gqa_decode "
                             f"launches in the profiled batch, device "
                             f"kernels {gqa_kernels}")
    for o in outs:
        if o.shape != (WHISPER_GEN,) or o.min() < 0 or o.max() >= cfg.vocab:
            raise AssertionError(f"whisper serve: bad tokens {o.shape}")
    rec.update({
        "gqa_launches": launches, "batches": batches,
        "gqa_launches_per_batch": launches / batches,
        "profiled_gqa_launches": prof_launches, "seconds": secs,
        "requests_per_s": WHISPER_REQUESTS / secs,
        "generated_tokens_per_s": WHISPER_REQUESTS * WHISPER_GEN / secs,
        "prefill_ms": prefill, "encode_ms": encode_ms,
        "decode_ms_per_token": decode,
        "profiled_batch_wall_ms": wall_s * 1e3,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (wall_s * 1e3),
        "device_ops": sum(n for _, _, n in by_name),
        "top_device_ms": [[name[:60], round(us / 1e3, 4), n]
                          for us, name, n in by_name[:12]],
        "sample_tokens": outs[0][:12].tolist()})
    log("[whisper] " + json.dumps(rec))
    # no row sees another: the same requests one a batch, identical tokens
    with api.ServeEngine(api.ServeConfig(workers=1, assemble_max=1, **kw),
                         weights=eng.model.params()) as seq:
        seq_outs = seq.serve(reqs[:WHISPER_SEQ_REQUESTS])
    for i, (a, b) in enumerate(zip(outs, seq_outs)):
        if not np.array_equal(a, b):
            raise AssertionError(f"whisper request {i}: batched != "
                                 f"sequential")
    log(f"[whisper] {WHISPER_SEQ_REQUESTS} requests served one a batch: "
        f"tokens identical to the batched run")
    del eng
    torch.cuda.empty_cache()
    return rec


def phase_whisper_f32(torch, api, gk) -> dict:
    """21 (cont.). whisper-small at full width and depth in f32 (TF32 off;
    0.84 GB): the same weights on the card and on the CPU (plain path),
    ``prefill`` over zero stub frames, then WHISPER_F32["steps"]
    teacher-forced decode steps (the CPU's greedy tokens); the logits at
    WHISPER_F32_TOL and within WHISPER_F32_REL x max |logit|."""
    import gc

    import numpy as np
    gc.collect()
    torch.cuda.empty_cache()
    c = WHISPER_F32
    cfg = dataclasses.replace(api.get_config(WHISPER_ARCH,
                                             smoke=WHISPER_SMOKE),
                              dtype="float32")
    cpu = api.build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(84))
    dev = api.build_model(cfg, device=DEV).load_params(cpu.params())
    toks = torch.from_numpy(np.random.default_rng(85).integers(
        0, cfg.vocab, size=(c["batch"], c["prompt"])))
    S = c["prompt"] + c["steps"]
    worst, scale, launches = 0.0, 0.0, 0
    with torch.inference_mode():
        t0 = time.perf_counter()
        c_cpu, l_cpu = cpu.prefill(toks, S)
        cpu_s = time.perf_counter() - t0
        c_dev, l_dev = dev.prefill(toks.to(DEV), S)
        for step in range(c["steps"] + 1):
            if step:
                tok = torch.argmax(l_cpu, dim=-1)
                c_cpu, l_cpu = cpu.decode_step(c_cpu, tok)
                before = gk.launch_count()
                c_dev, l_dev = dev.decode_step(c_dev, tok.to(DEV))
                launches += gk.launch_count() - before
            got = l_dev.cpu()
            worst = max(worst, check_close(f"whisper f32 step {step}", got,
                                           l_cpu, **WHISPER_F32_TOL))
            scale = max(scale, float(l_cpu.abs().max()))
    rec = {**c, "enc_layers": cfg.enc_layers, "n_layers": cfg.n_layers,
           "max_abs_err": worst, "ref_max_abs": scale, "ratio": worst / scale,
           "limit": WHISPER_F32_REL, **WHISPER_F32_TOL,
           "gqa_launches": launches, "cpu_prefill_s": cpu_s}
    log("[whisper-f32] " + json.dumps(rec))
    if launches != c["steps"] * gqa_per_step(cfg):
        raise AssertionError(f"whisper f32: {launches} gqa_decode launches")
    if not worst <= WHISPER_F32_REL * scale:
        raise AssertionError(f"whisper f32: max |err| {worst:.3e} beyond "
                             f"{WHISPER_F32_REL} x {scale:.3e}")
    del cpu, dev, c_cpu, c_dev
    gc.collect()
    torch.cuda.empty_cache()
    return rec


class MoeRecorder:
    """Wraps ``lm.moe_apply`` while in a ``with``: each call's capacity C,
    its per-expert counts and dropped assignments (from the router on the
    block's inputs, recomputed), and its top-k ids and router logits."""

    def __init__(self, torch):
        self.torch = torch
        self.calls = []

    def __enter__(self):
        from repro_torch.models import blocks, lm
        self.lm, self.real = lm, lm.moe_apply

        def recorded(cfg, p, x):
            _, logits, (_, idx) = blocks.moe_route(cfg, p, x)
            N = x.shape[0] * x.shape[1]
            C = blocks.moe_capacity(cfg, N)
            counts = self.torch.bincount(idx.reshape(-1),
                                         minlength=cfg.n_experts)
            self.calls.append({
                "N": N, "C": C,
                "dropped": int(self.torch.clamp(counts - C, min=0).sum()),
                "max_load": int(counts.max()), "idx": idx.cpu(),
                "logits": logits.cpu()})
            return self.real(cfg, p, x)

        lm.moe_apply = recorded
        return self

    def __exit__(self, *exc):
        self.lm.moe_apply = self.real
        return False


def route_compare(torch, want, got, k: int) -> dict:
    """Routing of two runs call by call: the (token, k) ids must agree
    wherever the k-th and (k+1)-th router logits of ``want`` are more than
    MOE_ROUTE_MARGIN apart; the flips inside the margin are counted."""
    flips = near = 0
    for a, b in zip(want, got):
        srt = torch.sort(a["logits"], dim=-1, descending=True).values
        margin = srt[:, k - 1] - srt[:, min(k, srt.shape[1] - 1)]
        clear = margin > MOE_ROUTE_MARGIN
        if k == srt.shape[1]:
            clear[:] = True
        differ = (a["idx"] != b["idx"]).any(dim=-1)
        if bool((differ & clear).any()):
            raise AssertionError(f"routing differs on "
                                 f"{int((differ & clear).sum())} tokens "
                                 f"whose router margin is over "
                                 f"{MOE_ROUTE_MARGIN}")
        flips += int(differ.sum())
        near += int((~clear).sum())
    return {"calls": len(want), "near_ties": near, "flips": flips}


def phase_moe(torch, api, ops, ref, gk) -> dict:
    """22. dbrx-132b, then llama4-scout, at full width and MOE_LAYERS
    layers (bf16, random weights from MOE_SEED), through ``build_model`` ->
    ``prefill`` -> ``decode_step`` (the calls the engine's LM backend
    makes): batch 8, prompt 128, then gen - 1 greedy decode steps, 4
    ``gqa_decode`` launches a step; each prefill layer's capacity C and
    dropped assignments; LM_TF_STEPS teacher-forced decode steps under
    ``torch.profiler`` (the device's busy share), then held in bf16
    against the same model with the plain ``ref.gqa_decode`` in the
    kernel's place (rows whose routing flips are reported, not held);
    peak device memory.  Then the dispatch logic in f32 at SMOKE
    widths, card against CPU.  Each model is freed before the next."""
    import gc

    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    rec = {}
    for arch in MOE_ARCHS:
        cfg = dataclasses.replace(api.get_config(arch, smoke=MOE_SMOKE),
                                  n_layers=MOE_LAYERS)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = api.build_model(cfg, device=DEV).init(
            torch.Generator(device=DEV).manual_seed(MOE_SEED))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.params().values())
        toks = torch.from_numpy(np.random.default_rng(86).integers(
            0, cfg.vocab, size=(MOE_BATCH, MOE_PROMPT))).to(DEV)
        S = MOE_PROMPT + MOE_GEN
        r = {"arch": cfg.name, "n_layers": cfg.n_layers,
             "full_n_layers": api.get_config(arch, smoke=MOE_SMOKE).n_layers,
             "params": n_params, "param_gb": sum(
                 p.numel() * p.element_size()
                 for p in model.params().values()) / 1e9,
             "n_experts": cfg.n_experts, "top_k": cfg.top_k,
             "shared_expert": cfg.shared_expert, "init_s": init_s,
             "batch": MOE_BATCH, "prompt_len": MOE_PROMPT, "gen": MOE_GEN}
        with torch.inference_mode():
            model.prefill(toks, S)                 # warm the path
            torch.cuda.synchronize()
            gk.reset_launch_count()                # the MoE path starts
            t0 = time.perf_counter()
            cache, logits = model.prefill(toks, S)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            tok = torch.argmax(logits, dim=-1)
            out = [tok]
            t0 = time.perf_counter()
            for _ in range(MOE_GEN - 1):
                cache, logits = model.decode_step(cache, tok)
                tok = torch.argmax(logits, dim=-1)
                out.append(tok)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
            launches = gk.launch_count()           # ... and ends here
            served = torch.stack(out, dim=1)
            del cache
            with MoeRecorder(torch) as prefill_rec:
                cache, _ = model.prefill(toks, S)
            # teacher-forced: the served tokens fed to the kernel's decode
            # and, from a copy of the same cache, to the plain version's;
            # first the kernel's steps once more under the profiler
            saved = {k: v.clone() for k, v in cache["layers"].items()}
            length0 = cache["length"].clone()

            def restore():
                for k, v in saved.items():
                    cache["layers"][k].copy_(v)
                cache["length"].copy_(length0)

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for j in range(LM_TF_STEPS):
                    model.decode_step(cache, served[:, j])
                torch.cuda.synchronize()
                prof_wall_s = time.perf_counter() - t0
            restore()
            runs = {}
            for label in ("kernel", "plain"):
                if label == "plain":
                    real = ops.gqa_decode
                    ops.gqa_decode = ref.gqa_decode
                    restore()
                try:
                    with MoeRecorder(torch) as routed:
                        steps = []
                        for j in range(LM_TF_STEPS):
                            cache, lg = model.decode_step(cache,
                                                          served[:, j])
                            steps.append(lg.float())
                finally:
                    if label == "plain":
                        ops.gqa_decode = real
                runs[label] = (torch.stack(steps, dim=1), routed.calls)
        by_name, busy_ms = device_time_by_kernel(prof)
        del prof
        r["profiled_decode"] = {
            "steps": LM_TF_STEPS, "wall_ms": prof_wall_s * 1e3,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (prof_wall_s * 1e3),
            "device_ops": sum(n for _, _, n in by_name),
            "top_device_ms": [[name[:60], round(us / 1e3, 4), n]
                              for us, name, n in by_name[:8]]}
        want, got = runs["plain"][0], runs["kernel"][0]
        # a row whose routing differs in a step keeps its own path from
        # there: report it, hold the rest
        flipped = torch.zeros(MOE_BATCH, dtype=torch.bool)
        for a, b in zip(runs["plain"][1], runs["kernel"][1]):
            flipped |= (a["idx"] != b["idx"]).any(dim=-1)
        keep = (~flipped).to(want.device)
        err = max_err(got[keep], want[keep]) if bool(keep.any()) else 0.0
        scale = float(want.abs().max())
        r["teacher_forced"] = {
            "steps": LM_TF_STEPS, "max_abs_err": err, "ref_max_abs": scale,
            "ratio": err / scale, "limit": LM_TF_REL,
            "rows_with_routing_flips": int(flipped.sum()),
            "rows_flipped_max_abs_err": max_err(got[~keep], want[~keep])
            if bool(flipped.any()) else 0.0}
        if launches != (MOE_GEN - 1) * cfg.n_layers:
            raise AssertionError(f"{arch}: {launches} gqa_decode launches "
                                 f"for {MOE_GEN - 1} decode steps")
        if not err <= LM_TF_REL * scale:
            raise AssertionError(f"{arch} teacher-forced: kernel vs plain "
                                 f"max |err| {err:.3e} beyond {LM_TF_REL} "
                                 f"x {scale:.3e}")
        if not torch.isfinite(served.float()).all() or \
                served.min() < 0 or served.max() >= cfg.vocab:
            raise AssertionError(f"{arch}: bad served tokens")
        r.update({
            "gqa_launches": launches,
            "gqa_launches_per_step": launches / (MOE_GEN - 1),
            "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_token": decode_s * 1e3 / (MOE_GEN - 1),
            "generated_tokens_per_s": MOE_BATCH * MOE_GEN
            / (prefill_s + decode_s),
            "prefill_layers": [{k: c[k] for k in ("N", "C", "dropped",
                                                  "max_load")}
                               for c in prefill_rec.calls],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "sample_tokens": served[0, :12].tolist()})
        if arch == "dbrx_132b":
            r["ep_mesh"] = moe_ep_check(torch, model, toks, S)
        log(f"[moe {arch}] " + json.dumps(r))
        del model, cache, saved, runs, prefill_rec
        gc.collect()
        torch.cuda.empty_cache()
        r["f32"] = moe_f32(torch, api, gk, arch)
        rec[arch] = r
    return rec


def moe_ep_check(torch, model, toks, S) -> dict:
    """One prefill of ``model`` with every layer's MoE block run twice on
    the same input: ``moe_apply`` (whose output goes on) and the
    expert-parallel ``moe_apply_ep`` on the one-rank NCCL mesh.  At one
    rank the shard's capacity is the global one, so the slot the EP path
    gave each (token, k) (``return_slot``) must equal ``moe_dispatch``'s
    for ``moe_apply``'s routing, drops included; the outputs agree within
    MESH_EP_REL of max |out|, one bf16 rounding.  The block without EP
    (``moe_apply_tp``, which decode steps on a mesh take) runs on the same
    input and is held to the same limit."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import moe_ep
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import blocks, lm
    mesh = make_local_mesh(1, DEV)
    real = lm.moe_apply
    layers = []

    def both(cfg, p, x):
        want = real(cfg, p, x)
        got, slot_ep = moe_ep.moe_apply_ep(cfg, p, x, mesh, return_slot=True)
        N, E = x.shape[0] * x.shape[1], cfg.n_experts
        flat, _, (_, idx) = blocks.moe_route(cfg, p, x)
        c_one, c_ep = blocks.moe_capacity(cfg, N), moe_ep.capacity(cfg, N)
        slot_one, _ = blocks.moe_dispatch(flat, idx, E, c_one)
        layers.append({
            "N": N, "C": c_one, "C_ep": c_ep,
            "dropped": int((slot_one == E * c_one).sum()),
            "dropped_ep": int((slot_ep == E * c_ep).sum()),
            "same_slots": bool(torch.equal(slot_one, slot_ep)),
            "max_abs_err": max_err(got, want),
            "max_abs_err_tp": max_err(moe_ep.moe_apply_tp(cfg, p, x, mesh),
                                      want),
            "ref_max_abs": float(want.float().abs().max())})
        return want

    col.reset_calls()
    lm.moe_apply = both
    try:
        with torch.inference_mode():
            model.prefill(toks, S)
    finally:
        lm.moe_apply = real
    torch.cuda.synchronize()
    calls = dict(col.CALLS)
    for i, c in enumerate(layers):
        if c["C"] != c["C_ep"] or not c["same_slots"]:
            raise AssertionError(f"EP layer {i}: capacity, routing or drops "
                                 f"differ: {c}")
        for key in ("max_abs_err", "max_abs_err_tp"):
            if not c[key] <= MESH_EP_REL * c["ref_max_abs"]:
                raise AssertionError(f"EP layer {i}: {key} {c[key]:.3e} "
                                     f"beyond {MESH_EP_REL} x "
                                     f"{c['ref_max_abs']:.3e}")
    want_a2a = 2 * len(layers)
    if calls["all_to_all_single"] != want_a2a:
        raise AssertionError(f"EP: {calls['all_to_all_single']} "
                             f"all-to-alls, want {want_a2a}")
    rec = {"layers": layers, "collectives": calls,
           "max_abs_err": max(c["max_abs_err"] for c in layers),
           "max_abs_err_tp": max(c["max_abs_err_tp"] for c in layers),
           "ref_max_abs": max(c["ref_max_abs"] for c in layers)}
    log("[mesh dbrx ep] " + json.dumps(rec))
    return rec


def moe_f32(torch, api, gk, arch) -> dict:
    """The dispatch logic in f32 (TF32 off) at SMOKE widths: the same
    weights (at MOE_F32["scale"]) on the card and on the CPU, prefill and
    MOE_F32["steps"] teacher-forced decode steps (the CPU's greedy
    tokens); identical routing outside MOE_ROUTE_MARGIN, and the logits
    within LM_F32_TOL wherever no routing flipped."""
    import numpy as np
    c = MOE_F32
    cfg = api.get_config(arch, smoke=True)
    cpu = api.build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(87), scale=c["scale"])
    dev = api.build_model(cfg, device=DEV).load_params(cpu.params())
    toks = torch.from_numpy(np.random.default_rng(88).integers(
        0, cfg.vocab, size=(c["batch"], c["prompt"])))
    S = c["prompt"] + c["steps"]
    worst, scale, launches, unheld = 0.0, 0.0, 0, 0
    routes = {"calls": 0, "near_ties": 0, "flips": 0}
    drops = []
    with torch.inference_mode():
        for step in range(c["steps"] + 1):
            with MoeRecorder(torch) as r_cpu:
                if step:
                    tok = torch.argmax(l_cpu, dim=-1)
                    c_cpu, l_cpu = cpu.decode_step(c_cpu, tok)
                else:
                    c_cpu, l_cpu = cpu.prefill(toks, S)
            with MoeRecorder(torch) as r_dev:
                before = gk.launch_count()
                if step:
                    c_dev, l_dev = dev.decode_step(c_dev, tok.to(DEV))
                else:
                    c_dev, l_dev = dev.prefill(toks.to(DEV), S)
                launches += gk.launch_count() - before
            rc = route_compare(torch, r_cpu.calls, r_dev.calls, cfg.top_k)
            for k in routes:
                routes[k] += rc[k]
            if not step:
                drops = [x["dropped"] for x in r_cpu.calls]
            scale = max(scale, float(l_cpu.abs().max()))
            if rc["flips"] or unheld:
                # a near tie flipped: from here the two runs may part (a
                # prefill flip moves other tokens' places in the queues)
                unheld += 1
                continue
            worst = max(worst, check_close(f"{arch} f32 step {step}",
                                           l_dev.cpu(), l_cpu, LM_F32_TOL,
                                           LM_F32_TOL))
    if launches != c["steps"] * cfg.n_layers:
        raise AssertionError(f"{arch} f32: {launches} gqa_decode launches")
    rec = {**c, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "max_abs_err": worst, "ref_max_abs": scale, "tol": LM_F32_TOL,
           "prefill_dropped": drops, "routing": routes,
           "steps_not_held_for_flips": unheld, "gqa_launches": launches}
    log(f"[moe-f32 {arch}] " + json.dumps(rec))
    return rec


def nccl_device_ms(prof) -> dict:
    """Device ms of the NCCL kernels in a ``torch.profiler`` run, the
    device's busy ms, and its largest events."""
    by_name, busy = device_time_by_kernel(prof)
    return {"nccl_ms": sum(us for us, name, _ in by_name
                           if "nccl" in name.lower()) / 1e3,
            "busy_ms": busy,
            "top": [[name[:50], round(us / 1e3, 4), k]
                    for us, name, k in by_name[:10]]}


def phase_mesh(torch, api, gk, lk, moe) -> dict:
    """23. The distribution layer on a one-rank NCCL mesh: llama3.2-3b
    serving through ``prefill_step``/``serve_step`` and rwkv6 training
    through ``make_train_step(model, mesh, ...)`` in both layout modes,
    each against the one-device path on the same weights; dbrx's EP check
    (run in phase 22) is carried into this record."""
    import gc

    import numpy as np
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.distributed import collectives as col
    mesh = api.make_local_mesh(1, DEV)
    rec = {"world": dist.get_world_size(), "backend": dist.get_backend(),
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
    if rec["backend"] != "nccl":
        raise AssertionError(f"backend {rec['backend']}, want nccl")

    # -- llama3.2-3b: prefill_step + serve_step against the one device
    cfg = api.get_config(LM_ARCH, smoke=LM_SMOKE)
    one = api.build_model(cfg, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(LM_SEED))
    sharded = api.build_model(cfg, device=DEV).load_params(one.params())
    toks = torch.from_numpy(np.random.default_rng(23).integers(
        0, cfg.vocab, size=(LM_BATCH, LM_PROMPT))).to(DEV)
    S = LM_PROMPT + MESH_LM_STEPS + 1
    n = MESH_LM_STEPS

    def serve(prefill, decode):
        cache, logits = prefill(toks)
        out, lgs = [torch.argmax(logits, -1)], [logits.float()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            cache, logits = decode(cache, out[-1])
            out.append(torch.argmax(logits, -1))
            lgs.append(logits.float())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        return cache, torch.stack(out, 1), torch.stack(lgs, 1), ms

    with torch.inference_mode():
        pre = api.prefill_step(sharded, mesh, LM_BATCH, LM_PROMPT, S)
        step = api.serve_step(sharded, mesh, LM_BATCH, S)
        serve(lambda t: one.prefill(t, S), one.decode_step)      # warm
        serve(pre, step)
        _, tok1, lg1, ms1 = serve(lambda t: one.prefill(t, S),
                                  one.decode_step)
        gk.reset_launch_count()
        col.reset_calls()                    # the mesh path starts
        cache, tok2, lg2, ms2 = serve(pre, step)
        gqa = gk.launch_count()
        calls = dict(col.CALLS)              # ... and ends here
        col.reset_calls()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(cache, tok2[:, -1])
            torch.cuda.synchronize()
        step_calls = dict(col.CALLS)
    step_dev = nccl_device_ms(prof)
    del prof
    # one collective's wall time alone: 200 all-reduces of a decode
    # step's (B, D) bf16 partial sum, fenced once
    part = torch.randn(LM_BATCH, cfg.d_model, device=DEV,
                       dtype=torch.bfloat16)
    with torch.inference_mode():
        col.all_reduce(part, mesh.get_group("model"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            col.all_reduce(part, mesh.get_group("model"))
        torch.cuda.synchronize()
    one_call_ms = (time.perf_counter() - t0) * 1e3 / 200
    dlogit = max_err(lg2, lg1)
    lm_rec = {
        "arch": cfg.name, "n_layers": cfg.n_layers, "batch": LM_BATCH,
        "prompt_len": LM_PROMPT, "decode_steps": n,
        "tokens_identical": bool(torch.equal(tok1, tok2)),
        "max_abs_dlogit": dlogit,
        "ref_max_abs": float(lg1.abs().max()),
        "decode_ms_per_token": {"one_device": ms1, "mesh": ms2},
        "gqa_launches": gqa, "gqa_launches_per_step": gqa / n,
        "collectives_prefill_and_steps": calls,
        "collectives_per_step": step_calls,
        "profiled_step_device": step_dev,
        "all_reduce_wall_ms_per_call": one_call_ms}
    log("[mesh llama] " + json.dumps(lm_rec))
    if not lm_rec["tokens_identical"]:
        raise AssertionError("mesh greedy tokens differ from one device")
    if gqa != n * cfg.n_layers:
        raise AssertionError(f"{gqa} gqa_decode launches on the mesh, want "
                             f"{n * cfg.n_layers}")
    if calls["all_reduce"] == 0:
        raise AssertionError(f"no collective on the mesh path: {calls}")
    rec["llama"] = lm_rec
    del one, sharded, cache, pre, step
    gc.collect()
    torch.cuda.empty_cache()

    # -- rwkv6: the sharded train step in both layout modes
    cfg = dataclasses.replace(api.get_config(TRAIN_ARCH, smoke=TRAIN_SMOKE),
                              n_layers=MESH_TRAIN_LAYERS)
    weights = api.build_model(cfg, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(TRAIN_SEED)).params()
    weights = {k: v.detach().clone() for k, v in weights.items()}
    stream = api.SyntheticLMStream(api.DataConfig(
        vocab=cfg.vocab, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ))

    def train(mode):
        model = api.build_model(cfg, device=DEV).load_params(weights)
        step = api.make_train_step(model) if mode is None else \
            api.make_train_step(model, mesh, layout_mode=mode)
        opt = api.adamw_init(model.params())
        losses = []
        lk.reset_launch_count()
        col.reset_calls()
        for s in range(MESH_TRAIN_STEPS):
            if s == 1:                   # the first step warms the path
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            opt, met = step(opt, stream.batch_at(s))
            losses.append(float(met["loss"]))
        ms = (time.perf_counter() - t0) * 1e3 / (MESH_TRAIN_STEPS - 1)
        out = {"losses": losses, "step_ms_after_the_first": ms,
               "scan_launches": lk.launch_count(),
               "collectives": dict(col.CALLS),
               "collective_bytes": {f"{k}/{d}": b for (k, d), b in
                                    col.BYTES.items()},
               "zero1_leaves": sum(getattr(p, "zero1", None) is not None
                                   for p in model.params().values())}
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        return out

    base = train(None)
    tr = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "steps": MESH_TRAIN_STEPS, "one_device": base}
    for mode in ("coswitch", "fixed"):
        got = train(mode)
        got["max_rel_loss_diff"] = max(
            abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                 base["losses"]))
        tr[mode] = got
        want_scan = 2 * cfg.n_layers * MESH_TRAIN_STEPS
        if got["scan_launches"] != want_scan:
            raise AssertionError(f"{mode}: {got['scan_launches']} "
                                 f"linear_scan launches, want {want_scan}")
        if not got["max_rel_loss_diff"] <= MESH_TRAIN_REL:
            raise AssertionError(f"{mode}: losses {got['losses']} vs one "
                                 f"device {base['losses']}")
        if got["collectives"]["all_reduce"] == 0:
            raise AssertionError(f"{mode}: no collective called")
        if got["zero1_leaves"] == 0:
            raise AssertionError(f"{mode}: no ZeRO-1 block placed")
    # both modes reduce-scatter the gradients onto their ZeRO-1 blocks;
    # coswitch also reduce-scatters the stream (at one rank the data and
    # model groups are one group, so the calls tell them apart)
    if not tr["coswitch"]["collectives"]["reduce_scatter"] > \
            tr["fixed"]["collectives"]["reduce_scatter"]:
        raise AssertionError("coswitch reduce-scattered the stream nowhere")
    log("[mesh rwkv6] " + json.dumps(tr))
    rec["rwkv6"] = tr
    rec["dbrx_ep"] = {k: moe["dbrx_132b"]["ep_mesh"][k] for k in
                      ("max_abs_err", "ref_max_abs", "collectives")}
    return rec


def dry_cells() -> list:
    """Start the dry-run's cells (``DRY_CELLS``), one process each, all at
    once; returns ``(cell, process, out path)``."""
    import os
    out = pathlib.Path(tempfile.mkdtemp(prefix="dryrun-"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape in DRY_CELLS:
        path = out / f"{arch}-{shape}.json"
        procs.append(((arch, shape), subprocess.Popen(
            [sys.executable, "-W", "ignore", "-m",
             "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
             "--accum", str(DRY_ACCUM), "--out", str(path)],
            env=env, cwd=str(ROOT), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True), path))
    return procs


def counted(torch, counter_cls, fn) -> dict:
    """``fn()`` under ``trace_cost.Counter``: its counts."""
    with counter_cls() as c:
        fn()
    return c.counts


def roofline_share(torch, counts, fn) -> dict:
    """The step ``fn()``'s device time (its profiled kernels' sum) against
    the roofline bound of ``counts`` on the H100's data-sheet rates: the
    share must stay at or below 1 / ``ROOF_MIN`` (a larger one means the
    count claims more work than the card did)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import gpu_cost
    terms = gpu_cost.terms_from_counts(counts.flops, counts.bytes, {}, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    _, busy_ms = device_time_by_kernel(prof)
    bound = terms.bound_s * 1e3
    share = bound / busy_ms
    if busy_ms < ROOF_MIN * bound:
        raise AssertionError(f"device {busy_ms:.3f} ms below {ROOF_MIN} x "
                             f"the bound {bound:.3f} ms: the count is wrong")
    return {"device_ms": busy_ms, "bound_ms": bound,
            "bound_by": terms.dominant, "share_of_bound": share,
            "compute_ms": terms.compute_s * 1e3,
            "memory_ms": terms.memory_s * 1e3}


def same_counts(name: str, real, fake) -> None:
    a, b = real.to_dict(), fake.to_dict()
    if a != b:
        diff = {k: (a[k], b[k]) for k in a if a[k] != b[k]}
        raise AssertionError(f"{name}: real and fake counts differ: {diff}")


def phase_analysis(torch, api, gk, record) -> dict:
    """24. The analysis layer on the card: (a) the dry-run cells
    (``DRY_CELLS``) on the fake 16x16 world, each in a subprocess, and
    their roofline rows;
    (b) ``trace_cost.Counter`` on the card's real steps at full width,
    the llama3.2-3b decode step at phase 8's shape and one rwkv6-1.6b
    train step at phase 11's, each counted again on fake CUDA tensors of
    the same shapes (equal, bit for bit) and held against its profiled
    device time (at least ``ROOF_MIN`` x its roofline bound), its peak of
    live bytes beside ``max_memory_allocated`` less the arguments;
    (c) the host cost of ``ops.gqa_decode``, a registered operator, against
    the kernel's binding called directly."""
    import gc

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.trace_cost import Counter
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline
    procs = dry_cells()
    rec = {}

    # (b) llama3.2-3b decode step, B 8, S 1024 (phase 8's cache)
    cfg = api.get_config(LM_ARCH, smoke=LM_SMOKE)
    S = LM_PROMPT + LM_GEN

    def decode_setup(model):
        cache = model.init_cache(LM_BATCH, S)
        cache["length"].fill_(LM_PROMPT)
        toks = torch.zeros(LM_BATCH, dtype=torch.int32, device=DEV)
        return cache, toks

    model = api.build_model(cfg, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(LM_SEED))
    cache, toks = decode_setup(model)
    with torch.inference_mode():
        model.decode_step(cache, toks)                     # warm
        torch.cuda.synchronize()
        args = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        real = counted(torch, Counter,
                       lambda: model.decode_step(cache, toks))
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - args
        roof = roofline_share(torch, real,
                              lambda: model.decode_step(cache, toks))
    with FakeTensorMode(), torch.inference_mode():
        fmodel = api.build_model(cfg, device=DEV)
        fcache, ftoks = decode_setup(fmodel)
        fmodel.decode_step(fcache, ftoks)
        fake = counted(torch, Counter,
                       lambda: fmodel.decode_step(fcache, ftoks))
    same_counts("llama decode", real, fake)
    rec["llama_decode"] = {
        "batch": LM_BATCH, "cache": S, "counts": real.to_dict(), **roof,
        "peak_live_bytes": real.peak_live_bytes,
        "max_allocated_less_arguments": extra}
    log("[analysis] llama decode step " + json.dumps(rec["llama_decode"]))
    del model, cache, fmodel, fcache
    gc.collect()
    torch.cuda.empty_cache()

    # (b) rwkv6-1.6b train step, 8 x 1024, 24 layers (phase 11's)
    cfg = api.get_config(TRAIN_ARCH, smoke=TRAIN_SMOKE)

    def train_setup(model):
        step = api.make_train_step(model)
        opt = api.adamw_init(model.params())
        toks = torch.zeros((TRAIN_BATCH, TRAIN_SEQ + 1), dtype=torch.int32,
                           device=DEV)
        return step, opt, {"tokens": toks}

    model = api.build_model(cfg, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(TRAIN_SEED))
    step, opt, batch = train_setup(model)
    step(opt, batch)                                       # warm
    torch.cuda.synchronize()
    args = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    real = counted(torch, Counter, lambda: step(opt, batch))
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - args
    roof = roofline_share(torch, real, lambda: step(opt, batch))
    del model, step, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with FakeTensorMode():
        fmodel = api.build_model(cfg, device=DEV)
        fstep, fopt, fbatch = train_setup(fmodel)
        fstep(fopt, fbatch)
        fake = counted(torch, Counter, lambda: fstep(fopt, fbatch))
    fake_s = time.perf_counter() - t0
    same_counts("rwkv6 train", real, fake)
    rec["rwkv6_train"] = {
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "counts": real.to_dict(),
        **roof, "peak_live_bytes": real.peak_live_bytes,
        "max_allocated_less_arguments": extra, "fake_trace_s": fake_s}
    log("[analysis] rwkv6 train step " + json.dumps(rec["rwkv6_train"]))
    del fmodel, fstep, fopt
    gc.collect()

    # (c) the host cost of the registered operator, at phase 8's shape
    lcfg = api.get_config(LM_ARCH, smoke=LM_SMOKE)
    gen = torch.Generator(device=DEV).manual_seed(24)
    q = torch.randn(LM_BATCH, lcfg.n_heads, lcfg.head_dim, generator=gen,
                    device=DEV).bfloat16()
    kv = torch.randn(LM_BATCH, S, lcfg.n_kv_heads, lcfg.head_dim,
                     generator=gen, device=DEV).bfloat16()
    lens = torch.full((LM_BATCH,), LM_PROMPT, dtype=torch.int32, device=DEV)

    def issue_us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(GQA_HOST_CALLS):
            fn()
        us = (time.perf_counter() - t) * 1e6 / GQA_HOST_CALLS
        torch.cuda.synchronize()
        return us

    times = {"ops": [], "binding": []}
    for _ in range(2):
        times["ops"].append(issue_us(lambda: ops.gqa_decode(q, kv, kv,
                                                            lens)))
        times["binding"].append(issue_us(
            lambda: gk.gqa_decode_cuda(q, kv, kv, lens)))
    added = min(times["ops"]) - min(times["binding"])
    decode_ms = record["lm_serve"]["decode_ms_per_token"]["p50"]
    rec["gqa_host"] = {
        "us_per_call": times, "added_us": added,
        "calls_per_decode_step": lcfg.n_layers,
        "decode_ms_per_token_p50": decode_ms,
        "added_share_of_decode": added * lcfg.n_layers / 1e3 / decode_ms}
    log("[analysis] gqa host cost " + json.dumps(rec["gqa_host"]))

    # (a) the dry-run's cells
    rec["dryrun"] = {}
    for (arch, shape), proc, path in procs:
        try:
            _, err = proc.communicate(timeout=DRY_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"dry-run {arch} {shape}: over "
                                 f"{DRY_TIMEOUT_S} s")
        if proc.returncode != 0:
            raise AssertionError(f"dry-run {arch} {shape} failed: "
                                 f"{err[-2000:]}")
        cell = json.loads(path.read_text())
        keep = {k: cell[k] for k in (
            "mesh", "accum", "trace_s", "per_device", "flops_per_device",
            "flops_by_unit", "bytes_per_device",
            "collective_bytes_per_device", "collective_kinds", "kernels",
            "roofline", "n_params", "n_params_active")}
        keep["roofline_row"] = roofline.row(cell)
        rec["dryrun"][f"{arch}/{shape}"] = keep
        log(f"[analysis] dry-run {arch} {shape} " + json.dumps(keep))
        log(f"[analysis] roofline row {arch} {shape} "
            + json.dumps(keep["roofline_row"]))
    shutil.rmtree(procs[0][2].parent)
    return rec


def phase_split(torch, api, ops, ref, gk) -> dict:
    """25. Attention over the model ranks where the heads do not divide
    them, on one device: (i) ``gqa_decode_partial`` against its plain
    version and timed at llama's decode shape; (ii) llama3.2-3b's
    ``decode_32k`` attention as ``SPLIT_RANKS`` sequence blocks merged by
    log-sum-exp against one whole call; (iii) ``chunked_attention``'s
    query blocks at their offsets against the whole call at ``train_4k``
    width, f32."""
    from repro_torch.core import gpu_cost
    from repro_torch.models import blocks
    from repro_torch.models.common import chunked_attention, merge_partials
    gen = torch.Generator(device="cpu").manual_seed(250)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    rec = {"cases": {}}

    # (i) out, m and l against the plain version
    for label, (hq, hkv, d, S) in SPLIT_SHAPES.items():
        lens = torch.tensor([0, 1, S // 3, 256, 257, S // 2, S - 1, S],
                            dtype=torch.int32).clamp(max=S).to(DEV)
        for dt, tdt in dts.items():
            q = torch.randn(8, hq, d, generator=gen).to(DEV, tdt)
            k = torch.randn(8, S, hkv, d, generator=gen).to(DEV, tdt)
            v = torch.randn(8, S, hkv, d, generator=gen).to(DEV, tdt)
            out, m, l = ops.gqa_decode_partial(q, k, v, lens)
            w_out, w_m, w_l = ref.gqa_decode_partial(q, k, v, lens)
            name = f"partial {label} {dt}"
            if not (torch.equal(out[0].float(), torch.zeros_like(
                    out[0].float())) and torch.all(m[0] == float("-inf"))
                    and torch.all(l[0] == 0)):
                raise AssertionError(f"{name}: a row of length 0 is not "
                                     f"(0, -inf, 0)")
            rec["cases"][name] = {
                "out": check_close(name + " out", out, w_out, GQA_TOL[dt],
                                   GQA_TOL[dt]),
                "m": check_close(name + " m", m[1:], w_m[1:],
                                 SPLIT_ML_TOL["m"], SPLIT_ML_TOL["m"]),
                "l": check_close(name + " l", l[1:], w_l[1:],
                                 SPLIT_ML_TOL["l"], SPLIT_ML_TOL["m"])}
    log("[split] partial vs plain " + json.dumps(rec["cases"]))

    # (i) timed at llama's decode shape, one cache a layer, beside the
    # kernel without (m, l)
    cfg = api.get_config(LM_ARCH, smoke=LM_SMOKE)
    B, S = LM_BATCH, LM_PROMPT + LM_GEN
    Hq, Hkv, D, n = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    q = torch.randn(B, Hq, D, generator=gen).to(DEV, torch.bfloat16)
    ks = [torch.randn(B, S, Hkv, D, generator=gen).to(DEV, torch.bfloat16)
          for _ in range(n)]
    vs = [torch.randn(B, S, Hkv, D, generator=gen).to(DEV, torch.bfloat16)
          for _ in range(n)]
    lens = torch.randint(LM_PROMPT, S, (B,), dtype=torch.int32,
                         generator=gen).to(DEV)
    part = cycling(lambda i: ops.gqa_decode_partial(q, ks[i], vs[i], lens),
                   n)
    whole = cycling(lambda i: ops.gqa_decode(q, ks[i], vs[i], lens), n)
    plain = cycling(lambda i: ref.gqa_decode_partial(q, ks[i], vs[i], lens),
                    n)
    got = ops.gqa_decode_partial(q, ks[0], vs[0], lens)
    err = check_close("partial llama shape",
                      got[0], ref.gqa_decode_partial(q, ks[0], vs[0],
                                                     lens)[0],
                      GQA_TOL["bf16"], GQA_TOL["bf16"])
    times = {}
    for name, fn in (("partial", part), ("gqa_decode", whole),
                     ("partial", part), ("gqa_decode", whole)):
        ms, _ = kernel_ms(fn, [gk.KERNEL], iters=4 * n, warmup=n)
        times.setdefault(name, []).append(ms)
    plain_ms, _ = kernel_ms(plain, None, iters=2 * n, warmup=2)
    w = gk.work(B, Hq, Hkv, D, int(lens.sum()), 2, ml=True)
    rec["llama_times"] = {
        "B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "S": S, "caches": n,
        "max_abs_err": err, "ms": min(times["partial"]),
        "ms_runs": times["partial"],
        "gqa_decode_ms": min(times["gqa_decode"]),
        "gqa_decode_ms_runs": times["gqa_decode"], "plain_ms": plain_ms,
        **gpu_cost.bound_ms(w), "mbytes": w.bytes / 1e6}
    log("[split] partial timed at llama's decode shape "
        + json.dumps(rec["llama_times"]))
    del ks, vs
    torch.cuda.empty_cache()

    # (ii) decode_32k at full width: 16 sequence blocks, merged
    m_, Sd = SPLIT_RANKS, SPLIT_DECODE_S
    Sb = Sd // m_
    q = torch.randn(B, Hq, D, generator=gen).to(DEV, torch.bfloat16)
    kb = [torch.randn(B, Sb, Hkv, D, generator=gen).to(DEV, torch.bfloat16)
          for _ in range(m_)]
    vb = [torch.randn(B, Sb, Hkv, D, generator=gen).to(DEV, torch.bfloat16)
          for _ in range(m_)]
    lens = torch.tensor([1, Sb - 1, Sb, Sb + 1, Sd // 2, Sd - 1000, Sd - 1,
                         Sd], dtype=torch.int32)[:B].to(DEV)

    def split():
        parts = [blocks.seq_block_partial(q, kb[r], vb[r], lens, r)
                 for r in range(m_)]
        return merge_partials(*(torch.stack(t) for t in zip(*parts))
                              ).to(q.dtype)

    gk.reset_launch_count()                        # the split path starts
    got = split()
    launches = gk.partial_launch_count()           # ... and ends here
    if launches != m_ or gk.launch_count():
        raise AssertionError(f"split decode: {launches} partial and "
                             f"{gk.launch_count()} whole launches, want "
                             f"{m_} and 0")
    kw, vw = torch.cat(kb, dim=1), torch.cat(vb, dim=1)
    want = ops.gqa_decode(q, kw, vw, lens)
    err = check_close("split decode_32k vs one call", got, want,
                      GQA_TOL["bf16"], GQA_TOL["bf16"])
    plain_err = check_close("split decode_32k vs plain", got,
                            ref.gqa_decode(q, kw, vw, lens),
                            GQA_TOL["bf16"], GQA_TOL["bf16"])
    whole_ms, _ = kernel_ms(lambda: ops.gqa_decode(q, kw, vw, lens),
                            [gk.KERNEL], iters=40, warmup=4)
    split_ms, split_seen = kernel_ms(split, None, iters=40, warmup=4)
    wb = gk.work(B, Hq, Hkv, D, int(lens.sum()), 2)
    rec["decode_32k"] = {
        "B": B, "S": Sd, "blocks": m_, "lengths": lens.tolist(),
        "kv_gbytes": 2 * B * Sd * Hkv * D * 2 / 1e9, "launches": launches,
        "max_abs_err": err, "plain_max_abs_err": plain_err,
        "split_ms": split_ms, "split_kernels": split_seen,
        "split_event_ms": cuda_ms(split, iters=10, warmup=2),
        "whole_ms": whole_ms,
        "whole_event_ms": cuda_ms(lambda: ops.gqa_decode(q, kw, vw, lens),
                                  iters=10, warmup=2),
        "whole_bound_ms": gpu_cost.bound_ms(wb)["bound_ms"]}
    log("[split] decode_32k in 16 blocks " + json.dumps(rec["decode_32k"]))
    del kb, vb, kw, vw
    torch.cuda.empty_cache()

    # (iii) train_4k width: the query blocks at their offsets, f32
    T, blk = SPLIT_TRAIN_T, SPLIT_TRAIN_T // m_
    q = torch.randn(1, T, Hq, D, generator=gen).to(DEV)
    k = torch.randn(1, T, Hkv, D, generator=gen).to(DEV)
    v = torch.randn(1, T, Hkv, D, generator=gen).to(DEV)
    whole = chunked_attention(q, k, v)
    worst = 0.0
    for r in range(m_):
        lo, hi = r * blk, (r + 1) * blk
        got = chunked_attention(q[:, lo:hi], k[:, :hi], v[:, :hi],
                                q_offset=lo)
        worst = max(worst, check_close(f"query block {r}", got,
                                       whole[:, lo:hi], TOL["f32"],
                                       TOL["f32"]))
    last = (m_ - 1) * blk
    rec["train_4k"] = {
        "T": T, "blocks": m_, "max_abs_err": worst,
        "whole_ms": cuda_ms(lambda: chunked_attention(q, k, v), iters=3,
                            warmup=1),
        "last_block_ms": cuda_ms(lambda: chunked_attention(
            q[:, last:], k, v, q_offset=last), iters=3, warmup=1),
        "first_block_ms": cuda_ms(lambda: chunked_attention(
            q[:, :blk], k[:, :blk], v[:, :blk], q_offset=0), iters=3,
            warmup=1)}
    log("[split] train_4k query blocks " + json.dumps(rec["train_4k"]))
    del q, k, v, whole
    torch.cuda.empty_cache()
    rec["mesh_route"] = split_mesh_route(torch, api, gk)
    return rec


def split_mesh_route(torch, api, gk) -> dict:
    """Phase 25 (iv): llama3.2-3b on the one-rank NCCL mesh, its K/V cache
    placed split by sequence over the model axis (``cache_shardings`` as it
    places KV heads that do not divide the axis; at one rank the local
    shape is the whole cache) and its attention routed as such heads
    (``TensorParallel(attn_sharded=False)``): ``prefill_step`` then
    ``SPLIT_MESH_STEPS`` greedy ``serve_step``s against the one-device
    model's prefill and decode on the same weights."""
    import gc

    import numpy as np

    from repro_torch.distributed import stepfn
    from repro_torch.models.common import TensorParallel
    mesh = api.make_local_mesh(1, DEV)
    cfg = api.get_config(LM_ARCH, smoke=LM_SMOKE)
    one = api.build_model(cfg, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(LM_SEED))
    model = api.build_model(cfg, device=DEV).load_params(one.params())
    toks = torch.from_numpy(np.random.default_rng(25).integers(
        0, cfg.vocab, size=(LM_BATCH, LM_PROMPT))).to(DEV)
    n = SPLIT_MESH_STEPS
    S = LM_PROMPT + n + 1
    placed = stepfn.cache_shardings

    def seq_split(mesh_, specs):
        out = placed(mesh_, specs)
        for name in ("k", "v"):
            spec = list(out["layers"][name])
            spec[2], spec[3] = "model", None          # (L, B, S, Hkv, dh)
            out["layers"][name] = tuple(spec)
        return out

    def serve(prefill, decode):
        cache, logits = prefill(toks)
        out, lgs = [torch.argmax(logits, -1)], [logits.float()]
        for _ in range(n):
            cache, logits = decode(cache, out[-1])
            out.append(torch.argmax(logits, -1))
            lgs.append(logits.float())
        return torch.stack(out, 1), torch.stack(lgs, 1)

    stepfn.cache_shardings = seq_split
    try:
        with torch.inference_mode():
            pre = api.prefill_step(model, mesh, LM_BATCH, LM_PROMPT, S)
            step = api.serve_step(model, mesh, LM_BATCH, S)
            model.tp = TensorParallel(model.tp.group, 1, 0,
                                      attn_sharded=False,
                                      split=model.tp.split)
            tok1, lg1 = serve(lambda t: one.prefill(t, S), one.decode_step)
            gk.reset_launch_count()                # the split route starts
            tok2, lg2 = serve(pre, step)
            launches = gk.partial_launch_count()   # ... and ends here
            whole = gk.launch_count()
            split = dict(model.kv_split)
    finally:
        stepfn.cache_shardings = placed
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": LM_BATCH,
           "prompt_len": LM_PROMPT, "decode_steps": n, "kv_split": split,
           "tokens_identical": bool(torch.equal(tok1, tok2)),
           "max_abs_dlogit": max_err(lg2, lg1),
           "ref_max_abs": float(lg1.abs().max()),
           "partial_launches": launches, "gqa_decode_launches": whole}
    log("[split] mesh route " + json.dumps(rec))
    del one, model, pre, step
    gc.collect()
    torch.cuda.empty_cache()
    if not split.get("k"):
        raise AssertionError(f"the cache was not placed split: {split}")
    if not rec["tokens_identical"]:
        raise AssertionError("split route's greedy tokens differ from one "
                             "device")
    if rec["max_abs_dlogit"] > GQA_TOL["bf16"] * rec["ref_max_abs"]:
        raise AssertionError(f"split route's logits {rec['max_abs_dlogit']}"
                             f" from one device's")
    if launches != n * cfg.n_layers or whole:
        raise AssertionError(f"{launches} gqa_decode_partial and {whole} "
                             f"gqa_decode launches, want "
                             f"{n * cfg.n_layers} and 0")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--out", default=None,
                    help="also write every measurement as JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke runs on "
              "an NVIDIA card only", file=sys.stderr)
        return 1
    from repro_torch import api, obs
    from repro_torch.kernels import birrd_reduce as bk
    from repro_torch.kernels import gqa_decode as gk
    from repro_torch.kernels import linear_scan as lk
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rir_matmul as rk

    t_start = time.perf_counter()
    phase_s = {}

    def run(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        phase_s[name] = time.perf_counter() - t0
        log(f"[time] {name}: {phase_s[name]:.1f} s")
        return out

    record = {"build": run("build", phase_build, rk, gk, lk, bk)}
    cache, nets = run("plan", phase_plan, api)
    record["sweep_worst_f32_err"] = run("kernel_sweep", phase_kernel_sweep,
                                        torch, ops, ref)
    record["resnet50_steps"] = run("kernel_resnet", phase_kernel_resnet,
                                   torch, api, ops, ref, rk, nets)
    record["networks"] = run("networks", phase_networks, torch, api, rk,
                             obs, nets)
    record["serve"] = run("serve", phase_serve, torch, api, rk, obs, cache,
                          nets)
    record["profile"] = run("profile", phase_profile, torch, api, obs,
                            cache, nets)
    record["gqa_sweep"] = run("gqa_sweep", phase_gqa_sweep, torch, ops, ref)
    record["gqa_llama"] = run("gqa_llama", phase_gqa_llama, torch, api, ops,
                              ref, gk)
    record["lm_serve"] = run("lm_serve", phase_lm_serve, torch, api, gk, obs)
    record["lm_f32"] = run("lm_f32", phase_lm_f32, torch, api, gk)
    record["scan_sweep"] = run("scan_sweep", phase_scan_sweep, torch, ops,
                               ref, lk)
    record["train"] = run("train", phase_train, torch, api, lk, obs)
    record["train_f32"] = run("train_f32", phase_train_f32, torch, api, lk)
    record["ssm_serve"] = run("ssm_serve", phase_ssm_serve, torch, api, lk,
                              obs)
    record["ssm_f32"] = run("ssm_f32", phase_ssm_f32, torch, api, lk)
    record["birrd"] = run("birrd", phase_birrd, torch, ops, ref, bk)
    record["coswitch"] = run("coswitch", phase_coswitch, torch, rk, bk)
    record["zamba_serve"] = run("zamba_serve", phase_zamba_serve, torch,
                                api, ops, ref, gk, lk, obs)
    record["zamba_f32"] = run("zamba_f32", phase_zamba_f32, torch, api, gk,
                              lk)
    record["serve_cli"] = run("serve_cli", phase_serve_cli, torch, api, rk,
                              gk, obs)
    record["smokes"] = run("smokes", phase_smokes, torch, api, rk, obs, nets)
    record["chaos"] = run("chaos", phase_chaos, torch, api, rk, gk, obs)
    record["resume"] = run("resume", phase_resume, torch, api, lk,
                           obs)
    record["gqa_new"] = run("gqa_new", phase_gqa_new, torch, api, ops, ref,
                            gk)
    record["whisper_serve"] = run("whisper_serve", phase_whisper_serve,
                                  torch, api, gk, obs)
    record["whisper_f32"] = run("whisper_f32", phase_whisper_f32, torch,
                                api, gk)
    record["moe"] = run("moe", phase_moe, torch, api, ops, ref, gk)
    record["mesh"] = run("mesh", phase_mesh, torch, api, gk, lk,
                         record["moe"])
    record["analysis"] = run("analysis", phase_analysis, torch, api, gk,
                             record)
    record["split"] = run("split", phase_split, torch, api, ops, ref, gk)
    record["seconds"] = time.perf_counter() - t_start
    record["phase_seconds"] = phase_s
    tot = record["resnet50_steps"]["total"]
    gq = record["gqa_llama"]
    sc = record["scan_sweep"]["train_shape"]
    bd = record["birrd"]
    sp = record["split"]["llama_times"]
    kernels = {"kernels": [{
        "name": "rir_matmul", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES,
        "launches": record["serve"]["batched"]["launches"],
        "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
        "event_ms": tot["event_ms"],
        "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": tot["bound_by"], "library_ms": tot["library_ms"]}, {
        "name": "gqa_decode", "route": "cuda", "source": GQA_SOURCE,
        "replaces": GQA_REPLACES,
        "launches": record["lm_serve"]["gqa_launches"],
        "mesh_launches": record["mesh"]["llama"]["gqa_launches"],
        "max_abs_err": gq["max_abs_err"], "ms": gq["ms"],
        "plain_ms": gq["plain_ms"], "bound_ms": gq["bound_ms"],
        "bound_by": gq["bound_by"], "library_ms": gq["library_ms"]}, {
        "name": "linear_scan", "route": "cuda", "source": SCAN_SOURCE,
        "replaces": SCAN_REPLACES,
        "launches": record["train"]["scan_launches"],
        "mesh_launches": record["mesh"]["rwkv6"]["coswitch"]["scan_launches"],
        "max_abs_err": sc["max_abs_err"], "ms": sc["ms"],
        "plain_ms": sc["plain_ms"], "bound_ms": sc["bound_ms"],
        "bound_by": sc["bound_by"], "library_ms": None}, {
        "name": "birrd_apply", "route": "cuda", "source": BIRRD_SOURCE,
        "replaces": BIRRD_REPLACES,
        "launches": record["coswitch"]["birrd_launches"],
        "max_abs_err": bd["max_abs_err"], "ms": bd["ms"],
        "dense_ms": bd["dense_ms"],
        "plain_ms": bd["plain_ms"], "bound_ms": bd["bound_ms"],
        "bound_by": bd["bound_by"], "library_ms": bd["library_ms"]}, {
        "name": "gqa_decode_partial", "route": "cuda", "source": GQA_SOURCE,
        "replaces": GQA_REPLACES,
        "launches": record["split"]["mesh_route"]["partial_launches"],
        "block_launches": record["split"]["decode_32k"]["launches"],
        "max_abs_err": sp["max_abs_err"], "ms": sp["ms"],
        "plain_ms": sp["plain_ms"], "bound_ms": sp["bound_ms"],
        "bound_by": sp["bound_by"], "library_ms": None}]}
    record["kernels"] = kernels["kernels"]
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(record, indent=1))
    log(f"[done] {record['seconds']:.1f} s")
    print(card_line())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
