#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/kernels/``, holds each kernel against its plain PyTorch version on
the card, times both, and drives the port's two main paths on the card,
each with the launch counts set to 0 just before it and read just after:

* the paper's quickstart loop (edge generator → WAN topic → cloud k-means
  processor → parameter service), checked against the plain path on the
  same messages;
* serving hymba-1.5b at full width (random fp32 weights from a seed, bf16
  cache) through ``BatchServer``: two waves of 4 requests, 1,024- and
  4,096-token prompts, 32 new tokens each, through the flash-attention and
  SSD kernels; then the same waves through the same server with
  ``impl="dense"`` (no kernel), which must agree.

Then the paper's other two workloads and its full scenario, on the card:
``placement="advise"`` for k-means and the auto-encoder; the auto-encoder
and the isolation forest (100 trees, refit per message) in the quickstart's
closed loop, each held against the same processor on the host; and
``repro_torch.examples.edge_to_cloud_outlier`` (advise, paced k-means
through the kernel with an injected fault, hot-swap to the auto-encoder,
autoscaling).  These paths launch no kernel of their own beyond k-means.
The three models run through their compiled functions
(``repro_torch.graphs.GraphFn``: one CUDA graph a key, the k-means kernel
inside its graphs, the forest's generator seeded again before every
replay): each loop (``pipeline``, ``ae_pipeline``, ``iforest_pipeline``)
runs op by op and then through the graphs, with msgs/s, the profiler's
device ms, kernels and host launches a message, captures and their ms,
and the memory the graphs hold; ``kmeans_vs_eager``, ``ae_vs_eager`` and
``iforest_vs_eager`` hold 8 seeded messages through the graphs against
the eager functions on the card, bit for bit.

Last, training: internlm2-1.8b at full width and depth (24 layers, 1.89 B
fp32 parameters, AdamW, remat, dense attention) for 8 steps of 4 × 1,024
tokens through ``launch.train.train_loop``, whose step is
``train.step.make_train_fn``'s CUDA graph (params and optimizer state
updated in place inside it), beside the same 8 steps of its eager step,
bit for bit: step time, data time, peak memory, launches or kernel
nodes, capture time and device time a step against the fp32 bound; the
same step through the graph on the card and eagerly on the host (2
layers); a checkpointed resume of mamba2-130m through the graph against
a straight run; and the int8-compressed step on a one-rank NCCL group,
a reduced check and then internlm2-1.8b at full width, 4 × 1,024
tokens, eagerly and through ``make_compressed_train_fn``'s CUDA graph
(the NCCL collectives inside it), bit for bit, the error buffers too.
Training launches no hand-written kernel: the reference trains with
``impl="dense"`` and its Pallas kernels have no gradient.

Then the launch stack: the GPipe step (``train.pipeline``) with both of
its 2 stages (12 layers each) in one process, internlm2-1.8b at full
width and depth, 4 microbatches of 1 × 1,024 tokens, eagerly (its first
two steps against two plain steps from the same seed on the same
batches) and through ``make_pp_train_fn``'s CUDA graph, bit for bit with
the eager run, each with step and device time, idle share, launches or
kernel nodes and peak memory; and the sharding
rules on a one-rank NCCL mesh (1, 1): internlm2-1.8b's parameters
restored onto their ``param_pspecs`` placements, its forward under the
mesh's rules against ``rules=None``, qwen3-moe (1 layer, full width) with
4 MoE dispatch groups card against host, and every arch's per-rank bytes
on the two production meshes (a fake process group).  Neither launches a
hand-written kernel (the reference's pipeline runs ``impl="dense"``).

Then the dry-run (``launch.dryrun``): internlm2-1.8b × train_4k and ×
decode_32k on both production meshes and hymba-1.5b × long_500k lowered
on the host (meta DTensors over fake process groups, counted by
``roofline.counter``), and internlm2-1.8b's dry-run train step (bf16,
4 × 4,096 tokens) and a decode step over a 32,768-slot bf16 cache counted
on the card and on meta tensors, their device time against the counted
bound, each timed eagerly and through its CUDA graph (``make_train_fn``,
``make_decode_fn``).  No hand-written kernel runs there (dense
attention).

Then the rest of the zoo, each phase with the flash launch count set to 0
just before it and read just after: minicpm3-4b (MLA) at full width and
depth served in 2 waves of 4 requests (1,024 and 2,048 tokens, no flash
launch: its attention is dense, as in the reference), its absorbed decode
held against ``forward``, and its 2-layer cut card against host;
qwen2-vl-2b at full width and depth on patch embeddings with M-RoPE
positions (a 16 × 16 image grid and 768 text positions, 4 sequences, 16
decode steps) against its dense path; qwen3-moe-235b-a22b at full width
with 4 of its 94 layers served in 2 waves (512 and 1,024 tokens) against
its dense path, and one of its MoE layers against an every-expert form.

Last, the five archs no earlier phase serves (``ZOO_SERVE``), smallest
first, each at full width with random fp32 weights from the seed through
``BatchServer`` (bf16 cache, 2 waves of 4 requests, 16 new tokens each)
with the flash and SSD launch counts set to 0 just before the timed waves
and read just after, then against its dense path; each one's weights are
freed before the next: mamba2-130m at full depth (1,024- and 4,096-token
waves through the SSD kernel, d_state 128), musicgen-medium at full depth
(MHA over 4 codebooks), mistral-nemo-12b at full depth (GQA 32/8),
nemotron-4-340b with 1 of its 96 layers (96/8 at D 192) and arctic-480b
with 1 of its 35 (56/8, 128 experts top-2 beside a dense FFN).  The
calibrator's phase also runs the drift tool
(``repro_torch.tools.calibration_drift``) for k-means on the card.

Every phase that serves (``serve``, ``lm_example``, ``serve_mla``,
``vlm_mrope``, ``serve_moe`` and the five) prefills through
``serve.make_prefill_fn``'s CUDA graph, one a (batch, prompt) shape with
the flash and SSD kernels inside it, and decodes through
``serve.make_decode_fn``'s, one a batch shape.  It holds every prefill
against the eager ``prefill_with_cache`` on the same inputs
(:class:`CheckedPrefill`: last-position logits and the whole cache) and
every step against the eager ``decode_step`` on a copy of the same cache
at the decode function's ``impl`` (:class:`CheckedDecode`; the servers'
``"kernel"`` runs the decode attention kernel in every GQA and hybrid
layer), bit for bit, or within 1e-5 of their scale,
tokens equal.  It reports each wave's eager and graph ms, the captures'
ms and the graphs' nodes beside the eager prefill's op count on the host
(:func:`prefill_ops`), and the kernel launches of each wave's replay and
of each capture's eager warm-up (the checks' own launches left out).
For hymba-1.5b and mamba2-130m, ``torch.profiler`` traces 3 eager
prefills and 3 graph replays of the 1,024-token wave (``prefill_trace``)
and 8 eager and 8 graph decode steps (``decode_trace``): idle share,
kernels a prefill or a step.

Each phase prints one JSON line; the card's ``nvidia-smi`` name and power
limit, then a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
line come last.  Any failure raises and
exits non-zero before the last line; so does a host without a CUDA card
or a directory without the package beside this script.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12,      # CUDA-core fp32: the kernel's FMAs
              "bf16": 989e12,     # bf16 products with fp32 sums (tensor cores)
              "int8": 67e12}      # per-feature scales: products run in fp32
ELEM_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}
PRECISIONS = ("fp32", "bf16", "int8")
# (n, f, k): the paper's largest message, the kernel's headline shape,
# the quickstart's, geo example's and calibrator's message, a ragged tile
# with tiny widths, the reference's widest test case, F and K across the
# kernel's 32-padding, and a million rows of 7 features (no row on a
# 16-byte boundary but every eighth)
CHECK_SHAPES = [(10_000, 32, 25), (1_000_000, 32, 25), (2_500, 32, 25),
                (257, 7, 3), (513, 128, 128), (10_000, 33, 33),
                (1_000_000, 7, 3)]
# and x[1:] of these: a start address off the 16-byte grid
CHECK_MISALIGNED = [(1_001, 7, 3)]
TIMED_SHAPES = [(10_000, 32, 25), (1_000_000, 32, 25)]
MAIN_SHAPE = (10_000, 32, 25)     # what one quickstart message gives
# near-tie and distance tolerance, per row: 1e-5 of the expansion's
# largest terms (‖x‖² + max‖c‖²), about 170 fp32 ulps of them
D2_RTOL = 1e-5
N_MESSAGES = 64
SEED = 0
# the auto-encoder's and the isolation forest's closed loops
AE_MESSAGES = 64
IFOREST_MESSAGES = 16
LOOP_TIMEOUT_S = 120.0    # a cloud loop that fails its tasks ends here

# flash attention: (b, sq, sk, h, hkv, d, causal, window).  The reference's
# cases (tests/test_kernels.py:25-34), hymba-1.5b's two prefill waves,
# internlm2-1.8b's heads at 4,096 tokens, a head_dim of 192, the LM
# example's prefill (internlm2-100m: 12 heads on 4 KV heads, 32 tokens,
# batch 4); then the edges
# of the two designs' tiles: Sq != Sk without the causal mask (k padding),
# fully masked rows (window 1, Sq 8 > Sk 4: rows 4 and up give 0), a
# sequence that no tile size divides, and a head_dim of 256.
FLASH_CASES = [
    (1, 100, 300, 2, 1, 64, False, None),
    (2, 300, 77, 4, 2, 128, False, None),
    (1, 8, 4, 2, 2, 16, False, 1),
    (1, 333, 333, 4, 2, 64, True, None),
    (1, 256, 256, 2, 1, 256, True, None),
    (1, 128, 128, 2, 2, 64, True, None),
    (2, 256, 256, 4, 2, 64, True, None),
    (1, 384, 384, 8, 1, 32, True, None),
    (1, 128, 128, 4, 4, 128, False, None),
    (2, 200, 200, 2, 2, 64, True, 64),
    (1, 512, 512, 2, 1, 64, True, 128),
    (1, 96, 96, 2, 2, 16, True, None),
    (4, 1024, 1024, 25, 5, 64, True, 2048),
    (4, 4096, 4096, 25, 5, 64, True, 2048),
    (1, 4096, 4096, 16, 8, 128, True, None),
    (1, 1024, 1024, 16, 2, 192, True, None),
    (4, 32, 32, 12, 4, 64, True, None),
    (4, 1024, 1024, 12, 2, 128, True, None),
    (4, 512, 512, 64, 4, 128, True, None),
    (4, 1024, 1024, 64, 4, 128, True, None),
    (4, 2048, 2048, 24, 24, 64, True, None),
    (4, 2048, 2048, 32, 8, 128, True, None),
    (4, 1024, 1024, 96, 8, 192, True, None),
    (4, 1024, 1024, 56, 8, 128, True, None),
]
FLASH_MAIN = [(4, 1024, 1024, 25, 5, 64, True, 2048),
              (4, 4096, 4096, 25, 5, 64, True, 2048)]
# the zoo's prefills through the flash kernel: qwen2-vl-2b (12 heads on 2,
# GQA ratio 6) and qwen3-moe's 1,024-token wave (64 on 4, ratio 16); then
# the widest waves of the ZOO_SERVE phases: musicgen-medium (MHA 24/24,
# D 64), mistral-nemo-12b (32 on 8, D 128), nemotron-4-340b (96 on 8, a
# group of 12, D 192) and arctic-480b (56 on 8, a group of 7, D 128)
FLASH_ZOO = [(4, 1024, 1024, 12, 2, 128, True, None),
             (4, 1024, 1024, 64, 4, 128, True, None),
             (4, 2048, 2048, 24, 24, 64, True, None),
             (4, 2048, 2048, 32, 8, 128, True, None),
             (4, 1024, 1024, 96, 8, 192, True, None),
             (4, 1024, 1024, 56, 8, 128, True, None)]
# SSD: (b, s, nh, hd, g, ds, chunk).  The reference's cases
# (tests/test_kernels.py:99-106), hymba-1.5b's widest wave, mamba2-130m's
# widths, and a ragged chunk of 200; then the edges of the kernel's tiles:
# ds 4 and 256, hd 30 (rows staged element by element) and 256, 4 B/C
# groups of 8 heads, and hymba's widths at 1,024 tokens; last,
# mamba2-130m's widest serving wave and granite-4.0-h-small's (32 × 256
# tokens, 128 heads of 64, d_state 128).
SSD_CASES = [
    (1, 64, 2, 16, 1, 16, 16),
    (2, 128, 4, 32, 1, 16, 32),
    (1, 256, 8, 64, 2, 32, 64),
    (1, 256, 24, 64, 1, 128, 64),
    (2, 128, 4, 32, 4, 16, 128),
    (4, 4096, 50, 64, 1, 16, 256),
    (2, 4096, 24, 64, 1, 128, 256),
    (2, 400, 4, 64, 1, 16, 200),
    (1, 256, 4, 32, 1, 4, 128),
    (1, 512, 2, 64, 1, 256, 256),
    (1, 256, 2, 256, 1, 256, 256),
    (1, 400, 4, 30, 2, 4, 200),
    (1, 256, 8, 32, 4, 16, 64),
    (2, 1024, 50, 64, 1, 16, 256),
    (4, 4096, 24, 64, 1, 128, 256),
    (32, 256, 128, 64, 1, 128, 256),
]
SSD_MAIN = [(4, 1024, 50, 64, 1, 16, 256), (4, 4096, 50, 64, 1, 16, 256)]
# mamba2-130m served at full depth: its 4,096-token wave, d_state 128
SSD_ZOO = [(4, 4096, 24, 64, 1, 128, 256)]
# the flash kernel with a score scale other than 1/sqrt(D):
# granite-4.0-h-small's served wave, 32 × 256 tokens, 32 heads on 8 of 128,
# no rope, scores times 1/128
FLASH_SCALED = [((32, 256, 256, 32, 8, 128, True, None), 1 / 128)]
# decode attention: (b, cache slots, kv heads, query heads a group,
# head_dim, valid keys timed).  The benchmark's decode_heavy step
# (hymba-1.5b: 16 slots over 1,280, its mean of 769 valid keys) and
# mistral-nemo-12b's widest serving wave (4 slots over 2,064, D 128, a
# group of 4); fp32 q, k, v from the weight products, bf16 caches, shared
# rope tables, as the servers run them
DECODE_ATTENTION_MAIN = [(16, 1280, 5, 5, 64, 769),
                         (4, 2064, 8, 4, 128, 2049)]
# granite-4.0-h-small's batch_decode step: 32 slots over 768, 32 heads on
# 8 of 128, its mean of 512 valid keys, no rope, scores times 1/128
DECODE_ATTENTION_NOPE = [((32, 768, 8, 4, 128, 512), 1 / 128)]
# the old row of the slot a step writes, far from any new k or v
STALE_ROW = 40.0
# the SSM decode step: (b, heads, head_dim, d_state, groups).  The
# benchmark's batch_decode step (granite-4.0-h-small: 32 slots, 128 heads
# of 64 at d_state 128, 134 MB of state a layer) and decode_heavy's
# (hymba-1.5b: 16 slots, 50 heads of 64 at d_state 16); fp32, as served
SSM_DECODE_MAIN = [(32, 128, 64, 128, 1), (16, 50, 64, 16, 1)]
# bf16 activations and conv window, two groups
SSM_DECODE_BF16 = [(4, 32, 64, 128, 2)]
# tests/test_kernels.py:16-18 (fp32, bf16) and :123 (the SSD scan)
TOL = {"fp32": 2e-5, "bf16": 5e-2}
SSD_TOL = 1e-3
# the kernel's exp is ex2.approx: its fp32 y against plain is reported as
# max |got - want| / (1 + |want|) beside this figure
SSD_EXP_TOL = 2e-5
# serving: hymba-1.5b, 4 slots, two waves of 4 requests
SERVE_ARCH = "hymba-1.5b"
SERVE_WAVES = (1024, 4096)
SERVE_SLOTS = 4
SERVE_NEW_TOKENS = 32
SERVE_MAX_LEN = 4128
# model level: tests/test_serve.py's 2e-3; greedy tokens may differ only at
# a near-tie of the plain run's top two logits
MODEL_TOL = 2e-3
NEAR_TIE = 1e-4
# the decode and prefill graphs against the eager step or prefill on the
# same inputs: bit for bit, or logits (and each cache entry) within this
# share of their largest magnitude, tokens equal
GRAPH_REL_TOL = 1e-5
TRACE_ARCHS = ("hymba-1.5b", "mamba2-130m")
TRACE_STEPS = 8
TRACE_PREFILLS = 3
# the aten ops that allocate without launching a kernel (prefill_ops)
ALLOCATIONS = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided")
# training: internlm2-1.8b at full width and depth, fp32, 8 steps
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_BATCH = 4
TRAIN_SEQ = 1024
TRAIN_STEPS = 8
# the sharded DES: BENCH_des_scale.json's diurnal row
DES_CELL = dict(arrival="diurnal", messages=100_000, devices=100,
                consumers=1_000, rate_hz=20_000.0, payload_bytes=64,
                service_s=0.001, seed=0)
DES_DET_COLS = ("processed", "duplicates", "truncated_msgs", "makespan_s",
                "lat_p50_s", "lat_p95_s", "wan_bytes")
# the quickstart's messages held card against host
QUICKSTART_CHECKED = 8
# the LM example: --params 100 (12 layers × 768), the reference's 60 steps
LM_STEPS = 60
# the rest of the zoo: minicpm3-4b (MLA) served at full width and depth,
# 2 waves of 4 requests; its 2-layer cut card against host; qwen2-vl-2b
# (M-RoPE, patch embeddings) at full width and depth; qwen3-moe at full
# width with 4 of its 94 layers (45 GB of fp32 weights)
ZOO_NEW_TOKENS = 16
MLA_ARCH = "minicpm3-4b"
MLA_WAVES = (1024, 2048)
MLA_HOST_PROMPT = 128
MLA_HOST_STEPS = 8
VLM_ARCH = "qwen2-vl-2b"
VLM_BATCH = 4
VLM_GRID = 16                # a 16 × 16 image grid of patch embeddings
VLM_TEXT = 768
MOE_ARCH = "qwen3-moe-235b-a22b"
MOE_LAYERS = 4
MOE_WAVES = (512, 1024)
MOE_CHECK_TOKENS = 256
MOE_TOL = 2e-4
# the five archs first served on the card at full width (ROADMAP A11),
# smallest first: (phase, arch, layers kept, the two waves' prompt tokens);
# depth is cut where the fp32 weights fill the card (nemotron: 37.75 GB of
# embedding and head and 13.45 GB a layer, 65.0 GB at two layers before
# any activation; arctic: 56.28 GB for its first layer)
ZOO_SERVE = [("serve_mamba2", "mamba2-130m", 24, (1024, 4096)),
             ("serve_musicgen", "musicgen-medium", 48, (1024, 2048)),
             ("serve_mistral", "mistral-nemo-12b", 40, (1024, 2048)),
             ("serve_nemotron", "nemotron-4-340b", 1, (512, 1024)),
             ("serve_arctic", "arctic-480b", 1, (512, 1024))]
CARD_BYTES = 80e9             # a phase must peak below this
PLAN_LIMIT_BYTES = 75e9       # a reckoned peak past this fails on the host
# the GPipe step (both stages in one process) and the sharding rules
GPIPE_STAGES = 2
GPIPE_MICROBATCHES = 4
GPIPE_STEPS = 2               # held against the plain step
GPIPE_GRAPH_STEPS = 4         # eager, then through the graph, bit for bit
GPIPE_LOSS_TOL = 1e-5         # relative, against the plain step
GPIPE_NORM_TOL = 1e-4         # relative (train_vs_host's)
GPIPE_PARAM_TOL = 5e-5        # absolute (tests/test_torch_train.py's)
GPIPE_FLIP_SHARE = 1e-4       # of elements allowed past it (sign flips)
SHARD_MOE_LAYERS = 1
SHARD_MOE_BATCH = 4
SHARD_MOE_SEQ = 128
SHARD_MOE_GROUPS = 4
SHARD_MOE_TOL = 1e-4          # of the logits' largest magnitude
DRYRUN_CELLS = [("internlm2-1.8b", "train_4k", False),
                ("internlm2-1.8b", "train_4k", True),
                ("internlm2-1.8b", "decode_32k", False),
                ("internlm2-1.8b", "decode_32k", True),
                ("hymba-1.5b", "long_500k", False)]
# one reduced config of each family through train, prefill and decode on
# a (data 2, model 4) fake mesh: this machine's torch has its own DTensor
DRYRUN_FAMILIES = ["internlm2-1.8b", "minicpm3-4b", "hymba-1.5b",
                   "mamba2-130m", "qwen3-moe-235b-a22b", "qwen2-vl-2b",
                   "musicgen-medium"]
DRYRUN_SMALL = [("train_s", 32, 4, "train"), ("prefill_s", 64, 2, "prefill"),
                ("decode_s", 64, 4, "decode")]
DRYRUN_TRAIN_BATCH = 4        # train_4k's 256 sequences of 4,096 cut to 4
DRYRUN_DECODE_BATCH = 2       # decode_32k's 128 sequences cut to 2
DRYRUN_TIMED = 1              # host-timed calls a form of the train step
DRYRUN_DECODES = 8            # and of the decode step
INT8_BATCH = 4                # the train phase's 4 × 1,024 tokens
INT8_STEPS = 4                # eager, then through the graph, bit for bit


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def blobs(torch, n, f, k, device, seed):
    """Mini-App-like data made on the card: Gaussian clusters in a ±10 box,
    2% uniform outliers in a ±40 box; the centroids are k of the points,
    as ``KMeans.init(sample)`` seeds them, so k rows sit at d = 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    centers = (torch.rand((k, f), generator=g, device=device) * 2 - 1) * 10
    which = torch.randint(0, k, (n,), generator=g, device=device)
    x = centers[which] + torch.randn((n, f), generator=g, device=device)
    n_out = int(round(0.02 * n))
    if n_out:
        rows = torch.randperm(n, generator=g, device=device)[:n_out]
        x[rows] = (torch.rand((n_out, f), generator=g, device=device)
                   * 2 - 1) * 40
    pick = torch.randperm(n, generator=g, device=device)[:k]
    return x.contiguous(), x[pick].contiguous()


def bound_ms(n, f, k, precision, fused, point_bytes=None):
    """Least time for the function on this card: the larger of its bytes
    (each input read once, each output written once) over HBM bandwidth
    and its 2·N·K·F flops over the peak rate for its type."""
    pb = ELEM_BYTES[precision] if point_bytes is None else point_bytes
    nbytes = n * f * pb + (k * f + k) * 4 + n * 8
    if precision == "int8":
        nbytes += f * 4
    if fused:
        nbytes += (k * f + k) * 4
    flops = 2.0 * n * k * f
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[precision]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_kernel(torch, kk, n, f, k, precision, device, offset=0,
                 block_n=128):
    """Both kernels, with ``block_n``-row tiles, against the plain version at
    one shape (on ``x[offset:]`` of the points); returns the worst dmin
    error of each form where the ids agree."""
    x, c = blobs(torch, n, f, k, device, SEED + n + f + k)
    x = x[offset:]
    n = x.shape[0]
    prep = kk.prepare(x, c, precision)
    runs = [kk.launch(prep, True, block_n) for _ in range(3)]
    ids, dmin, sums, counts = runs[0]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            if not torch.equal(a, b):
                raise AssertionError(f"fused outputs differ between launches "
                                     f"at {(n, f, k)} {precision}")
    a_ids, a_dmin = kk.launch(prep, False, block_n)
    p_ids, p_dmin, p_sums, p_counts = kk.plain(prep, fused=True)
    torch.cuda.synchronize()
    if not (torch.equal(a_ids, ids) and torch.equal(a_dmin, dmin)):
        raise AssertionError(f"assign-only and fused kernels disagree at "
                             f"{(n, f, k)} {precision}")

    xv = kk.point_values(prep)
    cv = prep.centroids
    d2p = torch.clamp_min((xv * xv).sum(1, keepdim=True) - 2.0 * (xv @ cv.T)
                          + prep.c2[None, :], 0.0)
    tol = D2_RTOL * ((xv * xv).sum(1) + prep.c2.max())
    ids_l, p_ids_l = ids.long(), p_ids.long()
    gap = (d2p.gather(1, ids_l[:, None]) - d2p.gather(1, p_ids_l[:, None]))
    mism = ids_l != p_ids_l
    if bool((mism & (gap[:, 0].abs() > tol)).any()):
        raise AssertionError(f"ids differ beyond near-ties at {(n, f, k)} "
                             f"{precision}")
    # distances, compared as squared distances (the cancellation near d = 0
    # is absolute in d², not in d)
    if bool(((dmin.double() ** 2 - p_dmin.double() ** 2).abs()
             > tol.double()).any()):
        raise AssertionError(f"dmin out of tolerance at {(n, f, k)} "
                             f"{precision}")
    # counts exact against the kernel's own ids (and the plain counts
    # when no id moved); sums against a float64 sum over the kernel's
    # ids, within the fp32 bound of the kernel's longest chain of
    # additions: chain · 2^-24 · Σ|x|, where a block's accumulator takes at
    # most ceil(tiles / grid) tiles of `rows` rows, then the block adds its
    # warps' copies and the second launch the grid's partials
    want_counts = torch.bincount(ids_l, minlength=k).float()
    if not torch.equal(counts, want_counts):
        raise AssertionError(f"counts wrong at {(n, f, k)} {precision}")
    if not bool(mism.any()) and not torch.equal(counts, p_counts):
        raise AssertionError(f"counts differ from plain at {(n, f, k)}")
    x64 = xv.double()
    want = torch.zeros((k, f), dtype=torch.float64, device=device
                       ).index_add_(0, ids_l, x64)
    abs_sums = torch.zeros_like(want).index_add_(0, ids_l, x64.abs())
    grid, rows, warps = kk.geometry(prep, True, block_n)
    chain = -(-n // (rows * grid)) * rows + warps + grid
    sum_tol = chain * 2.0 ** -24 * abs_sums + 1e-6
    if bool(((sums.double() - want).abs() > sum_tol).any()):
        raise AssertionError(f"sums out of tolerance at {(n, f, k)} "
                             f"{precision}")
    agree = ~mism
    err = float((dmin - p_dmin)[agree].abs().max()) if bool(agree.any()) \
        else 0.0
    return {"shape": [n, f, k], "offset": offset, "precision": precision,
            "block_n": block_n, "grid": grid, "sum_chain": chain,
            "id_mismatches_at_ties": int(mism.sum()),
            "dmin_max_abs_err": err,
            "sums_max_abs_err": float((sums.double() - want).abs().max())}


def time_ms(torch, fn, iters):
    """Median over 5 repeats of the mean time of ``iters`` calls, CUDA
    events around each repeat, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(torch, fn, iters, names):
    """The kernels' own device time per call: the CUDA kernel durations that
    ``torch.profiler`` records over ``iters`` calls, for the kernels whose
    names hold one of ``names``; None where the profiler records none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(ev.device_time_total for ev in prof.key_averages()
                   if any(name in ev.key for name in names))
    return total_us / iters / 1e3 if total_us else None


def time_kernels(torch, kk, ops, device):
    rows = []
    for n, f, k in TIMED_SHAPES:
        x, c = blobs(torch, n, f, k, device, SEED + 1)
        iters = 50 if n <= 100_000 else 10
        for precision in PRECISIONS:
            prep = kk.prepare(x, c, precision)
            for fused, name in ((True, "kmeans_assign_update"),
                                (False, "kmeans_assign")):
                entry = ops.kmeans_assign_update if fused else ops.kmeans_assign
                row = {
                    "kernel": name, "shape": [n, f, k],
                    "precision": precision,
                    "kernel_ms": time_ms(
                        torch, lambda: kk.launch(prep, fused), iters),
                    "wrapper_ms": time_ms(
                        torch, lambda: entry(x, c, precision=precision),
                        iters),
                    "plain_ms": time_ms(
                        torch, lambda: kk.plain(prep, fused), iters),
                    "device_ms": device_ms(
                        torch, lambda: kk.launch(prep, fused), iters,
                        ("assign_kernel", "reduce_partials")),
                    "library_ms": None,
                }
                row["bound_ms"], row["bound_by"] = bound_ms(
                    n, f, k, precision, fused)
                # the wrapper reads fp32 points and prepares them itself
                row["wrapper_bound_ms"], _ = bound_ms(
                    n, f, k, precision, fused, point_bytes=4)
                emit("timing", **row)
                rows.append(row)
    return rows


def run_pipeline(torch, core, ml, kk, device):
    """The quickstart's loop through the port on the card: the training
    processor on 64 messages of 10,000 points under the threaded
    executor, op by op (``graph=False``) and then through the compiled
    ``assign_update_fn`` (one CUDA graph, the kernel inside it), then an
    inference processor through ``assign_fn`` that fetches the published
    centroids.  Each is driven with the launch counts set to 0 just
    before it and read just after; the graph runs are the main path's.
    Then each processor's CUDA work a message (``profile_messages``)."""
    manager = core.PilotManager()
    edge = manager.submit_pilot(core.ComputeResource(
        tier="edge", n_workers=4, memory_gb=4))
    cloud = manager.submit_pilot(core.ComputeResource(
        tier="cloud", n_devices=1, n_workers=4, memory_gb=44))
    if cloud.devices[0] != device:
        raise AssertionError(f"cloud pilot got {cloud.devices}")
    fns = outlier_graph_fns()

    def process_edge(context, data=None):
        return data[np.isfinite(data).all(axis=1)]

    def pipeline(handler, n_messages):
        gen = ml.MiniAppGenerator(n_points=MAIN_SHAPE[0], n_clusters=25,
                                  seed=7)
        return core.EdgeToCloudPipeline(
            pilot_cloud_processing=cloud, pilot_edge=edge,
            produce_function_handler=gen.make_producer(),
            process_edge_function_handler=process_edge,
            process_cloud_function_handler=handler,
            function_context={"model": "kmeans", "n_clusters": 25},
        ).run(n_messages=n_messages)

    runs = {False: [], True: []}
    for graph in TURNS:
        kmeans = ml.KMeans(n_clusters=25, n_features=32,
                           device=cloud.devices[0], graph=graph)
        params = core.ParameterService()
        meter = GraphMeter(torch, fns)
        for counter in kk.LAUNCHES.values():
            counter.reset()
        res = pipeline(kmeans.make_processor(params, "kmeans", train=True),
                       N_MESSAGES)
        torch.cuda.synchronize()
        launches = {name: c.count for name, c in kk.LAUNCHES.items()}
        stats = meter.read()
        if res.n_processed != N_MESSAGES:
            raise AssertionError(f"processed {res.n_processed}/{N_MESSAGES}")
        if launches["kmeans_assign_update"] < N_MESSAGES:
            raise AssertionError(f"fused kernel launched "
                                 f"{launches['kmeans_assign_update']} "
                                 f"times for {N_MESSAGES} messages")
        if (stats["captures"] + stats["replays"] >= N_MESSAGES) != graph:
            raise AssertionError(f"graph={graph}: {stats}")
        # the processor's state is shared by the cloud stage's worker
        # threads without a lock (as in the reference), so an update may be
        # lost and the counts only bound the points seen
        version, tree = params.fetch("kmeans")
        if version != N_MESSAGES or tree["centroids"].shape != (25, 32) \
                or not np.isfinite(tree["centroids"]).all() \
                or not 0 < tree["counts"].sum() <= N_MESSAGES * MAIN_SHAPE[0]:
            raise AssertionError("published k-means state is wrong")
        for r in res.results:
            if not (np.isfinite(r["mean_score"]) and r["n_outliers"] >= 0):
                raise AssertionError(f"bad result {r}")
        runs[graph].append((res, launches, stats, version, params))
    res, train_launches, _, version, params = runs[True][-1]
    stats, stats_e = runs[True][0][2], runs[False][0][2]

    meter = GraphMeter(torch, fns)
    for counter in kk.LAUNCHES.values():
        counter.reset()
    res_inf = pipeline(ml.KMeans(device=device).make_processor(
        params, "kmeans", train=False), 8)
    torch.cuda.synchronize()
    infer_launches = {name: c.count for name, c in kk.LAUNCHES.items()}
    infer_stats = meter.read()
    if res_inf.n_processed != 8 or infer_launches["kmeans_assign"] < 8 \
            or infer_stats["captures"] + infer_stats["replays"] < 8:
        raise AssertionError(f"inference run: {res_inf.n_processed} "
                             f"processed, launches {infer_launches}, "
                             f"{infer_stats}")
    gen = ml.MiniAppGenerator(n_points=MAIN_SHAPE[0], seed=9)
    msgs = [gen.sample() for _ in range(8)]
    prof = {}
    for graph in (False, True):
        proc = ml.KMeans(device=device, graph=graph).make_processor()
        prof["graph" if graph else "eager"] = profile_messages(
            torch, lambda m: proc(None, data=m), msgs)
    tp = res.throughput()
    emit("pipeline", n_processed=res.n_processed, n_produced=res.n_produced,
         wall_s=res.wall_s, msgs_per_s=tp["msgs_per_s"],
         bytes_per_s=tp["bytes_per_s"], params_version=version,
         launches=train_launches, **loop_rates(runs), graph=stats,
         eager=stats_e,
         kernel_nodes_per_msg=kernel_nodes([fns[1]]), profile=prof)
    emit("pipeline_inference", n_processed=res_inf.n_processed,
         msgs_per_s=res_inf.throughput()["msgs_per_s"],
         launches=infer_launches, graph=infer_stats)
    manager.release_all()
    return {"kmeans_assign_update": train_launches["kmeans_assign_update"],
            "kmeans_assign": infer_launches["kmeans_assign"]}


def _tdtype(torch, name):
    return {"fp32": torch.float32, "bf16": torch.bfloat16}[name]


def flash_inputs(torch, case, dtype, device, seed):
    b, sq, sk, h, hkv, d = case[:6]
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=device  # noqa
                                    ).to(_tdtype(torch, dtype))
    return mk(b, sq, h, d), mk(b, sk, hkv, d), mk(b, sk, hkv, d)


def flash_tol(want, dtype):
    """Kernel against plain: both compute in fp32 from the same inputs and
    round once to the output type.  fp32 takes the reference's 2e-5; bf16
    one rounding, 2^-7 of the value, plus 1e-3 of the largest value for
    the fp32 sums' order near a rounding boundary."""
    w = want.float().abs()
    if dtype == "fp32":
        return TOL["fp32"] * (1 + w)
    return 2.0 ** -7 * w + 1e-3 * w.max()


def check_flash(torch, fa, tref, device):
    """The flash kernel against its plain version on every case in fp32 and
    bf16 (:func:`flash_tol`), ``FLASH_SCALED``'s at their scales, and
    against the O(S²) oracle (at 1/√D) where it fits,
    at the reference's tolerance; raises on a miss.  Returns the largest
    fp32 error."""
    worst = 0.0
    cases = [(case, None) for case in FLASH_CASES] + FLASH_SCALED
    for case, scale in cases:
        causal, window = case[6], case[7]
        for dtype in ("fp32", "bf16"):
            q, k, v = flash_inputs(torch, case, dtype, device, sum(case[:6]))
            out = fa.launch(q, k, v, causal=causal, window=window,
                            scale=scale)
            want = fa.plain(q, k, v, causal=causal, window=window,
                            scale=scale)
            torch.cuda.synchronize()
            err = float((out.float() - want.float()).abs().max())
            tol = flash_tol(want, dtype)
            if out.shape != q.shape or out.dtype != q.dtype or bool(
                    ((out.float() - want.float()).abs() > tol).any()):
                raise AssertionError(f"flash kernel vs plain at {case} "
                                     f"scale {scale} {dtype}: max error "
                                     f"{err}")
            row = {"case": list(case), "scale": scale, "dtype": dtype,
                   "max_abs_err": err}
            if case[1] <= 512 and scale is None:    # the oracle's 1/sqrt(D)
                oracle = tref.flash_attention_ref(q, k, v, causal=causal,
                                                  window=window)
                row["oracle_max_abs_err"] = float(
                    (out.float() - oracle.float()).abs().max())
                if bool(((out.float() - oracle.float()).abs()
                         > TOL[dtype] * (1 + oracle.float().abs())).any()):
                    raise AssertionError(f"flash kernel vs oracle at {case} "
                                         f"{dtype}")
            if dtype == "fp32":
                worst = max(worst, err)
            emit("check_flash", **row)
    return worst


def ssd_inputs(torch, case, dtype, device, seed):
    b, s, nh, hd, gr, ds, _ = case
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=device)  # noqa
    td = _tdtype(torch, dtype)
    return (mk(b, s, nh, hd).to(td),
            torch.rand((b, s, nh), generator=g, device=device) * 0.099 + 1e-3,
            -(torch.rand((nh,), generator=g, device=device) * 1.5 + 0.5),
            mk(b, s, gr, ds).to(td), mk(b, s, gr, ds).to(td), mk(nh))


def check_ssd(torch, ssd, tref, device):
    """The SSD chunk kernel (and the full scan through it) against the
    plain version on every case in fp32 (within 1e-3) and bf16 (within
    5e-2), and against the exact sequential oracle at the small fp32 cases.
    Each fp32 row also reports y's error relative to 1 + |y| beside
    ``SSD_EXP_TOL``.  Returns the largest fp32 error."""
    worst = 0.0
    runs = [(case, dtype) for dtype in ("fp32", "bf16") for case in SSD_CASES]
    for case, dtype in runs:
        chunk = case[-1]
        args = ssd_inputs(torch, case, dtype, device, sum(case))
        parts = ssd.chunk_launch(*args, chunk)
        y, fin = ssd.inter_chunk(*parts, args[4], chunk)
        want_parts = ssd.chunk_plain(*args, chunk)
        want_y, want_fin = ssd.inter_chunk(*want_parts, args[4], chunk)
        torch.cuda.synchronize()
        tol = SSD_TOL if dtype == "fp32" else TOL["bf16"]
        errs = {}
        for name, got, want in (("y_intra", parts[0], want_parts[0]),
                                ("st", parts[1], want_parts[1]),
                                ("cum", parts[2], want_parts[2]),
                                ("y", y, want_y), ("final", fin, want_fin)):
            diff = (got.float() - want.float()).abs()
            errs[name] = float(diff.max())
            if bool((diff > tol * (1 + want.float().abs())).any()):
                raise AssertionError(f"SSD kernel vs plain at {case} "
                                     f"{dtype}: {name} error {errs[name]}")
        row = {"case": list(case), "dtype": dtype, "max_abs_err": errs}
        if dtype == "fp32":
            want = want_parts[0]
            row["y_intra_rel_err"] = float(
                ((parts[0] - want).abs() / (1 + want.abs())).max())
            row["y_intra_rel_tol"] = SSD_EXP_TOL
        if case[1] <= 512 and dtype == "fp32":
            y_o, fin_o = tref.ssd_ref(*args)
            row["oracle_max_abs_err"] = [
                float((y - y_o).abs().max()), float((fin - fin_o).abs().max())]
            if bool(((y - y_o).abs() > SSD_TOL * (1 + y_o.abs())).any()) or \
                    bool(((fin - fin_o).abs()
                          > SSD_TOL * (1 + fin_o.abs())).any()):
                raise AssertionError(f"SSD scan vs oracle at {case}")
        if dtype == "fp32":
            worst = max(worst, max(errs.values()))
        emit("check_ssd", **row)
        del args, parts, want_parts, y, fin, want_y, want_fin
    return worst


def flash_bound_ms(case, dtype):
    """Bytes: q, k, v read once and o written once.  Operations: 4·D flops
    (q·k and p·v) for each (query, key) pair the masks leave open."""
    b, sq, sk, h, hkv, d, causal, window = case
    e = ELEM_BYTES[dtype]
    nbytes = e * d * (2 * b * sq * h + 2 * b * sk * hkv)
    qpos = np.arange(sq)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, int)
    pairs = int(np.maximum(hi - lo, 0).sum())
    flops = 4.0 * b * h * d * pairs
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def ssd_bound_ms(case, dtype, gram_per_head=False):
    """Operations, over the q(q+1)/2 causal (i, j) pairs of each chunk (as
    ``flash_bound_ms`` counts only unmasked pairs): 2·ds flops a pair for
    C·Bᵀ, once for each (batch, B/C group, chunk), since the group's heads
    share it; 2·hd a pair for its product with x and 2q·ds·hd for the
    chunk state, for each (batch, head, chunk).  ``gram_per_head`` counts
    C·Bᵀ once a head, the figure of earlier runs.  Bytes: x, dt, B and C
    read once; y, the chunk states and cum written once."""
    b, s, nh, hd, g, ds, q = case
    nc = s // q
    e = ELEM_BYTES[dtype]
    nbytes = (e * (2 * b * s * nh * hd + 2 * b * s * g * ds) + 4 * b * s * nh
              + 4 * b * nh * nc * (ds * hd + q) + 8 * nh)
    pairs = q * (q + 1) / 2
    gram = b * (nh if gram_per_head else g) * nc * 2.0 * ds * pairs
    flops = gram + b * nh * nc * (2.0 * hd * pairs + 2.0 * q * ds * hd)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def sdpa_forms(torch, q, k, v, causal, window):
    """The library yardstick (the port never calls it): each
    ``scaled_dot_product_attention`` form that computes the same function,
    inputs laid out for it outside the call.  The window as a boolean mask
    always; where the window covers every prompt position (or there is
    none), also the mask-free ``is_causal=True`` form, which the flash
    backend takes."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sq, sk = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        keep = keep & (kpos <= qpos)
    if window is not None:
        keep = keep & (kpos > qpos - window)
    forms = {"mask": lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep, enable_gqa=True)}
    if causal and sq == sk and (window is None or window >= sq):
        forms["is_causal"] = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    return forms


def time_library(torch, q, k, v, causal, window, iters):
    """Every (backend, form) of the library call that accepts the inputs,
    timed as :func:`time_ms` times the kernel, with the backend chosen
    outside the timed loop.  Returns the fastest as (ms, "BACKEND:form",
    its output in the reference's layout) and every time by name."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    times, best = {}, None
    for form, fn in sdpa_forms(torch, q, k, v, causal, window).items():
        for backend in (SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            name = backend.name
            with sdpa_kernel(backend):
                try:
                    out = fn()
                    torch.cuda.synchronize()
                except RuntimeError:        # the backend refuses the inputs
                    continue
                ms = time_ms(torch, fn, iters)
            times[f"{name}:{form}"] = ms
            if best is None or ms < best[0]:
                best = (ms, f"{name}:{form}", out.transpose(1, 2))
            del out
    if best is None:
        raise AssertionError("no SDPA backend accepted the inputs")
    return best, times


def time_attention_ssd(torch, fa, ssd, device):
    """Kernel, plain and library times at the serving path's shapes, fp32
    and bf16: CUDA events, median of 5 repeats."""
    rows = []
    for case in FLASH_MAIN + FLASH_ZOO:
        causal, window = case[6], case[7]
        for dtype in ("fp32", "bf16"):
            q, k, v = flash_inputs(torch, case, dtype, device, 11)
            ker_out = fa.launch(q, k, v, causal=causal, window=window)
            (lib_ms, lib_name, lib_out), lib_times = time_library(
                torch, q, k, v, causal, window, 5)
            row = {"kernel": "flash_attention", "case": list(case),
                   "dtype": dtype,
                   "kernel_ms": time_ms(torch, lambda: fa.launch(
                       q, k, v, causal=causal, window=window), 5),
                   "plain_ms": time_ms(torch, lambda: fa.plain(
                       q, k, v, causal=causal, window=window), 1),
                   "library_ms": lib_ms, "library_backend": lib_name,
                   "library_ms_by_backend": lib_times,
                   "library_max_abs_diff": float(
                       (lib_out.float() - ker_out.float()).abs().max())}
            row["bound_ms"], row["bound_by"] = flash_bound_ms(case, dtype)
            emit("timing", **row)
            rows.append(row)
            del q, k, v, lib_out, ker_out
    for case in SSD_MAIN + SSD_ZOO:
        chunk = case[-1]
        for dtype in ("fp32", "bf16"):
            args = ssd_inputs(torch, case, dtype, device, 13)
            row = {"kernel": "ssd_chunk_scan", "case": list(case),
                   "dtype": dtype,
                   "kernel_ms": time_ms(torch, lambda: ssd.chunk_launch(
                       *args, chunk), 5),
                   "plain_ms": time_ms(torch, lambda: ssd.chunk_plain(
                       *args, chunk), 1),
                   "scan_ms": time_ms(torch, lambda: ssd.ssd_chunk_scan(
                       *args, chunk=chunk), 5),
                   "library_ms": None}
            row["bound_ms"], row["bound_by"] = ssd_bound_ms(case, dtype)
            row["bound_ms_gram_per_head"], _ = ssd_bound_ms(
                case, dtype, gram_per_head=True)
            emit("timing", **row)
            rows.append(row)
    return rows


def decode_attention_inputs(torch, case, device, seed):
    """Card inputs at ``case``: unroped fp32 q, k and v, bf16 caches of
    random keys and values, rope tables shared by the rows."""
    b, s, hkv, rep, d = case[:5]
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=device)  # noqa
    ang = mk(1, d // 2) * 3.0
    return (mk(b, hkv * rep, d), mk(b, hkv, d), mk(b, hkv, d),
            mk(b, s, hkv, d).bfloat16(), mk(b, s, hkv, d).bfloat16(),
            torch.cos(ang), torch.sin(ang))


def decode_attention_tol(want):
    """Kernel against plain: the same casts, the sums in another order, so
    the bf16 output may round the other way: one rounding, 2^-7 of the
    value, plus 2^-8 of the largest value for a softmax weight that rounds
    the other way to bf16."""
    w = want.float().abs()
    return 2.0 ** -7 * w + 2.0 ** -8 * w.max()


def check_decode_attention(torch, tda, device):
    """The decode attention kernel (``tda.launch``) against its plain
    version on the same card inputs at the main path's shapes
    (``DECODE_ATTENTION_MAIN``, roped, and ``DECODE_ATTENTION_NOPE``,
    unroped at its own scale), as a full cache and as a ring, at one
    valid key, the timed position, a full cache and (a ring) two
    positions past its wrap.  Before each call the slot the step writes
    holds ``±STALE_ROW``, so a read of the old row shows.  The caches
    after the call bit for bit, the output in the plain version's type
    and within :func:`decode_attention_tol`; raises on a miss.  Returns
    the largest error."""
    worst = 0.0
    cases = [(case, True, None) for case in DECODE_ATTENTION_MAIN] + [
        (case, False, scale) for case, scale in DECODE_ATTENTION_NOPE]
    for case, roped, scale in cases:
        b, s, hkv, rep, d, timed = case
        q, k, v, kc, vc, cos, sin = decode_attention_inputs(
            torch, case, device, sum(case))
        if not roped:
            cos = sin = None
        for ring in (False, True):
            positions = [0, timed - 1, s - 1] + (
                [s + 7, 3 * s + s // 3] if ring else [])
            errs, of_scale = [], []
            for n in positions:
                widx = tda.ring_slot(n, s, ring)[0]
                base_k, base_v = kc.clone(), vc.clone()
                base_k[:, widx], base_v[:, widx] = STALE_ROW, -STALE_ROW
                kk, vk = base_k.clone(), base_v.clone()
                length = torch.tensor(n, dtype=torch.int32, device=device)
                got = tda.launch(q, k, v, kk, vk, length, cos, sin,
                                 ring=ring, scale=scale)
                want = tda.plain(q, k, v, base_k, base_v, n, cos, sin,
                                 ring=ring, scale=scale)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                if (got.shape != want.shape or got.dtype != want.dtype
                        or not torch.equal(kk, base_k)
                        or not torch.equal(vk, base_v)
                        or bool((diff > decode_attention_tol(want)).any())):
                    raise AssertionError(
                        f"decode attention kernel vs plain at {case} rope "
                        f"{roped} scale {scale} ring {ring} position {n}: "
                        f"max error {float(diff.max())}"
                        f" of {float(want.float().abs().max())}, caches "
                        f"equal {torch.equal(kk, base_k)} "
                        f"{torch.equal(vk, base_v)}")
                errs.append(float(diff.max()))
                of_scale.append(errs[-1] / float(want.float().abs().max()))
                del base_k, base_v, kk, vk, got, want, diff
            worst = max(worst, max(errs))
            emit("check_decode_attention", case=list(case), rope=roped,
                 scale=scale, ring=ring, positions=positions,
                 max_abs_err=errs,
                 err_of_scale=of_scale, stale_row=STALE_ROW)
        del q, k, v, kc, vc, cos, sin
    return worst


def graph_ms(torch, fn, calls=20, replays=10):
    """One call of ``fn``'s device time without its host launch: ``calls``
    calls captured in a CUDA graph, replayed ``replays`` times between
    CUDA events (:func:`time_ms`), divided by ``calls``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(torch, graph.replay, replays) / calls
    del graph
    return ms


def decode_attention_bound_ms(case):
    """Bytes: the valid keys' K and V rows of the bf16 cache read once
    (the new row written in place of one), the fp32 q, k, v and rope
    tables read and the fp32 output written once.  Operations: 4·D flops
    (q·k and p·v) for each (query head, valid key) pair, at the fp32
    peak (the kernel's sums are CUDA-core FMAs)."""
    b, s, hkv, rep, d, valid = case
    h = hkv * rep
    nbytes = (ELEM_BYTES["bf16"] * 2 * b * valid * hkv * d
              + ELEM_BYTES["fp32"] * (2 * b * h * d + 2 * b * hkv * d + d))
    flops = 4.0 * d * b * h * valid
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["fp32"]
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def time_decode_attention(torch, tda, device):
    """Kernel, plain and library times at ``DECODE_ATTENTION_MAIN``: the
    kernel and the library call by :func:`graph_ms` (a launch takes
    longer on the host than the kernel on the card), the plain version
    by :func:`time_ms`.  The library is the fastest SDPA backend with
    one query over the valid keys of the bf16 cache, bf16 q, GQA: no
    rope, no slot write, the layouts made outside the call."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    rows = []
    for case in DECODE_ATTENTION_MAIN:
        b, s, hkv, rep, d, valid = case
        q, k, v, kc, vc, cos, sin = decode_attention_inputs(
            torch, case, device, 17)
        length = torch.tensor(valid - 1, dtype=torch.int32, device=device)
        run = lambda: tda.launch(q, k, v, kc, vc, length, cos,  # noqa
                                 sin, ring=False)
        kernel_ms = graph_ms(torch, run)
        plain_ms = time_ms(torch, lambda: tda.plain(
            q, k, v, kc, vc, valid - 1, cos, sin, ring=False), 1)
        qt = q.bfloat16()[:, :, None]
        kt, vt = (c[:, :valid].transpose(1, 2).contiguous()
                  for c in (kc, vc))
        times = {}
        for backend in (SDPBackend.CUDNN_ATTENTION,
                        SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION):
            fn = lambda: F.scaled_dot_product_attention(  # noqa
                qt, kt, vt, enable_gqa=True)
            with sdpa_kernel(backend):
                try:
                    fn()
                    torch.cuda.synchronize()
                except RuntimeError:        # the backend refuses the inputs
                    continue
                times[backend.name] = graph_ms(torch, fn)
        best = min(times, key=times.get)
        row = {"kernel": "decode_attention", "case": list(case),
               "dtype": "bf16 cache, fp32 q", "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": times[best],
               "library_backend": best, "library_ms_by_backend": times}
        row["bound_ms"], row["bound_by"] = decode_attention_bound_ms(case)
        emit("timing", **row)
        rows.append(row)
        del q, k, v, kc, vc, cos, sin, qt, kt, vt
    return rows


def ssm_decode_inputs(torch, case, device, seed, dtype=None):
    """Card inputs at ``case``: xbc and dt_raw as strided views of one
    in-projection row (as ``layers.ssm_decode`` passes them), a conv window
    of d_conv 4, an fp32 state, the conv's weight and bias and the heads'
    dt_bias, A_log (log 1..nh) and D."""
    b, nh, hd, ds, ng = case
    dtype = dtype or torch.float32
    conv_dim = nh * hd + 2 * ng * ds
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=device)  # noqa
    proj = mk(b, conv_dim + nh + 3).to(dtype)
    return dict(
        xbc=proj[:, :conv_dim], dt_raw=proj[:, conv_dim:conv_dim + nh],
        conv_state=mk(b, 3, conv_dim).to(dtype), ssm_state=mk(b, nh, hd, ds),
        conv_w=(mk(4, conv_dim) * 0.5).to(dtype),
        conv_b=(mk(conv_dim) * 0.1).to(dtype), dt_bias=mk(nh) * 0.5 - 3.0,
        A_log=torch.log(torch.arange(1, nh + 1, device=device,
                                     dtype=torch.float32)),
        D=mk(nh)), ng


def check_ssm_decode(torch, tsd, device):
    """The SSM decode kernel (``tsd.launch``) against its plain version on
    the same card inputs at ``SSM_DECODE_MAIN`` (fp32) and
    ``SSM_DECODE_BF16``, four consecutive steps each side on its own
    copies of the states: the conv window bit for bit, the state and y
    within ``tsd.tolerance`` (the card tests' too); raises on a miss.  Returns the largest
    error of y."""
    worst = 0.0
    cases = [(c, "fp32") for c in SSM_DECODE_MAIN] + [
        (c, "bf16") for c in SSM_DECODE_BF16]
    for case, dt in cases:
        dtype = torch.float32 if dt == "fp32" else torch.bfloat16
        a, ng = ssm_decode_inputs(torch, case, device, sum(case), dtype)
        mine = {k: a[k].clone() for k in ("conv_state", "ssm_state")}
        errs, state_errs = [], []
        for step in range(4):
            a["xbc"].mul_(-1.0 if step % 2 else 1.0)
            got = tsd.launch(a["xbc"], a["dt_raw"], mine["conv_state"],
                             mine["ssm_state"], a["conv_w"], a["conv_b"],
                             a["dt_bias"], a["A_log"], a["D"], n_groups=ng)
            want = tsd.plain(**a, n_groups=ng)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            sdiff = (mine["ssm_state"] - a["ssm_state"]).abs()
            if (got.shape != want.shape or got.dtype != want.dtype
                    or not torch.equal(mine["conv_state"], a["conv_state"])
                    or bool((diff > tsd.tolerance(want)).any())
                    or bool((sdiff > tsd.tolerance(a["ssm_state"])).any())):
                raise AssertionError(
                    f"SSM decode kernel vs plain at {case} {dt} step "
                    f"{step}: y max error {float(diff.max())} of "
                    f"{float(want.float().abs().max())}, state "
                    f"{float(sdiff.max())}, window equal "
                    f"{torch.equal(mine['conv_state'], a['conv_state'])}")
            errs.append(float(diff.max()))
            state_errs.append(float(sdiff.max()))
        worst = max(worst, max(errs))
        emit("check_ssm_decode", case=list(case), dtype=dt,
             max_abs_err=errs, state_max_abs_err=state_errs)
        del a, mine
    return worst


def ssm_decode_bound_ms(case):
    """Bytes: the fp32 state read and written once, the fp32 conv window
    (3 entries) read and written, xbc, dt_raw, the conv's weight and bias
    and the heads' three vectors read, y written.  Operations: ~7 flops a
    state element (the update's three products and sum, C·h's FMA) at the
    fp32 peak."""
    b, nh, hd, ds, ng = case
    conv_dim = nh * hd + 2 * ng * ds
    f4 = ELEM_BYTES["fp32"]
    nbytes = f4 * (2 * b * nh * hd * ds + 2 * 3 * b * conv_dim
                   + b * (conv_dim + nh) + 5 * conv_dim + 3 * nh
                   + b * nh * hd)
    flops = 7.0 * b * nh * hd * ds
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["fp32"]
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def time_ssm_decode(torch, tsd, device):
    """Kernel and plain times at ``SSM_DECODE_MAIN``: the kernel and the
    plain version (the op-by-op step's ops, with its copies into the
    cache) by :func:`graph_ms`, the plain version eagerly too
    (:func:`time_ms`).  Each call advances the states in place."""
    rows = []
    for case in SSM_DECODE_MAIN:
        a, ng = ssm_decode_inputs(torch, case, device, 29)
        kernel_ms = graph_ms(torch, lambda: tsd.launch(**a, n_groups=ng))
        plain = lambda: tsd.plain(**a, n_groups=ng)  # noqa
        row = {"kernel": "ssm_decode", "case": list(case), "dtype": "fp32",
               "kernel_ms": kernel_ms, "plain_graph_ms": graph_ms(torch,
                                                                  plain),
               "plain_ms": time_ms(torch, plain, 3), "library_ms": None}
        row["bound_ms"], row["bound_by"] = ssm_decode_bound_ms(case)
        emit("timing", **row)
        rows.append(row)
        del a
    return rows


def _top2(torch, logits, vocab):
    """The two largest logits of each row, on the host."""
    return torch.topk(logits[..., :vocab].float(), 2, dim=-1).values.cpu()


class CheckedDecode:
    """A decode function of ``serve.make_decode_fn`` (its CUDA graph on
    the card) held at every step against the eager ``decode_step`` on a
    copy of the same cache and the same inputs: logits bit for bit, or
    within ``GRAPH_REL_TOL`` of their largest magnitude, and the greedy
    tokens (every codebook's) equal; raises otherwise, and when a step on
    the card went through no graph.

    Records, for each wave (a call with another cache than the last one
    returned), the graph's and the eager step's ms (host clock between
    synchronisations; the step that captured, which also ran the warm-up
    step, is counted in ``capture_ms`` and not in ``graph_ms``), the
    graph's nodes and kernel nodes, the launches of each kernel of
    :func:`kernel_counters` its kernel nodes hold and those the wrappers
    counted at its capture, and the steps that agreed bit for bit.  The
    eager checks' own launches are kept apart in ``check_launches``."""

    def __init__(self, torch, T, cfg, decode):
        self.torch, self.T, self.cfg, self.decode = torch, T, cfg, decode
        self.waves = []
        self._cache = None
        self.counters = kernel_counters()
        self.check_launches = dict.fromkeys(self.counters, 0)

    @property
    def graphs(self):
        return self.decode.graphs

    @property
    def last(self):
        return self.decode.last

    @property
    def capture_s(self):
        return self.decode.capture_s

    def __call__(self, params, cache, inputs):
        torch = self.torch
        if cache is not self._cache:
            self.waves.append({"graph_ms": [], "eager_ms": [],
                               "capture_ms": 0.0, "steps": 0, "bitwise": 0,
                               "max_rel_err": 0.0})
        w = self.waves[-1]
        ref = {k: v.clone() for k, v in cache.items()}
        n_graphs = len(self.decode.graphs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, out = self.decode(params, cache, inputs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        before = {k: c.count for k, c in self.counters.items()}
        with torch.inference_mode():
            want, _ = self.T.decode_step(params, self.cfg, ref, inputs,
                                         impl=self.decode.impl)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for k, c in self.counters.items():
            self.check_launches[k] += c.count - before[k]
        g = self.decode.last
        if g is None:
            raise AssertionError("a decode step on the card went through "
                                 "no graph")
        if len(self.decode.graphs) > n_graphs:
            w["capture_ms"] = g.capture_s * 1e3
        else:
            w["graph_ms"].append((t1 - t0) * 1e3)
        w["eager_ms"].append((t2 - t1) * 1e3)
        w["nodes"], w["kernels"] = g.nodes, g.kernels
        names = {id(c): name for name, c in self.counters.items()}
        for key in ("launches", "counted"):
            w[key] = {names[id(c)]: n for c, n in getattr(g, key)
                      if id(c) in names}
        w["steps"] += 1
        if torch.equal(logits, want):
            w["bitwise"] += 1
        else:
            scale = float(want.float().abs().max())
            err = float((logits.float() - want.float()).abs().max())
            w["max_rel_err"] = max(w["max_rel_err"], err / scale)
            if not err <= GRAPH_REL_TOL * scale:
                raise AssertionError(f"decode graph vs eager: logits differ "
                                     f"by {err} of {scale}")
        vocab = self.cfg.vocab_size
        if not torch.equal(logits[..., :vocab].argmax(-1),
                           want[..., :vocab].argmax(-1)):
            raise AssertionError("decode graph vs eager: tokens differ")
        self._cache = out
        return logits, out


def graph_rows(waves, read_ms=None):
    """One row a wave of :class:`CheckedDecode`'s ``waves``; with
    ``read_ms`` (the step's weight read at the card's memory rate), each
    step's time over it."""
    rows = []
    for w in waves:
        row = dict(graph_ms=(statistics.mean(w["graph_ms"])
                                 if w["graph_ms"] else None),
                       eager_ms=statistics.mean(w["eager_ms"]),
                       capture_ms=w["capture_ms"], nodes=w["nodes"],
                       kernel_nodes=w["kernels"],
                       decode_attention_nodes=w["launches"].get(
                           "decode_attention", 0),
                       ssm_decode_nodes=w["launches"].get("ssm_decode", 0),
                       steps=w["steps"],
                       bitwise_steps=w["bitwise"],
                       max_rel_err=w["max_rel_err"])
        if read_ms:
            row["weight_read_ms"] = read_ms
            row["eager_over_read"] = row["eager_ms"] / read_ms
            if row["graph_ms"] is not None:
                row["graph_over_read"] = row["graph_ms"] / read_ms
        rows.append(row)
    return rows


def kernel_counters():
    """The launch counters of the kernels on the serving path, by name."""
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.kernels import ssm_decode as tsd
    return {**fa.LAUNCHES, **ssd.LAUNCHES, **tda.LAUNCHES, **tsd.LAUNCHES}


class CheckedPrefill:
    """A prefill function of ``serve.make_prefill_fn`` (its CUDA graph on
    the card) held at every call against its eager prefill
    (``prefill_with_cache`` at the same settings) on the same inputs: the
    last position's logits (every codebook's) and every cache entry bit
    for bit, or within ``GRAPH_REL_TOL`` of their largest magnitude, and
    the greedy tokens (every codebook's) equal; raises otherwise, and when
    a prefill on the card went through no graph.  Every other attribute
    is the function's.

    A key's first call returns its eager warm-up's result and captures
    the graph; here it is timed whole as ``first_ms``, and the graph is
    then replayed on the same inputs, so that every result this returns
    is a graph's.  Records, for each call (a wave), the graph's and the
    eager prefill's ms (host clock between synchronisations), the
    capture's ms, the graph's nodes and kernel nodes, the launches a
    replay adds (read from the graph's kernel nodes) and those the
    wrappers counted at its capture.  The eager prefill is a check, not
    the served path: its kernel launches are kept apart in
    ``check_launches``."""

    def __init__(self, torch, fn):
        self.torch, self.fn = torch, fn
        self.counters = kernel_counters()
        self.waves = []
        self.captures = 0
        self.check_launches = dict.fromkeys(self.counters, 0)

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __call__(self, params, inputs):
        torch = self.torch
        captures = self.fn.captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = self.fn(params, inputs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        g = self.fn.last
        if g is None:
            raise AssertionError("a prefill on the card went through no "
                                 "graph")
        names = {id(c): name for name, c in self.counters.items()}
        w = {"batch": int(next(iter(inputs.values())).shape[0]),
             "prompt": int(next(iter(inputs.values())).shape[1]),
             "first_ms": None, "capture_ms": 0.0, "nodes": g.nodes,
             "kernels": g.kernels,
             "launches": {names[id(c)]: n for c, n in g.launches
                          if id(c) in names},
             "counted": {names[id(c)]: n for c, n in g.counted
                         if id(c) in names}}
        if self.fn.captures > captures:
            self.captures += 1
            w["first_ms"] = (t1 - t0) * 1e3
            w["capture_ms"] = g.capture_s * 1e3
            del logits, cache                   # the warm-up's
            t0 = time.perf_counter()
            logits, cache = self.fn(params, inputs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        w["graph_ms"] = (t1 - t0) * 1e3
        before = {k: c.count for k, c in self.counters.items()}
        with torch.inference_mode():
            want, wcache = self.fn.eager(params, inputs)
        torch.cuda.synchronize()
        w["eager_ms"] = (time.perf_counter() - t1) * 1e3
        for k, c in self.counters.items():
            self.check_launches[k] += c.count - before[k]
        pairs = [("logits", logits[:, -1], want[:, -1])] + [
            (name, cache[name], wcache[name]) for name in wcache]
        if set(cache) != set(wcache):
            raise AssertionError(f"prefill graph vs eager: cache entries "
                                 f"{sorted(cache)} vs {sorted(wcache)}")
        w["bitwise"], w["max_rel_err"] = True, 0.0
        for name, a, b in pairs:
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"prefill graph vs eager: {name} is "
                                     f"{a.dtype} {tuple(a.shape)}, not "
                                     f"{b.dtype} {tuple(b.shape)}")
            if torch.equal(a, b):
                continue
            w["bitwise"] = False
            scale = float(b.float().abs().max())
            err = float((a.float() - b.float()).abs().max())
            w["max_rel_err"] = max(w["max_rel_err"], err / scale)
            if not err <= GRAPH_REL_TOL * scale:
                raise AssertionError(f"prefill graph vs eager: {name} "
                                     f"differs by {err} of {scale}")
        vocab = self.fn.cfg.vocab_size
        if not torch.equal(logits[:, -1, ..., :vocab].argmax(-1),
                           want[:, -1, ..., :vocab].argmax(-1)):
            raise AssertionError("prefill graph vs eager: tokens differ")
        self.waves.append(w)
        return logits, cache


def prefill_rows(waves):
    """:class:`CheckedPrefill`'s rows, with eager ÷ graph and, for a wave
    that captured, the replays of its shape that pay for the capture
    (capture ms ÷ the ms a replay saves; None where it saves none).  That
    wave's eager prefill follows the capture's ``empty_cache`` and
    allocates its working set anew, so the saving runs high there:
    :func:`trace_prefill` has the warm figure."""
    rows = []
    for w in waves:
        saved = w["eager_ms"] - w["graph_ms"]
        rows.append(dict(w, eager_over_graph=w["eager_ms"] / w["graph_ms"],
                         replays_to_repay=(w["capture_ms"] / saved
                                           if w["capture_ms"] and saved > 0
                                           else None)))
    return rows


def traced(prof, names, n, per):
    """Each of ``names`` is a ``record_function`` range of ``n`` runs
    that ends in a synchronisation: its window, the device's busy time
    (the union of its kernels and copies), idle share, and kernels a run.
    Fields are None where the profiler saw no device work."""
    from torch.autograd import DeviceType
    events = prof.events()
    # the ranges' own device-side annotations span them whole
    device_events = [e for e in events if e.device_type == DeviceType.CUDA
                     and e.name not in names]
    out = {"device_events": len(device_events)}
    for name in names:
        rng_ = next(e.time_range for e in events
                    if e.name == name and e.device_type == DeviceType.CPU)
        lo, hi = rng_.start, rng_.end
        spans = sorted((max(e.time_range.start, lo), min(e.time_range.end,
                                                          hi))
                       for e in device_events
                       if e.time_range.start < hi and e.time_range.end > lo)
        busy, end = 0.0, lo
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        kernels = sum(1 for e in device_events
                      if lo <= e.time_range.start < hi
                      and not e.name.startswith(("Memcpy", "Memset")))
        seen = bool(spans)
        out[name.split("_", 1)[1]] = {
            "window_ms": (hi - lo) / 1e3,
            f"ms_per_{per}": (hi - lo) / 1e3 / n,
            "busy_ms": busy / 1e3 if seen else None,
            "idle_share": 1.0 - busy / (hi - lo) if seen else None,
            f"kernels_per_{per}": kernels / n if seen else None}
    return out


def trace_prefill(torch, serve, params, cfg, device, prompt_len):
    """One wave of ``SERVE_SLOTS`` prompts of ``prompt_len`` tokens through
    ``make_prefill_fn(impl="kernel")`` (its graph captured first), then
    ``TRACE_PREFILLS`` eager prefills and ``TRACE_PREFILLS`` graph
    replays of the same wave under ``torch.profiler`` (:func:`traced`),
    and the replays that pay for the capture (capture ms ÷ the ms a
    replay saves over a warm eager prefill; None where it saves none)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    rng = np.random.default_rng(SEED + 10)
    shape = ((SERVE_SLOTS, prompt_len, cfg.n_codebooks)
             if cfg.n_codebooks > 1 else (SERVE_SLOTS, prompt_len))
    inputs = {"tokens": torch.from_numpy(rng.integers(
        1, cfg.vocab_size, shape)).to(device)}
    prefill = serve.make_prefill_fn(cfg, prompt_len + TRACE_STEPS,
                                    impl="kernel")
    with torch.inference_mode():
        prefill(params, inputs)                               # captures
        prefill.eager(params, inputs)
        torch.cuda.synchronize()
        runs = {"prefill_eager": lambda: prefill.eager(params, inputs),
                "prefill_graph": lambda: prefill(params, inputs)}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for name, run in runs.items():
                with record_function(name):
                    for _ in range(TRACE_PREFILLS):
                        run()
                    torch.cuda.synchronize()
    out = {"prefills": TRACE_PREFILLS, "graph_nodes": prefill.last.nodes,
           "graph_kernel_nodes": prefill.last.kernels,
           "capture_ms": prefill.last.capture_s * 1e3,
           **traced(prof, list(runs), TRACE_PREFILLS, "prefill")}
    saved = out["eager"]["ms_per_prefill"] - out["graph"]["ms_per_prefill"]
    out["replays_to_repay"] = out["capture_ms"] / saved if saved > 0 else None
    del prefill
    return out


def trace_decode(torch, T, serve, params, cfg, device, prompt_len):
    """One wave of ``SERVE_SLOTS`` prompts of ``prompt_len`` tokens
    prefilled (bf16 cache) by its prefill graph's first replay, the decode
    graph captured, then ``TRACE_STEPS`` eager steps (``decode_step`` on
    a copy of the cache) and ``TRACE_STEPS`` graph replays under
    ``torch.profiler`` (:func:`traced`), both at the server's
    ``impl="kernel"``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    rng = np.random.default_rng(SEED + 9)
    n = prompt_len + TRACE_STEPS + 2
    shape = ((SERVE_SLOTS, n, cfg.n_codebooks) if cfg.n_codebooks > 1
             else (SERVE_SLOTS, n))
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, shape)).to(
        device)
    prefill = serve.make_prefill_fn(cfg, n, impl="kernel")
    decode = serve.make_decode_fn(cfg, "kernel")

    def step_inputs(i):
        return {"tokens": toks[:, prompt_len + i:prompt_len + i + 1],
                "length": torch.tensor(prompt_len + i, dtype=torch.int32,
                                       device=device)}

    with torch.inference_mode():
        first = {"tokens": toks[:, :prompt_len]}
        prefill(params, first)                                # captures
        _, cache = prefill(params, first)                     # replays
        _, cache = decode(params, cache, step_inputs(0))      # captures
        eager = {k: v.clone() for k, v in cache.items()}
        T.decode_step(params, cfg, eager, step_inputs(1), impl="kernel")
        _, cache = decode(params, cache, step_inputs(1))
        torch.cuda.synchronize()
        runs = {"decode_eager": lambda i: T.decode_step(
                    params, cfg, eager, step_inputs(i), impl="kernel"),
                "decode_graph": lambda i: decode(params, cache,
                                                 step_inputs(i))}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for name, run in runs.items():
                with record_function(name):
                    for i in range(2, 2 + TRACE_STEPS):
                        run(i)
                    torch.cuda.synchronize()
    out = {"steps": TRACE_STEPS, "graph_nodes": decode.last.nodes,
           "graph_kernel_nodes": decode.last.kernels,
           **traced(prof, list(runs), TRACE_STEPS, "step")}
    del cache, eager, decode
    return out


class Tapped:
    """``fn`` that hands each result to ``tap(*result)`` before it returns
    it; every other attribute is ``fn``'s."""

    def __init__(self, fn, tap):
        self.fn, self.tap = fn, tap

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __call__(self, *args):
        out = self.fn(*args)
        self.tap(*out)
        return out


def run_server(torch, serve, params, cfg, device, impl, prompts,
               max_len=SERVE_MAX_LEN, new_tokens=SERVE_NEW_TOKENS,
               check=True):
    """Both waves through a fresh ``BatchServer``, capturing each wave's
    last-position prefill logits (every codebook's), its prefill cache,
    the two largest logits of every greedy token, and the first request's
    logits at every step (codebook 0's, which the server samples, where
    there are several), cloned from the graphs' static buffers.  With
    ``check``, every prefill is held against the eager prefill
    (:class:`CheckedPrefill`, kept as ``server.checked_prefill``) and
    every decode step against the eager step (:class:`CheckedDecode`,
    kept as ``server.checked``)."""
    from repro_torch.models import transformer as T
    server = serve.BatchServer(params, cfg, n_slots=SERVE_SLOTS,
                               max_len=max_len, impl=impl, device=device)
    captured = []
    prefill, decode = server.prefill_fn, server._decode
    server.checked = CheckedDecode(torch, T, cfg, decode) if check else None
    server.checked_prefill = (CheckedPrefill(torch, prefill) if check
                              else None)
    if check:
        prefill, decode = server.checked_prefill, server.checked
    sampled = ((lambda t: t) if cfg.n_codebooks == 1
               else (lambda t: t[:, 0]))

    def capture_prefill(logits, cache):
        last = logits[:, -1]
        captured.append({"logits": last.float().clone(),
                         "cache": {k: v.clone() for k, v in cache.items()},
                         "tops": [_top2(torch, sampled(last),
                                        cfg.vocab_size)],
                         "rows": [sampled(last)[0].float().clone()]})

    def capture_decode(p, cache, inputs):
        logits, cache = decode(p, cache, inputs)
        step = sampled(logits[:, 0])
        captured[-1]["tops"].append(_top2(torch, step, cfg.vocab_size))
        captured[-1]["rows"].append(step[0].float().clone())
        return logits, cache

    server.prefill_fn = Tapped(prefill, capture_prefill)
    server._decode = capture_decode
    for i, pr in enumerate(prompts):
        server.submit(serve.Request(request_id=f"req-{i}", prompt=pr,
                                    max_new_tokens=new_tokens))
    t0 = time.monotonic()
    done = server.run(max_requests=len(prompts), idle_timeout_s=1.0)
    torch.cuda.synchronize()
    return server, done, captured, time.monotonic() - t0


def check_served(done, n_requests, cfg, new_tokens):
    """Every request completed with ``new_tokens`` tokens in the
    vocabulary; returns the token count."""
    n_tok = sum(len(r.result_tokens) for r in done)
    if len(done) != n_requests or n_tok != n_requests * new_tokens:
        raise AssertionError(f"served {len(done)} requests, {n_tok} tokens")
    for r in done:
        if not all(0 <= t < cfg.vocab_size for t in r.result_tokens):
            raise AssertionError(f"token out of the vocabulary in {r}")
    return n_tok


def serve_stats(torch, server, done, n_tok, wall, device, read_ms=None):
    """The serving metrics of one ``run_server`` run, as ``serve``
    reports them.  A checked run's wall time, tokens/s and first-token
    latency include the eager check of every prefill and step, and its
    ``prefill_ms`` a wave's first call (for a new shape: the eager
    warm-up, the capture and :class:`CheckedPrefill`'s replay); its ``decode_ms_per_step`` is the
    graph's step (:class:`CheckedDecode`), ``prefill_graph`` and
    ``decode_graph`` have each wave's row."""
    first = np.array([r.t_first_token - r.t_submit for r in done])
    out = dict(
        requests=len(done), tokens=n_tok, wall_s=wall,
        tokens_per_s=n_tok / wall,
        first_token_ms_mean=float(first.mean() * 1e3),
        first_token_ms_p95=float(np.percentile(first, 95) * 1e3),
        prefill_ms=[w["prefill_s"] * 1e3 for w in server.waves],
        decode_ms_per_step=[float(np.mean(w["decode_s"]) * 1e3)
                            for w in server.waves],
        waves=[[w["batch"], w["prompt_len"]] for w in server.waves],
        max_memory_allocated_gb=torch.cuda.max_memory_allocated(device)
        / 1e9)
    if server.checked is not None:
        rows = graph_rows(server.checked.waves, read_ms)
        out["decode_graph"] = rows
        out["decode_ms_per_step"] = [r["graph_ms"] for r in rows]
        out["eager_decode_ms_per_step"] = [r["eager_ms"] for r in rows]
        out["graph_capture_ms"] = [w["graph_capture_s"] * 1e3
                                   for w in server.waves]
        out["prefill_graph"] = prefill_rows(server.checked_prefill.waves)
        out["prefill_capture_ms"] = [w["prefill_capture_s"] * 1e3
                                     for w in server.waves]
        out["max_memory_reserved_gb"] = torch.cuda.max_memory_reserved(
            device) / 1e9
    return out


def check_launches(checked, counters, layers):
    """A checked run's launches of each kernel on the served path (the
    counts less the checks' own, :class:`CheckedPrefill`): each wave's
    replay and each capture's eager warm-up launch the kernel once a layer
    (``layers[name]``; a capture launches nothing).  Raises otherwise, and
    where a wave's graph does not hold it once a layer, counted from its
    kernel nodes' names and by the wrappers at its capture.  Returns
    them."""
    launches = {name: c.count - checked.check_launches[name]
                for name, c in counters.items()}
    waves = len(checked.waves)
    want = {name: (waves + checked.captures) * layers[name]
            for name in counters}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want} "
                             f"((waves + captures) x layers)")
    for w in checked.waves:
        for key in ("launches", "counted"):
            got = {name: w[key].get(name, 0) for name in counters}
            if got != layers:
                raise AssertionError(f"a {w['prompt']}-token prefill graph "
                                     f"{key} {w[key]}, not {layers}")
    return launches


def check_decode_launches(checked, layers):
    """A checked run's launches of each decode kernel on the served path
    (the counts less the eager checks' own, :class:`CheckedDecode`): every
    step launches the kernel ``name`` ``layers[name]`` times (0 for an
    arch whose layers do not run it), a replay from its graph's kernel
    nodes and a capturing step in its eager warm-up.  Raises otherwise,
    and where a wave's graph does not hold ``layers[name]`` of them, read
    from its kernel nodes' names and counted by the wrapper at its
    capture.  Returns the served launches by name."""
    steps = sum(w["steps"] for w in checked.waves)
    served = {}
    for name, n in layers.items():
        served[name] = (checked.counters[name].count
                        - checked.check_launches[name])
        if served[name] != steps * n:
            raise AssertionError(f"{name} launched {served[name]} times in "
                                 f"{steps} steps, not {n} a step")
        for w in checked.waves:
            got = (w["launches"].get(name, 0), w["counted"].get(name, 0))
            if got != (n, n):
                raise AssertionError(f"a decode graph holds {got[0]} {name} "
                                     f"launches (counted {got[1]}), not {n}")
    return served


def serve_hymba(torch, serve, T, fa, ssd, device):
    """hymba-1.5b at full width through ``BatchServer`` on the card, with
    the kernel launch counts set to 0 just before and read just after."""
    from repro_torch.configs import get_arch
    cfg = get_arch(SERVE_ARCH)
    t0 = time.monotonic()
    params = T.init_params(cfg, device=device, dtype=torch.float32,
                           seed=SEED)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = T.param_count(params)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in SERVE_WAVES for _ in range(SERVE_SLOTS)]
    # warm the libraries (cuBLAS handles, allocator) on a short wave
    run_server(torch, serve, params, cfg, device, "kernel",
               [prompts[0][:64]], check=False)
    counters = {"flash_attention": fa.LAUNCHES["flash_attention"],
                "ssd_chunk_scan": ssd.LAUNCHES["ssd_chunk_scan"]}
    torch.cuda.reset_peak_memory_stats(device)
    for c in kernel_counters().values():
        c.reset()
    server, done, captured, wall = run_server(torch, serve, params, cfg,
                                              device, "kernel", prompts)
    launches = check_launches(server.checked_prefill, counters,
                              dict.fromkeys(counters, cfg.n_layers))
    launches.update(check_decode_launches(
        server.checked, {"decode_attention": cfg.n_layers,
                         "ssm_decode": cfg.n_layers}))
    read_ms = (decode_weight_bytes(cfg, params, SERVE_SLOTS)
               / HBM_BYTES_PER_S * 1e3)
    stats = serve_stats(torch, server, done,
                        check_served(done, len(prompts), cfg,
                                     SERVE_NEW_TOKENS), wall, device,
                        read_ms)
    del server
    for w in captured:
        if not bool(torch.isfinite(w["logits"]).all()) or not all(
                bool(torch.isfinite(v.float()).all())
                for v in w["cache"].values()):
            raise AssertionError("non-finite prefill logits or cache")
    emit("serve", arch=SERVE_ARCH, params=n_params, init_s=init_s, **stats,
         launches=launches, decode_weight_read_ms=read_ms,
         prefill_ops=[prefill_ops(torch, T, serve, cfg, SERVE_SLOTS, n)
                      for n in SERVE_WAVES])
    emit("decode_trace", arch=SERVE_ARCH, batch=SERVE_SLOTS,
         prompt=SERVE_WAVES[0], weight_read_ms=read_ms,
         **trace_decode(torch, T, serve, params, cfg, device,
                        SERVE_WAVES[0]))
    emit("prefill_trace", arch=SERVE_ARCH, batch=SERVE_SLOTS,
         prompt=SERVE_WAVES[0],
         **trace_prefill(torch, serve, params, cfg, device, SERVE_WAVES[0]))
    return params, cfg, prompts, done, captured, launches


def serve_vs_plain(torch, serve, fa, ssd, params, cfg, prompts, done,
                   captured, device):
    """The same waves through the same server with ``impl="dense"`` (no
    kernel: no flash, SSD or decode attention launch): prefill logits and
    captured caches within 2e-3 (a bf16 k/v entry also within one bf16
    rounding, 2^-7 of its size, since the fp32 values it rounds differ
    slightly); greedy tokens equal up to the first place where the plain
    run's top two logits lie within 1e-4."""
    counters = kernel_counters()
    before = {name: c.count for name, c in counters.items()}
    _, done_p, captured_p, wall = run_server(torch, serve, params, cfg,
                                             device, "dense", prompts,
                                             check=False)
    after = {name: c.count for name, c in counters.items()}
    if after != before:
        raise AssertionError(f"the dense path launched a kernel: {before} "
                             f"-> {after}")
    errs = hold_waves(torch, captured, captured_p)
    compared, near_ties = compare_tokens(done, done_p, captured_p,
                                         lambda top1: NEAR_TIE)
    emit("serve_vs_plain", wall_s=wall, max_abs_err=errs,
         tokens_compared=compared, near_ties=near_ties,
         tokens_equal=sum(a.result_tokens == b.result_tokens
                          for a, b in zip(done, done_p)))


def hold_waves(torch, captured, captured_p, hold=True):
    """Each wave's prefill logits and captured cache, kernel run against
    dense run: logits within 2e-3 of 1 + their size, cache entries within
    2e-3 (a bf16 k/v entry also within one bf16 rounding, 2^-7 of its
    size, since the fp32 values it rounds differ slightly); reported, not
    held, when ``hold`` is off.  Returns the largest difference of each."""
    errs = {}
    for w, (a, b) in enumerate(zip(captured, captured_p)):
        diff = (a["logits"] - b["logits"]).abs()
        errs[f"wave{w}_logits"] = float(diff.max())
        if hold and bool(
                (diff > MODEL_TOL * (1 + b["logits"].abs())).any()):
            raise AssertionError(f"wave {w}: prefill logits differ by "
                                 f"{float(diff.max())}")
        for name, ca in a["cache"].items():
            cb = b["cache"][name].float()
            diff = (ca.float() - cb).abs()
            slack = 2.0 ** -7 if ca.dtype == torch.bfloat16 else 0.0
            errs[f"wave{w}_{name}"] = float(diff.max())
            if hold and bool(
                    (diff > MODEL_TOL + (MODEL_TOL + slack) * cb.abs()).any()):
                raise AssertionError(f"wave {w}: cache {name} differs by "
                                     f"{float(diff.max())}")
    return errs


def compare_tokens(done, done_p, captured_p, tol):
    """Greedy tokens of two server runs over the same waves, equal up to
    the first place where the plain run's top two logits lie within
    ``tol(top1)`` of each other (later tokens follow other histories);
    raises on a mismatch past that.  Returns (compared, near ties)."""
    near_ties, compared = 0, 0
    for i, (a, b) in enumerate(zip(done, done_p)):
        tops = captured_p[i // SERVE_SLOTS]["tops"]
        for t, (ta, tb) in enumerate(zip(a.result_tokens, b.result_tokens)):
            compared += 1
            if ta != tb:
                top1, top2 = (float(v) for v in tops[t][i % SERVE_SLOTS])
                if top1 - top2 >= tol(top1):
                    raise AssertionError(f"{a.request_id} token {t}: "
                                         f"{ta} vs {tb}, gap {top1 - top2}")
                near_ties += 1
                break
    return compared, near_ties


def check_against_plain_path(torch, core, ml, device):
    """The same seeded messages through the processor on the card (the
    kernel) and on the host (the plain version), in order: equal outlier
    counts and versions, scores and centroids within tolerance.  The
    first message seeds the 25 centroids from its own points, and those 25
    distances sit at d ≈ 0, where the expansion cancels to an absolute
    floor of 0.05 a point: the mean score may move by 0.05 · 25 / n."""
    gen = ml.MiniAppGenerator(n_points=MAIN_SHAPE[0], seed=21)
    msgs = [gen.sample() for _ in range(8)]
    ps_card, ps_host = core.ParameterService(), core.ParameterService()
    card = ml.KMeans(device=device).make_processor(ps_card, "kmeans")
    host = ml.KMeans(device="cpu").make_processor(ps_host, "kmeans")
    worst = 0.0
    for msg in msgs:
        a, b = card(None, data=msg), host(None, data=msg)
        if a["n_outliers"] != b["n_outliers"]:
            raise AssertionError(f"n_outliers {a} vs {b}")
        diff = abs(a["mean_score"] - b["mean_score"])
        worst = max(worst, diff)
        if diff > 1e-5 * abs(b["mean_score"]) + 0.05 * 25 / MAIN_SHAPE[0]:
            raise AssertionError(f"mean_score {a} vs {b}")
    _, ta = ps_card.fetch("kmeans")
    _, tb = ps_host.fetch("kmeans")
    if ps_card.version("kmeans") != ps_host.version("kmeans"):
        raise AssertionError("parameter versions differ")
    if not np.array_equal(ta["counts"], tb["counts"]):
        raise AssertionError("counts differ between card and host")
    np.testing.assert_allclose(ta["centroids"], tb["centroids"],
                               rtol=1e-5, atol=1e-4)
    emit("check_vs_host", messages=len(msgs), mean_score_max_abs=worst,
         centroid_max_abs=float(np.abs(ta["centroids"]
                                       - tb["centroids"]).max()))


# the runtime calls that launch a kernel, as the profiler names them
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx")


def profile_messages(torch, fn, msgs):
    """The CUDA work of ``fn(msg)`` per message, from ``torch.profiler``
    over one call per message after a warm-up call (which captures a
    compiled function's graphs): the kernels' device ms, the kernels the
    card ran (a graph's kernel nodes included; copies and fills not
    counted), and the host's launches: kernel launches, graph launches
    and copies or fills; and the 5 host events with the most self time a
    message.  Before the profile, the host ms a message of one unprofiled
    pass, one message after another on this thread (no workers, no
    broker).  Raises where the profiler records no device kernel: the
    work did not run on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(msgs[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for msg in msgs:
        fn(msg)
    torch.cuda.synchronize()
    serial_ms = (time.perf_counter() - t0) / len(msgs) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for msg in msgs:
            fn(msg)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [ev for ev in events
               if getattr(ev, "device_type", None) == DeviceType.CUDA
               and not ev.key.startswith(("Memcpy", "Memset"))]
    if not kernels:
        raise AssertionError("the profiler recorded no CUDA kernel")
    calls, host_us = {}, {}
    for ev in events:
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            calls[ev.key] = calls.get(ev.key, 0) + ev.count
            host_us[ev.key] = host_us.get(ev.key, 0.0) + \
                ev.self_cpu_time_total
    n = len(msgs)
    top = sorted(host_us, key=host_us.get, reverse=True)[:5]
    return {"serial_ms_per_msg": serial_ms,
            "device_ms_per_msg": sum(ev.device_time_total
                                     for ev in kernels) / n / 1e3,
            "kernels_per_msg": sum(ev.count for ev in kernels) / n,
            "kernel_launches_per_msg": sum(calls.get(k, 0)
                                           for k in LAUNCH_APIS) / n,
            "graph_launches_per_msg": calls.get("cudaGraphLaunch", 0) / n,
            "copies_per_msg": sum(c for k, c in calls.items() if k.startswith(
                ("cudaMemcpy", "cudaMemset"))) / n,
            "top_host_ms_per_msg": {k: host_us[k] / n / 1e3 for k in top}}


# each loop runs op by op and through its graphs in turns, so that the two
# are compared within one call and neither only first or only last
TURNS = (False, True, True, False)


def loop_rates(runs):
    """Each mode's msgs/s and wall s over its turns: ``runs`` maps
    graph (a bool) to runs whose first item is a pipeline result."""
    out = {}
    for mode, graph in (("eager", False), ("graph", True)):
        out[f"{mode}_msgs_per_s"] = [r[0].throughput()["msgs_per_s"]
                                     for r in runs[graph]]
        out[f"{mode}_wall_s"] = [r[0].wall_s for r in runs[graph]]
    return out


def outlier_graph_fns():
    """The outlier models' compiled functions of module scope (the AE's
    step and update are its own)."""
    from repro_torch.ml import autoencoder as tae
    from repro_torch.ml import isoforest as tif
    from repro_torch.ml import kmeans as tkm
    return [tkm.assign_fn, tkm.assign_update_fn, tae.scores_fn, tif.fit_fn,
            tif.score_fn]


def graph_calls(fns=None):
    """Captures plus replays of ``fns`` so far (default: the module-scope
    compiled functions), to show that a phase went through them."""
    return sum(f.captures + f.replays for f in fns or outlier_graph_fns())


class GraphMeter:
    """Over a span: the captures, replays and capture ms of compiled
    functions (those given at the start, counted from there, and those
    given at the end, counted whole), the card's peak allocation, and the
    allocation and reservation held at the end beyond the start's (what
    live graphs keep: their pools, static inputs and outputs)."""

    def __init__(self, torch, fns=()):
        self.torch = torch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.alloc = torch.cuda.memory_allocated()
        self.reserved = torch.cuda.memory_reserved()
        self.start = [(f, f.captures, f.replays, f.capture_s) for f in fns]

    def read(self, more=()):
        torch = self.torch
        torch.cuda.synchronize()
        spans = self.start + [(f, 0, 0, 0.0) for f in more]
        return {"captures": sum(f.captures - c for f, c, _, _ in spans),
                "replays": sum(f.replays - r for f, _, r, _ in spans),
                "capture_ms": sum(f.capture_s - t
                                  for f, _, _, t in spans) * 1e3,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "held_gb": (torch.cuda.memory_allocated()
                            - self.alloc) / 1e9,
                "reserved_gb": (torch.cuda.memory_reserved()
                                - self.reserved) / 1e9}


def kernel_nodes(fns):
    """The kernel nodes of each function's last graph, summed: what one
    message's replays run on the card."""
    return sum(f.last.kernels for f in fns if f.last is not None)


def same_bits_np(a, b, what):
    """Two numpy trees (what a parameter service publishes) with the same
    structure, types, shapes and bits (NaN thresholds included)."""
    from torch.utils import _pytree as pytree
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    if sa != sb or len(la) != len(lb):
        raise AssertionError(f"{what}: trees differ in structure")
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{what}: {x.dtype} {x.shape} vs "
                                 f"{y.dtype} {y.shape}")
        if x.dtype.kind == "f":
            x, y = x.view(f"i{x.itemsize}"), y.view(f"i{y.itemsize}")
        if not np.array_equal(x, y):
            raise AssertionError(f"{what}: values differ")


def graph_vs_eager(torch, core, make, name, msgs, record=None):
    """The same messages through a model's processor on the card, through
    its compiled functions (``graph=True``) and op by op (``graph=False``),
    each with its own parameter service: results, published versions and
    states bit for bit, and what ``record`` (a method name) returned each
    message.  Returns the number of compiled calls the graph path made."""
    out = {}
    for graph in (True, False):
        ps = core.ParameterService()
        model = make(graph)
        seen = []
        if record is not None:
            inner = getattr(model, record)

            def recording(*args, inner=inner, seen=seen):
                res = inner(*args)
                seen.append(res[1] if isinstance(res, tuple) else None)
                return res

            setattr(model, record, recording)
        proc = model.make_processor(ps, name)
        calls = graph_calls()
        results = [proc(None, data=m) for m in msgs]
        torch.cuda.synchronize()
        out[graph] = (results, seen, ps.version(name), ps.fetch(name)[1],
                      graph_calls() - calls)
    (ra, sa, va, ta, calls), (rb, sb, vb, tb, eager_calls) = (out[True],
                                                             out[False])
    if ra != rb or sa != sb or va != vb:
        raise AssertionError(f"{name} graph vs eager: {ra} / {sa} / {va} "
                             f"vs {rb} / {sb} / {vb}")
    same_bits_np(ta, tb, f"{name} graph vs eager, published state")
    if eager_calls != 0 or calls < len(msgs):
        raise AssertionError(f"{name}: {calls} compiled calls for "
                             f"{len(msgs)} messages, {eager_calls} eager")
    return calls


def kmeans_vs_eager(torch, core, ml, device):
    """8 seeded messages of 10,000 × 32 through the k-means processor's
    graphs (the kernel inside) and op by op on the card: bit for bit."""
    gen = ml.MiniAppGenerator(n_points=MAIN_SHAPE[0], seed=21)
    msgs = [gen.sample() for _ in range(8)]
    calls = graph_vs_eager(torch, core, lambda g: ml.KMeans(
        device=device, graph=g), "kmeans", msgs)
    emit("kmeans_vs_eager", messages=len(msgs), bitwise=True,
         graph_calls=calls)


def ae_vs_eager(torch, core, ml, device):
    """8 seeded messages through the AE processor's graphs (scores, and
    the update with its backward and AdamW) and op by op on the card:
    results, losses and the published state bit for bit."""
    gen = ml.MiniAppGenerator(n_points=MAIN_SHAPE[0], seed=21)
    msgs = [gen.sample() for _ in range(8)]
    calls = graph_vs_eager(torch, core, lambda g: ml.AutoEncoder(
        device=device, graph=g), "ae", msgs, record="update")
    emit("ae_vs_eager", messages=len(msgs), bitwise=True,
         graph_calls=calls)


def iforest_vs_eager(torch, core, ml, device):
    """8 seeded messages through the forest processor's graphs (the
    seeded fit, the score) and op by op on the card: results and the
    published forest (NaN thresholds too) bit for bit, each message's fit
    from the same seeded streams."""
    gen = ml.MiniAppGenerator(n_points=MAIN_SHAPE[0], seed=21)
    msgs = [gen.sample() for _ in range(8)]
    calls = graph_vs_eager(torch, core, lambda g: ml.IsolationForest(
        device=device, graph=g), "iforest", msgs)
    emit("iforest_vs_eager", messages=len(msgs), bitwise=True,
         graph_calls=calls)


def on_card(torch, tree, what):
    """``tree`` after checking that it holds tensors and that every array
    in it is a tensor on the card (plain numbers are let through)."""
    from torch.utils import _pytree as pytree
    arrays = [x for x in pytree.tree_leaves(tree)
              if isinstance(x, (torch.Tensor, np.ndarray))]
    if not arrays or not all(isinstance(x, torch.Tensor)
                             and x.device.type == "cuda" for x in arrays):
        raise AssertionError(f"{what} is not on the card")
    return tree


def check_on_card(torch, obj, method, what):
    """Wrap ``obj.method`` so that every result it returns is checked
    with ``on_card``."""
    inner = getattr(obj, method)

    def checked(*args, **kwargs):
        return on_card(torch, inner(*args, **kwargs), what)

    setattr(obj, method, checked)


def cloud_loop(core, ml, handler, n_messages, model, seed):
    """``run_pipeline``'s closed loop for another cloud processor: 4 edge
    producers of 10,000 × 32 messages, 4 cloud workers on one card."""
    manager = core.PilotManager()
    edge = manager.submit_pilot(core.ComputeResource(
        tier="edge", n_workers=4, memory_gb=4))
    cloud = manager.submit_pilot(core.ComputeResource(
        tier="cloud", n_devices=1, n_workers=4, memory_gb=44))
    gen = ml.MiniAppGenerator(n_points=MAIN_SHAPE[0], n_clusters=25,
                              seed=seed)

    def process_edge(context, data=None):
        return data[np.isfinite(data).all(axis=1)]

    res = core.EdgeToCloudPipeline(
        pilot_cloud_processing=cloud, pilot_edge=edge,
        produce_function_handler=gen.make_producer(),
        process_edge_function_handler=process_edge,
        process_cloud_function_handler=handler,
        function_context={"model": model},
    ).run(n_messages=n_messages, timeout_s=LOOP_TIMEOUT_S)
    manager.release_all()
    if res.n_processed != n_messages:
        raise AssertionError(f"{model}: processed {res.n_processed}/"
                             f"{n_messages}")
    for r in res.results:
        if not (np.isfinite(r["mean_score"]) and r["n_outliers"] >= 0):
            raise AssertionError(f"{model}: bad result {r}")
    return res


def advise(core, cost):
    """``placement="advise"`` for k-means and the auto-encoder on a port
    pipeline at the paper's largest message: the best placement per band
    and the wall time of each advisory grid.  Checks 5 finite rows a band
    for both, and tests/test_cost.py's Fig-3 pin for k-means: it goes to
    the edge (or hybrid) at 10 Mbit/s."""
    manager = core.PilotManager(devices=())
    edge = manager.submit_pilot(core.ComputeResource(tier="edge",
                                                     n_workers=4))
    cloud = manager.submit_pilot(core.ComputeResource(tier="cloud",
                                                      n_workers=4))
    out = {}
    for model in ("kmeans", "autoencoder"):
        pipe = core.EdgeToCloudPipeline(
            pilot_cloud_processing=cloud, pilot_edge=edge,
            produce_function_handler=lambda ctx: None,
            process_cloud_function_handler=lambda ctx, data=None: None,
            function_context={"model": model, "n_points": MAIN_SHAPE[0]})
        t0 = time.perf_counter()
        rep = pipe.run(placement="advise")
        wall = time.perf_counter() - t0
        if not isinstance(rep, cost.AdvisorReport) or rep.model != model:
            raise AssertionError(f"advise({model}) returned {rep!r}")
        bands = list(dict.fromkeys(c.wan_band for c in rep.cells))
        if len(rep.rows()) != 5 * len(bands) or not all(
                np.isfinite(r["msgs_per_s"]) for r in rep.rows()):
            raise AssertionError(f"advise({model}): bad rows")
        out[model] = {"best": {b: rep.best(b).placement for b in bands},
                      "wall_s": wall}
    manager.release_all()
    if out["kmeans"]["best"]["10mbit"] not in ("edge", "hybrid"):
        raise AssertionError(f"k-means at 10 Mbit/s: {out['kmeans']}")
    emit("advise", models=out)
    return out


def ae_bound(n, sizes):
    """Least time for one AE processor message of n points on this card:
    the larger of its bytes (points read once, scores written once, the
    params and both Adam moments read and written once) over HBM bandwidth
    and its fp32 flops over the fp32 peak.  Flops: a scoring forward, the
    training forward, a backward of twice the forward and the post-step
    loss's forward, 2·din·dout a point and layer each.  Also returns the
    flops and the activations one forward writes (MB), for the record."""
    macs = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    n_params = macs + sum(sizes[1:])
    flops = 5 * 2.0 * n * macs
    nbytes = n * sizes[0] * 4 + n * 4 + 2 * 3 * n_params * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["fp32"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops,
            n * sum(sizes[1:]) * 4 / 1e6)


def iforest_bound(n, f, n_trees, n_nodes, depth):
    """Least time for one isolation-forest message (refit, then score):
    the points read once, the forest (int32 feature, fp32 threshold and
    size, bool leaf flag a node) and the scores written once, over HBM
    bandwidth; against a compare and a select a point, tree and level
    over the fp32 peak."""
    nbytes = n * f * 4 + n_trees * n_nodes * 13 + n * 4
    ops = 2.0 * n * n_trees * depth
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS["fp32"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def run_ae_pipeline(torch, core, ml, device):
    """The auto-encoder processor in ``run_pipeline``'s closed loop on the
    card, op by op (``graph=False``) and through its compiled functions
    (one graph for the scores, one for the update: the normalisation,
    autograd's backward and AdamW): 64 training messages each, then 8
    inference messages from the published state through the graphs; the
    device time, kernels and host launches a message from the profiler.
    The 4 cloud workers share the processor's state without a lock, as in
    the reference, so concurrent updates are lost: in lock step one update
    in 4 is kept (tests/test_torch_autoencoder.py,
    ``test_concurrent_workers_lose_updates_as_the_reference``), and the
    published step must reach that floor."""
    fns = outlier_graph_fns()
    runs = {False: [], True: []}
    for graph in TURNS:
        params = core.ParameterService()
        ae = ml.AutoEncoder(device=device, graph=graph)
        check_on_card(torch, ae, "update", "the AE's trained state")
        check_on_card(torch, ae, "outlier_scores", "the AE's scores")
        meter = GraphMeter(torch, fns)
        res = cloud_loop(core, ml, ae.make_processor(params, "autoencoder"),
                         AE_MESSAGES, "autoencoder", seed=7)
        stats = meter.read([ae._update])
        version, tree = params.fetch("autoencoder")
        floor = AE_MESSAGES // 4
        if version != AE_MESSAGES or int(tree["step"]) < floor or not all(
                np.isfinite(p[k]).all() for p in tree["params"]
                for k in ("w", "b")):
            raise AssertionError(f"published AE state is wrong (version "
                                 f"{version}, step {int(tree['step'])})")
        if (stats["captures"] + stats["replays"] >= 2 * AE_MESSAGES) != graph:
            raise AssertionError(f"graph={graph}: {stats}")
        runs[graph].append((res, stats, version, tree, ae, params))
    res, _, version, tree, ae, params = runs[True][-1]
    stats, stats_e = runs[True][0][1], runs[False][0][1]
    res_inf = cloud_loop(core, ml,
                         ae.make_processor(params, "autoencoder",
                                           train=False),
                         8, "autoencoder", seed=8)
    if params.version("autoencoder") != AE_MESSAGES:
        raise AssertionError("inference published a version")
    gen = ml.MiniAppGenerator(n_points=MAIN_SHAPE[0], seed=9)
    msgs = [gen.sample() for _ in range(8)]
    prof = {}
    for graph in (False, True):
        ae_prof = ml.AutoEncoder(device=device, graph=graph)
        check_on_card(torch, ae_prof, "update", "the AE's trained state")
        proc = ae_prof.make_processor(core.ParameterService(), "autoencoder")
        prof["graph" if graph else "eager"] = profile_messages(
            torch, lambda m: proc(None, data=m), msgs)
    prof["graph"]["kernel_nodes_per_msg"] = kernel_nodes(
        [outlier_graph_fns()[2], ae_prof._update])
    sizes = [tree["params"][0]["w"].shape[0]] + [
        p["w"].shape[1] for p in tree["params"]]
    bound, bound_by, flops, act_mb = ae_bound(MAIN_SHAPE[0], sizes)
    emit("ae_pipeline", n_processed=res.n_processed, wall_s=res.wall_s,
         msgs_per_s=res.throughput()["msgs_per_s"], **loop_rates(runs),
         inference_msgs_per_s=res_inf.throughput()["msgs_per_s"],
         n_inference=res_inf.n_processed, params_version=version,
         steps={mode: [int(r[3]["step"]) for r in runs[graph]]
                for mode, graph in (("eager", False), ("graph", True))},
         step_floor=AE_MESSAGES // 4, graph=stats, eager=stats_e,
         profile=prof, bound_ms=bound, bound_by=bound_by,
         gflop_per_msg=flops / 1e9, activation_mb_per_forward=act_mb)


def ae_vs_host(torch, core, ml, device):
    """The same 8 seeded messages through the AE processor on the card and
    on the host from one initial state: equal outlier counts and versions;
    mean scores and losses within 1e-5 relative and the final params within
    5e-5 (tests/test_torch_autoencoder.py's tolerances against the
    reference: Adam scales each element's step to about lr, so a gradient
    that differs by a rounding moves a param where |g| ~ sqrt(nu))."""
    gen = ml.MiniAppGenerator(n_points=MAIN_SHAPE[0], seed=21)
    msgs = [gen.sample() for _ in range(8)]
    init = ml.AutoEncoder(device="cpu").init()
    losses = {}
    results = {}
    trees = {}
    for name, dev in (("card", device), ("host", "cpu")):
        ps = core.ParameterService()
        ps.publish("ae", init)
        ae = ml.AutoEncoder(device=dev)
        seen = losses.setdefault(name, [])
        update = ae.update

        def recording(state, points, update=update, seen=seen, name=name):
            new, loss = update(state, points)
            if name == "card":
                on_card(torch, new, "the card processor's state")
            seen.append(loss)
            return new, loss

        ae.update = recording
        proc = ae.make_processor(ps, "ae")
        results[name] = [proc(None, data=m) for m in msgs]
        trees[name] = ps.fetch("ae")
    worst_score = worst_loss = 0.0
    for a, b in zip(results["card"], results["host"]):
        if a["n_outliers"] != b["n_outliers"]:
            raise AssertionError(f"n_outliers {a} vs {b}")
        err = abs(a["mean_score"] - b["mean_score"]) / abs(b["mean_score"])
        worst_score = max(worst_score, err)
    for a, b in zip(losses["card"], losses["host"]):
        worst_loss = max(worst_loss, abs(a - b) / abs(b))
    (va, ta), (vb, tb) = trees["card"], trees["host"]
    param_err = max(float(np.abs(pa[k] - pb[k]).max())
                    for pa, pb in zip(ta["params"], tb["params"])
                    for k in ("w", "b"))
    if va != vb or not int(ta["step"]) == int(tb["step"]) == len(msgs):
        raise AssertionError(f"versions {va}/{vb}, steps {ta['step']}/"
                             f"{tb['step']}")
    if worst_score > 1e-5 or worst_loss > 1e-5 or param_err > 5e-5:
        raise AssertionError(f"AE card vs host: mean_score {worst_score}, "
                             f"loss {worst_loss}, params {param_err}")
    emit("ae_vs_host", messages=len(msgs), mean_score_max_rel=worst_score,
         loss_max_rel=worst_loss, param_max_abs=param_err,
         n_outliers=[r["n_outliers"] for r in results["card"]])


def run_iforest_pipeline(torch, core, ml, device):
    """The isolation-forest processor (100 trees, refit per message) in
    the same closed loop on the card for 16 messages, op by op
    (``graph=False``) and through its compiled fit (seeded again before
    every replay) and score; device time, kernels and host launches a
    message from the profiler."""
    fns = outlier_graph_fns()
    runs = {False: [], True: []}
    for graph in TURNS:
        params = core.ParameterService()
        forest = ml.IsolationForest(device=device, graph=graph)
        check_on_card(torch, forest, "fit", "the fitted forest")
        check_on_card(torch, forest, "outlier_scores", "the forest's scores")
        meter = GraphMeter(torch, fns)
        res = cloud_loop(core, ml, forest.make_processor(params, "iforest"),
                         IFOREST_MESSAGES, "isoforest", seed=7)
        stats = meter.read()
        version, tree = params.fetch("iforest")
        if version != IFOREST_MESSAGES or tree["forest"]["size"].shape != (
                100, 511):
            raise AssertionError(f"published forest is wrong ({version})")
        if (stats["captures"] + stats["replays"]
                >= 2 * IFOREST_MESSAGES) != graph:
            raise AssertionError(f"graph={graph}: {stats}")
        runs[graph].append((res, stats, tree))
    res, _, tree = runs[True][-1]
    stats, stats_e = runs[True][0][1], runs[False][0][1]
    gen = ml.MiniAppGenerator(n_points=MAIN_SHAPE[0], seed=9)
    msgs = [gen.sample() for _ in range(4)]
    prof = {}
    for graph in (False, True):
        forest_prof = ml.IsolationForest(device=device, graph=graph)
        check_on_card(torch, forest_prof, "fit", "the fitted forest")
        proc = forest_prof.make_processor()
        prof["graph" if graph else "eager"] = profile_messages(
            torch, lambda m: proc(None, data=m), msgs)
    prof["graph"]["kernel_nodes_per_msg"] = kernel_nodes(fns[3:])
    n_trees, n_nodes = tree["forest"]["size"].shape
    bound, bound_by = iforest_bound(MAIN_SHAPE[0], MAIN_SHAPE[1], n_trees,
                                    n_nodes, forest_prof.max_depth)
    emit("iforest_pipeline", n_processed=res.n_processed, wall_s=res.wall_s,
         msgs_per_s=res.throughput()["msgs_per_s"], **loop_rates(runs),
         params_version=IFOREST_MESSAGES,
         graph=stats, eager=stats_e, profile=prof, bound_ms=bound,
         bound_by=bound_by)


def _auc(s, is_out):
    order = np.argsort(s)
    ranks = np.empty_like(order, float)
    ranks[order] = np.arange(len(s))
    return float((ranks[is_out].mean() - ranks.mean()) / len(s) + 0.5)


def iforest_vs_host(torch, ml, device):
    """One forest built on the host and moved to the card scores the same
    10,000 points on both: equal leaves and depths in every tree, scores
    within 1e-6.  Then the card's own fit passes tests/test_ml.py:83-96's
    band: outlier mean above inlier mean + 0.05, AUC > 0.85."""
    from repro_torch.ml import isoforest as tif
    pts, _ = ml.MiniAppGenerator(n_points=MAIN_SHAPE[0], outlier_frac=0.02,
                                 seed=5).sample_with_labels()
    host = ml.IsolationForest(device="cpu")
    card = ml.IsolationForest(device=device)
    st = host.fit(pts)
    st_card = {"forest": {k: v.to(device) for k, v in st["forest"].items()},
               "psi": st["psi"].to(device)}
    x = torch.as_tensor(pts, dtype=torch.float32)
    node_h, depth_h = tif._walk(st["forest"], x, host.max_depth)
    node_c, depth_c = tif._walk(st_card["forest"], x.to(device),
                                host.max_depth)
    if not (torch.equal(node_c.cpu(), node_h)
            and torch.equal(depth_c.cpu(), depth_h)):
        raise AssertionError("leaves or depths differ between card and host")
    on_card(torch, st_card, "the moved forest")
    s_card = on_card(torch, card.outlier_scores(st_card, pts),
                     "the card's scores").cpu().numpy()
    s_host = host.outlier_scores(st, pts).numpy()
    err = float(np.abs(s_card - s_host).max())
    if err > 1e-6:
        raise AssertionError(f"iforest scores differ by {err}")
    band_pts, is_out = ml.MiniAppGenerator(
        n_points=1_500, outlier_frac=0.03, seed=4).sample_with_labels()
    own = ml.IsolationForest(n_trees=50, device=device)
    own_state = on_card(torch, own.fit(band_pts), "the card's own fit")
    s = own.outlier_scores(own_state, band_pts).cpu().numpy()
    gap = float(s[is_out].mean() - s[~is_out].mean())
    auc = _auc(s, is_out)
    if gap <= 0.05 or auc <= 0.85:
        raise AssertionError(f"card fit: gap {gap}, AUC {auc}")
    emit("iforest_vs_host", points=len(pts), score_max_abs_err=err,
         leaves_equal=True, depths_equal=True, own_fit_gap=gap,
         own_fit_auc=auc)


def outlier_example(torch, kk, device):
    """``repro_torch.examples.edge_to_cloud_outlier.main`` on the card,
    with the k-means launch counts set to 0 just before and read just
    after: every message processed, the fault retried, the swap to the
    auto-encoder recorded, the k-means kernel launched."""
    from repro_torch.examples import edge_to_cloud_outlier as example
    for counter in kk.LAUNCHES.values():
        counter.reset()
    calls = graph_calls()
    t0 = time.perf_counter()
    out = example.main(device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.count for name, c in kk.LAUNCHES.items()}
    calls = graph_calls() - calls
    if calls < out["n_processed"]:
        raise AssertionError(f"outlier example: {calls} compiled calls")
    if out["n_processed"] != out["n_messages"]:
        raise AssertionError(f"example processed {out['n_processed']}/"
                             f"{out['n_messages']}")
    if not out["fault_fired"] or out["retries"] < 1:
        raise AssertionError("the injected fault was not retried")
    if out["swaps"] != ["process_cloud"]:
        raise AssertionError(f"swaps {out['swaps']}")
    if launches["kmeans_assign_update"] < 1:
        raise AssertionError("the example launched no k-means kernel")
    emit("outlier_example", n_messages=out["n_messages"],
         n_processed=out["n_processed"], wall_s=wall,
         run_wall_s=out["wall_s"], msgs_per_s=out["msgs_per_s"],
         advise_wall_s=out["advise_wall_s"], advice=out["advice"],
         retries=out["retries"], swaps=out["swaps"],
         autoscale=out["autoscale"], kmeans_messages=out["kmeans_messages"],
         params_versions=out["params_versions"], launches=launches,
         graph_calls=calls)


# --- training (internlm2-1.8b at full width; mamba2-130m for resume) ------


def train_flops(cfg, batch, seq, remat=True):
    """fp32 matmul operations of one dense train step, from the shapes:
    the projections, the FFN and the dense attention's two products (all
    S² pairs: the dense path masks after the product) in every layer and
    the head; backward twice the forward, and with remat the layers'
    forward once more."""
    d, h, kv, hd, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.n_layers)
    tok = batch * seq
    n_ffn = 3 if cfg.ffn_kind == "swiglu" else 2
    layer = (2 * tok * (d * h * hd + 2 * d * kv * hd + h * hd * d
                        + n_ffn * d * cfg.d_ff)
             + 4 * batch * h * seq * seq * hd)
    fwd = L * layer + 2 * tok * d * cfg.padded_vocab_size
    return 3 * fwd + (L * layer if remat else 0)


def profile_step(torch, fn):
    """``(device_ms, launches)`` of one call of ``fn`` from
    ``torch.profiler``: the CUDA kernels' time and count, copies and
    fills not counted.  Raises where no CUDA kernel was recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if getattr(ev, "device_type", None) == DeviceType.CUDA
               and not ev.key.startswith(("Memcpy", "Memset"))]
    if not kernels:
        raise AssertionError("the profiler recorded no CUDA kernel")
    return (sum(ev.device_time_total for ev in kernels) / 1e3,
            sum(ev.count for ev in kernels), out)


def _max_abs(torch, a, b):
    from torch.utils import _pytree as pytree
    return max(float((x.float().cpu() - y.float().cpu()).abs().max())
               for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))


def timed_steps(torch, TS, eager):
    """Wrap ``TS.make_train_fn`` so that every step of the train function
    it makes (its eager step, ``make_train_step``, where ``eager``)
    records a CUDA event as its work is queued.  Returns (events, made,
    restore): the events of consecutive steps bound each step on the
    device's timeline, idle time waiting for the host included, without
    a host sync; ``made`` holds the train functions made."""
    make = TS.make_train_fn
    events, made = [], []

    def timed_make(*args, **kwargs):
        fn = make(*args, **kwargs)
        made.append(fn)
        step = fn.eager if eager else fn

        def timed(*a, **kw):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            return step(*a, **kw)
        return timed

    def restore():
        TS.make_train_fn = make

    TS.make_train_fn = timed_make
    return events, made, restore


def _train_run(torch, TL, TS, cfg, tc, device, eager):
    """``train_loop`` for ``TRAIN_STEPS`` steps, its step the graph of
    ``make_train_fn`` or, where ``eager``, that function's eager step.
    The loss is read back at the first and last step only (so the host
    draws the next batch while the card runs the step, as with the
    default log_every).  Returns (measurements, params, state, the train
    function)."""
    stamps = []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    compute_grads = TS.compute_grads
    check_on_card(torch, TS, "compute_grads", "the gradients")
    events, made, restore = timed_steps(torch, TS, eager)
    try:
        t0 = time.perf_counter()
        params, state, hist = TL.train_loop(
            cfg, tc, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
            seed=0, log_every=TRAIN_STEPS, device=device,
            log=lambda _: stamps.append(time.perf_counter()))
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
    finally:
        TS.compute_grads = compute_grads
        restore()
    on_card(torch, params, "the trained params")
    on_card(torch, state, "the train state")
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    if len(hist) != 2 or not all(np.isfinite(losses + gnorms)):
        raise AssertionError(f"non-finite loss or grad norm: {hist}")
    if int(state["step"]) != TRAIN_STEPS:
        raise AssertionError(f"step {int(state['step'])}")
    events.append(end)
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    median_ms = statistics.median(step_ms[2:])          # steps 3-8
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"wall_s": wall, "step_ms_each": step_ms, "step_ms": median_ms,
           "tokens_per_s": tokens / median_ms * 1e3,
           "tokens_per_s_wall_steps_2_8": (TRAIN_STEPS - 1) * tokens
           / (stamps[-1] - stamps[0]),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "loss": losses, "grad_norm": gnorms}
    return out, params, state, made[0]


def _enqueue_ms(torch, fn):
    """The host's ms to queue ``fn()`` (the card runs meanwhile: where the
    launch queue fills, this includes waiting for the card)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    ms = 1e3 * (time.perf_counter() - t)
    torch.cuda.synchronize()
    del out
    return ms


def train_full(torch, TL, TS, T, device):
    """internlm2-1.8b at full width and depth through ``train_loop``:
    fp32 params and AdamW moments, remat on, dense attention, 4 × 1,024
    tokens a step from ``make_batch_iterator(seed=0)``, 8 steps, first
    with the train function's eager step, then, after freeing that run,
    through its CUDA graph (``make_train_fn``, the loop's own step); each
    then one more step under the profiler, and one timed on the host.
    The graph's losses and grad norms at steps 1 and 8 and its params
    after step 8 equal the eager run's bit for bit."""
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_arch
    from repro_torch.data import make_batch_iterator
    cfg = get_arch(TRAIN_ARCH)
    tc = TS.TrainConfig(lr=3e-4, warmup=10, total_steps=TRAIN_STEPS)
    it = make_batch_iterator(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                             device="cpu")
    t = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        next(it)
    data_ms = 1e3 * (time.perf_counter() - t) / TRAIN_STEPS
    batch = {k: v.to(device) for k, v in next(it).items()}
    rows = {}

    eager, params, state, fn = _train_run(torch, TL, TS, cfg, tc, device,
                                          eager=True)
    p0 = T.init_params(cfg, device=device, seed=0)     # train_loop's init
    still = sum(torch.equal(a, b) for a, b in zip(
        pytree.tree_leaves(params), pytree.tree_leaves(p0)))
    del p0
    if still:
        raise AssertionError(f"{still} parameter leaves did not move")
    eager["device_ms_per_step"], eager["launches_per_step"], out = \
        profile_step(torch, lambda: fn.eager(params, state, batch))
    del out
    # of the host's time to queue one step, the forward and backward's
    compute_grads, grads_ms = TS.compute_grads, []

    def timed_grads(*a, **kw):
        t = time.perf_counter()
        out = compute_grads(*a, **kw)
        grads_ms.append(1e3 * (time.perf_counter() - t))
        return out

    TS.compute_grads = timed_grads
    try:
        eager["host_enqueue_ms"] = _enqueue_ms(
            torch, lambda: fn.eager(params, state, batch))
    finally:
        TS.compute_grads = compute_grads
    eager["host_enqueue_grads_ms"] = grads_ms[0]
    n_params = T.param_count(params)
    want = [t.cpu() for t in pytree.tree_leaves(params)]
    rows["eager"] = eager
    del params, state, fn

    graph, params, state, fn = _train_run(torch, TL, TS, cfg, tc, device,
                                          eager=False)
    for key in ("loss", "grad_norm"):
        if graph[key] != eager[key]:
            raise AssertionError(f"graph {key} at steps 1 and 8 "
                                 f"{graph[key]} != eager {eager[key]}")
    differ = sum(not torch.equal(a.cpu(), b) for a, b in zip(
        pytree.tree_leaves(params), want))
    del want
    if differ:
        raise AssertionError(f"{differ} param leaves of the graph differ "
                             f"from the eager run's after 8 steps")
    g = fn.last
    if fn.captures != 1 or g is None:
        raise AssertionError(f"{fn.captures} train graphs captured")
    graph.update(nodes=g.nodes, kernel_nodes=g.kernels,
                 capture_ms=1e3 * fn.capture_s)
    graph["device_ms_per_step"], graph["launches_per_step"], out = \
        profile_step(torch, lambda: fn(params, state, batch))
    del out
    graph["host_enqueue_ms"] = _enqueue_ms(
        torch, lambda: fn(params, state, batch))
    rows["graph"] = graph
    for row in rows.values():
        row["device_idle_share"] = 1 - row["device_ms_per_step"] / \
            row["step_ms"]
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    emit("train", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         steps=TRAIN_STEPS, dtype="fp32", remat=True, impl="dense",
         data_ms=data_ms, static_gb_12B_per_param=12 * n_params / 1e9,
         state_gb_16B_per_param=16 * n_params / 1e9,
         graph_equals_eager="losses and grad norms at steps 1 and 8, "
         "params after 8, bit for bit",
         tflop_per_step=flops / 1e12,
         bound_ms=flops / PEAK_FLOPS["fp32"] * 1e3, bound_by="operations",
         **{f"{k}_{name}": v for name, row in rows.items()
            for k, v in row.items()})
    del params, state, fn
    torch.cuda.empty_cache()


def train_vs_host(torch, TS, T, device):
    """internlm2-1.8b at full width with its depth cut to 2 layers, 2 × 128
    tokens: the same weights (made on the host from a seed, copied to the
    card) and the same batches through three steps of ``make_train_fn``
    on the card (its first call eager, then two replays of its graph)
    and of ``make_train_step`` on the host."""
    import dataclasses
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_arch
    from repro_torch.data import make_batch_iterator
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=2)
    tc = TS.TrainConfig(lr=3e-4, warmup=10, total_steps=TRAIN_STEPS)
    host = torch.device("cpu")
    params_h, state_h = TS.init_train_state(cfg, tc, seed=1, device=host)
    params_c = pytree.tree_map(lambda t: t.to(device), params_h)
    state_c = pytree.tree_map(lambda t: t.to(device), state_h)
    it = make_batch_iterator(cfg, 2, 128, seed=0, device=host)
    fn = TS.make_train_fn(cfg, tc)
    step = TS.make_train_step(cfg, tc)
    rows = []
    for i in range(3):
        batch = next(it)
        params_c, state_c, mc = fn(params_c, state_c,
                                   {k: v.to(device)
                                    for k, v in batch.items()})
        params_h, state_h, mh = step(params_h, state_h, batch)
        row = {k: abs(float(mc[k]) - float(mh[k])) / abs(float(mh[k]))
               for k in ("loss", "grad_norm")}
        rows.append(row)
        if max(row.values()) > 1e-4:
            raise AssertionError(f"step {i + 1}: card and host differ {row}")
    on_card(torch, (params_c, state_c), "the card's train state")
    worst = _max_abs(torch, params_c, params_h)
    if worst > 5e-5:
        raise AssertionError(f"params differ by {worst} after 3 steps")
    if fn.captures != 1 or fn.last is None:
        raise AssertionError(f"{fn.captures} train graphs captured")
    emit("train_vs_host", arch=cfg.name, reduced="n_layers 24 -> 2",
         d_model=cfg.d_model, batch=2, seq=128, steps=3,
         card_step="make_train_fn: 1 capture, 2 replays",
         graph_kernel_nodes=fn.last.kernels,
         rel_diff_per_step=rows, params_max_abs=worst, tol_rel=1e-4,
         tol_params=5e-5)


def train_resume(torch, TL, TS, device):
    """mamba2-130m at full width (d_model 768) with 2 layers, 2 × 256
    tokens, lr 1e-3: 4 steps with a checkpoint, resumed to 8, against a
    straight run to 8 (the reference test's 1e-6).  The SSD path's
    backward runs on the card."""
    import dataclasses
    import shutil
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch("mamba2-130m"), n_layers=2)
    tc = TS.TrainConfig(lr=1e-3, warmup=2, total_steps=8)
    ckpt = Path(__file__).resolve().parent / "build" / "train_resume"
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(batch=2, seq_len=256, device=device, log=lambda _: None)
    TL.train_loop(cfg, tc, steps=4, ckpt_dir=str(ckpt), ckpt_every=4, **kw)
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*")
                     if f.is_file())
    logs = []
    p_res, _, _ = TL.train_loop(cfg, tc, steps=8, ckpt_dir=str(ckpt),
                                ckpt_every=4, **{**kw, "log": logs.append})
    if "resumed from step 4" not in logs:
        raise AssertionError(f"did not resume: {logs}")
    p_str, _, _ = TL.train_loop(cfg, tc, steps=8, **kw)
    on_card(torch, p_res, "the resumed params")
    worst = 0.0
    from torch.utils import _pytree as pytree
    for a, b in zip(pytree.tree_leaves(p_res), pytree.tree_leaves(p_str)):
        if not bool(torch.isfinite(b).all()):
            raise AssertionError("the straight run's params are not finite")
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
        worst = max(worst, float((a - b).abs().max()))
    shutil.rmtree(ckpt, ignore_errors=True)
    emit("train_resume", arch=cfg.name, reduced="n_layers 24 -> 2",
         d_model=cfg.d_model, batch=2, seq=256, steps="4 + 4 vs 8",
         params_max_abs=worst, tol=1e-6, checkpoint_bytes=ckpt_bytes)


def step_run(torch, make_fn, init, batches, device, graph, keep=(),
             snap=lambda params, state: params, profile=True):
    """``len(batches)`` steps of the train function ``make_fn()`` from
    ``init()``: through its CUDA graph where ``graph``, else its eager
    step (each step's trees fed to the next), each timed on the host to a
    synchronize; then, where ``profile``, one more step under
    ``profile_step`` (the eager step, or a replay, which moves the
    graph's buffers on).  Returns (the run's row: metrics, step ms each
    and their median after the first, tokens a second, peak GB allocated
    and reserved, device ms, launches and idle share of the profiled step,
    the host's ms to queue one more and, through the graph, its capture
    ms, nodes and kernel nodes;
    ``snap(params, state)``'s leaves on the host after each step in
    ``keep``).  The function, its graphs and its trees are freed before
    it returns."""
    from torch.utils import _pytree as pytree
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, state = init()
    fn = make_fn()
    step = fn if graph else fn.eager
    metrics, ms, kept = [], [], {}
    for i, b in enumerate(batches, 1):
        b = {k: v.to(device) for k, v in b.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step(params, state, b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        metrics.append({k: float(v) for k, v in m.items()})
        if i in keep:
            kept[i] = [x.to("cpu", copy=True) for x in
                       pytree.tree_leaves(snap(params, state))]
    on_card(torch, (params, state), "the train state")
    if not all(np.isfinite([v for m in metrics for v in m.values()])):
        raise AssertionError(f"non-finite metrics: {metrics}")
    step_ms = statistics.median(ms[1:] or ms)
    row = {"metrics": metrics, "step_ms_each": ms, "step_ms": step_ms,
           "tokens_per_s": b["labels"].numel() / step_ms * 1e3,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}
    if graph:
        if fn.captures != 1 or fn.last is None:
            raise AssertionError(f"{fn.captures} train graphs captured")
        row.update(capture_ms=1e3 * fn.capture_s, nodes=fn.last.nodes,
                   kernel_nodes=fn.last.kernels)
    if profile:
        dev_ms, launches, out = profile_step(
            torch, lambda: step(params, state, b))
        del out
        row.update(device_ms_per_step=dev_ms, launches_per_step=launches,
                   device_idle_share=1 - dev_ms / step_ms,
                   host_enqueue_ms=_enqueue_ms(
                       torch, lambda: step(params, state, b)))
    del params, state, step, fn
    torch.cuda.empty_cache()
    return row, kept


def graph_equals_eager(torch, eager, graph, kept_eager, kept_graph, what):
    """Raise unless the graph run's metrics at every step and its kept
    leaves (on the host) equal the eager run's bit for bit."""
    if graph["metrics"] != eager["metrics"]:
        raise AssertionError(f"{what}: graph metrics {graph['metrics']} != "
                             f"eager {eager['metrics']}")
    differ = sum(not torch.equal(a, b)
                 for a, b in zip(kept_eager, kept_graph))
    if differ or len(kept_eager) != len(kept_graph):
        raise AssertionError(f"{what}: {differ} of {len(kept_eager)} "
                             f"leaves of the graph differ from the eager "
                             f"run's")


def nccl_trace(torch):
    """The NCCL flight recorder's entries counted by collective and state
    (``torch._C._distributed_c10d._dump_nccl_trace``), or the error the
    dump raised: an entry the watchdog has seen complete reads
    "completed"."""
    import pickle
    from collections import Counter
    try:
        dump = torch._C._distributed_c10d._dump_nccl_trace(
            includeCollectives=True, includeStackTraces=False,
            onlyActive=False)
    except (AttributeError, RuntimeError, TypeError) as e:
        return {"error": f"{type(e).__name__}: {e}"}
    entries = pickle.loads(dump).get("entries", [])
    return {"entries": len(entries), "by_state": dict(Counter(
        f"{e.get('profiling_name')} {e.get('state')}" for e in entries))}


def int8_pod(torch, TS, device):
    """The int8-compressed step on a one-rank NCCL group.  Reduced
    internlm2-1.8b, 2 steps of ``make_compressed_train_step``: the error
    buffers stay bf16, finite and on the card, and step 1's compressed
    gradient is within scale/2 of the plain one (the residual bound of
    int8 rounding).  Then internlm2-1.8b at full width and depth (fp32,
    AdamW, remat, dense attention), ``INT8_STEPS`` steps of
    ``INT8_BATCH`` × 1,024 tokens from one seed, eagerly and then, after
    freeing that run, through ``make_compressed_train_fn``'s CUDA graph
    (its MAX and mean all-reduces captured), bit for bit: losses and
    grad norms at every step, params and bf16 error buffers after the
    last; the flight recorder's entries after each run say which
    collectives the group's watchdog saw complete."""
    import torch.distributed as dist
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_arch
    from repro_torch.data import make_batch_iterator
    from repro_torch.models import convert
    from repro_torch.optim import tree_compressed_psum
    cfg = get_arch(TRAIN_ARCH).reduced()
    tc = TS.TrainConfig(lr=1e-3, warmup=2, total_steps=8,
                        grad_compression="int8_pod")
    _nccl_world(torch)
    try:
        group = dist.group.WORLD
        params, state = TS.init_train_state(cfg, tc, seed=0, device=device)
        it = make_batch_iterator(cfg, 4, 64, seed=0, device=device)
        batches = [next(it), next(it)]
        plain, _ = TS.compute_grads(cfg, tc, params, batches[0])
        stacked = convert.stack_blocks(plain)
        deq, _ = tree_compressed_psum(stacked, group)
        worst = 0.0
        for g, q in zip(pytree.tree_leaves(stacked), pytree.tree_leaves(deq)):
            half = float(g.abs().max()) / 127 / 2
            err = float((g - q).abs().max())
            if err > half + 1e-6:           # tests/test_train_integration.py
                raise AssertionError(f"compressed gradient off by {err} "
                                     f"> scale/2 = {half}")
            worst = max(worst, err / max(half, 1e-30))
        step = TS.make_compressed_train_step(cfg, tc, group)
        metrics = []
        for b in batches:
            params, state, m = step(params, state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        ef = pytree.tree_leaves(state["ef"])
        on_card(torch, state["ef"], "the error buffers")
        if not all(t.dtype == torch.bfloat16 and bool(torch.isfinite(t).all())
                   for t in ef):
            raise AssertionError("error buffers are not finite bf16")
        if int(state["step"]) != 2:
            raise AssertionError("steps were not counted")
        ef_max = max(float(t.float().abs().max()) for t in ef)
        del params, state, step, plain, stacked, deq, ef

        full = get_arch(TRAIN_ARCH)
        ftc = TS.TrainConfig(lr=3e-4, warmup=10, total_steps=TRAIN_STEPS,
                             grad_compression="int8_pod")
        it = make_batch_iterator(full, INT8_BATCH, TRAIN_SEQ, seed=0,
                                 device="cpu")
        fbatches = [next(it) for _ in range(INT8_STEPS)]
        kw = dict(batches=fbatches, device=device, keep=(INT8_STEPS,),
                  snap=lambda p, s: (p, s["ef"]),
                  make_fn=lambda: TS.make_compressed_train_fn(full, ftc,
                                                              group),
                  init=lambda: TS.init_train_state(full, ftc, seed=0,
                                                   device=device))
        rows, kept, trace = {}, {}, {}
        for name in ("eager", "graph"):
            rows[name], kept[name] = step_run(torch, graph=name == "graph",
                                              **kw)
            trace[name] = nccl_trace(torch)
        graph_equals_eager(torch, rows["eager"], rows["graph"],
                           kept["eager"][INT8_STEPS],
                           kept["graph"][INT8_STEPS], "the int8 step")
        leaves = kept["eager"][INT8_STEPS]
        n = len(leaves) // 2            # the params, then their buffers
        n_params = sum(t.numel() for t in leaves[:n])
        if not all(t.dtype == torch.bfloat16 and bool(torch.isfinite(t).all())
                   for t in leaves[n:]):
            raise AssertionError("full-width error buffers are not finite "
                                 "bf16")
        del kept, leaves
    finally:
        dist.destroy_process_group()
    emit("int8_pod", arch=cfg.name, backend="nccl", world_size=1, steps=2,
         metrics=metrics, worst_err_over_half_scale=worst, ef_max_abs=ef_max,
         full={"arch": full.name, "layers": full.n_layers,
               "d_model": full.d_model, "params": n_params,
               "batch": INT8_BATCH, "seq": TRAIN_SEQ, "steps": INT8_STEPS,
               "dtype": "fp32", "remat": True, "impl": "dense",
               "graph_equals_eager": "losses and grad norms at every step, "
               "params and bf16 error buffers after the last, bit for bit",
               "eager": rows["eager"], "graph": rows["graph"],
               "nccl_trace": trace})


def gpipe(torch, TS, T, device):
    """internlm2-1.8b at full width and depth (24 layers, fp32 weights and
    AdamW moments, remat, dense attention) through the GPipe step with
    both stages in one process on the card: 2 stages of 12 layers, 4
    microbatches of 1 × 1,024 tokens, the ``train`` phase's schedule
    (lr 3e-4, 10 warm-up steps).  ``GPIPE_GRAPH_STEPS`` steps of
    ``make_pp_train_fn``'s eager step from one seeded state, then
    ``GPIPE_STEPS`` of ``make_train_step`` from the same seed on the same
    batches, then the pipeline's steps again through its CUDA graph, each
    run freed before the next (two states of the model do not fit beside
    a working set).  The plain steps must agree with the pipeline's
    first: losses and grad norms, and the parameters too but for
    elements whose update AdamW's first steps turn on a gradient's
    rounding (each step moves an element by up to lr_t whatever |g|;
    their share is bounded).  The graph must equal the eager pipeline bit
    for bit: losses and grad norms at every step, every parameter after
    the last.  Each pipeline run takes one more step under the profiler.
    On one card the stages run in turn; the bubble (S − 1)/T is the
    multi-device schedule's."""
    from repro_torch.configs import get_arch
    from repro_torch.data import make_batch_iterator
    from repro_torch.train import pipeline as PP
    cfg = get_arch(TRAIN_ARCH)
    tc = TS.TrainConfig(lr=3e-4, warmup=10, total_steps=TRAIN_STEPS)
    pc = PP.PipelineConfig(n_stages=GPIPE_STAGES,
                           microbatches=GPIPE_MICROBATCHES)
    it = make_batch_iterator(cfg, GPIPE_MICROBATCHES, TRAIN_SEQ, seed=1,
                             device="cpu")
    batches = [next(it) for _ in range(GPIPE_GRAPH_STEPS)]
    kw = dict(device=device,
              make_fn=lambda: PP.make_pp_train_fn(cfg, tc, pc),
              init=lambda: PP.init_pp_state(cfg, tc, pc, seed=0,
                                            device=device))
    eager, kept = step_run(torch, batches=batches, graph=False,
                           keep=(GPIPE_STEPS, GPIPE_GRAPH_STEPS), **kw)
    plain, plain_kept = step_run(
        torch, lambda: TS.make_train_fn(cfg, tc),
        lambda: TS.init_train_state(cfg, tc, seed=0, device=device),
        batches[:GPIPE_STEPS], device, graph=False, keep=(GPIPE_STEPS,),
        profile=False)
    pp_m, plain_m = eager["metrics"][:GPIPE_STEPS], plain["metrics"]
    rel = [{k: abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm")}
           for a, b in zip(pp_m, plain_m)]
    worst, n, over = 0.0, 0, {1e-7: 0, 1e-6: 0, GPIPE_PARAM_TOL: 0}
    for a, b in zip(kept.pop(GPIPE_STEPS), plain_kept.pop(GPIPE_STEPS)):
        d = (a.to(device) - b.to(device)).abs()
        worst = max(worst, float(d.max()))
        n += d.numel()
        for tol in over:
            over[tol] += int((d > tol).sum())
    del d
    graph, graph_kept = step_run(torch, batches=batches, graph=True,
                                 keep=(GPIPE_GRAPH_STEPS,), **kw)
    graph_equals_eager(torch, eager, graph, kept[GPIPE_GRAPH_STEPS],
                       graph_kept[GPIPE_GRAPH_STEPS], "the GPipe step")
    del kept, graph_kept
    torch.cuda.empty_cache()
    lr_sum = sum(float(tc.lr * min(1.0, (i + 1) / tc.warmup))
                 for i in range(GPIPE_STEPS))
    ticks = GPIPE_MICROBATCHES + GPIPE_STAGES - 1
    emit("gpipe", arch=cfg.name, layers=cfg.n_layers, stages=GPIPE_STAGES,
         layers_per_stage=cfg.n_layers // GPIPE_STAGES,
         microbatches=GPIPE_MICROBATCHES, microbatch=[1, TRAIN_SEQ],
         steps=GPIPE_GRAPH_STEPS, plain_steps=GPIPE_STEPS, dtype="fp32",
         remat=True, impl="dense", lr=tc.lr, warmup=tc.warmup,
         pipeline=pp_m, plain=plain_m, rel_diff_per_step=rel,
         params_max_abs=worst, params=n,
         params_over={str(k): v for k, v in over.items()},
         tol_loss_rel=GPIPE_LOSS_TOL, tol_grad_norm_rel=GPIPE_NORM_TOL,
         tol_params=GPIPE_PARAM_TOL, tol_params_over_share=GPIPE_FLIP_SHARE,
         graph_equals_eager="losses and grad norms at every step, params "
         "after the last, bit for bit",
         eager=eager, graph=graph,
         plain_step_ms_each=plain["step_ms_each"],
         plain_peak_gb=plain["peak_gb"], ticks=ticks,
         bubble_of_the_schedule=(GPIPE_STAGES - 1) / ticks)
    for i, r in enumerate(rel):
        if r["loss"] > GPIPE_LOSS_TOL or r["grad_norm"] > GPIPE_NORM_TOL:
            raise AssertionError(f"step {i + 1}: pipeline and plain step "
                                 f"differ {r}")
    if not np.isfinite(worst) or worst > 2 * lr_sum \
            or over[GPIPE_PARAM_TOL] > GPIPE_FLIP_SHARE * n:
        raise AssertionError(f"params differ by up to {worst}, "
                             f"{over[GPIPE_PARAM_TOL]} of {n} past "
                             f"{GPIPE_PARAM_TOL}")


def _nccl_world(torch):
    """A one-rank NCCL default group on this card."""
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)


def shard_bytes(shapes, specs, mesh, elem_bytes=None):
    """Bytes of one rank's shards of a stacked tree of meta tensors laid
    out by ``specs`` on ``mesh`` (each element ``elem_bytes`` long when
    given, else its own type's)."""
    from repro_torch.launch import mesh as TM
    if isinstance(shapes, dict):
        return sum(shard_bytes(shapes[k], specs[k], mesh, elem_bytes)
                   for k in shapes)
    n = int(np.prod(TM.local_shape(tuple(shapes.shape), specs, mesh)))
    return n * (elem_bytes or shapes.element_size())


def shard_rules(torch, T, device):
    """The sharding rules on the card.  On a one-rank NCCL ``DeviceMesh``
    of shape (1, 1), axes (data, model): internlm2-1.8b's full-width
    parameters (fp32) saved and restored onto their ``param_pspecs``
    placements, every leaf a DTensor with the same bits; its forward with
    the mesh's rules equal to ``rules=None`` bit for bit, and the rules'
    constraint on a DTensor activation.  Then qwen3-moe-235b-a22b at full
    width, depth cut to 1 layer, one prefill of 4 × 128 tokens with 4
    MoE groups on the card against the same call on the host
    (``dropped_frac`` equal, logits within 1e-4 of their scale).  Last,
    each arch's per-rank parameter (bf16) and AdamW (fp32 moments) bytes
    on both production meshes, from the meta shapes and the specs (host
    arithmetic) on a fake process group."""
    import dataclasses
    import shutil
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Replicate,
                                          distribute_tensor)
    from torch.utils import _pytree as pytree
    from repro_torch.ckpt import restore, save
    from repro_torch.configs import get_arch, list_archs
    from repro_torch.launch import mesh as TM
    from repro_torch.models import convert
    cfg = get_arch(TRAIN_ARCH)
    ckpt = Path(__file__).resolve().parent / "build" / "shard_rules"
    shutil.rmtree(ckpt, ignore_errors=True)
    params = T.init_params(cfg, device=device, seed=0)
    t = time.perf_counter()
    save(str(ckpt), 1, convert.stack_blocks(params, device="cpu"))
    save_s = time.perf_counter() - t
    _nccl_world(torch)
    try:
        mesh = TM.make_debug_mesh((1, 1))
        rules = TM.make_rules(mesh)
        pspecs = T.param_pspecs(cfg, rules)
        like = convert.stack_blocks(T.param_shapes(cfg, torch.float32))
        t = time.perf_counter()
        got = convert.unstack_blocks(
            restore(str(ckpt), 1, like=like, mesh=mesh, pspecs=pspecs),
            params)
        restore_s = time.perf_counter() - t
        shutil.rmtree(ckpt, ignore_errors=True)
        layered = convert.unstack_specs(pspecs, params)
        n_leaves = 0
        placements = set()
        for (leaf, spec), (want, _) in zip(
                convert.leaves_with_specs(got, layered),
                convert.leaves_with_specs(params, layered)):
            if not isinstance(leaf, DTensor) or \
                    leaf.to_local().device != device:
                raise AssertionError("a restored leaf is not a DTensor on "
                                     f"{device}")
            if tuple(leaf.placements) != TM.placements(spec, mesh):
                raise AssertionError(f"placements {leaf.placements} for "
                                     f"{spec}")
            if not torch.equal(leaf.to_local(), want):
                raise AssertionError("a restored leaf differs")
            n_leaves += 1
            placements.add(str(tuple(leaf.placements)))
        local = pytree.tree_map(lambda d: d.to_local(), got)
        del got
        tok = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (2, TRAIN_SEQ), dtype=np.int32)).to(device)
        with torch.inference_mode():
            with_rules, _ = T.forward(local, cfg, {"tokens": tok},
                                      rules=rules)
            plain, _ = T.forward(params, cfg, {"tokens": tok})
            same = bool(torch.equal(with_rules, plain))
            act = rules.act(distribute_tensor(
                plain, mesh, [Replicate(), Replicate()]),
                rules.batch, None, rules.model)
            act_same = bool(torch.equal(act.full_tensor(), plain))
        if not same or not act_same:
            raise AssertionError("forward with rules differs from "
                                 "rules=None")
        act_placements = str(tuple(act.placements))
        backend = dist.get_backend()
        del local, params, with_rules, plain, act
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    moe_cfg = dataclasses.replace(get_arch(MOE_ARCH),
                                  n_layers=SHARD_MOE_LAYERS)
    grouped = T.ShardRules(moe_groups=SHARD_MOE_GROUPS)
    host = torch.device("cpu")
    p_host = T.init_params(moe_cfg, device=host, seed=SEED + 5)
    p_card = pytree.tree_map(lambda x: x.to(device), p_host)
    tok = torch.from_numpy(np.random.default_rng(SEED + 6).integers(
        0, moe_cfg.vocab_size, (SHARD_MOE_BATCH, SHARD_MOE_SEQ),
        dtype=np.int32))
    with torch.inference_mode():
        y_card, aux_card = T.forward(p_card, moe_cfg,
                                     {"tokens": tok.to(device)},
                                     rules=grouped)
        _, aux_one = T.forward(p_card, moe_cfg, {"tokens": tok.to(device)})
        t = time.perf_counter()
        y_host, aux_host = T.forward(p_host, moe_cfg, {"tokens": tok},
                                     rules=grouped)
        host_s = time.perf_counter() - t
    moe_diff = float((y_card.cpu() - y_host).abs().max())
    moe_scale = float(y_host.abs().max())
    row = {k: [float(aux_card[k]), float(aux_host[k])] for k in aux_card}
    del p_host, p_card, y_card, y_host
    torch.cuda.empty_cache()
    if row["dropped_frac"][0] != row["dropped_frac"][1]:
        raise AssertionError(f"grouped dispatch differs card/host: {row}")
    if not np.isfinite(moe_diff) or moe_diff > SHARD_MOE_TOL * moe_scale:
        raise AssertionError(f"grouped MoE prefill card vs host: "
                             f"{moe_diff} > {SHARD_MOE_TOL} × {moe_scale}")

    per_rank = {}
    for multi in (False, True):
        mesh = TM.make_production_mesh(multi_pod=multi)
        name = "x".join(map(str, mesh.shape))
        for fsdp in (False, True):
            rules_p = TM.make_rules(mesh, fsdp=fsdp)
            for arch in list_archs():
                a_cfg = get_arch(arch)
                shapes = convert.stack_blocks(T.param_shapes(a_cfg))
                specs = T.param_pspecs(a_cfg, rules_p)
                per_rank.setdefault(arch, {})[
                    f"{name}{'_fsdp' if fsdp else ''}"] = {
                    "params_gb": shard_bytes(shapes, specs, mesh) / 1e9,
                    "adamw_gb": 2 * shard_bytes(shapes, specs, mesh, 4)
                    / 1e9}
        dist.destroy_process_group()
    emit("shard_rules", mesh=[1, 1], axes=["data", "model"],
         backend=backend, arch=cfg.name, restored_leaves=n_leaves,
         placements=sorted(placements), save_s=save_s, restore_s=restore_s,
         forward_rules_bit_equal=same, act_placements=act_placements,
         moe_arch=moe_cfg.name, moe_reduced="n_layers 94 -> 1",
         moe_tokens=[SHARD_MOE_BATCH, SHARD_MOE_SEQ],
         moe_groups=SHARD_MOE_GROUPS, moe_card_vs_host=row,
         moe_dropped_frac_one_group=float(aux_one["dropped_frac"]),
         moe_max_abs=moe_diff, moe_scale=moe_scale,
         moe_tol_of_scale=SHARD_MOE_TOL, moe_host_s=host_s,
         per_rank=per_rank)


def dryrun(torch, T, TS, device):
    """The dry-run and its counted bound against the card.  On the host:
    ``launch.dryrun.lower`` for ``DRYRUN_FAMILIES`` × ``DRYRUN_SMALL``
    (reduced configs on a (2, 4) fake mesh), then
    ``launch.dryrun.lower_cell`` for internlm2-1.8b × train_4k and ×
    decode_32k on both production meshes and hymba-1.5b × long_500k on
    16×16 (fake process groups, meta DTensors).  On the card:
    internlm2-1.8b's dry-run train step (``arch_train_config``: bf16
    parameters, fp32 AdamW moments, remat, dense attention) at full width
    and depth on 4 × 4,096 tokens (train_4k's batch cut 256 → 4), and one
    decode step at position 32,767 of a 32,768-slot bf16 cache for 2
    sequences (decode_32k's batch cut 128 → 2).  Each is counted once on
    the card and once on meta tensors (dot flops and bytes must be
    equal), then its device time is taken with ``profile_step`` after a
    warm-up call, and it is timed on the host eagerly and through its CUDA
    graph (``make_train_fn``, whose first call must give the eager step's
    loss; ``make_decode_fn``, whose logits must agree within
    ``GRAPH_REL_TOL``); the counted terms use ``Roofline``'s H100 datasheet
    peaks at bf16.  The host's DTensor count of each cell (one rank's
    products × ranks) must equal the card's plain count of the cut batch
    times the cut (256/4 and 128/2): the sharded step does the plain
    step's products, split over the ranks without redundancy."""
    import dataclasses
    import torch.distributed as dist
    from torch.utils import _pytree as pytree
    import repro_torch.serve as serve
    from repro_torch.configs import SHAPES, ShapeConfig, get_arch
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as TM
    from repro_torch.roofline import analysis as R
    from repro_torch.roofline.counter import count
    if dist.is_initialized():
        dist.destroy_process_group()
    t = time.perf_counter()
    families = 0
    for arch in DRYRUN_FAMILIES:
        for shape in DRYRUN_SMALL:
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=8)
            try:
                mesh = TM.make_debug_mesh((2, 4), ("data", "model"),
                                          device="cpu")
                row = D.lower(get_arch(arch).reduced(), ShapeConfig(*shape),
                              mesh).row()
            finally:
                dist.destroy_process_group()
            if not row["dot_flops"] > 0:
                raise AssertionError(f"{arch} × {shape[0]}: no products")
            families += 1
    families_s = time.perf_counter() - t
    cells = []
    t_all = time.perf_counter()
    for arch, shape, multi in DRYRUN_CELLS:
        t = time.perf_counter()
        row = D.lower_cell(arch, shape, multi_pod=multi,
                           verbose=False).row()
        row["seconds"] = time.perf_counter() - t
        cells.append(row)
    host_s = time.perf_counter() - t_all
    if dist.is_initialized():
        raise AssertionError("a dry-run cell left its fake group behind")
    for row in cells:
        if not all(np.isfinite(row[k]) and row[k] > 0 for k in (
                "hlo_flops", "dot_flops", "hlo_bytes", "collective_bytes",
                "per_device_hbm")):
            raise AssertionError(f"dry-run row not finite and positive: "
                                 f"{row}")
    # the module's products are the same work on either mesh (its ranks
    # split the batch evenly): one rank's count × ranks agrees
    for arch, shape in {(a, s) for a, s, _ in DRYRUN_CELLS}:
        dots = [r["dot_flops"] for r in cells
                if (r["arch"], r["shape"]) == (arch, shape)]
        if len(dots) == 2 and abs(dots[0] - dots[1]) > 1e-6 * dots[0]:
            raise AssertionError(f"{arch} × {shape}: module dot flops "
                                 f"differ between the meshes: {dots}")

    cfg = get_arch(TRAIN_ARCH)
    rng = np.random.default_rng(SEED + 11)
    tc = D.arch_train_config(cfg)
    params, state = TS.init_train_state(cfg, tc, device=device,
                                        dtype=torch.bfloat16, seed=SEED)
    seq = SHAPES["train_4k"].seq_len
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (DRYRUN_TRAIN_BATCH, seq + 1), dtype=np.int32))
    batch = {"tokens": tokens[:, :-1].to(device),
             "labels": tokens[:, 1:].to(device)}
    step = TS.make_train_step(cfg, tc)
    out = step(params, state, batch)                     # warm-up
    torch.cuda.synchronize()
    del out
    card = count(lambda: step(params, state, batch))[1]
    mparams, mstate = TS.train_state_shapes(cfg, tc, torch.bfloat16)
    mbatch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in batch.items()}
    meta = count(lambda: step(mparams, mstate, mbatch))[1]
    dev_ms, launches, out = profile_step(
        torch, lambda: step(params, state, batch))
    if not all(torch.isfinite(v).all() for v in
               pytree.tree_leaves(out[2])):
        raise AssertionError("the dry-run train step's metrics are not "
                             "finite")
    loss = out[2]["loss"].clone()
    del out
    # the same step eagerly and through its CUDA graph, which adopts the
    # trees (the eager step never changed them)
    eager_ms = synced_ms(torch, lambda: step(params, state, batch))
    torch.cuda.reset_peak_memory_stats()
    fn = TS.make_train_fn(cfg, tc)
    first = fn(params, state, batch)[2]["loss"]
    if not torch.equal(first, loss):
        raise AssertionError("the train graph's first call differs from "
                             "the eager step")
    graph_ms = synced_ms(torch, lambda: fn(params, state, batch))
    graph_dev_ms, graph_launches, out = profile_step(
        torch, lambda: fn(params, state, batch))
    if not torch.isfinite(out[2]["loss"]).all():
        raise AssertionError("the train graph's loss is not finite")
    del out
    enqueue_ms = _enqueue_ms(torch, lambda: fn(params, state, batch))
    train_graph = {"eager_ms_each": eager_ms, "graph_ms_each": graph_ms,
                   "eager_ms": statistics.median(eager_ms),
                   "graph_ms": statistics.median(graph_ms),
                   "graph_device_ms": graph_dev_ms,
                   "graph_launches": graph_launches,
                   "graph_enqueue_ms": enqueue_ms,
                   "capture_ms": 1e3 * fn.capture_s,
                   "nodes": fn.last.nodes, "kernel_nodes": fn.last.kernels,
                   "graph_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del fn, first, params, state, batch
    torch.cuda.empty_cache()
    cut = ShapeConfig("train_4k_b4", seq, DRYRUN_TRAIN_BATCH, "train")
    train = _dryrun_row(R, cfg, cut, card, meta, dev_ms, launches)
    train.update(train_graph)
    _dryrun_scaled(cells, "train_4k", card, SHAPES["train_4k"].global_batch
                   // DRYRUN_TRAIN_BATCH)
    train["train_flops_hand"] = train_flops(cfg, DRYRUN_TRAIN_BATCH, seq)
    train["dot_flops_over_hand"] = card.dot_flops / train[
        "train_flops_hand"]

    dcfg_shape = SHAPES["decode_32k"]
    with torch.no_grad():
        params = T.init_params(cfg, device=device, dtype=torch.bfloat16,
                               seed=SEED)
        cache = T.init_cache(cfg, DRYRUN_DECODE_BATCH, dcfg_shape.seq_len,
                             torch.bfloat16, device=device)
        tok = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (DRYRUN_DECODE_BATCH, 1), dtype=np.int32))
        # the dry-run's position: the cache's last slot, all of it attended
        inputs = {"tokens": tok.to(device), "length": dcfg_shape.seq_len - 1}
        dec = lambda p, c, i: T.decode_step(p, cfg, c, i)[0]
        dec(params, cache, inputs)                            # warm-up
        torch.cuda.synchronize()
        card = count(lambda: dec(params, cache, inputs))[1]
        mcache = T.init_cache(cfg, DRYRUN_DECODE_BATCH, dcfg_shape.seq_len,
                              torch.bfloat16, device="meta")
        minputs = {"tokens": torch.empty(tok.shape, dtype=tok.dtype,
                                         device="meta"),
                   "length": inputs["length"]}
        mparams = T.param_shapes(cfg)
        meta = count(lambda: dec(mparams, mcache, minputs))[1]
        dev_ms, launches, logits = profile_step(
            torch, lambda: dec(params, cache, inputs))
        if not torch.isfinite(logits).all():
            raise AssertionError("the dry-run decode step's logits are "
                                 "not finite")
        cache_gb = sum(v.numel() * v.element_size()
                       for v in cache.values()) / 1e9
        # eagerly and through its CUDA graph, the position a device
        # scalar; every call writes the same slot with the same token
        eager_ms = synced_ms(torch, lambda: dec(params, cache, inputs),
                             DRYRUN_DECODES)
        decode_fn = serve.make_decode_fn(cfg)
        tinputs = {"tokens": inputs["tokens"], "length": torch.tensor(
            inputs["length"], dtype=torch.int32, device=device)}
        decode_fn(params, cache, tinputs)
        graph_ms = synced_ms(torch, lambda: decode_fn(params, cache,
                                                      tinputs),
                             DRYRUN_DECODES)
        graph_dev_ms, graph_launches, (glogits, _) = profile_step(
            torch, lambda: decode_fn(params, cache, tinputs))
        enqueue_ms = _enqueue_ms(torch, lambda: decode_fn(params, cache,
                                                          tinputs))
        scale = float(logits.float().abs().max())
        rel = float((glogits.float() - logits.float()).abs().max()) / scale
        if not rel <= GRAPH_REL_TOL:
            raise AssertionError(f"the decode graph's logits differ from "
                                 f"the eager step's by {rel} of their scale")
        decode_graph = {"eager_ms_each": eager_ms, "graph_ms_each": graph_ms,
                        "eager_ms": statistics.median(eager_ms),
                        "graph_ms": statistics.median(graph_ms),
                        "graph_device_ms": graph_dev_ms,
                        "graph_launches": graph_launches,
                        "graph_enqueue_ms": enqueue_ms,
                        "capture_ms": 1e3 * decode_fn.last.capture_s,
                        "nodes": decode_fn.last.nodes,
                        "kernel_nodes": decode_fn.last.kernels,
                        "logits_rel_diff": rel}
    del params, cache, logits, glogits, decode_fn
    torch.cuda.empty_cache()
    cut = ShapeConfig("decode_32k_b2", dcfg_shape.seq_len,
                      DRYRUN_DECODE_BATCH, "decode")
    decode = _dryrun_row(R, cfg, cut, card, meta, dev_ms, launches)
    decode.update(decode_graph)
    _dryrun_scaled(cells, "decode_32k", card,
                   dcfg_shape.global_batch // DRYRUN_DECODE_BATCH)
    decode["cache_gb"] = cache_gb
    emit("dryrun", families=families, families_s=families_s,
         host_cells=cells, host_s=host_s, train=train,
         decode=decode, hardware=dataclasses.asdict(R.H100))


def synced_ms(torch, fn, n=DRYRUN_TIMED):
    """The host's ms of each of ``n`` calls of ``fn``, each bounded by a
    synchronize."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        del out
    return ms


def _dryrun_scaled(cells, shape, card, cut):
    """Every host row of ``TRAIN_ARCH`` × ``shape`` (either mesh): its
    module dot flops equal the card's count × ``cut``, exactly."""
    rows = [r for r in cells if (r["arch"], r["shape"]) == (TRAIN_ARCH,
                                                            shape)]
    if not rows:
        raise AssertionError(f"no host row of {TRAIN_ARCH} × {shape}")
    for r in rows:
        if r["dot_flops"] != card.dot_flops * cut:
            raise AssertionError(
                f"{shape} on {r['mesh']}: module dot flops {r['dot_flops']}"
                f" != the card's {card.dot_flops} × {cut}")


def _dryrun_row(R, cfg, shape, card, meta, dev_ms, launches):
    """The counted step against its measured device time; raises where
    the card's and meta's counts disagree."""
    if card.dot_flops != meta.dot_flops:
        raise AssertionError(f"{shape.name}: dot flops on the card "
                             f"{card.dot_flops} != on meta {meta.dot_flops}")
    if card.bytes != meta.bytes:
        raise AssertionError(f"{shape.name}: bytes on the card {card.bytes}"
                             f" != on meta {meta.bytes}")
    roof = R.Roofline(arch=cfg.name, shape=shape.name, mesh="1", chips=1,
                      hlo_flops=card.flops, hlo_bytes=card.bytes,
                      collective_bytes=0.0,
                      model_flops=R.model_flops(cfg, shape),
                      dot_flops=card.dot_flops, dtype="bfloat16")
    bound_ms = 1e3 * max(roof.t_compute, roof.t_memory)
    return {"shape": shape.name, "dot_flops_card": card.dot_flops,
            "dot_flops_meta": meta.dot_flops, "flops": card.flops,
            "bytes_card": card.bytes, "bytes_meta": meta.bytes,
            "model_flops": roof.model_flops,
            "dot_flops_over_model": card.dot_flops / roof.model_flops,
            "t_compute_ms": 1e3 * roof.t_compute,
            "t_memory_ms": 1e3 * roof.t_memory,
            "bottleneck": roof.bottleneck, "bound_ms": bound_ms,
            "device_ms": dev_ms, "launches": launches,
            "device_over_bound": dev_ms / bound_ms}


# --- the rest of the paper's framework: sharded DES, examples, B5, A6 -----


def des_sharded():
    """The sharded DES on the committed ``BENCH_des_scale.json`` diurnal row
    (100,000 messages, 100 devices, 1,000 consumers, 20,000 Hz, 64 B,
    service 1 ms, seed 0), single-process inline and at 4 shards ``mp``:
    both must reproduce the row's deterministic columns bit for bit.  It
    runs before anything touches CUDA, because ``mp`` forks."""
    import os

    from repro_torch.sim import shard
    bench = json.loads((Path(__file__).resolve().parent
                        / "BENCH_des_scale.json").read_text())
    golden = next(r for r in bench["rows"] if r["arrival"] == "diurnal")
    for key in ("messages", "devices", "consumers", "payload_bytes",
                "seed"):
        if golden[key] != DES_CELL[key]:
            raise AssertionError(f"BENCH_des_scale.json diurnal row has "
                                 f"{key}={golden[key]}")
    runs = []
    for shards, mode in ((1, "inline"), (4, "mp")):
        row = shard.run_scale_sharded(**DES_CELL, shards=shards, mode=mode)
        bad = {col: (row[col], golden[col]) for col in DES_DET_COLS
               if row[col] != golden[col]}
        if bad:
            raise AssertionError(f"{shards} shards {mode}: {bad}")
        runs.append({key: row[key] for key in (
            "shards", "mode", "windows", "events", "wall_s",
            "events_per_s", "cpu_s_total", "cpu_critical_s",
            "agg_events_per_s")})
    emit("des_sharded", cell=DES_CELL, cpu_count=os.cpu_count(),
         golden={col: golden[col] for col in DES_DET_COLS},
         golden_wall_s=golden["wall_s"], runs=runs)


def quickstart_example(torch, core, ml, kk, device):
    """``repro_torch.examples.quickstart.main`` at its full size (128
    messages of 2,500 × 32, k = 25) on the card, with the k-means launch
    counts set to 0 just before and read just after; then the quickstart's
    first messages through the processor on the card and on the host, in
    order, as ``check_against_plain_path`` holds them."""
    from repro_torch.examples import quickstart
    for counter in kk.LAUNCHES.values():
        counter.reset()
    calls = graph_calls()
    out = quickstart.main(device=device)
    torch.cuda.synchronize()
    launches = {name: c.count for name, c in kk.LAUNCHES.items()}
    calls = graph_calls() - calls
    if out["n_processed"] != out["n_messages"]:
        raise AssertionError(f"quickstart processed {out['n_processed']}/"
                             f"{out['n_messages']}")
    if calls < out["n_messages"]:
        raise AssertionError(f"quickstart: {calls} compiled calls")
    if launches["kmeans_assign_update"] < out["n_messages"]:
        raise AssertionError(f"quickstart launched B1 "
                             f"{launches['kmeans_assign_update']} times")
    gen = ml.MiniAppGenerator(n_points=2_500, n_clusters=25, seed=7)
    msgs = [gen.sample() for _ in range(QUICKSTART_CHECKED)]
    card = ml.KMeans(device=device).make_processor()
    host = ml.KMeans(device="cpu").make_processor()
    worst = 0.0
    for msg in msgs:
        a, b = card(None, data=msg), host(None, data=msg)
        diff = abs(a["mean_score"] - b["mean_score"])
        worst = max(worst, diff)
        if a["n_outliers"] != b["n_outliers"] or \
                diff > 1e-5 * abs(b["mean_score"]) + 0.05 * 25 / 2_500:
            raise AssertionError(f"quickstart message: {a} vs {b}")
    emit("quickstart_example", n_messages=out["n_messages"],
         n_processed=out["n_processed"], wall_s=out["wall_s"],
         msgs_per_s=out["msgs_per_s"], outliers=out["outliers"],
         launches=launches, graph_calls=calls, checked_vs_host=len(msgs),
         mean_score_max_abs=worst)


def geo_example(torch, kk, device):
    """``repro_torch.examples.geo_distributed.main`` on the card: 64
    messages of 2,500 points local, then across a ``WanShaper(80e6, rtt
    0.150, sleep=True)``, then the PlacementEngine's ranking (k-means to
    the edge, the auto-encoder to the cloud: the paper's Fig 3)."""
    from repro_torch.examples import geo_distributed as geo
    for counter in kk.LAUNCHES.values():
        counter.reset()
    calls = graph_calls()
    out = geo.main(device=device)
    torch.cuda.synchronize()
    launches = {name: c.count for name, c in kk.LAUNCHES.items()}
    calls = graph_calls() - calls
    n = out["n_messages"]
    if calls < 2 * n:
        raise AssertionError(f"geo example: {calls} compiled calls")
    if out["local"]["n_processed"] != n or out["geo"]["n_processed"] != n:
        raise AssertionError(f"geo example processed {out['local']} / "
                             f"{out['geo']}")
    if launches["kmeans_assign_update"] < 2 * n:
        raise AssertionError(f"geo example launched B1 {launches}")
    choices = {name: r["choice"] for name, r in out["rankings"].items()}
    if choices != {"k-means": "edge", "auto-encoder": "cloud"}:
        raise AssertionError(f"placement ranking {choices}")
    emit("geo_example", n_messages=n, local=out["local"], geo=out["geo"],
         rankings=out["rankings"], launches=launches, graph_calls=calls)


def autotune(torch, kk, device):
    """B5 at the timed shapes and every precision: each tile instance held
    against the plain version (``check_kernel``), its ids and dmin the same
    bits as every other tile's, timed with CUDA events; then
    ``autotune_block_n`` at the full shape and at its default 4,096-row
    probe, from an empty cache."""
    for n, f, k in TIMED_SHAPES:
        x, c = blobs(torch, n, f, k, device, SEED + 1)
        iters = 50 if n <= 100_000 else 10
        for precision in PRECISIONS:
            prep = kk.prepare(x, c, precision)
            first, cands = None, {}
            for tile in kk.TILES:
                row = check_kernel(torch, kk, n, f, k, precision, device,
                                   block_n=tile)
                ids, dmin, _, _ = kk.launch(prep, True, tile)
                a_ids, a_dmin = kk.launch(prep, False, tile)
                torch.cuda.synchronize()
                first = first or (ids, dmin)
                if not all(torch.equal(a, b) for a, b in (
                        (a_ids, ids), (a_dmin, dmin), (ids, first[0]),
                        (dmin, first[1]))):
                    raise AssertionError(f"ids/dmin of the {tile}-row tile "
                                         f"differ at {(n, f, k)} "
                                         f"{precision}")
                cands[tile] = {
                    "ms": time_ms(torch, lambda: kk.launch(prep, True, tile),
                                  iters),
                    "assign_ms": time_ms(
                        torch, lambda: kk.launch(prep, False, tile), iters),
                    "grid": row["grid"], "sum_chain": row["sum_chain"],
                    "sums_max_abs_err": row["sums_max_abs_err"],
                    "id_mismatches_at_ties": row["id_mismatches_at_ties"]}
            kk._autotune_cache.clear()
            t0 = time.perf_counter()
            winner = kk.autotune_block_n(n, f, k, precision=precision,
                                         probe_n=n, device=device)
            sweep_s = time.perf_counter() - t0
            winner_probe = kk.autotune_block_n(n, f, k, precision=precision,
                                               device=device)
            emit("autotune", shape=[n, f, k], precision=precision,
                 candidates=cands, winner=winner, sweep_s=sweep_s,
                 winner_at_4096_probe=winner_probe,
                 fastest_timed=min(cands, key=lambda t: cands[t]["ms"]),
                 default=kk.DEFAULT_BLOCK_N)


def calibrate(torch, kk, device):
    """``Calibrator(...).calibrate(measure_service=True)`` at 2,500 × 32,
    every processor on the card: the fitted efficiency and sigma of the
    five models beside the committed paper-testbed fit, and the torch
    flop count beside the committed HLO figure.  Then the drift tool's
    k-means row (``repro_torch.tools.calibration_drift``, 2 messages on
    the card): its count within the calibrator's band and within a factor
    of 2 of its pinned counting ratio, as its CLI's gate holds it."""
    from repro_torch.cost import calibrate as cal
    from repro_torch.tools import calibration_drift as drift
    for counter in kk.LAUNCHES.values():
        counter.reset()
    calls = graph_calls()
    t0 = time.perf_counter()
    costs = cal.Calibrator(n_points=2_500, n_features=32,
                           device=device).calibrate(measure_service=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.count for name, c in kk.LAUNCHES.items()}
    calls = graph_calls() - calls
    committed = cal.load_calibration()
    models = {}
    for name, mc in sorted(costs.items()):
        ref = committed[name]
        if not (0.0 < mc.efficiency <= 1.0 and np.isfinite(mc.sigma)
                and mc.sigma >= 0.0 and mc.source == "measured"):
            raise AssertionError(f"calibrate {name}: {mc}")
        models[name] = {
            "efficiency": mc.efficiency, "sigma": mc.sigma,
            "paper_efficiency": ref.efficiency, "paper_sigma": ref.sigma,
            "torch_flops_per_point": mc.kernel_flops_per_point,
            "hlo_flops_per_point": ref.kernel_flops_per_point,
            "flops_ratio": mc.kernel_flops_per_point
            / ref.kernel_flops_per_point,
            "torch_bytes_per_point": mc.kernel_bytes_per_point,
            "hlo_bytes_per_point": ref.kernel_bytes_per_point}
    if not 0.75 <= models["kmeans"]["flops_ratio"] <= 1.33:
        raise AssertionError(f"k-means count {models['kmeans']}")
    # three k-means processors, a warm-up and 5 samples each
    if launches["kmeans_assign_update"] < 3 * 6 or calls < 5 * 6:
        raise AssertionError(f"calibration launched B1 {launches}, "
                             f"{calls} compiled calls")
    report = drift.drift_report(models=["kmeans"], n_messages=2,
                                device=device)
    (row,) = report["models"]
    if (report["meta"]["device"] != str(device)
            or not 0.75 <= row["kernel_flops_ratio"] <= 1.33
            or not 0.5 <= drift.drift(row) <= 2.0
            or not row["achieved_fraction_of_peak"] > 0.0):
        raise AssertionError(f"calibration drift {report}")
    emit("calibrate", wall_s=wall, models=models, launches=launches,
         graph_calls=calls,
         drift=row, drift_meta=report["meta"])


def lm_example(torch, fa, device):
    """``repro_torch.examples.train_and_serve_lm.main --params 100`` (12
    layers × 768) on the card: a short training run whose loss must fall,
    checkpoints, publish and fetch through the parameter service, then 8
    requests served through ``BatchServer``, whose GQA prefill graph runs
    the flash-attention kernel (its launch count set to 0 just before and
    read just after) and is held against the eager prefill at every wave
    (:class:`CheckedPrefill`), and whose decode graph is held against the
    eager step at every step (:class:`CheckedDecode`; both put in through
    ``serve.engine``).  Every launch that runs Python (the graph's eager
    warm-up and the eager check, which the graph equals bit for bit; a
    capture fills no tensor and a replay runs no Python) keeps its inputs
    and output, each held against the plain version on the same inputs at
    the flash checks' fp32 tolerance (:func:`flash_tol`)."""
    from repro_torch.examples import train_and_serve_lm as lm
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine
    launch, seen = fa.launch, []
    make_decode, made = engine.make_decode_fn, []
    make_prefill, made_prefill = engine.make_prefill_fn, []

    def checked_make(cfg, impl="dense"):
        made.append(CheckedDecode(torch, T, cfg, make_decode(cfg, impl)))
        return made[-1]

    def checked_make_prefill(cfg, max_len, **kw):
        made_prefill.append(CheckedPrefill(torch, make_prefill(cfg, max_len,
                                                               **kw)))
        return made_prefill[-1]

    def kept_launch(q, k, v, *, causal=True, window=None, scale=None):
        out = launch(q, k, v, causal=causal, window=window, scale=scale)
        if not torch.cuda.is_current_stream_capturing():
            seen.append((q.clone(), k.clone(), v.clone(), causal, window,
                         scale, out.clone()))
        return out

    for counter in fa.LAUNCHES.values():
        counter.reset()
    fa.launch, engine.make_decode_fn, engine.make_prefill_fn = (
        kept_launch, checked_make, checked_make_prefill)
    try:
        t0 = time.perf_counter()
        out = lm.main(device=device, params_m=100, steps=LM_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        fa.launch, engine.make_decode_fn, engine.make_prefill_fn = (
            launch, make_decode, make_prefill)
    if len(made) != 1 or not made[0].waves or len(made_prefill) != 1:
        raise AssertionError(f"the LM example's server made {len(made)} "
                             f"decode and {len(made_prefill)} prefill "
                             f"functions")
    graph = graph_rows(made.pop().waves)
    checked = made_prefill.pop()
    cfg = lm.sized_config(100)
    launches = check_launches(checked, fa.LAUNCHES,
                              dict.fromkeys(fa.LAUNCHES, cfg.n_layers))
    worst, shapes = 0.0, set()
    for q, k, v, causal, window, scale, got in seen:
        want = fa.plain(q, k, v, causal=causal, window=window, scale=scale)
        diff = (got.float() - want.float()).abs()
        worst = max(worst, float(diff.max()))
        shapes.add((*q.shape, k.shape[2], str(q.dtype), causal, window))
        if got.dtype != torch.float32 or bool(
                (diff > flash_tol(want, "fp32")).any()):
            raise AssertionError(f"LM example flash launch at "
                                 f"{tuple(q.shape)}/{tuple(k.shape)}: "
                                 f"max error {float(diff.max())}")
    waves = len(out["waves"])
    if len(seen) != (checked.captures + waves) * cfg.n_layers or \
            len(checked.waves) != waves:
        raise AssertionError(f"kept {len(seen)} launches of {waves} waves "
                             f"and {checked.captures} captures")
    del seen
    if out["served"] != 8 or out["tokens"] != 8 * 16:
        raise AssertionError(f"served {out['served']}, {out['tokens']} "
                             f"tokens")
    hist = out["history"]
    emit("lm_example", config=out["config"],
         param_count=out["param_count"], steps=LM_STEPS,
         loss_first=hist[0]["loss"], loss_last=hist[-1]["loss"],
         tok_per_s=hist[-1]["tok_per_s"], version=out["version"],
         served=out["served"], tokens=out["tokens"], waves=waves,
         prefill_ms=[w["prefill_s"] * 1e3 for w in out["waves"]],
         prefill_graph=prefill_rows(checked.waves),
         prefill_captures=checked.captures,
         prefill_ops=prefill_ops(torch, T, engine, cfg, 4, 32),
         decode_ms_mean=[r["graph_ms"] for r in graph],
         eager_decode_ms_mean=[r["eager_ms"] for r in graph],
         decode_graph=graph,
         wall_s=wall, launches=launches,
         flash_checked_vs_plain=(checked.captures + waves) * cfg.n_layers,
         flash_max_abs_err=worst,
         flash_shapes=sorted(map(list, shapes), key=str))


def serve_mla(torch, serve, T, fa, device):
    """minicpm3-4b (MLA) at full width and depth (62 layers × 2,560,
    random fp32 weights from the seed, bf16 cache) through
    ``BatchServer(impl="kernel")``: 2 waves of 4 requests, 1,024- and
    2,048-token prompts, 16 new tokens each, the flash launch count set to
    0 just before and read just after; it must stay 0, since MLA's
    ``"kernel"`` is dense attention, as the reference's ``"pallas"`` is.
    Then the first request again with an fp32 cache, prefill and absorbed
    decode against ``forward`` over prompt + generated tokens (the
    expanded form) within 2e-3 of the logits' largest magnitude; the
    served (bf16 cache) logits' distance from it is reported."""
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import prefill_with_cache
    cfg = get_arch(MLA_ARCH)
    max_len = max(MLA_WAVES) + ZOO_NEW_TOKENS
    t0 = time.monotonic()
    params = T.init_params(cfg, device=device, dtype=torch.float32,
                           seed=SEED)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in MLA_WAVES for _ in range(SERVE_SLOTS)]
    run_server(torch, serve, params, cfg, device, "kernel",
               [prompts[0][:64]], max_len=max_len, new_tokens=2,
               check=False)
    counter = fa.LAUNCHES["flash_attention"]
    torch.cuda.reset_peak_memory_stats(device)
    counter.reset()
    server, done, captured, wall = run_server(
        torch, serve, params, cfg, device, "kernel", prompts,
        max_len=max_len, new_tokens=ZOO_NEW_TOKENS)
    launches = {"flash_attention": counter.count}
    read_ms = (decode_weight_bytes(cfg, params, SERVE_SLOTS)
               / HBM_BYTES_PER_S * 1e3)
    stats = serve_stats(torch, server, done,
                        check_served(done, len(prompts), cfg,
                                     ZOO_NEW_TOKENS), wall, device, read_ms)
    del server
    if launches["flash_attention"] != 0:
        raise AssertionError(f"MLA launched the flash kernel: {launches}")

    r = done[0]
    n = len(r.prompt)
    seq = torch.from_numpy(np.concatenate(
        [r.prompt, r.result_tokens[:-1]]).astype(np.int64))[None].to(device)
    with torch.inference_mode():
        full, _ = T.forward(params, cfg, {"tokens": seq}, impl="kernel")
        full = full[0, n - 1:].float()
        logits, cache = prefill_with_cache(
            params, cfg, {"tokens": seq[:, :n]}, max_len=seq.shape[1],
            impl="kernel", cache_dtype=torch.float32)
        rows = [logits[0, -1].float()]
        for i in range(ZOO_NEW_TOKENS - 1):
            logits, cache = T.decode_step(params, cfg, cache, {
                "tokens": seq[:, n + i:n + i + 1], "length": n + i})
            rows.append(logits[0, 0].float())
    got, served = torch.stack(rows), torch.stack(captured[0]["rows"])
    scale = float(full.abs().max())
    err = float((got - full).abs().max())
    if not np.isfinite(err) or err > MODEL_TOL * scale:
        raise AssertionError(f"MLA absorbed decode vs forward: {err} > "
                             f"{MODEL_TOL} × {scale}")
    emit("serve_mla", arch=MLA_ARCH, layers=cfg.n_layers,
         d_model=cfg.d_model, params=T.param_count(params), init_s=init_s,
         cache="bf16", **stats, launches=launches,
         decode_weight_read_ms=read_ms,
         prefill_ops=[prefill_ops(torch, T, serve, cfg, SERVE_SLOTS, n)
                      for n in MLA_WAVES],
         flash_zero_because="the reference's mla_forward runs dense "
         "attention for every impl but chunked; the flash kernel never "
         "sees MLA's 96-wide q/k and 64-wide v",
         decode_vs_forward_max_abs=err, logits_max_abs=scale,
         tol=MODEL_TOL * scale, positions_checked=ZOO_NEW_TOKENS,
         served_bf16_vs_forward_max_abs=float((served - full).abs().max()))
    del params, cache, full, captured
    torch.cuda.empty_cache()


def mla_vs_host(torch, T, device):
    """minicpm3-4b at full width with 2 layers: one parameter tree made on
    the host from the seed and copied to the card; a 128-token prefill
    and 8 decode steps (fp32 cache) on both.  Logits and the ``ckv`` /
    ``krope`` caches within 2e-3 of each one's largest magnitude."""
    import dataclasses
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import prefill_with_cache
    cfg = dataclasses.replace(get_arch(MLA_ARCH), n_layers=2)
    host = T.init_params(cfg, device="cpu", seed=SEED + 2)
    card = pytree.tree_map(lambda t: t.to(device), host)
    n, steps = MLA_HOST_PROMPT, MLA_HOST_STEPS
    toks = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
        1, cfg.vocab_size, (2, n + steps)))
    out = {}
    for name, params, dev in (("card", card, device), ("host", host, "cpu")):
        seq = toks.to(dev)
        with torch.inference_mode():
            logits, cache = prefill_with_cache(
                params, cfg, {"tokens": seq[:, :n]}, max_len=n + steps,
                impl="kernel", cache_dtype=torch.float32)
            rows = [logits[:, -1]]
            for i in range(steps):
                logits, cache = T.decode_step(params, cfg, cache, {
                    "tokens": seq[:, n + i:n + i + 1], "length": n + i})
                rows.append(logits[:, 0])
        if name == "card":
            on_card(torch, cache, "the MLA cache")
        out[name] = {"logits": torch.stack(rows, 1).float().cpu(),
                     **{k: v.float().cpu() for k, v in cache.items()}}
    errs = {}
    for key, want in out["host"].items():
        diff = float((out["card"][key] - want).abs().max())
        scale = float(want.abs().max())
        errs[key] = {"max_abs": diff, "scale": scale}
        if not np.isfinite(diff) or diff > MODEL_TOL * scale:
            raise AssertionError(f"MLA card vs host, {key}: {diff} > "
                                 f"{MODEL_TOL} × {scale}")
    emit("mla_vs_host", arch=MLA_ARCH, reduced="n_layers 62 -> 2",
         d_model=cfg.d_model, batch=2, prompt=n, decode_steps=steps,
         cache="fp32", errors=errs, tol_of_scale=MODEL_TOL)
    del card, host


def vlm_positions(n_text, batch):
    """qwen2-vl's M-RoPE positions (3, B, S): a 16 × 16 image grid at
    t = 0 with (h, w) grid positions, then text continuing on all three
    axes from the grid's maximum + 1."""
    hh, ww = np.meshgrid(np.arange(VLM_GRID), np.arange(VLM_GRID),
                         indexing="ij")
    img = np.stack([np.zeros(VLM_GRID ** 2, np.int64), hh.ravel(),
                    ww.ravel()])
    txt = np.tile(np.arange(VLM_GRID, VLM_GRID + n_text), (3, 1))
    pos = np.concatenate([img, txt], axis=1)
    if (pos[0] == pos[1]).all() or (pos[1] == pos[2]).all():
        raise AssertionError("the M-RoPE axes do not differ")
    return np.repeat(pos[:, None], batch, axis=1).astype(np.int32)


def vlm_mrope(torch, T, fa, device):
    """qwen2-vl-2b at full width and depth (28 layers × 1,536, random fp32
    weights): 4 sequences of a 16 × 16 grid of patch embeddings and 768
    text positions (embeddings drawn from the seed), through
    ``make_prefill_fn(impl="kernel")``'s graph (the embeds + M-RoPE key;
    bf16 cache; held against the eager prefill, :class:`CheckedPrefill`)
    and 16 decode steps with (3, B, 1) positions through
    ``make_decode_fn(impl="kernel")``'s graph (the decode attention
    kernel with per-row M-RoPE tables), each held against the eager step
    (:class:`CheckedDecode`); the flash launch count set to 0 just before
    and read just after (exactly one a layer: the kernel run replays the
    prefill graph the warm-up captured).  The same run at
    ``impl="dense"`` (its own prefill and decode graphs): prefill and
    decode logits within 2e-3 of the largest magnitude; both runs' greedy
    tokens reported.  The warm-up and the kernel run replay the one kernel
    decode graph the warm-up captured."""
    import repro_torch.serve as serve
    from repro_torch.configs import get_arch
    cfg = get_arch(VLM_ARCH)
    b, s, steps = VLM_BATCH, VLM_GRID ** 2 + VLM_TEXT, ZOO_NEW_TOKENS
    t0 = time.monotonic()
    params = T.init_params(cfg, device=device, dtype=torch.float32,
                           seed=SEED)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    embeds = torch.randn((b, s + steps, cfg.d_model), generator=g,
                         device=device)
    positions = torch.from_numpy(vlm_positions(VLM_TEXT + steps, b)).to(
        device)
    vocab = cfg.vocab_size
    decodes = {impl: CheckedDecode(torch, T, cfg, serve.make_decode_fn(
        cfg, impl)) for impl in ("kernel", "dense")}
    prefills = {impl: CheckedPrefill(torch, serve.make_prefill_fn(
        cfg, s + steps, impl=impl)) for impl in ("kernel", "dense")}

    def run(impl):
        with torch.inference_mode():
            logits, cache = prefills[impl](
                params, {"embeds": embeds[:, :s],
                         "positions": positions[:, :, :s]})
            logits = logits.clone()             # the graph's buffer
            tokens = [torch.argmax(logits[:, -1, :vocab], -1).cpu()]
            prefill_s = prefills[impl].waves[-1]["graph_ms"] / 1e3
            rows, decode_s = [logits[:, -1].float()], []
            for i in range(steps):
                t = time.perf_counter()
                out, cache = decodes[impl](params, cache, {
                    "embeds": embeds[:, s + i:s + i + 1],
                    "positions": positions[:, :, s + i:s + i + 1],
                    "length": torch.tensor(s + i, dtype=torch.int32,
                                           device=device)})
                tokens.append(torch.argmax(out[:, 0, :vocab], -1).cpu())
                decode_s.append(time.perf_counter() - t)
                rows.append(out[:, 0].float().clone())  # the graph's buffer
        return (logits, torch.stack(rows, 1), torch.stack(tokens, 1),
                prefill_s, decode_s)

    run("kernel")                                       # warm up
    counter = fa.LAUNCHES["flash_attention"]
    checked = prefills["kernel"]
    torch.cuda.reset_peak_memory_stats(device)
    counter.reset()
    checked.check_launches = dict.fromkeys(checked.check_launches, 0)
    logits, rows, tokens, prefill_s, decode_s = run("kernel")
    launches = {"flash_attention": counter.count
                - checked.check_launches["flash_attention"]}
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    if launches["flash_attention"] != cfg.n_layers or \
            checked.captures != 1 or checked.waves[-1]["first_ms"] is not None:
        raise AssertionError(f"qwen2-vl flash launches {launches}, "
                             f"expected {cfg.n_layers} from one replay")
    served = counter.count
    plain_logits, plain_rows, plain_tokens, plain_prefill_s, _ = run(
        "dense")
    if counter.count != served:
        raise AssertionError("the dense path launched the flash kernel")
    errs = {}
    for key, a, want in (("prefill", logits, plain_logits),
                         ("decode", rows, plain_rows)):
        diff = float((a.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        errs[key] = {"max_abs": diff, "scale": scale}
        if not np.isfinite(diff) or diff > MODEL_TOL * scale:
            raise AssertionError(f"qwen2-vl kernel vs dense {key} logits: "
                                 f"{diff} > {MODEL_TOL} × {scale}")
    wall = prefill_s + sum(decode_s)
    read_ms = decode_weight_bytes(cfg, params, b) / HBM_BYTES_PER_S * 1e3
    graph = graph_rows(decodes["kernel"].waves, read_ms)
    graph_dense = graph_rows(decodes["dense"].waves, read_ms)
    del decodes
    emit("vlm_mrope", arch=VLM_ARCH, layers=cfg.n_layers,
         d_model=cfg.d_model, params=T.param_count(params), init_s=init_s,
         batch=b, seq=s, image_grid=[VLM_GRID, VLM_GRID], text=VLM_TEXT,
         decode_steps=steps, cache="bf16", launches=launches,
         tokens_per_s=b * (steps + 1) / wall, wall_s=wall,
         first_token_ms_mean=prefill_s * 1e3,
         first_token_ms_p95=prefill_s * 1e3, prefill_ms=prefill_s * 1e3,
         prefill_ms_dense=plain_prefill_s * 1e3,
         prefill_graph=prefill_rows(checked.waves),
         prefill_graph_dense=prefill_rows(prefills["dense"].waves),
         prefill_ops=prefill_ops(torch, T, serve, cfg, b, s),
         decode_ms_per_step=graph[1]["graph_ms"],
         eager_decode_ms_per_step=graph[1]["eager_ms"],
         decode_weight_read_ms=read_ms,
         decode_graph=graph, decode_graph_runs=["warm-up", "kernel"],
         decode_graph_dense=graph_dense,
         max_memory_allocated_gb=peak_gb, kernel_vs_dense=errs,
         tol_of_scale=MODEL_TOL, greedy_tokens=tokens.tolist(),
         greedy_tokens_dense=plain_tokens.tolist(),
         greedy_equal=int((tokens == plain_tokens).sum()),
         greedy_compared=tokens.numel())
    del params, embeds, logits, plain_logits, prefills
    torch.cuda.empty_cache()


def moe_layer_vs_dense(torch, L, cfg, device):
    """One full-width MoE layer (fp32 weights drawn from the seed) on 256
    tokens against an independent dense formulation: every token through
    every expert, weighted by its gates and the keep mask of
    ``_dispatch_positions``.  Tolerance 2e-4 of the largest magnitude."""
    m, d = cfg.moe, cfg.d_model
    g = torch.Generator(device=device).manual_seed(SEED + 4)
    lp = L.moe_init(g, cfg, torch.float32, device)
    x = torch.randn((1, MOE_CHECK_TOKENS, d), generator=g, device=device)
    with torch.inference_mode():
        y, aux = L.moe_forward(lp, x, cfg)
        xs = x[0]
        _, _, gate, ids = L.moe_route(lp, xs, m.top_k)
        cap = L.moe_capacity(cfg, MOE_CHECK_TOKENS)
        pos = L._dispatch_positions(ids.reshape(-1), m.n_experts).reshape(
            ids.shape)
        keep = pos < cap
        h = torch.einsum("td,edf->etf", xs, lp["w_gate"])
        u = torch.einsum("td,edf->etf", xs, lp["w_up"])
        every = torch.einsum("etf,efd->etd", L.silu(h) * u, lp["w_down"])
        rows = torch.arange(MOE_CHECK_TOKENS, device=device)
        want = torch.zeros_like(xs)
        for j in range(m.top_k):
            want += (gate[:, j] * keep[:, j])[:, None] * every[ids[:, j],
                                                               rows]
    diff = float((y[0] - want).abs().max())
    scale = float(want.abs().max())
    if not np.isfinite(diff) or diff > MOE_TOL * scale:
        raise AssertionError(f"MoE layer vs dense formulation: {diff} > "
                             f"{MOE_TOL} × {scale}")
    emit("moe_layer_vs_dense", arch=cfg.name, tokens=MOE_CHECK_TOKENS,
         capacity=cap, dropped_frac=float(aux["dropped_frac"]),
         kept_pairs=int(keep.sum()), max_abs=diff, scale=scale,
         tol_of_scale=MOE_TOL)


def cache_bytes(cfg, batch, positions):
    """Bytes of ``batch`` sequences' cache over ``positions`` positions:
    the bf16 k/v entries (a sliding window caps the positions) and the
    fp32 SSM and conv states."""
    n = 0
    if cfg.attn_kind in ("gqa", "hybrid"):
        if cfg.sliding_window is not None:
            positions = min(positions, cfg.sliding_window)
        n += (cfg.n_layers * 2 * batch * positions * cfg.n_kv_heads
              * cfg.head_dim * 2)
    if cfg.ssm is not None:
        m = cfg.ssm
        d_in = m.expand * cfg.d_model
        conv = d_in + 2 * m.n_groups * m.d_state
        n += cfg.n_layers * batch * 4 * (
            d_in * m.d_state + (m.d_conv - 1) * conv)
    return n


def serve_plan(torch, T, cfg, waves, slots=SERVE_SLOTS,
               new_tokens=ZOO_NEW_TOKENS):
    """The reckoned device memory of a :func:`serve_zoo` phase in bytes,
    from shapes alone.  Its parts: the fp32 weights counted on ``meta``;
    the cache at ``max(waves) + new_tokens`` positions; each wave's fp32
    logits at every position (the prefill computes them all) and at the
    last (all the server's prefill returns); an eager prefill's
    transients, three FFN-wide fp32 activations (the FFN or residual, the
    SSM's in-projection), and on the dense path the larger of those and
    its fp32 scores twice (each step of ``attention_dense`` makes a new
    tensor).

    The prefill graphs of a server share one pool (``prefill_graph_pool``)
    that holds the outputs of each graph the server keeps (its last
    logits and its cache, from its wave on; at most
    ``MAX_PREFILL_GRAPHS``), and the widest wave's working set beyond
    them: its layers' cache entries before the stack, its logits at every
    position and its transients.  The decode graph's static cache is the
    first wave's prefill cache: a graph's output in the kernel run (whose
    :class:`CheckedPrefill` serves a replay), the eager warm-up's in the
    dense run.  An eager prefill (``eager_prefill``: the graph's
    warm-up, :class:`CheckedPrefill`'s check) holds its logits, its cache
    twice (the entries and their stack) and its transients in the
    ordinary pool, whose free blocks the capture hands back.  The peak is
    the larger of two moments:

    * ``kernel_run``: the eager check of the kernel run's widest wave,
      beside that pool and :func:`run_server`'s copies of the earlier
      waves' caches;
    * ``dense_run``: the dense run's warm-up of its widest wave, beside
      the kernel run's copies of every wave's cache, the dense run's of
      the earlier waves, and the dense pool with the earlier waves'
      outputs and working set.

    The decode steps' eager check copies one cache when the prefill's
    transients are gone."""
    from repro_torch.serve.engine import MAX_PREFILL_GRAPHS
    s, n = max(waves), len(waves)
    kept = min(n, MAX_PREFILL_GRAPHS)
    params = 4 * T.param_count(T.param_shapes(cfg, dtype=torch.float32))
    cache = cache_bytes(cfg, slots, s + new_tokens)
    width = cfg.d_ff
    if cfg.ssm is not None:
        m = cfg.ssm
        d_in = m.expand * cfg.d_model
        width = max(width, 2 * d_in + 2 * m.n_groups * m.d_state
                    + d_in // m.head_dim)
    last = 4 * slots * cfg.n_codebooks * cfg.padded_vocab_size
    logits = sorted(w * last for w in waves)
    ffn = 3 * 4 * slots * s * width
    dense = max(2 * 4 * slots * cfg.n_heads * s * s, ffn)

    def eager(transient):
        return logits[-1] + 2 * cache + transient

    pool = kept * (cache + last) + cache + logits[-1] + ffn
    kernel_run = params + (n - 1) * cache + pool + eager(ffn)
    earlier = ((min(n - 1, kept) * (cache + last) + 2 * cache + logits[-2]
                + dense) if n > 1 else 0)
    dense_run = params + (2 * n - 1) * cache + earlier + eager(dense)
    return {"params": params, "cache": cache, "logits": logits[-1],
            "last_logits": last, "transient": dense,
            "prefill_graph_pool": pool, "eager_prefill": eager(ffn),
            "kernel_run": kernel_run, "dense_run": dense_run,
            "peak": max(kernel_run, dense_run)}


def prefill_ops(torch, T, serve, cfg, batch, prompt, impl="kernel"):
    """The kernel-launching aten ops of one eager prefill of ``batch``
    prompts of ``prompt`` tokens (bf16 cache), counted on the host under a
    ``TorchDispatchMode`` over meta tensors (weights and inputs), views and
    bare allocations left out; the flash kernel and the SSD chunk kernel
    count one op a call (the recurrence across chunks runs its own ops).
    The count a graph's kernel nodes should come near."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ssd as kssd

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view and func.overloadpacket not in ALLOCATIONS:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    def flash(q, k, v, **kw):
        Count.n += 1
        return torch.empty_like(q)

    def scan(xh, dt, A, B_, C_, D, *, chunk):
        Count.n += 1
        b, s, nh, hd = xh.shape
        nc, ds = s // chunk, B_.shape[3]
        parts = (torch.empty_like(xh),
                 xh.new_empty((b, nh, nc, ds, hd), dtype=torch.float32),
                 xh.new_empty((b, nh, nc, chunk), dtype=torch.float32))
        return kssd.inter_chunk(*parts, C_, chunk)

    params = T.param_shapes(cfg, dtype=torch.float32)
    meta = torch.device("meta")
    if cfg.input_mode == "embeddings":
        inputs = {"embeds": torch.empty((batch, prompt, cfg.d_model),
                                        device=meta),
                  "positions": torch.zeros((3, batch, prompt),
                                           dtype=torch.int32, device=meta)}
    else:
        shape = ((batch, prompt, cfg.n_codebooks) if cfg.n_codebooks > 1
                 else (batch, prompt))
        inputs = {"tokens": torch.zeros(shape, dtype=torch.long,
                                        device=meta)}
    saved = kops._flash, kops._ssd
    kops._flash, kops._ssd = flash, scan
    try:
        with torch.inference_mode(), Count():
            serve.prefill_with_cache(params, cfg, inputs, prompt + 1,
                                     impl=impl)
    finally:
        kops._flash, kops._ssd = saved
    return Count.n


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a parameter tree."""
    if hasattr(tree, "element_size"):
        return tree.numel() * tree.element_size()
    values = tree.values() if isinstance(tree, dict) else tree
    return sum(tree_bytes(v) for v in values)


def decode_weight_bytes(cfg, params, batch, experts=None):
    """The weight bytes one decode step of ``batch`` sequences must read:
    every parameter but the embedding table's unread rows (one row a
    sequence and codebook; a tied table is read whole as the head), and of
    each MoE layer's expert stacks only ``experts`` of them (the distinct
    experts the step's tokens chose)."""
    weights = tree_bytes(params)
    if "embed" in params and not cfg.tie_embeddings:
        emb = params["embed"]
        weights -= tree_bytes(emb) - (batch * cfg.n_codebooks
                                      * emb.shape[-1] * emb.element_size())
    if cfg.moe is not None:
        unread = 1.0 - experts / cfg.moe.n_experts
        for lp in params["blocks"]:
            weights -= unread * sum(tree_bytes(lp["moe"][k]) for k in
                                    ("w_gate", "w_up", "w_down"))
    return weights


def serve_zoo(torch, serve, T, L, fa, ssd, device, phase, arch, layers,
              waves):
    """One arch at full width and ``layers`` of its layers
    (:func:`_serve_zoo_run`, whose locals hold the weights); then the
    weights are freed, and the card's allocation must be back at its
    level before the phase."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    fields = _serve_zoo_run(torch, serve, T, L, fa, ssd, device, arch,
                            layers, waves)
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated(device)
    emit(phase, **fields, allocated_before_gb=base / 1e9,
         allocated_after_gb=after / 1e9)
    if after > base:
        raise AssertionError(f"{phase}: {after - base} B still allocated "
                             f"after its weights were freed")


def _serve_zoo_run(torch, serve, T, L, fa, ssd, device, arch, layers,
                   waves):
    """Random fp32 weights from the seed, a bf16 cache, through
    ``BatchServer(impl="kernel")``: 2 waves of 4 requests, 16 new tokens
    each, the kernel launch counts set to 0 just before the timed waves
    and read just after (a flash launch a layer for attention, an SSD
    launch a layer for the SSM, in each wave's prefill graph and each
    capture's eager warm-up; :func:`check_launches`).  Then the same waves
    at ``impl="dense"``: tokens equal up to the first place where the
    dense run's top two logits lie within 2e-3 of 1 + the top logit;
    prefill logits and caches held by :func:`hold_waves`, but for an MoE,
    whose routing may flip at a near-tie, where they are reported.  The
    MoE's prefill ``dropped_frac`` and tokens per expert are recorded from
    the router in the eager check of each prefill (:class:`CheckedPrefill`,
    which the graph equals bit for bit: a capture fills no tensor and a
    replay runs no Python), and the distinct experts each decode step
    chose in the eager check of each step.  The peak (init, kernel and
    dense runs) must stay below 80 GB.  Returns the phase's fields."""
    import dataclasses
    from repro_torch.configs import get_arch
    full = get_arch(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    plan = serve_plan(torch, T, cfg, waves)
    max_len = max(waves) + ZOO_NEW_TOKENS
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.monotonic()
    params = T.init_params(cfg, device=device, dtype=torch.float32,
                           seed=SEED)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    peaks = {"init": torch.cuda.max_memory_allocated(device)}
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in waves for _ in range(SERVE_SLOTS)]
    run_server(torch, serve, params, cfg, device, "kernel",
               [prompts[0][:64]], max_len=max_len, new_tokens=2,
               check=False)

    route, forward = L.moe_route, L.moe_forward
    routes, drops, decode_ids = [], [], []

    def eager_check():
        # the graphs' warm-ups and captures run on their side stream, and
        # their replays run no Python
        return torch.cuda.current_stream() == torch.cuda.default_stream()

    def kept_route(p, xf, top_k):
        out = route(p, xf, top_k)
        if eager_check():
            (routes if xf.shape[-2] > SERVE_SLOTS else decode_ids).append(
                out[3])
        return out

    def kept_forward(p, x, cfg, **kw):
        y, aux = forward(p, x, cfg, **kw)
        if x.shape[0] * x.shape[1] > SERVE_SLOTS and eager_check():
            drops.append(aux["dropped_frac"])
        return y, aux

    counters = {"flash_attention": fa.LAUNCHES["flash_attention"],
                "ssd_chunk_scan": ssd.LAUNCHES["ssd_chunk_scan"]}
    runs = {"flash_attention": cfg.attn_kind in ("gqa", "hybrid"),
            "ssd_chunk_scan": cfg.attn_kind in ("none", "hybrid")}
    torch.cuda.reset_peak_memory_stats(device)
    if cfg.moe is not None:
        L.moe_route, L.moe_forward = kept_route, kept_forward
    try:
        for c in kernel_counters().values():
            c.reset()
        server, done, captured, wall = run_server(
            torch, serve, params, cfg, device, "kernel", prompts,
            max_len=max_len, new_tokens=ZOO_NEW_TOKENS)
    finally:
        L.moe_route, L.moe_forward = route, forward
    peaks["kernel"] = torch.cuda.max_memory_allocated(device)
    reserved = {"kernel": torch.cuda.max_memory_reserved(device)}
    launches = check_launches(server.checked_prefill, counters,
                              {name: layers * int(on)
                               for name, on in runs.items()})
    launches.update(check_decode_launches(
        server.checked,
        {"decode_attention": layers * int(runs["flash_attention"]),
         "ssm_decode": layers * int(runs["ssd_chunk_scan"])}))
    served = {name: c.count for name, c in kernel_counters().items()}
    stats = serve_stats(torch, server, done,
                        check_served(done, len(prompts), cfg,
                                     ZOO_NEW_TOKENS), wall, device)
    for w in captured:
        if not bool(torch.isfinite(w["logits"]).all()) or not all(
                bool(torch.isfinite(v.float()).all())
                for v in w["cache"].values()):
            raise AssertionError(f"{arch}: non-finite prefill logits or "
                                 f"cache")

    torch.cuda.reset_peak_memory_stats(device)
    graph_waves = server.checked.waves
    del server
    _, done_p, captured_p, wall_p = run_server(
        torch, serve, params, cfg, device, "dense", prompts,
        max_len=max_len, new_tokens=ZOO_NEW_TOKENS, check=False)
    peaks["dense"] = torch.cuda.max_memory_allocated(device)
    reserved["dense"] = torch.cuda.max_memory_reserved(device)
    if {name: c.count for name, c in kernel_counters().items()} != served:
        raise AssertionError(f"{arch}: the dense path launched a kernel")
    errs = hold_waves(torch, captured, captured_p, hold=cfg.moe is None)
    compared, near_ties = compare_tokens(
        done, done_p, captured_p, lambda top1: MODEL_TOL * (1 + abs(top1)))
    if max(peaks.values()) >= CARD_BYTES:
        raise AssertionError(f"{arch} peaked at {peaks} B")

    moe, experts = {}, None
    if cfg.moe is not None:
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        counts = [torch.bincount(ids.reshape(-1), minlength=e).tolist()
                  for ids in routes]
        if len(counts) != len(waves) * layers or any(
                sum(c) != n * SERVE_SLOTS * k
                for c, n in zip(counts, np.repeat(waves, layers))):
            raise AssertionError("the prefill routes do not cover every "
                                 "token")
        experts = float(np.mean([len(set(ids.reshape(-1).tolist()))
                                 for ids in decode_ids]))
        every = sum(tree_bytes(lp["moe"][name]) for lp in params["blocks"]
                    for name in ("w_gate", "w_up", "w_down"))
        moe = dict(experts=e, top_k=k,
                   prefill_dropped_frac=[float(d) for d in drops],
                   prefill_expert_counts=counts,
                   prefill_expert_counts_min_max=[[min(c), max(c)]
                                                  for c in counts],
                   decode_steps_routed=len(decode_ids),
                   decode_distinct_experts_mean=experts,
                   decode_all_experts_read_ms=every / HBM_BYTES_PER_S * 1e3)
    weights = decode_weight_bytes(cfg, params, SERVE_SLOTS, experts)
    cache = cache_bytes(cfg, SERVE_SLOTS, max(waves))
    read_ms = weights / HBM_BYTES_PER_S * 1e3
    stats["decode_graph"] = graph_rows(graph_waves, read_ms)
    if arch in TRACE_ARCHS:
        emit("decode_trace", arch=arch, batch=SERVE_SLOTS, prompt=waves[0],
             weight_read_ms=read_ms,
             **trace_decode(torch, T, serve, params, cfg, device, waves[0]))
        emit("prefill_trace", arch=arch, batch=SERVE_SLOTS, prompt=waves[0],
             **trace_prefill(torch, serve, params, cfg, device, waves[0]))
    return dict(
        arch=arch, layers=layers,
        reduced=(f"n_layers {full.n_layers} -> {layers}"
                 if layers < full.n_layers else None),
        d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
        head_dim=cfg.head_dim, codebooks=cfg.n_codebooks,
        params=T.param_count(params), init_s=init_s, cache="bf16",
        **stats, launches=launches,
        dense_wall_s=wall_p, tokens_compared=compared, near_ties=near_ties,
        tokens_equal=sum(a.result_tokens == b.result_tokens
                         for a, b in zip(done, done_p)),
        kernel_vs_dense=errs, logits_and_cache_held=cfg.moe is None,
        peak_gb={name: v / 1e9 for name, v in peaks.items()},
        peak_reserved_gb={name: v / 1e9 for name, v in reserved.items()},
        prefill_ops=[prefill_ops(torch, T, serve, cfg, SERVE_SLOTS, n)
                     for n in waves],
        plan_gb={name: v / 1e9 for name, v in plan.items()},
        decode_weight_read_ms=read_ms,
        decode_bound_ms=(weights + cache) / HBM_BYTES_PER_S * 1e3,
        decode_over_weight_read=stats["decode_ms_per_step"][-1] / read_ms,
        eager_decode_over_weight_read=(stats["eager_decode_ms_per_step"][-1]
                                       / read_ms),
        **moe)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    # first, before anything touches CUDA: the sharded DES forks
    des_sharded()
    import repro_torch.core as core
    import repro_torch.cost as cost
    import repro_torch.ml as ml
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kmeans as kk
    from repro_torch.kernels import ref as tref
    from repro_torch.kernels import ssd
    from repro_torch.kernels import ssm_decode as tsd
    from repro_torch.launch import train as TL
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    import repro_torch.serve as serve
    from repro_torch.train import step as TS

    # the plain version's fp32 matmul must not run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    smi = nvidia_smi()
    cap = torch.cuda.get_device_capability(0)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), capability=list(cap),
         count=torch.cuda.device_count(), nvidia_smi=smi)
    if cap != (9, 0):
        raise RuntimeError(f"needs an sm_90 card, got capability {cap}")

    t0 = time.perf_counter()
    seconds = build.build_all()
    ptxas = [line.strip() for log in build.build_logs.values()
             for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit("build", seconds=seconds, wall_s=time.perf_counter() - t0,
         build_dir=str(build.BUILD_DIR), ptxas=ptxas)

    worst = {"kmeans_assign_update": 0.0, "kmeans_assign": 0.0}
    checks = [(shape, 0) for shape in CHECK_SHAPES] + [
        (shape, 1) for shape in CHECK_MISALIGNED]
    for (n, f, k), offset in checks:
        for precision in PRECISIONS:
            row = check_kernel(torch, kk, n, f, k, precision, device, offset)
            emit("check", **row)
            for name in worst:
                worst[name] = max(worst[name], row["dmin_max_abs_err"])

    timings = time_kernels(torch, kk, ops, device)
    launches = run_pipeline(torch, core, ml, kk, device)
    check_against_plain_path(torch, core, ml, device)
    quickstart_example(torch, core, ml, kk, device)
    geo_example(torch, kk, device)
    autotune(torch, kk, device)

    worst["flash_attention"] = check_flash(torch, fa, tref, device)
    worst["ssd_chunk_scan"] = check_ssd(torch, ssd, tref, device)
    timings += time_attention_ssd(torch, fa, ssd, device)
    worst["decode_attention"] = check_decode_attention(torch, tda, device)
    timings += time_decode_attention(torch, tda, device)
    worst["ssm_decode"] = check_ssm_decode(torch, tsd, device)
    timings += time_ssm_decode(torch, tsd, device)
    params, cfg, prompts, done, captured, serve_launches = serve_hymba(
        torch, serve, T, fa, ssd, device)
    launches.update(serve_launches)
    serve_vs_plain(torch, serve, fa, ssd, params, cfg, prompts, done,
                   captured, device)
    del params, captured

    # the paper's other two workloads, the advisor and its full scenario
    advise(core, cost)
    kmeans_vs_eager(torch, core, ml, device)
    run_ae_pipeline(torch, core, ml, device)
    ae_vs_host(torch, core, ml, device)
    ae_vs_eager(torch, core, ml, device)
    run_iforest_pipeline(torch, core, ml, device)
    iforest_vs_host(torch, ml, device)
    iforest_vs_eager(torch, core, ml, device)
    outlier_example(torch, kk, device)
    calibrate(torch, kk, device)
    # the outlier models' graphs go before the LM phases need the card
    for fn in outlier_graph_fns():
        fn.clear()
    lm_example(torch, fa, device)

    # training: internlm2-1.8b at full width, card against host, resume,
    # int8 compression on an NCCL group, eager and through its graph (no
    # hand-written kernel: the reference trains with impl="dense", and its
    # Pallas kernels have no gradient)
    train_full(torch, TL, TS, T, device)
    train_vs_host(torch, TS, T, device)
    train_resume(torch, TL, TS, device)
    int8_pod(torch, TS, device)

    # the launch stack: the GPipe step at full width (both stages in one
    # process) against the plain step and through its graph, and the
    # sharding rules on a one-rank NCCL mesh
    gpipe(torch, TS, T, device)
    shard_rules(torch, T, device)
    # the dry-run's cells on the host, and its counted bound against the
    # card's train and decode steps
    dryrun(torch, T, TS, device)

    # the rest of the zoo: MLA, M-RoPE with patch embeddings, MoE (the
    # flash kernel serves the GQA prefills; MLA's attention is dense)
    serve_mla(torch, serve, T, fa, device)
    mla_vs_host(torch, T, device)
    vlm_mrope(torch, T, fa, device)
    serve_zoo(torch, serve, T, L, fa, ssd, device, "serve_moe", MOE_ARCH,
              MOE_LAYERS, MOE_WAVES)
    moe_layer_vs_dense(torch, L, get_arch(MOE_ARCH), device)
    # the five archs never served on the card before (ROADMAP A11),
    # smallest first, each one's weights freed before the next
    for phase, arch, layers, waves in ZOO_SERVE:
        serve_zoo(torch, serve, T, L, fa, ssd, device, phase, arch, layers,
                  waves)

    kernels = []
    for name, replaces in (
            ("kmeans_assign_update", "src/repro/kernels/kmeans.py:196"),
            ("kmeans_assign", "src/repro/kernels/kmeans.py:196")):
        main_row = next(r for r in timings if r["kernel"] == name
                        and tuple(r["shape"]) == MAIN_SHAPE
                        and r["precision"] == "fp32")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/kmeans.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": main_row["kernel_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": None,
            "block_n": kk.DEFAULT_BLOCK_N})
    for name, source, replaces, main in (
            ("flash_attention",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:120", FLASH_MAIN[-1]),
            ("ssd_chunk_scan", "src/repro_torch/kernels/csrc/ssd.cu",
             "src/repro/kernels/ssd.py:92", SSD_MAIN[-1])):
        main_row = next(r for r in timings if r["kernel"] == name
                        and tuple(r["case"]) == main
                        and r["dtype"] == "fp32")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": main_row["kernel_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "library_backend": main_row.get("library_backend")})
    main_row = next(r for r in timings if r["kernel"] == "decode_attention"
                    and tuple(r["case"]) == DECODE_ATTENTION_MAIN[0])
    kernels.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": None, "fuses": "src/repro/models/layers.py:257",
        "launches": launches["decode_attention"],
        "max_abs_err": worst["decode_attention"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library_backend": main_row["library_backend"]})
    main_row = next(r for r in timings if r["kernel"] == "ssm_decode"
                    and tuple(r["case"]) == SSM_DECODE_MAIN[0])
    kernels.append({
        "name": "ssm_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_decode.cu",
        "replaces": None, "fuses": "src/repro/models/layers.py:728",
        "launches": launches["ssm_decode"],
        "max_abs_err": worst["ssm_decode"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
