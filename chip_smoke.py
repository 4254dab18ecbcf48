"""Chip smoke test of the PyTorch/CUDA port: builds the port's kernels,
holds each one to its plain PyTorch version on the card (flash attention
forward and gradient, its decode path against its split algorithm and a
row the same in any batch, the state sweep of ring attention, the ODC ring
gather and scatter-accumulate, their chained-layer versions and the
per-layer flags between a chained ring and the compute stream), holds the
cp ring's forward bitwise to the monolithic kernel and its gradient to
the plain route, holds the int8 codec and the compressed (q8) rings
bitwise to their plain versions, serves full-width qwen-1.5b through the
serve entry point in both modes, trains full-width qwen-1.5b with two
ranks on the card through the train entry point (ODC x minibatch,
collective x layer, ODC under the overlap schedule, context parallelism:
data 1 x cp 2 with lb_token plans, and the two-tier backends hier, pipe
and pipe-int8 as 2 nodes or stages x 1), trains pipe-int8 on a 2 x 2
layout at full width and reduced depth (22 layers), profiles a train
step of the first, the third and the cp run, saves and resumes a reduced
overlap run, and times each kernel against its bound and its library
yardstick.  The ssm family: the Mamba2 SSD scan (a chunk-parallel
sequence of four kernels, its launch plan and workspace held to the C
side's) against its plain version (forward at mamba2's and zamba2's
serve and train shapes and three more, the gradient route at the train
shape), mamba2-2.7b served at full width and
depth (its prefill logits against the plain scan route), and trained at
full width and 40 of its 64 layers with two ranks as collective x layer
and ODC x minibatch (step 0 against the plain scan route, one profiled
step).  The gather_matmul kernel (the ODC gather fused with its
consumer matmul) against its plain version at qwen-1.5b's MLP and
zamba2's in_proj shapes on 2 and 4 ranks, float32 and bfloat16, on its
two routes (bf16 on the tensor cores, whose SASS must hold HGMMA; f32 and
bf16 rows off 16 bytes on the CUDA cores), each call's route held to the
C side's plan and counted, and its refusal of ranks on two devices.  The
single-leaf scatter (an owner-side pull) and the two single-leaf gathers
(f32 and q8: read-once broadcasts) allocate nothing but their outputs and
give the same bits on any grid; the gathers also from sources off 16
bytes and for NaN bit patterns, and row 1 is timed at the (k, v) leaf the
cp run gathers.  The hybrid family: zamba2-1.2b served
at full width and depth (38 scans and 6 attention calls per prefill, its
logits against the plain scan and attention routes) and trained at full
width and depth with two ranks as collective x layer, ODC x minibatch and
odc-overlap (a profiled step of ODC x minibatch and one of odc-overlap).
The chained rings are timed at the grid the overlap gives them and at
the whole card.  The moe and vlm families: grok-1-314b served at its
published widths with 2 of its 64 layers (the prefill on the kernel and
on the plain attention route, and prefill of S-1 tokens plus one decode
step with the router tallies against the full forward, each under the
routing rule of ``repro_torch.models.moe.routing_rule``; a decode-step
profile), reduced grok-1 and llama4-maverick trained with two ranks as
collective x layer, ODC x minibatch and odc-overlap and with
weight-stationary experts (one profiled step), and chameleon-34b at its
published widths trained with 1 of 48 layers and served with 4.  The
audio family: the flash kernel at seamless-m4t-medium's encoder and
cross-attention shapes (non-causal, S != T, no segment ids; the cross
decode on the decode path), seamless-m4t-medium served at full width and
depth (12 + 12 layers; the prefill on the kernel and on the plain
attention route, and prefill of S-1 tokens plus one decode step from the
cached encoder output against the full forward; a decode-step profile)
and trained at full width and depth with two ranks as collective x
layer, ODC x minibatch and odc-overlap (two chained trunks; one profiled
step).  Post-training: GRPO on qwen-1.5b at full width and depth through
the post-training entry point with two ranks on the card, its rollouts
from the wave engine under ODC weight pushes (the row-1 gather kernel,
one launch a sharded leaf), from the continuous engine with live ODC
pushes and with the collective's barrier push, each push held bitwise to
the trainer's parameters, the staleness bound, the --metrics push bytes
and the --trace lanes checked; synthetic rollouts at staleness 0 on the
kernel and on the plain route; one push timed.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It exits non-zero, printing no result, when there is no CUDA device or the
repository's ``src/`` is not beside it.  The last line of its output is
``{"ok": true, "device": {...}}``, printed only when every phase passed;
the line before it is the kernels' JSON record.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Peaks of one H100 SXM (NVIDIA data sheet, dense): the f32 rate of the
# CUDA cores, the bf16 tensor-core rate, and the HBM3 rate.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12

# Kernel vs plain tolerance, |diff| <= TOL * (1 + |plain|), on rows with at
# least one valid key.  float32: both sides sum the 128-term dots and the
# T-term softmax in a different order (measured error below 1e-6 on the
# H100).  bfloat16: both compute in f32 from the same inputs, so the
# outputs differ by at most one bf16 rounding step (2**-7 relative).
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# Full-width prefill, kernel vs plain attention through 28 layers: the
# last-position logits in f32 (|logits| ~ 1).
LOGITS_TOL = 1e-3

# Flash gradient, kernel route (CUDA forward + ported backward) vs the
# plain route (autograd through the plain version), |diff| <= tol * (1 +
# |plain|): both in f32 from the same inputs, the T-term sums taken in
# another order (materialized softmax and autograd vs closed-form VJP).
GRAD_TOL = 1e-4
# Train, ODC x minibatch vs collective x layer.  Step 0: the same
# parameters and batches through the same forward, so the losses are
# equal (tolerance 0).  Its gradients are summed in another order (per
# rank over M microbatches, then over the n ranks; against per
# microbatch over the ranks), so each element differs by at most about
# 2*n*M*u of the sum of its |terms| (u = 2**-24; n = M = 2 here), and
# the step-0 global norms by about that relative (5e-7): 1e-5 is twenty
# times it.
# The norm is what a scatter that drops, repeats or rescales a rank's
# contribution changes, and AdamW with the norm clip hides a rescaled
# gradient from the losses.
GRAD_NORM_RTOL = 1e-5
# Later losses: AdamW's first steps move each weight by about
# lr * sign(g), so only elements whose gradient is within rounding of 0
# can move another way, and they move the loss by a second-order amount.
# Every sound run measured 0; the limit leaves room for a flip of that
# kind and no more (the readings of planted faulty scatters: PERF.md).
TRAIN_LOSS_RTOL = 1e-5
# Weight-stationary experts (moe_ep='data') against the gathering run:
# tests/test_moe_ep.py holds every parameter after one step at lr 1e-2
# within 2e-3, a fifth of the lr; the same fifth of the run's lr (2e-4 at
# the driver's 1e-3).  AdamW's update barely changes when a gradient is
# scaled, so an expert gradient counted twice shows only in the step-0
# gradient norm, which the run is held to as every config is
# (``_hold_to_first``); a gradient on the wrong rank's shard moves its
# parameters by about the lr a step.
EP_PARAM_TOL_PER_LR = 0.2

# The serve runs: qwen-1.5b at its published widths, fp32, one card.
ARCH = "qwen-1.5b"
WAVE = dict(batch=8, prompt_len=512, gen=32)
CONT = dict(slots=4, requests=12, length_spread=4.0, prompt_len=512, gen=32)
SEED = 0
# The train runs: qwen-1.5b at its published widths and depth, fp32, two
# ranks on the one card, LongAlign lengths planned by LB-Mini.
TRAIN = dict(data_axis=2, steps=3, max_tokens=4096, max_len=4096,
             minibatch_per_device=4)
# the first config is the reference the others are held to
TRAIN_CONFIGS = (("collective", "layer"), ("odc", "minibatch"),
                 ("odc-overlap", "overlap"))
# The cp run: qwen-1.5b at its published widths and depth, fp32, data 1 x
# cp 2 on the one card, LongAlign lengths up to 8192 planned by lb_token:
# each rank's budget is 4096 tokens, a group row holds 8192.
CP_TRAIN = dict(cp=2, steps=3, max_tokens=4096, max_len=8192,
                minibatch_per_device=4)
# cp step 0 against the same step with every attention run by the plain
# route (allgather_attention under autograd): the loss and the gradient
# norm, relative.  Both are sums over every token and parameter of values
# that differ by f32 rounding in the attention (sum order), about 1e-7
# relative; a wrong chunk, mask or slice moves them by far more.
CP_PLAIN_RTOL = 1e-5
# The ring's group gradient at the train shape against the plain route,
# |diff| <= tol * (1 + |plain|): as GRAD_TOL, the same closed form against
# autograd of the materialized softmax in f32; dk and dv are sums over up
# to 6 heads x 8192 rows of terms that cancel (random cotangents), so
# their rounding is about sqrt(49152) * 2**-24 of the terms' magnitude.
# (1e-5 is too tight for that: the first run read 2.956e-5; the flat
# flash gradient at 4096 rows reads 5.5e-5 under the same 1e-4.)
CP_GRAD_TOL = GRAD_TOL
# lengths of the samples packed into the cp checks' 8192-token row
CP_ROW_LENS = (3000, 2500, 2000)

# single-leaf ring cases: ranks, shard elements (1 and 1001 odd: the pull
# scatter's chunks start off 16 bytes), dtypes
RING_NS = (2, 3, 4, 8, 16)
RING_SIZES = (1, 1001, 2 ** 20)
# chained ring cases: ranks (16 needs a non-portable cluster of 16 blocks;
# the card tests hold that case)
LAYER_RING_NS = (2, 3, 4, 8)
# qwen-1.5b's largest leaf, the stacked w_up (28, 1536, 8960), as each of
# 2 ranks holds it; and a 2**24-element shard on 4 ranks
W_UP_SHARD = (28, 768, 8960)
# chained ring cases: layers (28 on 4 and 8 ranks: 84 and 196 hops, above
# the q8 scatter's tag stride of 64), and the ragged per-layer shard of
# each case
LAYER_RING_LS = (1, 3, 28)
# q8 ring cases: ranks and shard shapes (ragged against the 256-value
# chunks), and w_up's shard on 2 ranks
Q8_RING_NS = (2, 3, 4)
Q8_RING_SHAPES = ((1,), (1000,), (4099, 3))
# The two-tier train runs: TRAIN's settings, the two ranks as 2 nodes (hier)
# or 2 stages (pipe, pipe-int8) of 1 device each
TIER_CONFIGS = (("hier", ("--nodes", "2")),
                ("pipe", ("--pipe-stages", "2")),
                ("pipe-int8", ("--pipe-stages", "2")))
# The reference's own bound on |loss(pipe-int8) - loss(pipe)|
# (tests/test_pipe.py::test_pipe_matches_collective_and_int8_within_bound);
# printed against, not enforced: a gap above it with the kernel route equal
# to the plain route would be the algorithm's, not the port's
INT8_LOSS_GAP = 1e-2
# The 2 x 2 pipe-int8 run: four ranks at full width hold about 11 copies
# of the parameters (gathered and gradient trees of every rank, shards, m,
# v), 74 GB at full depth; on an H100 16 of the 28 layers peaked at 44.14
# GiB and 22 at 52.79 GiB, while 26 ran out of the card: 53.23 GiB
# allocated and 25.07 GiB reserved but free (the allocator's fragments
# after the earlier runs)
PIPE4 = dict(data_axis=4, layers=22)

# The ssm family: mamba2-2.7b at its published widths, fp32.
MAMBA = "mamba2-2.7b"
# SSD scan kernel vs ssd_scan_plain, |diff| <= tol * (1 + |plain|).  The
# reference's own kernel-vs-oracle tolerances (tests/test_kernels.py:198)
# are 1e-4 and 5e-2; tightened, since both sides sum the chunk's decay
# alike (decay_cumsum: f64, rounded once) and differ only in the order of
# the f32 sums over Q and n: float32 read 3.4e-7 on the H100 (and 9.7e-5
# before the f64 decay sum, when a CUDA cumsum's f32 parallel scan fed the
# plain side), so 1e-5; bfloat16 y is one bf16 rounding of nearly equal
# f32 values on each side, at most one step, 2**-7 of |y|: 1e-2
SSD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# The scan's gradient route (its backward differentiates ssd_chunked)
# against autograd through the plain version: two f32 algorithms.  Each is
# within 1.31e-3 of the float64 gradient at (1, 512, 4, 64, 1, 128) (dA;
# measured on the CPU), since the chunk's cumulative decay reaches |acum|
# ~ 180 at Q = 256 and exp() turns its f32 rounding into a relative
# error; so the two may differ by twice that.  GRAD_TOL's 1e-4 is too
# tight: the card read 6.79e-4 at that shape, and 5.64e-4 (dA) at the
# train shape
SSD_GRAD_TOL = 2e-3
# (b, s, h, p, g, n, Q, padded tail): mamba2's serve prefill and train
# shapes, the serve shape with a padded tail (dt = 0), the reference
# test's g > 1 and zamba2-like cases (tests/test_kernels.py:184-188), and
# zamba2-1.2b's serve prefill and train shapes (64 heads, p 64, n 64)
SSD_CASES = {
    "serve prefill": (8, 512, 80, 64, 1, 128, 256, 0),
    "train": (1, 4096, 80, 64, 1, 128, 256, 0),
    "padded tail": (8, 512, 80, 64, 1, 128, 256, 40),
    "g=2": (1, 128, 8, 32, 2, 16, 32, 0),
    "zamba2-like": (1, 64, 2, 64, 2, 64, 64, 0),
    "zamba2 serve prefill": (8, 512, 64, 64, 1, 64, 256, 0),
    "zamba2 train": (1, 4096, 64, 64, 1, 64, 256, 0),
}
# The mamba2 train runs: TRAIN's settings at full width, depth cut.  Two
# ranks on one card hold about 28 bytes a parameter (the shards, m and v;
# each rank's gathered tree and accumulated gradient): 70.5 GiB of the
# card's 79.2 at 64 layers, 45.3 GiB at 40
MAMBA_LAYERS = 40

# gather_matmul: (ranks, m, k, f) of each checked and timed call, rank r's
# x (m, k) and shard (k / ranks, f): qwen-1.5b's MLP projections at a
# 4096-token microbatch (w_up, w_down), zamba2-1.2b's in_proj, and w_up
# over 4 ranks
GM_CASES = {
    "w_up": (2, 4096, 1536, 8960),
    "w_down": (2, 4096, 8960, 1536),
    "zamba2 in_proj": (2, 4096, 2048, 8384),
    "w_up 4 ranks": (4, 4096, 1536, 8960),
}
# kernel vs plain, max |diff| <= tol * max |plain| over each rank's output.
# float32: both sum each hop's k/n-term dots in f32 in another order (an
# H100 read 2.7e-6 at w_down, and 0 elsewhere); bfloat16: both
# sum the exact products of bf16 values in f32 and round once to bf16, so
# at most one bf16 step (2**-7 relative) apart
GM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

# The hybrid family: zamba2-1.2b at its published widths and depth, fp32
# (38 mamba blocks: 6 super-layers of 6 and a tail of 2; one shared
# attention block after each super-layer), served with WAVE's settings and
# trained with TRAIN's.  Two ranks hold about 28 bytes a parameter (the
# shards, m and v; each rank's gathered tree and accumulated gradient),
# 28.8 GiB at its 1.105 B parameters, and the overlap's gathered trunk and
# packed shards about 10.3 GiB more: full depth fits the card (peaks on an
# H100 80GB: 38.7 GiB, and 49.0 under the overlap schedule)
ZAMBA = "zamba2-1.2b"
# The moe and vlm families, f32, seed 0.  grok-1-314b serves at its
# published widths with 2 of its 64 layers: 7.43 B parameters, 29.7 GB
# (its full depth, 314 B, is ten times the card).  Training a moe config
# at full width does not fit one card (one grok-1 layer with AdamW state
# and ODC's gathered copies needs about 130 GB), so the reduced grok-1
# (period 1, top-2, gelu) and llama4-maverick (period 2, top-1, swiglu, a
# shared expert, 8 vision-stub positions) train with TRAIN's batches.
# chameleon-34b trains at its published widths with 1 of its 48 layers
# (1.77 B parameters with its untied embedding and head) and serves with 4
# (3.9 B, 15.4 GB).
GROK = "grok-1-314b"
LLAMA4 = "llama4-maverick-400b-a17b"
CHAMELEON = "chameleon-34b"
GROK_SERVE_LAYERS = 2
CHAMELEON_TRAIN_LAYERS = 1
CHAMELEON_SERVE_LAYERS = 4
# The audio family: seamless-m4t-medium at its published widths and depth
# (12 encoder and 12 decoder layers, 16/16 heads of 64, 614,739,968
# parameters, 2.46 GB in f32), served with WAVE's settings and as many
# encoder frames as prompt tokens (the JAX serve driver's enc_len = S),
# trained with TRAIN's batches and 16 frames a microbatch row (the train
# driver's stub).  Two ranks hold about 17 GB of weights, AdamW state,
# gathered copies and gradients, and a 4096-token microbatch's logits over
# the 256,206-token tied vocabulary 4.2 GB each: full depth fits the card.
SEAMLESS = "seamless-m4t-medium"
# Post-training: GRPO on qwen-1.5b at its published widths and depth,
# fp32, two ranks on the card, the JAX driver's GRPO defaults (8 prompts x
# a group of 4, prompts of 16 tokens, rollouts up to 192 tokens), a
# 1024-token microbatch budget, 3 iterations at staleness 1; the
# continuous engine with 8 slots
POSTTRAIN = dict(data_axis=2, prompts=8, group=4, prompt_len=16,
                 rollout_max_len=192, max_tokens=1024, slots=8, lr=1e-3)
# (run, --rollout, --comm, iterations, staleness, rollout max len): ODC
# pushes into the wave engine and live into the continuous engine, the
# collective's barrier push; then one short iteration under odc-overlap
# (the chained rings train) and pipe-int8 (2 stages x 1: the push and the
# train step on the int8 wire) for the launch counts of rows 2, 4, 7-10
POSTTRAIN_RUNS = (("a", "engine", "odc", 3, 1, 192),
                  ("b", "continuous", "odc", 3, 1, 192),
                  ("c", "continuous", "collective", 3, 1, 192),
                  ("e", "engine", "odc-overlap", 1, 0, 48),
                  ("f", "engine", "pipe-int8", 1, 0, 48))


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# phase 1: environment
# ---------------------------------------------------------------------------
def phase_env() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA device")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    print(smi, flush=True)
    return {"smi": smi}


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, rec in logs.items():
        for line in rec["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                log(f"  {name}: {line.strip()}")
    # gather_matmul's bf16 route must reach the tensor cores: HGMMA in the
    # SASS of the built library
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    lib = _build._target("gather_matmul")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    hgmma = sum("HGMMA" in line for line in sass.splitlines())
    log(f"gather_matmul SASS ({lib.name}): {hgmma} HGMMA lines")
    if hgmma == 0:
        fail("gather_matmul's tensor-core route has no HGMMA in its SASS")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version on the card
# ---------------------------------------------------------------------------
def _attn_case(B, S, T, H, KH, hd, dtype, *, seed, q_pos=None, kv_valid=None,
               packed=False, q_packed=False, causal=True, window=0,
               softcap=0.0):
    """Inputs of one attention call.  q_pos: (B,) first query position of
    each row (decode: the cache index); kv_valid: (B,) last written cache
    position, later positions arrive as -1e9 like the serve path's
    masked cache tail; q_packed: q positions of a packed train row
    (``_packed_positions``) and no segment ids, as the decoder's cross-
    attention takes them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn(B, S, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, T, KH, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, T, KH, hd, generator=g, device=dev).to(dtype)
    start = torch.zeros(B, dtype=torch.int32, device=dev) if q_pos is None \
        else torch.tensor(q_pos, dtype=torch.int32, device=dev)
    qp = start[:, None] + torch.arange(S, dtype=torch.int32, device=dev)
    kp = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    if kv_valid is not None:
        last = torch.tensor(kv_valid, dtype=torch.int32, device=dev)
        kp = torch.where(kp <= last[:, None], kp, -(10 ** 9))
    kw = dict(causal=causal, window=window, logit_softcap=softcap,
              q_positions=qp, kv_positions=kp.contiguous())
    if packed:  # two packed segments and a padding tail, S == T
        pad, cut = S // 8, (S - S // 8) // 2
        seg = torch.full((B, S), -1, dtype=torch.int32, device=dev)
        pos = torch.full((B, S), -(10 ** 9), dtype=torch.int32, device=dev)
        seg[:, :cut], seg[:, cut:S - pad] = 0, 1
        pos[:, :cut] = torch.arange(cut, device=dev, dtype=torch.int32)
        pos[:, cut:S - pad] = torch.arange(S - pad - cut, device=dev,
                                           dtype=torch.int32)
        kw.update(q_positions=pos, kv_positions=pos, q_segment_ids=seg,
                  kv_segment_ids=seg)
    if q_packed:
        kw["q_positions"] = _packed_positions(S).expand(B, S).contiguous()
    return q, k, v, kw


def _packed_positions(S):
    """(1, S) int32 positions of a packed train row of three LongAlign-like
    samples and a padding tail (1500/1800/500 tokens of 4096, scaled to
    S), as ``data.packing.pack_sequences`` lays them out: positions
    restart per sample, the padding sits at position 0."""
    from repro_torch.data.packing import pack_sequences
    import numpy as np

    lens = [max(1, n * S // 4096) for n in (1500, 1800, 500)]
    row = pack_sequences([np.zeros(n, np.int32) for n in lens], S)
    return torch.from_numpy(row["positions"])[None].cuda()


# name -> (B, S, T, H, KH, hd, options); H 12 / KH 2 / hd 128 is qwen's
ATTN_CASES = {
    "prefill S=T causal": (2, 256, 256, 12, 2, 128, {}),
    "prefill over masked cache": (2, 100, 300, 12, 2, 128,
                                  {"kv_valid": [99, 99]}),
    "decode uniform index": (4, 1, 300, 12, 2, 128,
                             {"q_pos": [150] * 4, "kv_valid": [150] * 4}),
    "decode per-row index": (4, 1, 300, 12, 2, 128,
                             {"q_pos": [3, 77, 150, 299],
                              "kv_valid": [3, 77, 150, 299]}),
    "ragged S/T hd64": (1, 77, 131, 4, 2, 64, {"q_pos": [54]}),
    "window+softcap hd256": (2, 300, 300, 4, 2, 256,
                             {"window": 64, "softcap": 50.0}),
    "packed segments hd32": (2, 256, 256, 4, 1, 32, {"packed": True}),
    "serve prefill": (8, 512, 544, 12, 2, 128, {"kv_valid": [511] * 8}),
    "serve decode": (8, 1, 544, 12, 2, 128,
                     {"q_pos": [527] * 8, "kv_valid": [527] * 8}),
    # zamba2-1.2b's shared block: 32 heads of 64 over 32 KV heads (MHA)
    "zamba2 serve prefill": (8, 512, 544, 32, 32, 64,
                             {"kv_valid": [511] * 8}),
    "zamba2 serve decode": (8, 1, 544, 32, 32, 64,
                            {"q_pos": [527] * 8, "kv_valid": [527] * 8}),
    # seamless-m4t-medium: 16 heads of 64 over 16 KV heads (MHA), every
    # call non-causal with no segment ids: the encoder's self-attention
    # over 512 serve frames, the decoder's cross-attention to them at
    # prefill (512 x 512) and decode (1 x 512), and in training (a
    # 4096-token packed row x 16 frames)
    "seamless encoder serve": (8, 512, 512, 16, 16, 64, {"causal": False}),
    "seamless cross prefill": (8, 512, 512, 16, 16, 64, {"causal": False}),
    "seamless cross decode": (8, 1, 512, 16, 16, 64,
                              {"q_pos": [527] * 8, "causal": False}),
    "seamless train cross": (1, 4096, 16, 16, 16, 64,
                             {"q_packed": True, "causal": False}),
}


def _compare(out, ref, kw, dtype):
    from repro_torch.kernels.flash_attention import attn_mask

    mask = attn_mask(kw["q_positions"], kw["kv_positions"],
                     kw.get("q_segment_ids"), kw.get("kv_segment_ids"),
                     causal=kw["causal"], window=kw["window"])
    rows = mask.any(-1)  # (B, S): rows with at least one valid key
    o, r = out.float()[rows], ref.float()[rows]
    err = (o - r).abs()
    ok = bool(torch.isfinite(o).all()) and bool(
        (err <= TOL[dtype] * (1 + r.abs())).all())
    return ok, float(err.max()), int(rows.sum())


def phase_kernel_cases() -> dict:
    from repro_torch.kernels import flash_attention as fa

    errs = {}
    bad = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, (B, S, T, H, KH, hd, opt)) in enumerate(
                ATTN_CASES.items()):
            q, k, v, kw = _attn_case(B, S, T, H, KH, hd, dtype, seed=i, **opt)
            out = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(q, k, v, **kw)
            ok, err, nrows = _compare(out, ref, kw, dtype)
            errs[(name, dtype)] = err
            tag = str(dtype).replace("torch.", "")
            log(f"flash_attention vs plain [{tag:8s}] {name:28s} "
                f"max|diff| {err:.3e} over {nrows} rows "
                f"(tol {TOL[dtype]:g}) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(f"{name} {tag}")
    if bad:
        fail(f"flash_attention disagrees with its plain version: {bad}")
    return errs


# ---------------------------------------------------------------------------
# phase 3a': the decode path (split keys over a cluster) against the plain
# version and its own algorithm, and a row the same in any batch
# ---------------------------------------------------------------------------
# name -> (B, S, T, H, KH, hd, options), every one at or under the decode
# path's rows threshold: qwen's and zamba2's serve decode, per-row cache
# indices, two positions of qwen's 6 heads, and the threshold's 8 rows at
# head dim 256 and 16 at head dim 32
DECODE_CASES = {
    "serve decode": ATTN_CASES["serve decode"],
    "zamba2 serve decode": ATTN_CASES["zamba2 serve decode"],
    "decode per-row index": ATTN_CASES["decode per-row index"],
    "2 positions x 6 heads": (4, 2, 300, 12, 2, 128,
                              {"q_pos": [3, 77, 150, 298],
                               "kv_valid": [4, 78, 151, 299]}),
    "8 rows hd256 window+softcap": (2, 8, 300, 2, 2, 256,
                                    {"q_pos": [100, 292],
                                     "kv_valid": [107, 299], "window": 64,
                                     "softcap": 30.0}),
    "16 rows hd32": (2, 16, 700, 2, 2, 32, {"q_pos": [600, 10],
                                            "kv_valid": [615, 25]}),
    "seamless cross decode": ATTN_CASES["seamless cross decode"],
}


def phase_decode() -> dict:
    """Each decode case takes the decode path (its launch plan), agrees
    with ``flash_attention_plain`` and with ``flash_decode_split_plain``
    (the path's split and merge) within TOL on rows with a valid key, and
    gives each batch row bit for bit what that row gives alone."""
    from repro_torch.kernels import flash_attention as fa

    bad = []
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for i, (name, (B, S, T, H, KH, hd, opt)) in enumerate(
                DECODE_CASES.items()):
            if not fa.launch_plan(B, S, T, H, KH, hd, dtype)["decode"]:
                fail(f"decode case {name} does not take the decode path")
            q, k, v, kw = _attn_case(B, S, T, H, KH, hd, dtype, seed=40 + i,
                                     **opt)
            out = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            errs = []
            for ref in (fa.flash_attention_plain(q, k, v, **kw),
                        fa.flash_decode_split_plain(q, k, v, **kw)):
                ok, err, nrows = _compare(out, ref, kw, dtype)
                errs.append(err)
                if not ok:
                    bad.append(f"{name} {tag}")
            alone = all(torch.equal(fa.flash_attention(
                q[b:b + 1], k[b:b + 1], v[b:b + 1],
                **{n: (x[b:b + 1] if torch.is_tensor(x) else x)
                   for n, x in kw.items()}), out[b:b + 1]) for b in range(B))
            if not alone:
                bad.append(f"{name} {tag}: a row alone differs from the "
                           f"same row in its batch")
            worst[(name, dtype)] = max(errs)
            log(f"decode path [{tag:8s}] {name:28s} max|diff| vs plain "
                f"{errs[0]:.3e}, vs split plain {errs[1]:.3e} over {nrows} "
                f"rows (tol {TOL[dtype]:g}); each row alone bitwise "
                f"{'equal' if alone else 'DIFFERENT'}")
    if bad:
        fail(f"decode path: {bad}")
    return worst


# ---------------------------------------------------------------------------
# phase 3b: the flash gradient, kernel route against the plain route
# ---------------------------------------------------------------------------
# the masking cases of tests/test_torch_cuda.py, and the train paths' calls:
# qwen's 12/2 heads of 128 and zamba2's shared block, 32/32 heads of 64
TRAIN_ATTN = "train packed 4096"
ZAMBA_TRAIN_ATTN = "zamba2 train packed 4096"
GRAD_CASES = {
    "causal hd128": (2, 130, 130, 12, 2, 128, {}),
    "window hd64": (1, 45, 70, 4, 2, 64, {"window": 16, "q_pos": [25]}),
    "window+softcap hd256": (2, 64, 64, 4, 2, 256,
                             {"window": 24, "softcap": 50.0}),
    "non-causal hd32": (2, 33, 33, 4, 1, 32, {"causal": False}),
    "seamless train cross": ATTN_CASES["seamless train cross"],
}


def _train_attn_case(seed, dtype=torch.float32, H=12, KH=2, hd=128):
    """One attention call of the train path: a 4096-token packed row of
    three LongAlign-like samples and a padding tail, laid out as
    ``data.packing.pack_sequences`` lays it out (positions restart per
    sample, padding is segment -1 at position 0), qwen's 12/2 heads of
    128 unless others are given."""
    from repro_torch.data.packing import pack_sequences
    import numpy as np

    S = TRAIN["max_tokens"]
    lens = (1500, 1800, 500)
    row = pack_sequences([np.zeros(n, np.int32) for n in lens], S)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(1, S, H, hd, generator=g, device="cuda").to(dtype)
    k = torch.randn(1, S, KH, hd, generator=g, device="cuda").to(dtype)
    v = torch.randn(1, S, KH, hd, generator=g, device="cuda").to(dtype)
    pos = torch.from_numpy(row["positions"])[None].cuda()
    seg = torch.from_numpy(row["segment_ids"])[None].cuda()
    kw = dict(causal=True, window=0, logit_softcap=0.0, q_positions=pos,
              kv_positions=pos, q_segment_ids=seg, kv_segment_ids=seg)
    return q, k, v, kw


def _grads(fn, q, k, v, kw, gout):
    """fn's output on (q, k, v), then dq, dk, dv for the cotangent gout."""
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v, **kw)
    out.backward(gout)
    return out.detach(), q.grad, k.grad, v.grad


def phase_flash_grad() -> dict:
    """Per case: (forward max|diff|, worst of dq/dk/dv max|diff|)."""
    from repro_torch.kernels import flash_attention as fa

    cases = {name: _attn_case(B, S, T, H, KH, hd, torch.float32, seed=i,
                              **opt)
             for i, (name, (B, S, T, H, KH, hd, opt))
             in enumerate(GRAD_CASES.items())}
    cases[TRAIN_ATTN] = _train_attn_case(seed=7)
    cases[ZAMBA_TRAIN_ATTN] = _train_attn_case(seed=8, H=32, KH=32, hd=64)
    found = {}
    for name, (q, k, v, kw) in cases.items():
        gout = torch.randn(q.shape, device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(11))
        before = fa.launches
        out, *kern = _grads(fa.flash_attention, q, k, v, kw, gout)
        torch.cuda.synchronize()
        if fa.launches != before + 1:
            fail(f"flash gradient {name}: the kernel route did not launch "
                 f"the kernel")
        ref, *plain = _grads(fa.flash_attention_plain, q, k, v, kw, gout)
        fwd_ok, fwd_err, nrows = _compare(out, ref, kw, torch.float32)
        if not fwd_ok:
            fail(f"flash forward {name}: kernel and plain version disagree "
                 f"(max|diff| {fwd_err:.3e} over {nrows} rows)")
        errs = []
        for a, b in zip(kern, plain):
            err = (a - b).abs()
            ok = bool(torch.isfinite(a).all()) and bool(
                (err <= GRAD_TOL * (1 + b.abs())).all())
            errs.append(float(err.max()))
            if not ok:
                fail(f"flash gradient {name}: kernel route and plain route "
                     f"disagree (max|diff| {float(err.max()):.3e})")
        found[name] = (fwd_err, max(errs))
        log(f"flash gradient {name:22s} q {tuple(q.shape)}: max|diff| out "
            f"{fwd_err:.3e} over {nrows} rows (tol {TOL[torch.float32]:g}), "
            f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
            f"(tol {GRAD_TOL:g}) ok")
        del out, ref, kern, plain
    torch.cuda.empty_cache()
    return found


# ---------------------------------------------------------------------------
# phase 3b': the state sweep of ring attention, the cp ring's forward
# against the monolithic kernel, and its group gradient
# ---------------------------------------------------------------------------
# name -> (B, S, kv chunk lengths, H, KH, hd, window): the first chunk
# starts from a fresh carry, the later ones carry it; q is the last S
# rows of a packed sequence of two segments and a padding tail
STATE_CASES = {
    "fresh, 1 chunk, 12/2 hd128": (2, 256, (256,), 12, 2, 128, 0),
    "4 chunks, 12/2 hd128, window 96": (2, 256, (64,) * 4, 12, 2, 128, 96),
    "3 ragged chunks, 4/4 hd64": (1, 77, (45, 45, 41), 4, 4, 64, 0),
    "2 ragged chunks, 4/4 hd64, window 96": (2, 131, (70, 61), 4, 4, 64,
                                             96),
}


def _packed_seq(B, T, dev="cuda"):
    """Positions and segment ids of B packed rows of T tokens: two
    segments and a padding tail at position -1e9 (no valid key)."""
    pad, cut = T // 8, (T - T // 8) // 2
    pos = torch.full((B, T), -(10 ** 9), dtype=torch.int32, device=dev)
    seg = torch.full((B, T), -1, dtype=torch.int32, device=dev)
    pos[:, :cut] = torch.arange(cut, device=dev, dtype=torch.int32)
    pos[:, cut:T - pad] = torch.arange(T - pad - cut, device=dev,
                                       dtype=torch.int32)
    seg[:, :cut], seg[:, cut:T - pad] = 0, 1
    return pos, seg


def phase_state_kernel():
    """The state sweep kernel against its plain version, chunk by chunk:
    the carry (f32) on rows with a valid key so far, and the finished
    output."""
    from repro_torch.kernels import flash_attention as fa

    bad = []
    for i, (name, (B, S, chunks, H, KH, hd, window)) in enumerate(
            STATE_CASES.items()):
        T = sum(chunks)
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(20 + i)
            q = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dtype)
            k, v = (torch.randn(B, T, KH, hd, generator=g,
                                device="cuda").to(dtype) for _ in range(2))
            pos, seg = _packed_seq(B, T)
            kw = dict(causal=True, window=window, q_positions=pos[:, T - S:],
                      q_segment_ids=seg[:, T - S:])
            carry = ref = None
            worst, ok, t0 = 0.0, True, 0
            for c in chunks:
                sl = slice(t0, t0 + c)
                t0 += c
                ck = dict(kw, kv_positions=pos[:, sl],
                          kv_segment_ids=seg[:, sl])
                carry = fa.flash_attention_state(q, k[:, sl], v[:, sl],
                                                 carry, **ck)
                torch.cuda.synchronize()
                ref = fa.flash_attention_state_plain(q, k[:, sl], v[:, sl],
                                                     ref, **ck)
                rows = fa.attn_mask(kw["q_positions"], pos[:, :t0],
                                    kw["q_segment_ids"], seg[:, :t0],
                                    causal=True, window=window).any(-1)
                for a, b in zip(carry, ref):
                    a, b = a[rows], b[rows]
                    err = (a - b).abs()
                    ok &= bool(torch.isfinite(a).all()) and bool(
                        (err <= TOL[torch.float32] * (1 + b.abs())).all())
                    worst = max(worst, float(err.max()) if err.numel() else 0)
            out = fa.finish_attention(carry, dtype).float()[rows]
            want = fa.finish_attention(ref, dtype).float()[rows]
            err = (out - want).abs()
            ok &= bool((err <= TOL[dtype] * (1 + want.abs())).all())
            tag = str(dtype).replace("torch.", "")
            log(f"flash_attention_state vs plain [{tag:8s}] {name:38s} q "
                f"{tuple(q.shape)} chunks {chunks}: carry max|diff| "
                f"{worst:.3e} (tol {TOL[torch.float32]:g}), output "
                f"{float(err.max()):.3e} over {int(rows.sum())} rows (tol "
                f"{TOL[dtype]:g}) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(f"{name} {tag}")
    if bad:
        fail(f"flash_attention_state disagrees with its plain version: {bad}")


def _cp_row(cp_deg, T, H=12, KH=2, hd=128, dtype=torch.float32, seed=0):
    """One packed train row of T tokens (CP_ROW_LENS scaled to T, then
    padding, laid out as ``data.packing.pack_sequences`` lays it out:
    positions restart per sample, padding is segment -1 at position 0),
    random q, k, v of qwen's heads, and the interleave of cp_deg ranks."""
    from repro_torch.core import cp
    from repro_torch.data.packing import pack_sequences
    import numpy as np

    scale = T / 8192
    lens = [max(1, int(n * scale)) for n in CP_ROW_LENS]
    row = pack_sequences([np.zeros(n, np.int32) for n in lens], T)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(1, T, H, hd, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(1, T, KH, hd, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    pos = torch.from_numpy(row["positions"])[None].cuda()
    seg = torch.from_numpy(row["segment_ids"])[None].cuda()
    perm = torch.from_numpy(cp.interleave_indices(T, cp_deg)).cuda()
    return q, k, v, pos, seg, perm


def phase_cp_bitwise() -> dict:
    """The cp ring's forward (the ring gather kernel, then the state
    kernel swept over the 2*cp chunks in ascending global order, or cp
    without interleave; every chunk a multiple of the kernel's kv tile)
    against the monolithic kernel on the gathered sequence: equal bit for
    bit on every row with a valid key."""
    from repro_torch.core import cp
    from repro_torch.kernels import flash_attention as fa

    cases = 0
    for n in (2, 4):
        for interleave in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                T = 2 * n * 256
                q, k, v, pos, seg, perm = _cp_row(n, T, dtype=dtype, seed=n)
                if not interleave:
                    perm = torch.arange(T, device="cuda")
                split = lambda x: list(x.index_select(1, perm).chunk(n, 1))
                with torch.no_grad():
                    outs = cp.ring_attention(
                        split(q), split(k), split(v), split(pos), split(seg),
                        interleave=interleave)
                    ref = fa.flash_attention(
                        q, k, v, q_positions=pos, kv_positions=pos,
                        q_segment_ids=seg, kv_segment_ids=seg)
                out = torch.empty_like(q)
                out[:, perm] = torch.cat(outs, 1)
                torch.cuda.synchronize()
                rows = fa.attn_mask(pos, pos, seg, seg, causal=True,
                                    window=0).any(-1)
                equal = torch.equal(out[rows], ref[rows])
                tag = (f"cp {n}, interleave {interleave}, "
                       f"{str(dtype).replace('torch.', '')}, {T} tokens")
                if not equal:
                    err = float((out[rows].float() - ref[rows].float())
                                .abs().max())
                    fail(f"cp ring forward ({tag}) is not bitwise the "
                         f"monolithic kernel: max|diff| {err:.3e}")
                cases += 1
    log(f"cp ring forward bitwise equal to the monolithic kernel on the "
        f"gathered sequence in {cases} cases (cp 2 and 4, interleave on "
        f"and off, float32 and bfloat16, chunks of 256 or 512 keys)")
    return {"cases": cases}


def phase_cp_grad() -> dict:
    """The ring's group Function at the train shape (one 8192-token row
    over cp 2, qwen's 12/2 heads, hd 128): output and dq, dk, dv against
    the plain route, ``allgather_attention`` under autograd."""
    from repro_torch.core import cp
    from repro_torch.kernels import flash_attention as fa

    n, T = CP_TRAIN["cp"], 2 * CP_TRAIN["max_tokens"]
    q, k, v, pos, seg, perm = _cp_row(n, T, seed=9)
    split = lambda x: list(x.index_select(1, perm).chunk(n, 1))
    gout = split(torch.randn(q.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(10)))
    found = {}
    for name, fn in (("ring", cp.ring_attention),
                     ("plain", cp.allgather_attention)):
        leaves = [[t.clone().requires_grad_(True) for t in split(x)]
                  for x in (q, k, v)]
        before = (fa.state_launches, fa.launches)
        outs = fn(*leaves, split(pos), split(seg))
        torch.autograd.backward(outs, gout)
        torch.cuda.synchronize()
        launched = (fa.state_launches - before[0], fa.launches - before[1])
        found[name] = ([o.detach() for o in outs],
                       [t.grad for ts in leaves for t in ts], launched)
        del outs, leaves
        torch.cuda.empty_cache()
    (outs, grads, launched), (pouts, pgrads, plaunched) = (found["ring"],
                                                          found["plain"])
    if launched != (2 * n * n, 0) or plaunched != (0, 0):
        fail(f"cp gradient: the ring launched {launched} (state, "
             f"monolithic) kernels, want ({2 * n * n}, 0); the plain route "
             f"{plaunched}, want (0, 0)")
    fwd = max(float((a - b).abs().max()) for a, b in zip(outs, pouts))
    errs = []
    for a, b in zip(grads, pgrads):
        err = (a - b).abs()
        errs.append(float(err.max()))
        if not (bool(torch.isfinite(a).all())
                and bool((err <= CP_GRAD_TOL * (1 + b.abs())).all())):
            fail(f"cp gradient: the ring and the plain route disagree "
                 f"(max|diff| {float(err.max()):.3e})")
    if not all(bool(((a - b).abs() <= TOL[torch.float32]
                     * (1 + b.abs())).all()) for a, b in zip(outs, pouts)):
        fail(f"cp forward: the ring and the plain route disagree "
             f"(max|diff| {fwd:.3e})")
    dq, dk, dv = (max(errs[i * n:(i + 1) * n]) for i in range(3))
    log(f"cp group gradient, {T} tokens over cp {n}, 12/2 heads, hd 128: "
        f"ring vs plain route max|diff| out {fwd:.3e} (tol "
        f"{TOL[torch.float32]:g}), dq {dq:.3e} dk {dk:.3e} dv {dv:.3e} "
        f"(tol {CP_GRAD_TOL:g}) ok")
    del found, grads, pgrads
    torch.cuda.empty_cache()
    return {"fwd": fwd, "dq": dq, "dk": dk, "dv": dv}


# ---------------------------------------------------------------------------
# phase 3c: the ODC ring kernels against the plain rings
# ---------------------------------------------------------------------------
def _ring_orders(n):
    """The natural ring and a DeviceProfile's ring order."""
    from repro_torch.balance.cost import make_straggler_profile
    from repro_torch.core import odc

    order = odc.ring_order(n, make_straggler_profile(
        "uniform", n, slow_factor=2.0, seed=0))
    if order is None:
        fail(f"the profile of {n} ranks orders its ring naturally")
    return [None, order]


def _scatter_bound(ys, n, c, dtype):
    """Elementwise bound on |ring - one library sum|: each sum rounds n-1
    times (in its own order), each rounding is at most one unit roundoff
    u of a partial sum, and every partial sum is at most the sum of |y|
    over the ranks; 2n instead of 2(n-1) covers the second-order terms."""
    u = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8}[dtype]
    return [2 * n * u * torch.stack([y[r * c:(r + 1) * c].float().abs()
                                     for y in ys]).sum(0)
            for r in range(n)]


def _ring_case(n, order, dtype, shape, g):
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import odc_scatter as S

    xs = [torch.randn(shape, generator=g, device="cuda").to(dtype)
          for _ in range(n)]
    out = G.odc_gather(xs, order)
    torch.cuda.synchronize()
    ref = G.odc_gather_plain(xs, order)
    gather_ok = all(torch.equal(a, b) for a, b in zip(out, ref))
    del xs, out, ref
    c = shape[0]
    ys = [torch.randn((n * c,) + tuple(shape[1:]), generator=g,
                      device="cuda").to(dtype) for _ in range(n)]
    out = S.odc_scatter_accumulate(ys, order)
    torch.cuda.synchronize()
    ref = S.odc_scatter_accumulate_plain(ys, order)
    scatter_ok = all(torch.equal(a, b) for a, b in zip(out, ref))
    lib = [torch.stack([y[r * c:(r + 1) * c] for y in ys]).sum(0)
           for r in range(n)]
    bound = _scatter_bound(ys, n, c, dtype)
    lib_ok = all(bool(((a.float() - b.float()).abs() <= e).all())
                 for a, b, e in zip(out, lib, bound))
    rel = max(float(((a.float() - b.float()).abs()
                     / (1 + b.float().abs())).max())
              for a, b in zip(out, lib))
    return gather_ok, scatter_ok, lib_ok, rel


def phase_rings() -> dict:
    g = torch.Generator(device="cuda").manual_seed(3)
    bad, worst_rel = [], {torch.float32: 0.0, torch.bfloat16: 0.0}
    bitwise = within = 0
    cases = [(n, order, dtype, (c,)) for n in RING_NS
             for order in _ring_orders(n)
             for dtype in (torch.float32, torch.bfloat16)
             for c in RING_SIZES]
    cases.append((2, None, torch.float32, W_UP_SHARD))
    for n, order, dtype, shape in cases:
        gok, sok, lok, rel = _ring_case(n, order, dtype, shape, g)
        worst_rel[dtype] = max(worst_rel[dtype], rel)
        bitwise += gok and sok
        within += lok
        tag = (f"n={n} order={order or 'natural'} "
               f"{str(dtype).replace('torch.', '')} shard {shape}")
        if not (gok and sok and lok):
            bad.append(f"{tag}: gather==plain {gok} scatter==plain {sok} "
                       f"scatter~sum {lok}")
    torch.cuda.empty_cache()
    log(f"ring kernels: {len(cases)} cases (n in {RING_NS}, natural and "
        f"profile-ordered rings, float32 and bfloat16, shards of "
        f"{RING_SIZES} elements and w_up's {W_UP_SHARD}): gather and "
        f"scatter bitwise equal to the plain rings in {bitwise}; scatter "
        f"vs torch.stack().sum(0) within 2n*u*sum|y| in {within}, max "
        f"|diff|/(1+|sum|) float32 "
        f"{worst_rel[torch.float32]:.2e} bfloat16 "
        f"{worst_rel[torch.bfloat16]:.2e}")
    if bad:
        fail("ring kernels disagree with the plain rings:\n  "
             + "\n  ".join(bad))
    _scatter_alloc_and_grid(g)
    return {"cases": len(cases), "rel": worst_rel}


def _peak_growth(fn):
    """(result, peak bytes allocated above the start in one call of fn)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


def _scatter_alloc_and_grid(g):
    """The pull scatter allocates its outputs and nothing else (no staging,
    no flags), and gives the same bits on any grid."""
    from repro_torch.kernels import odc_scatter as S

    n, c = 4, 2 ** 22
    ys = [torch.randn(n * c, generator=g, device="cuda") for _ in range(n)]
    ref = S.odc_scatter_accumulate_plain(ys)
    S.odc_scatter_accumulate(ys)
    out, grew = _peak_growth(lambda: S.odc_scatter_accumulate(ys))
    outputs = sum(o.numel() * o.element_size() for o in out)
    same = all(torch.equal(a, b) for a, b in zip(out, ref))
    del out
    grids = {}
    for grid in (1, 7, 1 << 20):
        out = S.odc_scatter_accumulate(ys, blocks_per_rank=grid)
        torch.cuda.synchronize()
        grids[grid] = all(torch.equal(a, b) for a, b in zip(out, ref))
        del out
    log(f"pull scatter, n={n} c={c} float32: peak growth {grew} bytes in a "
        f"call, its outputs {outputs}; bitwise the plain ring {same}, on "
        f"grids of 1, 7 and 2**20 blocks a rank {list(grids.values())}")
    if grew != outputs or not same or not all(grids.values()):
        fail("the pull scatter allocates more than its outputs or is not "
             "bitwise the plain ring on every grid")
    del ys, ref
    torch.cuda.empty_cache()


def _layer_ring_case(n, order, dtype, L, c, g):
    """The chained gather, the chained scatter, and the chained scatter
    in backward layer order accumulating into a start value, each against
    its plain version (bitwise)."""
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import odc_scatter as S

    xs = [torch.randn((L, c, 3), generator=g, device="cuda").to(dtype)
          for _ in range(n)]
    out = G.odc_gather_layers(xs, order)
    torch.cuda.synchronize()
    ref = G.odc_gather_layers_plain(xs, order)
    gather_ok = all(torch.equal(a, b) for a, b in zip(out, ref))
    del xs, out, ref
    ys = [torch.randn((L, n * c, 3), generator=g, device="cuda").to(dtype)
          for _ in range(n)]
    out = S.odc_scatter_accumulate_layers(ys, order)
    torch.cuda.synchronize()
    ref = S.odc_scatter_accumulate_layers_plain(ys, order)
    scatter_ok = all(torch.equal(a, b) for a, b in zip(out, ref))
    start = [torch.randn((L, c, 3), generator=g, device="cuda").to(dtype)
             for _ in range(n)]
    acc = [a.clone() for a in start]
    S.odc_scatter_accumulate_layers(ys, order, reverse=True, out=acc)
    torch.cuda.synchronize()
    ref = [a + b for a, b in zip(start, S.odc_scatter_accumulate_layers_plain(
        ys, order, reverse=True))]
    acc_ok = all(torch.equal(a, b) for a, b in zip(acc, ref))
    return gather_ok, scatter_ok, acc_ok


def phase_layer_rings() -> dict:
    """Both chained kernels against their plain versions over every case;
    then a grid that cannot be resident is refused before it runs."""
    from repro_torch.kernels import _ring
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import odc_scatter as S

    g = torch.Generator(device="cuda").manual_seed(4)
    bad, ok, hops = [], 0, 0
    cases = [(n, order, dtype, L) for n in LAYER_RING_NS
             for order in _ring_orders(n)
             for dtype in (torch.float32, torch.bfloat16)
             for L in LAYER_RING_LS]
    for i, (n, order, dtype, L) in enumerate(cases):
        c = 997 + 13 * i  # ragged: no multiple of 8
        res = _layer_ring_case(n, order, dtype, L, c, g)
        hops = max(hops, L * (n - 1))
        tag = (f"n={n} order={order or 'natural'} "
               f"{str(dtype).replace('torch.', '')} L={L} c={c}x3")
        if all(res):
            ok += 1
        else:
            bad.append(f"{tag}: gather {res[0]} scatter {res[1]} "
                       f"reversed+accumulate {res[2]}")
    torch.cuda.empty_cache()
    with torch.cuda.device(0):
        cap = 2 * _ring.capacity(_build_lib("odc_gather"),
                                 "repro_odc_gather_layers_capacity", 2,
                                 _ring.chain_layout("gather", 2).smem_bytes)
    log(f"chained ring kernels: {len(cases)} cases (n in {LAYER_RING_NS}, natural "
        f"and profile-ordered, float32 and bfloat16, L in {LAYER_RING_LS}, "
        f"ragged shards, up to {hops} hops in a launch): gather, scatter and "
        f"reversed accumulating scatter bitwise equal to the plain rings in "
        f"{ok}; grid capped at 1/{_ring.CHAIN_SHARE} of the card's "
        f"{cap} co-resident blocks (the gather's clusters of 2 at n = 2)")
    if bad:
        fail("chained ring kernels disagree with the plain rings:\n  "
             + "\n  ".join(bad))
    xs = [torch.ones((3, 64), device="cuda") for _ in range(2)]
    ys = [torch.ones((3, 128), device="cuda") for _ in range(2)]
    for fn, mod, args in ((G.odc_gather_layers, G, xs),
                          (S.odc_scatter_accumulate_layers, S, ys)):
        before = mod.layers_launches
        try:
            fn(args, blocks_per_rank=1 << 20)
        except RuntimeError as e:
            log(f"chained ring refusal: {e}")
        else:
            fail(f"{fn.__name__} launched a grid that cannot be co-resident")
        if mod.layers_launches != before:
            fail(f"{fn.__name__} counted a refused launch")
    out = G.odc_gather_layers(xs)
    torch.cuda.synchronize()
    if not all(torch.equal(o, torch.ones((3, 128), device="cuda"))
               for o in out):
        fail("odc_gather_layers after a refused launch is wrong")
    return {"cases": len(cases), "max_hops": hops, "cap": cap}


def _build_lib(name):
    from repro_torch.kernels import _build

    return _build.library(name)


# the late-partner case: qwen's 28 layers on 2 ranks, 2**22 float32 per
# layer's shard, and the compute stream sleeping this many cycles before
# it writes each layer of the scatter's input
FLAG_CASE = dict(n=2, L=28, c=2 ** 22)
FLAG_SLEEP_CYCLES = 2_000_000


def phase_layer_flags() -> dict:
    """The per-layer flags against a late partner.  Scatter: launched
    first on a side stream over an input (NaN until written) that the
    compute stream writes afterwards, layer by layer from the last, each
    after a sleep, each followed by its ready flag; the kernel must wait
    for every flag.
    Gather: launched on the side stream, the compute stream reads each
    layer after waiting for that layer's done counter, and records how
    many layers were still in flight when it read the first.  Both results
    bitwise equal to the plain rings."""
    from repro_torch.kernels import _ring
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import odc_scatter as S

    n, L, c = FLAG_CASE["n"], FLAG_CASE["L"], FLAG_CASE["c"]
    dev = torch.device("cuda", 0)
    _ring.probe_stream_memops(dev)
    g = torch.Generator(device="cuda").manual_seed(8)
    side = torch.cuda.Stream()
    vals = [torch.randn((L, n * c), generator=g, device="cuda")
            for _ in range(n)]
    ys = [torch.full_like(v, float("nan")) for v in vals]
    acc = [torch.zeros((L, c), device="cuda") for _ in range(n)]
    ready = _ring.LayerReady(L, dev)
    ready.arm()
    # every kernel the loop below launches runs once first: CUDA loads a
    # kernel's module at its first launch and may synchronise the context
    # to do so, which would wait for the scatter that waits for the loop
    torch.cuda._sleep(1)
    torch.empty_like(vals[0][0]).copy_(vals[0][0])
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        S.odc_scatter_accumulate_layers(ys, reverse=True, out=acc,
                                        ready=ready)
    t0 = time.perf_counter()
    for layer in reversed(range(L)):
        torch.cuda._sleep(FLAG_SLEEP_CYCLES)
        for y, v in zip(ys, vals):
            y[layer].copy_(v[layer])
        ready.set(layer)
    torch.cuda.synchronize()
    scatter_s = time.perf_counter() - t0
    ref = S.odc_scatter_accumulate_layers_plain(vals, reverse=True)
    scatter_ok = all(torch.equal(a, b) for a, b in zip(acc, ref))
    del vals, ys, acc, ref

    xs = [torch.randn((L, c), generator=g, device="cuda") for _ in range(n)]
    outs = [torch.empty((L, n * c), device="cuda") for _ in range(n)]
    done = _ring.LayerDone(L, dev)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        G.odc_gather_layers(xs, out=outs, done=done)
    reads, in_flight = [], None
    for layer in range(L):
        done.wait(layer)
        reads.append([o[layer].clone() for o in outs])
        if layer == 0:  # the counters as the compute stream saw them
            in_flight = done.words.clone()
    torch.cuda.synchronize()
    pending = int((in_flight.long() < done.target).sum())
    ref = G.odc_gather_layers_plain(xs)
    gather_ok = all(torch.equal(reads[l][r], ref[r][l]) for l in range(L)
                    for r in range(n))
    del xs, outs, reads, ref
    torch.cuda.empty_cache()
    log(f"chained flags, late partner (n={n}, L={L}, {c} float32 per layer "
        f"shard): scatter launched first, its input written layer by layer "
        f"after a {FLAG_SLEEP_CYCLES}-cycle sleep each ({scatter_s:.3f} s "
        f"in all): bitwise equal to the plain ring {scatter_ok}; gather "
        f"read layer by layer after each wait, {pending} of {L} layers "
        f"still in flight when layer 0 was read: bitwise equal {gather_ok}")
    if not (scatter_ok and gather_ok):
        fail("the chained rings' per-layer flags let a stream read or write "
             "out of turn")
    return {"scatter_s": scatter_s, "in_flight_at_first_read": pending}


# ---------------------------------------------------------------------------
# phase 3g: the int8 codec and the compressed (q8) rings against their plain
# versions
# ---------------------------------------------------------------------------
def _codec_case(g):
    """A ragged input of mixed scales with an all-zero chunk, a chunk of
    exact ties (absmax 127: scale 1, every x.5 a tie) and a chunk whose
    extremes land on +-127."""
    x = torch.randn(3 * 256 + 10_000 + 17, generator=g, device="cuda")
    x *= 10.0 ** torch.randint(-3, 4, x.shape, generator=g, device="cuda")
    x[:256] = 0.0
    x[256:512] = torch.arange(256, device="cuda") % 9 - 4 + 0.5
    x[256] = 127.0
    x[512:768] = torch.linspace(-3.0, 3.0, 256, device="cuda")
    return x


def phase_codec():
    """Rows 7 and 8, kernel against plain, bitwise: at qwen's w_up shard
    on 2 ranks and at a ragged size with zero chunks and ties."""
    from repro_torch.core import odc
    from repro_torch.kernels import quant as Q

    g = torch.Generator(device="cuda").manual_seed(7)
    for name, x in (("w_up shard", torch.randn(W_UP_SHARD, generator=g,
                                               device="cuda")),
                    ("ragged", _codec_case(g))):
        q, s = Q.quantize_int8(x)
        y = Q.dequantize_int8(q, s, x.shape)
        torch.cuda.synchronize()
        qr, sr = odc.quantize_chunked(x)
        yr = odc.dequantize_chunked(qr, sr, x.shape)
        ok = torch.equal(q, qr) and torch.equal(s, sr) and torch.equal(y, yr)
        bound = float((s / 2).max())
        err = float((y - x).abs().max())
        log(f"codec {name} {tuple(x.shape)}: codes, scales and decode "
            f"bitwise equal to the plain versions {ok}; codes in "
            f"[{int(q.min())}, {int(q.max())}], max |decode - x| {err:.3e} "
            f"(at most scale/2 = {bound:.3e})")
        if not ok:
            fail(f"codec {name}: the kernels disagree with the plain codec")
        if err > bound or int(q.min()) < -127:
            fail(f"codec {name}: a code is out of range or off by more "
                 f"than half a step")
        del x, q, s, y, qr, sr, yr
    torch.cuda.empty_cache()


def phase_q8_rings() -> dict:
    """Rows 9 and 10, kernel against plain, bitwise: n in Q8_RING_NS,
    natural and profile-ordered rings, ragged shards, and w_up's shard on
    2 ranks."""
    from repro_torch.core import odc
    from repro_torch.kernels import quant as Q

    g = torch.Generator(device="cuda").manual_seed(8)
    cases = [(n, order, shape) for n in Q8_RING_NS
             for order in _ring_orders(n) for shape in Q8_RING_SHAPES]
    cases.append((2, None, W_UP_SHARD))
    bad = []
    for n, order, shape in cases:
        xs = [torch.randn(shape, generator=g, device="cuda")
              for _ in range(n)]
        gather_ok = all(torch.equal(a, b) for a, b in zip(
            Q.odc_gather_q8(xs, order), odc.ring_gather_q8(xs, order)))
        del xs
        ys = [torch.randn((n * shape[0],) + tuple(shape[1:]), generator=g,
                          device="cuda") for _ in range(n)]
        scatter_ok = all(torch.equal(a, b) for a, b in zip(
            Q.odc_scatter_accumulate_q8(ys, order),
            odc.ring_scatter_accumulate_q8(ys, order)))
        del ys
        torch.cuda.synchronize()
        if not (gather_ok and scatter_ok):
            bad.append(f"n={n} order={order or 'natural'} shard {shape}: "
                       f"gather {gather_ok} scatter {scatter_ok}")
    torch.cuda.empty_cache()
    log(f"q8 ring kernels: {len(cases)} cases (n in {Q8_RING_NS}, natural "
        f"and profile-ordered, shards {Q8_RING_SHAPES} and w_up's "
        f"{W_UP_SHARD} on 2 ranks): gather and scatter bitwise equal to the "
        f"plain rings in {len(cases) - len(bad)}")
    if bad:
        fail("q8 ring kernels disagree with the plain rings:\n  "
             + "\n  ".join(bad))
    return {"cases": len(cases)}


def _nan_bits(n, shape, g):
    """n ranks' int32 leaves of ``shape`` as float32 views, half of them
    NaN and infinity bit patterns (quiet, signalling, negative, with
    payloads), the rest random: the cp path sends its segment ids so."""
    numel = math.prod(shape)
    pats = torch.tensor([0x7FC00001, 0x7F800001, -1, 0x7F800000,
                         -0x00400001, 0x7FBFFFFF], dtype=torch.int32,
                        device="cuda")
    out = []
    for _ in range(n):
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, (numel,), generator=g,
                          dtype=torch.int32, device="cuda")
        x[::2] = pats.repeat(numel // len(pats) + 1)[:x[::2].numel()]
        out.append(x.view(shape).view(torch.float32))
    return out


def phase_gathers() -> dict:
    """Rows 1 and 9, the read-once broadcast gathers: a call's peak growth
    equals its outputs' bytes (no staging, no flags), and the same bits as
    the plain ring on grids of 1, 7 and 2**20 blocks a rank, from sources
    that are views at storage offset 1 (off 16 bytes), and for NaN bit
    patterns (int32 leaves as float32 bits).  Then the q8 scatter, still a
    ring whose blocks wait on each other, refuses a grid that cannot be
    resident."""
    from repro_torch.core import odc
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import quant as Q

    g = torch.Generator(device="cuda").manual_seed(6)
    grids = (1, 7, 1 << 20)
    # row 1
    n, c = 4, 2 ** 22
    xs = [torch.randn(c, generator=g, device="cuda") for _ in range(n)]
    ref = G.odc_gather_plain(xs)
    G.odc_gather(xs)
    out, grew = _peak_growth(lambda: G.odc_gather(xs))
    outputs = sum(o.numel() * o.element_size() for o in out)
    same = all(torch.equal(a, b) for a, b in zip(out, ref))
    del out
    on_grid = []
    for grid in grids:
        out = G.odc_gather(xs, blocks_per_rank=grid)
        torch.cuda.synchronize()
        on_grid.append(all(torch.equal(a, b) for a, b in zip(out, ref)))
        del out
    del xs, ref
    offsets = []
    for dtype in (torch.float32, torch.bfloat16):
        views = [torch.randn(1001 * 3 + 1, generator=g, device="cuda")
                 .to(dtype)[1:].view(1001, 3) for _ in range(3)]
        ref = G.odc_gather_plain(views, [2, 0, 1])
        for grid in (1, 7, None):
            out = G.odc_gather(views, [2, 0, 1], blocks_per_rank=grid)
            torch.cuda.synchronize()
            offsets.append(all(torch.equal(a, b) for a, b in zip(out, ref)))
    bits = _nan_bits(2, (4096, 1, 2), g)
    want = torch.cat([b.view(torch.int32) for b in bits])
    out = G.odc_gather(bits)
    torch.cuda.synchronize()
    nan_ok = all(torch.equal(o.view(torch.int32), want) for o in out)
    del bits, want, out
    log(f"broadcast gather (row 1), n={n} c={c} float32: peak growth "
        f"{grew} bytes in a call, its outputs {outputs}; bitwise the plain "
        f"ring {same}, on grids of 1, 7 and 2**20 blocks a rank {on_grid}; "
        f"sources at storage offset 1 (float32, bfloat16 (1001, 3) on 3 "
        f"ranks, grids 1, 7 and the default) {offsets}; int32 NaN bit "
        f"patterns (4096, 1, 2) on 2 ranks {nan_ok}")
    if grew != outputs or not (same and all(on_grid) and all(offsets)
                               and nan_ok):
        fail("the broadcast gather allocates more than its outputs or is "
             "not bitwise the plain ring on every grid and source")
    # row 9
    nc = 2 ** 14
    enc = [Q.quantize_int8(torch.randn(nc * 256, generator=g,
                                       device="cuda")) for _ in range(n)]
    qs, ss = [q for q, _ in enc], [s for _, s in enc]
    del enc
    ref = (odc.ring_gather(qs), odc.ring_gather(ss))

    def equal(got, qref, sref):
        return all(torch.equal(a.view(-1, 256), b) for a, b in
                   zip(got[0], qref)) and all(
            torch.equal(a.view(-1, 1), b) for a, b in zip(got[1], sref))

    Q.gather_codes(qs, ss)
    out, q8_grew = _peak_growth(lambda: Q.gather_codes(qs, ss))
    q8_outputs = sum(o.numel() * o.element_size() for o in out[0] + out[1])
    q8_same = equal(out, *ref)
    del out
    q8_grid = []
    for grid in grids:
        q8_grid.append(equal(Q.gather_codes(qs, ss, blocks_per_rank=grid),
                             *ref))
        torch.cuda.synchronize()
    qv = [torch.cat([q.new_zeros(1), q.view(-1)])[1:].view(nc, 256)
          for q in qs]
    sv = [torch.cat([s.new_zeros(1), s.view(-1)])[1:].view(nc, 1)
          for s in ss]
    q8_off = [equal(Q.gather_codes(qv, sv, blocks_per_rank=grid), *ref)
              for grid in (1, 7, None)]
    torch.cuda.synchronize()
    del qs, ss, qv, sv, ref
    log(f"broadcast q8 gather (row 9), n={n} {nc} chunks: peak growth "
        f"{q8_grew} bytes in a call, its outputs {q8_outputs}; bitwise the "
        f"plain ring {q8_same}, on grids of 1, 7 and 2**20 blocks a rank "
        f"{q8_grid}; codes and scales at storage offset 1 {q8_off}")
    if q8_grew != q8_outputs or not (q8_same and all(q8_grid)
                                     and all(q8_off)):
        fail("the q8 gather allocates more than its outputs or is not "
             "bitwise the plain ring on every grid and source")
    # row 10 keeps its ring
    ys = [torch.randn(2048, generator=g, device="cuda") for _ in range(2)]
    before = Q.scatter_launches
    try:
        Q.odc_scatter_accumulate_q8(ys, blocks_per_rank=1 << 20)
    except RuntimeError as e:
        log(f"q8 scatter refusal: {e}")
    else:
        fail("odc_scatter_accumulate_q8 launched a grid that cannot be "
             "co-resident")
    out = Q.odc_scatter_accumulate_q8(ys)
    torch.cuda.synchronize()
    if Q.scatter_launches != before + 1 or not all(
            torch.equal(a, b) for a, b in
            zip(out, odc.ring_scatter_accumulate_q8(ys))):
        fail("odc_scatter_accumulate_q8 after a refused launch is wrong")
    torch.cuda.empty_cache()
    return {"peak_growth": grew, "q8_peak_growth": q8_grew}


# ---------------------------------------------------------------------------
# phase 3g: the Mamba2 SSD scan kernel (ssm family) against its plain
# version, and its gradient route
# ---------------------------------------------------------------------------
def _ssd_inputs(b, s, h, p, g, n, pad, dtype, seed):
    """Scan inputs as ``mamba2_apply`` makes them (dt a softplus, A < 0);
    the last ``pad`` positions a padded tail (x, B, C zero, dt 0)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    x = rnd(b, s, h, p) * 0.5
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    A = -torch.exp(rnd(h) * 0.3)
    Bm, Cm = rnd(b, s, g, n) * 0.5, rnd(b, s, g, n) * 0.5
    if pad:
        for t in (x, dt, Bm, Cm):
            t[:, s - pad:] = 0
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)


def _peak_requested(fn):
    """(result, peak bytes requested of the caching allocator above the
    start in one call of fn): the sizes the callers asked for, before the
    allocator rounds them up to its blocks."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_stats()["requested_bytes.all.peak"] - before


def _rel_err(out, ref):
    """(max |diff|, max |diff| / (1 + |ref|)) in f32."""
    d = (out.float() - ref.float()).abs()
    return float(d.max()), float((d / (1 + ref.float().abs())).max())


def _ssd_plan_of_c(b, s, h, p, g, n, Q) -> list:
    """``repro_ssd_scan_plan``'s launches and workspace bytes, flat."""
    import ctypes

    from repro_torch.kernels import _build

    out = (ctypes.c_longlong * 17)()
    err = _build.library("ssd_scan").repro_ssd_scan_plan(b, s, h, p, g, n,
                                                         Q, out)
    return list(out) if err == 0 else [f"refused: CUDA error {err}"]


def _ssd_plan_flat(plan) -> list:
    from repro_torch.kernels import ssd_scan as K

    return [v for k in K.KERNELS for v in (*plan[k]["grid"],
                                           plan[k]["threads"],
                                           plan[k]["smem_bytes"])] \
        + [plan["workspace_bytes"]]


def phase_ssd_kernel():
    from repro_torch.kernels import ssd_scan as K

    bad = []
    # the host's plan (grids, shared memory, workspace: the wrapper
    # allocates what it says) against the C side's
    for name, (b, s, h, p, g, n, Q, _) in SSD_CASES.items():
        plan = K.launch_plan(b, s, h, p, g, n, Q)
        if _ssd_plan_flat(plan) != _ssd_plan_of_c(b, s, h, p, g, n, Q):
            bad.append(f"{name} plan")
        log(f"ssd_scan plan {name}: " + ", ".join(
            f"{k} grid {plan[k]['grid']}" for k in K.KERNELS)
            + f"; workspace {plan['workspace_bytes']} bytes, C side "
            f"{'agrees' if f'{name} plan' not in bad else 'DIFFERS'}")
    # the largest chunk both sides take, and one more that both refuse
    edge = (1, K.MAX_Q, 2, 8, 1, 8, K.MAX_Q)
    past = (1, K.MAX_Q + 1, 2, 8, 1, 8, K.MAX_Q + 1)
    try:
        K.launch_plan(*past)
        host_refuses = False
    except ValueError:
        host_refuses = True
    c_refuses = _ssd_plan_of_c(*past)[0] == "refused: CUDA error 1"
    edge_ok = _ssd_plan_flat(K.launch_plan(*edge)) == _ssd_plan_of_c(*edge)
    log(f"ssd_scan largest chunk {K.MAX_Q}: plans agree {edge_ok}; one "
        f"more refused by the host {host_refuses}, by the C side "
        f"{c_refuses}")
    if not (edge_ok and host_refuses and c_refuses):
        bad.append("largest chunk")
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, (b, s, h, p, g, n, Q, pad)) in enumerate(
                SSD_CASES.items()):
            ins = _ssd_inputs(b, s, h, p, g, n, pad, dtype, seed=i)
            before = K.launches
            y, st = K.ssd_scan(*ins, Q)
            torch.cuda.synchronize()
            launched = K.launches - before
            ry, rst = K.ssd_scan_plain(*ins, Q)
            (ya, yr), (sa, sr) = _rel_err(y, ry), _rel_err(st, rst)
            finite = bool(torch.isfinite(y.float()).all()
                          and torch.isfinite(st).all())
            ok = (finite and launched == 1 and y.dtype == dtype
                  and max(yr, sr) <= SSD_TOL[dtype])
            tag = str(dtype).replace("torch.", "")
            log(f"ssd_scan vs plain [{tag:8s}] {name:13s} (b, s, h, p, g, n, "
                f"Q) = {(b, s, h, p, g, n, Q)}{f', tail {pad}' if pad else ''}"
                f": y max|diff| {ya:.3e} ({yr:.3e} of 1+|plain|), state "
                f"{sa:.3e} ({sr:.3e}) (tol {SSD_TOL[dtype]:g}), launches "
                f"{launched} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(f"{name} {tag}")
            del ins, y, st, ry, rst
    if bad:
        fail(f"ssd_scan disagrees with its plain version: {bad}")


def phase_ssd_grad():
    """The gradient route (kernel forward, ``ssd_chunked`` backward) at the
    train shape against autograd through the plain version, every input,
    |diff| <= SSD_GRAD_TOL * (1 + |plain|)."""
    from repro_torch.kernels import ssd_scan as K

    b, s, h, p, g, n, Q, _ = SSD_CASES["train"]
    ins = _ssd_inputs(b, s, h, p, g, n, 0, torch.float32, seed=7)
    gen = torch.Generator(device="cuda").manual_seed(8)
    gy = torch.randn(ins[0].shape, generator=gen, device="cuda")
    gs = torch.randn((b, h, p, n), generator=gen, device="cuda")
    grads = []
    for fn in (K.ssd_scan, K.ssd_scan_plain):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        y, st = fn(*leaves, Q)
        torch.autograd.backward([y, st], [gy, gs])
        grads.append([t.grad for t in leaves])
        del y, st, leaves
    errs = {name: _rel_err(a, r) for name, a, r in
            zip(("x", "dt", "A", "B", "C"), *grads)}
    finite = all(bool(torch.isfinite(a).all()) for a in grads[0])
    worst = max(r for _, r in errs.values())
    log(f"ssd_scan gradient route vs autograd through the plain version at "
        f"the train shape: " + ", ".join(
            f"d{k} max|diff| {a:.3e} ({r:.3e} of 1+|plain|)"
            for k, (a, r) in errs.items())
        + f" (tol {SSD_GRAD_TOL:g}), finite {finite}")
    if not finite or worst > SSD_GRAD_TOL:
        fail("ssd_scan: the gradient route disagrees with the plain route")
    del grads
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4m: serve mamba2-2.7b at full width and depth, then its wave
# prefill on the plain scan route
# ---------------------------------------------------------------------------
def phase_mamba_serve() -> dict:
    import gc

    from repro_torch.kernels import ssd_scan as K
    from repro_torch.launch import serve, train
    from repro_torch.models import ssm

    gc.collect()
    torch.cuda.empty_cache()
    args = serve.parse_args([
        "--arch", MAMBA, "--seed", str(SEED), "--device", "cuda", "--dtype",
        "float32", "--batch", str(WAVE["batch"]), "--prompt-len",
        str(WAVE["prompt_len"]), "--gen", str(WAVE["gen"])])
    torch.cuda.reset_peak_memory_stats()
    train.reset_launches()
    summary = serve.run(args)
    torch.cuda.synchronize()
    got = train.read_launches()
    peak = torch.cuda.max_memory_allocated()
    L = summary["num_layers"]
    want = L * summary["prefill_calls"]
    others = {k: v for k, v in got.items() if k != "ssd_scan" and v}
    log(f"serve {MAMBA} wave ({L} layers): prefill "
        f"{summary['prefill_tok_s']:.1f} tok/s, decode "
        f"{summary['decode_tok_s']:.1f} tok/s, ssd_scan launches "
        f"{got['ssd_scan']} (want {L} layers x {summary['prefill_calls']} "
        f"prefill = {want}; decode is the recurrent step), other launches "
        f"{others or 0}, peak memory {peak / 2 ** 30:.2f} GiB, first ids "
        f"{summary['first_ids'][:8]}")
    if L != 64 or got["ssd_scan"] != want or want == 0:
        fail(f"serve {MAMBA}: {got['ssd_scan']} scan launches over {L} "
             f"layers, want {want} over 64")
    if others:
        fail(f"serve {MAMBA}: launched {others}")
    if not summary["ids_in_vocab"]:
        fail(f"serve {MAMBA}: generated ids outside the vocabulary")

    # the wave prefill again, on the kernel route and on the plain route
    cfg, params, tokens = serve.build(args)
    engine = serve.make_engine(cfg, args)
    batch = engine.prompt_batch(tokens)
    B, S = tokens.shape
    kern, cache = engine.prefill(params, batch,
                                 engine.init_cache(B, S + args.gen))
    prev = ssm.set_ssd_impl(ssm.ssd_chunked)
    try:
        before = K.launches
        plain, pcache = engine.prefill(params, batch,
                                       engine.init_cache(B, S + args.gen))
        torch.cuda.synchronize()
        plain_launches = K.launches - before
    finally:
        ssm.set_ssd_impl(prev)
    diff = float((kern[:, -1] - plain[:, -1]).abs().max())
    state = _rel_err(cache["ssm"], pcache["ssm"])
    finite = bool(torch.isfinite(kern).all())
    log(f"{MAMBA} wave prefill last-position logits "
        f"{tuple(kern[:, -1].shape)}, kernel vs plain scan route max|diff| "
        f"{diff:.3e} (tol {LOGITS_TOL:g}), final states max|diff| "
        f"{state[0]:.3e} ({state[1]:.3e} of 1+|plain|), finite {finite}, "
        f"scan launches on the plain route {plain_launches}")
    if not finite or diff > LOGITS_TOL or plain_launches:
        fail(f"{MAMBA} prefill logits: kernel and plain scan disagree")
    del plain, pcache
    tok = kern[:, -1].argmax(-1)[:, None]
    _profile_decode(engine, params, cache, tok, S)
    del params, engine, cache, kern
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": got}


# ---------------------------------------------------------------------------
# phase 4n: train mamba2-2.7b at full width, depth cut, with two ranks
# ---------------------------------------------------------------------------
def _train_args(arch, comm, schedule, steps):
    """TRAIN's settings for ``arch`` through the train driver's parser."""
    from repro_torch.launch import train

    return train.parse_args([
        "--arch", arch, "--seed", str(SEED), "--device", "cuda",
        "--comm", comm, "--schedule", schedule, "--strategy", "lb_mini",
        "--dataset", "longalign", "--data-axis", str(TRAIN["data_axis"]),
        "--steps", str(steps), "--max-tokens", str(TRAIN["max_tokens"]),
        "--max-len", str(TRAIN["max_len"]),
        "--minibatch-per-device", str(TRAIN["minibatch_per_device"])])


def phase_mamba_train() -> dict:
    """collective x layer and ODC x minibatch through the train entry
    point, held to each other as qwen's runs are and to their launch
    counts; step 0 again on the plain scan route (``ssd_chunked``), its
    loss and gradient norm within CP_PLAIN_RTOL; one profiled step."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core import fsdp
    from repro_torch.launch import train
    from repro_torch.models import ssm

    cfg = dataclasses.replace(get_config(MAMBA), num_layers=MAMBA_LAYERS)
    log(f"train {MAMBA}: full width, {MAMBA_LAYERS} of 64 layers "
        f"({cfg.num_params() / 1e9:.3f} B parameters)")
    runs = {}
    for comm, schedule in TRAIN_CONFIGS[:2]:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        train.reset_launches()
        summary = train.run(_train_args(MAMBA, comm, schedule, TRAIN["steps"]),
                            cfg=cfg)
        torch.cuda.synchronize()
        got = train.read_launches()
        dims = summary["dims"]
        if any(fsdp.get(dims, p) is None for p in fsdp.tree_paths(dims)):
            fail(f"{MAMBA} on {TRAIN['data_axis']} ranks replicates a leaf")
        want = _expected_launches(cfg, comm, schedule, summary, dims)
        peak = torch.cuda.max_memory_allocated()
        tag = f"{MAMBA} {comm} x {schedule}"
        log(f"train {tag} ({cfg.num_layers} layers): losses "
            f"{summary['losses']}, step s "
            f"{[round(t, 3) for t in summary['step_s']]}, tokens "
            f"{[st['tokens'] for st in summary['steps']]}, microbatches "
            f"{[(st['microbatches'], st['counts']) for st in summary['steps']]}"
            f", {summary['tok_s']:.1f} tok/s, peak memory "
            f"{peak / 2 ** 30:.2f} GiB, grad norms "
            f"{[st['grad_norm'] for st in summary['steps']]}, launches {got} "
            f"(want {want})")
        if not all(math.isfinite(x) for x in summary["losses"]):
            fail(f"train {tag}: a loss is not finite")
        if got != want:
            fail(f"train {tag}: kernel launches {got}, want {want}")
        summary["peak_bytes"] = peak
        summary["launches"] = got
        runs[tag] = summary
    _hold_to_first(runs)
    odc_run = runs[f"{MAMBA} odc x minibatch"]
    gc.collect()
    torch.cuda.empty_cache()
    prev = ssm.set_ssd_impl(ssm.ssd_chunked)
    try:
        train.reset_launches()
        plain = train.run(_train_args(MAMBA, "odc", "minibatch", 1),
                          cfg=cfg)
        torch.cuda.synchronize()
    finally:
        ssm.set_ssd_impl(prev)
    l0, p0 = odc_run["losses"][0], plain["losses"][0]
    n0, pn0 = odc_run["steps"][0]["grad_norm"], plain["steps"][0]["grad_norm"]
    rel_l, rel_n = abs(l0 - p0) / abs(p0), abs(n0 - pn0) / abs(pn0)
    log(f"train {MAMBA} odc x minibatch step 0, kernel route against the "
        f"plain scan route (scan launches {plain['launches']['ssd_scan']}): "
        f"loss {l0!r} vs {p0!r} ({rel_l:.2e} relative), gradient norm "
        f"{n0!r} vs {pn0!r} ({rel_n:.2e}) (tol {CP_PLAIN_RTOL:g})")
    if plain["launches"]["ssd_scan"] or max(rel_l, rel_n) > CP_PLAIN_RTOL:
        fail(f"train {MAMBA}: step 0 differs from the plain scan route")
    gc.collect()
    torch.cuda.empty_cache()
    _profile_train_step("odc", "minibatch", cfg=cfg)
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": runs}


# ---------------------------------------------------------------------------
# phase 3h: gather_matmul, the kernel against its plain version
# ---------------------------------------------------------------------------
# bf16 shapes that TMA cannot take (rows off 16 bytes): the CUDA-core route
GM_UNALIGNED = {"c 24, f 70": (4, 100, 96, 70), "c 3, f 5": (3, 7, 9, 5)}


def _gm_plan_checked(n, m, k, f, dtype) -> dict:
    """``launch_plan`` of a call with aligned pointers, held to the plan
    the C side gives for the same route (grid, threads, shared memory,
    load path)."""
    import ctypes

    from repro_torch.kernels import _ring
    from repro_torch.kernels import gather_matmul as GM

    plan = GM.launch_plan(n, m, k, f, dtype)
    out = (ctypes.c_int * 6)()
    err = _build_lib("gather_matmul").repro_gather_matmul_plan(
        n, m, k, f, _ring.DTYPE_CODES[dtype], 0 if plan["route"] == "tc"
        else 1, 1, out)
    loads = {0: "tma", 1: "vector", 2: "scalar"}.get(out[5])
    c_plan = (tuple(out[:3]), out[3], out[4], loads)
    if err != 0 or c_plan != (plan["grid"], plan["threads"],
                              plan["smem_bytes"], plan["loads"]):
        fail(f"gather_matmul plan {plan} disagrees with the C side's "
             f"{c_plan} (error {err})")
    return plan


def _gm_plan_str(plan) -> str:
    return (f"{plan['route']} route, {plan['bm']} x {plan['bn']} tiles, "
            f"k step {plan['bk']}, {plan['stages']} stages, grid "
            f"{plan['grid']} x {plan['threads']} threads, "
            f"{plan['smem_bytes']} bytes of shared memory, {plan['loads']} "
            f"loads")


def _gm_unaligned_cases():
    """bf16 shapes off TMA's 16-byte rows, against the plain version: one
    launch each on the CUDA-core route."""
    from repro_torch.kernels import gather_matmul as GM

    for i, (name, (n, m, k, f)) in enumerate(GM_UNALIGNED.items()):
        xs, ws = _gm_inputs(n, m, k, f, torch.bfloat16, seed=20 + i)
        before = (GM.launches_tc, GM.launches_simt)
        outs = GM.gather_matmul(xs, ws)
        torch.cuda.synchronize()
        moved = (GM.launches_tc - before[0], GM.launches_simt - before[1])
        ref = GM.gather_matmul_plain(xs, ws)
        d = max(float((o.float() - r.float()).abs().max())
                for o, r in zip(outs, ref))
        scale = max(float(r.float().abs().max()) for r in ref)
        plan = _gm_plan_checked(n, m, k, f, torch.bfloat16)
        log(f"gather_matmul vs plain [bfloat16] unaligned {name}: {n} ranks, "
            f"x {(m, k)}, shard {(k // n, f)}: max|diff| {d:.3e} (tol "
            f"{GM_TOL[torch.bfloat16]:g} of {scale:.3e}); launches by route "
            f"{moved}; {_gm_plan_str(plan)}")
        if moved != (0, 1) or plan["route"] != "simt" or \
                d > GM_TOL[torch.bfloat16] * scale:
            fail(f"gather_matmul unaligned {name}: launches by route {moved} "
                 f"(want (0, 1)), max|diff| {d}")
def _gm_inputs(n, m, k, f, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = [torch.randn((m, k), generator=g, device="cuda").to(dtype)
          for _ in range(n)]
    ws = [torch.randn((k // n, f), generator=g, device="cuda").to(dtype)
          for _ in range(n)]
    return xs, ws


def phase_gather_matmul() -> dict:
    """The op's path is the op itself (no engine calls it): each case of
    GM_CASES in float32 and bfloat16 through ``gather_matmul``, one launch
    for every rank, with the counts set to 0 just before and read just
    after; then each output against the plain version's, per rank; then
    the refusal of ranks on two devices."""
    from repro_torch.kernels import gather_matmul as GM
    from repro_torch.launch import train

    runs = []
    train.reset_launches()
    by_route = (GM.launches_tc, GM.launches_simt)
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, (n, m, k, f)) in enumerate(GM_CASES.items()):
            xs, ws = _gm_inputs(n, m, k, f, dtype, seed=i)
            runs.append((name, dtype, xs, ws, GM.gather_matmul(xs, ws)))
    torch.cuda.synchronize()
    got = train.read_launches()
    by_route = (GM.launches_tc - by_route[0], GM.launches_simt - by_route[1])
    errs, bad = {}, []
    for name, dtype, xs, ws, outs in runs:
        n, m, k, f = GM_CASES[name]
        ref = GM.gather_matmul_plain(xs, ws)
        worst_abs = worst_rel = 0.0
        ok = True
        for o, r in zip(outs, ref):
            d = float((o.float() - r.float()).abs().max())
            scale = float(r.float().abs().max())
            worst_abs, worst_rel = max(worst_abs, d), max(worst_rel,
                                                           d / scale)
            ok &= (o.dtype == dtype and tuple(o.shape) == (m, f)
                   and bool(torch.isfinite(o.float()).all())
                   and d <= GM_TOL[dtype] * scale)
        errs[(name, dtype)] = worst_abs
        tag = str(dtype).replace("torch.", "")
        plan = _gm_plan_checked(n, m, k, f, dtype)
        want_route = "tc" if dtype == torch.bfloat16 else "simt"
        ok &= plan["route"] == want_route
        log(f"gather_matmul vs plain [{tag:8s}] {name:15s} {n} ranks, x "
            f"{(m, k)}, shard {(k // n, f)}: max|diff| {worst_abs:.3e} "
            f"({worst_rel:.3e} of max|plain|, tol {GM_TOL[dtype]:g}) "
            f"{'ok' if ok else 'MISMATCH'}; {_gm_plan_str(plan)}")
        if not ok:
            bad.append(f"{name} {tag}")
        del ref
    want = 2 * len(GM_CASES)
    others = {k: v for k, v in got.items() if k != "gather_matmul" and v}
    log(f"gather_matmul launches {got['gather_matmul']} (want {want}: one "
        f"per call for every rank), by route: tensor cores {by_route[0]}, "
        f"CUDA cores {by_route[1]} (want {len(GM_CASES)} each: every bf16 "
        f"case on the tensor cores, every f32 one on the CUDA cores), other "
        f"launches {others or 0}")
    if got["gather_matmul"] != want or others or by_route != (
            len(GM_CASES), len(GM_CASES)):
        fail(f"gather_matmul: launches {got}, by route {by_route}, want "
             f"{want} of it alone, {len(GM_CASES)} on each route")
    if bad:
        fail(f"gather_matmul disagrees with its plain version: {bad}")
    del runs
    _gm_unaligned_cases()
    # ranks on two devices: refused before any launch
    xs, ws = _gm_inputs(2, 64, 64, 64, torch.float32, seed=9)
    before = GM.launches
    try:
        GM.gather_matmul([xs[0], xs[1].cpu()], ws)
    except NotImplementedError as e:
        log(f"gather_matmul refuses ranks on cuda:0 and cpu: {e}")
    else:
        fail("gather_matmul took ranks on two devices")
    if GM.launches != before:
        fail("gather_matmul launched for ranks on two devices")
    torch.cuda.empty_cache()
    return {"launches": got, "errs": errs}


# ---------------------------------------------------------------------------
# phase 4z: serve zamba2-1.2b at full width and depth, then its wave
# prefill on the plain scan and attention routes
# ---------------------------------------------------------------------------
def phase_zamba_serve() -> dict:
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve, train
    from repro_torch.models import layers, ssm
    from repro_torch.models import transformer as T

    gc.collect()
    torch.cuda.empty_cache()
    args = serve.parse_args([
        "--arch", ZAMBA, "--seed", str(SEED), "--device", "cuda", "--dtype",
        "float32", "--batch", str(WAVE["batch"]), "--prompt-len",
        str(WAVE["prompt_len"]), "--gen", str(WAVE["gen"])])
    torch.cuda.reset_peak_memory_stats()
    train.reset_launches()
    summary = serve.run(args)
    torch.cuda.synchronize()
    got = train.read_launches()
    peak = torch.cuda.max_memory_allocated()
    L = summary["num_layers"]
    _, n_super, tail = T.hybrid_split(get_config(ZAMBA))
    calls = summary["prefill_calls"]
    want_scan = L * calls
    want_attn = n_super * (calls + summary["decode_steps"])
    others = {k: v for k, v in got.items()
              if k not in ("ssd_scan", "flash_attention") and v}
    log(f"serve {ZAMBA} wave ({L} layers: {n_super} super-layers and a "
        f"tail of {tail}): prefill {summary['prefill_tok_s']:.1f} tok/s, "
        f"decode {summary['decode_tok_s']:.1f} tok/s, ssd_scan launches "
        f"{got['ssd_scan']} (want {L} x {calls} prefill = {want_scan}), "
        f"flash_attention launches {got['flash_attention']} (want "
        f"{n_super} x ({calls} prefill + {summary['decode_steps']} decode) "
        f"= {want_attn}), other launches {others or 0}, peak memory "
        f"{peak / 2 ** 30:.2f} GiB, first ids {summary['first_ids'][:8]}")
    if L != 38 or got["ssd_scan"] != want_scan or want_scan == 0 \
            or got["flash_attention"] != want_attn:
        fail(f"serve {ZAMBA}: launches {got} over {L} layers, want "
             f"{want_scan} scans and {want_attn} attention calls over 38")
    if others:
        fail(f"serve {ZAMBA}: launched {others}")
    if not summary["ids_in_vocab"]:
        fail(f"serve {ZAMBA}: generated ids outside the vocabulary")

    # the wave prefill again, on the kernel route and on the plain route
    cfg, params, tokens = serve.build(args)
    engine = serve.make_engine(cfg, args)
    batch = engine.prompt_batch(tokens)
    B, S = tokens.shape
    train.reset_launches()
    kern, cache = engine.prefill(params, batch,
                                 engine.init_cache(B, S + args.gen))
    torch.cuda.synchronize()
    per_prefill = train.read_launches()
    prev_ssd = ssm.set_ssd_impl(ssm.ssd_chunked)
    prev_attn = layers.set_attention_impl(fa.flash_attention_plain)
    try:
        train.reset_launches()
        plain, pcache = engine.prefill(params, batch,
                                       engine.init_cache(B, S + args.gen))
        torch.cuda.synchronize()
        plain_launches = train.read_launches()
    finally:
        ssm.set_ssd_impl(prev_ssd)
        layers.set_attention_impl(prev_attn)
    diff = float((kern[:, -1] - plain[:, -1]).abs().max())
    state = _rel_err(cache["mamba"]["ssm"], pcache["mamba"]["ssm"])
    finite = bool(torch.isfinite(kern).all())
    log(f"{ZAMBA} wave prefill: launches {per_prefill['ssd_scan']} scans, "
        f"{per_prefill['flash_attention']} attention calls (want {L}, "
        f"{n_super}); last-position logits {tuple(kern[:, -1].shape)}, "
        f"kernel vs plain scan and attention routes max|diff| {diff:.3e} "
        f"(tol {LOGITS_TOL:g}), final states max|diff| {state[0]:.3e} "
        f"({state[1]:.3e} of 1+|plain|), finite {finite}, launches on the "
        f"plain route {sum(plain_launches.values())}")
    if per_prefill["ssd_scan"] != L \
            or per_prefill["flash_attention"] != n_super:
        fail(f"{ZAMBA} prefill: launches {per_prefill}")
    if not finite or diff > LOGITS_TOL or any(plain_launches.values()):
        fail(f"{ZAMBA} prefill logits: kernel and plain routes disagree")
    del plain, pcache
    tok = kern[:, -1].argmax(-1)[:, None]
    _profile_decode(engine, params, cache, tok, S)
    del params, engine, cache, kern
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": got, "summary": summary, "peak": peak}


# ---------------------------------------------------------------------------
# phase 4y: train zamba2-1.2b at full width and depth with two ranks
# ---------------------------------------------------------------------------
def phase_zamba_train() -> dict:
    """collective x layer, ODC x minibatch and odc-overlap through the train
    entry point, held to each other as qwen's runs are and to their launch
    counts; step 0 again on the plain scan and attention routes, its loss
    and gradient norm within CP_PLAIN_RTOL; one profiled step of ODC x
    minibatch and one of odc-overlap."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core import fsdp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.models import layers, ssm

    cfg = get_config(ZAMBA)
    log(f"train {ZAMBA}: full width and depth, {cfg.num_layers} layers "
        f"({cfg.num_params() / 1e9:.3f} B parameters)")
    runs = {}
    for comm, schedule in TRAIN_CONFIGS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        train.reset_launches()
        summary = train.run(_train_args(ZAMBA, comm, schedule,
                                        TRAIN["steps"]))
        torch.cuda.synchronize()
        got = train.read_launches()
        dims = summary["dims"]
        if any(fsdp.get(dims, p) is None for p in fsdp.tree_paths(dims)):
            fail(f"{ZAMBA} on {TRAIN['data_axis']} ranks replicates a leaf")
        want = _expected_launches(cfg, comm, schedule, summary, dims)
        peak = torch.cuda.max_memory_allocated()
        tag = f"{ZAMBA} {comm} x {summary['schedule']}"
        log(f"train {tag} ({cfg.num_layers} layers): losses "
            f"{summary['losses']}, step s "
            f"{[round(t, 3) for t in summary['step_s']]}, tokens "
            f"{[st['tokens'] for st in summary['steps']]}, microbatches "
            f"{[(st['microbatches'], st['counts']) for st in summary['steps']]}"
            f", {summary['tok_s']:.1f} tok/s, peak memory "
            f"{peak / 2 ** 30:.2f} GiB, grad norms "
            f"{[st['grad_norm'] for st in summary['steps']]}, launches {got} "
            f"(want {want})")
        if not all(math.isfinite(x) for x in summary["losses"]):
            fail(f"train {tag}: a loss is not finite")
        if got != want:
            fail(f"train {tag}: kernel launches {got}, want {want}")
        summary["peak_bytes"] = peak
        summary["launches"] = got
        runs[tag] = summary
    _hold_to_first(runs)
    odc_run = runs[f"{ZAMBA} odc x minibatch"]
    gc.collect()
    torch.cuda.empty_cache()
    prev_ssd = ssm.set_ssd_impl(ssm.ssd_chunked)
    prev_attn = layers.set_attention_impl(fa.flash_attention_plain)
    try:
        train.reset_launches()
        plain = train.run(_train_args(ZAMBA, "odc", "minibatch", 1))
        torch.cuda.synchronize()
    finally:
        ssm.set_ssd_impl(prev_ssd)
        layers.set_attention_impl(prev_attn)
    l0, p0 = odc_run["losses"][0], plain["losses"][0]
    n0, pn0 = odc_run["steps"][0]["grad_norm"], plain["steps"][0]["grad_norm"]
    rel_l, rel_n = abs(l0 - p0) / abs(p0), abs(n0 - pn0) / abs(pn0)
    model_launches = {name: plain["launches"][name]
                      for name in ("ssd_scan", "flash_attention")}
    log(f"train {ZAMBA} odc x minibatch step 0, kernel route against the "
        f"plain scan and attention routes (launches there "
        f"{model_launches}): loss {l0!r} vs {p0!r} ({rel_l:.2e} relative), "
        f"gradient norm {n0!r} vs {pn0!r} ({rel_n:.2e}) "
        f"(tol {CP_PLAIN_RTOL:g})")
    if any(model_launches.values()) or max(rel_l, rel_n) > CP_PLAIN_RTOL:
        fail(f"train {ZAMBA}: step 0 differs from the plain scan and "
             f"attention routes")
    profiles = {}
    for comm, schedule in (("odc", "minibatch"), ("odc-overlap", "overlap")):
        gc.collect()
        torch.cuda.empty_cache()
        profiles[f"{comm} x {schedule}"] = _profile_train_step(
            comm, schedule, cfg=cfg)
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": runs, "profiles": profiles}


# ---------------------------------------------------------------------------
# phase 4m: the moe and vlm families: grok-1-314b served at full width,
# reduced grok-1 and llama4-maverick trained, chameleon-34b at full width
# ---------------------------------------------------------------------------
class _Routing:
    """Records every ``moe._router`` call's (top_i, probs) while active,
    so that two forwards over the same tokens can be held to
    ``moe.routing_rule`` (``_hold_routing``); with ``inputs``, also each
    call's (tokens, router weights) in ``inputs``, for a router of
    another package to route them again (the tests)."""

    def __init__(self, inputs: bool = False):
        self.calls, self.inputs, self._keep = [], [], inputs

    def __enter__(self):
        from repro_torch.models import moe

        self._router = moe._router

        def capture(cfg, p, toks):
            out = self._router(cfg, p, toks)
            self.calls.append((out[1].detach(), out[3].detach()))
            if self._keep:
                self.inputs.append((toks.detach().clone(),
                                    p["router"].detach().clone()))
            return out

        moe._router = capture
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._router = self._router


def _hold_routing(tag, ref, got, B):
    """The routing rule over two runs' recorded calls (pairs of (top_i,
    probs) per moe block, groups one batch row each): fails on a fault,
    prints the near-ties; returns the rows free of them."""
    from repro_torch.models import moe

    if len(ref) != len(got) or not ref:
        fail(f"{tag}: {len(ref)} and {len(got)} router calls")
    ok = torch.ones(B, dtype=torch.bool)
    faults = near = tokens = 0
    for (ta, pa), (tb, _) in zip(ref, got):
        f, n, tied = moe.routing_rule(ta, tb, pa)
        faults, near = faults + f, near + n
        tokens += ta.shape[0] * ta.shape[1]
        ok &= ~tied.cpu().reshape(B, -1).any(-1)
    log(f"{tag}: routing of {tokens} tokens in {len(ref)} router "
        f"calls: {faults} disagreements beyond {moe.ROUTING_MARGIN:g} "
        f"(faults), {near} near-ties; {int(ok.sum())} of {B} rows compared")
    if faults:
        fail(f"{tag}: {faults} routing disagreements beyond the margin")
    return ok


def _num_params(cfg) -> int:
    """The parameters ``init_params`` draws (``ModelConfig.num_params``
    counts three matrices an expert, grok-1's gelu experts have two)."""
    from repro_torch.core import fsdp
    from repro_torch.models import transformer as T

    shapes = T.param_shapes(cfg)
    return sum(fsdp.get(shapes, p).numel() for p in fsdp.tree_paths(shapes))


def _cut(arch, layers):
    """``arch``'s published config with ``layers`` of its layers."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), num_layers=layers)


def phase_grok_serve() -> dict:
    """grok-1-314b at its published widths, GROK_SERVE_LAYERS of its 64
    layers, through the serve entry point (wave); then the prefill on the
    kernel and on the plain attention route, and prefill of S-1 tokens
    plus one decode step (router tallies) against the full forward's last
    logits, each under the routing rule; a decode-step profile."""
    import gc

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve, train
    from repro_torch.models import layers
    from repro_torch.models import transformer as T

    gc.collect()
    torch.cuda.empty_cache()
    cfg = _cut(GROK, GROK_SERVE_LAYERS)
    n = _num_params(cfg)
    log(f"serve {GROK}: full width, {cfg.num_layers} of 64 layers "
        f"({n / 1e9:.2f} B parameters, {n * 4 / 1e9:.1f} GB in f32), "
        f"{cfg.num_experts} experts top-{cfg.experts_per_token}")
    args = serve.parse_args([
        "--arch", GROK, "--seed", str(SEED), "--device", "cuda", "--dtype",
        "float32", "--batch", str(WAVE["batch"]), "--prompt-len",
        str(WAVE["prompt_len"]), "--gen", str(WAVE["gen"])])
    torch.cuda.reset_peak_memory_stats()
    train.reset_launches()
    summary = serve.run(args, cfg=cfg)
    torch.cuda.synchronize()
    got = train.read_launches()
    peak = torch.cuda.max_memory_allocated()
    L = summary["num_layers"]
    want = L * (summary["prefill_calls"] + summary["decode_steps"])
    others = {k: v for k, v in got.items() if k != "flash_attention" and v}
    log(f"serve {GROK} wave ({L} layers): prefill "
        f"{summary['prefill_tok_s']:.1f} tok/s, decode "
        f"{summary['decode_tok_s']:.1f} tok/s, flash_attention launches "
        f"{got['flash_attention']} (want {L} x ({summary['prefill_calls']} "
        f"prefill + {summary['decode_steps']} decode) = {want}), other "
        f"launches {others or 0}, peak memory {peak / 2 ** 30:.2f} GiB, "
        f"first ids {summary['first_ids'][:8]}")
    if got["flash_attention"] != want or want == 0 or others:
        fail(f"serve {GROK}: launches {got}, want {want} attention calls")
    if not summary["ids_in_vocab"]:
        fail(f"serve {GROK}: generated ids outside the vocabulary")

    cfg, params, tokens = serve.build(args, cfg)
    engine = serve.make_engine(cfg, args)
    batch = engine.prompt_batch(tokens)
    B, S = tokens.shape
    train.reset_launches()
    with _Routing() as kr:
        kern, cache = engine.prefill(params, batch,
                                     engine.init_cache(B, S + args.gen))
    torch.cuda.synchronize()
    per_prefill = train.read_launches()
    prev = layers.set_attention_impl(fa.flash_attention_plain)
    try:
        train.reset_launches()
        with _Routing() as pr:
            plain, _ = engine.prefill(params, batch,
                                      engine.init_cache(B, S + args.gen))
        torch.cuda.synchronize()
        plain_launches = train.read_launches()
    finally:
        layers.set_attention_impl(prev)
    ok = _hold_routing(f"{GROK} prefill, kernel vs plain attention route",
                       pr.calls, kr.calls, B)
    diff = float((kern[ok, -1] - plain[ok, -1]).abs().max()) \
        if ok.any() else 0.0
    finite = bool(torch.isfinite(kern).all())
    log(f"{GROK} wave prefill: {per_prefill['flash_attention']} attention "
        f"calls (want {L}); last-position logits {tuple(kern[:, -1].shape)},"
        f" kernel vs plain attention max|diff| {diff:.3e} over "
        f"{int(ok.sum())} rows (tol {LOGITS_TOL:g}), finite {finite}, "
        f"launches on the plain route {sum(plain_launches.values())}")
    if per_prefill["flash_attention"] != L or not finite \
            or diff > LOGITS_TOL or any(plain_launches.values()) \
            or not ok.any():
        fail(f"{GROK} prefill: kernel and plain attention routes disagree")
    del plain

    # prefill of S-1 tokens and one decode step (the router tallies)
    # against the full forward's last logits
    with torch.no_grad(), _Routing() as fr:
        full, _, _ = T.apply(cfg, params, batch, last_only=True)
    inc = engine.init_cache(B, S)
    head = {k: v[:, :S - 1] for k, v in batch.items()}
    with _Routing() as ir:
        _, inc = engine.prefill(params, head, inc)
        dec, inc = engine.decode(params, inc, tokens[:, S - 1:], S - 1)
    torch.cuda.synchronize()
    n_blocks = len(fr.calls)
    joined = [(torch.cat([a[0], b[0]], 1), torch.cat([a[1], b[1]], 1))
              for a, b in zip(ir.calls[:n_blocks], ir.calls[n_blocks:])]
    ok2 = _hold_routing(f"{GROK} prefill {S - 1} + 1 decode vs the full "
                        f"forward", fr.calls, joined, B)
    tally = int(inc["moe"]["router_counts"].sum())
    want_tally = n_blocks * B * S * cfg.experts_per_token
    diff2 = float((dec[ok2, -1] - full[ok2, -1]).abs().max()) \
        if ok2.any() else 0.0
    log(f"{GROK} prefill {S - 1} + 1 decode step vs the full forward's last "
        f"logits: max|diff| {diff2:.3e} over {int(ok2.sum())} rows (tol "
        f"{LOGITS_TOL:g}); router tallies sum {tally} (want {want_tally})")
    if diff2 > LOGITS_TOL or tally != want_tally or not ok2.any() \
            or not bool(torch.isfinite(dec).all()):
        fail(f"{GROK}: prefill plus decode differs from the full forward")
    del full, dec, inc
    tok = kern[:, -1].argmax(-1)[:, None]
    profile = _profile_decode(engine, params, cache, tok, S)
    del params, engine, cache, kern
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": got, "summary": summary, "peak": peak,
            "logits_diff": diff, "decode_diff": diff2, "profile": profile}


def _moe_train_args(arch, comm, schedule, steps):
    """TRAIN's settings for the reduced ``arch``."""
    from repro_torch.launch import train

    return train.parse_args([
        "--arch", arch, "--reduced", "--seed", str(SEED), "--device",
        "cuda", "--comm", comm, "--schedule", schedule, "--strategy",
        "lb_mini", "--dataset", "longalign", "--data-axis",
        str(TRAIN["data_axis"]), "--steps", str(steps), "--max-tokens",
        str(TRAIN["max_tokens"]), "--max-len", str(TRAIN["max_len"]),
        "--minibatch-per-device", str(TRAIN["minibatch_per_device"])])


def _train_run(tag, cfg, args, **kw):
    """One train run through the entry point, its launches held to
    ``_expected_launches``; returns its summary (peak and launches in)."""
    import gc

    from repro_torch.launch import train

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train.reset_launches()
    summary = train.run(args, cfg=cfg, **kw)
    torch.cuda.synchronize()
    got = train.read_launches()
    want = _expected_launches(cfg, args.comm, summary["schedule"], summary,
                              summary["dims"])
    peak = torch.cuda.max_memory_allocated()
    log(f"train {tag}: losses {summary['losses']}, step s "
        f"{[round(t, 3) for t in summary['step_s']]}, tokens "
        f"{[st['tokens'] for st in summary['steps']]}, microbatches "
        f"{[(st['microbatches'], st['counts']) for st in summary['steps']]}"
        f", {summary['tok_s']:.1f} tok/s, peak memory {peak / 2 ** 30:.2f} "
        f"GiB, grad norms {[st['grad_norm'] for st in summary['steps']]}, "
        f"launches {got} (want {want})")
    if not all(math.isfinite(x) for x in summary["losses"]):
        fail(f"train {tag}: a loss is not finite")
    if got != want:
        fail(f"train {tag}: kernel launches {got}, want {want}")
    ring = {"odc": ("odc_gather", "odc_scatter_accumulate"),
            "odc-overlap": ("odc_gather_layers",
                            "odc_scatter_accumulate_layers")}
    for name in ("flash_attention",) + ring.get(args.comm, ()):
        if not got[name]:
            fail(f"train {tag}: {name} never launched")
    summary["peak_bytes"] = peak
    summary["launches"] = got
    return summary


def phase_moe_train() -> dict:
    """Reduced grok-1 (P = 1, top-2, gelu) and reduced llama4-maverick (P =
    2, top-1, swiglu, a shared expert, 8 vision-stub positions), 2 ranks,
    TRAIN's batches, as collective x layer, ODC x minibatch and
    odc-overlap, held to each other as qwen's runs are; ODC x minibatch
    again with weight-stationary experts (moe_ep='data'), held to the
    gathering run as the configs are and its parameters within
    EP_PARAM_TOL_PER_LR of the lr; one profiled step.  Reduced: at full
    width one grok-1 layer with AdamW state and ODC's gathered copies
    needs about 130 GB (PERF.md, section 4)."""
    from repro_torch.configs import get_reduced
    from repro_torch.core import fsdp

    runs = {}
    for arch in (GROK, LLAMA4):
        cfg = get_reduced(arch)
        log(f"train {arch} reduced (d_model {cfg.d_model}, {cfg.num_layers}"
            f" layers at period {cfg.moe_period}, {cfg.num_experts} experts "
            f"top-{cfg.experts_per_token}, {cfg.activation}, shared expert "
            f"{cfg.moe_shared_expert}, vision-stub positions "
            f"{cfg.frontend_tokens}): full-width moe training does not fit "
            f"one card")
        mine = {}
        for comm, schedule in TRAIN_CONFIGS:
            tag = f"{arch} reduced {comm} x {schedule}"
            mine[tag] = _train_run(tag, cfg, _moe_train_args(
                arch, comm, schedule, TRAIN["steps"]), return_params=True)
        _hold_to_first(mine)
        btag = f"{arch} reduced odc x minibatch"
        base = mine[btag]
        tag = f"{btag} moe_ep=data"
        args = _moe_train_args(arch, "odc", "minibatch", TRAIN["steps"])
        ep = _train_run(tag, cfg, args, return_params=True, moe_ep="data")
        if not ep["ep"]:
            fail(f"train {tag}: the experts are not stationary")
        _hold_to_first({btag: base, tag: ep})
        dl = max(abs(a - b) for a, b in zip(ep["losses"], base["losses"]))
        dp = max(float((fsdp.get(ep["params"], p).float()
                        - fsdp.get(base["params"], p).float()).abs().max())
                 for p in fsdp.tree_paths(base["params"]))
        tol = EP_PARAM_TOL_PER_LR * args.lr
        log(f"train {tag} against the gathering run: losses differ by at "
            f"most {dl:.3e} (bound 1e-5), parameters after "
            f"{TRAIN['steps']} steps at lr {args.lr:g} by {dp:.3e} (bound "
            f"{tol:g})")
        if dl >= 1e-5 or dp >= tol:
            fail(f"train {tag}: outside tests/test_moe_ep.py's bounds, "
                 f"scaled to the lr")
        mine[tag] = ep
        for run in mine.values():
            run.pop("params", None)
        runs.update(mine)
    profile = _profile_train_step("odc", "minibatch", cfg=get_reduced(GROK))
    return {"runs": runs, "profile": profile}


def phase_chameleon() -> dict:
    """chameleon-34b at its published widths: trained at
    CHAMELEON_TRAIN_LAYERS of 48 layers with 2 ranks (collective x layer,
    ODC x minibatch, held to each other), served at CHAMELEON_SERVE_LAYERS
    (wave), its prefill on the kernel and the plain attention route."""
    import gc

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve, train
    from repro_torch.models import layers

    cfg = _cut(CHAMELEON, CHAMELEON_TRAIN_LAYERS)
    log(f"train {CHAMELEON}: full width, {cfg.num_layers} of 48 layers "
        f"({_num_params(cfg) / 1e9:.3f} B parameters)")
    runs = {}
    for comm, schedule in TRAIN_CONFIGS[:2]:
        tag = f"{CHAMELEON} {comm} x {schedule}"
        runs[tag] = _train_run(tag, cfg, _train_args(
            CHAMELEON, comm, schedule, TRAIN["steps"]))
    _hold_to_first(runs)

    gc.collect()
    torch.cuda.empty_cache()
    cfg = _cut(CHAMELEON, CHAMELEON_SERVE_LAYERS)
    args = serve.parse_args([
        "--arch", CHAMELEON, "--seed", str(SEED), "--device", "cuda",
        "--dtype", "float32", "--batch", str(WAVE["batch"]), "--prompt-len",
        str(WAVE["prompt_len"]), "--gen", str(WAVE["gen"])])
    torch.cuda.reset_peak_memory_stats()
    train.reset_launches()
    summary = serve.run(args, cfg=cfg)
    torch.cuda.synchronize()
    got = train.read_launches()
    peak = torch.cuda.max_memory_allocated()
    L = summary["num_layers"]
    want = L * (summary["prefill_calls"] + summary["decode_steps"])
    log(f"serve {CHAMELEON} wave ({L} of 48 layers, "
        f"{_num_params(cfg) * 4 / 1e9:.1f} GB in f32): prefill "
        f"{summary['prefill_tok_s']:.1f} tok/s, decode "
        f"{summary['decode_tok_s']:.1f} tok/s, flash_attention launches "
        f"{got['flash_attention']} (want {want}), peak memory "
        f"{peak / 2 ** 30:.2f} GiB, first ids {summary['first_ids'][:8]}")
    others = {k: v for k, v in got.items() if k != "flash_attention" and v}
    if got["flash_attention"] != want or want == 0 or others \
            or not summary["ids_in_vocab"]:
        fail(f"serve {CHAMELEON}: launches {got}, want {want}")
    cfg, params, tokens = serve.build(args, cfg)
    engine = serve.make_engine(cfg, args)
    batch = engine.prompt_batch(tokens)
    B, S = tokens.shape
    kern, _ = engine.prefill(params, batch, engine.init_cache(B, S))
    prev = layers.set_attention_impl(fa.flash_attention_plain)
    try:
        plain, _ = engine.prefill(params, batch, engine.init_cache(B, S))
    finally:
        layers.set_attention_impl(prev)
    diff = float((kern[:, -1] - plain[:, -1]).abs().max())
    log(f"{CHAMELEON} wave prefill: kernel vs plain attention last-position"
        f" logits max|diff| {diff:.3e} (tol {LOGITS_TOL:g})")
    if diff > LOGITS_TOL or not bool(torch.isfinite(kern).all()):
        fail(f"{CHAMELEON} prefill: kernel and plain attention disagree")
    del params, engine, kern, plain
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": runs, "launches": got, "summary": summary, "peak": peak}


# ---------------------------------------------------------------------------
# phase 4s: the audio family: seamless-m4t-medium served and trained at
# full width and depth
# ---------------------------------------------------------------------------
def phase_seamless_serve() -> dict:
    """seamless-m4t-medium through the serve entry point (wave, 512
    frames a request); then the prefill on the kernel and on the plain
    attention route, and prefill of S-1 tokens plus one decode step from
    the cached encoder output against the full forward's last logits; a
    decode-step profile."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve, train
    from repro_torch.models import layers
    from repro_torch.models import transformer as T

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(SEAMLESS)
    n = _num_params(cfg)
    Le, Ld = cfg.num_encoder_layers, cfg.num_layers
    log(f"serve {SEAMLESS}: full width and depth, {Le} encoder and {Ld} "
        f"decoder layers ({n:,} parameters, {n * 4 / 1e9:.2f} GB in f32; "
        f"ModelConfig.num_params() says {cfg.num_params():,})")
    args = serve.parse_args([
        "--arch", SEAMLESS, "--seed", str(SEED), "--device", "cuda",
        "--dtype", "float32", "--batch", str(WAVE["batch"]), "--prompt-len",
        str(WAVE["prompt_len"]), "--gen", str(WAVE["gen"])])
    torch.cuda.reset_peak_memory_stats()
    train.reset_launches()
    summary = serve.run(args)
    torch.cuda.synchronize()
    got = train.read_launches()
    peak = torch.cuda.max_memory_allocated()
    calls, steps = summary["prefill_calls"], summary["decode_steps"]
    # the prefill: every encoder layer's self-attention and every decoder
    # layer's self- and cross-attention; a decode step: the decoder's two
    want = calls * (Le + 2 * Ld) + steps * 2 * Ld
    others = {k: v for k, v in got.items() if k != "flash_attention" and v}
    log(f"serve {SEAMLESS} wave: prefill {summary['prefill_tok_s']:.1f} "
        f"tok/s, decode {summary['decode_tok_s']:.1f} tok/s, "
        f"flash_attention launches {got['flash_attention']} (want {calls} x "
        f"({Le} + 2 x {Ld}) prefill + {steps} x 2 x {Ld} decode = {want}), "
        f"other launches {others or 0}, peak memory {peak / 2 ** 30:.2f} "
        f"GiB, first ids {summary['first_ids'][:8]}")
    if got["flash_attention"] != want or want == 0 or others:
        fail(f"serve {SEAMLESS}: launches {got}, want {want} attention "
             f"calls")
    if not summary["ids_in_vocab"]:
        fail(f"serve {SEAMLESS}: generated ids outside the vocabulary")

    cfg, params, tokens = serve.build(args)
    engine = serve.make_engine(cfg, args)
    B, S = tokens.shape
    batch = dict(engine.prompt_batch(tokens),
                 **serve.stub_extras(cfg, args, B, S))
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if not fa.launch_plan(B, 1, S, H, KH, hd)["decode"]:
        fail(f"{SEAMLESS}: the cross-attention of a decode step does not "
             f"take the decode path")
    train.reset_launches()
    kern, cache = engine.prefill(params, batch, engine.init_cache(
        B, S + args.gen, enc_len=S))
    torch.cuda.synchronize()
    per_prefill = train.read_launches()["flash_attention"]
    prev = layers.set_attention_impl(fa.flash_attention_plain)
    try:
        train.reset_launches()
        plain, _ = engine.prefill(params, batch, engine.init_cache(
            B, S + args.gen, enc_len=S))
        torch.cuda.synchronize()
        plain_launches = train.read_launches()
    finally:
        layers.set_attention_impl(prev)
    diff = float((kern[:, -1] - plain[:, -1]).abs().max())
    finite = bool(torch.isfinite(kern).all())
    log(f"{SEAMLESS} wave prefill: {per_prefill} attention calls (want "
        f"{Le + 2 * Ld}); encoder output {tuple(cache['enc_out'].shape)} "
        f"cached; last-position logits {tuple(kern[:, -1].shape)}, kernel "
        f"vs plain attention max|diff| {diff:.3e} (tol {LOGITS_TOL:g}), "
        f"finite {finite}, launches on the plain route "
        f"{sum(plain_launches.values())}")
    if per_prefill != Le + 2 * Ld or not finite or diff > LOGITS_TOL \
            or any(plain_launches.values()):
        fail(f"{SEAMLESS} prefill: kernel and plain attention routes "
             f"disagree")
    del plain

    # prefill of S-1 tokens (with the frames) and one decode step from the
    # cached encoder output, against the full forward's last logits
    with torch.no_grad():
        full, _, _ = T.apply(cfg, params, batch, last_only=True)
    head = {k: v[:, :S - 1] for k, v in batch.items()
            if k != "encoder_embeds"}
    head["encoder_embeds"] = batch["encoder_embeds"]
    inc = engine.init_cache(B, S, enc_len=S)
    _, inc = engine.prefill(params, head, inc)
    train.reset_launches()
    dec, inc = engine.decode(params, inc, tokens[:, S - 1:], S - 1)
    torch.cuda.synchronize()
    per_decode = train.read_launches()["flash_attention"]
    diff2 = float((dec[:, -1] - full[:, -1]).abs().max())
    log(f"{SEAMLESS} prefill {S - 1} + 1 decode step (from the cached "
        f"encoder output, {per_decode} attention calls, want {2 * Ld}) vs "
        f"the full forward's last logits: max|diff| {diff2:.3e} (tol "
        f"{LOGITS_TOL:g})")
    if diff2 > LOGITS_TOL or per_decode != 2 * Ld \
            or not bool(torch.isfinite(dec).all()):
        fail(f"{SEAMLESS}: prefill plus decode differs from the full "
             f"forward")
    del full, dec, inc
    tok = kern[:, -1].argmax(-1)[:, None]
    profile = _profile_decode(engine, params, cache, tok, S)
    del params, engine, cache, kern
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": got, "summary": summary, "peak": peak,
            "logits_diff": diff, "decode_diff": diff2, "profile": profile}


def phase_seamless_train() -> dict:
    """seamless-m4t-medium at full width and depth, 2 ranks, TRAIN's
    batches with 16 frames a microbatch row, as collective x layer, ODC x
    minibatch and odc-overlap, held to each other as qwen's runs are and
    to their launch counts (rows 1-5 each launched wherever the config
    runs it; under odc-overlap two chained gathers and two chained
    scatters a round, one per trunk); one profiled step."""
    from repro_torch.configs import get_config

    cfg = get_config(SEAMLESS)
    log(f"train {SEAMLESS}: full width and depth, "
        f"{cfg.num_encoder_layers} + {cfg.num_layers} layers "
        f"({_num_params(cfg):,} parameters)")
    runs = {}
    for comm, schedule in TRAIN_CONFIGS:
        tag = f"{SEAMLESS} {comm} x {schedule}"
        run = _train_run(tag, cfg, _train_args(SEAMLESS, comm, schedule,
                                               TRAIN["steps"]))
        got = run["launches"]
        rows = {"collective": ("flash_attention",),
                "odc": ("flash_attention", "odc_gather",
                        "odc_scatter_accumulate"),
                "odc-overlap": ("flash_attention", "odc_gather",
                                "odc_scatter_accumulate",
                                "odc_gather_layers",
                                "odc_scatter_accumulate_layers")}[comm]
        if not all(got[name] > 0 for name in rows):
            fail(f"train {tag}: a kernel it runs never launched: {got}")
        if comm == "odc-overlap":
            rounds = sum(st["microbatches"] for st in run["steps"])
            log(f"train {tag}: {got['odc_gather_layers']} chained gathers "
                f"and {got['odc_scatter_accumulate_layers']} chained "
                f"scatters over {rounds} rounds: one of each per trunk "
                f"(encoder, decoder) a round")
            if got["odc_gather_layers"] != 2 * rounds \
                    or got["odc_scatter_accumulate_layers"] != 2 * rounds:
                fail(f"train {tag}: the chained rings do not walk both "
                     f"trunks")
        runs[tag] = run
    _hold_to_first(runs)
    log(f"train {SEAMLESS} peaks: " + ", ".join(
        f"{tag} {run['peak_bytes'] / 2 ** 30:.2f} GiB"
        for tag, run in runs.items()))
    profile = _profile_train_step("odc", "minibatch", cfg=cfg)
    return {"runs": runs, "profile": profile}


# ---------------------------------------------------------------------------
# phase 4: serve qwen-1.5b at full width through the entry point, then
# the wave prefill with the plain attention, and a decode-step profile
# ---------------------------------------------------------------------------
def _serve_args(extra):
    from repro_torch.launch import serve

    return serve.parse_args(["--arch", ARCH, "--seed", str(SEED),
                             "--device", "cuda", "--dtype", "float32",
                             *extra])


def phase_serve() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve, train

    results = {}
    runs = {
        "wave": ["--batch", str(WAVE["batch"]),
                 "--prompt-len", str(WAVE["prompt_len"]),
                 "--gen", str(WAVE["gen"])],
        "continuous": ["--continuous", "--slots", str(CONT["slots"]),
                       "--requests", str(CONT["requests"]),
                       "--length-spread", str(CONT["length_spread"]),
                       "--prompt-len", str(CONT["prompt_len"]),
                       "--gen", str(CONT["gen"])],
    }
    total = dict.fromkeys(train.KERNELS, 0)
    for mode, extra in runs.items():
        train.reset_launches()
        summary = serve.run(_serve_args(extra))
        torch.cuda.synchronize()
        got = train.read_launches()
        for name, count in got.items():
            total[name] += count
        n = got["flash_attention"]
        rings = {k: v for k, v in got.items() if k != "flash_attention"}
        L = summary["num_layers"]
        want = L * (summary["prefill_calls"] + summary["decode_steps"])
        log(f"serve {mode}: prefill {summary['prefill_tok_s']:.1f} tok/s, "
            f"decode {summary['decode_tok_s']:.1f} tok/s, "
            f"flash_attention launches {n} (want {L} layers x "
            f"({summary['prefill_calls']} prefill calls + "
            f"{summary['decode_steps']} decode steps) = {want}), ring "
            f"launches {rings} (want 0), first ids "
            f"{summary['first_ids'][:8]}")
        if n != want or n == 0:
            fail(f"{mode}: {n} kernel launches, want {want}")
        if any(rings.values()):
            fail(f"{mode}: serving launched a ring kernel")
        if not summary["ids_in_vocab"]:
            fail(f"{mode}: generated ids outside the vocabulary")
        results[mode] = summary
    results["launches"] = total

    # the wave prefill again, with the plain attention swapped in
    from repro_torch.models import layers

    args = _serve_args(["--batch", str(WAVE["batch"]),
                        "--prompt-len", str(WAVE["prompt_len"]),
                        "--gen", str(WAVE["gen"])])
    cfg, params, tokens = serve.build(args)
    engine = serve.make_engine(cfg, args)
    cache = engine.init_cache(tokens.shape[0], tokens.shape[1] + args.gen)
    batch = engine.prompt_batch(tokens)
    kern, _ = engine.prefill(params, batch, cache)
    prev = layers.set_attention_impl(fa.flash_attention_plain)
    try:
        cache = engine.init_cache(tokens.shape[0], tokens.shape[1] + args.gen)
        plain, _ = engine.prefill(params, batch, cache)
    finally:
        layers.set_attention_impl(prev)
    diff = float((kern[:, -1] - plain[:, -1]).abs().max())
    finite = bool(torch.isfinite(kern).all())
    log(f"wave prefill last-position logits {tuple(kern[:, -1].shape)}, "
        f"kernel vs plain attention max|diff| {diff:.3e} "
        f"(tol {LOGITS_TOL:g}), finite {finite}")
    if not finite or diff > LOGITS_TOL:
        fail("full-width prefill logits: kernel and plain attention "
             "disagree")
    results["logits_diff"] = diff
    tok = kern[:, -1].argmax(-1)[:, None]
    results["profile"] = _profile_decode(engine, params, cache, tok,
                                         tokens.shape[1])
    del params, engine, cache
    torch.cuda.empty_cache()
    return results


def _launch_labels(events, labels):
    """kernel correlation id -> the label (a ``record_function`` span
    named in ``labels``) under which it was launched; how many runtime
    calls their own timestamps would have placed otherwise; and how many
    runtime calls were made under each label.

    A runtime call (a ``cuda_runtime`` event) names the host op that
    made it by its "External id".  That op's start and the label spans are taken
    on the profiler's host clock, so the op is placed in a span by its
    start.  The launch's own timestamp is CUPTI's, converted from another
    clock, and can fall outside a short span (the cause of a copy label
    that got no kernel in an earlier run)."""
    import bisect

    ops, spans = {}, {}
    for e in events:
        if e.get("cat") not in ("cpu_op", "user_annotation"):
            continue
        ext = e.get("args", {}).get("External id")
        if ext is not None:
            ops[ext] = e
        if e["cat"] == "user_annotation" and e["name"] in labels:
            spans.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
    starts = {}
    for tid, sp in spans.items():
        sp.sort()
        starts[tid] = [x[0] for x in sp]

    def place(tid, ts):
        i = bisect.bisect_right(starts.get(tid, []), ts) - 1
        return spans[tid][i][2] if i >= 0 and ts <= spans[tid][i][1] \
            else None

    out, moved, calls = {}, 0, dict.fromkeys(labels, 0)
    for e in events:
        if e.get("cat") != "cuda_runtime":
            continue
        args = e.get("args", {})
        op = ops.get(args.get("External id"))
        label = place(op["tid"], op["ts"]) if op else place(e["tid"],
                                                             e["ts"])
        moved += label != place(e["tid"], e["ts"])
        if label:
            out[args.get("correlation")] = label
            calls[label] += 1
    return out, moved, calls


def _device_ms(prof, name, per, classes, labels=None):
    """Device ms per kernel class (over ``per`` repetitions) from a
    torch.profiler trace: a kernel launched under a label of ``labels``
    (class -> ``record_function`` name) falls in that class, any other
    in the first class one of whose name fragments it contains, else in
    "other".  Kernels run one at a time on the one stream, so their
    durations add up to the busy time."""
    path = os.path.join(ROOT, "build", name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    labels = labels or {}
    by_corr, _, _ = _launch_labels(events, set(labels.values()))
    of_label = {v: c for c, v in labels.items()}
    dev = {c: 0.0 for c in list(labels) + list(classes)}
    dev["other"] = 0.0
    n_kernels = 0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        n_kernels += 1
        kname = e["name"].lower()
        cls = of_label.get(by_corr.get(e.get("args", {}).get("correlation")))
        if cls is None:
            cls = next((c for c, frags in classes.items()
                        if any(f in kname for f in frags)), "other")
        dev[cls] += e["dur"] / 1e3 / per
    return dev, n_kernels


def _profile_decode(engine, params, cache, tok, start, steps=8):
    """Where a steady-state wave decode step's time goes: host wall time
    per step without the profiler, then device time per kernel class from
    a torch.profiler trace of the same steps (kernels run one at a time on
    the one stream, so their durations add up to the busy time)."""
    from torch.profiler import ProfilerActivity, profile

    def run(first):
        nonlocal cache, tok
        for i in range(steps):
            logits, cache = engine.decode(params, cache, tok, first + i)
            tok = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()

    run(start)  # warm: every decode shape has run once
    t0 = time.perf_counter()
    run(start + steps)
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(start + 2 * steps)
        wall_prof = (time.perf_counter() - t0) * 1e3 / steps
    dev, n_kernels = _device_ms(prof, "decode_trace.json", steps, {
        "flash_attention": ("attn_fwd", "attn_decode"),
        "gemm": ("gemm", "gemv")})
    busy = sum(dev.values())
    log(f"decode step profile ({engine.cfg.name} wave, batch "
        f"{tok.shape[0]}): host "
        f"{wall:.2f} ms/step ({wall_prof:.2f} under the profiler), device "
        f"busy {busy:.2f} ms/step = flash_attention {dev['flash_attention']:.2f}"
        f" + gemm {dev['gemm']:.2f} + other {dev['other']:.2f}, "
        f"{n_kernels / steps:.0f} kernels/step, device idle "
        f"{max(0.0, 1 - busy / wall):.1%} of the step")
    if busy <= 0:
        log("decode step profile: the trace holds no device time "
            "(device breakdown not measured)")
    return {"host_ms": wall, "device_ms": dev,
            "kernels_per_step": n_kernels / steps}


# ---------------------------------------------------------------------------
# phase 4b: train qwen-1.5b at full width with two ranks on the card
# ---------------------------------------------------------------------------
def _expected_launches(cfg, comm, schedule, summary, dims):
    """Kernel launches a train run must make, from the model's leaves and
    layers and the run's microbatches, steps and cp degree.  Every layer
    runs its attention (the ssm family: its SSD scan; the hybrid family:
    the scan in each of its L mamba blocks and attention in each of its
    n_super invocations of the shared block) twice per microbatch
    (forward, and the recompute of the backward pass); one ring launch
    serves every rank.  The per-layer leaves are those of one block; the
    top-level ones are every leaf that is not stacked (the hybrid's
    shared block among them).  The audio family runs attention once in
    each encoder layer and twice (self and cross) in each decoder layer,
    and has two trunks: under the overlap schedule each round launches
    one chained gather and one chained scatter per trunk."""
    from repro_torch.core import fsdp
    from repro_torch.models import transformer as T

    L = cfg.num_layers
    # the leaves the rings move (not replicated, not stationary experts)
    sharded = [p for p in fsdp.tree_paths(dims)
               if fsdp.moves(fsdp.get(dims, p))]
    top = [p for p in sharded if fsdp.stack_depth(p) == 0]
    trunks = fsdp.trunk_groups(dims)
    block = fsdp.layer_dims(dims, trunks[0])
    moving = lambda b: sum(fsdp.moves(fsdp.get(b, p))
                           for p in fsdp.tree_paths(b))
    # blocks outside the chained rings under the overlap schedule: the
    # hybrid's tail
    tail = T.hybrid_split(cfg)[2] if cfg.family == "hybrid" else 0
    if T.is_moe(cfg):
        # n_super moe blocks and n_super * (P-1) dense blocks
        P, n_super = T.moe_split(cfg)
        trunk_leaves = n_super * (moving(block["moe"]) + (P - 1) * (
            moving(block["dense"]) if P > 1 else 0))
        per_layer = moving(block["moe"])  # (no tail: unused)
        L = n_super * P
    elif cfg.family == "audio":
        trunk_leaves = cfg.num_encoder_layers * moving(block) \
            + L * moving(fsdp.layer_dims(dims, "dec_layers"))
        per_layer = 0  # (no tail: unused)
    else:
        per_layer = moving(block)
        trunk_leaves = L * per_layer
    from repro_torch.launch.train import KERNELS

    # the kernels every microbatch runs, each in its forward and in its
    # recompute: per layer, or per shared-block invocation
    per_mb = ({"ssd_scan": L} if cfg.family == "ssm" else
              {"ssd_scan": L, "flash_attention": T.hybrid_split(cfg)[1]}
              if cfg.family == "hybrid" else
              {"flash_attention": cfg.num_encoder_layers + 2 * L}
              if cfg.family == "audio" else {"flash_attention": L})
    want = dict.fromkeys(KERNELS, 0)
    ring = comm in ("odc", "odc-overlap", "cp")
    cp = summary.get("cp", 1)
    for st in summary["steps"]:
        if summary.get("tiers"):
            # two tiers (minibatch or 1f1b): every rank runs its real
            # microbatches; each leaf that shards over both tiers is
            # gathered and scattered once, one inter ring per device index
            # (pipe-int8: each ring encodes and decodes once per member);
            # a leaf of the intra tier alone moves by concatenations and
            # sums
            T, g = summary["tiers"]
            both = [p for p in sharded
                    if not isinstance(fsdp.get(dims, p), fsdp.IntraDim)]
            for kern, k in per_mb.items():
                want[kern] += 2 * k * sum(st["counts"])
            if comm == "pipe-int8":
                want["odc_gather_q8"] += len(both) * g
                want["odc_scatter_accumulate_q8"] += len(both) * g
                want["quantize_int8"] += len(both) * g * T
                want["dequantize_int8"] += len(both) * g * T
            else:
                want["odc_gather"] += len(both) * g
                want["odc_scatter_accumulate"] += len(both) * g
        elif schedule == "overlap":
            # microbatch j of every rank in lockstep, padded to M: per
            # round one chained gather and one chained scatter carry the
            # trunk, the top-level leaves go through the single-leaf rings
            # once each way, and every layer runs its attention in the
            # forward and the recompute
            M = st["microbatches"]
            for kern, k in per_mb.items():
                want[kern] += 2 * k * summary["world"] * M
            want["odc_gather"] += M * (len(top) + 2 * tail * per_layer) \
                * ring
            want["odc_scatter_accumulate"] += \
                M * (len(top) + tail * per_layer) * ring
            want["odc_gather_layers"] += M * ring * len(trunks)
            want["odc_scatter_accumulate_layers"] += M * ring * len(trunks)
        elif schedule == "minibatch" and cp > 1:
            # each cp group runs its real microbatches in lockstep (a
            # group's count is the largest of its rows'); per layer and
            # group microbatch, in the forward and again in the recompute,
            # every rank sweeps 2*cp kv chunks through the state kernel
            # and the group ring-gathers k+v and positions+segment ids (2
            # launches), and the backward gathers q+cotangent (1); every
            # leaf is gathered once and scattered once per step
            G = summary["world"] // cp
            rows = len(st["counts"]) // G
            mbs = sum(max(st["counts"][d * rows:(d + 1) * rows])
                      for d in range(G))
            want["flash_attention_state"] += 2 * L * mbs * cp * 2 * cp
            want["odc_gather"] += (2 * 2 + 1) * L * mbs
            want["odc_gather"] += len(sharded)
            want["odc_scatter_accumulate"] += len(sharded)
        elif schedule == "minibatch":
            # each rank runs only its real microbatches (the moe family:
            # every microbatch, whose padding carries its router loss);
            # every leaf is gathered once and scattered once per step
            mbs = (summary["world"] * st["microbatches"] if T.is_moe(cfg)
                   else sum(st["counts"]))
            for kern, k in per_mb.items():
                want[kern] += 2 * k * mbs
            want["odc_gather"] += len(sharded) * ring
            want["odc_scatter_accumulate"] += len(sharded) * ring
        else:
            # microbatch j of every rank in lockstep, padded to M; the
            # top-level leaves once per microbatch, each layer's leaves in
            # the forward and again in the recompute
            M = st["microbatches"]
            for kern, k in per_mb.items():
                want[kern] += 2 * k * summary["world"] * M
            want["odc_gather"] += M * (len(top) + 2 * trunk_leaves) * ring
            want["odc_scatter_accumulate"] += \
                M * (len(top) + trunk_leaves) * ring
    return want


def _merge(intervals):
    """Union of (start, end) intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(a, b, merged):
    """Length of [a, b) inside the union ``merged``."""
    import bisect

    i = max(0, bisect.bisect_right([m[0] for m in merged], a) - 1)
    total = 0.0
    for lo, hi in merged[i:]:
        if lo >= b:
            break
        total += max(0.0, min(b, hi) - max(a, lo))
    return total


CHAINED = ("odc_gather_layers_kernel", "odc_scatter_layers_kernel")
COPY_LABELS = ("overlap.pack", "overlap.unpack", "overlap.write_cotangents")


def _overlap_timeline(path) -> dict:
    """From a train step's trace: the chained kernels' device time, the
    part of it that lies under other (compute) kernels on the timeline,
    the device time of the kernels launched under each copy label of
    ``core.overlap`` (``_launch_labels``), and the device's busy time (the
    union of every kernel's interval, since two streams run at once)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    chained = [e for e in kernels
               if any(c in e["name"].lower() for c in CHAINED)]
    compute = _merge([(e["ts"], e["ts"] + e["dur"]) for e in kernels
                      if e not in chained])
    busy = sum(b - a for a, b in _merge(
        [(e["ts"], e["ts"] + e["dur"]) for e in kernels]))
    chained_us = sum(e["dur"] for e in chained)
    under_us = sum(_covered(e["ts"], e["ts"] + e["dur"], compute)
                   for e in chained)
    # kernel -> the copy label it was launched under; and the runtime
    # calls (not all of them launches) made under each label against the
    # kernels the trace holds for them: calls without their kernels mean
    # the trace lost kernels
    by_corr, moved, calls = _launch_labels(events, COPY_LABELS)
    copies = dict.fromkeys(COPY_LABELS, 0.0)
    found = dict.fromkeys(COPY_LABELS, 0)
    for e in kernels:
        name = by_corr.get(e["args"].get("correlation"))
        if name:
            copies[name] += e["dur"] / 1e3
            found[name] += 1
    by_kernel = {c: sum(e["dur"] for e in chained if c in e["name"].lower())
                 / 1e3 for c in CHAINED}
    return {"chained_ms": chained_us / 1e3, "chained_by_kernel": by_kernel,
            "chained_under_compute_ms": under_us / 1e3,
            "chained_launches": len(chained), "copies_ms": copies,
            "launches_moved": moved,
            "calls_and_kernels": {k: (calls[k], found[k])
                                  for k in COPY_LABELS},
            "busy_ms": busy / 1e3}


def _kernel_ms(path, frags) -> dict:
    """Device ms of the kernels of an exported trace whose names hold each
    fragment of ``frags`` (name -> fragment)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = dict.fromkeys(frags, 0.0)
    for e in events:
        if e.get("cat") == "kernel":
            for k, frag in frags.items():
                if frag in e["name"]:
                    out[k] += e["dur"] / 1e3
    return out


def _profile_train_step(comm="odc", schedule="minibatch", cp=1,
                        cfg=None) -> dict:
    """Where one train step's time goes: host wall time of a step without
    the profiler, then device time per kernel class from a torch.profiler
    trace of the same step (same batch, next parameters), the kernels of
    the flash backward (``flash_attention_bwd``, PyTorch code) counted
    apart by their label.  For the overlap schedule also the chained
    rings' time under compute, the packing copies, and the busy time as
    the union of the kernels' intervals.  ``cp`` > 1: the cp run's
    configuration (CP_TRAIN, lb_token) instead of TRAIN's.  ``cfg``: the
    model in place of ARCH's (the SSD scan's backward, PyTorch code, is
    then counted apart by its label too, and the scan's class split by
    the four kernels of its sequence)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.balance.cost import CostModel
    from repro_torch.configs import get_config
    from repro_torch.core.ranks import RankGroup
    from repro_torch.core.train_step import Trainer
    from repro_torch.data.loader import SyntheticSFTLoader
    from repro_torch.data.packing import build_minibatch
    from repro_torch.launch.train import stub_extras
    from repro_torch.models import transformer as T

    from repro_torch.kernels.flash_attention import BWD_LABEL
    from repro_torch.kernels.ssd_scan import BWD_LABEL as SSD_BWD_LABEL

    spec = CP_TRAIN if cp > 1 else TRAIN
    cfg = cfg or get_config(ARCH)
    ranks = RankGroup.make(cp if cp > 1 else TRAIN["data_axis"], "cuda")
    tr = Trainer(cfg, ranks, comm=comm, schedule=schedule, cp=cp)
    shards, opt = tr.init_state(T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED)))
    loader = SyntheticSFTLoader(
        "longalign", vocab_size=cfg.vocab_size, world_size=ranks.n,
        minibatch_per_device=spec["minibatch_per_device"],
        max_tokens=spec["max_tokens"],
        strategy="lb_token" if cp > 1 else "lb_mini",
        max_len=spec["max_len"], seed=SEED,
        cost_model=CostModel(attention_free=cfg.is_attention_free,
                             window=cfg.sliding_window), cp=cp)
    sd = next(loader.steps(1))
    batch = build_minibatch(sd["plan"], sd["sample_tokens"],
                            spec["max_tokens"], extras=stub_extras(cfg, 0))
    counts = [len(a) for a in sd["plan"].assignments]

    def step():
        nonlocal shards, opt
        shards, opt, m = tr.step(shards, opt, batch, counts)
        torch.cuda.synchronize()
        return float(m["tokens"])

    t0 = time.perf_counter()
    tokens = step()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall_prof = (time.perf_counter() - t0) * 1e3
    tag = f"{cfg.name} {comm} x {tr.schedule}"
    name = f"train_trace_{cfg.name}_{comm}_{tr.schedule}.json"
    dev, n_kernels = _device_ms(prof, name, 1, {
        "flash_attention": ("attn_fwd", "attn_decode"),
        "flash_attention_state": ("attn_state",),
        "ssd_scan": ("ssd_",),  # the four kernels of a scan call
        "odc_chained": CHAINED,
        "odc_gather": ("odc_gather_kernel",),
        "odc_scatter": ("odc_scatter_pull_kernel",),
        "gemm": ("gemm", "gemv", "cutlass", "xmma")},
        labels={"flash_backward": BWD_LABEL,
                "ssd_backward": SSD_BWD_LABEL})
    busy = sum(dev.values())
    result = {"host_ms": wall, "host_ms_profiled": wall_prof,
              "device_ms": dev, "kernels": n_kernels}
    extra = ""
    if dev["ssd_scan"] > 0:
        from repro_torch.kernels.ssd_scan import KERNELS as SSD_KERNELS

        split = _kernel_ms(os.path.join(ROOT, "build", name),
                           {k: f"ssd_{k}_kernel" for k in SSD_KERNELS})
        result["ssd_scan_by_kernel"] = split
        extra = ("; ssd_scan by kernel " + ", ".join(
            f"{k} {v:.1f}" for k, v in split.items()))
    if tr.schedule == "overlap":
        tl = _overlap_timeline(os.path.join(ROOT, "build", name))
        busy = tl["busy_ms"]
        result["overlap"] = tl
        share = (tl["chained_under_compute_ms"] / tl["chained_ms"]
                 if tl["chained_ms"] else 0.0)
        extra += (f"; chained rings {tl['chained_ms']:.2f} ms in "
                  f"{tl['chained_launches']} launches "
                  f"({', '.join(f'{k} {v:.2f}' for k, v in tl['chained_by_kernel'].items())}), "
                  f"{tl['chained_under_compute_ms']:.2f} ms of it under "
                  f"compute kernels ({share:.1%}); copies "
                  + ", ".join(f"{k} {v:.2f} ms"
                              for k, v in tl["copies_ms"].items())
                  + f" (runtime calls, kernels in the trace: "
                  + ", ".join(f"{k} {a}, {b}" for k, (a, b)
                              in tl["calls_and_kernels"].items())
                  + f"; {tl['launches_moved']} calls that their own "
                  f"timestamps would have placed under another label or "
                  f"none); busy is the union of kernel intervals")
    result["busy_ms"] = busy
    result["idle"] = max(0.0, 1 - busy / wall)
    log(f"train step profile ({tag}, step 0's batch, {tokens:.0f} tokens, "
        f"microbatches {counts}): host {wall:.1f} ms ({wall_prof:.1f} under "
        f"the profiler), device busy {busy:.1f} ms; kernel time "
        + " + ".join(f"{k} {v:.1f}" for k, v in dev.items())
        + f", {n_kernels} kernels, device idle "
        f"{result['idle']:.1%} of the step{extra}")
    if busy <= 0:
        fail("train step profile: the trace holds no device time")
    del shards, opt, tr
    return result


def phase_train() -> dict:
    import gc
    from repro_torch.core import fsdp
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    runs = {}
    for comm, schedule in TRAIN_CONFIGS:
        args = train.parse_args([
            "--arch", ARCH, "--seed", str(SEED), "--device", "cuda",
            "--comm", comm, "--schedule", schedule, "--strategy", "lb_mini",
            "--dataset", "longalign",
            "--data-axis", str(TRAIN["data_axis"]),
            "--steps", str(TRAIN["steps"]),
            "--max-tokens", str(TRAIN["max_tokens"]),
            "--max-len", str(TRAIN["max_len"]),
            "--minibatch-per-device", str(TRAIN["minibatch_per_device"])])
        torch.cuda.reset_peak_memory_stats()
        train.reset_launches()
        summary = train.run(args)
        torch.cuda.synchronize()
        got = train.read_launches()
        cfg = get_config(ARCH)
        dims = summary["dims"]
        if any(fsdp.get(dims, p) is None for p in fsdp.tree_paths(dims)):
            fail(f"{ARCH} on {TRAIN['data_axis']} ranks replicates a leaf")
        want = _expected_launches(cfg, comm, schedule, summary, dims)
        peak = torch.cuda.max_memory_allocated()
        tag = f"{comm} x {schedule}"
        log(f"train {tag}: losses {summary['losses']}, step s "
            f"{[round(t, 3) for t in summary['step_s']]}, tokens "
            f"{[st['tokens'] for st in summary['steps']]}, microbatches "
            f"{[(st['microbatches'], st['counts']) for st in summary['steps']]}"
            f", {summary['tok_s']:.1f} tok/s, peak memory "
            f"{peak / 2 ** 30:.2f} GiB, launches {got} (want {want})")
        if not all(math.isfinite(x) for x in summary["losses"]):
            fail(f"train {tag}: a loss is not finite")
        if got != want:
            fail(f"train {tag}: kernel launches {got}, want {want}")
        summary["peak_bytes"] = peak
        summary["launches"] = got
        runs[tag] = summary
        gc.collect()
        torch.cuda.empty_cache()
    _hold_to_first(runs)
    gc.collect()
    torch.cuda.empty_cache()
    profiles = {}
    for comm, schedule in (("odc", "minibatch"), ("odc-overlap", "overlap")):
        profiles[f"{comm} x {schedule}"] = _profile_train_step(comm,
                                                               schedule)
        gc.collect()
        torch.cuda.empty_cache()
    return {"runs": runs, "profiles": profiles}


def _hold_to_first(runs):
    """Every run against the first: step-0 losses equal (the same
    parameters and batches through the same forward), step-0 gradient
    norms within GRAD_NORM_RTOL, later losses within TRAIN_LOSS_RTOL."""
    (b, rb), *others = runs.items()
    for a, ra in others:
        l0a, l0b = ra["losses"][0], rb["losses"][0]
        if l0a != l0b:
            fail(f"train step-0 losses differ: {a} {l0a!r}, {b} {l0b!r} "
                 f"(the same parameters and batches through the same "
                 f"forward)")
        gna, gnb = (r["steps"][0]["grad_norm"] for r in (ra, rb))
        gn_rel = abs(gna - gnb) / gnb
        rel = max(abs(x - y) / abs(y) for x, y in zip(ra["losses"][1:],
                                                       rb["losses"][1:]))
        log(f"train {a} against {b}: step-0 losses equal ({l0a!r}); step-0 "
            f"gradient norms {gna!r} and {gnb!r}, {gn_rel:.2e} relative "
            f"(tol {GRAD_NORM_RTOL:g}); later losses agree to {rel:.2e} "
            f"relative (tol {TRAIN_LOSS_RTOL:g})")
        if not math.isfinite(gna) or gn_rel > GRAD_NORM_RTOL:
            fail(f"train: {a} and {b} step-0 gradient norms differ by "
                 f"{gn_rel:.2e}")
        if rel > TRAIN_LOSS_RTOL:
            fail(f"train: {a} and {b} losses after step 0 differ by "
                 f"{rel:.2e}")


# ---------------------------------------------------------------------------
# phase 4b': train qwen-1.5b at full width with context parallelism
# ---------------------------------------------------------------------------
def _cp_args(steps):
    from repro_torch.launch import train

    return train.parse_args([
        "--arch", ARCH, "--seed", str(SEED), "--device", "cuda",
        "--comm", "cp", "--cp", str(CP_TRAIN["cp"]), "--strategy",
        "lb_token", "--dataset", "longalign", "--steps", str(steps),
        "--max-tokens", str(CP_TRAIN["max_tokens"]),
        "--max-len", str(CP_TRAIN["max_len"]),
        "--minibatch-per-device", str(CP_TRAIN["minibatch_per_device"]),
        "--lr", "1e-3"])


def phase_cp_train() -> dict:
    """The cp run through the train entry point: data 1 x cp 2 on the
    card, lb_token plans of 8192-token group rows; then step 0 again with
    every attention run by the plain route, and one profiled step."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core import cp
    from repro_torch.launch import train
    from repro_torch.models import layers

    torch.cuda.reset_peak_memory_stats()
    train.reset_launches()
    summary = train.run(_cp_args(CP_TRAIN["steps"]))
    torch.cuda.synchronize()
    got = train.read_launches()
    peak = torch.cuda.max_memory_allocated()
    want = _expected_launches(get_config(ARCH), "cp", "minibatch", summary,
                              summary["dims"])
    # the leaf cp gathers most (core/cp.py, _gather_seq): a layer's k and
    # v stacked, (S_loc, B, 2, kv heads, head dim) float32 on cp ranks, a
    # microbatch row of each rank's --max-tokens; its positions and segment
    # ids are gathered as often
    cfg = get_config(ARCH)
    summary["kv_leaf"] = (CP_TRAIN["max_tokens"], 1, 2, cfg.num_kv_heads,
                          cfg.resolved_head_dim)
    summary["kv_ranks"] = CP_TRAIN["cp"]
    log(f"train cp: the (k, v) leaf _gather_seq receives: "
        f"{summary['kv_leaf']} float32 on {summary['kv_ranks']} ranks")
    splits = [st["cp_split"] for st in summary["steps"]]
    log(f"train cp x minibatch (data 1 x cp {CP_TRAIN['cp']}, lb_token, "
        f"{CP_TRAIN['max_tokens']} tokens a rank): losses "
        f"{summary['losses']}, step s "
        f"{[round(t, 3) for t in summary['step_s']]}, tokens "
        f"{[st['tokens'] for st in summary['steps']]}, group microbatches "
        f"{[st['counts'] for st in summary['steps']]}, cp-split samples "
        f"{splits}, {summary['tok_s']:.1f} tok/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB, launches {got} (want {want}), grad "
        f"norms {[st['grad_norm'] for st in summary['steps']]}")
    if not all(math.isfinite(x) for x in summary["losses"]):
        fail("train cp: a loss is not finite")
    if sum(splits) == 0:
        fail("train cp: no sample was split across the cp group")
    if got != want:
        fail(f"train cp: kernel launches {got}, want {want}")
    summary["peak_bytes"] = peak
    summary["launches"] = got
    gc.collect()
    torch.cuda.empty_cache()

    prev = layers.set_group_attention_impl(cp.allgather_attention)
    try:
        plain = train.run(_cp_args(1))
    finally:
        layers.set_group_attention_impl(prev)
    torch.cuda.synchronize()
    l0, p0 = summary["losses"][0], plain["losses"][0]
    g0, pg0 = summary["steps"][0]["grad_norm"], plain["steps"][0]["grad_norm"]
    l_rel, g_rel = abs(l0 - p0) / abs(p0), abs(g0 - pg0) / abs(pg0)
    log(f"train cp step 0 against the plain route (allgather_attention, "
        f"state launches {plain['launches']['flash_attention_state']}): "
        f"loss {l0!r} vs {p0!r} ({l_rel:.2e} relative), gradient norm "
        f"{g0!r} vs {pg0!r} ({g_rel:.2e} relative; tol {CP_PLAIN_RTOL:g})")
    if plain["launches"]["flash_attention_state"]:
        fail("train cp: the plain route launched the state kernel")
    if not (l_rel <= CP_PLAIN_RTOL and g_rel <= CP_PLAIN_RTOL):
        fail("train cp: step 0 differs from the plain route")
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    profile = _profile_train_step("cp", "minibatch", cp=CP_TRAIN["cp"])
    gc.collect()
    torch.cuda.empty_cache()
    return {"run": summary, "plain_rel": (l_rel, g_rel), "profile": profile}


# ---------------------------------------------------------------------------
# phase 4b'': train qwen-1.5b at full width under the two-tier backends
# ---------------------------------------------------------------------------
def _tier_args(comm, flags, steps, data_axis=TRAIN["data_axis"]):
    from repro_torch.launch import train

    return train.parse_args([
        "--arch", ARCH, "--seed", str(SEED), "--device", "cuda",
        "--comm", comm, *flags, "--strategy", "lb_mini", "--dataset",
        "longalign", "--data-axis", str(data_axis), "--steps", str(steps),
        "--max-tokens", str(TRAIN["max_tokens"]),
        "--max-len", str(TRAIN["max_len"]),
        "--minibatch-per-device", str(TRAIN["minibatch_per_device"])])


def _tier_run(tag, args, cfg=None) -> dict:
    """One two-tier run through the train entry point, its launches held
    to ``_expected_launches``."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cfg = cfg or get_config(ARCH)
    torch.cuda.reset_peak_memory_stats()
    train.reset_launches()
    summary = train.run(args, cfg=cfg)
    torch.cuda.synchronize()
    got = train.read_launches()
    peak = torch.cuda.max_memory_allocated()
    want = _expected_launches(cfg, summary["comm"], summary["schedule"],
                              summary, summary["dims"])
    T, g = summary["tiers"]
    log(f"train {tag} ({T} x {g}, {cfg.num_layers} layers): losses "
        f"{summary['losses']}, step s "
        f"{[round(t, 3) for t in summary['step_s']]}, tokens "
        f"{[st['tokens'] for st in summary['steps']]}, microbatches "
        f"{[st['counts'] for st in summary['steps']]}, "
        f"{summary['tok_s']:.1f} tok/s, peak memory {peak / 2 ** 30:.2f} "
        f"GiB, grad norms {[st['grad_norm'] for st in summary['steps']]}, "
        f"launches {got} (want {want})")
    if not all(math.isfinite(x) for x in summary["losses"]):
        fail(f"train {tag}: a loss is not finite")
    if got != want:
        fail(f"train {tag}: kernel launches {got}, want {want}")
    summary["peak_bytes"] = peak
    summary["launches"] = got
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def _same_step0(a, ra, b, rb):
    """Step 0 of run a against run b: the same loss (tolerance 0) and the
    gradient norm within GRAD_NORM_RTOL."""
    l0a, l0b = ra["losses"][0], rb["losses"][0]
    gna, gnb = (r["steps"][0]["grad_norm"] for r in (ra, rb))
    gn_rel = abs(gna - gnb) / gnb
    log(f"train {a} against {b}: step-0 losses {l0a!r} and {l0b!r}; "
        f"step-0 gradient norms {gna!r} and {gnb!r}, {gn_rel:.2e} relative "
        f"(tol {GRAD_NORM_RTOL:g})")
    if l0a != l0b:
        fail(f"train {a}: step-0 loss {l0a!r}, {b} {l0b!r} (the same "
             f"parameters and batches through the same forward)")
    if not math.isfinite(gna) or gn_rel > GRAD_NORM_RTOL:
        fail(f"train {a} and {b}: step-0 gradient norms differ by "
             f"{gn_rel:.2e}")


def _against_plain_q8(tag, q8, steps, data_axis=TRAIN["data_axis"],
                      cfg=None, count_zeros=False):
    """The first ``steps`` steps of the pipe-int8 run ``q8`` against the
    same run on the plain q8 route (the rings of ``core.odc``, no q8 or
    codec kernel): losses and gradient norms bitwise equal.  With
    ``count_zeros`` the plain route's q8 scatters also report step 0's
    zeroed gradient elements (``_Q8Zeros``); that run is not timed."""
    import contextlib
    import gc

    from repro_torch.core import odc
    from repro_torch.kernels import quant
    from repro_torch.launch import train

    kernels = (quant.odc_gather_q8, quant.odc_scatter_accumulate_q8)
    quant.odc_gather_q8 = odc.ring_gather_q8
    quant.odc_scatter_accumulate_q8 = odc.ring_scatter_accumulate_q8
    try:
        with (_Q8Zeros() if count_zeros
              else contextlib.nullcontext()) as zeros:
            train.reset_launches()
            plain = train.run(_tier_args("pipe-int8", TIER_CONFIGS[2][1],
                                         steps, data_axis), cfg=cfg)
            torch.cuda.synchronize()
    finally:
        quant.odc_gather_q8, quant.odc_scatter_accumulate_q8 = kernels
    if count_zeros:
        zeros.report(steps)
    gc.collect()
    torch.cuda.empty_cache()
    losses = q8["losses"][:steps], plain["losses"]
    norms = [[st["grad_norm"] for st in r["steps"][:steps]]
             for r in (q8, plain)]
    same = losses[0] == losses[1] and norms[0] == norms[1]
    plain_q8 = {k: v for k, v in plain["launches"].items()
                if "q8" in k or "quantize" in k}
    log(f"train {tag} against the plain q8 route, {steps} step(s) (q8 and "
        f"codec launches {plain_q8}): losses {losses[0]} vs {losses[1]}, "
        f"gradient norms {norms[0]} vs {norms[1]}: bitwise equal {same}")
    if any(plain_q8.values()):
        fail(f"train {tag}: the plain route launched a q8 kernel")
    if not same:
        fail(f"train {tag}: a step differs from the plain q8 route")


class _Q8Zeros:
    """Counts, over the q8 scatters of a run (whichever q8 scatter the
    run calls: the plain route's, whose steps equal the kernel's bitwise),
    the gradient elements the q8 scatter rounds to 0 whose f32 sum (the same contributions summed in
    rank order, plain PyTorch: no kernel launch) is not 0; and those whose
    q8 sum is the owning rank's own contribution exactly while the other
    ranks' f32 contributions are not 0 (every contribution that arrived
    over the int8 wire rounded to 0: the own one is added in f32)."""

    def __enter__(self):
        from repro_torch.core import odc
        from repro_torch.kernels import quant

        self.calls = []
        self.kernel = quant.odc_scatter_accumulate_q8

        def counted(ys, order=None):
            out = self.kernel(ys, order)
            ref = odc.collective_scatter(ys)
            c = ref[0].shape[0]
            own = [y[r * c:(r + 1) * c] for r, y in enumerate(ys)]
            self.calls.append((
                sum(int(((o == 0) & (f != 0)).sum())
                    for o, f in zip(out, ref)),
                sum(int((f != 0).sum()) for f in ref),
                sum(f.numel() for f in ref),
                sum(int(((o == w) & (f != w)).sum())
                    for o, f, w in zip(out, ref, own))))
            return out

        quant.odc_scatter_accumulate_q8 = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import quant

        quant.odc_scatter_accumulate_q8 = self.kernel

    def report(self, steps):
        """Log step 0's counts (every step makes the same scatters)."""
        per = len(self.calls) // steps
        zeroed, nonzero, total, lost = (sum(c[i] for c in self.calls[:per])
                                        for i in range(4))
        log(f"train pipe-int8 step 0: the q8 scatter rounds {zeroed} of "
            f"{nonzero} nonzero f32 gradient elements to 0 "
            f"({zeroed / max(nonzero, 1):.3%}; {zeroed / total:.3%} of all "
            f"{total} elements it carries, over {per} scatters); in {lost} "
            f"({lost / total:.3%}) every other rank's nonzero contribution "
            f"rounded to 0 on the int8 wire")


def phase_tier_train(odc_run) -> dict:
    """hier, pipe and pipe-int8 at full width with TRAIN's two ranks as
    2 x 1, through the train entry point: hier's step 0 against ODC x
    minibatch's, pipe's against hier's, pipe-int8's steps against the same
    run with the plain q8 route (the rings of ``core.odc``, no q8 or codec
    kernel), bitwise, and its gap to pipe against INT8_LOSS_GAP; then the
    2 x 2 pipe-int8 run at PIPE4's depth, its step 0 bitwise the plain q8
    route's."""
    import dataclasses

    from repro_torch.configs import get_config

    runs = {}
    for comm, flags in TIER_CONFIGS:
        runs[comm] = _tier_run(comm, _tier_args(comm, flags,
                                                TRAIN["steps"]))
    _same_step0("hier x minibatch", runs["hier"], "odc x minibatch", odc_run)
    _same_step0("pipe x 1f1b", runs["pipe"], "hier x minibatch", runs["hier"])

    _against_plain_q8("pipe-int8", runs["pipe-int8"], TRAIN["steps"],
                      count_zeros=True)
    gaps = [abs(a - b) for a, b in zip(runs["pipe-int8"]["losses"],
                                       runs["pipe"]["losses"])]
    log(f"train pipe-int8 against pipe: |loss gap| per step "
        f"{[f'{x:.3e}' for x in gaps]}, "
        f"{'within' if max(gaps) < INT8_LOSS_GAP else 'ABOVE'} the "
        f"reference's bound {INT8_LOSS_GAP:g}")
    cfg4 = dataclasses.replace(get_config(ARCH), num_layers=PIPE4["layers"])
    runs["pipe-int8 2x2"] = _tier_run(
        "pipe-int8 2 x 2", _tier_args("pipe-int8", TIER_CONFIGS[2][1],
                                      TRAIN["steps"], PIPE4["data_axis"]),
        cfg=cfg4)
    _against_plain_q8("pipe-int8 2 x 2", runs["pipe-int8 2x2"], 1,
                      PIPE4["data_axis"], cfg4)
    return {"runs": runs, "int8_gaps": gaps}


# ---------------------------------------------------------------------------
# phase 4c: save and resume a reduced overlap run on the card
# ---------------------------------------------------------------------------
def phase_checkpoint() -> dict:
    """Reduced qwen, 2 ranks, odc-overlap: 2 steps and a checkpoint, then
    a resumed run to step 3, against 3 steps run straight: the losses and
    the final parameters bitwise equal."""
    import shutil

    from repro_torch.launch import train

    ckpt = os.path.join(ROOT, "build", "ckpt_smoke")
    shutil.rmtree(ckpt, ignore_errors=True)
    base = ["--arch", ARCH, "--reduced", "--seed", str(SEED), "--device",
            "cuda", "--data-axis", "2", "--comm", "odc-overlap",
            "--quiet"]
    straight = train.run(train.parse_args(base + ["--steps", "3"]),
                         return_params=True)
    first = train.run(train.parse_args(base + [
        "--steps", "2", "--ckpt-dir", ckpt, "--save-every", "2"]))
    train.reset_launches()
    resumed = train.run(train.parse_args(base + [
        "--steps", "3", "--ckpt-dir", ckpt, "--resume"]), return_params=True)
    losses = first["losses"] + resumed["losses"]
    params_equal = all(
        torch.equal(a, b) for a, b in zip(_leaves(straight["params"]),
                                          _leaves(resumed["params"])))
    chained = resumed["launches"]["odc_gather_layers"]
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"checkpoint (reduced {ARCH}, 2 ranks, odc-overlap): saved at "
        f"{first['saved']}, resumed at step {resumed['start_step']}; losses "
        f"{losses} against straight {straight['losses']}: equal "
        f"{losses == straight['losses']}; final parameters bitwise equal "
        f"{params_equal}; chained gathers in the resumed step {chained}")
    if first["saved"] != [2] or resumed["start_step"] != 2:
        fail("checkpoint: the run did not save at step 2 and resume there")
    if losses != straight["losses"] or not params_equal:
        fail("checkpoint: save and resume is not bitwise equal to a run "
             "without a break")
    if chained == 0:
        fail("checkpoint: the resumed overlap run launched no chained ring")
    return {"losses": losses}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


# ---------------------------------------------------------------------------
# phase 4e: post-training: rollouts, weight push and trainer
# ---------------------------------------------------------------------------
def _posttrain_args(rollout, comm, staleness, iters, files=None,
                    max_len=POSTTRAIN["rollout_max_len"]):
    """POSTTRAIN's settings through the post-training driver's parser;
    ``files``: (trace path, metrics path); ``max_len``: the rollouts'."""
    from repro_torch.launch import posttrain

    argv = ["--task", "grpo", "--arch", ARCH, "--seed", str(SEED),
            "--device", "cuda", "--data-axis", str(POSTTRAIN["data_axis"]),
            "--iters", str(iters), "--staleness", str(staleness),
            "--comm", comm, "--rollout", rollout,
            "--slots", str(POSTTRAIN["slots"]),
            "--prompts", str(POSTTRAIN["prompts"]),
            "--group", str(POSTTRAIN["group"]),
            "--prompt-len", str(POSTTRAIN["prompt_len"]),
            "--rollout-max-len", str(max_len),
            "--max-tokens", str(POSTTRAIN["max_tokens"]),
            "--lr", str(POSTTRAIN["lr"]), "--quiet"]
    if files:
        argv += ["--trace", files[0], "--metrics", files[1]]
    return posttrain.parse_args(argv)


def _plain_q8_push(trainer, shards):
    """A pipe-int8 push on the plain q8 route (``core.odc.ring_gather_q8``
    in place of the row-9 kernel's wrapper), on the card."""
    from repro_torch.core import odc
    from repro_torch.kernels import quant
    from repro_torch.posttrain.weight_push import push_params

    kernel = quant.odc_gather_q8
    quant.odc_gather_q8 = lambda xs, order=None: odc.ring_gather_q8(xs,
                                                                    order)
    try:
        return push_params(trainer, shards)
    finally:
        quant.odc_gather_q8 = kernel


class _PosttrainProbe:
    """Wraps ``WeightPusher.push`` and ``GRPOTask.generate_wave`` for one
    run: after each push, the pushed parameters bitwise against the
    trainer's (``Trainer.unshard``, concatenations; under pipe-int8, whose
    wire rounds, against the same push on the plain q8 route) and the
    row-1 and row-9 launches the push made; each wave's generated tokens,
    seconds and versions."""

    def __init__(self):
        self.pushes, self.waves, self.sites = [], [], None

    def __enter__(self):
        from repro_torch.kernels import odc_gather, quant
        from repro_torch.posttrain.tasks import GRPOTask
        from repro_torch.posttrain.weight_push import (WeightPusher,
                                                       push_comm_sites)

        self._orig = (WeightPusher.push, GRPOTask.generate_wave)
        push, wave = self._orig
        probe = self

        def checked_push(pusher, shards, version):
            before = (odc_gather.launches, quant.gather_launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params = push(pusher, shards, version)  # ends synchronised
            seconds = time.perf_counter() - t0
            grew = (odc_gather.launches - before[0],
                    quant.gather_launches - before[1])
            if getattr(pusher.trainer.backend, "compress", False):
                full = _plain_q8_push(pusher.trainer, shards)
            else:
                full = pusher.trainer.unshard(shards, pusher.device)
            same = all(_bits(a).equal(_bits(b)) for a, b in
                       zip(_leaves(params), _leaves(full)))
            del full
            if probe.sites is None:
                probe.sites = push_comm_sites(pusher.trainer, shards)
            probe.pushes.append({"version": version, "row1": grew[0],
                                 "row9": grew[1], "bitwise": same,
                                 "seconds": seconds})
            return params

        def timed_wave(task, it, params, version):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rollouts = wave(task, it, params, version)
            dt = time.perf_counter() - t0  # the tokens are on the host
            probe.waves.append({
                "seconds": dt, "versions": [r.version for r in rollouts],
                "generated": sum(r.length - task.prompt_len
                                 for r in rollouts),
                "tokens": sum(r.length for r in rollouts)})
            return rollouts

        WeightPusher.push, GRPOTask.generate_wave = checked_push, timed_wave
        return self

    def __exit__(self, *exc):
        from repro_torch.posttrain.tasks import GRPOTask
        from repro_torch.posttrain.weight_push import WeightPusher

        WeightPusher.push, GRPOTask.generate_wave = self._orig
        return False


def _bits(x):
    """A tensor's bits as integers (NaN payloads compare equal)."""
    return x.contiguous().view({8: torch.int64, 4: torch.int32,
                                2: torch.int16}[x.element_size()])


def _check_trace(path, wall_s, tag):
    """The --trace file read back through ``read_trace``: its lanes, and
    no span past the run's wall time."""
    from repro_torch.sim.trace import read_trace

    events = read_trace(path)["traceEvents"]
    lanes = {e["args"]["name"] for e in events if e.get("ph") == "M"}
    spans = [e for e in events if e.get("ph") in ("X", "i")]
    end_s = max((e["ts"] + e.get("dur", 0.0)) / 1e6 for e in spans)
    log(f"posttrain {tag}: trace lanes {sorted(lanes)}, {len(spans)} "
        f"events, the last ends at {end_s:.3f} s of the run's "
        f"{wall_s:.3f} s wall time")
    missing = {"generator", "push", "trainer"} - lanes
    if missing:
        fail(f"posttrain {tag}: the trace has no {sorted(missing)} lane")
    if end_s > wall_s:
        fail(f"posttrain {tag}: a trace span ends at {end_s:.3f} s, past "
             f"the run's {wall_s:.3f} s")


def _push_bytes(path):
    """comm.bytes_logical{op=push} over every tier, from the last row of
    a --metrics file read back through ``read_jsonl``."""
    from repro_torch.obs.metrics import read_jsonl

    _, rows = read_jsonl(path)
    return sum(m["value"] for m in rows[-1]["metrics"]
               if m["name"] == "comm.bytes_logical"
               and m["labels"].get("op") == "push")


# cycles of the spin kernel queued before a timed push (about 100 ms on
# an H100): longer than the host takes to enqueue a full-width push
PUSH_SPIN_CYCLES = 200_000_000


def _time_push(comm):
    """Device ms of one weight push under ``comm`` and of the row-1
    launches inside it, from CUDA events (no profiler: late in a whole run
    it has lost kernel records, PERF.md §7): a spin kernel keeps the
    device busy while the host enqueues the push, so the events bracket
    the device's work; an event pair brackets each row-1 launch.  A push
    from a fresh trainer's shards, after a warm one."""
    from repro_torch.kernels import odc_gather as kgather
    from repro_torch.launch import posttrain
    from repro_torch.posttrain.weight_push import push_comm_sites

    built = posttrain.build(_posttrain_args("engine", comm, 1, 1))
    trainer, shards, pusher = built[1], built[2], built[6]
    pusher.push(shards, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pusher.push(shards, 1)  # ends synchronised
    host_ms = (time.perf_counter() - t0) * 1e3
    kernel, pairs = kgather.odc_gather, []

    def timed(shards, order=None, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = kernel(shards, order, **kw)
        b.record()
        pairs.append((a, b))
        return out

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    kgather.odc_gather = timed
    try:
        torch.cuda._sleep(PUSH_SPIN_CYCLES)
        start.record()
        pusher.push(shards, 2)
        end.record()
        end.synchronize()
    finally:
        kgather.odc_gather = kernel
    device_ms = start.elapsed_time(end)
    row1_ms = sum(a.elapsed_time(b) for a, b in pairs)
    leaves = len(push_comm_sites(trainer, shards))
    log(f"posttrain push ({comm}, {leaves} sharded leaves): host "
        f"{host_ms:.2f} ms, device {device_ms:.4f} ms, of which row 1 "
        f"(odc_gather) {row1_ms:.4f} ms in {len(pairs)} launches")
    if len(pairs) != leaves or not 0 < row1_ms <= device_ms:
        fail(f"posttrain push timing: {len(pairs)} row-1 launches for "
             f"{leaves} leaves, {row1_ms:.4f} of {device_ms:.4f} ms")
    del built, trainer, shards, pusher
    return {"host_ms": host_ms, "device_ms": device_ms, "row1_ms": row1_ms,
            "row1_launches": len(pairs)}


def phase_posttrain() -> dict:
    """GRPO post-training of qwen-1.5b at full width and depth through the
    post-training entry point, two ranks on the card (POSTTRAIN): (a)
    rollouts from the wave engine under ODC pushes, (b) from the
    continuous engine with live ODC pushes, (c) the same with the
    collective's barrier push, each with --trace and --metrics; (d)
    synthetic rollouts at staleness 0 for one step on the kernel route and
    on the plain route (plain attention, collective transport).  Holds:
    every push bitwise the trainer's parameters, row 1 launched once per
    sharded leaf per ODC push, staleness <= K with versions increasing,
    comm.bytes_logical{op=push} per push the sum over push_comm_sites,
    the trace's lanes and span ends, push_stall_s > 0 in (c) and 0 in
    (b), and (d)'s step-0 losses within CP_PLAIN_RTOL."""
    import gc
    import shutil
    import tempfile

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import posttrain, train
    from repro_torch.models import layers

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out_dir = tempfile.mkdtemp(prefix="posttrain_smoke_")
    runs, launches = {}, {}
    for key, rollout, comm, iters, K, max_len in POSTTRAIN_RUNS:
        tag = f"({key}) {rollout} {comm}"
        files = (os.path.join(out_dir, f"{key}.json"),
                 os.path.join(out_dir, f"{key}.jsonl"))
        args = _posttrain_args(rollout, comm, K, iters, files, max_len)
        train.reset_launches()
        t0 = time.perf_counter()
        with _PosttrainProbe() as probe:
            summary = posttrain.run(args)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = train.read_launches()
        launches[f"posttrain {tag}"] = got
        steps = summary["metrics"]
        stal = [m["staleness"] for m in steps]
        versions = [v for w in probe.waves for v in w["versions"]]
        leaves = len(probe.sites or ())
        gen_tok = sum(w["generated"] for w in probe.waves)
        gen_s = sum(w["seconds"] for w in probe.waves)
        # the packed rollout tokens each step trains on (the rows'
        # "tokens" sums the advantage-signed loss mask)
        train_tok = sum(w["tokens"] for w in probe.waves)
        train_s = sum(m["dt"] for m in steps)
        want_push = sum((w - 1) * b for b, w, _ in probe.sites or ())
        got_push = _push_bytes(files[1]) / max(summary["pushes"], 1)
        _check_trace(files[0], wall, tag)
        # the pushes' own time (the trace's push spans also hold the
        # probe's bitwise check)
        push_s = sum(p["seconds"] for p in probe.pushes)
        log(f"posttrain {tag}: losses {[m['loss'] for m in steps]}, "
            f"staleness per step {stal}, rollouts "
            f"{[m['rollouts'] for m in steps]}, microbatches "
            f"{[m['microbatches'] for m in steps]}; pushes "
            f"{summary['pushes']} (versions "
            f"{[p['version'] for p in probe.pushes]}, row-1 / row-9 "
            f"launches each {[(p['row1'], p['row9']) for p in probe.pushes]}"
            f" for {leaves} sharded leaves, bitwise "
            f"{[p['bitwise'] for p in probe.pushes]}); "
            f"rollout {gen_tok / gen_s:.1f} tok/s ({gen_tok} generated "
            f"tokens in {gen_s:.3f} s), train {train_tok / train_s:.1f} "
            f"tok/s ({train_tok} packed tokens in {train_s:.3f} s, step s "
            f"{[round(m['dt'], 3) for m in steps]}); push share of the run {push_s / wall:.2%} "
            f"({push_s:.3f} of {wall:.3f} s); push_stall_s "
            f"{summary['push_stall_s']:.4f}; comm.bytes_logical{{op=push}} "
            f"per push {got_push:.0f} (sites {want_push:.0f}); launches "
            f"{got}")
        if not all(math.isfinite(m["loss"]) for m in steps):
            fail(f"posttrain {tag}: a loss is not finite")
        if len(steps) != iters or max(stal) > K:
            fail(f"posttrain {tag}: steps {len(steps)}, staleness {stal} "
                 f"(bound {K})")
        if versions != sorted(versions) or \
                [p["version"] for p in probe.pushes] != \
                list(range(summary["pushes"])):
            fail(f"posttrain {tag}: versions do not increase")
        if not probe.pushes or not all(p["bitwise"] for p in probe.pushes):
            fail(f"posttrain {tag}: a pushed parameter differs from the "
                 f"trainer's")
        ring, q8 = comm in ("odc", "odc-overlap"), comm == "pipe-int8"
        want_rows = (leaves if ring else 0, leaves if q8 else 0)
        if any((p["row1"], p["row9"]) != want_rows for p in probe.pushes):
            fail(f"posttrain {tag}: row-1 / row-9 launches per push "
                 f"{[(p['row1'], p['row9']) for p in probe.pushes]}, want "
                 f"{want_rows}")
        if got_push != want_push:
            fail(f"posttrain {tag}: comm.bytes_logical{{op=push}} per push "
                 f"{got_push}, want {want_push}")
        path = {"odc": ("odc_gather", "odc_scatter_accumulate"),
                "odc-overlap": ("odc_gather", "odc_scatter_accumulate",
                                "odc_gather_layers",
                                "odc_scatter_accumulate_layers"),
                "pipe-int8": ("quantize_int8", "dequantize_int8",
                              "odc_gather_q8", "odc_scatter_accumulate_q8"),
                "collective": ()}[comm] + ("flash_attention",)
        if not all(got[k] for k in path):
            fail(f"posttrain {tag}: a kernel of the path was not launched "
                 f"(want each of {path})")
        if rollout == "continuous" and (
                (summary["push_stall_s"] > 0) != (comm == "collective")):
            fail(f"posttrain {tag}: push_stall_s "
                 f"{summary['push_stall_s']} (a barrier push stalls, a p2p "
                 f"push does not)")
        runs[tag] = {"summary": summary, "launches": got, "wall_s": wall,
                     "rollout_tok_s": gen_tok / gen_s,
                     "train_tok_s": train_tok / train_s,
                     "push_share": push_s / wall}
        gc.collect()
        torch.cuda.empty_cache()
    # (d): one synthetic step at staleness 0, kernel route and plain route
    train.reset_launches()
    kern = posttrain.run(_posttrain_args("synthetic", "odc", 0, 1))
    kern_launches = train.read_launches()
    launches["posttrain (d) synthetic odc"] = kern_launches
    gc.collect()
    torch.cuda.empty_cache()
    prev = layers.set_attention_impl(fa.flash_attention_plain)
    try:
        train.reset_launches()
        plain = posttrain.run(_posttrain_args("synthetic", "collective", 0,
                                              1))
        plain_launches = train.read_launches()
    finally:
        layers.set_attention_impl(prev)
    l0, p0 = kern["metrics"][0]["loss"], plain["metrics"][0]["loss"]
    rel = abs(l0 - p0) / abs(p0)
    log(f"posttrain (d) synthetic, staleness 0, step 0: kernel route loss "
        f"{l0!r} (launches {kern_launches}), plain route (plain attention, "
        f"collective transport) {p0!r}, {rel:.2e} relative (tol "
        f"{CP_PLAIN_RTOL:g}); plain launches {sum(plain_launches.values())}")
    if sum(plain_launches.values()) or rel > CP_PLAIN_RTOL:
        fail("posttrain (d): step 0 on the kernel route differs from the "
             "plain route")
    gc.collect()
    torch.cuda.empty_cache()
    push = _time_push("odc")
    peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(out_dir, ignore_errors=True)
    log(f"posttrain: peak device memory over the phase {peak / 2 ** 30:.2f} "
        f"GiB; the phase took {time.perf_counter() - t_phase:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": runs, "launches": launches, "push": push,
            "peak_bytes": peak}


# ---------------------------------------------------------------------------
# phase 5: times against bounds
# ---------------------------------------------------------------------------
# cycles of the spin kernel queued before each timed call (about 1 ms on
# an H100): longer than the host takes to enqueue any timed call
SPIN_CYCLES = 2_000_000


def _time_ms(fn, iters=20, warmup=3):
    """Mean device time of one call, with L2 flushed before each call: in
    the serve path a layer's K/V was last touched a whole model ago.  A
    spin kernel queued after the flush keeps the device busy while the
    host enqueues the call, so the time between the events is the
    device's work, not the host's latency in the wrapper (a call that
    launches many small kernels, as the plain versions do, still counts
    the host's gaps between them)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _attn_mask_of(kw):
    from repro_torch.kernels.flash_attention import attn_mask

    return attn_mask(kw["q_positions"], kw["kv_positions"],
                     kw.get("q_segment_ids"), kw.get("kv_segment_ids"),
                     causal=kw["causal"], window=kw["window"])


def _attn_bound_ops(q, kw):
    """ms of the operations this input needs at the card's peak: every
    unmasked (query, key, head) triple costs 4*hd (QK^T and PV)."""
    H, hd = q.shape[2], q.shape[3]
    return 4 * hd * H * int(_attn_mask_of(kw).sum()) \
        / PEAK_FLOPS[q.dtype] * 1e3


def _state_bound(q, k, kw):
    """(operations ms, bytes ms) of one state-sweep call: the operations
    as ``_attn_bound_ops``; the bytes of q once, K/V of the keys some
    query needs, the f32 carry (m, l, acc) read and written, and the
    int32 positions and segment ids."""
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    es = q.element_size()
    kv_rows = int(_attn_mask_of(kw).any(1).sum())
    carry = 4 * B * S * H * (2 + hd)
    nbytes = B * S * H * hd * es + 2 * kv_rows * KH * hd * es + 2 * carry \
        + 8 * B * (S + T)
    return _attn_bound_ops(q, kw), nbytes / PEAK_BYTES * 1e3


def _attn_bound(q, k, kw):
    """Least time for the work this input needs: the operations
    (``_attn_bound_ops``), and the bytes of q and out once each plus K/V
    of the unmasked cache prefix of each row, plus the int32 positions."""
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    es = q.element_size()
    kv_rows = int(_attn_mask_of(kw).any(1).sum())  # keys some query needs
    nbytes = 2 * B * S * H * hd * es + 2 * kv_rows * KH * hd * es \
        + 4 * B * (S + T)
    t_ops = _attn_bound_ops(q, kw)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _sdpa(q, k, v, kw):
    """One library call for the same function: SDPA with the boolean mask
    and GQA, timed as a yardstick only (the port never calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attn_mask

    mask = attn_mask(kw["q_positions"], kw["kv_positions"],
                     kw.get("q_segment_ids"), kw.get("kv_segment_ids"),
                     causal=kw["causal"], window=kw["window"])[:, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


# waves of the card's resident blocks at which the broadcast gathers (rows
# 1 and 9) are also timed; _ring.PULL_WAVES is their default
BCAST_WAVE_SWEEP = (1, 2, 4, 8)


def _bcast_waves(call, nbytes, n, lib_name, symbol, iters) -> dict:
    """{waves: (blocks a rank, ms)} of a broadcast gather, ``call(blocks)``
    on ``nbytes`` bytes a shard (of codes, for row 9) on n ranks, at each
    of BCAST_WAVE_SWEEP waves of the card's resident blocks."""
    from repro_torch.kernels import _build, _ring

    cap = _ring.capacity(_build.library(lib_name), symbol)
    out = {}
    for waves in BCAST_WAVE_SWEEP:
        blocks = _ring.pull_blocks_per_rank(nbytes, n, cap,
                                            _ring.BCAST_UNROLL, waves)
        out[waves] = (blocks, _time_ms(lambda: call(blocks), iters=iters))
    return out


def _ring_times(kind, n, shape) -> dict:
    """Kernel, plain ring and library times of one ring kernel on n ranks'
    float32 shards of ``shape`` (bound: n*c read + n^2*c written for the
    gather, n^2*c read + n*c written for the scatter, at 3.35 TB/s), and
    the kernel's max |diff| from the plain ring there."""
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import odc_scatter as S

    g = torch.Generator(device="cuda").manual_seed(5)
    numel = math.prod(shape)
    c_bytes = numel * 4
    if kind == "gather":
        xs = [torch.randn(shape, generator=g, device="cuda")
              for _ in range(n)]
        max_err = max(float((a - b).abs().max()) for a, b in zip(
            G.odc_gather(xs), G.odc_gather_plain(xs)))
        ms = _time_ms(lambda: G.odc_gather(xs), iters=10)
        plain_ms = _time_ms(lambda: G.odc_gather_plain(xs), iters=10)
        lib_ms = _time_ms(lambda: [torch.cat(xs) for _ in range(n)],
                          iters=10)
        nbytes = (n + n * n) * c_bytes
        waves = _bcast_waves(lambda b: G.odc_gather(xs, blocks_per_rank=b),
                             c_bytes, n, "odc_gather",
                             "repro_odc_gather_capacity", 10)
        log(f"time odc_gather n={n} {shape} by waves (blocks a rank, ms): "
            f"{waves}")
    else:
        ys = [torch.randn((n * shape[0],) + tuple(shape[1:]), generator=g,
                          device="cuda") for _ in range(n)]
        stacked = torch.stack(ys).view((n, n) + tuple(shape))
        max_err = max(float((a - b).abs().max()) for a, b in zip(
            S.odc_scatter_accumulate(ys), S.odc_scatter_accumulate_plain(ys)))
        ms = _time_ms(lambda: S.odc_scatter_accumulate(ys), iters=10)
        plain_ms = _time_ms(lambda: S.odc_scatter_accumulate_plain(ys),
                            iters=10)
        lib_ms = _time_ms(lambda: [stacked[:, r].sum(0) for r in range(n)],
                          iters=10)
        nbytes = (n * n + n) * c_bytes
    bound_ms = nbytes / PEAK_BYTES * 1e3
    name = "odc_gather" if kind == "gather" else "odc_scatter_accumulate"
    shape_s = f"n={n} float32 shard {shape} ({c_bytes / 2 ** 20:.1f} MiB)"
    log(f"time {name} {shape_s}: kernel {ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms (bytes), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
        f"kernel/bound {ms / bound_ms:.1f}x")
    torch.cuda.empty_cache()
    return {"shape": shape_s, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": lib_ms}


def _train_trunk_shard():
    """(L, c_flat) of the trunk as each of the train runs' ranks holds it
    packed: qwen's 28 layers and the 9 per-layer leaves' shards."""
    from repro_torch.configs import get_config
    from repro_torch.core import fsdp
    from repro_torch.core.overlap import LayerPacking
    from repro_torch.models import transformer as T

    shapes = T.param_shapes(get_config(ARCH))
    n = TRAIN["data_axis"]
    packing = LayerPacking(shapes, fsdp.leaf_dims(shapes, n), n)
    return packing.num_layers, packing.c_flat


def _layer_ring_times(kind, n, L, c) -> dict:
    """Kernel, plain and library times of one chained ring kernel on n
    ranks' float32 (L, c) shards (the gather) or (L, n*c) contributions
    (the scatter), its max |diff| from the plain version, and its byte
    bound: each shard read once and each output written once,
    (n + n^2) * c * L * 4 bytes at 3.35 TB/s for either kernel.  The
    kernel is timed twice: at its default grid, the one the overlap
    schedule runs beside the compute kernels (1/CHAIN_SHARE of the card),
    and at the whole card (every cluster the card holds at once, the grid
    a library call gets).  Library yardsticks: one ``torch.stack`` per
    rank (gather), one ``sum(0)`` per layer over every rank's
    contributions (scatter)."""
    from repro_torch.kernels import _ring
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import odc_scatter as S

    g = torch.Generator(device="cuda").manual_seed(6)
    lay = _ring.chain_layout(kind, n)
    if kind == "gather":
        clusters = _ring.capacity(_build_lib("odc_gather"),
                                  "repro_odc_gather_layers_capacity", n,
                                  lay.smem_bytes)
        xs = [torch.randn((L, c), generator=g, device="cuda")
              for _ in range(n)]
        max_err = max(float((a - b).abs().max()) for a, b in zip(
            G.odc_gather_layers(xs), G.odc_gather_layers_plain(xs)))
        torch.cuda.empty_cache()
        ms, card_ms = (_time_ms(lambda: G.odc_gather_layers(
            xs, blocks_per_rank=grid), iters=5, warmup=1)
            for grid in (None, clusters))
        plain_ms = _time_ms(lambda: G.odc_gather_layers_plain(xs), iters=5,
                            warmup=1)
        lib_ms = _time_ms(lambda: [torch.stack(xs, dim=1) for _ in range(n)],
                          iters=5, warmup=1)
        del xs
    else:
        clusters = _ring.capacity(_build_lib("odc_scatter"),
                                  "repro_odc_scatter_layers_capacity", 0, n,
                                  lay.smem_bytes)
        ys = [torch.randn((L, n * c), generator=g, device="cuda")
              for _ in range(n)]
        max_err = max(float((a - b).abs().max()) for a, b in zip(
            S.odc_scatter_accumulate_layers(ys),
            S.odc_scatter_accumulate_layers_plain(ys)))
        torch.cuda.empty_cache()
        ms, card_ms = (_time_ms(lambda: S.odc_scatter_accumulate_layers(
            ys, blocks_per_rank=grid), iters=5, warmup=1)
            for grid in (None, clusters))
        acc = [torch.zeros((L, c), device="cuda") for _ in range(n)]
        acc_ms = _time_ms(lambda: S.odc_scatter_accumulate_layers(
            ys, reverse=True, out=acc), iters=5, warmup=1)
        del acc
        plain_ms = _time_ms(lambda: S.odc_scatter_accumulate_layers_plain(ys),
                            iters=5, warmup=1)
        stacked = torch.stack(ys).view(n, L, n, c)
        lib_ms = _time_ms(lambda: [stacked[:, l].sum(0) for l in range(L)],
                          iters=5, warmup=1)
        del ys, stacked
    plan = _ring.chain_plan(kind, c, 4, n, clusters)
    blocks = plan.blocks_per_rank
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    nbytes = (n + n * n) * c * L * 4
    bound_ms = nbytes / PEAK_BYTES * 1e3
    # device-memory bytes each block moves per second, at either grid
    rate = [nbytes / (n * b) / (t * 1e-3) / 1e9
            for b, t in ((blocks, ms), (clusters, card_ms))]
    name = ("odc_gather_layers" if kind == "gather"
            else "odc_scatter_accumulate_layers")
    shape_s = (f"n={n} float32 (L, c) = ({L}, {c}) "
               f"({L * c * 4 / 2 ** 30:.2f} GiB per rank)")
    grid_s = (f"{blocks} clusters of {n} blocks ({n * blocks} blocks, on up "
              f"to {min(n * blocks, sms)} of {sms} SMs; {clusters * n // sms}"
              f" blocks of {lay.smem_bytes} bytes of shared memory, tiles of "
              f"{plan.tile_bytes} bytes, fit on an SM)")
    extra = {}
    if kind == "scatter":
        extra["reversed_accumulating_ms"] = acc_ms
    log(f"time {name} {shape_s}: kernel {ms:.4f} ms at the chained grid, "
        f"{grid_s}, {rate[0]:.2f} GB/s a block; {card_ms:.4f} ms at the "
        f"whole card ({clusters} clusters, {rate[1]:.2f} GB/s a block)"
        + (f"; reversed and accumulating at the chained grid, as the overlap "
           f"calls it, {acc_ms:.4f} ms" if extra else "")
        + f"; bound {bound_ms:.4f} ms (bytes), plain {plain_ms:.4f} ms, "
        f"library {lib_ms:.4f} ms, kernel/bound {ms / bound_ms:.1f}x "
        f"chained, {card_ms / bound_ms:.1f}x whole card")
    torch.cuda.empty_cache()
    return {"shape": shape_s, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": lib_ms, "grid": grid_s, "whole_card_ms": card_ms,
            "whole_card_clusters": clusters, "gb_s_per_block": rate[0],
            "whole_card_gb_s_per_block": rate[1], **extra}


def _state_times() -> dict:
    """Kernel, plain and reference times of the state sweep at the train
    shape: rank 0's sweep of the cp run, its 4096 local rows (12/2 heads,
    hd 128) over the gathered 8192-token row in 4 chunk calls of 2048
    keys.  Bound: per call, the unmasked (query, key, head) triples' 4*hd
    operations at 67 TFLOP/s against q, the kv chunk's needed rows, the
    carry in and out and the positions at 3.35 TB/s, the larger, summed
    over the calls.  No PyTorch call returns the unnormalized carry, so
    ``library_ms`` is null; ``reference_sdpa_ms`` times SDPA of the same q
    against the whole gathered row under the same mask (the normalized
    output), one call, as a reference only."""
    from repro_torch.core import cp
    from repro_torch.kernels import flash_attention as fa

    n, T = CP_TRAIN["cp"], 2 * CP_TRAIN["max_tokens"]
    q, k, v, pos, seg, perm = _cp_row(n, T, seed=12)
    S = T // n
    local = perm[:S]  # rank 0's rows: global chunks 0 and 3
    ql, ql_pos, ql_seg = q[:, local], pos[:, local], seg[:, local]
    chunk = T // (2 * n)
    calls = []
    for c in range(2 * n):
        sl = slice(c * chunk, (c + 1) * chunk)
        calls.append(dict(k=k[:, sl], v=v[:, sl], kw=dict(
            causal=True, window=0, q_positions=ql_pos,
            kv_positions=pos[:, sl], q_segment_ids=ql_seg,
            kv_segment_ids=seg[:, sl])))

    def sweep(fn, into=None):
        carry = into
        for call in calls:
            carry = fn(ql, call["k"], call["v"], carry, **call["kw"])
        return carry

    out = fa.finish_attention(sweep(fa.flash_attention_state))
    ref = fa.finish_attention(sweep(fa.flash_attention_state_plain))
    rows = fa.attn_mask(ql_pos, pos, ql_seg, seg, causal=True,
                        window=0).any(-1)
    max_err = float((out[rows] - ref[rows]).abs().max())
    carry = fa.fresh_carry(*ql.shape, device="cuda")
    ms = _time_ms(lambda: sweep(fa.flash_attention_state, carry))
    plain_ms = _time_ms(lambda: sweep(fa.flash_attention_state_plain))
    kw_all = dict(causal=True, window=0, q_positions=ql_pos,
                  kv_positions=pos, q_segment_ids=ql_seg,
                  kv_segment_ids=seg)
    lib_ms = _time_ms(_sdpa(ql, k, v, kw_all))
    bound_ms = t_ops = t_bytes = 0.0
    for call in calls:
        ops_ms, bytes_ms = _state_bound(ql, call["k"], call["kw"])
        t_ops += ops_ms
        t_bytes += bytes_ms
        bound_ms += max(ops_ms, bytes_ms)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    plan = fa.launch_plan(*ql.shape[:2], chunk, ql.shape[2], k.shape[2],
                          ql.shape[3], ql.dtype, state=True)
    shape = (f"train (cp run, rank 0's sweep): q {tuple(ql.shape)} over "
             f"{2 * n} kv chunks {tuple(calls[0]['k'].shape)} float32, "
             f"{2 * n} launches, carry in place")
    log(f"time flash_attention_state {shape}: kernel {ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: operations {t_ops:.4f}, bytes "
        f"{t_bytes:.4f}), plain {plain_ms:.4f} ms, reference sdpa over the "
        f"gathered row {lib_ms:.4f} ms, kernel/bound {ms / bound_ms:.1f}x, "
        f"max|diff| vs plain {max_err:.3e} over {int(rows.sum())} rows; "
        f"{_plan_str(plan)}")
    del q, k, v, calls, carry
    torch.cuda.empty_cache()
    return {"shape": shape, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "reference_sdpa_ms": lib_ms, "launch": plan}


def _q8_times(kind) -> dict:
    """Kernel, plain and bound times of one q8 kernel at the pipe-int8
    path's shape: qwen's w_up shard on 2 ranks (the 2 x 1 inter ring's
    largest leaf).  Bounds, bytes at 3.35 TB/s, v values and e = 1 + 4/256
    encoded bytes a value: the codec 4 + e per value; the q8 gather each
    of the n encoded shards read and the n x n written, (n + n^2) v e; the
    q8 scatter as the f32 scatter, (n^2 + n) v 4.  No PyTorch call
    computes the encoder or the requantizing scatter; ``q * scales`` (held
    bitwise to the kernel first) is the decoder's library call, and one
    ``torch.stack`` per rank of codes and scales the gather's yardstick."""
    from repro_torch.core import odc
    from repro_torch.kernels import quant as Q

    n, e = 2, 1 + 4 / 256
    g = torch.Generator(device="cuda").manual_seed(9)
    v = math.prod(W_UP_SHARD)
    lib_ms = None
    if kind in ("quantize", "dequantize"):
        x = torch.randn(W_UP_SHARD, generator=g, device="cuda")
        q, s = Q.quantize_int8(x)
        if kind == "quantize":
            qr, sr = odc.quantize_chunked(x)
            max_err = max(float((q.int() - qr.int()).abs().max()),
                          float((s - sr).abs().max()))
            del qr, sr
            fn = lambda: Q.quantize_int8(x)
            plain = lambda: odc.quantize_chunked(x)
        else:
            out = Q.dequantize_int8(q, s, x.shape)
            max_err = float((out - odc.dequantize_chunked(q, s, x.shape))
                            .abs().max())
            lib = q * s  # int8 x f32 promotes each code and multiplies once
            if not torch.equal(lib.view(-1), out.view(-1)):
                fail("time dequantize: the library call `q * scales` is "
                     "not bitwise the kernel's output")
            del out, lib
            fn = lambda: Q.dequantize_int8(q, s, x.shape)
            plain = lambda: odc.dequantize_chunked(q, s, x.shape)
            lib_ms = _time_ms(lambda: q * s, iters=5, warmup=1)
        nbytes = v * (4 + e)
        shape_s = f"float32 {W_UP_SHARD} ({v * 4 / 2 ** 30:.2f} GiB)"
    elif kind == "gather":
        enc = [Q.quantize_int8(torch.randn(W_UP_SHARD, generator=g,
                                           device="cuda")) for _ in range(n)]
        qs, ss = [q for q, _ in enc], [s for _, s in enc]
        out = Q.gather_codes(qs, ss)
        max_err = float(max(
            max(int((a.view(-1, 256).int() - b.int()).abs().max()),
                float((c.view(-1) - d.view(-1)).abs().max()))
            for a, c, b, d in zip(out[0], out[1], odc.ring_gather(qs),
                                  odc.ring_gather(ss))))
        del out
        fn = lambda: Q.gather_codes(qs, ss)
        plain = lambda: (odc.ring_gather(qs), odc.ring_gather(ss))
        lib_ms = _time_ms(lambda: [(torch.stack(qs), torch.stack(ss))
                                   for _ in range(n)], iters=5, warmup=1)
        nbytes = (n + n * n) * v * e
        waves = _bcast_waves(
            lambda b: Q.gather_codes(qs, ss, blocks_per_rank=b), v, n,
            "odc_q8", "repro_odc_gather_q8_capacity", 5)
        log(f"time gather (q8) n={n} codes of {W_UP_SHARD} by waves "
            f"(blocks a rank, ms): {waves}")
        shape_s = f"n={n} codes of float32 shards {W_UP_SHARD}"
    else:
        ys = [torch.randn((n * W_UP_SHARD[0],) + W_UP_SHARD[1:],
                          generator=g, device="cuda") for _ in range(n)]
        max_err = max(float((a - b).abs().max()) for a, b in zip(
            Q.odc_scatter_accumulate_q8(ys),
            odc.ring_scatter_accumulate_q8(ys)))
        fn = lambda: Q.odc_scatter_accumulate_q8(ys)
        plain = lambda: odc.ring_scatter_accumulate_q8(ys)
        nbytes = (n * n + n) * v * 4
        shape_s = f"n={n} float32 chunks {W_UP_SHARD}"
    torch.cuda.empty_cache()
    ms = _time_ms(fn, iters=5, warmup=1)
    plain_ms = _time_ms(plain, iters=3, warmup=1)
    bound_ms = nbytes / PEAK_BYTES * 1e3
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    log(f"time {kind} (q8) {shape_s}: kernel {ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms (bytes), plain {plain_ms:.4f} ms, library "
        f"{lib}, kernel/bound {ms / bound_ms:.1f}x, max |kernel - plain| "
        f"{max_err}")
    torch.cuda.empty_cache()
    return {"shape": shape_s, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": lib_ms}


def _ssd_times(name) -> dict:
    """Kernel and plain times of the SSD scan at one of SSD_CASES' shapes
    in float32, its max |diff| from the plain version there, and its
    bound: the larger of the causal operations at the f32 rate and the
    bytes (inputs read once, y and the state written once) at 3.35 TB/s.
    The operations: the Q(Q+1)/2 scores C.B^T, 2n FLOP each, once per
    (b, group, chunk), since every head of a group shares them; per
    (b, h, chunk) their products with x, 2p FLOP each, and 4Qpn for the
    off-diagonal term and the state.  No single PyTorch call computes the
    scan: no library time.  Also the call's workspace: the peak bytes a
    call requests of the allocator less y and the state, measured in one
    call, which must be the bytes ``launch_plan`` gives."""
    from repro_torch.kernels import ssd_scan as K

    b, s, h, p, g, n, Q, pad = SSD_CASES[name]
    ins = _ssd_inputs(b, s, h, p, g, n, pad, torch.float32, seed=99)
    y, st = K.ssd_scan(*ins, Q)
    ry, rst = K.ssd_scan_plain(*ins, Q)
    max_err = max(_rel_err(y, ry)[0], _rel_err(st, rst)[0])
    del y, st, ry, rst
    ms = _time_ms(lambda: K.ssd_scan(*ins, Q))
    plain_ms = _time_ms(lambda: K.ssd_scan_plain(*ins, Q), iters=5,
                        warmup=1)
    (y, st), grew = _peak_requested(lambda: K.ssd_scan(*ins, Q))
    ws = grew - sum(t.numel() * t.element_size() for t in (y, st))
    ws_plan = K.launch_plan(b, s, h, p, g, n, Q)["workspace_bytes"]
    del y, st
    chunks = b * (s // Q)
    tri = Q * (Q + 1) // 2
    ops = chunks * (g * tri * 2 * n + h * (tri * 2 * p + 4 * Q * p * n))
    full_ops = chunks * (g * 2 * Q * Q * n
                         + h * (2 * Q * Q * p + 4 * Q * p * n))
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * g * n
                  + b * h * p * n)
    ops_ms = ops / PEAK_FLOPS[torch.float32] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    shape_s = (f"{name}: (b, s, h, p, g, n, Q) = {(b, s, h, p, g, n, Q)} "
               f"float32")
    log(f"time ssd_scan {shape_s}: kernel {ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {ops / 1e9:.2f} GFLOP causal; the "
        f"full (Q, Q) blocks {full_ops / 1e9:.2f} GFLOP, "
        f"{full_ops / PEAK_FLOPS[torch.float32] * 1e3:.4f} ms; bytes "
        f"{bytes_ms:.4f} ms), plain {plain_ms:.4f} ms, library none, "
        f"kernel/bound {ms / bound_ms:.1f}x; workspace {ws} bytes (a "
        f"call's peak request less y and the state; the plan's {ws_plan})")
    if ws != ws_plan:
        fail(f"ssd_scan {name}: a call allocated {ws} bytes beyond y and "
             f"the state, its launch plan {ws_plan}")
    del ins
    torch.cuda.empty_cache()
    return {"shape": shape_s, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "workspace_bytes": ws}


def _gm_times(name, dtype, err) -> dict:
    """Kernel, plain and library times of gather_matmul at one of
    GM_CASES' shapes, and its bound: the larger of the operations (2 m k f
    per rank, every rank) at the card's peak for the type (f32: the CUDA
    cores' 67 TFLOP/s, the route it takes; bf16: the dense tensor-core 989
    TFLOP/s, its route) and the bytes (x and the shards read once, the
    outputs written once) at 3.35 TB/s.  Library: per rank one
    ``torch.matmul(x, torch.cat(shards))`` (TF32 off), and the matmul
    alone on a W concatenated beforehand."""
    from repro_torch.kernels import gather_matmul as GM

    n, m, k, f = GM_CASES[name]
    xs, ws = _gm_inputs(n, m, k, f, dtype, seed=99)
    ms = _time_ms(lambda: GM.gather_matmul(xs, ws))
    plain_ms = _time_ms(lambda: GM.gather_matmul_plain(xs, ws))
    lib_ms = _time_ms(lambda: [torch.matmul(x, torch.cat(ws)) for x in xs])
    W = torch.cat(ws)
    mm_ms = _time_ms(lambda: [torch.matmul(x, W) for x in xs])
    es = xs[0].element_size()
    ops = 2 * m * k * f * n
    nbytes = n * (m * k + (k // n) * f + m * f) * es
    ops_ms = ops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    tag = str(dtype).replace("torch.", "")
    shape_s = (f"{name}: {n} ranks, x {(m, k)}, shard {(k // n, f)} {tag}")
    log(f"time gather_matmul {shape_s} ({GM.route(n, m, k, f, dtype)} "
        f"route): kernel {ms:.4f} ms "
        f"({ops / ms / 1e9:.1f} TFLOP/s), bound {bound_ms:.4f} ms "
        f"({bound_by}: {ops / 1e9:.1f} GFLOP at "
        f"{PEAK_FLOPS[dtype] / 1e12:g} TFLOP/s; bytes {bytes_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, library (cat + matmul per rank) "
        f"{lib_ms:.4f} ms, matmul alone {mm_ms:.4f} ms, kernel/bound "
        f"{ms / bound_ms:.1f}x, kernel/library {ms / lib_ms:.2f}x")
    del xs, ws, W
    torch.cuda.empty_cache()
    return {"shape": shape_s, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "library_matmul_alone_ms": mm_ms,
            # tensor cores or CUDA cores; the record's "route" stays "cuda"
            "gm_route": GM.route(n, m, k, f, dtype)}


def _plan_str(plan) -> str:
    """One flash_attention launch: its path, grid, threads and shared
    memory."""
    grid = f"({plan['grid_x']}, {plan['grid_y']}, {plan['grid_z']})"
    if plan["decode"]:
        what = (f"decode path, clusters of {plan['cluster']}, "
                f"{plan['keys_tile']}-key tiles, rows <= {plan['rows_tile']}")
    else:
        what = (f"tiled path, {plan['rows_tile']} rows x "
                f"{plan['keys_tile']} keys a tile")
    return (f"{what}, grid {grid} x {plan['threads']} threads, "
            f"{plan['smem_bytes']} bytes of shared memory a block")


def phase_times(errs, grad_errs, gm_errs, serve_runs, train_runs) -> list:
    """One record per kernel: its numbers at the first shape, and at each
    measured shape under ``per_shape``; launches over the serve and train
    runs, by path under ``launches_by_path``."""
    from repro_torch.kernels import flash_attention as fa

    by_path = {}
    for name in serve_runs["serve"]:
        by_path[name] = {tag: got[name] for tag, got in serve_runs.items()}
        for tag, run in train_runs.items():
            by_path[name][f"train {tag}"] = run["launches"][name]

    shapes = []
    for name in ("serve prefill", "serve decode", "train",
                 "zamba2 serve prefill", "zamba2 serve decode",
                 "zamba2 train", "seamless encoder serve",
                 "seamless cross prefill", "seamless cross decode",
                 "seamless train cross"):
        grad_err = None
        if name in ("train", "zamba2 train"):
            heads = (dict(H=32, KH=32, hd=64) if name == "zamba2 train"
                     else {})
            q, k, v, kw = _train_attn_case(seed=99, **heads)
            shape = (f"{name}: packed q {tuple(q.shape)} kv "
                     f"{tuple(k.shape)} float32, segments of 1500/1800/500 "
                     f"+ padding")
            err, grad_err = grad_errs[TRAIN_ATTN if name == "train"
                                      else ZAMBA_TRAIN_ATTN]
        else:
            B, S, T, H, KH, hd, opt = ATTN_CASES[name]
            q, k, v, kw = _attn_case(B, S, T, H, KH, hd, torch.float32,
                                     seed=99, **opt)
            shape = (f"{name}: q {tuple(q.shape)} kv {tuple(k.shape)} "
                     f"float32, " + (f"cache valid to {opt['kv_valid'][0]}"
                                     if "kv_valid" in opt else
                                     "non-causal, no segment ids"))
            err = errs[(name, torch.float32)]
            if name in GRAD_CASES:
                grad_err = grad_errs[name][1]
        ms = _time_ms(lambda: fa.flash_attention(q, k, v, **kw))
        plain_ms = _time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw))
        lib_ms = _time_ms(_sdpa(q, k, v, kw))
        bound_ms, bound_by = _attn_bound(q, k, kw)
        plan = fa.launch_plan(*q.shape[:2], k.shape[1], q.shape[2],
                              k.shape[2], q.shape[3], q.dtype)
        log(f"time flash_attention {shape}: kernel {ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, kernel/bound {ms / bound_ms:.1f}x, "
            f"kernel/sdpa {ms / lib_ms:.2f}x; {_plan_str(plan)}")
        shapes.append({"shape": shape, "max_abs_err": err,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": lib_ms,
                       "launch": plan})
        if grad_err is not None:  # dq/dk/dv, kernel route vs plain route
            shapes[-1]["grad_max_abs_err"] = grad_err
        if plan["decode"]:  # the same call over one 64-key tile
            q1, k1, v1, kw1 = _attn_case(B, S, fa.DECODE_TILE, H, KH, hd,
                                         torch.float32, seed=99,
                                         q_pos=[fa.DECODE_TILE - 1] * B,
                                         kv_valid=[fa.DECODE_TILE - 1] * B)
            one = _time_ms(lambda: fa.flash_attention(q1, k1, v1, **kw1))
            log(f"time flash_attention {name} over one {fa.DECODE_TILE}-key "
                f"tile (q {tuple(q1.shape)}): kernel {one:.4f} ms, bound "
                f"{_attn_bound(q1, k1, kw1)[0]:.4f} ms: the path's fixed "
                f"cost")
            shapes[-1]["one_tile_ms"] = one
            del q1, k1, v1
        del q, k, v
    records = [{"name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:167",
                "launches": sum(by_path["flash_attention"].values()),
                "launches_by_path": by_path["flash_attention"],
                **shapes[0], "per_shape": shapes}]
    state = _state_times()
    records.append({"name": "flash_attention_state", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/"
                              "flash_attention.cu",
                    "replaces": "src/repro/kernels/flash_attention.py:416",
                    "launches": sum(by_path["flash_attention_state"]
                                    .values()),
                    "launches_by_path": by_path["flash_attention_state"],
                    **state, "per_shape": [state]})
    for kind, name, src, replaces in (
            ("gather", "odc_gather", "odc_gather.cu",
             "src/repro/kernels/odc_gather.py:103"),
            ("scatter", "odc_scatter_accumulate", "odc_scatter.cu",
             "src/repro/kernels/odc_scatter.py:89")):
        ring = [_ring_times(kind, 2, W_UP_SHARD),
                _ring_times(kind, 4, (2 ** 24,))]
        if kind == "gather":  # the leaf cp gathers most: (k, v) of a layer
            cp_run = train_runs["cp x minibatch"]
            ring.append(_ring_times(kind, cp_run["kv_ranks"],
                                    cp_run["kv_leaf"]))
        records.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{src}",
                        "replaces": replaces,
                        "launches": sum(by_path[name].values()),
                        "launches_by_path": by_path[name], **ring[0],
                        "per_shape": ring})
    L, c = _train_trunk_shard()
    for kind, name, src, replaces in (
            ("gather", "odc_gather_layers", "odc_gather.cu",
             "src/repro/kernels/odc_gather.py:199"),
            ("scatter", "odc_scatter_accumulate_layers", "odc_scatter.cu",
             "src/repro/kernels/odc_scatter.py:176")):
        rec = _layer_ring_times(kind, TRAIN["data_axis"], L, c)
        records.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{src}",
                        "replaces": replaces,
                        "launches": sum(by_path[name].values()),
                        "launches_by_path": by_path[name], **rec,
                        "per_shape": [rec]})
    for kind, name, src, replaces in (
            ("quantize", "quantize_int8", "quant.cu", "quant.py:56"),
            ("dequantize", "dequantize_int8", "quant.cu", "quant.py:70"),
            ("gather", "odc_gather_q8", "odc_q8.cu", "quant.py:148"),
            ("scatter", "odc_scatter_accumulate_q8", "odc_q8.cu",
             "quant.py:253")):
        rec = _q8_times(kind)
        records.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{src}",
                        "replaces": f"src/repro/kernels/{replaces}",
                        "launches": sum(by_path[name].values()),
                        "launches_by_path": by_path[name], **rec,
                        "per_shape": [rec]})
    ssd = [_ssd_times(name) for name in ("serve prefill", "train",
                                         "zamba2 serve prefill",
                                         "zamba2 train")]
    records.append({"name": "ssd_scan", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                    "replaces": "src/repro/kernels/ssd_scan.py:83",
                    "launches": sum(by_path["ssd_scan"].values()),
                    "launches_by_path": by_path["ssd_scan"], **ssd[0],
                    "per_shape": ssd})
    gm = [_gm_times(name, dtype, gm_errs[(name, dtype)])
          for dtype in (torch.float32, torch.bfloat16) for name in GM_CASES]
    records.append({"name": "gather_matmul", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/"
                              "gather_matmul.cu",
                    "replaces": "src/repro/kernels/gather_matmul.py:92",
                    "launches": sum(by_path["gather_matmul"].values()),
                    "launches_by_path": by_path["gather_matmul"], **gm[0],
                    "per_shape": gm})
    return records


def main() -> int:
    t0 = time.perf_counter()
    env = phase_env()
    phase_build()
    errs = phase_kernel_cases()
    phase_decode()
    grad_errs = phase_flash_grad()
    phase_state_kernel()
    phase_cp_bitwise()
    phase_cp_grad()
    phase_rings()
    phase_gathers()
    phase_layer_rings()
    phase_layer_flags()
    phase_codec()
    phase_q8_rings()
    phase_ssd_kernel()
    phase_ssd_grad()
    gm = phase_gather_matmul()
    mamba_served = phase_mamba_serve()
    mamba_trained = phase_mamba_train()
    zamba_served = phase_zamba_serve()
    zamba_trained = phase_zamba_train()
    grok_served = phase_grok_serve()
    moe_trained = phase_moe_train()
    chameleon = phase_chameleon()
    seamless_served = phase_seamless_serve()
    seamless_trained = phase_seamless_train()
    served = phase_serve()
    trained = phase_train()
    cp_trained = phase_cp_train()
    tiers = phase_tier_train(trained["runs"]["odc x minibatch"])
    phase_checkpoint()
    posttrained = phase_posttrain()
    runs = dict(trained["runs"])
    runs["cp x minibatch"] = cp_trained["run"]
    for tag, run in tiers["runs"].items():
        runs[tag] = run
    runs.update(mamba_trained["runs"])
    runs.update(zamba_trained["runs"])
    runs.update(moe_trained["runs"])
    runs.update(chameleon["runs"])
    runs.update(seamless_trained["runs"])
    records = phase_times(errs, grad_errs, gm["errs"], {
        "serve": served["launches"],
        f"serve {MAMBA}": mamba_served["launches"],
        f"serve {ZAMBA}": zamba_served["launches"],
        f"serve {GROK}": grok_served["launches"],
        f"serve {CHAMELEON}": chameleon["launches"],
        f"serve {SEAMLESS}": seamless_served["launches"],
        **posttrained["launches"],
        "gather_matmul": gm["launches"]}, runs)
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s")
    print(env["smi"])
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
