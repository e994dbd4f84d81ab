#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

The main path is one compressed FL round (``repro_torch.fl.federated``
over a ``RoundProtocol``) at the full width of the smallest model in the
registry, qwen1.5-0.5b: d = 463,987,712 coordinates, n = 4 clients,
clip 1.0, through three mechanisms: aggregate_gaussian and irwin_hall on
the packed wire (b = 8-bit fields, the fused_agg kernels) and
individual_shifted on the unpacked wire (the layered kernels); the
signed dither_pack kernels run on their own entry point,
``ops.dither_pack_encode`` / ``ops.dither_unpack_decode``.  The serve
path runs qwen1.5-0.5b itself, uncut, with seeded random weights:
``launch.serve.drive`` over a ``ServeEngine``, whose bf16 prefill
attention goes through the flash_attention_sm90 kernel (wgmma + TMA) in
every layer; its f32 checks go through the flash_attention_f32 kernel
(3xTF32 wgmma + TMA).  The same round also runs across 4 client ranks
spawned on the card (``dist.compress.compress_tree(axis=group)``, gloo),
each rank holding one client's update shaped as qwen1.5-0.5b's
parameter tree, and through the async runtime and a checkpoint-resume.
The train path trains qwen1.5-0.5b at full width through
``train.steps.build_train_step`` (the train launcher's step): bf16,
remat, kv_chunk 1024, its attention forward, remat forward and backward
through flash_attention_sm90 and flash_attention_bwd_sm90 (wgmma + TMA),
the gradients compressed by the fused_agg kernels; in one process and
across 2 client ranks on the card; and in f32 (the compute dtype the
train launcher gives its smoke mode) through flash_attention_f32 and
flash_attention_bwd_f32_sm90 (3xTF32 wgmma + TMA).  The moe family runs
at full width with its depth cut to what the card holds: phi3.5-moe (24
of 32 layers) and dbrx (8 of 40) served in bf16 and checked in f32 (4
layers), phi3.5-moe trained (1 layer); llava-next-mistral-7b, uncut,
prefills prompts behind its 576 stub patches.  The other three dense
configs (starcoder2-3b, minitron-4b, qwen3-32b) are served uncut in bf16
and checked in f32.  rwkv6-1.6b, the first family outside the
transformer, runs its time recurrence through the wkv6 kernels (a serial
step kernel for the decode step, a chunked forward and backward for every
call of more than one step): served uncut in bf16 (the engine and the
naive loop take the decode path, one wkv6_step launch a layer per token;
``registry.prefill_fn`` the scan path, one chunked wkv6_fwd a layer) and
checked in f32, and trained at 16 of its 24 layers.  zamba2-7b (Mamba2
blocks and one shared attention block with a sliding window of 4096 at
head dim 112) is served at 13 of its 81 layers through the engine and
the scan-path
prefill, whose shared attention runs flash_attention_sm90 with the
window, checked in f32 at 7 layers, and trained at 7 of its 81 layers
on sequences of 8192 tokens, where both backwards mask by the window.
Phases, each fatal on failure:

  1. build every CUDA source of the port with nvcc (sm_90a), one nvcc
     per source, all started together, and hold the f32 backward's
     streamed tiles against the ones its CPU emulation takes
     (``flash_attention.F32_BWD_TILES``);
  2. hold each kernel against its plain PyTorch version on the card at
     full width: fused_agg words bitwise and decode within 1e-6 for b in
     {8, 4, 16, 24}, scalar and array step, with and without offset;
     layered messages bitwise and decode within 1e-6 at sigma_client 0.5
     and 0.01; dither_pack words bitwise and decode equal for b in
     {4, 8, 16}, w = 0.05; and each on one ragged size; the bf16 flash
     kernel (flash_attention_sm90) within one bf16 ulp + 2^-9 max|v| of
     ``ref.flash_attention_bf16_ref`` with 99% of outputs within one ulp
     + 2e-5, the f32 flash kernel within 2e-5 of
     ``ref.flash_attention_ref``, at the serve path's shapes, at zamba2's
     windowed (1, 8192, 32 / 32, 112) (window 4096), a window of 1000, a
     window >= T (bitwise the kernel without one, forward and backward), a
     window at D = 64 with a GQA group of 4 and D = 112 without a window,
     and at GQA
     (qwen3-32b's 64 / 8 heads of 128 among them), non-causal and ragged
     ones (the moe and llava paths' 32 / 8 and 48 / 8 heads of 128
     among them); the bf16 kernel at the model configs' kv_chunk 1024 against
     the plain version at the same chunk, at the shapes with more than
     1024 keys: every output within one ulp + 2^-9 max|v|, at least 99%
     within one ulp + 2e-5; and the backward kernels (bf16:
     flash_attention_bwd_sm90; f32: flash_attention_bwd_f32_sm90) against
     ``ref.flash_attention_bwd_ref`` at the train shapes (4 and 2,
     2048, 16, 64), (1, 8192, 16, 64), qwen3-32b's GQA heads, the moe
     and llava paths' (1 and 2, 2048, 32 / 8, 128) and (1, 2048, 48 / 8,
     128), starcoder2-3b's and minitron-4b's (1, 2048, 24 / 2 and 24 / 8,
     128), a ragged
     and a non-causal case, and the windowed cases (f32 within 2e-5 max|g|; bf16 every output within
     one ulp + 2e-5 max|g|, dV also + 2^-9 max|dO| max_j sum_i P[i, j],
     and 99% within one ulp + 2e-5 max|g|), bitwise equal over two runs;
     the mesh paths' per-rank shapes (the moe kind's 16 / 4, 8 / 2, 24 /
     4 and 12 / 2 heads of 128 among them; zamba2's 16 / 16 of 112 with
     its window and whisper's 6 / 6 of 64, ``FLASH_FAMILY_MESH_CASES``); the long sums of the bf16
     backward (``BWD_DRIFT_CASES``) and of the f32 forward's running O
     accumulator (``FWD_DRIFT_CASES``: T = 8192 and 16384 at 16 heads of
     64, T = 4096 and 8192 at 64 / 8 of 128, within 2e-5), the worst
     ratio of each to its bar logged;
     and the wkv6 kernels against ``ref.wkv6_ref`` / ``ref.wkv6_bwd_ref``
     at rwkv6's (1 and 2, 2048, 32, 64) in bf16 and f32, a ragged T = 700
     and the decode step (8, 1, 32, 64), its 16 heads a rank on the mesh
     (``WKV_FAMILY_MESH_CASES``), the smoke config's heads of 16
     (1, 300, 2, 16) in each dtype pair, and two extreme decays (w = 0, w
     = 1, a log decay summed past -88 within a chunk), with a nonzero
     first state and u: each output (y, the final state, every saved
     chunk state, dr, dk, dv, dw, du, dS0) finite and no further from an
     f64 run than twice the plain f32 version (the chunked kernels at T >
     1, the step kernel at T = 1, its states bitwise the plain version's),
     every kernel bitwise over two runs, and each one's distance from the
     chunked mirror (``ref.wkv6_chunked_ref``) logged;
  3. run each path with its kernels' launch counts set to 0 just before
     and read just after: FederatedAveraging for aggregate_gaussian
     (per-coordinate, sigma 0.25) and irwin_hall (sigma 5e-3), one packed
     round each, and individual_shifted (sigma 0.25), one unpacked round;
     one individual_direct round at 2^24 coordinates (no layered
     launches: the configuration picks the plain path); 4 client ranks
     (3b: an NCCL probe of 2 ranks on the card, recorded only, then
     compress_tree across 4 gloo ranks, each client's update shaped as
     qwen1.5-0.5b's tree at 8 of its 24 layers, for aggregate_gaussian and
     irwin_hall fused b = 8 and layered_shifted: outputs bitwise equal
     across ranks, each case's two kernels once per leaf on every rank,
     the summed words equal to the one-process sum of the clients'
     words, the error law); the async runtime at d = 2^24 (3c: 3 rounds
     at staleness 0 bitwise equal to the sync loop, a checkpoint-resume
     from round 1 bitwise equal to the run without the break); the train
     path (3d: 3 steps of 8 x 2048 in 2 microbatches, AdamW,
     aggregate_gaussian fused b = 8 per-tensor; per step 2 x 48
     flash_attention_sm90, 2 x 24 flash_attention_bwd_sm90, no f32
     attention kernel, 14 fused_encode and 14 fused_decode launches,
     finite losses; a fourth step timed, then a fifth traced under
     ``torch.profiler`` (device ms by kernel, idle share); and on 1 x
     2048 the loss and every gradient leaf on the kernels against the plain
     versions, both measured against the f32 model; 3f: the same step in
     f32, 2 steps of 4 x 2048 in 2 microbatches, per step 2 x 48
     flash_attention_f32, 2 x 24 flash_attention_bwd_f32_sm90, no bf16
     attention kernel, 14 + 14 fused, then a timed and a traced step, and
     on 1 x 2048 the loss within 1e-6 relative and every gradient leaf
     within 1e-4 max|g| of the same on the plain versions; 3e: 2 gloo
     ranks on the card, each with the full model and its AdamW state, 2
     steps of a global batch 4 x 2048 with irwin_hall fused b = 8, params
     bitwise equal across ranks after each step); and the dither_pack
     entry point at full width; check the counts, the wire
     width or Elias-gamma bits, and the error law (KS against
     N(0, sigma^2) on a 2^20-coordinate subsample; IH support and std;
     the dither error inside [-w/2, w/2]); then the serve path: 16
     requests (prompts of 256-2048 tokens, 64 or 8 generated) through 8
     slots in bf16, with exactly 24 flash_attention_sm90 launches per
     prefill and no f32 flash launch, and in f32 the engine's tokens
     against the naive loop's and a teacher-forced full forward, with 24
     flash_attention_f32 launches per forward and no sm90 launch; 3g: the
     moe serve path, phi3.5-moe at 24 layers (16 requests, profiled) and
     dbrx at 8 (4 requests) in bf16 through the same ``run_serve``, one
     flash_attention_sm90 launch per layer per prefill, and each at 4
     layers in f32, one request per call: the engine's tokens equal the
     naive loop's, a teacher-forced forward's agreement reported beside
     both sides' dropped-choice counts (held where neither dropped); 3h:
     llava uncut, in f32 one prompt's last logits on the kernels within
     1e-4 max|logit| of the plain versions, then 4 bf16 prefills of 576
     patches plus 512-2048 tokens through ``registry.prefill_fn``, 32
     flash_attention_sm90 launches each; 3i: the moe train step,
     phi3.5-moe at 1 layer, 3 steps of 4 x 2048 in 2 microbatches as
     phase 3d (launches per step from the spec tree), a timed and a
     traced step, and on 1 x 2048 the bf16 gradient check against the f32
     model and the f32 check of the kernels against the plain versions;
     3j: starcoder2-3b, minitron-4b and qwen3-32b uncut in bf16, 8
     requests of 256-2048 prompt tokens and 64 out each through
     ``run_serve`` (one flash_attention_sm90 launch per layer per
     prefill), then the f32 token checks (qwen3-32b at 4 layers); 3k:
     rwkv6 uncut in bf16, 8 requests of 16-64 prompt tokens through
     ``run_serve`` (one wkv6_step launch per layer per decode call; each
     prompt token is one), ``registry.prefill_fn`` over 4 prompts of
     512-2048 tokens (one chunked wkv6_fwd a layer), and in f32 the engine
     equal to the naive loop one request per call, its prefill bitwise its own
     decode chain, and the scan path's last logits within 1e-4
     max|logit| of the plain versions; 3l: the rwkv6 train step at 16
     layers as phase 3i (per step 2 x 16 x 2 wkv6_fwd and 16 x 2
     wkv6_bwd), with its bf16 and f32 gradient checks on the trained
     parameters' first 2 layers; 3m: zamba2 at 13 layers in bf16, 8
     requests of
     16-64 prompt tokens through ``run_serve`` (no kernel launch: its
     decode attention and Mamba2 steps are plain PyTorch, as the
     reference's), one served decode step profiled, ``registry.
     prefill_fn`` over 4 prompts of 4224-8192 tokens (one
     flash_attention_sm90 with the window per group), and at 7 layers in
     f32 the engine equal to the naive loop one request per call, its
     prefill bitwise its own decode chain, and the scan path's last logits
     past the window within 1e-4 max|logit| of the plain versions; 3n: the
     zamba2 train step at 7 layers on 2 x 8192 tokens in 2 microbatches
     (per step 2 x 2 x 2 flash_attention_sm90 and 2 x 2
     flash_attention_bwd_sm90, both with the window), with its bf16 and
     f32 gradient checks on the trained parameters' first group at 1 x
     8192; rwkv6's served decode step is profiled too (3k: wkv6_step's
     own device time); 3q: the (pod, data, model) mesh, gloo ranks sharing
     the card (``run_mesh_phase``): qwen1.5-0.5b at full width, 4 of its
     24 layers, trained on (2, 1, 2) with aggregate_gaussian fused b = 8
     over the pods (params bitwise
     across pods per model rank, each rank's launches per step), its f32
     gradient on (1, 2, 2) against one rank (1e-6 / 1e-4), qwen1.5-0.5b
     served uncut on (1, 1, 2) and starcoder2-3b at 5 of its 30 layers on
     (1, 1, 4) (its KV heads cut
     over the ranks, the cache split by sequence), their f32 tokens equal
     to one rank's and their bf16 logits as close to f32 as one rank's;
     3r: the moe kind on the mesh (``run_moe_mesh_phase``): phi3.5-moe
     at full width on (1, 1, 2), two gloo ranks sharing the card, under
     the tensor-parallel branch (each expert's d_ff split) and the
     expert-parallel one (``moe_ep``, two all-to-alls a layer): one
     layer's MoE block routing bitwise and its f32 output within 1e-5
     max|y| of one rank's from the same x (the ep branch also resharded
     from SERVE_RESIDENT_RULES), a 4-layer bf16 engine's tokens equal on
     both ranks and its logits as close to f32 as one rank's (the
     routing choices that differ counted), and a 1-layer f32 gradient
     within 1e-4 max|g| of one rank's, then one AdamW step; 3s: rwkv6,
     zamba2 and whisper on the mesh (``run_family_mesh_phase``, gloo ranks
     sharing the card): rwkv6-1.6b uncut and zamba2-7b at 13 layers
     served on (1, 1, 2) through ``ServeEngine(mesh=)`` (tokens equal on
     both ranks, wkv6_step once a layer per decode call) and prefilled on
     the scan path (wkv6_fwd once a layer; the flash kernel once a group
     past the window), their f32 tokens one rank's and bf16 logits as
     close to f32 as one rank's at 4 and 7 layers; whisper-small uncut
     through a ``serve_fn`` chain on (1, 1, 2) (the steps' cross-attention
     on the flash kernel), checked alike; f32 gradients on (1, 2, 2) of
     rwkv6 at 4 layers, zamba2 at 7 and whisper uncut, loss within 1e-6
     relative and every leaf within 1e-4 max|g| of one rank (or, past
     that, within twice one rank's error from the f64 gradient); whisper's
     compressed step on (2, 1, 2), params bitwise across pods;
  4. time each kernel (CUDA events, median of 10) beside its bound and
     its plain version (the flash kernels also beside
     ``scaled_dot_product_attention``, and the backward beside its
     backward, timed here only, the moe and llava paths' shapes among
     them; the f32 kernels' bound is their 3xTF32
     work on the tensor cores; the bf16 forward at kv_chunk 1024 beside
     its 128-key tiling; the wkv6 kernels at rwkv6's train microbatch and
     decode step beside their bound, no library call computing the
     recurrence; the flash kernels also at zamba2's windowed shape, the
     bound counting the in-window causal pairs and SDPA given the band as
     a boolean mask), measure the
     card's device-to-device copy rate, and split each round's wall time
     by phase.

Prints the card's name and power limit, a ``kernels`` JSON line, and as
its last line ``{"ok": true, "device": {...}}``; the full report goes to
``build/chip_smoke.json``.  Needs one CUDA card; exits non-zero with no
result line otherwise.  Run from the repository root:
``python3 chip_smoke.py``.
"""
from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

D_FULL = 463_987_712  # sum of qwen1.5-0.5b's parameter sizes
N_CLIENTS = 4
BITS = 8
CLIP = 1.0
ROUNDS = 1
KS_SAMPLE = 1 << 20
DECODE_ATOL = 1e-6
SIGMA_IND = 0.25  # individual_shifted: per-client sigma 0.25 * sqrt(4)
D_DIRECT = 1 << 24  # the individual_direct round
DP_W = 0.05  # dither_pack step
# elements per chunk when a plain version runs beside a kernel at full
# width (its f64 fused multiply-adds would not fit the card at once)
PLAIN_CHUNK = 1 << 24
CSRC = "src/repro_torch/kernels/csrc/"
KERNELS = {  # name: (source, replaced TPU kernel)
    "fused_encode": ("fused_agg.cu", "src/repro/kernels/fused_agg.py:89"),
    "fused_decode": ("fused_agg.cu", "src/repro/kernels/fused_agg.py:115"),
    "dither_pack": ("dither_pack.cu",
                    "src/repro/kernels/dither_pack.py:56"),
    "unpack_decode": ("dither_pack.cu",
                      "src/repro/kernels/dither_pack.py:75"),
    "layered_encode": ("layered.cu",
                       "src/repro/kernels/layered_encode.py:67"),
    "layered_decode": ("layered.cu",
                       "src/repro/kernels/layered_encode.py:72"),
    "flash_attention_sm90": ("flash_attention_sm90.cu",
                             "src/repro/kernels/flash_attention.py:77"),
    "flash_attention_f32": ("flash_attention_f32_sm90.cu",
                            "src/repro/kernels/flash_attention.py:77"),
    "flash_attention_bwd_sm90": ("flash_attention_bwd_sm90.cu",
                                 "none: the JAX package differentiates "
                                 "src/repro/models/attention.py:26 by "
                                 "autodiff"),
    "flash_attention_bwd_f32_sm90": ("flash_attention_bwd_f32_sm90.cu",
                                     "none: the JAX package differentiates "
                                     "src/repro/models/attention.py:26 by "
                                     "autodiff"),
    "wkv6_fwd": ("wkv6.cu", "none: src/repro/models/rwkv6.py:54 _wkv_scan "
                            "is compiled lax.scan"),
    "wkv6_bwd": ("wkv6.cu", "none: src/repro/models/rwkv6.py:54 _wkv_scan "
                            "is compiled lax.scan"),
    "wkv6_step": ("wkv6.cu", "none: src/repro/models/rwkv6.py:113 the "
                             "decode step is jnp code"),
}
# device-memory rate (bytes/s) and f32 rate outside the tensor cores
# (flop/s) by card name, from NVIDIA's data sheets
_RATES = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
          ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12))
# f32 operations per coordinate of each kernel, counted from its source
# (a fused multiply-add counts 2; the layered kernels' log polynomial and
# square root dominate theirs)
FLOPS_PER_COORD = {"fused_encode": 5, "fused_decode": 3, "dither_pack": 5,
                   "unpack_decode": 2, "layered_encode": 74,
                   "layered_decode": 76}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(*args) -> None:
    print(*args, flush=True)


# dense bf16 tensor-core rate (flop/s) by card name, NVIDIA's data sheets
_BF16_RATES = (("H100 PCIe", 756e12), ("H100 NVL", 835e12),
               ("H200", 989e12), ("H100", 989e12))


# dense TF32 tensor-core rate (flop/s) by card name, NVIDIA's data sheets
# (half their "with sparsity" figures)
_TF32_RATES = (("H100 PCIe", 378e12), ("H100 NVL", 417.5e12),
               ("H200", 495e12), ("H100", 495e12))


def _rate(table, kind: str, name: str) -> float:
    for tag, flops in table:
        if tag in name:
            return flops
    raise RuntimeError(f"no {kind} rate known for card {name!r}: add it "
                       f"to _{kind.upper()}_RATES")


def bf16_rate(name: str) -> float:
    return _rate(_BF16_RATES, "bf16", name)


def tf32_rate(name: str) -> float:
    return _rate(_TF32_RATES, "tf32", name)


def card_rates(name: str) -> tuple:
    """(bytes/s, f32 flop/s) of the card named ``name``."""
    for tag, mem, flops in _RATES:
        if tag in name:
            return mem, flops
    raise RuntimeError(f"no rates known for card {name!r}: add them to "
                       f"_RATES")


def timed_row(name: str, kind: str, kern, plain, nbytes: int, coords: int,
              rates: tuple) -> dict:
    """Median kernel time (CUDA events, 10 runs) and plain-version time
    (3 runs) beside the bound: the larger of the bytes (each input read
    once, each output written once) over the memory rate and the f32
    operations over the f32 rate.  ``rates`` = (data-sheet bytes/s, f32
    flop/s, measured copy bytes/s); the bytes also go over the measured
    copy rate."""
    ms = cuda_ms(kern)
    plain_ms = cuda_ms(plain, reps=3)
    bytes_ms = nbytes / rates[0] * 1e3
    ops_ms = FLOPS_PER_COORD[name] * coords / rates[1] * 1e3
    bound = max(bytes_ms, ops_ms)
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    copy_ms = nbytes / rates[2] * 1e3
    log(f"{name} ({kind}): {ms:.4f} ms, bound {bound:.4f} ms by {by} "
        f"({nbytes / 1e9:.3f} GB at {rates[0] / 1e12:.2f} TB/s; "
        f"operations {ops_ms:.4f} ms), {100 * bound / ms:.1f}% of it, "
        f"{100 * copy_ms / ms:.1f}% of the measured copy rate; plain "
        f"{plain_ms:.4f} ms")
    return {"name": name, "config": kind, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "ops_ms": ops_ms, "copy_ms": copy_ms}


def cuda_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    import torch

    fn()  # warm up
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def ks_stat(samples, sigma: float) -> float:
    import numpy as np

    s = np.sort(np.asarray(samples, np.float64))
    n = len(s)
    erf = np.frompyfunc(math.erf, 1, 1)
    c = 0.5 * (1.0 + erf(s / (sigma * math.sqrt(2.0))).astype(np.float64))
    return max(float(np.max(np.abs(c - np.arange(1, n + 1) / n))),
               float(np.max(np.abs(c - np.arange(n) / n))))


# ------------------------------------------------------------- phase 2
# field clamp per width: the main path's (b = 8, n = 4), and the JAX
# package's kernel sweep for the others (tests/test_kernels.py)
M_MAX = {8: 31, 4: 3, 16: 4000, 24: 80000}


def kernel_inputs(d, bits, gen, device):
    """x ~ U(-1, 1), s ~ U(-1/2, 1/2), a scalar step and a per-coordinate
    one around 1/(m_max - 1), and an offset, all of ``d`` coordinates."""
    import torch

    m_max = M_MAX[bits]
    x = torch.rand(d, generator=gen, device=device) * 2.0 - 1.0
    s = torch.rand(d, generator=gen, device=device) - 0.5
    base = 1.0 / (m_max - 1)
    step = base * (torch.rand(d, generator=gen, device=device) + 0.5)
    offset = torch.rand(d, generator=gen, device=device) * 0.25
    return m_max, x, s, base, step, offset


def compare_kernels(device, gen) -> dict:
    """Each kernel's wrapper against its plain version, same inputs."""
    import torch

    from repro_torch.kernels import fused_agg as fg
    from repro_torch.kernels import ops, ref

    worst = {"fused_encode": 0.0, "fused_decode": 0.0}
    cases = 0
    for bits in (BITS, 4, 16, 24):
        g = max(32 // bits, 1)
        m_max, x, s, base, step, offset = kernel_inputs(D_FULL, bits, gen,
                                                       device)
        xr, sr = ops._pad_rows(x, g), ops._pad_rows(s, g)
        tr, orr = ops._pad_rows(step, g, 1.0), ops._pad_rows(offset, g)
        for st in (base, tr):
            w_k = fg.fused_encode(xr, sr, st, bits, m_max)
            w_p = ref.fused_encode_ref(xr, sr, st, bits, m_max)
            diff = int((w_k != w_p).sum())
            check(diff == 0, f"encode b={bits} words differ in {diff} lanes")
            # r = 1 summed message: s_eff = s + m_max
            se = sr + float(m_max)
            for off in (None, orr):
                y_k = fg.fused_decode(w_k, se, st, off, bits)
                y_p = ref.fused_decode_ref(w_p, se, st, off, bits)
                err = float((y_k - y_p).abs().max())
                check(err <= DECODE_ATOL, f"decode b={bits} err {err}")
                worst["fused_decode"] = max(worst["fused_decode"], err)
                cases += 1
                del y_k, y_p
            del w_k, w_p, se
        del x, s, step, offset, xr, sr, tr, orr
        torch.cuda.empty_cache()
        log(f"kernels b={bits}: words bitwise, decode within {DECODE_ATOL}")
    # one ragged size through ops, whose row padding the kernels see
    shape = (1000, 37)
    for bits in (BITS, 4, 16, 24):
        g = max(32 // bits, 1)
        m_max, x, s, base, step, offset = (
            t.reshape(shape) if isinstance(t, torch.Tensor) else t
            for t in kernel_inputs(math.prod(shape), bits, gen, device))
        se = s + float(m_max)
        for st in (base, step):
            st_r = st if isinstance(st, float) else ops._pad_rows(st, g, 1.0)
            w_k = ops.fused_pack_encode(x, s, st, bits, m_max)
            w_p = ref.fused_encode_ref(ops._pad_rows(x, g),
                                       ops._pad_rows(s, g), st_r, bits,
                                       m_max)
            check(bool((w_k == w_p).all()), f"ragged encode b={bits}")
            y_k = ops.fused_unpack_decode(w_k, se, st, offset, bits, shape)
            y_p = ref.fused_decode_ref(w_p, ops._pad_rows(se, g), st_r,
                                       ops._pad_rows(offset, g), bits)
            y_p = y_p.reshape(-1)[: math.prod(shape)].reshape(shape)
            err = float((y_k - y_p).abs().max())
            check(err <= DECODE_ATOL, f"ragged decode b={bits} err {err}")
            worst["fused_decode"] = max(worst["fused_decode"], err)
    log(f"kernels ragged (1000, 37): words bitwise, decode within "
        f"{DECODE_ATOL}; {cases} full-width decode cases")
    return worst


def _row_chunks(n_rows: int, fields: int = 1):
    """Row slices of PLAIN_CHUNK coordinates (rows of fields * 128)."""
    step = max(PLAIN_CHUNK // (128 * fields), 1)
    return [slice(r, r + step) for r in range(0, n_rows, step)]


def compare_layered(device, gen) -> dict:
    """The layered kernels against their plain versions at full width
    (the plain version in chunks of PLAIN_CHUNK), at sigma_client 0.5 (the
    individual_shifted round: 0.25 * sqrt(4)) and 0.01, and on a ragged
    size through ops.  Layers span (0, peak)."""
    import torch

    from repro_torch.kernels import layered_encode as le
    from repro_torch.kernels import ops, ref

    worst = {"layered_encode": 0.0, "layered_decode": 0.0}
    for sigma in (2 * SIGMA_IND, 0.01):
        peak = 1.0 / (sigma * math.sqrt(2.0 * math.pi))
        x = torch.randn(D_FULL, generator=gen, device=device) * (3 * sigma)
        u = torch.rand(D_FULL, generator=gen, device=device)
        layer = torch.rand(D_FULL, generator=gen, device=device) * peak
        xr, ur, lr = (t.view(-1, 128) for t in (x, u, layer))
        m = le.layered_encode(xr, ur, lr, sigma)
        y = le.layered_decode(m, ur, lr, sigma)
        for sl in _row_chunks(xr.shape[0]):
            mp = ref.layered_encode_ref(xr[sl], ur[sl], lr[sl], sigma)
            diff = int((m[sl] != mp).sum())
            check(diff == 0, f"layered_encode sigma={sigma}: {diff} differ")
            yp = ref.layered_decode_ref(m[sl], ur[sl], lr[sl], sigma)
            err = float((y[sl] - yp).abs().max())
            check(err <= DECODE_ATOL, f"layered_decode sigma={sigma} {err}")
            worst["layered_decode"] = max(worst["layered_decode"], err)
        del x, u, layer, xr, ur, lr, m, y
        torch.cuda.empty_cache()
        log(f"layered sigma={sigma}: messages bitwise, decode within "
            f"{DECODE_ATOL}")
    shape = (1000, 37)
    x = torch.randn(shape, generator=gen, device=device) * 1.5
    u = torch.rand(shape, generator=gen, device=device)
    layer = torch.rand(shape, generator=gen, device=device) * 0.79
    m = ops.layered_encode(x, u, layer, 0.5)
    rows = [ops._rows(t) for t in (x, u, layer)]
    mp = ref.layered_encode_ref(*rows, 0.5).reshape(-1)[:37000]
    check(bool((m.reshape(-1) == mp).all()), "ragged layered_encode")
    y = ops.layered_decode(m, u, layer, 0.5)
    yp = ref.layered_decode_ref(ops._rows(m), rows[1], rows[2], 0.5)
    err = float((y.reshape(-1) - yp.reshape(-1)[:37000]).abs().max())
    check(err <= DECODE_ATOL, f"ragged layered_decode {err}")
    log("layered ragged (1000, 37): messages bitwise, decode within "
        f"{DECODE_ATOL}")
    return worst


def compare_dither_pack(device, gen) -> dict:
    """The signed dither_pack kernels against their plain versions at full
    width for b in {4, 8, 16}, w = DP_W, and on a ragged size."""
    import torch

    from repro_torch.kernels import dither_pack as dp
    from repro_torch.kernels import ops, ref

    worst = {"dither_pack": 0.0, "unpack_decode": 0.0}
    for bits in (8, 4, 16):
        g = 32 // bits
        x = torch.randn(D_FULL, generator=gen, device=device) * 0.1
        s = torch.rand(D_FULL, generator=gen, device=device) - 0.5
        xr, sr = ops._pad_rows(x, g), ops._pad_rows(s, g)
        words = dp.dither_pack(xr, sr, DP_W, bits)
        y = dp.unpack_decode(words, sr, DP_W, bits)
        for sl in _row_chunks(xr.shape[0], g):
            wp = ref.dither_pack_ref(xr[sl], sr[sl], DP_W, bits)
            diff = int((words[sl] != wp).sum())
            check(diff == 0, f"dither_pack b={bits}: {diff} words differ")
            yp = ref.unpack_decode_ref(words[sl], sr[sl], DP_W, bits)
            err = float((y[sl] - yp).abs().max())
            check(err == 0.0, f"unpack_decode b={bits}: {err}")
        del x, s, xr, sr, words, y
        torch.cuda.empty_cache()
        log(f"dither_pack b={bits}: words bitwise, decode equal")
    shape = (1000, 37)
    x = torch.randn(shape, generator=gen, device=device) * 0.2
    s = torch.rand(shape, generator=gen, device=device) - 0.5
    for bits in (4, 8, 16):
        g = 32 // bits
        words, _ = ops.dither_pack_encode(x, s, DP_W, bits=bits)
        wp = ref.dither_pack_ref(ops._pad_rows(x, g), ops._pad_rows(s, g),
                                 DP_W, bits)
        check(bool((words == wp).all()), f"ragged dither_pack b={bits}")
        y = ops.dither_unpack_decode(words, s, DP_W, bits, shape)
        yp = ref.unpack_decode_ref(wp, ops._pad_rows(s, g), DP_W, bits)
        check(bool((y.reshape(-1) == yp.reshape(-1)[:37000]).all()),
              f"ragged unpack_decode b={bits}")
    log("dither_pack ragged (1000, 37): words bitwise, decode equal")
    return worst


# flash attention cases: (B, T, S, H, HK, D, causal); the serve path's
# prefill shapes first (qwen1.5-0.5b: 16 heads of 64; the serve phase's
# prompts run 256-2048 tokens: one 1024-key span below 1024, a ragged
# second span above), the train path's microbatches (bf16 4 x 2048, f32
# 2 x 2048: two spans), then GQA at D = 128 (qwen3-32b's 64 query and 8
# KV heads among them), non-causal with S != T, a ragged causal size, and
# causal GQA with T > S (queries past the last key see every key); the
# moe and llava paths' GQA heads of 128: phi3.5-moe's and llava's 32 / 8
# (a prefill, and the moe train microbatch 2 x 2048) and dbrx's 48 / 8
# (a group of 6 query heads); the dense serve prefills' GQA groups of 12
# (starcoder2-3b: 24 / 2 heads of 128) and 3 (minitron-4b: 24 / 8)
FLASH_CASES = (
    (1, 2048, 2048, 16, 16, 64, True),
    (1, 8192, 8192, 16, 16, 64, True),
    (1, 1500, 1500, 16, 16, 64, True),
    (1, 700, 700, 16, 16, 64, True),
    (4, 2048, 2048, 16, 16, 64, True),
    (2, 2048, 2048, 16, 16, 64, True),
    (2, 1024, 1024, 16, 2, 128, True),
    (1, 4096, 4096, 64, 8, 128, True),
    (1, 2048, 2048, 32, 8, 128, True),
    (2, 2048, 2048, 32, 8, 128, True),
    (1, 2048, 2048, 48, 8, 128, True),
    (1, 2048, 2048, 24, 2, 128, True),
    (1, 2048, 2048, 24, 8, 128, True),
    (2, 64, 192, 4, 4, 16, False),
    (1, 1000, 1000, 4, 4, 32, True),
    (2, 300, 130, 8, 2, 64, True),
)
# the mesh paths' per-rank shapes (phase 3q), from their own generator
# (MESH_SEED): qwen1.5-0.5b's 8 / 8 heads of 64 on each of 2 model ranks
# (the train microbatch and the serve prefill) and starcoder2-3b's 6 query
# heads on each of 4 model ranks with the one KV head they read
MESH_SEED = 41
FLASH_MESH_CASES = (
    (1, 2048, 2048, 8, 8, 64, True),
    (1, 2048, 2048, 6, 1, 128, True),
)
BWD_MESH_CASES = (
    (1, 2048, 2048, 8, 8, 64, True),
)
# the moe kind's per-rank attention on the mesh (phase 3r and
# tools/torch_moe_mesh_check.py), from their own generator
# (MOE_MESH_SEED), drawn after the cases above: phi3.5-moe's 32 / 8
# heads of 128 over 2 and 4 model ranks (16 / 4, 8 / 2) and dbrx's 48 /
# 8 (24 / 4, 12 / 2); the backward at phi3.5-moe's (1, 1, 2) train shape
MOE_MESH_SEED = 47
FLASH_MOE_MESH_CASES = (
    (1, 2048, 2048, 16, 4, 128, True),
    (1, 2048, 2048, 8, 2, 128, True),
    (1, 2048, 2048, 24, 4, 128, True),
    (1, 2048, 2048, 12, 2, 128, True),
)
BWD_MOE_MESH_CASES = (
    (1, 2048, 2048, 16, 4, 128, True),
)
# the windowed and head-dim-112 cases, drawn from their own generator
# (WINDOW_SEED) after the cases above, whose inputs stay what they were
# before these cases were added: zamba2-7b's shared attention (32 / 32 heads of 112, window
# 4096) over its 8192-token prefill; a window not a multiple of 128 and
# smaller than the 1024-key span; a window >= T (the bits of no window,
# held in compare_flash); a window at D = 64 with a GQA group of 4; D =
# 112 without a window
WINDOW_SEED = 23
FLASH_WINDOW_CASES = (
    (1, 8192, 8192, 32, 32, 112, True, 4096),
    (1, 3000, 3000, 8, 8, 112, True, 1000),
    (1, 2048, 2048, 8, 8, 112, True, 4096),
    (1, 2048, 2048, 16, 4, 64, True, 700),
    (1, 1024, 1024, 8, 8, 112, True),
)
# whisper-small's non-causal shapes (12 / 12 heads of 64), drawn from
# their own generator (WHISPER_SEED) after the cases above: the encoder's
# self-attention over its 1500 frames (two 1024-key spans, the second a
# ragged 476), the decoder's cross-attention of 448 tokens over them, and
# the decode step's one query over them, at the serve path's 8 rows
WHISPER_SEED = 31
FLASH_WHISPER_CASES = (
    (8, 1500, 1500, 12, 12, 64, False),
    (8, 448, 1500, 12, 12, 64, False),
    (8, 1, 1500, 12, 12, 64, False),
)
# the per-rank shapes of rwkv6, zamba2 and whisper on a model axis of 2
# (phase 3s), from their own generator (FAMILY_MESH_SEED), drawn after
# every case set above (the wkv6 cases last): zamba2-7b's shared
# attention at 16 / 16 heads of 112 (window 4096) over 3s's 5120-token
# scan prefill and a 2048-token gradient; whisper-small's 6 / 6
# heads of 64: the encoder over its 1500 frames, the decoder's
# cross-attention of 448 tokens over them at the serve path's 8 rows, and
# the decode step's one query
FAMILY_MESH_SEED = 53
FLASH_FAMILY_MESH_CASES = (
    (1, 5120, 5120, 16, 16, 112, True, 4096),
    (1, 1500, 1500, 6, 6, 64, False),
    (8, 448, 1500, 6, 6, 64, False),
    (8, 1, 1500, 6, 6, 64, False),
)
BWD_FAMILY_MESH_CASES = (
    (1, 2048, 2048, 16, 16, 112, True, 4096),
    (1, 1500, 1500, 6, 6, 64, False),
    (8, 448, 1500, 6, 6, 64, False),
)
FLASH_ATOL = 2e-5  # the reference's own bar (tests/test_kernels.py)
# bf16: a p that rounds to the other bf16 neighbour moves an output by at
# most 2^-9 max|v|; the kernel and its plain version round P against the
# same running max (both at the configs' kv_chunk), so nearly all outputs
# agree to one ulp
BF16_P_BAR = 2.0 ** -9
BF16_SHARE = 0.99
# the model configs' kv_chunk, which the serve and train paths pass: P
# rounded against the running max of 1024-key spans (the JAX model's
# tiling), two passes over each span's 128-key tiles; every bf16 case is
# held at it
CONFIG_KV_CHUNK = 1024
# the row statistic lse = m + log(l) (f32, both dtypes) against the plain
# version's: within 2e-5 max(1, |lse|) (f32 sums of l in another order)
LSE_REL = 2e-5


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (2^(e - 8) for |x| = m 2^e,
    m in [0.5, 1))."""
    import torch

    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def case_window(case) -> int:
    """A flash case's sliding window: its eighth entry, 0 (none) if it
    has none."""
    return case[7] if len(case) > 7 else 0


def flash_inputs(case, dtype, gen, device):
    import torch

    B, T, S, H, HK, D = case[:6]
    return tuple(torch.randn(shape, generator=gen, device=device).to(dtype)
                 for shape in ((B, T, H, D), (B, S, HK, D), (B, S, HK, D)))


def check_bf16_flash(got, want, v, label: str) -> dict:
    """The bf16 bars: every output within one ulp of the plain result +
    BF16_P_BAR max|v|, at least BF16_SHARE within one ulp + FLASH_ATOL."""
    diff = (got.float() - want.float()).abs()
    vmax = float(v.float().abs().max())
    over = int((diff > bf16_ulp(want) + BF16_P_BAR * vmax).sum())
    share = float((diff <= bf16_ulp(want) + FLASH_ATOL).float().mean())
    unequal = float((got != want).float().mean())
    err = float(diff.max())
    check(over == 0 and share >= BF16_SHARE,
          f"{label}: {over} outputs over one ulp + 2^-9 max|v|, "
          f"{share:.6f} within one ulp + 2e-5, max |diff| {err}")
    log(f"{label}: max |diff| {err:.3g} (bar one ulp + 2^-9 * {vmax:.3g}), "
        f"{100 * share:.4f}% within one ulp + 2e-5 (bar "
        f"{100 * BF16_SHARE:.0f}%), {100 * unequal:.2f}% not equal")
    return {"max_abs_err": err, "share_within_ulp": share, "vmax": vmax,
            "unequal": unequal}


def compare_flash(device, gen, shapes=FLASH_CASES) -> dict:
    """Each flash kernel against its plain version at each of ``shapes``
    (FLASH_CASES; FLASH_WINDOW_CASES), as the paths call it: bf16
    (flash_attention_sm90, at CONFIG_KV_CHUNK) against ``flash_attention_bf16_ref`` at the same
    chunk under ``check_bf16_flash``'s bars; f32 (flash_attention_f32)
    against ``flash_attention_ref`` within FLASH_ATOL (not at T >= 4096
    without a window, whose f32 plain version is slow).  Each kernel runs
    without lse (the serve path's call) and with it (the train path's): the
    two outputs are bitwise equal, and the lse is within LSE_REL of the
    plain version's.  A case's window (``case_window``) goes to both; a
    window >= T gives the kernel's bits without one."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    worst = {"flash_attention_sm90": 0.0, "flash_attention_f32": 0.0}
    lse_worst = 0.0
    cases = []
    for case in shapes:
        causal, window = case[6], case_window(case)
        for dtype in (torch.bfloat16, torch.float32):
            if case[1] >= 4096 and dtype == torch.float32 and not window:
                continue
            bf16 = dtype == torch.bfloat16
            q, k, v = flash_inputs(case, dtype, gen, device)
            got = fa.flash_attention(q, k, v, causal, kv_tile=CONFIG_KV_CHUNK,
                                     window=window)
            got_l, lse = fa.flash_attention(q, k, v, causal,
                                            kv_tile=CONFIG_KV_CHUNK,
                                            with_lse=True, window=window)
            if bf16:
                want, want_lse = ref.flash_attention_bf16_ref(
                    q, k, v, causal, kv_tile=CONFIG_KV_CHUNK,
                    return_lse=True, window=window)
            else:
                want, want_lse = ref.flash_attention_ref(
                    q, k, v, causal, return_lse=True, window=window)
            torch.cuda.synchronize()
            name = "flash_attention_sm90" if bf16 else "flash_attention_f32"
            label = (f"{name} {case}" + (f" kv_chunk {CONFIG_KV_CHUNK}"
                                         if bf16 else ""))
            if window >= case[1]:
                check(torch.equal(got, fa.flash_attention(
                    q, k, v, causal, kv_tile=CONFIG_KV_CHUNK)),
                    f"{label}: a window >= T changed the output")
            check(got.dtype == dtype and got.shape == q.shape,
                  f"{label}: {got.dtype} {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), f"{label}: non-finite")
            check(torch.equal(got, got_l), f"{label}: the output with lse "
                                           f"differs from the one without")
            lse_err = float(((lse - want_lse).abs()
                             / want_lse.abs().clamp_min(1.0)).max())
            check(lse.shape == want_lse.shape and lse_err <= LSE_REL,
                  f"{label}: lse {tuple(lse.shape)}, error {lse_err} "
                  f"max(1, |lse|) > {LSE_REL}")
            lse_worst = max(lse_worst, lse_err)
            row = {"case": list(case), "kernel": name,
                   "lse_rel_err": lse_err}
            if bf16:
                row.update(kv_chunk=CONFIG_KV_CHUNK,
                           **check_bf16_flash(got, want, v, label))
            else:
                err = float((got - want).abs().max())
                check(err <= FLASH_ATOL, f"{label}: max |diff| {err} > 2e-5")
                log(f"{label}: max |diff| {err:.3g} (bar 2e-5)")
                row["max_abs_err"] = err
            log(f"{label}: lse within {lse_err:.3g} max(1, |lse|) (bar "
                f"{LSE_REL:g}); the output with lse bitwise the one without")
            worst[name] = max(worst[name], row["max_abs_err"])
            cases.append(row)
            del q, k, v, got, got_l, lse, want, want_lse
    torch.cuda.empty_cache()
    check(len(cases) == sum(2 - (c[1] >= 4096 and not case_window(c))
                            for c in shapes),
          f"compare_flash ran {len(cases)} cases of {len(shapes)} shapes")
    return {**worst, "lse_rel_err": lse_worst, "flash_cases": cases}


# flash-attention backward cases: (B, T, S, H, HK, D, causal): the train
# path's microbatches (qwen1.5-0.5b's 16 heads of 64 over 4 x 2048 tokens
# in bf16, 2 x 2048 in f32), the longest serve prompt's shape, qwen3-32b's
# GQA heads of 128, the moe and llava paths' (32 / 8 and 48 / 8 of 128;
# 2 x 2048 the moe train microbatch), starcoder2-3b's 24 / 2 and
# minitron-4b's 24 / 8 of 128, a ragged causal and a non-causal one
BWD_CASES = (
    (4, 2048, 2048, 16, 16, 64, True),
    (2, 2048, 2048, 16, 16, 64, True),
    (1, 8192, 8192, 16, 16, 64, True),
    (1, 4096, 4096, 64, 8, 128, True),
    (1, 2048, 2048, 32, 8, 128, True),
    (2, 2048, 2048, 32, 8, 128, True),
    (1, 2048, 2048, 48, 8, 128, True),
    (1, 2048, 2048, 24, 2, 128, True),
    (1, 2048, 2048, 24, 8, 128, True),
    (2, 300, 130, 8, 2, 64, True),
    (2, 64, 192, 4, 4, 16, False),
)
# the windowed cases of FLASH_WINDOW_CASES (their own generator):
# zamba2-7b's train microbatch (1 x 8192, 32 / 32 heads of 112, window
# 4096), a window of 1000, one >= T (the bits of no window), D = 64 GQA,
# D = 112 without a window
BWD_WINDOW_CASES = (
    (1, 8192, 8192, 32, 32, 112, True, 4096),
    (1, 3000, 3000, 8, 8, 112, True, 1000),
    (1, 2048, 2048, 8, 8, 112, True, 4096),
    (1, 2048, 2048, 16, 4, 64, True, 700),
    (1, 1024, 1024, 8, 8, 112, True),
)
# whisper-small's backward at its train microbatch (8 rows): the encoder
# (1500 x 1500) and the decoder's cross-attention (448 x 1500), both
# non-causal (WHISPER_SEED's generator, after FLASH_WHISPER_CASES)
BWD_WHISPER_CASES = (
    (8, 1500, 1500, 12, 12, 64, False),
    (8, 448, 1500, 12, 12, 64, False),
)
# the bf16 backward's long sums, from their own generator (DRIFT_SEED),
# drawn after every case above: a key of qwen3-32b's GQA heads (64 / 8 of
# 128) sums 8 heads x T queries in dK and dV, where one running wgmma
# accumulator drifted past the bar; three draws at T = 4096, one at T =
# 8192 (65,536 query terms a key), and whisper's encoder (non-causal).
# bf16 only
DRIFT_SEED = 37
BWD_DRIFT_CASES = (
    (1, 4096, 4096, 64, 8, 128, True),
    (1, 4096, 4096, 64, 8, 128, True),
    (1, 4096, 4096, 64, 8, 128, True),
    (1, 8192, 8192, 64, 8, 128, True),
    (8, 1500, 1500, 12, 12, 64, False),
)
# the f32 forward's long sums, from their own generator (FWD_DRIFT_SEED),
# drawn after every case set above: the kernel adds each KV tile's P V
# into one running wgmma accumulator, the pattern that drifted in the
# bf16 backward's dK / dV; T = 8192 at 16 heads of 64 and T = 4096 at
# qwen3-32b's 64 / 8 heads of 128 (three draws each), T = 16384 and T =
# 8192 at 64 / 8 of 128 (one draw each).  f32, causal; the output within
# FLASH_ATOL of the plain version's arithmetic (``f32_attention_rows``)
FWD_DRIFT_SEED = 43
FWD_DRIFT_CASES = (
    (1, 8192, 8192, 16, 16, 64, True),
    (1, 8192, 8192, 16, 16, 64, True),
    (1, 8192, 8192, 16, 16, 64, True),
    (1, 4096, 4096, 64, 8, 128, True),
    (1, 4096, 4096, 64, 8, 128, True),
    (1, 4096, 4096, 64, 8, 128, True),
    (1, 16384, 16384, 16, 16, 64, True),
    (1, 8192, 8192, 64, 8, 128, True),
)
# f32: within 2e-5 max|g| (the forward's bar, scaled by the gradient).
# bf16: dV sums bf16(P) dO, and a p that rounds to the other bf16
# neighbour moves dV[j] by at most 2^-9 P[i, j] |dO[i]|, so every dV
# output lies within one ulp + 2^-9 max|dO| max_j sum_i P[i, j]; dQ and dK
# take the f32 P and are held within one ulp + 2e-5 max|g|; and at least
# 99% of all outputs within one ulp + 2e-5 max|g|
BWD_REL = 2e-5


def bwd_inputs(case, dtype, gen, device):
    """q, k, v, the kernel's output and lse (at the configs' kv_chunk, as
    the train path calls it), and dO for ``case``."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    B, T, S, H, HK, D, causal = case[:7]
    q, k, v = flash_inputs(case, dtype, gen, device)
    do = torch.randn((B, T, H, D), generator=gen, device=device).to(dtype)
    o, lse = fa.flash_attention(q, k, v, causal, kv_tile=CONFIG_KV_CHUNK,
                                with_lse=True, window=case_window(case))
    return q, k, v, o, lse, do


def p_colsum_max(q, k, lse, causal, window: int = 0) -> float:
    """max over keys j of sum_i P[i, j] (P = exp(S - lse), as the plain
    backward forms it), one tile of keys at a time."""
    import torch

    from repro_torch.kernels import ref

    B, T, H, D = q.shape
    g = H // k.shape[2]
    f32 = torch.float32
    if q.dtype == torch.bfloat16:
        qs = ref.scale_q_bf16(q).to(f32)
    else:
        qs = q.to(f32) * D ** -0.5
    qs = qs.permute(0, 2, 1, 3)
    kk = k.to(f32).repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    best = 0.0
    for k0 in range(0, kk.shape[2], 256):
        p = torch.exp(qs @ kk[:, :, k0:k0 + 256].transpose(-1, -2)
                      - lse[..., None])
        keep = ref._keep(T, kk.shape[2], k0, p.shape[-1], causal, window,
                         q.device)
        if keep is not None:
            p = torch.where(keep, p, 0.0)
        best = max(best, float(p.sum(dim=2).max()))
    return best


def compare_flash_bwd(device, gen, shapes=BWD_CASES, dtypes=None) -> dict:
    """The backward kernels against ``ref.flash_attention_bwd_ref`` on
    the card at ``shapes`` (BWD_CASES; BWD_WINDOW_CASES,
    BWD_WHISPER_CASES; BWD_DRIFT_CASES in bf16 alone), in ``dtypes``
    (default both): bf16 (flash_attention_bwd_sm90) and f32
    (flash_attention_bwd_f32_sm90), from the forward kernel's output and
    lse (held against the plain version's at the same shapes by
    ``compare_flash``); also run twice for determinism (bitwise equal).
    A case's window goes to the forward and both backwards; a window >= T
    gives the bits of none.  Each bf16 output's worst diff over its bar
    is logged (``*_bar_ratio``: at most 1 passes)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    worst = {name: 0.0 for name in fa.BWD_KERNELS.values()}
    dtypes = dtypes or (torch.bfloat16, torch.float32)
    rows = []
    for case in shapes:
        causal, window = case[6], case_window(case)
        for dtype in dtypes:
            kname = fa.BWD_KERNELS[dtype]
            q, k, v, o, lse, do = bwd_inputs(case, dtype, gen, device)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                         window=window)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                           window=window)
            want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                               window=window)
            if window >= case[1]:
                none = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
                check(all(torch.equal(a, b) for a, b in zip(got, none)),
                      f"bwd {case} {dtype}: a window >= T changed the "
                      f"gradient")
                del none
            torch.cuda.synchronize()
            bf16 = dtype == torch.bfloat16
            row = {"case": list(case), "dtype": str(dtype),
                   "kernel": kname}
            if bf16:
                row["p_colsum_max"] = p_colsum_max(q, k, lse, causal,
                                                   window)
            shares = []
            for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
                check(a.dtype == dtype and a.shape == b.shape,
                      f"bwd {case} {name}: {a.dtype} {tuple(a.shape)}")
                check(bool(torch.isfinite(a).all()),
                      f"bwd {case} {name}: non-finite")
                check(torch.equal(a, c), f"bwd {case} {name}: two runs "
                                         f"differ")
                diff = (a.float() - b.float()).abs()
                gmax = float(b.float().abs().max())
                err = float(diff.max())
                row[f"{name}_max_abs_err"] = err
                row[f"{name}_rel"] = err / max(gmax, 1e-30)
                worst[kname] = max(worst[kname], err)
                if bf16:
                    ulp = bf16_ulp(b)
                    slack = BWD_REL * gmax
                    if name == "dv":
                        slack += (BF16_P_BAR * float(do.float().abs().max())
                                  * row["p_colsum_max"])
                    over = int((diff > ulp + slack).sum())
                    share = float((diff <= ulp + BWD_REL * gmax).float()
                                  .mean())
                    shares.append(share)
                    row[f"{name}_share_within_ulp"] = share
                    row[f"{name}_over"] = over
                    row[f"{name}_bar_ratio"] = float(
                        (diff / (ulp + slack)).max())
                    check(over == 0, f"bwd {case} bf16 {name}: {over} "
                                     f"outputs over the bar, max {err}")
                else:
                    check(err <= BWD_REL * gmax, f"bwd {case} f32 {name}: "
                          f"{err} > 2e-5 * {gmax}")
                del diff
            if bf16:
                check(min(shares) >= BF16_SHARE,
                      f"bwd {case} bf16: shares {shares}")
            log(f"{kname} {case} {dtype}: " + ", ".join(
                f"{n} max |diff| {row[n + '_max_abs_err']:.3g} "
                f"({row[n + '_rel']:.3g} max|g|)"
                + (f", {100 * row[n + '_share_within_ulp']:.4f}% within "
                   f"one ulp, worst {row[n + '_bar_ratio']:.4f} of its bar"
                   if bf16 else "")
                for n in ("dq", "dk", "dv")) + "; two runs bitwise equal")
            rows.append(row)
            del q, k, v, o, lse, do, got, again, want
    torch.cuda.empty_cache()
    check(len(rows) == len(dtypes) * len(shapes),
          f"compare_flash_bwd ran {len(rows)} cases of {len(shapes)} shapes")
    return {**worst, "bwd_cases": rows}


def f32_attention_rows(q, k, v, rows: int = 1024):
    """Causal f32 attention with ``ref.flash_attention_ref``'s arithmetic
    (q * D^-1/2 rounded to f32, scores masked to -1e30 above the diagonal,
    P in f32, the sum clamped at 1e-30), one block of ``rows`` queries at
    a time so that the scores of T = 16384 fit beside the rest; a block
    reads only the keys its rows see (the others would add exact zeros)."""
    import torch

    from repro_torch.kernels import ref

    B, T, H, D = q.shape
    g = H // k.shape[2]
    k32 = k.to(torch.float32).repeat_interleave(g, dim=2)
    v32 = v.to(torch.float32).repeat_interleave(g, dim=2)
    out = torch.empty_like(q)
    for i0 in range(0, T, rows):
        i1 = min(T, i0 + rows)
        q32 = q[:, i0:i1].to(torch.float32) * (D ** -0.5)
        sc = torch.einsum("bthd,bshd->bhts", q32, k32[:, :i1])
        keep = (torch.arange(i1, device=q.device)[None, :]
                <= torch.arange(i0, i1, device=q.device)[:, None])
        sc = torch.where(keep, sc, ref.NEG_INF)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhts,bshd->bthd", p, v32[:, :i1])
        out[:, i0:i1] = o / l.clamp_min(1e-30).permute(0, 2, 1, 3)
        del sc, p
    return out


def compare_flash_fwd_drift(device, gen, shapes=FWD_DRIFT_CASES) -> dict:
    """flash_attention_f32 at ``shapes`` (FWD_DRIFT_CASES) against
    ``f32_attention_rows`` within FLASH_ATOL, each case's max |diff| and
    its ratio to the bar logged and kept."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    rows, worst = [], 0.0
    for case in shapes:
        q, k, v = flash_inputs(case, torch.float32, gen, device)
        got = fa.flash_attention(q, k, v, True, kv_tile=CONFIG_KV_CHUNK)
        want = f32_attention_rows(q, k, v)
        torch.cuda.synchronize()
        label = f"flash_attention_f32 drift {case}"
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite")
        err = float((got - want).abs().max())
        check(err <= FLASH_ATOL, f"{label}: max |diff| {err} > 2e-5")
        rows.append({"case": list(case), "max_abs_err": err,
                     "bar_ratio": err / FLASH_ATOL})
        worst = max(worst, err)
        log(f"{label}: max |diff| {err:.3g}, {err / FLASH_ATOL:.4f} of the "
            f"2e-5 bar")
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return {"flash_attention_f32": worst, "fwd_drift_cases": rows,
            "worst_ratio": worst / FLASH_ATOL}


# the wkv6 kernels' cases: (B, T, H, K, input dtype, decay dtype[,
# "extreme"]): rwkv6's 32 heads of 64 over 2048 steps (the train
# microbatch is B = 2), a ragged T = 700 (the last 64-step chunk partial),
# and the decode step (8 slots, T = 1, bf16 r, k, v with the decode path's
# f32 decay, and all f32); the smoke config's heads of 16 in each of their
# three dtype pairs; then two extreme decays (``wkv_inputs``).  T = 1 runs
# the step kernel, every other T the chunked ones
WKV_CASES = (
    (1, 2048, 32, 64, "bfloat16", "bfloat16"),
    (1, 2048, 32, 64, "float32", "float32"),
    (2, 2048, 32, 64, "bfloat16", "bfloat16"),
    (2, 2048, 32, 64, "float32", "float32"),
    (1, 700, 32, 64, "bfloat16", "bfloat16"),
    (1, 700, 32, 64, "float32", "float32"),
    (8, 1, 32, 64, "bfloat16", "float32"),
    (8, 1, 32, 64, "float32", "float32"),
    (1, 300, 2, 16, "bfloat16", "bfloat16"),
    (1, 300, 2, 16, "bfloat16", "float32"),
    (1, 300, 2, 16, "float32", "float32"),
    (1, 700, 32, 64, "bfloat16", "bfloat16", "extreme"),
    (1, 300, 2, 16, "float32", "float32", "extreme"),
)
# rwkv6-1.6b's 16 heads of 64 a rank on a model axis of 2 (phase 3s): the
# train microbatch of 2 x 2048 and the decode step of 8 slots
# (FAMILY_MESH_SEED's generator, after the flash cases above)
WKV_FAMILY_MESH_CASES = (
    (2, 2048, 16, 64, "bfloat16", "bfloat16"),
    (8, 1, 16, 64, "bfloat16", "float32"),
)
# the bar: each output's error against an f64 run of the same recurrence
# (max |diff| over max |f64|) at most WKV_RATIO times the plain f32
# version's (the kernels sum in another order)
WKV_RATIO = 2.0


def wkv_inputs(case, gen, device):
    """r, k, v (input dtype), w (decay dtype) in (0, 1), u (H, K), a
    nonzero first state, dy and the final state's gradient, all seeded.
    An "extreme" case draws w = exp(-exp(2 z + 1)) (a log decay of -20 a
    step on average, so a chunk's sums pass -88 and some w underflow to
    0), then sets 5% of w to exactly 0 and 5% to exactly 1."""
    import torch

    B, T, H, K, dt, wdt = case[:6]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    r, k, v = (randn(B, T, H, K).to(getattr(torch, dt)) for _ in range(3))
    if case[6:] == ("extreme",):
        w = torch.exp(-torch.exp(2.0 * randn(B, T, H, K) + 1.0))
        m = torch.rand((B, T, H, K), generator=gen, device=device)
        w = torch.where(m < 0.05, 0.0, torch.where(m > 0.95, 1.0, w))
        w = w.to(getattr(torch, wdt))
    else:
        w = torch.exp(-torch.exp(0.5 * randn(B, T, H, K) - 0.5)).to(
            getattr(torch, wdt))
    u = 0.5 * randn(H, K)
    s0 = 0.3 * randn(B, H, K, K)
    dy = randn(B, T, H, K)
    ds = 0.1 * randn(B, H, K, K)
    return r, k, v, w, u, s0, dy, ds


def _f64_err(a, want) -> float:
    import torch

    want = want.to(torch.float64)
    return float((a.to(torch.float64) - want).abs().max()
                 / want.abs().max().clamp_min(1e-300))


def compare_wkv6(device, gen, cases=WKV_CASES) -> dict:
    """The wkv6 kernels against their plain versions at ``cases``
    (WKV_CASES; WKV_FAMILY_MESH_CASES), with a
    nonzero first state, u and final-state gradient, each case through the
    forward ``wkv6.uses_step`` picks (the step kernel at T = 1, the
    chunked forward otherwise) and the chunked backward: each output (y,
    the final state, every saved chunk state; dr, dk, dv, dw, du, dS0)
    finite and no further from an f64 run of ``ref.wkv6_ref`` /
    ``ref.wkv6_bwd_ref`` than WKV_RATIO times the plain f32 version; the
    step kernel's states bitwise the plain version's (the same rounded
    updates; the chunked kernels sum in another order by design, so the
    f64 bar holds theirs); each kernel bitwise equal over two runs; each
    one's max |diff| from the chunked mirror (``ref.wkv6_chunked_ref`` /
    ``wkv6_chunked_bwd_ref``) logged."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wk

    worst = {"wkv6_fwd": 0.0, "wkv6_bwd": 0.0, "wkv6_step": 0.0}
    rows = []
    for case in cases:
        r, k, v, w, u, s0, dy, ds = wkv_inputs(case, gen, device)
        T = case[1]
        step = wk.uses_step(T, s0)
        fname = "wkv6_step" if step else "wkv6_fwd"
        fwd = wk.wkv6_step if step else wk.wkv6_fwd
        y, st, cs = fwd(r, k, v, w, u, s0, chunks=True)
        y2, st2, cs2 = fwd(r, k, v, w, u, s0, chunks=True)
        yp, stp, csp = ref.wkv6_ref(r, k, v, w, u, s0, return_chunks=True)
        y64, st64, cs64 = ref.wkv6_ref(r, k, v, w, u, s0,
                                       dtype=torch.float64,
                                       return_chunks=True)
        g = wk.wkv6_bwd(r, k, v, w, u, dy, cs, ds, want_dstate=True)
        g2 = wk.wkv6_bwd(r, k, v, w, u, dy, cs, ds, want_dstate=True)
        gp = ref.wkv6_bwd_ref(r, k, v, w, u, dy, s0, ds)
        g64 = ref.wkv6_bwd_ref(r, k, v, w, u, dy, s0, ds,
                               dtype=torch.float64)
        ym, stm, csm = ref.wkv6_chunked_ref(r, k, v, w, u, s0)
        gm = ref.wkv6_chunked_bwd_ref(r, k, v, w, u, dy, csm, ds)
        torch.cuda.synchronize()
        label = f"wkv6 {case}"
        check(torch.equal(y, y2) and torch.equal(st, st2)
              and torch.equal(cs, cs2), f"{label}: {fname} two runs differ")
        if step:
            check(torch.equal(st, stp) and torch.equal(cs, csp),
                  f"{label}: the step kernel's states are not the plain "
                  f"version's")
        row = {"case": list(case), "forward": fname}
        outs = ((fname, "y", y, yp, y64, None, ym),
                (fname, "state", st, stp, st64, None, stm))
        outs += tuple((fname, f"chunk {c}", cs[:, :, c], csp[:, :, c],
                       cs64[:, :, c], None, csm[:, :, c])
                      for c in range(1, cs.shape[2]))
        outs += tuple(("wkv6_bwd", n, a, b, c, a2, m) for n, a, b, c, a2, m
                      in zip(("dr", "dk", "dv", "dw", "du", "dS0"), g, gp,
                             g64, g2, gm))
        for kname, n, a, b, c, a2, m in outs:
            check(a.dtype == torch.float32 and a.shape == b.shape
                  and bool(torch.isfinite(a).all()),
                  f"{label} {n}: {a.dtype} {tuple(a.shape)}")
            if a2 is not None:
                check(torch.equal(a, a2), f"{label} {n}: wkv6_bwd two runs "
                                          f"differ")
            ek, ep = _f64_err(a, c), _f64_err(b, c)
            check(ek <= WKV_RATIO * ep, f"{label} {n}: kernel {ek:.3e} from "
                  f"f64, over {WKV_RATIO:g} x the plain f32 version's "
                  f"{ep:.3e}")
            row[n] = {"kernel": ek, "plain": ep,
                      "max_abs_err": float((a - b).abs().max()),
                      "mirror_max_abs": float((a - m).abs().max())}
            worst[kname] = max(worst[kname], row[n]["max_abs_err"])
        chunk_ratio = max((row[n]["kernel"] / max(row[n]["plain"], 1e-300)
                           for n in row if n.startswith("chunk ")),
                          default=0.0)
        log(f"{label} ({fname}, wkv6_bwd): error from f64 (max|diff| / "
            f"max|f64|) kernel / plain "
            + ", ".join(f"{n} {row[n]['kernel']:.3e} / {row[n]['plain']:.3e}"
                        for n in ("y", "state", "dr", "dk", "dv", "dw", "du",
                                  "dS0"))
            + f"; {cs.shape[2] - 1} chunk states at most {chunk_ratio:.2f}x "
            f"(bar {WKV_RATIO:g}x); max|diff| from the chunked mirror "
            + ", ".join(f"{n} {row[n]['mirror_max_abs']:.3e}"
                        for n in ("y", "state", "dr", "dk", "dv", "dw", "du",
                                  "dS0"))
            + ("; states bitwise the plain version's" if step else "")
            + "; two runs bitwise equal")
        rows.append(row)
        del r, k, v, w, u, s0, dy, ds, y, y2, yp, y64, g, g2, gp, g64
        del cs, cs2, csp, cs64, ym, stm, csm, gm
    torch.cuda.empty_cache()
    return {**worst, "wkv_cases": rows}


# ------------------------------------------------------------- phase 3
def _counters() -> tuple:
    from repro_torch.kernels import dither_pack as dp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_agg as fg
    from repro_torch.kernels import layered_encode as le
    from repro_torch.kernels import wkv6 as wk

    return fg.LAUNCHES, dp.LAUNCHES, le.LAUNCHES, fa.LAUNCHES, wk.LAUNCHES


def reset_launches() -> None:
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    out = {}
    for counts in _counters():
        out.update(counts)
    return out


def client_targets(c: int, d: int, device):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(1_000 + c)
    return torch.randn(d, generator=gen, device=device) * 0.5


def run_mechanism(mech: str, sigma: float, device, sample_idx, expect: dict,
                  d: int = D_FULL, rounds: int = ROUNDS) -> dict:
    """``rounds`` rounds of FederatedAveraging at width ``d``, the packed
    wire for the homomorphic mechanisms and the unpacked one otherwise;
    checks the launch counts against ``expect`` (every other kernel: 0)
    and returns them, the error sample, the round times and the bits."""
    import torch

    from repro_torch.dist import compress as dcompress
    from repro_torch.fl import federated
    from repro_torch.runtime import protocol

    def client_grad(params, c, rnd):
        # least squares toward a per-client target drawn on the card
        return params - client_targets(c, params.numel(), device)

    packed = mech in dcompress.HOMOMORPHIC
    kwargs = (("packed", True), ("msg_bits", BITS)) if packed else ()
    cfg = federated.FLConfig(
        n_clients=N_CLIENTS, mechanism=mech, sigma=sigma, clip=CLIP, lr=1.0,
        seed=0, mech_kwargs=kwargs)
    fa = federated.FederatedAveraging(cfg, client_grad, device=device)
    if packed:
        comp = fa.proto._comp()
        wire = dcompress.wire_bits_per_coord(comp, N_CLIENTS, size=d)
        check(wire == 8.0, f"{mech}: wire_bits_per_coord {wire} != 8")

    params = torch.zeros(d, dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    walls, split, errs, bits = [], {}, [], []
    for rnd in range(rounds):
        # the true mean of the clipped updates on the subsample
        p_s = params[sample_idx]
        mean = torch.zeros_like(p_s)
        for c in range(N_CLIENTS):
            t_s = client_targets(c, d, device)[sample_idx]
            mean += torch.clamp(p_s - t_s, -CLIP, CLIP)
        mean /= N_CLIENTS
        protocol.ROUND_TIMES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with protocol.timing(rnd == rounds - 1):
            new, info = fa.round(params, rnd)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if rnd == rounds - 1:
            split = dict(protocol.ROUND_TIMES)
        bits.append(info["bits_per_coord"])
        if packed:
            check(info["bits_per_coord"] == 8.0, f"{mech}: bits {info}")
        else:  # measured Elias-gamma length
            check(1.0 <= info["bits_per_coord"] < 32.0, f"{mech}: {info}")
        update = params[sample_idx] - new[sample_idx]  # lr = 1
        errs.append((update - mean).double().cpu())
        check(bool(torch.isfinite(new).all()), f"{mech}: non-finite params")
        params = new
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    for k, v in launches.items():
        want = expect.get(k, 0)
        check(v == want, f"{mech}: {v} {k} launches, expected {want}")
    del params, new, fa
    torch.cuda.empty_cache()
    return {"launches": launches, "errs": errs, "walls": walls,
            "split": split, "peak_bytes": peak, "bits": bits}


def run_dither_pack(device, gen) -> dict:
    """The dither_pack path: its entry points ops.dither_pack_encode /
    ops.dither_unpack_decode at full width, b = 8, w = DP_W, with the
    launch counts set to 0 just before and read just after; the error of
    the round trip is the dither's, inside [-w/2, w/2] with std
    w / sqrt(12)."""
    import torch

    from repro_torch.kernels import ops

    x = torch.randn(D_FULL, generator=gen, device=device) * 0.3
    s = torch.rand(D_FULL, generator=gen, device=device) - 0.5
    torch.cuda.synchronize()
    reset_launches()
    words, numel = ops.dither_pack_encode(x, s, DP_W, bits=BITS)
    y = ops.dither_unpack_decode(words, s, DP_W, BITS, x.shape)
    torch.cuda.synchronize()
    launches = read_launches()
    for k, v in launches.items():
        want = 1 if k in ("dither_pack", "unpack_decode") else 0
        check(v == want, f"dither_pack path: {v} {k} launches")
    wire = 32.0 * words.numel() / numel
    check(wire == 8.0, f"dither_pack wire {wire} bits per coordinate")
    err = y - x
    emax, estd = float(err.abs().max()), float(err.std())
    check(emax <= DP_W / 2 + 1e-6, f"dither_pack error {emax} > w/2")
    check(abs(estd - DP_W / math.sqrt(12)) < 0.02 * DP_W,
          f"dither_pack error std {estd}")
    log(f"dither_pack path: launches {launches}, wire {wire} bits, max "
        f"|err| {emax:.6g} (w/2 = {DP_W / 2}), std {estd:.6g} "
        f"(w/sqrt(12) = {DP_W / math.sqrt(12):.6g})")
    del x, s, words, y, err
    torch.cuda.empty_cache()
    return {"launches": launches, "max_err": emax, "std": estd}


# ------------------------------------------------------------ phase 3b
# compress_tree across client ranks on the one card: each rank holds one
# client's update, shaped as qwen1.5-0.5b's parameter tree
RANKS = 4
RANK_BACKEND = "gloo"  # the caller names it; NCCL is probed, not used
RANK_CASES = (  # (mechanism, sigma, fused)
    ("aggregate_gaussian", 0.25, True),
    ("irwin_hall", 5e-3, True),
    ("layered_shifted", SIGMA_IND, False),
)
RANK_KEY = 11  # compress_tree's key: PRNGKey(RANK_KEY)
RANK_TIMEOUT = 420.0
# each client's update is qwen1.5-0.5b's parameter tree at full width with
# its depth cut to RANK_LAYERS of 24 (181,283,840 of 463,987,712 entries,
# 155,582,464 of them the embedding), to keep the whole run inside its
# limit on slow hosts; the tree keeps its leaves (each stacks its layers),
# so each case's launches are unchanged
RANK_LAYERS = 2


def rank_config():
    from repro_torch import configs

    return configs.get_config(SERVE_ARCH).scaled(n_layers=RANK_LAYERS)


def rank_d() -> int:
    """Entries of a client's update (``rank_config``'s parameters)."""
    from repro_torch.models import nn, registry

    return nn.spec_numel(registry.param_specs(rank_config()))


def held(where: str) -> None:
    """Log the device memory this process still holds (the serve
    phase's peak counts what earlier phases left)."""
    import torch

    log(f"device memory allocated {where}: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def client_flat(c: int, device):
    """Client ``c``'s update, flat in the tree's leaf order: N(0, 0.25),
    drawn on the card from seed 2000 + c."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(2_000 + c)
    return torch.randn(rank_d(), generator=gen, device=device) * 0.5


def _views(node, flat, off: int):
    """(tree of views of ``flat`` shaped as the spec tree ``node``, the
    next offset); module-level, so no closure keeps ``flat`` alive."""
    from repro_torch.models import nn

    if nn.is_spec(node):
        n = math.prod(node.shape)
        return flat[off:off + n].view(node.shape), off + n
    out = {}
    for k in sorted(node):
        out[k], off = _views(node[k], flat, off)
    return out, off


def tree_of(flat):
    """Views of ``flat`` shaped as ``rank_config``'s parameter tree, in
    the JAX package's leaf order (dict keys sorted)."""
    from repro_torch.models import registry

    tree, end = _views(registry.param_specs(rank_config()), flat, 0)
    check(end == flat.numel(), f"tree holds {end} of {flat.numel()}")
    return tree


def _leaves(tree) -> list:
    from repro_torch.dist import compress as dcompress

    return dcompress._flatten(tree)[0]


def _comp(mech: str, sigma: float, fused: bool):
    from repro_torch.dist import compress as dcompress

    return dcompress.CompressionConfig(
        mechanism=mech, sigma=sigma, clip=CLIP, fused=fused,
        msg_bits=BITS if fused else None)


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def rank_main(rank: int, n: int, port: int, device: str, results) -> None:
    """One client rank: its update as the parameter tree, then one
    ``compress_tree(axis=group, n_clients=n)`` per case, timed between
    two barriers, with the kernel counts set to 0 just before and read
    just after.  Reports the launches, wall, peak memory and a digest of
    the output; rank 0 also the digests of the summed words and the
    error sample."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import prng
    from repro_torch.dist import compress as dcompress

    try:
        device = torch.device(device)
        torch.cuda.set_device(device)
        dist.init_process_group(RANK_BACKEND,
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=n)
        group = dist.group.WORLD
        tree = tree_of(client_flat(rank, device))
        d = rank_d()
        sample_idx = torch.arange(0, d, d // KS_SAMPLE,
                                  device=device)[:KS_SAMPLE]
        out = {"rank": rank, "backend": dist.get_backend(group), "cases": {}}
        psum = dcompress._psum_msg
        for mech, sigma, fused in RANK_CASES:
            comp = _comp(mech, sigma, fused)
            sums = []

            def recording(m, comp, grp):  # rank 0 keeps the summed words
                total = psum(m, comp, grp)
                if rank == 0:
                    sums.append(total.clone())
                return total

            dcompress._psum_msg = recording
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            reset_launches()
            t0 = time.perf_counter()
            y = dcompress.compress_tree(tree, comp, prng.PRNGKey(RANK_KEY),
                                        axis=group, n_clients=n,
                                        device=device)
            torch.cuda.synchronize()
            dist.barrier()
            wall = time.perf_counter() - t0
            launches = read_launches()
            dcompress._psum_msg = psum
            ys = _leaves(y)
            res = {"wall": wall, "launches": launches, "leaves": len(ys),
                   "peak_bytes": torch.cuda.max_memory_allocated(),
                   "y_digest": _digest(ys),
                   "finite": bool(all(torch.isfinite(t).all() for t in ys))}
            if rank == 0:
                res["sum_digest"] = _digest(sums) if sums else None
                flat_y = torch.cat([t.reshape(-1) for t in ys])[sample_idx]
                mean = torch.zeros_like(flat_y)
                for c in range(n):
                    mean += torch.clamp(client_flat(c, device)[sample_idx],
                                        -CLIP, CLIP)
                res["err"] = (flat_y - mean / n).double().cpu().numpy()
                del flat_y, mean
            out["cases"][mech] = res
            del y, ys, sums
            torch.cuda.empty_cache()
        results.put(out)
    except BaseException as e:  # reported to the parent, then re-raised
        import traceback

        results.put({"rank": rank, "error": traceback.format_exc()})
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def nccl_probe_main(rank: int, port: int, results) -> None:
    """Two NCCL ranks on the same card, one all_reduce: records whether
    NCCL accepts the communicator."""
    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=2)
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        results.put((rank, f"ok: sum {t.tolist()}"))
    except Exception as e:  # noqa: BLE001 -- the refusal is the result
        results.put((rank, f"refused: {type(e).__name__}: "
                           f"{str(e).splitlines()[0][:300]}"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn(target, args_of, n: int, timeout: float) -> list:
    """``n`` spawned processes of ``target(*args_of(i), results)``; their
    results, and every process stopped."""
    return _spawn_collect(_spawn_start(target, args_of, n), n, timeout)


def _spawn_start(target, args_of, n: int):
    """Start ``n`` spawned processes of ``target(*args_of(i), results)``
    and return at once: (processes, results queue) for
    ``_spawn_collect``.  Any still running when this process exits (a
    failed check before their collection) are killed then."""
    import atexit
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=target, args=(*args_of(i), results))
             for i in range(n)]
    for p in procs:
        p.start()
    atexit.register(lambda: [p.kill() for p in procs if p.is_alive()])
    return procs, results


def _spawn_collect(started, n: int, timeout: float) -> list:
    """The results of ``_spawn_start``'s processes within ``timeout``
    seconds, and every process stopped (killed if still running then)."""
    import queue

    procs, results = started
    got = []
    deadline = time.monotonic() + timeout
    try:
        while len(got) < n:
            try:
                got.append(results.get(
                    timeout=max(deadline - time.monotonic(), 0.1)))
            except queue.Empty:
                break
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return got


NCCL_PROBE_TIMEOUT = 120.0


def start_nccl_probe():
    """Start the probe's 2 NCCL ranks (``probe_nccl`` collects them); they
    run beside the FL rounds, and the phase uses RANK_BACKEND whatever
    they say."""
    port = free_port()
    return _spawn_start(nccl_probe_main, lambda i: (i, port), 2)


def probe_nccl(started) -> str:
    """Whether NCCL took ``start_nccl_probe``'s two ranks on one card (it
    is expected to refuse a duplicate GPU)."""
    got = _spawn_collect(started, 2, NCCL_PROBE_TIMEOUT)
    if len(got) < 2:
        return (f"no answer from {2 - len(got)} of 2 ranks within "
                f"{NCCL_PROBE_TIMEOUT:.0f} s")
    return "; ".join(f"rank {r}: {msg}" for r, msg in sorted(got))


def run_ranks_phase(device, nccl_started) -> dict:
    """The process-group path on one card: RANKS client ranks, each with
    its own client's update at full width, one compress_tree per case.
    Checks: every rank's output bitwise equal to rank 0's; each kernel of
    the case launched once per leaf on every rank and no other; for the
    fused cases, the summed words equal the sum of the four clients'
    words computed in this process by the codec (bitwise, by digest);
    the error law on a 2^20 subsample (KS against N(0, sigma^2); for
    irwin_hall its support and std).  ``nccl_started`` is
    ``start_nccl_probe``'s, collected here."""
    import numpy as np
    import torch

    from repro_torch.core import dither, prng
    from repro_torch.dist import compress as dcompress

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    nccl = probe_nccl(nccl_started)
    log(f"NCCL with 2 ranks on one card: {nccl}")
    port = free_port()
    t0 = time.perf_counter()
    got = _spawn(rank_main, lambda r: (r, RANKS, port, str(device)), RANKS,
                 RANK_TIMEOUT)
    spawn_wall = time.perf_counter() - t0
    errors = [g["error"] for g in got if "error" in g]
    check(not errors, "rank failed:\n" + "\n".join(errors))
    check(len(got) == RANKS, f"{RANKS - len(got)} ranks gave no result "
                             f"within {RANK_TIMEOUT} s")
    by_rank = {g["rank"]: g for g in got}
    backend = by_rank[0]["backend"]
    check(backend == RANK_BACKEND, f"backend {backend}")
    out = {"ranks": RANKS, "backend": backend, "nccl_probe": nccl,
           "spawn_to_exit_s": spawn_wall, "cases": {}}
    for mech, sigma, fused in RANK_CASES:
        rows = [by_rank[r]["cases"][mech] for r in range(RANKS)]
        leaves = rows[0]["leaves"]
        kernels = (("fused_encode", "fused_decode") if fused
                   else ("layered_encode", "layered_decode"))
        for r, row in enumerate(rows):
            check(row["finite"], f"{mech} rank {r}: non-finite output")
            check(row["y_digest"] == rows[0]["y_digest"],
                  f"{mech}: rank {r}'s output differs from rank 0's")
            for k, v in row["launches"].items():
                want = leaves if k in kernels else 0
                check(v == want, f"{mech} rank {r}: {v} {k} launches, "
                                 f"expected {want}")
        res = {"wall_s": [row["wall"] for row in rows],
               "peak_gib": [row["peak_bytes"] / 2**30 for row in rows],
               "launches_per_rank": rows[0]["launches"], "leaves": leaves}
        err = rows[0]["err"]
        if mech == "irwin_hall":
            half = sigma * math.sqrt(3 * RANKS)
            emax, estd = float(np.abs(err).max()), float(err.std())
            check(emax <= half + 1e-6, f"{mech}: max |err| {emax} > {half}")
            check(abs(estd - sigma) <= 0.1 * sigma, f"{mech}: std {estd}")
            res.update(max_abs_err=emax, support=half, std=estd)
        else:
            ks = ks_stat(err, sigma)
            thr = 1.95 / math.sqrt(len(err))
            check(ks < thr, f"{mech}: KS {ks} >= {thr}")
            res.update(ks=ks, ks_threshold=thr, std=float(err.std()))
        if fused:  # the sum of the clients' words, in this one process
            comp = _comp(mech, sigma, fused)
            xs = [client_flat(c, device) for c in range(RANKS)]
            trees = [_leaves(tree_of(x)) for x in xs]
            sums = []
            for i in range(leaves):
                kt, ks_ = prng.split(prng.fold_in(prng.PRNGKey(RANK_KEY), i))
                shape = tuple(trees[0][i].shape)
                step, _, geom = dcompress._leaf_params(comp, RANKS, kt, shape,
                                                       device)
                total = None
                for c in range(RANKS):
                    x32 = torch.clamp(trees[c][i], -CLIP, CLIP)
                    s_c = dither.dither_noise(prng.fold_in(ks_, c), shape,
                                              device=device)
                    w = dcompress.encode_leaf(x32, comp, step, s_c, geom)
                    total = w if total is None else total + w
                    del x32, s_c, w
                sums.append(total.cpu())
                del step, total
            digest = _digest(sums)
            check(digest == rows[0]["sum_digest"],
                  f"{mech}: summed words differ from the one-process sum")
            res["summed_words_bitwise"] = True
            del xs, trees, sums
            torch.cuda.empty_cache()
        out["cases"][mech] = res
        log(f"{RANKS} ranks ({backend}), {mech}: round walls "
            f"{[round(w, 3) for w in res['wall_s']]} s, peak "
            f"{[round(p, 2) for p in res['peak_gib']]} GiB per rank, "
            f"launches per rank {res['launches_per_rank']} ({leaves} "
            f"leaves), outputs bitwise equal across ranks"
            + (", summed words = one-process sum" if fused else "")
            + (f", KS {res['ks']:.6f} (threshold {res['ks_threshold']:.6f})"
               if "ks" in res else
               f", max |err| {res['max_abs_err']:.6g} (support "
               f"{res['support']:.6g}), std {res['std']:.6g}"))
    return out


# ------------------------------------------------------------ phase 3c
D_ASYNC = 1 << 24
ASYNC_ROUNDS = 3


def run_async_phase(device) -> dict:
    """At d = 2^24 on the card, QuadraticWorkload with 4 clients,
    aggregate_gaussian on the packed wire (b = 8): 3 rounds of the async
    runtime at staleness bound 0 bitwise equal to 3 rounds of the
    synchronous loop; and FederatedAveraging.run checkpointed after
    round 1 and resumed, bitwise equal to the run without the break."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.fl import federated
    from repro_torch.runtime import (AsyncFederatedRuntime, QuadraticWorkload,
                                     RuntimeConfig)

    cfg = federated.FLConfig(
        n_clients=N_CLIENTS, mechanism="aggregate_gaussian", sigma=0.25,
        clip=CLIP, lr=0.5, seed=5,
        mech_kwargs=(("packed", True), ("msg_bits", BITS)))
    wl = QuadraticWorkload(N_CLIENTS, D_ASYNC, seed=5)
    fa = federated.FederatedAveraging(cfg, wl.build(device), device=device)
    reset_launches()
    t0 = time.perf_counter()
    p_sync = wl.init_params(device)
    for rnd in range(ASYNC_ROUNDS):
        p_sync, _ = fa.round(p_sync, rnd)
    torch.cuda.synchronize()
    sync_wall = time.perf_counter() - t0
    sync_launches = read_launches()
    rt = AsyncFederatedRuntime(RuntimeConfig(fl=cfg, round_timeout_s=120.0),
                               wl, device=device)
    reset_launches()
    t0 = time.perf_counter()
    p_async, summary, records = rt.run(wl.init_params(device), ASYNC_ROUNDS)
    async_wall = time.perf_counter() - t0
    async_launches = read_launches()
    check(summary["rounds"] == ASYNC_ROUNDS
          and summary["mean_cohort_occupancy"] == 1.0, f"async {summary}")
    check(np.array_equal(p_async, p_sync.cpu().numpy()),
          "async at staleness 0 differs from the synchronous loop")
    for launches in (sync_launches, async_launches):
        for k, v in launches.items():
            want = {"fused_encode": ASYNC_ROUNDS * N_CLIENTS,
                    "fused_decode": ASYNC_ROUNDS}.get(k, 0)
            check(v == want, f"async phase: {v} {k} launches")
    ck = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    p0 = {"w": wl.init_params(device)}

    def grad(params, c, rnd):
        return {"w": fa.client_grad(params["w"], c, rnd)}

    fa_tree = federated.FederatedAveraging(cfg, grad, device=device)
    fa_tree.run(p0, 1, checkpoint_dir=str(ck))
    resumed, info = fa_tree.run(p0, ASYNC_ROUNDS, checkpoint_dir=str(ck),
                                resume=True)
    check(info["start_round"] == 1, f"resumed at {info['start_round']}")
    check(torch.equal(resumed["w"], p_sync),
          "resumed run differs from the run without the break")
    shutil.rmtree(ck, ignore_errors=True)
    log(f"async runtime at d = 2^24: {ASYNC_ROUNDS} rounds at staleness 0 "
        f"bitwise equal to the synchronous loop (sync {sync_wall:.3f} s, "
        f"async {async_wall:.3f} s, round latencies "
        f"{[round(r.latency_s, 3) for r in records]} s; launches "
        f"{async_launches}); checkpoint after round 1 and resume: bitwise")
    return {"sync_wall_s": sync_wall, "async_wall_s": async_wall,
            "round_latency_s": [r.latency_s for r in records],
            "launches": async_launches, "resume_bitwise": True,
            "async_bitwise": True}


# ------------------------------------------------------------ phase 3d
# the train step at full width: qwen1.5-0.5b as configured (bf16 compute,
# f32 params, remat full, kv_chunk 1024), AdamW lr 3e-4, lm data, global
# batch 8 x 2048 in 2 microbatches of 4 x 2048, compressed at n = 1 by
# aggregate_gaussian with per-tensor randomness, fused b = 8
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_SEQ = 2048
TRAIN_BATCH = 8
TRAIN_ACCUM = 2
TRAIN_STEPS = 3
TRAIN_SIGMA = 1e-4  # the train launcher's default
TRAIN_SEED = 0      # the step's compression seed (fold_in(PRNGKey, step))
TRAIN_CHECK_SEQ = 2048  # the kernels-vs-plain gradient check: 1 x 2048


def _train_comp(mech: str, sigma: float):
    from repro_torch.dist import compress as dcompress

    return dcompress.CompressionConfig(mechanism=mech, sigma=sigma,
                                       clip=CLIP, per_coord=False,
                                       fused=True, msg_bits=BITS)


def train_launches_expected(cfg, microbatches: int) -> dict:
    """Launches of one compressed train step: per microbatch each layer's
    forward, its remat forward and its backward through the kernels of
    its family and compute dtype (the transformer's flash kernels, bf16:
    flash_attention_sm90 and its backward, f32: flash_attention_f32 and
    its backward, none of the other dtype's; rwkv6's wkv6_fwd and
    wkv6_bwd in either dtype; zamba2's flash kernels once per group, the
    shared block's applications, its Mamba2 layers plain PyTorch;
    whisper's once per encoder layer and twice per decoder layer, its
    self- and cross-attention); then one fused encode and decode per
    parameter leaf."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import nn, registry, zamba2

    specs = []
    nn.map_specs(lambda _, spec: specs.append(spec),
                 registry.param_specs(cfg))
    leaves = len(specs)
    # the attention calls of a forward
    L = cfg.n_layers
    if cfg.kind == "zamba2":
        L = zamba2.layout(cfg)[0]
    elif cfg.kind == "whisper":
        L = cfg.encoder_layers + 2 * cfg.n_layers
    dtype = getattr(torch, cfg.compute_dtype)
    out = {name: 0 for name in fa.LAUNCHES}
    if cfg.kind == "rwkv6":
        out.update(wkv6_fwd=2 * L * microbatches,
                   wkv6_bwd=L * microbatches)
    else:
        out[fa.KERNELS[dtype][0]] = 2 * L * microbatches
        out[fa.BWD_KERNELS[dtype]] = L * microbatches
    out.update({"fused_encode": leaves, "fused_decode": leaves})
    return out


def _plain_wkv6_fwd(r, k, v, w, u, state=None, *, chunks=False):
    """``wkv6.wkv6_fwd``'s (and ``wkv6_step``'s) signature over
    ``ref.wkv6_ref``."""
    from repro_torch.kernels import ref

    out = ref.wkv6_ref(r, k, v, w, u, state, return_chunks=chunks)
    return out if chunks else out[:2]


def _plain_wkv6_bwd(r, k, v, w, u, dy, chunks, dstate=None, *,
                    want_dstate=False):
    """``wkv6.wkv6_bwd``'s signature over ``ref.wkv6_bwd_ref`` (the first
    state is the forward's first chunk state)."""
    from repro_torch.kernels import ref

    out = ref.wkv6_bwd_ref(r, k, v, w, u, dy, chunks[:, :, 0], dstate)
    return out if want_dstate else out[:5] + (None,)


class plain_kernels:
    """Within the block, the autograd functions of the models' kernels
    (flash attention, the wkv6 recurrence) run their plain forward and
    backward on CUDA tensors too (the yardstick of the gradient and logit
    checks; nothing is counted)."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ref
        from repro_torch.kernels import wkv6 as wk

        self._saved = (fa.flash_attention, fa.flash_attention_bwd,
                       wk.wkv6_fwd, wk.wkv6_bwd, wk.wkv6_step)
        fa.flash_attention = fa._plain_forward
        fa.flash_attention_bwd = ref.flash_attention_bwd_ref
        wk.wkv6_fwd, wk.wkv6_bwd = _plain_wkv6_fwd, _plain_wkv6_bwd
        wk.wkv6_step = _plain_wkv6_fwd
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import wkv6 as wk

        (fa.flash_attention, fa.flash_attention_bwd, wk.wkv6_fwd,
         wk.wkv6_bwd, wk.wkv6_step) = self._saved
        return False


def _rel_l2(a, b) -> float:
    import torch

    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-300))


def token_nll(cfg, params, batch):
    """The per-token NLL whose mean is the train loss
    (``registry.loss_fn``), without a gradient: (1, T - 1) f32."""
    import torch

    from repro_torch.models import nn, registry
    from repro_torch.models.config import torch_dtype

    with torch.no_grad():
        model = registry.tree_model(cfg, nn.cast_tree(
            params, torch_dtype(cfg.compute_dtype)))
        logits = registry.logits_fn(cfg, model, batch)[:, :-1].float()
        labels = batch["tokens"][:, 1:, None].long()
        return (torch.logsumexp(logits, dim=-1)
                - torch.gather(logits, -1, labels)[..., 0])


def check_batch(cfg, device, seq: int = TRAIN_CHECK_SEQ,
                rows: int = 1) -> dict:
    """The gradient checks' microbatch: ``rows`` x ``seq`` lm tokens, with
    the kind's stub embeddings (whisper's frames)."""
    from repro_torch.data import synthetic

    dc = synthetic.DataConfig(vocab=cfg.vocab, seq_len=seq,
                              global_batch=rows, kind="lm")
    return synthetic.with_frontend_stubs(
        synthetic.lm_batch(dc, 99, device=device), cfg)


def plain_f32_gradient(cfg, params, device, seq: int = TRAIN_CHECK_SEQ,
                       rows: int = 1) -> tuple:
    """(loss, gradient) of the f32 model on the plain versions at
    ``check_batch``: the yardstick both gradient checks take, computed
    once for them."""
    from repro_torch.train import steps

    with plain_kernels():
        return steps.value_and_grad(cfg.scaled(compute_dtype="float32"),
                                    params,
                                    check_batch(cfg, device, seq, rows))


def check_train_gradient(cfg, params, device, plain32=None,
                         seq: int = TRAIN_CHECK_SEQ, rows: int = 1) -> dict:
    """One microbatch of ``rows`` x ``seq`` at full width: the loss and
    every leaf's gradient of the bf16 model on the kernels against the
    same model on the plain versions, each measured against the f32
    model's loss and gradient of the same params on the plain versions
    (``plain32``, or ``plain_f32_gradient``'s here);
    the bar is the bf16 gradient bar of tests/test_torch_train.py: the
    kernels' relative L2 error at most twice the plain bf16 path's (which
    computes the JAX model's bf16 function), for each gradient leaf and
    for the loss's ``seq`` - 1 per-token terms.  The scalar loss
    is one mean of those terms, whose errors mostly cancel (a ratio of
    two such draws says nothing), so it is logged, not held; its terms
    are, after checking that their mean is the step's loss."""
    from repro_torch.train import steps

    batch = check_batch(cfg, device, seq, rows)
    cfg32 = cfg.scaled(compute_dtype="float32")
    lk, gk = steps.value_and_grad(cfg, params, batch)
    tk = token_nll(cfg, params, batch)
    l32, g32 = (plain_f32_gradient(cfg, params, device, seq, rows)
                if plain32 is None else plain32)
    with plain_kernels():
        lp, gp = steps.value_and_grad(cfg, params, batch)
        tp = token_nll(cfg, params, batch)
        t32 = token_nll(cfg32, params, batch)
    for name, t, l in (("kernels", tk, lk), ("plain", tp, lp),
                       ("f32", t32, l32)):
        mean = float(t.mean())
        check(abs(mean - float(l)) <= 1e-6 * abs(float(l)),
              f"train gradient check: the {name} per-token NLL's mean "
              f"{mean} is not the step's loss {float(l)}")
    gk, gp, g32 = _leaves(gk), _leaves(gp), _leaves(g32)
    loss = (abs(float(lk) - float(l32)), abs(float(lp) - float(l32)))
    tok = (_rel_l2(tk, t32), _rel_l2(tp, t32))
    check(tok[0] <= 2 * tok[1], f"train gradient check: per-token NLL "
                                f"kernels {tok[0]:.3e} > 2 x plain "
                                f"{tok[1]:.3e}")
    ratios = []
    for i, (a, b, c) in enumerate(zip(gk, gp, g32)):
        if not bool(c.any()):  # a leaf the loss does not read: all zeros
            check(not bool(a.any()) and not bool(b.any()),
                  f"train gradient check leaf {i}: a gradient where the f32 "
                  f"model has none")
            continue
        ek, ep = _rel_l2(a, c), _rel_l2(b, c)
        check(ek <= 2 * ep, f"train gradient check leaf {i}: kernels "
                            f"{ek:.3e} > 2 x plain {ep:.3e}")
        ratios.append((ek, ep))
    log(f"train gradient check ({rows} x {seq}, bf16, against the "
        f"f32 model): per-token NLL relative L2 error kernels "
        f"{tok[0]:.3e}, plain {tok[1]:.3e} (bar 2x); loss error kernels "
        f"{loss[0]:.3e}, plain {loss[1]:.3e} (logged); leaf relative L2 "
        f"error kernels / plain {min(k / p for k, p in ratios):.3f}-"
        f"{max(k / p for k, p in ratios):.3f} (bar 2)")
    return {"loss_err_kernels": loss[0], "loss_err_plain": loss[1],
            "token_nll_rel_l2": tok, "leaf_rel_l2": ratios}


GEMM_TAGS = ("gemm", "nvjet", "xmma", "cutlass")  # cuBLAS kernel names
# the device-side names of each compute dtype's attention kernels in a
# profile: the backward's three launches (preprocess, dQ, dK / dV) and the
# forward
BWD_TAGS = {"bfloat16": "fa_bwd_sm90", "float32": "fa_bwd_f32"}
FWD_TAGS = {"bfloat16": "flash_attention_sm90",
            "float32": "flash_attention_f32"}
# rwkv6's in either dtype: the chunked backward's three kernels
# (wkv6_bwd_sum, _pass, _grad) and the chunked forward's (wkv6_fwd_sum,
# _pass, _out)
WKV_BWD_TAG, WKV_FWD_TAG = "wkv6_bwd", "wkv6_fwd"


def profile_train_step(cfg, step_fn, holder: list, batch,
                       seed: int) -> dict:
    """Where a steady train step's time goes: one step timed on the host
    clock (ended by a synchronize), then one more under ``torch.profiler``
    (CPU + CUDA, shapes recorded).  Reports the device's busy ms (the sum
    of the device-side rows, each kernel once), its idle share against
    the untraced step's wall, the ms of the compute dtype's backward
    kernels (``BWD_TAGS``: the preprocess, dQ and dK / dV), of its flash
    forward, of every cuBLAS GEMM and of the logits' GEMMs (``aten::mm`` or
    ``bmm`` with an operand as wide as the padded vocabulary: the output
    projection and its two gradients), the ten largest device rows, and
    the ten aten ops whose own launches hold the most device time.  A
    trace with no device time fails the run.  ``holder`` is a one-item
    list holding the state, replaced by each step's (so no caller keeps
    an older state alive beside the step's); returns the report."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    holder[0], _ = step_fn(holder[0], batch, seed)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        holder[0], _ = step_fn(holder[0], batch, seed)
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t0) * 1e3
    dev = _kernel_ms(prof, 1)
    check(bool(dev), "train profile: the trace holds no device time")
    busy = sum(ms for _, ms in dev)
    if cfg.kind == "rwkv6":
        bwd_tag, fwd_tag = WKV_BWD_TAG, WKV_FWD_TAG
    else:
        bwd_tag = BWD_TAGS[cfg.compute_dtype]
        fwd_tag = FWD_TAGS[cfg.compute_dtype]

    def total(pred) -> float:
        return sum(ms for k, ms in dev if pred(k))

    # the ops by the device time of the kernels they launched themselves
    # (each kernel once: self time), largest first; the logits' GEMMs are
    # the mm / bmm ops with an operand as wide as the padded vocabulary
    own: dict = {}
    logits = 0.0
    for name, shapes, ms in _op_device_ms(prof):
        own[name] = own.get(name, 0.0) + ms
        if name in ("aten::mm", "aten::bmm") and any(
                cfg.padded_vocab in shape for shape in shapes):
            logits += ms
    ops = sorted(own.items(), key=lambda kv: -kv[1])
    out = {"wall_ms": wall, "wall_profiled_ms": wall_prof,
           "device_ms": busy, "idle_share": 1.0 - busy / wall,
           "bwd_ms": total(lambda k: bwd_tag in k),
           "bwd_by_kernel": {k: ms for k, ms in dev if bwd_tag in k},
           "flash_fwd_ms": total(lambda k: fwd_tag in k),
           "gemm_ms": total(lambda k: any(t in k.lower()
                                          for t in GEMM_TAGS)),
           "logits_gemm_ms": logits, "top": dev[:10], "top_ops": ops[:10]}
    log(f"train profile ({cfg.compute_dtype}, one steady step): wall "
        f"{wall:.3f} ms (profiled {wall_prof:.3f} ms), device busy "
        f"{busy:.3f} ms (idle share {out['idle_share']:.3f}); the backward "
        f"kernels {out['bwd_ms']:.3f} ms ({100 * out['bwd_ms'] / busy:.1f}"
        f"% of busy: "
        + "; ".join(f"{k[:60]} {ms:.3f}"
                    for k, ms in out["bwd_by_kernel"].items())
        + f"), flash forward {out['flash_fwd_ms']:.3f} ms, GEMMs "
        f"{out['gemm_ms']:.3f} ms, of them the logits' "
        f"{logits:.3f} ms; the ops that launch most device time: "
        + "; ".join(f"{k} {ms:.3f}" for k, ms in ops[:10]))
    return out


def drive_train(cfg, global_batch: int, n_steps: int, device,
                seq: int = TRAIN_SEQ) -> tuple:
    """``n_steps`` steps of ``train.steps.build_train_step`` (the
    launcher's step) at full width, AdamW lr 3e-4, lm data of ``seq``
    tokens a sequence, TRAIN_ACCUM microbatches, compressed at n = 1 by aggregate_gaussian fused b = 8
    per-tensor (with the kind's stub embeddings: whisper's frames); each
    step timed on the host clock after a synchronize,
    with the launch counts set to 0 just before the steps and read just
    after, and checked against ``train_launches_expected``; then two more
    steps, the second traced (``profile_train_step``).  Returns (params,
    report)."""
    import torch

    from repro_torch.data import synthetic
    from repro_torch.models import nn, registry
    from repro_torch.train import steps

    tc = steps.TrainConfig(optimizer="adamw", lr=3e-4,
                           grad_accum=TRAIN_ACCUM,
                           compression=_train_comp("aggregate_gaussian",
                                                   TRAIN_SIGMA))
    state = steps.init_train_state(cfg, tc, 0, device)
    n = sum(p.numel() for p in _leaves(state["params"]))
    check(n == nn.spec_numel(registry.param_specs(cfg)),
          f"train state holds {n} parameters")
    dc = synthetic.DataConfig(vocab=cfg.vocab, seq_len=seq,
                              global_batch=global_batch, kind="lm")
    step_fn = steps.build_train_step(cfg, tc)
    batches = [synthetic.with_frontend_stubs(
        synthetic.lm_batch(dc, i, device=device), cfg)
        for i in range(n_steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    walls, losses = [], []
    for i in range(n_steps):
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[i], TRAIN_SEED)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    per_step = train_launches_expected(cfg, TRAIN_ACCUM)
    for k, v in launches.items():
        want = n_steps * per_step.get(k, 0)
        check(v == want, f"train {cfg.compute_dtype}: {v} {k} launches, "
                         f"expected {want}")
    check(all(math.isfinite(x) for x in losses), f"train losses {losses}")
    check(int(state["step"]) == n_steps, f"step {state['step']}")
    check(all(bool(torch.isfinite(p).all())
              for p in _leaves(state["params"])), "non-finite params")
    # after the counted run: these launches are not the path's
    holder = [state]
    del state
    prof = profile_train_step(cfg, step_fn, holder, batches[-1], TRAIN_SEED)
    state = holder.pop()
    tokens = global_batch * seq
    log(f"train {cfg.name} ({cfg.n_layers} layers, {cfg.compute_dtype}, "
        f"remat {cfg.remat}, "
        f"kv_chunk {cfg.kv_chunk}), batch {global_batch} x {seq} in "
        f"{TRAIN_ACCUM} microbatches, aggregate_gaussian fused b = {BITS} "
        f"per-tensor: step walls {[round(w, 3) for w in walls]} s, tokens/s "
        f"{[round(tokens / w, 1) for w in walls]}, losses {losses}, peak "
        f"{peak / 2**30:.2f} GiB, launches {launches}")
    params = state["params"]
    del state, batches, m
    torch.cuda.empty_cache()
    return params, {"walls_s": walls,
                    "tokens_per_s": [tokens / w for w in walls],
                    "losses": losses, "peak_bytes": peak,
                    "launches": launches, "launches_per_step": per_step,
                    "profile": prof}


def run_train_phase(device) -> dict:
    """The bf16 train path at full width: TRAIN_STEPS steps of global batch
    TRAIN_BATCH (``drive_train``), then the gradient check on one
    microbatch."""
    import torch

    from repro_torch import configs

    cfg = configs.get_config(TRAIN_ARCH)
    check(cfg.remat == "full" and cfg.kv_chunk == CONFIG_KV_CHUNK
          and cfg.compute_dtype == "bfloat16", f"train config {cfg}")
    params, out = drive_train(cfg, TRAIN_BATCH, TRAIN_STEPS, device)
    out["gradient_check"] = check_train_gradient(cfg, params, device)
    del params
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 3f
# the train step in f32 at full width: qwen1.5-0.5b scaled to compute
# dtype f32 (the dtype the train launcher gives its smoke mode; remat
# full, kv_chunk 1024 as configured), global batch 4 x 2048 in 2
# microbatches of 2 x 2048, 2 steps, compressed as phase 3d; its attention
# runs through flash_attention_f32 and the f32 backward kernel
TRAIN_F32_BATCH = 4
TRAIN_F32_STEPS = 2
# the port's f32 gradient bar: each leaf within 1e-4 max|g| of that leaf
# of the plain path's gradient; the loss within 1e-6 relative
TRAIN_F32_GRAD_REL = 1e-4
TRAIN_F32_LOSS_REL = 1e-6


def f64_attention(q, k, v, causal: bool = True, *, kv_tile, window=0):
    """``ops.flash_attention``'s signature over attention computed in f64
    and differentiated by autograd; a window (causal, T = S) keeps the
    keys j with 0 <= i - j < window."""
    import torch

    D = q.shape[-1]
    g = q.shape[2] // k.shape[2]
    k, v = (x.repeat_interleave(g, dim=2) for x in (k, v))
    s = torch.einsum("bthd,bshd->bhts", q, k) * D ** -0.5
    if causal:
        i = torch.arange(s.shape[-1], device=q.device)
        d = i[:, None] - i[None, :]
        keep = (d >= 0) & (d < window) if window else d >= 0
        s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhts,bshd->bthd", s.softmax(-1), v)


def f64_gradient(cfg, params, device, seq: int = TRAIN_CHECK_SEQ,
                 rows: int = 1) -> tuple:
    """(loss, gradient) of the model in f64 (``f64_attention`` in place of
    the flash attention, rwkv6's recurrence ``ref.wkv6_ref`` in f64 under
    autograd; the loss's logits are cast to f32, as
    ``nn.cross_entropy_loss`` casts them) at ``check_batch``: the
    yardstick of the f32 gradient check where the f32 plain path itself
    is further from the exact gradient than that check's bar."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.train import steps

    def wkv6(r, k, v, w, u, state=None):
        return ref.wkv6_ref(r, k, v, w, u, state, dtype=torch.float64)

    saved = ops.flash_attention, ops.wkv6
    ops.flash_attention, ops.wkv6 = f64_attention, wkv6
    try:
        return steps.value_and_grad(cfg.scaled(compute_dtype="float64"),
                                    params,
                                    check_batch(cfg, device, seq, rows))
    finally:
        ops.flash_attention, ops.wkv6 = saved


def check_train_gradient_f32(cfg, params, device, plain=None,
                             seq: int = TRAIN_CHECK_SEQ, rows: int = 1,
                             exact=None) -> dict:
    """One microbatch of ``rows`` x ``seq`` at full width in f32: the
    loss and every leaf's gradient on the kernels (the transformer's
    flash_attention_f32 and the f32 backward; rwkv6's wkv6 pair) against
    the same on the plain versions (``plain``, or ``plain_f32_gradient``'s
    here): the loss within TRAIN_F32_LOSS_REL relative, each leaf within
    TRAIN_F32_GRAD_REL max|g| of that leaf.  With ``exact`` (the f64
    gradient, ``f64_gradient``), a leaf further than that from the plain
    path passes if its error from the f64 gradient is at most twice the
    plain path's (where the plain f32 gradient is itself about the bar
    from the exact one, two correct f32 orders differ by more than the
    bar); every leaf's two errors from f64 are logged."""
    from repro_torch.train import steps

    lk, gk = steps.value_and_grad(cfg, params,
                                  check_batch(cfg, device, seq, rows))
    lp, gp = (plain_f32_gradient(cfg, params, device, seq, rows)
              if plain is None else plain)
    lk, lp = float(lk), float(lp)
    loss_rel = abs(lk - lp) / abs(lp)
    check(math.isfinite(lk) and loss_rel <= TRAIN_F32_LOSS_REL,
          f"train f32 gradient check: loss {lk} on the kernels, {lp} plain "
          f"({loss_rel:.3e} relative)")
    ge = [None] * len(_leaves(gk)) if exact is None else _leaves(exact[1])
    rels, vs_exact = [], []
    for i, (a, b, e) in enumerate(zip(_leaves(gk), _leaves(gp), ge)):
        gmax = float(b.abs().max())
        rel = float((a - b).abs().max()) / max(gmax, 1e-30)
        rels.append(rel)
        ek = ep = None
        if e is not None:
            emax = max(float(e.abs().max()), 1e-300)
            ek = float((a.double() - e.double()).abs().max()) / emax
            ep = float((b.double() - e.double()).abs().max()) / emax
            vs_exact.append((ek, ep))
        check(rel <= TRAIN_F32_GRAD_REL or (ek is not None and ek <= 2 * ep),
              f"train f32 gradient check leaf {i}: {rel:.3e} max|g| from the "
              f"plain path" + ("" if ek is None else
                               f"; from f64 kernels {ek:.3e}, plain {ep:.3e}"))
    coarse = [i for i, r in enumerate(rels) if r > TRAIN_F32_GRAD_REL]
    log(f"train gradient check ({rows} x {seq}, f32, kernels against "
        f"the plain versions): loss {lk} / {lp} ({loss_rel:.3e} relative, bar "
        f"{TRAIN_F32_LOSS_REL:g}); leaf max |diff| {min(rels):.3e}-"
        f"{max(rels):.3e} max|g| (bar {TRAIN_F32_GRAD_REL:g})"
        + (f"; from the f64 gradient, kernels / plain per leaf "
           + ", ".join(f"{k:.2e} / {p:.2e}" for k, p in vs_exact)
           + f"; leaves {coarse} over the bar, held to 2x the plain path's "
           f"error from f64" if vs_exact else ""))
    return {"loss_kernels": lk, "loss_plain": lp, "loss_rel": loss_rel,
            "leaf_rel": rels, "leaf_vs_f64": vs_exact,
            "leaves_held_to_f64": coarse}


def run_train_f32_phase(device) -> dict:
    """The f32 train path at full width: TRAIN_F32_STEPS steps of global
    batch TRAIN_F32_BATCH (``drive_train``), then the f32 gradient check on
    one microbatch."""
    import torch

    from repro_torch import configs

    cfg = configs.get_config(TRAIN_ARCH).scaled(compute_dtype="float32")
    check(cfg.remat == "full" and cfg.kv_chunk == CONFIG_KV_CHUNK,
          f"train config {cfg}")
    params, out = drive_train(cfg, TRAIN_F32_BATCH, TRAIN_F32_STEPS, device)
    out["gradient_check"] = check_train_gradient_f32(cfg, params, device)
    del params
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 3e
# the train step across 2 client ranks on the one card (gloo), each rank
# holding full-width qwen1.5-0.5b and its AdamW state: global batch
# 4 x 2048 (2 per rank), irwin_hall fused b = 8, two steps
TRAIN_RANKS = 2
TRAIN_RANK_BATCH = 4
TRAIN_RANK_STEPS = 2
TRAIN_RANK_SIGMA = 5e-3
TRAIN_RANK_TIMEOUT = 420.0


def train_rank_main(rank: int, n: int, port: int, device: str,
                    results) -> None:
    """One client rank of the train step: the same initial state on every
    rank (seed 0), its slice of each global batch, ``compress_tree(axis=
    group)`` inside ``build_train_step(group=)``; reports per step the
    wall (between two barriers), the loss, a digest of the params, and
    the launches and peak memory of the steps."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.train import steps

    try:
        device = torch.device(device)
        torch.cuda.set_device(device)
        dist.init_process_group(RANK_BACKEND,
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=n)
        group = dist.group.WORLD
        cfg = configs.get_config(TRAIN_ARCH)
        tc = steps.TrainConfig(optimizer="adamw", lr=3e-4,
                               compression=_train_comp("irwin_hall",
                                                       TRAIN_RANK_SIGMA))
        state = steps.init_train_state(cfg, tc, 0, device)
        dc = synthetic.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_RANK_BATCH, kind="lm")
        step_fn = steps.build_train_step(cfg, tc, group)
        out = {"rank": rank, "backend": dist.get_backend(group),
               "init_digest": _digest(_leaves(state["params"])),
               "walls": [], "losses": [], "digests": []}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        for i in range(TRAIN_RANK_STEPS):
            batch = synthetic.lm_batch(dc, i, device=device)
            dist.barrier()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch, TRAIN_SEED)
            torch.cuda.synchronize()
            dist.barrier()
            out["walls"].append(time.perf_counter() - t0)
            out["losses"].append(float(m["loss"]))
            out["digests"].append(_digest(_leaves(state["params"])))
            out["cohort"] = int(m["cohort"])
        out["launches"] = read_launches()
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        results.put(out)
    except BaseException:  # reported to the parent, then re-raised
        import traceback

        results.put({"rank": rank, "error": traceback.format_exc()})
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def start_train_ranks(device) -> dict:
    """Spawn TRAIN_RANKS client ranks on the card, TRAIN_RANK_STEPS steps
    each (2 x 21.6 GiB, mostly on the card), to run beside phases 3o and
    3p (whisper, 10 GiB at most) until ``run_train_ranks_phase``."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    port = free_port()
    return {"t0": time.perf_counter(),
            "started": _spawn_start(
                train_rank_main,
                lambda r: (r, TRAIN_RANKS, port, str(device)), TRAIN_RANKS)}


def run_train_ranks_phase(spawn: dict) -> dict:
    """``start_train_ranks``'s ranks collected.  Checks: every rank's
    params bitwise equal to rank 0's after each step (and at the start),
    finite losses, the cohort, each rank's launches (one microbatch a
    step: per layer forward, remat forward and backward flash launches;
    one fused encode and decode per leaf)."""
    from repro_torch import configs

    got = _spawn_collect(spawn["started"], TRAIN_RANKS, TRAIN_RANK_TIMEOUT)
    spawn_wall = time.perf_counter() - spawn["t0"]
    errors = [g["error"] for g in got if "error" in g]
    check(not errors, "train rank failed:\n" + "\n".join(errors))
    check(len(got) == TRAIN_RANKS, f"{TRAIN_RANKS - len(got)} train ranks "
                                   f"gave no result")
    by_rank = {g["rank"]: g for g in got}
    per_step = train_launches_expected(configs.get_config(TRAIN_ARCH), 1)
    for r, g in by_rank.items():
        check(g["backend"] == RANK_BACKEND, f"backend {g['backend']}")
        check(g["init_digest"] == by_rank[0]["init_digest"],
              f"train rank {r}: initial params differ from rank 0's")
        check(g["digests"] == by_rank[0]["digests"],
              f"train rank {r}: params differ from rank 0's")
        check(g["losses"] == by_rank[0]["losses"]
              and all(math.isfinite(x) for x in g["losses"]),
              f"train rank {r}: losses {g['losses']}")
        check(g["cohort"] == TRAIN_RANKS, f"cohort {g['cohort']}")
        for k, v in g["launches"].items():
            want = TRAIN_RANK_STEPS * per_step.get(k, 0)
            check(v == want, f"train rank {r}: {v} {k} launches, expected "
                             f"{want}")
    res = {"ranks": TRAIN_RANKS, "backend": RANK_BACKEND,
           "walls_s": {r: by_rank[r]["walls"] for r in by_rank},
           "losses": by_rank[0]["losses"],
           "peak_gib": {r: by_rank[r]["peak_bytes"] / 2**30 for r in by_rank},
           "launches_per_rank": by_rank[0]["launches"],
           "spawn_to_exit_s": spawn_wall}
    log(f"train across {TRAIN_RANKS} ranks ({RANK_BACKEND}), irwin_hall "
        f"fused b = {BITS}, batch {TRAIN_RANK_BATCH} x {TRAIN_SEQ}: step "
        f"walls per rank {json.dumps({r: [round(w, 3) for w in ws] for r, ws in res['walls_s'].items()})} s, "
        f"losses {res['losses']}, peak "
        f"{json.dumps({r: round(p, 2) for r, p in res['peak_gib'].items()})}"
        f" GiB per rank, launches per rank {res['launches_per_rank']}; "
        f"params bitwise equal across ranks after every step")
    return res


SERVE_ARCH = "qwen1.5-0.5b"
SERVE_REQUESTS = 16
SERVE_SLOTS = 8
SERVE_PREFILL = 2048
SERVE_GEN = 64
MARGIN = 1e-4  # a differing greedy token is a tie below this top-2 margin


def serve_model(device):
    """qwen1.5-0.5b at full width: the port's specs (their element count
    must be D_FULL) and init law from a seeded generator on the card, in
    f32 (the config's param dtype)."""
    from repro_torch import configs
    from repro_torch.launch import serve as launch
    from repro_torch.models import nn, registry

    cfg = configs.get_config(SERVE_ARCH)
    specs = registry.param_specs(cfg)
    check(nn.spec_numel(specs) == D_FULL,
          f"{SERVE_ARCH} specs hold {nn.spec_numel(specs)} parameters")
    model = launch.build_model(cfg.scaled(compute_dtype="float32"), 0, device)
    n = sum(p.numel() for p in model.parameters())
    check(n == D_FULL, f"{SERVE_ARCH} model holds {n} parameters")
    return cfg, model


def serve_requests(cfg, n: int, seed: int = 1) -> list:
    """``n`` requests with prompt lengths uniform in [256, 2048] and
    ``max_gen`` 64, every fourth 8 (so slots free and refill mid-flight),
    from ``numpy.random.default_rng(seed)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.integers(256, SERVE_PREFILL + 1, size=n)
    return [(r, rng.integers(0, cfg.vocab, size=(int(p),), dtype=np.int32),
             8 if r % 4 == 3 else SERVE_GEN) for r, p in enumerate(lengths)]


def serve_launches_expected(cfg, stats: dict) -> dict:
    """Launches of a ``drive`` run: the transformer's bf16 flash kernel
    once per layer per prefill; rwkv6's wkv6_step once per layer per
    decode call (each prompt token is one, and each engine step one over
    the slots); zamba2 none (its decode attention and Mamba2 steps are
    plain PyTorch, as the reference's); nothing else."""
    if cfg.kind == "zamba2":
        return {}
    if cfg.kind == "rwkv6":
        return {"wkv6_step": cfg.n_layers * (stats["prompt_tokens"]
                                             + stats["steps"])}
    return {"flash_attention_sm90": cfg.n_layers * stats["prefills"]}


def run_serve(cfg, model, device, n_requests: int = SERVE_REQUESTS,
              requests=None, warm_len: int = 256,
              max_prefill_len: int = SERVE_PREFILL) -> dict:
    """The serve path in the config's compute dtype (bf16; ``model`` cast
    to it, the values the reference's cast at use gives): ``n_requests``
    requests (``serve_requests``, or ``requests``) through
    ``launch.serve.drive`` on 8 slots, with the launch counts set to 0
    just before and read just after and checked against
    ``serve_launches_expected`` (a warm-up of 2 requests of ``warm_len``
    prompt tokens first); the engine takes prompts of up to
    ``max_prefill_len``."""
    import statistics

    import torch

    from repro_torch.launch import serve as launch
    from repro_torch.serve import ServeEngine

    engine = ServeEngine(cfg, max_slots=SERVE_SLOTS,
                         max_prefill_len=max_prefill_len,
                         max_gen_len=SERVE_GEN, device=device)
    launch.drive(engine, model, [(r, toks[:warm_len], 4) for r, toks, _ in
                                 serve_requests(cfg, 2, seed=9)])
    if requests is None:
        requests = serve_requests(cfg, n_requests)
    n_requests = len(requests)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    outputs, stats = launch.drive(engine, model, requests)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(stats["prefills"] == n_requests, f"serve: {stats['prefills']} "
          f"prefills for {n_requests} requests")
    expected = serve_launches_expected(cfg, stats)
    for k, v in launches.items():
        want = expected.get(k, 0)
        check(v == want, f"serve path: {v} {k} launches, expected {want}")
    for rid, toks, max_gen in requests:
        out = outputs[rid]
        check(len(out) == max_gen, f"serve rid {rid}: {len(out)} tokens, "
              f"expected {max_gen}")
        check(all(0 <= t < cfg.vocab for t in out), f"serve rid {rid}: "
              f"token out of range")
    res = {
        "launches": launches, "peak_bytes": peak,
        "tokens_per_s": stats["tokens_per_s"],
        "step_ms_median": statistics.median(stats["step_ms"]),
        "prefill_s_per_1k": 1e3 * stats["prefill_s"] / stats["prompt_tokens"],
        **{k: stats[k] for k in ("steps", "tokens_out", "wall_s",
                                 "mean_occupancy", "prefills",
                                 "prompt_tokens", "prefill_s")}}
    log(f"serve {cfg.name} ({cfg.n_layers} layers, {cfg.compute_dtype}): "
        f"{n_requests} requests, {stats['prompt_tokens']} prompt tokens, "
        f"{stats['tokens_out']} tokens out in {stats['steps']} steps, "
        f"{stats['wall_s']:.3f} s: {stats['tokens_per_s']:.1f} tokens/s, "
        f"median decode step {res['step_ms_median']:.3f} ms, prefill "
        f"{res['prefill_s_per_1k']:.4f} s per 1k prompt tokens, mean "
        f"occupancy {stats['mean_occupancy']:.3f}, peak "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    del engine
    torch.cuda.empty_cache()
    return res


def _kernel_ms(prof, reps: int) -> list:
    """(name, ms per rep) of the device-side events of a finished
    ``torch.profiler`` trace (kernels, copies, sets), summed by name,
    largest first.  Read from the trace's raw events: ``prof.events()`` and
    ``key_averages()`` first turn every event into a Python object, which
    took a minute for a traced train step."""
    from torch.autograd import DeviceType

    totals: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU and e.duration_ns() > 0:
            totals[e.name()] = (totals.get(e.name(), 0.0)
                                + e.duration_ns() / 1e6 / reps)
    return sorted(totals.items(), key=lambda kv: -kv[1])


def _op_device_ms(prof) -> list:
    """(name, input shapes, device ms) of each op of a finished trace that
    launched kernels itself: the device events linked to it by its
    correlation id, as ``torch.profiler`` attaches kernels to the
    launching op (its self device time), from the raw events."""
    from torch.autograd import DeviceType

    launched: dict = {}  # correlation id -> device ns of its kernels
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU:
            corr = e.linked_correlation_id()
            if corr > 0:
                launched[corr] = launched.get(corr, 0) + e.duration_ns()
        elif e.linked_correlation_id() == 0 and not e.is_async():
            ops.append(e)
    return [(e.name(), e.shapes(), launched[e.correlation_id()] / 1e6)
            for e in ops if e.correlation_id() in launched]


def profile_serve(cfg, model, device, n_prefills: int = 2,
                  n_steps: int = 4) -> dict:
    """Where the serve path's time goes: ``n_prefills`` prefills of 1024
    tokens and, with all 8 slots active, ``n_steps`` decode steps, each
    window run first without and then under ``torch.profiler`` (CPU +
    CUDA).  For each window: the unprofiled wall ms (host clock, ended by
    a synchronize),
    the profiled wall ms (the profiler's own host cost included), the
    device's busy ms (the sum of the device-side rows of the trace:
    kernels and copies on one stream), its idle share against the
    unprofiled wall of the same work, the bf16 flash kernel's ms
    (flash_attention_sm90), of the cuBLAS GEMMs (``GEMM_TAGS``: the
    projections, and for moe the expert products) and the five largest
    kernels.  ``model`` is in the compute dtype.  A failure here,
    or a trace with no device time, fails the run.  After the counted
    run: the launches here are not the path's."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServeEngine

    engine = ServeEngine(cfg, max_slots=SERVE_SLOTS,
                         max_prefill_len=SERVE_PREFILL,
                         max_gen_len=SERVE_GEN, device=device)
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab, size=(SERVE_SLOTS, 1024),
                           dtype=np.int32)
    state = engine.init_state()
    for i in range(SERVE_SLOTS):
        _, prefix = engine.prefill(model, prompts[i])
        state = engine.insert(state, prefix, i)
    state, _, _ = engine.generate_step(model, state)  # warm

    def window(fn, reps: int) -> dict:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_prof = (time.perf_counter() - t0) * 1e3 / reps
        dev = _kernel_ms(prof, reps)
        check(bool(dev), "serve profile: the trace holds no device time")
        busy = sum(ms for _, ms in dev)
        flash = sum(ms for k, ms in dev if "flash_attention_sm90" in k)
        gemm = sum(ms for k, ms in dev
                   if any(t in k.lower() for t in GEMM_TAGS))
        return {"wall_ms": wall, "wall_profiled_ms": wall_prof,
                "device_ms": busy, "idle_share": 1.0 - busy / wall,
                "flash_attention_sm90_ms": flash, "gemm_ms": gemm,
                "top": dev[:5]}

    out = {"prefill_1024": window(lambda: engine.prefill(model, prompts[0]),
                                  n_prefills)}
    holder = [state]

    def step():
        holder[0], _, _ = engine.generate_step(model, holder[0])

    out["decode_step"] = window(step, n_steps)
    for name, w in out.items():
        log(f"serve profile {cfg.name} {name}: wall {w['wall_ms']:.3f} ms "
            f"(profiled {w['wall_profiled_ms']:.3f} ms), device busy "
            f"{w['device_ms']:.3f} ms (idle share {w['idle_share']:.3f}), "
            f"flash_attention_sm90 {w['flash_attention_sm90_ms']:.3f} ms, "
            f"GEMMs {w['gemm_ms']:.3f} ms; top "
            + "; ".join(f"{k[:60]} {ms:.3f}" for k, ms in w["top"]))
    del engine, state, holder
    torch.cuda.empty_cache()
    return out


def _margins(logits):
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def check_serve_f32(cfg, model32, device, n_prompt: int = 512,
                    n_gen: int = 16) -> dict:
    """In f32: the engine's tokens equal the naive loop's for 2 prompts,
    and a teacher-forced full forward (flash kernel) re-derives the naive
    loop's greedy tokens (plain decode attention).  A differing token is
    allowed only where the top-2 margin of the teacher-forced logits there
    is below MARGIN, once in all; the rest of an engine row is not
    compared after it (its history differs).  The launch counts are set to
    0 just before and read just after: four full forwards (the naive
    loop's batched prefill, two engine prefills, the teacher-forced
    forward) launch the f32 flash kernel once per layer each, and nothing
    else launches."""
    import numpy as np
    import torch

    from repro_torch.models import registry
    from repro_torch.serve import ServeEngine, naive_generate

    cfg = cfg.scaled(compute_dtype="float32")
    rng = np.random.default_rng(2)
    torch.cuda.synchronize()
    reset_launches()
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(2, n_prompt), dtype=np.int32),
        device=device)
    naive = naive_generate(cfg, model32, {"tokens": prompts}, n_gen)
    engine = ServeEngine(cfg, max_slots=2, max_prefill_len=n_prompt,
                         max_gen_len=n_gen, device=device)
    state = engine.init_state()
    for i in range(2):
        _, prefix = engine.prefill(model32, prompts[i])
        state = engine.insert(state, prefix, i, max_gen=n_gen)
    outs = [state["tokens"].clone()]
    for _ in range(n_gen - 1):
        state, tok, _ = engine.generate_step(model32, state)
        outs.append(tok)
    eng = torch.stack(outs, dim=1)
    full = torch.cat([prompts, naive[:, :-1]], dim=1)
    with torch.no_grad():
        logits = registry.logits_fn(cfg, model32, {"tokens": full})
    tail = logits[:, n_prompt - 1:]
    torch.cuda.synchronize()
    launches = read_launches()
    for k, v in launches.items():
        want = 4 * cfg.n_layers if k == "flash_attention_f32" else 0
        check(v == want, f"serve f32 checks: {v} {k} launches, expected "
              f"{want}")
    check(bool(torch.isfinite(tail).all()), "f32 forward: non-finite logits")
    forced = torch.clamp(tail.argmax(dim=-1), 0, cfg.vocab - 1)
    margin = _margins(tail).cpu()
    naive_h, eng_h, forced_h = (t.cpu().numpy() for t in (naive, eng, forced))
    ties = []

    def tie(what, b, t):
        m = float(margin[b, t])
        log(f"{what}: row {b} token {t} differs; top-2 margin {m:.3g}")
        check(m < MARGIN, f"{what}: row {b} token {t} differs with top-2 "
              f"margin {m} >= {MARGIN}")
        ties.append({"check": what, "row": b, "token": t, "margin": m})

    for b in range(2):
        for t in np.flatnonzero(forced_h[b] != naive_h[b]):
            tie("teacher-forced forward vs naive", b, int(t))
        diff = np.flatnonzero(eng_h[b] != naive_h[b])
        if diff.size:
            tie("engine vs naive", b, int(diff[0]))
    check(len(ties) <= 1, f"{len(ties)} differing tokens; at most 1 allowed")
    log(f"serve f32 checks: engine == naive and teacher-forced forward == "
        f"naive for 2 x {n_prompt} prompt tokens x {n_gen} generated "
        f"({len(ties)} tie(s)); smallest top-2 margin "
        f"{float(margin.min()):.4g}; launches {launches}")
    del logits, tail, engine, state
    torch.cuda.empty_cache()
    return {"ties": ties, "min_margin": float(margin.min()),
            "tokens": naive_h.tolist(), "launches": launches}


# ------------------------------------------------------------ phase 3g
# the moe family served at full width (widths, heads, experts, top-k and
# vocab as published), depth cut to what the card holds in bf16 beside
# the KV cache: phi3.5-moe's layer is 1,300.3 M parameters (2.42 GiB),
# its embedding and lm_head (vocab padded to 32,128) 0.49 GiB, so its 32
# layers would be 78.0 GiB of weights alone; 24 are 58.6 GiB.  dbrx's
# layer is 3,259.1 M (6.07 GiB), its embedding and lm_head 2.30 GiB: 8
# of its 40 layers are 50.9 GiB.  (arch, layers, requests)
MOE_SERVE = (("phi3.5-moe-42b-a6.6b", 24, SERVE_REQUESTS),
             ("dbrx-132b", 8, 4))
# the f32 checks: each model at full width and 4 layers, one request per
# call (a B = 1 prefill routes the same tokens in the engine and the
# naive loop; a decode step of 2 slots or 1 row cannot drop a choice:
# C = 8 and an expert gets at most one choice a token)
MOE_F32_LAYERS = 4
MOE_F32_PROMPT = 512
MOE_F32_GEN = 16


def moe_config(arch: str, layers: int):
    from repro_torch import configs

    cfg = configs.get_config(arch)
    check(cfg.kind == "moe" and cfg.compute_dtype == "bfloat16"
          and cfg.kv_chunk == CONFIG_KV_CHUNK, f"{arch} config {cfg}")
    return cfg.scaled(n_layers=layers)


def build_checked(cfg, device):
    """``launch.serve.build_model`` (seed 0, layer by layer in the compute
    dtype), its parameter count checked against the specs'."""
    from repro_torch.launch import serve as launch
    from repro_torch.models import nn, registry

    model = launch.build_model(cfg, 0, device)
    n = sum(p.numel() for p in model.parameters())
    want = nn.spec_numel(registry.param_specs(cfg))
    check(n == want, f"{cfg.name} model holds {n} parameters, specs {want}")
    held(f"with {cfg.name} at {cfg.n_layers} layers in {cfg.compute_dtype} "
         f"({n:,} parameters)")
    return model


class count_drops:
    """Within the block, ``models.moe.route`` is wrapped so that every MoE
    block's dropped-choice count is recorded (a 0-dim tensor on the
    device, read only by ``total()``, which sums them)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.drops, self._route = [], moe.route

        def route(*args):
            out = self._route(*args)
            self.drops.append((~out[3]).sum())
            return out

        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self._route
        return False

    def total(self) -> int:
        return int(sum(int(d) for d in self.drops))


def check_serve_moe_f32(arch: str, device) -> dict:
    """In f32 at full width and MOE_F32_LAYERS layers, one request per
    call: for 2 prompts of MOE_F32_PROMPT tokens, the naive loop (B = 1)
    and the engine (2 slots) give the same MOE_F32_GEN tokens (a differing
    token only at a top-2 margin below MARGIN, once in all, as the dense
    check).  A teacher-forced full forward (B = 1, prompt plus the
    generated prefix) routes another number of tokens, so another C and
    other drops: its agreement with the naive loop is reported beside both
    sides' dropped-choice counts and held only where neither side dropped
    a choice.  Launches: six full forwards (2 naive prefills, 2 engine
    prefills, 2 teacher-forced) of flash_attention_f32 per layer, nothing
    else."""
    import numpy as np
    import torch

    from repro_torch.models import registry
    from repro_torch.serve import ServeEngine, naive_generate

    cfg = moe_config(arch, MOE_F32_LAYERS).scaled(compute_dtype="float32")
    model = build_checked(cfg, device)
    rng = np.random.default_rng(2)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(2, MOE_F32_PROMPT), dtype=np.int32),
        device=device)
    torch.cuda.synchronize()
    reset_launches()
    naive, naive_drops = [], []
    for i in range(2):
        with count_drops() as d:
            naive.append(naive_generate(cfg, model,
                                        {"tokens": prompts[i:i + 1]},
                                        MOE_F32_GEN))
        naive_drops.append(d.total())
    naive = torch.cat(naive)
    engine = ServeEngine(cfg, max_slots=2, max_prefill_len=MOE_F32_PROMPT,
                         max_gen_len=MOE_F32_GEN, device=device)
    state = engine.init_state()
    with count_drops() as d:
        for i in range(2):
            _, prefix = engine.prefill(model, prompts[i])
            state = engine.insert(state, prefix, i, max_gen=MOE_F32_GEN)
        prefill_drops = d.total()
        outs = [state["tokens"].clone()]
        for _ in range(MOE_F32_GEN - 1):
            state, tok, _ = engine.generate_step(model, state)
            outs.append(tok)
        step_drops = d.total() - prefill_drops
    eng = torch.stack(outs, dim=1)
    forced, forced_drops, margins = [], [], []
    for i in range(2):
        full = torch.cat([prompts[i:i + 1], naive[i:i + 1, :-1]], dim=1)
        with torch.no_grad(), count_drops() as d:
            tail = registry.logits_fn(cfg, model, {"tokens": full})[
                :, MOE_F32_PROMPT - 1:]
        forced_drops.append(d.total())
        check(bool(torch.isfinite(tail).all()),
              f"{arch} f32 forward: non-finite logits")
        forced.append(torch.clamp(tail.argmax(dim=-1), 0, cfg.vocab - 1))
        margins.append(_margins(tail).cpu())
    torch.cuda.synchronize()
    launches = read_launches()
    for k, v in launches.items():
        want = 6 * cfg.n_layers if k == "flash_attention_f32" else 0
        check(v == want, f"{arch} serve f32 checks: {v} {k} launches, "
                         f"expected {want}")
    check(step_drops == 0, f"{arch}: an engine decode step dropped "
                           f"{step_drops} choices")
    check(prefill_drops == sum(naive_drops), f"{arch}: the engine's "
          f"prefills dropped {prefill_drops} choices, the naive loop "
          f"{naive_drops}")
    naive_h, eng_h = naive.cpu().numpy(), eng.cpu().numpy()
    ties, agree = [], []
    for b in range(2):
        diff = np.flatnonzero(eng_h[b] != naive_h[b])
        if diff.size:
            m = float(margins[b][0, diff[0]])
            log(f"{arch} engine vs naive: row {b} token {diff[0]} differs; "
                f"top-2 margin {m:.3g}")
            check(m < MARGIN, f"{arch} engine vs naive: row {b} token "
                              f"{diff[0]} differs with top-2 margin {m}")
            ties.append({"row": b, "token": int(diff[0]), "margin": m})
        same = forced[b][0].cpu().numpy() == naive_h[b]
        agree.append(float(same.mean()))
        if naive_drops[b] == 0 and forced_drops[b] == 0:
            for t in np.flatnonzero(~same):
                m = float(margins[b][0, t])
                check(m < MARGIN, f"{arch} teacher-forced vs naive, no "
                      f"drops: row {b} token {t} differs, margin {m}")
                ties.append({"row": b, "token": int(t), "margin": m,
                             "check": "teacher-forced"})
    check(len(ties) <= 1, f"{arch}: {len(ties)} differing tokens; at most "
                          f"1 allowed")
    min_margin = float(min(float(m.min()) for m in margins))
    log(f"serve {arch} f32 checks ({cfg.n_layers} layers, 2 x "
        f"{MOE_F32_PROMPT} prompt tokens x {MOE_F32_GEN}, one request per "
        f"call): engine == naive ({len(ties)} tie(s)); dropped choices: "
        f"naive prefills {naive_drops}, engine prefills {prefill_drops}, "
        f"engine decode steps {step_drops}, teacher-forced forwards "
        f"{forced_drops}; teacher-forced agreement with naive {agree}; "
        f"smallest top-2 margin {min_margin:.4g}; launches {launches}")
    del model, engine, state, tail
    torch.cuda.empty_cache()
    return {"ties": ties, "min_margin": min_margin, "launches": launches,
            "naive_drops": naive_drops, "engine_prefill_drops":
            prefill_drops, "engine_step_drops": step_drops,
            "forced_drops": forced_drops, "forced_agreement": agree,
            "tokens": naive_h.tolist()}


def run_serve_moe_phase(device) -> dict:
    """Phase 3g: each MOE_SERVE model built in bf16 at its depth cut
    (``build_checked``), ``run_serve`` with its requests (launches: one
    flash_attention_sm90 per layer per prefill, nothing else), phi3.5-moe
    also profiled (``profile_serve``); then each model's f32 checks."""
    import torch

    out = {}
    for arch, layers, n_requests in MOE_SERVE:
        cfg = moe_config(arch, layers)
        model = build_checked(cfg, device)
        res = run_serve(cfg, model, device, n_requests)
        if arch == MOE_SERVE[0][0]:
            res["profile"] = profile_serve(cfg, model, device)
        del model
        torch.cuda.empty_cache()
        out[arch] = res
    for arch, _, _ in MOE_SERVE:
        out[arch]["f32"] = check_serve_moe_f32(arch, device)
    return out


# ------------------------------------------------------------ phase 3h
# llava-next-mistral-7b uncut (32 layers, 7,258 M parameters, 13.5 GiB
# in bf16): prompts of its 576 stub patches plus 512-2048 text tokens
# through ``registry.prefill_fn``; in f32 one prompt's last-position
# logits on the kernels against the plain versions
LLAVA_ARCH = "llava-next-mistral-7b"
LLAVA_PROMPTS = 4
LLAVA_TEXT = (512, 2048)
LLAVA_LOGIT_REL = 1e-4  # of max|logit|


def llava_batches(cfg, device) -> list:
    """LLAVA_PROMPTS batches of one prompt: text lengths uniform in
    LLAVA_TEXT from ``numpy.random.default_rng(4)`` and the patch stub
    (``data.synthetic.with_frontend_stubs``, its default key)."""
    import numpy as np
    import torch

    from repro_torch.data import synthetic

    rng = np.random.default_rng(4)
    lengths = rng.integers(LLAVA_TEXT[0], LLAVA_TEXT[1] + 1,
                           size=LLAVA_PROMPTS)
    return [synthetic.with_frontend_stubs({"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(1, int(t)), dtype=np.int32),
        device=device)}, cfg) for t in lengths]


def run_llava_phase(device) -> dict:
    """Phase 3h.  f32 first: the first prompt's last-position logits
    through the kernels (flash_attention_f32 once per layer, counted)
    within LLAVA_LOGIT_REL max|logit| of the same on the plain versions
    (``plain_kernels``).  Then the bf16 model (the same seed: the f32
    weights rounded) prefills every prompt (launches: flash_attention_sm90
    once per layer per prompt, nothing else), each timed on the host clock
    after a synchronize, with finite logits and caches over patches and
    text."""
    import torch

    from repro_torch import configs
    from repro_torch.models import registry

    cfg = configs.get_config(LLAVA_ARCH)
    check(cfg.kind == "llava" and cfg.n_patches == 576
          and cfg.compute_dtype == "bfloat16", f"llava config {cfg}")
    cfg32 = cfg.scaled(compute_dtype="float32")
    model = build_checked(cfg32, device)
    batches = llava_batches(cfg, device)
    torch.cuda.synchronize()
    reset_launches()
    with torch.no_grad():
        got, _ = registry.prefill_fn(cfg32)(model, batches[0])
    torch.cuda.synchronize()
    f32_launches = read_launches()
    with torch.no_grad(), plain_kernels():
        want, _ = registry.prefill_fn(cfg32)(model, batches[0])
    for k, v in f32_launches.items():
        n = cfg.n_layers if k == "flash_attention_f32" else 0
        check(v == n, f"llava f32 prefill: {v} {k} launches, expected {n}")
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    check(bool(torch.isfinite(got).all()) and err <= LLAVA_LOGIT_REL,
          f"llava f32 last logits: {err:.3e} max|logit| from the plain "
          f"versions (bar {LLAVA_LOGIT_REL:g})")
    log(f"llava f32 prefill ({cfg.n_patches} patches + "
        f"{batches[0]['tokens'].shape[1]} tokens): last-position logits "
        f"within {err:.3e} max|logit| ({scale:.4g}) of the plain versions "
        f"(bar {LLAVA_LOGIT_REL:g}); launches {f32_launches}")
    del model, got, want
    torch.cuda.empty_cache()

    model = build_checked(cfg, device)
    prefill = registry.prefill_fn(cfg)
    with torch.no_grad():
        prefill(model, batches[-1])  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    walls, tokens = [], []
    for batch in batches:
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, (k, v) = prefill(model, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        T = cfg.n_patches + batch["tokens"].shape[1]
        tokens.append(T)
        check(tuple(k.shape) == (cfg.n_layers, 1, T, cfg.n_kv_heads, cfg.hd)
              and bool(torch.isfinite(logits).all()),
              f"llava prefill of {T} positions: caches {tuple(k.shape)}")
        del logits, k, v
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    for k, v in launches.items():
        n = cfg.n_layers * LLAVA_PROMPTS if k == "flash_attention_sm90" else 0
        check(v == n, f"llava prefill: {v} {k} launches, expected {n}")
    per_1k = 1e3 * sum(walls) / sum(tokens)
    log(f"llava prefill ({cfg.n_layers} layers, bf16): {LLAVA_PROMPTS} "
        f"prompts of {tokens} positions ({cfg.n_patches} patches each) in "
        f"{[round(w, 4) for w in walls]} s, {per_1k:.4f} s per 1k "
        f"positions, peak {peak / 2**30:.2f} GiB; launches {launches}")
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "walls_s": walls, "positions": tokens,
            "prefill_s_per_1k": per_1k, "peak_bytes": peak,
            "f32": {"launches": f32_launches, "logit_rel_err": err,
                    "max_logit": scale}}


# ------------------------------------------------------------ phase 3i
# phi3.5-moe trained at full width, depth cut to 1 of its 32 layers
# (1,563.5 M parameters, 23.3 GiB of f32 parameters, gradient and AdamW
# state).  2 layers (2,863.8 M, 42.7 GiB) do not fit: the optimizer's
# step is functional, so old and new parameters and moments (6 x 10.67
# GiB) and the gradient (10.67 GiB) are live together, 74.7 GiB before
# the transients of its f64 multiply-adds and of the codec's int64
# threefry over the 838,860,800-coordinate expert leaves (6.25 GiB per
# such tensor).  bf16, remat full, kv_chunk 1024, AdamW lr 3e-4, lm data
# seed 0, global batch 4 x 2048 in 2 microbatches (C = 640 per layer and
# call), aggregate_gaussian fused b = 8 per-tensor, TRAIN_STEPS steps
TRAIN_MOE_ARCH = "phi3.5-moe-42b-a6.6b"
TRAIN_MOE_LAYERS = 1
TRAIN_MOE_BATCH = 4


def run_train_moe_phase(device) -> dict:
    """Phase 3i: ``drive_train`` on the moe config (launches per step from
    the spec tree, finite losses, peak; a timed and a traced step), then
    on 1 x TRAIN_CHECK_SEQ the bf16 gradient check against the f32 model
    (``check_train_gradient``) and the f32 check of the kernels against
    the plain versions (``check_train_gradient_f32``)."""
    import torch

    from repro_torch.models import moe

    cfg = moe_config(TRAIN_MOE_ARCH, TRAIN_MOE_LAYERS)
    check(cfg.remat == "full", f"train config {cfg}")
    C = moe.capacity(TRAIN_MOE_BATCH // TRAIN_ACCUM * TRAIN_SEQ, cfg)
    log(f"train {cfg.name}: capacity {C} slots per expert per layer and "
        f"microbatch")
    params, out = drive_train(cfg, TRAIN_MOE_BATCH, TRAIN_STEPS, device)
    plain32 = plain_f32_gradient(cfg, params, device)
    out["gradient_check"] = check_train_gradient(cfg, params, device, plain32)
    out["gradient_check_f32"] = check_train_gradient_f32(
        cfg.scaled(compute_dtype="float32"), params, device, plain32)
    del plain32
    del params
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 3j
# the three dense configs no earlier phase serves, in bf16 at full width
# (seeded random weights, built layer by layer in bf16): starcoder2-3b
# (LayerNorm, the GELU MLP with biases, tied embeddings, GQA 24 / 2 heads
# of 128) and minitron-4b (24 / 8 of 128, a 256,000-entry vocab) uncut;
# qwen3-32b (qk_norm, 64 / 8 of 128) uncut too: 64 layers of 487.6 M
# parameters and 1,555.8 M of embedding and head are 61.0 GiB in bf16,
# and 8 slots of 2,112 positions of KV cache 4.1 GiB.  Each serves
# DENSE_REQUESTS requests of 256-2048 prompt tokens and SERVE_GEN out, then
# its f32 token checks (``check_serve_f32``) at DENSE_F32_LAYERS layers
# (None: uncut)
DENSE_SERVE = ("starcoder2-3b", "minitron-4b", "qwen3-32b")
DENSE_REQUESTS = 8
DENSE_F32_LAYERS = {"starcoder2-3b": None, "minitron-4b": None,
                    "qwen3-32b": 4}


def dense_config(arch: str, layers=None, dtype=None):
    from repro_torch import configs

    cfg = configs.get_config(arch)
    check(cfg.kind == "dense" and cfg.compute_dtype == "bfloat16"
          and cfg.kv_chunk == CONFIG_KV_CHUNK, f"{arch} config {cfg}")
    if layers is not None:
        cfg = cfg.scaled(n_layers=layers)
    return cfg if dtype is None else cfg.scaled(compute_dtype=dtype)


def run_serve_dense_phase(device) -> dict:
    """Phase 3j: each DENSE_SERVE config built in bf16 (``build_checked``)
    and served (``run_serve``: DENSE_REQUESTS requests of 256-2048 prompt
    tokens and SERVE_GEN out each; one flash_attention_sm90 launch per
    layer per prefill, nothing else), then its f32 checks
    (``check_serve_f32``: engine = naive loop = teacher-forced forward, a
    differing token only at a top-2 margin below MARGIN)."""
    import torch

    out = {}
    for arch in DENSE_SERVE:
        cfg = dense_config(arch)
        model = build_checked(cfg, device)
        requests = [(r, toks, SERVE_GEN) for r, toks, _ in
                    serve_requests(cfg, DENSE_REQUESTS, seed=6)]
        res = run_serve(cfg, model, device, requests=requests)
        del model
        torch.cuda.empty_cache()
        cfg32 = dense_config(arch, DENSE_F32_LAYERS[arch], "float32")
        model32 = build_checked(cfg32, device)
        res["f32"] = check_serve_f32(cfg32, model32, device)
        res["f32"]["layers"] = cfg32.n_layers
        del model32
        torch.cuda.empty_cache()
        held(f"after serving {arch}")
        out[arch] = res
    return out


# ------------------------------------------------------------ phase 3k
# rwkv6-1.6b served uncut in bf16 (24 layers, 1,678.3 M parameters, 3.13
# GiB): every prompt token is one 24-layer decode step (35-56 ms on the
# host's launches), so the prompts are short, to keep the whole run near
# 800 s: RWKV_REQUESTS of RWKV_PROMPT tokens and SERVE_GEN out; then
# ``registry.prefill_fn`` (the scan path: one wkv6_fwd launch a layer)
# over RWKV_PREFILLS prompts of RWKV_PREFILL_LEN tokens; and the f32
# checks, uncut
RWKV_ARCH = "rwkv6-1.6b"
RWKV_REQUESTS = 8
RWKV_PROMPT = (16, 64)
RWKV_PREFILLS = 4
RWKV_PREFILL_LEN = (512, 2048)
RWKV_F32_PROMPT = 16
RWKV_F32_GEN = 8
RWKV_F32_SCAN = 512  # the f32 scan-path check's prompt
RWKV_LOGIT_REL = 1e-4  # of max|logit|


def rwkv6_config(layers=None, dtype=None):
    from repro_torch import configs

    cfg = configs.get_config(RWKV_ARCH)
    check(cfg.kind == "rwkv6" and cfg.compute_dtype == "bfloat16"
          and cfg.remat == "full", f"rwkv6 config {cfg}")
    if layers is not None:
        cfg = cfg.scaled(n_layers=layers)
    return cfg if dtype is None else cfg.scaled(compute_dtype=dtype)


def rwkv6_prompts(cfg, n: int, lengths: tuple, seed: int) -> list:
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = rng.integers(lengths[0], lengths[1] + 1, size=n)
    return [rng.integers(0, cfg.vocab, size=(int(p),), dtype=np.int32)
            for p in sizes]


def run_rwkv6_prefill(cfg, model, device) -> dict:
    """``registry.prefill_fn`` (the scan path) over RWKV_PREFILLS prompts
    of RWKV_PREFILL_LEN tokens, each timed on the host clock after a
    synchronize, launches counted (wkv6_fwd once per layer per prompt,
    nothing else), finite last logits and no cache.  After the counted
    run, the longest prompt once more under ``torch.profiler``: the
    device's busy ms, the chunked forward's ms (its three kernels), and
    the idle share against that prompt's unprofiled wall above."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import registry

    prefill = registry.prefill_fn(cfg)
    prompts = [torch.as_tensor(p[None], device=device) for p in
               rwkv6_prompts(cfg, RWKV_PREFILLS, RWKV_PREFILL_LEN, seed=8)]
    with torch.no_grad():
        prefill(model, {"tokens": prompts[-1]})  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    walls = []
    for tokens in prompts:
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, cache = prefill(model, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(cache is None and tuple(logits.shape) == (
            1, 1, cfg.padded_vocab) and bool(torch.isfinite(logits).all()),
            f"rwkv6 prefill of {tokens.shape[1]}: {tuple(logits.shape)}")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    for k, v in launches.items():
        n = cfg.n_layers * RWKV_PREFILLS if k == "wkv6_fwd" else 0
        check(v == n, f"rwkv6 prefill: {v} {k} launches, expected {n}")
    lengths = [int(t.shape[1]) for t in prompts]
    per_1k = 1e3 * sum(walls) / sum(lengths)
    longest = max(range(len(prompts)), key=lambda i: lengths[i])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            prefill(model, {"tokens": prompts[longest]})
        torch.cuda.synchronize()
    dev = _kernel_ms(prof, 1)
    check(bool(dev), "rwkv6 prefill profile: the trace holds no device time")
    wall_ms = 1e3 * walls[longest]
    busy = sum(ms for _, ms in dev)
    prof_row = {"tokens": lengths[longest], "wall_ms": wall_ms,
                "device_ms": busy, "idle_share": 1.0 - busy / wall_ms,
                "wkv_ms": sum(ms for k, ms in dev if WKV_FWD_TAG in k),
                "top": dev[:5]}
    log(f"rwkv6 prefill_fn ({cfg.n_layers} layers, {cfg.compute_dtype}, the "
        f"scan path): prompts of {lengths} tokens in "
        f"{[round(w, 4) for w in walls]} s, {per_1k:.4f} s per 1k tokens, "
        f"peak {peak / 2**30:.2f} GiB; launches {launches}; the "
        f"{lengths[longest]}-token prompt profiled: device busy "
        f"{busy:.3f} ms of its {wall_ms:.3f} ms wall (idle share "
        f"{prof_row['idle_share']:.3f}), wkv6_fwd {prof_row['wkv_ms']:.3f} "
        f"ms")
    return {"launches": launches, "walls_s": walls, "tokens": lengths,
            "prefill_s_per_1k": per_1k, "peak_bytes": peak,
            "profile": prof_row}


def check_serve_rwkv6_f32(device) -> dict:
    """rwkv6 uncut in f32.  (1) For 2 prompts of RWKV_F32_PROMPT tokens the
    engine (2 slots) and the naive loop, one request per call, give the
    same RWKV_F32_GEN tokens (a differing token only at a top-2 margin
    below MARGIN, once); (2) the engine's prefill of the first prompt is
    bitwise its own chain of ``registry.serve_fn`` calls (logits and every
    state leaf); (3) ``registry.prefill_fn`` (the scan path) on
    RWKV_F32_SCAN tokens: the last logits on the kernels within
    RWKV_LOGIT_REL max|logit| of the same on the plain versions.  Launches
    over (1) and (2): wkv6_step once per layer per decode call; (3) once
    per layer."""
    import numpy as np
    import torch

    from repro_torch.models import registry
    from repro_torch.serve import ServeEngine, naive_generate

    cfg = rwkv6_config(dtype="float32")
    model = build_checked(cfg, device)
    prompts = [torch.as_tensor(p, device=device) for p in rwkv6_prompts(
        cfg, 2, (RWKV_F32_PROMPT, RWKV_F32_PROMPT), seed=2)]
    torch.cuda.synchronize()
    reset_launches()
    naive = torch.cat([naive_generate(cfg, model, {"tokens": p[None]},
                                      RWKV_F32_GEN) for p in prompts])
    engine = ServeEngine(cfg, max_slots=2, max_prefill_len=RWKV_F32_PROMPT,
                         max_gen_len=RWKV_F32_GEN, device=device)
    state = engine.init_state()
    prefixes = []
    for i in range(2):
        _, prefix = engine.prefill(model, prompts[i])
        prefixes.append(prefix)
        state = engine.insert(state, prefix, i, max_gen=RWKV_F32_GEN)
    outs, margins = [state["tokens"].clone()], [
        torch.stack([p.last_logits[0, 0] for p in prefixes])]
    for _ in range(RWKV_F32_GEN - 1):
        with torch.no_grad():  # the step's logits, for the margins
            logits = engine.family.step(
                model, state["tokens"][:, None],
                {k: v.clone() for k, v in state["cache"].items()},
                state["lengths"], state["active"])
        margins.append(logits[:, 0])
        state, tok, _ = engine.generate_step(model, state)
        outs.append(tok)
    eng = torch.stack(outs, dim=1)
    serve = registry.serve_fn(cfg)
    cache = registry.init_decode_state(cfg, 1, RWKV_F32_PROMPT, device)
    with torch.no_grad():
        for t in range(RWKV_F32_PROMPT):
            chain, cache = serve(model, {"tokens": prompts[0][None, t:t + 1]},
                                 cache)
    torch.cuda.synchronize()
    launches = read_launches()
    calls = 2 * (RWKV_F32_PROMPT + RWKV_F32_GEN - 1) + (
        2 * RWKV_F32_PROMPT + 2 * (RWKV_F32_GEN - 1)) + RWKV_F32_PROMPT
    for k, v in launches.items():
        want = cfg.n_layers * calls if k == "wkv6_step" else 0
        check(v == want, f"rwkv6 serve f32 checks: {v} {k} launches, "
                         f"expected {want}")
    check(torch.equal(chain, prefixes[0].last_logits)
          and all(torch.equal(cache[k], prefixes[0].cache[k])
                  for k in cache), "rwkv6: the engine's prefill is not "
                                   "bitwise its own decode chain")
    margin = _margins(torch.stack(margins, dim=1)).cpu()
    naive_h, eng_h = naive.cpu().numpy(), eng.cpu().numpy()
    ties = []
    for b in range(2):
        diff = np.flatnonzero(eng_h[b] != naive_h[b])
        if diff.size:
            m = float(margin[b, diff[0]])
            log(f"rwkv6 engine vs naive: row {b} token {diff[0]} differs; "
                f"top-2 margin {m:.3g}")
            check(m < MARGIN, f"rwkv6 engine vs naive: row {b} token "
                              f"{diff[0]} differs with top-2 margin {m}")
            ties.append({"row": b, "token": int(diff[0]), "margin": m})
    check(len(ties) <= 1, f"rwkv6: {len(ties)} differing tokens; at most 1 "
                          f"allowed")
    scan = torch.as_tensor(rwkv6_prompts(
        cfg, 1, (RWKV_F32_SCAN, RWKV_F32_SCAN), seed=3)[0][None],
        device=device)
    prefill = registry.prefill_fn(cfg)
    reset_launches()
    with torch.no_grad():
        got, _ = prefill(model, {"tokens": scan})
    torch.cuda.synchronize()
    scan_launches = read_launches()
    with torch.no_grad(), plain_kernels():
        want, _ = prefill(model, {"tokens": scan})
    for k, v in scan_launches.items():
        n = cfg.n_layers if k == "wkv6_fwd" else 0
        check(v == n, f"rwkv6 f32 prefill: {v} {k} launches, expected {n}")
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    check(bool(torch.isfinite(got).all()) and err <= RWKV_LOGIT_REL,
          f"rwkv6 f32 last logits: {err:.3e} max|logit| from the plain "
          f"versions (bar {RWKV_LOGIT_REL:g})")
    log(f"serve rwkv6 f32 checks ({cfg.n_layers} layers, 2 x "
        f"{RWKV_F32_PROMPT} prompt tokens x {RWKV_F32_GEN}, one request per "
        f"call): engine == naive ({len(ties)} tie(s)), the engine's prefill "
        f"bitwise its own decode chain; smallest top-2 margin "
        f"{float(margin.min()):.4g}; launches {launches}; scan-path last "
        f"logits ({RWKV_F32_SCAN} tokens) within {err:.3e} max|logit| "
        f"({scale:.4g}) of the plain versions (bar {RWKV_LOGIT_REL:g}), "
        f"launches {scan_launches}")
    del model, engine, state
    torch.cuda.empty_cache()
    return {"ties": ties, "min_margin": float(margin.min()),
            "launches": launches, "scan_launches": scan_launches,
            "logit_rel_err": err, "max_logit": scale,
            "tokens": naive_h.tolist()}


def run_serve_rwkv6_phase(device) -> dict:
    """Phase 3k: rwkv6 uncut in bf16 served by ``run_serve`` (its
    RWKV_REQUESTS requests of RWKV_PROMPT tokens; wkv6_step once per layer
    per decode call), one served decode step profiled for wkv6_step's own
    device time (``profile_decode_steps``), prefilled by
    ``registry.prefill_fn``
    (``run_rwkv6_prefill``), then the f32 checks
    (``check_serve_rwkv6_f32``)."""
    import torch

    t0 = time.perf_counter()
    cfg = rwkv6_config()
    model = build_checked(cfg, device)
    requests = [(r, p, SERVE_GEN) for r, p in enumerate(
        rwkv6_prompts(cfg, RWKV_REQUESTS, RWKV_PROMPT, seed=1))]
    res = run_serve(cfg, model, device, requests=requests, warm_len=16)
    # the step kernel's own device time in a served decode step (its
    # wrapper's host cost left out)
    res["decode_profile"] = profile_decode_steps(cfg, model, device,
                                                 ("wkv6_step",), prompt_len=4)
    t1 = time.perf_counter()
    res["prefill"] = run_rwkv6_prefill(cfg, model, device)
    del model
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    res["f32"] = check_serve_rwkv6_f32(device)
    res["split_s"] = {"serve": t1 - t0, "prefill_fn": t2 - t1,
                      "f32_checks": time.perf_counter() - t2}
    log(f"phase 3k split (s): {json.dumps(res['split_s'])}")
    return res


# ------------------------------------------------------------ phase 3l
# rwkv6 trained at full width, depth cut to TRAIN_RWKV_LAYERS of 24: 16
# layers are 1,208.3 M parameters; at phi3.5-moe's measured 70.0 GiB for
# 1,563.5 M (about 48 bytes a parameter: f32 parameters, gradient, AdamW
# moments, the functional step's new copies and the codec's transients),
# 24 layers (1,678.3 M) would need about 75 GiB before activations, 16
# about 54 GiB.  bf16, remat full, AdamW lr 3e-4, lm data seed 0, global
# batch 4 x 2048 in 2 microbatches, aggregate_gaussian fused b = 8
# per-tensor, TRAIN_STEPS steps.  Its gradient checks take the trained
# parameters' first RWKV_CHECK_LAYERS layers: their plain versions run the
# recurrence a step at a time (about 1.5 s a layer for the forward, its
# remat and the backward at 1 x 2048), which at 16 layers would hold the
# run for minutes
TRAIN_RWKV_LAYERS = 16
TRAIN_RWKV_BATCH = 4
RWKV_CHECK_LAYERS = 2


def run_train_rwkv6_phase(device) -> dict:
    """Phase 3l: ``drive_train`` on rwkv6 at TRAIN_RWKV_LAYERS layers
    (launches per step: 2 x L x 2 wkv6_fwd, L x 2 wkv6_bwd, one fused
    encode and decode per leaf), then, on the trained parameters' first
    RWKV_CHECK_LAYERS layers and 1 x TRAIN_CHECK_SEQ, the bf16 gradient
    check against the f32 model (``check_train_gradient``) and the f32
    check of the kernels against the plain versions
    (``check_train_gradient_f32``)."""
    import torch

    t0 = time.perf_counter()
    cfg = rwkv6_config(TRAIN_RWKV_LAYERS)
    params, out = drive_train(cfg, TRAIN_RWKV_BATCH, TRAIN_STEPS, device)
    t1 = time.perf_counter()
    ccfg = cfg.scaled(n_layers=RWKV_CHECK_LAYERS)
    cparams = dict(params, layers={k: v[:RWKV_CHECK_LAYERS]
                                   for k, v in params["layers"].items()})
    plain32 = plain_f32_gradient(ccfg, cparams, device)
    out["gradient_check"] = check_train_gradient(ccfg, cparams, device,
                                                 plain32)
    out["gradient_check_f32"] = check_train_gradient_f32(
        ccfg.scaled(compute_dtype="float32"), cparams, device, plain32)
    out["gradient_check_layers"] = RWKV_CHECK_LAYERS
    del plain32, cparams
    del params
    torch.cuda.empty_cache()
    out["split_s"] = {"train": t1 - t0,
                      "gradient_checks": time.perf_counter() - t1}
    log(f"phase 3l split (s): {json.dumps(out['split_s'])}")
    return out


# ------------------------------------------------------------ decode step
def profile_decode_steps(cfg, model, device, tags: tuple, n_steps: int = 4,
                         prompt_len: int = 16) -> dict:
    """One served decode step's device time: SERVE_SLOTS slots filled with
    prompts of ``prompt_len`` tokens (engine prefills), one warm step,
    then ``n_steps`` steps unprofiled (the wall per step, host clock
    ended by a synchronize) and ``n_steps`` more under ``torch.profiler``:
    the device's busy ms per step (each device-side row once), its idle
    share against the unprofiled wall, the ms per step of the rows whose
    name holds each of ``tags`` (a kernel's own device time, without its
    wrapper's host cost), and the largest rows.  After the counted runs:
    these launches are not the path's."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServeEngine

    engine = ServeEngine(cfg, max_slots=SERVE_SLOTS,
                         max_prefill_len=prompt_len,
                         max_gen_len=2 * n_steps + 3, device=device)
    rng = np.random.default_rng(5)
    state = engine.init_state()
    for i in range(SERVE_SLOTS):
        _, prefix = engine.prefill(model, rng.integers(
            0, cfg.vocab, size=(prompt_len,), dtype=np.int32))
        state = engine.insert(state, prefix, i)
    holder = [engine.generate_step(model, state)[0]]  # warm
    del state

    def steps() -> None:
        for _ in range(n_steps):
            holder[0], _, _ = engine.generate_step(model, holder[0])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps()
        torch.cuda.synchronize()
    dev = _kernel_ms(prof, n_steps)
    check(bool(dev), f"{cfg.name} decode profile: the trace holds no "
                     f"device time")
    check(bool(holder[0]["active"].all()), f"{cfg.name} decode profile: "
                                           f"a slot finished early")
    busy = sum(ms for _, ms in dev)
    out = {"wall_ms": wall, "device_ms": busy,
           "idle_share": 1.0 - busy / wall,
           "tag_ms": {t: sum(ms for k, ms in dev if t in k) for t in tags},
           "top": dev[:8]}
    log(f"decode profile {cfg.name} ({cfg.n_layers} layers, "
        f"{cfg.compute_dtype}, {SERVE_SLOTS} slots): wall {wall:.3f} ms a "
        f"step, device busy {busy:.3f} ms (idle share "
        f"{out['idle_share']:.3f}); "
        + "; ".join(f"{t} {ms:.4f} ms" for t, ms in out["tag_ms"].items())
        + "; top " + "; ".join(f"{k[:50]} {ms:.4f}" for k, ms in dev[:8]))
    del engine, holder
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 3m
# zamba2-7b served in bf16 at full width, its depth cut to ZAMBA_SERVE_LAYERS
# of 81 (2 groups of 5 Mamba2 layers and the shared attention block, a
# tail of 1; uncut, 81 layers, 5,735.2 M parameters, 10.68 GiB, until
# phase 3s was added: the whole run would otherwise pass 1150 s): the
# engine's prefill is a chain of one-token decodes, so the prompts are
# short (ZAMBA_REQUESTS of ZAMBA_PROMPT tokens, SERVE_GEN
# out, the KV rings min(window, 128) rows); its decode attention and
# Mamba2 steps are plain PyTorch, as the reference's (no kernel launches).
# Then ``registry.prefill_fn`` (the scan path: the SSD blocks and the
# shared attention through flash_attention_sm90 with the window 4096, once
# per group) over ZAMBA_PREFILLS prompts of ZAMBA_PREFILL_LEN tokens, all
# past the window and multiples of the SSD chunk (128); and the f32 checks
# at ZAMBA_F32_LAYERS layers (one group and a tail of one)
ZAMBA_ARCH = "zamba2-7b"
ZAMBA_SERVE_LAYERS = 13
ZAMBA_REQUESTS = 8
ZAMBA_PROMPT = (16, 64)
ZAMBA_PREFILLS = 4
ZAMBA_PREFILL_LEN = (4224, 8192)
ZAMBA_F32_LAYERS = 7
ZAMBA_F32_PROMPT = 16
ZAMBA_F32_GEN = 8
ZAMBA_F32_SCAN = 4352  # past the window: flash_attention_f32 masks by it
ZAMBA_LOGIT_REL = 1e-4  # of max|logit|


def zamba2_config(layers=None, dtype=None):
    from repro_torch import configs

    cfg = configs.get_config(ZAMBA_ARCH)
    check(cfg.kind == "zamba2" and cfg.compute_dtype == "bfloat16"
          and cfg.remat == "full" and cfg.window == 4096 and cfg.hd == 112
          and cfg.kv_chunk == CONFIG_KV_CHUNK, f"zamba2 config {cfg}")
    if layers is not None:
        cfg = cfg.scaled(n_layers=layers)
    return cfg if dtype is None else cfg.scaled(compute_dtype=dtype)


def zamba2_prefill_prompts(cfg, n: int, lengths: tuple, seed: int) -> list:
    """``n`` prompts with lengths uniform in ``lengths``, cut down to a
    multiple of the SSD chunk (the scan path's reshape needs one)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = rng.integers(lengths[0], lengths[1] + 1, size=n)
    sizes = [max(int(p) // cfg.ssm_chunk * cfg.ssm_chunk, lengths[0])
             for p in sizes]
    return [rng.integers(0, cfg.vocab, size=(p,), dtype=np.int32)
            for p in sizes]


def run_zamba2_prefill(cfg, model, device) -> dict:
    """``registry.prefill_fn`` (the scan path) over ZAMBA_PREFILLS prompts
    of ZAMBA_PREFILL_LEN tokens, each timed on the host clock after a
    synchronize, launches counted (flash_attention_sm90 once per group
    per prompt, nothing else), finite last logits and no cache.  Then the
    longest prompt once more under ``torch.profiler``: the device's busy
    ms, the flash kernel's ms and the idle share against that prompt's
    unprofiled wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import registry, zamba2

    G = zamba2.layout(cfg)[0]
    prefill = registry.prefill_fn(cfg)
    prompts = [torch.as_tensor(p[None], device=device) for p in
               zamba2_prefill_prompts(cfg, ZAMBA_PREFILLS, ZAMBA_PREFILL_LEN,
                                      seed=8)]
    with torch.no_grad():
        prefill(model, {"tokens": prompts[0]})  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    walls = []
    for tokens in prompts:
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, cache = prefill(model, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(cache is None and tuple(logits.shape) == (
            1, 1, cfg.padded_vocab) and bool(torch.isfinite(logits).all()),
            f"zamba2 prefill of {tokens.shape[1]}: {tuple(logits.shape)}")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    for k, v in launches.items():
        n = G * ZAMBA_PREFILLS if k == "flash_attention_sm90" else 0
        check(v == n, f"zamba2 prefill: {v} {k} launches, expected {n}")
    lengths = [int(t.shape[1]) for t in prompts]
    check(min(lengths) > cfg.window, f"zamba2 prefill prompts {lengths} "
                                     f"not past the window")
    per_1k = 1e3 * sum(walls) / sum(lengths)
    longest = max(range(len(prompts)), key=lambda i: lengths[i])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            prefill(model, {"tokens": prompts[longest]})
        torch.cuda.synchronize()
    dev = _kernel_ms(prof, 1)
    check(bool(dev), "zamba2 prefill profile: the trace holds no device "
                     "time")
    wall_ms = 1e3 * walls[longest]
    busy = sum(ms for _, ms in dev)
    prof_row = {"tokens": lengths[longest], "wall_ms": wall_ms,
                "device_ms": busy, "idle_share": 1.0 - busy / wall_ms,
                "flash_ms": sum(ms for k, ms in dev
                                if FWD_TAGS["bfloat16"] in k),
                "gemm_ms": sum(ms for k, ms in dev
                               if any(t in k.lower() for t in GEMM_TAGS)),
                "top": dev[:8]}
    log(f"zamba2 prefill_fn ({cfg.n_layers} layers, {cfg.compute_dtype}, "
        f"the scan path, window {cfg.window}): prompts of {lengths} tokens "
        f"in {[round(w, 4) for w in walls]} s, {per_1k:.4f} s per 1k "
        f"tokens, peak {peak / 2**30:.2f} GiB; launches {launches}; the "
        f"{lengths[longest]}-token prompt profiled: device busy "
        f"{busy:.3f} ms of its {wall_ms:.3f} ms wall (idle share "
        f"{prof_row['idle_share']:.3f}), flash_attention_sm90 "
        f"{prof_row['flash_ms']:.3f} ms, GEMMs {prof_row['gemm_ms']:.3f} "
        f"ms; top " + "; ".join(f"{k[:50]} {ms:.3f}" for k, ms in dev[:8]))
    return {"launches": launches, "walls_s": walls, "tokens": lengths,
            "prefill_s_per_1k": per_1k, "peak_bytes": peak,
            "profile": prof_row}


def check_serve_zamba2_f32(device) -> dict:
    """zamba2 at ZAMBA_F32_LAYERS layers (one group and a tail) in f32.
    (1) For 2 prompts of ZAMBA_F32_PROMPT tokens the engine (2 slots) and
    the naive loop, one request per call, give the same ZAMBA_F32_GEN
    tokens (a differing token only at a top-2 margin below MARGIN, once);
    (2) the engine's prefill of the first prompt is bitwise its own chain
    of ``registry.serve_fn`` calls (logits and every state leaf); no
    kernel launches in (1) and (2); (3) ``registry.prefill_fn`` (the scan
    path) on ZAMBA_F32_SCAN tokens, past the window: the last logits on
    the kernels (flash_attention_f32 once per group) within
    ZAMBA_LOGIT_REL max|logit| of the same on the plain versions."""
    import numpy as np
    import torch

    from repro_torch.models import registry, zamba2
    from repro_torch.serve import ServeEngine, naive_generate

    cfg = zamba2_config(ZAMBA_F32_LAYERS, "float32")
    model = build_checked(cfg, device)
    prompts = [torch.as_tensor(p, device=device) for p in rwkv6_prompts(
        cfg, 2, (ZAMBA_F32_PROMPT, ZAMBA_F32_PROMPT), seed=2)]
    torch.cuda.synchronize()
    reset_launches()
    naive = torch.cat([naive_generate(cfg, model, {"tokens": p[None]},
                                      ZAMBA_F32_GEN) for p in prompts])
    engine = ServeEngine(cfg, max_slots=2, max_prefill_len=ZAMBA_F32_PROMPT,
                         max_gen_len=ZAMBA_F32_GEN, device=device)
    state = engine.init_state()
    prefixes = []
    for i in range(2):
        _, prefix = engine.prefill(model, prompts[i])
        prefixes.append(prefix)
        state = engine.insert(state, prefix, i, max_gen=ZAMBA_F32_GEN)
    outs, margins = [state["tokens"].clone()], [
        torch.stack([p.last_logits[0, 0] for p in prefixes])]
    for _ in range(ZAMBA_F32_GEN - 1):
        with torch.no_grad():  # the step's logits, for the margins
            logits = engine.family.step(
                model, state["tokens"][:, None],
                {k: v.clone() for k, v in state["cache"].items()},
                state["lengths"], state["active"])
        margins.append(logits[:, 0])
        state, tok, _ = engine.generate_step(model, state)
        outs.append(tok)
    eng = torch.stack(outs, dim=1)
    serve = registry.serve_fn(cfg)
    cache = registry.init_decode_state(
        cfg, 1, ZAMBA_F32_PROMPT + ZAMBA_F32_GEN, device)
    with torch.no_grad():
        for t in range(ZAMBA_F32_PROMPT):
            chain, cache = serve(model, {"tokens": prompts[0][None, t:t + 1]},
                                 cache)
    torch.cuda.synchronize()
    launches = read_launches()
    check(not any(launches.values()), f"zamba2 serve f32 checks: launches "
                                      f"{launches}, expected none")
    check(torch.equal(chain, prefixes[0].last_logits)
          and all(torch.equal(cache[k], prefixes[0].cache[k])
                  for k in cache), "zamba2: the engine's prefill is not "
                                   "bitwise its own decode chain")
    margin = _margins(torch.stack(margins, dim=1)).cpu()
    naive_h, eng_h = naive.cpu().numpy(), eng.cpu().numpy()
    ties = []
    for b in range(2):
        diff = np.flatnonzero(eng_h[b] != naive_h[b])
        if diff.size:
            m = float(margin[b, diff[0]])
            log(f"zamba2 engine vs naive: row {b} token {diff[0]} differs; "
                f"top-2 margin {m:.3g}")
            check(m < MARGIN, f"zamba2 engine vs naive: row {b} token "
                              f"{diff[0]} differs with top-2 margin {m}")
            ties.append({"row": b, "token": int(diff[0]), "margin": m})
    check(len(ties) <= 1, f"zamba2: {len(ties)} differing tokens; at most 1 "
                          f"allowed")
    scan = torch.as_tensor(zamba2_prefill_prompts(
        cfg, 1, (ZAMBA_F32_SCAN, ZAMBA_F32_SCAN), seed=3)[0][None],
        device=device)
    check(scan.shape[1] > cfg.window, "zamba2 f32 scan prompt not past the "
                                      "window")
    prefill = registry.prefill_fn(cfg)
    reset_launches()
    with torch.no_grad():
        got, _ = prefill(model, {"tokens": scan})
    torch.cuda.synchronize()
    scan_launches = read_launches()
    with torch.no_grad(), plain_kernels():
        want, _ = prefill(model, {"tokens": scan})
    G = zamba2.layout(cfg)[0]
    for k, v in scan_launches.items():
        n = G if k == "flash_attention_f32" else 0
        check(v == n, f"zamba2 f32 prefill: {v} {k} launches, expected {n}")
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    check(bool(torch.isfinite(got).all()) and err <= ZAMBA_LOGIT_REL,
          f"zamba2 f32 last logits: {err:.3e} max|logit| from the plain "
          f"versions (bar {ZAMBA_LOGIT_REL:g})")
    log(f"serve zamba2 f32 checks ({cfg.n_layers} layers, 2 x "
        f"{ZAMBA_F32_PROMPT} prompt tokens x {ZAMBA_F32_GEN}, one request "
        f"per call): engine == naive ({len(ties)} tie(s)), the engine's "
        f"prefill bitwise its own decode chain; smallest top-2 margin "
        f"{float(margin.min()):.4g}; launches {launches}; scan-path last "
        f"logits ({scan.shape[1]} tokens) within {err:.3e} max|logit| "
        f"({scale:.4g}) of the plain versions (bar {ZAMBA_LOGIT_REL:g}), "
        f"launches {scan_launches}")
    del model, engine, state
    torch.cuda.empty_cache()
    return {"ties": ties, "min_margin": float(margin.min()),
            "launches": launches, "scan_launches": scan_launches,
            "logit_rel_err": err, "max_logit": scale,
            "tokens": naive_h.tolist()}


def run_serve_zamba2_phase(device) -> dict:
    """Phase 3m: zamba2 at ZAMBA_SERVE_LAYERS in bf16 served by
    ``run_serve`` (its
    ZAMBA_REQUESTS requests of ZAMBA_PROMPT tokens, no kernel launches),
    one served decode step profiled (``profile_decode_steps``), prefilled
    by ``registry.prefill_fn`` (``run_zamba2_prefill``), then the f32
    checks (``check_serve_zamba2_f32``)."""
    import torch

    t0 = time.perf_counter()
    cfg = zamba2_config(ZAMBA_SERVE_LAYERS)
    model = build_checked(cfg, device)
    requests = [(r, p, SERVE_GEN) for r, p in enumerate(
        rwkv6_prompts(cfg, ZAMBA_REQUESTS, ZAMBA_PROMPT, seed=1))]
    res = run_serve(cfg, model, device, requests=requests,
                    warm_len=ZAMBA_PROMPT[0], max_prefill_len=ZAMBA_PROMPT[1])
    res["decode_profile"] = profile_decode_steps(cfg, model, device, (),
                                                 prompt_len=4)
    t1 = time.perf_counter()
    res["prefill"] = run_zamba2_prefill(cfg, model, device)
    del model
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    res["f32"] = check_serve_zamba2_f32(device)
    res["split_s"] = {"serve": t1 - t0, "prefill_fn": t2 - t1,
                      "f32_checks": time.perf_counter() - t2}
    log(f"phase 3m split (s): {json.dumps(res['split_s'])}")
    return res


# ------------------------------------------------------------ phase 3n
# zamba2 trained at full width, depth cut to TRAIN_ZAMBA_LAYERS of 81: 7
# layers (1 group of 5 Mamba2 layers and the shared block, a tail of 1;
# 14 layers, 2 groups and a tail of 2, 1,370.2 M parameters, 67.86 GiB,
# until phase 3s was added: the whole run would otherwise pass 1150 s).  bf16, remat full, AdamW lr
# 3e-4, lm data seed 0, global batch 2 x 8192 in 2 microbatches (both past
# the window: the backward kernels mask by it), aggregate_gaussian fused
# b = 8 per-tensor, TRAIN_STEPS steps.  The gradient checks take the
# trained parameters' first group (ZAMBA_CHECK_LAYERS layers) at 1 x 8192
TRAIN_ZAMBA_LAYERS = 7
TRAIN_ZAMBA_BATCH = 2
TRAIN_ZAMBA_SEQ = 8192
ZAMBA_CHECK_LAYERS = 6


def run_train_zamba2_phase(device) -> dict:
    """Phase 3n: ``drive_train`` on zamba2 at TRAIN_ZAMBA_LAYERS layers and
    TRAIN_ZAMBA_SEQ tokens a sequence (launches per step: 2 x G x 2
    flash_attention_sm90, G x 2 flash_attention_bwd_sm90 for its G groups,
    one fused encode and decode per leaf), then, on the trained
    parameters' first group and 1 x TRAIN_ZAMBA_SEQ, the bf16 gradient
    check against the f32 model (``check_train_gradient``) and the f32
    check of the kernels against the plain versions
    (``check_train_gradient_f32``)."""
    import torch

    t0 = time.perf_counter()
    cfg = zamba2_config(TRAIN_ZAMBA_LAYERS)
    params, out = drive_train(cfg, TRAIN_ZAMBA_BATCH, TRAIN_STEPS, device,
                              seq=TRAIN_ZAMBA_SEQ)
    t1 = time.perf_counter()
    ccfg = cfg.scaled(n_layers=ZAMBA_CHECK_LAYERS)
    cparams = {k: v for k, v in params.items() if k != "tail"}
    cparams["groups"] = {k: v[:1] for k, v in params["groups"].items()}
    plain32 = plain_f32_gradient(ccfg, cparams, device, TRAIN_ZAMBA_SEQ)
    out["gradient_check"] = check_train_gradient(
        ccfg, cparams, device, plain32, TRAIN_ZAMBA_SEQ)
    out["gradient_check_f32"] = check_train_gradient_f32(
        ccfg.scaled(compute_dtype="float32"), cparams, device, plain32,
        TRAIN_ZAMBA_SEQ)
    out["gradient_check_layers"] = ZAMBA_CHECK_LAYERS
    del plain32, cparams, params
    torch.cuda.empty_cache()
    out["split_s"] = {"train": t1 - t0,
                      "gradient_checks": time.perf_counter() - t1}
    log(f"phase 3n split (s): {json.dumps(out['split_s'])}")
    return out


# ------------------------------------------------------------ phase 3o
# whisper-small uncut in bf16 (12 encoder and 12 decoder layers, d 768, 12
# heads of 64, 239.4 M parameters, 0.45 GiB).  The reference's prefill is
# its forward over the frames and the decoder tokens, which returns no
# cache, and its engine and naive loop refuse whisper, as the port's do:
# ``registry.prefill_fn`` over WHISPER_REQUESTS requests of its 1500 stub
# frames and WHISPER_TEXT decoder tokens (448 is whisper's text context,
# ``max_target_positions``), then a decode chain through
# ``registry.serve_fn``: WHISPER_ROWS rows, a prompt of WHISPER_PROMPT
# tokens (its self K / V from the decoder's layers), WHISPER_STEPS steps,
# each appending its new K / V to the self cache, the cross K / V
# projected once from the encoder memory; then the f32 checks, uncut
WHISPER_ARCH = "whisper-small"
WHISPER_REQUESTS = 8
WHISPER_TEXT = (64, 448)
WHISPER_ROWS = 8
WHISPER_PROMPT = 64
WHISPER_STEPS = 64
WHISPER_F32_ROWS = 2
WHISPER_F32_STEPS = 16
WHISPER_LOGIT_REL = 1e-4  # of max|logit|


def whisper_config(dtype=None):
    from repro_torch import configs

    cfg = configs.get_config(WHISPER_ARCH)
    check(cfg.kind == "whisper" and cfg.compute_dtype == "bfloat16"
          and cfg.remat == "full" and cfg.hd == 64 and cfg.encoder_len == 1500
          and cfg.kv_chunk == CONFIG_KV_CHUNK, f"whisper config {cfg}")
    return cfg if dtype is None else cfg.scaled(compute_dtype=dtype)


def whisper_batch(cfg, tokens, key: int, device) -> dict:
    """tokens (B, T) and their frames stub, drawn from PRNGKey(key)."""
    import torch

    from repro_torch.core import prng
    from repro_torch.data import synthetic

    return synthetic.with_frontend_stubs(
        {"tokens": torch.as_tensor(tokens, device=device)}, cfg,
        prng.PRNGKey(key))


def whisper_cross_kv(cfg, model, frames):
    """The decode cache's cross K / V, (L, B, 1500, HK, hd) each: each
    decoder layer's ``cross.wk`` / ``cross.wv`` over the encoder memory,
    as the reference's ``_cross_attend`` projects them (``whisper.
    cross_kv``: on a model axis the rank's heads); and the memory."""
    import torch

    from repro_torch.models import whisper

    memory = whisper.encode(cfg, model, frames)
    kv = [whisper.cross_kv(cfg, lp, memory) for lp in model.dec_layers]
    return tuple(torch.stack([c[i] for c in kv]) for i in (0, 1)), memory


def whisper_self_cache(cfg, model, tokens, memory):
    """The decoder's self K / V of a prompt, (L, B, T, HK, hd) each, from
    its layers run in turn (their flash kernels, causal and cross)."""
    import torch

    from repro_torch.models import nn, whisper

    x = whisper._embed(cfg, model, tokens)
    rope = nn.rope_freqs(cfg.hd, x.shape[1] + 1, cfg.rope_theta, x.dtype,
                         device=x.device)
    ks, vs = [], []
    for lp in model.dec_layers:
        x, (k, v) = whisper._dec_layer(cfg, lp, x, memory, rope)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def whisper_chain(cfg, model, prompt, frames, n_steps: int,
                  timed: bool = False) -> dict:
    """Greedy decode through ``registry.serve_fn``: the cross K / V from
    ``encode``, the self cache of ``prompt[:, :-1]`` from the decoder's
    layers, then ``n_steps`` steps from ``prompt[:, -1]``, each appending
    its new K / V.  The launch counts are set to 0 just before the steps
    and read just after (the decode step's cross-attention:
    flash_attention_* once a layer).  Returns tokens (B, n_steps), the
    steps' logits (B, n_steps, V; on a model axis the rank's vocab
    block), the launches and, with ``timed``, each step's wall on the
    host clock after a synchronize."""
    import torch

    from repro_torch.models import parallel, registry

    serve = registry.serve_fn(cfg)
    with torch.no_grad():
        (ck, cv), memory = whisper_cross_kv(cfg, model, frames)
        k, v = whisper_self_cache(cfg, model, prompt[:, :-1], memory)
        del memory
        tok, out, logits, walls = prompt[:, -1:], [], [], []
        torch.cuda.synchronize()
        reset_launches()
        for _ in range(n_steps):
            t0 = time.perf_counter()
            lg, (nk, nv) = serve(model, {"tokens": tok},
                                 {"k": k, "v": v, "cross_k": ck,
                                  "cross_v": cv})
            k, v = torch.cat([k, nk], 2), torch.cat([v, nv], 2)
            tok = parallel.argmax_vocab(cfg, lg).to(torch.int32)
            out.append(tok)
            logits.append(lg)
            if timed:
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        launches = read_launches()
    return {"tokens": torch.cat(out, 1), "logits": torch.cat(logits, 1),
            "launches": launches, "walls_s": walls}


def run_whisper_prefill(cfg, model, device) -> dict:
    """``registry.prefill_fn`` over WHISPER_REQUESTS requests (one a call)
    of the 1500 stub frames and WHISPER_TEXT decoder tokens, each timed on
    the host clock after a synchronize, launches counted (the bf16 flash
    kernel once per encoder layer and twice per decoder layer a request,
    nothing else), finite last logits and no cache; then the longest
    request once more under ``torch.profiler``: the device's busy ms, the
    flash kernel's and the GEMMs' ms and the idle share against its
    unprofiled wall."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import registry

    prefill = registry.prefill_fn(cfg)
    rng = np.random.default_rng(12)
    sizes = rng.integers(WHISPER_TEXT[0], WHISPER_TEXT[1] + 1,
                         size=WHISPER_REQUESTS)
    sizes[-1] = WHISPER_TEXT[1]  # the text context, in full, among them
    batches = [whisper_batch(cfg, rng.integers(0, cfg.vocab, size=(1, int(n)),
                                               dtype=np.int32), 100 + r,
                             device) for r, n in enumerate(sizes)]
    with torch.no_grad():
        prefill(model, batches[0])  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    walls = []
    for batch in batches:
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, cache = prefill(model, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(cache is None and tuple(logits.shape) == (
            1, 1, cfg.padded_vocab) and bool(torch.isfinite(logits).all()),
            f"whisper prefill of {batch['tokens'].shape[1]}: "
            f"{tuple(logits.shape)}")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    per = cfg.encoder_layers + 2 * cfg.n_layers
    for k, v in launches.items():
        n = per * WHISPER_REQUESTS if k == "flash_attention_sm90" else 0
        check(v == n, f"whisper prefill: {v} {k} launches, expected {n}")
    lengths = [int(n) for n in sizes]
    per_1k = 1e3 * sum(walls) / sum(lengths)
    longest = int(np.argmax(lengths))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            prefill(model, batches[longest])
        torch.cuda.synchronize()
    dev = _kernel_ms(prof, 1)
    check(bool(dev), "whisper prefill profile: the trace holds no device "
                     "time")
    wall_ms = 1e3 * walls[longest]
    busy = sum(ms for _, ms in dev)
    prof_row = {"tokens": lengths[longest], "wall_ms": wall_ms,
                "device_ms": busy, "idle_share": 1.0 - busy / wall_ms,
                "flash_ms": sum(ms for k, ms in dev
                                if FWD_TAGS["bfloat16"] in k),
                "gemm_ms": sum(ms for k, ms in dev
                               if any(t in k.lower() for t in GEMM_TAGS)),
                "top": dev[:8]}
    log(f"whisper prefill_fn ({cfg.encoder_layers} + {cfg.n_layers} layers, "
        f"{cfg.compute_dtype}, 1500 frames): decoder prompts of {lengths} "
        f"tokens in {[round(w, 4) for w in walls]} s, {per_1k:.4f} s per 1k "
        f"decoder tokens, {sum(walls) / len(walls):.4f} s per request, peak "
        f"{peak / 2**30:.2f} GiB; launches {launches}; the "
        f"{lengths[longest]}-token request profiled: device busy "
        f"{busy:.3f} ms of its {wall_ms:.3f} ms wall (idle share "
        f"{prof_row['idle_share']:.3f}), flash_attention_sm90 "
        f"{prof_row['flash_ms']:.3f} ms, GEMMs {prof_row['gemm_ms']:.3f} "
        f"ms; top " + "; ".join(f"{k[:50]} {ms:.3f}" for k, ms in dev[:8]))
    return {"launches": launches, "walls_s": walls, "tokens": lengths,
            "prefill_s_per_1k": per_1k,
            "s_per_request": sum(walls) / len(walls), "peak_bytes": peak,
            "profile": prof_row}


def run_whisper_decode(cfg, model, device) -> dict:
    """The decode chain (``whisper_chain``) of WHISPER_ROWS rows over
    WHISPER_STEPS steps after a WHISPER_PROMPT-token prompt, each step
    timed: the step's ms (the median), tokens/s (rows over it), peak GiB,
    launches (flash_attention_sm90 once a layer a step, nothing else)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(13)
    batch = whisper_batch(cfg, rng.integers(
        0, cfg.vocab, size=(WHISPER_ROWS, WHISPER_PROMPT), dtype=np.int32),
        200, device)
    torch.cuda.reset_peak_memory_stats()
    res = whisper_chain(cfg, model, batch["tokens"], batch["frames"],
                        WHISPER_STEPS, timed=True)
    peak = torch.cuda.max_memory_allocated()
    for k, v in res["launches"].items():
        n = (WHISPER_STEPS * cfg.n_layers if k == "flash_attention_sm90"
             else 0)
        check(v == n, f"whisper decode chain: {v} {k} launches, expected "
                      f"{n}")
    check(bool(torch.isfinite(res["logits"]).all()), "whisper decode chain: "
                                                     "non-finite logits")
    walls = sorted(res["walls_s"][1:])  # the first step warms
    step_ms = 1e3 * walls[len(walls) // 2]
    log(f"whisper decode chain ({WHISPER_ROWS} rows, {WHISPER_PROMPT}-token "
        f"prompt, {WHISPER_STEPS} steps through serve_fn, cross K / V over "
        f"1500 frames): step {step_ms:.3f} ms (median; first "
        f"{1e3 * res['walls_s'][0]:.3f} ms), {WHISPER_ROWS / step_ms * 1e3:.1f}"
        f" tokens/s, peak {peak / 2**30:.2f} GiB; launches {res['launches']}")
    return {"launches": res["launches"], "step_ms": step_ms,
            "tokens_per_s": WHISPER_ROWS / step_ms * 1e3,
            "walls_s": res["walls_s"], "peak_bytes": peak}


def check_serve_whisper_f32(device) -> dict:
    """whisper uncut in f32.  (1) ``registry.prefill_fn`` over one request
    of WHISPER_TEXT[1] decoder tokens: the last logits on the kernels
    (flash_attention_f32, 36 launches) within WHISPER_LOGIT_REL
    max|logit| of the same on the plain versions; (2) a decode chain
    (``whisper_chain``) of WHISPER_F32_ROWS rows, WHISPER_F32_STEPS steps
    after a WHISPER_PROMPT-token prompt: its greedy tokens are the argmax
    of the teacher-forced forward over prompt and output (a differing
    token only at a top-2 margin below MARGIN, once in all) and its
    logits within WHISPER_LOGIT_REL max|logit| of that forward's."""
    import numpy as np
    import torch

    from repro_torch.models import registry

    cfg = whisper_config("float32")
    model = build_checked(cfg, device)
    rng = np.random.default_rng(14)
    batch = whisper_batch(cfg, rng.integers(
        0, cfg.vocab, size=(1, WHISPER_TEXT[1]), dtype=np.int32), 300, device)
    prefill = registry.prefill_fn(cfg)
    torch.cuda.synchronize()
    reset_launches()
    with torch.no_grad():
        got, _ = prefill(model, batch)
    torch.cuda.synchronize()
    launches = read_launches()
    with torch.no_grad(), plain_kernels():
        want, _ = prefill(model, batch)
    per = cfg.encoder_layers + 2 * cfg.n_layers
    for k, v in launches.items():
        n = per if k == "flash_attention_f32" else 0
        check(v == n, f"whisper f32 prefill: {v} {k} launches, expected {n}")
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    check(bool(torch.isfinite(got).all()) and err <= WHISPER_LOGIT_REL,
          f"whisper f32 last logits: {err:.3e} max|logit| from the plain "
          f"versions (bar {WHISPER_LOGIT_REL:g})")
    chain_batch = whisper_batch(cfg, rng.integers(
        0, cfg.vocab, size=(WHISPER_F32_ROWS, WHISPER_PROMPT),
        dtype=np.int32), 301, device)
    prompt = chain_batch["tokens"]
    chain = whisper_chain(cfg, model, prompt, chain_batch["frames"],
                          WHISPER_F32_STEPS)
    for k, v in chain["launches"].items():
        n = (WHISPER_F32_STEPS * cfg.n_layers if k == "flash_attention_f32"
             else 0)
        check(v == n, f"whisper f32 chain: {v} {k} launches, expected {n}")
    full = torch.cat([prompt, chain["tokens"][:, :-1]], 1)
    with torch.no_grad():
        forced = registry.logits_fn(
            cfg, model, {"tokens": full, "frames": chain_batch["frames"]})[
                :, WHISPER_PROMPT - 1:]
    fscale = float(forced.abs().max())
    ferr = float((chain["logits"] - forced).abs().max()) / fscale
    check(ferr <= WHISPER_LOGIT_REL, f"whisper f32 chain logits: {ferr:.3e} "
          f"max|logit| from the teacher-forced forward")
    margin = _margins(forced).cpu()
    got_t = chain["tokens"].cpu().numpy()
    forced_t = forced.argmax(-1).cpu().numpy()
    ties = []
    for b, t in zip(*np.nonzero(got_t != forced_t)):
        m = float(margin[b, t])
        log(f"whisper f32 chain vs teacher-forced: row {b} token {t} "
            f"differs; top-2 margin {m:.3g}")
        check(m < MARGIN, f"whisper f32 chain: row {b} token {t} differs "
                          f"with top-2 margin {m} >= {MARGIN}")
        ties.append({"row": int(b), "token": int(t), "margin": m})
    # the forward reads the chain's own tokens: the same history at every
    # position
    check(len(ties) <= 1, f"whisper: {len(ties)} differing tokens; at most "
                          f"1 allowed")
    log(f"serve whisper f32 checks (uncut): prefill_fn's last logits "
        f"({WHISPER_TEXT[1]} tokens) within {err:.3e} max|logit| "
        f"({scale:.4g}) of the plain versions (bar {WHISPER_LOGIT_REL:g}), "
        f"launches {launches}; decode chain of {WHISPER_F32_ROWS} x "
        f"{WHISPER_F32_STEPS} == the teacher-forced forward's argmax "
        f"({len(ties)} tie(s)), logits within {ferr:.3e} max|logit|; "
        f"smallest top-2 margin {float(margin.min()):.4g}; chain launches "
        f"{chain['launches']}")
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "chain_launches": chain["launches"],
            "logit_rel_err": err, "max_logit": scale,
            "chain_logit_rel_err": ferr, "ties": ties,
            "min_margin": float(margin.min()), "tokens": got_t.tolist()}


def run_serve_whisper_phase(device) -> dict:
    """Phase 3o: whisper uncut in bf16 prefilled (``run_whisper_prefill``)
    and decoded (``run_whisper_decode``), then the f32 checks
    (``check_serve_whisper_f32``)."""
    import torch

    t0 = time.perf_counter()
    cfg = whisper_config()
    model = build_checked(cfg, device)
    res = {"prefill": run_whisper_prefill(cfg, model, device)}
    t1 = time.perf_counter()
    res["decode"] = run_whisper_decode(cfg, model, device)
    del model
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    res["f32"] = check_serve_whisper_f32(device)
    res["split_s"] = {"prefill_fn": t1 - t0, "decode": t2 - t1,
                      "f32_checks": time.perf_counter() - t2}
    log(f"phase 3o split (s): {json.dumps(res['split_s'])}")
    return res


# ------------------------------------------------------------ phase 3p
# whisper-small trained uncut: bf16, remat full, kv_chunk 1024, AdamW lr
# 3e-4, lm data seed 0 with the frames stub, global batch 16 x (1500
# frames, 448 decoder tokens) in 2 microbatches, aggregate_gaussian fused
# b = 8 per-tensor, TRAIN_STEPS steps; the gradient checks at
# WHISPER_CHECK_ROWS x (1500, 448)
TRAIN_WHISPER_BATCH = 16
WHISPER_CHECK_ROWS = 2


def run_train_whisper_phase(device) -> dict:
    """Phase 3p: ``drive_train`` on whisper uncut (launches per step: 2 x
    36 flash_attention_sm90 and 36 flash_attention_bwd_sm90 a microbatch,
    one fused encode and decode per leaf), then, on the trained parameters
    and WHISPER_CHECK_ROWS x WHISPER_TEXT[1], the bf16 gradient check
    against the f32 model (``check_train_gradient``) and the f32 check of
    the kernels against the plain versions with the f64 gradient as the
    yardstick (``check_train_gradient_f32``, ``f64_gradient``)."""
    import torch

    t0 = time.perf_counter()
    cfg = whisper_config()
    seq = WHISPER_TEXT[1]
    params, out = drive_train(cfg, TRAIN_WHISPER_BATCH, TRAIN_STEPS, device,
                              seq=seq)
    t1 = time.perf_counter()
    plain32 = plain_f32_gradient(cfg, params, device, seq, WHISPER_CHECK_ROWS)
    out["gradient_check"] = check_train_gradient(
        cfg, params, device, plain32, seq, WHISPER_CHECK_ROWS)
    # with random weights the encoder's attention is spread over 1500
    # nearly alike frames: dS = P (dP - Drow) cancels, and at some leaves
    # the plain f32 gradient is itself about 1e-4 max|g| from the exact one
    exact = f64_gradient(cfg, params, device, seq, WHISPER_CHECK_ROWS)
    out["gradient_check_f32"] = check_train_gradient_f32(
        cfg.scaled(compute_dtype="float32"), params, device, plain32, seq,
        WHISPER_CHECK_ROWS, exact)
    del plain32, exact, params
    torch.cuda.empty_cache()
    out["split_s"] = {"train": t1 - t0,
                      "gradient_checks": time.perf_counter() - t1}
    log(f"phase 3p split (s): {json.dumps(out['split_s'])}")
    return out


# ------------------------------------------------------------ phase 3q
# the (pod, data, model) mesh: MESH_RANKS gloo ranks on the one card (NCCL
# refuses two ranks on one card, see probe_nccl), so the times measure the
# paths' correctness and launches, not tensor parallelism over NVLink
MESH_RANKS = 4
MESH_TRAIN = (2, 1, 2)      # (a): two pods (clients), TP 2, NO_FSDP_RULES
MESH_TRAIN_LAYERS = 4       # (a)'s depth, cut from 24 (every leaf whole)
MESH_TRAIN_BATCH = 4        # global rows of TRAIN_SEQ tokens
MESH_TRAIN_ACCUM = 2        # microbatches per step on each rank
MESH_TRAIN_STEPS = 2
MESH_CHECK = (1, 2, 2)      # (b): FSDP 2 x TP 2, f32, 1 x TRAIN_CHECK_SEQ
# (c) / (d): (arch, mesh, requests, tokens out, layers or None for all):
# qwen1.5-0.5b's 16 / 16 heads split over 2 ranks, starcoder2-3b's 2 KV
# heads over 4 (the cut-head gather, the decode cache split by sequence).
# Cut from 8 requests of 64 out (and starcoder2-3b from 30 layers), and
# (a) from 24 layers, so that the whole script ends within 1200 s on the
# slowest hosts seen (with (a) at 12 layers, (c) at 8 requests and (d) at
# 10 layers it took 912 s on one host and 1053 s on one 1.16x slower;
# another host was 1.32x slower): every gloo op on the shared card costs
# 1-12 ms, and a 30-layer starcoder2-3b decode step ran ~120 of them
MESH_SERVE = (("qwen1.5-0.5b", (1, 1, 2), 4, 16, None),
              ("starcoder2-3b", (1, 1, 4), 2, 16, 5))
MESH_F32_PROMPT, MESH_F32_GEN = 512, 16
# the bf16 forward on the mesh against one rank's: the last MESH_BF16_POS
# positions of the first f32-check prompt; the mesh's distance from the
# f32 logits at most MESH_BF16_FACTOR times the one-rank bf16 forward's
# (tests/test_torch_mesh.py's BF16_FACTOR)
MESH_BF16_POS = 32
MESH_BF16_FACTOR = 1.5
MESH_TIMEOUT = 420.0


def mesh_train_config():
    from repro_torch import configs

    return configs.get_config(TRAIN_ARCH).scaled(n_layers=MESH_TRAIN_LAYERS)


def mesh_serve_config(arch: str, layers):
    from repro_torch import configs

    cfg = configs.get_config(arch)
    return cfg if layers is None else cfg.scaled(n_layers=layers)


def _mesh_train(mesh, device) -> dict:
    """(a) The compressed step on MESH_TRAIN: per step the wall between
    two barriers, the loss, the digest of this rank's params; the
    launches of both steps and the peak."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding
    from repro_torch.train import steps

    cfg = mesh_train_config()
    tc = steps.TrainConfig(optimizer="adamw", lr=3e-4,
                           grad_accum=MESH_TRAIN_ACCUM,
                           compression=_train_comp("aggregate_gaussian",
                                                   TRAIN_SIGMA))
    state = steps.init_train_state(cfg, tc, 0, device, mesh=mesh)
    step_fn = steps.build_train_step(cfg, tc, mesh=mesh)
    dc = synthetic.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                              global_batch=MESH_TRAIN_BATCH, kind="lm")
    split = _time_calls(((steps, "loss_and_grads"),
                         (steps.compress_mod, "compress_tree"),
                         (sharding, "unshard"), (coll, "all_reduce"),
                         (coll, "all_gather")))
    out = {"walls": [], "losses": [], "digests": [], "cohort": None,
           "split": [],
           "rules": "NO_FSDP_RULES" if steps.state_rules(cfg, tc, mesh)
           is sharding.NO_FSDP_RULES else "other",
           "local_params": sum(t.numel() for t in _leaves(state["params"]))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    reset_launches()
    for i in range(MESH_TRAIN_STEPS):
        batch = synthetic.lm_batch(dc, i, device=device)
        dist.barrier()
        split.clear()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, TRAIN_SEED)
        torch.cuda.synchronize()
        dist.barrier()
        out["walls"].append(time.perf_counter() - t0)
        out["split"].append(dict(split))
        out["losses"].append(float(m["loss"]))
        out["digests"].append(_digest(_leaves(state["params"])))
        out["cohort"] = int(m["cohort"])
    out["launches"] = read_launches()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del state
    torch.cuda.empty_cache()
    return out


def _time_calls(targets) -> dict:
    """Wrap each (owner, name) function so that its calls add their wall
    seconds (between synchronizes) to the returned dict under ``name``:
    a rank's split of its step (the wrapped calls nest: ``all_reduce`` and
    ``all_gather`` inside ``loss_and_grads`` and ``unshard`` count in
    both)."""
    import torch

    acc = {}

    def wrap(owner, name):
        fn = getattr(owner, name)

        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
                acc[name + "_calls"] = acc.get(name + "_calls", 0) + 1

        setattr(owner, name, run)

    for owner, name in targets:
        wrap(owner, name)
    return acc


def collective_ms(group, device) -> dict:
    """ms a gloo all-reduce of the card's f32 tensors takes on ``group``:
    a decode step's (8, 1024) and a 2048-token prefill's (2048, 1024),
    the mean of 20 and of 5 after a warm-up of each."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import collectives as coll

    out = {}
    for name, shape, reps in (("8x1024", (8, 1024), 20),
                              ("2048x1024", (2048, 1024), 5)):
        x = torch.ones(shape, device=device)
        coll.all_reduce(x, group)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            coll.all_reduce(x, group)
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.perf_counter() - t0) / reps
    return out


def _mesh_check(mesh, device) -> dict:
    """(b) f32 on MESH_CHECK, one microbatch of 1 x TRAIN_CHECK_SEQ: the
    mesh's loss and gradient (each rank's blocks) against the one-rank
    step's on the same params, computed on this rank and cut to its
    blocks; errors reduced to their max over the ranks."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding
    from repro_torch.models import nn, registry
    from repro_torch.train import steps

    cfg = configs.get_config(TRAIN_ARCH).scaled(compute_dtype="float32")
    tc = steps.TrainConfig(optimizer="adamw", lr=3e-4)
    shard = steps.train_state_shardings(cfg, tc, mesh)["params"]
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    full = nn.init_params(registry.param_specs(cfg), gen, device)
    local = sharding.shard_tree(full, shard)
    batch = check_batch(cfg, device)
    dist.barrier()
    reset_launches()
    t0 = time.perf_counter()
    loss, g = steps.mesh_loss_and_grads(cfg, tc, mesh, local, batch, shard)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    del local
    loss1, g1 = steps.loss_and_grads(cfg, tc, full, batch)
    del full
    worst = 0.0
    for x, y, ns in zip(_leaves(g), _leaves(g1),
                        sharding.tree_leaves(shard)):
        err = (x - sharding.shard_tensor(y, ns.spec, mesh)).abs().max()
        worst = max(worst, float(err) / max(float(y.abs().max()), 1e-30))
    worst = float(coll.all_reduce_max(
        torch.tensor(worst, dtype=torch.float64), dist.group.WORLD))
    loss_rel = abs(float(loss) - float(loss1)) / abs(float(loss1))
    del g, g1
    torch.cuda.empty_cache()
    return {"loss": float(loss), "loss_one": float(loss1),
            "loss_rel": loss_rel, "grad_rel": worst, "wall": wall,
            "launches": launches}


def mesh_f32_prompts(cfg, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(2)
    return torch.as_tensor(rng.integers(
        0, cfg.vocab, size=(2, MESH_F32_PROMPT), dtype=np.int32),
        device=device)


def mesh_engine_tokens(cfg, model, device, prompts,
                       gen: int = MESH_F32_GEN):
    """2 prompts at full occupancy through the engine (f32 check), ``gen``
    tokens each."""
    import torch

    from repro_torch.serve import ServeEngine

    engine = ServeEngine(cfg, max_slots=2, max_prefill_len=prompts.shape[1],
                         max_gen_len=gen, device=device)
    state = engine.init_state()
    for i in range(2):
        _, prefix = engine.prefill(model, prompts[i])
        state = engine.insert(state, prefix, i, max_gen=gen)
    outs = [state["tokens"].clone()]
    for _ in range(gen - 1):
        state, tok, _ = engine.generate_step(model, state)
        outs.append(tok)
    return torch.stack(outs, dim=1)


def _mesh_serve(mesh, device, arch: str, n_requests: int, gen: int,
                layers) -> dict:
    """(c) / (d) The engine on the mesh: ``n_requests`` requests of
    256-2048 prompt tokens, ``gen`` out, in bf16 (after a warm-up of 2),
    with the launches; then the f32 engine's tokens on 2 x
    MESH_F32_PROMPT."""
    import statistics

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch import serve as launch
    from repro_torch.serve import ServeEngine

    cfg = mesh_serve_config(arch, layers)
    gloo_ms = collective_ms(mesh.group("model"), device)
    model = launch.build_model(cfg, 0, device, mesh)
    bf16_logits = mesh_bf16_logits(cfg, model, device)
    engine = ServeEngine(cfg, max_slots=SERVE_SLOTS,
                         max_prefill_len=SERVE_PREFILL,
                         max_gen_len=gen, device=device)
    launch.drive(engine, model, [(r, toks[:256], 4) for r, toks, _ in
                                 serve_requests(cfg, 2, seed=9)])
    requests = [(r, toks, min(g, gen)) for r, toks, g in
                serve_requests(cfg, n_requests)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    reset_launches()
    outputs, stats = launch.drive(engine, model, requests)
    torch.cuda.synchronize()
    launches = read_launches()
    out = {"launches": launches, "gloo_all_reduce_ms": gloo_ms, "stats": {
        k: stats[k] for k in ("steps", "tokens_out", "wall_s",
                              "tokens_per_s", "prefills", "prompt_tokens",
                              "prefill_s", "mean_occupancy")},
        "step_ms_median": statistics.median(stats["step_ms"]),
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "outputs_digest": _json_digest(outputs),
        "cache_seq_split": engine.family.seq is not None,
        "cache_shape": list(engine.init_state()["cache"]["k"].shape),
        "ok_tokens": all(len(outputs[r]) == g and all(
            0 <= t < cfg.vocab for t in outputs[r]) for r, _, g in requests),
        "bf16_logits": bf16_logits}
    del engine, model
    torch.cuda.empty_cache()
    cfg32 = cfg.scaled(compute_dtype="float32")
    model32 = launch.build_model(cfg32, 0, device, mesh)
    reset_launches()
    out["f32_tokens"] = mesh_engine_tokens(
        cfg32, model32, device, mesh_f32_prompts(cfg32, device)).cpu().tolist()
    out["f32_launches"] = read_launches()
    del model32
    torch.cuda.empty_cache()
    return out


def mesh_bf16_logits(cfg, model, device):
    """The compute-dtype forward's logits (whole over the vocabulary, f32,
    on the host) at the last MESH_BF16_POS positions of the first f32-check
    prompt."""
    import torch

    from repro_torch.dist import collectives as coll
    from repro_torch.models import parallel, registry

    prompt = mesh_f32_prompts(cfg, device)[:1]
    with torch.no_grad():
        logits = registry.logits_fn(cfg, model, {"tokens": prompt})
        logits = logits[:, -MESH_BF16_POS:].to(torch.float32)
        logits = coll.all_gather(logits, -1,
                                 parallel.vocab_group(cfg, logits))
    return logits[..., :cfg.vocab].cpu().numpy()


def _json_digest(obj) -> str:
    import hashlib

    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def mesh_rank_main(rank: int, n: int, port: int, device: str, jobs, gate,
                   results) -> None:
    """One rank of phases 3q, 3r and 3s: the gloo group, then each (name,
    mesh shape, args) of ``jobs`` on its mesh (``meshctx.make_mesh``, set
    as the process's mesh), the function ``MESH_JOBS`` names by the part
    of ``name`` before any "/": 3q's ``train`` (a), ``check`` (b) or
    ``serve`` (c / d); 3r's ``moe_block``, ``moe_serve``, ``moe_train``;
    3s's ``family_serve``, ``whisper_serve``, ``family_train``,
    ``whisper_pods``.  A job named in GATED_JOBS starts only once the
    parent has set ``gate`` (an Event; None where no job waits)."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import meshctx

    try:
        # the ranks' work is on the card; one intra-op thread each keeps
        # the four from contending for the host's cores
        torch.set_num_threads(1)
        device = torch.device(device)
        torch.cuda.set_device(device)
        dist.init_process_group(RANK_BACKEND,
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=n)
        out = {"rank": rank, "backend": dist.get_backend(), "jobs": {}}
        for name, shape, args in jobs:
            if name.split("/")[0] in GATED_JOBS:
                t0 = time.perf_counter()
                if not gate.wait(GATE_TIMEOUT):
                    raise RuntimeError(f"{name}: the gate stayed shut")
                out.setdefault("gate_wait_s", time.perf_counter() - t0)
            mesh = meshctx.make_mesh(shape)
            meshctx.set_mesh(mesh)
            t0 = time.perf_counter()
            res = MESH_JOBS[name.split("/")[0]](mesh, device, *args)
            res.update(coords=mesh.coords(),
                       job_s=time.perf_counter() - t0)
            out["jobs"][name] = res
            torch.cuda.empty_cache()  # other processes share the card
        results.put(out)
    except BaseException:  # reported to the parent, then re-raised
        import traceback

        results.put({"rank": rank, "error": traceback.format_exc()})
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _mesh_spawn_start(n: int, jobs, device, gate=None) -> dict:
    """Start n ranks running ``jobs`` and return at once, for
    ``_mesh_spawn_collect``."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    port = free_port()
    return {"n": n, "jobs": jobs, "t0": time.perf_counter(),
            "started": _spawn_start(
                mesh_rank_main,
                lambda r: (r, n, port, str(device), jobs, gate), n)}


def _mesh_spawn_collect(spawn: dict) -> dict:
    """``_mesh_spawn_start``'s ranks: {job: {rank: result}}, the wall from
    spawn to exit and each rank's wait at the gate; every process
    stopped."""
    n, jobs = spawn["n"], spawn["jobs"]
    got = _spawn_collect(spawn["started"], n, MESH_TIMEOUT)
    wall = time.perf_counter() - spawn["t0"]
    errors = [g["error"] for g in got if "error" in g]
    check(not errors, "mesh rank failed:\n" + "\n".join(errors))
    check(len(got) == n, f"mesh: {n - len(got)} ranks gave no result")
    for g in got:
        check(g["backend"] == RANK_BACKEND, f"backend {g['backend']}")
    return {"jobs": {name: {g["rank"]: g["jobs"][name] for g in got}
                     for name, _, _ in jobs}, "spawn_to_exit_s": wall,
            "gate_wait_s": {g["rank"]: g["gate_wait_s"] for g in got
                            if "gate_wait_s" in g}}


def mesh_one_rank_f32(arch: str, layers, device) -> dict:
    """The one-rank f32 engine's tokens on the f32 check's prompts, and
    the top-2 margins of a teacher-forced forward over them (a differing
    mesh token is a tie only below MARGIN there)."""
    import torch

    from repro_torch import configs
    from repro_torch.launch import serve as launch
    from repro_torch.models import registry

    cfg = mesh_serve_config(arch, layers).scaled(compute_dtype="float32")
    model = launch.build_model(cfg, 0, device)
    prompts = mesh_f32_prompts(cfg, device)
    toks = mesh_engine_tokens(cfg, model, device, prompts)
    with torch.no_grad():
        logits = registry.logits_fn(cfg, model, {"tokens": torch.cat(
            [prompts, toks[:, :-1]], dim=1)})
    margin = _margins(logits[:, MESH_F32_PROMPT - 1:]).cpu()
    f32_logits = logits[:1, MESH_F32_PROMPT - MESH_BF16_POS:MESH_F32_PROMPT,
                        :cfg.vocab].cpu().numpy()
    del model, logits
    cfg16 = mesh_serve_config(arch, layers)
    model = launch.build_model(cfg16, 0, device)
    bf16_logits = mesh_bf16_logits(cfg16, model, device)
    del model
    torch.cuda.empty_cache()
    return {"tokens": toks.cpu().tolist(), "margin": margin.tolist(),
            "f32_logits": f32_logits, "bf16_logits": bf16_logits}


def mesh_phase_jobs() -> tuple:
    """3q's rank sides: ((a), (b), (d)) on 4 ranks, ((c),) on 2."""
    c_serve, d_serve = MESH_SERVE
    return ((("train", MESH_TRAIN, ()), ("check", MESH_CHECK, ()),
             ("serve", d_serve[1], (d_serve[0],) + d_serve[2:])),
            (("serve", c_serve[1], (c_serve[0],) + c_serve[2:]),))


def run_mesh_phase(device, four: dict, two: dict) -> dict:
    """Phase 3q: the dense transformer on the (pod, data, model) mesh,
    gloo ranks sharing the card.

    (a) qwen1.5-0.5b at full width, MESH_TRAIN_LAYERS of its 24 layers,
    in bf16 on (2, 1, 2) under NO_FSDP_RULES,
    aggregate_gaussian fused b = 8, MESH_TRAIN_STEPS steps of 4 x 2048 in
    2 microbatches a rank: params bitwise equal across the pods for each
    model rank after every step, finite losses equal on every rank, the
    cohort 2, and each rank's launches per step (the flash kernels on its
    8 heads per layer per microbatch, one fused encode and decode per
    whole leaf); (b) f32 on (1, 2, 2), 1 x 2048: the loss within 1e-6
    relative and every gradient leaf within 1e-4 max|g| of the one-rank
    step; (c) qwen1.5-0.5b served tensor parallel on (1, 1, 2) and (d)
    starcoder2-3b at full width (MESH_SERVE's depth) on (1, 1, 4), whose 2
    KV heads do not split (each
    rank gathers its query heads' KV head; the decode cache splits the
    sequence): MESH_SERVE's requests in bf16 with tokens/s and step ms,
    one flash_attention_sm90 launch a layer per prefill on every rank, the
    same tokens on every rank; then f32 tokens on 2 x 512 x 16 equal to
    the one-rank engine's (a differing token only at a tie), and the bf16
    logits no further from the f32 ones than MESH_BF16_FACTOR times the
    one-rank bf16 forward's.  (a), (b) and (d) ran in ``four``, the
    spawn of 4 ranks, (c) in ``two``, that of 2 (``start_mesh_spawns``)."""
    from repro_torch import configs

    res = {}
    cfg = mesh_train_config()
    c_serve, d_serve = MESH_SERVE
    one = {arch: mesh_one_rank_f32(arch, layers, device)
           for arch, _, _, _, layers in (d_serve, c_serve)}
    res["spawn_to_exit_s"] = {"4 ranks": four["spawn_to_exit_s"],
                              "2 ranks": two["spawn_to_exit_s"]}

    ranks = four["jobs"]["train"]
    per_step = train_launches_expected(cfg, MESH_TRAIN_ACCUM)
    for r, g in ranks.items():
        twin = next(o for o, h in ranks.items() if o != r and
                    h["coords"]["model"] == g["coords"]["model"])
        check(g["digests"] == ranks[twin]["digests"],
              f"mesh train: rank {r}'s params differ from rank {twin}'s "
              f"(the other pod, same model rank)")
        check(g["losses"] == ranks[0]["losses"]
              and all(math.isfinite(x) for x in g["losses"]),
              f"mesh train rank {r}: losses {g['losses']}")
        check(g["cohort"] == MESH_TRAIN[0], f"cohort {g['cohort']}")
        check(g["rules"] == "NO_FSDP_RULES", f"rules {g['rules']}")
        for k, v in g["launches"].items():
            want = MESH_TRAIN_STEPS * per_step.get(k, 0)
            check(v == want, f"mesh train rank {r}: {v} {k} launches, "
                             f"expected {want}")
    res["train"] = {
        "mesh": MESH_TRAIN, "walls_s": {r: g["walls"] for r, g in
                                        ranks.items()},
        "losses": ranks[0]["losses"],
        "peak_gib": {r: g["peak_bytes"] / 2**30 for r, g in ranks.items()},
        "local_params": {r: g["local_params"] for r, g in ranks.items()},
        "launches_per_rank": ranks[0]["launches"],
        "split_s": ranks[0]["split"],
        "job_s": {r: g["job_s"] for r, g in ranks.items()}}
    log(f"mesh train {MESH_TRAIN} ({cfg.n_layers} layers, {RANK_BACKEND}, "
        f"one card), "
        f"aggregate_gaussian fused b = {BITS}, {MESH_TRAIN_BATCH} x "
        f"{TRAIN_SEQ}: step walls per rank "
        f"{json.dumps({r: [round(w, 3) for w in ws] for r, ws in res['train']['walls_s'].items()})}"
        f" s, losses {res['train']['losses']}, peak "
        f"{json.dumps({r: round(p, 2) for r, p in res['train']['peak_gib'].items()})}"
        f" GiB, launches per rank {res['train']['launches_per_rank']}; "
        f"params bitwise equal across pods per model rank; rank 0's split "
        f"(s, nested) {json.dumps(res['train']['split_s'])}")

    chk = four["jobs"]["check"]
    c0 = chk[0]
    for r, g in chk.items():
        check(g["loss_rel"] <= 1e-6, f"mesh f32 check rank {r}: loss "
              f"{g['loss']} vs one rank {g['loss_one']}")
        check(g["grad_rel"] <= 1e-4, f"mesh f32 check: gradient "
              f"{g['grad_rel']} of max|g|")
        L = configs.get_config(TRAIN_ARCH).n_layers  # (b) runs all of them
        check(g["launches"].get("flash_attention_f32", 0) == 2 * L
              and g["launches"].get("flash_attention_bwd_f32_sm90", 0)
              == L, f"mesh f32 check rank {r}: launches "
              f"{g['launches']}")
    res["check"] = {"mesh": MESH_CHECK, "loss_rel": c0["loss_rel"],
                    "grad_rel": c0["grad_rel"],
                    "walls_s": {r: g["wall"] for r, g in chk.items()},
                    "job_s": {r: g["job_s"] for r, g in chk.items()},
                    "launches_per_rank": c0["launches"]}
    log(f"mesh f32 check {MESH_CHECK}: loss {c0['loss_rel']:.3g} relative, "
        f"gradient {c0['grad_rel']:.3g} of max|g| from the one-rank step")

    for (arch, shape, n_req, gen, layers), sr in zip(
            MESH_SERVE, (two["jobs"]["serve"], four["jobs"]["serve"])):
        scfg = mesh_serve_config(arch, layers)
        s0 = sr[0]
        ties = []
        for r, g in sr.items():
            check(g["ok_tokens"], f"mesh serve {arch} rank {r}: tokens")
            check(g["outputs_digest"] == s0["outputs_digest"],
                  f"mesh serve {arch}: rank {r}'s tokens differ from rank 0's")
            want = {"flash_attention_sm90": scfg.n_layers
                    * g["stats"]["prefills"]}
            for k, v in g["launches"].items():
                check(v == want.get(k, 0), f"mesh serve {arch} rank {r}: "
                      f"{v} {k} launches, expected {want.get(k, 0)}")
            check(g["f32_launches"].get("flash_attention_f32", 0)
                  == 2 * scfg.n_layers, f"mesh serve {arch} f32 launches "
                  f"{g['f32_launches']}")
            check(g["f32_tokens"] == s0["f32_tokens"],
                  f"mesh serve {arch}: f32 tokens differ across ranks")
        check(s0["cache_seq_split"] == (scfg.n_kv_heads % shape[2] != 0),
              f"mesh serve {arch}: cache layout {s0['cache_shape']}")
        for b in range(2):
            got, want = s0["f32_tokens"][b], one[arch]["tokens"][b]
            diff = [t for t in range(len(want)) if got[t] != want[t]]
            if diff:
                m = one[arch]["margin"][b][diff[0]]
                check(m < MARGIN, f"mesh serve {arch} f32 row {b} token "
                      f"{diff[0]} differs with top-2 margin {m}")
                ties.append({"row": b, "token": diff[0], "margin": m})
        check(len(ties) <= 1, f"mesh serve {arch}: {len(ties)} ties")
        bf16 = mesh_bf16_reading(one[arch], sr)
        check(bf16["ratio"] <= MESH_BF16_FACTOR,
              f"mesh serve {arch}: bf16 logits {bf16['mesh_err']} from "
              f"f32, one rank's {bf16['one_err']}")
        res[arch] = {
            "mesh": shape, "requests": n_req, "gen": gen,
            "layers": scfg.n_layers,
            "tokens_per_s": s0["stats"]["tokens_per_s"],
            "step_ms_median": s0["step_ms_median"], "stats": s0["stats"],
            "peak_gib": {r: g["peak_bytes"] / 2**30 for r, g in sr.items()},
            "cache_shape": s0["cache_shape"],
            "cache_seq_split": s0["cache_seq_split"],
            "launches_per_rank": s0["launches"],
            "f32_launches_per_rank": s0["f32_launches"],
            "f32_ties": ties,
            "gloo_all_reduce_ms": s0["gloo_all_reduce_ms"],
            "min_margin": min(min(m) for m in one[arch]["margin"]),
            "bf16_logits": bf16,
            "job_s": {r: g["job_s"] for r, g in sr.items()}}
        log(f"mesh serve {arch} {shape} ({scfg.n_layers} layers, bf16, "
            f"{n_req} requests, {gen} out): {s0['stats']['tokens_per_s']:.1f} tokens/s, median "
            f"decode step {s0['step_ms_median']:.3f} ms, prefill "
            f"{s0['stats']['prefill_s']:.3f} s for "
            f"{s0['stats']['prompt_tokens']} prompt tokens; KV cache per "
            f"rank {s0['cache_shape']} (sequence split: "
            f"{s0['cache_seq_split']}); launches per rank {s0['launches']};"
            f" f32 tokens on 2 x {MESH_F32_PROMPT} x {MESH_F32_GEN} equal "
            f"to the one-rank engine's ({len(ties)} tie(s)); bf16 logits "
            f"{json.dumps(bf16)}; a gloo "
            f"all-reduce of f32 on the model group: "
            f"{json.dumps(s0['gloo_all_reduce_ms'])} ms")
    res["launches"] = {
        k: sum(g["launches"].get(k, 0) for g in ranks.values())
        + sum(g["launches"].get(k, 0) for g in chk.values())
        + sum(g["launches"].get(k, 0) + g["f32_launches"].get(k, 0)
              for sr in (two["jobs"]["serve"], four["jobs"]["serve"])
              for g in sr.values())
        for k in KERNELS}
    return res


def mesh_bf16_reading(one: dict, ranks: dict) -> dict:
    """The mesh's bf16 logits (the same bits on every rank) against the
    one-rank bf16 and f32 forwards': max |mesh - f32|, max |one - f32|,
    their ratio, max |mesh - one| and the share of bitwise-equal logits."""
    import numpy as np

    mesh = ranks[0]["bf16_logits"]
    for r, g in ranks.items():
        check(np.array_equal(g["bf16_logits"], mesh),
              f"mesh bf16 logits: rank {r}'s differ from rank 0's")
    f32, one16 = one["f32_logits"], one["bf16_logits"]
    mesh_err = float(np.abs(mesh - f32).max())
    one_err = float(np.abs(one16 - f32).max())
    return {"mesh_err": mesh_err, "one_err": one_err,
            "ratio": mesh_err / max(one_err, 1e-30),
            "mesh_vs_one": float(np.abs(mesh - one16).max()),
            "equal_share": float((mesh == one16).mean()),
            "f32_max": float(np.abs(f32).max())}


# ------------------------------------------------------------ phase 3r
# the moe kind on the mesh: phi3.5-moe at full width (widths, heads, 16
# experts, top 2, vocab as published) on (1, 1, 2), two gloo ranks sharing
# the card (times measure the paths' correctness and launches, not tensor
# or expert parallelism), under the tensor-parallel branch (each expert's
# d_ff split over the 2 ranks) and the expert-parallel one (moe_ep: 8
# experts a rank at full d_ff, two all-to-alls a layer).  Depth cut to
# what keeps the phase near 90 s beside the earlier ones (every gloo op on
# the shared card costs 1-12 ms, 3q): the block alone is one layer's MoE
# FFN on 1 x MOE_MESH_BLOCK_T f32 tokens; the serve leg MOE_MESH_LAYERS
# of 32 layers in bf16 (both ranks' halves 10.5 GiB); the train leg one
# layer in f32, as phase 3i (each rank also holds the one-rank model and
# its gradient for the check, 12.5 GiB)
MOE_MESH_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_MESH = (1, 1, 2)
MOE_MESH_BRANCHES = ("tp", "ep")
MOE_MESH_BLOCK_T = 2048
MOE_MESH_LAYERS = 4
MOE_MESH_REQUESTS, MOE_MESH_GEN = 4, 16
MOE_MESH_TRAIN_LAYERS = 1
# the block's f32 output against one rank's, of max|y|; the f32 gradient
# of every leaf against one rank's, of max|g| (the port's bars)
MOE_MESH_OUT_REL, MOE_MESH_GRAD_REL = 1e-5, 1e-4


def moe_mesh_config(layers: int, branch: str, dtype=None):
    cfg = moe_config(MOE_MESH_ARCH, layers).scaled(moe_ep=branch == "ep")
    return cfg if dtype is None else cfg.scaled(compute_dtype=dtype)


class record_routes:
    """Within the block, ``models.moe.route`` is wrapped so that every
    call's experts, positions and keep mask are kept (on the host)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._route = [], moe.route

        def route(*args):
            out = self._route(*args)
            self.calls.append([t.cpu() for t in out[1:4]])
            return out

        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self._route
        return False


def _moe_block_check(mesh, device, branch: str) -> dict:
    """One layer's MoE FFN at full width in f32 on 1 x MOE_MESH_BLOCK_T
    tokens from a seeded generator: the one-rank block on the whole
    weights, then ``moe.moe_block`` on this rank's blocks under each rule
    table of the branch (tp: PARAM_RULES; ep: EP_PARAM_RULES, and
    SERVE_RESIDENT_RULES, whose d_ff-split experts are resharded at use):
    routing bitwise, the output's distance from one rank's in max|y|, the
    call's wall."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import sharding
    from repro_torch.models import moe, nn

    cfg = moe_mesh_config(1, branch, "float32")
    specs = moe.moe_specs(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    whole = {k: nn.init_leaf(sp, gen, device) for k, sp in specs.items()}
    x = torch.randn((1, MOE_MESH_BLOCK_T, cfg.d_model), generator=gen,
                    device=device)
    with torch.no_grad(), record_routes() as one:
        y1 = moe.local_moe(cfg, x, whole["router"], whole["w_gate"],
                           whole["w_up"], whole["w_down"])
    tables = (("PARAM_RULES",) if branch == "tp"
              else ("EP_PARAM_RULES", "SERVE_RESIDENT_RULES"))
    out = {"capacity": moe.capacity(MOE_MESH_BLOCK_T, cfg), "tables": {}}
    for rules in tables:
        shard = sharding.param_shardings(specs, mesh,
                                         getattr(sharding, rules))
        local = {k: sharding.shard_tensor(t, shard[k].spec, mesh)
                 for k, t in whole.items()}
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad(), record_routes() as rec:
            y = moe.moe_block(cfg, local, x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        same = (len(rec.calls) == 1 and all(
            torch.equal(a, b) for a, b in zip(rec.calls[0], one.calls[0])))
        out["tables"][rules] = {
            "routing_bitwise": same, "wall_s": wall,
            "dropped": int((~rec.calls[0][2]).sum()),
            "w_gate": list(local["w_gate"].shape),
            "out_rel": float((y - y1).abs().max() / y1.abs().max())}
        del local, y
    del whole, x, y1
    torch.cuda.empty_cache()
    return out


def _moe_mesh_serve(mesh, device, branch: str) -> dict:
    """The engine on the mesh in bf16 at MOE_MESH_LAYERS layers (tp: the
    weights by SERVE_RESIDENT_RULES; ep: by EP_PARAM_RULES, the experts
    resident a rank's 8 at full d_ff, as the reference's dry run places
    them for serving): the check prompt's logits and routing, then
    MOE_MESH_REQUESTS requests of 256-2048 prompt tokens, MOE_MESH_GEN
    out, one request a prefill call (after a warm-up of 2), with the
    launches."""
    import statistics

    import torch
    import torch.distributed as dist

    from repro_torch.dist import sharding
    from repro_torch.launch import serve as launch
    from repro_torch.serve import ServeEngine

    cfg = moe_mesh_config(MOE_MESH_LAYERS, branch)
    rules = sharding.EP_PARAM_RULES if branch == "ep" else None
    model = launch.build_model(cfg, 0, device, mesh, rules)
    with record_routes() as rec:
        bf16_logits = mesh_bf16_logits(cfg, model, device)
    engine = ServeEngine(cfg, max_slots=SERVE_SLOTS,
                         max_prefill_len=SERVE_PREFILL,
                         max_gen_len=MOE_MESH_GEN, device=device)
    launch.drive(engine, model, [(r, toks[:256], 4) for r, toks, _ in
                                 serve_requests(cfg, 2, seed=9)])
    requests = [(r, toks, min(g, MOE_MESH_GEN)) for r, toks, g in
                serve_requests(cfg, MOE_MESH_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    reset_launches()
    outputs, stats = launch.drive(engine, model, requests)
    torch.cuda.synchronize()
    out = {"launches": read_launches(), "stats": {
        k: stats[k] for k in ("steps", "tokens_out", "wall_s",
                              "tokens_per_s", "prefills", "prompt_tokens",
                              "prefill_s", "mean_occupancy")},
        "step_ms_median": statistics.median(stats["step_ms"]),
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "outputs_digest": _json_digest(outputs),
        "ok_tokens": all(len(outputs[r]) == g and all(
            0 <= t < cfg.vocab for t in outputs[r]) for r, _, g in requests),
        "w_gate": list(model.layers[0].moe["w_gate"].shape),
        "bf16_logits": bf16_logits,
        "top_e": [c[0].numpy() for c in rec.calls]}
    del engine, model
    torch.cuda.empty_cache()
    return out


def _moe_mesh_train(mesh, device, branch: str) -> dict:
    """f32 at MOE_MESH_TRAIN_LAYERS layer, one microbatch of 1 x
    TRAIN_CHECK_SEQ, the state under ``train_state_shardings`` (tp:
    PARAM_RULES; ep: EP_PARAM_RULES): the mesh's loss and gradient
    against the one-rank step's on the same params (errors reduced to
    their max over the ranks), with the launches; then one uncompressed
    AdamW step of ``build_train_step(mesh=)`` (its wall, loss, launches
    and peak)."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding
    from repro_torch.models import nn, registry
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.train import steps

    cfg = moe_mesh_config(MOE_MESH_TRAIN_LAYERS, branch, "float32")
    tc = steps.TrainConfig(optimizer="adamw", lr=3e-4)
    shard = steps.train_state_shardings(cfg, tc, mesh)["params"]
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    full = nn.init_params(registry.param_specs(cfg), gen, device)
    local = sharding.shard_tree(full, shard)
    batch = check_batch(cfg, device)
    dist.barrier()
    reset_launches()
    t0 = time.perf_counter()
    loss, g = steps.mesh_loss_and_grads(cfg, tc, mesh, local, batch, shard)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    loss1, g1 = steps.loss_and_grads(cfg, tc, full, batch)
    del full
    worst = 0.0
    for x, y, ns in zip(_leaves(g), _leaves(g1),
                        sharding.tree_leaves(shard)):
        err = (x - sharding.shard_tensor(y, ns.spec, mesh)).abs().max()
        worst = max(worst, float(err) / max(float(y.abs().max()), 1e-30))
    worst = float(coll.all_reduce_max(
        torch.tensor(worst, dtype=torch.float64, device=device),
        dist.group.WORLD))
    loss_rel = abs(float(loss) - float(loss1)) / abs(float(loss1))
    del g, g1
    torch.cuda.empty_cache()
    state = {"params": local,
             "opt_state": get_optimizer("adamw", 3e-4).init(local),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    step_fn = steps.build_train_step(cfg, tc, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    reset_launches()
    t0 = time.perf_counter()
    state, m = step_fn(state, batch, TRAIN_SEED)
    torch.cuda.synchronize()
    out = {"loss": float(loss), "loss_one": float(loss1),
           "loss_rel": loss_rel, "grad_rel": worst, "wall": wall,
           "launches": launches, "step_wall": time.perf_counter() - t0,
           "step_loss": float(m["loss"]), "step_launches": read_launches(),
           "step_peak_bytes": torch.cuda.max_memory_allocated(),
           "local_params": sum(t.numel() for t in _leaves(state["params"]))}
    del state, local
    torch.cuda.empty_cache()
    return out


MESH_JOBS = {"train": _mesh_train, "check": _mesh_check,
             "serve": _mesh_serve, "moe_block": _moe_block_check,
             "moe_serve": _moe_mesh_serve, "moe_train": _moe_mesh_train}


def moe_mesh_one_rank(device) -> dict:
    """One rank's check-prompt logits at MOE_MESH_LAYERS layers: in f32
    and in bf16 (the same seeded weights), and the bf16 forward's
    routing."""
    import torch

    from repro_torch.launch import serve as launch

    cfg32 = moe_mesh_config(MOE_MESH_LAYERS, "tp", "float32")
    model = launch.build_model(cfg32, 0, device)
    f32_logits = mesh_bf16_logits(cfg32, model, device)
    del model
    torch.cuda.empty_cache()
    cfg = moe_mesh_config(MOE_MESH_LAYERS, "tp")
    model = launch.build_model(cfg, 0, device)
    with record_routes() as rec:
        bf16_logits = mesh_bf16_logits(cfg, model, device)
    del model
    torch.cuda.empty_cache()
    return {"f32_logits": f32_logits, "bf16_logits": bf16_logits,
            "top_e": [c[0].numpy() for c in rec.calls]}


def moe_mesh_jobs() -> tuple:
    """3r's rank sides, on the 2 ranks of MOE_MESH."""
    return tuple((f"{job}/{b}", MOE_MESH, (b,)) for b in MOE_MESH_BRANCHES
                 for job in ("moe_block", "moe_serve", "moe_train"))


def run_moe_mesh_phase(device, two: dict) -> dict:
    """Phase 3r: phi3.5-moe on the (1, 1, 2) mesh, two gloo ranks sharing
    the card, under both branches (MOE_MESH_BRANCHES), in one spawn:

    the block alone (``_moe_block_check``): routing bitwise the one-rank
    block's from the same x, the f32 output within MOE_MESH_OUT_REL
    max|y| (tp under PARAM_RULES; ep under EP_PARAM_RULES and resharded
    from SERVE_RESIDENT_RULES); the engine in bf16 (``_moe_mesh_serve``):
    the check prompt's logits no further from one rank's f32 logits than
    MESH_BF16_FACTOR times the one-rank bf16 forward's, the count of
    routing choices that differ from the one-rank bf16 forward's, the
    requests' tokens equal on both ranks, one flash_attention_sm90 launch
    a layer per prefill; the train leg in f32 (``_moe_mesh_train``): the
    loss within 1e-6 relative and every gradient leaf within
    MOE_MESH_GRAD_REL max|g| of one rank's, 2 flash_attention_f32 and one
    backward launch a layer (forward and remat), and one AdamW step."""
    import numpy as np

    res = {}
    one = moe_mesh_one_rank(device)
    res["spawn_to_exit_s"] = two["spawn_to_exit_s"]
    launches = {k: 0 for k in KERNELS}
    for b in MOE_MESH_BRANCHES:
        blk = two["jobs"][f"moe_block/{b}"]
        for r, g in blk.items():
            for rules, row in g["tables"].items():
                check(row["routing_bitwise"], f"moe mesh block {b} {rules} "
                      f"rank {r}: routing differs from one rank's")
                check(row["out_rel"] <= MOE_MESH_OUT_REL,
                      f"moe mesh block {b} {rules} rank {r}: output "
                      f"{row['out_rel']} of max|y| from one rank's")
        res[f"block_{b}"] = blk[0]
        log(f"moe mesh block {b} {MOE_MESH} (f32, 1 x {MOE_MESH_BLOCK_T} "
            f"tokens, C = {blk[0]['capacity']}): routing bitwise the "
            f"one-rank block's; " + "; ".join(
                f"{rules}: w_gate block {row['w_gate']}, output "
                f"{row['out_rel']:.3g} of max|y| from one rank's, "
                f"{row['dropped']} choices dropped, call "
                f"{row['wall_s']:.3f} s" for rules, row in
                blk[0]["tables"].items()))

        sr = two["jobs"][f"moe_serve/{b}"]
        s0 = sr[0]
        scfg = moe_mesh_config(MOE_MESH_LAYERS, b)
        for r, g in sr.items():
            check(g["ok_tokens"], f"moe mesh serve {b} rank {r}: tokens")
            check(g["outputs_digest"] == s0["outputs_digest"],
                  f"moe mesh serve {b}: rank {r}'s tokens differ")
            want = {"flash_attention_sm90": scfg.n_layers
                    * g["stats"]["prefills"]}
            for k, v in g["launches"].items():
                check(v == want.get(k, 0), f"moe mesh serve {b} rank {r}: "
                      f"{v} {k} launches, expected {want.get(k, 0)}")
                launches[k] += v
        bf16 = mesh_bf16_reading(one, sr)
        check(bf16["ratio"] <= MESH_BF16_FACTOR,
              f"moe mesh serve {b}: bf16 logits {bf16['mesh_err']} from "
              f"f32, one rank's {bf16['one_err']}")
        check(len(s0["top_e"]) == len(one["top_e"]) == scfg.n_layers,
              f"moe mesh serve {b}: {len(s0['top_e'])} route calls")
        differ = sum(int((a != c).sum()) for a, c in
                     zip(s0["top_e"], one["top_e"]))
        total = sum(a.size for a in one["top_e"])
        res[f"serve_{b}"] = {
            "layers": scfg.n_layers, "requests": MOE_MESH_REQUESTS,
            "gen": MOE_MESH_GEN, "stats": s0["stats"],
            "tokens_per_s": s0["stats"]["tokens_per_s"],
            "step_ms_median": s0["step_ms_median"],
            "peak_gib": {r: g["peak_bytes"] / 2**30 for r, g in sr.items()},
            "w_gate": s0["w_gate"], "launches_per_rank": s0["launches"],
            "bf16_logits": bf16, "routing_differ": differ,
            "routing_choices": total,
            "job_s": {r: g["job_s"] for r, g in sr.items()}}
        log(f"moe mesh serve {b} {MOE_MESH} ({scfg.n_layers} layers, bf16, "
            f"{MOE_MESH_REQUESTS} requests, {MOE_MESH_GEN} out; w_gate "
            f"block {s0['w_gate']}): {s0['stats']['tokens_per_s']:.1f} "
            f"tokens/s, median decode step {s0['step_ms_median']:.3f} ms, "
            f"prefill {s0['stats']['prefill_s']:.3f} s for "
            f"{s0['stats']['prompt_tokens']} prompt tokens; launches per "
            f"rank {s0['launches']}; bf16 logits {json.dumps(bf16)}; "
            f"{differ} of {total} routing choices of the check prompt "
            f"differ from the one-rank bf16 forward's")

        tr = two["jobs"][f"moe_train/{b}"]
        t0 = tr[0]
        L = MOE_MESH_TRAIN_LAYERS
        for r, g in tr.items():
            check(g["loss_rel"] <= 1e-6, f"moe mesh train {b} rank {r}: "
                  f"loss {g['loss']} vs one rank {g['loss_one']}")
            check(g["grad_rel"] <= MOE_MESH_GRAD_REL, f"moe mesh train {b}:"
                  f" gradient {g['grad_rel']} of max|g|")
            check(math.isfinite(g["step_loss"]),
                  f"moe mesh train {b} rank {r}: step loss {g['step_loss']}")
            for ln in (g["launches"], g["step_launches"]):
                check(ln.get("flash_attention_f32", 0) == 2 * L
                      and ln.get("flash_attention_bwd_f32_sm90", 0) == L,
                      f"moe mesh train {b} rank {r}: launches {ln}")
                for k in KERNELS:
                    launches[k] += ln.get(k, 0)
        res[f"train_{b}"] = {
            "loss_rel": t0["loss_rel"], "grad_rel": t0["grad_rel"],
            "grad_wall_s": {r: g["wall"] for r, g in tr.items()},
            "step_wall_s": {r: g["step_wall"] for r, g in tr.items()},
            "step_peak_gib": {r: g["step_peak_bytes"] / 2**30
                              for r, g in tr.items()},
            "local_params": {r: g["local_params"] for r, g in tr.items()},
            "launches_per_rank": t0["launches"],
            "job_s": {r: g["job_s"] for r, g in tr.items()}}
        log(f"moe mesh train {b} {MOE_MESH} (f32, {L} layer, 1 x "
            f"{TRAIN_CHECK_SEQ}): loss {t0['loss_rel']:.3g} relative, "
            f"gradient {t0['grad_rel']:.3g} of max|g| from the one-rank "
            f"step; {t0['local_params']:,} parameters a rank; one AdamW "
            f"step {t0['step_wall']:.3f} s (rank 0), peak "
            f"{t0['step_peak_bytes'] / 2**30:.2f} GiB")
    res["launches"] = launches
    res["one_rank_choices"] = int(np.sum([a.size for a in one["top_e"]]))
    return res


# ------------------------------------------------------------ phase 3s
# rwkv6, zamba2 and whisper on the (pod, data, model) mesh, gloo ranks
# sharing the card, as 3q and 3r: the times measure the paths'
# correctness and launches, not tensor parallelism (every gloo op on the
# shared card costs 1-12 ms).  (a) rwkv6-1.6b uncut served on (1, 1, 2):
# each prompt token is a 24-layer decode step of three all-reduces a
# layer (250 ms a call on the card), so the requests are few and short
# (cut from 8 of 16-64 tokens, 32 out; (b), (d) and (e) hold the f32
# gradient without the AdamW steps after it, and (e)'s pods take one step,
# not two, to keep the phase near 120 s); (c) zamba2-7b at 13 of its 81
# layers (2 groups and a tail of 1: groups, shared block and tail all
# run); the f32 token checks and the bf16 logits at FM_*_F32_LAYERS; (b),
# (d) and whisper's f32 gradient at the depth where each rank also holds
# the one-rank model and its gradient beside its blocks, on sequences of
# FM_TRAIN_SEQ (cut from 2048)
FM_SERVE = (1, 1, 2)
FM_TRAIN = (1, 2, 2)
FM_PODS = (2, 1, 2)
FM_RWKV_REQUESTS, FM_RWKV_PROMPT, FM_RWKV_GEN = 2, (8, 8), 8
FM_RWKV_SCAN = 2000          # (a)'s scan-path prefill
FM_RWKV_F32_LAYERS = 4
FM_RWKV_TRAIN_LAYERS = 4     # (b): f32, 2 x FM_TRAIN_SEQ
FM_TRAIN_SEQ = 1024          # (b) and (d)'s sequence
FM_ZAMBA_LAYERS = 13         # (c)
FM_ZAMBA_REQUESTS, FM_ZAMBA_PROMPT, FM_ZAMBA_GEN = 2, (8, 8), 8
FM_ZAMBA_SCAN = 5120         # past the window of 4096
FM_ZAMBA_F32_LAYERS = 7
FM_ZAMBA_TRAIN_LAYERS = 7    # (d): 1 group and a tail of 1, f32
FM_F32_PROMPT, FM_F32_GEN = 8, 8    # the f32 token checks: 2 prompts
FM_WHISPER_ROWS, FM_WHISPER_STEPS = 8, 16
FM_WHISPER_F32_ROWS, FM_WHISPER_F32_STEPS = 2, 16
FM_WHISPER_TRAIN = (2, 448)  # global rows x decoder tokens (1500 frames)
FM_WHISPER_POD_STEPS = 1
FM_GRAD_REL = 1e-4           # of max|g|, every leaf, against one rank
FM_LOSS_REL = 1e-6


def family_config(kind: str, layers=None, dtype=None):
    if kind == "whisper":
        return whisper_config(dtype)
    return {"rwkv6": rwkv6_config, "zamba2": zamba2_config}[kind](layers,
                                                                 dtype)


def family_f32_prompts(cfg, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(4)
    return torch.as_tensor(rng.integers(
        0, cfg.vocab, size=(2, FM_F32_PROMPT), dtype=np.int32), device=device)


def whisper_mesh_inputs(cfg, device, rows: int):
    """``rows`` prompts of WHISPER_PROMPT tokens and their frames stub."""
    import numpy as np

    rng = np.random.default_rng(5)
    b = whisper_batch(cfg, rng.integers(0, cfg.vocab,
                                        size=(rows, WHISPER_PROMPT),
                                        dtype=np.int32), 6, device)
    return b["tokens"], b["frames"]


def whisper_mesh_logits(cfg, model, device):
    """``registry.logits_fn`` over the first f32-check row's prompt and
    frames: the last MESH_BF16_POS positions, whole over the vocabulary,
    f32 on the host."""
    import torch

    from repro_torch.dist import collectives as coll
    from repro_torch.models import parallel, registry

    tokens, frames = whisper_mesh_inputs(cfg, device, FM_WHISPER_F32_ROWS)
    with torch.no_grad():
        logits = registry.logits_fn(cfg, model, {"tokens": tokens[:1],
                                                 "frames": frames[:1]})
        logits = logits[:, -MESH_BF16_POS:].to(torch.float32)
        logits = coll.all_gather(logits, -1,
                                 parallel.vocab_group(cfg, logits))
    return logits[..., :cfg.vocab].cpu().numpy()


def family_f32_tokens(kind: str, cfg32, model, device) -> dict:
    """The f32 token check's tokens (the engine for rwkv6 and zamba2, 2
    prompts of FM_F32_PROMPT, FM_F32_GEN out; whisper's ``serve_fn``
    chain of FM_WHISPER_F32_ROWS x FM_WHISPER_F32_STEPS) and its
    launches."""
    reset_launches()
    if kind == "whisper":
        tokens, frames = whisper_mesh_inputs(cfg32, device,
                                             FM_WHISPER_F32_ROWS)
        ch = whisper_chain(cfg32, model, tokens, frames,
                           FM_WHISPER_F32_STEPS)
        return {"tokens": ch["tokens"].cpu().tolist(),
                "launches": ch["launches"], "logits": ch["logits"]}
    toks = mesh_engine_tokens(cfg32, model, device,
                              family_f32_prompts(cfg32, device), FM_F32_GEN)
    return {"tokens": toks.cpu().tolist(), "launches": read_launches(),
            "engine_tokens": toks}


def family_one_rank(kind: str, device) -> dict:
    """One rank's f32 tokens with their top-2 margins, and its f32 and
    bf16 logits of the bf16 check (``mesh_bf16_logits``, whisper's
    ``whisper_mesh_logits``), at the f32 check's depth."""
    import torch

    from repro_torch.launch import serve as launch
    from repro_torch.models import registry

    layers = {"rwkv6": FM_RWKV_F32_LAYERS, "zamba2": FM_ZAMBA_F32_LAYERS,
              "whisper": None}[kind]
    logits_of = (whisper_mesh_logits if kind == "whisper"
                 else mesh_bf16_logits)
    cfg32 = family_config(kind, layers, "float32")
    model = launch.build_model(cfg32, 0, device)
    got = family_f32_tokens(kind, cfg32, model, device)
    if kind == "whisper":
        margin = _margins(got["logits"]).cpu()
    else:
        prompts = family_f32_prompts(cfg32, device)
        # the last token too, so that zamba2's scan sees P + gen tokens,
        # a multiple of the smoke config's SSD chunk of 8
        with torch.no_grad():
            logits = registry.logits_fn(cfg32, model, {"tokens": torch.cat(
                [prompts, got["engine_tokens"]], dim=1)})
        margin = _margins(logits[:, FM_F32_PROMPT - 1:-1]).cpu()
    f32_logits = logits_of(cfg32, model, device)
    del model
    torch.cuda.empty_cache()
    cfg16 = family_config(kind, layers)
    model = launch.build_model(cfg16, 0, device)
    bf16_logits = logits_of(cfg16, model, device)
    del model
    torch.cuda.empty_cache()
    return {"tokens": got["tokens"], "margin": margin.tolist(),
            "f32_logits": f32_logits, "bf16_logits": bf16_logits}


def _family_serve(mesh, device, kind: str) -> dict:
    """(a) / (c) The engine on the mesh in bf16 (rwkv6 uncut, zamba2 at
    FM_ZAMBA_LAYERS): the requests after a warm-up of one, with the
    launches and the pool's local shapes; one scan-path prefill
    (``registry.prefill_fn``) with its launches; then at the f32 check's
    depth the bf16 check's logits and the f32 engine's tokens."""
    import statistics

    import torch
    import torch.distributed as dist

    from repro_torch.launch import serve as launch
    from repro_torch.models import registry
    from repro_torch.serve import ServeEngine

    rw = kind == "rwkv6"
    cfg = family_config(kind, None if rw else FM_ZAMBA_LAYERS)
    n_req, lengths, gen = ((FM_RWKV_REQUESTS, FM_RWKV_PROMPT, FM_RWKV_GEN)
                           if rw else (FM_ZAMBA_REQUESTS, FM_ZAMBA_PROMPT,
                                       FM_ZAMBA_GEN))
    model = launch.build_model(cfg, 0, device, mesh)
    engine = ServeEngine(cfg, max_slots=SERVE_SLOTS,
                         max_prefill_len=lengths[1], max_gen_len=gen,
                         device=device)
    launch.drive(engine, model, [(0, rwkv6_prompts(cfg, 1, (4, 4),
                                                   seed=9)[0], 2)])
    requests = [(r, p, gen) for r, p in enumerate(
        rwkv6_prompts(cfg, n_req, lengths, seed=1))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    reset_launches()
    outputs, stats = launch.drive(engine, model, requests)
    torch.cuda.synchronize()
    out = {"launches": read_launches(),
           "expected": serve_launches_expected(cfg, stats),
           "stats": {k: stats[k] for k in (
               "steps", "tokens_out", "wall_s", "tokens_per_s", "prefills",
               "prompt_tokens", "prefill_s", "mean_occupancy")},
           "step_ms_median": statistics.median(stats["step_ms"]),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "outputs_digest": _json_digest(outputs),
           "ok_tokens": all(len(outputs[r]) == g and all(
               0 <= t < cfg.vocab for t in outputs[r])
               for r, _, g in requests),
           "pool": {k: list(v.shape) for k, v in
                    engine.init_state()["cache"].items()}}
    del engine
    n_scan = FM_RWKV_SCAN if rw else FM_ZAMBA_SCAN
    scan = torch.as_tensor(rwkv6_prompts(cfg, 1, (n_scan, n_scan),
                                         seed=3)[0][None], device=device)
    dist.barrier()
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = registry.prefill_fn(cfg)(model, {"tokens": scan})
    torch.cuda.synchronize()
    out["scan"] = {"tokens": n_scan, "wall_s": time.perf_counter() - t0,
                   "launches": read_launches(),
                   "ok": cache is None and bool(torch.isfinite(
                       logits).all()) and tuple(logits.shape) == (
                       1, 1, cfg.padded_vocab // mesh.shape["model"])}
    del model, logits
    torch.cuda.empty_cache()
    layers = FM_RWKV_F32_LAYERS if rw else FM_ZAMBA_F32_LAYERS
    model = launch.build_model(family_config(kind, layers), 0, device, mesh)
    out["bf16_logits"] = mesh_bf16_logits(family_config(kind, layers),
                                          model, device)
    del model
    cfg32 = family_config(kind, layers, "float32")
    model = launch.build_model(cfg32, 0, device, mesh)
    got = family_f32_tokens(kind, cfg32, model, device)
    out["f32_tokens"], out["f32_launches"] = got["tokens"], got["launches"]
    del model
    torch.cuda.empty_cache()
    return out


def _whisper_mesh_serve(mesh, device) -> dict:
    """(e) whisper uncut on the mesh in bf16: ``whisper_chain`` of
    FM_WHISPER_ROWS rows, a WHISPER_PROMPT-token prompt each and
    FM_WHISPER_STEPS steps (its launches: the steps' cross-attention),
    the bf16 check's logits; then the f32 chain's tokens."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import serve as launch

    cfg = family_config("whisper")
    model = launch.build_model(cfg, 0, device, mesh)
    tokens, frames = whisper_mesh_inputs(cfg, device, FM_WHISPER_ROWS)
    dist.barrier()
    t0 = time.perf_counter()
    ch = whisper_chain(cfg, model, tokens, frames, FM_WHISPER_STEPS,
                       timed=True)
    out = {"wall_s": time.perf_counter() - t0, "launches": ch["launches"],
           "step_ms_median": 1e3 * sorted(ch["walls_s"])[
               len(ch["walls_s"]) // 2],
           "tokens_digest": _json_digest(ch["tokens"].cpu().tolist()),
           "ok_tokens": bool(((ch["tokens"] >= 0)
                              & (ch["tokens"] < cfg.vocab)).all()),
           "logits_block": list(ch["logits"].shape)}
    out["bf16_logits"] = whisper_mesh_logits(cfg, model, device)
    del model, ch
    torch.cuda.empty_cache()
    cfg32 = family_config("whisper", dtype="float32")
    model = launch.build_model(cfg32, 0, device, mesh)
    got = family_f32_tokens("whisper", cfg32, model, device)
    out["f32_tokens"], out["f32_launches"] = got["tokens"], got["launches"]
    del model, got
    torch.cuda.empty_cache()
    return out


FM_ONE_DIR = ROOT / "build" / "3s_one_rank"  # the one-rank gradients


def family_train_inputs(kind: str, device):
    """(b) / (d) / (e)'s f32 config, train config, seeded whole params
    and check batch (rwkv6 2 x FM_TRAIN_SEQ, zamba2 1 x FM_TRAIN_SEQ,
    whisper FM_WHISPER_TRAIN), the same in every process."""
    import torch

    from repro_torch.models import nn, registry
    from repro_torch.train import steps

    layers = {"rwkv6": FM_RWKV_TRAIN_LAYERS,
              "zamba2": FM_ZAMBA_TRAIN_LAYERS, "whisper": None}[kind]
    cfg = family_config(kind, layers, "float32")
    tc = steps.TrainConfig(optimizer="adamw", lr=3e-4)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    full = nn.init_params(registry.param_specs(cfg), gen, device)
    rows, seq = {"rwkv6": (2, FM_TRAIN_SEQ), "zamba2": (1, FM_TRAIN_SEQ),
                 "whisper": FM_WHISPER_TRAIN}[kind]
    return cfg, tc, full, check_batch(cfg, device, seq, rows), rows, seq


def family_one_rank_grads(device) -> float:
    """The one-rank f32 loss and gradient of (b), (d) and (e), computed
    once here on the whole card before the ranks start (each rank used to
    compute its own) and written to FM_ONE_DIR, which ``_family_train``
    reads by memory map; the seconds it took."""
    import torch

    from repro_torch.train import steps

    t0 = time.perf_counter()
    FM_ONE_DIR.mkdir(parents=True, exist_ok=True)
    for kind in ("rwkv6", "zamba2", "whisper"):
        cfg, tc, full, batch, _, _ = family_train_inputs(kind, device)
        loss1, g1 = steps.loss_and_grads(cfg, tc, full, batch)
        del full
        torch.save({"loss": float(loss1),
                    "grads": [x.cpu() for x in _leaves(g1)],
                    "scales": [float(x.abs().max()) for x in _leaves(g1)]},
                   FM_ONE_DIR / f"{kind}.pt")
        del g1
        torch.cuda.empty_cache()
    return time.perf_counter() - t0


def _family_train(mesh, device, kind: str) -> dict:
    """(b) / (d) / (e) f32 on FM_TRAIN, the state under
    ``train_state_shardings`` (PARAM_RULES: FSDP over data, tensor
    parallel over model): the mesh's loss and gradient on its check batch
    (``family_train_inputs``) against the one-rank step's on the same
    params (``family_one_rank_grads``; errors reduced to their max over
    the ranks), with the launches, the wall and the peak of the mesh's
    pass.  (The step around this gradient, ``build_train_step(mesh=)``,
    runs in the compressed pods, ``_whisper_pods``.)"""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding
    from repro_torch.train import steps

    cfg, tc, full, batch, rows, seq = family_train_inputs(kind, device)
    shard = steps.train_state_shardings(cfg, tc, mesh)["params"]
    local = sharding.shard_tree(full, shard)
    del full
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    reset_launches()
    t0 = time.perf_counter()
    loss, g = steps.mesh_loss_and_grads(cfg, tc, mesh, local, batch, shard)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    one = torch.load(FM_ONE_DIR / f"{kind}.pt", mmap=True)
    loss1, g1 = one["loss"], one["grads"]
    specs = sharding.tree_leaves(shard)
    errs = [float((x - sharding.shard_tensor(y, ns.spec, mesh).to(device))
                  .abs().max()) / max(scale, 1e-30)
            for x, y, ns, scale in zip(_leaves(g), g1, specs, one["scales"])]
    errs = coll.all_reduce_max(torch.tensor(
        errs, dtype=torch.float64, device=device), dist.group.WORLD).tolist()
    worst = max(errs)
    loss_rel = abs(float(loss) - float(loss1)) / abs(float(loss1))
    exact = family_f64_check(cfg, mesh, device, g, g1, errs, specs, rows,
                             seq)
    out = {"loss": float(loss), "loss_one": float(loss1),
           "loss_rel": loss_rel, "grad_rel": worst, "wall": wall,
           "exact": exact, "launches": launches, "peak_bytes": peak,
           "local_params": sum(t.numel() for t in _leaves(local)),
           "rows": rows, "seq": seq}
    del g, g1, one, local
    torch.cuda.empty_cache()
    return out


def family_f64_check(cfg, mesh, device, g, g1, errs, specs, rows: int,
                     seq: int) -> dict:
    """Where a leaf of the mesh's f32 gradient ``g`` (the rank's blocks)
    lies further than FM_GRAD_REL max|g| from one rank's ``g1`` (its
    leaves, on the host; ``errs``,
    each leaf's maximum over the ranks), the f64 gradient decides, as
    ``check_train_gradient_f32`` does: the leaves over the bar are
    gathered whole, rank 0 alone computes the f64 gradient
    (``f64_gradient`` on the same seeded params and batch) while the
    others wait, and each such leaf's error from it (of max|f64|) is
    returned for the mesh and for one rank: {leaf index: (mesh, one)}."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import sharding
    from repro_torch.models import nn, registry

    over = [i for i, e in enumerate(errs) if e > FM_GRAD_REL]
    if not over:
        return {}
    mesh_leaves = [sharding.unshard(_leaves(g)[i], specs[i].spec, mesh)
                   for i in over]
    one_leaves = [g1[i].to(device) for i in over]
    out = {}
    if dist.get_rank() == 0:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        full = nn.init_params(registry.param_specs(cfg), gen, device)
        _, g64 = f64_gradient(cfg, full, device, seq, rows)
        del full
        for i, a, b in zip(over, mesh_leaves, one_leaves):
            e = _leaves(g64)[i].double()
            emax = max(float(e.abs().max()), 1e-300)
            out[i] = (float((a.double() - e).abs().max()) / emax,
                      float((b.double() - e).abs().max()) / emax)
        del g64
    del mesh_leaves, one_leaves
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _whisper_pods(mesh, device) -> dict:
    """(e) whisper uncut in bf16 on FM_PODS, NO_FSDP_RULES,
    aggregate_gaussian fused b = 8 over the pods: FM_WHISPER_POD_STEPS
    steps of FM_WHISPER_TRAIN, each step's wall, loss and the digest of
    this rank's params; the launches and the peak."""
    import torch
    import torch.distributed as dist

    from repro_torch.train import steps

    cfg = family_config("whisper")
    tc = steps.TrainConfig(optimizer="adamw", lr=3e-4,
                           compression=_train_comp("aggregate_gaussian",
                                                   TRAIN_SIGMA))
    state = steps.init_train_state(cfg, tc, 0, device, mesh=mesh)
    step_fn = steps.build_train_step(cfg, tc, mesh=mesh)
    rows, seq = FM_WHISPER_TRAIN
    out = {"walls": [], "losses": [], "digests": [],
           "leaves": len(_leaves(state["params"]))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    reset_launches()
    for i in range(FM_WHISPER_POD_STEPS):
        batch = check_batch(cfg, device, seq, rows)
        dist.barrier()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, TRAIN_SEED + i)
        torch.cuda.synchronize()
        out["walls"].append(time.perf_counter() - t0)
        out["losses"].append(float(m["loss"]))
        out["digests"].append(_digest(_leaves(state["params"])))
        out["cohort"] = int(m["cohort"])
    out["launches"] = read_launches()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del state
    torch.cuda.empty_cache()
    return out


def _f32_ties(label: str, got: list, one: dict) -> list:
    """Rows of f32 tokens against one rank's: a differing token allowed
    only where one rank's top-2 margin there is below MARGIN, once."""
    ties = []
    for b, want in enumerate(one["tokens"]):
        diff = [t for t in range(len(want)) if got[b][t] != want[t]]
        if diff:
            m = one["margin"][b][diff[0]]
            check(m < MARGIN, f"{label} f32 row {b} token {diff[0]} differs "
                              f"with top-2 margin {m}")
            ties.append({"row": b, "token": diff[0], "margin": m})
    check(len(ties) <= 1, f"{label}: {len(ties)} ties")
    return ties


def _check_train_job(label: str, ranks: dict, want: dict) -> dict:
    """(b) / (d) / (e)'s f32 gradient: the loss and gradient bars (a leaf
    over FM_GRAD_REL from one rank passes if its error from the f64
    gradient is at most twice one rank's, ``family_f64_check``) and the
    launches of the mesh's pass as ``want`` (per rank)."""
    g0 = ranks[0]
    for i, (em, eo) in g0["exact"].items():
        check(em <= 2 * eo, f"{label} leaf {i}: {em:.3e} of max|g| from the "
              f"f64 gradient, one rank {eo:.3e}")
    for r, g in ranks.items():
        check(g["loss_rel"] <= FM_LOSS_REL, f"{label} rank {r}: loss "
              f"{g['loss']} vs one rank {g['loss_one']}")
        check(g["grad_rel"] <= FM_GRAD_REL or g0["exact"], f"{label}: "
              f"gradient {g['grad_rel']} of max|g|")
        check(math.isfinite(g["loss"]), f"{label} rank {r}: loss {g['loss']}")
        for k in KERNELS:
            check(g["launches"].get(k, 0) == want.get(k, 0),
                  f"{label} rank {r}: {g['launches'].get(k, 0)} {k} "
                  f"launches, expected {want.get(k, 0)}")
    return {"loss_rel": g0["loss_rel"], "grad_rel": g0["grad_rel"],
            "loss": g0["loss"], "leaves_held_to_f64": g0["exact"],
            "grad_wall_s": {r: g["wall"] for r, g in ranks.items()},
            "peak_gib": {r: g["peak_bytes"] / 2**30
                         for r, g in ranks.items()},
            "local_params": {r: g["local_params"] for r, g in ranks.items()},
            "launches_per_rank": g0["launches"],
            "batch": [g0["rows"], g0["seq"]],
            "job_s": {r: g["job_s"] for r, g in ranks.items()}}


def family_mesh_jobs() -> tuple:
    """3s's rank sides: (b), (d) and (e)'s training on 4 ranks, (a), (c)
    and (e)'s serving on the 2 of FM_SERVE."""
    return ((("family_train/rwkv6", FM_TRAIN, ("rwkv6",)),
             ("family_train/zamba2", FM_TRAIN, ("zamba2",)),
             ("family_train/whisper", FM_TRAIN, ("whisper",)),
             ("whisper_pods", FM_PODS, ())),
            (("family_serve/rwkv6", FM_SERVE, ("rwkv6",)),
             ("family_serve/zamba2", FM_SERVE, ("zamba2",)),
             ("whisper_serve", FM_SERVE, ())))


# 3r's jobs (up to 2 x 35.8 GiB) start only once the 4 ranks and 3b's
# ranks have ended and this process holds nothing
GATED_JOBS = ("moe_block", "moe_serve", "moe_train")
GATE_TIMEOUT = 900.0  # their wait: the FL rounds, 3b and the 4 ranks


def start_mesh_spawns(device) -> dict:
    """Start the rank sides of phases 3q, 3r and 3s in two spawns, one of
    4 ranks and one of 2, which run beside the FL rounds and 3b (their
    ranks wait on gloo and the host, those phases on the card's draws;
    together ~60 GiB at most).  The 2 ranks take 3r's jobs last, behind a
    gate that ``finish_mesh_spawns`` opens once the 4 ranks and 3b's ranks
    have ended.  The one-rank f32 gradients of 3s come first, on the whole
    card."""
    import multiprocessing

    q4, q2 = mesh_phase_jobs()
    s4, s2 = family_mesh_jobs()
    one_s = family_one_rank_grads(device)
    log(f"phase 3s: the one-rank f32 gradients once, {one_s:.1f} s")
    gate = multiprocessing.get_context("spawn").Event()
    return {"gate": gate,
            "four": _mesh_spawn_start(MESH_RANKS, q4 + s4, device),
            "two": _mesh_spawn_start(2, q2 + s2 + moe_mesh_jobs(), device,
                                     gate)}


def finish_mesh_spawns(spawns: dict) -> tuple:
    """``start_mesh_spawns``'s results, (four, two): the 4 ranks, then the
    gate opened, then the 2."""
    try:
        four = _mesh_spawn_collect(spawns["four"])
    except BaseException:
        _spawn_collect(spawns["two"]["started"], 0, 0.0)  # stop the 2
        raise
    spawns["gate"].set()
    two = _mesh_spawn_collect(spawns["two"])
    log(f"mesh spawns: 4 ranks {four['spawn_to_exit_s']:.1f} s from spawn "
        f"to exit, 2 ranks {two['spawn_to_exit_s']:.1f} s, of which "
        f"{max(two['gate_wait_s'].values()):.1f} s at the gate")
    return four, two


def run_family_mesh_phase(device, four: dict, two: dict) -> dict:
    """Phase 3s: rwkv6, zamba2 and whisper on the (pod, data, model) mesh,
    gloo ranks sharing the card: (a), (c) and (e)'s serving ran in
    ``two``, the spawn of 2 ranks, (b), (d) and (e)'s training in
    ``four`` (``start_mesh_spawns``).

    (a) rwkv6-1.6b uncut, bf16, ``ServeEngine(mesh=)``: FM_RWKV_REQUESTS
    requests of FM_RWKV_PROMPT tokens, FM_RWKV_GEN out, the same tokens on
    both ranks, wkv6_step once per layer per decode call on each rank
    (each prompt token is one); the pool holding the rank's 16 heads of
    wkv and its 1024 of D of the shift tokens; one scan-path prefill of
    FM_RWKV_SCAN tokens (wkv6_fwd once per layer); at FM_RWKV_F32_LAYERS
    the f32 tokens one rank's (a differing token only at a tie) and the
    bf16 logits no further from f32 than MESH_BF16_FACTOR times one
    rank's.  (b) rwkv6 at FM_RWKV_TRAIN_LAYERS on FM_TRAIN in f32, 2 x
    FM_TRAIN_SEQ: the loss within 1e-6 relative and every leaf within
    1e-4 max|g| of one rank's (2 L wkv6_fwd and L wkv6_bwd a rank,
    remat).  (c) zamba2-7b at FM_ZAMBA_LAYERS, as (a) (no kernel in the
    engine: its decode is plain PyTorch, as the reference's), its
    scan-path prefill of FM_ZAMBA_SCAN tokens past the window (the flash
    kernel once per group), the f32 and bf16 checks at
    FM_ZAMBA_F32_LAYERS.  (d) zamba2 at FM_ZAMBA_TRAIN_LAYERS on
    FM_TRAIN, 1 x FM_TRAIN_SEQ, as (b) (the f32 flash kernels, window
    4096).  (e) whisper-small uncut: the f32 gradient on FM_TRAIN as (b);
    the compressed step on FM_PODS (params bitwise across pods per model
    rank, one fused encode and decode per leaf a step); a ``serve_fn``
    chain on FM_SERVE of FM_WHISPER_ROWS x FM_WHISPER_STEPS (the steps'
    cross-attention: flash_attention_sm90 once per layer), its f32 tokens
    one rank's and its bf16 logits by MESH_BF16_FACTOR."""
    from repro_torch.models import zamba2

    t0 = time.perf_counter()
    one = {k: family_one_rank(k, device)
           for k in ("rwkv6", "zamba2", "whisper")}
    res = {"one_rank_s": time.perf_counter() - t0,
           "job_s": {name: max(got["jobs"][name][r]["job_s"]
                               for r in got["jobs"][name])
                     for got, jobs in zip((four, two), family_mesh_jobs())
                     for name, _, _ in jobs}}
    launches = {k: 0 for k in KERNELS}

    def add(ln):
        for k in KERNELS:
            launches[k] += ln.get(k, 0)

    for kind in ("rwkv6", "zamba2"):
        sr = two["jobs"][f"family_serve/{kind}"]
        s0 = sr[0]
        cfg = family_config(kind, None if kind == "rwkv6"
                            else FM_ZAMBA_LAYERS)
        L = cfg.n_layers
        for r, g in sr.items():
            check(g["ok_tokens"], f"mesh serve {kind} rank {r}: tokens")
            check(g["outputs_digest"] == s0["outputs_digest"],
                  f"mesh serve {kind}: rank {r}'s tokens differ")
            for k in KERNELS:
                check(g["launches"].get(k, 0) == g["expected"].get(k, 0),
                      f"mesh serve {kind} rank {r}: {g['launches'].get(k, 0)}"
                      f" {k} launches, expected {g['expected'].get(k, 0)}")
            scan_want = ({"wkv6_fwd": L} if kind == "rwkv6" else
                         {"flash_attention_sm90": zamba2.layout(cfg)[0]})
            check(g["scan"]["ok"], f"mesh {kind} scan prefill rank {r}")
            for k in KERNELS:
                check(g["scan"]["launches"].get(k, 0) == scan_want.get(k, 0),
                      f"mesh {kind} scan prefill rank {r}: launches "
                      f"{g['scan']['launches']}")
            check(g["f32_tokens"] == s0["f32_tokens"],
                  f"mesh serve {kind}: f32 tokens differ across ranks")
            add(g["launches"])
            add(g["scan"]["launches"])
            add(g["f32_launches"])
        if kind == "rwkv6":
            H, D = cfg.n_heads, cfg.d_model
            check(s0["pool"]["wkv"][2] == H // 2 and s0["pool"][
                "prev_tm"][3] == D // 2, f"mesh rwkv6 pool {s0['pool']}")
        ties = _f32_ties(f"mesh serve {kind}", s0["f32_tokens"], one[kind])
        bf16 = mesh_bf16_reading(one[kind], sr)
        check(bf16["ratio"] <= MESH_BF16_FACTOR,
              f"mesh serve {kind}: bf16 logits {bf16['mesh_err']} from f32, "
              f"one rank's {bf16['one_err']}")
        res[f"serve_{kind}"] = {
            "mesh": FM_SERVE, "layers": L, "stats": s0["stats"],
            "tokens_per_s": s0["stats"]["tokens_per_s"],
            "step_ms_median": s0["step_ms_median"],
            "peak_gib": {r: g["peak_bytes"] / 2**30 for r, g in sr.items()},
            "pool": s0["pool"], "launches_per_rank": s0["launches"],
            "scan": s0["scan"], "f32_ties": ties, "bf16_logits": bf16,
            "job_s": {r: g["job_s"] for r, g in sr.items()}}
        log(f"mesh serve {kind} {FM_SERVE} ({L} layers, bf16): "
            f"{s0['stats']['prefills']} requests, "
            f"{s0['stats']['prompt_tokens']} prompt tokens, "
            f"{s0['stats']['tokens_out']} out in {s0['stats']['wall_s']:.3f} "
            f"s ({s0['stats']['tokens_per_s']:.2f} tokens/s, median decode "
            f"step {s0['step_ms_median']:.3f} ms); pool per rank "
            f"{json.dumps(s0['pool'])}; launches per rank "
            f"{s0['launches']}; scan prefill of {s0['scan']['tokens']} "
            f"tokens {s0['scan']['wall_s']:.3f} s, launches "
            f"{s0['scan']['launches']}; f32 tokens one rank's "
            f"({len(ties)} tie(s)); bf16 logits {json.dumps(bf16)}")

    wr = two["jobs"]["whisper_serve"]
    w0 = wr[0]
    wcfg = family_config("whisper")
    for r, g in wr.items():
        check(g["ok_tokens"] and g["tokens_digest"] == w0["tokens_digest"],
              f"mesh whisper chain rank {r}: tokens")
        want = {"flash_attention_sm90": wcfg.n_layers * FM_WHISPER_STEPS}
        for k in KERNELS:
            check(g["launches"].get(k, 0) == want.get(k, 0),
                  f"mesh whisper chain rank {r}: launches {g['launches']}")
        check(g["f32_launches"].get("flash_attention_f32", 0)
              == wcfg.n_layers * FM_WHISPER_F32_STEPS,
              f"mesh whisper f32 chain rank {r}: {g['f32_launches']}")
        check(g["f32_tokens"] == w0["f32_tokens"],
              "mesh whisper: f32 tokens differ across ranks")
        add(g["launches"])
        add(g["f32_launches"])
    ties = _f32_ties("mesh whisper chain", w0["f32_tokens"], one["whisper"])
    bf16 = mesh_bf16_reading(one["whisper"], wr)
    check(bf16["ratio"] <= MESH_BF16_FACTOR,
          f"mesh whisper: bf16 logits {bf16['mesh_err']} from f32, one "
          f"rank's {bf16['one_err']}")
    res["serve_whisper"] = {
        "mesh": FM_SERVE, "rows": FM_WHISPER_ROWS,
        "steps": FM_WHISPER_STEPS, "wall_s": w0["wall_s"],
        "step_ms_median": w0["step_ms_median"],
        "logits_block": w0["logits_block"],
        "launches_per_rank": w0["launches"], "f32_ties": ties,
        "bf16_logits": bf16, "job_s": {r: g["job_s"] for r, g in wr.items()}}
    log(f"mesh whisper chain {FM_SERVE} (bf16, {FM_WHISPER_ROWS} rows x "
        f"{FM_WHISPER_STEPS} steps): {w0['wall_s']:.3f} s with the caches' "
        f"build, median step {w0['step_ms_median']:.3f} ms, logits block "
        f"{w0['logits_block']}, launches per rank {w0['launches']}; f32 "
        f"tokens one rank's ({len(ties)} tie(s)); bf16 logits "
        f"{json.dumps(bf16)}")

    for kind in ("rwkv6", "zamba2", "whisper"):
        tr = four["jobs"][f"family_train/{kind}"]
        layers = {"rwkv6": FM_RWKV_TRAIN_LAYERS,
                  "zamba2": FM_ZAMBA_TRAIN_LAYERS, "whisper": None}[kind]
        want = {k: v for k, v in train_launches_expected(
            family_config(kind, layers, "float32"), 1).items()
            if not k.startswith("fused")}
        res[f"train_{kind}"] = _check_train_job(f"mesh train {kind}", tr,
                                                want)
        for g in tr.values():
            add(g["launches"])
        t = res[f"train_{kind}"]
        log(f"mesh train {kind} {FM_TRAIN} (f32, {t['batch'][0]} x "
            f"{t['batch'][1]}): loss {t['loss_rel']:.3g} relative, gradient "
            f"{t['grad_rel']:.3g} of max|g| from one rank; leaves over "
            f"{FM_GRAD_REL:g} held to 2x one rank's error from f64 (leaf: "
            f"mesh, one rank) {json.dumps(t['leaves_held_to_f64'])}; the "
            f"mesh's pass {t['grad_wall_s'][0]:.3f} s (rank 0), peak "
            f"{t['peak_gib'][0]:.2f} GiB, launches per rank "
            f"{t['launches_per_rank']}")

    pods = four["jobs"]["whisper_pods"]
    pod_want = train_launches_expected(wcfg, 1)
    for r, g in pods.items():
        twin = next(o for o, h in pods.items() if o != r and
                    h["coords"]["model"] == g["coords"]["model"])
        check(g["digests"] == pods[twin]["digests"],
              f"mesh whisper pods: rank {r}'s params differ from rank "
              f"{twin}'s (the other pod, same model rank)")
        check(g["losses"] == pods[0]["losses"] and all(
            math.isfinite(x) for x in g["losses"]),
            f"mesh whisper pods rank {r}: losses {g['losses']}")
        check(g["cohort"] == FM_PODS[0], f"cohort {g['cohort']}")
        for k in KERNELS:
            check(g["launches"].get(k, 0)
                  == FM_WHISPER_POD_STEPS * pod_want.get(k, 0),
                  f"mesh whisper pods rank {r}: launches {g['launches']}")
        add(g["launches"])
    p0 = pods[0]
    res["pods_whisper"] = {
        "mesh": FM_PODS, "walls_s": {r: g["walls"] for r, g in pods.items()},
        "losses": p0["losses"], "leaves": p0["leaves"],
        "peak_gib": {r: g["peak_bytes"] / 2**30 for r, g in pods.items()},
        "launches_per_rank": p0["launches"],
        "job_s": {r: g["job_s"] for r, g in pods.items()}}
    log(f"mesh whisper pods {FM_PODS} (bf16, aggregate_gaussian fused b = "
        f"{BITS}, {FM_WHISPER_TRAIN[0]} x {FM_WHISPER_TRAIN[1]}): step walls "
        f"(rank 0) {[round(w, 3) for w in p0['walls']]} s, losses "
        f"{p0['losses']}, params bitwise equal across pods per model rank; "
        f"launches per rank {p0['launches']}")
    res["launches"] = launches
    log(f"phase 3s: one-rank references {res['one_rank_s']:.1f} s; its "
        f"jobs in the shared spawns (s, slowest rank) "
        f"{json.dumps(res['job_s'])}")
    return res


MESH_JOBS.update({"family_serve": _family_serve,
                  "whisper_serve": _whisper_mesh_serve,
                  "family_train": _family_train,
                  "whisper_pods": _whisper_pods})


# ------------------------------------------------------------ phase 3t
# The dry run (``launch.dryrun``) of three cells on the production meshes:
# rank 0's program on meta tensors (its own process, off the card, started
# at the top of the run) and replayed on the card at its block shapes over
# the same recording groups; then the cut query heads held numerically.
#   (a) starcoder2-3b train_4k on (16, 16), grad_accum 8: 24 query heads
#       cut by the model axis (1.5 a rank), the flash kernels on all heads
#       at (2, 4096, 24 / 2, 128) a microbatch;
#   (b) minitron-4b decode_32k on (16, 16): the cut heads on the cache
#       split over the sequence (8 KV heads over 16);
#   (c) qwen1.5-0.5b train_4k on (2, 16, 16), irwin_hall over the pods:
#       the pods' aggregation and the compressed step's whole-leaf gathers;
#   (d) whisper-small uncut on (1, 1, 8) gloo ranks sharing the card (12
#       heads over 8): one f32 forward of HS_ROWS x (1500, HS_TOKENS)
#       within HS_LOGIT_REL max|logit| of one rank, and a ``serve_fn``
#       chain of HS_CHAIN_ROWS x HS_CHAIN_STEPS whose f32 tokens are one
#       rank's.
DRYRUN_CELLS = (("a", "starcoder2-3b", "train_4k", False, "none"),
                ("b", "minitron-4b", "decode_32k", False, "none"),
                ("c", "qwen1.5-0.5b", "train_4k", True, "irwin_hall"))
DRYRUN_DIR = ROOT / "build" / "dryrun_3t"
DRYRUN_PEAK = (0.8, 1.25)    # the card's peak over the meta prediction
ALLOC_ROUND = 512            # the caching allocator's rounding, a tensor
# (B, T, S, H, HK) at which the dry run's flash-backward scratch (meta's
# ``flash_attention.bwd_work_bytes``) is held to the built libraries'
# ``<name>_work_bytes``, at every head dim: (a)'s microbatch, (c)'s,
# whisper's cross-attention chain and training, zamba2's, ragged lengths
SCRATCH_SHAPES = ((2, 4096, 4096, 24, 2), (1, 4096, 4096, 16, 16),
                  (8, 1, 1500, 12, 12), (8, 448, 1500, 12, 12),
                  (1, 8192, 8192, 32, 32), (3, 127, 129, 24, 8))
HS_MESH = (1, 1, 8)
HS_ROWS, HS_TOKENS = 2, 448
HS_CHAIN_ROWS, HS_CHAIN_STEPS = 8, 16
HS_LOGIT_REL = 1e-5          # of max|logit|
HS_TIMEOUT = 300.0


def start_dryrun_meta():
    """The meta runs of DRYRUN_CELLS (``dryrun.run_cell``, their JSON in
    DRYRUN_DIR) in a process of their own that sees no card, started now
    so that they overlap the card's phases: the Popen (``finish_dryrun_
    meta`` waits for it)."""
    import atexit
    import os
    import shutil

    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    cells = [(a, s, mp, c) for _, a, s, mp, c in DRYRUN_CELLS]
    code = ("import sys\n"
            "from repro_torch.launch import dryrun\n"
            f"for a, s, mp, c in {cells!r}:\n"
            f"    dryrun.run_cell(a, s, mp, {str(DRYRUN_DIR)!r}, c)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = open(DRYRUN_DIR / "meta.log", "w")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=out, stderr=subprocess.STDOUT)
    # stopped however the run ends
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def finish_dryrun_meta(proc) -> dict:
    """Wait for the meta runs; their records by cell label."""
    rc = proc.wait(timeout=600)
    text = (DRYRUN_DIR / "meta.log").read_text()
    check(rc == 0, f"dry run on meta exited {rc}:\n{text[-3000:]}")
    out = {}
    for label, arch, shape, mp, _ in DRYRUN_CELLS:
        path = DRYRUN_DIR / f"{arch}_{shape}{'_mp' if mp else ''}.json"
        out[label] = json.loads(path.read_text())
    return out


def dryrun_replay(arch: str, shape: str, multi_pod: bool, compress: str,
                  device) -> dict:
    """Rank 0's program of a cell on the card (``dryrun.run_replay``)
    over a fresh recording mesh: its record."""
    from repro_torch import configs
    from repro_torch.dist import collectives as coll
    from repro_torch.dist import meshctx
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    record = coll.new_record()
    mesh = make_production_mesh(multi_pod=multi_pod, record=record)
    fn, args, shardings = dryrun.build_cell(arch, shape, mesh, compress)
    try:
        got = dryrun.run_replay(fn, args, shardings,
                                configs.SHAPES[shape]["step"],
                                configs.get_config(arch), device)
    finally:
        meshctx.set_mesh(None)
    got["collective_bytes"], got["collective_counts"] = \
        dryrun.collective_bytes(record)
    return got


def check_bwd_scratch() -> int:
    """The dry run's flash-backward scratch on meta
    (``flash_attention.bwd_work_bytes``) equals what each built backward
    library's ``<name>_work_bytes`` asks for at SCRATCH_SHAPES and every
    head dim; the number of cases held."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    n = 0
    for dtype, name in fa.BWD_KERNELS.items():
        fn = getattr(build.load(name), name + "_work_bytes")
        fn.argtypes = [ctypes.c_int] * 6
        fn.restype = ctypes.c_size_t
        for shape in SCRATCH_SHAPES:
            for d in fa.HEAD_DIMS:
                want = fn(*shape, d)
                got = fa.bwd_work_bytes(dtype, *shape, d)
                check(got == want, f"3t: {name} scratch at {shape}, D = "
                                   f"{d}: meta {got} bytes, library {want}")
                n += 1
    log(f"3t: the flash backwards' scratch on meta equals the libraries' "
        f"<name>_work_bytes at all {n} cases")
    return n


def check_dryrun_cell(label: str, meta: dict, card: dict) -> dict:
    """(a)-(c): the collectives by kind equal the meta run's; the bytes
    the card's allocator was asked for while placing the inputs equal the
    argument bytes, and the bytes it allocated exceed them by at most its
    rounding, ALLOC_ROUND a tensor (with expandable segments, as ``main``
    sets them: a fixed segment may leave a block of over 1 MiB an unsplit
    rest of up to 1 MiB); the card's peak within DRYRUN_PEAK of the
    prediction (arguments + temp); the launches the meta run's kernel
    calls; the outputs finite.  Every reading is logged before the first
    check."""
    mem = meta["memory"]
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    ratio = card["peak_bytes"] / predicted
    slack = card["allocated_after_placing"] - card["argument_bytes"]
    out = {"peak_ratio": ratio, "predicted_bytes": predicted,
           "alloc_slack_bytes": slack}
    log(f"3t ({label}) readings: {json.dumps(out)}")
    for key in ("collective_bytes", "collective_counts"):
        check(card[key] == meta[key], f"3t ({label}) {key}: card "
              f"{card[key]}, meta {meta[key]}")
    check(card["argument_bytes"] == mem["argument_size_in_bytes"]
          == card["requested_after_placing"],
          f"3t ({label}): arguments {card['argument_bytes']} on the card, "
          f"{card['requested_after_placing']} requested of its allocator, "
          f"{mem['argument_size_in_bytes']} on meta")
    check(0 <= slack <= ALLOC_ROUND * card["argument_tensors"],
          f"3t ({label}): {card['allocated_after_placing']} bytes allocated "
          f"for {card['argument_bytes']} of arguments")
    check(DRYRUN_PEAK[0] <= ratio <= DRYRUN_PEAK[1],
          f"3t ({label}): peak {card['peak_bytes']} on the card, "
          f"{predicted} predicted ({ratio:.3f}x)")
    check(card["launches"] == meta["kernel_calls"],
          f"3t ({label}): launches {card['launches']}, meta kernel calls "
          f"{meta['kernel_calls']}")
    check(card["finite"], f"3t ({label}): non-finite outputs")
    return out


def hs_inputs(cfg, device, rows: int, length: int, seed: int):
    """``rows`` random prompts of ``length`` tokens and their frames
    stub."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b = whisper_batch(cfg, rng.integers(0, cfg.vocab, size=(rows, length),
                                        dtype=np.int32), seed, device)
    return b["tokens"], b["frames"]


def hs_one_rank(device) -> dict:
    """(d) on one rank: the f32 forward's logits (saved for the ranks,
    which read their vocab block by memory map) and the chain's tokens."""
    import os

    import numpy as np
    import torch

    from repro_torch.launch import serve as launch
    from repro_torch.models import registry

    cfg = whisper_config("float32")
    model = launch.build_model(cfg, 0, device)
    tokens, frames = hs_inputs(cfg, device, HS_ROWS, HS_TOKENS, 11)
    with torch.no_grad():
        logits = registry.logits_fn(cfg, model, {"tokens": tokens,
                                                 "frames": frames})
    part = DRYRUN_DIR / "hs_logits.part.npy"  # renamed whole: the ranks
    np.save(part, logits.cpu().numpy())       # wait for the name
    os.replace(part, DRYRUN_DIR / "hs_logits.npy")
    scale = float(logits.abs().max())
    del logits
    tokens, frames = hs_inputs(cfg, device, HS_CHAIN_ROWS, WHISPER_PROMPT,
                               12)
    ch = whisper_chain(cfg, model, tokens, frames, HS_CHAIN_STEPS)
    del model
    torch.cuda.empty_cache()
    return {"scale": scale, "tokens": ch["tokens"].cpu().tolist()}


def hs_rank_main(rank: int, n: int, port: int, device: str, results) -> None:
    """One rank of 3t (d): whisper-small f32 on HS_MESH, its weights the
    rank's blocks (SERVE_RESIDENT_RULES, ``launch.build_model``): the
    forward's error from one rank's logits (its vocab block of them) and
    the chain's tokens, with the launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.dist import meshctx
    from repro_torch.launch import serve as launch
    from repro_torch.models import parallel, registry

    try:
        torch.set_num_threads(1)
        device = torch.device(device)
        torch.cuda.set_device(device)
        dist.init_process_group(RANK_BACKEND,
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=n)
        mesh = meshctx.make_mesh(HS_MESH)
        meshctx.set_mesh(mesh)
        cfg = whisper_config("float32")
        t0 = time.perf_counter()
        model = launch.build_model(cfg, 0, device, mesh)
        cut = (parallel.local_heads(cfg, parallel.tp()) == 0)
        tokens, frames = hs_inputs(cfg, device, HS_ROWS, HS_TOKENS, 11)
        reset_launches()
        with torch.no_grad():
            logits = registry.logits_fn(cfg, model, {"tokens": tokens,
                                                     "frames": frames})
        V = logits.shape[-1]
        t_fwd = time.perf_counter() - t0
        path = DRYRUN_DIR / "hs_logits.npy"  # one rank's, made meanwhile
        deadline = time.monotonic() + HS_TIMEOUT
        while not path.exists():
            check(time.monotonic() < deadline, "3t (d): no one-rank logits")
            time.sleep(0.05)
        one = np.load(path, mmap_mode="r")
        want = torch.from_numpy(np.ascontiguousarray(
            one[..., mesh.coord("model") * V:(mesh.coord("model") + 1) * V]))
        err = float((logits - want.to(device)).abs().max())
        del logits, want
        fwd_launches = read_launches()
        tokens, frames = hs_inputs(cfg, device, HS_CHAIN_ROWS,
                                   WHISPER_PROMPT, 12)
        ch = whisper_chain(cfg, model, tokens, frames, HS_CHAIN_STEPS)
        results.put({"rank": rank, "err": err, "cut": cut,
                     "tokens": ch["tokens"].cpu().tolist(),
                     "fwd_launches": fwd_launches,
                     "chain_launches": ch["launches"],
                     "forward_s": t_fwd,
                     "job_s": time.perf_counter() - t0})
    except BaseException:  # reported to the parent, then re-raised
        import traceback

        results.put({"rank": rank, "error": traceback.format_exc()})
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def start_dryrun_ranks(device) -> dict:
    """3t (d)'s one-rank reference, then its ranks spawned, which run on
    beside phases 3c-3f (they spend most of their time in gloo on the
    host, ~20 GiB in all) until ``run_dryrun_phase`` collects them."""
    import torch

    (DRYRUN_DIR / "hs_logits.npy").unlink(missing_ok=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    one = hs_one_rank(device)
    t1 = time.perf_counter()
    n = math.prod(HS_MESH)
    port = free_port()
    return {"one": one, "one_rank_s": t1 - t0, "t_spawn": t1,
            "started": _spawn_start(hs_rank_main,
                                    lambda r: (r, n, port, str(device)), n)}


def run_dryrun_phase(device, meta_proc, hs: dict) -> dict:
    """Phase 3t (see DRYRUN_CELLS): the replays of (a)-(c) against their
    meta runs, then (d)'s ranks (``start_dryrun_ranks``) collected and
    held against one rank's."""
    import torch

    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    meta = finish_dryrun_meta(meta_proc)
    t_meta = time.perf_counter() - t0
    res = {"card": dryrun.card_name(), "cells": {}}
    launches = {k: 0 for k in KERNELS}
    n = math.prod(HS_MESH)
    one, started = hs["one"], hs["started"]
    try:
        t1 = time.perf_counter()
        for label, arch, shape, mp, comp in DRYRUN_CELLS:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            card = dryrun_replay(arch, shape, mp, comp, device)
            torch.cuda.empty_cache()
            got = check_dryrun_cell(label, meta[label], card)
            m = meta[label]
            res["cells"][label] = {
                "arch": arch, "shape": shape, "mesh": m["mesh"],
                "compress": comp, "meta": m, "replay": card, **got}
            for k, v in card["launches"].items():
                launches[k] += v
            log(f"3t ({label}) {arch} x {shape} on {m['mesh']} (compress "
                f"{comp}), rank 0: meta run {m['compile_s']} s, predicted "
                f"peak {got['predicted_bytes'] / 2**30:.3f} GiB (arguments "
                f"{m['memory']['argument_size_in_bytes'] / 2**30:.3f}), the "
                f"card's {card['peak_bytes'] / 2**30:.3f} GiB "
                f"({got['peak_ratio']:.3f}x); collectives equal "
                f"{json.dumps(card['collective_counts'])}; launches "
                f"{card['launches']}; one-rank replay wall "
                f"{card['wall_s']:.3f} s (no communication)")
        check(res["cells"]["a"]["replay"]["launches"].get(
            "flash_attention_sm90", 0) > 0 and res["cells"]["a"]["replay"][
            "launches"].get("flash_attention_bwd_sm90", 0) > 0,
            "3t (a): the flash kernels did not launch")
        res["bwd_scratch_cases"] = check_bwd_scratch()
        t2 = time.perf_counter()
    finally:
        got = _spawn_collect(started, n, HS_TIMEOUT)
    errors = [g["error"] for g in got if "error" in g]
    check(not errors, "3t (d) rank failed:\n" + "\n".join(errors))
    check(len(got) == n, f"3t (d): {n - len(got)} ranks gave no result")
    cfg = whisper_config("float32")
    worst = max(g["err"] for g in got) / one["scale"]
    for g in got:
        check(g["cut"], "3t (d): the model axis does not cut whisper's "
                        "heads")
        check(g["tokens"] == one["tokens"],
              f"3t (d) rank {g['rank']}: f32 tokens differ from one rank's")
        check(g["chain_launches"].get("flash_attention_f32", 0)
              == cfg.n_layers * HS_CHAIN_STEPS,
              f"3t (d) rank {g['rank']}: chain launches "
              f"{g['chain_launches']}")
        for ln in (g["fwd_launches"], g["chain_launches"]):
            for k, v in ln.items():
                if k in launches:
                    launches[k] += v
    check(worst <= HS_LOGIT_REL, f"3t (d): f32 logits {worst:.3e} of "
                                 f"max|logit| from one rank's")
    res["whisper_cut_heads"] = {
        "mesh": HS_MESH, "logit_rel": worst, "rows": HS_ROWS,
        "tokens": HS_TOKENS, "chain": [HS_CHAIN_ROWS, HS_CHAIN_STEPS],
        "job_s": max(g["job_s"] for g in got),
        "fwd_launches_per_rank": got[0]["fwd_launches"]}
    res["launches"] = launches
    res["split_s"] = {"meta_wait": t_meta, "one_rank_d": hs["one_rank_s"],
                      "replays": t2 - t1,
                      "whisper_wait": time.perf_counter() - t2,
                      "d_ranks_forward": max(g["forward_s"] for g in got),
                      "d_ranks_job": max(g["job_s"] for g in got),
                      "d_spawn_to_collected": time.perf_counter()
                      - hs["t_spawn"]}
    log(f"3t (d) whisper-small f32 on {HS_MESH} (12 heads over 8: cut): "
        f"logits {worst:.3e} of max|logit| from one rank's over "
        f"{HS_ROWS} x (1500, {HS_TOKENS}); the chain's {HS_CHAIN_ROWS} x "
        f"{HS_CHAIN_STEPS} tokens one rank's on all {n} ranks; split (s) "
        f"{json.dumps(res['split_s'])}")
    return res


def check_gaussian_law(mech: str, res: dict, sigma: float) -> dict:
    """KS of each round's error against N(0, sigma^2), below 1.95/sqrt(N)
    on the subsample."""
    out = {}
    for rnd, err in enumerate(res["errs"]):
        e = err.numpy()
        ks = ks_stat(e, sigma)
        thr = 1.95 / math.sqrt(len(e))
        log(f"{mech} round {rnd}: KS {ks:.6f} (threshold {thr:.6f}), std "
            f"{e.std():.6f} vs sigma {sigma}")
        check(ks < thr, f"{mech} round {rnd} fails KS: {ks}")
        out[f"{mech}_ks_r{rnd}"] = ks
    return out


def check_error_laws(res_gauss, res_ih, sigma_g, sigma_ih) -> dict:
    import numpy as np

    out = check_gaussian_law("aggregate_gaussian", res_gauss, sigma_g)
    half = sigma_ih * math.sqrt(3 * N_CLIENTS)
    for rnd, err in enumerate(res_ih["errs"]):
        e = err.numpy()
        std = float(e.std())
        m = float(np.abs(e).max())
        log(f"irwin_hall round {rnd}: max |err| {m:.6g} (support "
            f"{half:.6g}), std {std:.6g} vs sigma {sigma_ih}")
        # 1e-6 slack: the error is read back as params - new params
        check(m <= half + 1e-6, "irwin_hall error outside its support")
        check(abs(std - sigma_ih) <= 0.1 * sigma_ih,
              f"irwin_hall std {std} not within 10% of {sigma_ih}")
        out[f"ih_std_r{rnd}"] = std
    return out


# ------------------------------------------------------------- phase 4
def time_kernels(device, gen, rates: tuple) -> list:
    """Median times at the main path's shapes (d = D_FULL, b = 8): the
    aggregate configuration (array step, offset) and irwin_hall's
    (scalar step, no offset)."""
    import torch

    from repro_torch.kernels import fused_agg as fg
    from repro_torch.kernels import ops, ref

    g = 32 // BITS
    m_max, x, s, base, step, offset = kernel_inputs(D_FULL, BITS, gen, device)
    xr, sr = ops._pad_rows(x, g), ops._pad_rows(s, g)
    tr, orr = ops._pad_rows(step, g, 1.0), ops._pad_rows(offset, g)
    words = fg.fused_encode(xr, sr, tr, BITS, m_max)
    se = sr + float(m_max)
    n_el = xr.numel()
    f4, w4 = 4 * n_el, 4 * words.numel()
    rows = []
    for name, kind, kern, plain, nbytes in (
        ("fused_encode", "array step",
         lambda: fg.fused_encode(xr, sr, tr, BITS, m_max),
         lambda: ref.fused_encode_ref(xr, sr, tr, BITS, m_max),
         3 * f4 + w4),
        ("fused_encode", "scalar step",
         lambda: fg.fused_encode(xr, sr, base, BITS, m_max),
         lambda: ref.fused_encode_ref(xr, sr, base, BITS, m_max),
         2 * f4 + w4),
        ("fused_decode", "array step + offset",
         lambda: fg.fused_decode(words, se, tr, orr, BITS),
         lambda: ref.fused_decode_ref(words, se, tr, orr, BITS),
         w4 + 4 * f4),
        ("fused_decode", "scalar step",
         lambda: fg.fused_decode(words, se, base, None, BITS),
         lambda: ref.fused_decode_ref(words, se, base, None, BITS),
         w4 + 2 * f4),
    ):
        rows.append(timed_row(name, kind, kern, plain, nbytes, n_el,
                              rates))
    del xr, sr, tr, orr, words, se, x, s, step, offset
    torch.cuda.empty_cache()
    return rows


def time_new_kernels(device, gen, rates: tuple) -> list:
    """Median times of the layered kernels (sigma_client 0.5, the
    individual_shifted round's) and the dither_pack kernels (b = 8) at
    full width, beside their byte bounds and their plain versions (run
    over the same input in chunks of PLAIN_CHUNK, median of 3)."""
    import torch

    from repro_torch.kernels import dither_pack as dp
    from repro_torch.kernels import layered_encode as le
    from repro_torch.kernels import ops, ref

    rows = []

    def add(name, kind, kern, plain, nbytes):
        rows.append(timed_row(name, kind, kern, plain, nbytes, D_FULL,
                              rates))

    sigma = 2 * SIGMA_IND
    peak = 1.0 / (sigma * math.sqrt(2.0 * math.pi))
    xr = (torch.randn(D_FULL, generator=gen, device=device)
          * (3 * sigma)).view(-1, 128)
    ur = torch.rand(D_FULL, generator=gen, device=device).view(-1, 128)
    lr = (torch.rand(D_FULL, generator=gen, device=device)
          * peak).view(-1, 128)
    m = le.layered_encode(xr, ur, lr, sigma)
    chunks = _row_chunks(xr.shape[0])

    def plain_enc():
        for sl in chunks:
            ref.layered_encode_ref(xr[sl], ur[sl], lr[sl], sigma)

    def plain_dec():
        for sl in chunks:
            ref.layered_decode_ref(m[sl], ur[sl], lr[sl], sigma)

    add("layered_encode", f"sigma {sigma}",
        lambda: le.layered_encode(xr, ur, lr, sigma), plain_enc, 16 * D_FULL)
    add("layered_decode", f"sigma {sigma}",
        lambda: le.layered_decode(m, ur, lr, sigma), plain_dec, 16 * D_FULL)
    del xr, ur, lr, m
    torch.cuda.empty_cache()

    g = 32 // BITS
    xr = ops._pad_rows(torch.randn(D_FULL, generator=gen, device=device)
                       * 0.1, g)
    sr = ops._pad_rows(torch.rand(D_FULL, generator=gen, device=device)
                       - 0.5, g)
    words = dp.dither_pack(xr, sr, DP_W, BITS)
    chunks = _row_chunks(xr.shape[0], g)

    def plain_pack():
        for sl in chunks:
            ref.dither_pack_ref(xr[sl], sr[sl], DP_W, BITS)

    def plain_unpack():
        for sl in chunks:
            ref.unpack_decode_ref(words[sl], sr[sl], DP_W, BITS)

    nb = 8 * D_FULL + 4 * words.numel()
    add("dither_pack", f"b = {BITS}",
        lambda: dp.dither_pack(xr, sr, DP_W, BITS), plain_pack, nb)
    add("unpack_decode", f"b = {BITS}",
        lambda: dp.unpack_decode(words, sr, DP_W, BITS), plain_unpack, nb)
    del xr, sr, words
    torch.cuda.empty_cache()
    return rows


# timed flash shapes, causal: (B, T, S, H, HK, D, dtype): the serve
# path's heads (qwen1.5-0.5b, 16 of 64) at T = 2048 and 8192 and
# qwen3-32b's GQA heads (64 query, 8 KV, of 128) at 4096, in bf16 and f32;
# then the moe and llava prefills' heads at 2048 (phi3.5-moe and llava
# 32 / 8, dbrx 48 / 8, of 128), then starcoder2-3b's 24 / 2 and
# minitron-4b's 24 / 8 of 128
FLASH_TIMED = (
    (1, 2048, 2048, 16, 16, 64, "bfloat16"),
    (1, 8192, 8192, 16, 16, 64, "bfloat16"),
    (1, 4096, 4096, 64, 8, 128, "bfloat16"),
    (1, 2048, 2048, 16, 16, 64, "float32"),
    (1, 8192, 8192, 16, 16, 64, "float32"),
    (1, 4096, 4096, 64, 8, 128, "float32"),
    (1, 2048, 2048, 32, 8, 128, "bfloat16"),
    (1, 2048, 2048, 48, 8, 128, "bfloat16"),
    (1, 2048, 2048, 32, 8, 128, "float32"),
    (1, 2048, 2048, 48, 8, 128, "float32"),
    (1, 2048, 2048, 24, 2, 128, "bfloat16"),
    (1, 2048, 2048, 24, 8, 128, "bfloat16"),
    (1, 2048, 2048, 24, 2, 128, "float32"),
    (1, 2048, 2048, 24, 8, 128, "float32"),
    # zamba2-7b's shared attention over its 8192-token prefill: 32 / 32
    # heads of 112, window 4096
    (1, 8192, 8192, 32, 32, 112, "bfloat16", 4096),
    (1, 8192, 8192, 32, 32, 112, "float32", 4096),
    # whisper-small's encoder over its 1500 frames (12 / 12 heads of 64),
    # non-causal: the eighth entry is the window (0, none), the ninth the
    # causal flag (True where absent)
    (1, 1500, 1500, 12, 12, 64, "bfloat16", 0, False),
    (1, 1500, 1500, 12, 12, 64, "float32", 0, False),
)


def timed_causal(row) -> bool:
    """A timed row's causal flag: its ninth entry, True if it has none."""
    return row[8] if len(row) > 8 else True


def attn_pairs(T: int, S: int, causal: bool, window: int = 0) -> float:
    """The (query, key) pairs the function computes: every T x S pair
    without the causal mask, else ``causal_pairs``' count (T^2 / 2, or the
    in-window pairs)."""
    if not causal:
        return T * S
    return causal_pairs(T, window) if window else T * S / 2


def causal_pairs(T: int, window: int = 0) -> float:
    """The (query, key) pairs a causal attention over T tokens computes:
    T^2 / 2 (the bound's count of full causal attention), or with a window
    sum_i min(i + 1, window), the in-window pairs alone."""
    if not window:
        return T * T / 2
    w = min(window, T)
    return w * (w + 1) / 2 + (T - w) * w


def band_mask(T: int, window: int, device):
    """The causal sliding-window band as SDPA's boolean ``attn_mask``
    (True where attended): key j for query i where i - window < j <= i."""
    import torch

    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    return (j <= i) & (j > i - window)


def batched_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the mean ms of ``n`` back-to-back calls
    between two CUDA events: the host's launch cost overlaps the device's
    work, so a call whose device time exceeds its host time is timed by
    the device."""
    import torch

    fn()  # warm up
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    times.sort()
    return times[len(times) // 2]


def time_flash(device, gen, mem_rate: float, f32_rate: float,
               bf16_tc: float, tf32_tc: float) -> list:
    """Each flash kernel at the FLASH_TIMED shapes (``batched_ms``; bf16 at
    the configs' kv_chunk, whose second pass over each span is the
    kernel's own cost, not counted in the bound), beside its bound — the larger of the bytes (q, k, v read once, out written
    once) over the memory rate and the least operations the card needs
    for the causal FLOPs (4 B H T S D / 2) at its inputs' accuracy: once
    at the bf16 tensor-core rate for bf16, three times at the TF32
    tensor-core rate for f32 (3xTF32, f32 accuracy on the tensor cores;
    the bound at the f32 rate outside the tensor cores is logged beside)
    — its plain version (``cuda_ms``, 3 runs) and
    ``scaled_dot_product_attention`` at the same shape and dtype
    (``enable_gqa`` where HK < H, and then also on K and V repeated to H
    heads beforehand, ``library_expanded_ms``; the library yardstick,
    timed only here)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    rows = []
    for row_case in FLASH_TIMED:
        B, T, S, H, HK, D, dt = row_case[:7]
        window, causal = case_window(row_case), timed_causal(row_case)
        dtype = getattr(torch, dt)
        case = (B, T, S, H, HK, D, causal)
        q, k, v = flash_inputs(case, dtype, gen, device)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        bf16 = dtype == torch.bfloat16
        name = "flash_attention_sm90" if bf16 else "flash_attention_f32"
        # bf16 at the configs' kv_chunk, as the serve and train paths call
        # it (the f32 function has no chunking)
        kv = {"kv_tile": CONFIG_KV_CHUNK} if bf16 else {}
        plain = (ref.flash_attention_bf16_ref if bf16
                 else ref.flash_attention_ref)
        ms = batched_ms(lambda: fa.flash_attention(
            q, k, v, causal, kv_tile=CONFIG_KV_CHUNK, window=window))
        plain_ms = cuda_ms(lambda: plain(q, k, v, causal, **kv,
                                         window=window), reps=3)
        # SDPA: causal or not, or the window's band as a boolean mask
        mask = band_mask(T, window, device) if window else None
        lib_ms = batched_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None and causal,
            enable_gqa=HK < H))
        lib_x_ms = None
        if HK < H:
            kx, vx = (x.repeat_interleave(H // HK, dim=1) for x in (kt, vt))
            lib_x_ms = batched_ms(lambda: F.scaled_dot_product_attention(
                qt, kx, vx, is_causal=causal))
            del kx, vx
        flops = 4 * B * H * D * attn_pairs(T, S, causal, window)
        nbytes = q.element_size() * (2 * B * T * H * D + 2 * B * S * HK * D)
        bytes_ms = nbytes / mem_rate * 1e3
        ops_ms = (flops / bf16_tc if bf16 else 3 * flops / tf32_tc) * 1e3
        bound = max(bytes_ms, ops_ms)
        by = "bytes" if bytes_ms >= ops_ms else "operations"
        shape = (f"({B}, {T}, {H} / {HK} heads, {D}) {dt} "
                 + ("causal" if causal else "non-causal")
                 + (f" window {window}" if window else "")
                 + (f" kv_chunk {CONFIG_KV_CHUNK}" if bf16 else ""))
        rate = (f"{flops / 1e9:.2f} GFLOP at {bf16_tc / 1e12:.0f} TFLOP/s"
                if bf16 else f"3 x {flops / 1e9:.2f} GFLOP at "
                f"{tf32_tc / 1e12:.1f} TFLOP/s TF32")
        row = {"name": name, "config": shape, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "bytes": nbytes, "flops": flops, "library_ms": lib_ms,
               "library_expanded_ms": lib_x_ms}
        extra = ""
        if not bf16:
            core_ms = max(bytes_ms, flops / f32_rate * 1e3)
            row["cuda_core_bound_ms"] = core_ms
            extra = (f"; CUDA-core bound {core_ms:.4f} ms at "
                     f"{f32_rate / 1e12:.0f} TFLOP/s f32, "
                     f"{100 * core_ms / ms:.1f}% of it")
        lib_x = ("" if lib_x_ms is None else
                 f"; SDPA on repeated K, V {lib_x_ms:.4f} ms")
        log(f"{name} {shape}: {ms:.4f} ms, bound {bound:.4f} ms by {by} "
            f"({rate}; bytes {bytes_ms:.4f} ms), {100 * bound / ms:.1f}% of "
            f"it{extra}, {flops / ms / 1e9:.1f} TFLOP/s; plain "
            f"{plain_ms:.4f} ms; scaled_dot_product_attention "
            f"{lib_ms:.4f} ms (kernel / SDPA {ms / lib_ms:.2f}){lib_x}")
        rows.append(row)
        del q, k, v, qt, kt, vt, mask
    torch.cuda.empty_cache()
    return rows


# timed backward shapes, causal: (B, T, S, H, HK, D, dtype): the bf16
# train path's microbatch first (the bf16 kernel's row in the kernels
# line), then the longest serve prompt's shape and qwen3-32b's GQA heads,
# in bf16 and then in f32 (the first f32 row the f32 kernel's); then the
# moe train microbatch (2 x 2048, 32 / 8 heads of 128) in both; then
# starcoder2-3b's and minitron-4b's heads (24 / 2 and 24 / 8 of 128) in both
BWD_TIMED = (
    (4, 2048, 2048, 16, 16, 64, "bfloat16"),
    (1, 8192, 8192, 16, 16, 64, "bfloat16"),
    (1, 4096, 4096, 64, 8, 128, "bfloat16"),
    (4, 2048, 2048, 16, 16, 64, "float32"),
    (1, 8192, 8192, 16, 16, 64, "float32"),
    (1, 4096, 4096, 64, 8, 128, "float32"),
    (2, 2048, 2048, 32, 8, 128, "bfloat16"),
    (2, 2048, 2048, 32, 8, 128, "float32"),
    (1, 2048, 2048, 24, 2, 128, "bfloat16"),
    (1, 2048, 2048, 24, 8, 128, "bfloat16"),
    (1, 2048, 2048, 24, 2, 128, "float32"),
    (1, 2048, 2048, 24, 8, 128, "float32"),
    # zamba2-7b's train microbatch (1 x 8192, 32 / 32 heads of 112, window
    # 4096)
    (1, 8192, 8192, 32, 32, 112, "bfloat16", 4096),
    (1, 8192, 8192, 32, 32, 112, "float32", 4096),
    # whisper-small's train microbatch (8 rows, 12 / 12 heads of 64),
    # non-causal: the decoder's cross-attention (448 x 1500) and the
    # encoder (1500 x 1500)
    (8, 448, 1500, 12, 12, 64, "bfloat16", 0, False),
    (8, 1500, 1500, 12, 12, 64, "bfloat16", 0, False),
    (8, 448, 1500, 12, 12, 64, "float32", 0, False),
    (8, 1500, 1500, 12, 12, 64, "float32", 0, False),
)


def time_flash_bwd(device, gen, mem_rate: float, bf16_tc: float,
                   tf32_tc: float) -> list:
    """The backward kernels at BWD_TIMED (bf16: flash_attention_bwd_sm90,
    f32: flash_attention_bwd_f32_sm90; ``batched_ms``, 5 calls a mean)
    beside the bound — the larger of the bytes (q, k, v, o, dO and lse
    read once, dq, dk, dv written once) over the memory rate and the
    gradient's products, 2.5 times the forward's causal FLOPs (4 B H T S D
    / 2), at the bf16 tensor-core rate for bf16 and three times at the
    TF32 rate for f32 (f32 accuracy on the tensor cores, as the f32
    forward's bound) — its plain version (``cuda_ms``, 3 runs) and the
    library's: ``scaled_dot_product_attention``'s backward at the same
    shape and dtype, timed as its autograd forward + backward minus its
    forward (the library yardstick, timed only here)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    rows = []
    for row_case in BWD_TIMED:
        B, T, S, H, HK, D, dt = row_case[:7]
        window, causal = case_window(row_case), timed_causal(row_case)
        dtype = getattr(torch, dt)
        case = (B, T, S, H, HK, D, causal, window)
        q, k, v, o, lse, do = bwd_inputs(case, dtype, gen, device)
        ms = batched_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, causal, window=window), n=5, reps=3)
        plain_ms = cuda_ms(lambda: ref.flash_attention_bwd_ref(
            q, k, v, o, lse, do, causal, window=window), reps=3)
        mask = band_mask(T, window, device) if window else None
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2)
        gqa = HK < H

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None and causal,
                enable_gqa=gqa)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

        with torch.no_grad():
            fwd_ms = batched_ms(sdpa, n=5, reps=3)
        lib_ms = batched_ms(sdpa_fwd_bwd, n=5, reps=3) - fwd_ms
        bf16 = dtype == torch.bfloat16
        name = fa.BWD_KERNELS[dtype]
        flops = 2.5 * 4 * B * H * D * attn_pairs(T, S, causal, window)
        # q, o, dO and dq (B T H D each), k, v, dk and dv (B S HK D each),
        # lse (B H T, f32)
        nbytes = (q.element_size() * 4 * (B * T * H * D + B * S * HK * D)
                  + 4 * B * H * T)
        bytes_ms = nbytes / mem_rate * 1e3
        ops_ms = (flops / bf16_tc if bf16 else 3 * flops / tf32_tc) * 1e3
        bound = max(bytes_ms, ops_ms)
        by = "bytes" if bytes_ms >= ops_ms else "operations"
        shape = (f"({B}, {T}" + (f", {S}" if S != T else "")
                 + f", {H} / {HK} heads, {D}) {dt} "
                 + ("causal" if causal else "non-causal")
                 + (f" window {window}" if window else ""))
        row = {"name": name, "config": shape, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "bytes": nbytes, "flops": flops, "library_ms": lib_ms,
               "library_forward_ms": fwd_ms}
        log(f"{name} {shape}: {ms:.4f} ms, bound {bound:.4f} ms by {by} "
            f"({flops / 1e9:.2f} GFLOP{'' if bf16 else ' x 3 (TF32)'}; "
            f"bytes {bytes_ms:.4f} ms), "
            f"{100 * bound / ms:.1f}% of it, {flops / ms / 1e9:.1f} TFLOP/s; "
            f"plain {plain_ms:.4f} ms; scaled_dot_product_attention backward "
            f"{lib_ms:.4f} ms (forward + backward {lib_ms + fwd_ms:.4f}, "
            f"forward {fwd_ms:.4f}; kernel / SDPA {ms / lib_ms:.2f})")
        rows.append(row)
        del q, k, v, o, lse, do, qt, kt, vt, dot, mask
    torch.cuda.empty_cache()
    return rows


# timed wkv6 shapes: (B, T, H, K, input dtype, decay dtype): the rwkv6
# train microbatch (2 x 2048, 32 heads of 64) in bf16 (the kernels line's
# rows) and f32, through the chunked kernels, and the bf16 decode step of
# 8 slots (f32 decay and state) through the step kernel
WKV_TIMED = (
    (2, 2048, 32, 64, "bfloat16", "bfloat16"),
    (2, 2048, 32, 64, "float32", "float32"),
    (8, 1, 32, 64, "bfloat16", "float32"),
)
# f32 operations per state element and step that the function needs, not
# what the kernels do (a multiply-add counts 2; the O(K) terms left out).
# The forward: y = r S + (r . (u k)) v, 2; S w + k^T v, 3.  The backward,
# with the states recomputed from the saved chunks (S w + k^T v, 3): dS w
# + r^T dy, 3; dr = S dy + u k (dy . v), 2; dk = dS v, 2; dv = k dS, 2;
# dw = sum of dS * S, 2.  The step kernel's work is the forward's
WKV_FLOPS = {"wkv6_fwd": 5, "wkv6_bwd": 14, "wkv6_step": 5}
# the kept states the function needs for its backward: the reference's,
# one every 128 steps (src/repro/models/rwkv6.py:77, its checkpointed
# chunks), whatever interval the kernels keep them at
WKV_KEPT_EVERY = 128
# the row of the serial forward timed at the chunked kernels' shapes: a
# side row, not the kernels line's (that takes the decode step's)
WKV_SERIAL_ROW = "wkv6_step_serial_fwd"


def time_wkv6(device, gen, mem_rate: float, f32_rate: float,
              tf32_rate: float) -> list:
    """The wkv6 kernels at WKV_TIMED (``batched_ms``; the chunked forward
    and backward at T > 1, the step kernel at T = 1, and the step kernel
    at the T > 1 shapes too, the serial forward the chunked one replaced,
    as the side row WKV_SERIAL_ROW) beside their bound -- the larger of
    the bytes (the forward: r, k, v, w, u and a first state read, y, the
    final state and the states kept for the backward, one every
    WKV_KEPT_EVERY steps, written; the backward: r, k, v, w, u, dy and
    those states read, dr, dk, dv, dw and du's per-(b, h) partials
    written) over the memory rate
    and WKV_FLOPS K^2 per (b, t, h) at the fastest rate that keeps f32
    accuracy, 3xTF32 on the tensor cores (a third of the TF32 rate; the
    bound at the f32 CUDA-core rate is logged beside it) -- and their
    plain versions (``cuda_ms``, one run after a warm-up).  No PyTorch call
    computes the recurrence: no library time."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wk

    rows = []
    for case in WKV_TIMED:
        B, T, H, K, dt, wdt = case
        r, k, v, w, u, s0, dy, _ = wkv_inputs(case, gen, device)
        state = s0 if T == 1 else None
        train = T > 1
        n = B * T * H * K
        es, wes = r.element_size(), w.element_size()
        chunk_b = 4 * B * H * -(-T // WKV_KEPT_EVERY) * K * K
        fwd_b = (3 * es * n + wes * n + 4 * H * K + 4 * n
                 + 4 * B * H * K * K * (2 if state is not None else 1))
        jobs = []
        if train:
            y, _, cs = wk.wkv6_fwd(r, k, v, w, u, state, chunks=True)
            jobs += [("wkv6_fwd",
                      lambda: wk.wkv6_fwd(r, k, v, w, u, state, chunks=True),
                      lambda: ref.wkv6_ref(r, k, v, w, u, state),
                      fwd_b + chunk_b),
                     ("wkv6_bwd",
                      lambda: wk.wkv6_bwd(r, k, v, w, u, dy, cs),
                      lambda: ref.wkv6_bwd_ref(r, k, v, w, u, dy),
                      3 * es * n + wes * n + 4 * H * K + 4 * n + chunk_b
                      + 16 * n + 4 * B * H * K)]
        else:
            y, cs = None, None
        jobs.append((WKV_SERIAL_ROW if train else "wkv6_step",
                     lambda: wk.wkv6_step(r, k, v, w, u, state),
                     lambda: ref.wkv6_ref(r, k, v, w, u, state), fwd_b))
        for name, kern, plain, nbytes in jobs:
            ms = batched_ms(kern, n=5, reps=3)
            plain_ms = (cuda_ms(plain, reps=1) if name != WKV_SERIAL_ROW
                        else None)
            flops = WKV_FLOPS[name if name != WKV_SERIAL_ROW
                              else "wkv6_step"] * K * K * B * T * H
            bytes_ms = nbytes / mem_rate * 1e3
            ops_ms = flops / (tf32_rate / 3) * 1e3
            core_ms = flops / f32_rate * 1e3
            bound = max(bytes_ms, ops_ms)
            by = "bytes" if bytes_ms >= ops_ms else "operations"
            shape = f"({B}, {T}, {H}, {K}) {dt} (decay {wdt})"
            log(f"{name} {shape}: {ms:.4f} ms, bound {bound:.4f} ms by {by} "
                f"({flops / 1e9:.3f} GFLOP at {tf32_rate / 3e12:.0f} TFLOP/s, "
                f"3xTF32; bytes {nbytes / 1e6:.1f} MB, {bytes_ms:.4f} ms), "
                f"{100 * bound / ms:.1f}% of it; at the {f32_rate / 1e12:.0f} "
                f"TFLOP/s f32 CUDA-core rate {max(bytes_ms, core_ms):.4f} ms, "
                f"{100 * max(bytes_ms, core_ms) / ms:.1f}%; plain "
                + ("not timed (the serial forward beside the chunked one)"
                   if plain_ms is None else f"{plain_ms:.4f} ms")
                + "; no library call")
            rows.append({"name": name, "config": shape, "T": T, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": by, "bound_f32_core_ms": max(bytes_ms,
                                                                  core_ms),
                         "bytes": nbytes, "flops": flops,
                         "library_ms": None})
        del r, k, v, w, u, s0, dy, y, cs
    torch.cuda.empty_cache()
    return rows


def time_flash_span(device, gen) -> list:
    """The bf16 forward kernel at the configs' kv_chunk (two passes over
    each 1024-key span) beside its single pass over 128-key tiles
    (kv_chunk 128, the PR 14-16 function, held to the bf16 bars against
    the plain version at 128 first), at the FLASH_TIMED bf16 shapes
    without a window, in turns (``batched_ms``)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    rows = []
    for row_case in FLASH_TIMED:
        B, T, S, H, HK, D, dt = row_case[:7]
        if dt != "bfloat16" or case_window(row_case):
            continue
        case = (B, T, S, H, HK, D, True)
        q, k, v = flash_inputs(case, torch.bfloat16, gen, device)
        check_bf16_flash(
            fa.flash_attention(q, k, v, True, kv_tile=128),
            ref.flash_attention_bf16_ref(q, k, v, True, kv_tile=128), v,
            f"flash_attention_sm90 {case} kv_chunk 128")
        tile = batched_ms(lambda: fa.flash_attention(q, k, v, True,
                                                     kv_tile=128))
        span = batched_ms(lambda: fa.flash_attention(
            q, k, v, True, kv_tile=CONFIG_KV_CHUNK))
        shape = f"({B}, {T}, {H} / {HK} heads, {D}) bf16 causal"
        log(f"flash_attention_sm90 {shape} at kv_chunk {CONFIG_KV_CHUNK}: "
            f"{span:.4f} ms (128-key tiling in the same call {tile:.4f} ms, "
            f"x{span / tile:.2f})")
        rows.append({"config": shape, "kv_chunk": CONFIG_KV_CHUNK,
                     "ms": span, "tile_ms": tile})
        del q, k, v
    torch.cuda.empty_cache()
    return rows


def copy_rate(device) -> dict:
    """The card's achievable device-to-device rate: ``copy_`` of a
    4.29 GB f32 tensor, CUDA events, median of 10; bytes read + written
    over the time."""
    import torch

    src = torch.empty(1 << 30, dtype=torch.float32, device=device)
    src.fill_(1.0)
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src))
    nbytes = 2 * src.numel() * 4
    rate = nbytes / (ms * 1e-3)
    log(f"copy_ of {src.numel() * 4 / 1e9:.3f} GB: {ms:.4f} ms, "
        f"{rate / 1e12:.4f} TB/s read + write")
    del src, dst
    torch.cuda.empty_cache()
    return {"ms": ms, "bytes": nbytes, "rate": rate}


def main() -> int:
    import os

    # grow segments instead of caching fixed blocks: the train steps' f64
    # temporaries of the largest leaves (zamba2's 522 M-element group stack
    # at 14 layers) otherwise leave the cache too fragmented for the next
    # step (set before the first allocation; the spawned ranks inherit it)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv6 as wk

    device = torch.device("cuda", 0)
    # the plain versions' f32 products in full f32 (PyTorch's default,
    # stated here): TF32 would round their inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    log(f"card: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    phase_s = {}  # each phase's end, seconds from the start

    def done(phase: str) -> None:
        phase_s[phase] = time.perf_counter() - t_start
        log(f"phase {phase} done at {phase_s[phase]:.1f} s")

    # 1. build
    secs = build.build_all()
    log(f"build: {json.dumps(secs)} s")
    # phase 3t's meta runs, in a process off the card meanwhile
    meta_proc = start_dryrun_meta()
    for lib, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line
                    or "Performance Loss" in line):
                log(f"  ptxas {lib}: {line.strip()}")
    f32_lib = build.load("flash_attention_f32_sm90")
    bwd_lib = build.load("flash_attention_bwd_f32_sm90")
    heads = (16, 32, 64, 112, 128)
    smem = {"flash_attention_f32_sm90": {
        d: f32_lib.flash_attention_f32_smem_bytes(d) for d in heads},
        "flash_attention_bwd_f32_sm90 dq": {
        d: bwd_lib.flash_attention_bwd_f32_sm90_smem_bytes(d, 0)
        for d in heads},
        "flash_attention_bwd_f32_sm90 dkv": {
        d: bwd_lib.flash_attention_bwd_f32_sm90_smem_bytes(d, 1)
        for d in heads},
        "wkv6 wkv6_bwd_grad": {d: wk._lib().wkv6_grad_smem_bytes(d)
                               for d in wk.HEAD_DIMS}}
    log(f"  dynamic shared memory by head dim (bytes; ptxas does not "
        f"report it): {json.dumps(smem)}")
    # the f32 backward's streamed tiles, which its CPU emulation takes
    tiles = {d: (bwd_lib.flash_attention_bwd_f32_sm90_tile(d, 0),
                 bwd_lib.flash_attention_bwd_f32_sm90_tile(d, 1))
             for d in heads}
    check(tiles == fa.F32_BWD_TILES, f"flash_attention_bwd_f32_sm90 tiles "
          f"{tiles}, F32_BWD_TILES {fa.F32_BWD_TILES}")
    log(f"  flash_attention_bwd_f32_sm90 tiles (dQ keys, dK / dV queries) by "
        f"head dim: {tiles}, as F32_BWD_TILES")

    # 2. kernels against their plain versions
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    worst = compare_kernels(device, gen)
    worst.update(compare_layered(device, gen))
    worst.update(compare_dither_pack(device, gen))
    flash = compare_flash(device, gen)
    bwd = compare_flash_bwd(device, gen)
    # the windowed and head-dim-112 cases from their own generator, so the
    # cases above keep their inputs
    wgen = torch.Generator(device=device)
    wgen.manual_seed(WINDOW_SEED)
    flash_w = compare_flash(device, wgen, FLASH_WINDOW_CASES)
    bwd_w = compare_flash_bwd(device, wgen, BWD_WINDOW_CASES)
    # whisper's non-causal shapes, then the bf16 backward's long sums, each
    # from its own generator
    whgen = torch.Generator(device=device)
    whgen.manual_seed(WHISPER_SEED)
    flash_wh = compare_flash(device, whgen, FLASH_WHISPER_CASES)
    bwd_wh = compare_flash_bwd(device, whgen, BWD_WHISPER_CASES)
    dgen = torch.Generator(device=device)
    dgen.manual_seed(DRIFT_SEED)
    drift = compare_flash_bwd(device, dgen, BWD_DRIFT_CASES,
                              (torch.bfloat16,))
    mgen = torch.Generator(device=device)
    mgen.manual_seed(MESH_SEED)
    flash_m = compare_flash(device, mgen, FLASH_MESH_CASES)
    bwd_m = compare_flash_bwd(device, mgen, BWD_MESH_CASES)
    # the moe kind's per-rank shapes, then the f32 forward's long sums,
    # each from its own generator
    mmgen = torch.Generator(device=device)
    mmgen.manual_seed(MOE_MESH_SEED)
    flash_mm = compare_flash(device, mmgen, FLASH_MOE_MESH_CASES)
    bwd_mm = compare_flash_bwd(device, mmgen, BWD_MOE_MESH_CASES)
    fgen = torch.Generator(device=device)
    fgen.manual_seed(FWD_DRIFT_SEED)
    fwd_drift = compare_flash_fwd_drift(device, fgen)
    bwd_ratio = max(r[f"{n}_bar_ratio"] for r in drift["bwd_cases"]
                    for n in ("dq", "dk", "dv"))
    log(f"drift: flash_attention_f32's worst case {fwd_drift['worst_ratio']:.4f}"
        f" of its 2e-5 bar over {len(FWD_DRIFT_CASES)} cases; "
        f"flash_attention_bwd_sm90's (BWD_DRIFT_CASES) {bwd_ratio:.4f} of "
        f"its bar")
    worst.update({k: max(flash[k], flash_w[k], flash_wh[k], flash_m[k],
                         flash_mm[k])
                  for k in ("flash_attention_sm90", "flash_attention_f32")})
    worst["flash_attention_f32"] = max(worst["flash_attention_f32"],
                                       fwd_drift["flash_attention_f32"])
    worst.update({k: max(bwd[k], bwd_w[k], bwd_wh[k], drift[k], bwd_m[k],
                         bwd_mm[k])
                  for k in ("flash_attention_bwd_sm90",
                            "flash_attention_bwd_f32_sm90")})
    wkv = compare_wkv6(device, gen)
    # the per-rank shapes of rwkv6, zamba2 and whisper on the mesh (3s),
    # from their own generator
    fmgen = torch.Generator(device=device)
    fmgen.manual_seed(FAMILY_MESH_SEED)
    flash_fm = compare_flash(device, fmgen, FLASH_FAMILY_MESH_CASES)
    bwd_fm = compare_flash_bwd(device, fmgen, BWD_FAMILY_MESH_CASES)
    wkv_fm = compare_wkv6(device, fmgen, WKV_FAMILY_MESH_CASES)
    for k in ("flash_attention_sm90", "flash_attention_f32"):
        worst[k] = max(worst[k], flash_fm[k])
    for k in ("flash_attention_bwd_sm90", "flash_attention_bwd_f32_sm90"):
        worst[k] = max(worst[k], bwd_fm[k])
    worst.update({k: max(wkv[k], wkv_fm[k])
                  for k in ("wkv6_fwd", "wkv6_bwd", "wkv6_step")})
    done("2")

    # 3. the main path: each path with its launch counts.  The mesh
    # phases' ranks (3q-3s) and the NCCL probe start first and run beside
    # the FL rounds and 3b; their checks come after 3p
    from repro_torch.dist import compress as dcompress

    mesh_spawns = start_mesh_spawns(device)
    nccl_started = start_nccl_probe()

    sample_idx = torch.arange(0, D_FULL, D_FULL // KS_SAMPLE,
                              device=device)[:KS_SAMPLE]
    sigma_g, sigma_ih = 0.25, 5e-3
    fused = {"fused_encode": ROUNDS * N_CLIENTS, "fused_decode": ROUNDS}
    layered = {"layered_encode": ROUNDS * N_CLIENTS,
               "layered_decode": ROUNDS * N_CLIENTS}
    res = {
        "aggregate_gaussian": run_mechanism(
            "aggregate_gaussian", sigma_g, device, sample_idx, fused),
        "irwin_hall": run_mechanism("irwin_hall", sigma_ih, device,
                                    sample_idx, fused),
        "individual_shifted": run_mechanism(
            "individual_shifted", SIGMA_IND, device, sample_idx, layered),
    }
    laws = check_error_laws(res["aggregate_gaussian"], res["irwin_hall"],
                            sigma_g, sigma_ih)
    laws.update(check_gaussian_law("individual_shifted",
                                   res["individual_shifted"], SIGMA_IND))
    fixed = dcompress.message_bits(dcompress.CompressionConfig(
        mechanism="layered_shifted", sigma=SIGMA_IND, clip=CLIP), N_CLIENTS,
        device=device)
    log(f"individual_shifted: Elias-gamma bits per coordinate "
        f"{res['individual_shifted']['bits']} (measured); the reference's "
        f"message_bits (fixed-length code, |Supp M| <= 2 + t / eta) "
        f"{fixed}")
    # the configuration's dispatch: direct layering runs plain PyTorch
    direct_idx = torch.arange(0, D_DIRECT, D_DIRECT // KS_SAMPLE,
                              device=device)[:KS_SAMPLE]
    res["individual_direct"] = run_mechanism(
        "individual_direct", SIGMA_IND, device, direct_idx, {},
        d=D_DIRECT, rounds=1)
    laws.update(check_gaussian_law("individual_direct",
                                   res["individual_direct"], SIGMA_IND))
    for mech, r in res.items():
        log(f"{mech}: launches {r['launches']}, round walls "
            f"{[round(w, 3) for w in r['walls']]} s, last round split "
            f"{json.dumps({k: round(v, 4) for k, v in r['split'].items()})}"
            f" s, peak memory {r['peak_bytes'] / 2**30:.2f} GiB")
    done("3 (FL rounds)")
    held("after the FL rounds")
    ranks = run_ranks_phase(device, nccl_started)
    done("3b (client ranks)")
    held("after the client ranks")
    four, two = finish_mesh_spawns(mesh_spawns)
    done("3q-3s ranks (two spawns, beside the FL rounds and 3b)")
    hs = start_dryrun_ranks(device)
    done("3t (d)'s one rank; its ranks run beside 3c-3f")
    async_res = run_async_phase(device)
    done("3c (async runtime)")
    held("after the async runtime")
    train = run_train_phase(device)
    done("3d (train)")
    held("after the train phase")
    train_f32 = run_train_f32_phase(device)
    done("3f (train in f32)")
    held("after the f32 train phase")
    dpath = run_dither_pack(device, gen)
    held("after the dither_pack path")
    cfg, model32 = serve_model(device)
    # the reference casts at use; one cast copy gives the same values
    model = copy.deepcopy(model32).to(getattr(torch, cfg.compute_dtype))
    serve = run_serve(cfg, model, device)
    serve_f32 = check_serve_f32(cfg, model32, device)
    serve_profile = profile_serve(cfg, model, device)
    del model32, model
    torch.cuda.empty_cache()
    done("3 (dither_pack, qwen1.5-0.5b serve)")
    held("after the serve path")
    serve_dense = run_serve_dense_phase(device)
    done("3j (serve the dense configs)")
    held("after the dense serve phase")
    serve_moe = run_serve_moe_phase(device)
    done("3g (serve moe)")
    held("after the moe serve phase")
    llava = run_llava_phase(device)
    done("3h (llava prefill)")
    held("after the llava phase")
    train_moe = run_train_moe_phase(device)
    done("3i (train moe)")
    held("after the moe train phase")
    serve_rwkv = run_serve_rwkv6_phase(device)
    done("3k (serve rwkv6)")
    held("after the rwkv6 serve phase")
    train_rwkv = run_train_rwkv6_phase(device)
    done("3l (train rwkv6)")
    held("after the rwkv6 train phase")
    serve_zamba = run_serve_zamba2_phase(device)
    done("3m (serve zamba2)")
    held("after the zamba2 serve phase")
    train_zamba = run_train_zamba2_phase(device)
    done("3n (train zamba2)")
    held("after the zamba2 train phase")
    train_ranks_started = start_train_ranks(device)
    serve_whisper = run_serve_whisper_phase(device)
    done("3o (serve whisper)")
    held("after the whisper serve phase")
    train_whisper = run_train_whisper_phase(device)
    done("3p (train whisper)")
    held("after the whisper train phase")
    train_ranks = run_train_ranks_phase(train_ranks_started)
    done("3e (train across ranks, beside 3o and 3p)")
    held("after the train ranks")
    mesh = run_mesh_phase(device, four, two)
    done("3q (the mesh)")
    moe_mesh = run_moe_mesh_phase(device, two)
    done("3r (moe on the mesh)")
    family_mesh = run_family_mesh_phase(device, four, two)
    done("3s (rwkv6, zamba2 and whisper on the mesh)")
    del four, two
    held("after the mesh phases")
    dry = run_dryrun_phase(device, meta_proc, hs)
    done("3t")
    done("3")

    # 4. times
    copy_row = copy_rate(device)
    log(f"copy rate {copy_row['rate'] / 1e12:.4f} TB/s beside the data "
        f"sheet's "
        f"{rates[0] / 1e12:.2f} TB/s")
    rates = rates + (copy_row["rate"],)
    rows = time_kernels(device, gen, rates) + time_new_kernels(device, gen,
                                                               rates)
    rows += time_flash(device, gen, rates[0], rates[1], bf16_rate(name),
                       tf32_rate(name))
    rows += time_flash_bwd(device, gen, rates[0], bf16_rate(name),
                           tf32_rate(name))
    rows += time_wkv6(device, gen, rates[0], rates[1], tf32_rate(name))
    span_rows = time_flash_span(device, gen)
    launches = {k: sum(r["launches"][k] for r in res.values())
                + RANKS * sum(c["launches_per_rank"][k]
                              for c in ranks["cases"].values())
                + async_res["launches"][k]
                + dpath["launches"][k] + serve["launches"][k]
                + serve_f32["launches"][k] + train["launches"][k]
                + train_f32["launches"][k]
                + TRAIN_RANKS * train_ranks["launches_per_rank"][k]
                + sum(r["launches"][k] + r["f32"]["launches"][k]
                      for r in serve_moe.values())
                + llava["launches"][k] + llava["f32"]["launches"][k]
                + train_moe["launches"][k]
                + sum(r["launches"][k] + r["f32"]["launches"][k]
                      for r in serve_dense.values())
                + serve_rwkv["launches"][k]
                + serve_rwkv["prefill"]["launches"][k]
                + serve_rwkv["f32"]["launches"][k]
                + serve_rwkv["f32"]["scan_launches"][k]
                + train_rwkv["launches"][k]
                + serve_zamba["launches"][k]
                + serve_zamba["prefill"]["launches"][k]
                + serve_zamba["f32"]["launches"][k]
                + serve_zamba["f32"]["scan_launches"][k]
                + train_zamba["launches"][k]
                + serve_whisper["prefill"]["launches"][k]
                + serve_whisper["decode"]["launches"][k]
                + serve_whisper["f32"]["launches"][k]
                + serve_whisper["f32"]["chain_launches"][k]
                + train_whisper["launches"][k]
                + mesh["launches"][k] + moe_mesh["launches"][k]
                + family_mesh["launches"][k] + dry["launches"][k]
                for k in KERNELS}
    kernels = []
    for kname, (src, replaces) in KERNELS.items():
        main_row = next(r for r in rows if r["name"] == kname)
        kernels.append({
            "name": kname, "route": "cuda", "source": CSRC + src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": worst[kname], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row.get("library_ms")})
    done("4")
    total = time.perf_counter() - t_start
    report = {"card": smi, "build_s": secs, "f32_flash_smem": smem,
              "kernel_rows": rows,
              "copy": copy_row, "dither_pack_path": dpath,
              "message_bits_layered_shifted": fixed,
              "rounds": {m: {k: v for k, v in r.items() if k != "errs"}
                         for m, r in res.items()},
              "laws": laws, "flash_cases": flash["flash_cases"],
              "bwd_cases": bwd["bwd_cases"],
              "flash_window_cases": flash_w["flash_cases"],
              "bwd_window_cases": bwd_w["bwd_cases"],
              "flash_whisper_cases": flash_wh["flash_cases"],
              "bwd_whisper_cases": bwd_wh["bwd_cases"],
              "bwd_drift_cases": drift["bwd_cases"],
              "flash_mesh_cases": flash_m["flash_cases"],
              "bwd_mesh_cases": bwd_m["bwd_cases"],
              "flash_moe_mesh_cases": flash_mm["flash_cases"],
              "bwd_moe_mesh_cases": bwd_mm["bwd_cases"],
              "fwd_drift_cases": fwd_drift["fwd_drift_cases"],
              "flash_family_mesh_cases": flash_fm["flash_cases"],
              "bwd_family_mesh_cases": bwd_fm["bwd_cases"],
              "wkv_family_mesh_cases": wkv_fm["wkv_cases"],
              "drift_worst_ratio": {"flash_attention_f32":
                                    fwd_drift["worst_ratio"],
                                    "flash_attention_bwd_sm90": bwd_ratio},
              "flash_span": span_rows,
              "train": train, "train_f32": train_f32,
              "train_ranks": train_ranks,
              "client_ranks": ranks, "async": async_res,
              "serve": serve, "serve_f32": serve_f32,
              "serve_profile": serve_profile, "serve_moe": serve_moe,
              "llava": llava, "train_moe": train_moe,
              "serve_dense": serve_dense, "wkv_cases": wkv["wkv_cases"],
              "serve_rwkv6": serve_rwkv, "train_rwkv6": train_rwkv,
              "serve_zamba2": serve_zamba, "train_zamba2": train_zamba,
              "serve_whisper": serve_whisper,
              "train_whisper": train_whisper, "mesh": mesh,
              "moe_mesh": moe_mesh, "family_mesh": family_mesh,
              "dryrun": dry,
              "kernels": kernels, "phase_s": phase_s, "seconds": total}
    out_dir = ROOT / "build"
    try:
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    except OSError as e:
        log(f"(report not written: {e})")
    log(f"total {total:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
