#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths — Aaren and the
softmax baseline, each also on packed documents, the serving tier (prefix
cache, drain, crash failover, quarantine, snapshots), group remat,
fault-tolerant training with checkpoints and instrumented serving, the four
paper-table proxies, the examples, the hybrid recurrentgemma-9b with the
dense configs of its slice, and the SSM mamba2-1.3b and the MoE
qwen3-moe-30b-a3b with dbrx-132b — on one CUDA card and check them.

Run from the root of the repository, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; no phase catches its
own error):

1. Toolchain and card: ``nvidia-smi``, ``torch.version.cuda``, ``nvcc``;
   TF32 off for matmuls and cuDNN.
2. Build every CUDA kernel of the paths from ``src/repro_torch/csrc``, one
   ``nvcc`` per source, all started together; for each instantiation of the
   bf16 tensor-core kernels (B3, B4 and B5, SEG false and true) the HGMMA
   instructions in ``cuobjdump -sass`` of the built library and ``-Xptxas
   -v``'s registers and spills (a count of 0 fails the run); B2's
   registers and spills for each of its instantiations.
3. Each kernel against its plain PyTorch version on the card: B1 (serving
   form and residual form) and B2 on edge shapes (B1's at its chunk and
   window boundaries: N = 63, 64, 65, 513, 1025, d = 130; B2's at its own:
   N = 31, 33, 191, 193, 257 at d = 6, 96, 128, N = 1030 at d = 256; ``n1``
   bit-equal), the inputs of a real
   serving tick at the first and last layer, a small f32 model served on the
   card (kernels) and on the CPU (plain versions) with identical greedy
   tokens, and the same model's loss, every parameter gradient and three
   train steps on the card against the CPU.  The segmented B1 and B2 of
   packed rows on edge cases (a flag at token 0 with a carry, a carry with
   no flags, single-token segments, every token flagged, a padding tail and
   an all-padding row, N not a multiple of 32, extreme scores, packed rows
   at the training N, flags at chunk edges, a carry whose first flag lies
   in chunk 2, a padding tail across a window; for B2 ends at its chunk and
   window edges, a last end in chunk 0 and a d = 256 long row), and
   all-zero flags against no flags, bit for bit.
   B3, B4 and B5 on edge shapes (N = 1, odd N, N = 1000, ragged lengths
   with 0 and all-empty rows, window, GQA, d from 32 to 256, f32 and
   bf16; every f32 case with a bf16 twin), bf16 B3, B4 and B5 also against
   the tensor-core oracles of ``kernels/ref.py`` at 2 bf16 spacings of each
   row's max (+1e-6; B4 against its oracle in f64 sums, plus the f32 noise
   of the dP sums its dS cancels).  The segmented B3, B4 and B5 on packed
   edge cases (single-token documents, a document straddling 64-row tiles, a padding tail, an
   all-padding row, reused non-monotone ids, ids with q/kv lengths, ids
   with a window, GQA, d = 32 and 256, N = 1 and 1000, f32 and bf16, every
   f32 case with a bf16 twin), with padding rows and keys exactly 0 and
   all-ones ids against no ids, bit for bit.  The proxies' shapes (f32,
   d = 16, N = 1, 2, 7, 16, 48, 64, 96): B1 in both forms and B2 over 64
   rows with and without a carry, B3, B4 and B5 at B = 16, H = G = 4,
   causal (B4's dq and B5's dk may also differ by the f32 noise of their
   cancelled sums: at N = 1 both are 0 by cancellation).  A small f32
   softmax model's greedy tokens (plain and ragged
   prompts), loss, gradients and three train steps on the card against the
   CPU.  Small f32 Aaren and softmax models' packed loss and gradients on
   the card against the CPU, and their packed loss against per-document
   evaluation.
4. Full-width serving: ``phi3-mini-3.8b`` as registered (bf16, 32 layers,
   d_model 3072, 32 x 96 heads), random weights from a seed, 16 requests
   through the ``StreamingEngine`` (8 slots, chunk 16, prompts of 32-256
   tokens, 32 new tokens each), then one wave ``generate`` call (B = 4,
   P = 128, 8 new tokens).  Launch counts are zeroed just before and read
   just after.  Then a ``torch.profiler`` view of five ticks and B1's
   device time at the serving shape (a replayed CUDA graph, so host overhead
   drops out) beside its eager per-call time, its plain version's and its
   bound.
4k. The full-width serving tier on phase 4's parameters: a
   ``ReplicatedRouter`` of 2 replicas x 8 slots (chunk 16, greedy, the
   replicas on the one card stepped in turn) serving 32 requests made of
   one shared 256-token prefix (seed 1) and a unique 16-128-token suffix,
   32 new tokens each.  (a) Undisturbed: the reference tokens, each row's top-2
   logits kept.  (b) A ``PrefixCache`` shared by the replicas with the
   prefix pinned: tokens bit-equal to (a); hits, misses, prefill tokens
   and ticks saved, an entry's carry bytes beside a softmax KV cache's;
   the cache saved and loaded with bit-equal carries.  (c) Replica 1
   drained after 24 tier ticks: tokens bit-equal to (a).  (d) Replica 1
   crashed (``kill_router_replica``) after 24 ticks: every request
   finishes, those never on replica 1 bit-equal to (a), a failed-over one
   differing only from a step where (a)'s top-1 - top-2 logit margin is
   within 2 bf16 spacings of the top logit.  (e) Slot 3 of replica 0
   poisoned after 24 ticks: that request ends with ``ERR_POISONED``, the
   slot's carry is init bit for bit, every other request bit-equal to
   (a).  (f) Phase 4's load on one engine saved after 20 ticks and loaded
   into a fresh engine: tokens equal phase 4's.  (g) Batched temperature
   sampling (0.8, top-k 50; 4 prompts of 128 tokens, 8 new): the engine's
   tokens equal ``generate``'s, or differ only from a near tie of the
   Gumbel-perturbed scores.  B1's launches are zeroed before and read
   after every run and must equal 32 x the engine ticks that reached the
   model (+ 32 for ``generate``'s prefill); no plain scan may see a CUDA
   tensor.  The router turns a replica's exception into a failover: a run
   fails if any replica but (d)'s fails over, if (d)'s fails by anything
   but the injected crash, or if every replica is lost.
4b. Full-width training: the serving model freed, ``phi3-mini-3.8b`` as
   registered (``remat="block"``, AdamW) through ``make_train_step`` and
   ``run_train_loop`` on ``SyntheticLMIterator`` batches of 4 x 1024
   tokens, 1 warm-up and 4 measured steps; counts zeroed just before and
   read just after (B1 64 and B2 32 launches a step).  B1's and B2's inputs
   at layers 0 and 31 are captured in the first step and held against the
   plain versions.  Then step time, tokens/s, peak memory, MFU, a profiler
   view of one step and both kernels' device time at the training shape.
4c. Full-width softmax training: the same model, load and loop with
   ``attn_mode="softmax"`` (RoPE, flash attention): counts zeroed just
   before and read just after (B3 64, B4 32 and B5 32 launches a step);
   layer 0's flash inputs captured in the first step and held against the
   plain versions; step time, tokens/s, peak memory, MFU, a profiler view,
   and B3, B4, B5 at that shape (replayed CUDA graph, eager call, plain
   version, bound, and ``scaled_dot_product_attention`` as the yardstick —
   the port never calls it).
4d. Full-width softmax serving: ``generate`` with a KV cache (B = 4,
   P = 128, 8 new tokens, cache_len 136), counts zeroed just before and
   read just after (32 B3 launches for the prefill; decode is plain torch).
4e. Full-width packed training: phase 4b on ``PackedLMIterator`` batches
   through ``run_train_loop(pack_sequences=True)``: counts zeroed just
   before and read just after (64 segmented B1 and 32 segmented B2 launches
   a step, every call carrying flags, no plain scan reached with a CUDA
   tensor), captured layer-0/31 inputs against the plain versions, step
   time, tokens/s and real tokens/s (x token_util), peak memory, a profile
   and both segmented kernels' device time against their bounds.
4f. Full-width packed softmax training: phase 4c on the same
   ``PackedLMIterator`` batches through ``pack_sequences=True``: counts
   zeroed just before and read just after (64 segmented B3, 32 segmented
   B4 and 32 segmented B5 launches a step, every call carrying ids, no
   plain flash version reached with a CUDA tensor), layer 0's captured
   inputs against the plain versions, step time, tokens/s and real
   tokens/s, peak memory, a profile, and the three segmented kernels'
   device time against bounds counted on this batch's live same-document
   causal pairs, beside ``scaled_dot_product_attention`` under the
   block-diagonal causal boolean mask as the yardstick.
4g. Full-width group remat: phase 4b's model, batches and loop with
   ``remat="group"`` (8 checkpointed groups of 4 periods), 1 warm-up and 2
   measured steps: counts zeroed just before and read just after (B1 64
   and B2 32 launches a step); step 0's loss, the step median and the peak
   memory beside phase 4b's.
4j. Full-width fault-tolerant training and instrumented serving: phase
   4b's batches wrapped in ``FaultyLMIterator(nan_at={2})`` with
   ``faulty_loss`` and ``GuardConfig()``.  (a) The model as registered, 6
   guarded steps with an event log and a metrics snapshot: step 2 skipped
   with the parameters and moments bit-unchanged (per-leaf bit checksums
   on the card), the LR scale 0.5 from step 3, every other loss finite,
   the log valid with a leading ``run_meta`` naming the card; the guarded
   step median beside phase 4b's, the guard check's own cost and a
   profiler view of one more guarded step with tracing on (the
   ``train.step`` and ``aaren_scan_*.cuda`` spans).  The checkpointed runs
   keep the full width and 8 of the 32 layers: the card machine ends a
   command that has written 45 GiB to its disk, a 32-layer checkpoint is
   35.6 GiB, and the script's time limit leaves room for two saves, a
   restore and two crc passes of ~11 GB.  (a8) The same 6 steps as the
   reference; (b) the same load with a real SIGTERM after the 3rd draw
   drains into one sync checkpoint at step 3; (c) a fresh state resumes
   from it to step 6 with the losses and grad norms of steps 3-5 and the
   final parameters bit-equal to (a8), both checkpoints passing
   ``verify_checkpoint``.
   Counts zeroed before (a) and read after (c): 2 x layers B1 and layers
   B2 launches for each step, skipped ones included.  Then the
   checkpoint's bytes, the save, restore and crc pass in s and GB/s with
   the peak device memory.  Last, phase 4's serving load with a registry
   and an event sink installed: the tokens equal phase 4's, the log
   validates, TTFT and ITL p50/p99 and the tick median beside phase 4's
   (which runs with neither installed).  The temporary directories are
   deleted at the end.
4h. The paper-table proxies (``benchmarks/torch/bench_{rl,events,tsf,
   tsc}.py``), both mixers at the JAX modules' step counts and sizes
   (f32, d = 16): per proxy, counts zeroed just before and read just after
   (Aaren B1 and B2, softmax B3, B4 and B5, every launch accounted for), no
   plain version reached with a CUDA tensor, finite metrics, each mode's
   last training loss below its first; the task metrics and the
   Aaren-vs-Transformer relgap printed, not gated; each kernel on inputs
   captured in each proxy's first step against its plain version.
4i. The examples (``examples/torch``): quickstart (its loss must fall),
   chunked prefill (one-shot == chunked is a gate), streaming inference,
   and ``train_lm`` at its full width (~100M parameters, both mixers) for
   ``TRAIN_LM_STEPS`` steps; their launches printed.
4l. The hybrid family and the dense configs of ROADMAP A10a.  (e) The
   smoke configs of ``recurrentgemma-9b``, ``gemma3-27b``, ``llama3-405b``
   and ``minitron-8b``, both modes, f32: greedy tokens on the card equal
   to the CPU (the streaming engine at its default chunk, ``generate`` past
   the window), the loss and every gradient within phase 3's bars.  (a)
   ``recurrentgemma-9b`` as registered (bf16, 38 layers: 12 x (rglru,
   rglru, Aaren) + 2 rglru, d_model 4096, 16 x 256 heads, MQA, vocab
   256000, 8.579 B parameters), random weights from seed 0: phase 4's 16
   requests through the ``StreamingEngine`` at 8 slots and chunk 1, counts
   zeroed just before and read just after (12 B1 launches a tick, no plain
   version reached with a CUDA tensor), tick median, tok/s, the decode
   state a slot (1,263,104 B) and a profile of 5 ticks; B1's inputs of one
   tick held against its plain version; a drain (export + inject) after
   80 ticks and a snapshot restored into a fresh engine 80 ticks later,
   every request's tokens bit-equal to the undisturbed run.  (b) The same
   parameters in softmax mode: ``generate`` of B = 2, P = 2304 (past the
   2048 window) and 16 new tokens, counts zeroed just before and read just
   after (12 B3 launches, one prefill), the window KV rings and RG-LRU
   states' bytes, and every token against the full forward's argmax
   (equal, or a flip the two paths' measured disagreement allows) with
   the logits within ``HY_GEN_RTOL``; then the f32 control: the same
   ``generate`` at full width and 6 layers in f32, whose logits must stay
   within ``HY_F32_RTOL`` of the full forward's, its tokens equal the
   forward's argmax, and its window KV rings equal the forward's ring
   slot for slot within ``HY_F32_RING``.  (c) Training at full width and 12 layers
   (3.423 B parameters) in both modes, 1 x 4096 tokens (the window binds),
   AdamW, ``remat="block"``, 1 warm-up and 2 measured steps: counts zeroed
   just before and read just after (Aaren B1 8 and B2 4 a step; softmax B3
   8, B4 4 and B5 4), step time, peak memory, MFU, a profile of one step.
   (d) B1–B5 at these shapes against their plain versions, with device
   time, bound and library call (SDPA under the banded causal mask, with
   ``enable_gqa``): B1 at the serving tick (R = 128, N = 1, d = 256) and
   with residuals at training (R = 16, N = 4096), B2 at training, bf16
   B3–B5 at training (H = 16, G = 1, N = 4096, d = 256, window 2048), B3
   at the prefill (B = 2, N = 2304), and B3–B5 at gemma3-27b's local shape
   (H = 32, G = 16, d = 128, window 1024, N = 4096, random inputs).
4m. The SSM and MoE families of ROADMAP A10b and A10c, each model freed
   before the next is built, with the peak memory of each part.  (h) The
   smoke configs of ``mamba2-1.3b``, ``qwen3-moe-30b-a3b`` and
   ``dbrx-132b``, in each mode they have, f32: greedy tokens on the card
   equal to the CPU (the streaming engine at its default chunk, and
   ``generate``), the loss, its MoE metrics and every gradient within
   phase 3's bars, dbrx's AdaFactor steps.  ``mamba2-1.3b`` as registered
   (bf16, 48 SSD layers with no MLP, d_model 2048, d_inner 4096, 64 heads
   x 64, state 128, vocab 50280, tied, 1,343,740,928 parameters, seed 0):
   (a) phase 4's 16 requests at 8 slots and chunk 1, counts zeroed just
   before and read just after (no kernel launched, no plain version
   reached), tick median, tok/s, the decode state a slot (101,916,672 B),
   a profile of 5 ticks, a drain after 80 ticks and a snapshot 80 later,
   bit-equal; (b) ``generate`` of B = 2, P = 768 (three SSD chunks) and 256
   new tokens against the full forward over the 1024 tokens (logits within
   ``MB_GEN_RTOL``, a token differs from its argmax only where the two
   paths' disagreement allows, and decode no farther from the same
   weights' f32 forward than ``MB_GEN_EXACT`` times the bf16 forward, the
   residual stream's bf16 drift printed by layer), then the f32 control at 6 layers (logits within ``MB_F32_RTOL``, every
   token the forward's argmax), also from 1- and 2-token prompts; (c) 48
   layers trained on 4 x 1024 tokens, AdamW, ``remat="block"``, 1 + 2
   steps, no kernel launched.  ``qwen3-moe-30b-a3b`` as registered (bf16,
   48 layers, d_model 2048, 32 x 128 heads, 4 kv heads, 128 experts top-8
   of width 768, capacity factor 1.25, vocab 151936, untied, seed 0): (d)
   Aaren serving of phase 4's 16 requests at 8 slots and chunk 16 (48 B1
   launches a tick, B1's inputs of one tick against its plain version, the
   decode state a slot 798,720 B), a drain and a snapshot bit-equal; (e)
   softmax ``generate`` of B = 4, P = 128, 8 new (48 B3 launches: one
   prefill) with the prefill's ``dropped_frac``, then the f32 control at 4
   layers with capacity factor 16 (nothing dropped; logits within
   ``MOE_F32_RTOL``, every token the forward's argmax); (f) training at
   full width and 4 layers, both modes, 4 x 1024 tokens, 1 + 2 steps (a
   step: Aaren 8 B1 + 4 B2, softmax 8 B3 + 4 B4 + 4 B5), each step's
   ``load_balance_loss`` and ``dropped_frac``, MFU on the active
   parameters; (g) B1–B5 at qwen3's shapes against their plain versions,
   with device time, bound and SDPA (``enable_gqa``) beside B3–B5.
5. Result lines: the kernels' JSON, the card, and the contract line.
"""

from __future__ import annotations

import gc
import importlib.metadata
import importlib.util
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "phi3-mini-3.8b"
SLOTS, CHUNK, REQUESTS, MAX_NEW = 8, 16, 16, 32
GEN_B, GEN_P, GEN_NEW = 4, 128, 8
TRAIN_B, TRAIN_N, TRAIN_WARM, TRAIN_MEASURED = 4, 1024, 1, 4
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
F32_OPS_PER_S = 67e12             # the same, f32 outside the tensor cores
BF16_DENSE_FLOPS = 989e12         # the same, bf16 dense tensor cores
TOL = dict(rtol=1e-4, atol=1e-4)  # the JAX suite's bar for these kernels
# Device times (us) of the designs that the chunked scans of B1 and B2 and
# bf16 B4's tensor-core kernel replaced (B1, B2: one warp walking a row; B4:
# SIMT f32), measured by this script's phases 4-4f on an NVIDIA H100 80GB
# HBM3 at a 700.00 W power limit: printed beside the new times.
BEFORE_US = {("aaren_scan", "serve"): 13.896,
             ("aaren_scan", "train"): 1487.10,
             ("aaren_scan", "train_packed"): 1510.60,
             ("aaren_scan_bwd", "train"): 598.39,
             ("aaren_scan_bwd", "train_packed"): 613.65,
             ("flash_bwd_dq", "train"): 2321.93,
             ("flash_bwd_dq", "train_packed"): 1230.75}


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _phase(name: str, t0: float) -> None:
    print(f"== {name} (t = {time.perf_counter() - t0:.1f} s)", flush=True)


def _to(tree, device):
    """A copy of a parameter tree on ``device`` (never the same tensors:
    the train step updates its parameters in place)."""
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.detach().to(device, copy=True), tree)


def _scan_inputs(torch, np, r, n, d, carry, seed, pad_rows=(), spread=3.0):
    from repro_torch.core.scan_attention import NEG_INF

    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((r, n)) * spread).astype(np.float32)
    v = rng.standard_normal((r, n, d)).astype(np.float32)
    for row in pad_rows:  # all-padding rows: ⊕-identity leaves
        s[row], v[row] = NEG_INF, 0.0
    if carry:
        m0 = (rng.standard_normal((r, 1)) * 2).astype(np.float32)
        u0 = rng.uniform(0.5, 3.0, (r, 1)).astype(np.float32)
        w0 = (rng.standard_normal((r, d)) * u0).astype(np.float32)
    else:
        m0 = np.full((r, 1), NEG_INF, np.float32)
        u0 = np.zeros((r, 1), np.float32)
        w0 = np.zeros((r, d), np.float32)
    return [torch.from_numpy(a).cuda() for a in (s, v, m0, u0, w0)]


def _compare_scan(torch, args, label, starts=None) -> float:
    """B1 (CUDA kernel) against its plain version on the same tensors;
    ``starts``: the segment-start flags of a packed call, or None."""
    from repro_torch.kernels.aaren_scan import aaren_scan, aaren_scan_plain

    got = aaren_scan(*args, segment_starts=starts)
    want = aaren_scan_plain(*args, segment_starts=starts)
    torch.cuda.synchronize()
    _require(torch.equal(got[1], want[1]),
             f"{label}: m_f differs from the plain version")
    err = 0.0
    for name, a, b in zip("oumw", (got[0], got[2], got[3]),
                          (want[0], want[2], want[3])):
        _require(bool(torch.isfinite(a).all()),
                 f"{label}: kernel {name} is not finite")
        torch.testing.assert_close(a, b, **TOL, msg=lambda m: f"{label} "
                                   f"{name}: {m}")
        err = max(err, (a - b).abs().max().item())
    print(f"  {label}: R={args[0].shape[0]} N={args[0].shape[1]} "
          f"d={args[1].shape[2]} max|kernel - plain| = {err:.3e}")
    return err


def _compare_scan_residuals(torch, args, label, starts=None) -> float:
    """B1's residual form against its plain version, and against its own
    serving form: the residuals change none of the serving outputs."""
    from repro_torch.kernels.aaren_scan import aaren_scan, aaren_scan_plain

    got = aaren_scan(*args, segment_starts=starts, return_residuals=True)
    serve = aaren_scan(*args, segment_starts=starts)
    want = aaren_scan_plain(*args, segment_starts=starts,
                            return_residuals=True)
    torch.cuda.synchronize()
    _require(all(torch.equal(a, b) for a, b in zip(got[:4], serve)),
             f"{label}: the residual form changed a serving output")
    _require(torch.equal(got[1], want[1]) and torch.equal(got[4], want[4]),
             f"{label}: m_f or m_all differs from the plain version")
    err = 0.0
    for name, i in (("o", 0), ("u_f", 2), ("w_f", 3), ("u_all", 5)):
        _require(bool(torch.isfinite(got[i]).all()),
                 f"{label}: kernel {name} is not finite")
        torch.testing.assert_close(got[i], want[i], **TOL,
                                   msg=lambda m: f"{label} {name}: {m}")
        err = max(err, (got[i] - want[i]).abs().max().item())
    print(f"  {label} (residuals): max|kernel - plain| = {err:.3e}, m_all "
          "bit-equal")
    return err


def _bwd_inputs(torch, np, fwd_args, seed, zero_u=False, starts=None):
    """B2's inputs: the plain forward's residuals on the card, cotangents
    from numpy, the seed (-m_f, g_w, -g_u)."""
    from repro_torch.kernels.aaren_scan import aaren_scan_plain

    s, v, m0, u0, w0 = fwd_args
    o, m_f, _, _, m_all, u_all = aaren_scan_plain(
        s, v, m0, u0, w0, segment_starts=starts, return_residuals=True)
    rng = np.random.default_rng(seed)
    r, n, d = v.shape
    g_o, g_u, g_w = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).cuda() for shape in ((r, n, d), (r, 1), (r, d)))
    if zero_u:  # empty-state positions: 1/u must be zeroed, not inf
        u_all = u_all.clone()
        u_all[:, ::3] = 0.0
    return [s, v, o, m_all, u_all, g_o, -m_f, g_w, -g_u]


def _compare_bwd(torch, args, label, ends=None) -> float:
    """B2 (CUDA kernel) against its plain version on the same tensors, each
    output scaled by max |plain| (the JAX suite's gradient bar); ``ends``:
    the segment-end flags of a packed call, or None."""
    from repro_torch.kernels.aaren_scan_bwd import (
        aaren_scan_bwd,
        aaren_scan_bwd_plain,
    )

    got = aaren_scan_bwd(*args, segment_ends=ends)
    want = aaren_scan_bwd_plain(*args, segment_ends=ends)
    torch.cuda.synchronize()
    _require(torch.equal(got[2], want[2]),
             f"{label}: n1 differs from the plain version")
    err = 0.0
    for name, a, b in zip(("ds", "dv", "n1", "g1", "b1"), got, want):
        _require(bool(torch.isfinite(a).all()),
                 f"{label}: kernel {name} is not finite")
        scale = max(b.abs().max().item(), 1e-6)
        torch.testing.assert_close(a / scale, b / scale, **TOL,
                                   msg=lambda m: f"{label} {name}: {m}")
        err = max(err, (a - b).abs().max().item())
    print(f"  {label} (B2): R={args[0].shape[0]} N={args[0].shape[1]} "
          f"d={args[1].shape[2]} max|kernel - plain| = {err:.3e}, n1 "
          "bit-equal")
    return err


def _time_ms(torch, fn, n_iter: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``n_iter`` calls.

    Eager calls: where the host enqueues slower than the card runs, this is
    the host's time per call."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_iter):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n_iter)
    return statistics.median(times)


def _graph_ms(torch, fn, n_iter: int) -> float:
    """Device time of one ``fn()``: ``n_iter`` calls captured in one CUDA
    graph, replayed and timed with CUDA events, so host overhead drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n_iter):
            fn()
    return _time_ms(torch, graph.replay, 1) / n_iter


def _device_profile(torch, fn, n: int):
    """Device busy time of ``n`` calls of ``fn`` from ``torch.profiler``.

    Returns (wall ms per call, device ms per call, [(kernel, device ms per
    call), ...] largest first), or None when the profiler saw no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [(e.key, e.self_device_time_total / 1e3 / n)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(ms for _, ms in kernels)
    if device_ms == 0:
        return None
    return wall_ms, device_ms, sorted(kernels, key=lambda kv: -kv[1])


# Kernel-name patterns of each group of the device-time breakdown; the
# first match wins, and a kernel that matches none is "other".
KERNEL_GROUPS = (
    ("B1 aaren_scan_fwd_kernel", ("aaren_scan_fwd",)),
    ("B2 aaren_scan_bwd_kernel", ("aaren_scan_bwd",)),
    ("B3 flash_fwd_kernel", ("flash_fwd_kernel", "flash_fwd_wgmma_kernel")),
    ("B4 flash_bwd_dq_kernel", ("flash_bwd_dq_kernel",
                                "flash_bwd_dq_wgmma_kernel")),
    ("B5 flash_bwd_dkv_kernel", ("flash_bwd_dkv_kernel",
                                 "flash_bwd_dkv_wgmma_kernel")),
    ("GEMM/GEMV (bf16 and f32)", ("gemm", "gemv", "nvjet", "xmma", "sgemm")),
    ("reductions (norms, sums, log-softmax)", ("reduce", "softmax", "norm")),
    ("elementwise and copies (casts, AdamW, scaling)",
     ("elementwise", "copy", "Memcpy", "Memset", "fill", "index", "cat",
      "where", "scatter", "gather")),
)


def _group(key: str) -> str:
    for name, patterns in KERNEL_GROUPS:
        if any(p.lower() in key.lower() for p in patterns):
            return name
    return "other"


def _print_profile(prof, what: str, card: str, top: int = 10) -> None:
    if prof is None:
        print(f"  {what} profile: the profiler saw no device time (not "
              "measured)")
        return
    wall_ms, device_ms, kernels = prof
    print(f"  {what} profile: wall {wall_ms:.3f} ms, device busy "
          f"{device_ms:.3f} ms ({device_ms / wall_ms:.1%})  [{card}]")
    groups: dict[str, float] = {}
    for key, ms in kernels:
        groups[_group(key)] = groups.get(_group(key), 0.0) + ms
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:9.3f} ms  {ms / device_ms:6.1%}  group: {name}")
    for key, ms in kernels[:top]:
        print(f"    {ms:9.3f} ms  {key[:100]}")


def _bound(nbytes: float, nops: float, ops_per_s: float = F32_OPS_PER_S):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def _b1_bound(r, n, d, residuals: bool, flags: bool = False):
    """B1: each input read once, each output written once (f32; the
    segment flags one byte a token); ~4 f32 operations per element of w per
    token plus ~5 per token of a row."""
    nbytes = 4 * r * n * (2 * d + 1) + 8 * r * (d + 2)
    if residuals:
        nbytes += 8 * r * n
    if flags:
        nbytes += r * n
    return _bound(nbytes, r * n * (4 * d + 5)) + (nbytes,)


def _b2_bound(r, n, d, flags: bool = False):
    """B2: s, m, u, v, o, g, the seed (and the flags, one byte a token)
    read once, ds, dv and the final carry written once (f32); ~9 f32
    operations per element of G per token plus ~12 per token of a row."""
    nbytes = 4 * r * n * (4 * d + 4) + 8 * r * (d + 2) + (r * n if flags
                                                          else 0)
    return _bound(nbytes, r * n * (9 * d + 12)) + (nbytes,)


def _kernel_times(torch, fn, plain, n_iter, plain_iter):
    """(device ms, eager call ms, plain device ms, plain eager call ms)."""
    return (_graph_ms(torch, fn, n_iter), _time_ms(torch, fn, n_iter),
            _graph_ms(torch, plain, plain_iter),
            _time_ms(torch, plain, plain_iter))


EDGE_CASES = [
    ("single token, empty carry", 1, 1, 8, False, (), 3.0),
    ("odd N, R % 32 != 0, carry", 7, 5, 96, True, (), 3.0),
    ("prime N, all-padding rows", 37, 97, 96, False, (0, 5), 3.0),
    ("serving N, padding row + carry", 33, 16, 96, True, (3,), 3.0),
    ("extreme scores (+-80)", 6, 48, 128, True, (), 80.0),
    ("widest d", 5, 33, 256, True, (), 3.0),
    # B1's chunks of 64 tokens and windows of 8 chunks (csrc/aaren_scan.cu)
    ("one chunk short, carry", 3, 63, 96, True, (), 3.0),
    ("one chunk, all-padding row", 3, 64, 96, False, (1,), 3.0),
    ("one chunk and a token, carry", 3, 65, 96, True, (2,), 3.0),
    ("a window and a token, carry", 3, 513, 96, True, (0,), 3.0),
    ("two windows and a token, extreme scores", 2, 1025, 96, True, (),
     80.0),
    ("d = 130 (a 2-column slice, unvectorised), carry", 3, 200, 130, True,
     (1,), 3.0),
]
BWD_ONLY_CASES = [
    ("u == 0 residual positions", 9, 70, 96, True, (), 3.0),
    ("extreme scores (+-80), training N", 4, 1024, 96, True, (), 80.0),
    ("widest d, long row", 3, 300, 256, False, (1,), 3.0),
    # B2's chunks of 32 tokens and windows of 6 chunks at d = 96, 4 at
    # d = 128, 2 at d = 256 and 8 at d = 6 (csrc/aaren_scan_bwd.cu)
    ("B2: one chunk short, seed", 3, 31, 96, True, (), 3.0),
    ("B2: one chunk and a token, seed", 3, 33, 96, True, (2,), 3.0),
    ("B2: a window less a token, seed", 3, 191, 96, True, (), 3.0),
    ("B2: a window and a token, seed", 3, 193, 96, True, (0,), 3.0),
    ("B2: d = 128, two windows and a token", 3, 257, 128, True, (), 3.0),
    ("B2: d = 256, long row, extreme scores", 2, 1030, 256, True, (1,),
     80.0),
    ("B2: d = 6 (unvectorised), a window and a token", 3, 257, 6, True,
     (), 3.0),
]


# The bf16 tensor-core kernels, by library: B3, B4 and B5.
WGMMA_KERNELS = (("flash_fwd", "flash_fwd_wgmma_kernel"),
                 ("flash_bwd", "flash_bwd_dq_wgmma_kernel"),
                 ("flash_bwd", "flash_bwd_dkv_wgmma_kernel"))


def _ptxas_usage(log: str) -> dict[str, str]:
    """{mangled kernel: "R registers, S bytes spill stores, L bytes spill
    loads"} from ``-Xptxas -v`` output."""
    usage, spills, fn = {}, {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
        elif fn and "spill stores" in line:
            spills[fn] = ", ".join(part.strip() for part in
                                   line.strip().split(",")[1:])
        elif "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "Used" in line and "registers" in line:
            usage[fn] = line.split("Used")[1].split(",")[0].strip()
    return {fn: f"{usage[fn]}, {spills.get(fn, 'no spill line')}"
            for fn in usage}


def phase2_tensor_cores(kbuild, logs) -> None:
    """For every instantiation of the bf16 tensor-core kernels (B3, B4, B5;
    each head-dim class, SEG false and true): its HGMMA instructions in the
    built library's SASS, and ``-Xptxas -v``'s registers and spills.  Fails
    when an instantiation has no HGMMA."""
    cuobjdump = str(Path(kbuild._nvcc()).parent / "cuobjdump")
    for lib, kernel in WGMMA_KERNELS:
        sass = subprocess.run([cuobjdump, "-sass",
                               str(kbuild.library_path(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
            elif fn and kernel in fn and "HGMMA" in line:
                counts[fn] = counts.get(fn, 0) + 1
        usage = _ptxas_usage(logs.get(lib, ""))
        names = sorted({fn for fn in usage if kernel in fn} | set(counts))
        _require(len(names) == 10, f"{kernel}: {len(names)} instantiations "
                 "found, want 10 (five head-dim classes, SEG false and true)")
        for fn in names:
            # _Z..ILi6ELb1EE..: NK = 6, SEG = true
            nk = fn.split("ILi")[1].split("E")[0]
            seg = "true" if "ELb1E" in fn else "false"
            print(f"  {kernel}<NK={nk}, SEG={seg}>: {counts.get(fn, 0)} "
                  f"HGMMA; {usage.get(fn, 'ptxas output not seen')}")
            _require(counts.get(fn, 0) > 0, f"{fn}: no HGMMA instruction in "
                     "the SASS")


def phase2_scan_bwd_usage(logs) -> None:
    """``-Xptxas -v``'s registers and spills of each instantiation of B2
    (KPL = ceil(d / 32) columns a lane)."""
    usage = _ptxas_usage(logs.get("aaren_scan_bwd", ""))
    names = sorted(fn for fn in usage if "aaren_scan_bwd_kernel" in fn)
    if not names:
        print("  aaren_scan_bwd_kernel: ptxas output not seen")
    for fn in names:
        kpl = fn.split("ILi")[1].split("E")[0]
        print(f"  aaren_scan_bwd_kernel<KPL={kpl}>: {usage[fn]}")


def phase3_kernels(torch, np) -> tuple[float, float]:
    """B1 (both forms) and B2 against their plain versions on edge shapes.
    Returns (max |err| of B1, of B2)."""
    b1_err = b2_err = 0.0
    for i, (label, r, n, d, carry, pad, spread) in enumerate(EDGE_CASES):
        args = _scan_inputs(torch, np, r, n, d, carry, seed=i,
                            pad_rows=pad, spread=spread)
        b1_err = max(b1_err, _compare_scan(torch, args, label),
                     _compare_scan_residuals(torch, args, label))
        b2_err = max(b2_err, _compare_bwd(
            torch, _bwd_inputs(torch, np, args, seed=50 + i), label))
    for i, (label, r, n, d, carry, pad, spread) in enumerate(BWD_ONLY_CASES):
        args = _scan_inputs(torch, np, r, n, d, carry, seed=20 + i,
                            pad_rows=pad, spread=spread)
        bwd = _bwd_inputs(torch, np, args, seed=70 + i,
                          zero_u=label.startswith("u == 0"))
        b2_err = max(b2_err, _compare_bwd(torch, bwd, label))
    return b1_err, b2_err


# The paper-table proxies' shapes (benchmarks/torch/common.py::bench_cfg:
# 4 heads of d = 16, f32): B1 and B2 over B·H = 64 rows, B3, B4 and B5 at
# B = 16, H = G = 4, causal; N from the RL rollout's first token to TSF's 96.
PROXY_N = (1, 2, 7, 16, 48, 64, 96)
PROXY_ROWS, PROXY_B, PROXY_H, PROXY_D = 64, 16, 4, 16


def phase3_proxy_kernels(torch, np) -> dict:
    """B1 (both forms) and B2 at the proxies' shapes, with and without a
    carry, and B3, B4 and B5 there, causal, all f32, against their plain
    versions at the bars of the edge cases; B4's dq and B5's dk may also
    differ by the f32 noise of their cancelled sums (at N = 1 both are 0
    by cancellation, :func:`_cancel_noise`).  Returns {wrapper name: max
    |kernel - plain|}."""
    errs = {"aaren_scan": 0.0, "aaren_scan_bwd": 0.0, "flash_attention": 0.0,
            "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for i, n in enumerate(PROXY_N):
        for carry in (False, True):
            label = f"proxy shape N = {n}{', carry' if carry else ''}"
            args = _scan_inputs(torch, np, PROXY_ROWS, n, PROXY_D, carry,
                                seed=400 + 2 * i + carry)
            errs["aaren_scan"] = max(
                errs["aaren_scan"], _compare_scan(torch, args, label),
                _compare_scan_residuals(torch, args, label))
            errs["aaren_scan_bwd"] = max(errs["aaren_scan_bwd"], _compare_bwd(
                torch, _bwd_inputs(torch, np, args, seed=450 + 2 * i + carry),
                label))
        q, k, v, do = _flash_inputs(torch, np, PROXY_B, PROXY_H, PROXY_H, n,
                                    PROXY_D, "float32", seed=480 + i)
        got = _check_flash(torch, q, k, v, do, None, True, None,
                           f"proxy shape N = {n}", cancel_noise=True)
        errs = {key: max(val, got.get(key, 0.0)) for key, val in errs.items()}
    return errs


# label, R, N, d, carry, score spread: the segmented B1/B2 edge cases
SEG_CASES = [
    ("docs + padding tail", 4, 23, 96, False, 3.0),
    ("flag at token 0, carry", 4, 23, 96, True, 3.0),
    ("carry, no flags", 4, 23, 96, True, 3.0),
    ("every token flagged, carry", 4, 40, 96, True, 3.0),
    ("single-token docs, all-padding row", 5, 33, 96, False, 3.0),
    ("N % 32 != 0, random flags, carry", 7, 70, 128, True, 3.0),
    ("extreme scores (+-80), docs", 6, 48, 96, True, 80.0),
    ("packed rows at the training N", 8, 1024, 96, False, 3.0),
    ("flags at chunk edges, carry", 4, 600, 96, True, 3.0),
    ("carry, first flag in chunk 2", 4, 300, 96, True, 3.0),
    ("every token flagged across chunks, carry", 3, 130, 96, True, 3.0),
    ("padding tail across a window, carry", 4, 1030, 96, True, 3.0),
    ("B2 ends at chunk and window edges, seed", 4, 600, 96, True, 3.0),
    ("B2 last end in chunk 0, seed crosses every chunk", 3, 700, 96, True,
     3.0),
    ("B2 d = 256, long row, random ends, seed", 2, 1030, 256, True, 3.0),
]


def _segmented_inputs(torch, np, label, r, n, d, carry, spread, seed):
    """(B1's args on the card, (R, N) bool start flags) of one edge case;
    padding positions are ⊕-identity leaves, as ``ops`` makes them."""
    from repro_torch.core.scan_attention import NEG_INF

    rng = np.random.default_rng(seed)
    starts = np.zeros((r, n), bool)
    pad = np.zeros((r, n), bool)
    if label.startswith("docs"):
        starts[:, [7, 15]] = True
        pad[:, 20:] = True
    elif label.startswith("flag at token 0"):
        starts[:, [0, 9]] = True
    elif label.startswith("every token"):
        starts[:] = True
    elif label.startswith("flags at chunk edges"):
        starts[:, [63, 64, 127, 128, 511, 512, 575, 576]] = True
    elif label.startswith("carry, first flag"):
        starts[:, [140, 141, 255, 256]] = True
    elif label.startswith("B2 ends at chunk"):  # ends at 31, 32, 191, ...
        starts[:, [32, 33, 192, 193, 384, 385]] = True
    elif label.startswith("B2 last end"):       # one end, at token 2
        starts[:, 3] = True
    elif label.startswith("B2 d = 256"):
        starts = rng.random((r, n)) < 0.05
    elif label.startswith("padding tail across"):
        starts[:, [100, 300, 511]] = True
        pad[:, 500:] = True
        pad[1] = True
    elif label.startswith("single-token"):
        starts[:, [3, 4, 5, 11]] = True
        pad[:, 28:] = True
        pad[2], starts[2] = True, False
    elif label.startswith("N % 32"):
        starts = rng.random((r, n)) < 0.1
        pad[1, 50:] = True
    elif label.startswith("extreme"):
        starts[:, [5, 6, 17, 40]] = True
    elif label.startswith("packed rows"):
        for row in range(r):       # documents of 8-400 tokens, then padding
            at = 0
            while True:
                length = int(8 + 392 * rng.random() ** 3)
                if at + length > n:
                    break
                starts[row, at] = at > 0
                at += length
            pad[row, at:] = True
    starts &= ~pad
    args = _scan_inputs(torch, np, r, n, d, carry, seed, spread=spread)
    pad_t = torch.from_numpy(pad).cuda()
    args[0][pad_t] = NEG_INF
    args[1][pad_t] = 0.0
    return args, torch.from_numpy(starts).cuda()


def phase3_segmented_kernels(torch, np) -> tuple[float, float]:
    """Segmented B1 (both forms) and B2 against their plain versions on the
    edge cases, and all-zero flags against no flags, bit for bit.  Returns
    (max |err| of segmented B1, of segmented B2)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.aaren_scan import aaren_scan
    from repro_torch.kernels.aaren_scan_bwd import aaren_scan_bwd

    b1_err = b2_err = 0.0
    for i, case in enumerate(SEG_CASES):
        label = f"segmented: {case[0]}"
        args, starts = _segmented_inputs(torch, np, *case, seed=400 + i)
        b1_err = max(b1_err, _compare_scan(torch, args, label, starts),
                     _compare_scan_residuals(torch, args, label, starts))
        bwd = _bwd_inputs(torch, np, args, seed=450 + i, starts=starts)
        ends = ops._segment_ends(starts)
        b2_err = max(b2_err, _compare_bwd(torch, bwd, label, ends))
        zeros = torch.zeros_like(starts)
        same = [torch.equal(a, b) for a, b in zip(
            aaren_scan(*args, segment_starts=zeros, return_residuals=True),
            aaren_scan(*args, return_residuals=True))]
        same += [torch.equal(a, b) for a, b in zip(
            aaren_scan_bwd(*bwd, segment_ends=zeros), aaren_scan_bwd(*bwd))]
        _require(all(same), f"{label}: all-zero flags differ from no flags")
    print("  segmented B1 and B2: all-zero flags give bit-identical outputs "
          f"to the unflagged kernels on all {len(SEG_CASES)} cases")
    return b1_err, b2_err


# label, (B, H, G, N, d), dtype, causal, window, per-row lengths (q and kv)
FLASH_CASES = [
    ("N = 1", (1, 2, 2, 1, 32), "float32", True, None, None),
    ("odd N, ragged lengths incl. 0", (3, 4, 4, 97, 96), "float32", True,
     None, (0, 50, 97)),
    ("all-empty rows", (2, 2, 2, 64, 32), "float32", True, None, (0, 0)),
    ("oversized lengths clamped", (2, 2, 2, 37, 32), "float32", True, None,
     (500, 37)),
    ("window 48, ragged", (2, 4, 4, 255, 96), "float32", True, 48, (200, 255)),
    ("non-causal, ragged", (2, 4, 4, 97, 32), "float32", False, None,
     (97, 40)),
    ("N = 1000, GQA 4:2, ragged", (2, 4, 2, 1000, 96), "float32", True, None,
     (1000, 613)),
    ("GQA 8:1, window 64", (1, 8, 1, 300, 32), "float32", True, 64, None),
    ("d = 40, odd N", (2, 2, 2, 71, 40), "float32", True, None, (71, 9)),
    ("d = 130, window 16", (1, 2, 1, 150, 130), "float32", True, 16, None),
    ("d = 256, ragged, GQA 2:1", (2, 2, 1, 257, 256), "float32", True, None,
     (257, 130)),
    ("d = 256, window 64", (1, 4, 2, 300, 256), "float32", True, 64, None),
    ("bf16, GQA 8:2, ragged", (2, 8, 2, 333, 96), "bfloat16", True, None,
     (333, 100)),
    ("bf16, d = 256, window 32", (1, 2, 2, 129, 256), "bfloat16", True, 32,
     None),
    ("bf16, N = 1, an empty row", (2, 2, 2, 1, 32), "bfloat16", True, None,
     (1, 0)),
]
# A bf16 twin of every f32 case: bf16 runs B3 and B5 on the tensor cores.
FLASH_CASES += [(f"{c[0]} (bf16)", c[1], "bfloat16", *c[3:])
                for c in FLASH_CASES if c[2] == "float32"]
# The CPU parity bars of tests/test_torch_flash.py: forward rtol = atol (f32
# 2e-5, bf16 2e-2); gradients |kernel - plain| <= rtol * max |plain| + 1e-6.
FLASH_FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# bf16 B3, B4 and B5 against the oracles of their rounding points
# (kernels/ref.py): both round the same p and dS to bf16, so they differ
# by the order of f32 sums, a rare p or dS that rounds the other way, and
# the last rounding of the bf16 output (at most one spacing of a row's
# max).
ORACLE_SPACINGS = 2.0
# B4's dq has rows whose true value is 0 by cancellation: a query that sees
# only its own key has dS = p (dP - delta) with dP = do . v = delta up to
# rounding, so any f32 sum leaves noise of the size of f32 rounding of
# sum_c |do_c v_c|, carried into dq, which grows with d and is not covered
# by the 1e-6 floor; the f32-sum oracle differs from an f64-sum one there
# by noise of the same size.  So B4 is held to the f64-sum oracle, with 4
# f32 ulps (2^-21) of those sums, carried into dq, added to the bar per
# element (_cancel_noise).
DQ_NOISE_ULPS = 2.0 ** -21


def _flash_inputs(torch, np, b, h, g, n, d, dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = ((b, h, n, d), (b, g, n, d), (b, g, n, d), (b, h, n, d))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .cuda().to(getattr(torch, dtype)) for s in shapes]


def _grad_close(a, b, rtol, what, noise=None):
    """|a - b| <= rtol * max|b| + 1e-6 (the 1e-6 floor is the f32 noise of a
    dense reference where the true gradient is 0), + ``noise`` per element
    when given (:func:`_cancel_noise`)."""
    a, b = a.float(), b.float()
    _require(bool(a.isfinite().all()), f"{what}: kernel output not finite")
    diff = (a - b).abs()
    err = diff.max().item()
    bar = rtol * b.abs().max().item() + 1e-6
    if noise is None:
        _require(err <= bar, f"{what}: max |kernel - plain| {err:.3e} > "
                 f"{bar:.3e}")
    else:
        over = (diff - bar - noise).max().item()
        _require(over <= 0, f"{what}: |kernel - plain| over {bar:.3e} + the "
                 f"f32 noise of its cancelled sums by {over:.3e}")
    return err


def _oracle_close(torch, a, b, what, noise=None):
    """The tensor-core oracle bar: on every output row (a query's o or dq, a
    key's dk or dv), |kernel - oracle| <= ORACLE_SPACINGS bf16 spacings of
    the row's max |oracle| (the spacing of x is 2^(floor(log2 x) - 7), 0 for
    x = 0) + 1e-6, the f32 noise floor of FLASH_GRAD_TOL's bar where the
    true value is 0, + ``noise`` (per element, when given).  Returns the
    worst |kernel - oracle| as a fraction of its bar (at most 1)."""
    a, b = a.float(), b.float()
    _require(bool(a.isfinite().all()), f"{what}: kernel output not finite")
    row_max = b.abs().amax(dim=-1, keepdim=True)
    spacing = torch.where(row_max > 0,
                          torch.exp2(torch.floor(torch.log2(row_max)) - 7),
                          0.0)
    bar = ORACLE_SPACINGS * spacing + 1e-6
    if noise is None:
        err = (a - b).abs().amax(dim=-1, keepdim=True)
    else:
        err, bar = (a - b).abs(), bar + noise
    over = (err - bar).flatten()
    worst = over.argmax()
    _require(bool((over <= 0).all()), f"{what}: |kernel - oracle| "
             f"{err.flatten()[worst].item():.3e} on a row whose max |oracle| "
             f"is {row_max.expand_as(err).flatten()[worst].item():.3e}, over "
             f"its bar {bar.expand_as(err).flatten()[worst].item():.3e} "
             f"({ORACLE_SPACINGS} bf16 spacings + 1e-6"
             f"{'' if noise is None else ' + f32 noise'})")
    return (err / bar).max().item()


def _cancel_noise(torch, args, kw):
    """Per element of dq and of dk: DQ_NOISE_ULPS of each live pair's
    sum_c |do_ic v_jc|, weighted by p_ij and carried through dq = scale
    sum_j dS_ij k_j and dk = scale sum_i dS_ij q_i (summed over a kv head's
    query heads).  At N = 1 every dS is 0 by cancellation (p = 1, o = v),
    so the whole of dq and dk is f32 rounding noise of this size, for the
    kernel and the plain version alike.  Returns (dq noise, dk noise)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do, lse, delta, ql, kl = args
    b, g, n_k, d = k.shape
    group = q.shape[1] // g
    p, _ = fa._p_ds(*args, kw["causal"], kw["window"], kw["scale"],
                    kw["q_seg"], kw["kv_seg"])
    ve, ke = (torch.repeat_interleave(t, group, dim=1).float().abs()
              for t in (v, k))
    pm = p * torch.einsum("bhqd,bhkd->bhqk", do.float().abs(), ve)
    dq = DQ_NOISE_ULPS * kw["scale"] * torch.einsum("bhqk,bhkd->bhqd", pm,
                                                      ke)
    dk = DQ_NOISE_ULPS * kw["scale"] * torch.einsum("bhqk,bhqd->bhkd", pm,
                                                      q.float().abs())
    return dq, dk.reshape(b, g, group, n_k, d).sum(dim=2)


def _check_flash(torch, q, k, v, do, lens, causal, window, label, seg=None,
                 cancel_noise=False):
    """B3, B4 and B5 against their plain versions on the same tensors, with
    segment ids ``seg`` (B, N) for both q and kv when given; for bf16, B3's
    o, B4's dq and B5's dk, dv also against the tensor-core oracles
    (:func:`_oracle_close`).  Masked queries (by length or padding id) must
    read o = 0 and lse = NEG_INF and get dq = 0, masked keys dk = dv = 0,
    exactly.  ``cancel_noise``: dq and dk may also differ by the f32 noise
    of their cancelled sums (:func:`_cancel_noise`), for f32 cases whose
    gradients are 0 by cancellation.  Returns the max |kernel - plain| of
    each, keyed by wrapper name, and under "oracle_*" the worst oracle
    error as a fraction of its bar."""
    import math

    from repro_torch.core.scan_attention import NEG_INF
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dtype = str(q.dtype).split(".")[-1]
    b, h, n_q, d = q.shape
    n_k = k.shape[2]
    ql = fa._lens(lens, b, n_q, q.device)
    kl = fa._lens(lens, b, n_k, q.device)
    kw = dict(causal=causal, window=window, scale=1.0 / math.sqrt(d))
    o, lse = fa.flash_attention(q, k, v, q_lens=lens, kv_lens=lens,
                                q_segment_ids=seg, kv_segment_ids=seg,
                                return_residuals=True, **kw)
    kw.update(q_seg=seg, kv_seg=seg)
    o_p, lse_p = fa.flash_attention_plain(q, k, v, ql, kl, **kw)
    torch.cuda.synchronize()
    tol = FLASH_FWD_TOL[dtype]
    _require(bool(o.float().isfinite().all()), f"{label}: o not finite")
    torch.testing.assert_close(o.float(), o_p.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"{label} o: {m}")
    torch.testing.assert_close(lse, lse_p, rtol=2e-5, atol=2e-5,
                               msg=lambda m: f"{label} lse: {m}")
    dead = torch.arange(n_q, device=q.device)[None, :] >= ql[:, None]
    dead_k = torch.arange(n_k, device=q.device)[None, :] >= kl[:, None]
    if seg is not None:
        dead, dead_k = dead | (seg == 0), dead_k | (seg == 0)
    _require(bool((o.float()[dead[:, None].expand(b, h, n_q)] == 0).all()
                  and (lse[dead[:, None].expand(b, h, n_q)]
                       == NEG_INF).all()),
             f"{label}: a masked query does not read o = 0, lse = NEG_INF")
    errs = {"flash_attention": (o.float() - o_p.float()).abs().max().item()}
    tc = q.dtype == torch.bfloat16
    if tc:
        o_tc, lse_tc = ref.flash_attention_tc_oracle(q, k, v, ql, kl, **kw)
        _require(torch.equal(lse_tc, lse_p), f"{label}: the oracle's lse "
                 "differs from the plain version's")
        errs["oracle_flash_attention"] = _oracle_close(
            torch, o, o_tc, f"{label} o (tensor-core oracle)")

    delta = (do.float() * o_p.float()).sum(dim=-1).contiguous()
    args = (q, k, v, do, lse_p, delta, ql, kl)
    dq = fa.flash_bwd_dq(*args, **kw)
    dk, dv = fa.flash_bwd_dkv(*args, **kw)
    dq_p = fa.flash_bwd_dq_plain(*args, **kw)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(*args, **kw)
    torch.cuda.synchronize()
    rtol = FLASH_GRAD_TOL[dtype]
    noise = _cancel_noise(torch, args, kw) if cancel_noise or tc else None
    dq_noise, dk_noise = noise if cancel_noise else (None, None)
    errs["flash_bwd_dq"] = _grad_close(dq, dq_p, rtol, f"{label} dq",
                                       dq_noise)
    errs["flash_bwd_dkv"] = max(
        _grad_close(dk, dk_p, rtol, f"{label} dk", dk_noise),
        _grad_close(dv, dv_p, rtol, f"{label} dv"))
    dead_k = dead_k[:, None].expand(b, k.shape[1], n_k)
    _require(bool((dq[dead[:, None].expand(b, h, n_q)] == 0).all()
                  and (dk[dead_k] == 0).all() and (dv[dead_k] == 0).all()),
             f"{label}: a masked query or key has a nonzero gradient")
    oracle = ""
    if tc:
        errs["oracle_flash_bwd_dq"] = _oracle_close(
            torch, dq, ref.flash_bwd_dq_tc_oracle(*args, **kw,
                                                  sums=torch.float64),
            f"{label} dq (tensor-core oracle, f64 sums)",
            noise=noise[0])
        dk_tc, dv_tc = ref.flash_bwd_dkv_tc_oracle(*args, **kw)
        errs["oracle_flash_bwd_dkv"] = max(
            _oracle_close(torch, dk, dk_tc, f"{label} dk (tensor-core "
                          "oracle)"),
            _oracle_close(torch, dv, dv_tc, f"{label} dv (tensor-core "
                          "oracle)"))
        oracle = (f"; |kernel - tensor-core oracle| at most "
                  f"{errs['oracle_flash_attention']:.2f} (B3), "
                  f"{errs['oracle_flash_bwd_dq']:.2f} (B4) and "
                  f"{errs['oracle_flash_bwd_dkv']:.2f} (B5) of the bar")
    ids = "" if seg is None else ", segment ids"
    print(f"  {label}: B={b} H={h} G={k.shape[1]} N={n_q} d={d} {dtype}"
          f"{ids}: max|kernel - plain| B3 {errs['flash_attention']:.3e}, B4 "
          f"{errs['flash_bwd_dq']:.3e}, B5 {errs['flash_bwd_dkv']:.3e}"
          f"{oracle}")
    return errs


def phase3_flash_kernels(torch, np) -> dict:
    """B3, B4 and B5 against their plain versions on edge shapes.  Returns
    {wrapper name: max |kernel - plain|}."""
    errs = {"flash_attention": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
            "oracle_flash_attention": 0.0, "oracle_flash_bwd_dq": 0.0,
            "oracle_flash_bwd_dkv": 0.0}
    for i, (label, (b, h, g, n, d), dtype, causal, window,
            lens) in enumerate(FLASH_CASES):
        q, k, v, do = _flash_inputs(torch, np, b, h, g, n, d, dtype,
                                    seed=300 + i)
        lens_t = (None if lens is None else
                  torch.tensor(lens, dtype=torch.int32, device="cuda"))
        got = _check_flash(torch, q, k, v, do, lens_t, causal, window, label)
        errs = {key: max(errs[key], got.get(key, 0.0))
                for key in errs}
    return errs


def _doc_spans(np, n, seed, tail=0):
    """Contiguous documents of 1 to n/3 tokens filling [0, n - tail), ids
    counting up from 1: (id, start, stop) triples."""
    rng = np.random.default_rng(seed)
    spans, a = [], 0
    while a < n - tail:
        c = min(n - tail, a + int(rng.integers(1, max(2, n // 3))))
        spans.append((len(spans) + 1, a, c))
        a = c
    return spans


# label, (B, H, G, N, d), dtype, window, per-row lengths (q and kv), and the
# documents of each row as (id, start, stop); the rest of a row is padding.
SEG_FLASH_CASES = [
    ("single-token documents, an all-padding row", (2, 2, 2, 70, 32),
     "float32", None, None,
     lambda np: [[(i + 1, i, i + 1) for i in range(70)], []]),
    ("a document straddling 64-row tiles, padding tail", (2, 4, 4, 200, 96),
     "float32", None, None,
     lambda np: [[(1, 0, 50), (2, 50, 130), (3, 130, 180)], [(1, 0, 200)]]),
    ("reused non-monotone ids, q/kv lengths", (2, 4, 2, 300, 64), "float32",
     None, (250, 300),
     lambda np: [[(2, 0, 60), (1, 60, 140), (2, 140, 200), (5, 200, 300)],
                 [(7, 0, 100), (3, 100, 300)]]),
    ("window 48, GQA 8:2, packed", (2, 8, 2, 333, 96), "float32", 48, None,
     lambda np: [_doc_spans(np, 333, 1, tail=20), _doc_spans(np, 333, 2)]),
    ("d = 256 (32-row kv tiles), GQA 2:1, packed, lengths",
     (2, 2, 1, 257, 256), "float32", None, (257, 200),
     lambda np: [_doc_spans(np, 257, 3, tail=9), _doc_spans(np, 257, 4)]),
    ("d = 32, N = 1, an all-padding row", (2, 2, 2, 1, 32), "float32", None,
     None, lambda np: [[(1, 0, 1)], []]),
    ("N = 1000, GQA 4:2, packed, padding tail", (2, 4, 2, 1000, 96),
     "float32", None, None,
     lambda np: [_doc_spans(np, 1000, 5, tail=77), _doc_spans(np, 1000, 6)]),
    ("bf16, N = 1024, packed", (1, 8, 8, 1024, 96), "bfloat16", None, None,
     lambda np: [_doc_spans(np, 1024, 7, tail=100)]),
    ("bf16, d = 256, window 32, reused ids", (1, 2, 2, 129, 256),
     "bfloat16", 32, None,
     lambda np: [[(3, 0, 40), (1, 40, 90), (3, 90, 129)]]),
    ("bf16, single-token documents, lengths, an all-padding row",
     (2, 2, 2, 33, 32), "bfloat16", None, (33, 10),
     lambda np: [[(i + 1, i, i + 1) for i in range(33)], []]),
]
SEG_FLASH_CASES += [(f"{c[0]} (bf16)", c[1], "bfloat16", *c[3:])
                    for c in SEG_FLASH_CASES if c[2] == "float32"]
# Unsegmented cases (FLASH_CASES labels) rerun with all-ones ids, which
# must give the unsegmented kernels' outputs bit for bit.
ONES_CASES = ("N = 1000, GQA 4:2, ragged", "d = 256, ragged, GQA 2:1",
              "bf16, GQA 8:2, ragged", "bf16, d = 256, window 32",
              "N = 1000, GQA 4:2, ragged (bf16)",
              "d = 130, window 16 (bf16)", "GQA 8:1, window 64 (bf16)")


def _span_ids(torch, b, n, rows):
    seg = torch.zeros((b, n), dtype=torch.int32)
    for r, spans in enumerate(rows):
        for sid, a, c in spans:
            seg[r, a:c] = sid
    return seg.cuda()


def _flash_kernel_outputs(torch, q, k, v, do, lens, causal, window, seg):
    """(o, lse, dq, dk, dv) from the three kernels alone."""
    import math

    from repro_torch.kernels import flash_attention as fa

    b, _, n_q, d = q.shape
    kw = dict(causal=causal, window=window, scale=1.0 / math.sqrt(d))
    o, lse = fa.flash_attention(q, k, v, q_lens=lens, kv_lens=lens,
                                q_segment_ids=seg, kv_segment_ids=seg,
                                return_residuals=True, **kw)
    delta = (do.float() * o.float()).sum(dim=-1).contiguous()
    args = (q, k, v, do, lse, delta, fa._lens(lens, b, n_q, q.device),
            fa._lens(lens, b, k.shape[2], q.device))
    kw.update(q_seg=seg, kv_seg=seg)
    return (o, lse, fa.flash_bwd_dq(*args, **kw),
            *fa.flash_bwd_dkv(*args, **kw))


def phase3_segmented_flash_kernels(torch, np) -> dict:
    """The segmented B3, B4 and B5 against their plain versions on packed
    edge cases, and all-ones ids against no ids, bit for bit.  Returns
    {wrapper name: max |kernel - plain|}."""
    errs = {"flash_attention": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
            "oracle_flash_attention": 0.0, "oracle_flash_bwd_dq": 0.0,
            "oracle_flash_bwd_dkv": 0.0}
    for i, (label, (b, h, g, n, d), dtype, window, lens,
            rows) in enumerate(SEG_FLASH_CASES):
        q, k, v, do = _flash_inputs(torch, np, b, h, g, n, d, dtype,
                                    seed=500 + i)
        lens_t = (None if lens is None else
                  torch.tensor(lens, dtype=torch.int32, device="cuda"))
        seg = _span_ids(torch, b, n, rows(np))
        got = _check_flash(torch, q, k, v, do, lens_t, True, window, label,
                           seg=seg)
        errs = {key: max(errs[key], got.get(key, 0.0))
                for key in errs}
    cases = {c[0]: c for c in FLASH_CASES}
    for i, label in enumerate(ONES_CASES):
        _, (b, h, g, n, d), dtype, causal, window, lens = cases[label]
        q, k, v, do = _flash_inputs(torch, np, b, h, g, n, d, dtype,
                                    seed=600 + i)
        lens_t = (None if lens is None else
                  torch.tensor(lens, dtype=torch.int32, device="cuda"))
        ones = torch.ones((b, n), dtype=torch.int32, device="cuda")
        with_ids = _flash_kernel_outputs(torch, q, k, v, do, lens_t, causal,
                                         window, ones)
        without = _flash_kernel_outputs(torch, q, k, v, do, lens_t, causal,
                                        window, None)
        for name, a, c in zip(("o", "lse", "dq", "dk", "dv"), with_ids,
                              without):
            _require(torch.equal(a, c), f"{label}: all-ones ids change {name}"
                     f" by {(a.float() - c.float()).abs().max().item():.3e}")
    print("  segmented B3, B4 and B5: all-ones ids give bit-identical "
          f"outputs to no ids on {len(ONES_CASES)} cases")
    return errs


def _causal_pairs(n_q, n_k, lens, causal, window, seg=None) -> int:
    """Live (query, key) pairs of one head, summed over the batch rows:
    what this run's masks leave, the segment ids ``seg`` (B, N) included."""
    import numpy as np

    i = np.arange(n_q)[:, None]
    j = np.arange(n_k)[None, :]
    base = np.ones((n_q, n_k), bool)
    if causal:
        base &= j <= i
    if window is not None:
        base &= j > i - window
    total = 0
    for r, ln in enumerate(lens):
        live = base & (i < ln) & (j < ln)
        if seg is not None:
            sq, sk = seg[r, :n_q, None], seg[r, None, :n_k]
            live &= (sq == sk) & (sq != 0)
        total += int(live.sum())
    return total


def _flash_bounds(torch, q, k, lens, causal, window, seg=None):
    """(bound row of B3, of B4, of B5): each input read once, each output
    written once (segment ids, when given, 4 bytes a token for q and for
    kv); the products on the live pairs of this run's masks (4, 6 and 8
    flops a pair and element of d) at the card's peak rate for the input
    type: the bf16 tensor cores for bf16 inputs, f32 outside the tensor
    cores for f32 inputs.  The f32 SIMT bound (the rate of the f32 kernels
    and of B4) stands beside it."""
    b, h, n_q, d = q.shape
    g, n_k = k.shape[1], k.shape[2]
    lens = [n_q] * b if lens is None else [int(x) for x in lens.tolist()]
    pairs = h * _causal_pairs(n_q, n_k, lens, causal, window,
                              None if seg is None else seg.cpu().numpy())
    e = q.element_size()
    qb, kb = b * h * n_q * d * e, b * g * n_k * d * e
    rows = 4 * b * h * n_q
    ids = 0 if seg is None else 4 * b * (n_q + n_k)
    nbytes = {"flash_attention": 2 * qb + 2 * kb + rows + ids,
              "flash_bwd_dq": 3 * qb + 2 * kb + 2 * rows + ids,
              "flash_bwd_dkv": 2 * qb + 4 * kb + 2 * rows + ids}
    flops = {"flash_attention": 4 * pairs * d, "flash_bwd_dq": 6 * pairs * d,
             "flash_bwd_dkv": 8 * pairs * d}
    rate = BF16_DENSE_FLOPS if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    out = {}
    for name in nbytes:
        bound_ms, bound_by = _bound(nbytes[name], flops[name], rate)
        out[name] = {"bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": nbytes[name], "flops": flops[name],
                     "pairs": pairs,
                     "rate": rate,
                     "f32_simt_bound_ms": _bound(nbytes[name],
                                                 flops[name])[0]}
    return out


def flash_kernel_times(torch, q, k, v, do, lens, causal, window, card,
                       n_iter=10, plain_iter=3, seg=None):
    """B3, B4 and B5 at the given (main-path) inputs, with segment ids
    ``seg`` when given: device time in a replayed CUDA graph, eager call,
    plain version, bound, and the ``scaled_dot_product_attention``
    yardstick (forward for B3, its backward for B4 + B5 together; with ids
    or a window, under the block-diagonal or banded causal boolean mask;
    with fewer kv heads, ``enable_gqa``; timed here, never called by the
    port).  Returns {wrapper name: row}."""
    import math

    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    b, _, n_q, d = q.shape
    n_k = k.shape[2]
    kw = dict(causal=causal, window=window, scale=1.0 / math.sqrt(d))
    ql = fa._lens(lens, b, n_q, q.device)
    kl = fa._lens(lens, b, n_k, q.device)
    ids = dict(q_segment_ids=seg, kv_segment_ids=seg)
    o, lse = fa.flash_attention(q, k, v, q_lens=lens, kv_lens=lens,
                                return_residuals=True, **ids, **kw)
    delta = (do.float() * o.float()).sum(dim=-1).contiguous()
    args = (q, k, v, do, lse, delta, ql, kl)
    fwd_kw = dict(kw)
    kw.update(q_seg=seg, kv_seg=seg)
    calls = {
        "flash_attention": (
            lambda: fa.flash_attention(q, k, v, q_lens=lens, kv_lens=lens,
                                       return_residuals=True, **ids,
                                       **fwd_kw),
            lambda: fa.flash_attention_plain(q, k, v, ql, kl, **kw)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*args, **kw),
                         lambda: fa.flash_bwd_dq_plain(*args, **kw)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*args, **kw),
                          lambda: fa.flash_bwd_dkv_plain(*args, **kw)),
    }
    library = {"flash_attention": None, "flash_bwd_dq": None,
               "flash_bwd_dkv": None}
    if lens is None and causal:
        qs, ks, vs = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        sdpa = dict(is_causal=True)
        if seg is not None or window is not None:
            # A boolean mask: the causal band (of ``window`` keys), within
            # one document when ``seg`` is given.
            pos = torch.arange(n_q, device=q.device)
            allowed = pos[None, :] <= pos[:, None]
            if window is not None:
                allowed = allowed & (pos[None, :] > pos[:, None] - window)
            allowed = allowed[None]
            if seg is not None:
                allowed = allowed & (seg[:, :, None] == seg[:, None, :]) & (
                    seg[:, :, None] != 0)
            sdpa = dict(attn_mask=allowed[:, None])
        if q.shape[1] != k.shape[1]:
            sdpa["enable_gqa"] = True
        fwd_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, **sdpa), n_iter)
        out = F.scaled_dot_product_attention(qs, ks, vs, **sdpa)
        bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(
            out, (qs, ks, vs), do, retain_graph=True), n_iter)
        library = {"flash_attention": fwd_ms, "flash_bwd_dq": bwd_ms,
                   "flash_bwd_dkv": bwd_ms}
    bounds = _flash_bounds(torch, q, k, lens, causal, window, seg)
    rows = {}
    for name, (kernel, plain) in calls.items():
        ms, call_ms, plain_ms, plain_call_ms = _kernel_times(
            torch, kernel, plain, n_iter, plain_iter)
        bd = bounds[name]
        tflops = bd["flops"] / (ms * 1e-3) / 1e12
        rows[name] = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                      "plain_call_ms": plain_call_ms,
                      "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
                      "library_ms": library[name], "tflops": tflops,
                      "f32_simt_bound_ms": bd["f32_simt_bound_ms"]}
        lib = ("none" if library[name] is None
               else f"{library[name] * 1e3:.2f} us")
        form = "" if seg is None else "segmented "
        before = BEFORE_US.get((name, "train" if seg is None
                                else "train_packed"))
        before = "" if before is None else f"; before {before} us"
        print(f"  {form}{name} at B={b} H={q.shape[1]} G={k.shape[1]} N={n_q} "
              f"d={d} {str(q.dtype).split('.')[-1]}: device {ms * 1e3:.2f} "
              f"us (eager call {call_ms * 1e3:.2f} us{before}), plain device "
              f"{plain_ms * 1e3:.2f} us (eager call {plain_call_ms * 1e3:.2f}"
              f" us), bound {bd['bound_ms'] * 1e3:.2f} us by "
              f"{bd['bound_by']} ({bd['bytes']} B, {bd['flops']} flop on "
              f"{bd['pairs']} live pairs at "
              f"{bd['rate'] / 1e12:.0f} TFLOP/s; "
              f"{bd['f32_simt_bound_ms'] * 1e3:.2f} us at the f32 SIMT "
              f"rate), {ms / bd['bound_ms']:.2f}x the bound, {tflops:.1f} "
              f"TFLOP/s achieved; SDPA {lib}  [{card}]")
    return rows


def phase3_small_model(torch, np) -> None:
    """A small f32 model on the card (kernels) against the CPU (plain
    versions): greedy serving tokens, loss and gradients, three steps."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.synthetic import SyntheticLMIterator
    from repro_torch.kernels.aaren_scan import aaren_scan
    from repro_torch.kernels.aaren_scan_bwd import aaren_scan_bwd
    from repro_torch.models.factory import build
    from repro_torch.serving.engine import StreamingEngine
    from repro_torch.train.optim import make_optimizer, warmup_cosine
    from repro_torch.train.state import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    small = build(smoke_config(ARCH))
    cpu_params = small.init(0, device="cpu")
    prompts = [np.random.default_rng(100 + i).integers(0, small.cfg.vocab, n)
               for i, n in enumerate([3, 9, 1, 6, 12, 5])]
    outs = {}
    for dev, params in (("cpu", cpu_params), ("cuda", _to(cpu_params,
                                                          "cuda"))):
        eng = StreamingEngine(small, params, n_slots=4, chunk=4)
        rids = [eng.submit(p, 6) for p in prompts]
        res = eng.run()
        outs[dev] = [res[r] for r in rids]
    _require(outs["cpu"] == outs["cuda"], f"small model: card tokens "
             f"{outs['cuda']} != CPU tokens {outs['cpu']}")
    print(f"  small f32 model: greedy tokens on the card == on the CPU "
          f"({sum(map(len, outs['cpu']))} tokens)")

    data = SyntheticLMIterator(vocab=small.cfg.vocab, seq_len=32, batch=4)
    batches = [next(data) for _ in range(3)]
    grads, losses = {}, {}
    launches = (aaren_scan.n_launches, aaren_scan_bwd.n_launches)
    for dev in ("cpu", "cuda"):
        params = _to(cpu_params, dev)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()}
        loss, _ = small.loss(params, batch)
        grads[dev] = torch.autograd.grad(loss, leaves)
        losses[dev] = [loss.item()]
        opt = make_optimizer("adamw", warmup_cosine(3e-3, 1, 3))
        state = init_train_state(params, opt)
        step = make_train_step(small.loss, opt)
        for b in batches:
            state, metrics = step(state, b)
            losses[dev].append(metrics["loss"].item())
    _require(aaren_scan.n_launches > launches[0]
             and aaren_scan_bwd.n_launches > launches[1],
             "small model: the card path launched no scan kernel")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
    _require(rel[0] <= 1e-5, f"small model: loss on the card {losses['cuda']}"
             f" != on the CPU {losses['cpu']}")
    gerr = 0.0
    for a, b in zip(grads["cuda"], grads["cpu"]):
        scale = max(b.abs().max().item(), 1e-6)
        err = ((a.cpu() - b).abs().max().item()) / scale
        _require(err <= TOL["rtol"], f"small model: a gradient differs by "
                 f"{err:.3e} of its max between the card and the CPU")
        gerr = max(gerr, err)
    _require(max(rel[1:]) <= 1e-4, f"small model: train-step losses on the "
             f"card {losses['cuda'][1:]} != on the CPU {losses['cpu'][1:]}")
    print(f"  small f32 model: loss |card - CPU| / CPU = {rel[0]:.2e}; "
          f"{len(grads['cpu'])} gradients within {gerr:.2e} of max |CPU|; "
          f"3 train-step losses within {max(rel[1:]):.2e} relative")


def phase3_small_softmax(torch, np) -> None:
    """The small f32 softmax model on the card (flash kernels) against the
    CPU (plain versions): greedy tokens of ``generate`` (plain and ragged
    prompts), loss and every gradient, three train steps."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.synthetic import SyntheticLMIterator
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.factory import build
    from repro_torch.serving.engine import generate
    from repro_torch.train.optim import make_optimizer, warmup_cosine
    from repro_torch.train.state import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    small = build(smoke_config(ARCH, attn_mode="softmax", n_kv_heads=2))
    cpu_params = small.init(0, device="cpu")
    prompts = np.random.default_rng(110).integers(0, small.cfg.vocab, (3, 9))
    lens = [9, 4, 1]
    outs = {}
    launches = fa.flash_attention.n_launches
    for dev, params in (("cpu", cpu_params), ("cuda", _to(cpu_params,
                                                          "cuda"))):
        plain, _ = generate(small, params, prompts, 6)
        ragged, _ = generate(small, params, prompts, 6, prompt_lengths=lens)
        outs[dev] = (plain.tolist(), ragged.tolist())
    _require(fa.flash_attention.n_launches > launches,
             "small softmax model: the card path launched no B3")
    _require(outs["cpu"] == outs["cuda"], f"small softmax model: card "
             f"tokens {outs['cuda']} != CPU tokens {outs['cpu']}")
    print("  small f32 softmax model: greedy tokens on the card == on the "
          "CPU (plain and ragged prompts, 36 tokens)")

    data = SyntheticLMIterator(vocab=small.cfg.vocab, seq_len=32, batch=4)
    batches = [next(data) for _ in range(3)]
    grads, losses = {}, {}
    launches = (fa.flash_bwd_dq.n_launches, fa.flash_bwd_dkv.n_launches)
    for dev in ("cpu", "cuda"):
        params = _to(cpu_params, dev)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()}
        loss, _ = small.loss(params, batch)
        grads[dev] = torch.autograd.grad(loss, leaves)
        losses[dev] = [loss.item()]
        opt = make_optimizer("adamw", warmup_cosine(3e-3, 1, 3))
        state = init_train_state(params, opt)
        step = make_train_step(small.loss, opt)
        for b in batches:
            state, metrics = step(state, b)
            losses[dev].append(metrics["loss"].item())
    _require(fa.flash_bwd_dq.n_launches > launches[0]
             and fa.flash_bwd_dkv.n_launches > launches[1],
             "small softmax model: the card path launched no B4 or B5")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
    _require(rel[0] <= 1e-5, f"small softmax model: loss on the card "
             f"{losses['cuda']} != on the CPU {losses['cpu']}")
    gerr = 0.0
    for a, b in zip(grads["cuda"], grads["cpu"]):
        scale = b.abs().max().item()
        err = (a.cpu() - b).abs().max().item()
        _require(err <= TOL["rtol"] * scale + 1e-6, f"small softmax model: "
                 f"a gradient differs by {err:.3e} (max |CPU| {scale:.3e})")
        gerr = max(gerr, err / max(scale, 1e-6))
    _require(max(rel[1:]) <= 1e-4, f"small softmax model: train-step losses "
             f"on the card {losses['cuda'][1:]} != on the CPU "
             f"{losses['cpu'][1:]}")
    print(f"  small f32 softmax model: loss |card - CPU| / CPU = "
          f"{rel[0]:.2e}; {len(grads['cpu'])} gradients within {gerr:.2e} "
          f"of max |CPU|; 3 train-step losses within {max(rel[1:]):.2e} "
          "relative")


# Per mixer: the small model's keyword arguments, its documents (lengths,
# numpy seed) and the row length they are packed into.  The softmax rows of
# 96 hold a 70-token document and a 50 + 33 pair, so documents straddle the
# flash kernels' 64-row tiles.
SMALL_PACKED = {
    "aaren": ({}, (30, 12, 1, 9, 6, 20, 5, 33), 120, 48),
    "softmax": ({"attn_mode": "softmax", "n_kv_heads": 2},
                (70, 20, 50, 33, 9, 1, 40), 121, 96),
}


def phase3_small_packed(torch, np, mode: str = "aaren") -> None:
    """The small f32 model of ``mode`` (Aaren or softmax) on packed
    documents: loss and every gradient on the card (segmented kernels)
    against the CPU (plain versions), and the packed loss against
    per-document evaluation."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.packing import pack_documents
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.aaren_scan import aaren_scan
    from repro_torch.kernels.aaren_scan_bwd import aaren_scan_bwd
    from repro_torch.models.factory import build
    from repro_torch.tree import tree_leaves

    kw, lens, seed, seq_len = SMALL_PACKED[mode]
    small = build(smoke_config(ARCH, **kw))
    cpu_params = small.init(0, device="cpu")
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, small.cfg.vocab, n) for n in lens]
    packed = pack_documents(docs, seq_len)
    wrappers = ((aaren_scan, aaren_scan_bwd) if mode == "aaren" else
                (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv))
    # The softmax gradients take tests/test_torch_flash.py's 1e-6 floor.
    floor = 0.0 if mode == "aaren" else 1e-6
    losses, grads = {}, {}
    launches = [w.n_launches for w in wrappers]
    for dev in ("cpu", "cuda"):
        params = _to(cpu_params, dev)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in packed.items()}
        loss, _ = small.loss(params, batch)
        grads[dev] = torch.autograd.grad(loss, leaves)
        losses[dev] = loss.item()
    _require(all(w.n_launches > n for w, n in zip(wrappers, launches)),
             f"small packed {mode} model: the card path skipped a kernel")
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    _require(rel <= 1e-5, f"small packed {mode} model: loss on the card "
             f"{losses['cuda']} != on the CPU {losses['cpu']}")
    gerr = 0.0
    for a, b in zip(grads["cuda"], grads["cpu"]):
        scale = b.abs().max().item()
        err = (a.cpu() - b).abs().max().item()
        _require(err <= TOL["rtol"] * max(scale, 1e-6) + floor,
                 f"small packed {mode} model: a gradient differs by "
                 f"{err:.3e} (max |CPU| {scale:.3e}) between card and CPU")
        gerr = max(gerr, err / max(scale, 1e-6))
    card_params = _to(cpu_params, "cuda")
    total = count = 0
    with torch.no_grad():
        for doc in docs:
            if doc.size < 2:     # no next-token target
                continue
            loss, _ = small.loss(card_params,
                                 {"tokens": torch.from_numpy(doc[None]).cuda()})
            total += loss.item() * (doc.size - 1)
            count += doc.size - 1
    per_doc = total / count
    _require(abs(losses["cuda"] - per_doc) <= 1e-5, f"small packed {mode} "
             f"model: packed loss {losses['cuda']} != per-document {per_doc}")
    print(f"  small f32 packed {mode} model ({len(docs)} documents in "
          f"{packed['tokens'].shape[0]} rows of {seq_len}): loss |card - CPU|"
          f" / CPU = {rel:.2e}, |card - per-document| = "
          f"{abs(losses['cuda'] - per_doc):.2e}; {len(grads['cpu'])} "
          f"gradients within {gerr:.2e} of max |CPU|")


def phase4_serving(torch, np, card: str):
    """Full-width serving, with no metrics registry or event sink installed.
    Returns (B1 launches, B1 row of the kernels' JSON at the serving shape,
    max |err| over captured inputs, {"tokens": each request's tokens,
    "tick_ms": the tick median, "requests": the prompts, "model": (api,
    params), which phase 4k serves})."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.aaren_scan import aaren_scan, aaren_scan_plain
    from repro_torch.models.factory import build
    from repro_torch.models.lm import lm_state_init
    from repro_torch.models.param import count_params
    from repro_torch.serving.engine import (
        StreamingEngine,
        decode_state_bytes,
        generate,
    )
    from repro_torch.serving.sampler import greedy_sampler

    cfg = get_config(ARCH)
    api = build(cfg)
    ti = time.perf_counter()
    params = api.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = count_params(api.specs())
    print(f"  init {time.perf_counter() - ti:.2f} s: {n_params / 1e9:.3f} B "
          f"params, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on card")

    rng = np.random.default_rng(0)
    lens = rng.integers(32, 257, REQUESTS)
    reqs = [rng.integers(0, cfg.vocab, n) for n in lens]

    from repro_torch.obs import events as obs_events
    from repro_torch.obs import metrics as obs_metrics

    _require(obs_metrics.current() is None and obs_events.current() is None,
             "phase 4 must run with no registry or sink installed")
    # Capture the scan inputs of one real serving tick (not counted).
    captured = []
    real_scan = ops.aaren_scan

    def capture(*args, **kw):
        captured.append([a.clone() for a in args])
        return real_scan(*args, **kw)

    cap = StreamingEngine(api, params, n_slots=SLOTS, chunk=CHUNK)
    for p in reqs[:SLOTS]:
        cap.submit(p, MAX_NEW)
    ops.aaren_scan = capture
    try:
        cap.step()
    finally:
        ops.aaren_scan = real_scan
    _require(len(captured) == cfg.n_layers,
             f"captured {len(captured)} scans, want {cfg.n_layers}")
    err = 0.0
    for layer in (0, cfg.n_layers - 1):
        err = max(err, _compare_scan(torch, captured[layer],
                                     f"serving tick, layer {layer}"))
    del cap

    finite = {"ok": True}

    class CheckedEngine(StreamingEngine):
        def _advance(self, tokens, lengths):
            last, states = super()._advance(tokens, lengths)
            finite["ok"] &= bool(torch.isfinite(last).all())  # syncs
            return last, states

    def checked_greedy(logits, seeds):
        finite["ok"] &= bool(torch.isfinite(logits).all())
        return greedy_sampler(logits, seeds)

    checked_greedy.batched = True
    checked_greedy.uses_seeds = False

    eng = CheckedEngine(api, params, n_slots=SLOTS, chunk=CHUNK)
    print(f"  engine warm-up {eng.warmup():.2f} s")
    gen_prompts = rng.integers(0, cfg.vocab, (GEN_B, GEN_P))

    # The main path: counts from zero, read right after.
    aaren_scan.n_launches = 0
    rids = [eng.submit(p, MAX_NEW) for p in reqs]
    tick_s, ticks = [], 0
    ts = time.perf_counter()
    while eng.queue or any(s is not None for s in eng.active):
        t1 = time.perf_counter()
        eng.step()
        tick_s.append(time.perf_counter() - t1)
        ticks += 1
    serve_s = time.perf_counter() - ts
    tg = time.perf_counter()
    gen_toks, gen_states = generate(api, params, gen_prompts, GEN_NEW,
                                    sampler=checked_greedy)
    gen_s = time.perf_counter() - tg
    launches = aaren_scan.n_launches

    served = sum(len(eng.finished[r]) for r in rids)
    _require(all(len(eng.finished[r]) == MAX_NEW for r in rids),
             "a request did not return max_new tokens")
    _require(tuple(gen_toks.shape) == (GEN_B, GEN_NEW),
             f"generate returned {tuple(gen_toks.shape)}")
    _require(finite["ok"], "non-finite logits on the main path")
    want = cfg.n_layers * (ticks + 1)   # every tick + one generate prefill
    _require(launches == want, f"B1 launched {launches} times, want {want}")
    init = lm_state_init(cfg, SLOTS, device="cuda")
    _require(all(torch.equal(a, b) for sa, sb in zip(eng.states, init)
                 for a, b in zip(sa, sb)), "a free slot's carry is not init")
    tick_ms = statistics.median(tick_s) * 1e3
    print(f"  served {len(rids)} requests / {served} tokens in {ticks} ticks,"
          f" {serve_s:.3f} s: tick median {tick_ms:.3f} ms, "
          f"{served / serve_s:.1f} tok/s  [{card}]")
    print(f"  generate B={GEN_B} P={GEN_P} new={GEN_NEW}: {gen_s:.3f} s; "
          f"decode state {decode_state_bytes(gen_states)} B  [{card}]")
    print(f"  B1 launches on the serving path: {launches} = {cfg.n_layers} x"
          f" ({ticks} ticks + 1 prefill)")

    # Where a tick's time goes (after the counts were read).
    for p in reqs[:SLOTS]:
        eng.submit(p, MAX_NEW)
    eng.step()
    _print_profile(_device_profile(torch, eng.step, 5), "tick (5 ticks)",
                   card)
    eng.run()

    # B1 at the serving shape: device time from a replayed CUDA graph, the
    # eager per-call time (wrapper included), the plain version, the bound.
    s, v, m0, u0, w0 = captured[0]
    r, n = s.shape
    d = v.shape[-1]
    kernel_ms, call_ms, plain_ms, plain_call_ms = _kernel_times(
        torch, lambda: aaren_scan(s, v, m0, u0, w0),
        lambda: aaren_scan_plain(s, v, m0, u0, w0), 200, 20)
    bound_ms, bound_by, nbytes = _b1_bound(r, n, d, residuals=False)
    print(f"  B1 at R={r} N={n} d={d}: device {kernel_ms * 1e3:.3f} us "
          f"(eager call {call_ms * 1e3:.2f} us; before "
          f"{BEFORE_US['aaren_scan', 'serve']} us), plain device "
          f"{plain_ms * 1e3:.2f} us (eager call {plain_call_ms * 1e3:.2f} "
          f"us), bound {bound_ms * 1e3:.3f} us by {bound_by} ({nbytes} B)"
          f"  [{card}]")
    row = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by}
    ref = {"tokens": [eng.finished[r] for r in rids], "tick_ms": tick_ms,
           "requests": reqs, "model": (api, params)}
    return launches, row, err, ref


class _PlainOnCard(Exception):
    """A plain version was reached with a CUDA tensor on a main path."""


def _forbid_plain_on_card():
    """Make the plain versions of B1–B5 raise on CUDA tensors until the
    returned undo is called: proof that a main path ran only kernels."""
    from repro_torch.kernels import aaren_scan as b1_mod
    from repro_torch.kernels import aaren_scan_bwd as b2_mod
    from repro_torch.kernels import flash_attention as fa

    plains = [(b1_mod, "aaren_scan_plain"), (b2_mod, "aaren_scan_bwd_plain"),
              (fa, "flash_attention_plain"), (fa, "flash_bwd_dq_plain"),
              (fa, "flash_bwd_dkv_plain")]
    saved = [getattr(mod, name) for mod, name in plains]

    def guard(fn):
        def wrapped(x, *args, **kw):
            if x.is_cuda:
                raise _PlainOnCard(f"{fn.__name__} reached with a CUDA tensor")
            return fn(x, *args, **kw)
        return wrapped

    for (mod, name), fn in zip(plains, saved):
        setattr(mod, name, guard(fn))

    def undo():
        for (mod, name), fn in zip(plains, saved):
            setattr(mod, name, fn)
    return undo


TIER_REPLICAS, TIER_REQUESTS, TIER_PREFIX, TIER_NEW = 2, 32, 256, 32
TIER_EVENT_TICK = 24     # drain / crash / poison before this tier tick
TIER_MAX_TICKS = 1000    # (a) takes ~100: a tier that never drains fails
SNAP_TICK = 20           # (f): the engine is saved after this many ticks
TEMP_B, TEMP_P, TEMP_NEW = 4, 128, 8
TIE_SPACINGS = 2.0       # a near tie: top-1 - top-2 <= 2 bf16 spacings


def _bf16_spacing(x: float) -> float:
    """The distance between bf16 neighbours at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def _tier_busy(router) -> bool:
    return bool(router.front) or any(
        router.alive[i] and (eng.queue
                             or any(s is not None for s in eng.active))
        for i, eng in enumerate(router.engines))


def phase4k_serving_tier(torch, np, card: str, cfg, model, ref: dict):
    """The serving tier at full width on phase 4's parameters: a
    ``ReplicatedRouter`` of 2 replicas x 8 slots (chunk 16, greedy) serving
    32 requests that share a 256-token system prefix, undisturbed (a), with
    a shared prefix cache (b), with a drain (c), a crash (d) and a poisoned
    slot (e) after 24 tier ticks; then an engine snapshot of phase 4's load
    saved and loaded mid-run (f), and batched temperature sampling against
    ``generate`` (g).  B1's launches are read around every run.  Returns
    the B1 launches of the phase."""
    from repro_torch.kernels.aaren_scan import aaren_scan
    from repro_torch.models.lm import lm_state_init
    from repro_torch.serving import (
        ERR_POISONED,
        PrefixCache,
        ReplicatedRouter,
        StreamingEngine,
        generate,
    )
    from repro_torch.serving.prefix_cache import carry_bytes
    from repro_torch.serving.sampler import (
        greedy_sampler,
        gumbel_noise,
        request_seed,
        temperature_sampler,
    )
    from repro_torch.testing import kill_router_replica, poison_engine_slot

    api, params = model
    t_phase = time.perf_counter()
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab, TIER_PREFIX)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab, n)])
               for n in rng.integers(16, 129, TIER_REQUESTS)]

    # Count the engine ticks that reach the model (a crashed replica's
    # step raises before), and each request's prefill ticks.
    lock = threading.Lock()
    stepped = {"ticks": 0, "prefill": {}}
    real_advance = StreamingEngine._advance

    def counting_advance(self, tokens, lengths):
        with lock:
            stepped["ticks"] += 1
            for s in self.active:
                if s is not None and s.pending is not None:
                    stepped["prefill"][s.request_id] = (
                        stepped["prefill"].get(s.request_id, 0) + 1)
        return real_advance(self, tokens, lengths)

    def zero_counts():
        aaren_scan.n_launches = 0
        stepped["ticks"] = 0
        stepped["prefill"] = {}

    def read_counts(what: str) -> int:
        torch.cuda.synchronize()
        launches, ticks = aaren_scan.n_launches, stepped["ticks"]
        _require(launches == cfg.n_layers * ticks,
                 f"{what}: B1 launched {launches} times over {ticks} "
                 f"engine ticks, want {cfg.n_layers} x {ticks}")
        return launches

    # (a)'s sampler: greedy, keeping each row's top-2 logits by seed.
    top2 = []

    def recording_greedy(logits, seeds):
        top2.append((seeds, torch.topk(logits[:, 0], 2, dim=-1).values))
        return greedy_sampler(logits, seeds)

    recording_greedy.batched = True

    def tier(label, sampler=greedy_sampler, cache=None, event=None,
             after=None, alive=TIER_REPLICAS, crashed=()):
        """Serve ``prompts`` on a fresh tier.  The router turns a replica's
        exception into a failover; every one is recorded, and a run fails
        unless exactly the replicas in ``crashed`` failed, each by the
        injected crash, and ``alive`` replicas remain."""
        router = ReplicatedRouter(
            api, params, n_replicas=TIER_REPLICAS, n_slots=SLOTS,
            chunk=CHUNK, sampler=sampler, prefix_cache=cache)
        router.warmup()
        failures = []
        real_failover = router._failover

        def failover(index, *, error):
            failures.append((index, f"{type(error).__name__}: {error}"))
            real_failover(index, error=error)

        router._failover = failover
        if cache is not None:
            cache.pin(prefix)
        zero_counts()     # the main path: counts from zero, read after
        rids = [router.submit(p, TIER_NEW) for p in prompts]
        tick_s, info = [], None
        t0 = time.perf_counter()
        while _tier_busy(router):
            _require(any(router.alive), f"({label}) every replica failed "
                     f"with requests outstanding: {failures}")
            _require(len(tick_s) < TIER_MAX_TICKS, f"({label}) not done "
                     f"after {TIER_MAX_TICKS} tier ticks")
            if event is not None and len(tick_s) == TIER_EVENT_TICK:
                info = event(router)
            t1 = time.perf_counter()
            router.step()
            tick_s.append(time.perf_counter() - t1)
            if after is not None and len(tick_s) == TIER_EVENT_TICK + 1:
                after(router, info)
        wall = time.perf_counter() - t0
        launches = read_counts(label)
        router.close()
        _require([i for i, _ in failures] == list(crashed) and all(
            "injected crash" in what for _, what in failures),
            f"({label}) replicas failed over: {failures}, want "
            f"{list(crashed)} by the injected crash")
        _require(sum(router.alive) == alive, f"({label}) "
                 f"{sum(router.alive)} replicas alive, want {alive}")
        _require(not crashed or router.stats()["failed_over"] > 0,
                 f"({label}) the crash failed over no request")
        _require(crashed or router.stats()["failed_over"] == 0,
                 f"({label}) {router.stats()} failed over with no crash")
        out = {"router": router, "launches": launches, "ticks": len(tick_s),
               "engine_ticks": stepped["ticks"],
               "prefill": dict(stepped["prefill"]),
               "tick_ms": statistics.median(tick_s) * 1e3, "wall": wall,
               "tokens": {r: router.finished.get(r) for r in rids},
               "info": info}
        served = sum(len(t) for t in out["tokens"].values() if t)
        print(f"  ({label}) {len(rids)} requests, {served} tokens in "
              f"{len(tick_s)} tier ticks ({stepped['ticks']} engine ticks, "
              f"{launches} B1 launches = {cfg.n_layers} x "
              f"{stepped['ticks']}), {wall:.3f} s: tick median "
              f"{out['tick_ms']:.3f} ms, {served / wall:.1f} tok/s  [{card}]")
        return out

    total = 0
    StreamingEngine._advance = counting_advance
    undo = _forbid_plain_on_card()
    try:
        # (a) Undisturbed: the reference tokens T0.
        a = tier("a, undisturbed", sampler=recording_greedy)
        t0_tokens = a["tokens"]
        _require(not a["router"].errors and all(
            t is not None and len(t) == TIER_NEW
            for t in t0_tokens.values()), "(a) lost or cut a request")
        total += a["launches"]
        margin = {}
        for seeds, vals in top2:
            for s, (v1, v2) in zip(seeds.tolist(), vals.tolist()):
                margin[s] = (v1, v2)

        def near_tie(rid: int, step: int) -> tuple[bool, str]:
            v1, v2 = margin[request_seed(0, rid, step)]
            sp = _bf16_spacing(v1)
            return (v1 - v2 <= TIE_SPACINGS * sp,
                    f"rid {rid} step {step}: top-1 {v1:.6f} - top-2 "
                    f"{v2:.6f} = {v1 - v2:.3e}, bf16 spacing {sp:.3e}")

        # (b) A prefix cache shared by the replicas, the prefix pinned.
        cache = PrefixCache(max_bytes=64 << 20)
        matched = {}
        real_lookup = cache.lookup

        def lookup(prompt):
            got = real_lookup(prompt)
            matched[np.asarray(prompt, np.int32).tobytes()] = got[0]
            return got

        cache.lookup = lookup
        b = tier("b, prefix cache", cache=cache)
        _require(b["tokens"] == t0_tokens,
                 "(b) prefix-cache tokens differ from (a)'s")
        total += b["launches"]
        st = cache.stats()
        hit = [r for r, p in enumerate(prompts)
               if matched[p.astype(np.int32).tobytes()]]
        miss = [r for r in range(TIER_REQUESTS) if r not in hit]
        key = next(k for k in cache._entries if k[0] == TIER_PREFIX)
        entry = carry_bytes(cache._entries[key].carry)
        kv = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.resolved_head_dim \
            * TIER_PREFIX * 2
        print(f"  (b) cache: {st['hits']} hits, {st['misses']} misses, "
              f"{st['prefill_tokens_saved']} prefill tokens saved "
              f"(predicted 24, 8, 4224), {st['entries']} entries, "
              f"{st['bytes']} B; tier ticks {b['ticks']} with the cache, "
              f"{a['ticks']} without")

        def mean(xs):
            return sum(xs) / len(xs) if xs else float("nan")

        hit_b = mean([b["prefill"][r] for r in hit])
        hit_a = mean([a["prefill"][r] for r in hit])
        miss_b = mean([b["prefill"][r] for r in miss])
        print(f"  (b) prefill ticks a request: hits {hit_b:.2f} (the same "
              f"requests cold in (a): {hit_a:.2f}), misses {miss_b:.2f}")
        print(f"  (b) an entry's carry: {entry} B (predicted 401408) for "
              f"{TIER_PREFIX} tokens; a {TIER_PREFIX}-token softmax KV "
              f"cache (bf16): {kv} B, {kv / entry:.1f}x")
        tmp = tempfile.mkdtemp(prefix="chip_smoke_4k_cache_")
        try:
            ts = time.perf_counter()
            cache.save(tmp, 0)
            save_s = time.perf_counter() - ts
            nbytes = sum(f.stat().st_size for f in Path(tmp).rglob("*")
                         if f.is_file())
            loaded = PrefixCache(max_bytes=64 << 20)
            StreamingEngine(api, params, n_slots=1, chunk=CHUNK,
                            prefix_cache=loaded)      # binds the template
            ts = time.perf_counter()
            _require(loaded.load(tmp) == 0, "(b) cache load")
            load_s = time.perf_counter() - ts
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        _require(list(loaded._entries) == list(cache._entries) and all(
            x.tobytes() == y.tobytes()
            for k, e in cache._entries.items()
            for x, y in zip(
                [v for st_ in e.carry for v in st_],
                [v for st_ in loaded._entries[k].carry for v in st_])),
            "(b) the loaded carries differ from the saved ones")
        print(f"  (b) cache saved ({nbytes} B on disk, {save_s:.3f} s) and "
              f"loaded ({load_s:.3f} s): {len(loaded)} entries, carries "
              f"bit-equal")

        # (c) Drain replica 1.
        def drain(router):
            ts = time.perf_counter()
            n = router.drain(1)
            return n, (time.perf_counter() - ts) * 1e3

        c = tier("c, drain", event=drain, alive=TIER_REPLICAS - 1)
        _require(c["tokens"] == t0_tokens, "(c) drained tokens differ "
                 "from (a)'s")
        total += c["launches"]
        print(f"  (c) drained replica 1 after {TIER_EVENT_TICK} tier ticks:"
              f" {c['info'][0]} requests migrated, export + inject "
              f"{c['info'][1]:.3f} ms")

        # (d) Crash replica 1.
        def crash(router):
            victims = {rid for rid, rec in router._records.items()
                       if rec["replica"] == 1}
            kill_router_replica(router, 1)
            return victims

        d = tier("d, crash", event=crash, alive=TIER_REPLICAS - 1,
                 crashed=(1,))
        total += d["launches"]
        victims = d["info"]
        _require(d["router"].stats()["failed_over"] == len(victims),
                 f"(d) {d['router'].stats()['failed_over']} requests "
                 f"failed over, want the {len(victims)} on replica 1")
        _require(all(t is not None and len(t) == TIER_NEW
                     for t in d["tokens"].values()),
                 "(d) a request did not finish with its tokens")
        ties = []
        for rid, toks in d["tokens"].items():
            if toks == t0_tokens[rid]:
                continue
            _require(rid in victims, f"(d) rid {rid}, never on replica 1, "
                     "differs from (a)")
            k = next(i for i, (x, y) in enumerate(zip(toks, t0_tokens[rid]))
                     if x != y)
            ok, what = near_tie(rid, k)
            _require(ok, f"(d) failed-over {what}: not a near tie")
            ties.append(what)
        print(f"  (d) crashed replica 1 after {TIER_EVENT_TICK} tier ticks: "
              f"{len(victims)} requests failed over "
              f"({d['router'].stats()['failed_over']}), "
              f"{len(victims) - len(ties)} equal to (a); divergences at "
              f"near ties: {len(ties)}")
        for what in ties:
            print(f"    {what}")

        # (e) Poison slot 3 of replica 0.
        def poison(router):
            slot = router.engines[0].active[3]
            _require(slot is not None, "(e) slot 3 of replica 0 is free")
            poison_engine_slot(router.engines[0], 3)
            return slot.request_id

        def check_freed(router, rid):
            eng = router.engines[0]
            init = lm_state_init(cfg, SLOTS, device=eng.device)
            _require(eng.active[3] is None and all(
                torch.equal(x[3], y[3]) for sx, sy in zip(eng.states, init)
                for x, y in zip(sx, sy)),
                "(e) the quarantined slot's carry is not init")

        e = tier("e, quarantine", event=poison, after=check_freed)
        total += e["launches"]
        victim = e["info"]
        _require(e["router"].errors == {victim: ERR_POISONED},
                 f"(e) errors {e['router'].errors}")
        _require(all(e["tokens"][r] == t0_tokens[r]
                     for r in t0_tokens if r != victim),
                 "(e) a batch-mate of the quarantined slot differs")
        print(f"  (e) poisoned slot 3 of replica 0 (rid {victim}): "
              f"quarantined, its carry init bit for bit, every other "
              f"request equal to (a)")

        # (f) Snapshot phase 4's load on one engine mid-run.
        eng = StreamingEngine(api, params, n_slots=SLOTS, chunk=CHUNK)
        zero_counts()
        rids = [eng.submit(p, MAX_NEW) for p in ref["requests"]]
        for _ in range(SNAP_TICK):
            eng.step()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_4k_engine_")
        try:
            ts = time.perf_counter()
            eng.save(tmp, SNAP_TICK)
            save_s = time.perf_counter() - ts
            nbytes = sum(f.stat().st_size for f in Path(tmp).rglob("*")
                         if f.is_file())
            fresh = StreamingEngine(api, params, n_slots=SLOTS, chunk=CHUNK)
            ts = time.perf_counter()
            _require(fresh.load(tmp) == SNAP_TICK, "(f) engine load")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - ts
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        out = fresh.run()
        total += read_counts("(f) snapshot")
        _require([out[r] for r in rids] == ref["tokens"],
                 "(f) restored tokens differ from phase 4's")
        print(f"  (f) engine saved after {SNAP_TICK} ticks ({nbytes} B on "
              f"disk, {save_s:.3f} s), loaded into a fresh engine "
              f"({load_s:.3f} s): tokens equal phase 4's  [{card}]")

        # (g) Batched temperature sampling, streaming against generate.
        base = temperature_sampler(0.8, top_k=50)
        scores = []

        def recording(logits, seeds):
            x = logits.float() / 0.8
            kth = torch.topk(x, 50, dim=-1).values[..., -1:]
            x = torch.where(x < kth, torch.full_like(x, -torch.inf), x)
            g = x[:, 0] + gumbel_noise(seeds, x.shape[-1])
            scores.append((seeds, torch.topk(g, 2, dim=-1).values,
                           logits[:, 0].abs().amax(dim=-1)))
            return base(logits, seeds)

        recording.batched = True
        temp_prompts = np.random.default_rng(7).integers(
            0, cfg.vocab, (TEMP_B, TEMP_P))
        zero_counts()
        wave, _ = generate(api, params, temp_prompts, TEMP_NEW,
                           sampler=recording)
        torch.cuda.synchronize()
        gen_launches = aaren_scan.n_launches
        _require(gen_launches == cfg.n_layers,
                 f"(g) generate launched B1 {gen_launches} times")
        gap = {}
        for seeds, vals, amax in scores:
            for s, (v1, v2), m in zip(seeds.tolist(), vals.tolist(),
                                      amax.tolist()):
                gap[s] = (v1 - v2, _bf16_spacing(m) / 0.8)
        eng = StreamingEngine(api, params, n_slots=SLOTS, chunk=CHUNK,
                              sampler=base)
        zero_counts()
        rids = [eng.submit(p, TEMP_NEW) for p in temp_prompts]
        got = eng.run()
        total += read_counts("(g) temperature") + gen_launches
        ties = []
        for i, r in enumerate(rids):
            want = wave[i].tolist()
            if got[r] == want:
                continue
            k = next(j for j, (x, y) in enumerate(zip(got[r], want))
                     if x != y)
            g12, sp = gap[request_seed(0, i, k)]
            _require(g12 <= TIE_SPACINGS * sp,
                     f"(g) request {i} differs from generate at step {k}, "
                     f"perturbed margin {g12:.3e} > {TIE_SPACINGS} x "
                     f"{sp:.3e}")
            ties.append(f"request {i} step {k}: perturbed margin "
                        f"{g12:.3e}, bound {TIE_SPACINGS * sp:.3e}")
        print(f"  (g) temperature 0.8, top-k 50, {TEMP_B} x {TEMP_P} "
              f"prompts, {TEMP_NEW} new: {TEMP_B - len(ties)} of {TEMP_B} "
              f"requests equal generate's; divergences at near ties: "
              f"{len(ties)}")
        for what in ties:
            print(f"    {what}")
    finally:
        undo()
        StreamingEngine._advance = real_advance
    print(f"  phase 4k: {total} B1 launches, "
          f"{time.perf_counter() - t_phase:.1f} s")
    return total


def phase4b_training(torch, np, card: str, cfg, packed: bool = False):
    """Training of ``cfg`` (full width in :func:`main`), on
    ``SyntheticLMIterator`` batches or, with ``packed``, on
    ``PackedLMIterator`` batches through ``pack_sequences=True`` and the
    segmented kernels.  Returns ({kernel: launches}, {kernel: timing row at
    the training shape}, {kernel: max |err| on captured inputs}, {"loss0":
    step 0's loss, "step_ms": the measured steps' median, "peak": peak
    bytes allocated})."""
    from repro_torch.data.packing import PackedLMIterator
    from repro_torch.data.synthetic import SyntheticLMIterator
    from repro_torch.kernels import ops
    from repro_torch.kernels.aaren_scan import aaren_scan, aaren_scan_plain
    from repro_torch.kernels.aaren_scan_bwd import (
        aaren_scan_bwd,
        aaren_scan_bwd_plain,
    )
    from repro_torch.models.factory import build
    from repro_torch.models.param import count_params
    from repro_torch.train.loop import LoopConfig, run_train_loop
    from repro_torch.train.optim import make_optimizer, warmup_cosine
    from repro_torch.train.state import init_train_state, make_train_step

    _require((cfg.remat, cfg.optimizer) == ("block", "adamw"), str(cfg))
    what = "packed training" if packed else "training"
    api = build(cfg)
    n_params = count_params(api.specs())
    steps = TRAIN_WARM + TRAIN_MEASURED
    ti = time.perf_counter()
    params = api.init(0, device="cuda")
    opt = make_optimizer(cfg.optimizer, warmup_cosine(3e-4, 1, steps))
    state = init_train_state(params, opt)
    step_fn = make_train_step(api.loss, opt, max_grad_norm=1.0)
    torch.cuda.synchronize()
    print(f"  init {time.perf_counter() - ti:.2f} s: params + AdamW moments "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on card")
    data = (PackedLMIterator if packed else SyntheticLMIterator)(
        vocab=cfg.vocab, seq_len=TRAIN_N, batch=TRAIN_B, seed=0)

    # Capture B1's and B2's inputs (and flags) at layers 0 and 31 in the
    # first step: B1 runs forward for layers 0..31, then the remat recompute
    # for 31..0; B2 runs for layers 31..0.  Cloning launches nothing.  Every
    # call of the run is counted, and those carrying segment flags apart.
    last = cfg.n_layers - 1
    want_calls = {"b1": {0: 0, last: last}, "b2": {last: 0, 0: last}}
    calls = {"b1": 0, "b2": 0}
    flagged = {"b1": 0, "b2": 0}
    captured = {"b1": {}, "b2": {}}
    capturing = {"on": True}
    real_scan, real_bwd = ops.aaren_scan, ops.aaren_scan_bwd

    def spy(kind, fn, flag_key):
        def wrapped(*args, **kw):
            flags = kw.get(flag_key)
            flagged[kind] += flags is not None
            if capturing["on"]:
                for layer, idx in want_calls[kind].items():
                    if calls[kind] == idx:
                        captured[kind][layer] = (
                            [a.clone() for a in args],
                            None if flags is None else flags.clone())
                calls[kind] += 1
            return fn(*args, **kw)
        return wrapped

    finite = {"ok": True}
    losses, utils = [], []

    def on_log(step, m):
        capturing["on"] = False
        finite["ok"] &= bool(np.isfinite(m["loss"])
                             and np.isfinite(m["grad_norm"]))
        losses.append(m["loss"])
        utils.append(m.get("token_util", 1.0))
        util = (f" token_util {m['token_util']:.4f}" if "token_util" in m
                else "")
        print(f"  step {step}: loss {m['loss']:.4f} grad_norm "
              f"{m['grad_norm']:.4f} {m['step_time_s'] * 1e3:.1f} ms{util}")

    ops.aaren_scan = spy("b1", real_scan, "segment_starts")
    ops.aaren_scan_bwd = spy("b2", real_bwd, "segment_ends")
    undo = _forbid_plain_on_card()
    torch.cuda.reset_peak_memory_stats()
    # The main path: counts from zero, read right after.
    aaren_scan.n_launches = aaren_scan_bwd.n_launches = 0
    try:
        result = run_train_loop(
            step_fn, state, data,
            LoopConfig(total_steps=steps, log_every=1, pack_sequences=packed),
            on_log=on_log)
    finally:
        ops.aaren_scan, ops.aaren_scan_bwd = real_scan, real_bwd
        undo()
    launches = {"aaren_scan": aaren_scan.n_launches,
                "aaren_scan_bwd": aaren_scan_bwd.n_launches}
    peak = torch.cuda.max_memory_allocated()

    _require(finite["ok"], f"non-finite loss or grad norm: {losses}")
    _require(result.state.step == steps and len(result.history) == steps,
             f"ran {result.state.step} steps, want {steps}")
    _require(calls["b1"] == 2 * cfg.n_layers and calls["b2"] == cfg.n_layers,
             f"first step called B1 {calls['b1']} and B2 {calls['b2']} times")
    want_b1, want_b2 = 2 * cfg.n_layers * steps, cfg.n_layers * steps
    _require(launches == {"aaren_scan": want_b1, "aaren_scan_bwd": want_b2},
             f"launches {launches}, want B1 {want_b1} and B2 {want_b2}")
    want_flagged = ({"b1": want_b1, "b2": want_b2} if packed
                    else {"b1": 0, "b2": 0})
    _require(flagged == want_flagged, f"calls with segment flags {flagged}, "
             f"want {want_flagged}")
    form = "segmented " if packed else ""
    print(f"  launches on the {what} path over {steps} steps: {form}B1 "
          f"{launches['aaren_scan']} = 2 x {cfg.n_layers} x {steps}, {form}B2 "
          f"{launches['aaren_scan_bwd']} = {cfg.n_layers} x {steps}; no plain "
          "scan reached a CUDA tensor")

    errs = {"aaren_scan": 0.0, "aaren_scan_bwd": 0.0}
    for layer in (0, last):
        (b1_args, starts), (b2_args, ends) = (captured["b1"][layer],
                                              captured["b2"][layer])
        _require((starts is not None) == packed and (ends is not None)
                 == packed, f"layer {layer}: flags {starts}, {ends}")
        label = f"{what} step, layer {layer}"
        errs["aaren_scan"] = max(errs["aaren_scan"], _compare_scan_residuals(
            torch, b1_args, label, starts))
        errs["aaren_scan_bwd"] = max(errs["aaren_scan_bwd"], _compare_bwd(
            torch, b2_args, label, ends))

    step_s = [m["step_time_s"] for _, m in result.history[TRAIN_WARM:]]
    step_ms = statistics.median(step_s) * 1e3
    tokens = TRAIN_B * TRAIN_N
    util = statistics.mean(utils[TRAIN_WARM:])
    mfu = 6 * n_params * tokens / (step_ms / 1e3) / BF16_DENSE_FLOPS
    each = ", ".join(f"{s * 1e3:.1f}" for s in step_s)
    print(f"  {what} B={TRAIN_B} N={TRAIN_N}: step median {step_ms:.3f} ms "
          f"over {len(step_s)} steps ({each} ms), "
          f"{tokens / (step_ms / 1e3):.1f} tokens/s, real tokens/s "
          f"{tokens * util / (step_ms / 1e3):.1f} (token_util {util:.4f})"
          f"  [{card}]")
    print(f"  peak memory allocated {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)  [{card}]")
    print(f"  MFU {mfu:.2%}: 6 x {n_params} params x {tokens} tokens per "
          f"step over the H100 SXM bf16 dense peak of "
          f"{BF16_DENSE_FLOPS / 1e12:.0f} TFLOP/s  [{card}]")
    print(f"  loss {'fell' if losses[-1] < losses[0] else 'did not fall'}: "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (not required at full width)")

    # Where a step's time goes (after the counts were read).
    train_state = {"state": result.state}
    batch = next(data)

    def one_step():
        train_state["state"], _ = step_fn(train_state["state"], batch)

    _print_profile(_device_profile(torch, one_step, 1), f"{what} step", card,
                   top=16)

    # Both kernels at the training shape, on the captured layer-0 inputs.
    rows = {}
    (s, v, m0, u0, w0), starts = captured["b1"][0]
    r, n = s.shape
    d = v.shape[-1]
    times = _kernel_times(
        torch, lambda: aaren_scan(s, v, m0, u0, w0, segment_starts=starts,
                                  return_residuals=True),
        lambda: aaren_scan_plain(s, v, m0, u0, w0, segment_starts=starts,
                                 return_residuals=True), 20, 3)
    rows["aaren_scan"] = times + _b1_bound(r, n, d, residuals=True,
                                           flags=packed)
    serve_form_ms = _graph_ms(torch, lambda: aaren_scan(
        s, v, m0, u0, w0, segment_starts=starts), 20)
    print(f"  {form}aaren_scan serving form (no residuals) at the training "
          f"shape: device {serve_form_ms * 1e3:.2f} us  [{card}]")
    bwd, ends = captured["b2"][0]
    times = _kernel_times(
        torch, lambda: aaren_scan_bwd(*bwd, segment_ends=ends),
        lambda: aaren_scan_bwd_plain(*bwd, segment_ends=ends), 20, 3)
    rows["aaren_scan_bwd"] = times + _b2_bound(r, n, d, flags=packed)
    out = {}
    for name, (ms, call_ms, plain_ms, plain_call_ms, bound_ms, bound_by,
               nbytes) in rows.items():
        before = BEFORE_US.get((name, "train_packed" if packed else "train"))
        before = "" if before is None else f"; before {before} us"
        print(f"  {form}{name} at the training shape R={r} N={n} d={d}: "
              f"device {ms * 1e3:.2f} us (eager call {call_ms * 1e3:.2f} us"
              f"{before}), "
              f"plain device {plain_ms * 1e3:.2f} us (eager call "
              f"{plain_call_ms * 1e3:.2f} us), bound {bound_ms * 1e3:.3f} us "
              f"by {bound_by} ({nbytes} B), {ms / bound_ms:.1f}x the bound"
              f"  [{card}]")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "shape": [r, n, d]}
    summary = {"loss0": losses[0], "step_ms": step_ms, "peak": peak}
    return launches, out, errs, summary


def phase4c_softmax_training(torch, np, card: str, cfg,
                             packed: bool = False):
    """Training of the softmax ``cfg`` (full width in :func:`main`), on
    ``SyntheticLMIterator`` batches or, with ``packed``, on
    ``PackedLMIterator`` batches through ``pack_sequences=True`` and the
    segmented kernels.  Returns ({kernel: launches}, {kernel: timing row at
    the training shape}, {kernel: max |err| on the captured layer-0
    inputs})."""
    from repro_torch.data.packing import PackedLMIterator
    from repro_torch.data.synthetic import SyntheticLMIterator
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.factory import build
    from repro_torch.models.param import count_params
    from repro_torch.train.loop import LoopConfig, run_train_loop
    from repro_torch.train.optim import make_optimizer, warmup_cosine
    from repro_torch.train.state import init_train_state, make_train_step

    _require((cfg.attn_mode, cfg.remat, cfg.optimizer)
             == ("softmax", "block", "adamw"), str(cfg))
    what = "packed softmax training" if packed else "softmax training"
    api = build(cfg)
    n_params = count_params(api.specs())
    steps = TRAIN_WARM + TRAIN_MEASURED
    ti = time.perf_counter()
    params = api.init(0, device="cuda")
    opt = make_optimizer(cfg.optimizer, warmup_cosine(3e-4, 1, steps))
    state = init_train_state(params, opt)
    step_fn = make_train_step(api.loss, opt, max_grad_norm=1.0)
    torch.cuda.synchronize()
    print(f"  init {time.perf_counter() - ti:.2f} s: params + AdamW moments "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on card")
    data = (PackedLMIterator if packed else SyntheticLMIterator)(
        vocab=cfg.vocab, seq_len=TRAIN_N, batch=TRAIN_B, seed=0)

    # In the first step B3 runs forward for layers 0..31, then the remat
    # recompute for 31..0; the backward runs for 31..0, so its last call
    # is layer 0's: capture those inputs (cloning launches nothing).  Every
    # call of the run is counted, and those carrying segment ids apart.
    calls = {"fwd": 0, "bwd": 0}
    with_ids = {"fwd": 0, "bwd": 0}
    captured = {}
    capturing = {"on": True}
    real_fwd, real_bwd = ops.flash_attention, ops.flash_attention_bwd

    def spy_fwd(*args, **kw):
        with_ids["fwd"] += kw.get("q_segment_ids") is not None
        if capturing["on"]:
            calls["fwd"] += 1
        return real_fwd(*args, **kw)

    def spy_bwd(*args, **kw):
        with_ids["bwd"] += kw.get("q_segment_ids") is not None
        if capturing["on"]:
            if calls["bwd"] == cfg.n_layers - 1:
                captured["args"] = [a.clone() for a in args]
                captured["kw"] = dict(kw)
            calls["bwd"] += 1
        return real_bwd(*args, **kw)

    finite = {"ok": True}
    losses, utils = [], []

    def on_log(step, m):
        capturing["on"] = False
        finite["ok"] &= bool(np.isfinite(m["loss"])
                             and np.isfinite(m["grad_norm"]))
        losses.append(m["loss"])
        utils.append(m.get("token_util", 1.0))
        util = (f" token_util {m['token_util']:.4f}" if "token_util" in m
                else "")
        print(f"  step {step}: loss {m['loss']:.4f} grad_norm "
              f"{m['grad_norm']:.4f} {m['step_time_s'] * 1e3:.1f} ms{util}")

    ops.flash_attention, ops.flash_attention_bwd = spy_fwd, spy_bwd
    undo = _forbid_plain_on_card()
    torch.cuda.reset_peak_memory_stats()
    # The main path: counts from zero, read right after.
    fa.flash_attention.n_launches = 0
    fa.flash_bwd_dq.n_launches = fa.flash_bwd_dkv.n_launches = 0
    try:
        result = run_train_loop(
            step_fn, state, data,
            LoopConfig(total_steps=steps, log_every=1, pack_sequences=packed),
            on_log=on_log)
    finally:
        ops.flash_attention, ops.flash_attention_bwd = real_fwd, real_bwd
        undo()
    launches = {"flash_attention": fa.flash_attention.n_launches,
                "flash_bwd_dq": fa.flash_bwd_dq.n_launches,
                "flash_bwd_dkv": fa.flash_bwd_dkv.n_launches}
    peak = torch.cuda.max_memory_allocated()

    _require(finite["ok"], f"non-finite loss or grad norm: {losses}")
    _require(result.state.step == steps and len(result.history) == steps,
             f"ran {result.state.step} steps, want {steps}")
    _require(calls == {"fwd": 2 * cfg.n_layers, "bwd": cfg.n_layers},
             f"first step called B3 {calls['fwd']} and the backward "
             f"{calls['bwd']} times")
    want = {"flash_attention": 2 * cfg.n_layers * steps,
            "flash_bwd_dq": cfg.n_layers * steps,
            "flash_bwd_dkv": cfg.n_layers * steps}
    _require(launches == want, f"launches {launches}, want {want}")
    want_ids = ({"fwd": want["flash_attention"], "bwd": want["flash_bwd_dq"]}
                if packed else {"fwd": 0, "bwd": 0})
    _require(with_ids == want_ids, f"calls with segment ids {with_ids}, want "
             f"{want_ids}")
    form = "segmented " if packed else ""
    print(f"  launches on the {what} path over {steps} steps: {form}B3 "
          f"{launches['flash_attention']} = 2 x {cfg.n_layers} x {steps}, "
          f"{form}B4 {launches['flash_bwd_dq']} and {form}B5 "
          f"{launches['flash_bwd_dkv']} = {cfg.n_layers} x {steps}; no plain "
          "flash version reached a CUDA tensor")

    q, k, v, o, lse, do = captured["args"]
    kw = captured["kw"]
    seg = kw.get("q_segment_ids")
    _require(kw.get("q_lens") is None and kw.get("window") is None
             and kw.get("causal", True) and (seg is not None) == packed
             and (seg is None or torch.equal(kw["kv_segment_ids"], seg)),
             f"layer 0's flash call: {sorted(kw)}")
    errs = _check_flash(torch, q, k, v, do, None, True, None,
                        f"{what} step, layer 0 (captured)", seg=seg)

    step_s = [m["step_time_s"] for _, m in result.history[TRAIN_WARM:]]
    step_ms = statistics.median(step_s) * 1e3
    tokens = TRAIN_B * TRAIN_N
    util = statistics.mean(utils[TRAIN_WARM:])
    mfu = 6 * n_params * tokens / (step_ms / 1e3) / BF16_DENSE_FLOPS
    each = ", ".join(f"{s * 1e3:.1f}" for s in step_s)
    real = (f", real tokens/s {tokens * util / (step_ms / 1e3):.1f} "
            f"(token_util {util:.4f})" if packed else "")
    print(f"  {what} B={TRAIN_B} N={TRAIN_N}: step median "
          f"{step_ms:.3f} ms over {len(step_s)} steps ({each} ms), "
          f"{tokens / (step_ms / 1e3):.1f} tokens/s{real}  [{card}]")
    print(f"  peak memory allocated {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)  [{card}]")
    print(f"  MFU {mfu:.2%}: 6 x {n_params} params x {tokens} tokens per "
          f"step over the H100 SXM bf16 dense peak of "
          f"{BF16_DENSE_FLOPS / 1e12:.0f} TFLOP/s  [{card}]")
    print(f"  loss {'fell' if losses[-1] < losses[0] else 'did not fall'}: "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (not required at full width)")

    # Where a step's time goes (after the counts were read).
    train_state = {"state": result.state}
    batch = next(data)

    def one_step():
        train_state["state"], _ = step_fn(train_state["state"], batch)

    _print_profile(_device_profile(torch, one_step, 1), f"{what} step",
                   card, top=16)
    del train_state, result, state, params
    gc.collect()
    torch.cuda.empty_cache()
    rows = flash_kernel_times(torch, q, k, v, do, None, True, None, card,
                              seg=seg)
    return launches, rows, errs


def phase4d_softmax_generate(torch, np, card: str, cfg):
    """Wave ``generate`` of the softmax ``cfg`` with a KV cache (B = 4,
    P = 128, 8 new tokens, cache_len = 136).  Returns B3's launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.factory import build
    from repro_torch.serving.engine import decode_state_bytes, generate
    from repro_torch.serving.sampler import greedy_sampler

    api = build(cfg)
    params = api.init(0, device="cuda")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (GEN_B, GEN_P))
    cache_len = GEN_P + GEN_NEW
    finite = {"ok": True}

    def checked_greedy(logits, seeds):
        finite["ok"] &= bool(torch.isfinite(logits).all())
        return greedy_sampler(logits, seeds)

    checked_greedy.batched = True
    checked_greedy.uses_seeds = False

    generate(api, params, prompts, 2, cache_len=cache_len)  # warm-up
    torch.cuda.synchronize()
    # The main path: counts from zero, read right after.
    fa.flash_attention.n_launches = 0
    fa.flash_bwd_dq.n_launches = fa.flash_bwd_dkv.n_launches = 0
    tg = time.perf_counter()
    toks, states = generate(api, params, prompts, GEN_NEW,
                            sampler=checked_greedy, cache_len=cache_len)
    gen_s = time.perf_counter() - tg
    launches = (fa.flash_attention.n_launches, fa.flash_bwd_dq.n_launches,
                fa.flash_bwd_dkv.n_launches)
    _require(tuple(toks.shape) == (GEN_B, GEN_NEW),
             f"generate returned {tuple(toks.shape)}")
    _require(finite["ok"], "non-finite logits on the softmax serving path")
    _require(launches == (cfg.n_layers, 0, 0),
             f"generate launched B3/B4/B5 {launches} times, want "
             f"({cfg.n_layers}, 0, 0): one prefill, plain-torch decode")
    _require(all(int(st["index"]) == GEN_P + GEN_NEW - 1
                 and st["k"].shape[1] == cache_len for st in states),
             "the KV caches do not hold prompt + generated tokens")
    print(f"  softmax generate B={GEN_B} P={GEN_P} new={GEN_NEW} "
          f"cache_len={cache_len}: {gen_s:.3f} s; B3 launches {launches[0]}"
          f" (one prefill), decode state {decode_state_bytes(states)} B  "
          f"[{card}]")
    return launches[0]


GROUP_WARM, GROUP_MEASURED = 1, 2


def phase4g_group_remat(torch, np, card: str, cfg, block: dict) -> dict:
    """Training of ``cfg`` (full width in :func:`main`) with
    ``remat="group"``: every group of ``_group_size(32) = 4`` periods is one
    checkpoint.  The same seed, batches and optimizer as phase 4b; counts
    zeroed just before and read just after (B1 64 and B2 32 launches a
    step).  Step 0's loss, the step median and the peak memory are printed
    beside phase 4b's (``block``).  Returns {kernel: launches}."""
    from repro_torch.data.synthetic import SyntheticLMIterator
    from repro_torch.kernels.aaren_scan import aaren_scan
    from repro_torch.kernels.aaren_scan_bwd import aaren_scan_bwd
    from repro_torch.models.factory import build
    from repro_torch.models.lm import _group_size
    from repro_torch.train.loop import LoopConfig, run_train_loop
    from repro_torch.train.optim import make_optimizer, warmup_cosine
    from repro_torch.train.state import init_train_state, make_train_step

    cfg = cfg.replace(remat="group")
    n_periods, _ = cfg.layer_plan()
    g = _group_size(n_periods)
    _require((n_periods, g, cfg.scan_layers) == (32, 4, True),
             f"{n_periods} periods in groups of {g}")
    api = build(cfg)
    steps = GROUP_WARM + GROUP_MEASURED
    params = api.init(0, device="cuda")
    opt = make_optimizer(cfg.optimizer, warmup_cosine(3e-4, 1, steps))
    state = init_train_state(params, opt)
    step_fn = make_train_step(api.loss, opt, max_grad_norm=1.0)
    data = SyntheticLMIterator(vocab=cfg.vocab, seq_len=TRAIN_N,
                               batch=TRAIN_B, seed=0)
    losses = []

    def on_log(step, m):
        losses.append(m["loss"])
        print(f"  step {step}: loss {m['loss']:.4f} grad_norm "
              f"{m['grad_norm']:.4f} {m['step_time_s'] * 1e3:.1f} ms")

    undo = _forbid_plain_on_card()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # The main path: counts from zero, read right after.
    aaren_scan.n_launches = aaren_scan_bwd.n_launches = 0
    try:
        result = run_train_loop(step_fn, state, data,
                                LoopConfig(total_steps=steps, log_every=1),
                                on_log=on_log)
    finally:
        undo()
    launches = {"aaren_scan": aaren_scan.n_launches,
                "aaren_scan_bwd": aaren_scan_bwd.n_launches}
    peak = torch.cuda.max_memory_allocated()
    want = {"aaren_scan": 2 * cfg.n_layers * steps,
            "aaren_scan_bwd": cfg.n_layers * steps}
    _require(launches == want, f"launches {launches}, want {want}")
    _require(all(np.isfinite(x) for x in losses), f"losses {losses}")
    print(f"  launches on the group-remat training path over {steps} steps: "
          f"B1 {launches['aaren_scan']} = 2 x {cfg.n_layers} x {steps}, B2 "
          f"{launches['aaren_scan_bwd']} = {cfg.n_layers} x {steps}; "
          f"{n_periods // g} groups of {g} periods; no plain scan reached a "
          "CUDA tensor")
    diff = losses[0] - block["loss0"]
    print(f"  step 0 loss, group {losses[0]!r} against block {block['loss0']!r}"
          f": {'bit-equal' if diff == 0 else f'differs by {diff:.3e}'}")
    step_ms = statistics.median(
        m["step_time_s"] for _, m in result.history[GROUP_WARM:]) * 1e3
    print(f"  remat group against block, B={TRAIN_B} N={TRAIN_N}: step median "
          f"{step_ms:.3f} ms against {block['step_ms']:.3f} ms; peak memory "
          f"allocated {peak / 2**30:.2f} GiB against "
          f"{block['peak'] / 2**30:.2f} GiB  [{card}]")
    return launches


FT_STEPS, FT_NAN_AT, FT_PREEMPT_AFTER = 6, 2, 3
# The card machine ends a command once it has written 45 GiB to its disk,
# deleted files included, and one checkpoint of the 32-layer model is
# 35.6 GiB: the checkpointed runs of phase 4j keep the full width and 8 of
# the 32 layers, two checkpoints in one run.  At 16 layers (18.7 GiB each)
# their saves, restore and crc passes took ~196 s of a whole run that
# reached its result lines at 1021.5 s of its 1200 s limit (NVIDIA H100
# 80GB HBM3, 700 W).
FT_CKPT_LAYERS = 8


def _bit_checksums(torch, tree) -> list:
    """Per-leaf int64 sums of the leaves' bits (bf16 read as int16, f32 as
    int32), computed on the card and read in one transfer: a fingerprint of
    the tree without a second copy of it."""
    from repro_torch.tree import tree_leaves

    views = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return torch.stack([
        t.detach().view(views.get(t.dtype, t.dtype)).sum(dtype=torch.int64)
        for t in tree_leaves(tree)]).tolist()


def _span_times(prof, names) -> dict:
    """{(span name, "cpu" or "cuda"): (count, host ms, device ms)} of the
    named ``record_function`` spans in a ``torch.profiler`` run: the host
    range with the device time of the kernels it launched, and the range
    the profiler draws on the card's timeline."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.name not in names:
            continue
        side = "cuda" if e.device_type == DeviceType.CUDA else "cpu"
        n, host, dev = out.get((e.name, side), (0, 0.0, 0.0))
        out[e.name, side] = (n + 1, host + e.cpu_time_total / 1e3,
                             dev + e.device_time_total / 1e3)
    return out


def phase4j_fault_tolerant_training(torch, np, card: str, cfg, block: dict):
    """Full-width fault-tolerant training on ``SyntheticLMIterator`` batches
    wrapped in ``FaultyLMIterator(nan_at={2})``, with ``faulty_loss`` on the
    model's loss and ``GuardConfig()``.

    (a) ``cfg`` as registered (32 layers), 6 guarded steps with an event log
    and a metrics snapshot: step 2 is skipped with the parameters and
    moments bit-unchanged and the LR scale halves; the guarded step median
    beside phase 4b's unguarded one (``block``), the guard check's own cost
    and a profiler view of one more guarded step with tracing on.  Then at
    the full width with ``FT_CKPT_LAYERS`` layers (the disk's write limit):
    (a8) the same 6 steps as the reference; (b) the same load with a real
    SIGTERM after the 3rd draw drains into one sync checkpoint at step 3;
    (c) a fresh state and loop resume from it and run to step 6, bit-equal
    to (a8).  Counts are zeroed before (a) and read after (c): 2 x layers
    B1 and layers B2 launches for every step.  Then the checkpoint's bytes,
    the save, restore and crc-pass rates and the peak memory.  Returns
    {kernel: launches}."""
    import json
    import os
    import shutil
    import signal
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import available_steps, verify_checkpoint
    from repro_torch.data.synthetic import SyntheticLMIterator
    from repro_torch.kernels.aaren_scan import aaren_scan
    from repro_torch.kernels.aaren_scan_bwd import aaren_scan_bwd
    from repro_torch.models.factory import build
    from repro_torch.models.param import count_params
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.events import read_events, validate_events
    from repro_torch.testing import (
        FaultyLMIterator,
        PreemptingIterator,
        faulty_loss,
    )
    from repro_torch.train import loop as loop_mod
    from repro_torch.train.guard import GuardConfig, all_finite, guard_update
    from repro_torch.train.loop import LoopConfig, run_train_loop
    from repro_torch.train.optim import make_optimizer, warmup_cosine
    from repro_torch.train.state import init_train_state, make_train_step

    _require((cfg.remat, cfg.optimizer) == ("block", "adamw"), str(cfg))
    guard = GuardConfig()
    opt = make_optimizer(cfg.optimizer, warmup_cosine(3e-4, 1, FT_STEPS))
    ckpt_cfg = cfg.replace(n_layers=FT_CKPT_LAYERS)

    def model(c):
        """(step function, fresh guarded state maker, parameters)."""
        api = build(c)
        step_fn = make_train_step(faulty_loss(api.loss), opt,
                                  max_grad_norm=1.0, guard=guard)
        return step_fn, (lambda: init_train_state(
            api.init(0, device="cuda"), opt, guard=guard)), count_params(
                api.specs())

    def faulty():
        return FaultyLMIterator(SyntheticLMIterator(
            vocab=cfg.vocab, seq_len=TRAIN_N, batch=TRAIN_B, seed=0),
            nan_at={FT_NAN_AT})

    def logger(hist, run):
        def on_log(step, m):
            hist[step] = m
            print(f"  ({run}) step {step}: loss {m['loss']!r} grad_norm "
                  f"{m['grad_norm']!r} skipped {m['guard_skipped']:.0f} "
                  f"lr_scale {m['guard_lr_scale']} "
                  f"{m['step_time_s'] * 1e3:.1f} ms")
        return on_log

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def guarded_run(step_fn, state, run, **loop_kw):
        """FT_STEPS guarded steps from ``state``: step FT_NAN_AT skipped
        with the parameters and moments bit-unchanged, the LR scale 0.5
        from the step after, every healthy loss and grad norm finite.
        Returns (result, {step: metrics})."""
        around, hist = {}, {}

        def watched_step(state, batch, gen=None):
            watch = state.step == FT_NAN_AT
            if watch:
                around["before"] = _bit_checksums(torch, (state.params,
                                                          state.opt_state))
            state, m = step_fn(state, batch, gen)
            if watch:
                around["after"] = _bit_checksums(torch, (state.params,
                                                         state.opt_state))
            return state, m

        res = run_train_loop(
            watched_step, state, faulty(),
            LoopConfig(total_steps=FT_STEPS, log_every=1, guard=True,
                       **loop_kw),
            on_log=logger(hist, run))
        skipped = [s for s in range(FT_STEPS) if hist[s]["guard_skipped"]]
        _require(skipped == [FT_NAN_AT] and res.skipped_steps == 1,
                 f"({run}) skipped steps {skipped}, {res.skipped_steps}")
        _require(around["before"] == around["after"],
                 f"({run}) the skipped step changed parameters or moments")
        scales = [hist[s]["guard_lr_scale"] for s in range(FT_STEPS)]
        _require(scales == [1.0] * FT_NAN_AT + [0.5] * (FT_STEPS - FT_NAN_AT)
                 and res.final_lr_scale == 0.5, f"({run}) lr_scale {scales}")
        _require(all(np.isfinite(hist[s]["loss"]) for s in range(FT_STEPS))
                 and all(np.isfinite(hist[s]["grad_norm"])
                         for s in range(FT_STEPS) if s != FT_NAN_AT),
                 f"({run}) a healthy step's loss or grad norm is not finite")
        print(f"  ({run}) step {FT_NAN_AT} skipped, parameters and moments "
              f"bit-unchanged across it ({len(around['before'])} leaf "
              f"checksums), lr_scale 0.5 from step {FT_NAN_AT + 1}")
        return res, hist

    # Saves and restores inside the loop, timed with their peak memory.
    io_times = {"save": [], "restore": []}
    real_ckpt, real_restore = loop_mod.Checkpointer, loop_mod.restore_checkpoint

    def timed(kind, fn, *args, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        out = fn(*args, **kw)
        io_times[kind].append((time.perf_counter() - t, base,
                               torch.cuda.max_memory_allocated()))
        return out

    class TimedCheckpointer(real_ckpt):
        def save_sync(self, step, tree, *, extra=None):
            timed("save", super().save_sync, step, tree, extra=extra)

    def verified(step):
        """verify_checkpoint of one step: (seconds, manifest)."""
        t = time.perf_counter()
        manifest = verify_checkpoint(ckpt_dir, step)
        return time.perf_counter() - t, manifest

    tmp = tempfile.mkdtemp(prefix="chip_smoke_4j_")
    ckpt_dir = os.path.join(tmp, "ckpt")
    events_path = os.path.join(tmp, "events.jsonl")
    metrics_path = os.path.join(tmp, "metrics.json")
    undo = _forbid_plain_on_card()
    try:
        loop_mod.Checkpointer = TimedCheckpointer
        loop_mod.restore_checkpoint = (
            lambda *a, **kw: timed("restore", real_restore, *a, **kw))
        # The main path: counts from zero before (a), read after (c).
        aaren_scan.n_launches = aaren_scan_bwd.n_launches = 0

        # (a) As registered: guarded, no checkpoint, obs files on.
        step_fn, fresh_state, n_params = model(cfg)
        res, hist_a = guarded_run(step_fn, fresh_state(), "a",
                                  events=events_path,
                                  metrics_out=metrics_path)
        recs = read_events(events_path)
        validate_events(recs)
        _require(recs[0]["kind"] == "run_meta" and recs[0]["data"][
            "device_kind"] == torch.cuda.get_device_name(),
            f"run_meta {recs[0]}")
        with open(metrics_path) as f:
            snap = json.load(f)["metrics"]
        _require(snap["counters"]["train_guard_skipped_total"]["value"] == 1,
                 "snapshot's train_guard_skipped_total is not 1")
        print(f"  (a) event log of {len(recs)} records valid, first "
              f"run_meta on {recs[0]['data']['device_kind']}; snapshot "
              "train_guard_skipped_total 1")
        guarded_ms = statistics.median(
            hist_a[s]["step_time_s"] for s in range(1, FT_STEPS)
            if s != FT_NAN_AT) * 1e3

        # The guard's own cost: its all-finite check, carry update and host
        # read on a tree of the gradients' shapes and dtypes (the params).
        state = res.state
        loss = torch.zeros((), device=state.params["embed"]["table"].device)

        def check():
            finite = all_finite(loss, state.params)
            return bool(guard_update(guard, state.guard, finite, loss)[1])

        for _ in range(2):
            check()
        t = time.perf_counter()
        for _ in range(5):
            _require(check(), "the guard read finite parameters as not")
        check_ms = (time.perf_counter() - t) / 5 * 1e3
        print(f"  guarded step median {guarded_ms:.3f} ms (steps 1, 3-5 of "
              f"(a), {cfg.n_layers} layers) against phase 4b's unguarded "
              f"{block['step_ms']:.3f} ms: {guarded_ms - block['step_ms']:+.3f}"
              f" ms; the guard's check, update and host read alone "
              f"{check_ms:.3f} ms  [{card}]")

        # One more guarded step of (a)'s model with tracing on.
        mode = "cuda" if loss.is_cuda else "plain"
        names = ("train.step", f"aaren_scan_fwd.{mode}",
                 f"aaren_scan_bwd.{mode}")
        prev = obs_trace.set_enabled(True)
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run_train_loop(step_fn, state, faulty(),
                               LoopConfig(total_steps=FT_STEPS + 1,
                                          log_every=1, guard=True,
                                          install_signal_handlers=False))
        finally:
            obs_trace.set_enabled(prev)
        spans = _span_times(prof, names)
        _require(all((n, "cpu") in spans for n in names),
                 f"spans seen {sorted(spans)}")
        print(f"  profile of one guarded step with tracing on "
              f"({cfg.n_layers} layers):")
        for (name, side), (n, host, dev) in sorted(spans.items()):
            print(f"    span {name:22s} [{side}] x{n:3d}: host {host:9.3f} ms"
                  f", device {dev:9.3f} ms  [{card}]")
        del state, res, prof
        free()

        # The checkpointed runs, at FT_CKPT_LAYERS layers.
        step_fn, fresh_state, n_ckpt = model(ckpt_cfg)
        want_disk = 10 * n_ckpt
        free_disk = shutil.disk_usage(tmp).free
        print(f"  checkpointed runs: {ckpt_cfg.n_layers} of {cfg.n_layers} "
              f"layers at full width, {n_ckpt} params, ~{want_disk / 2**30:.1f}"
              f" GiB a checkpoint; {free_disk / 2**30:.1f} GiB free at "
              f"{ckpt_dir}")
        _require(free_disk > 2.05 * want_disk, "the disk cannot hold two "
                 "checkpoints")

        # (a8) The reference for the resume.
        res, hist_r = guarded_run(step_fn, fresh_state(), "a8")
        final_r = _bit_checksums(torch, res.state.params)
        del res
        free()

        # (b) The preemption drain: a real SIGTERM after the 3rd draw.
        res = run_train_loop(
            step_fn, fresh_state(),
            PreemptingIterator(faulty(), FT_PREEMPT_AFTER),
            LoopConfig(total_steps=FT_STEPS, ckpt_dir=ckpt_dir, log_every=1,
                       guard=True),
            on_log=logger({}, "b"))
        _require(res.preempted and res.preempt_signal == signal.SIGTERM
                 and res.state.step == FT_PREEMPT_AFTER
                 and available_steps(ckpt_dir) == [FT_PREEMPT_AFTER]
                 and len(io_times["save"]) == 1,
                 f"preempted {res.preempted} at step {res.state.step}, "
                 f"checkpoints {available_steps(ckpt_dir)}")
        print(f"  (b) SIGTERM drained: step {res.state.step} finished, one "
              f"sync checkpoint at step {FT_PREEMPT_AFTER}")
        del res
        free()

        # (c) The resume: a fresh state and loop on the same directory.
        hist_c = {}
        res = run_train_loop(
            step_fn, fresh_state(), PreemptingIterator(faulty(), 10 ** 9),
            LoopConfig(total_steps=FT_STEPS, ckpt_dir=ckpt_dir, log_every=1,
                       guard=True),
            on_log=logger(hist_c, "c"))
        launches = {"aaren_scan": aaren_scan.n_launches,
                    "aaren_scan_bwd": aaren_scan_bwd.n_launches}
        final_c = _bit_checksums(torch, res.state.params)
        _require(res.resumed_from == FT_PREEMPT_AFTER
                 and res.state.step == FT_STEPS and not res.preempted,
                 f"resumed from {res.resumed_from} to {res.state.step}")
        for s in range(FT_PREEMPT_AFTER, FT_STEPS):
            for key in ("loss", "grad_norm"):
                _require(hist_c[s][key] == hist_r[s][key],
                         f"resumed step {s} {key} {hist_c[s][key]!r} != "
                         f"{hist_r[s][key]!r}")
        _require(final_c == final_r, "resumed final parameters differ")
        print(f"  (c) resumed from step {res.resumed_from}: losses and grad "
              f"norms of steps {FT_PREEMPT_AFTER}-{FT_STEPS - 1} and the "
              f"final parameters ({len(final_c)} leaf checksums) bit-equal "
              "to (a8)")
        del res
        free()
        big = FT_STEPS + 1                       # (a) and its traced step
        small = FT_STEPS + FT_STEPS              # (a8), (b) and (c)
        want = {"aaren_scan": 2 * (cfg.n_layers * big
                                   + ckpt_cfg.n_layers * small),
                "aaren_scan_bwd": (cfg.n_layers * big
                                   + ckpt_cfg.n_layers * small)}
        _require(launches == want, f"launches {launches}, want {want}")
        print(f"  launches over (a)-(c), every step guarded, the skipped "
              f"ones included: B1 {launches['aaren_scan']} = 2 x "
              f"({cfg.n_layers} x {big} + {ckpt_cfg.n_layers} x {small}), "
              f"B2 {launches['aaren_scan_bwd']} = {cfg.n_layers} x {big} + "
              f"{ckpt_cfg.n_layers} x {small}; no plain scan reached a CUDA "
              "tensor")

        # The checkpoints: bytes, save / restore / crc-pass rates, memory.
        crc = [verified(step) for step in (FT_PREEMPT_AFTER, FT_STEPS)]
        manifest = crc[-1][1]
        nbytes = sum(int(np.prod(rec["shape"], dtype=np.int64))
                     * (2 if rec["dtype"] == "bfloat16"
                        else np.dtype(rec["dtype"]).itemsize)
                     for rec in manifest["leaves"])
        chunks = sum(len(rec["chunks"]) for rec in manifest["leaves"])
        print(f"  checkpoint: {nbytes} B in {len(manifest['leaves'])} leaves"
              f" / {chunks} chunks (params bf16 {2 * n_ckpt} B + AdamW "
              f"moments f32 {8 * n_ckpt} B = {10 * n_ckpt} B, + the step and"
              f" the guard carry); at {cfg.n_layers} layers it would be "
              f"{10 * n_params} B")
        for kind, rows in io_times.items():
            for sec, base, peak in rows:
                print(f"  {kind}: {sec:.2f} s, {nbytes / sec / 1e9:.3f} GB/s;"
                      f" device memory {base / 2**30:.2f} GiB allocated "
                      f"before, peak {peak / 2**30:.2f} GiB  [{card}]")
        for step, (sec, _) in zip((FT_PREEMPT_AFTER, FT_STEPS), crc):
            print(f"  crc pass (verify_checkpoint, step {step}): {sec:.2f} "
                  f"s, {nbytes / sec / 1e9:.3f} GB/s  [{card}]")
    finally:
        loop_mod.Checkpointer, loop_mod.restore_checkpoint = (
            real_ckpt, real_restore)
        undo()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def phase4j_instrumented_serving(torch, np, card: str, cfg, ref: dict):
    """Phase 4's serving load once more with a metrics registry and an event
    sink installed: the tokens must equal phase 4's and the event log must
    validate; TTFT and ITL p50/p99 (bucket upper bounds) and the tick
    median beside phase 4's.  Returns the B1 launches."""
    import os
    import shutil
    import tempfile

    from repro_torch.kernels.aaren_scan import aaren_scan
    from repro_torch.models.factory import build
    from repro_torch.obs.events import (
        EventLog,
        read_events,
        use_events,
        validate_events,
    )
    from repro_torch.obs.metrics import MetricsRegistry, use_metrics
    from repro_torch.serving.engine import StreamingEngine

    rng = np.random.default_rng(0)           # phase 4's requests
    lens = rng.integers(32, 257, REQUESTS)
    reqs = [rng.integers(0, cfg.vocab, n) for n in lens]
    api = build(cfg)
    params = api.init(0, device="cuda")
    eng = StreamingEngine(api, params, n_slots=SLOTS, chunk=CHUNK)
    eng.warmup()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_4j_serve_")
    path = os.path.join(tmp, "serve_events.jsonl")
    reg = MetricsRegistry()
    undo = _forbid_plain_on_card()
    try:
        with EventLog(path) as log, use_metrics(reg), use_events(log):
            # The main path: counts from zero, read right after.
            aaren_scan.n_launches = 0
            rids = [eng.submit(p, MAX_NEW) for p in reqs]
            tick_s = []
            while eng.queue or any(s is not None for s in eng.active):
                t1 = time.perf_counter()
                eng.step()
                tick_s.append(time.perf_counter() - t1)
            launches = aaren_scan.n_launches
        recs = read_events(path)
    finally:
        undo()
        shutil.rmtree(tmp, ignore_errors=True)
    validate_events(recs)
    tokens = [eng.finished[r] for r in rids]
    _require(tokens == ref["tokens"], "instrumented serving tokens differ "
             "from phase 4's")
    _require(launches == cfg.n_layers * len(tick_s),
             f"B1 launched {launches} times over {len(tick_s)} ticks")
    _require(eng.submitted_at == {} and eng.first_token_at == {},
             "latency maps not empty")
    kinds = [r["kind"] for r in recs]
    _require(all(kinds.count(k) == REQUESTS for k in (
        "request_submitted", "first_token", "request_completed")),
        "missing request events")
    snap = reg.snapshot()
    _require(snap["counters"]["serve_requests_completed_total"]["value"]
             == REQUESTS, "serve_requests_completed_total")
    ttft, itl = reg.histogram("serve_ttft_s"), reg.histogram("serve_itl_s")
    tick_ms = statistics.median(tick_s) * 1e3
    print(f"  instrumented serving: tokens equal phase 4's ({REQUESTS} "
          f"requests), event log of {len(recs)} records valid; {launches} "
          f"B1 launches = {cfg.n_layers} x {len(tick_s)} ticks")
    print(f"  TTFT p50 <= {ttft.quantile(0.5)} s, p99 <= "
          f"{ttft.quantile(0.99)} s over {ttft.count}; ITL p50 <= "
          f"{itl.quantile(0.5)} s, p99 <= {itl.quantile(0.99)} s over "
          f"{itl.count} (histogram bucket bounds); tick median "
          f"{tick_ms:.3f} ms against phase 4's {ref['tick_ms']:.3f} ms"
          f"  [{card}]")
    return launches


PROXIES = ("bench_rl", "bench_events", "bench_tsf", "bench_tsc")
SCAN_KERNELS = ("aaren_scan", "aaren_scan_bwd")
FLASH_KERNELS = ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv")


def _counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.aaren_scan import aaren_scan
    from repro_torch.kernels.aaren_scan_bwd import aaren_scan_bwd

    return {"aaren_scan": aaren_scan, "aaren_scan_bwd": aaren_scan_bwd,
            "flash_attention": fa.flash_attention,
            "flash_bwd_dq": fa.flash_bwd_dq, "flash_bwd_dkv": fa.flash_bwd_dkv}


def phase4h_tasks(torch, np, card: str):
    """The four paper-table proxies (``benchmarks/torch/bench_*.py``) as
    their ``run`` drives them: both mixers at the JAX modules' step counts
    and sizes, on the card.  Per proxy, counts zeroed just before and read
    just after: Aaren runs B1 and B2, softmax B3, B4 and B5, each launch
    accounted for (2 layers a forward and a backward per training step,
    2 layers per evaluation forward); no plain version is reached with a
    CUDA tensor.  Each mode's metric must be finite and its last training
    loss below its first; the Aaren-vs-Transformer relgap is printed, not
    gated.  Each kernel is held against its plain version on inputs
    captured in each proxy's first training step.  Returns ({kernel:
    launches over the four proxies}, {kernel: max |err| on the captured
    inputs})."""
    import importlib

    from repro_torch.kernels import ops

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    counters = _counts()
    total = dict.fromkeys(counters, 0)
    errs = dict.fromkeys(counters, 0.0)
    real = {name: getattr(ops, name) for name in
            ("aaren_scan", "aaren_scan_bwd", "flash_attention_bwd")}
    for proxy in PROXIES:
        mod = importlib.import_module(f"benchmarks.torch.{proxy}")
        captured = {}

        def spy(name):
            def wrapped(*args, **kw):
                if name not in captured:
                    captured[name] = ([a.clone() for a in args], dict(kw))
                return real[name](*args, **kw)
            return wrapped

        for name in real:
            setattr(ops, name, spy(name))
        undo = _forbid_plain_on_card()
        for counter in counters.values():
            counter.n_launches = 0
        tp = time.perf_counter()
        try:
            results = mod.run("cuda")
        finally:
            for name, fn in real.items():
                setattr(ops, name, fn)
            undo()
        launches = {name: c.n_launches for name, c in counters.items()}
        seconds = time.perf_counter() - tp
        steps = mod.STEPS
        evals = mod.T * 16 if proxy == "bench_rl" else 1  # forwards
        want_fwd = 2 * steps + 2 * evals
        want = {"aaren_scan": want_fwd, "aaren_scan_bwd": 2 * steps,
                "flash_attention": want_fwd, "flash_bwd_dq": 2 * steps,
                "flash_bwd_dkv": 2 * steps}
        _require(launches == want, f"{proxy}: launches {launches}, want "
                 f"{want}")
        for mode, r in results.items():
            _require(bool(np.isfinite([r["metric"]] + r["losses"]).all()),
                     f"{proxy} {mode}: metric {r['metric']}, losses not "
                     "finite")
            _require(r["losses"][-1] < r["losses"][0],
                     f"{proxy} {mode}: training loss {r['losses'][0]:.4f} "
                     f"-> {r['losses'][-1]:.4f} did not fall")
            print(f"  {proxy} {mode}: metric {r['metric']:.4f}, training "
                  f"loss {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f} over "
                  f"{steps} steps, {r['per_step'] * 1e3:.3f} ms a step  "
                  f"[{card}]")
        print(f"  {proxy}: launches aaren B1 {launches['aaren_scan']}, B2 "
              f"{launches['aaren_scan_bwd']}; softmax B3 "
              f"{launches['flash_attention']}, B4 {launches['flash_bwd_dq']},"
              f" B5 {launches['flash_bwd_dkv']} (= 2 layers x {steps} steps "
              f"+ 2 x {evals} evaluation forwards); no plain version reached "
              f"a CUDA tensor; {seconds:.1f} s")
        total = {name: total[name] + launches[name] for name in total}

        label = f"{proxy} step 0 (captured)"
        b1_args, _ = captured["aaren_scan"]
        errs["aaren_scan"] = max(errs["aaren_scan"], _compare_scan_residuals(
            torch, b1_args, label))
        b2_args, _ = captured["aaren_scan_bwd"]
        errs["aaren_scan_bwd"] = max(errs["aaren_scan_bwd"], _compare_bwd(
            torch, b2_args, label))
        (q, k, v, _, _, do), kw = captured["flash_attention_bwd"]
        _require(kw.get("q_lens") is None and kw.get("window") is None
                 and kw.get("q_segment_ids") is None and kw.get("causal"),
                 f"{proxy}: flash call {sorted(kw)}")
        got = _check_flash(torch, q, k, v, do, None, True, None, label)
        errs = {name: max(val, got.get(name, 0.0))
                for name, val in errs.items()}
    return total, errs


# The example's own default is 300 steps; 100 keep the whole run inside half
# of its time limit beside phase 4j's checkpoint I/O.
TRAIN_LM_STEPS = 100


def phase4i_examples(torch, np, card: str) -> None:
    """The four examples of ``examples/torch`` on the card, in process:
    quickstart (its loss must fall), chunked prefill (its one-shot ==
    chunked check is a gate), streaming inference, and ``train_lm`` at its
    full width (the ~100M configuration, both mixers) for TRAIN_LM_STEPS
    steps.  Each example's kernel launches are printed; no plain version
    is reached with a CUDA tensor."""
    import importlib

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    counters = _counts()
    runs = (("quickstart", []), ("chunked_prefill", []),
            ("streaming_inference", []),
            ("train_lm", ["--steps", str(TRAIN_LM_STEPS)]))
    for name, argv in runs:
        mod = importlib.import_module(f"examples.torch.{name}")
        print(f"  -- examples/torch/{name}.py {' '.join(argv)}", flush=True)
        for counter in counters.values():
            counter.n_launches = 0
        undo = _forbid_plain_on_card()
        te = time.perf_counter()
        try:
            out = mod.main(argv)
        finally:
            undo()
        launches = ", ".join(f"{k} {c.n_launches}"
                             for k, c in counters.items())
        print(f"  examples/torch/{name}.py: {time.perf_counter() - te:.1f} s;"
              f" launches {launches}  [{card}]")
        if name == "quickstart":
            _require(out["last_loss"] < out["first_loss"],
                     f"quickstart: loss {out['first_loss']} -> "
                     f"{out['last_loss']} did not fall")
        elif name == "train_lm":
            for mode, hist in out.items():
                _require(all(np.isfinite(m["loss"]) for _, m in hist),
                         f"train_lm {mode}: non-finite loss")


# Phases 4l and 4m: a drain after EVENT_TICK engine ticks and a snapshot
# EVENT_TICK ticks later; LONG_WARM + LONG_MEASURED steps of each training.
EVENT_TICK = 80
LONG_WARM, LONG_MEASURED = 1, 2


def _small_configs(torch, np, archs, seed: int) -> None:
    """The smoke configs of ``archs``, in each mode they have (an SSM model
    has no attention, so one), f32: greedy tokens on the card (kernels)
    equal to the CPU's (plain versions) — the streaming engine at its
    default chunk where the model streams (Aaren mode), and ``generate``
    in every mode (past the window where the model has one) — the loss,
    its MoE metrics and every gradient within phase 3's bars, and for a
    model whose optimizer is AdaFactor (dbrx, beside its LayerNorm) three
    steps within phase 3's step bar.  Each mode's kernels must launch, and
    no others: none for an SSM model.  The prompts are made from ``seed``
    and the training batch from ``seed + 1``."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.factory import build
    from repro_torch.serving.engine import StreamingEngine, generate
    from repro_torch.train.optim import make_optimizer, warmup_cosine
    from repro_torch.train.state import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    counters = _counts()
    for arch in archs:
        ssm = smoke_config(arch).family == "ssm"
        for mode in (("aaren",) if ssm else ("aaren", "softmax")):
            small = build(smoke_config(arch, attn_mode=mode))
            cpu_params = small.init(0, device="cpu")
            prompts = np.random.default_rng(seed).integers(
                0, small.cfg.vocab, (3, 12))
            batch = np.random.default_rng(seed + 1).integers(
                0, small.cfg.vocab, (2, 24))
            before = {k: c.n_launches for k, c in counters.items()}
            toks, gen, metrics, grads, steps = {}, {}, {}, {}, {}
            for dev in ("cpu", "cuda"):
                params = _to(cpu_params, dev)
                if mode == "aaren":
                    eng = StreamingEngine(small, params, n_slots=2)
                    rids = [eng.submit(p[:n], 5)
                            for p, n in zip(prompts, (12, 5, 1))]
                    res = eng.run()
                    toks[dev] = [res[r] for r in rids]
                gen[dev] = generate(small, params, prompts, 5)[0].tolist()
                leaves = tree_leaves(params)
                for p in leaves:
                    p.requires_grad_(True)
                loss, m = small.loss(params, {
                    "tokens": torch.from_numpy(batch).to(dev)})
                grads[dev] = torch.autograd.grad(loss, leaves)
                metrics[dev] = {k: float(v) for k, v in m.items()}
                if small.cfg.optimizer == "adafactor":
                    opt = make_optimizer("adafactor",
                                         warmup_cosine(3e-3, 1, 3))
                    state = init_train_state(_to(cpu_params, dev), opt)
                    step = make_train_step(small.loss, opt)
                    steps[dev] = []
                    for _ in range(3):
                        state, m = step(state, {"tokens": batch})
                        steps[dev].append(m["loss"].item())
            launched = {k: c.n_launches - before[k]
                        for k, c in counters.items()}
            kernels = (() if ssm else
                       ("aaren_scan", "aaren_scan_bwd") if mode == "aaren"
                       else ("flash_attention", "flash_bwd_dq",
                             "flash_bwd_dkv"))
            what = f"small {arch} {mode}"
            _require(all((launched[k] > 0) == (k in kernels)
                         for k in launched),
                     f"{what}: launches {launched}, want {kernels} only")
            _require(toks.get("cpu") == toks.get("cuda"), f"{what}: engine "
                     f"tokens on the card {toks.get('cuda')} != on the CPU "
                     f"{toks.get('cpu')}")
            _require(gen["cpu"] == gen["cuda"], f"{what}: generate's tokens"
                     f" on the card {gen['cuda']} != on the CPU {gen['cpu']}")
            rel = max(abs(metrics["cuda"][k] - metrics["cpu"][k])
                      / max(abs(metrics["cpu"][k]), 1e-6)
                      for k in metrics["cpu"])
            _require(rel <= 1e-5, f"{what}: loss metrics on the card "
                     f"{metrics['cuda']} != on the CPU {metrics['cpu']}")
            gerr = 0.0
            for a, b in zip(grads["cuda"], grads["cpu"]):
                scale = b.abs().max().item()
                err = (a.cpu() - b).abs().max().item()
                _require(err <= TOL["rtol"] * scale + 1e-6, f"{what}: a "
                         f"gradient differs by {err:.3e} (max |CPU| "
                         f"{scale:.3e}) between the card and the CPU")
                gerr = max(gerr, err / max(scale, 1e-6))
            srel = ""
            if steps:
                s = max(abs(a - b) / abs(b)
                        for a, b in zip(steps["cuda"], steps["cpu"]))
                _require(s <= 1e-4, f"{what}: AdaFactor step losses on the "
                         f"card {steps['cuda']} != on the CPU {steps['cpu']}")
                srel = f"; 3 AdaFactor step losses within {s:.2e} relative"
            print(f"  {what}: greedy tokens on the card == on the CPU "
                  f"({'engine and ' if toks else ''}generate); loss "
                  f"metrics |card - CPU| / CPU <= {rel:.2e}"
                  + (f" (dropped_frac {metrics['cpu']['dropped_frac']:.3f})"
                     if small.cfg.n_experts else "") + "; "
                  f"{len(grads['cpu'])} gradients within {gerr:.2e} of max "
                  f"|CPU|{srel}; launches "
                  + (", ".join(f"{k} {launched[k]}" for k in kernels)
                     or "none"))


def _serve_full(torch, np, card, api, params, label, n_scan, state_bytes):
    """Phase 4's ``REQUESTS`` prompts (32-256 tokens, seed 0) through the
    ``StreamingEngine`` at ``SLOTS`` slots and the model's default chunk,
    ``MAX_NEW`` new tokens each, greedy.  B1's inputs of one tick are held
    against its plain version (when the model has ``n_scan`` Aaren layers);
    then every count is zeroed just before the run and read just after: B1
    ``n_scan`` a tick, nothing else, and no plain version reached with a
    CUDA tensor.  Prints tick median, tok/s and the decode state a slot
    (which must be ``state_bytes``), then a profile of 5 ticks; then a drain
    (export + inject) after ``EVENT_TICK`` ticks and a snapshot restored
    into a fresh engine ``EVENT_TICK`` ticks later, every request's
    tokens bit-equal to the undisturbed run.  Returns (B1 launches, B1's
    captured serving inputs or None, max |err| of B1 on them)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import StreamingEngine, decode_state_bytes

    rng = np.random.default_rng(0)
    lens = rng.integers(32, 257, REQUESTS)
    reqs = [rng.integers(0, api.cfg.vocab, n) for n in lens]
    captured, err = [], 0.0
    if n_scan:          # B1's inputs of one real tick (not counted)
        real_scan = ops.aaren_scan

        def capture(*args, **kw):
            captured.append([a.clone() for a in args])
            return real_scan(*args, **kw)

        cap = StreamingEngine(api, params, n_slots=SLOTS)
        for p in reqs[:SLOTS]:
            cap.submit(p, MAX_NEW)
        ops.aaren_scan = capture
        try:
            cap.step()
        finally:
            ops.aaren_scan = real_scan
        _require(len(captured) == n_scan,
                 f"captured {len(captured)} scans, want {n_scan}")
        for i in (0, n_scan - 1):
            err = max(err, _compare_scan(
                torch, captured[i], f"{label} serving tick, Aaren layer {i}"))
        del cap

    eng = StreamingEngine(api, params, n_slots=SLOTS)
    print(f"  engine warm-up {eng.warmup():.2f} s")
    counters = _counts()
    undo = _forbid_plain_on_card()
    # The main path: counts from zero, read right after.
    for c in counters.values():
        c.n_launches = 0
    try:
        rids = [eng.submit(p, MAX_NEW) for p in reqs]
        tick_s = []
        ts = time.perf_counter()
        while eng.queue or any(s is not None for s in eng.active):
            t1 = time.perf_counter()
            eng.step()
            tick_s.append(time.perf_counter() - t1)
        serve_s = time.perf_counter() - ts
    finally:
        undo()
    launches = {k: c.n_launches for k, c in counters.items()}
    ticks = len(tick_s)
    _require(not eng.errors and eng.n_quarantined == 0,
             f"errors {eng.errors}, quarantined {eng.n_quarantined}")
    _require(all(len(eng.finished[r]) == MAX_NEW for r in rids),
             "a request did not return max_new tokens")
    want = dict.fromkeys(launches, 0)
    want["aaren_scan"] = n_scan * ticks
    _require(launches == want, f"launches {launches}, want {want}")
    ref = [eng.finished[r] for r in rids]
    served = sum(map(len, ref))
    per_slot = decode_state_bytes(eng.states) // SLOTS
    tick_ms = statistics.median(tick_s) * 1e3
    print(f"  {label}: served {len(rids)} requests / {served} tokens in "
          f"{ticks} ticks (chunk {eng.chunk}), {serve_s:.3f} s: tick median "
          f"{tick_ms:.3f} ms, {served / serve_s:.1f} tok/s; B1 launches "
          f"{launches['aaren_scan']} = {n_scan} x {ticks}, no other kernel "
          f"and no plain version; decode state {per_slot} B a slot  [{card}]")
    _require(per_slot == state_bytes,
             f"decode state {per_slot} B a slot, want {state_bytes}")
    for p in reqs[:SLOTS]:
        eng.submit(p, MAX_NEW)
    eng.step()
    _print_profile(_device_profile(torch, eng.step, 5), f"{label} tick (5 "
                   "ticks)", card)
    eng.run()
    del eng

    src = StreamingEngine(api, params, n_slots=SLOTS)
    rids = [src.submit(p, MAX_NEW) for p in reqs]
    for _ in range(EVENT_TICK):
        src.step()
    dst = StreamingEngine(api, params, n_slots=SLOTS)
    tm = time.perf_counter()
    descs = src.export_requests()
    for desc in descs:
        dst.inject_request(desc)
    torch.cuda.synchronize()
    move_ms = (time.perf_counter() - tm) * 1e3
    for _ in range(EVENT_TICK):
        dst.step()
    snap = dst.snapshot()
    fresh = StreamingEngine(api, params, n_slots=SLOTS)
    fresh.restore(snap)
    fresh.run()
    done = {**src.finished, **dst.finished, **fresh.finished}
    _require([done[r] for r in rids] == ref, f"{label} drain + snapshot: "
             "tokens differ from the undisturbed run")
    print(f"  {label}: drain after {EVENT_TICK} ticks: {len(descs)} "
          f"requests exported + injected in {move_ms:.3f} ms; snapshot "
          f"{EVENT_TICK} ticks later restored into a fresh engine: every "
          f"request's tokens bit-equal to the undisturbed run  [{card}]")
    return launches["aaren_scan"], (captured[0] if captured else None), err


def _train_full(torch, np, card, cfg, label, batch, seq_len, want, *,
                mfu_params=None, mfu_label="MFU"):
    """``LONG_WARM`` + ``LONG_MEASURED`` steps of ``cfg`` (AdamW, its remat)
    through ``make_train_step`` and ``run_train_loop`` on
    ``SyntheticLMIterator`` batches of ``batch`` x ``seq_len`` tokens.
    Counts zeroed just before and read just after must equal ``want`` a
    step (every other kernel 0), and no plain version may see a CUDA
    tensor.  Prints each step's loss and grad norm (and the MoE metrics),
    the step median, tokens/s, MFU (6 x ``mfu_params``, default every
    parameter, x tokens over the bf16 peak), peak memory and a profile of
    one more step.  Returns ({kernel: launches}, the first step's first
    captured call of each kernel, {"step_ms", "peak"})."""
    from repro_torch.data.synthetic import SyntheticLMIterator
    from repro_torch.kernels import ops
    from repro_torch.models.factory import build
    from repro_torch.models.param import count_params
    from repro_torch.train.loop import LoopConfig, run_train_loop
    from repro_torch.train.optim import make_optimizer, warmup_cosine
    from repro_torch.train.state import init_train_state, make_train_step

    _require((cfg.remat, cfg.optimizer) == ("block", "adamw"), str(cfg))
    api = build(cfg)
    n_params = count_params(api.specs())
    steps = LONG_WARM + LONG_MEASURED
    ti = time.perf_counter()
    params = api.init(0, device="cuda")
    opt = make_optimizer(cfg.optimizer, warmup_cosine(3e-4, 1, steps))
    state = init_train_state(params, opt)
    step_fn = make_train_step(api.loss, opt, max_grad_norm=1.0)
    torch.cuda.synchronize()
    print(f"  {label}: {cfg.n_layers} layers, {n_params / 1e9:.3f} B params, "
          f"init {time.perf_counter() - ti:.2f} s: params + AdamW moments "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on card")
    data = SyntheticLMIterator(vocab=cfg.vocab, seq_len=seq_len, batch=batch,
                               seed=0)
    names = ((("aaren_scan", "aaren_scan_bwd") if "aaren_scan" in want
              else ()) + (("flash_attention", "flash_attention_bwd")
                          if "flash_attention" in want else ()))
    reals = {n: getattr(ops, n) for n in names}
    captured = {}

    def spy(name):
        def wrapped(*args, **kw):
            if name not in captured:
                captured[name] = ([a.clone() for a in args], dict(kw))
            return reals[name](*args, **kw)
        return wrapped

    losses, finite = [], {"ok": True}

    def on_log(step, m):
        finite["ok"] &= bool(np.isfinite(m["loss"])
                             and np.isfinite(m["grad_norm"]))
        losses.append(m["loss"])
        moe = (f" load_balance_loss {m['load_balance_loss']:.4f} "
               f"dropped_frac {m['dropped_frac']:.4f}"
               if cfg.n_experts else "")
        print(f"  step {step}: loss {m['loss']:.4f} grad_norm "
              f"{m['grad_norm']:.4f}{moe} {m['step_time_s'] * 1e3:.1f} ms")

    counters = _counts()
    for n in names:
        setattr(ops, n, spy(n))
    undo = _forbid_plain_on_card()
    torch.cuda.reset_peak_memory_stats()
    # The main path: counts from zero, read right after.
    for c in counters.values():
        c.n_launches = 0
    try:
        result = run_train_loop(step_fn, state, data,
                                LoopConfig(total_steps=steps, log_every=1),
                                on_log=on_log)
    finally:
        for n in names:
            setattr(ops, n, reals[n])
        undo()
    launches = {k: c.n_launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    _require(finite["ok"], f"non-finite loss or grad norm: {losses}")
    _require(result.state.step == steps, f"ran {result.state.step} steps")
    want = {k: want.get(k, 0) * steps for k in launches}
    _require(launches == want, f"launches {launches}, want {want}")
    step_s = [m["step_time_s"] for _, m in result.history[LONG_WARM:]]
    step_ms = statistics.median(step_s) * 1e3
    tokens = batch * seq_len
    mfu = (6 * (mfu_params or n_params) * tokens / (step_ms / 1e3)
           / BF16_DENSE_FLOPS)
    print(f"  {label} training {batch} x {seq_len}: step median "
          f"{step_ms:.3f} ms ({', '.join(f'{s * 1e3:.1f}' for s in step_s)}"
          f" ms), {tokens / (step_ms / 1e3):.1f} tokens/s, {mfu_label} "
          f"{mfu:.2%}, peak memory {peak / 2**30:.2f} GiB; launches "
          + (", ".join(f"{k} {v}" for k, v in launches.items() if v)
             or "none") + f"  [{card}]")
    train_state = {"state": result.state}
    batch_ = next(data)

    def one_step():
        train_state["state"], _ = step_fn(train_state["state"], batch_)

    _print_profile(_device_profile(torch, one_step, 1),
                   f"{label} training step", card, top=12)
    del train_state, result, state, params
    gc.collect()
    torch.cuda.empty_cache()
    return ({k: v for k, v in launches.items() if v}, captured,
            {"step_ms": step_ms, "peak": peak})


HYBRID = "recurrentgemma-9b"
HY_GEN_B, HY_GEN_P, HY_GEN_NEW = 2, 2304, 16
HY_TRAIN_LAYERS, HY_TRAIN_N = 12, 4096
# (b): decode's logits against the full forward's, as a fraction of the
# step's largest logit.  The bf16 38-layer run reads 6.21e-2 (GEMV against
# GEMM in bf16, the bf16 KV ring against flash's f32-accumulated tiles).
# The f32 control below reads 8.4e-5 on an H100 with the same decode path,
# so that gap is bf16 rounding, and the bf16 bar is twice its reading.
HY_GEN_RTOL = 0.125
# The f32 control: full width, 6 layers (two attn_local layers), f32
# weights and compute; what is left is the bf16 rounding of the KV ring.
# At reduced width on the CPU a sound decode reads 1.5e-4 and one whose
# ring is laid out oldest first (the reference's layout) 8.6e-3.
HY_F32_LAYERS = 6
HY_F32_RTOL = 1e-3
# A ring slot's head vector against the forward's: a bf16 spacing is 2^-8
# of it at worst; a slot holding another position's key is off by ~1.4.
HY_F32_RING = 2.0 ** -6
SMALL_ARCHS = ("recurrentgemma-9b", "gemma3-27b", "llama3-405b",
               "minitron-8b")


def _n_mixers(cfg, kind: str) -> int:
    from repro_torch.models.lm import layer_sigs

    return sum(sig[0] == kind for sig in layer_sigs(cfg))


def phase4l_hybrid_serving(torch, np, card: str):
    """(a) Aaren-mode serving of the full-width ``recurrentgemma-9b``
    (:func:`_serve_full`, chunk 1).  Returns (B1 launches, B1's captured
    serving inputs, max |err| of B1 on them, (api, params))."""
    from repro_torch.configs import get_config
    from repro_torch.models.factory import build
    from repro_torch.models.param import count_params
    from repro_torch.serving.engine import StreamingEngine

    cfg = get_config(HYBRID)
    _require((cfg.family, cfg.attn_mode, cfg.param_dtype, cfg.compute_dtype,
              cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
              cfg.resolved_head_dim, cfg.d_rnn, cfg.window, cfg.vocab)
             == ("hybrid", "aaren", "bfloat16", "bfloat16", 38, 4096, 16, 1,
                 256, 4096, 2048, 256000), str(cfg))
    api = build(cfg)
    n_aaren = _n_mixers(cfg, "aaren")
    _require(n_aaren == 12 and _n_mixers(cfg, "rglru") == 26,
             f"pattern {cfg.effective_pattern()}")
    ti = time.perf_counter()
    params = api.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = count_params(api.specs())
    print(f"  {HYBRID} init {time.perf_counter() - ti:.2f} s: "
          f"{n_params / 1e9:.3f} B params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on card")
    chunk = StreamingEngine(api, params, n_slots=SLOTS).chunk
    _require(chunk == 1, f"a hybrid engine's chunk is {chunk}")
    launches, b1_args, err = _serve_full(
        torch, np, card, api, params, "hybrid (a)", n_aaren,
        26 * 40960 + 12 * 16512)
    return launches, b1_args, err, (api, params)


def _recording_greedy(steps: list):
    """A greedy sampler that keeps each step's logits in ``steps``."""
    from repro_torch.serving.sampler import greedy_sampler

    def sample(logits, seeds):
        steps.append(logits[:, 0].float())
        return greedy_sampler(logits, seeds)

    sample.batched = True
    sample.uses_seeds = False
    return sample


def _decode_against_forward(torch, cfg, params, prompts, toks, steps, *,
                            rings: bool = False, with_last: bool = False):
    """``generate``'s per-step logits (``steps``, one (B, V) a step) against
    the full forward over prompt + generated tokens.  Returns, each (B,
    new) on the host: |decode - forward| over the vocabulary as a fraction
    of the step's largest logit, whether the token is the forward's argmax,
    whether the forward's top-2 margin is within twice that disagreement
    (the least a flip needs), the margin and the disagreement; and, with
    ``rings``, the forward's per-layer states, each window layer's KV ring
    laid out as ``generate`` keeps it.  ``with_last``: the forward also
    runs over the last generated token (its logits unused), for a model that
    takes only some lengths (the chunked SSD: up to 256 or a multiple)."""
    from repro_torch.models import lm

    dev = steps[0].device
    toks = toks.to(dev)
    seq = torch.cat([torch.as_tensor(prompts, device=dev),
                     toks if with_last else toks[:, :-1]], dim=1)
    with torch.inference_mode():
        full, states = lm.lm_apply(cfg, params, seq, collect_state=rings,
                                   cache_len=cfg.window if rings else None)
    full = full[:, prompts.shape[1] - 1:][:, :toks.shape[1]]
    dec = torch.stack(steps, dim=1)                       # (B, new, V)
    delta = (dec - full).abs().amax(dim=-1)
    rel = delta / full.abs().amax(dim=-1)
    top2 = full.topk(2, dim=-1)
    margin = top2.values[..., 0] - top2.values[..., 1]
    agree = top2.indices[..., 0] == toks
    return (rel.cpu(), agree.cpu(), (margin <= 2 * delta).cpu(),
            margin.cpu(), delta.cpu(), states)


def phase4l_hybrid_generate(torch, np, card: str, api, params):
    """(b) Softmax-mode ``generate`` of the full-width ``recurrentgemma-9b``
    past its window, on (a)'s parameters (the Aaren query tokens go
    unread).  Every step's logits are held against the full forward over
    prompt + generated tokens (:func:`_decode_against_forward`): within
    ``HY_GEN_RTOL`` of the step's largest logit, and a token differs from
    the forward's argmax only where the two paths' disagreement allows a
    flip.  Returns (B3 launches, B3's captured prefill call {"args",
    "kw"})."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.factory import build
    from repro_torch.serving.engine import decode_state_bytes, generate

    soft = build(api.cfg.replace(attn_mode="softmax"))
    cfg = soft.cfg
    n_local = _n_mixers(cfg, "attn_local")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab,
                                                (HY_GEN_B, HY_GEN_P))
    steps = []
    prefill = {}
    real_fwd = ops.flash_attention

    def capture_fwd(*args, **kw):
        if not prefill:
            prefill["args"] = [a.clone() for a in args]
            prefill["kw"] = dict(kw)
        return real_fwd(*args, **kw)

    ops.flash_attention = capture_fwd
    try:
        generate(soft, params, prompts, 2)       # warm-up, and B3's inputs
    finally:
        ops.flash_attention = real_fwd
    torch.cuda.synchronize()
    undo = _forbid_plain_on_card()
    # The main path: counts from zero, read right after.
    fa.flash_attention.n_launches = 0
    fa.flash_bwd_dq.n_launches = fa.flash_bwd_dkv.n_launches = 0
    try:
        tg = time.perf_counter()
        toks, states = generate(soft, params, prompts, HY_GEN_NEW,
                                sampler=_recording_greedy(steps))
        gen_s = time.perf_counter() - tg
    finally:
        undo()
    gen = (fa.flash_attention.n_launches, fa.flash_bwd_dq.n_launches,
           fa.flash_bwd_dkv.n_launches)
    _require(gen == (n_local, 0, 0), f"generate launched B3/B4/B5 {gen} "
             f"times, want ({n_local}, 0, 0): one prefill")
    _require(tuple(toks.shape) == (HY_GEN_B, HY_GEN_NEW),
             f"generate returned {tuple(toks.shape)}")
    kv = [st for st in states if "k" in st]
    _require(len(kv) == n_local and all(
        st["k"].shape[1] == cfg.window
        and int(st["index"]) == HY_GEN_P + HY_GEN_NEW - 1 for st in kv),
        "the window KV rings do not hold the last window positions")
    kv_bytes = decode_state_bytes([[st["k"], st["v"]] for st in kv])
    rnn_bytes = decode_state_bytes([st for st in states if "h" in st])

    rel, agree, explained, margin, delta, _ = _decode_against_forward(
        torch, cfg, params, prompts, toks, steps)
    print(f"  (b) softmax generate B={HY_GEN_B} P={HY_GEN_P} "
          f"new={HY_GEN_NEW}: {gen_s:.3f} s; B3 launches {gen[0]} (one "
          f"prefill); window KV rings (k, v) {kv_bytes} B "
          f"({kv_bytes // HY_GEN_B} B a row) + RG-LRU states {rnn_bytes} B"
          f"  [{card}]")
    _require(kv_bytes == HY_GEN_B * n_local * cfg.window * cfg.n_kv_heads
             * cfg.resolved_head_dim * 2 * 2, f"KV rings {kv_bytes} B")
    print(f"  (b) against the full forward over prompt + tokens: "
          f"{int(agree.sum())}/{agree.numel()} tokens its argmax; "
          f"|logits - forward's| / max |logit| per step: prefill "
          f"{rel[:, 0].max().item():.2e}, decode max "
          f"{rel[:, 1:].max().item():.2e}, median "
          f"{rel[:, 1:].median().item():.2e}; forward's top-2 margin where "
          f"a token differs: {margin[~agree].tolist()} against twice "
          f"the disagreement {(2 * delta)[~agree].tolist()}")
    _require(bool((agree | explained).all()), "softmax generate: a token "
             "differs from the full forward's argmax by more than the two "
             "paths' disagreement explains")
    _require(rel.max().item() <= HY_GEN_RTOL, f"softmax generate: logits "
             f"{rel.max().item():.3e} of max |logit| from the full forward's")
    return gen[0], prefill, rel.max().item()


def phase4l_generate_f32_control(torch, np, card: str, bf16_rel: float):
    """(b) in f32: ``generate`` as in (b) on the full-width
    ``recurrentgemma-9b`` cut to ``HY_F32_LAYERS`` layers, f32 weights from
    seed 0 and f32 compute, so that only the bf16 rounding of the window
    KV rings is left between decode and the full forward.  The logits must
    stay within ``HY_F32_RTOL`` of the step's largest logit, a token differ
    from the forward's argmax only where that small disagreement allows a
    flip, and every window ring hold, slot for slot, the keys and values
    the full forward's ring holds, each head's vector within
    ``HY_F32_RING`` of its norm: a decode that reads or writes the wrong
    positions fails here, where the bf16 run's rounding would hide it."""
    from repro_torch.configs import get_config
    from repro_torch.models.factory import build
    from repro_torch.serving.engine import generate

    cfg = get_config(HYBRID, n_layers=HY_F32_LAYERS, attn_mode="softmax",
                     param_dtype="float32", compute_dtype="float32")
    tc = time.perf_counter()
    api = build(cfg)
    params = api.init(0, device="cuda")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab,
                                                (HY_GEN_B, HY_GEN_P))
    steps = []
    toks, states = generate(api, params, prompts, HY_GEN_NEW,
                            sampler=_recording_greedy(steps))
    rel, agree, explained, margin, _, fwd = _decode_against_forward(
        torch, cfg, params, prompts, toks, steps, rings=True)
    ring_err = 0.0          # max |ring - forward's| / |forward's|, a head
    for got, want in zip(states, fwd):
        if "k" not in got:
            continue
        _require(int(got["index"]) == int(want["index"]),
                 f"f32 control: ring index {int(got['index'])} against the "
                 f"forward's {int(want['index'])}")
        for key in ("k", "v"):
            a, b = got[key].float(), want[key].float()
            ring_err = max(ring_err, ((a - b).norm(dim=-1)
                                      / b.norm(dim=-1)).max().item())
    print(f"  (b) f32 control, {HY_F32_LAYERS} layers at full width "
          f"({time.perf_counter() - tc:.1f} s): |logits - forward's| / "
          f"max |logit| max {rel.max().item():.3e}, median "
          f"{rel.median().item():.3e} (bf16 38 layers: {bf16_rel:.3e}); "
          f"{int(agree.sum())}/{agree.numel()} tokens the forward's argmax "
          f"(smallest margin {margin.min().item():.3e}); window rings "
          f"against the forward's: |a - b| / |b| over a head's vector at "
          f"most {ring_err:.3e}  [{card}]")
    _require(ring_err <= HY_F32_RING, f"f32 control: a window ring slot is "
             f"{ring_err:.3e} of its norm from the full forward's")
    _require(bool((agree | explained).all()), "f32 control: a token "
             "differs from the full forward's argmax by more than the two "
             "paths' disagreement explains")
    _require(rel.max().item() <= HY_F32_RTOL, f"f32 control: logits "
             f"{rel.max().item():.3e} of max |logit| from the full "
             "forward's")


def phase4l_hybrid_training(torch, np, card: str, mode: str):
    """(c) Training of ``recurrentgemma-9b`` at full width and
    ``HY_TRAIN_LAYERS`` layers in ``mode``, on 1 x ``HY_TRAIN_N`` tokens,
    AdamW, ``remat="block"`` (:func:`_train_full`).  Returns ({kernel:
    launches}, the first step's first captured call of each kernel,
    {"step_ms", "peak"})."""
    from repro_torch.configs import get_config

    cfg = get_config(HYBRID, n_layers=HY_TRAIN_LAYERS, attn_mode=mode)
    n_attn = _n_mixers(cfg, "aaren" if mode == "aaren" else "attn_local")
    want = ({"aaren_scan": 2 * n_attn, "aaren_scan_bwd": n_attn}
            if mode == "aaren" else
            {"flash_attention": 2 * n_attn, "flash_bwd_dq": n_attn,
             "flash_bwd_dkv": n_attn})
    return _train_full(torch, np, card, cfg, f"hybrid {mode}", 1,
                       HY_TRAIN_N, want)


def _scan_row(torch, card, name, label, fn, plain, bound, n_iter,
              plain_iter) -> dict:
    """B1's or B2's row at one shape: device time in a replayed CUDA graph,
    eager call, plain version and ``bound`` ((ms, "bytes" or "operations",
    bytes)); no PyTorch call computes either, so no library time."""
    ms, call_ms, plain_ms, plain_call_ms = _kernel_times(
        torch, fn, plain, n_iter, plain_iter)
    bound_ms, bound_by, nbytes = bound
    print(f"  {name} at {label}: device {ms * 1e3:.3f} us (eager call "
          f"{call_ms * 1e3:.2f} us), plain device {plain_ms * 1e3:.2f} "
          f"us (eager call {plain_call_ms * 1e3:.2f} us), bound "
          f"{bound_ms * 1e3:.3f} us by {bound_by} ({nbytes} B), "
          f"{ms / bound_ms:.2f}x the bound  [{card}]")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def _hybrid_kernel_rows(torch, np, card, serve_cap, train_cap):
    """(d) B1–B5 at the hybrid's shapes against their plain versions, with
    device time, bound and library call: B1 at the serving tick (R = 8 x 16,
    N = 1, d = 256) and with residuals at training (R = 16, N = 4096); B2
    at training; bf16 B3–B5 at training (B = 1, H = 16, G = 1, N = 4096,
    d = 256, window 2048), B3 at the prefill (B = 2, N = 2304), and B3–B5
    at gemma3-27b's local shape (H = 32, G = 16, d = 128, window 1024,
    N = 4096, random inputs).  Returns ({kernel: {shape: row}}, {kernel:
    max |err|})."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.aaren_scan import aaren_scan, aaren_scan_plain
    from repro_torch.kernels.aaren_scan_bwd import (
        aaren_scan_bwd,
        aaren_scan_bwd_plain,
    )

    rows = {k: {} for k in ("aaren_scan", "aaren_scan_bwd", "flash_attention",
                            "flash_bwd_dq", "flash_bwd_dkv")}
    errs = dict.fromkeys(rows, 0.0)

    def scan_row(name, label, fn, plain, bound, n_iter, plain_iter):
        rows[name][label] = _scan_row(torch, card, name, label, fn, plain,
                                      bound, n_iter, plain_iter)

    s, v, m0, u0, w0 = serve_cap["b1"]
    r, n, d = v.shape
    scan_row("aaren_scan", f"serve R={r} N={n} d={d}",
             lambda: aaren_scan(s, v, m0, u0, w0),
             lambda: aaren_scan_plain(s, v, m0, u0, w0),
             _b1_bound(r, n, d, residuals=False), 200, 20)

    (args, kw) = train_cap["aaren"]["aaren_scan"]
    _require(kw.get("segment_starts") is None, f"B1 call {sorted(kw)}")
    errs["aaren_scan"] = _compare_scan_residuals(
        torch, args, "hybrid training step, first Aaren layer")
    s, v, m0, u0, w0 = args
    r, n, d = v.shape
    scan_row("aaren_scan", f"train R={r} N={n} d={d}",
             lambda: aaren_scan(s, v, m0, u0, w0, return_residuals=True),
             lambda: aaren_scan_plain(s, v, m0, u0, w0,
                                      return_residuals=True),
             _b1_bound(r, n, d, residuals=True), 20, 3)
    (bwd, kw) = train_cap["aaren"]["aaren_scan_bwd"]
    errs["aaren_scan_bwd"] = _compare_bwd(
        torch, bwd, "hybrid training step, last Aaren layer")
    scan_row("aaren_scan_bwd", f"train R={r} N={n} d={d}",
             lambda: aaren_scan_bwd(*bwd), lambda: aaren_scan_bwd_plain(*bwd),
             _b2_bound(r, n, d), 20, 3)

    def flash_rows(label, q, k, v, do, window, check_label):
        got = _check_flash(torch, q, k, v, do, None, True, window,
                           check_label)
        for key in errs:
            errs[key] = max(errs[key], got.get(key, 0.0))
        for name, row in flash_kernel_times(torch, q, k, v, do, None, True,
                                            window, card,
                                            plain_iter=2).items():
            rows[name][label] = {key: row[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "tflops")}

    (fwd_args, kw) = train_cap["softmax"]["flash_attention"]
    (bwd_args, bkw) = train_cap["softmax"]["flash_attention_bwd"]
    q, k, v, o, lse, do = bwd_args
    _require(bkw.get("window") == 2048 and bkw.get("q_lens") is None
             and q.dtype == torch.bfloat16,
             f"the hybrid's flash backward call: {sorted(bkw)}")
    b, h, n_q, d = q.shape
    flash_rows(f"train B={b} H={h} G={k.shape[1]} N={n_q} d={d} window "
               "2048", q, k, v, do, 2048,
               "hybrid softmax training step, an attn_local layer")
    qp, kp, vp = serve_cap["b3"]["args"][:3]
    _require(serve_cap["b3"]["kw"].get("window") == 2048,
             f"prefill flash call: {serve_cap['b3']['kw']}")
    dop = torch.randn_like(qp)
    b, h, n_q, d = qp.shape
    label = f"prefill B={b} H={h} G={kp.shape[1]} N={n_q} d={d} window 2048"
    got = _check_flash(torch, qp, kp, vp, dop, None, True, 2048,
                       "hybrid softmax generate prefill, first attn_local "
                       "layer")
    for key in errs:
        errs[key] = max(errs[key], got.get(key, 0.0))
    row = flash_kernel_times(torch, qp, kp, vp, dop, None, True, 2048, card,
                             plain_iter=2)["flash_attention"]
    rows["flash_attention"][label] = {key: row[key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "tflops")}
    q, k, v, do = _flash_inputs(torch, np, 1, 32, 16, 4096, 128, "bfloat16",
                                seed=400)
    flash_rows("gemma3-27b local B=1 H=32 G=16 N=4096 d=128 window 1024",
               q, k, v, do, 1024, "gemma3-27b local shape (random inputs)")
    return rows, errs


def phase4l_hybrid(torch, np, card: str):
    """Phase 4l: (e) the four A10a smoke configs card against CPU, (a)–(b)
    full-width recurrentgemma-9b serving, (c) its training in both modes at
    12 layers, (d) B1–B5 at its shapes.  Returns ({kernel: {"serve_hybrid":
    n, "train_hybrid": n}}, {kernel: {shape: row}}, {kernel: max |err|})."""
    _small_configs(torch, np, SMALL_ARCHS, 120)
    gc.collect()
    torch.cuda.empty_cache()
    b1_serve, b1_args, b1_err, (api, params) = phase4l_hybrid_serving(
        torch, np, card)
    b3_serve, b3_call, bf16_rel = phase4l_hybrid_generate(
        torch, np, card, api, params)
    serve_launches = {"aaren_scan": b1_serve, "flash_attention": b3_serve}
    serve_cap = {"b1": b1_args, "b3": b3_call}
    del api, params
    gc.collect()
    torch.cuda.empty_cache()
    phase4l_generate_f32_control(torch, np, card, bf16_rel)
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, train_cap = {}, {}
    for mode in ("aaren", "softmax"):
        launches, train_cap[mode], _ = phase4l_hybrid_training(
            torch, np, card, mode)
        train_launches.update(launches)
        gc.collect()
        torch.cuda.empty_cache()
    rows, errs = _hybrid_kernel_rows(torch, np, card, serve_cap, train_cap)
    errs["aaren_scan"] = max(errs["aaren_scan"], b1_err)
    by_path = {k: {"serve_hybrid": serve_launches.get(k, 0),
                   "train_hybrid": train_launches.get(k, 0)} for k in rows}
    return by_path, rows, errs



SSM = "mamba2-1.3b"
MOE = "qwen3-moe-30b-a3b"
SSM_MOE_SMALL = ("mamba2-1.3b", "qwen3-moe-30b-a3b", "dbrx-132b")
# (b): mamba2's generate.  Three 256-token SSD chunks of prompt (so the
# inter-chunk scan runs), and 256 new tokens: the forward over prompt +
# output is 1024 tokens, a length the chunked SSD takes.
MB_GEN_B, MB_GEN_P, MB_GEN_NEW = 2, 768, 256
MB_SHORT_P, MB_SHORT_NEW = (1, 2), 16     # the reference's short conv tails
MB_TRAIN_LAYERS = 48
# The f32 controls: full width, cut depth, f32 weights and compute, so no
# bf16 is left between decode and the full forward; for qwen3-moe
# capacity_factor E / k = 16 leaves every expert room for every token, so
# decode and the forward route alike.  The bars, as fractions of a step's
# largest logit, from CPU readings at reduced width (d_model 512; mamba2 16
# SSD heads, 6 layers, P = 768 + 256 new; qwen3-moe 8 x 128 heads, 1 kv
# head, 32 experts top-8, 4 layers, P = 128 + 8 new): a sound mamba2
# decode reads 2.97e-05 (P = 1 and 2: 4.6e-06), one that loses its conv
# tail (as the reference's short tail does) 1.8; a sound qwen3-moe decode
# reads 6.9e-07, the same at capacity factor 1.25 (so that decode and the
# forward drop different tokens) 2.0e-03.
MB_F32_LAYERS = 6
MB_F32_RTOL = 1e-3
# (b) in bf16: decode's logits against the full forward's, as a fraction of
# the step's largest logit.  The 48-layer run reads 0.214 at most (median
# 0.102; NVIDIA H100 80GB HBM3, 700 W), and the bar is twice that.  The
# same weights' f32 forward tells rounding from a decode fault: decode must
# be no farther from it than MB_GEN_EXACT times the bf16 forward is.  On
# that card both read 0.157 of the largest logit from it (median), and the
# residual stream's bf16 drift grows with depth, from 0.66 % after layer 1
# to 16.6 % after layer 48: the gap is bf16 rounding, not decode.
MB_GEN_RTOL = 0.43
MB_GEN_EXACT = 2.0
MB_DRIFT_AT = (1, 6, 12, 24, 48)
MOE_F32_LAYERS = 4
MOE_F32_CF = 16.0
MOE_F32_RTOL = 1e-4
MOE_TRAIN_LAYERS = 4
# Decode state a slot: 48 x (s (64, 64, 128) f32 + conv (3, 4352) bf16);
# 48 x an Aaren carry of 32 heads x (128 + 2) f32.
MB_STATE_BYTES = 48 * (64 * 64 * 128 * 4 + 3 * 4352 * 2)
MOE_STATE_BYTES = 48 * 32 * 130 * 4


def _active_params(api) -> int:
    """The parameters one token's forward multiplies through: each layer's
    mixer, router and ``n_experts_per_tok`` of its experts, and the
    unembedding (the embedding is a lookup)."""
    from repro_torch.models.param import count_params

    cfg, specs = api.cfg, api.specs()
    n = count_params(specs.get("unembed", specs["embed"]))
    for layer in specs["layers"]:
        mlp = layer["mlp"]
        experts = count_params([mlp["wi_gate"], mlp["wi_up"], mlp["wo"]])
        n += (count_params(layer["mixer"]) + count_params(mlp["router"])
              + experts * cfg.n_experts_per_tok // cfg.n_experts)
    return n


def _peak(torch, what: str, card: str) -> None:
    print(f"  {what}: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    torch.cuda.reset_peak_memory_stats()


def phase4m_ssm_generate(torch, np, card: str, api, params) -> None:
    """(b) ``generate`` of the full-width ``mamba2-1.3b``: B = 2, P = 768
    (three SSD chunks), 256 new tokens; counts zeroed just before and read
    just after (no kernel, no plain version).  Every step's logits against
    the full forward over the 1024 tokens of prompt + output
    (:func:`_decode_against_forward`): within ``MB_GEN_RTOL`` of the
    step's largest logit, and a token differs from the forward's argmax
    only where the two bf16 paths' disagreement allows a flip.  Then both
    paths against the same weights' f32 forward
    (:func:`_bf16_against_f32`): decode no farther from it than
    ``MB_GEN_EXACT`` times the bf16 forward, so the gap is the model's own
    bf16 rounding, whose growth through the layers is printed."""
    from repro_torch.serving.engine import decode_state_bytes, generate

    cfg = api.cfg
    prompts = np.random.default_rng(1).integers(0, cfg.vocab,
                                                (MB_GEN_B, MB_GEN_P))
    steps = []
    counters = _counts()
    undo = _forbid_plain_on_card()
    # The main path: counts from zero, read right after.
    for c in counters.values():
        c.n_launches = 0
    try:
        tg = time.perf_counter()
        toks, states = generate(api, params, prompts, MB_GEN_NEW,
                                sampler=_recording_greedy(steps))
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - tg
    finally:
        undo()
    launches = {k: c.n_launches for k, c in counters.items()}
    _require(not any(launches.values()), f"mamba2 generate launched "
             f"{launches}: an SSD model runs no kernel of B1-B5")
    _require(tuple(toks.shape) == (MB_GEN_B, MB_GEN_NEW),
             f"generate returned {tuple(toks.shape)}")
    rel, agree, explained, margin, delta, _ = _decode_against_forward(
        torch, cfg, params, prompts, toks, steps, with_last=True)
    print(f"  mamba2 (b) generate B={MB_GEN_B} P={MB_GEN_P} "
          f"new={MB_GEN_NEW}: {gen_s:.3f} s "
          f"({MB_GEN_B * MB_GEN_NEW / gen_s:.1f} tok/s), no kernel "
          f"launched; decode state {decode_state_bytes(states)} B  [{card}]")
    print(f"  mamba2 (b) against the full forward over {MB_GEN_P + MB_GEN_NEW}"
          f" tokens: {int(agree.sum())}/{agree.numel()} tokens its argmax; "
          f"|logits - forward's| / max |logit| per step: prefill "
          f"{rel[:, 0].max().item():.2e}, decode max "
          f"{rel[:, 1:].max().item():.2e}, median "
          f"{rel[:, 1:].median().item():.2e}; forward's top-2 margin where "
          f"a token differs: {margin[~agree].tolist()[:8]} against twice "
          f"the disagreement {(2 * delta)[~agree].tolist()[:8]}")
    _require(bool(torch.isfinite(rel).all()), "mamba2 generate: non-finite "
             "logits")
    _require(bool((agree | explained).all()), "mamba2 generate: a token "
             "differs from the full forward's argmax by more than the two "
             "paths' disagreement explains")
    _require(rel.max().item() <= MB_GEN_RTOL, f"mamba2 generate: logits "
             f"{rel.max().item():.3e} of max |logit| from the full forward's")

    seq = torch.cat([torch.as_tensor(prompts, device="cuda"),
                     toks.to("cuda")], dim=1)
    drift, fwd, exact = _bf16_against_f32(torch, cfg, params, seq)
    at = slice(MB_GEN_P, MB_GEN_P - 1 + MB_GEN_NEW)     # the decode steps
    exact = exact[:, at]
    scale = exact.abs().amax(dim=-1)
    fwd_rel = (fwd[:, at] - exact).abs().amax(dim=-1) / scale
    dec = torch.stack(steps[1:], dim=1)
    dec_rel = (dec - exact).abs().amax(dim=-1) / scale
    print(f"  mamba2 (b) against the same weights' f32 forward (|logits - "
          f"f32's| / max |logit| over the decode steps): bf16 forward median "
          f"{fwd_rel.median().item():.3e}, max {fwd_rel.max().item():.3e}; "
          f"bf16 decode median {dec_rel.median().item():.3e}, max "
          f"{dec_rel.max().item():.3e}; the residual stream's "
          f"||bf16 - f32|| / ||f32|| after layer "
          + ", ".join(f"{i} {drift[i - 1]:.3e}" for i in MB_DRIFT_AT
                      if i <= len(drift)) + f"  [{card}]")
    _require(dec_rel.median().item()
             <= MB_GEN_EXACT * fwd_rel.median().item(), "mamba2 generate: "
             "decode is farther from the f32 forward than the bf16 forward")


def _bf16_against_f32(torch, cfg, params, seq):
    """The bf16 model over ``seq`` (B, L) against itself with its weights
    widened to f32 (exactly) and f32 compute: what bf16 rounding alone
    does, with no decode.  Returns the residual stream's relative distance
    ||x_bf16 - x_f32|| / ||x_f32|| after each layer, the bf16 logits and
    the f32 logits."""
    from repro_torch.models import blocks, lm
    from repro_torch.models.layers import apply_embed
    from repro_torch.tree import tree_map

    f32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    wide = tree_map(lambda t: t.float(), params)
    drift = []
    with torch.inference_mode():
        x = apply_embed(params["embed"], seq,
                        getattr(torch, cfg.compute_dtype))
        xf = apply_embed(wide["embed"], seq, torch.float32)
        for p, pf, sig in zip(params["layers"], wide["layers"],
                              lm.layer_sigs(cfg)):
            x = blocks.block_sequence(p, x, sig, cfg, want_aux=False)[0]
            xf = blocks.block_sequence(pf, xf, sig, f32, want_aux=False)[0]
            drift.append(((x.float() - xf).norm() / xf.norm()).item())
        fwd = lm.lm_apply(cfg, params, seq)[0]
        exact = lm.lm_apply(f32, wide, seq)[0]
    del wide
    return drift, fwd, exact


def _f32_control(torch, np, card, cfg, label, prompt_shapes, new, rtol):
    """``generate`` of ``cfg`` (f32 weights from seed 0, f32 compute) from
    random prompts of each shape in ``prompt_shapes``, ``new`` tokens each,
    against the full forward over prompt + output: every step's logits
    within ``rtol`` of the step's largest logit, every token the forward's
    argmax.  Returns the largest relative disagreement."""
    from repro_torch.models.factory import build
    from repro_torch.serving.engine import generate

    tc = time.perf_counter()
    api = build(cfg)
    params = api.init(0, device="cuda")
    worst = 0.0
    for i, shape in enumerate(prompt_shapes):
        prompts = np.random.default_rng(1 + i).integers(0, cfg.vocab, shape)
        steps = []
        toks, _ = generate(api, params, prompts, new,
                           sampler=_recording_greedy(steps))
        rel, agree, _, margin, _, _ = _decode_against_forward(
            torch, cfg, params, prompts, toks, steps, with_last=True)
        worst = max(worst, rel.max().item())
        print(f"  {label} f32 control, {cfg.n_layers} layers at full width, "
              f"B={shape[0]} P={shape[1]} new={new}: |logits - forward's| / "
              f"max |logit| max {rel.max().item():.3e}, median "
              f"{rel.median().item():.3e} (bar {rtol:.0e}); "
              f"{int(agree.sum())}/{agree.numel()} tokens the forward's "
              f"argmax (smallest margin {margin.min().item():.3e})  [{card}]")
        _require(bool(agree.all()), f"{label} f32 control P={shape[1]}: a "
                 "token differs from the full forward's argmax")
        _require(rel.max().item() <= rtol, f"{label} f32 control "
                 f"P={shape[1]}: logits {rel.max().item():.3e} of max "
                 "|logit| from the full forward's")
    print(f"  {label} f32 control: {time.perf_counter() - tc:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def phase4m_moe_generate(torch, np, card: str, api, params):
    """(e) Softmax-mode ``generate`` of the full-width ``qwen3-moe-30b-a3b``
    on (d)'s parameters (the Aaren query tokens go unread): phase 4's B = 4,
    P = 128, 8 new tokens, counts zeroed just before and read just after
    (B3 once a layer: one prefill).  Prints the tokens and the prefill's
    ``dropped_frac`` (capacity binds, so decode and the full forward route
    differently here: the f32 control below holds decode to the forward).
    Returns (B3 launches, B3's captured prefill call {"args", "kw"})."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.factory import build
    from repro_torch.serving.engine import decode_state_bytes, generate

    soft = build(api.cfg.replace(attn_mode="softmax"))
    cfg = soft.cfg
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (GEN_B, GEN_P))
    prefill = {}
    real_fwd = ops.flash_attention

    def capture_fwd(*args, **kw):
        if not prefill:
            prefill["args"] = [a.clone() for a in args]
            prefill["kw"] = dict(kw)
        return real_fwd(*args, **kw)

    ops.flash_attention = capture_fwd
    try:
        generate(soft, params, prompts, 2)       # warm-up, and B3's inputs
    finally:
        ops.flash_attention = real_fwd
    torch.cuda.synchronize()
    counters = _counts()
    undo = _forbid_plain_on_card()
    # The main path: counts from zero, read right after.
    for c in counters.values():
        c.n_launches = 0
    try:
        tg = time.perf_counter()
        toks, states = generate(soft, params, prompts, GEN_NEW)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - tg
    finally:
        undo()
    launches = {k: c.n_launches for k, c in counters.items()}
    want = dict.fromkeys(launches, 0)
    want["flash_attention"] = cfg.n_layers
    _require(launches == want, f"generate launched {launches}, want {want}: "
             "one prefill")
    _require(tuple(toks.shape) == (GEN_B, GEN_NEW),
             f"generate returned {tuple(toks.shape)}")
    with torch.inference_mode():
        _, _, aux = lm.lm_apply(cfg, params, torch.as_tensor(
            prompts, device="cuda"), return_aux=True)
    dropped = float(aux["dropped_frac"])
    print(f"  qwen3-moe (e) softmax generate B={GEN_B} P={GEN_P} "
          f"new={GEN_NEW}: {gen_s:.3f} s; B3 launches "
          f"{launches['flash_attention']} (one prefill); KV caches "
          f"{decode_state_bytes(states)} B; the prefill's dropped_frac "
          f"{dropped:.4f} (mean of {cfg.n_layers} layers), "
          f"load_balance_loss {float(aux['load_balance_loss']):.4f}; tokens "
          f"{toks.tolist()}"
          f"  [{card}]")
    _require(0.0 <= dropped < 1.0, f"dropped_frac {dropped}")
    return launches["flash_attention"], prefill


def _moe_kernel_rows(torch, np, card, serve_cap, train_cap):
    """(g) B1–B5 at qwen3-moe-30b-a3b's shapes, on inputs captured from
    (d)–(f), against their plain versions, with device time, bound and
    library call: B1 at the serving tick (R = 8 x 32, N = 16, d = 128) and
    with residuals at training (R = 4 x 32, N = 1024); B2 at training;
    bf16 B3–B5 at training (B = 4, H = 32, G = 4, N = 1024, d = 128,
    causal), and B3 at the prefill (B = 4, N = 128); SDPA with
    ``enable_gqa`` beside B3–B5.  Returns ({kernel: {shape: row}}, {kernel:
    max |err|})."""
    from repro_torch.kernels.aaren_scan import aaren_scan, aaren_scan_plain
    from repro_torch.kernels.aaren_scan_bwd import (
        aaren_scan_bwd,
        aaren_scan_bwd_plain,
    )

    rows = {k: {} for k in FLASH_KERNELS + SCAN_KERNELS}
    errs = dict.fromkeys(rows, 0.0)

    def scan_row(name, label, fn, plain, bound, n_iter, plain_iter):
        rows[name][label] = _scan_row(torch, card, name, label, fn, plain,
                                      bound, n_iter, plain_iter)

    s, v, m0, u0, w0 = serve_cap["b1"]
    r, n, d = v.shape
    scan_row("aaren_scan", f"serve R={r} N={n} d={d}",
             lambda: aaren_scan(s, v, m0, u0, w0),
             lambda: aaren_scan_plain(s, v, m0, u0, w0),
             _b1_bound(r, n, d, residuals=False), 200, 20)
    (args, kw) = train_cap["aaren"]["aaren_scan"]
    errs["aaren_scan"] = _compare_scan_residuals(
        torch, args, "qwen3-moe training step, first layer")
    s, v, m0, u0, w0 = args
    r, n, d = v.shape
    scan_row("aaren_scan", f"train R={r} N={n} d={d}",
             lambda: aaren_scan(s, v, m0, u0, w0, return_residuals=True),
             lambda: aaren_scan_plain(s, v, m0, u0, w0,
                                      return_residuals=True),
             _b1_bound(r, n, d, residuals=True), 20, 3)
    (bwd, _) = train_cap["aaren"]["aaren_scan_bwd"]
    errs["aaren_scan_bwd"] = _compare_bwd(
        torch, bwd, "qwen3-moe training step, last layer")
    scan_row("aaren_scan_bwd", f"train R={r} N={n} d={d}",
             lambda: aaren_scan_bwd(*bwd), lambda: aaren_scan_bwd_plain(*bwd),
             _b2_bound(r, n, d), 20, 3)

    def flash_rows(label, q, k, v, do, check_label, names):
        got = _check_flash(torch, q, k, v, do, None, True, None, check_label)
        for key in errs:
            errs[key] = max(errs[key], got.get(key, 0.0))
        timed = flash_kernel_times(torch, q, k, v, do, None, True, None,
                                   card, plain_iter=2)
        for name in names:
            rows[name][label] = {key: timed[name][key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "tflops")}

    (bwd_args, bkw) = train_cap["softmax"]["flash_attention_bwd"]
    q, k, v, o, lse, do = bwd_args
    _require(bkw.get("window") is None and bkw.get("q_lens") is None
             and q.dtype == torch.bfloat16 and k.shape[1] == 4,
             f"the qwen3-moe flash backward call: {sorted(bkw)}")
    b, h, n_q, d = q.shape
    flash_rows(f"train B={b} H={h} G={k.shape[1]} N={n_q} d={d}", q, k, v,
               do, "qwen3-moe softmax training step, layer 0", FLASH_KERNELS)
    qp, kp, vp = serve_cap["b3"]["args"][:3]
    b, h, n_q, d = qp.shape
    flash_rows(f"prefill B={b} H={h} G={kp.shape[1]} N={n_q} d={d}", qp, kp,
               vp, torch.randn_like(qp), "qwen3-moe softmax generate "
               "prefill, layer 0", ("flash_attention",))
    return rows, errs


def phase4m_ssm_moe(torch, np, card: str):
    """Phase 4m: (h) the three smoke configs card against CPU; (a)–(c)
    the full-width mamba2-1.3b's serving, generate (with its f32 control)
    and training; (d)–(f) the full-width qwen3-moe-30b-a3b's Aaren serving,
    softmax generate (with its f32 control) and training at 4 layers in
    both modes; (g) B1–B5 at qwen3's shapes.  Returns ({kernel:
    {"serve_ssm", "train_ssm", "serve_moe", "train_moe": n}}, {kernel:
    {shape: row}}, {kernel: max |err|})."""
    from repro_torch.configs import get_config
    from repro_torch.models.factory import build
    from repro_torch.models.param import count_params

    _small_configs(torch, np, SSM_MOE_SMALL, 130)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    cfg = get_config(SSM)
    _require((cfg.family, cfg.param_dtype, cfg.compute_dtype, cfg.n_layers,
              cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state,
              cfg.vocab, cfg.tie_embeddings, cfg.mlp_pattern)
             == ("ssm", "bfloat16", "bfloat16", 48, 2048, 4096, 64, 128,
                 50280, True, ("none",)), str(cfg))
    api = build(cfg)
    n_params = count_params(api.specs())
    _require(n_params == 1_343_740_928, f"{n_params} parameters")
    ti = time.perf_counter()
    params = api.init(0, device="cuda")
    torch.cuda.synchronize()
    print(f"  {SSM} init {time.perf_counter() - ti:.2f} s: {n_params:,} "
          f"params, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on card")
    _serve_full(torch, np, card, api, params, "mamba2 (a)", 0,
                MB_STATE_BYTES)
    _peak(torch, "mamba2 (a) serving", card)
    phase4m_ssm_generate(torch, np, card, api, params)
    _peak(torch, "mamba2 (b) generate", card)
    del api, params
    gc.collect()
    torch.cuda.empty_cache()
    f32 = get_config(SSM, n_layers=MB_F32_LAYERS, param_dtype="float32",
                     compute_dtype="float32")
    _f32_control(torch, np, card, f32, "mamba2 (b)",
                 [(MB_GEN_B, MB_GEN_P)], MB_GEN_NEW, MB_F32_RTOL)
    _f32_control(torch, np, card, f32, "mamba2 (b) short prompts",
                 [(MB_GEN_B, p) for p in MB_SHORT_P], MB_SHORT_NEW,
                 MB_F32_RTOL)
    _peak(torch, "mamba2 (b) f32 control", card)
    _train_full(torch, np, card, get_config(SSM, n_layers=MB_TRAIN_LAYERS),
                "mamba2 (c)", TRAIN_B, TRAIN_N, {})
    torch.cuda.reset_peak_memory_stats()

    cfg = get_config(MOE)
    _require((cfg.family, cfg.attn_mode, cfg.param_dtype, cfg.compute_dtype,
              cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
              cfg.resolved_head_dim, cfg.n_experts, cfg.n_experts_per_tok,
              cfg.moe_d_ff, cfg.capacity_factor, cfg.vocab,
              cfg.tie_embeddings)
             == ("moe", "aaren", "bfloat16", "bfloat16", 48, 2048, 32, 4,
                 128, 128, 8, 768, 1.25, 151936, False), str(cfg))
    api = build(cfg)
    n_params = count_params(api.specs())
    ti = time.perf_counter()
    params = api.init(0, device="cuda")
    torch.cuda.synchronize()
    print(f"  {MOE} init {time.perf_counter() - ti:.2f} s: {n_params:,} "
          f"params, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on card")
    b1_serve, b1_args, b1_err = _serve_full(
        torch, np, card, api, params, "qwen3-moe (d)", cfg.n_layers,
        MOE_STATE_BYTES)
    _peak(torch, "qwen3-moe (d) serving", card)
    b3_serve, b3_call = phase4m_moe_generate(torch, np, card, api, params)
    _peak(torch, "qwen3-moe (e) generate", card)
    del api, params
    gc.collect()
    torch.cuda.empty_cache()
    _f32_control(torch, np, card, get_config(
        MOE, n_layers=MOE_F32_LAYERS, attn_mode="softmax",
        param_dtype="float32", compute_dtype="float32",
        capacity_factor=MOE_F32_CF), "qwen3-moe (e)", [(GEN_B, GEN_P)],
        GEN_NEW, MOE_F32_RTOL)
    _peak(torch, "qwen3-moe (e) f32 control", card)
    train_launches, train_cap = {}, {}
    for mode in ("aaren", "softmax"):
        tcfg = get_config(MOE, n_layers=MOE_TRAIN_LAYERS, attn_mode=mode)
        n = tcfg.n_layers
        want = ({"aaren_scan": 2 * n, "aaren_scan_bwd": n}
                if mode == "aaren" else
                {"flash_attention": 2 * n, "flash_bwd_dq": n,
                 "flash_bwd_dkv": n})
        launches, train_cap[mode], _ = _train_full(
            torch, np, card, tcfg, f"qwen3-moe (f) {mode}", TRAIN_B, TRAIN_N,
            want, mfu_params=_active_params(build(tcfg)),
            mfu_label="MFU on active parameters")
        train_launches.update(launches)
    rows, errs = _moe_kernel_rows(torch, np, card, {"b1": b1_args,
                                                    "b3": b3_call}, train_cap)
    errs["aaren_scan"] = max(errs["aaren_scan"], b1_err)
    serve = {"aaren_scan": b1_serve, "flash_attention": b3_serve}
    by_path = {k: {"serve_ssm": 0, "train_ssm": 0,
                   "serve_moe": serve.get(k, 0),
                   "train_moe": train_launches.get(k, 0)} for k in rows}
    return by_path, rows, errs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build as kbuild

    t0 = time.perf_counter()
    # 1. Toolchain and card ------------------------------------------------
    _phase("1 toolchain and card", t0)
    card = _card_line()
    print(f"card: {card}")
    nvcc = subprocess.run([kbuild._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    triton = ("triton " + importlib.metadata.version("triton")
              if importlib.util.find_spec("triton") else "no triton")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}, nvcc: {nvcc[-1]}, "
          f"{triton}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")

    # 2. Build ---------------------------------------------------------------
    _phase("2 build", t0)
    tb = time.perf_counter()
    logs = kbuild.build(kbuild.KERNELS)
    for name in kbuild.KERNELS:
        kbuild.load(name)
        print(f"  built {kbuild.library_path(name).name}")
        for line in logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    print(f"build seconds: {time.perf_counter() - tb:.2f}")
    phase2_tensor_cores(kbuild, logs)
    phase2_scan_bwd_usage(logs)

    # 3. Kernels against their plain versions --------------------------------
    _phase("3 kernels against plain versions", t0)
    b1_err, b2_err = phase3_kernels(torch, np)
    seg_b1_err, seg_b2_err = phase3_segmented_kernels(torch, np)
    flash_errs = phase3_flash_kernels(torch, np)
    seg_flash_errs = phase3_segmented_flash_kernels(torch, np)
    task_errs = phase3_proxy_kernels(torch, np)
    phase3_small_model(torch, np)
    phase3_small_softmax(torch, np)
    phase3_small_packed(torch, np)
    phase3_small_packed(torch, np, "softmax")

    # 4. Full-width serving ------------------------------------------------
    _phase("4 full-width serving", t0)
    cfg = get_config(ARCH)
    _require((cfg.attn_mode, cfg.param_dtype, cfg.compute_dtype,
              cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.resolved_head_dim,
              cfg.d_ff, cfg.vocab) == ("aaren", "bfloat16", "bfloat16", 32,
                                       3072, 32, 96, 8192, 32064), str(cfg))
    serve_launches, b1_serve, err, serve_ref = phase4_serving(torch, np,
                                                              card)
    b1_err = max(b1_err, err)

    # 4k. The serving tier on phase 4's parameters -------------------------
    _phase("4k full-width serving tier", t0)
    tier_launches = phase4k_serving_tier(torch, np, card, cfg,
                                         serve_ref.pop("model"), serve_ref)
    gc.collect()               # the serving model is freed here
    torch.cuda.empty_cache()

    # 4b. Full-width training ----------------------------------------------
    _phase("4b full-width training", t0)
    train_launches, train_rows, errs, block = phase4b_training(
        torch, np, card, cfg)
    b1_err = max(b1_err, errs["aaren_scan"])
    b2_err = max(b2_err, errs["aaren_scan_bwd"])
    gc.collect()
    torch.cuda.empty_cache()

    # 4g. Full-width training with group remat -----------------------------
    _phase("4g full-width training, remat group", t0)
    group_launches = phase4g_group_remat(torch, np, card, cfg, block)
    gc.collect()
    torch.cuda.empty_cache()

    # 4j. Full-width fault-tolerant training, then instrumented serving ----
    _phase("4j full-width fault-tolerant training", t0)
    ft_launches = phase4j_fault_tolerant_training(torch, np, card, cfg,
                                                  block)
    gc.collect()
    torch.cuda.empty_cache()
    obs_serve_launches = phase4j_instrumented_serving(torch, np, card, cfg,
                                                      serve_ref)
    gc.collect()
    torch.cuda.empty_cache()

    # 4c. Full-width softmax training --------------------------------------
    _phase("4c full-width softmax training", t0)
    soft_cfg = get_config(ARCH, attn_mode="softmax")
    soft_launches, flash_rows, errs = phase4c_softmax_training(
        torch, np, card, soft_cfg)
    flash_errs = {k: max(v, errs[k]) for k, v in flash_errs.items()}
    gc.collect()
    torch.cuda.empty_cache()

    # 4d. Full-width softmax generate with a KV cache ----------------------
    _phase("4d full-width softmax generate", t0)
    gen_b3 = phase4d_softmax_generate(torch, np, card, soft_cfg)
    gc.collect()
    torch.cuda.empty_cache()

    # 4e. Full-width packed training (segmented B1 and B2) ------------------
    _phase("4e full-width packed training", t0)
    packed_launches, packed_rows, errs, _ = phase4b_training(
        torch, np, card, cfg, packed=True)
    seg_b1_err = max(seg_b1_err, errs["aaren_scan"])
    seg_b2_err = max(seg_b2_err, errs["aaren_scan_bwd"])
    gc.collect()
    torch.cuda.empty_cache()

    # 4f. Full-width packed softmax training (segmented B3, B4, B5) ---------
    _phase("4f full-width packed softmax training", t0)
    seg_soft_launches, seg_flash_rows, errs = phase4c_softmax_training(
        torch, np, card, soft_cfg, packed=True)
    seg_flash_errs = {k: max(v, errs[k]) for k, v in seg_flash_errs.items()}
    gc.collect()
    torch.cuda.empty_cache()

    # 4h. The paper-table proxies ------------------------------------------
    _phase("4h paper-table proxies", t0)
    task_launches, errs = phase4h_tasks(torch, np, card)
    task_errs = {k: max(v, errs[k]) for k, v in task_errs.items()}

    # 4i. The examples -------------------------------------------------------
    _phase("4i examples", t0)
    phase4i_examples(torch, np, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 4l. The hybrid recurrentgemma-9b and the A10a smoke configs -----------
    _phase("4l hybrid recurrentgemma-9b", t0)
    hy_paths, hy_rows, hy_errs = phase4l_hybrid(torch, np, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 4m. The SSM and MoE families: mamba2-1.3b and qwen3-moe-30b-a3b -------
    _phase("4m mamba2-1.3b and qwen3-moe-30b-a3b", t0)
    m_paths, m_rows, m_errs = phase4m_ssm_moe(torch, np, card)

    # 5. Results ---------------------------------------------------------------
    _phase("5 results", t0)
    kernels = [
        {"name": "aaren_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/aaren_scan.cu",
         "replaces": "src/repro/kernels/aaren_scan.py:190",
         "launches": (serve_launches + tier_launches
                      + train_launches["aaren_scan"]
                      + group_launches["aaren_scan"]
                      + ft_launches["aaren_scan"] + obs_serve_launches
                      + task_launches["aaren_scan"]),
         "launches_by_path": {"serve": serve_launches,
                              "serve_tier": tier_launches,
                              "train": train_launches["aaren_scan"],
                              "train_group": group_launches["aaren_scan"],
                              "train_guarded": ft_launches["aaren_scan"],
                              "serve_instrumented": obs_serve_launches,
                              "tasks": task_launches["aaren_scan"]},
         "max_abs_err": max(b1_err, task_errs["aaren_scan"]),
         "max_abs_err_tasks": task_errs["aaren_scan"], **b1_serve,
         "library_ms": None,
         "shape": "serving tick; 'train' holds the residual form at the "
                  "training shape",
         "train": train_rows["aaren_scan"]},
        {"name": "aaren_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/aaren_scan_bwd.cu",
         "replaces": "src/repro/kernels/aaren_scan_bwd.py:183",
         "launches": (train_launches["aaren_scan_bwd"]
                      + group_launches["aaren_scan_bwd"]
                      + ft_launches["aaren_scan_bwd"]
                      + task_launches["aaren_scan_bwd"]),
         "launches_by_path": {"serve": 0,
                              "train": train_launches["aaren_scan_bwd"],
                              "train_group": group_launches["aaren_scan_bwd"],
                              "train_guarded": ft_launches["aaren_scan_bwd"],
                              "tasks": task_launches["aaren_scan_bwd"]},
         "max_abs_err": max(b2_err, task_errs["aaren_scan_bwd"]),
         "max_abs_err_tasks": task_errs["aaren_scan_bwd"],
         **train_rows["aaren_scan_bwd"],
         "library_ms": None},
    ]
    for name, line, err in (("aaren_scan", "aaren_scan.py:190", seg_b1_err),
                            ("aaren_scan_bwd", "aaren_scan_bwd.py:183",
                             seg_b2_err)):
        kernels.append({
            "name": f"{name}_segmented", "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{line} (segment flags)",
            "launches": packed_launches[name],
            "launches_by_path": {"serve": 0,
                                 "train_packed": packed_launches[name],
                                 "train_group": 0, "tasks": 0},
            "max_abs_err": err, **packed_rows[name], "library_ms": None,
            "shape": "packed training, layer 0 (residual form for B1)"})
    flash_meta = (
        ("flash_attention", "flash_fwd.cu", ":244",
         {"serve": gen_b3, "train": soft_launches["flash_attention"],
          "tasks": task_launches["flash_attention"]}),
        ("flash_bwd_dq", "flash_bwd.cu", ":548",
         {"serve": 0, "train": soft_launches["flash_bwd_dq"],
          "tasks": task_launches["flash_bwd_dq"]}),
        ("flash_bwd_dkv", "flash_bwd.cu", ":581",
         {"serve": 0, "train": soft_launches["flash_bwd_dkv"],
          "tasks": task_launches["flash_bwd_dkv"]}),
    )
    for name, source, line, by_path in flash_meta:
        row = flash_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/flash_attention.py{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(flash_errs[name], task_errs[name]),
            "max_abs_err_tasks": task_errs[name],
            **({"oracle_bar_fraction": flash_errs["oracle_" + name]}
               if "oracle_" + name in flash_errs else {}),
            **{key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms",
                                         "tflops")},
            "library": ("scaled_dot_product_attention forward" if name ==
                        "flash_attention" else "scaled_dot_product_attention"
                        " backward, B4 + B5 together"),
            "shape": "training, layer 0: B=4 H=G=32 N=1024 d=96 bf16 causal"})
    for name, source, line, _ in flash_meta:
        row = seg_flash_rows[name]
        kernels.append({
            "name": f"{name}_segmented", "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/flash_attention.py{line} "
                        "(segment ids)",
            "launches": seg_soft_launches[name],
            "launches_by_path": {"serve": 0,
                                 "train_packed": seg_soft_launches[name],
                                 "tasks": 0},
            "max_abs_err": seg_flash_errs[name],
            **({"oracle_bar_fraction": seg_flash_errs["oracle_" + name]}
               if "oracle_" + name in seg_flash_errs else {}),
            **{key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms",
                                         "tflops")},
            "library": ("scaled_dot_product_attention forward" if name ==
                        "flash_attention" else "scaled_dot_product_attention"
                        " backward, B4 + B5 together") + ", block-diagonal "
                       "causal boolean mask",
            "shape": "packed training, layer 0: B=4 H=G=32 N=1024 d=96 bf16 "
                     "causal, segment ids"})
    # The launches and shapes of the hybrid (phase 4l) and of the SSM and
    # MoE models (phase 4m).
    for key, paths, shape_rows, errs in (("hybrid", hy_paths, hy_rows,
                                          hy_errs),
                                         ("qwen3_moe", m_paths, m_rows,
                                          m_errs)):
        for row in kernels:
            name = row["name"]
            if name in paths:
                row["launches_by_path"].update(paths[name])
                row["launches"] += sum(paths[name].values())
                row["max_abs_err"] = max(row["max_abs_err"], errs[name])
                row[key] = shape_rows[name]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
