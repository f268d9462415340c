#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths — Aaren, packed
Aaren and the softmax baseline — on one CUDA card and check them.

Run from the root of the repository, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; no phase catches its
own error):

1. Toolchain and card: ``nvidia-smi``, ``torch.version.cuda``, ``nvcc``;
   TF32 off for matmuls and cuDNN.
2. Build every CUDA kernel of the paths from ``src/repro_torch/csrc``, one
   ``nvcc`` per source, all started together.
3. Each kernel against its plain PyTorch version on the card: B1 (serving
   form and residual form) and B2 on edge shapes, the inputs of a real
   serving tick at the first and last layer, a small f32 model served on the
   card (kernels) and on the CPU (plain versions) with identical greedy
   tokens, and the same model's loss, every parameter gradient and three
   train steps on the card against the CPU.  The segmented B1 and B2 of
   packed rows on edge cases (a flag at token 0 with a carry, a carry with
   no flags, single-token segments, every token flagged, a padding tail and
   an all-padding row, N not a multiple of 32, extreme scores, packed rows
   at the training N), and all-zero flags against no flags, bit for bit.
   B3, B4 and B5 on edge shapes (N = 1, odd N, N = 1000, ragged lengths
   with 0 and all-empty rows, window, GQA, d from 32 to 256, f32 and
   bf16), and a small f32 softmax
   model's greedy tokens (plain and ragged prompts), loss, gradients and
   three train steps on the card against the CPU.  A small f32 Aaren
   model's packed loss and gradients on the card against the CPU, and its
   packed loss against per-document evaluation.
4. Full-width serving: ``phi3-mini-3.8b`` as registered (bf16, 32 layers,
   d_model 3072, 32 x 96 heads), random weights from a seed, 16 requests
   through the ``StreamingEngine`` (8 slots, chunk 16, prompts of 32-256
   tokens, 32 new tokens each), then one wave ``generate`` call (B = 4,
   P = 128, 8 new tokens).  Launch counts are zeroed just before and read
   just after.  Then a ``torch.profiler`` view of five ticks and B1's
   device time at the serving shape (a replayed CUDA graph, so host overhead
   drops out) beside its eager per-call time, its plain version's and its
   bound.
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
5. Result lines: the kernels' JSON, the card, and the contract line.
"""

from __future__ import annotations

import gc
import importlib.metadata
import importlib.util
import json
import statistics
import subprocess
import sys
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
    err = 0.0
    for name, a, b in zip(("ds", "dv", "n1", "g1", "b1"), got, want):
        _require(bool(torch.isfinite(a).all()),
                 f"{label}: kernel {name} is not finite")
        scale = max(b.abs().max().item(), 1e-6)
        torch.testing.assert_close(a / scale, b / scale, **TOL,
                                   msg=lambda m: f"{label} {name}: {m}")
        err = max(err, (a - b).abs().max().item())
    print(f"  {label} (B2): R={args[0].shape[0]} N={args[0].shape[1]} "
          f"d={args[1].shape[2]} max|kernel - plain| = {err:.3e}")
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
    ("B3 flash_fwd_kernel", ("flash_fwd_kernel",)),
    ("B4 flash_bwd_dq_kernel", ("flash_bwd_dq_kernel",)),
    ("B5 flash_bwd_dkv_kernel", ("flash_bwd_dkv_kernel",)),
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
]
BWD_ONLY_CASES = [
    ("u == 0 residual positions", 9, 70, 96, True, (), 3.0),
    ("extreme scores (+-80), training N", 4, 1024, 96, True, (), 80.0),
    ("widest d, long row", 3, 300, 256, False, (1,), 3.0),
]


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
# The CPU parity bars of tests/test_torch_flash.py: forward rtol = atol (f32
# 2e-5, bf16 2e-2); gradients |kernel - plain| <= rtol * max |plain| + 1e-6.
FLASH_FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _flash_inputs(torch, np, b, h, g, n, d, dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = ((b, h, n, d), (b, g, n, d), (b, g, n, d), (b, h, n, d))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .cuda().to(getattr(torch, dtype)) for s in shapes]


def _grad_close(a, b, rtol, what):
    """|a - b| <= rtol * max|b| + 1e-6 (the 1e-6 floor is the f32 noise of a
    dense reference where the true gradient is 0)."""
    a, b = a.float(), b.float()
    _require(bool(a.isfinite().all()), f"{what}: kernel output not finite")
    err = (a - b).abs().max().item()
    bar = rtol * b.abs().max().item() + 1e-6
    _require(err <= bar, f"{what}: max |kernel - plain| {err:.3e} > {bar:.3e}")
    return err


def _check_flash(torch, q, k, v, do, lens, causal, window, label):
    """B3, B4 and B5 against their plain versions on the same tensors.
    Returns the max |kernel - plain| of each, keyed by wrapper name."""
    import math

    from repro_torch.kernels import flash_attention as fa

    dtype = str(q.dtype).split(".")[-1]
    b, h, n_q, d = q.shape
    n_k = k.shape[2]
    ql = fa._lens(lens, b, n_q, q.device)
    kl = fa._lens(lens, b, n_k, q.device)
    kw = dict(causal=causal, window=window, scale=1.0 / math.sqrt(d))
    o, lse = fa.flash_attention(q, k, v, q_lens=lens, kv_lens=lens,
                                return_residuals=True, **kw)
    o_p, lse_p = fa.flash_attention_plain(q, k, v, ql, kl, **kw)
    torch.cuda.synchronize()
    tol = FLASH_FWD_TOL[dtype]
    _require(bool(o.float().isfinite().all()), f"{label}: o not finite")
    torch.testing.assert_close(o.float(), o_p.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"{label} o: {m}")
    torch.testing.assert_close(lse, lse_p, rtol=2e-5, atol=2e-5,
                               msg=lambda m: f"{label} lse: {m}")
    dead = torch.arange(n_q, device=q.device)[None, :] >= ql[:, None]
    _require(bool((o.float()[dead[:, None].expand(b, h, n_q)] == 0).all()
                  and (lse[dead[:, None].expand(b, h, n_q)]
                       <= -1e38).all()),
             f"{label}: a masked query does not read o = 0, lse = NEG_INF")
    errs = {"flash_attention": (o.float() - o_p.float()).abs().max().item()}

    delta = (do.float() * o_p.float()).sum(dim=-1).contiguous()
    args = (q, k, v, do, lse_p, delta, ql, kl)
    dq = fa.flash_bwd_dq(*args, **kw)
    dk, dv = fa.flash_bwd_dkv(*args, **kw)
    dq_p = fa.flash_bwd_dq_plain(*args, **kw)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(*args, **kw)
    torch.cuda.synchronize()
    rtol = FLASH_GRAD_TOL[dtype]
    errs["flash_bwd_dq"] = _grad_close(dq, dq_p, rtol, f"{label} dq")
    errs["flash_bwd_dkv"] = max(_grad_close(dk, dk_p, rtol, f"{label} dk"),
                                _grad_close(dv, dv_p, rtol, f"{label} dv"))
    dead_k = (torch.arange(n_k, device=q.device)[None, :]
              >= kl[:, None])[:, None].expand(b, k.shape[1], n_k)
    _require(bool((dq[dead[:, None].expand(b, h, n_q)] == 0).all()
                  and (dk[dead_k] == 0).all() and (dv[dead_k] == 0).all()),
             f"{label}: a masked query or key has a nonzero gradient")
    print(f"  {label}: B={b} H={h} G={k.shape[1]} N={n_q} d={d} {dtype}: "
          f"max|kernel - plain| B3 {errs['flash_attention']:.3e}, B4 "
          f"{errs['flash_bwd_dq']:.3e}, B5 {errs['flash_bwd_dkv']:.3e}")
    return errs


def phase3_flash_kernels(torch, np) -> dict:
    """B3, B4 and B5 against their plain versions on edge shapes.  Returns
    {wrapper name: max |kernel - plain|}."""
    errs = {"flash_attention": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for i, (label, (b, h, g, n, d), dtype, causal, window,
            lens) in enumerate(FLASH_CASES):
        q, k, v, do = _flash_inputs(torch, np, b, h, g, n, d, dtype,
                                    seed=300 + i)
        lens_t = (None if lens is None else
                  torch.tensor(lens, dtype=torch.int32, device="cuda"))
        got = _check_flash(torch, q, k, v, do, lens_t, causal, window, label)
        errs = {key: max(errs[key], got[key]) for key in errs}
    return errs


def _causal_pairs(n_q, n_k, lens, causal, window) -> int:
    """Live (query, key) pairs of one head, summed over the batch rows."""
    total = 0
    for ln in lens:
        for i in range(min(ln, n_q)):
            hi = min(i + 1, n_k, ln) if causal else min(n_k, ln)
            lo = 0 if window is None else max(0, i - window + 1)
            total += max(0, hi - lo)
    return total


def _flash_bounds(torch, q, k, lens, causal, window):
    """(bound row of B3, of B4, of B5): each input read once, each output
    written once; the products on the live pairs of this run's masks (4, 6
    and 8 flops a pair and element of d) at the card's peak rate for the
    input type: the bf16 tensor cores for bf16 inputs, f32 outside the
    tensor cores for f32 inputs.  The f32 SIMT bound, the rate the kernels
    compute at, stands beside it."""
    b, h, n_q, d = q.shape
    g, n_k = k.shape[1], k.shape[2]
    lens = [n_q] * b if lens is None else [int(x) for x in lens.tolist()]
    pairs = h * _causal_pairs(n_q, n_k, lens, causal, window)
    e = q.element_size()
    qb, kb = b * h * n_q * d * e, b * g * n_k * d * e
    rows = 4 * b * h * n_q
    nbytes = {"flash_attention": 2 * qb + 2 * kb + rows,
              "flash_bwd_dq": 3 * qb + 2 * kb + 2 * rows,
              "flash_bwd_dkv": 2 * qb + 4 * kb + 2 * rows}
    flops = {"flash_attention": 4 * pairs * d, "flash_bwd_dq": 6 * pairs * d,
             "flash_bwd_dkv": 8 * pairs * d}
    rate = BF16_DENSE_FLOPS if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    out = {}
    for name in nbytes:
        bound_ms, bound_by = _bound(nbytes[name], flops[name], rate)
        out[name] = {"bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": nbytes[name], "flops": flops[name],
                     "rate": rate,
                     "f32_simt_bound_ms": _bound(nbytes[name],
                                                 flops[name])[0]}
    return out


def flash_kernel_times(torch, q, k, v, do, lens, causal, window, card,
                       n_iter=10, plain_iter=3):
    """B3, B4 and B5 at the given (main-path) inputs: device time in a
    replayed CUDA graph, eager call, plain version, bound, and the
    ``scaled_dot_product_attention`` yardstick (forward for B3, its
    backward for B4 + B5 together; timed here, never called by the port).
    Returns {wrapper name: row}."""
    import math

    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    b, _, n_q, d = q.shape
    n_k = k.shape[2]
    kw = dict(causal=causal, window=window, scale=1.0 / math.sqrt(d))
    ql = fa._lens(lens, b, n_q, q.device)
    kl = fa._lens(lens, b, n_k, q.device)
    o, lse = fa.flash_attention(q, k, v, q_lens=lens, kv_lens=lens,
                                return_residuals=True, **kw)
    delta = (do.float() * o.float()).sum(dim=-1).contiguous()
    args = (q, k, v, do, lse, delta, ql, kl)
    calls = {
        "flash_attention": (
            lambda: fa.flash_attention(q, k, v, q_lens=lens, kv_lens=lens,
                                       return_residuals=True, **kw),
            lambda: fa.flash_attention_plain(q, k, v, ql, kl, **kw)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*args, **kw),
                         lambda: fa.flash_bwd_dq_plain(*args, **kw)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*args, **kw),
                          lambda: fa.flash_bwd_dkv_plain(*args, **kw)),
    }
    library = {"flash_attention": None, "flash_bwd_dq": None,
               "flash_bwd_dkv": None}
    if lens is None and window is None and causal and q.shape[1] == k.shape[1]:
        qs, ks, vs = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        fwd_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), n_iter)
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(
            out, (qs, ks, vs), do, retain_graph=True), n_iter)
        library = {"flash_attention": fwd_ms, "flash_bwd_dq": bwd_ms,
                   "flash_bwd_dkv": bwd_ms}
    bounds = _flash_bounds(torch, q, k, lens, causal, window)
    rows = {}
    for name, (kernel, plain) in calls.items():
        ms, call_ms, plain_ms, plain_call_ms = _kernel_times(
            torch, kernel, plain, n_iter, plain_iter)
        bd = bounds[name]
        rows[name] = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                      "plain_call_ms": plain_call_ms,
                      "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
                      "library_ms": library[name],
                      "f32_simt_bound_ms": bd["f32_simt_bound_ms"]}
        lib = ("none" if library[name] is None
               else f"{library[name] * 1e3:.2f} us")
        print(f"  {name} at B={b} H={q.shape[1]} G={k.shape[1]} N={n_q} "
              f"d={d} {str(q.dtype).split('.')[-1]}: device {ms * 1e3:.2f} "
              f"us (eager call {call_ms * 1e3:.2f} us), plain device "
              f"{plain_ms * 1e3:.2f} us (eager call {plain_call_ms * 1e3:.2f}"
              f" us), bound {bd['bound_ms'] * 1e3:.2f} us by "
              f"{bd['bound_by']} ({bd['bytes']} B, {bd['flops']} flop at "
              f"{bd['rate'] / 1e12:.0f} TFLOP/s; "
              f"{bd['f32_simt_bound_ms'] * 1e3:.2f} us at the f32 SIMT rate "
              f"the kernel computes at), {ms / bd['bound_ms']:.2f}x the "
              f"bound; SDPA {lib}  [{card}]")
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


def phase3_small_packed(torch, np) -> None:
    """The small f32 Aaren model on packed documents: loss and every
    gradient on the card (segmented kernels) against the CPU (plain
    versions), and the packed loss against per-document evaluation."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.packing import pack_documents
    from repro_torch.kernels.aaren_scan import aaren_scan
    from repro_torch.kernels.aaren_scan_bwd import aaren_scan_bwd
    from repro_torch.models.factory import build
    from repro_torch.tree import tree_leaves

    small = build(smoke_config(ARCH))
    cpu_params = small.init(0, device="cpu")
    rng = np.random.default_rng(120)
    docs = [rng.integers(0, small.cfg.vocab, n)
            for n in (30, 12, 1, 9, 6, 20, 5, 33)]
    packed = pack_documents(docs, 48)
    losses, grads = {}, {}
    launches = (aaren_scan.n_launches, aaren_scan_bwd.n_launches)
    for dev in ("cpu", "cuda"):
        params = _to(cpu_params, dev)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in packed.items()}
        loss, _ = small.loss(params, batch)
        grads[dev] = torch.autograd.grad(loss, leaves)
        losses[dev] = loss.item()
    _require(aaren_scan.n_launches > launches[0]
             and aaren_scan_bwd.n_launches > launches[1],
             "small packed model: the card path launched no scan kernel")
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    _require(rel <= 1e-5, f"small packed model: loss on the card "
             f"{losses['cuda']} != on the CPU {losses['cpu']}")
    gerr = 0.0
    for a, b in zip(grads["cuda"], grads["cpu"]):
        err = (a.cpu() - b).abs().max().item() / max(b.abs().max().item(),
                                                     1e-6)
        _require(err <= TOL["rtol"], f"small packed model: a gradient "
                 f"differs by {err:.3e} of its max between card and CPU")
        gerr = max(gerr, err)
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
    _require(abs(losses["cuda"] - per_doc) <= 1e-5, f"small packed model: "
             f"packed loss {losses['cuda']} != per-document {per_doc}")
    print(f"  small f32 packed model ({len(docs)} documents in "
          f"{packed['tokens'].shape[0]} rows of 48): loss |card - CPU| / CPU "
          f"= {rel:.2e}, |card - per-document| = "
          f"{abs(losses['cuda'] - per_doc):.2e}; {len(grads['cpu'])} "
          f"gradients within {gerr:.2e} of max |CPU|")


def phase4_serving(torch, np, card: str):
    """Full-width serving.  Returns (B1 launches, B1 row of the kernels'
    JSON at the serving shape, max |err| over captured inputs)."""
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
          f"(eager call {call_ms * 1e3:.2f} us), plain device "
          f"{plain_ms * 1e3:.2f} us (eager call {plain_call_ms * 1e3:.2f} "
          f"us), bound {bound_ms * 1e3:.3f} us by {bound_by} ({nbytes} B)"
          f"  [{card}]")
    row = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by}
    return launches, row, err


class _PlainOnCard(Exception):
    """A plain version was reached with a CUDA tensor on a main path."""


def _forbid_plain_on_card():
    """Make the scans' plain versions raise on CUDA tensors until the
    returned undo is called: proof that a main path ran only kernels."""
    from repro_torch.kernels import aaren_scan as b1_mod
    from repro_torch.kernels import aaren_scan_bwd as b2_mod

    saved = (b1_mod.aaren_scan_plain, b2_mod.aaren_scan_bwd_plain)

    def guard(fn):
        def wrapped(s, *args, **kw):
            if s.is_cuda:
                raise _PlainOnCard(f"{fn.__name__} reached with a CUDA tensor")
            return fn(s, *args, **kw)
        return wrapped

    b1_mod.aaren_scan_plain = guard(saved[0])
    b2_mod.aaren_scan_bwd_plain = guard(saved[1])

    def undo():
        b1_mod.aaren_scan_plain, b2_mod.aaren_scan_bwd_plain = saved
    return undo


def phase4b_training(torch, np, card: str, cfg, packed: bool = False):
    """Training of ``cfg`` (full width in :func:`main`), on
    ``SyntheticLMIterator`` batches or, with ``packed``, on
    ``PackedLMIterator`` batches through ``pack_sequences=True`` and the
    segmented kernels.  Returns ({kernel: launches}, {kernel: timing row at
    the training shape}, {kernel: max |err| on captured inputs})."""
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
        print(f"  {form}{name} at the training shape R={r} N={n} d={d}: "
              f"device {ms * 1e3:.2f} us (eager call {call_ms * 1e3:.2f} us), "
              f"plain device {plain_ms * 1e3:.2f} us (eager call "
              f"{plain_call_ms * 1e3:.2f} us), bound {bound_ms * 1e3:.3f} us "
              f"by {bound_by} ({nbytes} B), {ms / bound_ms:.1f}x the bound"
              f"  [{card}]")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "shape": [r, n, d]}
    return launches, out, errs


def phase4c_softmax_training(torch, np, card: str, cfg):
    """Training of the softmax ``cfg`` (full width in :func:`main`).
    Returns ({kernel: launches}, {kernel: timing row at the training
    shape}, {kernel: max |err| on the captured layer-0 inputs})."""
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
    data = SyntheticLMIterator(vocab=cfg.vocab, seq_len=TRAIN_N,
                               batch=TRAIN_B, seed=0)

    # In the first step B3 runs forward for layers 0..31, then the remat
    # recompute for 31..0; the backward runs for 31..0, so its last call
    # is layer 0's: capture those inputs (cloning launches nothing).
    calls = {"fwd": 0, "bwd": 0}
    captured = {}
    capturing = {"on": True}
    real_fwd, real_bwd = ops.flash_attention, ops.flash_attention_bwd

    def spy_fwd(*args, **kw):
        if capturing["on"]:
            calls["fwd"] += 1
        return real_fwd(*args, **kw)

    def spy_bwd(*args, **kw):
        if capturing["on"]:
            if calls["bwd"] == cfg.n_layers - 1:
                captured["args"] = [a.clone() for a in args]
                captured["kw"] = dict(kw)
            calls["bwd"] += 1
        return real_bwd(*args, **kw)

    finite = {"ok": True}
    losses = []

    def on_log(step, m):
        capturing["on"] = False
        finite["ok"] &= bool(np.isfinite(m["loss"])
                             and np.isfinite(m["grad_norm"]))
        losses.append(m["loss"])
        print(f"  step {step}: loss {m['loss']:.4f} grad_norm "
              f"{m['grad_norm']:.4f} {m['step_time_s'] * 1e3:.1f} ms")

    ops.flash_attention, ops.flash_attention_bwd = spy_fwd, spy_bwd
    torch.cuda.reset_peak_memory_stats()
    # The main path: counts from zero, read right after.
    fa.flash_attention.n_launches = 0
    fa.flash_bwd_dq.n_launches = fa.flash_bwd_dkv.n_launches = 0
    try:
        result = run_train_loop(step_fn, state, data,
                                LoopConfig(total_steps=steps, log_every=1),
                                on_log=on_log)
    finally:
        ops.flash_attention, ops.flash_attention_bwd = real_fwd, real_bwd
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
    print(f"  launches on the softmax training path over {steps} steps: B3 "
          f"{launches['flash_attention']} = 2 x {cfg.n_layers} x {steps}, "
          f"B4 {launches['flash_bwd_dq']} and B5 {launches['flash_bwd_dkv']}"
          f" = {cfg.n_layers} x {steps}")

    q, k, v, o, lse, do = captured["args"]
    kw = captured["kw"]
    _require(kw.get("q_lens") is None and kw.get("window") is None
             and kw.get("causal", True), f"layer 0's flash call: {kw}")
    errs = _check_flash(torch, q, k, v, do, None, True, None,
                        "training step, layer 0 (captured)")

    step_s = [m["step_time_s"] for _, m in result.history[TRAIN_WARM:]]
    step_ms = statistics.median(step_s) * 1e3
    tokens = TRAIN_B * TRAIN_N
    mfu = 6 * n_params * tokens / (step_ms / 1e3) / BF16_DENSE_FLOPS
    each = ", ".join(f"{s * 1e3:.1f}" for s in step_s)
    print(f"  softmax training B={TRAIN_B} N={TRAIN_N}: step median "
          f"{step_ms:.3f} ms over {len(step_s)} steps ({each} ms), "
          f"{tokens / (step_ms / 1e3):.1f} tokens/s  [{card}]")
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

    _print_profile(_device_profile(torch, one_step, 1), "softmax train step",
                   card, top=16)
    del train_state, result, state, params
    gc.collect()
    torch.cuda.empty_cache()
    rows = flash_kernel_times(torch, q, k, v, do, None, True, None, card)
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

    # 3. Kernels against their plain versions --------------------------------
    _phase("3 kernels against plain versions", t0)
    b1_err, b2_err = phase3_kernels(torch, np)
    seg_b1_err, seg_b2_err = phase3_segmented_kernels(torch, np)
    flash_errs = phase3_flash_kernels(torch, np)
    phase3_small_model(torch, np)
    phase3_small_softmax(torch, np)
    phase3_small_packed(torch, np)

    # 4. Full-width serving ------------------------------------------------
    _phase("4 full-width serving", t0)
    cfg = get_config(ARCH)
    _require((cfg.attn_mode, cfg.param_dtype, cfg.compute_dtype,
              cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.resolved_head_dim,
              cfg.d_ff, cfg.vocab) == ("aaren", "bfloat16", "bfloat16", 32,
                                       3072, 32, 96, 8192, 32064), str(cfg))
    serve_launches, b1_serve, err = phase4_serving(torch, np, card)
    b1_err = max(b1_err, err)
    gc.collect()               # the serving model went with its frame
    torch.cuda.empty_cache()

    # 4b. Full-width training ----------------------------------------------
    _phase("4b full-width training", t0)
    train_launches, train_rows, errs = phase4b_training(torch, np, card,
                                                        cfg)
    b1_err = max(b1_err, errs["aaren_scan"])
    b2_err = max(b2_err, errs["aaren_scan_bwd"])
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
    packed_launches, packed_rows, errs = phase4b_training(torch, np, card,
                                                          cfg, packed=True)
    seg_b1_err = max(seg_b1_err, errs["aaren_scan"])
    seg_b2_err = max(seg_b2_err, errs["aaren_scan_bwd"])

    # 5. Results ---------------------------------------------------------------
    _phase("5 results", t0)
    kernels = [
        {"name": "aaren_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/aaren_scan.cu",
         "replaces": "src/repro/kernels/aaren_scan.py:190",
         "launches": serve_launches + train_launches["aaren_scan"],
         "launches_by_path": {"serve": serve_launches,
                              "train": train_launches["aaren_scan"]},
         "max_abs_err": b1_err, **b1_serve, "library_ms": None,
         "shape": "serving tick; 'train' holds the residual form at the "
                  "training shape",
         "train": train_rows["aaren_scan"]},
        {"name": "aaren_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/aaren_scan_bwd.cu",
         "replaces": "src/repro/kernels/aaren_scan_bwd.py:183",
         "launches": train_launches["aaren_scan_bwd"],
         "launches_by_path": {"serve": 0,
                              "train": train_launches["aaren_scan_bwd"]},
         "max_abs_err": b2_err, **train_rows["aaren_scan_bwd"],
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
                                 "train_packed": packed_launches[name]},
            "max_abs_err": err, **packed_rows[name], "library_ms": None,
            "shape": "packed training, layer 0 (residual form for B1)"})
    flash_meta = (
        ("flash_attention", "flash_fwd.cu", ":244",
         {"serve": gen_b3, "train": soft_launches["flash_attention"]}),
        ("flash_bwd_dq", "flash_bwd.cu", ":548",
         {"serve": 0, "train": soft_launches["flash_bwd_dq"]}),
        ("flash_bwd_dkv", "flash_bwd.cu", ":581",
         {"serve": 0, "train": soft_launches["flash_bwd_dkv"]}),
    )
    for name, source, line, by_path in flash_meta:
        row = flash_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/flash_attention.py{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": flash_errs[name],
            **{key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "library": ("scaled_dot_product_attention forward" if name ==
                        "flash_attention" else "scaled_dot_product_attention"
                        " backward, B4 + B5 together"),
            "shape": "training, layer 0: B=4 H=G=32 N=1024 d=96 bf16 causal"})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
