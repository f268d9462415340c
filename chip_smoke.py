#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

Run from the root of the repository, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; no phase catches its
own error):

1. Toolchain and card: ``nvidia-smi``, ``torch.version.cuda``, ``nvcc``;
   TF32 off for matmuls and cuDNN.
2. Build every CUDA kernel of the path from ``src/repro_torch/csrc``.
3. Each kernel against its plain PyTorch version on the card: edge shapes,
   the inputs of a real serving tick at the first and last layer, and a
   small f32 model served on the card (kernels) and on the CPU (plain
   versions) with identical greedy tokens.
4. Full width: ``phi3-mini-3.8b`` as registered (bf16, 32 layers, d_model
   3072, 32 x 96 heads), random weights from a seed, 16 requests through
   the ``StreamingEngine`` (8 slots, chunk 16, prompts of 32-256 tokens,
   32 new tokens each), then one wave ``generate`` call (B = 4, P = 128, 8
   new tokens).  Launch counts are zeroed just before and read just after.
   Then a ``torch.profiler`` view of five ticks (device busy share, largest
   kernels) and each kernel's device time at the serving shape (a replayed
   CUDA graph, so host overhead drops out) beside its eager per-call time,
   its plain version's and its bound.
5. Result lines: the kernels' JSON, the card, and the contract line.
"""

from __future__ import annotations

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
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
F32_OPS_PER_S = 67e12             # the same, f32 outside the tensor cores
TOL = dict(rtol=1e-4, atol=1e-4)  # the JAX suite's bar for this kernel


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
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


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


def _compare_scan(torch, args, label) -> float:
    """B1 (CUDA kernel) against its plain version on the same tensors."""
    from repro_torch.kernels.aaren_scan import aaren_scan, aaren_scan_plain

    got = aaren_scan(*args)
    want = aaren_scan_plain(*args)
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


def _tick_profile(torch, eng, reqs, n_ticks: int = 5):
    """Device busy time of ``n_ticks`` engine ticks from ``torch.profiler``.

    Returns (wall ms per tick, device ms per tick, [(kernel, device ms per
    tick), ...] largest first), or None when the profiler saw no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for p in reqs:
        eng.submit(p, MAX_NEW)
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_ticks
    kernels = [(e.key, e.self_device_time_total / 1e3 / n_ticks)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    eng.run()
    device_ms = sum(ms for _, ms in kernels)
    if device_ms == 0:
        return None
    return wall_ms, device_ms, sorted(kernels, key=lambda kv: -kv[1])


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import ops
    from repro_torch.kernels.aaren_scan import aaren_scan, aaren_scan_plain
    from repro_torch.models.factory import build
    from repro_torch.models.lm import lm_state_init
    from repro_torch.models.param import count_params
    from repro_torch.serving.engine import StreamingEngine, generate
    from repro_torch.serving.sampler import greedy_sampler

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
    max_err = 0.0
    edge_cases = [
        ("single token, empty carry", 1, 1, 8, False, (), 3.0),
        ("odd N, R % 32 != 0, carry", 7, 5, 96, True, (), 3.0),
        ("prime N, all-padding rows", 37, 97, 96, False, (0, 5), 3.0),
        ("serving N, padding row + carry", 33, 16, 96, True, (3,), 3.0),
        ("extreme scores (+-80)", 6, 48, 128, True, (), 80.0),
        ("widest d", 5, 33, 256, True, (), 3.0),
    ]
    for i, (label, r, n, d, carry, pad, spread) in enumerate(edge_cases):
        args = _scan_inputs(torch, np, r, n, d, carry, seed=i,
                            pad_rows=pad, spread=spread)
        max_err = max(max_err, _compare_scan(torch, args, label))

    # A small f32 model: kernel path on the card == plain path on the CPU.
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

    # 4. Full width ------------------------------------------------------------
    _phase("4 full width", t0)
    cfg = get_config(ARCH)
    _require((cfg.attn_mode, cfg.param_dtype, cfg.compute_dtype,
              cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.resolved_head_dim,
              cfg.d_ff, cfg.vocab) == ("aaren", "bfloat16", "bfloat16", 32,
                                       3072, 32, 96, 8192, 32064), str(cfg))
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

    def capture(*args):
        captured.append([a.clone() for a in args])
        return real_scan(*args)

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
    for layer in (0, cfg.n_layers - 1):
        max_err = max(max_err, _compare_scan(
            torch, captured[layer], f"serving tick, layer {layer}"))
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
    gen_toks, _ = generate(api, params, gen_prompts, GEN_NEW,
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
    print(f"  generate B={GEN_B} P={GEN_P} new={GEN_NEW}: {gen_s:.3f} s  "
          f"[{card}]")
    print(f"  B1 launches on the main path: {launches} = {cfg.n_layers} x "
          f"({ticks} ticks + 1 prefill)")

    # Where a tick's time goes (after the counts were read).
    prof = _tick_profile(torch, eng, reqs[:SLOTS])
    if prof is None:
        print("  tick profile: the profiler saw no device time (not measured)")
    else:
        wall_ms, device_ms, kernels = prof
        print(f"  tick profile over 5 ticks: wall {wall_ms:.3f} ms, device "
              f"busy {device_ms:.3f} ms per tick ({device_ms / wall_ms:.1%})"
              f"  [{card}]")
        for key, ms in kernels[:8]:
            print(f"    {ms:9.3f} ms/tick  {key[:100]}")

    # B1 at the serving shape: device time from a replayed CUDA graph, the
    # eager per-call time (wrapper included), the plain version, the bound.
    s, v, m0, u0, w0 = captured[0]
    r, n = s.shape
    d = v.shape[-1]
    kernel_ms = _graph_ms(torch, lambda: aaren_scan(s, v, m0, u0, w0), 200)
    plain_ms = _graph_ms(torch, lambda: aaren_scan_plain(s, v, m0, u0, w0),
                         20)
    kernel_call_ms = _time_ms(torch, lambda: aaren_scan(s, v, m0, u0, w0),
                              200)
    plain_call_ms = _time_ms(torch,
                             lambda: aaren_scan_plain(s, v, m0, u0, w0), 20)
    # Each input read once, each output written once (f32); the f32 work is
    # ~4 operations per element of w per token plus ~5 per token of a row.
    nbytes = 4 * r * n * (2 * d + 1) + 8 * r * (d + 2)
    nops = r * n * (4 * d + 5)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"  B1 at R={r} N={n} d={d}: device {kernel_ms * 1e3:.3f} us "
          f"(eager call {kernel_call_ms * 1e3:.2f} us), plain device "
          f"{plain_ms * 1e3:.2f} us (eager call {plain_call_ms * 1e3:.2f} "
          f"us), bound {bound_ms * 1e3:.3f} us by {bound_by} ({nbytes} B, "
          f"{nops} f32 ops)  [{card}]")

    # 5. Results ---------------------------------------------------------------
    _phase("5 results", t0)
    print(json.dumps({"kernels": [{
        "name": "aaren_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/aaren_scan.cu",
        "replaces": "src/repro/kernels/aaren_scan.py:190",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
