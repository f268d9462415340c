"""Serving launcher: the streaming engine or wave generation on one device.

Parameters are random, drawn from ``--seed``; prompts are random token ids
from ``--seed + 1``.  A warm-up step runs before the timed section, and
warm-up and steady-state time are reported separately.  Runs on the card
unless ``--device cpu`` is given.  ``--attn-mode softmax`` serves the
softmax baseline, whose KV-cache decode state only the wave engine takes;
the wave engine prints the decode state's size.

Observability: ``--events`` writes the JSONL event log, ``--metrics-out``
dumps the metrics-registry snapshot at exit, and ``--metrics-port`` serves
live Prometheus text at ``/metrics`` (plus the snapshot document at
``/metrics.json``) on 127.0.0.1 while the engine runs.

Example::

    python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
        --engine streaming --requests 16 --slots 8 --chunk 16 --max-new 32
    python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
        --attn-mode softmax --engine wave --requests 4 --prompt-len 128
    python -m repro_torch.launch.serve --arch phi3-mini-3.8b --smoke \
        --events serve_events.jsonl --metrics-out serve_metrics.json
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models.factory import build
from repro_torch.obs.events import EventLog, use_events
from repro_torch.obs.export import serve_metrics, write_snapshot
from repro_torch.obs.metrics import MetricsRegistry, use_metrics
from repro_torch.serving.engine import (
    StreamingEngine,
    decode_state_bytes,
    generate,
)
from repro_torch.serving.sampler import greedy_sampler, temperature_sampler


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--attn-mode", default="aaren",
                    choices=["aaren", "softmax"])
    ap.add_argument("--engine", default="streaming",
                    choices=["streaming", "wave"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=16,
                    help="prefill chunk size of the streaming engine")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--events", default=None,
                    help="path of the JSONL event log to write "
                         "(repro_torch.obs.events; off when omitted)")
    ap.add_argument("--metrics-out", default=None,
                    help="path of the metrics-snapshot JSON dumped at exit")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text at /metrics on this port "
                         "while the engine runs (0 = ephemeral port)")
    args = ap.parse_args(argv)

    # Ambient observability for the whole serve run: a registry whenever
    # any obs output was asked for (the endpoints need one even if only
    # --metrics-port was given).
    obs = contextlib.ExitStack()
    registry = None
    if (args.events is not None or args.metrics_out is not None
            or args.metrics_port is not None):
        registry = obs.enter_context(use_metrics(MetricsRegistry()))
        if args.events is not None:
            log = obs.enter_context(use_events(EventLog(args.events)))
            obs.callback(log.close)
    http = None
    if args.metrics_port is not None:
        http = serve_metrics(registry, args.metrics_port)
        print(f"metrics: http://{http.server_address[0]}:"
              f"{http.server_address[1]}/metrics")
    try:
        with obs:
            _run(args)
            if args.metrics_out is not None:
                write_snapshot(args.metrics_out, registry)
                print(f"metrics snapshot: {args.metrics_out}")
    finally:
        if http is not None:
            http.shutdown()


def _run(args):
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    api = build(cfg.replace(attn_mode=args.attn_mode))
    t0 = time.perf_counter()
    params = api.init(args.seed, device=args.device)
    device = params["embed"]["table"].device
    _sync(device)
    print(f"[{args.engine}] init {time.perf_counter() - t0:.2f}s on {device}")
    sampler = (greedy_sampler if args.temperature == 0
               else temperature_sampler(args.temperature, top_k=50))
    prompts = np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, (args.requests, args.prompt_len))
    n_tokens = args.requests * args.max_new

    if args.engine == "wave":
        # cache_len pinned to the timed call's, as in the JAX launcher.
        cache_len = args.prompt_len + args.max_new
        t0 = time.perf_counter()
        generate(api, params, prompts, 2, sampler=sampler, seed=args.seed,
                 cache_len=cache_len)
        _sync(device)
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        toks, states = generate(api, params, prompts, args.max_new,
                                sampler=sampler, seed=args.seed,
                                cache_len=cache_len)
        steady_s = time.perf_counter() - t0
        print(f"[wave] warm-up {warm_s:.2f}s | steady {steady_s:.2f}s for "
              f"{tuple(toks.shape)} = {n_tokens} tokens "
              f"({n_tokens / steady_s:.0f} tok/s); decode state "
              f"{decode_state_bytes(states) / 2**20:.3f} MiB")
        return
    eng = StreamingEngine(api, params, n_slots=args.slots, chunk=args.chunk,
                          sampler=sampler, seed=args.seed)
    warm_s = eng.warmup()
    for p in prompts:
        eng.submit(p, args.max_new)
    t0 = time.perf_counter()
    out = eng.run()
    steady_s = time.perf_counter() - t0
    served = sum(len(v) for v in out.values())
    print(f"[streaming] warm-up {warm_s:.2f}s | steady {steady_s:.2f}s for "
          f"{len(out)} requests / {served} tokens "
          f"({served / steady_s:.0f} tok/s) over {args.slots} slots, "
          f"chunk {eng.chunk}")


if __name__ == "__main__":
    main()
