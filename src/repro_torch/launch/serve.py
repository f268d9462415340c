"""Serving launcher: the streaming engine or wave generation on one device.

Parameters are random, drawn from ``--seed``; prompts are random token ids
from ``--seed + 1``.  A warm-up step runs before the timed section, and
warm-up and steady-state time are reported separately.  Runs on the card
unless ``--device cpu`` is given.  ``--attn-mode softmax`` serves the
softmax baseline, whose KV-cache decode state only the wave engine takes;
the wave engine prints the decode state's size.

The serving tier: ``--replicas N`` serves through a ``ReplicatedRouter``
of N streaming engines on the one device (``--route-policy``; ``--drain R``
drains replica R after three ticks, migrating its requests' carries to the
survivors); ``--max-queue`` bounds the admission queue (the router's front
queue with replicas), ``--deadline-s`` gives every request a deadline, and
``--prefix-cache-mb`` attaches a prefix-carry cache (``--pin-prefix``,
``--prefix-cache-min-hits``; ``--prefix-cache-dir`` loads it at start and
saves it at exit), shared by the replicas.

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
    python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
        --replicas 2 --slots 8 --drain 1 --prefix-cache-mb 64
    python -m repro_torch.launch.serve --arch recurrentgemma-9b \
        --requests 16 --slots 8 --max-new 32
    python -m repro_torch.launch.serve --arch recurrentgemma-9b \
        --attn-mode softmax --engine wave --requests 2 --prompt-len 2304
    python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --requests 16 --slots 8 --max-new 32
    python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
        --requests 16 --slots 8 --chunk 16 --max-new 32
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
from repro_torch.serving import (
    EngineOverloaded,
    PrefixCache,
    ReplicatedRouter,
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
    ap.add_argument("--chunk", type=int, default=0,
                    help="prefill chunk size of the streaming engine (0 = "
                         "the engine's default: 16 for an all-Aaren model, "
                         "1 with RG-LRU layers)")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="admission queue bound; overflow submits are shed "
                         "(0 = unbounded).  With --replicas > 1 this bounds "
                         "the router's front queue; the tier sheds only "
                         "when every replica is saturated AND the front "
                         "queue is full")
    ap.add_argument("--replicas", type=int, default=1,
                    help="run N streaming-engine replicas behind the "
                         "occupancy-aware router (each with --slots slots; "
                         "requests are dispatched per --route-policy, and "
                         "a prefix cache is shared tier-wide)")
    ap.add_argument("--route-policy", default="least-occupancy",
                    choices=["least-occupancy", "round-robin", "jsq"],
                    help="replica dispatch policy (--replicas > 1): "
                         "emptiest batch first, strict rotation, or "
                         "join-shortest-queue")
    ap.add_argument("--drain", type=int, default=None, metavar="R",
                    help="mid-run, drain replica R: its queued + active "
                         "requests carry-migrate to the survivors "
                         "byte-identically (needs --replicas >= 2)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request wall-clock deadline; expired requests "
                         "error out (0 = none)")
    ap.add_argument("--prefix-cache-mb", type=float, default=0.0,
                    help="prompt-prefix carry cache budget in MiB "
                         "(streaming engine only; 0 = off)")
    ap.add_argument("--prefix-cache-min-hits", type=int, default=2,
                    help="boundary must be seen this many times before its "
                         "carry is cached (pinned prefixes skip this)")
    ap.add_argument("--pin-prefix", action="append", default=[],
                    metavar="IDS",
                    help="comma-separated token ids of a prefix to pin "
                         "(always cached, never evicted); repeatable")
    ap.add_argument("--prefix-cache-dir", default=None,
                    help="directory to load the prefix cache from at start "
                         "and save it to at exit (crc'd checkpoint chunks)")
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
        if args.prefix_cache_mb:
            # A clean no-op, so one launch script serves both families.
            print("[wave] --prefix-cache-mb ignored: prefix-state caching "
                  "needs the streaming engine's position-free carries")
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
    cache = _prefix_cache(args)
    if args.replicas > 1:
        _run_router(args, api, params, sampler, prompts, cache)
        return
    eng = StreamingEngine(api, params, n_slots=args.slots,
                          chunk=args.chunk or None,
                          sampler=sampler, seed=args.seed,
                          max_queue=args.max_queue or None,
                          prefix_cache=cache)
    _load_cache(args, cache, "streaming")
    warm_s = eng.warmup()
    deadline = args.deadline_s or None
    for p in prompts:
        try:
            eng.submit(p, args.max_new, deadline_s=deadline)
        except EngineOverloaded:
            pass   # shed at the door; counted in eng.n_shed
    t0 = time.perf_counter()
    out = eng.run()
    steady_s = time.perf_counter() - t0
    served = sum(len(v) for v in out.values())
    print(f"[streaming] warm-up {warm_s:.2f}s | steady {steady_s:.2f}s for "
          f"{len(out)} requests / {served} tokens "
          f"({served / steady_s:.0f} tok/s) over {args.slots} slots, "
          f"chunk {eng.chunk}; per-slot state "
          f"{decode_state_bytes(eng.states) / args.slots / 2**10:.1f} KiB"
          f" (constant in sequence length)")
    if eng.n_shed or eng.errors or eng.n_quarantined:
        print(f"[streaming] degraded: shed {eng.n_shed}, errored "
              f"{len(eng.errors)} (deadline/poison), quarantined "
              f"{eng.n_quarantined} slots")
    if cache is not None:
        st = cache.stats()
        print(f"[streaming] prefix cache: {st['entries']} entries / "
              f"{st['bytes'] / 2**10:.1f} KiB, hit rate "
              f"{st['hit_rate']:.0%}, {st['prefill_tokens_saved']} "
              "prefill tokens saved")
        _save_cache(args, cache, "streaming")


def _prefix_cache(args):
    if not args.prefix_cache_mb:
        return None
    return PrefixCache(max_bytes=int(args.prefix_cache_mb * 2**20),
                       min_hits=args.prefix_cache_min_hits)


def _load_cache(args, cache, tag: str) -> None:
    """Pin the ``--pin-prefix`` prefixes and load ``--prefix-cache-dir``
    (after an engine bound the cache to its chunk grid)."""
    if cache is None:
        return
    for spec in args.pin_prefix:
        cache.pin([int(t) for t in spec.split(",") if t.strip()])
    if args.prefix_cache_dir:
        try:
            got = cache.load(args.prefix_cache_dir)
            print(f"[{tag}] prefix cache: restored step {got} "
                  f"({len(cache)} entries)")
        except FileNotFoundError:
            pass   # first run: nothing to restore yet


def _save_cache(args, cache, tag: str) -> None:
    if args.prefix_cache_dir:
        cache.save(args.prefix_cache_dir, 0)
        print(f"[{tag}] prefix cache saved to {args.prefix_cache_dir}")


def _run_router(args, api, params, sampler, prompts, cache):
    """--replicas > 1: the replicated tier (serving/router.py)."""
    router = ReplicatedRouter(
        api, params, n_replicas=args.replicas, n_slots=args.slots,
        chunk=args.chunk or None, sampler=sampler, seed=args.seed,
        policy=args.route_policy, max_queue=args.max_queue or None,
        prefix_cache=cache)
    _load_cache(args, cache, "router")
    warm_s = router.warmup()
    deadline = args.deadline_s or None
    for p in prompts:
        try:
            router.submit(p, args.max_new, deadline_s=deadline)
        except EngineOverloaded:
            pass   # tier-wide shed; counted in router.n_shed
    t0 = time.perf_counter()
    try:
        if args.drain is not None:
            for _ in range(3):             # let the victim pick up work
                router.step()
            n = router.drain(args.drain)
            print(f"[router] drained replica {args.drain}: {n} requests "
                  "carry-migrated to survivors")
        out = router.run()
    finally:
        router.close()
    steady_s = time.perf_counter() - t0
    served = sum(len(v) for v in out.values())
    st = router.stats()
    print(f"[router] warm-up {warm_s:.2f}s | steady {steady_s:.2f}s for "
          f"{len(out)} requests / {served} tokens "
          f"({served / steady_s:.0f} tok/s aggregate) over "
          f"{args.replicas}x{args.slots} slots, policy "
          f"{args.route_policy}")
    print(f"[router] tier: alive {st['alive']}/{st['n_replicas']}, shed "
          f"{st['shed']}, rerouted {st['rerouted']}, migrated "
          f"{st['migrated']}, failed-over {st['failed_over']}, errors "
          f"{st['errors']}")
    if cache is not None:
        cst = cache.stats()
        print(f"[router] shared prefix cache: {cst['entries']} entries, "
              f"hit rate {cst['hit_rate']:.0%}, "
              f"{cst['prefill_tokens_saved']} prefill tokens saved")
        _save_cache(args, cache, "router")


if __name__ == "__main__":
    main()
