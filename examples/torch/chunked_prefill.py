"""Chunked prefill through the port's serving engine (paper App. A, system
level).

A long prompt is consumed in fixed-size chunks by ``StreamingEngine``'s one
fixed-shape step: each chunk folds its (m, u, w) statistics into the carried
per-layer state — O(chunk) activation memory instead of O(N) — and the
engine interleaves those chunks with other slots' decode steps.  The outputs
match one-shot wave prefill (up to float associativity across chunk
boundaries); the script fails if they do not.

The chunk math lives in ``repro_torch.models.lm.lm_prefill_chunk``, through
the prefix-scan kernel B1 on the card.

Run:  PYTHONPATH=src python examples/torch/chunked_prefill.py [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.factory import build
from repro_torch.serving.engine import (
    StreamingEngine,
    decode_state_bytes,
    generate,
)


def main(argv=None) -> bool:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=64)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = smoke_config("phi3-mini-3.8b", n_layers=2, d_model=64, d_ff=128,
                       vocab=256)
    api = build(cfg)
    params = api.init(0, device=device)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab,
                                                (2, args.prompt))

    # one-shot wave prefill (O(PROMPT) activations) — the reference
    toks, _ = generate(api, params, prompts, args.new)

    # chunked prefill via the engine: the same prompts cross the carry in
    # PROMPT // CHUNK fixed-shape steps of one shared step function
    eng = StreamingEngine(api, params, n_slots=2, chunk=args.chunk)
    warm_s = eng.warmup()
    rids = [eng.submit(prompts[i], args.new) for i in range(2)]
    out = eng.run()

    match = all(out[rid] == toks[i].tolist() for i, rid in enumerate(rids))
    n_chunks = -(-args.prompt // args.chunk)
    state_kib = decode_state_bytes(eng.states) / 2 / 2**10
    print(f"prompt length {args.prompt}, chunk {args.chunk} ({n_chunks} "
          f"chunks, {n_chunks}x less activation memory than one-shot "
          "prefill)")
    print(f"engine warm-up {warm_s:.2f}s; chunked == one-shot outputs: "
          f"{match}")
    print(f"carried state per slot: {state_kib:.1f} KiB — constant in N")
    if not match:
        raise AssertionError("chunked prefill diverged from one-shot prefill")
    return match


if __name__ == "__main__":
    main()
