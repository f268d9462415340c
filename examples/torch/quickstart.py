"""Quickstart on the PyTorch port: the paper in 80 lines.

1.  Attention == an RNN: the same output three ways (conventional /
    recurrent O(1)-memory / parallel prefix scan).
2.  A 2-layer Aaren LM learns a Markov token stream (trained through the
    prefix-scan kernels B1 and B2 on the card).
3.  It then streams tokens with a constant-size decode state.  (A pure copy
    task would be the wrong demo: Aaren's query is a learned constant, not
    content-dependent, so exact random-content recall is outside its
    design — the paper's own §G limitation.)

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import smoke_config
from repro_torch.core.scan_attention import (
    attention_many_to_many,
    attention_many_to_one,
    attention_recurrent,
)
from repro_torch.data.synthetic import SyntheticLMIterator
from repro_torch.device import resolve_device
from repro_torch.models.factory import build
from repro_torch.serving.engine import StreamingEngine, decode_state_bytes
from repro_torch.train.optim import make_optimizer, warmup_cosine
from repro_torch.train.state import init_train_state, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. attention is an RNN ----------------------------------------------
    d, n = 16, 32
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=device)
               for shape in ((d,), (n, d), (n, d)))
    o_conventional = attention_many_to_one(q, k, v)      # softmax(qK^T)V
    o_rnn = attention_recurrent(q, k, v)                 # O(1)-memory cell
    o_scan = attention_many_to_many(q, k, v)[-1]         # parallel prefix scan
    print("max |conventional - RNN|        :",
          float((o_conventional - o_rnn).abs().max()))
    print("max |conventional - prefix-scan|:",
          float((o_conventional - o_scan).abs().max()))

    # --- 2 + 3. an Aaren LM: train in parallel, stream in O(1) ---------------
    cfg = smoke_config("phi3-mini-3.8b", n_layers=2, d_model=64, d_ff=128,
                       vocab=64)
    api = build(cfg)
    params = api.init(0, device=device)
    opt = make_optimizer("adamw", warmup_cosine(2e-3, args.steps // 10,
                                                args.steps))
    state = init_train_state(params, opt)
    step = make_train_step(api.loss, opt)
    data = SyntheticLMIterator(vocab=64, seq_len=64, batch=16, copy_p=0.0)

    print("\ntraining a 2-layer Aaren LM on a Markov token stream:")
    first_loss = None
    for i in range(args.steps):
        state, m = step(state, next(data))
        first_loss = first_loss or float(m["loss"])
        if i % 50 == 0 or i == args.steps - 1:
            print(f"  step {i:3d}  loss {float(m['loss']):.3f}")
    last_loss = float(m["loss"])
    print(f"  loss dropped {first_loss:.2f} -> {last_loss:.2f} "
          f"(entropy floor of the chain is > 0)")

    print("\nstreaming generation (constant-memory decode):")
    eng = StreamingEngine(api, state.params, n_slots=2)
    prompt = next(data)["tokens"][0, :16]
    rid = eng.submit(prompt, 8)
    out = eng.run()
    print("  prompt:", [int(x) for x in prompt])
    print("  generated:", out[rid])
    print("  decode state:", decode_state_bytes(eng.states) // 2,
          "bytes/slot — independent of sequence length")
    return {"first_loss": first_loss, "last_loss": last_loss,
            "generated": out[rid]}


if __name__ == "__main__":
    main()
