"""End-to-end training script on the PyTorch port: a ~100M-parameter Aaren
LM on the synthetic Markov+induction stream, with an Aaren-vs-Transformer
loss comparison at identical hyperparameters (the paper's protocol).

Run:  PYTHONPATH=src python examples/torch/train_lm.py [--steps 300] \
          [--small] [--device cpu]

Sequence packing: ``--pack`` switches the data stream to ragged documents
bin-packed into fixed rows (segment ids + per-document positions); the
attention stack keeps documents independent and the logs gain a
``token_util`` column (real tokens per row slot).

Not in the port yet, and refused when asked for: the mesh flags
``--context-parallel``, ``--model-parallel`` and ``--fsdp`` (ROADMAP queue
A item 11).  Like its JAX twin, the example has no checkpoint flag; the
training launcher (``python -m repro_torch.launch.train``) has
``--ckpt-dir`` and ``--guard``.
"""

from __future__ import annotations

import argparse

from repro_torch.configs.base import ArchConfig
from repro_torch.data.packing import PackedLMIterator
from repro_torch.data.synthetic import SyntheticLMIterator
from repro_torch.device import resolve_device
from repro_torch.models.factory import build
from repro_torch.models.param import count_params
from repro_torch.train.loop import LoopConfig, run_train_loop
from repro_torch.train.optim import make_optimizer, warmup_cosine
from repro_torch.train.state import init_train_state, make_train_step


def lm_100m(attn_mode: str, small: bool) -> ArchConfig:
    if small:  # CI-speed variant
        return ArchConfig(
            name=f"lm-small-{attn_mode}", family="dense", n_layers=2,
            d_model=128, n_heads=4, n_kv_heads=4, d_ff=512, vocab=512,
            pattern=("attn",), mlp_pattern=("swiglu",), attn_mode=attn_mode,
            param_dtype="float32", compute_dtype="float32", remat="none")
    # ~100M params: 12L x 768 (GPT-2-small scale)
    return ArchConfig(
        name=f"lm-100m-{attn_mode}", family="dense", n_layers=12,
        d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072, vocab=8192,
        pattern=("attn",), mlp_pattern=("swiglu",), attn_mode=attn_mode,
        param_dtype="float32", compute_dtype="float32", remat="none")


def _refuse_later_flags(args) -> None:
    later = [("--context-parallel", args.context_parallel != 1),
             ("--model-parallel", args.model_parallel != 1),
             ("--fsdp", args.fsdp > 1)]
    for flag, asked in later:
        if asked:
            raise NotImplementedError(
                f"{flag} comes with a later slice of the port (ROADMAP "
                "queue A item 11)")


def train_one(attn_mode: str, args) -> list:
    cfg = lm_100m(attn_mode, args.small)
    api = build(cfg)
    params = api.init(args.seed, device=resolve_device(args.device))
    print(f"[{attn_mode}] params: {count_params(api.specs())/1e6:.1f}M")
    opt = make_optimizer("adamw",
                         warmup_cosine(args.lr, args.steps // 10, args.steps))
    state = init_train_state(params, opt)
    step = make_train_step(api.loss, opt, n_microbatches=args.microbatches)
    data = (PackedLMIterator if args.pack else SyntheticLMIterator)(
        vocab=cfg.vocab, seq_len=args.seq_len, batch=args.batch,
        seed=args.seed)

    def log(s, m):
        util = f" util {m['token_util']:.2f}" if "token_util" in m else ""
        print(f"  [{attn_mode}] step {s:4d} loss {m['loss']:.4f} "
              f"({m['step_time_s']*1e3:.0f} ms){util}")

    res = run_train_loop(
        step, state, data,
        LoopConfig(total_steps=args.steps,
                   log_every=max(args.steps // 10, 1), seed=args.seed,
                   pack_sequences=args.pack),
        on_log=log)
    return res.history


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--context-parallel", type=int, default=1,
                    help="size of the seq mesh axis (1 = off)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="size of the model mesh axis (tensor parallelism)")
    ap.add_argument("--fsdp", type=int, default=0,
                    help="size of the data mesh axis (0 = auto, 1 = off)")
    ap.add_argument("--pack", action="store_true",
                    help="train on bin-packed ragged documents "
                         "(segment-aware attention, DESIGN.md §Packing)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _refuse_later_flags(args)

    hists = {"aaren": train_one("aaren", args)}
    if not args.skip_baseline:
        hists["softmax"] = train_one("softmax", args)
        fa = hists["aaren"][-1][1]["loss"]
        fs = hists["softmax"][-1][1]["loss"]
        print(f"\nfinal loss — aaren: {fa:.4f}  transformer: {fs:.4f}  "
              f"(rel gap {abs(fa-fs)/fs:.2%}; paper claim: comparable)")
    return hists


if __name__ == "__main__":
    main()
