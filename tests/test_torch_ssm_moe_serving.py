"""Serving and launching the port's SSM and MoE families.

A bf16-compute mamba2 smoke model (SSD ``s`` in f32, conv tails in bf16,
widened exactly to f32 on the host): a prefix-cache hit, an export +
inject into a second engine and a snapshot restore (in memory and through
``save``/``load``) each give tokens bit-equal to the cold run.  The same
drain and snapshot for an Aaren qwen3-moe smoke model at chunk 4 (routing
is per chunk, so the migrated requests must route as the cold run did).
Then the training and serving launchers with ``--smoke`` on the CPU for
``mamba2-1.3b``, ``qwen3-moe-30b-a3b`` and ``dbrx-132b`` (AdaFactor and
LayerNorm), both modes where a mode exists.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.factory import build
from repro_torch.serving import PrefixCache
from repro_torch.serving.engine import StreamingEngine


def _tokens(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def _serve(engine, prompts, max_new):
    rids = [engine.submit(p, m) for p, m in zip(prompts, max_new)]
    out = engine.run()
    return [list(map(int, out[r])) for r in rids]


def _drain_and_snapshot(api, params, prompts, max_new, cold, tmp_path,
                        chunk=None):
    """Export + inject after 5 ticks, and a snapshot after 7 restored in
    memory and through save/load: tokens bit-equal to ``cold`` (a request
    that finished before the event counts from the source engine)."""
    def engine():
        return StreamingEngine(api, params, n_slots=2, chunk=chunk)

    def run_until(eng, ticks):
        rids = [eng.submit(p, m) for p, m in zip(prompts, max_new)]
        for _ in range(ticks):
            eng.step()
        return rids

    src = engine()
    rids = run_until(src, 5)
    dst = engine()
    for desc in src.export_requests():
        dst.inject_request(desc)
    out = {**src.finished, **dst.run()}
    assert [list(map(int, out[r])) for r in rids] == cold

    src = engine()
    rids = run_until(src, 7)
    snap = src.snapshot()
    src.save(str(tmp_path), 0)
    for restore in ("snapshot", "load"):
        eng = engine()
        if restore == "snapshot":
            eng.restore(snap)
        else:
            eng.load(str(tmp_path))
        out = {**src.finished, **eng.run()}
        assert [list(map(int, out[r])) for r in rids] == cold


def test_ssd_prefix_hit_drain_and_snapshot_are_bit_equal(tmp_path):
    api = build(smoke_config("mamba2-1.3b", compute_dtype="bfloat16"))
    params = api.init(0, device="cpu")
    shared = _tokens(api.cfg.vocab, 6, seed=20)
    prompts = [np.concatenate([shared, _tokens(api.cfg.vocab, n, seed=21 + n)])
               for n in (2, 3, 1, 4)]
    max_new = [4, 3, 5, 2]
    cold = _serve(StreamingEngine(api, params, n_slots=2), prompts, max_new)

    cache = PrefixCache(max_bytes=1 << 20, min_hits=1)
    eng = StreamingEngine(api, params, n_slots=2, prefix_cache=cache)
    cache.pin(shared)
    assert _serve(eng, prompts, max_new) == cold
    assert cache.n_hits >= 2 and cache.tokens_saved >= 12
    carry = [e.carry for e in cache._entries.values()][0]
    assert len(carry) == api.cfg.n_layers
    assert carry[0]["s"].dtype == np.float32
    assert carry[0]["s"].shape == (1, 4, 64, 16)
    assert carry[0]["conv"].dtype == np.float32
    assert carry[0]["conv"].shape == (1, 3, 256 + 2 * 16)
    _drain_and_snapshot(api, params, prompts, max_new, cold, tmp_path)
    eng = StreamingEngine(api, params, n_slots=2)
    assert eng.states[0]["conv"].dtype == torch.bfloat16
    assert eng.states[0]["s"].dtype == torch.float32


def test_moe_drain_and_snapshot_are_bit_equal(tmp_path):
    api = build(smoke_config("qwen3-moe-30b-a3b", compute_dtype="bfloat16"))
    params = api.init(0, device="cpu")
    prompts = [_tokens(api.cfg.vocab, n, seed=30 + n) for n in (9, 3, 6, 4)]
    max_new = [4, 3, 5, 2]
    cold = _serve(StreamingEngine(api, params, n_slots=2, chunk=4), prompts,
                  max_new)
    _drain_and_snapshot(api, params, prompts, max_new, cold, tmp_path,
                        chunk=4)


@pytest.mark.parametrize("arch,mode", [
    ("mamba2-1.3b", "aaren"), ("qwen3-moe-30b-a3b", "aaren"),
    ("qwen3-moe-30b-a3b", "softmax"), ("dbrx-132b", "aaren"),
    ("dbrx-132b", "softmax")])
def test_launchers_run_on_cpu(arch, mode, capsys):
    """Three training steps, then serving: the streaming engine where the
    model streams (SSD at chunk 1), the wave engine in softmax mode."""
    train_cli.main(["--arch", arch, "--smoke", "--attn-mode", mode,
                    "--device", "cpu", "--steps", "3", "--batch", "2",
                    "--seq-len", "16"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke attn_mode={mode}" in out
    assert out.count(" loss=") == 3 and "done at step 3" in out
    losses = [float(line.split(" loss=")[1].split()[0])
              for line in out.splitlines() if " loss=" in line]
    assert all(np.isfinite(losses))
    engine = "wave" if mode == "softmax" else "streaming"
    serve_cli.main(["--arch", arch, "--smoke", "--attn-mode", mode,
                    "--device", "cpu", "--engine", engine, "--requests", "3",
                    "--slots", "2", "--prompt-len", "5", "--max-new", "3"])
    out = capsys.readouterr().out
    assert f"[{engine}]" in out and "9 tokens" in out
    if arch == "mamba2-1.3b":
        assert "chunk 1;" in out
