"""The port's training path (``repro_torch``) against the JAX package.

Parameters are initialised by the JAX package and carried across with
``params_from_jax``; batches come from both packages' own
``SyntheticLMIterator`` (held equal below) or from numpy.  Everything runs
in f32 on the CPU, where the port's scan kernels are their plain torch
versions.  Bars: loss ``rtol=1e-5``; gradients and optimizer outputs
scaled by max |JAX| at 1e-4 (the JAX suite's gradient bar) unless a test
says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.data.synthetic import SyntheticLMIterator as JaxIterator
from repro.distributed import grad as jgrad
from repro.models.factory import build as jax_build
from repro.train import optim as joptim
from repro.train.state import init_train_state as jax_init_train_state
from repro.train.state import make_train_step as jax_make_train_step
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.synthetic import SyntheticLMIterator
from repro_torch.distributed import grad as tgrad
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import params_from_jax
from repro_torch.models.factory import build
from repro_torch.train import loop as loop_module
from repro_torch.train import optim as toptim
from repro_torch.train.loop import LoopConfig, run_train_loop
from repro_torch.train.state import init_train_state, make_train_step
from repro_torch.tree import tree_leaves

CONFIGS = {
    "phi3-smoke": lambda get, smoke: smoke("phi3-mini-3.8b"),
    "aaren-paper-cut": lambda get, smoke: get("aaren-paper", n_layers=2,
                                              d_model=128),
}


def _grad_close(got, want, rtol=1e-4):
    for a, b in zip(got, want):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, rtol=rtol,
                                   atol=rtol)


def _leaves(tree):
    return [t.detach().float().numpy() for t in tree_leaves(tree)]


def _sorted_leaves(tree):
    """Leaves with dict keys sorted: the order ``jax.tree.leaves`` uses."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [np.asarray(x.detach().float() if torch.is_tensor(x) else x,
                       np.float32) for x in tree_leaves(tree)]


def _torch_tree(np_tree):
    """Copies: the port's optimizer and clipping write in place."""
    return jax.tree.map(lambda a: torch.from_numpy(a.copy()), np_tree)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    make = CONFIGS[request.param]
    jcfg = make(jax_get_config, jax_smoke_config)
    cfg = make(get_config, smoke_config)
    japi = jax_build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    jgrad_fn = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))
    return jcfg, jparams, cfg, build(cfg), jgrad_fn


def _port_params(jparams, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _batch(vocab, b=2, n=16, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (b, n)).astype(np.int32)}
    if mask:
        batch["loss_mask"] = (rng.random((b, n)) < 0.6).astype(np.float32)
    return batch


def _with_ones_mask(batch):
    """JAX's lm_loss reads a missing mask as ones: passing the ones keeps
    one jit of its loss for both cases."""
    ones = np.ones(batch["tokens"].shape, np.float32)
    return {"loss_mask": ones, **batch}


def _port_loss_and_grads(api, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = api.loss(params, tb)
    return loss.detach(), metrics, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("mask", [False, True], ids=["no_mask", "loss_mask"])
def test_loss_and_grads_match_jax(model, mask):
    """lm_loss and every parameter gradient, from the same JAX init."""
    jcfg, jparams, cfg, api, jgrad_fn = model
    batch = _batch(cfg.vocab, mask=mask, seed=int(mask))
    (jloss, jmetrics), jgrads = jgrad_fn(jparams, _with_ones_mask(batch))
    params = _port_params(jparams, cfg)
    loss, metrics, grads = _port_loss_and_grads(api, params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg, "cpu")
    assert len(grads) == len(tree_leaves(want)) > 10
    _grad_close([g.numpy() for g in grads], _leaves(want))


def test_remat_block_recomputes_and_matches_none(model, monkeypatch):
    """remat='block' gives the loss and grads of remat='none', and runs
    every layer's scan twice (forward + recompute), 'none' once."""
    jcfg, jparams, cfg, _, _ = model
    batch = _batch(cfg.vocab, seed=2)
    real = ops.aaren_scan
    calls = []

    def counting(*args, **kw):
        calls.append(kw.get("return_residuals", False))
        return real(*args, **kw)

    monkeypatch.setattr(ops, "aaren_scan", counting)
    out = {}
    for remat in ("none", "block"):
        calls.clear()
        api = build(cfg.replace(remat=remat))
        loss, _, grads = _port_loss_and_grads(
            api, _port_params(jparams, cfg), batch)
        out[remat] = (loss, grads, list(calls))
    n = cfg.n_layers
    assert out["none"][2] == [True] * n
    assert out["block"][2] == [True] * (2 * n)
    assert torch.equal(out["none"][0], out["block"][0])
    for a, b in zip(out["none"][1], out["block"][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_lm_loss_refuses_later_slices(model):
    """VLM prefix embeddings raise (item 10); packed batches train Aaren
    (tests/test_torch_packing.py) but raise on softmax layers (item A7b)."""
    _, jparams, cfg, api, _ = model
    params = _port_params(jparams, cfg)
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="item 10"):
        api.loss(params, {"tokens": tokens, "prefix_embeds": tokens})
    soft = build(cfg.replace(attn_mode="softmax"))
    soft_params = soft.init(0, device="cpu")
    for key in ("segment_ids", "positions"):
        with pytest.raises(NotImplementedError, match="A7b"):
            soft.loss(soft_params, {"tokens": tokens, key: tokens + 1})


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 3), "b": (5,), "c": {"d": (2, 3, 4), "e": (3, 1)}}

    def draw(shape):
        return rng.standard_normal(shape).astype(np.float32)

    return jax.tree.map(draw, shapes, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("name", ["adamw", "adamw_bf16", "adafactor"])
def test_optimizer_updates_match_jax(name):
    """Two updates from identical numpy params and grads: new params and
    optimizer state equal JAX's."""
    params_np = _opt_tree(0)
    grads_np = [_opt_tree(1), _opt_tree(2)]
    sched = (3e-2, 1, 10)
    jopt = joptim.make_optimizer(name, joptim.warmup_cosine(*sched))
    topt = toptim.make_optimizer(name, toptim.warmup_cosine(*sched))
    jp = jax.tree.map(jnp.asarray, params_np)
    js = jopt.init(jp)
    tp = _torch_tree(params_np)
    ts = topt.init(tp)
    for step, g in enumerate(grads_np):
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, step + 1)
        tp, ts = topt.update(_torch_tree(g), ts, tp, step + 1)
    for a, b in zip(_sorted_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    want_state = [np.asarray(x, np.float32) for x in jax.tree.leaves(js)]
    got_state = _sorted_leaves(ts)
    assert len(got_state) == len(want_state)
    for a, b in zip(got_state, want_state):
        assert a.shape == b.shape
        # bf16 moments: one bf16 rounding of values that agree in f32.
        tol = 2 ** -8 if name == "adamw_bf16" else 1e-5
        np.testing.assert_allclose(a, b, rtol=tol, atol=1e-7)
    if name == "adamw_bf16":
        assert all(t.dtype == torch.bfloat16 for t in tree_leaves(ts))


def test_warmup_cosine_matches_jax():
    jsched = joptim.warmup_cosine(3e-4, 5, 20)
    tsched = toptim.warmup_cosine(3e-4, 5, 20)
    for step in range(26):
        np.testing.assert_allclose(tsched(step), float(jsched(step)),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "keeps"])
def test_clip_by_global_norm_matches_jax(max_norm):
    g_np = _opt_tree(4)
    jg, jnorm = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g_np),
                                           max_norm)
    tg, tnorm = toptim.clip_by_global_norm(_torch_tree(g_np), max_norm)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    for a, b in zip(_leaves(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Microbatching and compression
# ---------------------------------------------------------------------------


def test_microbatch_grads_match_full_batch_and_jax():
    """k = 2 strided microbatches == k = 1 (the port) == JAX's k = 2."""
    jcfg = jax_smoke_config("phi3-mini-3.8b", n_layers=2)
    cfg = smoke_config("phi3-mini-3.8b", n_layers=2)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(1))
    api = build(cfg)
    batch = _batch(cfg.vocab, b=4, seed=5)
    params = _port_params(jparams, cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    g1, l1, _ = tgrad.microbatch_grads(api.loss, params, tb, 1)
    g2, l2, m2 = tgrad.microbatch_grads(api.loss, params, tb, 2)
    jg2, jl2, jm2 = jax.jit(lambda p, b: jgrad.microbatch_grads(
        jax_build(jcfg).loss, p, b, 2))(jparams, batch)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    np.testing.assert_allclose(float(l2), float(jl2), rtol=1e-5)
    np.testing.assert_allclose(float(m2["ce"]), float(jm2["ce"]), rtol=1e-5)
    _grad_close(_leaves(g2), _leaves(g1))
    want = params_from_jax(jax.tree.map(np.asarray, jg2), cfg, "cpu")
    _grad_close(_leaves(g2), _leaves(want))


def test_bf16_compression_matches_jax():
    g_np = _opt_tree(6)
    want = jgrad.compress_gradients(jax.tree.map(jnp.asarray, g_np), "bf16")
    got = tgrad.compress_gradients(_torch_tree(g_np), "bf16")
    for a, b in zip(_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    none = tgrad.compress_gradients(g_np, "none")
    assert none is g_np
    with pytest.raises(ValueError, match="unknown"):
        tgrad.compress_gradients(g_np, "fp4")


def test_int8_compression_is_unbiased():
    """Stochastic rounding: each element dequantizes to one of its two
    neighbouring int8 levels, and the mean over many draws is g (within
    five standard errors of the per-draw error, <= scale / 2)."""
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(64)
                         .astype(np.float32) * 0.1)
    scale = float(g.abs().max()) / 127
    gen = torch.Generator().manual_seed(0)
    n = 4000
    draws = torch.stack([tgrad.compress_gradients({"g": g}, "int8", gen)["g"]
                         for _ in range(n)])
    assert torch.all((draws - g).abs() <= scale * (1 + 1e-5))
    assert (draws != draws[0]).any(dim=0).float().mean() > 0.9
    bound = 5 * (scale / 2) / np.sqrt(n)
    np.testing.assert_allclose(draws.mean(0).numpy(), g.numpy(), atol=bound,
                               rtol=0)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def _same_batches(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_synthetic_iterator_equals_jax():
    """Batch for batch, host slices, and state/restore."""
    kw = dict(vocab=100, seq_len=24, batch=4, seed=3)
    port, ref = SyntheticLMIterator(**kw), JaxIterator(**kw)
    for _ in range(3):
        _same_batches(next(port), next(ref))
    halves = [SyntheticLMIterator(**kw, host_id=h, num_hosts=2)
              for h in range(2)]
    for h in halves:
        h.restore(port.state())
    whole = next(ref)
    parts = [next(h) for h in halves]
    _same_batches({k: np.concatenate([p[k] for p in parts]) for k in whole},
                  whole)
    resumed = SyntheticLMIterator(**kw)
    resumed.restore(ref.state())
    _same_batches(next(resumed), next(ref))


# ---------------------------------------------------------------------------
# Train step, loop and launcher
# ---------------------------------------------------------------------------


def test_twenty_steps_track_jax_loss_curve():
    """20 train steps from the same init on the same batches: the port's
    loss tracks JAX's step by step within rtol 1e-5, the suite's loss bar.
    The two differ by f32 rounding only (JAX differentiates its jnp scan,
    the port runs the analytic backward), which Adam's m/sqrt(v) feeds back
    into the parameters every step; over these 20 steps the largest
    difference is 2.2e-7 relative."""
    jcfg = jax_smoke_config("phi3-mini-3.8b")
    cfg = smoke_config("phi3-mini-3.8b")
    steps, kw = 20, dict(vocab=cfg.vocab, seq_len=32, batch=4, seed=0)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))

    jopt = joptim.make_optimizer("adamw", joptim.warmup_cosine(3e-3, 2, steps))
    jstate = jax_init_train_state(jparams, jopt)
    jstep = jax.jit(jax_make_train_step(jax_build(jcfg).loss, jopt))
    jit = JaxIterator(**kw)
    want = []
    for i in range(steps):
        jstate, m = jstep(jstate, next(jit), jax.random.PRNGKey(i))
        want.append(float(m["loss"]))

    api = build(cfg)
    topt = toptim.make_optimizer("adamw", toptim.warmup_cosine(3e-3, 2, steps))
    state = init_train_state(_port_params(jparams, cfg), topt)
    result = run_train_loop(make_train_step(api.loss, topt), state,
                            SyntheticLMIterator(**kw),
                            LoopConfig(total_steps=steps, log_every=1))
    got = [m["loss"] for _, m in result.history]
    assert result.state.step == steps and len(got) == steps
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.mean(got[-5:]) < np.mean(got[:5])


def test_train_step_microbatches_and_compression_run():
    cfg = smoke_config("phi3-mini-3.8b", n_layers=1)
    api = build(cfg)
    opt = toptim.make_optimizer("adamw", toptim.warmup_cosine(1e-3, 1, 4))
    state = init_train_state(api.init(0, device="cpu"), opt)
    data = SyntheticLMIterator(vocab=cfg.vocab, seq_len=8, batch=4)
    for mode in ("none", "bf16", "int8"):
        step = make_train_step(api.loss, opt, n_microbatches=2,
                               grad_compression=mode)
        state, metrics = step(state, next(data), torch.Generator())
        assert set(metrics) >= {"loss", "ce", "grad_norm"}
        assert all(torch.isfinite(v) for v in metrics.values())
    assert state.step == 3


class _Clock:
    """A stand-in for the ``time`` module whose clock the test advances."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def test_loop_detects_a_straggler(monkeypatch):
    """The EWMA straggler detector flags an injected slow step (50 ms
    against 10 ± 0.2 ms), and nothing before its warm-up ends."""
    clock = _Clock()
    monkeypatch.setattr(loop_module, "time", clock)
    cfg = smoke_config("phi3-mini-3.8b", n_layers=1)
    params = build(cfg).init(0, device="cpu")
    slow = {5, 14}   # step 5 is inside the warm-up and must not flag

    def fake_step(state, batch, gen):
        jitter = 0.0002 * (-1) ** state.step
        clock.now += 0.05 if state.step in slow else 0.01 + jitter
        return state._replace(step=state.step + 1), {"loss": torch.zeros(())}

    state = init_train_state(params, toptim.make_optimizer(
        "adamw", toptim.warmup_cosine(1e-3, 1, 4)))
    res = run_train_loop(fake_step, state, iter(lambda: {}, None),
                         LoopConfig(total_steps=16, log_every=5,
                                    straggler_warmup=10))
    assert [s for s, _, _ in res.stragglers] == [14]
    assert [s for s, _ in res.history] == [0, 5, 10, 15]


@pytest.mark.parametrize("knob", [
    dict(ckpt_dir="x"), dict(events="x"), dict(metrics_out="x"),
    dict(guard=True), dict(pack_sequences=True), dict(context_parallel=2),
    dict(model_parallel=2), dict(fsdp=2)], ids=lambda k: next(iter(k)))
def test_loop_refuses_knobs_of_later_slices(knob):
    """Knobs of later slices raise naming their item; ``pack_sequences``
    is ported and refuses only a batch without ``segment_ids``."""
    cfg = smoke_config("phi3-mini-3.8b", n_layers=1)
    opt = toptim.make_optimizer("adamw", toptim.warmup_cosine(1e-3, 1, 4))
    state = init_train_state(build(cfg).init(0, device="cpu"), opt)
    exc, match = ((ValueError, "segment_ids") if "pack_sequences" in knob
                  else (NotImplementedError, "item"))
    with pytest.raises(exc, match=match):
        run_train_loop(None, state, iter([{"tokens": np.zeros((1, 4))}]),
                       LoopConfig(total_steps=1, **knob))
    with pytest.raises(NotImplementedError, match="item 8"):
        make_train_step(None, opt, guard=object())


def test_train_launcher_runs_on_cpu(capsys):
    train_cli.main(["--arch", "phi3-mini-3.8b", "--smoke", "--device", "cpu",
                    "--steps", "3", "--batch", "2", "--seq-len", "16"])
    out = capsys.readouterr().out
    assert "arch=phi3-mini-3.8b-smoke attn_mode=aaren" in out
    assert out.count(" loss=") == 3 and "done at step 3" in out


@pytest.mark.parametrize("argv, match", [
    ([], "no CUDA device"),
    (["--attn-mode", "softmax"], "no CUDA device"),
    (["--ckpt-dir", "ckpt"], "item 8"),
    (["--context-parallel", "2"], "item 11"),
], ids=["no_card", "softmax", "ckpt", "context_parallel"])
def test_train_launcher_refuses(argv, match, monkeypatch):
    """Without --device cpu the launcher needs a card, in either attention
    mode; flags of later slices raise with their ROADMAP item."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, NotImplementedError), match=match):
        train_cli.main(["--arch", "phi3-mini-3.8b", "--smoke", "--steps",
                        "1", *argv])
