"""The port's hybrid family (``recurrentgemma-9b``: RG-LRU layers beside
Aaren or sliding-window softmax layers) against the JAX package.

The recurrentgemma smoke model (4 layers: rglru, rglru, attention, rglru;
d_model 128, 4 x 32 heads, MQA, window 8, ``rnn_width`` 128) in both modes,
from JAX's initial parameters carried across as numpy, on inputs made with
numpy from a seed.  f32 on the CPU: logits and carries within
``rtol=atol=1e-4``; the loss within ``rtol=1e-5`` and every gradient
within 1e-4 of its leaf's max; greedy tokens equal token for token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.models.factory import build as jax_build
from repro.serving import StreamingEngine as JaxStreamingEngine
from repro.serving.engine import generate as jax_generate
from repro_torch.configs import smoke_config
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax, states_to_jax_layout
from repro_torch.models.factory import build
from repro_torch.serving import PrefixCache
from repro_torch.serving.engine import StreamingEngine, generate
from repro_torch.tree import tree_leaves

ARCH = "recurrentgemma-9b"
TOL = dict(rtol=1e-4, atol=1e-4)


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.fixture(scope="module", params=["aaren", "softmax"])
def model(request):
    """Both packages' models and, in one JAX compile a mode, JAX's forward
    of 2 x 12 tokens with every layer's state, its loss and the loss's
    gradients."""
    jcfg = jax_smoke_config(ARCH, attn_mode=request.param)
    japi = jax_build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    api = build(smoke_config(ARCH, attn_mode=request.param))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), api.cfg,
                             "cpu")
    toks = _tokens(api.cfg.vocab, (2, 12), seed=2)

    def forward_and_grads(p, t):
        logits, states, _ = jlm.lm_apply(jcfg, p, t, collect_state=True)
        (loss, _), grads = jax.value_and_grad(japi.loss, has_aux=True)(
            p, {"tokens": t, "loss_mask": jnp.ones(t.shape, jnp.float32)})
        return logits, states, loss, grads

    jlogits, jstates, jloss, jgrads = jax.jit(forward_and_grads)(
        jparams, jnp.asarray(toks))
    grads = params_from_jax(jax.tree.map(np.asarray, jgrads), api.cfg, "cpu")
    ref = {"tokens": toks, "logits": np.asarray(jlogits), "states": jstates,
           "loss": float(jloss),
           "grads": [g.numpy().astype(np.float32) for g in tree_leaves(grads)]}
    return japi, jparams, api, params, ref


def test_loss_and_grads_match_jax(model):
    """The loss and every parameter gradient, under ``remat="none"`` and
    ``"block"`` (RG-LRU's backward is autograd through the chunked scan)."""
    _, jparams, api, _, ref = model
    for remat in ("none", "block"):
        params = params_from_jax(jax.tree.map(np.asarray, jparams), api.cfg,
                                 "cpu")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = build(api.cfg.replace(remat=remat)).loss(
            params, {"tokens": torch.as_tensor(ref["tokens"])})
        grads = torch.autograd.grad(loss, leaves)
        np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
        assert len(grads) == len(ref["grads"]) > 30
        for a, b in zip(grads, ref["grads"]):
            scale = max(np.abs(b).max(), 1e-6)
            np.testing.assert_allclose(a.numpy() / scale, b / scale,
                                       rtol=1e-4, atol=1e-4)


def test_lm_apply_logits_and_carries(model):
    """Logits and every layer's decode state (RG-LRU ``h`` and conv tail,
    the Aaren carry, or the window's KV ring, compared oldest first: the
    port keeps position j in slot j mod 8, the JAX package the last 8
    oldest first) after 12 tokens."""
    _, _, api, params, ref = model
    logits, states = lm.lm_apply(api.cfg, params,
                                 torch.as_tensor(ref["tokens"]),
                                 collect_state=True)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **TOL)
    assert [type(st).__name__ for st in states].count("dict") == (
        4 if api.cfg.attn_mode == "softmax" else 3)
    states = [dict(st, k=st["k"].roll(-4, 1), v=st["v"].roll(-4, 1))
              if "k" in st else st for st in states]
    got = jax.tree.leaves(states_to_jax_layout(api.cfg, states))
    want = jax.tree.leaves(ref["states"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_prefill_then_decode_matches_jax_full_forward(model):
    """Prefill P tokens, then decode to position 11: each decode's logits
    equal JAX's full forward there — for P = 1 and 2 (RG-LRU conv tails
    shorter than d_conv - 1, zero-padded in the port; the JAX package's
    own decode differs there by ~1, ROADMAP queue C) and P = 10 (past the
    window of 8: the softmax layer keeps the trailing window as a bf16
    ring, so its logits are held to a bf16 spacing of their max)."""
    _, _, api, params, ref = model
    jfull = ref["logits"]
    t = torch.as_tensor(ref["tokens"])
    for p_len in (1, 2, 10):
        bf16_ring = api.cfg.attn_mode == "softmax" and p_len > 8
        tol = (dict(rtol=0, atol=2 ** -7 * np.abs(jfull).max())
               if bf16_ring else TOL)
        logits, states = lm.lm_apply(api.cfg, params, t[:, :p_len],
                                     collect_state=True, cache_len=12)
        np.testing.assert_allclose(logits[:, -1].numpy(),
                                   jfull[:, p_len - 1], **TOL)
        for pos in range(p_len, 12):
            logits, states = lm.lm_decode_step(api.cfg, params,
                                               t[:, pos:pos + 1], states)
            np.testing.assert_allclose(logits[:, 0].numpy(), jfull[:, pos],
                                       **tol)


PROMPT_LENS = [3, 5, 1, 4]
MAX_NEW = [4, 3, 5, 2]


def _serve(engine, prompts, max_new):
    rids = [engine.submit(p, m) for p, m in zip(prompts, max_new)]
    out = engine.run()
    return [list(map(int, out[r])) for r in rids]


def test_greedy_tokens_match_jax(model):
    """Aaren mode: the streaming engine at its default chunk (1, as JAX's),
    2 slots refilled mid-flight.  Softmax mode: ``generate`` of 6 + 6
    tokens, the window's KV ring of 8 wrapping in decode.  Token for token
    against the JAX package's."""
    japi, jparams, api, params, _ = model
    if api.cfg.attn_mode == "aaren":
        prompts = [_tokens(api.cfg.vocab, n, seed=10 + i)
                   for i, n in enumerate(PROMPT_LENS)]
        eng = StreamingEngine(api, params, n_slots=2)
        assert eng.chunk == 1
        got = _serve(eng, prompts, MAX_NEW)
        want = _serve(JaxStreamingEngine(japi, jparams, n_slots=2), prompts,
                      MAX_NEW)
        assert [len(g) for g in got] == MAX_NEW
    else:
        prompts = _tokens(api.cfg.vocab, (2, 6), seed=3)
        got, _ = generate(api, params, prompts, 6)
        want, _ = jax_generate(japi, jparams, jnp.asarray(prompts), 6)
        got, want = got.tolist(), np.asarray(want).tolist()
    assert got == want


def test_refusals_match_jax(model):
    """What the JAX package refuses for an RG-LRU model, with its
    messages: a streaming chunk > 1, packed batches, ragged prefill, and a
    multi-token chunk through an RG-LRU carry."""
    _, _, api, params, _ = model
    cfg = api.cfg
    toks = torch.as_tensor(_tokens(cfg.vocab, (2, 6)))
    if cfg.attn_mode == "aaren":
        with pytest.raises(ValueError, match="all-aaren"):
            StreamingEngine(api, params, chunk=4)
        with pytest.raises(ValueError, match="chunk == 1"):
            lm.lm_prefill_chunk(cfg, params, toks,
                                lm.lm_state_init(cfg, 2, device="cpu"))
    else:
        with pytest.raises(ValueError, match="KV-cache models"):
            StreamingEngine(api, params, chunk=1)
    with pytest.raises(ValueError, match="no packed-segment"):
        api.loss(params, {"tokens": toks,
                          "segment_ids": torch.ones_like(toks)})
    with pytest.raises(ValueError, match="ragged-length"):
        generate(api, params, toks.numpy(), 2, prompt_lengths=[6, 3])


def test_prefix_cache_hit_drain_and_snapshot_are_bit_equal(tmp_path):
    """A bf16-compute hybrid (RG-LRU conv tails in bf16, widened exactly to
    f32 on the host): a prefix-cache hit, an export + inject into a second
    engine and a snapshot restore (in memory and through ``save``/``load``)
    each give tokens bit-equal to the cold run."""
    api = build(smoke_config(ARCH, compute_dtype="bfloat16"))
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
    conv = [e.carry[0]["conv"] for e in cache._entries.values()][0]
    assert conv.dtype == np.float32 and conv.shape == (1, 3, api.cfg.d_rnn)

    def run_until(eng, ticks):
        rids = [eng.submit(p, m) for p, m in zip(prompts, max_new)]
        for _ in range(ticks):
            eng.step()
        return rids

    src = StreamingEngine(api, params, n_slots=2)
    rids = run_until(src, 5)
    dst = StreamingEngine(api, params, n_slots=2)
    for desc in src.export_requests():
        dst.inject_request(desc)
    out = dst.run()
    assert [list(map(int, out[r])) for r in rids] == cold

    src = StreamingEngine(api, params, n_slots=2)
    rids = run_until(src, 7)
    snap = src.snapshot()
    src.save(str(tmp_path), 0)
    for restore in ("snapshot", "load"):
        eng = StreamingEngine(api, params, n_slots=2)
        if restore == "snapshot":
            eng.restore(snap)
        else:
            eng.load(str(tmp_path))
        assert eng.states[0]["conv"].dtype == torch.bfloat16
        out = eng.run()
        assert [list(map(int, out[r])) for r in rids] == cold


@pytest.mark.parametrize("kind,value,item", [
    ("family", "ssm", "A10b"), ("family", "moe", "A10c"),
    ("family", "audio", "A10d"), ("family", "vlm", "A10d"),
    ("mlp", "moe", "A10c"), ("mlp", "none", "A10b")])
def test_unported_families_and_mlps_name_their_item(kind, value, item):
    """The audio and VLM families still raise, naming A10d; the families
    and MLPs that A10b and A10c brought build, and a forward through the
    hybrid's layers with them is finite."""
    cfg = smoke_config(ARCH)
    cfg = (cfg.replace(family=value) if kind == "family" else
           cfg.replace(mlp_pattern=(value,) * len(cfg.pattern),
                       n_experts=4, n_experts_per_tok=2, moe_d_ff=64))
    if item == "A10d":
        with pytest.raises(NotImplementedError, match=item):
            build(cfg).init(0, device="cpu")
        return
    api = build(cfg)
    params = api.init(0, device="cpu")
    if value == "none":
        assert all("mlp" not in layer for layer in params["layers"])
    if kind == "mlp" and value == "moe":
        assert params["layers"][0]["mlp"]["wi_gate"].shape == (4, 128, 64)
    logits = api.forward(params, {"tokens": torch.as_tensor(
        _tokens(cfg.vocab, (2, 6)))})
    assert logits.shape == (2, 6, cfg.vocab)
    assert torch.isfinite(logits).all()
