"""The port's softmax-attention baseline (``attn_mode="softmax"``) against
the JAX package, as a whole: the LM with RoPE, flash attention and KV-cache
decode, its loss and gradients, training, and wave generation.

Parameters are initialised by the JAX package and carried across with
``params_from_jax``; inputs are made with numpy from a seed.  Everything
runs in f32 on the CPU, where the port's flash kernels are their plain
torch versions.  Three configurations: ``smoke_config("phi3-mini-3.8b",
attn_mode="softmax")`` (global attention, MHA), the same with
``n_kv_heads=2`` (GQA), and an ``attn_local`` variant with ``window=8``
(sliding window, whose cache is a ring of ``min(window, cache_len)``
slots).

Bars: logits and f32 KV caches ``rtol=atol=1e-4`` (tests/
test_torch_model.py's); the trailing-window ring cache is bf16 by design,
so two f32 values that agree within 1e-6 can round to neighbouring bf16
values — its leaves are held to one bf16 spacing (``rtol=2**-7``) instead.
Loss ``rtol=1e-5``; gradients ``|port - JAX| <= 1e-4 * max|JAX| + 1e-6``
(tests/test_torch_flash.py explains the floor).  Greedy tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core import rope as jrope
from repro.core import softmax_attention as jsoft
from repro.data.synthetic import SyntheticLMIterator as JaxIterator
from repro.models import lm as jlm
from repro.models.factory import build as jax_build
from repro.serving import generate as jax_generate
from repro.train import optim as joptim
from repro.train.state import init_train_state as jax_init_train_state
from repro.train.state import make_train_step as jax_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.core import rope, softmax_attention as soft
from repro_torch.data.synthetic import SyntheticLMIterator
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import blocks, lm
from repro_torch.models.convert import params_from_jax, states_to_jax_layout
from repro_torch.models.factory import build
from repro_torch.models.param import map_specs
from repro_torch.serving.engine import StreamingEngine, generate
from repro_torch.train import optim as toptim
from repro_torch.train.loop import LoopConfig, run_train_loop
from repro_torch.train.state import init_train_state, make_train_step
from repro_torch.tree import tree_leaves, tree_map

ARCH = "phi3-mini-3.8b"
CONFIGS = {
    "global": dict(attn_mode="softmax"),
    "gqa": dict(attn_mode="softmax", n_kv_heads=2),
    "local": dict(attn_mode="softmax", pattern=("attn_local",), window=8),
}
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-4)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    kw = CONFIGS[request.param]
    jcfg = jax_smoke_config(ARCH, **kw)
    cfg = smoke_config(ARCH, **kw)
    japi = jax_build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return request.param, jcfg, japi, jparams, cfg, build(cfg), params


def _tokens(vocab, b, n, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(
        np.int32)


def _states_close(got_states, want_states, cfg):
    """Every leaf of the collected decode states, in the JAX layout."""
    got = jax.tree.leaves(states_to_jax_layout(cfg, got_states))
    want = jax.tree.leaves(want_states)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        b_dtype = np.asarray(b).dtype
        b = np.asarray(b, np.float32 if b_dtype.kind == "V"
                       or b_dtype.name == "bfloat16" else b_dtype)
        assert a.shape == b.shape
        tol = BF16_TOL if b_dtype.name == "bfloat16" else TOL
        np.testing.assert_allclose(a, b, **tol)


def _grad_close(got, want, rtol=1e-4, floor=1e-6):
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        err, bar = np.abs(a - b).max(), rtol * np.abs(b).max() + floor
        assert err <= bar, f"max |port - JAX| {err:.3e} > {bar:.3e}"


# ---------------------------------------------------------------------------
# Core: RoPE, dense attention, the KV cache
# ---------------------------------------------------------------------------


def test_rope_matches_jax():
    """Split-halves RoPE at shared and per-row positions, f32 and bf16."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    for pos in (np.arange(9)[None, :] + 5,
                rng.integers(0, 4000, (2, 9))):
        want = jrope.rope_for_positions(jnp.asarray(x), jnp.asarray(pos),
                                        500.0)
        got = rope.rope_for_positions(torch.from_numpy(x),
                                      torch.from_numpy(pos), 500.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = rope.rope_for_positions(torch.from_numpy(x).bfloat16(),
                                  torch.arange(9)[None, :])
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("kw", [
    dict(), dict(window=3), dict(causal=False), dict(q_offset=4),
    dict(lengths=[9, 5], q_lens=[5, 0]),
], ids=["causal", "window", "noncausal", "offset", "lengths"])
def test_multihead_attention_matches_jax(kw):
    """The dense masked attention (GQA 4:2) with the shared mask builder;
    a row with no live key reads 0."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 9, 2, 8)).astype(np.float32)
            for _ in range(2))
    jkw = {key: (jnp.asarray(val) if isinstance(val, list) else val)
           for key, val in kw.items()}
    tkw = {key: (torch.tensor(val) if isinstance(val, list) else val)
           for key, val in kw.items()}
    want = jsoft.multihead_attention(*map(jnp.asarray, (q, k, v)), **jkw)
    got = soft.multihead_attention(*map(torch.from_numpy, (q, k, v)), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [None, 3])
def test_kv_cache_decode_attention_matches_jax(window):
    """init_kv_cache, update_kv_cache (prefill then one token) and
    decode_attention, f32 and the default bf16 cache."""
    rng = np.random.default_rng(10)
    k, v = (rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
            for _ in range(2))
    q = rng.standard_normal((2, 1, 4, 8)).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        jc = jsoft.init_kv_cache(2, 10, 2, 8, dtype=getattr(jnp, dtype))
        tc = soft.init_kv_cache(2, 10, 2, 8, dtype=getattr(torch, dtype),
                                device="cpu")
        jc = jsoft.update_kv_cache(jc, jnp.asarray(k[:, :5]),
                                   jnp.asarray(v[:, :5]))
        tc = soft.update_kv_cache(tc, torch.from_numpy(k[:, :5]),
                                  torch.from_numpy(v[:, :5]))
        jc = jsoft.update_kv_cache(jc, jnp.asarray(k[:, 5:]),
                                   jnp.asarray(v[:, 5:]))
        before = tc["k"].clone()
        tc2 = soft.update_kv_cache(tc, torch.from_numpy(k[:, 5:]),
                                   torch.from_numpy(v[:, 5:]))
        assert torch.equal(tc["k"], before) and int(tc2["index"]) == 6
        want = jsoft.decode_attention(jnp.asarray(q), jc, window=window)
        got = soft.decode_attention(torch.from_numpy(q), tc2, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(tc2["k"].float().numpy(),
                                   np.asarray(jc["k"], np.float32), **TOL)


# ---------------------------------------------------------------------------
# Forward, caches, decode
# ---------------------------------------------------------------------------


def _oldest_first(states, n):
    """The port keeps a trailing-window ring as softmax_step reads it
    (position j in slot j mod capacity); the JAX package keeps it oldest
    first (ROADMAP queue C).  The port's rings after an N-token prefill,
    rotated oldest first."""
    out = []
    for st in states:
        c = st["k"].shape[1]
        if c < n:
            st = dict(st, k=st["k"].roll(-(n % c), 1),
                      v=st["v"].roll(-(n % c), 1))
        out.append(st)
    return out


@pytest.mark.parametrize("cache_len", [None, 20, 5],
                         ids=["cache_N", "cache_20", "ring_5"])
def test_logits_and_caches_match_jax(model, cache_len):
    """lm_apply(collect_state=True): logits, and the KV caches of every
    layer — full (cache_len >= N) or the trailing ring (cache_len < N),
    compared oldest first."""
    _, jcfg, _, jparams, cfg, _, params = model
    toks = _tokens(cfg.vocab, 2, 13)
    jlogits, jstates, _ = jlm.lm_apply(jcfg, jparams, jnp.asarray(toks),
                                       collect_state=True,
                                       cache_len=cache_len)
    logits, states = lm.lm_apply(cfg, params, torch.from_numpy(toks),
                                 collect_state=True, cache_len=cache_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    _states_close(_oldest_first(states, 13), jstates, cfg)


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_decode_steps_match_jax(model, ragged):
    """Prefill (ragged right-padded rows carry prompt_lens/prompt_pad),
    then three decode steps: logits and caches after each."""
    name, jcfg, _, jparams, cfg, _, params = model
    b, n, steps = 3, 7, 3
    toks = _tokens(cfg.vocab, b, n, seed=1)
    lens = np.asarray([7, 3, 1], np.int32) if ragged else None
    cache_len = n + steps
    jlogits, jstates, _ = jlm.lm_apply(
        jcfg, jparams, jnp.asarray(toks), collect_state=True,
        cache_len=cache_len, lengths=None if lens is None else
        jnp.asarray(lens))
    logits, states = lm.lm_apply(
        cfg, params, torch.from_numpy(toks), collect_state=True,
        cache_len=cache_len,
        lengths=None if lens is None else torch.from_numpy(lens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    nxt = _tokens(cfg.vocab, b, steps, seed=2)
    for t in range(steps):
        tok = nxt[:, t:t + 1]
        jl, jstates = jlm.lm_decode_step(jcfg, jparams, jnp.asarray(tok),
                                         jstates)
        tl, states = lm.lm_decode_step(cfg, params, torch.from_numpy(tok),
                                       states)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _states_close(states, jstates, cfg)
    if ragged:
        assert {"prompt_lens", "prompt_pad"} <= set(states[0])


def test_state_init_matches_jax(model):
    """lm_state_init: empty bf16 KV caches of cache_len slots (min(window,
    cache_len) for attn_local), the JAX package's layout."""
    _, jcfg, _, _, cfg, _, _ = model
    jstates = jlm.lm_state_init(jcfg, 2, 12)
    states = lm.lm_state_init(cfg, 2, 12, device="cpu")
    assert all(st["k"].dtype == torch.bfloat16 for st in states)
    _states_close(states, jstates, cfg)
    with pytest.raises(ValueError, match="cache_len"):
        lm.lm_state_init(cfg, 2, device="cpu")


def test_block_chunk_refuses_softmax(model):
    _, _, _, _, cfg, _, params = model
    sig = lm.layer_sigs(cfg)[0]
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="position-free carry"):
        blocks.block_chunk(params["layers"][0], x, None, sig, cfg)


# ---------------------------------------------------------------------------
# Loss, gradients, training
# ---------------------------------------------------------------------------


def test_loss_and_grads_match_jax(model):
    """lm_loss and every parameter gradient (autograd through FlashAttention
    and its analytic backward) against jax.grad of the JAX loss."""
    _, _, japi, jparams, cfg, api, params = model
    toks = _tokens(cfg.vocab, 2, 16, seed=3)
    ones = np.ones(toks.shape, np.float32)
    (jloss, _), jgrads = jax.value_and_grad(japi.loss, has_aux=True)(
        jparams, {"tokens": toks, "loss_mask": ones})
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = api.loss(params, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg, "cpu")
    assert len(grads) == len(tree_leaves(want)) > 10
    _grad_close([g.numpy() for g in grads],
                [w.numpy() for w in tree_leaves(want)])


def test_remat_block_recomputes_and_matches_none(monkeypatch):
    """remat='block' gives the loss and grads of remat='none' and runs every
    layer's flash forward twice (forward + recompute), 'none' once."""
    cfg = smoke_config(ARCH, **CONFIGS["gqa"])
    params = build(cfg).init(0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab, 2, 12, seed=4))
    real = ops.flash_attention
    calls = []

    def counting(*args, **kw):
        calls.append(kw.get("return_residuals", False))
        return real(*args, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    out = {}
    for remat in ("none", "block"):
        calls.clear()
        api = build(cfg.replace(remat=remat))
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = api.loss(params, {"tokens": toks})
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves),
                      list(calls))
    n = cfg.n_layers
    assert out["none"][2] == [True] * n
    assert out["block"][2] == [True] * (2 * n)
    assert torch.equal(out["none"][0], out["block"][0])
    for a, b in zip(out["none"][1], out["block"][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_train_steps_track_jax_loss_curve():
    """Eight AdamW steps from the same init on the same batches (GQA): the
    port's loss tracks JAX's within rtol 1e-5 at every step."""
    kw = CONFIGS["gqa"]
    jcfg, cfg = jax_smoke_config(ARCH, **kw), smoke_config(ARCH, **kw)
    steps, data = 8, dict(vocab=cfg.vocab, seq_len=32, batch=4, seed=0)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    jopt = joptim.make_optimizer("adamw", joptim.warmup_cosine(3e-3, 2, steps))
    jstate = jax_init_train_state(jparams, jopt)
    jstep = jax.jit(jax_make_train_step(jax_build(jcfg).loss, jopt))
    jit = JaxIterator(**data)
    want = []
    for i in range(steps):
        jstate, m = jstep(jstate, next(jit), jax.random.PRNGKey(i))
        want.append(float(m["loss"]))
    api = build(cfg)
    topt = toptim.make_optimizer("adamw", toptim.warmup_cosine(3e-3, 2, steps))
    state = init_train_state(
        params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu"), topt)
    result = run_train_loop(make_train_step(api.loss, topt), state,
                            SyntheticLMIterator(**data),
                            LoopConfig(total_steps=steps, log_every=1))
    got = [m["loss"] for _, m in result.history]
    assert len(got) == steps
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# Wave generation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_generate_greedy_matches_jax(model, ragged):
    """Greedy tokens identical to the JAX generate, plain and with ragged
    right-padded prompts (true positions in RoPE, the padded gap masked).
    The local config's ragged case keeps P <= window (its ring needs that);
    its plain case has P > window, a trailing-window ring, whose decode the
    JAX generate misreads (ROADMAP queue C): there the tokens equal greedy
    decoding through the JAX package's full forward."""
    name, jcfg, japi, jparams, cfg, api, params = model
    p = 6 if (ragged and name == "local") else 11
    prompts = _tokens(cfg.vocab, 3, p, seed=5)
    lens = np.asarray([p, 4, 1], np.int32) if ragged else None
    for i, ln in enumerate(lens if ragged else []):
        prompts[i, ln:] = 0
    if name == "local" and not ragged:
        # Causal: position t's logits read tokens <= t only, so one
        # fixed-shape forward a token serves (the tail is zeros).
        forward = jax.jit(lambda w, t: jlm.lm_apply(jcfg, w, t)[0])
        seq = np.zeros((3, p + 5), np.int32)
        seq[:, :p] = prompts
        want = []
        for t in range(6):
            nxt = np.asarray(forward(jparams, jnp.asarray(seq))
                             [:, p - 1 + t]).argmax(-1)
            want.append(nxt)
            if t < 5:
                seq[:, p + t] = nxt
        want = np.stack(want, axis=1)
    else:
        want, _ = jax_generate(japi, jparams, jnp.asarray(prompts), 6,
                               prompt_lengths=None if lens is None else
                               jnp.asarray(lens))
    got, states = generate(api, params, prompts, 6, prompt_lengths=lens)
    assert got.tolist() == np.asarray(want).tolist()
    assert int(states[0]["index"]) == p + 5


def test_ragged_generate_equals_solo_runs():
    """Each ragged row's tokens equal running that prompt alone."""
    cfg = smoke_config(ARCH, **CONFIGS["gqa"])
    api = build(cfg)
    params = api.init(0, device="cpu")
    lens = [9, 4, 1]
    prompts = _tokens(cfg.vocab, 3, 9, seed=6)
    got, _ = generate(api, params, prompts, 5, prompt_lengths=lens)
    for i, ln in enumerate(lens):
        solo, _ = generate(api, params, prompts[i:i + 1, :ln], 5)
        assert got[i].tolist() == solo[0].tolist()


def test_generate_refusals(model):
    name, _, _, _, cfg, api, params = model
    prompts = _tokens(cfg.vocab, 2, 10, seed=7)
    if name != "local":
        with pytest.raises(ValueError, match="non-wrapping"):
            generate(api, params, prompts, 4, cache_len=12)
    with pytest.raises(ValueError, match="non-wrapping"):
        generate(api, params, prompts, 4, cache_len=12,
                 prompt_lengths=[10, 3])
    if name == "local":
        # window 8 < P = 10: the ragged ring would need per-row indices.
        with pytest.raises(NotImplementedError, match="window"):
            generate(api, params, prompts, 4, prompt_lengths=[10, 3])
        # A wrapping ring is the local layer's design, not an error.
        toks, _ = generate(api, params, prompts, 4, cache_len=12)
        assert toks.shape == (2, 4)


def test_streaming_engine_rejects_kv_models(model):
    _, _, _, _, _, api, params = model
    with pytest.raises(ValueError, match="generate\\(\\) for KV-cache"):
        StreamingEngine(api, params)


def test_params_from_jax_copies_trees_without_a_query_leaf(model):
    """A softmax layer has no Aaren ``query`` leaf; params_from_jax copies
    the tree as it is, every element of it, into the shapes of the port's
    own specs."""
    _, _, _, jparams, cfg, api, params = model
    jmixers = [t["mixer"] for t in jparams.get("periods", ())
               + tuple(jparams.get("rest", ()))]
    assert jmixers and all("query" not in m for m in jmixers)
    for layer in params["layers"]:
        assert set(layer["mixer"]) == {"wq", "wk", "wv", "wo"}
    assert sum(t.numel() for t in tree_leaves(params)) == sum(
        x.size for x in jax.tree.leaves(jparams))
    assert tree_map(lambda t: tuple(t.shape), params) == map_specs(
        lambda s: tuple(s.shape), api.specs())


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------


def test_train_launcher_runs_softmax_on_cpu(capsys):
    train_cli.main(["--arch", ARCH, "--smoke", "--attn-mode", "softmax",
                    "--device", "cpu", "--steps", "3", "--batch", "2",
                    "--seq-len", "16"])
    out = capsys.readouterr().out
    assert "attn_mode=softmax pattern=('attn'," in out
    assert out.count(" loss=") == 3 and "done at step 3" in out


def test_serve_launcher_runs_softmax_wave_on_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--smoke", "--attn-mode", "softmax",
                    "--device", "cpu", "--engine", "wave", "--requests", "2",
                    "--prompt-len", "5", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "[wave]" in out and "6 tokens" in out and "decode state" in out
    with pytest.raises(ValueError, match="KV-cache"):
        serve_cli.main(["--arch", ARCH, "--smoke", "--attn-mode", "softmax",
                        "--device", "cpu", "--engine", "streaming"])
