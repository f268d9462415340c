"""The port's SSM and MoE families (``mamba2-1.3b``, ``qwen3-moe-30b-a3b``,
``dbrx-132b``) against the JAX package, at their smoke widths.

mamba2 (3 SSD layers with no MLP; d_model 128, 4 heads x 64, state 16) in
its one mode; qwen3-moe (RMSNorm) and dbrx (LayerNorm) (3 layers of
attention and a routed MLP: 4 experts top-2 of width 64) in Aaren and
softmax mode; from JAX's initial parameters carried across as numpy, on
inputs made with numpy from a seed.  f32 on the CPU: logits, carries and
decode logits within ``rtol=atol=1e-5``; the loss (with the MoE auxiliary
loss) and its metrics within ``rtol=1e-5``; every gradient within 1e-4 of
its leaf's max; greedy tokens equal token for token.
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
from repro_torch.serving.engine import StreamingEngine, generate
from repro_torch.tree import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-5)
# With capacity_factor = E / k no token can be dropped: sequence and
# decode route the same way only then.
NO_DROP = 2.0
CASES = [("mamba2-1.3b", "aaren"), ("qwen3-moe-30b-a3b", "aaren"),
         ("qwen3-moe-30b-a3b", "softmax"), ("dbrx-132b", "aaren"),
         ("dbrx-132b", "softmax")]
METRICS = ("loss", "ce", "load_balance_loss", "dropped_frac")


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _packed(vocab):
    """Two rows of two documents each and a padding tail: tokens,
    segment ids and within-document positions."""
    toks = _tokens(vocab, (2, 12), seed=5)
    seg = np.array([[1] * 5 + [2] * 5 + [0] * 2,
                    [1] * 8 + [2] * 4], np.int32)
    pos = np.array([list(range(5)) * 2 + [0, 0],
                    list(range(8)) + list(range(4))], np.int32)
    return {"tokens": toks, "segment_ids": seg, "positions": pos}


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-{m}" for a, m in CASES])
def model(request):
    """Both packages' models and, in one JAX compile, JAX's forward of
    2 x 12 tokens with every layer's state, its loss, metrics and
    gradients, the forward with no token dropped, and (MoE) the packed
    loss and metrics."""
    arch, mode = request.param
    jcfg = jax_smoke_config(arch, attn_mode=mode)
    japi = jax_build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    api = build(smoke_config(arch, attn_mode=mode))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), api.cfg,
                             "cpu")
    toks = _tokens(api.cfg.vocab, (2, 12), seed=2)
    roomy = jcfg.replace(capacity_factor=NO_DROP)
    packed = _packed(api.cfg.vocab) if jcfg.family == "moe" else None

    def forward_and_grads(p, t):
        logits, states, _ = jlm.lm_apply(jcfg, p, t, collect_state=True)
        (_, metrics), grads = jax.value_and_grad(japi.loss, has_aux=True)(
            p, {"tokens": t})
        full, _, _ = jlm.lm_apply(roomy, p, t)
        pm = (jlm.lm_loss(jcfg, p, jax.tree.map(jnp.asarray, packed))[1]
              if packed else None)
        return logits, states, metrics, grads, full, pm

    jlogits, jstates, jm, jgrads, jfull, jpm = jax.jit(forward_and_grads)(
        jparams, jnp.asarray(toks))
    grads = params_from_jax(jax.tree.map(np.asarray, jgrads), api.cfg, "cpu")
    ref = {"tokens": toks, "logits": np.asarray(jlogits), "states": jstates,
           "metrics": {k: float(v) for k, v in jm.items()},
           "grads": [g.numpy() for g in tree_leaves(grads)],
           "full_no_drop": np.asarray(jfull), "packed": packed,
           "packed_metrics": (None if jpm is None else
                              {k: float(v) for k, v in jpm.items()})}
    return japi, jparams, api, params, ref


def test_loss_metrics_and_grads_match_jax(model):
    """``ce + 0.01 · load_balance_loss``, its metrics and every parameter
    gradient (the router's through the gates and ``router_mean``), under
    ``remat="none"`` and ``"block"``; the MoE configs drop tokens here."""
    _, jparams, api, _, ref = model
    assert set(ref["metrics"]) == set(METRICS)
    if api.cfg.family == "moe":
        assert ref["metrics"]["dropped_frac"] > 0
        assert ref["metrics"]["loss"] != ref["metrics"]["ce"]
    for remat in ("none", "block"):
        params = params_from_jax(jax.tree.map(np.asarray, jparams), api.cfg,
                                 "cpu")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = build(api.cfg.replace(remat=remat)).loss(
            params, {"tokens": torch.as_tensor(ref["tokens"])})
        grads = torch.autograd.grad(loss, leaves)
        assert set(metrics) == set(METRICS)
        for k in METRICS:
            np.testing.assert_allclose(metrics[k].item(), ref["metrics"][k],
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(loss.item(), ref["metrics"]["loss"],
                                   rtol=1e-5)
        assert len(grads) == len(ref["grads"]) > 20
        for a, b in zip(grads, ref["grads"]):
            scale = max(np.abs(b).max(), 1e-6)
            np.testing.assert_allclose(a.numpy() / scale, b / scale,
                                       rtol=1e-4, atol=1e-4)


def test_lm_apply_logits_aux_and_carries(model):
    """Logits, the auxiliary metrics as ``lm_apply`` returns them (their
    mean over every layer) and every layer's decode state after 12 tokens
    (SSD ``s`` and conv tail, or the Aaren carry; a softmax KV cache is
    compared in tests/test_torch_softmax.py)."""
    _, _, api, params, ref = model
    logits, states, aux = lm.lm_apply(api.cfg, params,
                                      torch.as_tensor(ref["tokens"]),
                                      collect_state=True, return_aux=True)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **TOL)
    for k in ("load_balance_loss", "dropped_frac"):
        np.testing.assert_allclose(float(aux[k]), ref["metrics"][k],
                                   rtol=1e-5, atol=1e-7)
    if api.cfg.attn_mode == "softmax":
        return
    got = jax.tree.leaves(states_to_jax_layout(api.cfg, states))
    want = jax.tree.leaves(ref["states"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_prefill_then_decode_matches_jax_full_forward(model):
    """Prefill P tokens, then decode to position 11: each decode's logits
    equal JAX's full forward there, with ``capacity_factor`` raised so no
    token is dropped (capacity is per row and per call, so a one-token
    decode and a 12-token forward drop different tokens when it binds).
    P = 1 and 2 leave SSD conv tails shorter than ``d_conv - 1``, which the
    port zero-pads (the JAX package's own decode misses there; ROADMAP
    queue C)."""
    _, _, api, params, ref = model
    cfg = api.cfg.replace(capacity_factor=NO_DROP)
    jfull = ref["full_no_drop"]
    t = torch.as_tensor(ref["tokens"])
    for p_len in (1, 2, 10):
        logits, states = lm.lm_apply(cfg, params, t[:, :p_len],
                                     collect_state=True, cache_len=12)
        np.testing.assert_allclose(logits[:, -1].numpy(),
                                   jfull[:, p_len - 1], **TOL)
        for pos in range(p_len, 12):
            logits, states = lm.lm_decode_step(cfg, params,
                                               t[:, pos:pos + 1], states)
            np.testing.assert_allclose(logits[:, 0].numpy(), jfull[:, pos],
                                       **TOL)


PROMPT_LENS = [3, 5, 1, 4]
MAX_NEW = [4, 3, 5, 2]


def _serve(engine, prompts, max_new):
    rids = [engine.submit(p, m) for p, m in zip(prompts, max_new)]
    out = engine.run()
    return [list(map(int, out[r])) for r in rids]


def test_greedy_tokens_match_jax(model):
    """The streaming engine at its default chunk (1 for mamba2, 16 for an
    Aaren MoE model, as JAX's), 2 slots refilled mid-flight, in the modes
    that stream; ``generate`` of 6 + 6 tokens in every mode.  Token for
    token against the JAX package's."""
    japi, jparams, api, params, _ = model
    if api.cfg.attn_mode == "aaren":
        prompts = [_tokens(api.cfg.vocab, n, seed=10 + i)
                   for i, n in enumerate(PROMPT_LENS)]
        eng = StreamingEngine(api, params, n_slots=2)
        assert eng.chunk == (1 if api.cfg.family == "ssm" else 16)
        got = _serve(eng, prompts, MAX_NEW)
        want = _serve(JaxStreamingEngine(japi, jparams, n_slots=2), prompts,
                      MAX_NEW)
        assert [len(g) for g in got] == MAX_NEW
        assert got == want
    prompts = _tokens(api.cfg.vocab, (2, 6), seed=3)
    got, _ = generate(api, params, prompts, 6)
    want, _ = jax_generate(japi, jparams, jnp.asarray(prompts), 6)
    assert got.tolist() == np.asarray(want).tolist()


def test_packed_loss_matches_jax_or_is_refused(model):
    """Packed documents: the MoE models' loss and metrics equal JAX's (the
    padding is routed too, and capacity counts it); an SSM model refuses
    them with the JAX package's ``ValueError``, as it refuses a ragged
    prefill."""
    _, _, api, params, ref = model
    if api.cfg.family == "ssm":
        toks = torch.as_tensor(ref["tokens"])
        with pytest.raises(ValueError, match="no packed-segment"):
            api.loss(params, {"tokens": toks,
                              "segment_ids": torch.ones_like(toks)})
        with pytest.raises(ValueError, match="ragged-length"):
            generate(api, params, ref["tokens"], 2, prompt_lengths=[12, 3])
        return
    batch = {k: torch.as_tensor(v) for k, v in ref["packed"].items()}
    _, metrics = api.loss(params, batch)
    for k in METRICS:
        np.testing.assert_allclose(metrics[k].item(),
                                   ref["packed_metrics"][k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_recurrent_refusals_match_jax(model):
    """What the JAX package refuses for an SSD model, with its messages: a
    streaming chunk > 1 and a multi-token chunk through an SSD carry; and
    a softmax MoE model in the streaming engine."""
    _, _, api, params, _ = model
    cfg = api.cfg
    if cfg.family == "ssm":
        with pytest.raises(ValueError, match="all-aaren"):
            StreamingEngine(api, params, chunk=4)
        toks = torch.as_tensor(_tokens(cfg.vocab, (2, 6)))
        with pytest.raises(ValueError, match="chunk == 1"):
            lm.lm_prefill_chunk(cfg, params, toks,
                                lm.lm_state_init(cfg, 2, device="cpu"))
    elif cfg.attn_mode == "softmax":
        with pytest.raises(ValueError, match="KV-cache models"):
            StreamingEngine(api, params)
    else:
        assert StreamingEngine(api, params, chunk=4).chunk == 4
