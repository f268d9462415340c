"""The port's Aaren layer and LM (``repro_torch``) against the JAX package.

Parameters are initialised by the JAX package (``api.init(PRNGKey(0))``)
and carried across with ``params_from_jax``; inputs are made with numpy
from a seed.  Everything runs in f32 on the CPU, where the port's prefix
scan is its plain torch version, and is held to ``rtol=atol=1e-4`` — the
bar the JAX suite holds the scan kernel to against its oracle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core import aaren as jaaren
from repro.models import lm as jlm
from repro.models.factory import build as jax_build
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import aaren as taaren
from repro_torch.core.scan_attention import ScanState
from repro_torch.models import attention as tattention
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax, states_to_jax_layout
from repro_torch.models.factory import build

TOL = dict(rtol=1e-4, atol=1e-4)
CONFIGS = {
    "phi3-smoke": lambda get, smoke: smoke("phi3-mini-3.8b"),
    "aaren-paper-cut": lambda get, smoke: get("aaren-paper", n_layers=2,
                                              d_model=128),
}


NEW_CONFIGS = ("recurrentgemma-9b", "gemma3-27b", "llama3-405b",
               "minitron-8b", "mamba2-1.3b", "qwen3-moe-30b-a3b",
               "dbrx-132b")


@pytest.mark.parametrize("make", [
    lambda get, smoke: get("phi3-mini-3.8b"),
    lambda get, smoke: get("aaren-paper"),
    lambda get, smoke: smoke("phi3-mini-3.8b"),
    lambda get, smoke: smoke("aaren-paper"),
    lambda get, smoke: smoke("phi3-mini-3.8b", n_layers=2, vocab=64),
] + [lambda get, smoke, a=a: get(a) for a in NEW_CONFIGS]
  + [lambda get, smoke, a=a: smoke(a) for a in NEW_CONFIGS],
    ids=["phi3", "aaren-paper", "phi3-smoke", "aaren-paper-smoke",
         "phi3-smoke-override"] + list(NEW_CONFIGS)
    + [f"{a}-smoke" for a in NEW_CONFIGS])
def test_config_copies_match_jax(make):
    """The port keeps copies of the configs: drift must fail loudly."""
    port = dataclasses.asdict(make(get_config, smoke_config))
    ref = dataclasses.asdict(make(jax_get_config, jax_smoke_config))
    assert port == ref


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    make = CONFIGS[request.param]
    jcfg = make(jax_get_config, jax_smoke_config)
    cfg = make(get_config, smoke_config)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def _assert_states(cfg, port_states, jax_states):
    got = jax.tree.leaves(states_to_jax_layout(cfg, port_states))
    want = jax.tree.leaves(jax_states)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_lm_apply_logits_and_carries(model, ragged):
    jcfg, jparams, cfg, params = model
    toks = _tokens(cfg, (3, 11))
    lens = np.array([11, 4, 1]) if ragged else None
    jlogits, jstates, _ = jlm.lm_apply(
        jcfg, jparams, jnp.asarray(toks), collect_state=True,
        lengths=None if lens is None else jnp.asarray(lens))
    logits, states = lm.lm_apply(
        cfg, params, torch.as_tensor(toks), collect_state=True,
        lengths=None if lens is None else torch.as_tensor(lens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    _assert_states(cfg, states, jstates)


def test_prefill_chunks_and_decode_match_jax(model):
    """Three chunks with a ragged length mask, then decode steps."""
    jcfg, jparams, cfg, params = model
    b, c = 3, 5
    toks = _tokens(cfg, (3, b, c), seed=1)
    lens = np.array([[5, 5, 2], [5, 3, 0], [1, 0, 4]])
    jstates = jlm.lm_state_init(jcfg, b, 1)
    states = lm.lm_state_init(cfg, b, device="cpu")
    for t, ln in zip(toks, lens):
        mask = np.arange(c)[None, :] < ln[:, None]
        jlogits, jstates = jlm.lm_prefill_chunk(
            jcfg, jparams, jnp.asarray(t), jstates,
            length_mask=jnp.asarray(mask))
        logits, states = lm.lm_prefill_chunk(
            cfg, params, torch.as_tensor(t), states,
            length_mask=torch.as_tensor(mask))
        valid = mask[..., None]   # padded positions' logits are garbage
        np.testing.assert_allclose(np.where(valid, logits.numpy(), 0),
                                   np.where(valid, np.asarray(jlogits), 0),
                                   **TOL)
        _assert_states(cfg, states, jstates)
    for t in _tokens(cfg, (2, b, 1), seed=2):
        jlogits, jstates = jlm.lm_decode_step(jcfg, jparams, jnp.asarray(t),
                                              jstates)
        logits, states = lm.lm_decode_step(cfg, params, torch.as_tensor(t),
                                           states)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        _assert_states(cfg, states, jstates)


def test_one_shot_prefill_equals_chunked(model):
    """Inside the port: lm_apply's final carries == the same tokens folded
    chunk by chunk, and the last logits agree."""
    _, _, cfg, params = model
    toks = torch.as_tensor(_tokens(cfg, (2, 13), seed=3))
    logits, one_shot = lm.lm_apply(cfg, params, toks, collect_state=True)
    states = lm.lm_state_init(cfg, 2, device="cpu")
    for lo in range(0, 13, 4):
        chunk = toks[:, lo:lo + 4]
        if chunk.shape[1] < 4:   # fixed chunk shape: pad and mask the tail
            pad = 4 - chunk.shape[1]
            mask = torch.arange(4)[None, :] < chunk.shape[1]
            chunk = torch.nn.functional.pad(chunk, (0, pad))
            clog, states = lm.lm_prefill_chunk(cfg, params, chunk, states,
                                               length_mask=mask.expand(2, 4))
            clog = clog[:, :4 - pad]
        else:
            clog, states = lm.lm_prefill_chunk(cfg, params, chunk, states)
    np.testing.assert_allclose(clog[:, -1].numpy(), logits[:, -1].numpy(),
                               **TOL)
    for a, b in zip(one_shot, states):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)


@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2), (6, 1)])
def test_aaren_layer_matches_jax_gqa(heads, kv_heads):
    """Layer level: head queries in f32, GQA scores (head h reads kv head
    h // (H/G)), the parallel layer and the O(1) step."""
    rng = np.random.default_rng(heads * 10 + kv_heads)
    d_model, d_head, b, n = 24, 8, 2, 7
    arrays = dict(query=rng.standard_normal(d_model) * 0.5,
                  wq=rng.standard_normal((d_model, heads, d_head)) * 0.3,
                  wk=rng.standard_normal((d_model, kv_heads, d_head)) * 0.3,
                  wv=rng.standard_normal((d_model, kv_heads, d_head)) * 0.3,
                  wo=rng.standard_normal((heads, d_head, d_model)) * 0.3)
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    x = rng.standard_normal((b, n, d_model)).astype(np.float32)
    jw = jaaren.AarenWeights(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tw = taaren.AarenWeights(**{k: torch.from_numpy(v)
                                for k, v in arrays.items()})
    np.testing.assert_allclose(taaren.head_queries(tw).numpy(),
                               np.asarray(jaaren.head_queries(jw)), **TOL)

    jy, jfin = jax.jit(jaaren.aaren_layer_parallel)(jw, jnp.asarray(x))
    y, fin = tattention.aaren_sequence(
        {k: torch.from_numpy(v) for k, v in arrays.items()},
        torch.from_numpy(x),
        get_config("aaren-paper", n_heads=heads, n_kv_heads=kv_heads,
                   head_dim=d_head, d_model=d_model))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for a, b_ in zip(fin, jfin):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **TOL)

    x_t = x[:, :1]
    jy_t, jnew = jax.jit(jaaren.aaren_layer_step)(jw, jnp.asarray(x_t),
                                                 jfin)
    y_t, new = taaren.aaren_layer_step(tw, torch.from_numpy(x_t),
                                       ScanState(*fin))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(jy_t), **TOL)
    for a, b_ in zip(new, jnew):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **TOL)


def test_params_from_jax_keeps_bf16_bits():
    """bf16 JAX parameters (the registered configs' param dtype) cross as
    bf16 tensors with the same bits."""
    jcfg = jax_smoke_config("phi3-mini-3.8b", n_layers=1, vocab=64,
                            param_dtype="bfloat16")
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    cfg = smoke_config("phi3-mini-3.8b", n_layers=1, vocab=64,
                       param_dtype="bfloat16")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    want = np.asarray(jparams["periods"][0]["mixer"]["wk"][0])
    got = params["layers"][0]["mixer"]["wk"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


def test_init_is_seeded_and_follows_the_rules():
    cfg = smoke_config("phi3-mini-3.8b")
    api = build(cfg)
    a, b = api.init(7, device="cpu"), api.init(7, device="cpu")
    layer = a["layers"][0]
    assert torch.equal(layer["mixer"]["wk"], b["layers"][0]["mixer"]["wk"])
    assert not torch.equal(api.init(8, device="cpu")["layers"][0]["mixer"]
                           ["wk"], layer["mixer"]["wk"])
    assert len(a["layers"]) == cfg.n_layers
    assert layer["mixer"]["wq"].shape == (cfg.d_model, cfg.n_heads,
                                          cfg.resolved_head_dim)
    assert torch.equal(layer["norm1"]["scale"], torch.ones(cfg.d_model))
    std = layer["mlp"]["wi_gate"].std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert abs(a["embed"]["table"].std().item() - 0.02) < 0.002
    bf16 = build(cfg.replace(param_dtype="bfloat16")).init(0, device="cpu")
    assert bf16["embed"]["table"].dtype == torch.bfloat16


def test_entry_points_refuse_a_missing_card():
    """Entry points default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    api = build(smoke_config("phi3-mini-3.8b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.lm_state_init(api.cfg, 2)


def test_unsupported_blocks_raise():
    """An unknown mixer raises; an SSD block (ROADMAP A10b, ported:
    tests/test_torch_ssd.py) builds in a dense pattern and runs."""
    cfg = smoke_config("phi3-mini-3.8b", pattern=("ssd",), ssm_state=16,
                       ssm_heads=4)
    api = build(cfg)
    params = api.init(0, device="cpu")
    assert params["layers"][0]["mixer"]["w_in"].shape == (
        cfg.d_model, 2 * cfg.d_inner + 2 * 16 + 4)
    logits = api.forward(params, {"tokens": torch.zeros((1, 5),
                                                        dtype=torch.int64)})
    assert torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="unknown mixer"):
        build(cfg.replace(pattern=("lstm",))).init(0, device="cpu")
