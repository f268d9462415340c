"""``remat="group"`` in the port's ``models/lm.py`` — the sqrt-L two-level
remat — against ``remat="block"``, ``"none"`` and the JAX package's
``remat="group"``.

Bars: between remat modes of the port, loss ``rtol=1e-6`` and gradients
``rtol=1e-4, atol=1e-5`` (``tests/test_models.py::
test_group_remat_equivalence``); against JAX, loss ``rtol=1e-5`` and
gradients scaled by max |JAX| at 1e-4, the port's usual bars.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.models.factory import build as jax_build
from repro_torch.configs import smoke_config
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.factory import build
from repro_torch.tree import tree_leaves

F32 = dict(compute_dtype="float32", param_dtype="float32")


def _setup(n_layers, remat="group"):
    jcfg = jax_smoke_config("phi3-mini-3.8b", n_layers=n_layers,
                            remat=remat, **F32)
    japi = jax_build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                         jcfg.vocab), np.int32)
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, japi, jparams, np_params, toks


def _loss_and_grads(remat, n_layers, np_params, toks):
    cfg = smoke_config("phi3-mini-3.8b", n_layers=n_layers, remat=remat,
                       **F32)
    params = params_from_jax(np_params, cfg, "cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = build(cfg).loss(params, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), [g.numpy() for g in grads]


def _count_checkpoints(monkeypatch):
    calls = {"checkpoint": 0, "block": 0}
    real_ckpt, real_block = lm.checkpoint, lm.blocks.block_sequence

    def ckpt(*args, **kw):
        calls["checkpoint"] += 1
        return real_ckpt(*args, **kw)

    def block(*args, **kw):
        calls["block"] += 1
        return real_block(*args, **kw)

    monkeypatch.setattr(lm, "checkpoint", ckpt)
    monkeypatch.setattr(lm.blocks, "block_sequence", block)
    return calls


def test_group_size_matches_jax():
    got = [lm._group_size(n) for n in range(1, 129)]
    assert got == [jlm._group_size(n) for n in range(1, 129)]
    assert lm._group_size(32) == 4  # phi3-mini-3.8b: 8 groups of 4


def test_group_matches_block_and_none(monkeypatch):
    """8 periods in 4 checkpointed groups of 2: the loss and gradients of
    block and none; each layer runs forward twice (the recompute)."""
    _, _, _, np_params, toks = _setup(8)
    calls = _count_checkpoints(monkeypatch)
    loss_g, grads_g = _loss_and_grads("group", 8, np_params, toks)
    assert calls == {"checkpoint": 4, "block": 16}
    for remat in ("block", "none"):
        loss, grads = _loss_and_grads(remat, 8, np_params, toks)
        np.testing.assert_allclose(loss_g, loss, rtol=1e-6)
        for a, b in zip(grads_g, grads):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_layers", [2, 3])
def test_group_falls_back_to_block_at_few_periods(monkeypatch, n_layers):
    """With n_periods <= 3 "group" checkpoints every period, as "block"
    does (and gives its loss)."""
    _, _, _, np_params, toks = _setup(n_layers)
    calls = _count_checkpoints(monkeypatch)
    loss_g, _ = _loss_and_grads("group", n_layers, np_params, toks)
    assert calls == {"checkpoint": n_layers, "block": 2 * n_layers}
    loss_b, _ = _loss_and_grads("block", n_layers, np_params, toks)
    assert loss_g == loss_b


def test_group_matches_jax_group():
    """The port's group-remat loss and gradients against the JAX package's
    ``remat="group"`` on the same weights and tokens."""
    jcfg, japi, jparams, np_params, toks = _setup(8)
    (jloss, _), jgrads = jax.value_and_grad(japi.loss, has_aux=True)(
        jparams, {"tokens": toks})
    loss, grads = _loss_and_grads("group", 8, np_params, toks)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jgrads),
                                       jcfg, "cpu"))
    assert len(want) == len(grads)
    for a, b in zip(grads, want):
        b = b.numpy()
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, rtol=1e-4,
                                   atol=1e-4)


def test_unknown_remat_raises():
    cfg = smoke_config("phi3-mini-3.8b", remat="layers", **F32)
    params = build(cfg).init(0, device="cpu")
    with pytest.raises(ValueError, match="unknown remat"):
        lm.lm_apply(cfg, params, torch.zeros((1, 4), dtype=torch.long))
