"""The port's routed MoE MLP (``repro_torch.models.moe``) against the JAX
package's.

``apply_moe`` at the smoke widths of qwen3-moe-30b-a3b (4 experts top-2,
d_model 128, expert width 64) and dbrx-132b, from JAX's initial
parameters carried across as numpy, on inputs made with numpy from a
seed: the output, ``load_balance_loss``, ``dropped_frac`` and the
gradients of the input, the router and every expert weight.  At the
configs' own capacity factor (1.25) tokens are dropped, and the test
asserts that they are, so the drop path runs; with headroom (capacity
factor 8) nothing is dropped, and the output also equals a brute-force
per-token expert sum in torch (the JAX suite's reference).  f32 on the
CPU: outputs and metrics within ``rtol=atol=1e-5``, gradients within 1e-4
of their leaf's max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro.models.param import init_params as jax_init_params
from repro_torch.configs import smoke_config
from repro_torch.models import moe
from repro_torch.models.convert import tree_to_torch

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [("qwen3-moe-30b-a3b", 1.25), ("qwen3-moe-30b-a3b", 8.0),
         ("dbrx-132b", 1.25), ("dbrx-132b", 8.0)]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-cf{c}" for a, c in CASES])
def case(request):
    """Both packages' configs and parameters, a (2, 24) input and JAX's
    output, aux and gradients (input and parameters) of ``sum(y · ct) +
    load_balance_loss`` in one JAX compile."""
    arch, cf = request.param
    jcfg = jax_smoke_config(arch, capacity_factor=cf)
    cfg = smoke_config(arch, capacity_factor=cf)
    jp = jax_init_params(jmoe.moe_specs(jcfg), jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    # Tokens that share a direction prefer the same experts, so capacity
    # binds at the configs' own factor.
    x = (rng.standard_normal((2, 24, cfg.d_model))
         + 2.0 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)

    def objective(pp, xx):
        y, aux = jmoe.apply_moe(pp, xx, jcfg, return_aux=True)
        return jnp.sum(y * ct) + aux["load_balance_loss"], (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    return {"cfg": cfg, "np_p": jax.tree.map(np.asarray, jp), "x": x,
            "ct": ct, "y": np.asarray(y),
            "aux": {k: float(v) for k, v in aux.items()},
            "gp": jax.tree.map(np.asarray, gp), "gx": np.asarray(gx)}


def _port(case, grad=False):
    p = tree_to_torch(case["np_p"], "cpu")
    x = torch.from_numpy(case["x"])
    if grad:
        for v in p.values():
            v.requires_grad_(True)
        x.requires_grad_(True)
    return p, x


def test_output_and_aux_match_jax(case):
    p, x = _port(case)
    y, aux = moe.apply_moe(p, x, case["cfg"], return_aux=True)
    np.testing.assert_allclose(y.numpy(), case["y"], **TOL)
    for key in ("load_balance_loss", "dropped_frac"):
        np.testing.assert_allclose(aux[key].item(), case["aux"][key], **TOL)
    if case["cfg"].capacity_factor < 2:
        assert aux["dropped_frac"].item() > 0    # the drop path ran
    else:
        assert aux["dropped_frac"].item() == 0
    y2 = moe.apply_moe(p, x, case["cfg"], decode=True)
    assert torch.equal(y2, y)                    # decode= changes nothing


def test_gradients_match_jax(case):
    """Input, router and expert gradients of ``sum(y · ct) +
    load_balance_loss``: the router's gradient comes through the gates and
    through ``router_mean``."""
    p, x = _port(case, grad=True)
    y, aux = moe.apply_moe(p, x, case["cfg"], return_aux=True)
    obj = (y * torch.from_numpy(case["ct"])).sum() + aux["load_balance_loss"]
    names = sorted(p)
    grads = torch.autograd.grad(obj, [x] + [p[k] for k in names])
    want = [case["gx"]] + [case["gp"][k] for k in names]
    for name, a, b in zip(["x"] + names, grads, want):
        scale = max(np.abs(b).max(), 1e-6)
        assert scale > 1e-6, name
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def _brute_force(p, x, cfg):
    """Every token through its top-k experts one at a time (nothing
    dropped), as ``tests/test_models.py`` does in JAX."""
    k = cfg.n_experts_per_tok
    probs = torch.softmax(x @ p["router"], dim=-1)
    gv, ids = torch.topk(probs, k, dim=-1)
    gv = gv / gv.sum(-1, keepdim=True)
    ref = torch.zeros_like(x)
    for bi in range(x.shape[0]):
        for t in range(x.shape[1]):
            for j in range(k):
                ei = int(ids[bi, t, j])
                xt = x[bi, t]
                h = F.silu(xt @ p["wi_gate"][ei]) * (xt @ p["wi_up"][ei])
                ref[bi, t] += gv[bi, t, j] * (h @ p["wo"][ei])
    return ref


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "dbrx-132b"])
def test_matches_brute_force_when_nothing_is_dropped(arch):
    cfg = smoke_config(arch, capacity_factor=8.0)
    p = tree_to_torch(jax.tree.map(np.asarray, jax_init_params(
        jmoe.moe_specs(jax_smoke_config(arch)), jax.random.PRNGKey(7))),
        "cpu")
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    y, aux = moe.apply_moe(p, x, cfg, return_aux=True)
    assert aux["dropped_frac"].item() == 0
    np.testing.assert_allclose(y.numpy(), _brute_force(p, x, cfg).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_dropped_tokens_keep_only_the_residual_share():
    """A capacity of 1 per (row, expert): only each expert's first routed
    token is computed, in token order, and a token whose every choice was
    dropped gets exactly 0 (the block's residual carries it)."""
    cfg = smoke_config("qwen3-moe-30b-a3b", capacity_factor=0.1)
    assert moe.expert_capacity(8, cfg) == 1
    rng = np.random.default_rng(5)
    p = tree_to_torch(jax.tree.map(np.asarray, jax_init_params(
        jmoe.moe_specs(jax_smoke_config("qwen3-moe-30b-a3b")),
        jax.random.PRNGKey(6))), "cpu")
    x = torch.from_numpy(rng.standard_normal((1, 8, cfg.d_model))
                         .astype(np.float32))
    y, aux = moe.apply_moe(p, x, cfg, return_aux=True)
    ids = torch.topk(torch.softmax(x @ p["router"], -1), 2, -1).indices[0]
    first = {}
    for t in range(8):
        for e in ids[t].tolist():
            first.setdefault(e, t)
    kept = {(t, e) for e, t in first.items()}
    assert aux["dropped_frac"].item() == pytest.approx(1 - len(kept) / 16)
    for t in range(8):
        if not any((t, e) in kept for e in ids[t].tolist()):
            assert torch.equal(y[0, t], torch.zeros_like(y[0, t]))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "qwen3-moe-30b-a3b",
                                  "dbrx-132b"])
def test_full_configs_build_with_jax_parameter_counts(arch):
    """``build(get_config(arch))`` at full width: its parameter specs hold
    as many parameters as the JAX package's abstract tree (nothing is
    allocated)."""
    from repro.configs import get_config as jax_get_config
    from repro.models.factory import build as jax_build
    from repro_torch.configs import get_config
    from repro_torch.models.factory import build
    from repro_torch.models.param import count_params

    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jax_build(jax_get_config(arch)).abstract()))
    got = count_params(build(get_config(arch)).specs())
    assert got == want
    if arch == "mamba2-1.3b":
        assert got == 1_343_740_928
