"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's.

Parameters are initialised by the JAX package and carried across as numpy;
inputs are made with numpy from a seed.  Everything runs in f32 on the CPU
and is held to ``rtol=atol=1e-5``.  Two widths: the smoke width
(``rnn_width = 128``, one gate block) and ``rnn_width = 512`` (two
256-wide blocks), where the gates' block-diagonal structure shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import rglru as jrglru
from repro.models.param import init_params as jax_init_params
from repro_torch.configs import smoke_config
from repro_torch.models import rglru
from repro_torch.models.convert import tree_to_torch

TOL = dict(rtol=1e-5, atol=1e-5)
WIDTHS = {"smoke": {}, "two-blocks": {"rnn_width": 512}}
# Jitted once each (eager JAX dispatches the scan's ops one by one).
jseq = jax.jit(jrglru.rglru_sequence, static_argnums=2)
jstep = jax.jit(jrglru.rglru_step, static_argnums=3)
jscan = jax.jit(jrglru._linear_scan)


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def block(request):
    kw = WIDTHS[request.param]
    jcfg = jax_smoke_config("recurrentgemma-9b", **kw)
    cfg = smoke_config("recurrentgemma-9b", **kw)
    jp = jax_init_params(jrglru.rglru_specs(jcfg), jax.random.PRNGKey(3))
    p = tree_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, cfg, p


def _x(cfg, b, n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_specs_match_jax(block):
    jcfg, jp, cfg, p = block
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: s.shape for k, s in rglru.rglru_specs(cfg).items()}
    nb = p["w_rgate"].shape[0]
    assert nb == max(cfg.d_rnn // 256, 1)


@pytest.mark.parametrize("n", [1, 7, 150], ids=["n1", "n7", "n150"])
def test_sequence_then_steps_match_jax(block, n):
    """rglru_sequence's output and state, then three rglru_step updates,
    against the JAX functions (N = 150 crosses the scan's 64-token chunks;
    N = 1 has a conv tail shorter than d_conv - 1, compared on ``h`` and
    the step outputs below)."""
    jcfg, jp, cfg, p = block
    x = _x(cfg, 2, n + 3, seed=n)
    jy, jst = jseq(jp, jnp.asarray(x[:, :n]), jcfg)
    y, st = rglru.rglru_sequence(p, torch.from_numpy(x[:, :n]), cfg)
    _close(y, jy)
    _close(st["h"], jst["h"])
    assert st["conv"].shape == (2, cfg.d_conv - 1, cfg.d_rnn)
    if n >= cfg.d_conv - 1:
        _close(st["conv"], jst["conv"])
        for t in range(n, n + 3):
            jy, jst = jstep(jp, jnp.asarray(x[:, t:t + 1]), jst, jcfg)
            y, st = rglru.rglru_step(p, torch.from_numpy(x[:, t:t + 1]), st,
                                     cfg)
            _close(y, jy)
            _close(st["h"], jst["h"])
            _close(st["conv"], jst["conv"])


@pytest.mark.parametrize("n", [1, 2], ids=["prefill1", "prefill2"])
def test_short_prefill_then_step_equals_jax_full_forward(block, n):
    """The port's conv tail after a 1- or 2-token prefill is zero-padded to
    d_conv - 1, so the next step equals the JAX package's full forward at
    that position (the JAX package keeps a short tail there: its step
    differs; ROADMAP queue C)."""
    jcfg, jp, cfg, p = block
    x = _x(cfg, 2, n + 1, seed=10 + n)
    jfull, _ = jseq(jp, jnp.asarray(x), jcfg)
    _, st = rglru.rglru_sequence(p, torch.from_numpy(x[:, :n]), cfg)
    y, _ = rglru.rglru_step(p, torch.from_numpy(x[:, n:]), st, cfg)
    _close(y[:, 0], np.asarray(jfull)[:, n])


def _pairs(n, r, regime, seed):
    """Decays and inputs of one regime: the block's own range, decays all
    near 0 (a = e^-60), all near 1 (1 - 1e-7), or mixed per channel."""
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((2, n, r)).astype(np.float32)
    if regime == "gates":
        a = np.exp(-8.0 * np.log1p(np.exp(rng.standard_normal(r) * 0.5))
                   * rng.uniform(0, 1, (2, n, r))).astype(np.float32)
    elif regime == "near0":
        a = np.full((2, n, r), np.exp(-60.0), np.float32)
    elif regime == "near1":
        a = np.full((2, n, r), 1.0 - 1e-7, np.float32)
    else:
        a = np.where(rng.random((2, n, r)) < 0.5, np.exp(-60.0),
                     1.0 - 1e-7).astype(np.float32)
    return a, b


@pytest.mark.parametrize("regime", ["gates", "near0", "near1", "mixed"])
@pytest.mark.parametrize("chunk", [64, 8], ids=["chunk64", "chunk8"])
def test_chunked_scan_matches_associative_scan(regime, chunk):
    """The chunked scan against ``jax.lax.associative_scan`` at N = 1000
    (not a multiple of the chunk; chunk 8 runs three levels of chunks),
    with and without a carry-in: finite, and within the bar.  A
    cumprod-and-divide scan would be inf/NaN here within tens of tokens."""
    a, b = _pairs(1000, 16, regime, seed=len(regime) + chunk)
    h0 = np.random.default_rng(1).standard_normal((2, 16)).astype(np.float32)
    for carry in (None, h0):
        want = jscan(
            jnp.asarray(a), jnp.asarray(b),
            None if carry is None else jnp.asarray(carry))
        got = rglru._linear_scan(
            torch.from_numpy(a), torch.from_numpy(b),
            None if carry is None else torch.from_numpy(carry), chunk=chunk)
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_scan_gradients_match_jax():
    """Autograd through the chunked scan against JAX's VJP of its scan."""
    a, b = _pairs(200, 8, "gates", seed=5)
    g = np.random.default_rng(6).standard_normal(b.shape).astype(np.float32)
    ja, jb = jax.jit(lambda a, b, g: jax.vjp(jrglru._linear_scan, a, b)[1](
        g))(jnp.asarray(a), jnp.asarray(b), jnp.asarray(g))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    ga, gb = torch.autograd.grad(rglru._linear_scan(ta, tb, chunk=16),
                                 (ta, tb), torch.from_numpy(g))
    for got, want in ((ga, ja), (gb, jb)):
        scale = max(float(np.abs(np.asarray(want)).max()), 1e-6)
        np.testing.assert_allclose(got.numpy() / scale,
                                   np.asarray(want) / scale, rtol=1e-4,
                                   atol=1e-4)
