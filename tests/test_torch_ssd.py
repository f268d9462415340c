"""The port's Mamba-2 SSD mixer (``repro_torch.models.ssd``) against the
JAX package's.

The chunked core at chunk 16, 64 and 256 over several chunks, with and
without a carried-in state, with decays near 0 and near 1; the mixer's
sequence form, its decode step and their gradients at the mamba2 smoke
width (d_model 128, 4 heads x 64, state 16), from JAX's initial
parameters carried across as numpy.  f32 on the CPU, to ``rtol=atol=
1e-5`` (the chunked core's outputs to 1e-5 of their largest magnitude:
its sums of up to 256 terms run in another order than XLA's; gradients
within 1e-4 of their leaf's max).  Short prefills of 1
and 2 tokens then a step against JAX's full forward: the JAX package keeps
a conv tail shorter than ``d_conv - 1`` there and its own step misses the
forward; the port zero-pads the tail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import ssd as jssd
from repro.models.param import init_params as jax_init_params
from repro_torch.configs import smoke_config
from repro_torch.models import ssd
from repro_torch.models.convert import tree_to_torch

ARCH = "mamba2-1.3b"
TOL = dict(rtol=1e-5, atol=1e-5)


def _core_inputs(seed, bsz, length, h, p, n, a_log_mean):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((bsz, length, h, p)).astype(f),
            rng.standard_normal((bsz, length, n)).astype(f),
            rng.standard_normal((bsz, length, n)).astype(f),
            np.log1p(np.exp(rng.standard_normal((bsz, length, h)))).astype(f),
            (a_log_mean + 0.3 * rng.standard_normal(h)).astype(f),
            rng.standard_normal((bsz, h, p, n)).astype(f))


# (chunk, L): 4 chunks of 16, 4 of 64, 2 of 256; a_log sets the decay
# exp(-dt · exp(a_log)): 3.0 drives it to ~0, -6.0 to ~1.
@pytest.mark.parametrize("chunk,length", [(16, 64), (64, 256), (256, 512)])
@pytest.mark.parametrize("a_log", [0.0, 3.0, -6.0])
@pytest.mark.parametrize("with_s0", [False, True])
def test_chunked_core_matches_jax(chunk, length, a_log, with_s0):
    xh, bh, ch, dt, al, s0 = _core_inputs(chunk + length, 2, length, 3, 8, 4,
                                          a_log)
    s0 = s0 if with_s0 else None
    jy, js = jssd._ssd_chunked(*map(jnp.asarray, (xh, bh, ch, dt, al)),
                               s0=None if s0 is None else jnp.asarray(s0),
                               chunk=chunk)
    y, s = ssd._ssd_chunked(*map(torch.from_numpy, (xh, bh, ch, dt, al)),
                            s0=None if s0 is None else torch.from_numpy(s0),
                            chunk=chunk)
    for a, b in ((y, jy), (s, js)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())
    # The decays cover the range the case names.
    decay = np.exp(-dt * np.exp(al))
    if a_log == 3.0:
        assert np.median(decay) < 1e-5
    if a_log == -6.0:
        assert np.median(decay) > 0.99


def test_chunked_core_refuses_lengths_off_the_chunk_grid():
    """Only L <= 256 or multiples of 256 — in both packages."""
    args = _core_inputs(0, 1, 300, 2, 4, 4, 0.0)[:5]
    with pytest.raises(ValueError, match="not divisible by chunk"):
        jssd._ssd_chunked(*map(jnp.asarray, args))
    with pytest.raises(ValueError, match="not divisible by chunk"):
        ssd._ssd_chunked(*map(torch.from_numpy, args))


@pytest.fixture(scope="module")
def mixer():
    """The smoke mixer's parameters in both packages, a (2, 12) input, and
    JAX's sequence outputs, state and input/parameter gradients under a
    random cotangent (one JAX compile)."""
    jcfg = jax_smoke_config(ARCH)
    cfg = smoke_config(ARCH)
    jp = jax_init_params(jssd.ssd_specs(jcfg), jax.random.PRNGKey(0))
    # Spread the decays: the initial a_log ~ N(0, 0.5) and dt_bias 0.
    rng = np.random.default_rng(1)
    jp = dict(jp, dt_bias=jnp.asarray(rng.standard_normal(4), jnp.float32))
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)

    def fwd_and_grads(pp, xx):
        (out, state), vjp = jax.vjp(lambda a, b: jssd.ssd_sequence(a, b, jcfg),
                                    pp, xx)
        zero_state = jax.tree.map(jnp.zeros_like, state)
        gp, gx = vjp((jnp.asarray(ct), zero_state))
        return out, state, gp, gx

    out, state, gp, gx = jax.jit(fwd_and_grads)(jp, jnp.asarray(x))
    np_p = jax.tree.map(np.asarray, jp)
    return {"jcfg": jcfg, "cfg": cfg, "jp": jp, "np_p": np_p, "x": x,
            "ct": ct, "out": np.asarray(out),
            "state": jax.tree.map(np.asarray, state),
            "gp": jax.tree.map(np.asarray, gp), "gx": np.asarray(gx)}


def test_sequence_and_state_match_jax(mixer):
    p = tree_to_torch(mixer["np_p"], "cpu")
    out, state = ssd.ssd_sequence(p, torch.from_numpy(mixer["x"]),
                                  mixer["cfg"])
    np.testing.assert_allclose(out.numpy(), mixer["out"], **TOL)
    for key in ("s", "conv"):
        assert state[key].shape == mixer["state"][key].shape
        np.testing.assert_allclose(state[key].numpy(), mixer["state"][key],
                                   **TOL)


def test_sequence_gradients_match_jax(mixer):
    """The input's and every parameter's gradient under one cotangent."""
    p = tree_to_torch(mixer["np_p"], "cpu")
    for v in p.values():
        v.requires_grad_(True)
    x = torch.from_numpy(mixer["x"]).requires_grad_(True)
    out, _ = ssd.ssd_sequence(p, x, mixer["cfg"])
    names = sorted(p)
    grads = torch.autograd.grad(out, [x] + [p[k] for k in names],
                                torch.from_numpy(mixer["ct"]))
    want = [mixer["gx"]] + [mixer["gp"][k] for k in names]
    for name, a, b in zip(["x"] + names, grads, want):
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_steps_match_jax_steps(mixer):
    """From JAX's state after 8 tokens, four decode steps: each output and
    state equal JAX's step."""
    jcfg, cfg = mixer["jcfg"], mixer["cfg"]
    p = tree_to_torch(mixer["np_p"], "cpu")
    x = mixer["x"]
    _, jstate = jssd.ssd_sequence(mixer["jp"], jnp.asarray(x[:, :8]), jcfg)
    state = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
    for t in range(8, 12):
        jy, jstate = jssd.ssd_step(mixer["jp"], jnp.asarray(x[:, t:t + 1]),
                                   jstate, jcfg)
        y, state = ssd.ssd_step(p, torch.from_numpy(x[:, t:t + 1]), state,
                                cfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        for key in ("s", "conv"):
            np.testing.assert_allclose(state[key].numpy(),
                                       np.asarray(jstate[key]), **TOL)


@pytest.mark.parametrize("p_len", [1, 2, 3, 8])
def test_short_prefill_then_steps_match_jax_full_forward(mixer, p_len):
    """Prefill ``p_len`` tokens, then step to token 11: every step's
    output equals JAX's full forward there.  For 1 and 2 tokens the JAX
    package's own prefill keeps a conv tail of 1 or 2 rows, not 3, and its
    step misses the forward by ~1 (ROADMAP queue C); the port's tail is
    zero-padded to 3 rows."""
    jcfg, cfg = mixer["jcfg"], mixer["cfg"]
    p = tree_to_torch(mixer["np_p"], "cpu")
    x = mixer["x"]
    full = mixer["out"]
    out, state = ssd.ssd_sequence(p, torch.from_numpy(x[:, :p_len]), cfg)
    assert state["conv"].shape[1] == cfg.d_conv - 1
    np.testing.assert_allclose(out.numpy(), full[:, :p_len], **TOL)
    for t in range(p_len, 12):
        y, state = ssd.ssd_step(p, torch.from_numpy(x[:, t:t + 1]), state,
                                cfg)
        np.testing.assert_allclose(y[:, 0].numpy(), full[:, t], **TOL)
    _, jstate = jssd.ssd_sequence(mixer["jp"], jnp.asarray(x[:, :p_len]),
                                  jcfg)
    jy, _ = jssd.ssd_step(mixer["jp"], jnp.asarray(x[:, p_len:p_len + 1]),
                          jstate, jcfg)
    jmiss = np.abs(np.asarray(jy)[:, 0] - full[:, p_len]).max()
    assert jstate["conv"].shape[1] == min(p_len, cfg.d_conv - 1)
    if p_len < cfg.d_conv - 1:
        assert jmiss > 0.5, jmiss       # the reference's short tail
    else:
        assert jmiss < 1e-4, jmiss


def test_state_init_shapes_and_dtypes():
    cfg = smoke_config(ARCH, compute_dtype="bfloat16")
    st = ssd.ssd_state_init(cfg, 3, "cpu")
    d_in, h, p, n = ssd.ssd_dims(cfg)
    assert (d_in, h, p, n) == (256, 4, 64, 16)
    assert st["s"].shape == (3, h, p, n) and st["s"].dtype == torch.float32
    assert st["conv"].shape == (3, cfg.d_conv - 1, d_in + 2 * n)
    assert st["conv"].dtype == torch.bfloat16
    assert not any(v.any() for v in st.values())
