"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX package, mirroring tests/test_flash_masking.py.

The same numpy inputs, made from a seed, go through the port's wrappers —
on CPU tensors the plain torch versions of kernels B3, B4 and B5 — and
through the JAX package's dense oracles ``ref.flash_reference`` /
``ref.flash_vjp_reference``, its Pallas kernels in interpret mode (one case
each: interpret mode is slow) and ``jax.grad`` through its ``flash_mha``.

Bars: forward ``rtol=atol=2e-5`` in f32 and ``2e-2`` in bf16 (that file's
bars).  Gradients ``|port - ref| <= 1e-4 * max|ref| + 1e-6``: the JAX
file's scaled bar plus an absolute floor, the f32 noise of the dense
reference where the true gradient is 0 (1.65e-7 measured at ``n=2, lens=
[0, 1]``, where every dq is 0).  Without the floor a scale of ~1e-7
reads that noise as a relative error of 0.165.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.flash_attention import (
    flash_attention_bwd as pallas_flash_bwd,
)
from repro.kernels.ops import flash_mha as jax_flash_mha
from repro.kernels.ref import flash_reference as _jax_flash_reference
from repro.kernels.ref import flash_vjp_reference as _jax_flash_vjp_reference
from repro_torch.core.scan_attention import NEG_INF
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels.ops import flash_mha

jax_flash_reference = jax.jit(
    _jax_flash_reference, static_argnames=("causal", "window", "scale"))
jax_flash_vjp_reference = jax.jit(
    _jax_flash_vjp_reference, static_argnames=("causal", "window", "scale"))

FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(b, h, g, n, d, seed=0):
    rng = np.random.default_rng(seed)
    shapes = ((b, h, n, d), (b, g, n, d), (b, g, n, d), (b, h, n, d))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _ragged_lens(n):
    """Two batch rows: one genuinely ragged, one full-length."""
    return np.asarray([max(1, (2 * n) // 3), n], np.int32)


def _lens(lens):
    return None if lens is None else torch.from_numpy(np.asarray(lens))


def _f32(x):
    return np.asarray(torch.as_tensor(x).float() if torch.is_tensor(x)
                      else jnp.asarray(x, jnp.float32))


def _grad_close(got, want, rtol=1e-4, floor=1e-6):
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        a, b = _f32(a), _f32(b)
        bar = rtol * np.abs(b).max() + floor
        err = np.abs(a - b).max()
        assert err <= bar, f"{name}: max |port - ref| {err:.3e} > {bar:.3e}"


# ---------------------------------------------------------------------------
# Forward (B3's plain version)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 97, 255, 257, 1000])
@pytest.mark.parametrize("ragged", [False, True])
def test_flash_fwd_ragged_n(n, ragged):
    b, h, g, d = 2, 2, 2, 16
    q, k, v, _ = _qkv(b, h, g, n, d, seed=n)
    lens = _ragged_lens(n) if ragged else None
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=True,
                             q_lens=_lens(lens), kv_lens=_lens(lens))
    want = jax_flash_reference(_j(q), _j(k), _j(v), causal=True,
                               q_lens=lens, kv_lens=lens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)])
@pytest.mark.parametrize("g", [4, 2])
def test_flash_fwd_mask_matrix(causal, window, g):
    """causal × windowed × noncausal × GQA at prime N with ragged lengths."""
    b, h, n, d = 2, 4, 97, 16
    q, k, v, _ = _qkv(b, h, g, n, d, seed=7 * g + (window or 0))
    lens = _ragged_lens(n)
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             window=window, q_lens=_lens(lens),
                             kv_lens=_lens(lens))
    want = jax_flash_reference(_j(q), _j(k), _j(v), causal=causal,
                               window=window, q_lens=lens, kv_lens=lens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_fwd_ragged_dtypes(dtype):
    b, h, g, n, d = 2, 4, 2, 250, 32
    q, k, v, _ = _qkv(b, h, g, n, d, seed=3)
    lens = _ragged_lens(n)
    got = fa.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                             q_lens=_lens(lens), kv_lens=_lens(lens))
    want = jax_flash_reference(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                               q_lens=lens, kv_lens=lens)
    assert got.dtype == getattr(torch, dtype)
    tol = FWD_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_flash_masked_queries_read_zero():
    """Rows at or beyond q_lens read o = 0 with lse = NEG_INF, and keys at
    or beyond kv_lens are unattendable even with huge values."""
    b, h, g, n, d = 1, 2, 2, 37, 8
    q, k, v, _ = _qkv(b, h, g, n, d, seed=4)
    v[:, :, 20:, :] = 1e4
    lens = torch.tensor([20], dtype=torch.int32)
    o, lse = fa.flash_attention(_t(q), _t(k), _t(v), q_lens=lens,
                                kv_lens=lens, return_residuals=True)
    assert torch.all(o[:, :, 20:] == 0.0)
    assert torch.all(lse[:, :, 20:] == NEG_INF)
    assert torch.all(o[:, :, :20].abs() < 1e2), "a masked key leaked"
    assert torch.isfinite(lse[:, :, :20]).all()


def test_flash_oversized_lengths_are_noop():
    """Lengths beyond N are clamped to N: the same as no lengths."""
    b, h, g, n, d = 1, 2, 2, 37, 8
    q, k, v, _ = _qkv(b, h, g, n, d, seed=5)
    big = torch.tensor([n + 100], dtype=torch.int32)
    for causal in (True, False):
        got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                 q_lens=big, kv_lens=big)
        want = jax_flash_reference(_j(q), _j(k), _j(v), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# Backward (B4's and B5's plain versions)
# ---------------------------------------------------------------------------


def _port_bwd(q, k, v, do, lens=None, dtype="float32", **kw):
    q, k, v, do = (_t(a, dtype) for a in (q, k, v, do))
    o, lse = fa.flash_attention(q, k, v, q_lens=_lens(lens),
                                kv_lens=_lens(lens), return_residuals=True,
                                **kw)
    return fa.flash_attention_bwd(q, k, v, o, lse, do, q_lens=_lens(lens),
                                  kv_lens=_lens(lens), **kw)


@pytest.mark.parametrize("n", [97, 255])
@pytest.mark.parametrize("window", [None, 48])
def test_flash_bwd_ragged(n, window):
    """flash_attention_bwd == the dense analytic formulas, ragged, GQA."""
    b, h, g, d = 2, 4, 2, 16
    q, k, v, do = _qkv(b, h, g, n, d, seed=n + (window or 0))
    lens = _ragged_lens(n)
    got = _port_bwd(q, k, v, do, lens, window=window)
    want = jax_flash_vjp_reference(_j(q), _j(k), _j(v), _j(do), causal=True,
                                   window=window, q_lens=lens, kv_lens=lens)
    _grad_close(got, want)


def test_flash_bwd_empty_row_dq_is_zero():
    """n=2, lens=[0, 1], no window: batch row 1's only live query attends
    one key, so its softmax is the constant 1 and every dq is 0.  The
    port's dq is 0 within 1e-6 (the dense JAX reference carries f32 noise
    there, which is why the bar has an absolute floor)."""
    b, h, g, n, d = 2, 2, 1, 2, 8
    q, k, v, do = _qkv(b, h, g, n, d, seed=0)
    lens = np.asarray([0, 1], np.int32)
    got = _port_bwd(q, k, v, do, lens)
    assert got[0].abs().max().item() <= 1e-6
    want = jax_flash_vjp_reference(_j(q), _j(k), _j(v), _j(do), causal=True,
                                   q_lens=lens, kv_lens=lens)
    _grad_close(got, want)
    # Masked query rows and keys get exactly zero cotangents.
    assert torch.all(got[0][0] == 0) and torch.all(got[1][0] == 0)
    assert torch.all(got[2][0] == 0) and torch.all(got[1][1, :, 1:] == 0)


def test_flash_bwd_n1000():
    b, h, g, n, d = 1, 2, 2, 1000, 16
    q, k, v, do = _qkv(b, h, g, n, d, seed=11)
    got = _port_bwd(q, k, v, do)
    want = jax_flash_vjp_reference(_j(q), _j(k), _j(v), _j(do), causal=True)
    _grad_close(got, want)


# ---------------------------------------------------------------------------
# Against the Pallas kernels themselves (interpret mode), one case each
# ---------------------------------------------------------------------------


def test_flash_fwd_matches_pallas_interpret():
    b, h, g, n, d = 2, 4, 2, 97, 16
    q, k, v, _ = _qkv(b, h, g, n, d, seed=21)
    lens = _ragged_lens(n)
    o, lse = fa.flash_attention(_t(q), _t(k), _t(v), window=48,
                                q_lens=_lens(lens), kv_lens=_lens(lens),
                                return_residuals=True)
    jo, jlse = pallas_flash(_j(q), _j(k), _j(v), window=48, q_lens=lens,
                            kv_lens=lens, block_q=64, block_k=64,
                            return_residuals=True, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=2e-5,
                               atol=2e-5)


def test_flash_bwd_matches_pallas_interpret():
    b, h, g, n, d = 2, 4, 2, 97, 16
    q, k, v, do = _qkv(b, h, g, n, d, seed=22)
    lens = _ragged_lens(n)
    jo, jlse = pallas_flash(_j(q), _j(k), _j(v), q_lens=lens, kv_lens=lens,
                            block_q=64, block_k=64, return_residuals=True,
                            interpret=True)
    want = pallas_flash_bwd(_j(q), _j(k), _j(v), jo, jlse, _j(do),
                            q_lens=lens, kv_lens=lens, block_q=64,
                            block_k=64, interpret=True)
    got = fa.flash_attention_bwd(
        _t(q), _t(k), _t(v), _t(jo), _t(jlse), _t(do), q_lens=_lens(lens),
        kv_lens=_lens(lens))
    _grad_close(got, want)


# ---------------------------------------------------------------------------
# The kernel boundary (autograd) and the dense oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_mha_grad_matches_jax(dtype):
    """torch.autograd through ``ops.flash_mha`` (FlashAttention: B3 with
    residuals, then B4 and B5) == jax.grad through the JAX ``flash_mha``,
    (B, N, H, d) layout, GQA, ragged."""
    b, n, h, g, d = 2, 97, 4, 2, 16
    rng = np.random.default_rng(31)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, n, h, d), (b, n, g, d), (b, n, g, d)))
    lens = _ragged_lens(n)

    def jloss(q_, k_, v_):
        o = jax_flash_mha(q_, k_, v_, causal=True, q_lens=lens,
                          kv_lens=lens)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        _j(q, dtype), _j(k, dtype), _j(v, dtype))
    tq, tk, tv = (_t(a, dtype).requires_grad_(True) for a in (q, k, v))
    o = flash_mha(tq, tk, tv, causal=True, q_lens=_lens(lens),
                  kv_lens=_lens(lens))
    assert o.shape == (b, n, h, d) and o.dtype == getattr(torch, dtype)
    grads = torch.autograd.grad((o.float() ** 2).sum(), (tq, tk, tv))
    for a, want in zip(grads, jgrads):
        assert a.dtype == getattr(torch, dtype)
    _grad_close(grads, jgrads, rtol=2e-2 if dtype == "bfloat16" else 1e-4)


@pytest.mark.parametrize("window", [None, 5])
def test_port_oracles_match_jax_oracles(window):
    """``repro_torch.kernels.ref``, the plain versions under the oracles'
    signatures, == ``repro.kernels.ref`` (forward and VJP), GQA with
    ragged lengths."""
    b, h, g, n, d = 2, 4, 1, 23, 8
    q, k, v, do = _qkv(b, h, g, n, d, seed=41)
    lens = np.asarray([23, 10], np.int32)
    kw = dict(causal=True, window=window)
    o = ref.flash_reference(_t(q), _t(k), _t(v), q_lens=_lens(lens),
                            kv_lens=_lens(lens), **kw)
    jo = jax_flash_reference(_j(q), _j(k), _j(v), q_lens=lens,
                             kv_lens=lens, **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=2e-5,
                               atol=2e-5)
    got = ref.flash_vjp_reference(_t(q), _t(k), _t(v), _t(do),
                                  q_lens=_lens(lens), kv_lens=_lens(lens),
                                  **kw)
    want = jax_flash_vjp_reference(_j(q), _j(k), _j(v), _j(do),
                                   q_lens=lens, kv_lens=lens, **kw)
    _grad_close(got, want)


def test_plain_versions_are_the_cpu_path():
    """On CPU tensors the wrappers are the plain versions, bit for bit,
    and launch no kernel."""
    b, h, g, n, d = 2, 2, 1, 19, 8
    q, k, v, do = (_t(a) for a in _qkv(b, h, g, n, d, seed=51))
    lens = torch.tensor([19, 4], dtype=torch.int32)
    before = (fa.flash_attention.n_launches, fa.flash_bwd_dq.n_launches,
              fa.flash_bwd_dkv.n_launches)
    kw = dict(causal=True, window=None, scale=d ** -0.5)
    o, lse = fa.flash_attention(q, k, v, q_lens=lens, kv_lens=lens,
                                return_residuals=True, **kw)
    o_p, lse_p = fa.flash_attention_plain(q, k, v, lens, lens, **kw)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    delta = (do * o).sum(-1)
    args = (q, k, v, do, lse, delta, lens, lens)
    assert torch.equal(fa.flash_bwd_dq(*args, **kw),
                       fa.flash_bwd_dq_plain(*args, **kw))
    for a, c in zip(fa.flash_bwd_dkv(*args, **kw),
                    fa.flash_bwd_dkv_plain(*args, **kw)):
        assert torch.equal(a, c)
    assert before == (fa.flash_attention.n_launches,
                      fa.flash_bwd_dq.n_launches,
                      fa.flash_bwd_dkv.n_launches)


def test_wrappers_check_inputs():
    q, k, v, do = (_t(a) for a in _qkv(1, 4, 2, 8, 8, seed=61))
    with pytest.raises(ValueError, match="float32"):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="do not fit"):
        fa.flash_attention(q, k[:, :, :, :4].contiguous(),
                           v[:, :, :, :4].contiguous())
    with pytest.raises(ValueError, match="do not fit"):
        fa.flash_attention(q[:, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="lengths"):
        fa.flash_attention(q, k, v, q_lens=torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.flash_attention(*(t.to("meta") for t in (q, k, v)))
    o, lse = fa.flash_attention(q, k, v, return_residuals=True)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, o, lse[..., :4], do)
    ids = torch.ones(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="both q and kv"):
        fa.flash_attention(q, k, v, q_segment_ids=ids)
    with pytest.raises(ValueError, match="both q and kv"):
        fa.flash_attention_bwd(q, k, v, o, lse, do, kv_segment_ids=ids)
    for bad in (ids.long(), ids[:, :7].contiguous(), ids.expand(2, 8),
                torch.ones(1, 16, dtype=torch.int32)[:, ::2]):
        with pytest.raises(ValueError, match="segment_ids"):
            fa.flash_attention(q, k, v, q_segment_ids=ids,
                               kv_segment_ids=bad)
    # One document over the whole row is no packing at all.
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    assert torch.equal(flash_mha(qs, ks, vs, q_segment_ids=ids),
                       flash_mha(qs, ks, vs))


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """B3, B4 and B5 against their plain versions on the card, at the CPU
    bars (chip_smoke.py runs the full edge-case list)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    errs = chip_smoke.phase3_flash_kernels(torch, np)
    assert set(errs) == {"flash_attention", "flash_bwd_dq", "flash_bwd_dkv"}
