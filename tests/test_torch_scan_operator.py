"""The paper's ⊕ properties and evaluation strategies on the port
(``repro_torch.core.scan_attention``, ``core.aaren``,
``core.softmax_attention.causal_mask_bias``), mirroring
``tests/test_scan_operator.py`` and holding each function to its JAX
counterpart on the same numpy inputs.

Tolerances: the JAX suite's own 2e-5 between strategies, 1e-6 for the
identity element, and 1e-5 f32 against the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import aaren as jaaren
from repro.core import scan_attention as jsa
from repro.core import softmax_attention as jsoft
from repro_torch.core import aaren
from repro_torch.core import scan_attention as sa
from repro_torch.core.softmax_attention import causal_mask_bias

TOL = dict(rtol=2e-5, atol=2e-5)
JAX_TOL = dict(rtol=1e-5, atol=1e-5)

finite_f = st.floats(min_value=-30.0, max_value=30.0, allow_nan=False,
                     allow_subnormal=False, width=32)


def _qkv(seed, q_shape, kv_shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in (q_shape, kv_shape, kv_shape))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@settings(max_examples=50, deadline=None, derandomize=True, database=None)
@given(st.tuples(finite_f, st.lists(finite_f, min_size=2, max_size=2)))
def test_identity_element(leaf):
    """empty ⊕ x == x == x ⊕ empty."""
    x = sa.make_leaf_state(torch.tensor(leaf[0], dtype=torch.float32),
                           torch.tensor(leaf[1], dtype=torch.float32))
    e = sa.make_empty_state((), 2, device="cpu")
    for out in (sa.combine(e, x), sa.combine(x, e)):
        for a, b in zip(out, x):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 129])
@pytest.mark.parametrize("d", [4, 32])
def test_all_strategies_agree(n, d):
    """many-to-one == recurrent == prefix-scan final == blockwise (the
    paper's exactness claim: all are the same attention), each equal to
    the JAX package's function on the same inputs."""
    q, k, v = _qkv(n * 100 + d, (2, d), (2, n, d))
    tq, tk, tv = _t(q, k, v)
    jq, jk, jv = _j(q, k, v)
    o_conv = sa.attention_many_to_one(tq, tk, tv)
    o_rec = sa.attention_recurrent(tq, tk, tv)
    o_mm = sa.attention_many_to_many(tq, tk, tv)
    np.testing.assert_allclose(o_conv.numpy(), o_rec.numpy(), **TOL)
    np.testing.assert_allclose(o_conv.numpy(), o_mm[:, -1].numpy(), **TOL)
    for got, fn in ((o_conv, jsa.attention_many_to_one),
                    (o_rec, jsa.attention_recurrent),
                    (o_mm, jsa.attention_many_to_many)):
        np.testing.assert_allclose(got.numpy(), np.asarray(fn(jq, jk, jv)),
                                   **TOL)
    for b in [1, 2, 4]:
        if n % b == 0:
            o_blk = sa.attention_blockwise(tq, tk, tv, b)
            np.testing.assert_allclose(o_mm.numpy(), o_blk.numpy(), **TOL)
            np.testing.assert_allclose(
                o_blk.numpy(),
                np.asarray(jsa.attention_blockwise(jq, jk, jv, b)), **TOL)


def test_blockwise_rejects_a_partial_block():
    q, k, v = _t(*_qkv(0, (4,), (6, 4)))
    with pytest.raises(ValueError, match="not divisible"):
        sa.attention_blockwise(q, k, v, 4)


def test_prefix_scan_matches_per_prefix_softmax():
    """o_k == Attention(q, x_{1:k}) for every k (many-to-many definition)."""
    n, d = 33, 8
    q, k, v = _t(*_qkv(1, (d,), (n, d)))
    o_mm = sa.attention_many_to_many(q, k, v)
    for kk in [1, 2, 17, 33]:
        o_k = sa.attention_many_to_one(q, k[:kk], v[:kk])
        np.testing.assert_allclose(o_mm[kk - 1].numpy(), o_k.numpy(), **TOL)


def test_transformer_rnn_view():
    """Fig. 1b: causal self-attention row k == many-to-one with q = x_k,
    and the reference equals the JAX package's."""
    n, d = 16, 8
    q, k, v = _qkv(2, (1, n, d), (1, n, d))
    full = sa.causal_attention_reference(*_t(q, k, v))
    tq, tk, tv = _t(q, k, v)
    for t in [0, 3, n - 1]:
        row = sa.attention_many_to_one(tq[:, t], tk[:, :t + 1],
                                       tv[:, :t + 1])
        np.testing.assert_allclose(full[:, t].numpy(), row.numpy(), **TOL)
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jsa.causal_attention_reference(
            *_j(q, k, v))), **JAX_TOL)
    np.testing.assert_allclose(
        sa.scores(tq, tk).numpy(), np.asarray(jsa.scores(*_j(q, k))),
        **JAX_TOL)


def _carry(rng, batch_shape, d):
    u = rng.uniform(0.5, 3.0, batch_shape).astype(np.float32)
    return (rng.standard_normal(batch_shape).astype(np.float32), u,
            (rng.standard_normal(batch_shape + (d,)) * u[..., None])
            .astype(np.float32))


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_many_to_many_with_state_matches_jax(with_carry, with_mask):
    """Carry and mask threading (chunked prefill, App. A) against JAX."""
    n, d = 11, 8
    rng = np.random.default_rng(3)
    q, k, v = _qkv(4, (3, d), (3, n, d))
    carry = _carry(rng, (3,), d) if with_carry else None
    mask = (np.arange(n)[None, :] < np.array([[11], [5], [0]]))
    mask = mask if with_mask else None
    got_o, got_f = sa.attention_many_to_many_with_state(
        *_t(q, k, v),
        carry=None if carry is None else sa.ScanState(*_t(*carry)),
        mask=None if mask is None else torch.from_numpy(mask))
    want_o, want_f = jsa.attention_many_to_many_with_state(
        *_j(q, k, v),
        carry=None if carry is None else jsa.ScanState(*_j(*carry)),
        mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **JAX_TOL)
    for a, b in zip(got_f, want_f):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **JAX_TOL)


@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2)])
def test_aaren_parallel_and_chunked_match_jax(heads, kv_heads):
    """aaren_attention_parallel, and aaren_attention_chunked with a carry
    and a ragged mask, against the JAX package's (GQA included)."""
    b, n, d = 2, 9, 8
    rng = np.random.default_rng(5)
    qh = rng.standard_normal((heads, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, n, kv_heads, d)).astype(np.float32)
            for _ in range(2))
    carry = _carry(rng, (b, heads), d)
    mask = np.arange(n)[None, :] < np.array([[9], [4]])
    scale = d ** -0.5
    got = aaren.aaren_attention_parallel(*_t(qh, k, v), scale)
    want = jaaren.aaren_attention_parallel(*_j(qh, k, v), scale)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **JAX_TOL)
    for a, w in zip(got[1], want[1]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **JAX_TOL)
    for m in (None, mask):
        got = aaren.aaren_attention_chunked(
            *_t(qh, k, v), sa.ScanState(*_t(*carry)), scale,
            mask=None if m is None else torch.from_numpy(m))
        want = jaaren.aaren_attention_chunked(
            *_j(qh, k, v), jsa.ScanState(*_j(*carry)), scale,
            mask=None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   **JAX_TOL)
        for a, w in zip(got[1], want[1]):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), **JAX_TOL)


@pytest.mark.parametrize("n_q,n_k,window,q_offset",
                         [(5, 5, None, 0), (3, 8, None, 5), (6, 6, 2, 0),
                          (2, 9, 3, 7)])
def test_causal_mask_bias_matches_jax(n_q, n_k, window, q_offset):
    got = causal_mask_bias(n_q, n_k, window=window, q_offset=q_offset)
    want = jsoft.causal_mask_bias(n_q, n_k, window=window,
                                  q_offset=q_offset)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
