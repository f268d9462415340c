"""Sequence packing in the port (``repro_torch``) against the JAX package:
the Aaren half of ``tests/test_packing.py``.

The same numpy inputs, made from a seed, go through the port — its copy of
``data/packing.py``, its segmented ⊕ algebra, the plain versions of the
segmented B1 and B2 (the CPU path of their wrappers), ``aaren_prefix_attention``
with ``segment_ids``, and the packed ``lm_loss`` — and through the JAX
package: its packer, its algebra, its Pallas kernels in interpret mode, its
dense oracle, its jnp ``ops`` path and ``jax.grad`` of its packed loss.
Bars: packing arrays bit-equal; the scan at ``rtol=atol=1e-4`` with ``m``
at ``rtol=1e-5`` (the JAX suite's bar for this kernel); gradients scaled by
max |reference| at 1e-4; packed loss within 1e-5 of JAX's and of
per-document evaluation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.base import ArchConfig as JArchConfig
from repro.core import scan_attention as jscan
from repro.data import packing as jpacking
from repro.kernels import ops as jops
from repro.kernels.aaren_scan import aaren_scan as _pallas_scan
from repro.kernels.aaren_scan_bwd import aaren_scan_bwd as _pallas_bwd
from repro.kernels.ref import (
    aaren_scan_segmented_reference as jax_segmented_reference,
)
from repro.models.factory import build as jax_build
from repro_torch.configs.base import ArchConfig
from repro_torch.core import scan_attention as tscan
from repro_torch.core.scan_attention import NEG_INF, ScanState
from repro_torch.data import packing
from repro_torch.kernels import ops
from repro_torch.kernels.aaren_scan import aaren_scan
from repro_torch.kernels.aaren_scan_bwd import aaren_scan_bwd
from repro_torch.kernels.ref import aaren_scan_segmented_reference
from repro_torch.models.convert import params_from_jax
from repro_torch.models.factory import build
from repro_torch.train.loop import LoopConfig, run_train_loop
from repro_torch.train.optim import make_optimizer, warmup_cosine
from repro_torch.train.state import init_train_state, make_train_step
from repro_torch.tree import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-4)
M_TOL = dict(rtol=1e-5)
# One jit per shape: eager JAX compiles every primitive of the scan anew.
jax_segmented_states = jax.jit(jscan.prefix_scan_states_segmented)
jax_reference = jax.jit(jax_segmented_reference)


def _np(t):
    return t.detach().float().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _grad_close(got, want, rtol=1e-4):
    """The JAX suite's gradient bar: both scaled by max |want|."""
    for a, b in zip(got, want):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32).reshape(a.shape)
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, rtol=rtol,
                                   atol=rtol)


# ---------------------------------------------------------------------------
# Packer + iterator: the port's copy against the JAX package's
# ---------------------------------------------------------------------------


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pack_documents_first_fit_layout():
    docs = [np.arange(1, 5), np.arange(5, 10), np.arange(10, 13),
            np.arange(13, 20)]                     # lengths 4, 5, 3, 7
    packed = packing.pack_documents(docs, seq_len=8)
    _assert_batches_equal(packed, jpacking.pack_documents(docs, seq_len=8))
    assert packed["tokens"].shape == (3, 8)
    assert packed["segment_ids"][0].tolist() == [1] * 4 + [2] * 3 + [0]
    assert packed["segment_ids"][1, :5].tolist() == [1] * 5
    assert packed["positions"][0, :7].tolist() == [0, 1, 2, 3, 0, 1, 2]
    assert packed["loss_mask"][0].tolist() == [1.0] * 7 + [0.0]


def test_pack_documents_roundtrip_and_errors():
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, 99, size=n) for n in (3, 9, 2, 7, 5, 8)]
    packed = packing.pack_documents(docs, seq_len=16)
    _assert_batches_equal(packed, jpacking.pack_documents(docs, seq_len=16))
    out = packing.unpack_documents(packed)
    key = lambda d: tuple(int(x) for x in d)  # noqa: E731
    assert sorted(map(key, out)) == sorted(map(key, docs))
    for bad, match in (([np.arange(20)], "exceeds seq_len"),
                       ([np.arange(0)], "empty")):
        with pytest.raises(ValueError, match=match):
            packing.pack_documents(bad, seq_len=16)
    with pytest.raises(ValueError, match="unknown packing strategy"):
        packing.pack_documents(docs, seq_len=16, strategy="worst_fit")


def test_packing_stats_accounting():
    lens = [512] + [96] * 12
    stats = packing.packing_stats(lens, seq_len=512, n_rows=4)
    assert stats == jpacking.packing_stats(lens, seq_len=512, n_rows=4)
    assert stats["real_tokens"] == 512 + 96 * 12
    assert stats["padded_token_ratio"] == pytest.approx(13 * 512 / 1664)


def test_best_fit_decreasing_contract():
    """BFD keeps every layout invariant (contiguous ids from 1, padding at
    the tail, positions restarting at 0, a lossless round trip), packs the
    ~4:1 skewed mix tighter than first-fit, and equals JAX bit for bit."""
    rng = np.random.default_rng(7)
    docs = [rng.integers(0, 99, size=n) for n in (3, 9, 2, 7, 5, 8, 4, 6)]
    packed = packing.pack_documents(docs, 16, strategy="best_fit_decreasing")
    _assert_batches_equal(packed, jpacking.pack_documents(
        docs, 16, strategy="best_fit_decreasing"))
    for row_seg, row_pos in zip(packed["segment_ids"], packed["positions"]):
        nz = row_seg[row_seg != 0]
        assert (np.diff(nz) >= 0).all() and (np.diff(nz) <= 1).all()
        assert nz[0] == 1 and (row_seg[len(nz):] == 0).all()
        first = np.flatnonzero(np.diff(np.concatenate([[0], row_seg])))
        assert all(row_pos[i] == 0 for i in first if row_seg[i])
    key = lambda d: tuple(int(x) for x in d)  # noqa: E731
    assert (sorted(map(key, packing.unpack_documents(packed)))
            == sorted(map(key, docs)))
    ff_rows = bfd_rows = real = 0
    for seed in range(4):
        rng = np.random.default_rng(seed)
        lens = (8 + 504 * rng.random(60) ** 3.0).astype(int)
        docs = [rng.integers(0, 99, size=int(n)) for n in lens]
        ff_rows += packing.pack_documents(docs, 512)["tokens"].shape[0]
        bfd_rows += packing.pack_documents(
            docs, 512, strategy="best_fit_decreasing")["tokens"].shape[0]
        real += int(lens.sum())
    assert bfd_rows < ff_rows
    assert 1.0 - real / (bfd_rows * 512) <= 0.05


def test_packed_iterator_matches_jax_and_shards_by_host():
    """Bit-equal to JAX's iterator; the union of host slices is the
    single-host batch; ``state``/``restore`` round-trip."""
    kw = dict(vocab=128, seq_len=64, batch=4, seed=7)
    single = packing.PackedLMIterator(**kw)
    jax_single = jpacking.PackedLMIterator(**kw)
    b0 = next(single)
    _assert_batches_equal(b0, next(jax_single))
    _assert_batches_equal(next(single), next(jax_single))
    hosts = [packing.PackedLMIterator(**kw, host_id=h, num_hosts=2)
             for h in (0, 1)]
    parts = [next(h) for h in hosts]
    _assert_batches_equal(
        b0, {k: np.concatenate([p[k] for p in parts]) for k in b0})
    resumed = packing.PackedLMIterator(**kw)
    resumed.restore(single.state())
    _assert_batches_equal(next(resumed), next(single))
    for row in b0["segment_ids"]:
        nz = np.flatnonzero(row)
        assert nz.size and row[nz].min() == 1 and (np.diff(nz) == 1).all()


# ---------------------------------------------------------------------------
# The segmented ⊕ algebra
# ---------------------------------------------------------------------------


def _flagged_states(seed, shape=(5,), d=3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape).astype(np.float32),
             np.log1p(np.exp(rng.standard_normal(shape))).astype(np.float32),
             rng.standard_normal(shape + (d,)).astype(np.float32),
             (rng.random(shape) > 0.5).astype(np.float32))
            for _ in range(3)]


def test_segmented_combine_associative_and_matches_jax():
    """The lifted (⊕, flag) operator is associative — what the Hillis–Steele
    scans rely on — and equals the JAX package's."""
    a, b, c = ([_t(x) for x in op] for op in _flagged_states(0))
    left = tscan.combine_segmented(tscan.combine_segmented(a, b), c)
    right = tscan.combine_segmented(a, tscan.combine_segmented(b, c))
    for x, y in zip(left, right):
        np.testing.assert_allclose(_np(x), _np(y), rtol=1e-5, atol=1e-5)
    ja, jb = ([jnp.asarray(x) for x in op] for op in _flagged_states(0)[:2])
    for x, y in zip(tscan.combine_segmented(a, b),
                    jscan.combine_segmented(ja, jb)):
        np.testing.assert_allclose(_np(x), np.asarray(y), rtol=1e-6,
                                   atol=1e-6)


def test_segment_starts_and_segmented_prefix_states_match_jax():
    seg = np.array([[1, 1, 2, 2, 2, 3, 0, 0], [0, 0, 0, 0, 0, 0, 0, 0],
                    [1, 2, 3, 4, 5, 6, 7, 8]], np.int32)
    starts = tscan.segment_starts_from_ids(_t(seg))
    want = np.asarray(jscan.segment_starts_from_ids(jnp.asarray(seg)))
    np.testing.assert_array_equal(starts.numpy(), want)
    assert not starts[:, 0].any()      # token 0 never resets the carry-in
    rng = np.random.default_rng(1)
    s = (rng.standard_normal((3, 8)) * 3).astype(np.float32)
    v = rng.standard_normal((3, 8, 4)).astype(np.float32)
    states, seen = tscan.prefix_scan_states_segmented(_t(s), _t(v), starts)
    jstates, jseen = jax_segmented_states(
        jnp.asarray(s), jnp.asarray(v), jnp.asarray(want))
    np.testing.assert_array_equal(seen.numpy(), np.asarray(jseen))
    np.testing.assert_allclose(_np(states.m), np.asarray(jstates.m), **M_TOL)
    np.testing.assert_allclose(_np(states.u), np.asarray(jstates.u), **TOL)
    np.testing.assert_allclose(_np(states.w), np.asarray(jstates.w), **TOL)


# ---------------------------------------------------------------------------
# Segmented B1 and B2: plain versions against interpret-mode Pallas
# ---------------------------------------------------------------------------


def _segmented_case(name, seed=0):
    """(s, v, m0, u0, w0, starts) numpy inputs of one named edge case."""
    r, n, d, carry, spread = 4, 23, 8, False, 3.0
    rng = np.random.default_rng(seed)
    starts = np.zeros((r, n), bool)
    pad = np.zeros((r, n), bool)
    if name == "docs+padding tail":
        starts[:, [7, 15]] = True
        pad[:, 20:] = True
    elif name == "flag at token 0 with carry":
        carry = True
        starts[:, [0, 9]] = True
    elif name == "carry, no flags":
        carry = True
    elif name == "every token flagged, carry":
        carry = True
        starts[:] = True
    elif name == "single-token docs, all-padding row":
        starts[:, [3, 4, 5, 11]] = True
        starts[2] = False
        pad[2] = True
        pad[:, 18:] = True
    elif name == "N % 32 != 0, random flags, carry":
        r, n, carry = 3, 70, True
        starts = rng.random((r, n)) < 0.1
        pad = np.zeros((r, n), bool)
        pad[1, 50:] = True
        starts &= ~pad
    elif name == "extreme scores (+-80)":
        spread = 80.0
        starts[:, [5, 6, 17]] = True
    else:
        raise KeyError(name)
    s = (rng.standard_normal((r, n)) * spread).astype(np.float32)
    v = rng.standard_normal((r, n, d)).astype(np.float32)
    s[pad] = NEG_INF
    v[pad] = 0.0
    if carry:
        m0 = (rng.standard_normal((r, 1)) * 2).astype(np.float32)
        u0 = rng.uniform(0.5, 3.0, (r, 1)).astype(np.float32)
        w0 = (rng.standard_normal((r, d)) * u0).astype(np.float32)
    else:
        m0 = np.full((r, 1), NEG_INF, np.float32)
        u0 = np.zeros((r, 1), np.float32)
        w0 = np.zeros((r, d), np.float32)
    return s, v, m0, u0, w0, starts


SEG_CASES = ["docs+padding tail", "flag at token 0 with carry",
             "carry, no flags", "every token flagged, carry",
             "single-token docs, all-padding row",
             "N % 32 != 0, random flags, carry", "extreme scores (+-80)"]


def _pallas_fwd(args, starts):
    return _pallas_scan(*(jnp.asarray(a) for a in args),
                        jnp.asarray(starts, jnp.float32),
                        return_residuals=True, interpret=True)


@pytest.mark.parametrize("case", SEG_CASES)
def test_segmented_scan_matches_pallas(case):
    """Plain segmented B1 (with residuals) == interpret-mode Pallas B1 with
    ``segment_starts``; all-zero flags == no flags, bit for bit."""
    *args, starts = _segmented_case(case, seed=SEG_CASES.index(case))
    got = aaren_scan(*(_t(a) for a in args), segment_starts=_t(starts),
                     return_residuals=True)
    want = _pallas_fwd(args, starts)
    for i, (a, b) in enumerate(zip(got, want)):
        tol = M_TOL if i in (1, 4) else TOL       # m_f and m_all
        np.testing.assert_allclose(_np(a), np.asarray(b), **tol)
    assert all(np.isfinite(_np(t)).all() for t in got)
    zero = torch.zeros(starts.shape, dtype=torch.bool)
    plain = aaren_scan(*(_t(a) for a in args), return_residuals=True)
    unflagged = aaren_scan(*(_t(a) for a in args), segment_starts=zero,
                           return_residuals=True)
    for a, b in zip(plain, unflagged):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=0)


@pytest.mark.parametrize("case", SEG_CASES)
def test_segmented_bwd_matches_pallas(case):
    """Plain segmented B2 == interpret-mode Pallas B2 with
    ``segment_ends`` (the starts shifted left one), on the JAX forward's
    residuals and numpy cotangents."""
    *args, starts = _segmented_case(case, seed=SEG_CASES.index(case))
    o, m_f, _, _, m_all, u_all = (np.asarray(x)
                                  for x in _pallas_fwd(args, starts))
    r, n, d = args[1].shape
    rng = np.random.default_rng(90)
    g_o = rng.standard_normal((r, n, d)).astype(np.float32)
    g_u = rng.standard_normal((r, 1)).astype(np.float32)
    g_w = rng.standard_normal((r, d)).astype(np.float32)
    ends = np.pad(starts[:, 1:], ((0, 0), (0, 1)))
    bwd = (args[0], args[1], o, m_all, u_all, g_o, -m_f, g_w, -g_u)
    got = aaren_scan_bwd(*(_t(a) for a in bwd), segment_ends=_t(ends))
    want = _pallas_bwd(*(jnp.asarray(a) for a in bwd),
                       jnp.asarray(ends, jnp.float32), interpret=True)
    _grad_close([_np(t) for t in got], want)
    np.testing.assert_array_equal(
        _np(ops._segment_ends(_t(starts))), ends)


# ---------------------------------------------------------------------------
# The kernel boundary with segment_ids: oracle, jnp ops, gradients, carry
# ---------------------------------------------------------------------------


def _segments(r, n, spans):
    seg = np.zeros((r, n), np.int32)
    for sid, (a, b) in enumerate(spans, start=1):
        seg[:, a:b] = sid
    return seg


SPANS = [(0, 7), (7, 15), (15, 20)]   # ragged docs + padded tail (N = 23)


def _scores_values(r, n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((r, n)).astype(np.float32),
            rng.standard_normal((r, n, d)).astype(np.float32))


def test_ops_segment_ids_match_oracles_and_jax():
    """aaren_prefix_attention(segment_ids=) == the port's dense oracle ==
    the JAX oracle == JAX's jnp ops, outputs and finals; padding reads 0;
    (B, N) ids broadcast over (B, H, N) scores."""
    r, n, d = 3, 23, 5
    s, v = _scores_values(r, n, d, seed=0)
    seg = _segments(r, n, SPANS)
    o, fin = ops.aaren_prefix_attention(_t(s), _t(v), segment_ids=_t(seg))
    wants = [
        [_np(x) for x in aaren_scan_segmented_reference(_t(s), _t(v),
                                                        _t(seg))],
        [np.asarray(x) for x in jax_reference(
            jnp.asarray(s), jnp.asarray(v), jnp.asarray(seg))]]
    jo, jfin = jax.jit(jops.aaren_prefix_attention)(
        jnp.asarray(s), jnp.asarray(v), segment_ids=jnp.asarray(seg))
    wants.append([np.asarray(jo), np.asarray(jfin.m)[:, None],
                  np.asarray(jfin.u)[:, None], np.asarray(jfin.w)])
    for want in wants:
        np.testing.assert_allclose(_np(o), want[0], **TOL)
        np.testing.assert_allclose(_np(fin.m)[:, None], want[1], **M_TOL)
        np.testing.assert_allclose(_np(fin.u)[:, None], want[2], **TOL)
        np.testing.assert_allclose(_np(fin.w), want[3], **TOL)
    assert not _np(o)[:, 20:].any()
    ob, finb = ops.aaren_prefix_attention(
        _t(np.stack([s, s])), _t(np.stack([v, v])), segment_ids=_t(seg[:2]))
    np.testing.assert_array_equal(_np(ob[1]), _np(o))
    np.testing.assert_array_equal(_np(finb.w[0]), _np(fin.w))


def _port_seg_grads(s, v, seg, spans):
    st, vt = _t(s).requires_grad_(True), _t(v).requires_grad_(True)
    o, fin = ops.aaren_prefix_attention(st, vt, segment_ids=_t(seg))
    loss = o.sin().sum() + 0.3 * fin.w.sum() + 0.7 * fin.u.sum()
    return torch.autograd.grad(loss, (st, vt))


def test_segmented_grads_match_per_doc_and_jax():
    """Packed-scan cotangents == each document differentiated on its own,
    the final-carry cotangents reaching only the last document; == jax.grad
    of JAX's packed ops; padding gets no gradient."""
    r, n, d = 3, 23, 5
    s, v = _scores_values(r, n, d, seed=1)
    seg = _segments(r, n, SPANS)
    gs, gv = _port_seg_grads(s, v, seg, SPANS)
    gs_ref = np.zeros((r, n), np.float32)
    gv_ref = np.zeros((r, n, d), np.float32)
    for a, b in SPANS:
        st = _t(s[:, a:b]).requires_grad_(True)
        vt = _t(v[:, a:b]).requires_grad_(True)
        o, fin = ops.aaren_prefix_attention(st, vt)
        loss = o.sin().sum()
        if (a, b) == SPANS[-1]:
            loss = loss + 0.3 * fin.w.sum() + 0.7 * fin.u.sum()
        g1, g2 = torch.autograd.grad(loss, (st, vt))
        gs_ref[:, a:b], gv_ref[:, a:b] = _np(g1), _np(g2)
    _grad_close([_np(gs), _np(gv)], [gs_ref, gv_ref])

    def packed(s_, v_):
        o, fin = jops.aaren_prefix_attention(s_, v_,
                                             segment_ids=jnp.asarray(seg))
        return (jnp.sum(jnp.sin(o)) + 0.3 * jnp.sum(fin.w)
                + 0.7 * jnp.sum(fin.u))

    _grad_close([_np(gs), _np(gv)], jax.jit(jax.grad(packed, argnums=(0, 1)))(
        jnp.asarray(s), jnp.asarray(v)))
    assert not _np(gs)[:, 20:].any() and not _np(gv)[:, 20:].any()


def test_segmented_scan_composes_with_carry():
    """An incoming carry reaches exactly the first document, forward and
    backward (its cotangents come from the first document alone)."""
    r, n, d = 2, 16, 4
    s, v = _scores_values(r, n, d, seed=2)
    seg = _segments(r, n, [(0, 6), (6, 16)])
    rng = np.random.default_rng(3)
    carry_np = ((rng.standard_normal(r) * 0.5).astype(np.float32),
                rng.uniform(0.5, 2.0, r).astype(np.float32),
                rng.standard_normal((r, d)).astype(np.float32))

    def run(s_, v_, seg_=None):
        carry = ScanState(*(_t(x).requires_grad_(True) for x in carry_np))
        o, _ = ops.aaren_prefix_attention(
            _t(s_), _t(v_), carry,
            segment_ids=None if seg_ is None else _t(seg_))
        return o, torch.autograd.grad(o.sin().sum(), carry)

    o, g_carry = run(s, v, seg)
    o1, g_carry1 = run(s[:, :6], v[:, :6])
    o2, _ = ops.aaren_prefix_attention(_t(s[:, 6:]), _t(v[:, 6:]))
    np.testing.assert_allclose(_np(o[:, :6]), _np(o1), **TOL)
    np.testing.assert_allclose(_np(o[:, 6:]), _np(o2), **TOL)
    _grad_close([_np(g) for g in g_carry], [_np(g) for g in g_carry1])
    jo, _ = jax.jit(jops.aaren_prefix_attention)(
        jnp.asarray(s), jnp.asarray(v),
        jscan.ScanState(*(jnp.asarray(x) for x in carry_np)),
        segment_ids=jnp.asarray(seg))
    np.testing.assert_allclose(_np(o), np.asarray(jo), **TOL)


@settings(max_examples=10, deadline=None, derandomize=True, database=None)
@given(lens=st.lists(st.integers(min_value=1, max_value=12), min_size=1,
                     max_size=5),
       pad=st.integers(min_value=0, max_value=4))
def test_segmented_scan_property(lens, pad):
    """Any contiguous segment layout: the port's segmented scan == its dense
    oracle (held to the JAX oracle above)."""
    seg = np.concatenate([np.full(n, i + 1, np.int32)
                          for i, n in enumerate(lens)]
                         + [np.zeros(pad, np.int32)])[None].repeat(2, 0)
    s, v = _scores_values(2, seg.shape[1], 3, seed=sum(lens) + pad)
    o, fin = ops.aaren_prefix_attention(_t(s), _t(v), segment_ids=_t(seg))
    want = [_np(x) for x in aaren_scan_segmented_reference(
        _t(s), _t(v), _t(seg))]
    np.testing.assert_allclose(_np(o), want[0], **TOL)
    np.testing.assert_allclose(_np(fin.m)[:, None], want[1], **M_TOL)
    np.testing.assert_allclose(_np(fin.u)[:, None], want[2], **TOL)
    np.testing.assert_allclose(_np(fin.w), want[3], **TOL)


# ---------------------------------------------------------------------------
# Packed LM loss and gradients
# ---------------------------------------------------------------------------


def _lm_cfgs(remat):
    kw = dict(name=f"pack-aaren-{remat}", family="dense", n_layers=2,
              d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
              pattern=("attn",), mlp_pattern=("swiglu",), attn_mode="aaren",
              param_dtype="float32", compute_dtype="float32", remat=remat)
    return JArchConfig(**kw), ArchConfig(**kw)


@pytest.fixture(scope="module", params=["none", "block"])
def packed_model(request):
    jcfg, cfg = _lm_cfgs(request.param)
    japi = jax_build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    return japi, jparams, build(cfg), cfg


def _docs(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _loss_and_grads(api, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = api.loss(params, {k: _t(v) for k, v in batch.items()})
    return loss, metrics, torch.autograd.grad(loss, leaves)


def _per_doc_reference(api, params, docs):
    """Token-weighted mean loss and gradients of exact-length per-document
    runs: no mask and no packing on this side.  One-token documents have no
    next-token target and drop out."""
    leaves = tree_leaves(params)
    tot, cnt, g_sum = 0.0, 0, [torch.zeros_like(p) for p in leaves]
    for d in docs:
        if len(d) < 2:
            continue
        loss, _, grads = _loss_and_grads(api, params, {"tokens": d[None]})
        k = len(d) - 1
        tot += loss.item() * k
        cnt += k
        g_sum = [a + b * k for a, b in zip(g_sum, grads)]
    return tot / cnt, [g / cnt for g in g_sum]


def test_packed_lm_loss_and_grads_match_jax_and_per_doc(packed_model):
    """Packed loss and every gradient == the JAX package's packed loss
    (remat none and block), and == per-document evaluation (the oracle
    with no masking machinery)."""
    japi, jparams, api, cfg = packed_model
    docs = _docs(cfg.vocab, [30, 12, 9, 6, 20, 5], seed=3)
    batch = packing.pack_documents(docs, 48)
    assert batch["tokens"].shape[0] < len(docs)        # actually packed
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    loss, metrics, grads = _loss_and_grads(api, params, batch)
    assert abs(loss.item() - float(jloss)) <= 1e-5
    assert metrics["loss"].item() == loss.item()
    jleaves = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg, "cpu")
    _grad_close([_np(g) for g in grads],
                [_np(g) for g in tree_leaves(jleaves)])
    ref_loss, ref_grads = _per_doc_reference(api, params, docs)
    assert abs(loss.item() - ref_loss) <= 1e-5
    _grad_close([_np(g) for g in grads], [_np(g) for g in ref_grads])


def test_single_token_docs_contribute_nothing(packed_model):
    """A one-token document has no next-token target: packing it beside
    the others leaves the loss at the per-document value."""
    _, jparams, api, cfg = packed_model
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    base = _docs(cfg.vocab, [9, 13], seed=0)
    single = base + _docs(cfg.vocab, [1], seed=1)
    ref_loss, _ = _per_doc_reference(api, params, base)
    with torch.no_grad():
        for docs in (base, single):
            batch = {k: _t(v) for k, v in
                     packing.pack_documents(docs, 32).items()}
            assert abs(api.loss(params, batch)[0].item() - ref_loss) <= 2e-5


def test_pack_sequences_trains_and_requires_segment_ids():
    """run_train_loop(pack_sequences=True) on PackedLMIterator batches logs
    each step's token utilisation; a batch without segment_ids raises."""
    _, cfg = _lm_cfgs("block")
    api = build(cfg)
    opt = make_optimizer("adamw", warmup_cosine(1e-3, 1, 3))
    state = init_train_state(api.init(0, device="cpu"), opt)
    kw = dict(vocab=cfg.vocab, seq_len=32, batch=2, seed=0, min_doc=2,
              max_doc=20)
    twin = packing.PackedLMIterator(**kw)
    want = [float((next(twin)["segment_ids"] != 0).mean()) for _ in range(3)]
    res = run_train_loop(make_train_step(api.loss, opt), state,
                         packing.PackedLMIterator(**kw),
                         LoopConfig(total_steps=3, log_every=1,
                                    pack_sequences=True))
    assert [m["token_util"] for _, m in res.history] == want
    assert all(np.isfinite(m["loss"]) for _, m in res.history)
    with pytest.raises(ValueError, match="segment_ids"):
        run_train_loop(None, init_train_state(api.init(0, device="cpu"),
                                              opt),
                       iter([{"tokens": np.zeros((1, 4), np.int32)}]),
                       LoopConfig(total_steps=1, pack_sequences=True))
