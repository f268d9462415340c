"""Sequence packing on softmax layers in the port (``repro_torch``) against
the JAX package: the softmax half of ``tests/test_packing.py``.

The same numpy inputs, made from a seed, go through the port — its
``segment_positions``, its dense masked softmax with segment ids, the
plain versions of the segmented B3, B4 and B5 (the CPU path of their
wrappers), ``flash_mha`` with segment ids, the packed softmax ``lm_loss``
and ``run_train_loop(pack_sequences=True)`` — and through the JAX package:
its ``segment_positions``, its mask builder and ``multihead_attention``,
its dense oracles ``ref.flash_reference``/``flash_vjp_reference``, its
Pallas kernels in interpret mode, its ``flash_mha`` and ``jax.grad`` of
its packed loss.  Parameters are the JAX package's, carried across with
``models/convert.py``.

Bars, the JAX suite's own: segment positions and masks exact; forward
``rtol=atol=2e-5`` in f32 and ``2e-2`` in bf16 against the oracles
(tests/test_torch_flash.py), gradients ``|port - ref| <= 1e-4 * max|ref|
+ 1e-6`` in f32 and ``2e-2`` scaled in bf16; against per-document runs
1e-5 in f32 and ``3e-2`` in bf16 (tests/test_packing.py); packed loss
within 1e-5 of JAX's and of per-document evaluation in f32, gradients
1e-4 of max |ref|; in bf16 the loss within ``5e-2`` and the gradients
within ``8e-2`` (tests/test_packing.py::test_packed_lm_parity).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.base import ArchConfig as JArchConfig
from repro.core import rope as jrope
from repro.core import softmax_attention as jsoft
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.flash_attention import (
    flash_attention_bwd as pallas_flash_bwd,
)
from repro.kernels.ops import flash_mha as jax_flash_mha
from repro.kernels.ref import flash_reference as _jax_flash_reference
from repro.kernels.ref import flash_vjp_reference as _jax_flash_vjp_reference
from repro.models.factory import build as jax_build
from repro_torch.configs.base import ArchConfig
from repro_torch.core import rope
from repro_torch.core import softmax_attention as soft
from repro_torch.core.scan_attention import NEG_INF
from repro_torch.data import packing
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels.ops import flash_mha
from repro_torch.models.convert import params_from_jax
from repro_torch.models.factory import build
from repro_torch.train.loop import LoopConfig, run_train_loop
from repro_torch.train.optim import make_optimizer, warmup_cosine
from repro_torch.train.state import init_train_state, make_train_step
from repro_torch.tree import tree_leaves

_STATIC = ("causal", "window", "scale")
jax_flash_reference = jax.jit(_jax_flash_reference, static_argnames=_STATIC)
jax_flash_vjp_reference = jax.jit(_jax_flash_vjp_reference,
                                  static_argnames=_STATIC)
FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DOC_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(getattr(torch, dtype))


def _j(a, dtype=None):
    a = jnp.asarray(a)
    return a if dtype is None else a.astype(getattr(jnp, dtype))


def _f32(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x)
                      else jnp.asarray(x, jnp.float32))


def _grad_close(got, want, rtol=1e-4, floor=1e-6):
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        a, b = _f32(a), _f32(b)
        bar = rtol * np.abs(b).max() + floor
        err = np.abs(a - b).max()
        assert err <= bar, f"{name}: max |port - ref| {err:.3e} > {bar:.3e}"


def _slug(label):
    return re.sub(r"[^a-z0-9]+", "-", label.lower()).strip("-")


def _ids(b, n, spans_per_row):
    """(b, n) int32 ids: row ``r`` holds ``spans_per_row[r]``, a list of
    (id, start, stop); everything else is padding (0)."""
    seg = np.zeros((b, n), np.int32)
    for r, spans in enumerate(spans_per_row):
        for sid, a, c in spans:
            seg[r, a:c] = sid
    return seg


# ---------------------------------------------------------------------------
# segment_positions and the dense masked softmax
# ---------------------------------------------------------------------------

POSITION_LAYOUTS = {
    "packed, padding tail": _ids(2, 12, [[(1, 0, 5), (2, 5, 9)],
                                         [(1, 0, 1), (2, 1, 2), (3, 2, 12)]]),
    "reused, non-monotone": _ids(1, 10, [[(3, 0, 2), (1, 2, 5), (3, 5, 7),
                                          (3, 7, 8), (2, 8, 10)]]),
    "all padding and leading padding": _ids(2, 6, [[], [(4, 3, 6)]]),
}


@pytest.mark.parametrize("name", sorted(POSITION_LAYOUTS),
                         ids=[_slug(k) for k in sorted(POSITION_LAYOUTS)])
def test_segment_positions_match_jax(name):
    seg = POSITION_LAYOUTS[name]
    got = rope.segment_positions(_t(seg))
    want = np.asarray(jrope.segment_positions(_j(seg)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # Any leading batch shape, as JAX's.
    three_d = np.stack([seg, seg[:, ::-1].copy()], axis=1)
    np.testing.assert_array_equal(
        rope.segment_positions(_t(three_d)).numpy(),
        np.asarray(jrope.segment_positions(_j(three_d))))


@pytest.mark.parametrize("sides", ["both", "q only", "kv only"],
                         ids=["both", "q-only", "kv-only"])
def test_attention_mask_with_segments_matches_jax(sides):
    seg = POSITION_LAYOUTS["packed, padding tail"]
    lens = np.asarray([10, 7], np.int32)
    q_ids = seg if sides != "kv only" else None
    kv_ids = seg if sides != "q only" else None
    kw = dict(causal=True, window=4)
    got = soft.attention_mask(
        12, 12, q_lens=_t(lens), kv_lens=_t(lens),
        q_segment_ids=None if q_ids is None else _t(q_ids),
        kv_segment_ids=None if kv_ids is None else _t(kv_ids), **kw)
    want = jsoft.attention_mask(
        12, 12, q_lens=_j(lens), kv_lens=_j(lens),
        q_segment_ids=None if q_ids is None else _j(q_ids),
        kv_segment_ids=None if kv_ids is None else _j(kv_ids), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window", [None, 3])
def test_multihead_attention_with_segments_matches_jax(window):
    b, n, h, g, d = 2, 12, 4, 2, 8
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, n, h, d), (b, n, g, d), (b, n, g, d)))
    seg = POSITION_LAYOUTS["packed, padding tail"]
    got = soft.multihead_attention(_t(q), _t(k), _t(v), window=window,
                                   segment_ids=_t(seg))
    want = jsoft.multihead_attention(_j(q), _j(k), _j(v), window=window,
                                     segment_ids=_j(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert not got[0, 9:].any()          # padding reads 0


# ---------------------------------------------------------------------------
# The segmented plain versions of B3–B5 against the JAX oracles
# ---------------------------------------------------------------------------

# label, (B, H, G, N, d), dtype, window, lengths, spans per row
SEG_CASES = [
    ("packed rows, padding tail, a straddle of 64", (2, 4, 4, 97, 16),
     "float32", None, None,
     [[(1, 0, 3), (2, 3, 70), (3, 70, 90)], [(1, 0, 97)]]),
    ("single-token docs, an all-padding row", (2, 2, 2, 9, 8), "float32",
     None, None, [[(i + 1, i, i + 1) for i in range(9)], []]),
    ("reused non-monotone ids, lengths", (2, 4, 2, 40, 8), "float32", None,
     (33, 40), [[(2, 0, 10), (1, 10, 20), (2, 20, 30), (5, 30, 40)],
                [(7, 0, 5), (3, 5, 40)]]),
    ("window, GQA 4:1", (1, 4, 1, 50, 8), "float32", 6, None,
     [[(1, 0, 17), (2, 17, 50)]]),
    ("bf16, N = 1", (2, 2, 2, 1, 8), "bfloat16", None, None, [[(1, 0, 1)],
                                                              []]),
    ("bf16, packed, window", (2, 4, 2, 30, 16), "bfloat16", 5, None,
     [[(1, 0, 12), (2, 12, 25)], [(1, 0, 30)]]),
]


def _case_inputs(case, seed):
    _, (b, h, g, n, d), dtype, window, lens, spans = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((b, h, n, d), (b, g, n, d), (b, g, n, d), (b, h, n, d)))
    lens = None if lens is None else np.asarray(lens, np.int32)
    return q, k, v, do, _ids(b, n, spans), window, lens, dtype


@pytest.mark.parametrize("i", range(len(SEG_CASES)),
                         ids=[_slug(c[0]) for c in SEG_CASES])
def test_segmented_plain_versions_match_jax_oracles(i):
    q, k, v, do, seg, window, lens, dtype = _case_inputs(SEG_CASES[i], 70 + i)
    masks = dict(causal=True, window=window)
    t_lens = None if lens is None else _t(lens)
    j_lens = None if lens is None else _j(lens)
    tq, tk, tv, tdo = (_t(x, dtype) for x in (q, k, v, do))
    o, lse = fa.flash_attention(tq, tk, tv, q_lens=t_lens, kv_lens=t_lens,
                                q_segment_ids=_t(seg), kv_segment_ids=_t(seg),
                                return_residuals=True, **masks)
    assert o.dtype == tq.dtype
    jargs = [_j(x, dtype) for x in (q, k, v)]
    jkw = dict(q_lens=j_lens, kv_lens=j_lens, q_segment_ids=_j(seg),
               kv_segment_ids=_j(seg), **masks)
    want = jax_flash_reference(*jargs, **jkw)
    tol = FWD_TOL[dtype]
    np.testing.assert_allclose(_f32(o), _f32(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        _f32(ref.flash_reference(tq, tk, tv, q_lens=t_lens, kv_lens=t_lens,
                                 q_segment_ids=_t(seg),
                                 kv_segment_ids=_t(seg), **masks)),
        _f32(o), rtol=0, atol=0)
    got = fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, q_lens=t_lens,
                                 kv_lens=t_lens, q_segment_ids=_t(seg),
                                 kv_segment_ids=_t(seg), **masks)
    _grad_close(got, jax_flash_vjp_reference(*jargs, _j(do, dtype), **jkw),
                rtol=GRAD_TOL[dtype])
    # Padding queries read o = 0 with lse = NEG_INF and get dq = 0;
    # padding keys get dk = dv = 0, exactly.
    pad = torch.from_numpy(seg == 0)
    assert not o.float().permute(0, 2, 1, 3)[pad].any()
    assert (lse.permute(0, 2, 1)[pad] == NEG_INF).all()
    assert not got[0].float().permute(0, 2, 1, 3)[pad].any()
    for dkv in got[1:]:
        assert not dkv.float().permute(0, 2, 1, 3)[pad].any()


@pytest.mark.parametrize("shape", [(2, 4, 2, 97, 16), (1, 2, 1, 150, 8)])
def test_segmented_plain_versions_match_pallas_interpret(shape):
    """Against the Pallas kernels' has_segments branch itself, with 64-row
    tiles, so that documents straddle tiles and whole tiles are skipped."""
    b, h, g, n, d = shape
    rng = np.random.default_rng(n)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((b, h, n, d), (b, g, n, d), (b, g, n, d), (b, h, n, d)))
    # Packed rows with a padding tail, and reused, non-monotone ids.
    seg = _ids(b, n, [[(1, 0, 40), (2, 40, 77), (3, 77, n - 7)],
                      [(4, 0, 20), (1, 20, 90), (4, 90, n)]][:b])
    window = 48 if n > 100 else None
    tkw = dict(window=window, q_segment_ids=_t(seg), kv_segment_ids=_t(seg))
    o, lse = fa.flash_attention(_t(q), _t(k), _t(v), return_residuals=True,
                                **tkw)
    jkw = dict(window=window, q_segment_ids=_j(seg), kv_segment_ids=_j(seg),
               block_q=64, block_k=64, interpret=True)
    jo, jlse = pallas_flash(_j(q), _j(k), _j(v), return_residuals=True,
                            **jkw)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=2e-5,
                               atol=2e-5)
    want = pallas_flash_bwd(_j(q), _j(k), _j(v), jo, jlse, _j(do), **jkw)
    got = fa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(jo), _t(jlse),
                                 _t(do), **tkw)
    _grad_close(got, want)


# ---------------------------------------------------------------------------
# flash_mha with segment ids: each document as if run alone
# ---------------------------------------------------------------------------

SPANS = [(0, 7), (7, 15), (15, 20)]   # ragged docs and a padded tail, N = 23


def _mha_inputs(dtype, seed=0):
    b, n, h, g, d = 2, 23, 4, 2, 8
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, n, h, d), (b, n, g, d), (b, n, g, d)))
    seg = _ids(b, n, [[(i + 1, a, c) for i, (a, c) in enumerate(SPANS)]] * b)
    return [_t(x, dtype) for x in (q, k, v)], seg, (q, k, v)


def _cos_loss_grads(q, k, v, **kw):
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = flash_mha(q, k, v, causal=True, **kw)
    return out, torch.autograd.grad(torch.cos(out.float()).sum(), (q, k, v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 9])
def test_flash_mha_segments_match_per_doc_and_jax(dtype, window):
    """The mirror of tests/test_packing.py::test_segmented_flash_matches_
    per_doc: packed flash == each document run unpacked, forward and every
    cotangent; padding reads 0; and the same as JAX's flash_mha."""
    (q, k, v), seg, np_qkv = _mha_inputs(dtype)
    tol = DOC_TOL[dtype]
    o, (gq, gk, gv) = _cos_loss_grads(q, k, v, window=window,
                                      q_segment_ids=_t(seg))
    assert o.dtype == q.dtype
    np.testing.assert_allclose(_f32(o[:, 20:]), 0.0, atol=tol)
    for a, c in SPANS:
        o_doc, grads = _cos_loss_grads(q[:, a:c], k[:, a:c], v[:, a:c],
                                       window=window)
        np.testing.assert_allclose(_f32(o[:, a:c]), _f32(o_doc), atol=tol,
                                   rtol=tol, err_msg=f"fwd doc [{a},{c})")
        for got, want, nm in zip((gq, gk, gv), grads, ("dq", "dk", "dv")):
            np.testing.assert_allclose(_f32(got[:, a:c]), _f32(want),
                                       atol=tol, rtol=tol,
                                       err_msg=f"{nm} doc [{a},{c})")

    def jax_loss(q_, k_, v_):
        out = jax_flash_mha(q_, k_, v_, causal=True, window=window,
                            q_segment_ids=_j(seg))
        return jnp.sum(jnp.cos(out.astype(jnp.float32))), out

    jqkv = [_j(x, dtype) for x in np_qkv]
    (_, jo), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                         has_aux=True)(*jqkv)
    np.testing.assert_allclose(_f32(o), _f32(jo), rtol=FWD_TOL[dtype],
                               atol=FWD_TOL[dtype])
    _grad_close((gq, gk, gv), jgrads, rtol=GRAD_TOL[dtype])


def test_flash_mha_one_side_stands_for_both():
    (q, k, v), seg, _ = _mha_inputs("float32", seed=1)
    both = flash_mha(q, k, v, q_segment_ids=_t(seg), kv_segment_ids=_t(seg))
    assert torch.equal(flash_mha(q, k, v, q_segment_ids=_t(seg)), both)
    # Any integer dtype is taken, as JAX's asarray(int32) takes it.
    assert torch.equal(flash_mha(q, k, v, kv_segment_ids=_t(seg).long()),
                       both)


@settings(max_examples=8, deadline=None, derandomize=True, database=None)
@given(lens=st.lists(st.integers(min_value=1, max_value=12), min_size=1,
                     max_size=5),
       pad=st.integers(min_value=0, max_value=4))
def test_flash_mha_segments_property(lens, pad):
    """Any contiguous document layout: packed flash_mha == each document
    run alone (f32), and padding reads 0."""
    n = sum(lens) + pad
    rng = np.random.default_rng(n)
    q, k, v = (_t(rng.standard_normal((1, n, 2, 8)).astype(np.float32))
               for _ in range(3))
    starts = np.cumsum([0] + lens)
    seg = _ids(1, n, [[(i + 1, a, c) for i, (a, c)
                       in enumerate(zip(starts[:-1], starts[1:]))]])
    o = flash_mha(q, k, v, q_segment_ids=_t(seg))
    assert not o[:, starts[-1]:].any()
    for a, c in zip(starts[:-1], starts[1:]):
        np.testing.assert_allclose(
            o[:, a:c].numpy(), flash_mha(q[:, a:c], k[:, a:c],
                                         v[:, a:c]).numpy(),
            rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The packed softmax LM: loss, gradients and the training loop
# ---------------------------------------------------------------------------


def _lm_cfgs(dtype, remat="none"):
    kw = dict(name=f"pack-softmax-{dtype}", family="dense", n_layers=2,
              d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
              pattern=("attn",), mlp_pattern=("swiglu",),
              attn_mode="softmax", param_dtype="float32",
              compute_dtype=dtype, remat=remat)
    return JArchConfig(**kw), ArchConfig(**kw)


def _docs(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _loss_and_grads(api, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = api.loss(params, {k: _t(v) for k, v in batch.items()})
    return loss, torch.autograd.grad(loss, leaves)


def _per_doc_reference(api, params, docs):
    """Token-weighted mean loss and gradients of exact-length per-document
    runs: no mask and no packing on this side.  One-token documents have
    no next-token target and drop out."""
    leaves = tree_leaves(params)
    tot, cnt, g_sum = 0.0, 0, [torch.zeros_like(p) for p in leaves]
    for d in docs:
        if len(d) < 2:
            continue
        loss, grads = _loss_and_grads(api, params, {"tokens": d[None]})
        k = len(d) - 1
        tot += loss.item() * k
        cnt += k
        g_sum = [a + b * k for a, b in zip(g_sum, grads)]
    return tot / cnt, [g / cnt for g in g_sum]


def _scaled_err(got, want):
    return max(np.abs(_f32(a) - _f32(b)).max() / max(np.abs(_f32(b)).max(),
                                                     1e-6)
               for a, b in zip(got, want))


def _abs_err(got, want):
    return max(np.abs(_f32(a) - _f32(b)).max() for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_softmax_lm_matches_jax_and_per_doc(dtype):
    """The mirror of tests/test_packing.py::test_packed_lm_parity[softmax]:
    the packed loss and every gradient == the JAX package's packed loss,
    and == per-document evaluation.  Rows of 96 hold a 70-token document
    and a 50 + 33 pair, so documents straddle the CUDA kernels' 64-row
    tiles; a one-token document rides along."""
    jcfg, cfg = _lm_cfgs(dtype)
    japi = jax_build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    api = build(cfg)
    docs = _docs(cfg.vocab, [70, 20, 50, 33, 9, 1, 40], seed=3)
    batch = packing.pack_documents(docs, 96)
    assert batch["tokens"].shape[0] < len(docs)        # actually packed
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    loss, grads = _loss_and_grads(api, params, batch)
    jleaves = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jgrads),
                                          cfg, "cpu"))
    ref_loss, ref_grads = _per_doc_reference(api, params, docs)
    if dtype == "float32":
        assert abs(loss.item() - float(jloss)) <= 1e-5
        assert _scaled_err(grads, jleaves) <= 1e-4
        assert abs(loss.item() - ref_loss) <= 1e-5
        assert _scaled_err(grads, ref_grads) <= 1e-4
    else:
        assert abs(loss.item() - float(jloss)) <= 5e-2
        assert _abs_err(grads, jleaves) <= 8e-2
        assert abs(loss.item() - ref_loss) <= 5e-2
        assert _abs_err(grads, ref_grads) <= 8e-2


def test_pack_sequences_trains_softmax():
    """run_train_loop(pack_sequences=True) trains a softmax model on
    PackedLMIterator batches (block remat) and logs each step's token
    utilisation; the first step's loss is the packed lm_loss."""
    _, cfg = _lm_cfgs("float32", remat="block")
    api = build(cfg)
    opt = make_optimizer("adamw", warmup_cosine(1e-3, 1, 3))
    params = api.init(0, device="cpu")
    kw = dict(vocab=cfg.vocab, seq_len=32, batch=2, seed=0, min_doc=2,
              max_doc=20)
    twin = packing.PackedLMIterator(**kw)
    batches = [next(twin) for _ in range(3)]
    with torch.no_grad():
        first = api.loss(params, {k: _t(v) for k, v in batches[0].items()})[0]
    res = run_train_loop(make_train_step(api.loss, opt),
                         init_train_state(params, opt),
                         packing.PackedLMIterator(**kw),
                         LoopConfig(total_steps=3, log_every=1,
                                    pack_sequences=True))
    assert [m["token_util"] for _, m in res.history] == [
        float((b["segment_ids"] != 0).mean()) for b in batches]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for _, m in res.history)
    assert res.history[0][1]["loss"] == pytest.approx(first.item(), rel=1e-6)


@pytest.mark.cuda
def test_segmented_kernels_match_plain_versions_on_card():
    """The segmented B3, B4 and B5 against their plain versions on the
    card, on chip_smoke.py's edge cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    errs = chip_smoke.phase3_segmented_flash_kernels(torch, np)
    assert set(errs) == {"flash_attention", "flash_bwd_dq", "flash_bwd_dkv"}
