"""The rounding points of the bf16 tensor-core flash kernels (B3, B4, B5)
against the JAX package.

The bf16 forms of B3, B4 and B5 multiply on the tensor cores: products of
two bf16 inputs (``q·kᵀ``, ``do·vᵀ``) are exact f32 sums, while ``p`` and
``dS`` are rounded to bf16 before ``p·v``, ``dS·k``, ``pᵀ·do`` and
``dSᵀ·q``.  The oracles of those rounding points,
``ref.flash_attention_tc_oracle``, ``ref.flash_bwd_dq_tc_oracle`` and
``ref.flash_bwd_dkv_tc_oracle``, run here on bf16 inputs and are held
against the JAX package's dense oracles ``repro.kernels.ref.flash_reference``
and ``flash_vjp_reference`` in f32 on the same bf16-representable values,
at the port's bf16 bars (tests/test_torch_flash.py): forward
``rtol = atol = 2e-2``, gradients ``|port - ref| <= 2e-2 · max|ref| +
1e-6``.  So rounding ``p`` and ``dS`` keeps the kernels' function within
the bars the f32 reference holds.  On f32 inputs the oracles round nothing
and equal the plain versions of B3, B4 and B5 bit for bit.
"""

import math

import jax
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_reference as _jax_flash_reference
from repro.kernels.ref import flash_vjp_reference as _jax_flash_vjp_reference
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

_STATIC = ("causal", "window", "scale")
jax_flash_reference = jax.jit(_jax_flash_reference, static_argnames=_STATIC)
jax_flash_vjp_reference = jax.jit(_jax_flash_vjp_reference,
                                  static_argnames=_STATIC)


def _ids(b, n, rows):
    """(B, N) int32 segment ids from (id, start, stop) spans; the rest of a
    row is padding (0)."""
    ids = np.zeros((b, n), np.int32)
    for r, spans in enumerate(rows):
        for sid, a, c in spans:
            ids[r, a:c] = sid
    return ids


# label, (B, H, G, N, d), causal, window, lengths (q and kv), segment ids
CASES = [
    ("causal", (2, 2, 2, 97, 32), True, None, None, None),
    ("window 48", (2, 2, 2, 150, 32), True, 48, None, None),
    ("non-causal, GQA 4:2", (2, 4, 2, 80, 32), False, None, None, None),
    ("GQA 8:2, causal", (1, 8, 2, 70, 32), True, None, None, None),
    ("ragged lengths with an empty row", (2, 2, 1, 90, 32), True, None,
     (0, 61), None),
    ("segment ids with padding", (2, 2, 2, 140, 32), True, None, None,
     [[(1, 0, 30), (2, 30, 100), (3, 100, 120)], [(5, 0, 1), (4, 1, 140)]]),
    ("d = 40", (2, 2, 1, 75, 40), True, None, (75, 33), None),
]


def _inputs(case, seed):
    """bf16 q, k, v, do and the case's masks as torch and numpy arrays."""
    _, (b, h, g, n, d), causal, window, lens, rows = case
    rng = np.random.default_rng(seed)
    shapes = ((b, h, n, d), (b, g, n, d), (b, g, n, d), (b, h, n, d))
    bf = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          .bfloat16() for s in shapes]
    lens_np = None if lens is None else np.asarray(lens, np.int32)
    ids_np = None if rows is None else _ids(b, n, rows)
    return bf, lens_np, ids_np


def _port_kw(case, lens_np, ids_np):
    """The clamped (B,) lengths and the keywords of the plain versions."""
    _, (b, _, _, n, d), causal, window, _, _ = case
    seg = None if ids_np is None else torch.from_numpy(ids_np)
    lens = fa._lens(None if lens_np is None else torch.from_numpy(lens_np),
                    b, n, "cpu")
    return lens, dict(causal=causal, window=window, scale=1.0 / math.sqrt(d),
                      q_seg=seg, kv_seg=seg)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_tc_oracles_within_bf16_bars_of_jax(i):
    case = CASES[i]
    _, _, causal, window, _, _ = case
    (q, k, v, do), lens_np, ids_np = _inputs(case, seed=40 + i)
    lens, kw = _port_kw(case, lens_np, ids_np)

    o, lse = ref.flash_attention_tc_oracle(q, k, v, lens, lens, **kw)
    assert o.dtype == torch.bfloat16
    delta = (do.float() * o.float()).sum(dim=-1)
    dk, dv = ref.flash_bwd_dkv_tc_oracle(q, k, v, do, lse, delta, lens, lens,
                                         **kw)
    assert dk.dtype == dv.dtype == torch.bfloat16

    f32 = [np.asarray(t.float()) for t in (q, k, v, do)]
    jkw = dict(causal=causal, window=window, q_lens=lens_np,
               kv_lens=lens_np, q_segment_ids=ids_np, kv_segment_ids=ids_np)
    want_o = np.asarray(jax_flash_reference(*f32[:3], **jkw))
    np.testing.assert_allclose(o.float().numpy(), want_o, rtol=2e-2,
                               atol=2e-2)
    _, want_dk, want_dv = jax_flash_vjp_reference(*f32, **jkw)
    for name, got, want in (("dk", dk, want_dk), ("dv", dv, want_dv)):
        want = np.asarray(want)
        err = np.abs(got.float().numpy() - want).max()
        bar = 2e-2 * np.abs(want).max() + 1e-6
        assert err <= bar, f"{name}: max |oracle - JAX| {err:.3e} > {bar:.3e}"


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_tc_oracles_equal_plain_versions_on_f32(i):
    case = CASES[i]
    (q, k, v, do), lens_np, ids_np = _inputs(case, seed=60 + i)
    q, k, v, do = (t.float() for t in (q, k, v, do))
    lens, kw = _port_kw(case, lens_np, ids_np)

    o, lse = ref.flash_attention_tc_oracle(q, k, v, lens, lens, **kw)
    o_p, lse_p = fa.flash_attention_plain(q, k, v, lens, lens, **kw)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    delta = (do * o).sum(dim=-1)
    args = (q, k, v, do, lse, delta, lens, lens)
    for got, want in zip(ref.flash_bwd_dkv_tc_oracle(*args, **kw),
                         fa.flash_bwd_dkv_plain(*args, **kw)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_dq_tc_oracle_within_bf16_bar_of_jax(i):
    """B4's oracle (dS rounded to bf16 before dS·k) on bf16 inputs against
    the JAX f32 dq, with lse and delta from the forward oracle."""
    case = CASES[i]
    _, _, causal, window, _, _ = case
    (q, k, v, do), lens_np, ids_np = _inputs(case, seed=80 + i)
    lens, kw = _port_kw(case, lens_np, ids_np)

    o, lse = ref.flash_attention_tc_oracle(q, k, v, lens, lens, **kw)
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = ref.flash_bwd_dq_tc_oracle(q, k, v, do, lse, delta, lens, lens, **kw)
    assert dq.dtype == torch.bfloat16

    f32 = [np.asarray(t.float()) for t in (q, k, v, do)]
    want, _, _ = jax_flash_vjp_reference(
        *f32, causal=causal, window=window, q_lens=lens_np, kv_lens=lens_np,
        q_segment_ids=ids_np, kv_segment_ids=ids_np)
    want = np.asarray(want)
    err = np.abs(dq.float().numpy() - want).max()
    bar = 2e-2 * np.abs(want).max() + 1e-6
    assert err <= bar, f"dq: max |oracle - JAX| {err:.3e} > {bar:.3e}"
    dead = np.arange(q.shape[2])[None, :] >= lens.numpy()[:, None]
    if ids_np is not None:
        dead |= ids_np == 0
    assert not dq.float().numpy()[np.broadcast_to(dead[:, None],
                                                  dq.shape[:3])].any()


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_dq_tc_oracle_equals_plain_version_on_f32(i):
    case = CASES[i]
    (q, k, v, do), lens_np, ids_np = _inputs(case, seed=100 + i)
    q, k, v, do = (t.float() for t in (q, k, v, do))
    lens, kw = _port_kw(case, lens_np, ids_np)
    o, lse = fa.flash_attention_plain(q, k, v, lens, lens, **kw)
    delta = (do * o).sum(dim=-1)
    args = (q, k, v, do, lse, delta, lens, lens)
    assert torch.equal(ref.flash_bwd_dq_tc_oracle(*args, **kw),
                       fa.flash_bwd_dq_plain(*args, **kw))


def test_tc_oracle_rounds_p_against_the_running_max():
    """The forward oracle rounds p against the running max of the kernel's
    64-key tiles: a late large score leaves the early tiles' p rounded in
    their own frame, then carried to the final max in f32."""
    b, h, n, d = 1, 1, 130, 16
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((b, h, n, d))
                         .astype(np.float32)).bfloat16()
    k = torch.from_numpy(rng.standard_normal((b, h, n, d))
                         .astype(np.float32)).bfloat16()
    k[:, :, 100] = (q[:, :, -1].float() * 4).bfloat16()  # a late max
    v = torch.from_numpy(rng.standard_normal((b, h, n, d))
                         .astype(np.float32)).bfloat16()
    lens = fa._lens(None, b, n, "cpu")
    kw = dict(causal=True, window=None, scale=1.0 / math.sqrt(d))
    o_tile, lse_tile = ref.flash_attention_tc_oracle(q, k, v, lens, lens,
                                                     **kw)
    o_one, lse_one = ref.flash_attention_tc_oracle(q, k, v, lens, lens,
                                                   kv_tile=n, **kw)
    assert torch.equal(lse_tile, lse_one)
    # Rows before key 64 see one tile either way.  Rows past the late max
    # round tile 0's p in tile 0's frame: other bits, within a spacing.
    assert torch.equal(o_tile[:, :, :64], o_one[:, :, :64])
    assert not torch.equal(o_tile[:, :, 101:], o_one[:, :, 101:])
    err = (o_tile.float() - o_one.float()).abs().max().item()
    assert err <= 2 ** -7 * o_one.float().abs().max().item()
