"""B2's chunked parallel suffix scan against the JAX package.

``kernels/ref.py::aaren_scan_bwd_chunked_reference`` is the algebra of the
CUDA B2 (``csrc/aaren_scan_bwd.cu``) in plain torch: chunk aggregates from
the ⊕ identity in closed form; exclusive carries by the segmented operator,
folded from the seed leftwards; then the token recurrence from each carry,
right to left.
Here it runs at chunk sizes 16, 32, 64 and 256 on rows of N = 1, 16, 63,
64, 65 and 200 tokens and is held against the JAX package's Pallas
``aaren_scan_bwd`` in interpret mode, with segment ends, on the residuals
of the interpret-mode Pallas ``aaren_scan``: ``n1`` is a maximum and must
be equal bit for bit; ``ds``, ``dv``, ``g1`` and ``b1`` round in another
order and must agree within the JAX suite's gradient bar (each scaled by
max |Pallas|, ``rtol = atol = 1e-4``).  The rows of each batch are the
kernel's edge cases at chunk boundaries: ends at a chunk's first and last
token, a last end in chunk 0 (the seed crosses every chunk), every token an
end, ``u == 0`` positions, a padding tail across a boundary, all-padding
rows with and without a seed, extreme scores.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.kernels.aaren_scan import aaren_scan as _pallas_aaren_scan
from repro.kernels.aaren_scan_bwd import aaren_scan_bwd as _pallas_scan_bwd
from repro_torch.core.scan_attention import NEG_INF
from repro_torch.kernels.aaren_scan_bwd import aaren_scan_bwd_plain
from repro_torch.kernels.ref import aaren_scan_bwd_chunked_reference

CHUNKS = (16, 32, 64, 256)
LENGTHS = (1, 16, 63, 64, 65, 200)
D = 6

# label, forward carry and seed, score spread, end positions (or "all" /
# "random"), number of real tokens (None: the whole row), u == 0 at every
# third position
ROWS = [
    ("seed, no ends", True, 3.0, (), None, False),
    ("ends at chunk edges, seed", True, 3.0,
     (15, 16, 31, 32, 63, 64, 127, 128, 199), None, False),
    ("last end in chunk 0, seed", True, 3.0, (2, 5), None, False),
    ("end at token 0, no seed", False, 3.0, (0, 17, 100), None, False),
    ("every token an end, seed", True, 3.0, "all", None, False),
    ("u == 0 positions, ends, seed", True, 3.0, (20, 70), None, True),
    ("padding tail across a boundary, seed", True, 3.0, (10, 40), 50,
     False),
    ("all-padding row", False, 3.0, (), 0, False),
    ("all-padding row, seed", True, 3.0, (), 0, False),
    ("extreme scores (+-80), ends, seed", True, 80.0, (5, 33, 64), None,
     False),
    ("random ends, seed", True, 3.0, "random", None, False),
]


@functools.cache
def _case(n):
    """(s, v, o, m, u, g, n0, g0, b0, ends) numpy arrays of one batch of
    ROWS: the interpret-mode Pallas forward's residuals, cotangents and the
    seed ``(-m_f, g_w, -g_u)``."""
    rng = np.random.default_rng(n)
    r = len(ROWS)
    s = np.empty((r, n), np.float32)
    v = rng.standard_normal((r, n, D)).astype(np.float32)
    g = rng.standard_normal((r, n, D)).astype(np.float32)
    m0 = np.full((r, 1), NEG_INF, np.float32)
    u0 = np.zeros((r, 1), np.float32)
    w0 = np.zeros((r, D), np.float32)
    g_u = np.zeros((r, 1), np.float32)
    g_w = np.zeros((r, D), np.float32)
    ends = np.zeros((r, n), bool)
    for i, (_, seed, spread, at, real, _) in enumerate(ROWS):
        s[i] = rng.standard_normal(n) * spread
        if seed:
            m0[i] = rng.standard_normal() * 2
            u0[i] = rng.uniform(0.5, 3.0)
            w0[i] = rng.standard_normal(D) * u0[i]
            g_u[i] = rng.standard_normal()
            g_w[i] = rng.standard_normal(D)
        if at == "all":
            ends[i] = True
        elif at == "random":
            ends[i] = rng.random(n) < 0.1
        else:
            ends[i, [p for p in at if p < n]] = True
        if real is not None:  # padding: ⊕-identity leaves, never flagged
            s[i, real:], v[i, real:], g[i, real:] = NEG_INF, 0.0, 0.0
            ends[i, max(real - 1, 0):] = False
    # The forward's start flags are the ends shifted right one.
    starts = np.zeros_like(ends)
    starts[:, 1:] = ends[:, :-1]
    o, m_f, _, _, m, u = (np.array(x) for x in jax.block_until_ready(
        _pallas_aaren_scan(s, v, m0, u0, w0, starts.astype(np.float32),
                           return_residuals=True, interpret=True)))
    for i, row in enumerate(ROWS):
        if row[5]:  # empty-state positions: 1/u must read 0, not inf
            u[i, ::3] = 0.0
    return s, v, o, m, u, g, -m_f, g_w, -g_u, ends


@functools.cache
def _jax(n):
    *args, ends = _case(n)
    out = _pallas_scan_bwd(*args, ends.astype(np.float32), interpret=True)
    return [np.array(x) for x in jax.block_until_ready(out)]


def _chunked(n, chunk):
    *args, f = _case(n)
    out = aaren_scan_bwd_chunked_reference(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(f),
        chunk=chunk)
    return [t.numpy() for t in out]


def _assert_matches(got, want, rows=slice(None)):
    for name, a, b in zip(("ds", "dv", "n1", "g1", "b1"), got, want):
        a, b = a[rows], np.asarray(b, np.float32).reshape(a.shape)[rows]
        if name == "n1":
            np.testing.assert_array_equal(a, b, err_msg=name)
            continue
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("n", LENGTHS)
def test_chunked_scan_bwd_matches_pallas(n, chunk):
    """Chunked B2 algebra == interpret-mode Pallas B2 with segment ends on
    the Pallas forward's residuals, over the edge-case rows."""
    _assert_matches(_chunked(n, chunk), _jax(n))


@pytest.mark.parametrize("chunk", CHUNKS)
def test_no_ends_equal_all_zero_ends(chunk):
    """Without ends the chunked algebra is the unsegmented suffix scan: bit
    for bit the result of all-zero ends, and on the row without ends the
    JAX package's."""
    n = 200
    *args, _ = _case(n)
    args = [torch.from_numpy(a) for a in args]
    plain = aaren_scan_bwd_chunked_reference(*args, chunk=chunk)
    zeros = aaren_scan_bwd_chunked_reference(
        *args, torch.zeros((len(ROWS), n), dtype=torch.bool), chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(plain, zeros))
    _assert_matches([t.numpy() for t in plain], _jax(n), rows=slice(0, 1))


def test_seed_reaches_only_tokens_after_the_last_end():
    """With its last end in chunk 0, the seed's g_w crosses every chunk to
    reach the row's last segment, and ``(n1, g1, b1)`` covers only the
    first segment: tokens 0..2, whatever the seed."""
    n = 200
    row = [label for label, *_ in ROWS].index("last end in chunk 0, seed")
    *args, ends = _case(n)
    cut = [torch.from_numpy(a[row:row + 1].copy()) for a in args]
    f = torch.from_numpy(ends[row:row + 1].copy())
    for chunk in CHUNKS:
        base = aaren_scan_bwd_chunked_reference(*cut, f, chunk=chunk)
        cut2 = list(cut)
        cut2[7] = cut[7] + 1.0  # another g_w
        moved = aaren_scan_bwd_chunked_reference(*cut2, f, chunk=chunk)
        assert torch.equal(base[0][:, :3], moved[0][:, :3])
        assert torch.equal(base[1][:, :3], moved[1][:, :3])
        assert all(torch.equal(a, b) for a, b in zip(base[2:], moved[2:]))
        assert not torch.equal(base[1][:, 6:], moved[1][:, 6:])


def test_chunked_scan_bwd_matches_plain_version():
    """The chunked algebra against the port's plain version (a
    Hillis-Steele scan): n1 bit for bit, the rest within the bar."""
    n = 65
    *args, f = _case(n)
    args = [torch.from_numpy(a) for a in args]
    want = aaren_scan_bwd_plain(*args, segment_ends=torch.from_numpy(f))
    _assert_matches(_chunked(n, 16), [t.numpy() for t in want])
