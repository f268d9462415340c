"""B1's chunked parallel scan against the JAX package.

``kernels/ref.py::aaren_scan_chunked_reference`` is the algebra of the CUDA
B1 (``csrc/aaren_scan.cu``) in plain torch: chunk aggregates from the ⊕
identity, exclusive carries by the segmented operator, then the token
recurrence from each carry.  Here it runs at chunk sizes 16, 32, 64 and
256 on rows of N = 1, 16, 63, 64, 65 and 200 tokens and is held against
the JAX package's Pallas ``aaren_scan`` in interpret mode (segment flags and
residuals on): ``m``, ``m_f`` and ``m_all`` are maxima and must be equal
bit for bit; ``o``, ``u``, ``w`` round in another order and must agree
within the JAX suite's bar, ``rtol = atol = 1e-4``.  The rows of each batch
are the kernel's edge cases at chunk boundaries: flags at a chunk's first
and last token, a carry whose first flag lies in chunk 2, every token
flagged, a padding tail across a boundary, all-padding rows with and
without a carry, extreme scores.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.kernels.aaren_scan import aaren_scan as _pallas_aaren_scan
from repro_torch.core.scan_attention import NEG_INF
from repro_torch.kernels.aaren_scan import aaren_scan_plain
from repro_torch.kernels.ref import aaren_scan_chunked_reference

CHUNKS = (16, 32, 64, 256)
LENGTHS = (1, 16, 63, 64, 65, 200)
TOL = dict(rtol=1e-4, atol=1e-4)
D = 6

# label, carry, score spread, flagged positions (or "all" / "random"),
# number of real tokens (None: the whole row)
ROWS = [
    ("carry, no flags", True, 3.0, (), None),
    ("flags at chunk edges, carry", True, 3.0,
     (15, 16, 31, 32, 63, 64, 127, 128, 199), None),
    ("flag at token 0", False, 3.0, (0, 17, 100), None),
    ("carry, first flag in chunk 2 of 16", True, 3.0, (40, 90), None),
    ("carry, first flag in chunk 2 of 32", True, 3.0, (70, 150), None),
    ("carry, first flag in chunk 2 of 64", True, 3.0, (140,), None),
    ("every token flagged, carry", True, 3.0, "all", None),
    ("padding tail across a boundary, carry", True, 3.0, (10, 40), 50),
    ("all-padding row", False, 3.0, (), 0),
    ("all-padding row, carry", True, 3.0, (), 0),
    ("extreme scores (+-80), flags", True, 80.0, (5, 33, 64), None),
    ("random flags, carry", True, 3.0, "random", None),
]


@functools.cache
def _case(n):
    """(s, v, m0, u0, w0, flags) numpy arrays of one batch of ROWS."""
    rng = np.random.default_rng(n)
    r = len(ROWS)
    s = np.empty((r, n), np.float32)
    v = rng.standard_normal((r, n, D)).astype(np.float32)
    m0 = np.full((r, 1), NEG_INF, np.float32)
    u0 = np.zeros((r, 1), np.float32)
    w0 = np.zeros((r, D), np.float32)
    flags = np.zeros((r, n), bool)
    for i, (_, carry, spread, at, real) in enumerate(ROWS):
        s[i] = rng.standard_normal(n) * spread
        if carry:
            m0[i] = rng.standard_normal() * 2
            u0[i] = rng.uniform(0.5, 3.0)
            w0[i] = rng.standard_normal(D) * u0[i]
        if at == "all":
            flags[i] = True
        elif at == "random":
            flags[i] = rng.random(n) < 0.1
        else:
            flags[i, [p for p in at if p < n]] = True
        if real is not None:  # padding: ⊕-identity leaves, never flagged
            s[i, real:], v[i, real:], flags[i, real:] = NEG_INF, 0.0, False
    return s, v, m0, u0, w0, flags


@functools.cache
def _jax(n):
    s, v, m0, u0, w0, flags = _case(n)
    out = _pallas_aaren_scan(s, v, m0, u0, w0, flags.astype(np.float32),
                             return_residuals=True, interpret=True)
    return [np.asarray(x) for x in jax.block_until_ready(out)]


def _chunked(n, chunk, flags=True):
    s, v, m0, u0, w0, f = _case(n)
    args = [torch.from_numpy(a) for a in (s, v, m0, u0, w0)]
    out = aaren_scan_chunked_reference(
        *args, torch.from_numpy(f) if flags else None, chunk=chunk)
    return [t.numpy() for t in out]


def _assert_matches(got, want, rows=slice(None)):
    for name, a, b in zip(("o", "m_f", "u_f", "w_f", "m_all", "u_all"), got,
                          want):
        a, b = a[rows], b[rows]
        if name.startswith("m"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, err_msg=name, **TOL)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("n", LENGTHS)
def test_chunked_scan_matches_pallas(n, chunk):
    """Chunked B1 algebra == interpret-mode Pallas B1 with flags and
    residuals, row by row over the edge cases."""
    _assert_matches(_chunked(n, chunk), _jax(n))


@pytest.mark.parametrize("chunk", CHUNKS)
def test_no_flags_equal_all_zero_flags(chunk):
    """Without flags the chunked algebra is the unsegmented scan: bit for
    bit the result of all-zero flags, and on the unflagged row the JAX
    package's."""
    n = 200
    s, v, m0, u0, w0, _ = _case(n)
    args = [torch.from_numpy(a) for a in (s, v, m0, u0, w0)]
    plain = aaren_scan_chunked_reference(*args, chunk=chunk)
    zeros = aaren_scan_chunked_reference(
        *args, torch.zeros((len(ROWS), n), dtype=torch.bool), chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(plain, zeros))
    _assert_matches([t.numpy() for t in plain], _jax(n), rows=slice(0, 1))


def test_all_padding_row_counts_u_token_by_token():
    """An all-padding row folded into an empty carry gets u = i + 1 after
    token i across every chunk boundary, as the sequential walk does, and
    reads o = 0."""
    n = 200
    row = [label for label, *_ in ROWS].index("all-padding row")
    for chunk in CHUNKS:
        o, m_f, u_f, _, m_all, u_all = _chunked(n, chunk)
        np.testing.assert_array_equal(u_all[row], np.arange(1, n + 1))
        assert u_f[row, 0] == n and m_f[row, 0] == np.float32(NEG_INF)
        assert not np.any(o[row]) and (m_all[row] == np.float32(NEG_INF)).all()


def test_chunked_scan_matches_plain_version():
    """The chunked algebra against the port's plain version (a
    Hillis-Steele scan): m bit for bit, the rest within the bar."""
    n = 65
    s, v, m0, u0, w0, f = _case(n)
    args = [torch.from_numpy(a) for a in (s, v, m0, u0, w0)]
    want = aaren_scan_plain(*args, segment_starts=torch.from_numpy(f),
                            return_residuals=True)
    _assert_matches(_chunked(n, 16), [t.numpy() for t in want])
