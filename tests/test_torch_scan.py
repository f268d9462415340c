"""The port's prefix scan (``repro_torch.kernels``) against the JAX package.

The same numpy inputs, made from a seed, go through the port's
``aaren_scan`` wrapper and ``aaren_prefix_attention`` (on CPU tensors: the
plain torch version) and through the JAX package's Pallas kernel in
interpret mode, its dense oracle and its jnp ``ops`` path.  Tolerances are
the JAX suite's own bars for this kernel against its oracle
(tests/test_kernels.py): o/u/w ``rtol=atol=1e-4``, ``m`` ``rtol=1e-5``.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scan_attention import ScanState as JScanState
from repro.kernels.aaren_scan import aaren_scan as _pallas_aaren_scan
from repro.kernels.ops import aaren_prefix_attention as _jax_prefix_attention
from repro.kernels.ref import aaren_scan_reference as _jax_reference
from repro_torch.core.scan_attention import NEG_INF, ScanState
from repro_torch.kernels.aaren_scan import aaren_scan, aaren_scan_plain
from repro_torch.kernels.aaren_scan_bwd import aaren_scan_bwd
from repro_torch.kernels.ops import aaren_prefix_attention, flash_mha
from repro_torch.kernels.ref import aaren_scan_reference

# One jit per shape: eager JAX compiles every primitive of the scan anew.
jax_reference = jax.jit(_jax_reference)
jax_prefix_attention = jax.jit(_jax_prefix_attention)


def pallas_aaren_scan(*args):
    return _pallas_aaren_scan(*args, interpret=True)


TOL = dict(rtol=1e-4, atol=1e-4)
M_TOL = dict(rtol=1e-5)
REPO = Path(__file__).resolve().parents[1]


def _inputs(r, n, d, carry, seed=0, spread=3.0):
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((r, n)) * spread).astype(np.float32)
    v = rng.standard_normal((r, n, d)).astype(np.float32)
    if carry:
        m0 = (rng.standard_normal((r, 1)) * 2).astype(np.float32)
        u0 = rng.uniform(0.5, 3.0, (r, 1)).astype(np.float32)
        w0 = (rng.standard_normal((r, d)) * u0).astype(np.float32)
    else:
        m0 = np.full((r, 1), NEG_INF, np.float32)
        u0 = np.zeros((r, 1), np.float32)
        w0 = np.zeros((r, d), np.float32)
    return s, v, m0, u0, w0


def _port(s, v, m0, u0, w0):
    out = aaren_scan(*(torch.from_numpy(a) for a in (s, v, m0, u0, w0)))
    return [t.numpy() for t in out]


def _assert_same(got, want):
    o, m, u, w = got
    o_w, m_w, u_w, w_w = (np.asarray(x) for x in want)
    np.testing.assert_allclose(o, o_w, **TOL)
    np.testing.assert_allclose(m, m_w, **M_TOL)
    np.testing.assert_allclose(u, u_w, **TOL)
    np.testing.assert_allclose(w, w_w, **TOL)


@pytest.mark.parametrize("carry", [False, True], ids=["empty", "carry"])
@pytest.mark.parametrize("d", [8, 96])
@pytest.mark.parametrize("n", [1, 5, 16, 97])
@pytest.mark.parametrize("r", [1, 7])
def test_scan_matches_jax(r, n, d, carry):
    """Port scan == interpret-mode Pallas == dense oracle == jnp ops."""
    args = _inputs(r, n, d, carry, seed=r * 1000 + n * 10 + d)
    got = _port(*args)
    jargs = [jnp.asarray(a) for a in args]
    _assert_same(got, pallas_aaren_scan(*jargs))
    _assert_same(got, jax_reference(*jargs))
    o, fin = jax_prefix_attention(
        jargs[0], jargs[1], JScanState(m=jargs[2][:, 0], u=jargs[3][:, 0],
                                       w=jargs[4]))
    _assert_same(got, (o, fin.m[:, None], fin.u[:, None], fin.w))
    # The port's own dense oracle agrees too.
    ref = aaren_scan_reference(*(torch.from_numpy(a) for a in args))
    _assert_same(got, [t.numpy() for t in ref])


def test_carry_chaining():
    """Two chained halves == one call over the whole sequence."""
    s, v, m0, u0, w0 = _inputs(3, 40, 16, carry=True, seed=1)
    o, m, u, w = _port(s, v, m0, u0, w0)
    o1, m1, u1, w1 = _port(np.ascontiguousarray(s[:, :17]),
                           np.ascontiguousarray(v[:, :17]), m0, u0, w0)
    o2, m2, u2, w2 = _port(np.ascontiguousarray(s[:, 17:]),
                           np.ascontiguousarray(v[:, 17:]), m1, u1, w1)
    np.testing.assert_allclose(o, np.concatenate([o1, o2], 1), **TOL)
    np.testing.assert_array_equal(m, m2)
    np.testing.assert_allclose(u, u2, **TOL)
    np.testing.assert_allclose(w, w2, **TOL)


@pytest.mark.parametrize("carry", [False, True], ids=["empty", "carry"])
def test_masked_tail_and_all_padding_row(carry):
    """Masked positions (s = NEG_INF, v = 0) are ⊕-identity leaves and are
    not special-cased: an all-padding row folded into an empty carry gets
    u = N (exp(NEG_INF - NEG_INF) = 1 per leaf), exactly as in JAX."""
    r, n, d = 4, 13, 8
    s, v, m0, u0, w0 = _inputs(r, n, d, carry, seed=2)
    valid = np.arange(n)[None, :] < np.array([[13], [9], [0], [1]])
    s = np.where(valid, s, NEG_INF).astype(np.float32)
    v = np.where(valid[..., None], v, 0.0).astype(np.float32)
    got = _port(s, v, m0, u0, w0)
    jargs = [jnp.asarray(a) for a in (s, v, m0, u0, w0)]
    _assert_same(got, pallas_aaren_scan(*jargs))
    _assert_same(got, jax_reference(*jargs))
    o, m, u, w = got
    if carry:   # the carry passes through the padding row untouched
        np.testing.assert_array_equal(m[2], m0[2])
        np.testing.assert_array_equal(u[2], u0[2])
        np.testing.assert_array_equal(w[2], w0[2])
    else:
        assert u[2, 0] == n and m[2, 0] == np.float32(NEG_INF)
        assert not np.any(o[2]) and not np.any(w[2])


def test_extreme_scores():
    """f32 stability with a ±80 score spread: no NaN, o == 1 for v == 1."""
    s = np.asarray([[-80.0, 85.0] * 24, [85.0, -80.0] * 24], np.float32)
    v = np.ones((2, 48, 8), np.float32)
    m0 = np.full((2, 1), NEG_INF, np.float32)
    u0 = np.zeros((2, 1), np.float32)
    w0 = np.zeros((2, 8), np.float32)
    got = _port(s, v, m0, u0, w0)
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], 1.0, rtol=1e-5)
    _assert_same(got, pallas_aaren_scan(
        *(jnp.asarray(a) for a in (s, v, m0, u0, w0))))


def test_ops_leading_dims_match_jax():
    """aaren_prefix_attention reshapes (B, H, N) to (R, N) and back."""
    rng = np.random.default_rng(3)
    s = (rng.standard_normal((2, 3, 6)) * 2).astype(np.float32)
    v = rng.standard_normal((2, 3, 6, 8)).astype(np.float32)
    o, fin = aaren_prefix_attention(torch.from_numpy(s), torch.from_numpy(v))
    jo, jfin = jax_prefix_attention(jnp.asarray(s), jnp.asarray(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    for a, b in zip(fin, jfin):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # ... and a carry threads through as (B, H) / (B, H, d) leaves.
    o2, fin2 = aaren_prefix_attention(torch.from_numpy(s),
                                      torch.from_numpy(v), fin)
    jo2, jfin2 = jax_prefix_attention(jnp.asarray(s), jnp.asarray(v), jfin)
    np.testing.assert_allclose(o2.numpy(), np.asarray(jo2), **TOL)
    for a, b in zip(fin2, jfin2):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_ops_refuses_segments_and_wrapper_checks_inputs():
    """flash_mha refuses malformed segment ids (it takes well-formed ones:
    tests/test_torch_packing_softmax.py); the Aaren scan takes them
    (tests/test_torch_packing.py), and its wrappers check every input, the
    segment flags included."""
    s = torch.zeros(2, 4)
    v = torch.zeros(2, 4, 8)
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="segment_ids"):
        flash_mha(q, q, q, q_segment_ids=torch.ones(1, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="integer"):
        flash_mha(q, q, q, kv_segment_ids=torch.ones(1, 4))
    m0, u0, w0 = torch.zeros(2, 1), torch.zeros(2, 1), torch.zeros(2, 8)
    for bad in (torch.ones(2, 4), torch.ones(2, 3, dtype=torch.bool),
                torch.ones(4, 2, dtype=torch.bool).t()):
        with pytest.raises(ValueError, match="segment_starts"):
            aaren_scan(s, v, m0, u0, w0, segment_starts=bad)
        with pytest.raises(ValueError, match="segment_ends"):
            aaren_scan_bwd(s, v, v, s, s, v, m0, w0, u0, segment_ends=bad)
    with pytest.raises(ValueError, match="float32"):
        aaren_scan(s.double(), v, m0, u0, w0)
    with pytest.raises(ValueError, match="shape"):
        aaren_scan(s, v, m0, u0, torch.zeros(2, 7))
    with pytest.raises(ValueError, match="contiguous"):
        aaren_scan(s, v.transpose(0, 1).contiguous().transpose(0, 1),
                   m0, u0, w0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        aaren_scan(*(t.to("meta") for t in (s, v, m0, u0, w0)))


def test_plain_version_is_the_cpu_path():
    """On CPU tensors the wrapper is the plain version, bit for bit, and
    launches no kernel."""
    args = [torch.from_numpy(a) for a in _inputs(5, 11, 8, carry=True)]
    before = aaren_scan.n_launches
    got = aaren_scan(*args)
    want = aaren_scan_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert aaren_scan.n_launches == before


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def _forbidden_imports(path: Path) -> list[str]:
    """The imports of ``path`` the port may not make: jax, jaxlib, the JAX
    package ``repro``, and the JAX package's benchmarks and examples (any
    ``benchmarks.*`` outside ``benchmarks.torch``, any ``examples.*``
    outside ``examples.torch``)."""
    bad = []
    for name in sorted(_imports(path)):
        parts = name.split(".")
        if parts[0] in ("jax", "jaxlib", "repro") or (
                parts[0] in ("benchmarks", "examples")
                and parts[1:2] != ["torch"]):
            bad.append(name)
    return bad


def test_port_imports_neither_jax_nor_repro():
    """src/repro_torch/, benchmarks/torch/, examples/torch/ and
    chip_smoke.py import no jax, nothing of the JAX package ``repro``, and
    none of its benchmarks or examples."""
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    for folder in ("benchmarks", "examples"):
        found = sorted((REPO / folder / "torch").rglob("*.py"))
        assert len(found) >= 4, folder
        files += found
    files.append(REPO / "chip_smoke.py")
    bad = {}
    for f in files:
        hit = _forbidden_imports(f)
        if hit:
            bad[str(f.relative_to(REPO))] = hit
    assert not bad, bad


def test_import_scan_flags_jax_benchmarks_and_examples(tmp_path):
    """The scan flags the JAX scaffold (``benchmarks.common`` imports jax)
    and the JAX examples, and lets the port's own twins through."""
    src = tmp_path / "mod.py"
    src.write_text("import benchmarks.common\n"
                   "from examples import quickstart\n"
                   "from benchmarks.torch.common import emit\n"
                   "import examples.torch.quickstart\n"
                   "from repro.core import aaren\n"
                   "import numpy, torch\n")
    assert _forbidden_imports(src) == ["benchmarks.common", "examples",
                                       "repro.core"]
