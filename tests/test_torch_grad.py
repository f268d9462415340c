"""Gradients of the port's prefix scan (``repro_torch.kernels``) against the
JAX package.

The same numpy inputs, made from a seed, go through the port's plain B1
residual form and plain B2 (the CPU path of their wrappers), its epilogue,
its autograd Function and its dense VJP oracle, and through the JAX
package's Pallas kernels in interpret mode, its epilogue, ``jax.grad`` of
its custom VJP (jnp and interpret modes) and its oracle.  Bars are the JAX
suite's (tests/test_kernels.py): residuals ``rtol=atol=1e-4`` with ``m`` at
``rtol=1e-5``; gradients scaled by max |reference| at 1e-4 (f32 inputs)
and 2e-2 (bf16 inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scan_attention import ScanState as JScanState
from repro.kernels import ops as jops
from repro.kernels.aaren_scan import aaren_scan as _pallas_scan
from repro.kernels.aaren_scan_bwd import aaren_scan_bwd as _pallas_bwd
from repro.kernels.ref import aaren_scan_vjp_reference as jax_vjp_reference
from repro_torch.core.scan_attention import NEG_INF, ScanState
from repro_torch.kernels import ops
from repro_torch.kernels.aaren_scan import aaren_scan, aaren_scan_plain
from repro_torch.kernels.aaren_scan_bwd import (
    aaren_scan_bwd,
    aaren_scan_bwd_plain,
)
from repro_torch.kernels.ref import aaren_scan_vjp_reference

TOL = dict(rtol=1e-4, atol=1e-4)
M_TOL = dict(rtol=1e-5)
R, D = 5, 16
NS = [1, 7, 37, 128]


def _np(t):
    return t.detach().float().numpy()


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _grad_close(got, want, rtol=1e-4):
    """The JAX suite's gradient bar: both scaled by max |want|."""
    for a, b in zip(got, want):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32).reshape(a.shape)
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, rtol=rtol,
                                   atol=rtol)


def _fwd_inputs(r, n, d, carry, seed):
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((r, n)) * 3.0).astype(np.float32)
    v = rng.standard_normal((r, n, d)).astype(np.float32)
    if carry:
        m0 = (rng.standard_normal((r, 1)) + 4.0).astype(np.float32)
        u0 = rng.uniform(1.0, 3.0, (r, 1)).astype(np.float32)
        w0 = rng.standard_normal((r, d)).astype(np.float32)
    else:
        m0 = np.full((r, 1), NEG_INF, np.float32)
        u0 = np.zeros((r, 1), np.float32)
        w0 = np.zeros((r, d), np.float32)
    return s, v, m0, u0, w0


def _cotangents(r, n, d, seed):
    rng = np.random.default_rng(seed + 7)
    return (rng.standard_normal((r, n, d)).astype(np.float32),
            rng.standard_normal((r, 1)).astype(np.float32),
            rng.standard_normal((r, 1)).astype(np.float32),
            rng.standard_normal((r, d)).astype(np.float32))


def _jax_residuals(args):
    return _pallas_scan(*(jnp.asarray(a) for a in args),
                        return_residuals=True, interpret=True)


@pytest.mark.parametrize("carry", [False, True], ids=["empty", "carry"])
@pytest.mark.parametrize("n", NS)
def test_residuals_match_pallas(n, carry):
    """Plain B1 with residuals == interpret-mode Pallas B1 with residuals."""
    args = _fwd_inputs(R, n, D, carry, seed=n)
    got = aaren_scan(*(_t(a) for a in args), return_residuals=True)
    want = _jax_residuals(args)
    assert len(got) == 6
    for i, (a, b) in enumerate(zip(got, want)):
        tol = M_TOL if i in (1, 4) else TOL       # m_f and m_all
        np.testing.assert_allclose(_np(a), np.asarray(b), **tol)


def _bwd_case(n, carry, seed, zero_u=False):
    """Residuals from the JAX forward, cotangents from numpy: the same
    inputs for both packages' reverse scans."""
    args = _fwd_inputs(R, n, D, carry, seed)
    o, m_f, u_f, w_f, m_all, u_all = (np.asarray(x)
                                      for x in _jax_residuals(args))
    g_o, _, g_u, g_w = _cotangents(R, n, D, seed)
    u_all = u_all.copy()
    if zero_u:  # empty-state positions: 1/u must be zeroed, not inf
        u_all[:, ::3] = 0.0
    s, v = args[0], args[1]
    return (s, v, o, m_all, u_all, g_o, -m_f, g_w, -g_u)


@pytest.mark.parametrize("case", [
    *[(n, c, False) for n in NS for c in (False, True)],
    (37, True, True)], ids=lambda c: f"n{c[0]}-{'carry' if c[1] else 'empty'}"
                                     f"{'-zero_u' if c[2] else ''}")
def test_bwd_plain_matches_pallas(case):
    """Plain B2 (the CPU path of the wrapper) == interpret-mode Pallas B2
    on the same residuals, including u == 0 positions."""
    n, carry, zero_u = case
    bwd_args = _bwd_case(n, carry, seed=100 + n, zero_u=zero_u)
    before = aaren_scan_bwd.n_launches
    got = aaren_scan_bwd(*(_t(a) for a in bwd_args))
    assert aaren_scan_bwd.n_launches == before
    want = _pallas_bwd(*(jnp.asarray(a) for a in bwd_args), interpret=True)
    _grad_close([_np(t) for t in got], want)
    for a, b in zip(got, aaren_scan_bwd_plain(*(_t(a) for a in bwd_args))):
        assert torch.equal(a, b)


def test_bwd_wrapper_validates_inputs():
    args = [_t(a) for a in _bwd_case(7, False, seed=1)]
    with pytest.raises(ValueError, match="shape"):
        aaren_scan_bwd(*args[:6], args[6], args[7][:, :4], args[8])
    with pytest.raises(ValueError, match="float32"):
        aaren_scan_bwd(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        aaren_scan_bwd(*args[:2], args[2].transpose(1, 2).contiguous()
                       .transpose(1, 2), *args[3:])


@pytest.mark.parametrize("hit_mask", [False, True])
def test_epilogue_matches_jax(hit_mask):
    """The port's aaren_bwd_epilogue == the JAX package's, with exact ties
    between scores, m_f and m0 so every tie-split branch runs."""
    rng = np.random.default_rng(3)
    r, n, d = 4, 9, D
    s = rng.standard_normal((r, n)).astype(np.float32)
    m_f = s.max(axis=1, keepdims=True)
    s[0, 3] = m_f[0, 0]                              # second tie in row 0
    m0 = rng.standard_normal((r, 1)).astype(np.float32)
    m0[1] = m_f[1]                                   # carry ties the max
    u0, u_f = (rng.uniform(0.5, 2.0, (r, 1)).astype(np.float32)
               for _ in range(2))
    w0, w_f, g_w, g1 = (rng.standard_normal((r, d)).astype(np.float32)
                        for _ in range(4))
    g_m, g_u, n1, b1 = (rng.standard_normal((r, 1)).astype(np.float32)
                        for _ in range(4))
    ds = rng.standard_normal((r, n)).astype(np.float32)
    args = [s, m0, u0, w0, m_f, u_f, w_f, g_m, g_u, g_w, ds, n1, g1, b1]
    mask = (rng.random((r, n)) < 0.7).astype(np.float32) if hit_mask else None
    kw = {} if mask is None else {"hit_mask": mask}
    want = jops.aaren_bwd_epilogue(
        *(jnp.asarray(a) for a in args),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = ops.aaren_bwd_epilogue(*(_t(a) for a in args),
                                 **{k: _t(v) for k, v in kw.items()})
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("carry", [False, True], ids=["empty", "carry"])
def test_vjp_reference_matches_jax(carry):
    args = _fwd_inputs(3, 37, D, carry, seed=5)
    cots = _cotangents(3, 37, D, seed=5)
    want = jax.jit(jax_vjp_reference)(*(jnp.asarray(a)
                                         for a in args + cots))
    got = aaren_scan_vjp_reference(*(_t(a) for a in args + cots))
    _grad_close([_np(t) for t in got], want, rtol=1e-5)


def _grad_inputs(n, carry, seed, tie=False):
    rng = np.random.default_rng(seed)
    b, h = 2, 3
    s = (rng.standard_normal((b, h, n)) * 2).astype(np.float32)
    v = rng.standard_normal((b, h, n, D)).astype(np.float32)
    if not carry:
        return s, v, None
    m = (rng.standard_normal((b, h)) + 6.0).astype(np.float32)
    if tie:  # the carry's max equals the row's max score exactly
        m = s.max(axis=-1)
    u = (np.abs(rng.standard_normal((b, h))) + 1.0).astype(np.float32)
    w = rng.standard_normal((b, h, D)).astype(np.float32)
    return s, v, (m, u, w)


def _jax_grads(s, v, carry, dtype, mode, monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_MODE", mode)
    jc = None if carry is None else JScanState(*(jnp.asarray(a)
                                                for a in carry))

    def loss(s_, v_, c_):
        o, fin = jops.aaren_prefix_attention(s_, v_, c_)
        return (jnp.sum(o.astype(jnp.float32) ** 2) + jnp.sum(fin.w ** 2)
                + jnp.sum(fin.u ** 2) + 0.1 * jnp.sum(fin.m))

    # One jit per call (the mode is read while tracing): eager jnp-mode
    # autodiff compiles every primitive of the scan anew.
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(s).astype(dtype), jnp.asarray(v).astype(dtype), jc)


def _port_grads(s, v, carry, dtype):
    st = torch.from_numpy(s).to(dtype).requires_grad_()
    vt = torch.from_numpy(v).to(dtype).requires_grad_()
    ct = None
    if carry is not None:
        ct = ScanState(*(torch.from_numpy(a).requires_grad_()
                         for a in carry))
    o, fin = ops.aaren_prefix_attention(st, vt, ct)
    assert o.dtype == dtype
    loss = (o.float().square().sum() + fin.w.square().sum()
            + fin.u.square().sum() + 0.1 * fin.m.sum())
    inputs = (st, vt) + (tuple(ct) if ct is not None else ())
    return torch.autograd.grad(loss, inputs)


@pytest.mark.parametrize("mode", ["jnp", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carry", [False, True], ids=["empty", "carry"])
def test_autograd_matches_jax_grad(carry, dtype, mode, monkeypatch):
    """torch.autograd through the port's aaren_prefix_attention ==
    jax.grad through the JAX package's, for s, v and the carry."""
    s, v, c = _grad_inputs(37, carry, seed=11)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _jax_grads(s, v, c, jdt, mode, monkeypatch)
    got = _port_grads(s, v, c, tdt)
    want = [want[0], want[1]] + ([] if c is None else list(want[2]))
    rtol = 2e-2 if dtype == "bfloat16" else 1e-4
    _grad_close([_np(t) for t in got], want, rtol=rtol)


@pytest.mark.parametrize("mode", ["jnp", "interpret"])
def test_autograd_exact_tie_matches_jax(mode, monkeypatch):
    """m0 equal to the row's max score: the m_f subgradient splits between
    the carry and the score exactly as JAX's does."""
    s, v, c = _grad_inputs(37, True, seed=12, tie=True)
    want = _jax_grads(s, v, c, jnp.float32, mode, monkeypatch)
    got = _port_grads(s, v, c, torch.float32)
    _grad_close([_np(t) for t in got], [want[0], want[1], *want[2]])


def test_cpu_training_path_launches_no_kernel():
    """Forward with residuals and backward on CPU tensors take the plain
    versions: no kernel launch is counted."""
    before = (aaren_scan.n_launches, aaren_scan_bwd.n_launches)
    s, v, c = _grad_inputs(7, True, seed=13)
    _port_grads(s, v, c, torch.float32)
    got = aaren_scan(*(_t(a) for a in _fwd_inputs(2, 5, D, True, seed=1)),
                     return_residuals=True)
    want = aaren_scan_plain(*(_t(a) for a in _fwd_inputs(2, 5, D, True,
                                                         seed=1)),
                            return_residuals=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (aaren_scan.n_launches, aaren_scan_bwd.n_launches) == before
