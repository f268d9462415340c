"""RG-LRU recurrent block (Griffin / RecurrentGemma) — port of
``repro.models.rglru``.

The recurrence  h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ u_t)  is a
first-order linear RNN: the JAX package evaluates it with
``jax.lax.associative_scan`` (operator on pairs (a₂a₁, a₂b₁ + b₂)), outside
any Pallas kernel, so the port's scan is plain PyTorch too: a chunked scan
(:func:`_linear_scan`), log-depth doubling inside each chunk and a carry
across chunks, all in f32.  Decode is the O(1) one-token update.

Block layout (Griffin):
    y = W_out( GeLU(W_gate x) ⊙ RGLRU( CausalConv1D_4(W_x x) ) )

The decode state is ``{"h": (B, R) f32, "conv": (B, d_conv - 1, R)}`` in
the compute dtype, the batch on axis 0 of both.  Unlike the JAX package,
:func:`rglru_sequence` left-pads the conv tail with zeros when the prompt
is shorter than ``d_conv - 1`` tokens, so the tail always has its fixed
shape and a step after a 1- or 2-token prefill equals the full forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.param import ParamSpec

_C = 8.0  # Griffin's fixed recurrence sharpness constant
_BLOCK = 256  # block-diagonal gate width (official RecurrentGemma layout)
_SCAN_CHUNK = 64  # tokens a chunk of the chunked scan


def rglru_specs(cfg: ArchConfig) -> dict:
    d, r = cfg.d_model, cfg.d_rnn
    w = cfg.d_conv  # temporal conv width (4)
    nb = max(r // _BLOCK, 1)
    bw = r // nb
    return {
        "wx": ParamSpec((d, r)),
        "wgate": ParamSpec((d, r)),
        "conv": ParamSpec((w, r), scale=1.0 / w ** 0.5),
        "conv_bias": ParamSpec((r,), init="zeros"),
        # block-diagonal recurrence/input gates: (n_blocks, bw, bw)
        "w_rgate": ParamSpec((nb, bw, bw), scale=0.02),
        "b_rgate": ParamSpec((r,), init="zeros"),
        "w_igate": ParamSpec((nb, bw, bw), scale=0.02),
        "b_igate": ParamSpec((r,), init="zeros"),
        "lam": ParamSpec((r,), init="normal", scale=0.5),
        "wo": ParamSpec((r, d)),
    }


def _causal_conv_sequence(p: dict, u: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, N, R) with a width-w kernel."""
    w = p["conv"].shape[0]
    pad = F.pad(u, (0, 0, w - 1, 0))
    out = sum(pad[:, i:i + u.shape[1], :] * p["conv"][i].to(u.dtype)
              for i in range(w))
    return out + p["conv_bias"].to(u.dtype)


def _block_diag_matmul(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u: (..., R) x block-diag w: (nb, bw, bw) -> (..., R)."""
    nb, bw, _ = w.shape
    ub = u.reshape(u.shape[:-1] + (nb, bw))
    return torch.einsum("...nb,nbc->...nc", ub, w).reshape(u.shape)


def _gates(p: dict, u: torch.Tensor):
    """The decay ``a`` and the scaled input ``b`` of the recurrence, f32."""
    uf = u.float()
    r = torch.sigmoid(_block_diag_matmul(uf, p["w_rgate"].float())
                      + p["b_rgate"].float())
    i = torch.sigmoid(_block_diag_matmul(uf, p["w_igate"].float())
                      + p["b_igate"].float())
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * uf)
    return a, b


def _doubling_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of (a, b) pairs along axis -2 under
    (a₂a₁, a₂b₁ + b₂), in log2(n) doubling steps (Hillis–Steele).
    Returns (the products of a, h)."""
    n = a.shape[-2]
    k = 1
    while k < n:
        b = torch.cat([b[..., :k, :],
                       a[..., k:, :] * b[..., :-k, :] + b[..., k:, :]], -2)
        a = torch.cat([a[..., :k, :], a[..., k:, :] * a[..., :-k, :]], -2)
        k *= 2
    return a, b


def _scan_pairs(a: torch.Tensor, b: torch.Tensor, chunk: int):
    """(B, N, R) pairs -> their inclusive scan (products of a, h): a
    doubling scan inside each chunk of ``chunk`` tokens, then each chunk
    offset by the carry at the end of the chunks before it, those carries
    being the same scan one level up over the chunks' totals."""
    bsz, n, r = a.shape
    if n <= chunk:
        return _doubling_scan(a, b)
    nc = -(-n // chunk)
    pad = nc * chunk - n
    if pad:  # identity pairs (1, 0) fill the last chunk
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
    a_c, h_c = _doubling_scan(a.reshape(bsz, nc, chunk, r),
                              b.reshape(bsz, nc, chunk, r))
    a_tot, h_tot = _scan_pairs(a_c[:, :, -1], h_c[:, :, -1], chunk)
    # The carry into chunk c is the scan over chunks 0..c-1.
    h_in = F.pad(h_tot[:, :-1], (0, 0, 1, 0))
    a_in = F.pad(a_tot[:, :-1], (0, 0, 1, 0), value=1.0)
    h = h_c + a_c * h_in[:, :, None, :]
    a_s = a_c * a_in[:, :, None, :]
    return (a_s.reshape(bsz, nc * chunk, r)[:, :n],
            h.reshape(bsz, nc * chunk, r)[:, :n])


def _linear_scan(a: torch.Tensor, b: torch.Tensor,
                 h0: torch.Tensor | None = None,
                 chunk: int = _SCAN_CHUNK) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 (f32), from ``h0`` (B, R) or 0.

    No Python loop over tokens, and no division: a running product of
    decays underflows f32 to 0 within tens of tokens (log a = −8 ·
    softplus(λ) · r), so ``cumsum(b / cumprod(a))`` would turn it into
    inf/NaN; here every step only multiplies and adds."""
    a_s, h = _scan_pairs(a, b, chunk)
    if h0 is not None:
        h = h + a_s * h0[:, None, :]
    return h


def rglru_state_init(cfg: ArchConfig, batch: int, device) -> dict:
    r, w = cfg.d_rnn, cfg.d_conv
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, w - 1, r),
                                dtype=getattr(torch, cfg.compute_dtype),
                                device=device)}


def _gate(p: dict, x: torch.Tensor) -> torch.Tensor:
    return F.gelu((x @ p["wgate"].to(x.dtype)).float(), approximate="tanh")


def rglru_sequence(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """(B, N, D) -> (B, N, D), plus the decode state (h, conv tail)."""
    u0 = x @ p["wx"].to(x.dtype)
    u = _causal_conv_sequence(p, u0)
    a, b = _gates(p, u)
    h = _linear_scan(a, b)
    y = (h * _gate(p, x)).to(x.dtype) @ p["wo"].to(x.dtype)
    w = cfg.d_conv
    tail = F.pad(u0, (0, 0, w - 1, 0))[:, -(w - 1):]
    state = {"h": h[:, -1, :],
             "conv": tail.to(getattr(torch, cfg.compute_dtype))}
    return y, state


def rglru_step(p: dict, x_t: torch.Tensor, state: dict, cfg: ArchConfig):
    """One-token O(1) update.  x_t: (B, 1, D)."""
    u0 = x_t @ p["wx"].to(x_t.dtype)                              # (B, 1, R)
    window = torch.cat([state["conv"].to(u0.dtype), u0], dim=1)
    w = p["conv"].shape[0]
    u = sum(window[:, i, :] * p["conv"][i].to(u0.dtype) for i in range(w))
    u = (u + p["conv_bias"].to(u0.dtype))[:, None, :]
    a, b = _gates(p, u)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = (h[:, None, :] * _gate(p, x_t)).to(x_t.dtype) @ p["wo"].to(x_t.dtype)
    new_state = {"h": h, "conv": window[:, 1:, :].to(
        getattr(torch, cfg.compute_dtype))}
    return y, new_state
