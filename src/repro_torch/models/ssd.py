"""Mamba-2 SSD (state-space duality) mixer — port of ``repro.models.ssd``.

Recurrence per head (state S ∈ R^{P×N}, head dim P, state dim N):

    a_t = exp(Δ_t · A)                       (A < 0 scalar per head)
    S_t = a_t · S_{t-1} + Δ_t · x_t ⊗ B_t
    y_t = S_t · C_t + D · x_t

Chunked evaluation (chunk Q): inside a chunk the quadratic "attention"
``M_{ts} = C_t · B_s · Δ_s · exp(cum_a_t - cum_a_s)`` (causal); across
chunks the per-chunk states, combined by a loop over the ``L / Q`` chunk
totals (the JAX package's ``jax.lax.associative_scan``), in f32.  The JAX
package evaluates all of it outside any Pallas kernel, so the port's is
plain PyTorch too.  The chunked core and ``s`` are f32, the conv runs in
the compute dtype, and ``exp`` is applied after ``where(mask, decay,
-inf)``, so no upper-triangle decay is ever exponentiated.

The decode state is ``{"s": (B, H, P, N) f32, "conv": (B, d_conv - 1,
d_inner + 2N)}`` in the compute dtype, the batch on axis 0 of both.
Unlike the JAX package, :func:`ssd_sequence` left-pads the conv tail with
zeros when the prompt is shorter than ``d_conv - 1`` tokens, so the tail
always has its fixed shape and a step after a 1- or 2-token prefill equals
the full forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.param import ParamSpec

_CHUNK = 256


def ssd_dims(cfg: ArchConfig):
    d_in = cfg.d_inner
    n_heads = cfg.ssm_heads or (d_in // 64)
    p = d_in // n_heads
    n = cfg.ssm_state
    return d_in, n_heads, p, n


def ssd_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    d_in, h, p, n = ssd_dims(cfg)
    conv_ch = d_in + 2 * n  # conv runs over [x, B, C]
    w = cfg.d_conv
    return {
        # packed in-projection: [z (d_in), x (d_in), B (n), C (n), dt (h)]
        "w_in": ParamSpec((d, 2 * d_in + 2 * n + h)),
        "conv": ParamSpec((w, conv_ch), scale=1.0 / w ** 0.5),
        "conv_bias": ParamSpec((conv_ch,), init="zeros"),
        "a_log": ParamSpec((h,), init="normal", scale=0.5),
        "dt_bias": ParamSpec((h,), init="zeros"),
        "d_skip": ParamSpec((h,), init="ones"),
        "norm_scale": ParamSpec((d_in,), init="ones"),
        "w_out": ParamSpec((d_in, d)),
    }


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    d_in, h, p, n = ssd_dims(cfg)
    return torch.split(proj, [d_in, d_in, n, n, h], dim=-1)


def _conv_sequence(p: dict, u: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, L, C) in u's dtype, then SiLU in f32."""
    w = p["conv"].shape[0]
    pad = F.pad(u, (0, 0, w - 1, 0))
    out = sum(pad[:, i:i + u.shape[1], :] * p["conv"][i].to(u.dtype)
              for i in range(w))
    return F.silu((out + p["conv_bias"].to(u.dtype)).float())


def _gated_rmsnorm(p: dict, y: torch.Tensor, z: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    yf = y.float() * F.silu(z.float())
    var = yf.square().mean(dim=-1, keepdim=True)
    return yf * torch.rsqrt(var + eps) * p["norm_scale"].float()


def ssd_state_init(cfg: ArchConfig, batch: int, device) -> dict:
    d_in, h, p, n = ssd_dims(cfg)
    conv_ch = d_in + 2 * n
    return {"s": torch.zeros((batch, h, p, n), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.d_conv - 1, conv_ch),
                                dtype=getattr(torch, cfg.compute_dtype),
                                device=device)}


def _ssd_chunked(xh: torch.Tensor, bh: torch.Tensor, ch: torch.Tensor,
                 dt: torch.Tensor, a_log: torch.Tensor,
                 s0: torch.Tensor | None = None, chunk: int = _CHUNK):
    """Chunked SSD core.

    xh: (B, L, H, P) f32, bh/ch: (B, L, N) f32, dt: (B, L, H) f32 (post-
    softplus), a_log: (H,) — decay is exp(-dt*exp(a_log)) < 1.
    Returns y: (B, L, H, P) and final state (B, H, P, N).
    """
    bsz, l, h, p = xh.shape
    n = bh.shape[-1]
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"L={l} not divisible by chunk={q}")
    nc = l // q

    a = -torch.exp(a_log.float())                       # (H,) negative
    ca = torch.cumsum((dt * a).reshape(bsz, nc, q, h), dim=2)
    xc = xh.reshape(bsz, nc, q, h, p)
    bc = bh.reshape(bsz, nc, q, n)
    cc = ch.reshape(bsz, nc, q, n)
    dtc = dt.reshape(bsz, nc, q, h)

    # ---- intra-chunk (quadratic within the chunk, like a masked attention)
    # M[b,c,h,t,s] = (C_t . B_s) * dt_s * exp(ca_t - ca_s), s <= t
    cb = torch.einsum("bctn,bcsn->bcts", cc, bc)                # (B,nc,Q,Q)
    cat_ = ca.permute(0, 1, 3, 2)                               # (B,nc,H,Q)
    decay = cat_[..., :, None] - cat_[..., None, :]             # (B,nc,H,Q,Q)
    mask = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    m = cb[:, :, None] * torch.exp(torch.where(mask, decay, -torch.inf))
    m = m * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]           # x dt_s
    y_intra = m @ xc.permute(0, 1, 3, 2, 4)                     # (B,nc,H,Q,P)

    # ---- chunk states: S_c = sum_s exp(ca_end - ca_s) dt_s x_s B_s^T
    decay_to_end = torch.exp(ca[:, :, -1:, :] - ca)             # (B,nc,Q,H)
    xw = xc * (decay_to_end * dtc)[..., None]
    sc = torch.einsum("bcshp,bcsn->bchpn", xw, bc)

    # ---- inter-chunk recurrence over the chunk totals, in f32; the state
    # entering chunk c is the one after chunk c-1 (s0 before chunk 0)
    chunk_decay = torch.exp(ca[:, :, -1, :])                    # (B,nc,H)
    s = (s0.float() if s0 is not None
         else torch.zeros((bsz, h, p, n), dtype=torch.float32,
                          device=xh.device))
    s_prev = []
    for c in range(nc):
        s_prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + sc[:, c]
    s_prev = torch.stack(s_prev, dim=1)                         # (B,nc,H,P,N)

    # ---- inter-chunk contribution: y_t += C_t . (decay_to_t * S_prev)
    y_inter = torch.einsum("bctn,bchpn->bchtp", cc, s_prev)
    y_inter = y_inter * torch.exp(cat_)[..., None]
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(bsz, l, h, p)
    return y, s


def ssd_sequence(pp: dict, x: torch.Tensor, cfg: ArchConfig):
    """(B, L, D) -> (B, L, D), plus the decode state (s, conv tail)."""
    d_in, h, p, n = ssd_dims(cfg)
    proj = x @ pp["w_in"].to(x.dtype)
    z, xs, b, c, dt = _split_proj(cfg, proj)
    u0 = torch.cat([xs, b, c], dim=-1)
    u = _conv_sequence(pp, u0)                          # f32 (B, L, d_in + 2n)
    xs, b, c = torch.split(u, [d_in, n, n], dim=-1)
    dt = F.softplus(dt.float() + pp["dt_bias"].float())
    xh = xs.reshape(x.shape[0], x.shape[1], h, p)
    y, s_final = _ssd_chunked(xh, b, c, dt, pp["a_log"])
    y = y + pp["d_skip"].float()[None, None, :, None] * xh
    y = _gated_rmsnorm(pp, y.reshape(x.shape[0], x.shape[1], d_in), z)
    out = y.to(x.dtype) @ pp["w_out"].to(x.dtype)
    w = cfg.d_conv
    tail = F.pad(u0, (0, 0, w - 1, 0))[:, -(w - 1):]
    state = {"s": s_final,
             "conv": tail.to(getattr(torch, cfg.compute_dtype))}
    return out, state


def ssd_step(pp: dict, x_t: torch.Tensor, state: dict, cfg: ArchConfig):
    """One-token O(1) update.  x_t: (B, 1, D)."""
    d_in, h, p, n = ssd_dims(cfg)
    proj = x_t @ pp["w_in"].to(x_t.dtype)
    z, xs, b, c, dt = _split_proj(cfg, proj)
    u0 = torch.cat([xs, b, c], dim=-1)                  # (B, 1, conv_ch)
    window = torch.cat([state["conv"].to(u0.dtype), u0], dim=1)
    wlen = pp["conv"].shape[0]
    u = sum(window[:, i, :] * pp["conv"][i].to(u0.dtype)
            for i in range(wlen))
    u = F.silu((u + pp["conv_bias"].to(u0.dtype)).float())
    xs, b, c = torch.split(u, [d_in, n, n], dim=-1)     # (B, ...)
    dt = F.softplus(dt[:, 0].float() + pp["dt_bias"].float())    # (B, H)
    a = torch.exp(dt * -torch.exp(pp["a_log"].float()))          # (B, H)
    xh = xs.reshape(-1, h, p)
    s_new = (state["s"] * a[..., None, None]
             + (dt[..., None] * xh)[..., None] * b[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", s_new, c)
    y = y + pp["d_skip"].float()[None, :, None] * xh
    y = _gated_rmsnorm(pp, y.reshape(-1, 1, d_in), z)
    out = y.to(x_t.dtype) @ pp["w_out"].to(x_t.dtype)
    new_state = {"s": s_new, "conv": window[:, 1:, :].to(
        getattr(torch, cfg.compute_dtype))}
    return out, new_state
