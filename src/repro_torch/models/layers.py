"""Primitive layers: norms, MLPs, embeddings — port of ``repro.models.layers``.

Norms, the SwiGLU/GELU nonlinearities and the unembedding run in f32 and
cast back to the activation dtype, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.param import ParamSpec

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_specs(d: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": ParamSpec((d,), init="ones")}
    if kind == "layernorm":
        return {"scale": ParamSpec((d,), init="ones"),
                "bias": ParamSpec((d,), init="zeros")}
    raise ValueError(kind)


def apply_norm(p: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    elif kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].float() + p["bias"].float()
    else:
        raise ValueError(kind)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu_specs(d: int, f: int) -> dict:
    return {"wi_gate": ParamSpec((d, f)), "wi_up": ParamSpec((d, f)),
            "wo": ParamSpec((f, d))}


def apply_swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    gate = x @ p["wi_gate"].to(x.dtype)
    up = x @ p["wi_up"].to(x.dtype)
    h = F.silu(gate.float()).to(x.dtype) * up
    return h @ p["wo"].to(x.dtype)


def gelu_mlp_specs(d: int, f: int) -> dict:
    return {"wi": ParamSpec((d, f)), "wo": ParamSpec((f, d))}


def apply_gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["wi"].to(x.dtype)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_specs(vocab: int, d: int) -> dict:
    return {"table": ParamSpec((vocab, d), init="embed")}


def apply_embed(p: dict, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return p["table"][tokens].to(compute_dtype)


def unembed_specs(vocab: int, d: int) -> dict:
    return {"kernel": ParamSpec((d, vocab))}


def apply_unembed(p: dict | None, embed_p: dict, x: torch.Tensor,
                  softcap: float = 0.0) -> torch.Tensor:
    """Logits in f32.  ``p is None`` -> tied to the embedding table."""
    if p is None:
        logits = x.float() @ embed_p["table"].float().T
    else:
        logits = x.float() @ p["kernel"].float()
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
