"""Architecture configuration schema and registry (the port's own copy).

A field-for-field copy of ``repro.configs.base.ArchConfig`` so that the port
imports nothing of the JAX package; ``tests/test_torch_model.py`` fails if
the two drift apart.  Each architecture the port serves is an
:class:`ArchConfig` in its own module under ``repro_torch/configs``;
``get_config(name)`` resolves them.  ``attn_mode='aaren'`` replaces
softmax-attention mixers with Aaren prefix-scan attention — the only mode
the port runs so far.
"""

from __future__ import annotations

import dataclasses
from typing import Any

# Mixer kinds.  'attn' = global softmax self-attention, 'attn_local' =
# sliding-window softmax attention, 'aaren' = the paper's module, 'rglru' =
# RG-LRU recurrent block (Griffin/RecurrentGemma), 'ssd' = Mamba-2 state-space
# duality block.
MIXERS = ("attn", "attn_local", "aaren", "rglru", "ssd")
MLPS = ("swiglu", "gelu", "moe", "none")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int | None = None  # default: d_model // n_heads

    # Repeating layer pattern (scanned over periods; remainder unrolled).
    pattern: tuple[str, ...] = ("attn",)
    mlp_pattern: tuple[str, ...] = ("swiglu",)
    window: int = 4096  # sliding-window size for 'attn_local'

    # The paper's switch: 'aaren' rewrites attention mixers to Aaren.
    attn_mode: str = "aaren"
    # Whether local-attention mixers are also rewritten (DESIGN.md §4).
    aaren_replaces_local: bool = True

    # MoE
    n_experts: int = 0
    n_experts_per_tok: int = 0
    moe_d_ff: int = 0  # per-expert hidden size (qwen3's 768 is per expert)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0

    # SSM (mamba2)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_heads: int = 0  # number of SSD heads (d_inner / ssd head_dim)

    # RG-LRU (recurrentgemma)
    rnn_width: int = 0  # d_rnn; 0 -> d_model

    # Encoder-decoder (whisper)
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500  # stub frame-embedding count for the encoder

    # VLM (phi3-vision): number of stub patch-embedding tokens prepended.
    vision_tokens: int = 0

    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # Numerics / memory policy (per-arch so 405B-class fits the pod)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"  # adamw | adamw_bf16 | adafactor
    remat: str = "block"  # none | block (checkpoint each scanned period)
    # scan vs unroll over layer periods.  Scan = one HLO body (fast compiles,
    # production default).  The dry-run's cost probe unrolls a 1- and
    # 2-period variant because HloCostAnalysis counts while-loop bodies once
    # (see launch/dryrun.py).
    scan_layers: bool = True

    # Default microbatch count for train_4k (overridable per run)
    n_microbatches: int = 8

    notes: str = ""

    def __post_init__(self):
        if len(self.pattern) != len(self.mlp_pattern):
            raise ValueError("pattern and mlp_pattern must have equal length")
        for m in self.pattern:
            if m not in MIXERS:
                raise ValueError(f"unknown mixer {m!r}")
        for m in self.mlp_pattern:
            if m not in MLPS:
                raise ValueError(f"unknown mlp {m!r}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.expand * self.d_model

    @property
    def d_rnn(self) -> int:
        return self.rnn_width or self.d_model

    def effective_pattern(self) -> tuple[str, ...]:
        """Mixer pattern after applying the paper's Aaren rewrite."""
        if self.attn_mode != "aaren":
            return self.pattern
        out = []
        for m in self.pattern:
            if m == "attn":
                out.append("aaren")
            elif m == "attn_local" and self.aaren_replaces_local:
                out.append("aaren")
            else:
                out.append(m)
        return tuple(out)

    def layer_plan(self) -> tuple[int, int]:
        """(n_full_periods, n_remainder_layers) for scan-over-layers."""
        return divmod(self.n_layers, len(self.pattern))

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: dict[str, Any] = {}


def register(fn):
    """Decorator: config factory; registered under the config's exact id."""
    _REGISTRY[fn().name] = fn
    return fn


def get_config(name: str, **overrides) -> ArchConfig:
    if name not in _REGISTRY:
        # import all config modules lazily on first miss
        import repro_torch.configs  # noqa: F401  (triggers registration)
    key = name if name in _REGISTRY else name.replace("_", "-")
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[key]()
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
