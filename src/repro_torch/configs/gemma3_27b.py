"""gemma3-27b [dense] — 5:1 local:global attention, 256k vocab.
[hf:google/gemma-3-*-pt]"""

from repro_torch.configs.base import ArchConfig, register


@register
def gemma3_27b() -> ArchConfig:
    return ArchConfig(
        name="gemma3-27b",
        family="dense",
        n_layers=62,  # 10 full (5 local + 1 global) periods + 2 remainder
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab=262144,
        pattern=("attn_local",) * 5 + ("attn",),
        mlp_pattern=("swiglu",) * 6,
        window=1024,
        rope_theta=1000000.0,
        norm="rmsnorm",
        tie_embeddings=True,
        optimizer="adamw",
        remat="block",
        notes="5:1 local:global; aaren rewrite applies to both kinds "
              "(aaren_replaces_local=True default).",
    )
