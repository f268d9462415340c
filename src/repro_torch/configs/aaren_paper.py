"""The paper's own model scale: the Aaren stack used in its four settings
(Appendix E: embedding dim 512, 4 heads, 4 blocks — the RL configuration from
Zheng et al. (2022); ~3.15M params matching §4.5's parameter-count analysis).
"""

from repro_torch.configs.base import ArchConfig, register


@register
def aaren_paper() -> ArchConfig:
    return ArchConfig(
        name="aaren-paper",
        family="dense",
        n_layers=4,
        d_model=512,
        n_heads=4,
        n_kv_heads=4,
        d_ff=2048,
        vocab=1024,          # task-token vocabulary (settings are non-LM)
        pattern=("attn",),
        mlp_pattern=("gelu",),
        norm="layernorm",
        attn_mode="aaren",
        optimizer="adamw",
        remat="none",
        param_dtype="float32",
        compute_dtype="float32",
        notes="Paper-faithful module scale for the 38-dataset comparisons.",
    )
