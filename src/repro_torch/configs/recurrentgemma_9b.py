"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 ratio.
[arXiv:2402.19427 (Griffin)]"""

from repro_torch.configs.base import ArchConfig, register


@register
def recurrentgemma_9b() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,  # 12 (rglru, rglru, attn_local) periods + 2 remainder
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,  # MQA
        head_dim=256,
        d_ff=12288,
        vocab=256000,
        pattern=("rglru", "rglru", "attn_local"),
        mlp_pattern=("swiglu",) * 3,
        window=2048,
        rnn_width=4096,
        d_conv=4,
        rope_theta=10000.0,
        norm="rmsnorm",
        tie_embeddings=True,
        optimizer="adamw",
        remat="block",
        notes="RG-LRU blocks are already O(1)-state RNNs; the aaren rewrite "
              "applies to the attention third only.  long_500k runnable: "
              "bounded state (RG-LRU h + window cache / aaren carry).",
    )
