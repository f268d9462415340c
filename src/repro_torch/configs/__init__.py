"""Config registry: the architectures the port serves."""

from repro_torch.configs import (  # noqa: F401  (import for registration)
    aaren_paper,
    dbrx_132b,
    gemma3_27b,
    llama3_405b,
    mamba2_1p3b,
    minitron_8b,
    phi3_mini_3p8b,
    qwen3_moe_30b_a3b,
    recurrentgemma_9b,
)
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    get_config,
)
from repro_torch.configs.smoke import smoke_config  # noqa: F401
