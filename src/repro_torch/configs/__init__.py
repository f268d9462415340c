"""Config registry: the architectures the port serves."""

from repro_torch.configs import aaren_paper, phi3_mini_3p8b  # noqa: F401  (registration)
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    get_config,
)
from repro_torch.configs.smoke import smoke_config  # noqa: F401
