"""Device choice for the port's entry points.

Entry points take ``device="cuda"`` by default and run on the card.  With
no card they raise instead of carrying on quietly on the CPU; a caller who
wants the CPU (the parity tests) asks for ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain torch path on the CPU")
    return dev
