"""Serving: constant-memory streaming engine, batched generation, the
prefix-carry cache and the replicated router."""

from repro_torch.serving.engine import (  # noqa: F401
    ERR_DEADLINE,
    ERR_POISONED,
    EngineOverloaded,
    StreamingEngine,
    decode_state_bytes,
    generate,
)
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: F401
from repro_torch.serving.router import (  # noqa: F401
    POLICIES,
    ReplicatedRouter,
    ReplicaView,
)
from repro_torch.serving.sampler import (  # noqa: F401
    greedy_sampler,
    request_seed,
    temperature_sampler,
)
