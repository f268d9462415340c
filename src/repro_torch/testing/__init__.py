"""Fault injection for the port's chaos tests."""

from repro_torch.testing.faults import (  # noqa: F401
    FAULT_KINDS,
    FaultyLMIterator,
    PreemptingIterator,
    checkpoint_crc_ok,
    corrupt_checkpoint,
    faulty_loss,
    kill_router_replica,
    poison_engine_slot,
    send_preemption,
)
