"""Fault injection for the port's chaos tests (training half)."""

from repro_torch.testing.faults import (  # noqa: F401
    FAULT_KINDS,
    FaultyLMIterator,
    PreemptingIterator,
    checkpoint_crc_ok,
    corrupt_checkpoint,
    faulty_loss,
    send_preemption,
)
