"""Seeded fault injection for the training half of the chaos suite —
port of ``repro.testing.faults``.

Every injector reproduces, at a controlled point, a failure class the
fault-tolerance layer claims to survive:

* :func:`corrupt_checkpoint` — storage faults on a *committed* step
  directory (bit flip, truncated chunk, deleted manifest/chunk) plus the
  killed-mid-save ``stale_tmp`` artifact.  Restore must detect all of them
  and fall back to the newest intact step.
* :func:`faulty_loss` / :class:`FaultyLMIterator` — numerics faults inside
  the train step: the iterator stamps a ``"_fault_scale"`` scalar into
  chosen batches (NaN on fault batches, 1.0 otherwise — the 0-d leaf rides
  through the microbatch split unchanged), and the loss wrapper multiplies
  the loss by it, poisoning loss *and* grads exactly the way an fp
  overflow would.  The guard must skip those steps and keep training.
* :func:`send_preemption` / :class:`PreemptingIterator` — a real SIGTERM to
  the current process (not a loop test-hook), exercising the actual signal
  handler → drain → sync-checkpoint path.

The serving injectors (``poison_engine_slot``, ``kill_router_replica``)
come with the port's serving tier (ROADMAP queue A item 9).  Injection
points are deterministic (seeded RNG / explicit step indices): every chaos
test replays bit-identically.
"""

from __future__ import annotations

import os
import signal
import zlib
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.checkpoint.io import latest_step

#: checkpoint fault taxonomy (DESIGN.md §Fault-tolerance)
FAULT_KINDS = (
    "flip_byte",        # single bit-flip in a chunk's data region (crc catch)
    "truncate_chunk",   # chunk file cut short (torn write / partial fsync)
    "delete_chunk",     # chunk file missing entirely
    "delete_manifest",  # killed after chunks, before the manifest write
    "stale_tmp",        # killed mid-save: orphan .tmp-step_* staging dir
)


# ---------------------------------------------------------------------------
# Checkpoint storage faults
# ---------------------------------------------------------------------------

def corrupt_checkpoint(directory: str, step: int | None = None,
                       kind: str = "flip_byte", *, seed: int = 0) -> str:
    """Inject a storage fault into a committed checkpoint step.

    ``step=None`` targets the newest step.  Returns the path that was
    damaged (chunk file, manifest, or the created tmp dir) so tests can
    assert on it.  Chunk choice is seeded — deterministic per ``seed``.
    """
    if kind not in FAULT_KINDS:
        raise ValueError(f"kind must be one of {FAULT_KINDS}, got {kind!r}")
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    src = os.path.join(directory, f"step_{step:012d}")

    if kind == "stale_tmp":
        # A save killed mid-write strands `.tmp-step_*` with some chunks and
        # no manifest; restore must ignore it entirely.
        tmp = os.path.join(directory, f".tmp-step_{step + 1:012d}")
        os.makedirs(tmp, exist_ok=True)
        part = os.path.join(tmp, "leaf_00000_00000000.npy")
        with open(part, "wb") as f:
            f.write(b"\x93NUMPY partial garbage")
        return tmp

    if not os.path.isdir(src):
        raise FileNotFoundError(f"no checkpoint step directory {src}")

    if kind == "delete_manifest":
        target = os.path.join(src, "manifest.json")
        os.remove(target)
        return target

    rng = np.random.default_rng(seed)
    chunks = sorted(f for f in os.listdir(src) if f.startswith("leaf_"))
    if not chunks:
        raise FileNotFoundError(f"{src}: no chunk files to corrupt")
    target = os.path.join(src, chunks[int(rng.integers(len(chunks)))])

    if kind == "delete_chunk":
        os.remove(target)
    elif kind == "truncate_chunk":
        size = os.path.getsize(target)
        with open(target, "r+b") as f:
            f.truncate(max(size // 2, 1))
    elif kind == "flip_byte":
        # Flip one bit in the final byte — always payload, never the .npy
        # header, so the file still loads and only the crc catches it.
        with open(target, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            byte = f.read(1)[0]
            f.seek(-1, os.SEEK_END)
            f.write(bytes([byte ^ 0x01]))
    return target


def checkpoint_crc_ok(directory: str, step: int) -> bool:
    """Cheap standalone crc sweep (no restore) — handy in assertions."""
    import json

    src = os.path.join(directory, f"step_{step:012d}")
    try:
        with open(os.path.join(src, "manifest.json")) as f:
            manifest = json.load(f)
        for rec in manifest["leaves"]:
            for chunk in rec["chunks"]:
                piece = np.load(os.path.join(src, chunk["file"]))
                if zlib.crc32(piece.tobytes()) != chunk["crc32"]:
                    return False
    except Exception:
        return False
    return True


# ---------------------------------------------------------------------------
# Training numerics faults
# ---------------------------------------------------------------------------

def faulty_loss(loss_fn: Callable) -> Callable:
    """Wrap ``loss_fn(params, batch)`` to honor a ``"_fault_scale"`` leaf.

    The scale multiplies the loss *inside* the differentiated function, so a
    NaN scale poisons the loss and every gradient — the same blast radius as
    a real fp overflow.  Batches without the leaf (or scale 1.0) are
    bit-identical to the unwrapped loss (x * 1.0 == x in IEEE 754).
    """

    def wrapped(params, batch):
        batch = dict(batch)
        scale = batch.pop("_fault_scale", None)
        loss, metrics = loss_fn(params, batch)
        if scale is not None:
            loss = loss * torch.as_tensor(
                scale, dtype=loss.dtype, device=loss.device).reshape(())
        return loss, metrics

    return wrapped


class FaultyLMIterator:
    """Wrap a data iterator; stamp NaN ``"_fault_scale"`` on chosen batches.

    ``nan_at``: iterable of batch indices (by draw order, resume-aware) that
    receive a NaN scale; every other batch carries scale 1.0.  ``scale_at``
    maps indices to arbitrary finite scales (e.g. 1e6 to provoke a grad-norm
    spike without non-finiteness).  Pair with :func:`faulty_loss` on the
    model's loss.  Delegates the ``state()`` / ``restore()`` checkpoint
    protocol, persisting its own draw counter.
    """

    def __init__(self, base, nan_at: Iterable[int] = (),
                 scale_at: dict[int, float] | None = None):
        self.base = base
        self.nan_at = frozenset(int(i) for i in nan_at)
        self.scale_at = {int(k): float(v)
                         for k, v in (scale_at or {}).items()}
        self._i = 0

    def state(self) -> dict:
        return {"base": self.base.state(), "i": self._i}

    def restore(self, state: dict):
        self.base.restore(state["base"])
        self._i = int(state["i"])

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = dict(next(self.base))
        if self._i in self.nan_at:
            scale = np.nan
        else:
            scale = self.scale_at.get(self._i, 1.0)
        batch["_fault_scale"] = np.asarray(scale, np.float32)
        self._i += 1
        return batch


# ---------------------------------------------------------------------------
# Preemption
# ---------------------------------------------------------------------------

def send_preemption(signum: int = signal.SIGTERM) -> None:
    """Deliver a real preemption signal to this process (not a test hook)."""
    os.kill(os.getpid(), signum)


class PreemptingIterator:
    """Wrap a data iterator; SIGTERM the process after ``preempt_after``
    draws.  The train loop's handler must finish the in-flight step, write a
    sync checkpoint, and exit cleanly — the k8s/TPU grace-period path.
    Delegates ``state()`` / ``restore()``."""

    def __init__(self, base, preempt_after: int,
                 signum: int = signal.SIGTERM):
        self.base = base
        self.preempt_after = int(preempt_after)
        self.signum = signum
        self._i = 0

    def state(self) -> dict:
        return {"base": self.base.state(), "i": self._i}

    def restore(self, state: dict):
        self.base.restore(state["base"])
        self._i = int(state["i"])

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = next(self.base)
        self._i += 1
        if self._i == self.preempt_after:
            send_preemption(self.signum)
        return batch
