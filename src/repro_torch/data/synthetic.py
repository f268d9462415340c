"""Synthetic token stream for training — a copy of
``repro.data.synthetic.SyntheticLMIterator`` (numpy only, so the port
imports nothing of the JAX package; ``tests/test_torch_train.py`` holds the
two equal batch for batch).

* **Determinism** — row ``r`` of batch ``i`` is a pure function of
  ``(seed, i, r)`` with ``r`` a *global* row index: restart-safe and
  independent of the host topology.
* **Per-host sharding** — host ``h`` draws global rows
  ``[h·B/H, (h+1)·B/H)``: the union of the host slices is the single-host
  global batch.
* **Restorable** — ``state()``/``restore()`` round-trip the batch counter.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLMIterator:
    """Token stream with learnable structure (order-k Markov mixture).

    A fixed random transition table (from ``seed``) plus an induction-head
    pattern: with probability ``copy_p`` the next token repeats the token
    seen ``lag`` positions ago.  Both structures are learnable by small
    models, so loss curves are meaningful.
    """

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    copy_p: float = 0.5
    lag: int = 8
    _count: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab, 512)  # transition table over a capped alphabet
        self._v = v
        logits = rng.standard_normal((v, v)) * 2.0
        self._probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)

    def state(self) -> dict:
        return {"count": self._count}

    def restore(self, state: dict):
        self._count = int(state["count"])

    def __iter__(self):
        return self

    def _sample_row(self, i: int, row: int) -> np.ndarray:
        """Row ``row`` (a *global* batch index) of batch ``i`` — a pure
        function of ``(seed, i, row)``."""
        rng = np.random.default_rng((self.seed, i, row))
        toks = np.zeros(self.seq_len, np.int64)
        toks[0] = rng.integers(0, self._v)
        unif = rng.random(self.seq_len)
        for t in range(1, self.seq_len):
            nxt = rng.choice(self._v, p=self._probs[toks[t - 1]])
            if t > self.lag and unif[t] < self.copy_p:
                nxt = toks[t - self.lag]
            toks[t] = nxt
        return toks

    def __next__(self) -> dict:
        i = self._count
        self._count += 1
        b = self.batch // self.num_hosts
        rows = range(self.host_id * b, (self.host_id + 1) * b)
        toks = np.stack([self._sample_row(i, r) for r in rows])
        return {
            "tokens": toks.astype(np.int32),
            "loss_mask": np.ones((b, self.seq_len), np.float32),
        }
