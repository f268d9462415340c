"""Synthetic data generators — copies of ``repro.data.synthetic``'s
``SyntheticLMIterator``, ``CopyTaskIterator``, ``TimeSeriesGenerator`` and
``EventStreamGenerator`` (numpy only, so the port imports nothing of the
JAX package; ``tests/test_torch_train.py`` and ``tests/test_torch_tasks.py``
hold each bit-equal to its original).  The paper's datasets are not
redistributable offline; these streams have the same task structure.

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


@dataclasses.dataclass
class CopyTaskIterator:
    """Pure induction task: [prompt | SEP | prompt] — fast to learn, used by
    quickstart + integration tests to show loss actually drops."""

    vocab: int
    seq_len: int   # must be odd: k prompt + 1 sep + k copy
    batch: int
    seed: int = 0
    _count: int = 0

    def state(self):
        return {"count": self._count}

    def restore(self, state):
        self._count = int(state["count"])

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        i = self._count
        self._count += 1
        rng = np.random.default_rng((self.seed, i))
        k = (self.seq_len - 1) // 2
        sep = self.vocab - 1
        prompt = rng.integers(1, self.vocab - 1, (self.batch, k))
        toks = np.concatenate(
            [prompt, np.full((self.batch, 1), sep), prompt], axis=1)
        mask = np.zeros((self.batch, self.seq_len), np.float32)
        mask[:, k + 1:] = 1.0  # score only the copied half
        return {"tokens": toks.astype(np.int32), "loss_mask": mask}


@dataclasses.dataclass
class TimeSeriesGenerator:
    """Multivariate series: sums of random sinusoids + AR(1) noise + trend.

    Used by the TSF/TSC benchmark proxies (paper Tables 3–5): forecasting
    predicts the next ``horizon`` values; classification labels the series by
    its dominant frequency band.
    """

    n_channels: int = 8
    seed: int = 0

    def sample(self, batch: int, length: int, *, key: int = 0):
        rng = np.random.default_rng((self.seed, key))
        t = np.arange(length, dtype=np.float32)[None, None, :]
        freqs = rng.uniform(0.01, 0.4, (batch, self.n_channels, 3, 1))
        phases = rng.uniform(0, 2 * np.pi, (batch, self.n_channels, 3, 1))
        amps = rng.uniform(0.3, 1.0, (batch, self.n_channels, 3, 1))
        x = (amps * np.sin(2 * np.pi * freqs * t + phases)).sum(2)
        ar = rng.standard_normal((batch, self.n_channels, length)) * 0.1
        for i in range(1, length):
            ar[:, :, i] += 0.8 * ar[:, :, i - 1]
        trend = rng.uniform(-0.2, 0.2, (batch, self.n_channels, 1)) * t / length
        series = (x + ar + trend).astype(np.float32)
        labels = (freqs[:, :, 0, 0].mean(-1) > 0.2).astype(np.int32)
        return np.swapaxes(series, 1, 2), labels  # (B, L, C), (B,)


@dataclasses.dataclass
class EventStreamGenerator:
    """Hawkes-like marked event streams (paper Table 2 proxy).

    Self-exciting intensity lambda(t) = mu + sum_i alpha·exp(-beta (t-t_i));
    marks drawn from a state-dependent categorical.  Generated by Ogata
    thinning — deterministic per (seed, idx).
    """

    n_marks: int = 8
    mu: float = 0.2
    alpha: float = 0.6
    beta: float = 1.2
    seed: int = 0

    def sample(self, batch: int, n_events: int, *, key: int = 0):
        rng = np.random.default_rng((self.seed, key))
        times = np.zeros((batch, n_events), np.float32)
        marks = np.zeros((batch, n_events), np.int32)
        for b in range(batch):
            t, events = 0.0, []
            while len(events) < n_events:
                lam_bar = self.mu + self.alpha * sum(
                    np.exp(-self.beta * (t - ti)) for ti, _ in events[-20:])
                lam_bar = max(lam_bar, self.mu) * 1.5
                t += rng.exponential(1.0 / lam_bar)
                lam = self.mu + self.alpha * sum(
                    np.exp(-self.beta * (t - ti)) for ti, _ in events[-20:])
                if rng.random() < lam / lam_bar:
                    mark = rng.integers(0, self.n_marks)
                    events.append((t, mark))
            times[b] = [ti for ti, _ in events]
            marks[b] = [m for _, m in events]
        dt = np.diff(times, prepend=0.0, axis=1).astype(np.float32)
        return dt, marks
