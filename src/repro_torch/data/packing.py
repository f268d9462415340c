"""Sequence packing: bin-packing ragged documents into fixed-length rows — a
copy of ``repro.data.packing`` (numpy only, so the port imports nothing of
the JAX package; ``tests/test_torch_packing.py`` holds the two equal array
for array).

Packing concatenates several documents into one fixed-length row and keeps
them independent with three per-position arrays (DESIGN.md §Packing):

* ``tokens``      (B, N) int32 — documents back to back, 0-padded tail;
* ``segment_ids`` (B, N) int32 — 1..K per row in placement order, **0 for
  padding**.  The Aaren scan's resets and the CE loss key off these ids,
  which must form *contiguous same-id runs*;
* ``positions``   (B, N) int32 — within-document position, restarting at 0
  at every document start (what RoPE rotates by).

``pack_documents`` is the offline packer with two strategies: greedy
**first-fit** (each document into the first bin with room, deterministic in
document order) and **best-fit-decreasing** (descending length, each
document into the fullest bin that still fits).  ``PackedLMIterator`` is
the streaming twin of ``SyntheticLMIterator`` with the same
per-global-row determinism contract (row ``r`` of batch ``i`` is a pure
function of ``(seed, i, r)``), drawing a ragged document stream per row and
first-fit-filling that row's single bin.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def pack_documents(docs: list, seq_len: int,
                   strategy: str = "first_fit") -> dict:
    """Bin-pack ragged token documents into (B, N) rows.

    docs: list of 1-D int token arrays, each of length 1..seq_len (longer
    documents are the caller's problem — split or reject; silently
    truncating would corrupt the next-token targets).  Returns the batch
    dict {"tokens", "segment_ids", "positions", "loss_mask"} with B = the
    number of bins the strategy opened.  ``loss_mask`` is 1.0 at real
    tokens (the CE loss additionally drops cross-document boundary targets,
    see ``models/lm.lm_loss``).

    strategy:
      * ``"first_fit"`` (default) — placement in document order, first bin
        with room.  Order-preserving and streaming-friendly.
      * ``"best_fit_decreasing"`` — sort by descending length, place each
        document into the fullest bin that still fits.  Tighter tails on
        skewed length mixes (the 4:1 mix's ~19% first-fit tail padding
        mostly disappears) at the cost of reordering documents across rows.
    """
    docs = [np.asarray(d).reshape(-1) for d in docs]
    for d in docs:
        if d.size == 0:
            raise ValueError("empty document")
        if d.size > seq_len:
            raise ValueError(
                f"document of {d.size} tokens exceeds seq_len={seq_len}")
    if strategy not in ("first_fit", "best_fit_decreasing"):
        raise ValueError(f"unknown packing strategy {strategy!r}")
    if strategy == "best_fit_decreasing":
        # stable sort: equal-length documents keep their relative order,
        # so the packing stays deterministic in document order.
        docs = sorted(docs, key=lambda d: -d.size)
    bins: list[list[np.ndarray]] = []
    used: list[int] = []
    for d in docs:
        if strategy == "best_fit_decreasing":
            # fullest bin that still fits (max used => min leftover)
            best, best_used = -1, -1
            for i, u in enumerate(used):
                if u + d.size <= seq_len and u > best_used:
                    best, best_used = i, u
            if best >= 0:
                bins[best].append(d)
                used[best] += d.size
                continue
            bins.append([d])
            used.append(d.size)
            continue
        for i, u in enumerate(used):
            if u + d.size <= seq_len:
                bins[i].append(d)
                used[i] += d.size
                break
        else:
            bins.append([d])
            used.append(d.size)
    b = max(len(bins), 1)
    tokens = np.zeros((b, seq_len), np.int32)
    segment_ids = np.zeros((b, seq_len), np.int32)
    positions = np.zeros((b, seq_len), np.int32)
    for i, row_docs in enumerate(bins):
        off = 0
        for sid, d in enumerate(row_docs, start=1):
            tokens[i, off:off + d.size] = d
            segment_ids[i, off:off + d.size] = sid
            positions[i, off:off + d.size] = np.arange(d.size)
            off += d.size
    return {
        "tokens": tokens,
        "segment_ids": segment_ids,
        "positions": positions,
        "loss_mask": (segment_ids != 0).astype(np.float32),
    }


def unpack_documents(packed: dict) -> list:
    """Inverse of :func:`pack_documents` (placement order within each row)."""
    docs = []
    tokens = np.asarray(packed["tokens"])
    seg = np.asarray(packed["segment_ids"])
    for row_tok, row_seg in zip(tokens, seg):
        for sid in range(1, int(row_seg.max(initial=0)) + 1):
            sel = row_seg == sid
            if sel.any():
                docs.append(row_tok[sel])
    return docs


def packing_stats(doc_lengths, seq_len: int, n_rows: int) -> dict:
    """Padding-FLOP accounting: utilization of packed vs padded layouts.

    ``utilization`` = real tokens / (n_rows · seq_len) for the packed
    layout; ``padded_utilization`` = real / (n_docs · max_len) for the
    pad-to-max layout; ``padded_token_ratio`` = padded tokens per real token
    (the waste multiplier packing removes).
    """
    lens = np.asarray(list(doc_lengths), np.int64)
    real = int(lens.sum())
    padded = int(lens.size * lens.max(initial=0))
    packed = int(n_rows * seq_len)
    return {
        "real_tokens": real,
        "packed_slots": packed,
        "padded_slots": padded,
        "utilization": real / max(packed, 1),
        "padded_utilization": real / max(padded, 1),
        "padded_token_ratio": padded / max(real, 1),
    }


@dataclasses.dataclass
class PackedLMIterator:
    """Deterministic packed-LM batches over a ragged document stream.

    Mirrors ``SyntheticLMIterator``'s contracts exactly: row ``r`` of batch
    ``i`` is a pure function of ``(seed, i, r)`` with ``r`` a *global* row
    index (host ``h`` of ``H`` draws rows ``[h·B/H, (h+1)·B/H)``, and the
    union of host slices IS the single-host batch); ``state()``/
    ``restore()`` round-trip the batch counter.

    Each row draws a deterministic stream of ragged documents — lengths
    ``min_doc + (max_doc - min_doc)·u^skew`` (skew 3 gives the ~4:1
    max:mean mix of the serving benchmarks), order-1 Markov token content
    from the same capped-alphabet transition table as the unpacked
    iterator — and first-fit packs them into that row's single ``seq_len``
    bin, stopping at the first document that no longer fits.  Yields
    {"tokens", "segment_ids", "positions", "loss_mask"}.
    """

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    min_doc: int = 8
    max_doc: int | None = None       # default: seq_len
    skew: float = 3.0
    _count: int = 0

    def __post_init__(self):
        if self.max_doc is None:
            self.max_doc = self.seq_len
        if not (1 <= self.min_doc <= self.max_doc <= self.seq_len):
            raise ValueError(
                f"need 1 <= min_doc <= max_doc <= seq_len, got "
                f"{self.min_doc}/{self.max_doc}/{self.seq_len}")
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab, 512)
        self._v = v
        logits = rng.standard_normal((v, v)) * 2.0
        self._probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)

    def state(self) -> dict:
        return {"count": self._count}

    def restore(self, state: dict):
        self._count = int(state["count"])

    def __iter__(self):
        return self

    def _doc(self, rng: np.random.Generator) -> np.ndarray:
        span = self.max_doc - self.min_doc
        length = self.min_doc + int(span * rng.random() ** self.skew)
        toks = np.zeros(length, np.int64)
        toks[0] = rng.integers(0, self._v)
        for t in range(1, length):
            toks[t] = rng.choice(self._v, p=self._probs[toks[t - 1]])
        return toks

    def _sample_row(self, i: int, row: int) -> dict:
        """One packed row — a pure function of (seed, i, row)."""
        rng = np.random.default_rng((self.seed, i, row))
        docs, used = [], 0
        while True:
            d = self._doc(rng)
            if used + d.size > self.seq_len:
                break
            docs.append(d)
            used += d.size
        return pack_documents(docs, self.seq_len)

    def __next__(self) -> dict:
        i = self._count
        self._count += 1
        b = self.batch // self.num_hosts
        rows = [self._sample_row(i, r)
                for r in range(self.host_id * b, (self.host_id + 1) * b)]
        return {k: np.concatenate([r[k] for r in rows])
                for k in ("tokens", "segment_ids", "positions", "loss_mask")}
