"""Prefix-state cache — port of ``repro.serving.prefix_cache``.

A whole prompt prefix compresses to a per-layer carry of O(layers · heads)
floats (the paper's O(1)-state claim) — Aaren's ``(m, u, w)``, and in a
hybrid model RG-LRU's ``{"h", "conv"}`` beside it, or SSD's ``{"s",
"conv"}`` (101,916,672 B at mamba2-1.3b's full width): where a paged-KV server
needs a block allocator and O(tokens) of device memory per cached prefix,
such a prefix is a list of small host arrays — 401,408 B at the full width
of ``phi3-mini-3.8b`` (32 layers x 32 heads x (96 + 2) f32), whatever the
prefix's length.

Keying, as the JAX package's:

* Prefixes are keyed by ``(length, rolling hash)`` over token ids, the hash
  computed incrementally at **chunk-grid boundaries** only — the engine's
  prefill chunk defines the grid, so a cached carry always sits at a
  boundary the cold path also pauses at, and a hit's remaining prefill
  chunks are byte-identical to the cold run's.  The hash is the JAX
  package's, so the keys are equal.
* A hash match is verified against the entry's stored token ids — a
  collision degrades to a miss, never to a wrong carry.
* :meth:`lookup` returns the **longest** cached verified prefix that
  leaves at least one token to sample from.

Admission: a boundary becomes cacheable once seen ``min_hits`` times
(:meth:`lookup` counts sightings) or at once when :meth:`pin`-ned.
Eviction: LRU under ``max_bytes``; pinned entries are exempt.
Persistence: :meth:`save` / :meth:`load` go through the checkpoint layer,
with the JAX package's ``extra["prefix_cache"]`` schema, and ``load``
walks past corrupt steps.

The cache holds **host** numpy carries (one state a layer — a
``ScanState``, an RG-LRU or an SSD dict — with a size-1 batch axis on
every leaf); the engine copies one to the device when it
writes it into a slot.  One cache may serve every replica of a
``ReplicatedRouter``, whose engines step on worker threads, so every
method takes the cache's lock.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any

import numpy as np

from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics
from repro_torch.tree import tree_leaves, tree_map

#: rolling polynomial hash parameters (the JAX package's: a Mersenne-prime
#: modulus keeps the Python-int arithmetic exact; correctness never
#: depends on it — matches verify token ids).
_HASH_MOD = (1 << 61) - 1
_HASH_BASE = 1_000_003

#: bound on the seen-count table, so a long-lived engine's admission state
#: stays O(1) even under all-unique traffic.
_SEEN_CAP = 65536


def _roll(h: int, tokens: np.ndarray) -> int:
    """Fold ``tokens`` into rolling hash ``h`` (Python ints — exact)."""
    for t in tokens.tolist():
        h = (h * _HASH_BASE + int(t) + 1) % _HASH_MOD
    return h


def grid_hashes(tokens: np.ndarray, chunk: int) -> dict[int, int]:
    """``{L: hash(tokens[:L])}`` for L in {chunk, 2·chunk, ...} up to
    ``len(tokens)`` inclusive, in one pass."""
    out: dict[int, int] = {}
    h = 0
    n = int(tokens.size)
    for lo in range(0, n - n % chunk, chunk):
        h = _roll(h, tokens[lo:lo + chunk])
        out[lo + chunk] = h
    return out


def _host_carry(carry: list) -> list:
    """A carry (one state a layer) with numpy leaves."""
    return tree_map(np.asarray, carry)


def carry_bytes(carry: Any) -> int:
    """Total bytes of a (host) carry."""
    return int(sum(np.asarray(x).nbytes for x in tree_leaves(carry)))


@dataclasses.dataclass
class _Entry:
    tokens: np.ndarray        # (L,) int32 — verification copy of the prefix
    carry: Any                # host carry, size-1 slot axis on every leaf
    nbytes: int               # carry + tokens footprint
    pinned: bool
    hits: int = 0


class PrefixCache:
    """LRU prefix-carry cache over the engine's chunk grid.

    ``max_bytes``: eviction budget (carry + key-token bytes).  ``min_hits``:
    sightings before a boundary is cached (pinned prefixes skip it).
    ``chunk`` may be left to :meth:`bind` (the engine binds its chunk and
    carry template at construction).
    """

    def __init__(self, max_bytes: int, *, min_hits: int = 2,
                 chunk: int | None = None):
        if max_bytes <= 0:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        if min_hits < 1:
            raise ValueError(f"min_hits must be >= 1, got {min_hits}")
        self.max_bytes = int(max_bytes)
        self.min_hits = int(min_hits)
        self.chunk = chunk
        self._template: Any = None       # host carry (load() template)
        self._entries: "OrderedDict[tuple[int, int], _Entry]" = OrderedDict()
        self._seen: "OrderedDict[tuple[int, int], int]" = OrderedDict()
        self._pinned: dict[tuple[int, int], np.ndarray] = {}
        self.bytes = 0
        self.n_hits = 0
        self.n_misses = 0
        self.n_inserts = 0
        self.n_evictions = 0
        self.tokens_saved = 0
        # Replicas step on worker threads; RLock because insert's helpers
        # re-enter.
        self._lock = threading.RLock()

    # ---------------------------------------------------------------- bind
    def bind(self, chunk: int, template: Any) -> None:
        """Adopt the engine's chunk grid and carry template.  Entries keyed
        on one grid cannot serve another, so a different chunk raises."""
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if self.chunk is not None and self.chunk != chunk:
            raise ValueError(
                f"prefix cache is bound to chunk={self.chunk}; an engine "
                f"with chunk={chunk} cannot share it (entries are keyed on "
                "the chunk grid)")
        self.chunk = chunk
        self._template = _host_carry(template)

    def _require_bound(self):
        if self.chunk is None:
            raise ValueError("prefix cache is unbound: attach it to a "
                             "StreamingEngine (or call bind()) first")

    # -------------------------------------------------------------- lookup
    def pin(self, tokens) -> None:
        """Mark an exact prefix (e.g. a system prompt) as always-cacheable,
        truncated down to the chunk grid; pinned entries are cached on the
        first prefill through them and never evicted."""
        self._require_bound()
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n = int(tokens.size) - int(tokens.size) % self.chunk
        if n == 0:
            raise ValueError(
                f"pinned prefix has {tokens.size} tokens — shorter than one "
                f"chunk ({self.chunk}); nothing can be cached for it")
        tokens = tokens[:n]
        key = (n, _roll(0, tokens))
        with self._lock:
            self._pinned[key] = tokens
            ent = self._entries.get(key)
            if ent is not None:
                ent.pinned = True

    def lookup(self, prompt: np.ndarray):
        """Longest-cached-prefix match + admission counting, at admit time.

        Returns ``(match_len, carry, hashes)``: ``match_len`` 0 on a miss,
        else the longest cached verified prefix length <= len - 1;
        ``carry`` the entry's host carry; ``hashes`` the prompt's grid
        hashes, which the engine keeps on the slot for insertion.
        """
        self._require_bound()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        with self._lock:
            return self._lookup_locked(prompt)

    def _lookup_locked(self, prompt: np.ndarray):
        hashes = grid_hashes(prompt, self.chunk)
        match_len, carry = 0, None
        for length in sorted(hashes, reverse=True):
            if length > prompt.size - 1:
                continue
            ent = self._entries.get((length, hashes[length]))
            if ent is not None and np.array_equal(ent.tokens,
                                                  prompt[:length]):
                match_len, carry = length, ent.carry
                ent.hits += 1
                self._entries.move_to_end((length, hashes[length]))
                break
        # Every grid boundary of this prompt was seen once more (cached
        # ones too: the count is the re-admission signal after eviction).
        for length, h in hashes.items():
            key = (length, h)
            self._seen[key] = self._seen.pop(key, 0) + 1
            while len(self._seen) > _SEEN_CAP:
                self._seen.popitem(last=False)
        if match_len:
            self.n_hits += 1
            self.tokens_saved += match_len
            obs_metrics.inc("serve_prefix_cache_hits_total")
            obs_metrics.inc("serve_prefix_tokens_saved_total", match_len)
            obs_events.emit("prefix_cache_hit", prefix_len=match_len,
                            prompt_len=int(prompt.size))
        else:
            self.n_misses += 1
            obs_metrics.inc("serve_prefix_cache_misses_total")
        return match_len, carry, hashes

    def wants(self, length: int, h: int) -> bool:
        """Should the engine copy out the carry at this boundary?"""
        key = (length, h)
        with self._lock:
            if key in self._entries:
                return False
            return (key in self._pinned
                    or self._seen.get(key, 0) >= self.min_hits)

    # -------------------------------------------------------------- insert
    def insert(self, tokens: np.ndarray, h: int, carry: Any) -> None:
        """Admit one prefix carry (a host copy) and evict LRU past budget."""
        self._require_bound()
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size % self.chunk != 0:
            raise ValueError(
                f"prefix length {tokens.size} is off the chunk grid "
                f"(chunk={self.chunk}) — carries exist only at boundaries")
        key = (int(tokens.size), int(h))
        carry = _host_carry(carry)
        nbytes = carry_bytes(carry) + tokens.nbytes
        with self._lock:
            self._insert_locked(key, tokens, carry, nbytes)

    def _insert_locked(self, key, tokens, carry, nbytes):
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes -= old.nbytes
        self._entries[key] = _Entry(
            tokens=tokens, carry=carry, nbytes=nbytes,
            pinned=key in self._pinned)
        self.bytes += nbytes
        self.n_inserts += 1
        obs_metrics.inc("serve_prefix_cache_inserts_total")
        obs_events.emit("prefix_cache_insert", prefix_len=int(tokens.size),
                        nbytes=nbytes)
        self._evict_to_budget()
        self._update_gauges()

    def _evict_to_budget(self):
        while self.bytes > self.max_bytes:
            victim = next((k for k, e in self._entries.items()
                           if not e.pinned), None)
            if victim is None:     # only pinned left: exempt, budget overrun
                break
            ent = self._entries.pop(victim)
            self.bytes -= ent.nbytes
            self.n_evictions += 1
            obs_metrics.inc("serve_prefix_cache_evictions_total")
            obs_events.emit("prefix_cache_evict", prefix_len=victim[0],
                            nbytes=ent.nbytes)

    def _update_gauges(self):
        obs_metrics.set_gauge("serve_prefix_cache_bytes", self.bytes)
        obs_metrics.set_gauge("serve_prefix_cache_entries",
                              len(self._entries))

    # --------------------------------------------------------------- stats
    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            total = self.n_hits + self.n_misses
            return {
                "entries": len(self._entries),
                "bytes": self.bytes,
                "max_bytes": self.max_bytes,
                "hits": self.n_hits,
                "misses": self.n_misses,
                "hit_rate": self.n_hits / total if total else 0.0,
                "inserts": self.n_inserts,
                "evictions": self.n_evictions,
                "prefill_tokens_saved": self.tokens_saved,
            }

    # --------------------------------------------------- persistence layer
    @staticmethod
    def _key_str(key: tuple[int, int]) -> str:
        return f"L{key[0]}_H{key[1]:016x}"

    def save(self, directory: str, step: int) -> str:
        """Atomic crash-safe cache checkpoint (``checkpoint/io.py``).

        Entries are saved in LRU order (oldest first), so a load rebuilds
        the same eviction order; counters travel in ``extra``.
        """
        from repro_torch.checkpoint import save_checkpoint

        self._require_bound()
        with self._lock:
            tree = {"entries": {self._key_str(k): e.carry
                                for k, e in self._entries.items()}}
            meta = {
                "schema": 1,
                "chunk": self.chunk,
                "entries": [
                    {"key": self._key_str(k), "length": k[0],
                     "hash": str(k[1]), "tokens": e.tokens.tolist(),
                     "pinned": e.pinned, "hits": e.hits}
                    for k, e in self._entries.items()
                ],
                "counters": {"hits": self.n_hits, "misses": self.n_misses,
                             "inserts": self.n_inserts,
                             "evictions": self.n_evictions,
                             "tokens_saved": self.tokens_saved},
            }
        return save_checkpoint(directory, step, tree,
                               extra={"prefix_cache": meta})

    def load(self, directory: str, step: int | None = None) -> int:
        """Restore the hot set; ``step=None`` falls back past corrupt steps.

        The restore template is rebuilt per candidate step from the
        manifest's ``extra``, then every carry chunk is crc-verified by the
        checkpoint layer — a step whose carry data is corrupt is skipped.
        Returns the restored step.
        """
        from repro_torch.checkpoint import (
            CheckpointCorruptionError,
            available_steps,
            read_checkpoint_extra,
            restore_checkpoint,
        )

        self._require_bound()
        if self._template is None:
            raise ValueError("prefix cache has no carry template: bind() "
                             "an engine before load()")
        steps = ([step] if step is not None
                 else sorted(available_steps(directory), reverse=True))
        if not steps:
            raise FileNotFoundError(f"no prefix-cache checkpoint under "
                                    f"{directory}")
        failures: list[str] = []
        for s in steps:
            try:
                meta = read_checkpoint_extra(directory, s).get("prefix_cache")
                if meta is None:
                    raise CheckpointCorruptionError(
                        f"step {s}: no prefix_cache section in extra "
                        "(not a prefix-cache checkpoint)")
                template = {"entries": {
                    rec["key"]: self._template for rec in meta["entries"]}}
                tree, got, _ = restore_checkpoint(directory, template, s)
            except CheckpointCorruptionError as e:
                if step is not None:     # explicit step never falls back
                    raise
                failures.append(str(e))
                continue
            if meta["chunk"] != self.chunk:
                raise ValueError(
                    f"prefix-cache checkpoint was written at chunk="
                    f"{meta['chunk']}; this cache is bound to "
                    f"chunk={self.chunk} (entries key on the chunk grid)")
            with self._lock:
                self._entries.clear()
                self.bytes = 0
                for rec in meta["entries"]:
                    key = (int(rec["length"]), int(rec["hash"]))
                    tokens = np.asarray(rec["tokens"], np.int32)
                    carry = tree["entries"][rec["key"]]
                    nbytes = carry_bytes(carry) + tokens.nbytes
                    self._entries[key] = _Entry(
                        tokens=tokens, carry=carry, nbytes=nbytes,
                        pinned=bool(rec["pinned"]) or key in self._pinned,
                        hits=int(rec["hits"]))
                    self.bytes += nbytes
                c = meta.get("counters", {})
                self.n_hits = int(c.get("hits", 0))
                self.n_misses = int(c.get("misses", 0))
                self.n_inserts = int(c.get("inserts", 0))
                self.n_evictions = int(c.get("evictions", 0))
                self.tokens_saved = int(c.get("tokens_saved", 0))
                self._evict_to_budget()   # the budget may have shrunk
                self._update_gauges()
            obs_events.emit("prefix_cache_load", step=got,
                            entries=len(self._entries), nbytes=self.bytes)
            return got
        raise CheckpointCorruptionError(
            "no intact prefix-cache checkpoint under {}; every candidate "
            "failed:\n  {}".format(directory, "\n  ".join(failures)))
