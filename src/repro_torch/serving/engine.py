"""Inference engines — port of the core of ``repro.serving.engine``.

* :func:`generate` — wave generation: prefill the whole batch (ragged
  right-padded prompts allowed), then one-token decode steps; Aaren
  carries or softmax KV caches.
* :class:`StreamingEngine` — chunked-prefill continuous batching over
  ``n_slots`` persistent decode slots.  Pure-Python bookkeeping decides what
  each slot feeds next; one fixed-shape step advances a *mixed* batch —
  mid-prefill slots consume up to ``chunk`` prompt tokens, decoding slots
  one token, free slots are all padding — and freed slots are reset to the
  ⊕-identity carry in the same tick.

Both engines run under ``torch.inference_mode()`` on the device of the
parameters, and draw the token-``t`` sample of request ``rid`` from
:func:`~repro_torch.serving.sampler.request_seed` ``(seed, rid, t)``, so
streaming and wave generation sample identically.

The streaming engine reports through ``repro_torch.obs`` under the JAX
package's names: the ``serve_*`` counters, gauges and TTFT/ITL histograms
into the ambient registry, ``request_submitted``/``first_token``/
``request_completed`` events into the ambient sink, and the
``engine.schedule``/``engine.step``/``engine.sample`` spans.  Each is a
no-op when nothing is installed, and the tokens do not depend on them.

Not yet ported (ROADMAP queue A item 9): the prefix cache, request
export/inject, snapshot/restore, deadlines, ``max_queue`` shedding, slot
quarantine, and their instruments.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.models.factory import ModelAPI
from repro_torch.models.lm import (
    lm_prefill_chunk,
    lm_state_init,
    lm_state_select,
)
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.sampler import greedy_sampler, request_seed
from repro_torch.tree import tree_leaves


def _device_of(params: dict) -> torch.device:
    return params["embed"]["table"].device


def decode_state_bytes(states) -> int:
    """Total bytes of a decode state (the paper's Fig. 5-left measure)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(states))


def _sample(sampler: Callable, logits: torch.Tensor, seed: int, rids,
            steps) -> list[int]:
    """Sample each row of (B, 1, V) logits with its (request, step) seed."""
    seeds = [request_seed(seed, rid, st) for rid, st in zip(rids, steps)]
    return sampler(logits, seeds)[:, 0].tolist()


# ---------------------------------------------------------------------------
# Wave generation
# ---------------------------------------------------------------------------


@torch.inference_mode()
def generate(api: ModelAPI, params: dict, prompts, max_new_tokens: int, *,
             sampler: Callable = greedy_sampler, seed: int = 0,
             cache_len: int | None = None, prompt_lengths=None):
    """Wave generation.  Returns (tokens (B, max_new) int64, final states).

    ``prompts``: (B, P) token ids.  ``cache_len``: KV-cache slots of the
    softmax layers (default P + max_new; a sliding-window layer keeps
    ``min(window, cache_len)``).  ``prompt_lengths``: optional (B,) true
    lengths of right-padded ragged prompts — the prefill masks each row's
    padded tail, row ``i``'s first sample reads the logits at its true last
    token, and decode continues from exact per-row states (KV caches carry
    the prompt lengths, so the padded gap is masked and RoPE uses true
    positions).
    """
    device = _device_of(params)
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                              device=device)
    if prompts.ndim != 2 or 0 in prompts.shape:
        raise ValueError(f"prompts must be (B, P) with B, P >= 1; got "
                         f"{tuple(prompts.shape)}")
    if max_new_tokens <= 0:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    b, p = prompts.shape
    if cache_len is None:
        cache_len = p + max_new_tokens
    pattern = api.cfg.effective_pattern()
    if "attn" in pattern and cache_len < p + max_new_tokens:
        # A wrapped global-attention ring silently overwrites the earliest
        # context — a wrong answer (sliding-window layers cap their own
        # cache at `window` by design).
        raise ValueError(
            f"cache_len={cache_len} < prompt {p} + max_new "
            f"{max_new_tokens}: the global-attention ('attn') KV cache "
            "must be non-wrapping — a wrapped ring silently drops context")
    batch = {"tokens": prompts, "cache_len": cache_len}
    if prompt_lengths is not None:
        lens_np = np.asarray(prompt_lengths)
        if lens_np.shape != (b,):
            raise ValueError(f"prompt_lengths shape {lens_np.shape} != ({b},)")
        if (lens_np < 1).any() or (lens_np > p).any():
            raise ValueError(f"prompt_lengths must lie in [1, {p}]; got "
                             f"{lens_np.tolist()}")
        if cache_len < p + max_new_tokens:
            # The ragged decode mask reads slots [0, prompt_lens) as the
            # prompt; a wrapping ring would overwrite them.
            raise ValueError(
                f"ragged prefill needs a non-wrapping cache: cache_len="
                f"{cache_len} < padded prompt {p} + max_new "
                f"{max_new_tokens}")
        if "attn_local" in pattern and api.cfg.window < p:
            # window < P means a trailing-window ring, and ragged rows
            # would need per-row ring indices.
            raise NotImplementedError(
                f"ragged prefill (prompt_lengths=) is not supported for "
                f"'attn_local' layers with window ({api.cfg.window}) < "
                f"padded prompt length ({p}): the trailing-window ring "
                "cache needs per-row ring indices. Use window >= padded "
                "prompt length, or pad each prompt separately.")
        batch["lengths"] = torch.as_tensor(lens_np, dtype=torch.int64,
                                           device=device)
    logits, states = api.prefill(params, batch)
    if prompt_lengths is not None:
        idx = (batch["lengths"] - 1)[:, None, None].expand(-1, 1,
                                                           logits.shape[-1])
        last = torch.gather(logits, 1, idx)                      # (B, 1, V)
    else:
        last = logits[:, -1:]
    rids = list(range(b))
    out = [_sample(sampler, last, seed, rids, [0] * b)]
    for t in range(1, max_new_tokens):
        tok = torch.tensor(out[-1], dtype=torch.int64, device=device)[:, None]
        logits, states = api.decode_step(params, {"token": tok,
                                                  "states": states})
        out.append(_sample(sampler, logits, seed, rids, [t] * b))
    return torch.tensor(out, dtype=torch.int64).T, states


# ---------------------------------------------------------------------------
# Chunked-prefill continuous batching
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Slot:
    """Scheduler-side bookkeeping for one decode slot."""

    request_id: int
    pending: np.ndarray | None   # prompt tokens not yet consumed (None once decoding)
    tokens: list                 # generated token ids
    remaining: int               # generated tokens still owed
    n_sampled: int = 0           # per-request step counter (seed schedule)
    last_token: int = 0          # input token while decoding
    last_emit_at: float | None = None   # perf_counter of the last token


def _validate_request(prompt, max_new_tokens: int) -> np.ndarray:
    prompt = np.asarray(prompt)
    if prompt.ndim > 1:
        raise ValueError(f"prompt must be 1-D, got shape {prompt.shape}")
    if not np.issubdtype(prompt.dtype, np.integer):
        raise ValueError(f"prompt must hold token ids (integers), got "
                         f"dtype {prompt.dtype}")
    prompt = prompt.astype(np.int64).reshape(-1)
    if prompt.size == 0:
        raise ValueError("empty prompt")
    if max_new_tokens <= 0:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    return prompt


class StreamingEngine:
    """Chunked-prefill continuous batching over ``n_slots`` decode slots.

    All-Aaren models only: the decode state is a position-free ``(m, u, w)``
    carry per layer and head, so admitting a request needs no cache
    reshaping and any ``chunk`` works (masked positions are ⊕-identity).

    Slot-carry lifecycle: **free slots always hold the ⊕-identity init
    carry, bitwise.**  A completed request's slot is reset in the same
    tick, and free rows run all-padding through the step under a masked
    select that keeps their carry bit for bit — a masked leaf folded into an
    *empty* carry would add ``exp(NEG_INF - NEG_INF) = 1`` to ``u``.
    """

    def __init__(self, api: ModelAPI, params: dict, *, n_slots: int = 4,
                 chunk: int = 16, sampler: Callable = greedy_sampler,
                 seed: int = 0):
        pattern = api.cfg.effective_pattern()
        if any(m in ("attn", "attn_local") for m in pattern):
            raise ValueError(
                "StreamingEngine requires position-free decode state "
                "(aaren/rglru/ssd mixers only); use generate() for "
                "KV-cache models.")
        if any(m != "aaren" for m in pattern):
            raise ValueError(
                "the port's StreamingEngine serves all-Aaren models only; "
                f"pattern {pattern} has other mixers")
        if n_slots < 1 or chunk < 1:
            raise ValueError(f"need n_slots >= 1 and chunk >= 1; got "
                             f"{n_slots}, {chunk}")
        self.api = api
        self.params = params
        self.n_slots = n_slots
        self.chunk = chunk
        self.sampler = sampler
        self.seed = seed
        self.device = _device_of(params)
        self._init_states = lm_state_init(api.cfg, n_slots,
                                          device=self.device)
        self.states = self._init_states
        self.active: list[_Slot | None] = [None] * n_slots
        self.queue: list[_Slot] = []
        self.finished: dict[int, list[int]] = {}
        # Latency bookkeeping for TTFT; evicted when a request ends.
        self.submitted_at: dict[int, float] = {}
        self.first_token_at: dict[int, float] = {}
        self._next_id = 0

    # ------------------------------------------------------------------ API
    def submit(self, prompt, max_new_tokens: int) -> int:
        """Queue a request.  prompt: (P,) token ids, P >= 1.  Returns its id."""
        prompt = _validate_request(prompt, max_new_tokens)
        rid = self._next_id
        self._next_id += 1
        self.queue.append(_Slot(request_id=rid, pending=prompt, tokens=[],
                                remaining=int(max_new_tokens)))
        self.submitted_at[rid] = time.perf_counter()
        obs_metrics.inc("serve_requests_total")
        obs_metrics.set_gauge("serve_queue_depth", len(self.queue))
        obs_events.emit("request_submitted", rid=rid,
                        prompt_len=int(prompt.size),
                        max_new=int(max_new_tokens))
        return rid

    @torch.inference_mode()
    def warmup(self) -> float:
        """Run the fixed-shape step once (results discarded; ``self.states``
        untouched).  Returns the wall seconds spent."""
        t0 = time.perf_counter()
        self._advance(np.zeros((self.n_slots, self.chunk), np.int64),
                      np.ones((self.n_slots,), np.int64))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    @torch.inference_mode()
    def reset(self, mask) -> None:
        """Return the carries of slots where ``mask`` (S,) is True to init."""
        mask = torch.as_tensor(np.asarray(mask, bool), device=self.device)
        self.states = lm_state_select(mask, self._init_states, self.states)

    @torch.inference_mode()
    def step(self) -> int:
        """One engine tick: admit, advance the mixed batch, sample.

        Returns the number of tokens emitted this tick (0 when idle).
        """
        with obs_trace.span("engine.schedule"):
            self._admit()
            n_active = sum(s is not None for s in self.active)
            obs_metrics.set_gauge("serve_queue_depth", len(self.queue))
            obs_metrics.set_gauge("serve_slot_occupancy",
                                  n_active / self.n_slots)
            if n_active == 0:
                return 0
            # Free slots stay all-padding (lengths == 0).
            tokens = np.zeros((self.n_slots, self.chunk), np.int64)
            lengths = np.zeros((self.n_slots,), np.int64)
            prefill_toks, decode_toks = 0, 0
            for i, slot in enumerate(self.active):
                if slot is None:
                    continue
                if slot.pending is not None:  # mid-prefill: feed next chunk
                    take = min(slot.pending.size, self.chunk)
                    tokens[i, :take] = slot.pending[:take]
                    lengths[i] = take
                    prefill_toks += take
                else:                         # decoding: feed last sample
                    tokens[i, 0] = slot.last_token
                    lengths[i] = 1
                    decode_toks += 1
            if prefill_toks:
                obs_metrics.inc("serve_prefill_tokens_total", prefill_toks)
            if decode_toks:
                obs_metrics.inc("serve_decode_tokens_total", decode_toks)

        with obs_trace.span("engine.step"):
            last, self.states = self._advance(tokens, lengths)

        emitted = 0
        completed = np.zeros((self.n_slots,), bool)
        with obs_trace.span("engine.sample"):
            ready = []
            for i, slot in enumerate(self.active):
                if slot is None:
                    continue
                if slot.pending is not None:
                    slot.pending = slot.pending[int(lengths[i]):]
                    if slot.pending.size:     # prompt not done — no sample
                        continue
                    slot.pending = None
                ready.append(i)
            if ready:
                rows = [self.active[i] for i in ready]
                toks = _sample(self.sampler, last[ready], self.seed,
                               [s.request_id for s in rows],
                               [s.n_sampled for s in rows])
                now = time.perf_counter()
                for i, slot, t in zip(ready, rows, toks):
                    rid = slot.request_id
                    if not slot.tokens:
                        self.first_token_at[rid] = now
                        sub = self.submitted_at.get(rid)
                        if sub is not None:
                            obs_metrics.observe("serve_ttft_s", now - sub)
                            obs_events.emit("first_token", rid=rid,
                                            ttft_s=now - sub)
                    elif slot.last_emit_at is not None:
                        obs_metrics.observe("serve_itl_s",
                                            now - slot.last_emit_at)
                    slot.last_emit_at = now
                    slot.last_token = t
                    slot.tokens.append(t)
                    slot.n_sampled += 1
                    slot.remaining -= 1
                    emitted += 1
                    if slot.remaining <= 0:
                        self.finished[rid] = slot.tokens
                        self.active[i] = None
                        completed[i] = True
                        obs_metrics.inc("serve_requests_completed_total")
                        self._request_done(rid, "request_completed",
                                           n_tokens=len(slot.tokens))
        if completed.any():
            self.reset(completed)
        return emitted

    def run(self) -> dict[int, list[int]]:
        """Serve until queue and slots drain.  Returns {request_id: tokens}."""
        while self.queue or any(s is not None for s in self.active):
            self.step()
        return self.finished

    # ------------------------------------------------------------ internals
    def _advance(self, tokens: np.ndarray, lengths: np.ndarray):
        """The fixed-shape step: (S, C) tokens + per-slot valid lengths ->
        (last-valid logits (S, 1, V), next states).  Leaves ``self.states``
        as it is; :meth:`step` stores the result."""
        toks = torch.as_tensor(tokens, device=self.device)
        lens = torch.as_tensor(lengths, device=self.device)
        mask = torch.arange(self.chunk, device=self.device)[None, :] \
            < lens[:, None]
        logits, new_states = lm_prefill_chunk(
            self.api.cfg, self.params, toks, self.states, length_mask=mask)
        # An all-padding row (lengths == 0) keeps its carry bit for bit.
        new_states = lm_state_select(lens > 0, new_states, self.states)
        # lengths == 0 would gather index -1: clamp to 0 (never sampled).
        last_idx = torch.clamp(lens - 1, min=0)
        last = torch.gather(
            logits, 1, last_idx[:, None, None].expand(-1, 1, logits.shape[-1]))
        return last, new_states

    def _request_done(self, rid: int, kind: str, **data) -> None:
        """Terminal per-request accounting: emit the event and evict the
        latency maps, so a long-lived engine does not grow them."""
        now = time.perf_counter()
        sub = self.submitted_at.pop(rid, None)
        ft = self.first_token_at.pop(rid, None)
        if sub is not None:
            data["total_s"] = now - sub
            if ft is not None:
                data["ttft_s"] = ft - sub
        obs_events.emit(kind, rid=rid, **data)

    def _admit(self):
        """Move queued requests into free slots (free slots already hold
        the init carry)."""
        for i in range(self.n_slots):
            if self.active[i] is None and self.queue:
                self.active[i] = self.queue.pop(0)
