"""Inference engines — port of ``repro.serving.engine``.

* :func:`generate` — wave generation: prefill the whole batch (ragged
  right-padded prompts allowed), then one-token decode steps; Aaren
  carries or softmax KV caches.
* :class:`StreamingEngine` — chunked-prefill continuous batching over
  ``n_slots`` persistent decode slots.  Pure-Python bookkeeping decides what
  each slot feeds next; one fixed-shape step advances a *mixed* batch —
  mid-prefill slots consume up to ``chunk`` prompt tokens, decoding slots
  one token, free slots are all padding — and freed slots are reset to the
  ⊕-identity carry in the same tick.  Around it: deadlines, ``max_queue``
  shedding, slot quarantine, request export/inject (migration), engine
  snapshots, and the prefix-carry cache (``serving/prefix_cache.py``).

Both engines run under ``torch.inference_mode()`` on the device of the
parameters, and draw the token-``t`` sample of request ``rid`` from the
seed :func:`~repro_torch.serving.sampler.request_seeds` ``(seed, rid, t)``,
so streaming and wave generation sample identically.  The built-in
samplers take one call for all rows; a streaming tick reads the device
once, the sampled tokens and each row's logit finiteness together.

A request's whole context is its per-layer carry — Aaren's ``(m, u, w)``,
RG-LRU's ``{"h", "conv"}``, SSD's ``{"s", "conv"}`` — a few hundred KB to
about a hundred MB at full width (mamba2-1.3b: 101,916,672 B): a cached
prefix or a migrated request moves as one host copy of it.

The streaming engine reports through ``repro_torch.obs`` under the JAX
package's names: the ``serve_*`` counters, gauges and TTFT/ITL histograms
into the ambient registry, the request events into the ambient sink, and
the ``engine.schedule``/``engine.step``/``engine.sample`` spans.  Each is a
no-op when nothing is installed, and the tokens do not depend on them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.factory import ModelAPI
from repro_torch.models.lm import (
    lm_prefill_chunk,
    lm_state_init,
    lm_state_put_slot,
    lm_state_select,
    lm_state_take_slot,
)
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.sampler import (
    greedy_sampler,
    request_seed,
    request_seeds,
)
from repro_torch.tree import tree_leaves, tree_map


class EngineOverloaded(RuntimeError):
    """Admission queue full — the request was shed, not queued."""


#: error strings recorded in ``StreamingEngine.errors``
ERR_DEADLINE = "deadline exceeded"
ERR_POISONED = "non-finite logits (slot quarantined)"


def _device_of(params: dict) -> torch.device:
    return params["embed"]["table"].device


def decode_state_bytes(states) -> int:
    """Total bytes of a decode state (the paper's Fig. 5-left measure)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(states))


def carry_to_host(carry: list) -> list:
    """A carry (one state a layer: an Aaren ``ScanState``, an RG-LRU or an
    SSD dict) with numpy f32 leaves, in one device-to-host copy.  A bf16
    leaf (a conv tail) is widened to f32, exactly."""
    leaves = tree_leaves(carry)
    flat = torch.cat([x.reshape(-1).float() for x in leaves]).cpu().numpy()
    pieces = iter(np.split(flat, np.cumsum([x.numel() for x in leaves])))
    return tree_map(lambda x: next(pieces).reshape(tuple(x.shape)),
                        carry)


def carry_to_device(carry: list, device, like: list) -> list:
    """A host carry (numpy leaves, as :func:`carry_to_host` returns) as
    tensors on ``device``, in one host-to-device copy; each leaf takes the
    dtype of its leaf in ``like`` (a state of the same structure, any batch
    size)."""
    leaves = [np.asarray(x, np.float32) for x in tree_leaves(carry)]
    flat = torch.from_numpy(np.concatenate([x.reshape(-1) for x in leaves]))
    pieces = iter(torch.split(flat.to(device), [x.size for x in leaves]))
    return tree_map(
        lambda x, ref: next(pieces).reshape(np.shape(x)).to(ref.dtype),
        carry, like)


def _sample_rows(sampler: Callable, logits: torch.Tensor, seed: int, rids,
                 steps) -> torch.Tensor:
    """Sample each row of (B, 1, V) logits with its (request, step) seed.
    Returns (B,) int64 tokens on the logits' device, without a host read.

    ``batched`` samplers (the built-ins) take one call for all rows, the
    seeds derived on the device; custom samplers are called once per row
    with that row's seed, as the JAX package calls its non-``jit_safe``
    samplers.  Both engines route through here.  A sampler with
    ``uses_seeds = False`` (greedy) gets ``None``: no seeds are made.
    """
    if not getattr(sampler, "uses_seeds", True):
        return sampler(logits, None)[:, 0]
    if getattr(sampler, "batched", False):
        ids = torch.as_tensor(np.stack([np.asarray(rids, np.int64),
                                        np.asarray(steps, np.int64)]),
                              device=logits.device)
        return sampler(logits, request_seeds(seed, ids[0], ids[1]))[:, 0]
    return torch.cat([
        sampler(logits[i:i + 1],
                torch.tensor([request_seed(seed, int(r), int(s))],
                             device=logits.device))[:, 0]
        for i, (r, s) in enumerate(zip(rids, steps))])


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
    positions).  The sampled tokens stay on the device until the end.
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
    rids = np.arange(b)
    out = [_sample_rows(sampler, last, seed, rids, np.zeros(b))]
    for t in range(1, max_new_tokens):
        logits, states = api.decode_step(params, {"token": out[-1][:, None],
                                                  "states": states})
        out.append(_sample_rows(sampler, logits, seed, rids, np.full(b, t)))
    return torch.stack(out, dim=1).cpu(), states


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
    deadline: float | None = None  # absolute perf_counter() cutoff
    # perf_counter() of the last emitted token (inter-token latency); not
    # serialised by snapshot().
    last_emit_at: float | None = None
    # Prefix-cache bookkeeping: the full prompt (prefix extraction at
    # insert time), prompt tokens folded into the carry so far (a cache
    # hit starts at the matched length), and the prompt's grid hashes
    # ({boundary_len: hash}; None without a cache or after a restore, and
    # insertion is then skipped for this request).
    prompt: np.ndarray | None = None
    consumed: int = 0
    hashes: dict | None = None


@dataclasses.dataclass
class _Queued:
    """An admitted-but-not-yet-slotted request.

    Fresh submissions have ``pending == prompt`` and zeroed progress
    fields.  Migrated requests (:meth:`StreamingEngine.inject_request`)
    arrive mid-life: ``tokens``/``n_sampled`` record emitted progress and
    either ``carry`` holds the exact exported carry (drain — ``pending`` is
    then just the tokens not yet folded into it) or the carry is gone
    (crash) and ``pending`` replays prompt + emitted tokens from the
    ⊕-identity init.
    """

    request_id: int
    pending: np.ndarray          # tokens still to fold into the carry
    remaining: int               # generated tokens still owed
    deadline: float | None = None
    prompt: np.ndarray | None = None   # original prompt (cache + re-export)
    tokens: list = dataclasses.field(default_factory=list)
    n_sampled: int = 0
    carry: Any = None            # host carry (numpy leaves), or None


def _validate_request(prompt, max_new_tokens: int,
                      deadline_s: float | None = None) -> np.ndarray:
    """Validate submit() arguments; returns the canonical int32 prompt.

    Shared by the engine and the router, so both reject before any id
    allocation or bookkeeping — nothing is half-admitted.
    """
    prompt = np.asarray(prompt)
    if prompt.ndim > 1:
        raise ValueError(f"prompt must be 1-D, got shape {prompt.shape}")
    if not np.issubdtype(prompt.dtype, np.integer):
        raise ValueError(f"prompt must hold token ids (integers), got "
                         f"dtype {prompt.dtype}")
    prompt = prompt.astype(np.int32).reshape(-1)
    if prompt.size == 0:
        raise ValueError("empty prompt")
    if max_new_tokens <= 0:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if deadline_s is not None and deadline_s < 0:
        raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
    return prompt


class StreamingEngine:
    """Chunked-prefill continuous batching over ``n_slots`` decode slots.

    Position-free decode states only (Aaren, RG-LRU and SSD mixers), so
    admitting a request needs no cache reshaping.  An all-Aaren model takes
    any ``chunk`` (masked positions are ⊕-identity; default 16); an RG-LRU
    or SSD carry advances one token at a time, so a model with such layers
    runs at ``chunk == 1`` (the default there), as in the JAX package.  A
    MoE MLP routes each chunk's padding too and sizes its capacity per
    chunk, so a model with one streams only on a fixed chunk grid (a
    migrated or restored request keeps it).

    ``prefix_cache`` (optional :class:`~repro_torch.serving.prefix_cache
    .PrefixCache`) caches prompt-prefix carries across requests: an admitted
    prompt whose longest cached prefix has length L skips L tokens of
    prefill (the carry is written into the slot by
    :func:`~repro_torch.models.lm.lm_state_put_slot`), and a prefill that
    crosses a wanted chunk boundary copies the slot's carry out.  The cache
    binds to this engine's chunk grid; an engine with another ``chunk``
    cannot share it.

    Slot-carry lifecycle: **free slots always hold the ⊕-identity init
    carry, bitwise.**  Every exit path — completion, deadline expiry,
    quarantine, export, restore — resets the slot in the same tick, and
    free rows run all-padding through the step under a masked select that
    keeps their carry bit for bit (a masked leaf folded into an *empty*
    carry would add ``exp(NEG_INF - NEG_INF) = 1`` to ``u``).

    Degradation under faults:

    * ``max_queue`` bounds the admission queue — :meth:`submit` sheds with
      :class:`EngineOverloaded` (``None`` = unbounded).
    * ``submit(..., deadline_s=)`` — an expired request errors out
      (``self.errors``) whether queued or mid-slot.
    * ``guard_logits`` (default on) — a slot whose last-valid logits hold a
      NaN or ±inf is **quarantined**: its request errors and its carry is
      reset; its batch-mates are untouched.  Finiteness is reduced on the
      device and read with the sampled tokens.
    * :meth:`snapshot` / :meth:`restore` serialise the engine (carries +
      bookkeeping); :meth:`save` / :meth:`load` go through the checkpoint
      layer's atomic writes.
    """

    def __init__(self, api: ModelAPI, params: dict, *, n_slots: int = 4,
                 chunk: int | None = None,
                 sampler: Callable = greedy_sampler,
                 seed: int = 0, max_queue: int | None = None,
                 guard_logits: bool = True, prefix_cache=None):
        pattern = api.cfg.effective_pattern()
        if any(m in ("attn", "attn_local") for m in pattern):
            raise ValueError(
                "StreamingEngine requires position-free decode state "
                "(aaren/rglru/ssd mixers only); use generate() for "
                "KV-cache models.")
        pure_aaren = all(m == "aaren" for m in pattern)
        if chunk is None:
            chunk = 16 if pure_aaren else 1
        if chunk > 1 and not pure_aaren:
            raise ValueError(
                f"chunk={chunk} needs an all-aaren pattern; rglru/ssd "
                "carries advance one token at a time (use chunk=1).")
        if n_slots < 1 or chunk < 1:
            raise ValueError(f"need n_slots >= 1 and chunk >= 1; got "
                             f"{n_slots}, {chunk}")
        self.api = api
        self.params = params
        self.n_slots = n_slots
        self.chunk = chunk
        self.sampler = sampler
        self.seed = seed
        self.max_queue = max_queue
        self.guard_logits = guard_logits
        self.device = _device_of(params)
        self._init_states = lm_state_init(api.cfg, n_slots,
                                          device=self.device)
        self.states = self._init_states
        self.prefix_cache = prefix_cache
        if prefix_cache is not None:
            prefix_cache.bind(chunk, carry_to_host(
                lm_state_init(api.cfg, 1, device="cpu")))
        self.active: list[_Slot | None] = [None] * n_slots
        self.queue: list[_Queued] = []
        self.finished: dict[int, list[int]] = {}
        self.errors: dict[int, str] = {}       # rid -> error string
        self.n_shed = 0                        # submits rejected (queue full)
        self.n_quarantined = 0                 # slots reset on poisoned logits
        # Latency bookkeeping for in-flight requests only: evicted when a
        # request leaves the system, after its TTFT/latency went to obs.
        self.submitted_at: dict[int, float] = {}
        self.first_token_at: dict[int, float] = {}
        self._next_id = 0

    # ------------------------------------------------------------------ API
    def submit(self, prompt, max_new_tokens: int, *,
               deadline_s: float | None = None,
               request_id: int | None = None) -> int:
        """Queue a request.  prompt: (P,) token ids, P >= 1.  Returns its id.

        ``deadline_s``: optional wall-clock budget from submission; a
        request that has not *finished* within it errors out.  Raises
        :class:`EngineOverloaded` when the admission queue is at
        ``max_queue``.  ``request_id``: a caller-allocated id (the router
        assigns tier-unique ids, so two replicas never reuse a
        ``(rid, step)`` seed); it must not collide with a known request.
        """
        prompt = _validate_request(prompt, max_new_tokens, deadline_s)
        if request_id is not None and (
                request_id in self.submitted_at
                or request_id in self.finished
                or request_id in self.errors):
            raise ValueError(f"request_id {request_id} already in use")
        if (self.max_queue is not None
                and len(self.queue) >= self.max_queue):
            self._shed()
            raise EngineOverloaded(
                f"admission queue full ({len(self.queue)}/{self.max_queue} "
                "queued); retry later or raise max_queue")
        rid = self._next_id if request_id is None else int(request_id)
        self._next_id = max(self._next_id, rid + 1)
        now = time.perf_counter()
        deadline = now + deadline_s if deadline_s is not None else None
        self.queue.append(_Queued(
            request_id=rid, pending=prompt, remaining=int(max_new_tokens),
            deadline=deadline, prompt=prompt))
        self.submitted_at[rid] = now
        obs_metrics.inc("serve_requests_total")
        obs_metrics.set_gauge("serve_queue_depth", len(self.queue))
        obs_events.emit("request_submitted", rid=rid,
                        prompt_len=int(prompt.size),
                        max_new=int(max_new_tokens))
        return rid

    @torch.inference_mode()
    def warmup(self) -> float:
        """Run the fixed-shape step, the sampler and, with a prefix cache,
        the slot copy-out/in once (results discarded; ``self.states``
        untouched).  Returns the wall seconds spent."""
        t0 = time.perf_counter()
        last, states = self._advance(
            np.zeros((self.n_slots, self.chunk), np.int64),
            np.ones((self.n_slots,), np.int64))
        zeros = np.zeros((self.n_slots,), np.int64)
        _sample_rows(self.sampler, last, self.seed, zeros, zeros)
        if self.prefix_cache is not None:
            carry = carry_to_host(lm_state_take_slot(states, 0))
            lm_state_put_slot(
                states, carry_to_device(carry, self.device,
                                        self._init_states),
                torch.zeros(self.n_slots, dtype=torch.bool,
                            device=self.device))
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
        """One engine tick: expire, admit, advance the mixed batch, read the
        device once, quarantine, sample.

        Returns the number of tokens emitted this tick (0 when idle).
        """
        with obs_trace.span("engine.schedule"):
            self._expire_deadlines()
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
            # Rows that sample this tick: decoding ones and those whose
            # prompt ends in this chunk.  The one host read of the tick.
            ready = [i for i, s in enumerate(self.active) if s is not None
                     and (s.pending is None or s.pending.size <= lengths[i])]
            toks, finite = self._read_tick(last, ready)

            # Slot quarantine: a poisoned carry shows up as NaN/±inf in its
            # row's logits.  Reset ONLY the poisoned rows; healthy
            # batch-mates take no other code path.
            poisoned = np.zeros((self.n_slots,), bool)
            if finite is not None:
                for i, slot in enumerate(self.active):
                    if slot is not None and not finite[i]:
                        poisoned[i] = True
                        self.errors[slot.request_id] = ERR_POISONED
                        self.n_quarantined += 1
                        self.active[i] = None
                        obs_metrics.inc("serve_quarantine_total")
                        self._request_done(slot.request_id, "quarantine",
                                           slot=i)
            if poisoned.any():
                self.reset(poisoned)

            ready = []
            for i, slot in enumerate(self.active):
                if slot is None:
                    continue
                if slot.pending is not None:
                    take = int(lengths[i])
                    slot.pending = slot.pending[take:]
                    slot.consumed += take
                    self._maybe_cache_prefix(i, slot)
                    if slot.pending.size:     # prompt not done — no sample
                        continue
                    slot.pending = None
                ready.append(i)
            if toks is None and ready:        # a custom sampler: per row
                toks = dict(zip(ready, self._sample_custom(last, ready)))
            now = time.perf_counter()
            for i in ready:
                slot = self.active[i]
                t = int(toks[i])
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

    # ------------------------------------------------------------ migration
    @torch.inference_mode()
    def export_requests(self, *, reason: str = "drain") -> list[dict]:
        """Lift every queued + active request out as migration descriptors.

        An active request's entire context is its per-layer ``(m, u, w)``
        carry, copied to the host, so moving it to another engine costs a
        dict copy, not a KV-cache transfer.  Each descriptor carries that
        carry plus the tokens not yet folded into it (mid-prefill: the
        unconsumed prompt tail; decoding: the last sampled token), the
        emitted tokens, the step counter and the deadline as *remaining*
        budget.  Feed descriptors to another engine's
        :meth:`inject_request`: the continuation is byte-identical, since
        sampling seeds are ``(request_id, step)``-absolute.

        The engine is left empty (queue and slots cleared, carries reset);
        ``finished`` / ``errors`` stay for the caller to harvest.
        """
        now = time.perf_counter()

        def _remaining(deadline):
            return None if deadline is None else deadline - now

        descs: list[dict] = []
        occupied = np.zeros((self.n_slots,), bool)
        for i, slot in enumerate(self.active):
            if slot is None:
                continue
            occupied[i] = True
            carry = carry_to_host(lm_state_take_slot(self.states, i))
            if slot.pending is not None:
                pending = np.asarray(slot.pending, np.int32)
            else:
                pending = np.asarray([slot.last_token], np.int32)
            descs.append({
                "request_id": slot.request_id,
                "prompt": (None if slot.prompt is None
                           else np.asarray(slot.prompt, np.int32)),
                "tokens": list(slot.tokens),
                "remaining": slot.remaining,
                "n_sampled": slot.n_sampled,
                "deadline_remaining_s": _remaining(slot.deadline),
                "pending": pending,
                "carry": carry,
            })
            self.active[i] = None
            self._request_done(slot.request_id, "request_migrated",
                               reason=reason, n_tokens=len(slot.tokens),
                               active=True)
        for q in self.queue:
            descs.append({
                "request_id": q.request_id,
                "prompt": q.prompt,
                "tokens": list(q.tokens),
                "remaining": q.remaining,
                "n_sampled": q.n_sampled,
                "deadline_remaining_s": _remaining(q.deadline),
                "pending": np.asarray(q.pending, np.int32),
                "carry": q.carry,
            })
            self._request_done(q.request_id, "request_migrated",
                               reason=reason, n_tokens=len(q.tokens),
                               active=False)
        self.queue = []
        if occupied.any():
            self.reset(occupied)
        if descs:
            obs_metrics.inc("serve_migrated_total", len(descs))
        obs_metrics.set_gauge("serve_queue_depth", 0)
        obs_metrics.set_gauge("serve_slot_occupancy", 0.0)
        return descs

    def inject_request(self, desc: dict, *, force: bool = False) -> int:
        """Admit a migration descriptor from :meth:`export_requests`.

        * **carry present** (drain): the carry seeds the slot at admission
          and only ``desc["pending"]`` is folded on top.
        * **carry absent** (crash — the carry died with the replica): the
          prompt plus every emitted token is replayed from the ⊕-identity
          init; the loss is re-folding work, never a request or a token.

        ``force=True`` bypasses ``max_queue``: a migrated request was
        already admitted tier-wide.  ``submitted_at`` restarts at
        injection.
        """
        rid = int(desc["request_id"])
        if (rid in self.submitted_at or rid in self.finished
                or rid in self.errors):
            raise ValueError(f"request_id {rid} already known to this engine")
        if (not force and self.max_queue is not None
                and len(self.queue) >= self.max_queue):
            self._shed()
            raise EngineOverloaded(
                f"admission queue full ({len(self.queue)}/{self.max_queue} "
                "queued); inject elsewhere or force=True")
        remaining = int(desc["remaining"])
        if remaining < 1:
            raise ValueError(f"request {rid}: remaining={remaining} < 1 "
                             "(finished requests are not migratable)")
        carry = desc.get("carry")
        prompt = desc.get("prompt")
        prompt = None if prompt is None else np.asarray(prompt, np.int32)
        tokens = [int(t) for t in desc.get("tokens", [])]
        if carry is not None:
            pending = np.asarray(desc["pending"], np.int32)
        else:
            if prompt is None:
                raise ValueError(
                    f"request {rid}: carry-less descriptor needs the "
                    "original prompt to recompute from")
            pending = (np.concatenate(
                [prompt, np.asarray(tokens, np.int32)]) if tokens
                else prompt)
        dl = desc.get("deadline_remaining_s")
        now = time.perf_counter()
        self.queue.append(_Queued(
            request_id=rid, pending=pending, remaining=remaining,
            deadline=None if dl is None else now + dl,
            prompt=prompt, tokens=tokens,
            n_sampled=int(desc.get("n_sampled", len(tokens))),
            carry=carry))
        self._next_id = max(self._next_id, rid + 1)
        self.submitted_at[rid] = now
        obs_metrics.inc("serve_injected_total")
        obs_metrics.set_gauge("serve_queue_depth", len(self.queue))
        obs_events.emit("request_injected", rid=rid,
                        n_tokens=len(tokens), carried=carry is not None)
        return rid

    # -------------------------------------------------- snapshot / restore
    @torch.inference_mode()
    def snapshot(self) -> dict:
        """Serialise the engine: carries + scheduler bookkeeping.

        Returns ``{"tree": {"states": host carries, "seed": int64 array},
        "meta": <JSON-able>}`` — the JAX package's layout with the integer
        seed in place of the JAX key.  Deadlines are stored as *remaining*
        seconds.
        """
        now = time.perf_counter()

        def _remaining(deadline):
            return None if deadline is None else deadline - now

        def _slot_meta(slot: _Slot | None):
            if slot is None:
                return None
            return {
                "request_id": slot.request_id,
                "pending": (None if slot.pending is None
                            else slot.pending.tolist()),
                "tokens": list(slot.tokens),
                "remaining": slot.remaining,
                "n_sampled": slot.n_sampled,
                "last_token": slot.last_token,
                "deadline_remaining_s": _remaining(slot.deadline),
                "prompt": (None if slot.prompt is None
                           else slot.prompt.tolist()),
                "consumed": slot.consumed,
            }

        def _queued_meta(q: _Queued):
            if q.carry is not None and q.prompt is None:
                # Only reachable by migrating a restored slot (restore()
                # keeps no hashes) and snapshotting before it re-slots.
                raise RuntimeError(
                    f"request {q.request_id}: queued migrated carry with "
                    "no original prompt cannot be snapshotted")
            if q.carry is not None:
                # Recompute form: replay prompt + emitted from the init.
                pending = list(q.prompt.tolist()) + list(q.tokens)
            else:
                pending = q.pending.tolist()
            return {
                "request_id": q.request_id,
                "prompt": None if q.prompt is None else q.prompt.tolist(),
                "pending": pending,
                "tokens": list(q.tokens),
                "n_sampled": q.n_sampled,
                "max_new": q.remaining,      # the JAX package's field name
                "deadline_remaining_s": _remaining(q.deadline),
            }

        tree = {"states": carry_to_host(self.states),
                "seed": np.asarray(self.seed, np.int64)}
        meta = {
            "active": [_slot_meta(s) for s in self.active],
            "queue": [_queued_meta(q) for q in self.queue],
            "finished": {str(k): v for k, v in self.finished.items()},
            "errors": {str(k): v for k, v in self.errors.items()},
            "n_shed": self.n_shed,
            "n_quarantined": self.n_quarantined,
            "next_id": self._next_id,
            "n_slots": self.n_slots,
            "chunk": self.chunk,
        }
        return {"tree": tree, "meta": meta}

    @torch.inference_mode()
    def restore(self, snap: dict) -> None:
        """Restore engine state from a :meth:`snapshot` dict (carries as
        numpy arrays or tensors).  The engine must have the snapshotting
        engine's model config, ``n_slots`` and ``chunk``."""
        meta = snap["meta"]
        if meta["n_slots"] != self.n_slots or meta["chunk"] != self.chunk:
            raise ValueError(
                f"snapshot taken with n_slots={meta['n_slots']}, "
                f"chunk={meta['chunk']}; this engine has "
                f"n_slots={self.n_slots}, chunk={self.chunk}")
        now = time.perf_counter()

        def _absolute(remaining):
            return None if remaining is None else now + remaining

        def _slot(m):
            if m is None:
                return None
            prompt = m.get("prompt")
            return _Slot(
                request_id=m["request_id"],
                pending=(None if m["pending"] is None
                         else np.asarray(m["pending"], np.int32)),
                tokens=list(m["tokens"]),
                remaining=m["remaining"],
                n_sampled=m["n_sampled"],
                last_token=m["last_token"],
                deadline=_absolute(m["deadline_remaining_s"]),
                prompt=(None if prompt is None
                        else np.asarray(prompt, np.int32)),
                # hashes stays None: restored in-flight prefills skip cache
                # insertion.
                consumed=int(m.get("consumed", 0)),
            )

        states = snap["tree"]["states"]
        if torch.is_tensor(tree_leaves(states)[0]):
            self.states = tree_map(lambda x: x.to(self.device), states)
        else:
            self.states = carry_to_device(states, self.device,
                                          self._init_states)
        self.seed = int(snap["tree"]["seed"])
        self.active = [_slot(m) for m in meta["active"]]
        self.queue = [
            _Queued(
                request_id=q["request_id"],
                pending=np.asarray(q.get("pending", q["prompt"]), np.int32),
                remaining=int(q["max_new"]),
                deadline=_absolute(q["deadline_remaining_s"]),
                prompt=(None if q.get("prompt") is None
                        else np.asarray(q["prompt"], np.int32)),
                tokens=list(q.get("tokens", [])),
                n_sampled=int(q.get("n_sampled", 0)))
            for q in meta["queue"]
        ]
        self.finished = {int(k): list(v) for k, v in meta["finished"].items()}
        self.errors = {int(k): v for k, v in meta["errors"].items()}
        self.n_shed = int(meta["n_shed"])
        self.n_quarantined = int(meta["n_quarantined"])
        self._next_id = int(meta["next_id"])
        # The lifecycle invariant holds across restore too.
        free = np.asarray([s is None for s in self.active], bool)
        if free.any():
            self.reset(free)
        # Submission re-seeded at restore time: a restore is a new clock
        # epoch, so latencies after it exclude the time before.
        self.submitted_at = {
            rid: now
            for rid in ([s.request_id for s in self.active if s is not None]
                        + [q.request_id for q in self.queue])
        }
        self.first_token_at = {}
        obs_metrics.set_gauge("serve_queue_depth", len(self.queue))
        obs_metrics.set_gauge(
            "serve_slot_occupancy",
            sum(s is not None for s in self.active) / self.n_slots)

    def save(self, directory: str, step: int) -> str:
        """Atomic crash-safe engine checkpoint (``checkpoint/io.py``)."""
        from repro_torch.checkpoint import save_checkpoint
        snap = self.snapshot()
        return save_checkpoint(directory, step, snap["tree"],
                               extra={"engine": snap["meta"]})

    def load(self, directory: str, step: int | None = None) -> int:
        """Restore from :meth:`save`, falling back past corrupt steps.  The
        carries are read into host arrays (the f32 layout :meth:`snapshot`
        writes) and copied to the engine's device in each leaf's dtype.
        Returns the step the engine was restored from."""
        from repro_torch.checkpoint import restore_checkpoint
        template = {
            "states": carry_to_host(lm_state_init(self.api.cfg, self.n_slots,
                                                  device="cpu")),
            "seed": np.asarray(self.seed, np.int64),
        }
        tree, step_restored, extra = restore_checkpoint(
            directory, template, step)
        self.restore({"tree": tree, "meta": extra["engine"]})
        return step_restored

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

    def _read_tick(self, last: torch.Tensor, ready: list[int]):
        """The tick's one device read: ({row: token} or None, per-row
        finiteness or None).

        A ``batched`` sampler samples all S rows in one call (rows not in
        ``ready`` get the seed of request -1 and are discarded — a fixed
        shape beats a gather), and the tokens come back in the same
        transfer as the rows' finiteness.  A custom sampler runs after the
        quarantine (:meth:`_sample_custom`), so this reads finiteness only.
        """
        finite = (torch.isfinite(last).flatten(1).all(dim=1)
                  if self.guard_logits else None)
        if ready and getattr(self.sampler, "batched", False):
            rids = np.full((self.n_slots,), -1, np.int64)
            steps = np.zeros((self.n_slots,), np.int64)
            for i in ready:
                rids[i] = self.active[i].request_id
                steps[i] = self.active[i].n_sampled
            toks = _sample_rows(self.sampler, last, self.seed, rids, steps)
            if finite is None:
                return toks.tolist(), None
            host = torch.stack([toks, finite.to(torch.int64)]).tolist()
            return host[0], host[1]
        return None, (None if finite is None else finite.tolist())

    def _sample_custom(self, last: torch.Tensor, ready: list[int]) -> list:
        rows = [self.active[i] for i in ready]
        return _sample_rows(self.sampler, last[ready], self.seed,
                            [s.request_id for s in rows],
                            [s.n_sampled for s in rows]).tolist()

    def _shed(self) -> None:
        self.n_shed += 1
        obs_metrics.inc("serve_shed_total")
        obs_events.emit("request_shed", queue_depth=len(self.queue),
                        max_queue=self.max_queue)

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

    def _expire_deadlines(self) -> None:
        """Error out queued + active requests whose deadline has passed."""
        now = time.perf_counter()
        kept = []
        for q in self.queue:
            if q.deadline is not None and now > q.deadline:
                self.errors[q.request_id] = ERR_DEADLINE
                obs_metrics.inc("serve_deadline_expired_total")
                self._request_done(q.request_id, "deadline_expired",
                                   queued=True)
            else:
                kept.append(q)
        self.queue = kept
        expired = np.zeros((self.n_slots,), bool)
        for i, slot in enumerate(self.active):
            if (slot is not None and slot.deadline is not None
                    and now > slot.deadline):
                self.errors[slot.request_id] = ERR_DEADLINE
                self.active[i] = None
                expired[i] = True
                obs_metrics.inc("serve_deadline_expired_total")
                self._request_done(slot.request_id, "deadline_expired",
                                   queued=False)
        if expired.any():
            self.reset(expired)

    def _put(self, i: int, carry: list) -> None:
        """Write a host carry into slot ``i``."""
        mask = torch.zeros(self.n_slots, dtype=torch.bool)
        mask[i] = True
        self.states = lm_state_put_slot(
            self.states,
            carry_to_device(carry, self.device, self._init_states),
            mask.to(self.device))

    def _admit(self) -> None:
        """Move queued requests into free slots.

        Free slots already hold the init carry, so admission only *writes*
        state for a migrated carry or a prefix-cache hit.
        """
        for i in range(self.n_slots):
            if self.active[i] is not None or not self.queue:
                continue
            q = self.queue.pop(0)
            slot = _Slot(request_id=q.request_id, pending=q.pending,
                         tokens=list(q.tokens), remaining=q.remaining,
                         n_sampled=q.n_sampled,
                         deadline=q.deadline, prompt=q.prompt)
            migrated = q.carry is not None or q.n_sampled > 0
            if q.carry is not None:
                # Drain-migrated: q.pending holds only the tokens not yet
                # folded into the carry.
                self._put(i, q.carry)
            elif self.prefix_cache is not None and not migrated:
                # Migrated requests skip the cache both ways: their grid
                # hashes died with the donor, and a replayed pending
                # (prompt + generated tokens) is not a prompt.
                match_len, carry, hashes = self.prefix_cache.lookup(
                    q.pending)
                slot.hashes = hashes
                if match_len:
                    self._put(i, carry)
                    slot.pending = q.pending[match_len:]
                    slot.consumed = match_len
            self.active[i] = slot

    def _maybe_cache_prefix(self, i: int, slot: _Slot) -> None:
        """Copy slot ``i``'s carry into the prefix cache when the prefill
        just crossed a chunk-grid boundary the cache wants.  Runs after the
        step, so row ``i`` is exactly the carry of ``prompt[:consumed]``."""
        cache = self.prefix_cache
        if (cache is None or slot.hashes is None
                or slot.consumed % self.chunk != 0):
            return
        h = slot.hashes.get(slot.consumed)
        if h is None or not cache.wants(slot.consumed, h):
            return
        cache.insert(slot.prompt[:slot.consumed], h,
                     carry_to_host(lm_state_take_slot(self.states, i)))
