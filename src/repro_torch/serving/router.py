"""Replicated serving tier — port of ``repro.serving.router``.

A :class:`ReplicatedRouter` owns N :class:`~repro_torch.serving.engine
.StreamingEngine` replicas — one params copy on one device, independent
slot batches — and presents the same submit/step/run surface as one
engine.  As in the JAX package:

* **Routing** (:data:`POLICIES`): requests enter through one bounded front
  queue and go to the replica a policy ranks best — least-occupancy by
  default, round-robin and join-shortest-queue as alternates, or any
  callable ``views -> ranked indices``.  Rankings read the per-replica
  ``serve_*`` gauges (each replica's engine calls run under
  ``obs.metrics.label_scope(replica=i)``) and fall back to the engines'
  own bookkeeping when no registry is installed.
* **Degradation composes tier-wide**: a replica's ``EngineOverloaded``
  re-routes to the next-best replica; the router sheds only when every
  replica rejected AND the front queue is full; deadlines travel as
  remaining budget.
* **Carry migration**: :meth:`drain` lifts a replica's queued and active
  requests out through ``export_requests`` (an active request's context is
  its per-layer ``(m, u, w)`` carry, copied to the host) and re-injects
  them on the survivors byte-identically.  Crash **failover** rebuilds the
  requests of a replica whose carries died with it from the router's
  shadow records (prompt + emitted tokens) in recompute form.  Request ids
  are allocated tier-wide and sampling seeds are ``(request_id,
  step)``-absolute, so no two replicas reuse a seed.

One prefix cache may be shared by all replicas (a prefix made hot on
replica A hits on B); the cache locks itself for this.

Replicas on one device step one after the other on the calling thread:
their kernels share the device's stream, and on an H100 two full-width
replicas stepped on threads took 132 ms a tier tick against 55 ms in turn
(``benchmarks/torch/tier_step_ab.py``), the threads contending for the
interpreter lock.  Replicas on distinct devices, or any tier built with
``parallel_step=True``, step on worker threads, one per alive replica.
Each worker enters ``label_scope`` itself (the labels are thread-local, as
is the ``torch.inference_mode`` that ``StreamingEngine.step`` enters); the
kernels' launch counters take one lock.  Call :meth:`warmup` before the
first threaded tick: it builds and loads the kernels once, on the calling
thread.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving.engine import (
    ERR_DEADLINE,
    EngineOverloaded,
    StreamingEngine,
    _validate_request,
)
from repro_torch.serving.sampler import greedy_sampler

# ---------------------------------------------------------------------------
# Replica views + routing policies
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReplicaView:
    """Point-in-time dispatch facts about one replica."""

    index: int
    alive: bool
    queue_depth: int
    occupancy: float          # active slots / n_slots
    free_slots: int


def least_occupancy(views: list[ReplicaView]) -> list[int]:
    """Prefer the emptiest batch: occupancy, then queue depth, then index."""
    return [v.index for v in sorted(
        (v for v in views if v.alive),
        key=lambda v: (v.occupancy, v.queue_depth, v.index))]


def join_shortest_queue(views: list[ReplicaView]) -> list[int]:
    """Classic JSQ: total backlog (queued + active), then index.

    ``queue_depth - free_slots`` orders as ``queued + active`` does on a
    homogeneous tier, and is computable from the view alone.
    """
    return [v.index for v in sorted(
        (v for v in views if v.alive),
        key=lambda v: (v.queue_depth - v.free_slots, v.occupancy,
                       v.index))]


class RoundRobin:
    """Stateful rotation over the alive replicas."""

    def __init__(self):
        self._turn = 0

    def __call__(self, views: list[ReplicaView]) -> list[int]:
        alive = [v.index for v in views if v.alive]
        if not alive:
            return []
        start = self._turn % len(alive)
        self._turn += 1
        return alive[start:] + alive[:start]


#: name -> zero-arg factory returning a policy callable
#: ``(list[ReplicaView]) -> ranked alive indices``.
POLICIES: dict[str, Callable[[], Callable]] = {
    "least-occupancy": lambda: least_occupancy,
    "round-robin": RoundRobin,
    "jsq": lambda: join_shortest_queue,
}


def make_policy(policy) -> Callable:
    if callable(policy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown route policy {policy!r}; choose from "
            f"{sorted(POLICIES)} or pass a callable") from None


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------


class ReplicatedRouter:
    """N engine replicas behind one bounded queue + routing policy.

    Mirrors the single-engine surface (``submit`` / ``step`` / ``run`` /
    ``finished`` / ``errors``).  ``max_queue`` bounds the *front* queue;
    each replica bounds its own admission queue at ``replica_max_queue``
    (default ``n_slots``), so "saturated" is a per-replica signal the
    re-route can bounce off.

    ``submit``/``step``/``drain`` are meant for one serving thread (replica
    *stepping* is what fans out to workers).
    """

    def __init__(self, api, params, *, n_replicas: int = 2,
                 n_slots: int = 4, chunk: int | None = None,
                 sampler: Callable = greedy_sampler,
                 seed: int = 0,
                 policy="least-occupancy",
                 max_queue: int | None = None,
                 replica_max_queue: int | None = None,
                 guard_logits: bool = True,
                 prefix_cache=None,
                 parallel_step: bool | None = None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if replica_max_queue is None:
            replica_max_queue = n_slots
        self.n_replicas = n_replicas
        self.max_queue = max_queue
        self.policy = make_policy(policy)
        self.prefix_cache = prefix_cache
        self.engines: list[StreamingEngine] = []
        for i in range(n_replicas):
            with obs_metrics.label_scope(replica=i):
                self.engines.append(StreamingEngine(
                    api, params, n_slots=n_slots, chunk=chunk,
                    sampler=sampler, seed=seed,
                    max_queue=replica_max_queue,
                    guard_logits=guard_logits,
                    prefix_cache=prefix_cache))
        self.alive = [True] * n_replicas
        #: front queue of undispatched descriptors (dicts in the
        #: export_requests shape; fresh requests have no carry/tokens).
        self.front: list[dict] = []
        self.finished: dict[int, list[int]] = {}
        self.errors: dict[int, str] = {}
        #: shadow records for crash rebuild: rid -> {prompt, tokens,
        #: max_new, deadline (absolute), replica}.  tokens aliases the live
        #: slot list once the request is slotted.
        self._records: dict[int, dict] = {}
        self._next_id = 0
        self.n_shed = 0
        self.n_rerouted = 0
        self.n_migrated = 0
        self.n_failed_over = 0
        self._pool: ThreadPoolExecutor | None = None
        if parallel_step is None:
            parallel_step = len({str(e.device) for e in self.engines}) > 1
        self._parallel = parallel_step
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ API
    def warmup(self) -> float:
        """Warm every replica up in turn on this thread (the kernels are
        built and loaded once, before any worker runs).  Returns the wall
        seconds spent."""
        t0 = time.perf_counter()
        for i, eng in enumerate(self.engines):
            with obs_metrics.label_scope(replica=i):
                eng.warmup()
        return time.perf_counter() - t0

    def submit(self, prompt, max_new_tokens: int, *,
               deadline_s: float | None = None) -> int:
        """Admit one request tier-wide; returns its (tier-unique) id.

        Raises :class:`EngineOverloaded` only when every alive replica
        rejected it AND the front queue is at ``max_queue``.
        """
        prompt = _validate_request(prompt, max_new_tokens, deadline_s)
        with self._lock:
            now = time.perf_counter()
            desc = {
                "request_id": None,        # allocated after the shed check
                "prompt": prompt,
                "tokens": [],
                "remaining": int(max_new_tokens),
                "n_sampled": 0,
                "deadline": (now + deadline_s
                             if deadline_s is not None else None),
                "carry": None,
            }
            self._flush_front()
            # The shed decision comes before any id or record, so nothing
            # is half-admitted; a non-empty front queue means earlier
            # requests still wait — FIFO, no queue-jumping.
            must_queue = bool(self.front) or not self._dispatch_would_fit()
            if must_queue and (self.max_queue is not None
                               and len(self.front) >= self.max_queue):
                self.n_shed += 1
                obs_metrics.inc("router_shed_total")
                obs_events.emit(
                    "request_shed", tier=True,
                    front_depth=len(self.front), max_queue=self.max_queue)
                raise EngineOverloaded(
                    f"all {sum(self.alive)} replicas saturated and the "
                    f"front queue is full ({len(self.front)}/"
                    f"{self.max_queue}); retry later")
            rid = self._next_id
            self._next_id += 1
            desc["request_id"] = rid
            self._records[rid] = {
                "prompt": prompt, "tokens": desc["tokens"],
                "max_new": int(max_new_tokens),
                "deadline": desc["deadline"], "replica": None,
            }
            obs_metrics.inc("router_requests_total")
            if must_queue or not self._dispatch(desc):
                self.front.append(desc)
            self._update_gauges()
            return rid

    def step(self) -> int:
        """One tier tick: expire, flush the front queue, step every alive
        replica (on threads when they are on distinct devices), fail over
        crashed ones, harvest results.

        Returns the number of tokens emitted across the tier.
        """
        self._expire_front()
        self._flush_front()
        idxs = [i for i in range(self.n_replicas) if self.alive[i]]

        def _tick(i: int):
            try:
                with obs_metrics.label_scope(replica=i):
                    return self.engines[i].step()
            except Exception as exc:       # crash -> failover, not unwind
                return exc

        if self._parallel and len(idxs) > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.n_replicas,
                    thread_name_prefix="repro-replica")
            results = list(self._pool.map(_tick, idxs))
        else:
            results = [_tick(i) for i in idxs]

        emitted = 0
        for i, res in zip(idxs, results):
            if isinstance(res, Exception):
                self._failover(i, error=res)
            else:
                emitted += res
        self._harvest()
        self._update_gauges()
        return emitted

    def run(self, max_steps: int | None = None) -> dict[int, list[int]]:
        """Serve until the tier drains.  Returns {request_id: tokens}."""
        steps = 0
        while self.front or any(
                self.alive[i] and (self.engines[i].queue
                                   or any(s is not None
                                          for s in self.engines[i].active))
                for i in range(self.n_replicas)):
            if not any(self.alive):
                raise RuntimeError(
                    f"no alive replicas with {len(self.front)} requests "
                    "outstanding; reinstate() or add capacity")
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.finished

    def close(self) -> None:
        """Stop the worker threads (a later threaded step starts new ones)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # -------------------------------------------------- drain / failover
    def drain(self, index: int, *, reason: str = "drain") -> int:
        """Migrate replica ``index``'s queued + active requests, carries
        included, to the survivors and remove it from the dispatch set.
        Returns the number of requests migrated.  The engine stays, for
        :meth:`reinstate` after maintenance."""
        if not self.alive[index]:
            raise ValueError(f"replica {index} is not alive")
        self.alive[index] = False
        with obs_metrics.label_scope(replica=index):
            descs = self.engines[index].export_requests(reason=reason)
        self.n_migrated += len(descs)
        if descs:
            obs_metrics.inc("router_migrations_total", len(descs))
        now = time.perf_counter()
        for desc in descs:
            # Remaining-budget deadlines pinned to this clock, so front
            # queue expiry keeps billing.
            rel = desc.pop("deadline_remaining_s", None)
            desc["deadline"] = None if rel is None else now + rel
            rec = self._records.get(desc["request_id"])
            if rec is not None:
                rec["replica"] = None
                rec["tokens"] = list(desc["tokens"])
            if not self._dispatch(desc, migration=True):
                self.front.append(desc)
        obs_events.emit("replica_drained", replica=index,
                        migrated=len(descs), reason=reason)
        self._update_gauges()
        return len(descs)

    def reinstate(self, index: int) -> None:
        """Return a drained (or replaced-after-crash) replica to duty."""
        self.alive[index] = True
        self._update_gauges()

    def _failover(self, index: int, *, error: Exception) -> None:
        """Crash path: the replica's carries are gone; rebuild its
        in-flight requests from the shadow records in recompute form."""
        self.alive[index] = False
        obs_metrics.inc("router_replica_failures_total")
        victims = sorted(
            rid for rid, rec in self._records.items()
            if rec["replica"] == index)
        for rid in victims:
            rec = self._records[rid]
            rec["replica"] = None
            tokens = list(rec["tokens"])
            remaining = rec["max_new"] - len(tokens)
            if remaining < 1:
                # Every owed token was emitted; the completion was never
                # harvested.  Promote instead of re-running.
                self.finished[rid] = tokens
                self._records.pop(rid)
                continue
            desc = {
                "request_id": rid,
                "prompt": rec["prompt"],
                "tokens": tokens,
                "remaining": remaining,
                "n_sampled": len(tokens),
                "deadline": rec["deadline"],
                "carry": None,             # died with the replica
            }
            rec["tokens"] = tokens
            self.n_failed_over += 1
            if not self._dispatch(desc, migration=True):
                self.front.append(desc)
        obs_events.emit("replica_failed", replica=index,
                        error=f"{type(error).__name__}: {error}",
                        failed_over=len(victims))
        self._update_gauges()

    # ------------------------------------------------------------ internals
    def replica_views(self) -> list[ReplicaView]:
        """Live dispatch facts, preferring the per-replica gauges (what a
        remote router would scrape) over the engines' own bookkeeping."""
        reg = obs_metrics.current()
        views = []
        for i, eng in enumerate(self.engines):
            if not self.alive[i]:
                views.append(ReplicaView(i, False, 0, 1.0, 0))
                continue
            qd = occ = None
            if reg is not None:
                labels = {"replica": str(i)}
                qd = reg.peek("serve_queue_depth", labels)
                occ = reg.peek("serve_slot_occupancy", labels)
            if qd is None:
                qd = len(eng.queue)
            n_active = sum(s is not None for s in eng.active)
            if occ is None:
                occ = n_active / eng.n_slots
            views.append(ReplicaView(
                index=i, alive=True, queue_depth=int(qd),
                occupancy=float(occ),
                free_slots=eng.n_slots - n_active))
        return views

    def _dispatch_would_fit(self) -> bool:
        """Cheap pre-check: does any alive replica have queue headroom?"""
        return any(
            self.alive[i] and (
                eng.max_queue is None or len(eng.queue) < eng.max_queue)
            for i, eng in enumerate(self.engines))

    def _dispatch(self, desc: dict, *, migration: bool = False) -> bool:
        """Place ``desc`` on the best replica; True on success.

        Fresh requests go through ``engine.submit`` (a rejection re-routes
        to the next-ranked replica); migrated ones through
        ``engine.inject_request(force=True)`` — already admitted
        tier-wide, a replica bound may delay, never shed, them.
        """
        order = self.policy(self.replica_views())
        now = time.perf_counter()
        for rank, i in enumerate(order):
            if not self.alive[i]:          # policy bug guard
                continue
            eng = self.engines[i]
            deadline = desc.get("deadline")
            remaining_s = None if deadline is None else deadline - now
            try:
                with obs_metrics.label_scope(replica=i):
                    if migration:
                        d = dict(desc)
                        d.pop("deadline", None)
                        d["deadline_remaining_s"] = remaining_s
                        eng.inject_request(d, force=True)
                    else:
                        eng.submit(
                            desc["prompt"], desc["remaining"],
                            deadline_s=remaining_s,
                            request_id=desc["request_id"])
            except EngineOverloaded:
                self.n_rerouted += 1
                obs_metrics.inc("router_rerouted_total")
                continue
            rec = self._records.get(desc["request_id"])
            if rec is not None:
                rec["replica"] = i
            if rank:
                obs_events.emit("request_rerouted",
                                rid=desc["request_id"], replica=i,
                                tried=rank)
            return True
        return False

    def _expire_front(self) -> None:
        now = time.perf_counter()
        kept = []
        for desc in self.front:
            dl = desc.get("deadline")
            if dl is not None and now > dl:
                rid = desc["request_id"]
                self.errors[rid] = ERR_DEADLINE
                self._records.pop(rid, None)
                obs_metrics.inc("router_deadline_expired_total")
                obs_events.emit("deadline_expired", rid=rid, tier=True,
                                queued=True)
            else:
                kept.append(desc)
        self.front = kept

    def _flush_front(self) -> None:
        while self.front:
            desc = self.front[0]
            migration = (desc.get("carry") is not None
                         or desc.get("n_sampled", 0) > 0
                         or bool(desc.get("tokens")))
            if not self._dispatch(desc, migration=migration):
                break
            self.front.pop(0)

    def _harvest(self) -> None:
        """Pull per-replica terminal results up to the tier and alias the
        live token lists into the shadow records."""
        for i, eng in enumerate(self.engines):
            if not self.alive[i]:
                continue
            for slot in eng.active:
                if slot is None:
                    continue
                rec = self._records.get(slot.request_id)
                if rec is not None:
                    rec["tokens"] = slot.tokens     # alias, not copy
            for rid in list(eng.finished):
                self.finished[rid] = eng.finished.pop(rid)
                self._records.pop(rid, None)
            for rid in list(eng.errors):
                self.errors[rid] = eng.errors.pop(rid)
                self._records.pop(rid, None)

    def _update_gauges(self) -> None:
        depths = [len(self.engines[i].queue)
                  for i in range(self.n_replicas) if self.alive[i]]
        n_active = sum(
            sum(s is not None for s in self.engines[i].active)
            for i in range(self.n_replicas) if self.alive[i])
        n_slots = sum(self.engines[i].n_slots
                      for i in range(self.n_replicas) if self.alive[i])
        obs_metrics.set_gauge("router_front_queue_depth", len(self.front))
        obs_metrics.set_gauge("router_queue_depth_total",
                              len(self.front) + sum(depths))
        obs_metrics.set_gauge("router_slot_occupancy",
                              n_active / n_slots if n_slots else 1.0)
        obs_metrics.set_gauge("router_replicas_alive", sum(self.alive))

    def stats(self) -> dict:
        """Tier-level counters (JSON-able)."""
        return {
            "n_replicas": self.n_replicas,
            "alive": sum(self.alive),
            "requests": self._next_id,
            "finished": len(self.finished),
            "errors": len(self.errors),
            "shed": self.n_shed,
            "rerouted": self.n_rerouted,
            "migrated": self.n_migrated,
            "failed_over": self.n_failed_over,
            "front_queue": len(self.front),
        }
