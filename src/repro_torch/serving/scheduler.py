"""Request lifecycle for the continuous-batching engine (the JAX
package's ``serving/scheduler.py``).

A request moves queued -> ready -> (reserved) -> assigned (slot) ->
finished. The scheduler is pure host-side bookkeeping — all tensor state
lives in ``serving.batch.DecodeState``; the engine consults the scheduler
between decode chunks to admit ready requests into freed slots and to
harvest finished ones. Time is measured in decode steps (the engine's
clock advances by ``chunk`` per decode chunk), so ``arrival_step``
simulates a request stream without wall-clock dependence.

SLO-aware scheduling: the queue is priority-ordered (two heaps: future
arrivals by arrival step, ready requests by ``(priority, arrival, submit
order)``), requests carry optional queue
timeouts / absolute deadlines / cancellation points, and a running
request can be PREEMPTED (restart-style: its slot and pages are released,
the request re-enters the ready queue and prefills again on its next
admission). Queueing delay (ready -> dequeue) is tracked separately from
TTFT (dequeue -> first token): a request that waits ten chunks for a slot
but prefills instantly has a large queue delay and a small TTFT.

The *reserved* state backs chunked prefill interleaving
(serving/session.py): a slot whose request is still prefilling chunk by
chunk holds the slot but is not yet decoding, so it must not count as an
active slot (its DecodeState row still says done) nor be harvested.

Each request's lifecycle is traced (``repro_torch.obs``, off unless a
tracer is installed) on its own track of the owning replica's process
(``pid``): ``request/queued`` -> ``request/prefill`` -> ``request/decode``
spans, closed by a ``finish``, ``preempt`` or ``redrive`` instant, at the
points the reference's scheduler emits them.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Optional

import numpy as np

from repro_torch import obs


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Service-level-objective knobs for the serve loop (policy lives in
    serving/session.py; this is just the declaration).

    ``ttft_target_s``: admission is never deferred for a request that has
    already queued longer than this (late requests jump the TPOT gate).
    ``tpot_target_s``: defer admitting NEW work while the measured
    per-token latency of running slots (rolling mean over the last
    ``admit_window`` decode chunks) exceeds this — running requests drain
    first, then admissions resume. Priority-0 requests are never gated.
    ``preempt``: allow a strictly-higher-priority waiter to evict a
    running lower-priority slot (restart-style; pages released through
    ``PoolSession``, request requeued leak-free).
    """
    ttft_target_s: Optional[float] = None
    tpot_target_s: Optional[float] = None
    preempt: bool = False
    admit_window: int = 8


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new_tokens: int
    arrival_step: int = 0         # decode-step clock at which it may be admitted
    frames: Optional[np.ndarray] = None  # (S_enc, D) encoder frames (enc-dec)
    # per-request sampling controls (serving/sampling.py): per-slot state,
    # so mixing them in one stream needs no new decode chunk
    temperature: Optional[float] = None  # None: use serve()'s default
    top_k: int = 0                       # 0: disabled
    top_p: float = 1.0                   # >= 1: disabled
    # SLO attributes
    priority: int = 1                    # 0 = most urgent; ties break FIFO
    queue_timeout_steps: Optional[int] = None  # drop if not admitted by then
    deadline_steps: Optional[int] = None       # abort (even running) after
                                               # arrival + deadline steps
    cancel_at_step: Optional[int] = None       # simulated client cancel


@dataclasses.dataclass
class RequestOutput:
    rid: int
    tokens: np.ndarray            # (P + generated,) int32
    prompt_len: int
    logprobs: np.ndarray          # (generated,) f32 chosen-token logprobs
    finish_reason: str            # "eos" | "length" | "timeout" |
                                  # "cancelled" | "deadline"
    admitted_step: int            # -1: dropped before ever holding a slot
    finished_step: int
    # wall-clock latency (chunk-granular: the engine marks the first chunk
    # whose harvest shows generated tokens; None when never marked)
    ttft_s: Optional[float] = None       # dequeue -> first generated token
    tpot_s: Optional[float] = None       # per-token after the first
    # queueing delay, reported separately from TTFT: ready -> dequeue
    queue_delay_s: Optional[float] = None
    queue_delay_steps: Optional[int] = None
    priority: int = 1
    preempted: int = 0            # times this request lost its slot

    @property
    def generated(self) -> np.ndarray:
        return self.tokens[self.prompt_len:]


class Scheduler:
    """Priority admission queue + slot table over fixed decode slots."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        # trace pid: the owning session stamps its replica id, so request
        # lifecycle spans land on that replica's process
        self.pid = 0
        # future arrivals, by simulated arrival step
        self._arrivals: list[tuple[int, int, Request]] = []
        # arrived and admissible, by (priority, arrival, fifo seq)
        self._ready: list[tuple[int, int, int, Request]] = []
        self._seq = 0
        self._slots: list[Optional[Request]] = [None] * num_slots  # decoding
        self._reserved: dict[int, Request] = {}                    # prefilling
        self._cancelled: set[int] = set()
        self._ready_wall: dict[int, float] = {}
        self._admitted_step: dict[int, int] = {}
        self._admitted_wall: dict[int, float] = {}
        self._first_token_wall: dict[int, float] = {}
        self._queue_delay: dict[int, tuple[int, Optional[float]]] = {}
        self._preempt_count: dict[int, int] = {}
        self.finished: list[RequestOutput] = []
        self.preemptions = 0
        self.timeouts = 0
        self.cancels = 0

    # -- queue --------------------------------------------------------------
    def submit(self, req: Request) -> None:
        heapq.heappush(self._arrivals, (req.arrival_step, req.rid, req))

    def cancel(self, rid: int) -> None:
        """Client-side cancellation: takes effect at the next tick whether
        the request is queued, prefilling, or decoding."""
        self._cancelled.add(rid)

    def poll(self, clock: int, wall: Optional[float] = None) -> None:
        """Move requests whose arrival step has come into the ready queue
        (recording the wall time the queue-delay clock starts from)."""
        wall = time.perf_counter() if wall is None else wall
        while self._arrivals and self._arrivals[0][0] <= clock:
            _, rid, req = heapq.heappop(self._arrivals)
            self._push_ready(req)
            self._ready_wall.setdefault(rid, wall)

    def _push_ready(self, req: Request) -> None:
        self._seq += 1
        heapq.heappush(self._ready,
                       (req.priority, req.arrival_step, self._seq, req))
        # every path into the ready queue (arrival, requeue, preemption,
        # failed insert) opens or reopens the request's "queued" span
        obs.request_phase(self.pid, req.rid, "queued",
                          args={"priority": req.priority})

    def drop_reason(self, req: Request, clock: int,
                    queued: bool = False) -> Optional[str]:
        """Why ``req`` must stop now (None: keep going). Queue timeouts
        only apply while queued; deadlines and cancellation always do."""
        if (req.rid in self._cancelled
                or (req.cancel_at_step is not None
                    and clock >= req.cancel_at_step)):
            return "cancelled"
        if (req.deadline_steps is not None
                and clock - req.arrival_step >= req.deadline_steps):
            return "deadline"
        if (queued and req.queue_timeout_steps is not None
                and clock - req.arrival_step >= req.queue_timeout_steps):
            return "timeout"
        return None

    def expire(self, clock: int) -> None:
        """Finalize queued requests that timed out / were cancelled / can
        no longer meet their deadline — they leave the queue without ever
        holding a slot."""
        kept = []
        for pri, arr, seq, req in self._ready:
            reason = self.drop_reason(req, clock, queued=True)
            if reason is None:
                kept.append((pri, arr, seq, req))
            else:
                self._finish_unadmitted(req, reason, clock)
        if len(kept) != len(self._ready):
            heapq.heapify(kept)
            self._ready = kept
        kept_a = []
        for a, r, q in self._arrivals:
            reason = self.drop_reason(q, clock, queued=True)
            if reason is None:
                kept_a.append((a, r, q))
            else:
                self._finish_unadmitted(q, reason, clock)
        if len(kept_a) != len(self._arrivals):
            heapq.heapify(kept_a)
            self._arrivals = kept_a

    def _finish_unadmitted(self, req: Request, reason: str,
                           clock: int) -> None:
        obs.request_done(self.pid, req.rid, "finish",
                         args={"reason": reason})
        self._count_drop(reason)
        self._ready_wall.pop(req.rid, None)
        self.finished.append(RequestOutput(
            rid=req.rid, tokens=np.asarray(req.prompt, np.int32),
            prompt_len=len(req.prompt),
            logprobs=np.zeros((0,), np.float32), finish_reason=reason,
            admitted_step=-1, finished_step=clock,
            queue_delay_s=None, queue_delay_steps=clock - req.arrival_step,
            priority=req.priority,
            preempted=self._preempt_count.pop(req.rid, 0)))

    def _count_drop(self, reason: str) -> None:
        if reason == "cancelled":
            self.cancels += 1
        elif reason == "timeout":
            self.timeouts += 1

    def next_ready(self, clock: int) -> Optional[Request]:
        """Pop the highest-priority ready request (FIFO within a class),
        finalizing any expired entries encountered on the way."""
        self.poll(clock)
        while self._ready:
            req = heapq.heappop(self._ready)[3]
            reason = self.drop_reason(req, clock, queued=True)
            if reason is not None:
                self._finish_unadmitted(req, reason, clock)
                continue
            return req
        return None

    def peek_ready(self, clock: int) -> Optional[Request]:
        """Highest-priority ready request without dequeuing it (the SLO
        admission gate inspects priority and queueing age)."""
        self.poll(clock)
        while self._ready:
            req = self._ready[0][3]
            reason = self.drop_reason(req, clock, queued=True)
            if reason is None:
                return req
            heapq.heappop(self._ready)
            self._finish_unadmitted(req, reason, clock)
        return None

    def ready_wall(self, rid: int) -> Optional[float]:
        return self._ready_wall.get(rid)

    def next_arrival(self) -> Optional[int]:
        """Earliest pending arrival step; ready requests count as already
        arrived (step 0 effectively)."""
        if self._ready:
            return self._ready[0][1]
        return self._arrivals[0][0] if self._arrivals else None

    def requeue(self, req: Request) -> None:
        """Push a dequeued request back (admission backpressure — e.g. the
        paged pool cannot supply its pages until a slot drains). The
        queue-delay clock keeps running from the original ready time."""
        self._push_ready(req)

    # -- slots --------------------------------------------------------------
    def reserve(self, slot: int, req: Request, clock: int,
                wall: Optional[float] = None) -> None:
        """Dequeue ``req`` into ``slot`` for (possibly chunked) prefill.
        The queue-delay clock stops here; the TTFT clock starts here —
        ``wall`` lets the engine stamp the dequeue time BEFORE prefill so
        prefill cost (and the prefix cache skipping it) shows in ttft_s."""
        assert self._slots[slot] is None and slot not in self._reserved, \
            f"slot {slot} busy"
        wall = time.perf_counter() if wall is None else wall
        obs.request_phase(self.pid, req.rid, "prefill",
                          args={"slot": slot})
        self._reserved[slot] = req
        self._admitted_step[req.rid] = clock
        self._admitted_wall[req.rid] = wall
        ready_wall = self._ready_wall.pop(req.rid, None)
        self._queue_delay[req.rid] = (
            clock - req.arrival_step,
            None if ready_wall is None else max(0.0, wall - ready_wall))

    def activate(self, slot: int) -> None:
        """Prefill finished and the request was inserted: the slot starts
        decoding (counts toward occupancy, eligible for harvest)."""
        req = self._reserved.pop(slot)
        assert self._slots[slot] is None, f"slot {slot} busy"
        self._slots[slot] = req
        obs.request_phase(self.pid, req.rid, "decode",
                          args={"slot": slot})

    def assign(self, slot: int, req: Request, clock: int,
               wall: Optional[float] = None) -> None:
        """Monolithic admission: reserve + activate in one step."""
        self.reserve(slot, req, clock, wall=wall)
        self.activate(slot)

    def unreserve(self, slot: int, requeue: bool = True) -> Request:
        """Abandon a reservation (e.g. the pool could not supply pages at
        insert time): the request re-enters the ready queue with its
        original queue-delay clock, nothing is recorded."""
        req = self._reserved.pop(slot)
        self._admitted_step.pop(req.rid, None)
        wall = self._admitted_wall.pop(req.rid, None)
        delay = self._queue_delay.pop(req.rid, None)
        if requeue:
            # restore the ready-time so the eventual admission reports the
            # full wait, not just the tail after this failed attempt
            if delay is not None and delay[1] is not None and wall is not None:
                self._ready_wall[req.rid] = wall - delay[1]
            self._push_ready(req)  # reopens the queued span
        else:
            obs.request_done(self.pid, req.rid, "finish",
                             args={"reason": "unreserved"})
        return req

    def reserved_slots(self) -> list[tuple[int, Request]]:
        return sorted(self._reserved.items())

    def reserved_request(self, slot: int) -> Request:
        return self._reserved[slot]

    def drop_reserved(self, slot: int, reason: str, clock: int) -> Request:
        """A prefilling request was cancelled / deadlined: finalize it
        with no generated tokens (the caller unpins any prefix match)."""
        req = self._reserved.pop(slot)
        obs.request_done(self.pid, req.rid, "finish",
                         args={"reason": reason})
        self._count_drop(reason)
        delay = self._queue_delay.pop(req.rid, (None, None))
        self.finished.append(RequestOutput(
            rid=req.rid, tokens=np.asarray(req.prompt, np.int32),
            prompt_len=len(req.prompt),
            logprobs=np.zeros((0,), np.float32), finish_reason=reason,
            admitted_step=self._admitted_step.pop(req.rid, -1),
            finished_step=clock,
            queue_delay_s=delay[1], queue_delay_steps=delay[0],
            priority=req.priority,
            preempted=self._preempt_count.pop(req.rid, 0)))
        self._admitted_wall.pop(req.rid, None)
        return req

    def preempt(self, slot: int) -> Request:
        """Evict a DECODING request (restart-style): it loses its slot and
        all progress, re-enters the ready queue at its own priority, and
        will prefill from scratch when re-admitted. The caller releases
        the slot's tensor/pool state."""
        req = self._slots[slot]
        assert req is not None, f"slot {slot} empty"
        self._slots[slot] = None
        self._admitted_step.pop(req.rid, None)
        self._admitted_wall.pop(req.rid, None)
        self._first_token_wall.pop(req.rid, None)
        delay = self._queue_delay.pop(req.rid, None)
        # the next admission's queue delay spans the preemption wait too
        if delay is not None and delay[1] is not None:
            self._ready_wall[req.rid] = time.perf_counter()
        self._preempt_count[req.rid] = self._preempt_count.get(req.rid, 0) + 1
        self.preemptions += 1
        obs.request_done(self.pid, req.rid, "preempt",
                         args={"slot": slot})
        self._push_ready(req)      # reopens the queued span
        return req

    def preempt_victim(self, priority: int) -> Optional[int]:
        """Slot to evict for a waiter at ``priority``: the lowest-priority
        decoding slot strictly below it; ties prefer the most recently
        admitted (least progress lost). None when no slot qualifies."""
        best = None
        for i, req in enumerate(self._slots):
            if req is None or req.priority <= priority:
                continue
            key = (req.priority, self._admitted_step.get(req.rid, 0), i)
            if best is None or key > best[0]:
                best = (key, i)
        return None if best is None else best[1]

    def mark_first_token(self, slot: int, t: float) -> None:
        """Record the wall time of the first chunk whose harvest shows
        generated tokens for ``slot`` (TTFT attribution; idempotent)."""
        req = self._slots[slot]
        if req is not None and req.rid not in self._first_token_wall:
            self._first_token_wall[req.rid] = t

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self._slots)
                if r is None and i not in self._reserved]

    def active_slots(self) -> list[tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self._slots) if r is not None]

    def complete(self, slot: int, tokens: np.ndarray, logprobs: np.ndarray,
                 finish_reason: str, clock: int) -> RequestOutput:
        req = self._slots[slot]
        assert req is not None
        self._slots[slot] = None
        obs.request_done(self.pid, req.rid, "finish",
                         args={"reason": finish_reason})
        if finish_reason in ("cancelled", "timeout", "deadline"):
            self._count_drop(finish_reason)
        admit_wall = self._admitted_wall.pop(req.rid, None)
        first_wall = self._first_token_wall.pop(req.rid, None)
        ttft = tpot = None
        if admit_wall is not None and first_wall is not None:
            ttft = first_wall - admit_wall
            n_after_first = len(tokens) - len(req.prompt) - 1
            if n_after_first > 0:   # single-token outputs have no tpot
                tpot = (time.perf_counter() - first_wall) / n_after_first
        delay = self._queue_delay.pop(req.rid, (None, None))
        out = RequestOutput(
            rid=req.rid, tokens=tokens, prompt_len=len(req.prompt),
            logprobs=logprobs, finish_reason=finish_reason,
            admitted_step=self._admitted_step.pop(req.rid),
            finished_step=clock, ttft_s=ttft, tpot_s=tpot,
            queue_delay_s=delay[1], queue_delay_steps=delay[0],
            priority=req.priority,
            preempted=self._preempt_count.pop(req.rid, 0))
        self.finished.append(out)
        return out

    # -- progress -----------------------------------------------------------
    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def num_reserved(self) -> int:
        return len(self._reserved)

    @property
    def num_pending(self) -> int:
        return len(self._arrivals) + len(self._ready)

    def all_done(self) -> bool:
        return (not self._arrivals and not self._ready
                and self.num_active == 0 and not self._reserved)

    def drain_unfinished(self) -> list[Request]:
        """Pull every unfinished request — queued, ready, prefilling or
        decoding — out of the scheduler, clearing its bookkeeping. The
        caller can re-drive the result onto another engine: each request
        re-prefills from its original prompt there, so its greedy tokens
        are unchanged. Finished outputs stay."""
        out = [req for _, _, req in self._arrivals]
        out += [req for _, _, _, req in self._ready]
        out += list(self._reserved.values())
        out += [req for req in self._slots if req is not None]
        self._arrivals = []
        self._ready = []
        self._reserved.clear()
        self._slots = [None] * self.num_slots
        for req in out:
            # closes whatever phase span is open; the re-drive opens a
            # fresh queued span on the surviving replica's pid
            obs.request_done(self.pid, req.rid, "redrive")
        for req in out:
            for d in (self._ready_wall, self._admitted_step,
                      self._admitted_wall, self._first_token_wall,
                      self._queue_delay):
                d.pop(req.rid, None)
        return sorted(out, key=lambda r: r.rid)


def synthetic_stream(num_requests: int, *, vocab_size: int, prompt_len: int,
                     max_new_tokens: int, arrival_rate: float = 0.0,
                     seed: int = 0, poisson: bool = False,
                     priorities=None) -> list[Request]:
    """Deterministic request stream for benchmarks and tests.

    ``arrival_rate`` is requests per decode step; 0 means all requests are
    available at step 0 (pure batch drain). ``poisson=True`` draws seeded
    exponential inter-arrival gaps with mean ``1/arrival_rate`` instead of
    the fixed spacing (the open-loop load model):
    arrivals do not wait for completions, so queueing delay grows without
    bound past the saturation rate. ``priorities`` (optional) is cycled
    over the stream (e.g. ``(0, 1, 1, 1)`` for 25% interactive traffic).
    Generated lengths vary +-25% around ``max_new_tokens`` so slots free
    up at different times and mid-run admission is exercised.
    """
    rng = np.random.RandomState(seed)
    reqs = []
    t = 0.0
    for i in range(num_requests):
        prompt = rng.randint(0, vocab_size, size=(prompt_len,)).astype(np.int32)
        lo = max(1, int(max_new_tokens * 0.75))
        hi = max(lo + 1, int(max_new_tokens * 1.25) + 1)
        if arrival_rate <= 0:
            arrival = 0
        elif poisson:
            t += rng.exponential(1.0 / arrival_rate) if i > 0 else 0.0
            arrival = int(t)
        else:
            arrival = int(i / arrival_rate)
        pri = 1 if priorities is None else int(priorities[i % len(priorities)])
        reqs.append(Request(rid=i, prompt=prompt,
                            max_new_tokens=int(rng.randint(lo, hi)),
                            arrival_step=arrival, priority=pri))
    return reqs
