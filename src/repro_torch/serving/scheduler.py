"""Request lifecycle for the continuous-batching engine.

A request moves queued -> ready -> assigned (slot) -> finished. The
scheduler is host-side bookkeeping only: tensor state lives in
``serving.batch.DecodeState``, and the engine consults the scheduler
between decode chunks to admit ready requests into freed slots and to
harvest finished ones. Time is counted in decode steps (the clock advances
by ``chunk`` per chunk), so ``arrival_step`` simulates a request stream
without wall-clock dependence. The ready queue is ordered by
``(priority, arrival_step, submit order)``.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new_tokens: int
    arrival_step: int = 0         # decode-step clock at which it may be admitted
    temperature: Optional[float] = None  # None: serve()'s default
    top_k: int = 0                # 0: disabled
    top_p: float = 1.0            # >= 1: disabled
    priority: int = 1             # 0 = most urgent; ties break FIFO


@dataclasses.dataclass
class RequestOutput:
    rid: int
    tokens: np.ndarray            # (P + generated,) int32
    prompt_len: int
    logprobs: np.ndarray          # (generated,) f32 chosen-token logprobs
    finish_reason: str            # "eos" | "length"
    admitted_step: int
    finished_step: int
    # wall-clock latency, chunk-granular: the first harvest that shows a
    # generated token marks the first token
    ttft_s: Optional[float] = None       # dequeue -> first generated token
    tpot_s: Optional[float] = None       # per token after the first

    @property
    def generated(self) -> np.ndarray:
        return self.tokens[self.prompt_len:]


class Scheduler:
    """Priority admission queue + slot table over fixed decode slots."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self._arrivals: list[tuple[int, int, Request]] = []
        self._ready: list[tuple[int, int, int, Request]] = []
        self._seq = 0
        self._slots: list[Optional[Request]] = [None] * num_slots
        self._admitted_step: dict[int, int] = {}
        self._admitted_wall: dict[int, float] = {}
        self._first_token_wall: dict[int, float] = {}
        self.finished: list[RequestOutput] = []

    # -- queue --------------------------------------------------------------
    def submit(self, req: Request) -> None:
        heapq.heappush(self._arrivals, (req.arrival_step, req.rid, req))

    def poll(self, clock: int) -> None:
        """Move requests whose arrival step has come into the ready queue."""
        while self._arrivals and self._arrivals[0][0] <= clock:
            _, _, req = heapq.heappop(self._arrivals)
            self._seq += 1
            heapq.heappush(self._ready,
                           (req.priority, req.arrival_step, self._seq, req))

    def next_ready(self, clock: int) -> Optional[Request]:
        """Pop the highest-priority ready request (FIFO within a class)."""
        self.poll(clock)
        return heapq.heappop(self._ready)[3] if self._ready else None

    def next_arrival(self) -> Optional[int]:
        """Earliest pending arrival step (ready requests count as arrived)."""
        if self._ready:
            return self._ready[0][1]
        return self._arrivals[0][0] if self._arrivals else None

    # -- slots --------------------------------------------------------------
    def assign(self, slot: int, req: Request, clock: int,
               wall: Optional[float] = None) -> None:
        """Admit ``req`` into ``slot``; the TTFT clock starts here."""
        assert self._slots[slot] is None, f"slot {slot} busy"
        self._slots[slot] = req
        self._admitted_step[req.rid] = clock
        self._admitted_wall[req.rid] = (time.perf_counter() if wall is None
                                        else wall)

    def mark_first_token(self, slot: int, t: float) -> None:
        req = self._slots[slot]
        if req is not None and req.rid not in self._first_token_wall:
            self._first_token_wall[req.rid] = t

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self._slots) if r is None]

    def active_slots(self) -> list[tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self._slots) if r is not None]

    def complete(self, slot: int, tokens: np.ndarray, logprobs: np.ndarray,
                 finish_reason: str, clock: int) -> RequestOutput:
        req = self._slots[slot]
        assert req is not None
        self._slots[slot] = None
        admit_wall = self._admitted_wall.pop(req.rid, None)
        first_wall = self._first_token_wall.pop(req.rid, None)
        ttft = tpot = None
        if admit_wall is not None and first_wall is not None:
            ttft = first_wall - admit_wall
            n_after_first = len(tokens) - len(req.prompt) - 1
            if n_after_first > 0:
                tpot = (time.perf_counter() - first_wall) / n_after_first
        out = RequestOutput(
            rid=req.rid, tokens=tokens, prompt_len=len(req.prompt),
            logprobs=logprobs, finish_reason=finish_reason,
            admitted_step=self._admitted_step.pop(req.rid),
            finished_step=clock, ttft_s=ttft, tpot_s=tpot)
        self.finished.append(out)
        return out

    # -- progress -----------------------------------------------------------
    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slots)

    def all_done(self) -> bool:
        return not self._arrivals and not self._ready and self.num_active == 0


def synthetic_stream(num_requests: int, *, vocab_size: int, prompt_len: int,
                     max_new_tokens: int, arrival_rate: float = 0.0,
                     seed: int = 0) -> list[Request]:
    """Deterministic request stream (the reference's ``synthetic_stream``
    without Poisson arrivals or priorities): ``arrival_rate`` requests per
    decode step (0: all at step 0); generated lengths vary +-25% around
    ``max_new_tokens`` so slots free up at different times."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(num_requests):
        prompt = rng.randint(0, vocab_size, size=(prompt_len,)).astype(np.int32)
        lo = max(1, int(max_new_tokens * 0.75))
        hi = max(lo + 1, int(max_new_tokens * 1.25) + 1)
        arrival = 0 if arrival_rate <= 0 else int(i / arrival_rate)
        reqs.append(Request(rid=i, prompt=prompt,
                            max_new_tokens=int(rng.randint(lo, hi)),
                            arrival_step=arrival))
    return reqs
