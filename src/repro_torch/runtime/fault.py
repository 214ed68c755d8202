"""Fault tolerance: step watchdog, straggler detection, bounded retry,
preemption-aware checkpointing.

At 1000+ node scale the failure model is: (a) hard node loss — the run dies
and restarts from the latest atomic checkpoint on a (possibly re-sized)
mesh; (b) stragglers — a slow host stretches every collective; (c)
preemption — the scheduler gives notice and the run must commit state NOW.

This module holds the host-side runtime pieces that wrap the training
loop (``train/loop.py``) and the checkpoint reader (``checkpoint/ckpt.py``):

* ``StepWatchdog`` — EWMA step-time tracking; flags steps slower than
  ``threshold`` x the EWMA. On real pods the flagged host's neighbors report
  it to the coordinator for drain/replace; here the policy decision
  (CONTINUE / CHECKPOINT_AND_RESHARD) is surfaced to the loop.
* ``retry`` — bounded retry with exponential backoff for transient errors
  (collective timeouts, flaky interconnect, a flaky filesystem).
* ``PreemptionGuard`` — SIGTERM/SIGINT installs a flag; the loop checkpoints
  at the next step boundary and exits cleanly.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class StepWatchdog:
    threshold: float = 2.5          # x EWMA -> straggler
    ewma_alpha: float = 0.1
    grace_steps: int = 5            # ignore compile/warmup steps
    ewma: Optional[float] = None
    steps: int = 0
    stragglers: list = field(default_factory=list)

    def observe(self, step_time_s: float) -> str:
        """Returns "ok" | "straggler"."""
        self.steps += 1
        if self.steps <= self.grace_steps:
            return "ok"
        if self.ewma is None:
            self.ewma = step_time_s
            return "ok"
        verdict = "ok"
        if step_time_s > self.threshold * self.ewma:
            verdict = "straggler"
            self.stragglers.append((self.steps, step_time_s, self.ewma))
        self.ewma = (1 - self.ewma_alpha) * self.ewma \
            + self.ewma_alpha * step_time_s
        return verdict

    def should_reshard(self, window: int = 20, limit: int = 5) -> bool:
        """Persistent straggling -> advise checkpoint + elastic reshard."""
        recent = [s for s, _, _ in self.stragglers
                  if s > self.steps - window]
        return len(recent) >= limit


def retry(fn: Callable, *, attempts: int = 3, base_delay: float = 0.5,
          retriable=(RuntimeError, TimeoutError), on_retry=None):
    """Bounded retry with exponential backoff for transient runtime errors."""
    last = None
    for i in range(attempts):
        try:
            return fn()
        except retriable as e:  # noqa: PERF203
            last = e
            if on_retry:
                on_retry(i, e)
            if i + 1 < attempts:
                time.sleep(base_delay * (2 ** i))
    raise last


class PreemptionGuard:
    """SIGTERM/SIGINT -> checkpoint at the next step boundary."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = False
        self._signals = signals
        self._old = {}

    def __enter__(self):
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def __exit__(self, *exc):
        for s, h in self._old.items():
            signal.signal(s, h)
        return False
