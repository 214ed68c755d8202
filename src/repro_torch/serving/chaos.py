"""Deterministic fault injection for the serving stack (the JAX package's
``serving/chaos.py``).

Every recovery path in the fault-tolerance layer — replica failover with
request re-drive, artifact-read retry, graceful degradation under pool
pressure — is exercised in CI by *injecting* the faults it guards against.
Injection must therefore be deterministic: the same ``FaultConfig`` (rules
+ seed) produces the same fault schedule on every run, so a chaos test can
assert token-identical greedy output against a fault-free baseline.

Named injection sites (the code under test calls ``fire``/``deny`` with
these; an inactive injector makes both free no-ops):

* ``replica.dispatch`` / ``replica.harvest`` — raised inside a replica's
  dispatch/harvest tick, *before* any state mutation, so a transient
  fault can be retried in place and a permanent one quarantines the
  replica (``serving/replica.py``).
* ``pool.oom`` — consulted by the admission gate (``deny``): a hit makes
  the paged pool report backpressure as if out of pages, driving the
  graceful-degradation ladder without actually shrinking the pool.
* ``device.stall`` — a slow-device hang: ``mode="stall"`` sleeps
  ``stall_s`` inside the dispatch tick (watchdog fodder), ``mode="raise"``
  raises like a collective timeout.
* ``artifact.read`` — raised inside the checkpoint shard reader
  (transient I/O); ``artifact.corrupt`` (``deny`` site) flips one byte of
  a loaded payload so checksum verification is exercised end to end.

Faults are matched per (site, tag) occurrence count (1-based), where the
tag is typically a replica id — ``FaultRule(site="replica.dispatch",
tag=1, at=(3,))`` kills replica 1 at *its* third dispatch, regardless of
how the replicas interleave. Probabilistic rules draw exactly one RNG
sample per occurrence from a seeded generator, so a given seed yields one
schedule no matter which rules are attached.

This module imports nothing from the serving stack (stdlib + numpy only),
so low-level modules (``checkpoint/ckpt.py``, the pool) call into it
without import cycles. The port's injector is its own object: a process
that also imports the JAX package holds two, installed apart.

A rule that fires is logged (``log``), traced as a ``chaos/fire`` instant
and counted in ``serve_chaos_faults_total`` by site and replica, on the
installed sinks of ``repro_torch.obs`` (no-ops when none is installed).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch import obs


SITES = (
    "replica.dispatch",
    "replica.harvest",
    "pool.oom",
    "device.stall",
    "artifact.read",
    "artifact.corrupt",
)


class InjectedFault(RuntimeError):
    """A fault raised by the chaos harness (permanent unless subclassed)."""

    def __init__(self, site: str, occurrence: int, tag: Optional[int] = None,
                 transient: bool = False):
        where = site if tag is None else f"{site}[{tag}]"
        kind = "transient" if transient else "permanent"
        super().__init__(
            f"injected {kind} fault at {where} (occurrence {occurrence})")
        self.site = site
        self.occurrence = occurrence
        self.tag = tag
        self.transient = transient


class TransientFault(InjectedFault):
    """A retriable injected fault (flaky I/O, collective timeout)."""

    def __init__(self, site, occurrence, tag=None):
        super().__init__(site, occurrence, tag, transient=True)


@dataclass(frozen=True)
class FaultRule:
    """One fault schedule entry.

    ``at`` lists 1-based occurrence indices of (site, tag) calls that
    fault; ``prob`` adds seeded random faults on the remaining calls.
    ``count`` bounds total firings (0 = unlimited). ``tag=None`` matches
    any tag. ``mode="stall"`` sleeps ``stall_s`` instead of raising.
    """

    site: str
    at: tuple = ()
    prob: float = 0.0
    count: int = 1
    transient: bool = False
    tag: Optional[int] = None
    mode: str = "raise"          # "raise" | "stall"
    stall_s: float = 0.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"known: {SITES}")
        if self.mode not in ("raise", "stall"):
            raise ValueError(f"unknown fault mode {self.mode!r}")


@dataclass(frozen=True)
class FaultConfig:
    """A seeded set of fault rules — one deterministic chaos schedule."""

    rules: tuple = ()
    seed: int = 0

    # CLI shorthand -> rules. Occurrence indices are tuned so smoke-scale
    # serves (a handful of requests, chunk 4) hit every recovery path.
    _SHORTHAND = {
        # kill replica 1 at its 3rd dispatch: mid-stream, decode underway
        "replica_fault": dict(site="replica.dispatch", tag=1, at=(3,)),
        # two retriable dispatch hiccups on replica 0
        "replica_transient": dict(site="replica.dispatch", tag=0, at=(2, 4),
                                  count=2, transient=True),
        # admission gate reports pool exhaustion on each replica's first
        # attempt: an idle engine cannot free pages, so the degradation
        # policy spills exactly one ewq tier (int8) and admits there;
        # real pool capacity governs afterwards
        "oom": dict(site="pool.oom", at=(1,), count=0),
        # one slow-device stall inside a dispatch tick
        "stall": dict(site="device.stall", at=(2,), mode="stall",
                      stall_s=0.05),
        # one transient artifact-read failure (retry path)
        "artifact": dict(site="artifact.read", at=(1,), transient=True),
    }

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultConfig":
        """Build a config from a comma-separated CLI spec.

        Each item is a shorthand name (``replica_fault``, ``oom``, ...)
        or ``site@occ[,occ...]`` with ``:`` separating items' options —
        kept simple on purpose; tests construct ``FaultRule`` directly.
        """
        rules = []
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if item not in cls._SHORTHAND:
                raise ValueError(
                    f"unknown chaos shorthand {item!r}; known: "
                    f"{sorted(cls._SHORTHAND)}")
            rules.append(FaultRule(**cls._SHORTHAND[item]))
        return cls(rules=tuple(rules), seed=seed)


@dataclass
class ChaosInjector:
    """Deterministic occurrence-counting fault injector.

    Each ``fire``/``deny`` call advances the per-(site, tag) occurrence
    counter by exactly one and draws exactly one RNG sample per rule with
    ``prob > 0`` — determinism is independent of which rules matched.
    """

    config: FaultConfig
    _counts: dict = field(default_factory=dict)
    _fired: dict = field(default_factory=dict)
    log: list = field(default_factory=list)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.config.seed)

    def _occurrence(self, site: str, tag) -> int:
        key = (site, tag)
        self._counts[key] = self._counts.get(key, 0) + 1
        return self._counts[key]

    def poke(self, site: str, tag=None) -> Optional[FaultRule]:
        """Advance (site, tag) and return the matching rule, if any."""
        occ = self._occurrence(site, tag)
        hit = None
        for i, rule in enumerate(self.config.rules):
            if rule.site != site:
                continue
            if rule.tag is not None and rule.tag != tag:
                continue
            if rule.count and self._fired.get(i, 0) >= rule.count:
                continue
            fires = occ in rule.at
            if rule.prob > 0.0:
                # always one draw per matching call -> stable schedule
                fires = bool(self._rng.random() < rule.prob) or fires
            if fires and hit is None:
                self._fired[i] = self._fired.get(i, 0) + 1
                hit = rule
        if hit is not None:
            self.log.append((site, tag, occ))
            obs.instant("chaos/fire", tag if isinstance(tag, int) else 0,
                        args={"site": site, "occurrence": occ})
            obs.count("serve_chaos_faults_total", 1,
                      "chaos-injected faults fired, by site",
                      site=site, replica=str(tag))
        return hit

    def fire(self, site: str, tag=None) -> None:
        """Raise (or stall) if a rule matches this occurrence."""
        rule = self.poke(site, tag)
        if rule is None:
            return
        occ = self._counts[(site, tag)]
        if rule.mode == "stall":
            time.sleep(rule.stall_s)
            return
        if rule.transient:
            raise TransientFault(site, occ, tag)
        raise InjectedFault(site, occ, tag)

    def deny(self, site: str, tag=None) -> bool:
        """Non-raising site: True when a rule matches this occurrence."""
        return self.poke(site, tag) is not None


# ---------------------------------------------------------------------------
# Module-level active injector: production call sites stay one free branch.

_ACTIVE: Optional[ChaosInjector] = None


def install(injector: Optional[ChaosInjector]) -> Optional[ChaosInjector]:
    """Install (or clear, with None) the process-wide injector."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, injector
    return prev


def active() -> Optional[ChaosInjector]:
    return _ACTIVE


def fire(site: str, tag=None) -> None:
    if _ACTIVE is not None:
        _ACTIVE.fire(site, tag)


def deny(site: str, tag=None) -> bool:
    return _ACTIVE is not None and _ACTIVE.deny(site, tag)


@contextmanager
def chaos(config: FaultConfig):
    """Scoped injector installation (tests)."""
    injector = ChaosInjector(config)
    prev = install(injector)
    try:
        yield injector
    finally:
        install(prev)
