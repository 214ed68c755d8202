"""Observability facade: process-wide tracer, metrics registry and
profiler hooks (the JAX package's ``repro.obs``; the port's own copy).

Everything is OFF by default. The serving stack emits through the
module-level helpers below; with nothing installed each call is one
``None`` check and an immediate return, the discipline of
``serving/chaos.py``. Hot per-tick paths hold the ``tracer()`` handle once
and branch on it, so even the argument packing is skipped when tracing is
off.

Usage::

    from repro_torch import obs

    obs.install(tracer=obs.Tracer(), metrics=obs.MetricsRegistry())
    try:
        engine.serve(requests, ...)
    finally:
        tr, mx, _ = obs.install(None, None, None)
    tr.write("trace.json"); mx.write_prometheus("metrics.prom")

or scoped, for tests::

    with obs.capture() as (tr, mx):
        engine.serve(requests, ...)
    assert tr.open_spans() == []

``ProfileHooks`` (``obs/profile.py``) adds device fences on CUDA events and
a ``torch.profiler`` capture window over decode steps.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profile import ProfileHooks
from repro_torch.obs.trace import (DECODE_TRACK, ENGINE_TRACK, REQ_TRACK_BASE,
                             Tracer)

__all__ = [
    "Tracer", "MetricsRegistry", "ProfileHooks",
    "ENGINE_TRACK", "DECODE_TRACK", "REQ_TRACK_BASE",
    "install", "capture", "tracer", "metrics", "profile", "enabled",
    "request_phase", "request_done", "instant", "count", "observe",
]

_KEEP = object()

_TRACER: Optional[Tracer] = None
_METRICS: Optional[MetricsRegistry] = None
_PROFILE: Optional[ProfileHooks] = None


def install(tracer=_KEEP, metrics=_KEEP, profile=_KEEP):
    """Install (or clear, with None) process-wide sinks; omitted kwargs
    keep the current sink. Returns the previous (tracer, metrics,
    profile) triple so callers can restore it."""
    global _TRACER, _METRICS, _PROFILE
    prev = (_TRACER, _METRICS, _PROFILE)
    if tracer is not _KEEP:
        _TRACER = tracer
    if metrics is not _KEEP:
        _METRICS = metrics
    if profile is not _KEEP:
        _PROFILE = profile
    return prev


def tracer() -> Optional[Tracer]:
    return _TRACER


def metrics() -> Optional[MetricsRegistry]:
    return _METRICS


def profile() -> Optional[ProfileHooks]:
    return _PROFILE


def enabled() -> bool:
    return _TRACER is not None or _METRICS is not None


@contextmanager
def capture(tracer: Optional[Tracer] = None,
            metrics: Optional[MetricsRegistry] = None,
            profile: Optional[ProfileHooks] = None):
    """Scoped installation (tests): fresh tracer + registry by default."""
    tr = tracer if tracer is not None else Tracer()
    mx = metrics if metrics is not None else MetricsRegistry()
    prev = install(tr, mx, profile)
    try:
        yield tr, mx
    finally:
        install(*prev)


# ---------------------------------------------------------------------------
# Free no-op emitters: production call sites stay one None check when off.

def request_phase(pid: int, rid: int, phase: str, args=None) -> None:
    if _TRACER is not None:
        _TRACER.request_phase(pid, rid, phase, args)


def request_done(pid: int, rid: int, event: str, args=None) -> None:
    if _TRACER is not None:
        _TRACER.request_done(pid, rid, event, args)


def instant(name: str, pid: int = 0, tid: int = ENGINE_TRACK,
            args=None) -> None:
    if _TRACER is not None:
        _TRACER.instant(name, pid, tid, args)


def count(name: str, value: float = 1.0, help: str = "",
          **labels) -> None:
    """Increment a counter on the INSTALLED registry (live events that no
    per-run publish covers: replica failover, re-drives)."""
    if _METRICS is not None:
        _METRICS.counter(name, help).inc(value, **labels)


def observe(name: str, value: float, help: str = "", **labels) -> None:
    """Observe into a histogram on the installed registry."""
    if _METRICS is not None:
        _METRICS.histogram(name, help).observe(value, **labels)
