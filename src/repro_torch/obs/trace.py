"""Span tracer exporting Chrome ``trace_event`` JSON (the JAX package's
``obs/trace.py``, copied).

Records the serving stack's request lifecycle and engine timing as
begin/end (``B``/``E``) spans, complete (``X``) spans and instant (``i``)
events, written as a ``{"traceEvents": [...]}`` object that Perfetto and
chrome://tracing load.

Tracks:

* ``pid`` = replica id; process metadata names each ``replica<r>``.
* ``tid 0`` = the replica's ENGINE track: ``tick/dispatch`` /
  ``tick/harvest`` spans (one pair a ``ServeSession`` tick),
  ``engine/apply_kv_plan`` repack spans, ``replica/failover`` spans and
  ``degrade/transition`` / chaos / pool instants.
* ``tid 1`` = the DECODE track: one ``decode/chunk`` X span a decode
  chunk, from the start of its tick to its harvest (the port's decode gap,
  which starts at the tick; the reference's starts at the chunk's launch),
  its args the steps, the KV tier, the ``tuned`` stamp and, with device
  fences armed, ``device_ms`` and ``host_gap_ms``; ``spec/round``
  instants.
* ``tid REQ_TRACK_BASE + rid`` = one track a REQUEST: its
  ``request/queued`` -> ``request/prefill`` -> ``request/decode`` phases
  are sequential, so they form balanced B/E pairs; finish, cancel,
  preempt and re-drive land as instants on the same track.

``request_phase`` / ``request_done`` are a small per-(pid, rid) state
machine that closes the previous phase before opening the next, so span
balance holds by construction and ``open_spans() == []`` is the
leak-freedom check under cancellation, preemption, ``OutOfPages`` and
failover.

Timestamps are microseconds since the tracer was built (Chrome's ``ts``
unit), from ``time.perf_counter``. Stdlib only.
"""

from __future__ import annotations

import json
import time
from typing import Optional

ENGINE_TRACK = 0
DECODE_TRACK = 1
REQ_TRACK_BASE = 1000


class Tracer:
    def __init__(self):
        self._t0 = time.perf_counter()
        self.events: list[dict] = []
        # (pid, tid) -> stack of open span names (B/E balance bookkeeping)
        self._open: dict[tuple, list[str]] = {}
        # (pid, rid) -> current request phase
        self._req: dict[tuple, str] = {}
        self._named_pids: set = set()

    # -- clock ---------------------------------------------------------------
    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    # -- metadata ------------------------------------------------------------
    def set_process_name(self, pid: int, name: str) -> None:
        if pid in self._named_pids:
            return
        self._named_pids.add(pid)
        self.events.append({"name": "process_name", "ph": "M", "pid": pid,
                            "tid": 0, "args": {"name": name}})
        for tid, tname in ((ENGINE_TRACK, "engine"),
                           (DECODE_TRACK, "decode")):
            self.events.append({"name": "thread_name", "ph": "M",
                                "pid": pid, "tid": tid,
                                "args": {"name": tname}})

    # -- spans ---------------------------------------------------------------
    def begin(self, name: str, pid: int = 0, tid: int = ENGINE_TRACK,
              cat: str = "serve", args: Optional[dict] = None) -> None:
        ev = {"name": name, "ph": "B", "pid": pid, "tid": tid,
              "ts": self.now_us(), "cat": cat}
        if args:
            ev["args"] = args
        self.events.append(ev)
        self._open.setdefault((pid, tid), []).append(name)

    def end(self, name: str, pid: int = 0, tid: int = ENGINE_TRACK,
            args: Optional[dict] = None) -> None:
        stack = self._open.get((pid, tid), [])
        assert stack and stack[-1] == name, \
            (f"span misnesting on pid={pid} tid={tid}: ending {name!r}, "
             f"open stack {stack}")
        stack.pop()
        ev = {"name": name, "ph": "E", "pid": pid, "tid": tid,
              "ts": self.now_us()}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def complete(self, name: str, t0_us: float, pid: int = 0,
                 tid: int = ENGINE_TRACK, cat: str = "serve",
                 args: Optional[dict] = None) -> None:
        """A finished span in one event (``ph: "X"``): start at ``t0_us``
        (from ``now_us``), duration measured to now."""
        ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
              "ts": t0_us, "dur": max(0.0, self.now_us() - t0_us),
              "cat": cat}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, pid: int = 0, tid: int = ENGINE_TRACK,
                args: Optional[dict] = None) -> None:
        ev = {"name": name, "ph": "i", "pid": pid, "tid": tid,
              "ts": self.now_us(), "s": "t", "cat": "serve"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # -- per-request lifecycle state machine ----------------------------------
    def request_phase(self, pid: int, rid: int, phase: str,
                      args: Optional[dict] = None) -> None:
        """Move request ``rid`` into ``phase`` (queued/prefill/decode):
        the previous phase span (if any) ends first, so the request track
        is always a flat sequence of balanced spans."""
        tid = REQ_TRACK_BASE + rid
        prev = self._req.pop((pid, rid), None)
        if prev is not None:
            self.end(f"request/{prev}", pid, tid)
        self.begin(f"request/{phase}", pid, tid, cat="request", args=args)
        self._req[(pid, rid)] = phase

    def request_done(self, pid: int, rid: int, event: str,
                     args: Optional[dict] = None) -> None:
        """Terminal (or migrating) lifecycle event: close the open phase
        and mark the boundary — ``finish``, ``preempt``, ``redrive``."""
        tid = REQ_TRACK_BASE + rid
        prev = self._req.pop((pid, rid), None)
        if prev is not None:
            self.end(f"request/{prev}", pid, tid)
        self.instant(f"request/{event}", pid, tid, args=args)

    # -- inspection / export ---------------------------------------------------
    def open_spans(self) -> list[tuple]:
        """Every still-open (pid, tid, name) — empty iff leak-free."""
        return [(pid, tid, name)
                for (pid, tid), stack in sorted(self._open.items())
                for name in stack]

    def abandon(self, pid: int, tid: int,
                reason: str = "abandoned") -> None:
        """Force-close every open span on one track (exception unwind /
        replica quarantine keeps the trace loadable)."""
        for name in reversed(self._open.get((pid, tid), []).copy()):
            self.end(name, pid, tid, args={"reason": reason})

    def to_json(self) -> dict:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    def counts(self) -> dict:
        """Event counts by (name, ph): what the trace tests and
        ``chip_smoke.py`` read instead of re-deriving them."""
        out: dict[tuple, int] = {}
        for ev in self.events:
            k = (ev["name"], ev["ph"])
            out[k] = out.get(k, 0) + 1
        return out
