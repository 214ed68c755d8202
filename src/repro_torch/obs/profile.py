"""Profiler hooks: device-time fences on CUDA events and ``torch.profiler``
capture windows (the JAX package's ``obs/profile.py``; its
``jax.block_until_ready`` fence and ``jax.profiler`` trace become CUDA
events and ``torch.profiler``).

Two opt-in mechanisms, both armed by installing a ``ProfileHooks`` with
``obs.install(profile=...)``:

* **Device fences** (``device_fences=True``): ``ServeSession.dispatch``
  records one ``torch.cuda.Event(enable_timing=True)`` on the current
  stream (the one a decode chunk, or its CUDA-graph replay, runs on) just
  before the chunk's launch and one just after, and waits on the second
  (``end.synchronize()``). ``device_s`` is ``start.elapsed_time(end) /
  1e3``; ``harvest`` subtracts it from the chunk's decode gap (which in the
  port starts at the tick, so the tick's admissions and prefill work fall
  in the host share) to give the host gap. Both land in the
  ``decode/chunk`` span's args and in the ``serve_device_time_seconds`` /
  ``serve_host_gap_seconds`` histograms. On the CPU, where a tensor op
  returns when its work is done, ``device_s`` is the wall time of the
  chunk's call. The fence makes the host wait for the device: it is a
  measurement mode, never on by default.

* **Capture windows** (``steps=(A, B)``, CLI ``--profile-steps A:B``):
  ``torch.profiler.profile`` with CPU activities, and CUDA activities when
  a card is present, starts at the first tick whose decode-step clock is
  at least A and stops at the first later tick at or past B, or at session
  teardown; the window's Chrome trace is written under ``trace_dir``
  (``trace_files``). A start or stop failure warns and disarms the window
  rather than take serving down; a caller that needs the window (the chip
  smoke run) checks ``windows`` and the trace itself. Start the window
  after any CUDA-graph capture: a capture must not run under the profiler.

Disabled cost: the serve loop makes one ``obs.profile()`` ``None`` check a
site.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Optional


class ProfileHooks:
    def __init__(self, steps: Optional[tuple] = None,
                 trace_dir: Optional[str] = None,
                 device_fences: bool = True):
        if steps is not None:
            a, b = steps
            if not (0 <= a < b):
                raise ValueError(f"profile window must be 0 <= A < B, "
                                 f"got {a}:{b}")
        self.steps = steps
        # None: a folder under the process's temporary directory
        self.trace_dir = (trace_dir if trace_dir is not None else
                          os.path.join(tempfile.gettempdir(),
                                       "repro_torch-profile"))
        self.device_fences = device_fences
        self._capturing = False
        self._prof = None
        self.windows = 0              # capture windows actually recorded
        self.trace_files: list[str] = []
        # wall seconds of the window's start, and of its stop with the
        # trace's export: what the window costs the serve around it
        self.start_s = 0.0
        self.stop_s = 0.0

    @classmethod
    def parse(cls, spec: str, trace_dir: Optional[str] = None,
              device_fences: bool = True) -> "ProfileHooks":
        """``"A:B"`` -> a capture window over decode steps [A, B)."""
        try:
            a, b = (int(x) for x in spec.split(":"))
        except ValueError:
            raise ValueError(f"--profile-steps wants A:B, got {spec!r}")
        return cls(steps=(a, b), trace_dir=trace_dir,
                   device_fences=device_fences)

    # -- device fences ----------------------------------------------------------
    @staticmethod
    def fence_start(device):
        """Mark the start of a decode chunk's launch: a timing event
        recorded on ``device``'s current stream, or the host clock on the
        CPU."""
        if device.type != "cuda":
            return time.perf_counter()
        import torch
        start = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(device))
        return start

    @staticmethod
    def fence_end(device, start) -> float:
        """Wait for the chunk launched since ``fence_start`` and return its
        device seconds (on the CPU, the wall seconds of the call)."""
        if device.type != "cuda":
            return time.perf_counter() - start
        import torch
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(device))
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    # -- capture window -------------------------------------------------------
    def tick(self, clock: int) -> None:
        """Advance the capture window against the decode-step clock.
        Called once a dispatch; idempotent outside the window.

        The clock advances by ``chunk`` a tick, so the window triggers on
        *crossing*: capture starts at the first tick with ``clock >= A``
        and stops at the first later tick with ``clock >= B``. A window
        narrower than one chunk still records at least one tick."""
        if self.steps is None:
            return
        a, b = self.steps
        if not self._capturing:
            if clock >= a:
                self._start()
        elif clock >= b:
            self.stop()

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        t0 = time.perf_counter()
        try:
            prof = profile(activities=activities)
            prof.start()
            self._prof = prof
            self._capturing = True
            self.start_s = time.perf_counter() - t0
        except Exception as e:   # profiler availability varies by build
            import warnings
            warnings.warn(f"torch.profiler start failed: {e}")
            self.steps = None    # don't retry every tick

    def stop(self) -> None:
        """Close an open capture window and write its Chrome trace (also
        called at session teardown, so a window that spans the end of the
        stream still flushes)."""
        if not self._capturing:
            return
        self._capturing = False
        self.steps = None        # one window per arm; never re-open
        self.windows += 1
        prof, self._prof = self._prof, None
        t0 = time.perf_counter()
        try:
            prof.stop()
            os.makedirs(self.trace_dir, exist_ok=True)
            path = os.path.join(self.trace_dir,
                                f"window{self.windows}_{os.getpid()}.json")
            prof.export_chrome_trace(path)
            self.trace_files.append(path)
            self.stop_s = time.perf_counter() - t0
        except Exception as e:
            import warnings
            warnings.warn(f"torch.profiler stop failed: {e}")
