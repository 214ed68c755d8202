"""Serve-loop state machine: continuous batching with chunked prefill and
SLO-aware scheduling (the JAX package's ``serving/session.py``).

``ServeSession`` owns what one ``ServeEngine.serve`` run carries between
decode chunks: the scheduler, the slotted DecodeState, in-flight chunked
prefills, the decode-step clock and the latency accounting. One serve tick
has two phases:

* ``dispatch()``: host-side policy and device launches, no blocking read:
  the expire / cancel / deadline sweeps, SLO preemption, admissions (a
  whole-prompt prefill and insert, or a reservation and the start of a
  chunked prefill), one chunk of every in-flight prefill, then the next
  decode chunk (a CUDA-graph replay on the card);
* ``harvest()``: the one device read per chunk: done flags and lengths,
  first-token marks, finished slots completed.

Chunked prefill: with ``prefill_chunk`` set, an admitted request first
RESERVES its slot and its prompt enters the batch=1 prefill cache one
chunk per tick, between decode chunks, so a long prompt does not stall the
running slots for its whole prefill. A reserved slot stays done in the
DecodeState until ``insert``, so a decode chunk (or its graph replay) never
touches a half-prefilled request. The decode-step clock does not advance on
prefill-only ticks, which keeps ``arrival_step`` meaning what it means in
a whole-prompt serve.

A preempted, cancelled or deadlined running slot is released in place
(``ServeEngine.release``), so a captured decode graph keeps its buffers.

Graceful degradation (``DegradeConfig``, a paged engine only): admission
backpressure that lasts ``patience`` ticks spills the pool one tier down
the engine's entropy-ordered KV ladder (``ServeEngine.degrade_ladder``),
and ``cooldown`` calm ticks with ``headroom`` of the pool free promote it
one tier back. Each transition repacks the live pool at a constant byte
budget (``ServeEngine.apply_kv_plan``), which hands back a new decode state
and drops the captured decode chunks; a chunked prefill in flight keeps
its pinned prefix pages, its match remapped to where the repack moved them
(the reference keeps the old ids). Before an admission deadlock raises
``OutOfPages``, a spill is tried. A spec engine runs plain decode chunks
while degraded. ``finalize`` and ``abort`` put the engine back on tier 0
(the reference's ``abort`` leaves a failed serve's degraded plan behind,
so the engine's next serve took it for tier 0); ``finalize`` reports the
steps run at each tier.

Fault tolerance: the chaos sites (``serving/chaos.py``)
``replica.dispatch`` and ``device.stall`` fire at the start of
``dispatch``, before any state changes, so a transient fault retries the
tick in place (``serving/replica.py``); ``replica.harvest`` fires in
``harvest`` before its read; ``pool.oom`` denies an admission as if the
pool were full. ``watchdog_s`` counts decode gaps longer than that
(``watchdog_trips``). The gap runs from the tick's start, before the chaos
sites, to the harvest (the reference starts it after them, at the chunk's
launch), so a stalled tick shows in the gap and trips the watchdog.

Telemetry (``repro_torch.obs``, off unless installed): the session stamps
its replica id on the scheduler and the pool (the trace pid) and names the
trace process before the first submit. Each tick is a ``tick/dispatch``
and a ``tick/harvest`` span; each decode chunk a ``decode/chunk`` span on
the decode track, from the tick's start (where the port's gap starts) to
its harvest, with its steps, KV tier and ``tuned`` stamp; a spec chunk a
``spec/round`` instant with its counters (read at the harvest, only when
tracing); a tier transition an ``engine/apply_kv_plan`` span and a
``degrade/transition`` instant. An installed ``ProfileHooks`` ticks at
each dispatch, and with device fences the chunk's launch is bracketed by
two CUDA events on the stream it (or its graph replay) runs on, and waited
for: ``device_ms`` and ``host_gap_ms`` (the gap less the device time) go
to the span and to the registry. ``finalize`` publishes the run into a
fresh registry (``obs/serve_metrics.py``), merges it into an installed
one, closes a profile window and returns ``ServeStats.from_registry`` with
the port's own fields set beside the view.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.serving import chaos
from repro_torch.serving.pool import OutOfPages
from repro_torch.serving.scheduler import Request, Scheduler, SLOConfig
from repro_torch.serving.spec import SpecMetrics


@dataclasses.dataclass(frozen=True)
class DegradeConfig:
    """Graceful-degradation policy under pool pressure.

    Spills the engine's KV precision down its entropy-ordered tier ladder
    (``ServeEngine.degrade_ladder``) when admission backpressure persists
    for ``patience`` consecutive ticks (each tier repacks the pool at
    constant bytes, so a lower precision buys more pages) and promotes
    one tier back after ``cooldown`` stall-free ticks with at least
    ``headroom`` of the pool free. A spec engine runs plain decode chunks
    while degraded (draft rounds probe extra cache rows per slot).

    The reference also carries ``policy`` (only "ewq") and
    ``shrink_spec`` (only True); neither has another value here."""
    patience: int = 2
    cooldown: int = 16
    headroom: float = 0.5


class ServeSession:
    """One continuous-batching run over a fixed request list."""

    def __init__(self, engine, requests, *, num_slots: int, chunk: int,
                 temperature: float = 0.0, seed: int = 0,
                 prefill_chunk: Optional[int] = None,
                 slo: Optional[SLOConfig] = None, replica_id: int = 0,
                 degrade: Optional[DegradeConfig] = None,
                 watchdog_s: Optional[float] = None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if prefill_chunk is None:
            prefill_chunk = engine.prefill_chunk
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1 or None, got "
                             f"{prefill_chunk}")
        self.t_start = time.perf_counter()
        self.engine = engine
        self.chunk = chunk
        self.num_slots = num_slots
        self.temperature = temperature
        self.prefill_chunk = prefill_chunk
        self.slo = slo
        self.spec = engine.spec is not None
        self.sched = Scheduler(num_slots)
        # the trace pid goes on every emitter before the first submit, so
        # request spans and pool instants land on this replica's process
        self.replica_id = replica_id
        self.sched.pid = replica_id
        if engine.pool is not None:
            engine.pool.pid = replica_id
        _tr = obs.tracer()
        if _tr is not None:
            _tr.set_process_name(replica_id, f"replica{replica_id}")
        self.device_times: list[float] = []   # fenced device s per chunk
        self.host_gaps: list[float] = []      # gap - device s per chunk
        self._device_s: Optional[float] = None
        self._pending_spec = None             # a traced chunk's counters
        for r in requests:
            if self.spec:
                engine._spec_budget_check(len(r.prompt), r.max_new_tokens)
            else:
                assert len(r.prompt) + r.max_new_tokens <= engine.max_seq, \
                    r.rid
            self.sched.submit(r)
        self.state = engine.init_decode_state(num_slots, seed)
        if engine.graphs is not None:
            # capture the greedy chunk before the first admission: a
            # capture costs an eager chunk of host time, which would land
            # in the first requests' TTFT. A chunk over empty slots writes
            # only rows an insert overwrites (or the dump page) and leaves
            # tokens, lengths and done flags as they are.
            engine.decode_chunk(self.state, chunk)
        if engine.prompt_graph and engine.model.scans_prompts:
            engine._prompt_graph()     # captured before the first admission
        self.clock = 0
        self.occupancy: list[float] = []
        self.admissions = 0
        self.generated = 0
        self.prefill_chunks = 0
        self.requeues = 0
        # summed on the device; read once, by finalize
        self.spec_m = SpecMetrics.zeros(engine.device)
        self.tasks: dict = {}          # slot -> ChunkedPrefill (reserved)
        # wall seconds from the start of a decoding tick to its harvest:
        # what a running request waits for its next chunk of tokens
        self.gaps: list[float] = []
        self._chunk_t0: Optional[float] = None
        self._dispatched = False
        # fault tolerance and graceful degradation
        self.watchdog_s = watchdog_s
        self.watchdog_trips = 0
        self.degrade = degrade if engine.pool is not None else None
        self._ladder = (engine.degrade_ladder() if self.degrade is not None
                        else [engine.kv_plan])
        self.tier = 0
        self.tier_steps = [0] * max(1, len(self._ladder))
        self.degraded_steps = 0
        self.transitions: list = []    # (clock, from_tier, to_tier)
        self._stall_ticks = 0
        self._calm_ticks = 0

    # -- progress ------------------------------------------------------------
    @property
    def done(self) -> bool:
        return self.sched.all_done()

    # -- tick phase 1: policy + launches --------------------------------------
    def dispatch(self) -> None:
        """Admissions, SLO enforcement, one chunk of every in-flight
        prefill, and the next decode chunk. Never waits for the device
        (unless profiler fences are armed)."""
        pf = obs.profile()
        if pf is not None:
            pf.tick(self.clock)
        tr = obs.tracer()
        if tr is None:
            self._dispatch()
            return
        tr.begin("tick/dispatch", self.replica_id)
        try:
            self._dispatch()
        finally:
            tr.end("tick/dispatch", self.replica_id)

    def _dispatch(self) -> None:
        eng, sched = self.engine, self.sched
        self._dispatched = False
        now = time.perf_counter()
        # the chaos sites fire before any state changes, so a transient
        # fault can retry this tick in place
        chaos.fire("replica.dispatch", tag=self.replica_id)
        chaos.fire("device.stall", tag=self.replica_id)
        sched.poll(self.clock, now)
        sched.expire(self.clock)
        self._enforce_running_drops()
        self._preempt_for_priority()
        stalled = self._admit(now)
        if self._degrade_tick(stalled) and stalled:
            stalled = self._admit(now)   # the lower tier freed pages
        self._advance_prefills()
        if sched.num_active == 0:
            if self.tasks:
                return                 # prefill-only tick; clock frozen
            if stalled:
                if (self.degrade is not None
                        and self.tier + 1 < len(self._ladder)
                        and self._transition(self.tier + 1)):
                    return             # spilled a tier: re-admit next tick
                raise OutOfPages(
                    "admission deadlock: no active slots and the pool "
                    "cannot supply the next request's pages "
                    f"({eng.pool.num_pages} pages of "
                    f"{eng.pool.page_size} tokens); size pool_pages "
                    "for the longest request")
            nxt = sched.next_arrival()
            if nxt is not None:
                self.clock = max(self.clock + 1, nxt)  # idle: fast-forward
            return
        self.occupancy.append(sched.num_active / self.num_slots)
        # the gap starts with the tick, so the prefill work this tick ran
        # ahead of the chunk counts: the host dispatches it eagerly, where
        # the reference's asynchronous launch queued it before the chunk
        self._chunk_t0 = now
        pf = obs.profile()
        fence = (pf.fence_start(eng.device)
                 if pf is not None and pf.device_fences else None)
        if self.spec and self.tier == 0:
            self.state, m = eng.decode_chunk(self.state, self.chunk)
            self.spec_m = self.spec_m.plus(m)
            if obs.tracer() is not None:
                self._pending_spec = m     # read at the harvest
        else:
            eng.decode_chunk(self.state, self.chunk, plain=True)
        if fence is not None:
            # the device's share of this chunk; the harvest takes it from
            # the gap to leave the host's
            self._device_s = pf.fence_end(eng.device, fence)
        self.clock += self.chunk
        self.tier_steps[self.tier] += self.chunk
        if self.tier:
            self.degraded_steps += self.chunk
        self._dispatched = True

    # -- graceful degradation ------------------------------------------------
    def _degrade_tick(self, stalled: bool) -> bool:
        """The tier policy, one decision a tick: persistent backpressure
        spills down the ladder, sustained headroom promotes back up.
        Returns True when a transition happened."""
        if self.degrade is None or len(self._ladder) < 2:
            return False
        if stalled:
            self._stall_ticks += 1
            self._calm_ticks = 0
            if (self._stall_ticks >= self.degrade.patience
                    and self.tier + 1 < len(self._ladder)):
                return self._transition(self.tier + 1)
            return False
        self._stall_ticks = 0
        if self.tier == 0:
            return False
        pool = self.engine.pool
        if pool.pages_free / pool.num_pages < self.degrade.headroom:
            self._calm_ticks = 0
            return False
        self._calm_ticks += 1
        if self._calm_ticks >= self.degrade.cooldown:
            return self._transition(self.tier - 1)
        return False

    def _transition(self, tier: int) -> bool:
        """Repack the engine's pool at the target tier (False when the
        engine refuses: a promotion without room for the live pages)."""
        tr = obs.tracer()
        t0 = tr.now_us() if tr is not None else 0.0
        state = self.engine.apply_kv_plan(self.state, self._ladder[tier])
        if state is None:
            return False
        self.state = state
        if tr is not None:
            tr.complete("engine/apply_kv_plan", t0, self.replica_id,
                        args={"from_tier": self.tier, "to_tier": tier})
        obs.instant("degrade/transition", self.replica_id,
                    args={"from_tier": self.tier, "to_tier": tier,
                          "clock": self.clock})
        # an in-flight chunked prefill's pinned prefix pages moved with
        # the repack (a shrink compacts them): its match follows them
        for task in self.tasks.values():
            if task.match is not None:
                task.match = task.match.remap(self.engine.pool.perm)
        self.transitions.append((self.clock, self.tier, tier))
        self.tier = tier
        self._stall_ticks = 0
        self._calm_ticks = 0
        return True

    # -- tick phase 2: the one blocking read -----------------------------------
    def harvest(self) -> None:
        """Read back the chunk ``dispatch`` launched and complete slots."""
        tr = obs.tracer()
        if tr is None:
            self._harvest()
            return
        tr.begin("tick/harvest", self.replica_id)
        try:
            self._harvest()
        finally:
            tr.end("tick/harvest", self.replica_id)

    def _harvest(self) -> None:
        if not self._dispatched:
            return
        chaos.fire("replica.harvest", tag=self.replica_id)
        self._dispatched = False
        eng, sched = self.engine, self.sched
        if self._pending_spec is not None:
            delta = dict(zip(self._pending_spec._fields,
                             (int(v) for v in self._pending_spec)))
            self._pending_spec = None
            obs.instant("spec/round", self.replica_id, obs.DECODE_TRACK,
                        args=delta)
        done_np = self.state.done.cpu().numpy()      # the one device read
        len_np = self.state.lengths.cpu().numpy()
        now = time.perf_counter()
        if self._chunk_t0 is not None:
            gap = now - self._chunk_t0
            self.gaps.append(gap)
            tr = obs.tracer()
            if tr is not None or self._device_s is not None:
                args = {"steps": self.chunk, "tier": self.tier,
                        "tuned": eng.tuned}
                if self._device_s is not None:
                    host = max(0.0, gap - self._device_s)
                    self.device_times.append(self._device_s)
                    self.host_gaps.append(host)
                    args["device_ms"] = round(self._device_s * 1e3, 3)
                    args["host_gap_ms"] = round(host * 1e3, 3)
                    self._device_s = None
                if tr is not None:
                    # from the tick's start, where the port's gap starts
                    tr.complete("decode/chunk", tr.now_us() - gap * 1e6,
                                self.replica_id, obs.DECODE_TRACK,
                                args=args)
            if self.watchdog_s is not None and gap > self.watchdog_s:
                # an in-process stall cannot be preempted, so an overrun is
                # counted rather than aborted mid-read
                self.watchdog_trips += 1
        for slot, req in sched.active_slots():
            if len_np[slot] > len(req.prompt):
                sched.mark_first_token(slot, now)
            if not done_np[slot]:
                continue
            self._complete_slot(slot, req, int(len_np[slot]))

    def _complete_slot(self, slot: int, req: Request, n: int,
                       reason: Optional[str] = None) -> None:
        eng = self.engine
        # copies: the slot's buffers are reused by the next request
        row = self.state.tokens[slot, :n].cpu().numpy().copy()
        lps = self.state.logprobs[slot, len(req.prompt):n].cpu().numpy(
            ).copy()
        if reason is None:
            reason = ("eos" if eng.eos_id is not None and n > 0
                      and row[-1] == eng.eos_id else "length")
        self.sched.complete(slot, row, lps, reason, self.clock)
        eng.release(self.state, slot)
        self.generated += n - len(req.prompt)

    # -- SLO enforcement -------------------------------------------------------
    def _enforce_running_drops(self) -> None:
        """Cancellation / deadline sweep over reserved and decoding slots:
        the request finalizes (a running abort keeps its partial tokens)
        and the slot and its pool pages free leak-free."""
        eng, sched = self.engine, self.sched
        for slot, req in sched.reserved_slots():
            reason = sched.drop_reason(req, self.clock)
            if reason is None:
                continue
            task = self.tasks.pop(slot, None)
            if task is not None and task.match is not None \
                    and eng.pool is not None:
                eng.pool.unpin(task.match)
            sched.drop_reserved(slot, reason, self.clock)
        drops = [(slot, req, sched.drop_reason(req, self.clock))
                 for slot, req in sched.active_slots()]
        drops = [d for d in drops if d[2] is not None]
        if not drops:
            return
        len_np = self.state.lengths.cpu().numpy()
        for slot, req, reason in drops:
            self._complete_slot(slot, req, int(len_np[slot]), reason=reason)

    def _preempt_for_priority(self) -> None:
        """Restart-style preemption: a strictly-higher-priority waiter may
        evict the lowest-priority decoding slot (its pages return through
        ``PoolSession.release``; the victim requeues and prefills again).
        Gated behind ``SLOConfig.preempt``."""
        if self.slo is None or not self.slo.preempt:
            return
        sched = self.sched
        while not sched.free_slots():
            head = sched.peek_ready(self.clock)
            if head is None:
                return
            victim = sched.preempt_victim(head.priority)
            if victim is None:
                return
            self.engine.release(self.state, victim)
            sched.preempt(victim)

    def _admission_gated(self, req: Request, now: float) -> bool:
        """TPOT admission gate: defer NEW work while the running slots'
        measured per-token latency (mean over the last ``admit_window``
        chunks) exceeds the target. Priority-0 requests and requests
        already past their TTFT target are never deferred."""
        slo = self.slo
        if slo is None or slo.tpot_target_s is None or req.priority == 0:
            return False
        if self.sched.num_active == 0:
            return False    # never starve an idle engine
        if slo.ttft_target_s is not None:
            rw = self.sched.ready_wall(req.rid)
            if rw is not None and now - rw >= slo.ttft_target_s:
                return False
        window = self.gaps[-slo.admit_window:]
        if not window:
            return False
        return (sum(window) / len(window)) / self.chunk > slo.tpot_target_s

    # -- admissions --------------------------------------------------------------
    def _admit(self, now: float) -> bool:
        """Fill free slots from the ready queue. Returns True when pool
        backpressure stalled an admission (deadlock detection)."""
        eng, sched = self.engine, self.sched
        for slot in sched.free_slots():
            head = sched.peek_ready(self.clock)
            if head is None or self._admission_gated(head, now):
                break
            req = sched.next_ready(self.clock)
            if req is None:
                break
            if eng.pool is not None and (
                    chaos.deny("pool.oom", tag=self.replica_id)
                    or not eng.pool.can_admit(
                        eng.pool.pages_for(eng._slot_seq_budget(
                            len(req.prompt), req.max_new_tokens)))):
                # backpressure (or an injected one): the pool's free and
                # evictable pages do not cover the worst case; retry after
                # a slot drains
                sched.requeue(req)
                self.requeues += 1
                return True
            # the TTFT clock starts at dequeue (reserve), so prefill time
            # (and the prefix cache skipping it) shows in ttft_s
            sched.reserve(slot, req, self.clock, wall=time.perf_counter())
            if self.prefill_chunk is not None:
                self.tasks[slot] = eng.begin_prefill(
                    req.prompt, self.state, frames=req.frames)
                continue
            pf = eng.prefill_request(req.prompt, self.state,
                                     frames=req.frames)
            if not self._insert(slot, req, pf):
                return True
        return False

    def _insert(self, slot: int, req: Request, pf) -> bool:
        """Insert a finished prefill into its reserved slot; False if the
        pool refused (the request is back in the queue, nothing leaked)."""
        eng, sched = self.engine, self.sched
        temp = (req.temperature if req.temperature is not None
                else self.temperature)
        try:
            eng.insert(self.state, slot, pf, req.max_new_tokens,
                       temperature=temp, top_k=req.top_k, top_p=req.top_p)
        except OutOfPages:
            # insert unpinned the match and leaked nothing; the request
            # goes back (its queue-delay clock resumes) until a slot drains
            sched.unreserve(slot)
            self.requeues += 1
            return False
        # a refill = joining a batch that is already mid-decode
        if self.occupancy and sched.num_active > 0:
            self.admissions += 1
        sched.activate(slot)
        return True

    def _advance_prefills(self) -> None:
        """Advance every in-flight chunked prefill by ONE chunk per tick
        and insert each task as soon as its prompt is in. ``tasks`` keeps
        reservation order, so progress is FIFO."""
        for slot in list(self.tasks):
            task = self.tasks[slot]
            self.engine.advance_prefill(task, self.prefill_chunk)
            self.prefill_chunks += 1
            if not task.done:
                continue
            del self.tasks[slot]
            self._insert(slot, self.sched.reserved_request(slot),
                         task.as_prefill())

    # -- teardown ------------------------------------------------------------
    def abort(self) -> list:
        """Tear in-flight work down leak-free and return the unfinished
        requests (replica failover, or an exception unwinding the serve):
        chunked-prefill prefix pins drop, every decoding slot's pages
        release, and the scheduler drains. The caller re-drives the
        survivors onto another session, where each prefills again from its
        prompt. Finished outputs stay available through ``finalize``."""
        eng, sched = self.engine, self.sched
        for task in self.tasks.values():
            if task.match is not None and eng.pool is not None:
                eng.pool.unpin(task.match)
        self.tasks.clear()
        for slot, _req in sched.active_slots():
            eng.release(self.state, slot)
        survivors = sched.drain_unfinished()
        self._dispatched = False
        self._pending_spec = None
        self._device_s = None
        if eng.pool is not None:
            eng.pool.check_invariants()
        self._back_to_tier0()
        return survivors

    def _back_to_tier0(self) -> None:
        """The engine's next serve starts at tier 0: its next
        ``init_decode_state`` builds the pool from ``kv_plan``."""
        if self.tier:
            self.engine.kv_plan = self._ladder[0]

    # -- wrap-up -------------------------------------------------------------
    def finalize(self):
        """Outputs ordered by request id, and the run's ``ServeStats``
        (call once, after ``done``).

        The run publishes into a fresh per-run registry
        (``obs/serve_metrics.py``) and ``ServeStats`` is rebuilt from it
        as a snapshot view, with the port's own fields (wall time,
        tokens/s, mean TTFT, requeues) set beside it. An installed
        registry (``obs.metrics()``) takes the run merged in, so serves in
        turn accumulate with Prometheus counter semantics; an installed
        profile's open window closes."""
        from repro_torch.obs.metrics import MetricsRegistry
        from repro_torch.obs.serve_metrics import publish_session
        from repro_torch.quant.compiler import kv_tier_labels
        from repro_torch.serving.engine import ServeStats
        from repro_torch.serving.spec.loop import obs_labels
        eng, sched = self.engine, self.sched
        wall = time.perf_counter() - self.t_start
        outputs = sorted(sched.finished, key=lambda o: o.rid)
        ttfts = [o.ttft_s for o in outputs if o.ttft_s is not None]
        proposed, accepted, committed, rounds = (int(v) for v in self.spec_m)
        pool_kw = None
        if eng.pool is not None:
            pool = eng.pool
            pool.check_invariants()    # nothing leaked
            self._back_to_tier0()
            pool_kw = dict(
                pages_total=pool.num_pages,
                pages_peak=pool.peak_pages,
                page_size=pool.page_size,
                prefix_hits=pool.prefix_hits,
                prefix_hit_tokens=pool.prefix_hit_tokens,
                prompt_tokens=pool.prompt_tokens,
                cow_copies=pool.cow_copies,
                kv_bytes_peak=(pool.peak_pages * eng._page_bytes
                               + self.num_slots
                               * eng._nonpaged_bytes_per_slot()))
        local = MetricsRegistry()
        publish_session(
            local, replica=self.replica_id, outputs=outputs,
            occupancy=(float(np.mean(self.occupancy)) if self.occupancy
                       else 0.0),
            num_chunks=len(self.occupancy), chunk=self.chunk,
            admissions=self.admissions, generated=self.generated,
            prefill_chunks=self.prefill_chunks, gaps=self.gaps,
            spec_m=dict(proposed=proposed, accepted=accepted,
                        committed=committed, rounds=rounds),
            spec_labels=(obs_labels(eng.spec) if self.spec else None),
            watchdog_trips=self.watchdog_trips,
            degraded_steps=self.degraded_steps,
            transitions=len(self.transitions),
            tier_steps=self.tier_steps,
            tier_labels=kv_tier_labels(self._ladder),
            tuned=eng.tuned, pool=pool_kw,
            device_times=self.device_times, host_gaps=self.host_gaps)
        installed = obs.metrics()
        if installed is not None:
            installed.merge(local)
        pf = obs.profile()
        if pf is not None:
            pf.stop()
        stats = ServeStats.from_registry(
            local, wall_s=wall,
            tokens_per_s=self.generated / wall if wall > 0 else 0.0,
            ttft_mean_s=float(np.mean(ttfts)) if ttfts else 0.0,
            requeues=self.requeues)
        return outputs, stats

    @torch.no_grad()
    def run(self):
        """Drain the stream (the single-engine serve loop). Any failure
        first tears the session down leak-free (``abort``), then
        propagates."""
        try:
            while not self.done:
                self.dispatch()
                self.harvest()
        except BaseException:
            self.abort()
            raise
        return self.finalize()
