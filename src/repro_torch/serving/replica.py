"""Replica serving: a router over per-replica ServeEngines, with failover
(the JAX package's ``serving/replica.py``).

``ReplicaServe`` serves one request stream across R engines. Each engine
has its own slotted decode state, its own page pool and its own captured
decode chunks; on one card the engines may share one set of compiled
parameters. A host-side router partitions the stream across the replicas
with load-aware dispatch (least outstanding prompt + decode tokens, in
arrival order, deterministic).

The serve loop interleaves the replicas' session ticks in two passes:
dispatch every live replica's decode chunk, then harvest each. A chunk
replayed from a CUDA graph does not wait for the device, so replica 0's
harvest blocks while the later replicas' chunks are already queued.

Each replica runs its own decode-step clock (it advances only when that
replica decodes), so ``arrival_step`` is read per replica. Greedy decoding
is deterministic per request, so a replica serve gives each request the
tokens one engine gives it. Replica i's session takes ``seed + i``; the
reference folds a JAX key, which the port cannot match, so a sampled
replica serve has draws of its own.

Failover (``FailoverConfig``): a replica tick that raises a
``TransientFault`` retries in place; any other failure quarantines the
replica: its session aborts leak-free and every unfinished request
re-drives onto the surviving replicas, where it prefills again from its
prompt (greedy tokens unchanged).

Telemetry (``repro_torch.obs``): a quarantine is a ``replica/failover``
span on the failed replica's engine track, and counts
``serve_replica_restarts_total``, ``serve_redriven_requests_total`` and a
``serve_recovery_seconds`` sample on the installed registry; the
aggregate's ``registry`` merges the replicas' run registries (per-replica
labels) with the same failover events.

``ReplicaServe.build`` over a device mesh is the DP x TP layout: one
engine per data-axis submesh (``launch/mesh.split_data_replicas``), each
placing the weights TP-only over its own positions.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.serving import chaos
from repro_torch.serving.engine import ServeStats
from repro_torch.serving.pool import OutOfPages
from repro_torch.serving.scheduler import Request, RequestOutput, SLOConfig
from repro_torch.serving.session import ServeSession


@dataclasses.dataclass(frozen=True)
class FailoverConfig:
    """Replica health and failover policy.

    A replica tick (dispatch or harvest) that raises a ``TransientFault``
    retries in place, at once, up to ``retries`` times; any other failure
    quarantines the replica. ``max_restarts`` bounds the quarantines
    (default R - 1: the last replica standing must not fail);
    ``watchdog_s`` arms each replica's decode-gap deadline (overruns
    count as ``watchdog_trips``). The reference also carries
    ``backoff_s``, a sleep between retries that is 0 unless set."""
    retries: int = 2
    max_restarts: Optional[int] = None
    watchdog_s: Optional[float] = None


@dataclasses.dataclass
class ReplicaStats:
    """Aggregate and per-replica serve statistics."""
    replicas: int
    aggregate: ServeStats          # latency percentiles over ALL requests,
                                   # counters summed
    per_replica: list              # list[ServeStats], one per replica
    assignments: list              # requests routed to each replica
    occupancy_per_replica: list    # mean active-slot fraction per replica


class ReplicaServe:
    """Serve one request stream across R replica engines."""

    def __init__(self, engines: Sequence):
        if not engines:
            raise ValueError("ReplicaServe needs at least one engine")
        self.engines = list(engines)

    @classmethod
    def build(cls, model, params, *, mesh, max_seq: int,
              **engine_kw) -> "ReplicaServe":
        """One engine per data-axis submesh of ``mesh``; each places the
        (quantized) weights over its own submesh, which IS the DP
        replication. A mesh without a data axis yields a single TP-only
        replica."""
        from repro_torch.launch.mesh import split_data_replicas
        from repro_torch.serving.engine import ServeEngine
        return cls([ServeEngine(model, params, mesh=m, max_seq=max_seq,
                                **engine_kw)
                    for m in split_data_replicas(mesh)])

    @property
    def num_replicas(self) -> int:
        return len(self.engines)

    def route(self, requests: Sequence[Request]) -> list[list[Request]]:
        """Load-aware dispatch: walk the stream in arrival order and send
        each request to the replica with the least outstanding work
        (projected prompt + decode tokens); ties go to the lowest replica
        id."""
        buckets: list[list[Request]] = [[] for _ in self.engines]
        load = [0] * len(self.engines)
        order = sorted(requests, key=lambda r: (r.arrival_step, r.rid))
        for r in order:
            i = min(range(len(load)), key=lambda j: (load[j], j))
            buckets[i].append(r)
            load[i] += len(r.prompt) + r.max_new_tokens
        return buckets

    def serve(self, requests: Sequence[Request], *, num_slots: int = 8,
              chunk: int = 8, temperature: float = 0.0, seed: int = 0,
              prefill_chunk: Optional[int] = None,
              slo: Optional[SLOConfig] = None,
              failover: Optional[FailoverConfig] = None,
              degrade=None) -> tuple[list[RequestOutput], ReplicaStats]:
        """Drain the stream across all replicas; ``num_slots`` is PER
        replica. Outputs merge back in request-id order.

        With ``failover`` set, a replica whose tick faults permanently is
        quarantined and its unfinished requests re-drive onto the
        survivors; transient faults retry in place. Without ``failover``
        a failure propagates, after every live session is aborted
        leak-free (as ``ServeSession.run`` unwinds). ``degrade`` (a
        ``session.DegradeConfig``) arms each replica's graceful
        degradation under pool pressure."""
        buckets = self.route(requests)
        sessions = [
            ServeSession(eng, bucket, num_slots=num_slots, chunk=chunk,
                         temperature=temperature, seed=seed + i,
                         prefill_chunk=prefill_chunk, slo=slo,
                         replica_id=i, degrade=degrade,
                         watchdog_s=(failover.watchdog_s
                                     if failover is not None else None))
            for i, (eng, bucket) in enumerate(zip(self.engines, buckets))]
        alive = [True] * len(sessions)
        restarts, redriven = 0, 0
        failovers: list[tuple] = []    # (replica, recovery_s, orphans)

        def tick(i: int, phase: str) -> bool:
            """One session phase under the failover policy; False means
            the replica must be quarantined."""
            s = sessions[i]
            fn = s.dispatch if phase == "dispatch" else s.harvest
            attempts = failover.retries if failover is not None else 0
            while True:
                try:
                    fn()
                    return True
                except chaos.TransientFault:
                    if attempts <= 0:
                        if failover is None:
                            raise
                        return False
                    attempts -= 1   # the sites fire before any state
                                    # changes: retry in place
                except OutOfPages:
                    raise   # an admission deadlock is a sizing error on
                            # every identical replica: re-driving cannot help
                except Exception:
                    if failover is None:
                        raise
                    return False

        def quarantine(i: int) -> None:
            nonlocal restarts, redriven
            tr = obs.tracer()
            span_t0 = tr.now_us() if tr is not None else 0.0
            t0 = time.perf_counter()
            orphans = sessions[i].abort()
            alive[i] = False
            restarts += 1
            targets = [j for j in range(len(sessions)) if alive[j]]
            budget = (failover.max_restarts
                      if failover.max_restarts is not None
                      else len(sessions) - 1)
            if not targets or restarts > budget:
                raise RuntimeError(
                    f"replica failover exhausted: {restarts} replicas "
                    f"failed (budget {budget}), {len(orphans)} requests "
                    f"stranded")
            load = {j: 0 for j in targets}
            for req in orphans:          # load-aware re-drive, as route()
                j = min(targets, key=lambda t: (load[t], t))
                sessions[j].sched.submit(dataclasses.replace(
                    req, arrival_step=sessions[j].clock))
                load[j] += len(req.prompt) + req.max_new_tokens
                redriven += 1
            dt = time.perf_counter() - t0
            failovers.append((i, dt, len(orphans)))
            # a router-level event no session's publish covers: straight
            # to the installed sinks
            if tr is not None:
                tr.complete("replica/failover", span_t0, i,
                            args={"orphans": len(orphans),
                                  "survivors": len(targets)})
            obs.count("serve_replica_restarts_total", 1, replica=str(i))
            obs.count("serve_redriven_requests_total", len(orphans),
                      replica=str(i))
            obs.observe("serve_recovery_seconds", dt, replica=str(i))

        try:
            while any(alive[i] and not s.done
                      for i, s in enumerate(sessions)):
                for i, s in enumerate(sessions):  # launch every replica...
                    if alive[i] and not s.done and not tick(i, "dispatch"):
                        quarantine(i)
                for i, s in enumerate(sessions):  # ...then read each back
                    if alive[i] and not tick(i, "harvest"):
                        quarantine(i)
        except BaseException:
            for i, s in enumerate(sessions):      # leave no page held
                if alive[i]:
                    s.abort()
            raise
        results = [s.finalize() for s in sessions]
        outputs = sorted((o for outs, _ in results for o in outs),
                         key=lambda o: o.rid)
        per_replica = [st for _, st in results]
        aggregate = dataclasses.replace(
            _merge_stats(outputs, per_replica),
            replica_restarts=restarts, redriven_requests=redriven,
            recovery_p95_s=(float(np.percentile([f[1] for f in failovers],
                                                95)) if failovers else 0.0),
            registry=_merge_registries(per_replica, failovers))
        return outputs, ReplicaStats(
            replicas=len(self.engines),
            aggregate=aggregate,
            per_replica=per_replica,
            assignments=[len(b) for b in buckets],
            occupancy_per_replica=[st.occupancy for st in per_replica])


def _merge_registries(per_replica: list, failovers: list):
    """Roll the replicas' run registries into one and add the router's
    failover events, which no session's publish covers. The result rides
    on the aggregate's ``registry``, so its exposition carries per-replica
    labels."""
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.serve_metrics import SCHEMA
    merged = MetricsRegistry()
    for st in per_replica:
        if st.registry is not None:
            merged.merge(st.registry)
    for i, dt, orphans in failovers:
        r = str(i)
        merged.counter("serve_replica_restarts_total",
                       SCHEMA["serve_replica_restarts_total"][1]
                       ).inc(1, replica=r)
        merged.counter("serve_redriven_requests_total",
                       SCHEMA["serve_redriven_requests_total"][1]
                       ).inc(orphans, replica=r)
        merged.histogram("serve_recovery_seconds",
                         SCHEMA["serve_recovery_seconds"][1]
                         ).observe(dt, replica=r)
    return merged


def _merge_stats(outputs: list, per_replica: list) -> ServeStats:
    """The global view: latency percentiles recomputed over the merged
    outputs (a percentile of per-replica percentiles would be wrong),
    counters and token totals summed, occupancy weighted by chunks, wall
    time the longest replica's."""

    def pct(vals, q):
        return float(np.percentile(vals, q)) if vals else 0.0

    ttfts = [o.ttft_s for o in outputs if o.ttft_s is not None]
    tpots = [o.tpot_s for o in outputs if o.tpot_s is not None]
    qdels = [o.queue_delay_s for o in outputs if o.queue_delay_s is not None]
    chunks = sum(st.num_chunks for st in per_replica)
    proposed = sum(st.draft_proposed for st in per_replica)
    rounds = sum(st.spec_rounds for st in per_replica)
    committed = sum(st.tokens_per_round * st.spec_rounds
                    for st in per_replica)
    generated = sum(st.generated_tokens for st in per_replica)
    wall = max((st.wall_s for st in per_replica), default=0.0)
    return ServeStats(
        decode_steps=sum(st.decode_steps for st in per_replica),
        generated_tokens=generated,
        occupancy=(sum(st.occupancy * st.num_chunks for st in per_replica)
                   / chunks if chunks else 0.0),
        num_chunks=chunks,
        admissions=sum(st.admissions for st in per_replica),
        wall_s=wall,
        tokens_per_s=generated / wall if wall > 0 else 0.0,
        ttft_mean_s=float(np.mean(ttfts)) if ttfts else 0.0,
        ttft_p50_s=pct(ttfts, 50), ttft_p95_s=pct(ttfts, 95),
        tpot_p50_s=pct(tpots, 50), tpot_p95_s=pct(tpots, 95),
        queue_delay_p50_s=pct(qdels, 50), queue_delay_p95_s=pct(qdels, 95),
        preemptions=sum(st.preemptions for st in per_replica),
        timeouts=sum(st.timeouts for st in per_replica),
        cancelled=sum(st.cancelled for st in per_replica),
        prefill_chunks=sum(st.prefill_chunks for st in per_replica),
        decode_gap_p50_s=max((st.decode_gap_p50_s for st in per_replica),
                             default=0.0),
        decode_gap_p95_s=max((st.decode_gap_p95_s for st in per_replica),
                             default=0.0),
        decode_gap_max_s=max((st.decode_gap_max_s for st in per_replica),
                             default=0.0),
        spec_rounds=rounds,
        draft_proposed=proposed,
        draft_accepted=sum(st.draft_accepted for st in per_replica),
        acceptance_rate=(sum(st.draft_accepted for st in per_replica)
                         / proposed if proposed else 0.0),
        tokens_per_round=(committed / rounds if rounds else 0.0),
        pool_pages_total=sum(st.pool_pages_total for st in per_replica),
        pool_pages_peak=sum(st.pool_pages_peak for st in per_replica),
        pool_page_size=max((st.pool_page_size for st in per_replica),
                           default=0),
        prefix_hits=sum(st.prefix_hits for st in per_replica),
        prefix_hit_tokens=sum(st.prefix_hit_tokens for st in per_replica),
        cow_copies=sum(st.cow_copies for st in per_replica),
        kv_bytes_peak=sum(st.kv_bytes_peak for st in per_replica),
        requeues=sum(st.requeues for st in per_replica),
        tuned=per_replica[0].tuned if per_replica else "untuned",
        watchdog_trips=sum(st.watchdog_trips for st in per_replica),
        degraded_steps=sum(st.degraded_steps for st in per_replica),
        degrade_transitions=sum(st.degrade_transitions
                                for st in per_replica),
        kv_tier_steps=_sum_tiers([st.kv_tier_steps for st in per_replica]))


def _sum_tiers(tiers: list) -> tuple:
    """Elementwise sum of per-replica tier-step histograms (ragged: a
    replica that never degraded reports fewer tiers)."""
    width = max((len(t) for t in tiers), default=0)
    return tuple(sum(t[i] for t in tiers if i < len(t))
                 for i in range(width))
