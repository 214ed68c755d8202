"""The serving metric schema: one mapping between a serve run's data, the
metrics registry and ``ServeStats`` (the JAX package's
``obs/serve_metrics.py``, copied).

``publish_session`` writes what a ``ServeSession`` run produced into a
registry (counters, gauges and histograms with ``replica`` / ``priority``
/ ``tier`` labels); ``stats_fields`` reads a registry back into the
``ServeStats`` constructor's keywords. ``ServeSession.finalize`` composes
the two, so the registry is the single source of truth: the dataclass the
CLI prints and the Prometheus / JSON expositions are views of the same
published numbers.

Every ``ServeStats`` field of the reference has a metric here
(``STATS_FIELD_METRICS``). The port's own fields (``PORT_FIELDS``: the
serve's wall time, tokens/s, the mean TTFT and the requeues) have none:
``finalize`` sets them beside the view. Latency histograms also carry the
per-priority-class breakdown: ``quantile("serve_ttft_seconds", 95,
priority="0")``.
"""

from __future__ import annotations

from typing import Optional

# metric name -> (kind, help). The schema is data, not code, so a test
# can diff it against ServeStats' fields.
SCHEMA = {
    "serve_decode_steps_total":
        ("counter", "jitted decode steps executed (chunks x chunk)"),
    "serve_generated_tokens_total":
        ("counter", "tokens emitted across all requests"),
    "serve_decode_chunks_total":
        ("counter", "jitted decode chunks launched"),
    "serve_admissions_total":
        ("counter", "continuous-batching refills admitted mid-decode"),
    "serve_requests_total":
        ("counter", "finished requests by finish reason"),
    "serve_preemptions_total":
        ("counter", "restart-style evictions for higher priority"),
    "serve_timeouts_total":
        ("counter", "requests dropped by queue timeout"),
    "serve_cancelled_total":
        ("counter", "requests cancelled (queued or running)"),
    "serve_prefill_chunks_total":
        ("counter", "interleaved chunked-prefill advances"),
    "serve_spec_rounds_total":
        ("counter", "draft-propose/verify rounds executed"),
    "serve_draft_proposed_total":
        ("counter", "draft tokens proposed to live slots"),
    "serve_draft_accepted_total":
        ("counter", "draft tokens verified and committed"),
    "serve_draft_committed_total":
        ("counter", "tokens committed by spec rounds (incl. bonus)"),
    "serve_prefix_hits_total":
        ("counter", "admissions that reused shared prefix pages"),
    "serve_prefix_hit_tokens_total":
        ("counter", "prompt tokens served from shared pages"),
    "serve_prompt_tokens_total":
        ("counter", "prompt tokens across admitted requests"),
    "serve_cow_copies_total":
        ("counter", "COW boundary pages materialized"),
    "serve_watchdog_trips_total":
        ("counter", "dispatch->harvest deadline overruns"),
    "serve_degraded_steps_total":
        ("counter", "decode steps run below KV tier 0"),
    "serve_degrade_transitions_total":
        ("counter", "KV tier changes (spills + promotions)"),
    "serve_kv_tier_steps_total":
        ("counter", "decode steps per KV degradation tier"),
    "serve_replica_restarts_total":
        ("counter", "replicas quarantined and failed over"),
    "serve_redriven_requests_total":
        ("counter", "in-flight requests re-driven to survivors"),
    "serve_chaos_faults_total":
        ("counter", "chaos-injected faults fired, by site"),
    "serve_occupancy_ratio":
        ("gauge", "mean fraction of active slots per chunk"),
    "serve_pool_pages":
        ("gauge", "paged KV pool pages by kind (total/peak)"),
    "serve_pool_page_size_tokens":
        ("gauge", "tokens per KV page"),
    "serve_kv_bytes_peak":
        ("gauge", "peak physical KV bytes held"),
    "serve_tuned_info":
        ("gauge", "autotune cache key the engine was traced under"),
    "serve_ttft_seconds":
        ("histogram", "time to first token (dequeue -> first token)"),
    "serve_tpot_seconds":
        ("histogram", "per-output-token latency after the first"),
    "serve_queue_delay_seconds":
        ("histogram", "ready -> dequeue wait (separate from TTFT)"),
    "serve_decode_gap_seconds":
        ("histogram", "dispatch -> harvest wall per decode chunk"),
    "serve_device_time_seconds":
        ("histogram", "device compute per chunk (profiler fences)"),
    "serve_host_gap_seconds":
        ("histogram", "host scheduling gap per chunk (profiler fences)"),
    "serve_recovery_seconds":
        ("histogram", "replica failure -> survivors resumed"),
}

# ServeStats field -> the metric it is reconstructed from (derived ratios
# map to their inputs; tests/test_torch_obs.py holds the coverage)
STATS_FIELD_METRICS = {
    "decode_steps": "serve_decode_steps_total",
    "generated_tokens": "serve_generated_tokens_total",
    "occupancy": "serve_occupancy_ratio",
    "num_chunks": "serve_decode_chunks_total",
    "admissions": "serve_admissions_total",
    "ttft_p50_s": "serve_ttft_seconds",
    "ttft_p95_s": "serve_ttft_seconds",
    "tpot_p50_s": "serve_tpot_seconds",
    "tpot_p95_s": "serve_tpot_seconds",
    "queue_delay_p50_s": "serve_queue_delay_seconds",
    "queue_delay_p95_s": "serve_queue_delay_seconds",
    "preemptions": "serve_preemptions_total",
    "timeouts": "serve_timeouts_total",
    "cancelled": "serve_cancelled_total",
    "prefill_chunks": "serve_prefill_chunks_total",
    "decode_gap_p50_s": "serve_decode_gap_seconds",
    "decode_gap_p95_s": "serve_decode_gap_seconds",
    "decode_gap_max_s": "serve_decode_gap_seconds",
    "spec_rounds": "serve_spec_rounds_total",
    "draft_proposed": "serve_draft_proposed_total",
    "draft_accepted": "serve_draft_accepted_total",
    "acceptance_rate": "serve_draft_accepted_total",
    "tokens_per_round": "serve_draft_committed_total",
    "pool_pages_total": "serve_pool_pages",
    "pool_pages_peak": "serve_pool_pages",
    "pool_page_size": "serve_pool_page_size_tokens",
    "prefix_hits": "serve_prefix_hits_total",
    "prefix_hit_tokens": "serve_prefix_hit_tokens_total",
    "prefix_hit_rate": "serve_prompt_tokens_total",
    "cow_copies": "serve_cow_copies_total",
    "kv_bytes_peak": "serve_kv_bytes_peak",
    "tuned": "serve_tuned_info",
    "replica_restarts": "serve_replica_restarts_total",
    "redriven_requests": "serve_redriven_requests_total",
    "recovery_p95_s": "serve_recovery_seconds",
    "watchdog_trips": "serve_watchdog_trips_total",
    "degraded_steps": "serve_degraded_steps_total",
    "degrade_transitions": "serve_degrade_transitions_total",
    "kv_tier_steps": "serve_kv_tier_steps_total",
}


# ServeStats fields of the port alone: set by ServeSession.finalize beside
# the registry view, not reconstructed from it, and left out of ==
PORT_FIELDS = ("wall_s", "tokens_per_s", "ttft_mean_s", "requeues")


def _c(reg, name):
    return reg.counter(name, SCHEMA[name][1])


def _g(reg, name):
    return reg.gauge(name, SCHEMA[name][1])


def _h(reg, name):
    return reg.histogram(name, SCHEMA[name][1])


def publish_session(reg, *, replica: int, outputs, occupancy: float,
                    num_chunks: int, chunk: int, admissions: int,
                    generated: int, prefill_chunks: int, gaps,
                    spec_m: dict, spec_labels: Optional[dict],
                    watchdog_trips: int, degraded_steps: int,
                    transitions: int, tier_steps, tier_labels,
                    tuned: str, pool: Optional[dict] = None,
                    device_times=(), host_gaps=(),
                    recovery=(), restarts: int = 0,
                    redriven: int = 0) -> None:
    """Write one serve run into ``reg``. ``outputs`` are RequestOutputs
    (duck-typed — this module imports nothing from serving); ``pool`` is
    the page-pool reading dict or None for unpaged engines."""
    r = str(replica)
    _c(reg, "serve_decode_steps_total").inc(num_chunks * chunk, replica=r)
    _c(reg, "serve_generated_tokens_total").inc(generated, replica=r)
    _c(reg, "serve_decode_chunks_total").inc(num_chunks, replica=r)
    _c(reg, "serve_admissions_total").inc(admissions, replica=r)
    _c(reg, "serve_prefill_chunks_total").inc(prefill_chunks, replica=r)
    _c(reg, "serve_watchdog_trips_total").inc(watchdog_trips, replica=r)
    _c(reg, "serve_degraded_steps_total").inc(degraded_steps, replica=r)
    _c(reg, "serve_degrade_transitions_total").inc(transitions, replica=r)
    _g(reg, "serve_occupancy_ratio").set(occupancy, replica=r)
    _g(reg, "serve_tuned_info").set(1.0, key=tuned, replica=r)
    tiers = _c(reg, "serve_kv_tier_steps_total")
    for i, steps in enumerate(tier_steps):
        label = (tier_labels[i] if tier_labels is not None
                 and i < len(tier_labels) else str(i))
        tiers.inc(steps, replica=r, tier=str(i), precision=label)

    reqs = _c(reg, "serve_requests_total")
    preempts = _c(reg, "serve_preemptions_total")
    timeouts = _c(reg, "serve_timeouts_total")
    cancels = _c(reg, "serve_cancelled_total")
    ttft = _h(reg, "serve_ttft_seconds")
    tpot = _h(reg, "serve_tpot_seconds")
    qdel = _h(reg, "serve_queue_delay_seconds")
    for o in outputs:
        p = str(o.priority)
        reqs.inc(1, replica=r, reason=o.finish_reason, priority=p)
        if o.preempted:
            preempts.inc(o.preempted, replica=r, priority=p)
        if o.finish_reason == "timeout":
            timeouts.inc(1, replica=r, priority=p)
        elif o.finish_reason == "cancelled":
            cancels.inc(1, replica=r, priority=p)
        if o.ttft_s is not None:
            ttft.observe(o.ttft_s, replica=r, priority=p)
        if o.tpot_s is not None:
            tpot.observe(o.tpot_s, replica=r, priority=p)
        if o.queue_delay_s is not None:
            qdel.observe(o.queue_delay_s, replica=r, priority=p)

    gap = _h(reg, "serve_decode_gap_seconds")
    for g_ in gaps:
        gap.observe(g_, replica=r)
    dev = _h(reg, "serve_device_time_seconds")
    for d in device_times:
        dev.observe(d, replica=r)
    hg = _h(reg, "serve_host_gap_seconds")
    for h_ in host_gaps:
        hg.observe(h_, replica=r)

    sl = dict(spec_labels or {})
    _c(reg, "serve_spec_rounds_total").inc(spec_m["rounds"], replica=r, **sl)
    _c(reg, "serve_draft_proposed_total").inc(spec_m["proposed"],
                                              replica=r, **sl)
    _c(reg, "serve_draft_accepted_total").inc(spec_m["accepted"],
                                              replica=r, **sl)
    _c(reg, "serve_draft_committed_total").inc(spec_m["committed"],
                                               replica=r, **sl)

    if pool is not None:
        pages = _g(reg, "serve_pool_pages")
        pages.set(pool["pages_total"], replica=r, kind="total")
        pages.set(pool["pages_peak"], replica=r, kind="peak")
        _g(reg, "serve_pool_page_size_tokens").set(pool["page_size"],
                                                   replica=r)
        _g(reg, "serve_kv_bytes_peak").set(pool["kv_bytes_peak"], replica=r)
        _c(reg, "serve_prefix_hits_total").inc(pool["prefix_hits"],
                                               replica=r)
        _c(reg, "serve_prefix_hit_tokens_total").inc(
            pool["prefix_hit_tokens"], replica=r)
        _c(reg, "serve_prompt_tokens_total").inc(pool["prompt_tokens"],
                                                 replica=r)
        _c(reg, "serve_cow_copies_total").inc(pool["cow_copies"], replica=r)

    rec = _h(reg, "serve_recovery_seconds")
    for s in recovery:
        rec.observe(s, replica=r)
    if restarts:
        _c(reg, "serve_replica_restarts_total").inc(restarts, replica=r)
    if redriven:
        _c(reg, "serve_redriven_requests_total").inc(redriven, replica=r)


def stats_fields(reg) -> dict:
    """Reconstruct the ``ServeStats`` constructor kwargs from a published
    registry — the dataclass is a snapshot VIEW, not a second source."""
    proposed = reg.total("serve_draft_proposed_total")
    accepted = reg.total("serve_draft_accepted_total")
    committed = reg.total("serve_draft_committed_total")
    rounds = reg.total("serve_spec_rounds_total")
    prompt_tokens = reg.total("serve_prompt_tokens_total")
    hit_tokens = reg.total("serve_prefix_hit_tokens_total")
    gap = reg.get("serve_decode_gap_seconds")
    rec = reg.get("serve_recovery_seconds")

    def pool_gauge(name, **labels):
        m = reg.get(name)
        if m is None:
            return 0
        v = m.value(**labels)
        return v if v is not None else m.total()

    tuned = "untuned"
    m = reg.get("serve_tuned_info")
    if m is not None:
        keys = m.labeled("key")
        if keys:
            tuned = sorted(keys)[0]
    tiers: tuple = ()
    m = reg.get("serve_kv_tier_steps_total")
    if m is not None:
        by_tier = m.labeled("tier")
        if by_tier:
            width = max(int(t) for t in by_tier) + 1
            tiers = tuple(int(by_tier.get(str(i), 0))
                          for i in range(width))
    pool_pages = reg.get("serve_pool_pages")

    def pages(kind):
        if pool_pages is None:
            return 0
        vals = pool_pages.labeled("kind")
        return int(vals.get(kind, 0))

    return dict(
        decode_steps=int(reg.total("serve_decode_steps_total")),
        generated_tokens=int(reg.total("serve_generated_tokens_total")),
        occupancy=float(reg.total("serve_occupancy_ratio")),
        num_chunks=int(reg.total("serve_decode_chunks_total")),
        admissions=int(reg.total("serve_admissions_total")),
        ttft_p50_s=reg.quantile("serve_ttft_seconds", 50),
        ttft_p95_s=reg.quantile("serve_ttft_seconds", 95),
        tpot_p50_s=reg.quantile("serve_tpot_seconds", 50),
        tpot_p95_s=reg.quantile("serve_tpot_seconds", 95),
        queue_delay_p50_s=reg.quantile("serve_queue_delay_seconds", 50),
        queue_delay_p95_s=reg.quantile("serve_queue_delay_seconds", 95),
        preemptions=int(reg.total("serve_preemptions_total")),
        timeouts=int(reg.total("serve_timeouts_total")),
        cancelled=int(reg.total("serve_cancelled_total")),
        prefill_chunks=int(reg.total("serve_prefill_chunks_total")),
        decode_gap_p50_s=reg.quantile("serve_decode_gap_seconds", 50),
        decode_gap_p95_s=reg.quantile("serve_decode_gap_seconds", 95),
        decode_gap_max_s=(gap.max() if gap is not None else 0.0),
        spec_rounds=int(rounds),
        draft_proposed=int(proposed),
        draft_accepted=int(accepted),
        acceptance_rate=(accepted / proposed if proposed else 0.0),
        tokens_per_round=(committed / rounds if rounds else 0.0),
        pool_pages_total=pages("total"),
        pool_pages_peak=pages("peak"),
        pool_page_size=int(pool_gauge("serve_pool_page_size_tokens")),
        prefix_hits=int(reg.total("serve_prefix_hits_total")),
        prefix_hit_tokens=int(hit_tokens),
        prefix_hit_rate=(hit_tokens / prompt_tokens
                         if prompt_tokens else 0.0),
        cow_copies=int(reg.total("serve_cow_copies_total")),
        kv_bytes_peak=float(pool_gauge("serve_kv_bytes_peak")),
        tuned=tuned,
        replica_restarts=int(reg.total("serve_replica_restarts_total")),
        redriven_requests=int(reg.total("serve_redriven_requests_total")),
        recovery_p95_s=(rec.quantile(95) if rec is not None
                        and rec.count() else 0.0),
        watchdog_trips=int(reg.total("serve_watchdog_trips_total")),
        degraded_steps=int(reg.total("serve_degraded_steps_total")),
        degrade_transitions=int(reg.total("serve_degrade_transitions_total")),
        kv_tier_steps=tiers,
    )
