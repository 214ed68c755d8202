"""One renderer for serve statistics, driven by the metrics snapshot (the
JAX package's ``obs/render.py``, copied).

``launch/serve.py`` formats its serve report here: ``ServeStats`` is a view
of the published registry (``obs/serve_metrics.py``), so every line below,
and the per-priority breakdown only the registry carries, renders from the
same numbers the Prometheus and JSON exports serialize. The line formats
are the reference's, so a report reads the same from either package.
"""

from __future__ import annotations

from typing import Optional


def _ms(v: float) -> str:
    return f"{v * 1e3:.0f}ms"


def serve_report(stats, *, wall_s: float, num_requests: int, chunk: int,
                 queueing: bool = False, prefill_chunk: int = 0,
                 replicas: Optional[dict] = None,
                 fault: bool = False, chaos_fired=None,
                 spec: bool = False, paged: Optional[dict] = None,
                 per_priority: bool = True) -> list[str]:
    """Render the serve stat block as lines. ``replicas`` carries the
    DP context (``replicas``/``mesh_shape``/``assignments``/
    ``occupancy``), ``paged`` the dense-reservation comparison context
    (``num_slots``/``kv_bytes_per_slot``/``max_seq``)."""
    lines = [
        f"served {num_requests} requests in {wall_s:.1f}s "
        f"({stats.generated_tokens / wall_s:.1f} tok/s): "
        f"{stats.num_chunks} chunks x {chunk} steps, "
        f"occupancy {stats.occupancy:.1%}, "
        f"{stats.admissions} mid-run admissions, "
        f"ttft p50 {_ms(stats.ttft_p50_s)} / "
        f"p95 {_ms(stats.ttft_p95_s)}, "
        f"tpot p50 {stats.tpot_p50_s * 1e3:.1f}ms"]
    if queueing:
        lines.append(
            f"queueing: delay p50 {_ms(stats.queue_delay_p50_s)} "
            f"/ p95 {_ms(stats.queue_delay_p95_s)}, "
            f"{stats.preemptions} preemptions, "
            f"{stats.timeouts} timeouts, {stats.cancelled} cancelled, "
            f"decode gap p95 {stats.decode_gap_p95_s * 1e3:.1f}ms / "
            f"max {stats.decode_gap_max_s * 1e3:.1f}ms")
        if per_priority:
            lines.extend(priority_report(stats.registry))
    if prefill_chunk:
        lines.append(f"chunked prefill: {stats.prefill_chunks} interleaved "
                     f"chunks of {prefill_chunk} tokens")
    if replicas is not None:
        occ = ", ".join(
            f"r{i}: {n} reqs, occ {o:.1%}"
            for i, (n, o) in enumerate(zip(replicas["assignments"],
                                           replicas["occupancy"])))
        lines.append(f"dp replicas: {replicas['replicas']} x "
                     f"{replicas['mesh_shape']} ({occ})")
    if fault:
        lines.append(
            f"fault tolerance: {stats.replica_restarts} replica restarts, "
            f"{stats.redriven_requests} requests re-driven, "
            f"recovery p95 {stats.recovery_p95_s * 1e3:.1f}ms, "
            f"{stats.watchdog_trips} watchdog trips")
        tiers = ", ".join(f"tier{i}: {n} steps"
                          for i, n in enumerate(stats.kv_tier_steps))
        lines.append(f"degradation: {stats.degrade_transitions} "
                     f"transitions, {stats.degraded_steps} degraded steps "
                     f"({tiers or 'no tier ladder'})")
        if chaos_fired:
            fired = ", ".join(
                f"{site}#{occ}" + (f"[r{tag}]" if tag is not None else "")
                for site, tag, occ in chaos_fired)
            lines.append(f"chaos fired: {fired}")
    if spec:
        lines.append(
            f"spec: acceptance {stats.acceptance_rate:.1%} "
            f"({stats.draft_accepted}/{stats.draft_proposed}), "
            f"{stats.tokens_per_round:.2f} tokens/round over "
            f"{stats.spec_rounds} rounds")
    if paged is not None:
        dense_resv = paged["num_slots"] * paged["kv_bytes_per_slot"]
        lines.append(
            f"paged pool: peak {stats.pool_pages_peak}"
            f"/{stats.pool_pages_total} pages x "
            f"{stats.pool_page_size} tokens, "
            f"prefix hits {stats.prefix_hits} "
            f"({stats.prefix_hit_tokens} prompt tokens skipped, "
            f"{stats.prefix_hit_rate:.1%} hit rate), "
            f"cow copies {stats.cow_copies}")
        lines.append(
            f"kv memory: peak {stats.kv_bytes_peak / 2**20:.2f} MiB "
            f"paged vs {dense_resv / 2**20:.2f} MiB dense reservation "
            f"({paged['num_slots']} slots x "
            f"{paged['kv_bytes_per_slot'] / 2**20:.2f} MiB at "
            f"max_seq={paged['max_seq']})")
    return lines


def priority_report(reg) -> list[str]:
    """Per-priority-class latency breakdown (SLO scheduling admits by
    priority; aggregate percentiles hide priority inversions). Empty
    unless the registry saw more than one class."""
    if reg is None:
        return []
    m = reg.get("serve_requests_total")
    if m is None:
        return []
    by_pri = m.labeled("priority")
    if len(by_pri) < 2:
        return []
    lines = []
    for p in sorted(by_pri, key=lambda v: int(v)):
        lines.append(
            f"  priority {p}: {int(by_pri[p])} reqs, "
            f"queue delay p50 "
            f"{_ms(reg.quantile('serve_queue_delay_seconds', 50, priority=p))}"
            f" / p95 "
            f"{_ms(reg.quantile('serve_queue_delay_seconds', 95, priority=p))}"
            f", ttft p50 "
            f"{_ms(reg.quantile('serve_ttft_seconds', 50, priority=p))}"
            f" / p95 "
            f"{_ms(reg.quantile('serve_ttft_seconds', 95, priority=p))}, "
            f"tpot p50 "
            f"{reg.quantile('serve_tpot_seconds', 50, priority=p) * 1e3:.1f}"
            f"ms")
    return lines


def derived(stats, wall_s: float) -> dict:
    """Throughput derivations shared by the CLI line and the benchmark
    rows (one formula, not N copies)."""
    return {
        "tok_s": stats.generated_tokens / wall_s if wall_s else 0.0,
        "us_per_tok": (wall_s / stats.generated_tokens * 1e6
                       if stats.generated_tokens else 0.0),
    }
