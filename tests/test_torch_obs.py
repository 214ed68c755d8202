"""The port's observability layer (``src/repro_torch/obs``) against the JAX
package's (``src/repro/obs``), and the port's traced serves against the JAX
engine's, at SMOKE size on the CPU:

* registries: the same counter / gauge / histogram operations (merges
  included) give the same Prometheus text, byte for byte, and the same
  JSON snapshot;
* traces: the same span, instant and request-phase calls give the same
  events apart from ``ts`` / ``dur``;
* profile windows: ``ProfileHooks.tick`` and ``parse`` on crossing,
  aligned and teardown windows, as tests/test_obs.py holds the reference;
  a real ``torch.profiler`` window writes its Chrome trace;
* the serve-metric schema and the renderer equal to the reference's;
* traced serves on the dense SMOKE model trained 40 steps (f32): a plain
  stream, a paged stream with cancellation, queue timeouts and a
  preemption, a prefix-sharing stream, a two-replica failover under
  ``replica_fault`` and an ``OutOfPages`` unwind under degradation, each
  with equal ``Tracer.counts()``, request phases per rid, counter totals
  and histogram sample counts to the JAX engine's, and no open span;
* ``ServeStats.from_registry(stats.registry) == stats`` for the dense,
  ssm, hybrid, enc-dec and MoE families;
* tracing and device fences change no token or logprob.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs.base import RunConfig
from repro.configs.registry import get_config as jget_config
from repro.obs import render as jrender
from repro.obs import serve_metrics as jsm
from repro.serving import chaos as jchaos
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.engine import ServeStats as JServeStats
from repro.serving.pool import OutOfPages as JOutOfPages
from repro.serving.pool import PagedConfig as JPagedConfig
from repro.serving.replica import FailoverConfig as JFailoverConfig
from repro.serving.replica import ReplicaServe as JReplicaServe
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import SLOConfig as JSLOConfig
from repro.serving.session import DegradeConfig as JDegradeConfig
from repro.train.loop import train
from repro_torch import obs
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.models.model import build
from repro_torch.obs import render
from repro_torch.obs import serve_metrics as sm
from repro_torch.obs.trace import REQ_TRACK_BASE
from repro_torch.serving import chaos as tchaos
from repro_torch.serving.engine import ServeEngine, ServeStats
from repro_torch.serving.pool import OutOfPages, PagedConfig
from repro_torch.serving.replica import FailoverConfig, ReplicaServe
from repro_torch.serving.scheduler import Request, SLOConfig
from repro_torch.serving.session import DegradeConfig
from repro_torch.serving.spec import SpecConfig

torch.set_num_threads(2)

BOTH = ((obs, "port"), (jobs, "jax"))


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

def _ops_counters(reg):
    c = reg.counter("serve_x_total", "x help")
    c.inc(2, replica="0")
    c.inc(3, replica="0", reason="eos")
    c.inc(0.5, replica="1")
    reg.counter("serve_x_total")          # create-or-get
    reg.counter("serve_nohelp_total").inc(1e20)
    reg.counter("serve_nohelp_total", "later help").inc(7, k="v")


def _ops_gauges(reg):
    g = reg.gauge("serve_level", "a level")
    g.set(4.0, kind="peak")
    g.set(2.0, kind="peak")
    g.inc(1.5, kind="peak")
    g.set(0.1 + 0.2, kind="total")
    reg.gauge("serve_tuned_info").set(1.0, key="untuned", replica="0")


def _ops_histograms(reg):
    h = reg.histogram("serve_lat_seconds", "latency")
    for i, v in enumerate(np.random.RandomState(3).exponential(0.05, 200)):
        h.observe(float(v), replica=str(i % 2), priority=str(i % 3))
    h.observe(11.0, replica="0", priority="0")     # past the last bucket
    c = reg.histogram("serve_custom_seconds", "custom", buckets=(2.0, 0.1))
    c.observe(0.05)
    c.observe(1.0)
    c.observe(0.1)


def _ops_merge(reg, mod):
    other = mod.MetricsRegistry()
    _ops_counters(other)
    _ops_gauges(other)
    _ops_histograms(other)
    reg.counter("serve_x_total").inc(1, replica="0")
    reg.gauge("serve_level").set(9.0, kind="peak")
    reg.histogram("serve_lat_seconds").observe(0.3, replica="2")
    reg.merge(other)
    reg.merge(other)


PROGRAMS = {
    "counters": lambda reg, mod: _ops_counters(reg),
    "gauges": lambda reg, mod: _ops_gauges(reg),
    "histograms": lambda reg, mod: _ops_histograms(reg),
    "merge": _ops_merge,
    "empty": lambda reg, mod: None,
}


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_registry_expositions_equal_the_reference(program, tmp_path):
    regs = {}
    for mod, name in BOTH:
        reg = mod.MetricsRegistry()
        PROGRAMS[program](reg, mod)
        regs[name] = reg
    port, ref = regs["port"], regs["jax"]
    assert port.to_prometheus() == ref.to_prometheus()
    assert port.snapshot() == ref.snapshot()
    assert port.to_json() == ref.to_json()
    assert port.names() == ref.names()
    for name in ref.names():
        m, r = port.get(name), ref.get(name)
        assert m.total() == r.total()
        if r.kind == "histogram":
            for q in (50, 95):
                assert m.quantile(q) == r.quantile(q)
                assert m.quantile(q, priority="1") == r.quantile(
                    q, priority="1")
            assert m.max() == r.max() and m.count() == r.count()
            assert m.label_values("priority") == r.label_values("priority")
    port.write_prometheus(str(tmp_path / "p.prom"))
    port.write_json(str(tmp_path / "p.json"))
    assert (tmp_path / "p.prom").read_text() == ref.to_prometheus()
    assert json.loads((tmp_path / "p.json").read_text()) == ref.snapshot()


@pytest.mark.parametrize("case", ["decrease", "kind", "buckets"])
def test_registry_refusals_equal_the_reference(case):
    errors = []
    for mod, _ in BOTH:
        reg = mod.MetricsRegistry()
        try:
            if case == "decrease":
                reg.counter("serve_x_total").inc(-1)
            elif case == "kind":
                reg.counter("serve_x_total")
                reg.gauge("serve_x_total")
            else:
                reg.histogram("serve_h_seconds").observe(0.1)
                bad = mod.MetricsRegistry()
                bad.histogram("serve_h_seconds", buckets=(1.0,)).observe(1)
                reg.merge(bad)
        except (ValueError, TypeError) as e:
            errors.append((type(e), str(e)))
    assert len(errors) == 2 and errors[0] == errors[1]


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

def _untimed(events):
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur")}
            for ev in events]


def _trace_program(tr, mod):
    tr.set_process_name(0, "replica0")
    tr.set_process_name(0, "replica0")                 # idempotent
    tr.set_process_name(1, "replica1")
    tr.begin("tick/dispatch", 0)
    tr.begin("inner", 0, args={"a": 1})
    tr.end("inner", 0, args={"b": 2})
    tr.end("tick/dispatch", 0)
    t0 = tr.now_us()
    tr.complete("decode/chunk", t0, 0, mod.DECODE_TRACK,
                args={"steps": 4, "tier": 0})
    tr.instant("chaos/fire", 1, args={"site": "pool.oom"})
    tr.instant("plain")
    for rid in (3, 5):
        tr.request_phase(0, rid, "queued", args={"priority": 1})
        tr.request_phase(0, rid, "prefill", args={"slot": 0})
    tr.request_phase(0, 3, "decode")
    tr.request_done(0, 3, "finish", args={"reason": "eos"})
    tr.request_done(0, 5, "redrive")
    tr.request_phase(1, 5, "queued")
    tr.request_done(1, 5, "preempt")
    tr.request_done(1, 9, "finish")                    # no open phase
    tr.begin("a", 1, mod.DECODE_TRACK)
    tr.begin("b", 1, mod.DECODE_TRACK)
    tr.begin("c", 0)
    tr.abandon(1, mod.DECODE_TRACK, reason="quarantine")


def test_trace_events_equal_the_reference_apart_from_time(tmp_path):
    trs = {}
    for mod, name in BOTH:
        tr = mod.Tracer()
        _trace_program(tr, mod)
        trs[name] = tr
    port, ref = trs["port"], trs["jax"]
    assert _untimed(port.events) == _untimed(ref.events)
    assert port.counts() == ref.counts()
    assert port.open_spans() == ref.open_spans() == [(0, 0, "c")]
    assert (obs.ENGINE_TRACK, obs.DECODE_TRACK, obs.REQ_TRACK_BASE) == (
        jobs.ENGINE_TRACK, jobs.DECODE_TRACK, jobs.REQ_TRACK_BASE)
    doc = port.to_json()
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    assert doc["displayTimeUnit"] == ref.to_json()["displayTimeUnit"]
    port.write(str(tmp_path / "t.json"))
    back = json.loads((tmp_path / "t.json").read_text())
    assert _untimed(back["traceEvents"]) == _untimed(ref.events)
    x = [e for e in port.events if e["ph"] == "X"]
    assert len(x) == 1 and x[0]["dur"] >= 0
    with pytest.raises(AssertionError, match="misnesting"):
        port.end("not-open", 0)


def test_facade_off_by_default_install_and_capture():
    assert obs.tracer() is None and obs.metrics() is None
    assert obs.profile() is None and not obs.enabled()
    obs.request_phase(0, 0, "queued")
    obs.request_done(0, 0, "finish")
    obs.instant("x", 0)
    obs.count("serve_x_total", 1)
    obs.observe("serve_x_seconds", 0.1)
    tr, mx = obs.Tracer(), obs.MetricsRegistry()
    prev = obs.install(tr, mx)
    try:
        assert obs.enabled()
        obs.instant("x", 0)
        obs.count("serve_x_total", 2, "help text", replica="0")
        obs.observe("serve_x_seconds", 0.5)
        obs.install(metrics=None)                  # keeps the tracer
        assert obs.tracer() is tr and obs.metrics() is None
    finally:
        obs.install(*prev)
    assert obs.tracer() is None and obs.metrics() is None
    assert tr.counts()[("x", "i")] == 1
    assert mx.get("serve_x_total").value(replica="0") == 2
    assert mx.get("serve_x_total").help == "help text"
    with obs.capture() as (tr2, mx2):
        assert obs.tracer() is tr2 and obs.metrics() is mx2
        obs.instant("y", 0)
    assert obs.tracer() is None
    assert tr2.counts()[("y", "i")] == 1
    assert sorted(obs.__all__) == sorted(jobs.__all__)


# ---------------------------------------------------------------------------
# profile windows
# ---------------------------------------------------------------------------

def _fake_profiler(prof, calls):
    def fake_start():
        calls.append("start")
        prof._capturing = True

    def fake_stop():
        if not prof._capturing:
            return
        prof._capturing = False
        prof.steps = None
        prof.windows += 1
        calls.append("stop")
    prof._start = fake_start
    prof.stop = fake_stop


def _window_run(mod, spec, clocks, teardown):
    prof = mod.ProfileHooks.parse(spec)
    calls = []
    _fake_profiler(prof, calls)
    trail = []
    for clock in clocks:
        prof.tick(clock)
        trail.append((clock, prof._capturing, prof.windows))
    if teardown:
        prof.stop()
        prof.stop()                                # idempotent
    return calls, trail, prof.windows, prof.steps


@pytest.mark.parametrize("spec,clocks,teardown", [
    ("1:3", (0, 4, 8, 12), False),     # narrower than a chunk: crossing
    ("2:6", (0, 2, 4), True),          # aligned, flushed at teardown
    ("0:8", (0, 8, 16), False),        # starts at the first tick
    ("8:24", (0, 8, 16, 24, 32), False),
    ("5:100", (0, 4, 8), True),
    ("40:50", (0, 8, 16), True),       # never reached: no window
])
def test_profile_window_ticks_equal_the_reference(spec, clocks, teardown):
    port = _window_run(obs, spec, clocks, teardown)
    assert port == _window_run(jobs, spec, clocks, teardown)
    assert port[2] <= 1


@pytest.mark.parametrize("spec", ["3:1", "nope", "1:1", "1:2:3", "-1:2"])
def test_profile_parse_refusals_equal_the_reference(spec):
    for mod, _ in BOTH:
        with pytest.raises(ValueError):
            mod.ProfileHooks.parse(spec)
    assert obs.ProfileHooks.parse("2:9").steps == \
        jobs.ProfileHooks.parse("2:9").steps == (2, 9)


def test_profile_window_writes_a_chrome_trace(tmp_path):
    """The real ``torch.profiler`` window on the CPU: it starts at the
    crossing tick, records the ops run inside it and writes one Chrome
    trace under ``trace_dir``; the device fence times a call by the host
    clock off the card."""
    prof = obs.ProfileHooks(steps=(4, 8), trace_dir=str(tmp_path / "p"))
    x = torch.randn(64, 64)
    prof.tick(0)
    torch.mm(x, x)
    prof.tick(4)
    assert prof._capturing
    torch.mm(x, x)
    prof.tick(8)
    assert not prof._capturing and prof.windows == 1
    prof.stop()
    (path,) = prof.trace_files
    events = json.loads(open(path).read())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    start = prof.fence_start(torch.device("cpu"))
    assert prof.fence_end(torch.device("cpu"), start) >= 0.0


# ---------------------------------------------------------------------------
# schema and renderer
# ---------------------------------------------------------------------------

def test_schema_equals_the_reference_and_covers_servestats():
    assert sm.SCHEMA == jsm.SCHEMA
    assert sm.STATS_FIELD_METRICS == jsm.STATS_FIELD_METRICS
    fields = {f.name for f in dataclasses.fields(ServeStats)}
    ref = {f.name for f in dataclasses.fields(JServeStats)}
    assert fields == ref | set(sm.PORT_FIELDS)
    assert fields - {"registry"} == (set(sm.STATS_FIELD_METRICS)
                                     | set(sm.PORT_FIELDS))
    assert not set(sm.PORT_FIELDS) & ref
    # the port's own fields and the registry stay out of ==
    out_of_eq = {f.name for f in dataclasses.fields(ServeStats)
                 if not f.compare}
    assert out_of_eq == set(sm.PORT_FIELDS) | {"registry"}


@dataclasses.dataclass
class _Out:
    priority: int = 1
    finish_reason: str = "eos"
    preempted: int = 0
    ttft_s: float = 0.1
    tpot_s: float = 0.01
    queue_delay_s: float = 0.05


_PUBLISH = dict(
    replica=1, occupancy=0.75, num_chunks=5, chunk=4, admissions=2,
    generated=40, prefill_chunks=3, gaps=[0.02, 0.04],
    spec_m=dict(rounds=10, proposed=20, accepted=15, committed=25),
    spec_labels={"k": "2", "source": "model"}, watchdog_trips=1,
    degraded_steps=8, transitions=2, tier_steps=(12, 8),
    tier_labels=["bf16", "int8"], tuned="untuned",
    pool=dict(pages_total=6, pages_peak=5, page_size=8, prefix_hits=2,
              prefix_hit_tokens=12, prompt_tokens=24, cow_copies=1,
              kv_bytes_peak=4096.0),
    device_times=[0.01], host_gaps=[0.005], recovery=[0.2], restarts=1,
    redriven=4)


def test_publish_round_trip_and_render_equal_the_reference():
    outs = [_Out(), _Out(priority=0, finish_reason="timeout", ttft_s=0.3),
            _Out(finish_reason="cancelled", preempted=2)]
    regs = {}
    for mod, name in ((sm, "port"), (jsm, "jax")):
        reg = (obs if mod is sm else jobs).MetricsRegistry()
        mod.publish_session(reg, outputs=outs, **_PUBLISH)
        regs[name] = reg
    assert regs["port"].to_prometheus() == regs["jax"].to_prometheus()
    fields = sm.stats_fields(regs["port"])
    assert fields == jsm.stats_fields(regs["jax"])
    stats = ServeStats.from_registry(regs["port"], wall_s=2.0)
    jstats = JServeStats.from_registry(regs["jax"])
    assert ServeStats.from_registry(stats.registry) == stats
    assert stats.wall_s == 2.0 and stats.tuned == "untuned"
    kw = dict(wall_s=2.0, num_requests=3, chunk=4, queueing=True,
              prefill_chunk=16, fault=True,
              chaos_fired=[("replica.dispatch", 1, 3), ("pool.oom", 0, 2)],
              spec=True, paged=dict(num_slots=2, kv_bytes_per_slot=2048.0,
                                    max_seq=32))
    assert render.serve_report(stats, **kw) == jrender.serve_report(jstats,
                                                                    **kw)
    assert render.priority_report(stats.registry) == \
        jrender.priority_report(jstats.registry)
    assert len(render.priority_report(stats.registry)) == 2
    assert render.derived(stats, 2.0) == jrender.derived(jstats, 2.0)


# ---------------------------------------------------------------------------
# traced serves against the JAX engine's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained_dense():
    """The dense SMOKE model trained as tests/conftest.py trains it (f32,
    40 steps, lr 3e-3, batch 8, seq 16)."""
    cfg = dataclasses.replace(jget_config("llama3.2-3b", smoke=True),
                              dtype="float32")
    run = RunConfig(steps=40, learning_rate=3e-3, warmup_steps=3,
                    remat=False)
    res = train(cfg, run, batch=8, seq=16)
    tcfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True),
                               dtype="float32")
    tparams = from_jax(jax.tree.map(np.asarray, res["params"]),
                       device="cpu")
    return cfg, res["model"], res["params"], build(tcfg), tparams


def _requests(vocab, n=6, prompt_len=8, max_new=8, arrival_every=2,
              shared=0, **kw):
    rng = np.random.RandomState(10)
    prompts = [rng.randint(0, vocab, size=(prompt_len,)).astype(np.int32)
               for _ in range(n)]
    for p in prompts:
        p[:shared] = prompts[0][:shared]
    pair = []
    for cls in (JRequest, Request):
        pair.append([cls(rid=i, prompt=p.copy(), max_new_tokens=max_new,
                         arrival_step=i * arrival_every, **kw)
                     for i, p in enumerate(prompts)])
    return pair


def _phases(tr) -> dict:
    """Each request's track, in order: (pid, rid) -> [(name, ph), ...]."""
    out: dict = {}
    for ev in tr.events:
        if ev["tid"] >= REQ_TRACK_BASE:
            out.setdefault((ev["pid"], ev["tid"] - REQ_TRACK_BASE),
                           []).append((ev["name"], ev["ph"]))
    return out


def _metric_view(reg) -> tuple:
    """Every counter's total and every histogram's sample count."""
    counters, samples = {}, {}
    for name in reg.names():
        m = reg.get(name)
        if m.kind == "counter":
            counters[name] = m.total()
        elif m.kind == "histogram":
            samples[name] = m.count()
    return counters, samples


def _hold_traces(ttr, jtr, tmx, jmx):
    assert ttr.open_spans() == [] and jtr.open_spans() == []
    counts = ttr.counts()
    assert counts == jtr.counts()
    assert _phases(ttr) == _phases(jtr)
    assert _metric_view(tmx) == _metric_view(jmx)
    json.dumps(ttr.to_json())                      # serializable
    return counts


def _same_tokens(touts, jouts):
    assert [o.rid for o in touts] == [o.rid for o in jouts]
    for t, j in zip(touts, jouts):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        assert t.finish_reason == j.finish_reason


def _traced_pair(jrun, trun):
    with jobs.capture() as (jtr, jmx):
        jres = jrun()
    with obs.capture() as (ttr, tmx):
        tres = trun()
    return (ttr, tmx, tres), (jtr, jmx, jres)


def test_traced_stream_matches_the_reference(trained_dense):
    cfg, jmodel, jparams, tmodel, tparams = trained_dense
    jreqs, treqs = _requests(cfg.vocab_size)
    jeng = JServeEngine(jmodel, jparams, max_seq=18)
    teng = ServeEngine(tmodel, tparams, max_seq=18, device="cpu")
    base_outs, base_stats = teng.serve(treqs, num_slots=2, chunk=4)
    (ttr, tmx, (touts, stats)), (jtr, jmx, (jouts, _)) = _traced_pair(
        lambda: jeng.serve(jreqs, num_slots=2, chunk=4),
        lambda: teng.serve(treqs, num_slots=2, chunk=4))
    _same_tokens(touts, jouts)
    counts = _hold_traces(ttr, jtr, tmx, jmx)
    assert counts[("request/prefill", "B")] == len(treqs)
    assert counts[("request/decode", "B")] == len(treqs)
    assert counts[("request/finish", "i")] == len(treqs)
    assert counts[("decode/chunk", "X")] == stats.num_chunks
    assert counts[("tick/dispatch", "B")] == counts[("tick/harvest", "B")]
    # tracing changes no token, logprob or counted stat
    for a, b in zip(base_outs, touts):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.logprobs, b.logprobs)
    for f in ("decode_steps", "generated_tokens", "num_chunks",
              "admissions", "preemptions", "timeouts", "cancelled",
              "occupancy", "requeues"):
        assert getattr(stats, f) == getattr(base_stats, f), f
    assert tmx.total("serve_generated_tokens_total") == \
        stats.generated_tokens
    assert tmx.get("serve_requests_total").value(
        replica="0", reason="length", priority="1") == len(treqs)
    # with nothing installed the view holds what the old finalize computed
    # straight from the outputs and the session's counters
    ttfts = [o.ttft_s for o in base_outs if o.ttft_s is not None]
    tpots = [o.tpot_s for o in base_outs if o.tpot_s is not None]
    assert base_stats.ttft_p95_s == float(np.percentile(ttfts, 95))
    assert base_stats.tpot_p50_s == float(np.percentile(tpots, 50))
    assert base_stats.ttft_mean_s == float(np.mean(ttfts))
    assert base_stats.generated_tokens == sum(len(o.generated)
                                              for o in base_outs)
    assert base_stats.tokens_per_s == pytest.approx(
        base_stats.generated_tokens / base_stats.wall_s)
    assert base_stats.registry is not None
    assert base_stats.kv_tier_steps == (base_stats.decode_steps,)


def test_traced_cancel_preempt_matches_the_reference(trained_dense):
    cfg, jmodel, jparams, tmodel, tparams = trained_dense
    jreqs, treqs = _requests(cfg.vocab_size, n=6, max_new=24,
                             arrival_every=0)
    for reqs in (jreqs, treqs):
        reqs[1].cancel_at_step = 16      # running (after its preemption)
        reqs[2].queue_timeout_steps = 2  # times out in the queue
        reqs[3].priority = 0             # urgent, at step 4: preempts
        reqs[3].arrival_step = 4
        reqs[4].cancel_at_step = 3       # cancelled in the queue
        reqs[5].max_new_tokens = 8
    jeng = JServeEngine(jmodel, jparams, max_seq=34,
                        paged=JPagedConfig(page_size=8))
    teng = ServeEngine(tmodel, tparams, max_seq=34,
                       paged=PagedConfig(page_size=8), device="cpu")
    (ttr, tmx, (touts, stats)), (jtr, jmx, (jouts, _)) = _traced_pair(
        lambda: jeng.serve(jreqs, num_slots=2, chunk=4,
                           slo=JSLOConfig(preempt=True)),
        lambda: teng.serve(treqs, num_slots=2, chunk=4,
                           slo=SLOConfig(preempt=True)))
    _same_tokens(touts, jouts)
    counts = _hold_traces(ttr, jtr, tmx, jmx)
    assert stats.cancelled > 0 and stats.timeouts > 0
    assert stats.preemptions > 0
    assert counts[("request/preempt", "i")] == stats.preemptions
    assert counts[("request/finish", "i")] == len(touts)
    assert set(tmx.get("serve_requests_total").labeled("priority")) == \
        {"0", "1"}
    teng.pool.check_invariants()


def test_traced_prefix_sharing_matches_the_reference(trained_dense):
    cfg, jmodel, jparams, tmodel, tparams = trained_dense
    jreqs, treqs = _requests(cfg.vocab_size, n=4, prompt_len=12,
                             shared=10)
    jeng = JServeEngine(jmodel, jparams, max_seq=24,
                        paged=JPagedConfig(page_size=4))
    teng = ServeEngine(tmodel, tparams, max_seq=24,
                       paged=PagedConfig(page_size=4), device="cpu")
    (ttr, tmx, (touts, stats)), (jtr, jmx, (jouts, _)) = _traced_pair(
        lambda: jeng.serve(jreqs, num_slots=2, chunk=4),
        lambda: teng.serve(treqs, num_slots=2, chunk=4))
    _same_tokens(touts, jouts)
    counts = _hold_traces(ttr, jtr, tmx, jmx)
    assert counts[("pool/prefix-hit", "i")] == stats.prefix_hits > 0
    assert counts[("pool/cow-copy", "i")] == stats.cow_copies > 0
    assert all(ev["pid"] == 0 for ev in ttr.events
               if ev["name"].startswith("pool/"))


def test_traced_failover_matches_the_reference(trained_dense):
    cfg, jmodel, jparams, tmodel, tparams = trained_dense
    jreqs, treqs = _requests(cfg.vocab_size)
    jrs = JReplicaServe([JServeEngine(jmodel, jparams, max_seq=18,
                                      paged=JPagedConfig(page_size=8,
                                                         pool_pages=6))
                         for _ in range(2)])
    trs = ReplicaServe([ServeEngine(tmodel, tparams, max_seq=18,
                                    paged=PagedConfig(page_size=8,
                                                      pool_pages=6),
                                    device="cpu") for _ in range(2)])

    def jrun():
        with jchaos.chaos(jchaos.FaultConfig.parse("replica_fault")) as inj:
            res = jrs.serve(jreqs, num_slots=2, chunk=4,
                            failover=JFailoverConfig())
        return res, inj.log

    def trun():
        with tchaos.chaos(tchaos.FaultConfig.parse("replica_fault")) as inj:
            res = trs.serve(treqs, num_slots=2, chunk=4,
                            failover=FailoverConfig())
        return res, inj.log

    (ttr, tmx, ((touts, st), tlog)), (jtr, jmx, ((jouts, jst), jlog)) = \
        _traced_pair(jrun, trun)
    _same_tokens(touts, jouts)
    assert tlog == jlog
    counts = _hold_traces(ttr, jtr, tmx, jmx)
    agg = st.aggregate
    assert counts[("replica/failover", "X")] == agg.replica_restarts == 1
    assert counts[("request/redrive", "i")] == agg.redriven_requests > 0
    assert counts[("chaos/fire", "i")] == len(tlog)
    for name in ("serve_replica_restarts_total",
                 "serve_redriven_requests_total",
                 "serve_chaos_faults_total"):
        assert tmx.total(name) == jmx.total(name)
    assert tmx.total("serve_chaos_faults_total") == len(tlog)
    assert tmx.get("serve_recovery_seconds").count() == 1
    # the aggregate's merged registry: per-replica labels and the failover
    assert _metric_view(agg.registry) == _metric_view(
        jst.aggregate.registry)
    assert agg.registry.total("serve_replica_restarts_total") == 1
    assert agg.registry.get("serve_generated_tokens_total").labeled(
        "replica").keys() == {"0", "1"}
    assert agg.tuned == "untuned"


def test_traced_out_of_pages_unwinds_like_the_reference(trained_dense):
    _, jmodel, jparams, tmodel, tparams = trained_dense
    jeng = JServeEngine(jmodel, jparams, max_seq=64,
                        paged=JPagedConfig(page_size=8, pool_pages=1))
    teng = ServeEngine(tmodel, tparams, max_seq=64,
                       paged=PagedConfig(page_size=8, pool_pages=1),
                       device="cpu")
    prompt = np.zeros(32, np.int32)

    def jrun():
        with pytest.raises(JOutOfPages):
            jeng.serve([JRequest(rid=0, prompt=prompt, max_new_tokens=32)],
                       num_slots=1, chunk=4, degrade=JDegradeConfig())

    def trun():
        with pytest.raises(OutOfPages):
            teng.serve([Request(rid=0, prompt=prompt, max_new_tokens=32)],
                       num_slots=1, chunk=4, degrade=DegradeConfig())

    (ttr, tmx, _), (jtr, jmx, _) = _traced_pair(jrun, trun)
    counts = _hold_traces(ttr, jtr, tmx, jmx)
    assert counts[("request/redrive", "i")] == 1
    assert counts.get(("engine/apply_kv_plan", "X"), 0) == \
        counts.get(("degrade/transition", "i"), 0) > 0


# ---------------------------------------------------------------------------
# unchanged results, the device fence, and the stats views of every family
# ---------------------------------------------------------------------------

def _small_requests(vocab, n=3, max_new=6):
    rng = np.random.RandomState(4)
    return [Request(rid=i, prompt=rng.randint(0, vocab, size=(6,)).astype(
        np.int32), max_new_tokens=max_new, arrival_step=i) for i in range(n)]


@pytest.mark.parametrize("spec", [None, "ngram"])
def test_traced_and_fenced_serve_changes_no_token(trained_dense, spec):
    """A traced, metered serve with device fences armed (on the CPU the
    fence is the chunk call's wall time) gives the untraced serve's tokens
    and logprobs; every chunk has one device time no larger than its gap,
    and the registry view round-trips. A spec serve traces one
    ``spec/round`` a chunk with the chunk's counters."""
    _, _, _, tmodel, tparams = trained_dense
    eng = ServeEngine(tmodel, tparams, max_seq=24, device="cpu",
                      spec=(SpecConfig(k=2, draft_source=spec)
                            if spec else None))
    reqs = _small_requests(tmodel.cfg.vocab_size)
    base, base_stats = eng.serve(reqs, num_slots=2, chunk=4)
    prof = obs.ProfileHooks(device_fences=True)
    with obs.capture(profile=prof) as (tr, mx):
        outs, stats = eng.serve(reqs, num_slots=2, chunk=4)
    for a, b in zip(base, outs):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.logprobs, b.logprobs)
    assert tr.open_spans() == []
    chunks = [e for e in tr.events if e["name"] == "decode/chunk"]
    assert len(chunks) == stats.num_chunks > 0
    for e in chunks:
        assert 0 < e["args"]["device_ms"] <= e["dur"] / 1e3 + 1e-3
        assert e["args"]["host_gap_ms"] >= 0
        assert e["args"]["tuned"] == "untuned"
    reg = stats.registry
    assert reg.get("serve_device_time_seconds").count() == stats.num_chunks
    assert reg.get("serve_host_gap_seconds").count() == stats.num_chunks
    assert ServeStats.from_registry(reg) == stats
    assert prof.windows == 0                       # fences only, no window
    if spec:
        rounds = [e for e in tr.events if e["name"] == "spec/round"]
        assert len(rounds) == stats.num_chunks
        assert sum(e["args"]["rounds"] for e in rounds) == \
            stats.spec_rounds == base_stats.spec_rounds
        assert sum(e["args"]["proposed"] for e in rounds) == \
            stats.draft_proposed
        assert reg.get("serve_spec_rounds_total").labeled("source") == {
            "ngram": stats.spec_rounds}


FAMILIES = {"dense": "llama3.2-3b", "ssm": "mamba2-780m",
            "hybrid": "zamba2-2.7b", "encdec": "whisper-medium",
            "moe": "grok-1-314b"}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_stats_view_round_trips_per_family(family):
    """Every family's serve stats are a registry view: rebuilt from the
    attached registry they equal the dataclass field for field (the
    registry and the port's own fields are out of ==)."""
    cfg = get_config(FAMILIES[family], smoke=True)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(model, params, max_seq=16, device="cpu")
    with obs.capture() as (tr, mx):
        out, stats = eng.serve(_small_requests(cfg.vocab_size), num_slots=2,
                               chunk=4)
    assert len(out) == 3 and stats.generated_tokens > 0
    assert 0.0 < stats.occupancy <= 1.0 and stats.num_chunks > 0
    assert stats.registry is not None and stats.wall_s > 0
    assert ServeStats.from_registry(stats.registry) == stats
    assert tr.open_spans() == []
    assert mx.total("serve_generated_tokens_total") == stats.generated_tokens
