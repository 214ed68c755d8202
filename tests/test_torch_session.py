"""The serve session of the port (``serving/session.py``) and its scheduler
against the JAX package, on the dense SMOKE model trained as
tests/test_torch_serve.py trains it (greedy tokens are asserted only on
trained weights: untrained ones have near-ties).

* the scheduler op for op against JAX's ``Scheduler`` on the same request
  streams: priority order, queue timeout and cancel, deadline while
  running, preempt and requeue, the reserve / activate / unreserve cycle,
  and ``synthetic_stream`` with Poisson arrivals and priorities;
* ``serve(prefill_chunk=5)``: the tokens of the JAX engine's chunked serve
  and of the port's whole-prompt serve, ``prefill_chunks`` equal to JAX's;
  with int8 and int4 KV, under spec, and paged with a prefix hit;
* the SLO serves of tests/test_serving.py held to the JAX engine's outputs
  and counts: priority admission, the preemption round trip, queue
  timeout, cancelling a running request (which keeps its partial tokens),
  the deadline, and queue delay kept apart from TTFT;
* ``abort`` mid-serve leaks no page.

The other families' chunked serves are in tests/test_torch_session_families.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig
from repro.configs.registry import get_config as jget_config
from repro.serving import scheduler as JS
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.pool import PagedConfig as JPagedConfig
from repro.serving.spec import SpecConfig as JSpecConfig
from repro.train.loop import train
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.models.model import build
from repro_torch.serving import scheduler as TS
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.pool import PagedConfig
from repro_torch.serving.session import ServeSession
from repro_torch.serving.spec import SpecConfig

torch.set_num_threads(2)


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
    return cfg, res["model"], res["params"], tcfg, build(tcfg), tparams


# ---------------------------------------------------------------------------
# the scheduler, op for op
# ---------------------------------------------------------------------------

def _req(mod, rid, priority=1, arrival=0, **kw):
    return mod.Request(rid=rid, prompt=np.zeros(4, np.int32),
                       max_new_tokens=4, arrival_step=arrival,
                       priority=priority, **kw)


def _outs(s):
    return sorted((o.rid, o.finish_reason, o.admitted_step, o.finished_step,
                   o.queue_delay_steps, o.priority, o.preempted,
                   len(o.logprobs)) for o in s.finished)


def _priority(mod):
    s = mod.Scheduler(num_slots=1)
    for r in (_req(mod, 0, priority=2), _req(mod, 1, priority=0),
              _req(mod, 2, priority=1), _req(mod, 3, priority=0),
              _req(mod, 4, priority=0, arrival=3)):
        s.submit(r)
    trace = [s.peek_ready(0).rid, s.next_arrival()]
    trace += [s.next_ready(0).rid for _ in range(3)]
    trace += [s.next_ready(3).rid, s.next_ready(3).rid, s.next_ready(3)]
    return trace + [s.all_done()]


def _timeout_cancel(mod):
    s = mod.Scheduler(num_slots=1)
    s.submit(_req(mod, 0, queue_timeout_steps=3))
    s.submit(_req(mod, 1))
    s.submit(_req(mod, 2, cancel_at_step=4))
    s.submit(_req(mod, 3, arrival=6, queue_timeout_steps=1))
    s.cancel(1)
    trace = []
    for clock in (2, 3, 4, 5, 7):
        s.poll(clock, 0.0)
        s.expire(clock)
        trace.append((clock, _outs(s), s.timeouts, s.cancels,
                      s.num_pending))
    return trace + [s.all_done()]


def _deadline(mod):
    s = mod.Scheduler(num_slots=2)
    s.submit(_req(mod, 0, deadline_steps=6))
    s.submit(_req(mod, 1, arrival=2, deadline_steps=3, cancel_at_step=9))
    s.assign(0, s.next_ready(0), clock=0)
    trace = []
    for clock in (3, 5, 6, 8, 9):
        s.poll(clock, 0.0)
        trace.append([s.drop_reason(r, clock) for _, r in s.active_slots()]
                     + [s.drop_reason(r, clock, queued=True)
                        for r in (_req(mod, 1, arrival=2, deadline_steps=3,
                                       queue_timeout_steps=4),)])
    out = s.complete(0, np.arange(6, dtype=np.int32), np.zeros(2),
                     "deadline", 6)
    return trace + [(out.finish_reason, out.admitted_step), _outs(s),
                    s.timeouts, s.cancels]


def _preempt(mod):
    s = mod.Scheduler(num_slots=2)
    s.submit(_req(mod, 0, priority=2))
    s.submit(_req(mod, 1, priority=1))
    s.assign(0, s.next_ready(0), clock=0)
    s.assign(1, s.next_ready(0), clock=0)
    s.submit(_req(mod, 2, priority=0, arrival=4))
    trace = [s.preempt_victim(0), s.preempt_victim(1), s.preempt_victim(2)]
    victim = s.preempt(s.preempt_victim(0))
    trace += [victim.rid, s.preemptions, s.free_slots(), s.num_active]
    trace += [s.next_ready(4).rid, s.next_ready(4).rid]
    s.assign(1, victim, clock=4)
    out = s.complete(1, np.arange(8, dtype=np.int32), np.zeros(4),
                     "length", 8)
    trace += [out.preempted, out.admitted_step, out.queue_delay_steps]
    return trace + [_outs(s)]


def _reserve_cycle(mod):
    s = mod.Scheduler(num_slots=2)
    for i in range(4):
        s.submit(_req(mod, i, priority=i % 2))
    s.poll(0, 0.0)
    trace = []
    s.reserve(0, s.next_ready(0), clock=0, wall=1.0)
    trace += [s.free_slots(), s.num_active, s.num_reserved,
              s.reserved_request(0).rid, s.all_done()]
    back = s.unreserve(0)
    trace += [back.rid, s.num_reserved, s.peek_ready(1).rid]
    s.reserve(0, s.next_ready(1), clock=1, wall=2.0)
    s.activate(0)
    s.reserve(1, s.next_ready(1), clock=1, wall=2.0)
    trace += [s.num_active, s.num_reserved, s.reserved_slots()[0][0],
              [r.rid for _, r in s.reserved_slots()]]
    dropped = s.drop_reserved(1, "cancelled", 2)
    trace += [dropped.rid, s.cancels, s.free_slots()]
    drained = s.drain_unfinished()
    trace += [[r.rid for r in drained], s.all_done(), _outs(s)]
    return trace


def _streams(mod):
    kw = dict(vocab_size=64, prompt_len=4, max_new_tokens=4,
              arrival_rate=0.5, seed=9)
    out = []
    for extra in ({"poisson": True}, {"poisson": False},
                  {"poisson": True, "priorities": (0, 1, 1)}):
        for r in mod.synthetic_stream(12, **kw, **extra):
            out.append((r.rid, r.arrival_step, r.priority,
                        r.max_new_tokens, tuple(r.prompt.tolist())))
    return out


@pytest.mark.parametrize("script", [_priority, _timeout_cancel, _deadline,
                                    _preempt, _reserve_cycle, _streams],
                         ids=lambda f: f.__name__.strip("_"))
def test_scheduler_matches_reference(script):
    want = script(JS)
    assert script(TS) == want


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

def _requests(cfg, n=4, prompt_len=12, max_new=6, arrival=0.5, seed=17):
    """The same stream for both packages (tests/test_serving.py's)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        prompt = rng.randint(0, cfg.vocab_size,
                             size=(prompt_len,)).astype(np.int32)
        kw = dict(rid=i, prompt=prompt, max_new_tokens=max_new,
                  arrival_step=int(i / arrival) if arrival else 0)
        out.append((JS.Request(**kw), TS.Request(**kw)))
    return [j for j, _ in out], [t for _, t in out]


def _same_tokens(outs_a, outs_b):
    assert [o.rid for o in outs_a] == [o.rid for o in outs_b]
    for a, b in zip(outs_a, outs_b):
        np.testing.assert_array_equal(np.asarray(a.tokens),
                                      np.asarray(b.tokens))
        assert a.finish_reason == b.finish_reason


def _engines(trained_dense, max_seq=24, **kw):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = trained_dense
    jkw = dict(kw)
    if "spec" in jkw:
        jkw["spec"] = JSpecConfig(k=jkw["spec"].k)
    if "paged" in jkw:
        jkw["paged"] = JPagedConfig(page_size=jkw["paged"].page_size)
    jeng = JServeEngine(jmodel, jparams, max_seq=max_seq, autotune=False,
                        **jkw)
    teng = ServeEngine(tmodel, tparams, max_seq=max_seq, device="cpu", **kw)
    return jeng, teng


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_chunked_prefill_matches_reference_and_monolithic(trained_dense, kv):
    """Greedy serve() with a non-dividing prefill_chunk: the JAX engine's
    chunked tokens, the port's whole-prompt tokens, the same number of
    prefill chunks; chunked prefill fills a raw batch=1 cache, so int8 and
    int4 KV quantize at insert as before."""
    jeng, teng = _engines(trained_dense, kv_precision=kv)
    jreqs, treqs = _requests(trained_dense[0])
    jouts, jstats = jeng.serve(jreqs, num_slots=2, chunk=4,
                               prefill_chunk=5)
    touts, tstats = teng.serve(treqs, num_slots=2, chunk=4,
                               prefill_chunk=5)
    mono, mstats = teng.serve(treqs, num_slots=2, chunk=4)
    _same_tokens(touts, jouts)
    _same_tokens(touts, mono)
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.logprobs, np.asarray(j.logprobs),
                                   atol=1e-2 if kv != "bf16" else 1e-4)
        assert t.admitted_step == j.admitted_step
    assert tstats.prefill_chunks == jstats.prefill_chunks == 4 * 3
    assert mstats.prefill_chunks == 0
    assert tstats.decode_steps == jstats.decode_steps
    assert tstats.admissions == jstats.admissions


def test_chunked_prefill_under_spec(trained_dense):
    """Spec engines admit chunked-prefilled slots as whole-prompt ones."""
    jeng, teng = _engines(trained_dense, spec=SpecConfig(k=2))
    jreqs, treqs = _requests(trained_dense[0])
    jouts, jstats = jeng.serve(jreqs, num_slots=2, chunk=2, prefill_chunk=5)
    touts, tstats = teng.serve(treqs, num_slots=2, chunk=2, prefill_chunk=5)
    _same_tokens(touts, jouts)
    plain = ServeEngine(teng.model, teng.params, max_seq=24, device="cpu")
    _same_tokens(touts, plain.serve(treqs, num_slots=2, chunk=2)[0])
    assert tstats.prefill_chunks == jstats.prefill_chunks
    assert (tstats.spec_rounds, tstats.draft_proposed,
            tstats.draft_accepted) == (jstats.spec_rounds,
                                       jstats.draft_proposed,
                                       jstats.draft_accepted)


def test_chunked_prefill_paged_prefix_hit(trained_dense):
    """Paged, with a shared prefix: a hit seeds the task's cache from the
    pool (the suffix alone runs through the model, in chunks); tokens and
    the pool's counters equal the JAX engine's, the tokens the dense
    whole-prompt engine's; no page leaks."""
    jeng, teng = _engines(trained_dense, max_seq=32,
                          paged=PagedConfig(page_size=4))
    jreqs, treqs = _requests(trained_dense[0], n=4, prompt_len=14,
                             max_new=6, arrival=0.25)
    for r in jreqs + treqs:
        r.prompt[:9] = jreqs[0].prompt[:9]
    jouts, jstats = jeng.serve(jreqs, num_slots=2, chunk=4, prefill_chunk=3)
    touts, tstats = teng.serve(treqs, num_slots=2, chunk=4, prefill_chunk=3)
    _same_tokens(touts, jouts)
    assert tstats.prefix_hits == jstats.prefix_hits > 0
    assert tstats.prefix_hit_tokens == jstats.prefix_hit_tokens
    assert tstats.prefill_chunks == jstats.prefill_chunks
    assert tstats.cow_copies == jstats.cow_copies
    assert tstats.kv_bytes_peak == pytest.approx(jstats.kv_bytes_peak)
    dense = ServeEngine(teng.model, teng.params, max_seq=32, device="cpu")
    _same_tokens(touts, dense.serve(treqs, num_slots=2, chunk=4)[0])
    teng.pool.check_invariants()


def test_engine_level_prefill_chunk_default(trained_dense):
    """ServeEngine(prefill_chunk=...) applies when serve() passes none;
    0 is refused."""
    _, teng = _engines(trained_dense)
    _, treqs = _requests(trained_dense[0], n=2)
    ref, _ = teng.serve(treqs, num_slots=2, chunk=4)
    eng = ServeEngine(teng.model, teng.params, max_seq=24, device="cpu",
                      prefill_chunk=4)
    outs, stats = eng.serve(treqs, num_slots=2, chunk=4)
    assert stats.prefill_chunks == 2 * 3
    _same_tokens(outs, ref)
    with pytest.raises(ValueError):
        ServeEngine(teng.model, teng.params, max_seq=24, device="cpu",
                    prefill_chunk=0)


# ---------------------------------------------------------------------------
# SLO serving, held to the JAX engine
# ---------------------------------------------------------------------------

def _both(trained_dense, jreqs, treqs, max_seq=24, **serve_kw):
    jeng, teng = _engines(trained_dense, max_seq=max_seq)
    jslo = serve_kw.pop("slo", None)
    tslo = None if jslo is None else TS.SLOConfig(**dataclasses.asdict(jslo))
    jouts, jstats = jeng.serve(jreqs, slo=jslo, **serve_kw)
    touts, tstats = teng.serve(treqs, slo=tslo, **serve_kw)
    _same_tokens(touts, jouts)
    for t, j in zip(touts, jouts):
        assert (t.admitted_step, t.finished_step, t.priority, t.preempted,
                t.queue_delay_steps, len(t.logprobs)) == \
            (j.admitted_step, j.finished_step, j.priority, j.preempted,
             j.queue_delay_steps, len(j.logprobs))
    for name in ("preemptions", "timeouts", "cancelled", "decode_steps",
                 "generated_tokens", "prefill_chunks"):
        assert getattr(tstats, name) == getattr(jstats, name), name
    return teng, touts, tstats


def test_serve_priority_admission_order(trained_dense):
    """With one slot, a later priority-0 arrival is admitted ahead of
    earlier priority-1 traffic still queued."""
    jreqs, treqs = _requests(trained_dense[0], arrival=0)
    for r in (jreqs[3], treqs[3]):
        r.priority, r.arrival_step = 0, 2
    _, outs, _ = _both(trained_dense, jreqs, treqs, num_slots=1, chunk=4)
    admits = {o.rid: o.admitted_step for o in outs}
    assert admits[0] == 0 and admits[3] < min(admits[1], admits[2])


@pytest.mark.parametrize("prefill_chunk", [None, 3])
def test_serve_preemption_roundtrip(trained_dense, prefill_chunk):
    """A priority-0 arrival evicts the running priority-1 request; the
    victim prefills again from scratch and ends with the tokens of an
    uncontended run."""
    rng = np.random.RandomState(23)
    p0 = rng.randint(0, 512, size=(8,)).astype(np.int32)
    p1 = rng.randint(0, 512, size=(8,)).astype(np.int32)
    reqs = [(mod.Request(rid=0, prompt=p0, max_new_tokens=16, priority=1),
             mod.Request(rid=1, prompt=p1, max_new_tokens=4,
                         arrival_step=4, priority=0)) for mod in (JS, TS)]
    teng, outs, stats = _both(trained_dense, list(reqs[0]), list(reqs[1]),
                              max_seq=32, num_slots=1, chunk=4,
                              prefill_chunk=prefill_chunk,
                              slo=JS.SLOConfig(preempt=True))
    assert stats.preemptions == 1
    assert outs[0].preempted == 1 and outs[1].preempted == 0
    assert outs[1].admitted_step <= outs[0].admitted_step
    ref, _ = teng.serve([reqs[1][0]], num_slots=1, chunk=4)
    np.testing.assert_array_equal(outs[0].tokens, ref[0].tokens)


def test_serve_queue_timeout_drops_without_slot(trained_dense):
    jreqs, treqs = _requests(trained_dense[0], n=2, arrival=0, max_new=12)
    for r in (jreqs[1], treqs[1]):
        r.queue_timeout_steps = 4
    _, outs, stats = _both(trained_dense, jreqs, treqs, num_slots=1, chunk=4)
    assert [o.finish_reason for o in outs] == ["length", "timeout"]
    assert outs[1].admitted_step == -1 and len(outs[1].generated) == 0
    assert stats.timeouts == 1


def test_serve_cancel_running_keeps_partial_tokens(trained_dense):
    jreqs, treqs = _requests(trained_dense[0], n=1, arrival=0, max_new=24)
    for r in (jreqs[0], treqs[0]):
        r.cancel_at_step = 8
    teng, outs, stats = _both(trained_dense, jreqs, treqs, max_seq=40,
                              num_slots=1, chunk=4)
    assert outs[0].finish_reason == "cancelled" and stats.cancelled == 1
    assert 0 < len(outs[0].generated) < 24
    assert len(outs[0].logprobs) == len(outs[0].generated)
    ref, _ = teng.serve([dataclasses.replace(treqs[0], cancel_at_step=None)],
                        num_slots=1, chunk=4)
    n = len(outs[0].tokens)
    np.testing.assert_array_equal(outs[0].tokens, ref[0].tokens[:n])


def test_serve_deadline_applies_while_running(trained_dense):
    jreqs, treqs = _requests(trained_dense[0], n=2, arrival=0, max_new=24)
    for r in (jreqs[0], treqs[0]):
        r.deadline_steps = 8
    for r in (jreqs[1], treqs[1]):
        r.deadline_steps = 4           # dies in the queue
    _, outs, _ = _both(trained_dense, jreqs, treqs, max_seq=40, num_slots=1,
                       chunk=4)
    assert [o.finish_reason for o in outs] == ["deadline", "deadline"]
    assert 0 < len(outs[0].generated) < 24 and len(outs[1].generated) == 0


def test_queue_delay_reported_apart_from_ttft(trained_dense):
    """A request that waits for a slot reports queue delay; TTFT starts at
    dequeue."""
    jreqs, treqs = _requests(trained_dense[0], n=3, arrival=0, max_new=8)
    _, outs, stats = _both(trained_dense, jreqs, treqs, num_slots=1,
                           chunk=4)
    assert outs[0].queue_delay_steps == 0
    assert all(o.queue_delay_steps > 0 for o in outs[1:])
    assert all(o.queue_delay_s is not None and o.ttft_s is not None
               for o in outs)
    assert stats.queue_delay_p95_s >= stats.queue_delay_p50_s >= 0.0
    assert stats.ttft_p95_s >= stats.ttft_p50_s > 0.0
    assert stats.decode_gap_max_s >= stats.decode_gap_p95_s \
        >= stats.decode_gap_p50_s > 0.0


def test_tpot_gate_defers_admission(trained_dense):
    """With a TPOT target no chunk can meet, new priority-1 work waits for
    the running slots to drain (the gate never starves an idle engine), and
    priority 0 is never gated; the same admissions as the JAX engine's."""
    jreqs, treqs = _requests(trained_dense[0], n=3, arrival=0, max_new=8)
    for r in (jreqs[1], treqs[1], jreqs[2], treqs[2]):
        r.arrival_step = 4
    for r in (jreqs[2], treqs[2]):
        r.priority = 0
    teng, outs, _ = _both(trained_dense, jreqs, treqs, num_slots=3, chunk=4,
                          slo=JS.SLOConfig(tpot_target_s=1e-9))
    admits = {o.rid: o.admitted_step for o in outs}
    assert admits[0] == 0 and admits[2] == 4     # idle engine; priority 0
    assert admits[1] > 4                         # gated until a drain
    ref, _ = teng.serve(treqs, num_slots=3, chunk=4)
    _same_tokens(outs, ref)


def test_abort_leaks_no_page(trained_dense):
    """``abort`` mid-serve, with a chunked prefill in flight (holding a
    pinned prefix match) and slots decoding, returns every unfinished
    request and leaves the pool's refcounts whole."""
    _, teng = _engines(trained_dense, max_seq=32,
                       paged=PagedConfig(page_size=4))
    _, treqs = _requests(trained_dense[0], n=4, prompt_len=14, max_new=8,
                         arrival=0.5)
    for r in treqs:
        r.prompt[:9] = treqs[0].prompt[:9]
    sess = ServeSession(teng, treqs, num_slots=3, chunk=2, prefill_chunk=2)
    for _ in range(20):    # until rid 1 (a prefix hit) prefills beside rid 0
        sess.dispatch()
        sess.harvest()
        if sess.tasks and sess.sched.num_active:
            break
    assert sess.sched.num_active == 1 and list(sess.tasks) == [1]
    assert sess.tasks[1].match.hit > 0 and not sess.tasks[1].done
    assert teng.pool.pages_in_use > 0
    survivors = sess.abort()
    assert sorted([r.rid for r in survivors]
                  + [o.rid for o in sess.sched.finished]) == [0, 1, 2, 3]
    assert {0, 1} <= {r.rid for r in survivors}
    teng.pool.check_invariants()
    assert all(not teng.pool._slot_pages.get(s) for s in range(3))
    assert not bool(sess.state.active.any())
