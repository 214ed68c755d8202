"""Replica serving and failover of the port (``serving/replica.py``)
against the JAX package's ``ReplicaServe``, on the dense SMOKE model
trained as tests/test_torch_session.py trains it (f32), two replica
engines over one set of weights, each with its own pool of pages of 8:

* ``route`` equal to the reference's (load-aware, ties to replica 0);
* a fault-free serve, a replica killed mid-stream (``replica_fault``) with
  its requests re-driven, two transient dispatch faults retried in place,
  the retry budget deciding a quarantine (0, 1 and 2 retries), the
  failover budget spent ("replica failover exhausted", also by one kill
  at ``max_restarts=0``) and a fault propagating without failover: greedy tokens, restarts, re-driven
  requests, assignments and injector logs equal to the JAX serve's, every
  pool clean afterwards;
* a saturated Poisson stream under ``replica_fault,oom,stall`` with
  degradation armed: no request and no page lost, counts equal to JAX's;
* the watchdog counting a stalled tick (the port's decode gap starts
  before the chaos sites, so the stall falls inside it);
* ``_sum_tiers`` on ragged histograms.

Replica i's session takes seed + i in the port and a folded JAX key in
the reference, so only greedy serves are compared.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig
from repro.configs.registry import get_config as jget_config
from repro.serving import chaos as jchaos
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.pool import PagedConfig as JPagedConfig
from repro.serving.replica import FailoverConfig as JFailoverConfig
from repro.serving.replica import ReplicaServe as JReplicaServe
from repro.serving.replica import _sum_tiers as j_sum_tiers
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import synthetic_stream as jstream
from repro.serving.session import DegradeConfig as JDegradeConfig
from repro.train.loop import train
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.models.model import build
from repro_torch.serving import chaos as tchaos
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.pool import PagedConfig
from repro_torch.serving.replica import (FailoverConfig, ReplicaServe,
                                         _sum_tiers)
from repro_torch.serving.scheduler import Request
from repro_torch.serving.session import DegradeConfig

torch.set_num_threads(2)

MAX_SEQ = 18
PAGES = dict(page_size=8, pool_pages=6)


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


def _pair(jreqs):
    return jreqs, [Request(rid=r.rid, prompt=np.asarray(r.prompt),
                           max_new_tokens=r.max_new_tokens,
                           arrival_step=r.arrival_step) for r in jreqs]


def _requests(vocab, n=6, prompt_len=8, max_new=8, arrival_every=2):
    rng = np.random.RandomState(10)
    return _pair([JRequest(rid=i, prompt=rng.randint(
        0, vocab, size=(prompt_len,)).astype(np.int32),
        max_new_tokens=max_new, arrival_step=i * arrival_every)
        for i in range(n)])


def _replicas(trained, max_seq=MAX_SEQ, n=2):
    _, jmodel, jparams, _, tmodel, tparams = trained
    return (JReplicaServe([JServeEngine(jmodel, jparams, max_seq=max_seq,
                                        paged=JPagedConfig(**PAGES))
                           for _ in range(n)]),
            ReplicaServe([ServeEngine(tmodel, tparams, max_seq=max_seq,
                                      paged=PagedConfig(**PAGES),
                                      device="cpu") for _ in range(n)]))


def _assert_tokens_equal(touts, jouts):
    assert [o.rid for o in touts] == [o.rid for o in jouts]
    for t, j in zip(touts, jouts):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        assert t.finish_reason == j.finish_reason


def _assert_pool_clean(engine):
    pool = engine.pool
    pool.check_invariants()
    assert pool.pages_in_use == (pool.prefix.evictable(pool._ref)
                                 if pool.prefix is not None else 0)


def _serve_both(trained, jreqs, treqs, chaos_spec, failover=None,
                degrade=None, max_seq=MAX_SEQ, rules=None, **kw):
    """Both packages' replica serves under one fault schedule: the
    shorthands of ``chaos_spec``, or ``rules`` (FaultRule keywords);
    ``failover`` holds FailoverConfig keywords (default: its defaults)."""
    jrs, trs = _replicas(trained, max_seq=max_seq)
    failover = {} if failover is None else failover
    jkw = dict(kw, failover=JFailoverConfig(**failover),
               degrade=JDegradeConfig(**degrade) if degrade is not None
               else None)
    tkw = dict(kw, failover=FailoverConfig(**failover),
               degrade=DegradeConfig(**degrade) if degrade is not None
               else None)
    if rules is None:
        jcfg = jchaos.FaultConfig.parse(chaos_spec)
        tcfg = tchaos.FaultConfig.parse(chaos_spec)
    else:
        jcfg = jchaos.FaultConfig(rules=tuple(
            jchaos.FaultRule(**r) for r in rules))
        tcfg = tchaos.FaultConfig(rules=tuple(
            tchaos.FaultRule(**r) for r in rules))
    with jchaos.chaos(jcfg) as jinj:
        jouts, jst = jrs.serve(jreqs, **jkw)
    with tchaos.chaos(tcfg) as tinj:
        touts, tst = trs.serve(treqs, **tkw)
    assert tinj.log == jinj.log
    _assert_tokens_equal(touts, jouts)
    ta, ja = tst.aggregate, jst.aggregate
    assert tst.assignments == jst.assignments
    for f in ("replica_restarts", "redriven_requests", "decode_steps",
              "generated_tokens", "degrade_transitions", "degraded_steps",
              "kv_tier_steps"):
        assert getattr(ta, f) == getattr(ja, f), f
    for eng in trs.engines:
        _assert_pool_clean(eng)
    return touts, tst


def test_route_matches_reference(trained_dense):
    cfg = trained_dense[0]
    rng = np.random.RandomState(2)
    jreqs, treqs = _pair([JRequest(
        rid=i, prompt=np.zeros(int(rng.randint(2, 12)), np.int32),
        max_new_tokens=int(rng.randint(1, 9)),
        arrival_step=int(rng.randint(0, 5))) for i in range(23)])
    for n in (1, 2, 3):
        jrs, trs = _replicas(trained_dense, n=n)
        jb, tb = jrs.route(jreqs), trs.route(treqs)
        assert [[r.rid for r in b] for b in tb] == \
            [[r.rid for r in b] for b in jb]
    with pytest.raises(ValueError, match="at least one engine"):
        ReplicaServe([])
    assert cfg.vocab_size > 0


def test_fault_free_serve_matches_reference(trained_dense):
    jreqs, treqs = _requests(trained_dense[0].vocab_size)
    touts, st = _serve_both(trained_dense, jreqs, treqs, "", num_slots=2,
                            chunk=4)
    assert st.replicas == 2 and st.aggregate.replica_restarts == 0
    assert len(touts) == len(treqs)


def test_replica_kill_redrives_like_reference(trained_dense):
    jreqs, treqs = _requests(trained_dense[0].vocab_size)
    base, _ = _serve_both(trained_dense, jreqs, treqs, "", num_slots=2,
                          chunk=4)
    touts, st = _serve_both(trained_dense, jreqs, treqs, "replica_fault",
                            num_slots=2, chunk=4)
    agg = st.aggregate
    assert agg.replica_restarts == 1 and agg.redriven_requests > 0
    assert agg.recovery_p95_s > 0.0
    for a, b in zip(touts, base):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_transient_faults_retry_in_place_like_reference(trained_dense):
    jreqs, treqs = _requests(trained_dense[0].vocab_size)
    _, st = _serve_both(trained_dense, jreqs, treqs, "replica_transient",
                        num_slots=2, chunk=4)
    assert st.aggregate.replica_restarts == 0


@pytest.mark.parametrize("retries,restarts", [(0, 1), (1, 1), (2, 0)])
def test_retry_budget_decides_a_quarantine_like_reference(
        trained_dense, retries, restarts):
    """Two transient faults in a row on replica 0's dispatch: a tick that
    may retry twice rides them out; with fewer retries the second (or
    the first) quarantines the replica and its requests re-drive."""
    jreqs, treqs = _requests(trained_dense[0].vocab_size)
    rules = [dict(site="replica.dispatch", tag=0, at=(2, 3), count=2,
                  transient=True)]
    _, st = _serve_both(trained_dense, jreqs, treqs, None, rules=rules,
                        failover=dict(retries=retries), num_slots=2,
                        chunk=4)
    assert st.aggregate.replica_restarts == restarts
    assert (st.aggregate.redriven_requests > 0) == (restarts > 0)


def test_restart_budget_of_zero_is_spent_by_one_kill_like_reference(
        trained_dense):
    """``max_restarts=0`` with a live survivor: one killed replica already
    exhausts the failover, in both packages, leaving no page held."""
    jreqs, treqs = _requests(trained_dense[0].vocab_size, n=4)
    jrs, trs = _replicas(trained_dense)
    with jchaos.chaos(jchaos.FaultConfig.parse("replica_fault")) as jinj:
        with pytest.raises(RuntimeError, match="failover exhausted") as je:
            jrs.serve(jreqs, num_slots=2, chunk=4,
                      failover=JFailoverConfig(max_restarts=0))
    with tchaos.chaos(tchaos.FaultConfig.parse("replica_fault")) as tinj:
        with pytest.raises(RuntimeError, match="failover exhausted") as te:
            trs.serve(treqs, num_slots=2, chunk=4,
                      failover=FailoverConfig(max_restarts=0))
    assert str(te.value) == str(je.value) and "budget 0" in str(te.value)
    assert tinj.log == jinj.log
    for eng in trs.engines:
        _assert_pool_clean(eng)


def test_failover_exhausted_like_reference(trained_dense):
    jreqs, treqs = _requests(trained_dense[0].vocab_size, n=4)
    jrs, trs = _replicas(trained_dense)
    rules = [dict(site="replica.dispatch", tag=0, at=(1,)),
             dict(site="replica.dispatch", tag=1, at=(1,))]
    with jchaos.chaos(jchaos.FaultConfig(rules=tuple(
            jchaos.FaultRule(**r) for r in rules))) as jinj:
        with pytest.raises(RuntimeError, match="failover exhausted") as je:
            jrs.serve(jreqs, num_slots=2, chunk=4,
                      failover=JFailoverConfig())
    with tchaos.chaos(tchaos.FaultConfig(rules=tuple(
            tchaos.FaultRule(**r) for r in rules))) as tinj:
        with pytest.raises(RuntimeError, match="failover exhausted") as te:
            trs.serve(treqs, num_slots=2, chunk=4,
                      failover=FailoverConfig())
    assert str(te.value) == str(je.value)
    assert tinj.log == jinj.log
    for eng in trs.engines:
        _assert_pool_clean(eng)


def test_without_failover_the_fault_propagates_like_reference(trained_dense):
    jreqs, treqs = _requests(trained_dense[0].vocab_size, n=4)
    jrs, trs = _replicas(trained_dense)
    with jchaos.chaos(jchaos.FaultConfig.parse("replica_fault")) as jinj:
        with pytest.raises(jchaos.InjectedFault) as je:
            jrs.serve(jreqs, num_slots=2, chunk=4)
    with tchaos.chaos(tchaos.FaultConfig.parse("replica_fault")) as tinj:
        with pytest.raises(tchaos.InjectedFault) as te:
            trs.serve(treqs, num_slots=2, chunk=4)
    assert str(te.value) == str(je.value)
    assert tinj.log == jinj.log
    for eng in trs.engines:               # the port aborts leak-free
        _assert_pool_clean(eng)


def test_saturated_poisson_under_faults_loses_nothing(trained_dense):
    """A replica killed, admissions denied and a tick stalled under a
    Poisson stream that saturates both replicas, with degradation armed:
    every request completes once and every page is accounted for."""
    cfg = trained_dense[0]
    jreqs, treqs = _pair(jstream(12, vocab_size=cfg.vocab_size,
                                 prompt_len=8, max_new_tokens=8,
                                 arrival_rate=2.0, poisson=True))
    max_seq = max(len(r.prompt) + r.max_new_tokens for r in jreqs)
    touts, st = _serve_both(trained_dense, jreqs, treqs,
                            "replica_fault,oom,stall", degrade={},
                            max_seq=max_seq, num_slots=2, chunk=4)
    assert [o.rid for o in touts] == sorted(r.rid for r in treqs)
    agg = st.aggregate
    assert agg.replica_restarts == 1 and agg.redriven_requests > 0
    assert sum(agg.kv_tier_steps[1:]) > 0


def test_watchdog_counts_a_stalled_tick(trained_dense):
    _, treqs = _requests(trained_dense[0].vocab_size)
    _, trs = _replicas(trained_dense)
    base, _ = trs.serve(treqs, num_slots=2, chunk=4)
    rule = tchaos.FaultRule(site="device.stall", tag=1, at=(2,),
                            mode="stall", stall_s=0.5)
    with tchaos.chaos(tchaos.FaultConfig(rules=(rule,))) as inj:
        outs, st = trs.serve(treqs, num_slots=2, chunk=4,
                             failover=FailoverConfig(watchdog_s=0.4))
    assert inj.log == [("device.stall", 1, 2)]
    # replica 1 stalls in its own tick; replica 0's harvest of the same
    # round waits behind that dispatch, so its gap may overrun too
    assert st.per_replica[1].watchdog_trips == 1
    assert st.per_replica[0].watchdog_trips <= 1
    assert st.aggregate.watchdog_trips == sum(
        r.watchdog_trips for r in st.per_replica)
    assert st.aggregate.decode_gap_max_s > 0.5
    for a, b in zip(outs, base):
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("tiers", [[(4, 2), (1,), ()], [], [(3,)],
                                   [(0, 0, 5), (1, 2)]])
def test_sum_tiers_on_ragged_histograms(tiers):
    assert _sum_tiers(tiers) == j_sum_tiers(tiers)
    if tiers == [(4, 2), (1,), ()]:
        assert _sum_tiers(tiers) == (5, 2)
