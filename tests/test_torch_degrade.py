"""Graceful degradation of the port (the entropy-ordered KV tier ladder and
the live repack of a paged pool) against the JAX package, on the dense
SMOKE model trained as tests/test_torch_session.py trains it (f32):

* ``degrade_kv_ladder`` and ``kv_tier_labels`` equal to JAX's for the
  dense, MoE, enc-dec and hybrid SMOKE configs, with and without a plan,
  and in the FastEWQ spill order of a classifier trained alike in both
  packages, at every base KV policy, with and without segment cuts;
* ``repack_pool_field`` equal to the bit (payloads, scales, tables) on
  int8 -> int4, bf16 -> int8 and int4 -> int8, growth and compaction,
  pools of several runs;
* ``apply_kv_plan`` on a live engine: the pool's refcounts, free list,
  slot maps, prefix cache and page tables equal to the JAX engine's, each
  transition started from the same pool bits, the scales within one bf16
  step and each payload element within one step of its own row's scale
  on the current tier, and a promotion refused when the live pages do
  not fit;
* serves under the ``oom`` fault with ``DegradeConfig()``: tokens,
  transitions, tier steps and degraded steps equal to the JAX engine's,
  log-probs within 1e-3 (the int8 / int4 KV serves' limit), a mixed
  int4 / int8 tier, the promotion back to tier 0, a chunked prefill
  reserved before a spill and inserted after it, and a spec engine that
  runs plain chunks while degraded;
* the unpaged engine ignoring ``degrade``, the admission deadlock still
  raising when the ladder is spent, a failed degraded serve leaving the
  engine at tier 0 for its next serve, and a transition dropping the
  captured decode chunks (a stub graph counts the captures).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig
from repro.configs.registry import get_config as jget_config
from repro.core import fastewq as JF
from repro.core.dataset import BlockRow as JBlockRow
from repro.quant import compiler as JC
from repro.quant import paged as JPG
from repro.quant.kvcache import PagedKV as JPagedKV
from repro.quant.kvcache import dequantize_kv as jdequantize_kv
from repro.serving import chaos as jchaos
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.pool import PagedConfig as JPagedConfig
from repro.serving.quantized import explicit_plan as jexplicit_plan
from repro.serving.scheduler import Request as JRequest
from repro.serving.session import DegradeConfig as JDegradeConfig
from repro.serving.session import ServeSession as JServeSession
from repro.serving.spec import SpecConfig as JSpecConfig
from repro.train.loop import train
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.core import fastewq as TF
from repro_torch.core.dataset import BlockRow as TBlockRow
from repro_torch.models.model import build
from repro_torch.quant import compiler as TC
from repro_torch.quant import paged as TPG
from repro_torch.quant.kvcache import PagedKV, dequantize_kv, quantize_kv
from repro_torch.serving import chaos as tchaos
from repro_torch.serving import graphs as G
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.pool import OutOfPages, PagedConfig
from repro_torch.serving.quantized import explicit_plan
from repro_torch.serving.scheduler import Request
from repro_torch.serving.session import DegradeConfig, ServeSession
from repro_torch.serving.spec import SpecConfig

torch.set_num_threads(2)

MAX_SEQ = 18
PAGES = dict(page_size=8, pool_pages=6)
LP_TOL = 1e-3          # int8 / int4 KV serves (tests/test_torch_moe_serve.py)


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


def _requests(vocab, n=6, prompt_len=8, max_new=8, arrival_every=2,
              seed=10):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, vocab, size=(prompt_len,)).astype(np.int32)
               for _ in range(n)]
    return ([JRequest(rid=i, prompt=p, max_new_tokens=max_new,
                      arrival_step=i * arrival_every)
             for i, p in enumerate(prompts)],
            [Request(rid=i, prompt=p, max_new_tokens=max_new,
                     arrival_step=i * arrival_every)
             for i, p in enumerate(prompts)])


def _engines(trained, *, plan_layers=None, kv="bf16", paged=PAGES,
             max_seq=MAX_SEQ, **kw):
    """The JAX engine and the port's on the same trained weights, plan
    and pool."""
    cfg, jmodel, jparams, tcfg, tmodel, tparams = trained
    jplan = tplan = None
    if plan_layers is not None:
        jplan = jexplicit_plan(cfg, plan_layers)
        tplan = explicit_plan(tcfg, plan_layers)
    jspec = kw.pop("spec", None)
    jeng = JServeEngine(jmodel, jparams, max_seq=max_seq, plan=jplan,
                        kv_precision=kv,
                        paged=JPagedConfig(**paged) if paged else None,
                        spec=JSpecConfig(**jspec) if jspec else None, **kw)
    teng = ServeEngine(tmodel, tparams, max_seq=max_seq, plan=tplan,
                       kv_precision=kv,
                       paged=PagedConfig(**paged) if paged else None,
                       spec=SpecConfig(**jspec) if jspec else None,
                       device="cpu", **kw)
    return jeng, teng


def _ladder_key(ladder):
    return [None if kv is None else (kv.precisions, kv.group)
            for kv in ladder]


def _assert_pool_clean(engine):
    pool = engine.pool
    pool.check_invariants()
    assert pool.pages_in_use == (pool.prefix.evictable(pool._ref)
                                 if pool.prefix is not None else 0)


def _assert_same_serve(jouts, touts, exact_lps=False):
    assert [o.rid for o in touts] == [o.rid for o in jouts]
    for j, t in zip(jouts, touts):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        assert t.finish_reason == j.finish_reason
        tol = 0.0 if exact_lps else LP_TOL
        np.testing.assert_allclose(t.logprobs, np.asarray(j.logprobs),
                                   rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------

FAMILIES = [("dense", "llama3.2-3b"), ("moe", "grok-1-314b"),
            ("encdec", "whisper-medium"), ("hybrid", "zamba2-2.7b")]


@pytest.mark.parametrize("family,arch", FAMILIES)
def test_ladder_and_labels_match_reference(family, arch):
    jcfg, tcfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    n = jcfg.num_layers + (jcfg.num_encoder_layers or 0)
    layer_sets = [None, ["int4", "raw"] * n, ["raw"] * n, ["int8"] * n,
                  (["raw", "int8", "int4", "int4"] * n)[:n]]
    n_kv = JC.kv_cache_layers(jcfg)
    assert TC.kv_cache_layers(tcfg) == n_kv
    cut_sets = [(), tuple(range(1, n_kv)), (n_kv // 2,)]
    seen = 0
    for layers in layer_sets:
        jplan = None if layers is None else jexplicit_plan(jcfg, layers[:n])
        tplan = None if layers is None else explicit_plan(tcfg, layers[:n])
        for kv in ("bf16", "int8", "int4", "auto"):
            if kv == "auto" and jplan is None:
                continue
            jbase = JC.compile_kv_plan(jcfg, jplan, kv)
            tbase = TC.compile_kv_plan(tcfg, tplan, kv)
            for cuts in cut_sets:
                for group in (32, 64):
                    jl = JC.degrade_kv_ladder(jcfg, jplan, jbase, group,
                                              cuts=cuts)
                    tl = TC.degrade_kv_ladder(tcfg, tplan, tbase, group,
                                              cuts=cuts)
                    assert _ladder_key(tl) == _ladder_key(jl), (layers, kv,
                                                                cuts)
                    assert TC.kv_tier_labels(tl) == JC.kv_tier_labels(jl)
                    seen += len(tl)
    assert seen > 0


def _fastewq_pair():
    """A FastEWQ classifier in each package, trained on the same seeded
    rows (paper-like: later and larger blocks quantize more often)."""
    rng = np.random.default_rng(0)
    rows = []
    for m in range(10):
        nb = int(rng.integers(6, 30))
        base = rng.uniform(3e7, 5e8)
        for i in range(nb):
            q = int(rng.random() < 0.05 + 0.9 * i / nb)
            rows.append((f"m{m}", nb, i + 1, int(base * rng.uniform(0.8, 1.2)),
                         "8-bit" if q else "raw", q))
    return (JF.train_fastewq([JBlockRow(*r) for r in rows]),
            TF.train_fastewq([TBlockRow(*r) for r in rows]))


def test_fastewq_ladder_matches_reference():
    """The FastEWQ spill order: the classifier orders the KV layers from
    their sizes alone, and the first half spills first. Ladders and labels
    equal to JAX's for every family with a cache, at every base KV policy,
    with no cut, one cut and two cuts; one size per KV layer, and a list
    that also leads with the embedding block (whose order the ladder reads
    shifted by one, as the reference does). mamba2 has no cache."""
    jfq, tfq = _fastewq_pair()
    seen, moved = set(), 0
    for family, arch in FAMILIES:
        jcfg, tcfg = (dataclasses.replace(c, num_layers=4 * (
            c.shared_attn_period if family == "hybrid" else 2))
            for c in (jget_config(arch, smoke=True),
                      get_config(arch, smoke=True)))
        n = TC.kv_cache_layers(tcfg)
        assert n == JC.kv_cache_layers(jcfg) == (4 if family == "hybrid"
                                                 else 8)
        sizes = [int(3e7 * (1 + (7 * i) % 5)) for i in range(n)]
        for block_sizes in (sizes, [int(4e8)] + sizes):
            for kv in ("bf16", "int8", "int4"):
                jbase = JC.compile_kv_plan(jcfg, None, kv)
                tbase = TC.compile_kv_plan(tcfg, None, kv)
                for cuts in ((), (n // 2,), (1, n - 1)):
                    jl = JC.degrade_kv_ladder(jcfg, None, jbase, fastewq=jfq,
                                              block_sizes=block_sizes,
                                              cuts=cuts)
                    tl = TC.degrade_kv_ladder(tcfg, None, tbase, fastewq=tfq,
                                              block_sizes=block_sizes,
                                              cuts=cuts)
                    assert _ladder_key(tl) == _ladder_key(jl), (arch, kv, cuts)
                    assert TC.kv_tier_labels(tl) == JC.kv_tier_labels(jl)
                    assert tl[-1].precisions == ("int4",) * n
                    seen.add(tuple(map(str, TC.kv_tier_labels(tl))))
                    # the classifier's order, not the deeper-half default
                    unordered = TC.degrade_kv_ladder(tcfg, None, tbase,
                                                     cuts=cuts)
                    moved += _ladder_key(tl) != _ladder_key(unordered)
    assert ("bf16", "mixed", "mixed", "int4") in seen
    assert moved > 0
    assert TC.degrade_kv_ladder(get_config("mamba2-780m", smoke=True),
                                None, None, fastewq=tfq,
                                block_sizes=[1, 2]) == []
    assert TC.degrade_kv_ladder(get_config("mamba2-780m", smoke=True),
                                None, None) == []


# ---------------------------------------------------------------------------
# the repack, to the bit
# ---------------------------------------------------------------------------

def _pool_pair(runs, *, n_phys, slots, n_log, hkv=2, hd=8, group=8,
               page=4, raw=torch.float32, seed=0):
    """One paged field in both packages: each run's pages hold seeded
    random rows quantized at the run's precision, tables map each slot's
    logical pages to distinct live pages (0 past a slot's allocation)."""
    rng = np.random.RandomState(seed)
    live = rng.permutation(np.arange(1, n_phys))[:slots * n_log]
    table = np.zeros((slots, n_log), np.int32)
    for s in range(slots):
        k = rng.randint(1, n_log + 1)
        table[s, :k] = live[s * n_log:s * n_log + k]
    tpools, jpools = [], []
    for precision, lo, hi in runs:
        ll = hi - lo
        x = torch.from_numpy(rng.standard_normal(
            (ll, n_phys, page, hkv, hd)).astype(np.float32)).to(raw)
        if precision == "bf16":
            data, scale = x, None
        else:
            data, scale = quantize_kv(x, precision, group)
        tab = torch.from_numpy(np.broadcast_to(
            table, (ll,) + table.shape).copy())
        tpools.append(PagedKV(data=data, scale=scale, table=tab,
                              precision=precision, head_dim=hd, group=group,
                              page_size=page))
        jpools.append(JPagedKV(
            data=(jnp.asarray(data.float().numpy()).astype(
                jnp.float32 if raw == torch.float32 else jnp.bfloat16)
                if precision == "bf16" else jnp.asarray(data.numpy())),
            scale=(None if scale is None
                   else jnp.asarray(scale.float().numpy()).astype(
                       jnp.bfloat16)),
            table=jnp.asarray(tab.numpy()), precision=precision,
            head_dim=hd, group=group, page_size=page))
    one = lambda p: tuple(p) if len(p) > 1 else p[0]     # noqa: E731
    return one(tpools), one(jpools), table


def _as_np(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _perm_inv(table, n_old, n_new, grow):
    live = sorted(set(int(p) for p in table.reshape(-1) if p))
    perm = np.zeros(n_old + 1, np.int32)
    perm[live] = live if grow else np.arange(1, len(live) + 1)
    inv = np.zeros(n_new + 1, np.int32)
    inv[perm[live]] = live
    return perm, inv


REPACKS = [
    # (old runs, new runs, grow)
    ([("int8", 0, 2)], [("int4", 0, 1), ("int8", 1, 2)], True),
    ([("int8", 0, 1), ("int8", 1, 3)], [("int4", 0, 3)], True),
    ([("bf16", 0, 2)], [("int8", 0, 2)], True),
    ([("bf16", 0, 1), ("bf16", 1, 2)], [("int8", 0, 1), ("int4", 1, 2)],
     True),
    ([("int4", 0, 2)], [("int8", 0, 2)], False),
    ([("int4", 0, 1), ("int8", 1, 3)], [("int8", 0, 3)], False),
    ([("int4", 0, 3)], [("int8", 0, 2), ("bf16", 2, 3)], False),
]


@pytest.mark.parametrize("raw", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(REPACKS)))
def test_repack_pool_field_matches_reference_bits(case, raw):
    old_runs, new_runs, grow = REPACKS[case]
    n_old = 12
    tfield, jfield, table = _pool_pair(old_runs, n_phys=n_old + 1, slots=3,
                                       n_log=3, raw=raw, seed=case)
    n_new = 20 if grow else 9
    perm, inv = _perm_inv(table, n_old, n_new, grow)
    jraw = jnp.float32 if raw == torch.float32 else jnp.bfloat16
    want = JPG.repack_pool_field(jfield, new_runs, perm=perm, inv=inv,
                                 group=8, raw_dtype=jraw)
    got = TPG.repack_pool_field(tfield, new_runs, perm=perm, inv=inv,
                                group=8, raw_dtype=raw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == len(new_runs)
    for g, w in zip(got, want):
        assert g.precision == w.precision and g.page_size == w.page_size
        assert g.head_dim == w.head_dim and g.group == w.group
        assert g.num_pages == n_new + 1
        for a, b in ((g.data, w.data), (g.scale, w.scale),
                     (g.table, w.table)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(_as_np(a), _as_np(b))
    # the input pool is left as it was
    again = TPG.repack_pool_field(tfield, new_runs, perm=perm, inv=inv,
                                  group=8, raw_dtype=raw)
    for g, a in zip(got, again if isinstance(again, tuple) else (again,)):
        assert torch.equal(g.data, a.data)


# ---------------------------------------------------------------------------
# apply_kv_plan on a live engine
# ---------------------------------------------------------------------------

def _admit_some(jeng, teng, jreqs, treqs, num_slots=2):
    """Both engines: a fresh state with the first ``num_slots`` requests
    admitted and one decode chunk run."""
    jstate = jeng.init_decode_state(num_slots)
    tstate = teng.init_decode_state(num_slots)
    for slot in range(num_slots):
        jstate = jeng.insert(jstate, slot,
                             jeng.prefill_request(jreqs[slot].prompt,
                                                  state=jstate), 8)
        teng.insert(tstate, slot, teng.prefill_request(treqs[slot].prompt,
                                                       tstate), 8)
    jstate = jeng._chunk_fn(2)(jeng.params, jstate)
    teng.decode_chunk(tstate, 2)
    return jstate, tstate


def _fields(cache, name):
    f = getattr(cache, name)
    return f if isinstance(f, tuple) else (f,)


def _sync_payloads(teng, jstate, tstate):
    """Copy the JAX pool's payload and scale bits into the port's pool, so
    a transition starts from the same bits in both packages: their f32
    K/V rows differ in the last bits, and so their quantized rows by a
    step where a value sits on a rounding edge, which a later tier would
    carry on as a step of its own."""
    for name in teng._paged_fields:
        for t, j in zip(_fields(tstate.cache, name),
                        _fields(jstate.cache, name)):
            for dst, src in ((t.data, j.data), (t.scale, j.scale)):
                if dst is not None:
                    dst.copy_(torch.from_numpy(
                        np.array(_as_np(src))).to(dst.dtype))


def _bf16_ulp(x):
    """One bf16 step at each |x| (0 at 0)."""
    _, e = np.frexp(np.abs(x))
    return np.where(x == 0, 0.0, np.ldexp(1.0, e - 8))


def _assert_same_pool(jeng, teng, jstate, tstate):
    """The host allocators and the page tables equal; each scale within
    one bf16 step of the JAX engine's, and each payload element within one
    step of its own row's scale on the current tier (the larger of the two
    packages' scales of its group).

    Bit equality of the payloads is held by the repack tests above: the
    JAX engine runs its repack and page writes under jit, where XLA divides
    by the constant qmax through its reciprocal, so a scale on that
    rounding edge lands one bf16 step away (and may move a value across a
    rounding edge of its own)."""
    jp, tp = jeng.pool, teng.pool
    assert tp.num_pages == jp.num_pages
    np.testing.assert_array_equal(tp._ref, jp._ref)
    assert tp._free == jp._free
    assert tp._slot_pages == jp._slot_pages
    if jp.prefix is not None:
        assert list(tp.prefix._lru.items()) == list(jp.prefix._lru.items())
    assert teng._page_bytes == jeng._page_bytes
    for name in teng._paged_fields:
        tf = _fields(tstate.cache, name)
        jf = _fields(jstate.cache, name)
        assert [p.precision for p in tf] == [p.precision for p in jf]
        for t, j in zip(tf, jf):
            np.testing.assert_array_equal(_as_np(t.table), _as_np(j.table))
            assert (t.scale is None) == (j.scale is None)
            got = dequantize_kv(t, torch.float32).numpy()
            want = np.asarray(jdequantize_kv(j, jnp.float32))
            step = np.zeros_like(want)
            if j.scale is not None:
                ts, js = _as_np(t.scale), _as_np(j.scale)
                assert np.all(np.abs(ts - js)
                              <= np.maximum(_bf16_ulp(ts), _bf16_ulp(js)))
                s = np.maximum(np.abs(ts), np.abs(js))
                step = np.repeat(s, t.group, axis=-1).reshape(want.shape)
            # the dump page, page 0, holds the idle slots' garbage
            assert np.all(np.abs(got - want)[:, 1:]
                          <= 1.001 * step[:, 1:] + 1e-5)


@pytest.mark.parametrize("kv,layers", [("bf16", None),
                                       ("int8", ["int4", "raw"])])
def test_apply_kv_plan_matches_reference_pool(trained_dense, kv, layers):
    cfg = trained_dense[0]
    jeng, teng = _engines(trained_dense, plan_layers=layers, kv=kv,
                          paged=dict(page_size=8, pool_pages=8))
    jreqs, treqs = _requests(cfg.vocab_size, n=2)
    jstate, tstate = _admit_some(jeng, teng, jreqs, treqs)
    jl, tl = jeng.degrade_ladder(), teng.degrade_ladder()
    assert _ladder_key(tl) == _ladder_key(jl) and len(tl) >= 2
    _assert_same_pool(jeng, teng, jstate, tstate)
    for tier in list(range(1, len(tl))) + [0]:      # spill, spill, promote
        _sync_payloads(teng, jstate, tstate)
        jstate = jeng.apply_kv_plan(jstate, jl[tier])
        new = teng.apply_kv_plan(tstate, tl[tier])
        assert (new is None) == (jstate is None)
        assert new is not tstate
        tstate = new
        assert teng.kv_plan is tl[tier]
        _assert_same_pool(jeng, teng, jstate, tstate)
        jstate = jeng._chunk_fn(2)(jeng.params, jstate)
        teng.decode_chunk(tstate, 2)
        np.testing.assert_array_equal(tstate.tokens.numpy(),
                                      np.asarray(jstate.tokens))
        _assert_same_pool(jeng, teng, jstate, tstate)


def test_refused_promotion_keeps_the_plan(trained_dense):
    """At tier 1 (int8 from bf16) the pool holds about twice the pages;
    filled past what tier 0's budget holds, a promotion is refused in
    both packages and the KV plan stays."""
    cfg = trained_dense[0]
    jeng, teng = _engines(trained_dense,
                          paged=dict(page_size=8, pool_pages=3))
    jl, tl = jeng.degrade_ladder(), teng.degrade_ladder()
    jstate = jeng.init_decode_state(3)
    tstate = teng.init_decode_state(3)
    jstate = jeng.apply_kv_plan(jstate, jl[1])
    tstate = teng.apply_kv_plan(tstate, tl[1])
    assert teng.pool.num_pages == jeng.pool.num_pages > 3
    jreqs, treqs = _requests(cfg.vocab_size, n=3)
    for slot in range(3):
        jstate = jeng.insert(jstate, slot, jeng.prefill_request(
            jreqs[slot].prompt, state=jstate), 8)
        teng.insert(tstate, slot, teng.prefill_request(treqs[slot].prompt,
                                                       tstate), 8)
    assert teng.pool.pages_in_use == jeng.pool.pages_in_use > 3
    assert jeng.apply_kv_plan(jstate, jl[0]) is None
    assert teng.apply_kv_plan(tstate, tl[0]) is None
    assert teng.kv_plan is tl[1] and jeng.kv_plan is jl[1]
    _assert_same_pool(jeng, teng, jstate, tstate)


# ---------------------------------------------------------------------------
# degraded serves against the JAX engine
# ---------------------------------------------------------------------------

def _serve_both(trained, jreqs, treqs, degrade, chaos_spec="oom",
                num_slots=2, chunk=4, prefill_chunk=None, **engine_kw):
    jeng, teng = _engines(trained, **engine_kw)
    tier0 = teng.kv_plan
    jd = JDegradeConfig(**degrade) if degrade is not None else None
    td = DegradeConfig(**degrade) if degrade is not None else None
    with jchaos.chaos(jchaos.FaultConfig.parse(chaos_spec)) as jinj:
        js = JServeSession(jeng, jreqs, num_slots=num_slots, chunk=chunk,
                           degrade=jd, prefill_chunk=prefill_chunk)
        jouts, jstats = js.run()
    with tchaos.chaos(tchaos.FaultConfig.parse(chaos_spec)) as tinj:
        ts = ServeSession(teng, treqs, num_slots=num_slots, chunk=chunk,
                          degrade=td, prefill_chunk=prefill_chunk)
        touts, tstats = ts.run()
    assert tinj.log == jinj.log
    assert ts.transitions == js.transitions
    assert tstats.kv_tier_steps == jstats.kv_tier_steps
    assert tstats.degraded_steps == jstats.degraded_steps
    assert tstats.degrade_transitions == jstats.degrade_transitions
    assert tstats.decode_steps == jstats.decode_steps
    _assert_same_serve(jouts, touts)
    _assert_pool_clean(teng)
    assert teng.kv_plan is tier0                      # back at tier 0
    return ts, tstats


@pytest.mark.parametrize("kv,layers", [("bf16", None),
                                       ("int8", ["int4", "raw"])])
def test_oom_spill_matches_reference(trained_dense, kv, layers):
    cfg = trained_dense[0]
    jreqs, treqs = _requests(cfg.vocab_size)
    ts, stats = _serve_both(trained_dense, jreqs, treqs, {}, kv=kv,
                            plan_layers=layers)
    assert stats.degrade_transitions >= 1
    assert stats.kv_tier_steps[1] > 0 and stats.degraded_steps > 0
    if layers is not None:
        assert TC.kv_tier_labels(ts._ladder)[1] == "mixed"


def test_promotion_back_matches_reference(trained_dense):
    cfg = trained_dense[0]
    jreqs, treqs = _requests(cfg.vocab_size, arrival_every=4)
    _, stats = _serve_both(trained_dense, jreqs, treqs,
                           dict(cooldown=2, headroom=0.3))
    assert stats.degrade_transitions >= 2
    assert stats.kv_tier_steps[0] > 0


def test_real_pressure_spills_and_promotes(trained_dense):
    """No injected fault: four requests of 16 rows (2 pages each) arrive
    together at a 3-page pool and 4 slots, so admissions stall until the
    pool spills; it promotes back once the stream drains."""
    cfg = trained_dense[0]
    jreqs, treqs = _requests(cfg.vocab_size, n=6, arrival_every=0)
    _, stats = _serve_both(trained_dense, jreqs, treqs,
                           dict(cooldown=1, headroom=0.3), chaos_spec="",
                           num_slots=4, paged=dict(page_size=8,
                                                   pool_pages=3))
    assert stats.degrade_transitions >= 2
    assert sum(stats.kv_tier_steps[1:]) > 0 and stats.kv_tier_steps[0] > 0


def test_chunked_prefill_across_a_spill_matches_reference(trained_dense):
    """A prompt reserved with ``prefill_chunk`` before the spill enters the
    pool after it: its insert quantizes at the new tier's precision."""
    cfg = trained_dense[0]
    jreqs, treqs = _requests(cfg.vocab_size, n=4, prompt_len=10,
                             arrival_every=0)
    ts, stats = _serve_both(trained_dense, jreqs, treqs,
                            dict(patience=1), chaos_spec="", num_slots=3,
                            prefill_chunk=3,
                            paged=dict(page_size=8, pool_pages=5))
    spill_clock = ts.transitions[0][0]
    assert stats.degrade_transitions >= 1 and stats.prefill_chunks > 0
    assert any(o.admitted_step <= spill_clock for o in ts.sched.finished)


def test_spec_engine_runs_plain_chunks_while_degraded(trained_dense):
    cfg = trained_dense[0]
    jreqs, treqs = _requests(cfg.vocab_size, max_new=6)
    _, stats = _serve_both(trained_dense, jreqs, treqs, {},
                           spec=dict(k=2, draft_source="ngram"))
    assert stats.degraded_steps > 0


def test_unpaged_engine_ignores_degrade(trained_dense):
    cfg = trained_dense[0]
    _, teng = _engines(trained_dense, paged=None)
    assert teng.degrade_ladder() == []
    _, treqs = _requests(cfg.vocab_size, n=3)
    outs, stats = teng.serve(treqs, num_slots=2, chunk=4,
                             degrade=DegradeConfig())
    assert len(outs) == 3 and stats.degrade_transitions == 0
    assert stats.kv_tier_steps == (stats.decode_steps,)


def test_spent_ladder_still_raises_out_of_pages(trained_dense):
    """Degradation does not hide a sizing error: a request of 8 pages
    against a one-page f32 pool (about 7 pages at int4) still deadlocks
    once the ladder is spent."""
    _, teng = _engines(trained_dense, paged=dict(page_size=8, pool_pages=1),
                       max_seq=64)
    req = Request(rid=0, prompt=np.zeros(32, np.int32), max_new_tokens=32)
    with pytest.raises(OutOfPages):
        teng.serve([req], num_slots=1, chunk=4, degrade=DegradeConfig())
    teng.pool.check_invariants()
    assert teng.pool.pages_in_use == 0


def test_failed_degraded_serve_leaves_the_engine_at_tier0(trained_dense):
    """A degraded serve that raises (the spent ladder's deadlock) puts the
    engine back on tier 0 as a finished serve does, so the engine's next
    serve spills from the precision it was built with: it equals a fresh
    JAX engine's serve (the reference's ``abort`` keeps the failed serve's
    degraded plan, and its next serve takes that for tier 0)."""
    cfg = trained_dense[0]
    pages = dict(page_size=8, pool_pages=1)
    _, teng = _engines(trained_dense, paged=pages, max_seq=64)
    tier0, ladder = teng.kv_plan, _ladder_key(teng.degrade_ladder())
    req = Request(rid=0, prompt=np.zeros(32, np.int32), max_new_tokens=32)
    with pytest.raises(OutOfPages):
        teng.serve([req], num_slots=1, chunk=4, degrade=DegradeConfig())
    assert teng.kv_plan is tier0
    assert _ladder_key(teng.degrade_ladder()) == ladder
    jeng, _ = _engines(trained_dense, paged=pages, max_seq=64)
    # requests of 2 pages against the 1-page pool: the first admission
    # deadlocks at tier 0 and spills
    jreqs, treqs = _requests(cfg.vocab_size, n=3)
    js = JServeSession(jeng, jreqs, num_slots=2, chunk=4,
                       degrade=JDegradeConfig())
    jouts, jstats = js.run()
    ts = ServeSession(teng, treqs, num_slots=2, chunk=4,
                      degrade=DegradeConfig())
    assert teng.pool.num_pages == 1
    touts, tstats = ts.run()
    assert ts.transitions == js.transitions and ts.transitions
    assert tstats.kv_tier_steps == jstats.kv_tier_steps
    _assert_same_serve(jouts, touts)
    _assert_pool_clean(teng)
    assert teng.kv_plan is tier0


def test_transition_drops_the_captured_chunks(trained_dense):
    """A tier transition hands back a new state over new pools and resets
    the engine's graphs, so the next chunk captures anew and no replay
    reads the freed pools; the serve equals the eager one."""
    cfg = trained_dense[0]
    _, eager = _engines(trained_dense)
    _, graph = _engines(trained_dense)
    log = []

    class Stub:
        def __init__(self, body):
            self.body = body

        def replay(self):
            self.body()

    def make_graph(body, pool, generators):
        log.append("capture")
        return Stub(body), None

    def warm_run(body):
        return body()

    graph.graphs = G.ChunkGraphs(make_graph=make_graph, warm_run=warm_run)
    left = []          # captured chunks left right after each transition
    inner = graph.apply_kv_plan

    def apply_kv_plan(state, plan):
        new = inner(state, plan)
        left.append((new is not state, len(graph.graphs.graphs)))
        return new

    graph.apply_kv_plan = apply_kv_plan
    _, treqs = _requests(cfg.vocab_size)
    with tchaos.chaos(tchaos.FaultConfig.parse("oom")):
        e_outs, e_stats = eager.serve(treqs, num_slots=2, chunk=4,
                                      degrade=DegradeConfig())
    with tchaos.chaos(tchaos.FaultConfig.parse("oom")):
        g_outs, g_stats = graph.serve(treqs, num_slots=2, chunk=4,
                                      degrade=DegradeConfig())
    transitions = g_stats.degrade_transitions
    assert transitions >= 1 and e_stats.kv_tier_steps == g_stats.kv_tier_steps
    # one capture before the first admission, one after each transition
    assert left == [(True, 0)] * transitions
    assert log.count("capture") == 1 + transitions
    for e, g in zip(e_outs, g_outs):
        np.testing.assert_array_equal(g.tokens, e.tokens)
        np.testing.assert_array_equal(g.logprobs, e.logprobs)


def test_in_flight_prefix_hit_follows_a_compaction(trained_dense):
    """A chunked prefill that pinned a prefix hit before a promotion
    (which compacts the live pages to the front of a smaller pool) maps
    the hit's page where it moved: its match is remapped through the
    rebuild's page map (the reference keeps the old ids)."""
    cfg = trained_dense[0]
    _, eng = _engines(trained_dense, paged=dict(page_size=4, pool_pages=12))
    rng = np.random.RandomState(5)
    a_prompt = rng.randint(0, cfg.vocab_size, size=(8,)).astype(np.int32)
    c_prompt = rng.randint(0, cfg.vocab_size, size=(8,)).astype(np.int32)
    b_prompt = np.concatenate([a_prompt[:4], rng.randint(
        0, cfg.vocab_size, size=(4,)).astype(np.int32)])
    sess = ServeSession(eng, [Request(rid=0, prompt=b_prompt,
                                      max_new_tokens=2)],
                        num_slots=3, chunk=2, prefill_chunk=2,
                        degrade=DegradeConfig())
    # C then A straight into slots 1 and 2; C leaves, and its cached pages
    # are flushed, so A's pages are not at the front of the pool
    for slot, prompt in ((1, c_prompt), (2, a_prompt)):
        eng.insert(sess.state, slot, eng.prefill_request(prompt, sess.state),
                   2)
    eng.release(sess.state, 1)
    eng.pool.flush_prefix()
    a_pages = list(eng.pool._slot_pages[2])
    assert a_pages[0] > 1
    assert sess._transition(1)                 # a spill: ids in place
    sess.dispatch()                            # B reserved, hit pinned
    task = sess.tasks[0]
    assert task.match.full_ids == (a_pages[0],) and not task.done
    assert sess._transition(0)                 # a promotion: compaction
    moved = eng.pool._slot_pages[2]
    assert moved[0] == 1 and task.match.full_ids == (moved[0],)
    eng.pool.check_invariants()
    while not sess.done:
        sess.dispatch()
        sess.harvest()
    outs, _ = sess.finalize()
    assert eng.pool.prefix_hits == 1
    assert len(outs) == 1 and len(outs[0].generated) == 2
    eng.release(sess.state, 2)
    _assert_pool_clean(eng)
