"""Self-speculative decoding in the port against the JAX package, on the
dense SMOKE model trained as tests/test_torch_serve.py trains it (f32):
the draft plan (fields, bit-exact int4 payloads, shared tensors,
truncation), the read-only draft propose step, the verify window and its
rollback, ``commit_tokens``, greedy spec ``serve()`` token for token
against the JAX spec engine and the port's non-spec engine for every draft
path over int8 and int4 KV, a draft that never agrees, the sampled path,
``SpecConfig`` validation, and the exactness of rejection sampling by a
chi-square test. Training gives stable top-1 margins, so greedy tokens can
be compared across frameworks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig
from repro.configs.registry import get_config as jget_config
from repro.quant.compiler import compile_draft_plan as jcompile_draft_plan
from repro.quant.compiler import compile_plan as jcompile_plan
from repro.serving import batch as JB
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.pool import PagedConfig as JPagedConfig
from repro.serving.quantized import explicit_plan as jexplicit_plan
from repro.serving.scheduler import synthetic_stream as jstream
from repro.serving.spec import SpecConfig as JSpecConfig
from repro.train.loop import train
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.models.model import build
from repro_torch.models.transformer import DecodeCache
from repro_torch.quant.apply import Segment, SegmentedParams
from repro_torch.quant.compiler import DRAFT_SHARED, compile_draft_plan
from repro_torch.quant.compiler import compile_plan
from repro_torch.quant.kvcache import KVPage
from repro_torch.quant.qtypes import QTensor
from repro_torch.serving import batch as TB
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.pool import PagedConfig
from repro_torch.serving.quantized import explicit_plan
from repro_torch.serving.scheduler import Request
from repro_torch.serving.spec import SpecConfig
from repro_torch.serving.spec.loop import accept

torch.set_num_threads(2)

MAX_SEQ = 32
LAYERS = ["int4", "int8"]        # one layer shares its payload, one requantizes


@pytest.fixture(scope="module")
def trained_dense():
    """The dense SMOKE model trained as tests/test_torch_serve.py trains it
    (f32, 40 steps, lr 3e-3, batch 8, seq 16)."""
    cfg = dataclasses.replace(jget_config("llama3.2-3b", smoke=True),
                              dtype="float32")
    run = RunConfig(steps=40, learning_rate=3e-3, warmup_steps=3,
                    remat=False)
    res = train(cfg, run, batch=8, seq=16)
    tcfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True),
                               dtype="float32")
    tparams = from_jax(jax.tree.map(np.asarray, res["params"]),
                       device="cpu")
    return cfg, res["model"], res["params"], tcfg, tparams


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_same_tree(t, j):
    """The port's tree equals the bridged JAX tree bit for bit."""
    if isinstance(t, dict):
        assert sorted(t) == sorted(j)
        for key in t:
            _assert_same_tree(t[key], j[key])
    elif isinstance(t, SegmentedParams):
        assert t.num_layers == j.num_layers
        assert len(t.segments) == len(j.segments)
        for a, b in zip(t.segments, j.segments):
            _assert_same_tree(a, b)
    elif isinstance(t, Segment):
        assert (t.precision, t.start, t.stop) == (j.precision, j.start,
                                                  j.stop)
        _assert_same_tree(t.params, j.params)
    elif isinstance(t, QTensor):
        assert (t.precision, tuple(t.shape), t.group) == \
            (j.precision, tuple(j.shape), j.group)
        assert torch.equal(t.data, j.data)
        assert torch.equal(t.scale.view(torch.int16),
                           j.scale.view(torch.int16))
    else:
        assert torch.equal(t, j)


@pytest.mark.parametrize("layers,draft_layers", [
    (LAYERS, None), (LAYERS, 1), (["int4", "int4"], 1), (None, None),
    (None, 1)])
def test_draft_plan_matches_reference(trained_dense, layers, draft_layers):
    """Fields equal the JAX plan's, payloads are bit-exact, and a shared
    block is the target's own Segment (zero new bytes). (["int4", "int4"],
    1) cuts inside a shared segment, which becomes a counted copy."""
    jcfg, jmodel, jparams, tcfg, tparams = trained_dense
    tmodel = build(tcfg)
    if layers is None:
        jplan = tplan = None
        jtarget, ttarget = jparams, tparams
    else:
        jplan = jexplicit_plan(jcfg, layers)
        tplan = explicit_plan(tcfg, layers)
        jtarget = jcompile_plan(jmodel, jparams, jplan).params
        ttarget = compile_plan(tmodel, tparams, tplan).params
    jd = jcompile_draft_plan(jmodel, jtarget, jplan,
                             draft_layers=draft_layers)
    td = compile_draft_plan(tmodel, ttarget, tplan,
                            draft_layers=draft_layers)
    assert td.to_manifest() == jd.to_manifest()
    assert td.overhead_bytes == jd.overhead_bytes
    _assert_same_tree(td.params, from_jax(_np(jd.params), device="cpu"))
    if layers is not None:
        for seg in td.params["layers"].segments:
            tseg = next(s for s in ttarget["layers"].segments
                        if s.start == seg.start)
            shared = tseg.precision in DRAFT_SHARED and seg.stop == tseg.stop
            assert (seg is tseg) == shared
    if draft_layers is not None:
        assert td.precisions[1 + draft_layers:] == \
            ("skip",) * (tcfg.num_layers - draft_layers)


def _jax_state(jcfg, jmodel, jparams, kv, rounds):
    """A JAX slotted state after ``rounds`` greedy spec rounds (per-slot
    positions differ), with the draft it ran."""
    jplan = jexplicit_plan(jcfg, LAYERS)
    eng = JServeEngine(jmodel, jparams, max_seq=MAX_SEQ, plan=jplan,
                       kv_precision=kv, spec=JSpecConfig(k=3), autotune=False)
    prompts = jax.random.randint(jax.random.PRNGKey(3), (2, 8), 0,
                                 jcfg.vocab_size, dtype=jnp.int32)
    state = eng._batch_state(prompts, None, 8, 0.0, 0, 1.0,
                             jax.random.PRNGKey(0))
    for _ in range(rounds):
        state, _ = eng._spec_fn(1)(eng.params, eng.draft_params, state)
    return eng, state


def _port_cache(jcache):
    return DecodeCache(*from_jax(_np(jcache), device="cpu"))


def _cache_tensors(cache):
    out = []
    for field in (cache.k, cache.v):
        for page in field if isinstance(field, tuple) else (field,):
            out += [page.data] + ([page.scale] if isinstance(page, KVPage)
                                  and page.scale is not None else [])
    return out


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_draft_propose_step_matches_reference(trained_dense, kv):
    """Three read-only draft steps from per-slot cache positions: logits
    and side buffers as in JAX, and the cache untouched."""
    jcfg, jmodel, jparams, tcfg, _ = trained_dense
    tmodel = build(tcfg)
    eng, state = _jax_state(jcfg, jmodel, jparams, kv, rounds=1)
    dparams = from_jax(_np(eng.draft_params), device="cpu")
    cache = _port_cache(state.cache)
    before = [t.clone() for t in _cache_tensors(cache)]
    shape = (tcfg.num_layers, 2, 3, tcfg.num_kv_heads, tcfg.head_dim)
    jfk = jfv = jnp.zeros(shape, jnp.float32)
    tfk, tfv = torch.zeros(shape), torch.zeros(shape)
    tok = np.array([[5], [9]], np.int32)
    for count in range(3):
        jl, jfk, jfv = jmodel.draft_propose_step(
            eng.draft_params, state.cache, jfk, jfv, jnp.int32(count),
            jnp.asarray(tok))
        tl, tfk, tfv = tmodel.draft_propose_step(
            dparams, cache, tfk, tfv, count, torch.from_numpy(tok).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(tfk.numpy(), np.asarray(jfk), atol=1e-5)
        np.testing.assert_allclose(tfv.numpy(), np.asarray(jfv), atol=1e-5)
        tok = np.asarray(jl)[:, :, :jcfg.vocab_size].argmax(-1).astype(
            np.int32)
    for a, b in zip(before, _cache_tensors(cache)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_spec_verify_and_commit_match_reference(trained_dense, kv):
    jcfg, jmodel, jparams, tcfg, tparams = trained_dense
    tmodel = build(tcfg)
    eng, state = _jax_state(jcfg, jmodel, jparams, kv, rounds=1)
    tparams_c = from_jax(_np(eng.params), device="cpu")
    cache = _port_cache(state.cache)
    window = np.array([[1, 2, 3, 4], [7, 8, 9, 10]], np.int32)
    jl, jsnap = jmodel.spec_verify(eng.params, state.cache,
                                   jnp.asarray(window))
    tl, tsnap = tmodel.spec_verify(tparams_c, cache,
                                   torch.from_numpy(window).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    committed = np.array([0, 3], np.int32)
    jc = jmodel.spec_commit(jsnap, jnp.asarray(committed))
    tc = tmodel.spec_commit(tsnap, torch.from_numpy(committed))
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    np.testing.assert_array_equal(tc.pos.numpy(),
                                  np.asarray(state.cache.pos) + committed)


def test_commit_tokens_matches_reference(trained_dense):
    jcfg, jmodel, _, tcfg, _ = trained_dense
    rng = np.random.default_rng(0)
    s_max = 16
    tokens = rng.integers(0, 500, (3, s_max)).astype(np.int32)
    logprobs = rng.standard_normal((3, s_max)).astype(np.float32)
    lengths = np.array([3, 5, 14], np.int32)
    cand = rng.integers(0, 500, (3, 4)).astype(np.int32)
    cand_lp = rng.standard_normal((3, 4)).astype(np.float32)
    counts = np.array([0, 2, 3], np.int32)   # slot 2 runs past the buffer
    js = JB.init_state(jmodel, 3, s_max, jax.random.PRNGKey(0))._replace(
        tokens=jnp.asarray(tokens), logprobs=jnp.asarray(logprobs),
        lengths=jnp.asarray(lengths))
    js = JB.commit_tokens(js, jnp.asarray(cand), jnp.asarray(cand_lp),
                          jnp.asarray(counts))
    ts = TB.init_state(build(tcfg), 3, s_max, "cpu")
    ts.tokens, ts.logprobs = torch.from_numpy(tokens), torch.from_numpy(
        logprobs)
    ts.lengths = torch.from_numpy(lengths)
    TB.commit_tokens(ts, torch.from_numpy(cand), torch.from_numpy(cand_lp),
                     torch.from_numpy(counts))
    np.testing.assert_array_equal(ts.tokens.numpy(), np.asarray(js.tokens))
    np.testing.assert_array_equal(ts.logprobs.numpy(),
                                  np.asarray(js.logprobs))
    np.testing.assert_array_equal(ts.lengths.numpy(), np.asarray(js.lengths))


def _requests(jcfg):
    reqs = jstream(6, vocab_size=jcfg.vocab_size, prompt_len=8,
                   max_new_tokens=8, arrival_rate=0.5, seed=3)
    mine = [Request(rid=r.rid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens,
                    arrival_step=r.arrival_step) for r in reqs]
    return reqs, mine


@pytest.fixture(scope="module")
def baseline(trained_dense):
    """The port's non-spec serve of the stream, per KV precision."""
    jcfg, _, _, tcfg, tparams = trained_dense
    out = {}
    for kv in ("int8", "int4"):
        eng = ServeEngine(build(tcfg), tparams, max_seq=MAX_SEQ,
                          plan=explicit_plan(tcfg, LAYERS), kv_precision=kv,
                          eos_id=7, device="cpu")
        out[kv] = eng.serve(_requests(jcfg)[1], num_slots=3, chunk=4)[0]
    return out


SPECS = {"fused": dict(k=3), "two-pass": dict(k=3, fused_propose=False),
         "truncated": dict(k=3, draft_layers=1),
         "ngram": dict(k=2, draft_source="ngram")}


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("draft", sorted(SPECS))
def test_greedy_spec_serve_matches_reference(trained_dense, baseline, draft,
                                             kv):
    """Greedy spec serve() emits the JAX spec engine's tokens and the
    port's non-spec engine's tokens, with requests arriving mid-decode and
    an EOS id."""
    jcfg, jmodel, jparams, tcfg, tparams = trained_dense
    jeng = JServeEngine(jmodel, jparams, max_seq=MAX_SEQ,
                        plan=jexplicit_plan(jcfg, LAYERS), kv_precision=kv,
                        eos_id=7, spec=JSpecConfig(**SPECS[draft]),
                        autotune=False)
    teng = ServeEngine(build(tcfg), tparams, max_seq=MAX_SEQ,
                       plan=explicit_plan(tcfg, LAYERS), kv_precision=kv,
                       eos_id=7, spec=SpecConfig(**SPECS[draft]),
                       device="cpu")
    if draft != "ngram":
        assert teng.draft_overhead_bytes() == jeng.draft_overhead_bytes()
        assert teng.draft_weight_bytes() == pytest.approx(
            jeng.draft_weight_bytes())
    jreqs, treqs = _requests(jcfg)
    jouts, jstats = jeng.serve(jreqs, num_slots=3, chunk=2)
    touts, stats = teng.serve(treqs, num_slots=3, chunk=2)
    assert [o.rid for o in touts] == [o.rid for o in jouts]
    for t, j, base in zip(touts, jouts, baseline[kv]):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        np.testing.assert_array_equal(t.tokens, base.tokens)
        assert t.finish_reason == j.finish_reason == base.finish_reason
        np.testing.assert_allclose(t.logprobs, np.asarray(j.logprobs),
                                   atol=1e-2)
        np.testing.assert_allclose(t.logprobs, base.logprobs, atol=1e-4)
    assert stats.draft_proposed > 0
    assert ((stats.draft_proposed, stats.draft_accepted, stats.spec_rounds)
            == (jstats.draft_proposed, jstats.draft_accepted,
                jstats.spec_rounds))
    assert 0.0 <= stats.acceptance_rate <= 1.0
    assert stats.tokens_per_round >= 1.0
    if draft == "ngram":
        assert teng._draft is None         # no model draft was derived


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_forced_mismatch_draft_rolls_back_exactly(trained_dense, baseline,
                                                  kv):
    """A draft with unrelated random weights proposes mostly wrong tokens;
    every round falls back to the target's token through rollback and
    correction, so the output stays the non-spec engine's."""
    jcfg, _, _, tcfg, tparams = trained_dense
    model = build(tcfg)
    eng = ServeEngine(model, tparams, max_seq=MAX_SEQ,
                      plan=explicit_plan(tcfg, LAYERS), kv_precision=kv,
                      eos_id=7, spec=SpecConfig(k=3), device="cpu")
    other = model.init(torch.Generator().manual_seed(99), "cpu")
    plan = explicit_plan(tcfg, LAYERS)
    eng._ensure_draft().params = compile_draft_plan(
        model, compile_plan(model, other, plan).params, plan).params
    outs, stats = eng.serve(_requests(jcfg)[1], num_slots=3, chunk=1)
    for t, base in zip(outs, baseline[kv]):
        np.testing.assert_array_equal(t.tokens, base.tokens)
    assert stats.acceptance_rate < 0.2


def test_rollback_keeps_the_pending_invariant(trained_dense):
    """After a spec round each live slot's cache sits one row behind its
    length (the pending token has no row yet), and the committed count is
    what the lengths grew by."""
    _, _, _, tcfg, tparams = trained_dense
    eng = ServeEngine(build(tcfg), tparams, max_seq=MAX_SEQ,
                      kv_precision="int8", spec=SpecConfig(k=3),
                      device="cpu")
    prompts = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 8))
    state = eng.init_decode_state(2)
    for i in range(2):
        eng.insert(state, i, eng.prefill_request(prompts[i]), 8)
    np.testing.assert_array_equal(state.cache.pos.numpy(), [8, 8])
    state, m = eng.decode_chunk(state, 1)
    live = (state.active & ~state.done).numpy()
    np.testing.assert_array_equal(state.cache.pos.numpy()[live],
                                  state.lengths.numpy()[live] - 1)
    assert int(m.committed) == int(state.lengths.sum()) - 16


@pytest.mark.parametrize("draft", ["model", "ngram"])
def test_sampled_spec_is_finite_and_in_budget(trained_dense, draft):
    _, _, _, tcfg, tparams = trained_dense
    eng = ServeEngine(build(tcfg), tparams, max_seq=MAX_SEQ,
                      plan=explicit_plan(tcfg, LAYERS), kv_precision="int8",
                      spec=SpecConfig(k=3, draft_source=draft), device="cpu")
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(0, tcfg.vocab_size, 8)
                    .astype(np.int32), max_new_tokens=8, temperature=0.8,
                    top_k=8 if i % 2 else 0, top_p=0.95)
            for i in range(4)]
    outs, stats = eng.serve(reqs, num_slots=2, chunk=2)
    for o in outs:
        assert len(o.generated) == 8
        assert (o.generated >= 0).all() and (o.generated < tcfg.vocab_size
                                             ).all()
        assert np.isfinite(o.logprobs).all()
    assert stats.tokens_per_round >= 1.0


def test_spec_budget_needs_verify_headroom(trained_dense):
    _, _, _, tcfg, tparams = trained_dense
    eng = ServeEngine(build(tcfg), tparams, max_seq=20, spec=SpecConfig(k=4),
                      device="cpu")
    prompts = np.random.default_rng(3).integers(0, tcfg.vocab_size, (1, 8))
    out = eng.generate(prompts, 8, chunk=2)      # 8 + 8 + 4 = 20 fits
    assert out.tokens.shape == (1, 16)
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate(prompts, 9, chunk=2)


@pytest.mark.parametrize("kwargs", [
    dict(k=0), dict(k=2, draft_source="oracle"),
    dict(k=2, draft_source="ngram", draft_layers=1),
    dict(k=2, draft_layers=0), dict(k=2, draft_layers=1,
                                    fused_propose=False)])
def test_spec_config_validation_matches_reference(kwargs):
    with pytest.raises(ValueError) as want:
        JSpecConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        SpecConfig(**kwargs)
    assert str(got.value) == str(want.value)


def test_rejection_sampling_commits_the_target_distribution():
    """k = 1, fixed target p and draft q on 6 tokens: the first committed
    token (the proposal when accepted, else the residual draw) follows p.
    Chi-square over 40,000 draws against the 0.1% critical value for 5
    degrees of freedom (20.52); the proposal alone (no rejection) follows q
    and must fail the same test."""
    n, v = 40_000, 6
    p1 = torch.tensor([0.30, 0.25, 0.20, 0.12, 0.08, 0.05])
    q1 = torch.tensor([0.05, 0.10, 0.15, 0.20, 0.25, 0.25])
    gen = torch.Generator().manual_seed(0)
    x = torch.multinomial(q1.expand(n, v), 1, replacement=True,
                          generator=gen)                  # (N, 1)
    p = torch.log(p1).expand(n, 2, v)                     # + the bonus row
    q = torch.log(q1).expand(n, 1, v)
    a, z = accept(p, q, x, torch.ones(n), gen, sampling=True)
    first = torch.where(a == 1, x[:, 0], z)

    def chi2(tokens):
        counts = torch.bincount(tokens, minlength=v).double()
        expect = p1.double() * n
        return float(((counts - expect) ** 2 / expect).sum())

    assert chi2(first) < 20.52
    assert chi2(x[:, 0]) > 20.52


@pytest.mark.parametrize("draft,kv", [("fused", "int8"), ("two-pass", "int4"),
                                      ("ngram", "int8")])
def test_paged_spec_serve_matches_dense_and_reference(trained_dense, draft,
                                                      kv):
    """Spec serve over a paged pool (pages of 4): the verify writes K+1
    rows through the tables and rolls back by position, the fused propose
    reads the pool with fresh rows, the two-pass propose runs on a clone
    of the pool. Greedy tokens equal the port's dense spec serve (logprobs
    to the bit) and the JAX paged spec engine's, and no page leaks."""
    jcfg, jmodel, jparams, tcfg, tparams = trained_dense
    jeng = JServeEngine(jmodel, jparams, max_seq=MAX_SEQ,
                        plan=jexplicit_plan(jcfg, LAYERS), kv_precision=kv,
                        eos_id=7, spec=JSpecConfig(**SPECS[draft]),
                        paged=JPagedConfig(page_size=4), autotune=False)
    engines = [ServeEngine(build(tcfg), tparams, max_seq=MAX_SEQ,
                           plan=explicit_plan(tcfg, LAYERS), kv_precision=kv,
                           eos_id=7, spec=SpecConfig(**SPECS[draft]),
                           device="cpu", paged=paged)
               for paged in (PagedConfig(page_size=4), None)]
    jreqs, treqs = _requests(jcfg)
    jouts, _ = jeng.serve(jreqs, num_slots=3, chunk=2)
    (touts, stats), (douts, dstats) = (e.serve(treqs, num_slots=3, chunk=2)
                                       for e in engines)
    for t, d, j in zip(touts, douts, jouts):
        np.testing.assert_array_equal(t.tokens, d.tokens)
        np.testing.assert_array_equal(t.logprobs, d.logprobs)
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
    assert stats.draft_accepted == dstats.draft_accepted
    assert stats.pool_pages_peak > 0
    pool = engines[0].pool
    pool.check_invariants()
    assert pool.pages_in_use == pool.prefix.evictable(pool._ref)
