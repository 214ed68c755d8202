"""The port's hybrid family (zamba2) against the JAX reference on the
zamba2 SMOKE config (4 Mamba2 layers, d_model 128, a shared attention +
MLP block at 2 sites, hd 32, f32):

* the forward and teacher-forced decode steps over a raw cache (1e-4) and
  over int8 / int4 KV pages (1e-4: both sides quantize alike);
* a mixed plan that cuts inside units: the same segments as the
  reference's ``compile_plan``, payloads and scales equal to the bit, the
  forward on it (1e-4); the KV plan over the shared sites;
* serving on a briefly trained fixture (untrained weights have greedy
  near-ties, as the reference's own
  ``test_serve_int8_kv_matches_bf16_cache[hybrid]`` shows): greedy tokens
  equal to the JAX engine's and logprobs within 1e-2 (an int8 against a
  bf16 cache, README.md), dense with int8 KV, paged with a prefix hit
  (pages mapped, the prompt prefilled in full), and speculative with the
  ngram draft and the int4 self-draft;
* decode chunks and spec rounds write every state tensor in place, and the
  prompt scan replayed through ``graphs.PromptStep`` (a stub graph on the
  CPU) equals the eager scan to the bit;
* the bridge round trip.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig
from repro.configs.registry import get_config as jget_config
from repro.models.model import build as jbuild
from repro.quant.compiler import compile_kv_plan as jcompile_kv_plan
from repro.quant.compiler import compile_plan as jcompile_plan
from repro.quant.kvcache import quantize_model_cache as jquantize_cache
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.pool import PagedConfig as JPagedConfig
from repro.serving.quantized import explicit_plan as jexplicit_plan
from repro.serving.scheduler import Request as JRequest
from repro.serving.spec import SpecConfig as JSpecConfig
from repro.train.loop import train
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.models import hybrid as TH
from repro_torch.models.model import build
from repro_torch.quant.apply import SegmentedParams
from repro_torch.quant.compiler import compile_kv_plan
from repro_torch.quant.kvcache import KVPage, quantize_model_cache
from repro_torch.quant.qtypes import QTensor
from repro_torch.serving import graphs as G
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.pool import PagedConfig
from repro_torch.serving.quantized import explicit_plan
from repro_torch.serving.scheduler import Request
from repro_torch.serving.spec import SpecConfig
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

B, MAX_SEQ = 2, 40
MIXED = ["int8", "int8", "int8", "int4"]   # a cut inside unit 1


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs():
    return (dataclasses.replace(jget_config("zamba2-2.7b", smoke=True),
                                dtype="float32"),
            dataclasses.replace(get_config("zamba2-2.7b", smoke=True),
                                dtype="float32"))


@pytest.fixture(scope="module")
def zamba():
    jcfg, tcfg = _cfgs()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(5))
    return jcfg, tcfg, jmodel, jparams, build(tcfg), from_jax(
        _np(jparams), device="cpu")


@pytest.fixture(scope="module")
def trained():
    """The hybrid SMOKE model trained as tests/conftest.py trains it (f32,
    40 steps, lr 3e-3, batch 8, seq 16)."""
    jcfg, tcfg = _cfgs()
    run = RunConfig(steps=40, learning_rate=3e-3, warmup_steps=3,
                    remat=False)
    res = train(jcfg, run, batch=8, seq=16)
    return jcfg, tcfg, res["model"], res["params"], build(tcfg), from_jax(
        _np(res["params"]), device="cpu")


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _decode_both(jmodel, jparams, jcache, tmodel, tparams, tcache, toks):
    for t in range(toks.shape[1]):
        jl, jcache = jmodel.decode_step(jparams, jcache,
                                        jnp.asarray(toks[:, t:t + 1]))
        tl, tcache = tmodel.decode_step(tparams, tcache,
                                        torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    return jcache, tcache


def test_apply_and_decode_steps_match_reference(zamba):
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = zamba
    toks = _tokens(jcfg, 1, (B, 10))
    jlog, _ = jmodel.apply(jparams, {"tokens": jnp.asarray(toks)})
    tlog = tmodel.apply(tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    jcache, tcache = _decode_both(
        jmodel, jparams, jmodel.slotted_cache(B, MAX_SEQ), tmodel, tparams,
        tmodel.slotted_cache(B, MAX_SEQ, "cpu"), toks)
    for name in ("conv", "state", "k", "v"):
        np.testing.assert_allclose(getattr(tcache, name).numpy(),
                                   np.asarray(getattr(jcache, name)),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_decode_steps_over_quantized_kv_match_reference(zamba, kv):
    """One KVPage over the U shared sites (the shared block's one
    decision): the same quantized rows, the same logits."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = zamba
    jplan = jcompile_kv_plan(jcfg, None, kv)
    tplan = compile_kv_plan(tcfg, None, kv)
    assert tplan.precisions == jplan.precisions == (kv,) * 2
    jcache = jquantize_cache(jmodel.slotted_cache(B, MAX_SEQ), jplan, (),
                             ("k", "v"))
    tcache = quantize_model_cache(tmodel.slotted_cache(B, MAX_SEQ, "cpu"),
                                  tplan, (), ("k", "v"))
    assert isinstance(tcache.k, KVPage) and tcache.k.data.shape[0] == 2
    jcache, tcache = _decode_both(jmodel, jparams, jcache, tmodel, tparams,
                                  tcache, _tokens(jcfg, 2, (B, 8)))
    np.testing.assert_array_equal(tcache.k.data.numpy(),
                                  np.asarray(jcache.k.data))


def test_mixed_plan_cuts_inside_units_like_reference(zamba):
    """A plan mixed inside unit 1 (layers 2-3): segments cut at the unit
    boundary and at the precision change, every payload and scale (stack
    and shared block) equal to the reference's to the bit; the forward and
    decode steps on it."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = zamba
    jcp = jcompile_plan(jmodel, jparams, jexplicit_plan(
        jcfg, MIXED, shared_precision="int4"))
    tcp = tmodel.compile_plan(tparams, explicit_plan(
        tcfg, MIXED, shared_precision="int4"))
    jl, tl = jcp.params["layers"], tcp.params["layers"]
    assert isinstance(tl, SegmentedParams)
    segs = [(s.precision, s.start, s.stop) for s in tl.segments]
    assert segs == [(s.precision, s.start, s.stop) for s in jl.segments]
    assert segs == [("int8", 0, 2), ("int8", 2, 3), ("int4", 3, 4)]
    pairs = [(js.params, ts.params) for js, ts in zip(jl.segments,
                                                      tl.segments)]
    pairs.append((jcp.params["shared"], tcp.params["shared"]))
    for jtree, ttree in pairs:
        jleaves = jax.tree.leaves(
            jtree, is_leaf=lambda x: hasattr(x, "precision"))
        tleaves = tree_leaves(ttree)
        assert len(jleaves) == len(tleaves)
        for jq, tq in zip(jleaves, tleaves):
            if isinstance(tq, QTensor):
                np.testing.assert_array_equal(tq.data.numpy(),
                                              np.asarray(jq.data))
                np.testing.assert_array_equal(
                    tq.scale.float().numpy(),
                    np.asarray(jq.scale.astype(jnp.float32)))
    toks = _tokens(jcfg, 3, (B, 8))
    np.testing.assert_allclose(
        tmodel.apply(tcp.params, torch.from_numpy(toks)).numpy(),
        np.asarray(jmodel.apply(jcp.params,
                                {"tokens": jnp.asarray(toks)})[0]),
        rtol=1e-4, atol=1e-4)
    _decode_both(jmodel, jcp.params, jmodel.slotted_cache(B, MAX_SEQ),
                 tmodel, tcp.params, tmodel.slotted_cache(B, MAX_SEQ, "cpu"),
                 toks[:, :4])
    units = TH._layer_stack(tl, tcfg)
    assert [[l for _, _, l in u] for u in units] == [[0, 1], [2, 3]]


@pytest.mark.parametrize("kv", ["auto", "int8", "int4", "bf16"])
@pytest.mark.parametrize("shared", ["raw", "int8", "int4", "ternary"])
def test_kv_plan_covers_the_shared_sites(zamba, kv, shared):
    """The KV plan has one entry per shared-attention site (2 at SMOKE, 9
    at full width); "auto" follows the shared block's decision."""
    jcfg, tcfg = zamba[:2]
    jp = jcompile_kv_plan(jcfg, jexplicit_plan(jcfg, MIXED,
                                               shared_precision=shared), kv)
    tp = compile_kv_plan(tcfg, explicit_plan(tcfg, MIXED,
                                             shared_precision=shared), kv)
    if jp is None:
        assert tp is None
        return
    assert tp.precisions == jp.precisions and tp.group == jp.group
    assert len(tp.precisions) == 2
    full = get_config("zamba2-2.7b")
    assert len(compile_kv_plan(full, None, "int8").precisions) == 9


# ---------------------------------------------------------------------------
# serving on the trained fixture
# ---------------------------------------------------------------------------

def _requests(cfg, shared_prefix: int = 0):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (9, 12, 10, 14)]
    if shared_prefix:
        for p in prompts[1:]:
            p[:shared_prefix] = prompts[0][:shared_prefix]
    mine = [Request(rid=i, prompt=p, max_new_tokens=8, arrival_step=2 * i)
            for i, p in enumerate(prompts)]
    ref = [JRequest(rid=i, prompt=p, max_new_tokens=8, arrival_step=2 * i)
           for i, p in enumerate(prompts)]
    return ref, mine


def _serve_both(trained, *, kv="int8", paged=None, spec=None,
                shared_prefix=0):
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = trained
    jeng = JServeEngine(
        jmodel, jparams, max_seq=MAX_SEQ, kv_precision=kv, autotune=False,
        paged=JPagedConfig(**paged) if paged else None,
        spec=JSpecConfig(**spec) if spec else None)
    teng = ServeEngine(tmodel, tparams, max_seq=MAX_SEQ, kv_precision=kv,
                       device="cpu",
                       paged=PagedConfig(**paged) if paged else None,
                       spec=SpecConfig(**spec) if spec else None)
    jreqs, treqs = _requests(jcfg, shared_prefix)
    jouts, jstats = jeng.serve(jreqs, num_slots=2, chunk=3)
    touts, tstats = teng.serve(treqs, num_slots=2, chunk=3)
    assert [o.rid for o in touts] == [o.rid for o in jouts]
    for t, j in zip(touts, jouts):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        np.testing.assert_allclose(t.logprobs, np.asarray(j.logprobs),
                                   atol=1e-2)
    return teng, touts, tstats, jstats


def test_serve_int8_kv_matches_reference(trained):
    teng, touts, stats, _ = _serve_both(trained)
    assert stats.admissions > 0
    ref, _, _, _ = _serve_both(trained, kv="bf16")
    assert ref.kv_bytes_per_slot() / teng.kv_bytes_per_slot() >= 3.8
    state = teng.state_bytes_by_field()
    cfg = trained[1]
    assert state["state"] == (cfg.num_layers * cfg.ssm_nheads
                              * cfg.ssm_headdim * cfg.ssm_state * 4)
    assert teng.kv_bytes_by_field().keys() == {"k", "v"}


def test_paged_serve_with_prefix_hit_matches_reference(trained):
    """Pages of 4 with prefix sharing: the later prompts share 8 tokens
    with the first, their pages are mapped, and the prompt is still
    prefilled in full; tokens equal to the reference's paged engine and to
    the port's dense engine."""
    teng, touts, stats, jstats = _serve_both(
        trained, paged=dict(page_size=4), shared_prefix=8)
    assert stats.prefix_hits > 0
    assert stats.prefix_hits == jstats.prefix_hits
    assert stats.prefix_hit_tokens == jstats.prefix_hit_tokens
    _, dense, _, _ = _serve_both(trained, shared_prefix=8)
    for p, d in zip(touts, dense):
        np.testing.assert_array_equal(p.tokens, d.tokens)
        np.testing.assert_array_equal(p.logprobs, d.logprobs)


@pytest.mark.parametrize("source", ["ngram", "model"])
def test_spec_serve_matches_reference(trained, source):
    """k = 3, two-pass propose (the family has no fused one); the greedy
    tokens are the non-spec engine's."""
    teng, touts, stats, jstats = _serve_both(
        trained, spec=dict(k=3, draft_source=source))
    assert stats.spec_rounds > 0
    assert ((stats.draft_proposed, stats.draft_accepted, stats.spec_rounds)
            == (jstats.draft_proposed, jstats.draft_accepted,
                jstats.spec_rounds))
    assert not teng.model.supports_fused_propose
    _, plain, _, _ = _serve_both(trained)
    for s, p in zip(touts, plain):
        np.testing.assert_array_equal(s.tokens, p.tokens)


# ---------------------------------------------------------------------------
# in-place state (what a replayed CUDA graph needs)
# ---------------------------------------------------------------------------

def _state_tensors(state) -> dict:
    out = {name: getattr(state, name) for name in (
        "last_logits", "tokens", "lengths", "done", "logprobs")}
    for fname, field in zip(state.cache._fields, state.cache):
        if isinstance(field, torch.Tensor):
            out[fname] = field
        else:
            for leaf in ("data", "scale", "table"):
                t = getattr(field, leaf, None)
                if t is not None:
                    out[f"{fname}.{leaf}"] = t
    return out


@pytest.mark.parametrize("paged,spec", [(False, None), (True, None),
                                        (False, dict(k=3))])
def test_chunks_write_the_state_in_place(trained, paged, spec):
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = trained
    kw = dict(paged=PagedConfig(page_size=4) if paged else None,
              spec=SpecConfig(**spec) if spec else None)
    teng = ServeEngine(tmodel, tparams, max_seq=MAX_SEQ, kv_precision="int8",
                       device="cpu", **kw)
    jeng = JServeEngine(jmodel, jparams, max_seq=MAX_SEQ, kv_precision="int8",
                        autotune=False,
                        paged=JPagedConfig(page_size=4) if paged else None,
                        spec=JSpecConfig(**spec) if spec else None)
    tstate, jstate = teng.init_decode_state(3), jeng.init_decode_state(3)
    _, treqs = _requests(jcfg)
    for slot, r in enumerate(treqs[:3]):
        teng.insert(tstate, slot, teng.prefill_request(r.prompt, tstate), 10)
        jstate = jeng.insert(jstate, slot, jeng.prefill_request(
            r.prompt, state=jstate), 10)
    before = {k: t.data_ptr() for k, t in _state_tensors(tstate).items()}
    for _ in range(2):
        teng.decode_chunk(tstate, 3)
        out = jeng.decode_chunk(jstate, 3)
        jstate = out[0] if spec else out
    assert {k: t.data_ptr() for k, t in
            _state_tensors(tstate).items()} == before
    np.testing.assert_array_equal(tstate.tokens.numpy(),
                                  np.asarray(jstate.tokens))
    np.testing.assert_array_equal(tstate.cache.pos.numpy(),
                                  np.asarray(jstate.cache.pos))
    np.testing.assert_allclose(tstate.cache.state.numpy(),
                               np.asarray(jstate.cache.state), rtol=1e-3,
                               atol=1e-4)


class _StubGraph:
    """Records nothing: each replay runs the captured body again."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-780m"])
def test_prompt_step_equals_the_eager_scan(zamba, arch):
    """The prompt scan through ``PromptStep`` (the step captured once and
    replayed per token, here through a stub graph) leaves the eager scan's
    cache and logits to the bit, for a second prompt too (the persistent
    cache is zeroed between prompts)."""
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = build(tcfg)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    eng = ServeEngine(model, params, max_seq=MAX_SEQ, device="cpu")
    step = G.PromptStep(model, params, MAX_SEQ, "cpu",
                        make_graph=lambda body, pool, gens: (
                            _StubGraph(body), body()),
                        warm_run=lambda body: body())
    for seed in (1, 2):
        toks = torch.from_numpy(_tokens(tcfg, seed, (1, 7 + seed)))
        gcache, glog = step.run(toks)
        ecache, elog = eng._scan_prompt(toks)
        assert torch.equal(glog, elog)
        for g, e in zip(gcache, ecache):
            assert torch.equal(g, e)


def test_bridge_round_trip(zamba):
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = zamba
    np.testing.assert_array_equal(
        tparams["shared"]["attn"]["wq"].numpy(),
        np.asarray(jparams["shared"]["attn"]["wq"]))
    np.testing.assert_array_equal(tparams["layers"]["w_in"].numpy(),
                                  np.asarray(jparams["layers"]["w_in"]))
    jcache = jquantize_cache(jmodel.slotted_cache(B, MAX_SEQ),
                             jcompile_kv_plan(jcfg, None, "int4"), (),
                             ("k", "v"))
    tcache = from_jax(_np(jcache), device="cpu")
    assert isinstance(tcache, TH.HybridCache)
    assert isinstance(tcache.k, KVPage) and tcache.k.precision == "int4"
    np.testing.assert_array_equal(tcache.state.numpy(),
                                  np.asarray(jcache.state))
    mine = tmodel.init(torch.Generator().manual_seed(0), "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat:
        node = mine
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape, path


def test_cpu_engines_scan_prompts_eagerly(zamba):
    """A CPU engine never captures the prompt step (its prompts scan
    eagerly), whatever ``cuda_graphs`` says."""
    tmodel, tparams = zamba[4], zamba[5]
    for graphs in (True, False):
        eng = ServeEngine(tmodel, tparams, max_seq=MAX_SEQ, device="cpu",
                          cuda_graphs=graphs)
        assert eng.prompt_graph is False and eng.graphs is None
    eng = ServeEngine(tmodel, tparams, max_seq=MAX_SEQ, device="cpu")
    cache, logits = eng.prefill(np.array([[3, 4, 5]], np.int32))
    assert eng._prompt_step is None
    assert int(cache.pos) == 3 and logits.shape == (1, tmodel.cfg.padded_vocab)
