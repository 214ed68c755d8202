"""Chunked prefill on the SSM (mamba2), hybrid (zamba2) and enc-dec
(whisper) families against the JAX package, on SMOKE fixtures trained as
the port's family tests train theirs (greedy tokens are asserted only on
trained weights):

* ``serve(prefill_chunk=5)`` emits the JAX engine's chunked tokens and the
  port's whole-prompt tokens, with the same ``prefill_chunks``; the hybrid
  also paged, with a prefix hit (its pages mapped, the prompt still
  scanned in full, in chunks);
* a recurrent chunk is a scan of single-token steps from the task's cache:
  ``graphs.PromptStep.run`` from a given cache (a stub graph on the CPU)
  and ``begin_prefill`` + ``advance_prefill`` through it equal the eager
  scan over the whole prompt to the bit, in the cache and the logits;
* an enc-dec task starts from the encoder seed and its chunks equal the
  whole-prompt prefill within f32 rounding.
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
from repro.train.loop import train
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.models.model import build
from repro_torch.serving import graphs as G
from repro_torch.serving import scheduler as TS
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.pool import PagedConfig

torch.set_num_threads(2)

# family -> (arch, training steps): the steps of the port's family tests
FAMILIES = {"ssm": ("mamba2-780m", 30), "hybrid": ("zamba2-2.7b", 40),
            "encdec": ("whisper-medium", 40)}
MAX_SEQ = 24


@pytest.fixture(scope="module")
def trained():
    """Each family's SMOKE model trained in f32 (lr 3e-3, batch 8, seq
    16), with the port's copy of its params."""
    out = {}
    for family, (arch, steps) in FAMILIES.items():
        jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                                   dtype="float32")
        tcfg = dataclasses.replace(get_config(arch, smoke=True),
                                   dtype="float32")
        run = RunConfig(steps=steps, learning_rate=3e-3, warmup_steps=3,
                        remat=False)
        res = train(jcfg, run, batch=8, seq=16)
        out[family] = (jcfg, res["model"], res["params"], tcfg, build(tcfg),
                       from_jax(jax.tree.map(np.asarray, res["params"]),
                                device="cpu"))
    return out


def _requests(jcfg, n=4, prompt_len=12, max_new=6, arrival=0.5):
    """One stream for both packages (tests/test_serving.py's), with seeded
    frames for enc-dec."""
    rng = np.random.RandomState(17)
    frng = np.random.default_rng(2)
    jreqs, treqs = [], []
    for i in range(n):
        kw = dict(rid=i, prompt=rng.randint(0, jcfg.vocab_size,
                                            size=(prompt_len,)
                                            ).astype(np.int32),
                  max_new_tokens=max_new,
                  arrival_step=int(i / arrival) if arrival else 0)
        if jcfg.family == "encdec":
            kw["frames"] = frng.standard_normal(
                (jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
        jreqs.append(JS.Request(**kw))
        treqs.append(TS.Request(**kw))
    return jreqs, treqs


def _same_tokens(outs_a, outs_b):
    assert [o.rid for o in outs_a] == [o.rid for o in outs_b]
    for a, b in zip(outs_a, outs_b):
        np.testing.assert_array_equal(np.asarray(a.tokens),
                                      np.asarray(b.tokens))
        assert a.finish_reason == b.finish_reason


@pytest.mark.parametrize("family", list(FAMILIES))
def test_chunked_prefill_matches_reference_and_monolithic(trained, family):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = trained[family]
    jeng = JServeEngine(jmodel, jparams, max_seq=MAX_SEQ, autotune=False)
    teng = ServeEngine(tmodel, tparams, max_seq=MAX_SEQ, device="cpu")
    jreqs, treqs = _requests(jcfg)
    jouts, jstats = jeng.serve(jreqs, num_slots=2, chunk=4, prefill_chunk=5)
    touts, tstats = teng.serve(treqs, num_slots=2, chunk=4, prefill_chunk=5)
    mono, _ = teng.serve(treqs, num_slots=2, chunk=4)
    _same_tokens(touts, jouts)
    _same_tokens(touts, mono)
    for t, j, m in zip(touts, jouts, mono):
        np.testing.assert_allclose(t.logprobs, np.asarray(j.logprobs),
                                   atol=1e-4)
        np.testing.assert_allclose(t.logprobs, m.logprobs, atol=1e-4)
        assert t.admitted_step == j.admitted_step
    assert tstats.prefill_chunks == jstats.prefill_chunks == 4 * 3
    assert tstats.decode_steps == jstats.decode_steps


def test_hybrid_paged_chunked_prefix_hit(trained):
    """A hybrid prefix hit maps its pages while the prompt is scanned in
    full, in chunks: the JAX engine's tokens and pool counters."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = trained["hybrid"]
    jeng = JServeEngine(jmodel, jparams, max_seq=32, autotune=False,
                        paged=JPagedConfig(page_size=4))
    teng = ServeEngine(tmodel, tparams, max_seq=32, device="cpu",
                       paged=PagedConfig(page_size=4))
    jreqs, treqs = _requests(jcfg, prompt_len=14, arrival=0.25)
    for r in jreqs + treqs:
        r.prompt[:9] = jreqs[0].prompt[:9]
    jouts, jstats = jeng.serve(jreqs, num_slots=2, chunk=4, prefill_chunk=4)
    touts, tstats = teng.serve(treqs, num_slots=2, chunk=4, prefill_chunk=4)
    _same_tokens(touts, jouts)
    assert tstats.prefix_hits == jstats.prefix_hits > 0
    assert tstats.prefill_chunks == jstats.prefill_chunks
    assert tstats.kv_bytes_peak == pytest.approx(jstats.kv_bytes_peak)
    teng.pool.check_invariants()


class _StubGraph:
    """Records nothing: each replay runs the captured body again."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


def _stub_step(model, params):
    return G.PromptStep(model, params, MAX_SEQ, "cpu",
                        make_graph=lambda body, pool, gens: (
                            _StubGraph(body), body()),
                        warm_run=lambda body: body())


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-780m"])
def test_prompt_step_from_a_cache_equals_the_whole_scan(arch):
    """``PromptStep.run`` from a given cache continues the scan: a prompt
    run in pieces through the step (and through ``begin_prefill`` /
    ``advance_prefill`` on an engine whose prompt step it is) leaves the
    eager whole-prompt scan's cache and logits to the bit."""
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = build(tcfg)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    eng = ServeEngine(model, params, max_seq=MAX_SEQ, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (1, 11)))
    ecache, elog = eng._scan_prompt(toks)
    step = _stub_step(model, params)
    cache, logits = step.run(toks[:, :4])
    for lo, hi in ((4, 5), (5, 11)):
        cache, logits = step.run(toks[:, lo:hi], cache)
    assert torch.equal(logits, elog)
    for g, e in zip(cache, ecache):
        assert torch.equal(g, e)
    # the engine's chunked prefill through the (stub) captured step
    eng.prompt_graph, eng._prompt_step = True, step
    task = eng.begin_prefill(toks[0].numpy())
    while not task.done:
        eng.advance_prefill(task, 3)
    pf = task.as_prefill()
    assert torch.equal(pf.last_logits, elog)
    for g, e in zip(pf.cache, ecache):
        assert torch.equal(g, e)


def test_encdec_chunks_start_from_the_encoder_seed(trained):
    """An enc-dec task's cache holds the request's cross K/V from the
    start; its chunks equal the whole-prompt prefill (one multi-query step
    against several) within f32 rounding."""
    jcfg, _, _, tcfg, tmodel, tparams = trained["encdec"]
    eng = ServeEngine(tmodel, tparams, max_seq=MAX_SEQ, device="cpu")
    _, treqs = _requests(jcfg, n=1)
    req = treqs[0]
    whole = eng.prefill_request(req.prompt, frames=req.frames)
    task = eng.begin_prefill(req.prompt, frames=req.frames)
    assert torch.equal(task.cache.cross_k, whole.cache.cross_k)
    while not task.done:
        eng.advance_prefill(task, 5)
    pf = task.as_prefill()
    assert int(pf.cache.pos) == len(req.prompt)
    torch.testing.assert_close(pf.last_logits, whole.last_logits,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(pf.cache.k, whole.cache.k, rtol=1e-5,
                               atol=1e-5)
