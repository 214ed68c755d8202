"""Continuous-batching serving of the port against the JAX reference on a
briefly trained dense SMOKE model (f32): the port's ``serve()`` must emit
the same greedy tokens per request as the reference ``ServeEngine.serve()``
for bf16, int8 and int4 KV caches under the 8bit-mixed plan and for
4bit/8bit with an int8 cache, with requests arriving while others decode.
Training gives stable top-1 margins, so int8/int4 cache noise cannot flip
a token (untrained weights have near-ties)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig
from repro.configs.registry import get_config as jget_config
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.pool import PagedConfig as JPagedConfig
from repro.serving.quantized import plan_for_variant as jplan_for_variant
from repro.serving.sampling import masked_dist as jmasked
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import synthetic_stream as jstream
from repro.train.loop import train
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.models.model import build
from repro_torch.quant.apply import segment_slices
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.pool import OutOfPages, PagedConfig
from repro_torch.serving.quantized import plan_for_variant
from repro_torch.serving.sampling import masked_dist, sample
from repro_torch.serving.scheduler import Request, synthetic_stream

torch.set_num_threads(2)

MAX_SEQ = 32


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
    return cfg, res["model"], res["params"], tcfg, tparams


def _requests(cfg):
    reqs = jstream(6, vocab_size=cfg.vocab_size, prompt_len=8,
                   max_new_tokens=8, arrival_rate=0.5, seed=3)
    mine = [Request(rid=r.rid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens,
                    arrival_step=r.arrival_step) for r in reqs]
    return reqs, mine


@pytest.mark.parametrize("variant,kv,slots", [
    ("8bit-mixed", "bf16", 2), ("8bit-mixed", "int8", 3),
    ("8bit-mixed", "int4", 4), ("4bit/8bit", "int8", 2)])
def test_serve_greedy_tokens_match_reference(trained_dense, variant, kv,
                                             slots):
    jcfg, jmodel, jparams, tcfg, tparams = trained_dense
    tmodel = build(tcfg)
    jplan = jplan_for_variant(jmodel, jparams, variant)
    tplan = plan_for_variant(tmodel, tparams, variant)
    assert tplan.precisions() == jplan.precisions()
    jeng = JServeEngine(jmodel, jparams, max_seq=MAX_SEQ, plan=jplan,
                        kv_precision=kv, autotune=False)
    teng = ServeEngine(tmodel, tparams, max_seq=MAX_SEQ, plan=tplan,
                       kv_precision=kv, device="cpu")
    assert teng.kv_bytes_per_slot() == jeng.kv_bytes_per_slot()
    assert teng.weight_bytes() == pytest.approx(jeng.weight_bytes())
    jreqs, treqs = _requests(jcfg)
    jouts, _ = jeng.serve(jreqs, num_slots=slots, chunk=4)
    touts, stats = teng.serve(treqs, num_slots=slots, chunk=4)
    assert stats.admissions > 0            # admissions while others decode
    assert [o.rid for o in touts] == [o.rid for o in jouts]
    for t, j in zip(touts, jouts):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        np.testing.assert_allclose(t.logprobs, np.asarray(j.logprobs),
                                   atol=1e-2)
        assert t.finish_reason == j.finish_reason


def test_generate_matches_serve(trained_dense):
    """One fixed batch through ``generate`` gives the serve loop's tokens."""
    _, _, _, tcfg, tparams = trained_dense
    eng = ServeEngine(build(tcfg), tparams, max_seq=MAX_SEQ,
                      kv_precision="int8", device="cpu")
    reqs = synthetic_stream(2, vocab_size=tcfg.vocab_size, prompt_len=8,
                            max_new_tokens=8, seed=5)
    for r in reqs:
        r.max_new_tokens = 6
    outs, _ = eng.serve(reqs, num_slots=2, chunk=3)
    res = eng.generate(np.stack([r.prompt for r in reqs]), 6, chunk=3)
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(res.tokens[i].numpy(), o.tokens)


def test_masked_dist_matches_reference():
    """Sampling cannot reproduce JAX's random bits, so the sampled path is
    held to the reference through the distribution it samples from."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 50)).astype(np.float32) * 3
    lp = np.array(jax.nn.log_softmax(logits, -1))
    temp = np.array([0.0, 0.7, 1.0, 1.3], np.float32)
    top_k = np.array([0, 5, 0, 1], np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 0.5], np.float32)
    want = np.asarray(jmasked(lp, temp, top_k, top_p))
    got = masked_dist(torch.from_numpy(lp), torch.from_numpy(temp),
                      torch.from_numpy(top_k), torch.from_numpy(top_p)).numpy()
    kept = want > -1e29
    np.testing.assert_array_equal(got > -1e29, kept)
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-5, atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    toks = sample(gen, torch.from_numpy(got), torch.from_numpy(temp)).numpy()
    # row 0 is greedy and row 3 keeps only its top token
    assert toks[0] == lp[0].argmax() and toks[3] == lp[3].argmax()
    assert all(kept[i, t] for i, t in enumerate(toks))


# ---------------------------------------------------------------------------
# the paged KV pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_paged_serve_matches_reference_and_dense(trained_dense, kv):
    """Paged serve (pages of 4, the equal-memory pool, prefix sharing on)
    under the 8bit-mixed plan (a bf16 pool splits at the segment cuts):
    the JAX paged engine's greedy tokens and pool stats, and the port's
    dense tokens (int8/int4 logprobs to the bit)."""
    jcfg, jmodel, jparams, tcfg, tparams = trained_dense
    tmodel = build(tcfg)
    jplan = jplan_for_variant(jmodel, jparams, "8bit-mixed")
    tplan = plan_for_variant(tmodel, tparams, "8bit-mixed")
    jeng = JServeEngine(jmodel, jparams, max_seq=MAX_SEQ, plan=jplan,
                        kv_precision=kv, autotune=False,
                        paged=JPagedConfig(page_size=4))
    teng, dense = (ServeEngine(tmodel, tparams, max_seq=MAX_SEQ, plan=tplan,
                               kv_precision=kv, device="cpu", paged=paged)
                   for paged in (PagedConfig(page_size=4), None))
    jreqs, treqs = _requests(jcfg)
    jouts, jstats = jeng.serve(jreqs, num_slots=3, chunk=4)
    touts, stats = teng.serve(treqs, num_slots=3, chunk=4)
    douts, _ = dense.serve(treqs, num_slots=3, chunk=4)
    for t, j, d in zip(touts, jouts, douts):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        np.testing.assert_array_equal(t.tokens, d.tokens)
        np.testing.assert_allclose(t.logprobs, np.asarray(j.logprobs),
                                   atol=1e-2)
        if kv == "bf16":     # dense attends a raw cache, paged the kernel's
            np.testing.assert_allclose(t.logprobs, d.logprobs, atol=1e-4)
        else:
            np.testing.assert_array_equal(t.logprobs, d.logprobs)
    for name in ("pool_pages_total", "pool_pages_peak", "pool_page_size",
                 "prefix_hits", "prefix_hit_tokens", "cow_copies"):
        assert getattr(stats, name) == getattr(jstats, name), name
    assert stats.kv_bytes_peak == jstats.kv_bytes_peak
    teng.pool.check_invariants()
    # one pool per parameter segment, as the reference cuts them
    k = teng.init_decode_state(1).cache.k
    jk = jeng.init_decode_state(1).cache.k
    assert len(k if isinstance(k, tuple) else (k,)) \
        == len(jk if isinstance(jk, tuple) else (jk,)) \
        == len(segment_slices(teng.params["layers"]))


def _shared_requests(vocab, scenario):
    """test_paged.py's prefix scenarios with numpy-seeded tokens: four
    16-token prompts behind a 12-token common prefix, or three identical
    16-token prompts (the COW boundary page)."""
    rng = np.random.default_rng(99)
    if scenario == "shared-prefix":
        prefix = rng.integers(0, vocab, size=12)
        prompts = [np.concatenate([prefix, rng.integers(0, vocab, size=4)])
                   for _ in range(4)]
    else:
        prompts = [rng.integers(0, vocab, size=16)] * 3
    return [np.asarray(p, np.int32).copy() for p in prompts]


@pytest.mark.parametrize("scenario,kv", [("shared-prefix", "bf16"),
                                         ("cow", "bf16"), ("cow", "int8")])
def test_prefix_sharing_matches_reference(trained_dense, scenario, kv):
    """Followers map the shared pages, seed their prefill from the pool
    and run only the suffix; hits, hit tokens and COW copies equal the
    JAX engine's, and so do the greedy tokens."""
    jcfg, jmodel, jparams, tcfg, tparams = trained_dense
    prompts = _shared_requests(tcfg.vocab_size, scenario)
    jeng = JServeEngine(jmodel, jparams, max_seq=24, kv_precision=kv,
                        autotune=False, paged=JPagedConfig(page_size=4))
    teng = ServeEngine(build(tcfg), tparams, max_seq=24, kv_precision=kv,
                       device="cpu", paged=PagedConfig(page_size=4))
    jouts, jstats = jeng.serve([JRequest(rid=i, prompt=p, max_new_tokens=6)
                                for i, p in enumerate(prompts)],
                               num_slots=2, chunk=4)
    touts, stats = teng.serve([Request(rid=i, prompt=p, max_new_tokens=6)
                               for i, p in enumerate(prompts)],
                              num_slots=2, chunk=4)
    for t, j in zip(touts, jouts):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        np.testing.assert_allclose(t.logprobs, np.asarray(j.logprobs),
                                   atol=1e-2)
    for name in ("prefix_hits", "prefix_hit_tokens", "cow_copies",
                 "prefix_hit_rate", "pool_pages_peak"):
        assert getattr(stats, name) == getattr(jstats, name), name
    if scenario == "cow":
        assert stats.cow_copies == 2 and stats.prefix_hit_tokens == 2 * 15
    else:
        assert stats.prefix_hits == 3 and stats.prefix_hit_tokens == 3 * 12
    teng.pool.check_invariants()


def test_pool_backpressure_and_impossible_request(trained_dense):
    """A pool of 7 pages of 4 tokens cannot hold 4 slots of 3 pages: the
    serve requeues, completes with the dense engine's tokens and returns
    every page; a request no empty pool can hold raises OutOfPages."""
    _, _, _, tcfg, tparams = trained_dense
    model = build(tcfg)
    reqs = synthetic_stream(4, vocab_size=tcfg.vocab_size, prompt_len=6,
                            max_new_tokens=6, seed=11)
    for r in reqs:
        r.max_new_tokens = 6
    dense = ServeEngine(model, tparams, max_seq=24, device="cpu")
    paged = ServeEngine(model, tparams, max_seq=24, device="cpu",
                        paged=PagedConfig(page_size=4, pool_pages=7,
                                          prefix_sharing=False))
    douts, _ = dense.serve(reqs, num_slots=4, chunk=4)
    pouts, stats = paged.serve(reqs, num_slots=4, chunk=4)
    for p, d in zip(pouts, douts):
        np.testing.assert_array_equal(p.tokens, d.tokens)
    assert stats.requeues > 0 and stats.pool_pages_peak <= 7
    assert paged.pool.pages_in_use == 0
    paged.pool.check_invariants()
    tiny = ServeEngine(model, tparams, max_seq=24, device="cpu",
                       paged=PagedConfig(page_size=4, pool_pages=2,
                                         prefix_sharing=False))
    with pytest.raises(OutOfPages, match="deadlock"):
        tiny.serve(reqs[:1], num_slots=2, chunk=4)


def test_kv_bytes_allocated_matches_reference(trained_dense):
    """The dense engine reserves every slot up front; the paged one charges
    the pages referenced now: 0 once drained, one request's pages mid
    flight. Both as the JAX engine counts them."""
    jcfg, jmodel, jparams, tcfg, tparams = trained_dense
    nosh = dict(page_size=4, prefix_sharing=False)
    jd = JServeEngine(jmodel, jparams, max_seq=24, autotune=False)
    jp = JServeEngine(jmodel, jparams, max_seq=24, autotune=False,
                      paged=JPagedConfig(**nosh))
    td = ServeEngine(build(tcfg), tparams, max_seq=24, device="cpu")
    tp = ServeEngine(build(tcfg), tparams, max_seq=24, device="cpu",
                     paged=PagedConfig(**nosh))
    assert td.kv_bytes_allocated(4) == jd.kv_bytes_allocated(4) \
        == 4 * td.kv_bytes_per_slot()
    prompt = _requests(jcfg)[1][0].prompt
    tp.serve([Request(rid=0, prompt=prompt, max_new_tokens=6)],
             num_slots=2, chunk=4)
    assert tp.kv_bytes_allocated(2) == 0.0
    jstate, tstate = jp.init_decode_state(2), tp.init_decode_state(2)
    jp.insert(jstate, 0, jp.prefill_request(prompt, state=jstate), 6)
    tp.insert(tstate, 0, tp.prefill_request(prompt, tstate), 6)
    used = tp.kv_bytes_allocated(2)
    assert used == jp.kv_bytes_allocated(2) == tp.pool.pages_in_use \
        * tp._page_bytes
    assert 0.0 < used < td.kv_bytes_allocated(2)
    tp.release(tstate, 0)
    assert tp.kv_bytes_allocated(2) == 0.0
    assert torch.all(tstate.cache.k.table[:, 0] == 0)
