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
from repro.serving.quantized import plan_for_variant as jplan_for_variant
from repro.serving.sampling import masked_dist as jmasked
from repro.serving.scheduler import synthetic_stream as jstream
from repro.train.loop import train
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.models.model import build
from repro_torch.serving.engine import ServeEngine
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
    tparams = from_jax(jax.tree.map(np.asarray, res["params"]))
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
