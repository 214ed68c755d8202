"""MoE serving in the port against the JAX engine, on grok-smoke (4
experts, top 2, f32) trained 40 steps (stable top-1 margins). An MoE
layer's output depends on which tokens share its call, so each path must
route the reference's token set: greedy tokens equal to the JAX engine's,
log-probs within 1e-4 over a bf16 cache and 1e-3 over int8 and int4 KV
(the readings on the CPU: at most 1.4e-4 over int8 and 2.4e-6 over int4),
for

* whole-prompt serves (a prompt routed alone, every slot at a decode
  step);
* a paged pool with prefix hits (the hit's suffix routed alone);
* chunked prefill against the JAX engine's chunked prefill (each chunk
  routed alone);
* spec serves (fused and two-pass int4 self-draft, ngram; a verify window
  routes its B * (k + 1) tokens at once) with ``draft_proposed`` /
  ``draft_accepted`` / ``spec_rounds`` equal to JAX's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig
from repro.configs.registry import get_config as jget_config
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.pool import PagedConfig as JPagedConfig
from repro.serving.quantized import explicit_plan as jexplicit_plan
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import synthetic_stream as jstream
from repro.serving.spec import SpecConfig as JSpecConfig
from repro.train.loop import train
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.models.model import build
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.pool import PagedConfig
from repro_torch.serving.quantized import explicit_plan
from repro_torch.serving.scheduler import Request
from repro_torch.serving.spec import SpecConfig

torch.set_num_threads(2)

LAYERS = ["int8", "int4"]
MAX_SEQ = 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trained_moe():
    """grok-smoke (4 experts, top 2) trained as tests/conftest.py trains
    the dense model (f32, 40 steps, lr 3e-3, batch 8, seq 16)."""
    jcfg, tcfg = (dataclasses.replace(get("grok-1-314b", smoke=True),
                                      dtype="float32")
                  for get in (jget_config, get_config))
    res = train(jcfg, RunConfig(steps=40, learning_rate=3e-3,
                                warmup_steps=3, remat=False), batch=8, seq=16)
    return (jcfg, res["model"], res["params"], tcfg,
            from_jax(_np(res["params"]), device="cpu"))


def _requests(cfg):
    reqs = jstream(6, vocab_size=cfg.vocab_size, prompt_len=8,
                   max_new_tokens=8, arrival_rate=0.5, seed=3)
    return reqs, [Request(rid=r.rid, prompt=r.prompt,
                          max_new_tokens=r.max_new_tokens,
                          arrival_step=r.arrival_step) for r in reqs]


def _shared_prompts(vocab):
    """Four 16-token prompts behind a 12-token common prefix."""
    rng = np.random.default_rng(99)
    prefix = rng.integers(0, vocab, size=12)
    return [np.concatenate([prefix, rng.integers(0, vocab, size=4)]
                           ).astype(np.int32) for _ in range(4)]


def _engines(trained, **kw):
    jcfg, jmodel, jparams, tcfg, tparams = trained
    jkw = dict(kw)
    if "paged" in kw:
        jkw["paged"] = JPagedConfig(page_size=kw["paged"].page_size)
    if "spec" in kw:
        jkw["spec"] = JSpecConfig(**dataclasses.asdict(kw["spec"]))
    jeng = JServeEngine(jmodel, jparams, max_seq=MAX_SEQ,
                        plan=jexplicit_plan(jcfg, LAYERS), autotune=False,
                        **jkw)
    teng = ServeEngine(build(tcfg), tparams, max_seq=MAX_SEQ,
                       plan=explicit_plan(tcfg, LAYERS), device="cpu", **kw)
    return jeng, teng


def _same(touts, jouts, kv):
    """Tokens equal; log-probs within 1e-4 over a bf16 cache, 1e-3 over a
    quantized one: both packages run the same int8/int4 arithmetic, but a
    K/V value one ulp apart across the two frameworks may round to the
    neighbouring level (the largest reading, 1.4e-4, was over int8)."""
    assert [o.rid for o in touts] == [o.rid for o in jouts]
    for t, j in zip(touts, jouts):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        np.testing.assert_allclose(t.logprobs, np.asarray(j.logprobs),
                                   atol=1e-4 if kv == "bf16" else 1e-3)
        assert t.finish_reason == j.finish_reason


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_serve_matches_reference(trained_moe, kv):
    jeng, teng = _engines(trained_moe, kv_precision=kv)
    assert teng.kv_bytes_per_slot() == jeng.kv_bytes_per_slot()
    assert teng.weight_bytes() == pytest.approx(jeng.weight_bytes())
    jreqs, treqs = _requests(trained_moe[0])
    jouts, _ = jeng.serve(jreqs, num_slots=3, chunk=4)
    touts, stats = teng.serve(treqs, num_slots=3, chunk=4)
    assert stats.admissions > 0
    _same(touts, jouts, kv)


def test_paged_prefix_hits_match_reference(trained_moe):
    """Followers of a shared 12-token prefix map its pages and route only
    their 4-token suffix through the experts, as the JAX engine does."""
    jeng, teng = _engines(trained_moe, kv_precision="int8",
                          paged=PagedConfig(page_size=4))
    prompts = _shared_prompts(trained_moe[3].vocab_size)
    jouts, jstats = jeng.serve([JRequest(rid=i, prompt=p, max_new_tokens=6)
                                for i, p in enumerate(prompts)],
                               num_slots=2, chunk=4)
    touts, stats = teng.serve([Request(rid=i, prompt=p, max_new_tokens=6)
                               for i, p in enumerate(prompts)],
                              num_slots=2, chunk=4)
    _same(touts, jouts, "int8")
    assert stats.prefix_hits == jstats.prefix_hits == 3
    for name in ("prefix_hit_tokens", "cow_copies", "pool_pages_peak"):
        assert getattr(stats, name) == getattr(jstats, name), name
    teng.pool.check_invariants()


def test_chunked_prefill_matches_reference(trained_moe):
    """Each 3-token chunk of a prompt is routed on its own: the JAX
    engine's chunked serve, token for token."""
    jeng, teng = _engines(trained_moe, kv_precision="int8")
    jreqs, treqs = _requests(trained_moe[0])
    jouts, jstats = jeng.serve(jreqs, num_slots=3, chunk=4, prefill_chunk=3)
    touts, stats = teng.serve(treqs, num_slots=3, chunk=4, prefill_chunk=3)
    _same(touts, jouts, "int8")
    assert stats.prefill_chunks == jstats.prefill_chunks > 0


SPECS = {"fused": (dict(k=3), "int8"),
         "two-pass": (dict(k=3, fused_propose=False), "int4"),
         "ngram": (dict(k=2, draft_source="ngram"), "int8")}


@pytest.mark.parametrize("draft", sorted(SPECS))
def test_spec_serve_matches_reference(trained_moe, draft):
    """A verify window routes all B * (k + 1) tokens at once; greedy tokens
    and the draft counters equal the JAX spec engine's to the integer."""
    spec, kv = SPECS[draft]
    jeng, teng = _engines(trained_moe, kv_precision=kv,
                          spec=SpecConfig(**spec))
    assert teng.model.supports_fused_propose
    jreqs, treqs = _requests(trained_moe[0])
    jouts, jstats = jeng.serve(jreqs, num_slots=3, chunk=2)
    touts, stats = teng.serve(treqs, num_slots=3, chunk=2)
    _same(touts, jouts, kv)
    assert stats.draft_proposed > 0
    if draft != "ngram":         # the int4 self-draft of the MoE stack
        assert teng.draft_overhead_bytes() == jeng.draft_overhead_bytes()
    assert ((stats.draft_proposed, stats.draft_accepted, stats.spec_rounds)
            == (jstats.draft_proposed, jstats.draft_accepted,
                jstats.spec_rounds))
