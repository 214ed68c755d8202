"""Enc-dec (whisper) serving over the paged KV pool and with speculative
decoding, in the port against the JAX engine, on the whisper SMOKE model
trained as tests/conftest.py's ``trained`` fixture trains its enc-dec model
(f32, 40 steps, lr 3e-3, batch 8, seq 16; greedy tokens are compared only
on trained weights). Tolerances are the reference's own: greedy tokens
equal, log-probs within 1e-4 over a bf16 cache and between the port's
paged and dense engines (tests/test_paged.py), within 1e-2 across the two
packages over an int8 cache (README.md).

* paged: the self-attention K/V in the pool, the cross K/V a dense field
  per slot (quantized per the KV plan); pool stats and ``kv_bytes_peak``
  equal to the JAX engine's; a prefix hit maps the shared pages but still
  prefills the whole prompt (the frames are needed);
* spec: the int4 self-draft (two-pass propose on a cache clone that keeps
  the slot's cross K/V) and the ngram draft, dense and paged, with the
  draft counters equal to the JAX engine's to the integer.
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
from repro.serving.scheduler import Request as JRequest
from repro.serving.spec import SpecConfig as JSpecConfig
from repro.train.loop import train
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.models.model import build
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.pool import PagedConfig
from repro_torch.serving.scheduler import Request
from repro_torch.serving.spec import SpecConfig

torch.set_num_threads(2)

MAX_SEQ = 32
PAGE = 4


@pytest.fixture(scope="module")
def whisper():
    jcfg = dataclasses.replace(jget_config("whisper-medium", smoke=True),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("whisper-medium", smoke=True),
                               dtype="float32")
    res = train(jcfg, RunConfig(steps=40, learning_rate=3e-3,
                                warmup_steps=3, remat=False), batch=8, seq=16)
    return (jcfg, res["model"], res["params"], tcfg,
            from_jax(jax.tree.map(np.asarray, res["params"]), device="cpu"))


def _requests(cfg, shared: bool = False):
    """Four requests with seeded frames, arriving while others decode;
    ``shared``: all behind one 8-token prefix (two full pages)."""
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, cfg.vocab_size, size=8)
    out = []
    for i, plen in enumerate((4, 7, 5, 9)):
        prompt = rng.integers(0, cfg.vocab_size, size=(plen,))
        if shared:
            prompt = np.concatenate([prefix, prompt[:3]])
        out.append(dict(rid=i, prompt=prompt.astype(np.int32),
                        max_new_tokens=6, arrival_step=2 * i,
                        frames=rng.standard_normal(
                            (cfg.encoder_seq, cfg.d_model)
                        ).astype(np.float32)))
    return ([JRequest(**r) for r in out], [Request(**r) for r in out])


def _engines(whisper, kv, **kw):
    jcfg, jmodel, jparams, tcfg, tparams = whisper
    jkw = {}
    if kw.get("paged") is not None:
        jkw["paged"] = JPagedConfig(page_size=kw["paged"].page_size)
    if kw.get("spec") is not None:
        jkw["spec"] = JSpecConfig(**dataclasses.asdict(kw["spec"]))
    jeng = JServeEngine(jmodel, jparams, max_seq=MAX_SEQ, kv_precision=kv,
                        autotune=False, **jkw)
    teng = ServeEngine(build(tcfg), tparams, max_seq=MAX_SEQ,
                       kv_precision=kv, device="cpu", **kw)
    return jeng, teng


def _same(touts, jouts, atol):
    assert [o.rid for o in touts] == [o.rid for o in jouts]
    for t, j in zip(touts, jouts):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        np.testing.assert_allclose(t.logprobs, np.asarray(j.logprobs),
                                   atol=atol)
        assert t.finish_reason == j.finish_reason


ATOL = {"bf16": 1e-4, "int8": 1e-2}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_serve_matches_reference_and_dense(whisper, kv):
    jeng, teng = _engines(whisper, kv, paged=PagedConfig(page_size=PAGE))
    dense = _engines(whisper, kv)[1]
    jreqs, treqs = _requests(whisper[0])
    jouts, jstats = jeng.serve(jreqs, num_slots=2, chunk=4)
    touts, stats = teng.serve(treqs, num_slots=2, chunk=4)
    douts, _ = dense.serve(treqs, num_slots=2, chunk=4)
    _same(touts, jouts, ATOL[kv])
    _same(touts, douts, 1e-4 if kv == "bf16" else 0.0)
    for name in ("pool_pages_total", "pool_pages_peak", "pool_page_size",
                 "kv_bytes_peak"):
        assert getattr(stats, name) == getattr(jstats, name), name
    # the cross K/V stay outside the pool, at the dense slot's bytes
    by_field = teng.kv_bytes_by_field()
    assert teng._nonpaged_bytes_per_slot() == \
        by_field["cross_k"] + by_field["cross_v"] > 0
    assert teng.kv_bytes_allocated(2) == jeng.kv_bytes_allocated(2)
    teng.pool.check_invariants()


def test_prefix_hit_maps_pages_and_prefills_in_full(whisper):
    """The followers' two shared prefix pages are mapped (hits and hit
    tokens equal to the JAX engine's), and each prompt still runs whole,
    its frames through the encoder."""
    jeng, teng = _engines(whisper, "int8", paged=PagedConfig(page_size=PAGE))
    jreqs, treqs = _requests(whisper[0], shared=True)
    seeded = []
    teng._seed_prefill = lambda *a: seeded.append(a)   # must not be taken
    jouts, jstats = jeng.serve(jreqs, num_slots=2, chunk=4)
    touts, stats = teng.serve(treqs, num_slots=2, chunk=4)
    _same(touts, jouts, ATOL["int8"])
    assert stats.prefix_hits == jstats.prefix_hits > 0
    assert stats.prefix_hit_tokens == jstats.prefix_hit_tokens
    assert seeded == []
    teng.pool.check_invariants()


@pytest.mark.parametrize("paged", [None, PAGE])
@pytest.mark.parametrize("draft", ["model", "ngram"])
def test_spec_serve_matches_reference(whisper, draft, paged):
    """Greedy spec serves equal the JAX spec engine's tokens and the port's
    non-spec tokens; proposed / accepted / rounds equal to the integer."""
    pc = None if paged is None else PagedConfig(page_size=paged)
    spec = SpecConfig(k=3, draft_source=draft)
    jeng, teng = _engines(whisper, "int8", spec=spec, paged=pc)
    base = _engines(whisper, "int8")[1]
    assert not teng.model.supports_fused_propose     # two-pass propose
    jreqs, treqs = _requests(whisper[0])
    jouts, jstats = jeng.serve(jreqs, num_slots=2, chunk=2)
    touts, stats = teng.serve(treqs, num_slots=2, chunk=2)
    bouts, _ = base.serve(treqs, num_slots=2, chunk=2)
    _same(touts, jouts, ATOL["int8"])
    for t, b in zip(touts, bouts):
        np.testing.assert_array_equal(t.tokens, b.tokens)
    assert stats.draft_proposed > 0
    assert ((stats.draft_proposed, stats.draft_accepted, stats.spec_rounds)
            == (jstats.draft_proposed, jstats.draft_accepted,
                jstats.spec_rounds))
    if draft == "model":
        assert teng.draft_overhead_bytes() == jeng.draft_overhead_bytes()
    if pc is not None:
        teng.pool.check_invariants()
