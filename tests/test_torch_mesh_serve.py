"""Mesh-parallel serving of the port held to the JAX package's mesh-less
engine on the CPU.

The f32 dense SMOKE model (2 layers) under the FastEWQ 4bit/8bit metadata
plan serves through the port's ``ServeEngine(mesh=(1, 2))``, its heads,
d_ff and vocab rows split over two "model" positions, with bf16 and int8
KV; the greedy tokens must equal those of the JAX ``ServeEngine`` without a
mesh on the bridged params, with logprobs within 1e-4 (the reference's own
tolerance for its sharded serve). A variant with 4 KV heads serves at
(1, 4), where each position holds under half the weight bytes. The groups
(weights 32 or 64, KV 32) are ones every shard holds whole: the port
refuses a shard that would split a quantization group
(``test_torch_sharding.py``).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models.model import build as jbuild
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.quantized import fastewq_metadata_plan as jfastewq
from repro.serving.scheduler import Request as JRequest
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import build
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.quantized import fastewq_metadata_plan
from repro_torch.serving.scheduler import Request
from repro_torch.sharding import collective

torch.set_num_threads(2)

MAX_SEQ = 24


def _mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, devices=["cpu"])


def _setup(**over):
    """(JAX model, JAX params, port model, port params) of the f32 SMOKE
    llama with 2 layers, the same weights on both sides."""
    jcfg = dataclasses.replace(jget_config("llama3.2-3b", smoke=True),
                               dtype="float32", num_layers=2, **over)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True),
                               dtype="float32", num_layers=2, **over)
    return (jmodel, jparams, build(tcfg),
            from_jax(jax.tree.map(np.asarray, jparams), "cpu"))


def _requests(vocab, n=3):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, size=6 + i, dtype=np.int32)
               for i in range(n)]
    return ([JRequest(rid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)],
            [Request(rid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)])


def _agree(outs, ref_outs, atol=1e-4):
    assert len(outs) == len(ref_outs)
    for a, b in zip(outs, ref_outs):
        assert a.rid == b.rid
        np.testing.assert_array_equal(np.asarray(a.tokens),
                                      np.asarray(b.tokens))
        np.testing.assert_allclose(np.asarray(a.logprobs),
                                   np.asarray(b.logprobs), atol=atol)


@pytest.fixture(scope="module")
def dense():
    return _setup()


@pytest.fixture(scope="module")
def dense_kv4():
    return _setup(num_kv_heads=4)


@pytest.fixture(scope="module")
def jax_serves(dense, dense_kv4):
    """The JAX mesh-less serves, one per (model, KV precision)."""
    out = {}
    for name, (jmodel, jparams, _, _), group in (
            ("kv2", dense, 64), ("kv4", dense_kv4, 32)):
        plan = jfastewq(jmodel.cfg, "4bit/8bit")
        jreqs, _ = _requests(jmodel.cfg.vocab_size)
        for kv in ("bf16", "int8"):
            if name == "kv4" and kv == "bf16":
                continue
            eng = JServeEngine(jmodel, jparams, max_seq=MAX_SEQ, plan=plan,
                               group=group, kv_precision=kv, kv_group=32,
                               autotune=False)
            out[name, kv] = eng.serve(jreqs, num_slots=2, chunk=4)[0]
    return out


def _port_engine(model, params, mesh, group, kv="int8", **kw):
    return ServeEngine(model, params, max_seq=MAX_SEQ,
                       plan=fastewq_metadata_plan(model.cfg, "4bit/8bit"),
                       group=group, kv_precision=kv, kv_group=32,
                       device="cpu", mesh=mesh, **kw)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_tp2_serve_matches_jax_meshless(dense, jax_serves, kv):
    _, _, model, params = dense
    eng = _port_engine(model, params, _mesh((1, 2)), 64, kv)
    _, reqs = _requests(model.cfg.vocab_size)
    outs, stats = eng.serve(reqs, num_slots=2, chunk=4)
    _agree(outs, jax_serves["kv2", kv])
    assert stats.generated_tokens == 15


def test_tp4_serve_matches_jax_meshless_and_shrinks_weights(dense_kv4,
                                                            jax_serves):
    _, _, model, params = dense_kv4
    eng = _port_engine(model, params, _mesh((1, 4)), 32)
    _, reqs = _requests(model.cfg.vocab_size)
    outs, _ = eng.serve(reqs, num_slots=2, chunk=4)
    _agree(outs, jax_serves["kv4", "int8"])
    single = _port_engine(model, params, None, 32)
    assert eng.weight_bytes() == pytest.approx(single.weight_bytes())
    per_dev, whole = eng.weight_bytes_per_device(), \
        single.weight_bytes_per_device()
    assert per_dev < 0.5 * whole, (per_dev, whole)


def test_tp_chunked_prefill_and_generate(dense, jax_serves):
    """Chunked prefill (one multi-query decode step per chunk over each
    position's cache) and ``generate`` over the sharded engine."""
    _, _, model, params = dense
    eng = _port_engine(model, params, _mesh((1, 2)), 64)
    _, reqs = _requests(model.cfg.vocab_size)
    outs, stats = eng.serve(reqs, num_slots=2, chunk=4, prefill_chunk=3)
    assert stats.prefill_chunks > 0
    _agree(outs, jax_serves["kv2", "int8"])
    single = _port_engine(model, params, None, 64)
    prompts = np.stack([r.prompt[:6] for r in reqs])
    a, b = eng.generate(prompts, 4), single.generate(prompts, 4)
    assert torch.equal(a.tokens, b.tokens)
    torch.testing.assert_close(a.logprobs, b.logprobs, atol=1e-4, rtol=0)


def test_dropped_shard_partial_fails_the_comparison(dense, jax_serves,
                                                    monkeypatch):
    """A planted fault: the position sum loses its last position's
    partial (embedding lookup, attention and MLP outputs)."""
    _, _, model, params = dense
    eng = _port_engine(model, params, _mesh((1, 2)), 64)
    real = collective.reduce_sum
    monkeypatch.setattr(collective, "reduce_sum",
                        lambda parts, device: real(parts[:-1], device))
    _, reqs = _requests(model.cfg.vocab_size)
    outs, _ = eng.serve(reqs, num_slots=2, chunk=4)
    with pytest.raises(AssertionError):
        _agree(outs, jax_serves["kv2", "int8"])


def test_refused_layouts_raise(dense):
    _, _, model, params = dense
    # 2 KV heads over 4 positions would split a head
    with pytest.raises(ValueError, match="would split a head.*ROADMAP"):
        _port_engine(model, params, _mesh((1, 4)), 32)
    # the paged pool and spec rounds over several positions
    from repro_torch.serving.spec import SpecConfig
    with pytest.raises(ValueError, match="paged pool.*ROADMAP"):
        _port_engine(model, params, _mesh((1, 2)), 64, paged=True)
    with pytest.raises(ValueError, match="speculative rounds.*ROADMAP"):
        _port_engine(model, params, _mesh((2, 1)), 64, spec=SpecConfig(k=2))
    # a KV scale group that straddles two positions' heads
    with pytest.raises(ValueError, match="straddle"):
        ServeEngine(model, params, max_seq=MAX_SEQ, kv_precision="int8",
                    kv_group=64, device="cpu", mesh=_mesh((1, 2)))
    # a CPU mesh for an engine on the card: never a fallback
    with pytest.raises(ValueError, match="every position must be"):
        ServeEngine(model, params, max_seq=MAX_SEQ, mesh=_mesh((1, 2)))
    # the SSM family with a model axis
    cfg = dataclasses.replace(get_config("mamba2-780m", smoke=True),
                              dtype="float32")
    ssm = build(cfg)
    with pytest.raises(ValueError, match="ssm family.*ROADMAP"):
        ServeEngine(ssm, ssm.init(torch.Generator().manual_seed(0), "cpu"),
                    max_seq=MAX_SEQ, device="cpu", mesh=_mesh((1, 2)))


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_data_only_mesh_serves_recurrent_families(arch):
    """A (2, 1) mesh replicates the weights and splits the slots over two
    data rows: token-identical to the single engine."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    _, reqs = _requests(cfg.vocab_size, n=4)
    kw = dict(max_seq=MAX_SEQ, kv_precision="int8", device="cpu")
    ref, _ = ServeEngine(model, params, **kw).serve(reqs, num_slots=2,
                                                    chunk=4)
    eng = ServeEngine(model, params, mesh=_mesh((2, 1)), **kw)
    outs, _ = eng.serve(reqs, num_slots=2, chunk=4)
    _agree(outs, ref, atol=1e-5)
    assert eng.weight_bytes_per_device() == pytest.approx(
        ServeEngine(model, params, **kw).weight_bytes_per_device())
