"""The port's MoE family (grok-1, arctic) against the JAX package on the
SMOKE configs (f32), the same numpy-seeded inputs through both:

* ``moe_block`` on one layer's raw, int8 and int4 experts (router
  included), at capacity factors 8.0 (no drop) and 0.25 (drops): output
  and aux loss within 1e-5; ``capacity_of`` on the reference's cases; the
  top-k tie order of ``jax.lax.top_k``;
* the model's logits from ``apply`` (raw and an explicit int8/int4 plan,
  1e-4) and teacher-forced decode steps over bf16 (1e-4) and int8 KV
  (log-probs 1e-3: both packages run the same int8 arithmetic, and the
  readings on the CPU were at most 3.8e-6);
* the analysis (each expert stack one matrix) and the EWQ plans;
* the bridge, and compiled-plan artifacts written by either package booted
  by the other, leaves to the bit.

Serving is held to the JAX engine in tests/test_torch_moe_serve.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core import entropy as JE
from repro.core.planner import plan_model as jplan_model
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.models.model import build as jbuild
from repro.quant.compiler import compile_kv_plan as jcompile_kv_plan
from repro.quant.compiler import compile_plan as jcompile_plan
from repro.quant.compiler import load_artifact as jload_artifact
from repro.quant.compiler import save_artifact as jsave_artifact
from repro.quant.kvcache import quantize_model_cache as jquantize_cache
from repro.quant.quantize import quantize as jquantize
from repro.serving.quantized import explicit_plan as jexplicit_plan
from repro_torch.bridge import from_jax
from repro_torch.checkpoint.ckpt import flatten_with_paths
from repro_torch.configs.registry import get_config
from repro_torch.core import entropy as TE
from repro_torch.core.planner import plan_model
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.models.model import build
from repro_torch.quant.apply import SegmentedParams
from repro_torch.quant.compiler import (compile_kv_plan, compile_plan,
                                        load_artifact, save_artifact)
from repro_torch.quant.kvcache import quantize_model_cache
from repro_torch.quant.qtypes import QTensor
from repro_torch.serving.quantized import explicit_plan

torch.set_num_threads(2)

ARCHS = ("grok-1-314b", "arctic-480b")
LAYERS = ["int8", "int4"]
MAX_SEQ = 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch):
    return (dataclasses.replace(jget_config(arch, smoke=True),
                                dtype="float32"),
            dataclasses.replace(get_config(arch, smoke=True),
                                dtype="float32"))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [(64, 4, 2, 1.0), (64, 4, 2, 1.25),
                                  (3, 4, 1, 1.0), (4, 8, 2, 1.25),
                                  (20, 128, 2, 1.25), (1, 8, 2, 0.25)])
def test_capacity_of_matches_reference(case):
    assert TMOE.capacity_of(*case) == JMOE.capacity_of(*case)


def test_top_k_breaks_ties_as_jax():
    """Rows with tied values: the lower index comes first, as in
    ``jax.lax.top_k``."""
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4], [0.5, 0.1, 0.3, 0.1]],
                     np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = TMOE.top_k_lower_first(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _layer_params(jcfg, precision):
    """One layer's MoE params in the reference's layout, quantized (router
    included, as a quantized stack quantizes it) unless raw."""
    p = JMOE.init_moe_params(jax.random.PRNGKey(3), jcfg.d_model,
                             jcfg.expert_d_ff, jcfg.num_experts, 1,
                             jnp.float32)
    if precision != "raw":
        p = {k: jquantize(v, precision, 128) for k, v in p.items()}
    return p


@pytest.mark.parametrize("cf", [8.0, 0.25])
@pytest.mark.parametrize("precision", ["raw", "int8", "int4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, precision, cf):
    jcfg, _ = _cfgs(arch)
    jp = _layer_params(jcfg, precision)
    tp = from_jax(_np(jp), device="cpu")
    if precision != "raw":
        assert isinstance(tp["router"], QTensor)
    x = np.random.default_rng(7).standard_normal(
        (2, 64, jcfg.d_model)).astype(np.float32)
    kw = dict(num_experts=jcfg.num_experts, top_k=jcfg.top_k,
              capacity_factor=cf)
    jy, jaux = JMOE.moe_block(jp, jnp.asarray(x), **kw)
    ty, taux = TMOE.moe_block(tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux["moe_aux_loss"]),
                               float(jaux["moe_aux_loss"]), rtol=1e-5,
                               atol=1e-5)
    # at 0.25 the slots cannot hold every assignment: drops are certain
    slots = TMOE.capacity_of(128, jcfg.num_experts, jcfg.top_k,
                             cf) * jcfg.num_experts
    assert (slots < 128 * jcfg.top_k) == (cf < 1)


def test_expert_chunks_equal_one_pass(monkeypatch):
    """Dequantizing the experts a few at a time (the transient budget)
    gives the one-pass result to the bit."""
    jcfg, _ = _cfgs("arctic-480b")
    tp = from_jax(_np(_layer_params(jcfg, "int4")), device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 24, jcfg.d_model)).astype(np.float32))
    kw = dict(num_experts=jcfg.num_experts, top_k=jcfg.top_k)
    whole, _ = TMOE.moe_block(tp, x, **kw)
    per = jcfg.expert_d_ff * jcfg.d_model * 4
    monkeypatch.setattr(TMOE, "EXPERT_BYTES", 3 * per)   # 3, 3, 2 experts
    assert TMOE._experts_per_chunk(tp["w_gate"], torch.float32) == 3
    chunked, _ = TMOE.moe_block(tp, x, **kw)
    assert torch.equal(whole, chunked)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        jmodel = jbuild(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(1))
        out[arch] = (jcfg, tcfg, jmodel, jparams,
                     from_jax(_np(jparams), device="cpu"))
    return out


def _compiled(m, plan_name):
    jcfg, tcfg, jmodel, jparams, tparams = m
    if plan_name == "raw":
        return None, None, jparams, tparams
    jplan, tplan = jexplicit_plan(jcfg, LAYERS), explicit_plan(tcfg, LAYERS)
    return (jplan, tplan, jcompile_plan(jmodel, jparams, jplan).params,
            build(tcfg).compile_plan(tparams, tplan).params)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("plan_name", ["raw", "explicit"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_decode_steps_match_reference(models, arch, plan_name,
                                                 kv):
    jcfg, tcfg = models[arch][:2]
    jplan, tplan, jp, tp = _compiled(models[arch], plan_name)
    if jplan is not None:
        assert isinstance(tp["layers"], SegmentedParams)
        router = tp["layers"].segments[0].params["moe"]["router"]
        assert isinstance(router, QTensor) and router.precision == "int8"
    b, p, steps = 2, 10, 5
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, tcfg.vocab_size, size=(b, p)).astype(np.int32)
    feed = rng.integers(0, tcfg.vocab_size, size=(b, steps)).astype(np.int32)
    jlogits, _, jcache = JT.apply(jp, jnp.asarray(prompts), jcfg, remat=False,
                                  return_cache=True)
    tlogits, tcache = TT.apply(tp, torch.from_numpy(prompts).long(), tcfg,
                               return_cache=True)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    pad = ((0, 0), (0, 0), (0, MAX_SEQ - p), (0, 0), (0, 0))
    jcache = jcache._replace(k=jnp.pad(jcache.k, pad),
                             v=jnp.pad(jcache.v, pad),
                             pos=jnp.full((b,), p, jnp.int32))
    tpad = (0, 0, 0, 0, 0, MAX_SEQ - p)
    tcache = tcache._replace(k=torch.nn.functional.pad(tcache.k, tpad),
                             v=torch.nn.functional.pad(tcache.v, tpad),
                             pos=torch.full((b,), p, dtype=torch.int32))
    if kv != "bf16":
        cuts = (1,) if jplan is not None else ()
        jcache = jquantize_cache(jcache, jcompile_kv_plan(jcfg, jplan, kv),
                                 cuts, ("k", "v"))
        tcache = quantize_model_cache(tcache, compile_kv_plan(tcfg, tplan, kv),
                                      cuts, ("k", "v"))
    jstep = jax.jit(lambda pp, c, t: JT.decode_step(pp, c, t, jcfg))
    for t in range(steps):
        tok = feed[:, t:t + 1]
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok))
        tl, tcache = TT.decode_step(tp, tcache, torch.from_numpy(tok).long(),
                                    tcfg)
        if kv == "bf16":
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                       atol=1e-4)
        else:
            np.testing.assert_allclose(
                torch.log_softmax(tl, -1).numpy(),
                np.asarray(jax.nn.log_softmax(jl, -1)), atol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_analysis_and_plans_match_reference(models, arch):
    """Each layer block's expert stacks are single 3-D matrices of the
    analysis: kernel mode (one grouped call; the plain version on the CPU)
    within 1e-5 of the reference's stream mode, matrix by matrix, and the
    EWQ plans equal to the reference's."""
    jcfg, tcfg, jmodel, jparams, tparams = models[arch]
    tmodel = build(tcfg)
    jblocks = JE.analyze_blocks(jmodel.block_params(jparams), mode="stream")
    tblocks = TE.analyze_blocks(tmodel.block_params(tparams), mode="kernel")
    assert [b.num_parameters for b in tblocks] == \
        [b.num_parameters for b in jblocks]
    for tb, jb in zip(tblocks, jblocks):
        assert tb.per_matrix.keys() == jb.per_matrix.keys()
        for name, (h, size) in tb.per_matrix.items():
            assert size == jb.per_matrix[name][1]
            assert h == pytest.approx(jb.per_matrix[name][0], abs=1e-5)
    assert tblocks[1].per_matrix["moe.w_gate"][1] == \
        tcfg.num_experts * tcfg.expert_d_ff * tcfg.d_model
    for variant in ("4bit/8bit", "8bit-mixed"):
        assert plan_model(tmodel, tparams, variant=variant).precisions() == \
            jplan_model(jmodel, jparams, variant=variant).precisions()


# ---------------------------------------------------------------------------
# the bridge and artifacts
# ---------------------------------------------------------------------------

def test_bridge_carries_moe_params_and_cache(models):
    jcfg, _, jmodel, jparams, _ = models["arctic-480b"]
    jp = jcompile_plan(jmodel, jparams, jexplicit_plan(jcfg, LAYERS)).params
    tp = from_jax(_np(jp), device="cpu")
    layers = tp["layers"]
    assert [(s.precision, s.start, s.stop) for s in layers.segments] == \
        [("int8", 0, 1), ("int4", 1, 2)]
    seg = layers.segments[1].params
    assert sorted(seg["moe"]) == ["router", "w_down", "w_gate", "w_up"]
    assert "mlp" in seg                         # arctic's dense residual
    w = seg["moe"]["w_gate"]
    jw = jp["layers"].segments[1].params["moe"]["w_gate"]
    assert isinstance(w, QTensor) and w.precision == "int4"
    assert tuple(w.data.shape) == (1, jcfg.num_experts, jcfg.expert_d_ff,
                                   jcfg.d_model // 2)
    np.testing.assert_array_equal(w.data.numpy(), np.asarray(jw.data))
    jcache = JT.init_cache(jcfg, 1, 8)
    jcache = jquantize_cache(jcache, jcompile_kv_plan(jcfg, None, "int4"),
                             (), ("k", "v"))
    tcache = from_jax(_np(jcache), device="cpu")
    assert isinstance(tcache, TT.DecodeCache)
    np.testing.assert_array_equal(tcache.k.data.numpy(),
                                  np.asarray(jcache.k.data))


def _leaves_equal(got, want):
    g, w = dict(flatten_with_paths(got)), dict(flatten_with_paths(want))
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))
    for key, b in w.items():
        a = g[key]
        pairs = (((a.data, b.data), (a.scale, b.scale))
                 if isinstance(b, QTensor) else ((a, b),))
        for x, y in pairs:
            assert x.dtype == y.dtype and torch.equal(x, y), key


@pytest.mark.parametrize("arch", ARCHS)
def test_artifacts_boot_across_packages(models, arch, tmp_path):
    jcfg, tcfg, jmodel, jparams, tparams = models[arch]
    jplan, tplan = jexplicit_plan(jcfg, LAYERS), explicit_plan(tcfg, LAYERS)
    jcompiled = jcompile_plan(jmodel, jparams, jplan)
    jsave_artifact(str(tmp_path / "jax"), jcompiled)
    got = load_artifact(str(tmp_path / "jax"), build(tcfg), device="cpu")
    assert got.plan.precisions() == jplan.precisions()
    assert got.nbytes_effective() == jcompiled.nbytes_effective()
    _leaves_equal(got.params, from_jax(_np(jcompiled.params), "cpu"))
    save_artifact(str(tmp_path / "port"),
                  compile_plan(build(tcfg), tparams, tplan))
    loaded = jload_artifact(str(tmp_path / "port"), jmodel)
    a, b = jax.tree.leaves(loaded.params), jax.tree.leaves(jcompiled.params)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))
