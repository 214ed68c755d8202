"""The port's dense model against the JAX reference on the llama3.2-3b
SMOKE config (f32): prefill logits and 8 teacher-forced decode steps over
a slotted cache, for the raw, 8bit-mixed and 4bit/8bit EWQ plans and an
explicit plan holding raw, int8, int4 and ternary layers (int8 embedding),
each with a bf16, int8 and int4 KV cache.

Tolerances: 1e-4 on logits with a bf16 cache; 1e-2 on logprobs with a
quantized cache (README: int8 KV against bf16 KV), since a K/V value one
ulp apart across the two frameworks may round to the neighbouring level.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core.planner import plan_model as jplan_model
from repro.models import transformer as JT
from repro.models.model import build as jbuild
from repro.quant.apply import segment_slices as jsegment_slices
from repro.quant.compiler import compile_kv_plan as jcompile_kv_plan
from repro.quant.compiler import compile_plan as jcompile_plan
from repro.quant.kvcache import quantize_model_cache as jquantize_cache
from repro.serving.quantized import explicit_plan as jexplicit_plan
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.core.planner import plan_model
from repro_torch.models import transformer as TT
from repro_torch.models.model import build
from repro_torch.quant.apply import segment_slices
from repro_torch.quant.compiler import compile_kv_plan
from repro_torch.quant.kvcache import quantize_model_cache
from repro_torch.serving.quantized import explicit_plan

torch.set_num_threads(2)

B, P, STEPS, MAX_SEQ = 2, 12, 8, 24
EXPLICIT = ["raw", "int8", "int4", "ternary"]


def _cfgs(explicit: bool):
    jcfg = dataclasses.replace(jget_config("llama3.2-3b", smoke=True),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True),
                               dtype="float32")
    if explicit:
        jcfg = dataclasses.replace(jcfg, num_layers=len(EXPLICIT))
        tcfg = dataclasses.replace(tcfg, num_layers=len(EXPLICIT))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    out = {}
    for explicit in (False, True):
        jcfg, tcfg = _cfgs(explicit)
        jmodel = jbuild(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(1))
        tparams = from_jax(jax.tree.map(np.asarray, jparams))
        step = jax.jit(lambda p, c, t, cfg=jcfg: JT.decode_step(p, c, t, cfg))
        out[explicit] = (jcfg, tcfg, jmodel, jparams, tparams, step)
    return out


def _plans(name, jmodel, jparams, tmodel, tparams, jcfg, tcfg):
    if name == "raw":
        return None, None
    if name == "explicit":
        return (_explicit_jax(jcfg),
                explicit_plan(tcfg, EXPLICIT, embed_precision="int8"))
    return (jplan_model(jmodel, jparams, variant=name),
            plan_model(tmodel, tparams, variant=name))


def _explicit_jax(jcfg):
    """The reference's explicit plan with the embedding block at int8."""
    plan = jexplicit_plan(jcfg, EXPLICIT)
    embed = dataclasses.replace(plan.decisions[0], precision="int8")
    return dataclasses.replace(plan, decisions=[embed] + plan.decisions[1:])


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("plan_name", ["raw", "8bit-mixed", "4bit/8bit",
                                       "explicit"])
def test_dense_logits_match_reference(models, plan_name, kv):
    explicit = plan_name == "explicit"
    jcfg, tcfg, jmodel, jparams, tparams, jstep = models[explicit]
    tmodel = build(tcfg)
    jplan, tplan = _plans(plan_name, jmodel, jparams, tmodel, tparams, jcfg,
                          tcfg)
    if jplan is not None:
        assert tplan.precisions() == jplan.precisions()
        jp = jcompile_plan(jmodel, jparams, jplan).params
        tp = tmodel.compile_plan(tparams, tplan).params
    else:
        jp, tp = jparams, tparams
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, tcfg.vocab_size, size=(B, P)).astype(np.int32)
    feed = rng.integers(0, tcfg.vocab_size, size=(B, STEPS)).astype(np.int32)

    jlogits, _, jcache = JT.apply(jp, jnp.asarray(prompts), jcfg, remat=False,
                                  return_cache=True)
    tlogits, tcache = TT.apply(tp, torch.from_numpy(prompts).long(), tcfg,
                               return_cache=True)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)

    pad = ((0, 0), (0, 0), (0, MAX_SEQ - P), (0, 0), (0, 0))
    jcache = jcache._replace(k=jnp.pad(jcache.k, pad), v=jnp.pad(jcache.v, pad),
                             pos=jnp.full((B,), P, jnp.int32))
    tpad = (0, 0, 0, 0, 0, MAX_SEQ - P)
    tcache = tcache._replace(
        k=torch.nn.functional.pad(tcache.k, tpad),
        v=torch.nn.functional.pad(tcache.v, tpad),
        pos=torch.full((B,), P, dtype=torch.int32))
    if kv != "bf16":
        jkv = jcompile_kv_plan(jcfg, jplan, kv)
        tkv = compile_kv_plan(tcfg, tplan, kv)
        assert tkv.to_dict() == jkv.to_dict()
        jcuts = tuple(lo for _, lo, _ in jsegment_slices(jp["layers"])[1:])
        tcuts = tuple(lo for _, lo, _ in segment_slices(tp["layers"])[1:])
        assert tcuts == jcuts
        jcache = jquantize_cache(jcache, jkv, jcuts, ("k", "v"))
        tcache = quantize_model_cache(tcache, tkv, tcuts, ("k", "v"))
    for t in range(STEPS):
        tok = feed[:, t:t + 1]
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok))
        tl, tcache = TT.decode_step(tp, tcache, torch.from_numpy(tok).long(),
                                    tcfg)
        jl, tl = np.asarray(jl), tl.numpy()
        if kv == "bf16":
            np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_allclose(
                torch.log_softmax(torch.from_numpy(tl), -1).numpy(),
                np.asarray(jax.nn.log_softmax(jl, -1)), atol=1e-2)
    assert tcache.pos.tolist() == np.asarray(jcache.pos).tolist()
