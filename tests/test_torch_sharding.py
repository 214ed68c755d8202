"""The port's sharding rules (``repro_torch.sharding``) and meshes
(``repro_torch.launch.mesh``) held to the JAX package's, entry for entry.

The same numpy trees (raw stacks of five families, QTensor leaves, segmented
stacks from compiled SMOKE plans, raw / int8 / int4 KVPage caches, a PagedKV
pool) go through the reference's rule functions on a
``jax.sharding.AbstractMesh`` and the port's on its own ``Mesh`` of the same
shape; every leaf's spec must be the same tuple at the same path.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs.registry import get_config
from repro.models.model import build
from repro.optim.adamw import AdamW as JAdamW
from repro.quant import kvcache as JKV
from repro.quant import paged as JPG
from repro.quant.compiler import compile_plan
from repro.quant.quantize import quantize
from repro.serving import batch as JB
from repro.serving.quantized import explicit_plan, fastewq_metadata_plan
from repro.sharding import ctx as JC
from repro.sharding import specs as JS
from repro_torch.bridge import from_jax
from repro_torch.launch import mesh as TM
from repro_torch.models.model import build as tbuild
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.serving import batch as TB
from repro_torch.sharding import ctx as TC
from repro_torch.sharding import specs as TS

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "1x2": ((1, 2), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "4x8": ((4, 8), ("data", "model")),
    "data8": ((8,), ("data",)),
    "model8": ((8,), ("model",)),
    "pod": ((2, 16, 16), ("pod", "data", "model")),
}


def _meshes(name):
    shape, axes = MESHES[name]
    return (AbstractMesh(shape, axes),
            TM.make_mesh(shape, axes, devices=["cpu"]))


def _ref_flat(specs) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(JS._path_names(p)): tuple(s) for p, s in flat}


def _port_flat(specs) -> dict:
    return {k: tuple(v) for k, v in TS.flatten_with_names(specs)}


def _assert_same(ref_specs, port_specs):
    ref, port = _ref_flat(ref_specs), _port_flat(port_specs)
    assert ref, "no leaves compared"
    assert ref == port


def _port(tree):
    """The port's copy of an abstract (shape-only) JAX tree: zeros of each
    leaf's shape and dtype, through the bridge."""
    return from_jax(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree),
                    "cpu")


# --------------------------------------------------------------------------
# trees
# --------------------------------------------------------------------------

def _smoke(arch, **over):
    cfg = get_config(arch, smoke=True)
    if over:
        cfg = dataclasses.replace(cfg, **over)
    return cfg, build(cfg)


@functools.lru_cache(maxsize=None)
def _tree(name: str):
    """A JAX parameter tree by name, shapes only (``jax.eval_shape``: the
    rules read nothing else), built once per test process."""
    return jax.eval_shape(lambda: _make_tree(name))


@functools.lru_cache(maxsize=None)
def _port_tree(name: str):
    return _port(_tree(name))


def _make_tree(name: str):
    if name.endswith("_raw"):
        arch = {"dense_raw": "llama3.2-3b", "moe_raw": "grok-1-314b",
                "hybrid_raw": "zamba2-2.7b", "ssm_raw": "mamba2-780m",
                "encdec_raw": "whisper-medium"}[name]
        _, model = _smoke(arch)
        return model.init(jax.random.PRNGKey(0))
    if name == "qtensors":
        w = lambda *s: jnp.ones(s, jnp.float32)
        return {"embed": {"tok": quantize(w(512, 256), "int8")},
                "layers": {"attn": {"wq": quantize(w(2, 256, 256), "int4"),
                                    "wo": quantize(w(2, 256, 512), "int4"),
                                    "wk": quantize(w(2, 64, 256),
                                                   "ternary")},
                           "mlp": {"w_down": quantize(w(2, 256, 384),
                                                      "int8", 128)},
                           "ln1": w(2, 256)},
                "final": {"norm": w(256)}}
    if name == "dense_ewq":
        cfg, model = _smoke("llama3.2-3b", num_layers=4)
        plan = fastewq_metadata_plan(cfg, "4bit/8bit")
        return compile_plan(model, model.init(jax.random.PRNGKey(1)),
                            plan).params
    if name == "dense_mixed":
        cfg, model = _smoke("llama3.2-3b", num_layers=4)
        plan = explicit_plan(cfg, ["int8", "int4", "int4", "ternary"])
        plan = dataclasses.replace(plan, decisions=[dataclasses.replace(
            plan.decisions[0], precision="int8")] + list(plan.decisions[1:]))
        return compile_plan(model, model.init(jax.random.PRNGKey(2)),
                            plan).params
    if name == "hybrid_mixed":
        cfg, model = _smoke("zamba2-2.7b")
        plan = explicit_plan(cfg, ["int8"] * (cfg.num_layers // 2)
                             + ["int4"] * (cfg.num_layers
                                           - cfg.num_layers // 2))
        return compile_plan(model, model.init(jax.random.PRNGKey(3)),
                            plan).params
    raise KeyError(name)


PARAM_TREES = ("dense_raw", "moe_raw", "hybrid_raw", "ssm_raw", "encdec_raw",
               "qtensors", "dense_ewq", "dense_mixed", "hybrid_mixed")


@pytest.mark.parametrize("serving", [False, True], ids=["fsdp", "serving"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("tree_name", PARAM_TREES)
def test_param_specs_match_reference(tree_name, mesh_name, serving):
    jm, tm = _meshes(mesh_name)
    _assert_same(JS.param_specs(_tree(tree_name), jm, serving=serving),
                 TS.param_specs(_port_tree(tree_name), tm, serving=serving))


# --------------------------------------------------------------------------
# caches and decode states
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cache(name: str):
    return jax.eval_shape(lambda: _make_cache(name))


def _make_cache(name: str):
    if name.startswith("dense"):
        cfg, model = _smoke("llama3.2-3b", num_layers=4)
        b = 3 if name == "dense_b3" else 8
        raw = model.slotted_cache(b, 32)
        if name in ("dense_raw", "dense_b3"):
            return raw
        if name in ("dense_int8", "dense_int4"):
            prec = name[-4:]
            return JKV.quantize_model_cache(
                raw, JKV.KVPlan((prec,) * 4, group=32), (), ("k", "v"))
        if name == "dense_mixed":
            return JKV.quantize_model_cache(
                raw, JKV.KVPlan(("int8", "int8", "int4", "bf16"), group=32),
                (2,), ("k", "v"))
        if name == "dense_paged":
            runs = [("int8", 0, 2), ("int4", 2, 4)]
            pools = {f: JPG.init_pool_field(getattr(raw, f), runs,
                                            num_pages=6, page_size=8,
                                            num_slots=b, group=32)
                     for f in ("k", "v")}
            return raw._replace(**pools)
    arch = {"hybrid": "zamba2-2.7b", "ssm": "mamba2-780m",
            "encdec": "whisper-medium"}[name]
    _, model = _smoke(arch)
    return model.slotted_cache(8, 32)


CACHES = ("dense_raw", "dense_b3", "dense_int8", "dense_int4", "dense_mixed",
          "dense_paged", "hybrid", "ssm", "encdec")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("cache_name", CACHES)
def test_cache_specs_match_reference(cache_name, mesh_name):
    jm, tm = _meshes(mesh_name)
    cache = _cache(cache_name)
    _assert_same(JS.cache_specs(cache, jm),
                 TS.cache_specs(_port(cache), tm))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_state_specs_match_reference(mesh_name):
    """The decode state: the cache by cache_specs, every bookkeeping buffer
    the two states share replicated."""
    jm, tm = _meshes(mesh_name)
    cfg, model = _smoke("llama3.2-3b", num_layers=4)
    ref = JB.state_specs(jax.eval_shape(
        lambda: JB.init_state(model, 8, 32, jax.random.PRNGKey(0))), jm)
    port = TB.state_specs(TB.init_state(tbuild(
        dataclasses.replace(get_config("llama3.2-3b", smoke=True),
                            num_layers=4)), 8, 32, "cpu"), tm)
    _assert_same(ref.cache, port["cache"])
    shared = [f for f in ref._fields if f != "cache" and f in port]
    assert len(shared) >= 10, shared
    for f in shared:
        assert tuple(getattr(ref, f)) == tuple(port[f]) == (), f


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_specs_match_reference(mesh_name):
    jm, tm = _meshes(mesh_name)
    batch = {"tokens": np.zeros((8, 16), np.int32),
             "labels": np.zeros((3, 16), np.int32),
             "frames": np.zeros((16, 4, 8), np.float32)}
    _assert_same(JS.batch_specs(batch, jm), TS.batch_specs(
        {k: torch.from_numpy(v) for k, v in batch.items()}, tm))


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
@pytest.mark.parametrize("mesh_name", ["1x2", "2x4", "pod"])
def test_opt_state_specs_match_reference(mesh_name, moment_dtype):
    jm, tm = _meshes(mesh_name)
    params = _tree("dense_raw")
    tparams = _port_tree("dense_raw")
    ref_state = jax.eval_shape(
        JAdamW(1e-3, moment_dtype=moment_dtype).init, params)
    port_state = TAdamW(1e-3, moment_dtype=moment_dtype).init(tparams)
    ref = JS.opt_state_specs(ref_state, JS.param_specs(params, jm), jm)
    port = TS.opt_state_specs(port_state, TS.param_specs(tparams, tm), tm)
    _assert_same(ref, port)
    if moment_dtype == "int8":        # int8 moments: a scale was compared
        assert any(k.endswith("#1") for k in _port_flat(port))


# --------------------------------------------------------------------------
# the activation context and the meshes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", ["1x2", "data8", "model8", "pod"])
def test_activation_sharding_rules_match_reference(mesh_name):
    """Meshes without "model" or without "data" map the absent logical
    dim to no axis, as the reference does."""
    jm, tm = _meshes(mesh_name)
    with JC.activation_sharding(jm):
        ref = JC._rules()
        ref_shards = (JC.data_shards(), JC.model_shards())
    with TC.activation_sharding(tm):
        port = TC._rules()
        port_shards = (TC.data_shards(), TC.model_shards())
        x = torch.zeros(16, 4, 24)
        assert TC.constrain(x, ("batch", None, "model")) is x
        spec = TC.activation_spec(x.shape, ("batch", None, "model"))
    assert ref["axes"] == port["axes"]
    assert ref["sizes"] == port["sizes"]
    assert ref_shards == port_shards
    want = [ref["axes"]["batch"] if 16 % ref["sizes"]["batch"] == 0
            else None, None,
            ref["axes"]["model"] if 24 % ref["sizes"]["model"] == 0
            else None]
    assert tuple(spec) == tuple(want)
    assert TC._rules() is None and TC.constrain(x, ("seq",)) is x


def test_unshard_fsdp_and_cost_mode():
    """The port holds no FSDP-sharded weight: the materialization point
    hands the tree back, inside the context and out; cost mode unrolls."""
    _, tm = _meshes("2x4")
    params = _port_tree("dense_raw")
    assert TC.unshard_fsdp(params) is params
    with TC.activation_sharding(tm):
        assert TC.unshard_fsdp(params) is params
    assert TC.unroll_flag() == 1 and not TC.in_cost_mode()
    with TC.cost_mode():
        assert TC.in_cost_mode() and TC.unroll_flag() is True
    assert not TC.in_cost_mode()


@pytest.mark.parametrize("axes,shape", [("", None), (" , ", None),
                                        ("data,model", "2"),
                                        ("data", "2,4")])
def test_parse_mesh_errors_match_reference(axes, shape):
    from repro.launch.mesh import parse_mesh as jparse
    with pytest.raises(ValueError) as ref:
        jparse(axes, shape)
    with pytest.raises(ValueError) as port:
        TM.parse_mesh(axes, shape, devices=["cpu"])
    assert str(ref.value) == str(port.value)


def test_parse_mesh_shapes():
    m = TM.parse_mesh("data, model", "2,4", devices=["cpu"])
    assert m.axis_names == ("data", "model")
    assert dict(m.shape) == {"data": 2, "model": 4} and m.size == 8
    # no shape: every device on the last axis
    m = TM.parse_mesh("data,model", devices=["cpu", "cpu", "cpu"])
    assert dict(m.shape) == {"data": 1, "model": 3}
    assert dict(TM.make_production_mesh(devices=["cpu"]).shape) == \
        {"data": 16, "model": 16}
    assert dict(TM.make_production_mesh(multi_pod=True,
                                        devices=["cpu"]).shape) == \
        {"pod": 2, "data": 16, "model": 16}


def test_make_mesh_lays_positions_round_the_devices():
    devs = [f"cuda:{i}" for i in range(3)]
    m = TM.make_mesh((2, 4), ("data", "model"), devices=devs)
    flat = [str(d) for d in m.devices.flat]
    assert flat == [devs[i % 3] for i in range(8)]
    assert [str(d) for d in m.device_set] == devs
    one = TM.make_mesh((2, 2), ("data", "model"), devices=["cuda:0"])
    assert {str(d) for d in one.devices.flat} == {"cuda:0"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.make_mesh((1, 2), ("data", "model"))


@pytest.mark.parametrize("shape,axes,n", [
    ((2, 4), ("data", "model"), 2), ((4, 2), ("data", "model"), 4),
    ((2, 4, 8), ("pod", "data", "model"), 8), ((8,), ("data",), 8)])
def test_split_data_replicas(shape, axes, n):
    """Submeshes keep every axis name with size-1 data axes and own
    disjoint positions that cover the mesh (the reference's docstring and
    ``tests/test_serving.py``'s (2, 4) split into two (1, 4) meshes)."""
    size = int(np.prod(shape))
    m = TM.make_mesh(shape, axes, devices=[f"cuda:{i}" for i in range(size)])
    subs = TM.split_data_replicas(m)
    assert len(subs) == n
    for s in subs:
        assert s.axis_names == axes
        assert all(s.shape[a] == 1 for a in axes if a != "model")
        if "model" in axes:
            assert s.shape["model"] == m.shape["model"]
    seen = [str(d) for s in subs for d in s.devices.flat]
    assert sorted(seen) == sorted(str(d) for d in m.devices.flat)
    assert len(set(seen)) == size


@pytest.mark.parametrize("shape,axes", [((1, 4), ("data", "model")),
                                        ((8,), ("model",)),
                                        ((1, 1), ("data", "model"))])
def test_split_data_replicas_without_a_data_split(shape, axes):
    m = TM.make_mesh(shape, axes, devices=["cpu"])
    assert TM.split_data_replicas(m) == [m]


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------

def test_shard_tree_copies_slices_and_shares_replicated_leaves():
    """Every shard is a contiguous copy of its slice (never a view); a
    replicated leaf is the same tensor at every position on its device;
    QTensor shards keep whole groups (an int4 payload split at K/2)."""
    from repro_torch.quant.compiler import compile_plan as tcompile
    from repro_torch.serving.quantized import explicit_plan as texplicit
    cfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True),
                              num_layers=4)
    model = tbuild(cfg)
    plan = texplicit(cfg, ["int8", "int4", "int4", "ternary"])
    plan = dataclasses.replace(plan, decisions=[dataclasses.replace(
        plan.decisions[0], precision="int8")] + list(plan.decisions[1:]))
    params = tcompile(model, model.init(torch.Generator().manual_seed(0),
                                        "cpu"), plan, 32).params
    mesh = TM.make_mesh((2, 2), ("data", "model"), devices=["cpu"])
    placed = TS.serving_shard(params, mesh)
    seg = lambda pos: placed.at(pos)["layers"].segments
    full = params["layers"].segments
    for si, s in enumerate(full):
        wo = s.params["attn"]["wo"]
        for m in range(2):
            sh = seg((0, m))[si].params["attn"]["wo"]
            k = wo.data.shape[-1] // 2
            assert sh.data.is_contiguous()
            assert sh.data.untyped_storage().data_ptr() != \
                wo.data.untyped_storage().data_ptr()
            assert torch.equal(sh.data, wo.data[..., m * k:(m + 1) * k])
            g = wo.scale.shape[-1] // 2
            assert torch.equal(sh.scale, wo.scale[..., m * g:(m + 1) * g])
            assert sh.shape[-1] == wo.shape[-1] // 2
            # data rows share one copy per model position
            assert seg((1, m))[si].params["attn"]["wo"].data is sh.data
        ln = seg((0, 0))[si].params["ln1"]
        assert ln is s.params["ln1"] and seg((1, 1))[si].params["ln1"] is ln
    n = {p: v for p, v in placed.position_nbytes().items()}
    assert len(n) == 4 and len(set(n.values())) == 1
    total = TS.physical_nbytes(params)
    assert n[(0, 0)] < 0.55 * total


def test_shard_tree_refuses_a_split_group():
    """A row-parallel int8 QTensor whose shard of K would split a group of
    128 (K = 128 over |model| = 2): the reference shards the payload and
    replicates the scale; the port refuses."""
    cfg, model = _smoke("llama3.2-3b")
    params = jax.eval_shape(lambda: compile_plan(
        model, model.init(jax.random.PRNGKey(0)),
        explicit_plan(cfg, ["int8", "int8"])).params)
    mesh = TM.make_mesh((1, 2), ("data", "model"), devices=["cpu"])
    with pytest.raises(TS.GroupSplitError, match="quantization group"):
        TS.serving_shard(_port(params), mesh)


def test_shard_cache_splits_slots_and_heads():
    cfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True),
                              num_layers=2)
    model = tbuild(cfg)
    cache = model.slotted_cache(4, 16, "cpu")
    cache.k.normal_()
    cache.v.normal_()
    cache.pos.copy_(torch.arange(4))
    mesh = TM.make_mesh((2, 2), ("data", "model"), devices=["cpu"])
    mc = TB.shard_cache(cache, mesh, model)
    assert mc.slots_per_row == 2 and mc.locate(3) == (1, 1)
    part = mc.rows[1].parts[1]
    assert torch.equal(part.k, cache.k[:, 2:4, :, 1:2])
    assert torch.equal(part.pos, cache.pos[2:4])
    assert part.k.is_contiguous()
    state = TB.shard_state(TB.init_state(model, 4, 16, "cpu"), mesh, model)
    assert TB.constrain_state(state, mesh) is state
    with pytest.raises(ValueError, match="do not split"):
        TB.shard_cache(model.slotted_cache(3, 16, "cpu"), mesh, model)
    wide = TM.make_mesh((1, 4), ("data", "model"), devices=["cpu"])
    with pytest.raises(ValueError, match="sequence-sharded KV"):
        TB.shard_cache(cache, wide, model)
