"""Training over a mesh (``make_train_step(..., mesh=)``) held to the JAX
package and to the port's mesh-less step on the CPU, with the f32 SMOKE
llama (2 layers, d_model 128, 4 heads over 2 KV heads) and a batch of 8 x
32.

Meshes: (data=2, model=4), the reference test's
(``tests/test_sharding.py:188``: its wk / wv shards are half a KV head, so
the port gathers the KV projections over "model" and replicates the KV
heads, as Megatron does), (2, 2), and ("pod", "data", "model") (2, 2, 2),
every position on the CPU. Params are placed by the reference's training
rules (FSDP over the data axes, TP over "model") and gathered layer by
layer inside the forward.

Limits, each against a measured floor and a planted fault:
* the mesh loss within 1e-3 of the reference's single-device loss (its own
  limit, ``tests/test_sharding.py:217``) and within MESH_LOSS_RTOL of the
  port's mesh-less loss (readings: equal, or 7.6e-8 relative at
  (2, 2, 2));
* the gathered gradients within MESH_GRAD_REL_L2 a leaf of the mesh-less
  ones (readings 1.0e-6 to 1.1e-6 on the three meshes); the planted fault,
  each FSDP slice's gradient summed twice over the data rows, reads 1.0 on
  every FSDP-sharded leaf;
* three AdamW steps with f32 and bf16 moments, with and without
  ``microbatch``: the losses and grad norms within MESH_LOSS_RTOL, params
  within MESH_TRAIN_REL_L2 a leaf of three mesh-less steps (readings
  1.5e-5 to 1.8e-5, w_down: Adam's first steps, about lr * sign(g),
  amplify the reordered TP sums, which put 1e-6 into the gradients; the
  mesh-less step with the batch's rows reversed reads 5.8e-7, a (2, 1)
  mesh without TP 1.0e-6); the planted fault, weight decay left out of
  the mesh run, reads 3.3e-4;
* int8 moments: the placed update equal to the bit to the mesh-less one on
  the same gradients over three steps (params, levels, scales), at (2, 2)
  and (2, 4), where a data row's 64 columns hold half of a 128-column
  group. The full steps are not compared there: a moment of v that rounds
  to level 0 makes the update m / eps, so a reordered gradient sum flips
  whole entries of both packages' int8 Adam at this size.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.data.synthetic import synthetic_batch as jsynthetic_batch
from repro.models.model import build as jbuild
from repro.train import step as JT
from repro_torch.bridge import from_jax
from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_optimizer
from repro_torch.models.model import build
from repro_torch.optim.adamw import global_norm
from repro_torch.quant.qtypes import QTensor
from repro_torch.sharding import collective as C
from repro_torch.sharding.specs import (P, MeshTree, flatten_with_names,
                                        gather_tree, opt_state_specs,
                                        param_specs, placed_slices,
                                        positions, shard_tree)
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)

REFERENCE_LOSS_ATOL = 1e-3
MESH_LOSS_RTOL = 1e-5
MESH_GRAD_REL_L2 = 1e-5
MESH_TRAIN_REL_L2 = 1e-4
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _mesh(name: str):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices=["cpu"])


def _clone(tree):
    return tree_map(lambda x: x.clone(), tree)


@pytest.fixture(scope="module")
def setup():
    """(JAX single-device loss, port model, params, batch) of the f32
    SMOKE llama on the same weights and batch."""
    jcfg = dataclasses.replace(jget_config("llama3.2-3b", smoke=True),
                               dtype="float32")
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jbatch = jsynthetic_batch(jcfg, batch=8, seq=32, step=0)
    ref = float(JT.make_loss_fn(jmodel, remat=False)(jparams, jbatch)[0])
    cfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True),
                              dtype="float32")
    params = from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    batch = {k: torch.from_numpy(np.asarray(v).copy())
             for k, v in jbatch.items()}
    return ref, build(cfg), params, batch


def _grads(model, params, batch, mesh=None):
    run = RunConfig(remat=False)
    step = make_train_step(model, make_optimizer(run), run, mesh=mesh)
    if mesh is not None:
        params = shard_tree(params, param_specs(params, mesh), mesh)
    return step.compute_grads(params, batch)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_loss_and_grads(setup, mesh):
    ref, model, params, batch = setup
    (loss0, _), g0 = _grads(model, params, batch)
    (loss, metrics), grads = _grads(model, params, batch, _mesh(mesh))
    assert abs(float(loss) - ref) < REFERENCE_LOSS_ATOL
    assert float(loss) == pytest.approx(float(loss0), rel=MESH_LOSS_RTOL)
    assert float(metrics["loss"]) == pytest.approx(float(loss0),
                                                   rel=MESH_LOSS_RTOL)
    got = tree_leaves(gather_tree(grads, "cpu"))
    want = tree_leaves(g0)
    assert [g.shape for g in got] == [w.shape for w in want]
    errs = [rel_l2(g, w) for g, w in zip(got, want)]
    print(f"{mesh}: loss {float(loss):.7f} (reference {ref:.7f}, mesh-less "
          f"{float(loss0):.7f}); grads worst leaf {max(errs):.3g}")
    assert max(errs) < MESH_GRAD_REL_L2


def test_planted_double_sum_fails_the_grad_limit(setup, monkeypatch):
    """Each FSDP slice's gradient summed twice over the data rows (the
    gather's value unchanged, its backward doubled): every FSDP-sharded
    leaf moves by 1.0 relative, far outside MESH_GRAD_REL_L2."""
    _, model, params, batch = setup
    _, g0 = _grads(model, params, batch)
    gather = C.gather

    def twice(parts, device, dim=-1):
        x = gather(parts, device, dim)
        return x + (x - x.detach())

    monkeypatch.setattr(C, "gather", twice)
    mesh = _mesh("2x2")
    _, grads = _grads(model, params, batch, mesh)
    errs = [rel_l2(g, w) for g, w in zip(tree_leaves(gather_tree(grads)),
                                         tree_leaves(g0))]
    assert max(errs) > 0.5 > MESH_GRAD_REL_L2


def _three_steps(model, params, run, mesh, weight_decay=None):
    """(mesh-less params, mesh params gathered, each step's (mesh-less,
    mesh) losses and grad norms) after three steps from ``params`` on
    batches 0-2."""
    opt = make_optimizer(run)
    mopt = opt if weight_decay is None else dataclasses.replace(
        opt, weight_decay=weight_decay)
    p0 = _clone(params)
    s0 = opt.init(p0)
    placed = shard_tree(_clone(params), param_specs(params, mesh), mesh)
    state = mopt.init(placed)
    step = make_train_step(model, opt, run)
    mstep = make_train_step(model, mopt, run, mesh=mesh)
    readings = []
    for i in range(3):
        batch = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in
                 jsynthetic_batch(model.cfg, batch=8, seq=32, step=i).items()}
        p0, s0, m0 = step(p0, s0, batch)
        placed, state, m1 = mstep(placed, state, batch)
        readings.append([tuple(float(m[k]) for m in (m0, m1))
                         for k in ("loss", "grad_norm")])
    assert int(state.at(positions(mesh)[0]).count) == 3
    return p0, gather_tree(placed, "cpu"), readings


@pytest.mark.parametrize("moments,microbatch", [
    ("float32", None), ("float32", 4), ("bfloat16", None), ("bfloat16", 4)])
def test_three_steps_match_meshless(setup, moments, microbatch):
    _, model, params, _ = setup
    run = RunConfig(learning_rate=1e-3, warmup_steps=1, remat=True,
                    moment_dtype=moments, microbatch=microbatch)
    want, got, readings = _three_steps(model, params, run, _mesh("2x2"))
    for pair in readings:
        for meshless, mesh in pair:
            assert mesh == pytest.approx(meshless, rel=MESH_LOSS_RTOL)
    errs = {name: rel_l2(g, w) for (name, _), g, w in zip(
        flatten_with_names(want), tree_leaves(got), tree_leaves(want))}
    err = max(errs.values())
    print(f"{moments} microbatch {microbatch}: worst leaf {err:.3g} "
          f"({max(errs, key=errs.get)})")
    assert err < MESH_TRAIN_REL_L2


def test_planted_no_decay_fails_the_step_limit(setup):
    _, model, params, _ = setup
    run = RunConfig(learning_rate=1e-3, warmup_steps=1, remat=False)
    want, got, _ = _three_steps(model, params, run, _mesh("2x2"),
                                weight_decay=0.0)
    err = max(rel_l2(g, w) for g, w in zip(tree_leaves(got),
                                           tree_leaves(want)))
    print(f"no decay: worst leaf {err:.3g}")
    assert err > MESH_TRAIN_REL_L2


@pytest.mark.parametrize("mesh", ["2x2", "2x4"])
def test_int8_placed_update_equals_meshless(setup, mesh):
    """Three int8-moment updates of a placement on the mesh-less step's
    gradients, equal to the bit to the mesh-less updates: params, moment
    levels and the replicated scales."""
    _, model, params, _ = setup
    mesh = _mesh(mesh)
    run = RunConfig(learning_rate=1e-3, warmup_steps=1, remat=False,
                    moment_dtype="int8")
    opt = make_optimizer(run)
    step = make_train_step(model, opt, run)
    p0 = _clone(params)
    s0 = opt.init(p0)
    specs = param_specs(p0, mesh)
    placed = shard_tree(_clone(params), specs, mesh)
    state = opt.init(placed)
    for i in range(3):
        batch = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in
                 jsynthetic_batch(model.cfg, batch=8, seq=32, step=i).items()}
        _, g = step.compute_grads(p0, batch)
        scale = torch.tensor(0.5)
        _, s0 = opt.update(g, s0, p0, grad_scale=scale)
        _, state = opt.update(shard_tree(g, specs, mesh), state, placed,
                              grad_scale=scale)
    got_p, got_s = gather_tree(placed, "cpu"), gather_tree(state, "cpu")
    for a, b in zip(tree_leaves(got_p), tree_leaves(p0)):
        assert torch.equal(a, b)
    quantized = 0
    for a, b in zip(tree_leaves([got_s.m, got_s.v]),
                    tree_leaves([s0.m, s0.v])):
        if isinstance(b, QTensor):
            quantized += 1
            assert torch.equal(a.data, b.data)
            assert torch.equal(a.scale, b.scale)
        else:
            assert torch.equal(a, b)
    assert quantized > 0
    assert int(got_s.count) == 3


def test_placed_state_follows_opt_state_specs(setup):
    """``opt.init`` of a placement gives each position the slices
    ``shard_tree`` of the logical zero state under ``opt_state_specs``
    gives it: moments as the params' slices, an int8 moment's payload
    sliced and its scales whole (P()), the count replicated; the scales
    and the count one tensor for the positions of a device."""
    _, model, params, _ = setup
    mesh = _mesh("2x4")
    for moments in ("float32", "int8"):
        opt = make_optimizer(RunConfig(moment_dtype=moments))
        pspecs = param_specs(params, mesh)
        placed = opt.init(shard_tree(params, pspecs, mesh))
        logical = opt.init(params)
        ospecs = opt_state_specs(logical, pspecs, mesh)
        assert flatten_with_names(placed.specs) == flatten_with_names(ospecs)
        assert ospecs.count == P()
        want = shard_tree(logical, ospecs, mesh)
        first = positions(mesh)[0]
        for pos in positions(mesh):
            a = tree_leaves([placed.at(pos).m, placed.at(pos).v])
            b = tree_leaves([want.at(pos).m, want.at(pos).v])
            for x, y in zip(a, b):
                if isinstance(y, QTensor):
                    assert x.data.shape == y.data.shape
                    assert x.scale.shape == y.scale.shape
                    assert x.data.dtype == torch.int8
                    assert x.shape == y.shape
                else:
                    assert (x.shape, x.dtype) == (y.shape, y.dtype)
                assert not (x.data if isinstance(x, QTensor) else x).any()
            assert placed.at(pos).count is placed.at(first).count
        if moments == "int8":
            m0 = tree_leaves(placed.at(first).m)
            m1 = tree_leaves(placed.at(positions(mesh)[-1]).m)
            shared = [x.scale is y.scale for x, y in zip(m0, m1)
                      if isinstance(x, QTensor)]
            assert shared and all(shared)


def test_global_norm_counts_each_element_once(setup):
    """The norm over a placement equals the mesh-less norm; a sum over
    every position's slices would count each replicated element once per
    position that holds it."""
    _, model, params, batch = setup
    _, g0 = _grads(model, params, batch)
    mesh = _mesh("2x4")
    _, grads = _grads(model, params, batch, mesh)
    want = float(global_norm(g0))
    assert float(global_norm(grads)) == pytest.approx(want, rel=1e-6)
    every = sum(float(torch.sum(x.double() ** 2)) for entries in
                placed_slices(grads) for _, _, x in entries) ** 0.5
    assert every > want * (1 + 1e-4)


def _unshared(mt: MeshTree) -> MeshTree:
    """``mt`` with every position holding its own copy of each leaf, as
    positions on different cards do: a replicated leaf is then one tensor
    a position, not one shared tensor."""
    trees = np.empty(mt.trees.shape, dtype=object)
    for pos in positions(mt.mesh):
        trees[pos] = tree_map(lambda x: x.clone(), mt.trees[pos])
    return MeshTree(mesh=mt.mesh, specs=mt.specs, trees=trees)


def test_replicated_copies_step_as_one(setup):
    """Replicated leaves held as one copy a position (as across cards):
    each copy's gradient is the sum over the copies, in position order,
    and three steps keep the copies equal to the bit and the params within
    the mesh limit of the shared placement's."""
    _, model, params, _ = setup
    mesh = _mesh("2x2")
    run = RunConfig(learning_rate=1e-3, warmup_steps=1, remat=False)
    opt = make_optimizer(run)
    step = make_train_step(model, opt, run, mesh=mesh)
    shared = shard_tree(_clone(params), param_specs(params, mesh), mesh)
    copies = _unshared(shared)
    states = [opt.init(shared), opt.init(copies)]
    for i in range(3):
        batch = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in
                 jsynthetic_batch(model.cfg, batch=8, seq=32, step=i).items()}
        shared, states[0], _ = step(shared, states[0], batch)
        copies, states[1], _ = step(copies, states[1], batch)
    norm = [entries for entries in placed_slices(copies)
            if len({id(x) for _, _, x in entries}) == len(entries)
            and len({b for _, b, _ in entries}) == 1]
    assert norm                     # the replicated leaves (norms)
    for entries in norm:
        for _, _, x in entries[1:]:
            assert torch.equal(x, entries[0][2])
    errs = [rel_l2(g, w) for g, w in zip(tree_leaves(gather_tree(copies)),
                                         tree_leaves(gather_tree(shared)))]
    assert max(errs) < MESH_TRAIN_REL_L2


def test_collectives_carry_gradients():
    """``reduce_sum``, ``gather`` and ``broadcast`` differentiate: the
    gradient of a sum reaches every part, a gather's splits back to its
    parts, a broadcast's sums over the positions that read it."""
    a = torch.randn(3, 4, requires_grad=True)
    b = torch.randn(3, 4, requires_grad=True)
    w = torch.randn(3, 8)
    out = (C.reduce_sum([a, b], "cpu") * w[:, :4]).sum() \
        + (C.gather([a, b], "cpu", dim=-1) * w).sum()
    ga, gb = torch.autograd.grad(out, [a, b])
    torch.testing.assert_close(ga, w[:, :4] + w[:, :4])
    torch.testing.assert_close(gb, w[:, :4] + w[:, 4:])
    x = torch.randn(5, requires_grad=True)
    copies = C.broadcast(x, ["cpu", "cpu", "cpu"])
    (gx,) = torch.autograd.grad(sum((c * (i + 1)).sum()
                                    for i, c in enumerate(copies)), [x])
    torch.testing.assert_close(gx, torch.full((5,), 6.0))


def test_refusals(setup):
    """Mesh training takes the dense family; params placed on another mesh
    are refused."""
    _, model, params, batch = setup
    run = RunConfig(remat=False)
    moe = build(dataclasses.replace(get_config("grok-1-314b", smoke=True),
                                    dtype="float32"))
    with pytest.raises(NotImplementedError, match="item 10"):
        make_train_step(moe, make_optimizer(run), run, mesh=_mesh("2x2"))
    mesh = _mesh("2x2")
    step = make_train_step(model, make_optimizer(run), run, mesh=mesh)
    other = _mesh("2x2")
    with pytest.raises(ValueError, match="another mesh"):
        step.compute_grads(shard_tree(params, param_specs(params, other),
                                      other), batch)
