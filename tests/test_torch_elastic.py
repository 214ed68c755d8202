"""Elastic re-meshing of the port's training state on the CPU (the JAX
package's ``tests/test_elastic.py:17``): a ``(params, AdamWState)``
placement saved on one mesh is written as its logical arrays and restores
onto another mesh, each position holding the slice its specs name, the
logical arrays equal to the bit (int8 moments included: the payload's
slices, the scales replicated whole). ``train(mesh=)`` resumes a
mesh-less checkpoint and a mesh-less run resumes a mesh one, each within
the mesh step's limit of the uninterrupted mesh-less run.
"""

import dataclasses
import json
import os
import signal

import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_optimizer
from repro_torch.models.model import build
from repro_torch.optim.adamw import AdamWState
from repro_torch.quant.qtypes import QTensor
from repro_torch.sharding.specs import (MeshTree, gather_tree,
                                        opt_state_specs, param_specs,
                                        positions, shard_tree)
from repro_torch.train.loop import train
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)

MESH_TRAIN_REL_L2 = 1e-4        # tests/test_torch_mesh_train.py's limit


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), devices=["cpu"])


def _state(arch: str, moments: str):
    """Params from a seeded init and an AdamW state whose moments hold
    seeded nonzero values (levels and scales for int8)."""
    model = build(get_config(arch, smoke=True))
    opt = make_optimizer(RunConfig(moment_dtype=moments))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    state = opt.init(params)
    gen = torch.Generator().manual_seed(1)
    for x in tree_leaves([state.m, state.v]):
        if isinstance(x, QTensor):
            x.data.copy_(torch.randint(-127, 128, x.data.shape,
                                       generator=gen, dtype=torch.int8))
            x.scale.copy_(torch.rand(x.scale.shape, generator=gen))
        else:
            x.copy_(torch.rand(x.shape, generator=gen))
    return params, state._replace(count=torch.tensor(7, dtype=torch.int32)),\
        opt


def _specs(params, state, mesh):
    pspecs = param_specs(params, mesh)
    return pspecs, opt_state_specs(state, pspecs, mesh)


def _same(a, b) -> None:
    fa, fb = ckpt.flatten_with_paths(a), ckpt.flatten_with_paths(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (key, x), (_, y) in zip(fa, fb):
        if isinstance(x, QTensor):
            assert torch.equal(x.data, y.data), key
            assert torch.equal(x.scale, y.scale), key
            assert x.shape == y.shape, key
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), key


@pytest.mark.parametrize("arch,moments", [("olmo-1b", "float32"),
                                          ("llama3.2-3b", "int8")])
def test_remesh_restore(tmp_path, arch, moments):
    """Saved on (4, 2), restored onto (2, 4): the logical arrays equal to
    the bit, the checkpoint's keys those of an unsharded save, and every
    position holding what ``shard_tree`` of the logical state gives it."""
    params, state, opt = _state(arch, moments)
    mesh_a, mesh_b = _mesh((4, 2)), _mesh((2, 4))
    placed = shard_tree((params, state), _specs(params, state, mesh_a),
                        mesh_a)
    ckpt.save(str(tmp_path / "mesh"), 1, placed, extra={"mesh": "4x2"})
    ckpt.save(str(tmp_path / "plain"), 1, (params, state))
    with open(tmp_path / "mesh" / "step_00000001" / "manifest.json") as f:
        got = json.load(f)["leaves"]
    with open(tmp_path / "plain" / "step_00000001" / "manifest.json") as f:
        assert got == json.load(f)["leaves"]

    meta = tree_map(lambda p: torch.empty_like(p, device="meta"), params)
    like = (meta, opt.init(meta))
    specs_b = _specs(params, state, mesh_b)
    restored, extra = ckpt.restore(str(tmp_path / "mesh"), like,
                                   mesh=mesh_b, specs=specs_b)
    assert extra == {"mesh": "4x2"}
    assert isinstance(restored, MeshTree)
    assert restored.mesh.shape["model"] == 4
    _same(gather_tree(restored, "cpu"), (params, state))
    want = shard_tree((params, state), specs_b, mesh_b)
    for pos in positions(mesh_b):
        _same(restored.at(pos), want.at(pos))
    if moments == "int8":
        first, last = positions(mesh_b)[0], positions(mesh_b)[-1]
        m0 = tree_leaves(restored.at(first)[1].m)
        m1 = tree_leaves(restored.at(last)[1].m)
        q = [(x, y) for x, y in zip(m0, m1) if isinstance(x, QTensor)]
        assert q and all(x.scale is y.scale for x, y in q)
        assert any(x.data.shape != x.scale.shape[:-1] + (
            x.scale.shape[-1] * 128,) for x, _ in q)


def _run(cfg, d=None, mesh=None, stop_after=None):
    """Four steps (a SIGTERM after step ``stop_after`` commits a checkpoint
    and stops the run, so the schedule is the four steps' either way)."""
    run = RunConfig(steps=4, learning_rate=1e-3, warmup_steps=1,
                    remat=False, checkpoint_dir=d, checkpoint_every=4)
    lines = []

    def log(line):
        lines.append(line)
        if stop_after is not None and line.startswith(f"step {stop_after}:"):
            os.kill(os.getpid(), signal.SIGTERM)

    res = train(cfg, run, batch=4, seq=16, mesh=mesh, device="cpu"
                if mesh is None else None, log_every=1, log_fn=log)
    return res, lines


def _worst(got, want) -> float:
    g = dict(ckpt.flatten_with_paths(got))
    w = dict(ckpt.flatten_with_paths(want))
    assert g.keys() == w.keys()
    return max(float((g[k].double() - w[k].double()).norm()
                     / w[k].double().norm()) for k in w if w[k].ndim)


@pytest.mark.parametrize("first,second", [(None, (2, 2)), ((2, 2), None)])
def test_train_resumes_across_meshes(tmp_path, first, second):
    """Two steps on one layout, committed; resumed on the other for two
    more: the losses and params of the uninterrupted mesh-less run within
    the mesh step's limits, the state placed as the run's mesh says."""
    cfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True),
                              dtype="float32")
    whole, _ = _run(cfg)
    d = str(tmp_path / "ckpt")
    a, _ = _run(cfg, d, None if first is None else _mesh(first), 1)
    assert ckpt.latest_step(d) == 2 and len(a["losses"]) == 2
    b, lines = _run(cfg, d, None if second is None else _mesh(second))
    assert "resumed from step 2" in lines
    losses = a["losses"] + b["losses"]
    assert losses == pytest.approx(whole["losses"], rel=1e-5)
    params, state = b["params"], b["opt_state"]
    if second is not None:
        assert isinstance(params, MeshTree) and isinstance(state, MeshTree)
        assert params.mesh.shape == _mesh(second).shape
        assert isinstance(state.at(positions(state.mesh)[0]), AdamWState)
        params, state = gather_tree(params, "cpu"), gather_tree(state, "cpu")
    assert int(state.count) == 4
    err = _worst(params, whole["params"])
    print(f"{first} -> {second}: worst leaf {err:.3g}")
    assert err < MESH_TRAIN_REL_L2
