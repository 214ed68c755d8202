"""DP x TP replicas, sharded artifacts and the launcher's mesh flags of the
port, on the CPU.

* ``ReplicaServe.build`` on a (2, 2) mesh against a (1, 2) TP-only engine
  and the single full (2, 2) mesh engine (the JAX package's
  ``tests/test_serving.py`` ``test_dp_replica_serve_matches_tp_only``);
* the ``saved_mesh`` stamp (``tests/test_compiler.py``
  ``test_artifact_records_save_mesh``) and the sharded cold boot
  (``tests/test_serving.py`` ``test_sharded_artifact_cold_boot_lands_
  sharded``);
* ``python -m repro_torch.launch.serve --mesh ... --dp --check-dp-parity``
  and its flag errors.
"""

from __future__ import annotations

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.ckpt import load_artifact_manifest
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import make_mesh, split_data_replicas
from repro_torch.models.model import build
from repro_torch.quant.compiler import (compile_plan, load_artifact,
                                        save_artifact)
from repro_torch.quant.qtypes import QTensor
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.quantized import explicit_plan, fastewq_metadata_plan
from repro_torch.serving.replica import ReplicaServe
from repro_torch.serving.scheduler import synthetic_stream
from repro_torch.sharding.specs import MeshTree, physical_nbytes

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAX_SEQ = 24


def _mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, devices=["cpu"])


@pytest.fixture(scope="module")
def dense():
    cfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True),
                              dtype="float32", num_layers=2)
    model = build(cfg)
    return model, model.init(torch.Generator().manual_seed(0), "cpu")


def test_dp_replica_serve_matches_tp_only(dense):
    """ReplicaServe over (2, 2) is greedy token-identical to the same
    stream on a (1, 2) TP-only engine and on the full (2, 2) mesh engine;
    per-replica occupancy and load-aware assignments are reported."""
    model, params = dense
    cfg = model.cfg
    plan = fastewq_metadata_plan(cfg, "4bit/8bit")
    kw = dict(max_seq=MAX_SEQ, plan=plan, group=64, kv_precision="int8",
              kv_group=32, device="cpu")
    reqs = synthetic_stream(6, vocab_size=cfg.vocab_size, prompt_len=8,
                            max_new_tokens=6, arrival_rate=0.5, seed=2)
    tp = ServeEngine(model, params, mesh=_mesh((1, 2)), **kw)
    outs_tp, _ = tp.serve(reqs, num_slots=2, chunk=4)

    mesh = _mesh((2, 2))
    subs = split_data_replicas(mesh)
    assert all(dict(m.shape) == {"data": 1, "model": 2} for m in subs)
    rep = ReplicaServe.build(model, params, mesh=mesh, **kw)
    assert rep.num_replicas == 2
    assert [dict(e.mesh.shape) for e in rep.engines] == \
        [{"data": 1, "model": 2}] * 2
    outs_dp, rstats = rep.serve(reqs, num_slots=2, chunk=4, prefill_chunk=3)
    assert rstats.replicas == 2
    assert sum(rstats.assignments) == len(reqs)
    assert all(n > 0 for n in rstats.assignments)
    assert len(rstats.occupancy_per_replica) == 2
    assert all(0.0 < o <= 1.0 for o in rstats.occupancy_per_replica)
    assert rstats.aggregate.generated_tokens == sum(
        st.generated_tokens for st in rstats.per_replica)
    full = ServeEngine(model, params, mesh=mesh, **kw)
    outs_full, _ = full.serve(reqs, num_slots=4, chunk=4)
    for a, b, c in zip(outs_tp, outs_dp, outs_full):
        assert a.rid == b.rid == c.rid
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.tokens, c.tokens)
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-4)
        np.testing.assert_allclose(a.logprobs, c.logprobs, atol=1e-4)
    # one copy of the weights per model position, shared by the data rows
    assert full.weight_bytes_per_device() == tp.weight_bytes_per_device()


def test_data_only_replicas_serve_paged_and_spec(dense):
    """Over a data-only (2, 1) mesh each replica holds one position, so the
    paged pool and speculative rounds run per replica: greedy tokens equal
    to the single engine's."""
    from repro_torch.serving.spec import SpecConfig
    model, params = dense
    reqs = synthetic_stream(4, vocab_size=model.cfg.vocab_size,
                            prompt_len=8, max_new_tokens=6, seed=4)
    kw = dict(max_seq=MAX_SEQ, kv_precision="int8", device="cpu",
              paged=True, spec=SpecConfig(k=2))
    ref, _ = ServeEngine(model, params, **kw).serve(reqs, num_slots=2,
                                                    chunk=2)
    rep = ReplicaServe.build(model, params, mesh=_mesh((2, 1)), **kw)
    outs, rstats = rep.serve(reqs, num_slots=2, chunk=2)
    assert rstats.aggregate.spec_rounds > 0
    for a, b in zip(outs, ref):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_artifact_records_save_mesh(dense, tmp_path):
    """save_artifact(mesh=...) stamps the save-time layout; the artifact
    stays mesh-portable (restorable without any mesh)."""
    model, params = dense
    compiled = compile_plan(model, params,
                            explicit_plan(model.cfg, ["int8", "raw"]))
    save_artifact(str(tmp_path), compiled,
                  mesh=_mesh((1, 1)))
    manifest = load_artifact_manifest(str(tmp_path))
    assert manifest["saved_mesh"] == {"axis_names": ["data", "model"],
                                      "shape": [1, 1]}
    loaded = load_artifact(str(tmp_path), model, device="cpu")
    assert loaded.plan.precisions() == ["raw", "int8", "raw"]


def _qtensors(tree) -> list:
    from repro_torch.sharding.specs import _leaves
    return [leaf for leaf, _ in _leaves(tree, tree)
            if isinstance(leaf, QTensor)]


def _check_cold_boot(model, directory, mem_params, mesh):
    art = ServeEngine.from_artifact(model, directory, max_seq=MAX_SEQ,
                                    mesh=mesh, device="cpu")
    placed = art.mesh_params
    assert isinstance(placed, MeshTree)
    whole = physical_nbytes(mem_params)
    for pos, nbytes in placed.position_nbytes().items():
        # no position holds a whole copy of the weights
        assert nbytes < 0.6 * whole, (pos, nbytes, whole)
    full = {id(q): q for q in _qtensors(mem_params)}
    split = [q for q in _qtensors(placed.at((0, 0)))
             if q.shape[-1] < model.cfg.num_heads * model.cfg.head_dim
             and q.shape[-2] == model.cfg.d_model]
    assert split and full
    mem = ServeEngine(model, mem_params, max_seq=MAX_SEQ, device="cpu")
    prompts = np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, size=(2, 8), dtype=np.int32)
    o_mem, o_art = mem.generate(prompts, 6), art.generate(prompts, 6)
    assert torch.equal(o_mem.tokens, o_art.tokens)
    torch.testing.assert_close(o_mem.logprobs, o_art.logprobs, atol=1e-4,
                               rtol=0)
    # a pure-DP mesh (no "model" axis) serves the same artifact
    dp = ServeEngine.from_artifact(model, directory, max_seq=MAX_SEQ,
                                   mesh=_mesh((2,), ("data",)), device="cpu")
    assert torch.equal(dp.generate(prompts, 6).tokens, o_mem.tokens)


def test_sharded_artifact_cold_boot_lands_sharded(dense, tmp_path):
    """from_artifact(mesh=...) restores every weight leaf already sharded
    (each position receives its slice only) and generates as the
    in-memory engine does."""
    model, params = dense
    compiled = compile_plan(model, params,
                            explicit_plan(model.cfg, ["int8", "int4"]), 64)
    mesh = _mesh((1, 2))
    save_artifact(str(tmp_path), compiled, mesh=mesh)
    _check_cold_boot(model, str(tmp_path), compiled.params, mesh)


def test_launcher_dp_parity(tmp_path):
    """The launcher on the CPU: DP x TP replicas over a (2, 2) mesh, held
    to the single full-mesh engine, in a process that never loads JAX."""
    code = ("import sys\n"
            "from repro_torch.launch.serve import main\n"
            "main(['--arch', 'llama3.2-3b', '--smoke', '--device', 'cpu', "
            "'--mesh', 'data,model', '--mesh-shape', '2,2', '--dp', "
            "'--check-dp-parity', '--num-requests', '4', '--prompt-len', "
            "'8', '--max-new', '6', '--train-steps', '2'])\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print('LOADED', ','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin",
                              "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED \n" in out.stdout, out.stdout[-2000:]
    assert "mesh: {'data': 2, 'model': 2} over 1 devices" in out.stdout
    assert "greedy-agree vs single full-mesh engine: 1.0" in out.stdout
    assert "dp replicas: 2 x {'data': 1, 'model': 2}" in out.stdout


@pytest.mark.parametrize("argv,message", [
    (["--mesh-shape", "2,2"], "--mesh-shape requires --mesh"),
    (["--dp"], "--dp requires --mesh with a data axis >= 2"),
    (["--check-dp-parity"], "--check-dp-parity requires --dp"),
    (["--dp", "--mesh", "data,model", "--mesh-shape", "1,2"],
     "--dp found 1 replica(s)")])
def test_launcher_mesh_flag_errors(argv, message):
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as err:
        main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
              "--train-steps", "0"] + argv)
    assert message in str(err.value)
