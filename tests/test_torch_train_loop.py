"""The port's training loop (``repro_torch.train.loop``) and the slice as a
whole, at SMOKE size on the CPU.

* k train steps from the same params (carried from the JAX package through
  the bridge) and the same batches, f32 moments, dense and MoE: params
  within TRAIN_REL_L2 relative L2 a leaf of the JAX train step's (Adam's
  first steps are about lr * sign(g), so a near-zero gradient may flip
  under a reordered sum: elementwise limits would be noise). Readings: the
  port at ~2e-6 (dense) and ~1.4e-5 (MoE); the planted fault, weight decay
  left out, at 2.6e-4 and 6.8e-4.
* A run preempted by SIGTERM commits a checkpoint and stops; resumed from
  it, it equals an uninterrupted run to the bit (params, int8 moments,
  count).
* The port resumes from a checkpoint the JAX trainer wrote of
  ``(params, AdamWState)``: restored to the bit (f32 moments, and int8
  ``QTensor`` moments from the reference's ``ckpt.save``), then continued
  within TRAIN_REL_L2 of the JAX trainer continuing the same checkpoint.
* The system path, the JAX package's ``tests/test_system.py`` on the port
  alone: train -> EWQ plan -> held-out ``evaluate`` of raw, 8bit-mixed
  and uniform 4-bit params: raw ~ 8bit-mixed << 4bit.
"""

import dataclasses
import os
import shutil
import signal

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.registry import get_config as jget_config
from repro.data.synthetic import synthetic_batch as jsynthetic_batch
from repro.launch.steps import make_optimizer as jmake_optimizer
from repro.models.model import build as jbuild
from repro.train.loop import train as jtrain
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.bridge import from_jax
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import flatten_with_paths
from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.planner import plan_model
from repro_torch.data.synthetic import synthetic_batch
from repro_torch.launch.steps import make_optimizer
from repro_torch.models.model import build
from repro_torch.optim.adamw import AdamWState
from repro_torch.quant.qtypes import QTensor
from repro_torch.serving.quantized import apply_plan_to_params
from repro_torch.train.loop import evaluate, train
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

TRAIN_REL_L2 = 1e-4
QUIET = dict(log_fn=lambda line: None)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _f32(arch, smoke_cfg):
    return dataclasses.replace(smoke_cfg(arch, smoke=True), dtype="float32")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _worst(got, want) -> float:
    """The worst leaf's relative L2, leaves paired by checkpoint key."""
    g, w = dict(flatten_with_paths(got)), dict(flatten_with_paths(want))
    assert g.keys() == w.keys()
    return max(rel_l2(g[k], w[k]) for k in w)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "grok-1-314b"])
def test_k_steps_match_reference(arch):
    jcfg, cfg = _f32(arch, jget_config), _f32(arch, get_config)
    kw = dict(steps=10, learning_rate=1e-3, warmup_steps=2, remat=False)
    jrun, run = JRunConfig(**kw), RunConfig(**kw)
    jmodel, model = jbuild(jcfg), build(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jopt = jmake_optimizer(jrun)
    jstate, jstep = jopt.init(jparams), jax.jit(
        jmake_train_step(jmodel, jopt, jrun))
    runs = {}
    for name, r in (("port", run), ("no decay", dataclasses.replace(
            run, weight_decay=0.0))):
        opt = make_optimizer(r)
        params = from_jax(_np(jparams), "cpu")
        runs[name] = [params, opt.init(params), make_train_step(model, opt,
                                                                r)]
    for i in range(3):
        jparams, jstate, jm = jstep(jparams, jstate, jsynthetic_batch(
            jcfg, batch=4, seq=32, step=i))
        batch = synthetic_batch(cfg, batch=4, seq=32, step=i, device="cpu")
        for name, r in runs.items():
            r[0], r[1], m = r[2](r[0], r[1], batch)
            if name == "port":
                assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                         rel=1e-5)
    want = from_jax(_np(jparams), "cpu")
    err, fault = _worst(runs["port"][0], want), _worst(runs["no decay"][0],
                                                       want)
    print(f"{arch}: 3 steps, worst leaf {err:.3g}; no decay {fault:.3g}")
    assert err < TRAIN_REL_L2 < fault
    assert _worst(runs["port"][1].m, from_jax(_np(jstate.m), "cpu")) \
        < TRAIN_REL_L2


def _same(a, b) -> None:
    """Two trees (AdamWState included) leaf for leaf to the bit, under the
    same checkpoint keys."""
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (key, x), (_, y) in zip(fa, fb):
        if isinstance(x, QTensor):
            assert torch.equal(x.data, y.data) and torch.equal(
                x.scale, y.scale), key
        else:
            assert x.dtype == y.dtype and x.shape == y.shape, key
            assert torch.equal(x, y), key


def test_resume_equals_uninterrupted(tmp_path):
    """A run preempted (SIGTERM) after step 3 commits its checkpoint there
    and stops; resumed, it equals the uninterrupted run to the bit."""
    cfg = get_config("llama3.2-3b", smoke=True)
    kw = dict(steps=6, learning_rate=1e-3, warmup_steps=2, remat=False,
              moment_dtype="int8", checkpoint_every=4)
    whole = train(cfg, RunConfig(**kw), batch=4, seq=16, device="cpu",
                  **QUIET)
    d = str(tmp_path / "ckpt")

    def preempt(line):
        if line.startswith("step 2:"):
            os.kill(os.getpid(), signal.SIGTERM)

    first = train(cfg, RunConfig(**kw, checkpoint_dir=d), batch=4, seq=16,
                  device="cpu", log_every=1, log_fn=preempt)
    assert ckpt.latest_step(d) == 3 and len(first["losses"]) == 3
    lines = []
    resumed = train(cfg, RunConfig(**kw, checkpoint_dir=d), batch=4,
                    seq=16, device="cpu", log_fn=lines.append)
    assert lines[0] == "resumed from step 3"
    assert resumed["losses"] == whole["losses"][3:]
    _same(resumed["params"], whole["params"])
    _same(resumed["opt_state"], whole["opt_state"])
    assert isinstance(resumed["opt_state"], AdamWState)
    assert ckpt.latest_step(d) == 6


def test_resumes_from_reference_checkpoint(tmp_path):
    """The JAX trainer writes step 3; the port resumes it (restored to the
    bit) and trains to 5, beside the JAX trainer resuming a copy."""
    arch = "llama3.2-3b"
    jcfg, cfg = _f32(arch, jget_config), _f32(arch, get_config)
    kw = dict(steps=3, learning_rate=1e-3, warmup_steps=2, remat=False,
              checkpoint_every=3)
    d, d2 = str(tmp_path / "port"), str(tmp_path / "ref")
    jres = jtrain(jcfg, JRunConfig(**kw, checkpoint_dir=d), batch=4, seq=16,
                  **QUIET)
    shutil.copytree(d, d2)
    model = build(cfg)
    opt = make_optimizer(RunConfig(**kw))
    skeleton = model.init(torch.Generator().manual_seed(0), "meta")
    (params, state), extra = ckpt.restore(
        d, (skeleton, opt.init(skeleton)), device="cpu")
    assert extra == {"step": 3, "data": {"step": 3, "seed": 0}}
    _same((params, state), from_jax(_np((jres["params"],
                                        jres["opt_state"])), "cpu"))
    more = dict(kw, steps=5)
    lines = []
    port = train(cfg, RunConfig(**more, checkpoint_dir=d), batch=4, seq=16,
                 device="cpu", log_fn=lines.append)
    ref = jtrain(jcfg, JRunConfig(**more, checkpoint_dir=d2), batch=4,
                 seq=16, **QUIET)
    assert lines[0] == "resumed from step 3" and len(port["losses"]) == 2
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)
    assert _worst(port["params"], from_jax(_np(ref["params"]), "cpu")) \
        < TRAIN_REL_L2


def test_int8_moments_restore_from_reference_checkpoint(tmp_path):
    """int8 ``QTensor`` moments (and f32 ones for the leaves too small or
    ragged for groups of 128) written by the JAX package's ``ckpt.save``
    come back to the bit under the reference's key paths."""
    jcfg = get_config("llama3.2-3b", smoke=True)
    jmodel = jbuild(jget_config("llama3.2-3b", smoke=True))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(1))
    run = JRunConfig(steps=4, moment_dtype="int8")
    jopt = jmake_optimizer(run)
    grads = jax.tree.map(lambda p: p * 0.01, jparams)
    jparams, jstate = jax.jit(jopt.update)(grads, jax.jit(jopt.init)(jparams),
                                           jparams)
    jckpt.save(str(tmp_path), 1, (jparams, jstate), extra={"step": 1})
    opt = make_optimizer(RunConfig(steps=4, moment_dtype="int8"))
    skeleton = build(jcfg).init(torch.Generator().manual_seed(0), "meta")
    tree, extra = ckpt.restore(str(tmp_path), (skeleton,
                                               opt.init(skeleton)),
                               device="cpu")
    want = from_jax(_np((jparams, jstate)), "cpu")
    assert any(isinstance(x, QTensor) for x in tree_leaves(tree[1].m))
    _same(tree, want)
    assert int(tree[1].count) == 1 and extra == {"step": 1}


@pytest.fixture(scope="module")
def trained():
    """The reference's tests/test_system.py fixture, on the port."""
    cfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True),
                              num_layers=4)
    run = RunConfig(steps=120, learning_rate=2e-3, warmup_steps=10,
                    remat=False, schedule="cosine")
    res = train(cfg, run, batch=16, seq=64, device="cpu", **QUIET)
    return res["model"], res["params"], res["losses"]


def test_training_learns(trained):
    _, _, losses = trained
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5     # clearly below ln(512) ~ 6.2


def test_plan_and_quantized_eval_ordering(trained):
    """A non-trivial EWQ plan of the trained weights, and raw ~
    8bit-mixed << uniform 4-bit held-out perplexity (paper Table 6)."""
    model, params, _ = trained
    plan = plan_model(model, params, variant="4bit/8bit")
    counts = plan.counts()
    assert counts["raw"] >= 1 and counts["int8"] + counts["int4"] >= 1
    ev_raw = evaluate(model, params, batch=8, seq=64, steps=4)
    evs = {}
    for variant in ("8bit-mixed", "4bit"):
        q = apply_plan_to_params(model, params,
                                 plan_model(model, params, variant=variant))
        evs[variant] = evaluate(model, q, batch=8, seq=64, steps=4)
    mixed = abs(evs["8bit-mixed"]["loss"] - ev_raw["loss"])
    bit4 = abs(evs["4bit"]["loss"] - ev_raw["loss"])
    assert mixed < 0.05, (ev_raw, evs)
    assert bit4 >= mixed - 1e-6
    assert ev_raw["perplexity"] == pytest.approx(np.exp(ev_raw["loss"]))
