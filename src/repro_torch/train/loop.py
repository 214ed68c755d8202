"""Training loop: data, step, checkpoint/auto-resume, fault handling.

Composes the deterministic synthetic data (``data/synthetic.py``), the
train step (``train/step.py``), atomic checkpoints with auto-resume
(``checkpoint/ckpt.py``) and the fault-tolerance runtime
(``runtime/fault.py``), on one device or on a mesh (the reference's
contract: ``launch/train.py`` passes none, a caller may).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.data.synthetic import DataLoader
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_optimizer
from repro_torch.models.model import Model, build
from repro_torch.runtime.fault import PreemptionGuard, StepWatchdog
from repro_torch.sharding.specs import (opt_state_specs, param_specs,
                                        positions, shard_tree)
from repro_torch.train.step import make_eval_step, make_train_step
from repro_torch.tree import tree_leaves, tree_map


def _restore(run: RunConfig, opt, params, mesh, device):
    """(params, opt_state, extra), each from the latest checkpoint of
    ``run.checkpoint_dir`` when there is one (extra None when not). Over a
    mesh the init's params are placed by ``param_specs`` and the state
    zeroed on the placement, or both restored straight onto the mesh: a
    checkpoint holds logical arrays, whichever mesh (or none) wrote it."""
    last = (ckpt.latest_step(run.checkpoint_dir) if run.checkpoint_dir
            else None)
    if mesh is None:
        opt_state = opt.init(params)
        if last is None:
            return params, opt_state, None
        (params, opt_state), extra = ckpt.restore(
            run.checkpoint_dir, (params, opt_state), device=device)
        return params, opt_state, extra
    pspecs = param_specs(params, mesh)
    if last is None:
        placed = shard_tree(params, pspecs, mesh)
        return placed, opt.init(placed), None
    like = tree_map(lambda p: torch.empty_like(p, device="meta"), params)
    like = (like, opt.init(like))
    placed, extra = ckpt.restore(
        run.checkpoint_dir, like, mesh=mesh,
        specs=(pspecs, opt_state_specs(like[1], pspecs, mesh)))
    return placed.field(0), placed.field(1), extra


def train(cfg: ModelConfig, run: RunConfig, *, batch: int = 8, seq: int = 64,
          mesh=None, log_every: int = 10,
          log_fn: Callable[[str], None] = print, device=None) -> dict:
    """Train ``cfg`` for ``run.steps`` on synthetic data on ``device``
    (None: the GPU; with a ``mesh``, its first position's device), from an
    init drawn by a ``torch.Generator`` seeded with ``run.seed``.
    Auto-resumes from ``run.checkpoint_dir`` when it holds a checkpoint.
    With ``mesh`` (``launch/mesh.py``; the dense family) the params and the
    optimizer state are placed on it by the reference's training rules
    and every step is a mesh step; its results equal the mesh-less run's
    to rounding, checkpoints hold the logical arrays, and ``params`` and
    ``opt_state`` come back placed (``sharding.specs.MeshTree``). Returns
    the params, the optimizer state, the loss of each step, each step's
    wall seconds and the watchdog's stragglers."""
    if mesh is not None and device is None:
        device = mesh.devices[positions(mesh)[0]]
    device = resolve_device(device)
    model = build(cfg)
    opt = make_optimizer(run)
    gen = torch.Generator(device=device).manual_seed(run.seed)
    params, opt_state, extra = _restore(run, opt, model.init(gen, device),
                                        mesh, device)
    loader = DataLoader(cfg, global_batch=batch, seq=seq, seed=run.seed,
                        device=device)
    start_step = 0
    if extra is not None:
        loader.restore(extra["data"])
        start_step = int(extra["step"])
        log_fn(f"resumed from step {start_step}")

    step_fn = make_train_step(model, opt, run, mesh=mesh)
    watchdog = StepWatchdog()
    history, step_s = [], []

    with PreemptionGuard() as guard:
        for step in range(start_step, run.steps):
            t0 = time.time()
            batch_data = next(loader)
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 batch_data)
            loss = float(metrics["loss"])       # waits for the step
            dt = time.time() - t0
            verdict = watchdog.observe(dt)
            history.append(loss)
            step_s.append(dt)
            if step % log_every == 0 or step == run.steps - 1:
                log_fn(f"step {step}: loss {loss:.4f} "
                       f"({dt*1000:.0f} ms{', straggler' if verdict != 'ok' else ''})")
            should_ckpt = run.checkpoint_dir and (
                (step + 1) % run.checkpoint_every == 0
                or step == run.steps - 1 or guard.preempted)
            if should_ckpt:
                ckpt.save(run.checkpoint_dir, step + 1, (params, opt_state),
                          extra={"step": step + 1, "data": loader.state()},
                          keep=run.keep_checkpoints)
            if guard.preempted:
                log_fn(f"preempted at step {step}; checkpoint committed")
                break

    return {"params": params, "opt_state": opt_state, "losses": history,
            "final_loss": history[-1] if history else float("nan"),
            "step_s": step_s, "stragglers": watchdog.stragglers,
            "model": model}


def evaluate(model: Model, params, *, batch: int = 8, seq: int = 64,
             steps: int = 8, seed: int = 0, start_step: int = 100_000,
             device=None) -> dict:
    """Held-out loss and perplexity: the same seed (the same synthetic
    language), a disjoint step range (a different seed would be a different
    language). ``params`` may be raw or compiled (quantized: on the GPU the
    qmatmul / qkv / qmlp kernels run at M = batch * seq); ``device``
    defaults to the params'."""
    if device is None:
        first = tree_leaves(params["embed"])[0]
        device = first.device
    eval_fn = make_eval_step(model)
    loader = DataLoader(model.cfg, global_batch=batch, seq=seq, seed=seed,
                        start_step=start_step, device=device)
    losses = []
    for _ in range(steps):
        m = eval_fn(params, next(loader))
        losses.append(float(m["loss"]))
    mean = float(np.mean(losses))
    return {"loss": mean, "perplexity": float(np.exp(mean))}
