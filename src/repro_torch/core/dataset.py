"""FastEWQ's training rows (paper §4.1).

Each row describes one transformer block:
  (model_name, num_blocks, exec_index, num_parameters,
   quantization_type, quantized)

A row comes from a full EWQ plan (``rows_from_plan``). ``build_dataset``
makes the plans as the JAX package does: it trains a reduced instance of
each architecture briefly (random init gives a near-degenerate entropy
spread) and runs EWQ on it, on the caller's device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

FEATURES = ("num_parameters", "exec_index", "num_blocks")


@dataclasses.dataclass(frozen=True)
class BlockRow:
    model_name: str
    num_blocks: int
    exec_index: int
    num_parameters: int
    quantization_type: str  # "raw" | "8-bit" | "4-bit"
    quantized: int          # 0 | 1


def rows_from_plan(model_name: str, plan) -> list[BlockRow]:
    n = len(plan.decisions)
    out = []
    for d in plan.decisions:
        qt = {"raw": "raw", "int8": "8-bit", "int4": "4-bit",
              "int3": "4-bit", "ternary": "4-bit"}[d.precision]
        out.append(BlockRow(model_name=model_name, num_blocks=n,
                            exec_index=d.exec_index,
                            num_parameters=d.num_parameters,
                            quantization_type=qt,
                            quantized=int(d.precision != "raw")))
    return out


def to_xy(rows: Sequence[BlockRow]):
    x = np.array([[r.num_parameters, r.exec_index, r.num_blocks]
                  for r in rows], np.float64)
    y = np.array([r.quantized for r in rows], np.int64)
    return x, y


def train_test_split(x, y, test_frac: float = 0.3, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = len(y)
    idx = rng.permutation(n)
    n_test = int(round(n * test_frac))
    te, tr = idx[:n_test], idx[n_test:]
    return x[tr], y[tr], x[te], y[te]


def train_reduced(arch: str, seed: int, *, steps: int,
                  scale_overrides: dict | None = None, device=None):
    """One model of ``build_dataset``: ``arch``'s SMOKE config deepened
    (hybrid 8 layers, enc-dec 6, the others 9), initialized from a
    ``torch.Generator`` seeded with ``seed`` and trained ``steps`` steps of
    batch 8 x 64 tokens of synthetic data. Returns (model, params)."""
    import torch

    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.models.model import build
    from repro_torch.train.step import make_train_step

    cfg = get_config(arch, smoke=True)
    # deepen the reduced configs so each model contributes a
    # realistic number of block rows (paper: 700 rows)
    depth = {"hybrid": 8, "encdec": 6}.get(cfg.family, 9)
    cfg = dataclasses.replace(cfg, num_layers=depth)
    if scale_overrides:
        cfg = dataclasses.replace(cfg, **scale_overrides)
    model = build(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init(gen, device)
    run = RunConfig(steps=steps, learning_rate=1e-3, warmup_steps=5,
                    remat=False)
    opt = make_optimizer(run)
    opt_state = opt.init(params)
    step = make_train_step(model, opt, run)
    for i in range(steps):
        batch = synthetic_batch(cfg, batch=8, seq=64, step=i, seed=seed,
                                device=device)
        params, opt_state, _ = step(params, opt_state, batch)
    return model, params


def build_dataset(*, steps: int = 60, seeds: Sequence[int] = (0,),
                  archs: Sequence[str] | None = None,
                  scale_overrides: dict | None = None,
                  device=None) -> list[BlockRow]:
    """Train each reduced arch briefly from each of ``seeds``
    (``train_reduced``), plan it 4bit/8bit with the reference's analysis
    (paper mode: plain PyTorch on ``device``, no entropy kernel) and
    collect its block rows. ``device`` None means the GPU."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.planner import plan_model
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    rows: list[BlockRow] = []
    for arch in (archs or ARCHS):
        for seed in seeds:
            model, params = train_reduced(arch, seed, steps=steps,
                                          scale_overrides=scale_overrides,
                                          device=device)
            plan = plan_model(model, params, variant="4bit/8bit")
            rows.extend(rows_from_plan(f"{model.cfg.name}-s{seed}", plan))
    return rows
