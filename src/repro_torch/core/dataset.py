"""FastEWQ's training rows (paper §4.1).

Each row describes one transformer block:
  (model_name, num_blocks, exec_index, num_parameters,
   quantization_type, quantized)

A row comes from a full EWQ plan (``rows_from_plan``). The JAX package also
builds its dataset (``build_dataset``): it trains a reduced instance of each
architecture family briefly and runs EWQ on it. The port leaves that function
out until it has a training loop (ROADMAP.md queue 1, items 8 and 9b); the
rows here come from plans the caller already holds.
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
