"""Entropy analysis of weight matrices and transformer blocks (paper 3.1-3.2).

For a weight matrix W with n parameters:

    p_i = softmax(flatten(W))_i
    H(W) = -sum_i p_i * log(p_i + eps)          (eps = 1e-2 for stability)

and for a block containing matrices {W_i}:

    H_block = sum_i |W_i| * H(W_i) / sum_i |W_i|

* ``mode="paper"``  - the literal formula (materializes softmax), eps inside
  the log.
* ``mode="stream"`` - the closed form H = lse(w) - E_p[w] with an online
  (chunked) logsumexp and weighted sum; eps = 0.
* ``mode="kernel"`` - the entropy kernel, still to be ported (ROADMAP.md).

Matrices are analyzed on whatever device they live on, in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

DEFAULT_EPS = 0.01


def matrix_entropy_paper(w: torch.Tensor, eps: float = DEFAULT_EPS
                         ) -> torch.Tensor:
    """Literal paper formula: H = -sum p log(p + eps), p = softmax(flat(w))."""
    p = torch.softmax(w.reshape(-1).float(), dim=0)
    return -torch.sum(p * torch.log(p + eps))


def matrix_entropy_stream(w: torch.Tensor, chunk: int = 1 << 20
                          ) -> torch.Tensor:
    """H = logsumexp(w) - sum(w e^w) / sum(e^w), merged chunk by chunk with
    a running max m, Z = sum e^(w - m) and S = sum w e^(w - m)."""
    flat = w.reshape(-1).float()
    m = torch.tensor(float("-inf"), device=flat.device)
    z = torch.zeros((), device=flat.device)
    s = torch.zeros((), device=flat.device)
    for lo in range(0, flat.numel(), chunk):
        x = flat[lo:lo + chunk]
        new_m = torch.maximum(m, x.max())
        scale = torch.exp(m - new_m)
        e = torch.exp(x - new_m)
        z = z * scale + e.sum()
        s = s * scale + (x * e).sum()
        m = new_m
    return (m + torch.log(z)) - s / z


def matrix_entropy(w: torch.Tensor, *, mode: str = "paper",
                   eps: float = DEFAULT_EPS) -> torch.Tensor:
    if mode == "paper":
        return matrix_entropy_paper(w, eps=eps)
    if mode == "stream":
        return matrix_entropy_stream(w)
    if mode == "kernel":
        raise NotImplementedError(
            "mode='kernel' needs the entropy kernel (entropy_pallas), which "
            "is still to be ported; use mode='paper' or 'stream'")
    raise ValueError(f"unknown entropy mode: {mode}")


@dataclasses.dataclass(frozen=True)
class BlockEntropy:
    """Entropy record for one transformer block."""
    block_index: int          # 0-based model-definition index
    exec_index: int           # paper-style execution index
    entropy: float            # weighted H_block
    num_parameters: int       # sum of |W_i|
    per_matrix: dict[str, tuple[float, int]]  # name -> (H, size)


def block_entropy_from_matrices(
    mats: Mapping[str, torch.Tensor], *, mode: str = "paper",
    eps: float = DEFAULT_EPS,
) -> tuple[float, int, dict[str, tuple[float, int]]]:
    """Size-weighted block entropy over the >= 2-D (Linear / Embedding)
    matrices; vectors (norm scales, biases) are excluded."""
    per: dict[str, tuple[float, int]] = {}
    total = 0
    acc = 0.0
    for name, w in sorted(mats.items()):
        if w.ndim < 2:
            continue
        size = int(np.prod(tuple(w.shape)))
        h = float(matrix_entropy(w, mode=mode, eps=eps))
        per[name] = (h, size)
        total += size
        acc += h * size
    if total == 0:
        return 0.0, 0, per
    return acc / total, total, per


def flatten_block_params(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Flatten a nested param dict into {dotted_name: tensor}."""
    out: dict[str, Any] = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(flatten_block_params(v, f"{prefix}{k}."))
    else:
        out[prefix[:-1]] = tree
    return out


def analyze_blocks(
    blocks: Sequence[Mapping[str, torch.Tensor]], *, mode: str = "paper",
    eps: float = DEFAULT_EPS, first_exec_index: int = 2,
) -> list[BlockEntropy]:
    """Per-block entropy for a sequence of block param dicts."""
    out = []
    for i, blk in enumerate(blocks):
        mats = flatten_block_params(blk)
        h, n, per = block_entropy_from_matrices(mats, mode=mode, eps=eps)
        out.append(BlockEntropy(block_index=i, exec_index=first_exec_index + i,
                                entropy=h, num_parameters=n, per_matrix=per))
    return out


def entropy_stats(entropies: Sequence[float]) -> tuple[float, float]:
    """(mu, sigma) over block entropies; population std (paper 3.3.2)."""
    arr = np.asarray(entropies, dtype=np.float64)
    return float(arr.mean()), float(arr.std())
