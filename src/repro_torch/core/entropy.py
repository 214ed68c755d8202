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
* ``mode="kernel"`` - the closed form through the entropy kernel
  (``kernels/entropy``): ``analyze_blocks`` hands every matrix of every
  block to one grouped kernel launch on the GPU (one read of each matrix,
  in place, and one read-back of all entropies; the host names and sorts
  the matrices while the card reads them); CPU tensors take the plain
  version (``entropy_ref``'s arithmetic). eps = 0.

Matrices are analyzed on whatever device they live on, in f32.
"""

from __future__ import annotations

import dataclasses
from collections import abc
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.kernels.entropy.ops import entropies as kernel_entropies
from repro_torch.kernels.entropy.ops import matrix_entropy as kernel_entropy

DEFAULT_EPS = 0.01


def matrix_entropy_paper(w: torch.Tensor, eps: float = DEFAULT_EPS
                         ) -> torch.Tensor:
    """Literal paper formula: H = -sum p log(p + eps), p = softmax(flat(w))."""
    p = torch.softmax(w.reshape(-1).float(), dim=0)
    return -torch.sum(p * torch.log(p + eps))


def matrix_entropy_stream(w: torch.Tensor, chunk: int = 1 << 20
                          ) -> torch.Tensor:
    """H = logsumexp(w) - sum(w e^w) / sum(e^w), merged chunk by chunk with
    a running max m, Z = sum e^(w - m) and S = sum w e^(w - m). Each chunk
    is summed in f32 (goes to f32 on its own: no f32 copy of the whole
    matrix, and an MoE expert stack holds billions of elements); the
    running Z and S merge in f64, so a matrix of thousands of chunks keeps
    the accuracy of one (an f32 running sum over 1600 chunks drifts by
    ~1e-5 in H)."""
    flat = w.reshape(-1)
    m = torch.tensor(float("-inf"), device=flat.device)
    z = torch.zeros((), dtype=torch.float64, device=flat.device)
    s = torch.zeros((), dtype=torch.float64, device=flat.device)
    for lo in range(0, flat.numel(), chunk):
        x = flat[lo:lo + chunk].float()
        new_m = torch.maximum(m, x.max())
        scale = torch.exp((m - new_m).double())
        e = torch.exp(x - new_m)
        z = z * scale + e.sum().double()
        s = s * scale + (x * e).sum().double()
        m = new_m
    return ((m.double() + torch.log(z)) - s / z).float()


def matrix_entropy(w: torch.Tensor, *, mode: str = "paper",
                   eps: float = DEFAULT_EPS) -> torch.Tensor:
    if mode == "paper":
        return matrix_entropy_paper(w, eps=eps)
    if mode == "stream":
        return matrix_entropy_stream(w)
    if mode == "kernel":
        return kernel_entropy(w)
    raise ValueError(f"unknown entropy mode: {mode}")


@dataclasses.dataclass(frozen=True)
class BlockEntropy:
    """Entropy record for one transformer block."""
    block_index: int          # 0-based model-definition index
    exec_index: int           # paper-style execution index
    entropy: float            # weighted H_block
    num_parameters: int       # sum of |W_i|
    per_matrix: dict[str, tuple[float, int]]  # name -> (H, size)


def _block_matrices(mats: Mapping[str, torch.Tensor]) -> list:
    """The >= 2-D (Linear / Embedding) matrices of a block by sorted name;
    vectors (norm scales, biases) are excluded."""
    return [(name, w) for name, w in sorted(mats.items()) if w.ndim >= 2]


def _weighted(sized: Sequence, hs: Sequence[float]
              ) -> tuple[float, int, dict[str, tuple[float, int]]]:
    """(block entropy, parameters, name -> (H, size)) of a block's
    (name, size) matrices and their entropies."""
    per: dict[str, tuple[float, int]] = {}
    total = 0
    acc = 0.0
    for (name, size), h in zip(sized, hs):
        per[name] = (h, size)
        total += size
        acc += h * size
    if total == 0:
        return 0.0, 0, per
    return acc / total, total, per


def block_entropy_from_matrices(
    mats: Mapping[str, torch.Tensor], *, mode: str = "paper",
    eps: float = DEFAULT_EPS,
) -> tuple[float, int, dict[str, tuple[float, int]]]:
    """Size-weighted block entropy over the >= 2-D (Linear / Embedding)
    matrices; vectors (norm scales, biases) are excluded."""
    named = _block_matrices(mats)
    return _weighted([(name, w.numel()) for name, w in named],
                     [float(matrix_entropy(w, mode=mode, eps=eps))
                      for _, w in named])


def flatten_block_params(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Flatten a nested param dict into {dotted_name: tensor}."""
    out: dict[str, Any] = {}
    _flatten_into(out, tree, prefix)
    return out


def _flatten_into(out: dict, tree: Any, prefix: str) -> None:
    # a tensor is tested first: the Mapping check is slow on a non-mapping
    if isinstance(tree, torch.Tensor) or not isinstance(tree, abc.Mapping):
        out[prefix[:-1]] = tree
        return
    for k, v in tree.items():
        _flatten_into(out, v, f"{prefix}{k}.")


def _matrices_into(out: list, tree: Any) -> None:
    # flatten_block_params's walk without the names: the >= 2-D leaves in
    # its order
    if isinstance(tree, torch.Tensor) or not isinstance(tree, abc.Mapping):
        if tree.ndim >= 2:
            out.append(tree)
        return
    for v in tree.values():
        _matrices_into(out, v)


def _kernel_mode(blocks: Sequence) -> tuple[list, list]:
    """Kernel mode over all blocks: every matrix in one ``kernels/entropy``
    call, launched before the host names and sorts the matrices (on the GPU
    that work then overlaps the card's read), read back at once. Returns
    per block its (name, size) matrices by sorted name and their entropies.
    An array's entropy does not depend on its place in the launch, so each
    equals the per-matrix path's."""
    flat: list = []
    for blk in blocks:
        _matrices_into(flat, blk)
    hs = kernel_entropies(flat) if flat else None   # on the GPU: launched
    walked = [[(name, w.numel()) for name, w in
               flatten_block_params(blk).items() if w.ndim >= 2]
              for blk in blocks]
    if sum(map(len, walked)) != len(flat):
        raise ValueError("entropy: two matrices of a block share a name")
    it = iter(hs.tolist() if flat else [])
    sized, hss = [], []
    for items in walked:
        pairs = sorted(zip(items, [next(it) for _ in items]),
                       key=lambda p: p[0][0])
        sized.append([s for s, _ in pairs])
        hss.append([h for _, h in pairs])
    return sized, hss


def analyze_blocks(
    blocks: Sequence[Mapping[str, torch.Tensor]], *, mode: str = "paper",
    eps: float = DEFAULT_EPS, first_exec_index: int = 2,
) -> list[BlockEntropy]:
    """Per-block entropy for a sequence of block param dicts. In kernel
    mode every matrix of every block goes to one ``kernels/entropy`` call
    (one launch on the GPU), read back at once; each block's weighting is
    the per-matrix path's arithmetic on the same entropies."""
    if mode == "kernel":
        sized, hss = _kernel_mode(blocks)
    else:
        named = [_block_matrices(flatten_block_params(blk)) for blk in blocks]
        sized = [[(name, w.numel()) for name, w in mats] for mats in named]
        hss = [[float(matrix_entropy(w, mode=mode, eps=eps)) for _, w in mats]
               for mats in named]
    out = []
    for i, (mats, hs) in enumerate(zip(sized, hss)):
        h, n, per = _weighted(mats, hs)
        out.append(BlockEntropy(block_index=i, exec_index=first_exec_index + i,
                                entropy=h, num_parameters=n, per_matrix=per))
    return out


def entropy_stats(entropies: Sequence[float]) -> tuple[float, float]:
    """(mu, sigma) over block entropies; population std (paper 3.3.2)."""
    arr = np.asarray(entropies, dtype=np.float64)
    return float(arr.mean()), float(arr.std())
