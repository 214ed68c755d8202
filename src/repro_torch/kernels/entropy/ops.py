"""Softmax entropy of whole weight arrays: ``matrix_entropy``,
``entropy_many``.

``H = lse(w) - sum softmax(w) * w`` over each flattened array, in f32, with
eps = 0 (the closed form of the paper's section 3.1 analysis). Two
implementations side by side:

* the CUDA kernel (``csrc/entropy.cu``), launched for CUDA tensors: one
  launch takes a list of up to MAX_ARRAYS arrays (``entropy_many``; a
  model's analysis is one launch), reads each once in place (bf16 or f32),
  folds fixed tiles of TILE elements into partial (max, Z, S) states and
  merges each array's partials in tile order; it raises on what it does
  not take, never falls back. ``entropy_cuda(w)`` is
  ``entropy_many([w])[0]``; ``entropies`` cuts a longer list into
  launches of MAX_ARRAYS;
* ``entropy_plain``, which mirrors the JAX package's ``entropy_ref``
  (logsumexp, then the softmax-weighted sum), for tensors on the CPU and
  for ``plain=True`` on the GPU; ``entropy_many_plain`` stacks it.

``tile_plan``, ``tile_partials`` and ``merge_partials`` are the kernel's
tile plan and merge order in plain PyTorch (``entropy_tiled_plain``), so
the CPU tests can hold the plan to the reference.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import build

# elements of one tile: kTile in csrc/entropy.cu (the wrapper checks)
TILE = 8192
# threads of the kernel's merge (kFinalThreads, 32 warps): runs of
# partials a thread
MERGE_THREADS = 1024
# arrays one launch takes (kMaxArrays: the table, a kernel parameter)
MAX_ARRAYS = 1024
_DTYPES = (torch.bfloat16, torch.float32)


def entropy_plain(w: torch.Tensor) -> torch.Tensor:
    """f32 scalar: ``entropy_ref`` of the flattened array."""
    flat = w.reshape(-1).float()
    lse = torch.logsumexp(flat, dim=0)
    p = torch.exp(flat - lse)
    return lse - torch.sum(p * flat)


def entropy_many_plain(ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """f32 (len(ws),): ``entropy_plain`` of each array."""
    return torch.stack([entropy_plain(w) for w in ws])


def tile_plan(sizes: Sequence[int], tile: int = TILE) -> list:
    """The first tile of each array and, last, the tiles of all: array i
    owns tiles ``first[i] .. first[i + 1] - 1``, tile t of it its elements
    ``t * tile .. (t + 1) * tile - 1`` (the last one ragged)."""
    first = [0]
    for n in sizes:
        first.append(first[-1] + -(-int(n) // tile))
    return first


def tile_partials(w: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """(tiles, 3) f32: each tile's (max, Z, S) with Z = sum e^(x - max),
    S = sum x e^(x - max), as the kernel's pass 1 writes them."""
    flat = w.reshape(-1).float()
    out = []
    for lo in range(0, flat.numel(), tile):
        x = flat[lo:lo + tile]
        m = x.max()
        e = torch.exp(x - m)
        out.append(torch.stack([m, e.sum(), (x * e).sum()]))
    return torch.stack(out)


def _merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two (..., 3) states merged; two empty states (max -inf) give the
    empty state."""
    m = torch.maximum(a[..., 0], b[..., 0])
    empty = m == -math.inf
    ref = torch.where(empty, torch.zeros_like(m), m)
    ca, cb = torch.exp(a[..., 0] - ref), torch.exp(b[..., 0] - ref)
    z = a[..., 1] * ca + b[..., 1] * cb
    s = a[..., 2] * ca + b[..., 2] * cb
    return torch.stack([m, torch.where(empty, torch.zeros_like(z), z),
                        torch.where(empty, torch.zeros_like(s), s)], -1)


def merge_partials(parts: torch.Tensor) -> torch.Tensor:
    """An array's (tiles, 3) partials -> its (3,) state, merged in the
    kernel's pass-2 order: thread i of MERGE_THREADS merges a contiguous
    run of ceil(tiles / MERGE_THREADS) partials in order, the lanes of each
    warp merge pairwise in lane order (1, 2, 4, 8, 16 apart, the lower run
    on the left), then the warps' states in the same way."""
    n = parts.shape[0]
    run = -(-n // MERGE_THREADS)
    empty = torch.tensor([-math.inf, 0.0, 0.0], dtype=parts.dtype)
    padded = torch.cat([parts, empty.expand(MERGE_THREADS * run - n, 3)])
    padded = padded.reshape(MERGE_THREADS, run, 3)
    st = empty.expand(MERGE_THREADS, 3)
    for r in range(run):
        st = _merge(st, padded[:, r])
    st = _warp_merge(st.reshape(32, 32, 3))
    return _warp_merge(st[None, :, 0])[0, 0]


def _warp_merge(st: torch.Tensor) -> torch.Tensor:
    """(warps, 32, 3) lane states -> each lane's state after the kernel's
    ``warp_merge``: lane 0 holds its warp's states merged in lane order."""
    lane = torch.arange(32)
    for o in (1, 2, 4, 8, 16):
        other = st[:, lane ^ o]
        upper = ((lane & o) != 0)[None, :, None]
        st = _merge(torch.where(upper, other, st),
                    torch.where(upper, st, other))
    return st


def entropy_of_state(st: torch.Tensor) -> torch.Tensor:
    """H = (m + log Z) - S / Z of a (3,) state."""
    return (st[0] + torch.log(st[1])) - st[2] / st[1]


def entropy_tiled_plain(ws: Sequence[torch.Tensor],
                        tile: int = TILE) -> torch.Tensor:
    """f32 (len(ws),): the grouped kernel's plan in plain PyTorch. Every
    array's tiles are laid out in one partial buffer by ``tile_plan``, and
    array i's H comes from ``merge_partials`` over its own slice."""
    first = tile_plan([w.numel() for w in ws], tile)
    partial = torch.cat([tile_partials(w, tile) for w in ws])
    assert partial.shape[0] == first[-1]
    return torch.stack([entropy_of_state(merge_partials(
        partial[first[i]:first[i + 1]])) for i in range(len(ws))])


def _table(ws: list) -> tuple:
    """Raise on what the kernel does not take; else its table for ``ws``
    (per array {pointer, elements, 1 if bf16, first tile} as int64, read
    by the launch from host memory) and the tiles of all arrays."""
    if not ws:
        raise ValueError("entropy: no arrays")
    if len(ws) > MAX_ARRAYS:
        raise ValueError(f"entropy: {len(ws)} arrays, at most {MAX_ARRAYS} "
                         "a launch")
    dev, rows, tiles = ws[0].get_device(), [], 0
    for w in ws:
        n, dtype, d = w.numel(), w.dtype, w.get_device()
        if dtype not in _DTYPES:
            raise TypeError(f"entropy: w must be bf16 or f32, got {dtype}")
        if n == 0:
            raise ValueError("entropy: w is empty")
        if d < 0:
            raise ValueError("entropy: w must be a CUDA tensor")
        if d != dev:
            raise ValueError("entropy: the arrays lie on different devices")
        if not w.is_contiguous():
            raise ValueError("entropy: w must be contiguous")
        rows += (w.data_ptr(), n, dtype is torch.bfloat16, tiles)
        tiles += -(-n // TILE)
    if tiles >= 2 ** 31:
        raise ValueError(f"entropy: {tiles} tiles, past the kernel's int32")
    return np.array(rows, dtype=np.int64).reshape(-1, 4), tiles


def entropy_many(ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """The entropy kernel over a list of up to MAX_ARRAYS contiguous,
    non-empty bf16 or f32 CUDA tensors of any shapes, in one launch -> f32
    (len(ws),) of H on their device. An array's H depends on the array
    alone, not on the rest of the list."""
    ws = list(ws)
    table, tiles = _table(ws)
    lib = build.library("entropy")
    device = ws[0].device
    partial = torch.empty((tiles, 4), dtype=torch.float32, device=device)
    out = torch.empty((len(ws),), dtype=torch.float32, device=device)
    build.LAUNCHES["entropy"] += 1
    build.check(lib.repro_entropy_many(
        table.ctypes.data, len(ws), tiles, TILE, partial.data_ptr(),
        out.data_ptr(), build.stream_ptr(device)), "entropy")
    return out


def entropy_cuda(w: torch.Tensor) -> torch.Tensor:
    """The entropy kernel on one array: a table of one -> f32 scalar."""
    return entropy_many([w])[0]


def entropies(ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """f32 (len(ws),): the plain version of each array when all lie on the
    CPU; else the kernel, one launch a run of MAX_ARRAYS arrays (an
    array's H does not depend on the rest of its launch), which raises on
    a CPU tensor among them."""
    ws = [w.contiguous() for w in ws]
    if not any(w.is_cuda for w in ws):
        return entropy_many_plain(ws)
    hs = [entropy_many(ws[i:i + MAX_ARRAYS])
          for i in range(0, len(ws), MAX_ARRAYS)]
    return hs[0] if len(hs) == 1 else torch.cat(hs)


def matrix_entropy(w: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor or
    with ``plain=True``."""
    if w.is_cuda and not plain:
        return entropy_cuda(w.contiguous())
    return entropy_plain(w)
