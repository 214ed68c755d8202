"""Softmax entropy of a whole weight array: ``matrix_entropy``.

``H = lse(w) - sum softmax(w) * w`` over the flattened array, in f32, with
eps = 0 (the closed form of the paper's section 3.1 analysis). Two
implementations side by side:

* the CUDA kernel (``csrc/entropy.cu``), launched for a tensor on the GPU:
  one read of the array in place (bf16 or f32), per-block online
  (max, Z, S) states merged in a fixed order; it raises on what it does not
  take, never falls back;
* ``entropy_plain``, which mirrors the JAX package's ``entropy_ref``
  (logsumexp, then the softmax-weighted sum), for a tensor on the CPU and
  for ``plain=True`` on the GPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build


def entropy_plain(w: torch.Tensor) -> torch.Tensor:
    """f32 scalar: ``entropy_ref`` of the flattened array."""
    flat = w.reshape(-1).float()
    lse = torch.logsumexp(flat, dim=0)
    p = torch.exp(flat - lse)
    return lse - torch.sum(p * flat)


def entropy_cuda(w: torch.Tensor) -> torch.Tensor:
    """The entropy kernel: a contiguous bf16 or f32 CUDA tensor of any
    shape -> f32 scalar on the same device."""
    if not w.is_cuda:
        raise ValueError("entropy: w must be a CUDA tensor")
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"entropy: w must be bf16 or f32, got {w.dtype}")
    if not w.is_contiguous():
        raise ValueError("entropy: w must be contiguous")
    n = w.numel()
    if n == 0:
        raise ValueError("entropy: w is empty")
    lib = build.library("entropy")
    parts = lib.repro_entropy_parts(n)
    partial = torch.empty((parts, 3), dtype=torch.float32, device=w.device)
    out = torch.empty((), dtype=torch.float32, device=w.device)
    build.LAUNCHES["entropy"] += 1
    build.check(lib.repro_entropy(
        w.data_ptr(), int(w.dtype == torch.bfloat16), n,
        int(w.data_ptr() % 16 == 0), parts, partial.data_ptr(),
        out.data_ptr(), build.stream_ptr(w.device)), "entropy")
    return out


def matrix_entropy(w: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor or
    with ``plain=True``."""
    if w.is_cuda and not plain:
        return entropy_cuda(w.contiguous())
    return entropy_plain(w)
