"""Group-wise absmax int8 quantization: ``quantize_int8``.

``quantize_int8(w, group)`` takes a (N, K) weight and returns the int8
payload (N, K) and **f32** scales (N, K / group): ``scale = absmax / 127``,
``q = clip(round(w / scale), -127, 127)`` (a zero group divides by 1). The
f32 scales are the reference kernel's (``quantize_int8_ref``); the serve
path's QTensor keeps bf16 scales (``quant/quantize.py``), so nothing on it
calls this. Two implementations side by side, bit-identical:

* the CUDA kernel (``csrc/quantize.cu``), launched for a tensor on the
  GPU; it raises on what it does not take, never falls back;
* ``quantize_int8_plain``, which mirrors ``quantize_int8_ref``, for a tensor
  on the CPU and for ``plain=True`` on the GPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build


def quantize_int8_plain(w: torch.Tensor, group: int = 128):
    """(N, K) -> (int8 (N, K), f32 scales (N, K // group))."""
    n, k = w.shape
    g = w.float().reshape(n, k // group, group)
    amax = g.abs().amax(dim=-1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the correctly rounded
    # quotient the reference and the kernel compute
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.round(g / safe[..., None]).clamp(-127, 127).to(torch.int8)
    return q.reshape(n, k), scale


def quantize_int8_cuda(w: torch.Tensor, group: int = 128):
    """The quantize kernel: a contiguous (N, K) bf16 or f32 CUDA tensor,
    K % group == 0."""
    if not w.is_cuda:
        raise ValueError("quantize_int8: w must be a CUDA tensor")
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quantize_int8: w must be bf16 or f32, got "
                        f"{w.dtype}")
    if w.ndim != 2 or not w.is_contiguous():
        raise ValueError("quantize_int8: w must be a contiguous (N, K) "
                         "tensor")
    n, k = w.shape
    if group < 1 or k % group:
        raise ValueError(f"quantize_int8: K={k} is not a multiple of "
                         f"group={group}")
    q = torch.empty((n, k), dtype=torch.int8, device=w.device)
    scale = torch.empty((n, k // group), dtype=torch.float32,
                        device=w.device)
    if n == 0 or k == 0:
        return q, scale
    lib = build.library("quantize")
    build.LAUNCHES["quantize_int8"] += 1
    build.check(lib.repro_quantize_int8(
        w.data_ptr(), int(w.dtype == torch.bfloat16), n, k, group,
        q.data_ptr(), scale.data_ptr(), build.stream_ptr(w.device)),
        "quantize_int8")
    return q, scale


def quantize_int8(w: torch.Tensor, group: int = 128, plain: bool = False):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor or
    with ``plain=True``."""
    if w.is_cuda and not plain:
        return quantize_int8_cuda(w.contiguous(), group)
    return quantize_int8_plain(w, group)
