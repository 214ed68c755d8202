"""Shared model building blocks (norms, init, rope, embeddings, lm head).

Conventions, as in the JAX reference:
* every weight matrix is stored ``(out_features, in_features)`` and applied
  with ``qdot``, so quantization groups along the last axis coincide with
  the contraction axis;
* stacked layers carry a leading layer axis;
* activations are bf16 at full width, reductions and softmax in f32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.qmatmul.ops import qdot
from repro_torch.quant.qtypes import QTensor
from repro_torch.quant.quantize import unpack_int4

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def decode_positions(pos: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """(B, S) int32 token positions for a decode step; ``pos`` is a scalar
    or a (B,) per-slot vector of cache positions."""
    step = torch.arange(s, dtype=torch.int32, device=pos.device)[None]
    if pos.ndim == 1:
        return pos.to(torch.int32)[:, None] + step
    return (pos.to(torch.int32) + step).expand(b, s)


# --------------------------------------------------------------------------
# Initializers (the JAX package's scales; seeded torch.Generator)
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: tuple, dtype, device,
               scale: float = 1.0) -> torch.Tensor:
    """Normal(0, scale / sqrt(in_features)) for a (..., out, in) weight."""
    std = scale / shape[-1] ** 0.5
    return (torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype,
               device) -> torch.Tensor:
    return (torch.randn((vocab, dim), generator=gen, device=device,
                        dtype=torch.float32) * 0.02).to(dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, w, eps: float = 1e-5) -> torch.Tensor:
    """Non-parametric when w is None (OLMo-style)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.float()
    return y.to(x.dtype)


def norm(x, w, cfg):
    if cfg.nonparametric_norm:
        return layer_norm(x, None, cfg.norm_eps)
    return rms_norm(x, w, cfg.norm_eps)


# --------------------------------------------------------------------------
# Rotary position embedding
# --------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int32."""
    half = x.shape[-1] // 2
    expo = torch.arange(half, dtype=torch.float32, device=x.device) / half
    # torch.full, not torch.tensor: no host-to-device copy, so a decode
    # step can be captured in a CUDA graph
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                       device=x.device), expo)
    ang = positions.float()[..., None] * freqs           # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Embedding lookup (quant-aware) and the head
# --------------------------------------------------------------------------

def embed_lookup(table, ids: torch.Tensor, dtype) -> torch.Tensor:
    if isinstance(table, QTensor):
        rows = table.data[ids]
        scales = table.scale[ids]
        if table.precision == "int4":
            rows = unpack_int4(rows)
        k = rows.shape[-1]
        g = rows.float().reshape(*rows.shape[:-1], k // table.group,
                                 table.group)
        out = (g * scales.float()[..., None]).reshape(*rows.shape[:-1], k)
        return out.to(dtype)
    return table[ids].to(dtype)


def lm_head(x: torch.Tensor, head_w, plain: bool = False) -> torch.Tensor:
    """Final projection to (padded) vocab logits in f32."""
    return qdot(x, head_w, out_dtype=torch.float32, plain=plain)
