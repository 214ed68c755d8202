"""Group-wise symmetric absmax quantization (int8 / packed int4 / ternary).

Quantization groups run along the tensor's LAST axis. Matmul weights are
stored ``(out_features, in_features)`` (stacked ``(layers, out, in)``), so the
last axis is the contraction axis and the per-group scale factors out of each
partial dot product. Embedding tables (V, D) are gathered along axis 0, so
per-row groups along D dequantize cheaply at lookup.

The arithmetic is f32 and rounds half to even (``torch.round``), so payloads
and bf16 scales are bit-identical to the JAX reference's for the same
inputs. int4 packing: two nibbles per byte, low nibble = even element, so a
(..., K) tensor stores (..., K // 2) int8. "int3" uses the int4 carrier and
clips to +-7, as the reference does.
"""

from __future__ import annotations

import torch

from repro_torch.quant.qtypes import DEFAULT_GROUP, QTensor


def _grouped(w: torch.Tensor, group: int) -> torch.Tensor:
    *lead, k = w.shape
    assert k % group == 0, f"last dim {k} not divisible by group {group}"
    return w.reshape(*lead, k // group, group)


def _absmax_levels(w: torch.Tensor, group: int, qmax: float):
    g = _grouped(w.float(), group)
    scale = g.abs().amax(dim=-1, keepdim=True) / qmax
    q = torch.round(g / torch.where(scale == 0, torch.ones_like(scale), scale))
    q = q.clamp(-qmax, qmax).to(torch.int8)
    return q.reshape(w.shape), scale[..., 0].to(torch.bfloat16)


def quantize_int8(w: torch.Tensor, group: int = DEFAULT_GROUP) -> QTensor:
    q, scale = _absmax_levels(w, group, 127.0)
    return QTensor(data=q, scale=scale, precision="int8",
                   shape=tuple(w.shape), group=group)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 levels in [-8, 7] -> (..., K // 2) packed bytes."""
    *lead, k = q.shape
    q2 = q.to(torch.int32).reshape(*lead, k // 2, 2)
    byte = (q2[..., 0] & 0x0F) | ((q2[..., 1] & 0x0F) << 4)
    return byte.to(torch.uint8).view(torch.int8)


def quantize_int4(w: torch.Tensor, group: int = DEFAULT_GROUP) -> QTensor:
    q, scale = _absmax_levels(w, group, 7.0)
    return QTensor(data=pack_int4(q), scale=scale, precision="int4",
                   shape=tuple(w.shape), group=group)


def unpack_int4(data: torch.Tensor) -> torch.Tensor:
    """Unpack packed nibbles back to signed int8 in [-8, 7]."""
    d = data.to(torch.int16)
    lo = ((d & 0x0F) ^ 8) - 8
    hi = ((d >> 4) & 0x0F ^ 8) - 8
    out = torch.stack([lo, hi], dim=-1).to(torch.int8)
    return out.reshape(*data.shape[:-1], data.shape[-1] * 2)


def quantize_ternary(w: torch.Tensor, group: int = DEFAULT_GROUP) -> QTensor:
    """1.58-bit ternary: W ~ scale * sign(W) * 1{|W| > tau}, tau = 0.5 *
    mean(|W|) per group; the scale minimizes ||W - s q||^2 per group."""
    g = _grouped(w.float(), group)
    absmean = g.abs().mean(dim=-1, keepdim=True)
    q = torch.where(g.abs() > 0.5 * absmean, torch.sign(g),
                    torch.zeros_like(g))
    num = (g * q).sum(dim=-1, keepdim=True)
    den = (q * q).sum(dim=-1, keepdim=True)
    scale = num / torch.where(den == 0, torch.ones_like(den), den)
    return QTensor(data=q.reshape(w.shape).to(torch.int8),
                   scale=scale[..., 0].to(torch.bfloat16),
                   precision="ternary", shape=tuple(w.shape), group=group)


def quantize(w: torch.Tensor, precision: str,
             group: int = DEFAULT_GROUP) -> QTensor:
    if precision == "int8":
        return quantize_int8(w, group)
    if precision in ("int4", "int3"):
        return quantize_int4(w, group)
    if precision == "ternary":
        return quantize_ternary(w, group)
    raise ValueError(f"cannot quantize to precision={precision!r}")


def dequantize(q: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize. Shapes come from ``q.data``, so layer slices work."""
    if q.precision == "int4":
        vals = unpack_int4(q.data).float()
    elif q.precision in ("int8", "ternary"):
        vals = q.data.float()
    else:
        raise ValueError(q.precision)
    *lead, k = vals.shape
    g = vals.reshape(*lead, k // q.group, q.group)
    out = g * q.scale.float()[..., None]
    return out.reshape(*lead, k).to(dtype)
