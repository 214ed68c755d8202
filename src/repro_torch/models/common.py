"""Shared model building blocks (norms, init, rope, sinusoidal positions,
embeddings, lm head).

Conventions, as in the JAX reference:
* every weight matrix is stored ``(out_features, in_features)`` and applied
  with ``qdot``, so quantization groups along the last axis coincide with
  the contraction axis;
* stacked layers carry a leading layer axis;
* activations are bf16 at full width, reductions and softmax in f32.
"""

from __future__ import annotations

import numpy as np
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


def select_snapshot(snaps: torch.Tensor, idx: torch.Tensor,
                    batch_axis: int = 2) -> torch.Tensor:
    """Per-slot gather over stacked sequential-state snapshots: ``snaps``
    holds N checkpoints stacked on a new leading axis, so the slot axis
    sits at ``batch_axis`` (2 for the usual (N, L, B, ...) state stack);
    ``idx`` (B,) picks each slot's snapshot in [0, N). Returns the
    un-stacked layout (slot axis back at ``batch_axis - 1``): the SSM-state
    rollback of speculative decoding (conv/state cannot be rewound by
    position arithmetic)."""
    moved = snaps.movedim(batch_axis, 0)                  # (B, N, ...)
    out = moved[torch.arange(moved.shape[0], device=snaps.device),
                idx.long()]                               # (B, ...)
    return out.movedim(0, batch_axis - 1)


def remat_call(fn, *args, remat: bool = False):
    """``fn(*args)``; with ``remat`` under activation checkpointing: its
    activations are recomputed in the backward pass instead of kept (the
    reference's ``jax.checkpoint`` of a layer)."""
    if not remat:
        return fn(*args)
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, *args, use_reentrant=False)


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


def sinusoidal_positions(seq: int, dim: int, device) -> torch.Tensor:
    """(seq, dim) f32 sinusoidal embedding, [sin | cos] halves, computed in
    float64 on the host as the reference does, then cast."""
    pos = np.arange(seq)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / (10000 ** (2 * i / dim))
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb.astype(np.float32)).to(device)


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


# --------------------------------------------------------------------------
# Vocab-parallel embedding and head (mesh serving)
# --------------------------------------------------------------------------

def _table_rows(table) -> int:
    return (table.data if isinstance(table, QTensor) else table).shape[0]


def embed_lookup_sharded(tables: list, ids: torch.Tensor, dtype, devices,
                         vocab: int) -> torch.Tensor:
    """Vocab-parallel lookup over a model-axis group: position m holds rows
    [m * n, (m + 1) * n) of the table; each looks up the ids it owns
    (zeros elsewhere) and the partials are summed on ``devices[0]``, which
    equals the whole table's lookup to the bit. A replicated table (V not
    divisible by the axis) is looked up once."""
    from repro_torch.sharding import collective as C
    n = _table_rows(tables[0])
    if n == vocab:
        return embed_lookup(tables[0], ids, dtype)
    parts = []
    for m, (table, own_ids) in enumerate(zip(tables,
                                             C.broadcast(ids, devices))):
        local = own_ids - m * n
        own = (local >= 0) & (local < n)
        rows = embed_lookup(table, torch.where(own, local,
                                               torch.zeros_like(local)),
                            dtype)
        parts.append(torch.where(own[..., None], rows,
                                 torch.zeros((), dtype=dtype,
                                             device=rows.device)))
    return C.reduce_sum(parts, devices[0])


def lm_head_sharded(xs: list, heads: list, devices, vocab: int,
                    plain: bool = False) -> torch.Tensor:
    """Vocab-parallel head: each position's logits over its vocab rows,
    gathered along V on ``devices[0]``; a replicated head runs once."""
    from repro_torch.sharding import collective as C
    if _table_rows(heads[0]) == vocab:
        return lm_head(xs[0], heads[0], plain)
    return C.gather([lm_head(x, w, plain) for x, w in zip(xs, heads)],
                    devices[0], dim=-1)
