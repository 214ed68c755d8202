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


# elements of one f32 working slice: quantize and dequantize walk a tensor
# in slices of whole last-axis rows, so a stacked expert weight of billions
# of elements never has a whole-tensor f32 copy. Groups run along the last
# axis, so a slice's payloads and scales are the whole tensor's, bit for bit.
SLICE_ELEMS = 1 << 26


def _row_slices(rows: int, k: int):
    step = max(1, SLICE_ELEMS // max(k, 1))
    return [(lo, min(lo + step, rows)) for lo in range(0, rows, step)]


def _grouped(w: torch.Tensor, group: int) -> torch.Tensor:
    *lead, k = w.shape
    assert k % group == 0, f"last dim {k} not divisible by group {group}"
    return w.reshape(*lead, k // group, group)


def _by_rows(w: torch.Tensor, group: int, fn, packed: bool
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``w`` slice by slice of its rows: ``fn`` maps an f32
    (rows, K // group, group) slice to (int8 levels, f32 (rows, K // group)
    scales). Returns the payload (packed to K // 2 bytes if ``packed``) and
    the bf16 scales, shaped as ``w``'s leading axes."""
    *lead, k = w.shape
    assert k % group == 0, f"last dim {k} not divisible by group {group}"
    rows = w.reshape(-1, k)
    n = rows.shape[0]
    q = torch.empty((n, k // 2 if packed else k), dtype=torch.int8,
                    device=w.device)
    scale = torch.empty((n, k // group), dtype=torch.bfloat16,
                        device=w.device)
    for lo, hi in _row_slices(n, k):
        levels, s = fn(_grouped(rows[lo:hi].float(), group))
        levels = levels.reshape(hi - lo, k)
        q[lo:hi] = pack_int4(levels) if packed else levels
        scale[lo:hi] = s.to(torch.bfloat16)
    return (q.reshape(*lead, q.shape[-1]),
            scale.reshape(*lead, k // group))


def _absmax(qmax: float):
    def fn(g: torch.Tensor):
        scale = g.abs().amax(dim=-1, keepdim=True) / qmax
        q = torch.round(g / torch.where(scale == 0, torch.ones_like(scale),
                                        scale))
        return q.clamp(-qmax, qmax).to(torch.int8), scale[..., 0]
    return fn


def quantize_int8(w: torch.Tensor, group: int = DEFAULT_GROUP) -> QTensor:
    q, scale = _by_rows(w, group, _absmax(127.0), packed=False)
    return QTensor(data=q, scale=scale, precision="int8",
                   shape=tuple(w.shape), group=group)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 levels in [-8, 7] -> (..., K // 2) packed bytes."""
    *lead, k = q.shape
    q2 = q.to(torch.int32).reshape(*lead, k // 2, 2)
    byte = (q2[..., 0] & 0x0F) | ((q2[..., 1] & 0x0F) << 4)
    return byte.to(torch.uint8).view(torch.int8)


def quantize_int4(w: torch.Tensor, group: int = DEFAULT_GROUP) -> QTensor:
    q, scale = _by_rows(w, group, _absmax(7.0), packed=True)
    return QTensor(data=q, scale=scale, precision="int4",
                   shape=tuple(w.shape), group=group)


def unpack_int4(data: torch.Tensor) -> torch.Tensor:
    """Unpack packed nibbles back to signed int8 in [-8, 7]: an arithmetic
    shift sign-extends each nibble (low = (b << 4) >> 4, high = b >> 4)."""
    lo = torch.bitwise_left_shift(data, 4) >> 4
    hi = data >> 4
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*data.shape[:-1], data.shape[-1] * 2)


def _ternary(g: torch.Tensor):
    absmean = g.abs().mean(dim=-1, keepdim=True)
    q = torch.where(g.abs() > 0.5 * absmean, torch.sign(g),
                    torch.zeros_like(g))
    num = (g * q).sum(dim=-1, keepdim=True)
    den = (q * q).sum(dim=-1, keepdim=True)
    scale = num / torch.where(den == 0, torch.ones_like(den), den)
    return q.to(torch.int8), scale[..., 0]


def quantize_ternary(w: torch.Tensor, group: int = DEFAULT_GROUP) -> QTensor:
    """1.58-bit ternary: W ~ scale * sign(W) * 1{|W| > tau}, tau = 0.5 *
    mean(|W|) per group; the scale minimizes ||W - s q||^2 per group."""
    q, scale = _by_rows(w, group, _ternary, packed=False)
    return QTensor(data=q, scale=scale, precision="ternary",
                   shape=tuple(w.shape), group=group)


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
    """Dequantize (levels times scales in f32, rounded once to ``dtype``),
    slice by slice of the rows. Shapes come from ``q.data``, so layer
    slices work. Each slice is one multiply of the int8 levels by the
    scales, written straight into the output (an int4 payload's low and
    high nibbles, sign-extended by arithmetic shifts, into its even and odd
    elements): the multiply runs in f32 and rounds once to the output
    dtype, and a level (at most 8 significant bits) times a bf16 scale is
    exact in f32, so a bf16 output takes the f32 path's bits with no f32
    copy."""
    if q.precision not in ("int8", "int4", "ternary"):
        raise ValueError(q.precision)
    *lead, kd = q.data.shape
    k = kd * 2 if q.precision == "int4" else kd
    grp = q.group
    data = q.data.reshape(-1, kd)
    rows = data.shape[0]
    scale = q.scale.reshape(rows, k // grp)
    work = dtype if dtype in (torch.bfloat16, torch.float32) else \
        torch.float32
    out = torch.empty((rows, k), dtype=work, device=q.data.device)
    for lo, hi in _row_slices(rows, k):
        s = scale[lo:hi].to(work)[..., None]
        dst = out[lo:hi].view(hi - lo, k // grp, grp)
        if q.precision == "int4":
            g = data[lo:hi].view(hi - lo, k // grp, grp // 2)
            dst = dst.view(hi - lo, k // grp, grp // 2, 2)
            torch.mul(torch.bitwise_left_shift(g, 4) >> 4, s,
                      out=dst[..., 0])
            torch.mul(g >> 4, s, out=dst[..., 1])
        else:
            torch.mul(data[lo:hi].view(hi - lo, k // grp, grp), s, out=dst)
    return out.reshape(*lead, k).to(dtype)
