"""Entropy-weighted quantized KV cache.

Each attention layer's K/V buffers are stored int8 or packed int4 with
per-group scales (or bf16), the per-layer precision chosen by a ``KVPlan``
(uniform, or derived from the layer's weight decision by
``quant.compiler.compile_kv_plan``).

Layout of a ``KVPage`` (one contiguous run of cache layers at ONE precision):

  data  : (L?, B, S, Hkv, hd)      int8   ("int8")
          (L?, B, S, F // 2)       int8   ("int4", two nibbles per byte,
                                           stored FLAT over F = Hkv * hd)
          (L?, B, S, Hkv, hd)      bf16   ("bf16", scale is None)
  scale : (L?, B, S, F // group)   bf16   groups along the FLATTENED heads

int4 pages pack split-half over the flat F axis: byte j holds flat element j
(low nibble) and element j + F/2 (high nibble).

Writes happen in place: ``update_page`` (per-token decode write) and
``insert_slot`` (admitting a prefilled request) quantize at the write and
store into the page's tensors, so the decode loop never holds a bf16 copy of
a quantized cache. ``KVPage.layer(i)`` is a view, so a per-layer write lands
in the stacked page.

Mixed per-layer plans cut the cache into a tuple of pages whose boundaries
are the parameter-stack segment boundaries (``cuts``), so page i lines up
with segment i of ``quant.apply.segment_slices``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

DEFAULT_KV_GROUP = 64
KV_PRECISIONS = ("bf16", "int8", "int4")


@dataclasses.dataclass(frozen=True)
class KVPlan:
    """Per-cache-layer precision plan. ``group`` is the scale-group size
    along the flattened (Hkv * hd) axis."""
    precisions: tuple[str, ...]
    group: int = DEFAULT_KV_GROUP

    def __post_init__(self):
        for p in self.precisions:
            if p not in KV_PRECISIONS:
                raise ValueError(f"unknown KV precision {p!r}; "
                                 f"one of {KV_PRECISIONS}")

    def pages(self, cuts: Sequence[int] = ()) -> list[tuple[str, int, int]]:
        """Maximal equal-precision runs, additionally cut at ``cuts``."""
        cutset = set(cuts)
        runs: list[tuple[str, int, int]] = []
        start = 0
        n = len(self.precisions)
        for i in range(1, n + 1):
            if (i == n or self.precisions[i] != self.precisions[start]
                    or i in cutset):
                runs.append((self.precisions[start], start, i))
                start = i
        return runs

    def to_dict(self) -> dict:
        return {"precisions": list(self.precisions), "group": self.group}


@dataclasses.dataclass
class KVPage:
    """One contiguous run of cache layers at a single precision."""
    data: torch.Tensor
    scale: Optional[torch.Tensor]   # None for "bf16"
    precision: str
    head_dim: int                   # logical hd (int4 stores F // 2 bytes)
    group: int                      # divides Hkv * hd

    @property
    def num_kv_heads(self) -> int:
        if self.precision == "int4":
            return 2 * self.data.shape[-1] // self.head_dim
        return self.data.shape[-2]

    @property
    def seq_len(self) -> int:
        return self.data.shape[-2 if self.precision == "int4" else -3]

    def layer(self, i: int) -> "KVPage":
        """View of layer ``i`` of a layer-stacked page (writes land in the
        stack)."""
        return dataclasses.replace(
            self, data=self.data[i],
            scale=None if self.scale is None else self.scale[i])


def is_kv_page(x: Any) -> bool:
    """True for a KVPage or a non-empty tuple of them."""
    if isinstance(x, KVPage):
        return True
    return (isinstance(x, tuple) and len(x) > 0
            and all(isinstance(p, KVPage) for p in x))


# ---------------------------------------------------------------------------
# quantize / dequantize (flat-head grouping)
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor, precision: str, group: int
                ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (..., Hkv, hd) float -> (data, scale) in the page layout."""
    *lead, hkv, hd = x.shape
    if precision == "bf16":
        return x.to(torch.bfloat16), None
    f = hkv * hd
    assert f % group == 0, f"Hkv*hd={f} not divisible by kv group {group}"
    g = x.float().reshape(*lead, f // group, group)
    qmax = 127.0 if precision == "int8" else 7.0
    scale = g.abs().amax(dim=-1, keepdim=True) / qmax
    q = torch.round(g / torch.where(scale == 0, torch.ones_like(scale), scale))
    q = q.clamp(-qmax, qmax).to(torch.int8)
    scale = scale[..., 0].to(torch.bfloat16)
    if precision == "int8":
        return q.reshape(*lead, hkv, hd), scale
    if precision == "int4":
        assert hd % 2 == 0, f"int4 KV packing needs an even head dim, {hd}"
        flat = q.reshape(*lead, f).to(torch.int32)
        half = f // 2
        packed = (flat[..., :half] & 0x0F) | ((flat[..., half:] & 0x0F) << 4)
        return packed.to(torch.uint8).view(torch.int8), scale
    raise ValueError(f"cannot quantize KV to {precision!r}")


def unpack_kv_int4(data: torch.Tensor) -> torch.Tensor:
    """(..., P) packed -> (..., 2P): low nibbles are flat elements [0, P),
    high nibbles [P, 2P)."""
    d = data.to(torch.int16)
    lo = ((d & 0x0F) ^ 8) - 8
    hi = d >> 4
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def dequantize_kv(page: KVPage, dtype=torch.float32) -> torch.Tensor:
    """Page -> (..., Hkv, hd) in ``dtype`` (bf16 pages: a plain cast)."""
    if page.precision == "bf16":
        return page.data.to(dtype)
    data = page.data
    if page.precision == "int4":
        data = unpack_kv_int4(data)
        *lead, f = data.shape
    else:
        *lead, hkv, hd = data.shape
        f = hkv * hd
    g = data.float().reshape(*lead, f // page.group, page.group)
    out = g * page.scale.float()[..., None]
    return out.reshape(*lead, f // page.head_dim, page.head_dim).to(dtype)


def make_page(raw: torch.Tensor, precision: str, group: int) -> KVPage:
    """Quantize a raw (..., S, Hkv, hd) cache buffer into one page."""
    data, scale = quantize_kv(raw, precision, group)
    return KVPage(data=data, scale=scale, precision=precision,
                  head_dim=raw.shape[-1], group=group)


# ---------------------------------------------------------------------------
# page writes (quantize-on-insert, in place)
# ---------------------------------------------------------------------------

def write_rows(dst: torch.Tensor, src: torch.Tensor,
               pos: torch.Tensor) -> None:
    """In place: dst (B, S, ...)[b, pos[b] + j] = src (B, s, ...)[b, j].
    ``pos`` is a scalar or (B,) tensor; the start is clamped to [0, S - s]
    the way a JAX dynamic_update_slice clamps it (idle serving slots keep
    advancing their position past the cache end)."""
    b, s = src.shape[:2]
    start = torch.as_tensor(pos, device=dst.device).to(torch.long)
    start = start.expand(b).clamp(0, dst.shape[1] - s)
    rows = start[:, None] + torch.arange(s, device=dst.device)[None, :]
    dst[torch.arange(b, device=dst.device)[:, None], rows] = src.to(dst.dtype)


def update_page(page: KVPage, new: torch.Tensor, pos) -> KVPage:
    """Decode-step write: quantize ``new`` (B, s, Hkv, hd) and store it in
    place at sequence position ``pos`` (scalar or (B,) per-slot)."""
    data_n, scale_n = quantize_kv(new, page.precision, page.group)
    write_rows(page.data, data_n, pos)
    if scale_n is not None:
        write_rows(page.scale, scale_n, pos)
    return page


def insert_slot(field, src: torch.Tensor, slot: int):
    """Admit a prefilled request: quantize the raw batch=1 cache ``src``
    ((L, 1, S, Hkv, hd)) into slot ``slot`` of a slotted page field (batch
    axis 1), in place. ``field`` is a KVPage or a tuple of them."""
    pages = field if isinstance(field, tuple) else (field,)
    lo = 0
    for page in pages:
        hi = lo + page.data.shape[0]
        data_n, scale_n = quantize_kv(src[lo:hi], page.precision, page.group)
        page.data[:, slot] = data_n[:, 0].to(page.data.dtype)
        if scale_n is not None:
            page.scale[:, slot] = scale_n[:, 0]
        lo = hi
    return field


# ---------------------------------------------------------------------------
# model-cache conversion and per-segment access
# ---------------------------------------------------------------------------

def quantize_cache_field(raw: torch.Tensor, plan: KVPlan,
                         cuts: Sequence[int] = ()):
    """Raw stacked (L, B, S, Hkv, hd) buffer -> a KVPage, or a tuple of
    pages cut at ``cuts`` for a mixed plan."""
    runs = plan.pages(cuts)
    assert runs and runs[-1][2] == raw.shape[0], \
        (f"KV plan covers {runs[-1][2] if runs else 0} layers; cache has "
         f"{raw.shape[0]}")
    pages = tuple(make_page(raw[lo:hi], prec, plan.group)
                  for prec, lo, hi in runs)
    return pages if len(pages) > 1 else pages[0]


def quantize_model_cache(cache, plan: KVPlan, cuts: Sequence[int],
                         fields: Sequence[str]):
    """Replace each named KV field of a family cache with quantized pages."""
    reps = {}
    for name in fields:
        raw = getattr(cache, name)
        reps[name] = raw if is_kv_page(raw) else \
            quantize_cache_field(raw, plan, cuts)
    return cache._replace(**reps) if reps else cache


def kv_segment(field, si: int, lo: int, hi: int):
    """The cache field of parameter segment ``si`` covering layers
    [lo, hi): its page, or a view of the raw stack."""
    if isinstance(field, tuple):
        page = field[si]
        assert page.data.shape[0] == hi - lo, \
            (f"KV page {si} holds {page.data.shape[0]} layers; segment "
             f"[{lo},{hi}) expects {hi - lo}")
        return page
    if isinstance(field, KVPage):
        assert si == 0, "single-page cache with a multi-segment stack"
        return field
    return field[lo:hi]


def kv_layer(seg_field, i: int):
    """Layer ``i`` of a segment's cache field (a view)."""
    if isinstance(seg_field, KVPage):
        return seg_field.layer(i)
    return seg_field[i]


def kv_field_nbytes(field) -> float:
    """Physical bytes of a cache field (pages count data + scales)."""
    pages = field if isinstance(field, tuple) else (field,)
    total = 0.0
    for p in pages:
        for t in ((p.data, p.scale) if isinstance(p, KVPage) else (p,)):
            if t is not None:
                total += float(t.numel() * t.element_size())
    return total
