"""Model facade: one interface over the family modules.

This slice ports the dense family. Building a model of another family
raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.quant import kvcache as KV

_FAMILIES = {"dense": transformer}
_TODO = {"moe": "the other families (MoE branch of the transformer)",
         "ssm": "the other families (ssm.py, ssm_lm.py)",
         "hybrid": "the other families (hybrid.py)",
         "encdec": "the other families (encdec.py)"}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family not in _FAMILIES:
            raise NotImplementedError(
                f"family {self.cfg.family!r} is still to be ported "
                f"(ROADMAP.md: {_TODO.get(self.cfg.family, '?')})")

    @property
    def module(self):
        return _FAMILIES[self.cfg.family]

    # ---- parameters -------------------------------------------------------
    def init(self, gen: torch.Generator, device) -> Any:
        return self.module.init(self.cfg, gen, device)

    # ---- forward ----------------------------------------------------------
    def apply(self, params, tokens: torch.Tensor, *, last_only: bool = False,
              plain: bool = False) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V_pad) f32."""
        return self.module.apply(params, tokens, self.cfg,
                                 last_only=last_only, plain=plain)

    # ---- decode -----------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, device):
        return self.module.init_cache(self.cfg, batch, max_seq, device)

    def decode_step(self, params, cache, tokens, *, plain: bool = False):
        return self.module.decode_step(params, cache, tokens, self.cfg,
                                       plain=plain)

    # ---- slotted decode (continuous batching) -----------------------------
    @property
    def cache_batch_axes(self):
        return self.module.CACHE_BATCH_AXES

    @property
    def kv_cache_fields(self) -> tuple:
        return self.module.KV_CACHE_FIELDS

    def slotted_cache(self, num_slots: int, max_seq: int, device):
        """init_cache with a (num_slots,) per-slot position vector."""
        cache = self.init_cache(num_slots, max_seq, device)
        return cache._replace(pos=torch.zeros((num_slots,), dtype=torch.int32,
                                              device=device))

    def insert_cache_slot(self, cache, one, slot: int):
        """Write a batch=1 cache (scalar or (1,) pos) into slot ``slot`` of
        a slotted cache, in place. Quantized fields quantize the prompt's
        K/V here, at admission (quantize-on-insert)."""
        for dst, src, axis in zip(cache, one, self.cache_batch_axes):
            if KV.is_kv_page(dst):
                KV.insert_slot(dst, src, slot)
                continue
            src = src.reshape(1) if src.ndim < dst.ndim else src
            index = [slice(None)] * dst.ndim
            index[axis] = slot
            dst[tuple(index)] = src.select(axis, 0).to(dst.dtype)
        return cache

    # ---- EWQ --------------------------------------------------------------
    def block_params(self, params) -> list:
        return self.module.block_params(params)

    def compile_plan(self, params, plan, group: int = 128, **kw):
        from repro_torch.quant.compiler import compile_plan
        return compile_plan(self, params, plan, group, **kw)


def build(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)
