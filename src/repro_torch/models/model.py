"""Model facade: one interface over the family modules.

Every family of the JAX package: dense and MoE (``transformer``), the
encoder-decoder family (``encdec``), the SSM family (``ssm_lm``) and the
hybrid family (``hybrid``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, ssm_lm, transformer
from repro_torch.quant import kvcache as KV

_FAMILIES = {"dense": transformer, "moe": transformer, "encdec": encdec,
             "ssm": ssm_lm, "hybrid": hybrid}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family not in _FAMILIES:
            raise ValueError(f"unknown family {self.cfg.family!r}")

    @property
    def module(self):
        return _FAMILIES[self.cfg.family]

    # ---- parameters -------------------------------------------------------
    def init(self, gen: torch.Generator, device) -> Any:
        return self.module.init(self.cfg, gen, device)

    # ---- forward ----------------------------------------------------------
    def apply(self, params, tokens: torch.Tensor, *, frames=None,
              last_only: bool = False, plain: bool = False,
              remat: bool = False, with_aux: bool = False):
        """tokens (B, S) (+ ``frames`` (B, S_enc, D) for enc-dec) ->
        logits (B, S, V_pad) f32; with ``with_aux`` -> (logits, aux), the
        aux dict holding an MoE model's ``moe_aux_loss`` summed over its
        layers (empty for the other families). ``remat`` recomputes each
        layer's activations in the backward pass
        (``torch.utils.checkpoint``). ``params`` may also be a
        ``TPGroup``, one data row of a mesh (dense family): its shards
        serving, or, in a mesh train step, training (``FSDPLeaf``s gathered
        layer by layer)."""
        kw = dict(last_only=last_only, plain=plain, remat=remat,
                  with_aux=with_aux)
        if self.cfg.family == "encdec":
            if frames is None:
                raise ValueError("an enc-dec model needs frames")
            return self.module.apply(params, tokens, frames, self.cfg, **kw)
        if frames is not None:
            raise ValueError("frames only apply to enc-dec models")
        return self.module.apply(params, tokens, self.cfg, **kw)

    # ---- decode -----------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, device):
        return self.module.init_cache(self.cfg, batch, max_seq, device)

    def decode_step(self, params, cache, tokens, *, plain: bool = False):
        return self.module.decode_step(params, cache, tokens, self.cfg,
                                       plain=plain)

    # ---- speculative decoding -----------------------------------------------
    @property
    def supports_fused_propose(self) -> bool:
        """True when the family has a read-only draft decode step (dense
        and MoE); the others propose in two passes on a cache clone."""
        return hasattr(self.module, "draft_propose_step")

    def draft_propose_step(self, params, cache, fresh_k, fresh_v, count,
                           tokens, *, plain: bool = False):
        """One read-only draft decode step: K/V go to row ``count`` of the
        (L_draft, B, K, Hkv, hd) side buffers, never to the cache. Returns
        (logits, fresh_k, fresh_v)."""
        return self.module.draft_propose_step(params, cache, fresh_k,
                                              fresh_v, count, tokens,
                                              self.cfg, plain=plain)

    def spec_verify(self, params, cache, tokens, *, plain: bool = False):
        """Score a (B, K+1) verify window: one multi-query decode step, or
        (SSM, hybrid) a scan of single-token steps that snapshots the
        recurrent state. Returns (logits (B, K+1, V_pad), snap) for
        ``spec_commit``."""
        return self.module.spec_verify(params, cache, tokens, self.cfg,
                                       plain=plain)

    def spec_commit(self, snap, committed):
        """Commit ``committed`` (B,) tokens of a verify window; 0 rolls a
        slot back to its pre-verify cache position (and, SSM and hybrid,
        copies each slot's selected conv/state snapshot into the cache in
        place)."""
        return self.module.spec_commit(snap, committed)

    # ---- slotted decode (continuous batching) -----------------------------
    @property
    def cache_batch_axes(self):
        return self.module.CACHE_BATCH_AXES

    @property
    def kv_cache_fields(self) -> tuple:
        return self.module.KV_CACHE_FIELDS

    @property
    def scans_prompts(self) -> bool:
        """True for the families whose recurrent state has no multi-token
        step (SSM, hybrid): a prompt is a scan of single-token decode
        steps."""
        return self.cfg.family in ("ssm", "hybrid")

    @property
    def seeds_prefix_hits(self) -> bool:
        """True for the families whose prefix hit skips its shared tokens
        (dense, MoE: the pool's rows seed the cache, the model runs the
        suffix); the others prefill in full with the hit's pages still
        mapped (a hybrid's conv/state need every token, an enc-dec prompt
        its frames)."""
        return self.cfg.family in ("dense", "moe")

    def slotted_cache(self, num_slots: int, max_seq: int, device):
        """init_cache with a (num_slots,) per-slot position vector."""
        cache = self.init_cache(num_slots, max_seq, device)
        return cache._replace(pos=torch.zeros((num_slots,), dtype=torch.int32,
                                              device=device))

    def insert_cache_slot(self, cache, one, slot: int, page_rows=None):
        """Write a batch=1 cache (scalar or (1,) pos) into slot ``slot`` of
        a slotted cache, in place, every field of the family's cache (an
        enc-dec cache's cross K/V too). Quantized fields quantize the
        prompt's K/V here, at admission (quantize-on-insert). Paged-pool fields also
        need ``page_rows=(row, wrow)``, the slot's page-table rows from the
        host allocator (``serving/pool.py``): ``row`` maps logical pages to
        physical ones, ``wrow`` redirects shared read-only prefix pages to
        the dump page so this insert cannot overwrite them."""
        for dst, src, axis in zip(cache, one, self.cache_batch_axes):
            if KV.is_kv_page(dst):
                first = dst[0] if isinstance(dst, tuple) else dst
                if isinstance(first, KV.PagedKV):
                    from repro_torch.quant import paged
                    assert page_rows is not None, \
                        "inserting into a paged cache needs page_rows"
                    paged.insert_slot_paged(dst, src, slot, *page_rows)
                else:
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
