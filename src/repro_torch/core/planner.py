"""EWQ planner: model params -> block entropies -> QuantPlan (paper §3).

Works on the framework's standard param layout (see models/model.py):
blocks are exposed by ``Model.block_params(params)`` as an ordered list of
{name: array} dicts — [embedding_block?, layer_0, ..., layer_{L-1}] — with
exec_index starting at 1 for the embedding block (paper Table 8 convention).
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

from repro_torch.core import entropy as E
from repro_torch.core import policy as P


def analyze(blocks: Sequence[Mapping[str, Any]], *, mode: str = "paper",
            eps: float = E.DEFAULT_EPS,
            first_exec_index: int = 1) -> list[E.BlockEntropy]:
    return E.analyze_blocks(blocks, mode=mode, eps=eps,
                            first_exec_index=first_exec_index)


def plan(blocks: Sequence[Mapping[str, Any]], *, variant: str = "4bit/8bit",
         x_factor: float = 1.0, mode: str = "paper",
         eps: float = E.DEFAULT_EPS) -> P.QuantPlan:
    """Produce a QuantPlan with one of the paper's §6.2 variants.

    variant:
      "raw"         — no quantization
      "4bit"        — uniform int4 (global quantization baseline)
      "8bit"        — uniform int8 (global quantization baseline)
      "8bit-mixed"  — H <= mu -> int8 else raw
      "4bit/8bit"   — H <= T -> int4; T < H <= mu -> int8; else raw
      "ternary/4bit"— edge variant: H <= T -> ternary; T < H <= mu -> int4
    """
    ents = analyze(blocks, mode=mode, eps=eps)
    if variant == "raw":
        return P.decide_uniform(ents, "raw")
    if variant == "4bit":
        return P.decide_uniform(ents, "int4")
    if variant == "8bit":
        return P.decide_uniform(ents, "int8")
    if variant == "8bit-mixed":
        return P.decide_8bit_mixed(ents)
    if variant == "4bit/8bit":
        return P.decide(ents, x_factor=x_factor, aggressive="int4")
    if variant == "ternary/4bit":
        pl = P.decide(ents, x_factor=x_factor, aggressive="ternary")
        # 8-bit tier becomes 4-bit in the edge configuration (paper §3.4).
        return pl.with_precisions(
            ["int4" if p == "int8" else p for p in pl.precisions()])
    raise ValueError(f"unknown variant {variant!r}")


def plan_model(model, params, *, variant: str = "4bit/8bit",
               x_factor: float = 1.0, mode: str = "paper",
               eps: float = E.DEFAULT_EPS) -> P.QuantPlan:
    """Convenience: EWQ plan for a Model instance (see models/model.py)."""
    return plan(model.block_params(params), variant=variant,
                x_factor=x_factor, mode=mode, eps=eps)


def plan_kv(cfg, plan: "P.QuantPlan | None" = None, *,
            kv_precision: str = "auto", group: int | None = None):
    """KV-cache precision plan for a model config.

    Extends the block-entropy decision from weights to the serving KV
    cache: with ``kv_precision="auto"`` each attention layer's cache
    precision is derived from that layer's existing entropy decision in
    ``plan`` (low entropy -> int4 cache, mid -> int8, high/raw -> bf16);
    "int8"/"int4" force a uniform cache; "bf16" returns None. The result
    feeds ``ServeEngine(kv_precision=...)`` and is stamped into compiled
    artifacts by quant/compiler.py."""
    from repro_torch.quant.compiler import compile_kv_plan
    from repro_torch.quant.kvcache import DEFAULT_KV_GROUP
    return compile_kv_plan(cfg, plan, kv_precision,
                           group or DEFAULT_KV_GROUP)
