"""Plan compiler: QuantPlan -> CompiledPlan.

Lowers an EWQ/FastEWQ ``QuantPlan`` (one precision decision per block, in
``Model.block_params`` order) onto a model family's parameter layout: the
layer stack becomes a ``SegmentedParams`` (maximal runs of equal precision)
and the embedding block is quantized whole at its own decision. Also lowers
a KV-cache precision policy onto the family's cache layout
(``compile_kv_plan``).

``compile_draft_plan`` derives the self-speculative all-int4 draft from a
compiled target by the plan's entropy order.

Every family's layout compiles: dense, MoE and SSM (one layer stack),
enc-dec (two stacks, ``enc_layers`` and ``dec_layers``, under one plan)
and hybrid (the Mamba2 stack, cut at shared-attention unit boundaries when
the plan is mixed so that every segment runs inside one unit, and the
shared block quantized whole at its own decision). Persisted plan
artifacts are still to be ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import QuantPlan
from repro_torch.quant.apply import (Segment, SegmentedParams, _quantizable,
                                     apply_plan_stacked, quantize_tree,
                                     tree_nbytes)
from repro_torch.quant.kvcache import DEFAULT_KV_GROUP, KVPlan
from repro_torch.quant.qtypes import QTensor
from repro_torch.quant.quantize import dequantize, quantize
from repro_torch.tree import tree_map

# Block decisions at (or below) these precisions already carry
# int4-or-lower payloads: a self-speculative draft shares them with the
# target instead of storing a copy.
DRAFT_SHARED = ("int4", "int3", "ternary")

# Entropy-weighted weight decision -> KV-cache precision: layers whose
# weights tolerate aggressive quantization (low entropy) also take the int4
# cache; sensitive (raw-weight) layers keep bf16 K/V.
KV_OF_WEIGHT = {"ternary": "int4", "int3": "int4", "int4": "int4",
                "int8": "int8", "raw": "bf16"}


@dataclasses.dataclass(frozen=True)
class StackSpec:
    """One layer stack: param key + the plan slice covering it."""
    key: str
    lo: int                         # first plan decision index (inclusive)
    hi: int                         # last plan decision index (exclusive)
    cut_period: Optional[int] = None  # forced segment cuts every N layers


@dataclasses.dataclass(frozen=True)
class ExtraSpec:
    """One non-stacked block quantized whole (embedding, hybrid shared)."""
    key: str
    index: int                      # plan decision index


def family_layout(cfg: ModelConfig) -> tuple[list[StackSpec], list[ExtraSpec]]:
    """Map a family's ``block_params`` order onto its param-dict layout:
    [embed] + stacked layers (+ family extras)."""
    n = cfg.num_layers
    if cfg.family in ("dense", "moe", "ssm"):
        return [StackSpec("layers", 1, 1 + n)], [ExtraSpec("embed", 0)]
    if cfg.family == "hybrid":
        return ([StackSpec("layers", 1, 1 + n,
                           cut_period=cfg.shared_attn_period)],
                [ExtraSpec("embed", 0), ExtraSpec("shared", 1 + n)])
    if cfg.family == "encdec":
        ne = cfg.num_encoder_layers
        return ([StackSpec("enc_layers", 1, 1 + ne),
                 StackSpec("dec_layers", 1 + ne, 1 + ne + n)],
                [ExtraSpec("embed", 0)])
    raise ValueError(f"unknown family {cfg.family!r}")


def plan_length(cfg: ModelConfig) -> int:
    """Number of block decisions a plan for ``cfg`` must carry."""
    stacks, extras = family_layout(cfg)
    return max([s.hi for s in stacks] + [e.index + 1 for e in extras])


def _subplan(plan: QuantPlan, lo: int, hi: int) -> QuantPlan:
    return dataclasses.replace(plan, decisions=plan.decisions[lo:hi])


def kv_cache_layers(cfg: ModelConfig) -> int:
    """Leading-axis length of the family's attention cache (0: no cache)."""
    if cfg.family in ("dense", "moe"):
        return cfg.num_layers
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_period
    if cfg.family == "encdec":
        return cfg.num_layers
    return 0


def compile_kv_plan(cfg: ModelConfig, plan: Optional[QuantPlan],
                    kv_precision: str = "auto",
                    group: int = DEFAULT_KV_GROUP) -> Optional[KVPlan]:
    """Lower a KV-cache precision policy onto a family's cache layout.

    "bf16" -> None (raw cache); "int8" / "int4" -> uniform; "auto" -> each
    cache layer inherits its block's weight decision via ``KV_OF_WEIGHT``
    (needs ``plan``)."""
    if kv_precision in (None, "bf16"):
        return None
    n = kv_cache_layers(cfg)
    if n == 0:
        return None
    if kv_precision in ("int8", "int4"):
        return KVPlan(precisions=(kv_precision,) * n, group=group)
    if kv_precision != "auto":
        raise ValueError(f"unknown kv_precision {kv_precision!r}; one of "
                         f"('bf16', 'int8', 'int4', 'auto')")
    if plan is None:
        raise ValueError("kv_precision='auto' derives per-layer cache "
                         "precision from the weight plan's entropy "
                         "decisions - pass a QuantPlan")
    if cfg.family == "hybrid":
        shared = plan.decisions[1 + cfg.num_layers].precision
        prec = (KV_OF_WEIGHT[shared],) * n
    elif cfg.family == "encdec":
        ne = cfg.num_encoder_layers
        prec = tuple(KV_OF_WEIGHT[d.precision]
                     for d in plan.decisions[1 + ne:1 + ne + cfg.num_layers])
    else:
        prec = tuple(KV_OF_WEIGHT[d.precision]
                     for d in plan.decisions[1:1 + cfg.num_layers])
    return KVPlan(precisions=prec, group=group)


@dataclasses.dataclass
class CompiledPlan:
    """A QuantPlan lowered onto one model's parameters. ``params`` slots in
    for the raw params everywhere (apply / decode_step / serving)."""
    family: str
    config_name: str
    group: int
    plan: QuantPlan
    params: Any
    kv_plan: Optional[KVPlan] = None

    def nbytes_effective(self) -> float:
        return sum(v.nbytes_effective() if isinstance(v, SegmentedParams)
                   else tree_nbytes(v) for v in self.params.values())


def compile_plan(model, params, plan: QuantPlan, group: int = 128,
                 kv_precision: str = "bf16",
                 kv_group: int = DEFAULT_KV_GROUP) -> CompiledPlan:
    """Lower ``plan`` onto ``params`` for any family: every layer stack
    becomes a ``SegmentedParams``, every extra block (embedding, hybrid
    shared block) is quantized whole."""
    cfg = model.cfg
    expected = plan_length(cfg)
    assert len(plan.decisions) == expected, \
        (f"plan has {len(plan.decisions)} decisions; family {cfg.family!r} "
         f"needs {expected}")
    stacks, extras = family_layout(cfg)
    new = dict(params)
    for spec in stacks:
        sub = _subplan(plan, spec.lo, spec.hi)
        cuts: Sequence[int] = ()
        if spec.cut_period and len(set(sub.precisions())) > 1:
            cuts = range(spec.cut_period, spec.hi - spec.lo, spec.cut_period)
        new[spec.key] = apply_plan_stacked(params[spec.key], sub, group,
                                           cuts=cuts)
    for spec in extras:
        new[spec.key] = quantize_tree(
            params[spec.key], plan.decisions[spec.index].precision, group)
    return CompiledPlan(family=cfg.family, config_name=cfg.name, group=group,
                        plan=plan, params=new,
                        kv_plan=compile_kv_plan(cfg, plan, kv_precision,
                                                kv_group))


# ---------------------------------------------------------------------------
# self-speculative draft plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DraftPlan:
    """An entropy-ordered all-int4 draft derived from a compiled target.

    ``params`` runs through the same model code as the target: blocks the
    entropy plan already pushed to int4 (or lower) REFERENCE the target's
    tensors (the same Segment objects; zero extra device memory), while
    raw/int8 blocks carry a draft-only int4 requantization.
    ``overhead_bytes`` counts exactly those draft-only payloads."""
    params: Any
    precisions: tuple[str, ...]     # per-block draft decision (plan order;
                                    # "skip" = truncated away)
    shared_blocks: int              # decisions sharing target payloads
    requantized_blocks: int         # decisions with a draft-only int4 copy
    overhead_bytes: float
    group: int
    draft_layers: Optional[int] = None  # truncated layer count (None: full)

    def to_manifest(self) -> dict:
        return {"precisions": list(self.precisions),
                "shared_blocks": self.shared_blocks,
                "requantized_blocks": self.requantized_blocks,
                "overhead_bytes": float(self.overhead_bytes),
                "group": self.group,
                "draft_layers": self.draft_layers}


def _draft_tree(tree: Any, group: int, min_ndim: int) -> tuple[Any, float]:
    """Requantize one block's tree to int4, dequantizing int8 QTensors
    first; already-aggressive QTensors and ineligible leaves are shared.
    Returns (draft_tree, draft_only_bytes)."""
    overhead = 0.0

    def leaf(x):
        nonlocal overhead
        if isinstance(x, QTensor):
            if x.precision in DRAFT_SHARED:
                return x                       # shared payload, zero bytes
            q = quantize(dequantize(x, torch.float32), "int4", x.group)
        elif _quantizable(x, group, min_ndim):
            q = quantize(x, "int4", group)
        else:
            return x                           # norms/biases: shared raw
        overhead += q.nbytes_effective()
        return q

    out = tree_map(leaf, tree)
    return out, overhead


def _slice_stack_layers(tree: Any, take: int) -> Any:
    """Layers [0, take) of a stacked tree, as a copy (draft-only bytes, as
    in the reference, where slicing materializes), with each QTensor's
    logical shape rebuilt."""
    def leaf(x):
        if isinstance(x, QTensor):
            return QTensor(data=x.data[:take].clone(),
                           scale=x.scale[:take].clone(),
                           precision=x.precision,
                           shape=(take,) + tuple(x.shape[1:]), group=x.group)
        return x[:take].clone()

    return tree_map(leaf, tree)


def compile_draft_plan(model, params, plan: Optional[QuantPlan],
                       group: int = 128,
                       draft_layers: Optional[int] = None) -> DraftPlan:
    """Derive the self-speculative all-int4 draft from a served model.

    ``params`` is the tree the engine serves (compiled segmented stacks and
    quantized extras, or raw when ``plan`` is None). Every block decision
    maps to ``min(decision, int4)``: blocks the entropy analysis already
    marked aggressive keep their payloads (shared, no copy), higher-entropy
    raw/int8 blocks get a draft-only int4 requantization. With no plan the
    draft is a uniform int4 copy of every eligible block. Segment
    boundaries are kept 1:1 with the target, so the draft runs through the
    same segmented paths and shares the target's KV-cache layout.

    ``draft_layers=N`` truncates the draft to the first N layers of the
    stack (early-exit drafting; verification keeps greedy output exact). A
    segment the cut lands inside is sliced into a copy, so sliced segments
    count toward ``overhead_bytes`` even at a shared precision.
    Truncated-away blocks are stamped ``"skip"`` in ``precisions``."""
    cfg = model.cfg
    if draft_layers is not None:
        if cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"draft_layers needs the fused propose path (dense/moe "
                f"families); family is {cfg.family!r}")
        if not 1 <= draft_layers <= cfg.num_layers:
            raise ValueError(
                f"draft_layers must be in [1, {cfg.num_layers}], got "
                f"{draft_layers}")
    new = dict(params)
    stacks, extras = family_layout(cfg)
    overhead = 0.0
    shared = requant = 0
    precisions = ["int4"] * plan_length(cfg)

    def mark_skipped():
        if draft_layers is None:
            return
        for spec in stacks:                    # dense/moe: one "layers" stack
            for i in range(draft_layers, spec.hi - spec.lo):
                precisions[spec.lo + i] = "skip"

    if plan is None:
        for key, val in params.items():
            n = draft_layers if key == "layers" else None
            is_stack = any(s.key == key for s in stacks)
            if isinstance(val, SegmentedParams):
                segs = []
                for seg in val.segments:
                    if n is not None and seg.start >= n:
                        break
                    stop = min(seg.stop, n) if n is not None else seg.stop
                    src = (_slice_stack_layers(seg.params, stop - seg.start)
                           if stop < seg.stop else seg.params)
                    t, ob = _draft_tree(src, group, min_ndim=3)
                    segs.append(Segment(precision="int4", start=seg.start,
                                        stop=stop, params=t))
                    overhead += ob
                new[key] = SegmentedParams(
                    segments=segs,
                    num_layers=n if n is not None else val.num_layers)
            elif key in ("embed", "shared") or is_stack:
                if n is not None:
                    val = _slice_stack_layers(val, n)
                new[key], ob = _draft_tree(val, group,
                                           min_ndim=3 if is_stack else 2)
                overhead += ob
        mark_skipped()
        requant = sum(1 for p in precisions if p != "skip")
        return DraftPlan(params=new, precisions=tuple(precisions),
                         shared_blocks=0, requantized_blocks=requant,
                         overhead_bytes=overhead, group=group,
                         draft_layers=draft_layers)

    assert len(plan.decisions) == len(precisions), \
        (f"plan has {len(plan.decisions)} decisions; family {cfg.family!r} "
         f"needs {len(precisions)}")
    for spec in stacks:
        layers = params[spec.key]
        if not isinstance(layers, SegmentedParams):
            raise ValueError(
                f"draft derivation expects compiled (segmented) stacks; "
                f"{spec.key!r} is {type(layers).__name__}: compile the plan "
                f"first (quant/compiler.compile_plan)")
        n = draft_layers if spec.key == "layers" else None
        segs = []
        for seg in layers.segments:
            if n is not None and seg.start >= n:
                break
            sliced = n is not None and seg.stop > n
            stop = n if sliced else seg.stop
            if seg.precision in DRAFT_SHARED:
                if sliced:
                    # the slice is a draft-only copy of an already
                    # aggressive payload: same precision, real bytes
                    t = _slice_stack_layers(seg.params, stop - seg.start)
                    seg = Segment(precision=seg.precision, start=seg.start,
                                  stop=stop, params=t)
                    overhead += tree_nbytes(t)
                segs.append(seg)               # else shared verbatim
                shared += stop - seg.start
                for i in range(seg.start, stop):
                    precisions[spec.lo + i] = seg.precision
            else:
                src = (_slice_stack_layers(seg.params, stop - seg.start)
                       if sliced else seg.params)
                t, ob = _draft_tree(src, group, min_ndim=3)
                segs.append(Segment(precision="int4", start=seg.start,
                                    stop=stop, params=t))
                overhead += ob
                requant += stop - seg.start
        new[spec.key] = SegmentedParams(
            segments=segs,
            num_layers=n if n is not None else layers.num_layers)
    mark_skipped()
    for spec in extras:
        prec = plan.decisions[spec.index].precision
        if prec in DRAFT_SHARED:
            shared += 1
            precisions[spec.index] = prec
        else:
            new[spec.key], ob = _draft_tree(params[spec.key], group,
                                            min_ndim=2)
            overhead += ob
            requant += 1
    return DraftPlan(params=new, precisions=tuple(precisions),
                     shared_blocks=shared, requantized_blocks=requant,
                     overhead_bytes=overhead, group=group,
                     draft_layers=draft_layers)
