"""Plan compiler: QuantPlan -> CompiledPlan.

Lowers an EWQ/FastEWQ ``QuantPlan`` (one precision decision per block, in
``Model.block_params`` order) onto a model family's parameter layout: the
layer stack becomes a ``SegmentedParams`` (maximal runs of equal precision)
and the embedding block is quantized whole at its own decision. Also lowers
a KV-cache precision policy onto the family's cache layout
(``compile_kv_plan``).

This slice compiles the dense and MoE layouts. The hybrid and enc-dec rows
of ``family_layout`` are kept as plain data so plans for those families
have the right length; compiling them waits for their models (ROADMAP.md).
Persisted plan artifacts and self-speculative draft plans are still to be
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import QuantPlan
from repro_torch.quant.apply import (SegmentedParams, apply_plan_stacked,
                                     quantize_tree, tree_nbytes)
from repro_torch.quant.kvcache import DEFAULT_KV_GROUP, KVPlan

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
    """Lower ``plan`` onto ``params`` (dense and MoE families)."""
    cfg = model.cfg
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"compile_plan for the {cfg.family!r} family waits for its model "
            f"port (ROADMAP.md, 'the other families')")
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
