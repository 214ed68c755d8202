"""EWQ-quantized serving: the variant vocabulary and plan builders.

Weights are quantized per the EWQ/FastEWQ plan (block-granular mixed
precision): high-entropy blocks stay raw, and decode, which is bound by the
weight bytes it reads, reads int8/int4 payloads instead of bf16.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import BlockDecision, QuantPlan
from repro_torch.quant.compiler import compile_plan


def fastewq_metadata_plan(cfg: ModelConfig, variant: str = "8bit-mixed",
                          quant_fraction: float = 0.41) -> QuantPlan:
    """O(1) plan from architecture metadata only (no weights): the trailing
    ``quant_fraction`` of transformer blocks are selected, int8 by default;
    the final block drops to int4 under the "4bit/8bit" variant (paper 6.3).
    The closed form equals the FastEWQ classifier's majority behavior on the
    paper's dataset (the trained classifiers are still to be ported)."""
    blocks = []
    n_layers = cfg.num_layers + (cfg.num_encoder_layers or 0)
    extra = 1 if cfg.family == "hybrid" else 0
    total = 1 + n_layers + extra
    n_quant = max(1, int(round(n_layers * quant_fraction)))
    first_quant = 1 + (n_layers - n_quant)
    for i in range(total):
        if i == 0:
            prec = "raw"
        elif first_quant <= i <= n_layers:
            last = i == n_layers
            prec = ("int4" if (variant.startswith("4bit") and last)
                    else "int8")
        elif i > n_layers:
            prec = "int8"
        else:
            prec = "raw"
        blocks.append(BlockDecision(block_index=i, exec_index=i + 1,
                                    entropy=float("nan"), num_parameters=0,
                                    precision=prec))
    return QuantPlan(decisions=blocks, mu=float("nan"), sigma=float("nan"),
                     threshold=float("nan"), x_factor=1.0)


def plan_for_variant(model, params, variant: str,
                     fast: bool = False) -> Optional[QuantPlan]:
    """Variant string -> QuantPlan (None for "raw"). ``fast`` takes the
    metadata-only FastEWQ path; otherwise the weights are entropy-analyzed
    (full EWQ) on the device they live on."""
    if variant == "raw":
        return None
    if fast:
        return fastewq_metadata_plan(model.cfg, variant)
    from repro_torch.core.planner import plan_model
    return plan_model(model, params, variant=variant)


def apply_plan_to_params(model, params, plan: QuantPlan, group: int = 128):
    """Quantize a model's params per an EWQ plan (block order matches
    ``Model.block_params``: [embed] + layers)."""
    return compile_plan(model, params, plan, group).params


def explicit_plan(cfg: ModelConfig, layer_precisions: list[str],
                  variant: str = "8bit-mixed",
                  shared_precision: str = "raw",
                  embed_precision: str = "raw") -> QuantPlan:
    """Plan with explicit per-layer precisions; the embedding block takes
    ``embed_precision`` (raw by default)."""
    n_layers = cfg.num_layers + (cfg.num_encoder_layers or 0)
    assert len(layer_precisions) == n_layers
    ds = [BlockDecision(block_index=0, exec_index=1, entropy=float("nan"),
                        num_parameters=0, precision=embed_precision)]
    for i, p in enumerate(layer_precisions):
        ds.append(BlockDecision(block_index=i + 1, exec_index=i + 2,
                                entropy=float("nan"), num_parameters=0,
                                precision=p))
    if cfg.family == "hybrid":
        ds.append(BlockDecision(block_index=len(ds), exec_index=len(ds) + 1,
                                entropy=float("nan"), num_parameters=0,
                                precision=shared_precision))
    return QuantPlan(decisions=ds, mu=float("nan"), sigma=float("nan"),
                     threshold=float("nan"), x_factor=1.0)
