"""Plan compiler: QuantPlan -> CompiledPlan.

Lowers an EWQ/FastEWQ ``QuantPlan`` (one precision decision per block, in
``Model.block_params`` order) onto a model family's parameter layout: the
layer stack becomes a ``SegmentedParams`` (maximal runs of equal precision)
and the embedding block is quantized whole at its own decision. Also lowers
a KV-cache precision policy onto the family's cache layout
(``compile_kv_plan``), and orders the KV degradation tiers a paged engine
spills through under pool pressure (``degrade_kv_ladder``).

``compile_draft_plan`` derives the self-speculative all-int4 draft from a
compiled target by the plan's entropy order.

Every family's layout compiles: dense, MoE and SSM (one layer stack),
enc-dec (two stacks, ``enc_layers`` and ``dec_layers``, under one plan)
and hybrid (the Mamba2 stack, cut at shared-attention unit boundaries when
the plan is mixed so that every segment runs inside one unit, and the
shared block quantized whole at its own decision).

``save_artifact`` / ``load_artifact`` persist the quantized parameters and
their manifest as a bootable checkpoint in the JAX package's format
(``checkpoint/ckpt.py``), so a server cold start skips raw-weight loading
and entropy analysis (``ServeEngine.from_artifact``, ``launch/serve.py
--plan-artifact``). The skeleton a load restores into is compiled on the
meta device: no raw weight is ever materialized.
"""

from __future__ import annotations

import dataclasses
import json
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

ARTIFACT_VERSION = 1

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


_KV_DOWN = {"bf16": "int8", "int8": "int4", "int4": "int4"}


def degrade_kv_ladder(cfg: ModelConfig, plan: Optional[QuantPlan],
                      base: Optional[KVPlan],
                      group: int = DEFAULT_KV_GROUP, *,
                      fastewq=None, block_sizes=None,
                      cuts: Sequence[int] = ()) -> list:
    """Entropy-ordered KV degradation tiers.

    Tier 0 is the serving policy (``base``; None = bf16). Deeper tiers
    spill cache precision down bf16 -> int8 -> int4 in the order the
    layer-level entropy signal gives: layers whose weight blocks the plan
    marked quantizable spill first, entropy-sensitive layers one tier
    later, and the last tier is all int4. A lower precision at a constant
    byte budget buys proportionally more pool pages
    (``ServeEngine.apply_kv_plan``).

    Decode reads the cache one pool run per parameter segment, so a tier's
    precision is uniform within each segment of ``cuts`` (no cuts: one
    segment over the stack); a segment spills when at least half of its
    layers' decisions say so. Without a plan, a FastEWQ classifier
    (``fastewq``) orders the layers from their sizes alone
    (``block_sizes``, O(1) a block; ``FastEWQ.kv_spill_order``) and the
    first half of that order spills first; the order's indices are read
    as KV-layer indices, so ``block_sizes`` gives one size per KV layer.
    With neither, the deeper half of the layers spills first."""
    n = kv_cache_layers(cfg)
    if n == 0:
        return []
    base_prec = list(base.precisions) if base is not None else ["bf16"] * n
    if base is not None:
        group = base.group
    if plan is not None:
        if cfg.family == "hybrid":
            spill = [plan.decisions[1 + cfg.num_layers].quantized] * n
        elif cfg.family == "encdec":
            ne = cfg.num_encoder_layers
            spill = [d.quantized
                     for d in plan.decisions[1 + ne:1 + ne + cfg.num_layers]]
        else:
            spill = [d.quantized for d in plan.decisions[1:1 + cfg.num_layers]]
    elif fastewq is not None and block_sizes is not None:
        order = fastewq.kv_spill_order(block_sizes)
        first = set(order[:max(1, len(order) // 2)])
        spill = [i in first for i in range(n)]
    else:
        spill = [i >= n // 2 for i in range(n)]
    bounds = [0] + [c for c in sorted(set(cuts)) if 0 < c < n] + [n]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        seg = sum(spill[lo:hi]) * 2 >= (hi - lo)
        spill[lo:hi] = [seg] * (hi - lo)
    if not any(spill):
        spill = [True] * n
    t1 = [_KV_DOWN[p] if s else p for p, s in zip(base_prec, spill)]
    t2 = [_KV_DOWN[_KV_DOWN[p]] if s else _KV_DOWN[p]
          for p, s in zip(base_prec, spill)]
    t3 = ["int4"] * n
    tiers = [base]
    last = base_prec
    for t in (t1, t2, t3):
        if t != last:
            tiers.append(KVPlan(precisions=tuple(t), group=group))
            last = t
    return tiers


def kv_tier_labels(ladder: Sequence[Optional[KVPlan]]) -> list[str]:
    """The cache precision of each degradation tier: "bf16", "int8",
    "int4", or "mixed" when a tier's layers differ."""
    labels = []
    for kv in ladder:
        if kv is None:
            labels.append("bf16")
            continue
        uniq = sorted(set(kv.precisions))
        labels.append(uniq[0] if len(uniq) == 1 else "mixed")
    return labels


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
    # self-speculative draft stamp (DraftPlan.to_manifest()): a cold boot
    # re-derives the same draft (the derivation is deterministic given the
    # plan and the params) and checks it against this
    draft: Optional[dict] = None

    def stack_keys(self) -> list[str]:
        return [k for k, v in self.params.items()
                if isinstance(v, SegmentedParams)]

    def nbytes_effective(self) -> float:
        return sum(v.nbytes_effective() if isinstance(v, SegmentedParams)
                   else tree_nbytes(v) for v in self.params.values())

    def manifest(self) -> dict:
        stacks = {key: [{"precision": s.precision, "start": s.start,
                         "stop": s.stop} for s in self.params[key].segments]
                  for key in self.stack_keys()}
        out = {
            "version": ARTIFACT_VERSION,
            "family": self.family,
            "config_name": self.config_name,
            "group": self.group,
            "plan": json.loads(self.plan.to_json()),
            "stacks": stacks,
            "effective_bytes": float(self.nbytes_effective()),
        }
        if self.kv_plan is not None:
            out["kv_plan"] = self.kv_plan.to_dict()
        if self.draft is not None:
            out["draft"] = self.draft
        return out


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


# ---------------------------------------------------------------------------
# persisted artifacts (compile once, serve many)
# ---------------------------------------------------------------------------

def validate_manifest(manifest: dict, cfg: ModelConfig) -> None:
    """Check an artifact manifest against a target model config up front:
    a ``ValueError`` names the mismatch (family, config, plan length, stack
    layout, group size) instead of a failure deep in the restore."""
    def bail(msg):
        raise ValueError(f"artifact/model mismatch: {msg}")

    if manifest.get("version") != ARTIFACT_VERSION:
        bail(f"manifest version {manifest.get('version')!r}, this build "
             f"reads version {ARTIFACT_VERSION}")
    if manifest["family"] != cfg.family or manifest["config_name"] != cfg.name:
        bail(f"artifact was compiled for {manifest['config_name']!r} "
             f"({manifest['family']}); model is {cfg.name!r} ({cfg.family})")
    expected = plan_length(cfg)
    got = len(manifest["plan"]["decisions"])
    if got != expected:
        bail(f"plan carries {got} block decisions; family {cfg.family!r} "
             f"config {cfg.name!r} needs {expected} (layer counts differ?)")
    stacks, _ = family_layout(cfg)
    want_stacks = {s.key: s.hi - s.lo for s in stacks}
    got_stacks = manifest.get("stacks", {})
    if set(got_stacks) != set(want_stacks):
        bail(f"stack keys {sorted(got_stacks)} != expected "
             f"{sorted(want_stacks)}")
    for key, segs in got_stacks.items():
        covered = sum(s["stop"] - s["start"] for s in segs)
        if covered != want_stacks[key]:
            bail(f"stack {key!r} segments cover {covered} layers; config "
                 f"has {want_stacks[key]}")
    group = manifest["group"]
    if not isinstance(group, int) or group < 1:
        bail(f"group size {group!r} is not a positive integer")
    # a group that quantizes other leaves than the save-time compile did
    # (a tampered manifest) shows as a leaf-KIND mismatch between the
    # rebuilt skeleton and the checkpoint, which ckpt.restore names


def save_artifact(directory: str, compiled: CompiledPlan,
                  mesh=None) -> str:
    """Persist a compiled plan: quantized params checkpoint + manifest.
    ``autotune`` is ``"untuned"``: the port has no kernel autotuner. The
    arrays are stored whole, so the artifact restores onto any mesh or
    none; ``mesh`` only stamps the save-time layout (``saved_mesh``)."""
    from repro_torch.checkpoint import ckpt
    manifest = compiled.manifest()
    manifest["autotune"] = "untuned"
    if mesh is not None:
        manifest["saved_mesh"] = {
            "axis_names": list(mesh.axis_names),
            "shape": [int(mesh.shape[a]) for a in mesh.axis_names]}
    return ckpt.save_artifact(directory, compiled.params, manifest)


def load_artifact(directory: str, model, *, device=None,
                  mesh=None) -> CompiledPlan:
    """Boot a CompiledPlan from disk without raw weights or entropy
    analysis: the manifest's plan is compiled over parameters on the meta
    device (shapes only, no memory) to rebuild the segmented, quantized
    skeleton, and the checkpoint's leaves are restored into it, each
    straight onto ``device`` (None: the GPU). With ``mesh`` the skeleton's
    TP-only serving specs place each leaf's shards on their positions as
    it is read: ``params`` is then a ``sharding.specs.MeshTree``."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.device import resolve_device
    device = resolve_device(device)
    manifest = ckpt.load_artifact_manifest(directory)
    cfg = model.cfg
    validate_manifest(manifest, cfg)
    plan = QuantPlan.from_json(json.dumps(manifest["plan"]))
    group = manifest["group"]
    meta = model.init(torch.Generator(), "meta")
    skeleton = compile_plan(model, meta, plan, group).params
    if mesh is not None:
        from repro_torch.sharding.specs import serving_param_specs
        params = ckpt.restore_artifact(
            directory, skeleton, mesh=mesh,
            specs=serving_param_specs(skeleton, mesh))
    else:
        params = ckpt.restore_artifact(directory, skeleton, device=device)
    kv_plan = (KVPlan.from_dict(manifest["kv_plan"])
               if manifest.get("kv_plan") else None)
    return CompiledPlan(family=cfg.family, config_name=cfg.name, group=group,
                        plan=plan, params=params, kv_plan=kv_plan,
                        draft=manifest.get("draft"))
