"""A compiled plan does not pin the raw stacks it was cut from
(``quant/apply.apply_plan_stacked``), as the JAX package's slice copies.

A raw segment that covers only part of a stack, and the raw vectors of a
quantized segment that covers part of one, are copies: they share no
storage with the raw params. A segment spanning its whole stack may stay
a view. So once the caller drops the raw params, an engine over an
int8 / int4 plan holds exactly ``weight_bytes`` in distinct storages; the
same tree built with views (the fault this repairs) holds more."""

import dataclasses

import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.models.model import build
from repro_torch.quant.apply import Segment, SegmentedParams
from repro_torch.quant.qtypes import QTensor
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.quantized import explicit_plan
from repro_torch.tree import tree_leaves

LAYERS = ["raw", "int8", "int4", "raw"]


def _tensors(tree) -> list:
    out = []
    for v in (tree.values() if isinstance(tree, dict) else [tree]):
        trees = ([s.params for s in v.segments]
                 if isinstance(v, SegmentedParams) else [v])
        for leaf in (x for t in trees for x in tree_leaves(t)):
            out += ([leaf.data, leaf.scale] if isinstance(leaf, QTensor)
                    else [leaf])
    return out


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages a tree's tensors keep alive."""
    seen = {}
    for t in _tensors(tree):
        s = t.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def _model():
    cfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True),
                              num_layers=len(LAYERS))
    model = build(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), "cpu")


def test_partial_segments_share_no_storage_with_the_raw_stacks():
    cfg, model, params = _model()
    raw = {t.untyped_storage().data_ptr()
           for t in tree_leaves(params["layers"])}
    plan = explicit_plan(cfg, LAYERS, embed_precision="int8")
    compiled = model.compile_plan(params, plan).params
    segs = compiled["layers"].segments
    assert [(s.precision, s.start, s.stop) for s in segs] == [
        ("raw", 0, 1), ("int8", 1, 2), ("int4", 2, 3), ("raw", 3, 4)]
    for t in _tensors(compiled["layers"]):
        assert t.untyped_storage().data_ptr() not in raw
    # the copies hold the raw stacks' values
    for s in (segs[0], segs[3]):
        for k, v in s.params["attn"].items():
            assert torch.equal(v, params["layers"]["attn"][k][s.start:s.stop])


def test_a_whole_stack_segment_may_stay_a_view():
    cfg, model, params = _model()
    raw = {t.untyped_storage().data_ptr()
           for t in tree_leaves(params["layers"])}
    plan = explicit_plan(cfg, ["raw"] * len(LAYERS), embed_precision="int8")
    compiled = model.compile_plan(params, plan).params
    assert all(t.untyped_storage().data_ptr() in raw
               for t in _tensors(compiled["layers"]))


@pytest.mark.parametrize("layers", [LAYERS, ["int8", "raw", "raw", "int4"]])
def test_engine_holds_its_weight_bytes_once_raw_params_are_dropped(layers):
    cfg, model, params = _model()
    plan = explicit_plan(cfg, layers, embed_precision="int8")
    engine = ServeEngine(model, params, max_seq=32, plan=plan,
                         kv_precision="int8", device="cpu")
    stacks = params["layers"]
    params = None                       # the caller drops the raw params
    assert _storage_bytes(engine.params) == engine.weight_bytes()
    # the fault repaired: the raw segments as views of the raw stacks
    views = dict(engine.params)
    views["layers"] = SegmentedParams(
        segments=[Segment(s.precision, s.start, s.stop,
                          {k: {n: w[s.start:s.stop] for n, w in v.items()}
                           if isinstance(v, dict) else v[s.start:s.stop]
                           for k, v in stacks.items()})
                  if s.precision == "raw" else s
                  for s in engine.params["layers"].segments],
        num_layers=len(layers))
    assert _storage_bytes(views) > engine.weight_bytes()
