"""Compiled-plan artifacts of the port against the JAX package, both ways:
the on-disk format is the reference's, so an artifact written by either
package boots in the other.

* an artifact written by JAX's ``save_artifact`` and cold-booted by the
  port (``load_artifact`` on a meta-device skeleton) holds the JAX compiled
  params carried over by ``bridge.from_jax``, to the bit: dense with all
  four precisions, hybrid cut at its shared-attention units, enc-dec with
  its two stacks; the booted engine's greedy tokens equal the in-memory JAX
  engine's and its logprobs lie within 1e-4;
* an artifact written by the port loads in JAX's ``load_artifact`` with
  the same plan, effective bytes and leaves;
* ``validate_manifest`` refuses a wrong model, a layer-count mismatch and a
  tampered group; one flipped payload byte, or a missing payload, raises
  ``ArtifactCorruptionError`` naming the leaf;
* the stamped KV plan and the stamped self-draft round trip, and a draft
  stamp the re-derived draft does not match raises (in both packages);
* on the card, an artifact at a weight group the kernels refuse is refused
  at boot.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models.model import build as jbuild
from repro.quant.compiler import compile_draft_plan as jcompile_draft_plan
from repro.quant.compiler import compile_plan as jcompile_plan
from repro.quant.compiler import load_artifact as jload_artifact
from repro.quant.compiler import save_artifact as jsave_artifact
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.quantized import explicit_plan as jexplicit_plan
from repro.serving.spec import SpecConfig as JSpecConfig
from repro_torch.bridge import from_jax
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import (ArtifactCorruptionError,
                                         flatten_with_paths)
from repro_torch.configs.registry import get_config
from repro_torch.models.model import build
from repro_torch.quant.compiler import (compile_plan, load_artifact,
                                        save_artifact)
from repro_torch.quant.qtypes import QTensor
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.quantized import explicit_plan
from repro_torch.serving.spec import SpecConfig

torch.set_num_threads(2)

# per family: arch, config overrides, layer precisions, shared precision
CASES = {
    "dense": ("llama3.2-3b", {"num_layers": 4},
              ["ternary", "int4", "int8", "raw"], "raw"),
    # period 2: the int8 run 0-3 is cut at layer 2 (one unit each)
    "hybrid": ("zamba2-2.7b", {}, ["int8", "int8", "int8", "int4"], "int8"),
    "encdec": ("whisper-medium", {}, ["int4", "ternary", "int8", "raw"],
               "raw"),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(family):
    arch, over, layers, shared = CASES[family]
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), dtype="float32",
                               **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                               **over)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jplan = jexplicit_plan(jcfg, layers, shared_precision=shared)
    tplan = explicit_plan(tcfg, layers, shared_precision=shared)
    return jcfg, tcfg, jmodel, jparams, build(tcfg), jplan, tplan


def _assert_trees_equal(got, want):
    """Same keys, and every leaf equal to the bit with its dtype."""
    g, w = dict(flatten_with_paths(got)), dict(flatten_with_paths(want))
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))
    for key in g:
        a, b = g[key], w[key]
        if isinstance(b, QTensor):
            assert isinstance(a, QTensor), key
            assert (a.precision, tuple(a.shape), a.group) == \
                (b.precision, tuple(b.shape), b.group), key
            pairs = ((a.data, b.data), (a.scale, b.scale))
        else:
            pairs = ((a, b),)
        for x, y in pairs:
            assert x.dtype == y.dtype and torch.equal(x, y), key


def _frames(jcfg, b):
    if jcfg.family != "encdec":
        return None
    return np.random.default_rng(5).standard_normal(
        (b, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("family", list(CASES))
def test_port_boots_jax_artifact(family, tmp_path):
    jcfg, tcfg, jmodel, jparams, tmodel, jplan, _ = _models(family)
    jcompiled = jcompile_plan(jmodel, jparams, jplan)
    jsave_artifact(str(tmp_path), jcompiled)
    got = load_artifact(str(tmp_path), tmodel, device="cpu")
    assert got.plan.precisions() == jplan.precisions()
    assert got.group == jcompiled.group and got.kv_plan is None
    assert got.nbytes_effective() == jcompiled.nbytes_effective()
    assert got.stack_keys() == jcompiled.stack_keys()
    _assert_trees_equal(got.params, from_jax(_np(jcompiled.params), "cpu"))
    if family == "hybrid":
        segs = [(s.precision, s.start, s.stop)
                for s in got.params["layers"].segments]
        assert segs == [("int8", 0, 2), ("int8", 2, 3), ("int4", 3, 4)]


@pytest.mark.parametrize("family", list(CASES))
def test_booted_engine_matches_jax_engine(family, tmp_path):
    """Greedy tokens of the port's cold-booted engine equal the in-memory
    JAX engine's; logprobs within 1e-4."""
    jcfg, tcfg, jmodel, jparams, tmodel, jplan, _ = _models(family)
    jcompiled = jcompile_plan(jmodel, jparams, jplan)
    jsave_artifact(str(tmp_path), jcompiled)
    jeng = JServeEngine(jmodel, jcompiled.params, max_seq=20, autotune=False)
    teng = ServeEngine.from_artifact(tmodel, str(tmp_path), max_seq=20,
                                     device="cpu")
    assert teng.plan.precisions() == jplan.precisions()
    assert teng.weight_bytes() == pytest.approx(jeng.weight_bytes())
    prompts = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    frames = _frames(jcfg, 2)
    want = jeng.generate(jnp.asarray(prompts), 6,
                         frames=None if frames is None
                         else jnp.asarray(frames))
    got = teng.generate(prompts, 6, frames=frames)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprobs.numpy(),
                               np.asarray(want.logprobs), atol=1e-4)


@pytest.mark.parametrize("family", list(CASES))
def test_jax_boots_port_artifact(family, tmp_path):
    jcfg, tcfg, jmodel, jparams, tmodel, jplan, tplan = _models(family)
    tcompiled = compile_plan(tmodel, from_jax(_np(jparams), "cpu"), tplan)
    save_artifact(str(tmp_path), tcompiled)
    manifest = ckpt.load_artifact_manifest(str(tmp_path))
    assert manifest["autotune"] == "untuned" and manifest["version"] == 1
    loaded = jload_artifact(str(tmp_path), jmodel)
    want = jcompile_plan(jmodel, jparams, jplan)
    assert loaded.plan.precisions() == jplan.precisions()
    assert loaded.nbytes_effective() == want.nbytes_effective()
    assert manifest["effective_bytes"] == want.manifest()["effective_bytes"]
    assert manifest["stacks"] == want.manifest()["stacks"]
    a, b = jax.tree.leaves(loaded.params), jax.tree.leaves(want.params)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


def _saved_dense(tmp_path, layers=4):
    """A port artifact of the 4-layer dense SMOKE model (int8 plan)."""
    _, tcfg, _, jparams, tmodel, _, _ = _models("dense")
    if layers != 4:
        tcfg = dataclasses.replace(tcfg, num_layers=layers)
        tmodel = build(tcfg)
        params = tmodel.init(torch.Generator().manual_seed(0), "cpu")
    else:
        params = from_jax(_np(jparams), "cpu")
    plan = explicit_plan(tcfg, ["int8"] * layers)
    save_artifact(str(tmp_path), compile_plan(tmodel, params, plan))
    return tcfg, tmodel


def test_artifact_rejects_wrong_model(tmp_path):
    _saved_dense(tmp_path)
    other = build(get_config("mamba2-780m", smoke=True))
    with pytest.raises(ValueError, match="compiled for"):
        load_artifact(str(tmp_path), other, device="cpu")


def test_artifact_rejects_layer_count_mismatch(tmp_path):
    tcfg, _ = _saved_dense(tmp_path)
    deeper = build(dataclasses.replace(tcfg, num_layers=6))
    with pytest.raises(ValueError, match="block decisions"):
        load_artifact(str(tmp_path), deeper, device="cpu")


def test_artifact_rejects_tampered_group(tmp_path):
    _, tmodel = _saved_dense(tmp_path, layers=2)
    mpath = tmp_path / "plan_manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["group"] = 100     # divides nothing: the skeleton stays raw
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="group/plan mismatch"):
        load_artifact(str(tmp_path), tmodel, device="cpu")
    manifest["group"] = 0
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="positive integer"):
        load_artifact(str(tmp_path), tmodel, device="cpu")


def _shard(tmp_path):
    return tmp_path / "step_00000000" / "shard_0.npz"


def test_flipped_payload_byte_names_the_leaf(tmp_path):
    _, tmodel = _saved_dense(tmp_path)
    with np.load(_shard(tmp_path)) as z:
        data = {k: z[k].copy() for k in z.files}
    key = "layers/0/0/0/attn/wq.__qdata"
    data[key].view(np.uint8).reshape(-1)[7] ^= 0x10
    np.savez(_shard(tmp_path), **data)
    with pytest.raises(ArtifactCorruptionError) as err:
        load_artifact(str(tmp_path), tmodel, device="cpu")
    assert err.value.leaf == "layers/0/0/0/attn/wq"
    # the JAX package refuses the same file for the same leaf
    jmodel = jbuild(dataclasses.replace(
        jget_config("llama3.2-3b", smoke=True), dtype="float32",
        num_layers=4))
    with pytest.raises(Exception) as jerr:
        jload_artifact(str(tmp_path), jmodel)
    assert getattr(jerr.value, "leaf", None) == "layers/0/0/0/attn/wq"


def test_missing_payload_raises(tmp_path):
    _, tmodel = _saved_dense(tmp_path)
    with np.load(_shard(tmp_path)) as z:
        data = {k: z[k] for k in z.files if k != "final/norm"}
    np.savez(_shard(tmp_path), **data)
    with pytest.raises(ArtifactCorruptionError, match="missing") as err:
        load_artifact(str(tmp_path), tmodel, device="cpu")
    assert err.value.leaf == "final/norm"


def test_kv_plan_stamp_roundtrip(tmp_path):
    """compile_plan stamps the KV plan into the manifest; from_artifact
    serves with it, as the in-memory engine given the same plan does, and
    JAX reads the same stamp."""
    jcfg, tcfg, jmodel, _, tmodel, _, _ = _models("dense")
    plan = explicit_plan(tcfg, ["int4", "int8", "int8", "raw"])
    params = from_jax(_np(jmodel.init(jax.random.PRNGKey(0))), "cpu")
    compiled = compile_plan(tmodel, params, plan, kv_precision="auto")
    assert compiled.kv_plan.precisions == ("int4", "int8", "int8", "bf16")
    save_artifact(str(tmp_path), compiled)
    assert load_artifact(str(tmp_path), tmodel,
                         device="cpu").kv_plan == compiled.kv_plan
    assert jload_artifact(str(tmp_path), jmodel).kv_plan.precisions == \
        compiled.kv_plan.precisions
    eng = ServeEngine.from_artifact(tmodel, str(tmp_path), max_seq=24,
                                    device="cpu")
    assert eng.kv_plan == compiled.kv_plan
    mem = ServeEngine(tmodel, compiled.params, max_seq=24,
                      kv_precision=compiled.kv_plan, device="cpu")
    prompts = np.random.default_rng(5).integers(0, tcfg.vocab_size, (1, 6))
    np.testing.assert_array_equal(mem.generate(prompts, 5).tokens.numpy(),
                                  eng.generate(prompts, 5).tokens.numpy())
    # an explicit kv_precision overrides the stamp; "auto" is compiled
    # from the stamped plan
    assert ServeEngine.from_artifact(tmodel, str(tmp_path), max_seq=24,
                                     device="cpu",
                                     kv_precision="bf16").kv_plan is None
    auto = ServeEngine.from_artifact(tmodel, str(tmp_path), max_seq=24,
                                     device="cpu", kv_precision="auto")
    assert auto.kv_plan == compiled.kv_plan


def test_draft_stamp_roundtrip_and_mismatch(tmp_path):
    """The stamped self-draft re-derives to the stamp on a cold boot (as
    in the JAX package), and a stamp the re-derived draft does not match
    raises in both packages."""
    jcfg, tcfg, jmodel, jparams, tmodel, _, _ = _models("dense")
    layers = ["int4", "int8", "ternary", "raw"]
    jplan = jexplicit_plan(jcfg, layers)
    jcompiled = jcompile_plan(jmodel, jparams, jplan)
    jcompiled.draft = jcompile_draft_plan(jmodel, jcompiled.params,
                                          jplan).to_manifest()
    d = tmp_path / "art"
    jsave_artifact(str(d), jcompiled)
    eng = ServeEngine.from_artifact(tmodel, str(d), max_seq=32,
                                    device="cpu", spec=SpecConfig(k=2))
    draft = eng._ensure_draft()
    assert list(draft.precisions) == jcompiled.draft["precisions"]
    assert draft.overhead_bytes == jcompiled.draft["overhead_bytes"]
    assert draft.to_manifest() == jcompiled.draft
    base = ServeEngine.from_artifact(tmodel, str(d), max_seq=32,
                                     device="cpu")
    prompts = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 8))
    np.testing.assert_array_equal(
        base.generate(prompts, 6, chunk=3).tokens.numpy(),
        eng.generate(prompts, 6, chunk=2).tokens.numpy())

    mpath = d / "plan_manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["draft"]["precisions"][1] = "ternary"
    mpath.write_text(json.dumps(manifest))
    bad = ServeEngine.from_artifact(tmodel, str(d), max_seq=32,
                                    device="cpu", spec=SpecConfig(k=2))
    with pytest.raises(ValueError, match="draft stamp mismatch"):
        bad._ensure_draft()
    jbad = JServeEngine.from_artifact(jmodel, str(d), max_seq=32,
                                      spec=JSpecConfig(k=2), autotune=False)
    with pytest.raises(ValueError, match="draft stamp mismatch"):
        jbad._ensure_draft()
    # another draft group is an explicit override: not checked
    other = ServeEngine.from_artifact(tmodel, str(d), max_seq=32,
                                      device="cpu",
                                      spec=SpecConfig(k=2, draft_group=64))
    other._ensure_draft()


def test_kernel_group_refused_at_boot_on_the_card(tmp_path, monkeypatch):
    """On a CUDA device an artifact quantized at a group the kernels do
    not take (ROADMAP.md K1) raises at boot, before a leaf is read; on the
    CPU it boots."""
    tcfg, tmodel = _saved_dense(tmp_path, layers=2)
    mpath = tmp_path / "plan_manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["group"] = 64
    mpath.write_text(json.dumps(manifest))
    monkeypatch.setattr(engine_mod, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    with pytest.raises(ValueError, match="K1"):
        ServeEngine.from_artifact(tmodel, str(tmp_path), max_seq=16)
