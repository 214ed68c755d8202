"""FastEWQ in the port (``repro_torch.core.fastewq`` and ``dataset``)
against the JAX package's, to the bit, and the slice as a whole at SMOKE
size.

The same seeded rows go through both packages: the rows a plan gives, the
feature matrix, the train/test split, each classifier trained by
``train_fastewq``, the plans it gives (both variants: precisions, exec
indices, sizes) and its KV spill order, ``evaluate_all_classifiers`` and
``feature_ablation``. A port pickle names only the port's classes.

The slice: each family's EWQ plan from the same weights in both packages
(the port's through the bridge), the rows of those plans, FastEWQ trained
with one family left out, that family's plan from the port's meta-device
block sizes, Algorithm 2 at a budget that demotes, and the compiled
payloads and scales of the adjusted plan equal to the JAX compile's."""

import dataclasses
import math
import pickle
import pickletools

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core import cluster as JCL
from repro.core import dataset as JD
from repro.core import fastewq as JF
from repro.core.planner import plan_model as jplan_model
from repro.models.model import build as jbuild
from repro.quant.compiler import compile_plan as jcompile_plan
from repro_torch.bridge import from_jax
from repro_torch.checkpoint.ckpt import flatten_with_paths
from repro_torch.configs.registry import get_config
from repro_torch.core import cluster as TCL
from repro_torch.core import dataset as TD
from repro_torch.core import fastewq as TF
from repro_torch.core.entropy import flatten_block_params
from repro_torch.core.planner import plan_model
from repro_torch.models.model import build
from repro_torch.quant.compiler import compile_plan
from repro_torch.quant.qtypes import QTensor

torch.set_num_threads(2)


def _synthetic_rows(n_models=25, seed=0, row=JD.BlockRow):
    """Paper-like dataset (the JAX package's tests/test_fastewq.py): later
    blocks and larger blocks quantize more often."""
    rng = np.random.default_rng(seed)
    rows = []
    for m in range(n_models):
        nb = int(rng.integers(8, 40))
        base = rng.uniform(3e7, 5e8)
        for i in range(nb):
            size = int(base * rng.uniform(0.8, 1.2))
            rel = i / nb
            p_q = 0.05 + 0.9 * rel
            q = int(rng.random() < p_q)
            rows.append(row(model_name=f"m{m}", num_blocks=nb,
                            exec_index=i + 1, num_parameters=size,
                            quantization_type="8-bit" if q else "raw",
                            quantized=q))
    return rows


def _both_rows(n_models, seed=0):
    return (_synthetic_rows(n_models, seed, JD.BlockRow),
            _synthetic_rows(n_models, seed, TD.BlockRow))


def _plan_key(plan):
    nan = lambda v: "nan" if math.isnan(v) else v   # noqa: E731
    return ([(d.block_index, d.exec_index, nan(d.entropy), d.num_parameters,
              d.precision) for d in plan.decisions],
            tuple(nan(v) for v in (plan.mu, plan.sigma, plan.threshold,
                                   plan.x_factor)))


def _equal(got, want):
    """Equal to the bit through dicts and floats."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _equal(got[k], want[k])
    else:
        assert type(got) is type(want) and got == want, (got, want)


# ---------------------------------------------------------------------------
# rows, features and the split
# ---------------------------------------------------------------------------

def test_rows_features_and_split_match_reference():
    jrows, trows = _both_rows(6, seed=3)
    assert [dataclasses.astuple(r) for r in trows] == \
        [dataclasses.astuple(r) for r in jrows]
    assert TD.FEATURES == JD.FEATURES
    (jx, jy), (tx, ty) = JD.to_xy(jrows), TD.to_xy(trows)
    np.testing.assert_array_equal(tx, jx, strict=True)
    np.testing.assert_array_equal(ty, jy, strict=True)
    for frac, seed in ((0.3, 0), (0.25, 7), (0.5, 1)):
        for a, b in zip(TD.train_test_split(tx, ty, frac, seed),
                        JD.train_test_split(jx, jy, frac, seed)):
            np.testing.assert_array_equal(a, b, strict=True)


def test_rows_from_plan_match_reference():
    """Every precision's row, from the same plan in both packages."""
    from repro.core import policy as JP
    from repro_torch.core import policy as TP
    precs = ["int8", "raw", "int8", "int4", "int3", "ternary", "int8"]
    plans = [P.QuantPlan(decisions=[
        P.BlockDecision(block_index=i, exec_index=i + 1, entropy=0.5 * i,
                        num_parameters=1000 * (i + 1), precision=p)
        for i, p in enumerate(precs)], mu=1.0, sigma=0.5, threshold=0.5,
        x_factor=1.0) for P in (JP, TP)]
    jrows = JD.rows_from_plan("m", plans[0])
    trows = TD.rows_from_plan("m", plans[1])
    assert [dataclasses.astuple(r) for r in trows] == \
        [dataclasses.astuple(r) for r in jrows]
    assert [r.quantization_type for r in trows] == \
        ["8-bit", "raw", "8-bit", "4-bit", "4-bit", "4-bit", "8-bit"]


# ---------------------------------------------------------------------------
# the classifier, its plans and its spill order
# ---------------------------------------------------------------------------

SIZES = {"flat": [int(2e8)] * 12,
         "ramp": [int(3e7 * (1 + i)) for i in range(20)],
         "llama-like": [394_002_432] + [100_675_584] * 28}


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("name", list(JF.CLASSIFIERS))
def test_trained_plans_and_spill_order_match_reference(name, full):
    jrows, trows = _both_rows(8)
    jf = JF.train_fastewq(jrows, classifier=name, full_dataset=full, seed=1)
    tf = TF.train_fastewq(trows, classifier=name, full_dataset=full, seed=1)
    assert tf.name == jf.name == name
    np.testing.assert_array_equal(tf.scaler.mean_, jf.scaler.mean_)
    np.testing.assert_array_equal(tf.scaler.scale_, jf.scaler.scale_)
    for sizes in SIZES.values():
        for start in (1, 2):
            for variant in ("8bit-mixed", "4bit/8bit"):
                got = tf.plan(sizes, start_exec_index=start, variant=variant)
                want = jf.plan(sizes, start_exec_index=start, variant=variant)
                assert _plan_key(got) == _plan_key(want)
            assert tf.kv_spill_order(sizes, start_exec_index=start) == \
                jf.kv_spill_order(sizes, start_exec_index=start)
    for args in ((2e8, 30, 32), (5e7, 1, 8), (4e8, 11, 12)):
        assert tf.predict_quantized(*args) == jf.predict_quantized(*args)


def test_evaluate_all_classifiers_matches_reference():
    jrows, trows = _both_rows(5, seed=2)
    got = TF.evaluate_all_classifiers(trows, seed=3)
    want = JF.evaluate_all_classifiers(jrows, seed=3)
    _equal(got, want)
    assert len(got) == 6 and "feature_importances" in got["random forest"]


def test_feature_ablation_matches_reference():
    jrows, trows = _both_rows(4, seed=4)
    got = TF.feature_ablation(trows, seed=2)
    _equal(got, JF.feature_ablation(jrows, seed=2))
    assert list(got) == ["all", "without_num_parameters",
                         "without_exec_index", "without_num_blocks"]


def _pickle_modules(path) -> set:
    """The modules a pickle names (its GLOBAL / STACK_GLOBAL opcodes)."""
    data = open(path, "rb").read()
    mods, strings = set(), []
    for op, arg, _ in pickletools.genops(data):
        if op.name in ("SHORT_BINUNICODE", "BINUNICODE", "UNICODE"):
            strings.append(arg)
        elif op.name == "STACK_GLOBAL":
            mods.add(strings[-2])
        elif op.name == "GLOBAL":
            mods.add(arg.split(" ")[0])
    return mods


def test_save_load_round_trip_names_only_the_port(tmp_path):
    _, trows = _both_rows(5)
    fq = TF.train_fastewq(trows)
    path = tmp_path / "fastewq.pkl"
    fq.save(str(path))
    mods = _pickle_modules(path)
    assert "repro_torch.core.fastewq" in mods
    assert "repro_torch.core.classifiers.rf" in mods
    assert not [m for m in mods if m == "repro" or m.startswith("repro.")]
    fq2 = TF.FastEWQ.load(str(path))
    assert type(fq2) is TF.FastEWQ and type(fq2.clf) is type(fq.clf)
    sizes = SIZES["ramp"]
    assert _plan_key(fq2.plan(sizes)) == _plan_key(fq.plan(sizes))
    assert fq2.kv_spill_order(sizes) == fq.kv_spill_order(sizes)
    assert pickle.loads(pickle.dumps(fq2)).name == fq.name


# ---------------------------------------------------------------------------
# the slice at SMOKE size
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("llama3.2-3b", "grok-1-314b", "whisper-medium",
                "mamba2-780m", "zamba2-2.7b")


def _block_sizes(blocks) -> list:
    """Each block's parameter count as EWQ counts it: its matrices."""
    return [sum(int(math.prod(w.shape))
                for w in flatten_block_params(b).values() if w.ndim >= 2)
            for b in blocks]


@pytest.fixture(scope="module")
def family_plans():
    """Per family: both configs, both models, both EWQ plans (the port's
    from the JAX weights through the bridge) and the JAX params."""
    out = {}
    for arch in FAMILY_ARCHS:
        jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                                   dtype="float32")
        tcfg = dataclasses.replace(get_config(arch, smoke=True),
                                   dtype="float32")
        jmodel, tmodel = jbuild(jcfg), build(tcfg)
        jparams = jmodel.init(jax.random.PRNGKey(11))
        tparams = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
        jplan = jplan_model(jmodel, jparams, variant="4bit/8bit")
        tplan = plan_model(tmodel, tparams, variant="4bit/8bit")
        out[arch] = (jmodel, jparams, tmodel, tparams, jplan, tplan)
    return out


def _trees_equal(got, want):
    g, w = dict(flatten_with_paths(got)), dict(flatten_with_paths(want))
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))
    for key, b in w.items():
        a = g[key]
        if isinstance(b, QTensor):
            assert (a.precision, tuple(a.shape), a.group) == \
                (b.precision, tuple(b.shape), b.group), key
            pairs = ((a.data, b.data), (a.scale, b.scale))
        else:
            pairs = ((a, b),)
        for x, y in pairs:
            assert x.dtype == y.dtype and torch.equal(x, y), key


@pytest.mark.parametrize("held_out", FAMILY_ARCHS)
def test_slice_leave_one_family_out(family_plans, held_out):
    jrows, trows = [], []
    for arch, (*_, jplan, tplan) in family_plans.items():
        assert tplan.precisions() == jplan.precisions(), arch
        if arch != held_out:
            jrows += JD.rows_from_plan(arch, jplan)
            trows += TD.rows_from_plan(arch, tplan)
    assert [dataclasses.astuple(r) for r in trows] == \
        [dataclasses.astuple(r) for r in jrows]
    jf = JF.train_fastewq(jrows, full_dataset=True)
    tf = TF.train_fastewq(trows, full_dataset=True)

    jmodel, jparams, tmodel, _, jplan, _ = family_plans[held_out]
    meta = tmodel.init(torch.Generator(), "meta")
    sizes = _block_sizes(tmodel.block_params(meta))
    assert sizes == _block_sizes(jmodel.block_params(jparams))
    assert sizes == [d.num_parameters for d in jplan.decisions]
    jfast = jf.plan(sizes, variant="4bit/8bit")
    tfast = tf.plan(sizes, variant="4bit/8bit")
    assert _plan_key(tfast) == _plan_key(jfast)

    # Algorithm 2 at a budget that demotes: the plan, forced quantized
    # past the classifier where it chose raw everywhere, squeezed to 60%
    if not any(d.quantized for d in jfast.decisions):
        jfast, tfast = (p.with_precisions(["int8"] * len(sizes))
                        for p in (jfast, tfast))
    budget = jfast.total_bytes() * 0.6
    want = JCL.fastewq_resource_adjust(
        jfast, [JCL.Machine("device", budget, budget)])
    got = TCL.fastewq_resource_adjust(
        tfast, [TCL.Machine("device", budget, budget)])
    assert _plan_key(got["plan"]) == _plan_key(want["plan"])
    assert (got["fits"], got["total_bytes"], got["budget"],
            got["placement"]) == (want["fits"], want["total_bytes"],
                                  want["budget"], want["placement"])
    assert want["total_bytes"] < jfast.total_bytes()
    assert set(want["plan"].precisions()) & {"int4", "ternary"}

    jcompiled = jcompile_plan(jmodel, jparams, want["plan"])
    tcompiled = compile_plan(tmodel, family_plans[held_out][3], got["plan"])
    _trees_equal(tcompiled.params,
                 from_jax(jax.tree.map(np.asarray, jcompiled.params),
                          device="cpu"))
    # the byte counts sum the same leaves in another order
    assert tcompiled.nbytes_effective() == pytest.approx(
        jcompiled.nbytes_effective(), rel=1e-12)
