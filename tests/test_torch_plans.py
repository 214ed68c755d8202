"""EWQ analysis and planning of the PyTorch port against the JAX reference:
matrix entropies within 1e-5 relative (f32), and the same QuantPlan
precisions for all six variants on the block params of every family's
SMOKE model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core import entropy as JE
from repro.core import planner as JP
from repro.models.model import build as jbuild
from repro.serving import quantized as JQS
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.core import entropy as TE
from repro_torch.core import planner as TP
from repro_torch.serving import quantized as TQS

torch.set_num_threads(2)

# one arch per family, as tests/conftest.py lists them
FAMILY_ARCHS = (("dense", "llama3.2-3b"), ("ssm", "mamba2-780m"),
                ("hybrid", "zamba2-2.7b"), ("encdec", "whisper-medium"))
VARIANTS = ("raw", "4bit", "8bit", "8bit-mixed", "4bit/8bit", "ternary/4bit")


@pytest.mark.parametrize("shape,scale", [((64, 96), 0.05), ((3, 128, 40), 1.0),
                                         ((1000,), 3.0)])
def test_matrix_entropy_matches_reference(shape, scale):
    w = (np.random.default_rng(shape[0]).standard_normal(shape) * scale
         ).astype(np.float32)
    tw = torch.from_numpy(w)
    for eps in (0.01, 1e-6):
        want = float(JE.matrix_entropy_paper(jnp.asarray(w), eps=eps))
        got = float(TE.matrix_entropy_paper(tw, eps=eps))
        assert got == pytest.approx(want, rel=1e-5)
    want = float(JE.matrix_entropy_stream(jnp.asarray(w), chunk=4096))
    assert float(TE.matrix_entropy_stream(tw, chunk=4096)) == \
        pytest.approx(want, rel=1e-5)
    assert float(TE.matrix_entropy_stream(tw, chunk=77)) == \
        pytest.approx(want, rel=1e-5)


def test_kernel_mode_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="entropy kernel"):
        TE.matrix_entropy(torch.ones(4, 4), mode="kernel")


@pytest.fixture(scope="module")
def family_blocks():
    out = {}
    for family, arch in FAMILY_ARCHS:
        cfg = jget_config(arch, smoke=True)
        model = jbuild(cfg)
        params = model.init(jax.random.PRNGKey(3))
        blocks = jax.tree.map(np.asarray, model.block_params(params))
        out[family] = (arch, blocks, from_jax(blocks))
    return out


@pytest.mark.parametrize("family", [f for f, _ in FAMILY_ARCHS])
def test_plans_match_reference_for_every_variant(family_blocks, family):
    arch, jblocks, tblocks = family_blocks[family]
    jents = JE.analyze_blocks(jblocks, first_exec_index=1)
    tents = TE.analyze_blocks(tblocks, first_exec_index=1)
    for je, te in zip(jents, tents):
        assert te.num_parameters == je.num_parameters
        assert te.entropy == pytest.approx(je.entropy, rel=1e-5)
    for variant in VARIANTS:
        jplan = JP.plan(jblocks, variant=variant)
        tplan = TP.plan(tblocks, variant=variant)
        assert tplan.precisions() == jplan.precisions(), variant
        assert tplan.threshold == pytest.approx(jplan.threshold, rel=1e-5)
        for kv in ("bf16", "int8", "int4", "auto"):
            jkv = JP.plan_kv(jget_config(arch, smoke=True), jplan,
                             kv_precision=kv)
            tkv = TP.plan_kv(get_config(arch, smoke=True), tplan,
                             kv_precision=kv)
            assert (None if tkv is None else tkv.to_dict()) == \
                (None if jkv is None else jkv.to_dict())


@pytest.mark.parametrize("family,arch", FAMILY_ARCHS)
def test_metadata_and_explicit_plans_match_reference(family, arch):
    jcfg, tcfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    assert tcfg == tcfg.__class__(**{
        f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    for variant in ("8bit-mixed", "4bit/8bit"):
        assert (TQS.fastewq_metadata_plan(tcfg, variant).precisions()
                == JQS.fastewq_metadata_plan(jcfg, variant).precisions())
    n = jcfg.num_layers + (jcfg.num_encoder_layers or 0)
    layers = (["int8", "int4", "ternary", "raw"] * n)[:n]
    assert (TQS.explicit_plan(tcfg, layers).precisions()
            == JQS.explicit_plan(jcfg, layers).precisions())
