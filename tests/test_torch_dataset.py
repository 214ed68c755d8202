"""The port's FastEWQ dataset builder (``repro_torch.core.dataset
.build_dataset``) against the JAX package's, at a few steps on two archs.

Each builds the same deepened SMOKE configs, trains them and plans them;
the deterministic columns (``model_name``, ``num_blocks``, ``exec_index``,
``num_parameters``) must be equal row for row. ``quantized`` depends on the
init's random draws, which differ between the packages (a
``torch.Generator`` against ``jax.random``), so it is only checked to be 0
or 1 and to agree with ``quantization_type``. A builder with other widths
(the planted fault: ``scale_overrides``) gives other parameter counts."""

import numpy as np
import pytest
import torch

from repro.core import dataset as JD
from repro_torch.core import dataset as TD

torch.set_num_threads(2)

ARCHS = ("llama3.2-3b", "mamba2-780m")
ENTROPY_RTOL = 1e-5
KEYS = ("model_name", "num_blocks", "exec_index", "num_parameters")


def _columns(rows) -> list:
    return [tuple(getattr(r, k) for k in KEYS) for r in rows]


@pytest.fixture(scope="module")
def rows():
    return (JD.build_dataset(steps=2, seeds=(1,), archs=ARCHS),
            TD.build_dataset(steps=2, seeds=(1,), archs=ARCHS,
                             device="cpu"))


def test_deterministic_columns_equal_reference(rows):
    want, got = rows
    assert len(got) == len(want) == 10 + 10
    assert _columns(got) == _columns(want)
    for r in got:
        assert r.quantized in (0, 1)
        assert (r.quantization_type == "raw") == (r.quantized == 0)
        assert r.quantization_type in ("raw", "8-bit", "4-bit")


def test_rows_feed_the_classifiers(rows):
    """The rows make a feature matrix the FastEWQ classifiers take."""
    _, got = rows
    x, y = TD.to_xy(got)
    assert x.shape == (len(got), 3) and set(np.unique(y)) <= {0, 1}
    assert (x[:, 1] >= 1).all() and (x[:, 0] > 0).all()


def test_other_widths_change_the_counts(rows):
    want = [r for r in rows[0] if r.model_name.startswith("llama")]
    got = TD.build_dataset(steps=1, seeds=(1,), archs=ARCHS[:1],
                           device="cpu", scale_overrides={"d_ff": 384})
    assert [r.num_parameters for r in got] != [r.num_parameters
                                               for r in want]


def _to_jax(tree):
    """The port's raw params as the JAX package's tree (bf16 exactly)."""
    import jax
    import jax.numpy as jnp

    def leaf(t):
        a = jnp.asarray(t.float().numpy())
        return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a
    return jax.tree.map(leaf, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def test_rows_are_reference_ewq_of_trained_weights(rows):
    """The builder labels the port's trained weights as the reference's EWQ
    does: the JAX package's ``plan_model`` on the same weights (carried
    across bit for bit) gives the port's ``quantized`` column, and its block
    entropies equal the port's paper-mode analysis (what ``build_dataset``
    runs) within ENTROPY_RTOL. The planted fault, the kernel-mode analysis
    (entropy at eps 0 through the grouped kernel's closed form), moves the
    entropies past that limit."""
    import dataclasses

    from repro.configs.registry import get_config as jget_config
    from repro.core.planner import plan_model as jplan_model
    from repro.models.model import build as jbuild
    from repro_torch.core.planner import plan_model

    model, params = TD.train_reduced(ARCHS[0], 1, steps=2, device="cpu")
    got = [r.quantized for r in rows[1] if r.model_name.startswith("llama")]
    jcfg = dataclasses.replace(jget_config(ARCHS[0], smoke=True),
                               num_layers=model.cfg.num_layers)
    want = jplan_model(jbuild(jcfg), _to_jax(params), variant="4bit/8bit")
    assert got == [int(d.quantized) for d in want.decisions]
    jent = [d.entropy for d in want.decisions]
    paper = plan_model(model, params, variant="4bit/8bit")
    kernel = plan_model(model, params, variant="4bit/8bit", mode="kernel")
    err = _rel([d.entropy for d in paper.decisions], jent)
    fault = _rel([d.entropy for d in kernel.decisions], jent)
    print(f"block entropies vs reference: paper {err:.3g}, kernel {fault:.3g}")
    assert err < ENTROPY_RTOL < fault
