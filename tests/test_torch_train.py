"""The port's training step (``repro_torch.train.step``) against the JAX
package's on the same params (carried through the bridge) and the same
seeded batch, at SMOKE size in f32, for all five families: dense (llama,
vocab cut to 500 so the padded-vocab mask is on), MoE (grok, with its
load-balancing loss), enc-dec (whisper, with frames), SSM (mamba2) and
hybrid (zamba2, the shared block's gradients summed over its sites).

Limits: the loss within LOSS_RTOL relative, each gradient leaf within
GRAD_REL_L2 relative L2. Readings beside them: the port's own gradients
with the batch's rows reversed (only the order of the sums changes; MoE
excluded, where the order decides the capacity drops) sit near 4e-7, the
port against the reference at most ~6e-6, and the planted fault, labels
left unshifted (the tokens themselves), at 0.2 or more, which the limit
must catch. ``remat=True`` equals ``remat=False`` to the bit; two
microbatches equal the whole batch within f32 summation (MICRO_REL_L2).
The bf16 tests run the launcher's training run in the dtype the card
trains in: three steps at SMOKE size held to the JAX steps, and eight at
FULL llama's d_model against JAX and against the init's loss."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.data.synthetic import synthetic_batch as jsynthetic_batch
from repro.models.model import build as jbuild
from repro.train import step as JT
from repro_torch.bridge import from_jax
from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import synthetic_batch
from repro_torch.launch.steps import make_optimizer
from repro_torch.models.model import build
from repro_torch.train import step as TT
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
MICRO_REL_L2 = 1e-5
BF16_LOSS_RTOL = 1e-3
BF16_UPDATE_REL_L2 = 0.1
BF16_TRAJECTORY_ATOL = 0.02
FAMILIES = {"dense": "llama3.2-3b", "moe": "grok-1-314b",
            "encdec": "whisper-medium", "ssm": "mamba2-780m",
            "hybrid": "zamba2-2.7b"}


def _cfgs(arch: str, **over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(jget_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _grads(model, params, batch, remat=False):
    return TT.make_grad_fn(TT.make_loss_fn(model, remat=remat))(params,
                                                                batch)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grads_match_reference(family):
    over = {"vocab_size": 500} if family == "dense" else {}
    jcfg, cfg = _cfgs(FAMILIES[family], **over)
    jmodel, model = jbuild(jcfg), build(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jb = jsynthetic_batch(jcfg, batch=4, seq=32, step=0)
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        JT.make_loss_fn(jmodel, remat=False), has_aux=True))(jparams, jb)
    params = from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    batch = synthetic_batch(cfg, batch=4, seq=32, step=0, device="cpu")
    (total, metrics), grads = _grads(model, params, batch)
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        assert float(metrics[k]) == pytest.approx(float(jmetrics[k]),
                                                  rel=LOSS_RTOL), k
    assert float(total) == pytest.approx(float(jtotal), rel=LOSS_RTOL)
    want = tree_leaves(from_jax(jax.tree.map(np.asarray, jgrads), "cpu"))
    got = tree_leaves(grads)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    errs = [rel_l2(g, w) for g, w in zip(got, want)]
    print(f"{family}: grads vs reference, worst leaf {max(errs):.3g}")
    assert max(errs) < GRAD_REL_L2

    fault = dict(batch, labels=batch["tokens"])
    _, fgrads = _grads(model, params, fault)
    faults = [rel_l2(g, w) for g, w in zip(tree_leaves(fgrads), want)]
    print(f"{family}: labels unshifted, worst leaf {max(faults):.3g}")
    assert max(faults) > GRAD_REL_L2
    if family != "moe":
        flipped = {k: v.flip(0) for k, v in batch.items()}
        _, rgrads = _grads(model, params, flipped)
        floor = max(rel_l2(r, g) for r, g in zip(tree_leaves(rgrads), got))
        print(f"{family}: rows reversed (the reordered-sum floor) {floor:.3g}")
        assert floor < GRAD_REL_L2


@pytest.mark.parametrize("family", ["dense", "moe", "hybrid"])
def test_remat_equals_plain_bits(family):
    _, cfg = _cfgs(FAMILIES[family])
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = synthetic_batch(cfg, batch=2, seq=32, step=1, device="cpu")
    (l0, m0), g0 = _grads(model, params, batch, remat=False)
    (l1, m1), g1 = _grads(model, params, batch, remat=True)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_microbatches_equal_whole_batch(family):
    _, cfg = _cfgs(FAMILIES[family])
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    batch = synthetic_batch(cfg, batch=4, seq=32, step=2, device="cpu")
    out = {}
    for mb in (None, 2):
        run = RunConfig(steps=1, microbatch=mb)
        step = TT.make_train_step(model, make_optimizer(run), run)
        out[mb] = step.compute_grads(params, batch)
    (l_whole, _), g_whole = out[None]
    (l_micro, m_micro), g_micro = out[2]
    assert float(l_micro) == pytest.approx(float(l_whole), rel=1e-6)
    assert float(m_micro["loss"]) == pytest.approx(float(l_whole), rel=1e-6)
    for a, b in zip(tree_leaves(g_micro), tree_leaves(g_whole)):
        assert a.dtype == torch.float32
        assert rel_l2(a, b) < MICRO_REL_L2


def test_cross_entropy_masks_padded_vocab():
    """The padded columns get no mass (as the reference), and leaving the
    mask out (a planted fault) moves the loss."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 512)).astype(np.float32) * 3
    labels = rng.integers(0, 500, (2, 5)).astype(np.int32)
    want = float(JT.cross_entropy(jax.numpy.asarray(logits),
                                  jax.numpy.asarray(labels), 500))
    got = float(TT.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels), 500))
    unmasked = float(TT.cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels), 512))
    assert got == pytest.approx(want, rel=1e-6)
    assert abs(unmasked - want) > 1e-3


def test_prefill_and_decode_steps():
    """``launch/steps``: the prefill step's logits are the forward's last
    position (within f32: a one-row head product), and the decode step's
    token is the argmax of its logits."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    _, cfg = _cfgs("llama3.2-3b")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(2), "cpu")
    batch = synthetic_batch(cfg, batch=2, seq=8, step=0, device="cpu")
    last = make_prefill_step(model)(params, batch)
    torch.testing.assert_close(
        last, model.apply(params, batch["tokens"])[:, -1, :], rtol=1e-5,
        atol=1e-6)
    cache = model.init_cache(2, 16, "cpu")
    tok, logits, cache = make_decode_step(model)(params, cache,
                                                 batch["tokens"][:, :1])
    assert tok.shape == (2, 1) and tok.dtype == torch.int32
    assert torch.equal(tok[:, 0].long(), logits[:, -1].argmax(-1))
    assert int(cache.pos) == 1



def _bf16_runs(over: dict, steps: int, seq: int, lr: float = 1e-3):
    """The launcher's run (warmup 3, no remat, f32 moments) of a bf16 llama
    for ``steps`` steps of 4 x ``seq`` from one JAX init in both packages.
    Returns the init's leaves and each package's leaves after the run (f32),
    each package's step losses, and the init's loss on each step's batch
    (what an lr=0 run reports: its params never move)."""
    from repro.configs.base import RunConfig as JRunConfig
    from repro.launch.steps import make_optimizer as jmake_optimizer
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16", **over) for c in (
        jget_config("llama3.2-3b", smoke=True),
        get_config("llama3.2-3b", smoke=True)))
    jmodel, model = jbuild(jcfg), build(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    first = from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    params = from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    kw = dict(steps=steps, learning_rate=lr, warmup_steps=3, remat=False)
    jopt, opt = jmake_optimizer(JRunConfig(**kw)), make_optimizer(
        RunConfig(**kw))
    jstep = jax.jit(JT.make_train_step(jmodel, jopt, JRunConfig(**kw)))
    step, eval_step = (TT.make_train_step(model, opt, RunConfig(**kw)),
                       TT.make_eval_step(model))
    jstate, state = jopt.init(jparams), opt.init(params)
    losses, jlosses, init_losses = [], [], []
    for i in range(steps):
        jparams, jstate, jm = jstep(
            jparams, jstate, jsynthetic_batch(jcfg, batch=4, seq=seq, step=i))
        b = synthetic_batch(cfg, batch=4, seq=seq, step=i, device="cpu")
        init_losses.append(float(eval_step(first, b)["loss"]))
        params, state, m = step(params, state, b)
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
    leaves = lambda t: [x.float() for x in tree_leaves(t)]
    return (leaves(first), leaves(params),
            leaves(from_jax(jax.tree.map(np.asarray, jparams), "cpu")),
            losses, jlosses, init_losses)


def test_bf16_train_steps_match_reference():
    """Three bf16 steps (the dtype the card trains in) from one init: each
    loss within BF16_LOSS_RTOL of the JAX step's, and each leaf's change
    (new - init) within BF16_UPDATE_REL_L2 relative L2 of the JAX change.
    Readings: the port against JAX at most ~0.08 (the two packages round
    their bf16 intermediates at other points), the port against itself with
    each batch's rows reversed at most ~0.02; the planted faults, an update
    not applied and an update of the wrong sign, put the changes at 1 and 2.
    The norm scales (1.0 in bf16, an ulp of 2^-7) take no update of lr 1e-3
    in either package."""
    init, got, want, losses, jlosses, _ = _bf16_runs({}, steps=3, seq=32)
    for a, b in zip(losses, jlosses):
        assert a == pytest.approx(b, rel=BF16_LOSS_RTOL)
    errs = [rel_l2(g - i, w - i) for i, g, w in zip(init, got, want)]
    moved = [float((w - i).norm()) > 0 for i, w in zip(init, want)]
    print(f"bf16 steps: losses {losses} vs {jlosses}; worst leaf change "
          f"{max(errs):.3g}; {sum(moved)} of {len(moved)} leaves moved")
    assert max(errs) < BF16_UPDATE_REL_L2
    for fault in (lambda i, g: i, lambda i, g: 2 * i - g):
        worst = max(rel_l2(fault(i, g) - i, w - i)
                    for i, g, w, mv in zip(init, got, want, moved) if mv)
        assert worst > BF16_UPDATE_REL_L2


def test_bf16_training_at_full_width_tracks_reference():
    """FULL llama's d_model (3072, 24 / 8 heads; one layer, d_ff 256, vocab
    2048, so the init's logits have FULL's spread, 0.02 x sqrt(3072)):
    eight bf16 steps in both packages. Every step's loss within
    BF16_TRAJECTORY_ATOL of the JAX step's, and the last four steps below
    the init's loss on the same batches (an update not applied leaves them
    equal, one of the wrong sign puts them above). Reading: the two
    packages' losses within ~0.003 of each other."""
    over = dict(d_model=3072, num_heads=24, num_kv_heads=8, d_ff=256,
                num_layers=1, vocab_size=2048)
    _, _, _, losses, jlosses, init_losses = _bf16_runs(over, steps=8, seq=32)
    print(f"full width: port {losses}\n  jax {jlosses}\n  init "
          f"{init_losses}")
    assert max(abs(a - b) for a, b in zip(losses, jlosses)) \
        < BF16_TRAJECTORY_ATOL
    assert all(a < b for a, b in zip(losses[-4:], init_losses[-4:]))
