"""The port's Mamba2 block and SSM family (mamba2) against the JAX reference
on numpy-seeded inputs and the mamba2 SMOKE config (2 layers, d_model 128):

* ``_causal_conv``, ``_gated_rms_norm``, ``ssm_block`` and
  ``ssm_decode_step`` (f32 1e-5, bf16 2e-2) and ``_ssd_chunked`` at chunks
  of 8, 16 and 32 (1e-4, as tests/test_attention_ssm.py:87);
* the SSM LM's forward and teacher-forced decode steps (1e-4 f32), and
  the decode steps against the port's own forward (the reference's
  "decode matches forward" property);
* ``select_snapshot`` against the reference, to the bit;
* ``spec_verify`` (logits 1e-4) and ``spec_commit`` at committed = 0..K+1
  and a mixed vector: the port's commit of the reference's snapshots
  equals the reference's commit to the bit, and the port's own verify and
  commit equal ``committed`` of its own decode steps to the bit;
* speculative serving on a briefly trained fixture (untrained weights
  have greedy near-ties) with the ngram draft and the int4 self-draft:
  greedy tokens, logprobs within 1e-2 and the draft counts
  (``draft_proposed``, ``draft_accepted``, ``spec_rounds``) equal to the
  JAX engine's, the tokens equal to the port's non-spec engine's;
* the plan compiler on the SSM layout and the bridge round trip.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig
from repro.configs.registry import get_config as jget_config
from repro.models import ssm as JS
from repro.models import ssm_lm as JLM
from repro.models.common import select_snapshot as jselect_snapshot
from repro.models.model import build as jbuild
from repro.quant.compiler import compile_plan as jcompile_plan
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.quantized import explicit_plan as jexplicit_plan
from repro.serving.scheduler import Request as JRequest
from repro.serving.spec import SpecConfig as JSpecConfig
from repro.train.loop import train
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.models import ssm as TS
from repro_torch.models import ssm_lm as TLM
from repro_torch.models.common import select_snapshot
from repro_torch.models.model import build
from repro_torch.quant.apply import SegmentedParams
from repro_torch.quant.qtypes import QTensor
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.quantized import explicit_plan
from repro_torch.serving.scheduler import Request
from repro_torch.serving.spec import SpecConfig

torch.set_num_threads(2)

B, L, K = 2, 12, 4
TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(dtype="float32", arch="mamba2-780m"):
    return (dataclasses.replace(jget_config(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


@pytest.fixture(scope="module")
def mamba():
    jcfg, tcfg = _cfgs()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(4))
    return jcfg, tcfg, jmodel, jparams, build(tcfg), from_jax(
        _np(jparams), device="cpu")


def _layer(jparams, dtype):
    """Layer 0 of the stack, cast to ``dtype`` (JAX, port)."""
    jp = jax.tree.map(lambda x: x[0], jparams["layers"])
    jp = {k: (v if v.dtype == jnp.float32 and k in ("A_log", "D", "dt_bias")
              else v.astype(dtype)) for k, v in jp.items()}
    return jp, from_jax(_np(jp), device="cpu")


# ---------------------------------------------------------------------------
# the block's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_and_gated_norm_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, L, 24)).astype(np.float32)
    w = rng.standard_normal((24, 4)).astype(np.float32) * 0.5
    b = rng.standard_normal((24,)).astype(np.float32) * 0.1
    jx, jw, jb = (jnp.asarray(a).astype(dtype) for a in (x, w, b))
    tx, tw, tb = (from_jax(np.asarray(a), device="cpu") for a in (jx, jw, jb))
    np.testing.assert_allclose(
        TS._causal_conv(tx, tw, tb).float().numpy(),
        _f32(JS._causal_conv(jx, jw, jb)), **TOLS[dtype])
    z = jnp.asarray(rng.standard_normal((B, L, 24)), dtype)
    nw = jnp.asarray(1.0 + 0.1 * rng.standard_normal((24,)), dtype)
    tz, tnw = (from_jax(np.asarray(a), device="cpu") for a in (z, nw))
    np.testing.assert_allclose(
        TS._gated_rms_norm(tx, tz, tnw).float().numpy(),
        _f32(JS._gated_rms_norm(jx, z, nw)), **TOLS[dtype])


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_chunked_matches_reference(chunk):
    bsz, l, h, p, n = 2, 32, 3, 4, 8
    rng = np.random.default_rng(chunk)
    x = rng.standard_normal((bsz, l, h, p)).astype(np.float32) * 0.5
    a = -np.abs(rng.standard_normal((bsz, l, h))).astype(np.float32) * 0.3
    bm = rng.standard_normal((bsz, l, h, n)).astype(np.float32) * 0.5
    cm = rng.standard_normal((bsz, l, h, n)).astype(np.float32) * 0.5
    jy, jfinal = JS._ssd_chunked(*(jnp.asarray(v) for v in (x, a, bm, cm)),
                                 chunk)
    ty, tfinal = TS._ssd_chunked(*(torch.from_numpy(v)
                                   for v in (x, a, bm, cm)), chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_and_decode_step_match_reference(mamba, dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _layer(mamba[3], dtype)
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.standard_normal((B, 16, jcfg.d_model)) * 0.5, dtype)
    tu = from_jax(np.asarray(u), device="cpu")
    np.testing.assert_allclose(
        TS.ssm_block(tp, tu, tcfg).float().numpy(),
        _f32(JS.ssm_block(jp, u, jcfg)), **TOLS[dtype])
    # one decode step from a non-zero cache; conv and state in place
    jcache = JS.SSMCache(
        conv=jnp.asarray(rng.standard_normal(
            (B, jcfg.ssm_conv - 1, TS.conv_dim(tcfg))) * 0.3, dtype),
        state=jnp.asarray(rng.standard_normal(
            (B, jcfg.ssm_nheads, jcfg.ssm_headdim, jcfg.ssm_state)) * 0.3,
            jnp.float32))
    tcache = from_jax(_np(jcache), device="cpu")
    tcache = TS.SSMCache(*tcache)
    jy, jnew = JS.ssm_decode_step(jp, u[:, 0], jcache, jcfg)
    ty = TS.ssm_decode_step(tp, tu[:, 0], tcache, tcfg)
    np.testing.assert_allclose(ty.float().numpy(), _f32(jy), **TOLS[dtype])
    np.testing.assert_allclose(tcache.conv.float().numpy(), _f32(jnew.conv),
                               **TOLS[dtype])
    np.testing.assert_allclose(tcache.state.numpy(), np.asarray(jnew.state),
                               **TOLS[dtype])
    assert tcache.state.dtype == torch.float32


# ---------------------------------------------------------------------------
# the SSM LM
# ---------------------------------------------------------------------------

def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def test_apply_and_decode_steps_match_reference(mamba):
    """Forward logits and teacher-forced decode steps (a slotted cache with
    a per-slot position) against the reference, and the port's decode
    steps against its own forward."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = mamba
    toks = _tokens(jcfg, 2, (B, L))
    jlog, _ = jmodel.apply(jparams, {"tokens": jnp.asarray(toks)})
    tlog = tmodel.apply(tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    jcache = jmodel.slotted_cache(B, 32)
    tcache = tmodel.slotted_cache(B, 32, "cpu")
    for t in range(L):
        jl, jcache = jmodel.decode_step(jparams, jcache,
                                        jnp.asarray(toks[:, t:t + 1]))
        tl, tcache = tmodel.decode_step(tparams, tcache,
                                        torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(tl[:, 0].numpy(), tlog[:, t].numpy(),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tcache.state.numpy(),
                               np.asarray(jcache.state), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))


def test_select_snapshot_matches_reference_bitwise():
    rng = np.random.default_rng(3)
    snaps = rng.standard_normal((K + 2, 3, B + 1, 5, 4)).astype(np.float32)
    for idx in ([0, 1, 5], [5, 5, 5], [2, 0, 3]):
        want = np.asarray(jselect_snapshot(jnp.asarray(snaps),
                                           jnp.asarray(idx, jnp.int32)))
        got = select_snapshot(torch.from_numpy(snaps),
                              torch.tensor(idx)).numpy()
        np.testing.assert_array_equal(got, want)
    # another batch axis
    want = np.asarray(jselect_snapshot(jnp.asarray(snaps),
                                       jnp.asarray([1, 4, 0, 2, 3]), 3))
    got = select_snapshot(torch.from_numpy(snaps), torch.tensor([1, 4, 0, 2,
                                                                  3]), 3)
    np.testing.assert_array_equal(got.numpy(), want)


def _prefilled(mamba):
    """Both models' slotted caches after a few teacher-forced steps."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = mamba
    toks = _tokens(jcfg, 5, (B, 6))
    jcache = jmodel.slotted_cache(B, 32)
    tcache = tmodel.slotted_cache(B, 32, "cpu")
    for t in range(toks.shape[1]):
        _, jcache = jmodel.decode_step(jparams, jcache,
                                       jnp.asarray(toks[:, t:t + 1]))
        _, tcache = tmodel.decode_step(tparams, tcache,
                                       torch.from_numpy(toks[:, t:t + 1]))
    return jcache, tcache


@pytest.mark.parametrize("committed", [[c, c] for c in range(K + 2)]
                         + [[0, K + 1], [3, 1]])
def test_spec_verify_and_commit_match_reference(mamba, committed):
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = mamba
    jcache, tcache = _prefilled(mamba)
    window = _tokens(jcfg, 6, (B, K + 1))
    jlog, jsnap = JLM.spec_verify(jparams, jcache, jnp.asarray(window), jcfg)
    start = TLM.SSMLMCache(*(t.clone() for t in tcache))
    tlog, tsnap = tmodel.spec_verify(tparams, tcache,
                                     torch.from_numpy(window))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    c = np.asarray(committed, np.int32)
    jout = JLM.spec_commit(jsnap, jnp.asarray(c))
    # the reference's snapshots, committed by the port: to the bit
    snap = from_jax(_np(jsnap), device="cpu")
    got = tmodel.spec_commit(snap, torch.from_numpy(c))
    for name in ("conv", "state", "pos"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(jout, name)))
    # the port's own commit equals its own decode steps, to the bit
    mine = tmodel.spec_commit(tsnap, torch.from_numpy(c).long())
    ref = TLM.SSMLMCache(*(t.clone() for t in start))   # steps in place
    for j in range(K + 1):
        _, ref = tmodel.decode_step(tparams, ref,
                                    torch.from_numpy(window[:, j:j + 1]))
        for b in range(B):
            if c[b] == j + 1:
                assert torch.equal(mine.state[:, b], ref.state[:, b])
                assert torch.equal(mine.conv[:, b], ref.conv[:, b])
    for b in range(B):
        if c[b] == 0:
            assert torch.equal(mine.state[:, b], start.state[:, b])
    np.testing.assert_array_equal(mine.pos.numpy(), start.pos.numpy() + c)


# ---------------------------------------------------------------------------
# speculative serving on a trained fixture
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained():
    """The SSM SMOKE model trained briefly (f32, 30 steps, lr 3e-3, batch
    8, seq 16), as tests/test_torch_hybrid.py trains its fixture."""
    jcfg, tcfg = _cfgs()
    run = RunConfig(steps=30, learning_rate=3e-3, warmup_steps=3,
                    remat=False)
    res = train(jcfg, run, batch=8, seq=16)
    return jcfg, tcfg, res["model"], res["params"], build(tcfg), from_jax(
        _np(res["params"]), device="cpu")


def _serve_requests(cfg):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (9, 12, 10, 14)]
    return ([JRequest(rid=i, prompt=p, max_new_tokens=8, arrival_step=2 * i)
             for i, p in enumerate(prompts)],
            [Request(rid=i, prompt=p, max_new_tokens=8, arrival_step=2 * i)
             for i, p in enumerate(prompts)])


@pytest.mark.parametrize("source", ["ngram", "model"])
def test_spec_serve_matches_reference(trained, source):
    """k = 3, int8 KV (the family has none: conv/state only), two-pass
    propose: tokens, logprobs and the draft counts of the JAX spec engine;
    tokens of the port's non-spec engine."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = trained
    spec = dict(k=3, draft_source=source)
    jeng = JServeEngine(jmodel, jparams, max_seq=40, kv_precision="int8",
                        autotune=False, spec=JSpecConfig(**spec))
    teng = ServeEngine(tmodel, tparams, max_seq=40, kv_precision="int8",
                       device="cpu", spec=SpecConfig(**spec))
    jreqs, treqs = _serve_requests(jcfg)
    jouts, jstats = jeng.serve(jreqs, num_slots=2, chunk=3)
    touts, stats = teng.serve(treqs, num_slots=2, chunk=3)
    assert [o.rid for o in touts] == [o.rid for o in jouts]
    for t, j in zip(touts, jouts):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        np.testing.assert_allclose(t.logprobs, np.asarray(j.logprobs),
                                   atol=1e-2)
    assert stats.spec_rounds > 0 and stats.draft_proposed > 0
    assert ((stats.draft_proposed, stats.draft_accepted, stats.spec_rounds)
            == (jstats.draft_proposed, jstats.draft_accepted,
                jstats.spec_rounds))
    plain, _ = ServeEngine(tmodel, tparams, max_seq=40, kv_precision="int8",
                           device="cpu").serve(_serve_requests(jcfg)[1],
                                               num_slots=2, chunk=3)
    for s, p in zip(touts, plain):
        np.testing.assert_array_equal(s.tokens, p.tokens)


def test_compile_plan_on_ssm_layout_matches_reference(mamba):
    """An explicit mixed plan compiles to the reference's segments with
    payloads and scales equal to the bit."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = mamba
    precs = ["int8", "int4"]
    jcp = jcompile_plan(jmodel, jparams, jexplicit_plan(jcfg, precs))
    tcp = tmodel.compile_plan(tparams, explicit_plan(tcfg, precs))
    jl, tl = jcp.params["layers"], tcp.params["layers"]
    assert isinstance(tl, SegmentedParams)
    assert ([(s.precision, s.start, s.stop) for s in tl.segments]
            == [(s.precision, s.start, s.stop) for s in jl.segments])
    for js, ts in zip(jl.segments, tl.segments):
        for name in ("w_in", "w_out"):
            jq, tq = js.params[name], ts.params[name]
            assert isinstance(tq, QTensor)
            np.testing.assert_array_equal(tq.data.numpy(),
                                          np.asarray(jq.data))
            np.testing.assert_array_equal(
                tq.scale.float().numpy(),
                np.asarray(jq.scale.astype(jnp.float32)))
    toks = _tokens(jcfg, 7, (B, 8))
    np.testing.assert_allclose(
        tmodel.apply(tcp.params, torch.from_numpy(toks)).numpy(),
        np.asarray(jmodel.apply(jcp.params, {"tokens": jnp.asarray(toks)})[0]),
        rtol=1e-4, atol=1e-4)
    assert tcp.kv_plan is None


def test_bridge_round_trip(mamba):
    """Params and a slotted cache carry over bit for bit, as the port's
    own types."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = mamba
    for k in ("w_in", "conv_w", "A_log", "dt_bias", "norm_w", "w_out", "ln"):
        np.testing.assert_array_equal(
            tparams["layers"][k].float().numpy(),
            _f32(jparams["layers"][k]))
    jcache, _ = _prefilled(mamba)
    tcache = from_jax(_np(jcache), device="cpu")
    assert isinstance(tcache, TLM.SSMLMCache)
    np.testing.assert_array_equal(tcache.state.numpy(),
                                  np.asarray(jcache.state))
    assert tcache.pos.dtype == torch.int32


def test_init_matches_reference_layout(mamba):
    """Seeded port init: the reference's tree, shapes and dtypes."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = mamba
    mine = tmodel.init(torch.Generator().manual_seed(0), "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat:
        node = mine
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape, path
    np.testing.assert_allclose(mine["layers"]["A_log"].numpy(),
                               np.asarray(jparams["layers"]["A_log"]),
                               rtol=1e-6)
    np.testing.assert_allclose(mine["layers"]["dt_bias"].numpy(),
                               np.asarray(jparams["layers"]["dt_bias"]),
                               rtol=1e-6)
