"""The port's encoder-decoder family (whisper) against the JAX reference on
the whisper SMOKE config (2 + 2 layers, d_model 128, f32):

* the gelu form of the fused MLP (plain version) against
  ``qmlp_pallas(act="gelu")`` in interpret mode (3e-2, as
  tests/test_megakernels.py:60-75) and against the reference's unfused
  sequence (1e-5);
* ``encode`` and ``precompute_cross_kv`` (1e-4);
* decode steps teacher-forced with the reference's greedy tokens, over a
  raw cache (logits 1e-4) and int8 / int4 self and cross caches (log-probs
  1e-2, as an int8 against a bf16 cache in README.md);
* cross-attention over int8 and int4 pages against the reference's
  ``decode_attention(causal=False)`` (1e-5);
* the full forward on compiled EWQ and explicit plans (1e-4);
* ``ServeEngine.serve`` with frames against the reference engine's
  log-probs (1e-4 raw cache, 1e-2 int8 cache) on each request's generated
  tokens up to the first token where the two greedy paths part (untrained
  weights have near-ties; ROADMAP.md);
* the bridge carrying enc-dec params and caches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core.planner import plan_model as jplan_model
from repro.kernels.decode_attn.ops import decode_attention as jdecode
from repro.kernels.qmatmul.kernel import qmlp_pallas
from repro.kernels.qmatmul.ops import fused_mlp as jfused_mlp
from repro.models import encdec as JED
from repro.models.model import build as jbuild
from repro.quant import kvcache as JKV
from repro.quant.apply import segment_slices as jsegment_slices
from repro.quant.compiler import compile_kv_plan as jcompile_kv_plan
from repro.quant.compiler import compile_plan as jcompile_plan
from repro.quant.quantize import quantize as jquantize
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.quantized import explicit_plan as jexplicit_plan
from repro.serving.scheduler import Request as JRequest
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.core.planner import plan_model
from repro_torch.kernels.decode_attn import ops as TDA
from repro_torch.kernels.qmatmul.ops import fused_mlp
from repro_torch.models import encdec as TED
from repro_torch.models.model import build
from repro_torch.quant.apply import SegmentedParams, segment_slices
from repro_torch.quant.compiler import compile_kv_plan
from repro_torch.quant.kvcache import KVPage, quantize_model_cache
from repro_torch.quant.qtypes import QTensor
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.quantized import explicit_plan
from repro_torch.serving.scheduler import Request
from repro_torch.serving.spec import SpecConfig

torch.set_num_threads(2)

B, P, STEPS, MAX_SEQ = 2, 6, 6, 24
EXPLICIT = ["raw", "int8", "int4", "ternary"]   # 2 encoder + 2 decoder layers


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def whisper():
    jcfg = dataclasses.replace(jget_config("whisper-medium", smoke=True),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("whisper-medium", smoke=True),
                               dtype="float32")
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(2))
    tparams = from_jax(_np(jparams), device="cpu")
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((B, jcfg.encoder_seq, jcfg.d_model)
                                 ).astype(np.float32)
    return jcfg, tcfg, jmodel, jparams, build(tcfg), tparams, frames


def _plans(name, whisper):
    jcfg, tcfg, jmodel, jparams, tmodel, tparams, _ = whisper
    if name == "raw":
        return None, None
    if name == "explicit":
        return jexplicit_plan(jcfg, EXPLICIT), explicit_plan(tcfg, EXPLICIT)
    return (jplan_model(jmodel, jparams, variant=name),
            plan_model(tmodel, tparams, variant=name))


# ---------------------------------------------------------------------------
# the gelu form of the fused MLP
# ---------------------------------------------------------------------------

def _mlp_weight(rng, n, k, precision, exact, group=64):
    """Random weights, or (``exact``) levels times a power-of-two scale with
    the largest level in every group: the group scale is then a power of
    two and the plain version's bf16 dequantization is exact, so it can be
    held to the Pallas kernel's f32 dequantization (as in
    tests/test_torch_qmatmul.py)."""
    if not exact:
        w = rng.standard_normal((n, k)) * 0.2
    else:
        qmax = {"int8": 127, "int4": 7, "ternary": 1}[precision]
        lv = (rng.choice([-1, 1], size=(n, k)) if precision == "ternary"
              else rng.integers(-qmax, qmax + 1, size=(n, k)))
        lv[:, ::group] = qmax
        step = {"int8": 2.0 ** -11, "int4": 2.0 ** -7, "ternary": 2.0 ** -5}
        w = lv * step[precision]
    return jquantize(jnp.asarray(w, jnp.float32), precision, group)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("precision", ["int8", "int4", "ternary"])
def test_gelu_fused_mlp_matches_reference(precision, exact):
    """Against the reference's unfused sequence, which the plain version
    mirrors (1e-5), and, on exact-scale weights, against the interpreted
    Pallas kernel (3e-2)."""
    rng = np.random.default_rng(7)
    k, ff, d = 256, 512, 256
    wu = _mlp_weight(rng, ff, k, precision, exact)
    wd = _mlp_weight(rng, d, ff, precision, exact)
    x = (rng.standard_normal((128, k)) * 0.5).astype(np.float32)
    got = fused_mlp(torch.from_numpy(x), None,
                    from_jax(_np(wu), device="cpu"),
                    from_jax(_np(wd), device="cpu"), act="gelu").numpy()
    unfused = jfused_mlp(jnp.asarray(x), None, wu, wd, act="gelu")
    np.testing.assert_allclose(got, np.asarray(unfused), rtol=1e-5,
                               atol=1e-5)
    if exact:
        pallas = qmlp_pallas(jnp.asarray(x), None, None, wu.data, wu.scale,
                             wd.data, wd.scale, group=wu.group,
                             precision=precision, act="gelu", bm=128, bf=256,
                             interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), rtol=3e-2,
                                   atol=3e-2)


def test_fused_mlp_refuses_a_gate_mismatch():
    w = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="gelu"):
        fused_mlp(torch.zeros(1, 8), w, w, w, act="gelu")


# ---------------------------------------------------------------------------
# encoder, cross K/V, decode steps
# ---------------------------------------------------------------------------

def test_encode_and_cross_kv_match_reference(whisper):
    jcfg, tcfg, _, jparams, _, tparams, frames = whisper
    jenc = JED.encode(jparams, jnp.asarray(frames), jcfg, remat=False)
    tenc = TED.encode(tparams, torch.from_numpy(frames), tcfg)
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), rtol=1e-4,
                               atol=1e-4)
    jk, jv = JED.precompute_cross_kv(jparams, jenc, jcfg)
    tk, tv = TED.precompute_cross_kv(tparams, tenc, tcfg)
    assert tuple(tk.shape) == jk.shape == (jcfg.num_layers, B,
                                           jcfg.encoder_seq,
                                           jcfg.num_kv_heads, jcfg.head_dim)
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


def _caches(whisper, jp, tp, jplan, tplan, kv):
    """Both frameworks' slotted caches after encoding the frames: cross K/V
    in place, pos 0 per slot, quantized per the KV plan."""
    jcfg, tcfg, _, _, _, _, frames = whisper
    jenc = JED.encode(jp, jnp.asarray(frames), jcfg, remat=False)
    jck, jcv = JED.precompute_cross_kv(jp, jenc, jcfg)
    jcache = JED.init_cache(jcfg, B, MAX_SEQ)._replace(
        cross_k=jck, cross_v=jcv, pos=jnp.zeros((B,), jnp.int32))
    tenc = TED.encode(tp, torch.from_numpy(frames), tcfg)
    tck, tcv = TED.precompute_cross_kv(tp, tenc, tcfg)
    tcache = TED.init_cache(tcfg, B, MAX_SEQ, "cpu")._replace(
        cross_k=tck, cross_v=tcv, pos=torch.zeros((B,), dtype=torch.int32))
    if kv != "bf16":
        jkv = jcompile_kv_plan(jcfg, jplan, kv)
        tkv = compile_kv_plan(tcfg, tplan, kv)
        assert tkv.to_dict() == jkv.to_dict()
        jcuts = tuple(lo for _, lo, _ in jsegment_slices(jp["dec_layers"])[1:])
        tcuts = tuple(lo for _, lo, _ in segment_slices(tp["dec_layers"])[1:])
        assert tcuts == jcuts
        jcache = JKV.quantize_model_cache(jcache, jkv, jcuts,
                                          JED.KV_CACHE_FIELDS)
        tcache = quantize_model_cache(tcache, tkv, tcuts,
                                      TED.KV_CACHE_FIELDS)
    return jcache, tcache


@pytest.mark.parametrize("plan_name,kv", [("raw", "bf16"), ("raw", "int8"),
                                          ("4bit/8bit", "int8"),
                                          ("explicit", "int4")])
def test_decode_steps_match_reference(whisper, plan_name, kv):
    jcfg, tcfg, jmodel, jparams, tmodel, tparams, _ = whisper
    jplan, tplan = _plans(plan_name, whisper)
    if jplan is not None:
        assert tplan.precisions() == jplan.precisions()
        jp = jcompile_plan(jmodel, jparams, jplan).params
        tp = tmodel.compile_plan(tparams, tplan).params
    else:
        jp, tp = jparams, tparams
    jcache, tcache = _caches(whisper, jp, tp, jplan, tplan, kv)
    step = jax.jit(lambda p, c, t: JED.decode_step(p, c, t, jcfg))
    tok = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
    for _ in range(STEPS):
        jl, jcache = step(jp, jcache, jnp.asarray(tok))
        tl, tcache = TED.decode_step(tp, tcache, torch.from_numpy(tok).long(),
                                     tcfg)
        jl, tl = np.asarray(jl), tl.numpy()
        if kv == "bf16":
            np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_allclose(
                torch.log_softmax(torch.from_numpy(tl), -1).numpy(),
                np.asarray(jax.nn.log_softmax(jl, -1)), atol=1e-2)
        # teacher-forced with the reference's greedy tokens
        tok = np.argmax(jl[:, -1, :jcfg.vocab_size], -1)[:, None].astype(
            np.int32)
    assert tcache.pos.tolist() == np.asarray(jcache.pos).tolist()


@pytest.mark.parametrize("precision", ["int8", "int4"])
@pytest.mark.parametrize("s", [1, 3])
def test_cross_attention_pages_match_reference(precision, s):
    b, t, hkv, hd, group = 3, 40, 4, 32, 32
    rng = np.random.default_rng(s)
    q = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, t, hkv, hd)).astype(np.float32)
            for _ in range(2))
    jk, jv = (JKV.make_page(jnp.asarray(a), precision, group) for a in (k, v))
    tk, tv = (from_jax(_np(p), device="cpu") for p in (jk, jv))
    got = TDA.decode_attention(torch.from_numpy(q), tk, tv,
                               causal=False).numpy()
    for backend in ("grouped", "simple"):
        want = jdecode(jnp.asarray(q), jk, jv, causal=False, backend=backend,
                       kv_chunk=16)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("plan_name", ["raw", "4bit/8bit", "explicit"])
def test_compiled_plan_apply_matches_reference(whisper, plan_name):
    jcfg, tcfg, jmodel, jparams, tmodel, tparams, frames = whisper
    jplan, tplan = _plans(plan_name, whisper)
    if jplan is not None:
        assert tplan.precisions() == jplan.precisions()
        jp = jcompile_plan(jmodel, jparams, jplan).params
        tp = tmodel.compile_plan(tparams, tplan).params
        assert isinstance(tp["enc_layers"], SegmentedParams)
        assert isinstance(tp["dec_layers"], SegmentedParams)
        for key in ("enc_layers", "dec_layers"):
            assert ([sg.precision for sg in tp[key].segments]
                    == [sg.precision for sg in jp[key].segments])
    else:
        jp, tp = jparams, tparams
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, size=(B, P)).astype(np.int32)
    jl, _ = jmodel.apply(jp, {"tokens": jnp.asarray(toks),
                              "frames": jnp.asarray(frames)}, remat=False)
    tl = tmodel.apply(tp, torch.from_numpy(toks).long(),
                      frames=torch.from_numpy(frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    tlast = tmodel.apply(tp, torch.from_numpy(toks).long(),
                         frames=torch.from_numpy(frames), last_only=True)
    np.testing.assert_allclose(tlast.numpy(), tl.numpy()[:, -1:], rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _requests(cfg, cls):
    rng = np.random.default_rng(6)
    out = []
    for i, plen in enumerate((4, 7, 5, 9)):
        out.append(cls(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, size=(plen,)
                                       ).astype(np.int32),
            max_new_tokens=6, arrival_step=2 * i,
            frames=rng.standard_normal((cfg.encoder_seq, cfg.d_model)
                                       ).astype(np.float32)))
    return out


@pytest.mark.parametrize("kv,atol", [("bf16", 1e-4), ("int8", 1e-2)])
def test_serve_with_frames_matches_reference(whisper, kv, atol):
    jcfg, tcfg, jmodel, jparams, tmodel, tparams, _ = whisper
    jplan, tplan = _plans("4bit/8bit", whisper)
    jeng = JServeEngine(jmodel, jparams, max_seq=MAX_SEQ, plan=jplan,
                        kv_precision=kv, autotune=False)
    teng = ServeEngine(tmodel, tparams, max_seq=MAX_SEQ, plan=tplan,
                       kv_precision=kv, device="cpu")
    assert teng.kv_bytes_per_slot() == jeng.kv_bytes_per_slot()
    assert teng.weight_bytes() == pytest.approx(jeng.weight_bytes())
    by_field = teng.kv_bytes_by_field()
    assert sorted(by_field) == sorted(TED.KV_CACHE_FIELDS)
    assert by_field["cross_k"] > 0 and by_field["k"] > 0
    jouts, _ = jeng.serve(_requests(jcfg, JRequest), num_slots=2, chunk=4)
    touts, stats = teng.serve(_requests(tcfg, Request), num_slots=2, chunk=4)
    assert stats.admissions > 0            # admissions while others decode
    assert [o.rid for o in touts] == [o.rid for o in jouts]
    compared = total = 0
    for t, j in zip(touts, jouts):
        jt, jl = np.asarray(j.tokens), np.asarray(j.logprobs)
        np.testing.assert_array_equal(t.tokens[:t.prompt_len],
                                      jt[:t.prompt_len])
        gen_t, gen_j = t.generated, jt[t.prompt_len:]
        assert len(gen_t) == len(gen_j) == 6
        same = np.cumprod(gen_t == gen_j).astype(bool)
        n = int(same.sum())
        # the log-prob of the first differing token is still over the same
        # context, so it is compared too
        upto = min(n + 1, len(gen_t))
        np.testing.assert_allclose(t.logprobs[:upto], jl[:upto], atol=atol)
        compared += n
        total += len(gen_t)
    assert compared >= total // 2, (compared, total)


def test_generate_with_frames_matches_serve(whisper):
    _, tcfg, _, _, tmodel, tparams, frames = whisper
    eng = ServeEngine(tmodel, tparams, max_seq=MAX_SEQ, kv_precision="int8",
                      device="cpu")
    prompts = np.random.default_rng(8).integers(
        0, tcfg.vocab_size, size=(B, P)).astype(np.int32)
    reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=5,
                    frames=frames[i]) for i in range(B)]
    outs, _ = eng.serve(reqs, num_slots=B, chunk=2)
    res = eng.generate(prompts, 5, chunk=2, frames=frames)
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(res.tokens[i].numpy(), o.tokens)


def test_engine_refuses_paged_and_spec_for_encdec(whisper):
    """The refusal is gone: an enc-dec engine builds over a paged pool and
    with speculative decoding, and each serves a request with frames to
    its non-spec dense tokens (held to the JAX engine in
    tests/test_torch_encdec_serve.py)."""
    _, tcfg, _, _, tmodel, tparams, frames = whisper
    prompt = np.random.default_rng(9).integers(
        0, tcfg.vocab_size, size=(P,)).astype(np.int32)
    outs = {}
    for name, kw in (("dense", {}), ("paged", dict(paged=True)),
                     ("spec", dict(spec=SpecConfig(k=2)))):
        eng = ServeEngine(tmodel, tparams, max_seq=MAX_SEQ, device="cpu",
                          kv_precision="int8", **kw)
        outs[name], _ = eng.serve([Request(rid=0, prompt=prompt,
                                           max_new_tokens=4,
                                           frames=frames[0])],
                                  num_slots=1, chunk=2)
        assert len(outs[name][0].generated) == 4
    for name in ("paged", "spec"):
        np.testing.assert_array_equal(outs[name][0].tokens,
                                      outs["dense"][0].tokens)


# ---------------------------------------------------------------------------
# bridge
# ---------------------------------------------------------------------------

def test_bridge_carries_encdec_params_and_cache(whisper):
    jcfg, _, jmodel, jparams, _, _, _ = whisper
    jplan = jexplicit_plan(jcfg, EXPLICIT)
    jp = jcompile_plan(jmodel, jparams, jplan).params
    tp = from_jax(_np(jp), device="cpu")
    for key in ("enc_layers", "dec_layers"):
        assert isinstance(tp[key], SegmentedParams)
        for jseg, tseg in zip(jp[key].segments, tp[key].segments):
            assert (tseg.precision, tseg.start, tseg.stop) == \
                (jseg.precision, jseg.start, jseg.stop)
        w = tp[key].segments[-1].params["mlp"]["w_up"]
        assert isinstance(w, QTensor)
        assert w.precision == jp[key].segments[-1].precision != "raw"
        np.testing.assert_array_equal(
            w.data.numpy(),
            np.asarray(jp[key].segments[-1].params["mlp"]["w_up"].data))
    assert "w_gate" not in tp["dec_layers"].segments[0].params["mlp"]
    jcache = JED.init_cache(jcfg, 1, 8)
    jkv = jcompile_kv_plan(jcfg, None, "int4")
    jcache = JKV.quantize_model_cache(jcache, jkv, (), JED.KV_CACHE_FIELDS)
    tcache = from_jax(_np(jcache), device="cpu")
    assert isinstance(tcache, TED.EncDecCache)
    for name in TED.KV_CACHE_FIELDS:
        page = getattr(tcache, name)
        assert isinstance(page, KVPage) and page.precision == "int4"
        np.testing.assert_array_equal(page.data.numpy(),
                                      np.asarray(getattr(jcache, name).data))
    assert tcache.cross_k.seq_len == jcfg.encoder_seq
