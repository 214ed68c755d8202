"""Decode chunks that a CUDA graph can replay, and prompts scored in one
multi-query step, in the port against the JAX package (SMOKE models, f32,
briefly trained so greedy tokens can be compared across frameworks):

* a decode chunk and a speculative chunk (dense, paged, enc-dec) write the
  decode state in place: every state tensor and cache field keeps its
  address, and the values are the JAX engine's after the same chunk;
* a prefix hit's suffix and a whisper prompt are each one ``decode_step``
  and match the JAX engine's chunked prefill (``begin_prefill`` +
  ``advance_prefill`` with a budget of the whole suffix);
* ``serving/graphs.py``'s bookkeeping with a stub graph: the first chunk of
  a key runs once and is then captured, later chunks replay, a new state
  drops the old graphs, replays credit the launches counted at capture,
  and an engine driven through it serves the eager engine's tokens;
* the ``-Xptxas -v`` parser of ``kernels/build.py``.

CUDA graphs themselves run only on the card (``chip_smoke.py`` holds graph
serves to eager serves to the bit there); here every engine is on the
CPU, where it always runs eagerly."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig
from repro.configs.registry import get_config as jget_config
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.pool import PagedConfig as JPagedConfig
from repro.serving.spec import SpecConfig as JSpecConfig
from repro.train.loop import train
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.kernels import build
from repro_torch.models.model import Model
from repro_torch.models.model import build as build_model
from repro_torch.serving import graphs as G
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.pool import PagedConfig
from repro_torch.serving.scheduler import Request
from repro_torch.serving.spec import SpecConfig, SpecMetrics

torch.set_num_threads(2)

MAX_SEQ = 32


def _train(arch: str):
    cfg = dataclasses.replace(jget_config(arch, smoke=True), dtype="float32")
    run = RunConfig(steps=40, learning_rate=3e-3, warmup_steps=3,
                    remat=False)
    res = train(cfg, run, batch=8, seq=16)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    tparams = from_jax(jax.tree.map(np.asarray, res["params"]), device="cpu")
    return cfg, res["model"], res["params"], tcfg, tparams


@pytest.fixture(scope="module")
def trained():
    """The dense and enc-dec SMOKE models trained as tests/conftest.py
    trains them (f32, 40 steps, lr 3e-3, batch 8, seq 16)."""
    return {"dense": _train("llama3.2-3b"), "encdec": _train("whisper-medium")}


def _prompts(vocab: int, n: int = 3) -> list:
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, size=(plen,)).astype(np.int32)
            for plen in (6, 9, 7)[:n]]


def _frames(cfg, n: int = 3) -> list:
    rng = np.random.default_rng(6)
    return [rng.standard_normal((cfg.encoder_seq, cfg.d_model))
            .astype(np.float32) for _ in range(n)]


def _state_tensors(state) -> dict:
    """Every tensor of a port decode state, the cache's fields (raw
    tensors, page data and scales, pool tables, pos) included."""
    out = {name: getattr(state, name) for name in (
        "last_logits", "tokens", "lengths", "max_len", "done", "active",
        "logprobs", "temperature", "top_k", "top_p")}
    for fname, field in zip(state.cache._fields, state.cache):
        for i, part in enumerate(field if isinstance(field, tuple)
                                 else (field,)):
            if isinstance(part, torch.Tensor):
                out[f"cache.{fname}.{i}"] = part
                continue
            for leaf in ("data", "scale", "table"):
                t = getattr(part, leaf, None)
                if t is not None:
                    out[f"cache.{fname}.{i}.{leaf}"] = t
    return out


CASES = {
    # name: (family, kv, paged, spec)
    "dense": ("dense", "bf16", False, None),
    "paged": ("dense", "int8", True, None),
    "encdec": ("encdec", "int8", False, None),
    "dense-spec": ("dense", "int8", False, dict(k=3)),
    "paged-spec": ("dense", "int8", True, dict(k=3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunks_write_the_state_in_place(trained, case):
    """Two decode chunks (or two chunks of spec rounds) over three
    admitted requests: every tensor of the state keeps its address (what
    a replayed graph needs), and tokens, lengths, done flags, logprobs and
    cache positions are the JAX engine's after the same chunks."""
    family, kv, paged, spec = CASES[case]
    _, jmodel, jparams, tcfg, tparams = trained[family]
    jeng = JServeEngine(jmodel, jparams, max_seq=MAX_SEQ, kv_precision=kv,
                        autotune=False,
                        paged=JPagedConfig(page_size=4) if paged else None,
                        spec=JSpecConfig(**spec) if spec else None)
    teng = ServeEngine(build_model(tcfg), tparams, max_seq=MAX_SEQ,
                       kv_precision=kv, device="cpu",
                       paged=PagedConfig(page_size=4) if paged else None,
                       spec=SpecConfig(**spec) if spec else None)
    prompts = _prompts(tcfg.vocab_size)
    frames = _frames(tcfg) if family == "encdec" else [None] * 3
    jstate = jeng.init_decode_state(4)
    tstate = teng.init_decode_state(4)
    for slot, (p, f) in enumerate(zip(prompts, frames)):
        jstate = jeng.insert(jstate, slot, jeng.prefill_request(
            p, frames=f, state=jstate), 10)
        teng.insert(tstate, slot, teng.prefill_request(p, tstate, frames=f),
                    10)
    before = {k: t.data_ptr() for k, t in _state_tensors(tstate).items()}
    cache = tstate.cache
    for _ in range(2):
        jout = jeng.decode_chunk(jstate, 3)
        jstate = jout[0] if spec else jout
        tout = teng.decode_chunk(tstate, 3)
        assert (tout[0] if spec else tout) is tstate
    after = {k: t.data_ptr() for k, t in _state_tensors(tstate).items()}
    assert after == before
    assert tstate.cache is cache
    np.testing.assert_array_equal(tstate.tokens.numpy(),
                                  np.asarray(jstate.tokens))
    for name in ("lengths", "done", "active"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)))
    np.testing.assert_array_equal(tstate.cache.pos.numpy(),
                                  np.asarray(jstate.cache.pos))
    np.testing.assert_allclose(tstate.logprobs.numpy(),
                               np.asarray(jstate.logprobs), atol=1e-2)


def _count_decode_steps(monkeypatch) -> list:
    """Wrap ``Model.decode_step``; returns the list of the token widths it
    is called with from then on."""
    calls = []
    inner = Model.decode_step

    def counting(self, params, cache, tokens, **kw):
        calls.append(tokens.shape[1])
        return inner(self, params, cache, tokens, **kw)

    monkeypatch.setattr(Model, "decode_step", counting)
    return calls


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_prefix_hit_suffix_is_one_step_like_chunked_reference(
        trained, monkeypatch, kv):
    """A prompt that shares 12 of its 16 tokens with an admitted one: the
    port scores the 4-token suffix in ONE decode step on the seeded cache,
    as the JAX engine's begin_prefill + advance_prefill (budget = the
    suffix) does; last logits and the tokens decoded after admission are
    the same."""
    jcfg, jmodel, jparams, tcfg, tparams = trained["dense"]
    rng = np.random.default_rng(99)
    prefix = rng.integers(0, tcfg.vocab_size, size=12)
    first, second = (np.concatenate(
        [prefix, rng.integers(0, tcfg.vocab_size, size=4)]).astype(np.int32)
        for _ in range(2))
    jeng = JServeEngine(jmodel, jparams, max_seq=24, kv_precision=kv,
                        autotune=False, paged=JPagedConfig(page_size=4))
    model = build_model(tcfg)
    teng = ServeEngine(model, tparams, max_seq=24, kv_precision=kv,
                       device="cpu", paged=PagedConfig(page_size=4))
    jstate = jeng.init_decode_state(2)
    tstate = teng.init_decode_state(2)
    jstate = jeng.insert(jstate, 0, jeng.prefill_request(first, state=jstate),
                         6)
    teng.insert(tstate, 0, teng.prefill_request(first, tstate), 6)
    calls = _count_decode_steps(monkeypatch)
    tpf = teng.prefill_request(second, tstate)
    assert tpf.match.hit == 12 and calls == [4]
    cp = jeng.begin_prefill(second, state=jstate)
    assert cp.pos == 12
    jeng.advance_prefill(cp, len(second) - cp.pos)
    assert cp.done
    np.testing.assert_allclose(
        torch.log_softmax(tpf.last_logits[:, :tcfg.vocab_size], -1).numpy(),
        np.asarray(jax.nn.log_softmax(cp.last_logits[:, :jcfg.vocab_size])),
        atol=1e-2)
    jstate = jeng.insert(jstate, 1, cp.as_prefill(), 6)
    teng.insert(tstate, 1, tpf, 6)
    jstate = jeng.decode_chunk(jstate, 6)
    teng.decode_chunk(tstate, 6)
    np.testing.assert_array_equal(tstate.tokens.numpy(),
                                  np.asarray(jstate.tokens))
    np.testing.assert_allclose(tstate.logprobs.numpy(),
                               np.asarray(jstate.logprobs), atol=1e-2)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_whisper_prompt_is_one_step_like_chunked_reference(
        trained, monkeypatch, kv):
    """Each whisper prompt (4-9 tokens) is one decode step after the
    encoder and the cross K/V, as the JAX engine's begin_prefill +
    advance_prefill with a budget of the whole prompt: the same last
    logits, and the same greedy tokens decoded from them."""
    jcfg, jmodel, jparams, tcfg, tparams = trained["encdec"]
    jeng = JServeEngine(jmodel, jparams, max_seq=MAX_SEQ, kv_precision=kv,
                        autotune=False)
    model = build_model(tcfg)
    teng = ServeEngine(model, tparams, max_seq=MAX_SEQ, kv_precision=kv,
                       device="cpu")
    prompts, frames = _prompts(tcfg.vocab_size), _frames(tcfg)
    calls = _count_decode_steps(monkeypatch)
    jstate = jeng.init_decode_state(3)
    tstate = teng.init_decode_state(3)
    for slot, (p, f) in enumerate(zip(prompts, frames)):
        tpf = teng.prefill_request(p, frames=f)
        assert calls[-1] == len(p)
        cp = jeng.begin_prefill(p, frames=f)
        jeng.advance_prefill(cp, len(p))
        np.testing.assert_allclose(
            torch.log_softmax(tpf.last_logits[:, :tcfg.vocab_size],
                              -1).numpy(),
            np.asarray(jax.nn.log_softmax(
                cp.last_logits[:, :jcfg.vocab_size])), atol=1e-4)
        jstate = jeng.insert(jstate, slot, cp.as_prefill(), 6)
        teng.insert(tstate, slot, tpf, 6)
    assert calls == [len(p) for p in prompts]   # one step per prompt
    jstate = jeng.decode_chunk(jstate, 6)
    teng.decode_chunk(tstate, 6)
    np.testing.assert_array_equal(tstate.tokens.numpy(),
                                  np.asarray(jstate.tokens))
    np.testing.assert_allclose(tstate.logprobs.numpy(),
                               np.asarray(jstate.logprobs), atol=1e-2)


# ---------------------------------------------------------------------------
# serving/graphs.py with a stub graph
# ---------------------------------------------------------------------------

class _Owner:
    """Stands in for a decode state (graphs are keyed to its identity)."""
    gen = None


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def launches(monkeypatch):
    counts = {k: 0 for k in build.LAUNCHES}
    monkeypatch.setattr(build, "LAUNCHES", counts)
    return counts


def _stub_graphs(log: list) -> G.ChunkGraphs:
    """ChunkGraphs whose capture runs the body's Python (as a real capture
    does; the kernels it would record are not run) into a stub graph."""
    def make_graph(body, pool, generators):
        log.append("capture")
        return _StubGraph(), body()

    def warm_run(body):
        log.append("run")
        return body()

    return G.ChunkGraphs(make_graph=make_graph, warm_run=warm_run)


def test_first_chunk_runs_once_then_replays(launches):
    log = []
    graphs = _stub_graphs(log)
    state = _Owner()
    body_calls = []

    def body():
        body_calls.append(1)
        return None

    graphs.run(state, "k", body)
    assert log == ["run", "capture"] and len(body_calls) == 2
    for _ in range(3):
        graphs.run(state, "k", body)
    assert log == ["run", "capture"] and len(body_calls) == 2
    assert graphs.graphs["k"].graph.replays == 3
    graphs.run(state, "other key", body)
    assert log == ["run", "capture"] * 2
    assert sorted(graphs.graphs) == ["k", "other key"]


def test_a_new_state_drops_the_old_graphs(launches):
    log = []
    graphs = _stub_graphs(log)
    first, second = _Owner(), _Owner()
    graphs.run(first, "k", lambda: None)
    graphs.run(second, "k", lambda: None)
    assert log == ["run", "capture"] * 2
    assert len(graphs.graphs) == 1
    graphs.run(second, "k", lambda: None)
    assert log == ["run", "capture"] * 2       # replayed


def test_replays_credit_the_launches_counted_at_capture(launches):
    """The wrappers count in Python, which runs at capture and not at
    replay: capture takes its counts back, each replay adds them."""
    graphs = _stub_graphs([])
    state = _Owner()

    def body():                 # as two kernel wrappers would count
        launches["qmatmul"] += 3
        launches["qkv"] += 2
        return None

    graphs.run(state, "k", body)               # the real run, then capture
    assert launches["qmatmul"] == 3 and launches["qkv"] == 2
    assert graphs.graphs["k"].launches == {"qmatmul": 3, "qkv": 2}
    graphs.run(state, "k", body)
    graphs.run(state, "k", body)
    assert launches["qmatmul"] == 9 and launches["qkv"] == 6
    assert sum(launches.values()) == 15


def test_replay_returns_copies_of_the_graph_outputs(launches):
    graphs = _stub_graphs([])
    state = _Owner()
    out = SpecMetrics(*(torch.tensor(i) for i in (1, 2, 3, 4)))
    graphs.run(state, "k", lambda: out)
    got = graphs.run(state, "k", lambda: out)
    assert isinstance(got, SpecMetrics)
    assert [int(t) for t in got] == [1, 2, 3, 4]
    assert all(a is not b for a, b in zip(got, out))
    out[0].fill_(5)                            # the next replay's write
    assert int(got[0]) == 1


def _emulated_graphs(state_of, keys: list) -> G.ChunkGraphs:
    """ChunkGraphs on the CPU that behave like CUDA graphs over an engine:
    capture runs the body on the live state and then restores every state
    tensor (and the generator), so the capture changes nothing; a replay
    runs the body again and writes its outputs into the captured ones."""
    class Replay:
        def __init__(self, body, outputs):
            self.body, self.outputs = body, outputs

        def replay(self):
            out = self.body()
            if out is not None:
                for dst, src in zip(self.outputs, out):
                    dst.copy_(src)

    def make_graph(body, pool, generators):
        state = state_of()
        saved = {k: t.clone() for k, t in _state_tensors(state).items()}
        gen = state.gen.get_state()
        outputs = body()
        for k, t in _state_tensors(state).items():
            t.copy_(saved[k])
        state.gen.set_state(gen)
        keys.append(None)
        return Replay(body, outputs), outputs

    return G.ChunkGraphs(make_graph=make_graph, warm_run=lambda b: b())


@pytest.mark.parametrize("spec", [None, dict(k=3)])
def test_engine_through_chunk_graphs_serves_the_eager_tokens(trained, spec):
    """An engine whose chunks go through ChunkGraphs (emulated on the
    CPU) serves the eager engine's tokens and logprobs: the greedy chunk is
    captured once per serve, on the empty state before the first admission
    (its chunk over empty slots changes no output), and sampled requests
    get a graph of their own key."""
    _, _, _, tcfg, tparams = trained["dense"]
    model = build_model(tcfg)
    kw = dict(max_seq=MAX_SEQ, kv_precision="int8", device="cpu",
              spec=SpecConfig(**spec) if spec else None)
    eager = ServeEngine(model, tparams, **kw)
    graph = ServeEngine(model, tparams, **kw)
    assert eager.graphs is None and graph.graphs is None   # CPU: eager
    states, captures = [], []
    inner = graph.init_decode_state

    def init(*a, **k):
        states.append(inner(*a, **k))
        return states[-1]

    graph.init_decode_state = init
    graph.graphs = _emulated_graphs(lambda: states[-1], captures)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=8, arrival_step=2 * i)
            for i, p in enumerate(_prompts(tcfg.vocab_size))]
    e_outs, _ = eager.serve(reqs, num_slots=2, chunk=2)
    g_outs, _ = graph.serve(reqs, num_slots=2, chunk=2)
    for e, g in zip(e_outs, g_outs):
        np.testing.assert_array_equal(e.tokens, g.tokens)
        np.testing.assert_array_equal(e.logprobs, g.logprobs)
    assert len(captures) == 1
    assert list(graph.graphs.graphs) == [(2, False, False, graph.spec)]
    sampled = [dataclasses.replace(r, temperature=0.7, top_k=5)
               for r in reqs]
    outs, _ = graph.serve(sampled, num_slots=2, chunk=2)
    assert sorted(graph.graphs.graphs, key=str) == [
        (2, False, False, graph.spec), (2, True, True, graph.spec)]
    for o in outs:
        assert len(o.generated) == 8 and np.all(np.isfinite(o.logprobs))


def test_cpu_engines_never_capture(trained):
    _, _, _, tcfg, tparams = trained["dense"]
    for flag in (True, False):
        eng = ServeEngine(build_model(tcfg), tparams, max_seq=MAX_SEQ,
                          device="cpu", cuda_graphs=flag)
        assert eng.graphs is None


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 16 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 360 bytes cmem[0]
"""


def test_parse_ptxas_reads_registers_smem_and_spills():
    assert build.parse_ptxas(PTXAS) == [
        dict(kernel="_Z3fooPf", spill_stores=4, spill_loads=12,
             registers=168, smem_bytes=16),
        dict(kernel="_Z3barv", spill_stores=0, spill_loads=0, registers=32,
             smem_bytes=0)]
