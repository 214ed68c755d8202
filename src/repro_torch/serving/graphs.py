"""Decode chunks replayed from CUDA graphs.

The port's counterpart of the JAX package's jitted chunk and spec-round
functions (``src/repro/serving/engine.py`` ``_chunk_fn`` / ``_spec_fn``):
there each decode chunk is one compiled ``lax.scan``; here an eager chunk
is thousands of small kernel launches and PyTorch ops whose host dispatch
takes several times the device's work. ``ChunkGraphs`` captures a whole
chunk (``steps`` decode steps, or ``rounds`` speculative rounds) into one
CUDA graph the first time its key is seen and replays it afterwards.

What the chunk body keeps to for capture:

* every state update is in place (``serving/batch.py``): a replay reads
  and writes the addresses its capture saw;
* it reads nothing back to the host;
* its random draws come from the slot state's ``torch.Generator``, which
  is registered with each graph, so every replay draws new numbers.

The first call with a key runs the chunk eagerly on a side stream (the
chunk's real run, and the warm-up capture wants), then captures the same
body. Capture records kernels and runs none, so the first chunk runs
once. Graphs belong to the decode state they were captured on:
``init_decode_state`` makes new tensors, so a new state drops the old
graphs, and so does a KV tier transition (``ServeEngine.apply_kv_plan``
hands back a new state over new pools and resets the graphs itself). The
graphs of one state share one memory pool; a new state captures into a
new pool.

Launch counts: the kernel wrappers add to ``build.LAUNCHES`` in Python,
which runs at capture and not at replay. ``capture`` takes back what the
capture counted, and each replay adds it, so the counters read as they
would for the eager chunk.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Optional

from repro_torch.kernels import build


def _clone(outputs):
    """A chunk's outputs (None, or a NamedTuple of tensors such as
    SpecMetrics), copied: a graph's own buffers are overwritten by its next
    replay."""
    if outputs is None:
        return None
    return type(outputs)(*(t.clone() for t in outputs))


class CapturedChunk:
    """One captured chunk: its graph, the tensors its body returned at
    capture (rewritten by each replay), and the kernel launches the body
    made."""

    def __init__(self, graph, outputs, launches: dict):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches

    def replay(self):
        self.graph.replay()
        for name, n in self.launches.items():
            build.LAUNCHES[name] += n
        return _clone(self.outputs)


def cuda_graph(body: Callable[[], Any], pool, generators) -> tuple:
    """Capture ``body`` into a ``torch.cuda.CUDAGraph`` in ``pool``, with
    ``generators`` registered. Returns (graph, what body returned). Raises
    if the capture fails: there is no eager fallback."""
    import torch
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    with torch.cuda.graph(graph, pool=pool):
        outputs = body()
    return graph, outputs


def capture(body: Callable[[], Any], *, pool=None, generators=(),
            make_graph: Callable = cuda_graph) -> CapturedChunk:
    """Capture ``body`` with ``make_graph`` and keep, beside the graph,
    the launches the capture counted; ``build.LAUNCHES`` is restored to
    what it was, since the capture launched nothing."""
    before = dict(build.LAUNCHES)
    graph, outputs = make_graph(body, pool, generators)
    launches = {k: build.LAUNCHES[k] - before[k] for k in before
                if build.LAUNCHES[k] != before[k]}
    build.LAUNCHES.update(before)
    return CapturedChunk(graph, outputs, launches)


_SIDE_STREAMS: dict = {}


def _side_stream_run(body: Callable[[], Any]):
    """Run ``body`` eagerly on a side stream that waits for, and is then
    waited on by, the current stream (the warm-up PyTorch's capture
    wants). The side stream is one per device for the process: cuBLAS
    keeps a workspace for every stream it runs on, so a new stream a
    capture would hold one more workspace each time a decode state (or a
    KV tier transition) captures anew."""
    import torch
    main = torch.cuda.current_stream()
    side = _SIDE_STREAMS.get(main.device)
    if side is None:
        side = _SIDE_STREAMS[main.device] = torch.cuda.Stream(main.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        outputs = body()
    main.wait_stream(side)
    return _clone(outputs)


class ChunkGraphs:
    """The captured chunks of one engine, keyed by what changes the
    captured work; ``make_graph`` and ``warm_run`` are replaced by stubs in
    the CPU tests."""

    def __init__(self, make_graph: Callable = cuda_graph,
                 warm_run: Callable = _side_stream_run):
        self.make_graph = make_graph
        self.warm_run = warm_run
        self.pool = None
        self.graphs: dict = {}
        self._state: Optional[weakref.ref] = None

    def reset(self) -> None:
        """Drop every captured chunk and their memory pool (the decode
        state's tensors changed under them: a KV tier transition repacks
        the pool). Once no graph holds a pool, PyTorch refuses a new
        capture into it, so the next capture takes a new pool."""
        self.graphs.clear()
        self.pool = None
        self._state = None

    def run(self, state, key, body: Callable[[], Any]):
        """Run one chunk over ``state``: replay its graph, or on the first
        call with ``key`` run it and capture it."""
        if self._state is None or self._state() is not state:
            self.reset()               # graphs of another state
            self._state = weakref.ref(state)
        entry = self.graphs.get(key)
        if entry is not None:
            return entry.replay()
        outputs = self.warm_run(body)
        if self.pool is None and self.make_graph is cuda_graph:
            import torch
            self.pool = torch.cuda.graph_pool_handle()
        self.graphs[key] = capture(body, pool=self.pool,
                                   generators=(state.gen,),
                                   make_graph=self.make_graph)
        return outputs


class PromptStep:
    """The prompt scan of the SSM and hybrid families from a CUDA graph:
    one single-token decode step over a persistent batch=1 cache, captured
    once and replayed for every prompt token (the recurrent state has no
    multi-token step, so a prompt is a scan of single-token steps, as in
    the reference's prefill). ``run`` zeroes the cache in place (or copies
    a given starting cache into it: a chunked prefill's cache so far),
    replays the step once per token and returns copies of the cache and of
    the last logits; the step and the eager scan launch the same kernels
    on the same values, so they agree to the bit, and a prompt scanned in
    chunks equals the prompt scanned whole. ``make_graph`` and
    ``warm_run`` are replaced by stubs in the CPU tests."""

    def __init__(self, model, params, max_seq: int, device,
                 make_graph: Callable = cuda_graph,
                 warm_run: Callable = _side_stream_run):
        import torch
        self.cache = model.init_cache(1, max_seq, device)
        self.tok = torch.zeros((1, 1), dtype=torch.long, device=device)
        self.logits = torch.zeros((1, model.cfg.padded_vocab),
                                  dtype=torch.float32, device=device)

        def body():
            logits, cache = model.decode_step(params, self.cache, self.tok)
            self.cache.pos.copy_(cache.pos)
            self.logits.copy_(logits[:, 0])

        warm_run(body)
        self.step = capture(body, make_graph=make_graph)

    def run(self, toks, cache=None) -> tuple:
        """toks (1, s) -> (batch=1 cache at pos + s, last logits
        (1, V_pad)), from ``cache`` (None: a fresh cache at pos 0)."""
        if cache is None:
            for t in self.cache:
                t.zero_()
        else:
            for t, src in zip(self.cache, cache):
                t.copy_(src)
        for j in range(toks.shape[1]):
            self.tok.copy_(toks[:, j:j + 1])
            self.step.replay()
        return (type(self.cache)(*(t.clone() for t in self.cache)),
                self.logits.clone())
