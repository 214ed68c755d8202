"""Continuous-batching serving engine with EWQ/FastEWQ-quantized weights.

The paper's deployment pipeline, end to end:
  1. pick a QuantPlan (full EWQ on the weights, FastEWQ metadata, or an
     explicit plan) and compile it onto the parameters (quant/compiler.py);
  2. optionally quantize the KV cache (int8 / int4 / entropy-weighted);
  3. serve: a prefill per request fills a raw cache (whole, or in
     ``prefill_chunk``-token slices between decode chunks), admission
     quantizes it into a decode slot, and decode runs over the quantized
     weights and cache through the port's CUDA kernels.

The quantized weights come from an in-memory plan (compiled when the engine
is built) or from a persisted artifact (``ServeEngine.from_artifact``: a
cold start with no raw weights and no entropy analysis).

Structure:
  * ``decode_chunk`` runs ``steps`` token steps over every slot: sampling,
    per-slot stop conditions (EOS / max-new-tokens), then one batched
    ``decode_step``. Nothing in a chunk waits for the device, and every
    step writes the decode state in place. On the card the whole chunk is
    captured into a CUDA graph the first time its key is seen and
    replayed afterwards (``serving/graphs.py``, the counterpart of the
    reference's jitted chunk); ``cuda_graphs=False`` runs the same code
    eagerly, the baseline a replay is held against. CPU engines always
    run eagerly.
  * ``serve`` is continuous batching (``serving/session.py``): between
    chunks the host-side Scheduler admits queued requests into freed slots
    (highest priority first) and harvests finished ones (one device read
    per chunk). With ``prefill_chunk`` a prompt enters its batch=1 cache
    one slice per tick (``begin_prefill`` / ``advance_prefill``) while the
    other slots keep decoding; with ``slo`` admission is TPOT-gated and a
    higher-priority waiter may preempt a running request. Deadlines, queue
    timeouts and cancellation hold either way.
  * ``generate`` drains one fixed batch through the same loop.
  * With ``spec=SpecConfig(k=...)`` a chunk runs ``steps`` self-speculative
    draft-propose / target-verify rounds instead of single-token steps
    (``serving/spec``); the all-int4 draft is derived from the plan by
    entropy order and shares the target's tensors where the plan already
    chose int4 or lower. Greedy output is token-identical to the non-spec
    engine.
  * With ``paged=PagedConfig(...)`` (or ``True``) the K/V live in a pool
    of fixed-size pages reached through per-slot page tables
    (``quant/paged.py``) instead of a ``num_slots x max_seq`` reservation.
    ``init_decode_state`` builds the pool and its host allocator
    (``serving/pool.py``), by default at the dense reservation's size;
    ``insert`` allocates a request's pages and raises ``OutOfPages``
    leak-free when the pool cannot supply them; ``release`` returns them.
    With prefix sharing, a prompt's full pages that match an earlier
    prompt are mapped read-only (copy-on-write at the boundary page), and
    ``prefill_request`` runs only the suffix, as one multi-query decode
    step over the shared rows. ``serve`` holds a request back (requeues it)
    while the pool cannot cover its worst case. Greedy output is
    token-identical to the dense engine's.
  * Graceful degradation: ``degrade_ladder`` orders the KV tiers a paged
    engine spills through under pool pressure (the weight plan's entropy
    decisions first), and ``apply_kv_plan`` repacks the live pool at one
    of them at a constant byte budget (``serve(degrade=...)``,
    ``serving/session.py``).

Enc-dec models (whisper) serve with ``frames`` per request (a zero frame
block when a request has none): prefill encodes them, computes every
decoder layer's cross K/V once, and scores the whole prompt in one
multi-query decode step; admission quantizes the self and cross K/V into
the slot. Over a paged pool only the self-attention K/V are paged; the
cross K/V stay a dense field per slot, and a prefix hit maps its pages but
still prefills in full (the frames are needed). Its speculative rounds
verify in one multi-query step and propose in two passes on a cache clone
(cross K/V included).

MoE models (grok-1, arctic) take the dense family's paths. An MoE layer's
output depends on which tokens share its call, so each path routes the
reference's token set: a prompt alone at prefill, one chunk (or a prefix
hit's suffix) at a time in chunked prefill, every slot (free ones too) at
a decode step, all B * (k + 1) tokens of a verify window.

SSM (mamba2) and hybrid (zamba2) models prefill by scanning single-token
decode steps over the prompt, as the reference does: their recurrent
conv/state has no multi-token step. On the card the step is replayed from
a CUDA graph over a persistent batch=1 cache (``graphs.PromptStep``),
which agrees with the eager scan to the bit, also on an engine whose
decode chunks run eagerly (``cuda_graphs=False``). Their conv/state live dense
per slot beside the K/V fields; a hybrid engine's K/V (one entry per
shared-attention site) may be quantized or paged, and on a prefix hit its
matched pages are mapped while the prompt is still prefilled in full (the
conv/state need every token). Their speculative rounds verify by a scan
that snapshots conv/state (``Model.spec_verify``) and propose in two
passes on a cache clone.

Over a device mesh (``mesh=``, ``launch/mesh.py``) the compiled weights are
placed TP-only (``sharding/specs.py``): the slots split over the rows of
the data axes, each row decoding its own through ``serving/batch.py``
``decode_rows``; within a row the "model" positions hold their heads, their
slice of d_ff and their vocab rows, and the prefill paths run row 0's group
(``self.params`` is then its ``TPGroup``, or its tree on a data-only mesh).

The engine runs on ``cuda`` unless the caller passes ``device="cpu"`` (the
tests do, and then every kernel's plain version runs). With no GPU and no
explicit CPU request it raises; it never falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.policy import QuantPlan
from repro_torch.device import resolve_device
from repro_torch.models import encdec
from repro_torch.models.common import dtype_of
from repro_torch.quant import paged as PG
from repro_torch.quant.apply import (SegmentedParams, segment_slices,
                                     tree_nbytes)
from repro_torch.quant.compiler import (compile_draft_plan, compile_kv_plan,
                                        degrade_kv_ladder)
from repro_torch.quant.kvcache import (DEFAULT_KV_GROUP, KVPlan,
                                       dequantize_kv, kv_field_nbytes,
                                       quantize_model_cache)
from repro_torch.serving import batch as B
from repro_torch.serving import sampling as S
from repro_torch.serving.graphs import ChunkGraphs, PromptStep
from repro_torch.serving.pool import PagedConfig, PoolSession, PrefixMatch
from repro_torch.serving.quantized import apply_plan_to_params
from repro_torch.serving.scheduler import Request, RequestOutput, SLOConfig
from repro_torch.serving.spec import SpecConfig, make_spec_round
from repro_torch.sharding import collective as C

DEFAULT_CHUNK = 8


@dataclasses.dataclass
class GenerateResult:
    tokens: torch.Tensor       # (B, prompt + new)
    logprobs: torch.Tensor     # (B, new) chosen-token logprobs
    steps: int


@dataclasses.dataclass
class Prefill:
    """One request's prefill result: what ``insert`` needs."""
    prompt: np.ndarray           # (P,) int32 host tokens
    cache: object                # batch=1 raw family cache, pos == P
    last_logits: torch.Tensor    # (1, V_pad) logits after the last token
    match: Optional[PrefixMatch] = None  # pinned prefix-cache match (paged)


@dataclasses.dataclass
class ChunkedPrefill:
    """An in-flight chunked prefill: the request holds a reserved slot
    while its prompt enters the batch=1 prefill cache one
    ``prefill_chunk``-token slice per serve tick, between decode chunks, so
    a long prompt never holds up the running slots for its whole prefill.
    Becomes a plain ``Prefill`` (and is inserted) once ``pos`` covers the
    prompt."""
    prompt: np.ndarray           # (P,) int32 host tokens
    cache: object                # batch=1 family cache, filled to ``pos``
    last_logits: Optional[torch.Tensor]  # (1, V_pad) after the last chunk
    pos: int                     # prompt tokens already in the cache
    match: Optional[PrefixMatch] = None  # pinned prefix-cache match (paged)

    @property
    def done(self) -> bool:
        return self.pos >= len(self.prompt)

    def as_prefill(self) -> Prefill:
        assert self.done and self.last_logits is not None
        return Prefill(prompt=self.prompt, cache=self.cache,
                       last_logits=self.last_logits, match=self.match)


@dataclasses.dataclass
class ServeStats:
    """Continuous-batching run statistics (wall clock on the host): a
    snapshot view of the run's published metrics registry
    (``from_registry``, ``obs/serve_metrics.py``), beside the port's own
    fields (``serve_metrics.PORT_FIELDS``), which ``finalize`` sets and
    ``==`` leaves out with the registry."""
    decode_steps: int          # steps executed (chunks * chunk)
    generated_tokens: int      # tokens emitted across all requests
    occupancy: float           # mean fraction of active slots per chunk
    num_chunks: int
    admissions: int            # requests admitted while others decoded
    # the port's own (PORT_FIELDS): no metric family, out of ==. The
    # serve() call's wall s (admission to last harvest), generated_tokens
    # / wall_s, and the mean of admission -> first harvested token
    wall_s: float = dataclasses.field(default=0.0, compare=False)
    tokens_per_s: float = dataclasses.field(default=0.0, compare=False)
    ttft_mean_s: float = dataclasses.field(default=0.0, compare=False)
    ttft_p50_s: float = 0.0
    ttft_p95_s: float = 0.0
    tpot_p50_s: float = 0.0    # per-output-token latency after the first
    tpot_p95_s: float = 0.0
    # queueing and SLO scheduling
    queue_delay_p50_s: float = 0.0  # ready -> dequeue wait, apart from
    queue_delay_p95_s: float = 0.0  #   ttft (which starts at dequeue)
    preemptions: int = 0       # restart-style evictions for higher priority
    timeouts: int = 0          # requests dropped by queue timeout
    cancelled: int = 0         # requests cancelled (queued or running)
    prefill_chunks: int = 0    # chunked-prefill advances interleaved
    # wall seconds from the start of each decoding tick to its harvest (the
    # tick's admissions and prefill work included: a whole-prompt prefill
    # of a long prompt shows as a spike in decode_gap_max_s)
    decode_gap_p50_s: float = 0.0
    decode_gap_p95_s: float = 0.0
    decode_gap_max_s: float = 0.0
    # speculative decoding (spec=SpecConfig(...) engines only)
    spec_rounds: int = 0       # draft-propose/verify rounds executed
    draft_proposed: int = 0    # draft tokens proposed to live slots
    draft_accepted: int = 0    # draft tokens verified AND committed
    acceptance_rate: float = 0.0   # accepted / proposed
    tokens_per_round: float = 0.0  # committed tokens per round
    # paged KV pool (paged=... engines only)
    pool_pages_total: int = 0      # allocatable physical pages in the pool
    pool_pages_peak: int = 0       # high-water mark of pages in use
    pool_page_size: int = 0        # tokens per page
    prefix_hits: int = 0           # admissions that reused shared pages
    prefix_hit_tokens: int = 0     # prompt tokens served from shared pages
    prefix_hit_rate: float = 0.0   # hit tokens / all prompt tokens
    cow_copies: int = 0            # COW boundary pages written privately
    kv_bytes_peak: float = 0.0     # peak pool bytes referenced, plus the
                                   # slots' KV fields outside the pool
    # admissions the pool held back (PORT_FIELDS)
    requeues: int = dataclasses.field(default=0, compare=False)
    # the autotune cache key the engine's kernels run under; the port has
    # no autotuner (ROADMAP.md queue 1 item 7), so always "untuned"
    tuned: str = "untuned"
    # fault tolerance and graceful degradation
    replica_restarts: int = 0      # replicas quarantined and failed over
    redriven_requests: int = 0     # in-flight requests re-driven to survivors
    recovery_p95_s: float = 0.0    # p95 wall s, failure -> survivors resumed
    watchdog_trips: int = 0        # decode gaps over the watchdog deadline
    degraded_steps: int = 0        # decode steps run below tier 0
    degrade_transitions: int = 0   # KV tier changes (spills + promotions)
    kv_tier_steps: tuple = ()      # decode steps per degradation tier
    # the registry this snapshot was rebuilt from: it carries the
    # per-priority and per-tier label breakdowns the flat fields sum away.
    # Out of == and repr, so stats stay comparable across runs.
    registry: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)

    @classmethod
    def from_registry(cls, reg, **own) -> "ServeStats":
        """Snapshot view of a published metrics registry (the field
        mapping is ``obs/serve_metrics.py``'s); ``own`` sets the port's
        own fields."""
        from repro_torch.obs.serve_metrics import stats_fields
        return cls(registry=reg, **stats_fields(reg), **own)


class ServeEngine:
    """``params`` must live on ``device`` (``bridge.from_jax`` and
    ``Model.init`` take a device).

    With ``mesh`` (``launch/mesh.py``) the compiled weights are placed
    TP-only over the mesh (``sharding/specs.py``): each data row of
    positions serves its share of the slots, and within a row each "model"
    position holds its heads and its slice of d_ff, the vocab rows of the
    embedding and the head, and its KV heads; the partial outputs are
    summed in position order (``sharding/collective.py``). A model axis
    larger than 1 serves the dense family whose heads divide it, without
    the paged pool or speculative rounds; a data-only mesh serves every
    family. Any other layout raises."""

    def __init__(self, model, params, *, max_seq: int,
                 plan: Optional[QuantPlan] = None, group: int = 128,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 kv_precision="bf16", kv_group: Optional[int] = None,
                 spec: Optional[SpecConfig] = None, paged=None, device=None,
                 cuda_graphs: bool = True,
                 prefill_chunk: Optional[int] = None, mesh=None):
        self.mesh = mesh
        if mesh is not None:
            device = _mesh_device(mesh, device)
        self.device = resolve_device(device)
        # decode chunks replay from CUDA graphs on the card (never on the
        # CPU); a capture that fails raises
        self.graphs = (ChunkGraphs() if cuda_graphs
                       and self.device.type == "cuda" else None)
        # an SSM / hybrid prompt scan replays its single-token step from a
        # graph of its own on the card
        self.prompt_graph = self.device.type == "cuda"
        self.model = model
        self.cfg = model.cfg
        self.max_seq = max_seq
        self.plan = plan
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.spec = spec
        self._draft = None            # compiled at first use
        self._draft_stamp = None      # artifact manifest "draft"
        # chunked prefill: serve() splits prompts into prefill_chunk-token
        # slices scheduled between decode chunks; None keeps the whole-
        # prompt prefill
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1 or None, got "
                             f"{prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        # paged KV pool: True -> defaults, or a PagedConfig
        self.paged = (PagedConfig() if paged is True else paged) or None
        self._paged_fields = (tuple(f for f in model.kv_cache_fields
                                    if f in ("k", "v"))
                              if self.paged is not None else ())
        self.pool: Optional[PoolSession] = None  # built by init_decode_state
        # the autotune stamp of ServeStats.tuned and the decode/chunk span:
        # no autotuner yet (ROADMAP.md queue 1 item 7)
        self.tuned = "untuned"
        self._page_bytes = 0.0
        self._prompt_step: Optional[PromptStep] = None  # built at first use
        if plan is not None:
            params = apply_plan_to_params(model, params, plan, group)
        if mesh is not None:
            params = self._place(params)
        self.params = params
        if isinstance(kv_precision, KVPlan):
            self.kv_plan = kv_precision
        else:
            self.kv_plan = compile_kv_plan(self.cfg, plan, kv_precision,
                                           kv_group or DEFAULT_KV_GROUP)
        if mesh is not None:
            self._check_kv_split()

    # -- mesh placement --------------------------------------------------------
    def _place(self, params):
        """Place the weights TP-only over the mesh (a ``MeshTree`` from a
        sharded cold boot is taken as it is). Returns what the prefill
        paths run: row 0's parameter tree, or its ``TPGroup``."""
        from repro_torch.sharding.specs import (MeshTree, position_grid,
                                                serving_shard)
        self._grid = grid = position_grid(self.mesh)
        self._check_mesh()
        self.mesh_params = (params if isinstance(params, MeshTree)
                            else serving_shard(params, self.mesh))
        r_n, t = grid.shape
        self._groups = []
        for r in range(r_n):
            trees = [self.mesh_params.at(grid[r, m]) for m in range(t)]
            devs = [self.mesh.devices[grid[r, m]] for m in range(t)]
            self._groups.append(C.TPGroup(trees, devs) if t > 1
                                else trees[0])
        return self._groups[0]

    def _check_mesh(self) -> None:
        """Refuse the layouts the port does not serve (never a fallback)."""
        cfg, mesh = self.cfg, self.mesh
        t = self._grid.shape[1]
        if self.spec is not None or self.paged is not None:
            if mesh.size > 1:
                raise ValueError(
                    f"{'speculative rounds' if self.spec else 'the paged pool'}"
                    f" over a mesh of {mesh.size} positions "
                    f"({dict(mesh.shape)}) is not ported (ROADMAP.md queue 1 "
                    f"item 10); serve them per replica over a data-only "
                    f"mesh (ReplicaServe.build)")
        if self.graphs is not None and len(mesh.device_set) > 1:
            raise ValueError(
                f"CUDA-graph decode chunks capture one card; this mesh spans "
                f"{mesh.device_set} (ROADMAP.md queue 1 item 10): pass "
                f"cuda_graphs=False")
        if t == 1:
            return
        if cfg.family != "dense":
            raise ValueError(
                f"a model axis of {t} for the {cfg.family} family: tensor "
                f"parallelism of the ssm, hybrid, encdec and moe families is "
                f"not ported (ROADMAP.md queue 1 item 10); a data-only mesh "
                f"serves it")
        if cfg.num_heads % t or cfg.num_kv_heads % t:
            raise ValueError(
                f"{cfg.num_heads} query / {cfg.num_kv_heads} KV heads over "
                f"|model| = {t} would split a head: the rules shard the KV "
                f"sequence there, a split-KV merge across positions the port "
                f"does not serve (ROADMAP.md queue 1 item 10)")

    def _check_kv_split(self) -> None:
        """A quantized KV page's scale groups run along the flat heads of
        its position; a group must not straddle two positions."""
        t = self._grid.shape[1]
        f = self.cfg.num_kv_heads // t * self.cfg.head_dim
        if (t > 1 and self.kv_plan is not None
                and any(p != "bf16" for p in self.kv_plan.precisions)
                and f % self.kv_plan.group):
            raise ValueError(
                f"KV group {self.kv_plan.group} does not divide a position's "
                f"{self.cfg.num_kv_heads // t} KV heads x {self.cfg.head_dim}"
                f" = {f}: a scale group would straddle two positions "
                f"(ROADMAP.md queue 1 item 10); serve with a kv_group that "
                f"divides {f}")

    def _layout_params(self):
        """The tree whose segment layout the cache follows: the params,
        or position 0's shard on a mesh."""
        if self.mesh is None:
            return self.params
        return self.mesh_params.at(self._grid[0, 0])

    def _new_cache(self, batch: int):
        """A fresh raw batch cache at pos 0: over a model axis, row 0's
        ``TPCache`` of each position's KV heads."""
        if self.mesh is None or self._grid.shape[1] == 1:
            return self.model.init_cache(batch, self.max_seq, self.device)
        return B.split_heads(self.model.init_cache(batch, self.max_seq,
                                                   "meta"),
                             self._groups[0].devices)

    @classmethod
    def from_artifact(cls, model, directory: str, *, max_seq: int,
                      device=None, mesh=None, **kw) -> "ServeEngine":
        """Boot from a persisted compiled-plan artifact: the quantized
        weights are restored straight onto the device, with no raw weight
        loading, no entropy analysis and no re-quantization
        (``quant/compiler.load_artifact``). The KV plan stamped at compile
        time is the default; ``kv_precision="auto"`` is compiled from the
        stamped plan. On the card an artifact whose weight group the
        kernels do not take is refused here, before any leaf is read. With
        ``mesh`` each leaf's shards land on their positions as it is read
        (``load_artifact(mesh=)``): no device holds a whole copy of a
        sharded leaf."""
        from repro_torch.checkpoint import ckpt
        from repro_torch.kernels.qmatmul.ops import KERNEL_GROUP
        from repro_torch.quant.compiler import load_artifact
        if mesh is not None:
            device = _mesh_device(mesh, device)
        device = resolve_device(device)
        manifest = ckpt.load_artifact_manifest(directory)
        quantized = any(d["precision"] != "raw"
                        for d in manifest["plan"]["decisions"])
        if (device.type == "cuda" and quantized
                and manifest["group"] != KERNEL_GROUP):
            raise ValueError(
                f"artifact {directory!r} holds weights quantized at group "
                f"{manifest['group']}; the CUDA kernels take group "
                f"{KERNEL_GROUP} only (ROADMAP.md K1)")
        compiled = load_artifact(directory, model, device=device, mesh=mesh)
        if compiled.kv_plan is not None:
            kw.setdefault("kv_precision", compiled.kv_plan)
        if kw.get("kv_precision") == "auto":
            # "auto" needs the weight plan, which the constructor does not
            # see on this path (the params arrive compiled)
            kw["kv_precision"] = compile_kv_plan(
                model.cfg, compiled.plan, "auto",
                kw.pop("kv_group", None) or DEFAULT_KV_GROUP)
        engine = cls(model, compiled.params, max_seq=max_seq, plan=None,
                     device=device, mesh=mesh, **kw)
        engine.plan = compiled.plan
        engine._draft_stamp = compiled.draft   # checked by _ensure_draft
        obs.instant("engine/from_artifact",
                    args={"directory": directory,
                          "family": model.cfg.family})
        return engine

    # -- quantized KV cache ----------------------------------------------------
    def _kv_cuts(self) -> tuple:
        """Page boundaries = the segment boundaries of the weight stack the
        cache follows (the decoder's for enc-dec). A hybrid cache follows
        the shared block's one decision over its sites: no cuts."""
        key = {"dense": "layers", "moe": "layers",
               "encdec": "dec_layers"}.get(self.cfg.family)
        if key is None:
            return ()
        return tuple(lo for _, lo, _ in
                     segment_slices(self._layout_params()[key])[1:])

    def _wrap_cache(self, cache):
        """Raw family cache -> quantized pages per the KV plan (identity
        for a bf16 cache)."""
        if self.kv_plan is None:
            return cache
        return quantize_model_cache(cache, self.kv_plan, self._kv_cuts(),
                                    self.model.kv_cache_fields)

    # -- prefill ---------------------------------------------------------------
    def _tokens(self, prompts) -> torch.Tensor:
        return torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                               device=self.device)

    @torch.no_grad()
    def prefill(self, prompts, frames=None):
        """(B, P) prompts (+ (B, S_enc, D) ``frames`` for enc-dec; zeros
        when None) -> (raw cache padded to max_seq at pos P, last-token
        logits (B, V_pad))."""
        toks = self._tokens(prompts)
        b, s = toks.shape
        assert s <= self.max_seq, (s, self.max_seq)
        if self.cfg.family == "encdec":
            if frames is None:
                frames = self._default_frames(b)
            return self._prefill_encdec(
                toks, torch.as_tensor(frames, device=self.device))
        if frames is not None:
            raise ValueError("frames only apply to enc-dec models")
        if self.model.scans_prompts:
            return self._scan_prompt(toks)
        logits, cache = self.model.module.apply(
            self.params, toks, self.cfg, return_cache=True, last_only=True)
        if isinstance(cache, C.TPCache):
            return cache.map(self._pad_to_max_seq), logits[:, 0]
        return self._pad_to_max_seq(cache), logits[:, 0]

    def _pad_to_max_seq(self, cache):
        """A prefill's (L, B, P, Hkv, hd) K/V padded to ``max_seq`` rows."""
        s = cache.k.shape[2]
        shape = cache.k.shape[:2] + (self.max_seq,) + cache.k.shape[3:]
        k = torch.zeros(shape, dtype=cache.k.dtype, device=cache.k.device)
        v = torch.zeros(shape, dtype=cache.v.dtype, device=cache.v.device)
        k[:, :, :s] = cache.k
        v[:, :, :s] = cache.v
        return cache._replace(k=k, v=v)

    def _prefill_step(self, toks: torch.Tensor, cache):
        """Score ``toks`` (B, s) in ONE multi-query decode step over a raw
        batch cache (rows written at its pos, query i sees the rows up to
        pos + i), as the reference's chunked prefill scores a chunk
        (``src/repro/serving/engine.py`` ``_prefill_chunk_fn``). Returns
        (cache at pos + s, last logits (B, V_pad))."""
        logits, cache = self.model.decode_step(self.params, cache, toks)
        return cache, logits[:, -1]

    def _prompt_graph(self) -> PromptStep:
        """The captured single-token prompt step (built at first use)."""
        if self._prompt_step is None:
            self._prompt_step = PromptStep(self.model, self.params,
                                           self.max_seq, self.device)
        return self._prompt_step

    def _scan_prompt(self, toks: torch.Tensor, cache=None,
                     eager: bool = False):
        """SSM / hybrid prefill: scan single-token decode steps over
        ``toks`` from ``cache`` (None: a fresh cache; or a chunked
        prefill's cache so far; the reference's ``_prefill_scan``). On the
        card a batch=1 prompt replays the captured step, unless ``eager``.
        Returns (cache at pos + s, last logits (B, V_pad))."""
        if self.prompt_graph and not eager and toks.shape[0] == 1:
            return self._prompt_graph().run(toks, cache)
        if cache is None:
            cache = self.model.init_cache(toks.shape[0], self.max_seq,
                                          self.device)
        for j in range(toks.shape[1]):
            logits, cache = self.model.decode_step(self.params, cache,
                                                   toks[:, j:j + 1])
        return cache, logits[:, 0]

    def _prefill_encdec(self, toks: torch.Tensor, frames: torch.Tensor):
        """Enc-dec prefill: the seed (encoder and cross K/V), then the
        prompt scored in one step."""
        return self._prefill_step(toks, self._encdec_seed(frames))

    def _encdec_seed(self, frames: torch.Tensor):
        """Encode (B, S_enc, D) ``frames`` and compute every decoder
        layer's cross K/V once: a raw batch cache at pos 0 that the prompt
        then enters, whole or chunk by chunk."""
        if tuple(frames.shape[1:]) != (self.cfg.encoder_seq,
                                       self.cfg.d_model):
            raise ValueError(f"frames must be (B, {self.cfg.encoder_seq}, "
                             f"{self.cfg.d_model}), got "
                             f"{tuple(frames.shape)}")
        enc_out = encdec.encode(self.params, frames, self.cfg)
        ck, cv = encdec.precompute_cross_kv(self.params, enc_out, self.cfg)
        cache = self.model.init_cache(frames.shape[0], self.max_seq,
                                      self.device)
        return cache._replace(cross_k=ck, cross_v=cv)

    def _default_frames(self, batch: int) -> torch.Tensor:
        return torch.zeros((batch, self.cfg.encoder_seq, self.cfg.d_model),
                           dtype=dtype_of(self.cfg), device=self.device)

    def prefill_request(self, prompt, state: Optional[B.DecodeState] = None,
                        *, frames=None) -> Prefill:
        """Prefill ONE request (1-D prompt; ``frames`` (S_enc, D) for an
        enc-dec model). A paged engine with prefix sharing first matches
        the prompt against the pool's prefix cache, pinning the matched
        pages; on a hit, and given ``state`` (which holds the pool), it
        reads the shared K/V back from the pool and runs the model over the
        suffix only (dense and MoE). A hybrid or enc-dec model prefills
        the whole prompt (its conv/state need every token; its frames are
        needed) while the hit's pages are still mapped at insert."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        match = None
        if self.pool is not None and self.pool.prefix is not None:
            match = self.pool.match(prompt)
            if (match.hit > 0 and state is not None
                    and self.model.seeds_prefix_hits):
                cache, logits = self._seed_prefill(prompt, match, state)
                return Prefill(prompt=prompt, cache=cache,
                               last_logits=logits, match=match)
        cache, logits = self.prefill(
            prompt[None], None if frames is None else frames[None])
        return Prefill(prompt=prompt, cache=cache, last_logits=logits,
                       match=match)

    @torch.no_grad()
    def _seed_prefill(self, prompt: np.ndarray, m: PrefixMatch,
                      state: B.DecodeState):
        """Prefix-hit prefill: the pool gather, then the suffix scored in
        one multi-query decode step. Returns (cache, last logits
        (1, V_pad))."""
        return self._prefill_step(self._tokens(prompt[None, m.hit:]),
                                  self._pool_gather(m, state))

    def _pool_gather(self, m: PrefixMatch, state: B.DecodeState):
        """Gather a prefix hit's matched rows (shared pages, then the COW
        donor's page) from the pool and dequantize them into a raw batch=1
        cache at ``pos = hit``."""
        row = np.zeros(self.pool.n_log, np.int32)
        row[:len(m.full_ids)] = m.full_ids
        if m.donor is not None:
            row[len(m.full_ids)] = m.donor
        proto = self.model.init_cache(1, self.max_seq, "meta")
        reps = {}
        for name in self._paged_fields:
            field = getattr(state.cache, name)
            dtype = getattr(proto, name).dtype
            parts = [dequantize_kv(PG.gather_rows(pg, row), dtype)
                     for pg in (field if isinstance(field, tuple)
                                else (field,))]
            reps[name] = torch.cat(parts, 0)[:, :, :self.max_seq].contiguous()
        return proto._replace(pos=torch.tensor(m.hit, dtype=torch.int32,
                                               device=self.device), **reps)

    # -- chunked prefill -----------------------------------------------------------
    @torch.no_grad()
    def begin_prefill(self, prompt, state: Optional[B.DecodeState] = None,
                      *, frames=None) -> ChunkedPrefill:
        """Start a chunked prefill: returns the task ``advance_prefill``
        moves forward between decode chunks. A prefix hit (paged, as in
        ``prefill_request``) seeds the cache from the pool's shared rows
        and only the suffix runs through the model; the match's pages stay
        pinned for the task's life (``insert`` takes the pins over; a
        cancelled task gives them back through ``pool.unpin``). An enc-dec
        task starts from the encoder seed (``frames`` (S_enc, D); zeros
        when None)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        match = None
        if self.pool is not None and self.pool.prefix is not None:
            match = self.pool.match(prompt)
            if (match.hit > 0 and state is not None
                    and self.model.seeds_prefix_hits):
                return ChunkedPrefill(prompt=prompt,
                                      cache=self._pool_gather(match, state),
                                      last_logits=None, pos=match.hit,
                                      match=match)
        if self.cfg.family == "encdec":
            frames_b = (self._default_frames(1) if frames is None else
                        torch.as_tensor(frames, device=self.device)[None])
            cache = self._encdec_seed(frames_b)
        else:
            if frames is not None:
                raise ValueError("frames only apply to enc-dec models")
            cache = self._new_cache(1)
        return ChunkedPrefill(prompt=prompt, cache=cache, last_logits=None,
                              pos=0, match=match)

    @torch.no_grad()
    def advance_prefill(self, cp: ChunkedPrefill,
                        budget: int) -> ChunkedPrefill:
        """Run ONE prefill chunk of up to ``budget`` prompt tokens; mutates
        and returns ``cp``. A dense or enc-dec chunk is one multi-query
        decode step over the task's raw cache; an SSM or hybrid chunk is a
        scan of single-token steps from the task's cache (on the card the
        captured prompt step), equal to the whole-prompt scan to the
        bit."""
        assert not cp.done
        c = min(int(budget), len(cp.prompt) - cp.pos)
        toks = self._tokens(cp.prompt[None, cp.pos:cp.pos + c])
        if self.model.scans_prompts:
            cp.cache, cp.last_logits = self._scan_prompt(toks, cp.cache)
        else:
            cp.cache, cp.last_logits = self._prefill_step(toks, cp.cache)
        cp.pos += c
        return cp

    # -- slotted decode ----------------------------------------------------------
    def _pool_runs(self, raw, kv_plan) -> list:
        """Per-precision layer runs of a pool under ``kv_plan`` (None:
        bf16), aligned with the plan's page cuts; a bf16 cache still splits
        at the weight stack's segment cuts, so each segment reads a pool of
        its own layers."""
        l_total = raw.shape[0]
        if kv_plan is None:
            cuts = (0,) + tuple(c for c in self._kv_cuts()
                                if 0 < c < l_total) + (l_total,)
            return [("bf16", lo, hi) for lo, hi in zip(cuts[:-1], cuts[1:])]
        runs = kv_plan.pages(self._kv_cuts())
        assert runs[-1][2] == l_total, (runs, l_total)
        return runs

    def pool_layout(self, kv_plan, num_slots: int) -> tuple[dict, dict,
                                                             float]:
        """A pool under ``kv_plan`` (None: bf16), reckoned on the meta
        device (nothing allocated): each paged field's layer runs, each
        field's raw (dense) dtype, and the bytes of one page."""
        proto = self.model.slotted_cache(num_slots, self.max_seq, "meta")
        group = kv_plan.group if kv_plan is not None else DEFAULT_KV_GROUP
        runs, raw_dtypes, page_bytes = {}, {}, 0.0
        for name in self._paged_fields:
            raw = getattr(proto, name)
            runs[name] = self._pool_runs(raw, kv_plan)
            raw_dtypes[name] = raw.dtype
            page_bytes += PG.page_nbytes(PG.init_pool_field(
                raw, runs[name], num_pages=1,
                page_size=self.paged.page_size, num_slots=num_slots,
                group=group, device="meta"))
        return runs, raw_dtypes, page_bytes

    def _paged_cache(self, num_slots: int, pool_pages: int):
        """Slotted family cache with the paged fields as empty pools (their
        dense layout is shaped on the meta device, never allocated) and
        every other field (pos; a hybrid's conv/state; an enc-dec slot's
        cross K/V, quantized per the KV plan) zeroed on the device."""
        proto = self.model.slotted_cache(num_slots, self.max_seq, "meta")
        group = (self.kv_plan.group if self.kv_plan is not None
                 else DEFAULT_KV_GROUP)
        reps = {}
        for name, raw in zip(proto._fields, proto):
            if name in self._paged_fields:
                reps[name] = PG.init_pool_field(
                    raw, self._pool_runs(raw, self.kv_plan),
                    num_pages=pool_pages,
                    page_size=self.paged.page_size, num_slots=num_slots,
                    group=group, device=self.device)
            else:
                reps[name] = torch.zeros(raw.shape, dtype=raw.dtype,
                                         device=self.device)
        return self._wrap_cache(proto._replace(**reps))

    def init_decode_state(self, num_slots: int, seed: int = 0
                          ) -> B.DecodeState:
        """Empty slotted decode state. A paged engine also (re)builds its
        page pool and host allocator here, sized by default to the dense
        reservation: ``num_slots * ceil(max_seq / page_size)`` pages."""
        if self._paged_fields:
            n_log = PG.logical_pages(self.max_seq, self.paged.page_size)
            pool_pages = self.paged.pool_pages or num_slots * n_log
            self.pool = PoolSession(pool_pages, self.paged.page_size, n_log,
                                    prefix_sharing=self.paged.prefix_sharing)
            cache = self._paged_cache(num_slots, pool_pages)
            self._page_bytes = sum(PG.page_nbytes(getattr(cache, name))
                                   for name in self._paged_fields)
        elif self.mesh is not None and self.mesh.size > 1:
            cache = B.shard_cache(
                self.model.slotted_cache(num_slots, self.max_seq, "meta"),
                self.mesh, self.model, wrap=self._wrap_cache)
        else:
            cache = self._wrap_cache(self.model.slotted_cache(
                num_slots, self.max_seq, self.device))
        return B.init_state(self.model, num_slots, self.max_seq, self.device,
                            cache=cache, seed=seed)

    @torch.no_grad()
    def insert(self, state: B.DecodeState, slot: int, pf: Prefill,
               max_new: int, *, temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0) -> B.DecodeState:
        """Admit a prefilled request into ``slot`` (quantize-on-insert). A
        paged engine allocates the slot's pages here (shared prefix pages
        are mapped, not copied; the COW boundary page is written by the
        insert) and raises ``OutOfPages``, with the match's pins released
        and nothing leaked, when the pool cannot serve the request."""
        page_rows = None
        p = int(pf.prompt.size)
        if self.pool is not None:
            need = self.pool.pages_for(self._slot_seq_budget(p, max_new))
            page_rows = self.pool.admit(slot, pf.prompt, need, pf.match)
        B.insert_request(
            self.model, state, slot, self._tokens(pf.prompt), pf.cache,
            pf.last_logits, max_new, temperature, top_k, top_p,
            page_rows=page_rows)
        if self.pool is not None:
            self.pool.register(slot, pf.prompt, p)
        return state

    def release(self, state: B.DecodeState, slot: int) -> B.DecodeState:
        """Evict a finished request; a paged engine points the slot's
        tables at the dump page and returns its pages (shared pages
        survive while the prefix cache or other slots hold them)."""
        B.release_slot(state, slot)
        if self.pool is not None:
            for name in self._paged_fields:
                PG.release_slot_pages(getattr(state.cache, name), slot)
            self.pool.release(slot)
        return state

    @torch.no_grad()
    def _step(self, st: B.DecodeState) -> None:
        """One decode step over every slot, every write in place."""
        vocab = self.cfg.vocab_size
        lp = torch.log_softmax(st.last_logits[:, :vocab].float(), dim=-1)
        if st.samples:
            dist = S.masked_dist(lp, st.temperature, st.top_k, st.top_p,
                                 need_mask=st.masks)
            nxt = S.sample(st.gen, dist, st.temperature)
        else:
            nxt = torch.argmax(lp, dim=-1).to(torch.int32)
        chosen_lp = torch.gather(lp, 1, nxt[:, None].long())[:, 0]
        advance = st.active & ~st.done
        nxt = torch.where(advance, nxt, torch.full_like(nxt, self.pad_id))
        s_max = st.tokens.shape[1]
        write = advance & (st.lengths < s_max)
        idx = st.lengths.clamp(max=s_max - 1).long()[:, None]
        st.tokens.scatter_(1, idx, torch.where(
            write[:, None], nxt[:, None], st.tokens.gather(1, idx)))
        st.logprobs.scatter_(1, idx, torch.where(
            write[:, None], chosen_lp[:, None], st.logprobs.gather(1, idx)))
        st.lengths += advance.to(torch.int32)
        done = st.done | (advance & (st.lengths >= st.max_len))
        if self.eos_id is not None:
            done = done | (advance & (nxt == self.eos_id))
        st.done.copy_(done)
        # the K/V rows are written in place; decode_step returns the
        # advanced position as a new tensor, copied back into the state's
        if isinstance(st.cache, B.MeshCache):
            logits = B.decode_rows(self.model, self._groups, st.cache,
                                   nxt[:, None].long())
        else:
            logits, cache = self.model.decode_step(self.params, st.cache,
                                                   nxt[:, None].long())
            st.cache.pos.copy_(cache.pos)
        st.last_logits.copy_(logits[:, 0])

    def _chunk(self, state: B.DecodeState, steps: int, plain: bool = False):
        """The chunk's work: ``steps`` decode steps (returns None) or
        ``steps`` spec rounds (returns their SpecMetrics)."""
        if self.spec is None or plain:
            for _ in range(steps):
                self._step(state)
            return None
        run = make_spec_round(
            self.model, self.spec.k, steps, self.eos_id,
            fused_propose=(self.spec.fused_propose
                           and self.model.supports_fused_propose),
            draft_source=self.spec.draft_source)
        return run(self.params, self.draft_params, state)[1]

    @torch.no_grad()
    def decode_chunk(self, state: B.DecodeState, steps: int = DEFAULT_CHUNK,
                     plain: bool = False):
        """Run ``steps`` decode steps over every slot; does not wait for
        the device. A spec engine runs ``steps`` propose/verify rounds and
        returns ``(state, SpecMetrics)``; a plain engine, or a spec engine
        asked for a ``plain`` chunk (a degraded serve drops its spec
        rounds), returns the state. On a CUDA-graph engine the chunk
        replays the graph captured for (state, steps, whether any slot
        samples, whether any slot masks, spec config or None for a plain
        chunk), capturing it on the key's first chunk."""
        plain = plain or self.spec is None
        if self.graphs is None:
            out = self._chunk(state, steps, plain)
        else:
            key = (steps, state.samples, state.masks,
                   None if plain else self.spec)
            out = self.graphs.run(state, key,
                                  lambda: self._chunk(state, steps, plain))
        return state if plain else (state, out)

    # -- graceful degradation ----------------------------------------------------
    def degrade_ladder(self) -> list:
        """Entropy-ordered KV degradation tiers of this engine: tier 0 is
        the serving policy, deeper tiers spill cache precision down
        bf16 -> int8 -> int4 in the order of the weight plan's entropy
        decisions (``quant/compiler.degrade_kv_ladder``). Empty for an
        unpaged engine: degradation trades precision for pool pages."""
        if not self._paged_fields:
            return []
        group = (self.kv_plan.group if self.kv_plan is not None
                 else DEFAULT_KV_GROUP)
        return degrade_kv_ladder(self.cfg, self.plan, self.kv_plan, group,
                                 cuts=self._kv_cuts())

    @torch.no_grad()
    def apply_kv_plan(self, state: B.DecodeState, new_plan
                      ) -> Optional[B.DecodeState]:
        """Live engine-wide KV-precision transition at a constant byte
        budget. A demotion (bf16 -> int8 -> int4) shrinks the page and buys
        proportionally more pages in the same bytes, which relieves pool
        pressure; a promotion shrinks the pool and is refused (None, the
        KV plan unchanged) while the live pages would not fit, after the
        cache-only prefix pages are flushed. Every live page is requantized
        (``quant/paged.repack_pool_field``) and the host allocator rebuilt
        with refcounts, slot maps and the prefix cache remapped: growth
        keeps each page's id, a shrink compacts the live pages to the
        front.

        Returns a new ``DecodeState`` over the new pools. ``state`` is
        consumed: its cache is rebound to the new pools, so the old ones
        are freed here, and the engine's captured decode chunks, which
        read the old pools, are dropped (the next chunk captures anew)."""
        pool = self.pool
        if pool is None or new_plan is self.kv_plan:
            return None
        old_pages = pool.num_pages
        new_runs, raw_dtypes, page_bytes_new = self.pool_layout(
            new_plan, state.num_slots)
        new_pages = int(old_pages * self._page_bytes // page_bytes_new)

        def alive():
            return [pid for pid in range(1, old_pages + 1)
                    if pool._ref[pid] > 0]

        live = alive()
        if len(live) > new_pages and pool.prefix is not None:
            pool.flush_prefix()
            live = alive()
        if new_pages < 1 or len(live) > new_pages:
            return None
        perm = np.zeros(old_pages + 1, np.int32)
        if new_pages >= old_pages:
            perm[live] = live                         # growth: in place
        else:
            perm[live] = np.arange(1, len(live) + 1)  # compaction
        inv = np.zeros(new_pages + 1, np.int32)
        inv[perm[live]] = live
        group = new_plan.group if new_plan is not None else DEFAULT_KV_GROUP
        reps = {name: PG.repack_pool_field(
                    getattr(state.cache, name), new_runs[name], perm=perm,
                    inv=inv, group=group, raw_dtype=raw_dtypes[name])
                for name in self._paged_fields}
        self.kv_plan = new_plan
        new_state = dataclasses.replace(state,
                                        cache=state.cache._replace(**reps))
        state.cache = new_state.cache
        if self.graphs is not None:
            self.graphs.reset()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()   # the old pools and the graphs' pool
        self.pool = pool.rebuild(perm, new_pages)
        self._page_bytes = page_bytes_new
        return new_state

    # -- self-speculative decoding ----------------------------------------------
    def _ensure_draft(self):
        """Compile the all-int4 draft at first use. An engine booted from
        an artifact holds the draft stamped there: the re-derived draft
        must carry the stamped precisions (a different ``draft_group`` or
        ``draft_layers`` is an explicit override and is not checked)."""
        if self._draft is None:
            draft = compile_draft_plan(
                self.model, self.params, self.plan, self.spec.draft_group,
                draft_layers=self.spec.draft_layers)
            stamp = self._draft_stamp
            if (stamp and stamp.get("group") == self.spec.draft_group
                    and stamp.get("draft_layers") == self.spec.draft_layers
                    and list(draft.precisions) != stamp.get("precisions")):
                raise ValueError(
                    "artifact draft stamp mismatch: re-derived draft "
                    f"precisions {list(draft.precisions)} != stamped "
                    f"{stamp.get('precisions')}: the artifact's plan and "
                    "the serving engine's plan disagree")
            self._draft = draft
        return self._draft

    @property
    def draft_params(self):
        # the ngram draft proposes from committed context: no draft model
        # exists, and the round never reads these params
        if self.spec is not None and self.spec.draft_source == "ngram":
            return self.params
        return self._ensure_draft().params

    def draft_overhead_bytes(self) -> float:
        """Draft-only weight bytes (blocks the plan left raw/int8,
        requantized to int4 for the draft); the rest is shared with the
        target."""
        if self.spec is not None and self.spec.draft_source == "ngram":
            return 0.0
        return float(self._ensure_draft().overhead_bytes)

    def draft_weight_bytes(self) -> float:
        """Effective weight bytes ONE draft decode step reads (shared
        payloads and draft-only copies)."""
        if self.spec is not None and self.spec.draft_source == "ngram":
            return 0.0
        return self._weight_bytes(self.draft_params)

    def _slot_seq_budget(self, prompt_len: int, max_new: int) -> int:
        """Deepest cache row a request can write, plus 1: a spec verify
        writes ``k`` rows past the last committed token."""
        k = self.spec.k if self.spec is not None else 0
        return prompt_len + max_new + k

    def _spec_budget_check(self, prompt_len: int, max_new: int) -> None:
        need = self._slot_seq_budget(prompt_len, max_new)
        if need > self.max_seq:
            raise ValueError(
                f"speculative serving needs max_seq >= prompt + max_new + k "
                f"= {need} (k={self.spec.k} verify headroom); max_seq is "
                f"{self.max_seq}")

    # -- generation ---------------------------------------------------------------
    def _slice_prefill(self, cache, i: int):
        """Row ``i`` of a batch prefill cache: the batch=1 cache ``insert``
        takes (a scalar pos is shared across the batch)."""
        if isinstance(cache, C.TPCache):
            return cache.map(lambda c: self._slice_prefill(c, i))
        return type(cache)(*(
            f if f.ndim == 0 else f.narrow(axis, i, 1)
            for f, axis in zip(cache, self.model.cache_batch_axes)))

    @torch.no_grad()
    def generate(self, prompts, max_new_tokens: int,
                 temperature: float = 0.0, chunk: Optional[int] = None,
                 seed: int = 0, frames=None) -> GenerateResult:
        """One fixed batch: batched prefill, then chunks until every row
        has ``max_new_tokens`` tokens (or hit EOS). ``frames``: (B, S_enc,
        D) for an enc-dec model."""
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        toks = self._tokens(prompts)
        b, p = toks.shape
        total = p + max_new_tokens
        if self.spec is not None:
            self._spec_budget_check(p, max_new_tokens)
        else:
            assert total <= self.max_seq, (total, self.max_seq)
        state = self.init_decode_state(b, seed)
        prompts_np = toks.cpu().numpy().astype(np.int32)
        cache, last = self.prefill(prompts_np, frames)
        for i in range(b):
            one = self._slice_prefill(cache, i)
            self.insert(state, i, Prefill(prompt=prompts_np[i], cache=one,
                                          last_logits=last[i:i + 1]),
                        max_new_tokens, temperature=temperature)
        chunk = max_new_tokens if chunk is None else min(chunk,
                                                         max_new_tokens)
        steps = 0
        while True:
            # a spec round commits >= 1 token per live slot, so
            # max_new_tokens rounds suffice
            self.decode_chunk(state, chunk)
            steps += chunk
            if steps >= max_new_tokens or bool(state.done.all()):
                break
        return GenerateResult(tokens=state.tokens[:, :total],
                              logprobs=state.logprobs[:, p:total],
                              steps=steps)

    # -- continuous batching --------------------------------------------------------
    @torch.no_grad()
    def serve(self, requests: Sequence[Request], *, num_slots: int = 8,
              chunk: int = DEFAULT_CHUNK, temperature: float = 0.0,
              seed: int = 0, prefill_chunk: Optional[int] = None,
              slo: Optional[SLOConfig] = None, degrade=None,
              watchdog_s: Optional[float] = None
              ) -> tuple[list[RequestOutput], ServeStats]:
        """Drain a request stream with continuous batching
        (``serving/session.py``): between decode chunks, finished slots are
        harvested and ready requests are admitted into freed slots, highest
        priority first and FIFO within a class. Outputs come back ordered
        by request id. ``prefill_chunk`` (or the engine's) splits prompts
        into slices scheduled between decode chunks; ``slo`` adds
        TPOT-gated admission and priority preemption; a request's queue
        timeout, deadline and cancellation hold either way. On a spec
        engine a chunk is ``chunk`` propose/verify rounds (1 to k+1 tokens
        per live slot each) and the stats carry the acceptance counters. On
        a paged engine a request whose worst case (no prefix hit) the
        pool's free and evictable pages cannot cover is requeued until a
        slot drains; with no slot active that is a deadlock, and
        ``OutOfPages`` is raised, unless ``degrade`` (a
        ``session.DegradeConfig``) can still spill the pool to a lower KV
        tier. ``watchdog_s`` counts decode gaps over that many seconds
        (``watchdog_trips``)."""
        from repro_torch.serving.session import ServeSession
        return ServeSession(self, requests, num_slots=num_slots, chunk=chunk,
                            temperature=temperature, seed=seed,
                            prefill_chunk=prefill_chunk, slo=slo,
                            degrade=degrade, watchdog_s=watchdog_s).run()

    # -- accounting ----------------------------------------------------------------
    def kv_bytes_by_field(self) -> dict:
        """Attention-cache bytes one decode slot holds at ``max_seq`` per
        cache field (K/V payloads + per-group scales; an enc-dec slot also
        holds its cross K/V at ``encoder_seq`` rows), from a one-slot cache
        built on the meta device (shapes only, no memory)."""
        cache = self._wrap_cache(self.model.slotted_cache(1, self.max_seq,
                                                          "meta"))
        return {name: kv_field_nbytes(getattr(cache, name))
                for name in self.model.kv_cache_fields}

    def kv_bytes_per_slot(self) -> float:
        """Attention-cache bytes one decode slot holds, all fields."""
        return float(sum(self.kv_bytes_by_field().values()))

    def state_bytes_by_field(self) -> dict:
        """Recurrent-state bytes one decode slot holds per cache field (an
        SSM or hybrid slot's conv and f32 state, every Mamba2 layer; empty
        for the attention families): they do not grow with the sequence
        and are not KV, so they are counted apart."""
        cache = self.model.slotted_cache(1, self.max_seq, "meta")
        return {name: float(getattr(cache, name).numel()
                            * getattr(cache, name).element_size())
                for name in ("conv", "state") if name in cache._fields}

    def _nonpaged_bytes_per_slot(self) -> float:
        """Per-slot bytes of the KV fields NOT served from the pool (an
        enc-dec engine's cross K/V); 0.0 when every KV field is paged or
        there is none."""
        by_field = self.kv_bytes_by_field()
        return float(sum(v for name, v in by_field.items()
                         if name not in self._paged_fields))

    def kv_bytes_allocated(self, num_slots: int = 1) -> float:
        """Attention-cache bytes held right now. A dense engine reserves
        every slot at full depth up front (``num_slots`` times
        ``kv_bytes_per_slot()``); a paged engine charges only the pool
        pages referenced now, a shared prefix page once, plus the dense
        reservation of any KV field outside the pool."""
        if self.pool is None:
            return num_slots * self.kv_bytes_per_slot()
        return (self.pool.pages_in_use * self._page_bytes
                + num_slots * self._nonpaged_bytes_per_slot())

    @staticmethod
    def _weight_bytes(params) -> float:
        return sum(v.nbytes_effective() if isinstance(v, SegmentedParams)
                   else tree_nbytes(v) for v in params.values())

    def weight_bytes(self) -> float:
        """Effective weight bytes (ternary counted at 1.58 bits); on a mesh
        those of the whole model, each sharded leaf's shards summed and a
        replicated leaf counted once."""
        if self.mesh is not None:
            return self.mesh_params.logical_nbytes()
        return self._weight_bytes(self.params)

    def weight_bytes_per_device(self) -> float:
        """The most physical weight bytes one mesh position holds (its
        shards, and the leaves the rules replicate); the whole tree's
        bytes without a mesh. Positions that share a card are counted
        apart: this is what one card of a deployment would hold."""
        if self.mesh is not None:
            return max(self.mesh_params.position_nbytes().values())
        from repro_torch.sharding.specs import physical_nbytes
        return physical_nbytes(self.params)


def _mesh_device(mesh, device) -> torch.device:
    """The engine's device on ``mesh``: its first position's. Every
    position must be a device of that one type, and an explicit
    ``device`` must be that type: a mesh never falls back."""
    first = mesh.devices.flat[0]
    kinds = {d.type for d in mesh.devices.flat}
    want = torch.device("cuda" if device is None else device).type
    if kinds != {want}:
        raise ValueError(
            f"mesh positions on {sorted(kinds)} for an engine on {want}: "
            f"every position must be a {want} device (launch/mesh.make_mesh"
            f"(..., devices=...)); the port never falls back")
    return first
