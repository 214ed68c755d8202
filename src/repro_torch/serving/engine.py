"""Continuous-batching serving engine with EWQ/FastEWQ-quantized weights.

The paper's deployment pipeline, end to end:
  1. pick a QuantPlan (full EWQ on the weights, FastEWQ metadata, or an
     explicit plan) and compile it onto the parameters (quant/compiler.py);
  2. optionally quantize the KV cache (int8 / int4 / entropy-weighted);
  3. serve: a monolithic prefill per request fills a raw cache, admission
     quantizes it into a decode slot, and decode runs over the quantized
     weights and cache through the port's CUDA kernels.

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
  * ``serve`` is continuous batching: between chunks the host-side
    Scheduler admits queued requests into freed slots and harvests finished
    ones (one device read per chunk).
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

Enc-dec models (whisper) serve with ``frames`` per request (a zero frame
block when a request has none): prefill encodes them, computes every
decoder layer's cross K/V once, and scores the whole prompt in one
multi-query decode step; admission quantizes the self and cross K/V into
the slot. The paged pool and speculative decoding are not ported for this
family, and the engine refuses both for it.

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

The engine runs on ``cuda`` unless the caller passes ``device="cpu"`` (the
tests do, and then every kernel's plain version runs). With no GPU and no
explicit CPU request it raises; it never falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.policy import QuantPlan
from repro_torch.device import resolve_device
from repro_torch.models import encdec
from repro_torch.models.common import dtype_of
from repro_torch.quant import paged as PG
from repro_torch.quant.apply import (SegmentedParams, segment_slices,
                                     tree_nbytes)
from repro_torch.quant.compiler import compile_draft_plan, compile_kv_plan
from repro_torch.quant.kvcache import (DEFAULT_KV_GROUP, KVPlan,
                                       dequantize_kv, kv_field_nbytes,
                                       quantize_model_cache)
from repro_torch.serving import batch as B
from repro_torch.serving import sampling as S
from repro_torch.serving.graphs import ChunkGraphs, PromptStep
from repro_torch.serving.pool import (OutOfPages, PagedConfig, PoolSession,
                                      PrefixMatch)
from repro_torch.serving.quantized import apply_plan_to_params
from repro_torch.serving.scheduler import Request, RequestOutput, Scheduler
from repro_torch.serving.spec import SpecConfig, SpecMetrics, make_spec_round

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
class ServeStats:
    """Continuous-batching run statistics (wall clock on the host)."""
    decode_steps: int          # steps executed (chunks * chunk)
    generated_tokens: int      # tokens emitted across all requests
    occupancy: float           # mean fraction of active slots per chunk
    num_chunks: int
    admissions: int            # requests admitted while others decoded
    wall_s: float              # serve() call, admission to last harvest
    tokens_per_s: float        # generated_tokens / wall_s
    ttft_mean_s: float = 0.0   # admission -> first harvested token
    ttft_p50_s: float = 0.0
    tpot_p50_s: float = 0.0    # per-output-token latency after the first
    decode_gap_p50_s: float = 0.0   # wall seconds per decode chunk
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
    kv_bytes_peak: float = 0.0     # peak pool bytes referenced
    requeues: int = 0              # admissions the pool held back


class ServeEngine:
    """``params`` must live on ``device`` (``bridge.from_jax`` and
    ``Model.init`` take a device)."""

    def __init__(self, model, params, *, max_seq: int,
                 plan: Optional[QuantPlan] = None, group: int = 128,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 kv_precision="bf16", kv_group: Optional[int] = None,
                 spec: Optional[SpecConfig] = None, paged=None, device=None,
                 cuda_graphs: bool = True):
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
        if self.cfg.family == "encdec" and (spec is not None or paged):
            raise NotImplementedError(
                "enc-dec serving over a paged KV pool or with speculative "
                "decoding is still to be ported (ROADMAP.md, 'the other "
                "families'); serve it dense and non-speculative")
        self.max_seq = max_seq
        self.plan = plan
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.spec = spec
        self._draft = None            # compiled at first use
        # paged KV pool: True -> defaults, or a PagedConfig
        self.paged = (PagedConfig() if paged is True else paged) or None
        self._paged_fields = (tuple(f for f in model.kv_cache_fields
                                    if f in ("k", "v"))
                              if self.paged is not None else ())
        self.pool: Optional[PoolSession] = None  # built by init_decode_state
        self._page_bytes = 0.0
        self._prompt_step: Optional[PromptStep] = None  # built at first use
        if plan is not None:
            params = apply_plan_to_params(model, params, plan, group)
        self.params = params
        if isinstance(kv_precision, KVPlan):
            self.kv_plan = kv_precision
        else:
            self.kv_plan = compile_kv_plan(self.cfg, plan, kv_precision,
                                           kv_group or DEFAULT_KV_GROUP)

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
                     segment_slices(self.params[key])[1:])

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
        shape = cache.k.shape[:2] + (self.max_seq,) + cache.k.shape[3:]
        k = torch.zeros(shape, dtype=cache.k.dtype, device=self.device)
        v = torch.zeros(shape, dtype=cache.v.dtype, device=self.device)
        k[:, :, :s] = cache.k
        v[:, :, :s] = cache.v
        return cache._replace(k=k, v=v), logits[:, 0]

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

    def _scan_prompt(self, toks: torch.Tensor, eager: bool = False):
        """SSM / hybrid prefill: scan single-token decode steps over the
        prompt from a fresh cache (the reference's ``_prefill_scan``). On
        the card a batch=1 prompt replays the captured step, unless
        ``eager``. Returns (cache at pos P, last logits (B, V_pad))."""
        if self.prompt_graph and not eager and toks.shape[0] == 1:
            return self._prompt_graph().run(toks)
        cache = self.model.init_cache(toks.shape[0], self.max_seq,
                                      self.device)
        for j in range(toks.shape[1]):
            logits, cache = self.model.decode_step(self.params, cache,
                                                   toks[:, j:j + 1])
        return cache, logits[:, 0]

    def _prefill_encdec(self, toks: torch.Tensor, frames: torch.Tensor):
        """Enc-dec prefill: encode the frames, compute every decoder
        layer's cross K/V once, then score the prompt in one step."""
        if tuple(frames.shape[1:]) != (self.cfg.encoder_seq,
                                       self.cfg.d_model):
            raise ValueError(f"frames must be (B, {self.cfg.encoder_seq}, "
                             f"{self.cfg.d_model}), got "
                             f"{tuple(frames.shape)}")
        enc_out = encdec.encode(self.params, frames, self.cfg)
        ck, cv = encdec.precompute_cross_kv(self.params, enc_out, self.cfg)
        cache = self.model.init_cache(toks.shape[0], self.max_seq,
                                      self.device)
        return self._prefill_step(toks, cache._replace(cross_k=ck,
                                                       cross_v=cv))

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
        suffix only. A hybrid model prefills the whole prompt (its
        conv/state need every token) while the hit's pages are still
        mapped at insert."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        match = None
        if self.pool is not None and self.pool.prefix is not None:
            match = self.pool.match(prompt)
            if (match.hit > 0 and state is not None
                    and not self.model.scans_prompts):
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
        """Prefix-hit prefill: gather the matched rows (shared pages, then
        the COW donor's page) from the pool, dequantize them into a raw
        batch=1 cache at ``pos = hit``, and score the suffix in one
        multi-query decode step. Returns (cache, last logits (1, V_pad))."""
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
        cache = proto._replace(pos=torch.tensor(m.hit, dtype=torch.int32,
                                                device=self.device), **reps)
        return self._prefill_step(self._tokens(prompt[None, m.hit:]), cache)

    # -- slotted decode ----------------------------------------------------------
    def _pool_runs(self, raw) -> list:
        """Per-precision layer runs of a pool, aligned with the KV plan's
        page cuts; a bf16 cache still splits at the weight stack's segment
        cuts, so each segment reads a pool of its own layers."""
        l_total = raw.shape[0]
        if self.kv_plan is None:
            cuts = (0,) + tuple(c for c in self._kv_cuts()
                                if 0 < c < l_total) + (l_total,)
            return [("bf16", lo, hi) for lo, hi in zip(cuts[:-1], cuts[1:])]
        runs = self.kv_plan.pages(self._kv_cuts())
        assert runs[-1][2] == l_total, (runs, l_total)
        return runs

    def _paged_cache(self, num_slots: int, pool_pages: int):
        """Slotted family cache with the paged fields as empty pools (their
        dense layout is shaped on the meta device, never allocated) and
        every other field (pos; a hybrid's conv/state) zeroed on the
        device."""
        proto = self.model.slotted_cache(num_slots, self.max_seq, "meta")
        group = (self.kv_plan.group if self.kv_plan is not None
                 else DEFAULT_KV_GROUP)
        reps = {}
        for name, raw in zip(proto._fields, proto):
            if name in self._paged_fields:
                reps[name] = PG.init_pool_field(
                    raw, self._pool_runs(raw), num_pages=pool_pages,
                    page_size=self.paged.page_size, num_slots=num_slots,
                    group=group, device=self.device)
            else:
                reps[name] = torch.zeros(raw.shape, dtype=raw.dtype,
                                         device=self.device)
        return proto._replace(**reps)

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
        logits, cache = self.model.decode_step(self.params, st.cache,
                                               nxt[:, None].long())
        st.cache.pos.copy_(cache.pos)
        st.last_logits.copy_(logits[:, 0])

    def _chunk(self, state: B.DecodeState, steps: int):
        """The chunk's work: ``steps`` decode steps (returns None) or
        ``steps`` spec rounds (returns their SpecMetrics)."""
        if self.spec is None:
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
    def decode_chunk(self, state: B.DecodeState, steps: int = DEFAULT_CHUNK):
        """Run ``steps`` decode steps over every slot; does not wait for
        the device. A spec engine runs ``steps`` propose/verify rounds and
        returns ``(state, SpecMetrics)``; a plain engine returns the
        state. On a CUDA-graph engine the chunk replays the graph captured
        for (state, steps, whether any slot samples, whether any slot
        masks, spec config), capturing it on the key's first chunk."""
        if self.graphs is None:
            out = self._chunk(state, steps)
        else:
            key = (steps, state.samples, state.masks, self.spec)
            out = self.graphs.run(state, key,
                                  lambda: self._chunk(state, steps))
        return state if self.spec is None else (state, out)

    # -- self-speculative decoding ----------------------------------------------
    def _ensure_draft(self):
        """Compile the all-int4 draft at first use."""
        if self._draft is None:
            self._draft = compile_draft_plan(
                self.model, self.params, self.plan, self.spec.draft_group,
                draft_layers=self.spec.draft_layers)
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
              seed: int = 0) -> tuple[list[RequestOutput], ServeStats]:
        """Drain a request stream with continuous batching: admit ready
        requests into free slots (monolithic prefill + insert), run one
        decode chunk, harvest finished slots; repeat. Outputs come back
        ordered by request id. On a spec engine a chunk is ``chunk``
        propose/verify rounds (1 to k+1 tokens per live slot each) and the
        stats carry the acceptance counters. On a paged engine a request
        whose worst case (no prefix hit) the pool's free and evictable
        pages cannot cover is requeued until a slot drains; with no slot
        active that is a deadlock, and ``OutOfPages`` is raised."""
        if chunk < 1 or num_slots < 1:
            raise ValueError("chunk and num_slots must be >= 1")
        t_start = time.perf_counter()
        sched = Scheduler(num_slots)
        for r in requests:
            if self.spec is not None:
                self._spec_budget_check(len(r.prompt), r.max_new_tokens)
            else:
                assert len(r.prompt) + r.max_new_tokens <= self.max_seq, r.rid
            sched.submit(r)
        spec_m = SpecMetrics.zeros(self.device)
        state = self.init_decode_state(num_slots, seed)
        if self.graphs is not None:
            # capture the greedy chunk before the first admission: a
            # capture costs an eager chunk of host time, which would land
            # in the first requests' TTFT. A chunk over empty slots writes
            # only rows an insert overwrites (or the dump page) and leaves
            # tokens, lengths and done flags as they are.
            self.decode_chunk(state, chunk)
        if self.prompt_graph and self.model.scans_prompts:
            self._prompt_graph()       # captured before the first admission
        clock, admissions, generated, requeues = 0, 0, 0, 0
        occupancy: list[float] = []
        gaps: list[float] = []
        while not sched.all_done():
            sched.poll(clock)
            stalled = False
            for slot in sched.free_slots():
                req = sched.next_ready(clock)
                if req is None:
                    break
                if self.pool is not None and not self.pool.can_admit(
                        self.pool.pages_for(self._slot_seq_budget(
                            len(req.prompt), req.max_new_tokens))):
                    # backpressure: the pool's free and evictable pages do
                    # not cover the worst case; retry after a slot drains
                    sched.requeue(req)
                    requeues += 1
                    stalled = True
                    break
                sched.assign(slot, req, clock, wall=time.perf_counter())
                temp = (req.temperature if req.temperature is not None
                        else temperature)
                try:
                    self.insert(state, slot,
                                self.prefill_request(req.prompt, state,
                                                     frames=req.frames),
                                req.max_new_tokens, temperature=temp,
                                top_k=req.top_k, top_p=req.top_p)
                except OutOfPages:
                    # insert unpinned the match and leaked nothing
                    sched.unassign(slot)
                    requeues += 1
                    stalled = True
                    break
                if occupancy and sched.num_active > 1:
                    admissions += 1    # joined a batch already mid-decode
            if sched.num_active == 0:
                if stalled:
                    raise OutOfPages(
                        "admission deadlock: no active slots and the pool "
                        "cannot supply the next request's pages "
                        f"({self.pool.num_pages} pages of "
                        f"{self.pool.page_size} tokens); size pool_pages "
                        "for the longest request")
                nxt = sched.next_arrival()
                if nxt is not None:
                    clock = max(clock + 1, nxt)    # idle: fast-forward
                continue
            occupancy.append(sched.num_active / num_slots)
            t0 = time.perf_counter()
            if self.spec is not None:
                state, m = self.decode_chunk(state, chunk)
                spec_m = spec_m.plus(m)
            else:
                self.decode_chunk(state, chunk)
            clock += chunk
            done_np = state.done.cpu().numpy()      # the one device read
            len_np = state.lengths.cpu().numpy()
            now = time.perf_counter()
            gaps.append(now - t0)
            for slot, req in sched.active_slots():
                if len_np[slot] > len(req.prompt):
                    sched.mark_first_token(slot, now)
                if not done_np[slot]:
                    continue
                n = int(len_np[slot])
                # copies: the slot's buffers are reused by the next request
                row = state.tokens[slot, :n].cpu().numpy().copy()
                lps = state.logprobs[slot, len(req.prompt):n].cpu().numpy(
                    ).copy()
                reason = ("eos" if self.eos_id is not None and n > 0
                          and row[-1] == self.eos_id else "length")
                sched.complete(slot, row, lps, reason, clock)
                self.release(state, slot)
                generated += n - len(req.prompt)
        wall = time.perf_counter() - t_start
        outputs = sorted(sched.finished, key=lambda o: o.rid)
        ttfts = [o.ttft_s for o in outputs if o.ttft_s is not None]
        tpots = [o.tpot_s for o in outputs if o.tpot_s is not None]
        proposed, accepted, committed, rounds = (int(v) for v in spec_m)
        pool_kw = {}
        if self.pool is not None:
            pool = self.pool
            pool.check_invariants()    # nothing leaked
            pool_kw = dict(
                pool_pages_total=pool.num_pages,
                pool_pages_peak=pool.peak_pages,
                pool_page_size=pool.page_size,
                prefix_hits=pool.prefix_hits,
                prefix_hit_tokens=pool.prefix_hit_tokens,
                prefix_hit_rate=(pool.prefix_hit_tokens / pool.prompt_tokens
                                 if pool.prompt_tokens else 0.0),
                cow_copies=pool.cow_copies,
                kv_bytes_peak=pool.peak_pages * self._page_bytes)
        stats = ServeStats(
            decode_steps=len(occupancy) * chunk, generated_tokens=generated,
            occupancy=float(np.mean(occupancy)) if occupancy else 0.0,
            num_chunks=len(occupancy), admissions=admissions, wall_s=wall,
            tokens_per_s=generated / wall if wall > 0 else 0.0,
            ttft_mean_s=float(np.mean(ttfts)) if ttfts else 0.0,
            ttft_p50_s=float(np.median(ttfts)) if ttfts else 0.0,
            tpot_p50_s=float(np.median(tpots)) if tpots else 0.0,
            decode_gap_p50_s=float(np.median(gaps)) if gaps else 0.0,
            spec_rounds=rounds, draft_proposed=proposed,
            draft_accepted=accepted,
            acceptance_rate=accepted / proposed if proposed else 0.0,
            tokens_per_round=committed / rounds if rounds else 0.0,
            requeues=requeues, **pool_kw)
        return outputs, stats

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

    def kv_bytes_allocated(self, num_slots: int = 1) -> float:
        """Attention-cache bytes held right now. A dense engine reserves
        every slot at full depth up front (``num_slots`` times
        ``kv_bytes_per_slot()``); a paged engine charges only the pool
        pages referenced now, a shared prefix page once."""
        if self.pool is None:
            return num_slots * self.kv_bytes_per_slot()
        return self.pool.pages_in_use * self._page_bytes

    @staticmethod
    def _weight_bytes(params) -> float:
        return sum(v.nbytes_effective() if isinstance(v, SegmentedParams)
                   else tree_nbytes(v) for v in params.values())

    def weight_bytes(self) -> float:
        """Effective weight bytes (ternary counted at 1.58 bits)."""
        return self._weight_bytes(self.params)
