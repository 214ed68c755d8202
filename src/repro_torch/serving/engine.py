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
    ``decode_step``. Nothing in a chunk waits for the device.
  * ``serve`` is continuous batching: between chunks the host-side
    Scheduler admits queued requests into freed slots and harvests finished
    ones (one device read per chunk).
  * ``generate`` drains one fixed batch through the same loop.

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
from repro_torch.quant.apply import (SegmentedParams, segment_slices,
                                     tree_nbytes)
from repro_torch.quant.compiler import compile_kv_plan
from repro_torch.quant.kvcache import (DEFAULT_KV_GROUP, KVPlan,
                                       kv_field_nbytes, quantize_model_cache)
from repro_torch.serving import batch as B
from repro_torch.serving import sampling as S
from repro_torch.serving.quantized import apply_plan_to_params
from repro_torch.serving.scheduler import Request, RequestOutput, Scheduler

DEFAULT_CHUNK = 8


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Raises when no GPU is present (pass
    ``device="cpu"`` to run the plain versions on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch serves on a CUDA GPU and none is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


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


class ServeEngine:
    """``params`` must live on ``device`` (``bridge.from_jax`` and
    ``Model.init`` take a device)."""

    def __init__(self, model, params, *, max_seq: int,
                 plan: Optional[QuantPlan] = None, group: int = 128,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 kv_precision="bf16", kv_group: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.cfg
        self.max_seq = max_seq
        self.plan = plan
        self.eos_id = eos_id
        self.pad_id = pad_id
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
        """Page boundaries = the weight stack's segment boundaries."""
        return tuple(lo for _, lo, _ in
                     segment_slices(self.params["layers"])[1:])

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
    def prefill(self, prompts):
        """(B, P) prompts -> (raw cache padded to max_seq at pos P,
        last-token logits (B, V_pad))."""
        toks = self._tokens(prompts)
        b, s = toks.shape
        assert s <= self.max_seq, (s, self.max_seq)
        logits, cache = self.model.module.apply(
            self.params, toks, self.cfg, return_cache=True, last_only=True)
        shape = cache.k.shape[:2] + (self.max_seq,) + cache.k.shape[3:]
        k = torch.zeros(shape, dtype=cache.k.dtype, device=self.device)
        v = torch.zeros(shape, dtype=cache.v.dtype, device=self.device)
        k[:, :, :s] = cache.k
        v[:, :, :s] = cache.v
        return cache._replace(k=k, v=v), logits[:, 0]

    def prefill_request(self, prompt) -> Prefill:
        """Prefill ONE request (1-D prompt)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        cache, logits = self.prefill(prompt[None])
        return Prefill(prompt=prompt, cache=cache, last_logits=logits)

    # -- slotted decode ----------------------------------------------------------
    def init_decode_state(self, num_slots: int, seed: int = 0
                          ) -> B.DecodeState:
        cache = self._wrap_cache(self.model.slotted_cache(
            num_slots, self.max_seq, self.device))
        return B.init_state(self.model, num_slots, self.max_seq, self.device,
                            cache=cache, seed=seed)

    @torch.no_grad()
    def insert(self, state: B.DecodeState, slot: int, pf: Prefill,
               max_new: int, *, temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0) -> B.DecodeState:
        """Admit a prefilled request into ``slot`` (quantize-on-insert)."""
        return B.insert_request(
            self.model, state, slot, self._tokens(pf.prompt), pf.cache,
            pf.last_logits, max_new, temperature, top_k, top_p)

    def release(self, state: B.DecodeState, slot: int) -> B.DecodeState:
        return B.release_slot(state, slot)

    @torch.no_grad()
    def _step(self, st: B.DecodeState) -> None:
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
        st.done = done
        logits, st.cache = self.model.decode_step(self.params, st.cache,
                                                  nxt[:, None].long())
        st.last_logits = logits[:, 0].float()

    def decode_chunk(self, state: B.DecodeState,
                     steps: int = DEFAULT_CHUNK) -> B.DecodeState:
        """Run ``steps`` decode steps over every slot; does not wait for
        the device."""
        for _ in range(steps):
            self._step(state)
        return state

    # -- generation ---------------------------------------------------------------
    @torch.no_grad()
    def generate(self, prompts, max_new_tokens: int,
                 temperature: float = 0.0, chunk: Optional[int] = None,
                 seed: int = 0) -> GenerateResult:
        """One fixed batch: batched prefill, then chunks until every row
        has ``max_new_tokens`` tokens (or hit EOS)."""
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        toks = self._tokens(prompts)
        b, p = toks.shape
        total = p + max_new_tokens
        assert total <= self.max_seq, (total, self.max_seq)
        state = self.init_decode_state(b, seed)
        cache, last = self.prefill(toks.cpu().numpy())
        for i in range(b):
            one = cache._replace(k=cache.k[:, i:i + 1], v=cache.v[:, i:i + 1])
            B.insert_request(self.model, state, i, toks[i], one,
                             last[i:i + 1], max_new_tokens, temperature)
        chunk = max_new_tokens if chunk is None else min(chunk,
                                                         max_new_tokens)
        steps = 0
        while True:
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
        ordered by request id."""
        if chunk < 1 or num_slots < 1:
            raise ValueError("chunk and num_slots must be >= 1")
        t_start = time.perf_counter()
        sched = Scheduler(num_slots)
        for r in requests:
            assert len(r.prompt) + r.max_new_tokens <= self.max_seq, r.rid
            sched.submit(r)
        state = self.init_decode_state(num_slots, seed)
        clock, admissions, generated = 0, 0, 0
        occupancy: list[float] = []
        gaps: list[float] = []
        while not sched.all_done():
            sched.poll(clock)
            for slot in sched.free_slots():
                req = sched.next_ready(clock)
                if req is None:
                    break
                sched.assign(slot, req, clock, wall=time.perf_counter())
                if occupancy and sched.num_active > 1:
                    admissions += 1    # joined a batch already mid-decode
                temp = (req.temperature if req.temperature is not None
                        else temperature)
                self.insert(state, slot, self.prefill_request(req.prompt),
                            req.max_new_tokens, temperature=temp,
                            top_k=req.top_k, top_p=req.top_p)
            if sched.num_active == 0:
                nxt = sched.next_arrival()
                if nxt is not None:
                    clock = max(clock + 1, nxt)    # idle: fast-forward
                continue
            occupancy.append(sched.num_active / num_slots)
            t0 = time.perf_counter()
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
        stats = ServeStats(
            decode_steps=len(occupancy) * chunk, generated_tokens=generated,
            occupancy=float(np.mean(occupancy)) if occupancy else 0.0,
            num_chunks=len(occupancy), admissions=admissions, wall_s=wall,
            tokens_per_s=generated / wall if wall > 0 else 0.0,
            ttft_mean_s=float(np.mean(ttfts)) if ttfts else 0.0,
            ttft_p50_s=float(np.median(ttfts)) if ttfts else 0.0,
            tpot_p50_s=float(np.median(tpots)) if tpots else 0.0,
            decode_gap_p50_s=float(np.median(gaps)) if gaps else 0.0)
        return outputs, stats

    # -- accounting ----------------------------------------------------------------
    def kv_bytes_per_slot(self) -> float:
        """Attention-cache bytes one decode slot holds at ``max_seq``
        (K/V payloads + per-group scales), from a one-slot cache built on
        the meta device (shapes only, no memory)."""
        cache = self._wrap_cache(self.model.slotted_cache(1, self.max_seq,
                                                          "meta"))
        return float(sum(kv_field_nbytes(getattr(cache, name))
                         for name in self.model.kv_cache_fields))

    def weight_bytes(self) -> float:
        """Effective weight bytes (ternary counted at 1.58 bits)."""
        total = 0.0
        for v in self.params.values():
            total += (v.nbytes_effective() if isinstance(v, SegmentedParams)
                      else tree_nbytes(v))
        return total
