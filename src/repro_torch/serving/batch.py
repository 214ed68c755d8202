"""Slot-based decode state for continuous batching.

The engine decodes a fixed number of *slots* in lockstep; each slot holds at
most one in-flight request. ``DecodeState`` keeps every per-slot buffer on
the device, and every update writes into those buffers in place (the
helpers below, the engine's decode step, the spec round): a decode chunk
replayed from a CUDA graph (``serving/graphs.py``) reads and writes the
addresses it was captured with, so a tensor that got rebound would
silently go stale.

* ``tokens`` / ``logprobs`` are (B, S_max) buffers written at
  ``lengths[slot]`` (done and empty slots never advance);
* ``cache`` is the family's KV cache in the slotted layout (``pos`` is a
  (B,) vector); with a quantized KV plan its K/V fields are KVPages (or
  PagedKV pools on a paged engine) and admission quantizes the prefilled
  K/V on insert; an SSM or hybrid cache also holds per-slot conv/state
  (slot axis 1), which insert overwrites and release leaves to the next
  insert;
* ``insert_request`` overwrites one slot with a prefilled request;
  ``commit_tokens`` appends a speculative round's tokens;
  ``release_slot`` drops the slot's active flag.

The sampling controls are also mirrored on the host (``host_*``), so the
decode loop knows without a device sync whether any slot samples.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass
class DecodeState:
    cache: Any                  # family cache, slotted layout (pos: (B,))
    last_logits: torch.Tensor   # (B, V_pad) f32 logits after the last token
    tokens: torch.Tensor        # (B, S_max) int32 prompt + generated tokens
    lengths: torch.Tensor       # (B,) int32 valid tokens per row
    max_len: torch.Tensor       # (B,) int32 a slot stops at this length
    done: torch.Tensor          # (B,) bool finished generating
    active: torch.Tensor        # (B,) bool slot holds a live request
    logprobs: torch.Tensor      # (B, S_max) f32 chosen-token logprobs
    temperature: torch.Tensor   # (B,) f32, 0 = greedy
    top_k: torch.Tensor         # (B,) int32, 0 = disabled
    top_p: torch.Tensor         # (B,) f32, >= 1 = disabled
    gen: torch.Generator        # draws for temperature sampling
    host_temperature: np.ndarray
    host_top_k: np.ndarray
    host_top_p: np.ndarray

    @property
    def num_slots(self) -> int:
        return self.tokens.shape[0]

    @property
    def samples(self) -> bool:
        return bool((self.host_temperature > 0).any())

    @property
    def masks(self) -> bool:
        return bool((self.host_top_k > 0).any() or (self.host_top_p < 1).any())


def init_state(model, num_slots: int, max_seq: int, device, cache=None,
               seed: int = 0) -> DecodeState:
    """All slots empty: inactive, done, zero-length."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return DecodeState(
        cache=cache if cache is not None
        else model.slotted_cache(num_slots, max_seq, dev),
        last_logits=torch.zeros((num_slots, model.cfg.padded_vocab),
                                dtype=torch.float32, device=dev),
        tokens=torch.zeros((num_slots, max_seq), dtype=torch.int32,
                           device=dev),
        lengths=torch.zeros((num_slots,), dtype=torch.int32, device=dev),
        max_len=torch.zeros((num_slots,), dtype=torch.int32, device=dev),
        done=torch.ones((num_slots,), dtype=torch.bool, device=dev),
        active=torch.zeros((num_slots,), dtype=torch.bool, device=dev),
        logprobs=torch.zeros((num_slots, max_seq), dtype=torch.float32,
                             device=dev),
        temperature=torch.zeros((num_slots,), dtype=torch.float32,
                                device=dev),
        top_k=torch.zeros((num_slots,), dtype=torch.int32, device=dev),
        top_p=torch.ones((num_slots,), dtype=torch.float32, device=dev),
        gen=gen,
        host_temperature=np.zeros(num_slots, np.float32),
        host_top_k=np.zeros(num_slots, np.int32),
        host_top_p=np.ones(num_slots, np.float32))


def insert_request(model, state: DecodeState, slot: int,
                   prompt: torch.Tensor, prompt_cache: Any,
                   last_logits: torch.Tensor, max_new: int,
                   temperature: float = 0.0, top_k: int = 0,
                   top_p: float = 1.0, page_rows=None) -> DecodeState:
    """Admit one prefilled request into ``slot``, in place. ``prompt``:
    (P,) int32; ``prompt_cache``/``last_logits`` come from a batch=1
    prefill (cache pos == P). The whole slot row is reset. ``page_rows``:
    (row, wrow) page-table rows from the pool allocator, needed when the
    cache holds paged fields."""
    p = prompt.shape[0]
    state.tokens[slot] = 0
    state.tokens[slot, :p] = prompt.to(torch.int32)
    model.insert_cache_slot(state.cache, prompt_cache, slot,
                            page_rows=page_rows)
    state.last_logits[slot] = last_logits.reshape(-1).float()
    state.lengths[slot] = p
    state.max_len[slot] = p + max_new
    state.done[slot] = False
    state.active[slot] = True
    state.logprobs[slot] = 0.0
    state.temperature[slot] = temperature
    state.top_k[slot] = top_k
    state.top_p[slot] = top_p
    state.host_temperature[slot] = temperature
    state.host_top_k[slot] = top_k
    state.host_top_p[slot] = top_p
    return state


def commit_tokens(state: DecodeState, cand: torch.Tensor,
                  cand_lp: torch.Tensor, counts: torch.Tensor) -> DecodeState:
    """Append up to K+1 tokens per slot in one step (speculative commit).
    ``cand``/``cand_lp``: (B, K+1) candidate tokens and their
    chosen-token logprobs; ``counts`` (B,): how many leading candidates
    each slot keeps (0 for done and empty slots). Candidate j lands at
    ``lengths[slot] + j``; ``lengths`` advances by ``counts``; all three
    buffers are written in place. The caller handles done flags and the
    cache rollback."""
    dev = cand.device
    jidx = torch.arange(cand.shape[1], device=dev)[None, :]
    wpos = state.lengths[:, None] + jidx                      # (B, K+1)
    # (B, K+1, S_max): candidate j goes to column wpos[:, j]; positions
    # past the buffer are dropped, as a JAX scatter drops them
    at = ((torch.arange(state.tokens.shape[1], device=dev)[None, None, :]
           == wpos[:, :, None]) & (jidx < counts[:, None])[:, :, None])
    hit = at.any(dim=1)
    zero = torch.zeros((), dtype=cand_lp.dtype, device=dev)
    toks = torch.where(at, cand[:, :, None], 0).sum(dim=1)
    lps = torch.where(at, cand_lp[:, :, None], zero).sum(dim=1)
    state.tokens.copy_(torch.where(hit, toks.to(state.tokens.dtype),
                                   state.tokens))
    state.logprobs.copy_(torch.where(hit, lps.to(state.logprobs.dtype),
                                     state.logprobs))
    state.lengths.add_(counts.to(state.lengths.dtype))
    return state


def release_slot(state: DecodeState, slot: int) -> DecodeState:
    """Evict a finished request: the slot becomes admissible again."""
    state.done[slot] = True
    state.active[slot] = False
    state.host_temperature[slot] = 0.0
    state.host_top_k[slot] = 0
    state.host_top_p[slot] = 1.0
    return state
