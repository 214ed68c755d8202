"""Slot-based decode state for continuous batching.

The engine decodes a fixed number of *slots* in lockstep; each slot holds at
most one in-flight request. ``DecodeState`` keeps every per-slot buffer on
the device, and the helpers below update it in place:

* ``tokens`` / ``logprobs`` are (B, S_max) buffers written at
  ``lengths[slot]`` (done and empty slots never advance);
* ``cache`` is the family's KV cache in the slotted layout (``pos`` is a
  (B,) vector); with a quantized KV plan its K/V fields are KVPages and
  admission quantizes the prefilled K/V on insert;
* ``insert_request`` overwrites one slot with a prefilled request;
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
                   top_p: float = 1.0) -> DecodeState:
    """Admit one prefilled request into ``slot``, in place. ``prompt``:
    (P,) int32; ``prompt_cache``/``last_logits`` come from a batch=1
    prefill (cache pos == P). The whole slot row is reset."""
    p = prompt.shape[0]
    state.tokens[slot] = 0
    state.tokens[slot, :p] = prompt.to(torch.int32)
    model.insert_cache_slot(state.cache, prompt_cache, slot)
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


def release_slot(state: DecodeState, slot: int) -> DecodeState:
    """Evict a finished request: the slot becomes admissible again."""
    state.done[slot] = True
    state.active[slot] = False
    state.host_temperature[slot] = 0.0
    state.host_top_k[slot] = 0
    state.host_top_p[slot] = 1.0
    return state
