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

Over a mesh (``shard_state``) the cache is a ``MeshCache``: the slots split
evenly over the rows of the data axes, and within a row the KV heads split
over the "model" positions (a ``TPCache``); the per-slot bookkeeping
buffers stay whole on the mesh's first device, so the scheduler reads any
slot without a gather. ``decode_rows`` runs one decode step row by row.
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


class MeshCache:
    """A slotted cache laid over a mesh: ``rows[r]`` holds slots
    ``[r * slots_per_row, (r + 1) * slots_per_row)`` of data row r, as the
    family cache of its one position or, over several "model" positions,
    a ``TPCache`` of each position's KV heads; ``devices[r][m]`` is the
    device of row r's position m."""

    def __init__(self, rows: list, slots_per_row: int, devices: list):
        self.rows = rows
        self.slots_per_row = slots_per_row
        self.devices = devices

    def locate(self, slot: int) -> tuple[int, int]:
        """(row, slot within the row) of a global slot."""
        return divmod(int(slot), self.slots_per_row)

    def positions(self) -> list:
        """Every position's family cache, row by row."""
        from repro_torch.sharding.collective import TPCache
        return [c for row in self.rows
                for c in (row.parts if isinstance(row, TPCache) else [row])]

    def insert(self, model, one, slot: int) -> None:
        """Write a batch=1 prefill cache (a family cache, or a ``TPCache``
        of the row-0 group's heads) into ``slot``, in place, each part
        copied to its position's device."""
        from repro_torch.sharding.collective import TPCache
        r, local = self.locate(slot)
        row = self.rows[r]
        dsts = row.parts if isinstance(row, TPCache) else [row]
        srcs = one.parts if isinstance(one, TPCache) else [one]
        for dst, src, dev in zip(dsts, srcs, self.devices[r]):
            model.insert_cache_slot(dst, _cache_to(src, dev), local)


def _cache_to(cache, device):
    """A raw family cache's fields on ``device`` (no copy where they are
    already there)."""
    return type(cache)(*(f.to(device) for f in cache))


def _zeros_like_slice(x: torch.Tensor, index: tuple, device) -> torch.Tensor:
    """A contiguous copy of ``x[index]`` on ``device`` (zeros when ``x``
    is a meta tensor: a cache placed before anything is written)."""
    view = x[index]
    out = torch.zeros(view.shape, dtype=x.dtype, device=device)
    if x.device.type != "meta":
        out.copy_(view)
    return out


def _check_heads(cache, mesh, t: int) -> None:
    """The rules must shard the KV heads over "model" (dim 3 of a raw
    (L, B, S, Hkv, hd) field); where the heads do not divide, the rules
    shard the sequence instead, a layout the port does not serve."""
    from repro_torch.sharding.specs import cache_specs
    specs = cache_specs(cache, mesh)
    for name in ("k", "v"):
        spec = getattr(specs, name)
        if t > 1 and (len(spec) < 4 or spec[3] != "model"):
            raise ValueError(
                f"cache field {name!r} {tuple(getattr(cache, name).shape)} "
                f"shards as {spec} over |model| = {t}: the KV heads do not "
                f"divide the model axis, and the sequence-sharded KV "
                f"fallback is not ported (ROADMAP.md queue 1 item 10)")


def split_heads(cache, devices: list, wrap=None):
    """A family cache's KV heads split over a row's "model" positions (a
    ``TPCache``; the cache itself, wrapped, for one position): every field
    a contiguous copy on its position's device (zeros from the meta
    device), K/V with their slice of the heads."""
    from repro_torch.sharding.collective import TPCache
    t = len(devices)
    parts = []
    for m, dev in enumerate(devices):
        fields = []
        for name, x in zip(cache._fields, cache):
            index = [slice(None)] * x.ndim
            if t > 1 and name in ("k", "v"):
                hkv = x.shape[3] // t
                index[3] = slice(m * hkv, (m + 1) * hkv)
            fields.append(_zeros_like_slice(x, tuple(index), dev))
        part = type(cache)(*fields)
        parts.append(part if wrap is None else wrap(part))
    return TPCache(parts) if t > 1 else parts[0]


def shard_cache(cache, mesh, model, wrap=None) -> MeshCache:
    """Place a slotted family cache (on the meta device, or holding data)
    over ``mesh``: the slots split over the data rows, the KV heads over
    the model positions of each row (``split_heads``). ``wrap`` (the
    engine's KV plan) quantizes each position's raw cache into its
    pages."""
    from repro_torch.sharding.specs import position_grid
    grid = position_grid(mesh)
    r_n, t = grid.shape
    b = cache.pos.shape[0]
    if b % r_n:
        raise ValueError(f"{b} slots do not split over {r_n} data rows; "
                         f"give the engine a multiple of {r_n} slots")
    if t > 1:
        _check_heads(cache, mesh, t)
    per = b // r_n
    rows, devices = [], []
    for r in range(r_n):
        devs = [mesh.devices[grid[r, m]] for m in range(t)]
        slots = type(cache)(*(x.narrow(axis, r * per, per) for x, axis in
                              zip(cache, model.cache_batch_axes)))
        rows.append(split_heads(slots, devs, wrap))
        devices.append(devs)
    return MeshCache(rows, per, devices)


def state_specs(state: DecodeState, mesh) -> dict:
    """P tree of a DecodeState on ``mesh``, by field: the family cache by
    ``sharding.specs.cache_specs`` (KV heads, or the GQA sequence fallback,
    over "model"; the slot dim over the data axes), every per-slot
    bookkeeping buffer replicated."""
    from repro_torch.sharding.specs import P, cache_specs
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "cache":
            out[f.name] = cache_specs(v, mesh)
        elif isinstance(v, torch.Tensor):
            out[f.name] = P()
    return out


def shard_state(state: DecodeState, mesh, model, wrap=None) -> DecodeState:
    """``state`` with its cache placed over ``mesh`` (``shard_cache``);
    the bookkeeping buffers stay where they are."""
    return dataclasses.replace(state, cache=shard_cache(state.cache, mesh,
                                                        model, wrap))


def constrain_state(state: DecodeState, mesh) -> DecodeState:
    """Check that ``state``'s cache keeps the layout ``shard_state`` laid:
    one entry per data row, each position's cache on its device with the
    row's slots. Returns ``state``."""
    from repro_torch.sharding.specs import position_grid
    cache = state.cache
    grid = position_grid(mesh)
    assert isinstance(cache, MeshCache), type(cache)
    assert len(cache.rows) == grid.shape[0], (len(cache.rows), grid.shape)
    devs = [d for row in cache.devices for d in row]
    for part, dev in zip(cache.positions(), devs):
        assert part.pos.device == dev, (part.pos.device, dev)
        assert part.pos.shape[0] == cache.slots_per_row, part.pos.shape
    return state


def decode_rows(model, groups: list, cache: MeshCache,
                tokens: torch.Tensor) -> torch.Tensor:
    """One decode step over a ``MeshCache``: data row r steps its slots
    with ``groups[r]`` (a parameter tree, or a ``TPGroup``), writing its
    caches in place; returns the logits of every slot, rows gathered on
    the first device."""
    from repro_torch.sharding.collective import TPCache, gather
    per = cache.slots_per_row
    outs = []
    for r, (group, row) in enumerate(zip(groups, cache.rows)):
        toks = tokens[r * per:(r + 1) * per].to(cache.devices[r][0])
        logits, new = model.decode_step(group, row, toks)
        olds = row.parts if isinstance(row, TPCache) else [row]
        news = new.parts if isinstance(new, TPCache) else [new]
        for old, nw in zip(olds, news):
            old.pos.copy_(nw.pos)
        outs.append(logits)
    return gather(outs, cache.devices[0][0], dim=0)


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
    if isinstance(state.cache, MeshCache):
        state.cache.insert(model, prompt_cache, slot)
    else:
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
