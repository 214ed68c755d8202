"""Self-speculative decode loop: draft-propose / target-verify rounds.

One round, over every slot at once:

1. **Propose.** The all-int4 draft (which shares the target's tensors for
   already-aggressive blocks) runs K single-token steps from each slot's
   *pending* token and samples K proposals from its masked distribution
   q. The fused propose (``fused_propose=True``) only reads the cache: each
   step's K/V go to small raw side buffers that decode attention sweeps
   with the cache. The two-pass propose runs the draft's ``decode_step`` on
   a clone of the cache, because the port writes cache pages in place.
   With ``draft_source="ngram"`` the proposals come from prompt lookup
   instead (no draft model runs), and q is the one-hot of the copied
   tokens.
2. **Verify.** The target scores the (K+1)-token window ``[pending,
   x_1..x_K]`` in one multi-query decode step (``Model.spec_verify``),
   giving the target distribution p_i at every draft position plus the
   bonus position.
3. **Accept.** Greedy slots accept the longest prefix with ``x_i ==
   argmax p_i`` (token-identical to the non-spec engine by construction);
   sampling slots run speculative rejection sampling: accept with
   probability min(1, p_i(x) / q_i(x)), on the first rejection draw from
   the normalized residual ``max(p - q, 0)``, and draw a bonus token from
   p_{K+1} when all K are accepted. A live slot commits 1 to K+1 tokens.
4. **Rollback.** ``Model.spec_commit`` moves each slot's cache position to
   its committed length; the rows past it stay in memory, masked invalid.

Invariant between rounds (per slot): ``cache.pos == lengths - 1``, and the
pending token ``tokens[lengths - 1]`` has no cache row yet; the next
verify writes it. Admission is the baseline's (full-prompt prefill,
``cache.pos == lengths``): such *fresh* slots take their candidate-0
distribution from ``last_logits`` (the prefill logits the baseline samples
its first token from, which keeps greedy output exact over a quantized
cache) and verify ``[x_1..x_K, x_K]`` instead.

Randomness comes from the slot state's ``torch.Generator``; it cannot
reproduce the JAX package's bits, so only greedy output is compared token
for token, and the sampler's exactness is tested by its distribution.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.models.common import dtype_of
from repro_torch.quant.apply import segment_slices
from repro_torch.quant.kvcache import clone_cache
from repro_torch.serving import batch as B
from repro_torch.serving.sampling import masked_dist, sample

NEG_INF = -1e30
_TINY = 1e-38


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Self-speculative serving knobs.

    ``k``: draft tokens proposed per round (the verify window is k+1
    wide). ``draft_group``: quantization group of the draft-only int4
    copies. ``fused_propose``: run the draft through the read-only propose
    (zero draft-side cache writes); the two-pass propose on a cache clone
    is the other path and the parity oracle. ``draft_layers``: truncate the
    draft to its first N layers (needs ``fused_propose``). ``draft_source``:
    "model" runs the int4 self-draft, "ngram" proposes by prompt lookup
    (match the context's trailing bigram, copy the k tokens that followed
    it). Verification is the same either way, so greedy output never
    depends on the draft."""
    k: int = 4
    draft_group: int = 128
    fused_propose: bool = True
    draft_layers: Optional[int] = None
    draft_source: str = "model"

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")
        if self.draft_source not in ("model", "ngram"):
            raise ValueError(f"draft_source must be 'model' or 'ngram', "
                             f"got {self.draft_source!r}")
        if self.draft_source == "ngram" and self.draft_layers is not None:
            raise ValueError("draft_layers only applies to the model "
                             "draft; the ngram draft runs no model")
        if self.draft_layers is not None:
            if self.draft_layers < 1:
                raise ValueError(f"draft_layers must be >= 1, got "
                                 f"{self.draft_layers}")
            if not self.fused_propose:
                raise ValueError(
                    "draft_layers needs fused_propose=True: the two-pass "
                    "propose runs the draft through decode_step, whose "
                    "cache segmentation must match the full target stack")


class SpecMetrics(NamedTuple):
    """Counters summed over rounds and slots (0-d device tensors, read by
    the host once per chunk)."""
    proposed: torch.Tensor    # draft tokens proposed to live slots
    accepted: torch.Tensor    # draft tokens verified AND committed
    committed: torch.Tensor   # tokens committed (incl. bonus/correction)
    rounds: torch.Tensor      # rounds with at least one live slot

    @staticmethod
    def zeros(device) -> "SpecMetrics":
        return SpecMetrics(*(torch.zeros((), dtype=torch.int64,
                                         device=device) for _ in range(4)))

    def plus(self, other: "SpecMetrics") -> "SpecMetrics":
        return SpecMetrics(*(a + b for a, b in zip(self, other)))


def accept(p: torch.Tensor, q: torch.Tensor, x: torch.Tensor,
           temperature: torch.Tensor, gen: torch.Generator,
           sampling: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Longest-prefix acceptance. ``p`` (B, K+1, V) target log-dists, ``q``
    (B, K, V) draft log-dists, ``x`` (B, K) proposals. Returns ``a`` (B,),
    the accepted prefix length, and ``z`` (B,), the correction (a < K) or
    bonus (a == K) token. Greedy rows (temperature 0) accept ``x_i ==
    argmax p_i``; with ``sampling``, rows with temperature > 0 run
    rejection sampling, which makes the committed tokens follow p exactly
    whatever q is."""
    k = x.shape[1]
    y = torch.argmax(p, dim=-1)                              # (B, K+1)
    acc = x == y[:, :k]
    if sampling:
        px = p[:, :k].gather(-1, x[..., None])[..., 0]
        qx = q.gather(-1, x[..., None])[..., 0]
        u = torch.rand(x.shape, generator=gen, device=x.device)
        stoch = torch.log(u.clamp(min=_TINY)) < px - qx      # u < p / q
        acc = torch.where(temperature[:, None] > 0, stoch, acc)
    a = torch.cumprod(acc.to(torch.int64), dim=1).sum(dim=1)
    z = y.gather(1, a[:, None])[:, 0]
    if sampling:
        idx = a[:, None, None].expand(-1, 1, p.shape[-1])
        pa = p.gather(1, idx)[:, 0]                          # (B, V)
        q_ext = torch.cat([q, torch.full_like(q[:, :1], NEG_INF)], dim=1)
        qa = q_ext.gather(1, idx)[:, 0]
        resid = (torch.exp(pa) - torch.exp(qa)).clamp(min=0.0)
        rsum = resid.sum(dim=-1, keepdim=True)
        resid = torch.where(rsum > 0, resid / rsum.clamp(min=_TINY),
                            torch.exp(pa))
        z_st = torch.multinomial(resid, 1, generator=gen)[:, 0]
        z = torch.where(temperature > 0, z_st, z)
    return a, z


def _ngram_propose(state: B.DecodeState, pending: torch.Tensor, k: int,
                   vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Prompt-lookup proposals: match the trailing bigram [prev, pending]
    against earlier committed context and copy the k tokens that followed
    the latest match. On a miss, or where the copy runs off the committed
    context, re-propose the pending token (verification rejects it for
    free). q is the one-hot of the proposals. Returns (x, q)."""
    toks = state.tokens.long()
    lengths = state.lengths.long()
    s_max = toks.shape[1]
    dev = toks.device
    prev = toks.gather(1, (lengths - 2).clamp(min=0)[:, None])[:, 0]
    pos = torch.arange(s_max, device=dev)[None, :]
    shifted = torch.cat([toks[:, :1], toks[:, :-1]], dim=1)
    hit = ((toks == pending[:, None]) & (shifted == prev[:, None])
           & (pos >= 1) & (pos < (lengths - 1)[:, None]))
    j = torch.where(hit, pos, torch.full_like(pos, -1)).amax(dim=1)
    src = j[:, None] + 1 + torch.arange(k, device=dev)[None, :]
    x = toks.gather(1, src.clamp(0, s_max - 1))
    ok = (j[:, None] >= 0) & (src < lengths[:, None])
    x = torch.where(ok, x, pending[:, None])
    q = torch.full((toks.shape[0], k, vocab), NEG_INF, dtype=torch.float32,
                   device=dev)
    q.scatter_(2, x[..., None], 0.0)
    return x, q


@torch.no_grad()
def spec_round(model, params, draft_params, state: B.DecodeState, k: int,
               eos_id, *, fused_propose: bool = False,
               draft_source: str = "model"
               ) -> tuple[B.DecodeState, SpecMetrics]:
    """One draft-propose / target-verify / accept / rollback round; the
    state is updated in place (every tensor keeps its address, so a chunk
    of rounds can be replayed from a CUDA graph) and returned with the
    round's counters. The round reads nothing back to the host."""
    cfg = model.cfg
    vocab = cfg.vocab_size
    dev = state.tokens.device
    live = state.active & ~state.done
    # fresh = just admitted: no pending row gap, and candidate 0's dist is
    # the prefill's last_logits
    fresh = state.cache.pos == state.lengths
    lengths = state.lengths.long()
    pending = state.tokens.long().gather(
        1, (lengths - 1).clamp(min=0)[:, None])[:, 0]
    sampling, masks = state.samples, state.masks
    temp, top_k, top_p = state.temperature, state.top_k, state.top_p

    # -- 1) propose K tokens ----------------------------------------------
    if draft_source == "ngram":
        x, q = _ngram_propose(state, pending, k, vocab)
    else:
        if fused_propose:
            n_draft = segment_slices(draft_params["layers"])[-1][2]
            fk = torch.zeros((n_draft, state.num_slots, k, cfg.num_kv_heads,
                              cfg.head_dim), dtype=dtype_of(cfg), device=dev)
            fv = torch.zeros_like(fk)
        else:
            dcache = clone_cache(state.cache)
        xs, qs, tok = [], [], pending
        for i in range(k):
            # (fresh slots feed their last prompt token once more, at pos
            # == lengths: a slightly stale q on the admission round, which
            # moves acceptance, never the output)
            if fused_propose:
                logits, fk, fv = model.draft_propose_step(
                    draft_params, state.cache, fk, fv, i, tok[:, None])
            else:
                logits, dcache = model.decode_step(draft_params, dcache,
                                                   tok[:, None])
            qd = masked_dist(torch.log_softmax(
                logits[:, 0, :vocab].float(), dim=-1), temp, top_k, top_p,
                need_mask=masks)
            tok = (sample(state.gen, qd, temp).long() if sampling
                   else torch.argmax(qd, dim=-1))
            xs.append(tok)
            qs.append(qd)
        x, q = torch.stack(xs, dim=1), torch.stack(qs, dim=1)

    # -- 2) verify the window in one multi-query step ---------------------
    stale_q = torch.cat([pending[:, None], x], dim=1)
    fresh_q = torch.cat([x, x[:, -1:]], dim=1)
    qtoks = torch.where(fresh[:, None], fresh_q, stale_q)
    logits, snap = model.spec_verify(params, state.cache, qtoks)
    lv = torch.log_softmax(logits[:, :, :vocab].float(), dim=-1)
    lp0 = torch.log_softmax(state.last_logits[:, :vocab].float(), dim=-1)
    lp_raw = torch.where(fresh[:, None, None],
                         torch.cat([lp0[:, None], lv[:, :k]], dim=1), lv)
    p = masked_dist(lp_raw, temp[:, None], top_k[:, None], top_p[:, None],
                    need_mask=masks)

    # -- 3) accept, then the correction / bonus token ---------------------
    a, z = accept(p, q, x, temp, state.gen, sampling)
    jidx = torch.arange(k + 1, device=dev)[None, :]
    x_pad = torch.cat([x, x[:, -1:]], dim=1)
    cand = torch.where(jidx == a[:, None], z[:, None], x_pad)
    # chosen-token logprobs under the UNMASKED target dist, as the
    # baseline's decode step records them
    cand_lp = lp_raw.gather(-1, cand[..., None])[..., 0]

    # -- 4) commit count: acceptance, token budget, first EOS -------------
    budget = (state.max_len - state.lengths).long().clamp(min=0)
    c = torch.minimum(a + 1, budget)
    if eos_id is not None:
        is_eos = cand == eos_id
        eos_cut = torch.where(is_eos.any(dim=1),
                              torch.argmax(is_eos.to(torch.int32), dim=1) + 1,
                              torch.full_like(c, k + 1))
        c = torch.minimum(c, eos_cut)
    c = torch.where(live, c, torch.zeros_like(c))
    B.commit_tokens(state, cand, cand_lp, c)
    done = state.done | (live & (state.lengths >= state.max_len))
    if eos_id is not None:
        done = done | (live & (is_eos & (jidx < c[:, None])).any(dim=1))
    state.done.copy_(done)
    # fresh slots never fed their pending token, so the cache keeps one
    # row less than the commit count (pos = lengths - 1 afterwards); the
    # verify wrote its rows in place, and the rollback is the position
    state.cache.pos.copy_(
        model.spec_commit(snap, (c - fresh.to(c.dtype)).clamp(min=0)).pos)

    # draft tokens actually COMMITTED: the last committed candidate is the
    # correction/bonus only when nothing cut the window short (c == a + 1)
    drafts = c - (c > a).to(c.dtype)
    metrics = SpecMetrics(
        proposed=live.sum() * k,
        accepted=torch.where(live, drafts, torch.zeros_like(drafts)).sum(),
        committed=c.sum(),
        rounds=live.any().to(torch.int64))
    return state, metrics


def make_spec_round(model, k: int, rounds: int, eos_id,
                    fused_propose: bool = False, draft_source: str = "model"):
    """``run(params, draft_params, state) -> (state, metrics)``: ``rounds``
    spec rounds in a Python loop, with no host read between them."""

    def run(params, draft_params, state: B.DecodeState):
        total = SpecMetrics.zeros(state.tokens.device)
        for _ in range(rounds):
            state, m = spec_round(model, params, draft_params, state, k,
                                  eos_id, fused_propose=fused_propose,
                                  draft_source=draft_source)
            total = total.plus(m)
        return state, total

    return run
