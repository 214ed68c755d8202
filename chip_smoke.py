"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card

Phases, each of which raises (and the script exits non-zero) on failure:

1. device: the card's name and power limit; TF32 off for f32 matmuls.
2. build: nvcc builds every kernel under src/repro_torch/csrc for sm_90a;
   each kernel's registers, static shared memory and spill bytes as
   ``-Xptxas -v`` reported them.
3. kernels: each hand-written kernel against its plain PyTorch version at
   the full-width shapes of the main paths (rtol = atol = 2e-2 on bf16
   inputs), timed with CUDA events (median of 20 after warm-up, L2 flushed
   before each call): the kernel, its plain version, and a PyTorch
   yardstick that the port itself never calls. The matmul kernels at
   llama3.2-3b's and whisper-medium's shapes, qmatmul and qkv also within
   QMATMUL_F32 of the f32 dequantized product, equal to the bit over two
   calls, with the launch each shape gets (grid, blocks per SM), and
   refusing a weight group other than 128; decode attention in its forms
   (attention_cases; each also within relative L2 ATTN_REL_L2 of its
   plain version): one
   query per slot, the speculative verify window (qs = K+1 queries, causal
   and not), and the fresh rows of the fused draft propose, slots whose
   valid rows end on the kernel's split boundaries, each again over a
   paged pool (pages of 64 rows and of 24, permuted tables, different for
   K and V, with a page mapped by two slots and dump entries past each
   allocation), where it must also equal the dense kernel on the gathered
   rows to the bit. Whisper-medium's shapes: the gelu form of the fused
   MLP (M = 1, 4 and the encoder's 1500), self-attention over its 448-row
   decoder cache and cross-attention (causal=False over 1500 rows, hd 64). The
   entropy kernel (within 1e-3 * max(1, |H|) and 1e-5 absolute, at the
   weight scale and the reference test's, with a weighted ragged tail) and
   the int8 quantize kernel (payload and scales equal to the bit).
4. serve: llama3.2-3b FULL (28 layers, d_model 3072) from seeded random
   weights, EWQ-planned on the card and served with int8 KV, then an
   explicit raw/int8/int4/ternary plan served with int4 KV. Every serve
   replays its decode chunks from CUDA graphs (the engine's default on the
   card); the EWQ serve runs again eagerly (``cuda_graphs=False``), which
   must give the same tokens and logprobs to the bit, and the graph serve
   with ``state.last_logits`` rebound in the step (a planted stale-buffer
   fault) must not. Each run also reports one decode chunk's wall time and,
   replayed, its device time and launches per step; four sampled requests
   (temperature 0.8, top-p 0.9) run from graphs and eagerly. One decode
   step through the kernels is then held against the plain versions
   (relative L2 of the logits), beside the readings that place that
   limit: the plain versions without their bf16 roundings, the plain
   versions with only the order of their f32 sums changed, and the kernels
   on params with one int4 layer's nibbles swapped (a planted fault the
   limit must catch).
4b. speculative serve: the EWQ plan with int8 KV and SpecConfig(k=4),
   once with the int4 self-draft (fused propose) and once with the ngram
   draft, on the same requests, each from CUDA graphs and eagerly (equal to
   the bit). Then, at the same limit: a 5-token verify
   window through the kernels against the plain versions and against five
   single-query decode steps; one fused propose step against a decode step
   on a clone of the cache, with the real cache unchanged to the byte; and
   the window run with causal=False (a planted fault the limit must catch).
4c. paged serve: phase 4's requests on the EWQ plan from an equal-memory
   paged pool with prefix sharing, eagerly and from CUDA graphs (equal to
   the bit, and tokens and logprobs identical to phase 4's dense run; one
   decode step's device time paged against dense); a shared-prefix stream
   (8 x (256 common + 32 own tokens)) from an 11-page pool, which must hit
   the prefix 7 times, requeue at least once, leak nothing and have a mean
   TTFT below the same stream without sharing (a hit's suffix is one
   multi-query step), beside that stream and dense; phase
   4b's model-draft speculative serve over the pool (tokens identical).
5. analysis: ``analyze_blocks`` over every matrix of llama3.2-3b FULL (197
   matrices) and of whisper-medium FULL through the entropy kernel
   (mode="kernel") and in plain tensor ops (mode="stream"), both timed;
   entropies within 1e-3 * max(1, |H|) and 1e-5, plan decisions equal
   wherever a block is farther from the thresholds than the measured
   difference.
4d. whisper serve: whisper-medium FULL (24 + 24 layers, d_model 1024)
   from seeded random weights, planned 4bit/8bit from phase 5's
   kernel-mode entropies, serves 8 requests with seeded frames at 4
   slots, int8 self and cross KV, from CUDA graphs, then eagerly (equal to
   the bit), then eagerly with every prompt run as single-token steps (the
   TTFT before prompts became one step); one decode step held to the plain
   versions at the same limit, each decoder layer's cross-attention output
   too (with the slots' cross caches rotated, a planted fault that limit
   must catch), and timed eager and from a CUDA graph.
6. a JSON line naming each kernel, then the device line last. Every
   kernel's launch count must have risen on the serve and analysis paths,
   except the int8 quantize kernel, which no path runs.

``--quick`` skips the timings and the lm_head shape (a short first call
after a kernel change); it checks the same M values as the full run.

Imports nothing of JAX; the port is imported from ``src/`` beside this file.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
TOL = dict(rtol=2e-2, atol=2e-2)
QUICK = "--quick" in sys.argv   # skip timings and the lm_head shape
SLOTS = 4                       # decode slots of the serve phase
SPEC_K = 4                      # draft tokens per speculative round
CHUNK = 8                       # decode steps (or spec rounds) per chunk
PAGE = 64                       # tokens per page of the paged KV pool


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def capture(torch, body):
    """``body`` captured into a CUDA graph (after one warm-up run on a side
    stream, as PyTorch's graph capture wants)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    return graph


def replay_ms(torch, graph, reps: int = 5) -> float:
    """Median device time of one replay, by CUDA events."""
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return sorted(times)[reps // 2]


class Timer:
    """Device time of one call. ``calls`` calls, each after writing a
    128 MiB buffer that pushes the 50 MB L2 out (every call reads its
    weights from device memory, as the main path's layer-by-layer sweep
    does), are captured in one CUDA graph and replayed; the same graph of
    flushes alone is subtracted. The graph takes the host's launch
    overhead out of the reading, so the time is the kernel's own."""

    def __init__(self, torch, calls: int = 20):
        self.torch = torch
        self.calls = calls
        self.flush_buf = torch.empty(32 << 20, dtype=torch.float32,
                                     device="cuda")
        self.flush_ms = replay_ms(torch, capture(torch, self._flushes))

    def _flushes(self):
        for _ in range(self.calls):
            self.flush_buf.zero_()

    def ms(self, fn) -> float:
        def body():
            for _ in range(self.calls):
                self.flush_buf.zero_()
                fn()
        graph = capture(self.torch, body)
        total = replay_ms(self.torch, graph)
        del graph
        return max(total - self.flush_ms, 0.0) / self.calls


def bound_ms(nbytes: float, flops: float,
             rate: float = BF16_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def qbytes(w) -> int:
    return w.data.numel() * w.data.element_size() + w.scale.numel() * 2


def serve_prompts(vocab: int) -> list:
    """The serve phase's 8 prompts: lengths 64-256 from numpy seed 0."""
    import numpy as np
    rng = np.random.RandomState(0)
    lens = rng.randint(64, 257, size=8)
    return [rng.randint(0, vocab, size=(n,)).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_pair(torch, gen, b: int, s: int, rows_needed, prec: str,
               seed: int, hkv: int = 8, hd: int = 128,
               page: int = PAGE) -> list:
    """One layer's K and V pools for ``b`` slots of ``s`` logical rows in
    pages of ``page`` tokens: slot i holds ceil(rows_needed[i] / page)
    pages at physical ids drawn by a seeded permutation, a different one
    for K and for V (a kernel that reads a pool through the other pool's
    table reads the wrong rows); the first page of the second slot that
    holds any is the first slot's (one physical page mapped by two slots,
    as a shared prefix is); every table entry past a slot's allocation is
    the dump page 0, filled with large garbage that no read may see. Rows
    are random, quantized with the page write math."""
    import numpy as np
    from repro_torch.quant.kvcache import PagedKV, make_page
    n_log = s // page
    need = [min(-(-int(r) // page), n_log) for r in rows_needed]
    owners = [i for i, n in enumerate(need) if n > 0][:2]
    shared = (owners[1], 0)
    unique = [(i, j) for i in range(b) for j in range(need[i])
              if (i, j) != shared]
    pools = []
    for k in range(2):
        perm = np.random.RandomState(seed + 1000 * k).permutation(
            len(unique)) + 1
        table = np.zeros((b, n_log), np.int32)
        for (i, j), pid in zip(unique, perm):
            table[i, j] = pid
        table[shared] = table[owners[0], 0]
        raw = torch.randn((len(unique) + 1, page, hkv, hd), generator=gen,
                          device="cuda")
        raw[0] *= 100.0
        pg = make_page(raw, prec, 64)
        pools.append(PagedKV(
            data=pg.data, scale=pg.scale,
            table=torch.from_numpy(table).cuda(), precision=prec,
            head_dim=hd, group=64, page_size=page))
    return pools


LLAMA_ATTN = (8, 3, 128)        # KV heads, query heads per KV head, head dim
WHISPER_ATTN = (16, 1, 64)


def attention_cases(torch):
    """Every decode attention case of phase 3, one at a time, from their own
    seeded generator (scripts/decode_attn_gate_mutants.py runs the same
    cases): dicts of ``kernel`` (its launch counter), ``shape``, ``q``,
    ``kp``, ``vp``, ``valid``, ``causal``, ``fresh`` (raw (fresh_k,
    fresh_v, base) or None) and ``extra`` (fields of the row).

    llama3.2-3b's heads: one query per slot at 8 slots x 2048 rows and at
    the serve phase's 4 slots x 1024 rows mid-decode; the verify window (qs
    = K+1, and 9 where shared memory is largest, causal and not) at the
    serve shape and at 8 x 2048, where slot 0's first queries see no row;
    the fresh rows of a draft propose at the serve shape, one case per
    propose step (count rows already written, base per slot); slots whose
    valid rows end on the kernel's split boundaries ("edges": L, L + 1,
    2 L - 1 for L = split_rows(3) = 128 rows). The same forms over paged
    pools (pages of 64 rows, and of 24 rows, which do not divide a split).
    whisper-medium's heads (one query row each, splits of split_rows(1) =
    256 rows): self-attention over its 448-row decoder cache at the split
    edges, cross-attention (causal=False) over 1500 encoder rows. Small
    cases ("f32q") run the kernel's other instantiations (hd 32, 64, 128
    with one or several query rows a KV head) on f32 q."""
    from repro_torch.kernels.decode_attn.ops import split_rows
    from repro_torch.quant.kvcache import make_page
    L, L1 = split_rows(LLAMA_ATTN[1]), split_rows(WHISPER_ATTN[1])
    gen = torch.Generator(device="cuda").manual_seed(1)
    lens = [len(p) for p in serve_prompts(128256)]
    serve_valid = [n + 16 for n in lens[:SLOTS]]
    big_valid = [0, 1, 1000, 2048, 517, 64, 1500, 2000]
    edge_valid = [L, L + 1, 2 * L - 1, 1024]
    all3, int8 = ("int8", "int4", "bf16"), ("int8",)

    def qkv(b, s, qs, geom):
        hkv, rep, hd = geom
        q = torch.randn((b, qs, hkv * rep, hd), generator=gen,
                        device="cuda").to(torch.bfloat16)
        kv = [torch.randn((b, s, hkv, hd), generator=gen, device="cuda")
              for _ in range(2)]
        return q, kv

    def valid_of(v):
        return torch.tensor(v, dtype=torch.int32, device="cuda")

    def shape(b, s, qs, geom, tail=""):
        hkv, rep, hd = geom
        return (f"B{b} S{s} Hkv{hkv} rep{rep} hd{hd}{tail}"
                + ("" if qs == 1 else f" qs{qs}"))

    def case(kernel, shp, q, kp, vp, valid, causal=True, fresh=None,
             **extra):
        return dict(kernel=kernel, shape=shp, q=q, kp=kp, vp=vp, valid=valid,
                    causal=causal, fresh=fresh, extra=extra)

    def needed(rows, qs):      # a window's last query sees ``rows`` rows
        return [v + qs - 1 if qs > 1 and v > 1 else v for v in rows]

    dense = [("decode_attn", 8, 2048, 1, True, big_valid, all3, LLAMA_ATTN,
              ""),
             ("decode_attn", SLOTS, 1024, 1, True, serve_valid, all3,
              LLAMA_ATTN, ""),
             ("decode_attn", SLOTS, 1024, 1, True, edge_valid, all3,
              LLAMA_ATTN, " edges"),
             ("decode_attn", SLOTS, WHISPER_MAX_SEQ, 1, True,
              [L1 - 1, L1, L1 + 1, WHISPER_MAX_SEQ], ("int8", "int4"),
              WHISPER_ATTN, " self edges"),
             ("decode_attn_window", SLOTS, 1024, SPEC_K + 1, True,
              serve_valid, all3, LLAMA_ATTN, ""),
             ("decode_attn_window", SLOTS, 1024, SPEC_K + 1, False,
              serve_valid, int8, LLAMA_ATTN, ""),
             ("decode_attn_window", SLOTS, 1024, 9, True, serve_valid, int8,
              LLAMA_ATTN, ""),
             ("decode_attn_window", SLOTS, 1024, SPEC_K + 1, True,
              edge_valid, int8, LLAMA_ATTN, " edges"),
             ("decode_attn_window", 8, 2048, SPEC_K + 1, True, big_valid,
              int8, LLAMA_ATTN, ""),
             ("decode_attn_cross", SLOTS, 1500, 1, False, [1500] * SLOTS,
              ("int8", "int4"), WHISPER_ATTN, " cross")]
    # the kernel's other instantiations: head dims 32 and 64 with several
    # query rows a KV head, 128 with one, and f32 q (as a float32 model
    # passes it); hd 32 leaves one scale per stored row (F / group odd)
    for geom, qs in (((2, 2, 32), 3), ((2, 1, 32), 1), ((2, 2, 64), 2),
                     ((2, 1, 128), 1)):
        dense.append(("decode_attn" if qs == 1 else "decode_attn_window", 2,
                      300, qs, True, [297, 129], all3, geom, " f32q"))
    for kname, b, s, qs, causal, rows, precs, geom, tail in dense:
        q, (kraw, vraw) = qkv(b, s, qs, geom)
        if tail == " f32q":
            q = q.float()
        valid = valid_of(needed(rows, qs))
        for prec in precs:
            kp, vp = make_page(kraw, prec, 64), make_page(vraw, prec, 64)
            yield case(kname, shape(b, s, qs, geom, tail), q, kp, vp, valid,
                       causal)
            del kp, vp
    sf = SPEC_K
    base = valid_of(serve_valid)
    hkv, rep, hd = LLAMA_ATTN
    _, (kraw, vraw) = qkv(SLOTS, 1024, 1, LLAMA_ATTN)
    fk, fv = (torch.randn((SLOTS, sf, hkv, hd), generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    for prec in ("int8", "int4"):
        kp, vp = make_page(kraw, prec, 64), make_page(vraw, prec, 64)
        for count in range(sf):
            q, _ = qkv(SLOTS, 0, 1, LLAMA_ATTN)
            yield case("decode_attn_fresh",
                       shape(SLOTS, 1024, 1, LLAMA_ATTN, f" Sf{sf} count{count}"),
                       q, kp, vp, base + count + 1, fresh=(fk, fv, base),
                       count=count)
        del kp, vp
    # the same forms over paged pools (permuted tables, a shared page and
    # dump entries), each also held to the dense kernel on the gathered rows
    # to the bit
    paged = [("decode_attn_paged", 8, 2048, 1, True, big_valid, all3, PAGE),
             ("decode_attn_paged_window", 8, 2048, SPEC_K + 1, True,
              big_valid, int8, PAGE),
             ("decode_attn_paged_window", SLOTS, 1024, SPEC_K + 1, True,
              serve_valid, all3, PAGE),
             ("decode_attn_paged_window", SLOTS, 1024, SPEC_K + 1, False,
              serve_valid, int8, PAGE),
             ("decode_attn_paged", SLOTS, 24 * 43, 1, True, edge_valid, all3,
              24),
             ("decode_attn_paged_window", SLOTS, 24 * 43, SPEC_K + 1, True,
              edge_valid, int8, 24)]
    for ci, (kname, b, s, qs, causal, rows, precs, page) in enumerate(paged):
        q, _ = qkv(b, 0, qs, LLAMA_ATTN)
        rows = needed(rows, qs)
        valid = valid_of(rows)
        tail = f" P{page}" + (" edges" if page != PAGE else "")
        for prec in precs:
            kp, vp = paged_pair(torch, gen, b, s, rows, prec, seed=ci,
                                page=page)
            yield case(kname, shape(b, s, qs, LLAMA_ATTN, tail), q, kp, vp,
                       valid, causal)
            del kp, vp
    for prec in ("int8", "int4"):
        kp, vp = paged_pair(torch, gen, SLOTS, 1024,
                            [v + sf for v in serve_valid], prec, seed=9)
        for count in range(sf):
            q, _ = qkv(SLOTS, 0, 1, LLAMA_ATTN)
            yield case("decode_attn_paged_fresh",
                       shape(SLOTS, 1024, 1, LLAMA_ATTN,
                             f" P{PAGE} Sf{sf} count{count}"),
                       q, kp, vp, base + count + 1, fresh=(fk, fv, base),
                       count=count)
        del kp, vp


# Limit on the relative L2 distance of a decode attention kernel's output
# from its plain version (both in q's dtype, bf16, over the whole output).
# The elementwise 2e-2 (TOL) cannot see a fault of the split-KV merge: the
# outputs are ~0.03 and one row of ~1000 weighs ~1e-3. Placed from the
# readings of scripts/decode_attn_gate_mutants.py (PERF.md): the real
# kernel against the plain version, and four planted faults (a lost split,
# no merge rescale, splits overlapping by one row, swapped K/V page tables).
ATTN_REL_L2 = 1e-3


def attn_rel_l2(got, want) -> float:
    """Relative L2 distance of a decode attention output from its plain
    version's."""
    return float((got.float() - want.float()).norm()
                 / max(float(want.float().norm()), 1e-30))


def attn_fault(got, want):
    """None when a decode attention output passes the attention gate
    (ATTN_REL_L2 against its plain version); else what it failed."""
    rel = attn_rel_l2(got, want)
    if not rel <= ATTN_REL_L2:
        return f"relative L2 {rel} > ATTN_REL_L2 {ATTN_REL_L2}"
    return None


def attn_outputs(torch, c: dict) -> tuple:
    """The kernel's and the plain version's output of one attention case
    (f32 views), and its quantized fresh rows (or None)."""
    from repro_torch.kernels.decode_attn import ops as DA
    kp, vp = c["kp"], c["vp"]
    fq = None
    if c["fresh"] is not None:
        fk, fv, base = c["fresh"]
        fq = (DA._fresh_page(fk, kp), DA._fresh_page(fv, vp), base)
    got = DA.decode_attn_cuda(c["q"], kp, vp, c["valid"], c["causal"], fq)
    want = DA.decode_attention_plain(c["q"], kp, vp, c["valid"], c["causal"],
                                     fq)
    torch.cuda.synchronize()
    return got.float(), want.float(), fq


def attn_case(torch, timer, compare, c: dict) -> dict:
    """One decode-attention case (``attention_cases``) against its plain
    version: the elementwise tolerance and the attention gate
    (``attn_fault``); a query that sees no row must give 0. Timed: the
    kernel, the plain version and SDPA on the dequantized cache with the
    same boolean mask (a yardstick the port never calls), with the bound of
    the rows its queries see. Pools (PagedKV) must also equal, to the bit,
    the dense kernel on the rows gathered through the tables, and the
    yardstick is that gather followed by SDPA."""
    from repro_torch.kernels.decode_attn import ops as DA
    from repro_torch.quant import paged as PG
    from repro_torch.quant.kvcache import KVPage, PagedKV, dequantize_kv
    kernel, q, kp, vp = c["kernel"], c["q"], c["kp"], c["vp"]
    valid, causal = c["valid"], c["causal"]
    b, s, h, hd = q.shape
    S = kp.seq_len
    hkv = kp.num_kv_heads
    rep = h // hkv
    dev = q.device
    paged = isinstance(kp, PagedKV)
    got, want, fq = attn_outputs(torch, c)
    compare(kernel, [got], [want])
    fault = attn_fault(got, want)
    if fault:
        raise AssertionError(f"{kernel} {c['shape']} {kp.precision}: {fault}")
    extra_row = {}
    if paged:
        dense = DA.decode_attn_cuda(q, PG.gather(kp), PG.gather(vp), valid,
                                    causal, fq).float()
        torch.cuda.synchronize()
        if not torch.equal(got, dense):
            raise AssertionError(
                f"{kernel}: the paged kernel differs from the dense kernel "
                f"on the gathered rows (max abs "
                f"{float((got - dense).abs().max())}): an addressing fault")
        extra_row["equal_to_dense_kernel"] = True
    vl = valid.long()
    limit = (vl[:, None] - s + 1 + torch.arange(s, device=dev)[None] if causal
             else vl[:, None].expand(b, s))
    cache_lim = limit if fq is None else torch.minimum(
        limit, fq[2].long()[:, None])
    blind = limit <= 0                                    # (B, s) sees no row
    if bool(blind.any()) and float(got[blind].abs().max()) != 0.0:
        raise AssertionError(f"{kernel}: a query that sees no row must "
                             "give 0")
    row = dict(kernel=kernel, shape=c["shape"], precision=kp.precision, m=b,
               qs=s, causal=causal, err=float((got - want).abs().max()),
               rel_l2=attn_rel_l2(got, want),
               **extra_row, **c["extra"])
    if QUICK:
        return row
    row["ms"] = timer.ms(lambda: DA.decode_attn_cuda(q, kp, vp, valid,
                                                      causal, fq))
    row["plain_ms"] = timer.ms(lambda: DA.decode_attention_plain(
        q, kp, vp, valid, causal, fq))
    pos = torch.arange(S, device=dev)
    mask = pos[None, None, :] < cache_lim[:, :, None]     # (B, s, S)
    if paged:
        # the yardstick gathers the dequantized pool through the table
        pools = [dequantize_kv(KVPage(data=p.data, scale=p.scale,
                                      precision=p.precision,
                                      head_dim=p.head_dim, group=p.group),
                               q.dtype).repeat_interleave(rep, 2)
                 for p in (kp, vp)]                       # (N, P, H, hd)
        tables = [p.table.long() for p in (kp, vp)]
    else:
        kd, vd = (dequantize_kv(p, q.dtype) for p in (kp, vp))
    seen = cache_lim.clamp(0, S).sum()
    rows_read = int(vl.clamp(0, S).sum() if fq is None
                    else torch.minimum(vl, fq[2].long()).clamp(0, S).sum())
    extra_bytes = 0
    fresh_kv = []
    if fq is not None:
        sf = fq[0].data.shape[1]
        fpos = fq[2].long()[:, None] + torch.arange(sf, device=dev)[None]
        fmask = fpos[:, None, :] < limit[:, :, None]      # (B, s, Sf)
        seen = seen + fmask.sum()
        mask = torch.cat([mask, fmask], dim=2)
        fresh_kv = [dequantize_kv(f, q.dtype) for f in fq[:2]]
        extra_bytes = 2 * sum(t.numel() * t.element_size() for t in
                              (fq[0].data, fq[0].scale) if t is not None)
        extra_bytes += b * 4
    qt = q.transpose(1, 2)                                # (B, H, s, hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if paged:
        fresh_h = [f.repeat_interleave(rep, 2) for f in fresh_kv]

        def library():
            kx, vx = (pool[t].reshape(b, S, h, hd)
                      for pool, t in zip(pools, tables))
            if fresh_h:
                kx = torch.cat([kx, fresh_h[0]], dim=1)
                vx = torch.cat([vx, fresh_h[1]], dim=1)
            return sdpa(qt, kx.transpose(1, 2), vx.transpose(1, 2),
                        attn_mask=mask[:, None])

        row["library_ms"] = timer.ms(library)
        extra_bytes += 2 * kp.table.numel() * 4           # both page tables
    else:
        if fresh_kv:
            kd = torch.cat([kd, fresh_kv[0]], dim=1)
            vd = torch.cat([vd, fresh_kv[1]], dim=1)
        kd, vd = (x.repeat_interleave(rep, 2).transpose(1, 2)
                  for x in (kd, vd))
        row["library_ms"] = timer.ms(lambda: sdpa(qt, kd, vd,
                                                  attn_mask=mask[:, None]))
    per_row = (kp.data[0, 0].numel() * kp.data.element_size()
               + (0 if kp.scale is None else kp.scale[0, 0].numel() * 2))
    row["bound_ms"], row["bound_by"] = bound_ms(
        2 * rows_read * per_row + extra_bytes
        + 2 * q.numel() * q.element_size() + b * 4,   # q in, out in q's dtype
        4.0 * int(seen) * h * hd)
    return row


def check_kernels(torch, timer, rows: list) -> dict:
    from repro_torch.kernels.qmatmul import ops as QM
    from repro_torch.quant.quantize import dequantize, quantize

    gen = torch.Generator(device="cuda").manual_seed(0)
    d, ff, vocab = 3072, 8192, 128256
    # llama3.2-3b's matrices, and whisper-medium's 1024 x 1024 (its wo and
    # cross-attention wq at decode)
    shapes = {"wq": (3072, d), "wk/wv": (1024, d), "gate/up": (ff, d),
              "down": (d, ff), "lm_head": (vocab, d),
              "whisper wo": (1024, 1024)}
    # The M values the main path gives the matmul kernels, each kernel
    # instantiation among them: decode runs every slot (M = 4, the MT = 4
    # kernel; 1-3 are the MT = 1, 2 kernels and a masked MT = 4 tile), a
    # prefill's head runs M = 1, and prefill runs M = the prompt length in
    # 8-row tiles: 8, 256, and a serve prompt whose last tile is partial;
    # a speculative verify runs every slot's K+1 window (M = 20).
    lens = [len(p) for p in serve_prompts(vocab)]
    ragged = next(n for n in lens if n % 8)
    ms_list = (1, 2, 3, SLOTS, 8, SLOTS * (SPEC_K + 1), 256, ragged)
    precs = ("int8", "int4", "ternary")
    worst = {k: 0.0 for k in KERNEL_SOURCES}

    def weight(n, k):
        w = torch.randn((n, k), generator=gen, device="cuda") / k ** 0.5
        return w.to(torch.bfloat16)

    def act(m, k):
        return (torch.randn((m, k), generator=gen, device="cuda") * 0.5
                ).to(torch.bfloat16)

    def compare(name, got, want):
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)
            worst[name] = max(worst[name], float((g - w).abs().max()))

    # qmatmul: every precision, M and projection shape of the model
    for wname, (n, k) in shapes.items():
        if QUICK and wname == "lm_head":
            continue
        base = weight(n, k)
        for prec in precs:
            w = quantize(base, prec)
            wd = dequantize(w, torch.bfloat16)
            for m in ms_list:
                x = act(m, k)
                got = QM.qmatmul_cuda(x, w)
                want = QM.qmatmul_plain(x, w)
                compare("qmatmul", [got], [want])
                exact = x.float() @ dequantize(w, torch.float32).t()
                row = dict(kernel="qmatmul", shape=f"{wname} {n}x{k}",
                           precision=prec, m=m,
                           err=float((got - want).abs().max()),
                           **matmul_exactness(torch, "qmatmul", [got], [exact],
                                              lambda: [QM.qmatmul_cuda(x, w)]),
                           plan=qmatmul_plan(n, m, k, prec))
                del exact
                if not QUICK:
                    row["ms"] = timer.ms(lambda: QM.qmatmul_cuda(x, w))
                    row["plain_ms"] = timer.ms(lambda: QM.qmatmul_plain(x, w))
                    row["library_ms"] = timer.ms(lambda: x @ wd.t())
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        m * k * 2 + qbytes(w) + m * n * 4, 2.0 * m * n * k)
                rows.append(row)
                log(json.dumps(row))
            del w, wd
        del base

    # qkv: the fused projections at llama's and whisper's widths
    for prec in precs:
        for label, dm, ns in (("wq|wk|wv 5120x3072", d, (3072, 1024, 1024)),
                              ("whisper wq|wk|wv 3072x1024", 1024,
                               (1024, 1024, 1024))):
            ws = [quantize(weight(n, dm), prec) for n in ns]
            wqkv = torch.cat([dequantize(w, torch.bfloat16) for w in ws])
            for m in ms_list:
                x = act(m, dm)
                got = QM.qkv_cuda(x, *ws)
                want = [QM.qmatmul_plain(x, w) for w in ws]
                compare("qkv", got, want)
                exact = [x.float() @ dequantize(w, torch.float32).t()
                         for w in ws]
                row = dict(kernel="qkv", shape=label, precision=prec, m=m,
                           err=max(float((g - w).abs().max())
                                   for g, w in zip(got, want)),
                           **matmul_exactness(torch, "qkv", got, exact,
                                              lambda: QM.qkv_cuda(x, *ws)),
                           plan=qmatmul_plan(sum(ns), m, dm, prec))
                if not QUICK:
                    row["ms"] = timer.ms(lambda: QM.qkv_cuda(x, *ws))
                    row["plain_ms"] = timer.ms(
                        lambda: QM.fused_qkv_plain(x, *ws))
                    row["library_ms"] = timer.ms(lambda: x @ wqkv.t())
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        m * dm * 2 + sum(map(qbytes, ws)) + m * sum(ns) * 4,
                        2.0 * m * sum(ns) * dm)
                rows.append(row)
                log(json.dumps(row))
            del ws, wqkv
    qmatmul_refusals()

    # qmlp: the fused SwiGLU MLP
    for prec in precs:
        wg, wu = (quantize(weight(ff, d), prec) for _ in range(2))
        wdn = quantize(weight(d, ff), prec)
        for m in ms_list:
            x = act(m, d)
            got = QM.qmlp_cuda(x, wg, wu, wdn)
            want = QM.fused_mlp_plain(x, wg, wu, wdn).float()
            compare("qmlp", [got], [want])
            row = dict(kernel="qmlp", shape="swiglu 3072->8192->3072",
                       precision=prec, m=m,
                       err=float((got - want).abs().max()))
            if not QUICK:
                row["ms"] = timer.ms(lambda: QM.qmlp_cuda(x, wg, wu, wdn))
                row["plain_ms"] = timer.ms(
                    lambda: QM.fused_mlp_plain(x, wg, wu, wdn))
                row["library_ms"] = None
                row["bound_ms"], row["bound_by"] = bound_ms(
                    m * d * 2 + sum(map(qbytes, (wg, wu, wdn))) + m * d * 4,
                    2.0 * m * (2 * ff * d + ff * d))
            rows.append(row)
            log(json.dumps(row))
        del wg, wu, wdn

    def add(row):
        rows.append(row)
        log(json.dumps(row))

    # decode attention in every form (attention_cases)
    for case in attention_cases(torch):
        add(attn_case(torch, timer, compare, case))
        del case
    attn_refusals()
    check_whisper_kernels(torch, timer, gen, compare, add)
    check_entropy_quantize(torch, timer, gen, rows, worst, add)
    return worst


def attn_refusals() -> None:
    """The decode attention entry point refuses, launching nothing, what it
    has no copy for: zamba2-2.7b's head dim 80, a scale group that is not a
    power of two, and a split other than its own (every pointer is null,
    so a launch would fault)."""
    from repro_torch.kernels import build
    lib = build.library("decode_attn")
    # (hd, group, prec, rep, split) against llama's (128, 64, int8, 3, 128)
    for hd, group, prec, rep, split in ((80, 64, 0, 1, 256),
                                        (128, 48, 0, 3, 128),
                                        (128, 64, 0, 3, 256),
                                        (64, 64, 1, 1, 128)):
        err = lib.repro_decode_attn(*[None] * 15, 0, 0, 0, 0, 4, 448, 1, 0,
                                    16, rep, 1, hd, group, prec, 1, 0, split,
                                    None)
        if err == 0:
            raise AssertionError(f"decode_attn took hd {hd}, group {group}, "
                                 f"split {split}")
    log("decode_attn refuses hd 80, group 48 and foreign splits")


# Limit on the largest absolute difference of a qmatmul / qkv output from
# the product in f32 with the weights dequantized to f32 (q * s is exact in
# f32, so only the order of the f32 sums differs; earlier designs read
# <= 7.6e-6).
QMATMUL_F32 = 1e-5


def matmul_exactness(torch, kernel: str, got: list, exact: list,
                     again) -> dict:
    """The qmatmul / qkv checks beyond the plain version: within
    QMATMUL_F32 of the f32 dequantized product, and a second call equal to
    the first to the bit (no atomics, a fixed summation order)."""
    err = max(float((g - e).abs().max()) for g, e in zip(got, exact))
    second = again()
    torch.cuda.synchronize()
    if not err <= QMATMUL_F32:
        raise AssertionError(f"{kernel}: {err} from the f32 dequantized "
                             f"product (limit {QMATMUL_F32})")
    if not all(torch.equal(a, b) for a, b in zip(got, second)):
        raise AssertionError(f"{kernel}: two calls on the same inputs differ")
    return dict(err_f32=err, bit_identical_twice=True)


def qmatmul_plan(n: int, m: int, k: int, prec: str) -> dict:
    """The launch csrc/qmatmul.cu picks for an (n, k) weight at m rows of
    bf16 x: grid, threads, shared memory, blocks an SM holds (occupancy)
    and blocks in flight per SM."""
    import ctypes
    from repro_torch.kernels import build
    out = (ctypes.c_int * 6)()
    build.check(build.library("qmatmul").repro_qmatmul_plan(
        n, m, k, int(prec == "int4"), 1, out), "qmatmul plan")
    gx, gy, threads, smem, per_sm, rows = list(out)
    sms = 132
    return dict(grid=[gx, gy], threads=threads, smem=smem, rows=rows,
                blocks_per_sm_max=per_sm,
                blocks_in_flight_per_sm=min(per_sm, (gx * gy) / sms))


def qmatmul_refusals() -> None:
    """The qmatmul entry point refuses, launching nothing, a weight group
    other than 128 and x or weights that are not 16-byte aligned (every
    other pointer is null, so a launch would fault)."""
    from repro_torch.kernels import build
    lib = build.library("qmatmul")
    for group, x, w in ((64, None, None), (256, None, None), (128, 8, None),
                        (128, None, 8)):
        err = lib.repro_qmatmul(x, 1, 4, 3072, group, 0, w, None, None, 3072,
                                None)
        if err == 0:
            raise AssertionError(f"qmatmul took group {group}, x {x}, w {w}")
    log("qmatmul refuses groups 64 and 256 and unaligned x or weights")


def check_whisper_kernels(torch, timer, gen, compare, add) -> None:
    """The whisper-medium path's MLP shapes: the gelu form of the fused
    MLP (1024 -> 4096 -> 1024) at every M it runs (1: the batch-1 prefill
    steps; SLOTS: a decode step; 1500: the encoder, one request's frames)
    in every precision. Its attention shapes are in ``attention_cases``."""
    from repro_torch.kernels.qmatmul import ops as QM
    from repro_torch.quant.quantize import quantize
    d, ff, s_enc = 1024, 4096, 1500
    for prec in ("int8", "int4", "ternary"):
        wu = quantize((torch.randn((ff, d), generator=gen, device="cuda")
                       / d ** 0.5).to(torch.bfloat16), prec)
        wdn = quantize((torch.randn((d, ff), generator=gen, device="cuda")
                        / ff ** 0.5).to(torch.bfloat16), prec)
        for m in (1, SLOTS, s_enc):
            x = (torch.randn((m, d), generator=gen, device="cuda") * 0.5
                 ).to(torch.bfloat16)
            got = QM.qmlp_cuda(x, None, wu, wdn)
            want = QM.fused_mlp_plain(x, None, wu, wdn, act="gelu").float()
            compare("qmlp_gelu", [got], [want])
            row = dict(kernel="qmlp_gelu", shape="gelu 1024->4096->1024",
                       precision=prec, m=m,
                       err=float((got - want).abs().max()))
            if not QUICK:
                row["ms"] = timer.ms(lambda: QM.qmlp_cuda(x, None, wu, wdn))
                row["plain_ms"] = timer.ms(
                    lambda: QM.fused_mlp_plain(x, None, wu, wdn, act="gelu"))
                row["library_ms"] = None
                row["bound_ms"], row["bound_by"] = bound_ms(
                    m * d * 2 + qbytes(wu) + qbytes(wdn) + m * d * 4,
                    2.0 * m * 2 * ff * d)
            add(row)
        del wu, wdn


# entropy: the largest error the reference's own test allows, relative to
# max(1, |H|) (tests/test_kernels.py:32)
ENTROPY_TOL = 1e-3
# entropy: the largest absolute error of H, kernel against its plain version
# (and kernel mode against stream mode). At the weight scale (std
# 1/sqrt(K)) the softmax is nearly uniform and the part of H that depends on
# the weights, log(n) - H, is about var(w) / 2: 6e-5 for 3072x8192, far under
# ENTROPY_TOL * |H| (1.7e-2). Correct kernels read 0 to 1.9e-6 apart on the
# card (one f32 ulp of H near 17.8 is 1.9e-6); a kernel that drops the S/Z
# term is 1.2e-4 off, one that loses one of 1024 partials 1e-3.
ENTROPY_ABS = 1e-5
# the ragged tail of an odd f32 case (the elements past the last 16-byte
# load) is set to this value, so that a kernel that skips it is far off
ENTROPY_TAIL = 8.0
# (label, shape, dtype, scale: None = 1/sqrt(last dim), the weight scale;
# 0.7 = the reference test's scale (tests/test_kernels.py:28))
ENTROPY_CASES = (("3072x8192 bf16", (3072, 8192), "bfloat16", None),
                 ("51968x1024 bf16", (51968, 1024), "bfloat16", None),
                 ("1000003 f32 tail", (1000003,), "float32", None),
                 ("3072x8192 bf16 x0.7", (3072, 8192), "bfloat16", 0.7),
                 ("1000003 f32 tail x0.7", (1000003,), "float32", 0.7))


def entropy_inputs(torch, gen, device: str = "cuda"):
    """Yields (label, w) for ENTROPY_CASES; an odd f32 case has its last
    n % 4 elements set to ENTROPY_TAIL."""
    for label, dims, dtype, scale in ENTROPY_CASES:
        w = torch.randn(dims, generator=gen, device=device)
        w = (w * (dims[-1] ** -0.5 if scale is None else scale)).to(
            getattr(torch, dtype))
        tail = w.numel() % 4 if w.dtype == torch.float32 else 0
        if tail:
            w.view(-1)[-tail:] = ENTROPY_TAIL
        yield label, w


def entropy_fault(got: float, want: float):
    """None when the kernel's H ``got`` passes both entropy gates against
    the plain version's ``want``; else what it failed."""
    err = abs(got - want)
    if not err <= ENTROPY_TOL * max(1.0, abs(want)):
        return f"error {err} > ENTROPY_TOL * max(1, |H|)"
    if not err <= ENTROPY_ABS:
        return f"error {err} > ENTROPY_ABS {ENTROPY_ABS}"
    return None


def check_entropy_quantize(torch, timer, gen, rows, worst, add) -> None:
    """The entropy kernel (ENTROPY_CASES: llama3.2-3b's 3072x8192 MLP
    weight and whisper-medium's padded 51968x1024 embedding in bf16, as the
    analysis reads them, and an odd-sized f32 vector whose ragged tail
    carries weight; at the weight scale and at the reference test's)
    within ENTROPY_TOL * max(1, |H|) and ENTROPY_ABS of its plain version,
    with the gap log(n) - H of both reported; the int8 quantize kernel on a
    3072x8192 bf16 and a 1024x4096 f32 weight, payload and f32 scales equal
    to the plain version's to the bit. The yardsticks:
    ``Categorical(logits=w).entropy()`` for the entropy (one PyTorch call,
    the same function); none for quantize."""
    import math
    from repro_torch.kernels.entropy import ops as EN
    from repro_torch.kernels.quantize import ops as QZ
    for shape, w in entropy_inputs(torch, gen):
        got = float(EN.entropy_cuda(w))
        want = float(EN.matrix_entropy(w, plain=True))
        err = abs(got - want)
        worst["entropy"] = max(worst["entropy"], err)
        fault = entropy_fault(got, want)
        if fault:
            raise AssertionError(f"entropy {shape}: kernel {got} against "
                                 f"plain {want}: {fault}")
        n = w.numel()
        row = dict(kernel="entropy", shape=shape,
                   precision=str(w.dtype).replace("torch.", ""), m=None,
                   h=want, gap=math.log(n) - want,
                   gap_kernel=math.log(n) - got, err=err,
                   rel_err=err / max(1.0, abs(want)))
        if not QUICK:
            flat = w.reshape(-1)
            cat = torch.distributions.Categorical
            row["ms"] = timer.ms(lambda: EN.entropy_cuda(w))
            row["plain_ms"] = timer.ms(
                lambda: EN.matrix_entropy(w, plain=True))
            row["library_ms"] = timer.ms(lambda: cat(
                logits=flat.float(), validate_args=False).entropy())
            row["bound_ms"], row["bound_by"] = bound_ms(
                n * w.element_size() + 4, 6.0 * n, F32_FLOPS)
        add(row)
        del w
    for shape, (n, k), dtype in (("3072x8192 bf16 group128", (3072, 8192),
                                  torch.bfloat16),
                                 ("1024x4096 f32 group128", (1024, 4096),
                                  torch.float32)):
        w = (torch.randn((n, k), generator=gen, device="cuda") * 0.02
             ).to(dtype)
        w[0, :128] = 0                              # a zero group
        q, sc = QZ.quantize_int8_cuda(w)
        qp, sp = QZ.quantize_int8(w, plain=True)
        torch.cuda.synchronize()
        if not (torch.equal(q, qp) and torch.equal(sc, sp)):
            raise AssertionError(
                f"quantize_int8 {shape}: {int((q != qp).sum())} payload "
                f"and {int((sc != sp).sum())} scale elements differ from "
                "the plain version")
        row = dict(kernel="quantize_int8", shape=shape,
                   precision=str(dtype).replace("torch.", ""), m=None,
                   err=0.0, bit_exact=True)
        if not QUICK:
            row["ms"] = timer.ms(lambda: QZ.quantize_int8_cuda(w))
            row["plain_ms"] = timer.ms(
                lambda: QZ.quantize_int8(w, plain=True))
            row["library_ms"] = None
            row["bound_ms"], row["bound_by"] = bound_ms(
                n * k * w.element_size() + n * k + n * (k // 128) * 4,
                5.0 * n * k, F32_FLOPS)
        add(row)
        del w, q, sc, qp, sp


# ---------------------------------------------------------------------------
# phase 4: full-width serve of llama3.2-3b
# ---------------------------------------------------------------------------

KERNEL_SOURCES = {
    "qmatmul": ("src/repro_torch/csrc/qmatmul.cu",
                "src/repro/kernels/qmatmul/kernel.py:75"),
    "qkv": ("src/repro_torch/csrc/qmatmul.cu",
            "src/repro/kernels/qmatmul/kernel.py:223"),
    "qmlp": ("src/repro_torch/csrc/qmlp.cu",
             "src/repro/kernels/qmatmul/kernel.py:143"),
    "qmlp_gelu": ("src/repro_torch/csrc/qmlp.cu",
                  "src/repro/kernels/qmatmul/kernel.py:143"),
    "decode_attn": ("src/repro_torch/csrc/decode_attn.cu",
                    "src/repro/kernels/decode_attn/kernel.py:162"),
    "decode_attn_window": ("src/repro_torch/csrc/decode_attn.cu",
                           "src/repro/kernels/decode_attn/kernel.py:94-99"),
    "decode_attn_fresh": ("src/repro_torch/csrc/decode_attn.cu",
                          "src/repro/kernels/decode_attn/kernel.py:129-151"),
    "decode_attn_cross": ("src/repro_torch/csrc/decode_attn.cu",
                          "src/repro/kernels/decode_attn/kernel.py:94-99"),
    "decode_attn_paged": ("src/repro_torch/csrc/decode_attn.cu",
                          "src/repro/kernels/decode_attn/kernel.py:203-260"),
    "decode_attn_paged_window": (
        "src/repro_torch/csrc/decode_attn.cu",
        "src/repro/kernels/decode_attn/kernel.py:203-260"),
    "decode_attn_paged_fresh": (
        "src/repro_torch/csrc/decode_attn.cu",
        "src/repro/kernels/decode_attn/kernel.py:203-260"),
    "entropy": ("src/repro_torch/csrc/entropy.cu",
                "src/repro/kernels/entropy/kernel.py:55"),
    "quantize_int8": ("src/repro_torch/csrc/quantize.cu",
                      "src/repro/kernels/quantize/kernel.py:35"),
}
# kernels that no serve or analysis path runs: held to their plain version
# only (nothing under src/ calls the reference's quantize_int8_pallas)
OFF_PATH = ("quantize_int8",)
# the kernels llama3.2-3b's paths (phases 4, 4b, 4c and its phase 5) run,
# each of which must launch there
LLAMA_PATH = ("qmatmul", "qkv", "qmlp", "decode_attn", "decode_attn_window",
              "decode_attn_fresh", "decode_attn_paged",
              "decode_attn_paged_window", "decode_attn_paged_fresh",
              "entropy")
# the kernels whisper-medium's serve (phase 4d) runs, each of which must
# launch in every whisper run
WHISPER_PATH = ("qmatmul", "qkv", "qmlp_gelu", "decode_attn",
                "decode_attn_cross")
# the row of each kernel reported on the kernels line: the serve phase's
# decode shape (4 slots) for the matmul kernels
HEADLINE = {"qmatmul": ("wq 3072x3072", "int8", SLOTS),
            "qkv": ("wq|wk|wv 5120x3072", "int8", SLOTS),
            "qmlp": ("swiglu 3072->8192->3072", "int8", SLOTS),
            "qmlp_gelu": ("gelu 1024->4096->1024", "int8", SLOTS),
            "decode_attn": ("B8 S2048 Hkv8 rep3 hd128", "int8", 8),
            "decode_attn_window": ("B8 S2048 Hkv8 rep3 hd128 qs5", "int8", 8),
            "decode_attn_fresh": ("B4 S1024 Hkv8 rep3 hd128 Sf4 count3",
                                  "int8", SLOTS),
            "decode_attn_cross": ("B4 S1500 Hkv16 rep1 hd64 cross", "int8",
                                  SLOTS),
            "decode_attn_paged": ("B8 S2048 Hkv8 rep3 hd128 P64", "int8", 8),
            "decode_attn_paged_window": ("B8 S2048 Hkv8 rep3 hd128 P64 qs5",
                                         "int8", 8),
            "decode_attn_paged_fresh": (
                "B4 S1024 Hkv8 rep3 hd128 P64 Sf4 count3", "int8", SLOTS),
            "entropy": ("3072x8192 bf16", "bfloat16", None),
            "quantize_int8": ("3072x8192 bf16 group128", "bfloat16", None)}
# Limit on the relative L2 distance of one decode step's logits, kernels
# against plain versions. PERF.md gives the readings that place it: the
# kernels against the plain versions, and against the plain versions
# without their bf16 roundings; the plain versions against themselves with
# their f32 sums reordered; the kernels with one int4 layer's nibbles
# swapped. The run repeats them all and fails if the planted fault falls
# under the limit.
LOGIT_REL_L2 = 5e-2
# Limit on the relative L2 distance of each whisper decoder layer's
# cross-attention output in one decode step, kernels against plain
# versions. The logits cannot hold cross-attention to a limit: with random
# weights the decoder's logits depend little on the frames (each slot
# reading another request's cross cache moves them by about 0.045, under
# LOGIT_REL_L2). The run reads the kernels against the plain versions and
# the outputs over the slots' cross caches rotated by one, in every layer,
# and fails if a rotated reading falls under the limit.
CROSS_REL_L2 = 5e-2


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


@contextlib.contextmanager
def patched_plain(torch, mode: str):
    """The plain versions changed for the logit readings below, and only
    there. ``"unrounded"``: without the bf16 roundings the kernels do not
    make (quantized weights dequantized to f32, not bf16; the SwiGLU hidden
    kept in f32, not rounded to x's dtype after silu and after the
    product). ``"reordered"``: the same arithmetic as the plain versions,
    but each quantized product summed over K in two halves, so only the
    order of the f32 additions changes."""
    import torch.nn.functional as F
    from repro_torch.kernels.qmatmul import ops as QM
    from repro_torch.models import mlp as MLP
    from repro_torch.quant.quantize import dequantize
    saved = QM.qmatmul_plain, MLP.fused_mlp

    def qmatmul_f32(x2d, w):
        return x2d.float() @ dequantize(w, torch.float32).t()

    def qmatmul_halves(x2d, w):
        wd = dequantize(w, torch.bfloat16).float()
        x, h = x2d.float(), wd.shape[1] // 2
        return x[:, :h] @ wd[:, :h].t() + x[:, h:] @ wd[:, h:].t()

    def fused_mlp_f32(x, wg, wu, wd, act="swiglu", plain=False):
        if not (plain and act == "swiglu"
                and QM._mega_eligible((wg, wu, wd))):
            return saved[1](x, wg, wu, wd, act=act, plain=plain)
        g = QM.qdot(x, wg, out_dtype=torch.float32, plain=True)
        u = QM.qdot(x, wu, out_dtype=torch.float32, plain=True)
        return QM.qdot(F.silu(g) * u, wd, out_dtype=x.dtype, plain=True)

    if mode == "unrounded":
        QM.qmatmul_plain, MLP.fused_mlp = qmatmul_f32, fused_mlp_f32
    elif mode == "reordered":
        QM.qmatmul_plain = qmatmul_halves
    else:
        raise ValueError(mode)
    try:
        yield
    finally:
        QM.qmatmul_plain, MLP.fused_mlp = saved


def swap_nibbles_one_layer(torch, params, key: str = "layers") -> dict:
    """A planted fault: ``params`` with the first int4 layer of the stack
    ``key`` nibble-swapped in its payload bytes (the other layers are
    shared, not copied)."""
    from repro_torch.quant.qtypes import QTensor
    from repro_torch.tree import tree_map
    layers = params[key]
    segs = list(layers.segments)
    i = next(j for j, seg in enumerate(segs) if seg.precision == "int4")

    def swap(x):
        if not isinstance(x, QTensor):
            return x
        data = x.data.clone()
        u = data[0].view(torch.uint8)
        data[0] = (((u & 0x0F) << 4) | (u >> 4)).view(torch.int8)
        return dataclasses.replace(x, data=data)

    segs[i] = dataclasses.replace(segs[i],
                                  params=tree_map(swap, segs[i].params))
    return {**params, key: dataclasses.replace(layers, segments=segs)}


def window_rel_l2(a, b) -> float:
    """The largest relative L2 distance over the positions of a verify
    window's logits (B, s, V): each position is held to the limit."""
    return max(rel_l2(a[:, i], b[:, i]) for i in range(a.shape[1]))


@contextlib.contextmanager
def noncausal_attention():
    """A planted fault: every decode attention of the model runs with
    causal=False, so a verify window's queries see their own future."""
    from repro_torch.models import attention as ATT
    saved = ATT.decode_attention
    ATT.decode_attention = functools.partial(saved, causal=False)
    try:
        yield
    finally:
        ATT.decode_attention = saved


def cache_tensors(cache) -> list:
    """Every tensor of a cache's K/V fields (page data and scales)."""
    out = []
    for field in (cache.k, cache.v):
        for page in field if isinstance(field, tuple) else (field,):
            out += [t for t in (page.data, page.scale) if t is not None]
    return out


def serve_full_width(torch, build, report: dict, smoke: bool = False,
                     device: str = "cuda") -> dict:
    """Phase 4 (``smoke``/``device`` rehearse it at SMOKE size on a CPU)."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build as build_model
    from repro_torch.quant.kvcache import clone_cache
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.quantized import explicit_plan, plan_for_variant
    from repro_torch.serving.scheduler import Request

    cfg = get_config("llama3.2-3b", smoke=smoke)   # FULL: 28L, d_model 3072
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen, device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    log(f"serve: {cfg.name} FULL {cfg.num_layers}L d_model {cfg.d_model} "
        f"{cfg.num_heads}H/{cfg.num_kv_heads}KV d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab_size} {cfg.dtype}; random init "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = serve_prompts(cfg.vocab_size)

    def requests():
        return [Request(rid=i, prompt=p, max_new_tokens=32)
                for i, p in enumerate(prompts)]

    t0 = time.perf_counter()
    ewq = plan_for_variant(model, params, "4bit/8bit")
    sync()
    log(f"serve: EWQ analysis on the card ({time.perf_counter() - t0:.1f} s): "
        f"4bit/8bit plan counts {ewq.counts()} "
        f"precisions {ewq.precisions()}")
    tiers = ["raw", "int8", "int4", "ternary"]
    n = cfg.num_layers
    layers = [tiers[i * len(tiers) // n] for i in range(n)]
    explicit = explicit_plan(cfg, layers, embed_precision="int8")
    log(f"serve: explicit plan counts {explicit.counts()} (int8 embedding)")

    launches = {k: 0 for k in build.LAUNCHES}
    runs = []
    engine = fault_outs = None
    # the EWQ run twice: replayed from CUDA graphs (the engine's default on
    # the card), then eagerly (cuda_graphs=False), held equal to the bit
    for label, plan, kv, graphs in (
            ("ewq-4bit/8bit", ewq, "int8", True),
            ("ewq-4bit/8bit", ewq, "int8", False),
            ("explicit-all-precisions", explicit, "int4", True)):
        engine = None                          # free the previous engine
        fresh_memory(torch, device)
        engine = ServeEngine(model, params, max_seq=1024, plan=plan,
                             kv_precision=kv, device=device,
                             cuda_graphs=graphs)
        build.reset_launches()                 # main path: counts from 0
        (outs, stats), peak, serve_peak = serve_peaks(
            torch, device, lambda: engine.serve(requests(), num_slots=SLOTS,
                                                chunk=CHUNK))
        counts = dict(build.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        for o in outs:
            gen_toks = o.generated
            if (len(gen_toks) != 32 or gen_toks.min() < 0
                    or gen_toks.max() >= cfg.vocab_size
                    or not np.all(np.isfinite(o.logprobs))):
                raise AssertionError(f"{label}: bad output for request "
                                     f"{o.rid}: {gen_toks}")
        run = dict(run=label, kv=kv, cuda_graphs=engine.graphs is not None,
                   requests=len(outs),
                   generated=stats.generated_tokens,
                   tokens_per_s=stats.tokens_per_s,
                   ttft_mean_s=stats.ttft_mean_s,
                   tpot_p50_s=stats.tpot_p50_s,
                   decode_chunk_p50_s=stats.decode_gap_p50_s,
                   wall_s=stats.wall_s,
                   weight_bytes=engine.weight_bytes(),
                   kv_bytes_per_slot=engine.kv_bytes_per_slot(),
                   max_memory_allocated=peak,
                   serve_max_memory_allocated=serve_peak,
                   launches=counts,
                   chunk=chunk_readings(torch, build, engine, prompts,
                                        device))
        # the graph engine also serves under the planted stale-buffer fault
        # and serves sampled requests; the eager engine (built after the
        # graph engine is freed, so each peak is its own) serves the same
        # sampled requests
        sampled = sampled_serve(torch, engine, prompts)
        log("serve: " + json.dumps(run))
        runs.append(run)
        if kv == "int8" and graphs:
            base_outs = outs                   # the EWQ non-spec tokens
            base_sampled = sampled
            fault_outs = (stale_buffer_serve(torch, engine, requests())
                          if device == "cuda" else None)
        elif kv == "int8":
            require_same(label, base_outs, outs, logprobs=True)
            run["identical_to_graph_run"] = True
            if fault_outs is not None:
                run["planted_fault"] = stale_buffer_caught(fault_outs, outs)
            run["sampled"] = sampled_agreement(base_sampled, sampled)
    # first decode step through the kernels against the plain versions, on
    # the explicit plan's params and an identical int4 cache
    eng = engine
    state = eng.init_decode_state(SLOTS)
    for slot in range(SLOTS):
        eng.insert(state, slot, eng.prefill_request(prompts[slot]), 32)
    toks = torch.argmax(state.last_logits[:, :cfg.vocab_size], -1)[:, None]

    def step_logits(params, plain=False):
        logits, _ = model.decode_step(params, clone_cache(state.cache),
                                      toks, plain=plain)
        return logits.float()

    k_logits, p_logits = step_logits(eng.params), step_logits(eng.params, True)
    if not bool(torch.isfinite(k_logits).all()):
        raise AssertionError("non-finite logits through the kernels")
    rel = rel_l2(k_logits, p_logits)
    agree = float((k_logits.argmax(-1) == p_logits.argmax(-1)).float().mean())
    err = float((k_logits - p_logits).abs().max())
    with patched_plain(torch, "unrounded"):
        rel_unrounded = rel_l2(k_logits, step_logits(eng.params, True))
    with patched_plain(torch, "reordered"):
        rel_reordered = rel_l2(step_logits(eng.params, True), p_logits)
    rel_fault = rel_l2(step_logits(swap_nibbles_one_layer(torch, eng.params)),
                       p_logits)
    log(f"serve: first decode step, kernels vs plain versions: relative L2 "
        f"{rel:.4g} (limit {LOGIT_REL_L2}), max abs diff {err:.4g} of max "
        f"|logit| {float(p_logits.abs().max()):.4g}, greedy agreement "
        f"{agree:.2f}")
    log(f"serve: the limit's readings: kernels vs plain versions without "
        f"their bf16 roundings {rel_unrounded:.4g}; plain versions with "
        f"their f32 sums reordered vs plain versions {rel_reordered:.4g}; "
        f"kernels with one int4 layer's nibbles swapped vs plain versions "
        f"{rel_fault:.4g}")
    if rel > LOGIT_REL_L2:
        raise AssertionError(f"decode logits differ: relative L2 {rel}")
    if rel_fault <= LOGIT_REL_L2:
        raise AssertionError(f"the logit limit {LOGIT_REL_L2} misses a "
                             f"planted fault (relative L2 {rel_fault})")

    report.update(runs=runs, launches=launches, logit_rel_l2=rel,
                  logit_rel_l2_unrounded=rel_unrounded,
                  logit_rel_l2_reordered=rel_reordered,
                  logit_rel_l2_planted_fault=rel_fault,
                  logit_max_abs_diff=err, greedy_agreement=agree,
                  ewq_counts=ewq.counts())
    if device == "cuda":
        decode_step_times(torch, model, eng, state, toks, report)
    eng = engine = state = None
    spec_launches, spec_outs = serve_speculative(
        torch, build, report, model, params, ewq, prompts, base_outs, device)
    for k, v in spec_launches.items():
        launches[k] += v
    paged_launches = serve_paged(torch, build, report, model, params, ewq,
                                 prompts, base_outs, spec_outs, device)
    for k, v in paged_launches.items():
        launches[k] += v
    _, entropy_launches = analyze_model(torch, build, report, model, params,
                                        device)
    launches["entropy"] += entropy_launches
    for k in LLAMA_PATH:
        if launches[k] <= 0 and device == "cuda":
            raise AssertionError(f"kernel {k} never launched on llama's "
                                 "serve and analysis paths")
    return launches


def fresh_memory(torch, device: str) -> None:
    """Free cached blocks and restart the peak-memory count (on the card)."""
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def serve_peaks(torch, device: str, serve):
    """Runs ``serve()`` and returns (its result, peak device memory since
    the last reset (the engine's build and the serve), the serve's own
    peak), the peaks None off the card."""
    if device != "cuda":
        return serve(), None, None
    built = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = serve()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return out, max(built, peak), peak


def same_outputs(outs, ref, logprobs: bool) -> bool:
    """Tokens (and logprobs) of two serves equal to the bit, request by
    request."""
    import numpy as np
    return len(outs) == len(ref) and all(
        np.array_equal(o.tokens, r.tokens)
        and (not logprobs or np.array_equal(o.logprobs, r.logprobs))
        for o, r in zip(outs, ref))


def require_same(label: str, graph_outs, eager_outs, logprobs: bool) -> None:
    """A serve replayed from CUDA graphs against the same serve run
    eagerly: the same kernels in the same order, so equal to the bit."""
    if not same_outputs(graph_outs, eager_outs, logprobs):
        raise AssertionError(f"{label}: the CUDA-graph serve's tokens"
                             f"{' or logprobs' if logprobs else ''} differ "
                             "from the eager serve's")
    log(f"{label}: CUDA-graph serve equal to the eager serve to the bit "
        f"(tokens{' and logprobs' if logprobs else ''})")


def chunk_readings(torch, build, engine, prompts, device: str,
                   frames=None) -> dict:
    """One decode chunk (CHUNK steps, or CHUNK spec rounds) over SLOTS
    freshly admitted requests: its wall time (host clock, ended by a
    synchronize) and, on a CUDA-graph engine, its device time (CUDA events
    around the replay), median of 3 after the chunk that captures; with
    the kernel launches a replayed chunk credits, per step (per round on
    a spec engine). A serve's own counts also hold the chunk a graph
    engine runs over its empty slots before the first admission."""
    if device != "cuda":
        return {}
    state = engine.init_decode_state(SLOTS)
    for slot in range(SLOTS):
        engine.insert(state, slot, engine.prefill_request(
            prompts[slot], frames=None if frames is None else frames[slot]),
            64)
    engine.decode_chunk(state, CHUNK)          # a graph engine captures
    torch.cuda.synchronize()
    walls, devs = [], []
    for _ in range(3):
        build.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        engine.decode_chunk(state, CHUNK)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        devs.append(start.elapsed_time(end))
    out = dict(steps=CHUNK, wall_ms=sorted(walls)[1],
               launches_per_step={k: v / CHUNK for k, v in
                                  build.LAUNCHES.items() if v})
    if engine.graphs is not None:
        out["device_ms"] = sorted(devs)[1]
        out["device_share_of_wall"] = out["device_ms"] / out["wall_ms"]
    build.reset_launches()
    return out


@contextlib.contextmanager
def stale_last_logits():
    """A planted fault: the decode step rebinds ``state.last_logits`` to a
    copy of itself in place of writing into it alone. Eagerly that changes
    nothing; a replayed graph goes on reading the buffer its capture saw,
    which no longer receives what the host writes (an admitted request's
    logits) nor, from the second replay, the current step's."""
    from repro_torch.serving.engine import ServeEngine
    saved = ServeEngine._step

    def step(self, st):
        saved(self, st)
        st.last_logits = st.last_logits.clone()

    ServeEngine._step = step
    try:
        yield
    finally:
        ServeEngine._step = saved


def stale_buffer_serve(torch, engine, requests) -> list:
    """The graph engine serves ``requests`` under ``stale_last_logits``."""
    with stale_last_logits():
        outs, _ = engine.serve(requests, num_slots=SLOTS, chunk=CHUNK)
    torch.cuda.synchronize()
    return outs


def stale_buffer_caught(fault_outs, eager_outs) -> dict:
    """The graph-vs-eager check must fail the serve under the planted
    stale-buffer fault."""
    import numpy as np
    if same_outputs(fault_outs, eager_outs, logprobs=True):
        raise AssertionError("the graph-vs-eager check misses a decode step "
                             "that rebinds a state tensor")
    agree = float(np.mean([np.mean(o.generated == e.generated)
                           for o, e in zip(fault_outs, eager_outs)]))
    log(f"planted fault (last_logits rebound in the step): caught, greedy "
        f"agreement with the eager serve {agree:.4f}")
    return dict(caught=True, greedy_agreement_with_eager=agree)


def sampled_serve(torch, engine, prompts) -> dict:
    """Four requests sampled at temperature 0.8, top-p 0.9 (so a captured
    chunk samples and masks, drawing from the state's generator), seed 7:
    outputs must be in the vocabulary with finite logprobs."""
    import numpy as np
    from repro_torch.serving.scheduler import Request
    cfg = engine.cfg
    reqs = [Request(rid=i, prompt=p, max_new_tokens=32, temperature=0.8,
                    top_p=0.9) for i, p in enumerate(prompts[:SLOTS])]
    outs, stats = engine.serve(reqs, num_slots=SLOTS, chunk=CHUNK, seed=7)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    for o in outs:
        if (len(o.generated) != 32 or o.generated.min() < 0
                or o.generated.max() >= cfg.vocab_size
                or not np.all(np.isfinite(o.logprobs))):
            raise AssertionError(f"sampled serve: bad output for request "
                                 f"{o.rid}: {o.generated}")
    return dict(outs=outs, tokens_per_s=stats.tokens_per_s)


def sampled_agreement(graph_run: dict, eager_run: dict) -> dict:
    """The sampled serves' agreement, a reading (a replay draws from the
    generator at the offsets its capture recorded)."""
    import numpy as np
    agree = float(np.mean([np.mean(a.generated == b.generated) for a, b in
                           zip(graph_run["outs"], eager_run["outs"])]))
    out = dict(tokens_per_s_graphs=graph_run["tokens_per_s"],
               tokens_per_s_eager=eager_run["tokens_per_s"],
               token_agreement_graphs_eager=agree)
    log("sampled serve (temperature 0.8, top-p 0.9): " + json.dumps(out))
    return out


def step_ms(torch, model, params, state, toks) -> tuple[float, float]:
    """One decode step on a clone of ``state``'s cache: its eager wall time
    (host dispatch included, median of 5) and its device time (the step
    replayed from a CUDA graph)."""
    from repro_torch.quant.kvcache import clone_cache
    cache = clone_cache(state.cache)

    def step():
        model.decode_step(params, cache, toks)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)[2], replay_ms(torch, capture(torch, step))


def decode_step_times(torch, model, eng, state, toks, report: dict) -> None:
    """Where a decode step's time goes: the same step eagerly (host
    dispatch included) and replayed from a CUDA graph (device time only)."""
    eager_ms, device_ms = step_ms(torch, model, eng.params, state, toks)
    log(f"serve: one decode step at {SLOTS} slots (explicit plan, int4 "
        f"KV): eager {eager_ms:.2f} ms wall, device {device_ms:.2f} ms (CUDA graph "
        f"replay); the device is busy {device_ms / eager_ms:.0%} of the "
        f"eager step")
    report["decode_step"] = dict(eager_ms=eager_ms, device_ms=device_ms)


def repeat_share(outs) -> float:
    """Share of generated tokens whose (previous, token) bigram already
    occurred earlier in the same request: what an ngram lookup can copy."""
    hits = total = 0
    for o in outs:
        toks = [int(t) for t in o.tokens]
        seen = {tuple(toks[j - 1:j + 1]) for j in range(1, o.prompt_len)}
        for i in range(o.prompt_len, len(toks)):
            pair = (toks[i - 1], toks[i])
            hits += pair in seen
            total += 1
            seen.add(pair)
    return hits / max(total, 1)


def serve_speculative(torch, build, report: dict, model, params, plan,
                      prompts, base_outs, device: str) -> dict:
    """Phase 4b: the EWQ plan with int8 KV served speculatively
    (SpecConfig(k=4)), with the int4 self-draft (fused propose) and with
    the ngram draft; then the window, step and propose readings on the
    model-draft engine. Returns the launches of both serves."""
    import numpy as np
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.spec import SpecConfig
    cfg = model.cfg
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    launches = {k: 0 for k in build.LAUNCHES}
    runs = []
    for label, source, graphs in (("spec-model-draft", "model", True),
                                  ("spec-model-draft", "model", False),
                                  ("spec-ngram-draft", "ngram", True),
                                  ("spec-ngram-draft", "ngram", False)):
        engine = None                          # free the previous engine
        fresh_memory(torch, device)
        engine = ServeEngine(model, params, max_seq=1024, plan=plan,
                             kv_precision="int8", device=device,
                             spec=SpecConfig(k=SPEC_K, draft_source=source),
                             cuda_graphs=graphs)
        t0 = time.perf_counter()
        engine.draft_params                    # the draft, derived once
        sync()
        draft_s = time.perf_counter() - t0
        build.reset_launches()                 # main path: counts from 0
        (outs, stats), peak, serve_peak = serve_peaks(
            torch, device, lambda: engine.serve(
                [Request(rid=i, prompt=p, max_new_tokens=32)
                 for i, p in enumerate(prompts)], num_slots=SLOTS,
                chunk=CHUNK))
        counts = dict(build.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        for o in outs:
            gen_toks = o.generated
            if (len(gen_toks) != 32 or gen_toks.min() < 0
                    or gen_toks.max() >= cfg.vocab_size
                    or not np.all(np.isfinite(o.logprobs))):
                raise AssertionError(f"{label}: bad output for request "
                                     f"{o.rid}: {gen_toks}")
        agree = float(np.mean([np.mean(o.generated == b.generated)
                               for o, b in zip(outs, base_outs)]))
        run = dict(run=label, kv="int8", k=SPEC_K,
                   cuda_graphs=engine.graphs is not None,
                   requests=len(outs),
                   generated=stats.generated_tokens,
                   tokens_per_s=stats.tokens_per_s,
                   ttft_mean_s=stats.ttft_mean_s,
                   tpot_p50_s=stats.tpot_p50_s,
                   decode_chunk_p50_s=stats.decode_gap_p50_s,
                   wall_s=stats.wall_s, rounds_run=stats.decode_steps,
                   spec_rounds=stats.spec_rounds,
                   acceptance_rate=stats.acceptance_rate,
                   tokens_per_round=stats.tokens_per_round,
                   draft_derive_s=draft_s,
                   draft_overhead_bytes=engine.draft_overhead_bytes(),
                   draft_weight_bytes=engine.draft_weight_bytes(),
                   weight_bytes=engine.weight_bytes(),
                   max_memory_allocated=peak,
                   serve_max_memory_allocated=serve_peak,
                   launches=counts,
                   greedy_agreement_with_nonspec=agree,
                   bigram_repeat_share=repeat_share(outs),
                   chunk=chunk_readings(torch, build, engine, prompts,
                                        device))
        log("spec serve: " + json.dumps(run))
        runs.append(run)
        if graphs:
            graph_outs = outs
            if source == "model":
                model_outs = outs
                report["spec_readings"] = spec_readings(torch, model, engine,
                                                        prompts, device)
        else:
            require_same(label, graph_outs, outs, logprobs=True)
            run["identical_to_graph_run"] = True
    report["spec_runs"] = runs
    return launches, model_outs


def serve_paged(torch, build, report: dict, model, params, plan, prompts,
                base_outs, spec_outs, device: str) -> dict:
    """Phase 4c: the paged KV pool (pages of PAGE tokens) at full width.
    Phase 4's requests on the EWQ plan with int8 KV from an equal-memory
    pool with prefix sharing on (tokens and logprobs identical to phase
    4's dense run), one decode step's device time paged against dense; a
    shared-prefix stream from an 11-page pool (backpressure, prefix hits,
    no leak), against the same stream without sharing from a 20-page pool
    and from the dense engine; phase 4b's model-draft speculative serve
    over the equal-memory pool (tokens identical to phase 4b's). Returns
    the launches of the serves."""
    import numpy as np
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.pool import PagedConfig
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.spec import SpecConfig
    cfg = model.cfg
    launches = {k: 0 for k in build.LAUNCHES}
    runs = []

    def serve(engine, prompt_list, label):
        build.reset_launches()                 # main path: counts from 0
        (outs, stats), peak, serve_peak = serve_peaks(
            torch, device, lambda: engine.serve(
                [Request(rid=i, prompt=p, max_new_tokens=32)
                 for i, p in enumerate(prompt_list)], num_slots=SLOTS,
                chunk=CHUNK))
        counts = dict(build.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        for o in outs:
            if (len(o.generated) != 32 or o.generated.min() < 0
                    or o.generated.max() >= cfg.vocab_size
                    or not np.all(np.isfinite(o.logprobs))):
                raise AssertionError(f"{label}: bad output for request "
                                     f"{o.rid}: {o.generated}")
        run = dict(run=label, cuda_graphs=engine.graphs is not None,
                   requests=len(outs),
                   generated=stats.generated_tokens,
                   tokens_per_s=stats.tokens_per_s,
                   ttft_mean_s=stats.ttft_mean_s,
                   tpot_p50_s=stats.tpot_p50_s,
                   decode_chunk_p50_s=stats.decode_gap_p50_s,
                   wall_s=stats.wall_s, pool_pages=stats.pool_pages_total,
                   pool_pages_peak=stats.pool_pages_peak,
                   prefix_hits=stats.prefix_hits,
                   prefix_hit_tokens=stats.prefix_hit_tokens,
                   cow_copies=stats.cow_copies, requeues=stats.requeues,
                   kv_bytes_peak=stats.kv_bytes_peak,
                   spec_rounds=stats.spec_rounds,
                   acceptance_rate=stats.acceptance_rate,
                   max_memory_allocated=peak,
                   serve_max_memory_allocated=serve_peak,
                   launches=counts)
        log("paged serve: " + json.dumps(run))
        runs.append(run)
        return outs, stats, run

    same = same_outputs

    # -- 1) phase 4's requests from an equal-memory pool, eagerly then from
    # CUDA graphs (held equal to the bit) ------------------------------------
    fresh_memory(torch, device)
    peng = ServeEngine(model, params, max_seq=1024, plan=plan,
                       kv_precision="int8", device=device,
                       paged=PagedConfig(page_size=PAGE), cuda_graphs=False)
    e_outs, _, e_run = serve(peng, prompts, "paged-ewq-int8")
    e_run["chunk"] = chunk_readings(torch, build, peng, prompts, device)
    peng = None
    fresh_memory(torch, device)
    peng = ServeEngine(model, params, max_seq=1024, plan=plan,
                       kv_precision="int8", device=device,
                       paged=PagedConfig(page_size=PAGE))
    outs, _, run = serve(peng, prompts, "paged-ewq-int8")
    run["chunk"] = chunk_readings(torch, build, peng, prompts, device)
    require_same("paged-ewq-int8", outs, e_outs, logprobs=True)
    run["identical_to_eager_run"] = True
    if not same(outs, base_outs, logprobs=True):
        raise AssertionError("the paged serve's tokens or logprobs differ "
                             "from phase 4's dense serve")
    run["identical_to_dense"] = True
    # the dense engine on the same quantized weights (no second plan pass)
    dense = ServeEngine(model, peng.params, max_seq=1024,
                        kv_precision="int8", device=device)
    readings = dict(dense_tokens_per_s=report["runs"][0]["tokens_per_s"],
                    dense_ttft_mean_s=report["runs"][0]["ttft_mean_s"],
                    paged_tokens_per_s=run["tokens_per_s"],
                    paged_ttft_mean_s=run["ttft_mean_s"])
    if device == "cuda":
        for label, eng in (("dense", dense), ("paged", peng), ("dense", dense),
                           ("paged", peng)):
            state = eng.init_decode_state(SLOTS)
            for slot in range(SLOTS):
                eng.insert(state, slot, eng.prefill_request(prompts[slot]),
                           32)
            toks = torch.argmax(state.last_logits[:, :cfg.vocab_size],
                                -1)[:, None]
            eager, dev_ms = step_ms(torch, model, eng.params, state, toks)
            readings.setdefault(f"{label}_step_eager_ms", []).append(eager)
            readings.setdefault(f"{label}_step_device_ms", []).append(dev_ms)
            state = None
        log(f"paged: one decode step at {SLOTS} slots (EWQ, int8 KV), "
            f"dense then paged, twice: device ms "
            f"{readings['dense_step_device_ms']} / "
            f"{readings['paged_step_device_ms']}, eager ms "
            f"{readings['dense_step_eager_ms']} / "
            f"{readings['paged_step_eager_ms']}")

    # -- 2) a shared-prefix stream from an 11-page pool ---------------------
    rng = np.random.RandomState(1)
    prefix = rng.randint(0, cfg.vocab_size, size=(256,))
    stream = [np.concatenate([prefix, rng.randint(0, cfg.vocab_size,
                                                  size=(32,))])
              .astype(np.int32) for _ in range(8)]
    seng = ServeEngine(model, peng.params, max_seq=1024, kv_precision="int8",
                       device=device,
                       paged=PagedConfig(page_size=PAGE, pool_pages=11))
    s_outs, s_stats, s_run = serve(seng, stream, "paged-shared-prefix-11")
    pool = seng.pool
    checks = {
        "prefix_hits == 7": s_stats.prefix_hits == 7,
        "prefix_hit_tokens == 7 * 256": s_stats.prefix_hit_tokens == 7 * 256,
        "pool_pages_peak <= 11": s_stats.pool_pages_peak <= 11,
        "an admission was requeued": s_stats.requeues >= 1,
        "only the prefix cache holds pages after the run":
            pool.pages_in_use == pool.prefix.evictable(pool._ref)}
    flushed = pool.flush_prefix()
    checks["pool.pages_in_use == 0 after flushing the prefix cache"] = \
        pool.pages_in_use == 0
    pool.check_invariants()
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"shared-prefix stream: {failed} ({s_run})")
    n_outs, _, n_run = serve(
        ServeEngine(model, peng.params, max_seq=1024, kv_precision="int8",
                    device=device,
                    paged=PagedConfig(page_size=PAGE, pool_pages=20,
                                      prefix_sharing=False)),
        stream, "paged-no-sharing-20")
    d_outs, _, d_run = serve(dense, stream, "dense-shared-prefix-stream")
    readings.update(
        stream_kv_bytes_peak=s_stats.kv_bytes_peak,
        stream_dense_reservation=SLOTS * dense.kv_bytes_per_slot(),
        stream_flushed_prefix_pages=flushed,
        stream_ttft_mean_s_sharing=s_run["ttft_mean_s"],
        stream_ttft_mean_s_no_sharing=n_run["ttft_mean_s"],
        stream_ttft_mean_s_dense=d_run["ttft_mean_s"],
        stream_greedy_agreement_with_dense=float(np.mean(
            [np.mean(o.generated == d.generated)
             for o, d in zip(s_outs, d_outs)])),
        stream_no_sharing_identical_to_dense=same(n_outs, d_outs, True))
    if device == "cuda" and not s_run["ttft_mean_s"] < n_run["ttft_mean_s"]:
        raise AssertionError(
            f"shared-prefix stream: mean TTFT with sharing "
            f"{s_run['ttft_mean_s']} s is not below the stream without "
            f"sharing ({n_run['ttft_mean_s']} s)")
    log(f"paged: shared-prefix stream: {json.dumps(checks)}; KV bytes at "
        f"peak {readings['stream_kv_bytes_peak']:.0f} against the dense "
        f"reservation {readings['stream_dense_reservation']:.0f}; mean TTFT "
        f"{s_run['ttft_mean_s']:.4f} s with sharing, "
        f"{n_run['ttft_mean_s']:.4f} s without (20 pages), "
        f"{d_run['ttft_mean_s']:.4f} s dense; greedy agreement with the "
        f"dense serve {readings['stream_greedy_agreement_with_dense']:.4f}")
    seng = dense = peng = None

    # -- 3) phase 4b's model-draft spec serve over the pool -------------------
    fresh_memory(torch, device)
    speng = ServeEngine(model, params, max_seq=1024, plan=plan,
                        kv_precision="int8", device=device,
                        spec=SpecConfig(k=SPEC_K),
                        paged=PagedConfig(page_size=PAGE))
    sp_outs, _, sp_run = serve(speng, prompts, "paged-spec-model-draft")
    if not same(sp_outs, spec_outs, logprobs=False):
        raise AssertionError("the paged spec serve's tokens differ from "
                             "phase 4b's dense spec serve")
    sp_run["identical_to_dense_spec"] = True
    report.update(paged_runs=runs, paged_readings=readings)
    return launches


def spec_readings(torch, model, eng, prompts, device: str) -> dict:
    """On freshly admitted slots: a (K+1)-token verify window through the
    kernels against the plain versions, and against K+1 single-query
    decode steps (the check that the causal offsets are right); one fused
    propose step against the draft's decode step on a clone of the cache,
    with the real cache unchanged to the byte; and the window run with
    causal=False, a planted fault the limit must catch."""
    from repro_torch.models.common import dtype_of
    from repro_torch.quant.apply import segment_slices
    from repro_torch.quant.kvcache import clone_cache
    cfg = model.cfg
    state = eng.init_decode_state(SLOTS)
    for slot in range(SLOTS):
        eng.insert(state, slot, eng.prefill_request(prompts[slot]), 32)
    gen = torch.Generator(device=device).manual_seed(1)
    first = torch.argmax(state.last_logits[:, :cfg.vocab_size], -1)
    window = torch.cat([first[:, None], torch.randint(
        0, cfg.vocab_size, (SLOTS, SPEC_K), generator=gen, device=device)], 1)

    def verify(plain=False):
        logits, _ = model.spec_verify(eng.params, clone_cache(state.cache),
                                      window, plain=plain)
        return logits.float()

    k_win, p_win = verify(), verify(plain=True)
    if not bool(torch.isfinite(k_win).all()):
        raise AssertionError("non-finite verify logits through the kernels")
    cache, steps = clone_cache(state.cache), []
    for i in range(SPEC_K + 1):
        logits, cache = model.decode_step(eng.params, cache,
                                          window[:, i:i + 1])
        steps.append(logits.float())
    steps = torch.cat(steps, dim=1)
    with noncausal_attention():
        f_win = verify()
    draft = eng.draft_params
    n_draft = segment_slices(draft["layers"])[-1][2]
    fk = torch.zeros((n_draft, SLOTS, SPEC_K, cfg.num_kv_heads,
                      cfg.head_dim), dtype=dtype_of(cfg), device=device)
    before = [t.clone() for t in cache_tensors(state.cache)]
    p_logits, _, _ = model.draft_propose_step(
        draft, state.cache, fk, torch.zeros_like(fk), 0, first[:, None])
    unchanged = all(torch.equal(a, b) for a, b in
                    zip(before, cache_tensors(state.cache)))
    d_logits, _ = model.decode_step(draft, clone_cache(state.cache),
                                    first[:, None])
    readings = dict(
        window_vs_plain=window_rel_l2(k_win, p_win),
        window_vs_steps=window_rel_l2(k_win, steps),
        propose_vs_step=rel_l2(p_logits.float(), d_logits.float()),
        window_noncausal_fault=window_rel_l2(f_win, p_win),
        cache_unchanged_by_propose=unchanged,
        window_greedy_agreement=float(
            (k_win.argmax(-1) == p_win.argmax(-1)).float().mean()))
    log(f"spec: {SPEC_K + 1}-token verify window (largest relative L2 over "
        f"its positions, limit {LOGIT_REL_L2}): kernels vs plain versions "
        f"{readings['window_vs_plain']:.4g}; kernels vs {SPEC_K + 1} "
        f"single-query decode steps {readings['window_vs_steps']:.4g}; "
        f"fused propose step vs draft decode step on a clone "
        f"{readings['propose_vs_step']:.4g}, cache unchanged by the propose: "
        f"{unchanged}; planted fault (causal=False) vs plain versions "
        f"{readings['window_noncausal_fault']:.4g}")
    for name in ("window_vs_plain", "window_vs_steps", "propose_vs_step"):
        if readings[name] > LOGIT_REL_L2:
            raise AssertionError(f"{name}: relative L2 {readings[name]} "
                                 f"above {LOGIT_REL_L2}")
    if not unchanged:
        raise AssertionError("the fused propose wrote the cache")
    if readings["window_noncausal_fault"] <= LOGIT_REL_L2:
        raise AssertionError(
            f"the logit limit {LOGIT_REL_L2} misses the planted causal=False "
            f"fault (relative L2 {readings['window_noncausal_fault']})")
    return readings



# ---------------------------------------------------------------------------
# phase 5: the EWQ analysis through the entropy kernel
# ---------------------------------------------------------------------------

def analyze_model(torch, build, report: dict, model, params,
                  device: str) -> tuple:
    """Phase 5 for one model: ``analyze_blocks`` over every block in
    mode="kernel" (the entropy kernel, one call per matrix) and in
    mode="stream" (plain tensor ops), each timed; the per-matrix entropies
    of the two within ENTROPY_TOL * max(1, |H|) and ENTROPY_ABS; the
    4bit/8bit plans of both (the plan ``plan_model(variant="4bit/8bit",
    mode=...)`` gives), equal on every block whose distance to the plan's
    thresholds exceeds the largest difference measured between the two
    (random blocks of one shape have nearly equal entropies, so a block on
    a threshold may fall either way). Returns (the kernel-mode entropies, entropy launches)."""
    from repro_torch.core import policy
    from repro_torch.core.planner import analyze
    cfg = model.cfg
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    blocks = model.block_params(params)
    timed = {}
    for mode in ("kernel", "stream", "kernel"):
        sync()
        build.reset_launches()
        t0 = time.perf_counter()
        ents = analyze(blocks, mode=mode)
        sync()
        timed.setdefault(mode, []).append((time.perf_counter() - t0, ents))
        if mode == "kernel":
            launches = build.LAUNCHES["entropy"]
    ek, es = timed["kernel"][-1][1], timed["stream"][0][1]
    n_mats = sum(len(b.per_matrix) for b in ek)
    nbytes = sum(t.numel() * t.element_size()
                 for blk in blocks for t in _matrices(blk))
    mat_err = 0.0
    for bk, bs in zip(ek, es):
        for name, (hk, _) in bk.per_matrix.items():
            hs = bs.per_matrix[name][0]
            mat_err = max(mat_err, abs(hk - hs))
            fault = entropy_fault(hk, hs)
            if fault:
                raise AssertionError(f"{cfg.name} {name} of block "
                                     f"{bk.block_index}: kernel {hk} "
                                     f"against stream {hs}: {fault}")
    blk_err = max(abs(a.entropy - b.entropy) for a, b in zip(ek, es))
    pk = policy.decide(ek, aggressive="int4")
    ps = policy.decide(es, aggressive="int4")
    slack = blk_err + abs(pk.threshold - ps.threshold) + abs(pk.mu - ps.mu)
    decided, differ = 0, []
    for dk, ds in zip(pk.decisions, ps.decisions):
        margin = min(abs(dk.entropy - pk.threshold), abs(dk.entropy - pk.mu))
        if margin > slack:
            decided += 1
            if dk.precision != ds.precision:
                raise AssertionError(
                    f"{cfg.name} block {dk.block_index}: kernel-mode plan "
                    f"{dk.precision}, stream-mode plan {ds.precision}, "
                    f"margin {margin} > {slack}")
        elif dk.precision != ds.precision:
            differ.append(dk.block_index)
    out = dict(model=cfg.name, blocks=len(ek), matrices=n_mats,
               bytes=nbytes, entropy_launches=launches,
               kernel_s=[t for t, _ in timed["kernel"]],
               stream_s=timed["stream"][0][0],
               max_matrix_abs_diff=mat_err, max_block_abs_diff=blk_err,
               threshold=pk.threshold, mu=pk.mu, sigma=pk.sigma,
               plan_kernel=pk.counts(), plan_stream=ps.counts(),
               blocks_held_equal=decided,
               blocks_within_slack_that_differ=differ)
    log("analysis: " + json.dumps(out))
    report.setdefault("analysis", []).append(out)
    return ek, launches


def _matrices(tree) -> list:
    """The >= 2-D tensors of a block (the matrices the analysis reads)."""
    from repro_torch.tree import tree_leaves
    return [t for t in tree_leaves(tree) if t.ndim >= 2]


# ---------------------------------------------------------------------------
# phase 4d: whisper-medium (enc-dec) serve at full width
# ---------------------------------------------------------------------------

WHISPER_MAX_SEQ = 448   # whisper's published decoder context (n_text_ctx)


def whisper_requests(cfg) -> list:
    """8 requests: decoder prompts of 4-32 tokens (numpy seed 0) and one
    (encoder_seq, d_model) frame block each, standard normal (numpy seed
    2, the encoder input's scale in the reference's synthetic data)."""
    import numpy as np
    from repro_torch.serving.scheduler import Request
    rng = np.random.RandomState(0)
    lens = rng.randint(4, 33, size=8)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in lens]
    frng = np.random.RandomState(2)
    return [Request(rid=i, prompt=p, max_new_tokens=32,
                    frames=frng.standard_normal(
                        (cfg.encoder_seq, cfg.d_model)).astype(np.float32))
            for i, p in enumerate(prompts)]


def serve_whisper(torch, build, report: dict, smoke: bool = False,
                  device: str = "cuda") -> dict:
    """Phases 5 and 4d for whisper-medium FULL (24 + 24 layers, d_model
    1024, 16 heads of 64, d_ff 4096, vocab 51865) from seeded random
    weights: the analysis through the entropy kernel (phase 5), whose
    4bit/8bit plan then serves 8 requests with frames at 4 slots, chunk 8,
    max_seq 448, int8 self and cross KV (phase 4d); then an explicit plan
    (each stack cycling raw, int8, int4, ternary; int8 embedding) with int4
    KV, so every precision path runs, the encoder's quantized MLP among
    them. On each engine one decode step through the kernels is held to
    the plain versions (LOGIT_REL_L2 on the logits, CROSS_REL_L2 on each
    decoder layer's cross-attention output, which the slots' cross caches
    rotated must fail); on the explicit plan's engine also a planted fault
    that the logit limit must catch (one int4 decoder layer's nibbles
    swapped). Returns the launches of the analysis (entropy) and of the
    serves."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import policy
    from repro_torch.models.model import build as build_model
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.quantized import explicit_plan

    cfg = get_config("whisper-medium", smoke=smoke)
    model = build_model(cfg)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    sync()
    log(f"whisper: {cfg.name} {cfg.num_encoder_layers}+{cfg.num_layers}L "
        f"d_model {cfg.d_model} {cfg.num_heads}H/{cfg.num_kv_heads}KV hd "
        f"{cfg.head_dim} d_ff {cfg.d_ff} {cfg.mlp_act} vocab "
        f"{cfg.vocab_size} encoder_seq {cfg.encoder_seq} {cfg.dtype}; "
        f"random init {time.perf_counter() - t0:.1f} s")
    launches = {k: 0 for k in build.LAUNCHES}
    ents, launches["entropy"] = analyze_model(torch, build, report, model,
                                              params, device)
    ewq = policy.decide(ents, aggressive="int4")    # the 4bit/8bit variant
    log(f"whisper: EWQ 4bit/8bit plan from the kernel-mode entropies: "
        f"{ewq.counts()} precisions {ewq.precisions()}")
    tiers = ["raw", "int8", "int4", "ternary"]
    stack = [tiers[i * len(tiers) // cfg.num_layers]
             for i in range(cfg.num_layers)]
    explicit = explicit_plan(cfg, stack * 2, embed_precision="int8")
    runs = []
    # EWQ from CUDA graphs, then eagerly (held equal to the bit), then
    # eagerly with each prompt run as single-token steps (the TTFT of the
    # older prefill); the explicit plan from CUDA graphs
    engine = None
    for label, plan, kv, graphs, scan in (
            ("whisper-ewq-4bit/8bit", ewq, "int8", True, False),
            ("whisper-ewq-4bit/8bit", ewq, "int8", False, False),
            ("whisper-ewq-4bit/8bit", ewq, "int8", False, True),
            ("whisper-explicit-all-precisions", explicit, "int4", True,
             False)):
        if not scan:
            engine = None                      # free the previous engine
        fresh_memory(torch, device)
        if not scan:
            engine = ServeEngine(model, params, max_seq=WHISPER_MAX_SEQ,
                                 plan=plan, kv_precision=kv, device=device,
                                 cuda_graphs=graphs)
        run, counts, outs = whisper_run(torch, build, model, engine, label,
                                        kv, plan, device,
                                        readings=graphs, scan=scan)
        for k, v in counts.items():
            launches[k] += v
        runs.append(run)
        if kv == "int8" and graphs:
            graph_outs = outs
        elif kv == "int8" and not scan:
            require_same(label, graph_outs, outs, logprobs=True)
            run["identical_to_graph_run"] = True
    engine = None
    ttft = {r["prefill"] + (" graphs" if r["cuda_graphs"] else " eager"):
            r["ttft_mean_s"] for r in runs if r["kv"] == "int8"}
    log(f"whisper: mean TTFT (EWQ, int8 KV): {json.dumps(ttft)}")
    report["whisper_ttft"] = ttft
    report["whisper_runs"] = runs
    return launches


def whisper_run(torch, build, model, engine, label: str, kv: str, plan,
                device: str, readings: bool = True,
                scan: bool = False) -> tuple:
    """One whisper serve of ``whisper_requests`` and its readings: the
    kernel launches of the encoder for one request and of one decode step;
    that decode step through the kernels against the plain versions, its
    logits (LOGIT_REL_L2) and every decoder layer's cross-attention output
    (CROSS_REL_L2); the cross-attention outputs of the same step with the
    cross caches of the slots rotated (each slot attends over another
    request's encoder output), a planted fault CROSS_REL_L2 must catch in
    every layer; with an int4 decoder layer, the step with that layer's
    nibbles swapped, a planted fault LOGIT_REL_L2 must catch; the step's
    time eager and from a CUDA graph; one decode chunk's wall and device
    time (``chunk_readings``). ``readings=False`` serves and takes the
    chunk readings only; ``scan=True`` serves with every prompt run as
    single-token steps (``token_scan_prefill``). Returns (the run's
    record, the serve's launches, the outputs)."""
    import numpy as np
    from repro_torch.models import encdec
    from repro_torch.quant.kvcache import clone_cache
    cfg = model.cfg
    reqs = whisper_requests(cfg)
    build.reset_launches()                     # main path: counts from 0
    with token_scan_prefill() if scan else contextlib.nullcontext():
        (outs, stats), peak, serve_peak = serve_peaks(
            torch, device, lambda: engine.serve(reqs, num_slots=SLOTS,
                                                chunk=CHUNK))
    counts = dict(build.LAUNCHES)
    for o in outs:
        if (len(o.generated) != 32 or o.generated.min() < 0
                or o.generated.max() >= cfg.vocab_size
                or not np.all(np.isfinite(o.logprobs))):
            raise AssertionError(f"{label}: bad output for request {o.rid}: "
                                 f"{o.generated}")
    by_field = engine.kv_bytes_by_field()
    run = dict(run=label, kv=kv, cuda_graphs=engine.graphs is not None,
               prefill="token scan" if scan else "one step",
               requests=len(outs),
               generated=stats.generated_tokens,
               tokens_per_s=stats.tokens_per_s,
               ttft_mean_s=stats.ttft_mean_s, tpot_p50_s=stats.tpot_p50_s,
               decode_chunk_p50_s=stats.decode_gap_p50_s,
               wall_s=stats.wall_s, weight_bytes=engine.weight_bytes(),
               kv_bytes_per_slot=engine.kv_bytes_per_slot(),
               kv_bytes_per_slot_self=by_field["k"] + by_field["v"],
               kv_bytes_per_slot_cross=(by_field["cross_k"]
                                        + by_field["cross_v"]),
               max_memory_allocated=peak,
               serve_max_memory_allocated=serve_peak,
               plan=plan.counts(), launches=counts)
    for k in WHISPER_PATH:
        if counts[k] <= 0 and device == "cuda":
            raise AssertionError(f"{label}: kernel {k} never launched")
    if not scan:
        run["chunk"] = chunk_readings(torch, build, engine,
                                      [r.prompt for r in reqs], device,
                                      frames=[r.frames for r in reqs])
    if scan or not readings:
        log("whisper serve: " + json.dumps(run))
        return run, counts, outs
    frames = torch.as_tensor(reqs[0].frames, device=device)[None]
    build.reset_launches()
    encdec.encode(engine.params, frames, cfg)
    run["encoder_launches_per_request"] = {
        k: v for k, v in build.LAUNCHES.items() if v}
    state = engine.init_decode_state(SLOTS)
    for slot in range(SLOTS):
        engine.insert(state, slot, engine.prefill_request(
            reqs[slot].prompt, frames=reqs[slot].frames), 32)
    toks = torch.argmax(state.last_logits[:, :cfg.vocab_size], -1)[:, None]

    def step_logits(cache, plain=False, params=None):
        logits, _ = model.decode_step(
            engine.params if params is None else params, clone_cache(cache),
            toks, plain=plain)
        return logits.float()

    build.reset_launches()
    with cross_outputs() as k_cross:
        k_logits = step_logits(state.cache)
    run["launches_per_decode_step"] = {
        k: v for k, v in build.LAUNCHES.items() if v}
    with cross_outputs() as p_cross:
        p_logits = step_logits(state.cache, plain=True)
    with cross_outputs() as r_cross:
        step_logits(rotate_cross(torch, state.cache))
    if not bool(torch.isfinite(k_logits).all()):
        raise AssertionError(f"{label}: non-finite logits through the "
                             "kernels")
    rel = rel_l2(k_logits, p_logits)
    cross = [rel_l2(a, b) for a, b in zip(k_cross, p_cross)]
    rotated = [rel_l2(a, b) for a, b in zip(r_cross, p_cross)]
    if not len(cross) == len(rotated) == cfg.num_layers:
        raise AssertionError(f"{label}: {len(cross)} cross-attention "
                             f"outputs recorded, {cfg.num_layers} layers")
    fault = None
    if any(sg.precision == "int4"
           for sg in engine.params["dec_layers"].segments):
        fault = rel_l2(step_logits(state.cache, params=swap_nibbles_one_layer(
            torch, engine.params, "dec_layers")), p_logits)
    agree = float((k_logits.argmax(-1) == p_logits.argmax(-1)).float().mean())
    run.update(logit_rel_l2=rel, logit_rel_l2_planted_fault=fault,
               cross_attn_rel_l2_max=max(cross),
               cross_attn_rel_l2_rotated_min=min(rotated),
               cross_attn_rel_l2=cross, cross_attn_rel_l2_rotated=rotated,
               greedy_agreement=agree)
    if device == "cuda":
        eager_ms, device_ms = step_ms(torch, model, engine.params, state,
                                      toks)
        run["decode_step"] = dict(eager_ms=eager_ms, device_ms=device_ms)
    log("whisper serve: " + json.dumps(run))
    log(f"whisper: {label}: one decode step, kernels vs plain versions: "
        f"relative L2 {rel:.4g} (limit {LOGIT_REL_L2}), greedy agreement "
        f"{agree:.2f}; planted fault (one int4 decoder layer's nibbles "
        f"swapped) {fault if fault is None else format(fault, '.4g')}; "
        f"cross-attention outputs of the {len(cross)} decoder layers, "
        f"kernels vs plain versions: largest relative L2 {max(cross):.4g} "
        f"(limit {CROSS_REL_L2}); each slot reading another request's "
        f"cross cache: smallest {min(rotated):.4g}")
    if rel > LOGIT_REL_L2:
        raise AssertionError(f"{label}: decode logits differ: relative L2 "
                             f"{rel}")
    if fault is not None and fault <= LOGIT_REL_L2:
        raise AssertionError(f"{label}: the logit limit misses the planted "
                             f"fault (relative L2 {fault})")
    if max(cross) > CROSS_REL_L2:
        raise AssertionError(f"{label}: cross-attention outputs differ: "
                             f"relative L2 {cross}")
    if min(rotated) <= CROSS_REL_L2:
        raise AssertionError(f"{label}: the cross-attention limit misses "
                             f"the rotated cross caches (relative L2 "
                             f"{rotated})")
    return run, counts, outs


@contextlib.contextmanager
def token_scan_prefill():
    """The prompt prefill as single-token steps, for the TTFT reading
    it is compared with: one single-token decode step per prompt token in
    place of one multi-query step."""
    from repro_torch.serving.engine import ServeEngine
    saved = ServeEngine._prefill_step

    def scan(self, toks, cache):
        for t in range(toks.shape[1]):
            logits, cache = self.model.decode_step(self.params, cache,
                                                   toks[:, t:t + 1])
        return cache, logits[:, 0]

    ServeEngine._prefill_step = scan
    try:
        yield
    finally:
        ServeEngine._prefill_step = saved


@contextlib.contextmanager
def cross_outputs():
    """Records, in a list it yields, the output of every cross-attention
    call (the decoder's attention over a cached encoder K/V) made inside
    the block, as f32."""
    from repro_torch.models import attention as A
    inner, outs = A.attention, []

    def recording(p, x, **kw):
        out = inner(p, x, **kw)
        if kw.get("cached_kv") is not None:
            outs.append(out[0].float())
        return out

    A.attention = recording
    try:
        yield outs
    finally:
        A.attention = inner


def rotate_cross(torch, cache):
    """A planted fault: ``cache`` with its cross K/V slots rotated by one,
    so each slot attends over another request's encoder output."""
    def roll(field):
        if isinstance(field, tuple):
            return tuple(roll(p) for p in field)
        if isinstance(field, torch.Tensor):
            return field.roll(1, dims=1)
        return dataclasses.replace(
            field, data=field.data.roll(1, dims=1),
            scale=None if field.scale is None else field.scale.roll(1, dims=1))
    return cache._replace(cross_k=roll(cache.cross_k),
                          cross_v=roll(cache.cross_v))


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this run needs one GPU")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    # -- phase 1: device ------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {name} | torch {torch.__version__} cuda {torch.version.cuda}")
    log("tf32: off for matmul and cudnn (f32 products run in full f32)")

    # -- phase 2: build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s ({build.BUILD_INFO})")
    ptxas = {src: build.ptxas_report(src) for src in build.SOURCES}
    for src, kernels in ptxas.items():
        for k in kernels:
            log(f"ptxas {src}: {k.get('registers')} registers, "
                f"{k.get('smem_bytes')} bytes static smem, spill stores "
                f"{k.get('spill_stores')} loads {k.get('spill_loads')} bytes: "
                f"{k['kernel']}")

    # -- phase 3: kernels -------------------------------------------------------
    timer = Timer(torch)
    rows: list = []
    worst = check_kernels(torch, timer, rows)
    log(f"kernels: all within rtol=atol=2e-2 of their plain versions, "
        f"decode attention within relative L2 {ATTN_REL_L2}; max abs err "
        f"{worst}")
    report: dict = {"device": name, "nvidia_smi": smi, "rows": rows,
                    "build": dict(build.BUILD_INFO), "ptxas": ptxas}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    out_file = out_dir / "chip_smoke.json"

    # -- phases 4, 4b, 4c and 5: llama3.2-3b at full width --------------------
    torch.cuda.empty_cache()
    launches = serve_full_width(torch, build, report)
    out_file.write_text(json.dumps(report, indent=1))

    # -- phases 5 and 4d: whisper-medium at full width -------------------------
    torch.cuda.empty_cache()
    for k, v in serve_whisper(torch, build, report).items():
        launches[k] += v
    out_file.write_text(json.dumps(report, indent=1))
    for k, v in launches.items():
        if v <= 0 and k not in OFF_PATH:
            raise AssertionError(f"kernel {k} never launched on the serve "
                                 "and analysis paths")

    # -- phase 6: the kernels line, then the device line last ---------------
    kernels = []
    for kname, (src, replaces) in KERNEL_SOURCES.items():
        shape, prec, m = HEADLINE[kname]
        row = next(r for r in rows if r["kernel"] == kname
                   and r["shape"] == shape and r["precision"] == prec
                   and r["m"] == m)
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": worst[kname], "ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"),
            "library_ms": row.get("library_ms")})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
