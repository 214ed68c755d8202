"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card

Phases, each of which raises (and the script exits non-zero) on failure:

1. device: the card's name and power limit; TF32 off for f32 matmuls.
2. build: nvcc builds every kernel under src/repro_torch/csrc for sm_90a.
3. kernels: each hand-written kernel against its plain PyTorch version at
   the full-width llama3.2-3b shapes (rtol = atol = 2e-2 on bf16 inputs),
   timed with CUDA events (median of 20 after warm-up, L2 flushed before
   each call): the kernel, its plain version, and a PyTorch yardstick that
   the port itself never calls.
4. serve: llama3.2-3b FULL (28 layers, d_model 3072) from seeded random
   weights, EWQ-planned on the card and served with int8 KV, then an
   explicit raw/int8/int4/ternary plan served with int4 KV; every kernel's
   launch count must rise during the serve runs. One decode step through
   the kernels is then held against the plain versions (relative L2 of the
   logits), beside the readings that place that limit: the plain versions
   without their bf16 roundings, the plain versions with only the order of
   their f32 sums changed, and the kernels on params with one int4 layer's
   nibbles swapped (a planted fault the limit must catch).
5. a JSON line naming each kernel, then the device line last.

``--quick`` skips the timings and the lm_head shape (a short first call
after a kernel change); it checks the same M values as the full run.

Imports nothing of JAX; the port is imported from ``src/`` beside this file.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
TOL = dict(rtol=2e-2, atol=2e-2)
QUICK = "--quick" in sys.argv   # skip timings and the lm_head shape
SLOTS = 4                       # decode slots of the serve phase


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
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

def check_kernels(torch, timer, rows: list) -> dict:
    from repro_torch.kernels.decode_attn import ops as DA
    from repro_torch.kernels.qmatmul import ops as QM
    from repro_torch.quant.kvcache import dequantize_kv, make_page
    from repro_torch.quant.quantize import dequantize, quantize

    gen = torch.Generator(device="cuda").manual_seed(0)
    d, ff, vocab = 3072, 8192, 128256
    shapes = {"wq": (3072, d), "wk/wv": (1024, d), "gate/up": (ff, d),
              "down": (d, ff), "lm_head": (vocab, d)}
    # The M values the main path gives the matmul kernels, each kernel
    # instantiation among them: decode runs every slot (M = 4, the MT = 4
    # kernel; 1-3 are the MT = 1, 2 kernels and a masked MT = 4 tile), a
    # prefill's head runs M = 1, and prefill runs M = the prompt length in
    # 8-row tiles: 8, 256, and a serve prompt whose last tile is partial.
    lens = [len(p) for p in serve_prompts(vocab)]
    ragged = next(n for n in lens if n % 8)
    ms_list = (1, 2, 3, SLOTS, 8, 256, ragged)
    precs = ("int8", "int4", "ternary")
    worst = {k: 0.0 for k in ("qmatmul", "qkv", "qmlp", "decode_attn")}

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
                           err_f32=float((got - exact).abs().max()))
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

    # qkv and qmlp: the fused projections and the fused SwiGLU MLP
    for prec in precs:
        wq, wk, wv = (quantize(weight(n, d), prec) for n in (3072, 1024, 1024))
        wg, wu = (quantize(weight(ff, d), prec) for _ in range(2))
        wdn = quantize(weight(d, ff), prec)
        wqkv = torch.cat([dequantize(w, torch.bfloat16) for w in (wq, wk, wv)])
        for m in ms_list:
            x = act(m, d)
            got = QM.qkv_cuda(x, wq, wk, wv)
            want = [QM.qmatmul_plain(x, w) for w in (wq, wk, wv)]
            compare("qkv", got, want)
            row = dict(kernel="qkv", shape="wq|wk|wv 5120x3072",
                       precision=prec, m=m,
                       err=max(float((g - w).abs().max())
                               for g, w in zip(got, want)))
            if not QUICK:
                row["ms"] = timer.ms(lambda: QM.qkv_cuda(x, wq, wk, wv))
                row["plain_ms"] = timer.ms(
                    lambda: QM.fused_qkv_plain(x, wq, wk, wv))
                row["library_ms"] = timer.ms(lambda: x @ wqkv.t())
                row["bound_ms"], row["bound_by"] = bound_ms(
                    m * d * 2 + sum(map(qbytes, (wq, wk, wv))) + m * 5120 * 4,
                    2.0 * m * 5120 * d)
            rows.append(row)
            log(json.dumps(row))

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
        del wq, wk, wv, wg, wu, wdn, wqkv

    # decode attention: one layer's cache at 8 slots x 2048 rows, and at
    # the serve phase's 4 slots x 1024 rows mid-decode
    hkv, rep, hd = 8, 3, 128
    cases = ((8, 2048, [0, 1, 1000, 2048, 517, 64, 1500, 2000]),
             (SLOTS, 1024, [n + 16 for n in lens[:SLOTS]]))
    for b, s, valid_rows in cases:
        valid = torch.tensor(valid_rows, dtype=torch.int32, device="cuda")
        q = torch.randn((b, 1, hkv * rep, hd), generator=gen,
                        device="cuda").to(torch.bfloat16)
        kraw = torch.randn((b, s, hkv, hd), generator=gen, device="cuda")
        vraw = torch.randn((b, s, hkv, hd), generator=gen, device="cuda")
        rows_read = int(valid.clamp(0, s).sum())
        for prec in ("int8", "int4", "bf16"):
            kp, vp = make_page(kraw, prec, 64), make_page(vraw, prec, 64)
            got = DA.decode_attn_cuda(q, kp, vp, valid).float()
            want = DA.decode_attention_plain(q, kp, vp, valid).float()
            compare("decode_attn", [got], [want])
            if 0 in valid_rows and float(
                    got[valid_rows.index(0)].abs().max()) != 0.0:
                raise AssertionError("decode_attn: empty slot must give 0")
            row = dict(kernel="decode_attn", shape=f"B{b} S{s} Hkv{hkv} "
                       f"rep{rep} hd{hd}", precision=prec, m=b,
                       err=float((got - want).abs().max()))
            if not QUICK:
                row["ms"] = timer.ms(
                    lambda: DA.decode_attn_cuda(q, kp, vp, valid))
                row["plain_ms"] = timer.ms(
                    lambda: DA.decode_attention_plain(q, kp, vp, valid))
                kd, vd = (dequantize_kv(p, torch.bfloat16)
                          .repeat_interleave(rep, 2)
                          .transpose(1, 2) for p in (kp, vp))  # (B, H, S, hd)
                qt = q.transpose(1, 2)
                mask = (torch.arange(s, device="cuda")[None, :]
                        < valid[:, None])[:, None, None, :]
                sdpa = torch.nn.functional.scaled_dot_product_attention
                row["library_ms"] = timer.ms(lambda: sdpa(qt, kd, vd,
                                                          attn_mask=mask))
                per_row = (kp.data[0, 0].numel() * kp.data.element_size()
                           + (0 if kp.scale is None
                              else kp.scale[0, 0].numel() * 2))
                row["bound_ms"], row["bound_by"] = bound_ms(
                    2 * rows_read * per_row + q.numel() * 2
                    + b * hkv * rep * hd * 4 + b * 4,
                    4.0 * rows_read * hkv * rep * hd)
                del kd, vd
            rows.append(row)
            log(json.dumps(row))
    return worst


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
    "decode_attn": ("src/repro_torch/csrc/decode_attn.cu",
                    "src/repro/kernels/decode_attn/kernel.py:162"),
}
# the row of each kernel reported on the kernels line: the serve phase's
# decode shape (4 slots) for the matmul kernels
HEADLINE = {"qmatmul": ("wq 3072x3072", "int8", SLOTS),
            "qkv": ("wq|wk|wv 5120x3072", "int8", SLOTS),
            "qmlp": ("swiglu 3072->8192->3072", "int8", SLOTS),
            "decode_attn": ("B8 S2048 Hkv8 rep3 hd128", "int8", 8)}
# Limit on the relative L2 distance of one decode step's logits, kernels
# against plain versions. PERF.md gives the readings that place it: the
# kernels against the plain versions, and against the plain versions
# without their bf16 roundings; the plain versions against themselves with
# their f32 sums reordered; the kernels with one int4 layer's nibbles
# swapped. The run repeats them all and fails if the planted fault falls
# under the limit.
LOGIT_REL_L2 = 5e-2


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


def swap_nibbles_one_layer(torch, params) -> dict:
    """A planted fault: ``params`` with the first int4 layer's payload
    bytes nibble-swapped (the other layers are shared, not copied)."""
    from repro_torch.quant.qtypes import QTensor
    from repro_torch.tree import tree_map
    layers = params["layers"]
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
    return {**params, "layers": dataclasses.replace(layers, segments=segs)}


def clone_cache(torch, cache):
    """Deep copy of a slotted cache whose fields may be KVPages."""
    import dataclasses
    from repro_torch.quant.kvcache import KVPage

    def one(x):
        if isinstance(x, tuple):
            return tuple(one(p) for p in x)
        if isinstance(x, KVPage):
            return dataclasses.replace(
                x, data=x.data.clone(),
                scale=None if x.scale is None else x.scale.clone())
        return x.clone()
    return type(cache)(*(one(f) for f in cache))


def serve_full_width(torch, build, report: dict, smoke: bool = False,
                     device: str = "cuda") -> dict:
    """Phase 4 (``smoke``/``device`` rehearse it at SMOKE size on a CPU)."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build as build_model
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
    engine = None
    for label, plan, kv in (("ewq-4bit/8bit", ewq, "int8"),
                            ("explicit-all-precisions", explicit, "int4")):
        engine = None                          # free the previous engine
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        engine = ServeEngine(model, params, max_seq=1024, plan=plan,
                             kv_precision=kv, device=device)
        build.reset_launches()                 # main path: counts from 0
        outs, stats = engine.serve(requests(), num_slots=SLOTS, chunk=8)
        sync()
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
        run = dict(run=label, kv=kv, requests=len(outs),
                   generated=stats.generated_tokens,
                   tokens_per_s=stats.tokens_per_s,
                   ttft_mean_s=stats.ttft_mean_s,
                   tpot_p50_s=stats.tpot_p50_s,
                   decode_chunk_p50_s=stats.decode_gap_p50_s,
                   wall_s=stats.wall_s,
                   weight_bytes=engine.weight_bytes(),
                   kv_bytes_per_slot=engine.kv_bytes_per_slot(),
                   max_memory_allocated=(torch.cuda.max_memory_allocated()
                                         if device == "cuda" else None),
                   launches=counts)
        log("serve: " + json.dumps(run))
        runs.append(run)
    for k, v in launches.items():
        if v <= 0 and device == "cuda":
            raise AssertionError(f"kernel {k} never launched on the main path")

    # first decode step through the kernels against the plain versions, on
    # the explicit plan's params and an identical int4 cache
    eng = engine
    state = eng.init_decode_state(SLOTS)
    for slot in range(SLOTS):
        eng.insert(state, slot, eng.prefill_request(prompts[slot]), 32)
    toks = torch.argmax(state.last_logits[:, :cfg.vocab_size], -1)[:, None]

    def step_logits(params, plain=False):
        logits, _ = model.decode_step(params, clone_cache(torch, state.cache),
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
    if device != "cuda":
        return launches

    # where a decode step's time goes: the same step eagerly (host
    # dispatch included) and replayed from a CUDA graph (device time only)
    cache = clone_cache(torch, state.cache)

    def step():
        model.decode_step(eng.params, cache, toks)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    eager_ms = sorted(walls)[2]
    device_ms = replay_ms(torch, capture(torch, step))
    log(f"serve: one decode step at {SLOTS} slots (explicit plan, int4 "
        f"KV): eager {eager_ms:.2f} ms wall, device {device_ms:.2f} ms (CUDA graph "
        f"replay); the device is busy {device_ms / eager_ms:.0%} of the "
        f"eager step")
    report["decode_step"] = dict(eager_ms=eager_ms, device_ms=device_ms)
    return launches


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

    # -- phase 3: kernels -------------------------------------------------------
    timer = Timer(torch)
    rows: list = []
    worst = check_kernels(torch, timer, rows)
    log(f"kernels: all within rtol=atol=2e-2 of their plain versions; "
        f"max abs err {worst}")
    report: dict = {"device": name, "nvidia_smi": smi, "rows": rows,
                    "build": dict(build.BUILD_INFO)}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    out_file = out_dir / "chip_smoke.json"

    # -- phase 4: full-width serve -----------------------------------------
    torch.cuda.empty_cache()
    launches = serve_full_width(torch, build, report)
    out_file.write_text(json.dumps(report, indent=1))

    # -- phase 5: the kernels line, then the device line last ---------------
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
