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
   before each call): the kernel, its plain version (only at the row each
   kernel reports on the kernels line, HEADLINE, and at one decode-step row
   of each form the MoE and whisper paged / spec serves brought,
   PLAIN_ROWS; PERF.md keeps the other shapes' plain times from earlier
   runs), and a PyTorch yardstick that
   the port itself never calls. The matmul kernels at
   llama3.2-3b's and whisper-medium's shapes, qmatmul and qkv also within
   QMATMUL_F32 of the f32 dequantized product, the fused MLP (swiglu and
   gelu) within QMLP_F32 of the MLP in f32 (``fused_mlp_f32``: weights
   dequantized to f32, the hidden kept in f32), each equal to the bit over
   two calls, with the launch each shape gets (grid, cluster, blocks per
   SM; the MLP's partial-buffer bytes), qmatmul refusing a weight group
   other than 128; the fused MLP's yardstick is the composition of its
   cuBLAS products and elementwise steps on the weights dequantized to
   bf16 (4 calls for swiglu, 3 for gelu), not one call; decode attention
   in its forms
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
   decoder cache and cross-attention (causal=False over 1500 rows, hd 64).
   zamba2-2.7b's attention (4 slots x 1024 rows, 32 KV heads of hd 80,
   group 64) in every form and precision, dense and paged, a group of 80
   at hd 80 and int4 at an odd Hkv (3 heads of 64); the refusals of what
   the kernel has no copy for (attn_refusals); the matmul kernels at
   zamba2's and mamba2's shapes at M = 1 and 4 (RECURRENT_SHAPES; every
   fused-MLP case is in qmlp_cases). The MoE family's (MOE_SHAPES,
   moe_ms): the routers (N = 8 for grok-1, 128 for arctic, f32 out),
   grok's and arctic's attention output projections (wo), their
   projections (qkv) and arctic's dense residual MLP (FF 4864, a ragged
   last 512-row part), each at a decode step, a verify window and a
   prompt;
   decode attention at 6 and 7 query heads a KV head (30 and 35 query rows
   in a verify window) in the single-query, window, fresh-row and paged
   forms; whisper's self-attention from a pool and its verify window
   (self, and cross-attention with causal=False over 1500 rows). The
   entropy kernel (within 1e-3 * max(1, |H|) and 1e-5 absolute, at the
   weight scale and the reference test's, with a weighted ragged tail),
   one array a launch and grouped (llama3.2-3b's embedding and one layer's
   matrices and the ragged vector in one launch, each H equal to the bit
   to its single launch and over two launches), and the int8 quantize
   kernel (payload and scales equal to the bit; groups of 128 and 64, and
   its warp-per-group path: a group of 24, a view off 16-byte alignment).
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
4k. (after 4, before 4b) FastEWQ, the paper's second method, on phase 4's
   llama3.2-3b FULL model, params, requests and EWQ plan (no second
   load or analysis; ``serve_fastewq``). (a) A random forest trained by
   ``train_fastewq`` on 30 seeded models shaped like the paper's dataset
   (``fastewq_rows``, ~700 block rows): held-out accuracy beside the
   majority baseline, ``evaluate_all_classifiers``' accuracy and AUC for
   the six classifiers, the forest's feature importances. (b) The
   classifier's plan of llama from its block sizes alone (host us beside
   phase 4's EWQ analysis s), its block agreement with the EWQ plan
   (quantized or not: the paper's measure; no limit, the weights are
   seeded random), compiled and served from CUDA graphs with int8 KV: 32
   valid tokens a request, every kernel its precisions reach launched,
   its weight bytes beside the plan's and the EWQ run's. (c) Algorithm 2
   (``fastewq_resource_adjust``) of that plan against the card's memory,
   and of grok-1-314b's and arctic-480b's FastEWQ plans at full depth
   from meta-device sizes (no byte allocated, asserted). (d) Algorithm 1
   (``fit_plan_to_hbm``) of the EWQ plan to a 3 GiB weight budget (4 GiB
   less a quarter), which demotes blocks: compiled (the plan's bytes,
   ``weight_bytes`` and the rise of ``memory_allocated`` across the
   compile, each at most 3 GiB, beside the bytes the engine's tensors
   hold) and served from graphs as in (b). (e) The FastEWQ KV spill
   ladder of llama from an int8 base at (b)'s engine's cuts: each tier
   lower than the last, the last all int4.
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
   the prefix 7 times, score each hit's suffix in one multi-query step,
   requeue at least once, leak nothing and take less device time a hit's
   prefill (median, torch.profiler) than a prefill of the same stream
   without sharing (wall times and mean TTFTs readings, beside dense); phase
   4b's model-draft speculative serve over the pool (tokens identical).
4i. degradation and fault tolerance (``serve_degrade``), on phase 4c's
   compiled EWQ weights (no second analysis or compile) and phase 4's
   requests: the entropy-ordered KV ladder (tiers, labels, pages a tier);
   a 10-page pool (pages of 64; any two of the first four requests fit at
   tier 0, no three) under DegradeConfig(cooldown=2, headroom=0.3), from
   CUDA graphs and eagerly (equal to the bit, the same transitions), which
   must spill and promote back (two transitions or more, decode steps at
   tier 0 and below it), complete every request, leak no page, launch
   DEGRADE_PATH's kernels (the paged attention kernel at a degraded tier)
   and hold no dead pool after its last transition; each transition's
   wall ms and transient bytes, the bytes allocated and reserved before
   the first and after the last; a live pool repacked by
   ``apply_kv_plan`` at a spill and at a promotion, each equal to the bit
   to ``repack_pool_field`` on a CPU copy (the repack's device ms beside
   the pool's bytes); two replica engines over the same weights under
   ``ReplicaServe``, fault-free and with replica 1 killed (the same greedy
   tokens, one restart, requests re-driven, clean pools; recovery p95 and
   the largest logprob difference read), and a tick stalled STALL_S
   under a WATCHDOG_S deadline (a watchdog trip, the same tokens). The
   share of tokens equal to phase 4's undegraded serve is a reading. The
   replica-kill serve runs with a metrics registry installed (4j (c)):
   one ``serve_replica_restarts_total``, ``serve_chaos_faults_total``
   equal to the injector's log, one ``serve_recovery_seconds`` sample,
   and per-replica labels on the aggregate's ``registry``.
4j. (after 4c, before 4i) observability (``serve_observed``) on phase
   4c's compiled EWQ weights with int8 KV (no second analysis or compile)
   and phase 4's 8 requests, from CUDA graphs. (a) With a ``Tracer`` and a
   ``MetricsRegistry`` installed: tokens and logprobs equal to phase 4's
   to the bit, no open span, every request's phases queued -> prefill ->
   decode -> finish, ``serve_generated_tokens_total`` equal to the
   tokens generated, ``ServeStats.from_registry(stats.registry) ==
   stats``; tokens/s beside the same engine's untraced serve just before
   and phase 4's (readings, beside the 2% tracing budget of the
   reference's benchmark). (b) Also with
   ``ProfileHooks(steps=(CHUNK, 3 * CHUNK), device_fences=True)``: the
   same tokens and logprobs, one device_ms (CUDA events around the
   chunk's graph replay) and host_gap_ms per decode chunk with 0 <
   device_ms <= the chunk's gap, one profiler window whose Chrome trace
   names the port's kernels (OBS_KERNELS, their ``__global__`` names);
   the device ms of each port kernel and of everything else inside the
   window, each one's share, and the chunks' median device ms beside
   phase 4's replayed chunk (readings). The sinks are installed and
   removed in ``try`` / ``finally``; no later phase is traced.
5. analysis: ``analyze_blocks`` over every matrix of llama3.2-3b FULL (197
   matrices) and of whisper-medium FULL through the entropy kernel
   (mode="kernel": one grouped launch a model) and in plain tensor ops
   (mode="stream"), timed in turns with a loop of single-matrix launches
   and a float() each (the per-matrix path); one launch, entropies
   equal to the loop's to the bit and within 1e-3 * max(1, |H|) and 1e-5
   of stream mode's, plan decisions equal wherever a block is farther from
   the thresholds than the measured difference; the model's bytes and
   bound beside the seconds.
4d. whisper serve: whisper-medium FULL (24 + 24 layers, d_model 1024)
   from seeded random weights, planned 4bit/8bit from phase 5's
   kernel-mode entropies, serves 8 requests with seeded frames at 4
   slots, int8 self and cross KV, from CUDA graphs, then eagerly (equal to
   the bit); one decode step held to the plain
   versions at the same limit, each decoder layer's cross-attention output
   too (with the slots' cross caches rotated, a planted fault that limit
   must catch), and timed eager and from a CUDA graph.
4e. zamba2-2.7b at full width, 24 of its 54 layers (RECURRENT_LAYERS;
   d_model 2560, one shared attention + MLP block at 4 of its 9 sites, hd
   80, vocab 32000) from seeded random weights, and 4f. mamba2-780m FULL (48 layers, d_model 1536,
   vocab 50280), each after its phase 5 analysis (kernel against stream
   mode): phase 4's 8 prompts, each prefilled as a scan of single-token
   steps (replayed from a CUDA graph on a graph engine), 32 new tokens,
   max_seq 1024, 4 slots, chunk 8; the kernel-mode 4bit/8bit plan with int8
   KV from CUDA graphs, with eager decode chunks (equal to the bit; its
   prompts also replay the prompt step, itself held to the eager scan to
   the bit on the shortest prompt) and under the planted stale-buffer
   fault (must differ); an explicit raw/int8/int4/ternary plan
   (int8 embedding and shared block) with int4 KV; zamba2 also from an
   equal-memory paged pool with prefix sharing (equal to the dense serve)
   and speculatively (k = 4, int4 self-draft and ngram draft, each from
   graphs and eagerly, equal to the bit). One decode step through the
   kernels against the plain versions (LOGIT_REL_L2), the plain versions
   with their f32 sums reordered (the limit's floor, a reading), and one
   Mamba2 layer's int4 w_in nibble-swapped, which the limit must catch.
   Each run reports tokens/s, TTFT, a chunk's device and wall ms and
   launches per step, weight bytes, KV and conv/state bytes a slot and
   peak memory. The shortest prompt scanned in chunks of 32 through the
   captured step (``begin_prefill`` + ``advance_prefill``) must equal the
   whole-prompt graph scan to the bit, cache and logits.
   The kernels of ZAMBA_PATH and MAMBA_PATH must launch there.
4h. (after 4f) the MoE family at full width, its depth cut (MOE_LAYERS:
   neither config fits one 80 GB card whole): grok-1-314b at 2 of 64
   layers (d_model 6144, 48 heads over 8, 8 experts top-2 of d_ff 32768,
   vocab 131072) and arctic-480b at 1 of 35 (d_model 7168, 56 heads over
   8, 128 experts top-2 of d_ff 4864 beside a dense residual MLP, vocab
   32000), from seeded random weights, phase 4's prompts, max_seq 1024;
   each after its phase 5 analysis (every expert stack one array of the
   grouped entropy launch). Both plans are compiled first and the raw
   weights freed: EWQ 4bit/8bit with int8 KV from CUDA graphs and eagerly
   (equal to the bit), an explicit plan (int8 embedding, layers int8 /
   int4) with int4 KV, also from CUDA graphs and eagerly (equal to the
   bit: on a depth-cut config EWQ leaves every layer raw, so this is the
   serve whose captured decode runs the quantized experts); grok-1 also from an equal-memory paged pool (equal
   to its dense serve) and with spec k = 4 (int4 self-draft, one wave of
   4 prompts of 16 new tokens). One decode step through the kernels against the plain
   versions (LOGIT_REL_L2), beside the reordered-sum floor and the first
   layer's router rows rotated by one expert, which the limit must catch;
   the 4e readings per run. The kernels of MOE_PATH must launch there.
   Phase 4d also serves whisper from an equal-memory paged pool (equal to
   its dense serve to the bit) and speculatively (k = 4, int4 self-draft
   and ngram draft, one wave of 4 requests of 16 new tokens, each from
   CUDA graphs and eagerly, equal to the bit), with their acceptance.
4g. (after llama's phase 5) plan artifacts and the serve session on
   llama3.2-3b FULL, reusing phase 4's EWQ plan, prompts and outputs and
   phase 4b's int4 self-draft, no second analysis. Artifact: the plan
   compiled with int8 KV and the draft stamped, saved into a temporary
   directory outside the repository (refused when the free disk space is
   under twice the weight bytes), cold-booted once with
   ``ServeEngine.from_artifact`` and SpecConfig(k=4): the plan, KV plan
   and weight bytes of the in-memory engine, every leaf equal to the bit
   on the card, a re-derived draft equal to the stamp, and phase 4's 8
   requests served from graphs over the booted leaves (a non-spec engine
   on them) with tokens and logprobs equal to the bit to phase 4's EWQ
   serve; bytes on disk, save and cold-boot seconds beside the analysis +
   compile seconds an engine without an artifact pays.
   Chunked prefill (prefill_chunk=64, int8 KV): phase 4's requests from
   graphs and eagerly (equal to the bit), ``prefill_chunks`` equal to
   sum ceil(P / 64); on a 256-token and a 111-token prompt, the chunked
   prefill's last logits and K/V rows [0, P) of every layer within
   LOGIT_REL_L2 of the whole-prompt prefill's, and a planted fault (each
   chunk on a fresh cache, its positions restarting at 0) outside it; the
   share of tokens equal to phase 4's serve and the decode gap (max, p95)
   while a 768-token prompt arrives, with prefill_chunk=128 and without
   (readings). SLO: a paged stream of 8 with SLOConfig(preempt=True),
   priorities 0 and 1, one cancel_at_step, one deadline_steps and one
   queue_timeout_steps on the decode-step clock: the finish reasons and
   preemption / timeout / cancel counts the stream dictates, graph and
   eager serves equal to the bit, no page leaked after either. The
   artifact's directory stays until 4n has booted it.
4n. (after 4g) mesh-parallel serving (``serve_mesh``): phase 4's EWQ plan
   with int8 KV over meshes of the port's own laid on the one card (every
   position cuda:0, each with its own shards; two positions share the
   card's bandwidth, so tokens/s is not a deployment's). (a) a (data=1,
   model=2) engine from CUDA graphs: prefill and teacher-forced decode
   logits along phase 4's token stream within LOGIT_REL_L2 of the
   mesh-less engine's, its greedy agreement (a reading: the position sums
   reorder bf16 additions), weight bytes a position against the ratio the
   plan's specs predict, its launches per decode step and tokens/s; (b)
   ReplicaServe over (data=2, model=2), 4 slots a replica, against the
   full (2, 2) engine with 8 (4 a data row) on the same requests, greedy
   tokens identical (else the first difference is reported and the run
   fails); (c) 4g's artifact cold-booted onto
   (1, 2): the boot's allocation peak within 5% of the whole model's
   bytes over the shards (no whole copy lands), tokens equal to (a)'s.
   qmatmul, qkv, qmlp and decode attention must launch in every serve.
   Phase 3 checks the same four kernels at a position's shapes
   (MESH_SHAPES, ``mesh_ms``), and the kernels line carries those rows
   (``mesh_rows``).
4l. (after 4n, phase 4's params dropped) training, the first step of the
   reference's serve launcher: llama3.2-3b FULL from its own
   ``torch.Generator`` init (seed 0) trained 30 steps of 4 x 256 tokens
   (``train``: lr 1e-3, warmup 3, no remat, f32 moments; every loss
   finite, the last below the first, and each of the last five below
   the init's loss on the same batch, their mean by more than
   TRAIN_GAIN_MIN; each step's loss and ms, the median step and
   ``max_memory_allocated`` beside the reckoning in PERF.md), then 2
   steps from the same init with int8 moments (their own peak); the
   trained weights planned 4bit/8bit as the serve launcher plans them
   (``plan_for_variant``, paper mode: no entropy kernel), with the
   kernel-mode analysis beside it (one grouped entropy launch, asserted;
   its plan and its agreement reported), compiled and served
   from CUDA graphs with int8 KV (phase 4's requests; qmatmul, qkv, qmlp
   and decode attention must launch); held-out ``evaluate`` (8 x 64, 4
   steps) of the raw, EWQ, 8bit-mixed and uniform 4bit params (each plan
   the launcher's), each
   quantized one through the kernels at M = 512 (its first eval batch
   held to the plain versions within LOGIT_REL_L2), the perplexities and
   their order reported, not asserted; FastEWQ's plan (phase 4k's, from
   block sizes) against the trained EWQ plan.
4m. (after 4l) the FastEWQ dataset on the card: ``build_dataset(steps=15,
   seeds=(0, 1))`` over every arch of the registry
   (benchmarks/common.py:120's seeds; its 30 steps halved to keep the run
   under 1000 s of the contract's 1200; each model planned with the
   reference's analysis, paper mode, which launches no entropy kernel),
   its rows, seconds and quantized share, and
   ``evaluate_all_classifiers`` on those rows (the six accuracies and
   AUCs; smoke-size models).
4o. (after 4m) training over a mesh (``train_mesh``): llama3.2-3b FULL
   from its seeded init, 4 x 256 tokens of 4l's stream, over meshes laid
   on the card (every position cuda:0 with its own slices: the params
   FSDP-sharded over "data" and TP-sharded over "model" by the reference's
   training rules, the weights gathered layer by layer in the forward).
   (a) one step's loss and gathered gradients on (data=2, model=1) and on
   (2, 2) against the mesh-less step on the same batch (MESH_LOSS_RTOL,
   MESH_GRAD_REL_L2 a leaf, the worst leaves reported; each FSDP slice's
   gradient summed twice over the rows, a planted fault the gradient
   limit must catch); (b) three AdamW steps of ``train(mesh=(2, 2))``
   against three of ``train`` from the same init (f32 moments; losses
   step by step, params within MESH_PARAM_REL_L2 a leaf; the FSDP
   gather's backward dropping every row's slice but the first, a planted
   fault the limit must catch); (c) ``compressed_psum_mean`` of the two
   data rows' own gradients (params replicated, each row's backward
   alone): the mean within COMPRESS_BOUND of the plain mean, and
   decoded_local + new_error == corrected to the bit; (d) a (params, int8
   AdamWState) placement of 2 of the 28 layers (ELASTIC_LAYERS, full
   width) after one mesh step, saved on (2, 2) and restored onto (4, 1)
   and (1, 4): the logical arrays equal to the bit and every position
   holding its slices. Each part's seconds and peak device memory. No
   port kernel launches in 4o (training is autograd over the raw
   weights): asserted.
6. a JSON line naming each kernel, then the device line last. Every
   kernel's launch count must have risen on the serve and analysis paths,
   except the int8 quantize kernel, which no path runs. No single PyTorch
   call computes the fused MLP: its entries have library_ms null and the
   composition's time as library_composition_ms. The four kernels of
   phase 4n carry ``mesh_rows``: their rows at a position's shapes, each
   with its times, bound, library call and 4n (a)'s launches.

Each phase prints its seconds on a line of its own (``phase <name>:``),
also when it fails.

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


@contextlib.contextmanager
def phase(report: dict, name: str):
    """Prints the seconds the phase ``name`` took on a line of its own,
    also when it raises, and keeps them in report["phase_seconds"]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        seconds = report.setdefault("phase_seconds", {})
        seconds[name] = time.perf_counter() - t0
        log(f"phase {name}: {seconds[name]:.1f} s")


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
               page: int = PAGE, group: int = 64) -> list:
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
        pg = make_page(raw, prec, group)
        pools.append(PagedKV(
            data=pg.data, scale=pg.scale,
            table=torch.from_numpy(table).cuda(), precision=prec,
            head_dim=hd, group=group, page_size=page))
    return pools


LLAMA_ATTN = (8, 3, 128)        # KV heads, query heads per KV head, head dim
LLAMA_TP2_ATTN = (4, 3, 128)    # one position of a (data, model=2) mesh
WHISPER_ATTN = (16, 1, 64)
ZAMBA_ATTN = (32, 1, 80)        # zamba2-2.7b's shared attention
GROK_ATTN = (8, 6, 128)         # grok-1-314b: 48 heads over 8
ARCTIC_ATTN = (8, 7, 128)       # arctic-480b: 56 heads over 8


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
    edges, cross-attention (causal=False) over 1500 encoder rows.
    zamba2-2.7b's heads (hd 80, one query row a KV head, the default scale
    group of 64, so a head's groups cross heads) at the serve shape in every
    form: one query, the verify window causal and not, causal=False, the
    split edges, the fresh rows, and paged in pages of 64 and of 24; a
    group of 80 at hd 80 (a multiple of 16 that is not a power of two) and
    int4 at an odd Hkv (3 heads of 64, a head straddling the two halves).
    Small cases ("f32q") run the kernel's other instantiations (hd 32, 64,
    80, 128 with one or several query rows a KV head) on f32 q.
    grok-1's and arctic's heads (6 and 7 query heads a KV head, hd 128) at
    the serve shape: one query (and the split edges), the verify window
    (30 and 35 query rows a KV head), the first and last fresh-row step,
    paged in pages of 64; whisper's verify window over its 448-row
    decoder cache and, causal=False, over 1500 encoder rows, and its
    self-attention from a pool in pages of 64."""
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
              ("int8", "int4"), WHISPER_ATTN, " cross"),
             # llama3.2-3b's heads on one position of a (data, model=2)
             # mesh (phase 4n): 12 query heads over 4 KV heads, int8
             # groups of 64 over Hkv * hd = 512, at a row's 4 slots
             ("decode_attn", SLOTS, 1024, 1, True, serve_valid, int8,
              LLAMA_TP2_ATTN, " tp2"),
             ("decode_attn", SLOTS, 1024, 1, True, serve_valid, all3,
              ZAMBA_ATTN, ""),
             ("decode_attn", SLOTS, 1024, 1, True,
              [L1 - 1, L1, L1 + 1, 2 * L1 + 1], all3, ZAMBA_ATTN, " edges"),
             ("decode_attn_window", SLOTS, 1024, SPEC_K + 1, True,
              serve_valid, all3, ZAMBA_ATTN, ""),
             ("decode_attn_window", SLOTS, 1024, SPEC_K + 1, False,
              serve_valid, all3, ZAMBA_ATTN, ""),
             ("decode_attn_cross", SLOTS, 1024, 1, False, serve_valid, all3,
              ZAMBA_ATTN, " cross"),
             ("decode_attn", SLOTS, 1024, 1, True, serve_valid, int8,
              ZAMBA_ATTN, " g80", 80),
             ("decode_attn_window", SLOTS, 1024, SPEC_K + 1, True,
              serve_valid, ("int4",), (3, 2, 64), " odd Hkv"),
             # whisper's verify window: self-attention over its decoder
             # cache, and cross-attention (causal=False) over 1500 rows
             ("decode_attn_window", SLOTS, WHISPER_MAX_SEQ, SPEC_K + 1, True,
              [L1 - 1, L1, L1 + 1, WHISPER_MAX_SEQ - SPEC_K],
              ("int8", "int4"), WHISPER_ATTN, " self"),
             ("decode_attn_window", SLOTS, 1500, SPEC_K + 1, False,
              [1500] * SLOTS, ("int8", "int4"), WHISPER_ATTN, " cross")]
    # the MoE family's heads: 6 (grok-1) and 7 (arctic) query heads a KV
    # head, so a verify window has 30 and 35 query rows a KV head
    for geom in (GROK_ATTN, ARCTIC_ATTN):
        dense += [("decode_attn", SLOTS, 1024, 1, True, serve_valid, all3,
                   geom, ""),
                  ("decode_attn", SLOTS, 1024, 1, True, edge_valid, int8,
                   geom, " edges"),
                  ("decode_attn_window", SLOTS, 1024, SPEC_K + 1, True,
                   serve_valid, all3, geom, "")]
    # the kernel's other instantiations: head dims 32 and 64 with several
    # query rows a KV head, 128 with one, and f32 q (as a float32 model
    # passes it); hd 32 leaves one scale per stored row (F / group odd)
    for geom, qs in (((2, 2, 32), 3), ((2, 1, 32), 1), ((2, 2, 64), 2),
                     ((2, 1, 128), 1), ((4, 2, 80), 3), ((4, 1, 80), 1)):
        dense.append(("decode_attn" if qs == 1 else "decode_attn_window", 2,
                      300, qs, True, [297, 129], all3, geom, " f32q"))
    for kname, b, s, qs, causal, rows, precs, geom, tail, *grp in dense:
        group = grp[0] if grp else 64
        q, (kraw, vraw) = qkv(b, s, qs, geom)
        if tail == " f32q":
            q = q.float()
        valid = valid_of(needed(rows, qs))
        for prec in precs:
            kp, vp = (make_page(kraw, prec, group),
                      make_page(vraw, prec, group))
            yield case(kname, shape(b, s, qs, geom, tail), q, kp, vp, valid,
                       causal)
            del kp, vp
    sf = SPEC_K
    base = valid_of(serve_valid)
    fresh_rows = {}
    # (geometry, precisions, propose steps): the MoE heads take the first
    # and the last step of a propose
    fresh_geoms = ((LLAMA_ATTN, ("int8", "int4"), range(SPEC_K)),
                   (ZAMBA_ATTN, all3, range(SPEC_K)),
                   (GROK_ATTN, int8, (0, SPEC_K - 1)),
                   (ARCTIC_ATTN, int8, (0, SPEC_K - 1)))
    for geom, precs, counts in fresh_geoms:
        hkv, rep, hd = geom
        _, (kraw, vraw) = qkv(SLOTS, 1024, 1, geom)
        fk, fv = (torch.randn((SLOTS, sf, hkv, hd), generator=gen,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        fresh_rows[geom] = fk, fv
        for prec in precs:
            kp, vp = make_page(kraw, prec, 64), make_page(vraw, prec, 64)
            for count in counts:
                q, _ = qkv(SLOTS, 0, 1, geom)
                yield case("decode_attn_fresh",
                           shape(SLOTS, 1024, 1, geom,
                                 f" Sf{sf} count{count}"),
                           q, kp, vp, base + count + 1, fresh=(fk, fv, base),
                           count=count)
            del kp, vp
    # the same forms over paged pools (permuted tables, a shared page and
    # dump entries), each also held to the dense kernel on the gathered rows
    # to the bit
    lz = LLAMA_ATTN
    paged = [("decode_attn_paged", 8, 2048, 1, True, big_valid, all3, PAGE,
              lz),
             ("decode_attn_paged_window", 8, 2048, SPEC_K + 1, True,
              big_valid, int8, PAGE, lz),
             ("decode_attn_paged_window", SLOTS, 1024, SPEC_K + 1, True,
              serve_valid, all3, PAGE, lz),
             ("decode_attn_paged_window", SLOTS, 1024, SPEC_K + 1, False,
              serve_valid, int8, PAGE, lz),
             ("decode_attn_paged", SLOTS, 24 * 43, 1, True, edge_valid, all3,
              24, lz),
             ("decode_attn_paged_window", SLOTS, 24 * 43, SPEC_K + 1, True,
              edge_valid, int8, 24, lz),
             ("decode_attn_paged", SLOTS, 1024, 1, True, serve_valid, all3,
              PAGE, ZAMBA_ATTN),
             ("decode_attn_paged_window", SLOTS, 1024, SPEC_K + 1, True,
              serve_valid, all3, PAGE, ZAMBA_ATTN),
             ("decode_attn_paged", SLOTS, 24 * 43, 1, True,
              [L1 - 1, L1, L1 + 1, 2 * L1 + 1], all3, 24, ZAMBA_ATTN),
             ("decode_attn_paged_window", SLOTS, 24 * 43, SPEC_K + 1, True,
              edge_valid, int8, 24, ZAMBA_ATTN),
             # whisper's self-attention from a pool (its cross K/V stay
             # dense per slot)
             ("decode_attn_paged", SLOTS, WHISPER_MAX_SEQ, 1, True,
              [L1 - 1, L1, L1 + 1, WHISPER_MAX_SEQ], ("int8", "int4"), PAGE,
              WHISPER_ATTN)]
    for geom in (GROK_ATTN, ARCTIC_ATTN):
        paged += [("decode_attn_paged", SLOTS, 1024, 1, True, serve_valid,
                   all3, PAGE, geom),
                  ("decode_attn_paged_window", SLOTS, 1024, SPEC_K + 1, True,
                   serve_valid, int8, PAGE, geom)]
    for ci, (kname, b, s, qs, causal, rows, precs, page,
             geom) in enumerate(paged):
        q, _ = qkv(b, 0, qs, geom)
        rows = needed(rows, qs)
        valid = valid_of(rows)
        tail = f" P{page}" + (" edges" if page != PAGE else "")
        for prec in precs:
            kp, vp = paged_pair(torch, gen, b, s, rows, prec, seed=ci,
                                hkv=geom[0], hd=geom[2], page=page)
            yield case(kname, shape(b, s, qs, geom, tail), q, kp, vp,
                       valid, causal)
            del kp, vp
    for geom, precs, counts in fresh_geoms:
        fk, fv = fresh_rows[geom]
        for prec in precs:
            kp, vp = paged_pair(torch, gen, SLOTS, 1024,
                                [v + sf for v in serve_valid], prec, seed=9,
                                hkv=geom[0], hd=geom[2])
            for count in counts:
                q, _ = qkv(SLOTS, 0, 1, geom)
                yield case("decode_attn_paged_fresh",
                           shape(SLOTS, 1024, 1, geom,
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
    row["plain_ms"] = plain_ms(timer, row, lambda: DA.decode_attention_plain(
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
    gen = torch.Generator(device="cuda").manual_seed(0)
    d, ff, vocab = 3072, 8192, 128256
    # llama3.2-3b's matrices, and whisper-medium's 1024 x 1024 (its wo and
    # cross-attention wq at decode)
    shapes = {"wq": (3072, d), "wk/wv": (1024, d), "gate/up": (ff, d),
              "down": (d, ff), "lm_head": (vocab, d),
              "whisper wo": (1024, 1024)}
    ms_list = matmul_ms()
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

    def add(row):
        rows.append(row)
        log(json.dumps(row))

    # every precision, M and shape of llama's and whisper's matrices
    mm = (torch, timer, weight, act, compare, add)
    check_qmatmul(*mm, shapes, ms_list)
    check_qkv(*mm, {"wq|wk|wv 5120x3072": ((3072, 1024, 1024), d),
                    "whisper wq|wk|wv 3072x1024": ((1024, 1024, 1024),
                                                   1024)}, ms_list)
    qmatmul_refusals()
    for form, label, mlp_ff, mlp_d, ms in qmlp_cases():
        check_qmlp(*mm, {label: (mlp_ff, mlp_d)}, ms, form=form)
    # zamba2's and mamba2's, at the M their paths give the kernels: M = 4
    # for a decode step of 4 slots (a verify window and a two-pass draft
    # step too, each a scan of single-token steps), M = 1 for a prompt
    # token (a prompt is a scan of single-token steps)
    check_qmatmul(*mm, RECURRENT_SHAPES["qmatmul"], (1, SLOTS))
    check_qkv(*mm, RECURRENT_SHAPES["qkv"], (1, SLOTS))
    # grok-1's and arctic's, each at every M their serves give (moe_ms):
    # the routers (N = 8 and 128, under one 16-row tile at grok), the
    # attention output projections and the projections
    check_qmatmul(*mm, MOE_SHAPES["router"], moe_ms())
    check_qmatmul(*mm, MOE_SHAPES["qmatmul"], moe_ms())
    check_qkv(*mm, MOE_SHAPES["qkv"], moe_ms())
    # llama3.2-3b's shapes on one position of a (data, model=2) mesh
    # (phase 4n) at every M its path gives them (mesh_ms), in the plan's
    # precisions
    check_qmatmul(*mm, MESH_SHAPES["qmatmul"], mesh_ms(), MESH_PRECISIONS)
    check_qkv(*mm, MESH_SHAPES["qkv"], mesh_ms(), MESH_PRECISIONS)
    check_qmlp(*mm, MESH_SHAPES["qmlp"], mesh_ms(),
               precisions=MESH_PRECISIONS)

    # decode attention in every form (attention_cases)
    for case in attention_cases(torch):
        add(attn_case(torch, timer, compare, case))
        del case
    attn_refusals()
    check_entropy_quantize(torch, timer, gen, rows, worst, add)
    return worst


def matmul_ms() -> tuple:
    """The M values the main path gives the matmul kernels, each kernel
    instantiation among them: decode runs every slot (M = 4, the MT = 4
    kernel; 1-3 are the MT = 1, 2 kernels and a masked MT = 4 tile), a
    prefill's head runs M = 1, and prefill runs M = the prompt length in
    8-row tiles: 8, 256, and a serve prompt whose last tile is partial; a
    speculative verify runs every slot's K+1 window (M = 20)."""
    lens = [len(p) for p in serve_prompts(128256)]
    ragged = next(n for n in lens if n % 8)
    return (1, 2, 3, SLOTS, 8, SLOTS * (SPEC_K + 1), 256, ragged)


def moe_ms() -> tuple:
    """The M values the MoE serves (phase 4h) give the routers, the
    projections and the dense residual MLP: a decode step or a draft step
    (SLOTS), a verify window (SLOTS * (K + 1)) and a prompt (the serve
    prompt whose last 8-row tile is partial). Their heads stay raw (an
    embedding plan quantizes the embedding alone), so no MoE row is at a
    prompt's head (M = 1)."""
    return (SLOTS, SLOTS * (SPEC_K + 1), matmul_ms()[-1])


def mesh_ms() -> tuple:
    """The M values phase 4n's mesh serves give the kernels at a position's
    shapes: the head at a prompt's last token (1), a decode step of a
    replica, a (2, 2) mesh row or the (1, 2) engine (SLOTS), and prompts
    (8-row tiles: 8, 256, and the serve prompt whose last tile is
    partial)."""
    return (1, SLOTS, 8, 256, matmul_ms()[-1])


def qmlp_cases() -> list:
    """(form, label, d_ff, d_model, M values) of every fused-MLP case:
    llama3.2-3b's swiglu at every M of ``matmul_ms``; zamba2's shared
    swiglu MLP at 1 (a prompt token: prompts are scans of single-token
    steps) and SLOTS (a decode step; verify windows and draft steps are
    scans too); whisper-medium's gelu at 1 (the batch-1 prefill steps),
    SLOTS and 1500 (the encoder, one request's frames); arctic-480b's
    dense residual MLP at ``moe_ms`` (FF 4864: its last 512-row part holds
    256 rows)."""
    return [("swiglu", "swiglu 3072->8192->3072", 8192, 3072, matmul_ms()),
            ("swiglu", "zamba2 swiglu 2560->10240->2560", 10240, 2560,
             (1, SLOTS)),
            ("gelu", "gelu 1024->4096->1024", 4096, 1024, (1, SLOTS, 1500)),
            ("swiglu", "arctic swiglu 7168->4864->7168", 4864, 7168,
             moe_ms())]


# zamba2-2.7b's and mamba2-780m's matrices (N, K) by kernel: the Mamba2
# products and the heads through qmatmul, zamba2's shared block through
# qkv (its swiglu MLP is in qmlp_cases)
RECURRENT_SHAPES = {
    "qmatmul": {"zamba2 w_in": (10368, 2560), "zamba2 w_out": (2560, 5120),
                "zamba2 wo": (2560, 2560), "zamba2 lm_head": (32000, 2560),
                "mamba2 w_in": (6448, 1536), "mamba2 w_out": (1536, 3072),
                "mamba2 lm_head": (50432, 1536)},
    "qkv": {"zamba2 wq|wk|wv 7680x2560": ((2560, 2560, 2560), 2560)},
}


# grok-1-314b's and arctic-480b's matrices (N, K) by kernel: the routers
# (f32 out) and the attention output projections through qmatmul, the
# projections through qkv (arctic's dense residual MLP is in qmlp_cases;
# the experts are dequantized and multiplied, as in the reference, through
# no kernel; the heads stay raw)
MOE_SHAPES = {
    "router": {"grok router": (8, 6144), "arctic router": (128, 7168)},
    "qmatmul": {"grok wo": (6144, 6144), "arctic wo": (7168, 7168)},
    "qkv": {"grok wq|wk|wv 8192x6144": ((6144, 1024, 1024), 6144),
            "arctic wq|wk|wv 9216x7168": ((7168, 1024, 1024), 7168)},
}


# llama3.2-3b's matrices on one position of a (data, model=2) mesh (phase
# 4n), by kernel: the row-parallel wo's columns (K = 1536, 12 groups of
# 128; an int4 shard splits the packed K/2 at a group boundary) and the
# tied head's vocab rows through qmatmul, each position's query and KV
# heads through qkv, its half of d_ff through qmlp
MESH_SHAPES = {
    "qmatmul": {"tp2 wo": (3072, 1536), "tp2 lm_head": (64128, 3072)},
    "qkv": {"tp2 wq|wk|wv 2560x3072": ((1536, 512, 512), 3072)},
    "qmlp": {"tp2 swiglu 3072->4096->3072": (4096, 3072)},
}
MATMUL_PRECISIONS = ("int8", "int4", "ternary")
MESH_PRECISIONS = ("int8", "int4")     # the EWQ 4bit/8bit plan's


def headline(row: dict) -> bool:
    """Is ``row`` the row its kernel reports on the kernels line
    (HEADLINE)?"""
    return HEADLINE.get(row["kernel"]) == (row["shape"], row["precision"],
                                           row["m"])


def plain_ms(timer, row: dict, plain):
    """The plain version's time, taken only at the kernels line's rows and
    at the forms the MoE and whisper paged / spec paths brought (PLAIN_ROWS):
    the other shapes' plain times are in PERF.md from earlier runs, and no
    check reads them."""
    key = (row["shape"], row["precision"], row["m"])
    return timer.ms(plain) if headline(row) or key in PLAIN_ROWS else None


def _timed(row, timer, fn, plain, library, nbytes, flops):
    """A matmul row's timings and bound (skipped by --quick)."""
    if not QUICK:
        row["ms"] = timer.ms(fn)
        row["plain_ms"] = plain_ms(timer, row, plain)
        row["library_ms"] = None if library is None else timer.ms(library)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
    return row


def check_qmatmul(torch, timer, weight, act, compare, add, shapes: dict,
                  ms_list, precisions=MATMUL_PRECISIONS) -> None:
    """qmatmul at every precision and M of ``shapes`` (label -> (N, K)):
    against the plain version, within QMATMUL_F32 of the f32 dequantized
    product and equal to the bit over two calls, timed beside the library
    product and the bound. --quick skips the lm_head shapes."""
    from repro_torch.kernels.qmatmul import ops as QM
    from repro_torch.quant.quantize import dequantize, quantize
    for wname, (n, k) in shapes.items():
        if QUICK and "lm_head" in wname:
            continue
        base = weight(n, k)
        for prec in precisions:
            w = quantize(base, prec)
            wd = dequantize(w, torch.bfloat16)
            for m in ms_list:
                x = act(m, k)
                got, want = QM.qmatmul_cuda(x, w), QM.qmatmul_plain(x, w)
                compare("qmatmul", [got], [want])
                exact = x.float() @ dequantize(w, torch.float32).t()
                row = dict(kernel="qmatmul", shape=f"{wname} {n}x{k}",
                           precision=prec, m=m,
                           err=float((got - want).abs().max()),
                           **matmul_exactness(torch, "qmatmul", [got], [exact],
                                              lambda: [QM.qmatmul_cuda(x, w)]),
                           plan=qmatmul_plan(n, m, k, prec))
                del exact
                add(_timed(row, timer, lambda: QM.qmatmul_cuda(x, w),
                           lambda: QM.qmatmul_plain(x, w), lambda: x @ wd.t(),
                           m * k * 2 + qbytes(w) + m * n * 4,
                           2.0 * m * n * k))
            del w, wd
        del base


def check_qkv(torch, timer, weight, act, compare, add, cases: dict,
              ms_list, precisions=MATMUL_PRECISIONS) -> None:
    """The fused projections, ``cases`` label -> ((Nq, Nk, Nv), D), with
    qmatmul's checks."""
    from repro_torch.kernels.qmatmul import ops as QM
    from repro_torch.quant.quantize import dequantize, quantize
    for label, (ns, dm) in cases.items():
        for prec in precisions:
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
                add(_timed(row, timer, lambda: QM.qkv_cuda(x, *ws),
                           lambda: QM.fused_qkv_plain(x, *ws),
                           lambda: x @ wqkv.t(),
                           m * dm * 2 + sum(map(qbytes, ws))
                           + m * sum(ns) * 4, 2.0 * m * sum(ns) * dm))
            del ws, wqkv


def check_qmlp(torch, timer, weight, act, compare, add, cases: dict,
               ms_list, form: str = "swiglu",
               precisions=MATMUL_PRECISIONS) -> None:
    """The fused MLP in one form (``form`` swiglu or gelu), ``cases`` label
    -> (d_ff, d_model), at every precision and M of ``ms_list``: against
    its plain version, within QMLP_F32 of ``fused_mlp_f32`` and equal to
    the bit over two calls (at M = SLOTS and the verify window's M with f32
    x too), with its launch plan and partial-buffer bytes;
    timed beside the bound and, as ``library_composition_ms`` (no single
    library call computes it: ``library_ms`` is None), the composition of
    cuBLAS products and elementwise steps on the weights dequantized to
    bf16 (swiglu: x Wg^T, x Wu^T, silu(.) *, . Wd^T; gelu: gelu(x Wu^T),
    . Wd^T)."""
    import torch.nn.functional as F
    from repro_torch.kernels.qmatmul import ops as QM
    from repro_torch.quant.quantize import dequantize, quantize
    gelu = form == "gelu"
    kernel = "qmlp_gelu" if gelu else "qmlp"
    for label, (ff, d) in cases.items():
        for prec in precisions:
            wg = None if gelu else quantize(weight(ff, d), prec)
            wu, wdn = quantize(weight(ff, d), prec), quantize(weight(d, ff),
                                                              prec)
            ws = [w for w in (wg, wu, wdn) if w is not None]
            bf = [dequantize(w, torch.bfloat16) for w in ws]

            def library():
                if gelu:
                    h = F.gelu(x @ bf[0].t(), approximate="tanh")
                    return h @ bf[1].t()
                return (F.silu(x @ bf[0].t()) * (x @ bf[1].t())) @ bf[2].t()

            for m in ms_list:
                x = act(m, d)
                got = QM.qmlp_cuda(x, wg, wu, wdn)
                want = QM.fused_mlp_plain(x, wg, wu, wdn, act=form).float()
                compare(kernel, [got], [want])
                exact = QM.fused_mlp_f32(x, wg, wu, wdn, act=form)
                row = dict(kernel=kernel, shape=label, precision=prec, m=m,
                           err=float((got - want).abs().max()),
                           **matmul_exactness(
                               torch, kernel, [got], [exact],
                               lambda: [QM.qmlp_cuda(x, wg, wu, wdn)],
                               QMLP_F32),
                           plan=qmlp_plan(m, d, ff, d, prec, gelu))
                del exact
                if m in (SLOTS, SLOTS * (SPEC_K + 1)):
                    # f32 x (8-row chunks) at a decode and a verify M, where
                    # its rows fit the shared memory (f32 x is off the
                    # serve path; past that the kernel refuses it)
                    x32 = x.float()
                    if qmlp_takes_f32(m, d, ff, prec, gelu):
                        exact = QM.fused_mlp_f32(x32, wg, wu, wdn, act=form)
                        row["f32_x"] = matmul_exactness(
                            torch, f"{kernel} f32 x",
                            [QM.qmlp_cuda(x32, wg, wu, wdn)], [exact],
                            lambda: [QM.qmlp_cuda(x32, wg, wu, wdn)],
                            QMLP_F32)
                        del exact
                    else:
                        try:
                            QM.qmlp_cuda(x32, wg, wu, wdn)
                        except RuntimeError:
                            row["f32_x"] = "refused: x rows past the shared " \
                                           "memory"
                        else:
                            raise AssertionError(
                                f"{kernel} {label}: f32 x at M = {m} "
                                "launched past its shared memory")
                if not QUICK:
                    row["library_composition_ms"] = timer.ms(library)
                add(_timed(row, timer, lambda: QM.qmlp_cuda(x, wg, wu, wdn),
                           lambda: QM.fused_mlp_plain(x, wg, wu, wdn,
                                                      act=form),
                           None, m * d * 2 + sum(map(qbytes, ws))
                           + m * d * 4, 2.0 * m * len(ws) * ff * d))
            del wg, wu, wdn, ws, bf


def attn_refusals() -> None:
    """The decode attention entry point refuses, launching nothing, what it
    has no copy for: a head dim outside 32, 64, 80 and 128 (72), a scale
    group that is not a multiple of 16 (24) or does not divide Hkv * hd
    (48 at 16 heads of 80), int4 at hd 80 with an odd Hkv (a 16-element
    chunk would straddle the two halves), and a split other than its own
    (every pointer is null, so a launch would fault). hd 80, a group of
    80 and int4 at an odd Hkv with hd 64 launch in attention_cases."""
    from repro_torch.kernels import build
    lib = build.library("decode_attn")
    # (hkv, hd, group, prec, rep, split)
    for hkv, hd, group, prec, rep, split in ((16, 72, 64, 0, 1, 256),
                                             (16, 128, 24, 0, 3, 128),
                                             (16, 80, 48, 0, 1, 256),
                                             (3, 80, 16, 1, 1, 256),
                                             (16, 128, 64, 0, 3, 256),
                                             (16, 64, 64, 1, 1, 128)):
        err = lib.repro_decode_attn(*[None] * 15, 0, 0, 0, 0, 4, 448, 1, 0,
                                    hkv, rep, 1, hd, group, prec, 1, 0,
                                    split, None)
        if err == 0:
            raise AssertionError(f"decode_attn took Hkv {hkv}, hd {hd}, "
                                 f"group {group}, prec {prec}, split {split}")
    log("decode_attn refuses hd 72, groups 24 and 48 (at 16 x 80), hd 80 "
        "int4 at an odd Hkv and foreign splits")


# Limit on the largest absolute difference of a qmatmul / qkv output from
# the product in f32 with the weights dequantized to f32 (q * s is exact in
# f32, so only the order of the f32 sums differs; earlier designs read
# <= 7.6e-6).
QMATMUL_F32 = 1e-5


# Limit on the largest absolute difference of a fused MLP output (both
# forms) from ``fused_mlp_f32``: x and the weights dequantized in f32 and
# the hidden h kept in f32, as the TPU kernel computes it. The kernel
# rounds nothing but h, which it multiplies as two bf16 parts (within
# 2^-16 of h relative), so the rest is the order of the f32 sums. PERF.md
# gives the readings that place it (every row of a run, and the faults
# that scripts/qmlp_gate_mutants.py plants).
QMLP_F32 = 2e-5


def matmul_exactness(torch, kernel: str, got: list, exact: list, again,
                     limit: float = QMATMUL_F32) -> dict:
    """The qmatmul / qkv / qmlp checks beyond the plain version: within
    ``limit`` of the product in f32 (QMATMUL_F32 for the matmuls, QMLP_F32
    for the fused MLP), and a second call equal to the first to the bit (no
    atomics, a fixed summation order)."""
    err = max(float((g - e).abs().max()) for g, e in zip(got, exact))
    second = again()
    torch.cuda.synchronize()
    if not err <= limit:
        raise AssertionError(f"{kernel}: {err} from the product in f32 "
                             f"(limit {limit})")
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
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(grid=[gx, gy], threads=threads, smem=smem, rows=rows,
                blocks_per_sm_max=per_sm,
                blocks_in_flight_per_sm=min(per_sm, (gx * gy) / sms))


def qmlp_plan(m: int, k: int, ff: int, d: int, prec: str,
              gelu: bool) -> dict:
    """The launch csrc/qmlp.cu picks for an MLP of width k -> ff -> d at m
    rows of bf16 x: grid, cluster, threads, shared memory, blocks and
    clusters the device holds at once, its SMs, x rows a chunk, and the
    partial buffer the wrapper allocates (parts, m, d) f32."""
    import ctypes
    from repro_torch.kernels import build
    out = (ctypes.c_int * 10)()
    build.check(build.library("qmlp").repro_qmlp_plan(
        m, k, ff, 1, int(prec == "int4"), int(gelu), out), "qmlp plan")
    gx, gy, cluster, threads, smem, per_sm, clusters, sms, rows, parts = \
        list(out)
    return dict(grid=[gx, gy], cluster=cluster, threads=threads, smem=smem,
                blocks_per_sm_max=per_sm, clusters_max=clusters, sms=sms,
                rows_a_chunk=rows, parts=parts,
                partial_bytes=parts * m * d * 4)


def qmlp_takes_f32(m: int, k: int, ff: int, prec: str, gelu: bool) -> bool:
    """Does csrc/qmlp.cu take f32 x at this shape (its 8-row chunk of x
    within the shared memory the device offers)?"""
    import ctypes
    from repro_torch.kernels import build
    out = (ctypes.c_int * 10)()
    return build.library("qmlp").repro_qmlp_plan(
        m, k, ff, 0, int(prec == "int4"), int(gelu), out) == 0


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


# the grouped case: llama3.2-3b's block 0 (the 128256 x 3072 embedding)
# and one layer's seven matrices in bf16 at the weight scale, and the
# ragged f32 vector, in one entropy_many launch
ENTROPY_GROUP = (("embed 128256x3072", (128256, 3072)),
                 ("wq 3072x3072", (3072, 3072)),
                 ("wk 1024x3072", (1024, 3072)),
                 ("wv 1024x3072", (1024, 3072)),
                 ("wo 3072x3072", (3072, 3072)),
                 ("gate 8192x3072", (8192, 3072)),
                 ("up 8192x3072", (8192, 3072)),
                 ("down 3072x8192", (3072, 8192)))


def entropy_group_inputs(torch, gen, device: str = "cuda") -> list:
    """(label, w) of the grouped case: ENTROPY_GROUP in bf16, then a
    1000003-element f32 vector whose ragged tail is ENTROPY_TAIL."""
    out = [(label, (torch.randn(dims, generator=gen, device=device)
                    * dims[-1] ** -0.5).to(torch.bfloat16))
           for label, dims in ENTROPY_GROUP]
    v = torch.randn((1000003,), generator=gen, device=device) * 1000003 ** -0.5
    v[-(v.numel() % 4):] = ENTROPY_TAIL
    return out + [("1000003 f32 tail", v)]


def entropy_group_check(torch, EN, group: list) -> list:
    """The grouped launch over ``group`` against its plain version (each H
    through ``entropy_fault``), against each array's single-array launch
    and against a second grouped launch (both to the bit). Returns one dict
    per array: label, H (grouped, plain), error, fault or None, and whether
    it equals its single launch and the second grouped launch."""
    ws = [w for _, w in group]
    got = EN.entropy_many(ws).tolist()
    again = EN.entropy_many(ws).tolist()
    want = EN.entropy_many_plain(ws).tolist()
    alone = [float(EN.entropy_cuda(w)) for w in ws]
    return [dict(case=label, h=g, h_plain=p, err=abs(g - p),
                 fault=entropy_fault(g, p), equal_single=g == a,
                 equal_twice=g == b)
            for (label, _), g, p, a, b in zip(group, got, want, alone, again)]


def check_entropy_quantize(torch, timer, gen, rows, worst, add) -> None:
    """The entropy kernel (ENTROPY_CASES: llama3.2-3b's 3072x8192 MLP
    weight and whisper-medium's padded 51968x1024 embedding in bf16, as the
    analysis reads them, and an odd-sized f32 vector whose ragged tail
    carries weight; at the weight scale and at the reference test's), each
    a launch of one array, within ENTROPY_TOL * max(1, |H|) and ENTROPY_ABS
    of its plain version, with the gap log(n) - H of both reported; the
    grouped case (ENTROPY_GROUP and the ragged vector in one launch), each
    H within the same limits and equal to the bit to its single launch and
    over two launches; the int8 quantize kernel on a 3072x8192 bf16 and a
    1024x4096 f32 weight at group 128, a bf16 weight at group 64, and two
    that take its warp-per-group path (group 24; a view one element off
    16-byte alignment), payload and f32 scales equal to the plain
    version's to the bit. The yardsticks: ``Categorical(logits=w)
    .entropy()`` for the entropy (one PyTorch call, the same function;
    none for a list); none for quantize."""
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
            row["plain_ms"] = plain_ms(
                timer, row, lambda: EN.matrix_entropy(w, plain=True))
            row["library_ms"] = timer.ms(lambda: cat(
                logits=flat.float(), validate_args=False).entropy())
            # one read of the same bytes by PyTorch's own reduction: what
            # a stream of them reads under this timing (a reading, not
            # the function)
            row["stream_ms"] = timer.ms(
                lambda: torch.sum(w, dtype=torch.float32))
            row["bound_ms"], row["bound_by"] = bound_ms(
                n * w.element_size() + 4, 6.0 * n, F32_FLOPS)
        add(row)
        del w
    group = entropy_group_inputs(torch, gen)
    checks = entropy_group_check(torch, EN, group)
    for c in checks:
        worst["entropy"] = max(worst["entropy"], c["err"])
        if c["fault"] or not (c["equal_single"] and c["equal_twice"]):
            raise AssertionError(f"entropy grouped case: {c}")
    ws = [w for _, w in group]
    n = sum(w.numel() for w in ws)
    row = dict(kernel="entropy", shape=f"grouped {len(ws)} arrays",
               precision="bfloat16+float32", m=None, arrays=checks,
               err=max(c["err"] for c in checks))
    if not QUICK:
        row["ms"] = timer.ms(lambda: EN.entropy_many(ws))
        row["plain_ms"] = plain_ms(timer, row,
                                   lambda: EN.entropy_many_plain(ws))
        row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = bound_ms(
            sum(w.numel() * w.element_size() for w in ws) + 4 * len(ws),
            6.0 * n, F32_FLOPS)
    add(row)
    del group, ws, checks
    base = torch.randn((3072 * 8192 + 8,), generator=gen, device="cuda")
    for shape, (n, k), dtype, group, offset in (
            ("3072x8192 bf16 group128", (3072, 8192), torch.bfloat16, 128,
             0),
            ("1024x4096 f32 group128", (1024, 4096), torch.float32, 128, 0),
            ("3072x8192 bf16 group64", (3072, 8192), torch.bfloat16, 64, 0),
            ("1024x3072 bf16 group24", (1024, 3072), torch.bfloat16, 24, 0),
            ("3072x8192 bf16 group128 offset1", (3072, 8192),
             torch.bfloat16, 128, 1)):
        flat = (base * 0.02).to(dtype)
        w = flat[offset:offset + n * k].view(n, k)  # offset 1: 2 bytes off
        w[0, :group] = 0                            # a zero group
        q, sc = QZ.quantize_int8_cuda(w, group)
        qp, sp = QZ.quantize_int8(w, group, plain=True)
        torch.cuda.synchronize()
        if not (torch.equal(q, qp) and torch.equal(sc, sp)):
            raise AssertionError(
                f"quantize_int8 {shape}: {int((q != qp).sum())} payload "
                f"and {int((sc != sp).sum())} scale elements differ from "
                "the plain version")
        row = dict(kernel="quantize_int8", shape=shape,
                   precision=str(dtype).replace("torch.", ""), m=None,
                   err=0.0, bit_exact=True,
                   aligned=w.data_ptr() % 16 == 0)
        if not QUICK:
            row["ms"] = timer.ms(lambda: QZ.quantize_int8_cuda(w, group))
            row["plain_ms"] = plain_ms(
                timer, row, lambda: QZ.quantize_int8(w, group, plain=True))
            row["library_ms"] = None
            row["bound_ms"], row["bound_by"] = bound_ms(
                n * k * w.element_size() + n * k + n * (k // group) * 4,
                5.0 * n * k, F32_FLOPS)
        add(row)
        del flat, w, q, sc, qp, sp
    del base


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
# a whisper serve from a paged pool: the self-attention reads the pool, the
# cross-attention the dense per-slot cross K/V
WHISPER_PAGED_PATH = ("qmatmul", "qkv", "qmlp_gelu", "decode_attn_paged",
                      "decode_attn_cross")
# a whisper serve with the ngram draft: no draft model runs, every step is
# a verify window (self-attention and the causal=False cross-attention)
WHISPER_NGRAM_PATH = ("qmatmul", "qkv", "qmlp_gelu", "decode_attn_window")
# the kernels zamba2-2.7b's serves (phase 4e) and its analysis run, each
# of which must launch there: the Mamba2 products, the shared block's
# projections and MLP, and decode attention at hd 80, dense and paged
ZAMBA_PATH = ("qmatmul", "qkv", "qmlp", "decode_attn", "decode_attn_paged",
              "entropy")
# the kernels mamba2-780m's serves (phase 4f) and its analysis run
MAMBA_PATH = ("qmatmul", "entropy")
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
# the rows of phase 3 whose plain version is also timed, beside HEADLINE's:
# one int8 row at a decode step (4 slots) of each form the MoE serves and
# whisper's paged and speculative serves run
PLAIN_ROWS = {
    ("grok router 8x6144", "int8", SLOTS),
    ("arctic router 128x7168", "int8", SLOTS),
    ("grok wq|wk|wv 8192x6144", "int8", SLOTS),
    ("arctic wq|wk|wv 9216x7168", "int8", SLOTS),
    ("arctic swiglu 7168->4864->7168", "int8", SLOTS),
    ("B4 S1024 Hkv8 rep6 hd128", "int8", SLOTS),
    ("B4 S1024 Hkv8 rep7 hd128", "int8", SLOTS),
    ("B4 S1024 Hkv8 rep6 hd128 qs5", "int8", SLOTS),
    ("B4 S1024 Hkv8 rep7 hd128 qs5", "int8", SLOTS),
    ("B4 S1024 Hkv8 rep6 hd128 Sf4 count3", "int8", SLOTS),
    ("B4 S1024 Hkv8 rep7 hd128 Sf4 count3", "int8", SLOTS),
    ("B4 S1024 Hkv8 rep6 hd128 P64", "int8", SLOTS),
    ("B4 S1024 Hkv8 rep7 hd128 P64", "int8", SLOTS),
    ("B4 S448 Hkv16 rep1 hd64 P64", "int8", SLOTS),
    ("B4 S448 Hkv16 rep1 hd64 self qs5", "int8", SLOTS),
    ("B4 S1500 Hkv16 rep1 hd64 cross qs5", "int8", SLOTS),
    # phase 4n's shapes on one position of a (data, model=2) mesh
    ("tp2 wo 3072x1536", "int8", SLOTS),
    ("tp2 lm_head 64128x3072", "int8", SLOTS),
    ("tp2 lm_head 64128x3072", "int4", SLOTS),
    ("tp2 wq|wk|wv 2560x3072", "int8", SLOTS),
    ("tp2 swiglu 3072->4096->3072", "int8", SLOTS),
    ("B4 S1024 Hkv4 rep3 hd128 tp2", "int8", SLOTS),
}
# the rows of phase 4n's shapes beside each kernel's headline on the
# kernels line (``mesh_rows``), at the (1, 2) engine's decode step (the
# head int4 too: the EWQ plan puts llama3.2-3b's embedding at int4)
MESH_ROWS = {"qmatmul": [("tp2 wo 3072x1536", "int8", SLOTS),
                         ("tp2 lm_head 64128x3072", "int8", SLOTS),
                         ("tp2 lm_head 64128x3072", "int4", SLOTS)],
             "qkv": [("tp2 wq|wk|wv 2560x3072", "int8", SLOTS)],
             "qmlp": [("tp2 swiglu 3072->4096->3072", "int8", SLOTS)],
             "decode_attn": [("B4 S1024 Hkv4 rep3 hd128 tp2", "int8",
                              SLOTS)]}
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
    make (quantized weights dequantized to f32, not bf16; the MLP's hidden
    kept in f32, not rounded to x's dtype: ``ops.fused_mlp_f32``).
    ``"reordered"``: the same arithmetic as the plain versions,
    but each quantized product summed over K in two halves, so only the
    order of the f32 additions changes."""
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
        if not (plain and QM._mega_eligible(
                [w for w in (wg, wu, wd) if w is not None])):
            return saved[1](x, wg, wu, wd, act=act, plain=plain)
        return QM.fused_mlp_f32(x, wg, wu, wd, act).to(x.dtype)

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


def swap_nibbles_one_layer(torch, params, key: str = "layers",
                           leaf=None) -> dict:
    """A planted fault: ``params`` with the first int4 layer of the stack
    ``key`` nibble-swapped in its payload bytes, in every weight of the
    layer or (``leaf``) in that one weight alone (the other layers are
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

    sp = segs[i].params
    sp = ({**sp, leaf: swap(sp[leaf])} if leaf is not None
          else tree_map(swap, sp))
    segs[i] = dataclasses.replace(segs[i], params=sp)
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
    import shutil
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build as build_model
    from repro_torch.quant.kvcache import clone_cache
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.quantized import explicit_plan, plan_for_variant
    from repro_torch.serving.scheduler import Request

    with phase(report, "4 llama serve"):   # with the model's init and plans
        cfg = get_config("llama3.2-3b", smoke=smoke)   # FULL: 28L, 3072 wide
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
        ewq_s = time.perf_counter() - t0
        log(f"serve: EWQ analysis on the card ({ewq_s:.1f} s): "
            f"4bit/8bit plan counts {ewq.counts()} "
            f"precisions {ewq.precisions()}")
        tiers = ["raw", "int8", "int4", "ternary"]
        n = cfg.num_layers
        layers = [tiers[i * len(tiers) // n] for i in range(n)]
        explicit = explicit_plan(cfg, layers, embed_precision="int8")
        log(f"serve: explicit plan counts {explicit.counts()} "
            "(int8 embedding)")

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
                torch, device, lambda: engine.serve(
                    requests(), num_slots=SLOTS, chunk=CHUNK))
            counts = dict(build.LAUNCHES)
            for k, v in counts.items():
                launches[k] += v
            check_outputs(label, outs, cfg.vocab_size)
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
                    run["planted_fault"] = stale_buffer_caught(fault_outs,
                                                               outs)
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

        k_logits = step_logits(eng.params)
        p_logits = step_logits(eng.params, True)
        if not bool(torch.isfinite(k_logits).all()):
            raise AssertionError("non-finite logits through the kernels")
        rel = rel_l2(k_logits, p_logits)
        agree = float((k_logits.argmax(-1) == p_logits.argmax(-1)).float()
                      .mean())
        err = float((k_logits - p_logits).abs().max())
        with patched_plain(torch, "unrounded"):
            rel_unrounded = rel_l2(k_logits, step_logits(eng.params, True))
        with patched_plain(torch, "reordered"):
            rel_reordered = rel_l2(step_logits(eng.params, True), p_logits)
        rel_fault = rel_l2(
            step_logits(swap_nibbles_one_layer(torch, eng.params)), p_logits)
        log(f"serve: first decode step, kernels vs plain versions: relative "
            f"L2 {rel:.4g} (limit {LOGIT_REL_L2}), max abs diff {err:.4g} of "
            f"max |logit| {float(p_logits.abs().max()):.4g}, greedy agreement "
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

        report.update(runs=runs, launches=launches, ewq_analysis_s=ewq_s,
                      logit_rel_l2=rel,
                      logit_rel_l2_unrounded=rel_unrounded,
                      logit_rel_l2_reordered=rel_reordered,
                      logit_rel_l2_planted_fault=rel_fault,
                      logit_max_abs_diff=err, greedy_agreement=agree,
                      ewq_counts=ewq.counts())
        if device == "cuda":
            decode_step_times(torch, model, eng, state, toks, report)
        eng = engine = state = None
    with phase(report, "4k llama FastEWQ"):
        fast_launches = serve_fastewq(torch, build, report, model, params,
                                      ewq, prompts, smoke, device)
    for k, v in fast_launches.items():
        launches[k] += v
    with phase(report, "4b llama spec"):
        spec_launches, spec_outs, draft_stamp = serve_speculative(
            torch, build, report, model, params, ewq, prompts, base_outs,
            device)
    for k, v in spec_launches.items():
        launches[k] += v
    with phase(report, "4c llama paged"):
        paged_launches, compiled = serve_paged(
            torch, build, report, model, params, ewq, prompts, base_outs,
            spec_outs, device)
    for k, v in paged_launches.items():
        launches[k] += v
    with phase(report, "4j llama traced + profiled serve"):
        obs_launches = serve_observed(torch, build, report, model, compiled,
                                      ewq, prompts, base_outs, device)
    for k, v in obs_launches.items():
        launches[k] += v
    with phase(report, "4i llama degrade + failover"):
        degrade_launches = serve_degrade(torch, build, report, model,
                                         compiled, ewq, prompts, base_outs,
                                         device)
    compiled = None
    for k, v in degrade_launches.items():
        launches[k] += v
    with phase(report, "5 llama analysis"):
        _, entropy_launches = analyze_model(torch, build, report, model,
                                            params, device)
    launches["entropy"] += entropy_launches
    artifact_dir = tempfile.mkdtemp(prefix="ewq_artifact_")
    try:
        with phase(report, "4g llama artifact + session"):
            session_launches = serve_artifact_session(
                torch, build, report, model, params, ewq, prompts, base_outs,
                draft_stamp, min(report["analysis"][-1]["kernel_s"]),
                artifact_dir, device)
        for k, v in session_launches.items():
            launches[k] += v
        with phase(report, "4n llama mesh"):
            mesh_launches = serve_mesh(torch, build, report, model, params,
                                       ewq, prompts, base_outs, artifact_dir,
                                       device)
        for k, v in mesh_launches.items():
            launches[k] += v
    finally:
        shutil.rmtree(artifact_dir, ignore_errors=True)
    params = None                 # 4l trains its own llama from its init
    with phase(report, "4l llama train + EWQ + perplexity + serve"):
        train_launches = train_serve(torch, build, report, prompts, smoke,
                                     device)
    for k, v in train_launches.items():
        launches[k] += v
    with phase(report, "4m FastEWQ dataset"):
        dataset_launches = fastewq_dataset(torch, build, report, smoke,
                                           device)
    for k, v in dataset_launches.items():
        launches[k] += v
    with phase(report, "4o llama train over a mesh"):
        train_mesh(torch, build, report, smoke, device)
    for k in LLAMA_PATH:
        if launches[k] <= 0 and device == "cuda":
            raise AssertionError(f"kernel {k} never launched on llama's "
                                 "serve and analysis paths")
    return launches


FIT_HBM = 4 * 2**30      # 4d's device memory for Algorithm 1, bytes
FIT_RESERVED = 0.25      # its share kept for activations and caches
FASTEWQ_ARCHS = ("grok-1-314b", "arctic-480b")   # 4k (c) at full depth


def fastewq_rows(n_models: int = 30, seed: int = 0) -> list:
    """Block rows shaped like the paper's FastEWQ dataset (the JAX
    package's tests/test_fastewq.py ``_synthetic_rows``): later and larger
    blocks quantize more often."""
    import numpy as np
    from repro_torch.core.dataset import BlockRow
    rng = np.random.default_rng(seed)
    rows = []
    for m in range(n_models):
        nb = int(rng.integers(8, 40))
        base = rng.uniform(3e7, 5e8)
        for i in range(nb):
            size = int(base * rng.uniform(0.8, 1.2))
            rel = i / nb
            p_q = 0.05 + 0.9 * rel  # exec_index dominates (paper: 66%)
            q = int(rng.random() < p_q)
            rows.append(BlockRow(model_name=f"m{m}", num_blocks=nb,
                                 exec_index=i + 1, num_parameters=size,
                                 quantization_type="8-bit" if q else "raw",
                                 quantized=q))
    return rows


def block_sizes(model, params) -> list:
    """Each block's parameter count as EWQ counts it (its matrices), in
    ``compile_plan``'s block order; ``params`` may lie on the meta
    device."""
    from repro_torch.core.entropy import flatten_block_params
    return [sum(w.numel() for w in flatten_block_params(b).values()
                if w.ndim >= 2) for b in model.block_params(params)]


def held_bytes(params, raw) -> tuple[int, int, int]:
    """(bytes every tensor of a compiled tree holds, ternary at its 8-bit
    carrier; of those, the bytes of views into ``raw``'s storage; the bytes
    of the distinct storages the tree keeps alive once ``raw`` is
    dropped, which counts a view's whole stack)."""
    from repro_torch.quant.apply import SegmentedParams
    from repro_torch.quant.qtypes import QTensor
    from repro_torch.tree import tree_leaves
    raw_ptrs = {t.untyped_storage().data_ptr() for t in tree_leaves(raw)}
    total = shared = 0
    storages = {}
    for v in params.values():
        trees = ([g.params for g in v.segments]
                 if isinstance(v, SegmentedParams) else [v])
        for leaf in (x for t in trees for x in tree_leaves(t)):
            for t in ((leaf.data, leaf.scale) if isinstance(leaf, QTensor)
                      else (leaf,)):
                n = t.numel() * t.element_size()
                total += n
                st = t.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
                if st.data_ptr() in raw_ptrs:
                    shared += n
    return total, shared, sum(storages.values())


def ternary_carrier_bytes(params) -> float:
    """Bytes a compiled tree's ternary payloads hold beyond the 1.58 bits a
    weight that ``nbytes_effective`` counts: ternary rides an 8-bit
    carrier (the reference's format)."""
    from repro_torch.quant.apply import SegmentedParams
    from repro_torch.quant.qtypes import QTensor
    from repro_torch.tree import tree_leaves
    total = 0.0
    for v in params.values():
        trees = ([g.params for g in v.segments]
                 if isinstance(v, SegmentedParams) else [v])
        for leaf in (x for t in trees for x in tree_leaves(t)):
            if isinstance(leaf, QTensor) and leaf.precision == "ternary":
                total += leaf.data.numel() * (1 - 1.58 / 8)
    return total


def plan_kernels(plan) -> tuple:
    """The kernels a dense plan's precisions reach in a serve with an int8
    (or int4) dense cache: decode attention always, the attention and MLP
    kernels for a quantized layer, qmatmul for a quantized (tied)
    embedding's lm_head."""
    precs = plan.precisions()
    need = ["decode_attn"]
    if any(p != "raw" for p in precs[1:]):
        need += ["qkv", "qmlp", "qmatmul"]
    elif precs[0] != "raw":
        need.append("qmatmul")
    return tuple(need)


def fastewq_serve(torch, build, launches: dict, label: str, model, params,
                  plan, prompts, device: str) -> tuple:
    """The plan compiled into a graph engine with int8 KV and phase 4's
    requests served (launch counts from 0 just before the serve): valid
    outputs, every kernel of ``plan_kernels`` launched. Returns the run's
    readings and the engine."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.scheduler import Request
    fresh_memory(torch, device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    before = torch.cuda.memory_allocated() if device == "cuda" else None
    t0 = time.perf_counter()
    engine = ServeEngine(model, params, max_seq=1024, plan=plan,
                         kv_precision="int8", device=device)
    sync()
    compile_s = time.perf_counter() - t0
    rise = (torch.cuda.memory_allocated() - before
            if device == "cuda" else None)
    requests = [Request(rid=i, prompt=p, max_new_tokens=32)
                for i, p in enumerate(prompts)]
    need = plan_kernels(plan)
    outs, stats = _counted(
        build, launches, label, lambda: engine.serve(
            requests, num_slots=SLOTS, chunk=CHUNK), device, path=need)
    check_outputs(label, outs, model.cfg.vocab_size)
    held, shared, pinned = held_bytes(engine.params, params)
    run = dict(run=label, kv="int8", cuda_graphs=engine.graphs is not None,
               counts=plan.counts(), precisions=plan.precisions(),
               plan_total_bytes=plan.total_bytes(),
               weight_bytes=engine.weight_bytes(),
               allocated_rise_bytes=rise, held_bytes=held,
               held_raw_view_bytes=shared, held_storage_bytes=pinned,
               ternary_carrier_bytes=ternary_carrier_bytes(engine.params),
               compile_s=compile_s,
               tokens_per_s=stats.tokens_per_s, wall_s=stats.wall_s,
               generated=stats.generated_tokens, kernels_needed=list(need))
    log(f"fastewq: {label}: " + json.dumps(run))
    return run, engine


def serve_fastewq(torch, build, report: dict, model, params, ewq, prompts,
                  smoke: bool, device: str) -> dict:
    """Phase 4k (see the module docstring); returns its launch counts."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.core.cluster import (Machine, fastewq_resource_adjust,
                                          fit_plan_to_hbm)
    from repro_torch.core.dataset import to_xy, train_test_split
    from repro_torch.core.fastewq import evaluate_all_classifiers, train_fastewq
    from repro_torch.models.model import build as build_model
    from repro_torch.quant.compiler import (compile_kv_plan,
                                            degrade_kv_ladder, kv_tier_labels)
    card = report.get("nvidia_smi", f"{device} (no card)")
    launches = {k: 0 for k in build.LAUNCHES}
    out: dict = {"card": card}
    report["fastewq"] = out

    # (a) the classifier
    t0 = time.perf_counter()
    rows = fastewq_rows()
    fq = train_fastewq(rows, classifier="random forest", full_dataset=False,
                       seed=0)
    train_s = time.perf_counter() - t0
    x, y = to_xy(rows)
    _, _, xte, yte = train_test_split(x, y, 0.3, 0)
    acc = float((fq.clf.predict(fq.scaler.transform(xte)) == yte).mean())
    majority = float(max(yte.mean(), 1 - yte.mean()))
    t0 = time.perf_counter()
    table = evaluate_all_classifiers(rows, seed=0)
    classifiers = {k: dict(accuracy=v["accuracy"], auc=v["auc"])
                   for k, v in table.items()}
    out.update(rows=len(rows), train_s=train_s,
               evaluate_s=time.perf_counter() - t0, heldout_accuracy=acc,
               majority_baseline=majority, classifiers=classifiers,
               rf_feature_importances=table["random forest"][
                   "feature_importances"])
    log(f"fastewq: (a) random forest on {len(rows)} seeded rows: held-out "
        f"accuracy {acc:.4f} against the majority baseline {majority:.4f} "
        f"[{card}]")
    log(f"fastewq: (a) six classifiers (accuracy, AUC): "
        + json.dumps(classifiers))
    log(f"fastewq: (a) random forest feature importances "
        + json.dumps(out["rf_feature_importances"]))
    if acc <= majority:
        raise AssertionError(f"FastEWQ's forest ({acc}) does not beat the "
                             f"majority baseline ({majority})")

    # (b) the FastEWQ plan of llama from its sizes, compiled and served
    cfg = model.cfg
    sizes = block_sizes(model, params)
    if sizes != [d.num_parameters for d in ewq.decisions]:
        raise AssertionError("block sizes differ from the EWQ plan's")
    t0 = time.perf_counter()
    fast = fq.plan(sizes, variant="4bit/8bit")
    decide_us = (time.perf_counter() - t0) * 1e6
    agree = float(np.mean([f.quantized == e.quantized for f, e in
                           zip(fast.decisions, ewq.decisions)]))
    same = float(np.mean([f.precision == e.precision for f, e in
                          zip(fast.decisions, ewq.decisions)]))
    log(f"fastewq: (b) plan of {cfg.name} from {len(sizes)} block sizes in "
        f"{decide_us:.0f} host us, beside phase 4's EWQ analysis "
        f"{report['ewq_analysis_s']:.3f} s; counts {fast.counts()}; "
        f"quantized-or-not agreement with the EWQ plan {agree:.4f} "
        f"(precision agreement {same:.4f}) [{card}]")
    fast_run, fast_engine = fastewq_serve(torch, build, launches,
                                          "fastewq-4bit/8bit", model, params,
                                          fast, prompts, device)
    ewq_bytes = next(r["weight_bytes"] for r in report["runs"]
                     if r["run"] == "ewq-4bit/8bit")
    log(f"fastewq: (b) weight bytes {fast_run['weight_bytes']:.0f} "
        f"(plan {fast.total_bytes():.0f}) beside the EWQ run's "
        f"{ewq_bytes:.0f}; {fast_run['tokens_per_s']:.2f} tokens/s [{card}]")
    out.update(decide_us=decide_us, ewq_analysis_s=report["ewq_analysis_s"],
               fast_quantized=[int(d.quantized) for d in fast.decisions],
               block_agreement=agree, precision_agreement=same,
               fast_run=fast_run, ewq_weight_bytes=ewq_bytes)

    cuts = fast_engine._kv_cuts()      # for (e)
    fast_engine = None

    # (c) Algorithm 2 against the card's memory
    if device == "cuda":
        _, total = torch.cuda.mem_get_info()
    else:
        total = 2 * ewq.raw_bytes()     # the rehearsal's stand-in budget
    machine = Machine("h100", total, total)
    adjust = {}

    def algorithm2(name, plan):
        res = fastewq_resource_adjust(plan, [machine])
        adjust[name] = dict(fits=res["fits"], total_bytes=res["total_bytes"],
                            budget=res["budget"],
                            counts=res["plan"].counts(),
                            classifier_counts=plan.counts())
        log(f"fastewq: (c) Algorithm 2, {name}: fits {res['fits']} at "
            f"{res['total_bytes']:.0f} of {res['budget']:.0f} bytes, counts "
            f"{res['plan'].counts()} (classifier {plan.counts()}) [{card}]")

    algorithm2(cfg.name, fast)
    for arch in FASTEWQ_ARCHS:
        before = torch.cuda.memory_allocated() if device == "cuda" else 0
        big = build_model(get_config(arch))
        meta = big.init(torch.Generator(), "meta")
        big_sizes = block_sizes(big, meta)
        meta = None
        after = torch.cuda.memory_allocated() if device == "cuda" else 0
        if after != before:
            raise AssertionError(f"{arch}'s meta-device sizes allocated "
                                 f"{after - before} bytes")
        algorithm2(f"{arch} ({big.cfg.num_layers} layers)",
                   fq.plan(big_sizes, variant="4bit/8bit"))
    out["algorithm2"] = adjust

    # (d) Algorithm 1 to a weight budget that forces demotion
    hbm = FIT_HBM if not smoke else ewq.total_bytes() * 0.6 / (
        1 - FIT_RESERVED)
    budget = hbm * (1 - FIT_RESERVED)
    fitted = fit_plan_to_hbm(ewq, hbm_bytes_per_device=hbm, devices=1,
                             reserved_fraction=FIT_RESERVED)
    if fitted.total_bytes() > budget or \
            fitted.total_bytes() >= ewq.total_bytes():
        raise AssertionError(f"Algorithm 1 did not demote to the budget: "
                             f"{fitted.total_bytes()} of {budget}")
    fit_run, _ = fastewq_serve(torch, build, launches, "fit-3GiB", model,
                               params, fitted, prompts, device)
    # the compile allocates every block it keeps (raw segments that cover
    # part of a stack are copies), ternary at its 8-bit carrier: set that
    # carrier's excess aside, the rest must fit the budget
    rise = fit_run["allocated_rise_bytes"]
    carrier = fit_run["ternary_carrier_bytes"]
    measured = {"weight_bytes": fit_run["weight_bytes"],
                "allocated_rise_bytes less the ternary carrier":
                None if rise is None else rise - carrier}
    for k, v in measured.items():
        if v is not None and v > budget:
            raise AssertionError(f"the fitted plan's {k} {v} exceed the "
                                 f"budget {budget}")
    if abs(fit_run["held_bytes"] - carrier - fit_run["weight_bytes"]) > \
            1e-3 * fit_run["weight_bytes"]:
        raise AssertionError(f"the engine's tensors hold "
                             f"{fit_run['held_bytes']} bytes: more than "
                             f"weight_bytes and the ternary carrier "
                             f"({carrier:.0f})")
    if rise is not None and abs(fit_run["held_bytes"] - fit_run[
            "held_raw_view_bytes"] - rise) > 0.01 * rise:
        raise AssertionError(f"the compile's rise {rise} is not the bytes "
                             f"its new tensors hold")
    out.update(fit_budget=budget, fit_hbm=hbm, fit_run=fit_run)
    held = fit_run["held_bytes"]
    log(f"fastewq: (d) Algorithm 1 to {budget:.0f} bytes: counts "
        f"{fitted.counts()}, plan {fitted.total_bytes():.0f}, weight_bytes "
        f"{fit_run['weight_bytes']:.0f}, allocated rise {rise}; the "
        f"engine's tensors hold {held} bytes "
        f"({'over' if held > budget else 'within'} the budget: ternary "
        f"rides an 8-bit carrier; {fit_run['held_raw_view_bytes']} of them "
        f"are views of the raw params: whole leaves, every partial raw "
        f"segment a copy); distinct storages kept alive "
        f"{fit_run['held_storage_bytes']} bytes, of which the ternary "
        f"carrier {carrier:.0f}; "
        f"{fit_run['tokens_per_s']:.2f} tokens/s [{card}]")
    if fit_run["held_storage_bytes"] > held:
        raise AssertionError(f"the compiled tree pins "
                             f"{fit_run['held_storage_bytes']} bytes of "
                             f"storage for {held} bytes of tensors")

    # (e) the FastEWQ KV spill ladder, at the FastEWQ engine's cuts
    base = compile_kv_plan(cfg, None, "int8")
    ladder = degrade_kv_ladder(cfg, None, base, fastewq=fq,
                               block_sizes=sizes[1:], cuts=cuts)
    labels = kv_tier_labels(ladder)
    rank = {"bf16": 2, "int8": 1, "int4": 0}
    tiers = [[rank[p] for p in kv.precisions] for kv in ladder]
    if ladder[-1].precisions != ("int4",) * cfg.num_layers or len(tiers) < 2:
        raise AssertionError(f"FastEWQ ladder does not end all int4: {labels}")
    for lo, hi in zip(tiers[1:], tiers[:-1]):
        if any(a > b for a, b in zip(lo, hi)) or sum(lo) >= sum(hi):
            raise AssertionError(f"a FastEWQ tier does not lower the "
                                 f"precision: {labels}")
    out["ladder"] = dict(labels=labels, cuts=list(cuts),
                         tiers=[list(kv.precisions) for kv in ladder],
                         spill_order=fq.kv_spill_order(sizes[1:]))
    log(f"fastewq: (e) KV ladder from int8 at cuts {list(cuts)}: {labels}; "
        f"tier 1 {list(ladder[1].precisions)}")
    return launches


TRAIN_STEPS = 30        # 4l: the serve launcher's --train-steps default
TRAIN_BATCH, TRAIN_SEQ = 4, 256
EVAL = dict(batch=8, seq=64, steps=4)     # tests/test_system.py's evaluate
# benchmarks/common.py:120's seeds; its 30 steps halved for the run's time
DATASET_STEPS, DATASET_SEEDS = 15, (0, 1)
# 4l: the least mean fall, in nats, of the last five steps' losses below
# the init's loss on the same batches (an update not applied gives 0, one
# of the wrong sign less than 0)
TRAIN_GAIN_MIN = 0.05


def train_serve(torch, build, report: dict, prompts, smoke: bool,
                device: str) -> dict:
    """Phase 4l: llama3.2-3b FULL trained, then EWQ-planned as the serve
    launcher plans it (the kernel-mode analysis, one grouped entropy
    launch, beside it), compiled, served and evaluated. Returns its launch
    counts."""
    import numpy as np
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.planner import plan_model
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.models.model import build as build_model
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.quantized import (apply_plan_to_params,
                                               plan_for_variant)
    from repro_torch.serving.scheduler import Request
    from repro_torch.train.loop import evaluate, train
    from repro_torch.train.step import make_eval_step
    from repro_torch.tree import tree_leaves
    card = report.get("nvidia_smi", f"{device} (no card)")
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    launches = {k: 0 for k in build.LAUNCHES}
    out: dict = {"card": card}
    report["train_serve"] = out
    cfg = get_config("llama3.2-3b", smoke=smoke)
    seq = TRAIN_SEQ if not smoke else 32

    def allocated():
        return torch.cuda.memory_allocated() if cuda else None

    def peak():
        return torch.cuda.max_memory_allocated() if cuda else None

    # the init's loss on each step's batch: what an lr=0 run of the same
    # steps reports (its params never move), so the trained run is held to
    # it batch by batch (train() draws the init from seed 0 and its
    # DataLoader gives step i's synthetic_batch)
    fresh_memory(torch, device)
    model = build_model(cfg)
    init = model.init(torch.Generator(device=device).manual_seed(0), device)
    eval_step = make_eval_step(model)
    init_losses = [float(eval_step(init, synthetic_batch(
        cfg, batch=TRAIN_BATCH, seq=seq, step=i, device=device))["loss"])
        for i in range(TRAIN_STEPS)]
    init = eval_step = model = None
    out["init_losses"] = init_losses

    # the launcher's run: lr 1e-3, warmup 3, no remat, f32 moments
    runs = {}
    params = model = None
    for label, steps, moments in (("f32-moments", TRAIN_STEPS, "float32"),
                                  ("int8-moments", 2, "int8")):
        fresh_memory(torch, device)
        before = allocated()
        run = RunConfig(steps=steps, learning_rate=1e-3, warmup_steps=3,
                        remat=False, moment_dtype=moments)
        t0 = time.perf_counter()
        res = train(cfg, run, batch=TRAIN_BATCH, seq=seq, device=device,
                    log_every=10, log_fn=lambda line: log(f"train: {line}"))
        sync()
        losses = res["losses"]
        runs[label] = dict(
            steps=steps, batch=TRAIN_BATCH, seq=seq, moment_dtype=moments,
            losses=losses, step_ms=[s * 1e3 for s in res["step_s"]],
            median_step_ms=float(np.median(res["step_s"]) * 1e3),
            seconds=time.perf_counter() - t0, allocated_before=before,
            max_memory_allocated=peak(),
            params=sum(p.numel() for p in tree_leaves(res["params"])))
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train {label}: a non-finite loss {losses}")
        if label == "f32-moments":
            if not losses[-1] < losses[0]:
                raise AssertionError(f"train: the loss did not fall: {losses}")
            below = [a - b for a, b in zip(losses[-5:], init_losses[-5:])]
            gain = -float(np.mean(below))
            runs[label].update(below_init_last5=below, gain_last5=gain)
            if not (all(d < 0 for d in below) and gain > TRAIN_GAIN_MIN):
                raise AssertionError(
                    f"train: the last five losses against the init's on the "
                    f"same batches {below} (mean fall {gain}, at least "
                    f"{TRAIN_GAIN_MIN} wanted)")
            log(f"train: last five steps below the init's loss on the same "
                f"batches by {[round(-d, 4) for d in below]} (mean {gain:.4f}"
                f" nats); the init's losses over the 30 batches span "
                f"{min(init_losses):.4f}-{max(init_losses):.4f} [{card}]")
            params, model = res["params"], res["model"]
        res = None
        log(f"train: {cfg.name} {label}: loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} over {steps} steps of {TRAIN_BATCH}x{seq}; "
            f"median step {runs[label]['median_step_ms']:.1f} ms; peak "
            f"{runs[label]['max_memory_allocated']} B allocated (from "
            f"{before} B) [{card}]")
    out["runs"] = runs
    sync()
    fresh_memory(torch, device)

    # EWQ of the trained weights as the serve launcher plans them
    # (plan_for_variant: paper mode, plain PyTorch, no entropy kernel)
    build.reset_launches()
    t0 = time.perf_counter()
    ewq = plan_for_variant(model, params, "4bit/8bit")
    sync()
    ewq_s = time.perf_counter() - t0
    paper_launches = build.LAUNCHES["entropy"]
    if not any(p != "raw" for p in ewq.precisions()[1:]):
        raise AssertionError(f"EWQ quantized no layer: {ewq.precisions()}")
    # beside it, the kernel-mode analysis: one grouped entropy launch
    build.reset_launches()
    t0 = time.perf_counter()
    kernel = plan_model(model, params, variant="4bit/8bit", mode="kernel")
    sync()
    kernel_s = time.perf_counter() - t0
    entropy_launches = build.LAUNCHES["entropy"]
    launches["entropy"] += entropy_launches
    if cuda and entropy_launches != 1:
        raise AssertionError(f"the trained model's kernel-mode analysis took "
                             f"{entropy_launches} entropy launches, not 1")
    mode_agree = float(np.mean([a.quantized == b.quantized for a, b in
                                zip(kernel.decisions, ewq.decisions)]))
    fast_q = report.get("fastewq", {}).get("fast_quantized")
    fast_random = report.get("fastewq", {}).get("block_agreement")
    fast_agree = (None if fast_q is None else float(np.mean(
        [f == int(e.quantized) for f, e in zip(fast_q, ewq.decisions)])))
    fast_agree_kernel = (None if fast_q is None else float(np.mean(
        [f == int(e.quantized) for f, e in zip(fast_q, kernel.decisions)])))
    out.update(ewq_analysis_s=ewq_s, ewq_entropy_launches=paper_launches,
               ewq_counts=ewq.counts(), ewq_precisions=ewq.precisions(),
               kernel_analysis_s=kernel_s, entropy_launches=entropy_launches,
               kernel_counts=kernel.counts(),
               kernel_ewq_agreement=mode_agree,
               fastewq_agreement=fast_agree,
               fastewq_agreement_kernel_mode=fast_agree_kernel,
               fastewq_agreement_random_weights=fast_random)
    log(f"train: EWQ of the trained weights (the launcher's plan_for_variant,"
        f" paper mode, {ewq_s:.3f} s, {paper_launches} entropy launches): "
        f"{ewq.counts()} {ewq.precisions()}; kernel mode beside it "
        f"({kernel_s:.3f} s, {entropy_launches} entropy launches) "
        f"{kernel.counts()} (blocks agreeing {mode_agree:.4f}); FastEWQ's "
        f"plan agrees on {fast_agree} of the blocks (kernel mode "
        f"{fast_agree_kernel}; phase 4k on the random weights {fast_random})"
        f" [{card}]")
    kernel = None

    # compiled and served from CUDA graphs with int8 KV: phase 4's requests
    fresh_memory(torch, device)
    engine = ServeEngine(model, params, max_seq=1024, plan=ewq,
                         kv_precision="int8", device=device)
    requests = [Request(rid=i, prompt=p, max_new_tokens=32)
                for i, p in enumerate(prompts)]
    serve_path = ("qmatmul", "qkv", "qmlp", "decode_attn")
    outs, stats = _counted(build, launches, "trained ewq serve", lambda:
                           engine.serve(requests, num_slots=SLOTS,
                                        chunk=CHUNK), device, path=serve_path)
    check_outputs("trained ewq serve", outs, cfg.vocab_size)
    out["serve"] = dict(
        kv="int8", cuda_graphs=engine.graphs is not None,
        generated=stats.generated_tokens, tokens_per_s=stats.tokens_per_s,
        ttft_mean_s=stats.ttft_mean_s, wall_s=stats.wall_s,
        weight_bytes=engine.weight_bytes(), max_memory_allocated=peak(),
        repeat_share=repeat_share(outs))
    log("train: served the trained EWQ weights: " + json.dumps(out["serve"]))

    # held-out perplexity: raw, EWQ, 8bit-mixed, uniform 4bit; the eval
    # batch through the kernels held to the plain versions once
    evals = {}
    ev_launches = {k: 0 for k in build.LAUNCHES}
    # the first held-out batch evaluate reads
    eval_tokens = synthetic_batch(cfg, batch=EVAL["batch"], seq=EVAL["seq"],
                                  step=100_000, device=device)["tokens"]
    for label, variant in (("raw", None), ("ewq-4bit/8bit", "4bit/8bit"),
                           ("8bit-mixed", "8bit-mixed"), ("4bit", "4bit")):
        if variant is None:
            q = params
        elif variant == "4bit/8bit":
            q = engine.params
        else:
            q = apply_plan_to_params(
                model, params, plan_for_variant(model, params, variant))
        t0 = time.perf_counter()
        path = () if variant is None else ("qmatmul", "qkv", "qmlp")
        ev = _counted(build, ev_launches, f"evaluate {label}", lambda:
                      evaluate(model, q, device=device, **EVAL), device,
                      path=path)
        sync()
        ev["seconds"] = time.perf_counter() - t0
        if variant is not None:
            with torch.no_grad():
                k_logits = model.apply(q, eval_tokens).float()
                p_logits = model.apply(q, eval_tokens, plain=True).float()
            ev["logit_rel_l2_vs_plain"] = rel_l2(k_logits, p_logits)
            if ev["logit_rel_l2_vs_plain"] > LOGIT_REL_L2:
                raise AssertionError(f"evaluate {label}: kernels vs plain "
                                     f"{ev['logit_rel_l2_vs_plain']}")
            k_logits = p_logits = None
        evals[label] = ev
        q = None
    for k, v in ev_launches.items():
        launches[k] += v
    engine = None
    order = sorted(evals, key=lambda k: evals[k]["perplexity"])
    out.update(evaluate=evals, evaluate_launches=ev_launches,
               perplexity_order=order)
    log(f"train: held-out perplexity ({EVAL['batch']}x{EVAL['seq']}, "
        f"{EVAL['steps']} steps): " + ", ".join(
            f"{k} {v['perplexity']:.4f}" for k, v in evals.items())
        + f"; lowest first {order}; the evaluations launched "
        f"{ {k: v for k, v in ev_launches.items() if v} } [{card}]")
    params = model = None
    fresh_memory(torch, device)
    return launches


def fastewq_dataset(torch, build, report: dict, smoke: bool,
                    device: str) -> dict:
    """Phase 4m: ``build_dataset`` on the card over every arch of the
    registry (each model planned with the reference's analysis, paper mode,
    which launches no entropy kernel), and the six classifiers on its rows.
    Returns its launch counts."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.dataset import build_dataset, to_xy
    from repro_torch.core.fastewq import evaluate_all_classifiers
    card = report.get("nvidia_smi", f"{device} (no card)")
    launches = {k: 0 for k in build.LAUNCHES}
    steps = DATASET_STEPS if not smoke else 2
    t0 = time.perf_counter()
    rows = _counted(build, launches, "build_dataset", lambda: build_dataset(
        steps=steps, seeds=DATASET_SEEDS, device=device), device, path=())
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    models = len(ARCHS) * len(DATASET_SEEDS)
    _, y = to_xy(rows)
    t0 = time.perf_counter()
    table = evaluate_all_classifiers(rows, seed=0)
    classifiers = {k: dict(accuracy=v["accuracy"], auc=v["auc"])
                   for k, v in table.items()}
    out = dict(card=card, archs=list(ARCHS), seeds=list(DATASET_SEEDS),
               steps=steps, models=models, rows=len(rows),
               quantized_share=float(y.mean()), seconds=seconds,
               entropy_launches=launches["entropy"],
               evaluate_s=time.perf_counter() - t0, classifiers=classifiers)
    report["fastewq_dataset"] = out
    log(f"dataset: {len(rows)} rows from {models} models ({len(ARCHS)} "
        f"archs x seeds {list(DATASET_SEEDS)}, {steps} steps each) in "
        f"{seconds:.1f} s, {launches['entropy']} entropy launches; "
        f"quantized share {out['quantized_share']:.4f} [{card}]")
    seeded = report.get("fastewq", {}).get("heldout_accuracy")
    log(f"dataset: six classifiers on these rows (accuracy, AUC; smoke-size "
        f"models, beside phase 4k's forest at {seeded} on seeded rows and "
        f"the paper's 80%): " + json.dumps(classifiers))
    return launches


# 4o: llama3.2-3b FULL trained over meshes laid on the one card
MESH_TRAIN_SHAPES = ((2, 1), (2, 2))          # 4o (a)
MESH_STEPS_SHAPE = (2, 2)                     # 4o (b)
ELASTIC_LAYERS = 2                            # 4o (d): 2 of 28, full width
ELASTIC_SAVE, ELASTIC_RESTORE = (2, 2), ((4, 1), (1, 4))
# 4o limits against the mesh-less step in bf16, each between the floor
# and a planted fault read on the card (PERF.md §6 keeps them): the loss
# (floor 4.3e-5; the dropped-slice fault 4.0e-3 at step 2), a gradient
# leaf (floor 0.034 at (2, 2); summed twice 1.0), a param leaf after three
# steps (floor 0.115, w_down, whose init scale the steps' updates match;
# the dropped-slice fault 0.548)
MESH_LOSS_RTOL = 1e-3
MESH_GRAD_REL_L2 = 0.1
MESH_PARAM_REL_L2 = 0.25
COMPRESS_BOUND = 0.05   # tests/test_sharding.py:223's bound on the mean


@contextlib.contextmanager
def measured(torch, out: dict, name: str, device: str, card: str):
    """Part ``name`` of a phase: its seconds and, on the card, its peak
    device memory (from a fresh count) into ``out[name]`` and a line."""
    fresh_memory(torch, device)
    t0 = time.perf_counter()
    part = out.setdefault(name, {})
    try:
        yield part
    finally:
        if device == "cuda":
            torch.cuda.synchronize()
            part["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        part["seconds"] = time.perf_counter() - t0
        log(f"train mesh: part {name}: {part['seconds']:.1f} s, peak "
            f"{part.get('max_memory_allocated')} B allocated [{card}]")


def within(label: str, value: float, limit: float, fault=None) -> None:
    """Raises unless ``value`` is at most ``limit`` and the planted fault's
    reading ``fault`` (when given) is above it. 4o's limits are placed at
    FULL width, so its SMOKE rehearsal on the CPU passes no fault."""
    if value > limit:
        raise AssertionError(f"{label}: {value} over the limit {limit}")
    if fault is not None and fault <= limit:
        raise AssertionError(f"{label}: the limit {limit} misses the "
                             f"planted fault ({fault})")


def leaf_rels(torch, got_tree, want: list, names: list) -> list:
    """[(relative L2, leaf name), ...] of a tree's leaves against ``want``
    (tensors in the tree's leaf order), the worst first."""
    from repro_torch.tree import tree_leaves
    rels = [(rel_l2(g, w), name)
            for name, g, w in zip(names, tree_leaves(got_tree), want)]
    return sorted(rels, reverse=True)


@contextlib.contextmanager
def patched_unshard(mode: str):
    """A planted fault in the FSDP gather (``FSDPLeaf.unshard``), and only
    inside the block. ``"twice"``: each slice's gradient summed twice over
    the data rows (the value unchanged); ``"dropped"``: every slice but the
    first row's left out of the backward."""
    from repro_torch.sharding import collective as C
    orig = C.FSDPLeaf.unshard

    def faulty(self):
        x = orig(self)
        if self.dim is None:
            return x
        if mode == "twice":
            return x + (x - x.detach())
        return C.gather([self.parts[0]] + [p.detach()
                                           for p in self.parts[1:]],
                        self.device, self.dim)

    C.FSDPLeaf.unshard = faulty
    try:
        yield
    finally:
        C.FSDPLeaf.unshard = orig


def shared_levels_check(torch, gs: list, errs: list, group: int = 256
                        ) -> bool:
    """``decoded_local + new_error == corrected`` to the bit for each
    position of one leaf: the levels and the shared scale recomputed here
    from the corrected gradients (absmax over the positions / 127)."""
    corrected = [g.float().reshape(-1) for g in gs]
    n = corrected[0].numel()
    pad = (-n) % group
    grs = [torch.nn.functional.pad(c, (0, pad)).reshape(-1, group)
           for c in corrected]
    scale = torch.stack([gr.abs().amax(dim=-1) for gr in grs]).amax(0) / 127
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    for c, gr, e in zip(corrected, grs, errs):
        q = torch.clamp(torch.round(gr / safe[:, None]), -127, 127)
        local = (q * scale[:, None]).reshape(-1)[:n]
        if not torch.equal(local + e.reshape(-1), c):
            return False
    return True


def train_mesh(torch, build, report: dict, smoke: bool, device: str) -> None:
    """Phase 4o: llama3.2-3b FULL trained over meshes of the port's own laid
    on the card (every position ``cuda:0``, each with its own slices), held
    to the mesh-less step: (a) one step's loss and gathered gradients on
    (2, 1) and (2, 2); (b) three AdamW steps of ``train(mesh=(2, 2))``
    against three of ``train``; (c) ``compressed_psum_mean`` of the two
    data rows' own gradients; (d) a (params, int8 AdamWState) placement of
    2 of the 28 layers saved on (2, 2) and restored onto (4, 1) and
    (1, 4). No port kernel runs (training is autograd over the raw
    weights, as the reference leaves it to XLA): asserted."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.models.model import build as build_model
    from repro_torch.optim.compress import compressed_psum_mean, init_error
    from repro_torch.quant.qtypes import QTensor
    from repro_torch.sharding.specs import (flatten_with_names, gather_tree,
                                            opt_state_specs, param_specs,
                                            shard_tree)
    from repro_torch.train.loop import train
    from repro_torch.train.step import (make_grad_fn, make_loss_fn,
                                        make_train_step)
    from repro_torch.tree import tree_leaves, tree_map
    card = report.get("nvidia_smi", f"{device} (no card)")
    out: dict = {"card": card}
    report["train_mesh"] = out
    cfg = get_config("llama3.2-3b", smoke=smoke)
    seq = TRAIN_SEQ if not smoke else 32
    devices = None if device == "cuda" else [device]

    def mesh_of(shape):
        return make_mesh(shape, ("data", "model"), devices=devices)

    def quiet(line):
        pass

    build.reset_launches()
    model = build_model(cfg)
    run = RunConfig(learning_rate=1e-3, warmup_steps=3, remat=False)
    opt = make_optimizer(run)
    batch = synthetic_batch(cfg, batch=TRAIN_BATCH, seq=seq, step=0,
                            device=device)

    # (a) one step's loss and gradients against the mesh-less step's
    with measured(torch, out, "a", device, card) as part:
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            device)
        names = [n for n, _ in flatten_with_names(params)]
        (loss0, _), g = make_train_step(model, opt, run).compute_grads(
            params, batch)
        want = tree_leaves(g)
        g = None
        part["meshless_loss"] = float(loss0)
        for shape in MESH_TRAIN_SHAPES:
            mesh = mesh_of(shape)
            placed = shard_tree(params, param_specs(params, mesh), mesh)
            step = make_train_step(model, opt, run, mesh=mesh)
            (loss, _), g = step.compute_grads(placed, batch)
            rels = leaf_rels(torch, gather_tree(g), want, names)
            g = None
            got = dict(loss=float(loss),
                       loss_rel_diff=abs(float(loss) - float(loss0))
                       / abs(float(loss0)), worst_grads=rels[:6])
            if shape == MESH_TRAIN_SHAPES[0]:
                with patched_unshard("twice"):
                    (_, _), g = step.compute_grads(placed, batch)
                    fault = leaf_rels(torch, gather_tree(g), want, names)
                    g = None
                got["planted_fault_twice"] = fault[:3]
            part[f"{shape[0]}x{shape[1]}"] = got
            placed = None
            log(f"train mesh: (a) {shape}: loss {got['loss']:.6f} against "
                f"the mesh-less {float(loss0):.6f} (relative "
                f"{got['loss_rel_diff']:.3g}, limit {MESH_LOSS_RTOL}); "
                f"gradients, relative L2 by leaf, worst first "
                f"{[(round(r, 6), n) for r, n in rels[:6]]} (limit "
                f"{MESH_GRAD_REL_L2})" + (
                    f"; planted fault (each slice's gradient summed twice "
                    f"over the data rows) {fault[0]}"
                    if "planted_fault_twice" in got else "") + f" [{card}]")
            within(f"4o (a) {shape} loss", got["loss_rel_diff"],
                   MESH_LOSS_RTOL)
            within(f"4o (a) {shape} gradients {rels[0][1]}", rels[0][0],
                   MESH_GRAD_REL_L2, fault[0][0]
                   if "planted_fault_twice" in got and not smoke else None)
        params = None
        want = None

    # (b) three AdamW steps: train(mesh=) against train()
    with measured(torch, out, "b", device, card) as part:
        run3 = dataclasses.replace(run, steps=3)
        res = train(cfg, run3, batch=TRAIN_BATCH, seq=seq, device=device,
                    log_fn=quiet)
        meshless = res["losses"]
        want = tree_leaves(res["params"])
        res = None
        fresh_memory(torch, device)
        mesh = mesh_of(MESH_STEPS_SHAPE)
        runs = {}
        for label, fault in (("mesh", None), ("planted_fault_dropped",
                                              "dropped")):
            with (patched_unshard(fault) if fault else
                  contextlib.nullcontext()):
                res = train(cfg, run3, batch=TRAIN_BATCH, seq=seq,
                            mesh=mesh, log_fn=quiet)
            runs[label] = dict(losses=res["losses"], worst_params=leaf_rels(
                torch, gather_tree(res["params"]), want, names)[:6],
                step_s=res["step_s"])
            res = None
        rels = runs["mesh"]["worst_params"]
        fault = runs["planted_fault_dropped"]["worst_params"]
        part.update(meshless_losses=meshless, **runs)
        log(f"train mesh: (b) three steps on {MESH_STEPS_SHAPE}: losses "
            f"{runs['mesh']['losses']} against the mesh-less {meshless}; "
            f"params, relative L2 by leaf, worst first "
            f"{[(round(r, 6), n) for r, n in rels]} (limit "
            f"{MESH_PARAM_REL_L2}); mesh step s "
            f"{[round(s, 3) for s in runs['mesh']['step_s']]}; planted "
            f"fault (the FSDP gather's backward drops every row's slice "
            f"but the first) {fault[0]} [{card}]")
        diffs = {label: max(abs(a - b) / abs(b) for a, b in zip(
            run_["losses"], meshless)) for label, run_ in runs.items()}
        part["loss_rel_diff"] = diffs
        within("4o (b) loss", diffs["mesh"], MESH_LOSS_RTOL,
               None if smoke else diffs["planted_fault_dropped"])
        within(f"4o (b) params {rels[0][1]}", rels[0][0], MESH_PARAM_REL_L2,
               None if smoke else fault[0][0])
        want = None

    # (c) the int8 error-feedback mean of the two data rows' gradients
    with measured(torch, out, "c", device, card) as part:
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            device)
        grad_fn = make_grad_fn(make_loss_fn(model, remat=False))
        rows = [{k: v.chunk(2, 0)[r] for k, v in batch.items()}
                for r in range(2)]
        gs = [tree_leaves(grad_fn(params, r)[1]) for r in rows]
        params = None
        worst, exact = [], True
        for name, a, b in zip(names, *gs):
            leaf = [{"g": a}, {"g": b}]
            means, errs = compressed_psum_mean(
                leaf, [init_error(x) for x in leaf])
            plain = (a.float() + b.float()) / 2
            rel = float((means[0]["g"].float() - plain).abs().max()
                        / plain.abs().max().clamp_min(1e-30))
            worst.append((rel, name))
            exact &= shared_levels_check(torch, [a, b],
                                         [e["g"] for e in errs])
            means = errs = plain = None
        gs = None
        worst.sort(reverse=True)
        part.update(worst_mean_rel=worst[:6], error_feedback_exact=exact)
        log(f"train mesh: (c) compressed_psum_mean of the two rows' "
            f"gradients against their plain mean, max |difference| / max "
            f"|mean| by leaf, worst first "
            f"{[(round(r, 6), n) for r, n in worst[:6]]} (the reference "
            f"test's bound {COMPRESS_BOUND}); decoded_local + new_error == "
            f"corrected to the bit on every leaf: {exact} [{card}]")
        within(f"4o (c) mean {worst[0][1]}", worst[0][0], COMPRESS_BOUND)
        if not exact:
            raise AssertionError("4o (c): decoded_local + new_error differs "
                                 "from the corrected gradient")

    # (d) elastic restore: int8 moments, 2 of 28 layers at full width
    with measured(torch, out, "d", device, card) as part:
        cfg2 = dataclasses.replace(cfg, num_layers=ELASTIC_LAYERS)
        model2 = build_model(cfg2)
        run8 = dataclasses.replace(run, moment_dtype="int8")
        opt8 = make_optimizer(run8)
        params = model2.init(torch.Generator(device=device).manual_seed(0),
                             device)
        mesh = mesh_of(ELASTIC_SAVE)
        placed = shard_tree(params, param_specs(params, mesh), mesh)
        like = tree_map(lambda p: torch.empty_like(p, device="meta"),
                        params)
        like = (like, opt8.init(like))
        params = None
        state = opt8.init(placed)
        placed, state, _ = make_train_step(model2, opt8, run8, mesh=mesh)(
            placed, state, batch)       # the moments nonzero
        saved = (placed, state)
        logical_tree = (gather_tree(placed), gather_tree(state))
        logical = ckpt.flatten_with_paths(logical_tree)
        nbytes = sum(sum(t.numel() * t.element_size() for t in (
            (x.data, x.scale) if isinstance(x, QTensor) else (x,)))
            for _, x in logical)
        directory = tempfile.mkdtemp(prefix="mesh_ckpt_")
        try:
            free = shutil.disk_usage(directory).free
            if free < 2 * nbytes:
                raise AssertionError(f"4o (d): {free} B free for a "
                                     f"{nbytes} B checkpoint")
            t0 = time.perf_counter()
            ckpt.save(directory, 1, saved, extra={"mesh": "2x2"})
            part["save_s"] = time.perf_counter() - t0
            saved = placed = state = None
            for shape in ELASTIC_RESTORE:
                mesh = mesh_of(shape)
                pspecs = param_specs(like[0], mesh)
                t0 = time.perf_counter()
                restored, extra = ckpt.restore(
                    directory, like, mesh=mesh,
                    specs=(pspecs, opt_state_specs(like[1], pspecs, mesh)))
                seconds = time.perf_counter() - t0
                back = ckpt.flatten_with_paths(gather_tree(restored))
                equal = [k for k, _ in back] == [k for k, _ in logical]
                for (_, x), (_, y) in zip(back, logical):
                    pairs = ((x.data, y.data), (x.scale, y.scale)) \
                        if isinstance(y, QTensor) else ((x, y),)
                    equal &= all(torch.equal(u, v) for u, v in pairs)
                slices = elastic_slices_hold(torch, restored, logical_tree)
                part[f"{shape[0]}x{shape[1]}"] = dict(
                    restore_s=seconds, logical_equal=equal,
                    positions_hold_their_slices=slices, extra=extra)
                log(f"train mesh: (d) saved on {ELASTIC_SAVE}, restored "
                    f"onto {shape} in {seconds:.2f} s: logical arrays equal "
                    f"to the bit {equal}, each position's slices those its "
                    f"specs name {slices} ({nbytes} B of params and int8 "
                    f"moments; save {part['save_s']:.2f} s) [{card}]")
                if not (equal and slices):
                    raise AssertionError(f"4o (d) onto {shape}: equal "
                                         f"{equal}, slices {slices}")
                restored = None
        finally:
            shutil.rmtree(directory, ignore_errors=True)
    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    out["kernel_launches"] = launched
    if launched:
        raise AssertionError(f"4o launched port kernels {launched}: mesh "
                             f"training runs the raw forward")


def elastic_slices_hold(torch, restored, logical_tree) -> bool:
    """Every position of ``restored`` holding, to the bit, the slices
    ``shard_tree`` cuts for it from the logical arrays under the same
    specs."""
    from repro_torch.checkpoint.ckpt import flatten_with_paths
    from repro_torch.quant.qtypes import QTensor
    from repro_torch.sharding.specs import positions, shard_tree
    want = shard_tree(logical_tree, restored.specs, restored.mesh)
    for pos in positions(restored.mesh):
        got, exp = (flatten_with_paths(restored.at(pos)),
                    flatten_with_paths(want.at(pos)))
        if [k for k, _ in got] != [k for k, _ in exp]:
            return False
        for (_, x), (_, y) in zip(got, exp):
            pairs = (((x.data, y.data), (x.scale, y.scale))
                     if isinstance(y, QTensor) else ((x, y),))
            if not all(torch.equal(u, v) for u, v in pairs):
                return False
    return True


def check_outputs(label: str, outs, vocab: int, max_new: int = 32) -> None:
    """Each request generated ``max_new`` tokens in the vocabulary, with
    finite log-probs."""
    import numpy as np
    for o in outs:
        gen_toks = o.generated
        if (len(gen_toks) != max_new or gen_toks.min() < 0
                or gen_toks.max() >= vocab
                or not np.all(np.isfinite(o.logprobs))):
            raise AssertionError(f"{label}: bad output for request "
                                 f"{o.rid}: {gen_toks}")


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
    model-draft engine. Returns the launches of both serves, the
    model-draft serve's outputs and its draft's stamp
    (``DraftPlan.to_manifest()``)."""
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
                draft_stamp = engine._ensure_draft().to_manifest()
                report["spec_readings"] = spec_readings(torch, model, engine,
                                                        prompts, device)
        else:
            require_same(label, graph_outs, outs, logprobs=True)
            run["identical_to_graph_run"] = True
    report["spec_runs"] = runs
    return launches, model_outs, draft_stamp


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
    the launches of the serves and the compiled EWQ params (phase 4i
    serves them)."""
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

    def stream_serve(share: bool, label: str):
        """The stream on a fresh engine: with sharing from an 11-page
        pool, or without from a 20-page pool; with its prefills
        (``prefill_times``)."""
        eng = ServeEngine(model, peng.params, max_seq=1024,
                          kv_precision="int8", device=device,
                          paged=PagedConfig(page_size=PAGE,
                                            pool_pages=11 if share else 20,
                                            prefix_sharing=share))
        with prefill_times(torch, device) as prefills:
            got = serve(eng, stream, label)
        return eng, got, prefills

    seng, (s_outs, s_stats, s_run), s_pre = stream_serve(
        True, "paged-shared-prefix-11")
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
    seng = pool = None
    # Sharing must cut a hit's prefill: its 32-token suffix scored in ONE
    # multi-query step over the shared rows, against the whole 288-token
    # prompt without sharing. The check holds each hit to one step of its
    # suffix, and the median device time of the 7 hits' prefills (the
    # kernels and copies the profiler traces) below the median of the same
    # prompts' prefills without sharing. Wall times and mean TTFTs are
    # readings: an eager prompt step's wall time is set by the host's
    # dispatch, and the streams' mean TTFTs (queueing and the 11-page
    # pool's requeues in them) differ by less than one serve's spread
    # (PERF.md §6).
    _, (n_outs, _, n_run), n_pre = stream_serve(False, "paged-no-sharing-20")
    d_outs, _, d_run = serve(dense, stream, "dense-shared-prefix-stream")
    hits = [r for r in s_pre if r["hit"] > 0]

    def median(recs, key):
        return float(np.median([r[key] for r in recs])) if recs else None

    prefill = {f"{key}_{arm}": median(recs, key)
               for key in (("device_ms", "wall_ms") if device == "cuda"
                           else ())
               for arm, recs in (("hit", hits), ("no_sharing", n_pre))}
    readings.update(
        stream_kv_bytes_peak=s_stats.kv_bytes_peak,
        stream_dense_reservation=SLOTS * dense.kv_bytes_per_slot(),
        stream_flushed_prefix_pages=flushed,
        stream_prefills_sharing=s_pre, stream_prefills_no_sharing=n_pre,
        stream_prefill_median=prefill,
        stream_ttft_mean_s_sharing=s_run["ttft_mean_s"],
        stream_ttft_mean_s_no_sharing=n_run["ttft_mean_s"],
        stream_ttft_mean_s_dense=d_run["ttft_mean_s"],
        stream_greedy_agreement_with_dense=float(np.mean(
            [np.mean(o.generated == d.generated)
             for o, d in zip(s_outs, d_outs)])),
        stream_no_sharing_identical_to_dense=same(n_outs, d_outs, True))
    not_one_step = [r for r in hits
                    if r["steps"] != [len(stream[0]) - r["hit"]]]
    if len(hits) < 7 or not_one_step:
        raise AssertionError(f"shared-prefix stream: {len(hits)} prefix-hit "
                             f"prefills (want 7); not one step of the "
                             f"suffix: {not_one_step}")
    if device == "cuda" and not (
            0 < prefill["device_ms_hit"] < prefill["device_ms_no_sharing"]):
        raise AssertionError(
            f"shared-prefix stream: the median device time of a prefix "
            f"hit's prefill {prefill['device_ms_hit']} ms is not below that "
            f"of a prefill without sharing "
            f"({prefill['device_ms_no_sharing']} ms), or none was traced")
    log(f"paged: shared-prefix stream: {json.dumps(checks)}; KV bytes at "
        f"peak {readings['stream_kv_bytes_peak']:.0f} against the dense "
        f"reservation {readings['stream_dense_reservation']:.0f}; each hit "
        f"one step of 32 tokens; median prefill (hit / without sharing) "
        f"{json.dumps(prefill)}; mean TTFT {s_run['ttft_mean_s']:.4f} s "
        f"with sharing, {n_run['ttft_mean_s']:.4f} s without (20 pages), "
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
    return launches, speng.params


DEGRADE_PATH = ("qmatmul", "qkv", "qmlp", "decode_attn_paged")
DEGRADE = dict(cooldown=2, headroom=0.3)   # 4i: spill, and promote back
WATCHDOG_S = 1.5        # 4i's watchdog deadline on a decode gap, s
STALL_S = 2.0           # the stall injected into one of its ticks, s


def degrade_pool_pages(prompts, max_new: int = 32) -> int:
    """4i's pool: the worst cases (prompt + 32 new tokens, in pages of
    PAGE) of the two largest of the first four requests, so any two of
    them fit at tier 0 and no three do."""
    need = sorted(-(-(len(p) + max_new) // PAGE) for p in prompts[:4])
    pages = need[-1] + need[-2]
    if sum(need[:3]) <= pages:
        raise AssertionError(f"4i: three of the first four requests fit in "
                             f"{pages} pages ({need})")
    return pages


def field_to(torch, field, device):
    """A paged field (one PagedKV or a tuple of runs) copied to ``device``."""
    runs = field if isinstance(field, tuple) else (field,)
    out = tuple(dataclasses.replace(
        pg, data=pg.data.to(device), table=pg.table.to(device),
        scale=None if pg.scale is None else pg.scale.to(device))
        for pg in runs)
    return out if isinstance(field, tuple) else out[0]


def field_mismatch(torch, got, want):
    """Where two paged fields differ, or None when they are equal to the
    bit: precisions, payloads, scales (through an int16 view) and
    tables."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if [g.precision for g in got] != [w.precision for w in want]:
        return ("precisions", [g.precision for g in got],
                [w.precision for w in want])
    for i, (g, w) in enumerate(zip(got, want)):
        for name in ("data", "scale", "table"):
            a, b = getattr(g, name), getattr(w, name)
            if (a is None) != (b is None):
                return (i, name, "one is None")
            if a is None:
                continue
            a, b = a.cpu(), b.cpu()
            if a.dtype == torch.bfloat16:
                a, b = a.view(torch.int16), b.view(torch.int16)
            if a.shape != b.shape:
                return (i, name, tuple(a.shape), tuple(b.shape))
            bad = (a != b).nonzero()
            if len(bad):
                return (i, g.precision, name, int(len(bad)), a.numel(),
                        bad[:4].tolist(),
                        a[tuple(bad[0])].item(), b[tuple(bad[0])].item())
    return None


def field_nbytes(field) -> int:
    return sum(t.numel() * t.element_size()
               for pg in (field if isinstance(field, tuple) else (field,))
               for t in (pg.data, pg.scale, pg.table) if t is not None)


def serve_degrade(torch, build, report: dict, model, compiled, plan,
                  prompts, base_outs, device: str) -> dict:
    """Phase 4i: graceful degradation and fault tolerance on llama3.2-3b
    FULL, over phase 4's compiled EWQ weights (``compiled``, the params of
    phase 4c's last engine; no second analysis, no second compile) with
    int8 KV and phase 4's 8 requests (4 slots, chunk 8, 32 new tokens).

    * The entropy-ordered ladder (``ServeEngine.degrade_ladder``: tier
      precisions, labels, pages a tier at the pool's byte budget).
    * A pool of ``degrade_pool_pages`` pages of PAGE (any two of the first
      four requests fit at tier 0, no three) under DegradeConfig(DEGRADE):
      served from CUDA graphs and eagerly, equal to the bit in tokens,
      logprobs and transitions; at least two transitions (a spill and a
      promotion), decode steps at tier 0 and below it, every request
      complete, no page leaked; DEGRADE_PATH's kernels launched, and the
      paged attention kernel during degraded steps. Each transition's wall
      ms, the memory it holds at its peak beyond what was allocated before
      it, and the allocated and reserved bytes before the first transition
      and after the last (which must not hold a dead pool's bytes more).
    * The repack held to its plain run: a live pool (two requests admitted,
      a chunk decoded) spilled one tier and promoted back with
      ``apply_kv_plan``, each repacked field equal to the bit to
      ``repack_pool_field`` on a CPU copy of the pool before it; the
      repack's device ms (CUDA events, the fields repacked from a copy)
      and transient bytes beside the pool's bytes.
    * Failover: two replica engines over the same compiled weights (two
      pools, 2 slots each) under ReplicaServe, fault-free and with replica
      1 killed at its third dispatch (``replica_fault``): the same greedy
      tokens, one restart, requests re-driven, both pools clean; the
      recovery p95 and the largest logprob difference (readings). The
      kill runs with a metrics registry installed (phase 4j (c)): one
      restart counted, the chaos faults counted as the injector logged
      them, one recovery sample, the aggregate's registry labelled by
      replica.
    * The watchdog: replica 0 stalls STALL_S in one tick under a
      WATCHDOG_S deadline: at least one trip, the same tokens.

    Artifact chaos (``artifact.read`` / ``artifact.corrupt``) is held on
    the CPU only (tests/test_torch_chaos.py): re-reading phase 4g's
    4.85 GB artifact would cost about 12 s. Returns the launches."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.quant import paged as PG
    from repro_torch.quant.compiler import kv_tier_labels
    from repro_torch.serving import chaos
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.pool import PagedConfig
    from repro_torch.serving.replica import FailoverConfig, ReplicaServe
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.session import DegradeConfig, ServeSession
    cfg = model.cfg
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    launches = {k: 0 for k in build.LAUNCHES}
    out = {}

    def engine(graphs: bool = True, pages=None):
        # no prefix sharing: the prompts share no prefix, and a finished
        # request's cached prompt pages would hold the pool's headroom down
        eng = ServeEngine(model, compiled, max_seq=1024, kv_precision="int8",
                          device=device, cuda_graphs=graphs,
                          paged=PagedConfig(page_size=PAGE, pool_pages=pages,
                                            prefix_sharing=False))
        eng.plan = plan     # the ladder's order: phase 4's EWQ decisions
        return eng

    def requests():
        return [Request(rid=i, prompt=p, max_new_tokens=32)
                for i, p in enumerate(prompts)]

    def check(label, outs):
        if len(outs) != len(prompts):
            raise AssertionError(f"4i {label}: {len(outs)} of "
                                 f"{len(prompts)} requests completed")
        for o in outs:
            if (len(o.generated) != 32 or o.generated.min() < 0
                    or o.generated.max() >= cfg.vocab_size
                    or not np.all(np.isfinite(o.logprobs))):
                raise AssertionError(f"4i {label}: bad output for request "
                                     f"{o.rid}: {o.generated}")

    def clean(label, eng):
        pool = eng.pool
        pool.check_invariants()
        cached = pool.prefix.evictable(pool._ref) if pool.prefix else 0
        if pool.pages_in_use != cached:
            raise AssertionError(f"4i {label}: {pool.pages_in_use} pages "
                                 f"held after the serve, {cached} cached")

    def memory():
        return ((torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
                if cuda else (None, None))

    # -- the ladder -----------------------------------------------------------
    pool_pages = degrade_pool_pages(prompts)
    eng = engine(pages=pool_pages)
    ladder = eng.degrade_ladder()
    labels = kv_tier_labels(ladder)
    budget = pool_pages * eng.pool_layout(ladder[0], SLOTS)[2]
    tiers = [dict(tier=i, label=labels[i],
                  precisions="".join("8" if p == "int8" else "4"
                                     if p == "int4" else "b"
                                     for p in kv.precisions),
                  pages=int(budget // eng.pool_layout(kv, SLOTS)[2]))
             for i, kv in enumerate(ladder)]
    eng = None
    log(f"degrade: the EWQ ladder at a {pool_pages}-page pool "
        f"({budget:.0f} B): " + json.dumps(tiers))
    out.update(pool_pages=pool_pages, pool_bytes=budget, ladder=tiers)
    if len(ladder) < 2:
        raise AssertionError("4i: the ladder has no tier below tier 0")
    keys = [kv.precisions for kv in ladder]

    # -- degraded serves: graphs, then eagerly --------------------------------
    serves = []
    for graphs in (True, False):
        fresh_memory(torch, device)
        eng = engine(graphs, pool_pages)
        moves, tier_attn = [], [0] * len(ladder)
        apply, chunk = eng.apply_kv_plan, eng.decode_chunk

        def timed_apply(state, kv, eng=eng, apply=apply, moves=moves):
            sync()
            alloc, reserved = memory()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            new = apply(state, kv)
            sync()
            wall = time.perf_counter() - t0
            alloc_after, reserved_after = memory()
            moves.append(dict(
                to=keys.index(kv.precisions), done=new is not None,
                wall_ms=wall * 1e3, pages=eng.pool.num_pages,
                allocated_before=alloc, allocated_after=alloc_after,
                reserved_before=reserved, reserved_after=reserved_after,
                transient_bytes=(torch.cuda.max_memory_allocated() - alloc
                                 if cuda else None)))
            return new

        def counted(state, steps=CHUNK, plain=False, eng=eng, chunk=chunk,
                    tier_attn=tier_attn):
            before = build.LAUNCHES["decode_attn_paged"]
            res = chunk(state, steps, plain)
            tier_attn[keys.index(eng.kv_plan.precisions)] += (
                build.LAUNCHES["decode_attn_paged"] - before)
            return res

        eng.apply_kv_plan, eng.decode_chunk = timed_apply, counted
        build.reset_launches()                 # main path: counts from 0
        t0 = time.perf_counter()
        sess = ServeSession(eng, requests(), num_slots=SLOTS, chunk=CHUNK,
                            degrade=DegradeConfig(**DEGRADE))
        t_init = time.perf_counter() - t0
        while not sess.done:
            sess.dispatch()
            sess.harvest()
        t_loop = time.perf_counter() - t0
        outs, stats = sess.finalize()
        wall = time.perf_counter() - t0
        counts = dict(build.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        label = "graphs" if graphs else "eager"
        check(f"degraded serve ({label})", outs)
        clean(f"degraded serve ({label})", eng)
        done = [m for m in moves if m["done"]]
        run = dict(cuda_graphs=graphs, wall_s=wall, session_init_s=t_init,
                   loop_s=t_loop,
                   serve_wall_s=stats.wall_s,
                   tokens_per_s=stats.tokens_per_s,
                   transitions=sess.transitions,
                   degrade_transitions=stats.degrade_transitions,
                   kv_tier_steps=list(stats.kv_tier_steps),
                   degraded_steps=stats.degraded_steps,
                   requeues=stats.requeues,
                   pool_pages_peak=stats.pool_pages_peak,
                   num_chunks=stats.num_chunks,
                   ttft_mean_s=stats.ttft_mean_s,
                   decode_gap_p50_s=stats.decode_gap_p50_s,
                   decode_gap_max_s=stats.decode_gap_max_s,
                   attn_paged_launches_by_tier=tier_attn,
                   transition_readings=moves, launches=counts)
        if cuda and done:
            run.update(
                allocated_before_first=done[0]["allocated_before"],
                allocated_after_last=done[-1]["allocated_after"],
                reserved_before_first=done[0]["reserved_before"],
                reserved_after_last=done[-1]["reserved_after"])
        log(f"degrade: serve ({label}): " + json.dumps(run))
        serves.append((outs, sess.transitions, stats, run))
        eng = sess = None
    (g_outs, g_moves, g_stats, g_run), (e_outs, e_moves, _, _) = serves
    require_same("4i degraded serve", g_outs, e_outs, logprobs=True)
    failed = [k for k, ok in {
        "the graph and eager serves make the same transitions":
            g_moves == e_moves,
        "degrade_transitions >= 2": g_stats.degrade_transitions >= 2,
        "decode steps below tier 0": sum(g_stats.kv_tier_steps[1:]) > 0,
        "decode steps at tier 0": g_stats.kv_tier_steps[0] > 0,
        "decode_attn_paged launched at a degraded tier":
            not cuda or sum(g_run["attn_paged_launches_by_tier"][1:]) > 0,
        "allocated bytes after the last transition within one pool of "
        "those before the first (no dead pool or workspace held)":
            not cuda or (g_run["allocated_after_last"]
                         - g_run["allocated_before_first"] < budget),
    }.items() if not ok]
    if failed:
        raise AssertionError(f"4i degraded serve: {failed}")
    missing = [k for k in DEGRADE_PATH if g_run["launches"][k] <= 0]
    if missing and cuda:
        raise AssertionError(f"4i: kernels {missing} never launched in the "
                             "degraded serve")
    share = float(np.mean([np.mean(o.generated == b.generated)
                           for o, b in zip(g_outs, base_outs)]))
    log(f"degrade: graph serve equal to the eager serve to the bit, "
        f"transitions {g_moves}; share of tokens equal to phase 4's "
        f"undegraded serve {share:.4f} (a reading)")
    out.update(serves=[s[3] for s in serves], token_share_vs_undegraded=share)

    # -- the repack on the card held to its plain run on the CPU -------------
    eng = engine(True, pool_pages)
    state = eng.init_decode_state(SLOTS)
    for slot in range(2):
        eng.insert(state, slot, eng.prefill_request(prompts[slot]), 32)
    eng.decode_chunk(state, CHUNK)
    repacks = []
    for tier in (1, 0):                        # a spill, then a promotion
        pool = eng.pool
        before = {s: list(p) for s, p in pool._slot_pages.items()}
        n_old = pool.num_pages
        cpu_fields = {n: field_to(torch, getattr(state.cache, n), "cpu")
                      for n in eng._paged_fields}
        old_bytes = sum(field_nbytes(getattr(state.cache, n))
                        for n in eng._paged_fields)
        runs, raw_dtypes, _ = eng.pool_layout(ladder[tier], SLOTS)
        sync()
        alloc, _ = memory()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        state = eng.apply_kv_plan(state, ladder[tier])
        sync()
        if state is None:
            raise AssertionError(f"4i repack: the transition to tier {tier} "
                                 "was refused")
        transient = (torch.cuda.max_memory_allocated() - alloc
                     if cuda else None)
        n_new = eng.pool.num_pages
        perm = np.zeros(n_old + 1, np.int32)
        for s, pages in before.items():
            perm[pages] = eng.pool._slot_pages[s]
        inv = np.zeros(n_new + 1, np.int32)
        live = np.nonzero(perm)[0]
        inv[perm[live]] = live
        group = ladder[tier].group
        rec = dict(tier=tier, pages_before=n_old, pages_after=n_new,
                   live_pages=int(live.size), pool_bytes_before=old_bytes,
                   pool_bytes_after=sum(field_nbytes(getattr(state.cache, n))
                                        for n in eng._paged_fields),
                   transient_bytes=transient, equal_to_cpu_run=True)
        device_ms = []
        for name in eng._paged_fields:
            want = PG.repack_pool_field(cpu_fields[name], runs[name],
                                        perm=perm, inv=inv, group=group,
                                        raw_dtype=raw_dtypes[name])
            bad = field_mismatch(torch, getattr(state.cache, name), want)
            if bad is not None:
                raise AssertionError(f"4i repack to tier {tier}: field "
                                     f"{name} differs from its CPU run: "
                                     f"{bad}")
            if cuda:                           # the repack alone, timed
                src = field_to(torch, cpu_fields[name], device)
                times = []
                for _ in range(3):
                    s_ev = torch.cuda.Event(enable_timing=True)
                    e_ev = torch.cuda.Event(enable_timing=True)
                    s_ev.record()
                    again = PG.repack_pool_field(
                        src, runs[name], perm=perm, inv=inv, group=group,
                        raw_dtype=raw_dtypes[name])
                    e_ev.record()
                    e_ev.synchronize()
                    times.append(s_ev.elapsed_time(e_ev))
                bad = field_mismatch(torch, again, want)
                if bad is not None:
                    raise AssertionError(f"4i repack to tier {tier}: field "
                                         f"{name} from a copy differs: "
                                         f"{bad}")
                device_ms.append(sorted(times)[1])
                src = again = None
        rec["device_ms"] = sum(device_ms) if cuda else None
        log(f"degrade: repack to tier {tier} equal to its CPU run to the "
            f"bit: " + json.dumps(rec))
        repacks.append(rec)
    out.update(repacks=repacks)
    eng = state = None

    # -- failover and the watchdog ---------------------------------------------
    fresh_memory(torch, device)
    rs = ReplicaServe([engine(), engine()])
    runs = {}
    for label, rules, failover in (
            ("fault-free", (), FailoverConfig()),
            ("replica_fault", chaos.FaultConfig.parse("replica_fault").rules,
             FailoverConfig()),
            ("stall", (chaos.FaultRule(site="device.stall", tag=0, at=(3,),
                                       mode="stall", stall_s=STALL_S),),
             FailoverConfig(watchdog_s=WATCHDOG_S))):
        build.reset_launches()
        # the kill serve is metered (phase 4j (c)); no other serve is
        metrics = obs.MetricsRegistry() if label == "replica_fault" else None
        prev = obs.install(metrics=metrics)
        try:
            with chaos.chaos(chaos.FaultConfig(rules=rules)) as inj:
                outs, st = rs.serve(requests(), num_slots=2, chunk=CHUNK,
                                    failover=failover)
        finally:
            obs.install(*prev)
        if metrics is not None:
            out["metered_failover"] = metered_failover(metrics, inj.log,
                                                       st.aggregate)
        for k, v in build.LAUNCHES.items():
            launches[k] += v
        check(label, outs)
        for i, e in enumerate(rs.engines):
            clean(f"{label} replica {i}", e)
        agg = st.aggregate
        runs[label] = (outs, dict(
            fired=inj.log, assignments=st.assignments,
            replica_restarts=agg.replica_restarts,
            redriven_requests=agg.redriven_requests,
            recovery_p95_s=agg.recovery_p95_s,
            watchdog_trips=agg.watchdog_trips,
            decode_gap_max_s=agg.decode_gap_max_s,
            tokens_per_s=agg.tokens_per_s, wall_s=agg.wall_s))
    base, _ = runs["fault-free"]
    for label in ("replica_fault", "stall"):
        outs, rec = runs[label]
        if not same_outputs(outs, base, logprobs=False):
            raise AssertionError(f"4i {label}: greedy tokens differ from the "
                                 "fault-free replica serve")
        rec["logprob_max_abs_diff"] = float(max(
            np.abs(o.logprobs - b.logprobs).max()
            for o, b in zip(outs, base)))
    kill, stall = runs["replica_fault"][1], runs["stall"][1]
    if kill["replica_restarts"] != 1 or kill["redriven_requests"] <= 0:
        raise AssertionError(f"4i replica_fault: {kill}")
    if stall["watchdog_trips"] < 1:
        raise AssertionError(f"4i stall: no watchdog trip ({stall})")
    for label, (_, rec) in runs.items():
        log(f"degrade: replicas ({label}): " + json.dumps(rec))
    out.update(replicas={k: v[1] for k, v in runs.items()})
    report["degrade"] = out
    rs = None
    return launches


def metered_failover(metrics, fired: list, agg) -> dict:
    """Phase 4j (c): the registry installed over 4i's replica-kill serve
    holds one restart, a chaos fault for each firing the injector logged
    and one recovery sample; the aggregate's merged registry carries both
    replicas' labels and the same failover."""
    rec = metrics.get("serve_recovery_seconds")
    merged = agg.registry
    gen = merged.get("serve_generated_tokens_total")
    got = dict(
        restarts=metrics.total("serve_replica_restarts_total"),
        redriven=metrics.total("serve_redriven_requests_total"),
        chaos_faults=metrics.total("serve_chaos_faults_total"),
        fired=len(fired),
        recovery_samples=rec.count() if rec is not None else 0,
        recovery_s=rec.samples() if rec is not None else [],
        aggregate_replica_labels=sorted(gen.labeled("replica")
                                        if gen is not None else ()),
        aggregate_restarts=merged.total("serve_replica_restarts_total"))
    failed = [k for k, ok in {
        "serve_replica_restarts_total == 1": got["restarts"] == 1,
        "serve_redriven_requests_total == the aggregate's re-drives":
            got["redriven"] == agg.redriven_requests > 0,
        "serve_chaos_faults_total == the injector's log":
            got["chaos_faults"] == got["fired"] > 0,
        "one serve_recovery_seconds sample": got["recovery_samples"] == 1,
        "the aggregate's registry labels replicas 0 and 1":
            got["aggregate_replica_labels"] == ["0", "1"],
        "the aggregate's registry holds the restart":
            got["aggregate_restarts"] == 1,
    }.items() if not ok]
    log("observe: 4i's replica-kill serve, metered: " + json.dumps(got))
    if failed:
        raise AssertionError(f"4j (c) metered failover: {failed} ({got})")
    return got


OBS_PATH = ("qmatmul", "qkv", "qmlp", "decode_attn")
# the __global__ names (csrc/) of the port's kernels on the serve path, by
# the kernels line's names; qmatmul and qkv are one kernel (qmma_kernel)
OBS_KERNELS = {"qmatmul + qkv": ("qmma_kernel",),
               "qmlp": ("qmlp_kernel", "qmlp_sum_kernel"),
               "decode_attn": ("decode_attn_split", "decode_attn_merge")}
OBS_REQUIRED = ("qmma_kernel", "qmlp_kernel", "decode_attn_split")
TRACE_BUDGET = 0.02     # the reference benchmark's tracing overhead budget
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_breakdown(path: str) -> dict:
    """The device events of a torch.profiler Chrome trace: the ms of each
    port kernel group (OBS_KERNELS) and of everything else on the device
    (other kernels, copies, sets), each one's share of the window's device
    ms, and the count of each ``__global__`` name seen."""
    events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    groups = {g: 0.0 for g in OBS_KERNELS}
    names = {n: 0 for ns in OBS_KERNELS.values() for n in ns}
    other, other_kernels, total, n_device = 0.0, {}, 0.0, 0
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS:
            continue
        ms = float(ev.get("dur", 0.0)) / 1e3
        n_device += 1
        total += ms
        for g, ns in OBS_KERNELS.items():
            hit = next((n for n in ns if n in ev["name"]), None)
            if hit is not None and ev["cat"] == "kernel":
                groups[g] += ms
                names[hit] += 1
                break
        else:
            other += ms
            key = ev["name"][:80]
            other_kernels[key] = other_kernels.get(key, 0.0) + ms
    top = sorted(other_kernels.items(), key=lambda kv: -kv[1])[:6]
    return dict(device_events=n_device, device_ms=total,
                kernel_ms=groups, other_ms=other,
                share={**{g: (v / total if total else 0.0)
                          for g, v in groups.items()},
                       "other": other / total if total else 0.0},
                kernel_events=names, other_top=dict(top))


def serve_observed(torch, build, report: dict, model, compiled, plan,
                   prompts, base_outs, device: str) -> dict:
    """Phase 4j: phase 4's 8 requests (4 slots, chunk 8, 32 new tokens) on
    phase 4c's compiled EWQ weights with int8 KV, from CUDA graphs:
    untraced, then (a) traced and metered, then (b) also with device fences
    and a torch.profiler window over two decode chunks past the chunk that
    captures. Returns
    the launches. (c) is 4i's replica-kill serve (``metered_failover``)."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch import obs
    from repro_torch.serving.engine import ServeEngine, ServeStats
    from repro_torch.serving.scheduler import Request
    cuda = device == "cuda"
    launches = {k: 0 for k in build.LAUNCHES}
    out = {}
    fresh_memory(torch, device)
    eng = ServeEngine(model, compiled, max_seq=1024, kv_precision="int8",
                      device=device)
    eng.plan = plan

    def serve(tracer, metrics, profile):
        build.reset_launches()                 # main path: counts from 0
        prev = obs.install(tracer, metrics, profile)
        try:
            res = eng.serve([Request(rid=i, prompt=p, max_new_tokens=32)
                             for i, p in enumerate(prompts)],
                            num_slots=SLOTS, chunk=CHUNK)
        finally:
            if profile is not None:
                profile.stop()
            obs.install(*prev)
        counts = dict(build.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        return res, counts

    phase4 = report["runs"][0]                 # phase 4's EWQ graph serve
    # the same engine untraced first: tracing's cost read within the phase
    (_, plain_stats), _ = serve(None, None, None)
    # -- (a) traced and metered -------------------------------------------------
    tr, mx = obs.Tracer(), obs.MetricsRegistry()
    (outs, stats), counts = serve(tr, mx, None)
    if not same_outputs(outs, base_outs, logprobs=True):
        raise AssertionError("4j (a): the traced serve's tokens or logprobs "
                             "differ from phase 4's serve")
    phases = {}
    for ev in tr.events:
        if ev["tid"] >= obs.REQ_TRACK_BASE:
            phases.setdefault(ev["tid"] - obs.REQ_TRACK_BASE, []).append(
                (ev["name"], ev["ph"]))
    walk = [("request/queued", "B"), ("request/queued", "E"),
            ("request/prefill", "B"), ("request/prefill", "E"),
            ("request/decode", "B"), ("request/decode", "E"),
            ("request/finish", "i")]
    tc = tr.counts()
    generated = sum(len(o.generated) for o in outs)
    failed = [k for k, ok in {
        "no open span": tr.open_spans() == [],
        "every request queued -> prefill -> decode -> finish":
            sorted(phases) == list(range(len(prompts)))
            and all(v == walk for v in phases.values()),
        "serve_generated_tokens_total == the tokens generated":
            mx.total("serve_generated_tokens_total") == generated
            == stats.generated_tokens,
        "ServeStats.from_registry(stats.registry) == stats":
            ServeStats.from_registry(stats.registry) == stats,
        "one decode/chunk span a chunk":
            tc.get(("decode/chunk", "X"), 0) == stats.num_chunks > 0,
        "OBS_PATH's kernels launched":
            not cuda or all(counts[k] > 0 for k in OBS_PATH),
    }.items() if not ok]
    if failed:
        raise AssertionError(f"4j (a) traced serve: {failed}")
    traced = dict(tokens_per_s=stats.tokens_per_s, wall_s=stats.wall_s,
                  untraced_tokens_per_s=plain_stats.tokens_per_s,
                  ratio_to_untraced=stats.tokens_per_s
                  / plain_stats.tokens_per_s,
                  phase4_tokens_per_s=phase4["tokens_per_s"],
                  ratio_to_phase4=stats.tokens_per_s
                  / phase4["tokens_per_s"],
                  trace_budget=TRACE_BUDGET, events=len(tr.events),
                  counts={f"{n}/{ph}": v for (n, ph), v in
                          sorted(tc.items()) if ph != "M"},
                  metric_families=len(mx.names()), launches=counts)
    log("observe: (a) traced + metered serve, tokens and logprobs equal to "
        "phase 4's to the bit, no open span: " + json.dumps(traced))
    log(f"observe: traced tokens/s {stats.tokens_per_s:.1f} beside the same "
        f"engine's untraced serve just before {plain_stats.tokens_per_s:.1f} "
        f"and phase 4's {phase4['tokens_per_s']:.1f} (readings; the "
        f"reference's benchmark budgets tracing at under "
        f"{TRACE_BUDGET:.0%})")
    out["traced"] = traced

    # -- (b) profiled: device fences and one torch.profiler window -------------
    trace_dir = tempfile.mkdtemp(prefix="repro_torch-profile-")
    try:
        prof = obs.ProfileHooks(steps=(CHUNK, 3 * CHUNK),
                                trace_dir=trace_dir, device_fences=True)
        tr2, mx2 = obs.Tracer(), obs.MetricsRegistry()
        (outs2, stats2), counts2 = serve(tr2, mx2, prof)
        if not same_outputs(outs2, outs, logprobs=True):
            raise AssertionError("4j (b): the profiled serve's tokens or "
                                 "logprobs differ from the traced serve's")
        chunks = [e for e in tr2.events if e["name"] == "decode/chunk"]
        dev = [e["args"].get("device_ms") for e in chunks]
        host = [e["args"].get("host_gap_ms") for e in chunks]
        gaps = [e["dur"] / 1e3 for e in chunks]
        breakdown = (profile_breakdown(prof.trace_files[0])
                     if prof.trace_files else None)
        failed = [k for k, ok in {
            "no open span": tr2.open_spans() == [],
            "one device_ms and host_gap_ms a decode chunk":
                len(chunks) == stats2.num_chunks > 0
                and None not in dev and None not in host
                and mx2.get("serve_device_time_seconds").count()
                == mx2.get("serve_host_gap_seconds").count()
                == stats2.num_chunks,
            "0 < device_ms <= the chunk's gap":
                None not in dev and all(
                    0 < d <= g + 1e-3 for d, g in zip(dev, gaps)),
            "one profiler window": prof.windows == 1,
            "the window's trace file exists":
                len(prof.trace_files) == 1
                and pathlib.Path(prof.trace_files[0]).is_file(),
            "the window recorded device work":
                not cuda or (breakdown is not None
                             and breakdown["device_events"] > 0),
            "the window's trace names the port's kernels":
                not cuda or (breakdown is not None and all(
                    breakdown["kernel_events"][n] > 0
                    for n in OBS_REQUIRED)),
        }.items() if not ok]
        if failed:
            raise AssertionError(f"4j (b) profiled serve: {failed}; "
                                 f"device_ms {dev}, gaps {gaps}, "
                                 f"breakdown {breakdown}")
        phase4_chunk = phase4.get("chunk", {}).get("device_ms")
        profiled = dict(
            window=[CHUNK, 3 * CHUNK], windows=prof.windows,
            trace_bytes=pathlib.Path(prof.trace_files[0]).stat().st_size,
            chunk_device_ms=dev, chunk_host_gap_ms=host, chunk_gap_ms=gaps,
            chunk_device_ms_median=float(np.median(dev)),
            chunk_host_gap_ms_median=float(np.median(host)),
            window_start_s=prof.start_s, window_stop_export_s=prof.stop_s,
            phase4_replayed_chunk_device_ms=phase4_chunk,
            tokens_per_s=stats2.tokens_per_s, launches=counts2,
            breakdown=breakdown)
        log("observe: (b) profiled serve (fences + one window), tokens and "
            "logprobs equal to (a): " + json.dumps(profiled))
        if breakdown is not None:
            parts = ", ".join(
                f"{g} {breakdown['kernel_ms'][g]:.3f} ms "
                f"({breakdown['share'][g]:.1%})" for g in OBS_KERNELS)
            log(f"observe: device time inside the window "
                f"({breakdown['device_ms']:.3f} ms): {parts}, everything "
                f"else {breakdown['other_ms']:.3f} ms "
                f"({breakdown['share']['other']:.1%})")
        log(f"observe: chunk device ms median "
            f"{profiled['chunk_device_ms_median']:.3f} (host gap median "
            f"{profiled['chunk_host_gap_ms_median']:.3f}) beside phase 4's "
            f"replayed chunk {phase4_chunk} ms")
        out["profiled"] = profiled
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    report["observe"] = out
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
# phase 4g: plan artifacts and the serve session (chunked prefill, SLO)
# ---------------------------------------------------------------------------

# the kernels every llama serve of phase 4g must launch (decode attention
# over the pool in its paged serve)
SESSION_PATH = ("qmatmul", "qkv", "qmlp", "decode_attn")
SESSION_PAGED_PATH = ("qmatmul", "qkv", "qmlp", "decode_attn_paged")
PREFILL_CHUNK = 64      # prompt tokens per chunk of 4g's chunked serve
LONG_PROMPT = 768       # the prompt that arrives while others decode


def _counted(build, launches: dict, label: str, fn, device: str,
             path=SESSION_PATH):
    """``fn()`` with every launch count set to 0 just before it and read
    just after, added to ``launches``; on the card each kernel of ``path``
    must have launched."""
    build.reset_launches()
    out = fn()
    counts = dict(build.LAUNCHES)
    for k, v in counts.items():
        launches[k] += v
    missing = [k for k in path if counts[k] <= 0]
    if missing and device == "cuda":
        raise AssertionError(f"{label}: kernels {missing} never launched")
    return out


def same_leaves(torch, got, want) -> int:
    """Two parameter trees with the same leaf keys, every leaf (a QTensor's
    payload and scales) equal to the bit with its dtype; returns the count
    of leaves."""
    from repro_torch.checkpoint.ckpt import flatten_with_paths
    from repro_torch.quant.qtypes import QTensor
    g, w = dict(flatten_with_paths(got)), dict(flatten_with_paths(want))
    if g.keys() != w.keys():
        raise AssertionError(f"artifact leaf keys differ: "
                             f"{sorted(set(g) ^ set(w))[:8]}")
    for key, b in w.items():
        a = g[key]
        pairs = ([(a.data, b.data), (a.scale, b.scale)]
                 if isinstance(b, QTensor) else [(a, b)])
        if isinstance(b, QTensor) and (a.precision, tuple(a.shape)) != (
                b.precision, tuple(b.shape)):
            raise AssertionError(f"artifact leaf {key}: {a.precision} "
                                 f"{a.shape} against {b.precision} {b.shape}")
        for x, y in pairs:
            if x.dtype != y.dtype or x.device != y.device \
                    or not torch.equal(x, y):
                raise AssertionError(f"artifact leaf {key} differs from "
                                     "the in-memory engine's")
    return len(w)


def chunked_prefill_readings(torch, engine, prompt, chunk: int) -> dict:
    """One prompt prefilled in ``chunk``-token chunks (``begin_prefill`` +
    ``advance_prefill``: each chunk one multi-query step over the cache so
    far) against the whole-prompt prefill (``prefill_request``: the full
    forward): relative L2 of the last logits and of the K/V rows [0, P) of
    every layer. The same two readings for a planted fault: each chunk
    run on a fresh cache, so its positions restart at 0."""
    toks = engine._tokens(prompt[None])
    p = int(prompt.size)
    whole = engine.prefill_request(prompt)
    task = engine.begin_prefill(prompt)
    chunks = 0
    while not task.done:
        engine.advance_prefill(task, chunk)
        chunks += 1

    def kv(k, v):
        return torch.cat([k[:, :, :p].float().flatten(),
                          v[:, :, :p].float().flatten()])

    want_kv = kv(whole.cache.k, whole.cache.v)
    ks, vs = [], []
    for lo in range(0, p, chunk):
        hi = min(p, lo + chunk)
        fresh = engine.model.init_cache(1, engine.max_seq, engine.device)
        cache, fault_logits = engine._prefill_step(toks[:, lo:hi], fresh)
        ks.append(cache.k[:, :, :hi - lo])
        vs.append(cache.v[:, :, :hi - lo])
    fault_kv = kv(torch.cat(ks, dim=2), torch.cat(vs, dim=2))
    return dict(tokens=p, chunk=chunk, chunks=chunks,
                logits_rel_l2=rel_l2(task.last_logits, whole.last_logits),
                kv_rel_l2=rel_l2(kv(task.cache.k, task.cache.v), want_kv),
                fault_logits_rel_l2=rel_l2(fault_logits, whole.last_logits),
                fault_kv_rel_l2=rel_l2(fault_kv, want_kv))


def slo_stream(prompts) -> tuple:
    """Phase 4g's SLO stream on the decode-step clock (4 slots, chunks of
    CHUNK = 8 steps, 32 new tokens unless said): rids 0-3 (priority 1)
    take the slots at step 0; rid 0 is cancelled at step 16 (partial
    tokens kept), rid 1 hits its 24-step deadline while decoding; rid 6
    (priority 1, queued behind them) times out at step 8; rids 4 and 5
    (priority 0, 16 new tokens) arrive at step 8: rid 4 preempts the most
    recently admitted lowest-priority slot (rid 3, which requeues and
    prefills again), rid 5 takes rid 0's slot at step 16; rid 7 waits its
    turn. Returns (requests, the finish reasons, the counts)."""
    from repro_torch.serving.scheduler import Request
    kw = [dict(cancel_at_step=16), dict(deadline_steps=24), {}, {},
          dict(priority=0, arrival_step=8, max_new_tokens=16),
          dict(priority=0, arrival_step=8, max_new_tokens=16),
          dict(queue_timeout_steps=8), {}]
    reqs = [Request(rid=i, prompt=prompts[i], **{"max_new_tokens": 32,
                                                "priority": 1, **k})
            for i, k in enumerate(kw)]
    reasons = {0: "cancelled", 1: "deadline", 2: "length", 3: "length",
               4: "length", 5: "length", 6: "timeout", 7: "length"}
    counts = dict(preemptions=1, timeouts=1, cancelled=1)
    return reqs, reasons, counts


def serve_artifact_session(torch, build, report: dict, model, params, plan,
                           prompts, base_outs, draft_stamp, analysis_s: float,
                           d: str, device: str) -> dict:
    """Phase 4g (see the module docstring): the artifact round trip (the
    artifact written into the empty directory ``d``, which phase 4n boots
    again and the caller removes), the chunked-prefill serve and its
    readings, the decode gap while a long prompt arrives, and the SLO
    stream. Returns the launches of its serves (each serve's counts set to
    0 just before it)."""
    import shutil

    import numpy as np
    from repro_torch.quant.compiler import compile_plan, save_artifact
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.pool import PagedConfig
    from repro_torch.serving.scheduler import Request, SLOConfig
    from repro_torch.serving.session import ServeSession
    from repro_torch.serving.spec import SpecConfig
    cfg = model.cfg
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    launches = {k: 0 for k in build.LAUNCHES}
    out: dict = {}

    def requests(max_new: int = 32):
        return [Request(rid=i, prompt=p, max_new_tokens=max_new)
                for i, p in enumerate(prompts)]

    # -- the artifact ---------------------------------------------------------
    fresh_memory(torch, device)
    t0 = time.perf_counter()
    compiled = compile_plan(model, params, plan, kv_precision="int8")
    sync()
    compile_s = time.perf_counter() - t0
    compiled.draft = draft_stamp
    mem = ServeEngine(model, compiled.params, max_seq=1024,
                      kv_precision=compiled.kv_plan, device=device)
    mem.plan = plan
    need = 2 * mem.weight_bytes()
    free = shutil.disk_usage(d).free
    if free < need:
        raise RuntimeError(
            f"artifact: {free} bytes free under {d}, under twice the "
            f"plan's weight bytes ({need:.0f}); the artifact cannot be "
            "written")
    t0 = time.perf_counter()
    save_artifact(d, compiled)
    save_s = time.perf_counter() - t0
    disk = sum(f.stat().st_size for f in pathlib.Path(d).rglob("*")
               if f.is_file())
    fresh_memory(torch, device)
    t0 = time.perf_counter()
    art = ServeEngine.from_artifact(model, d, max_seq=1024, device=device,
                                    spec=SpecConfig(k=SPEC_K))
    sync()
    boot_s = time.perf_counter() - t0
    if art.plan.to_json() != plan.to_json():
        raise AssertionError("artifact: the booted plan differs")
    if art.kv_plan != mem.kv_plan:
        raise AssertionError(f"artifact: KV plan {art.kv_plan} against "
                             f"{mem.kv_plan}")
    if art.weight_bytes() != mem.weight_bytes():
        raise AssertionError(f"artifact: weight bytes "
                             f"{art.weight_bytes()} against "
                             f"{mem.weight_bytes()}")
    leaves = same_leaves(torch, art.params, mem.params)
    draft = art._ensure_draft()
    if (list(draft.precisions) != draft_stamp["precisions"]
            or float(draft.overhead_bytes) != draft_stamp["overhead_bytes"]):
        raise AssertionError(
            f"artifact: re-derived draft {list(draft.precisions)} "
            f"{draft.overhead_bytes} against the stamp {draft_stamp}")
    draft = mem = None
    booted = ServeEngine(model, art.params, max_seq=1024,
                         kv_precision=art.kv_plan, device=device)
    art = None
    outs, stats = _counted(
        build, launches, "artifact serve",
        lambda: booted.serve(requests(), num_slots=SLOTS, chunk=CHUNK),
        device)
    if not same_outputs(outs, base_outs, logprobs=True):
        raise AssertionError("artifact: the cold-booted leaves' tokens or "
                             "logprobs differ from phase 4's EWQ serve")
    weight_bytes = booted.weight_bytes()
    booted = None
    out["artifact"] = dict(
        bytes_on_disk=disk, weight_bytes=weight_bytes, leaves=leaves,
        save_s=save_s, cold_boot_s=boot_s,
        analysis_s=analysis_s, compile_s=compile_s,
        no_artifact_s=analysis_s + compile_s,
        serve_tokens_per_s=stats.tokens_per_s,
        serve_ttft_mean_s=stats.ttft_mean_s,
        identical_to_phase_4=True, draft_equal_to_stamp=True)
    log("artifact: " + json.dumps(out["artifact"]))

    # -- chunked prefill ----------------------------------------------------------
    runs = {}
    for graphs in (True, False):
        eng = None
        fresh_memory(torch, device)
        eng = ServeEngine(model, compiled.params, max_seq=1024,
                          kv_precision=compiled.kv_plan, device=device,
                          cuda_graphs=graphs, prefill_chunk=PREFILL_CHUNK)
        outs, stats = _counted(
            build, launches, "chunked serve",
            lambda: eng.serve(requests(), num_slots=SLOTS, chunk=CHUNK),
            device)
        want = sum(-(-int(p.size) // PREFILL_CHUNK) for p in prompts)
        if stats.prefill_chunks != want:
            raise AssertionError(f"chunked serve: {stats.prefill_chunks} "
                                 f"prefill chunks, not {want}")
        for o in outs:
            if (len(o.generated) != 32 or o.generated.min() < 0
                    or o.generated.max() >= cfg.vocab_size
                    or not np.all(np.isfinite(o.logprobs))):
                raise AssertionError(f"chunked serve: bad output for "
                                     f"request {o.rid}: {o.generated}")
        runs[graphs] = (outs, stats)
    require_same("chunked prefill", runs[True][0], runs[False][0],
                 logprobs=True)
    outs, stats = runs[True]
    share = float(np.mean([np.mean(o.generated == b.generated)
                           for o, b in zip(outs, base_outs)]))
    readings = [chunked_prefill_readings(torch, eng, prompts[i],
                                         PREFILL_CHUNK) for i in (3, 1)]
    for r in readings:
        if r["logits_rel_l2"] > LOGIT_REL_L2 or r["kv_rel_l2"] > LOGIT_REL_L2:
            raise AssertionError(f"chunked prefill against the whole "
                                 f"prompt's: {r} (limit {LOGIT_REL_L2})")
        if max(r["fault_logits_rel_l2"], r["fault_kv_rel_l2"]) \
                <= LOGIT_REL_L2:
            raise AssertionError(f"the limit {LOGIT_REL_L2} misses the "
                                 f"planted fault: {r}")
    eng = None
    out["chunked"] = dict(
        prefill_chunk=PREFILL_CHUNK, prefill_chunks=stats.prefill_chunks,
        tokens_per_s=stats.tokens_per_s, ttft_mean_s=stats.ttft_mean_s,
        ttft_p95_s=stats.ttft_p95_s, tpot_p50_s=stats.tpot_p50_s,
        eager_tokens_per_s=runs[False][1].tokens_per_s,
        eager_ttft_mean_s=runs[False][1].ttft_mean_s,
        identical_to_eager=True, token_share_equal_to_phase_4=share,
        prefill_readings=readings)
    log("chunked prefill: " + json.dumps(out["chunked"]))

    # the decode gap while a long prompt arrives, chunked and whole; the
    # first decoding tick also prefills the three short prompts, so the
    # gaps after it are read apart, beside the long prompt's prefill
    # alone (whole, and chunk by chunk)
    rng = np.random.RandomState(7)
    long_prompt = rng.randint(0, cfg.vocab_size,
                              size=(LONG_PROMPT,)).astype(np.int32)
    gap = {}
    for pc in (128, None):
        eng = None
        fresh_memory(torch, device)
        eng = ServeEngine(model, compiled.params, max_seq=1024,
                          kv_precision=compiled.kv_plan, device=device)
        reqs = [Request(rid=i, prompt=prompts[6 + i % 2], max_new_tokens=64)
                for i in range(3)]
        reqs.append(Request(rid=3, prompt=long_prompt, max_new_tokens=8,
                            arrival_step=16))
        sess = ServeSession(eng, reqs, num_slots=SLOTS, chunk=CHUNK,
                            prefill_chunk=pc)
        _, st = _counted(build, launches, "decode-gap serve", sess.run,
                         device)
        sync()
        t0 = time.perf_counter()
        if pc is None:
            eng.prefill_request(long_prompt)
            sync()
            prefill_s = [time.perf_counter() - t0]
        else:
            task, prefill_s = eng.begin_prefill(long_prompt), []
            while not task.done:
                eng.advance_prefill(task, pc)
                sync()
                prefill_s.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
        gap["chunked_128" if pc else "whole"] = dict(
            decode_gap_max_s=st.decode_gap_max_s,
            decode_gap_p95_s=st.decode_gap_p95_s,
            decode_gap_p50_s=st.decode_gap_p50_s,
            gap_max_after_first_tick_s=max(sess.gaps[1:]),
            prefill_chunks=st.prefill_chunks, ttft_p95_s=st.ttft_p95_s,
            long_prompt_prefill_s=prefill_s)
        sess = task = None
    eng = None
    out["decode_gap"] = gap
    log("decode gap while a 768-token prompt arrives: " + json.dumps(gap))

    # -- SLO scheduling ------------------------------------------------------------
    slo_runs = {}
    for graphs in (True, False):
        eng = None
        fresh_memory(torch, device)
        eng = ServeEngine(model, compiled.params, max_seq=1024,
                          kv_precision=compiled.kv_plan, device=device,
                          cuda_graphs=graphs,
                          paged=PagedConfig(page_size=PAGE))
        reqs, reasons, counts = slo_stream(prompts)
        outs, stats = _counted(
            build, launches, "SLO serve",
            lambda: eng.serve(reqs, num_slots=SLOTS, chunk=CHUNK,
                              slo=SLOConfig(preempt=True)), device,
            SESSION_PAGED_PATH)
        eng.pool.check_invariants()
        got = {o.rid: o.finish_reason for o in outs}
        got_counts = dict(preemptions=stats.preemptions,
                          timeouts=stats.timeouts, cancelled=stats.cancelled)
        if got != reasons or got_counts != counts:
            raise AssertionError(f"SLO stream: reasons {got} counts "
                                 f"{got_counts}, the stream dictates "
                                 f"{reasons} {counts}")
        slo_runs[graphs] = (outs, stats)
    eng = None
    require_same("SLO stream", slo_runs[True][0], slo_runs[False][0],
                 logprobs=True)
    outs, stats = slo_runs[True]
    victim = next(o for o in outs if o.preempted)
    out["slo"] = dict(
        reasons={o.rid: o.finish_reason for o in outs},
        preemptions=stats.preemptions, timeouts=stats.timeouts,
        cancelled=stats.cancelled, identical_to_eager=True,
        no_page_leaked=True, preempted_rid=victim.rid,
        preempted_equal_to_unpreempted=bool(np.array_equal(
            victim.tokens, base_outs[victim.rid].tokens)),
        preempted_token_share=float(np.mean(
            victim.generated == base_outs[victim.rid].generated)),
        queue_delay_p50_s=stats.queue_delay_p50_s,
        queue_delay_p95_s=stats.queue_delay_p95_s,
        ttft_p95_s=stats.ttft_p95_s, tokens_per_s=stats.tokens_per_s)
    log("SLO stream: " + json.dumps(out["slo"]))
    report["session"] = out
    return launches


# ---------------------------------------------------------------------------
# phase 5: the EWQ analysis through the entropy kernel
# ---------------------------------------------------------------------------

# the kernels phase 4n's mesh serves run at a position's shapes, each of
# which must launch in every one of its serves
MESH_PATH = ("qmatmul", "qkv", "qmlp", "decode_attn")
MESH_FORCED_STEPS = 8   # 4n (a)'s teacher-forced decode steps


def forced_logits(torch, engine, prompts, forced) -> list:
    """``engine``'s logits over SLOTS of ``prompts`` prefilled and
    inserted, then ``forced`` (SLOTS, n) tokens stepped one at a time:
    the prefill's last-token logits, then each step's, f32."""
    from repro_torch.serving import batch as B
    state = engine.init_decode_state(SLOTS)
    for slot in range(SLOTS):
        engine.insert(state, slot, engine.prefill_request(prompts[slot]),
                      forced.shape[1] + 1)
    out = [state.last_logits.float().clone()]
    with torch.no_grad():
        for j in range(forced.shape[1]):
            tok = forced[:, j:j + 1]
            if isinstance(state.cache, B.MeshCache):
                logits = B.decode_rows(engine.model, engine._groups,
                                       state.cache, tok)
            else:
                logits, cache = engine.model.decode_step(
                    engine.params, state.cache, tok)
                state.cache.pos.copy_(cache.pos)
            out.append(logits[:, 0].float())
    return out


def first_difference(outs, ref) -> dict | None:
    """The first request and token at which two serves differ, with both
    chosen-token logprobs there; None when the tokens agree."""
    import numpy as np
    for o, r in zip(outs, ref):
        diff = np.nonzero(o.tokens != r.tokens)[0]
        if len(diff):
            j = int(diff[0])
            g = j - (len(o.tokens) - len(o.logprobs))
            return dict(rid=o.rid, position=j, tokens=[int(o.tokens[j]),
                                                       int(r.tokens[j])],
                        logprobs=([float(o.logprobs[g]), float(r.logprobs[g])]
                                  if g >= 0 else None))
    return None


def serve_mesh(torch, build, report: dict, model, params, plan, prompts,
               base_outs, artifact_dir: str, device: str) -> dict:
    """Phase 4n: llama3.2-3b under phase 4's EWQ plan and int8 KV served
    over meshes of the port's own laid on the one card (every position
    cuda:0, each holding its own shards), with CUDA-graph decode chunks.
    (a) a (data=1, model=2) engine: prefill and teacher-forced decode
    logits along the mesh-less engine's token stream held to it under
    LOGIT_REL_L2, the greedy agreement of its serve (a reading: the
    position sums reorder bf16 additions), its weight bytes per position
    against the prediction from the plan's specs, its launches and
    tokens/s; (b) ReplicaServe over (data=2, model=2), 4 slots a replica,
    and the full (2, 2) engine with 4 a data row, on the same requests,
    token-identical (the launcher's --check-dp-parity); (c) phase 4g's artifact cold-booted onto (1, 2):
    the allocation never holds a whole copy besides the shards, and the
    tokens equal (a)'s. Two positions on one card share its bandwidth:
    tokens/s here is not a deployment's. Returns the launches of its
    serves (each serve's counts set to 0 just before it)."""
    import numpy as np
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import mesh_groups
    from repro_torch.quant.compiler import compile_plan, save_artifact
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.replica import ReplicaServe
    from repro_torch.serving.scheduler import Request
    from repro_torch.sharding.specs import (predicted_position_nbytes,
                                            serving_param_specs)
    cfg = model.cfg
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    launches = {k: 0 for k in build.LAUNCHES}
    devs = None if device == "cuda" else [device]
    mesh12 = make_mesh((1, 2), ("data", "model"), devs)
    mesh22 = make_mesh((2, 2), ("data", "model"), devs)
    out: dict = {"positions_on": [str(d) for d in mesh22.device_set]}

    def requests():
        return [Request(rid=i, prompt=p, max_new_tokens=32)
                for i, p in enumerate(prompts)]

    def counted(label, fn):
        before = dict(launches)
        res = _counted(build, launches, label, fn, device, MESH_PATH)
        return res, {k: launches[k] - before[k] for k in MESH_PATH}

    # -- (a) the TP-only engine ------------------------------------------------
    fresh_memory(torch, device)
    # the groups each position holds whole: llama3.2-3b's 128 and 64 (the
    # groups phase 4g's artifact holds), smaller at SMOKE size
    group, kv_group = mesh_groups(cfg, 2)
    compiled = compile_plan(model, params, plan, group, kv_precision="int8",
                            kv_group=kv_group)
    if (group, kv_group) != (128, 64):
        artifact_dir = str(pathlib.Path(artifact_dir) / "mesh")
        save_artifact(artifact_dir, compiled)
    kw = dict(max_seq=1024, kv_precision=compiled.kv_plan, device=device)
    single = ServeEngine(model, compiled.params, **kw)
    whole = single.weight_bytes_per_device()
    predicted = predicted_position_nbytes(
        compiled.params, serving_param_specs(compiled.params, mesh12),
        mesh12) / whole
    log(f"mesh: predicted weight bytes per position at (1, 2), from the "
        f"plan's specs: {predicted:.4f} of the mesh-less engine's {whole:.0f}")
    t0 = time.perf_counter()
    tp = ServeEngine(model, compiled.params, mesh=mesh12, **kw)
    sync()
    place_s = time.perf_counter() - t0
    ratio = tp.weight_bytes_per_device() / whole
    forced = torch.as_tensor(
        np.stack([o.generated[:MESH_FORCED_STEPS] for o in base_outs[:SLOTS]]),
        dtype=torch.long, device=device)
    ref_logits = forced_logits(torch, single, prompts, forced)
    tp_logits = forced_logits(torch, tp, prompts, forced)
    rels = [rel_l2(a, b) for a, b in zip(tp_logits, ref_logits)]
    forced_agree = float(np.mean([float((a.argmax(-1) == b.argmax(-1))
                                        .float().mean())
                                  for a, b in zip(tp_logits, ref_logits)]))
    single = ref_logits = tp_logits = None
    log(f"mesh (1, 2): prefill logits vs the mesh-less engine: relative L2 "
        f"{rels[0]:.4g}; teacher-forced decode steps: max {max(rels[1:]):.4g}"
        f" (limit {LOGIT_REL_L2}); argmax agreement {forced_agree:.3f}")
    if max(rels) > LOGIT_REL_L2:
        raise AssertionError(f"mesh (1, 2): logits differ from the "
                             f"mesh-less engine's: relative L2 {rels}")
    t0 = time.perf_counter()
    (tp_outs, tp_stats), tp_counts = counted(
        "4n (1, 2) serve",
        lambda: tp.serve(requests(), num_slots=SLOTS, chunk=CHUNK))
    tp_s = time.perf_counter() - t0
    check_outputs("mesh (1, 2)", tp_outs, cfg.vocab_size)
    agree = float(np.mean([np.mean(o.generated == r.generated)
                           for o, r in zip(tp_outs, base_outs)]))
    out["tp"] = dict(
        mesh=dict(mesh12.shape), place_s=place_s,
        prefill_logit_rel_l2=rels[0], decode_logit_rel_l2=rels[1:],
        forced_argmax_agreement=forced_agree,
        greedy_agreement_with_phase_4=agree,
        weight_bytes_whole=whole,
        weight_bytes_per_position=tp.weight_bytes_per_device(),
        weight_bytes_ratio=ratio, weight_bytes_ratio_predicted=predicted,
        tokens_per_s=tp_stats.tokens_per_s, wall_s=tp_stats.wall_s,
        decode_steps=tp_stats.decode_steps, launches=tp_counts,
        launches_per_decode_step={k: v / tp_stats.decode_steps
                                  for k, v in tp_counts.items()},
        serve_s=tp_s)
    log("mesh (1, 2): " + json.dumps(out["tp"]))
    tp = None

    # -- (b) DP x TP replicas against the full (2, 2) engine -----------------
    fresh_memory(torch, device)
    rep = ReplicaServe.build(model, compiled.params, mesh=mesh22, **kw)
    (rep_outs, rstats), rep_counts = counted(
        "4n replicas over (2, 2)",
        lambda: rep.serve(requests(), num_slots=SLOTS, chunk=CHUNK))
    rep = None
    full = ServeEngine(model, compiled.params, mesh=mesh22, **kw)
    (full_outs, full_stats), full_counts = counted(
        "4n (2, 2) engine",
        lambda: full.serve(requests(), num_slots=2 * SLOTS, chunk=CHUNK))
    full = compiled = None
    check_outputs("mesh replicas", rep_outs, cfg.vocab_size)
    diff = first_difference(rep_outs, full_outs)
    out["dp"] = dict(
        replicas=rstats.replicas, assignments=rstats.assignments,
        occupancy_per_replica=rstats.occupancy_per_replica,
        replica_tokens_per_s=rstats.aggregate.tokens_per_s,
        full_mesh_tokens_per_s=full_stats.tokens_per_s,
        replica_launches=rep_counts, full_mesh_launches=full_counts,
        logprobs_identical=same_outputs(rep_outs, full_outs, logprobs=True),
        greedy_agreement_with_tp=float(np.mean([
            np.mean(o.generated == r.generated)
            for o, r in zip(rep_outs, tp_outs)])),
        first_difference=diff)
    log("mesh (2, 2): " + json.dumps(out["dp"]))
    if diff is not None:
        raise AssertionError(f"mesh (2, 2): the replicas' greedy tokens "
                             f"differ from the full-mesh engine's: {diff}")

    # -- (c) the artifact cold-booted sharded --------------------------------
    fresh_memory(torch, device)
    base = torch.cuda.memory_allocated() if device == "cuda" else 0
    t0 = time.perf_counter()
    art = ServeEngine.from_artifact(model, artifact_dir, max_seq=1024,
                                    mesh=mesh12, device=device)
    sync()
    boot_s = time.perf_counter() - t0
    held = sum(art.mesh_params.position_nbytes().values())
    peak = (torch.cuda.max_memory_allocated() - base if device == "cuda"
            else None)
    (art_outs, _), art_counts = counted(
        "4n cold-booted (1, 2) serve",
        lambda: art.serve(requests(), num_slots=SLOTS, chunk=CHUNK))
    out["cold_boot"] = dict(boot_s=boot_s, shards_bytes=held,
                            boot_peak_bytes=peak, whole_bytes=whole,
                            launches=art_counts,
                            tokens_equal_to_tp=same_outputs(
                                art_outs, tp_outs, logprobs=False),
                            logprobs_equal_to_tp=same_outputs(
                                art_outs, tp_outs, logprobs=True))
    art = None
    log("mesh cold boot (1, 2): " + json.dumps(out["cold_boot"]))
    if peak is not None and peak > held + 0.05 * whole:
        raise AssertionError(
            f"mesh cold boot: the allocation peaked at {peak} bytes over "
            f"{held} bytes of shards: a whole copy landed on the card")
    if not out["cold_boot"]["tokens_equal_to_tp"]:
        raise AssertionError("mesh cold boot: tokens differ from (a)'s: "
                             f"{first_difference(art_outs, tp_outs)}")
    report["mesh"] = out
    return launches


def analyze_model(torch, build, report: dict, model, params,
                  device: str) -> tuple:
    """Phase 5 for one model: ``analyze_blocks`` over every block in
    mode="kernel" (every matrix in one grouped entropy launch, read back
    once) and in mode="stream" (plain tensor ops), and the per-matrix path
    the analysis took before its launch was grouped
    (``block_entropy_from_matrices`` over each block: one single-array
    launch, whose table is a kernel parameter, and one ``float()`` a
    matrix), in turns (kernel, loop, stream, kernel, loop), each timed.
    Kernel mode
    must launch the kernel once; its entropies must equal the loop's to
    the bit and be
    within ENTROPY_TOL * max(1, |H|) and ENTROPY_ABS of stream mode's; the
    4bit/8bit plans of both modes (the plan ``plan_model(variant=
    "4bit/8bit", mode=...)`` gives) must be equal on every block whose
    distance to the plan's thresholds exceeds the largest difference
    measured between the two (random blocks of one shape have nearly
    equal entropies, so a block on a threshold may fall either way). The
    model's matrix bytes over HBM_BYTES_PER_S are the analysis's bound;
    the grouped launch's device time alone (``kernel_device_s``, median
    of 3) stands beside it. Returns (the kernel-mode entropies, entropy
    launches)."""
    from repro_torch.core import entropy as E
    from repro_torch.core import policy
    from repro_torch.core.planner import analyze
    cfg = model.cfg
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    blocks = model.block_params(params)

    def loop():     # the per-matrix path, one launch and float() a matrix
        return [[h for h, _ in E.block_entropy_from_matrices(
            E.flatten_block_params(blk), mode="kernel")[2].values()]
            for blk in blocks]

    timed = {}
    for mode in ("kernel", "loop", "stream", "kernel", "loop"):
        sync()
        build.reset_launches()
        t0 = time.perf_counter()
        ents = loop() if mode == "loop" else analyze(blocks, mode=mode)
        sync()
        timed.setdefault(mode, []).append((time.perf_counter() - t0, ents))
        if mode == "kernel":
            launches = build.LAUNCHES["entropy"]
    ek, es = timed["kernel"][-1][1], timed["stream"][0][1]
    if device == "cuda" and launches != 1:
        raise AssertionError(f"{cfg.name}: kernel mode launched the entropy "
                             f"kernel {launches} times, not once")
    looped = timed["loop"][-1][1]
    for bk, hl in zip(ek, looped):
        hk = [h for h, _ in bk.per_matrix.values()]
        if hk != hl:
            raise AssertionError(f"{cfg.name} block {bk.block_index}: "
                                 f"grouped entropies {hk} are not the "
                                 f"single launches' {hl}")
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
    kernel_s = [t for t, _ in timed["kernel"]]
    loop_s = [t for t, _ in timed["loop"]]
    device_s = None
    if device == "cuda":
        # the grouped launch's own device time: the host's checks and
        # table are hidden behind a sleep queued ahead of it
        from repro_torch.kernels.entropy import ops as EN
        flat = [t for blk in blocks for t in _matrices(blk)]
        reads = []
        for _ in range(3):
            torch.cuda._sleep(4_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            EN.entropies(flat)
            e.record()
            e.synchronize()
            reads.append(s.elapsed_time(e) / 1e3)
        device_s = sorted(reads)[1]
        del flat
    out = dict(model=cfg.name, blocks=len(ek), matrices=n_mats,
               bytes=nbytes, bound_s=nbytes / HBM_BYTES_PER_S,
               entropy_launches=launches, kernel_s=kernel_s,
               kernel_device_s=device_s,
               loop_s=loop_s, kernel_over_loop=min(kernel_s) / min(loop_s),
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

RECURRENT_MAX_SEQ = 1024   # cache depth per slot of phases 4e and 4f


def recurrent_run(torch, build, model, params, label: str, plan, kv: str,
                  graphs: bool, prompts, device: str, spec=None,
                  paged=None, readings: bool = False,
                  compiled: bool = False, max_new: int = 32):
    """One serve of phase 4e/4f/4h: the engine, its outputs (checked:
    ``max_new`` new tokens in the vocabulary with finite logprobs each),
    its launches and its row (tokens/s, TTFT, bytes, peak memory;
    ``readings``: one decode chunk's wall and device time and launches per
    step).
    ``compiled``: ``params`` are already compiled under ``plan`` (the
    engine takes them as they are and derives its draft from ``plan``).
    Every recurrent engine scans its prompts through the captured prompt
    step, one with eager decode chunks too (those are what it holds a
    graph serve to); ``prompt_graph_check`` holds the prompt step to the
    eager scan."""
    import numpy as np
    from repro_torch.serving.engine import ServeEngine
    cfg = model.cfg
    fresh_memory(torch, device)
    engine = ServeEngine(model, params, max_seq=RECURRENT_MAX_SEQ,
                         plan=None if compiled else plan, kv_precision=kv,
                         device=device, cuda_graphs=graphs, spec=spec,
                         paged=paged)
    engine.plan = plan
    if spec is not None:
        engine.draft_params                    # the draft, derived once
    build.reset_launches()                     # main path: counts from 0
    (outs, stats), peak, serve_peak = serve_peaks(
        torch, device, lambda: engine.serve(_requests_of(prompts, max_new),
                                            num_slots=SLOTS, chunk=CHUNK))
    counts = dict(build.LAUNCHES)
    for o in outs:
        if (len(o.generated) != max_new or o.generated.min() < 0
                or o.generated.max() >= cfg.vocab_size
                or not np.all(np.isfinite(o.logprobs))):
            raise AssertionError(f"{label}: bad output for request {o.rid}: "
                                 f"{o.generated}")
    run = dict(run=label, model=cfg.name, kv=kv,
               cuda_graphs=engine.graphs is not None,
               prompt_graph=engine.prompt_graph,
               paged=paged is not None,
               spec=None if spec is None else spec.draft_source,
               requests=len(outs), generated=stats.generated_tokens,
               tokens_per_s=stats.tokens_per_s,
               ttft_mean_s=stats.ttft_mean_s, tpot_p50_s=stats.tpot_p50_s,
               decode_chunk_p50_s=stats.decode_gap_p50_s, wall_s=stats.wall_s,
               weight_bytes=engine.weight_bytes(),
               kv_bytes_by_field=engine.kv_bytes_by_field(),
               kv_bytes_per_slot=engine.kv_bytes_per_slot(),
               state_bytes_by_field=engine.state_bytes_by_field(),
               max_memory_allocated=peak,
               serve_max_memory_allocated=serve_peak, launches=counts)
    if spec is not None:
        run.update(spec_rounds=stats.spec_rounds,
                   acceptance_rate=stats.acceptance_rate,
                   tokens_per_round=stats.tokens_per_round,
                   draft_overhead_bytes=engine.draft_overhead_bytes())
    if paged is not None:
        run.update(pool_pages=stats.pool_pages_total,
                   pool_pages_peak=stats.pool_pages_peak,
                   prefix_hits=stats.prefix_hits,
                   kv_bytes_peak=stats.kv_bytes_peak)
    if readings:
        run["chunk"] = chunk_readings(torch, build, engine, prompts, device)
    log(f"{cfg.name} serve: " + json.dumps(run))
    return engine, outs, run, counts


# Depth of the FULL configs phases 4e/4f serve, where cut: zamba2-2.7b's
# 54 layers (the shared block at 9 sites) take 24 (4 sites), every width
# as published. At 54 the whole smoke ran 770 s on one H100, its eight
# zamba2 serves (prompts scanned token by token) 351 s of it; at 36, with
# phase 4h, 662-704 s.
RECURRENT_LAYERS = {"zamba2-2.7b": 24}


def serve_recurrent(torch, build, report: dict, arch: str,
                    smoke: bool = False, device: str = "cuda") -> dict:
    """Phases 5 and 4e (zamba2-2.7b at full width, its depth cut to
    RECURRENT_LAYERS: 24 Mamba2 layers, d_model 2560, one shared attention
    + MLP block at 4 sites, 32 heads of hd 80, vocab 32000) or 4f
    (mamba2-780m FULL: 48 layers, d_model 1536, vocab 50280)
    from seeded random weights, max_seq 1024, 4 slots, chunk 8, phase 4's
    8 prompts of 64-256 tokens (each prefilled as a scan of single-token
    steps, replayed from a CUDA graph on a graph engine), 32 new tokens
    each. The analysis through the entropy kernel (phase 5); its 4bit/8bit
    plan served with int8 KV from CUDA graphs, with eager decode chunks
    (equal to the bit) and under the planted stale-buffer fault (must
    differ); the prompt step against the eager scan (to the bit); an explicit
    raw/int8/int4/ternary plan (int8 embedding and shared block) with int4
    KV. zamba2 only: an equal-memory paged pool with prefix sharing
    (tokens and logprobs equal to the dense EWQ serve) and spec k = 4 with
    the int4 self-draft and the ngram draft, each from CUDA graphs and
    eagerly (equal to the bit). Then, on the explicit engine, one decode
    step through the kernels against the plain versions (LOGIT_REL_L2),
    the plain versions with their f32 sums reordered against themselves (a
    reading of the limit's floor), and the planted fault the limit must
    catch: one Mamba2 layer's int4 ``w_in`` nibble-swapped. Returns the
    launches of the phases."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import policy
    from repro_torch.models.model import build as build_model
    from repro_torch.quant.kvcache import clone_cache
    from repro_torch.serving.pool import PagedConfig
    from repro_torch.serving.quantized import explicit_plan
    from repro_torch.serving.spec import SpecConfig

    cfg = get_config(arch, smoke=smoke)
    if not smoke and arch in RECURRENT_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=RECURRENT_LAYERS[arch])
    hybrid = cfg.family == "hybrid"
    model = build_model(cfg)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    sync()
    n_params = sum(t.numel() for t in _matrices(params))
    log(f"{cfg.name}: {cfg.family} {cfg.num_layers}L d_model {cfg.d_model} "
        f"d_inner {cfg.d_inner} ssm heads {cfg.ssm_nheads}x{cfg.ssm_headdim} "
        f"state {cfg.ssm_state} "
        + (f"shared attention {cfg.num_heads}H/{cfg.num_kv_heads}KV hd "
           f"{cfg.head_dim} x {cfg.num_layers // cfg.shared_attn_period} "
           f"sites d_ff {cfg.d_ff} " if hybrid else "")
        + f"vocab {cfg.vocab_size} {cfg.dtype}: {n_params} matrix params; "
        f"random init {time.perf_counter() - t0:.1f} s")
    launches = {k: 0 for k in build.LAUNCHES}
    ents, launches["entropy"] = analyze_model(torch, build, report, model,
                                              params, device)
    ewq = policy.decide(ents, aggressive="int4")    # the 4bit/8bit variant
    log(f"{cfg.name}: EWQ 4bit/8bit plan from the kernel-mode entropies: "
        f"{ewq.counts()} precisions {ewq.precisions()}")
    tiers = ["raw", "int8", "int4", "ternary"]
    n = cfg.num_layers
    explicit = explicit_plan(cfg, [tiers[i * len(tiers) // n]
                                   for i in range(n)],
                             embed_precision="int8",
                             shared_precision="int8")
    prompts = serve_prompts(cfg.vocab_size)
    runs = []

    def serve(label, plan, kv, graphs, **kw):
        engine, outs, run, counts = recurrent_run(
            torch, build, model, params, label, plan, kv, graphs, prompts,
            device, **kw)
        for k, v in counts.items():
            launches[k] += v
        runs.append(run)
        return engine, outs, run

    engine, base_outs, _ = serve("ewq-4bit/8bit", ewq, "int8", True,
                                 readings=True)
    fault_outs = (stale_buffer_serve(torch, engine, _requests_of(prompts))
                  if device == "cuda" else None)
    prompt_check = prompt_graph_check(torch, engine, min(prompts, key=len))
    engine = None
    _, outs, run = serve("ewq-4bit/8bit", ewq, "int8", False)
    require_same(f"{cfg.name} ewq", base_outs, outs, logprobs=True)
    run["identical_to_graph_run"] = True
    if fault_outs is not None:
        run["planted_fault"] = stale_buffer_caught(fault_outs, outs)
    if hybrid:
        _, outs, run = serve("ewq-4bit/8bit-paged", ewq, "int8", True,
                             paged=PagedConfig(page_size=PAGE))
        if not same_outputs(outs, base_outs, logprobs=True):
            raise AssertionError(f"{cfg.name}: the paged serve differs from "
                                 "the dense serve")
        run["identical_to_dense_run"] = True
        for label, source in (("spec-model-draft", "model"),
                              ("spec-ngram-draft", "ngram")):
            spec = SpecConfig(k=SPEC_K, draft_source=source)
            _, graph_outs, _ = serve(label, ewq, "int8", True, spec=spec,
                                     readings=True)
            _, outs, run = serve(label, ewq, "int8", False, spec=spec)
            require_same(f"{cfg.name} {label}", graph_outs, outs,
                         logprobs=True)
            run["identical_to_graph_run"] = True
    engine, _, _ = serve("explicit-all-precisions", explicit, "int4", True,
                         readings=True)

    # one decode step through the kernels against the plain versions, on
    # the explicit plan's params and an identical int4 cache
    state = engine.init_decode_state(SLOTS)
    for slot in range(SLOTS):
        engine.insert(state, slot, engine.prefill_request(prompts[slot]), 32)
    toks = torch.argmax(state.last_logits[:, :cfg.vocab_size], -1)[:, None]

    def step_logits(p, plain=False):
        logits, _ = model.decode_step(p, clone_cache(state.cache), toks,
                                      plain=plain)
        return logits.float()

    k_logits = step_logits(engine.params)
    p_logits = step_logits(engine.params, True)
    if not bool(torch.isfinite(k_logits).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits through the "
                             "kernels")
    rel = rel_l2(k_logits, p_logits)
    with patched_plain(torch, "reordered"):
        rel_reordered = rel_l2(step_logits(engine.params, True), p_logits)
    rel_fault = rel_l2(step_logits(swap_nibbles_one_layer(
        torch, engine.params, leaf="w_in")), p_logits)
    agree = float((k_logits.argmax(-1) == p_logits.argmax(-1)).float().mean())
    log(f"{cfg.name}: first decode step, kernels vs plain versions: relative "
        f"L2 {rel:.4g} (limit {LOGIT_REL_L2}), greedy agreement {agree:.2f}; "
        f"plain versions with their f32 sums reordered vs plain versions "
        f"{rel_reordered:.4g}; one Mamba2 layer's int4 w_in nibble-swapped: "
        f"{rel_fault:.4g}")
    if rel > LOGIT_REL_L2:
        raise AssertionError(f"{cfg.name}: decode logits differ: relative L2 "
                             f"{rel}")
    if rel_fault <= LOGIT_REL_L2:
        raise AssertionError(f"{cfg.name}: the logit limit {LOGIT_REL_L2} "
                             f"misses a planted fault (relative L2 "
                             f"{rel_fault})")
    step = {}
    if device == "cuda":
        eager_ms, device_ms = step_ms(torch, model, engine.params, state,
                                      toks)
        step = dict(eager_ms=eager_ms, device_ms=device_ms)
        log(f"{cfg.name}: one decode step at {SLOTS} slots (explicit plan, "
            f"int4 KV): eager {eager_ms:.2f} ms wall, device {device_ms:.2f} "
            f"ms (CUDA graph replay)")
    report.setdefault("recurrent", {})[cfg.name] = dict(
        runs=runs, ewq_counts=ewq.counts(), logit_rel_l2=rel,
        logit_rel_l2_reordered=rel_reordered,
        logit_rel_l2_planted_fault=rel_fault, greedy_agreement=agree,
        decode_step=step, prompt_graph_check=prompt_check,
        launches=launches)
    return launches


# ---------------------------------------------------------------------------
# phase 4h: the MoE family at full width, its depth cut
# ---------------------------------------------------------------------------

# Depth of the MoE configs phase 4h serves: neither fits one 80 GB card
# whole (grok-1 needs at least 157 GB at int4, arctic-480b 240 GB); every
# width is the published one. One layer holds 4.92 G params (9.84 GB in
# bf16) in grok-1 and 13.6 G (27.2 GB) in arctic.
MOE_LAYERS = {"grok-1-314b": 2, "arctic-480b": 1}
# the kernels the MoE serves and analyses (phase 4h) run, each of which
# must launch there: the routers, heads and attention output projections
# (qmatmul), the projections (qkv), arctic's dense residual MLP (qmlp),
# decode attention at rep 6 and 7 in its single-query, verify-window,
# fresh-row and paged forms, and the grouped entropy launch
MOE_PATH = ("qmatmul", "qkv", "qmlp", "decode_attn", "decode_attn_window",
            "decode_attn_fresh", "decode_attn_paged", "entropy")


def permute_router_rows(torch, params) -> dict:
    """A planted fault: ``params`` with the first layer's router rows
    rotated by one expert (its payload and scales, or its raw rows), so
    every token of that layer is routed by another expert's logits."""
    from repro_torch.quant.qtypes import QTensor
    layers = params["layers"]
    segs = list(layers.segments)
    sp = segs[0].params
    r = sp["moe"]["router"]

    def roll(t):
        t = t.clone()
        t[0] = t[0].roll(1, dims=0)
        return t

    r = (dataclasses.replace(r, data=roll(r.data), scale=roll(r.scale))
         if isinstance(r, QTensor) else roll(r))
    segs[0] = dataclasses.replace(
        segs[0], params={**sp, "moe": {**sp["moe"], "router": r}})
    return {**params, "layers": dataclasses.replace(layers, segments=segs)}


def serve_moe(torch, build, report: dict, arch: str, smoke: bool = False,
              device: str = "cuda") -> dict:
    """Phases 5 and 4h for one MoE config at full width, its depth cut to
    MOE_LAYERS (grok-1-314b: 2 of 64 layers, d_model 6144, 48 heads over
    8 KV heads of 128, 8 experts top-2 of d_ff 32768, vocab 131072;
    arctic-480b: 1 of 35, d_model 7168, 56 heads over 8, 128 experts top-2
    of d_ff 4864 beside a dense residual MLP of 4864, vocab 32000) from
    seeded random weights, phase 4's 8 prompts, 32 new tokens each, 4
    slots, chunk 8, max_seq 1024. The analysis through the entropy kernel
    (phase 5; every expert stack one array of the grouped launch). Both
    plans are compiled first and the raw weights freed before any serve:
    the 4bit/8bit plan from the kernel-mode entropies with int8 KV, from
    CUDA graphs and eagerly (equal to the bit); an explicit plan (int8
    embedding, layers int8 then int4) with int4 KV, so the routers,
    projections, experts and arctic's residual MLP run quantized, from
    CUDA graphs and eagerly (equal to the bit). grok-1
    also from an equal-memory paged pool (equal to its dense serve) and
    speculatively (k = 4, the int4 self-draft, fused propose; one wave of
    4 prompts, 16 new tokens each, for time). Then, on
    the explicit engine, one decode step through the kernels against the
    plain versions (LOGIT_REL_L2), the plain versions with their f32 sums
    reordered (the floor, a reading), and the planted fault the limit
    must catch: the first layer's router rows rotated by one expert.
    Returns the launches of the phases."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import policy
    from repro_torch.models.model import build as build_model
    from repro_torch.quant.kvcache import clone_cache
    from repro_torch.serving.pool import PagedConfig
    from repro_torch.serving.quantized import explicit_plan
    from repro_torch.serving.spec import SpecConfig

    cfg = get_config(arch, smoke=smoke)
    if not smoke:
        cfg = dataclasses.replace(cfg, num_layers=MOE_LAYERS[arch])
    model = build_model(cfg)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    sync()
    n_params = sum(t.numel() for t in _matrices(params))
    raw_bytes = sum(t.numel() * t.element_size() for t in _matrices(params))
    log(f"{cfg.name}: moe {cfg.num_layers} of {get_config(arch).num_layers}"
        f"L d_model {cfg.d_model} {cfg.num_heads}H/{cfg.num_kv_heads}KV hd "
        f"{cfg.head_dim} {cfg.num_experts} experts top-{cfg.top_k} d_ff "
        f"{cfg.expert_d_ff}" + (f" + dense residual d_ff {cfg.d_ff}"
                                if cfg.dense_residual else "")
        + f" vocab {cfg.vocab_size} {cfg.dtype}: {n_params} matrix params, "
        f"{raw_bytes} bytes (analytic {cfg.param_count()} params); random "
        f"init {time.perf_counter() - t0:.1f} s")
    launches = {k: 0 for k in build.LAUNCHES}
    ents, launches["entropy"] = analyze_model(torch, build, report, model,
                                              params, device)
    ewq = policy.decide(ents, aggressive="int4")    # the 4bit/8bit variant
    explicit = explicit_plan(cfg, (["int8", "int4"] * cfg.num_layers)
                             [:cfg.num_layers], embed_precision="int8")
    log(f"{cfg.name}: EWQ 4bit/8bit plan from the kernel-mode entropies: "
        f"{ewq.counts()} precisions {ewq.precisions()}; explicit "
        f"{explicit.precisions()}")
    t0 = time.perf_counter()
    trees = {name: model.compile_plan(params, plan).params
             for name, plan in (("ewq", ewq), ("explicit", explicit))}
    sync()
    compile_s = time.perf_counter() - t0
    params = None                       # the raw weights: freed
    fresh_memory(torch, device)
    prompts = serve_prompts(cfg.vocab_size)
    runs = []

    def serve(label, tree, plan, kv, graphs, requests=prompts, **kw):
        engine, outs, run, counts = recurrent_run(
            torch, build, model, trees[tree], label, plan, kv, graphs,
            requests, device, compiled=True, **kw)
        for k, v in counts.items():
            launches[k] += v
        runs.append(run)
        return engine, outs, run

    _, base_outs, _ = serve("ewq-4bit/8bit", "ewq", ewq, "int8", True,
                            readings=True)
    _, outs, run = serve("ewq-4bit/8bit", "ewq", ewq, "int8", False)
    require_same(f"{cfg.name} ewq", base_outs, outs, logprobs=True)
    run["identical_to_graph_run"] = True
    if arch == "grok-1-314b":
        _, outs, run = serve("ewq-4bit/8bit-paged", "ewq", ewq, "int8", True,
                             paged=PagedConfig(page_size=PAGE))
        if not same_outputs(outs, base_outs, logprobs=True):
            raise AssertionError(f"{cfg.name}: the paged serve differs from "
                                 "the dense serve")
        run["identical_to_dense_run"] = True
        # one wave of SLOTS prompts, 16 new tokens each, for time: every
        # round runs four int4 draft steps, each dequantizing both layers'
        # experts, and commits about one token a slot (random weights)
        serve("spec-model-draft", "ewq", ewq, "int8", True,
              requests=prompts[:SLOTS], max_new=16,
              spec=SpecConfig(k=SPEC_K))
    engine, base_outs, _ = serve("explicit", "explicit", explicit, "int4",
                                 True, readings=True)
    # EWQ leaves every layer of a depth-cut config raw: this is the graph
    # serve whose decode runs the quantized experts (chunked dequantize),
    # held to the eager serve to the bit
    _, outs, run = serve("explicit", "explicit", explicit, "int4", False)
    require_same(f"{cfg.name} explicit", base_outs, outs, logprobs=True)
    run["identical_to_graph_run"] = True

    # one decode step through the kernels against the plain versions, on
    # the explicit plan's params and an identical int4 cache
    state = engine.init_decode_state(SLOTS)
    for slot in range(SLOTS):
        engine.insert(state, slot, engine.prefill_request(prompts[slot]), 32)
    toks = torch.argmax(state.last_logits[:, :cfg.vocab_size], -1)[:, None]

    def step_logits(p, plain=False):
        logits, _ = model.decode_step(p, clone_cache(state.cache), toks,
                                      plain=plain)
        return logits.float()

    k_logits = step_logits(engine.params)
    p_logits = step_logits(engine.params, True)
    if not bool(torch.isfinite(k_logits).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits through the "
                             "kernels")
    rel = rel_l2(k_logits, p_logits)
    with patched_plain(torch, "reordered"):
        rel_reordered = rel_l2(step_logits(engine.params, True), p_logits)
    rel_fault = rel_l2(step_logits(permute_router_rows(torch, engine.params)),
                       p_logits)
    agree = float((k_logits.argmax(-1) == p_logits.argmax(-1)).float().mean())
    log(f"{cfg.name}: first decode step, kernels vs plain versions: relative "
        f"L2 {rel:.4g} (limit {LOGIT_REL_L2}), greedy agreement {agree:.2f}; "
        f"plain versions with their f32 sums reordered vs plain versions "
        f"{rel_reordered:.4g}; the first layer's router rows rotated by one "
        f"expert: {rel_fault:.4g}")
    if rel > LOGIT_REL_L2:
        raise AssertionError(f"{cfg.name}: decode logits differ: relative L2 "
                             f"{rel}")
    if rel_fault <= LOGIT_REL_L2:
        raise AssertionError(f"{cfg.name}: the logit limit {LOGIT_REL_L2} "
                             f"misses a planted fault (relative L2 "
                             f"{rel_fault})")
    step = {}
    if device == "cuda":
        eager_ms, device_ms = step_ms(torch, model, engine.params, state,
                                      toks)
        step = dict(eager_ms=eager_ms, device_ms=device_ms)
        log(f"{cfg.name}: one decode step at {SLOTS} slots (explicit plan, "
            f"int4 KV): eager {eager_ms:.2f} ms wall, device {device_ms:.2f} "
            f"ms (CUDA graph replay)")
    engine = state = None
    report.setdefault("moe", {})[cfg.name] = dict(
        layers=cfg.num_layers, raw_weight_bytes=raw_bytes,
        matrix_params=n_params, compile_s=compile_s, runs=runs,
        ewq_counts=ewq.counts(), ewq_precisions=ewq.precisions(),
        explicit_precisions=explicit.precisions(), logit_rel_l2=rel,
        logit_rel_l2_reordered=rel_reordered,
        logit_rel_l2_planted_fault=rel_fault, greedy_agreement=agree,
        decode_step=step, launches=launches)
    return launches


def prompt_graph_check(torch, engine, prompt, chunk: int = 32) -> dict:
    """A prompt scanned through the captured prompt step against the same
    prompt scanned eagerly, and against the prompt prefilled in chunks of
    ``chunk`` tokens through the step (``begin_prefill`` +
    ``advance_prefill``, each chunk starting from the cache so far): the
    cache (conv, state and K/V) and the last logits must be equal to the
    bit."""
    sync = (torch.cuda.synchronize if engine.device.type == "cuda"
            else (lambda: None))
    toks = engine._tokens(prompt[None])
    t0 = time.perf_counter()
    g_cache, g_logits = engine._scan_prompt(toks)
    sync()
    t1 = time.perf_counter()
    e_cache, e_logits = engine._scan_prompt(toks, eager=True)
    sync()
    t2 = time.perf_counter()
    task = engine.begin_prefill(prompt)
    chunks = 0
    while not task.done:
        engine.advance_prefill(task, chunk)
        chunks += 1
    sync()
    t3 = time.perf_counter()

    def same(cache, logits):
        return torch.equal(g_logits, logits) and all(
            torch.equal(a, b) for a, b in zip(g_cache, cache))

    if not same(e_cache, e_logits):
        raise AssertionError(f"{engine.cfg.name}: the prompt step replayed "
                             "from its graph differs from the eager scan")
    if not same(task.cache, task.last_logits):
        raise AssertionError(f"{engine.cfg.name}: the prompt prefilled in "
                             f"chunks of {chunk} through the graph differs "
                             "from the whole-prompt graph scan")
    out = dict(tokens=int(prompt.size), graph_s=t1 - t0, eager_s=t2 - t1,
               identical=True, chunk=chunk, chunks=chunks,
               chunked_graph_s=t3 - t2, chunked_identical=True)
    log(f"{engine.cfg.name}: prompt scan from its CUDA graph equal to the "
        f"eager scan and to the chunked scan to the bit: " + json.dumps(out))
    return out


def _requests_of(prompts, max_new: int = 32) -> list:
    from repro_torch.serving.scheduler import Request
    return [Request(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]


WHISPER_MAX_SEQ = 448   # whisper's published decoder context (n_text_ctx)


def whisper_requests(cfg, max_new: int = 32) -> list:
    """8 requests of ``max_new`` new tokens: decoder prompts of 4-32
    tokens (numpy seed 0) and one (encoder_seq, d_model) frame block
    each, standard normal (numpy seed 2, the encoder input's scale in the
    reference's synthetic data)."""
    import numpy as np
    from repro_torch.serving.scheduler import Request
    rng = np.random.RandomState(0)
    lens = rng.randint(4, 33, size=8)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in lens]
    frng = np.random.RandomState(2)
    return [Request(rid=i, prompt=p, max_new_tokens=max_new,
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
    from repro_torch.serving.pool import PagedConfig
    from repro_torch.serving.quantized import explicit_plan
    from repro_torch.serving.spec import SpecConfig

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
    # EWQ from CUDA graphs, then eagerly (held equal to the bit); EWQ from
    # an equal-memory paged pool (held equal to the dense serve); EWQ
    # speculatively with each draft, from graphs and eagerly (equal to the
    # bit); the explicit plan from CUDA graphs
    paged = dict(paged=PagedConfig(page_size=PAGE))
    cases = [("whisper-ewq-4bit/8bit", ewq, "int8", True, {}, WHISPER_PATH),
             ("whisper-ewq-4bit/8bit", ewq, "int8", False, {}, WHISPER_PATH),
             ("whisper-ewq-4bit/8bit-paged", ewq, "int8", True, paged,
              WHISPER_PAGED_PATH)]
    for source, path in (("model", WHISPER_PATH + ("decode_attn_window",)),
                         ("ngram", WHISPER_NGRAM_PATH)):
        spec = dict(spec=SpecConfig(k=SPEC_K, draft_source=source))
        cases += [(f"whisper-spec-{source}-draft", ewq, "int8", graphs,
                   spec, path) for graphs in (True, False)]
    cases.append(("whisper-explicit-all-precisions", explicit, "int4", True,
                  {}, WHISPER_PATH))
    graph_outs = {}
    engine = None
    for label, plan, kv, graphs, kw, path in cases:
        # a spec serve takes one wave of SLOTS requests, 16 new tokens
        # each, for time
        spec_wave = dict(n_requests=SLOTS, max_new=16) if "spec" in kw \
            else {}
        engine = None                          # free the previous engine
        fresh_memory(torch, device)
        engine = ServeEngine(model, params, max_seq=WHISPER_MAX_SEQ,
                             plan=plan, kv_precision=kv, device=device,
                             cuda_graphs=graphs, **kw)
        if engine.spec is not None:
            engine.draft_params                # the draft, derived once
        run, counts, outs = whisper_run(torch, build, model, engine, label,
                                        kv, plan, device, path=path,
                                        readings=graphs and not kw,
                                        **spec_wave)
        for k, v in counts.items():
            launches[k] += v
        runs.append(run)
        if graphs:
            graph_outs[label] = outs
        else:
            require_same(label, graph_outs[label], outs, logprobs=True)
            run["identical_to_graph_run"] = True
        if "paged" in kw:
            if not same_outputs(outs, graph_outs["whisper-ewq-4bit/8bit"],
                                logprobs=True):
                raise AssertionError("whisper: the paged serve differs from "
                                     "the dense serve")
            run["identical_to_dense_run"] = True
    engine = None
    ttft = {("graphs" if r["cuda_graphs"] else "eager"): r["ttft_mean_s"]
            for r in runs if r["run"] == "whisper-ewq-4bit/8bit"}
    log(f"whisper: mean TTFT (EWQ, int8 KV): {json.dumps(ttft)}")
    report["whisper_ttft"] = ttft
    report["whisper_runs"] = runs
    return launches


def whisper_run(torch, build, model, engine, label: str, kv: str, plan,
                device: str, readings: bool = True,
                path: tuple = None, n_requests: int = None,
                max_new: int = 32) -> tuple:
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
    chunk readings only. Every kernel of ``path`` (WHISPER_PATH by
    default) must launch in the serve; ``n_requests`` serves the first
    that many requests, ``max_new`` tokens each. Returns (the run's
    record, the serve's launches, the outputs)."""
    import numpy as np
    from repro_torch.models import encdec
    from repro_torch.quant.kvcache import clone_cache
    cfg = model.cfg
    reqs = whisper_requests(cfg, max_new)[:n_requests]
    build.reset_launches()                     # main path: counts from 0
    (outs, stats), peak, serve_peak = serve_peaks(
        torch, device, lambda: engine.serve(reqs, num_slots=SLOTS,
                                            chunk=CHUNK))
    counts = dict(build.LAUNCHES)
    for o in outs:
        if (len(o.generated) != max_new or o.generated.min() < 0
                or o.generated.max() >= cfg.vocab_size
                or not np.all(np.isfinite(o.logprobs))):
            raise AssertionError(f"{label}: bad output for request {o.rid}: "
                                 f"{o.generated}")
    by_field = engine.kv_bytes_by_field()
    run = dict(run=label, kv=kv, cuda_graphs=engine.graphs is not None,
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
    if engine.spec is not None:
        run.update(spec=engine.spec.draft_source,
                   spec_rounds=stats.spec_rounds,
                   acceptance_rate=stats.acceptance_rate,
                   tokens_per_round=stats.tokens_per_round,
                   draft_overhead_bytes=engine.draft_overhead_bytes())
    if engine.paged is not None:
        run.update(paged=True, pool_pages=stats.pool_pages_total,
                   pool_pages_peak=stats.pool_pages_peak,
                   kv_bytes_peak=stats.kv_bytes_peak)
    for k in path or WHISPER_PATH:
        if counts[k] <= 0 and device == "cuda":
            raise AssertionError(f"{label}: kernel {k} never launched")
    if engine.graphs is not None:   # an eager chunk's wall is in the stats
        run["chunk"] = chunk_readings(torch, build, engine,
                                      [r.prompt for r in reqs], device,
                                      frames=[r.frames for r in reqs])
    if not readings:
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
def prefill_times(torch, device: str):
    """Records, in a list it yields, every ``ServeEngine.prefill_request``
    made inside the block: the prompt's prefix hit (tokens) and the tokens
    of each multi-query step it ran (a hit's suffix); on the card also its
    device ms (the kernels and copies torch.profiler traces in it: the
    device's work, without the host's dispatch) and its wall ms (the
    device synchronized before and after, the profiler on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import ServeEngine
    saved_request = ServeEngine.prefill_request
    saved_step = ServeEngine._prefill_step
    records, steps = [], []

    def step(self, toks, cache):
        steps.append(int(toks.shape[1]))
        return saved_step(self, toks, cache)

    def request(self, prompt, state=None, **kw):
        steps.clear()
        if device != "cuda":
            out = saved_request(self, prompt, state, **kw)
        else:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = saved_request(self, prompt, state, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        rec = dict(hit=0 if out.match is None else int(out.match.hit),
                   steps=list(steps))
        if device == "cuda":
            rec.update(device_ms=sum(
                e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA) / 1e3,
                wall_ms=wall * 1e3)
        records.append(rec)
        return out

    ServeEngine.prefill_request, ServeEngine._prefill_step = request, step
    try:
        yield records
    finally:
        ServeEngine.prefill_request = saved_request
        ServeEngine._prefill_step = saved_step


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

def mesh_rows(rows: list, kname: str, mesh_launches: dict) -> list:
    """Phase 3's rows of ``kname`` at phase 4n's shapes (MESH_ROWS) with
    their times, bound and library call, and the kernel's launches in 4n's
    (1, 2) serve, every one of them at a position's shapes."""
    out = []
    for key in MESH_ROWS[kname]:
        for r in rows:
            if r["kernel"] == kname and (r["shape"], r["precision"],
                                         r["m"]) == key:
                out.append({k: r.get(k) for k in (
                    "shape", "precision", "m", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "library_composition_ms")
                    if k in r} | {"launches": mesh_launches[kname]})
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this run needs one GPU")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    # -- phase 1: device ----------------------------------------------------
    t_run = time.perf_counter()
    report: dict = {}
    with phase(report, "1 device"):
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"device: {name} | torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
        log("tf32: off for matmul and cudnn (f32 products run in full f32)")

    # -- phase 2: build -----------------------------------------------------
    with phase(report, "2 build"):
        t0 = time.perf_counter()
        build.build_all()
        log(f"build: {time.perf_counter() - t0:.1f} s ({build.BUILD_INFO})")
        ptxas = {src: build.ptxas_report(src) for src in build.SOURCES}
        for src, kernels in ptxas.items():
            for k in kernels:
                log(f"ptxas {src}: {k.get('registers')} registers, "
                    f"{k.get('smem_bytes')} bytes static smem, spill stores "
                    f"{k.get('spill_stores')} loads {k.get('spill_loads')} "
                    f"bytes: {k['kernel']}")

    # -- phase 3: kernels ---------------------------------------------------
    with phase(report, "3 kernels"):
        timer = Timer(torch)
        rows: list = []
        worst = check_kernels(torch, timer, rows)
        log(f"kernels: all within rtol=atol=2e-2 of their plain versions, "
            f"decode attention within relative L2 {ATTN_REL_L2}; max abs "
            f"err {worst}")
    report.update(device=name, nvidia_smi=smi, rows=rows,
                  build=dict(build.BUILD_INFO), ptxas=ptxas)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    out_file = out_dir / "chip_smoke.json"

    # -- phases 4, 4b, 4c and 5: llama3.2-3b at full width --------------------
    torch.cuda.empty_cache()
    launches = serve_full_width(torch, build, report)
    out_file.write_text(json.dumps(report, indent=1))

    # -- phases 5 and 4d: whisper-medium at full width ---------------------
    torch.cuda.empty_cache()
    with phase(report, "5+4d whisper-medium"):
        for k, v in serve_whisper(torch, build, report).items():
            launches[k] += v
    out_file.write_text(json.dumps(report, indent=1))
    # -- phases 5, 4e and 4f: zamba2-2.7b and mamba2-780m at full width -----
    for arch, path, label in (("zamba2-2.7b", ZAMBA_PATH, "5+4e"),
                              ("mamba2-780m", MAMBA_PATH, "5+4f")):
        torch.cuda.empty_cache()
        with phase(report, f"{label} {arch}"):
            got = serve_recurrent(torch, build, report, arch)
        for k in path:
            if got[k] <= 0:
                raise AssertionError(f"kernel {k} never launched on "
                                     f"{arch}'s serve and analysis paths")
        for k, v in got.items():
            launches[k] += v
        out_file.write_text(json.dumps(report, indent=1))
    # -- phases 5 and 4h: grok-1-314b and arctic-480b at full width ---------
    moe_launches = {k: 0 for k in build.LAUNCHES}
    for arch in MOE_LAYERS:
        torch.cuda.empty_cache()
        with phase(report, f"5+4h {arch}"):
            got = serve_moe(torch, build, report, arch)
        for k, v in got.items():
            moe_launches[k] += v
            launches[k] += v
        out_file.write_text(json.dumps(report, indent=1))
    for k in MOE_PATH:
        if moe_launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the MoE "
                                 "serve and analysis paths")
    report["moe_launches"] = moe_launches
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
        entry = {
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": worst[kname], "ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"),
            "library_ms": row.get("library_ms")}
        if "library_composition_ms" in row:
            entry["library_composition_ms"] = row["library_composition_ms"]
        if kname in MESH_ROWS:
            entry["mesh_rows"] = mesh_rows(rows, kname,
                                           report["mesh"]["tp"]["launches"])
        kernels.append(entry)
    seconds = report["phase_seconds"]
    log(f"run: {time.perf_counter() - t_run:.1f} s, by phase "
        f"{json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    out_file.write_text(json.dumps(report, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
