"""Serve an EWQ-quantized model with the PyTorch port.

    python -m repro_torch.launch.serve --arch llama3.2-3b --variant 4bit/8bit \
        --kv-precision int8 --num-requests 8 --num-slots 4 --chunk 8
    python -m repro_torch.launch.serve --arch llama3.2-3b --smoke --device cpu
    python -m repro_torch.launch.serve --arch llama3.2-3b --spec-k 4 \
        --spec-draft model     # self-speculative decoding, int4 self-draft
    python -m repro_torch.launch.serve --arch llama3.2-3b --paged \
        --shared-prefix-len 12 # paged KV pool with prefix sharing
    python -m repro_torch.launch.serve --arch whisper-medium \
        --kv-precision int8    # enc-dec: seeded frames per request
    python -m repro_torch.launch.serve --arch zamba2-2.7b --smoke \
        --device cpu           # hybrid (also --paged, --spec-k 4)
    python -m repro_torch.launch.serve --arch mamba2-780m --smoke \
        --device cpu           # SSM (also --spec-k 4)
    python -m repro_torch.launch.serve --arch grok-1-314b --smoke \
        --device cpu           # MoE (also arctic-480b; --paged, --spec-k 4)
    python -m repro_torch.launch.serve --arch grok-1-314b --num-layers 2
                               # MoE at full width, its depth cut to fit
    python -m repro_torch.launch.serve --arch llama3.2-3b \
        --plan-artifact /tmp/llama-ewq   # compile and save; the next run
                                         # cold-boots from the artifact
    python -m repro_torch.launch.serve --arch llama3.2-3b --prefill-chunk 64 \
        --priorities 0,1,1,1 --preempt --arrival-rate 0.5 --poisson
    python -m repro_torch.launch.serve --arch llama3.2-3b --paged \
        --degrade-policy ewq --chaos oom --check-chaos-parity
                               # spill the KV tiers under injected pressure
    python -m repro_torch.launch.serve --arch llama3.2-3b \
        --trace-out trace.json --metrics-out metrics.prom \
        --profile-steps 8:24   # traced, metered and profiled serve
    python -m repro_torch.launch.serve --arch llama3.2-3b --mesh data,model \
        --mesh-shape 2,2 --dp --check-dp-parity
                               # DP x TP replicas against the full mesh

Weights start from a seeded ``torch.Generator`` init at the JAX package's
scales (real checkpoints are not in the repository) and train
``--train-steps`` steps (default 30, batch ``--batch``, sequences of twice
``--prompt-len``; lr 1e-3, warmup 3, as the reference's launcher) on the
synthetic stream before the analysis, so the weights are not degenerate;
``--train-steps 0`` plans the seeded init itself. A cold boot from an
artifact trains nothing. The run shows the serving path, its memory and
its speed, not model quality.
An enc-dec model (whisper) gets one block of (encoder_seq, d_model) frame
embeddings per request, standard normal from ``--seed``, in place of the
audio frontend. An SSM or hybrid model also reports the conv/state bytes
a slot holds; an SSM model has no KV cache, so ``--kv-precision`` and
``--paged`` leave it as it is. ``--num-layers N`` keeps the config's width
and cuts its depth to N layers: neither MoE config fits one 80 GB card
whole (grok-1 needs at least 157 GB at int4, arctic 240 GB).
``--plan-artifact DIR`` boots from DIR when it holds a compiled-plan
artifact (no raw weights, no entropy analysis; the KV plan stamped there is
the default), and otherwise compiles the plan, stamps the int4 self-draft
when ``--spec-draft model`` serves, and saves the artifact there.
``--prefill-chunk`` interleaves prompt prefill between decode chunks;
``--priorities``, ``--poisson``, ``--ttft-target-ms``, ``--tpot-target-ms``,
``--preempt``, ``--queue-timeout-steps`` and ``--deadline-steps`` shape the
stream and its SLO scheduling. ``--degrade-policy ewq`` (with ``--paged``)
spills the pool down the entropy-ordered KV tier ladder under pressure and
promotes it back; ``--chaos`` injects faults into the serve
(``serving/chaos.py`` shorthands, seeded by ``--chaos-seed``);
``--watchdog-ms`` counts decode gaps over the deadline;
``--check-chaos-parity`` serves fault-free (and undegraded) first and
fails unless the chaos serve gives the same greedy tokens.
``--trace-out`` writes the serve's spans as Chrome trace_event JSON,
``--metrics-out`` its metrics registry as Prometheus text (and a JSON
snapshot beside it), and ``--profile-steps A:B`` arms the device fences
(CUDA events around each decode chunk) and a ``torch.profiler`` window
over decode steps [A, B), its trace written under ``--profile-dir``; the
sinks are installed after the parity baseline, so only the measured serve
is instrumented. The serve report renders through ``obs/render.py``.
``--mesh data,model --mesh-shape 1,2`` serves tensor-parallel over a mesh
of the port's own (``launch/mesh.py``: on one card every position is
``cuda:0``, each holding its own shards); ``--dp`` splits the mesh's data
axis into replicas, one engine each, and ``--check-dp-parity`` also serves
on the single full-mesh engine and fails unless the greedy tokens agree. On
a mesh the weights quantize at the largest group up to 128 that divides
every shard's contraction axis, and the KV cache at the largest group up to
64 that divides a position's KV heads (128 and 64 for llama3.2-3b at
|model| = 2: the groups the kernels take).
Without ``--device`` it runs on the GPU, and raises if there is none.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.models.model import build
from repro_torch.obs import render
from repro_torch.quant.compiler import kv_tier_labels, save_artifact
from repro_torch.serving import chaos
from repro_torch.serving.engine import ServeEngine, resolve_device
from repro_torch.serving.pool import PagedConfig
from repro_torch.serving.replica import FailoverConfig, ReplicaServe
from repro_torch.serving.quantized import plan_for_variant
from repro_torch.serving.scheduler import SLOConfig, synthetic_stream
from repro_torch.serving.session import DegradeConfig
from repro_torch.serving.spec import SpecConfig
from repro_torch.train.loop import train


def mesh_groups(cfg, t: int, group: int = 128,
                kv_group: int = 64) -> tuple[int, int]:
    """The weight and KV groups a model axis of ``t`` lets each position
    hold whole: the largest divisors of ``group`` / ``kv_group`` that
    divide every shard's contraction axis (d_model, the heads' H * hd / t,
    d_ff / t) and a position's KV heads (Hkv / t * hd)."""
    ks = (cfg.d_model, cfg.num_heads * cfg.head_dim // t, cfg.d_ff // t)
    for k in ks:
        group = math.gcd(group, k)
    return group, math.gcd(kv_group, cfg.num_kv_heads // t * cfg.head_dim)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut the config's depth to N layers at its full "
                         "width (0: the config's own depth)")
    ap.add_argument("--variant", default="4bit/8bit",
                    choices=["raw", "4bit", "8bit", "8bit-mixed", "4bit/8bit",
                             "ternary/4bit"])
    ap.add_argument("--fast", action="store_true",
                    help="FastEWQ metadata plan instead of entropy analysis")
    ap.add_argument("--kv-precision", default=None,
                    choices=["bf16", "int8", "int4", "auto"],
                    help="default: int8, or the policy stamped into "
                         "--plan-artifact; an explicit value overrides it")
    ap.add_argument("--plan-artifact", default=None,
                    help="compiled-plan artifact dir: boot from it when it "
                         "holds one, else compile the plan and save it there")
    ap.add_argument("--train-steps", type=int, default=30,
                    help="brief training so weights are non-degenerate "
                         "(0: plan the seeded init)")
    ap.add_argument("--batch", type=int, default=4,
                    help="training batch (with --train-steps)")
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--arrival-rate", type=float, default=0.0)
    ap.add_argument("--max-seq", type=int, default=0,
                    help="cache depth per slot (0: prompt + 1.25 x max-new)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft tokens per round "
                         "(0 disables; the all-int4 draft is derived from "
                         "the plan and shares payloads with the target)")
    ap.add_argument("--spec-draft", default="model",
                    choices=("model", "ngram"),
                    help="with --spec-k: 'model' drafts with the int4 "
                         "self-draft; 'ngram' proposes by prompt lookup")
    ap.add_argument("--paged", action="store_true",
                    help="serve K/V from a paged pool with copy-on-write "
                         "prefix sharing instead of contiguous per-slot "
                         "reservations")
    ap.add_argument("--page-size", type=int, default=64,
                    help="tokens per KV page (with --paged)")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="physical pages in the pool (0: equal-memory "
                         "default, num_slots * ceil(max_seq/page_size))")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="with --paged: disable the prefix cache")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="overwrite the first N prompt tokens of every "
                         "request with a common prefix (exercises prefix "
                         "sharing)")
    # chunked prefill and SLO scheduling
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill prompts in N-token chunks between decode "
                         "chunks instead of whole at admission (0: off)")
    ap.add_argument("--poisson", action="store_true",
                    help="seeded exponential inter-arrival gaps with mean "
                         "1/--arrival-rate (open-loop load) instead of "
                         "fixed spacing")
    ap.add_argument("--priorities", default=None,
                    help="comma-separated priority cycle over the stream "
                         "(0 = most urgent), e.g. 0,1,1,1")
    ap.add_argument("--ttft-target-ms", type=float, default=0.0,
                    help="SLO: queued requests past this bypass the "
                         "admission gate (0: unset)")
    ap.add_argument("--tpot-target-ms", type=float, default=0.0,
                    help="SLO: defer admissions while the rolling decode "
                         "latency per token exceeds this (0: unset)")
    ap.add_argument("--preempt", action="store_true",
                    help="let a strictly-higher-priority waiter evict the "
                         "lowest-priority decoding slot (it requeues)")
    ap.add_argument("--queue-timeout-steps", type=int, default=0,
                    help="drop requests still queued after N decode steps "
                         "(finish_reason 'timeout'; 0: never)")
    ap.add_argument("--deadline-steps", type=int, default=0,
                    help="abort requests, queued or running, N decode "
                         "steps after arrival (finish_reason 'deadline'; "
                         "0: never)")
    ap.add_argument("--chaos", default=None,
                    help="comma-separated fault-injection shorthands "
                         "(serving/chaos.py): replica_fault, "
                         "replica_transient, oom, stall, artifact; "
                         "deterministic under --chaos-seed")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed of the chaos injector's fault schedule")
    ap.add_argument("--degrade-policy", default="off", choices=["off", "ewq"],
                    help="graceful degradation under pool pressure: 'ewq' "
                         "spills KV precision down the entropy-ordered "
                         "tier ladder instead of rejecting work, and "
                         "promotes back when headroom returns (requires "
                         "--paged)")
    ap.add_argument("--watchdog-ms", type=float, default=0.0,
                    help="decode-gap deadline; overruns count as "
                         "watchdog_trips (0: off)")
    ap.add_argument("--check-chaos-parity", action="store_true",
                    help="with --chaos: serve fault-free first, then the "
                         "chaos serve, and fail unless every request "
                         "completes with the same greedy tokens")
    # serving telemetry (repro_torch.obs)
    ap.add_argument("--trace-out", default=None,
                    help="write the serve's request and engine spans as "
                         "Chrome trace_event JSON (Perfetto / "
                         "chrome://tracing)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the serve's metrics registry as Prometheus "
                         "text exposition (and a .json snapshot beside it)")
    ap.add_argument("--profile-steps", default=None,
                    help="A:B: a torch.profiler window over decode steps "
                         "[A, B) and device fences (CUDA events) around "
                         "each decode chunk (device vs host-gap split)")
    ap.add_argument("--profile-dir", default=None,
                    help="folder of the --profile-steps trace (default: "
                         "repro_torch-profile under the temporary folder)")
    # mesh-parallel serving
    ap.add_argument("--mesh", default=None,
                    help="comma-separated mesh axis names (e.g. data,model): "
                         "shard weights/caches and serve mesh-parallel")
    ap.add_argument("--mesh-shape", default=None,
                    help="comma-separated per-axis device counts (e.g. 1,8); "
                         "default puts every device on the last axis")
    ap.add_argument("--dp", action="store_true",
                    help="serve DP x TP: split the mesh's data axis into "
                         "replicas, one engine each, and route the request "
                         "stream load-aware across them")
    ap.add_argument("--check-dp-parity", action="store_true",
                    help="with --dp: also serve on the single full-mesh "
                         "engine and assert token-identical greedy output")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    if args.poisson and not args.arrival_rate:
        raise SystemExit("--poisson requires --arrival-rate > 0")
    if args.mesh_shape and not args.mesh:
        raise SystemExit("--mesh-shape requires --mesh")
    if args.dp and args.num_requests < 1:
        raise SystemExit("--dp serves a request stream; set --num-requests")
    if args.dp and not args.mesh:
        raise SystemExit("--dp requires --mesh with a data axis >= 2 "
                         "(e.g. --mesh data,model --mesh-shape 2,4)")
    if args.check_dp_parity and not args.dp:
        raise SystemExit("--check-dp-parity requires --dp")
    if args.check_chaos_parity and not args.chaos:
        raise SystemExit("--check-chaos-parity requires --chaos")
    if args.degrade_policy != "off" and not args.paged:
        raise SystemExit("--degrade-policy trades KV precision for pool "
                         "pages; it requires --paged")
    if args.num_requests < 1 and (args.trace_out or args.metrics_out
                                  or args.profile_steps):
        raise SystemExit("--trace-out/--metrics-out/--profile-steps "
                         "instrument the serve loop; set --num-requests")
    # a malformed window fails here, before any model is built
    prof = (obs.ProfileHooks.parse(args.profile_steps,
                                   trace_dir=args.profile_dir)
            if args.profile_steps else None)
    degrade = DegradeConfig() if args.degrade_policy == "ewq" else None
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    model = build(cfg)
    spec = (SpecConfig(k=args.spec_k, draft_source=args.spec_draft)
            if args.spec_k > 0 else None)
    max_seq = args.max_seq or (args.prompt_len + int(args.max_new * 1.25) + 1
                               + args.spec_k)   # verify-window headroom
    paged = (PagedConfig(page_size=args.page_size,
                         pool_pages=args.pool_pages or None,
                         prefix_sharing=not args.no_prefix_sharing)
             if args.paged else None)
    kw = dict(max_seq=max_seq, spec=spec, paged=paged, device=device)
    mesh, subs, group, kv_group = None, None, 128, None
    if args.mesh:
        from repro_torch.launch.mesh import parse_mesh, split_data_replicas
        from repro_torch.sharding.specs import position_grid
        mesh = parse_mesh(args.mesh, args.mesh_shape,
                          devices=None if device.type == "cuda"
                          else [device])
        print(f"mesh: {dict(mesh.shape)} over {len(mesh.device_set)} "
              f"devices")
        group, kv_group = mesh_groups(cfg, position_grid(mesh).shape[1])
        if args.dp:
            subs = split_data_replicas(mesh)
            if len(subs) < 2:
                raise SystemExit(f"--dp found {len(subs)} replica(s) in "
                                 f"mesh {dict(mesh.shape)}; need a data "
                                 "axis of size >= 2")
    kw["kv_group"] = kv_group
    boot_s = None
    if args.plan_artifact and ckpt.is_artifact(args.plan_artifact):
        # cold boot: quantized weights straight from the artifact
        t0 = time.perf_counter()
        if args.kv_precision is not None:
            kw["kv_precision"] = args.kv_precision

        def make_engine(m):
            return ServeEngine.from_artifact(model, args.plan_artifact,
                                             mesh=m, **kw)

        engine = make_engine(mesh)
        boot_s = time.perf_counter() - t0
        print(f"booted from artifact {args.plan_artifact} in {boot_s:.2f} s")
    else:
        if args.train_steps > 0:
            run = RunConfig(steps=args.train_steps, learning_rate=1e-3,
                            warmup_steps=3, remat=False, seed=args.seed)
            t0 = time.perf_counter()
            result = train(cfg, run, batch=args.batch,
                           seq=args.prompt_len * 2, device=device,
                           log_fn=lambda line: None)
            params = result["params"]
            result = None                   # the optimizer state goes
            print(f"trained {args.train_steps} steps [{time.perf_counter() - t0:.2f} s]")
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(args.seed)
            params = model.init(gen, device)
        t0 = time.perf_counter()
        plan = plan_for_variant(model, params, args.variant, fast=args.fast)
        if plan is not None:
            print(f"plan ({args.variant}): {plan.counts()}  "
                  f"[{time.perf_counter() - t0:.2f} s]")
        kv_precision = args.kv_precision or "int8"
        if plan is not None and args.plan_artifact:
            compiled = model.compile_plan(params, plan, group,
                                          kv_precision=kv_precision,
                                          kv_group=kv_group or 64)

            def make_engine(m):
                eng = ServeEngine(model, compiled.params,
                                  kv_precision=compiled.kv_plan or "bf16",
                                  mesh=m, **kw)
                eng.plan = plan
                return eng

            engine = make_engine(mesh)
            if spec is not None and spec.draft_source == "model":
                # stamp the draft so a cold boot re-derives the same one
                compiled.draft = engine._ensure_draft().to_manifest()
            path = save_artifact(args.plan_artifact, compiled, mesh=mesh)
            print(f"saved compiled plan artifact to {path}")
        else:
            def make_engine(m):
                return ServeEngine(model, params, plan=plan, group=group,
                                   kv_precision=kv_precision, mesh=m, **kw)

            engine = make_engine(mesh)
    replica = None
    if subs is not None:
        replica = ReplicaServe([make_engine(m) for m in subs])
    params = compiled = None
    priorities = (tuple(int(p) for p in args.priorities.split(","))
                  if args.priorities else None)
    reqs = synthetic_stream(args.num_requests, vocab_size=cfg.vocab_size,
                            prompt_len=args.prompt_len,
                            max_new_tokens=args.max_new,
                            arrival_rate=args.arrival_rate, seed=args.seed,
                            poisson=args.poisson, priorities=priorities)
    for r in reqs:
        r.queue_timeout_steps = args.queue_timeout_steps or None
        r.deadline_steps = args.deadline_steps or None
    slo = None
    if args.ttft_target_ms or args.tpot_target_ms or args.preempt:
        slo = SLOConfig(
            ttft_target_s=(args.ttft_target_ms / 1e3
                           if args.ttft_target_ms else None),
            tpot_target_s=(args.tpot_target_ms / 1e3
                           if args.tpot_target_ms else None),
            preempt=args.preempt)
    if cfg.family == "encdec":
        rng = np.random.RandomState(args.seed + 2)
        for r in reqs:
            r.frames = rng.standard_normal(
                (cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if args.shared_prefix_len > 0:
        if args.shared_prefix_len >= args.prompt_len:
            raise SystemExit("--shared-prefix-len must be shorter than "
                             "--prompt-len")
        shared = reqs[0].prompt[:args.shared_prefix_len].copy()
        for r in reqs:
            r.prompt[:args.shared_prefix_len] = shared
    serve_kw = dict(num_slots=args.num_slots, chunk=args.chunk,
                    prefill_chunk=args.prefill_chunk or None, slo=slo,
                    watchdog_s=(args.watchdog_ms / 1e3 if args.watchdog_ms
                                else None))
    base = None
    if args.check_chaos_parity:
        # the fault-free baseline first, at tier 0 (no degradation): each
        # serve builds a fresh state and pool
        base, _ = engine.serve(reqs, **serve_kw)
    injector = None
    if args.chaos:
        injector = chaos.ChaosInjector(chaos.FaultConfig.parse(
            args.chaos, seed=args.chaos_seed))
        chaos.install(injector)
        print(f"chaos: injecting {args.chaos} (seed {args.chaos_seed})")
    # the sinks go in after the parity baseline, so only the measured
    # serve is instrumented, and come out however it ends
    tracer = obs.Tracer() if args.trace_out else None
    metrics_reg = obs.MetricsRegistry() if args.metrics_out else None
    obs_on = bool(tracer or metrics_reg or prof)
    if obs_on:
        obs.install(tracer, metrics_reg, prof)
    t0 = time.perf_counter()
    rstats = None
    try:
        if replica is not None:
            # as the reference: chaos or a watchdog under --dp arm the
            # replicas' failover (the watchdog per replica)
            failover = (FailoverConfig(watchdog_s=serve_kw["watchdog_s"])
                        if args.chaos or args.watchdog_ms else None)
            outs, rstats = replica.serve(
                reqs, degrade=degrade, failover=failover,
                **{k: v for k, v in serve_kw.items() if k != "watchdog_s"})
            stats = rstats.aggregate
        else:
            outs, stats = engine.serve(reqs, degrade=degrade, **serve_kw)
    finally:
        if injector is not None:
            chaos.install(None)
        if obs_on:
            if prof is not None:
                prof.stop()
            obs.install(None, None, None)
    serve_s = time.perf_counter() - t0
    for line in render.serve_report(
            stats, wall_s=serve_s, num_requests=len(outs), chunk=args.chunk,
            queueing=bool(args.arrival_rate or slo is not None),
            prefill_chunk=args.prefill_chunk,
            fault=bool(args.chaos or degrade is not None
                       or args.watchdog_ms),
            chaos_fired=injector.log if injector is not None else None,
            spec=spec is not None,
            replicas=(dict(replicas=rstats.replicas,
                           mesh_shape=dict(replica.engines[0].mesh.shape),
                           assignments=rstats.assignments,
                           occupancy=rstats.occupancy_per_replica)
                      if rstats is not None else None),
            paged=(dict(num_slots=args.num_slots,
                        kv_bytes_per_slot=engine.kv_bytes_per_slot(),
                        max_seq=max_seq) if paged is not None else None)):
        print(line)
    if tracer is not None:
        tracer.write(args.trace_out)
        print(f"trace: {len(tracer.events)} events -> {args.trace_out} "
              f"({len(tracer.open_spans())} open spans)")
    if metrics_reg is not None:
        metrics_reg.write_prometheus(args.metrics_out)
        metrics_reg.write_json(args.metrics_out + ".json")
        print(f"metrics: {len(metrics_reg.names())} families -> "
              f"{args.metrics_out} (+ .json snapshot)")
    if prof is not None and prof.windows:
        print(f"profiler: {prof.windows} capture window(s) -> "
              f"{', '.join(prof.trace_files)}")
    reasons: dict = {}
    for o in outs:
        reasons[o.finish_reason] = reasons.get(o.finish_reason, 0) + 1
    report = dict(arch=cfg.name, device=str(device), variant=args.variant,
                  layers=cfg.num_layers,
                  kv_plan=(list(engine.kv_plan.precisions)
                           if engine.kv_plan is not None else "bf16"),
                  requests=len(outs), generated=stats.generated_tokens,
                  tokens_per_s=stats.tokens_per_s,
                  ttft_mean_s=stats.ttft_mean_s,
                  ttft_p50_s=stats.ttft_p50_s, ttft_p95_s=stats.ttft_p95_s,
                  tpot_p50_s=stats.tpot_p50_s, tpot_p95_s=stats.tpot_p95_s,
                  queue_delay_p50_s=stats.queue_delay_p50_s,
                  queue_delay_p95_s=stats.queue_delay_p95_s,
                  decode_gap_p95_s=stats.decode_gap_p95_s,
                  decode_gap_max_s=stats.decode_gap_max_s,
                  prefill_chunks=stats.prefill_chunks,
                  preemptions=stats.preemptions, timeouts=stats.timeouts,
                  cancelled=stats.cancelled, finish_reasons=reasons,
                  weight_bytes=engine.weight_bytes(),
                  kv_bytes_per_slot=engine.kv_bytes_per_slot(),
                  kv_bytes_by_field=engine.kv_bytes_by_field(),
                  state_bytes_by_field=engine.state_bytes_by_field())
    if boot_s is not None:
        report.update(artifact_boot_s=boot_s)
    if mesh is not None:
        report.update(mesh=dict(mesh.shape), weight_group=group,
                      weight_bytes_per_device=engine.weight_bytes_per_device())
    if args.check_dp_parity:
        ref_out, _ = engine.serve(reqs, **serve_kw)
        agree = (len(ref_out) == len(outs)
                 and all(a.rid == b.rid and np.array_equal(a.tokens, b.tokens)
                         for a, b in zip(ref_out, outs)))
        print(f"greedy-agree vs single full-mesh engine: {float(agree):.1f}")
        report.update(greedy_agree_with_full_mesh=agree)
    if degrade is not None or injector is not None or args.watchdog_ms:
        report.update(degrade_transitions=stats.degrade_transitions,
                      kv_tier_steps=stats.kv_tier_steps,
                      kv_tier_labels=kv_tier_labels(
                          engine.degrade_ladder() if degrade is not None
                          else [engine.kv_plan]),
                      degraded_steps=stats.degraded_steps,
                      watchdog_trips=stats.watchdog_trips,
                      chaos_fired=(injector.log if injector is not None
                                   else []))
    if base is not None:
        agree = len(base) == len(outs) and all(
            a.rid == b.rid and np.array_equal(a.tokens, b.tokens)
            for a, b in zip(base, outs))
        report.update(greedy_agree_with_fault_free=agree)
    if paged is not None:
        report.update(page_size=paged.page_size,
                      pool_pages=stats.pool_pages_total,
                      pool_pages_peak=stats.pool_pages_peak,
                      prefix_hits=stats.prefix_hits,
                      prefix_hit_tokens=stats.prefix_hit_tokens,
                      cow_copies=stats.cow_copies, requeues=stats.requeues,
                      kv_bytes_peak=stats.kv_bytes_peak)
    if prof is not None:
        report.update(profile_windows=prof.windows,
                      profile_traces=list(prof.trace_files),
                      device_time_p50_s=stats.registry.quantile(
                          "serve_device_time_seconds", 50),
                      host_gap_p50_s=stats.registry.quantile(
                          "serve_host_gap_seconds", 50))
    if spec is not None:
        report.update(spec_k=spec.k, spec_draft=spec.draft_source,
                      spec_rounds=stats.spec_rounds,
                      acceptance_rate=stats.acceptance_rate,
                      tokens_per_round=stats.tokens_per_round,
                      draft_overhead_bytes=engine.draft_overhead_bytes())
    for k, v in report.items():
        print(f"{k}: {v}")
    if base is not None and not report["greedy_agree_with_fault_free"]:
        raise SystemExit("the chaos serve's greedy output differs from the "
                         "fault-free serve's (or requests were lost)")
    if args.check_dp_parity and not report["greedy_agree_with_full_mesh"]:
        raise SystemExit("DP x TP greedy output DIVERGED from the single "
                         "full-mesh engine")
    return report


if __name__ == "__main__":
    main()
