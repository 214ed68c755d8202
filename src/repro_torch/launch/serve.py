"""Serve an EWQ-quantized model with the PyTorch port.

    python -m repro_torch.launch.serve --arch llama3.2-3b --variant 4bit/8bit \
        --kv-precision int8 --num-requests 8 --num-slots 4 --chunk 8
    python -m repro_torch.launch.serve --arch llama3.2-3b --smoke --device cpu

Weights are random, drawn from a seeded ``torch.Generator`` at the JAX
package's init scales (real checkpoints are not in the repository), so the
run shows the serving path, its memory and its speed, not model quality.
Without ``--device`` it runs on the GPU, and raises if there is none.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.models.model import build
from repro_torch.serving.engine import ServeEngine, resolve_device
from repro_torch.serving.quantized import plan_for_variant
from repro_torch.serving.scheduler import synthetic_stream


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--variant", default="4bit/8bit",
                    choices=["raw", "4bit", "8bit", "8bit-mixed", "4bit/8bit",
                             "ternary/4bit"])
    ap.add_argument("--fast", action="store_true",
                    help="FastEWQ metadata plan instead of entropy analysis")
    ap.add_argument("--kv-precision", default="int8",
                    choices=["bf16", "int8", "int4", "auto"])
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--arrival-rate", type=float, default=0.0)
    ap.add_argument("--max-seq", type=int, default=0,
                    help="cache depth per slot (0: prompt + 1.25 x max-new)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init(gen, device)
    t0 = time.perf_counter()
    plan = plan_for_variant(model, params, args.variant, fast=args.fast)
    if plan is not None:
        print(f"plan ({args.variant}): {plan.counts()}  "
              f"[{time.perf_counter() - t0:.2f} s]")
    max_seq = args.max_seq or (args.prompt_len + int(args.max_new * 1.25) + 1)
    engine = ServeEngine(model, params, max_seq=max_seq, plan=plan,
                         kv_precision=args.kv_precision, device=device)
    del params
    reqs = synthetic_stream(args.num_requests, vocab_size=cfg.vocab_size,
                            prompt_len=args.prompt_len,
                            max_new_tokens=args.max_new,
                            arrival_rate=args.arrival_rate, seed=args.seed)
    outs, stats = engine.serve(reqs, num_slots=args.num_slots,
                               chunk=args.chunk)
    report = dict(arch=cfg.name, device=str(device), variant=args.variant,
                  kv_precision=args.kv_precision,
                  requests=len(outs), generated=stats.generated_tokens,
                  tokens_per_s=stats.tokens_per_s,
                  ttft_mean_s=stats.ttft_mean_s,
                  weight_bytes=engine.weight_bytes(),
                  kv_bytes_per_slot=engine.kv_bytes_per_slot())
    for k, v in report.items():
        print(f"{k}: {v}")
    return report


if __name__ == "__main__":
    main()
