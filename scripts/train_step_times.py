"""Where a training step of llama3.2-3b FULL spends its time on one GPU.

    python3 scripts/train_step_times.py        # needs one CUDA card
    python3 scripts/train_step_times.py --profile   # and one profiled step

For f32 and int8 moments in turn, builds the port's train step
(``train/step.make_train_step``: batch 4 x 256, lr 1e-3, warmup 3, no
remat) from the seeded init and runs one warm-up step and then three
timed ones, each in three parts timed with CUDA events on the current
stream: the forward and backward (``compute_grads``), the global norm of
the gradients, and AdamW's in-place update with the clip fused in. It
prints one JSON line per moment dtype (each part's median ms, the step's,
the peak memory) and the card's name and power limit, and writes them to
``chiprun_out/train_step_times.json``. With ``--profile`` one more
step (f32 moments) runs under ``torch.profiler``: the device time of the
kernels grouped by name (the 15 largest, with their launch counts), the
total device time and kernel count, and the host time of the step, in
the same JSON. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def profile_step(torch, step, params, state, cfg, synthetic_batch):
    """One train step under torch.profiler: device ms by kernel name."""
    import time
    from torch.profiler import ProfilerActivity, profile
    batch = synthetic_batch(cfg, batch=4, seq=256, step=99, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for item in prof.key_averages():
        if item.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(item, "self_device_time_total", None)
        if us is None:
            us = item.self_cuda_time_total
        kernels[item.key] = [us / 1e3, item.count]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    total = sum(v[0] for v in kernels.values())
    prof_out = {"host_ms": host_ms, "device_ms": total,
                "kernels": sum(v[1] for v in kernels.values()),
                "top": [{"name": n[:120], "ms": v[0], "launches": v[1],
                         "share": v[0] / total if total else None}
                        for n, v in top]}
    print(json.dumps({k: v for k, v in prof_out.items() if k != "top"}))
    for row in prof_out["top"]:
        print(json.dumps(row))
    return prof_out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("train_step_times: no CUDA device; this run needs one GPU")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.models.model import build
    from repro_torch.optim.adamw import clip_scale, global_norm
    from repro_torch.train.step import make_train_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cfg = get_config("llama3.2-3b")
    model = build(cfg)
    out = {"card": card, "runs": []}
    for moments in ("float32", "int8"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run = RunConfig(steps=30, learning_rate=1e-3, warmup_steps=3,
                        remat=False, moment_dtype=moments)
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
        opt = make_optimizer(run)
        state = opt.init(params)
        step = make_train_step(model, opt, run)
        parts = {"grads": [], "norm": [], "update": [], "step": []}
        for i in range(4):
            batch = synthetic_batch(cfg, batch=4, seq=256, step=i,
                                    device="cuda")
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            (_, metrics), grads = step.compute_grads(params, batch)
            ev[1].record()
            norm = global_norm(grads)
            ev[2].record()
            params, state = opt.update(grads, state, params,
                                       grad_scale=clip_scale(norm, 1.0))
            ev[3].record()
            torch.cuda.synchronize()
            grads = None
            if i == 0:
                continue            # the warm-up step
            if i == 3 and moments == "float32" and "--profile" in sys.argv:
                out["profile"] = profile_step(torch, step, params, state,
                                              cfg, synthetic_batch)
            for name, (a, b) in (("grads", (0, 1)), ("norm", (1, 2)),
                                 ("update", (2, 3)), ("step", (0, 3))):
                parts[name].append(ev[a].elapsed_time(ev[b]))
        row = {"moment_dtype": moments,
               **{f"{k}_ms": float(np.median(v)) for k, v in parts.items()},
               "samples_ms": parts,
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        out["runs"].append(row)
        print(json.dumps({k: v for k, v in row.items()
                          if k != "samples_ms"}), flush=True)
        params = state = step = None
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "train_step_times.json").write_text(
        json.dumps(out, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
