"""Training launcher of the PyTorch port (one device).

Usage:
  python -m repro_torch.launch.train --arch llama3.2-3b --steps 30 \
      --batch 4 --seq 256            # llama3.2-3b FULL on the GPU
  python -m repro_torch.launch.train --arch olmo-1b --smoke --steps 100 \
      --device cpu
  python -m repro_torch.launch.train --arch llama3.2-3b --smoke --steps 200 \
      --checkpoint-dir ckpt --moment-dtype int8 --device cpu

Weights start from a seeded ``torch.Generator`` init and train on the
deterministic synthetic stream (``data/synthetic.py``); the run ends with
the held-out loss and perplexity (``train/loop.evaluate``).
``--grad-compression`` is stored in the ``RunConfig`` as in the JAX
package, whose single-device train step does not read it either.
Without ``--device`` it runs on the GPU, and raises if there is none.
"""

from __future__ import annotations

import argparse

from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.train.loop import evaluate, train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "linear"])
    ap.add_argument("--moment-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--grad-compression", default=None,
                    choices=[None, "int8_ef"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda; 'cpu' trains on the CPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    # minicpm trains with WSD per its paper
    schedule = "wsd" if args.arch == "minicpm-2b" and \
        args.schedule == "cosine" else args.schedule
    run = RunConfig(steps=args.steps, learning_rate=args.lr,
                    schedule=schedule, moment_dtype=args.moment_dtype,
                    microbatch=args.microbatch,
                    checkpoint_dir=args.checkpoint_dir,
                    checkpoint_every=args.checkpoint_every,
                    grad_compression=args.grad_compression, seed=args.seed,
                    warmup_steps=max(args.steps // 20, 1), remat=False)
    result = train(cfg, run, batch=args.batch, seq=args.seq, device=device)
    ev = evaluate(result["model"], result["params"], batch=args.batch,
                  seq=args.seq)
    print(f"final train loss {result['final_loss']:.4f}; "
          f"eval loss {ev['loss']:.4f} ppl {ev['perplexity']:.2f}")
    return {"run": run, "losses": result["losses"], "eval": ev}


if __name__ == "__main__":
    main()
