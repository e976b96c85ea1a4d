"""Training launcher: ``python -m repro_torch.launch.train --arch
smollm-135m [--smoke] [--steps N] [--seq N --batch N] [--compress]
[--ckpt-dir DIR] [--device cpu]`` — the reference's ``repro.launch.train``.

Runs on the card unless ``--device cpu`` is given (use ``--smoke``, the
reduced config, there). Weights are random, drawn from a generator seeded
0; the tokens are ``SyntheticLM``'s, seeded 0. Prints one line a logged
step and a last ``done:`` line.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.training.train_loop import TrainConfig, train

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    tcfg = TrainConfig(steps=args.steps, grad_compression=args.compress,
                       ckpt_dir=args.ckpt_dir)
    state, losses, monitor = train(cfg, tcfg, shape, device=args.device)
    first, last = losses[0][1], losses[-1][1]
    print(f"done: loss {first:.4f} -> {last:.4f} "
          f"({len(monitor.events)} straggler events)")


if __name__ == "__main__":
    main()
