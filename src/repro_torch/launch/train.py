"""Training launcher of the port, on one device.

CPU example (quickstart scale):
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --reduced \
      --steps 200 --batch 8 --seq-len 128 --device cpu

The JAX launcher's flags, with ``--device`` (default ``cuda``) in place
of ``--mesh``: multi-device training is not ported yet.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU runs only when asked for")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.train.loop import train

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    train(cfg, steps=args.steps, batch=args.batch, seq_len=args.seq_len,
          lr=args.lr, seed=args.seed, ckpt_dir=args.ckpt_dir,
          device=args.device)


if __name__ == "__main__":
    main()
