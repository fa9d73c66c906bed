"""Training launcher of the port, on one device.

CPU example (quickstart scale):
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --reduced \
      --steps 200 --batch 8 --seq-len 128 --device cpu

On the card (the default device) every family trains through the
hand-written kernels: attention's forward and backward (K4) and, for a
mixture-of-experts model (phi-tiny-moe, qwen2-moe, Llama-4, DBRX), the
expert FFN's forward and backward (K7):
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi-tiny-moe \
      --steps 5 --batch 1 --seq-len 8192

The JAX launcher's flags, ``--mesh`` included, with ``--device``
(default ``cuda``).  ``--mesh pod|multipod`` trains on the production
mesh (data 16, model 16; or pod 2, data 16, model 16): one process per
rank, started by a launcher that sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` (``torchrun``); each rank holds its
shard of the parameters and moments (``embed_fsdp`` over ``data``;
experts and, tensor-parallel, heads, kv heads, ``ff`` and the vocabulary
over ``model``) and trains its rows, for every family (the
hybrid zamba2-7b and the ssm xlstm-1.3b too), and outside a world of 256
or 512 ranks the mesh refuses.  Smaller meshes are driven from Python
(``repro_torch.launch.mesh.launch``, ``make_rules``, ``train(...,
rules=rules)``).
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
    ap.add_argument("--mesh", choices=["none", "pod", "multipod"],
                    default="none")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU runs only when asked for")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.train.loop import train

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rules = None
    if args.mesh != "none":
        from repro_torch.launch.mesh import (init_world, make_production_mesh,
                                             make_rules)
        init_world("gloo" if args.device == "cpu" else None)
        mesh = make_production_mesh(multi_pod=args.mesh == "multipod")
        rules = make_rules(mesh)
    train(cfg, steps=args.steps, batch=args.batch, seq_len=args.seq_len,
          lr=args.lr, seed=args.seed, rules=rules, ckpt_dir=args.ckpt_dir,
          device=args.device)


if __name__ == "__main__":
    main()
