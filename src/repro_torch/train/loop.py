"""Training loop: the fused step, the data pipeline and checkpointing, as
``repro.train.loop`` runs them, on one device."""
from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticCorpus, make_batches
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.optim import adamw_init, train_step


def cosine_lr(step: int, *, base: float, warmup: int, total: int,
              floor_frac: float = 0.1) -> float:
    if step < warmup:
        return base * (step + 1) / warmup
    t = (step - warmup) / max(total - warmup, 1)
    return base * (floor_frac + (1 - floor_frac) * 0.5 * (1 + np.cos(np.pi * t)))


def train(cfg: ModelConfig, *, steps: int, batch: int, seq_len: int,
          lr: float = 3e-4, seed: int = 0, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 200, log_every: int = 10,
          resume: Optional[str] = None, device="cuda"):
    """Train ``cfg`` from weights drawn on ``device`` by a generator seeded
    with ``seed`` (not the JAX package's draws) on the synthetic corpus of
    the same seed.  Returns (params, opt_state, history)."""
    dev = resolve_device(device)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           dev)
    opt = adamw_init(params)
    start_step = 0
    if resume:
        params, opt, start_step = restore_checkpoint(resume, params, opt)

    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seed=seed)
    batches = make_batches(corpus, batch, seq_len)
    for _ in range(start_step):      # resume: fast-forward the data stream
        next(batches)
    history = []
    t0 = time.time()
    tokens_seen = 0
    for step in range(start_step, steps):
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(batches).items()}
        cur_lr = cosine_lr(step, base=lr, warmup=min(100, steps // 10 + 1),
                           total=steps)
        params, opt, metrics = train_step(params, opt, b, cfg, lr=cur_lr)
        tokens_seen += batch * seq_len
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            rec = dict(step=step, lr=cur_lr, tok_s=tokens_seen / max(dt, 1e-9),
                       **m)
            history.append(rec)
            print(f"step {step:5d}  loss {m['loss']:.4f}  nll {m['nll']:.4f}  "
                  f"gnorm {m['grad_norm']:.2f}  lr {cur_lr:.2e}  "
                  f"{rec['tok_s']:.0f} tok/s", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(Path(ckpt_dir) / f"step_{step+1:06d}.npz",
                            params, opt, step + 1)
    if ckpt_dir:
        save_checkpoint(Path(ckpt_dir) / "final.npz", params, opt, steps)
    return params, opt, history
