"""Time K7 on the training path (the forward that a training step runs
under grad, then its backward) of the ``repro_torch`` package under
``--src`` on one CUDA card, in bf16 at three shapes: phi-tiny-moe's
training shape (8,192 tokens routed top-2 over 16 experts by a random
router, C 1,280, d 2,304, f 915, one expert tokenless), qwen2-moe's width
(512 tokens top-4 over 64 experts, f 1,408) and DBRX's (16 tokens top-4
over 16 experts, C 5, f 10,752).  Each shape's inputs come from one seed,
so two trees see the same tensors.

A tree with a training forward (``moe_ffn_train``) is timed on it and on
the backward that reads what it saved (``moe_ffn_bwd_saved``); an older
tree on ``moe_ffn`` (its decode kernels, what its training step ran) and
``moe_ffn_bwd`` (which recomputes h and g).  Each tree's forward and
gradient are first held to ``moe_ffn_plain`` and ``moe_ffn_bwd_plain``
(``chip_smoke.py``'s tolerances).

One rule for every tree: a call's device time comes from a profiler trace
of ``ITERS`` calls in which every row ran a whole number of times a call
(``whole_trace`` of the tree's own ``chip_smoke.py``, the same in every
tree since it came), every row of the call counted.  Prints one JSON line:
per shape and direction the rows, their sum and one bound for every tree
(6 flops a routed row per (d, f) pair forward, 12 backward, over the bf16
rate; bytes: xd and the output, A, h and g once, the weights of the
experts holding a token, the backward's dout and three weight gradients
of every expert).  Run for two checkouts in one call (each whole: the
tool reads the ``chip_smoke.py`` beside its ``src``), it holds their
kernels side by side on the same inputs:

    python3 tools/time_moe_train.py                      # this checkout's src
    python3 tools/time_moe_train.py --src other/checkout/src
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ITERS = 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    src = Path(ap.parse_args().src).resolve()
    sys.path.insert(0, str(src))
    # imported first, so that chip_smoke's imports bind this tree's package
    import repro_torch
    assert Path(repro_torch.__file__).resolve().is_relative_to(src)
    sys.path.insert(0, str(src.parent))
    import chip_smoke as cs
    assert Path(cs.__file__).resolve().parent == src.parent
    import torch

    if not torch.cuda.is_available():
        print("time_moe_train: no CUDA card visible", file=sys.stderr)
        return 2
    mops = cs.mops
    train = hasattr(mops, "moe_ffn_train")
    shapes = [("phi-tiny-moe training shape", "phi-tiny-moe", 8192, (0,)),
              ("qwen2-moe width", "qwen2-moe", 512, ()),
              ("dbrx-132b width", cs.DBRX, 16, ())]
    out = dict(src=str(src), card=cs.card_line(),
               forward="moe_ffn_train" if train else "moe_ffn",
               backward="moe_ffn_bwd_saved" if train else "moe_ffn_bwd")
    bf16 = torch.bfloat16
    for i, (label, arch, tokens, tokenless) in enumerate(shapes):
        cfg = cs.get_config(arch)
        mc, act = cfg.moe, cfg.activation
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 50 + i)
        xd = cs.dispatch_buffer(cfg, tokens, gen)[0]
        xd[list(tokenless)] = 0
        w = cs.expert_weights(mc.num_experts, cfg.d_model, mc.d_ff_expert,
                              bf16, gen)
        dout = torch.randn(xd.shape, generator=gen, device="cuda").to(bf16)
        dout[(xd == 0).all(-1)] = 0

        if train:
            def fwd():
                return mops.moe_ffn_train(xd, *w, activation=act)

            saved = fwd()[1]

            def bwd():
                return mops.moe_ffn_bwd_saved(saved, dout, activation=act)
        else:
            saved = None

            def fwd():
                return mops.moe_ffn(xd, *w, activation=act)

            def bwd():
                return mops.moe_ffn_bwd(xd, *w, dout, activation=act)

        got = fwd()[0] if train else fwd()
        ref = mops.moe_ffn_plain(xd, *w, act)
        torch.testing.assert_close(got.float(), ref.float(),
                                   **cs.MOE_TOL[bf16])
        fwd_err = cs._max_err(got, ref)
        bwd_err = max(cs.hold_moe_bwd(
            bwd(), mops.moe_ffn_bwd_plain(xd, *w, dout, act), bf16))
        del got, ref
        e, c, d = xd.shape
        f = w[0].shape[-1]
        empty = (xd == 0).all(-1)
        rows, filled = int((~empty).sum()), int((~empty).any(1).sum())
        fwd_bound = cs.cost_bound(mops.moe_ffn_train_cost(
            e, c, d, f, 2, rows=rows, experts=filled))
        bwd_bound = cs.cost_bound(mops.moe_ffn_bwd_cost(
            e, c, d, f, 2, saved=True, rows=rows, experts=filled))
        entry = dict(E=e, C=c, d=d, f=f, rows=rows, experts_with_token=filled)
        for name, fn, err, (bound_ms, bound_by) in (
                ("forward", fwd, fwd_err, fwd_bound),
                ("backward", bwd, bwd_err, bwd_bound)):
            trace = cs.whole_trace(fn, ITERS)
            ms = sum(t for _, _, t in trace)
            entry[name] = dict(
                rows=[(n[:70], k, t) for n, k, t in trace], ms=ms,
                max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by)
        out[label] = entry
        del xd, w, dout, saved
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
