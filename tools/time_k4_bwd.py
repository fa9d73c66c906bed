"""Time K4's backward (``prefill_attention_bwd``) of the ``repro_torch``
package under ``--src`` on one CUDA card, at three bf16 shapes: danube's
training sequence (8,192 tokens, 32 / 8 heads of 120, window 4,096),
yi-6b's heads (32 / 4 of 128) at 2,048 tokens, and Llama-4's heads (40 / 8
of 128) across its 8,192-token attention chunk (8,800 tokens).  Each
shape's inputs come from one seed, so two trees see the same tensors, and
each tree's backward is held to ``prefill_attention_bwd_plain`` (the
port's tolerance) before it is timed.

One rule for every tree: a call's device time comes from a profiler trace
of ``ITERS`` calls in which every row ran a whole number of times a call
(a trace that lost rows is taken again, up to three times, and never
used), split into the backward's kernels (every row whose name holds
``flash_bwd``) and the rest.  Prints one JSON line: per shape the kernels'
rows, their sum, the bound (10 hd flops a kept pair over the bf16 rate,
against each operand and gradient moved once) and the TFLOP/s at that
count.  Run for two checkouts in one call, it holds their kernels side by
side on the same inputs:

    python3 tools/time_k4_bwd.py                      # this checkout's src
    python3 tools/time_k4_bwd.py --src other/checkout/src
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
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("time_k4_bwd: no CUDA card visible", file=sys.stderr)
        return 2
    fops = cs.fops
    danube, yi, llama4 = (cs.get_config(a) for a in
                          ("h2o-danube-3-4b", "yi-6b", cs.LLAMA4))
    shapes = [("h2o-danube-3-4b training sequence", danube, 8192,
               dict(sliding_window=danube.sliding_window)),
              ("yi-6b heads", yi, 2048, {}),
              (f"{cs.LLAMA4} heads across its chunk", llama4, 8800,
               dict(attention_chunk=llama4.attention_chunk))]
    out = dict(src=str(src), card=cs.card_line())
    for i, (label, cfg, n, masks) in enumerate(shapes):
        nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 40 + i)
        pos = torch.arange(n, dtype=torch.int32, device="cuda")[None]
        q, k, v, do = (torch.randn((1, n, h, hd), generator=gen,
                                   device="cuda").bfloat16()
                       for h in (nq, nkv, nkv, nq))
        o, lse = fops.prefill_attention_plain(q, k, v, pos, pos,
                                              return_lse=True, **masks)

        def bwd():
            return fops.prefill_attention_bwd(q, k, v, o, lse, do, pos, pos,
                                              **masks)

        got = bwd()
        ref = fops.prefill_attention_bwd_plain(q, k, v, o, lse, do, pos, pos,
                                               **masks)
        err = 0.0
        for g, r in zip(got, ref):
            torch.testing.assert_close(g.float(), r.float(),
                                       **cs.FLASH_TOL[torch.bfloat16])
            err = max(err, cs._max_err(g, r))
        del got, ref
        pairs = int(fops.band_mask(pos, pos, masks.get("sliding_window"),
                                   masks.get("attention_chunk")).sum())
        cost = fops.prefill_attention_bwd_cost(1, n, n, nq, nkv, hd, 2,
                                               pairs=pairs)
        flops = cost.flops
        bound_ms, bound_by = cs.cost_bound(cost)
        rows = cs.whole_trace(  # some row must be the backward's
            bwd, ITERS, want=lambda r: any("flash_bwd" in n for n, _, _ in r))
        kernels = [(name[:70], c, t) for name, c, t in rows
                   if "flash_bwd" in name]
        ms = sum(t for _, _, t in kernels)
        out[label] = dict(tokens=n, heads=[nq, nkv], hd=hd,
                          pairs_per_head=pairs, max_abs_err=err,
                          kernels=kernels, kernels_ms=ms,
                          other_ms=sum(t for _, _, t in rows) - ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          gflop=flops / 1e9, tflops=flops / ms / 1e9)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
