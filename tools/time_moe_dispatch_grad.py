"""Time one MoE layer's gradient at phi-tiny-moe's width on one CUDA card,
two ways on the same inputs: with the dispatch gather and the combine
taking each other as their gradient (``models/moe.py``'s
``_DispatchGather`` and ``_SumSlots``, what training runs), and with
autograd's own backward of the plain indexing (the two Functions swapped
for their forwards, as the layer was before them).

One layer: a random router and 16 experts of width 915 (K7's forward and
backward kernels), 8,192 bf16 tokens routed top-2 at capacity factor
1.25, the gradient of ``sum(y * ct)`` with respect to x and the layer's
weights.  A call's device time comes from a profiler trace of ``ITERS``
gradients (``chip_smoke.whole_trace``), split into the indexing
backward's rows (every row whose name holds ``indexing_backward``) and
the rest.  Prints the card and one JSON line: per way the device ms of a
gradient and of its indexing-backward rows, and whether the two ways'
gradients are the same bits:

    python3 tools/time_moe_dispatch_grad.py
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ITERS = 3


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("time_moe_dispatch_grad: no CUDA card visible", file=sys.stderr)
        return 2
    moe = cs.MOE
    cfg = cs.get_config("phi-tiny-moe")
    mc, d = cfg.moe, cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 13)
    p = {"router": torch.randn((d, mc.num_experts), generator=gen,
                               device="cuda") * 0.02}
    p.update(zip(("wi", "wg", "wo"), cs.expert_weights(
        mc.num_experts, d, mc.d_ff_expert, torch.bfloat16, gen)))
    x = torch.randn((1, 8192, d), generator=gen, device="cuda").bfloat16()
    ct = torch.randn(x.shape, generator=gen, device="cuda")

    def grads():
        leaves = [t.detach().requires_grad_() for t in (x, *p.values())]
        y, _, _ = moe.moe_layer(leaves[0], dict(zip(p, leaves[1:])), cfg)
        return torch.autograd.grad(torch.sum(y.float() * ct), leaves)

    out = dict(card=cs.card_line(), tokens=x.shape[1], E=mc.num_experts,
               top_k=mc.top_k, d=d, f=mc.d_ff_expert)
    runs = {}
    for way in ("gathers", "autograd index backward"):
        if way != "gathers":     # their forwards, and autograd's backward
            moe._DispatchGather.apply = staticmethod(
                lambda xt, st, pt: moe._gather_slots(xt, st))
            moe._SumSlots.apply = staticmethod(
                lambda rows, pt: moe._sum_slots(rows, pt))
        try:
            runs[way] = grads()
            rows = cs.whole_trace(grads, ITERS)
        finally:
            for fn in (moe._DispatchGather, moe._SumSlots):
                if "apply" in vars(fn):
                    del fn.apply
        out[way] = dict(
            device_ms=sum(ms for _, _, ms in rows),
            indexing_backward_ms=sum(ms for n, _, ms in rows
                                     if "indexing_backward" in n))
    out["same_bits"] = all(torch.equal(a, b) for a, b in
                           zip(*runs.values()))
    print(f"card: {out['card']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
