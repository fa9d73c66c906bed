"""Time paged decode (K1) and the expert FFN (K7) of the ``repro_torch``
package under ``--src`` on one CUDA card, with ``chip_smoke.py``'s inputs
and timing: K1 at yi-6b's heads over the card-filling pool of
``chip_smoke.card_pool_scenario`` (65,536 slots, 64 short contexts) and
with the same owned slots moved to the table's front, K7 at
qwen2-moe's decode shape (4 rows, C 4) and at a 128-row prefill shape
(C 10).  Each kernel is held to its plain version first.  Prints one JSON
line.  Run for two checkouts in one call, it holds their kernels side by
side on the same inputs:

    python3 tools/time_k1_k7.py                      # this checkout's src
    python3 tools/time_k1_k7.py --src other/checkout/src
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


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
        print("time_k1_k7: no CUDA card visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = dict(src=str(src), card=cs.card_line())

    yi = cs.get_config("yi-6b")
    args = cs.card_pool_scenario(yi, 8)
    kw = dict(scale=yi.resolved_head_dim ** -0.5)
    got = cs.pops.paged_decode_partials(*args, **kw)
    ref = cs.pops.paged_decode_partials_plain(*args, **kw)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)
    del got, ref
    out["k1_card_pool_ms"], _ = cs.time_ms(
        lambda: cs.pops.paged_decode_partials(*args, **kw), 50)
    # the same live rows with the owned slots moved to the table's front:
    # what the rest of the table costs
    q, pk, pv, slot_req, slot_base, q_pos = args
    del args
    order = torch.argsort((slot_req < 0).int(), stable=True)
    packed = (q, pk[order], pv[order], slot_req[order].contiguous(),
              slot_base[order].contiguous(), q_pos)
    del pk, pv
    out["k1_card_pool_packed_ms"], _ = cs.time_ms(
        lambda: cs.pops.paged_decode_partials(*packed, **kw), 50)
    del packed
    torch.cuda.empty_cache()

    # the generator is drawn in check_moe_ffn's order: the same inputs
    moe = cs.get_config("qwen2-moe")
    mc = moe.moe
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)
    w = cs.expert_weights(mc.num_experts, moe.d_model, mc.d_ff_expert,
                          torch.bfloat16, gen)
    for t in (4, 128):
        xd, _, _ = cs.dispatch_buffer(moe, t, gen)
        got = cs.mops.moe_ffn(xd, *w, activation=moe.activation)
        ref = cs.mops.moe_ffn_plain(xd, *w, activation=moe.activation)
        torch.testing.assert_close(got.float(), ref.float(),
                                   **cs.MOE_TOL[torch.bfloat16])
        out[f"k7_{t}_rows_C{xd.shape[1]}_ms"], _ = cs.time_ms(
            lambda: cs.mops.moe_ffn(xd, *w, activation=moe.activation), 50)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
