"""Device rows of the two weight-reading ``torch.einsum`` calls of the port's
decode step that copy their weight before the product, on one CUDA card:
the attention output projection ``bnh,nhd->bd`` (``wo`` of (nq, hd, d),
permuted and cloned each call) in every layer, and the tied-embedding
unembed ``bsd,vd->bsv`` (the (V, d) embedding made contiguous each call)
of command-r-35b.  Each at a full-width model's decode shape (4 rows,
bf16), beside the same product written as one matrix product on views
(``o.reshape(b, nq * hd) @ wo.reshape(nq * hd, d)``, ``x @ embed.T``),
checked equal first.  Prints one line per case and one JSON line:

    python3 tools/probe_einsum_copies.py
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ARCHS = ("yi-6b", "qwen2-moe", "h2o-danube-3-4b", "nemotron-4-15b",
         "command-r-35b", "llama4-maverick-400b-a17b")


def split(rows):
    """(copy ms, other ms) per call of a trace's device rows."""
    copy = sum(t for n, t in rows if "copy" in n or "elementwise" in n)
    return copy, sum(t for _, t in rows) - copy


def main() -> int:
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("probe_einsum_copies: no CUDA card visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out = dict(card=cs.card_line(), cases=[])
    print(f"card: {out['card']}")
    for arch in ARCHS:
        cfg = cs.get_config(arch)
        d, nq, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
        o = torch.randn((4, nq, hd), generator=gen, device="cuda").bfloat16()
        wo = torch.randn((nq, hd, d), generator=gen,
                         device="cuda").bfloat16()
        cases = [("out projection bnh,nhd->bd", wo.numel(),
                  lambda: torch.einsum("bnh,nhd->bd", o, wo),
                  lambda: o.reshape(4, nq * hd) @ wo.reshape(nq * hd, d))]
        if cfg.tie_embeddings:
            x = torch.randn((4, 1, d), generator=gen,
                            device="cuda").bfloat16()
            emb = torch.randn((cfg.vocab_size, d), generator=gen,
                              device="cuda").bfloat16()
            cases.append(("tied unembed bsd,vd->bsv", emb.numel(),
                          lambda: torch.einsum("bsd,vd->bsv", x, emb),
                          lambda: x @ emb.T))
        for label, n_weight, fn, views in cases:
            # the same products summed in another order: one bf16 step of
            # the largest output
            want = views().float()
            step = 2.0 ** -7 * float(want.abs().max())
            torch.testing.assert_close(fn().float(), want, rtol=1.6e-2,
                                       atol=step)
            rows = cs.traced_rows(fn, 20)
            copy_ms, gemm_ms = split(rows)
            view_rows = cs.traced_rows(views, 20)
            vcopy_ms, vgemm_ms = split(view_rows)
            bound_ms = 2 * n_weight / cs.HBM_BYTES_PER_S * 1e3
            print(f"{arch} {label} (weight {2 * n_weight / 1e6:.1f} MB): "
                  f"einsum copy {copy_ms:.5f} + product {gemm_ms:.5f} ms "
                  f"device per call; on views copy {vcopy_ms:.5f} + "
                  f"product {vgemm_ms:.5f}; weight read once "
                  f"{bound_ms:.5f}")
            out["cases"].append(dict(
                arch=arch, case=label, layers=cfg.num_layers,
                einsum_copy_ms=copy_ms, einsum_product_ms=gemm_ms,
                views_copy_ms=vcopy_ms, views_product_ms=vgemm_ms,
                weight_read_ms=bound_ms,
                rows=[(n[:60], t) for n, t in rows]))
        del o, wo, cases
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
