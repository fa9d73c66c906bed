"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``gpu`` and skips without one; the file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import paged_attention as tpa
from repro_torch.kernels.harvest_copy import ops as hops
from repro_torch.kernels.paged_attention import ops as pops

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _scenario(seed, n_slots, bs, nkv, nq, hd, q_pos, empty_row):
    rng = np.random.default_rng(seed)
    b = len(q_pos)
    s = dict(q=rng.normal(size=(b, nq, hd)),
             pk=rng.normal(size=(n_slots, bs, nkv, hd)),
             pv=rng.normal(size=(n_slots, bs, nkv, hd)))
    s = {k: v.astype(np.float32) for k, v in s.items()}
    slot_req = np.full((n_slots,), -1, np.int32)
    slot_base = rng.integers(0, 64, size=n_slots).astype(np.int32)
    order = iter(rng.permutation(n_slots))
    for r in range(b):
        if r != empty_row:
            for j in range(q_pos[r] // bs + 1):
                slot = next(order)
                slot_req[slot], slot_base[slot] = r, j * bs
    s.update(slot_req=slot_req, slot_base=slot_base,
             q_pos=np.asarray(q_pos, np.int32))
    return s


def _partials(s, cfg, device):
    t = {k: torch.from_numpy(v).to(device) for k, v in s.items()}
    return tpa.pool_partials(t["q"], t["pk"], t["pv"], t["slot_req"],
                             t["slot_base"], t["q_pos"], cfg)


@pytest.mark.parametrize("window,chunk", [(None, None), (12, None),
                                          (None, 16)])
@pytest.mark.parametrize("gq,hd,bs", [(4, 64, 8), (8, 128, 16)])
def test_paged_partials_kernel_matches_plain(cuda, window, chunk, gq, hd,
                                             bs):
    cfg = dataclasses.replace(get_config("yi-6b").reduced(),
                              sliding_window=window, attention_chunk=chunk)
    s = _scenario(11, 16, bs, 2, 2 * gq, hd, (37, 0, 20), empty_row=1)
    before = pops.paged_decode_partials.launches
    got = _partials(s, cfg, cuda)
    torch.cuda.synchronize()
    assert pops.paged_decode_partials.launches == before + 1
    ref = _partials(s, cfg, "cpu")
    for name in ("m", "l", "acc"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(ref, name), rtol=1e-4, atol=1e-4)
    assert torch.all(got.l[1] == 0) and torch.all(got.m[1] == -1e30)


def _pool(seed, n_slots, elems, zero_row=None):
    rng = np.random.default_rng(seed)
    src = (rng.normal(size=(n_slots, elems))
           * rng.uniform(0.01, 30.0, size=(n_slots, 1))).astype(np.float32)
    if zero_row is not None:
        src[zero_row] = 0.0
    return src


@pytest.mark.parametrize("fidelity", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("elems", [37, 262_144])
def test_quant_kernels_bit_identical_to_plain(cuda, fidelity, elems):
    src = _pool(12, 5, elems, zero_row=2)
    ids = np.asarray([2, 4, 0], np.int32)
    tv, ts = hops.quantize_blocks(torch.from_numpy(src), ids,
                                  fidelity=fidelity)
    gv, gs = hops.quantize_blocks(torch.from_numpy(src).to(cuda), ids,
                                  fidelity=fidelity)
    assert torch.equal(gv.cpu().view(torch.uint8), tv.view(torch.uint8))
    assert torch.equal(gs.cpu(), ts)
    dst = _pool(13, 6, elems)
    dst_ids = np.asarray([5, 1, 3], np.int32)
    ref = hops.dequantize_blocks(torch.from_numpy(dst.copy()), tv, ts,
                                 dst_ids, fidelity=fidelity)
    got = hops.dequantize_blocks(torch.from_numpy(dst).to(cuda), gv, gs,
                                 dst_ids, fidelity=fidelity)
    assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))


def test_kernel_wrappers_raise_on_cuda(cuda):
    src = torch.from_numpy(_pool(14, 4, 16)).to(cuda)
    with pytest.raises(IndexError):
        hops.quantize_blocks(src, np.asarray([0, 4], np.int32))
    with pytest.raises(TypeError):
        hops.quantize_blocks(src.double(), np.asarray([0], np.int32))
    v, s = hops.quantize_blocks(src, np.asarray([0, 1], np.int32))
    with pytest.raises(IndexError):
        hops.dequantize_blocks(src, v, s, np.asarray([0, 7], np.int32))
    q = torch.zeros((1, 3, 16), device=cuda)       # gq 3 has no kernel
    pool = torch.zeros((2, 4, 1, 16), device=cuda)
    ids = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pops.paged_decode_partials(q, pool, pool, ids, ids,
                                   ids[:1], scale=0.25)
