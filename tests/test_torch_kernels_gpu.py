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
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.harvest_copy import ops as hops
from repro_torch.kernels.moe_ffn import ops as mops
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


def _two_pools(seed, bs, nkv, gq, hd, q_pos, alone):
    """Each row's blocks dealt over a local pool and a peer pool, the
    first half of them on the peer but for row ``alone``, which has none
    there; the fetch pool holds every block in the local pool's slots.
    Free slots hold garbage.  Returns q, q_pos and three (pool_k, pool_v,
    slot_req, slot_base) tuples on the card: local, peer, fetch."""
    rng = np.random.default_rng(seed)
    blocks = [(r, j) for r, p in enumerate(q_pos) for j in range(p // bs + 1)]
    n_local, n_peer = len(blocks) + 5, len(blocks) + 5

    def table(n):
        return (rng.normal(size=(n, bs, nkv, hd)).astype(np.float32),
                rng.normal(size=(n, bs, nkv, hd)).astype(np.float32),
                np.full((n,), -1, np.int32),
                rng.integers(0, 64, size=n).astype(np.int32))

    fetch, peer = table(n_local), table(n_peer)
    local_slots = rng.permutation(n_local)
    peer_slots = iter(rng.permutation(n_peer))
    local = None
    moved = []
    for (r, j), slot in zip(blocks, local_slots):
        fetch[2][slot], fetch[3][slot] = r, j * bs
        if r != alone and j < (q_pos[r] // bs + 1) // 2:
            moved.append((slot, next(peer_slots)))
    local = tuple(a.copy() for a in fetch)
    for slot, ps in moved:
        for a in range(4):
            peer[a][ps] = fetch[a][slot]
        local[2][slot] = -1
    q = rng.normal(size=(len(q_pos), nkv * gq, hd)).astype(np.float32)
    dev = [tuple(torch.from_numpy(a).cuda() for a in t)
           for t in (local, peer, fetch)]
    return (torch.from_numpy(q).cuda(),
            torch.from_numpy(np.asarray(q_pos, np.int32)).cuda(), *dev)


@pytest.mark.parametrize("gq,hd,bs", [(1, 64, 16), (8, 128, 8)])
def test_paged_decode_over_two_pools_merged(cuda, gq, hd, bs):
    """K1 as the in-place mode calls it: once over the local pool and once
    over the peer pool, the partials merged by LSE and normalised
    (``paged_decode_attention``), at musicgen-medium's heads (24 / 24 of
    64) and yi-6b's (32 / 4 of 128): two launches, and the result against
    the plain version over the same two pools and against one K1 call
    over the fetch pool that holds every block.  Row 1 has no block on
    the peer: K1 leaves it m -1e30, l 0, acc 0 there, and the merge gives
    its local result unchanged, bit for bit."""
    nkv = 24 if gq == 1 else 4
    cfg = get_config("yi-6b").reduced()
    q, q_pos, local, peer, fetch = _two_pools(
        31, bs, nkv, gq, hd, (70, 33, 129, 5), alone=1)
    before = pops.paged_decode_partials.launches
    got = tpa.paged_decode_attention(q, [local, peer], q_pos, cfg)
    torch.cuda.synchronize()
    assert pops.paged_decode_partials.launches == before + 2
    cpu = lambda t: tuple(a.cpu() for a in t)  # noqa: E731
    ref = tpa.paged_decode_attention(q.cpu(), [cpu(local), cpu(peer)],
                                     q_pos.cpu(), cfg)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)
    one = tpa.paged_decode_attention(q, [fetch], q_pos, cfg)
    torch.testing.assert_close(got, one, rtol=1e-4, atol=1e-4)
    empty = tpa.pool_partials(q, *peer, q_pos, cfg)
    assert torch.all(empty.m[1] == -1e30) and torch.all(empty.l[1] == 0)
    assert torch.all(empty.acc[1] == 0)
    alone = tpa.paged_decode_attention(q, [local], q_pos, cfg)
    assert torch.isfinite(got).all()
    assert torch.equal(got[1], alone[1])


# (name, sliding window, attention chunk, logit softcap)
K1_MASKS = [("causal", None, None, None), ("window", 21, None, None),
            ("chunk", None, 24, None), ("softcap", 37, None, 5.0)]


@pytest.mark.parametrize("mask", K1_MASKS, ids=[m[0] for m in K1_MASKS])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("hd", [64, 120, 128])
@pytest.mark.parametrize("gq", [3, 5, 6, 12, 16])
def test_paged_partials_any_gq(cuda, gq, hd, bs, mask):
    """K1 at GQA groups that are no power of two (3; 5 as in llama-4; 6
    as in dbrx and nemotron; 12) and at 16, the most it takes: the
    register rows past gq hold zero queries and are never written."""
    _, window, chunk, softcap = mask
    cfg = dataclasses.replace(get_config("yi-6b").reduced(),
                              sliding_window=window, attention_chunk=chunk,
                              logit_softcap=softcap)
    s = _scenario(24 + gq, 20, bs, 2, 2 * gq, hd, (70, 0, 33, 9),
                  empty_row=1)
    got = _partials(s, cfg, cuda)
    ref = _partials(s, cfg, "cpu")
    assert got.m.shape == (4, 2, gq) and got.acc.shape == (4, 2, gq, hd)
    for name in ("m", "l", "acc"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(ref, name), rtol=1e-4, atol=1e-4)
    assert torch.all(got.l[1] == 0) and torch.all(got.m[1] == -1e30)
    assert torch.all(got.acc[1] == 0)


@pytest.mark.parametrize("case", ["window", "causal", "rounds",
                                  "card_pool"])
def test_paged_partials_many_splits(cuda, case):
    """Each request's slots split over many blocks and merged by LSE: some
    300 owned slots per request among free slots, an empty request, a
    window that leaves whole owned slots out.  "rounds": a 2,400-slot
    table (past 1,024 slots, so the live-slot bitmap comes from the
    pre-pass) under 1,056 (request, kv head) pairs, one block each, whose
    2,000-slot request is listed and folded in rounds.  "card_pool": short
    contexts scattered over a 12,000-slot table."""
    if case == "rounds":
        b, nkv, gq, hd, bs, n_slots = 33, 32, 1, 64, 8, 2400
        q_pos = (15_999,) + tuple(range(3, 33 * 3, 3))[:b - 2] + (0,)
        window, empty = None, b - 1
    elif case == "card_pool":
        b, nkv, gq, hd, bs, n_slots = 16, 4, 2, 64, 8, 12_000
        q_pos = tuple(np.random.default_rng(32).integers(50, 600, size=b))
        window, empty = 256, 5
    else:
        b, nkv, gq, hd, bs, n_slots = 3, 8, 4, 120, 16, 1000
        q_pos, empty = (4_799, 0, 4_500), 1
        window = 4096 if case == "window" else None
    cfg = dataclasses.replace(get_config("yi-6b").reduced(),
                              sliding_window=window)
    s = _scenario(31, n_slots, bs, nkv, nkv * gq, hd, q_pos, empty_row=empty)
    splits = pops.num_splits(b, nkv, n_slots, pops.sm_count(cuda))
    if case == "rounds":
        assert splits == 1 and (s["slot_req"] == 0).sum() > 1024
    else:
        assert splits > 1
    got = _partials(s, cfg, cuda)
    ref = _partials(s, cfg, "cpu")
    for name in ("m", "l", "acc"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(ref, name), rtol=1e-4, atol=1e-4)
    assert torch.all(got.m[empty] == -1e30) and torch.all(got.l[empty] == 0)
    assert torch.all(got.acc[empty] == 0)


def _pool(seed, n_slots, elems, zero_row=None):
    rng = np.random.default_rng(seed)
    src = (rng.normal(size=(n_slots, elems))
           * rng.uniform(0.01, 30.0, size=(n_slots, 1))).astype(np.float32)
    if zero_row is not None:
        src[zero_row] = 0.0
    return src


# (q heads per kv head, kv heads, attention chunk): Llama-4's 40 / 8 and
# Command-R's 64 / 8 heads at Llama-4's chunk of 8,192, and both groups
# over 2 kv heads at a chunk of 64
K1_CHUNKS = [(5, 8, 8192), (8, 8, 8192), (5, 2, 64), (8, 2, 64)]


@pytest.mark.parametrize("gq,nkv,chunk", K1_CHUNKS,
                         ids=["gq5-8192", "gq8-8192", "gq5-64", "gq8-64"])
def test_paged_partials_across_a_chunk_boundary(cuda, gq, nkv, chunk):
    """K1 with an attention chunk, rows on both sides of the first chunk
    boundary (the chunk's last position, its first, and two past it): the
    chunk mask cuts every slot of the earlier chunk, and the row at the
    boundary keeps one key, its own (l = 1)."""
    cfg = dataclasses.replace(get_config("yi-6b").reduced(),
                              attention_chunk=chunk)
    q_pos = (chunk - 1, chunk, chunk + chunk // 8 + 3, 2 * chunk - 5)
    bs = 16
    n_slots = sum(p // bs + 1 for p in q_pos) + 12
    s = _scenario(41 + gq, n_slots, bs, nkv, nkv * gq, 128, q_pos,
                  empty_row=None)
    got = _partials(s, cfg, cuda)
    ref = _partials(s, cfg, "cpu")
    for name in ("m", "l", "acc"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(ref, name), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.l[1].cpu(), torch.ones((nkv, gq)))


@pytest.mark.parametrize("fidelity", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("elems", [37, 262_144, 737_280, 786_432,
                                   1_048_576])
def test_quant_kernels_bit_identical_to_plain(cuda, fidelity, elems):
    """Three rows, one all zero, at an odd width, the demoted blocks of
    yi-6b, h2o-danube-3-4b and qwen2-moe, and a 4 MiB row."""
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


@pytest.mark.parametrize("fidelity", ["int8", "fp8", "int4"])
def test_quant_kernel_many_rows_bit_identical_to_plain(cuda, fidelity):
    """More rows than half the card's SMs: K2 gives each block a whole row
    (no grid barrier), with odd widths, ragged 4-byte groups and an
    all-zero row among 300 gathered in shuffled order."""
    src = _pool(21, 320, 301, zero_row=7)
    ids = np.random.default_rng(22).permutation(320)[:300].astype(np.int32)
    ids[0] = 7
    tv, ts = hops.quantize_blocks(torch.from_numpy(src), ids,
                                  fidelity=fidelity)
    gv, gs = hops.quantize_blocks(torch.from_numpy(src).to(cuda), ids,
                                  fidelity=fidelity)
    assert torch.equal(gv.cpu().view(torch.uint8), tv.view(torch.uint8))
    assert torch.equal(gs.cpu(), ts)


#: f32 of one block's slice that K2 keeps in shared memory (csrc's
#: kMaxCachedBytes over 4)
K2_CACHED_ELEMS = 57_344


@pytest.mark.parametrize("fidelity", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("m,elems", [(200, 60_001), (3, 3_000_000)])
def test_quant_kernel_rows_past_shared_memory_bit_identical_to_plain(
        cuda, fidelity, m, elems):
    """Slices longer than K2 keeps on chip, whose rest it reads again from
    device memory to quantize: a whole odd row per block (200 rows, no
    exchange, 4-byte loads) and a row spread over the card (3 rows, the
    exchange, bulk copies), each with an all-zero row."""
    lib = hops._kernels()
    nb = lib.quantize_demote_blocks(m, hops.sm_count(cuda))
    assert -(-elems // nb) > K2_CACHED_ELEMS, nb
    src = _pool(25, m + 2, elems, zero_row=m // 2)
    ids = np.random.default_rng(26).permutation(m + 2)[:m].astype(np.int32)
    tv, ts = hops.quantize_blocks(torch.from_numpy(src), ids,
                                  fidelity=fidelity)
    gv, gs = hops.quantize_blocks(torch.from_numpy(src).to(cuda), ids,
                                  fidelity=fidelity)
    assert torch.equal(gv.cpu().view(torch.uint8), tv.view(torch.uint8))
    assert torch.equal(gs.cpu(), ts)


def test_kernel_wrappers_raise_on_cuda(cuda):
    src = torch.from_numpy(_pool(14, 4, 16)).to(cuda)
    with pytest.raises(IndexError):
        hops.quantize_blocks(src, np.asarray([0, 4], np.int32))
    with pytest.raises(TypeError):
        hops.quantize_blocks(src.double(), np.asarray([0], np.int32))
    v, s = hops.quantize_blocks(src, np.asarray([0, 1], np.int32))
    with pytest.raises(IndexError):
        hops.dequantize_blocks(src, v, s, np.asarray([0, 7], np.int32))
    q = torch.zeros((1, 17, 16), device=cuda)      # gq 17: past 16
    pool = torch.zeros((2, 4, 1, 16), device=cuda)
    ids = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pops.paged_decode_partials(q, pool, pool, ids, ids,
                                   ids[:1], scale=0.25)
    q, pool = torch.zeros((1, 2, 18), device=cuda), \
        torch.zeros((2, 4, 1, 18), device=cuda)  # hd 18: no float4 rows
    with pytest.raises(ValueError):
        pops.paged_decode_partials(q, pool, pool, ids, ids,
                                   ids[:1], scale=0.25)


def _quant_round_trip(cuda, dtype, fidelity, m, elems, seed):
    """K2 then K3 on a pool of ``dtype`` against the plain versions on the
    same card tensors, values, scales and pools bit for bit; each wrapper
    launches its kernel once."""
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(_pool(seed, m + 2, elems, zero_row=1)).to(
        dtype).to(cuda)
    ids = rng.permutation(m + 2)[:m].astype(np.int32)
    dst = torch.from_numpy(_pool(seed + 1, m + 3, elems)).to(dtype).to(cuda)
    dids = rng.permutation(m + 3)[:m].astype(np.int32)
    pv, ps = hops.quantize_blocks_plain(src, ids, fidelity)
    before = (hops.quantize_blocks.launches, hops.dequantize_blocks.launches)
    gv, gs = hops.quantize_blocks(src, ids, fidelity=fidelity)
    assert torch.equal(gv.view(torch.uint8), pv.view(torch.uint8))
    assert torch.equal(gs, ps)
    ref = hops.dequantize_blocks_plain(dst.clone(), pv, ps, dids, fidelity)
    got = hops.dequantize_blocks(dst.clone(), gv, gs, dids, fidelity=fidelity)
    torch.cuda.synchronize()
    assert (hops.quantize_blocks.launches, hops.dequantize_blocks.launches) \
        == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("fidelity", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("m,elems", [(3, 37), (3, 737_280), (3, 3_000_000),
                                     (200, 120_001)])
def test_quant_kernels_half_pools_bit_identical_to_plain(cuda, dtype,
                                                        fidelity, m, elems):
    """K2 and K3 on bf16 and f16 pools: an odd width (rows not 16-byte
    aligned: plain loads into shared memory, K3 one weight a thread),
    h2o-danube-3-4b's demoted block, a row spread over the card, and 200
    odd rows of one block each whose slices outgrow the 114,688 2-byte
    elements K2 keeps on chip."""
    _quant_round_trip(cuda, dtype, fidelity, m, elems, 40)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("fidelity", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("m,elems", [(5, 4_096), (hops.IDS_BY_VALUE, 1_000),
                                     (300, 1_024), (300, 301)])
def test_dequantize_ids_in_launch_and_device_table(cuda, dtype, fidelity, m,
                                                   elems):
    """K3 with its row ids in the launch (up to 128 rows, 128 the last)
    and past them from a device table, by whole 16-byte vectors (widths
    4,096 and 1,024) and one weight a thread (rows of packed values not
    16-byte aligned: 1,000 and the odd 301)."""
    _quant_round_trip(cuda, dtype, fidelity, m, elems, 41)


def test_dequantize_device_ids_past_the_launch(cuda):
    """Past 128 rows K3 reads the caller's device ids, with or without a
    host mirror, into the rows they name."""
    m, elems = 200, 64
    src = torch.from_numpy(_pool(42, m, elems)).to(cuda)
    v, s = hops.quantize_blocks(src, np.arange(m, dtype=np.int32))
    dids = np.random.default_rng(43).permutation(m + 10)[:m].astype(np.int32)
    dev = torch.from_numpy(dids).to(cuda)
    ref = hops.dequantize_blocks_plain(torch.zeros((m + 10, elems),
                                                   device=cuda), v, s, dids)
    for mirror in (None, dids):
        got = hops.dequantize_blocks(torch.zeros((m + 10, elems), device=cuda),
                                     v, s, dev, host_ids=mirror)
        assert torch.equal(got, ref)


def test_quant_kernels_refuse_other_pool_dtypes(cuda):
    """f64 (and any pool the kernels do not take) raises TypeError on the
    card for both K2 and K3, before any launch."""
    src = torch.from_numpy(_pool(44, 4, 16)).to(cuda)
    v, s = hops.quantize_blocks(src, np.asarray([0, 1], np.int32))
    launches = (hops.quantize_blocks.launches,
                hops.dequantize_blocks.launches)
    with pytest.raises(TypeError):
        hops.quantize_blocks(src.double(), np.asarray([0], np.int32))
    with pytest.raises(TypeError):
        hops.dequantize_blocks(src.double(), v, s, np.asarray([2, 3]))
    assert launches == (hops.quantize_blocks.launches,
                        hops.dequantize_blocks.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("m", [24, hops.IDS_BY_VALUE, 300])
@pytest.mark.parametrize("elems", [37, 15_360, 16_384])
def test_copy_blocks_ids_in_launch_and_device_table(cuda, dtype, m, elems):
    """K5 with its (src, dst) id pairs in the launch (up to 128 rows) and
    past them from a device table: across two pools and within one pool
    on disjoint rows, rows of 16 and 15 KiB of f32 and an odd row size
    (the narrow vector path), every other row keeping its bytes."""
    rng = np.random.default_rng(45)
    n = 2 * m + 7
    src = torch.from_numpy(rng.normal(size=(n, elems)) * 40).to(dtype)
    dst = torch.from_numpy(rng.normal(size=(n + 3, elems)) * 40).to(dtype)
    sids = rng.permutation(n)[:m].astype(np.int32)
    dids = rng.permutation(n + 3)[:m].astype(np.int32)
    before = hops.copy_blocks.launches
    got = hops.copy_blocks(src.to(cuda), dst.to(cuda), sids, dids)
    torch.cuda.synchronize()
    assert hops.copy_blocks.launches == before + 1
    assert torch.equal(got.cpu(), hops.copy_blocks_plain(src, dst.clone(),
                                                         sids, dids))
    # one pool: the sources the first m of a permutation, the
    # destinations the next m
    perm = rng.permutation(n).astype(np.int32)
    pool = src.to(cuda)
    hops.copy_blocks(pool, pool, torch.from_numpy(perm[:m]).to(cuda),
                     perm[m:2 * m])
    assert torch.equal(pool.cpu(), hops.copy_blocks_plain(
        src, src.clone(), perm[:m], perm[m:2 * m]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("elems", [37, 16_384])
def test_movers_bit_identical_to_plain(cuda, dtype, elems):
    """K6 gather and K5 copy move bytes: any dtype, odd row widths (the
    narrow vector path), the engine's layer-row width (16 KiB of f32),
    untouched rows kept, ids from the host or the device."""
    rng = np.random.default_rng(15)
    src = torch.from_numpy(rng.normal(size=(12, elems)) * 40).to(dtype)
    dst = torch.from_numpy(rng.normal(size=(9, elems)) * 40).to(dtype)
    ids = np.asarray([11, 0, 4, 11], np.int32)
    before = hops.gather_blocks.launches
    got = hops.gather_blocks(src.to(cuda), torch.from_numpy(ids).to(cuda))
    assert hops.gather_blocks.launches == before + 1
    assert torch.equal(got.cpu(), hops.gather_blocks_plain(src, ids))
    sids, dids = [3, 10, 0], [8, 2, 5]
    ref = hops.copy_blocks_plain(src, dst.clone(), sids, dids)
    before = hops.copy_blocks.launches
    got = hops.copy_blocks(src.to(cuda), dst.to(cuda), sids, dids)
    torch.cuda.synchronize()
    assert hops.copy_blocks.launches == before + 1
    assert torch.equal(got.cpu(), ref)
    pool = src.to(cuda)
    hops.copy_blocks(pool, pool, [0, 1], [5, 6])
    assert torch.equal(pool.cpu(), hops.copy_blocks_plain(
        src, src.clone(), [0, 1], [5, 6]))


def test_gather_blocks_into_out_on_cuda(cuda):
    """K6 writes into a caller's buffer (one half of the engine's k/v
    eviction buffer) and leaves the other half alone."""
    src = torch.from_numpy(np.random.default_rng(18).normal(
        size=(10, 37)).astype(np.float32))
    ids = np.asarray([9, 1, 4], np.int32)
    buf = torch.full((2, 3, 37), 7.0, device=cuda)
    before = hops.gather_blocks.launches
    hops.gather_blocks(src.to(cuda), ids, out=buf[1])
    assert hops.gather_blocks.launches == before + 1
    assert torch.equal(buf[1].cpu(), hops.gather_blocks_plain(src, ids))
    assert torch.all(buf[0] == 7.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("elems", [37, 16_384, 15_360])
def test_gather_blocks_into_strided_payload_on_cuda(cuda, dtype, elems):
    """The engine's eviction: k and v gathered into the two halves of one
    (L, 2, elems) payload (strided views), with device ids and their host
    mirror; bit for bit, one launch each, no byte of the buffer left
    unwritten.  Odd widths take the narrow vectors, rows of whole 16-byte
    vectors the wide ones."""
    rng = np.random.default_rng(19)
    L, n_slots, slot = 6, 9, 4
    pools = [torch.from_numpy(rng.normal(size=(L * n_slots, elems)) * 40)
             .to(dtype) for _ in range(2)]
    host = np.arange(L, dtype=np.int32) * n_slots + slot
    ids = torch.from_numpy(host).to(cuda)
    payload = torch.full((L, 2, elems), 7, dtype=dtype, device=cuda)
    before = hops.gather_blocks.launches
    for h, pool in enumerate(pools):
        hops.gather_blocks(pool.to(cuda), ids, out=payload[:, h],
                           host_ids=host)
    torch.cuda.synchronize()
    assert hops.gather_blocks.launches == before + 2
    for h, pool in enumerate(pools):
        assert torch.equal(payload[:, h].cpu(),
                           hops.gather_blocks_plain(pool, host))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_gather_blocks_many_rows_device_ids_on_cuda(cuda, dtype):
    """Past the rows whose ids ride in the launch, K6 reads them from the
    device: 300 rows, repeated ids, into a strided out."""
    rng = np.random.default_rng(23)
    src = torch.from_numpy(rng.normal(size=(50, 96)) * 40).to(dtype)
    ids = rng.integers(0, 50, size=300).astype(np.int32)
    assert ids.size > hops.IDS_BY_VALUE
    buf = torch.zeros((300, 2, 96), dtype=dtype, device=cuda)
    hops.gather_blocks(src.to(cuda), torch.from_numpy(ids).to(cuda),
                       out=buf[:, 1], host_ids=ids)
    assert torch.equal(buf[:, 1].cpu(), hops.gather_blocks_plain(src, ids))
    assert torch.all(buf[:, 0] == 0)


def test_host_mirror_out_of_range_raises_on_cuda(cuda):
    """The range checks read the host mirror: an id out of range there
    raises IndexError before any launch, whatever the device ids hold."""
    pool = torch.from_numpy(_pool(20, 6, 64)).to(cuda)
    ids = torch.tensor([0, 2], dtype=torch.int32, device=cuda)
    v, s = hops.quantize_blocks(pool, ids, host_ids=np.asarray([0, 2]))
    launches = (hops.gather_blocks.launches, hops.quantize_blocks.launches,
                hops.dequantize_blocks.launches)
    for mirror in (np.asarray([0, 6]), np.asarray([-1, 2])):
        with pytest.raises(IndexError):
            hops.gather_blocks(pool, ids, host_ids=mirror)
        with pytest.raises(IndexError):
            hops.quantize_blocks(pool, ids, host_ids=mirror)
        with pytest.raises(IndexError):
            hops.dequantize_blocks(pool, v, s, ids, host_ids=mirror)
    assert launches == (hops.gather_blocks.launches,
                        hops.quantize_blocks.launches,
                        hops.dequantize_blocks.launches)


def test_movers_raise_on_cuda(cuda):
    pool = torch.zeros((4, 16), device=cuda)
    with pytest.raises(IndexError):
        hops.gather_blocks(pool, np.asarray([0, 4]))
    with pytest.raises(IndexError):
        hops.copy_blocks(pool, pool.clone(), [0], [-1])
    with pytest.raises(ValueError):
        hops.copy_blocks(pool, pool.clone(), [0, 1], [2, 2])
    with pytest.raises(ValueError):
        hops.copy_blocks(pool, pool, [0, 1], [1, 2])
    with pytest.raises(ValueError):
        hops.gather_blocks(pool.t(), [0])
    with pytest.raises(TypeError):
        hops.copy_blocks(pool, pool.double(), [0], [1])


def _expert_inputs(seed, e, c, d, f, dtype, empty_slots=0):
    rng = np.random.default_rng(seed)
    xd = rng.normal(size=(e, c, d))
    if empty_slots:
        xd[:, -empty_slots:] = 0.0
    # scaled so that h, g and the outputs are O(1), where the stated bf16
    # tolerance (one step at magnitude 1) is tight
    ws = [rng.normal(size=(e, d, f)) / np.sqrt(d),
          rng.normal(size=(e, d, f)) / np.sqrt(d),
          rng.normal(size=(e, f, d)) / np.sqrt(f)]
    return [torch.from_numpy(a.astype(np.float32)).to(dtype).cuda()
            for a in [xd] + ws]


# bf16: the kernel and the plain version (cuBLAS) sum each product in
# another order, so an intermediate may round one bf16 step apart and move
# the outputs that read it by |wo| times that step: one bf16 step at
# magnitude 1; f32: sums of d and f terms in another order
MOE_TOL = {torch.bfloat16: dict(rtol=1.6e-2, atol=2.0 ** -7),
           torch.float32: dict(rtol=1e-4, atol=1e-4)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("activation", ["silu", "gelu", "relu2"])
@pytest.mark.parametrize("shape", [(8, 4, 256, 1408 // 4), (3, 21, 96, 915),
                                   (2, 1, 33, 17)])
def test_moe_ffn_kernel_matches_plain(cuda, dtype, activation, shape):
    """K7 against its plain version: ragged C, d and f tiles (f = 915 and
    odd widths), empty capacity slots giving exact zeros."""
    e, c, d, f = shape
    args = _expert_inputs(16, e, c, d, f, dtype, empty_slots=c // 3)
    before = mops.moe_ffn.launches
    got = mops.moe_ffn(*args, activation=activation)
    torch.cuda.synchronize()
    assert mops.moe_ffn.launches == before + 1
    assert got.dtype == dtype and got.shape == (e, c, d)
    ref = mops.moe_ffn_plain(*args, activation=activation)
    torch.testing.assert_close(got.float(), ref.float(), **MOE_TOL[dtype])
    if c // 3:
        assert torch.all(got[:, -(c // 3):] == 0)


# rows of each expert that hold a token (the dispatch buffer fills an
# expert from row 0): experts 1 and 4 empty; experts 2, 3, 6 and 7 fill
# only the first 16-row tile, expert 5 reaches the second by one row
FILLED = (20, 0, 16, 5, 0, 17, 1, 3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("activation", ["silu", "gelu", "relu2"])
@pytest.mark.parametrize("shape", [(256, 352), (96, 915)],
                         ids=["aligned", "ragged"])
def test_moe_ffn_skips_empty_experts(cuda, dtype, activation, shape):
    """Experts without a token and 16-row tiles without one read no
    weights (the kernel's count of skipped tiles says so) and give exact
    zeros; the filled rows still match the plain version.  ``ragged``
    (f = 915) stages by plain loads instead of cp.async."""
    d, f = shape
    e, c = len(FILLED), 20
    args = _expert_inputs(25, e, c, d, f, dtype)
    for ex, n in enumerate(FILLED):
        args[0][ex, n:] = 0
    skipped = torch.zeros((1,), dtype=torch.int32, device=cuda)
    got = mops.moe_ffn(*args, activation=activation, skipped=skipped)
    ref = mops.moe_ffn_plain(*args, activation=activation)
    torch.testing.assert_close(got.float(), ref.float(), **MOE_TOL[dtype])
    tiles = sum(not args[0][ex, t:t + 16].any().item()
                for ex in range(e) for t in (0, 16))
    assert tiles == 8 and int(skipped.item()) == tiles
    for ex, n in enumerate(FILLED):
        assert torch.all(got[ex, n:] == 0), ex


@pytest.mark.parametrize("dtype,d,f,c", [
    (torch.bfloat16, 5120, 8192, 4), (torch.bfloat16, 256, 352, 20),
    (torch.float32, 256, 352, 20)], ids=["llama4-decode", "bf16", "f32"])
def test_moe_ffn_skips_all_but_four_of_128_experts(cuda, dtype, d, f, c):
    """128 experts of which 4 hold tokens (every row of their buffers), as
    a decode step of Llama-4 gives them: each of the other 124 experts
    skips its every 16-row tile (one at C 4, two at C 20; counted on the
    card) and gives exact zeros, and the 4 match the plain version.  At
    Llama-4's width (d 5120, f 8192) the weights are 32.2 GB in bf16."""
    e, filled = 128, (3, 40, 77, 127)
    gen = torch.Generator(device=cuda).manual_seed(33)
    xd = torch.zeros((e, c, d), dtype=dtype, device=cuda)
    xd[list(filled)] = torch.randn((len(filled), c, d), generator=gen,
                                   device=cuda).to(dtype)
    # scaled so that h, g and the outputs are O(1), as _expert_inputs
    wi, wg = (torch.randn((e, d, f), generator=gen, device=cuda,
                          dtype=dtype).mul_(d ** -0.5) for _ in range(2))
    wo = torch.randn((e, f, d), generator=gen, device=cuda,
                     dtype=dtype).mul_(f ** -0.5)
    skipped = torch.zeros((1,), dtype=torch.int32, device=cuda)
    got = mops.moe_ffn(xd, wi, wg, wo, skipped=skipped)
    ref = mops.moe_ffn_plain(xd, wi, wg, wo)
    torch.testing.assert_close(got.float(), ref.float(), **MOE_TOL[dtype])
    tiles = (c + 15) // 16
    assert int(skipped.item()) == (e - len(filled)) * tiles
    empty = [x for x in range(e) if x not in filled]
    assert torch.all(got[empty] == 0)


# rows of each of DBRX's 16 experts that hold a token: 4 decode rows at
# top-4 (16 assignments, capacity 4; 5 experts empty), and 40 prefill rows
# (160 assignments, capacity 12: 10 experts full, their tokens past it
# dropped, 4 partly filled, 2 empty)
DBRX_FILLED = {4: (2, 1, 0, 1, 1, 0, 2, 1, 0, 3, 1, 0, 2, 0, 1, 1),
               12: (12, 12, 7, 12, 12, 0, 12, 12, 3, 12, 12, 12, 0, 12, 9, 1)}


@pytest.mark.parametrize("c", sorted(DBRX_FILLED), ids=["decode", "prefill"])
def test_moe_ffn_at_dbrx_width(cuda, c):
    """K7 at dbrx-132b's fine-grained shape, 16 experts of d 6144 and
    f 10752 (21 tiles of 512; 6.3 GB of bf16 weights), with the experts'
    rows filled as a decode step (C 4) or a 40-token prefill (C 12) fills
    them: the filled rows match the plain version, each empty expert
    skips its one 16-row tile (counted on the card) and gives zeros."""
    e, d, f = 16, 6144, 10752
    filled = DBRX_FILLED[c]
    gen = torch.Generator(device=cuda).manual_seed(35)
    xd = torch.randn((e, c, d), generator=gen, device=cuda,
                     dtype=torch.bfloat16)
    for ex, n in enumerate(filled):
        xd[ex, n:] = 0
    # scaled so that h, g and the outputs are O(1), as _expert_inputs
    wi, wg = (torch.randn((e, d, f), generator=gen, device=cuda,
                          dtype=torch.bfloat16).mul_(d ** -0.5)
              for _ in range(2))
    wo = torch.randn((e, f, d), generator=gen, device=cuda,
                     dtype=torch.bfloat16).mul_(f ** -0.5)
    skipped = torch.zeros((1,), dtype=torch.int32, device=cuda)
    got = mops.moe_ffn(xd, wi, wg, wo, skipped=skipped)
    ref = mops.moe_ffn_plain(xd, wi, wg, wo)
    torch.testing.assert_close(got.float(), ref.float(),
                               **MOE_TOL[torch.bfloat16])
    assert int(skipped.item()) == filled.count(0)
    for ex, n in enumerate(filled):
        assert torch.all(got[ex, n:] == 0), ex


def test_moe_ffn_raises_on_cuda(cuda):
    x, wi, wg, wo = _expert_inputs(17, 2, 3, 8, 5, torch.bfloat16)
    with pytest.raises(ValueError):
        mops.moe_ffn(x, wi.transpose(1, 2).contiguous(), wg, wo)
    with pytest.raises(ValueError):
        mops.moe_ffn(x.transpose(0, 1), wi, wg, wo)
    with pytest.raises(TypeError):
        mops.moe_ffn(x.float(), wi, wg, wo)
    with pytest.raises(ValueError):
        mops.moe_ffn(x, wi.cpu(), wg, wo)


# K7's backward against its plain version: each gradient within this
# share of the output's largest entry.  bf16: the kernel and cuBLAS sum in
# other orders, so dA, dH or dG may round one bf16 step apart, and the
# gradients that read them move by a step of their own magnitude; f32:
# sums over C, d and f in other orders
MOE_BWD_REL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


def _bwd_inputs(seed, e, c, d, f, dtype, tail=5, tokenless=(1,)):
    """K7's operands and a cotangent as the MoE layer gives them: the
    ``tokenless`` experts hold no token, every expert's last ``tail`` rows
    are empty, and the cotangent is zero on every empty row."""
    xd, wi, wg, wo = _expert_inputs(seed, e, c, d, f, dtype,
                                    empty_slots=tail)
    xd[list(tokenless)] = 0
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dout = torch.randn(xd.shape, generator=gen, device="cuda").to(dtype)
    dout[(xd == 0).all(-1)] = 0
    return xd, wi, wg, wo, dout


def _assert_bwd_close(got, ref, dtype):
    for name, g, r in zip(("dxd", "dwi", "dwg", "dwo"), got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        err = (g.float() - r.float()).abs().max().item()
        scale = r.float().abs().max().item()
        assert err <= MOE_BWD_REL[dtype] * scale, (name, err, scale)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("activation", ["silu", "gelu", "relu2"])
@pytest.mark.parametrize("shape", [(4, 80, 256, 352), (3, 70, 96, 915),
                                   (2, 33, 37, 77)],
                         ids=["aligned", "phi-f", "odd"])
def test_moe_ffn_bwd_kernel_matches_plain(cuda, dtype, activation, shape):
    """K7's backward against ``moe_ffn_bwd_plain``: ragged C, d and f tiles
    (f = 915, and odd d and f, staged by plain loads), a tokenless expert
    whose weight gradients are exact zeros, empty tail rows whose dX is
    zero; one counted launch a call; a second call bit-identical (no
    atomics)."""
    e, c, d, f = shape
    args = _bwd_inputs(40, e, c, d, f, dtype)
    before = mops.moe_ffn_bwd.launches
    skipped = torch.zeros((1,), dtype=torch.int32, device=cuda)
    got = mops.moe_ffn_bwd(*args, activation=activation, skipped=skipped)
    torch.cuda.synchronize()
    assert mops.moe_ffn_bwd.launches == before + 1
    ref = mops.moe_ffn_bwd_plain(*args, activation=activation)
    _assert_bwd_close(got, ref, dtype)
    dx, dwi, dwg, dwo = got
    for g in (dwi[1], dwg[1], dwo[1], dx[1], dx[:, -5:]):
        assert torch.all(g == 0)
    # expert 1's C tiles (128 rows in bf16, 64 in f32) are skipped, and
    # none of the others'
    assert int(skipped.item()) == -(-c // mops.bwd_tile(dtype))
    again = mops.moe_ffn_bwd(*args, activation=activation)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_ffn_bwd_skips_empty_tiles(cuda, dtype):
    """Experts filled to 0, 1, 64, 65 and 200 of 200 rows (the dispatch
    buffer fills each from row 0): each skips its C tiles past its last
    token (128 rows in bf16, 64 in f32; counted on the card) and still
    matches the plain version; an expert without a token gets zero weight
    gradients."""
    filled = (0, 1, 64, 65, 200)
    e, c, d, f = len(filled), 200, 128, 96
    xd, wi, wg, wo, dout = _bwd_inputs(41, e, c, d, f, dtype, tail=0,
                                       tokenless=())
    for ex, n in enumerate(filled):
        xd[ex, n:] = 0
        dout[ex, n:] = 0
    skipped = torch.zeros((1,), dtype=torch.int32, device=cuda)
    got = mops.moe_ffn_bwd(xd, wi, wg, wo, dout, skipped=skipped)
    ref = mops.moe_ffn_bwd_plain(xd, wi, wg, wo, dout)
    _assert_bwd_close(got, ref, dtype)
    t = mops.bwd_tile(dtype)
    tiles = sum(-(-c // t) + (-n // t) for n in filled)
    assert tiles == {64: 12, 128: 5}[t]
    assert int(skipped.item()) == tiles
    assert all(torch.all(g[0] == 0) for g in got)


def test_moe_ffn_gradient_on_cuda(cuda):
    """``moe_ffn`` on CUDA tensors that require grad goes through
    ``MoeFFN``: one training-forward launch (not the decode kernels'), one
    backward launch, and the gradient that arrives equals
    ``moe_ffn_bwd_plain``'s within the backward's tolerance."""
    args = _bwd_inputs(42, 3, 40, 64, 48, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in args[:4]]
    counts = (mops.moe_ffn.launches, mops.moe_ffn_train.launches,
              mops.moe_ffn_bwd.launches)
    out = mops.moe_ffn(*leaves)
    got = torch.autograd.grad(out, leaves, args[4])
    torch.cuda.synchronize()
    assert (mops.moe_ffn.launches, mops.moe_ffn_train.launches,
            mops.moe_ffn_bwd.launches) == (counts[0], counts[1] + 1,
                                           counts[2] + 1)
    _assert_bwd_close(got, mops.moe_ffn_bwd_plain(*args), torch.bfloat16)


# (E, C, d, f, empty tail rows): phi-tiny-moe's training C and expert
# width, its reduced width 183, an odd d and f, a capacity of 5
TRAIN_SHAPES = {"phi-c1280": (4, 1280, 256, 915, 300),
                "f183": (3, 200, 64, 183, 20), "odd": (2, 33, 37, 77, 5),
                "c5": (4, 5, 96, 183, 1)}


@pytest.mark.parametrize("activation", ["silu", "gelu", "relu2"])
@pytest.mark.parametrize("shape", list(TRAIN_SHAPES))
def test_moe_ffn_train_matches_plain(cuda, activation, shape):
    """The bf16 training forward against ``moe_ffn_plain(...,
    residuals=True)``: the output within ``moe_ffn``'s tolerance, A, h and
    g (E, C, fp) within it too with their pad columns zero, a tokenless
    expert and empty tail rows giving zeros; its skip count (128-row C
    tiles without a token) counted on the card; one counted launch; a
    second call the same bits, output and residuals alike."""
    e, c, d, f, tail = TRAIN_SHAPES[shape]
    xd, wi, wg, wo, _ = _bwd_inputs(44, e, c, d, f, torch.bfloat16,
                                    tail=tail)
    skipped = torch.zeros((1,), dtype=torch.int32, device=cuda)
    before = mops.moe_ffn_train.launches
    out, saved = mops.moe_ffn_train(xd, wi, wg, wo, activation=activation,
                                    skipped=skipped)
    torch.cuda.synchronize()
    assert mops.moe_ffn_train.launches == before + 1
    ref, res = mops.moe_ffn_plain(xd, wi, wg, wo, activation,
                                  residuals=True)
    torch.testing.assert_close(out.float(), ref.float(),
                               **MOE_TOL[torch.bfloat16])
    fp = -(-f // 8) * 8
    for got, r in zip(saved[4:7], res):
        assert got.shape == (e, c, fp)
        torch.testing.assert_close(got[..., :f].float(), r.float(),
                                   **MOE_TOL[torch.bfloat16])
        assert torch.all(got[..., f:] == 0)
    assert torch.all(out[1] == 0) and torch.all(out[:, c - tail:] == 0)
    t = mops.TRAIN_TILE
    tiles = sum(bool((xd[x, r:r + t] == 0).all()) for x in range(e)
                for r in range(0, c, t))
    assert int(skipped.item()) == tiles
    assert torch.equal(saved[7].bool(), torch.tensor(
        [[not bool((xd[x, r:r + t] == 0).all()) for r in range(0, c, t)]
         for x in range(e)], device=cuda))
    again, saved2 = mops.moe_ffn_train(xd, wi, wg, wo, activation=activation)
    assert torch.equal(out, again)
    assert all(torch.equal(a, b) for a, b in zip(saved, saved2))


@pytest.mark.parametrize("shape", list(TRAIN_SHAPES))
def test_moe_train_backward_matches_plain(cuda, shape):
    """Through ``MoeFFN`` in bf16 (the training forward, then the backward
    reading its A, h and g): the gradient within the backward's tolerance
    of ``moe_ffn_bwd_plain``'s, the tokenless expert's exact zeros, and a
    second forward and backward the same bits."""
    e, c, d, f, tail = TRAIN_SHAPES[shape]
    args = _bwd_inputs(45, e, c, d, f, torch.bfloat16, tail=tail)

    def grads():
        leaves = [t.clone().requires_grad_() for t in args[:4]]
        return torch.autograd.grad(mops.moe_ffn(*leaves), leaves, args[4])

    got = grads()
    _assert_bwd_close(got, mops.moe_ffn_bwd_plain(*args), torch.bfloat16)
    assert all(torch.all(g[1] == 0) for g in got)
    assert all(torch.equal(a, b) for a, b in zip(got, grads()))


def _kernel_names(fn):
    """The device kernels' names in a profiler trace of two calls of
    ``fn``, the card idle 25 ms on each side inside the window (a bare
    window around a short call can lose its rows); taken again, up to
    three times, where the trace came back empty."""
    import time
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.025)
            fn()
            fn()
            torch.cuda.synchronize()
            time.sleep(0.025)
        names = {r.key for r in prof.key_averages()
                 if r.device_type == torch.autograd.DeviceType.CUDA}
        if names:
            return names
    raise AssertionError("three traces came back without a kernel")


def test_no_grad_call_keeps_the_decode_kernels(cuda):
    """Read from a profiler trace by kernel name: a call without a gradient
    runs the decode kernels (gate_up_mma_kernel, down_mma_kernel) and no
    training kernel; a call under grad runs the training forward's
    kernels and, in its backward, the wgmma backward's, and no decode
    kernel."""
    args = _bwd_inputs(46, 3, 70, 96, 183, torch.bfloat16)
    with torch.no_grad():
        plain = _kernel_names(lambda: mops.moe_ffn(*args[:4]))
    assert any("gate_up_mma_kernel" in n for n in plain), plain
    assert any("down_mma_kernel" in n for n in plain), plain
    assert not any("wgmma" in n or "moe_train" in n for n in plain), plain
    leaves = [t.clone().requires_grad_() for t in args[:4]]
    trained = _kernel_names(lambda: torch.autograd.grad(
        mops.moe_ffn(*leaves), leaves, args[4]))
    for k in ("moe_train_flags_kernel", "moe_train_gate_wgmma_kernel",
              "moe_train_down_wgmma_kernel", "moe_bwd_dgate_wgmma_kernel",
              "moe_bwd_dx_wgmma_kernel", "moe_bwd_dw_wgmma_kernel",
              "moe_bwd_dwo_wgmma_kernel"):
        assert any(k in n for n in trained), (k, trained)
    assert not any("_mma_kernel" in n and "wgmma" not in n
                   for n in trained), trained


def test_moe_ffn_bwd_raises_on_cuda(cuda):
    xd, wi, wg, wo, dout = _bwd_inputs(43, 2, 8, 16, 24, torch.bfloat16)
    with pytest.raises(ValueError):
        mops.moe_ffn_bwd(xd, wi, wg, wo, dout[:, :4])
    with pytest.raises(ValueError):
        mops.moe_ffn_bwd(xd, wi, wg, wo, dout.float())
    with pytest.raises(ValueError):
        mops.moe_ffn_bwd(xd, wi, wg, wo, dout.transpose(0, 1).contiguous()
                         .transpose(0, 1))
    with pytest.raises(TypeError):
        mops.moe_ffn_bwd(xd.half(), wi.half(), wg.half(), wo.half(),
                         dout.half())
    with pytest.raises(ValueError):
        mops.moe_ffn_bwd(xd, wi, wg, wo.cpu(), dout)


@pytest.mark.parametrize("q_pos", [(41, 24, 33, 17), (7, 0, 15, 3)])
def test_paged_partials_at_zamba2_heads(cuda, q_pos):
    """K1 as zamba2-7b's shared attention block gives it at full width:
    MHA, 32 q over 32 kv heads (gq 1) of 112, 8-token blocks, 4 rows over
    a 24-slot pool dealt in shuffled order."""
    cfg = get_config("zamba2-7b")
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim) == \
        (32, 32, 112)
    s = _scenario(31, 24, 8, 32, 32, 112, q_pos, empty_row=None)
    got = _partials(s, cfg, cuda)
    ref = _partials(s, cfg, "cpu")
    assert got.acc.shape == (4, 32, 1, 112)
    for name in ("m", "l", "acc"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(ref, name), rtol=1e-4, atol=1e-4)


# K4 against its plain version.  bf16: the plain version rounds each
# probability to bf16 against the running max of its 1024-key chunk, the
# kernel against that of its 64-key tile, so the two differ by about one
# bf16 step of p, and the rounded outputs by up to one bf16 step more: two
# bf16 steps at magnitude 1.  f32: sums over hd and over keys in another
# order.
FLASH_TOL = {torch.bfloat16: dict(rtol=1.6e-2, atol=2.0 ** -7),
             torch.float32: dict(rtol=1e-4, atol=1e-4)}
FLASH_MASKS = [dict(), dict(sliding_window=20), dict(attention_chunk=24),
               dict(logit_softcap=2.0), dict(sliding_window=33,
                                             attention_chunk=48,
                                             logit_softcap=30.0)]


def _flash_inputs(seed, b, sq, sk, nq, nkv, hd, dtype, q0=None):
    """Normal q, k, v; keys at positions 0..sk-1 and queries at the last
    sq of them (``q0`` shifts the queries of batch row 1)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(dtype).cuda()
               for s in ((b, sq, nq, hd), (b, sk, nkv, hd), (b, sk, nkv, hd)))
    kp = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    qp = kp[:, sk - sq:].copy()
    if q0 is not None:
        qp[1] = np.arange(q0, q0 + sq, dtype=np.int32)
    return q, k, v, torch.from_numpy(qp).cuda(), torch.from_numpy(kp).cuda()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("masks", FLASH_MASKS,
                         ids=["causal", "window", "chunk", "softcap", "all"])
@pytest.mark.parametrize("shape", [(2, 77, 77, 8, 2, 120),
                                   (1, 45, 130, 8, 1, 128),
                                   (2, 131, 131, 3, 3, 64),
                                   (2, 5, 70, 40, 8, 96),
                                   (2, 60, 90, 16, 4, 112),
                                   (1, 70, 70, 6, 1, 128)])
def test_prefill_attention_kernel_matches_plain(cuda, dtype, masks, shape):
    """K4 against its plain version at ragged shapes: sq and sk no
    multiple of the tiles, hd 120, 96, 64, 112 (zamba2) and 128, gq 4, 8,
    1, 5 and 6 (dbrx), queries after a prefix of keys, batch row 1's
    queries at other positions, every mask alone and together."""
    b, sq, sk, nq, nkv, hd = shape
    q, k, v, qp, kp = _flash_inputs(19, b, sq, sk, nq, nkv, hd, dtype,
                                    q0=sk // 3 if b > 1 else None)
    before = fops.prefill_attention.launches
    got = fops.prefill_attention(q, k, v, qp, kp, **masks)
    torch.cuda.synchronize()
    assert fops.prefill_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    ref = fops.prefill_attention_plain(q, k, v, qp, kp, **masks)
    torch.testing.assert_close(got.float(), ref.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("masks", [dict(), dict(sliding_window=300),
                                   dict(attention_chunk=256)],
                         ids=["causal", "window", "chunk"])
def test_prefill_attention_many_tiles(cuda, dtype, masks):
    """1,100 queries over 1,100 keys at danube's heads (gq 4, hd 120):
    18 q tiles by 18 K/V tiles, so the copy ring turns many times, tiles
    are skipped behind the window and past the diagonal, and the tiles
    inside the band take the mask-free path."""
    q, k, v, qp, kp = _flash_inputs(21, 1, 1100, 1100, 16, 4, 120, dtype)
    got = fops.prefill_attention(q, k, v, qp, kp, **masks)
    ref = fops.prefill_attention_plain(q, k, v, qp, kp, **masks)
    torch.testing.assert_close(got.float(), ref.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 8300, 40, 8, 8192),
                                   (2, 600, 40, 8, 256),
                                   (2, 600, 64, 8, 256)],
                         ids=["llama4-8192", "gq5-256", "gq8-256"])
def test_prefill_attention_across_a_chunk_boundary(cuda, dtype, shape):
    """K4 with an attention chunk and a prompt past its first boundary, at
    hd 128: Llama-4's heads (40 / 8) with its chunk of 8,192 at 8,300
    tokens, and gq 5 and 8 at a chunk of 256 (batch row 1's queries at
    other positions), where queries past the boundary see their own
    chunk only."""
    b, n, nq, nkv, chunk = shape
    q, k, v, qp, kp = _flash_inputs(23, b, n, n, nq, nkv, 128, dtype,
                                    q0=n // 3 if b > 1 else None)
    got = fops.prefill_attention(q, k, v, qp, kp, attention_chunk=chunk)
    ref = fops.prefill_attention_plain(q, k, v, qp, kp,
                                       attention_chunk=chunk)
    torch.testing.assert_close(got.float(), ref.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("prompt", [8, 40])
def test_prefill_attention_behind_a_prefix(cuda, dtype, prompt):
    """K4 as qwen2-vl-72b's prefill gives it: 1,024 prefix positions (the
    patch embeddings) ahead of a padded prompt, one sequence, 64 / 8 heads
    (gq 8) of 128, causal over both."""
    n = 1024 + prompt
    q, k, v, qp, kp = _flash_inputs(24, 1, n, n, 64, 8, 128, dtype)
    got = fops.prefill_attention(q, k, v, qp, kp)
    ref = fops.prefill_attention_plain(q, k, v, qp, kp)
    torch.testing.assert_close(got.float(), ref.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [8, 40, 1032])
def test_prefill_attention_at_zamba2_heads(cuda, dtype, n):
    """K4 as zamba2-7b's shared attention block gives it at full width:
    one padded prompt, 32 q over 32 kv heads (gq 1) of 112, causal; bf16
    on the tensor cores (hd 112 is 7 k-steps of 16) and f32."""
    q, k, v, qp, kp = _flash_inputs(25, 1, n, n, 32, 32, 112, dtype)
    got = fops.prefill_attention(q, k, v, qp, kp)
    ref = fops.prefill_attention_plain(q, k, v, qp, kp)
    torch.testing.assert_close(got.float(), ref.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [72, 1564])
def test_prefill_attention_at_musicgen_heads(cuda, dtype, n):
    """K4 as musicgen-medium's prefill gives it at full width: its 64
    conditioning positions ahead of an audio prompt (8 frames, and 1,500:
    30 s at 50 Hz), one sequence, 24 q over 24 kv heads (MHA) of 64, so
    four k-steps of 16 on the tensor cores in bf16; causal over both."""
    q, k, v, qp, kp = _flash_inputs(26, 1, n, n, 24, 24, 64, dtype)
    before = fops.prefill_attention.launches
    got = fops.prefill_attention(q, k, v, qp, kp)
    torch.cuda.synchronize()
    assert fops.prefill_attention.launches == before + 1
    ref = fops.prefill_attention_plain(q, k, v, qp, kp)
    torch.testing.assert_close(got.float(), ref.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefill_attention_pad_keys_and_empty_rows(cuda, dtype):
    """Keys padded at ``PAD_POSITION`` (random k and v behind them) add
    nothing, and a query row whose every key is rejected (before the first
    key, or with the window past the last) comes out zero, as in the
    plain version."""
    q, k, v, qp, kp = _flash_inputs(22, 2, 40, 100, 8, 2, 128, dtype)
    kp[1] += 10                      # row 1's keys start at position 10
    kp[:, 70:] = fops.PAD_POSITION
    qp[1, :3] = torch.tensor([0, 5, 9], dtype=torch.int32)
    masks = dict(sliding_window=50)
    qp[0, -1] = 200                  # window (150, 200]: no real key in it
    got = fops.prefill_attention(q, k, v, qp, kp, **masks)
    ref = fops.prefill_attention_plain(q, k, v, qp, kp, **masks)
    torch.testing.assert_close(got.float(), ref.float(), **FLASH_TOL[dtype])
    assert torch.all(got[1, :3] == 0) and torch.all(got[0, -1] == 0)
    assert torch.all(got[0, :-1].abs().sum(-1) > 0)
    unpadded = fops.prefill_attention(q[:1], k[:1, :70].contiguous(),
                                      v[:1, :70].contiguous(), qp[:1],
                                      kp[:1, :70].contiguous(), **masks)
    torch.testing.assert_close(got[:1], unpadded, rtol=0, atol=0)


def test_prefill_attention_head_dim_not_multiple_of_8(cuda):
    """hd 36: bf16 raises (the tensor-core kernel copies 16-byte rows),
    f32 takes the CUDA-core kernel."""
    q, k, v, qp, kp = _flash_inputs(23, 1, 30, 30, 4, 2, 36, torch.float32)
    with pytest.raises(ValueError):
        fops.prefill_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), qp,
                               kp)
    got = fops.prefill_attention(q, k, v, qp, kp)
    ref = fops.prefill_attention_plain(q, k, v, qp, kp)
    torch.testing.assert_close(got, ref, **FLASH_TOL[torch.float32])


def test_prefill_attention_raises_on_cuda(cuda):
    q, k, v, qp, kp = _flash_inputs(20, 1, 8, 8, 4, 2, 32, torch.bfloat16)
    with pytest.raises(TypeError):
        fops.prefill_attention(q.float(), k, v, qp, kp)
    with pytest.raises(TypeError):
        fops.prefill_attention(q, k, v, qp.long(), kp)
    with pytest.raises(ValueError):
        fops.prefill_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v, qp, kp)
    with pytest.raises(ValueError):
        fops.prefill_attention(q, k.cpu(), v, qp, kp)
    wide = torch.zeros((1, 8, 2, 160), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        fops.prefill_attention(wide, wide, wide, qp, kp)
    shifted = torch.zeros(q.numel() + 1, dtype=q.dtype,
                          device=cuda)[1:].view(q.shape)   # 2-byte aligned
    with pytest.raises(ValueError):
        fops.prefill_attention(shifted, k, v, qp, kp)


# K4's backward: (b, sq, sk, nq, nkv, hd) at ragged tiles, every gq the
# models give it (1, 4, 5, 6, 8) and hd 64, 112, 120 and 128; gq 6
# (nemotron-4-15b's 48 / 8 heads) folds 60 rows into the dQ kernel's 64,
# and 333 tokens at danube's heads cross more q tiles than the ring has
# stages, with sq and sk no multiple of 128
BWD_SHAPES = [(2, 77, 77, 8, 2, 120), (1, 45, 130, 8, 1, 128),
              (2, 131, 131, 3, 3, 64), (2, 60, 90, 16, 4, 112),
              (1, 70, 70, 40, 8, 128), (2, 90, 90, 48, 8, 128),
              (1, 333, 333, 32, 8, 120)]


def _bwd_operands(seed, shape, dtype, masks):
    b, sq, sk, nq, nkv, hd = shape
    q, k, v, qp, kp = _flash_inputs(seed, b, sq, sk, nq, nkv, hd, dtype,
                                    q0=sk // 3 if b > 1 else None)
    o, lse = fops.prefill_attention_plain(q, k, v, qp, kp, return_lse=True,
                                          **masks)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    return q, k, v, qp, kp, o, lse, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("masks", FLASH_MASKS,
                         ids=["causal", "window", "chunk", "softcap", "all"])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_prefill_attention_bwd_kernel_matches_plain(cuda, dtype, masks,
                                                    shape):
    """K4's backward kernels against ``prefill_attention_bwd_plain`` on the
    same o, LSE and do: every mask alone and together, queries after a
    prefix of keys, batch row 1's queries at other positions; and the
    forward's LSE against the plain LSE."""
    q, k, v, qp, kp, o, lse, do = _bwd_operands(31, shape, dtype, masks)
    before = fops.prefill_attention_bwd.launches
    got = fops.prefill_attention_bwd(q, k, v, o, lse, do, qp, kp, **masks)
    torch.cuda.synchronize()
    assert fops.prefill_attention_bwd.launches == before + 1
    ref = fops.prefill_attention_bwd_plain(q, k, v, o, lse, do, qp, kp,
                                           **masks)
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), r.float(), **FLASH_TOL[dtype])
    _, lse_k = fops._launch_forward(q, k, v, qp, kp, want_lse=True, **masks)
    torch.testing.assert_close(lse_k, lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_prefill_attention_bwd_kernel_every_head_dim(cuda, hd):
    """The bf16 backward at every head dim it takes (a multiple of 8 up to
    128): below 64 one TMA box is wider than a head row, and columns past
    hd land as zeros in both operands of each product."""
    masks = FLASH_MASKS[-1]
    q, k, v, qp, kp, o, lse, do = _bwd_operands(41, (2, 70, 70, 12, 4, hd),
                                                torch.bfloat16, masks)
    got = fops.prefill_attention_bwd(q, k, v, o, lse, do, qp, kp, **masks)
    ref = fops.prefill_attention_bwd_plain(q, k, v, o, lse, do, qp, kp,
                                           **masks)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.float(), r.float(),
                                   **FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("masks", [FLASH_MASKS[0], FLASH_MASKS[-1]],
                         ids=["causal", "all"])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_prefill_attention_bwd_kernel_is_deterministic(cuda, masks, shape):
    """Two bf16 backward calls on the same inputs give the same dq, dk and
    dv bit for bit: each output element is summed by one thread in one
    order (dK and dV over the GQA group in one block, dQ in another
    kernel), with no atomics."""
    q, k, v, qp, kp, o, lse, do = _bwd_operands(37, shape, torch.bfloat16,
                                                masks)
    first = fops.prefill_attention_bwd(q, k, v, o, lse, do, qp, kp, **masks)
    second = fops.prefill_attention_bwd(q, k, v, o, lse, do, qp, kp, **masks)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefill_attention_bwd_at_danube_window(cuda, dtype):
    """1,100 tokens at danube's heads (32 / 8 of 120) with a window of 300:
    many q tiles per key tile, tiles skipped behind the window and past the
    diagonal, through ``torch.autograd`` (one forward and one backward
    launch)."""
    q, k, v, qp, kp = _flash_inputs(33, 1, 1100, 1100, 32, 8, 120, dtype)
    masks = dict(sliding_window=300)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    f0, b0 = fops.prefill_attention.launches, \
        fops.prefill_attention_bwd.launches
    out = fops.prefill_attention(q, k, v, qp, kp, **masks)
    do = torch.randn_like(out)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert fops.prefill_attention.launches == f0 + 1
    assert fops.prefill_attention_bwd.launches == b0 + 1
    with torch.no_grad():
        o, lse = fops.prefill_attention_plain(q, k, v, qp, kp,
                                              return_lse=True, **masks)
        ref = fops.prefill_attention_bwd_plain(q, k, v, o, lse, do, qp, kp,
                                               **masks)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.float(), r.float(), **FLASH_TOL[dtype])


def test_kernels_without_backward_raise_under_grad(cuda):
    """K1, K2, K3, K5 and K6 have no backward: on a CUDA tensor that
    requires grad, in grad mode, each raises and names itself instead of
    returning a tensor that drops the gradient; under ``torch.no_grad`` each
    runs.  (K7 has one: ``test_moe_ffn_gradient_on_cuda``.)"""
    q = torch.randn((2, 8, 64), device=cuda, requires_grad=True)
    pool = torch.randn((4, 8, 2, 64), device=cuda, requires_grad=True)
    req = torch.tensor([0, 0, 1, -1], dtype=torch.int32, device=cuda)
    base = torch.tensor([0, 8, 0, 0], dtype=torch.int32, device=cuda)
    pos = torch.tensor([12, 5], dtype=torch.int32, device=cuda)
    flat = torch.randn((4, 64), device=cuda, requires_grad=True)
    ids = torch.tensor([0, 2], dtype=torch.int32, device=cuda)
    values, scales = hops.quantize_blocks(flat.detach(), ids)
    calls = {
        "paged_decode_partials": lambda: pops.paged_decode_partials(
            q, pool, pool, req, base, pos, scale=0.125),
        "quantize_blocks": lambda: hops.quantize_blocks(flat, ids),
        "dequantize_blocks": lambda: hops.dequantize_blocks(
            flat, values, scales, ids),
        "gather_blocks": lambda: hops.gather_blocks(flat, ids),
        "copy_blocks": lambda: hops.copy_blocks(flat, flat.detach().clone(),
                                                ids, ids),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: the kernel has no "
                           f"backward"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


def test_row_parallel_product_matches_widened(cuda):
    """``layers.row_parallel`` of bf16 operands on the card (cuBLAS's
    bf16 product with an f32 output, and its bf16 backward) against the
    operands widened, as the CPU computes it: the output within 1e-5 of
    its largest entry, each operand's gradient within one bf16 step of
    its largest entry (a bf16-valued upstream gradient)."""
    from repro_torch.models.layers import row_parallel

    gen = torch.Generator(device=cuda).manual_seed(0)
    a = (torch.randn((2, 64, 4, 32), generator=gen, device=cuda) * 0.5).to(
        torch.bfloat16).requires_grad_(True)
    w = (torch.randn((4, 32, 96), generator=gen, device=cuda) * 0.02).to(
        torch.bfloat16).requires_grad_(True)
    g = torch.randn((2, 64, 96), generator=gen, device=cuda).to(
        torch.bfloat16).float()
    ways = []
    for fn in (lambda: row_parallel(a, w, 2),
               lambda: torch.einsum("bsnh,nhd->bsd", a.float(), w.float())):
        y = fn()
        ways.append((y, *torch.autograd.grad(y, (a, w), g)))
    (y, da, dw), (y0, da0, dw0) = ways
    assert y.dtype == torch.float32
    for got, want, rel in ((y, y0, 1e-5), (da, da0, 2.0 ** -7),
                           (dw, dw0, 2.0 ** -7)):
        err = (got.float() - want.float()).abs().max()
        assert err <= rel * want.float().abs().max(), (err, rel)
