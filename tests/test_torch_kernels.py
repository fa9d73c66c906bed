"""The port's kernels held against the JAX package.

Kernel K1 (paged decode partials), K2/K3 (quantize-on-demote /
dequantize-on-reload) and K5/K6 (fused copy / gather of pool rows) run
here through their plain PyTorch versions, which
are what the wrappers take for CPU tensors; the same numpy inputs go through
``repro.core.paged_attention`` and the Pallas kernels in interpret mode.
The CUDA kernels are held against these plain versions on the card by
tests/test_torch_kernels_gpu.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import paged_attention as jpa
from repro.kernels.harvest_copy.kernel import harvest_copy as pallas_copy
from repro.kernels.harvest_copy.kernel import harvest_gather as pallas_gather
from repro.kernels.harvest_copy.ops import dequantize_blocks as j_dequant
from repro.kernels.harvest_copy.ops import quantize_blocks as j_quant
from repro.kernels.harvest_copy.ref import (harvest_copy_ref,
                                            harvest_scatter_ref)
from repro.kernels.paged_attention.kernel import \
    paged_attention as pallas_paged_attention
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import paged_attention as tpa
from repro_torch.kernels.harvest_copy import ops as hops
from repro_torch.kernels.paged_attention import ops as pops

# f32 partials: the same tolerance as the JAX kernel tests (test_kernels.py)
TOL = dict(rtol=2e-5, atol=2e-5)


def _cfgs(**changes):
    cfg = get_config("yi-6b").reduced()
    return (dataclasses.replace(cfg, **changes),
            dataclasses.replace(t_get_config("yi-6b").reduced(), **changes))


def _scenario(seed=0, b=3, n_slots=12, bs=8, nkv=1, nq=4, hd=64,
              q_pos=(21, 7, 0), empty_row=None):
    """Random pools whose slots are dealt to requests in shuffled order
    (block j of request r at base j*bs, up to its q_pos); the rest are free
    slots holding garbage.  ``empty_row`` owns no slot at all."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, nq, hd)).astype(np.float32)
    pk = rng.normal(size=(n_slots, bs, nkv, hd)).astype(np.float32)
    pv = rng.normal(size=(n_slots, bs, nkv, hd)).astype(np.float32)
    slot_req = np.full((n_slots,), -1, np.int32)
    slot_base = rng.integers(0, 64, size=n_slots).astype(np.int32)
    order = rng.permutation(n_slots)
    table = np.full((b, 8), -1, np.int32)
    k = 0
    for r in range(b):
        if r == empty_row:
            continue
        for j in range(q_pos[r] // bs + 1):
            slot = order[k]
            k += 1
            slot_req[slot], slot_base[slot] = r, j * bs
            table[r, j] = slot
    return dict(q=q, pk=pk, pv=pv, slot_req=slot_req, slot_base=slot_base,
                q_pos=np.asarray(q_pos, np.int32), table=table)


def _jax_partials(s, cfg):
    return jpa.pool_partials(jnp.asarray(s["q"]), jnp.asarray(s["pk"]),
                             jnp.asarray(s["pv"]), jnp.asarray(s["slot_req"]),
                             jnp.asarray(s["slot_base"]),
                             jnp.asarray(s["q_pos"]), cfg)


def _torch_partials(s, cfg):
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    return tpa.pool_partials(t["q"], t["pk"], t["pv"], t["slot_req"],
                             t["slot_base"], t["q_pos"], cfg)


# ---------------------------------------------------------------------------
# K1: paged decode partials
# ---------------------------------------------------------------------------


POOL_CHANGES = [
    {},                              # causal only (yi-6b)
    {"sliding_window": 12},          # sliding window
    {"attention_chunk": 16},         # chunked-local
    {"logit_softcap": 5.0},          # softcapped scores
]


@pytest.mark.parametrize("changes,heads", [
    pytest.param(c, heads, id=f"changes{i}{name}")
    for name, heads in (("", (4, 1)), ("-gq3", (6, 2)), ("-gq6", (12, 2)))
    for i, c in enumerate(POOL_CHANGES)])
def test_pool_partials_match_jax(changes, heads):
    """gq 4 (the reduced configs), 3, and 6 (dbrx-132b and
    nemotron-4-15b, 48 q over 8 kv heads)."""
    nq, nkv = heads
    jcfg, tcfg = _cfgs(**changes)
    s = _scenario(nq=nq, nkv=nkv)
    jp, tp = _jax_partials(s, jcfg), _torch_partials(s, tcfg)
    for name in ("m", "l", "acc"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)), **TOL)
    np.testing.assert_allclose(tpa.finalize(tp).numpy(),
                               np.asarray(jpa.finalize(jp)), **TOL)


def test_empty_request_and_free_slots():
    """A request owning no slot ends at m = -1e30, l = 0, acc = 0 as in JAX;
    free slots (garbage data, slot_req = -1) add nothing."""
    jcfg, tcfg = _cfgs()
    s = _scenario(seed=1, empty_row=1)
    tp = _torch_partials(s, tcfg)
    assert torch.all(tp.m[1] == -1e30) and torch.all(tp.l[1] == 0)
    assert torch.all(tp.acc[1] == 0)
    jp = _jax_partials(s, jcfg)
    np.testing.assert_allclose(tp.m.numpy(), np.asarray(jp.m), **TOL)
    # changing only the free slots' data leaves the result bit-identical
    s2 = dict(s, pk=s["pk"].copy(), pv=s["pv"].copy())
    free = s["slot_req"] < 0
    s2["pk"][free] = 1e3
    s2["pv"][free] = -1e3
    tp2 = _torch_partials(s2, tcfg)
    assert torch.equal(tp.acc, tp2.acc) and torch.equal(tp.l, tp2.l)


def test_paged_attention_matches_pallas_kernel():
    """Turn the Pallas kernel's block table into slot_req/slot_base and
    compare the normalised outputs."""
    jcfg, tcfg = _cfgs()
    s = _scenario(seed=2, n_slots=10, q_pos=(29, 13, 3))
    ref = pallas_paged_attention(
        jnp.asarray(s["q"]), jnp.asarray(s["pk"]), jnp.asarray(s["pv"]),
        jnp.asarray(s["table"][:, :4]), jnp.asarray(s["q_pos"]),
        interpret=True)
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    got = tpa.paged_decode_attention(
        t["q"], [(t["pk"], t["pv"], t["slot_req"], t["slot_base"])],
        t["q_pos"], tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_two_pool_merge_matches_jax_and_single_pool():
    """[local, peer]: the peer tier joins the softmax through the LSE merge;
    the result equals one pool holding the union of the slots."""
    jcfg, tcfg = _cfgs()
    s = _scenario(seed=3, n_slots=12)
    split = 5
    pools_np = [(s["pk"][:split], s["pv"][:split], s["slot_req"][:split],
                 s["slot_base"][:split]),
                (s["pk"][split:], s["pv"][split:], s["slot_req"][split:],
                 s["slot_base"][split:])]
    ref = jpa.paged_decode_attention(
        jnp.asarray(s["q"]), [tuple(map(jnp.asarray, p)) for p in pools_np],
        jnp.asarray(s["q_pos"]), jcfg)
    t_pools = [tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in p)
               for p in pools_np]
    got = tpa.paged_decode_attention(torch.from_numpy(s["q"]), t_pools,
                                     torch.from_numpy(s["q_pos"]), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    union = tpa.paged_decode_attention(
        t["q"], [(t["pk"], t["pv"], t["slot_req"], t["slot_base"])],
        t["q_pos"], tcfg)
    np.testing.assert_allclose(got.numpy(), union.numpy(), **TOL)


def test_append_kv_drops_out_of_range_rows():
    """Rows whose slot is n_slots are dropped, like the JAX scatter's drop
    mode; the port writes in place."""
    rng = np.random.default_rng(4)
    pk = rng.normal(size=(6, 8, 1, 64)).astype(np.float32)
    pv = rng.normal(size=(6, 8, 1, 64)).astype(np.float32)
    k_new = rng.normal(size=(3, 1, 64)).astype(np.float32)
    v_new = rng.normal(size=(3, 1, 64)).astype(np.float32)
    slot = np.asarray([2, 6, 5], np.int32)          # row 1 lives elsewhere
    off = np.asarray([3, 1, 7], np.int32)
    rk, rv = jpa.append_kv(*(jnp.asarray(a) for a in
                             (pk, pv, k_new, v_new, slot, off)))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    out = tpa.append_kv(tk, tv, *(torch.from_numpy(a) for a in
                                  (k_new, v_new, slot, off)))
    assert out[0] is tk and out[1] is tv
    assert np.array_equal(tk.numpy(), np.asarray(rk))
    assert np.array_equal(tv.numpy(), np.asarray(rv))


def test_paged_partials_wrapper_checks_shapes():
    s = _scenario()
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    with pytest.raises(ValueError):
        pops.paged_decode_partials(t["q"][..., :32], t["pk"], t["pv"],
                                   t["slot_req"], t["slot_base"], t["q_pos"],
                                   scale=0.125)
    with pytest.raises(ValueError):
        pops.paged_decode_partials(t["q"], t["pk"], t["pv"],
                                   t["slot_req"][:4], t["slot_base"],
                                   t["q_pos"], scale=0.125)


@pytest.mark.parametrize("b,nkv,n_slots,sms,want", [
    (2, 8, 800, 132, 33),        # h2o-danube-3-4b's long pool on an H100
    (2, 8, 60_000, 132, 33),     # the same rows in a pool 75x larger
    (4, 4, 10, 132, 1),          # yi-6b's decode shape: 2 slots a split
    (64, 4, 58_593, 132, 3),     # a card-filling pool of short contexts
    (33, 32, 2_400, 132, 1),     # more (request, kv head) pairs than a wave
])
def test_paged_splits_follow_card_not_pool(b, nkv, n_slots, sms, want):
    """K1's split count: about one wave of BLOCKS_PER_SM blocks per SM,
    no split with fewer than MIN_SLOTS_PER_SPLIT slots per request on
    average, and no growth with the pool past that."""
    splits = pops.num_splits(b, nkv, n_slots, sms)
    assert splits == want
    assert b * nkv * (splits - 1) < pops.BLOCKS_PER_SM * sms
    assert splits == 1 or splits <= n_slots // (b * pops.MIN_SLOTS_PER_SPLIT)


# ---------------------------------------------------------------------------
# K2 / K3: quantize-on-demote, dequantize-on-reload
# ---------------------------------------------------------------------------


def _pool(seed, n_slots, elems, zero_row=None):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.01, 30.0, size=(n_slots, 1))
    src = (rng.normal(size=(n_slots, elems)) * scale).astype(np.float32)
    if zero_row is not None:
        src[zero_row] = 0.0
    return src


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


#: the pool dtypes K2 and K3 take (the Pallas kernels take any floating
#: pool): (JAX dtype, torch dtype)
POOL_DTYPES = {"float32": (jnp.float32, torch.float32),
               "bfloat16": (jnp.bfloat16, torch.bfloat16),
               "float16": (jnp.float16, torch.float16)}


def _pools(src, dtype):
    """``src`` (f32) rounded to ``dtype`` in both packages, the same bits."""
    jdt, tdt = POOL_DTYPES[dtype]
    j, t = jnp.asarray(src).astype(jdt), torch.from_numpy(src).to(tdt)
    assert np.array_equal(np.asarray(j).view(np.uint8), _bits(t).reshape(
        np.asarray(j).view(np.uint8).shape))
    return j, t


@pytest.mark.parametrize("dtype", sorted(POOL_DTYPES))
@pytest.mark.parametrize("fidelity", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("elems", [64, 37])          # even and odd widths
def test_quantize_bit_identical_to_pallas(fidelity, elems, dtype):
    """K2's plain version against the Pallas kernel on an f32, bf16 or f16
    pool (each element read as f32)."""
    jsrc, tsrc = _pools(_pool(5, 9, elems, zero_row=4), dtype)
    ids = np.asarray([4, 0, 7, 2], np.int32)
    jv, js = j_quant(jsrc, jnp.asarray(ids), fidelity=fidelity,
                     interpret=True)
    tv, ts = hops.quantize_blocks(tsrc, torch.from_numpy(ids),
                                  fidelity=fidelity)
    assert tv.dtype == hops.FIDELITY_QDTYPE[fidelity]
    assert np.array_equal(_bits(tv), np.asarray(jv).view(np.uint8))
    assert np.array_equal(ts.numpy().view(np.uint32),
                          np.asarray(js).view(np.uint32))
    assert ts[0, 0] == 1.0                  # the all-zero row's unit scale


def test_fp8_saturation_boundary_matches_jax():
    """Rows whose absmax element lands on e4m3's 448 after the division,
    and neighbours just inside it."""
    row = np.asarray([[3.0, -3.0, 2.9999, 2.99, 1e-3, -1e-7, 0.0, 2.5],
                      [-1.0, 0.99999994, 0.5, -0.25, 1e-30, 0.0, 0.0, 0.0]],
                     np.float32)
    ids = np.asarray([0, 1], np.int32)
    jv, js = j_quant(jnp.asarray(row), jnp.asarray(ids), fidelity="fp8",
                     interpret=True)
    tv, ts = hops.quantize_blocks(torch.from_numpy(row),
                                  torch.from_numpy(ids), fidelity="fp8")
    assert np.array_equal(_bits(tv), np.asarray(jv).view(np.uint8))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert tv[0, 0].float().item() == 448.0


@pytest.mark.parametrize("dtype", sorted(POOL_DTYPES))
@pytest.mark.parametrize("fidelity", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("elems", [64, 37])
def test_dequantize_bit_identical_and_in_place(fidelity, elems, dtype):
    """K3's plain version against the Pallas kernel into an f32, bf16 or
    f16 pool (the f32 product rounded to the pool's dtype), from K2's
    values of a pool of that dtype."""
    jsrc, tsrc = _pools(_pool(6, 9, elems, zero_row=3), dtype)
    jdst, dst = _pools(_pool(7, 11, elems), dtype)
    ids = np.asarray([3, 8, 1], np.int32)
    dst_ids = np.asarray([10, 0, 5], np.int32)
    jv, js = j_quant(jsrc, jnp.asarray(ids), fidelity=fidelity,
                     interpret=True)
    ref = j_dequant(jdst, jv, js, jnp.asarray(dst_ids), fidelity=fidelity,
                    interpret=True)
    tv, ts = hops.quantize_blocks(tsrc, torch.from_numpy(ids),
                                  fidelity=fidelity)
    tdst = dst.clone()
    out = hops.dequantize_blocks(tdst, tv, ts, torch.from_numpy(dst_ids),
                                 fidelity=fidelity)
    assert out is tdst and tdst.dtype == dst.dtype
    # every slot, touched or not, bit for bit
    assert _same_bits(tdst, ref)
    untouched = np.setdiff1d(np.arange(11), dst_ids)
    assert torch.equal(tdst[untouched].view(torch.uint8),
                       dst[untouched].view(torch.uint8))


def _quantize(impl, src, ids, fidelity="int8"):
    if impl == "jax":
        return j_quant(jnp.asarray(src), jnp.asarray(ids), fidelity=fidelity,
                       interpret=True)
    return hops.quantize_blocks(torch.from_numpy(src), ids, fidelity=fidelity)


def _dequantize(impl, dst, values, scales, ids):
    if impl == "jax":
        return j_dequant(jnp.asarray(dst), values, scales, jnp.asarray(ids),
                         interpret=True)
    return hops.dequantize_blocks(torch.from_numpy(dst), values, scales, ids)


@pytest.mark.parametrize("impl", ["jax", "port"])
@pytest.mark.parametrize("exc,pool,ids,fidelity", [
    (IndexError, lambda a: a, [0, 4], "int8"),          # id past the pool
    (IndexError, lambda a: a, [-1], "int8"),            # negative id
    (ValueError, lambda a: a, [0, 2], "fp16"),          # unknown fidelity
    (ValueError, lambda a: a.reshape(-1), [0, 2], "int8"),   # 1-D pool
    (TypeError, lambda a: a.astype(np.int32), [0, 2], "int8"),
])
def test_quantize_rejects_like_jax(impl, exc, pool, ids, fidelity):
    src = pool(_pool(8, 4, 16))
    with pytest.raises(exc):
        _quantize(impl, src, np.asarray(ids, np.int32), fidelity)


@pytest.mark.parametrize("impl", ["jax", "port"])
@pytest.mark.parametrize("exc,ids,cut_values,cut_scales", [
    (IndexError, [0, 9], False, False),                 # id past the pool
    (ValueError, [0, 2], True, False),                  # values shape
    (ValueError, [0, 2], False, True),                  # scales shape
])
def test_dequantize_rejects_like_jax(impl, exc, ids, cut_values, cut_scales):
    src = _pool(8, 4, 16)
    values, scales = _quantize(impl, src, np.asarray([0, 2], np.int32))
    values = values[:1] if cut_values else values
    scales = scales[:1] if cut_scales else scales
    with pytest.raises(exc):
        _dequantize(impl, src.copy(), values, scales,
                    np.asarray(ids, np.int32))


def test_dequantize_refuses_duplicate_slots():
    """Two reloads into one slot are a plan bug: the port refuses them
    (the JAX kernel documents the contract without checking it)."""
    src = _pool(8, 4, 16)
    values, scales = _quantize("port", src, np.asarray([0, 2], np.int32))
    with pytest.raises(ValueError):
        _dequantize("port", src.copy(), values, scales,
                    np.asarray([1, 1], np.int32))


@pytest.mark.parametrize("m", [3, hops.IDS_BY_VALUE + 72])
def test_copy_and_dequantize_refuse_bad_ids(m):
    """The checks that make K5's and K3's launches safe hold at any row
    count (on the card, ids in the launch up to ``IDS_BY_VALUE`` rows and a
    device table past it) and for ids as arrays or tensors: an id out of
    range raises IndexError; a repeated destination, a row both read and
    written in one pool (copy) and a repeated slot (dequantize) raise
    ValueError; a refused call writes nothing."""
    n = 2 * m + 4
    rng = np.random.default_rng(26)
    src = torch.from_numpy(rng.normal(size=(n, 24)).astype(np.float32))
    dst = src + 1.0
    sids = np.arange(m, dtype=np.int32)
    dids = np.arange(m, 2 * m, dtype=np.int32)
    values, scales = hops.quantize_blocks(src, sids, fidelity="int4")
    past, neg, twice = (np.r_[dids[:-1], n].astype(np.int32),
                        np.r_[-1, dids[1:]].astype(np.int32),
                        np.r_[dids[:-1], dids[0]].astype(np.int32))
    overlap = np.r_[dids[:-1], sids[0]].astype(np.int32)
    for wrap in (np.asarray, torch.from_numpy):
        calls = [
            (IndexError, lambda: hops.copy_blocks(src, dst, wrap(sids),
                                                  wrap(past))),
            (IndexError, lambda: hops.copy_blocks(src, dst, wrap(neg),
                                                  wrap(dids))),
            (ValueError, lambda: hops.copy_blocks(src, dst, wrap(sids),
                                                  wrap(twice))),
            (ValueError, lambda: hops.copy_blocks(dst, dst, wrap(sids),
                                                  wrap(overlap))),
            (IndexError, lambda: hops.dequantize_blocks(
                dst, values, scales, wrap(past), fidelity="int4")),
            (IndexError, lambda: hops.dequantize_blocks(
                dst, values, scales, wrap(dids), fidelity="int4",
                host_ids=neg)),
            (ValueError, lambda: hops.dequantize_blocks(
                dst, values, scales, wrap(twice), fidelity="int4"))]
        for exc, call in calls:
            before = dst.clone()
            with pytest.raises(exc):
                call()
            assert torch.equal(dst, before)
    # the same ids, unrefused, move every row
    hops.copy_blocks(dst, dst, sids, dids)
    assert torch.equal(dst[dids], dst[sids])
    hops.dequantize_blocks(dst, values, scales, dids, fidelity="int4")
    assert torch.equal(dst[dids], hops.dequantize_blocks_plain(
        torch.empty((m, 24)), values, scales, np.arange(m), "int4"))


def test_scatter_and_copy_match_jax_refs():
    src = _pool(9, 6, 24)
    dst = _pool(10, 8, 24)
    sids = np.asarray([5, 0, 3], np.int32)
    dids = np.asarray([1, 7, 2], np.int32)
    ref = harvest_copy_ref(jnp.asarray(src), jnp.asarray(dst),
                           jnp.asarray(sids), jnp.asarray(dids))
    got = hops.copy_blocks(torch.from_numpy(src), torch.from_numpy(dst.copy()),
                           sids, dids)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    staging = src[:3]
    ref = harvest_scatter_ref(jnp.asarray(dst), jnp.asarray(staging),
                              jnp.asarray(dids))
    got = hops.scatter_blocks(torch.from_numpy(dst.copy()),
                              torch.from_numpy(staging), dids)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(IndexError):
        hops.copy_blocks(torch.from_numpy(src), torch.from_numpy(dst),
                         sids, np.asarray([0, 1, 8]))
    with pytest.raises(IndexError):
        hops.scatter_blocks(torch.from_numpy(dst), torch.from_numpy(staging),
                            np.asarray([0, -1, 2]))


# ---------------------------------------------------------------------------
# K6 gather and K5 fused copy against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

MOVER_DTYPES = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _mover_pools(seed, dtype, elems):
    jdt, tdt = MOVER_DTYPES[dtype]
    src, dst = _pool(seed, 9, elems), _pool(seed + 1, 7, elems)
    return ((jnp.asarray(src, jdt), jnp.asarray(dst, jdt)),
            (torch.from_numpy(src).to(tdt), torch.from_numpy(dst).to(tdt)))


def _same_bits(t: torch.Tensor, a) -> bool:
    return np.array_equal(_bits(t), np.asarray(a).view(np.uint8).reshape(
        t.shape[0], -1))


@pytest.mark.parametrize("dtype", sorted(MOVER_DTYPES))
@pytest.mark.parametrize("elems", [16, 37, 600])
def test_gather_blocks_bit_identical_to_pallas(dtype, elems):
    """Odd widths (the Pallas kernel pads its trailing 16-element chunk)
    and a repeated id, bit for bit."""
    (jsrc, _), (tsrc, _) = _mover_pools(20, dtype, elems)
    ids = np.asarray([7, 0, 3, 7], np.int32)
    ref = pallas_gather(jsrc, jnp.asarray(ids), chunk=16, interpret=True)
    got = hops.gather_blocks(tsrc, ids)
    assert got.dtype == tsrc.dtype and tuple(got.shape) == (4, elems)
    assert _same_bits(got, ref)


@pytest.mark.parametrize("dtype", sorted(MOVER_DTYPES))
@pytest.mark.parametrize("elems", [16, 37, 600])
def test_copy_blocks_bit_identical_to_pallas(dtype, elems):
    """Rows outside the destination ids keep their bits; two pools, and
    one pool copied into itself."""
    (jsrc, jdst), (tsrc, tdst) = _mover_pools(21, dtype, elems)
    sids = np.asarray([5, 0, 8], np.int32)
    dids = np.asarray([1, 6, 2], np.int32)
    ref = pallas_copy(jsrc, jdst, jnp.asarray(sids), jnp.asarray(dids),
                      chunk=16, interpret=True)
    got = hops.copy_blocks(tsrc, tdst.clone(), sids, dids)
    assert _same_bits(got, ref)
    assert torch.equal(got[[0, 3, 4, 5]], tdst[[0, 3, 4, 5]])
    ref = pallas_copy(jsrc, jsrc, jnp.asarray(sids), jnp.asarray([1, 2, 3]),
                      chunk=16, interpret=True)
    pool = tsrc.clone()
    assert hops.copy_blocks(pool, pool, sids, [1, 2, 3]) is pool
    assert _same_bits(pool, ref)


def test_movers_reject_like_jax():
    """Out-of-range ids raise IndexError in both packages; the port also
    refuses what would make the copy depend on the order of its writes
    (a repeated destination, a row both read and written in one pool) and
    pools that differ in dtype or row size."""
    (jsrc, jdst), (tsrc, tdst) = _mover_pools(22, "float32", 24)
    for jcall, tcall in (
            (lambda: pallas_gather(jsrc, jnp.asarray([0, 9])),
             lambda: hops.gather_blocks(tsrc, np.asarray([0, 9]))),
            (lambda: pallas_copy(jsrc, jdst, jnp.asarray([0, 1]),
                                 jnp.asarray([7, 0])),
             lambda: hops.copy_blocks(tsrc, tdst, [0, 1], [7, 0])),
            (lambda: pallas_copy(jsrc, jdst, jnp.asarray([-1, 1]),
                                 jnp.asarray([2, 0])),
             lambda: hops.copy_blocks(tsrc, tdst, [-1, 1], [2, 0]))):
        with pytest.raises(IndexError):
            jcall()
        with pytest.raises(IndexError):
            tcall()
    with pytest.raises(ValueError, match="unique"):
        hops.copy_blocks(tsrc, tdst, [0, 1], [3, 3])
    with pytest.raises(ValueError, match="race"):
        hops.copy_blocks(tsrc, tsrc, [0, 1], [1, 2])
    with pytest.raises(ValueError):
        hops.copy_blocks(tsrc, tdst[:, :20].contiguous(), [0], [0])
    with pytest.raises(TypeError):
        hops.copy_blocks(tsrc, tdst.double(), [0], [0])
    with pytest.raises(ValueError):
        hops.gather_blocks(tsrc[0], [0])


@pytest.mark.parametrize("dtype", sorted(MOVER_DTYPES))
def test_gather_blocks_into_out_matches_pallas(dtype):
    """Gathering into a caller's buffer (the engine gathers k and v into
    the two halves of one) writes the same bits as the Pallas gather and
    leaves the rest of the buffer alone; a buffer of the wrong shape,
    dtype or layout is refused."""
    (jsrc, _), (tsrc, _) = _mover_pools(23, dtype, 37)
    ids = np.asarray([8, 2, 5], np.int32)
    ref = pallas_gather(jsrc, jnp.asarray(ids), chunk=16, interpret=True)
    buf = torch.full((2, 3, 37), 7.0, dtype=tsrc.dtype)
    out = buf[1]
    assert hops.gather_blocks(tsrc, ids, out=out) is out
    assert _same_bits(buf[1], ref)
    assert torch.all(buf[0] == 7.0)
    for bad in (torch.empty((2, 37), dtype=tsrc.dtype),
                torch.empty((3, 37), dtype=torch.float64),
                torch.empty((37, 3), dtype=tsrc.dtype).t()):
        with pytest.raises(ValueError):
            hops.gather_blocks(tsrc, ids, out=bad)


PAYLOAD_DTYPES = {"float32": (jnp.float32, torch.float32),
                  "bfloat16": (jnp.bfloat16, torch.bfloat16),
                  "int8": (jnp.int8, torch.int8)}


@pytest.mark.parametrize("dtype", sorted(PAYLOAD_DTYPES))
@pytest.mark.parametrize("elems", [37, 64])
def test_gather_blocks_into_strided_payload_matches_pallas(dtype, elems):
    """The engine's eviction: k and v of one slot's every layer gathered
    into the two halves ``payload[:, 0]`` and ``payload[:, 1]`` of one
    (L, 2, ...) buffer, strided views of it, with the ids as a tensor and
    their host mirror; each half bit-identical to the Pallas gather."""
    jdt, tdt = PAYLOAD_DTYPES[dtype]
    L, n_slots, slot = 3, 5, 2
    rng = np.random.default_rng(24)
    pools = [np.clip(rng.normal(size=(L * n_slots, elems)) * 40, -127, 127)
             for _ in range(2)]
    host = np.arange(L, dtype=np.int32) * n_slots + slot
    payload = torch.full((L, 2, elems), 7, dtype=tdt)
    for h, pool in enumerate(pools):
        out = payload[:, h]
        assert not out.is_contiguous()
        got = hops.gather_blocks(torch.from_numpy(pool).to(tdt),
                                 torch.from_numpy(host), out=out,
                                 host_ids=host)
        assert got is out
        ref = pallas_gather(jnp.asarray(pool, jdt), jnp.asarray(host),
                            chunk=16, interpret=True)
        assert _same_bits(payload[:, h], ref)
    bad = torch.empty((elems + 2,), dtype=tdt).as_strided((L, elems), (1, 1))
    with pytest.raises(ValueError, match="overlap"):
        hops.gather_blocks(torch.from_numpy(pools[0]).to(tdt), host, out=bad)


def test_host_mirror_is_what_the_checks_read():
    """With ``host_ids`` the wrappers check the mirror, not the ids: an
    out-of-range id in the mirror raises IndexError, a mirror of another
    size ValueError; with a true mirror every result is the one without."""
    src = _pool(25, 6, 40, zero_row=1)
    tsrc = torch.from_numpy(src)
    ids = torch.tensor([1, 4, 0], dtype=torch.int32)
    host = ids.numpy().copy()
    gv, gs = hops.quantize_blocks(tsrc, ids, fidelity="int4", host_ids=host)
    v, s = hops.quantize_blocks(tsrc, ids, fidelity="int4")
    assert torch.equal(gv, v) and torch.equal(gs, s)
    got = hops.dequantize_blocks(tsrc.clone(), v, s, ids, fidelity="int4",
                                 host_ids=host)
    assert torch.equal(got, hops.dequantize_blocks(tsrc.clone(), v, s, ids,
                                                   fidelity="int4"))
    assert torch.equal(hops.gather_blocks(tsrc, ids, host_ids=host),
                       hops.gather_blocks(tsrc, ids))
    for mirror, exc in (([1, 6, 0], IndexError), ([1, -1, 0], IndexError),
                        ([1, 4], ValueError)):
        mirror = np.asarray(mirror, np.int32)
        with pytest.raises(exc):
            hops.gather_blocks(tsrc, ids, host_ids=mirror)
        with pytest.raises(exc):
            hops.quantize_blocks(tsrc, ids, host_ids=mirror)
        with pytest.raises(exc):
            hops.dequantize_blocks(tsrc.clone(), v, s, ids,
                                   fidelity="int4", host_ids=mirror)
