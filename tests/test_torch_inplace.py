"""The harvested peer tier read in place: ``serve_step(...,
harvest_inplace=True)`` with ``state.peer`` set, where each layer's
attention runs K1 over the local pool and over the peer pool and merges
the two pools' partials by log-sum-exp, held against the jitted JAX
``serve_step(..., harvest_inplace=True)`` at the reduced size, bf16
weights, in each of the three branches where JAX reads the peer: the
scan that carries the pools (and its variant that takes them as scan
inputs), the interleaved dense/MoE pairs (Llama-4, 4 layers, its
``layer_period`` 2 put back) and the hybrid super-block (zamba2-7b, 5
layers); and on MusicGen's codebooks.

Each row's blocks are dealt over a local pool and a peer pool (the rest
of each pool free slots of garbage): yi-6b with every row's first block
on the peer, h2o-danube-3-4b with the first half of each row's blocks
there (most of them outside its reduced 64-token window, one row with no
block there at all), the others half.  Three steps each: the logits
within ``LOGIT_TOL`` of JAX's, the argmax tokens equal under the near-tie
guard of tests/test_torch_engine.py, the local pool (where the steps
append) and the peer pool (read only) bit-identical to JAX's after every
step, but the appended rows of the two models whose residual stream runs
a bf16 step apart from JAX's (``APPENDS_A_STEP_APART``); and the port's in-place step against its own fetch step over the
same KV with every block local."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JM
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from test_torch_archs import KV_TOL, LLAMA4, _close
from test_torch_engine import _check_sampled_logits

MUSICGEN = "musicgen-medium"
BS = 8
STEPS = 3
#: arch -> (config changes, each row's first decode position (prefix
#: positions included), which of a row's blocks at prefill lie on the
#: peer: "first" its first, "half" the first half of them)
CASES = {
    "yi-6b": ({}, (41, 24, 33, 17), "first"),
    # rows past the 64-token window: the peer's blocks of the first row lie
    # outside it, the second's across its edge; the third row has no block
    # on the peer
    "h2o-danube-3-4b": ({}, (150, 101, 5), "half"),
    # rows past the 64-token attention chunk
    LLAMA4: (dict(num_layers=4), (130, 70), "half"),
    # the recurrent states of a common prefill: the rows decode in step
    "zamba2-7b": (dict(num_layers=5), (29, 29), "half"),
    # 8 prefix positions ahead of 30 and 21 frames
    MUSICGEN: ({}, (38, 29), "half"),
}
#: the models whose appended k and v differ from JAX's by a bf16 step in
#: a layer past the first: their residual stream enters that layer a bf16
#: rounding apart from JAX's (ROADMAP C), Llama-4's after its dense layer
#: (74 of the step's entries in its MoE layer), zamba2's after its Mamba2
#: layers (219 at the third step).  There every pool entry but the
#: appended rows is held bit for bit and those rows within ``KV_TOL``;
#: for the other models every entry of both pools bit for bit.
APPENDS_A_STEP_APART = {LLAMA4, "zamba2-7b"}


def _config(get, arch):
    changes, _, _ = CASES[arch]
    cfg = get(arch).reduced()
    if arch == LLAMA4:
        changes = dict(changes, moe=dataclasses.replace(cfg.moe,
                                                        layer_period=2))
    return dataclasses.replace(cfg, **changes)


@functools.lru_cache(maxsize=None)
def _models(arch):
    cfg, tcfg = _config(get_config, arch), _config(t_get_config, arch)
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            tcfg, "cpu")


def _npre(cfg):
    return cfg.modality.num_prefix_embeddings if cfg.modality else 0


def _sequence(cfg, pos):
    """(numpy) the tokens of every row up to the last step's position,
    (b, n) or (b, n, ncb), the positions over prefix and tokens, and bf16
    prefix embeddings (as f32 values) where the model takes them."""
    rng = np.random.default_rng(11)
    npre = _npre(cfg)
    n = max(pos) + STEPS - npre
    ncb = cfg.modality.num_codebooks if cfg.family == "audio" else 0
    toks = rng.integers(0, cfg.vocab_size, size=(len(pos), n) + (
        (ncb,) if ncb else ())).astype(np.int32)
    positions = np.broadcast_to(np.arange(npre + n, dtype=np.int32),
                                (len(pos), npre + n)).copy()
    pre = None
    if npre:
        pre = (0.5 * rng.normal(size=(len(pos), npre, cfg.d_model))).astype(
            np.float32)
        pre = np.asarray(jnp.asarray(pre, jnp.bfloat16), np.float32)
    return toks, positions, pre


def _prefill(cfg, jp, toks, positions, pre, upto):
    """JAX's forward over every row's first ``upto`` positions: the
    stacked KV (L, b, upto, nkv, hd) and the recurrent states."""
    npre = _npre(cfg)
    batch = {"tokens": jnp.asarray(toks[:, :upto - npre]),
             "positions": jnp.asarray(positions[:, :upto])}
    if pre is not None:
        batch["prefix_embeddings"] = jnp.asarray(pre, jnp.bfloat16)
    _, out = jax.jit(lambda p, bt: JM.forward(p, bt, cfg, want_kv=True))(
        jp, batch)
    return out


def _deal(kv, pos, rule, seed=12):
    """Each row's blocks (those its positions up to the last step need)
    dealt over a local and a peer pool in shuffled slot order, the
    prefill's k and v copied in, three free slots of garbage in each pool.
    Returns (local, peer, fetch) as (pool_k, pool_v, slot_req, slot_base)
    numpy tuples, the fetch pools the local slots with every block in
    them, and {(row, block): local slot}."""
    k, v = (np.asarray(t, np.float32) for t in kv)
    L_kv, _, upto, nkv, hd = k.shape
    rng = np.random.default_rng(seed)
    blocks = [(r, j) for r, p in enumerate(pos)
              for j in range((p + STEPS - 1) // BS + 1)]

    def on_peer(r, j):
        n = pos[r] // BS + 1                  # the row's blocks at prefill
        return j == 0 if rule == "first" else j < n // 2

    peer_blocks = [rj for rj in blocks if on_peer(*rj)]
    assert all(j * BS + BS <= pos[r] for r, j in peer_blocks)

    def pool(owned, n_slots):
        slots = rng.permutation(n_slots)[:len(owned)]
        pk = rng.normal(size=(L_kv, n_slots, BS, nkv, hd)).astype(np.float32)
        pv = rng.normal(size=pk.shape).astype(np.float32)
        sr = np.full((n_slots,), -1, np.int32)
        sb = rng.integers(0, 256, size=n_slots).astype(np.int32)
        where = {}
        for (r, j), slot in zip(owned, slots):
            sr[slot], sb[slot] = r, j * BS
            lo, hi = j * BS, min(j * BS + BS, upto)
            pk[:, slot], pv[:, slot] = 0.0, 0.0
            if lo < hi:
                pk[:, slot, :hi - lo] = k[:, r, lo:hi]
                pv[:, slot, :hi - lo] = v[:, r, lo:hi]
            where[(r, j)] = int(slot)
        return (pk, pv, sr, sb), where

    fetch, where = pool(blocks, len(blocks) + 3)
    local = tuple(a.copy() for a in fetch)
    for rj in peer_blocks:                     # harvested: free locally
        local[2][where[rj]] = -1
        local[0][:, where[rj]] = rng.normal(size=local[0][:, 0].shape)
    peer, _ = pool(peer_blocks, len(peer_blocks) + 3)
    return local, peer, fetch, where


def _states(out):
    if out.states is None:
        return None, None
    return out.states, TS.SSMState(*(torch.from_numpy(np.array(
        t, np.float32)).to(getattr(torch, str(t.dtype))) for t in out.states))


def _jax_pools(arrays, b):
    return JM.KVPools(*(jnp.asarray(a) for a in arrays),
                      jnp.zeros((b,), jnp.int32), jnp.zeros((b,), jnp.int32))


def _torch_pools(arrays, b):
    return TM.KVPools(*(torch.from_numpy(a.copy()) for a in arrays),
                      torch.zeros((b,), dtype=torch.int32),
                      torch.zeros((b,), dtype=torch.int32))


def _rows(logits):
    """A step's logits as a list of vectors, one per row (and codebook)."""
    a = np.asarray(logits, np.float32)
    return list(a.reshape(-1, a.shape[-1]))


@pytest.mark.parametrize("arch,carried", [
    ("yi-6b", True), ("yi-6b", False), ("h2o-danube-3-4b", True),
    ("h2o-danube-3-4b", False), (LLAMA4, True), ("zamba2-7b", True),
    (MUSICGEN, True), (MUSICGEN, False)])
def test_inplace_step_matches_jax(arch, carried):
    """``carried``: JAX's default scan that carries the pools, or its
    variant that takes each layer's pool slices as scan inputs (dense and
    audio stacks; the interleaved pairs and the hybrid super-block have
    one branch each)."""
    cfg, tcfg, jp, tp = _models(arch)
    _, pos, rule = CASES[arch]
    b, npre = len(pos), _npre(cfg)
    toks, positions, pre = _sequence(cfg, pos)
    out = _prefill(cfg, jp, toks, positions, pre, max(pos))
    local, peer, fetch, where = _deal(out.kv, pos, rule)
    alone = [r for r in range(b) if r not in peer[2]]
    assert len(alone) == (arch == "h2o-danube-3-4b")
    jstates, tstates = _states(out)
    jst = JM.DecodeState(tokens=None, pos=None, kv=_jax_pools(local, b),
                         peer=_jax_pools(peer, b), states=jstates)
    tpeer = _torch_pools(peer, b)
    tst = TM.DecodeState(tokens=None, pos=None, kv=_torch_pools(local, b),
                         peer=tpeer, states=tstates)
    fst = TM.DecodeState(tokens=None, pos=None, kv=_torch_pools(fetch, b),
                         peer=None, states=tstates)
    jstep = jax.jit(lambda p, st: JM.serve_step(
        p, st, cfg, harvest_inplace=True, carried_pools=carried))
    jlog, tlog, flog = [], [], []
    appended = np.zeros(local[0].shape[:3], bool)     # (L, slot, offset)
    for t in range(STEPS):
        p = np.asarray(pos, np.int32) + t
        aslot = np.asarray([where[(r, q // BS)] for r, q in enumerate(p)],
                           np.int32)
        assert all(local[2][s] == r for r, s in enumerate(aslot))
        aoff = (p % BS).astype(np.int32)
        tok = toks[np.arange(b), p - npre]
        jst = jst._replace(
            tokens=jnp.asarray(tok), pos=jnp.asarray(p),
            kv=jst.kv._replace(append_slot=jnp.asarray(aslot),
                               append_off=jnp.asarray(aoff)))
        step = dict(tokens=torch.from_numpy(tok), pos=torch.from_numpy(p))
        tst = tst._replace(**step, kv=tst.kv._replace(
            append_slot=torch.from_numpy(aslot),
            append_off=torch.from_numpy(aoff)))
        fst = fst._replace(**step, kv=fst.kv._replace(
            append_slot=torch.from_numpy(aslot),
            append_off=torch.from_numpy(aoff)))
        jl, jst = jstep(jp, jst)
        tl, tst = TM.serve_step(tp, tst, tcfg, harvest_inplace=True)
        fl, fst = TM.serve_step(tp, fst, tcfg)
        _close(tl, jl, "bfloat16")
        _close(tl, fl.float(), "bfloat16")
        # a row with no block on the peer: the peer's partials (m -1e30,
        # l 0, acc 0) merge in as nothing, so the row's step is the fetch
        # step's bit for bit
        for r in alone:
            assert torch.equal(tl[r], fl[r]), r
        jlog += _rows(jl)
        tlog += _rows(tl.float())
        flog += _rows(fl.float())
        assert np.array_equal(tst.tokens.numpy(), np.asarray(jst.tokens))
        assert torch.equal(tst.tokens, fst.tokens)
        # the step appended to the local pool alone, as JAX did
        appended[:, aslot, aoff] = True
        for tt, jt in ((tst.kv.pool_k, jst.kv.pool_k),
                       (tst.kv.pool_v, jst.kv.pool_v)):
            got, want = tt.numpy(), np.asarray(jt)
            if arch in APPENDS_A_STEP_APART:
                assert np.array_equal(got[~appended], want[~appended])
                np.testing.assert_allclose(got[appended], want[appended],
                                           **KV_TOL)
            else:
                assert np.array_equal(got, want)
        for tt, jt, orig in zip(tst.peer[:4], jst.peer[:4], peer):
            assert np.array_equal(tt.numpy(), np.asarray(jt))
            assert np.array_equal(tt.numpy(), orig)
    assert tst.peer.pool_k is tpeer.pool_k
    _check_sampled_logits(jlog, tlog)
    _check_sampled_logits(flog, tlog)
