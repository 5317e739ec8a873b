"""The port's incremental fork choice (Queue 2 B9, ``ops/forkchoice.py``)
and its resident store (B11, ``ops/resident.py``) against the JAX
package's on the CPU, tolerance 0: each B9 function against its jitted
JAX twin on seeded tables (duplicate validators, inactive and padded
entries, ties in epoch, windowed columns at the window's edges, a batch
of 8,192), the host staging and walks on the same chain, the resident
head against the JAX store's and the host walk at every query of a
3-epoch run with an equivocator, capacity growth, the degradation
paths, and ``convert.resident_to_port``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from pos_evolution_tpu import config as jc  # noqa: E402
from pos_evolution_tpu import sim as jsim  # noqa: E402
from pos_evolution_tpu.backend import set_backend as jax_set_backend  # noqa: E402
from pos_evolution_tpu.ops import forkchoice as jofc  # noqa: E402
from pos_evolution_tpu.ops import resident as jres  # noqa: E402
from pos_evolution_tpu.specs import forkchoice as jfc  # noqa: E402
from pos_evolution_tpu.specs import genesis as jgen  # noqa: E402
from pos_evolution_tpu.specs import validator as jval  # noqa: E402
from pos_evolution_tpu.ssz import hash_tree_root as jhtr  # noqa: E402
from pos_evolution_tpu_torch import config as tc  # noqa: E402
from pos_evolution_tpu_torch import convert  # noqa: E402
from pos_evolution_tpu_torch import sim as tsim  # noqa: E402
from pos_evolution_tpu_torch.backend import use_backend  # noqa: E402
from pos_evolution_tpu_torch.ops import forkchoice as tofc  # noqa: E402
from pos_evolution_tpu_torch.ops import resident as tres  # noqa: E402
from pos_evolution_tpu_torch.specs import forkchoice as tfc  # noqa: E402
from pos_evolution_tpu_torch.specs import genesis as tgen  # noqa: E402
from pos_evolution_tpu_torch.specs import validator as tval  # noqa: E402
from pos_evolution_tpu_torch.ssz import hash_tree_root as thtr  # noqa: E402


@pytest.fixture(autouse=True)
def _minimal_cpu():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jax_set_backend("numpy")
    with jc.use_config(jc.minimal_config()), tc.use_config(tc.minimal_config()), \
            use_backend("torch", device="cpu"):
        yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _eq(t: torch.Tensor, j) -> bool:
    a, b = t.numpy(), np.asarray(j)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# --- B9 on seeded tables ---------------------------------------------------------


def _table(rng, n: int, nb: int):
    msg_block = rng.integers(-1, nb, n).astype(np.int32)
    msg_epoch = np.where(msg_block >= 0, rng.integers(0, 6, n), 0).astype(np.int64)
    weight = rng.integers(1, 64, n).astype(np.int64) * 10**9
    buckets = np.zeros(nb, np.int64)
    np.add.at(buckets, msg_block[msg_block >= 0], weight[msg_block >= 0])
    return msg_block, msg_epoch, weight, buckets


def _batch(rng, n: int, nb: int, k: int, pad: int):
    """A vote batch of ``k`` entries: validators drawn from a small range
    (duplicates), epochs from a small range (ties), a fifth inactive, a
    tenth voting for no block, and ``pad`` trailing flush padding entries
    (validator 0, block -1, epoch 0)."""
    live = k - pad
    val = rng.integers(0, max(live // 3, 2), live).astype(np.int32)
    block = np.where(rng.random(live) < 0.1, -1, rng.integers(0, nb, live)).astype(np.int32)
    epoch = rng.integers(0, 8, live).astype(np.int64)
    active = rng.random(live) < 0.8
    val = np.concatenate([val, np.zeros(pad, np.int32)])
    block = np.concatenate([block, np.full(pad, -1, np.int32)])
    epoch = np.concatenate([epoch, np.zeros(pad, np.int64)])
    active = np.concatenate([active, np.ones(pad, bool)])
    return val, block, epoch, active


CASES = [(0, 64, 16, 32, 5), (1, 256, 64, 128, 0), (2, 1024, 8, 256, 17),
         (3, 65_536, 256, 8192, 100)]


@pytest.mark.parametrize("seed,n,nb,k,pad", CASES, ids=[f"k{c[3]}" for c in CASES])
def test_vote_landing_and_apply_equal_jax(seed, n, nb, k, pad):
    rng = np.random.default_rng(seed)
    mb, me, w, buckets = _table(rng, n, nb)
    val, block, epoch, active = _batch(rng, n, nb, k, pad)
    j = jax.jit(jofc._vote_landing)(jnp.asarray(mb), jnp.asarray(me), jnp.asarray(val),
                                    jnp.asarray(block), jnp.asarray(epoch),
                                    jnp.asarray(active))
    t = tofc._vote_landing(_t(mb), _t(me), _t(val), _t(block), _t(epoch), _t(active))
    assert all(_eq(a, b) for a, b in zip(t, j))
    lands = t[0].numpy()
    dup = np.bincount(val[lands], minlength=1)
    assert dup.max(initial=0) <= 1, "one landing entry per validator"
    assert lands.any() and (~lands & active & (block >= 0)).any()

    jw = w[val]
    jout = jofc.apply_latest_messages(jnp.asarray(mb), jnp.asarray(me), jnp.asarray(buckets),
                                      jnp.asarray(val), jnp.asarray(block),
                                      jnp.asarray(epoch), jnp.asarray(jw), jnp.asarray(active))
    tout = tofc.apply_latest_messages(_t(mb), _t(me), _t(buckets), _t(val), _t(block),
                                      _t(epoch), _t(jw), _t(active))
    assert all(_eq(a, b) for a, b in zip(tout, jout))
    # the buckets stay the segment sum of the table
    assert _eq(tout[2], tofc.rebuild_buckets(tout[0], _t(w), nb).numpy())

    victims = np.unique(rng.integers(0, n, 7)).astype(np.int32)
    jrm = jofc.remove_latest_messages(*(jnp.asarray(np.asarray(x)) for x in jout),
                                      jnp.asarray(victims), jnp.asarray(w[victims]))
    trm = tofc.remove_latest_messages(*tout, _t(victims), _t(w[victims]))
    assert all(_eq(a, b) for a, b in zip(trm, jrm))


@pytest.mark.parametrize("seed", [0, 1])
def test_epoch_buckets_equal_jax_at_the_window_edges(seed):
    rng = np.random.default_rng(10 + seed)
    n, nb, window, base = 512, 32, 4, 3
    mb, _, w, _ = _table(rng, n, nb)
    # epochs below, at, inside, at the top of and above the window
    me = rng.choice(np.array([0, 2, 3, 4, 5, 6, 7, 9], np.int64), n)
    jb = jofc.rebuild_epoch_buckets(jnp.asarray(mb), jnp.asarray(me), jnp.asarray(w),
                                    capacity=nb, window=window, base_epoch=base)
    tb = tofc.rebuild_epoch_buckets(_t(mb), _t(me), _t(w), nb, window, base)
    assert _eq(tb, jb)
    assert int(tb.sum()) == int(w[(mb >= 0) & (me >= base)].sum())

    val, block, epoch, active = _batch(rng, n, nb, 256, 9)
    epoch = rng.choice(np.array([1, 3, 5, 6, 8, 12], np.int64), 256)
    epoch[-9:] = 0
    jout = jofc.apply_latest_messages_windowed(
        jnp.asarray(mb), jnp.asarray(me), jb, jnp.int64(base), jnp.asarray(val),
        jnp.asarray(block), jnp.asarray(epoch), jnp.asarray(w[val]), jnp.asarray(active))
    tout = tofc.apply_latest_messages_windowed(_t(mb), _t(me), tb, base, _t(val), _t(block),
                                               _t(epoch), _t(w[val]), _t(active))
    assert all(_eq(a, b) for a, b in zip(tout, jout))
    assert _eq(tout[2], tofc.rebuild_epoch_buckets(tout[0], tout[1], _t(w), nb, window,
                                                   base).numpy())

    parent = np.concatenate([[-1], rng.integers(0, np.arange(1, nb))]).astype(np.int32)
    real = np.ones(nb, bool)
    rank = rng.permutation(nb).astype(np.int32)
    viable = rng.random(nb) < 0.9
    for mve in (base - 1, base, base + 2, base + window - 1):
        for boost in ((-1, 0), (int(rng.integers(nb)), 7 * 10**9)):
            jh, jw_ = jofc.head_from_epoch_buckets(
                jnp.asarray(parent), jnp.asarray(real), jnp.asarray(rank),
                jnp.asarray(viable), jnp.int32(0), jnp.asarray(np.asarray(jout[2])),
                base, mve, jnp.int32(boost[0]), jnp.int64(boost[1]), nb, window)
            th, tw = tofc.head_from_epoch_buckets(_t(parent), _t(real), _t(rank), _t(viable),
                                                  0, tout[2], base, mve, boost[0], boost[1],
                                                  nb, window)
            assert int(th) == int(jh) and _eq(tw, jw_)
    with pytest.raises(ValueError, match="above the top"):
        tofc.head_from_epoch_buckets(_t(parent), _t(real), _t(rank), _t(viable), 0, tout[2],
                                     base, base + window, -1, 0, nb, window)


# --- host staging on the same chain ---------------------------------------------------


def _chains(n=32, slots=6):
    """The same forked chain with votes in both packages' stores."""
    out = []
    for gen, fc, val, htr in ((jgen, jfc, jval, jhtr), (tgen, tfc, tval, thtr)):
        state, anchor = gen.make_genesis(n)
        store = fc.get_forkchoice_store(state, anchor)
        spt = jc.minimal_config().seconds_per_slot
        parent = state
        for slot in range(1, slots + 1):
            fc.on_tick(store, store.genesis_time + slot * spt)
            for g in ((b"\x0a", b"\x0b") if slot == 3 else (b"\x00",)):
                sb = val.build_block(parent, slot, graffiti=g * 32)
                fc.on_block(store, sb)
            root = htr(sb.message)
            fc.on_tick(store, store.genesis_time + (slot + 1) * spt)
            att = val.make_committee_attestation(store.block_states[root], slot, 0, root)
            fc.on_attestation(store, att)
            parent = store.block_states[root]
        out.append(store)
    return out


def test_host_staging_and_walks_equal_jax():
    js, ts = _chains()
    jcols, jroots, jcap = jofc.build_dense_arrays(js)
    tcols, troots, tcap = tofc.build_dense_arrays(ts)
    assert jroots == troots and jcap == tcap and jcols.keys() == tcols.keys()
    for k in jcols:
        assert np.asarray(jcols[k]).dtype == np.asarray(tcols[k]).dtype, k
        assert np.array_equal(jcols[k], tcols[k]), k
    dense, roots, cap = tofc.build_dense_store(ts, device="cpu")
    assert all(_eq(getattr(dense, f), jcols[f]) for f in dense._fields)
    want = jfc.get_head(js)
    assert jofc.get_head_host(js) == tofc.get_head_host(ts) == want
    assert jofc.get_head_dense(js) == tofc.get_head_dense(ts, device="cpu") == want


# --- the resident store -----------------------------------------------------------------


def _recording(resident_cls, get_head_host, log):
    """A ``ResidentForkChoice`` subclass that logs (answer, host walk) for
    every head query."""
    class Recording(resident_cls):
        def head(self, store):
            root = super().head(store)
            log.append((root, get_head_host(store)))
            return root
    return Recording


def test_resident_head_equals_jax_at_every_query(monkeypatch):
    """A 3-epoch accelerated run with an equivocator and the default
    monitors (slashings reach the resident store): every head query of
    the port's resident store equals the JAX store's answer to the same
    query and the host walk."""
    from pos_evolution_tpu.specs import helpers as jh
    logs = {"jax": [], "port": []}
    monkeypatch.setattr(jres, "ResidentForkChoice",
                        _recording(jres.ResidentForkChoice, jofc.get_head_host, logs["jax"]))
    monkeypatch.setattr(tres, "ResidentForkChoice",
                        _recording(tres.ResidentForkChoice, tofc.get_head_host, logs["port"]))
    state, _ = jgen.make_genesis(64)
    p2 = int(jh.get_beacon_proposer_index(jval.advance_state_to_slot(state, 2)))
    controlled = {p2} | set(range(4))
    sims = []
    for pkg, kw in ((jsim, {}), (tsim, {"device": "cpu"})):
        sim = pkg.Simulation(64, adversaries=[pkg.Equivocator(controlled)],
                             monitors=pkg.default_monitors(), accelerated_forkchoice=True, **kw)
        for g in sim.groups:
            g.resident.selfcheck_every = 1
        sim.run_epochs(3)
        sims.append(sim)
    jsim_, tsim_ = sims
    assert len(logs["port"]) == len(logs["jax"]) > 3 * 8
    assert logs["port"] == logs["jax"]
    assert all(root == host for root, host in logs["port"])
    store = tsim_.groups[0].store
    assert store.equivocating_indices, "the slashings reached the store"
    res = tsim_.groups[0].resident
    assert not res.degraded and res.incidents == []
    assert res.stats["device_heads"] + res.stats["memo_hits"] == len(logs["port"])
    assert jsim_.metrics == tsim_.metrics


def test_resident_capacity_growth_equals_jax():
    """Past the initial capacity the store rebuilds transparently, head
    for head with the JAX store and the spec walk."""
    stores, residents = [], []
    for gen, fc, res in ((jgen, jfc, jres), (tgen, tfc, tres)):
        state, anchor = gen.make_genesis(32)
        store = fc.get_forkchoice_store(state, anchor)
        stores.append((state, store, fc))
        residents.append(res.ResidentForkChoice(store, capacity=4))
    spt = jc.minimal_config().seconds_per_slot
    parents = [s[0] for s in stores]
    for slot in range(1, 10):
        heads = []
        for i, ((_, store, fc), val, htr) in enumerate(zip(stores, (jval, tval),
                                                           (jhtr, thtr))):
            fc.on_tick(store, store.genesis_time + slot * spt)
            sb = val.build_block(parents[i], slot)
            fc.on_block(store, sb)
            root = htr(sb.message)
            residents[i].note_block(store, root)
            parents[i] = store.block_states[root]
            heads.append((residents[i].head(store), fc.get_head(store)))
        assert heads[0] == heads[1] and heads[1][0] == heads[1][1]
    assert residents[1].capacity == residents[0].capacity >= 10
    assert residents[1].stats["rebuilds"] >= 3


def _short_chain(slots=3):
    state, anchor = tgen.make_genesis(32)
    store = tfc.get_forkchoice_store(state, anchor)
    spt = tc.cfg().seconds_per_slot
    parent = state
    for slot in range(1, slots + 1):
        tfc.on_tick(store, store.genesis_time + slot * spt)
        sb = tval.build_block(parent, slot)
        tfc.on_block(store, sb)
        parent = store.block_states[thtr(sb.message)]
    return store


def test_device_error_falls_back_to_spec_head():
    store = _short_chain()
    resident = tres.ResidentForkChoice(store)

    def boom(store_arg):
        raise RuntimeError("device out of memory")

    resident._device_head = boom
    assert resident.head(store) == tfc.get_head(store)
    assert resident.degraded and "memory" in resident.incidents[0]
    assert resident.head(store) == tfc.get_head(store)


def test_divergence_self_check_catches_corruption():
    state, anchor = tgen.make_genesis(32)
    store = tfc.get_forkchoice_store(state, anchor)
    spt = tc.cfg().seconds_per_slot
    tfc.on_tick(store, store.genesis_time + 2 * spt)
    for g in (b"\x0a", b"\x0b"):
        tfc.on_block(store, tval.build_block(state, 1, graffiti=g * 32))
    resident = tres.ResidentForkChoice(store, selfcheck_every=1)
    # invert the rank order: the device descent breaks the tie wrongly
    resident.rank = resident.rank.max() - resident.rank
    assert resident.head(store) == tfc.get_head(store)
    assert resident.degraded and "divergence" in resident.incidents[0]


def test_degraded_handlers_are_noops_and_a_failed_rebuild_degrades():
    store = _short_chain(2)
    resident = tres.ResidentForkChoice(store)
    resident._degrade("test-injected")
    state = store.block_states[tfc.get_head(store)]
    tfc.on_tick(store, store.genesis_time + 3 * tc.cfg().seconds_per_slot)
    sb = tval.build_block(state, 3)
    tfc.on_block(store, sb)
    resident.note_block(store, thtr(sb.message))
    resident.note_attestation(np.arange(4), 0, thtr(sb.message))
    resident.note_slashing([1, 2])
    assert resident.head(store) == tfc.get_head(store)
    store.justified_checkpoint = type(store.justified_checkpoint)(epoch=0, root=b"\x01" * 32)
    broken = tres.ResidentForkChoice(store)
    assert broken.degraded and "initial rebuild failed" in broken.incidents[0]


def test_selfcheck_period_counts_fresh_queries(monkeypatch):
    store = _short_chain()
    resident = tres.ResidentForkChoice(store, selfcheck_every=4)
    calls = {"n": 0}
    real = tofc.get_head_host

    def counting(store_arg):
        calls["n"] += 1
        return real(store_arg)

    monkeypatch.setattr(tofc, "get_head_host", counting)
    for _ in range(8):
        resident.head(store)
    assert resident._head_queries == 1 and calls["n"] == 0
    assert resident.stats["memo_hits"] == 7
    tip = list(store.blocks.keys())[-1]
    for i in range(7):
        resident.note_attestation(np.array([i]), 1 + i, tip)
        resident.head(store)
    assert resident._head_queries == 8 and calls["n"] == 2
    assert resident.stats == {"device_heads": 8, "memo_hits": 7, "flushes": 7, "rebuilds": 1}
    assert not resident.degraded


# --- carrying a resident store across -----------------------------------------------


def test_resident_to_port_carries_the_jax_image():
    js, ts = _chains()
    jr = jres.ResidentForkChoice(js)
    jr.head(js)
    arrays = {f: np.asarray(getattr(jr, f)) for f in tres.RESIDENT_ARRAYS}
    arrays["roots"] = list(jr.roots)
    tr = convert.resident_to_port(arrays, ts, device="cpu")
    own = tres.ResidentForkChoice(ts)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype
               for a, b in ((arrays[f], getattr(tr, f).numpy()) for f in tres.RESIDENT_ARRAYS))
    got = own.arrays()
    assert got["roots"] == arrays["roots"]
    assert all(np.array_equal(got[f], arrays[f]) for f in tres.RESIDENT_ARRAYS)
    assert tr.head(ts) == own.head(ts) == jr.head(js) == jfc.get_head(js)
