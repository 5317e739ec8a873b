"""The port's spec tier against the JAX package on the CPU, tolerance 0:
the block sweep (Queue 2 B8) against JAX's ``apply_attestation_rows_device``
and ``_host``, its residency cases, ``registry_churn_dense`` and the whole
``process_epoch`` on churny states, a 4-epoch chain of spec blocks against
the JAX package's numpy backend, the ``on_block_batch`` replay, the
carrying of states and blocks across (``convert.spec_to_port``), the
host/device route of host rows, and the default backend's refusal
without CUDA. Both packages' configs are set for each test."""

import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu import config as jc  # noqa: E402
from pos_evolution_tpu.backend import set_backend as jax_set_backend  # noqa: E402
from pos_evolution_tpu.ops import epoch as jep  # noqa: E402
from pos_evolution_tpu.ops import transition as jtr  # noqa: E402
from pos_evolution_tpu.specs import containers as jcont  # noqa: E402
from pos_evolution_tpu.specs import epoch as jsep  # noqa: E402
from pos_evolution_tpu.specs import forkchoice as jfc  # noqa: E402
from pos_evolution_tpu.specs import genesis as jgen  # noqa: E402
from pos_evolution_tpu.specs import transition as jst  # noqa: E402
from pos_evolution_tpu.specs import validator as jval  # noqa: E402
from pos_evolution_tpu.ssz import hash_tree_root as jhtr  # noqa: E402
from pos_evolution_tpu.ssz import incremental as jinc  # noqa: E402
from pos_evolution_tpu.ssz import merkle as jmerkle  # noqa: E402
from pos_evolution_tpu_torch import config as tc  # noqa: E402
from pos_evolution_tpu_torch import convert, spec_chain  # noqa: E402
from pos_evolution_tpu_torch.backend import get_backend, set_backend, use_backend  # noqa: E402
from pos_evolution_tpu_torch.ops import epoch as tep  # noqa: E402
from pos_evolution_tpu_torch.ops import merkle_device as tmd  # noqa: E402
from pos_evolution_tpu_torch.ops.aggregation import precompute_pk_states  # noqa: E402
from pos_evolution_tpu_torch.ops import transition as ttr  # noqa: E402
from pos_evolution_tpu_torch.specs import epoch as tsep  # noqa: E402
from pos_evolution_tpu_torch.specs import forkchoice as tfc  # noqa: E402
from pos_evolution_tpu_torch.specs import genesis as tgen  # noqa: E402
from pos_evolution_tpu_torch.specs import transition as tst  # noqa: E402
from pos_evolution_tpu_torch.specs import validator as tval  # noqa: E402
from pos_evolution_tpu_torch.ssz import hash as thash  # noqa: E402
from pos_evolution_tpu_torch.ssz import hash_tree_root as thtr  # noqa: E402
from pos_evolution_tpu_torch.ssz import incremental as tinc  # noqa: E402
from pos_evolution_tpu_torch.ssz import merkle as tmerkle  # noqa: E402

FAR = 2**64 - 1
COLS = ("effective_balance", "slashed", "activation_eligibility_epoch", "activation_epoch",
        "exit_epoch", "withdrawable_epoch")
STATE_COLS = ("balances", "previous_epoch_participation", "current_epoch_participation",
              "inactivity_scores")


@pytest.fixture(autouse=True)
def _minimal_cpu():
    """Both packages on the minimal config, the JAX package on its numpy
    backend, the port on its CPU backend, one intra-op thread, fresh B8
    sessions."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ttr.reset_session()
    jtr.reset_session()
    jax_set_backend("numpy")
    with jc.use_config(jc.minimal_config()), tc.use_config(tc.minimal_config()), \
            use_backend("torch", device="cpu"):
        yield
    torch.set_num_threads(n)
    jax_set_backend("numpy")


def _genesis_pair(n):
    js, ja = jgen.make_genesis(n)
    ts, ta = tgen.make_genesis(n)
    assert jhtr(js) == thtr(ts) and jhtr(ja) == thtr(ta)
    return js, ts


def _assert_states_equal(js, ts):
    for f in COLS + ("pubkeys", "withdrawal_credentials"):
        np.testing.assert_array_equal(getattr(ts.validators, f), getattr(js.validators, f),
                                      err_msg=f)
    for f in STATE_COLS:
        got, want = getattr(ts, f), getattr(js, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert thtr(ts) == jhtr(js)


# --- B8: the block sweep ---------------------------------------------------------------

def _randomize(states, rng, n):
    """The same random balances, effective balances and flags on each state."""
    bal = rng.integers(31 * 10**9, 33 * 10**9, n).astype(np.uint64)
    eff = (rng.integers(16, 33, n) * 10**9).astype(np.uint64)
    prev = rng.integers(0, 8, n).astype(np.uint8)
    cur = rng.integers(0, 8, n).astype(np.uint8)
    for s in states:
        s.balances = bal.copy()
        s.validators.effective_balance = eff.copy()
        s.previous_epoch_participation = prev.copy()
        s.current_epoch_participation = cur.copy()


def _rows(rng, n, count):
    """Attestation rows with overlapping attesters, both epochs, every
    flag subset (the empty one included) and rows of one attester."""
    rows = []
    for i in range(count):
        k = 1 if i == 0 else int(rng.integers(2, n // 2))
        attesting = np.sort(rng.choice(n, k, replace=False)).astype(np.int64)
        flags = [f for f in range(3) if rng.random() < 0.6]
        rows.append((attesting, flags, bool(rng.random() < 0.5)))
    rows.append((rows[1][0].copy(), [0, 1, 2], rows[1][2]))   # the same attesters again
    return rows


def _copies(s, k):
    return [s.copy() for _ in range(k)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_sweep_equals_jax_device_and_host(seed):
    n = 64
    rng = np.random.default_rng(seed)
    js, ts = _genesis_pair(n)
    js.slot = ts.slot = 9           # epoch 1: the previous epoch is a real one
    _randomize([js, ts], rng, n)
    rows = _rows(rng, n, 7)
    j_host, j_dev = _copies(js, 2)
    t_host, t_dev = _copies(ts, 2)
    sweeps = ttr.session_stats()["sweeps"]
    jtr.apply_attestation_rows_host(j_host, rows)
    jtr.apply_attestation_rows_device(j_dev, rows)
    ttr.apply_attestation_rows_host(t_host, rows)
    get_backend().block_sweep(t_dev, rows)
    for t_state in (t_host, t_dev):
        for j_state in (j_host, j_dev):
            for f in STATE_COLS[:3]:
                np.testing.assert_array_equal(getattr(t_state, f), getattr(j_state, f),
                                              err_msg=f)
    assert ttr.session_stats()["sweeps"] == sweeps + 1
    assert (t_dev.balances != ts.balances).any()


def test_block_sweep_session_reuses_patches_and_uploads():
    n = 64
    rng = np.random.default_rng(5)
    js, ts = _genesis_pair(n)
    js.slot = ts.slot = 9
    _randomize([js, ts], rng, n)
    before, jbefore = ttr.session_stats(), jtr.session_stats()
    steps = [None, "reuse", "patch", "upload"]
    for i, step in enumerate(steps):
        if step == "patch":        # a few rows move between blocks
            for s in (js, ts):
                s.balances = s.balances.copy()      # the JAX write-back is read-only
                s.balances[[3, 17]] += np.uint64(5)
                s.current_epoch_participation = s.current_epoch_participation.copy()
                s.current_epoch_participation[40] = 0
        elif step == "upload":     # more than 1/8 of the rows move
            for s in (js, ts):
                s.balances = s.balances.copy()
                s.balances[: n // 2] += np.uint64(7)
        rows = _rows(np.random.default_rng(100 + i), n, 4)
        jtr.apply_attestation_rows_device(js, rows)
        get_backend().block_sweep(ts, rows)
        for f in STATE_COLS[:3]:
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), err_msg=f"{step} {f}")
    after = ttr.session_stats()
    got = {k: after[k] - before[k] for k in ("uploads", "reuses", "patches")}
    assert got == {"uploads": 2, "reuses": 1, "patches": 1}
    jafter = jtr.session_stats()
    assert got == {k: jafter[k] - jbefore[k] for k in got}


def test_session_resets_on_a_device_change():
    n = 64
    js, ts = _genesis_pair(n)
    ts.slot = 9
    rows = _rows(np.random.default_rng(3), n, 2)
    ttr.apply_attestation_rows_device(ts, rows, "cpu")
    ttr._SESSION.device = torch.device("meta")      # as if another device held it
    before = ttr.session_stats()["uploads"]
    ttr.apply_attestation_rows_device(ts, rows, "cpu")
    assert ttr.session_stats()["uploads"] == before + 1


def test_prewarm_runs_the_sweep_once():
    _js, ts = _genesis_pair(64)
    assert ttr.prewarm_block_sweep(ts) == 1


# --- the registry churn and process_epoch ---------------------------------------------

def _churny(make_genesis, n, seed, at_limit):
    """Ejections, fresh deposits, a waiting queue, and an exit queue whose
    tail epoch holds one fewer than the churn limit or the limit itself."""
    c = tc.minimal_config()
    rng = np.random.default_rng(seed)
    state, _ = make_genesis(n)
    reg = state.validators
    reg.effective_balance[rng.random(n) < 0.15] = c.ejection_balance
    fresh = rng.random(n) < 0.1
    reg.activation_eligibility_epoch[fresh] = FAR
    reg.activation_epoch[fresh] = FAR
    queued = rng.random(n) < 0.2
    reg.activation_eligibility_epoch[queued] = rng.integers(1, 4, queued.sum())
    reg.activation_epoch[queued] = FAR
    limit = max(c.min_per_epoch_churn_limit, n // c.churn_limit_quotient)
    tail = rng.choice(np.nonzero(~queued & ~fresh)[0], limit if at_limit else limit - 1,
                      replace=False)
    reg.exit_epoch[tail] = 20
    reg.withdrawable_epoch[tail] = 20 + c.min_validator_withdrawability_delay
    earlier = rng.choice(np.setdiff1d(np.nonzero(~queued & ~fresh)[0], tail), 3, replace=False)
    reg.exit_epoch[earlier] = 16
    reg.withdrawable_epoch[earlier] = 16 + c.min_validator_withdrawability_delay
    state.slot = 10 * c.slots_per_epoch - 1
    state.finalized_checkpoint = type(state.finalized_checkpoint)(epoch=5, root=b"\x05" * 32)
    state.block_roots = rng.integers(0, 255, state.block_roots.shape).astype(np.uint8)
    state.previous_epoch_participation = rng.integers(0, 8, n).astype(np.uint8)
    return state


@pytest.mark.parametrize("at_limit", [False, True])
def test_registry_churn_dense_equals_jax(at_limit):
    c = tc.minimal_config()
    js = _churny(jgen.make_genesis, 96, 11, at_limit)
    ts = _churny(tgen.make_genesis, 96, 11, at_limit)
    want = jep.registry_churn_dense(jep.densify(js), jep.densify_eligibility(js), 9, 5,
                                    jc.minimal_config())
    got = tep.registry_churn_dense(tep.densify(ts), tep.densify_eligibility(ts), 9, 5, c)
    for f in tep.ChurnResult._fields:
        assert isinstance(getattr(got, f), np.ndarray)
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)
    ejected = (np.asarray(want.exit_epoch) != np.asarray(jep.densify(js).exit_epoch))
    assert ejected.sum() >= 2          # the closed form assigns more than one exit


@pytest.mark.parametrize("at_limit", [False, True])
def test_process_epoch_equals_jax_numpy_backend(at_limit):
    js = _churny(jgen.make_genesis, 96, 12, at_limit)
    ts = _churny(tgen.make_genesis, 96, 12, at_limit)
    jsep.process_epoch(js)
    tsep.process_epoch(ts)
    _assert_states_equal(js, ts)
    assert js.justification_bits.tolist() == ts.justification_bits.tolist()
    assert js.finalized_checkpoint.as_key() == ts.finalized_checkpoint.as_key()


def test_densify_and_pad_registry_equal_jax():
    js = _churny(jgen.make_genesis, 40, 3, False)
    ts = _churny(tgen.make_genesis, 40, 3, False)
    want = jep.pad_registry(jep.densify_np(js), 64)
    got = tep.pad_registry(tep.densify(ts), 64)
    for f in tep.DenseRegistry._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(tep.densify_np(ts), f),
                                      np.asarray(getattr(jep.densify_np(js), f)), err_msg=f)
    np.testing.assert_array_equal(tep.densify_eligibility(ts).numpy(),
                                  np.asarray(jep.densify_eligibility(js)))


# --- whole chains -----------------------------------------------------------------------

def _chain(gen, build_block, state_transition, attest, htr, n, slots):
    state, anchor = gen.make_genesis(n)
    genesis, anchor = state.copy(), anchor.copy()
    atts, roots, blocks = [], [], []
    for slot in range(1, slots + 1):
        sb = build_block(state, slot, attestations=atts)
        state_transition(state, sb, True)
        blocks.append(sb)
        atts = attest(state, slot, htr(sb.message))
        roots.append(htr(state))
    return state, roots, blocks, genesis, anchor


def test_four_epoch_chain_equals_jax_numpy_backend():
    slots = 4 * tc.minimal_config().slots_per_epoch
    js, jroots, _b, _g, _a = _chain(jgen, jval.build_block, jst.state_transition,
                                    jval.attest_all_committees, jhtr, 64, slots)
    ts, troots, _b, _g, _a = _chain(tgen, tval.build_block, tst.state_transition,
                                    tval.attest_all_committees, thtr, 64, slots)
    assert troots == jroots                         # every slot's state root
    assert int(ts.finalized_checkpoint.epoch) >= 2
    assert ts.finalized_checkpoint.as_key() == js.finalized_checkpoint.as_key()
    _assert_states_equal(js, ts)


def test_replay_of_carried_blocks_equals_jax():
    """A JAX chain's genesis and blocks carried across (``spec_to_port``,
    SSZ bytes) replay through the port's ``on_block_batch`` to the JAX
    chain's state, as they do through the JAX package's."""
    c = tc.minimal_config()
    slots = 2 * c.slots_per_epoch + 1
    js, _roots, blocks, genesis, anchor = _chain(
        jgen, jval.build_block, jst.state_transition, jval.attest_all_committees, jhtr, 64, slots)
    t_genesis, t_anchor = convert.spec_to_port(genesis), convert.spec_to_port(anchor)
    t_blocks = [convert.spec_to_port(b) for b in blocks]
    assert [thtr(b) for b in t_blocks] == [jhtr(b) for b in blocks]
    assert thtr(t_genesis) == jhtr(genesis)
    last_time = c.seconds_per_slot * slots

    jstore = jfc.get_forkchoice_store(genesis.copy(), anchor)
    jfc.on_tick(jstore, last_time)
    jfc.on_block_batch(jstore, blocks)
    tstore = tfc.get_forkchoice_store(t_genesis, t_anchor)
    tfc.on_tick(tstore, last_time)
    before = ttr.session_stats()
    tfc.on_block_batch(tstore, t_blocks)
    assert ttr.session_stats()["sweeps"] - before["sweeps"] == slots - 1
    last = jhtr(blocks[-1].message)
    assert thtr(tstore.block_states[last]) == jhtr(jstore.block_states[last]) == jhtr(js)
    assert sorted(tstore.blocks) == sorted(jstore.blocks)
    assert tstore.finalized_checkpoint.as_key() == jstore.finalized_checkpoint.as_key()
    assert tstore.justified_checkpoint.as_key() == jstore.justified_checkpoint.as_key()
    _assert_states_equal(js, tstore.block_states[last])


def test_spec_chain_replay_from_a_kept_state():
    """``replay(start=k)`` anchors a fresh store at block ``k`` and the state
    ``run_chain(keep=(k,))`` kept after it, and replays the blocks after it
    across the epoch boundary to the chain's final state root."""
    c = tc.minimal_config()
    k = c.slots_per_epoch - 2
    run = spec_chain.run_chain(64, c.slots_per_epoch + 2, device="cpu", cfg=c, keep=(k,))
    assert list(run.kept) == [k] and thtr(run.kept[k]) == run.roots[k - 1]
    rep = spec_chain.replay(run, device="cpu", cfg=c, start=k)
    assert rep["blocks"] == 4 and rep["final_root"] == run.summary["final_root"]
    assert rep["b8"]["sweeps"] == 4, "every block after the anchor carries attestations"
    assert thtr(run.kept[k]) == run.roots[k - 1], "the kept state is left as it was"


def test_spec_chain_run_and_replay_agree():
    """``spec_chain``'s chain (its own attestations) and its replay reach one
    root, equal to the chain of ``attest_all_committees`` blocks."""
    c = tc.minimal_config()
    run = spec_chain.run_chain(64, c.slots_per_epoch + 1, device="cpu", cfg=c)
    assert run.pre_epoch is not None and run.summary["state_roots"] > 0
    rep = spec_chain.replay(run, device="cpu", cfg=c)
    assert rep["final_root"] == run.summary["final_root"] == thtr(run.state).hex()
    post, ms = spec_chain.boundary(run.pre_epoch, device="cpu", cfg=c)
    assert ms > 0 and int(post.slot) == c.slots_per_epoch - 1
    assert int(post.current_epoch_participation.sum()) == 0     # the flags rotated
    state, anchor = tgen.make_genesis(64)
    pk = precompute_pk_states(state.validators.pubkeys, "cpu")
    head = thtr(anchor)
    for slot in range(1, 4):
        mine = []
        if slot > 1:
            theirs = tval.attest_all_committees(state, slot - 1, head)
            mine = spec_chain.committee_attestations(state, slot - 1, head, pk)
            assert [thtr(a) for a in mine] == [thtr(a) for a in theirs]
        sb = tval.build_block(state, slot, attestations=mine)
        tst.state_transition(state, sb, True)
        head = thtr(sb.message)


# --- host rows: the merkle route and the copies' helpers --------------------------------

@pytest.mark.parametrize("count,limit", [(0, 4), (1, None), (5, 8), (4096, None), (9000, 2**14)])
def test_numpy_merkleize_chunks_equals_jax(count, limit):
    rows = np.random.default_rng(count).integers(0, 256, (count, 32)).astype(np.uint8)
    assert tmerkle.merkleize_chunks(rows, limit) == jmerkle.merkleize_chunks(rows, limit)
    assert tmerkle.merkleize(rows, limit) == jmerkle.merkleize(rows, limit)
    if count and count < 64:
        want = jmerkle.merkle_tree_branch(rows, count - 1, 7)
        assert tmerkle.merkle_tree_branch(rows, count - 1, 7) == want
    left, right = rows[0::2], rows[1::2][: rows[0::2].shape[0]]
    if left.shape == right.shape:
        np.testing.assert_array_equal(thash.sha256_pairs(left, right),
                                      jmerkle.sha256_pairs(left, right))


def test_pack_uint_chunks_numpy_equals_jax():
    for byte_len, dtype in ((8, np.uint64), (1, np.uint8)):
        for n in (0, 1, 5, 33):
            vals = np.random.default_rng(n).integers(0, 255, n).astype(dtype)
            np.testing.assert_array_equal(tinc._pack_uint_chunks(vals, byte_len),
                                          jinc._pack_uint_chunks(vals, byte_len))


def test_device_eligible_reads_the_backends_device_and_size():
    """The route of host rows: CUDA device and the crossover (``"auto"``),
    or forced; a CPU backend keeps every sweep on the host."""
    floor = tc.minimal_config().merkle_device_min_pairs
    assert not tmd.device_eligible(floor)           # the CPU backend
    card = types.SimpleNamespace(device=torch.device("cuda"))
    with use_backend(card):
        assert tmd.device_eligible(floor) and not tmd.device_eligible(floor - 1)
        assert not tmd.device_eligible(0)
        prev = tmd.set_mode("device")
        try:
            assert tmd.device_eligible(1)
            tmd.set_mode("host")
            assert not tmd.device_eligible(floor * 4)
        finally:
            tmd.set_mode(prev)
    assert tmd.small_batch_floor(16) == floor // 16
    with pytest.raises(ValueError):
        tmd.set_mode("sometimes")


def test_state_root_disabled_merkleizes_from_scratch():
    _js, ts = _genesis_pair(64)
    want = thtr(ts)
    prev = tinc.set_enabled(False)
    try:
        assert thtr(ts) == want
    finally:
        tinc.set_enabled(prev)
    assert tinc.state_root(ts) == want


def test_default_backend_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default backend is valid here")
    caught = []

    def fresh_thread():            # a thread with no backend set yet
        for call in (get_backend, lambda: tinc.state_root(ts),
                     lambda: set_backend("torch")):
            try:
                call()
            except RuntimeError as e:
                caught.append(str(e))

    _js, ts = _genesis_pair(64)
    t = threading.Thread(target=fresh_thread)
    t.start()
    t.join()
    assert len(caught) == 3 and all("CUDA" in m for m in caught)
    with pytest.raises(ValueError):
        set_backend("numpy")
