"""The port's second slice -- ``run_state_roots``: the five registry-scale
field roots before and after one epoch -- against the same composition in
the JAX package: its epoch sweep, then its ``RegistryTree``/``ChunkTree``
and the ``_RegistrySedes``/``_U64ListSedes`` ``htr`` oracles on its
post-state. All 10 roots equal, byte for byte."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pos_evolution_tpu import config as jcfg  # noqa: E402
from pos_evolution_tpu.ops import epoch as jep  # noqa: E402
from pos_evolution_tpu.specs.containers import (  # noqa: E402
    ValidatorRegistry,
    _RegistrySedes,
    _U64ListSedes,
)
from pos_evolution_tpu.ssz import incremental as jinc  # noqa: E402
from pos_evolution_tpu.ssz.merkle import mix_in_length  # noqa: E402
from pos_evolution_tpu_torch.epoch import build_epoch_inputs  # noqa: E402
from pos_evolution_tpu_torch.ops import kernels  # noqa: E402
from pos_evolution_tpu_torch.ops import merkle_device as md  # noqa: E402
from pos_evolution_tpu_torch.ssz import incremental as inc  # noqa: E402
from pos_evolution_tpu_torch.state_roots import (  # noqa: E402
    FIELDS,
    RegistryScaleTrees,
    load_columns,
    registry_state,
    run_state_roots,
    validator_columns,
)

LIMIT = 2**40
SMALL = dict(slots=4, committees_per_slot=4, capacity=16, shuffle_rounds=10)


def _jax_fields(reg, cols):
    """A dense registry's numpy columns and the static columns as the JAX
    package's five field values."""
    vr = ValidatorRegistry(reg.balance.shape[0])
    vr.pubkeys[:] = cols.pubkeys
    vr.withdrawal_credentials[:] = cols.withdrawal_credentials
    vr.effective_balance[:] = np.asarray(reg.effective_balance).astype(np.uint64)
    vr.slashed[:] = np.asarray(reg.slashed)
    vr.activation_eligibility_epoch[:] = cols.activation_eligibility_epoch.astype(np.uint64)
    for f in ("activation_epoch", "exit_epoch", "withdrawable_epoch"):
        getattr(vr, f)[:] = jep.i64_to_epochs(getattr(reg, f))
    return {"validators": vr,
            "balances": np.asarray(reg.balance).astype(np.uint64),
            "previous_epoch_participation": np.asarray(reg.prev_flags).astype(np.uint8),
            "current_epoch_participation": np.asarray(reg.cur_flags).astype(np.uint8),
            "inactivity_scores": np.asarray(reg.inactivity_scores).astype(np.uint64)}


class _JaxTrees:
    """The JAX package's incremental trees for the five fields."""

    def __init__(self):
        self.reg = jinc.RegistryTree()
        self.lists = {f: jinc.ChunkTree(LIMIT // (32 // (1 if "participation" in f else 8)))
                      for f in FIELDS[1:]}

    def roots(self, fields):
        out = {"validators": self.reg.root(fields["validators"], LIMIT)}
        for f, tree in self.lists.items():
            byte_len = fields[f].dtype.itemsize
            out[f] = mix_in_length(tree.root(jinc._pack_uint_chunks(fields[f], byte_len)),
                                   fields[f].shape[0])
        return out


def _sedes_roots(fields):
    out = {"validators": _RegistrySedes().htr(fields["validators"])}
    for f in FIELDS[1:]:
        out[f] = _U64ListSedes(fields[f].dtype.type, LIMIT).htr(fields[f])
    return out


def test_state_roots_match_jax():
    inp = build_epoch_inputs(4096, seed=5, **SMALL)
    before = dict(kernels.launches)
    res = run_state_roots(inp, "cpu")
    assert kernels.launches == before        # the CPU takes the plain versions

    cols = validator_columns(inp)
    cur, fin, jbits, pj, cj, sl = inp.sweep_args
    post_reg = jep.process_epoch_dense(
        jep.DenseRegistry(*(jnp.asarray(x) for x in inp.registry)),
        cur, fin, jnp.asarray(jbits), pj, cj, sl, jcfg.mainnet_config()).registry
    post_reg = jep.DenseRegistry(*(np.asarray(x) for x in post_reg))
    pre_fields, post_fields = _jax_fields(inp.registry, cols), _jax_fields(post_reg, cols)

    trees = _JaxTrees()
    want_pre, want_post = trees.roots(pre_fields), trees.roots(post_fields)
    assert want_pre == _sedes_roots(pre_fields)
    assert want_post == _sedes_roots(post_fields)
    assert want_pre != want_post
    assert res.pre == want_pre
    assert res.post == want_post

    eff_changed = int((post_reg.effective_balance != inp.registry.effective_balance).sum())
    assert 0 < res.dirty["validators"] == eff_changed
    assert res.dirty["balances"] == 1024               # every balance chunk changed
    assert res.dirty["inactivity_scores"] == 0         # every score stays 0


def test_fresh_build_equals_incremental_update():
    """The post-epoch roots from new trees equal the incremental ones, and
    the plain-level reference gives the same roots."""
    inp = build_epoch_inputs(2048, seed=9, **SMALL)
    res = run_state_roots(inp, "cpu")
    cols = load_columns(inp, "cpu")
    assert RegistryScaleTrees(inp.cfg).roots(registry_state(res.epoch.result.registry,
                                                            cols)) == res.post
    ref = run_state_roots(inp, "cpu", plain=True)
    assert (ref.pre, ref.post, ref.dirty) == (res.pre, res.post, res.dirty)


def test_launch_accounting_per_root_computation():
    """Each root computation is the validator-root pass's 4 sweeps plus one
    sweeper round per level of the deepest dirty tree (the registry's)."""
    n = 2048
    inp = build_epoch_inputs(n, seed=4, **SMALL)
    md.reset_stats()
    inc.reset_stats()
    run_state_roots(inp, "cpu")
    s, i = md.stats(), inc.stats()
    levels = (n - 1).bit_length()
    assert i["validator_root_passes"] == 2
    assert s["batched_launches"] == 2 * levels
    assert s["sweeps"] == 4 * i["validator_root_passes"] + s["batched_launches"]


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from pos_evolution_tpu_torch import convert
    inp = build_epoch_inputs(1024, seed=8, **SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_state_roots(inp)
    with pytest.raises(RuntimeError, match="CUDA"):
        md.digest_bytes(b"payload")
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.chunks_to_torch(np.zeros((2, 32), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.validator_registry_to_torch(ValidatorRegistry(3))
