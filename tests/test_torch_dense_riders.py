"""The port's dense driver with both workload riders (the DAS sidecar plane
and a light-client population) against the JAX package's, on the CPU:
rider stats, ``summary()["workload"]``, the light clients' heads and the
state digest, under Gasper and Goldfish; a JAX checkpoint with riders
resumed in the port and run on; the rider configs' round trips."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu.config import mainnet_config as jax_mainnet  # noqa: E402
from pos_evolution_tpu.config import use_config  # noqa: E402
from pos_evolution_tpu.das.dense_rider import DenseDasRider as JaxDasRider  # noqa: E402
from pos_evolution_tpu.lightclient.population import (  # noqa: E402
    DenseLightClientPopulation as JaxLightClients,
)
from pos_evolution_tpu.resilience import state_digest as jax_digest  # noqa: E402
from pos_evolution_tpu.sim import dense_variants as jvar  # noqa: E402
from pos_evolution_tpu.sim.dense_driver import DenseSimulation as JaxSim  # noqa: E402
from pos_evolution_tpu_torch.config import mainnet_config  # noqa: E402
from pos_evolution_tpu_torch.das.dense_rider import DenseDasRider  # noqa: E402
from pos_evolution_tpu_torch.lightclient.population import DenseLightClientPopulation  # noqa: E402
from pos_evolution_tpu_torch.resilience import state_digest  # noqa: E402
from pos_evolution_tpu_torch.sim import dense_variants as tvar  # noqa: E402
from pos_evolution_tpu_torch.sim.dense_driver import DenseSimulation  # noqa: E402

N = 512
SMALL = dict(slots_per_epoch=8, max_committees_per_slot=4, das_cells_per_blob=8,
             das_cell_bytes=64, das_max_blobs_per_block=2)
RIDERS = ({"kind": "das", "scheme": "merkle", "n_blobs": 2, "n_clients": 16,
           "samples_per_client": 12, "seed": 3, "verify_every": 1},
          {"kind": "lightclient", "n_clients": 48, "seed": 4})
KW = dict(seed=11, shuffle_rounds=6, verify_aggregates=False, check_walk_every=4)
JCFG = jax_mainnet().replace(**SMALL)


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain SHA-256 is thousands of small tensor ops: one intra-op
    thread keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_sim(variant):
    riders = [jvar.dense_rider_from_config(dict(d)) for d in RIDERS]
    return JaxSim(N, cfg=JCFG, variant=variant, riders=riders, **KW)


def _port_sim(variant):
    riders = [tvar.dense_rider_from_config(dict(d)) for d in RIDERS]
    return DenseSimulation(N, mainnet_config().replace(**SMALL), device="cpu",
                           variant=variant, riders=riders, **KW)


def _record(sim, pkg):
    summary = sim.summary()
    summary.pop("mesh", None)
    das, lc = sim.riders
    return {"summary": summary, "metrics": sim.metrics,
            "das": (das.stats(), das.state_meta()),
            "lightclient": (lc.stats(), lc.state_meta(), lc.head_slot.tolist(),
                            lc.head_idx.tolist(), lc.lag.tolist()),
            "digest": jax_digest(sim) if pkg == "jax" else state_digest(sim)}


@pytest.fixture(scope="module", params=[("gasper", 4), ("goldfish", 2)],
                ids=["gasper", "goldfish"])
def rider_runs(request):
    variant, epochs = request.param
    with use_config(JCFG):
        jsim = _jax_sim(variant)
        jsim.run_epochs(epochs)
        jrec = _record(jsim, "jax")
    tsim = _port_sim(variant)
    tsim.run_epochs(epochs)
    return jrec, _record(tsim, "port")


@pytest.mark.parametrize("key", ["summary", "metrics", "das", "lightclient", "digest"])
def test_rider_run_equals_jax(rider_runs, key):
    jrec, trec = rider_runs
    assert trec[key] == jrec[key]


def test_riders_did_their_work(rider_runs):
    _, rec = rider_runs
    das, lc = rec["summary"]["workload"]["das"], rec["summary"]["workload"]["lightclient"]
    slots = rec["summary"]["slots"]
    assert das["sidecars_built"] == das["sidecars_verified"] == 2 * slots
    assert das["sidecar_failures"] == 0 and das["sample_misses"] == 0
    assert das["samples_drawn"] == 16 * 12 * slots
    assert lc["clients_synced"] == 48 and lc["updates_applied"] > 0


def test_jax_checkpoint_with_riders_resumes_in_port():
    """A JAX run with both riders, checkpointed after 5 slots, resumes in
    the port; both then run 4 more slots and agree."""
    with use_config(JCFG):
        jsim = _jax_sim("goldfish")
        for _ in range(5):
            jsim.run_slot()
        data = jsim.checkpoint()
        for _ in range(4):
            jsim.run_slot()
        want = _record(jsim, "jax")
    tsim = DenseSimulation.resume(data, device="cpu")
    assert [r.describe() for r in tsim.riders] == [dict(d) for d in RIDERS]
    for _ in range(4):
        tsim.run_slot()
    got = _record(tsim, "port")
    for key in want:
        assert got[key] == want[key], key
    back = DenseSimulation.resume(tsim.checkpoint(), device="cpu")
    assert [r.state_meta() for r in back.riders] == [r.state_meta() for r in tsim.riders]
    np.testing.assert_array_equal(back.riders[1].head_idx, tsim.riders[1].head_idx)


def test_rider_configs_round_trip_as_jax():
    for d in RIDERS + ({"kind": "das"}, {"kind": "lightclient"}):
        want = jvar.dense_rider_from_config(dict(d))
        got = tvar.dense_rider_from_config(dict(d))
        assert got.kind == want.kind and got.describe() == want.describe()
        assert tvar.dense_rider_from_config(got.describe()).describe() == got.describe()
    rider = DenseDasRider(n_blobs=3)
    assert tvar.dense_rider_from_config(rider) is rider
    assert tvar.dense_rider_from_config(None) is None
    assert DenseLightClientPopulation.from_config({}).describe() == \
        JaxLightClients.from_config({}).describe()
    assert DenseDasRider.from_config({}).describe() == JaxDasRider.from_config({}).describe()
    with pytest.raises(ValueError, match="unknown dense rider kind"):
        tvar.dense_rider_from_config({"kind": "nope"})
