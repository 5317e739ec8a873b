"""The port's dense driver with a KZG DAS rider against the JAX package's on
the CPU, as ``tests/test_dense_variants.py``'s rider test runs it: n = 512
under SSF and RLMD (the variants the JAX dense matrix pairs with the kzg
scheme), stats, summary, metrics and state digest equal; a checkpoint with
the rider written by either package resumes in the other."""

import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu.config import mainnet_config as jax_mainnet  # noqa: E402
from pos_evolution_tpu.config import use_config  # noqa: E402
from pos_evolution_tpu.resilience import state_digest as jax_digest  # noqa: E402
from pos_evolution_tpu.sim import dense_variants as jvar  # noqa: E402
from pos_evolution_tpu.sim.dense_driver import DenseSimulation as JaxSim  # noqa: E402
from pos_evolution_tpu_torch.config import mainnet_config  # noqa: E402
from pos_evolution_tpu_torch.resilience import state_digest  # noqa: E402
from pos_evolution_tpu_torch.sim import dense_variants as tvar  # noqa: E402
from pos_evolution_tpu_torch.sim.dense_driver import DenseSimulation  # noqa: E402

N = 512
SLOTS = 4
GEOM = dict(slots_per_epoch=8, max_committees_per_slot=4, das_cells_per_blob=8,
            das_cell_bytes=64, das_max_blobs_per_block=2)
RIDER = {"kind": "das", "scheme": "kzg", "n_blobs": 2, "n_clients": 8,
         "samples_per_client": 2, "seed": 3, "verify_every": 1}
KW = dict(seed=11, shuffle_rounds=6, verify_aggregates=False, check_walk_every=4)
JCFG = jax_mainnet().replace(**GEOM)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """A plain field op is hundreds of small tensor ops: one intra-op thread
    keeps parallel test workers from oversubscribing the cores. Module
    scope, so that it also wraps the module's fixtures, which run first."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_sim(variant):
    return JaxSim(N, cfg=JCFG, variant=variant,
                  riders=[jvar.dense_rider_from_config(dict(RIDER))], **KW)


def _port_sim(variant):
    return DenseSimulation(N, mainnet_config().replace(**GEOM), device="cpu", variant=variant,
                           riders=[tvar.dense_rider_from_config(dict(RIDER))], **KW)


def _record(sim, pkg):
    summary = sim.summary()
    summary.pop("mesh", None)
    das = sim.riders[0]
    return {"summary": summary, "metrics": sim.metrics,
            "das": (das.stats(), das.state_meta(), das.describe()),
            "digest": jax_digest(sim) if pkg == "jax" else state_digest(sim)}


def _run(sim, slots):
    for _ in range(slots):
        sim.run_slot()
    return sim


@pytest.fixture(scope="module", params=["ssf", "rlmd"])
def kzg_runs(request):
    with use_config(JCFG):
        jrec = _record(_run(_jax_sim(request.param), SLOTS), "jax")
    return jrec, _record(_run(_port_sim(request.param), SLOTS), "port")


@pytest.mark.parametrize("key", ["summary", "metrics", "das", "digest"])
def test_kzg_rider_run_equals_jax(kzg_runs, key):
    jrec, trec = kzg_runs
    assert trec[key] == jrec[key]


def test_kzg_rider_did_its_work(kzg_runs):
    _, rec = kzg_runs
    das = rec["summary"]["workload"]["das"]
    assert das["scheme"] == "kzg"
    assert das["sidecars_built"] == das["sidecars_verified"] >= 2 * SLOTS
    assert das["sidecar_failures"] == 0 and das["sample_misses"] == 0
    assert das["samples_drawn"] > 0


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_kzg_rider_checkpoint_resumes_across_packages(writer, reader):
    """SSF with the kzg rider, checkpointed after 2 slots by one package,
    resumed in the other and run 2 more: equal to the JAX package's
    uninterrupted run."""
    with use_config(JCFG):
        ref = _record(_run(_jax_sim("ssf"), 4), "jax")
        if writer == "jax":
            data = _run(_jax_sim("ssf"), 2).checkpoint()
    if writer == "port":
        data = _run(_port_sim("ssf"), 2).checkpoint()
    if reader == "jax":
        with use_config(JCFG):
            got = _record(_run(JaxSim.resume(data), 2), "jax")
    else:
        resumed = DenseSimulation.resume(data, device="cpu")
        assert [r.describe() for r in resumed.riders] == [dict(RIDER)]
        got = _record(_run(resumed, 2), "port")
    for key in ref:
        assert got[key] == ref[key], key
