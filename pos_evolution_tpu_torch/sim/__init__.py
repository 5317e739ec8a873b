"""Network & adversary simulation layer: the spec driver (``driver``) with
its schedules, fault plans, adversaries and monitors, and the dense
driver (``dense_driver``)."""

from pos_evolution_tpu_torch.sim.adversary import (
    AdversaryContext,
    AdversaryStrategy,
    Balancer,
    Equivocator,
    RandomByzantine,
    SplitVoter,
    Withholder,
)
from pos_evolution_tpu_torch.sim.driver import Simulation, ViewGroup
from pos_evolution_tpu_torch.sim.faults import (
    CrashWindow,
    DenseCrashWindow,
    DenseFaultPlan,
    FaultPlan,
    chaos_plan,
    lossy_plan,
    stateless_unit,
    stateless_unit_array,
)
from pos_evolution_tpu_torch.sim.monitors import (
    AccountableSafetyMonitor,
    FinalityLivenessMonitor,
    ForkChoiceParityMonitor,
    Monitor,
    VariantSafetyMonitor,
    default_monitors,
)
from pos_evolution_tpu_torch.sim.schedule import (
    Schedule,
    faulty_schedule,
    honest_schedule,
    partition_schedule,
)
