"""Online serving: query traffic, drift injection, accuracy-monitored
re-selection (DESIGN.md §14; port of `repro/serve`).

Spec-driven like every other subsystem: `ExperimentSpec.serve` names a
traffic component (registry kind "traffic": poisson, bursty) and drift
components (kind "drift": label_shift, covariate_shift). The event
scheduler interleaves the generated "query"/"drift" events with
train/gossip/repair and consults the `ServingEngine`, which answers each
micro-batch from the client's currently-selected ensemble, monitors
sliding-window serving accuracy, and requests debounced re-selection on
a threshold breach. The compiled backend rejects serve specs loudly
(`ServingEngine.array_params`).
"""
from repro_torch.serve.drift import (CovariateShiftConfig, CovariateShiftDrift,
                               LabelShiftConfig, LabelShiftDrift)
from repro_torch.serve.engine import ServeConfig, ServeStats, ServingEngine
from repro_torch.serve.traffic import (BurstyTraffic, BurstyTrafficConfig,
                                 PoissonTraffic, PoissonTrafficConfig)

__all__ = [
    "BurstyTraffic", "BurstyTrafficConfig", "CovariateShiftConfig",
    "CovariateShiftDrift", "LabelShiftConfig", "LabelShiftDrift",
    "PoissonTraffic", "PoissonTrafficConfig", "ServeConfig", "ServeStats",
    "ServingEngine",
]
