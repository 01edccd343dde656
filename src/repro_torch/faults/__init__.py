"""Deterministic fault injection + validation-gated admission
(DESIGN.md §12; port of `repro/faults`, numpy on the host as there).

Spec-driven like every other subsystem: `ExperimentSpec.faults` names
injector components (registry kind "fault": byzantine, corruption,
crash_restart, partition) and an optional admission gate (kind
"admission": validation_gate). The event scheduler consults the
aggregated `FaultController`; the `AdmissionController` screens remote
payloads in the gossip -> store path. The compiled backend rejects fault
specs loudly (`FaultController.array_params`).
"""
from repro_torch.faults.admission import (AdmissionConfig, AdmissionController,
                                    AdmissionStats, ValidationGate)
from repro_torch.faults.controller import FaultController, FaultStats
from repro_torch.faults.injectors import (ByzantineConfig, ByzantineFault,
                                    CorruptionConfig, CorruptionFault,
                                    CrashRestartConfig, CrashRestartFault,
                                    PartitionConfig, PartitionFault)

__all__ = [
    "AdmissionConfig", "AdmissionController", "AdmissionStats",
    "ByzantineConfig", "ByzantineFault", "CorruptionConfig",
    "CorruptionFault", "CrashRestartConfig", "CrashRestartFault",
    "FaultController", "FaultStats", "PartitionConfig", "PartitionFault",
    "ValidationGate",
]
