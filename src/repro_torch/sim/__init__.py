"""Declarative experiment layer of the port: `ExperimentSpec` (the same
serializable spec as `repro.sim`) and `Experiment`, which runs its
synchronous image path.

    from repro_torch.sim import Experiment, ExperimentSpec

    spec = ExperimentSpec.from_json(open("exp.json").read())
    result = Experiment.from_spec(spec).run()
"""
from repro_torch.sim.compat import fedpae_config
from repro_torch.sim.experiment import Experiment, RunResult
from repro_torch.sim.spec import (ComponentSpec, DataSpec, ExperimentSpec,
                                  FaultSpec, NetworkSpec, ObsSpec,
                                  ScheduleSpec, SelectionSpec, ServeSpec,
                                  TrainSpec)

__all__ = [
    "ComponentSpec", "DataSpec", "Experiment", "ExperimentSpec",
    "FaultSpec", "NetworkSpec", "ObsSpec", "RunResult", "ScheduleSpec",
    "SelectionSpec", "ServeSpec", "TrainSpec", "fedpae_config",
]
