"""Declarative experiment layer of the port: `ExperimentSpec` (the same
serializable spec as `repro.sim`) and `Experiment`, which builds and
runs it (synchronous, and asynchronous on the event backend).

    from repro_torch.sim import Experiment, ExperimentSpec

    spec = ExperimentSpec.from_json(open("exp.json").read())
    result = Experiment.from_spec(spec).run()

Components (transports, gossip protocols, churn models, repair loops,
train-cost models, message sizers, sinks) are tagged configs resolved by
name through `repro_torch.sim.registry`; importing this package
registers the stock set (`repro_torch.sim.build`).
"""
from repro_torch.sim import build as _build  # noqa: F401  (registers)
from repro_torch.sim.compat import fedpae_config, spec_from_fedpae
from repro_torch.sim.experiment import Experiment, RunResult
from repro_torch.sim.registry import known, register, resolve
from repro_torch.sim.spec import (ComponentSpec, DataSpec, ExperimentSpec,
                                  FaultSpec, NetworkSpec, ObsSpec,
                                  ScheduleSpec, SelectionSpec, ServeSpec,
                                  TrainSpec)

__all__ = [
    "ComponentSpec", "DataSpec", "Experiment", "ExperimentSpec",
    "FaultSpec", "NetworkSpec", "ObsSpec", "RunResult", "ScheduleSpec",
    "SelectionSpec", "ServeSpec", "TrainSpec", "fedpae_config", "known",
    "register", "resolve", "spec_from_fedpae",
]
