"""FedPAE in PyTorch for NVIDIA Hopper: the port of `repro` (JAX/TPU).

The package mirrors `repro` file for file (`repro_torch/core/nsga2.py`
answers to `repro/core/nsga2.py`) and imports neither JAX nor `repro`.
Entry points run on the CUDA device unless the caller passes
`device="cpu"`; the one hand-written kernel on the synchronous path,
`kernels/ensemble_fitness`, is CUDA C++ built with nvcc at first use.

    from repro_torch.sim import Experiment, ExperimentSpec
    result = Experiment.from_spec(spec, device="cuda").run()
"""
