"""FedPAE in PyTorch for NVIDIA Hopper: the port of `repro` (JAX/TPU).

The package mirrors `repro` file for file (`repro_torch/core/nsga2.py`
answers to `repro/core/nsga2.py`) and imports neither JAX nor `repro`.
Entry points run on the CUDA device unless the caller passes
`device="cpu"`. The hand-written kernels are CUDA C++ built with nvcc at
first use: `kernels/ensemble_fitness` on every selection (the
synchronous round and each debounced re-selection of the asynchronous
event loop, `fl/scheduler.py` over the `p2p` stack), and the attention
and scan kernels on the LLM paths.

    from repro_torch.sim import Experiment, ExperimentSpec
    result = Experiment.from_spec(spec, device="cuda").run()

    from repro_torch.launch.serve import serve_batch
    tokens = serve_batch(cfg, members, prompts, gen_len=16)
"""
