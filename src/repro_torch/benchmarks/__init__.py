"""Scripts of the paper's tables on the port (counterparts of the repo's
`benchmarks/table*.py`): Table I accuracy, Table II negative transfer,
Table III scalability and Table IV cost. Each runs as `python -m
repro_torch.benchmarks.<script>` on the card (`--device cpu` for the
CPU) and writes under `results/torch/`."""
