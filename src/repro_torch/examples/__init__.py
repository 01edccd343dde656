"""Drivers of the LLM model zoo on the port (counterparts of the repo's
`examples/serve_ensemble.py` and `examples/train_llm.py`). Each runs as
`python -m repro_torch.examples.<script>` on the card (`--device cpu`
for the CPU)."""
