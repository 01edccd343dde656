"""Drivers of the port, one for each of the repo's `examples/*.py`:
`lossy_links`, `quickstart`, `async_decentralized`, `gossip_churn`,
`pareto_front`, `beyond_paper`, `byzantine_peers` and `serve_drift` (the
FedPAE system), `serve_ensemble` and `train_llm` (the LLM model zoo).
Each runs as `python -m repro_torch.examples.<script>` on the card
(`--device cpu` for the CPU)."""
