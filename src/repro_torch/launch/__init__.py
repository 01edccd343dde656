"""Entry points of the LLM model zoo: `serve.py` (batched prefill +
decode, single model or FedPAE soft-vote ensemble)."""
