"""Models of the port: the FedPAE bench's image classifiers (`cnn.py`)
and the dense transformers of the LLM model zoo (`common.py`,
`attention.py`, `transformer.py`)."""
