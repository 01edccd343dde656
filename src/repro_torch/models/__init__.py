"""Models of the port: the FedPAE bench's image classifiers (`cnn.py`)
and the LLM model zoo's dense transformers, RWKV6 and Zamba2-style
hybrids (`common.py`, `attention.py`, `ssm.py`, `rwkv.py`,
`transformer.py`)."""
