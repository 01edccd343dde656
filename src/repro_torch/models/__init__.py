"""Models of the port: the FedPAE bench's image classifiers (`cnn.py`)
and the LLM model zoo's dense, MoE, cross-attention VLM and multi-codebook
audio transformers, RWKV6 and Zamba2-style hybrids (`common.py`,
`attention.py`, `moe.py`, `ssm.py`, `rwkv.py`, `transformer.py`)."""
