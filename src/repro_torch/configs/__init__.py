"""Architecture registry of the port, mirroring `repro/configs`: one module
per architecture, `get_config(name)` for the full-scale config and
`get_smoke(name)` for the reduced same-family variant of the CPU tests.

Every architecture of the reference's list is ported: the dense
(llama3-8b, qwen2.5-3b, gemma2-27b, command-r-plus-104b), moe
(qwen3-moe-235b-a22b, arctic-480b), ssm (rwkv6-3b), hybrid (zamba2-7b),
vlm (llama-3.2-vision-11b) and audio (musicgen-medium) families, and
"paper-cnn" (the paper's FedPAE scale, `paper_cnn.py`).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "zamba2-7b",
    "rwkv6-3b",
    "qwen2.5-3b",
    "llama-3.2-vision-11b",
    "arctic-480b",
    "command-r-plus-104b",
    "gemma2-27b",
    "musicgen-medium",
    "qwen3-moe-235b-a22b",
    "llama3-8b",
    "paper-cnn",  # the paper's own experimental scale (FedPAE on CNN bench)
]


def _mod(name: str):
    if name not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}; choose from "
                         f"{ARCHS}")
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get_config(name: str):
    return _mod(name).config()


def get_smoke(name: str):
    return _mod(name).smoke()


def list_archs(include_paper: bool = False):
    return [a for a in ARCHS if include_paper or a != "paper-cnn"]
