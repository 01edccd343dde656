"""Architecture registry of the port, mirroring `repro/configs`: one module
per architecture, `get_config(name)` for the full-scale config and
`get_smoke(name)` for the reduced same-family variant of the CPU tests.

The dense (llama3-8b, qwen2.5-3b, gemma2-27b), ssm (rwkv6-3b) and hybrid
(zamba2-7b) families are ported, and so is "paper-cnn" (the paper's
FedPAE scale, `paper_cnn.py`). Every other architecture of the
reference's list raises NotImplementedError (ROADMAP.md queue 1).
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
PORTED = ("llama3-8b", "qwen2.5-3b", "gemma2-27b", "rwkv6-3b", "zamba2-7b",
          "paper-cnn")


def _mod(name: str):
    if name not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}; choose from "
                         f"{ARCHS}")
    if name not in PORTED:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (ported: {PORTED}); "
            "see ROADMAP.md queue 1")
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get_config(name: str):
    return _mod(name).config()


def get_smoke(name: str):
    return _mod(name).smoke()


def list_archs(include_paper: bool = False):
    return [a for a in ARCHS if include_paper or a != "paper-cnn"]
