"""Checkpointing (port of `repro/checkpoint/store.py`): flat-key npz
serialization of nested dicts, lists and tensors, and a per-client
directory store that doubles as the p2p model-exchange medium (a client
'sends' a model by publishing the checkpoint; peers fetch it).

The file format is the reference's, so a file written by either package
loads in the other: keys are the path joined with `|`, list items are
`#i`, None is an empty array under `|@none`, bf16 is stored as its
uint16 bits under `|@bf16` (npz has no bf16), metadata is strict JSON
under `@meta`. Leaves may be tensors or numpy arrays; `load_pytree`
gives CPU tensors (bf16 by a view of the bits, without ml_dtypes). A
model goes through `models.transformer.params_to_jax` and
`params_from_jax`, which give and take the reference's stacked layout.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np
import torch

_SEP = "|"


def _array(leaf) -> tuple:
    """A leaf -> (numpy array, True when its bits are bf16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), True
    return arr, False


def _flatten(tree) -> dict:
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in sorted(node.items()):
                rec(prefix + [str(k)], v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(prefix + [f"#{i}"], v)
        elif node is None:
            flat[_SEP.join(prefix + ["@none"])] = np.zeros((0,))
        else:
            arr, bf16 = _array(node)
            flat[_SEP.join(prefix + ["@bf16"] if bf16 else prefix)] = arr
    rec([], tree)
    return flat


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        tag = parts[-1] if parts[-1] in ("@none", "@bf16") else None
        if tag:
            parts = parts[:-1]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if tag == "@none":
            node[parts[-1]] = None
        elif tag == "@bf16":
            node[parts[-1]] = torch.from_numpy(
                val.view(np.int16).copy()).view(torch.bfloat16)
        else:
            node[parts[-1]] = torch.from_numpy(val.copy())

    def fix(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(re.fullmatch(r"#\d+", k) for k in keys):
                return [fix(node[f"#{i}"]) for i in range(len(keys))]
            return {k: fix(v) for k, v in node.items()}
        return node
    return fix(root)


def save_pytree(path: str, tree, metadata: dict | None = None) -> None:
    """Write `tree` (and strict-JSON `metadata`) to `path` atomically:
    into a temporary file beside it, then renamed."""
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    flat = _flatten(tree)
    if metadata is not None:
        flat["@meta"] = np.frombuffer(
            json.dumps(metadata, allow_nan=False).encode(), np.uint8)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_pytree(path: str):
    """Returns (tree of CPU tensors, metadata or None)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = None
    if "@meta" in flat:
        meta = json.loads(flat.pop("@meta").tobytes().decode())
    return _unflatten(flat), meta


class CheckpointStore:
    """Directory-backed store; publish/fetch is the gossip medium."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.root, name + ".npz")

    def publish(self, name: str, tree, metadata: dict | None = None) -> str:
        save_pytree(self.path(name), tree, metadata)
        return self.path(name)

    def fetch(self, name: str):
        return load_pytree(self.path(name))

    def list(self) -> list:
        return sorted(f[:-4] for f in os.listdir(self.root)
                      if f.endswith(".npz"))

    def exists(self, name: str) -> bool:
        return os.path.exists(self.path(name))
