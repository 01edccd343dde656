"""The port stands alone: importing every `repro_torch` module, running
a tiny synchronous slice, a tiny ensemble `serve_batch` of each ported
model family (dense llama3-8b, ssm rwkv6-3b, hybrid zamba2-7b) and two
training steps of smoke qwen2.5-3b and rwkv6-3b with a checkpoint on the
CPU loads neither JAX nor any module of the reference package `repro`."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.join(os.path.dirname(__file__), "..")

SCRIPT = r"""
import importlib, json, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch.sim import Experiment, ExperimentSpec
spec = ExperimentSpec.from_dict({
    "data": {"kind": "synthetic_images", "n_clients": 2, "n_classes": 4,
             "n_samples": 240, "image_size": 8},
    "train": {"families": ["cnn4", "vgg"], "max_epochs": 1, "width": 4},
    "selection": {"pop_size": 8, "generations": 2, "k": 2,
                  "use_kernel": True}})
res = Experiment.from_spec(spec, device="cpu").run()
assert res.test_acc.shape == (2,)
import torch
from repro_torch.configs import get_smoke
from repro_torch.launch.serve import serve_batch
from repro_torch.models.transformer import init_params
for arch, kw in (("llama3-8b", {"attn_impl": "pallas"}), ("rwkv6-3b", {}),
                 ("zamba2-7b", {})):
    cfg = get_smoke(arch).replace(dtype="float32", **kw)
    members = [init_params(cfg, torch.Generator().manual_seed(i))
               for i in range(2)]
    toks = serve_batch(cfg, members, torch.zeros((2, 8), dtype=torch.int32),
                       gen_len=3)
    assert toks.shape == (2, 3)
import tempfile
from repro_torch.launch.train import train
for arch in ("qwen2.5-3b", "rwkv6-3b"):
    with tempfile.TemporaryDirectory() as ckpt:
        _, losses, _, _ = train(arch, "smoke", steps=2, batch=2, seq=16,
                                device="cpu", ckpt_dir=ckpt)
    assert len(losses) == 2
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps(bad))
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_cuda_request_without_cuda_raises():
    import torch

    from repro_torch.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device(None)
