"""The port stands alone: importing every `repro_torch` module (the
example drivers and replint included; replint linting its own package
and a tiny lossy_links run), running
a tiny synchronous slice, a tiny asynchronous run (lossy gossip, churn,
repair, bounded stores, observability), one with faults and the
validation gate and one serving queries through a label shift (the
fault, admission, serving and dynamic-selection modules), one on the
compiled array world with the restack selection path, a two-round
baseline (FML) with the clustered-gossip saving, a tiny ensemble
`serve_batch` of the dense llama3-8b, ssm rwkv6-3b, hybrid zamba2-7b and
moe qwen3-moe-235b-a22b families, one prefill and decode step of the
vlm llama-3.2-vision-11b (with images) and the audio musicgen-medium
(with codebooks), two training steps of smoke qwen2.5-3b and rwkv6-3b
with a checkpoint, and, on a one-rank gloo world, a pod ring exchange
and ensemble vote, an expert-parallel MoE train step with Adafactor and
a sharded hybrid train step (the mesh, sharding, pod and MoE mesh
modules), and a dry run with its roofline and the pods' dry run on fake
worlds (the dry-run and roofline modules) on the CPU loads neither JAX
nor any module of the reference package `repro`."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.join(os.path.dirname(__file__), "..")

SCRIPT = r"""
import importlib, json, pkgutil, sys
import repro_torch
walked = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in walked:
    importlib.import_module(name)
assert {"repro_torch.analysis.rules", "repro_torch.analysis.__main__",
        "repro_torch.examples.lossy_links",
        "repro_torch.examples.serve_drift"} <= set(walked)
from repro_torch.analysis import lint_paths
from repro_torch.examples import lossy_links
assert lint_paths([repro_torch.__path__[0] + "/analysis"]).exit_code == 0
assert lossy_links.run_once(4, 1, 0.1, True, device="cpu")[1]["coverage"] \
    == 1.0
from repro_torch.sim import Experiment, ExperimentSpec
spec = ExperimentSpec.from_dict({
    "data": {"kind": "synthetic_images", "n_clients": 2, "n_classes": 4,
             "n_samples": 240, "image_size": 8},
    "train": {"families": ["cnn4", "vgg"], "max_epochs": 1, "width": 4},
    "selection": {"pop_size": 8, "generations": 2, "k": 2,
                  "use_kernel": True}})
res = Experiment.from_spec(spec, device="cpu").run()
assert res.test_acc.shape == (2,)
spec = ExperimentSpec.from_dict({
    "data": {"kind": "prediction_world", "n_clients": 6, "n_val": 16},
    "selection": {"pop_size": 8, "generations": 2, "k": 2,
                  "store_capacity": 5},
    "network": {"topology": "ring", "transport": {"name": "gossip",
                "params": {"drop_prob": 0.2}}, "gossip": "push",
                "churn": "lognormal", "repair": "anti_entropy"},
    "schedule": {"mode": "async"}, "obs": {"enabled": True,
                                           "trace": True}})
res = Experiment.from_spec(spec, device="cpu").run()
assert res.coverage > 0 and res.metrics.names()
world = {"data": {"kind": "prediction_world", "n_clients": 6, "n_val": 16},
         "selection": {"pop_size": 8, "generations": 2, "k": 2},
         "network": {"topology": "ring", "transport": "gossip",
                     "gossip": "push", "repair": "anti_entropy"},
         "schedule": {"mode": "async"}}
spec = ExperimentSpec.from_dict({**world, "faults": {
    "injectors": ["byzantine", "corruption", "crash_restart", "partition"],
    "admission": "validation_gate"}})
res = Experiment.from_spec(spec, device="cpu").run()
assert res.net["faults"]["n_crashes"] >= 0 and "admission" in res.net
spec = ExperimentSpec.from_dict({**world, "serve": {
    "traffic": {"name": "poisson", "params": {"duration": 3.0}},
    "drift": [{"name": "label_shift", "params": {"at": 1.5}}]}})
res = Experiment.from_spec(spec, device="cpu").run()
assert res.net["serve"]["n_queries"] > 0
spec = ExperimentSpec.from_dict({
    **world, "network": {**world["network"], "transport": {
        "name": "gossip", "params": {"drop_prob": 0.1}},
        "churn": "lognormal"},
    "selection": {**world["selection"], "device_resident": False},
    "schedule": {"mode": "async", "select_during_run": False,
                 "backend": {"name": "compiled",
                             "params": {"chunk_ticks": 16}}},
    "obs": {"enabled": True}})
res = Experiment.from_spec(spec, device="cpu").run()
assert res.perf["backend"] == "compiled" and res.metrics.names()
assert res.engine.store_batch is None and res.engine.select()
from repro_torch.benchmarks.common import make_clients
from repro_torch.fl.baselines import BASELINES, FLConfig
from repro_torch.fl.clustering import ClusterState, clustering_savings
clients, _ = make_clients(3, 0.5, 300, 4, size=8)
acc = BASELINES["fml"](clients, 4, FLConfig(rounds=2, local_steps=1,
                       families=("cnn4", "vgg"), width=4), device="cpu")
assert acc.shape == (3,)
st = ClusterState.init(4)
st.update(0, [1, 2])
assert clustering_savings(st) == 0.5
import torch
from repro_torch.core.dynamic import des_accuracy
x = torch.rand(8, 4)
assert float(des_accuracy(x, torch.zeros(8, dtype=torch.int64), x,
                          torch.zeros(8, dtype=torch.int64),
                          torch.rand(3, 8, 2), torch.rand(3, 8, 2),
                          K=2, k=2)) >= 0
import torch
from repro_torch.configs import get_smoke
from repro_torch.launch.serve import serve_batch
from repro_torch.models.transformer import init_params
for arch, kw in (("llama3-8b", {"attn_impl": "pallas"}), ("rwkv6-3b", {}),
                 ("zamba2-7b", {}), ("qwen3-moe-235b-a22b", {})):
    cfg = get_smoke(arch).replace(dtype="float32", **kw)
    members = [init_params(cfg, torch.Generator().manual_seed(i))
               for i in range(2)]
    toks = serve_batch(cfg, members, torch.zeros((2, 8), dtype=torch.int32),
                       gen_len=3)
    assert toks.shape == (2, 3)
from repro_torch.launch.steps import make_prefill_step, make_serve_step
for arch in ("llama-3.2-vision-11b", "musicgen-medium"):
    cfg = get_smoke(arch).replace(dtype="float32", attn_impl="pallas")
    model = init_params(cfg, torch.Generator().manual_seed(0))
    shp = (2, 8, cfg.n_codebooks) if cfg.n_codebooks else (2, 8)
    batch = {"tokens": torch.zeros(shp, dtype=torch.int32)}
    if cfg.d_vision:
        batch["img_emb"] = torch.ones((2, cfg.n_img_tokens, cfg.d_vision))
    with torch.no_grad():
        logits, cache = make_prefill_step(cfg, cache_len=9)(model, batch)
        step, _ = make_serve_step(cfg)(model, {
            "tokens": batch["tokens"][:, :1], "cache": cache, "t": 8})
    assert step.shape == logits.shape and torch.isfinite(step).all()
import tempfile
from repro_torch.launch.train import train
for arch in ("qwen2.5-3b", "rwkv6-3b"):
    with tempfile.TemporaryDirectory() as ckpt:
        _, losses, _, _ = train(arch, "smoke", steps=2, batch=2, seq=16,
                                device="cpu", ckpt_dir=ckpt)
    assert len(losses) == 2
import os
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch import fedpae_pods
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import moe as tmoe
from repro_torch.optim import constant, make_optimizer
from repro_torch.sharding import param_shardings, placements
with tempfile.TemporaryDirectory() as d:
    tmesh.init_world("cpu", store=dist.FileStore(os.path.join(d, "s"), 1),
                     timeout=60)
    try:
        pods = init_device_mesh("cpu", (1, 1, 1),
                                mesh_dim_names=("pod", "data", "model"))
        cfg = get_smoke("llama3-8b").replace(dtype="float32",
                                             attn_impl="pallas")
        m = fedpae_pods.pod_ring_exchange(
            init_params(cfg, torch.Generator().manual_seed(0)), pods)
        vote = fedpae_pods.make_ensemble_serve_step(cfg, pods)(
            m, 1.0, torch.zeros((2, 8), dtype=torch.int32))
        assert tuple(vote.shape) == (2, 1, cfg.vocab)
        mesh = tmesh.make_host_mesh(1, 1, device="cpu")
        cfg = get_smoke("qwen3-moe-235b-a22b").replace(dtype="float32")
        m = tmoe.local_experts(init_params(
            cfg, torch.Generator().manual_seed(0)), cfg, mesh)
        placements(param_shardings(mesh, m, cfg)["layers.0.ffn.wg"], mesh)
        opt = make_optimizer("adafactor")
        toks = torch.zeros((2, 9), dtype=torch.int64)
        loss = make_train_step(cfg, opt, constant(1e-3), mesh=mesh)(
            m, opt.init(dict(m.named_parameters())),
            {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        assert bool(torch.isfinite(loss))
        from repro_torch.sharding.rules import gather_params, shard_params
        cfg = get_smoke("zamba2-7b").replace(dtype="float32")
        m = shard_params(init_params(cfg, torch.Generator().manual_seed(0)),
                         mesh, cfg)
        loss = make_train_step(cfg, make_optimizer("sgd"), constant(1e-3),
                               mesh=mesh)(m, {"step": 0}, {
            "tokens": toks[:, :-1], "labels": toks[:, 1:]})
        assert bool(torch.isfinite(loss)) and gather_params(m, mesh)
    finally:
        dist.destroy_process_group()
from repro_torch.launch.dryrun import run_one
from repro_torch.roofline import roofline_terms
rec = run_one("rwkv6-3b", "decode_32k", False, cfg=get_smoke("rwkv6-3b"),
              dims=(2, 2))
assert roofline_terms(rec)["step_lower_bound_s"] > 0
assert fedpae_pods.dryrun(dims=(2, 1, 1))["exchange_bytes_per_device"] > 0
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
