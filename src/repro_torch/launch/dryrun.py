"""The dry run (port of `repro/launch/dryrun.py`): each (arch, shape)
step of rank 0 of the production world, counted without a device.

The world is torch's fake process group (`FakeStore`, backend "fake":
its collectives move nothing) of 256 ranks (16 x 16, `data` x `model`)
or 512 (2 x 16 x 16 with `pod`); every tensor lies on the `meta` device
(shapes and dtypes, no memory), at full width and depth. The step is the
sharded step (`rules.shard_params`, `sharding/layout.py`,
`launch/steps.py`): rank 0's pieces of the parameters, its batch shard,
its cache. The record is the reference's, key for key:

  flops_per_device — the matrix FLOPs of the step (mm, bmm, einsum, the
      attention products, the backward's), from
      `torch.utils.flop_counter.FlopCounterMode`. XLA's cost analysis
      also counts elementwise work (softmax, norms, activations, the
      optimizer's updates), so the reference's count of the same step is
      larger by that share.
  bytes_per_device — the input and output bytes of every aten op the
      step runs (views excluded), from a `TorchDispatchMode` counter: an
      unfused program's traffic, as XLA's "bytes accessed" is.
  collective_bytes_per_device / collective_counts_scan — from the
      collective ledger (`launch.mesh.record_collectives`), with the
      reference's ring accounting (`collective_bytes`).
  memory — argument and output bytes exactly, from the local pieces
      (alias: the donated inputs, the train step's parameters and
      optimizer state, the serve step's cache); temp bytes -1, the
      reference's own default: torch's mem_tracker follows a module's
      forward and backward, not a step's optimizer and collectives, so it
      gives no figure to put beside XLA's.
  compile_seconds — the seconds to trace the full-depth step once.

The port's layers are a Python loop, so the full-depth counts are exact
(the reference extrapolates from two shallow probes because XLA counts a
scanned body once). `probe_plan` is kept, and with `--probes` the two
probe depths are traced too: f(L1) + k (f(L2) - f(L1)) must equal f(L)
for FLOPs and (but for Adafactor's steps) collective bytes
(`check_probes`).

    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes --out DIR
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, list_archs
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import (batch_axes as mesh_batch_axes,
                                     make_host_mesh, make_production_mesh,
                                     mesh_shape, record_collectives)
from repro_torch.launch.shapes import SHAPES, arch_for_shape, input_specs
from repro_torch.models import transformer as tf
from repro_torch.obs.metrics import Stopwatch
from repro_torch.sharding.rules import cache_shardings, shard_params, \
    shard_tree

RING_FACTOR = {"all-gather": lambda g: 1.0, "all-reduce": lambda g: 2.0,
               "reduce-scatter": lambda g: float(max(1, g - 1)),
               "all-to-all": lambda g: 1.0,
               "collective-permute": lambda g: 1.0}


class MetaGen(torch.Generator):
    """A generator whose draws land on the meta device (shapes only)."""
    device = torch.device("meta")


def collective_bytes(events, default_group: int):
    """Per-device link bytes of a collective ledger (`(op, dtype, local
    result shape, group size)` tuples), the reference's ring accounting
    (`parse_collectives`): all-gather x 1, all-reduce x 2, reduce-scatter
    x (g - 1), all-to-all and permute x 1, each of the local result's
    bytes. A group size of None takes `default_group`. Returns
    ({op: bytes}, {op: count})."""
    out = dict.fromkeys(RING_FACTOR, 0.0)
    counts = dict.fromkeys(RING_FACTOR, 0)
    for op, dtype, shape, g in events:
        nbytes = torch.empty((), dtype=dtype).element_size()
        for d in shape:
            nbytes *= int(d)
        out[op] += nbytes * RING_FACTOR[op](g or default_group)
        counts[op] += 1
    return out, counts


class _Bytes(TorchDispatchMode):
    """Sums the bytes of every tensor an aten op reads or writes (views
    and metadata-only ops excluded)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False) and \
                func.name() not in _FREE:
            self.total += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        return out


_FREE = {"aten::detach", "aten::empty.memory_format", "aten::empty_like",
         "aten::empty_strided", "aten::lift_fresh", "aten::_to_copy.out",
         "aten::new_empty", "aten::set_"}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return 0


def _tree_bytes(x) -> int:
    if isinstance(x, torch.nn.Module):
        return sum(_nbytes(t) for t in x.parameters())
    return _nbytes(x)


class FakeWorld:
    """torch's fake process group of `n` ranks, this process rank 0, for
    the block's length."""

    def __init__(self, n: int):
        from torch.testing._internal.distributed.fake_pg import FakeStore
        self.n = n
        self.store = FakeStore()

    def __enter__(self):
        dist.init_process_group("fake", store=self.store, rank=0,
                                world_size=self.n)
        return self

    def __exit__(self, *exc):
        dist.destroy_process_group()


def _local_batch(batch: dict, mesh, baxes) -> dict:
    return {k: steps_mod._local(v, mesh, baxes) for k, v in batch.items()}


def build_step(cfg, shape, mesh, n_params: int = 0):
    """(step thunk, argument bytes, n_params, batch axes, optimizer name
    or None) of this (arch, shape) on rank 0 of `mesh`; the thunk runs
    the step once and returns (its outputs, the donated inputs' bytes).
    `n_params` (the full config's) picks the optimizer, as at full depth,
    for probes."""
    baxes = mesh_batch_axes(mesh, shape.global_batch)
    specs = input_specs(cfg, shape)
    cfg = arch_for_shape(cfg, shape)
    full = tf.init_params(cfg, MetaGen())
    count = steps_mod.count_params(full)
    params = shard_params(full, mesh, cfg)
    del full
    opt = None
    if shape.kind == "train":
        opt = steps_mod.choose_optimizer(cfg, n_params or count)
        state = opt.init(dict(params.named_parameters()))
        fn = steps_mod.make_train_step(cfg, opt, lambda s: 1e-4, mesh=mesh,
                                       batch_axes=baxes)
        args = _tree_bytes(params) + _tree_bytes(state) + _tree_bytes(
            _local_batch(specs, mesh, baxes))

        def run():
            donated = _tree_bytes(params) + _tree_bytes(state)
            loss = fn(params, state, specs)
            return (params, state, loss), donated
    elif shape.kind == "prefill":
        cache_len = min(shape.seq_len, cfg.decode_window) \
            if cfg.decode_window else shape.seq_len
        fn = steps_mod.make_prefill_step(cfg, mesh=mesh, batch_axes=baxes,
                                         cache_len=cache_len)
        args = _tree_bytes(params) + _tree_bytes(
            _local_batch(specs, mesh, baxes))

        def run():
            with torch.no_grad():
                return fn(params, specs), 0
    else:
        cache = shard_tree(specs["cache"], cache_shardings(
            mesh, specs["cache"], baxes), mesh)
        fn = steps_mod.make_serve_step(cfg, mesh=mesh, batch_axes=baxes)
        batch = {"tokens": specs["tokens"], "cache": cache,
                 "t": _decode_t(cache)}
        args = _tree_bytes(params) + _tree_bytes(cache) + _tree_bytes(
            steps_mod._local(specs["tokens"], mesh, baxes))

        def run():
            with torch.no_grad():
                return fn(params, batch), _tree_bytes(cache)
    return run, args, count, baxes, opt and opt.name


def _decode_t(cache) -> int:
    """The new token's position: the last slot of a full cache (the
    reference's decode shapes read a cache of seq_len)."""
    def first(node):
        if isinstance(node, dict):
            if "pos" in node:
                return node["pos"].shape[0]
            return next((v for v in map(first, node.values()) if v), 0)
        if isinstance(node, list):
            return next((v for v in map(first, node) if v), 0)
        return 0
    return max(first(cache) - 1, 0)


def probe_plan(cfg):
    """(L1, L2, k): per-layer costs are linear in depth, so
    total(L) = f(L1) + k * (f(L2) - f(L1)) with structure-preserving probe
    depths (keeps gemma2 local/global pairs, zamba2 super-layers of
    `shared_attn_every` SSM blocks + 1 shared attn, VLM periods intact).
    The reference needs them because XLA's cost analysis counts a
    while-loop body once; the port counts every layer and keeps them as a
    check (`check_probes`)."""
    L = cfg.n_layers
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        tail = L % every
        return every + tail, 2 * every + tail, L // every - 1
    if cfg.family == "vlm":
        p = cfg.cross_attn_every
        return p, 2 * p, L // p - 1
    if L % 2 == 0:
        return 2, 4, (L - 2) // 2
    return 3, 5, (L - 3) // 2


def count_step(cfg, shape, mesh, n_params: int = 0) -> dict:
    """Traces one step and counts it: flops, bytes, collectives, memory,
    seconds."""
    sw = Stopwatch().start()
    run, args, count, baxes, opt = build_step(cfg, shape, mesh, n_params)
    counter = _Bytes()
    with record_collectives() as events, FlopCounterMode(
            display=False) as flops, counter:
        out, donated = run()
    coll, counts = collective_bytes(events, mesh_shape(mesh)["model"])
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(counter.total), "coll": coll, "counts": counts,
            "argument_bytes": args, "output_bytes": _tree_bytes(out),
            "alias_bytes": donated, "n_params": count,
            "batch_axes": list(baxes), "optimizer": opt,
            "seconds": sw.peek()}


def check_probes(cfg, shape, mesh, full: dict) -> dict:
    """f(L1) + k (f(L2) - f(L1)) of FLOPs and collective bytes, which
    must equal the full-depth counts; returns the extrapolation.
    Adafactor (the train step of a model above 50B parameters) updates a
    stack of leaves above 64 MB layer by layer, each layer's clip one
    all-reduce over a split leaf's groups: a stack crosses that size at
    some depth, so its collectives are not linear in depth (in the
    reference's extrapolation either) and only its FLOPs are held."""
    L1, L2, k = probe_plan(cfg)
    f1 = count_step(cfg.replace(n_layers=L1), shape, mesh, full["n_params"])
    f2 = count_step(cfg.replace(n_layers=L2), shape, mesh, full["n_params"])
    ext = {"flops": f1["flops"] + k * (f2["flops"] - f1["flops"]),
           "bytes": f1["bytes"] + k * (f2["bytes"] - f1["bytes"]),
           "coll": {op: f1["coll"][op] + k * (f2["coll"][op] - f1["coll"][op])
                    for op in f1["coll"]}}
    held = [("flops", ext["flops"], full["flops"])]
    if full["optimizer"] != "adafactor":
        held += [(op, ext["coll"][op], full["coll"][op])
                 for op in ext["coll"]]
    bad = [what for what, a, b in held
           if abs(a - b) > 1e-9 * max(abs(b), 1.0)]
    if bad:
        raise AssertionError(f"{cfg.name}: probe extrapolation of {bad} "
                             f"differs from the full-depth count")
    return ext


def run_one(arch: str, shape_name: str, multi_pod: bool,
            probes: bool = False, cfg=None, dims=None) -> dict:
    """The record of one (arch, shape, mesh); `cfg` replaces the arch's
    full config and `dims` ((data, model)) the production mesh (tests
    pass a smoke config and a small world)."""
    sw = Stopwatch().start()
    shape = SHAPES[shape_name]
    cfg = arch_for_shape(cfg or get_config(arch), shape)
    n_dev = (512 if multi_pod else 256) if dims is None else \
        dims[0] * dims[1]
    with FakeWorld(n_dev):
        if dims is None:
            mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        else:
            mesh = make_host_mesh(*dims, device="meta")
        full = count_step(cfg, shape, mesh)
        if probes:
            check_probes(cfg, shape, mesh, full)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(n) for n in mesh.shape),
        "n_devices": n_dev,
        "n_params": full["n_params"],
        "batch_axes": full["batch_axes"],
        "flops_per_device": full["flops"],
        "bytes_per_device": full["bytes"],
        "flops_scan_raw": full["flops"],
        "memory": {
            "argument_bytes": full["argument_bytes"],
            "output_bytes": full["output_bytes"],
            "temp_bytes": -1,
            "alias_bytes": full["alias_bytes"],
        },
        "collective_bytes_per_device": full["coll"],
        "collective_counts_scan": full["counts"],
        "compile_seconds": round(full["seconds"], 1),
        "total_seconds": round(sw.peek(), 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/torch/dryrun")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--probes", action="store_true",
                    help="also trace the two probe depths and check the "
                         "extrapolation against the full-depth count")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)

    n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape_name}__{'mp' if mp else 'sp'}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_done and os.path.exists(path):
                    print(f"[skip] {tag}", flush=True)
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    res = run_one(arch, shape_name, mp, probes=args.probes)
                    with open(path, "w") as f:
                        json.dump(res, f, indent=1, allow_nan=False)
                    print(f"[ok] {tag} trace={res['compile_seconds']}s "
                          f"flops/dev={res['flops_per_device']:.3e} "
                          f"args={res['memory']['argument_bytes'] / 1e9:.1f}"
                          "GB", flush=True)
                except Exception as e:  # noqa: BLE001
                    n_fail += 1
                    with open(os.path.join(args.out, tag + ".FAIL"),
                              "w") as f:
                        f.write(traceback.format_exc())
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}",
                          flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
