"""FedPAE at pod scale: clients = pods (port of
`repro/launch/fedpae_pods.py`).

The paper's two distributed primitives over the `pod` axis of a mesh
(`launch/mesh.py`):

  pod_ring_exchange — one peer-to-peer gossip step: every pod sends its
      model to pod (p + shift) % n_pods over the `pod` group (the
      reference's `ppermute`). After k steps on a p-pod ring every pod
      has held k + 1 bench members.

  make_ensemble_serve_step — serve the SELECTED ensemble: every pod runs
      its bench member forward on the SAME request batch, and the
      ensemble mean-probability vote is one all_reduce over `pod` of the
      member's probabilities weighted by its NSGA-II chromosome entry.

The reference stacks the pods' members on a leading axis, which its
single controller needs; here each rank holds its own pod's member.
Every step runs its collectives at any world size, one pod included.
`dryrun` traces both on rank 0 of the 2 x 16 x 16 fake world (meta
tensors, `launch/dryrun.py`'s counters).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import all_reduce_in, mesh_shape, record
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig, with_leaves
from repro_torch.obs.metrics import Stopwatch


class _Lap:
    """Milliseconds of each part of a step, into `times` (CUDA events on
    the card, the host's clock elsewhere); nothing without `times`."""

    def __init__(self, times, device):
        self.times, self.cuda = times, device.type == "cuda"
        self.sw = Stopwatch()
        self.mark = self._now()

    def _now(self):
        if self.times is None:
            return None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        self.sw.start()
        return self.sw

    def __call__(self, part: str):
        if self.times is None:
            return
        if self.cuda:
            end = self._now()
            end.synchronize()
            self.times[part] = self.mark.elapsed_time(end)
            self.mark = end
        else:
            self.times[part] = self.sw.stop() * 1e3
            self.mark = self._now()


def pod_ring_exchange(params, mesh, shift: int = 1, times=None):
    """One gossip hop: this pod's parameters go to pod (p + shift) %
    n_pods and pod (p - shift) % n_pods's arrive. Returns the received
    model, of `params`' structure, its leaves views of one received
    buffer (the leaves are packed bytewise into one buffer, moved by one
    all_to_all_single over `pod`). A dict `times` gets the ms of the
    pack, the collective and the unpack (each ended by a device sync on
    the card, so the parts do not overlap)."""
    n_pods = mesh_shape(mesh)["pod"]
    p = mesh.get_local_rank("pod")
    named = dict(params.named_parameters())
    lap = _Lap(times, next(iter(named.values())).device)
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in named.values()])
    recv = torch.empty_like(flat)
    lap("pack")
    send_sizes, recv_sizes = [0] * n_pods, [0] * n_pods
    send_sizes[(p + shift) % n_pods] = flat.numel()
    recv_sizes[(p - shift) % n_pods] = flat.numel()
    group = mesh.get_group("pod")
    record("collective-permute", recv, group)
    dist.all_to_all_single(recv, flat, recv_sizes, send_sizes, group=group)
    lap("collective")
    leaves, at = {}, 0
    for name, t in named.items():
        n = t.numel() * t.element_size()
        leaves[name] = recv[at:at + n].view(t.dtype).view(t.shape)
        at += n
    out = with_leaves(params, leaves)
    lap("unpack")
    return out


def make_ensemble_serve_step(cfg: ModelConfig, mesh):
    """step(member, chromosome_weight, tokens) -> (B, 1, V) fp32 vote.
    `member` is this pod's bench member, `chromosome_weight` its entry of
    the chromosome (a float or 0-d tensor), `tokens` the request batch,
    the same on every pod."""
    group = mesh.get_group("pod")

    def step(member, chromosome_weight, tokens):
        logits, _ = tf.forward(member, cfg, tokens, mode="train",
                               last_only=True)
        probs = torch.softmax(logits.float(), dim=-1)
        w = torch.as_tensor(chromosome_weight, dtype=torch.float32,
                            device=probs.device).reshape(())
        vote = w * probs
        denom = w.clone()
        all_reduce_in(vote, group)
        all_reduce_in(denom, group)
        return vote / torch.clamp(denom, min=1e-9)

    return step


def dryrun(multi_pod: bool = True, arch: str = "llama3-8b", dims=None):
    """Both primitives traced on rank 0 of the production world (2 x 16 x
    16 multi-pod; torch's fake process group, meta tensors) at the
    smoke width of `arch` (full archs go through `launch/dryrun.py`), or
    of a (pod, data, model) world of `dims`: prints and returns the
    exchange's link bytes a device (ring accounting) and the vote's
    matrix FLOPs a device."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_smoke
    from repro_torch.launch.dryrun import FakeWorld, MetaGen, collective_bytes
    from repro_torch.launch.mesh import (_mesh, make_production_mesh,
                                         record_collectives)
    cfg = get_smoke(arch)
    n = (512 if multi_pod else 256) if dims is None else math.prod(dims)
    with FakeWorld(n):
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta") \
            if dims is None else _mesh("meta", tuple(dims),
                                       ("pod", "data", "model"))
        member = tf.init_params(cfg, MetaGen())
        with record_collectives() as events:
            pod_ring_exchange(member, mesh)
        coll, _ = collective_bytes(events, mesh_shape(mesh)["pod"])
        toks = torch.empty((4, 32), dtype=torch.int32, device="meta")
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            make_ensemble_serve_step(cfg, mesh)(member, 1.0, toks)
    out = {"exchange_bytes_per_device": coll["collective-permute"],
           "vote_flops_per_device": float(fc.get_total_flops())}
    print(f"pod_ring_exchange: {out['exchange_bytes_per_device']:.6e} "
          f"bytes a device; ensemble_serve_step: "
          f"{out['vote_flops_per_device']:.6e} flops a device")
    return out


if __name__ == "__main__":
    dryrun()
