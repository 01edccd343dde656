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
The reference's `dryrun` (compile-only over 512 fake devices) is not
ported yet.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import mesh_shape
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig, with_leaves


def pod_ring_exchange(params, mesh, shift: int = 1):
    """One gossip hop: this pod's parameters go to pod (p + shift) %
    n_pods and pod (p - shift) % n_pods's arrive. Returns the received
    model, of `params`' structure, its leaves views of one received
    buffer (the leaves are packed bytewise into one buffer, moved by one
    all_to_all_single over `pod`)."""
    n_pods = mesh_shape(mesh)["pod"]
    p = mesh.get_local_rank("pod")
    named = dict(params.named_parameters())
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in named.values()])
    recv = torch.empty_like(flat)
    send_sizes, recv_sizes = [0] * n_pods, [0] * n_pods
    send_sizes[(p + shift) % n_pods] = flat.numel()
    recv_sizes[(p - shift) % n_pods] = flat.numel()
    dist.all_to_all_single(recv, flat, recv_sizes, send_sizes,
                           group=mesh.get_group("pod"))
    leaves, at = {}, 0
    for name, t in named.items():
        n = t.numel() * t.element_size()
        leaves[name] = recv[at:at + n].view(t.dtype).view(t.shape)
        at += n
    return with_leaves(params, leaves)


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
        dist.all_reduce(vote, group=group)
        dist.all_reduce(denom, group=group)
        return vote / torch.clamp(denom, min=1e-9)

    return step
