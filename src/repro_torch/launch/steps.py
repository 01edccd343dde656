"""Step functions (train / prefill / serve) shared by the trainer and the
server (port of `repro/launch/steps.py`).

A train step updates the parameters and the optimizer state in place
and returns the loss. Microbatches are the reference's strided split of
the batch (row i goes to microbatch i % microbatches), with fp32
gradient accumulation; with one microbatch the gradients keep the
parameters' dtype, as `jax.value_and_grad` gives them. Every family
trains: the ssm (rwkv6) and hybrid (zamba2) ones on the card through the
scans' CUDA backward kernels (wkv_scan_bwd, ssd_scan_bwd), the moe
family with 0.01 x the router's load-balance aux loss added, the vlm
family with the batch's `img_emb`.

With a `mesh` (`launch/mesh.py`) every rank is given the whole batch
and takes its contiguous shard over `batch_axes` (the first axis major,
as a JAX sharding of dim 0); the parameters are this rank's pieces
(`sharding.rules.shard_params`: FSDP over `data`, tensor parallelism
over `model`; `models.moe.local_experts` cuts only the experts) and the
forward runs sharded where they are split (`sharding/layout.py`). A
train step returns the global loss (the mean over the `batch_axes`
ranks). Each gradient is averaged over those ranks before the update: a
leaf split over `data` gets its sum over `data` from the backward's
reduce-scatter onto its piece, the rest one all-reduce an axis. The
optimizer runs on the pieces (its moments are pieces alike, as
`rules.state_shardings` lays them out; Adafactor sums its factors and
clip over the split dims' groups). Cross-entropy is vocab-parallel where
the logits are split over `model` (max and sum over `model`). Prefill
and serve steps return this rank's shard of the logits (split over
`model` where the head is) and cache (as `rules.cache_shardings` lays
it out).

While a profiler records, a train step opens spans (`obs/spans.py`):
`train.step` around it, `train.forward{microbatch=i}` around the loss,
`train.backward{microbatch=i}` around the backward (the checkpoint's
recompute included), `train.accumulate` around the fp32 accumulators'
creation, each microbatch's add and the final division (microbatches >
1 only), and `train.optimizer` around the schedule and the update.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import (all_reduce_over, batch_shard,
                                     mesh_shape, reduce)
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig, cross_entropy, softcap
from repro_torch.obs.spans import span
from repro_torch.optim import make_optimizer
from repro_torch.sharding.rules import leaf_split, split_factor


def _local(x, mesh, batch_axes_):
    """This rank's contiguous shard of dim 0 of `x` over `batch_axes_`
    (x itself without a mesh)."""
    if mesh is None or x is None:
        return x
    i, n = batch_shard(mesh, batch_axes_)
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split over "
                         f"{n} ranks of {batch_axes_}")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def count_params(params, mesh=None) -> int:
    """The model's parameters; under a mesh a leaf cut by
    `rules.shard_params` counts as many times as it has pieces."""
    if mesh is None:
        return sum(p.numel() for p in params.parameters())
    return sum(p.numel() * split_factor(p, mesh)
               for p in params.parameters())


def vocab_parallel_cross_entropy(logits, labels, mesh, softcap_val=0.0):
    """`cross_entropy` of logits split over `model` by vocabulary (this
    rank's (..., V / n) columns, in rank order): the row max and the sum
    of exponentials are taken over `model`, and the gold logit is summed
    from the rank that holds it."""
    V = logits.shape[-1]
    lo = mesh.get_local_rank("model") * V
    z = softcap(logits.float(), softcap_val)
    m = all_reduce_over(z.detach().amax(-1).contiguous(), mesh, ("model",),
                        op="max")
    se = reduce(torch.exp(z - m[..., None]).sum(-1), mesh, "model")
    t = labels.long() - lo
    ok = (t >= 0) & (t < V)
    gold = torch.gather(z, -1, t.clamp(0, V - 1)[..., None])[..., 0]
    gold = reduce(torch.where(ok, gold, 0.0), mesh, "model")
    return torch.mean(m + torch.log(se) - gold)


def choose_optimizer(cfg: ModelConfig, n_params: int):
    """AdamW below 50B params; Adafactor above (as the reference: fp32
    moments of a 480B model would not fit)."""
    if n_params > 5e10:
        return make_optimizer("adafactor")
    return make_optimizer("adamw", weight_decay=0.1)


def make_train_step(cfg: ModelConfig, opt, lr_fn, mesh=None,
                    batch_axes=("data",), microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> loss (a 0-d fp32
    tensor). `batch` holds `tokens` and `labels`, (B, S) tensors ((B, S,
    ncb) for audio) on the parameters' device, B a multiple of
    `microbatches` (of it times the `batch_axes` ranks under a mesh), and
    for vlm `img_emb`. `lr_fn` gets the optimizer's step count before the
    update."""

    def loss_fn(params, b):
        logits, extra = tf.forward(params, cfg, b["tokens"], mode="train",
                                   img_emb=b.get("img_emb"), mesh=mesh,
                                   batch_axes=batch_axes)
        if mesh is not None and logits.shape[-1] < cfg.vocab:
            loss = vocab_parallel_cross_entropy(
                logits, b["labels"], mesh, cfg.final_logit_softcap)
        else:
            loss = cross_entropy(logits, b["labels"],
                                 cfg.final_logit_softcap)
        if cfg.n_experts and extra is not None:
            loss = loss + 0.01 * extra  # router load-balance aux
        return loss

    def grads_of(loss, leaves):
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, gs)]

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        leaves = list(named.values())
        with span("train.step", device=leaves[0].device):
            return step_body(params, opt_state, batch, named, leaves)

    def step_body(params, opt_state, batch, named, leaves):
        batch = {k: _local(v, mesh, batch_axes) for k, v in batch.items()}
        if microbatches > 1:
            with span("train.accumulate"):
                loss = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
                grads = [torch.zeros_like(p, dtype=torch.float32)
                         for p in leaves]
            for i in range(microbatches):
                b = {k: v[i::microbatches] for k, v in batch.items()}
                with span("train.forward", microbatch=i):
                    mb_loss = loss_fn(params, b)
                with span("train.backward", microbatch=i):
                    gs = grads_of(mb_loss, leaves)
                with span("train.accumulate"):
                    for acc, g in zip(grads, gs):
                        acc.add_(g)
                    loss += mb_loss.detach()
                del gs
            with span("train.accumulate"):
                loss /= microbatches
                torch._foreach_div_(grads, float(microbatches))
        else:
            with span("train.forward", microbatch=0):
                loss = loss_fn(params, batch)
            with span("train.backward", microbatch=0):
                grads = grads_of(loss, leaves)
            loss = loss.detach()
        split = None
        if mesh is not None:
            n = batch_shard(mesh, batch_axes)[1]
            n_data = mesh_shape(mesh).get("data", 1)
            loss = all_reduce_over(loss.clone(), mesh, batch_axes) / n
            # in place, a leaf at a time: no second copy of the gradients
            for i, p in enumerate(leaves):
                fsdp = "data" in leaf_split(p).values()
                axes = [a for a in batch_axes if not (fsdp and a == "data")]
                g = all_reduce_over(grads[i].contiguous(), mesh, axes)
                # the reduce-scatter summed n_data copies of a step whose
                # batch is not split over data
                grads[i] = g.div_(n * (n_data if fsdp and "data" not in
                                       batch_axes else 1))
            split = {k: {d - p.dim(): mesh.get_group(a)
                         for d, a in leaf_split(p).items()}
                     for k, p in named.items() if leaf_split(p)}
        with span("train.optimizer"):
            lr = lr_fn(opt_state["step"])
            opt.update(dict(zip(named, grads)), opt_state, named, lr,
                       split=split)
        return loss

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh=None, batch_axes=("data",),
                      cache_len: int = 0, last_only: bool = True):
    def prefill_step(params, batch):
        logits, cache = tf.forward(
            params, cfg, _local(batch["tokens"], mesh, batch_axes),
            mode="prefill",
            img_emb=_local(batch.get("img_emb"), mesh, batch_axes),
            mesh=mesh, batch_axes=batch_axes, cache_len=cache_len,
            last_only=last_only)
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None, batch_axes=("data",)):
    """serve_step(params, batch) with batch {tokens (B, 1) (this rank's
    shard is taken under a mesh), cache (this rank's), t}."""
    def serve_step(params, batch):
        logits, new_cache = tf.forward(
            params, cfg, _local(batch["tokens"], mesh, batch_axes),
            mode="decode", cache=batch["cache"], t=batch["t"], mesh=mesh,
            batch_axes=batch_axes)
        return logits[:, -1], new_cache

    return serve_step
