"""The sharded step's layout: what the reference gets from GSPMD under its
sharding rules, written out (`models/*`'s `lay=` paths use it).

A rank holds the pieces `rules.shard_params` cut: `data`-split leaves
are gathered at use (FSDP: `Layout.fsdp`, once a block, freed when the
block returns; under the train step's checkpoint they are gathered again
for the recompute), `model`-split leaves are used as they are (tensor
parallelism). The residual stream is whole over `model`, or, in training
under the reference's `_constrain` condition (`S % n_model == 0`, `S >
n_model`, the vocabulary split over `model`), split along the sequence
over `model` (`Layout.seq`).

A layer runs as regions, each `shard_map`'s semantics over `model`:

  split region — each rank computes its own heads / columns (its leaves
      split over `model`): the residual enters through `into` (an
      all-gather of the sequence when it is sequence-split, else an
      identity whose backward all-reduces), and leaves through `out` (a
      reduce-scatter into the sequence-split residual, else one
      all-reduce). A leaf or input replicated over `model` enters
      through `rep`: an identity whose backward all-reduces, as the
      transpose of a replicated input to `shard_map`.
  duplicated region — every rank computes the whole thing (its leaves
      replicated over `model`, as attention whose heads do not divide
      the axis, or RWKV's time-mix): whole residual in and out; under a
      sequence-split residual the sequence is gathered in, each rank
      keeps its own part of the output, and its leaves enter through
      `rep` (each rank's gradient is of its own part).

Norms applied to a sequence-split residual are of a region of the second
kind with no gather: `lay.resid.rep(scale)`.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import enter, gather, mesh_shape, reduce, scatter
from repro_torch.sharding.rules import leaf_split


class Layout:
    """This rank's place in the mesh, for one step."""

    def __init__(self, mesh, *, seq: bool = False):
        shape = mesh_shape(mesh)
        self.mesh, self.seq = mesh, seq
        self.n_model = shape.get("model", 1)
        self.r_model = mesh.get_local_rank("model") if "model" in shape \
            else 0
        self.resid = Region(self, False)

    def region(self, split: bool) -> "Region":
        return Region(self, split)

    def fsdp(self, p):
        """`p` (a block's module) with its `data`-split leaves gathered
        whole over `data` (autograd: the backward reduce-scatters each
        gradient onto its piece); the module itself when none is."""
        from repro_torch.models.common import Leaves
        named = dict(p.named_parameters())
        todo = {n: d for n, t in named.items()
                for d, a in leaf_split(t).items() if a == "data"}
        if not todo:
            return p
        for n, d in todo.items():
            named[n] = gather(named[n], self.mesh, "data", d)
        return Leaves(p, named)

    def leaf(self, t):
        """One top-level leaf (embedding, head) gathered over `data`."""
        for d, a in leaf_split(t).items():
            if a == "data":
                t = gather(t, self.mesh, "data", d)
        return t

    def local_seq(self, S: int) -> tuple:
        """(start, length) of this rank's part of a sequence of S."""
        n = S // self.n_model
        return self.r_model * n, n


class Region:
    """One region over `model` (see the module's docstring)."""

    def __init__(self, lay: Layout, split: bool):
        self.lay, self.split = lay, split
        self.on = lay.n_model > 1

    def into(self, x):
        """The residual (B, S_local, d) -> this region's input."""
        if not self.on:
            return x
        if self.lay.seq:
            return gather(x, self.lay.mesh, "model", 1)
        return enter(x, self.lay.mesh, "model") if self.split else x

    def out(self, y):
        """This region's output (B, S, d) -> the residual's layout."""
        if not self.on:
            return y
        if self.split:
            return scatter(y, self.lay.mesh, "model", 1) if self.lay.seq \
                else reduce(y, self.lay.mesh, "model")
        if self.lay.seq:
            lo, n = self.lay.local_seq(y.shape[1])
            return y.narrow(1, lo, n)
        return y

    def rep(self, t):
        """A leaf (or input) replicated over `model`, used here."""
        if not self.on or not (self.split or self.lay.seq):
            return t
        return enter(t, self.lay.mesh, "model")


def heads_of(lay: Layout, n_local: int) -> range:
    """The global indices of this rank's `n_local` heads."""
    return range(lay.r_model * n_local, (lay.r_model + 1) * n_local)


def as_range(idx) -> tuple:
    """(first, count) when `idx` is a run of consecutive ints, else None."""
    idx = list(idx)
    if idx == list(range(idx[0], idx[0] + len(idx))):
        return idx[0], len(idx)
    return None


def take(t, idx, dim: int):
    """t's entries `idx` along `dim` (a view when they are consecutive)."""
    run = as_range(idx)
    if run is not None:
        return t.narrow(dim, *run)
    return t.index_select(dim, torch.as_tensor(list(idx), device=t.device))
