"""Logical sharding rules (port of `repro/sharding/rules.py`): parameter
path regex -> PartitionSpec for the TRAILING dims; leading stacked-layer
dims are padded with None.

Strategy (as the reference): tensor-parallel over `model` on heads /
d_ff / experts / vocab, FSDP over `data` on the complementary dim, batch
over (`pod`, `data`). SSM/RWKV inner weights stay data-sharded only.

The rules are the reference's, rule for rule, and speak of its trees:
one leaf a stack of blocks (`layers/attn/wq` is (L, d, H hd)). The port
holds one tensor a block (`layers.3.attn.wq` is (d, H hd)); each dotted
name maps onto the reference's path by dropping its block indices, whose
count is the number of stacked dims the reference pads. A port leaf's
spec is the reference leaf's without those leading (always None)
entries. Caches are lists of per-layer dicts; their list indices are
the stacked dims in the same way.

`shard_params` cuts a model to the piece of each leaf these specs give
a rank (`data` as FSDP, `model` as tensor parallelism), and the sharded
step (`sharding/layout.py`, the models' `lay=` paths) runs on those
pieces; `gather_params` gives the whole leaves back. The MoE's
`local_experts` is the case that cuts only the expert leaves over
`model`.
"""
from __future__ import annotations

import re

import math

from repro_torch.launch.mesh import all_gather_over, batch_shard, mesh_shape


class PartitionSpec(tuple):
    """A tuple of one entry a tensor dim: a mesh axis name, None
    (replicated), or a tuple of names (one dim over several mesh axes,
    the first major), as `jax.sharding.PartitionSpec`, which also
    normalises a sequence of one name to the name and an empty one to
    None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if not e else e[0] if len(e) == 1 else tuple(e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _rules(cfg, n_model: int):
    """Sharding rules, HEAD-GRANULARITY AWARE: a projection's head axis is
    sharded over `model` only when the head count divides the axis size
    (sub-head sharding would need per-layer activation all-gathers)."""
    q_ok = cfg is None or cfg.n_heads % n_model == 0
    kv_ok = cfg is None or cfg.n_kv_heads % n_model == 0
    # SSM head-parallel guard: shard the d_inner / dt-head axes over
    # `model` only at whole-head granularity
    ssm_nh = 0
    if cfg is not None and cfg.ssm_state:
        ssm_nh = (cfg.ssm_expand * cfg.d_model) // cfg.ssm_head_dim
    ssm_ok = ssm_nh > 0 and ssm_nh % n_model == 0
    return [
        # --- embeddings / heads ---
        (r"embed/embed$", ("model", "data")),          # (V, d) or (ncb, V, d)
        (r"embed/head$", ("data", "model")),           # (d, V) or (ncb, d, V)
        (r"embed/img_proj$", (None, "data")),
        # --- attention ---
        (r"attn/wq$", ("data", "model" if q_ok else None)),
        (r"attn/w[kv]$", ("data", "model" if kv_ok else None)),
        (r"attn/wo$", ("model" if q_ok else None, "data")),
        (r"attn/bq$", ("model" if q_ok else None,)),
        (r"attn/b[kv]$", ("model" if kv_ok else None,)),
        (r"attn/(q|k)_norm$", (None,)),
        # --- MoE experts (leading E dim -> model = expert parallelism) ---
        (r"ffn/router$", (None, None)),                # replicated
        (r"ffn/w[gu]$", ("model", "data", None)),      # (E, d, ff)
        (r"ffn/wd$", ("model", None, "data")),         # (E, ff, d)
        # --- dense MLP (also arctic's ffn/dense/*) ---
        (r"w_gate$|w_up$", ("data", "model")),
        (r"w_down$", ("model", "data")),
        # --- RWKV time-mix: FSDP over data ---
        (r"rwkv/w[rkvgo]$", ("data", None)),
        (r"rwkv/cm_k$", ("data", "model")),
        (r"rwkv/cm_v$", ("model", "data")),
        (r"rwkv/w_[ab]$", (None, None)),
        # --- Mamba2 (head-parallel TP when heads divide the model axis) ---
        (r"ssm/in_[zx]$", ("data", "model" if ssm_ok else None)),
        (r"ssm/in_dt$", ("data", "model" if ssm_ok else None)),
        (r"ssm/in_bc$", ("data", None)),
        (r"ssm/out_proj$", ("model" if ssm_ok else None, "data")),
        (r"ssm/conv_x$", (None, "model" if ssm_ok else None)),
        (r"ssm/conv_xb$", ("model" if ssm_ok else None,)),
        (r"ssm/norm$", ("model" if ssm_ok else None,)),
        (r"ssm/(A_log|D|dt_bias)$", ("model" if ssm_ok else None,)),
        (r"ssm/conv_bc", None),  # replicate (tiny)
    ]


def _spec_for(rules, path: str, ndim: int):
    for pat, spec in rules:
        if re.search(pat, path):
            if spec is None:
                return P()
            pad = ndim - len(spec)
            if pad < 0:  # rank-1 leaf matched a rank-2 rule (e.g. scalars)
                return P()
            return P(*([None] * pad + list(spec)))
    return P()  # norms, scalars, biases: replicated


def ref_path(name: str):
    """A port parameter name (`layers.3.attn.wq`) -> (the reference's
    path `layers/attn/wq`, its number of stacked block dims)."""
    parts = name.split(".")
    keys = [q for q in parts if not q.isdigit()]
    return "/".join(keys), len(parts) - len(keys)


def _unstack(spec, n_lead: int, what: str):
    """The reference's spec of a stack -> one block's: drops the leading
    `n_lead` entries, which must be None."""
    if not spec:
        return P()
    if any(e is not None for e in spec[:n_lead]):
        raise ValueError(f"{what}: spec {spec} shards a stacked block dim")
    return P(*spec[n_lead:])


def _stacked_shapes(named: dict) -> dict:
    """Port names -> (reference path, the reference leaf's stacked shape,
    number of stacked dims): a stack's lead is one past each block
    index's largest value among the names of that path."""
    lead: dict = {}
    for name in named:
        idx = tuple(int(q) for q in name.split(".") if q.isdigit())
        path, _ = ref_path(name)
        lead[path] = tuple(max(a, b + 1) for a, b in zip(
            lead.get(path, (0,) * len(idx)), idx))
    return {name: (ref_path(name)[0], lead[ref_path(name)[0]]
                   + tuple(t.shape), ref_path(name)[1])
            for name, t in named.items()}


def param_shardings(mesh, params, cfg=None) -> dict:
    """A port module -> {name: PartitionSpec} of each tensor's own dims,
    the reference's `_spec_for` at the stacked path."""
    rules = _rules(cfg, mesh_shape(mesh).get("model", 1))
    out = {}
    for name, (path, shape, n_lead) in _stacked_shapes(
            dict(params.named_parameters())).items():
        out[name] = _unstack(_spec_for(rules, path, len(shape)), n_lead,
                             name)
    return out


def state_shardings(mesh, opt_state, params, param_specs) -> dict:
    """Optimizer state specs, as the reference derives them: a moment
    shards like the first parameter of its (stacked) shape in the
    reference's leaf order (paths sorted); an Adafactor row / column
    factor inherits the reduced spec of the first parameter it reduces;
    scalars are replicated. Returns the state's tree with a spec for each
    tensor (AdamW's per-tensor moments in the parameters' order;
    Adafactor's stacked factors a stack) and P() for the step count."""
    named = dict(params.named_parameters())
    stacked = _stacked_shapes(named)
    first = sorted(named, key=lambda n: stacked[n][0].split("/"))
    shape_to_spec: dict = {}
    for name in first:
        path, shape, n_lead = stacked[name]
        spec = P(*([None] * n_lead + list(param_specs[name]))) \
            if param_specs[name] else P()
        shape_to_spec.setdefault(shape, spec)

    def spec_of(shape):
        spec = shape_to_spec.get(shape)
        if spec is None and len(shape) >= 1:
            for pshape, pspec in shape_to_spec.items():
                if shape == pshape[:-1] and len(pspec) >= 2:
                    return P(*pspec[:-1])
                if shape == pshape[:-2] + pshape[-1:] and len(pspec) >= 2:
                    return P(*(list(pspec[:-2]) + [pspec[-1]]))
        return spec if spec is not None else P()

    out = {}
    for key, value in opt_state.items():
        if key in ("m", "v"):     # one moment a tensor, params' order
            out[key] = [_unstack(spec_of(stacked[n][1]), stacked[n][2], n)
                        for n in named]
        elif key == "f":          # Adafactor: one dict of factors a stack
            out[key] = {k: {n: spec_of(tuple(t.shape))
                            for n, t in fac.items()}
                        for k, fac in value.items()}
        else:
            out[key] = P()
    return out


def data_shardings(mesh, batch_axes_, batch: dict) -> dict:
    """Shard batch dim 0 over batch_axes_, everything else replicated."""
    def f(leaf):
        if leaf.dim() >= 1 and batch_axes_:
            return P(batch_axes_, *([None] * (leaf.dim() - 1)))
        return P()
    return {k: f(v) for k, v in batch.items()}


def _axes_size(shape: dict, axes) -> int:
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def cache_shardings(mesh, cache, batch_axes_, seq_axis_name="model"):
    """Decode-cache specs, the cache's tree with a spec a tensor.

    KV caches (B, S, KV, hd): batch over batch_axes_ when divisible,
    sequence dim over `model` (long caches spread over the model axis).
    SSM/RWKV states (B, ...): batch over batch_axes_ only. Paths and
    stacked shapes are the reference's (list indices are its stacked
    dims)."""
    mshape = mesh_shape(mesh)
    # batch-dim position measured from the END of the shape, by leaf path
    state_batch_from_end = [
        (r"state/s$", 4),            # (L, B, nh, K, V)
        (r"state/last_(tm|cm)$", 2),  # (L, B, d)
        (r"/h$", 4),                 # mamba (.., B, nh, hd, ds)
        (r"/conv$", 3),              # mamba (.., B, K-1, C)
    ]

    def spec(path_s, shape):
        nd = len(shape)
        if path_s.endswith("/pos") or nd < 2:
            return P()
        if re.search(r"(kv|attn_kv|self_kv|cross_kv)/(k|v)$", path_s):
            n_lead = nd - 4  # stacked layer dims
            b_ok = bool(batch_axes_) and shape[n_lead] % _axes_size(
                mshape, batch_axes_) == 0
            seq = shape[n_lead + 1]
            seq_ok = seq % mshape[seq_axis_name] == 0 \
                and seq >= 2 * mshape[seq_axis_name]
            return P(*([None] * n_lead
                       + [batch_axes_ if b_ok else None]
                       + [seq_axis_name if seq_ok else None, None, None]))
        for pat, from_end in state_batch_from_end:
            if re.search(pat, path_s) and batch_axes_:
                bpos = nd - from_end
                if bpos >= 0 and shape[bpos] % _axes_size(
                        mshape, batch_axes_) == 0:
                    out = [None] * nd
                    out[bpos] = batch_axes_
                    return P(*out)
        return P()

    def walk(node, keys, lead):
        if isinstance(node, dict):
            return {k: walk(v, keys + [k], lead) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, keys, lead + (len(node),)) for v in node]
        path = "/".join(keys)
        return _unstack(spec(path, lead + tuple(node.shape)), len(lead),
                        path)
    return walk(cache, [], ())


def placements(spec, mesh) -> list:
    """A spec -> DTensor placements on `mesh`, one a mesh dim: Shard(d)
    on each mesh axis that tensor dim d names, Replicate elsewhere. A
    dim over several axes names them in the mesh's order (first major),
    as DTensor shards it."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a is not None)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {tuple(names)}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return out


# ---------------------------------------------------------------------------
# a model's pieces
# ---------------------------------------------------------------------------

def leaf_split(t) -> dict:
    """{dim: mesh axis} over which a leaf of `shard_params` is split
    ({} for a whole leaf)."""
    return getattr(t, "mesh_split", None) or {}


def shard_params(params, mesh, cfg=None, *, names=None,
                 axes=("data", "model")):
    """A copy of `params` that holds this rank's piece of each leaf: on
    each dim whose spec names one of `axes` (of more than one rank), the
    1/n slice at this rank's index along that axis. `names` limits the
    cut to those leaves; the others are shared with `params`. Each cut
    leaf carries its {dim: axis} as `mesh_split` (read by `leaf_split`,
    the layers, the train step and the optimizer)."""
    from repro_torch.models.common import with_leaves
    shape = mesh_shape(mesh)
    specs = param_shardings(mesh, params, cfg)
    leaves, splits = {}, {}
    for name, t in params.named_parameters():
        leaves[name] = t
        if names is not None and name not in names:
            continue
        split = {}
        for d, entry in enumerate(specs[name]):
            if isinstance(entry, tuple):
                raise ValueError(f"{name}: spec {specs[name]} puts one dim "
                                 "over several axes")
            if entry in axes and shape.get(entry, 1) > 1:
                split[d] = entry
        if not split:
            continue
        piece = t.detach()
        for d, a in split.items():
            n = shape[a]
            if piece.shape[d] % n:
                raise ValueError(f"{name}: dim {d} of {tuple(t.shape)} does "
                                 f"not split over {n} ranks of {a}")
            size = piece.shape[d] // n
            piece = piece.narrow(d, mesh.get_local_rank(a) * size, size)
        leaves[name] = piece.clone()
        splits[name] = split
    out = with_leaves(params, leaves)
    for name, t in out.named_parameters():
        if name in splits:
            t.mesh_split = splits[name]
    return out


def gather_tensor(t, mesh, split: dict):
    """The whole tensor of a piece split over {dim: axis} (no grad)."""
    for d, a in sorted(split.items()):
        t = all_gather_over(t.detach(), mesh, a, d)
    return t


def gather_params(params, mesh):
    """The inverse of `shard_params`: a module of `params`' structure
    whose leaves are whole on every rank (uncut leaves are shared)."""
    from repro_torch.models.common import with_leaves
    return with_leaves(params, {
        n: gather_tensor(t, mesh, leaf_split(t)) if leaf_split(t) else t
        for n, t in params.named_parameters()})


def shard_tree(tree, specs, mesh):
    """A tree of whole tensors (a cache) -> this rank's pieces under its
    tree of specs (`cache_shardings`): each dim cut at this rank's index
    over the axes it names (several axes: the first major, as
    `batch_shard`). A dim cut over `model` is marked in the piece's
    `mesh_split`, as the sharded step's own caches are."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shard_tree(v, s, mesh) for v, s in zip(tree, specs)]
    t, split = tree, {}
    for d, entry in enumerate(specs):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        i, n = batch_shard(mesh, axes)
        if n > 1:
            t = t.narrow(d, i * (t.shape[d] // n), t.shape[d] // n)
            if axes == ("model",):
                split[d] = "model"
    t = t.clone()
    if split:
        t.mesh_split = split
    return t


def split_factor(t, mesh) -> int:
    """How many pieces the whole leaf of `t` has over the mesh."""
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in leaf_split(t).values())
