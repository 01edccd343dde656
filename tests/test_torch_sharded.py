"""The port's sharded step (`rules.shard_params`, the models' `lay=`
paths, the sharded train / prefill / serve steps) against the unsharded
port and the JAX reference's `mesh=None` results, on the CPU.

One spawn a world size (2 and 4 gloo ranks, one process a rank,
rendezvous through a FileStore in tmp_path, a 60 s collective timeout
and a join limit) runs every case: smoke configs in fp32, their widths
chosen so that each layout arises (q and kv heads split, kv heads whole,
q heads whole, biases, softcaps with local / global layers, cross-
attention, codebooks, the MoE's sequence-split expert region and g_major
kv gather, RWKV's FSDP-only time-mix, the hybrid's head-parallel
Mamba2). Each rank checks that it holds only its piece of every leaf,
runs the sharded prefill, a decode step against its cache and one SGD
train step (the update is the gradient itself), and gathers what came
out; two cases also take one Adafactor step (its row / column factors
and clip over a split leaf's groups). Rank 0 also runs the same steps
unsharded. The ranks import neither JAX nor the reference: the parent
runs the reference's `mesh=None` steps (one jit a case) while they run.

Tolerances, of each tensor's largest magnitude (fp32): the sharded
results against the unsharded port's within SHARD_TOL (partial sums over
ranks add in another order); both against the reference's within
REF_TOL. Adafactor's step on a 1-D leaf is g / |g| elementwise (its
second moment is g^2 on the first step), which turns fp32 noise in tiny
gradients into steps of up to lr: its comparison holds the leaves of two
or more dims, whose factored moments do not.
"""
import multiprocessing
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import constant, make_optimizer  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402

PG_TIMEOUT = 60.0   # seconds, every collective of a spawned group
JOIN_S = 150.0      # seconds, all ranks of one spawn
B, S, CACHE = 4, 16, 20   # batch, prompt, cache length (decode at t = S)
LR = 1e-2
SHARD_TOL = 2e-5    # sharded vs unsharded port, of max |x|
REF_TOL = 2e-4      # port vs reference, of max |x|

# name -> (arch, config overrides, {world: (data, model)})
CASES = {
    "dense": ("llama3-8b", {}, {2: (1, 2), 4: (2, 2)}),
    "kv_whole": ("llama3-8b", {}, {4: (1, 4)}),
    "q_whole": ("command-r-plus-104b", {}, {4: (1, 4)}),
    "bias": ("qwen2.5-3b", {}, {2: (2, 1), 4: (2, 2)}),
    "softcap": ("gemma2-27b", {}, {2: (1, 2), 4: (1, 4)}),
    "vlm": ("llama-3.2-vision-11b", {}, {2: (1, 2), 4: (2, 2)}),
    "audio": ("musicgen-medium", {}, {2: (1, 2), 4: (1, 4)}),
    "moe": ("qwen3-moe-235b-a22b", {"capacity_factor": 8.0},
            {2: (1, 2), 4: (2, 2)}),
    "rwkv": ("rwkv6-3b", {}, {2: (1, 2), 4: (2, 2)}),
    "hybrid": ("zamba2-7b", {}, {2: (1, 2), 4: (1, 4)}),
}


# cases whose train step also runs Adafactor (its factors of a split leaf)
ADAFACTOR = ("dense", "moe")


def case_cfg(name):
    arch, over, _ = CASES[name]
    return get_smoke(arch).replace(dtype="float32", **over)


def case_inputs(name, seed=0):
    cfg = case_cfg(name)
    rng = np.random.default_rng(seed)
    tail = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    toks = rng.integers(0, cfg.vocab, (B, S + 2) + tail).astype(np.int32)
    out = {"prompt": toks[:, :S], "next": toks[:, S:S + 1],
           "tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
    if cfg.d_vision:
        out["img_emb"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_vision)).astype(np.float32)
    return out


def draw(cfg):
    return ttf.init_params(cfg, torch.Generator().manual_seed(0))


from _torch_threads import one_thread as _one_thread  # noqa: E402,F401


# ---------------------------------------------------------------------------
# spawned ranks
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy().copy()


def _gather_batch(t, mesh):
    if tmesh.mesh_shape(mesh).get("data", 1) > 1:
        return tmesh.all_gather_over(t.contiguous(), mesh, "data", 0)
    return t


def _whole(t, mesh):
    """A rank's piece of logits or a cache tensor -> the whole, numpy."""
    t = trules.gather_tensor(t, mesh, trules.leaf_split(t))
    return _np(_gather_batch(t, mesh) if t.dim() >= 2 else t)


def _whole_logits(t, cfg, mesh):
    if t.shape[-1] < cfg.vocab:
        t = tmesh.all_gather_over(t.contiguous(), mesh, "model", t.dim() - 1)
    return _np(_gather_batch(t, mesh))


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree(v, fn) for v in node]
    return fn(node)


def _train(cfg, params, batch, mesh, opt_name):
    """One train step of `opt_name` on `params` (updated in place);
    returns the loss."""
    kw = dict(mesh=mesh, batch_axes=("data",) if mesh is not None else ())
    opt = make_optimizer(opt_name)
    state = opt.init(dict(params.named_parameters()))
    train = tsteps.make_train_step(cfg, opt, constant(LR), **kw)
    tb = {k: batch[k] for k in ("tokens", "labels", "img_emb") if k in batch}
    return float(train(params, state, tb))


def _steps(cfg, params, batch, mesh):
    """(prefill logits, its cache, decode logits, decode cache, train
    loss, updated parameters), each as this rank holds it; `batch` whole
    (the steps take this rank's shard)."""
    kw = dict(mesh=mesh, batch_axes=("data",) if mesh is not None else ())
    pre = tsteps.make_prefill_step(cfg, cache_len=CACHE, **kw)
    serve = tsteps.make_serve_step(cfg, **kw)
    with torch.no_grad():
        b = {"tokens": batch["prompt"]}
        if "img_emb" in batch:
            b["img_emb"] = batch["img_emb"]
        logits, cache = pre(params, b)
        p_logits = logits.clone()
        p_cache = _tree(cache, lambda t: t.clone())
        for a, c in zip(_leaves(p_cache), _leaves(cache)):
            if trules.leaf_split(c):
                a.mesh_split = c.mesh_split
        d_logits, d_cache = serve(params, {"tokens": batch["next"],
                                           "cache": cache, "t": S})
    loss = _train(cfg, params, batch, mesh, "sgd")
    return p_logits, p_cache, d_logits, d_cache, loss, params


def _leaves(node):
    if isinstance(node, dict):
        return [x for v in node.values() for x in _leaves(v)]
    if isinstance(node, (list, tuple)):
        return [x for v in node for x in _leaves(v)]
    return [node]


def _expected_piece(t_full, spec, mesh):
    shape = list(t_full.shape)
    sizes = tmesh.mesh_shape(mesh)
    for d, a in enumerate(spec):
        if a is not None and sizes.get(a, 1) > 1:
            shape[d] //= sizes[a]
    return tuple(shape)


def _case(name, world, inputs, rank):
    cfg = case_cfg(name)
    data, model = CASES[name][2][world]
    mesh = tmesh.make_host_mesh(data, model, "cpu")
    full = draw(cfg)
    specs = trules.param_shardings(mesh, full, cfg)
    local = trules.shard_params(full, mesh, cfg)
    named = dict(local.named_parameters())
    pieces_ok = all(tuple(named[n].shape) == _expected_piece(t, specs[n],
                                                             mesh)
                    for n, t in full.named_parameters())
    batch = {k: torch.as_tensor(v) for k, v in inputs.items()}
    pl, pc, dl, dc, loss, params = _steps(cfg, local, batch, mesh)
    out = {"pieces_ok": pieces_ok,
           "n_params": tsteps.count_params(local, mesh),
           "prefill": _whole_logits(pl, cfg, mesh),
           "prefill_cache": _tree(pc, lambda t: _whole(t, mesh)),
           "decode": _whole_logits(dl, cfg, mesh),
           "decode_cache": _tree(dc, lambda t: _whole(t, mesh)),
           "loss": loss,
           "params": {n: _np(t) for n, t in trules.gather_params(
               params, mesh).named_parameters()}}
    if name in ADAFACTOR:   # factors and clip over the split dims' groups
        local = trules.shard_params(draw(cfg), mesh, cfg)
        _train(cfg, local, batch, mesh, "adafactor")
        out["adafactor"] = {n: _np(t) for n, t in trules.gather_params(
            local, mesh).named_parameters()}
    if rank == 0:   # the same steps unsharded, on this rank alone
        pl, pc, dl, dc, loss, params = _steps(cfg, draw(cfg), batch, None)
        out["single"] = {
            "prefill": _np(pl), "prefill_cache": _tree(pc, _np),
            "decode": _np(dl), "decode_cache": _tree(dc, _np),
            "loss": loss,
            "params": {n: _np(t) for n, t in params.named_parameters()}}
        if name in ADAFACTOR:
            params = draw(cfg)
            _train(cfg, params, batch, None, "adafactor")
            out["single"]["adafactor"] = {
                n: _np(t) for n, t in params.named_parameters()}
    return out


def _rank_main(rank, world, store_path, arg_path, out_path):
    torch.set_num_threads(1)
    tmesh.init_world("cpu", rank=rank, world_size=world,
                     store=dist.FileStore(store_path, world),
                     timeout=PG_TIMEOUT)
    try:
        with open(arg_path, "rb") as f:
            args = pickle.load(f)
        out = {name: _case(name, world, args[name], rank)
               for name, (_, _, worlds) in CASES.items() if world in worlds}
        if rank:
            out = {n: {k: v for k, v in o.items() if k in (
                "pieces_ok", "n_params", "loss")} for n, o in out.items()}
        with open(f"{out_path}.{rank}", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(tmp_path, world):
    """Starts the world's ranks; returns a function that joins them and
    gives their results, rank by rank."""
    ctx = multiprocessing.get_context("spawn")
    arg_path, out_path = tmp_path / "args", tmp_path / "out"
    with open(arg_path, "wb") as f:
        pickle.dump({n: case_inputs(n) for n in CASES}, f)
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, str(tmp_path / "store"), str(arg_path), str(out_path)))
        for r in range(world)]
    for p in procs:
        p.start()

    def join():
        for p in procs:
            p.join(JOIN_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        assert not hung, f"world {world}: ranks {hung} still running"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"world {world}: exit codes {codes}"
        out = []
        for r in range(world):
            with open(f"{out_path}.{r}", "rb") as f:
                out.append(pickle.load(f))
        return out
    return join


# ---------------------------------------------------------------------------
# the runs: both worlds spawned first, the reference meanwhile
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def started(tmp_path_factory):
    return {w: spawn(tmp_path_factory.mktemp(f"world{w}"), w)
            for w in (2, 4)}


def _stacked(c):
    """The port's cache (lists of per-layer dicts, numpy) -> the
    reference's layout, the layers stacked on leading axes."""
    if isinstance(c, dict):
        return {k: _stacked(v) for k, v in c.items()}
    if isinstance(c, list):
        items = [_stacked(x) for x in c]
        if isinstance(items[0], dict):
            return {k: np.stack([i[k] for i in items]) for k in items[0]}
        return np.stack(items)
    return c


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def reference(started):
    """The reference's mesh=None prefill, decode and SGD step of every
    case, from the port's draws (`params_to_jax`), as numpy."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke as jget_smoke
    from repro.launch import steps as jsteps
    from repro.models import transformer as jtf
    from repro.models.common import cross_entropy as jxent

    def jit(fn):
        return jax.jit(fn, compiler_options={
            "xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True,
            "xla_cpu_use_fusion_emitters": False})
    out = {}
    for name, (arch, over, _) in CASES.items():
        cfg = case_cfg(name)
        jcfg = jget_smoke(arch).replace(dtype="float32", **over)
        p = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                         ttf.params_to_jax(cfg, draw(cfg)))
        a = {k: jnp.asarray(v) for k, v in case_inputs(name).items()}
        img = a.get("img_emb")

        def loss_fn(p, b):
            logits, extra = jtf.forward(p, jcfg, b["tokens"], mode="train",
                                        img_emb=b.get("img_emb"))
            loss = jxent(logits, b["labels"], jcfg.final_logit_softcap)
            return loss + 0.01 * extra if jcfg.n_experts else loss

        @jit
        def run(p, a):
            pre = jsteps.make_prefill_step(jcfg, cache_len=CACHE)(
                p, {"tokens": a["prompt"], "img_emb": img})
            dec = jsteps.make_serve_step(jcfg)(p, {
                "tokens": a["next"], "cache": pre[1], "t": jnp.int32(S)})
            b = {"tokens": a["tokens"], "labels": a["labels"]}
            if img is not None:
                b["img_emb"] = img
            loss, g = jax.value_and_grad(loss_fn)(p, b)
            new = jax.tree.map(lambda w, d: w - jnp.float32(LR) * d, p, g)
            return pre[0], pre[1], dec[0], dec[1], loss, new
        pl, pc, dl, dc, loss, new = jax.tree.map(np.asarray, run(p, a))
        out[name] = {"prefill": pl, "prefill_cache": _flat(pc),
                     "decode": dl, "decode_cache": _flat(dc),
                     "loss": float(loss), "params": _flat(new)}
    return out


@pytest.fixture(scope="module")
def runs(started, reference):
    return {w: join() for w, join in started.items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want))
                                               + 1e-30))


def _as_ref(name, res):
    """A run's results in the reference's layout (caches stacked, the
    parameters as `params_to_jax` names them)."""
    cfg = case_cfg(name)
    model = draw(cfg)
    with torch.no_grad():
        for n, t in model.named_parameters():
            t.copy_(torch.as_tensor(res["params"][n]))
    return {"prefill": res["prefill"], "decode": res["decode"],
            "prefill_cache": _flat(_stacked(res["prefill_cache"])),
            "decode_cache": _flat(_stacked(res["decode_cache"])),
            "loss": res["loss"],
            "params": _flat(ttf.params_to_jax(cfg, model))}


def _hold(got, want, tol, what):
    for key in ("prefill", "decode"):
        assert _rel(got[key], want[key]) < tol, (what, key)
    for key in ("prefill_cache", "decode_cache", "params"):
        assert sorted(got[key]) == sorted(want[key]), (what, key)
        for k, w in want[key].items():
            if w.dtype.kind == "f":
                assert _rel(got[key][k], w) < tol, (what, key, k)
            else:
                np.testing.assert_array_equal(got[key][k], w,
                                              err_msg=f"{what} {key} {k}")
    assert abs(got["loss"] - want["loss"]) <= tol * abs(want["loss"]), what


WORLD_CASES = [(w, n) for n, (_, _, ws) in CASES.items() for w in sorted(ws)]


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_ranks_hold_their_pieces(runs, world, name):
    """Every rank's leaves have their spec's piece shapes, and the
    pieces count the whole model's parameters."""
    n = sum(t.numel() for t in draw(case_cfg(name)).parameters())
    for r in runs[world]:
        assert r[name]["pieces_ok"]
        assert r[name]["n_params"] == n


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_sharded_steps_equal_unsharded_port(runs, world, name):
    """Prefill logits and cache, a decode step's logits and cache, the
    train step's loss (equal on every rank) and updated parameters,
    gathered, against the same steps unsharded."""
    got = runs[world][0][name]
    _hold(_as_ref(name, got), _as_ref(name, got["single"]), SHARD_TOL,
          (world, name))
    for r in runs[world]:
        assert abs(r[name]["loss"] - got["loss"]) <= 1e-6 * got["loss"]


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_sharded_steps_equal_reference(runs, reference, world, name):
    """The same gathered results against the reference's mesh=None
    steps, and the unsharded port's too."""
    got = runs[world][0][name]
    _hold(_as_ref(name, got), reference[name], REF_TOL, (world, name))
    _hold(_as_ref(name, got["single"]), reference[name], REF_TOL,
          ("single", name))


@pytest.mark.parametrize("world,name", [(w, n) for w, n in WORLD_CASES
                                        if n in ADAFACTOR])
def test_sharded_adafactor_equals_unsharded(runs, world, name):
    got = runs[world][0][name]
    want = got["single"]["adafactor"]
    assert sorted(got["adafactor"]) == sorted(want)
    for k, w in want.items():
        if w.ndim >= 2:
            assert _rel(got["adafactor"][k], w) < SHARD_TOL, (world, name, k)
