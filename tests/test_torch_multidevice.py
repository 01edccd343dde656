"""The port's multi-device runtime against the JAX reference, on the CPU.

Meshes, sharding rules (specs for every architecture's full config at
model axes of 1, 2 and 16), FedPAE's pod ring exchange and ensemble
vote, the MoE's expert-parallel branch and sharded train steps. The
multi-rank cases spawn 2 or 4 ranks on gloo (one process a rank,
rendezvous through a FileStore in the test's tmp_path, so no port is
fixed); every group has a 60 s collective timeout and every rank a join
limit, so a hung collective fails its case. The spawned ranks import
neither JAX nor the reference: the parent draws the reference's
parameters and inputs (numpy), hands them over, and holds what comes
back against the reference's own results and the single-process port.

JAX is imported inside the `ref` fixture only, so that the ranks, which
import this module, do not load it.
"""
import multiprocessing
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config, get_smoke, list_archs  # noqa: E402
from repro_torch.launch import fedpae_pods  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.common import Params, with_leaves  # noqa: E402
from repro_torch.optim import constant, make_optimizer  # noqa: E402
from repro_torch.optim.optimizers import Optimizer  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PG_TIMEOUT = 60.0   # seconds, every collective of a spawned group
JOIN_S = 120.0      # seconds, all ranks of one spawn
S = 16
MOE = "qwen3-moe-235b-a22b"
LR = 1e-2
ADAMW_GRAD_FLOOR = 1e-4   # of a leaf's largest |gradient|, see the test


from _torch_threads import one_thread as _one_thread  # noqa: E402,F401


# ---------------------------------------------------------------------------
# spawned ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, world, store_path, job, arg_path, out_path):
    torch.set_num_threads(1)
    tmesh.init_world("cpu", rank=rank, world_size=world,
                     store=dist.FileStore(store_path, world),
                     timeout=PG_TIMEOUT)
    try:
        with open(arg_path, "rb") as f:
            args = pickle.load(f)
        out = JOBS[job](rank, world, args)
        with open(f"{out_path}.{rank}", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, job, world, args):
    """Runs JOBS[job](rank, world, args) on `world` spawned gloo ranks;
    returns their results, rank by rank."""
    ctx = multiprocessing.get_context("spawn")
    arg_path, out_path = tmp_path / f"{job}.args", tmp_path / f"{job}.out"
    with open(arg_path, "wb") as f:
        pickle.dump(args, f)
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, str(tmp_path / f"{job}.store"), job, str(arg_path),
        str(out_path))) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"{job}: ranks {hung} still running after {JOIN_S} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"{job}: exit codes {codes}"
    out = []
    for r in range(world):
        with open(f"{out_path}.{r}", "rb") as f:
            out.append(pickle.load(f))
    return out


def _np(t):
    return t.detach().cpu().numpy()


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _pods(rank, world, a, mesh):
    """This pod's member through one exchange and the vote of each
    chromosome."""
    cfg = get_smoke("llama3-8b").replace(dtype="float32")
    p = mesh.get_local_rank("pod")
    members = [ttf.params_from_jax(cfg, m) for m in a["members"]]
    got = fedpae_pods.pod_ring_exchange(members[p], mesh)
    want = dict(members[(p - 1) % 2].named_parameters())
    same = all(torch.equal(t, want[n]) and t.dtype == want[n].dtype
               for n, t in got.named_parameters())
    step = fedpae_pods.make_ensemble_serve_step(cfg, mesh)
    toks = torch.as_tensor(a["tokens"])
    with torch.no_grad():
        votes = [_np(step(members[p], float(c[p]), toks))
                 for c in a["chromosomes"]]
    return {"exchanged": same, "votes": votes}


def _gathered(params, cfg, mesh, leaves):
    """`leaves` ({name: tensor} of `params`' structure) with the expert
    leaves gathered whole over `model`, as numpy."""
    full = tmoe.gather_experts(with_leaves(params, leaves), cfg, mesh)
    return {n: _np(full.get(n, t)) for n, t in leaves.items()}


def _tee(grads: dict, named: dict):
    """An optimizer for one train step that records the gradients it is
    handed, then applies them with adafactor and with adamw to two copies
    of the parameters (passing the step's `split` on); returns it and
    {optimizer name: the copy it updates}."""
    copies = {n: {k: t.detach().clone() for k, t in named.items()}
              for n in ("adafactor", "adamw")}
    opts = {n: make_optimizer(n) for n in copies}
    states = {n: opts[n].init(copies[n]) for n in copies}

    def update(g, s, p, lr, split=None):
        grads.update({k: v.detach().clone() for k, v in g.items()})
        for n in copies:
            opts[n].update(g, states[n], copies[n], lr, split=split)
    return Optimizer("tee", lambda p: {"step": 0}, update), copies


def _moe(rank, world, a, mesh):
    """The expert-parallel layer: no drops (loss and gradients summed over
    the batch shards) and with drops (this rank's output shard)."""
    out = {"shard": tmesh.batch_shard(mesh, ("data",))}
    for cf, key in ((8.0, "nodrop"), (1.0, "drops")):
        cfg = get_smoke(MOE).replace(dtype="float32", n_experts=8,
                                     capacity_factor=cf)
        whole = Params({"ffn": Params({k: torch.as_tensor(v) for k, v in
                                       a["layer"].items()})})
        local = tmoe.local_experts(whole, cfg, mesh)
        i, n = out["shard"]
        x = torch.as_tensor(a["x"]).chunk(n)[i]
        y = tmoe.moe_ffn(local["ffn"], cfg, x, mesh=mesh)
        if key == "drops":
            out[key] = _np(y)
            continue
        loss = torch.sum(y ** 2)
        names = [k for k, _ in local.named_parameters()]
        grads = torch.autograd.grad(loss, list(local.parameters()))
        loss = tmesh.all_reduce_over(loss.detach().clone(), mesh, ("data",))
        grads = {k: tmesh.all_reduce_over(g.contiguous(), mesh, ("data",))
                 for k, g in zip(names, grads)}
        out[key] = {"loss": float(loss),
                    "grads": _gathered(local, cfg, mesh, grads)}
    return out


def _train(rank, world, a, mesh):
    """One sharded train step: the loss, the gathered gradients, and the
    gathered parameters after an adafactor and an adamw update."""
    cfg = train_cfg()
    batch = {k: torch.as_tensor(v) for k, v in a["batch"].items()}
    params = tmoe.local_experts(ttf.params_from_jax(cfg, a["params"]), cfg,
                                mesh)
    grads = {}
    opt, copies = _tee(grads, dict(params.named_parameters()))
    step = tsteps.make_train_step(cfg, opt, constant(LR), mesh=mesh,
                                  batch_axes=("data",))
    loss = float(step(params, {"step": 0}, batch))
    out = {"loss": loss, "n_params": tsteps.count_params(params, mesh)}
    for name, leaves in dict(copies, record=grads).items():
        out[name] = _gathered(params, cfg, mesh, leaves)
    return out


def _job_world2(rank, world, a):
    mesh = _mesh((2, 1, 1), ("pod", "data", "model"))
    out = {"pods": _pods(rank, world, a, mesh)}
    try:
        tmesh.make_host_mesh(2, 2, device="cpu")
    except ValueError as e:
        out["small_world"] = str(e)
    try:
        tmesh._mesh("cuda", (2, 1), ("data", "model"))
    except RuntimeError as e:
        out["cuda_on_gloo"] = str(e)
    return out


def _job_world4(rank, world, a):
    return {
        "pods": _pods(rank, world, a, _mesh((2, 1, 2),
                                            ("pod", "data", "model"))),
        "moe": _moe(rank, world, a, tmesh.make_host_mesh(2, 2, "cpu")),
        "train": _train(rank, world, a, tmesh.make_host_mesh(2, 2, "cpu"))}


JOBS = {"world2": _job_world2, "world4": _job_world4}


def train_cfg():
    return get_smoke(MOE).replace(dtype="float32", n_experts=8,
                                  capacity_factor=8.0)


# ---------------------------------------------------------------------------
# the reference, and the runs (one spawn of each world for the file)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jget_config
    from repro.configs import get_smoke as jget_smoke
    from repro.launch import mesh as jmesh
    from repro.launch import shapes as jshapes
    from repro.models import moe as jmoe
    from repro.models import transformer as jtf
    from repro.optim import make_optimizer as jmake_optimizer
    from repro.sharding import rules as jrules

    def jit(fn):
        return jax.jit(fn, compiler_options={
            "xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True,
            "xla_cpu_use_fusion_emitters": False})
    return types.SimpleNamespace(**locals())


@pytest.fixture(scope="module")
def inputs(ref):
    """The reference's parameters and the inputs every run shares."""
    jax, jnp = ref.jax, ref.jnp
    lcfg = ref.jget_smoke("llama3-8b").replace(dtype="float32")
    key = jax.random.PRNGKey(0)
    members = [jax.tree.map(np.asarray, ref.jit(
        lambda k: ref.jtf.init_params(lcfg, k))(jax.random.fold_in(key, i)))
        for i in range(2)]
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, lcfg.vocab, (2, S)).astype(np.int32)
    mcfg = ref.jget_smoke(MOE).replace(dtype="float32", n_experts=8,
                                       capacity_factor=8.0)
    layer = jax.tree.map(np.asarray, ref.jit(
        lambda k: ref.jmoe.init_moe(mcfg, k))(jax.random.PRNGKey(1)))
    x = rng.standard_normal((4, S, mcfg.d_model)).astype(np.float32)
    params = jax.tree.map(np.asarray, ref.jit(
        lambda k: ref.jtf.init_params(mcfg, k))(jax.random.PRNGKey(2)))
    toks = rng.integers(0, mcfg.vocab, (4, S + 1)).astype(np.int32)
    return {"members": members, "tokens": tokens,
            "chromosomes": [np.array([1.0, 1.0], np.float32),
                            np.array([1.0, 0.0], np.float32)],
            "layer": layer, "x": x, "params": params,
            "batch": {"tokens": toks[:, :-1], "labels": toks[:, 1:]}}


@pytest.fixture(scope="module")
def world2(inputs, tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("world2"), "world2", 2,
                  {k: inputs[k] for k in ("members", "tokens",
                                          "chromosomes")})


@pytest.fixture(scope="module")
def world4(inputs, tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("world4"), "world4", 4, inputs)


# ---------------------------------------------------------------------------
# meshes (torch's fake process group stands for 256 and 512 ranks)
# ---------------------------------------------------------------------------

class _FakeWorld:
    def __init__(self, n):
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_under_fake_world(multi_pod):
    n = 512 if multi_pod else 256
    with _FakeWorld(n):
        mesh = tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
        want = {"pod": 2, "data": 16, "model": 16} if multi_pod else {
            "data": 16, "model": 16}
        assert tmesh.mesh_shape(mesh) == want
    with _FakeWorld(4):
        with pytest.raises(ValueError, match="256"):
            tmesh.make_production_mesh(multi_pod=False, device="cpu")
        with pytest.raises(ValueError, match="512"):
            tmesh.make_production_mesh(multi_pod=True, device="cpu")


def test_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_host_mesh(1, 1, device="cpu")


def test_batch_axes_equal_the_reference(ref):
    for multi_pod in (False, True):
        shape, names = tmesh.PRODUCTION[multi_pod]
        jm = ref.AbstractMesh(shape, names)
        with _FakeWorld(int(np.prod(shape))):
            mesh = tmesh.make_production_mesh(multi_pod=multi_pod,
                                              device="cpu")
            for s in ref.jshapes.SHAPES.values():
                for b in (s.global_batch, 1, 8, 48):
                    assert tmesh.batch_axes(mesh, b) == \
                        ref.jmesh.batch_axes(jm, b), (names, b)


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

class _MetaGen(torch.Generator):
    """A generator whose draws land on the meta device (shapes only)."""
    device = torch.device("meta")


_META = {}


def _meta_params(arch):
    if arch not in _META:
        _META[arch] = ttf.init_params(get_config(arch), _MetaGen())
    return _META[arch]


def _flat_specs(tree, prefix=""):
    """{path: spec tuple} of a reference tree of NamedShardings."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.spec)
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_the_reference(ref, arch):
    """Every port parameter's spec is the reference's `_spec_for` at its
    stacked path, its block dims dropped, at model axes of 1, 2 and 16;
    and the reference's own param_shardings, as one tree, agree."""
    params = _meta_params(arch)
    jcfg = ref.jget_config(arch)
    jshape = ref.jax.eval_shape(
        lambda: ref.jtf.init_params(jcfg, ref.jax.random.PRNGKey(0)))
    for n_model in (1, 2, 16):
        with _FakeWorld(16 * n_model):
            mesh = _mesh((16, n_model), ("data", "model"))
            specs = trules.param_shardings(mesh, params, get_config(arch))
        want = _flat_specs(ref.jrules.param_shardings(
            ref.AbstractMesh((16, n_model), ("data", "model")), jshape,
            jcfg))
        rules = ref.jrules._rules(jcfg, n_model)
        for name, spec in specs.items():
            path, n_lead = trules.ref_path(name)
            full = tuple(ref.jrules._spec_for(
                rules, path, params.get_parameter(name).dim() + n_lead))
            assert tuple(spec) == full[n_lead:] if full else spec == (), \
                (arch, n_model, name, spec, full)
            assert full == want[path], (arch, n_model, name)
        assert {trules.ref_path(n)[0] for n in specs} == set(want)


def test_head_granularity_guard():
    """llama3-8b at a 16-way model axis: 8 kv heads do not divide it, so
    wk stays unsplit over model; 32 q heads do (tests/test_infra.py)."""
    cfg = get_config("llama3-8b")
    rules = trules._rules(cfg, 16)
    assert trules._spec_for(rules, "layers/attn/wk", 3) == \
        trules.P(None, "data", None)
    assert trules._spec_for(rules, "layers/attn/wq", 3) == \
        trules.P(None, "data", "model")
    with _FakeWorld(256):
        specs = trules.param_shardings(_mesh((16, 16), ("data", "model")),
                                       _meta_params("llama3-8b"), cfg)
    assert specs["layers.0.attn.wk"] == ("data", None)
    assert specs["layers.31.attn.wq"] == ("data", "model")


def _tree_specs(tree):
    """A spec tree (dicts / lists) -> {path with indices: spec}."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out[path] = tuple(node)
    walk(tree, ())
    return out


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_state_specs_equal_the_reference(ref, opt_name):
    """At smoke, every arch, on the production 16 x 16 mesh: each state
    tensor's spec is the reference's for the same leaf (its stacked
    spec, block dims dropped for AdamW's per-tensor moments)."""
    jm = ref.AbstractMesh((16, 16), ("data", "model"))
    with _FakeWorld(256):
        mesh = _mesh((16, 16), ("data", "model"))
        for arch in list_archs():
            cfg, jcfg = get_smoke(arch), ref.jget_smoke(arch)
            params = ttf.init_params(cfg, _MetaGen())
            named = dict(params.named_parameters())
            opt = make_optimizer(opt_name)
            state = opt.init(named)
            pspecs = trules.param_shardings(mesh, params, cfg)
            got = trules.state_shardings(mesh, state, params, pspecs)
            jshape = ref.jax.eval_shape(lambda: ref.jtf.init_params(
                jcfg, ref.jax.random.PRNGKey(0)))
            jopt = ref.jmake_optimizer(opt_name)
            jstate = ref.jax.eval_shape(jopt.init, jshape)
            jp = ref.jrules.param_shardings(jm, jshape, jcfg)
            want = ref.jrules.state_shardings(jm, jstate, jshape, jp)
            assert got["step"] == () and tuple(want["step"].spec) == ()
            if opt_name == "adamw":
                for key in ("m", "v"):
                    flat = _flat_specs(want[key])
                    for name, spec in zip(named, got[key]):
                        path, n_lead = trules.ref_path(name)
                        full = flat[path]
                        assert tuple(spec) == (full[n_lead:] if full
                                               else ()), (arch, name)
                continue
            flat = _flat_specs(want["f"])
            for key, fac in got["f"].items():
                path = "/".join(q for q in key.split(".") if q != "*")
                for k, spec in fac.items():
                    assert tuple(spec) == flat[f"{path}/{k}"], (arch, key)
            assert len(flat) == sum(len(f) for f in got["f"].values())


def test_data_and_cache_specs_equal_the_reference(ref):
    """At smoke, each family's decode cache and a train batch, on the
    production meshes with the batch over the reference's batch_axes
    (both a batch the axes divide and one they do not): the reference's
    specs, cache list indices as its stacked dims."""
    for multi_pod in (False, True):
        shape, names = tmesh.PRODUCTION[multi_pod]
        jm = ref.AbstractMesh(shape, names)
        with _FakeWorld(int(np.prod(shape))):
            mesh = tmesh.make_production_mesh(multi_pod=multi_pod,
                                              device="cpu")
            for arch in list_archs():
                cfg, jcfg = get_smoke(arch), ref.jget_smoke(arch)
                for B, clen in ((32, 64), (6, 16)):
                    axes = tmesh.batch_axes(mesh, B)
                    cache = ttf.init_cache(cfg, B, clen, device="meta")
                    jcache = ref.jax.eval_shape(
                        lambda: ref.jtf.init_cache(jcfg, B, clen))
                    want = ref.jrules.cache_shardings(jm, jcache, axes)
                    got = _tree_specs(trules.cache_shardings(mesh, cache,
                                                             axes))
                    flat = _flat_specs(want)
                    for path, spec in got.items():
                        keys = [p for p in path if isinstance(p, str)]
                        full = flat["/".join(keys)]
                        n_lead = len(path) - len(keys)
                        assert spec == (full[n_lead:] if full else ()), \
                            (arch, B, path, spec, full)
                    batch = {"tokens": torch.zeros((B, 8), device="meta"),
                             "t": torch.zeros((), device="meta")}
                    jb = {"tokens": ref.jax.ShapeDtypeStruct((B, 8),
                                                             np.int32),
                          "t": ref.jax.ShapeDtypeStruct((), np.int32)}
                    jd = ref.jrules.data_shardings(jm, axes, jb)
                    got_d = trules.data_shardings(mesh, axes, batch)
                    assert {k: tuple(v) for k, v in got_d.items()} == {
                        k: tuple(v.spec) for k, v in jd.items()}


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    with _FakeWorld(512):
        mesh = _mesh((2, 16, 16), ("pod", "data", "model"))
        assert trules.placements(trules.P(("pod", "data"), None, "model"),
                                 mesh) == [Shard(0), Shard(0), Shard(2)]
        assert trules.placements(trules.P(), mesh) == [Replicate()] * 3
        assert trules.placements(trules.P(None, "data"), mesh) == [
            Replicate(), Shard(1), Replicate()]
        with pytest.raises(ValueError, match="order"):
            trules.placements(trules.P(("data", "pod")), mesh)


# ---------------------------------------------------------------------------
# FedPAE's pod primitives
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def member_probs(ref, inputs):
    """Each member's last-position softmax through the reference's
    forward."""
    jax, jnp = ref.jax, ref.jnp
    cfg = ref.jget_smoke("llama3-8b").replace(dtype="float32")
    probs = ref.jit(lambda m, t: jax.nn.softmax(ref.jtf.forward(
        m, cfg, t, mode="train", last_only=True)[0].astype(jnp.float32),
        -1))
    return [np.asarray(probs(m, jnp.asarray(inputs["tokens"])))
            for m in inputs["members"]]


@pytest.mark.parametrize("world", [2, 4])
def test_pod_ring_exchange_swaps_members(world, world2, world4):
    """Every rank receives the other pod's member, bit for bit."""
    runs = world2 if world == 2 else world4
    assert all(r["pods"]["exchanged"] for r in runs)


@pytest.mark.parametrize("world", [2, 4])
def test_pod_vote_equals_host_vote(member_probs, world, world2, world4):
    """The all_reduce vote over `pod` is the reference's host mean-
    probability vote (within 1e-5) on every rank; chromosome [1, 0] gives
    member 0's softmax, the same on every rank."""
    runs = world2 if world == 2 else world4
    probs = member_probs
    want = (probs[0] + probs[1]) / 2
    for r in runs:
        vote, masked = r["pods"]["votes"]
        assert vote.shape == want.shape == (2, 1, want.shape[-1])
        np.testing.assert_allclose(vote, want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(masked, probs[0], atol=1e-5, rtol=0)
        assert np.array_equal(masked, runs[0]["pods"]["votes"][1])


def test_mesh_refusals(world2):
    """A world smaller than the mesh, and a CUDA mesh on gloo, raise."""
    r = world2[0]
    assert "needs 4 ranks" in r["small_world"]
    assert "nccl" in r["cuda_on_gloo"]


# ---------------------------------------------------------------------------
# expert-parallel MoE
# ---------------------------------------------------------------------------

def test_moe_mesh_grads_equal_reference(ref, inputs, world4):
    """(data 2, model 2), no drops: the loss and the router / expert
    gradients equal the reference's single-device value_and_grad within
    1e-4 relative (tests/test_infra.py's tolerance)."""
    jax, jnp = ref.jax, ref.jnp
    cfg = ref.jget_smoke(MOE).replace(dtype="float32", n_experts=8,
                                      capacity_factor=8.0)
    p = jax.tree.map(jnp.asarray, inputs["layer"])
    l0, g0 = ref.jit(jax.value_and_grad(lambda p, x: jnp.sum(
        ref.jmoe.moe_ffn(p, cfg, x) ** 2)))(p, jnp.asarray(inputs["x"]))
    for r in world4:
        got = r["moe"]["nodrop"]
        assert abs(got["loss"] - float(l0)) / abs(float(l0)) < 1e-4
        for k in ("router", "wg", "wu", "wd"):
            want = np.asarray(g0[k])
            err = np.max(np.abs(got["grads"][f"ffn.{k}"] - want))
            assert err / (np.max(np.abs(want)) + 1e-9) < 1e-4, k


MOE_MESH_REF = """
import sys, numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke
from repro.models import moe
d = np.load(sys.argv[1])
cfg = get_smoke("qwen3-moe-235b-a22b").replace(
    dtype="float32", n_experts=8, capacity_factor=1.0)
p = {k: jnp.asarray(d[k]) for k in ("router", "wg", "wu", "wd")}
mesh = jax.make_mesh((2, 2), ("data", "model"))
with mesh:
    out = jax.jit(lambda p, x: moe.moe_ffn(p, cfg, x, mesh=mesh,
                                           batch_axes=("data",)))(
        p, jnp.asarray(d["x"]))
single = moe.moe_ffn(p, cfg, jnp.asarray(d["x"]))
np.savez(sys.argv[2], mesh=np.asarray(out), single=np.asarray(single))
"""


def test_moe_mesh_drops_equal_reference_mesh(inputs, world4, tmp_path):
    """(data 2, model 2), capacity factor 1: each rank's capacity is of
    its own tokens, so the kept choices differ from one device's; the
    output equals the reference's own mesh branch (4 fake CPU devices)
    within 1e-5."""
    np.savez(tmp_path / "in.npz", x=inputs["x"], **inputs["layer"])
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", MOE_MESH_REF,
                           str(tmp_path / "in.npz"),
                           str(tmp_path / "out.npz")], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")
    for r in world4:
        i, n = r["moe"]["shard"]
        mine = np.split(want["mesh"], n)[i]
        np.testing.assert_allclose(r["moe"]["drops"], mine, atol=1e-5,
                                   rtol=0)
    assert np.max(np.abs(want["mesh"] - want["single"])) > 1e-3


# ---------------------------------------------------------------------------
# sharded train steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single(inputs):
    """The single-process port step from the same parameters and batch:
    the loss, the parameters before it, and, as _train gives them, the
    gradients and the parameters after each update."""
    cfg = train_cfg()
    params = ttf.params_from_jax(cfg, inputs["params"])
    p0 = {k: _np(v) for k, v in params.named_parameters()}
    grads = {}
    opt, copies = _tee(grads, dict(params.named_parameters()))
    step = tsteps.make_train_step(cfg, opt, constant(LR))
    batch = {k: torch.as_tensor(v) for k, v in inputs["batch"].items()}
    out = {"loss": float(step(params, {"step": 0}, batch)), "p0": p0,
           "experts": tmoe.expert_names(params)}
    for name, leaves in dict(copies, record=grads).items():
        out[name] = {k: _np(v) for k, v in leaves.items()}
    return out


def _rel(got, want, mask=None):
    if mask is not None:
        got, want = got[mask], want[mask]
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30)


@pytest.mark.parametrize("name", ["record", "adafactor", "adamw"])
def test_sharded_train_step_equals_single_process(single, world4, name):
    """(data 2, model 2): the global loss, and the gradients (record) or
    the parameters after one adafactor / adamw update, gathered, within
    1e-5 relative (max abs error over max abs, a leaf) of the single-
    process port's. Adafactor's clip binds on the expert stacks (its
    RMS sums over `model`); AdamW leaves out elements whose gradient is
    below ADAMW_GRAD_FLOOR of the leaf's largest: its first step is
    g / (|g| + 1e-8), which turns the reduction order's fp32 noise in
    such elements into a step of up to lr (below 1e-6 of the largest the
    whole sign flips; between 1e-6 and 1e-4 this run moves by up to 7e-5
    relative)."""
    want = single[name]
    for r in world4:
        got = r["train"]
        assert abs(got["loss"] - single["loss"]) <= 1e-5 * abs(single["loss"])
        assert set(got[name]) == set(want)
        for k, w in want.items():
            mask = None
            if name == "adamw":
                g = np.abs(single["record"][k])
                mask = g >= ADAMW_GRAD_FLOOR * g.max()
            assert _rel(got[name][k], w, mask) < 1e-5, (name, k)
    if name == "adafactor":    # the clip binds on each expert stack
        stacks = {}
        for k in single["experts"]:
            stacks.setdefault(trules.ref_path(k)[0], []).append(
                (single["p0"][k] - want[k]) / LR)
        for path, steps in stacks.items():
            rms = np.sqrt(np.mean(np.stack(steps) ** 2))
            assert abs(rms - 1.0) < 1e-3, (path, rms)


def test_sharded_param_count_is_global(world4):
    cfg = train_cfg()
    n = sum(t.numel() for t in ttf.init_params(
        cfg, torch.Generator().manual_seed(0)).parameters())
    assert all(r["train"]["n_params"] == n for r in world4)
