"""The port's training path against the JAX reference: one AdamW and one
Adafactor step (two updates, so the state is used) on the smoke dense
and hybrid trees, whose stacked leaves are (L, ...) and (n_super, every,
...); Adafactor's layer-by-layer branch; the schedules; the first smoke
losses of qwen2.5-3b at microbatches 1 and 2; the trainer's loss falls;
rwkv6-3b smoke gradients with a non-zero bonus u.

Parameters, gradients and token batches are made by the reference (or
with numpy from a seed) and carried across with `params_from_jax`, in
fp32. Optimizer steps are elementwise or reductions in fp32: held to
atol 1e-6 / rtol 1e-5. Losses and gradients pass through a whole
forward and backward, computed in another order by each framework
(the port's scans run the naive recurrence on the CPU, the reference
its chunked form): held to the tolerances stated at each test.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.common import cross_entropy as jxent  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.common import cross_entropy  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402

STEP_TOL = dict(atol=1e-6, rtol=1e-5)


def _cfgs(arch):
    return (jget_smoke(arch).replace(dtype="float32"),
            get_smoke(arch).replace(dtype="float32"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float().numpy()
    return np.asarray(leaf)


def _hold_trees(got, want, **tol):
    """got: the port's tree (`params_to_jax`); want: the reference's."""
    got = {k: _numpy(v) for k, v in _flat(got).items()}
    want = {k: _numpy(v) for k, v in _flat(want).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _grads_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), tree)


def _named(cfg, tree):
    return dict(ttf.params_from_jax(cfg, tree).named_parameters())


@pytest.mark.parametrize("arch,name,layerwise", [
    ("qwen2.5-3b", "adamw", False),
    ("zamba2-7b", "adamw", False),
    ("qwen2.5-3b", "adafactor", False),
    ("zamba2-7b", "adafactor", False),
    ("qwen2.5-3b", "adafactor", True),
    ("zamba2-7b", "adafactor", True),
])
def test_optimizer_steps_match_reference(arch, name, layerwise, monkeypatch):
    """Two updates from the reference's smoke parameters with numpy
    gradients; `layerwise` lowers both packages' layer-by-layer threshold
    to 1 KiB, so every stacked leaf of 3 or more dims is clipped a
    leading index at a time."""
    if layerwise:
        monkeypatch.setattr(jopt, "_LAYERWISE_BYTES", 1024)
        monkeypatch.setattr(topt, "_LAYERWISE_BYTES", 1024)
    jcfg, tcfg = _cfgs(arch)
    hp = {"weight_decay": 0.1} if name == "adamw" else {}
    jo, to = jopt.make_optimizer(name, **hp), topt.make_optimizer(name, **hp)
    jp = _np(jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    model = ttf.params_from_jax(tcfg, jp)
    named = dict(model.named_parameters())
    jstate, tstate = jo.init(jp), to.init(named)
    jupdate = jax.jit(jo.update)
    for step, lr in enumerate((1e-2, 3e-3)):
        g = _grads_like(jp, 10 + step)
        jp, jstate = jupdate(g, jstate, jp, jnp.float32(lr))
        to.update(_named(tcfg, g), tstate, named, lr)
    assert tstate["step"] == int(jstate["step"]) == 2
    _hold_trees(ttf.params_to_jax(tcfg, model), jp, **STEP_TOL)
    if name == "adafactor":
        # the factors of the stacked (L, d) norm scales: r over d, c over L
        key = "layers.*.ln1" if arch == "qwen2.5-3b" else "m_main.*.*.ln"
        f = tstate["f"][key]
        jf = (jstate["f"]["layers"]["ln1"] if arch == "qwen2.5-3b"
              else jstate["f"]["m_main"]["ln"])
        for k in ("r", "c"):
            np.testing.assert_allclose(f[k].numpy(), np.asarray(jf[k]),
                                       **STEP_TOL)


def test_adamw_moments_stay_fp32_on_bf16_params():
    p = {"w": torch.ones(4, 3, dtype=torch.bfloat16)}
    opt = topt.make_optimizer("adamw")
    state = opt.init(p)
    opt.update({"w": torch.full((4, 3), 0.5, dtype=torch.bfloat16)}, state,
               p, 1e-2)
    assert state["m"][0].dtype == state["v"][0].dtype == torch.float32
    assert p["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("fn,args", [
    ("warmup_cosine", (3e-4, 10, 100)),
    ("warmup_cosine", (1e-2, 3, 7)),
    ("cosine", (3e-4, 50)),
    ("constant", (3e-4,)),
])
def test_schedules_match_reference(fn, args):
    want = getattr(jsched, fn)(*args)
    got = getattr(tsched, fn)(*args)
    for step in range(0, 130, 3):
        assert got(step) == pytest.approx(float(want(jnp.int32(step))),
                                          rel=1e-6, abs=1e-12)
    if fn == "warmup_cosine":
        assert got(0) == 0.0


def _jloss(jcfg):
    def loss(p, tokens, labels):
        logits, _ = jtf.forward(p, jcfg, tokens, mode="train", mesh=None,
                                batch_axes=())
        return jxent(logits, labels, jcfg.final_logit_softcap)
    return loss


@pytest.mark.parametrize("microbatches", [1, 2])
def test_smoke_losses_match_reference(microbatches):
    """Five AdamW steps of qwen2.5-3b smoke (fp32, warmup_cosine(3e-3, 2,
    5), weight decay 0.01) from the reference's parameters and batches:
    the losses agree within 2e-5 relative."""
    jcfg, tcfg = _cfgs("qwen2.5-3b")
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    model = ttf.params_from_jax(tcfg, _np(jp))
    jo = jopt.make_optimizer("adamw", weight_decay=0.01)
    to = topt.make_optimizer("adamw", weight_decay=0.01)
    jfn = jax.jit(jsteps.make_train_step(
        jcfg, jo, jsched.warmup_cosine(3e-3, 2, 5), mesh=None, batch_axes=(),
        microbatches=microbatches))
    tfn = tsteps.make_train_step(tcfg, to, tsched.warmup_cosine(3e-3, 2, 5),
                                 microbatches=microbatches)
    jstate, tstate = jo.init(jp), to.init(dict(model.named_parameters()))
    pipe = iter(TokenPipeline(tcfg.vocab, 4, 32, seed=0))
    jl, tl = [], []
    for _ in range(5):
        hb = next(pipe)
        jp, jstate, loss = jfn(jp, jstate, {k: jnp.asarray(hb[k])
                                            for k in ("tokens", "labels")})
        jl.append(float(loss))
        tl.append(float(tfn(model, tstate, {k: torch.as_tensor(hb[k])
                                            for k in ("tokens", "labels")})))
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    assert jl[-1] < jl[0]


def test_microbatches_split_rows_strided(monkeypatch):
    """Two microbatches take rows 0, 2 and rows 1, 3, and the step's loss
    is the mean of theirs."""
    cfg = get_smoke("qwen2.5-3b").replace(dtype="float32")
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    hb = next(iter(TokenPipeline(cfg.vocab, 4, 16, seed=1)))
    b = {k: torch.as_tensor(hb[k]) for k in ("tokens", "labels")}
    seen, forward = [], ttf.forward

    def spy(params, cfg, tokens, **kw):
        seen.append(tokens)
        return forward(params, cfg, tokens, **kw)
    monkeypatch.setattr(ttf, "forward", spy)
    sgd = topt.make_optimizer("sgd")
    step = tsteps.make_train_step(cfg, sgd, tsched.constant(0.0),
                                  microbatches=2)
    loss = float(step(model, sgd.init([]), b))
    assert [t.tolist() for t in seen] == [b["tokens"][0::2].tolist(),
                                          b["tokens"][1::2].tolist()]
    with torch.no_grad():
        halves = [float(cross_entropy(
            forward(model, cfg, b["tokens"][i::2], mode="train")[0],
            b["labels"][i::2])) for i in (0, 1)]
    assert loss == pytest.approx(sum(halves) / 2, rel=1e-6)


def test_trainer_loss_decreases():
    """The port's copy of tests/test_launch.py::test_trainer_loss_decreases
    (on the CPU)."""
    _, losses, _, _ = train("qwen2.5-3b", "smoke", steps=25, batch=4, seq=64,
                            log_every=100, device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_rwkv_smoke_gradients_match_jax_grad():
    """rwkv6-3b smoke in fp32 with a non-zero bonus u (the models start it
    at zeros): every parameter's gradient of the train-mode loss, the
    port's through the checkpointed blocks and the naive scan, against
    jax.grad of the reference's loss through its chunked scan. Held to
    2e-4 of each leaf's largest |gradient|, atol 1e-7."""
    jcfg, tcfg = _cfgs("rwkv6-3b")
    jp = _np(jtf.init_params(jcfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    jp["layers"]["rwkv"]["u"] = (0.5 * rng.standard_normal(
        jp["layers"]["rwkv"]["u"].shape)).astype(np.float32)
    hb = next(iter(TokenPipeline(jcfg.vocab, 2, 64, seed=5)))
    want = jax.grad(_jloss(jcfg))(jp, jnp.asarray(hb["tokens"]),
                                  jnp.asarray(hb["labels"]))
    model = ttf.params_from_jax(tcfg, jp)
    logits, _ = ttf.forward(model, tcfg, torch.as_tensor(hb["tokens"]),
                            mode="train")
    cross_entropy(logits, torch.as_tensor(hb["labels"])).backward()
    grads = copy.deepcopy(model)
    for p, g in zip(grads.parameters(), model.parameters()):
        p.data = g.grad
    got_f = {k: _numpy(v) for k, v in
             _flat(ttf.params_to_jax(tcfg, grads)).items()}
    want_f = {k: _numpy(v) for k, v in _flat(want).items()}
    assert sorted(got_f) == sorted(want_f)
    assert np.abs(want_f["layers.rwkv.u"]).max() > 0
    for k in want_f:
        scale = float(np.abs(want_f[k]).max())
        np.testing.assert_allclose(got_f[k], want_f[k], rtol=0,
                                   atol=2e-4 * scale + 1e-7, err_msg=k)


def test_train_step_refuses_moe():
    cfg = get_smoke("qwen2.5-3b").replace(n_experts=4, top_k=2)
    with pytest.raises(NotImplementedError, match="aux loss"):
        tsteps.make_train_step(cfg, topt.make_optimizer("sgd"),
                               tsched.constant(0.1))
