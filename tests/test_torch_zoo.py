"""The rest of the LLM zoo (the moe, vlm and audio families and
command-r-plus-104b) in the port against the JAX reference.

Each case builds the reference's smoke parameters from
`jax.random.PRNGKey(seed)` (drawn once per architecture, a module
fixture), carries them across with `params_from_jax` and feeds both
packages the same numpy inputs from `np.random.default_rng(seed)`, in
fp32: outputs are held to atol 3e-4 / rtol 1e-3, as
tests/test_attention_impls.py holds the reference's own attention paths
to each other. Each reference computation a case needs is one
`jax.jit` (on one CPU core a compile of the whole costs a fraction of
compiling its hundreds of primitives one by one in eager mode). With
attn_impl="pallas" the reference runs its Pallas kernel in interpret
mode and the port the kernel's plain version (CPU tensors). The jits,
the parameter draw included, compile at XLA's backend optimisation
level 0 without the CPU fusion emitters (`ref.jit`): on one core that
cuts each compile to about a third, and moves the reference's outputs
by a few 1e-6 at most (its parameters by an ulp here and there), well
inside the tolerances, while both packages still get the very same
parameters and inputs.

JAX is imported inside the `ref` fixture, so the `cuda` cases (card
against CPU, no reference) run on a machine without it.
"""
import copy
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import load_pytree, save_pytree  # noqa: E402
from repro_torch.configs import get_config, get_smoke, list_archs  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.serve import serve_batch  # noqa: E402
from repro_torch.launch.train import scaled_config, train  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.common import (ModelConfig, Params,  # noqa: E402
                                       cross_entropy)
from repro_torch.optim import make_optimizer, warmup_cosine  # noqa: E402

TOL = dict(atol=3e-4, rtol=1e-3)
MOE, ARCTIC, CMD_R = "qwen3-moe-235b-a22b", "arctic-480b", \
    "command-r-plus-104b"
VLM, AUDIO = "llama-3.2-vision-11b", "musicgen-medium"
S = 16


from _torch_threads import one_thread as _one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def ref():
    """The reference's modules and its smoke parameters (numpy), drawn
    once per (arch, seed)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.checkpoint import load_pytree as jload
    from repro.checkpoint import save_pytree as jsave
    from repro.configs import get_config as jget_config
    from repro.configs import get_smoke as jget_smoke
    from repro.launch import serve as jserve
    from repro.launch import shapes as jshapes
    from repro.launch import steps as jsteps
    from repro.launch import train as jtrain
    from repro.models import attention as jattn
    from repro.models import moe as jmoe
    from repro.models import transformer as jtf
    from repro.models.common import ModelConfig as JConfig
    from repro.models.common import cross_entropy as jxent
    from repro.optim import optimizers as jopt
    from repro.optim import schedules as jsched
    drawn = {}

    def jit(fn):
        return jax.jit(fn, compiler_options={
            "xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True,
            "xla_cpu_use_fusion_emitters": False})

    def params(arch, seed=0):
        if (arch, seed) not in drawn:
            drawn[arch, seed] = jax.tree.map(np.asarray, jit(
                lambda k: jtf.init_params(cfg(arch), k))(
                jax.random.PRNGKey(seed)))
        return drawn[arch, seed]

    def moe_params(arch, seed):
        """One MoE layer's parameters (the capacity factor draws none)."""
        if ("moe", arch, seed) not in drawn:
            drawn["moe", arch, seed] = jax.tree.map(np.asarray, jit(
                lambda k: jmoe.init_moe(cfg(arch), k))(
                jax.random.PRNGKey(seed)))
        return drawn["moe", arch, seed]

    def cfg(arch, **kw):
        return jget_smoke(arch).replace(dtype="float32", **kw)
    return types.SimpleNamespace(**locals())


def _cfg(arch, **kw):
    return get_smoke(arch).replace(dtype="float32", **kw)


def _inputs(cfg, seed, B=2, seq=S):
    """Tokens ((B, seq) or (B, seq, ncb)) and, for vlm, image embeddings
    (B, n_img_tokens, d_vision), from a numpy seed."""
    rng = np.random.default_rng(seed)
    shp = (B, seq, cfg.n_codebooks) if cfg.n_codebooks else (B, seq)
    toks = rng.integers(0, cfg.vocab, shp).astype(np.int32)
    img = None
    if cfg.family == "vlm":
        img = rng.standard_normal((B, cfg.n_img_tokens, cfg.d_vision)
                                  ).astype(np.float32)
    return toks, img


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _stacked(c):
    """The port's cache (lists of per-layer dicts) -> the reference's
    layout, the layers stacked on leading axes."""
    if isinstance(c, dict):
        return {k: _stacked(v) for k, v in c.items()}
    if isinstance(c, list):
        items = [_stacked(x) for x in c]
        if isinstance(items[0], dict):
            return {k: torch.stack([i[k] for i in items]) for k in items[0]}
        return torch.stack(items)
    return c


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _numpy(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _hold(got, want, exact=False, **tol):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        if exact:
            np.testing.assert_array_equal(_numpy(got[k]), _numpy(want[k]),
                                          err_msg=k)
        else:
            np.testing.assert_allclose(_numpy(got[k]), _numpy(want[k]),
                                       err_msg=k, **(tol or TOL))


def test_configs_and_families_are_all_ported(ref):
    for arch in list_archs():
        for ours, theirs in ((get_config(arch), ref.jget_config(arch)),
                             (get_smoke(arch), ref.jget_smoke(arch))):
            assert vars(ours) == vars(theirs)
    assert set(ttf.FAMILIES) == {get_config(a).family for a in list_archs()}


# ---- the MoE layer ----------------------------------------------------------

def _moe_case(ref, arch, seed, **kw):
    jcfg, cfg = ref.cfg(arch, **kw), _cfg(arch, **kw)
    p = ref.moe_params(arch, seed)
    x = np.random.default_rng(seed).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, p, x


def _moe_both(ref, jcfg, cfg, p, x):
    want, waux = ref.jit(lambda p, x: ref.jmoe.moe_ffn(
        p, jcfg, x, with_aux=True))(p, ref.jnp.asarray(x))
    with torch.no_grad():
        got, aux = tmoe.moe_ffn(Params(ttf._tree(p)), cfg, torch.as_tensor(x),
                                with_aux=True)
    return np.asarray(want), float(waux), got.numpy(), float(aux)


@pytest.mark.parametrize("arch,cf", [(MOE, 0.25), (MOE, 8.0), (ARCTIC, 0.25),
                                     (ARCTIC, 8.0)])
def test_moe_ffn_matches_reference(ref, arch, cf):
    """64 tokens, top-2 of 4 experts: at capacity factor 0.25 each expert
    keeps C = 8 of about 32 choices, so most are dropped, and a token
    whose every choice was dropped comes out exactly zero (qwen3-moe has
    no dense residual): the same tokens in both packages. At 8 nothing
    is dropped."""
    jcfg, cfg, p, x = _moe_case(ref, arch, 3, capacity_factor=cf)
    assert tmoe._capacity(64, cfg) == ref.jmoe._capacity(64, jcfg) == (
        8 if cf < 1 else 256)
    want, waux, got, aux = _moe_both(ref, jcfg, cfg, p, x)
    np.testing.assert_allclose(got, want, **TOL)
    assert aux == pytest.approx(waux, rel=1e-6)
    zero = lambda a: np.flatnonzero(~a.reshape(64, -1).any(-1))  # noqa
    np.testing.assert_array_equal(zero(got), zero(want))
    assert (len(zero(want)) > 0) == (arch == MOE and cf < 1)


def test_moe_router_ties_go_to_the_lower_expert(ref):
    """Router columns 0, 1 and 2 equal: each token's logits tie three
    ways, so top-2 takes two of the tied experts by index, and the
    argmax of the aux loss the first. The experts differ, so another
    pick would change the output."""
    jcfg, cfg, p, x = _moe_case(ref, MOE, 4, capacity_factor=8.0)
    r = p["router"].copy()
    r[:, 1] = r[:, 2] = r[:, 0]
    p = dict(p, router=r)
    want, waux, got, aux = _moe_both(ref, jcfg, cfg, p, x)
    np.testing.assert_allclose(got, want, **TOL)
    assert aux == pytest.approx(waux, rel=1e-6)
    gw, gi = tmoe._route(torch.as_tensor(x).reshape(64, -1),
                         torch.as_tensor(r), cfg.top_k)
    logits = x.reshape(64, -1) @ r
    tied = logits[:, 0] > logits[:, 3]
    assert 0 < tied.sum() < 64
    assert (gi[torch.as_tensor(tied)] == torch.tensor([0, 1])).all()
    assert (gi[torch.as_tensor(~tied)] == torch.tensor([3, 0])).all()


# ---- cross-attention -------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_cross_attention_matches_reference(ref, impl):
    """attn_forward with kv_emb (no RoPE, not causal, the plain core under
    either impl) and attn_decode against the static cache it made, which
    is read and not written."""
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, vocab=64,
              dtype="float32", attn_impl=impl)
    jcfg, cfg = ref.JConfig(**kw), ModelConfig(**kw)
    p = ref.jax.tree.map(np.asarray, ref.jattn.init_attn(
        jcfg, ref.jax.random.PRNGKey(5), cross=True))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    emb = rng.standard_normal((2, 7, 64)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    want, (wk, wv) = ref.jit(
        lambda p, x, pos, emb: ref.jattn.attn_forward(
            p, jcfg, x, pos, kv_emb=emb))(
        p, ref.jnp.asarray(x), ref.jnp.asarray(pos), ref.jnp.asarray(emb))
    tp = Params(ttf._tree(p))
    with torch.no_grad():
        got, (k, v) = tattn.attn_forward(tp, cfg, torch.as_tensor(x),
                                         torch.as_tensor(pos),
                                         kv_emb=torch.as_tensor(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(wk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(wv), **TOL)
    wd, _ = ref.jit(lambda p, x, k, v: ref.jattn.attn_decode(
        p, jcfg, x, 12, {"k": k, "v": v, "static": True}))(
        p, ref.jnp.asarray(x[:, :1]), wk, wv)
    cache = {"k": k.clone(), "v": v.clone(), "static": True}
    with torch.no_grad():
        gd, out_cache = tattn.attn_decode(tp, cfg, torch.as_tensor(x[:, :1]),
                                          12, cache)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), **TOL)
    assert torch.equal(out_cache["k"], k) and torch.equal(out_cache["v"], v)


# ---- whole models -----------------------------------------------------------

@pytest.mark.parametrize("arch,impl", [(MOE, "xla")] + [
    (a, i) for a in (ARCTIC, CMD_R, VLM, AUDIO) for i in ("xla", "pallas")])
def test_forward_matches_reference(ref, arch, impl):
    """Train logits (and the moe family's router aux), then a prefill
    through make_prefill_step (logits and every cache) and one step
    through make_serve_step, vlm with images and audio with codebooks.
    Under "pallas" a prefill alone, full logits and caches: the kernel is
    on that path, and one interpret-mode kernel compiles faster than
    two. qwen3-moe is g_major, so "pallas" would take the plain path
    there, as in the reference."""
    jcfg, cfg = ref.cfg(arch, attn_impl=impl), _cfg(arch, attn_impl=impl)
    pnp = ref.params(arch)
    model = ttf.params_from_jax(cfg, pnp)
    toks, img = _inputs(cfg, 1)
    clen = S + 4
    batch = {"tokens": toks[:, :S - 1], "img_emb": img}
    step = {"tokens": toks[:, S - 1:], "t": S - 1}
    jnp = ref.jnp

    @ref.jit
    def run(p, toks, img):
        if impl == "pallas":
            return ref.jtf.forward(p, jcfg, toks[:, :S - 1], mode="prefill",
                                   img_emb=img, cache_len=clen)
        train = ref.jtf.forward(p, jcfg, toks, mode="train", img_emb=img)
        pre = ref.jsteps.make_prefill_step(jcfg, cache_len=clen)(
            p, {"tokens": toks[:, :S - 1], "img_emb": img})
        dec = ref.jsteps.make_serve_step(jcfg)(p, {
            "tokens": toks[:, S - 1:], "cache": pre[1],
            "t": jnp.int32(S - 1)})
        return train, pre, dec
    out = run(pnp, jnp.asarray(toks),
              None if img is None else jnp.asarray(img))
    if impl == "pallas":
        with torch.no_grad():
            gl, cache = ttf.forward(model, cfg, _t(toks[:, :S - 1]),
                                    mode="prefill", img_emb=_t(img),
                                    cache_len=clen)
        np.testing.assert_allclose(gl.numpy(), np.asarray(out[0]), **TOL)
        _hold(_stacked(cache), out[1], **TOL)
        return
    (want, waux), (wl, wcache), dec = out
    with torch.no_grad():
        got, aux = ttf.forward(model, cfg, _t(toks), mode="train",
                               img_emb=_t(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (aux is None) == (waux is None) == (cfg.family != "moe")
    if aux is not None:
        assert float(aux) == pytest.approx(float(waux), rel=1e-5)
    assert got.shape == ((2, S, cfg.n_codebooks, cfg.vocab)
                         if cfg.n_codebooks else (2, S, cfg.vocab))
    with torch.no_grad():
        gl, cache = tsteps.make_prefill_step(cfg, cache_len=clen)(
            model, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
    _hold(_stacked(cache), wcache, **TOL)
    with torch.no_grad():   # writes the cache in place, as the port does
        gd, _ = tsteps.make_serve_step(cfg)(model, dict(
            step, tokens=_t(step["tokens"]), cache=cache))
    np.testing.assert_allclose(gd.numpy(), np.asarray(dec[0]), **TOL)


@pytest.mark.parametrize("arch", [AUDIO, VLM, MOE])
def test_decode_matches_full_forward(arch):
    """As tests/test_models.py:20,38 in the port: the last position of a
    full forward equals a prefill of the rest and one decode step (vlm
    with images; the MoE with headroom, capacity factor 8, so neither
    path drops a token)."""
    cfg = _cfg(arch, capacity_factor=8.0)
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    n = 33
    toks, img = (_t(a) for a in _inputs(cfg, 2, seq=n))
    with torch.no_grad():
        full, _ = ttf.forward(model, cfg, toks, img_emb=img)
        _, cache = ttf.forward(model, cfg, toks[:, :n - 1], mode="prefill",
                               img_emb=img, cache_len=64)
        lg, _ = ttf.forward(model, cfg, toks[:, n - 1:], mode="decode",
                            cache=cache, t=n - 1, img_emb=img)
    np.testing.assert_allclose(full[:, -1].numpy(), lg[:, 0].numpy(), **TOL)


@pytest.mark.parametrize("arch", [MOE, VLM, AUDIO])
def test_param_trees_round_trip(ref, arch, tmp_path):
    """The moe (`layers.ffn.{router, wg, wu, wd}`), vlm (`self_layers`
    (n_super, period - 1, ...), `cross_layers`) and audio (stacked
    `embed` and `head`) trees: params_from_jax / params_to_jax give the
    reference's leaves bit for bit, the port's own init makes the same
    shapes, and the npz checkpoint carries the tree both ways."""
    cfg = _cfg(arch)
    pnp = ref.params(arch)
    model = ttf.params_from_jax(cfg, pnp)
    _hold(ttf.params_to_jax(cfg, model), pnp, exact=True)
    fresh = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    assert {n: (tuple(p.shape), p.dtype) for n, p in
            fresh.named_parameters()} == \
        {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    path = str(tmp_path / "ref.npz")
    ref.jsave(path, pnp, {"arch": arch})
    tree, meta = load_pytree(path)
    assert meta == {"arch": arch}
    _hold(ttf.params_to_jax(cfg, ttf.params_from_jax(cfg, tree)), pnp,
          exact=True)
    path = str(tmp_path / "port.npz")
    save_pytree(path, ttf.params_to_jax(cfg, fresh))
    back, _ = ref.jload(path, as_jax=False)
    _hold(back, ttf.params_to_jax(cfg, fresh), exact=True)


@pytest.mark.parametrize("arch", [MOE, ARCTIC, VLM])
def test_serve_batch_matches_reference(ref, arch, monkeypatch):
    """Two members (the reference's smoke parameters, and the same with
    numpy noise added), 2 x 8 prompts, 4 tokens: equal greedy tokens; vlm
    is served text-only, as the reference's serve_batch passes no images.
    The reference's serve_batch jits its prefill and decode through
    `ref.jit`, as every other reference computation here."""
    monkeypatch.setattr(ref.jserve, "jax", types.SimpleNamespace(
        jit=ref.jit, nn=ref.jax.nn))
    jcfg, cfg = ref.cfg(arch), _cfg(arch)
    rng = np.random.default_rng(6)
    p0 = ref.params(arch)
    p1 = ref.jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(
        a.shape)).astype(a.dtype), p0)
    prompts, _ = _inputs(cfg, 7, seq=8)
    want = np.asarray(ref.jserve.serve_batch(
        jcfg, [p0, p1], ref.jnp.asarray(prompts), gen_len=4))
    got = serve_batch(cfg, [ttf.params_from_jax(cfg, p) for p in (p0, p1)],
                      torch.as_tensor(prompts), gen_len=4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_batch_refuses_audio_prompts(ref):
    """Both packages' serve_batch unpack `B, S = prompts.shape`, so
    musicgen's (B, S, ncb) prompts raise; audio is served through the
    step functions."""
    cfg = _cfg(AUDIO)
    toks, _ = _inputs(cfg, 8, seq=4)
    with pytest.raises(ValueError, match="unpack"):
        ref.jserve.serve_batch(ref.cfg(AUDIO), [], ref.jnp.asarray(toks))
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="unpack"):
        serve_batch(cfg, [model], torch.as_tensor(toks))


# ---- training ---------------------------------------------------------------

def _jloss(ref, jcfg):
    def loss(p, b):
        logits, extra = ref.jtf.forward(p, jcfg, b["tokens"], mode="train",
                                        img_emb=b.get("img_emb"))
        out = ref.jxent(logits, b["labels"], jcfg.final_logit_softcap)
        return out + 0.01 * extra if jcfg.n_experts else out
    return loss


def _batch(cfg, seed):
    toks, img = _inputs(cfg, seed, seq=S + 1)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if img is not None:
        b["img_emb"] = img
    return b


@pytest.mark.parametrize("arch", [MOE, VLM, AUDIO])
def test_train_steps_match_reference(ref, arch):
    """Two AdamW steps (warmup_cosine(3e-3, 1, 2), weight decay 0.01) from
    the reference's parameters, the moe family's loss with 0.01 x its
    router aux, vlm's with image embeddings, musicgen's the cross-entropy
    of (B, S, ncb, V) logits against (B, S, ncb) codebook labels: the
    losses agree within 1e-5
    relative, and every first-step gradient within 1e-4 of its leaf's
    largest |gradient| (atol 1e-7), the port's through the checkpointed
    blocks (and the dispatch's gathers and the sorted top-k) against
    jax.grad. The reference's step is its make_train_step's body at one
    microbatch (value_and_grad, the schedule, opt.update), each part one
    jit, so the first step's gradient comes out on the way."""
    jcfg, cfg = ref.cfg(arch), _cfg(arch)
    jp = ref.params(arch)
    model = ttf.params_from_jax(cfg, jp)
    jo = ref.jopt.make_optimizer("adamw", weight_decay=0.01)
    to = make_optimizer("adamw", weight_decay=0.01)
    jlr = ref.jsched.warmup_cosine(3e-3, 1, 2)
    loss_fn = _jloss(ref, jcfg)

    @ref.jit
    def jstep(p, st, b):
        loss, g = ref.jax.value_and_grad(loss_fn)(p, b)
        return (loss, g) + tuple(jo.update(g, st, p, jlr(st["step"])))
    tfn = tsteps.make_train_step(cfg, to, warmup_cosine(3e-3, 1, 2))
    jstate, tstate = jo.init(jp), to.init(dict(model.named_parameters()))
    jl, tl, wgrad = [], [], None
    for seed in (9, 10):
        b = _batch(cfg, seed)
        loss, g, jp, jstate = jstep(jp, jstate, b)
        jl.append(float(loss))
        if wgrad is None:
            wgrad = {k: _numpy(v) for k, v in _flat(g).items()}
            ggrad = _port_grads(cfg, model, b)
        tl.append(float(tfn(model, tstate, {k: _t(v)
                                            for k, v in b.items()})))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert sorted(ggrad) == sorted(wgrad)
    if cfg.n_experts:
        assert np.abs(wgrad["layers.ffn.router"]).max() > 0
    for k in wgrad:
        scale = float(np.abs(wgrad[k]).max())
        np.testing.assert_allclose(ggrad[k], wgrad[k], rtol=0,
                                   atol=1e-4 * scale + 1e-7, err_msg=k)


def _port_grads(cfg, model, b):
    """The gradient of the port's train loss at `model` (a copy), by the
    reference's names."""
    m = copy.deepcopy(model)
    logits, aux = ttf.forward(m, cfg, _t(b["tokens"]), mode="train",
                              img_emb=_t(b.get("img_emb")))
    loss = cross_entropy(logits, _t(b["labels"]))
    (loss + 0.01 * aux if cfg.n_experts else loss).backward()
    for p in m.parameters():
        p.data = p.grad
    return {k: _numpy(v) for k, v in _flat(ttf.params_to_jax(cfg, m)).items()}


@pytest.mark.parametrize("arch", [MOE, VLM, AUDIO])
def test_trainer_runs_the_new_families(arch, tmp_path):
    """train() at smoke on the CPU (vlm with zero image embeddings, as
    the reference's trainer), two steps with finite losses and a
    checkpoint."""
    _, losses, _, _ = train(arch, "smoke", steps=2, batch=2, seq=16,
                            device="cpu", ckpt_dir=str(tmp_path),
                            log_every=100)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert (tmp_path / f"{arch}_smoke_final.npz").exists()


@pytest.mark.parametrize("preset", ["25m", "100m"])
@pytest.mark.parametrize("arch", [MOE, ARCTIC, VLM])
def test_scaled_config_matches_reference(ref, arch, preset):
    """The presets keep the reference's vlm (cross_attn_every 2) and MoE
    (8 experts, d_ff / 4) rules."""
    assert vars(scaled_config(arch, preset)) == \
        vars(ref.jtrain.scaled_config(arch, preset))


# ---- input specs ------------------------------------------------------------

@pytest.mark.parametrize("shape", list(tshapes.SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_reference(ref, arch, shape):
    """Every input of every (arch, shape) at full size: the port's meta
    tensors have the reference's ShapeDtypeStructs' shapes and dtypes
    (the cache's per-layer lists stacked as the reference stacks them)."""
    got = tshapes.input_specs(get_config(arch), tshapes.SHAPES[shape])
    want = ref.jshapes.input_specs(ref.jget_config(arch),
                                   ref.jshapes.SHAPES[shape])
    assert vars(tshapes.SHAPES[shape]) == vars(ref.jshapes.SHAPES[shape])
    got = _flat(_stacked(got))
    want = _flat(want)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.device.type == "meta", k
        assert (tuple(t.shape), str(t.dtype).split(".")[-1]) == \
            (tuple(want[k].shape), want[k].dtype.name), k


# ---- the drivers ------------------------------------------------------------

def test_example_drivers_run_on_cpu(tmp_path, monkeypatch, capsys):
    from repro_torch.examples import serve_ensemble, train_llm
    monkeypatch.chdir(tmp_path)
    train_llm.main(["--device", "cpu", "--preset", "smoke", "--steps", "12",
                    "--arch", MOE])
    assert (tmp_path / "results" / "torch" / "ckpts"
            / f"{MOE}_smoke_final.npz").exists()
    serve_ensemble.main(["--device", "cpu", "--steps", "2", "--members",
                         "2", "--arch", VLM])
    out = capsys.readouterr().out
    assert "checkpoint round-trip OK" in out and "ensemble NLL" in out


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [MOE, ARCTIC])
def test_cuda_moe_ffn_matches_cpu(cuda, arch):
    """moe_ffn at smoke width, fp32, 4 x 256 tokens with drops (capacity
    factor 1): the card against the CPU, and the same tokens dropped."""
    cfg = _cfg(arch, capacity_factor=1.0)
    p = tmoe.init_moe(cfg, torch.Generator().manual_seed(1))
    x = torch.randn((4, 256, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want, waux = tmoe.moe_ffn(p, cfg, x, with_aux=True)
        got, aux = tmoe.moe_ffn(p.to("cuda"), cfg, x.cuda(), with_aux=True)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)
    assert float(aux) == pytest.approx(float(waux), rel=1e-5)


@pytest.mark.cuda
def test_cuda_moe_combine_is_bitwise_repeatable(cuda):
    """qwen3-moe's top-8 of 128 experts at d_model 512, bf16: two calls
    on the same inputs give the same bits (no atomics in the combine)."""
    cfg = get_config(MOE).replace(d_model=512, d_ff=128)
    p = tmoe.init_moe(cfg, torch.Generator("cuda").manual_seed(3))
    x = torch.randn((4, 512, 512), generator=torch.Generator(
        "cuda").manual_seed(4), device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        a, b = (tmoe.moe_ffn(p, cfg, x) for _ in range(2))
    assert torch.equal(a, b)
