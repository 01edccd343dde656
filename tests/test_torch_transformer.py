"""The port's dense transformer against the JAX reference, with the
reference's own weights carried across by `params_from_jax`.

Inputs are numpy token batches from a seed. The forwards run in fp32;
logits are held to atol 3e-4 / rtol 1e-3, as tests/test_attention_impls.py
holds the reference's own attention paths to each other. With
attn_impl="pallas" the reference runs its Pallas kernel in interpret mode
and the port the kernel's plain version (CPU tensors).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.common import ModelConfig as JConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402

ARCHS = ("llama3-8b", "qwen2.5-3b", "gemma2-27b")
TOL = dict(atol=3e-4, rtol=1e-3)


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _jparams(jcfg, seed):
    return _np_tree(jtf.init_params(jcfg, jax.random.PRNGKey(seed)))


def _tokens(seed, vocab, B, S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (B, S)).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _cfgs(arch, **kw):
    """The same smoke config in both packages, fp32 unless overridden."""
    kw.setdefault("dtype", "float32")
    return jget_smoke(arch).replace(**kw), get_smoke(arch).replace(**kw)


def test_configs_mirror_the_reference():
    """All 11 names of the reference's registry resolve and none raises;
    the 10 model configs and their smoke variants are the reference's
    (paper-cnn's dict holds each package's own FedPAEConfig)."""
    from repro.configs import ARCHS as JARCHS
    from repro.configs import get_config as jget_config
    from repro_torch.configs import ARCHS as TARCHS
    assert TARCHS == JARCHS and len(TARCHS) == 11
    for arch in TARCHS:
        pairs = ((get_config(arch), jget_config(arch)),
                 (get_smoke(arch), jget_smoke(arch)))
        if arch == "paper-cnn":
            assert all(sorted(a) == sorted(b) for a, b in pairs)
            continue
        for ours, theirs in pairs:
            assert vars(ours) == vars(theirs)
    assert vars(ModelConfig()) == vars(JConfig())


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_round_trips(arch):
    jcfg, cfg = _cfgs(arch, dtype="bfloat16")
    pnp = _jparams(jcfg, 0)
    model = ttf.params_from_jax(cfg, pnp)
    want = _flat({k: v for k, v in pnp.items() if k != "layers"})
    for i in range(cfg.n_layers):
        want.update(_flat(jax.tree.map(lambda a: a[i], pnp["layers"]),
                          f"layers.{i}."))
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert str(t.dtype).split(".")[-1] == want[name].dtype.name, name
        np.testing.assert_array_equal(
            t.detach().float().numpy(), np.asarray(want[name], np.float32),
            err_msg=name)
    # the port's own init makes the same tree
    fresh = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    assert {n: (tuple(p.shape), p.dtype)
            for n, p in fresh.named_parameters()} == \
        {n: (tuple(p.shape), p.dtype) for n, p in got.items()}


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, impl, mode):
    jcfg, cfg = _cfgs(arch, attn_impl=impl)
    pnp = _jparams(jcfg, 1)
    toks = _tokens(2, cfg.vocab, 2, 64)
    clen = 80
    fwd = jax.jit(lambda p, t: jtf.forward(p, jcfg, t, mode=mode,
                                           cache_len=clen))
    want, wcache = fwd(pnp, jnp.asarray(toks))
    model = ttf.params_from_jax(cfg, pnp)
    with torch.no_grad():
        got, cache = ttf.forward(model, cfg, torch.as_tensor(toks),
                                 mode=mode, cache_len=clen)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if mode == "train":
        assert cache is None
        return
    for i, layer in enumerate(cache["kv"]):
        np.testing.assert_array_equal(layer["pos"].numpy(),
                                      np.asarray(wcache["kv"]["pos"][i]))
        for n in ("k", "v"):
            np.testing.assert_allclose(layer[n].numpy(),
                                       np.asarray(wcache["kv"][n][i]), **TOL)


@pytest.mark.parametrize("layout", ["kv_major", "g_major"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_full_forward(arch, layout):
    """As test_gqa_layouts_agree_with_consistent_weights: the last
    position of a full forward equals prefill + one decode step, in the
    port, and the decode logits equal the reference's."""
    jcfg, cfg = _cfgs(arch, gqa_layout=layout)
    pnp = _jparams(jcfg, 3)
    S = 17
    toks = _tokens(4, cfg.vocab, 2, S)
    model = ttf.params_from_jax(cfg, pnp)
    with torch.no_grad():
        full, _ = ttf.forward(model, cfg, torch.as_tensor(toks))
        _, cache = ttf.forward(model, cfg, torch.as_tensor(toks[:, :S - 1]),
                               mode="prefill", cache_len=32)
        lg, cache = ttf.forward(model, cfg, torch.as_tensor(toks[:, S - 1:]),
                                mode="decode", cache=cache, t=S - 1)
    np.testing.assert_allclose(full[:, -1].numpy(), lg[:, 0].numpy(), **TOL)
    assert [int(c["pos"].max()) for c in cache["kv"]] == [S - 1] * 2
    _, jcache = jtf.forward(pnp, jcfg, jnp.asarray(toks[:, :S - 1]),
                            mode="prefill", cache_len=32)
    jlg, _ = jtf.forward(pnp, jcfg, jnp.asarray(toks[:, S - 1:]),
                         mode="decode", cache=jcache, t=jnp.int32(S - 1))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    # the first token decoded into an empty cache == a 1-token forward
    with torch.no_grad():
        lg0, _ = ttf.forward(model, cfg, torch.as_tensor(toks[:, :1]),
                             mode="decode", cache=ttf.init_cache(cfg, 2, 4),
                             t=0)
    np.testing.assert_allclose(lg0.numpy(), full[:, :1].numpy(), **TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("H,KV,window,cap", [
    (4, 4, 0, 0.0), (4, 2, 0, 0.0), (4, 2, 32, 0.0), (4, 4, 0, 30.0)])
def test_attn_forward_matches_reference(H, KV, window, cap, impl):
    """attn_forward with a static window, chunked (attn_chunk 32 < S)
    on the "xla" path, as tests/test_attention_impls.py sets it up."""
    kw = dict(d_model=H * 32, n_heads=H, n_kv_heads=KV, head_dim=32,
              vocab=64, dtype="float32", attn_logit_softcap=cap,
              attn_chunk=32, attn_impl=impl)
    jcfg, cfg = JConfig(**kw), ModelConfig(**kw)
    p = _np_tree(jattn.init_attn(jcfg, jax.random.PRNGKey(0)))
    x = np.random.default_rng(5).standard_normal(
        (2, 128, cfg.d_model)).astype(np.float32)
    pos = np.arange(128, dtype=np.int32)
    want, (wk, wv) = jattn.attn_forward(p, jcfg, jnp.asarray(x),
                                        jnp.asarray(pos), window=window)
    tp = ttf.Params({k: torch.tensor(v) for k, v in p.items()})
    with torch.no_grad():
        got, (k, v) = tattn.attn_forward(tp, cfg, torch.as_tensor(x),
                                         torch.as_tensor(pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(k.numpy(), np.asarray(wk), **TOL)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_cross_entropy_matches_reference(cap):
    from repro.models.common import cross_entropy as jce
    from repro_torch.models.common import cross_entropy as tce
    rng = np.random.default_rng(8)
    logits = (4 * rng.standard_normal((2, 5, 33))).astype(np.float32)
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        float(tce(torch.as_tensor(logits), torch.as_tensor(labels), cap)),
        float(jce(jnp.asarray(logits), jnp.asarray(labels), cap)),
        rtol=1e-6)


def test_pallas_branch_drops_layer_windows():
    """Inside forward the window is a tensor, so the "pallas" branch runs
    without gemma2's local window (attention.py:128 of the reference),
    while the "xla" branch applies it: with a window shorter than S the
    two differ, in both packages alike."""
    jcfg, cfg = _cfgs("gemma2-27b", local_window=8)
    pnp = _jparams(jcfg, 6)
    toks = _tokens(7, cfg.vocab, 1, 32)
    model = ttf.params_from_jax(cfg, pnp)
    outs = {}
    for impl in ("xla", "pallas"):
        with torch.no_grad():
            got, _ = ttf.forward(model, cfg.replace(attn_impl=impl),
                                 torch.as_tensor(toks))
        want, _ = jtf.forward(pnp, jcfg.replace(attn_impl=impl),
                              jnp.asarray(toks))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        outs[impl] = got.numpy()
    assert np.abs(outs["xla"] - outs["pallas"]).max() > 1e-2
