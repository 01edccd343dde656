"""The port's ssm (rwkv6-3b) and hybrid (zamba2-7b) families against the
JAX reference, with the reference's own weights carried across by
`params_from_jax`.

Smoke configs in fp32, token batches from a numpy seed. The port's
prefill runs each scan's plain version (the naive recurrence) on CPU
tensors where the reference runs its chunked jnp scan, so the two take
different roads to the same function: logits and every cache leaf are
held to atol 3e-4 / rtol 1e-3, tighter than the reference's own
chunked-against-naive tolerance (tests/test_models.py:108-130, atol 2e-3
/ rtol 1e-3), and as tests/test_torch_transformer.py holds the dense
family. Served tokens must be equal, with a top-1/top-2 gap above 1e-4
at every step (checked) so that equality does not hinge on rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCHS = ("rwkv6-3b", "zamba2-7b")
TOL = dict(atol=3e-4, rtol=1e-3)
SEED, GEN = 1, 6
MIN_GAP = 1e-4


def _cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return jget_smoke(arch).replace(**kw), get_smoke(arch).replace(**kw)


def _jparams(jcfg, seed):
    return jtf.init_params(jcfg, jax.random.PRNGKey(seed))


def _np(p):
    return jax.tree.map(np.asarray, p)


def _tokens(seed, vocab, B, S):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _stacked(cache):
    """The port's cache (lists a block) -> numpy in the reference's
    layout (block axes stacked first)."""
    if isinstance(cache, dict):
        return {k: _stacked(v) for k, v in cache.items()}
    if isinstance(cache, list):
        items = [_stacked(c) for c in cache]
        if isinstance(items[0], dict):
            return {k: np.stack([it[k] for it in items]) for k in items[0]}
        return np.stack(items)
    return cache.float().numpy()


def _hold_cache(got, want):
    got, want = _flat(_stacked(got)), _flat(_np(want))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        if name.endswith("pos"):
            np.testing.assert_array_equal(got[name], w, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], np.asarray(w, np.float32),
                                       err_msg=name, **TOL)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, cfg = _cfgs(request.param)
    jp = _jparams(jcfg, 1)
    return jcfg, cfg, jp, ttf.params_from_jax(cfg, _np(jp))


def test_configs_mirror_the_reference():
    for arch in ARCHS:
        for ours, theirs in ((get_config(arch), jget_config(arch)),
                             (get_smoke(arch), jget_smoke(arch))):
            assert vars(ours) == vars(theirs)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_round_trips(arch):
    """Every leaf lands under the reference's name with the block axes
    unstacked (hybrid: m_main (n_super, every), m_tail, shared_attn)."""
    jcfg, cfg = _cfgs(arch, dtype="bfloat16")
    pnp = _np(_jparams(jcfg, 0))
    model = ttf.params_from_jax(cfg, pnp)
    want = {}
    for name, a in _flat(pnp).items():
        top, _, rest = name.partition(".")
        if top in ("layers", "m_tail", "shared_attn"):
            for i in range(a.shape[0]):
                want[f"{top}.{i}.{rest}"] = a[i]
        elif top == "m_main":
            for i in range(a.shape[0]):
                for j in range(a.shape[1]):
                    want[f"{top}.{i}.{j}.{rest}"] = a[i, j]
        else:
            want[name] = a
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert str(t.dtype).split(".")[-1] == want[name].dtype.name, name
        np.testing.assert_array_equal(
            t.detach().float().numpy(), np.asarray(want[name], np.float32),
            err_msg=name)
    fresh = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    assert {n: (tuple(p.shape), p.dtype)
            for n, p in fresh.named_parameters()} == \
        {n: (tuple(p.shape), p.dtype) for n, p in got.items()}


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward_matches_reference(model, mode):
    jcfg, cfg, jp, tp = model
    toks = _tokens(2, cfg.vocab, 2, 64)
    want, wcache = jtf.forward(jp, jcfg, jnp.asarray(toks), mode=mode,
                               cache_len=80)
    with torch.no_grad():
        got, cache = ttf.forward(tp, cfg, torch.as_tensor(toks), mode=mode,
                                 cache_len=80)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if mode == "train":
        assert cache is None
    else:
        _hold_cache(cache, wcache)


def test_prefill_then_decode_matches_reference(model):
    """Two decode steps after a prefill: logits and every cache leaf (the
    SSM h and conv tails, the RWKV s and token-shift rows, the shared
    attention KV) against the reference's; the port's own last logits
    equal a full forward's, and so do its first from `init_cache`."""
    jcfg, cfg, jp, tp = model
    S = 19
    toks = _tokens(4, cfg.vocab, 2, S)
    _, jc = jtf.forward(jp, jcfg, jnp.asarray(toks[:, :S - 2]),
                        mode="prefill", cache_len=32)
    with torch.no_grad():
        full, _ = ttf.forward(tp, cfg, torch.as_tensor(toks))
        _, cache = ttf.forward(tp, cfg, torch.as_tensor(toks[:, :S - 2]),
                               mode="prefill", cache_len=32)
    for t in (S - 2, S - 1):
        jlg, jc = jtf.forward(jp, jcfg, jnp.asarray(toks[:, t:t + 1]),
                              mode="decode", cache=jc, t=jnp.int32(t))
        with torch.no_grad():
            lg, cache = ttf.forward(tp, cfg, torch.as_tensor(toks[:, t:t + 1]),
                                    mode="decode", cache=cache, t=t)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    _hold_cache(cache, jc)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, -1].numpy(), **TOL)
    # the first token decoded into an empty cache == a 1-token forward
    with torch.no_grad():
        lg0, _ = ttf.forward(tp, cfg, torch.as_tensor(toks[:, :1]),
                             mode="decode", cache=ttf.init_cache(cfg, 2, 4),
                             t=0)
    np.testing.assert_allclose(lg0.numpy(), full[:, :1].numpy(), **TOL)


def test_rwkv_prefill_continues_a_carried_state():
    """A prefill given a cache carries its RWKV state into the scan (the
    `s0` of wkv_scan), in the port as in the reference: two prefills of
    halves end where one prefill of the whole does."""
    jcfg, cfg = _cfgs("rwkv6-3b")
    jp = _jparams(jcfg, 5)
    tp = ttf.params_from_jax(cfg, _np(jp))
    toks = _tokens(6, cfg.vocab, 2, 40)
    with torch.no_grad():
        whole, wc = ttf.forward(tp, cfg, torch.as_tensor(toks),
                                mode="prefill")
        _, c = ttf.forward(tp, cfg, torch.as_tensor(toks[:, :24]),
                           mode="prefill")
        second, c = ttf.forward(tp, cfg, torch.as_tensor(toks[:, 24:]),
                                mode="prefill", cache=c)
    np.testing.assert_allclose(second.numpy(), whole[:, 24:].numpy(), **TOL)
    _, jc = jtf.forward(jp, jcfg, jnp.asarray(toks[:, :24]), mode="prefill")
    jsecond, jc = jtf.forward(jp, jcfg, jnp.asarray(toks[:, 24:]),
                              mode="prefill", cache=jc)
    np.testing.assert_allclose(second.numpy(), np.asarray(jsecond), **TOL)
    _hold_cache(c, jc)
    _hold_cache(c, _stacked(wc))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_matches_reference(arch):
    """Two members served through serve_batch: the port's tokens equal the
    reference's; weights [1, 0] give member 0's own tokens."""
    jcfg, cfg = _cfgs(arch)
    key = jax.random.PRNGKey(SEED)
    jparams = [jtf.init_params(jcfg, jax.random.fold_in(key, i))
               for i in range(2)]
    members = [ttf.params_from_jax(cfg, _np(p)) for p in jparams]
    prompts = _tokens(SEED, cfg.vocab, 2, 16)
    want = np.asarray(jserve.serve_batch(jcfg, jparams, jnp.asarray(prompts),
                                         gen_len=GEN))
    got = tserve.serve_batch(cfg, members, torch.as_tensor(prompts),
                             gen_len=GEN)
    assert got.dtype == torch.int32 and got.shape == (2, GEN)
    np.testing.assert_array_equal(got.numpy(), want)
    seq = np.concatenate([prompts, want[:, :-1]], axis=1)
    with torch.no_grad():
        probs = sum(0.5 * torch.softmax(
            ttf.forward(m, cfg, torch.as_tensor(seq))[0].float(), dim=-1)
            for m in members).numpy()[:, prompts.shape[1] - 1:]
    np.testing.assert_array_equal(probs.argmax(-1), want)
    top2 = np.sort(probs, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > MIN_GAP
    solo = tserve.serve_batch(cfg, members[:1], torch.as_tensor(prompts),
                              gen_len=GEN)
    masked = tserve.serve_batch(cfg, members, torch.as_tensor(prompts),
                                gen_len=GEN, weights=[1.0, 0.0])
    np.testing.assert_array_equal(solo.numpy(), masked.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_main_runs_on_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                 "--prompt-len", "8", "--gen-len", "3", "--ensemble", "2"])
    out = capsys.readouterr().out
    assert f"arch={arch} ensemble=2 device=cpu generated (2, 3)" in out
