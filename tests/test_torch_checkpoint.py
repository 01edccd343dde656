"""The port's checkpoint store against the reference's file format: a
file the reference writes loads in the port with every leaf bit for bit
(bf16 too) and gives the reference's logits; a file the port writes
loads in the reference the same way; metadata, lists, None and bf16
round-trip in the port alone, and a write leaves no temporary file.

Logits are compared in fp32, where both forwards are held to atol 3e-4
/ rtol 1e-3 elsewhere (tests/test_torch_recurrent.py); here they come
from the same weights through the file, so the same bound holds.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_pytree as jload  # noqa: E402
from repro.checkpoint import save_pytree as jsave  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.checkpoint import (CheckpointStore, load_pytree,  # noqa: E402
                                    save_pytree)
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

TOL = dict(atol=3e-4, rtol=1e-3)
ARCHS = ("qwen2.5-3b", "rwkv6-3b", "zamba2-7b")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _bits(leaf):
    """A leaf's dtype name and raw bits, numpy or tensor alike."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16", leaf.view(torch.int16).numpy().view(np.uint16)
        return str(leaf.numpy().dtype), leaf.numpy()
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return "bfloat16", a.view(np.uint16)
    return a.dtype.name, a


def _same_bits(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        (gd, gb), (wd, wb) = _bits(got[k]), _bits(want[k])
        assert gd == wd, k
        assert gb.shape == wb.shape and np.array_equal(gb, wb), k


def _tokens(vocab):
    return np.random.default_rng(0).integers(0, vocab, (2, 32)).astype(
        np.int32)


def _logits_agree(jcfg, tcfg, jparams, model):
    toks = _tokens(tcfg.vocab)
    want = np.asarray(jtf.forward(jparams, jcfg, jnp.asarray(toks),
                                  mode="train")[0])
    with torch.no_grad():
        got = ttf.forward(model, tcfg, torch.as_tensor(toks),
                          mode="train")[0].numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reference_file_loads_in_the_port(arch, dtype, tmp_path):
    jcfg = jget_smoke(arch).replace(dtype=dtype)
    tcfg = get_smoke(arch).replace(dtype=dtype)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(1))
    path = str(tmp_path / "ref.npz")
    jsave(path, jp, {"arch": arch, "step": 3})
    tree, meta = load_pytree(path)
    assert meta == {"arch": arch, "step": 3}
    _same_bits(tree, jax.tree.map(np.asarray, jp))
    model = ttf.params_from_jax(tcfg, tree)
    _same_bits(ttf.params_to_jax(tcfg, model), jax.tree.map(np.asarray, jp))
    if dtype == "float32":
        _logits_agree(jcfg, tcfg, jp, model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_port_file_loads_in_the_reference(arch, dtype, tmp_path):
    jcfg = jget_smoke(arch).replace(dtype=dtype)
    tcfg = get_smoke(arch).replace(dtype=dtype)
    model = ttf.init_params(tcfg, torch.Generator().manual_seed(2))
    tree = ttf.params_to_jax(tcfg, model)
    store = CheckpointStore(str(tmp_path / "store"))
    path = store.publish("m", tree, {"final_loss": 1.5})
    assert store.list() == ["m"] and store.exists("m")
    assert sorted(os.listdir(tmp_path / "store")) == ["m.npz"]
    jp, meta = jload(path, as_jax=False)
    assert meta == {"final_loss": 1.5}
    _same_bits(tree, jp)
    # the reference's tree has the shapes of its own init
    shapes = jax.eval_shape(lambda: jtf.init_params(
        jcfg, jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda a: (a.shape, a.dtype.name), shapes) == \
        jax.tree.map(lambda a: (a.shape, a.dtype.name), jp)
    if dtype == "float32":
        _logits_agree(jcfg, tcfg, jax.tree.map(jnp.asarray, jp), model)


def test_round_trip_in_the_port(tmp_path):
    tree = {"w": torch.randn(3, 4, generator=torch.Generator().manual_seed(0)
                             ).to(torch.bfloat16),
            "n": np.arange(5, dtype=np.int32),
            "xs": [torch.ones(2), None,
                   {"b": torch.zeros(1, dtype=torch.float64)}],
            "empty": None}
    path = str(tmp_path / "sub" / "t.npz")
    save_pytree(path, tree, {"note": "x", "vals": [1, 2.5]})
    got, meta = load_pytree(path)
    assert meta == {"note": "x", "vals": [1, 2.5]}
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"],
                                                            tree["w"])
    assert got["n"].tolist() == list(range(5))
    assert isinstance(got["xs"], list) and got["xs"][1] is None
    assert got["xs"][2]["b"].dtype == torch.float64
    assert got["empty"] is None
    with pytest.raises(ValueError):
        save_pytree(path, tree, {"bad": float("nan")})
    assert os.listdir(tmp_path / "sub") == ["t.npz"]
    assert load_pytree(path)[1] == meta     # the failed write left it whole
