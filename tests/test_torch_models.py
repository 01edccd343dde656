"""The port's CNN families, optimizer step and batched forward against the
JAX reference, with the reference's own weights carried across by
`params_from_jax`. Tolerances: logits atol 1e-4 (convolutions sum in
another order), parameters after one momentum step atol 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.fl import client as jclient  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.fl import client as tclient  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402

FAMILIES = ("cnn4", "vgg", "resnet", "densenet", "inception")
JCFG = jcnn.CNNConfig(n_classes=5, width=8, in_channels=3)
_apply = jax.jit(jcnn.apply_model, static_argnums=0)


def _jparams(family, seed):
    p = jcnn.init_model(family, jax.random.PRNGKey(seed), JCFG)
    return {k: np.asarray(v) for k, v in p.items()}


def _images(seed, n, size):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("size", [10, 8])
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_reference(family, size):
    params = _jparams(family, 3)
    x = _images(size, 6, size)
    want = np.asarray(_apply(family, params, jnp.asarray(x)))
    model = tcnn.params_from_jax(family, params)
    assert model.cfg == tcnn.CNNConfig(n_classes=5, width=8, in_channels=3)
    with torch.no_grad():
        got = model(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_resnet_stride2_same_padding_is_asymmetric():
    """SAME padding of a stride-2 3x3 conv on an even input pads 0 low,
    1 high: symmetric padding=1 would shift every window."""
    x = torch.as_tensor(_images(0, 2, 10)).permute(0, 3, 1, 2)
    w = torch.randn((4, 3, 3, 3), generator=torch.Generator().manual_seed(0))
    want = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x, (0, 1, 0, 1)), w, stride=2)
    assert torch.equal(tcnn.conv(x, w, stride=2), want)
    assert not torch.allclose(
        torch.nn.functional.conv2d(x, w, stride=2, padding=1), want)


@pytest.mark.parametrize("family", ["cnn4", "resnet", "densenet"])
def test_one_momentum_step_matches_reference(family):
    params = _jparams(family, 4)
    x = _images(5, 16, 8)
    y = np.random.default_rng(6).integers(0, 5, 16).astype(np.int32)
    opt, train_step, _ = jclient._step_fns(family, JCFG, "momentum", 16)
    state = opt.init(params)
    for _ in range(2):   # two steps: the second one reads the momentum
        params, state, _ = train_step(params, state, jnp.asarray(x),
                                      jnp.asarray(y), jnp.float32(0.05))
    model = tcnn.params_from_jax(family, _jparams(family, 4))
    tparams = list(model.parameters())
    topt = make_optimizer("momentum")
    tstate = topt.init(tparams)
    for _ in range(2):
        loss = torch.nn.functional.cross_entropy(
            model(torch.as_tensor(x)), torch.as_tensor(y, dtype=torch.int64))
        topt.update(torch.autograd.grad(loss, tparams), tstate, tparams,
                    0.05)
    want = tcnn.params_from_jax(family, {k: np.asarray(v)
                                         for k, v in params.items()})
    for (name, got), ref in zip(model.named_parameters(),
                                want.parameters()):
        np.testing.assert_allclose(got.detach().numpy(),
                                   ref.detach().numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("family", ["vgg", "inception"])
def test_predict_probs_batched_matches_per_model(family):
    models = [tcnn.params_from_jax(family, _jparams(family, s))
              for s in range(3)]
    x = _images(9, 1100, 8)     # more than one EVAL_CHUNK
    got = tclient.predict_probs_batched(family, models[0].cfg, models, x)
    assert got.shape == (3, 1100, 5)
    for m, g in zip(models, got):
        np.testing.assert_allclose(
            g, tclient.predict_probs(family, m.cfg, m, x), atol=1e-6)
    want = jclient.predict_probs_batched(
        family, JCFG, [_jparams(family, s) for s in range(3)], x[:64])
    np.testing.assert_allclose(got[:, :64], want, atol=1e-5)
