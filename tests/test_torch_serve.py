"""The port's ensemble serving against the reference's `serve_batch` on
the same weights (carried across by `params_from_jax`) and the same
numpy prompts: smoke llama3-8b in fp32 with attn_impl="pallas" (the
reference's Pallas kernel in interpret mode, the port's plain version on
CPU tensors). Greedy tokens must be equal; the seed is one whose soft
vote keeps a top-1/top-2 probability gap above 1e-4 at every step, which
the test checks, so equality does not hinge on rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

SEED, GEN = 1, 6
MIN_GAP = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_smoke("llama3-8b").replace(dtype="float32",
                                           attn_impl="pallas")
    cfg = get_smoke("llama3-8b").replace(dtype="float32", attn_impl="pallas")
    key = jax.random.PRNGKey(SEED)
    jparams = [jtf.init_params(jcfg, jax.random.fold_in(key, i))
               for i in range(2)]
    members = [ttf.params_from_jax(cfg, jax.tree.map(np.asarray, p))
               for p in jparams]
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32)
    return jcfg, cfg, jparams, members, prompts


def _soft_vote(cfg, members, weights, seq):
    """The ensemble's probabilities at every position of `seq` (one full
    forward per member: the decode steps' inputs, teacher-forced)."""
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    with torch.no_grad():
        return sum(float(wi) * torch.softmax(
            ttf.forward(m, cfg, torch.as_tensor(seq))[0].float(), dim=-1)
            for wi, m in zip(w, members)).numpy()


def test_serve_batch_matches_reference(setup):
    jcfg, cfg, jparams, members, prompts = setup
    want = np.asarray(jserve.serve_batch(jcfg, jparams, jnp.asarray(prompts),
                                         gen_len=GEN))
    got = tserve.serve_batch(cfg, members, torch.as_tensor(prompts),
                             gen_len=GEN)
    assert got.dtype == torch.int32 and got.shape == (2, GEN)
    np.testing.assert_array_equal(got.numpy(), want)
    # every step's vote is decided by more than rounding
    S = prompts.shape[1]
    seq = np.concatenate([prompts, want[:, :-1]], axis=1)
    probs = _soft_vote(cfg, members, [1, 1], seq)[:, S - 1:]
    np.testing.assert_array_equal(probs.argmax(-1), want)
    top2 = np.sort(probs, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > MIN_GAP


def test_weighted_decode_degenerate(setup):
    """weights=[1, 0] reduce the soft vote to member 0's own greedy
    decode (tests/test_launch.py:89-104), in the port and the reference
    alike."""
    jcfg, cfg, jparams, members, prompts = setup
    solo = tserve.serve_batch(cfg, members[:1], torch.as_tensor(prompts),
                              gen_len=GEN)
    masked = tserve.serve_batch(cfg, members, torch.as_tensor(prompts),
                                gen_len=GEN, weights=[1.0, 0.0])
    np.testing.assert_array_equal(solo.numpy(), masked.numpy())
    want = jserve.serve_batch(jcfg, jparams[:1], jnp.asarray(prompts),
                              gen_len=GEN)
    np.testing.assert_array_equal(solo.numpy(), np.asarray(want))
    blended = tserve.serve_batch(cfg, members, torch.as_tensor(prompts),
                                 gen_len=GEN, weights=[0.7, 0.3])
    assert blended.shape == (2, GEN) and int(blended.max()) < cfg.vocab


def test_main_runs_on_cpu(capsys):
    tserve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                 "--gen-len", "3", "--ensemble", "2"])
    out = capsys.readouterr().out
    assert "ensemble=2 device=cpu generated (2, 3)" in out
