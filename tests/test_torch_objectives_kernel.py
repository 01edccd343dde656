"""The port's objectives and ensemble_fitness against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages. The
reference's Pallas kernels run in interpret mode, as tests/test_kernels.py
runs them. Tolerances are fp32: rtol 1e-5, atol 1e-6 (sums are taken in
another order than XLA's). The `cuda` case holds the CUDA kernel against
its plain version on the card and skips elsewhere.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import objectives as tobj  # noqa: E402
from repro_torch.kernels.ensemble_fitness import kernel as tkernel  # noqa: E402
from repro_torch.kernels.ensemble_fitness import ops as tops  # noqa: E402
from repro_torch.kernels.ensemble_fitness import ref as tref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here so the `cuda` case can run on a
    machine without JAX."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core import objectives
    from repro.kernels.ensemble_fitness import kernel, ref
    return SimpleNamespace(jax=jax, jnp=jnp, objectives=objectives,
                           kernel=kernel, ref=ref)


def _probs(rng, shape, zero_rows=True):
    """Softmax-like probabilities (..., V, C); with `zero_rows`, every
    fifth sample is all zeros, so argmax ties go to class 0."""
    p = rng.random(shape).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    if zero_rows:
        p[..., ::5, :] = 0.0
    return p


def _labels(rng, lead, V, C, pad):
    y = rng.integers(0, C, lead + (V,)).astype(np.int32)
    if pad:
        y[..., -pad:] = -1
    return y


def _pop(rng, lead, P, M):
    """0/1 populations whose rows hold k in {0, 1, 5} ones (k <= M)."""
    pop = np.zeros(lead + (P, M), np.float32)
    flat = pop.reshape(-1, P, M)
    for b in range(flat.shape[0]):
        for p in range(P):
            k = min((0, 1, 5)[p % 3], M)
            flat[b, p, rng.choice(M, k, replace=False)] = 1.0
    return pop


def _stats(rng, lead, M):
    acc = rng.random(lead + (M,)).astype(np.float32)
    a = rng.random(lead + (M, M)).astype(np.float32)
    S = (a + np.swapaxes(a, -1, -2)) / 2
    return acc, S


def _t(a):
    return torch.as_tensor(a)


def test_member_accuracy_similarity_match_reference(jx):
    rng = np.random.default_rng(0)
    M, V, C = 6, 40, 4
    probs = _probs(rng, (M, V, C))
    labels = _labels(rng, (), V, C, pad=7)
    np.testing.assert_array_equal(
        tobj.member_accuracy(_t(probs), _t(labels)).numpy(),
        np.asarray(jx.objectives.member_accuracy(probs, labels)))
    for lab in (labels, None):
        np.testing.assert_allclose(
            tobj.similarity_matrix(_t(probs), None if lab is None
                                   else _t(lab)).numpy(),
            np.asarray(jx.objectives.similarity_matrix(probs, lab)), **TOL)
    # leading client axis == the reference vmapped over clients
    bp = _probs(rng, (3, M, V, C))
    bl = _labels(rng, (3,), V, C, pad=5)
    np.testing.assert_array_equal(
        tobj.member_accuracy(_t(bp), _t(bl)).numpy(),
        np.asarray(jx.jax.vmap(jx.objectives.member_accuracy)(bp, bl)))
    np.testing.assert_allclose(
        tobj.similarity_matrix(_t(bp), _t(bl)).numpy(),
        np.asarray(jx.jax.vmap(jx.objectives.similarity_matrix)(bp, bl)),
        **TOL)


def test_all_zero_slot_scores_label0_fraction(jx):
    """An empty (all-zero) slot's accuracy is the label-0 fraction:
    argmax ties resolve to the first index in both packages."""
    rng = np.random.default_rng(1)
    labels = _labels(rng, (), 30, 3, pad=4)
    probs = np.zeros((2, 30, 3), np.float32)
    want = np.float32((labels == 0).sum()) / np.float32((labels >= 0).sum())
    got = tobj.member_accuracy(_t(probs), _t(labels)).numpy()
    np.testing.assert_array_equal(got, [want, want])
    np.testing.assert_array_equal(
        got, np.asarray(jx.objectives.member_accuracy(probs, labels)))


def test_population_objectives_and_ensemble_accuracy(jx):
    rng = np.random.default_rng(2)
    P, M, V, C = 9, 7, 30, 4
    pop = _pop(rng, (), P, M)
    acc, S = _stats(rng, (), M)
    for got, want in zip(
            tobj.population_objectives(_t(pop), _t(acc), _t(S)),
            jx.objectives.population_objectives(pop, acc, S)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    probs = _probs(rng, (M, V, C))
    labels = _labels(rng, (), V, C, pad=3)
    np.testing.assert_array_equal(
        tobj.ensemble_accuracy(_t(pop), _t(probs), _t(labels)).numpy(),
        np.asarray(jx.objectives.ensemble_accuracy(pop, probs, labels)))


@pytest.mark.parametrize("M", [7, 100])
@pytest.mark.parametrize("P", [5, 130, 256])
def test_fitness_plain_versions_match_pallas(jx, P, M):
    """Both entry points of the port's plain version (through ops.py on
    CPU tensors) against the reference's Pallas kernels in interpret mode
    and its ref.py."""
    rng = np.random.default_rng(P * 1000 + M)
    pop = _pop(rng, (), P, M)
    acc, S = _stats(rng, (), M)
    want = jx.kernel.ensemble_fitness(pop, acc, S, interpret=True)
    want_ref = jx.ref.ensemble_fitness_ref(pop, acc, S)
    got = tops.ensemble_fitness(_t(pop), _t(acc), _t(S))
    got_ref = tref.ensemble_fitness_ref(_t(pop), _t(acc), _t(S))
    for g, gr, w, wr in zip(got, got_ref, want, want_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        np.testing.assert_allclose(gr.numpy(), np.asarray(wr), **TOL)

    N = 2
    bpop = _pop(rng, (N,), P, M)
    bacc, bS = _stats(rng, (N,), M)
    want = jx.kernel.ensemble_fitness_batched(bpop, bacc, bS, interpret=True)
    got = tops.ensemble_fitness(_t(bpop), _t(bacc), _t(bS))   # rank 3
    got_b = tops.ensemble_fitness_batched(_t(bpop), _t(bacc), _t(bS))
    for g, gb, w in zip(got, got_b, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        np.testing.assert_array_equal(gb.numpy(), g.numpy())


def test_kernel_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper never falls back: a CPU tensor raises."""
    rng = np.random.default_rng(3)
    pop = _pop(rng, (1,), 4, 7)
    acc, S = _stats(rng, (1,), 7)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.ensemble_fitness_batched(_t(pop), _t(acc), _t(S))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("N,P,M", [(32, 200, 100), (32, 100, 100),
                                   (1, 100, 100), (3, 37, 320), (2, 1, 7)])
def test_cuda_kernel_matches_plain_version(cuda_device, N, P, M):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(N * P * M)
    pop = _t(_pop(rng, (N,), P, M)).to(cuda_device)
    acc, S = (_t(a).to(cuda_device) for a in _stats(rng, (N,), M))
    before = tkernel.KERNEL.launches
    got = tops.ensemble_fitness_batched(pop, acc, S)
    assert tkernel.KERNEL.launches == before + 1
    torch.cuda.synchronize()
    for g, w in zip(got, tref.ensemble_fitness_batched_ref(pop, acc, S)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    single = tops.ensemble_fitness(pop[0], acc[0], S[0])
    for g, w in zip(single, got):
        np.testing.assert_allclose(g.cpu().numpy(), w[0].cpu().numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_objectives_fn_matches_pallas(jx, lead):
    """ops.objectives_fn, what the selection scores every population with:
    (..., P, 2) strength and diversity against statistics bound once, on
    one client (P, M) or a client batch (N, P, M), as the reference's
    Pallas kernels compute them (interpret mode)."""
    rng = np.random.default_rng(11)
    pop = _pop(rng, lead, 23, 12)
    acc, S = _stats(rng, lead, 12)
    got = tops.objectives_fn(_t(acc), _t(S))(_t(pop))
    assert got.shape == lead + (23, 2)
    fn = (jx.kernel.ensemble_fitness_batched if lead
          else jx.kernel.ensemble_fitness)
    want = fn(jx.jnp.asarray(pop), jx.jnp.asarray(acc), jx.jnp.asarray(S),
              interpret=True)
    for i, w in enumerate(want):
        np.testing.assert_allclose(got[..., i].numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("bad", ["pop_cpu", "pop_shape", "pop_dtype",
                                 "acc_shape", "S_shape"])
def test_objectives_wrapper_raises(bad):
    """The kernel's Objectives checks acc and S once and pop at every
    call, and raises before any launch; nothing falls back."""
    rng = np.random.default_rng(12)
    pop = _t(_pop(rng, (2,), 6, 9))
    acc, S = (_t(a) for a in _stats(rng, (2,), 9))
    before = tkernel.KERNEL.launches
    if bad in ("acc_shape", "S_shape"):
        if bad == "acc_shape":
            acc = acc[0]
        else:
            S = S[:, :4]
        with pytest.raises(ValueError, match="shape"):
            tkernel.Objectives(acc, S)
    else:
        # statistics that pass the checks: fake the CUDA test on them
        obj = object.__new__(tkernel.Objectives)
        obj.N, obj.M, obj.acc, obj.S = 2, 9, acc, S
        if bad == "pop_shape":
            pop = pop[:, :, :5]
        elif bad == "pop_dtype":
            pop = pop.double()
        match = {"pop_cpu": "CUDA tensor", "pop_shape": "shape",
                 "pop_dtype": "float32"}[bad]
        with pytest.raises(ValueError, match=match):
            obj(pop)
    assert tkernel.KERNEL.launches == before


def _gather_case(rng, case):
    """(pop, acc, S) numpy inputs of the gather form's edge cases."""
    if case == "non_binary":       # rows of arbitrary values, k = sum
        N, P, M = 3, 40, 100
        pop = (rng.random((N, P, M)) * (rng.random((N, P, M)) < 0.06)
               ).astype(np.float32)
        pop[:, ::4] *= -1.5
    elif case == "zero_rows":
        N, P, M = 2, 64, 100
        pop = _pop(rng, (N,), P, M)
        pop[:, ::2] = 0.0
    elif case == "k1":
        N, P, M = 2, 50, 100
        pop = np.zeros((N, P, M), np.float32)
        pop[:, np.arange(P), rng.integers(0, M, P)] = 1.0
    elif case == "dense_320":
        N, P, M = 3, 37, 320
        pop = (rng.random((N, P, M)) < 0.5).astype(np.float32)
    else:                          # ragged: N P not a multiple of 8 rows
        N, P, M = 5, 13, 7
        pop = _pop(rng, (N,), P, M)
    return (pop,) + _stats(rng, (N,), M)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["non_binary", "zero_rows", "k1",
                                  "dense_320", "ragged"])
def test_cuda_gather_form_cases(cuda_device, case):
    """The gather form against the plain version on rows it has to get
    right beyond k = 5 ones: non-binary values, all-zero rows, k = 1,
    dense rows at M = 320 and N P not a multiple of a block's 8 rows;
    one launch a call, through both entry points and the objectives."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pop, acc, S = (_t(a).to(cuda_device) for a in
                   _gather_case(np.random.default_rng(13), case))
    want = tref.ensemble_fitness_batched_ref(pop, acc, S)
    before = tkernel.KERNEL.launches
    got = tops.ensemble_fitness_batched(pop, acc, S)
    assert tkernel.KERNEL.launches == before + 1
    objs = tops.objectives_fn(acc, S)(pop)
    assert tkernel.KERNEL.launches == before + 2
    single = tops.ensemble_fitness(pop[1], acc[1], S[1])
    assert tkernel.KERNEL.launches == before + 3
    torch.cuda.synchronize()
    assert objs.shape == pop.shape[:2] + (2,)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(objs[..., i].cpu().numpy(),
                                      g.cpu().numpy())
        np.testing.assert_allclose(single[i].cpu().numpy(),
                                   w[1].cpu().numpy(), rtol=1e-5, atol=1e-5)
