"""Local CNN training is a function of its seed and data.

`fl.client.train_local_model` runs under `repeatable_cudnn`: cuDNN takes
only deterministic algorithms, chosen by heuristics, and the flags it
found come back afterwards. On the CPU two trainings from one seed give
the same bits; on the card (`cuda` marker) so must they, for every
family, with the same validation history.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.fl.client import (ClientData,  # noqa: E402
                                   repeatable_cudnn, train_local_model)
from repro_torch.models.cnn import CNNConfig  # noqa: E402

FAMILIES = ("cnn4", "vgg", "resnet", "densenet", "inception")


def _data(seed=0, n=256, size=10, n_classes=5):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n)
    x = rng.normal(size=(n, size, size, 3)).astype(np.float32)
    x[np.arange(n), 0, 0, 0] += 2.0 * y       # a learnable signal
    parts = np.split(np.arange(n), [n // 2, 3 * n // 4])
    return ClientData(*(a for ix in parts for a in (x[ix], y[ix])))


def _train_twice(family, device, epochs):
    cfg = CNNConfig(n_classes=5, width=8, in_channels=3)
    data = _data()
    runs = [train_local_model(family, cfg, 7, data, max_epochs=epochs,
                              patience=epochs, device=device)
            for _ in range(2)]
    (m1, a1, h1), (m2, a2, h2) = runs
    return ([p.detach().cpu() for p in m1.parameters()],
            [p.detach().cpu() for p in m2.parameters()], (a1, h1), (a2, h2))


def test_scope_restores_the_flags():
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic, cudnn.benchmark
    try:
        cudnn.deterministic, cudnn.benchmark = False, True
        with repeatable_cudnn():
            assert cudnn.deterministic and not cudnn.benchmark
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
        with pytest.raises(RuntimeError):
            with repeatable_cudnn():
                raise RuntimeError("a failed step")
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    finally:
        cudnn.deterministic, cudnn.benchmark = before


@pytest.mark.parametrize("family", ["cnn4", "resnet"])
def test_cpu_training_is_bitwise_repeatable(family):
    p1, p2, r1, r2 = _train_twice(family, "cpu", epochs=2)
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert r1 == r2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the nondeterminism is cuDNN's")


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_cuda_training_is_bitwise_repeatable(cuda, family):
    p1, p2, r1, r2 = _train_twice(family, "cuda", epochs=3)
    differ = [i for i, (a, b) in enumerate(zip(p1, p2))
              if not torch.equal(a, b)]
    assert not differ, f"parameters {differ} differ between two runs"
    assert r1 == r2
