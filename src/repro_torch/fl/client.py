"""Per-client local training of heterogeneous image classifiers (port of
`repro/fl/client.py`). Models live on the device they were trained on;
data crosses as numpy arrays and predictions come back as numpy."""
from __future__ import annotations

import contextlib
import copy
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call, stack_module_state, vmap

from repro_torch.device import resolve_device
from repro_torch.models.cnn import CNNConfig, init_model
from repro_torch.optim import make_optimizer

EVAL_CHUNK = 1024


@dataclasses.dataclass
class ClientData:
    x_tr: np.ndarray
    y_tr: np.ndarray
    x_va: np.ndarray
    y_va: np.ndarray
    x_te: np.ndarray
    y_te: np.ndarray


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def predict_probs(family: str, cfg: CNNConfig, params, x: np.ndarray
                  ) -> np.ndarray:
    """Chunked inference of one model (`params` is its `CNN` module) ->
    (N, C) probabilities (np.float32)."""
    dev = _device_of(params)
    outs = [torch.softmax(params(torch.as_tensor(x[i:i + EVAL_CHUNK],
                                                 device=dev)), dim=-1)
            for i in range(0, len(x), EVAL_CHUNK)]
    return torch.cat(outs).cpu().numpy() if outs else \
        np.zeros((0, cfg.n_classes), np.float32)


@torch.no_grad()
def predict_probs_batched(family: str, cfg: CNNConfig, params_seq,
                          x: np.ndarray) -> np.ndarray:
    """Batched multi-model inference: ALL of one family's models on `x`
    in one batched forward per chunk (`torch.func.vmap` over the stacked
    parameters) -> (n_models, N, C)."""
    models = list(params_seq)
    stacked, _ = stack_module_state(models)
    base = copy.deepcopy(models[0]).to("meta")
    dev = _device_of(models[0])

    def probs(p, xb):
        return torch.softmax(functional_call(base, p, (xb,)), dim=-1)

    batched = vmap(probs, in_dims=(0, None))
    outs = [batched(stacked, torch.as_tensor(x[i:i + EVAL_CHUNK],
                                             device=dev))
            for i in range(0, len(x), EVAL_CHUNK)]
    return torch.cat(outs, dim=1).cpu().numpy()


def accuracy(probs: np.ndarray, y: np.ndarray) -> float:
    return float((probs.argmax(-1) == y).mean())


@contextlib.contextmanager
def repeatable_cudnn():
    """Scope in which cuDNN picks only deterministic algorithms, and picks
    them by its heuristics rather than by timing (`benchmark` off): the
    convolutions' backward then sums in one order every run, so a fixed
    seed gives the same trained bits. The previous flags come back on
    exit, so nothing outside local training (LLM serving and training in
    the same process) changes. cuBLAS needs nothing here: its products
    on one stream are repeatable without a workspace setting."""
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = prev


def train_local_model(family: str, cfg: CNNConfig, seed: int,
                      data: ClientData, *, lr: float = 0.05,
                      batch: int = 32, max_epochs: int = 60,
                      patience: int = 8, opt_name: str = "momentum",
                      device=None):
    """Train one model with early stopping on the client's validation set
    (the paper's protocol: the best-validation checkpoint is kept).
    Minibatch indices come from `np.random.default_rng(seed)` drawn as
    the reference draws them; one epoch's indices cross to the device in
    one copy, so the steps of an epoch never wait on the host. Training
    runs under `repeatable_cudnn`, so on the card too the result is a
    function of the seed and the data alone.

    Returns (best_model, best_val_acc, history)."""
    dev = resolve_device(device)
    model = init_model(family, seed, cfg).to(dev)
    params = list(model.parameters())
    opt = make_optimizer(opt_name)
    state = opt.init(params)
    rng = np.random.default_rng(seed)
    x_tr = torch.as_tensor(data.x_tr, device=dev)
    y_tr = torch.as_tensor(data.y_tr, dtype=torch.int64, device=dev)
    n = len(data.x_tr)
    steps_per_epoch = max(1, n // batch)

    best_acc, since_best = -1.0, 0
    best = [p.detach().clone() for p in params]
    history = []
    with repeatable_cudnn():
        for _ in range(max_epochs):
            idx = torch.as_tensor(
                np.stack([rng.integers(0, n, batch)
                          for _ in range(steps_per_epoch)]), device=dev)
            for step in range(steps_per_epoch):
                loss = F.cross_entropy(model(x_tr[idx[step]]),
                                       y_tr[idx[step]])
                grads = torch.autograd.grad(loss, params)
                opt.update(grads, state, params, lr)
            va = accuracy(predict_probs(family, cfg, model, data.x_va),
                          data.y_va)
            history.append(va)
            if va > best_acc:
                best_acc, since_best = va, 0
                best = [p.detach().clone() for p in params]
            else:
                since_best += 1
                if since_best >= patience:
                    break
    with torch.no_grad():
        for p, b in zip(params, best):
            p.copy_(b)
    return model, best_acc, history
