"""The paper's seven comparison methods (port of `repro/fl/baselines.py`).

Synchronous, server-based rounds (that is the point of comparison: FedPAE
is the only fully decentralized/asynchronous method in the table).

  fedavg     — McMahan et al. 2017, homogeneous cnn4
  fedprox    — + proximal term mu/2 ||w - w_global||^2
  feddistill — share per-class mean logits, distill to local models (het.)
  lg_fedavg  — average the homogeneous classifier head only (het. bodies)
  fedgh      — server trains a generalized global header on uploaded
               per-class feature prototypes (het. bodies)
  fml        — mutual distillation with a shared small aux model (cnn4)
  fedkd      — like FML with scheduled distillation weight + aux averaging
  local      — per-client local ensemble (in core/fedpae.py)

Every model is a `models.cnn.CNN` on `device` ("cuda" unless "cpu" is
asked). Gradients come from `torch.autograd.grad` and the SGD update `p -
lr * g` is applied in place, so each client's model is its own module:
a client that starts from the global model starts from a clone of it, and
a head copied into a model is copied, never shared.

The run's one `np.random.default_rng(fl.seed)` is drawn as the reference
draws it (round, then client, then local step); a round's indices cross
to the device in one copy, and each client's training set crosses once.
`init(family, seed, ccfg) -> CNN` (default `models.cnn.init_model`) is
called with the integer the reference passes to `jax.random.PRNGKey`, so
a caller can hand in the reference's weights. Training runs under
`fl.client.repeatable_cudnn`: a fixed seed gives the same bits on the
card.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fl.client import accuracy, predict_probs, repeatable_cudnn
from repro_torch.models.cnn import CNNConfig, init_model

DEFAULT_FAMILIES = ("cnn4", "vgg", "resnet", "densenet", "inception")
PROBE = 256   # training samples whose class means FedDistill / FedGH share


@dataclasses.dataclass
class FLConfig:
    rounds: int = 150
    local_steps: int = 4
    lr: float = 0.05
    batch: int = 32
    mu: float = 0.01          # fedprox
    beta: float = 1.0         # distillation weight
    families: tuple = DEFAULT_FAMILIES
    width: int = 16
    seed: int = 0


def _ce(logits, y):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, y[:, None]).mean()


def _kl(p_logits, q_logits, T=1.0):
    """KL(softmax(p) || softmax(q)) mean over batch."""
    p = torch.log_softmax(p_logits / T, dim=-1)
    q = torch.log_softmax(q_logits / T, dim=-1)
    return (p.exp() * (p - q)).sum(-1).mean()


def _avg(trees, weights):
    """Weighted mean of equal-length tensor lists. As the reference: the
    float64 weights are normalised, then each applies as a float32
    scalar, and the terms are summed left to right from 0."""
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    out = []
    for leaves in zip(*trees):
        acc = 0
        for wi, leaf in zip(w, leaves):
            acc = acc + float(np.float32(wi)) * leaf
        out.append(acc)
    return out


def _sample(rng, data, batch):
    """One minibatch's training-set indices, drawn as the reference's
    `_sample` draws them."""
    return rng.integers(0, len(data.x_tr), batch)


def _round_indices(rng, datasets, steps, batch, dev):
    """A round's draws in the reference's order (client, then step), in
    one copy to the device: (n_clients, steps, batch)."""
    idx = np.stack([np.stack([_sample(rng, d, batch) for _ in range(steps)])
                    for d in datasets])
    return torch.as_tensor(idx, dtype=torch.int64, device=dev)


def _ccfg(datasets, n_classes, fl):
    return CNNConfig(n_classes=n_classes, width=fl.width,
                     in_channels=datasets[0].x_tr.shape[-1])


def _families(datasets, fl):
    return [fl.families[i % len(fl.families)] for i in range(len(datasets))]


def _train_sets(datasets, dev):
    """Each client's training set on the device, once."""
    return [(torch.as_tensor(d.x_tr, device=dev),
             torch.as_tensor(d.y_tr, dtype=torch.int64, device=dev))
            for d in datasets]


def _leaves(model):
    return [p.detach() for p in model.parameters()]


@torch.no_grad()
def _sgd(params, grads, lr):
    for p, g in zip(params, grads):
        p.sub_(g * lr)


@torch.no_grad()
def _load(model, leaves):
    for p, t in zip(model.parameters(), leaves):
        p.copy_(t)


def _local_step(model, xb, yb, lr):
    """One SGD step on the cross-entropy."""
    params = list(model.parameters())
    _sgd(params, torch.autograd.grad(_ce(model(xb), yb), params), lr)


def _class_means(values, y, n_classes):
    """Per-class mean rows of `values` and the class counts (the
    reference's one-hot product)."""
    onehot = torch.nn.functional.one_hot(y, n_classes).to(values.dtype)
    sums = onehot.T @ values
    cnts = torch.clamp(onehot.sum(0)[:, None], min=1.0)
    return sums / cnts, onehot.sum(0)


def _accuracies(fams, ccfg, models, datasets):
    return np.array([accuracy(predict_probs(f, ccfg, m, d.x_te), d.y_te)
                     for f, m, d in zip(fams, models, datasets)])


# --------------------------------------------------------------------------
# FedAvg / FedProx
# --------------------------------------------------------------------------

def run_fedavg(datasets, n_classes, fl: FLConfig, prox: bool = False, *,
               device=None, init=None):
    dev = resolve_device(device)
    init = init or init_model
    ccfg = _ccfg(datasets, n_classes, fl)
    fam = "cnn4"
    mu = fl.mu if prox else 0.0
    rng = np.random.default_rng(fl.seed)
    g = init(fam, fl.seed, ccfg).to(dev)
    sizes = [len(d.x_tr) for d in datasets]
    train = _train_sets(datasets, dev)
    with repeatable_cudnn():
        for _ in range(fl.rounds):
            idx = _round_indices(rng, datasets, fl.local_steps, fl.batch, dev)
            pg = [t.clone() for t in _leaves(g)]   # fixed for the round
            locals_ = []
            for i, (x, y) in enumerate(train):
                p = copy.deepcopy(g)
                params = list(p.parameters())
                for s in range(fl.local_steps):
                    b = idx[i, s]
                    loss = _ce(p(x[b]), y[b])
                    if mu:
                        sq = sum(((a - c) ** 2).sum()
                                 for a, c in zip(params, pg))
                        loss = loss + 0.5 * mu * sq
                    _sgd(params, torch.autograd.grad(loss, params), fl.lr)
                locals_.append(_leaves(p))
            _load(g, _avg(locals_, sizes))
    return _accuracies([fam] * len(datasets), ccfg, [g] * len(datasets),
                       datasets)


# --------------------------------------------------------------------------
# FedDistill: share per-class mean logits
# --------------------------------------------------------------------------

def run_feddistill(datasets, n_classes, fl: FLConfig, *, device=None,
                   init=None):
    dev = resolve_device(device)
    init = init or init_model
    ccfg = _ccfg(datasets, n_classes, fl)
    fams = _families(datasets, fl)
    rng = np.random.default_rng(fl.seed)
    models = [init(f, fl.seed + i, ccfg).to(dev) for i, f in enumerate(fams)]
    train = _train_sets(datasets, dev)
    glob = np.zeros((n_classes, n_classes), np.float32)
    have = 0.0
    with repeatable_cudnn():
        for r in range(fl.rounds):
            idx = _round_indices(rng, datasets, fl.local_steps, fl.batch, dev)
            glob_t = torch.as_tensor(glob, device=dev)
            sums = np.zeros_like(glob)
            cnts = np.zeros((n_classes,), np.float32)
            for i, (x, y) in enumerate(train):
                m = models[i]
                for s in range(fl.local_steps):
                    b = idx[i, s]
                    xb, yb = x[b], y[b]
                    params = list(m.parameters())
                    logits = m(xb)
                    # the global mean logits of each sample's true class
                    loss = _ce(logits, yb) + fl.beta * have * (
                        (logits - glob_t[yb]) ** 2).mean()
                    _sgd(params, torch.autograd.grad(loss, params), fl.lr)
                with torch.no_grad():
                    cl, cc = _class_means(m(x[:PROBE]), y[:PROBE],
                                          n_classes)
                cc = cc.cpu().numpy()
                sums += cl.cpu().numpy() * cc[:, None]
                cnts += cc
            glob = sums / np.maximum(cnts, 1.0)[:, None]
            have = 1.0
    return _accuracies(fams, ccfg, models, datasets)


# --------------------------------------------------------------------------
# LG-FedAvg: average only the homogeneous head
# --------------------------------------------------------------------------

def run_lg_fedavg(datasets, n_classes, fl: FLConfig, *, device=None,
                  init=None):
    dev = resolve_device(device)
    init = init or init_model
    ccfg = _ccfg(datasets, n_classes, fl)
    fams = _families(datasets, fl)
    rng = np.random.default_rng(fl.seed)
    models = [init(f, fl.seed + i, ccfg).to(dev) for i, f in enumerate(fams)]
    sizes = [len(d.x_tr) for d in datasets]
    train = _train_sets(datasets, dev)
    with repeatable_cudnn():
        for r in range(fl.rounds):
            idx = _round_indices(rng, datasets, fl.local_steps, fl.batch, dev)
            for i, (x, y) in enumerate(train):
                for s in range(fl.local_steps):
                    b = idx[i, s]
                    _local_step(models[i], x[b], y[b], fl.lr)
            (head,) = _avg([[m.head.detach()] for m in models], sizes)
            with torch.no_grad():
                for m in models:
                    m.head.copy_(head)
    return _accuracies(fams, ccfg, models, datasets)


# --------------------------------------------------------------------------
# FedGH: server-side generalized global header on feature prototypes
# --------------------------------------------------------------------------

def _head_step(head, protos, labels, lr):
    h = head.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(_ce(protos @ h, labels), h)
    return (h - lr * g).detach()


def run_fedgh(datasets, n_classes, fl: FLConfig, *, device=None,
              init=None):
    dev = resolve_device(device)
    init = init or init_model
    ccfg = _ccfg(datasets, n_classes, fl)
    fams = _families(datasets, fl)
    rng = np.random.default_rng(fl.seed)
    models = [init(f, fl.seed + i, ccfg).to(dev) for i, f in enumerate(fams)]
    train = _train_sets(datasets, dev)
    head = init("cnn4", 0, ccfg).head.detach().to(dev)
    with repeatable_cudnn():
        for r in range(fl.rounds):
            idx = _round_indices(rng, datasets, fl.local_steps, fl.batch, dev)
            all_protos, all_labels = [], []
            for i, (x, y) in enumerate(train):
                m = models[i]
                with torch.no_grad():
                    m.head.copy_(head)
                for s in range(fl.local_steps):
                    b = idx[i, s]
                    _local_step(m, x[b], y[b], fl.lr)
                with torch.no_grad():
                    pr, cc = _class_means(m.features(x[:PROBE]), y[:PROBE],
                                          n_classes)
                present = cc.cpu().numpy() > 0   # classes the client holds
                all_protos.append(pr[torch.as_tensor(present, device=dev)])
                all_labels.append(np.where(present)[0])
            protos = torch.cat(all_protos)
            labels = torch.as_tensor(np.concatenate(all_labels),
                                     dtype=torch.int64, device=dev)
            for _ in range(5):
                head = _head_step(head, protos, labels, fl.lr)
    with torch.no_grad():
        for m in models:
            m.head.copy_(head)
    return _accuracies(fams, ccfg, models, datasets)


# --------------------------------------------------------------------------
# FML / FedKD: mutual distillation with a shared small auxiliary model
# --------------------------------------------------------------------------

def _mutual_step(big, aux, xb, yb, beta, lr):
    pb, pa = list(big.parameters()), list(aux.parameters())
    lb, la = big(xb), aux(xb)
    l_big = _ce(lb, yb) + beta * _kl(la.detach(), lb)
    l_aux = _ce(la, yb) + beta * _kl(lb.detach(), la)
    grads = torch.autograd.grad(l_big + l_aux, pb + pa)
    _sgd(pb + pa, grads, lr)


def run_fml(datasets, n_classes, fl: FLConfig, schedule_beta: bool = False,
            *, device=None, init=None):
    """FML (schedule_beta=False) / FedKD (True: distill weight ramps up)."""
    dev = resolve_device(device)
    init = init or init_model
    ccfg = _ccfg(datasets, n_classes, fl)
    fams = _families(datasets, fl)
    rng = np.random.default_rng(fl.seed)
    models = [init(f, fl.seed + i, ccfg).to(dev) for i, f in enumerate(fams)]
    aux_g = init("cnn4", fl.seed - 1, ccfg).to(dev)
    sizes = [len(d.x_tr) for d in datasets]
    train = _train_sets(datasets, dev)
    with repeatable_cudnn():
        for r in range(fl.rounds):
            beta = fl.beta * ((r + 1) / fl.rounds if schedule_beta else 1.0)
            beta = float(np.float32(beta))   # crosses as a float32 scalar
            idx = _round_indices(rng, datasets, fl.local_steps, fl.batch, dev)
            aux_locals = []
            for i, (x, y) in enumerate(train):
                aux = copy.deepcopy(aux_g)
                for s in range(fl.local_steps):
                    b = idx[i, s]
                    _mutual_step(models[i], aux, x[b], y[b], beta, fl.lr)
                aux_locals.append(_leaves(aux))
            _load(aux_g, _avg(aux_locals, sizes))
    return _accuracies(fams, ccfg, models, datasets)


def run_fedkd(datasets, n_classes, fl: FLConfig, **kw):
    return run_fml(datasets, n_classes, fl, schedule_beta=True, **kw)


BASELINES = {
    "fedavg": lambda d, n, fl, **kw: run_fedavg(d, n, fl, prox=False, **kw),
    "fedprox": lambda d, n, fl, **kw: run_fedavg(d, n, fl, prox=True, **kw),
    "feddistill": run_feddistill,
    "lg_fedavg": run_lg_fedavg,
    "fedgh": run_fedgh,
    "fml": run_fml,
    "fedkd": run_fedkd,
}
