"""The five span readers (`metrics/prefill_device_ms.score.py` and
`metrics/*_share.train.py`, through `bench/spans.py`) on the CPU at the
port's smoke widths: `serve_batch` with 2 members and `make_train_step`
with 2 microbatches under a CPU profiler. The step shares are positive
and the device reading None (no CUDA events on the CPU); a step's four
phases sum to no more than the whole of it; every reader is None with
no trace or with fewer roots than the run's calls or steps; and the
served tokens, the losses and the parameters are bit-identical with and
without the profiler."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from bench import harness  # noqa: E402
from bench import spans as bspans  # noqa: E402

SCORE = ("prefill_device_ms.score",)
TRAIN = ("forward_share.train", "backward_share.train",
         "accumulate_share.train", "optimizer_share.train")
TRACE = {"busy_s": 1.0, "window_s": 1.0}      # a traced run's stand-in


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def store(monkeypatch):
    from repro_torch.obs import spans
    s = spans.SpanStore()
    monkeypatch.setattr(spans, "STORE", s)
    return s


def _maybe_profiled(on, fn):
    if not on:
        return fn()
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def _serve(on):
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import transformer as tf
    cfg = get_smoke("rwkv6-3b")
    members = [tf.init_params(cfg, torch.Generator().manual_seed(i))
               for i in range(2)]
    g = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, cfg.vocab, (2, 8), generator=g)
               for _ in range(2)]
    return _maybe_profiled(on, lambda: [serve_batch(cfg, members, p,
                                                    gen_len=2)
                                        for p in prompts])


def _train(on):
    from repro_torch.configs import get_smoke
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import make_optimizer, warmup_cosine
    cfg = get_smoke("rwkv6-3b")
    params = tf.init_params(cfg, torch.Generator().manual_seed(3))
    opt = make_optimizer("adamw", weight_decay=0.01)
    state = opt.init(dict(params.named_parameters()))
    step = make_train_step(cfg, opt, warmup_cosine(1e-3, warmup=1,
                                                   total_steps=4),
                           microbatches=2)
    g = torch.Generator().manual_seed(11)
    batches = [{"tokens": torch.randint(0, cfg.vocab, (4, 16), generator=g),
                "labels": torch.randint(0, cfg.vocab, (4, 16), generator=g)}
               for _ in range(2)]
    losses = _maybe_profiled(on, lambda: [step(params, state, b)
                                          for b in batches])
    return losses, params


def _read(name, run):
    return harness.read_layer_metric(name, run)


def test_score_readers(store):
    plain = _serve(False)
    assert len(store.spans) == 0
    traced = _serve(True)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    run = {"trace": TRACE, "calls": [(2, 8), (2, 8)], "members": 2}
    for name in SCORE:                                  # no CUDA events
        assert _read(name, run) is None, name
    (call,) = bspans.traced_roots(run, "serve.call", 1)
    assert [c["labels"] for c in call["children"]] == [{"member": 0},
                                                       {"member": 1}]
    assert all(c["host_ms"] > 0 for c in call["children"])
    assert call["self_host_ms"] > 0                     # the vote
    for bad in ({"calls": run["calls"]}, {"trace": TRACE, "calls": []},
                {"trace": TRACE, "calls": [(2, 8)] * 3}):
        for name in SCORE:
            assert _read(name, bad) is None, (name, bad)


def test_train_readers(store):
    l0, p0 = _train(False)
    assert len(store.spans) == 0
    l1, p1 = _train(True)
    assert [float(x) for x in l0] == [float(x) for x in l1]
    for (n, a), b in zip(p0.named_parameters(), p1.parameters()):
        assert torch.equal(a, b), n
    run = {"trace": TRACE, "steps": 2}
    got = {name: _read(name, run) for name in TRAIN}
    assert all(v > 0 for v in got.values()), got
    assert sum(got.values()) <= 100.0
    roots = bspans.traced_roots(run, "train.step", 2)
    kids = [c["host_ms"] for r in roots for c in r["children"]
            if c["name"] == "train.optimizer"]
    assert got["optimizer_share.train"] == pytest.approx(
        100.0 * sum(kids) / sum(r["host_ms"] for r in roots))
    for r in roots:
        assert [c["name"] for c in r["children"]] == [
            "train.accumulate", "train.forward", "train.backward",
            "train.accumulate", "train.forward", "train.backward",
            "train.accumulate", "train.accumulate", "train.optimizer"]
    for bad in ({"steps": 2}, {"trace": TRACE, "steps": 0},
                {"trace": TRACE, "steps": 3}):
        for name in TRAIN:
            assert _read(name, bad) is None, (name, bad)


def test_readers_none_without_the_span_store(monkeypatch, store):
    """As on a port without `obs/spans.py`: the import fails, the
    readers return None."""
    import repro_torch.obs as obs
    from repro_torch.obs.spans import span

    def roots():
        for root, kids in (("serve.call", ["serve.prefill"]),
                           ("train.step", ["train.forward", "train.backward",
                                           "train.accumulate",
                                           "train.optimizer"])):
            with span(root):
                for k in kids:
                    with span(k):
                        torch.ones(2).sum()
    _maybe_profiled(True, roots)
    run = {"trace": TRACE, "calls": [(2, 8)], "steps": 1}
    assert all(_read(n, run) >= 0 for n in TRAIN)
    monkeypatch.delattr(obs, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    for name in SCORE + TRAIN:
        assert _read(name, run) is None


def test_one_microbatch_has_no_accumulate(store):
    from repro_torch.configs import get_smoke
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import make_optimizer
    cfg = get_smoke("rwkv6-3b")
    params = tf.init_params(cfg, torch.Generator().manual_seed(5))
    opt = make_optimizer("adamw")
    state = opt.init(dict(params.named_parameters()))
    step = make_train_step(cfg, opt, lambda t: 1e-3)
    b = {"tokens": torch.zeros(2, 8, dtype=torch.long),
         "labels": torch.ones(2, 8, dtype=torch.long)}
    _maybe_profiled(True, lambda: step(params, state, b))
    (r,) = bspans.traced_roots({"trace": TRACE}, "train.step", 1)
    assert [c["name"] for c in r["children"]] == [
        "train.forward", "train.backward", "train.optimizer"]
    assert _read("accumulate_share.train",
                 {"trace": TRACE, "steps": 1}) is None
