"""Each cell's run, driven on the CPU at the port's smoke widths with the
harness's look for a card skipped, and with its timed path broken
underneath in each way the cell can break: `correct` comes out false,
on a number that the same run without the fault keeps within its limit.
Score cells: a served token altered where it is produced; half of each
call's prompts left out (the rest's tokens standing in). Train cells: a
step that returns its state unchanged; half of each batch left out (the
mean over the rest). No cell runs on more than one card, so no exchange
between cards can be left out."""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from bench.run import run_cell  # noqa: E402

SEED = 2 ** 40 + 29


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell):
    return run_cell(cell, SEED, 0.1, False, torch.device("cpu"), time.time(),
                    smoke=True, log=lambda s: None)


def _caught(sound, broken):
    """The broken run fails a number the sound run keeps within limit."""
    assert not broken["correct"]
    return any(c["value"] > c["limit"] and sound["checks"][k]["ok"]
               for k, c in broken["checks"].items())


def _token_altered(monkeypatch):
    from repro_torch.launch import serve
    orig = serve.serve_batch
    monkeypatch.setattr(serve, "serve_batch",
                        lambda cfg, m, p, gen_len=16, weights=None:
                        (orig(cfg, m, p, gen_len, weights) + 1) % cfg.vocab)


def _half_prompts(monkeypatch):
    from repro_torch.launch import serve
    orig = serve.serve_batch
    monkeypatch.setattr(
        serve, "serve_batch", lambda cfg, m, p, gen_len=16, weights=None:
        orig(cfg, m, p[:p.shape[0] // 2], gen_len, weights).repeat(2, 1))


def _state_unchanged(monkeypatch):
    import repro_torch.optim as optim
    orig = optim.make_optimizer

    def frozen(name, **hp):
        def update(grads, state, params, lr, split=None):
            state["step"] += 1
        return dataclasses.replace(orig(name, **hp), update=update)
    monkeypatch.setattr(optim, "make_optimizer", frozen)


def _half_batch(monkeypatch):
    from repro_torch.launch import steps
    orig = steps.make_train_step

    def half(cfg, opt, lr_fn, **kw):
        step = orig(cfg, opt, lr_fn, **kw)
        return lambda p, s, b: step(p, s, {k: v[:v.shape[0] // 2]
                                           for k, v in b.items()})
    monkeypatch.setattr(steps, "make_train_step", half)


@pytest.mark.parametrize("cell,fault", [
    ("rwkv6-3b.score", _token_altered), ("rwkv6-3b.score", _half_prompts),
    ("zamba2-7b.score", _token_altered), ("zamba2-7b.score", _half_prompts),
    ("rwkv6-3b.train", _state_unchanged), ("rwkv6-3b.train", _half_batch)])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    sound = _run(cell)
    fault(monkeypatch)
    assert _caught(sound, _run(cell))
