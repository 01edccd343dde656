"""The harness on the CPU: every cell, configuration, mix and metric of
BENCHMARK.json loads by name; names and units outside the allowed
characters are refused; the traffic is seeded and its length cycle is
the same on every seed; the copied cost functions equal chip_smoke.py's
at PERF.md's shapes; a smoke run loads no JAX module; a run with its
timed path broken reads `correct` false."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from bench import costs, gen, harness  # noqa: E402

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 40 + 17


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = harness.Cell(name)
    assert cell.entry["config"] in {c["name"] for c in BENCH["configs"]}
    assert cell.driver().run
    e2e = {m["name"] for m in cell.metrics("end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    moved = {m["moves"] for m in cell.metrics("per_layer")}
    assert moved and moved <= e2e
    for m in cell.metrics("per_layer"):
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()


def test_config_files_hold_their_sources():
    for c in BENCH["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert sorted(f["reduced"]) == sorted(c["reduced"])
        assert {"assumed", "departures", "as_run"} <= set(f)


def test_published_numbers_kept():
    """zamba2-7b's file holds its published config.json's numbers (no key
    is cut)."""
    f = json.loads((ROOT / "bench/configs/zamba2-7b.json").read_text())
    for k, v in {"hidden_size": 3584, "num_hidden_layers": 81,
                 "mamba_d_state": 64, "n_mamba_heads": 112,
                 "attention_head_dim": 224, "vocab_size": 32000,
                 "intermediate_size": 14336}.items():
        assert f[k] == v


@pytest.mark.parametrize("bad", ["", "has space", "a,b", "x/y", ".dot",
                                 "μs", "a" * 65])
def test_bad_names_refused(bad):
    with pytest.raises(ValueError):
        harness.check_name(bad)


@pytest.mark.parametrize("bad", ["", "tokens per s", "μs", "a" * 17])
def test_bad_units_refused(bad):
    with pytest.raises(ValueError):
        harness.check_unit(bad)


def test_good_names_and_units():
    for n in ("rwkv6-3b.score", "wkv_scan_roofline.train", "setup_s"):
        harness.check_name(n)
    for u in ("tokens/s", "%", "s", "launches"):
        harness.check_unit(u)


def _mix(name):
    return json.loads((harness.BENCH / "traffic" / f"{name}.json")
                      .read_text())


def _calls(mix, seed, n=64):
    it = gen.score_calls(mix, seed)
    return [next(it) for _ in range(n)]


def test_score_traffic_is_seeded_and_its_cycle_fixed():
    """The score mix: four prompts of 2048 tokens a call on every seed;
    the seed draws the tokens."""
    mix = _mix("score-slice")
    a, b, c = _calls(mix, SEED), _calls(mix, SEED), _calls(mix, SEED + 1)
    assert a == b
    assert {L for _, L, _ in a + c} == {2048}
    assert [x[2] for x in a] == [True] * 64
    p = gen.prompts(mix, SEED, 3, 2048, 65536)
    assert p.shape == (4, 2048)
    assert np.array_equal(p, gen.prompts(mix, SEED, 3, 2048, 65536))
    assert not np.array_equal(p, gen.prompts(mix, SEED, 4, 2048, 65536))
    assert not np.array_equal(p, gen.prompts(mix, SEED + 1, 3, 2048, 65536))
    assert gen.length_cycle(mix, smoke=True) == [16] * 4


def test_lognormal_length_cycle_is_seed_independent():
    """A log-normal length mix: the seed orders its cycle, never changes
    it; the blocks carry nearly the same work."""
    mix = dict(_mix("score-slice"), lengths={
        "dist": "lognormal", "median": 1024, "sigma": 0.8, "quantiles": 32,
        "min": 256, "max": 4096, "multiple": 256, "smoke_min": 8})
    a, c = _calls(mix, SEED), _calls(mix, SEED + 1)
    assert a != c
    for run in (a, c):
        for k in range(0, 64, 32):
            assert sorted(L for _, L, _ in run[k:k + 32]) == \
                gen.length_cycle(mix)
    lens = gen.length_cycle(mix)
    assert min(lens) == 256 and max(lens) == 4096
    assert all(L % 256 == 0 for L in lens)
    sums = [sum(b) for b in gen.blocks(mix)]
    assert max(sums) / min(sums) < 1.15


def test_train_traffic_is_seeded():
    mix = _mix("local-train")
    t1, _ = gen.train_batch(mix, SEED, 0, 65536)
    t2, _ = gen.train_batch(mix, SEED, 0, 65536)
    t3, _ = gen.train_batch(mix, SEED, 1, 65536)
    assert t1.shape == (4, 2048) and np.array_equal(t1, t2)
    assert not np.array_equal(t1, t3)


def _chip_smoke():
    return harness.load(ROOT / "chip_smoke.py", "chip_smoke_costs")


@pytest.mark.parametrize("shape", [(4, 2048, 112, 64, 64),
                                   (4, 2048, 28, 64, 64),
                                   (2, 4096, 112, 64, 64),
                                   (2, 256, 112, 64, 64)])
def test_ssd_cost_is_chip_smokes(shape):
    cs = _chip_smoke()
    assert costs.ssd_cost(*shape, 2) == cs.ssd_cost(*shape, 2)
    assert costs.roofline(*costs.ssd_cost(*shape, 2)[False], False, 2) == \
        cs.roofline(*cs.ssd_cost(*shape, 2)[False], False, 2)


@pytest.mark.parametrize("shape", [(4, 2048, 40, 64), (2, 2048, 40, 64),
                                   (2, 4096, 40, 64), (2, 256, 40, 64)])
def test_wkv_costs_are_chip_smokes(shape):
    cs = _chip_smoke()
    for s0 in (False, True):
        assert costs.wkv_cost(*shape, 2, s0) == cs.wkv_cost(*shape, 2, s0)
    assert costs.wkv_bwd_cost(*shape, 2) == cs.wkv_bwd_cost(*shape, 2)
    assert costs.roofline(*costs.wkv_cost(*shape, 2, True)[False], False,
                          2, costs.TERMS_F32) == \
        cs.roofline(*cs.wkv_cost(*shape, 2, True)[False], False, 2,
                    cs.TERMS_F32)
    assert (costs.PEAK_BF16_FLOPS, costs.PEAK_BYTES,
            costs.PEAK_FP32_FLOPS) == (cs.PEAK_BF16_FLOPS, cs.PEAK_BYTES,
                                       cs.PEAK_FP32_FLOPS)


def test_kernel_table_bounds():
    """PERF.md's kernel table: wkv_scan's bound 0.076690 ms at (4, 2048,
    40, 64) with s0, ssd_scan's 0.074027 ms at (4, 2048, 112, 64, 64)."""
    assert costs.wkv_bound_s(4, 2048, 40, 64) * 1e3 == pytest.approx(
        0.076690, abs=5e-7)
    assert costs.ssd_bound_s(4, 2048, 112, 64, 64) * 1e3 == pytest.approx(
        0.074027, abs=5e-7)


def test_trace_reading():
    """busy seconds are the union of device intervals inside the window;
    gaps are labelled by the innermost host op."""
    from bench import trace
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "cpu_op", "name": "inner", "ts": 40, "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 80, "dur": 10}]
    r = trace.read_events(ev)
    assert [c for _, _, c in r["kernels"]] == [-1, -1]
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(40e-6)
    assert r["launches"] == 2
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps["inner"] == pytest.approx(40e-6)
    assert gaps["outer"] == pytest.approx(20e-6)


def test_trace_attributes_launches_to_calls():
    """A kernel belongs to the last CALL span that started before it."""
    import re

    from bench import trace
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
           "ts": 0, "dur": 100}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": trace.CALL,
            "ts": t, "dur": 30} for t in (10, 50)]
    ev += [{"ph": "X", "cat": "kernel", "name": f"void x_scan_chunk{i}(int)",
            "ts": t, "dur": 5} for i, t in enumerate((5, 12, 30, 55, 70))]
    r = trace.read_events(ev)
    assert trace.launch_calls(r, re.compile(r"scan")) == [-1, 0, 0, 1, 1]
    assert trace.launch_counts(r, re.compile(r"chunk[34]")) == {
        "void x_scan_chunk3(int)": 1, "void x_scan_chunk4(int)": 1}


def test_shared_blocks_count_once_per_application():
    """zamba2-7b's two shared blocks are applied 13 times: the model FLOP
    count takes each block's parameters once per application."""
    from bench import weights
    z = json.loads((ROOT / "bench/configs/zamba2-7b.json").read_text())
    a = z["as_run"]
    block = 4 * 3584 ** 2 + 3 * 3584 * 14336 + 2 * 3584   # and 2 norms
    assert weights.count_applied(a) - weights.count(a) == 11 * block
    r = json.loads((ROOT / "bench/configs/rwkv6-3b.json").read_text())
    assert weights.count_applied(r["as_run"]) == weights.count(r["as_run"])


def test_smoke_run_loads_no_jax():
    """A smoke cell driven end to end in a fresh process leaves no module
    of JAX or of the JAX package (`repro`) in sys.modules."""
    code = (
        "import sys, time, torch; torch.set_num_threads(1);"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}];"
        "from bench.run import run_cell; from bench import harness;"
        "r = run_cell('rwkv6-3b.score', 5, 0.1, False, torch.device('cpu'),"
        " time.time(), smoke=True, log=lambda s: None);"
        "assert r['correct'], r;"
        "print('LOADED', harness.loaded_jax())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout


def test_loaded_jax_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro_torch_fake" not in harness.loaded_jax()
    monkeypatch.setitem(sys.modules, "repro.fake_sub", object())
    assert "repro.fake_sub" in harness.loaded_jax()


def test_result_line_keys_and_checks_last():
    line = harness.result_line(True, 4, 0, {"setup_s": {"value": 1.0,
                                                        "unit": "s"}},
                               {"platform": "gpu"},
                               {"vote_gap": {"value": 0.1, "limit": 0.5,
                                             "ok": True}})
    d = json.loads(line)
    assert list(d) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]


def test_cuda_run_refuses_without_a_card(tmp_path):
    """bench/run.py exits non-zero and prints no result without CUDA (the
    CPU here) and in a checkout that holds only the benchmark's files."""
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            shutil.copytree(ROOT / "bench", tmp_path / "bench",
                            ignore=shutil.ignore_patterns("__pycache__"))
            (tmp_path / "BENCHMARK.json").write_text(
                (ROOT / "BENCHMARK.json").read_text())
        out = subprocess.run(
            [sys.executable, "bench/run.py", "--workload", CELLS[0],
             "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
            capture_output=True, text=True, timeout=120,
            env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert out.stdout.strip() == ""
