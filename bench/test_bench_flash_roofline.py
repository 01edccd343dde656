"""`metrics/flash_attention_roofline.score.py` on synthetic traces: None
without a trace or traced calls, without flash launches (a prefill on the
plain path) and for rwkv6-3b (no attention); otherwise each launch is
priced at its call's (B, L) as costs.attention_flops over the shared
blocks' applications, at the bf16 peak, over the launches' device time."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from bench import costs, harness  # noqa: E402

NAME = "flash_attention_roofline.score"
ZAMBA = json.loads((ROOT / "bench/configs/zamba2-7b.json").read_text())[
    "as_run"]
RWKV = json.loads((ROOT / "bench/configs/rwkv6-3b.json").read_text())[
    "as_run"]
BF16 = ("void (anonymous namespace)::flash_fwd_bf16_wgmma<128>(CUtensorMap, "
        "CUtensorMap, CUtensorMap, (anonymous namespace)::Params)")
F32 = "void (anonymous namespace)::flash_fwd_f32<112>((anonymous " \
    "namespace)::Params)"
SCAN = "void (anonymous namespace)::ssd_scan_chunk<__nv_bfloat16>(float*)"
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8_stage3"


def _run(arch, kernels, calls):
    return {"arch": arch, "calls": calls,
            "trace": {"busy_s": 1.0, "window_s": 1.0, "kernels": kernels,
                      "launches": len(kernels)}}


def _read(run):
    return harness.read_layer_metric(NAME, run)


def test_none_without_flash_launches():
    calls = [(4, 2048)]
    plain = [(SCAN, 8e-4, 0), (GEMM, 1.5e-3, 0)]
    assert _read(_run(ZAMBA, plain, calls)) is None
    assert _read(_run(ZAMBA, [], calls)) is None
    assert _read({"arch": ZAMBA, "calls": calls, "trace": None}) is None
    assert _read(_run(ZAMBA, [(BF16, 4e-4, 0)], [])) is None
    assert _read(_run(RWKV, [(BF16, 4e-4, 0)], calls)) is None


def test_bound_per_launch_at_its_call():
    """13 applications a member: one launch each, the call's (B, L) sets
    the bound; a launch before the first traced call is timed but not
    priced, as the scan rooflines do."""
    uses = ZAMBA["n_layers"] // ZAMBA["shared_attn_every"]
    assert uses == 13
    # 4 B H hd L (L + 1) / 2: QK^T and PV over the causal pairs
    per = 4 * 4 * 32 * 112 * 2048 * 2049 / 2
    assert costs.attention_flops(ZAMBA, 4, 2048) / uses == pytest.approx(per)
    assert per / costs.PEAK_BF16_FLOPS * 1e3 == pytest.approx(0.1217,
                                                              abs=5e-5)
    calls = [(4, 2048), (2, 1024)]
    kernels = ([(BF16, 3.9e-4, -1)] + [(BF16, 3.9e-4, 0)] * 2 * uses
               + [(SCAN, 8e-4, 0)] + [(F32, 2e-4, 1)] * 2 * uses)
    flops = 2 * uses * sum(costs.attention_flops(ZAMBA, B, L) / uses
                           for B, L in calls)
    secs = 3.9e-4 * (2 * uses + 1) + 2e-4 * 2 * uses
    assert _read(_run(ZAMBA, kernels, calls)) == pytest.approx(
        100.0 * flops / (costs.PEAK_BF16_FLOPS * secs))
    at_bound = [(BF16, per / costs.PEAK_BF16_FLOPS, 0)] * (2 * uses)
    assert _read(_run(ZAMBA, at_bound, calls[:1])) == pytest.approx(100.0)
