"""Family modules (`bench/families/<equations>.py`) on the CPU. Each
configuration reads the numbers the harness read when its family's code
still sat in `weights.py`, `reference/models.py`, `costs.py` and the
kernel metrics: its members' draw at the port's smoke widths (a digest
of every tensor), its parameter and FLOP counts at full size, and each
kernel metric on a fixed synthetic trace. A toy family in a temporary
directory is found by its name and drives the weights, the reference
and the counts with no other file edited, and no file outside
`families/` names a family."""
from __future__ import annotations

import hashlib
import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from bench import costs, families, harness, reference, weights  # noqa: E402
from bench.drivers import score  # noqa: E402
from bench.reference import models  # noqa: E402

FIRST = {}
for _w in harness.benchmark()["workloads"]:
    FIRST.setdefault(_w["config"], _w["name"])
SEED = 2 ** 40 + 5
METRICS = ["ssd_scan_roofline", "flash_attention_roofline.score",
           "wkv_scan_roofline.score", "wkv_scan_roofline.train",
           "wkv_scan_bwd_roofline"]
# read before the move: digest of members 0 and 1 at SEED and smoke
# widths; count, count_applied and costs.score_flops at (4, 2048) at full
# size; each kernel metric on _trace()
PINS = {
    "rwkv6-3b": {
        "digest": "118aaacef27feba25f1da3e33ccab0df"
                  "f9024af575bcca3c2066efb5293af2b0",
        "count": 2522728960, "applied": 2522728960,
        "score_flops": 41520296099840.0,
        "metrics": [None, None, 9.255384615384614, 7.374328358208954,
                    6.50924583133482]},
    "zamba2-7b": {
        "digest": "23cb9e9ed4414a06f6f1f5170f9ecd05"
                  "615e4df81c670a23f318fb71bef6c62b",
        "count": 6727282896, "applied": 8988091600,
        "score_flops": 150124804964352.0,
        "metrics": [3.041869866354502, 15.915168027841137, None, None,
                    None]},
}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digest(flats) -> str:
    h = hashlib.sha256()
    for flat in flats:
        for n, t in flat.items():
            h.update(f"{n}{tuple(t.shape)}{t.dtype}".encode())
            h.update(t.contiguous().reshape(-1).view(torch.uint8).numpy()
                     .tobytes())
    return h.hexdigest()


def _trace():
    """Two traced calls, (4, 2048) and (2, 1024), each launching every
    scan kernel's parts and one flash kernel; one ssd launch before the
    first call (timed, not priced)."""
    def name(kernel, part):
        return f"void (anonymous namespace)::{kernel}_{part}" \
            "<__nv_bfloat16>(float*)"
    flash = ("void (anonymous namespace)::flash_fwd_bf16_wgmma<128>("
             "CUtensorMap, CUtensorMap, CUtensorMap, (anonymous "
             "namespace)::Params)")
    kernels = [(name("ssd_scan", "chunk"), 8e-4, -1)]
    for call in (0, 1):
        kernels += [(name("ssd_scan", p), t, call) for p, t in
                    (("cb", 1e-4), ("state", 2e-4), ("pass", 3e-5),
                     ("chunk", 8e-4))]
        kernels += [(name("wkv_scan", p), t, call) for p, t in
                    (("state", 1e-4), ("pass", 2e-5), ("chunk", 4e-4))]
        kernels += [(name("wkv_scan_bwd", p), t, call) for p, t in
                    (("state", 3e-4), ("pass", 5e-5), ("chunk", 7e-4),
                     ("du", 8e-6))]
        kernels.append((flash, 4.3e-4, call))
    return {"busy_s": 1.0, "window_s": 1.0, "kernels": kernels,
            "launches": len(kernels)}


def _run(arch):
    return {"arch": arch, "calls": [(4, 2048), (2, 1024)], "steps": 2,
            "microbatch": (2, 2048), "trace": _trace()}


@pytest.mark.parametrize("config", sorted(PINS))
def test_member_draw_is_pinned(config):
    cell = harness.Cell(FIRST[config])
    arch = score.smoke_arch(cell, score.port_config(cell, True))
    flats = [weights.make_member(arch, SEED, m, torch.device("cpu"))
             for m in range(2)]
    assert _digest(flats) == PINS[config]["digest"]


@pytest.mark.parametrize("config", sorted(PINS))
def test_counts_are_pinned(config):
    a, pin = harness.Cell(FIRST[config]).arch, PINS[config]
    assert weights.count(a) == pin["count"]
    assert weights.count_applied(a) == pin["applied"]
    assert costs.score_flops(a, pin["applied"], 4, 2048) == \
        pin["score_flops"]


@pytest.mark.parametrize("config", sorted(PINS))
@pytest.mark.parametrize("metric", METRICS)
def test_kernel_metric_is_pinned(config, metric):
    got = harness.read_layer_metric(metric,
                                    _run(harness.Cell(FIRST[config]).arch))
    assert got == PINS[config]["metrics"][METRICS.index(metric)]


def test_flash_operations_bound():
    """0.1217 ms a shared-block application at (4, 2048), from the
    family's (applications, heads, KV heads, head_dim)."""
    a = harness.Cell(FIRST["zamba2-7b"]).arch
    uses, H, _, hd = families.get(a).attention(a)
    assert (uses, H, hd) == (13, 32, 112)
    ms = costs.attention_flops(a, 4, 2048) / uses / costs.PEAK_BF16_FLOPS
    assert ms * 1e3 == pytest.approx(0.1217, abs=5e-5)


def test_ssd_groups_scale_bc():
    """The B/C bytes and the C B^T work scale with the groups; at one
    group the cost is the default's."""
    one, two = (costs.ssd_cost(4, 2048, 64, 64, 128, 2, g)[False]
                for g in (1, 2))
    assert one == costs.ssd_cost(4, 2048, 64, 64, 128, 2)[False]
    assert two[0] - one[0] == 2 * 2 * 4 * 2048 * 128
    assert two[1] == one[1] and two[2] == 2 * one[2]
    assert costs.ssd_bound_s(4, 2048, 64, 64, 128, 8) > \
        costs.ssd_bound_s(4, 2048, 64, 64, 128)


TOY = '''
from bench.reference import layers as L

NORMALS = {"gain": (1.0, 0.0)}


def layout(a):
    d, V, E = a["d_model"], a["vocab"], a["n_experts"]
    out = [("embed.embed", (V, d), "e"), ("embed.head", (d, V), "w"),
           ("final_norm", (d,), "norm")]
    for i in range(a["n_layers"]):
        out += [(f"layers.{i}.ln", (d,), "norm"),
                (f"layers.{i}.experts", (E, d, 4 * d), "w"),
                (f"layers.{i}.down", (4 * d, d), "w"),
                (f"layers.{i}.gain", (d,), "gain")]
    return out


def block(w, p, a, x):
    h = L.rms_norm(x, w(p + "ln"), a["norm_eps"])
    up = sum(h @ e for e in w(p + "experts"))
    return x + (up @ w(p + "down")) * w(p + "gain")


def blocks(a):
    return [(block, f"layers.{i}.") for i in range(a["n_layers"])]


def applied(a):
    return 1234


def scan_flops(a, B, S):
    return 0.0


def attention(a):
    return None


def ssd(a):
    return None


def wkv(a):
    return None
'''


def test_toy_family_is_found_by_name(tmp_path, monkeypatch):
    (tmp_path / "toy.py").write_text(TOY)
    arch = {"equations": "toy", "n_layers": 2, "d_model": 32,
            "n_experts": 3, "vocab": 64, "norm_eps": 1e-6}
    fam = families.get(arch, root=tmp_path)
    assert fam.applied(arch) == 1234
    with pytest.raises(FileNotFoundError):
        families.get(arch)
    with pytest.raises(ValueError):
        families.get({"equations": "../toy"}, root=tmp_path)
    monkeypatch.setattr(families, "ROOT", tmp_path)
    assert weights.layout(arch) == fam.layout(arch)
    flat = weights.make_member(arch, SEED, 0, torch.device("cpu"))
    assert flat["layers.1.experts"].shape == (3, 32, 128)
    assert flat["layers.1.experts"].dtype == torch.bfloat16
    # a stack draws with its matrices' fan-in, d, not with E
    std = float(flat["layers.1.experts"].float().std())
    assert std == pytest.approx(32 ** -0.5, rel=0.1)
    assert torch.equal(flat["layers.0.gain"], torch.ones(32))
    assert weights.count_applied(arch) == 1234
    tokens = torch.randint(0, 64, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    h = models.hidden(reference.exact_weights(flat), arch, tokens)
    assert h.shape == (2, 8, 32) and bool(torch.isfinite(h).all())
    head = 2 * 32 * 64 * 2
    assert costs.score_flops(arch, 1234, 2, 8) == 2 * 1234 * 2 * 8 + head
    for metric in METRICS:
        assert harness.read_layer_metric(metric, _run(arch)) is None


def test_no_family_named_outside_families():
    """Only `families/` and the tests name a family or test `equations`
    against a name."""
    names = [p.stem for p in (ROOT / "bench/families").glob("*.py")
             if p.stem != "__init__"]
    assert names
    quoted = re.compile("|".join(rf"[\"']{re.escape(n)}[\"']"
                                 for n in names))
    for path in (ROOT / "bench").rglob("*.py"):
        rel = path.relative_to(ROOT / "bench")
        if rel.parts[0] == "families" or path.name.startswith("test_"):
            continue
        text = path.read_text()
        assert not quoted.search(text), rel
        assert not re.search(r"equations\"\]\s*[!=]=", text), rel
