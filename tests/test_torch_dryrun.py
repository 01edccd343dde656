"""The port's dry run (`launch/dryrun.py`), roofline (`roofline/`) and
`fedpae_pods.dryrun` against the reference, on the CPU.

The collective accounting against the reference's HLO parser on the
same three collectives; `probe_plan`, `active_params` and `model_flops`
for every arch x shape; every full config's parameter count on `meta`
against the reference's `count_params(jax.eval_shape(...))`; a dry run
of smoke configs on small fake worlds (the reference's record keys, read
from its source, and the probe extrapolation equal to the full-depth
count); both pod primitives traced on a small fake world.
"""
import ast
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import get_config, get_smoke, list_archs  # noqa
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import fedpae_pods  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.roofline import analysis as troof  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
REF_DRYRUN = os.path.join(REPO, "src", "repro", "launch", "dryrun.py")


@pytest.fixture(scope="module")
def ref():
    """The reference's dry-run parser, roofline and configs. Importing
    its dryrun module sets XLA_FLAGS for a 512-device host; the variable
    is put back so later subprocesses of this worker do not inherit it."""
    pytest.importorskip("jax")
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdry
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    import jax

    from repro.configs import get_config as jget_config
    from repro.launch import shapes as jshapes
    from repro.launch import steps as jsteps
    from repro.models import transformer as jtf
    from repro.roofline import analysis as jroof
    return jax, jdry, jget_config, jshapes, jsteps, jtf, jroof


def test_collective_bytes_equal_the_hlo_parser(ref):
    """tests/test_launch.py's three collectives, as HLO for the
    reference's parser and as ledger events for the port's."""
    jdry = ref[1]
    hlo = """
      %ag = bf16[16,128]{1,0} all-gather(%x), replica_groups={{0,1,2,3}}
      %ar = f32[64]{0} all-reduce(%y), replica_groups={{0,1}}
      %rs = f32[8,8]{1,0} reduce-scatter(%z), replica_groups={{0,1,2,3}}
    """
    events = [("all-gather", torch.bfloat16, (16, 128), 4),
              ("all-reduce", torch.float32, (64,), 2),
              ("reduce-scatter", torch.float32, (8, 8), 4)]
    assert tdry.collective_bytes(events, 4) == jdry.parse_collectives(hlo, 4)


def test_ledger_records_each_helper():
    """Each helper of launch/mesh.py records (op, dtype, local result
    shape, group size) on a fake world of 4 (data 2, model 2)."""
    with tdry.FakeWorld(4):
        mesh = tmesh.make_host_mesh(2, 2, device="meta")
        t = torch.empty((4, 6), device="meta")
        with tmesh.record_collectives() as ev:
            tmesh.all_reduce_over(t, mesh, ("data",))
            tmesh.all_gather_over(t, mesh, "model", 1)
            tmesh.reduce_scatter_over(t, mesh, "model", 0)
            tmesh.all_to_all_over(t, mesh, "model", 0, 1)
    assert ev == [("all-reduce", torch.float32, (4, 6), 2),
                  ("all-gather", torch.float32, (4, 12), 2),
                  ("reduce-scatter", torch.float32, (2, 6), 2),
                  ("all-to-all", torch.float32, (2, 12), 2)]
    assert not dist.is_initialized()


def test_probe_plan_and_model_flops_equal_the_reference(ref):
    _, jdry, jget_config, jshapes, _, _, jroof = ref
    n = 0
    for arch in list_archs():
        for name, shape in tshapes.SHAPES.items():
            cfg = tshapes.arch_for_shape(get_config(arch), shape)
            jcfg = jshapes.arch_for_shape(jget_config(arch),
                                          jshapes.SHAPES[name])
            assert tdry.probe_plan(cfg) == jdry.probe_plan(jcfg), arch
            for n_params in (10 ** 9, 480 * 10 ** 9):
                assert troof.active_params(cfg, n_params) == \
                    jroof.active_params(jcfg, n_params)
                assert troof.model_flops(cfg, shape, n_params) == \
                    jroof.model_flops(jcfg, jshapes.SHAPES[name], n_params)
            assert troof.attention_score_elems(cfg, shape, 256) == \
                jroof.attention_score_elems(jcfg, jshapes.SHAPES[name], 256)
            n += 1
    assert n == 40


@pytest.mark.parametrize("arch", list_archs())
def test_meta_param_count_equals_the_reference(ref, arch):
    jax, _, jget_config, _, jsteps, jtf, _ = ref
    want = jsteps.count_params(jax.eval_shape(
        lambda: jtf.init_params(jget_config(arch), jax.random.PRNGKey(0))))
    got = sum(t.numel() for t in ttf.init_params(
        get_config(arch), tdry.MetaGen()).parameters())
    assert got == want


def _ref_record_keys():
    """The keys of the reference's record (`res = {...}` in its
    run_one), and those of its "memory" entry, from its source."""
    tree = ast.parse(open(REF_DRYRUN).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and getattr(node.targets[0], "id", "") == "res":
            keys = {k.value for k in node.value.keys}
            mem = next(v for k, v in zip(node.value.keys, node.value.values)
                       if k.value == "memory")
            return keys, {k.value for k in mem.keys}
    raise AssertionError("no record in the reference's dry run")


# (arch, config overrides, shape, (data, model)): depths with probes that
# are not the whole model, each step kind, the sharded layouts' families
DRY_CASES = [("llama3-8b", {"n_layers": 6}, "train_4k", (2, 2)),
             ("zamba2-7b", {"n_layers": 7}, "prefill_32k", (2, 4)),
             ("qwen3-moe-235b-a22b", {"n_layers": 5}, "decode_32k", (2, 2)),
             ("rwkv6-3b", {"n_layers": 4}, "long_500k", (2, 2))]


@pytest.mark.parametrize("arch,over,shape,dims", DRY_CASES)
def test_dry_run_record(ref, arch, over, shape, dims, tmp_path):
    """A smoke config's record on a small fake world: the reference's
    keys, strict JSON, positive counts, n_params the config's, and (the
    run raises otherwise) the probes' extrapolation equal to the
    full-depth FLOPs and collective bytes."""
    cfg = get_smoke(arch).replace(**over)
    rec = tdry.run_one(arch, shape, False, probes=True, cfg=cfg, dims=dims)
    keys, mem_keys = _ref_record_keys()
    assert set(rec) == keys and set(rec["memory"]) == mem_keys
    path = tmp_path / "rec.json"
    path.write_text(json.dumps(rec, allow_nan=False))
    assert json.loads(path.read_text()) == rec
    assert rec["mesh"] == f"{dims[0]}x{dims[1]}"
    assert rec["n_devices"] == math.prod(dims)
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["n_params"] == sum(t.numel() for t in ttf.init_params(
        tshapes.arch_for_shape(cfg, tshapes.SHAPES[shape]),
        tdry.MetaGen()).parameters())
    assert sum(rec["collective_counts_scan"].values()) > 0
    terms = troof.roofline_terms(rec)
    assert terms["step_lower_bound_s"] > 0
    assert not dist.is_initialized()


def test_pods_dryrun_on_a_small_world():
    """Both pod primitives on a (pod 2, data 1, model 2) fake world: the
    exchange moves one member's bytes a device (permute x 1), the vote's
    FLOPs are one member's forward on the request batch."""
    out = fedpae_pods.dryrun(dims=(2, 1, 2))
    cfg = get_smoke("llama3-8b")
    member = ttf.init_params(cfg, tdry.MetaGen())
    assert out["exchange_bytes_per_device"] == sum(
        t.numel() * t.element_size() for t in member.parameters())
    toks = torch.empty((4, 32), dtype=torch.int32, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ttf.forward(member, cfg, toks, mode="train", last_only=True)
    assert out["vote_flops_per_device"] == fc.get_total_flops() > 0
    assert not dist.is_initialized()


def test_roofline_constants_are_the_h100s():
    """The constants are the H100 SXM data sheet's; the score-element
    bytes are the port's own count of its plain attention (36)."""
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    from repro_torch.models.attention import attn_core

    def count(H, S, hd=128):
        q = torch.empty((1, S, H, hd), dtype=torch.bfloat16, device="meta")
        pos = torch.arange(S, dtype=torch.int32, device="meta")
        c = tdry._Bytes()
        with c:
            attn_core(q, q, q, pos, pos, torch.tensor(
                0, dtype=torch.int32, device="meta"), 0.0)
        return c.total
    # bytes a head: a S^2 + b S; a is the score element's
    r1 = (count(8, 512) - count(4, 512)) / 4
    r2 = (count(8, 1024) - count(4, 1024)) / 4
    b = (r2 - 4 * r1) / (1024 - 4 * 512)
    assert (r1 - b * 512) / 512 ** 2 == troof.BYTES_PER_SCORE_ELEM


def test_analyze_all_reads_records(tmp_path):
    rec = tdry.run_one("llama3-8b", "prefill_32k", False,
                       cfg=get_smoke("llama3-8b"), dims=(1, 2))
    rec["mesh"] = "16x16"
    (tmp_path / "a.json").write_text(json.dumps(rec, allow_nan=False))
    rows = troof.analyze_all(str(tmp_path), mesh="16x16")
    assert len(rows) == 1 and rows[0]["dominant"] in (
        "compute", "memory", "collective")
    assert "| llama3-8b | prefill_32k |" in troof.markdown_table(rows)


def test_kernel_wrappers_take_their_plain_versions_on_meta():
    """The dry run's route: each wrapper runs its plain version on meta
    tensors (shapes out, no kernel, no raise)."""
    from repro_torch.kernels.ensemble_fitness.ops import ensemble_fitness
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.wkv_scan.ops import wkv_scan

    def m(*shape):
        return torch.empty(shape, device="meta")
    assert flash_attention(m(1, 8, 4, 32), m(1, 8, 2, 32),
                           m(1, 8, 2, 32)).shape == (1, 8, 4, 32)
    y, h = ssd_scan(m(1, 8, 2, 4), m(1, 8, 2), m(2), m(1, 8, 3),
                    m(1, 8, 3), m(2), chunk=4)
    assert y.shape == (1, 8, 2, 4) and h.shape == (1, 2, 4, 3)
    y, s = wkv_scan(m(1, 8, 2, 4), m(1, 8, 2, 4), m(1, 8, 2, 4),
                    m(1, 8, 2, 4), m(2, 4), chunk=4)
    assert y.shape == (1, 8, 2, 4) and s.device.type == "meta"
    out = ensemble_fitness(m(3, 5), m(5), m(5, 5))
    assert all(t.device.type == "meta" for t in out)
