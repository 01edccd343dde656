"""The benchmark's reference and weights against the port, on the CPU at
the port's smoke widths: for every score cell of BENCHMARK.json, the
weight layout matches the port's parameter tree, and the reference's
float32 forward and soft vote agree with the port's CPU path in float32;
so does the training step."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from bench import harness, reference, weights  # noqa: E402
from bench.drivers import score  # noqa: E402
from bench.reference import layers, models  # noqa: E402

CELLS = [w["name"] for w in harness.benchmark()["workloads"]
         if harness.Cell(w["name"]).kind == "score"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke(cell_name, dtype="float32"):
    cell = harness.Cell(cell_name)
    cfg = score.port_config(cell, True).replace(dtype=dtype)
    return cell, cfg, score.smoke_arch(cell, cfg)


@pytest.mark.parametrize("cell_name", CELLS)
def test_layout_matches_port_params(cell_name):
    from repro_torch.models import transformer as tf
    _, cfg, arch = _smoke(cell_name, "bfloat16")
    want = {n: (tuple(p.shape), p.dtype) for n, p in
            tf.init_params(cfg, torch.Generator().manual_seed(0))
            .named_parameters()}
    flat = weights.make_member(arch, 7, 0, torch.device("cpu"))
    got = {n: (tuple(t.shape), t.dtype) for n, t in flat.items()}
    assert got == want
    built = dict(weights.port_params(flat).named_parameters())
    assert list(built) == list(want)
    assert all(built[n].data_ptr() == flat[n].data_ptr() for n in flat)


def test_member_draw_is_seeded():
    _, _, arch = _smoke("rwkv6-3b.score", "bfloat16")
    a = weights.make_member(arch, 2 ** 40 + 3, 1, torch.device("cpu"))
    b = weights.make_member(arch, 2 ** 40 + 3, 1, torch.device("cpu"))
    c = weights.make_member(arch, 2 ** 40 + 3, 2, torch.device("cpu"))
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["layers.0.rwkv.wr"], c["layers.0.rwkv.wr"])


@pytest.mark.parametrize("cell_name", CELLS)
def test_reference_logits_match_port_fp32(cell_name):
    from repro_torch.models import transformer as tf
    _, cfg, arch = _smoke(cell_name)
    flat = weights.make_member(arch, 11, 0, torch.device("cpu"),
                               low_dtype=torch.float32)
    tokens = torch.randint(0, arch["vocab"], (2, 32),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, _ = tf.forward(weights.port_params(flat), cfg, tokens,
                            mode="prefill", cache_len=33)
        want = models.last_logits(reference.exact_weights(flat), arch,
                                  tokens)
    err = (got[:, -1] - want).abs().max() / want.abs().max()
    assert float(err) < 1e-5


@pytest.mark.parametrize("cell_name", CELLS)
def test_vote_matches_port_serve_batch(cell_name):
    """The reference's vote ranks first the token the port serves in
    float32, and its log probability of the port's vote is the port's."""
    from repro_torch.launch import serve
    _, cfg, arch = _smoke(cell_name)
    flats = [weights.make_member(arch, 5, m, torch.device("cpu"),
                                 low_dtype=torch.float32) for m in range(3)]
    tokens = torch.randint(0, arch["vocab"], (2, 16),
                           generator=torch.Generator().manual_seed(2))
    served = serve.serve_batch(cfg, [weights.port_params(f) for f in flats],
                               tokens, gen_len=1)
    lp = reference.vote_logprobs(arch, flats, tokens)
    assert torch.equal(lp.argmax(-1), served[:, 0].long())


def test_scans_match_their_recurrences():
    g = torch.Generator().manual_seed(3)
    B, S, nh, hd = 2, 64, 3, 8
    r, k, v = (torch.randn(B, S, nh, hd, generator=g) for _ in range(3))
    logw = -torch.exp(torch.randn(B, S, nh, hd, generator=g) * 0.3 - 1)
    u = torch.randn(nh, hd, generator=g)
    s = torch.zeros(B, nh, hd, hd)
    ys = []
    for t in range(S):
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s)
                  + (r[:, t] * u * k[:, t]).sum(-1, keepdim=True) * v[:, t])
        s = s * logw[:, t].exp()[..., None] \
            + k[:, t][..., None] * v[:, t][:, :, None]
    want = torch.stack(ys, 1)
    assert torch.allclose(layers.wkv(r, k, v, logw, u), want, atol=1e-4)

    ds = 5
    x = torch.randn(B, S, nh, hd, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, S, nh, generator=g))
    a_log = torch.randn(nh, generator=g) * 0.2
    Bm, Cm = (torch.randn(B, S, ds, generator=g) for _ in range(2))
    D = torch.randn(nh, generator=g)
    h = torch.zeros(B, nh, hd, ds)
    ys = []
    for t in range(S):
        dec = torch.exp(dt[:, t] * -torch.exp(a_log))
        h = h * dec[..., None, None] \
            + (dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, None, None, :]
        ys.append(torch.einsum("bhds,bs->bhd", h, Cm[:, t]) + D[:, None]
                  * x[:, t])
    want = torch.stack(ys, 1)
    assert torch.allclose(layers.ssd(x, dt, a_log, Bm, Cm, D), want,
                          atol=1e-4)


def test_fp8_control_rounds_below_bf16():
    w = torch.randn(64, 32, generator=torch.Generator().manual_seed(4))
    q = reference.fp8_round(w)
    rel = ((q - w).abs() / w.abs().amax(0)).max()
    assert 1e-3 < float(rel) < 0.07


def test_fp8_control_rounds_stacks():
    """A 3-d bf16 stack goes through float8 matrix by matrix, each with
    its own scale per output column; a 2-d leaf rounds as it did with one
    scale per column (amax over dim 0); fp32 leaves stay exact."""
    g = torch.Generator().manual_seed(5)
    stack = (torch.randn(3, 64, 32, generator=g)
             * torch.tensor([1.0, 10.0, 0.1])[:, None, None]).bfloat16()
    mat = torch.randn(64, 32, generator=g).bfloat16()
    vec = torch.randn(32, generator=g)
    w = reference.fp8_weights({"stack": stack, "mat": mat, "vec": vec})
    got = w("stack")
    assert not torch.equal(got, stack.float())
    for e in range(3):
        assert torch.equal(got[e], reference.fp8_round(stack[e]))
    m = mat.float()
    s = m.abs().amax(dim=0, keepdim=True).clamp_min(1e-12) / 448.0
    assert torch.equal(w("mat"), (m / s).to(torch.float8_e4m3fn).float() * s)
    assert torch.equal(w("vec"), vec)


def test_reference_training_matches_port_fp32():
    """Three steps of the port's train step (adamw, warmup_cosine, two
    microbatches) in float32 against the reference's."""
    from bench.drivers import train
    cell = harness.Cell("rwkv6-3b.train")
    cfg = train.port_config(cell, True).replace(dtype="float32")
    arch = train.smoke_arch(cell, cfg)
    mix = cell.traffic
    dev = torch.device("cpu")
    flat = weights.make_member(arch, 13, 0, dev, low_dtype=torch.float32)
    p0 = {n: t.clone() for n, t in flat.items()}
    params = weights.port_params(flat)
    opt, step_fn = train.make_step(cfg, mix)
    named = dict(params.named_parameters())
    state = opt.init(named)
    losses = []
    for t in range(mix["checked_steps"]):
        losses.append(float(step_fn(params, state, train.batch(
            mix, 13, t, arch["vocab"], dev, True))))
        if t == 0:
            g1 = {n: float(m.norm()) / (1 - mix["optimizer"]["b1"])
                  for n, m in zip(named, state["m"])}
    prog = {"losses": losses, "grad_norm": g1,
            "change_norm": {n: float((p.detach() - p0[n]).norm())
                            for n, p in named.items()}}
    from bench.reference import train as rtrain
    batches = [tuple(train.batch(mix, 13, t, arch["vocab"], dev,
                                 True).values())
               for t in range(mix["checked_steps"])]
    ref = rtrain.train(arch, p0, batches, mix)
    gaps = train.compare(prog, ref, arch, 13, dev)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-4
    assert gaps["change_gap"] < 1e-3
