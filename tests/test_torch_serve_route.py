"""The route of `serve_batch`'s prefill: the members' prefill runs under
`attn_impl="pallas"` wherever flash_attention computes the config's own
attention (`attention.kernel_computes`), on CPU prompts (the kernel's
plain version) as on CUDA prompts (the kernel).

The CPU cases check the predicate and the route for every architecture of
the zoo (full configs). The `cuda` case serves smoke zamba2-7b, whose
config keeps the plain "xla" path, on the card: its 2 shared-block
applications a member launch the kernel; each member's log-probabilities
at every position lie no farther from a float32 forward of the same
weights than `F32_ROOM` times the plain bf16 path's; and the served token
is the plain vote's on a seed whose top-1/top-2 gap the test checks. On
the card the two bf16 paths lie about 0.05 from each other and from
float32 at worst; a kernel whose output is zeroed, unmasked or mis-scaled
moves the log-probabilities by 0.57 or more (seeds 6-8).
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from _torch_threads import one_thread as _one_thread  # noqa: F401
from repro_torch.configs import get_config, get_smoke, list_archs
from repro_torch.launch import serve
from repro_torch.models import transformer as tf
from repro_torch.models.attention import kernel_computes

# where the kernel would serve another function, or the plain core
# serves either way
PLAIN = {"gemma2-27b": "local windows on every other layer",
         "qwen3-moe-235b-a22b": "the g_major head layout"}
F32_ROOM = 2.0         # the kernel's distance to float32 over the plain's
MIN_GAP = 2e-3         # the plain vote's top-1 over top-2, every row
SEED = 6               # members drawn on the CPU; smallest gap 3.0e-3


@pytest.mark.parametrize("arch", list_archs())
def test_kernel_computes(arch):
    cfg = get_config(arch)
    assert kernel_computes(cfg) == (arch not in PLAIN), PLAIN.get(arch)
    # a decode window is applied by the plain core in the prefill, not by
    # the kernel; a head dim the kernel is not built for
    assert not kernel_computes(cfg.replace(decode_window=512))
    assert not kernel_computes(cfg.replace(head_dim=96))
    # the kernel takes a softcap
    assert kernel_computes(cfg.replace(attn_logit_softcap=30.0)) == \
        (arch not in PLAIN)


@pytest.mark.parametrize("arch", list_archs())
def test_route(arch, monkeypatch):
    """The members' prefill gets the kernel's route where the predicate
    holds and `cfg` itself elsewhere."""
    cfg = get_config(arch)
    routed = cfg if arch in PLAIN else cfg.replace(attn_impl="pallas")
    seen = []

    def forward(params, c, tokens, **kw):
        seen.append(c)
        B, S = tokens.shape
        return torch.zeros(B, S, 8), None

    monkeypatch.setattr(tf, "forward", forward)
    out = serve.serve_batch(cfg, [None, None],
                            torch.zeros(2, 4, dtype=torch.int64), gen_len=1)
    assert out.shape == (2, 1)
    assert seen == [routed, routed]
    assert serve.prefill_config(cfg) == routed
    windowed = cfg.replace(decode_window=512)
    assert serve.prefill_config(windowed) is windowed


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _logp(cfg, members, prompts):
    """Each member's prefill log-probabilities at every position."""
    with torch.inference_mode():
        return [torch.log_softmax(tf.forward(
            m, cfg, prompts, mode="prefill")[0].float(), dim=-1)
            for m in members]


def _gap(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


@pytest.mark.cuda
def test_cuda_zamba2_shared_attention_takes_the_kernel(cuda_device):
    from repro_torch.kernels.flash_attention import kernel
    cfg = get_smoke("zamba2-7b")
    assert cfg.attn_impl == "xla"
    uses = cfg.n_layers // cfg.shared_attn_every
    members = [tf.init_params(cfg, torch.Generator().manual_seed(2 * SEED + i))
               .to(cuda_device) for i in range(2)]
    prompts = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (2, 128)), device=cuda_device)
    before = kernel.KERNEL.launches
    toks = serve.serve_batch(cfg, members, prompts, gen_len=1)
    torch.cuda.synchronize()
    assert kernel.KERNEL.launches == before + len(members) * uses
    plain = _logp(cfg, members, prompts)
    exact = _logp(cfg.replace(dtype="float32"),
                  [copy.deepcopy(m).float() for m in members], prompts)
    assert kernel.KERNEL.launches == before + len(members) * uses
    routed = _logp(serve.prefill_config(cfg), members, prompts)
    assert kernel.KERNEL.launches == before + 2 * len(members) * uses
    assert _gap(routed, exact) <= F32_ROOM * _gap(plain, exact)
    vote = sum(0.5 * lp[:, -1].exp() for lp in plain)
    top2 = vote.topk(2, dim=-1).values
    assert float((top2[:, 0] - top2[:, 1]).min()) > MIN_GAP
    assert torch.equal(toks[:, 0].long(), vote.argmax(dim=-1))
