"""The port's flash attention against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages (bf16
inputs are rounded from the same fp32 draws in both). The reference's
Pallas kernel runs in interpret mode, as tests/test_kernels.py runs it.
Tolerances are those of tests/test_kernels.py:70,83: fp32 atol = rtol =
2e-5, bf16 2e-2 (a bf16 output is rounded in other places in the two
packages). The `cuda` cases hold the CUDA kernel against its plain
version on the card and skip elsewhere.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as tkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402

SHAPES = [  # (B, H, KV, Sq, Sk, hd), tests/test_kernels.py:54-58
    (2, 4, 4, 256, 256, 64),
    (1, 8, 2, 128, 384, 64),
    (1, 4, 1, 64, 64, 32),
    (1, 2, 2, 1, 256, 64),     # decode
    (1, 4, 2, 128, 128, 112),  # zamba2-7b's shared attention head dim
]
VARIANTS = [(0, 0.0), (64, 0.0), (0, 30.0), (32, 50.0)]  # (window, softcap)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here so the `cuda` cases can run on a
    machine without JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention import kernel, ops, ref
    return SimpleNamespace(jnp=jnp, kernel=kernel, ops=ops, ref=ref)


def _qkv(seed, B, H, KV, Sq, Sk, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, hd)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, hd)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, hd)).astype(np.float32))


def _t(a, dtype, device="cpu"):
    return torch.as_tensor(a).to(device=device, dtype=getattr(torch, dtype))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_reference(jx, shape, dtype):
    arrs = _qkv(0, *shape)
    jq, jk, jv = (jx.jnp.asarray(a, getattr(jx.jnp, dtype)) for a in arrs)
    want = jx.kernel.flash_attention(jq, jk, jv, interpret=True)
    want_ref = jx.ref.flash_attention_ref(jq, jk, jv)
    got = tref.flash_attention_ref(*(_t(a, dtype) for a in arrs))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
    _close(got, want_ref, dtype)


@pytest.mark.parametrize("window,softcap", VARIANTS)
def test_plain_version_variants_match_reference(jx, window, softcap):
    arrs = _qkv(1, 2, 4, 2, 256, 256, 64)
    jq, jk, jv = (jx.jnp.asarray(a) for a in arrs)
    want = jx.kernel.flash_attention(jq, jk, jv, window=window,
                                     softcap=softcap, interpret=True)
    got = tref.flash_attention_ref(*(_t(a, "float32") for a in arrs),
                                   window=window, softcap=softcap)
    _close(got, want, "float32")


@pytest.mark.parametrize("causal", [True, False])
def test_ops_model_layout_matches_reference(jx, causal):
    """ops.py swaps the (B, S, H, hd) model layout to the kernel's and
    back, as the reference's ops.py does; ragged S = 100."""
    q, k, v = (np.swapaxes(a, 1, 2) for a in _qkv(2, 2, 4, 2, 100, 100, 32))
    want = jx.ops.flash_attention(jx.jnp.asarray(q), jx.jnp.asarray(k),
                                  jx.jnp.asarray(v), causal=causal,
                                  window=40)
    got = tops.flash_attention(*(_t(a, "float32") for a in (q, k, v)),
                               causal=causal, window=40)
    assert got.shape == q.shape
    _close(got, want, "float32")


@pytest.mark.parametrize("bad", ["cpu", "float16", "mixed", "gqa", "hd",
                                 "rank", "hd112", "hd120", "model_layout",
                                 "head_stride", "out_shape"])
def test_kernel_wrapper_raises(bad):
    """The CUDA wrapper never falls back: a CPU tensor, a bad dtype,
    shape or head dim raises. hd 112 and the model layout's strides pass
    the wrapper's checks, so a CPU tensor then raises for its device; a
    head-dim stride other than 1 and a misfit `out` raise."""
    q, k, v = (_t(a, "float32") for a in _qkv(3, 1, 4, 2, 8, 8, 32))
    out = None
    if bad == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        q = q.to(torch.bfloat16)
    elif bad == "gqa":
        q = q[:, :3].contiguous()
    elif bad == "hd":
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
    elif bad == "rank":
        q = q[0]
    elif bad in ("hd112", "hd120"):
        q, k, v = (_t(a, "bfloat16") for a in
                   _qkv(6, 1, 4, 2, 16, 16, int(bad[2:])))
    elif bad == "model_layout":   # (B, S, heads, hd) read in place
        q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                   for x in (q, k, v))
        assert not q.is_contiguous() and q.stride(1) == 32
    elif bad == "head_stride":
        q = torch.cat([q, q], dim=-1)[..., ::2]
    elif bad == "out_shape":
        out = torch.empty_like(q[:, :2])
    match = {"cpu": "CUDA tensor", "float16": "float32 or all bfloat16",
             "mixed": "float32 or all bfloat16", "gqa": "multiple of KV",
             "hd": "head dim", "rank": "4-d", "hd112": "CUDA tensor",
             "hd120": "head dim", "model_layout": "CUDA tensor",
             "head_stride": "head-dim stride 1",
             "out_shape": "does not fit"}[bad]
    before = tkernel.KERNEL.launches
    with pytest.raises(ValueError, match=match):
        tkernel.flash_attention(q, k, v, out=out)
    assert tkernel.KERNEL.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_CASES = ([(s, d, 0, 0.0) for s in SHAPES
               for d in ("float32", "bfloat16")]
              + [((2, 4, 2, 256, 256, 64), "float32", w, c)
                 for w, c in VARIANTS[1:]]
              + [((2, 4, 2, 100, 100, 128), d, 0, 0.0)
                 for d in ("float32", "bfloat16")]
              + [((2, 4, 2, 256, 256, hd), "bfloat16", 32, 50.0)
                 for hd in (64, 128)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,window,softcap", CARD_CASES)
def test_cuda_kernel_matches_plain_version(cuda_device, shape, dtype,
                                           window, softcap):
    q, k, v = (_t(a, dtype, cuda_device) for a in _qkv(4, *shape))
    before = tkernel.KERNEL.launches
    got = tkernel.flash_attention(q, k, v, window=window, softcap=softcap)
    assert tkernel.KERNEL.launches == before + 1
    torch.cuda.synchronize()
    want = tref.flash_attention_ref(q, k, v, window=window, softcap=softcap)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want.float().cpu().numpy(), dtype)


@pytest.mark.cuda
def test_cuda_ops_takes_the_kernel(cuda_device):
    """ops.py launches the kernel for CUDA tensors in the model layout;
    the kernel reads the transposed views in place and writes a
    contiguous (B, Sq, H, hd) output; the wrapper refuses a head-dim
    stride other than 1."""
    q, k, v = (np.swapaxes(a, 1, 2) for a in _qkv(5, 2, 8, 2, 64, 64, 64))
    q, k, v = (_t(a, "bfloat16", cuda_device).contiguous() for a in (q, k, v))
    assert not q.transpose(1, 2).is_contiguous()
    before = tkernel.KERNEL.launches
    got = tops.flash_attention(q, k, v)
    assert tkernel.KERNEL.launches == before + 1 and got.is_contiguous()
    want = tref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2)).transpose(1, 2)
    _close(got, want.float().cpu().numpy(), "bfloat16")
    with pytest.raises(ValueError, match="head-dim stride 1"):
        tkernel.flash_attention(*(torch.cat([x, x], -1)[..., ::2]
                                  .transpose(1, 2) for x in (q, k, v)))


@pytest.mark.cuda
def test_cuda_ops_reads_split_heads_in_place(cuda_device):
    """Ragged S = 100, hd 128, q, k and v as head slices of one fused (B,
    S, H + 2 KV, hd) projection (not contiguous): the kernel reads them
    where they lie and the output is a contiguous (B, Sq, H, hd) tensor,
    so no transpose copy is made on the way in or out."""
    B, S, H, KV, hd = 2, 100, 8, 2, 128
    rng = np.random.default_rng(14)
    qkv = _t(rng.standard_normal((B, S, H + 2 * KV, hd)).astype(np.float32),
             "bfloat16", cuda_device)
    q, k, v = torch.split(qkv, [H, KV, KV], dim=2)
    assert not (q.is_contiguous() or k.is_contiguous())
    before = tkernel.KERNEL.launches
    got = tops.flash_attention(q, k, v)
    assert tkernel.KERNEL.launches == before + 1
    assert got.shape == (B, S, H, hd) and got.is_contiguous()
    want = tref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2)).transpose(1, 2)
    _close(got, want.float().cpu().numpy(), "bfloat16")


@pytest.mark.cuda
def test_cuda_ops_raises_under_grad(cuda_device):
    """The kernel is forward-only, as the TPU kernel is: on CUDA tensors
    that require grad, with grad mode on, ops.flash_attention raises and
    launches nothing (no silent detach, no plain fallback); under
    no_grad it launches."""
    q, k, v = (np.swapaxes(a, 1, 2) for a in _qkv(6, 1, 4, 2, 64, 64, 64))
    q, k, v = (_t(a, "bfloat16", cuda_device).contiguous() for a in (q, k, v))
    k.requires_grad_()
    before = tkernel.KERNEL.launches
    with pytest.raises(RuntimeError, match="flash_attention: the backward"):
        tops.flash_attention(q, k, v)
    assert tkernel.KERNEL.launches == before
    with torch.no_grad():
        tops.flash_attention(q, k, v)
    assert tkernel.KERNEL.launches == before + 1
