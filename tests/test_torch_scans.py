"""The port's ssd_scan and wkv_scan against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages, as
tests/test_kernels.py draws them (x, r, k, v, B, C standard normal; dt =
softplus(normal); A_log = 0.5 normal; logw = -exp(normal - 1); u = 0.3
normal). The reference's Pallas kernels run in interpret mode. The
plain versions (the naive recurrences) are held to the reference's own
tolerances (tests/test_kernels.py:96-97,116-117): y max abs error /
max |y| < 1e-5, the final state atol = rtol = 1e-3. The torch copies of
the models' chunked scans are held to theirs to 1e-5 relative. The
`cuda` cases hold each CUDA kernel against its plain version on the card
and skip elsewhere. The plain wkv backward (`ref.wkv_scan_bwd_ref`) is
held against torch.autograd of a float64 recurrence, and on the card the
backward kernel against it.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan import kernel as skernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as sref  # noqa: E402
from repro_torch.kernels.wkv_scan import kernel as wkernel  # noqa: E402
from repro_torch.kernels.wkv_scan import ops as wops  # noqa: E402
from repro_torch.kernels.wkv_scan import ref as wref  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

SSD_SHAPES = [  # (Bb, S, nh, hd, ds, chunk), tests/test_kernels.py:86-90
    (2, 256, 4, 64, 64, 128),
    (1, 128, 2, 32, 16, 64),
    (2, 512, 3, 64, 64, 128),
]
WKV_SHAPES = [  # (B, S, nh, hd, chunk), tests/test_kernels.py:107-111
    (2, 128, 4, 64, 64),
    (1, 256, 2, 32, 64),
    (2, 192, 3, 64, 32),
]
Y_REL = 1e-5
STATE = dict(atol=1e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here so the `cuda` cases can run on a
    machine without JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ssd_scan import kernel as sk
    from repro.kernels.ssd_scan import ops as so
    from repro.kernels.ssd_scan import ref as sr
    from repro.kernels.wkv_scan import kernel as wk
    from repro.kernels.wkv_scan import ops as wo
    from repro.kernels.wkv_scan import ref as wr
    from repro.models import rwkv, ssm
    return SimpleNamespace(jnp=jnp, ssd=sk.ssd_scan, ssd_ops=so.ssd_scan,
                           ssd_ref=sr.ssd_scan_ref, wkv=wk.wkv_scan,
                           wkv_ops=wo.wkv_scan, wkv_ref=wr.wkv_scan_ref,
                           ssd_chunk=ssm.ssd_chunk_scan,
                           wkv_chunk=rwkv.wkv_chunk_scan)


def _softplus(a):
    return np.logaddexp(a, 0.0).astype(np.float32)


def ssd_inputs(seed, Bb, S, nh, hd, ds):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (n(Bb, S, nh, hd), _softplus(n(Bb, S, nh)), 0.5 * n(nh),
            n(Bb, S, ds), n(Bb, S, ds), np.ones(nh, np.float32))


def wkv_inputs(seed, B, S, nh, hd, s0=False):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    out = (n(B, S, nh, hd), n(B, S, nh, hd), n(B, S, nh, hd),
           -np.exp(n(B, S, nh, hd) - 1.0), 0.3 * n(nh, hd))
    return out + ((0.5 * n(B, nh, hd, hd)) if s0 else None,)


def _t(arrs, device="cpu", dtype=torch.float32, n_cast=None):
    """numpy -> tensors; the first `n_cast` (default all) in `dtype`."""
    n_cast = len(arrs) if n_cast is None else n_cast
    return [None if a is None else torch.as_tensor(a).to(
        device=device, dtype=dtype if i < n_cast else torch.float32)
        for i, a in enumerate(arrs)]


def _max_rel(got, want):
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.float().cpu().numpy() - want).max())
    return err / (float(np.abs(want).max()) + 1e-6)


def _hold(got_y, got_s, want_y, want_s, y_rel=Y_REL, state_rel=None):
    """y to `y_rel` of max |y|; the state to STATE, or to `state_rel` of
    its largest entry."""
    assert _max_rel(got_y, want_y) < y_rel
    if state_rel is not None:
        assert _max_rel(got_s, want_s) < state_rel
    else:
        np.testing.assert_allclose(got_s.float().cpu().numpy(),
                                   np.asarray(want_s, np.float32), **STATE)


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_plain_version_matches_reference(jx, shape):
    *dims, chunk = shape
    arrs = ssd_inputs(0, *dims)
    ja = [jx.jnp.asarray(a) for a in arrs]
    got_y, got_h = sref.ssd_scan_ref(*_t(arrs))
    assert got_y.dtype == torch.float32 and got_h.shape == (
        dims[0], dims[2], dims[3], dims[4])
    _hold(got_y, got_h, *jx.ssd(*ja, chunk=chunk, interpret=True))
    _hold(got_y, got_h, *jx.ssd_ref(*ja))


@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_wkv_plain_version_matches_reference(jx, shape):
    *dims, chunk = shape
    arrs = wkv_inputs(1, *dims)
    ja = [jx.jnp.asarray(a) for a in arrs[:5]]
    got_y, got_s = wref.wkv_scan_ref(*_t(arrs))
    assert got_y.dtype == torch.float32
    _hold(got_y, got_s, *jx.wkv(*ja, chunk=chunk, interpret=True))
    _hold(got_y, got_s, *jx.wkv_ref(*ja))


def test_wkv_plain_version_with_initial_state(jx):
    """The carried state s0 (rwkv_forward with a cache) enters the plain
    version as it enters the reference's."""
    arrs = wkv_inputs(2, 2, 96, 2, 32, s0=True)
    got_y, got_s = wref.wkv_scan_ref(*_t(arrs))
    want = jx.wkv_ref(*(jx.jnp.asarray(a) for a in arrs))
    _hold(got_y, got_s, *want)
    # s0 is the state the first half of the sequence leaves behind
    first = wref.wkv_scan_ref(*_t([a[:, :40] for a in arrs[:4]] + [arrs[4]]))
    second = wref.wkv_scan_ref(*_t([a[:, 40:] for a in arrs[:4]]
                                   + [arrs[4]]), s0=first[1])
    whole = wref.wkv_scan_ref(*_t(arrs[:5]))
    _hold(torch.cat([first[0], second[0]], 1), second[1], *whole)


def test_ops_pad_to_the_chunk_as_the_reference(jx):
    """ops.py pads S = 200 (ssd) and S = 100 (wkv) to the chunk with
    steps that leave the state exact, as tests/test_kernel_ops.py shows
    of the reference's ops.py."""
    arrs = ssd_inputs(3, 2, 200, 2, 32, 16)
    got = sops.ssd_scan(*_t(arrs))
    assert got[0].shape == (2, 200, 2, 32)
    _hold(*got, *jx.ssd_ops(*(jx.jnp.asarray(a) for a in arrs)))
    _hold(*got, *jx.ssd_ref(*(jx.jnp.asarray(a) for a in arrs)))
    arrs = wkv_inputs(4, 2, 100, 2, 32)
    got = wops.wkv_scan(*_t(arrs))
    assert got[0].shape == (2, 100, 2, 32)
    _hold(*got, *jx.wkv_ops(*(jx.jnp.asarray(a) for a in arrs[:5])))
    _hold(*got, *jx.wkv_ref(*(jx.jnp.asarray(a) for a in arrs[:5])))


def test_chunked_copies_match_reference(jx):
    """The torch copies of the models' chunked scans (two chunks each, a
    nonzero initial wkv state) against the reference's, fp32. The wkv
    decays are those the model's initialisation gives (logw = -exp(w0 +
    small), w0 = -1), which the chunk of 128 steps holds in fp32's range
    (next test)."""
    arrs = ssd_inputs(5, 2, 512, 3, 32, 16)
    got = tssm.ssd_chunk_scan(*_t(arrs))
    want = jx.ssd_chunk(*(jx.jnp.asarray(a) for a in arrs))
    _hold(*got, *want, state_rel=1e-5)
    arrs = list(wkv_inputs(6, 2, 256, 2, 32, s0=True))
    arrs[3] = -np.exp(-1.0 + 0.1 * np.random.default_rng(7).standard_normal(
        arrs[3].shape)).astype(np.float32)
    got = trwkv.wkv_chunk_scan(*_t(arrs))
    want = jx.wkv_chunk(*(jx.jnp.asarray(a) for a in arrs))
    _hold(*got, *want, state_rel=1e-5)


def test_chunked_wkv_overflows_where_the_recurrence_does_not(jx):
    """A reference-side finding, mirrored by the copy: with the kernel
    tests' decays (logw = -exp(normal - 1)) some channels decay by more
    than e^-88 within a chunk of 128 steps, e^{-cum} overflows fp32 and
    the model's chunked scan returns NaN in both packages, while the
    naive recurrence (the model path of the port on CPU tensors) stays
    finite. The wkv_scan kernel's sub-block rebasing avoids this (its
    `cuda` strong-decay case)."""
    arrs = wkv_inputs(6, 2, 256, 2, 32, s0=True)
    cum = np.cumsum(arrs[3].reshape(2, 2, 128, 2, 32), axis=2)[:, :, -1]
    assert cum.min() < -88.7
    y_port, _ = trwkv.wkv_chunk_scan(*_t(arrs))
    y_ref, _ = jx.wkv_chunk(*(jx.jnp.asarray(a) for a in arrs))
    assert not np.isfinite(np.asarray(y_ref)).all()
    assert not bool(torch.isfinite(y_port).all())
    y_plain, _ = wops.wkv_scan(*_t(arrs))
    assert bool(torch.isfinite(y_plain).all())


def _split(v, n):
    """v (float32) as n bf16-valued float32 terms, each the rounding of
    what the earlier ones left: the kernel's operand split."""
    out = []
    for _ in range(n):
        t = v.to(torch.bfloat16).float()
        out.append(t)
        v = v - t
    return out


def _mm_terms(a, b, na, nb, k_axis_a=-1):
    """sum_k a[..., k] b[k, ...] over k steps of 16 as the kernel sums it:
    each step's products of the terms i, j with i + j <= 2 (a in na, b in
    nb terms), smallest first, into a zeroed float32 partial, then the
    partial added to the running float32 sum. a: (..., M, K), b: (..., K,
    N)."""
    at, bt = _split(a, na), _split(b, nb)
    acc = None
    for k0 in range(0, a.shape[-1], 16):
        part = torch.zeros(a.shape[:-1] + b.shape[-1:])
        for j in reversed(range(nb)):
            for i in reversed(range(na)):
                if i + j <= 2:
                    part = part + at[i][..., k0:k0 + 16] @ \
                        bt[j][..., k0:k0 + 16, :]
        acc = part if acc is None else acc + part
    return acc


def _ssd_emulated(x, dt, A_log, B, C, D, n_in, Q=128):
    """The CUDA ssd_scan's arithmetic in float32 torch on one batch row:
    C B^T once a chunk, the chunk states, the sequential state pass and
    the chunk outputs, with every fp32 factor split into 3 bf16 terms and
    x, B, C into n_in (1: bf16 inputs, exact; 3: fp32). cum is double; a
    decay exp(cum_i - cum_j) is taken from cum as a float pair hi + lo.
    x (S, nh, hd), dt (S, nh), B/C (S, ds) -> y (S, nh, hd) before the
    output rounding."""
    S, nh, hd = x.shape
    nc = S // Q
    xc = x.reshape(nc, Q, nh, hd).permute(2, 0, 1, 3)      # (nh, nc, Q, hd)
    dtc = dt.reshape(nc, Q, nh).permute(2, 0, 1)           # (nh, nc, Q)
    Bc, Cc = B.reshape(nc, Q, -1), C.reshape(nc, Q, -1)    # (nc, Q, ds)
    A = -torch.exp(A_log.double())
    cum = torch.cumsum(dtc.double() * A[:, None, None], -1)   # (nh, nc, Q)
    hi = cum.float()
    lo = (cum - hi.double()).float()
    i, j = torch.arange(Q)[:, None], torch.arange(Q)[None, :]
    cb = _mm_terms(Cc, Bc.transpose(1, 2), n_in, n_in)       # (nc, Q, Q)
    dec = torch.exp((hi[..., :, None] - hi[..., None, :])
                    + (lo[..., :, None] - lo[..., None, :]))
    P = torch.where(j <= i, cb * dec * dtc[..., None, :], 0.0)
    y_in = _mm_terms(P, xc, 3, n_in)                         # (nh, nc, Q, hd)
    cQ = cum[..., -1:]
    w = torch.exp((cQ - cum).float()) * dtc                  # (nh, nc, Q)
    st = _mm_terms((xc * w[..., None]).transpose(-1, -2), Bc, 3, n_in)
    decay = torch.exp(cQ[..., 0].float())                    # (nh, nc)
    h = torch.zeros(nh, hd, B.shape[-1])
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * decay[:, c, None, None] + st[:, c]
    hp = torch.stack(prev, 1)                                # (nh, nc, hd, ds)
    y_out = _mm_terms(Cc.expand(nh, -1, -1, -1), hp.transpose(-1, -2),
                      n_in, 3)
    y = y_in + torch.exp(cum.float())[..., None] * y_out + \
        xc * D[:, None, None, None]
    return y.permute(1, 2, 0, 3).reshape(S, nh, hd)


def _ssd_float64(x, dt, A_log, B, C, D):
    """The recurrence in float64, one batch row."""
    x, dt, B, C = x.double(), dt.double(), B.double(), C.double()
    A = -torch.exp(A_log.double())
    h = torch.zeros(x.shape[1], x.shape[2], B.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(x.shape[0]):
        h = h * torch.exp(dt[t] * A)[:, None, None] + \
            (dt[t, :, None] * x[t])[..., None] * B[t, None, None, :]
        ys.append(torch.einsum("hds,s->hd", h, C[t]))
    return torch.stack(ys) + x * D.double()[None, :, None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_arithmetic_against_float64(dtype):
    """The CUDA ssd_scan's chunk decomposition and operand splits,
    emulated in float32 torch, stay within 1e-6 of max |y| of a float64
    recurrence at the serving slice's width, (1, 2048, 2, 64, 64): the
    accuracy argument of csrc/ssd_scan.cu, checked before any card.
    bf16 inputs are rounded first and y is compared before its own
    rounding to bf16."""
    x, dt, A_log, B, C, D = (torch.as_tensor(a) for a in
                             ssd_inputs(15, 1, 2048, 2, 64, 64))
    x, B, C = (a.to(getattr(torch, dtype)).float() for a in (x, B, C))
    got = _ssd_emulated(x[0], dt[0], A_log, B[0], C[0], D,
                        n_in=3 if dtype == "float32" else 1)
    want = _ssd_float64(x[0], dt[0], A_log, B[0], C[0], D)
    err = float((got.double() - want).abs().max() / want.abs().max())
    assert err < 1e-6, err


def _wkv_emulated(r, k, v, logw, u, s0, n_in, Q=64, SB=16, states=False):
    """The CUDA wkv_scan's arithmetic in float32 torch on one batch row:
    the chunk states, the sequential state pass and the chunk outputs,
    with cumsums in double, local to sub-blocks of SB steps; A's
    off-diagonal sub-block pairs rebased so that no factor exceeds 1 and
    multiplied with both fp32 factors split into 3 bf16 terms (the
    products of terms i + j <= 2); its diagonal sub-blocks in fp32, pairs
    of 4-step micro-blocks rebased the same way and pairs inside one one
    exp a term, from the cumsums as a float pair hi + lo; A v with v in n_in terms (1:
    bf16 inputs, exact; 3: fp32) and (r e^{E_{i-1}}) h_{c-1} with both in
    3. r, k, v, logw (S, nh, hd), u (nh, hd), s0 (nh, hd, hd) -> y (S,
    nh, hd) before the output rounding; with `states`, also the states
    entering the chunks (nh, nc, hd, hd) and s_T (nh, hd, hd), the
    forward kernel's scratch and output."""
    S, nh, hd = r.shape
    nc, nsb = S // Q, Q // SB

    def blocks(a):                               # (nh, nc, nsb, SB, hd)
        return a.reshape(nc, nsb, SB, nh, hd).permute(3, 0, 1, 2, 4)
    rc, kc, vc, wc = (blocks(a) for a in (r, k, v, logw))
    L = torch.cumsum(wc.double(), 3)             # inclusive, per sub-block
    tot = L[..., -1, :]                          # (nh, nc, nsb, hd)
    Lprev = torch.cat([torch.zeros_like(L[..., :1, :]), L[..., :-1, :]], 3)
    flat = lambda a: a.reshape(nh, nc, Q, hd)    # noqa: E731
    vq = flat(vc)
    # chunk states s_c = (k e^{E_{Q-1} - E_j})^T v, decays e^{E_{Q-1}}
    after = tot.flip(2).cumsum(2).flip(2) - tot
    kw = kc * torch.exp((after[..., None, :] + (L[..., -1:, :] - L)).float())
    st = _mm_terms(flat(kw).transpose(-1, -2), vq, 3, n_in)
    decay = torch.exp(tot.sum(2).float())        # (nh, nc, hd)
    h, prev = s0.clone(), []
    for c in range(nc):
        prev.append(h)
        h = h * decay[:, c, :, None] + st[:, c]
    hp = torch.stack(prev, 1)                    # (nh, nc, hd, hd)
    # chunk outputs
    RR = rc * torch.exp(Lprev.float())           # r e^{E_{i-1} - E_{b-1}}
    KK = kc * torch.exp((L[..., -1:, :] - L).float())   # k e^{E_e - E_j}
    Eb = torch.exp((tot.cumsum(2) - tot).float())        # e^{E_{b-1}}
    A = torch.zeros(nh, nc, Q, Q)
    g = torch.exp(tot.float())                   # e^{E} of each sub-block
    for I in range(1, nsb):
        for J in range(I):
            a = RR[:, :, I]
            if I - J > 1:                        # the sub-blocks between
                a = a * torch.prod(g[:, :, J + 1:I], 2)[:, :, None]
            A[:, :, I * SB:(I + 1) * SB, J * SB:(J + 1) * SB] = _mm_terms(
                a, KK[:, :, J].transpose(-1, -2), 3, 3)
    # inside a sub-block: pairs of 4-step micro-blocks rebased at their
    # edges (r e^{E_{i-1} - E_{i0-1}} e^{E_{i0-1} - E_{j0+3}}) (k e^{E_{j0+3}
    # - E_j}); pairs inside a micro-block one exp a term
    hi = L.float()
    lo = (L - hi.double()).float()
    hp_, lp_ = hi.roll(1, 3), lo.roll(1, 3)      # row i holds row i - 1
    dif = lambda a, b, c, d: torch.exp((a - b) + (c - d))  # noqa: E731
    mb = torch.arange(SB) // 4
    first, last = 4 * mb, 4 * mb + 3
    ex = dif(hp_[..., :, None, :], hi[..., None, :, :],
             lp_[..., :, None, :], lo[..., None, :, :])
    near = (ex * (rc[..., :, None, :] * kc[..., None, :, :])).sum(-1)
    fi = dif(hp_, hp_[..., first, :], lp_, lp_[..., first, :])
    fj = dif(hi[..., last, :], hi, lo[..., last, :], lo)
    gap = dif(hp_[..., first, None, :], hi[..., None, last, :],
              lp_[..., first, None, :], lo[..., None, last, :])
    far = ((rc * fi)[..., :, None, :] * gap
           * (kc * fj)[..., None, :, :]).sum(-1)
    lower = torch.tril(torch.ones(SB, SB, dtype=torch.bool), -1)
    same = mb[:, None] == mb[None, :]
    diag = torch.where(lower & same, near, 0.0) + torch.where(
        lower & ~same, far, 0.0)                 # (nh, nc, nsb, SB, SB)
    for I in range(nsb):
        A[:, :, I * SB:(I + 1) * SB, I * SB:(I + 1) * SB] = diag[:, :, I]
    bonus = flat(rc * u[:, None, None, None, :] * kc).sum(-1)
    y = _mm_terms(A, vq, 3, n_in) + bonus[..., None] * vq + _mm_terms(
        flat(RR * Eb[..., None, :]), hp, 3, 3)
    y = y.permute(1, 2, 0, 3).reshape(S, nh, hd)
    return (y, hp, h) if states else y


def _wkv_float64(r, k, v, logw, u, s0):
    """The recurrence in float64, one batch row."""
    r, k, v, w = (a.double() for a in (r, k, v, logw))
    s, ud, ys = s0.double(), u.double(), []
    for t in range(r.shape[0]):
        ys.append(torch.einsum("hk,hkv->hv", r[t], s)
                  + (r[t] * ud * k[t]).sum(-1, keepdim=True) * v[t])
        s = s * torch.exp(w[t])[..., None] + k[t][..., None] * v[t][:, None]
    return torch.stack(ys)


@pytest.mark.parametrize("dtype,logw", [("float32", None),
                                        ("bfloat16", None),
                                        ("float32", -8.0)])
def test_wkv_kernel_arithmetic_against_float64(dtype, logw):
    """The CUDA wkv_scan's chunk decomposition, rebasing and operand
    splits, emulated in float32 torch, stay within 1e-6 of max |y| of a
    float64 recurrence at the serving slice's width, (1, 2048, 2, 64) with
    a nonzero s0: the accuracy argument of csrc/wkv_scan.cu, checked
    before any card. The kernel tests' decays (logw = -exp(normal - 1))
    take some channels past e^-88 within a chunk, where the TPU kernel's
    factorisation overflows; logw = -8 on every step (past trained
    RWKV6's -7) stays finite too. bf16 inputs are rounded first and y is
    compared before its own rounding to bf16."""
    r, k, v, lw, u, s0 = (torch.as_tensor(a) for a in
                          wkv_inputs(17, 1, 2048, 2, 64, s0=True))
    if logw is not None:
        lw = torch.full_like(lw, logw)
    r, k, v = (a.to(getattr(torch, dtype)).float() for a in (r, k, v))
    got = _wkv_emulated(r[0], k[0], v[0], lw[0], u, s0[0],
                        n_in=3 if dtype == "float32" else 1)
    assert bool(torch.isfinite(got).all())
    want = _wkv_float64(r[0], k[0], v[0], lw[0], u, s0[0])
    err = float((got.double() - want).abs().max() / want.abs().max())
    assert err < 1e-6, err


def _wkv_grads_float64(r, k, v, logw, u, s0, dy, dsT):
    """torch.autograd of the float64 recurrence (all batch rows): the
    gradients of sum(y dy) + sum(s_T dsT) with respect to r, k, v, logw,
    u and s0."""
    ins = [a.detach().double().requires_grad_() for a in
           (r, k, v, logw, u, s0)]
    rd, kd, vd, wd, ud, s = ins
    ys = []
    for t in range(rd.shape[1]):
        ys.append(torch.einsum("bhk,bhkv->bhv", rd[:, t], s)
                  + (rd[:, t] * ud * kd[:, t]).sum(-1, keepdim=True)
                  * vd[:, t])
        s = s * torch.exp(wd[:, t])[..., None] \
            + kd[:, t][..., None] * vd[:, t][:, :, None]
    loss = (torch.stack(ys, 1) * dy.double()).sum() \
        + (s * dsT.double()).sum()
    return torch.autograd.grad(loss, ins)


WKV_GRADS = ("dr", "dk", "dv", "dlogw", "du", "ds0")


def _hold_grads(got, want, rel, what=""):
    for name, g, w in zip(WKV_GRADS, got, want):
        w = w.double().cpu()
        err = float((g.double().cpu() - w).abs().max() / w.abs().max())
        assert err < rel, (what, name, err)


@pytest.mark.parametrize("logw", [None, -8.0])
def test_wkv_bwd_ref_matches_float64_autograd(logw):
    """The plain backward (the reverse recurrence written out) against
    torch.autograd of the float64 recurrence, with a non-zero u, s0 and a
    gradient on s_T: every gradient within 1e-6 of its largest entry
    (fp32 sums over S = 96 steps), also at logw = -8 on every step."""
    r, k, v, lw, u, s0 = _t(wkv_inputs(30, 2, 96, 3, 16, s0=True))
    if logw is not None:
        lw = torch.full_like(lw, logw)
    rng = np.random.default_rng(31)
    dy = torch.as_tensor(rng.standard_normal(r.shape).astype(np.float32))
    dsT = torch.as_tensor(rng.standard_normal(s0.shape).astype(np.float32))
    got = wref.wkv_scan_bwd_ref(r, k, v, lw, u, s0, dy, dsT)
    assert [g.dtype for g in got] == [torch.float32] * 6
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _hold_grads(got, _wkv_grads_float64(r, k, v, lw, u, s0, dy, dsT), 1e-6)


def test_wkv_ops_gradient_on_cpu_through_the_padding():
    """On CPU tensors ops.wkv_scan is the plain forward, which autograd
    differentiates: at S = 100, padded to 128, the gradients equal the
    plain backward's on the unpadded inputs (the padded steps take
    none)."""
    r, k, v, lw, u, s0 = _t(wkv_inputs(32, 1, 100, 2, 8, s0=True))
    rng = np.random.default_rng(33)
    dy = torch.as_tensor(rng.standard_normal(r.shape).astype(np.float32))
    dsT = torch.as_tensor(rng.standard_normal(s0.shape).astype(np.float32))
    ins = [a.clone().requires_grad_() for a in (r, k, v, lw, u, s0)]
    y, sT = wops.wkv_scan(*ins, chunk=64)
    got = torch.autograd.grad((y * dy).sum() + (sT * dsT).sum(), ins)
    want = wref.wkv_scan_bwd_ref(r, k, v, lw, u, s0, dy, dsT)
    _hold_grads(got, want, 1e-5)


def _wkv_bwd_emulated(r, k, v, logw, u, s0, dy, dsT, n_in, Q=64, SB=16,
                      split=True):
    """The arithmetic of the CUDA wkv_scan backward's four kernels in
    float32 torch on one batch row, from the forward's chunk states
    (`_wkv_emulated`): cumsums in double, local to sub-blocks of SB steps;
    M = dy v^T; the sub-block pairs of dr's and dk's sums and of A rebased
    so that no factor exceeds 1, with both fp32 factors split into 3 bf16
    terms (dy and v in n_in: 1 for bf16 inputs, exact; 3 for fp32); the
    diagonal sub-blocks per channel, e^{E_{i-1}-E_j} as the running product
    of the w between; the neighbours (i = j + 1) kept out of the sums that
    make dlogw and added to dr and dk apart; the gradient's chunk states,
    the reverse pass over chunks; dk, dv; dlogw as suffix sums of r dr' -
    k dk', prefix sums of the d s_T side and e^{E_{Q-1}} rowsum(dH_c
    h_{c-1}), all local to the chunk. `split=False` takes every product in
    plain float32 (the chunked algebra alone). r, k, v, logw, dy (S, nh,
    hd), u (nh, hd), s0, dsT (nh, hd, hd) -> [dr, dk, dv, dlogw (S, nh,
    hd), du (nh, hd), ds0 (nh, hd, hd)] before any output rounding."""
    S, nh, hd = r.shape
    nc, nsb = S // Q, Q // SB
    mm = _mm_terms if split else (lambda a, b, na, nb: a @ b)
    _, hp, sT = _wkv_emulated(r, k, v, logw, u, s0, n_in, Q, SB,
                                states=True)

    def blocks(a):                               # (nh, nc, nsb, SB, hd)
        return a.reshape(nc, nsb, SB, nh, hd).permute(3, 0, 1, 2, 4)
    flat = lambda a: a.reshape(nh, nc, Q, hd)    # noqa: E731
    sub = lambda a: a.reshape(nh, nc, nsb, SB, a.shape[-1])  # noqa: E731
    rc, kc, vc, dyc, wc = (blocks(a) for a in (r, k, v, dy, logw))
    L = torch.cumsum(wc.double(), 3)             # inclusive, per sub-block
    tot = L[..., -1, :]                          # (nh, nc, nsb, hd)
    Lprev = torch.cat([torch.zeros_like(L[..., :1, :]), L[..., :-1, :]], 3)
    before = tot.cumsum(2) - tot                 # E_{b(I)-1}
    after = tot.flip(2).cumsum(2).flip(2) - tot  # E_{Q-1} - E_{e(J)}
    Fr = torch.exp(Lprev.float())                # e^{E_{i-1} - E_{b(I)-1}}
    Fk = torch.exp((L[..., -1:, :] - L).float())  # e^{E_{e(J)} - E_j}
    Eb, Ea = torch.exp(before.float()), torch.exp(after.float())
    decay = torch.exp(tot.sum(2).float())        # (nh, nc, hd)

    def g(I, J):                                 # e^{E_{b(I)-1} - E_{e(J)}}
        return torch.exp(tot[:, :, J + 1:I].sum(2).float())[..., None, :]

    def tile(a, I, J):
        return a[..., I * SB:(I + 1) * SB, J * SB:(J + 1) * SB]
    vq, dyq = flat(vc), flat(dyc)
    M = mm(dyq, vq.transpose(-1, -2), n_in, n_in)          # (nh, nc, Q, Q)
    Mii = torch.diagonal(M, dim1=-2, dim2=-1)              # v_i . dy_i
    # the diagonal sub-blocks, per channel: D_ij = prod_{j<t<i} e^{logw_t}
    w = torch.exp(wc)
    Md = torch.stack([tile(M, I, I) for I in range(nsb)], 2)
    drd, dkd = torch.zeros_like(rc), torch.zeros_like(rc)
    Ad = torch.zeros(nh, nc, nsb, SB, SB)
    for j in range(SB):
        d = torch.ones_like(w[..., 0, :])
        for i in range(j + 1, SB):
            if i > j + 1:
                d = d * w[..., i - 1, :]
            kd = kc[..., j, :] * d
            Ad[..., i, j] = (rc[..., i, :] * kd).sum(-1)
            if i > j + 1:                        # neighbours: added apart
                m = Md[..., i, j, None]
                drd[..., i, :] += m * kd
                dkd[..., j, :] += m * (rc[..., i, :] * d)
    KK = kc * Fk                                           # k e^{E_e - E_j}
    RR = rc * Fr                                           # r e^{E_{i-1}-E_b}
    # 1. chunk states of the gradient and the r side
    RE = rc * torch.exp((before[..., None, :] + Lprev).float())
    ds = mm(flat(RE).transpose(-1, -2), dyq, 3, n_in)      # (nh, nc, hd, hd)
    # M without the neighbours (i = j + 1), whose factor is 1 whatever the
    # decay: their terms cancel in dlogw and are added to dr, dk apart
    Mn = M.clone()
    idx = torch.arange(1, Q)
    Mn[..., idx, idx - 1] = 0.0
    nb = torch.diagonal(M, offset=-1, dim1=-2, dim2=-1)    # M_{i, i-1}
    X = sub(mm(dyq, hp.transpose(-1, -2), n_in, 3)) * Eb[..., None, :]
    for I in range(1, nsb):
        for J in range(I):
            X[:, :, I] += g(I, J) * mm(tile(Mn, I, J), KK[:, :, J], 3, 3)
    dro = Fr * X + drd                           # dr° less the neighbours
    uu = u[:, None, None, None, :]
    kq, rq = flat(kc), flat(rc)
    nbr = torch.zeros_like(kq)
    nbr[:, :, 1:] = nb[..., None] * kq[:, :, :-1]
    dr = dro + sub(nbr) + uu * kc * sub(Mii[..., None])
    P = flat(rc * dro)                                     # r_i . dr°_i
    du = (rc * kc * sub(Mii[..., None])).sum((1, 2, 3))
    # 2. the reverse pass over chunks
    dH, dHc = dsT.clone(), [None] * nc
    for c in reversed(range(nc)):
        dHc[c] = dH
        dH = decay[:, c, :, None] * dH + ds[:, c]
    ds0, dHs = dH, torch.stack(dHc, 1)                     # dH_c
    # 3. the k and v sides and dlogw
    A = torch.zeros(nh, nc, Q, Q)
    for I in range(nsb):
        tile(A, I, I)[...] = Ad[:, :, I]
        for J in range(I):
            tile(A, I, J)[...] = mm(RR[:, :, I] * g(I, J),
                                    KK[:, :, J].transpose(-1, -2), 3, 3)
    YH = sub(mm(vq, dHs.transpose(-1, -2), n_in, 3)) * Ea[..., None, :]
    Y = torch.zeros_like(YH)
    for J in range(nsb - 1):
        for I in range(J + 1, nsb):
            Y[:, :, J] += g(I, J) * mm(tile(Mn, I, J).transpose(-1, -2),
                                       RR[:, :, I], 3, 3)
    dkH = Fk * YH                                # e^{E_{Q-1}-E_j} dH_c v_j
    dko = Fk * Y + dkd                           # the rest, less neighbours
    nbk = torch.zeros_like(rq)
    nbk[:, :, :-1] = nb[..., None] * rq[:, :, 1:]
    dk = dkH + dko + sub(nbk) + uu * rc * sub(Mii[..., None])
    bonus = (rc * uu * kc).sum(-1, keepdim=True)
    dv = mm(flat(KK * Ea[..., None, :]), dHs, 3, 3) \
        + mm(A.transpose(-1, -2), dyq, 3, n_in) + bonus.reshape(nh, nc, Q, 1) * dyq
    # dlogw_t: the terms whose exponent holds logw_t; suffix sums of r dr°
    # less k dk° (the pairs i > t > j), prefix sums of k dkH (j < t), and
    # e^{E_{Q-1}} rowsum(dH_c * h_{c-1}) at every step
    a = -flat(kc * dko)
    a[:, :, :-1] += P[:, :, 1:]
    b = flat(kc * dkH)
    pre = torch.zeros_like(b)
    pre[:, :, 1:] = torch.cumsum(b[:, :, :-1], 2)
    whole = decay[:, :, None, :] * (dHs * hp).sum(-1)[:, :, None, :]
    dlogw = a.flip(2).cumsum(2).flip(2) + pre + whole
    out = [a.reshape(nh, S, hd).permute(1, 0, 2)
           for a in (flat(dr), flat(dk), dv, dlogw)]
    return out + [du, ds0]


@pytest.mark.parametrize("dtype,logw", [("float32", None),
                                        ("bfloat16", None),
                                        ("float32", -8.0)])
def test_wkv_bwd_kernel_arithmetic_against_float64(dtype, logw):
    """The CUDA wkv_scan backward's chunk decomposition, rebasing, operand
    splits and chunk-local dlogw, emulated in float32 torch, give every
    gradient finite and within 1e-5 of its largest entry of autograd of a
    float64 recurrence at a rwkv6-3b head's width, (1, 2048, 2, 64) with a
    nonzero s0 and d s_T: the accuracy argument of csrc/wkv_scan_bwd.cu,
    checked before any card, also at logw = -8 on every step, where dlogw
    is small against the terms that make it. bf16 inputs (and dy) are
    rounded first."""
    r, k, v, lw, u, s0 = (torch.as_tensor(a) for a in
                          wkv_inputs(17, 1, 2048, 2, 64, s0=True))
    if logw is not None:
        lw = torch.full_like(lw, logw)
    rng = np.random.default_rng(18)
    dy = torch.as_tensor(rng.standard_normal(r.shape).astype(np.float32))
    dsT = torch.as_tensor(rng.standard_normal(s0.shape).astype(np.float32))
    r, k, v, dy = (a.to(getattr(torch, dtype)).float() for a in (r, k, v, dy))
    got = _wkv_bwd_emulated(r[0], k[0], v[0], lw[0], u, s0[0], dy[0],
                            dsT[0], n_in=3 if dtype == "float32" else 1)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    want = _wkv_grads_float64(r, k, v, lw, u, s0, dy, dsT)
    want = [w[0] for w in want[:4]] + [want[4], want[5][0]]
    _hold_grads(got, want, 1e-5, (dtype, logw))


def test_wkv_bwd_chunked_algebra_matches_plain_backward():
    """The backward's chunked algebra without the operand splits, at
    chunk 32 (two sub-blocks) over three chunks of (2, 96, 3, 16) with s0
    and d s_T, batch row by batch row: within 1e-6 of each gradient's
    largest entry of the plain backward (the reverse recurrence)."""
    r, k, v, lw, u, s0 = _t(wkv_inputs(36, 2, 96, 3, 16, s0=True))
    rng = np.random.default_rng(37)
    dy = torch.as_tensor(rng.standard_normal(r.shape).astype(np.float32))
    dsT = torch.as_tensor(rng.standard_normal(s0.shape).astype(np.float32))
    rows = [_wkv_bwd_emulated(r[b], k[b], v[b], lw[b], u, s0[b], dy[b],
                              dsT[b], n_in=3, Q=32, split=False)
            for b in range(2)]
    got = [torch.stack([g[n] for g in rows]) for n in range(4)] + [
        rows[0][4] + rows[1][4], torch.stack([g[5] for g in rows])]
    _hold_grads(got, wref.wkv_scan_bwd_ref(r, k, v, lw, u, s0, dy, dsT),
                1e-6)


@pytest.mark.parametrize("bad", ["cpu", "float16", "mixed", "dt_dtype",
                                 "hd", "chunk", "ragged", "shape"])
def test_ssd_kernel_wrapper_raises(bad):
    """The CUDA wrapper never falls back: a CPU tensor, a bad dtype,
    shape, width, chunk or an unpadded S raises before any launch."""
    x, dt, A_log, B, C, D = _t(ssd_inputs(7, 1, 64, 2, 32, 16))
    chunk = 64
    if bad == "float16":
        x, B, C = x.half(), B.half(), C.half()
    elif bad == "mixed":
        x = x.to(torch.bfloat16)
    elif bad == "dt_dtype":
        dt = dt.to(torch.bfloat16)
    elif bad == "hd":
        x = torch.zeros((1, 64, 2, 80))
    elif bad == "chunk":
        chunk = 256
    elif bad == "ragged":
        x, dt, B, C = x[:, :40], dt[:, :40], B[:, :40], C[:, :40]
        chunk = 32
    elif bad == "shape":
        D = D[:1]
    match = {"cpu": "CUDA tensor", "float16": "float32 or all bfloat16",
             "mixed": "float32 or all bfloat16", "dt_dtype": "dt must be",
             "hd": "supports", "chunk": "supports", "ragged": "multiple",
             "shape": "do not fit"}[bad]
    before = skernel.KERNEL.launches
    with pytest.raises(ValueError, match=match):
        skernel.ssd_scan(x, dt, A_log, B, C, D, chunk=chunk)
    assert skernel.KERNEL.launches == before


@pytest.mark.parametrize("bad", ["cpu", "float16", "logw_dtype", "hd",
                                 "chunk", "ragged", "s0"])
def test_wkv_kernel_wrapper_raises(bad):
    r, k, v, logw, u, _ = _t(wkv_inputs(8, 1, 64, 2, 32))
    s0, chunk = None, 64
    if bad == "float16":
        r, k, v = r.half(), k.half(), v.half()
    elif bad == "logw_dtype":
        logw = logw.to(torch.bfloat16)
    elif bad == "hd":
        r = k = v = logw = torch.zeros((1, 64, 1, 96))
        u = torch.zeros((1, 96))
    elif bad == "chunk":
        chunk = 128
    elif bad == "ragged":
        r, k, v, logw = r[:, :40], k[:, :40], v[:, :40], logw[:, :40]
        chunk = 32
    elif bad == "s0":
        s0 = torch.zeros((1, 2, 32, 16))
    match = {"cpu": "CUDA tensor", "float16": "float32 or all bfloat16",
             "logw_dtype": "logw must be", "hd": "supports",
             "chunk": "supports", "ragged": "multiple",
             "s0": "do not fit"}[bad]
    before = wkernel.KERNEL.launches
    with pytest.raises(ValueError, match=match):
        wkernel.wkv_scan(r, k, v, logw, u, s0, chunk=chunk)
    assert wkernel.KERNEL.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


BF16_Y_REL = 2.0 ** -7   # one bf16 step at the top of y's range


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_SHAPES + [(2, 200, 2, 32, 16, 128)])
def test_cuda_ssd_kernel_matches_plain_version(cuda_device, shape, dtype):
    *dims, chunk = shape
    dt = getattr(torch, dtype)
    arrs = _t(ssd_inputs(9, *dims), cuda_device, dt)
    x, dtv, A_log, B, C, D = arrs
    args = (x, dtv.float(), A_log.float(), B, C, D.float())
    before = skernel.KERNEL.launches
    got = sops.ssd_scan(*args, chunk=chunk)
    assert skernel.KERNEL.launches == before + 1
    torch.cuda.synchronize()
    want = sref.ssd_scan_ref(*args)
    assert got[0].dtype == dt and got[1].dtype == torch.float32
    _hold(*got, want[0].float().cpu().numpy(), want[1].cpu().numpy(),
          y_rel=Y_REL if dtype == "float32" else BF16_Y_REL)


@pytest.mark.cuda
def test_cuda_ssd_kernel_many_chunks_split_bc(cuda_device):
    """bf16 over 8 chunks of 128 (the state pass carries 7 states) with B
    and C as views of one (B, S, 2 ds) tensor, as ssm_forward passes
    them."""
    x, dt, A_log, B, C, D = _t(ssd_inputs(16, 2, 1024, 8, 64, 64),
                               cuda_device, torch.bfloat16, n_cast=1)
    Bv, Cv = torch.cat([B, C], -1).to(torch.bfloat16).split(64, dim=-1)
    before = skernel.KERNEL.launches
    got = sops.ssd_scan(x, dt, A_log, Bv, Cv, D)
    assert skernel.KERNEL.launches == before + 1
    torch.cuda.synchronize()
    want = sref.ssd_scan_ref(x, dt, A_log, Bv, Cv, D)
    _hold(*got, want[0].float().cpu().numpy(), want[1].cpu().numpy(),
          y_rel=BF16_Y_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,s0", [(s, False) for s in WKV_SHAPES]
                         + [((2, 100, 2, 32, 64), False),
                            ((2, 128, 2, 32, 64), True),
                            ((1, 70, 2, 6, 64), True),
                            ((1, 40, 1, 5, 32), True)])
def test_cuda_wkv_kernel_matches_plain_version(cuda_device, shape, s0,
                                               dtype):
    *dims, chunk = shape
    dt = getattr(torch, dtype)
    r, k, v, logw, u, st = _t(wkv_inputs(10, *dims, s0=s0), cuda_device, dt,
                              n_cast=3)
    before = wkernel.KERNEL.launches
    got = wops.wkv_scan(r, k, v, logw, u, s0=st, chunk=chunk)
    assert wkernel.KERNEL.launches == before + 1
    torch.cuda.synchronize()
    want = wref.wkv_scan_ref(r, k, v, logw, u, st)
    assert got[0].dtype == dt and got[1].dtype == torch.float32
    _hold(*got, want[0].float().cpu().numpy(), want[1].cpu().numpy(),
          y_rel=Y_REL if dtype == "float32" else BF16_Y_REL)


@pytest.mark.cuda
def test_cuda_wkv_kernel_strong_decay(cuda_device):
    """logw = -2 on every step: 64 steps decay a channel by e^-128, past
    fp32's range, where the reference's single factorisation r e^{cum}
    k e^{-cum} overflows; the kernel's sub-block rebasing stays finite
    and agrees with the recurrence."""
    r, k, v, logw, u, _ = _t(wkv_inputs(11, 2, 128, 2, 64), cuda_device)
    logw = torch.full_like(logw, -2.0)
    got = wkernel.wkv_scan(r, k, v, logw, u)
    torch.cuda.synchronize()
    want = wref.wkv_scan_ref(r, k, v, logw, u)
    assert bool(torch.isfinite(got[0]).all())
    _hold(*got, want[0].cpu().numpy(), want[1].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("logw", [None, -8.0])
def test_cuda_wkv_kernel_many_chunks_carried_state(cuda_device, dtype,
                                                   logw):
    """S = 1024 at chunk 64 (the state pass carries 15 chunk states) from
    a nonzero s0, with the tests' decays and with logw = -8 on every step
    (each 16-step sub-block decays by e^-128): finite, one launch, and
    equal to the recurrence."""
    dt = getattr(torch, dtype)
    r, k, v, lw, u, s0 = _t(wkv_inputs(18, 2, 1024, 3, 64, s0=True),
                            cuda_device, dt, n_cast=3)
    if logw is not None:
        lw = torch.full_like(lw, logw)
    before = wkernel.KERNEL.launches
    got = wops.wkv_scan(r, k, v, lw, u, s0=s0)
    assert wkernel.KERNEL.launches == before + 1
    torch.cuda.synchronize()
    want = wref.wkv_scan_ref(r, k, v, lw, u, s0)
    assert bool(torch.isfinite(got[0]).all())
    _hold(*got, want[0].float().cpu().numpy(), want[1].cpu().numpy(),
          y_rel=Y_REL if dtype == "float32" else BF16_Y_REL)


@pytest.mark.cuda
def test_cuda_ops_take_the_kernels_in_the_model_layout(cuda_device):
    """ssd_scan reads B and C as strided views of one (B, S, 2 ds)
    tensor, as ssm_forward passes them; both ops launch their kernel."""
    x, dt, A_log, B, C, D = _t(ssd_inputs(12, 2, 256, 4, 64, 32),
                               cuda_device)
    bc = torch.cat([B, C], dim=-1)
    Bv, Cv = torch.split(bc, 32, dim=-1)
    assert not Bv.is_contiguous()
    before = skernel.KERNEL.launches
    got = sops.ssd_scan(x, dt, A_log, Bv, Cv, D)
    assert skernel.KERNEL.launches == before + 1
    want = sref.ssd_scan_ref(x, dt, A_log, B, C, D)
    _hold(*got, want[0].cpu().numpy(), want[1].cpu().numpy())
    r, k, v, logw, u, _ = _t(wkv_inputs(13, 1, 64, 2, 32), cuda_device)
    before = wkernel.KERNEL.launches
    wops.wkv_scan(r, k, v, logw, u)
    assert wkernel.KERNEL.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("with_dsT,want_ds0", [(True, True), (False, False),
                                               (True, False), (False, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,logw", [((2, 128, 2, 64), None),
                                        ((1, 100, 2, 32), None),
                                        ((2, 256, 3, 64), -8.0)])
def test_cuda_wkv_gradient_takes_the_backward_kernel(cuda_device, shape,
                                                     logw, dtype, with_dsT,
                                                     want_ds0):
    """On CUDA tensors that require grad ops.wkv_scan runs the forward
    kernel inside its autograd Function and the backward kernel once
    (no plain version): every gradient, with a non-zero u and s0, with and
    without a gradient on s_T and with and without one for s0, agrees
    with the plain backward on the same inputs (fp32: 1e-5 of each
    gradient's largest entry; bf16: one bf16 step at the top of the range
    for dr, dk, dv, rounded to bf16, 1e-5 for the fp32 dlogw, du and ds0)
    and is finite at logw = -8; a second backward of the same graph gives
    the same bits."""
    dt = getattr(torch, dtype)
    r, k, v, lw, u, s0 = _t(wkv_inputs(34, *shape, s0=True), cuda_device,
                            dt, n_cast=3)
    if logw is not None:
        lw = torch.full_like(lw, logw)
    rng = np.random.default_rng(35)
    dy = torch.as_tensor(rng.standard_normal(r.shape).astype(np.float32),
                         device=cuda_device).to(dt)
    dsT = torch.as_tensor(rng.standard_normal(s0.shape).astype(np.float32),
                          device=cuda_device)
    ins = [a.clone().requires_grad_() for a in (r, k, v, lw, u)]
    s0_in = s0.clone().requires_grad_(want_ds0)
    fwd, bwd = wkernel.KERNEL.launches, wkernel.KERNEL_BWD.launches
    y, sT = wops.wkv_scan(*ins, s0_in)
    assert y.grad_fn is not None and sT.grad_fn is not None
    outs, gouts = ([y, sT], [dy, dsT]) if with_dsT else ([y], [dy])
    wrt = ins + [s0_in] * want_ds0
    got = torch.autograd.grad(outs, wrt, gouts, retain_graph=True)
    torch.cuda.synchronize()
    assert wkernel.KERNEL.launches == fwd + 1
    assert wkernel.KERNEL_BWD.launches == bwd + 1
    assert [g.dtype for g in got] == [dt] * 3 + [torch.float32] * (
        2 + want_ds0)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    again = torch.autograd.grad(outs, wrt, gouts)
    assert wkernel.KERNEL_BWD.launches == bwd + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    pad = (-shape[1]) % 64
    padded = [torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
              for a in (r, k, v, lw, dy)]
    want = wref.wkv_scan_bwd_ref(*padded[:4], u, s0, padded[4],
                                 dsT if with_dsT else None)
    want = [w[:, :shape[1]] if i < 4 else w for i, w in enumerate(want)]
    rel = 1e-5 if dtype == "float32" else BF16_Y_REL
    _hold_grads(got[:3], want[:3], rel)
    _hold_grads(got[3:], want[3:3 + len(got[3:])], 1e-5)


@pytest.mark.cuda
def test_cuda_ssd_scan_raises_under_grad(cuda_device):
    """ssd_scan has no backward kernel yet: on CUDA tensors that require
    grad, with grad mode on, ops.ssd_scan raises and launches nothing;
    under no_grad it launches."""
    x, dt, A_log, B, C, D = _t(ssd_inputs(36, 1, 64, 2, 32, 16), cuda_device)
    x.requires_grad_()
    before = skernel.KERNEL.launches
    with pytest.raises(RuntimeError, match="ssd_scan: the backward"):
        sops.ssd_scan(x, dt, A_log, B, C, D)
    assert skernel.KERNEL.launches == before
    with torch.no_grad():
        sops.ssd_scan(x, dt, A_log, B, C, D)
    assert skernel.KERNEL.launches == before + 1
