"""Mamba2-style selective SSM block (SSD), port of `repro/models/ssm.py`.

    h_t = exp(a_t) h_{t-1} + dt_t * (B_t outer x_t)      a_t = -exp(A_log) dt_t
    y_t = C_t . h_t + D * x_t

with per-head scalar decay a_t and state (hd, ds) per head. The
projections are separate z / x / BC / dt weights, the gate norm is
per-head (grouped RMSNorm, as in Mamba2). Decode is one O(1) state update
in plain PyTorch, as in the reference.

The train/prefill scan goes through `kernels/ssd_scan/ops.py` where the
reference calls its chunked jnp scan `ssd_chunk_scan` (ssm.py:140): the
CUDA kernel for CUDA tensors, the naive recurrence for CPU tensors. The
function is the same; `ssd_chunk_scan` is kept as a torch copy, held
against the reference's; on `meta` tensors (the dry run) the model takes
it, as the reference's own scan.

Under a layout (`lay=`, `sharding/layout.py`) the block is head-parallel
where the rules split it (`ssm_ok`: the heads divide `model`): `in_z`,
`in_x`, `in_dt`, `conv_x`, `conv_xb`, `norm`, `A_log`, `D` and
`dt_bias` split over `model`, `in_bc` and `conv_bc` whole (B and C are
shared by all heads), one all-reduce at `out_proj` (a reduce-scatter
into the sequence-split training residual). The grouped norm is per
head, so it needs no reduction across ranks. The decode state is whole
over `model` (`rules.cache_shardings` splits it over the batch only):
each rank reads its heads' part and the new state's heads and conv
features are gathered over `model`, one token's worth a step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.launch.mesh import all_gather_over

from .common import ModelConfig, Params, dense_init, init_rms

CHUNK = 256


def ssm_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    nh = d_inner // cfg.ssm_head_dim
    return d_inner, nh, cfg.ssm_state


def init_ssm(cfg: ModelConfig, gen: torch.Generator) -> Params:
    d = cfg.d_model
    d_inner, nh, ds = ssm_dims(cfg)
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return Params({
        "in_z": dense_init(gen, (d, d_inner), 0, cfg.cdtype),
        "in_x": dense_init(gen, (d, d_inner), 0, cfg.cdtype),
        "in_bc": dense_init(gen, (d, 2 * ds), 0, cfg.cdtype),
        "in_dt": dense_init(gen, (d, nh), 0, cfg.cdtype),
        "conv_x": dense_init(gen, (cfg.ssm_conv, d_inner), 0,
                             torch.float32) * 0.1,
        "conv_bc": dense_init(gen, (cfg.ssm_conv, 2 * ds), 0,
                              torch.float32) * 0.1,
        "conv_xb": torch.zeros((d_inner,), **f32),
        "conv_bcb": torch.zeros((2 * ds,), **f32),
        "A_log": torch.zeros((nh,), **f32),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.zeros((nh,), **f32),
        "norm": init_rms(d_inner, dev),  # applied per head (grouped RMSNorm)
        "out_proj": dense_init(gen, (d_inner, d), 0, cfg.cdtype),
    })


def _conv_train(u, w, b):
    """Depthwise causal conv over the sequence. u: (B, S, C) fp32; w: (K,
    C)."""
    K = w.shape[0]
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + u.shape[1], :] * w[i] for i in range(K))
    return F.silu(out + b)


def _group_rms(y, scale, nh, hd, eps):
    """Per-head RMSNorm (Mamba2 grouped norm)."""
    B, S, _ = y.shape
    yh = y.reshape(B, S, nh, hd).float()
    yh = yh * torch.rsqrt(torch.mean(yh * yh, dim=-1, keepdim=True) + eps)
    yh = yh * (1.0 + scale.float().reshape(nh, hd))
    return yh.reshape(B, S, nh * hd).to(y.dtype)


def ssd_chunk_scan(x, dt, A_log, B, C, D):
    """Chunked SSD from h_0 = 0, a torch copy of the reference's (not on
    the model path). x: (B, S, nh, hd); dt: (B, S, nh) (post-softplus);
    B, C: (B, S, ds); returns (y, h_final (B, nh, hd, ds))."""
    Bb, S, nh, hd = x.shape
    ds = B.shape[-1]
    Q = min(CHUNK, S)
    nc = S // Q
    A = -torch.exp(A_log)  # (nh,) negative
    a = dt * A  # (B, S, nh) log-decay per step

    xc = x.reshape(Bb, nc, Q, nh, hd)
    dtc = dt.reshape(Bb, nc, Q, nh)
    ac = a.reshape(Bb, nc, Q, nh)
    Bc = B.reshape(Bb, nc, Q, ds)
    Cc = C.reshape(Bb, nc, Q, ds)

    cum = torch.cumsum(ac, dim=2)  # (B, nc, Q, nh) cumulative log decay
    # intra-chunk: scores[i,j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j, j <= i
    CB = torch.einsum("bnqs,bnts->bnqt", Cc, Bc)  # (B, nc, Q, Q)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,nh)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    L = torch.exp(torch.where(mask, li, float("-inf")))
    scores = CB[..., None] * L * dtc[:, :, None, :, :]  # (B,nc,Q(i),Q(j),nh)
    y_intra = torch.einsum("bnqth,bnthd->bnqhd", scores.to(x.dtype), xc)

    # inter-chunk state: S_chunk = sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T
    wj = torch.exp(cum[:, :, -1:, :] - cum) * dtc  # (B, nc, Q, nh)
    S_chunk = torch.einsum("bnqh,bnqs,bnqhd->bnhds", wj.to(x.dtype),
                           Bc.to(x.dtype), xc)
    decay_chunk = torch.exp(cum[:, :, -1, :])  # (B, nc, nh) chunk decay

    h = torch.zeros((Bb, nh, hd, ds), dtype=x.dtype, device=x.device)
    h_prevs = []  # the state at the START of each chunk
    for n in range(nc):
        h_prevs.append(h)
        h = h * decay_chunk[:, n, :, None, None].to(h.dtype) + S_chunk[:, n]
    h_prevs = torch.stack(h_prevs)  # (nc, B, nh, hd, ds)
    y_inter = torch.einsum("bnqs,bnqh,nbhds->bnqhd", Cc.to(x.dtype),
                           torch.exp(cum).to(x.dtype), h_prevs)
    y = y_intra + y_inter + xc * D[None, None, None, :, None].to(x.dtype)
    return y.reshape(Bb, S, nh, hd), h


def _project(p, cfg, x):
    z = x @ p["in_z"]
    xs = x @ p["in_x"]
    bc = x @ p["in_bc"]
    dt = x @ p["in_dt"]
    return z, xs, bc, dt


_SPLIT = ("in_z", "in_x", "in_dt", "conv_x", "conv_xb", "norm", "A_log",
          "D", "dt_bias", "out_proj")


def _local(p, cfg, lay):
    """(this rank's leaves, its region, its d_inner, its heads)."""
    d_inner, _, _ = ssm_dims(cfg)
    region = lay.region(p["in_x"].shape[1] < d_inner)
    pp = {n: p[n] if region.split and n in _SPLIT else region.rep(p[n])
          for n, _ in p.named_parameters(recurse=False)}
    return pp, region, pp["in_x"].shape[1], pp["in_dt"].shape[1]


def _gather_heads(t, lay, dim, region):
    """A head-split decode state -> whole over `model`."""
    return all_gather_over(t, lay.mesh, "model", dim) if region.split else t


def ssm_forward(p, cfg: ModelConfig, x, lay=None, keep_state=True):
    """Train/prefill path. x: (B, S, d) -> (out, state); under a layout
    the state is made (whole over `model`) only when `keep_state`."""
    if lay is not None:
        p, region, d_inner, nh = _local(p, cfg, lay)
        x = region.into(x)
    B, S, d = x.shape
    if lay is None:
        d_inner, nh, _ = ssm_dims(cfg)
    ds = cfg.ssm_state
    z, xs, bc, dt = _project(p, cfg, x)
    xs = _conv_train(xs.float(), p["conv_x"], p["conv_xb"]).to(x.dtype)
    bc = _conv_train(bc.float(), p["conv_bc"], p["conv_bcb"]).to(x.dtype)
    Bm, Cm = torch.split(bc, ds, dim=-1)
    dtp = F.softplus(dt.float() + p["dt_bias"])
    xh = xs.reshape(B, S, nh, cfg.ssm_head_dim)
    if xh.device.type == "meta":    # the dry run counts the chunked scan
        y, hT = ssd_chunk_scan(xh, dtp, p["A_log"], Bm, Cm, p["D"])
    else:
        y, hT = ssd_scan(xh, dtp, p["A_log"], Bm, Cm, p["D"])
    y = y.reshape(B, S, d_inner) * F.silu(z)
    y = _group_rms(y, p["norm"], nh, cfg.ssm_head_dim, cfg.norm_eps)
    out = y @ p["out_proj"]
    if lay is None:
        return out, {"h": hT, "conv": conv_tail(x, p, cfg)}
    if keep_state:
        hT = _gather_heads(hT, lay, 1, region)
        tail = conv_tail(x, p, cfg)
        tail = torch.cat([_gather_heads(tail[..., :d_inner], lay, 2, region),
                          tail[..., d_inner:]], dim=-1)
    else:
        hT = tail = None
    return region.out(out), {"h": hT, "conv": tail}


def conv_tail(x, p, cfg):
    """Last K-1 pre-conv features, for seamless prefill -> decode."""
    K = cfg.ssm_conv
    tail = x[:, -(K - 1):, :]
    if tail.shape[1] < K - 1:  # short prefill: left-pad with zeros
        tail = F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0))
    xs = tail @ p["in_x"]
    bc = tail @ p["in_bc"]
    return torch.cat([xs, bc], dim=-1).float()


def init_ssm_state(cfg: ModelConfig, batch: int, device=None):
    d_inner, nh, ds = ssm_dims(cfg)
    return {
        "h": torch.zeros((batch, nh, cfg.ssm_head_dim, ds), dtype=cfg.cdtype,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * ds),
                            dtype=torch.float32, device=device),
    }


def ssm_decode(p, cfg: ModelConfig, x, state, lay=None):
    """One-token decode. x: (B, 1, d) -> (out, new_state). O(1) in
    context."""
    B = x.shape[0]
    d_inner, nh, ds = ssm_dims(cfg)
    region = None
    if lay is not None:
        d_full = d_inner
        p, region, d_inner, nh = _local(p, cfg, lay)
        if region.split:    # this rank's heads of the whole state
            lo = lay.r_model * d_inner
            conv = state["conv"]
            state = {"h": state["h"].narrow(1, lay.r_model * nh, nh),
                     "conv": torch.cat([conv[..., lo:lo + d_inner],
                                        conv[..., d_full:]], dim=-1)}
    z, xs, bc, dt = _project(p, cfg, x)
    feats = torch.cat([xs[:, 0], bc[:, 0]], dim=-1).float()
    conv_buf = torch.cat([state["conv"], feats[:, None, :]], dim=1)  # (B,K,C)
    w_all = torch.cat([p["conv_x"], p["conv_bc"]], dim=1)
    b_all = torch.cat([p["conv_xb"], p["conv_bcb"]])
    conv_out = F.silu(torch.einsum("bkc,kc->bc", conv_buf, w_all) + b_all)
    conv_out = conv_out.to(x.dtype)
    xs1, Bm, Cm = torch.split(conv_out, [d_inner, ds, ds], dim=-1)
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])  # (B, nh)
    A = -torch.exp(p["A_log"])
    dec = torch.exp(dt1 * A)  # (B, nh)
    xh = xs1.reshape(B, nh, cfg.ssm_head_dim)
    h = state["h"].float()
    h = h * dec[:, :, None, None] + (dt1[:, :, None] * xh)[..., None] \
        * Bm[:, None, None, :].float()
    y = torch.einsum("bhds,bs->bhd", h, Cm.float())
    y = y + xh.float() * p["D"][None, :, None]
    y = y.reshape(B, 1, d_inner).to(x.dtype) * F.silu(z)
    y = _group_rms(y, p["norm"], nh, cfg.ssm_head_dim, cfg.norm_eps)
    out = y @ p["out_proj"]
    new_state = {"h": h.to(state["h"].dtype), "conv": conv_buf[:, 1:, :]}
    if region is not None:
        conv = new_state["conv"]
        new_state = {"h": _gather_heads(new_state["h"], lay, 1, region),
                     "conv": torch.cat([
                         _gather_heads(conv[..., :d_inner], lay, 2, region),
                         conv[..., d_inner:]], dim=-1)}
        out = region.out(out)
    return out, new_state
