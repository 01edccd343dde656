"""The yardstick's arithmetic: the card's published peaks and the least
bytes and operations of a scan kernel's call, from its shapes and types
alone (so they read the same work whatever implements the kernel), and
the model FLOPs that the mfu metrics count. The kernel counts are a
frozen copy of `chip_smoke.py`'s (`ssd_cost`, `wkv_cost`,
`wkv_bwd_cost`, `roofline`), which set PERF.md's kernel table;
`test_bench_harness.py` holds them equal (`ssd_cost` at one B/C group,
chip_smoke.py's only case). What a configuration runs of each (its scan
shapes, its attention) is its family's (`families/<equations>.py`)."""
from __future__ import annotations

from bench import families

PEAK_FP32_FLOPS = 67e12       # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12      # H100 SXM, bf16 dense tensor cores
TERMS = 3       # bf16 terms of an fp32 factor against an exact bf16 operand
TERMS_F32 = 6   # products of 3-term splits of two fp32 factors, i + j <= 2


def _chunk_sizes(S):
    """The chunk sizes a chunked scan could take at length S: the powers
    of two that divide S (1 is the plain recurrence)."""
    return [q for q in (2 ** i for i in range(S.bit_length())) if S % q == 0]


def _ops_time(fp32, tc, fp32_rate, elem_bytes, terms=TERMS):
    """Seconds of `fp32` fp32-factor FLOP and `tc` exact bf16 FLOP: on the
    fp32 FMA units (fp32_rate, or fp32 activations) or on the bf16 tensor
    cores at `terms` products a multiply-add."""
    if fp32_rate or elem_bytes != 2:
        return fp32 / PEAK_FP32_FLOPS + tc / PEAK_BF16_FLOPS
    return (terms * fp32 + tc) / PEAK_BF16_FLOPS


def ssd_cost(Bb, S, nh, hd, ds, elem_bytes, groups=1):
    """The ssd_scan call's bytes (x, B, C and y in the activation type,
    dt, A_log, D and h_T in fp32, each moved once) and least multiply-add
    work, as (bytes, fp32-factor FLOP, exact bf16 FLOP), by `fp32_rate`:
    the chunked form's at the chunk size that needs least time (see
    chip_smoke.py). B and C come in `groups` groups of heads, each its
    own (S, ds) and its own C B^T."""
    nbytes = (elem_bytes * (2 * Bb * S * nh * hd + 2 * Bb * S * ds * groups)
              + 4 * (Bb * S * nh + 2 * nh + Bb * nh * hd * ds))
    out = {}
    for fp32_rate in (False, True):
        best = None
        for Q in _chunk_sizes(S):
            fp32 = Bb * nh * (S // Q) * (Q * (Q + 1) * hd + 4 * Q * hd * ds
                                         + hd * ds)
            cb = Bb * (S // Q) * Q * (Q + 1) * ds * groups
            if elem_bytes != 2:
                fp32, cb = fp32 + cb, 0
            t = _ops_time(fp32, cb, fp32_rate, elem_bytes)
            if best is None or t < best[0]:
                best = (t, fp32, cb)
        out[fp32_rate] = (nbytes, best[1], best[2])
    return out


def wkv_cost(B, S, nh, hd, elem_bytes, with_s0):
    """The wkv_scan call's bytes (r, k, v and y in the activation type,
    logw, u, s0 if given and s_T in fp32) and least work, all with fp32
    factors (see chip_smoke.py); priced at TERMS_F32."""
    nbytes = (elem_bytes * 4 * B * S * nh * hd
              + 4 * (B * S * nh * hd + nh * hd
                     + (2 if with_s0 else 1) * B * nh * hd * hd))
    flops = min(B * nh * (S // Q) * (2 * Q * (Q - 1) * hd + 4 * Q * hd * hd
                                     + hd * hd) for Q in _chunk_sizes(S))
    return {rate: (nbytes, flops, 0) for rate in (False, True)}


def wkv_bwd_cost(B, S, nh, hd, elem_bytes):
    """The backward's bytes (r, k, v, dy read and dr, dk, dv written in
    the activation type, logw and dlogw in fp32, u and du) and least
    work: twice the forward's; priced at TERMS_F32."""
    nbytes = (elem_bytes * 7 * B * S * nh * hd
              + 4 * (2 * B * S * nh * hd + 2 * nh * hd))
    flops = 2 * wkv_cost(B, S, nh, hd, elem_bytes, False)[False][1]
    return {rate: (nbytes, flops, 0) for rate in (False, True)}


def roofline(nbytes, fp32_flops, tc_flops, fp32_rate, elem_bytes,
             terms=TERMS):
    """(ms, bound_by): the larger of the bytes over the memory rate and
    the operations over the rate of the unit that does them."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = _ops_time(fp32_flops, tc_flops, fp32_rate, elem_bytes, terms)
    return 1e3 * max(t_bytes, t_ops), \
        "operations" if t_ops >= t_bytes else "bytes"


# --- the least time of one call of each kernel on the served path ---

def wkv_bound_s(B, S, nh, hd, with_s0=True):
    return roofline(*wkv_cost(B, S, nh, hd, 2, with_s0)[False], False, 2,
                    TERMS_F32)[0] * 1e-3


def wkv_bwd_bound_s(B, S, nh, hd):
    return roofline(*wkv_bwd_cost(B, S, nh, hd, 2)[False], False, 2,
                    TERMS_F32)[0] * 1e-3


def ssd_bound_s(B, S, nh, hd, ds, groups=1):
    return roofline(*ssd_cost(B, S, nh, hd, ds, 2, groups)[False], False, 2,
                    TERMS)[0] * 1e-3


# --- model FLOPs (the mfu metrics) ---

def scan_flops(arch: dict, B: int, S: int) -> float:
    """The scans' least FLOP of one member's forward over (B, S), as its
    family counts them."""
    return families.get(arch).scan_flops(arch, B, S)


def attention_flops(arch: dict, B: int, S: int) -> float:
    """Causal attention's QK^T and PV FLOP of one member over (B, S): its
    family's applications a member (none where it has no attention)."""
    att = families.get(arch).attention(arch)
    if att is None:
        return 0.0
    uses, H, _, hd = att
    pairs = S * (S + 1) / 2
    return uses * 2 * 2 * B * H * pairs * hd


def score_flops(arch: dict, n_body: int, B: int, S: int) -> float:
    """One member's forward FLOP that a scoring call needs: 2 x the
    non-embedding parameters a token passes through (`n_body`,
    `weights.count_applied`: a shared block once per application), the
    scans and attention, and the head at each row's last position only."""
    head = 2 * arch["d_model"] * arch["vocab"] * B
    return 2 * n_body * B * S + scan_flops(arch, B, S) \
        + attention_flops(arch, B, S) + head


def train_flops(n_body_and_head: int, tokens: int) -> float:
    """6 x (non-embedding + head parameters) a token; recompute not
    counted."""
    return 6 * n_body_and_head * tokens
