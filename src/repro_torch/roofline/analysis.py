"""Three-term roofline from the dry run's records (port of
`repro/roofline/analysis.py`).

  compute    = flops_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / LINK_BW

Hardware constants: NVIDIA's data sheet for the H100 SXM5 (80 GB) at its
700 W power limit: 989 TFLOP/s dense bf16 tensor-core, 3.35 TB/s HBM3,
NVLink 4 at 450 GB/s each way. A card run below 700 W reaches less; the
card's name and power limit go beside every time measured against these
(`nvidia-smi --query-gpu=name,power.limit`). A 16-way `model` axis spans
two 8-card hosts, whose link between them is slower than NVLink: there
the collective term is a lower bound. MODEL_FLOPS = 6 N D (train) /
2 N D (inference), N_active for MoE; the MODEL_FLOPS / counted ratio
surfaces remat and dispatch overhead. The dry run counts matrix FLOPs
only (`launch/dryrun.py`), so that ratio is against matrix work.

    python -m repro_torch.roofline.analysis 16x16 [records dir]
"""
from __future__ import annotations

import glob
import json
import os

PEAK_FLOPS = 989e12   # H100 SXM, bf16 dense tensor core, 700 W
HBM_BW = 3.35e12      # H100 SXM, HBM3 bytes / s
LINK_BW = 450e9       # H100 SXM, NVLink 4 bytes / s each way

_SUGGEST = {
    "compute": "increase per-card arithmetic intensity (reduce remat "
               "recompute, fuse elementwise chains, larger per-device "
               "batch)",
    "memory": "improve reuse (flash/blocked attention, fuse norm+matmul, "
              "wider tiles so weights stream once per step)",
    "collective": "reshard to cut cross-card traffic (fewer all-gathers via "
                  "head-aligned TP, overlap collectives with compute, "
                  "reduce-scatter gradient fusion)",
}


def model_flops(cfg, shape, n_params: int) -> float:
    """Analytic 'useful' FLOPs per step (global, not per-device)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_active = active_params(cfg, n_params)
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens


def active_params(cfg, n_params: int) -> float:
    """MoE: count experts at top_k/E utilization."""
    if not cfg.n_experts:
        return float(n_params)
    expert_per_layer = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts
    expert_total = expert_per_layer * cfg.n_layers
    dense_rest = n_params - expert_total
    return dense_rest + expert_total * cfg.top_k / cfg.n_experts


# The port's own count of the traffic a dense-score attention element
# costs (`models.attention.attn_core`, bf16 q/k/v, fp32 scores), from the
# dry run's byte counter (`launch.dryrun._Bytes`): the QK einsum writes
# the fp32 score (4), the scale reads and writes it (4 + 4), the causal
# `where` reads and writes it (4 + 4), the softmax reads and writes it
# (4 + 4), the cast to bf16 reads fp32 and writes bf16 (4 + 2), the PV
# einsum reads the bf16 probability (2): 36 bytes an element of every
# (head, query, key). Counted as the slope over heads at two sequence
# lengths (the mask's (S, T) bytes, shared by the heads, and the q/k/v
# bytes drop out); a softcap adds its tanh's (4 + 4) and two more scale
# passes, which this constant leaves out.
BYTES_PER_SCORE_ELEM = 36.0


def attention_score_elems(cfg, shape, n_devices: int) -> float:
    """Dense-attention score elements per device per step (what the flash
    kernel keeps on chip instead of in HBM)."""
    if cfg.family == "ssm" or shape.kind == "decode":
        return 0.0
    n_attn_layers = cfg.n_layers
    if cfg.family == "hybrid":
        n_attn_layers = cfg.n_layers // max(1, cfg.shared_attn_every)
    S = shape.seq_len
    per_layer = shape.global_batch * cfg.n_heads * float(S) * S
    mult = 3.0 if shape.kind == "train" else 1.0  # fwd + remat-fwd + bwd
    return n_attn_layers * per_layer * mult / n_devices


def flash_adjusted_bytes(rec, cfg, shape) -> float:
    """Memory bytes with the flash_attention kernel: score traffic never
    touches HBM (kernels/flash_attention); streaming qkv/out is negligible
    next to it."""
    byts = rec.get("bytes_per_device") or 0.0
    saved = BYTES_PER_SCORE_ELEM * attention_score_elems(cfg, shape,
                                                         rec["n_devices"])
    return max(byts - saved, byts * 0.05)


def roofline_terms(rec: dict) -> dict:
    flops = rec.get("flops_per_device") or 0.0
    byts = rec.get("bytes_per_device") or 0.0
    coll = sum(rec.get("collective_bytes_per_device", {}).values())
    t_c = flops / PEAK_FLOPS
    t_m = byts / HBM_BW
    t_x = coll / LINK_BW
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "dominant": dom, "suggest": _SUGGEST[dom],
            "step_lower_bound_s": max(t_c, t_m, t_x)}


def analyze_all(dryrun_dir=None, mesh="16x16"):
    """Full roofline table for one mesh from the dry run's records
    (`launch/dryrun.py --out`, results/torch/dryrun by default). Returns
    a list of row dicts."""
    if dryrun_dir is None:
        dryrun_dir = "results/torch/dryrun"
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import SHAPES, arch_for_shape

    rows = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec["mesh"] != mesh:
            continue
        shape = SHAPES[rec["shape"]]
        cfg = arch_for_shape(get_config(rec["arch"]), shape)
        terms = roofline_terms(rec)
        mf = model_flops(cfg, shape, rec["n_params"])
        hlo_global = (rec.get("flops_per_device") or 0.0) * rec["n_devices"]
        mem_flash = flash_adjusted_bytes(rec, cfg, shape) / HBM_BW
        temp = rec["memory"]["temp_bytes"]
        rows.append({
            "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            **{k: terms[k] for k in ("compute_s", "memory_s", "collective_s",
                                     "dominant", "step_lower_bound_s")},
            "memory_flash_s": mem_flash,
            "model_flops": mf,
            "hlo_flops_global": hlo_global,
            "useful_ratio": (mf / hlo_global) if hlo_global else None,
            "hbm_gb_per_device": temp / 1e9 if temp >= 0 else None,
            "args_gb_per_device": rec["memory"]["argument_bytes"] / 1e9,
            "suggest": terms["suggest"],
        })
    return rows


def markdown_table(rows) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| MODEL/counted | args GB/dev |\n|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        ur = f"{r['useful_ratio']:.2f}" if r["useful_ratio"] else "-"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3g} | "
            f"{r['memory_s']:.3g} | {r['collective_s']:.3g} | "
            f"**{r['dominant']}** | {ur} | {r['args_gb_per_device']:.2f} |")
    return "\n".join(lines)


if __name__ == "__main__":
    import sys
    mesh = sys.argv[1] if len(sys.argv) > 1 else "16x16"
    rows = analyze_all(sys.argv[2] if len(sys.argv) > 2 else None,
                       mesh=mesh)
    print(markdown_table(rows))
