"""Trainer of the ported LLM families (port of
`repro/launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch qwen2.5-3b --preset smoke --steps 20 --batch 4 --seq 64

Presets scale the architecture's family down while keeping its
structure, as the reference's do; `full` is the architecture's own
config (on the card). Entry points run on `cuda` unless asked for the
CPU, and raise without CUDA. Every family trains; on the card every
rwkv6 layer's scan runs the wkv_scan kernel forward and its backward
kernel, and every Mamba2 layer's the ssd_scan kernel and its backward
kernel. vlm batches carry zero image embeddings, as the reference's.
Checkpoints go through `repro_torch.checkpoint` in the reference's
format.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_config, get_smoke
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer as tf
from repro_torch.obs.metrics import Stopwatch
from repro_torch.optim import make_optimizer, warmup_cosine

PRESETS = {
    "smoke": dict(),  # the per-arch reduced config
    "25m": dict(n_layers=4, d_model=384, n_heads=6, n_kv_heads=2,
                head_dim=64, d_ff=1024, vocab=8192),
    "100m": dict(n_layers=8, d_model=640, n_heads=10, n_kv_heads=2,
                 head_dim=64, d_ff=1792, vocab=16384),
    "full": dict(),  # the architecture's own config
}


def scaled_config(arch: str, preset: str):
    if preset == "smoke":
        return get_smoke(arch)
    if preset == "full":
        return get_config(arch)
    base = get_smoke(arch)  # family structure (moe/ssm flags etc.)
    kw = dict(PRESETS[preset])
    if base.family == "hybrid":
        kw["shared_attn_every"] = 2
    if base.family == "vlm":
        kw["cross_attn_every"] = 2
    if base.n_experts:
        kw["n_experts"] = 8
        kw["d_ff"] = kw["d_ff"] // 4
    if base.family == "ssm":
        kw.pop("n_heads", None), kw.pop("n_kv_heads", None)
    return base.replace(**kw)


def train(arch: str, preset: str, steps: int, batch: int, seq: int,
          lr: float = 3e-4, log_every: int = 10, ckpt_dir: str | None = None,
          seed: int = 0, *, device=None, microbatches: int = 1,
          n_layers: int | None = None, params=None):
    """Train `arch` at `preset` for `steps` adamw steps (weight decay
    0.01, warmup_cosine) on `TokenPipeline(seed=seed)` batches, from
    parameters drawn on the CPU from `seed` and moved to the device (so
    every device starts from the same weights), or from `params` (a
    model of this config drawn by the caller, on the device, trained in
    place). `n_layers` cuts the preset's depth (its width stays).
    Returns (params, losses, cfg, seconds): each step's seconds end after
    its loss is read back."""
    device = resolve_device(device)
    cfg = scaled_config(arch, preset)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    if params is None:
        params = tf.init_params(cfg, torch.Generator().manual_seed(seed))
        params = params.to(device)
    n_params = steps_mod.count_params(params)
    print(f"[train] arch={arch} preset={preset} params={n_params/1e6:.1f}M "
          f"family={cfg.family} device={device}", flush=True)
    opt = make_optimizer("adamw", weight_decay=0.01)
    opt_state = opt.init(dict(params.named_parameters()))
    lr_fn = warmup_cosine(lr, warmup=max(10, steps // 20), total_steps=steps)
    step_fn = steps_mod.make_train_step(cfg, opt, lr_fn,
                                        microbatches=microbatches)
    pipe = iter(TokenPipeline(cfg.vocab, batch, seq,
                              n_codebooks=cfg.n_codebooks, seed=seed))
    losses, seconds = [], []
    sw = Stopwatch()
    for step in range(steps):
        hb = next(pipe)
        sw.start()
        b = {k: torch.as_tensor(hb[k], device=device)
             for k in ("tokens", "labels")}
        if cfg.family == "vlm":
            b["img_emb"] = torch.zeros((batch, cfg.n_img_tokens,
                                        cfg.d_vision), dtype=torch.bfloat16,
                                       device=device)
        losses.append(float(step_fn(params, opt_state, b)))
        seconds.append(sw.stop())
        if step % log_every == 0 or step == steps - 1:
            tok_s = (step + 1) * batch * seq / max(sw.total, 1e-9)
            print(f"  step {step:5d} loss {losses[-1]:.4f} "
                  f"({tok_s:.0f} tok/s)", flush=True)
    if ckpt_dir:
        store = CheckpointStore(ckpt_dir)
        name = f"{arch}_{preset}_final"
        store.publish(name, tf.params_to_jax(cfg, params),
                      {"arch": arch, "preset": preset, "steps": steps,
                       "final_loss": losses[-1]})
        print(f"[train] checkpoint published to {store.path(name)}")
    return params, losses, cfg, seconds


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--preset", default="25m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    a = ap.parse_args(argv)
    _, losses, _, _ = train(a.arch, a.preset, a.steps, a.batch, a.seq, a.lr,
                            ckpt_dir=a.ckpt_dir, device=a.device)
    assert losses[-1] < losses[0], "loss did not decrease"
    print(f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
