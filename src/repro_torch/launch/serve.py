"""Serving entry point: batched prefill + decode, single-model or FedPAE
k-ensemble (weighted mean of per-model softmax probabilities — the
paper's soft-vote inference path at LLM scale). Port of
`repro/launch/serve.py`.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --device cpu

`serve_batch` serves token prompts through `transformer.forward`, as
the reference's does. Its prefill runs the family's kernel on CUDA
tensors and the kernel's plain version on CPU tensors: with
`attn_impl="pallas"` every self-attention layer of the kv_major configs
(dense, moe, vlm, audio) runs flash_attention (the g_major
qwen3-moe-235b-a22b takes the plain path, as in the reference); every
rwkv6 layer runs wkv_scan and every zamba2 Mamba2 layer ssd_scan. The
prefill runs under `attn_impl="pallas"` whatever the config says
wherever the kernel computes the config's own attention
(`attention.kernel_computes`: kv_major, no per-layer window, a head dim
the kernel takes), so zamba2's shared attention and the "xla" dense
configs take flash_attention too.
Decode is plain PyTorch, as in the reference. Two families keep the
reference's limits:
- vlm is served text-only: no image embeddings reach `forward`, so each
  cross layer attends causally to its own input in the prefill (through
  flash_attention under "pallas") and keeps those keys and values as its
  static decode cache;
- audio is refused: `B, S = prompts.shape` does not take its (B, S, ncb)
  prompts (a ValueError).
Images and codebooks are served through `launch/steps.py`'s prefill and
serve steps.

While a profiler records, `serve_batch` opens spans (`obs/spans.py`):
`serve.call` around the call and `serve.prefill{member=i}` around each
member's prefill; the vote and the decode are the call's self time.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.attention import kernel_computes
from repro_torch.obs.metrics import Stopwatch
from repro_torch.obs.spans import span


def prefill_config(cfg):
    """The config the members' prefill runs under: `attn_impl="pallas"`
    where the kernel computes the config's own attention, else `cfg`."""
    return cfg.replace(attn_impl="pallas") if kernel_computes(cfg) else cfg


@torch.inference_mode()
def serve_batch(cfg, members, prompts, gen_len: int = 16, weights=None):
    """prompts: (B, S) integer tensor on the members' device. Returns the
    generated (B, gen_len) int32 tokens. len(members) == 1 -> single
    model; > 1 -> FedPAE ensemble."""
    B, S = prompts.shape
    with span("serve.call", device=prompts.device):
        cache_len = S + gen_len
        w = np.ones(len(members)) if weights is None else \
            np.asarray(weights, np.float64)
        w = w / w.sum()

        pcfg = prefill_config(cfg)
        caches, prob_sum = [], 0.0
        for i, (wi, model) in enumerate(zip(w, members)):
            with span("serve.prefill", member=i):
                logits, cache = tf.forward(model, pcfg, prompts,
                                           mode="prefill", cache_len=cache_len)
            caches.append(cache)
            prob_sum = prob_sum + float(wi) * torch.softmax(
                logits[:, -1].float(), dim=-1)
            del logits
        out = []
        tok = torch.argmax(prob_sum, dim=-1)[:, None].to(torch.int32)
        out.append(tok)
        for g in range(1, gen_len):
            pos = S + g - 1
            prob_sum = 0.0
            for i, (wi, model) in enumerate(zip(w, members)):
                logits, caches[i] = tf.forward(model, cfg, tok, mode="decode",
                                               cache=caches[i], t=pos)
                prob_sum = prob_sum + float(wi) * torch.softmax(
                    logits[:, -1].float(), dim=-1)
            tok = torch.argmax(prob_sum, dim=-1)[:, None].to(torch.int32)
            out.append(tok)
        return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--ensemble", type=int, default=1,
                    help="number of models in the served ensemble")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    cfg = get_smoke(a.arch)
    members = [tf.init_params(cfg, torch.Generator(device).manual_seed(i))
               for i in range(a.ensemble)]
    prompts = next(iter(TokenPipeline(cfg.vocab, a.batch, a.prompt_len,
                                      seed=0)))["tokens"]
    prompts = torch.as_tensor(prompts, device=device)
    sw = Stopwatch().start()
    toks = serve_batch(cfg, members, prompts, a.gen_len).cpu()
    dt = sw.stop()
    print(f"[serve] arch={a.arch} ensemble={a.ensemble} device={device} "
          f"generated {tuple(toks.shape)} in {dt:.1f}s "
          f"({a.batch * a.gen_len / dt:.1f} tok/s)")
    print("sample:", toks[0].numpy())


if __name__ == "__main__":
    main()
