"""FedPAE at LLM scale: serve a k-ensemble of language models with
batched requests; compare single-model against ensemble negative
log-likelihood on held-out synthetic data (port of
`examples/serve_ensemble.py`).

    PYTHONPATH=src python -m repro_torch.examples.serve_ensemble --device cpu

Each member is trained from its own seed at the architecture's smoke
preset (`launch/train.py`), then scored on one held-out batch and
served through `launch/serve.py::serve_batch` (so not the audio family,
whose codebook prompts serve_batch refuses).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.data import TokenPipeline
from repro_torch.launch.serve import serve_batch
from repro_torch.launch.train import train
from repro_torch.models import transformer as tf


@torch.no_grad()
def nll(cfg, params, tokens, labels):
    logits, _ = tf.forward(params, cfg, tokens, mode="train")
    logp = torch.log_softmax(logits.float(), dim=-1)
    return float(-torch.mean(torch.gather(logp, -1,
                                          labels[..., None].long())))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--members", type=int, default=3)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    a = ap.parse_args(argv)
    # "clients" train the same family from different seeds/data shards
    members, cfg = [], None
    for seed in range(a.members):
        params, _, cfg, _ = train(a.arch, "smoke", steps=a.steps, batch=8,
                                  seq=64, seed=seed, log_every=30,
                                  device=a.device)
        members.append(params)
    device = next(members[0].parameters()).device
    pipe = iter(TokenPipeline(cfg.vocab, 8, 64, seed=999))
    hb = next(pipe)
    toks, labs = (torch.as_tensor(hb[k], device=device)
                  for k in ("tokens", "labels"))
    singles = [nll(cfg, p, toks, labs) for p in members]
    # ensemble NLL via the mean probability
    with torch.no_grad():
        probs = sum(torch.softmax(tf.forward(p, cfg, toks, mode="train")[0]
                                  .float(), -1) for p in members) / len(
                                      members)
    ens = float(-torch.mean(torch.log(torch.gather(
        probs, -1, labs[..., None].long()) + 1e-9)))
    print(f"single-model NLLs: {np.round(singles, 4)}")
    print(f"{len(members)}-ensemble NLL   : {ens:.4f}")
    assert ens <= min(singles) + 0.05, "ensemble should not be much worse"

    # batched generation through the serving path
    prompts = torch.as_tensor(next(pipe)["tokens"][:4, :32], device=device)
    out = serve_batch(cfg, members, prompts, gen_len=8)
    print("ensemble generation:", out[0].cpu().numpy())


if __name__ == "__main__":
    main()
