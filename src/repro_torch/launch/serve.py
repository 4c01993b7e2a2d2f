"""Serving launcher: batched greedy decode with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \
        --batch 4 --prompt-len 16 --gen 32 [--reduced | --full] [--device cpu]

The model is the reduced config unless ``--full``; it runs on the card
unless ``--device`` names another (``cpu`` runs the kernels' plain
versions). Weights are random from seed 0, the prompt from seed 1.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import build_model


def generate(model, prompt: torch.Tensor, gen: int) -> torch.Tensor:
    """Greedy decoding of ``gen`` tokens after ``prompt`` (B, P) int32,
    the prompt fed token by token through the cache as the reference's
    launcher does: P + gen - 1 decode steps. The argmax stays on the
    device; returns the (B, gen) int32 tokens there (no host copy)."""
    b, p = prompt.shape
    total = p + gen
    cache = model.init_cache(b, total)
    tok = prompt[:, :1]
    out = []
    for t in range(total - 1):
        logits, cache = model.decode_step(cache, tok, t)
        if t + 1 < p:
            tok = prompt[:, t + 1:t + 2]
        else:
            tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
            out.append(tok)
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    model = build_model(cfg, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)

    t0 = time.perf_counter()
    tokens = generate(model, prompt, args.gen).cpu()
    dt = time.perf_counter() - t0
    print(f"generated {tuple(tokens.shape)} tokens in {dt:.2f}s "
          f"({tokens.numel() / dt:.1f} tok/s)")
    print("sample:", tokens[0, :16].tolist())
    return tokens


if __name__ == "__main__":
    main()
