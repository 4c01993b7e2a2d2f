"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 200 --batch 8 --seq 256 [--reduced | --full] \
        [--ckpt-dir ckpt/] [--device cpu]

The model is the reduced config unless ``--full``; it runs on the card
unless ``--device`` names another (``cpu`` runs the kernels' plain
versions, which autograd differentiates). Weights are random from seed 0;
the tokens are the reference's synthetic pipeline (``training.data``),
step s drawing batch s; the vlm's patch embeddings and whisper's frames are
drawn from seed s on the device. With ``--ckpt-dir`` the loop checkpoints
every ``--ckpt-every`` steps and resumes from the latest checkpoint there;
``--steps`` counts from step 0, so a run resumed at step N trains steps N
.. ``--steps`` - 1 on their own batches (the reference's launcher feeds
batches 0, 1, ... after any resume).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import build_model, make_batch
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.data import DataConfig, global_batch
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainLoop


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    return ap.parse_args(argv)


def setup(args):
    """The model (random weights from seed 0 on the device), the loop and
    the batches of steps ``start`` .. ``args.steps`` - 1, where ``start``
    is the step of the latest checkpoint in ``args.ckpt_dir`` (else 0)."""
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    model = build_model(cfg, device=dev, seed=0)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    start = ((ckpt_lib.latest_step(args.ckpt_dir) or 0) if args.ckpt_dir
             else 0)

    def batches():
        for s in range(start, args.steps):
            b = global_batch(dc, s)
            if cfg.family in ("vlm", "encdec"):
                gen = torch.Generator(device=dev).manual_seed(s)
                extra = make_batch(cfg, shape, gen)
                for k in ("patch_embeds", "frames"):
                    if k in extra:
                        b[k] = extra[k]
            yield b

    loop = TrainLoop(
        model,
        AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                    total_steps=args.steps),
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
    )
    return model, loop, batches()


def main(argv=None):
    """Train and print the loss every ``--log-every`` steps; returns the
    loop's history."""
    args = parse_args(argv)
    _, loop, batches = setup(args)
    _, hist = loop.run(batches)
    if not hist:
        print(f"nothing to train: the checkpoint is at step {args.steps}")
        return hist
    for h in hist:
        if h["step"] % args.log_every == 0 or h["step"] == hist[-1]["step"]:
            flag = " STRAGGLER" if h["straggler"] else ""
            print(f"step {h['step']:5d} loss {h['loss']:.4f} "
                  f"({h['time_s']*1e3:.0f} ms){flag}", flush=True)
    print(f"final loss {hist[-1]['loss']:.4f} over {len(hist)} steps")
    return hist


if __name__ == "__main__":
    main()
