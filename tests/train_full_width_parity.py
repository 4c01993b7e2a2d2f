"""The training loop at an arch's published widths in the JAX package and
in the port, on the CPU: the same bf16 weights (the reference's
initialisation, key 0, carried across by ``model_from_numpy``), the same
synthetic batches (``training.data.global_batch``, 8 x 128 by default, the
``train_lm`` example's), the same AdamW settings (lr 1e-3, one warm-up
step per 20, as ``launch.train`` sets them). Prints each package's loss at
every step.

Run from the repository root (smollm-135m, 12 steps: about two minutes):

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/train_full_width_parity.py
"""
import argparse
import dataclasses
import time

import jax
import numpy as np
import torch

import torch_parity  # noqa: F401  (one torch thread per process)
from repro.configs.registry import ARCHS as JARCHS
from repro.models import build_model as jbuild
from repro.training.data import DataConfig, global_batch
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.train_step import TrainLoop as JTrainLoop
from repro_torch.configs.registry import ARCHS
from repro_torch.models import model_from_numpy
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainLoop


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)

    cfg = dataclasses.replace(JARCHS[args.arch], remat=False)
    jm = jbuild(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch)
    batches = [global_batch(dc, s) for s in range(args.steps)]
    opt = dict(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
               total_steps=args.steps)

    t0 = time.perf_counter()
    _, _, jhist = JTrainLoop(jm, JAdamWConfig(**opt)).run(params, batches)
    jax_s = time.perf_counter() - t0
    model = model_from_numpy(ARCHS[args.arch],
                             jax.tree.map(np.asarray, params), device="cpu")
    t0 = time.perf_counter()
    _, thist = TrainLoop(model, AdamWConfig(**opt)).run(batches)
    port_s = time.perf_counter() - t0
    print(f"{args.arch}, {args.batch} x {args.seq}, lr {args.lr}:")
    print("step  JAX package  port")
    for j, t in zip(jhist, thist):
        print(f"{j['step']:4d}  {j['loss']:11.4f}  {t['loss']:.4f}")
    print(f"(JAX {jax_s:.0f} s with its compile, port {port_s:.0f} s)")


if __name__ == "__main__":
    main()
