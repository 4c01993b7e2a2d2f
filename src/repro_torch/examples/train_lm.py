"""Train a ~130M-param LM (smollm-135m exact config) for a few hundred
steps on synthetic data with checkpointing — the model zoo's end-to-end
driver. The reduced config by default; ``--full`` for the published one
(on the card).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 \
        [--full] [--ckpt-dir DIR] [--device cpu]

Unlike the reference's example, it calls the launcher in-process, and the
checkpoints go to a fresh temporary directory unless ``--ckpt-dir`` names
one (the reference writes to /tmp/repro_ckpt).
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.launch import train

DEVICE_HELP = "torch device (default: the CUDA card; 'cpu' for the CPU)"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="repro_ckpt_") as tmp:
        cmd = ["--arch", "smollm-135m", "--steps", str(args.steps),
               "--batch", "8", "--seq", "128",
               "--ckpt-dir", args.ckpt_dir or tmp]
        if args.full:
            cmd.append("--full")
        if args.device:
            cmd += ["--device", args.device]
        return train.main(cmd)


if __name__ == "__main__":
    main()
