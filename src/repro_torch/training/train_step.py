"""The train step and the training loop, port of
``repro.training.train_step``.

``make_train_step`` builds one step: the model's loss, its gradients by
autograd (on the card through the RMSNorm and flash-attention backward
kernels), and the AdamW update with the reference's NaN guard, all on the
device with no host sync. ``TrainLoop`` adds the reference's production
posture: checkpoint cadence with atomic commit and auto-resume, a per-step
watchdog that flags stragglers (steps beyond mean + 4 sigma), and NaN-step
skipping, with one read of the step's loss (and its skip flag, in the same
copy) a step. The model holds its weights and is trained in place, so
neither takes a ``params`` argument where the reference's functions do.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.lm import reference_ranks
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.optimizer import (
    AdamWConfig, OptState, init_opt_state, step_)


def make_train_step(model, opt_cfg: AdamWConfig):
    """``step_fn(opt_state, batch) -> (opt_state, metrics)``: loss, backward
    and the AdamW update written into ``model``'s parameters; ``metrics``
    holds the () device tensors ``loss``, ``grad_norm``, ``lr`` and
    ``skipped`` (1 where the guard kept the old weights and state)."""
    params = dict(model.named_parameters())
    ranks = reference_ranks(model)

    def step_fn(opt_state: OptState, batch):
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {name: torch.zeros_like(p) if g is None else g
                 for (name, p), g in zip(params.items(), grads)}
        opt_state, metrics = step_(opt_cfg, params, grads, opt_state, loss,
                                   ranks)
        del grads
        return opt_state, dict(metrics, loss=loss.detach())

    return step_fn


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``; host
    arrays cross from pinned memory without blocking the host on the card."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                v = v.pin_memory()
        out[k] = v.to(device, non_blocking=True)
    return out


def checkpoint_tree(params, opt_state: OptState) -> Dict[str, Any]:
    """What a checkpoint holds: the parameters by name and the state."""
    return {"params": params, "opt": opt_state}


@dataclasses.dataclass
class TrainLoop:
    model: Any
    opt_cfg: AdamWConfig
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    straggler_sigma: float = 4.0

    def run(self, batches):
        """``batches``: iterable of batch dicts (numpy arrays or tensors).
        Trains ``model`` in place from the latest checkpoint in
        ``ckpt_dir`` (if any); returns ``(opt_state, history)``."""
        step_fn = make_train_step(self.model, self.opt_cfg)
        params = dict(self.model.named_parameters())
        opt_state = init_opt_state(params)
        start = 0

        if self.ckpt_dir:
            latest = ckpt_lib.latest_step(self.ckpt_dir)
            if latest is not None:
                tree = ckpt_lib.restore(self.ckpt_dir, latest,
                                        checkpoint_tree(params, opt_state))
                with torch.no_grad():
                    for name, p in params.items():
                        p.copy_(tree["params"][name])
                opt_state = tree["opt"]
                del tree
                start = latest

        history = []
        durations = []
        dev = self.model.device
        for i, batch in enumerate(batches):
            step = start + i
            t0 = time.perf_counter()
            opt_state, metrics = step_fn(opt_state, to_device(batch, dev))
            # the step's one read: loss and skip flag in one copy
            loss, skipped = torch.stack(
                [metrics["loss"], metrics["skipped"].float()]).tolist()
            dt = time.perf_counter() - t0
            straggler = False
            if len(durations) >= 5:
                mu, sd = np.mean(durations), np.std(durations) + 1e-9
                straggler = dt > mu + self.straggler_sigma * sd
            durations.append(dt)
            history.append(
                {"step": step, "loss": loss, "time_s": dt,
                 "straggler": bool(straggler), "skipped": int(skipped)})
            if self.ckpt_dir and (step + 1) % self.ckpt_every == 0:
                ckpt_lib.save(self.ckpt_dir, step + 1,
                              checkpoint_tree(params, opt_state))
                ckpt_lib.retain(self.ckpt_dir)
        return opt_state, history
