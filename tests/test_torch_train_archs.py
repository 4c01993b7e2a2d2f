"""Every registry arch, reduced, trains on the CPU in the port alone: one
step down its own gradient lowers the loss on the same batch (the port's
``tests/test_models_smoke.py::test_reduced_train_step_decreases_loss``:
the same SGD step, ``p - 0.5 / max(|g|, 1) g`` in the weights' type, so
that gradients flow through every family's block structure)."""
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.models import build_model, make_batch
from repro_torch.training.optimizer import global_norm

SMOKE = ShapeConfig("smoke", seq_len=32, global_batch=2, kind="train")


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_reduced_train_step_decreases_loss(name):
    cfg = ARCHS[name].reduced()
    model = build_model(cfg, device="cpu", seed=0)
    batch = make_batch(cfg, SMOKE, torch.Generator().manual_seed(0))
    params = list(model.parameters())
    loss0 = model.loss(batch)
    grads = torch.autograd.grad(loss0, params)
    gnorm = global_norm(dict(enumerate(grads)))
    assert torch.isfinite(gnorm) and gnorm > 0, f"{name}: dead grads"
    with torch.no_grad():
        lr = 0.5 / torch.clamp(gnorm, min=1.0)
        for p, g in zip(params, grads):
            p.copy_((p.float() - lr * g.float()).to(p.dtype))
        loss1 = model.loss(batch)
    assert loss1.item() < loss0.item(), f"{name}: {loss0} -> {loss1}"
