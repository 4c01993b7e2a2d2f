"""What ``repro_torch.core.run`` refuses: a run without a card unless
``device="cpu"`` is asked, the knobs the port does not take, and an
unknown store kind. The runs themselves are held to the JAX package's in
``test_torch_engine.py``.
"""
import pytest
import torch

from repro_torch.core import FaultPlan, RunConfig, graph as TG, run
from repro_torch.core.apps import MotifsApp


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(TG.triangle_plus_tail(), MotifsApp(max_size=3))
    res = run(TG.triangle_plus_tail(), MotifsApp(max_size=3), device="cpu")
    assert sum(res.patterns.values()) > 0


@pytest.mark.parametrize("knob", [
    dict(checkpoint_dir="ckpt"), dict(log_every=1),
    dict(trace=True), dict(faults=()),
])
def test_unported_paths_raise(knob, tmp_path):
    """The knobs whose paths were not ported raised ``NotImplementedError``;
    checkpoints, the progress log, tracing and fault plans are ported now,
    so each runs and gives the default run's patterns."""
    if "checkpoint_dir" in knob:
        knob = dict(checkpoint_dir=str(tmp_path / knob["checkpoint_dir"]))
    if "faults" in knob:
        knob = dict(faults=FaultPlan(knob["faults"]))
    g = TG.triangle_plus_tail()
    res = run(g, MotifsApp(max_size=3), RunConfig(**knob), device="cpu")
    ref = run(g, MotifsApp(max_size=3), device="cpu")
    assert res.patterns == ref.patterns


def test_unknown_store_kind_raises():
    """``make_store`` takes "raw" and "odag", as the reference's does: a
    spill store comes from ``device_budget_bytes``, not from ``store``."""
    with pytest.raises(ValueError, match="spill"):
        run(TG.triangle_plus_tail(), MotifsApp(max_size=3),
            RunConfig(store="spill"), device="cpu")
