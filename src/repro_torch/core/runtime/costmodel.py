"""Cost-model dispatch (DESIGN.md §14), port of the static and forced
tables of ``repro.core.runtime.costmodel``.

Every unset knob of :class:`RunConfig` is filled from a
:class:`DecisionTable`. The static table turns the kernel knobs on where
the hand-written kernels run — ``native`` is ``device.type == "cuda"``, in
place of the JAX package's ``platform == "tpu"`` — with the fused pipeline,
device aggregation, the sort bin and the host level 2. The pilot
calibration is not ported yet, so ``cost_model="auto"`` resolves like the
static table (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

#: the config knobs a table decides, in resolution order.
DECIDED_KNOBS = (
    "async_chunks",
    "device_aggregate",
    "use_pallas",
    "compact_kernel",
    "aggregate_kernel",
    "aggregate_bin",
    "canonical_placement",
)

COST_MODEL_MODES = ("auto", "off", "force_device", "force_host")


@dataclasses.dataclass
class DecisionTable:
    """Concrete value of every decided knob."""

    backend: str                     # execution backend ("serial")
    platform: str                    # device type at decision time
    source: str                      # static | forced:<mode>
    async_chunks: bool = True
    device_aggregate: bool = True
    use_pallas: bool = False
    compact_kernel: bool = False
    aggregate_kernel: bool = False
    aggregate_bin: str = "sort"      # "sort" | "radix"
    canonical_placement: str = "host"  # "device" | "host" | "host_async"
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def copy(self) -> "DecisionTable":
        return dataclasses.replace(self, timings=dict(self.timings))


def static_table(backend_name: str, device: torch.device,
                 source: str = "static") -> DecisionTable:
    """The pre-calibration defaults: fused pipeline + device aggregation
    everywhere, the hand-written kernels where they run (CUDA), sort bin."""
    native = device.type == "cuda"
    return DecisionTable(
        backend=backend_name, platform=device.type, source=source,
        async_chunks=True, device_aggregate=True,
        use_pallas=native, compact_kernel=native, aggregate_kernel=native,
        aggregate_bin="sort",
    )


def forced_table(mode: str, backend_name: str,
                 device: torch.device) -> DecisionTable:
    """The ``force_device``/``force_host`` placement extremes (kernel knobs
    stay at their static defaults)."""
    t = static_table(backend_name, device, source=f"forced:{mode}")
    if mode == "force_device":
        t.async_chunks = True
        t.device_aggregate = True
        t.aggregate_bin = "radix"
        t.canonical_placement = "device"
    elif mode == "force_host":
        t.async_chunks = False
        t.device_aggregate = False
        t.aggregate_bin = "sort"
        t.canonical_placement = "host"
    else:
        raise ValueError(f"unknown forced cost_model mode {mode!r}")
    return t


def resolve(config, g, app, backend_name: str):
    """Resolve every unset knob of ``config`` to a concrete choice for the
    device ``g`` lives on. Returns ``(concrete_config, table)``; explicit
    config knobs always win over the table."""
    mode = getattr(config, "cost_model", "auto")
    if mode not in COST_MODEL_MODES:
        raise ValueError(
            f"unknown cost_model {mode!r} (expected one of {COST_MODEL_MODES})"
        )
    if mode == "off":
        table = static_table(backend_name, g.device, source="forced:off")
    elif mode == "auto":
        table = static_table(backend_name, g.device)
    else:
        table = forced_table(mode, backend_name, g.device)
    table = table.copy()
    concrete = {}
    for knob in DECIDED_KNOBS:
        user = getattr(config, knob)
        if user is None:
            concrete[knob] = getattr(table, knob)
        else:
            concrete[knob] = user
            setattr(table, knob, user)
            table.timings[f"override.{knob}"] = 1
    return dataclasses.replace(config, **concrete), table
