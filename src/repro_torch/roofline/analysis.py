"""Roofline terms of a dry-run step, port of ``repro.roofline.analysis``.

    compute term    = FLOPs / peak_FLOP/s
    memory term     = HBM bytes / HBM_bw
    collective term = collective bytes / collective_bw

each from one device's program, the reference's formulas. The reference
reads its inputs from XLA (``compiled.cost_analysis()`` and the collective
ops of the HLO text); the port has no compiled program, so
:func:`from_counts` takes them from :class:`~repro_torch.roofline.counter.
StepCounter`, which runs the step on fake tensors and counts each device's
own operations. Its collective bytes carry the reference's five kinds
under the reference's keys (:data:`COLLECTIVES`), so the two results files
read alike. There is no HLO text to parse: the reference's
``collective_bytes`` and ``_shape_bytes`` have no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.roofline import hw as _hw

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass
class Roofline:
    """All byte and FLOP inputs are PER DEVICE (the counter counts one
    device's shards). ``hw``: the constants (a module or any object with
    ``PEAK_FLOPS_BF16``, ``HBM_BW`` and ``ICI_BW``), by default the H100's
    (:mod:`repro_torch.roofline.hw`)."""

    flops: float                   # per-device FLOPs
    hbm_bytes: float               # per-device bytes read and written
    coll_bytes: float              # per-device collective payload bytes
    chips: int
    model_flops: float = 0.0       # GLOBAL 6*N_active*D (train) / 2*N_active*D
    per_device_hbm: Optional[float] = None  # argument + peak step bytes
    hw: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def _hw(self):
        return _hw if self.hw is None else self.hw

    @property
    def t_compute(self) -> float:
        return self.flops / self._hw.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self._hw.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self._hw.ICI_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """The least time the step can take: the largest term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS share per device / counted per-device FLOPs."""
        return (self.model_flops / self.chips) / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / achievable step time (bound = max term)."""
        bound = self.bound_s
        if bound <= 0:
            return 0.0
        return (self.model_flops / self.chips
                / self._hw.PEAK_FLOPS_BF16) / bound

    def to_dict(self):
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "per_device_hbm": self.per_device_hbm,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def from_counts(counts, chips: int, model_flops: float = 0.0) -> Roofline:
    """The reference's ``from_compiled`` for a counted step: ``counts`` a
    :class:`~repro_torch.roofline.counter.StepCounter` that has run it."""
    return Roofline(
        flops=float(counts.flops),
        hbm_bytes=float(counts.hbm_bytes),
        coll_bytes=float(sum(counts.collectives.values())),
        chips=chips,
        model_flops=model_flops,
        per_device_hbm=float(counts.argument_bytes + counts.peak_bytes),
    )


def _named(params) -> Dict[str, Any]:
    return (dict(params.named_parameters())
            if hasattr(params, "named_parameters") else dict(params))


def count_params(params, exclude_substrings=("embed",)) -> dict:
    """Parameter counts: total, embedding, expert. ``params``: a model
    (meta skeletons serve) or a name -> tensor mapping; a name matches
    where the reference's path does, since the two differ only in their
    separators and the port's stack indices."""
    total = emb = expert = 0
    for name, leaf in _named(params).items():
        n = int(np.prod(tuple(leaf.shape)))
        total += n
        if any(s in name.lower() for s in exclude_substrings):
            emb += n
        if "experts" in name.lower():
            expert += n
    return {"total": total, "embedding": emb, "experts": expert}


def model_flops_for(cfg, shape, params) -> float:
    """MODEL_FLOPS = 6*N_active*D (train) or 2*N_active*D (serve),
    N_active excluding embeddings and inactive experts."""
    counts = count_params(params)
    n = counts["total"] - counts["embedding"]
    if cfg.n_experts:
        active_frac = (cfg.top_k + cfg.n_shared_experts) / max(
            cfg.n_experts + cfg.n_shared_experts, 1
        )
        n = n - counts["experts"] + counts["experts"] * active_frac
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
