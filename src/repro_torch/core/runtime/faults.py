"""Deterministic fault injection + the graceful-degradation ladder (§13),
port of ``repro.core.runtime.faults``.

Arabesque's fault-tolerance story (paper §5.5, and Aridhi et al.,
arXiv:1212.0017) is superstep-granular: fail anywhere, restart from the
last sealed cut. To *test* that story deterministically this module gives
the runtime a :class:`FaultPlan` — an explicit list of (phase, superstep,
kind) triples — tripped at every phase boundary of the BSP loop. A plan is
exact and replayable: the same plan against the same run fails at the same
instruction every time, which is what lets the tests assert bit-identical
recovery.

Three layers live here:

* **Injection** — :class:`FaultSpec`/:class:`FaultPlan` and the injected
  exception taxonomy (:class:`InjectedCrash`, :class:`InjectedOOM`,
  :class:`InjectedHaloFailure`). Lethal kinds raise (or ``os._exit`` for
  real-kill subprocess tests); benign kinds (``corrupt``, ``saturate``)
  are consumed by the call site that simulates them via
  :meth:`FaultPlan.take`. A plan is *stateful across retries*: a spec
  fires ``times`` times total, shared through every supervisor attempt.
* **Classification** — :func:`classify_failure` maps a caught exception
  onto the failure taxonomy the supervisor retries over (``oom`` /
  ``halo`` / ``crash``), plus ``fatal`` for what no retry can mend on this
  process: a kernel build error and a CUDA runtime error (the CUDA context
  is poisoned). ``torch.OutOfMemoryError`` is an ``oom``.
* **Degradation** — :func:`apply_degradation`, the ladder consulted when
  the *same* phase fails twice: each rung returns a strictly safer
  ``RunConfig`` (fused pipeline -> chunk loop, device aggregation -> host
  ``aggregate_rows``, kernels -> their plain PyTorch routes,
  ``device_budget_bytes`` halving on OOM, the halo all-to-all -> the
  all-gather of the shard tables). Every rung is bit-identical, so
  a degraded retry reproduces the clean run's patterns exactly. On the
  card the ladder stops before the rungs that hand a kernel's work to its
  plain version or to the host: those run only for CPU tensors.

``corrupt_checkpoint`` tampers a written cut while *keeping the stale
embedded checksum*, producing exactly the artifact ``checkpoint.verify``
must reject and ``load_latest_valid`` must roll back past.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import KernelCompileError

#: process exit code of a ``kind="exit"`` fault — subprocess kill tests
#: assert on it (mirrors examples/resume_after_crash.py).
EXIT_CODE = 17

#: where a plan can trip: the six loop phases (obs.PHASES) + the halo
#: exchange of the shard-map backend's partitioned superstep.
FAULT_PHASES = (
    "materialize", "aggregate", "alpha", "expand", "seal", "checkpoint",
    "halo",
)

#: lethal kinds abort the attempt at the trip site; benign kinds are
#: consumed by the code path that simulates them (``FaultPlan.take``).
LETHAL_KINDS = ("crash", "exit", "oom", "halo")
BENIGN_KINDS = ("corrupt", "saturate")
FAULT_KINDS = LETHAL_KINDS + BENIGN_KINDS


class InjectedFault(RuntimeError):
    """Root of every deterministically injected failure."""


class InjectedCrash(InjectedFault):
    """A generic process crash at a phase boundary (retryable)."""


class InjectedOOM(InjectedFault):
    """A simulated device allocation failure, classified ``oom`` as a real
    ``torch.OutOfMemoryError`` is (its message keeps the reference's
    ``RESOURCE_EXHAUSTED`` marker)."""


class InjectedHaloFailure(InjectedFault):
    """A failed halo exchange (lost worker / collective timeout)."""


@dataclasses.dataclass
class FaultSpec:
    """One planned fault: trip ``kind`` when ``phase`` runs at superstep
    ``step``, up to ``times`` times across ALL supervisor attempts."""

    phase: str
    step: int
    kind: str = "crash"
    times: int = 1

    def __post_init__(self) -> None:
        if self.phase not in FAULT_PHASES:
            raise ValueError(
                f"unknown fault phase {self.phase!r} (one of {FAULT_PHASES})"
            )
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (one of {FAULT_KINDS})"
            )


class FaultPlan:
    """A deterministic schedule of faults, shared across retry attempts.

    The plan is the *only* mutable state of the injection layer: each spec
    carries a remaining-fire budget, decremented when it trips, so a
    once-only crash does not re-fire on the supervised retry. ``fired``
    records every (phase, step, kind) that actually tripped — tests assert
    the schedule executed."""

    def __init__(self, specs: Iterable[FaultSpec | Sequence]) -> None:
        self.specs: List[FaultSpec] = [
            s if isinstance(s, FaultSpec) else FaultSpec(*s) for s in specs
        ]
        self._remaining = [max(int(s.times), 0) for s in self.specs]
        self.fired: List[Tuple[str, int, str]] = []

    def _match(self, phase: str, step: int, kinds) -> Optional[str]:
        for i, s in enumerate(self.specs):
            if (
                self._remaining[i] > 0
                and s.phase == phase
                and s.step == int(step)
                and s.kind in kinds
            ):
                self._remaining[i] -= 1
                self.fired.append((phase, int(step), s.kind))
                return s.kind
        return None

    # -- injection sites -----------------------------------------------------
    def trip(self, phase: str, step: int) -> None:
        """Called at a phase boundary: fire any matching LETHAL spec.
        Benign kinds never raise here — the simulating call site pulls
        them via :meth:`take`."""
        kind = self._match(phase, step, LETHAL_KINDS)
        if kind is None:
            return
        if kind == "exit":
            # a real kill: no unwinding, no atexit — the subprocess kill
            # matrix asserts the parent sees EXIT_CODE
            os._exit(EXIT_CODE)
        if kind == "oom":
            raise InjectedOOM(
                f"RESOURCE_EXHAUSTED: injected device OOM at "
                f"{phase}/step {step}"
            )
        if kind == "halo":
            raise InjectedHaloFailure(
                f"injected halo-exchange failure at step {step}"
            )
        raise InjectedCrash(f"injected crash at {phase}/step {step}")

    def take(self, phase: str, step: int, kind: str) -> bool:
        """Consume a matching BENIGN spec (``corrupt``/``saturate``);
        returns whether one fired. The caller simulates the effect."""
        if kind not in BENIGN_KINDS:
            raise ValueError(f"take() is for benign kinds, not {kind!r}")
        return self._match(phase, step, (kind,)) is not None

    @property
    def exhausted(self) -> bool:
        return not any(self._remaining)


def trip(plan: Optional[FaultPlan], phase: str, step: int) -> None:
    """The one-liner the loop calls at each phase boundary: no-op on the
    (default) ``faults=None`` path — a single attribute read."""
    if plan is not None:
        plan.trip(phase, step)


def take(plan: Optional[FaultPlan], phase: str, step: int, kind: str) -> bool:
    if plan is None:
        return False
    return plan.take(phase, step, kind)


# ---------------------------------------------------------------------------
# checkpoint tampering: the adversarial half of the integrity format
# ---------------------------------------------------------------------------

def corrupt_checkpoint(path: str, mode: str = "payload") -> str:
    """Tamper a written checkpoint in place.

    ``mode="payload"`` flips one element of a payload array and re-saves
    the archive **with the old embedded checksum** — a structurally valid
    .npz whose SHA-256 no longer matches, exactly the artifact
    ``checkpoint.verify`` must reject. ``mode="truncate"`` chops the file
    in half (a torn write that never reached ``os.replace``) — unreadable
    as a zip, also classified corrupt. Returns ``path``."""
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(os.path.getsize(path) // 2, 1))
        return path
    if mode != "payload":
        raise ValueError(f"unknown corruption mode {mode!r}")
    with np.load(path, allow_pickle=False) as z:
        arrays = {key: np.asarray(z[key]) for key in z.files}
    for name in sorted(arrays):
        if name in ("meta", "checksum"):
            continue
        a = arrays[name]
        if a.size and np.issubdtype(a.dtype, np.number):
            a = np.array(a, copy=True)
            flat = a.reshape(-1)
            if np.issubdtype(a.dtype, np.integer):
                flat[0] = int(flat[0]) ^ 1
            else:
                flat[0] = float(flat[0]) + 1.0
            arrays[name] = a
            break
    else:  # no numeric payload to flip (empty run): tear the file instead
        return corrupt_checkpoint(path, mode="truncate")
    np.savez(path, **arrays)
    return path


# ---------------------------------------------------------------------------
# failure classification: what the supervisor retries over
# ---------------------------------------------------------------------------

#: failure classes the supervisor re-raises at once, without a retry
FATAL = "fatal"

#: ``torch.AcceleratorError`` (a CUDA runtime error) where this torch has it
_ACCELERATOR_ERROR = getattr(torch, "AcceleratorError", None)


def is_fatal(exc: BaseException) -> bool:
    """A kernel build error, or a CUDA runtime error: the first cannot
    mend on a retry, and after the second the process's CUDA context is
    poisoned. ``torch.OutOfMemoryError`` is neither."""
    if isinstance(exc, KernelCompileError):
        return True
    if isinstance(exc, torch.OutOfMemoryError):
        return False
    if _ACCELERATOR_ERROR is not None and isinstance(exc, _ACCELERATOR_ERROR):
        return True
    msg = str(exc)
    return isinstance(exc, RuntimeError) and (
        "CUDA error" in msg or "cudaError" in msg
    )


def classify_failure(exc: BaseException) -> str:
    """Map a caught exception onto the retry taxonomy: ``"oom"`` (device
    allocation — ``torch.OutOfMemoryError``, a message naming one, or
    injected), ``"halo"`` (exchange/collective failure), ``"fatal"``
    (:func:`is_fatal`), else ``"crash"``. Fingerprint mismatches are the
    supervisor's business — it only calls this for failures raised
    *inside* a mining attempt."""
    if isinstance(exc, InjectedOOM) or isinstance(exc, torch.OutOfMemoryError):
        return "oom"
    if isinstance(exc, InjectedHaloFailure):
        return "halo"
    if is_fatal(exc):
        return FATAL
    msg = str(exc)
    if "RESOURCE_EXHAUSTED" in msg or "out of memory" in msg.lower():
        return "oom"
    return "crash"


# ---------------------------------------------------------------------------
# the graceful-degradation ladder (DESIGN.md §13)
# ---------------------------------------------------------------------------

#: floor of ``device_budget_bytes`` halving — below this a wave holds a
#: handful of rows and further halving cannot help.
_BUDGET_FLOOR = 1 << 16
#: seed budget when OOM strikes a run that never set one (2x halvable).
_BUDGET_SEED = 1 << 26


#: the rungs that move a kernel's work to its plain version or the host:
#: taken only when the run's tensors are on the CPU
CPU_ONLY_RUNGS = ("host_aggregate", "aggregate_kernel_off", "pallas_off")


def apply_degradation(config, phase: str, kind: str, on_card: bool = False):
    """One rung down the ladder for a repeated (phase, kind) failure.

    Returns ``(new_config, event)`` where ``event`` names the downshift
    (recorded in the recovery report and the trace's recovery span), or
    ``(config, None)`` when no safer configuration remains. Every rung is
    behaviour-preserving: the slow path it falls back to is the reference
    the fast path was verified against. A ``fatal`` failure never reaches
    the ladder (the supervisor re-raises it). ``on_card`` (the run's
    tensors are on a CUDA device) ends the ladder before
    :data:`CPU_ONLY_RUNGS`, so a failure there re-raises once the retry
    budget is spent."""
    if kind == "oom":
        # rung 1: halve the spill-wave budget — the direct remedy for a
        # frontier wave outgrowing device memory
        budget = config.device_budget_bytes
        if budget is None:
            new = _BUDGET_SEED
            return (
                dataclasses.replace(config, device_budget_bytes=new),
                f"budget_capped:{new}",
            )
        if budget > _BUDGET_FLOOR:
            new = max(budget // 2, _BUDGET_FLOOR)
            return (
                dataclasses.replace(config, device_budget_bytes=new),
                f"budget_halved:{new}",
            )
        # rung 2: drop the fused pipeline (smaller per-chunk footprint).
        # ``is not False`` because the knob is tri-state (None = cost-model
        # auto, effectively on): an unresolved config still downshifts.
        if config.async_chunks is not False:
            return (
                dataclasses.replace(config, async_chunks=False),
                "fused_off",
            )
        return config, None

    if kind == "halo" or phase == "halo":
        # a failed halo exchange: the all-to-all -> the all-gather of the
        # shard tables, the equivalence oracle the exchange was held to
        if config.resolve_halo() != "gather":
            return dataclasses.replace(config, halo="gather"), "halo_gather"
        return config, None

    if phase in ("aggregate", "alpha"):
        # rung 0: device / overlapped level-2 canonicalisation -> the
        # synchronous memoised host batch (DESIGN.md §15). No-op for an
        # unresolved knob (None resolves to "host" pre-calibration), so
        # existing ladder sequences are unchanged unless the placement was
        # actually lifted off the host.
        if config.resolve_canonical_placement() != "host":
            return (
                dataclasses.replace(config, canonical_placement="host"),
                "canon_host",
            )
        # rung 1: radix bucket bin -> the sort bin
        if config.resolve_aggregate_bin() == "radix":
            return (
                dataclasses.replace(config, aggregate_bin="sort"),
                "radix_bin_off",
            )
        if on_card:
            return config, None
        # rung 2: device level-1 aggregation -> host aggregate_rows
        # reference (tri-state knob: None = cost-model auto = maybe on)
        if config.device_aggregate is not False:
            return (
                dataclasses.replace(config, device_aggregate=False),
                "host_aggregate",
            )
        if config.resolve_aggregate_kernel(on_card):
            return (
                dataclasses.replace(config, aggregate_kernel=False),
                "aggregate_kernel_off",
            )
        return config, None

    if phase in ("materialize", "expand", "seal"):
        # rung 1: fused pipeline -> legacy chunk loop (tri-state knob)
        if config.async_chunks is not False:
            return (
                dataclasses.replace(config, async_chunks=False),
                "fused_off",
            )
        if on_card:
            return config, None
        # rung 2: the hand-written kernels -> their plain PyTorch routes
        if (
            config.resolve_use_pallas(on_card)
            or config.resolve_compact_kernel(on_card)
            or config.fused_expand
        ):
            return (
                dataclasses.replace(
                    config,
                    use_pallas=False,
                    fused_expand=False,
                    compact_kernel=False,
                ),
                "pallas_off",
            )
        return config, None

    # checkpoint-phase failures have no safer configuration — retry from
    # the previous cut IS the remedy
    return config, None
