"""Checkpoint a mining run, kill it mid-flight, resume — same output.

    PYTHONPATH=src python -m repro_torch.examples.resume_after_crash \
        [--device cpu]

The walkthrough (DESIGN.md §9 + §13):

  1. mine the reference result uninterrupted;
  2. launch the SAME run in a child process with
     ``RunConfig(checkpoint_dir=...)`` — every sealed superstep is
     persisted atomically — and kill it with the §13 fault-injection
     layer: ``FaultPlan([FaultSpec("materialize", 3, "exit")])`` hard-
     exits (``os._exit``) the instant superstep 3 opens, right after
     superstep 2's checkpoint landed. What is left on disk is exactly
     what a SIGKILL / preemption at that boundary leaves;
  3. ``resume()`` from the surviving checkpoint and compare pattern
     dictionaries: identical;
  4. do it all again WITHOUT the manual resume: ``run_supervised`` with
     an injected crash retries from the last valid checkpoint by itself
     and reports what it did in ``result.recovery``.

The checkpoint payload is worker-count-free (the sealed frontier store
plus the superstep cursor), so step 3 could equally hand the same
checkpoint to a ``ShardMapBackend`` over a mesh of any size.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import repro_torch
from repro_torch.core import RunConfig, graph, resume, run, run_supervised
from repro_torch.core.apps import MotifsApp
from repro_torch.core.runtime import FaultPlan, FaultSpec, latest_checkpoint
from repro_torch.core.runtime import faults as faults_lib
from repro_torch.examples.quickstart import DEVICE_HELP

SCALE = 0.05      # CiteSeer-shaped, seconds per run
CRASH_STEP = 3    # die as superstep 3 opens: step 2's checkpoint survives

CHILD = textwrap.dedent(
    f"""
    import sys
    from repro_torch.core import RunConfig, graph, run
    from repro_torch.core.apps import MotifsApp
    from repro_torch.core.runtime import FaultPlan, FaultSpec

    # deterministic crash injection (DESIGN.md §13): kind "exit" calls
    # os._exit at the materialize boundary of superstep {CRASH_STEP} —
    # no atexit, no unwinding, the run is genuinely torn.
    plan = FaultPlan([FaultSpec("materialize", {CRASH_STEP}, "exit")])
    g = graph.citeseer_like(scale={SCALE})
    run(g, MotifsApp(max_size=3),
        RunConfig(checkpoint_dir=sys.argv[1], faults=plan),
        device=sys.argv[2] if len(sys.argv) > 2 else None)
    raise SystemExit("unreachable: the injected exit never fired")
    """
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    args = ap.parse_args(argv)

    g = graph.citeseer_like(scale=SCALE)
    app = MotifsApp(max_size=3)

    reference = run(g, app, RunConfig(), device=args.device)
    print(f"reference run: {len(reference.patterns)} patterns over "
          f"{len(reference.stats.steps)} supersteps")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        env = dict(os.environ)
        src = str(Path(repro_torch.__file__).resolve().parents[1])
        env["PYTHONPATH"] = os.pathsep.join(
            [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                     if p])
        child_args = [ckpt_dir] + ([args.device] if args.device else [])
        proc = subprocess.run([sys.executable, "-c", CHILD, *child_args],
                              env=env, timeout=600)
        if proc.returncode != faults_lib.EXIT_CODE:
            raise SystemExit(
                f"child should have died mid-run (exit {proc.returncode})")
        survivor = latest_checkpoint(ckpt_dir)
        print(f"child killed mid-run; survivor: {os.path.basename(survivor)}")

        resumed = resume(g, app, survivor, device=args.device)
        print(f"resumed run:   {len(resumed.patterns)} patterns over "
              f"{len(resumed.stats.steps)} supersteps "
              f"(replayed steps "
              f"{[s.step for s in resumed.stats.steps[CRASH_STEP - 1:]]})")
        if resumed.patterns != reference.patterns:
            raise SystemExit("outputs diverged after resume")
        print("OK: resumed output identical to the uninterrupted run")

    # -- the supervised version: no manual resume step -------------------
    plan = FaultPlan([FaultSpec("expand", 2, "crash")])
    supervised = run_supervised(g, app, RunConfig(faults=plan),
                                device=args.device)
    rec = supervised.recovery
    print(f"run_supervised: crashed once, retried {rec['n_retries']}x, "
          f"resumed from step {rec['resumed_step']}, recovery "
          f"{rec['t_recovery'] * 1e3:.1f} ms")
    if supervised.patterns != reference.patterns:
        raise SystemExit("outputs diverged under run_supervised")
    print("OK: supervised recovery identical to the uninterrupted run")
    return {"reference": reference, "resumed": resumed,
            "supervised": supervised}


if __name__ == "__main__":
    main()
