#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

  1. the card: name, device count, ``nvidia-smi`` name and power limit;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes the main path gives it on ``mico_like(0.1)`` (integers and
     booleans: exact equality), and time kernel, plain version and, where
     one exists, the one PyTorch call that computes the same function;
  4. the card port against the CPU port on ``mico_like(0.005)``: motifs and
     cliques, identical patterns, per-size embedding counts and per-step
     counters;
  5. the main path through ``repro_torch.core.run`` on ``mico_like(0.1)``
     (MiCo/10) with the default static config: motifs unfused and fused,
     then cliques; the launch counts are zeroed just before each run and
     read just after, and every kernel must have launched.

It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. ``--json PATH`` also writes the details
(per-step times, peak bytes, launches per run) to PATH. It needs the
repository's ``src`` beside it and a CUDA device; it imports neither JAX
nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: published H100 SXM device-memory rate (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
CHUNK = 4096                   # RunConfig.chunk_size default
AGG_QCAP = 4096                # RunConfig.agg_qcap default


class SmokeFailure(Exception):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60,
    )
    need(out.returncode == 0 and out.stdout.strip(),
         f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` launches, each timed
    with CUDA events after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(torch, got, want) -> int:
    """Largest absolute difference over a tuple of integer/bool outputs."""
    err = 0
    for g, w in zip(got, want):
        need(g.shape == w.shape and g.dtype == w.dtype,
             f"shape/dtype {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} "
             f"{w.dtype}")
        if g.numel():
            d = (g.to(torch.int64) - w.to(torch.int64)).abs().max()
            err = max(err, int(d))
    return err


def kernel_checks(torch, np, dg, g):
    """Phase 3: every kernel against its plain version at main-path shapes
    (the first size-2 chunk of mico_like(0.1) and what it produces)."""
    from repro_torch.core import explore, pattern
    from repro_torch.core.runtime.config import next_pow2
    from repro_torch.kernels import aggregate, build, compact
    from repro_torch.kernels.canonical_check.canonical_check import (
        canonical_check_cuda, canonical_check_ref, expand_canonical_cuda,
        expand_canonical_ref,
    )

    dev = dg.device
    reps = 15
    members = torch.from_numpy(g.edges[:CHUNK].astype(np.int32)).to(dev)
    n_valid = torch.full((CHUNK,), 2, dtype=torch.int32, device=dev)
    c, k, d = members.shape[0], members.shape[1], dg.max_degree
    w = dg.adj_bits.shape[1]
    n_member_rows = int(torch.unique(members).numel())
    rows = []

    def record(name, src, replaces, err, ms, plain_ms, nbytes, library_ms):
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": library_ms,
            "bytes": nbytes,
        })
        log(f"  {name}: max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f}"
            f" bound_ms={bound_ms:.4f} library_ms={library_ms}")

    # -- expand_canonical: members (4096, 2), D = max degree ----------------
    got = expand_canonical_cuda(members, n_valid, dg.nbr, dg.adj_bits)
    want = expand_canonical_ref(members, n_valid, dg.nbr, dg.adj_bits)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    need(err == 0, f"expand_canonical differs from its plain version ({err})")
    ms = time_ms(torch, lambda: expand_canonical_cuda(
        members, n_valid, dg.nbr, dg.adj_bits), reps)
    plain = time_ms(torch, lambda: expand_canonical_ref(
        members, n_valid, dg.nbr, dg.adj_bits), 3, 1)
    nbytes = (c * k * 4 + c * 4 + n_member_rows * (d + w) * 4
              + c * k * d * (4 + 1 + 1))
    record("expand_canonical",
           "src/repro_torch/kernels/csrc/expand_canonical.cu",
           "src/repro/kernels/canonical_check/canonical_check.py:252",
           err, ms, plain, nbytes, None)
    cand, valid, keep3 = got
    del want

    # -- canonical_check: the unfused route's flat batch --------------------
    flat_rows = torch.arange(c, dtype=torch.int32, device=dev).repeat_interleave(k * d)
    fm, fn_, fc = members[flat_rows], n_valid[flat_rows], cand.reshape(-1)
    b = fc.shape[0]
    got = (canonical_check_cuda(fm, fn_, fc, dg.adj_bits),)
    want = (canonical_check_ref(fm, fn_, fc, dg.adj_bits),)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    need(err == 0, f"canonical_check differs from its plain version ({err})")
    ms = time_ms(torch, lambda: canonical_check_cuda(
        fm, fn_, fc, dg.adj_bits), reps)
    plain = time_ms(torch, lambda: canonical_check_ref(
        fm, fn_, fc, dg.adj_bits), 3, 1)
    nbytes = b * k * 4 + b * 4 + b * 4 + n_member_rows * w * 4 + b
    record("canonical_check",
           "src/repro_torch/kernels/csrc/canonical_check.cu",
           "src/repro/kernels/canonical_check/canonical_check.py:87",
           err, ms, plain, nbytes, None)
    log(f"  canonical_check batch: members {tuple(fm.shape)}, "
        f"{b} candidates")
    del fm, fn_, fc, got, want

    # -- stream_compact: the chunk's keep mask -----------------------------
    keep = keep3.reshape(-1)
    kept = int(keep.sum())
    out_cap = next_pow2(kept)
    errs = []
    for cap in (out_cap, CHUNK):        # main-path capacity, and overflow
        got = compact.stream_compact_cuda(keep, cap)
        want = compact.stream_compact_ref(keep, cap)
        torch.cuda.synchronize()
        errs.append(max_abs_err(torch, got, want))
        need(int(got[1]) == kept, "stream_compact count is not the "
             "unclamped kept total")
    err = max(errs)
    need(err == 0, f"stream_compact differs from its plain version ({err})")
    ms = time_ms(torch, lambda: compact.stream_compact_cuda(keep, out_cap), reps)
    plain = time_ms(torch, lambda: compact.stream_compact_ref(keep, out_cap), 5)
    lib_ms = time_ms(torch, lambda: torch.nonzero(keep), 5)
    nbytes = keep.numel() + out_cap * 4 + 4
    record("stream_compact", "src/repro_torch/kernels/csrc/stream_compact.cu",
           "src/repro/kernels/compact.py:91", err, ms, plain, nbytes, lib_ms)
    log(f"  stream_compact: B={keep.numel()} kept={kept} out_cap={out_cap}")

    # -- seg_unique: the chunk's children codes, sorted ---------------------
    children, count = explore.compact(
        members, explore.Expansion(flat_rows, cand.reshape(-1), keep,
                                   None, None),
        keep, out_cap, use_kernel=True,
    )
    child_nv = torch.where(torch.arange(out_cap, device=dev) < count, k + 1,
                           0).to(torch.int32)
    qp = pattern.quick_pattern_vertex(dg, children, child_nv)
    sc, sv, _ = aggregate.sort_codes(qp.codes, child_nv > 0)
    new = sv & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          (sc[1:] != sc[:-1]).any(1)])
    acap = min(out_cap, AGG_QCAP)
    errs = []
    for cap in (acap, out_cap):         # main-path capacity, and no overflow
        got = aggregate.seg_unique_cuda(new, sv, cap)
        want = aggregate.seg_unique_ref(new, sv, cap)
        torch.cuda.synchronize()
        errs.append(max_abs_err(torch, got, want))
    err = max(errs)
    need(err == 0, f"seg_unique differs from its plain version ({err})")
    n_distinct = int(got[3])
    ms = time_ms(torch, lambda: aggregate.seg_unique_cuda(new, sv, acap), reps)
    plain = time_ms(torch, lambda: aggregate.seg_unique_ref(new, sv, acap), 5)
    valid_rows = sc[:kept]
    lib_ms = time_ms(torch, lambda: torch.unique_consecutive(
        valid_rows, dim=0, return_inverse=True, return_counts=True), 5)
    bsz = new.numel()
    nbytes = 2 * bsz + 4 * bsz + 2 * acap * 4 + 4
    record("seg_unique", "src/repro_torch/kernels/csrc/seg_unique.cu",
           "src/repro/kernels/aggregate.py:110", err, ms, plain, nbytes, lib_ms)
    log(f"  seg_unique: B={bsz} cap={acap} distinct={n_distinct}")
    build.reset_launches()
    return rows


def chunk_program_is_sync_free(torch, dg, members, n_valid):
    """One chunk program per route under sync debug mode "error": any
    hidden host sync in expansion, filter, compaction or the partial bin
    raises."""
    from repro_torch.core import explore
    from repro_torch.core.apps import CliquesApp, MotifsApp

    for app, fused in ((MotifsApp(max_size=3), False),
                       (MotifsApp(max_size=3), True),
                       (CliquesApp(max_size=4), False)):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            explore.fused_chunk_step(
                dg, members, n_valid, 1 << 22, mode="vertex", app=app,
                with_aggregates=app.wants_patterns, agg_qcap=AGG_QCAP,
                with_local_verts=False, use_pallas=True, fused=fused,
                compact_kernel=True, aggregate_kernel=True,
            )
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


INT_FIELDS = ("step", "size", "n_frontier", "n_generated", "n_canonical",
              "n_children", "n_quick_patterns", "n_canonical_patterns",
              "n_iso_checks", "n_chunks", "n_host_syncs", "frontier_bytes",
              "bytes_to_host")


def step_counters(res):
    return [{f: getattr(s, f) for f in INT_FIELDS} for s in res.stats.steps]


def card_vs_cpu(torch, run, G, apps):
    """Phase 4: identical results from the card and the CPU port."""
    g = G.mico_like(0.005)
    out = {}
    for name, app in apps:
        cpu = run(g, app, device="cpu")
        gpu = run(g, app)
        need(cpu.patterns == gpu.patterns, f"{name}: patterns differ")
        need({k: len(v) for k, v in cpu.embeddings.items()}
             == {k: len(v) for k, v in gpu.embeddings.items()},
             f"{name}: embedding counts differ")
        need(step_counters(cpu) == step_counters(gpu),
             f"{name}: step counters differ:\n{step_counters(cpu)}\n"
             f"{step_counters(gpu)}")
        out[name] = {"patterns": len(gpu.patterns),
                     "steps": step_counters(gpu)}
        log(f"  {name}: {len(gpu.patterns)} patterns, "
            f"{[s.n_children for s in gpu.stats.steps]} children per step, "
            "identical")
    return out


def main_path(torch, np, run, RunConfig, G, build, apps):
    """Phase 5: the main path on mico_like(0.1), kernels counted."""
    from repro_torch.core.runtime.serial import _DRAIN_WINDOW

    g = G.mico_like(0.1)
    deg = g.degrees().astype(np.int64)
    wedges = int((deg * (deg - 1) // 2).sum())
    totals = {name: 0 for name in build.LAUNCHES}
    runs, results = [], {}
    for label, app, cfg in apps:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        res = run(g, app, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        for name, v in launches.items():
            totals[name] += v
        peak = torch.cuda.max_memory_allocated()
        for s in res.stats.steps:
            # the pilot, then one stacked drain per window of chunks
            bound = 1 + math.ceil(s.n_chunks / _DRAIN_WINDOW)
            need(s.n_host_syncs <= (bound if s.n_chunks else 0),
                 f"{label} step {s.step}: {s.n_host_syncs} host syncs for "
                 f"{s.n_chunks} chunks")
        steps = [{
            "step": s.step, "frontier": s.n_frontier, "children": s.n_children,
            "n_chunks": s.n_chunks, "n_host_syncs": s.n_host_syncs,
            "quick_patterns": s.n_quick_patterns,
            "canonical_patterns": s.n_canonical_patterns,
            "t_expand": s.t_expand, "t_aggregate": s.t_aggregate,
            "t_canon": s.t_canon, "t_storage": s.t_storage,
        } for s in res.stats.steps]
        rec = {"run": label, "wall_s": wall, "peak_bytes": peak,
               "launches": launches, "steps": steps,
               "patterns": len(res.patterns),
               "chunk_signatures": len(res.stats.chunk_signatures)}
        runs.append(rec)
        results[label] = res
        log(f"  {label}: wall {wall:.3f} s, peak {peak / 2**30:.2f} GiB, "
            f"launches {launches}")
        for s in steps:
            log(f"    step {s['step']}: frontier {s['frontier']} children "
                f"{s['children']} chunks {s['n_chunks']} syncs "
                f"{s['n_host_syncs']} quick {s['quick_patterns']} canonical "
                f"{s['canonical_patterns']}")

    mot, fused, cli = (results["motifs_unfused"], results["motifs_fused"],
                       results["cliques"])
    need(mot.patterns == fused.patterns, "fused and unfused motifs differ")
    for s in mot.stats.steps:
        need(s.n_host_syncs <= 2, f"motifs step {s.step}: "
             f"{s.n_host_syncs} host syncs")
    # the repo's own cross-checks: size-2 motifs are the edges, size-3
    # motifs are the wedges less twice the triangles, and the triangles are
    # the size-3 cliques
    by_size = {}
    tri = 0
    for code, cnt in mot.patterns.items():
        nv = code[0] & 0xF
        by_size[nv] = by_size.get(nv, 0) + cnt
        if nv == 3 and (code[0] >> 4) == 0b111:
            tri += cnt
    n_tri = len(cli.embeddings.get(3, []))
    need(by_size.get(2) == g.m, f"size-2 motifs {by_size.get(2)} != {g.m}")
    need(tri == n_tri, f"triangle motifs {tri} != size-3 cliques {n_tri}")
    need(by_size.get(3) == wedges - 2 * n_tri,
         f"size-3 motifs {by_size.get(3)} != wedges - 2 triangles")
    for size, emb in cli.embeddings.items():
        need(emb.shape[1] == size and (emb >= 0).all() and (emb < g.n).all(),
             f"clique embeddings of size {size} malformed")
    log(f"  checks: {g.m} edges, {n_tri} triangles, {by_size.get(3)} size-3 "
        f"motifs = wedges - 2 triangles; cliques per size "
        f"{ {k: len(v) for k, v in cli.embeddings.items()} }")
    return totals, runs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", type=Path, default=None,
                        help="also write the run's details to this file")
    args = parser.parse_args(argv)
    if not (SRC / "repro_torch").is_dir():
        raise SmokeFailure(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    need(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    t_all = time.perf_counter()

    # ---- 1. the card ----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"[1] card: {kind} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    from repro_torch.core import RunConfig, graph as G, run
    from repro_torch.core.apps import CliquesApp, MotifsApp
    from repro_torch.kernels import build

    # ---- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    log(f"[2] kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.last_build_seconds:.2f} s)")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"    {line.strip()}")

    # ---- 3. kernels against their plain versions ---------------------------
    log("[3] kernels vs plain versions at main-path shapes (mico_like(0.1))")
    g = G.mico_like(0.1)
    dg = G.to_device(g)
    kernels = kernel_checks(torch, np, dg, g)
    members = torch.from_numpy(g.edges[:CHUNK].astype(np.int32)).to(dg.device)
    n_valid = torch.full((CHUNK,), 2, dtype=torch.int32, device=dg.device)
    chunk_program_is_sync_free(torch, dg, members, n_valid)
    log("  chunk programs ran under sync debug mode 'error': no host sync")
    del dg, members, n_valid
    torch.cuda.empty_cache()

    # ---- 4. card port vs CPU port ----------------------------------------
    log("[4] card port vs CPU port on mico_like(0.005)")
    small = card_vs_cpu(torch, run, G, [
        ("motifs", MotifsApp(max_size=3)), ("cliques", CliquesApp(max_size=4)),
    ])

    # ---- 5. the main path --------------------------------------------------
    log("[5] main path on mico_like(0.1) through repro_torch.core.run")
    totals, runs = main_path(torch, np, run, RunConfig, G, build, [
        ("motifs_unfused", MotifsApp(max_size=3), RunConfig()),
        ("motifs_fused", MotifsApp(max_size=3), RunConfig(fused_expand=True)),
        ("cliques", CliquesApp(max_size=4), RunConfig()),
    ])
    for row in kernels:
        row["launches"] = totals[row["name"]]
        need(row["launches"] > 0,
             f"{row['name']} never launched on the main path")

    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({
            "card": kind, "nvidia_smi": smi, "kernels": kernels,
            "card_vs_cpu": small, "main_path": runs,
            "build_seconds": build.last_build_seconds,
            "total_seconds": time.perf_counter() - t_all,
        }, indent=1))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
