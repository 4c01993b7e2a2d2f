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
     the expansion in the variant the chunk takes (named in the log) and
     at a wide synthetic shape (2^17 vertices, k = 8) that takes the
     global-read variant;
     the canonical refine also on seeded codes of every nv from 2 to 8,
     with and without orbits; the halo gather and the tile check on the
     partitioned layout (``to_partitioned(mico_like(0.1), 4)``, the halo
     of the first size-2 chunk); the stream compaction also at B of 0, 1,
     one tile, one tile + 1 and 4 x 132 tiles, masks all false, all true
     and random, out_cap 0, below and above the count, flags at byte
     offset 3, each case twice, and timed at ``halo_unique``'s shape;
     the radix sort of the chunk's child codes whole and kernel by kernel
     (the histogram, then every launch of the scatter kernel from the
     state the launches before it left), with the library sorts;
     then one chunk program per route, whole graph and partitioned, under
     sync debug mode "error";
  4. the card port against the CPU port on ``mico_like(0.005)``: motifs and
     cliques with the default config, motifs under
     ``cost_model="force_device"`` and under
     ``canonical_placement="host_async"``, and size-4 motifs under
     ``force_device`` on ``mico_like(0.001)``, and motifs and cliques
     under ``graph_partition=4``: identical patterns, per-size embedding
     counts and per-step counters;
  5. the main path through ``repro_torch.core.run`` on ``mico_like(0.1)``
     (MiCo/10): motifs unfused and fused and cliques with the default
     static config, then motifs under ``cost_model="force_device"`` (the
     radix bin and level 2 on the device), then motifs and cliques over
     the partitioned layout (``graph_partition=4``), which must equal the
     whole-graph runs; the launch counts are zeroed
     just before each run and read just after, and every kernel must have
     launched. The refine row is then timed on the distinct table that
     level 2 of the last run's step 3 refined, and the radix sort and
     ``seg_unique``, as in phase 3, on the canonical codes that level 2
     re-bins (33,554,432 rows);
  6. the model zoo's dense decoder (``repro_torch.models``):
     a. RMSNorm and flash attention against their plain versions at
        qwen2.5-14b's shapes (the forward's 8,192 x 5,120 rows and a decode
        step's 4; attention at B=4, S=2,048, 40 heads over 8 KV heads of
        128, at smollm-135m's 9 over 3 of 64, and at a ragged S=200), bf16
        and f32, timed beside their plain versions and the library calls
        ``torch.nn.functional.rms_norm`` and ``scaled_dot_product_attention``;
        bf16 flash attention within the JAX package's 2e-2 and no further
        from the plain version than 1.5x SDPA's largest error; RMSNorm
        also with a scale of the other type; the host time a call of the
        RMSNorm wrapper, ``F.rms_norm`` and each piece of a wrapper at the
        decode shape, over 10,000 calls each;
     b. the card port against the CPU port on the reduced qwen2.5-14b,
        smollm-135m and stablelm-1.6b (forward and 8 decode steps);
     c. the main path: qwen2.5-14b at its published widths and 48 layers
        with random weights from seed 0 on the card, a forward of 4 x 2,048
        tokens (rmsnorm 97 and flash 48 launches, exactly) and
        ``launch/serve.py:generate`` for 4 requests (prompt 16, gen 32: 47
        decode steps, 4,559 rmsnorm launches, no flash), each run twice;
        decode through the cache against the forward (B=2 x S=256), both
        held to an f32 forward without kernels, with two wrong-attention
        controls that must fail the bound; one decode step
        and one forward under sync debug mode "error"; the peak device
        bytes; a profile of one forward and one decode step;
  7. frequent subgraph mining (``FSMApp``: edge-induced exploration,
     min-image support from domain bitmaps, alpha pruning by support):
     a. the card port against the CPU port on ``citeseer_like(0.1)``,
        ``FSMApp(support=2, max_size=3)``, under the default config,
        ``cost_model="force_device"``, ``device_aggregate=False`` and
        ``graph_partition=4``, and, after b and c (whose host level 2
        would otherwise find its memo filled), ``FSMApp(support=2,
        max_size=4)`` under ``force_device`` (the device level 2 and its
        orbit pass at nv 5) (patterns and supports, embedding counts,
        per-step counters identical); one FSM chunk program per layout
        under sync debug mode "error";
     b. the main path at the paper's FSM graph, ``citeseer_like(1.0)``,
        ``FSMApp(support=25, max_size=3)`` (three configs at 3 edges; 8c
        mines its 4 edges, 60-90 s a run), and at the
        example's scale, ``citeseer_like(0.3)``, ``FSMApp(support=8,
        max_size=4)``, each under the default config and ``force_device``
        (device level 2 with its orbit pass, the radix bin), the first also
        under ``graph_partition=4``: identical patterns, a frequent
        pattern of the largest size;
     c. the domain stress: ``mico_like(0.1)``, ``FSMApp(support=100,
        max_size=2)``, default config;
     for each run of b and c the wall, per step the phase times, syncs,
     chunks and the domain bitmap's bytes, the host seconds of the domain
     scatter (with its copy) and of the min-image support, the peak device
     bytes and the
     launches per kernel (zeroed just before the run, read just after,
     added to the kernels line); the host syncs within the window rule,
     ``stream_compact`` and ``seg_unique`` launched in every run, under
     ``force_device`` two refine launches (the orbit pass) a level-2
     pass; the single-edge supports against a count from the edge list;
     then the refine with orbits on the canonical table of step 4, exact
     against its plain version and against ``automorphism_orbits``, timed
     beside the plain version;
  8. the frontier stores (the ODAG store, paper §5.2-5.3, and the spill
     store's device-budget waves):
     a. the card port against the CPU port (patterns, embedding counts,
        every per-step counter with ``odag_bytes``, and the waves per
        step) on ``mico_like(0.005)``: size-3 motifs and size-4 cliques
        under ``store="odag"``, size-3 motifs under a budget of an eighth
        of their peak frontier bytes for the raw and the ODAG store (more
        than one wave a step); size-4 motifs under ``store="odag"`` on
        ``mico_like(0.001)``; FSM on ``citeseer_like(0.1)``, support 2, 3
        edges, under ``store="odag"`` and under a budget as well;
     b. the main path under ``store="odag"`` on ``mico_like(0.1)``:
        size-3 motifs and size-4 cliques, each equal to phase 5's
        raw-store run (patterns, embeddings as sets, frontier rows per
        step), kernels counted; per step the raw and the ODAG bytes (Fig.
        9's ratio) and ``t_storage``; per extraction its seconds, levels,
        chunks, candidate pairs, host syncs (one a level and chunk, one
        for the copy) and the ``canonical_check`` and ``stream_compact``
        launches within it (``canonical_check`` must launch);
     c. the paper's FSM graph at its depth, ``citeseer_like(1.0)``,
        support 25, 4 edges (~2.6e8 embeddings at step 4), under
        ``device_budget_bytes=2**30`` and then in one wave: the waves per
        step, the walls, the peaks; a frequent pattern of 4 edges, the
        same patterns in both runs and, up to 3 edges, 7b's patterns.

Times are amortised (``time_call``): after a warm-up, one CUDA event pair
around N back-to-back calls (N >= 20, or enough for 2 ms; one call for the
slow plain versions), divided by N, the median of 3-5 such windows. Where
the host's enqueue takes at least 0.8x the event time, the row is marked
``host_bound`` and also carries the profiler's device time per call.

It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. ``--json PATH`` also writes the details
(per-step times, peak bytes, launches per run) to PATH. It needs the
repository's ``src`` beside it and a CUDA device; it imports neither JAX
nor the JAX package.

    python3 chip_smoke.py --kernel-ab PARENT_SRC [--json PATH]

runs only the parent-against-change comparison of the redesigned kernels
of ``PARENT_SRC``'s ``repro_torch`` (for example a ``git archive`` of the
parent commit unpacked under ``archive_check/``) and of this checkout's:
the expansion at the chunk and at the wide shape of phase 3, the whole
radix sort and ``seg_unique`` at the chunk and level-2 shapes of phases 3
and 5, the canonical refine at the level-2 table and on the seeded codes
of every nv from 2 to 8, in turns (parent, change, change, parent), each
in a process of its own.

    python3 chip_smoke.py --fsm-full-depth

runs only phase 8c (the depth 7b stops short of), under the budget and in
one wave, and prints their record where both pass and agree; where a run
runs the card out of memory, it logs the failed allocation, where it was
made and the peak, and exits non-zero.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: published H100 SXM device-memory rate (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM int32 rate: 132 SMs x 64 INT32 lanes x 1.98 GHz (the lanes are
#: half the 128 FP32 lanes behind the data sheet's 67 TFLOP/s FP32, which
#: counts an FMA as two), operations/s.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: H100 SXM dense bf16 tensor-core rate and f32 rate outside the tensor
#: cores (NVIDIA data sheet, an FMA counted as two), FLOP/s.
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
CHUNK = 4096                   # RunConfig.chunk_size default
REFINE_ROWS = 3000             # seeded quick codes per nv (2/3 of it at nv 8)
AGG_QCAP = 4096                # RunConfig.agg_qcap default
#: the expansion kernel's wide synthetic shape: a uniform random graph of
#: 2^17 vertices (4,096 bitmap words a row) and 2^21 edges, and CHUNK
#: parents of k = 8 random members: 8 x 4,096 words are past the kernel's
#: shared-memory budget, so the global-read variant runs
WIDE_N, WIDE_M, WIDE_K = 1 << 17, 1 << 21, 8
PARTS = 4                      # graph shards of the partitioned runs
#: phase 7 (FSM): the card-vs-CPU graph; the paper's FSM graph at full
#: scale (citeseer_like(1.0): 3,312 vertices, 4,732 edges, 6 labels, paper
#: Table 1) with the example's support of 8 at scale 0.3 scaled to the
#: whole graph, to 3 edges under three configs (phase 8c mines its 4
#: edges, ~2.6e8 embeddings, in waves and in one wave), and at the
#: example's own scale, support and depth (citeseer_like(0.3), 8, 4
#: edges); the domain stress on mico_like(0.1) at size 2
FSM_SMALL = 0.1                # citeseer_like scale of 7a
FSM_SMALL_APP = dict(support=2, max_size=3)
FSM_SMALL4_APP = dict(support=2, max_size=4)   # 7a's nv-5 orbit pass
FSM_MAIN_APP = dict(support=25, max_size=3)
FSM_DEEP = 0.3                 # citeseer_like scale of the 4-edge runs
FSM_DEEP_APP = dict(support=8, max_size=4)
FSM_STRESS_APP = dict(support=100, max_size=2)
#: phase 8 (stores): the card-vs-CPU graphs (size-4 motifs on the smaller
#: one: mico_like(0.005) holds 17.3e6 of them, minutes a run on the CPU)
#: and the device budget of the paper's FSM graph at its depth
STORE_SMALL = 0.005
STORE_TINY = 0.001
FSM_DEPTH_BUDGET = 1 << 30     # ~6.7e7 size-4 rows a wave
MODEL = "qwen2.5-14b"          # phase 6's model, full widths and depth
FWD_B, FWD_S = 4, 2048         # the timed forward: 4 prompts x 2,048 tokens
SERVE_B, SERVE_P, SERVE_G = 4, 16, 32   # launch/serve.py's defaults
CHECK_B, CHECK_S = 2, 256      # decode through the cache vs the forward
#: decode vs forward at full depth, as relative RMS errors of the logits
#: (RMS of the difference over RMS of the logits). Only bf16 rounding over
#: 48 layers separates serving from the forward: both round the softmax
#: weights to bf16 (decode in eager PyTorch, the forward in the flash
#: kernel before its PV product), at other places in the sum, and the
#: matmuls run at other shapes. Both are also held to an f32 forward of the
#: same weights through the kernels' plain versions (the reference; it runs
#: the port's own block code, so it checks the two kernels and bf16
#: precision, while RoPE, the projections and the MLP are held to the JAX
#: package by tests/test_torch_models.py at reduced widths). Fixed bounds,
#: about 2.5x the readings on an H100 with the CUDA-core flash kernel
#: (forward and decode 0.0193 and 0.0195 from the reference, decode vs
#: forward 0.0228 over all positions and 0.0273 at the worst), and 20x
#: below the controls: a forward without the causal mask, or with KV tile 0
#: dropped past row 63, reads 1.22-1.38 and must land outside the
#: decode-vs-forward bound.
FORWARD_VS_F32_MAX = 0.05
DECODE_VS_F32_MAX = 0.05
DECODE_VS_FORWARD_MAX = 0.06


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


#: a timing window holds at least this many milliseconds of calls
WINDOW_MS = 2.0
#: most calls in one window (a 2 ms window of 2 us calls)
MAX_CALLS = 1000
#: a call is host-bound when the host's enqueue takes at least this share
#: of its event time: the card then waits for the host, and the events time
#: the host
HOST_BOUND_SHARE = 0.8
#: timing of the slow plain versions: one call a window, three windows
PLAIN = {"calls": 1, "windows": 3, "warmup": 1}


def time_call(torch, fn, calls: int = 20, windows: int = 5, warmup: int = 2,
              device: bool = False) -> dict:
    """Milliseconds per call of ``fn()``, amortised: after ``warmup``
    untimed calls, one CUDA event pair around N back-to-back calls, divided
    by N; the median of ``windows`` such windows. N is ``calls``, or more
    where the warm-up says that ``calls`` take less than ``WINDOW_MS``.
    Also the host's enqueue per call (host clock around the N calls, before
    the closing synchronise), ``host_bound`` when that is at least
    ``HOST_BOUND_SHARE`` of the event time, and then, with ``device=True``,
    the profiler's device time per call (:func:`device_ms`)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    est = (time.perf_counter() - t0) * 1e3 / max(warmup, 1)
    n = max(calls, min(MAX_CALLS, math.ceil(WINDOW_MS / max(est, 1e-3))))
    ev, host = [], []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / n)
        b.record()
        b.synchronize()
        ev.append(a.elapsed_time(b) / n)
    out = {"ms": statistics.median(ev), "host_ms": statistics.median(host),
           "calls": n, "windows": windows}
    out["host_bound"] = out["host_ms"] >= HOST_BOUND_SHARE * out["ms"]
    out["device_ms"] = (device_ms(torch, fn, n)
                        if device and out["host_bound"] else None)
    return out


def time_ms(torch, fn, calls: int = 20, windows: int = 5,
            warmup: int = 2) -> float:
    """:func:`time_call`'s amortised event milliseconds per call."""
    return time_call(torch, fn, calls, windows, warmup)["ms"]


def device_ms(torch, fn, calls: int):
    """Device milliseconds per call of ``fn()`` by ``torch.profiler``: the
    device records (kernels, copies, memsets) of ``calls`` calls over
    ``calls``; ``None`` where the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if getattr(e, "device_type", None) == DeviceType.CUDA
             and e.key != "Command Buffer Full")
    return us / 1e3 / calls if us > 0 else None


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


def kernel_row(name, src, replaces, err, timed, plain_ms, nbytes, library_ms,
               ops=0, op_rate=INT32_OPS_PER_S):
    """One entry of the kernels line, from the kernel's :func:`time_call`
    record ``timed``: the bound is the larger of the bytes over the memory
    rate and the operations over their type's rate (int32 unless
    ``op_rate`` says otherwise)."""
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / op_rate * 1e3
    ms = timed["ms"]
    row = {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "library_ms": library_ms, "bytes": nbytes, "ops": ops,
        "host_ms": timed["host_ms"], "host_bound": timed["host_bound"],
        "device_ms": timed["device_ms"], "calls": timed["calls"],
    }
    host = (f" HOST-BOUND (enqueue {timed['host_ms']:.4f} ms a call; "
            f"profiler device {timed['device_ms']} ms)"
            if timed["host_bound"] else "")
    log(f"  {name}: max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f}"
        f" bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
        f"library_ms={library_ms}{host}")
    return row


def compact_cases(torch, compact, build):
    """The compaction kernel against its plain version off the main path's
    shape: B of 0, 1, one tile, one tile + 1 and 4 x 132 tiles + 77 (look-
    back chains longer than the card holds tiles at once); masks all
    false, all true and random at 0.3; out_cap 0, below the count and above
    it; the flags contiguous and at byte offset 3. Each case runs twice
    (the second call on the first one's scratch block, so a missed reset
    of the tile words would show). Returns the largest difference."""
    tile = build.library().repro_compact_tile()
    gen = torch.Generator(device="cuda").manual_seed(5)
    err, n = 0, 0
    for b in (0, 1, tile, tile + 1, 4 * 132 * tile + 77):
        flags = torch.rand(b + 3, generator=gen, device="cuda") < 0.3
        for fill in (None, False, True):
            if fill is not None:
                flags.fill_(fill)
            for keep in (flags[:b], flags[3:]):
                kept = int(keep.sum())
                for cap in (0, kept // 2, kept + 5):
                    want = compact.stream_compact_ref(keep, cap)
                    for _ in range(2):
                        got = compact.stream_compact_cuda(keep, cap)
                        torch.cuda.synchronize()
                        err = max(err, max_abs_err(torch, got, want))
                        n += 1
    log(f"  stream_compact: {n} off-path cases (B 0 to {4 * 132 * tile + 77}"
        f", tiles of {tile}), max_abs_err {err}")
    return err


def first_chunk(torch, np, dg, g) -> dict:
    """The first size-2 chunk of ``g`` (its first ``CHUNK`` edges) through
    the chunk program's kernel route: the expansion (``cand``, ``valid``,
    ``keep3``), the kept children compacted to ``out_cap`` rows, and their
    quick codes (``qp``), the rows that the radix bin sorts."""
    from repro_torch.core import explore, pattern
    from repro_torch.core.runtime.config import next_pow2
    from repro_torch.kernels.canonical_check.canonical_check import (
        expand_canonical_cuda,
    )

    dev = dg.device
    members = torch.from_numpy(g.edges[:CHUNK].astype(np.int32)).to(dev)
    n_valid = torch.full((CHUNK,), 2, dtype=torch.int32, device=dev)
    c, k, d = members.shape[0], members.shape[1], dg.max_degree
    cand, valid, keep3 = expand_canonical_cuda(members, n_valid, dg.nbr,
                                               dg.adj_bits)
    flat_rows = torch.arange(c, dtype=torch.int32,
                             device=dev).repeat_interleave(k * d)
    keep = keep3.reshape(-1)
    kept = int(keep.sum())
    out_cap = next_pow2(kept)
    children, count = explore.compact(
        members, explore.Expansion(flat_rows, cand.reshape(-1), keep,
                                   None, None),
        keep, out_cap, use_kernel=True)
    child_nv = torch.where(torch.arange(out_cap, device=dev) < count, k + 1,
                           0).to(torch.int32)
    qp = pattern.quick_pattern_vertex(dg, children, child_nv)
    return dict(members=members, n_valid=n_valid, cand=cand, valid=valid,
                keep3=keep3, flat_rows=flat_rows, keep=keep, kept=kept,
                out_cap=out_cap, child_nv=child_nv, qp=qp)


def expand_bytes(torch, members, n_valid, cand, d, w, whole_rows):
    """Bytes the expansion must move: members and n_valid read, 6 bytes a
    slot written, each distinct member's neighbour row read, and of the
    bitmap either each distinct member's row (``whole_rows``: the staged
    variant's reads) or the distinct words its bit tests need (the valid
    members' rows at the words of the slots with a candidate)."""
    c, k = members.shape
    n_rows = int(torch.unique(members).numel())
    nbytes = c * k * 4 + c * 4 + n_rows * d * 4 + c * k * d * (4 + 1 + 1)
    if whole_rows:
        return nbytes + n_rows * w * 4
    ok = torch.arange(k, device=members.device)[None, :] < n_valid[:, None]
    col = (cand.clamp(min=0) >> 5).clamp(max=w - 1)          # (C, k, D)
    key = (members.clamp(min=0).to(torch.int64)[:, :, None, None] * w
           + col[:, None, :, :])
    need_ = ok[:, :, None, None] & (cand >= 0)[:, None, :, :]
    return nbytes + int(torch.unique(key[need_]).numel()) * 4


def expand_wide_case(torch, np, ops) -> dict:
    """The expansion kernel of ``ops`` (a ``canonical_check`` module) at
    the wide synthetic shape (``WIDE_N``): exact against its plain version,
    then timed, with its bound (the bitmap words its bit tests need)."""
    from repro_torch.core import graph as G

    dg = G.to_device(G.random_labeled(WIDE_N, WIDE_M, n_labels=29, seed=3,
                                      power_law=False))
    rng = np.random.default_rng(3)
    members = torch.from_numpy(rng.integers(
        0, WIDE_N, (CHUNK, WIDE_K)).astype(np.int32)).to(dg.device)
    n_valid = torch.full((CHUNK,), WIDE_K, dtype=torch.int32,
                         device=dg.device)
    args = (members, n_valid, dg.nbr, dg.adj_bits)
    got = ops.expand_canonical_cuda(*args)
    err = max_abs_err(torch, got, ops.expand_canonical_ref(*args))
    need(err == 0, f"expand_canonical differs at the wide shape ({err})")
    timed = time_call(torch, lambda: ops.expand_canonical_cuda(*args),
                      device=True)
    w = dg.adj_bits.shape[1]
    variant = getattr(ops, "expand_variant", None)
    out = {"n": WIDE_N, "k": WIDE_K, "C": CHUNK, "D": dg.max_degree, "W": w,
           "kept": int(got[2].sum()), "max_abs_err": err,
           "variant": variant(WIDE_K, w) if variant else None,
           "ms": timed["ms"], "host_ms": timed["host_ms"],
           "device_ms": timed["device_ms"],
           "bound_ms": expand_bytes(torch, members, n_valid, got[0],
                                    dg.max_degree, w, False)
           / HBM_BYTES_PER_S * 1e3}
    del dg, got, args
    torch.cuda.empty_cache()
    return out


def kernel_checks(torch, np, dg, g):
    """Phase 3: every kernel against its plain version at main-path shapes
    (the first size-2 chunk of mico_like(0.1) and what it produces)."""
    from repro_torch.kernels import build, compact
    ops = importlib.import_module(
        "repro_torch.kernels.canonical_check.canonical_check")
    from repro_torch.kernels.canonical_check.canonical_check import (
        canonical_check_cuda, canonical_check_ref, expand_canonical_cuda,
        expand_canonical_ref,
    )

    dev = dg.device
    ch = first_chunk(torch, np, dg, g)
    members, n_valid = ch["members"], ch["n_valid"]
    c, k, d = members.shape[0], members.shape[1], dg.max_degree
    w = dg.adj_bits.shape[1]
    n_member_rows = int(torch.unique(members).numel())
    rows = []

    # -- expand_canonical: members (4096, 2), D = max degree ----------------
    got = (ch["cand"], ch["valid"], ch["keep3"])
    want = expand_canonical_ref(members, n_valid, dg.nbr, dg.adj_bits)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    need(err == 0, f"expand_canonical differs from its plain version ({err})")
    timed = time_call(torch, lambda: expand_canonical_cuda(
        members, n_valid, dg.nbr, dg.adj_bits), device=True)
    plain = time_ms(torch, lambda: expand_canonical_ref(
        members, n_valid, dg.nbr, dg.adj_bits), **PLAIN)
    nbytes = expand_bytes(torch, members, n_valid, ch["cand"], d, w, True)
    log(f"  expand_canonical at the chunk (C={c}, k={k}, D={d}, W={w}): "
        f"the {ops.expand_variant(k, w)} variant")
    rows.append(kernel_row(
        "expand_canonical", "src/repro_torch/kernels/csrc/expand_canonical.cu",
        "src/repro/kernels/canonical_check/canonical_check.py:252",
        err, timed, plain, nbytes, None))
    cand, flat_rows = ch["cand"], ch["flat_rows"]
    del want
    wide = expand_wide_case(torch, np, ops)
    log(f"  expand_canonical at the wide shape (C={wide['C']}, k={wide['k']},"
        f" n={wide['n']}, D={wide['D']}, W={wide['W']}): the "
        f"{wide['variant']} variant, max_abs_err={wide['max_abs_err']} "
        f"ms={wide['ms']:.4f} (device {wide['device_ms']}) "
        f"bound_ms={wide['bound_ms']:.4f}, {wide['kept']} kept")

    # -- canonical_check: the unfused route's flat batch --------------------
    fm, fn_, fc = members[flat_rows], n_valid[flat_rows], cand.reshape(-1)
    b = fc.shape[0]
    got = (canonical_check_cuda(fm, fn_, fc, dg.adj_bits),)
    want = (canonical_check_ref(fm, fn_, fc, dg.adj_bits),)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    need(err == 0, f"canonical_check differs from its plain version ({err})")
    timed = time_call(torch, lambda: canonical_check_cuda(
        fm, fn_, fc, dg.adj_bits), device=True)
    plain = time_ms(torch, lambda: canonical_check_ref(
        fm, fn_, fc, dg.adj_bits), **PLAIN)
    nbytes = b * k * 4 + b * 4 + b * 4 + n_member_rows * w * 4 + b
    rows.append(kernel_row(
        "canonical_check", "src/repro_torch/kernels/csrc/canonical_check.cu",
        "src/repro/kernels/canonical_check/canonical_check.py:87",
        err, timed, plain, nbytes, None))
    log(f"  canonical_check batch: members {tuple(fm.shape)}, "
        f"{b} candidates")
    del fm, fn_, fc, got, want

    # -- stream_compact: the chunk's keep mask -----------------------------
    keep, kept, out_cap = ch["keep"], ch["kept"], ch["out_cap"]
    errs = []
    for cap in (out_cap, CHUNK):        # main-path capacity, and overflow
        got = compact.stream_compact_cuda(keep, cap)
        want = compact.stream_compact_ref(keep, cap)
        torch.cuda.synchronize()
        errs.append(max_abs_err(torch, got, want))
        need(int(got[1]) == kept, "stream_compact count is not the "
             "unclamped kept total")
    err = max(errs + [compact_cases(torch, compact, build)])
    need(err == 0, f"stream_compact differs from its plain version ({err})")
    timed = time_call(torch, lambda: compact.stream_compact_cuda(
        keep, out_cap), device=True)
    plain = time_ms(torch, lambda: compact.stream_compact_ref(keep, out_cap))
    lib_ms = time_ms(torch, lambda: torch.nonzero(keep))
    nbytes = keep.numel() + out_cap * 4 + 4
    rows.append(kernel_row(
        "stream_compact", "src/repro_torch/kernels/csrc/stream_compact.cu",
        "src/repro/kernels/compact.py:91", err, timed, plain, nbytes, lib_ms))
    log(f"  stream_compact: B={keep.numel()} kept={kept} out_cap={out_cap}")

    # -- seg_unique: the chunk's children codes, sorted ---------------------
    qp, child_nv = ch["qp"], ch["child_nv"]
    acap = min(out_cap, AGG_QCAP)
    rows.append(seg_unique_case(torch, qp.codes, child_nv > 0, acap,
                                out_cap, "chunk"))

    # -- radix passes: the same chunk's child codes, as the radix bin of the
    # chunk program gets them ----------------------------------------------
    codes, cvalid = qp.codes, child_nv > 0
    extra = {"radix": radix_checks(torch, codes, cvalid, rows),
             "expand_wide": wide}
    del qp, codes, cvalid, ch
    torch.cuda.empty_cache()
    extra["refine_synthetic"] = refine_synthetic_checks(torch, np, dev)
    build.reset_launches()
    return rows, extra


def seg_inputs(torch, codes, valid):
    """The flags ``bin_sorted`` gives ``seg_unique`` for a batch of codes:
    (new, valid) in sort order, and the sorted codes."""
    from repro_torch.kernels import aggregate

    sc, sv, _ = aggregate.sort_codes(codes, valid)
    new = sv & torch.cat([torch.ones(1, dtype=torch.bool, device=sc.device),
                          (sc[1:] != sc[:-1]).any(1)])
    return new, sv, sc


def seg_unique_bytes(b: int, cap: int) -> int:
    """Bytes ``seg_unique`` must move: both flags read, the slots written
    (6 B a row), and the src and counts windows and n written."""
    return 6 * b + 2 * cap * 4 + 4


def seg_unique_case(torch, codes, valid, cap, wide_cap, label):
    """``seg_unique`` on one batch of sorted codes against its plain
    version (exact) at the main path's ``cap`` and at ``wide_cap``; then
    its kernel row, timed at ``cap``."""
    from repro_torch.kernels import aggregate

    new, sv, sc = seg_inputs(torch, codes, valid)
    errs = []
    for c in (cap, wide_cap):
        got = aggregate.seg_unique_cuda(new, sv, c)
        want = aggregate.seg_unique_ref(new, sv, c)
        torch.cuda.synchronize()
        errs.append(max_abs_err(torch, got, want))
    err = max(errs)
    need(err == 0, f"seg_unique differs from its plain version at {label} "
         f"({err})")
    n_distinct = int(got[3])
    del got, want
    timed = time_call(torch, lambda: aggregate.seg_unique_cuda(
        new, sv, cap), device=True)
    plain = time_ms(torch, lambda: aggregate.seg_unique_ref(new, sv, cap))
    valid_rows = sc[:int(sv.sum())]
    lib_ms = time_ms(torch, lambda: torch.unique_consecutive(
        valid_rows, dim=0, return_inverse=True, return_counts=True))
    bsz = new.numel()
    log(f"  seg_unique at {label}: B={bsz} cap={cap} distinct={n_distinct}")
    return kernel_row(
        "seg_unique", "src/repro_torch/kernels/csrc/seg_unique.cu",
        "src/repro/kernels/aggregate.py:110", err, timed, plain,
        seg_unique_bytes(bsz, cap), lib_ms)


def radix_pass_bytes(b, i, gather, carry, last, word):
    """Bytes one pass of the scatter kernel must move: the order read
    (not on the first pass, which reads the rows in place), the key read
    coalesced or, on a word's first pass, the word (the flag: a byte)
    gathered, the order written, when the next pass sorts by the same
    word the key written, and on the last pass the rows' codes and valid
    flags read and written in the sorted order."""
    key = (1 if word == 3 else 4) if gather else 4
    return b * ((4 if i else 0) + key + 4 + (4 if carry else 0)
                + (2 * 25 if last else 0))


def time_after(torch, first, fn, first_timed):
    """A :func:`time_call` record of ``fn()``, a launch that must follow
    ``first()`` (whose record is ``first_timed``): the pair timed together,
    less ``first``'s times."""
    pair = time_call(torch, lambda: (first(), fn()), device=True)
    dev = (pair["device_ms"] - first_timed["device_ms"]
           if pair["device_ms"] and first_timed["device_ms"] else None)
    return dict(pair, ms=pair["ms"] - first_timed["ms"],
                host_ms=pair["host_ms"] - first_timed["host_ms"],
                device_ms=dev, pair_ms=pair["ms"])


def radix_case(torch, codes, valid, label):
    """The radix sort of one batch: the whole sort and each kernel against
    its plain version (exact), and their times. The histogram once; the
    scatter kernel at every launch of the plan, each from the state the
    launches before it left (so every pass after the first reads a
    non-identity order), timed after the histogram that clears its
    scratch (:func:`time_after`), and one launch past the plan. Also the
    library sorts."""
    from repro_torch.kernels import aggregate, radix_bin as R

    b = codes.shape[0]
    dev = codes.device
    got = R.radix_sort_codes(codes, valid)
    want = R.radix_sort_codes_ref(codes, valid)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    need(err == 0, f"radix_sort_codes differs from its plain version at "
         f"{label} ({err})")
    del got, want
    st = R.RadixScratch(b, dev)
    R.radix_hist_cuda(codes, valid, st)
    ref = R.radix_digit_counts_ref(codes, valid)
    torch.cuda.synchronize()
    herr = max_abs_err(torch, (st.plan, st.counts, st.bases), ref)
    need(herr == 0, f"radix_hist differs from its plain version at {label} "
         f"({herr})")
    plan = st.plan.tolist()
    nvary = plan[0]

    def hist():
        R.radix_hist_cuda(codes, valid, st)

    h_timed = time_call(torch, hist, device=True)
    passes = [R._PASSES[p] for p in plan[1:1 + nvary]]
    words = [w for w, _ in passes]
    launches, serr = [], 0
    for i, (word, shift) in enumerate(passes):
        gather = i == 0 or words[i - 1] != word
        last = i == nvary - 1
        carry = not last and words[i + 1] == word
        order = (torch.arange(b, dtype=torch.int32, device=dev) if i == 0
                 else st.orders[i & 1].clone())
        keys = (R._word(codes, valid, word)[order.long()] if gather
                else st.keys[i & 1].long() & 0xFFFFFFFF)
        R.radix_scatter_cuda(codes, valid, st, i)
        k_ref, o_ref = R.radix_pass_ref(keys, order, shift)
        if last:
            got = [st.out, st.codes_out, st.valid_out]
            exp = [o_ref, codes[o_ref], valid[o_ref]]
        else:
            got = [st.orders[(i + 1) & 1]] + (
                [st.keys[(i + 1) & 1].long() & 0xFFFFFFFF] if carry else [])
            exp = [o_ref] + ([k_ref] if carry else [])
        torch.cuda.synchronize()
        e = max_abs_err(torch, got, exp)
        need(e == 0, f"radix_scatter launch {i} (pass {word, shift}) "
             f"differs from its plain version at {label} ({e})")
        serr = max(serr, e)
        timed = time_after(torch, hist, lambda: R.radix_scatter_cuda(
            codes, valid, st, i), h_timed)
        plain = time_ms(torch, lambda: R.radix_pass_ref(keys, order, shift))
        digits = (keys >> shift) & 0xFF
        lib = time_ms(torch, lambda: torch.sort(digits, stable=True))
        nbytes = radix_pass_bytes(b, i, gather, carry, last, word)
        launches.append({"launch": i, "pass": [word, shift],
                         "gather": gather, "carry": carry, "last": last,
                         "timed": timed, "plain_ms": plain,
                         "library_ms": lib, "bytes": nbytes,
                         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
        log(f"  radix {label} launch {i} pass {(word, shift)} "
            f"{'gather' if gather else 'carried'}"
            f"{' +keys' if carry else ''}{' +outputs' if last else ''}: "
            f"{timed['ms']:.4f} ms, plain "
            f"{plain:.4f} ms, bound {launches[-1]['bound_ms']:.4f} ms, "
            f"torch.sort of its digits {lib:.4f} ms")
        del order, keys, k_ref, o_ref, got, exp, digits
    idle = (time_call(torch, lambda: R.radix_scatter_cuda(
        codes, valid, st, len(R._PASSES) - 1), device=True)
        if nvary < len(R._PASSES) else None)
    h_plain = time_ms(torch, lambda: R.radix_digit_counts_ref(codes, valid),
                      **PLAIN)
    # codes and valid read once, the counts, bases and plan written
    h_bytes = b * 25 + 4 * (2 * 13 * 256 + 14)
    sort_ms = time_ms(torch, lambda: R.radix_sort_codes(codes, valid))
    sort_plain = time_ms(torch, lambda: R.radix_sort_codes_ref(
        codes, valid), **PLAIN)
    key = R._fused_keys(codes, valid)[0]
    fused_ms = time_ms(torch, lambda: torch.sort(key, stable=True))
    sort_codes_ms = time_ms(torch, lambda: aggregate.sort_codes(codes,
                                                                valid))
    # the histogram, the three int32 code words it writes, and the passes
    sort_bytes = h_bytes + 12 * b + sum(x["bytes"] for x in launches)
    info = {
        "label": label, "rows": b, "valid": int(valid.sum()),
        "varying_passes": passes, "sort_ms": sort_ms,
        "sort_plain_ms": sort_plain,
        "sort_bound_ms": sort_bytes / HBM_BYTES_PER_S * 1e3,
        "fused_key_torch_sort_ms": fused_ms,
        "sort_codes_library_ms": sort_codes_ms,
        "hist": {"timed": h_timed, "plain_ms": h_plain, "bytes": h_bytes,
                 "bound_ms": h_bytes / HBM_BYTES_PER_S * 1e3, "err": herr},
        "launches": launches, "idle_launch": idle, "scatter_err": serr,
    }
    log(f"  radix {label}: B={b}, valid {info['valid']}, {nvary} of 13 "
        f"passes vary {passes}; whole sort {sort_ms:.4f} ms (bound "
        f"{info['sort_bound_ms']:.4f} ms), plain {sort_plain:.4f} ms, "
        f"torch.sort of the fused key {fused_ms:.4f} ms, sort_codes "
        f"{sort_codes_ms:.4f} ms; histogram {h_timed['ms']:.4f} ms (bound "
        f"{info['hist']['bound_ms']:.4f}); a launch past the plan "
        f"{idle and idle['ms']} ms")
    return info


def radix_checks(torch, codes, valid, rows):
    """Phase 3's radix rows, on the first size-2 chunk's child codes: the
    histogram, and the scatter kernel at the first pass of a later word
    (w0, byte 0), whose key is gathered through the order the passes
    before it left."""
    info = radix_case(torch, codes, valid, "chunk")
    gathered = [x for x in info["launches"] if x["launch"] and x["gather"]
                and x["pass"][0] != 3]
    need(gathered, f"no pass gathers a word through a non-identity order: "
         f"{info['varying_passes']}")
    row = gathered[0]
    h = info["hist"]
    rows.append(kernel_row(
        "radix_hist", "src/repro_torch/kernels/csrc/radix_sort.cu",
        "src/repro/kernels/radix_bin.py:83", h["err"], h["timed"],
        h["plain_ms"], h["bytes"], None))
    rows.append(kernel_row(
        "radix_scatter", "src/repro_torch/kernels/csrc/radix_sort.cu",
        "src/repro/kernels/radix_bin.py:92", info["scatter_err"],
        row["timed"], row["plain_ms"], row["bytes"], row["library_ms"]))
    log(f"  radix rows: radix_scatter timed at launch {row['launch']}, pass "
        f"{tuple(row['pass'])}")
    return info


def level2_rebin_input(torch, table):
    """The canonical codes and valid mask that the device level 2 of the
    recorded table hands to ``bin_rows`` (``aggregation._level2_program``)."""
    from repro_torch.kernels import canonical_refine

    u, c, uv, cap, nvs = table
    canon = canonical_refine.refine_codes(u, uv, nvs, use_kernel=True)[0]
    return canon.masked_fill(~uv[:, None], 0).contiguous(), uv


def library_gather(torch, table, rows, fill):
    """One library gather of the same function: ``index_select`` of the
    clamped rows, then the fill mask."""
    out = torch.index_select(table, 0, rows.clamp(0, table.shape[0] - 1))
    ok = (rows >= 0) & (rows < table.shape[0])
    return out.masked_fill_(~ok[:, None], fill)


def partition_checks(torch, np, G, g):
    """Phase 3, partitioned layout: the halo gather and the tile check
    against their plain versions at the shapes the first size-2 chunk of
    the partitioned main path gives them. Returns the two kernel rows and
    the partitioned graph (for the sync check)."""
    from repro_torch.core import explore
    from repro_torch.kernels import compact, gather
    from repro_torch.kernels.canonical_check.canonical_check import (
        canonical_check_tiles_cuda, canonical_check_tiles_ref, expand_masks,
    )

    pg = G.to_partitioned(g, PARTS)
    dev = pg.device
    members = torch.from_numpy(g.edges[:CHUNK].astype(np.int32)).to(dev)
    n_valid = torch.full((CHUNK,), 2, dtype=torch.int32, device=dev)
    c, k, d = members.shape[0], members.shape[1], pg.max_degree
    w = pg.adj_sh.shape[2]
    cap = explore.halo_cap(members.shape, "vertex", pg.n)
    verts = explore.halo_vertices(pg, members, n_valid, "vertex")
    uniq, count = gather.halo_unique(verts, pg.n, cap, use_kernel=True)
    want = gather.halo_unique(verts, pg.n, cap, use_kernel=False)
    torch.cuda.synchronize()
    need(max_abs_err(torch, (uniq, count), want) == 0,
         "halo_unique through the compaction kernel differs from its plain "
         "version")
    fi, ok = pg.flat_index(uniq)
    fi = torch.where(ok, fi, -1)
    n_hit = int(count)
    log(f"  partitioned: bounds {pg.part_offsets.tolist()}, "
        f"{pg.tile_rows} rows per shard, halo {n_hit} of U={cap}")
    info = {"part_offsets": pg.part_offsets.tolist(),
            "tile_rows": pg.tile_rows, "halo": n_hit, "halo_cap": cap}
    # the compaction at halo_unique's shape: n presence flags, host-bound
    flat = verts.reshape(-1)
    presence = torch.zeros((pg.n + 1,), dtype=torch.bool, device=dev)
    presence.scatter_(0, torch.where((flat >= 0) & (flat < pg.n), flat,
                                     pg.n).to(torch.int64), True)
    presence = presence[:pg.n]
    info["stream_compact_halo"] = t = time_call(
        torch, lambda: compact.stream_compact_cuda(presence, cap),
        device=True)
    log(f"  stream_compact at halo_unique's shape (n={pg.n}, out_cap={cap})"
        f": {t['ms']:.4f} ms by events, host enqueue {t['host_ms']:.4f} ms "
        f"a call, profiler device {t['device_ms']} ms")

    # -- gather_rows: the neighbour and adjacency tiles of the chunk --------
    rows, gathers = [], {}
    for name, table, fill in (
            ("nbr", pg.nbr_sh.reshape(-1, d), -1),
            ("adj", pg.adj_sh.reshape(-1, w), 0)):
        got = gather.gather_rows_cuda(table, fi, fill)
        want = gather.gather_rows_ref(table, fi, fill)
        torch.cuda.synchronize()
        err = max_abs_err(torch, (got,), (want,))
        need(err == 0, f"gather_rows ({name}) differs from its plain "
             f"version ({err})")
        del got, want
        timed = time_call(torch, lambda: gather.gather_rows_cuda(
            table, fi, fill), device=True)
        plain = time_ms(torch, lambda: gather.gather_rows_ref(
            table, fi, fill))
        lib_ms = time_ms(torch, lambda: library_gather(
            torch, table, fi, fill))
        r = table.shape[1]
        nbytes = cap * 4 + n_hit * r * 4 + cap * r * 4
        log(f"  gather_rows, {name} tile ({cap} x {r}):")
        gathers[name] = kernel_row(
            "gather_rows", "src/repro_torch/kernels/csrc/gather_rows.cu",
            "src/repro/kernels/gather.py:63", err, timed, plain, nbytes,
            lib_ms)
    rows.append(gathers["nbr"])
    info["gather_rows_adj"] = gathers["adj"]

    # -- canonical_check_tiles: the chunk's flat candidate batch -----------
    view = explore.build_tile_view(pg, members, n_valid, "vertex",
                                   use_pallas=True, compact_kernel=True)
    plain_view = explore.build_tile_view(pg, members, n_valid, "vertex")
    torch.cuda.synchronize()
    need(max_abs_err(torch, tuple(view), tuple(plain_view)) == 0,
         "the tile view built through the kernels differs from the plain one")
    del plain_view
    mrow, row_ok = explore.member_tile_rows(view, members, n_valid)
    cand, _ = expand_masks(members, n_valid, view.nbr_t, view.adj_t,
                           rows=mrow, row_ok=row_ok)
    flat_rows = torch.arange(c, dtype=torch.int32,
                             device=dev).repeat_interleave(k * d)
    args = (members[flat_rows], mrow[flat_rows], n_valid[flat_rows],
            cand.reshape(-1), view.adj_t)
    b = args[3].shape[0]
    got = (canonical_check_tiles_cuda(*args),)
    want = (canonical_check_tiles_ref(*args),)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    need(err == 0, f"canonical_check_tiles differs from its plain version "
         f"({err})")
    del got, want
    timed = time_call(torch, lambda: canonical_check_tiles_cuda(*args),
                      device=True)
    plain = time_ms(torch, lambda: canonical_check_tiles_ref(*args), **PLAIN)
    nbytes = b * (2 * k * 4 + 4 + 4 + 1) + view.adj_t.numel() * 4
    log(f"  canonical_check_tiles: {b} candidates, tile "
        f"{tuple(view.adj_t.shape)}")
    rows.append(kernel_row(
        "canonical_check_tiles",
        "src/repro_torch/kernels/csrc/canonical_check_tiles.cu",
        "src/repro/kernels/canonical_check/canonical_check.py:155",
        err, timed, plain, nbytes, None))
    info["tiles_batch"] = b
    return rows, info, pg


def refine_ops(nv: int) -> int:
    """int32 operations of one (row, permutation) of the refine: 4 per
    adjacency bit, 4 per label, 3 for the compare."""
    return 4 * nv * (nv - 1) // 2 + 4 * nv + 3


def refine_synthetic_codes(np) -> dict:
    """Seeded quick codes of every nv from 2 to 8 (labels included),
    ``REFINE_ROWS`` a nv (two thirds of it at nv 8), as numpy arrays."""
    from repro_torch.core import canon_math

    rng = np.random.default_rng(12)
    out = {}
    for nv in range(2, 9):
        n = REFINE_ROWS if nv < 8 else REFINE_ROWS * 2 // 3
        upper = np.triu(rng.random((n, nv, nv)) < 0.5, 1)
        labels = rng.integers(0, 29, (n, nv))
        out[nv] = np.array([canon_math.encode(nv, upper[i] | upper[i].T,
                                              labels[i]) for i in range(n)],
                           dtype=np.int64)
    return out


def refine_synthetic_time(torch, c, v, nv) -> dict:
    """:func:`time_call` of one refine launch over the seeded codes of one
    nv, with the profiler's device time where the call is host-bound (the
    launches of small nv take microseconds)."""
    from repro_torch.kernels import canonical_refine

    return time_call(torch, lambda: canonical_refine.refine_cuda(
        c, v, (nv,)), 5, 3, device=True)


def refine_synthetic_checks(torch, np, dev):
    """canonical_refine against its plain version on seeded quick codes of
    every nv from 2 to 8 (labels included), orbits off and on, one launch
    per nv and one for the whole mixed batch."""
    from repro_torch.kernels import canonical_refine

    parts, info = [], {}
    for nv, codes in refine_synthetic_codes(np).items():
        n = codes.shape[0]
        parts.append(codes)
        c = torch.from_numpy(codes).to(dev)
        v = torch.ones(n, dtype=torch.bool, device=dev)
        errs = []
        for orbits in (False, True):
            got = canonical_refine.refine_cuda(c, v, (nv,), with_orbits=orbits)
            want = canonical_refine.refine_codes_ref(c, v, (nv,),
                                                     with_orbits=orbits)
            torch.cuda.synchronize()
            errs.append(max_abs_err(torch, got, want))
        need(max(errs) == 0, f"canonical_refine differs from its plain "
             f"version at nv={nv} ({errs})")
        timed = refine_synthetic_time(torch, c, v, nv)
        ms = timed["ms"]
        plain = time_ms(torch, lambda: canonical_refine.refine_codes_ref(
            c, v, (nv,)), **PLAIN)
        ops = n * math.factorial(nv) * refine_ops(nv)
        info[nv] = {"rows": n, "ms": ms, "device_ms": timed["device_ms"],
                    "plain_ms": plain, "ops": ops,
                    "bound_ms": ops / INT32_OPS_PER_S * 1e3}
        log(f"  canonical_refine nv={nv}: {n} rows, max_abs_err=0 (orbits "
            f"off, on), ms={ms:.4f} (profiler device {timed['device_ms']}) "
            f"plain_ms={plain:.4f} ops bound {info[nv]['bound_ms']:.4f} ms")
    mixed = torch.from_numpy(np.concatenate(parts)).to(dev)
    v = torch.rand(mixed.shape[0], device=dev) < 0.95
    for orbits in (False, True):
        got = canonical_refine.refine_cuda(mixed, v, tuple(range(2, 9)),
                                           with_orbits=orbits)
        want = canonical_refine.refine_codes_ref(mixed, v, tuple(range(2, 9)),
                                                 with_orbits=orbits)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        need(err == 0, f"canonical_refine differs on the mixed batch ({err})")
    log("  canonical_refine: mixed nv 2-8 batch with invalid rows, orbits "
        "off and on: max_abs_err=0")
    return info


def refine_bytes(q: int, nv: int) -> int:
    """Bytes the refine must move: codes and valid read, canon, sigma and
    rep written (113 B a row), and the nv's permutation table read."""
    return q * (24 + 1 + 24 + 32 + 32) + math.factorial(nv) * 32


def refine_main_table(torch, table):
    """The refine row, at the distinct table level 2 refined in step 3 of
    the force_device main path run; then where that step's ``t_canon``
    goes: the whole device level-2 program (refine + weighted re-bin) on
    the card, and the host's memo seeding of the same Q rows."""
    from repro_torch.core import aggregation, pattern
    from repro_torch.kernels import canonical_refine

    u, c, uv, cap, nvs = table
    got = canonical_refine.refine_cuda(u, uv, nvs)
    want = canonical_refine.refine_codes_ref(u, uv, nvs)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    need(err == 0, f"canonical_refine differs from its plain version on the "
         f"main path's table ({err})")
    timed = time_call(torch, lambda: canonical_refine.refine_cuda(
        u, uv, nvs), device=True)
    plain = time_ms(torch, lambda: canonical_refine.refine_codes_ref(
        u, uv, nvs), **PLAIN)
    q, live = u.shape[0], int(uv.sum())
    nv = nvs[0]
    nbytes = refine_bytes(q, nv)
    ops = live * math.factorial(nv) * refine_ops(nv)
    log(f"  canonical_refine on the step-3 table: {q} rows, {live} valid, "
        f"nv {nv}")
    row = kernel_row(
        "canonical_refine", "src/repro_torch/kernels/csrc/canonical_refine.cu",
        "src/repro/kernels/canonical_refine.py:266", err, timed, plain, nbytes,
        None, ops)
    program_ms = time_ms(torch, lambda: aggregation._level2_program(
        u, c, uv, cap, nvs, False, True, "radix"), 3, 3)
    quick = u[:live].cpu().numpy()
    canon, sigma, _ = (t[:live].cpu().numpy() for t in got)
    pattern.clear_memo()
    t0 = time.perf_counter()
    pattern.seed_memo(quick, canon, sigma)
    seed_s = time.perf_counter() - t0
    pattern.clear_memo()
    log(f"  step-3 device level 2: program {program_ms:.3f} ms on the card, "
        f"host memo seeding of {live} rows {seed_s:.4f} s")
    return row, {"rows": q, "valid": live, "program_ms": program_ms,
                 "seed_memo_s": seed_s}


def chunk_program_is_sync_free(torch, dg, pg, members, n_valid):
    """One chunk program per route under sync debug mode "error": any
    hidden host sync in expansion, filter, compaction or the partial bin
    (sort bin; radix bin through its kernels and through the fused-key
    route) raises; on the partitioned layout ``pg`` also in the halo
    gather, the tile view's rank translation and the tile check."""
    from repro_torch.core import explore
    from repro_torch.core.apps import CliquesApp, MotifsApp

    motifs, cliques = MotifsApp(max_size=3), CliquesApp(max_size=4)
    for graph, app, fused, agg_bin, agg_kernel in (
            (dg, motifs, False, "sort", True), (dg, motifs, True, "sort", True),
            (dg, cliques, False, "sort", True),
            (dg, motifs, False, "radix", True),
            (dg, motifs, True, "radix", True),
            (dg, motifs, False, "radix", False),
            (pg, motifs, False, "sort", True), (pg, motifs, True, "sort", True),
            (pg, cliques, False, "sort", True)):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            explore.fused_chunk_step(
                graph, members, n_valid, 1 << 22, mode="vertex", app=app,
                with_aggregates=app.wants_patterns, agg_qcap=AGG_QCAP,
                with_local_verts=False, use_pallas=True, fused=fused,
                compact_kernel=True, aggregate_kernel=agg_kernel,
                aggregate_bin=agg_bin,
            )
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def chunk_program_times(torch, dg, pg, members, n_valid, calls=3):
    """Milliseconds of one chunk program (the first size-2 chunk, default
    knobs: kernels on, unfused, sort bin) on the whole graph and on the
    partitioned layout, for motifs and cliques, and of the partitioned
    program's tile-gather stage alone: where the partitioned path's extra
    expansion time goes."""
    from repro_torch.core import explore
    from repro_torch.core.apps import CliquesApp, MotifsApp

    def program(graph, app):
        return lambda: explore.fused_chunk_step(
            graph, members, n_valid, 1 << 23, mode="vertex", app=app,
            with_aggregates=app.wants_patterns, agg_qcap=AGG_QCAP,
            with_local_verts=False, use_pallas=True, compact_kernel=True,
            aggregate_kernel=True)

    out = {}
    for app in (MotifsApp(max_size=3), CliquesApp(max_size=4)):
        for layout, graph in (("whole", dg), ("partitioned", pg)):
            out[f"{type(app).__name__}_{layout}"] = time_ms(
                torch, program(graph, app), calls, 3)
    out["build_tile_view"] = time_ms(torch, lambda: explore.build_tile_view(
        pg, members, n_valid, "vertex", use_pallas=True,
        compact_kernel=True), calls, 3)
    log("  one chunk program, ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out.items()))
    return out


INT_FIELDS = ("step", "size", "n_frontier", "n_generated", "n_canonical",
              "n_children", "n_quick_patterns", "n_canonical_patterns",
              "n_iso_checks", "n_chunks", "n_host_syncs", "frontier_bytes",
              "odag_bytes", "bytes_to_host")


def step_counters(res):
    return [{f: getattr(s, f) for f in INT_FIELDS} for s in res.stats.steps]


def card_vs_cpu(torch, run, make_graph, cases):
    """Phases 4 and 7a: identical results from the card and the CPU port
    on ``make_graph(scale)`` (patterns with their counts or supports,
    embeddings per size, per-step counters)."""
    out = {}
    for name, scale, app, cfg in cases:
        g = make_graph(scale)
        cpu = run(g, app, cfg, device="cpu")
        gpu = run(g, app, cfg)
        need(cpu.patterns == gpu.patterns, f"{name}: patterns differ")
        need({k: len(v) for k, v in cpu.embeddings.items()}
             == {k: len(v) for k, v in gpu.embeddings.items()},
             f"{name}: embedding counts differ")
        need(step_counters(cpu) == step_counters(gpu),
             f"{name}: step counters differ:\n{step_counters(cpu)}\n"
             f"{step_counters(gpu)}")
        by_nv = {}
        for code in gpu.patterns:
            by_nv[code[0] & 0xF] = by_nv.get(code[0] & 0xF, 0) + 1
        out[name] = {"patterns": len(gpu.patterns), "patterns_by_nv": by_nv,
                     "steps": step_counters(gpu)}
        log(f"  {name}: {len(gpu.patterns)} patterns, "
            f"{[s.n_children for s in gpu.stats.steps]} children per step, "
            "identical")
    return out


class Level2Tables:
    """Records each device level 2 of a run (``_level2_program``): its nv
    set and whether the orbit pass ran, the distinct table the last one
    refined (its inputs) and the canonical table it produced (its
    outputs). These are references, which nothing writes after the call:
    no copy adds to the run's time or peak memory, and the refine can be
    timed on the main path's own tables after the run."""

    def __init__(self, aggregation):
        self.agg = aggregation
        self.orig = aggregation._level2_program
        self.calls, self.last, self.canon = [], None, None

    def __enter__(self):
        def spy(u, c, uv, cap, nvs, with_orbits, *rest):
            out = self.orig(u, c, uv, cap, nvs, with_orbits, *rest)
            self.calls.append({"nvs": tuple(nvs), "rows": int(cap),
                               "orbits": bool(with_orbits)
                               and out[-1] is not None,
                               "device": u.device.type})
            self.last = (u, c, uv, cap, nvs)
            self.canon = (out[2], out[5], cap, tuple(nvs))
            return out

        self.agg._level2_program = spy
        return self

    def __exit__(self, *exc):
        self.agg._level2_program = self.orig


STEP_FIELDS = {"frontier": "n_frontier", "children": "n_children",
               "n_chunks": "n_chunks", "n_host_syncs": "n_host_syncs",
               "quick_patterns": "n_quick_patterns",
               "canonical_patterns": "n_canonical_patterns",
               "bytes_to_host": "bytes_to_host", "t_expand": "t_expand",
               "t_aggregate": "t_aggregate", "t_canon": "t_canon",
               "t_storage": "t_storage"}


def counted_run(torch, run, build, totals, label, g, app, cfg, clock=None,
                more=None):
    """Phases 5 and 7b-c: one run through ``repro_torch.core.run`` with its
    kernels counted (the counts zeroed just before the run, read just
    after and added to ``totals``), its wall, its peak device bytes and its
    steps; every step's host syncs within the window rule (the pilot, then
    one stacked drain per window of chunks). ``clock`` (a
    :class:`HostClock`) is entered around the run, and ``more(step)`` adds
    fields to each step's record. Returns the record, the result and the
    :class:`Level2Tables` spy."""
    from repro_torch.core import aggregation
    from repro_torch.core.runtime.serial import _DRAIN_WINDOW

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with Level2Tables(aggregation) as spy, WaveLog() as waves, \
            clock or contextlib.nullcontext():
        build.reset_launches()
        t0 = time.perf_counter()
        res = run(g, app, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    for name, v in launches.items():
        totals[name] += v
    peak = torch.cuda.max_memory_allocated()
    steps = []
    for s, n_waves in zip(res.stats.steps, waves.per_step("cuda")):
        # each wave of a spilled step pilots and drains on its own
        bound = 2 * n_waves - 1 + math.ceil(s.n_chunks / _DRAIN_WINDOW)
        need(s.n_host_syncs <= (bound if s.n_chunks else 0),
             f"{label} step {s.step}: {s.n_host_syncs} host syncs for "
             f"{s.n_chunks} chunks in {n_waves} waves")
        step = {"step": s.step, "waves": n_waves}
        step.update({k: getattr(s, f) for k, f in STEP_FIELDS.items()})
        step.update(more(s) if more else {})
        steps.append(step)
    rec = {"run": label, "wall_s": wall, "peak_bytes": peak,
           "launches": launches, "steps": steps,
           "patterns": len(res.patterns),
           "chunk_signatures": len(res.stats.chunk_signatures),
           "cost_model": res.stats.cost_model, "level2": spy.calls}
    log(f"  {label}: wall {wall:.3f} s, peak {peak / 2**30:.2f} GiB, "
        f"{len(res.patterns)} patterns, launches {launches}")
    for step in steps:
        log(f"    step {step['step']}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in step.items() if k != "step"))
    return rec, res, spy


def main_path(torch, np, run, RunConfig, G, build, apps):
    """Phase 5: the main path on mico_like(0.1), kernels counted."""
    g = G.mico_like(0.1)
    deg = g.degrees().astype(np.int64)
    wedges = int((deg * (deg - 1) // 2).sum())
    totals = {name: 0 for name in build.LAUNCHES}
    runs, results = [], {}
    level2_table = None
    for label, app, cfg in apps:
        rec, results[label], spy = counted_run(torch, run, build, totals,
                                               label, g, app, cfg)
        runs.append(rec)
        if spy.last is not None:
            level2_table = spy.last

    mot, fused, cli, fdev, pmot, pcli = (
        results["motifs_unfused"], results["motifs_fused"],
        results["cliques"], results["motifs_force_device"],
        results["motifs_partitioned"], results["cliques_partitioned"])
    need(mot.patterns == fused.patterns, "fused and unfused motifs differ")
    # the partitioned layout: the same results and the same host syncs as
    # the whole-graph runs, through the halo gather and the tile check
    need(pmot.patterns == mot.patterns,
         "partitioned motifs differ from the whole-graph motifs")
    need(sorted(pcli.embeddings) == sorted(cli.embeddings),
         "partitioned cliques have other sizes")
    for size, emb in cli.embeddings.items():
        pe = pcli.embeddings[size]
        need(pe.shape == emb.shape and np.array_equal(
            np.unique(pe, axis=0), np.unique(emb, axis=0)),
            f"partitioned size-{size} cliques differ as sets")
    for whole, part, label in ((mot, pmot, "motifs"), (cli, pcli, "cliques")):
        need([(s.n_chunks, s.n_host_syncs, s.n_children)
              for s in whole.stats.steps]
             == [(s.n_chunks, s.n_host_syncs, s.n_children)
                 for s in part.stats.steps],
             f"partitioned {label}: chunks, syncs or children per step differ")
    for rec in runs:
        if rec["run"].endswith("_partitioned"):
            for name in ("gather_rows", "canonical_check_tiles"):
                need(rec["launches"][name] > 0,
                     f"{name} never launched in {rec['run']}")
    need(fdev.patterns == mot.patterns,
         "force_device motifs differ from the host-placed motifs")
    fd = next(r for r in runs if r["run"] == "motifs_force_device")
    need(fd["cost_model"]["aggregate_bin"] == "radix"
         and fd["cost_model"]["canonical_placement"] == "device",
         f"force_device did not pick the radix bin and device level 2: "
         f"{fd['cost_model']}")
    for name in ("radix_hist", "radix_scatter", "canonical_refine"):
        need(fd["launches"][name] > 0,
             f"{name} never launched in the force_device run")
    need(level2_table is not None and level2_table[4] == (3,),
         "no size-3 level-2 table was refined on the device")
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
    return totals, runs, level2_table, {"motifs": mot, "cliques": cli}


# ---------------------------------------------------------------------------
# Phase 7: frequent subgraph mining (edge mode, min-image domains)
# ---------------------------------------------------------------------------

class HostClock:
    """Adds up the wall seconds of calls to the named attributes of their
    owners while it is entered (the FSM runs' domain scatter, which ends in
    the bitmap's one device-to-host copy, and the host's min-image
    support)."""

    def __init__(self, **targets):
        self.targets = targets          # label -> (owner, attribute name)
        self.seconds = {label: 0.0 for label in targets}

    def __enter__(self):
        self.orig = {}
        for label, (owner, attr) in self.targets.items():
            fn = getattr(owner, attr)
            self.orig[label] = fn

            def timed(*a, _fn=fn, _label=label, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    self.seconds[_label] += time.perf_counter() - t0

            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for label, (owner, attr) in self.targets.items():
            setattr(owner, attr, self.orig[label])


def single_edge_supports(np, g, support: int) -> dict:
    """The repo's own check of a step-1 FSM result, straight from the edge
    list: the min-image support of each single-edge pattern (labels a, b)
    is the smaller of the distinct a-endpoints and b-endpoints of its
    edges, or, where a == b (the two positions are one orbit), the
    distinct endpoints. Canonical code -> support, frequent ones only."""
    from repro_torch.core import canon_math

    la, lb = g.labels[g.edges[:, 0]], g.labels[g.edges[:, 1]]
    lo, hi = np.minimum(la, lb), np.maximum(la, lb)
    out = {}
    for a, b in sorted(set(zip(lo.tolist(), hi.tolist()))):
        sel = g.edges[(lo == a) & (hi == b)]
        ends = np.concatenate([sel[:, 0], sel[:, 1]])
        if a == b:
            sup = len(np.unique(ends))
        else:
            lab = g.labels[ends]
            sup = min(len(np.unique(ends[lab == a])),
                      len(np.unique(ends[lab == b])))
        if sup >= support:
            adj = np.array([[0, 1], [1, 0]], dtype=bool)
            code, _ = canon_math.canonicalize_one(
                canon_math.encode(2, adj, np.array([a, b])))
            out[tuple(int(x) for x in code)] = sup
    return out


def fsm_chunk_is_sync_free(torch, np, G):
    """One FSM chunk program per route under sync debug mode "error": the
    edge expansion, the edge check, the compaction and the children's edge
    quick codes with the local-vertex table, on the whole graph and on the
    partitioned layout (the halo of member-edge endpoints and the
    incident-edge gather)."""
    from repro_torch.core import explore
    from repro_torch.core.apps import FSMApp

    g = G.citeseer_like(1.0)
    dg, pg = G.to_device(g), G.to_partitioned(g, PARTS)
    rows = min(CHUNK, g.m)           # the first size-1 chunk: edges 0..
    members = torch.arange(rows, dtype=torch.int32, device=dg.device)[:, None]
    n_valid = torch.ones(rows, dtype=torch.int32, device=dg.device)
    app = FSMApp(**FSM_MAIN_APP)
    for graph in (dg, pg):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            explore.fused_chunk_step(
                graph, members, n_valid, 1 << 16, mode="edge", app=app,
                with_patterns=True, with_local_verts=True, use_pallas=True,
                compact_kernel=True, aggregate_kernel=True,
            )
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def fsm_refine_orbits(torch, np, table) -> dict:
    """The refine with orbits on the canonical table of the last device
    level 2 (step 4 of the 4-edge force_device run): the kernel against
    its plain version (exact), the orbit representatives against the
    host's ``automorphism_orbits`` on every live row, and both timed."""
    from repro_torch.core import canon_math
    from repro_torch.kernels import canonical_refine

    cu, cn, cap, nvs = table
    live = int(cn)
    cuv = torch.arange(cu.shape[0], device=cu.device) < live

    def plain():
        # permutation tiles of 8: the default tile of 1,024 holds all 120
        # permutations of nv 5 at once, (rows, 120) int64 a word
        return canonical_refine.refine_codes_ref(cu, cuv, nvs,
                                                 with_orbits=True, tile=8)

    got = canonical_refine.refine_cuda(cu, cuv, nvs, with_orbits=True)
    want = plain()
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    need(err == 0, f"canonical_refine with orbits differs from its plain "
         f"version on the FSM table ({err})")
    codes = cu[:live].cpu().numpy()
    host = np.stack([canon_math.automorphism_orbits(c) for c in codes])
    need(np.array_equal(got[2][:live].cpu().numpy(), host),
         "refine orbits differ from automorphism_orbits on the FSM table")
    need((got[0][:live] == cu[:live]).all().item(),
         "the refine moved a canonical code of the FSM table")
    timed = time_call(torch, lambda: canonical_refine.refine_cuda(
        cu, cuv, nvs, with_orbits=True), device=True)
    del want
    plain_ms = time_ms(torch, plain, **PLAIN)
    row_nv = codes[:, 0] & 0xF
    ops = sum(int((row_nv == nv).sum()) * math.factorial(nv) * refine_ops(nv)
              for nv in nvs)
    nbytes = cu.shape[0] * (24 + 1 + 24 + 32 + 32) + sum(
        math.factorial(nv) * 32 for nv in nvs)
    bound = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
    by_nv = {int(nv): int((row_nv == nv).sum()) for nv in nvs}
    log(f"  canonical_refine with orbits on the step-4 FSM table: "
        f"{cu.shape[0]} rows, {live} live (by nv {by_nv}), max_abs_err=0, "
        f"orbits == automorphism_orbits; ms={timed['ms']:.4f} (profiler "
        f"device {timed['device_ms']}) plain_ms={plain_ms:.4f} "
        f"bound_ms={bound:.4f}")
    return {"rows": int(cu.shape[0]), "live": live, "by_nv": by_nv,
            "ms": timed["ms"], "device_ms": timed["device_ms"],
            "host_bound": timed["host_bound"], "plain_ms": plain_ms,
            "bytes": nbytes, "ops": ops, "bound_ms": bound}


def fsm_runs(torch, np, run, build, cases):
    """Phases 7b-c: FSM runs, each a :func:`counted_run` with the domain
    bitmap's bytes per step and the host seconds of the domain scatter
    and the min-image support."""
    from repro_torch.core import aggregation
    from repro_torch.core.runtime.config import next_pow2
    from repro_torch.core.runtime.serial import SerialBackend

    totals = {name: 0 for name in build.LAUNCHES}
    runs, results, table = [], {}, None
    for label, g, app, cfg in cases:
        clock = HostClock(
            scatter_domains=(SerialBackend, "_scatter_domains"),
            min_image_support=(aggregation, "min_image_support"))

        def domains(s, n=g.n):
            # the (Pc, 8, N) bitmap that crosses, and the flat device
            # accumulator it is cut from (pc_cap * 8 * N + 1 bools)
            pc = s.n_canonical_patterns
            return {"domain_bytes": pc * 8 * n,
                    "domain_device_bytes": (next_pow2(pc) * 8 * n + 1
                                            if pc else 0)}

        rec, res, spy = counted_run(torch, run, build, totals, label, g, app,
                                    cfg, clock=clock, more=domains)
        launches = rec["launches"]
        by_size = {}
        for code in res.patterns:
            by_size[code[0] & 0xF] = by_size.get(code[0] & 0xF, 0) + 1
        rec.update(n=g.n, m=g.m, host_s=clock.seconds,
                   patterns_by_size=by_size)
        runs.append(rec)
        results[label] = res
        if spy.canon is not None:
            table = spy.canon
        need(launches["stream_compact"] > 0 and launches["seg_unique"] > 0,
             f"{label}: stream_compact or seg_unique never launched "
             f"({launches})")
        log(f"    domain scatter and copy "
            f"{clock.seconds['scatter_domains']:.3f} s, min-image support "
            f"{clock.seconds['min_image_support']:.3f} s")
        if rec["cost_model"]["canonical_placement"] == "device":
            need(spy.calls and all(c["orbits"] for c in spy.calls),
                 f"{label}: the device level 2 ran without its orbit pass "
                 f"({spy.calls})")
            need(launches["canonical_refine"] == 2 * len(spy.calls),
                 f"{label}: {launches['canonical_refine']} refine launches "
                 f"for {len(spy.calls)} device level-2 passes with orbits")
            need(launches["radix_hist"] > 0 and launches["radix_scatter"] > 0,
                 f"{label}: the radix bin never launched")
        # the repo's own check: the frequent single-edge patterns and their
        # supports, counted from the edge list
        want = single_edge_supports(np, g, app.support)
        got = {c: v for c, v in res.patterns.items() if c[0] & 0xF == 2
               and (c[0] >> 4) == 1}
        need(got == want, f"{label}: single-edge supports differ from the "
             f"edge list's ({len(got)} vs {len(want)} patterns)")
        need(all(v >= app.support for v in res.patterns.values()),
             f"{label}: a recorded pattern is below the support")
    return totals, runs, results, table


def fsm_phase(torch, np, run, RunConfig, G, build):
    """Phase 7: FSM on the card. 7a the card port against the CPU port
    (to 4 edges under force_device after 7b-c);
    7b the main path at the paper's FSM graph, citeseer_like(1.0) to 3
    edges (also partitioned) and citeseer_like(0.3) to 4 edges, each under
    the default config and force_device (device level 2 with its orbit
    pass, the radix bin);
    7c the domain stress on mico_like(0.1) at size 2."""
    from repro_torch.core.apps import FSMApp

    log(f"[7a] FSM: card port vs CPU port on citeseer_like({FSM_SMALL})")
    small = card_vs_cpu(torch, run, G.citeseer_like, [
        ("fsm", FSM_SMALL, FSMApp(**FSM_SMALL_APP), RunConfig()),
        ("fsm_force_device", FSM_SMALL, FSMApp(**FSM_SMALL_APP),
         RunConfig(cost_model="force_device")),
        ("fsm_host_level1", FSM_SMALL, FSMApp(**FSM_SMALL_APP),
         RunConfig(device_aggregate=False)),
        ("fsm_partitioned", FSM_SMALL, FSMApp(**FSM_SMALL_APP),
         RunConfig(graph_partition=PARTS)),
    ])
    fsm_chunk_is_sync_free(torch, np, G)
    log("  FSM chunk programs (whole graph and partitioned) ran under sync "
        "debug mode 'error': no host sync")
    build.reset_launches()
    log(f"[7b] FSM main path on citeseer_like(1.0), {FSM_MAIN_APP}, and "
        f"citeseer_like({FSM_DEEP}), {FSM_DEEP_APP}; [7c] domain stress on "
        f"mico_like(0.1), {FSM_STRESS_APP}")
    cite, deep = G.citeseer_like(1.0), G.citeseer_like(FSM_DEEP)
    force = RunConfig(cost_model="force_device")
    totals, runs, results, table = fsm_runs(
        torch, np, run, build, [
            ("fsm_citeseer", cite, FSMApp(**FSM_MAIN_APP), RunConfig()),
            ("fsm_citeseer_force_device", cite, FSMApp(**FSM_MAIN_APP),
             force),
            ("fsm_citeseer_partitioned", cite, FSMApp(**FSM_MAIN_APP),
             RunConfig(graph_partition=PARTS)),
            ("fsm_mico_domains", G.mico_like(0.1), FSMApp(**FSM_STRESS_APP),
             RunConfig()),
            ("fsm_citeseer4", deep, FSMApp(**FSM_DEEP_APP), RunConfig()),
            ("fsm_citeseer4_force_device", deep, FSMApp(**FSM_DEEP_APP),
             force),
        ])
    part = results["fsm_citeseer_partitioned"]
    need(part.patterns == results["fsm_citeseer"].patterns,
         "partitioned FSM differs from the whole-graph FSM")
    need(next(r for r in runs if r["run"] == "fsm_citeseer_partitioned")
         ["launches"]["gather_rows"] > 0,
         "gather_rows never launched in the partitioned FSM run")
    for label, app in (("fsm_citeseer", FSM_MAIN_APP),
                       ("fsm_citeseer4", FSM_DEEP_APP)):
        base, fdev = results[label], results[label + "_force_device"]
        need(fdev.patterns == base.patterns,
             f"{label}: force_device FSM differs from the default FSM")
        # a pattern's edges are its adjacency bits (edge-induced codes)
        by_edges = {}
        for code in base.patterns:
            e = bin(code[0] >> 4).count("1")
            by_edges[e] = by_edges.get(e, 0) + 1
        need(by_edges.get(app["max_size"], 0) > 0,
             f"{label}: no frequent pattern of {app['max_size']} edges: "
             f"{by_edges}")
        log(f"  {label}: canonical patterns per step "
            f"{[len(a.canon_codes) for a in base.aggregates]}, frequent by "
            f"edges {by_edges}; force_device identical")
    need(table is not None and table[3] == (2, 3, 4, 5),
         f"no 4-edge level-2 table was refined on the device: {table}")
    # 7a to 4 edges after 7b-c, whose host level 2 would otherwise start
    # from the canonical memo this run fills
    log(f"[7a] FSM to 4 edges: card port vs CPU port on "
        f"citeseer_like({FSM_SMALL}), {FSM_SMALL4_APP}, force_device")
    from repro_torch.core import aggregation
    with Level2Tables(aggregation) as spy:
        small.update(card_vs_cpu(torch, run, G.citeseer_like, [
            ("fsm4_force_device", FSM_SMALL, FSMApp(**FSM_SMALL4_APP),
             force)]))
    # the nv-5 orbit pass ran on the card, and its supports agree
    need(any(c["device"] == "cuda" and c["orbits"] and 5 in c["nvs"]
             for c in spy.calls) and
         small["fsm4_force_device"]["patterns_by_nv"].get(5, 0) > 0,
         f"fsm4_force_device: no nv-5 level 2 with orbits on the card "
         f"({spy.calls})")
    refine = fsm_refine_orbits(torch, np, table)
    del table
    build.reset_launches()
    torch.cuda.empty_cache()
    return totals, {"card_vs_cpu": small, "runs": runs,
                    "refine_orbits_step4": refine}, \
        results["fsm_citeseer"].patterns


def fsm_full_depth(torch) -> dict:
    """``--fsm-full-depth``: phase 8c alone, the paper's FSM graph at the
    depth 7b is cut from, under the device budget and in one wave."""
    from repro_torch.core import RunConfig, graph as G, run
    from repro_torch.kernels import build

    log(f"card: {nvidia_smi_line()}")
    totals = {name: 0 for name in build.LAUNCHES}
    return fsm_depth_runs(torch, run, RunConfig, G, build, totals)


# ---------------------------------------------------------------------------
# Phase 8: the frontier stores (ODAG, spill)
# ---------------------------------------------------------------------------

class WaveLog:
    """Records the waves the serial backend re-materialises at each step
    (``begin_step``), by the device the run's graph is on."""

    def __init__(self):
        from repro_torch.core.runtime.serial import SerialBackend
        self.cls = SerialBackend
        self.orig = SerialBackend.begin_step
        self.calls = []

    def __enter__(self):
        def spy(backend, store, st):
            waves = self.orig(backend, store, st)
            self.calls.append((backend.g.device.type, st.step, len(waves)))
            return waves

        self.cls.begin_step = spy
        return self

    def __exit__(self, *exc):
        self.cls.begin_step = self.orig

    def per_step(self, device: str) -> list:
        return [n for d, _, n in self.calls if d == device]


class ExtractLog:
    """Records each ODAG extraction (``repro_torch.core.odag.extract``, the
    store's whole and per-partition walks): its seconds (the card
    synchronised before it; it ends in its copy to the host), its
    counters, and the launches of ``canonical_check`` and
    ``stream_compact`` within it alone."""

    def __init__(self, torch, build):
        from repro_torch.core import odag
        self.torch, self.build, self.mod = torch, build, odag
        self.orig = odag.extract
        self.calls = []

    def __enter__(self):
        torch, launches = self.torch, self.build.LAUNCHES

        def spy(g, o, *a, **kw):
            stats = {}
            kw["stats"] = stats
            before = dict(launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = self.orig(g, o, *a, **kw)
            stats["seconds"] = time.perf_counter() - t0
            stats["rows"] = len(rows)
            for name in ("canonical_check", "stream_compact"):
                stats[name] = launches[name] - before[name]
            self.calls.append(stats)
            return rows

        self.mod.extract = spy
        return self

    def __exit__(self, *exc):
        self.mod.extract = self.orig

    def total(self, key):
        return sum(c[key] for c in self.calls)


def store_card_vs_cpu(torch, run, RunConfig, G):
    """Phase 8a: the ODAG and spill stores, the card port against the CPU
    port (patterns, embedding counts, every per-step counter with
    ``odag_bytes``), each run's waves per step identical too, and more
    than one wave in some step under a budget."""
    from repro_torch.core.apps import CliquesApp, FSMApp, MotifsApp

    def peak(make, scale, app):
        res = run(make(scale), app, RunConfig(), device="cpu")
        return max(s.frontier_bytes for s in res.stats.steps)

    motifs, fsm = MotifsApp(max_size=3), FSMApp(**FSM_SMALL_APP)
    budget = peak(G.mico_like, STORE_SMALL, motifs) // 8
    fsm_budget = peak(G.citeseer_like, FSM_SMALL, fsm) // 8
    log(f"[8a] stores: card port vs CPU port on mico_like({STORE_SMALL}) "
        f"(motifs budget {budget} B, an eighth of the peak frontier), "
        f"mico_like({STORE_TINY}) and citeseer_like({FSM_SMALL}) (FSM "
        f"budget {fsm_budget} B)")
    cases = [
        ("motifs4_odag", G.mico_like, STORE_TINY, MotifsApp(max_size=4),
         RunConfig(store="odag")),
        ("motifs_odag", G.mico_like, STORE_SMALL, motifs,
         RunConfig(store="odag")),
        ("cliques_odag", G.mico_like, STORE_SMALL, CliquesApp(max_size=4),
         RunConfig(store="odag")),
        ("motifs_spill_raw", G.mico_like, STORE_SMALL, motifs,
         RunConfig(device_budget_bytes=budget)),
        ("motifs_spill_odag", G.mico_like, STORE_SMALL, motifs,
         RunConfig(store="odag", device_budget_bytes=budget)),
        ("fsm_odag", G.citeseer_like, FSM_SMALL, fsm,
         RunConfig(store="odag")),
        ("fsm_spill_odag", G.citeseer_like, FSM_SMALL, fsm,
         RunConfig(store="odag", device_budget_bytes=fsm_budget)),
    ]
    out = {}
    for name, make, scale, app, cfg in cases:
        with WaveLog() as waves:
            out.update(card_vs_cpu(torch, run, make,
                                   [(name, scale, app, cfg)]))
        gpu, cpu = waves.per_step("cuda"), waves.per_step("cpu")
        need(gpu == cpu, f"{name}: waves per step differ: {cpu} vs {gpu}")
        out[name]["waves"] = gpu
        if cfg.device_budget_bytes is not None:
            need(max(gpu) > 1, f"{name}: one wave a step under the budget")
        odag = [s["odag_bytes"] for s in out[name]["steps"]]
        if cfg.store == "odag":
            need(max(odag) > 0, f"{name}: no ODAG bytes recorded")
        log(f"    waves per step {gpu}; frontier bytes "
            f"{[s['frontier_bytes'] for s in out[name]['steps']]}, ODAG "
            f"bytes {odag}")
    return out


def store_main_path(torch, np, run, RunConfig, G, build, raw):
    """Phase 8b: motifs and cliques on mico_like(0.1) under the ODAG store,
    kernels counted, each equal to phase 5's raw-store run; per step the
    raw and ODAG bytes (Fig. 9's ratio) and the storage seconds, per
    extraction its seconds, pairs, host syncs and kernel launches."""
    from repro_torch.core.apps import CliquesApp, MotifsApp

    log("[8b] main path under store='odag' on mico_like(0.1)")
    g = G.mico_like(0.1)
    totals = {name: 0 for name in build.LAUNCHES}
    runs = []

    def fig9(s):
        return {"frontier_bytes": s.frontier_bytes,
                "odag_bytes": s.odag_bytes,
                "compression": (s.frontier_bytes / s.odag_bytes
                                if s.odag_bytes else None)}

    for label, app, base in (
        ("motifs_odag", MotifsApp(max_size=3), raw["motifs"]),
        ("cliques_odag", CliquesApp(max_size=4), raw["cliques"]),
    ):
        with ExtractLog(torch, build) as ex:
            rec, res, _ = counted_run(torch, run, build, totals, label, g,
                                      app, RunConfig(store="odag"),
                                      more=fig9)
        need(res.patterns == base.patterns,
             f"{label}: patterns differ from phase 5's raw-store run")
        need(sorted(res.embeddings) == sorted(base.embeddings),
             f"{label}: embedding sizes differ from the raw-store run")
        for size, emb in base.embeddings.items():
            got = res.embeddings[size]
            need(got.shape == emb.shape and np.array_equal(
                np.unique(got, axis=0), np.unique(emb, axis=0)),
                f"{label}: size-{size} embeddings differ as sets")
        need([s.n_frontier for s in res.stats.steps]
             == [s.n_frontier for s in base.stats.steps],
             f"{label}: frontier rows per step differ from the raw store")
        need(ex.calls and ex.total("canonical_check") > 0,
             f"{label}: canonical_check never launched in extraction")
        need(all(c["host_syncs"] == c["chunks"] + 1 for c in ex.calls),
             f"{label}: an extraction took more than one host sync a level "
             f"and chunk: {ex.calls}")
        rec["extract"] = ex.calls
        runs.append(rec)
        for c in ex.calls:
            log(f"    extraction: {c['rows']} rows in {c['seconds']:.3f} s, "
                f"{c['levels']} levels, {c['chunks']} chunks, {c['pairs']} "
                f"pairs, {c['kept']} kept, {c['host_syncs']} host syncs, "
                f"canonical_check {c['canonical_check']} and stream_compact "
                f"{c['stream_compact']} launches")
    return totals, runs


def fsm_depth_runs(torch, run, RunConfig, G, build, totals, fewer_edges=None):
    """Phase 8c (and ``--fsm-full-depth``): the paper's FSM graph at its
    depth, ``citeseer_like(1.0)``, support 25, to 4 edges, under
    ``device_budget_bytes = FSM_DEPTH_BUDGET`` (waves per step logged),
    then without a budget, in one wave a step: a frequent pattern of 4
    edges, every support at or above 25, the same patterns in both runs
    and, given ``fewer_edges`` (7b's patterns to 3 edges), the same
    patterns of up to 3 edges. A run that runs the card out of memory is
    logged with the failed allocation, where it was made and the peak,
    and fails the phase."""
    from repro_torch.core.apps import FSMApp

    app = FSMApp(**dict(FSM_MAIN_APP, max_size=4))
    g = G.citeseer_like(1.0)
    cases = [("fsm_citeseer_4edges_budget",
              RunConfig(device_budget_bytes=FSM_DEPTH_BUDGET)),
             ("fsm_citeseer_4edges", RunConfig())]
    out, results = {}, {}
    for label, cfg in cases:
        oom = None
        try:
            out[label], results[label], _ = counted_run(
                torch, run, build, totals, label, g, app, cfg)
        except torch.OutOfMemoryError as e:
            # the port's innermost frames: where the failed allocation was
            frames = [f"{Path(f.filename).name}:{f.lineno} {f.name}"
                      for f in traceback.extract_tb(e.__traceback__)
                      if "repro_torch" in f.filename][-3:]
            oom = {"error": str(e).split(". GPU")[0], "at": frames}
        if oom is not None:
            oom["peak_bytes"] = torch.cuda.max_memory_allocated()
            log(f"  {label}: out of device memory (peak allocated "
                f"{oom['peak_bytes']} bytes): {oom['error']}, at "
                f"{' <- '.join(reversed(oom['at']))}")
            out[label] = {"oom": oom}
            torch.cuda.empty_cache()
    need(len(results) == 2, f"FSM to 4 edges ran out of device memory: "
         f"{ {k: r['oom'] for k, r in out.items() if 'oom' in r} }")
    base = results["fsm_citeseer_4edges_budget"]
    by_edges = {}
    for code in base.patterns:
        e = bin(code[0] >> 4).count("1")
        by_edges[e] = by_edges.get(e, 0) + 1
    need(by_edges.get(4, 0) > 0, f"FSM to 4 edges: no frequent pattern of "
         f"4 edges: {by_edges}")
    need(all(v >= app.support for v in base.patterns.values()),
         "FSM to 4 edges: a recorded pattern is below the support")
    if fewer_edges is not None:
        need({c: v for c, v in base.patterns.items()
              if bin(c[0] >> 4).count("1") <= 3} == fewer_edges,
             "FSM to 4 edges: its patterns of up to 3 edges differ from "
             "7b's run to 3 edges")
    log(f"  FSM to 4 edges under the budget: frequent by edges {by_edges}"
        + ("; up to 3 edges equal to 7b's" if fewer_edges is not None
           else ""))
    need(results["fsm_citeseer_4edges"].patterns == base.patterns,
         "FSM to 4 edges: the budgeted and the one-wave runs differ")
    log("  the one-wave run: identical patterns")
    return out


# ---------------------------------------------------------------------------
# Phase 6: the model zoo's dense decoder (qwen2.5-14b)
# ---------------------------------------------------------------------------

def causal_pairs(sq, sk):
    """(query, key) pairs the start-aligned causal mask keeps."""
    return sum(min(i + 1, sk) for i in range(sq))


def model_kernel_checks(torch):
    """6a: RMSNorm and flash attention against their plain versions at the
    model's shapes, bf16 and f32, each timed beside its plain version, its
    bound and the library call of the same function (which the port never
    calls). Returns the two rows of the kernels line (bf16, the main path's
    shapes) and every case's record."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda, flash_attention_ref)
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda, rmsnorm_ref
    from repro_torch.configs.registry import get_arch

    F = torch.nn.functional
    torch.backends.cuda.matmul.allow_tf32 = False      # f32 means f32
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch(MODEL)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    rows, cases = {}, []
    d = cfg.d_model
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.finfo(dtype).bits // 8
        other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
        for r, what in ((FWD_B * FWD_S, "forward"), (SERVE_B, "decode step")):
            x = torch.randn((r, d), generator=gen, device=dev).to(dtype)
            scale32 = 1 + 0.1 * torch.randn((d,), generator=gen, device=dev)
            # a scale of the other kernel type first: checked, not timed
            for sdtype in (other, dtype):
                scale = scale32.to(sdtype)
                got = rmsnorm_cuda(x, scale, cfg.norm_eps)
                want = rmsnorm_ref(x, scale, cfg.norm_eps)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                # both round once from f32: f32 to 1e-5, bf16 one step (2^-7)
                lim = (1e-6 + 1e-5 * want.float().abs()
                       if dtype == torch.float32
                       else 2**-7 * want.float().abs())
                need(bool((diff <= lim).all()), f"rmsnorm {dtype} ({r}, {d}) "
                     f"with a {sdtype} scale differs from its plain version "
                     f"by {float(diff.max())}")
                if sdtype == other:
                    log(f"  rmsnorm {dtype} ({r}, {d}) with a {other} "
                        f"scale: max_abs_err {float(diff.max())}")
            timed = time_call(torch, lambda: rmsnorm_cuda(
                x, scale, cfg.norm_eps), device=True)
            plain = time_ms(torch, lambda: rmsnorm_ref(x, scale, cfg.norm_eps))
            lib = time_call(torch, lambda: F.rms_norm(x, (d,), scale,
                                                      cfg.norm_eps),
                            device=True)
            row = kernel_row(
                "rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/rmsnorm.py:23", float(diff.max()),
                timed, plain, (2 * r * d + d) * es, lib["ms"], ops=4 * r * d,
                op_rate=F32_FLOPS)
            cases.append(dict(row, shape=[r, d], dtype=str(dtype), at=what,
                              library=lib))
            if lib["host_bound"]:
                log(f"    F.rms_norm is host-bound here too: enqueue "
                    f"{lib['host_ms']:.4f} ms a call, profiler device "
                    f"{lib['device_ms']} ms")
            if what == "decode step":
                log(f"    host enqueue a call at the decode shape: kernel "
                    f"{timed['host_ms']:.4f} ms, F.rms_norm "
                    f"{lib['host_ms']:.4f} ms")
            if dtype == torch.bfloat16 and what == "forward":
                rows["rmsnorm"] = row
            del x, got, want, diff
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.finfo(dtype).bits // 8
        rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        for what, b, s, h, kv, hd in (
                ("qwen2.5-14b forward", FWD_B, FWD_S, cfg.n_heads,
                 cfg.n_kv_heads, cfg.head_dim),
                ("smollm-135m widths", FWD_B, FWD_S, 9, 3, 64),
                ("ragged S", FWD_B, 200, cfg.n_heads, cfg.n_kv_heads,
                 cfg.head_dim)):
            q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
            k = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dtype)
            v = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dtype)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)

            got = flash_attention_cuda(q, k, v)
            want = flash_attention_ref(q, k, v).float()
            lib_out = sdpa().transpose(1, 2).float()
            torch.cuda.synchronize()
            diff = (got.float() - want).abs()
            lib_err = float((lib_out - want).abs().max())
            if dtype == torch.float32:
                # the JAX package's f32 kernel-test bound
                need(bool((diff <= 2e-5 + 2e-5 * want.abs()).all()),
                     f"flash_attention {dtype} {what} differs from its plain "
                     f"version by {float(diff.max())}")
            else:
                # bf16 rounds P before PV as the TPU kernel's MXU and SDPA
                # do: the JAX package's bf16 bound for this kernel
                # (tests/test_kernels.py, atol = rtol = 2e-2), and no
                # further from the plain version than 1.5x SDPA is
                need(bool((diff <= 2e-2 + 2e-2 * want.abs()).all()),
                     f"flash_attention {dtype} {what} differs from its plain "
                     f"version by {float(diff.max())} (bound 2e-2)")
                need(float(diff.max()) <= 1.5 * lib_err,
                     f"flash_attention {dtype} {what}: max error "
                     f"{float(diff.max())} above 1.5x SDPA's {lib_err}")
            del want, lib_out
            timed = time_call(torch, lambda: flash_attention_cuda(q, k, v),
                              device=True)
            plain = time_ms(torch, lambda: flash_attention_ref(q, k, v),
                            **PLAIN)
            lib = time_ms(torch, sdpa)
            flops = 4 * hd * causal_pairs(s, s) * b * h
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * es
            row = kernel_row(
                "flash_attention",
                "src/repro_torch/kernels/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention/flash_attention.py:68",
                float(diff.max()), timed, plain, nbytes, lib, ops=flops,
                op_rate=rate)
            log(f"    SDPA's max_abs_err against the plain version "
                f"{lib_err}; kernel {flops / timed['ms'] / 1e9:.1f} TFLOP/s, "
                f"{row['bound_ms'] / timed['ms']:.1%} of its bound, "
                f"{timed['ms'] / lib:.2f}x SDPA")
            cases.append(dict(row, shape=[b, s, h, kv, hd], dtype=str(dtype),
                              at=what, library_max_abs_err=lib_err))
            if dtype == torch.bfloat16 and what.startswith("qwen"):
                rows["flash_attention"] = row
            del q, k, v, got, diff, qt, kt, vt
            torch.cuda.empty_cache()
    return [rows["rmsnorm"], rows["flash_attention"]], cases


#: calls a piece of the RMSNorm wrapper is timed over (host clock), and
#: the turns in which the wrapper and F.rms_norm share them
HOST_CALLS = 10_000
HOST_TURNS = 10


def rmsnorm_host_pieces(torch) -> dict:
    """6a: host microseconds a call, each over ``HOST_CALLS`` calls with
    the host clock, at the decode shape (4 x 5,120 bf16): the RMSNorm
    wrapper and ``F.rms_norm`` in ``HOST_TURNS`` alternating turns (the
    medians), and each piece a wrapper can spend host time on: the ones it
    runs (the output allocation, the ctypes call of the C entry with its
    launch, the raw stream and current-device reads, three ``data_ptr``)
    beside costlier forms of the same work (a ``torch.cuda.Stream`` object
    a call, a device guard, two
    ``contiguous()``, alignment probes, ``build.library()``, a ``c_float``
    built by hand)."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda

    F = torch.nn.functional
    eps = 1e-6
    x = torch.randn((SERVE_B, 5120), device="cuda").to(torch.bfloat16)
    scale = torch.ones((5120,), device="cuda", dtype=torch.bfloat16)
    out = torch.empty_like(x)
    fn = build.library().repro_rmsnorm
    dev = x.get_device()
    stream = build.raw_stream(dev)
    xp, sp, op = x.data_ptr(), scale.data_ptr(), out.data_ptr()

    def guard():
        with torch.cuda.device(x.device):
            pass

    pieces = {
        "wrapper (rmsnorm_cuda)": lambda: rmsnorm_cuda(x, scale, eps),
        "F.rms_norm": lambda: F.rms_norm(x, (5120,), scale, eps),
        "torch.empty_like": lambda: torch.empty_like(x),
        "C entry by ctypes, launch included": lambda: fn(
            xp, sp, op, SERVE_B, 5120, eps, 1, 1, stream),
        "build.raw_stream": lambda: build.raw_stream(dev),
        "torch.cuda.current_device": torch.cuda.current_device,
        "three data_ptr": lambda: (x.data_ptr(), scale.data_ptr(),
                                   out.data_ptr()),
        "torch.cuda.current_stream().cuda_stream": lambda: build.stream_of(x),
        "with torch.cuda.device": guard,
        "two contiguous()": lambda: (x.contiguous(), scale.contiguous()),
        "three alignment probes": lambda: all(
            t.data_ptr() % 16 == 0 for t in (x, scale, out)),
        "build.library()": build.library,
        "ctypes.c_float(eps)": lambda: ctypes.c_float(eps),
    }
    def per_call(piece, calls):
        for _ in range(100):
            piece()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            piece()
        t = (time.perf_counter() - t0) * 1e6 / calls
        torch.cuda.synchronize()
        return t

    # the two whole calls in turns (a b b a ...), HOST_CALLS each in all
    turns = {"wrapper (rmsnorm_cuda)": [], "F.rms_norm": []}
    names = list(turns)
    for r in range(HOST_TURNS):
        for name in (names if r % 2 == 0 else names[::-1]):
            turns[name].append(per_call(pieces[name],
                                        HOST_CALLS // HOST_TURNS))
    us = {name: statistics.median(t) for name, t in turns.items()}
    us.update((name, per_call(piece, HOST_CALLS))
              for name, piece in pieces.items() if name not in turns)
    log("    host us a call at the decode shape: " + "; ".join(
        f"{k} {v:.2f}" for k, v in us.items()))
    for name, t in turns.items():
        log(f"    {name} in {HOST_TURNS} turns of {HOST_CALLS // HOST_TURNS}"
            f" calls: median {us[name]:.2f} us, range {min(t):.2f}-"
            f"{max(t):.2f}")
    return {"us": us, "turns": turns}


def logit_errors(got, base, ref):
    """Mean and largest absolute error of ``got`` and of ``base`` against
    ``ref`` (f32 tensors on the CPU)."""
    eg, eb = (got - ref).abs(), (base - ref).abs()
    return {"card_mean": float(eg.mean()), "card_max": float(eg.max()),
            "cpu_mean": float(eb.mean()), "cpu_max": float(eb.max())}


def model_card_vs_cpu(torch, steps=8):
    """6b: each reduced dense model with the same weights (drawn on the CPU
    from a seed, then moved) on the card and on the CPU. The card's bf16
    logits (cuBLAS bf16 matmuls, with the reduced-precision reductions
    PyTorch enables by default, and the two kernels) must be as close to the
    CPU's f32 logits as the CPU's own bf16 logits: mean absolute error at
    most 1.25x, the largest at most 2x. Forward and ``steps`` decode
    steps."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import build_model

    out = {}
    for name in ("qwen2.5-14b", "smollm-135m", "stablelm-1.6b"):
        cfg = get_arch(name).reduced()
        cpu = build_model(cfg, device="cpu", seed=5)
        cpu32 = build_model(cfg, device="cpu", seed=5)
        cpu32.float()
        card = build_model(cfg, device="cpu", seed=5).to("cuda")
        tokens = torch.randint(0, cfg.vocab, (2, 32), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(6))
        rec = {}
        rec["forward"] = logit_errors(
            card.forward(tokens.cuda()).float().cpu(),
            cpu.forward(tokens).float(), cpu32.forward(tokens))
        caches = [m.init_cache(2, steps) for m in (card, cpu, cpu32)]
        dec = [[], [], []]
        for t in range(steps):
            for i, m in enumerate((card, cpu, cpu32)):
                tok = tokens[:, t:t + 1].to(m.device)
                logits, caches[i] = m.decode_step(caches[i], tok, t)
                dec[i].append(logits.float().cpu())
        rec["decode"] = logit_errors(*(torch.cat(x, 1) for x in dec))
        for part, e in rec.items():
            need(e["card_mean"] <= 1.25 * e["cpu_mean"]
                 and e["card_max"] <= 2 * e["cpu_max"],
                 f"{name} {part}: the card's bf16 logits are further from "
                 f"the f32 logits than the CPU's: {e}")
        out[name] = rec
        log(f"  {name} (reduced): forward |card - f32| mean "
            f"{rec['forward']['card_mean']:.5f} max "
            f"{rec['forward']['card_max']:.4f} (CPU bf16 "
            f"{rec['forward']['cpu_mean']:.5f} / "
            f"{rec['forward']['cpu_max']:.4f}); decode mean "
            f"{rec['decode']['card_mean']:.5f} (CPU "
            f"{rec['decode']['cpu_mean']:.5f})")
    return out


class Swap:
    """Within the block, the dense decoder's kernel calls (the names
    ``flash_attention`` and ``_rmsnorm_kernel`` of ``models/layers.py``) go
    to other functions: the plain versions for the f32 reference, wrong
    variants for the controls. A swapped kernel must not launch inside the
    block; if ``models/layers.py`` reached it by another name, the
    reference would be the model itself and the check would prove
    nothing."""

    KERNEL = {"flash_attention": "flash_attention",
              "_rmsnorm_kernel": "rmsnorm"}

    def __init__(self, **fns):
        from repro_torch.kernels import build
        from repro_torch.models import layers
        self.build, self.layers, self.fns = build, layers, fns

    def __enter__(self):
        self.orig = {k: getattr(self.layers, k) for k in self.fns}
        self.before = {self.KERNEL[k]: self.build.LAUNCHES[self.KERNEL[k]]
                       for k in self.fns}
        for k, fn in self.fns.items():
            setattr(self.layers, k, fn)

    def __exit__(self, exc_type, *exc):
        for k, fn in self.orig.items():
            setattr(self.layers, k, fn)
        if exc_type is None:
            for name, n in self.before.items():
                got = self.build.LAUNCHES[name] - n
                need(got == 0, f"{name} launched {got} times while swapped "
                     "for another function")


def f32_reference_forward(torch, model, tokens):
    """The forward in f32 without kernels: the kernels' plain versions, and
    each block's weights cast to f32 one block at a time, so that the
    reference fits beside the bf16 model."""
    import copy

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_ref)
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_ref
    from repro_torch.models import lm

    cfg = model.cfg
    b, s = tokens.shape
    with torch.inference_mode(), Swap(flash_attention=flash_attention_ref,
                                      _rmsnorm_kernel=rmsnorm_ref):
        x = model.embed.index_select(0, tokens.reshape(-1)).float()
        x = x.reshape(b, s, -1)
        pos = torch.arange(s, dtype=torch.int32, device=x.device)[None]
        for p in model.layers:
            x = lm._block_fwd(cfg, copy.deepcopy(p).float(), x,
                              pos.expand(b, s))
        x = rmsnorm_ref(x, model.ln_f.float(), cfg.norm_eps)
        return x @ model.unembed.float()


def masked_attention(torch, keep):
    """Plain attention over (B, S, H, D) / (B, S, KV, D) keeping the
    (query, key) pairs where ``keep(qi, kj)`` is true."""
    def attend(q, k, v, causal=True):
        b, s, h, d = q.shape
        kv = k.shape[2]
        i = torch.arange(s, device=q.device)
        mask = keep(i[:, None], i[None, :])
        qg = q.float().reshape(b, s, kv, h // kv, d)
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d ** -0.5
        w = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
        return o.reshape(b, s, h, d).to(q.dtype)
    return attend


def rel_rms(a, b):
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def model_main_path(torch, build):
    """6c: qwen2.5-14b at full widths and depth, random weights from seed 0
    on the card: a timed forward of 4 x 2,048 tokens, ``generate`` for 4
    requests (prompt 16, gen 32), decode through the cache against the
    forward, one forward and one decode step under sync debug mode
    "error", and the peak device bytes. Launch counts are zeroed before
    each counted run and read after it."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    cfg = get_arch(MODEL)
    L = cfg.n_layers
    per_pass = {"rmsnorm": 2 * L + 1, "flash_attention": L}
    out = {"config": MODEL, "n_layers": L}
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["n_params"] = model.n_params()
    out["weight_bytes"] = torch.cuda.memory_allocated() - before
    log(f"  {MODEL}: {out['n_params'] / 1e9:.3f} B parameters, "
        f"{out['weight_bytes'] / 1e9:.2f} GB, drawn in {out['init_s']:.2f} s")
    gen = torch.Generator(device="cuda").manual_seed(1)
    totals = {name: 0 for name in build.LAUNCHES}

    peaks = {}

    def counted(label, fn, expect):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peaks[label] = torch.cuda.max_memory_allocated()
        launches = dict(build.LAUNCHES)
        want = {name: expect.get(name, 0) for name in launches}
        need(launches == want, f"{label}: launches {launches}, expected "
             f"{want}")
        for name, v in launches.items():
            totals[name] += v
        return res, wall

    tokens = torch.randint(0, cfg.vocab, (FWD_B, FWD_S), generator=gen,
                           device="cuda", dtype=torch.int32)
    fwd = []
    for i in range(2):                       # the first warms cuBLAS up
        logits, wall = counted(f"forward {i}", lambda: model.forward(tokens),
                               per_pass)
        need(logits.shape == (FWD_B, FWD_S, cfg.vocab)
             and logits.dtype == torch.bfloat16, f"forward logits "
             f"{tuple(logits.shape)} {logits.dtype}")
        need(bool(torch.isfinite(logits).all()), "forward logits not finite")
        del logits
        fwd.append(wall)
        log(f"  forward {FWD_B} x {FWD_S}: {wall * 1e3:.1f} ms "
            f"({FWD_B * FWD_S / wall:.0f} tokens/s)")
    out["forward_s"] = fwd

    prompt = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_P), generator=gen,
                           device="cuda", dtype=torch.int32)
    steps = SERVE_P + SERVE_G - 1
    serve = []
    for i in range(2):
        toks, wall = counted(
            f"generate {i}", lambda: generate(model, prompt, SERVE_G),
            {"rmsnorm": steps * per_pass["rmsnorm"]})
        need(toks.shape == (SERVE_B, SERVE_G) and toks.dtype == torch.int32,
             f"generated {tuple(toks.shape)} {toks.dtype}")
        host = toks.cpu()
        need(bool(((host >= 0) & (host < cfg.vocab)).all()),
             "generated token ids out of range")
        serve.append({"wall_s": wall, "ms_per_step": wall / steps * 1e3,
                      "tokens_per_s": SERVE_B * SERVE_G / wall})
        log(f"  generate {SERVE_B} requests (prompt {SERVE_P}, gen "
            f"{SERVE_G}, {steps} steps): {wall:.3f} s, "
            f"{wall / steps * 1e3:.2f} ms/step, "
            f"{SERVE_B * SERVE_G / wall:.1f} tokens/s; sample "
            f"{host[0, :8].tolist()}")
    out["serve"] = serve
    out["serve_tokens"] = host.tolist()

    out["peak_bytes"] = peaks
    log("  peak device memory: " + ", ".join(
        f"{k} {v / 1e9:.2f} GB" for k, v in peaks.items()))

    # decode through the cache against the forward, position by position,
    # both against the f32 reference
    toks2 = torch.randint(0, cfg.vocab, (CHECK_B, CHECK_S), generator=gen,
                          device="cuda", dtype=torch.int32)
    full = model.forward(toks2).float()
    cache = model.init_cache(CHECK_B, CHECK_S)
    dec = torch.empty_like(full)
    for t in range(CHECK_S):
        logits, cache = model.decode_step(cache, toks2[:, t:t + 1], t)
        dec[:, t] = logits[:, 0].float()
    ref = f32_reference_forward(torch, model, toks2)
    e_fwd, e_dec, e_dvf = rel_rms(full, ref), rel_rms(dec, ref), rel_rms(dec, full)
    per_pos = ((dec - full).pow(2).mean((0, 2)).sqrt()
               / full.pow(2).mean((0, 2)).sqrt())
    controls = {}
    for name, keep in (("no causal mask", lambda i, j: (i >= j) | (i < j)),
                       ("KV tile 0 dropped past row 63",
                        lambda i, j: (i >= j) & ((i < 64) | (j >= 64)))):
        with Swap(flash_attention=masked_attention(torch, keep)):
            controls[name] = rel_rms(model.forward(toks2).float(), full)
    bound = DECODE_VS_FORWARD_MAX
    out["decode_vs_forward"] = {
        "forward_vs_f32": e_fwd, "decode_vs_f32": e_dec,
        "decode_vs_forward": e_dvf, "bound": bound,
        "max_abs": float((dec - full).abs().max()),
        "logit_rms": float(full.pow(2).mean().sqrt()),
        "worst_position": float(per_pos.max()),
        "controls_vs_forward": controls}
    log(f"  decode vs forward, B={CHECK_B} x S={CHECK_S}, relative RMS: "
        f"forward vs f32 {e_fwd:.5f}, decode vs f32 {e_dec:.5f}, decode vs "
        f"forward {e_dvf:.5f} (bound {bound:.5f}; worst position "
        f"{float(per_pos.max()):.5f}; max |diff| "
        f"{out['decode_vs_forward']['max_abs']:.4f}); controls "
        + ", ".join(f"{k} {v:.4f}" for k, v in controls.items()))
    need(e_fwd <= FORWARD_VS_F32_MAX, f"the bf16 forward is {e_fwd} from "
         f"the f32 reference (> {FORWARD_VS_F32_MAX})")
    need(e_dec <= DECODE_VS_F32_MAX, f"decode is {e_dec} from the f32 "
         f"reference (> {DECODE_VS_F32_MAX})")
    need(e_dvf <= bound and float(per_pos.max()) <= bound,
         f"decode disagrees with the forward: {e_dvf} over all positions, "
         f"{float(per_pos.max())} at the worst, bound {bound}")
    for name, v in controls.items():
        need(v > bound, f"control '{name}' ({v}) is inside the "
             f"decode-vs-forward bound {bound}: the check is not tight")
    del full, dec, cache, ref

    # no host sync inside one decode step or one forward
    cache = model.init_cache(CHECK_B, CHECK_S)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_step(cache, toks2[:, :1], 0)
        model.forward(toks2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("  one decode step and one forward ran under sync debug mode "
        "'error': no host sync")
    out["profile"] = model_profile(torch, model, tokens, prompt, {
        "forward": min(fwd), "decode_step": min(
            r["ms_per_step"] for r in serve) / 1e3})
    del model, cache
    torch.cuda.empty_cache()
    return totals, out


def model_profile(torch, model, tokens, prompt, walls, top=8):
    """Device time by kernel for one forward and one decode step
    (``torch.profiler``), and the device's busy share of the unprofiled
    wall time ``walls[label]`` (seconds) of the same work; ``None`` where
    the profiler records no device time on this machine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    cache = model.init_cache(SERVE_B, SERVE_P + SERVE_G)
    for label, fn in (
            ("forward", lambda: model.forward(tokens)),
            ("decode_step", lambda: model.decode_step(
                cache, prompt[:, :1], SERVE_P))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # device-side kernel and copy records only; "Command Buffer Full"
        # marks a full launch queue, not device work
        rows = sorted(
            ((e.self_device_time_total, e.key, e.count)
             for e in prof.key_averages()
             if getattr(e, "device_type", None) == DeviceType.CUDA
             and e.self_device_time_total > 0
             and e.key != "Command Buffer Full"), reverse=True)
        if not rows:
            out[label] = None
            log(f"  profile {label}: no device time recorded")
            continue
        busy = sum(r[0] for r in rows) / 1e3
        wall = walls[label] * 1e3
        out[label] = {
            "device_busy_ms": busy, "wall_ms": wall,
            "idle_share": max(0.0, 1 - busy / wall),
            "launches": sum(r[2] for r in rows),
            "top": [{"name": k[:90], "device_ms": us / 1e3, "count": c}
                    for us, k, c in rows[:top]]}
        log(f"  profile {label}: device busy {busy:.2f} ms of {wall:.2f} ms "
            f"unprofiled wall (idle {out[label]['idle_share']:.1%}), "
            f"{out[label]['launches']} device records")
        for us, k, c in rows[:top]:
            log(f"    {us / 1e3:9.3f} ms  x{c:<5} {k[:80]}")
    return out


def kernel_times(torch, np) -> dict:
    """The redesigned kernels of the ``repro_torch`` on ``sys.path`` at the
    main path's shapes on ``mico_like(0.1)``: the radix sort and
    ``seg_unique`` at the first size-2 chunk's child codes and at the
    canonical codes that the device level 2 of a motifs run under
    ``cost_model="force_device"`` re-bins (its last, step 3's), the refine
    at the distinct table that level 2 refines, and the refine of the
    seeded codes of every nv from 2 to 8, and the expansion at the chunk
    and at the wide synthetic shape. At each, exact against the plain
    version, then timed."""
    from repro_torch.core import RunConfig, aggregation, graph as G, run
    from repro_torch.core.apps import MotifsApp
    from repro_torch.kernels import aggregate, build, canonical_refine
    from repro_torch.kernels import radix_bin as R
    ops = importlib.import_module(
        "repro_torch.kernels.canonical_check.canonical_check")

    build.library()
    g = G.mico_like(0.1)
    dg = G.to_device(g)
    ch = first_chunk(torch, np, dg, g)
    shapes = {"chunk": (ch["qp"].codes.contiguous(), ch["child_nv"] > 0,
                        min(ch["out_cap"], AGG_QCAP))}
    args = (ch["members"], ch["n_valid"], dg.nbr, dg.adj_bits)
    err = max_abs_err(torch, ops.expand_canonical_cuda(*args),
                      ops.expand_canonical_ref(*args))
    need(err == 0, f"expand_canonical differs at the chunk ({err})")
    timed = time_call(torch, lambda: ops.expand_canonical_cuda(*args),
                      device=True)
    variant = getattr(ops, "expand_variant", None)
    expand = {"chunk": {
        "ms": timed["ms"], "host_ms": timed["host_ms"],
        "device_ms": timed["device_ms"],
        "variant": (variant(args[0].shape[1], dg.adj_bits.shape[1])
                    if variant else None)}}
    del ch, args
    expand["wide"] = expand_wide_case(torch, np, ops)
    with Level2Tables(aggregation) as tables:
        run(g, MotifsApp(max_size=3), RunConfig(cost_model="force_device"))
    table = tables.last
    shapes["level2"] = (*level2_rebin_input(torch, table), table[3])
    out = {"card": torch.cuda.get_device_name(0),
           "nvidia_smi": nvidia_smi_line(), "expand": expand}
    for name, (codes, valid, cap) in shapes.items():
        err = max_abs_err(torch, R.radix_sort_codes(codes, valid),
                          R.radix_sort_codes_ref(codes, valid))
        need(err == 0, f"radix_sort_codes differs at {name} ({err})")
        timed = time_call(torch, lambda: R.radix_sort_codes(codes, valid))
        new, sv, _ = seg_inputs(torch, codes, valid)
        err = max_abs_err(torch, aggregate.seg_unique_cuda(new, sv, cap),
                          aggregate.seg_unique_ref(new, sv, cap))
        need(err == 0, f"seg_unique differs at {name} ({err})")
        seg = time_call(torch, lambda: aggregate.seg_unique_cuda(
            new, sv, cap), device=True)
        out[name] = {"rows": codes.shape[0], "valid": int(valid.sum()),
                     "sort_ms": timed["ms"], "host_ms": timed["host_ms"],
                     "seg_unique_ms": seg["ms"],
                     "seg_unique_host_ms": seg["host_ms"],
                     "seg_unique_device_ms": seg["device_ms"],
                     "seg_unique_cap": cap,
                     "seg_unique_bound_ms": seg_unique_bytes(
                         codes.shape[0], cap) / HBM_BYTES_PER_S * 1e3}
        del codes, valid, new, sv
    u, _, uv, _, nvs = table
    err = max_abs_err(torch, canonical_refine.refine_cuda(u, uv, nvs),
                      canonical_refine.refine_codes_ref(u, uv, nvs))
    need(err == 0, f"canonical_refine differs at level 2 ({err})")
    out["level2"]["refine_ms"] = time_call(
        torch, lambda: canonical_refine.refine_cuda(u, uv, nvs))["ms"]
    out["level2"]["refine_bound_ms"] = (refine_bytes(u.shape[0], nvs[0])
                                        / HBM_BYTES_PER_S * 1e3)
    out["refine_synthetic_ms"], out["refine_synthetic_device_ms"] = {}, {}
    for nv, codes in refine_synthetic_codes(np).items():
        c = torch.from_numpy(codes).to(dg.device)
        v = torch.ones(c.shape[0], dtype=torch.bool, device=dg.device)
        err = max_abs_err(torch, canonical_refine.refine_cuda(c, v, (nv,)),
                          canonical_refine.refine_codes_ref(c, v, (nv,)))
        need(err == 0, f"canonical_refine differs at nv={nv} ({err})")
        timed = refine_synthetic_time(torch, c, v, nv)
        out["refine_synthetic_ms"][nv] = timed["ms"]
        out["refine_synthetic_device_ms"][nv] = timed["device_ms"]
    return out


def kernel_ab(parent_src: Path) -> list:
    """:func:`kernel_times` of ``parent_src``'s package and of this
    checkout's in turns (parent, change, change, parent), each in a process
    of its own that builds and loads its own kernels."""
    results = []
    for label, src in (("parent", parent_src), ("change", SRC),
                       ("change", SRC), ("parent", parent_src)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--kernel-times",
             str(src.resolve())], stdout=subprocess.PIPE, text=True)
        need(proc.returncode == 0, f"the kernel times of {src} failed")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res.update(label=label, src=str(src))
        results.append(res)
        c, l2 = res["chunk"], res["level2"]
        dev = res["refine_synthetic_device_ms"]
        syn = ", ".join(f"{nv}: {ms:.4f} (device {dev[nv]})"
                        for nv, ms in res["refine_synthetic_ms"].items())
        ex = res["expand"]
        log(f"{label}: expand_canonical chunk {ex['chunk']['ms']:.4f} ms "
            f"(device {ex['chunk']['device_ms']}), wide "
            f"{ex['wide']['ms']:.4f} ms (device {ex['wide']['device_ms']}, "
            f"bound {ex['wide']['bound_ms']:.4f})")
        log(f"{label}: sort chunk {c['sort_ms']:.4f} ms, level2 "
            f"{l2['sort_ms']:.4f} ms; seg_unique chunk "
            f"{c['seg_unique_ms']:.4f} ms (host {c['seg_unique_host_ms']:.4f}"
            f", device {c['seg_unique_device_ms']}), level2 "
            f"{l2['seg_unique_ms']:.4f} ms (device "
            f"{l2['seg_unique_device_ms']}); refine level2 "
            f"{l2['refine_ms']:.4f} ms; refine by nv {{{syn}}} ms "
            f"({res['nvidia_smi']})")
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", type=Path, default=None,
                        help="also write the run's details to this file")
    parser.add_argument("--kernel-ab", type=Path, default=None,
                        metavar="PARENT_SRC",
                        help="only time the expansion, the radix sort, "
                        "seg_unique and the canonical refine of "
                        "PARENT_SRC's repro_torch and of "
                        "this checkout's at the main path's shapes, in turns "
                        "(parent, change, change, parent), and print the "
                        "four results")
    parser.add_argument("--kernel-times", type=Path, default=None,
                        help=argparse.SUPPRESS)   # one turn of --kernel-ab
    parser.add_argument("--fsm-full-depth", action="store_true",
                        help="only run phase 8c: 7b's graph to 4 edges "
                        "(citeseer_like(1.0), support 25) under a device "
                        "budget and then in one wave, and print their "
                        "record; where the card runs out of memory, log "
                        "the failed allocation and the peak and exit "
                        "non-zero")
    args = parser.parse_args(argv)
    if not (SRC / "repro_torch").is_dir():
        raise SmokeFailure(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(args.kernel_times or SRC))
    import numpy as np
    import torch

    need(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    if args.kernel_times is not None:
        print(json.dumps(kernel_times(torch, np)))
        return 0
    if args.fsm_full_depth:
        print(json.dumps(fsm_full_depth(torch)))
        return 0
    if args.kernel_ab is not None:
        results = kernel_ab(args.kernel_ab)
        if args.json is not None:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(results, indent=1))
        print(json.dumps(results))
        return 0
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
    kernels, extra = kernel_checks(torch, np, dg, g)
    rows, extra["partitioned"], pg = partition_checks(torch, np, G, g)
    kernels += rows
    build.reset_launches()
    members = torch.from_numpy(g.edges[:CHUNK].astype(np.int32)).to(dg.device)
    n_valid = torch.full((CHUNK,), 2, dtype=torch.int32, device=dg.device)
    chunk_program_is_sync_free(torch, dg, pg, members, n_valid)
    log("  chunk programs (whole graph and partitioned) ran under sync "
        "debug mode 'error': no host sync")
    extra["chunk_program_ms"] = chunk_program_times(torch, dg, pg, members,
                                                    n_valid)
    del dg, pg, members, n_valid
    torch.cuda.empty_cache()

    # ---- 4. card port vs CPU port ----------------------------------------
    log("[4] card port vs CPU port on mico_like(0.005) and (0.001)")
    small = card_vs_cpu(torch, run, G.mico_like, [
        ("motifs", 0.005, MotifsApp(max_size=3), RunConfig()),
        ("cliques", 0.005, CliquesApp(max_size=4), RunConfig()),
        ("motifs_force_device", 0.005, MotifsApp(max_size=3),
         RunConfig(cost_model="force_device")),
        ("motifs_host_async", 0.005, MotifsApp(max_size=3),
         RunConfig(canonical_placement="host_async")),
        ("motifs4_force_device", 0.001, MotifsApp(max_size=4),
         RunConfig(cost_model="force_device")),
        ("motifs_partitioned", 0.005, MotifsApp(max_size=3),
         RunConfig(graph_partition=PARTS)),
        ("cliques_partitioned", 0.005, CliquesApp(max_size=4),
         RunConfig(graph_partition=PARTS)),
    ])

    # ---- 5. the main path --------------------------------------------------
    log("[5] main path on mico_like(0.1) through repro_torch.core.run")
    totals, runs, level2_table, raw_runs = main_path(
        torch, np, run, RunConfig, G, build, [
        ("motifs_unfused", MotifsApp(max_size=3), RunConfig()),
        ("motifs_fused", MotifsApp(max_size=3), RunConfig(fused_expand=True)),
        ("cliques", CliquesApp(max_size=4), RunConfig()),
        ("motifs_force_device", MotifsApp(max_size=3),
         RunConfig(cost_model="force_device")),
        ("motifs_partitioned", MotifsApp(max_size=3),
         RunConfig(graph_partition=PARTS)),
        ("cliques_partitioned", CliquesApp(max_size=4),
         RunConfig(graph_partition=PARTS)),
    ])
    row, extra["level2_step3"] = refine_main_table(torch, level2_table)
    rebin = level2_rebin_input(torch, level2_table)
    extra["radix_level2"] = radix_case(torch, *rebin, "level2")
    cap = level2_table[3]
    extra["seg_unique_level2"] = seg_unique_case(torch, *rebin, cap, cap,
                                                 "level2")
    kernels.append(row)
    del rebin
    del level2_table
    build.reset_launches()
    torch.cuda.empty_cache()

    # ---- 6. the model zoo's dense decoder ----------------------------------
    log(f"[6a] rmsnorm and flash attention vs plain versions at {MODEL} "
        "widths")
    rows, extra["model_kernels"] = model_kernel_checks(torch)
    kernels += rows
    extra["rmsnorm_host_us"] = rmsnorm_host_pieces(torch)
    build.reset_launches()
    log("[6b] card port vs CPU port on reduced qwen2.5-14b, smollm-135m, "
        "stablelm-1.6b")
    extra["model_card_vs_cpu"] = model_card_vs_cpu(torch)
    build.reset_launches()
    log(f"[6c] main path: {MODEL} at full widths and depth")
    model_totals, extra["model_main_path"] = model_main_path(torch, build)
    for name, v in model_totals.items():
        totals[name] += v

    # ---- 7. frequent subgraph mining ---------------------------------------
    fsm_totals, extra["fsm"], fsm_3edges = fsm_phase(torch, np, run,
                                                     RunConfig, G, build)
    for name, v in fsm_totals.items():
        totals[name] += v

    # ---- 8. the frontier stores ----------------------------------------------
    extra["stores_card_vs_cpu"] = store_card_vs_cpu(torch, run, RunConfig, G)
    store_totals, extra["stores_main_path"] = store_main_path(
        torch, np, run, RunConfig, G, build, raw_runs)
    del raw_runs
    log(f"[8c] the paper's FSM graph at its depth: citeseer_like(1.0), "
        f"{dict(FSM_MAIN_APP, max_size=4)}, budget {FSM_DEPTH_BUDGET} B, "
        "then one wave")
    extra["fsm_depth"] = fsm_depth_runs(torch, run, RunConfig, G, build,
                                        store_totals, fewer_edges=fsm_3edges)
    del fsm_3edges
    for name, v in store_totals.items():
        totals[name] += v
    for row in kernels:
        row["launches"] = totals[row["name"]]
        need(row["launches"] > 0,
             f"{row['name']} never launched on the main path")
    need(len(kernels) == 11, f"{len(kernels)} kernel rows, expected 11")

    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({
            "card": kind, "nvidia_smi": smi, "kernels": kernels,
            "card_vs_cpu": small, "main_path": runs, **extra,
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
