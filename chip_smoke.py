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
     of the first size-2 chunk), the gather's host time a call split into
     its pieces; the stream compaction also at B of 0, 1,
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
        ``device_budget_bytes=2**30`` (the same run in one wave is left
        to ``--fsm-full-depth``): the waves per step, the wall, the peak;
        a frequent pattern of 4 edges and, up to 3 edges, 7b's patterns;
  9. the runtime's control plane, through ``run``, ``resume`` and
     ``run_supervised``:
     a. the pilot-calibrated cost model (``cost_model="auto"``) on
        ``mico_like(0.1)`` size-3 motifs and ``citeseer_like(1.0)`` FSM
        (support 25, 3 edges), each run twice: the decision table (source,
        knobs, probe timings), the seconds ``resolve`` took and the pilot's
        launches; the source ``calibrated``, the three kernel knobs on,
        the patterns of phase 5's and 7b's ``off`` runs, no second pilot;
        a table written to a ``cost_model_dir`` read back as ``cached`` by
        a child process;
     b. checkpoints of the motif run (``checkpoint_every=1``: per step
        ``t_checkpoint`` and the cut's bytes), resumed from the step-2 cut
        under the raw and the ODAG store; a child process killed by an
        ``exit`` fault at step 3's aggregation (exit code 17), resumed
        from what it left; each equal to phase 5's run;
     c. ``run_supervised`` on the motifs under a crash at step 2's
        aggregation, an OOM at step 2's expansion (the ``budget_capped``
        rung), a corrupt step-2 cut and a crash after it (the rollback) and
        a ``saturate`` (the wide re-fold), and on the FSM run under one
        crash: each bit-identical to its clean supervised run, the retry
        stamped on step 2 with its ``t_recovery``, the reference's rungs,
        the peak within 1.1x the clean run's; an expansion crash repeated
        three times, which on the card takes ``fused_off`` and no rung to
        the plain versions, the kernel knobs still on; a real allocation
        past a per-process memory cap in a child classified ``oom``;
     d. tracing the motif run: the Chrome trace valid, phase coverage
        >= 0.95, the untraced run's host syncs per step, a device-memory
        gauge; ``trace_sync`` under ``graph_partition=4`` (``t_gather`` >
        0, fences counted); ``log_every=1`` one line a superstep;
     and no run without an injected fault has a recovery report;
  10. the distributed backend (the shard-map superstep, paper §5.1-5.3)
     through ``run_distributed`` on a mesh of four virtual workers on the
     card (``make_mesh((4,), ("data",))``: the workers share the card, so
     their collectives are copies within it), ``cost_model="off"``:
     a. the card against the CPU port over four CPU workers (patterns,
        embeddings, every per-step counter with ``collective_bytes``) on
        ``mico_like(0.005)``: size-3 motifs and size-4 cliques whole-graph
        and under ``graph_partition=4`` with both halo strategies, motifs
        under ``store="odag"``; size-3 motifs with and without
        ``naive_aggregation`` on ``mico_like(0.002)`` (Table 4's ratio of
        collective bytes); FSM on ``citeseer_like(0.1)``, support 2, 3
        edges;
     b. the main path on ``mico_like(0.1)``: size-3 motifs whole-graph
        (fused expansion, radix bin, device level 2), under
        ``graph_partition=4`` (all-to-all halo) and under ``store="odag"``
        (the dense exchange), size-4 cliques under ``graph_partition=4``,
        each equal to phase 5's run (patterns, embeddings as sets), kernels
        counted: per run the wall, the peak, the launches, per step the
        phase times, syncs (<= 2), collective and halo bytes; the
        partitioned motifs once more under ``trace_sync`` (the halo
        exchange probed into ``t_exchange``, the syncs unchanged); every
        kernel of the path launched; one superstep's expansion under sync
        debug mode "error";
     c. ``citeseer_like(1.0)`` FSM, support 25, 3 edges, under
        ``store="odag"``: 7b's patterns;
     d. a cut of the partitioned motifs written at four workers resumed at
        three and five, and ``run_supervised`` under a ``halo`` fault (the
        ``halo_gather`` rung), each equal to phase 5's run;
  11. the exact oracles, Table 1's SN and Patents graphs and the examples,
     through ``run`` at the default config unless named:
     a. the card against the port's brute-force oracles
        (``repro_torch.core.baselines.bruteforce``, host sets, nothing of
        the engine): size-4 motifs and cliques and FSM supports on the
        graphs of tests/test_apps_vs_oracle.py, Figure 2's single-edge
        supports and counts, and the explored embeddings against TLV's
        (``baselines.tlv.run_tlv``), whose messages exceed twice them;
     b. paper Table 5 at SN scale: ``unlabeled_sn_like(0.0004)`` under
        bench_large.py's ``chunk_size=16384, initial_capacity=1 << 16``,
        size-3 motifs and size-4 cliques (``collect_embeddings=False``),
        then size-3 motifs of ``unlabeled_sn_like(0.002)``; held to the
        host's closed forms (scipy.sparse): T = trace(A^3)/6 triangles,
        sum C(d,2) - 3T open wedges, sum C(d,2) - 2T connected triples,
        and size-4 cliques by the edges among each edge's common
        neighbours;
     c. size-3 motifs of ``patents_like(0.01)`` (37 labels) against the
        same closed forms;
     d. every example's ``main`` (``repro_torch.examples``) on the card
        with its defaults (the trace directory a temporary one), each
        passing its own check; quickstart's motifs against the oracle, the
        FSM and the distributed examples against the CPU port;
     for every run the wall, the peak, per step the phase times and host
     syncs, and the launches per kernel (added to the kernels line);
  12. the rest of the model zoo's serving path (``repro_torch.models``):
     a. flash attention at the new families' shapes, bf16: zamba2's
        sliding window of 512 over S = 2,048 (32 heads of 80), deepseek's
        MLA prefill (128 heads, D = 192 with v zero-padded from 128),
        whisper's encoder (S = 1,500, 8 heads of 64, no mask) and its
        cross-attention (448 queries over 1,500 frames); RMSNorm at MLA's
        q and kv norms (1,536, 512), Mamba2's gate norm (5,120) and the
        mLSTM's output norm (4,096), 8,192 rows; each against its plain
        version (6a's bounds), timed beside it, its bound and the library
        call (SDPA with the same mask, ``F.rms_norm``);
     b. the card port against the CPU port on the reduced deepseek-v2-236b,
        llama4-maverick-400b-a17b, zamba2-2.7b, xlstm-1.3b, whisper-base and
        internvl2-26b, forward and 8 decode steps (zamba2 also 8 around
        its shared attention's clamp) under 6b's rule; the MoE archs on
        four input batches, their bf16 runs routed as the f32 run (so that
        the rule holds every position), each router's own choice recorded:
        the card's at most 1/8 of the positions more off the f32 run's
        experts than the CPU's;
     c. deepseek-v2-236b (cut to its dense layer and two MoE layers),
        zamba2-2.7b, xlstm-1.3b, whisper-base and internvl2-26b at their
        published widths, random weights from seed 0: a forward of 4 x
        2,048 tokens (whisper 448 over 1,500 frames, internvl2 after 256
        patches) and ``generate`` for 4 requests (prompt 16, gen 32), with
        the exact launches of each derived from the config (xLSTM launches
        no flash); decode against the forward at B = 2 (S = 256, whisper
        448) under the JAX package's bound for the family (deepseek's MoE
        capacity lifted in both), and the control with the state zeroed
        each step outside it; zamba2 and xlstm, whose random-weight stacks
        are chaotic at published depth, block by block (each block of the
        first super block, the shared attention+MLP block and the chunked
        scans, S = 512: two chunks, each with its control; their whole
        decode logged); one forward and one decode step under sync debug mode
        "error"; ``generate`` timed once, after the decode check; the
        wall, the peaks and the weights' bytes, each model freed before the
        next.
  13. training (``repro_torch.training``, ``repro_torch.launch.train``):
     a. the RMSNorm backward kernel at smollm-135m's and stablelm-1.6b's
        norms (1,024 x 576, 8,192 x 2,048), the flash-attention backward
        kernels and the forward's lse at the training shapes (stablelm
        4 x 2,048 with 32 heads of 64, qwen2.5-14b's 40 over 8 heads of
        128, smollm 8 x 128 with 9 over 3 heads, zamba2's window of 512
        with heads of 80, MLA's D = 192, whisper's unmasked encoder and its
        448-over-1,500 cross-attention), bf16 (the tensor cores) and f32
        (the CUDA cores), each against autograd through the plain f32
        forward (bf16 at most twice the plain bf16 autograd's error plus
        one bf16 step, f32 within 1e-4 relative, the lse within 1e-4), two
        calls bit for bit, timed beside its plain version, its bound and
        SDPA's backward through autograd;
     b. every registry arch reduced, the same weights on the card and on
        the CPU: the loss and every gradient leaf against the CPU's f32 run
        under 6b's rule (the MoE archs routed as their f32 run), then 5
        steps of ``TrainLoop`` on the card with the loss falling;
     c. the main path: ``launch.train`` for stablelm-1.6b at its published
        widths and 24 layers, random weights from seed 0, 4 x 2,048 tokens,
        10 steps checkpointed every 5: the loss falls, the exact launches a
        step, ms a step, tokens/s, the peak; one step profiled, one under
        sync debug mode "error"; a fresh model resumed from the step-5
        checkpoint gives steps 5-9's losses bit for bit;
     d. ``examples.train_lm --full`` (smollm-135m, 8 x 128): the loss falls;
  14. the dry run (``repro_torch.launch.dryrun``, ``repro_torch.roofline``):
     a. one cell a family on the fake 16 x 16 mesh at published widths and
        full depth (qwen2.5-14b train_4k, deepseek-v2-236b prefill_32k,
        zamba2-2.7b long_500k, xlstm-1.3b decode_32k, whisper-base
        decode_32k, internvl2-26b prefill_32k) and the mining cell on both
        meshes, each counted in a process of its own, all at once: status
        ``ok`` (or ``error`` naming the operation DTensor cannot shard),
        the seconds, the bottleneck and the three terms;
     b. the fixed-shape mining step (``core.distributed.
        mining_step_for_dryrun``) for real: four virtual workers on the
        card over a seeded graph of 65,536 vertices (maximum degree at most
        64) and a frontier of 2^20 full rows of 5 vertices, a dictionary
        of 512 quick codes; ``canonical_check`` launched once a worker;
        children, counts and the psum'd pattern counts equal, bit for bit,
        to a one-worker mesh run on each slice, to the plain route
        (``use_pallas=False``, no launch) on the card over the whole
        frontier, and, on the first 8,192 rows, to the four workers on the
        CPU's plain route; ms a step and the peak;
     c. the roofline held against the card: the dry run's counter on one
        device for 13c's train step and 6c's forward, whose measured times
        must be at least the bound (the largest term); measured / bound.

Phases 4, 5, 7a-b and 8a-b pass ``cost_model="off"``: under ``"auto"`` a
graph of 2,048 edges or more is calibrated, and the card and the CPU may
then place phases differently, which moves per-step counters such as
``bytes_to_host`` and ``n_host_syncs``; ``"off"`` resolves as ``"auto"``
did before the calibration was ported, so those phases' checks and records
stay comparable with earlier runs. 7c and 8c run the default, calibrated.

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
of every nv from 2 to 8, the halo gather at phase 3's tiles and the bf16
flash backward at stablelm-1.6b's training shape, in turns (parent,
change, change, parent), each in a process of its own.

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
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
#: edges, ~2.6e8 embeddings, in waves; ``--fsm-full-depth`` also in one
#: wave), and at the
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
#: phase 11 (oracles and Table 1's graphs): the graphs of
#: tests/test_apps_vs_oracle.py (motifs: (seed, n, m, labels); cliques:
#: seeds of random_labeled(50, 180, 1); FSM: (seed, support, edges) on
#: random_labeled(40, 90, 2)), bench_large.py's SN graph and config
#: (paper Table 5), SN at 5x its scale, Patents at 1/100
ORACLE_MOTIFS = [(3, 60, 150, 3), (5, 30, 60, 1), (11, 45, 100, 5)]
ORACLE_CLIQUES = (0, 7)
ORACLE_FSM = [(3, 3, 3), (5, 2, 4), (9, 5, 3)]
SN_TABLE5 = 0.0004             # 2,009 vertices, 79,355 edges, D = 1,623
SN_WIDE = 0.002                # 10,045 vertices, 396,777 edges, D = 6,274
PATENTS = 0.01                 # 27,457 vertices, 139,654 edges, 37 labels
TABLE5_CFG = dict(chunk_size=16384, initial_capacity=1 << 16)
HOST_ROWS = 1024               # rows a block of the host's sparse products
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


def first_halo(torch, np, pg, g) -> dict:
    """The first size-2 chunk of the partitioned main path (the first
    ``CHUNK`` edges of ``g`` on ``pg``): its members, their halo's
    vertices, the halo (``halo_unique`` through the compaction kernel) and
    its flat rows in the shard-stacked tables, -1 past the halo."""
    from repro_torch.core import explore
    from repro_torch.kernels import gather

    dev = pg.device
    members = torch.from_numpy(g.edges[:CHUNK].astype(np.int32)).to(dev)
    n_valid = torch.full((CHUNK,), 2, dtype=torch.int32, device=dev)
    cap = explore.halo_cap(members.shape, "vertex", pg.n)
    verts = explore.halo_vertices(pg, members, n_valid, "vertex")
    uniq, count = gather.halo_unique(verts, pg.n, cap, use_kernel=True)
    fi, ok = pg.flat_index(uniq)
    return {"members": members, "n_valid": n_valid, "cap": cap,
            "verts": verts, "uniq": uniq, "count": count,
            "fi": torch.where(ok, fi, -1)}


def partition_checks(torch, np, G, g):
    """Phase 3, partitioned layout: the halo gather and the tile check
    against their plain versions at the shapes the first size-2 chunk of
    the partitioned main path gives them, and the gather's host time split
    into its pieces. Returns the two kernel rows and the partitioned graph
    (for the sync check)."""
    from repro_torch.core import explore
    from repro_torch.kernels import compact, gather
    from repro_torch.kernels.canonical_check.canonical_check import (
        canonical_check_tiles_cuda, canonical_check_tiles_ref, expand_masks,
    )

    pg = G.to_partitioned(g, PARTS)
    dev = pg.device
    halo = first_halo(torch, np, pg, g)
    members, n_valid, cap = halo["members"], halo["n_valid"], halo["cap"]
    verts, fi = halo["verts"], halo["fi"]
    c, k, d = members.shape[0], members.shape[1], pg.max_degree
    w = pg.adj_sh.shape[2]
    want = gather.halo_unique(verts, pg.n, cap, use_kernel=False)
    torch.cuda.synchronize()
    need(max_abs_err(torch, (halo["uniq"], halo["count"]), want) == 0,
         "halo_unique through the compaction kernel differs from its plain "
         "version")
    n_hit = int(halo["count"])
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
    info["gather_host_us"] = gather_host_pieces(
        torch, pg.nbr_sh.reshape(-1, d), fi, -1)

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


class Calibrations:
    """Records each calibration pilot (``costmodel.calibrate``) while it is
    entered: the seconds, the kernel launches the probes made (part of the
    run's launches) and the seconds of a kernel build the probes'
    first launches paid."""

    def __init__(self, build):
        self.build = build
        self.calls, self.seconds, self.build_seconds = 0, 0.0, 0.0
        self.launches = {}

    def __enter__(self):
        from repro_torch.core.runtime import costmodel

        self.mod, self.orig = costmodel, costmodel.calibrate

        def spy(*a, **k):
            before = dict(self.build.LAUNCHES)
            built = self.build.last_build_seconds
            t0 = time.perf_counter()
            try:
                return self.orig(*a, **k)
            finally:
                self.calls += 1
                self.seconds += time.perf_counter() - t0
                if self.build.last_build_seconds != built:
                    self.build_seconds += self.build.last_build_seconds
                for name, v in self.build.LAUNCHES.items():
                    if v - before[name]:
                        self.launches[name] = (self.launches.get(name, 0)
                                               + v - before[name])

        costmodel.calibrate = spy
        return self

    def __exit__(self, *exc):
        self.mod.calibrate = self.orig

    def record(self) -> dict:
        return {"calls": self.calls, "seconds": self.seconds,
                "build_seconds": self.build_seconds,
                "launches": dict(self.launches)}


def decision_line(cm) -> str:
    """One line of a decision table: its source, every knob, every timing."""
    knobs = ", ".join(f"{k}={cm[k]}" for k in (
        "async_chunks", "device_aggregate", "use_pallas", "compact_kernel",
        "aggregate_kernel", "aggregate_bin", "canonical_placement"))
    times = ", ".join(f"{k} {v}" for k, v in cm.get("timings", {}).items())
    return f"{cm['source']}: {knobs}; µs: {times}"


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
    one stacked drain per window of chunks) or, where the run's table
    chose the chunk loop, one a chunk plus its capacity retries; the
    record names the pipeline. ``clock`` (a
    :class:`HostClock`) is entered around the run, and ``more(step)`` adds
    fields to each step's record. Returns the record, the result and the
    :class:`Level2Tables` spy."""
    from repro_torch.core import aggregation
    from repro_torch.core.runtime.serial import _DRAIN_WINDOW

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with Level2Tables(aggregation) as spy, WaveLog() as waves, \
            Calibrations(build) as cal, clock or contextlib.nullcontext():
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
    fused = res.stats.cost_model["async_chunks"]
    pipeline = "fused" if fused else "chunk loop"
    for s, n_waves in zip(res.stats.steps, waves.per_step("cuda")):
        if fused:
            # each wave of a spilled step pilots and drains on its own
            bound = 2 * n_waves - 1 + math.ceil(s.n_chunks / _DRAIN_WINDOW)
        else:
            # the chunk loop (which a calibrated table may pick): one sync
            # a chunk, plus one a capacity retry; each retry lifts the
            # step's bucket to a larger power of two, from
            # initial_capacity to at most next_pow2(n_generated)
            bound = s.n_chunks + max(
                0, (max(s.n_generated, 1) - 1).bit_length()
                - (cfg.initial_capacity.bit_length() - 1))
        need(s.n_host_syncs <= (bound if s.n_chunks else 0),
             f"{label} step {s.step}: {s.n_host_syncs} host syncs for "
             f"{s.n_chunks} chunks in {n_waves} waves ({pipeline})")
        step = {"step": s.step, "waves": n_waves}
        step.update({k: getattr(s, f) for k, f in STEP_FIELDS.items()})
        step.update(more(s) if more else {})
        steps.append(step)
    rec = {"run": label, "wall_s": wall, "peak_bytes": peak,
           "pipeline": pipeline, "launches": launches, "steps": steps,
           "patterns": len(res.patterns),
           "chunk_signatures": len(res.stats.chunk_signatures),
           "cost_model": res.stats.cost_model, "level2": spy.calls,
           "calibration": cal.record()}
    log(f"  {label}: wall {wall:.3f} s, peak {peak / 2**30:.2f} GiB, "
        f"{len(res.patterns)} patterns, {pipeline}, launches {launches}")
    if cal.calls:
        log(f"    calibrated ({cal.calls} pilot): {cal.seconds:.3f} s, nvcc "
            f"{cal.build_seconds:.2f} s of it, launches {cal.launches}; "
            f"table {decision_line(res.stats.cost_model)}")
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
            refines = (launches["canonical_refine"] - rec["calibration"]
                       ["launches"].get("canonical_refine", 0))
            need(refines == 2 * len(spy.calls),
                 f"{label}: {refines} refine launches for "
                 f"{len(spy.calls)} device level-2 passes with orbits")
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

    OFF = RunConfig(cost_model="off")
    log(f"[7a] FSM: card port vs CPU port on citeseer_like({FSM_SMALL})")
    small = card_vs_cpu(torch, run, G.citeseer_like, [
        ("fsm", FSM_SMALL, FSMApp(**FSM_SMALL_APP), OFF),
        ("fsm_force_device", FSM_SMALL, FSMApp(**FSM_SMALL_APP),
         RunConfig(cost_model="force_device")),
        ("fsm_host_level1", FSM_SMALL, FSMApp(**FSM_SMALL_APP),
         RunConfig(cost_model="off", device_aggregate=False)),
        ("fsm_partitioned", FSM_SMALL, FSMApp(**FSM_SMALL_APP),
         RunConfig(cost_model="off", graph_partition=PARTS)),
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
            ("fsm_citeseer", cite, FSMApp(**FSM_MAIN_APP), OFF),
            ("fsm_citeseer_force_device", cite, FSMApp(**FSM_MAIN_APP),
             force),
            ("fsm_citeseer_partitioned", cite, FSMApp(**FSM_MAIN_APP),
             RunConfig(cost_model="off", graph_partition=PARTS)),
            ("fsm_mico_domains", G.mico_like(0.1), FSMApp(**FSM_STRESS_APP),
             RunConfig()),
            ("fsm_citeseer4", deep, FSMApp(**FSM_DEEP_APP), OFF),
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
        res = run(make(scale), app, RunConfig(cost_model="off"), device="cpu")
        return max(s.frontier_bytes for s in res.stats.steps)

    motifs, fsm = MotifsApp(max_size=3), FSMApp(**FSM_SMALL_APP)
    budget = peak(G.mico_like, STORE_SMALL, motifs) // 8
    fsm_budget = peak(G.citeseer_like, FSM_SMALL, fsm) // 8
    log(f"[8a] stores: card port vs CPU port on mico_like({STORE_SMALL}) "
        f"(motifs budget {budget} B, an eighth of the peak frontier), "
        f"mico_like({STORE_TINY}) and citeseer_like({FSM_SMALL}) (FSM "
        f"budget {fsm_budget} B)")
    off = dict(cost_model="off")
    cases = [
        ("motifs4_odag", G.mico_like, STORE_TINY, MotifsApp(max_size=4),
         RunConfig(store="odag", **off)),
        ("motifs_odag", G.mico_like, STORE_SMALL, motifs,
         RunConfig(store="odag", **off)),
        ("cliques_odag", G.mico_like, STORE_SMALL, CliquesApp(max_size=4),
         RunConfig(store="odag", **off)),
        ("motifs_spill_raw", G.mico_like, STORE_SMALL, motifs,
         RunConfig(device_budget_bytes=budget, **off)),
        ("motifs_spill_odag", G.mico_like, STORE_SMALL, motifs,
         RunConfig(store="odag", device_budget_bytes=budget, **off)),
        ("fsm_odag", G.citeseer_like, FSM_SMALL, fsm,
         RunConfig(store="odag", **off)),
        ("fsm_spill_odag", G.citeseer_like, FSM_SMALL, fsm,
         RunConfig(store="odag", device_budget_bytes=fsm_budget, **off)),
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
                                      app, RunConfig(store="odag",
                                                     cost_model="off"),
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


def fsm_depth_runs(torch, run, RunConfig, G, build, totals, fewer_edges=None,
                   one_wave=True):
    """Phase 8c (and ``--fsm-full-depth``): the paper's FSM graph at its
    depth, ``citeseer_like(1.0)``, support 25, to 4 edges, under
    ``device_budget_bytes = FSM_DEPTH_BUDGET`` (waves per step logged),
    then, given ``one_wave``, without a budget, in one wave a step: a
    frequent pattern of 4 edges, every support at or above 25, the same
    patterns in both runs and, given ``fewer_edges`` (7b's patterns to 3
    edges), the same patterns of up to 3 edges. A run that runs the card
    out of memory is logged with the failed allocation, where it was made
    and the peak, and fails the phase."""
    from repro_torch.core.apps import FSMApp

    app = FSMApp(**dict(FSM_MAIN_APP, max_size=4))
    g = G.citeseer_like(1.0)
    cases = [("fsm_citeseer_4edges_budget",
              RunConfig(device_budget_bytes=FSM_DEPTH_BUDGET))]
    if one_wave:
        cases.append(("fsm_citeseer_4edges", RunConfig()))
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
    need(len(results) == len(cases), f"FSM to 4 edges ran out of device "
         "memory: "
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
    if one_wave:
        need(results["fsm_citeseer_4edges"].patterns == base.patterns,
             "FSM to 4 edges: the budgeted and the one-wave runs differ")
        log("  the one-wave run: identical patterns")
    return out


# ---------------------------------------------------------------------------
# Phase 9: the runtime's control plane (cost model, checkpoints, supervisor,
# tracing)
# ---------------------------------------------------------------------------

#: child of 9a: resolve the FSM table from the directory the parent filled
CACHE_CHILD = """
import json, sys
from repro_torch.core import RunConfig, graph as G, to_device
from repro_torch.core.apps import FSMApp
from repro_torch.core.runtime import costmodel
_, t = costmodel.resolve(RunConfig(cost_model_dir=sys.argv[1]),
                         to_device(G.citeseer_like(1.0)),
                         FSMApp(**json.loads(sys.argv[2])), "serial")
print(json.dumps(t.as_dict()))
"""

#: child of 9b: the checkpointed motif run, killed at step 3's aggregation
#: (size-3 motifs expand at steps 1 and 2 only)
EXIT_CHILD = """
import sys
from repro_torch.core import FaultPlan, RunConfig, graph as G, run
from repro_torch.core.apps import MotifsApp
run(G.mico_like(0.1), MotifsApp(max_size=3),
    RunConfig(checkpoint_dir=sys.argv[1], checkpoint_every=1,
              faults=FaultPlan([("aggregate", 3, "exit")])))
raise SystemExit("the exit fault never tripped")
"""

#: child of 9c: a real allocation past a per-process memory cap
OOM_CHILD = """
import torch
from repro_torch.core.runtime import faults
torch.cuda.set_per_process_memory_fraction(0.01)
try:
    torch.empty(8 << 30, dtype=torch.uint8, device="cuda")
except Exception as e:
    print(type(e).__name__, faults.classify_failure(e))
else:
    raise SystemExit("8 GiB allocated under a 1 % cap")
"""


def child(script, *args, timeout=600):
    """Run ``script`` in a Python process of its own on the card, with
    this checkout's ``src`` on its path."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-c", script, *map(str, args)],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


CONTROL_STEP_FIELDS = ("n_frontier", "n_children", "n_chunks",
                       "n_host_syncs", "t_expand", "t_aggregate",
                       "t_storage", "t_checkpoint", "t_gather", "n_retries",
                       "t_recovery")


def control_plane_phase(torch, np, G, build, motifs5, fsm7b):
    """Phase 9: the runtime's control plane on the card, through the entry
    points a user calls. 9a the pilot-calibrated cost model (``auto``) on
    mico_like(0.1) motifs and citeseer_like(1.0) FSM, its process cache and
    its disk cache read back by a child process; 9b checkpoints, resume
    from the step-2 cut (raw and ODAG stores) and from what a child killed
    at step 3 left; 9c ``run_supervised`` under injected faults (crash,
    OOM, corruption, saturation; FSM with domains; a thrice-repeated
    expansion crash, whose ladder stops before the plain versions),
    bit-identical to the clean runs within 1.1x their peak, and a real OOM
    in a child
    classified ``oom``; 9d tracing (schema, coverage >= 0.95, no extra host
    sync, a device-memory gauge), ``trace_sync`` on the partitioned layout
    and ``log_every``. ``motifs5`` is phase 5's motif result, ``fsm7b`` 7b's
    FSM patterns to 3 edges."""
    from repro_torch.core import (
        FaultPlan, RunConfig, SuperstepRuntime, obs, resume, run,
        run_supervised,
    )
    from repro_torch.core.apps import FSMApp, MotifsApp
    from repro_torch.core.runtime import checkpoint as ckpt_lib
    from repro_torch.core.runtime import costmodel, faults, loop

    t_phase = time.perf_counter()
    totals = {name: 0 for name in build.LAUNCHES}
    runs, out = [], {}
    mico, cite = G.mico_like(0.1), G.citeseer_like(1.0)
    motifs = lambda: MotifsApp(max_size=3)      # noqa: E731
    fsm = lambda: FSMApp(**FSM_MAIN_APP)        # noqa: E731
    clean_results = []          # every run of the phase with no fault
    retries = []                # every failure the supervisor retried
    release = loop._release_attempt

    def spy_release(exc, kind, device):
        retries.append(kind)
        return release(exc, kind, device)

    def timed(label, fn, clean=True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        with Calibrations(build) as cal:
            build.reset_launches()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(build.LAUNCHES)
        for name, v in launches.items():
            totals[name] += v
        rec = {"run": label, "wall_s": wall,
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "launches": {k: v for k, v in launches.items() if v},
               "calibration": cal.record(),
               "cost_model": res.stats.cost_model, "recovery": res.recovery,
               "patterns": len(res.patterns),
               "steps": [{"step": s.step, **{f: getattr(s, f)
                                             for f in CONTROL_STEP_FIELDS}}
                         for s in res.stats.steps]}
        runs.append(rec)
        if clean:
            clean_results.append((label, res))
        log(f"  {label}: wall {wall:.3f} s, peak "
            f"{rec['peak_bytes'] / 2**30:.2f} GiB, {len(res.patterns)} "
            f"patterns, source {res.stats.cost_model['source']}, recovery "
            f"{res.recovery}")
        for st in rec["steps"]:
            log("    " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in st.items()))
        return rec, res

    work = Path(tempfile.mkdtemp(prefix="chip-smoke-control-"))
    loop._release_attempt = spy_release
    try:
        # ---- 9a: the cost model ------------------------------------------
        log("[9a] cost model 'auto': size-3 motifs on mico_like(0.1) "
            f"({mico.m} edges), FSM {FSM_MAIN_APP} on citeseer_like(1.0) "
            f"({cite.m} edges); each run twice")
        costmodel.clear_cache()
        tables = {}
        for label, g, mk, want in (("motifs_auto", mico, motifs,
                                    motifs5.patterns),
                                   ("fsm_auto", cite, fsm, fsm7b)):
            for turn in ("first", "again"):
                clock = HostClock(resolve=(costmodel, "resolve"))
                with clock:
                    rec, res = timed(f"{label}_{turn}",
                                     lambda: run(g, mk(), RunConfig()))
                rec["resolve_s"] = clock.seconds["resolve"]
                cm = res.stats.cost_model
                log(f"    resolve {rec['resolve_s']:.3f} s; table "
                    f"{decision_line(cm)}")
                need(cm["source"] == "calibrated",
                     f"{label}: the table's source is {cm['source']}")
                need(all(cm[k] is True for k in (
                    "use_pallas", "compact_kernel", "aggregate_kernel")),
                     f"{label}: a kernel knob is off on the card: {cm}")
                need(res.patterns == want, f"{label}: patterns differ from "
                     "the cost_model='off' run of phase 5 or 7b")
                need(rec["calibration"]["calls"] == (turn == "first"),
                     f"{label} {turn}: {rec['calibration']['calls']} pilots")
                if turn == "again":
                    need(cm == tables[label], f"{label}: the second run's "
                         "table differs from the first's")
                tables[label] = cm
        out["tables"] = tables
        cache_dir = work / "costmodel"
        costmodel.clear_cache()
        _, table = costmodel.resolve(
            RunConfig(cost_model_dir=str(cache_dir)), G.to_device(cite),
            fsm(), "serial")
        need(table.source == "calibrated" and list(cache_dir.glob("*.json")),
             f"the FSM table was not written to {cache_dir}")
        t0 = time.perf_counter()
        proc = child(CACHE_CHILD, cache_dir, json.dumps(FSM_MAIN_APP))
        need(proc.returncode == 0, f"cache child failed:\n{proc.stderr}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        need(got["source"] == "cached" and all(
            got[k] == getattr(table, k) for k in costmodel.DECIDED_KNOBS),
            f"the child did not load the table back: {got}")
        out["cache_child_s"] = time.perf_counter() - t0
        log(f"  a child process loaded the FSM table back as 'cached' "
            f"({out['cache_child_s']:.1f} s)")

        # ---- 9b: checkpoint and resume -----------------------------------
        log("[9b] checkpoints: size-3 motifs on mico_like(0.1), "
            "checkpoint_every=1")
        ck = work / "ckpt"
        rec, res = timed("motifs_checkpointed", lambda: run(
            mico, motifs(), RunConfig(checkpoint_dir=str(ck),
                                      checkpoint_every=1)))
        need(res.patterns == motifs5.patterns,
             "checkpointed motifs differ from phase 5's")
        cuts = {}
        for s in res.stats.steps:
            path = Path(ckpt_lib.checkpoint_path(str(ck), s.step + 1))
            if path.exists():
                cuts[s.step] = {"bytes": path.stat().st_size,
                                "t_checkpoint": s.t_checkpoint}
        rec["checkpoints"] = cuts
        log(f"    cuts by step: {cuts}")
        need(2 in cuts and cuts[2]["t_checkpoint"] > 0,
             f"no step-2 checkpoint: {cuts}")
        step2 = ckpt_lib.checkpoint_path(str(ck), 3)
        rec, res2 = timed("motifs_resumed_step2",
                          lambda: resume(mico, motifs(), step2))
        need(res2.patterns == motifs5.patterns,
             "motifs resumed from the step-2 cut differ from phase 5's")
        need([s.n_children for s in res2.stats.steps]
             == [s.n_children for s in res.stats.steps],
             "the resumed run's children per step differ")
        shutil.rmtree(ck)
        killed = work / "killed"
        t0 = time.perf_counter()
        proc = child(EXIT_CHILD, killed)
        need(proc.returncode == faults.EXIT_CODE,
             f"the child exited with {proc.returncode}, not "
             f"{faults.EXIT_CODE}:\n{proc.stderr[-3000:]}")
        latest = ckpt_lib.latest_checkpoint(str(killed))
        need(latest is not None, "the killed child left no checkpoint")
        out["exit_child"] = {"seconds": time.perf_counter() - t0,
                             "exit_code": proc.returncode,
                             "latest": Path(latest).name}
        log(f"  the child exited with code {proc.returncode} at step 3's "
            f"aggregation; newest cut {Path(latest).name}")
        rec, res3 = timed("motifs_resumed_after_exit",
                          lambda: resume(mico, motifs(), str(killed)))
        need(res3.patterns == motifs5.patterns,
             "motifs resumed after the child's exit differ from phase 5's")
        shutil.rmtree(killed)
        od = work / "odag"
        odag = RunConfig(store="odag", checkpoint_dir=str(od))
        rec, res4 = timed("motifs_odag_checkpointed",
                          lambda: run(mico, motifs(), odag))
        rec["checkpoints"] = {
            s.step: Path(ckpt_lib.checkpoint_path(str(od), s.step + 1))
            .stat().st_size for s in res4.stats.steps[:-1]}
        rec, res5 = timed("motifs_odag_resumed_step2", lambda: resume(
            mico, motifs(), ckpt_lib.checkpoint_path(str(od), 3),
            RunConfig(store="odag")))
        need(res4.patterns == res5.patterns == motifs5.patterns,
             "ODAG-store checkpointed or resumed motifs differ")
        shutil.rmtree(od)

        # ---- 9c: supervised recovery -------------------------------------
        log("[9c] run_supervised under injected faults: size-3 motifs on "
            "mico_like(0.1), FSM on citeseer_like(1.0)")
        clean_rec, clean = timed("motifs_supervised_clean",
                                 lambda: run_supervised(mico, motifs()))
        need(clean.patterns == motifs5.patterns,
             "supervised clean motifs differ from phase 5's")
        cases = [
            ("crash_aggregate2", [("aggregate", 2, "crash")], [], {}),
            ("oom_expand2", [("expand", 2, "oom")],
             [f"budget_capped:{faults._BUDGET_SEED}"], {}),
            ("corrupt_rollback", [("checkpoint", 2, "corrupt"),
                                  ("aggregate", 3, "crash")], [],
             {"rolled_back": 1, "resumed_step": 2}),
        ]
        recovered = {}
        for label, specs, rungs, more in cases:
            plan = FaultPlan(specs)
            rec, res = timed(
                f"motifs_supervised_{label}",
                lambda: run_supervised(mico, motifs(),
                                       RunConfig(faults=plan)),
                clean=False)
            rep = res.recovery
            need(plan.fired == [tuple(x) for x in specs],
                 f"{label}: fired {plan.fired}")
            need(res.patterns == clean.patterns
                 and [s.n_children for s in res.stats.steps]
                 == [s.n_children for s in clean.stats.steps],
                 f"{label}: the recovered run differs from the clean run")
            need(rep is not None and rep["n_retries"] == 1
                 and rep["degradations"] == rungs
                 and all(rep[k] == v for k, v in more.items()),
                 f"{label}: recovery report {rep}")
            marked = [s for s in res.stats.steps if s.n_retries]
            need([s.step for s in marked] == [2] and marked[0].t_recovery > 0,
                 f"{label}: the retry was stamped on steps "
                 f"{[s.step for s in marked]}")
            need(rec["peak_bytes"] <= 1.1 * clean_rec["peak_bytes"],
                 f"{label}: peak {rec['peak_bytes']} > 1.1 x the clean "
                 f"run's {clean_rec['peak_bytes']}")
            recovered[label] = {"t_recovery": marked[0].t_recovery,
                                "report": rep,
                                "peak_ratio": rec["peak_bytes"]
                                / clean_rec["peak_bytes"]}
        plan = FaultPlan([("aggregate", 2, "saturate")])
        rec, res = timed("motifs_supervised_saturate", lambda: run_supervised(
            mico, motifs(), RunConfig(faults=plan, device_aggregate=True)))
        need(plan.fired == [("aggregate", 2, "saturate")]
             and res.recovery is None and res.patterns == clean.patterns,
             f"saturate: fired {plan.fired}, recovery {res.recovery}")
        # on the card the ladder ends before the kernels' plain routes: a
        # thrice-repeated expand crash takes fused_off (the CPU would go on
        # to pallas_off) and the last retry runs on the kernels
        plan = FaultPlan([("expand", 2, "crash", 3)])
        rec, res = timed("motifs_supervised_expand_crash_x3", lambda: (
            run_supervised(mico, motifs(), RunConfig(faults=plan))),
            clean=False)
        rep = res.recovery
        need(len(plan.fired) == 3 and res.patterns == clean.patterns
             and rep["n_retries"] == 3 and rep["degradations"] == ["fused_off"]
             and all(res.stats.cost_model[k] is True for k in (
                 "use_pallas", "compact_kernel", "aggregate_kernel")),
             f"expand crash x3: fired {plan.fired}, recovery {rep}, table "
             f"{res.stats.cost_model}")
        need(rec["peak_bytes"] <= 1.1 * clean_rec["peak_bytes"],
             f"expand crash x3: peak {rec['peak_bytes']} > 1.1 x the clean "
             f"run's {clean_rec['peak_bytes']}")
        recovered["expand_crash_x3"] = {
            "t_recovery": next(s.t_recovery for s in res.stats.steps
                               if s.n_retries),
            "report": rep,
            "peak_ratio": rec["peak_bytes"] / clean_rec["peak_bytes"]}
        fclean_rec, fclean = timed("fsm_supervised_clean",
                                   lambda: run_supervised(cite, fsm()))
        plan = FaultPlan([("aggregate", 2, "crash")])
        rec, res = timed("fsm_supervised_crash_aggregate2",
                         lambda: run_supervised(cite, fsm(),
                                                RunConfig(faults=plan)),
                         clean=False)
        need(res.patterns == fclean.patterns == fsm7b,
             "the recovered FSM run differs from the clean run")
        need(res.recovery["n_retries"] == 1
             and res.recovery["degradations"] == [],
             f"FSM recovery report {res.recovery}")
        need(rec["peak_bytes"] <= 1.1 * fclean_rec["peak_bytes"],
             f"FSM: peak {rec['peak_bytes']} > 1.1 x the clean run's "
             f"{fclean_rec['peak_bytes']}")
        recovered["fsm_crash_aggregate2"] = {
            "t_recovery": next(s.t_recovery for s in res.stats.steps
                               if s.n_retries),
            "report": res.recovery,
            "peak_ratio": rec["peak_bytes"] / fclean_rec["peak_bytes"]}
        out["recovered"] = recovered
        proc = child(OOM_CHILD, timeout=300)
        need(proc.returncode == 0 and proc.stdout.split()[-1:] == ["oom"],
             f"a real OOM was not classified 'oom': {proc.stdout} "
             f"{proc.stderr[-2000:]}")
        out["real_oom"] = proc.stdout.strip()
        log(f"  a real allocation past a 1 % memory cap in a child: "
            f"{out['real_oom']}")

        # ---- 9d: tracing ---------------------------------------------------
        log("[9d] tracing: size-3 motifs on mico_like(0.1)")
        _, plain = timed("motifs_untraced", lambda: run(mico, motifs()))
        rec, traced = timed("motifs_traced", lambda: run(
            mico, motifs(), RunConfig(trace=True,
                                      trace_dir=str(work / "trace"))))
        doc = json.load(open(traced.trace_path))
        problems = obs.validate_chrome_trace(doc)
        cov = obs.phase_coverage(doc)
        gauges = doc["otherData"]["metrics"]["gauges"]
        rec.update(trace_events=len(doc["traceEvents"]), coverage=cov,
                   device_bytes_in_use=gauges.get("device_bytes_in_use"))
        log(f"    trace: {len(doc['traceEvents'])} events, problems "
            f"{problems}, coverage {cov}, device bytes in use "
            f"{gauges.get('device_bytes_in_use')}")
        need(problems == [], f"the Chrome trace is malformed: {problems}")
        need(cov["coverage"] >= 0.95, f"phase coverage {cov}")
        need(traced.patterns == plain.patterns,
             "traced motifs differ from untraced")
        need([s.n_host_syncs for s in traced.stats.steps]
             == [s.n_host_syncs for s in plain.stats.steps],
             "tracing changed the host syncs per step")
        need(gauges.get("device_bytes_in_use") is not None,
             f"no device-memory gauge: {gauges}")
        holder = {}

        def synced():
            # the gather probe and the expansion's fence belong to the
            # fused pipeline (the chunk loop carries nothing to fence),
            # which a calibrated table may not pick
            holder["rt"] = SuperstepRuntime(mico, motifs(), RunConfig(
                graph_partition=PARTS, trace=True, trace_sync=True,
                async_chunks=True))
            return holder["rt"].run()

        rec, part = timed("motifs_partitioned_trace_sync", synced)
        fences = holder.pop("rt").observer.tracer.n_fences
        rec["n_fences"] = fences
        need(part.patterns == plain.patterns,
             "partitioned trace_sync motifs differ")
        need(any(s.t_gather > 0 for s in part.stats.steps) and fences > 0,
             f"trace_sync: t_gather {[s.t_gather for s in part.stats.steps]}"
             f", {fences} fences")
        need(rec["launches"].get("gather_rows", 0) > 0,
             "gather_rows never launched in the partitioned run")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, logged = timed("motifs_log_every", lambda: run(
                mico, motifs(), RunConfig(log_every=1)))
        lines = buf.getvalue().splitlines()
        for line in lines:
            log(line)
        steps = [ln for ln in lines if ln.startswith("[obs] step=")]
        need(len(steps) == len(logged.stats.steps),
             f"{len(steps)} progress lines for {len(logged.stats.steps)} "
             "supersteps")

        # ---- no run outside the injected faults recovered ------------------
        need(retries == ["crash", "oom", "crash"] + ["crash"] * 3
             + ["crash"],
             f"the supervisor retried {retries}")
        stray = [label for label, res in clean_results
                 if res.recovery is not None]
        need(not stray, f"runs without a fault have a recovery report: "
             f"{stray}")
    finally:
        loop._release_attempt = release
        shutil.rmtree(work, ignore_errors=True)
    out["runs"] = runs
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 9: {out['seconds']:.1f} s")
    return totals, out


# ---------------------------------------------------------------------------
# Phase 10: the distributed backend (the shard-map superstep, paper §5.1-5.3)
# ---------------------------------------------------------------------------

SHARD_FIELDS = INT_FIELDS + ("collective_bytes",)
#: 10a's graphs: the card-vs-CPU runs, and the naive aggregation's (it
#: canonicalises every embedding on the host, ~0.1 ms a row, on both sides)
SHARD_SMALL = 0.005
SHARD_NAIVE = 0.002


class HostAggregation:
    """Counts the shard-map backend's host aggregation path
    (``ShardMapBackend.quick_codes``: every embedding's codes to the
    host), which a run under device aggregation must not take on the
    card: an overflowing per-worker table is re-binned there."""

    def __init__(self):
        from repro_torch.core.runtime.shard import ShardMapBackend
        self.cls, self.orig = ShardMapBackend, ShardMapBackend.quick_codes
        self.calls = 0

    def __enter__(self):
        def counted(backend, blocks, size):
            self.calls += 1
            return self.orig(backend, blocks, size)

        self.cls.quick_codes = counted
        return self

    def __exit__(self, *exc):
        self.cls.quick_codes = self.orig


def shard_counters(res):
    return [{f: getattr(s, f) for f in SHARD_FIELDS} for s in res.stats.steps]


def shard_run(torch, build, totals, label, g, app, cfg, device=None,
              workers=PARTS, halo_graph=None):
    """One ``run_distributed`` over ``workers`` virtual workers on the card
    (or on ``device``), its kernels counted (zeroed just before, read just
    after, added to ``totals``): wall, peak, per step the phase times,
    syncs (<= 2), collective bytes and, given the run's partitioned graph
    ``halo_graph`` (raw store), the halo bytes of each step's slices
    (``shard.halo_bytes``, the count the backend adds to
    ``collective_bytes``). On the card a run under device aggregation must
    not take the host aggregation path. Returns (record, result)."""
    from repro_torch.core.distributed import make_mesh, run_distributed
    from repro_torch.core.runtime import shard

    mesh = make_mesh((workers,), ("data",), device=device)
    on_card = device is None
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
    with HostAggregation() as host:
        build.reset_launches()
        t0 = time.perf_counter()
        res = run_distributed(g, app, mesh, cfg)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    if not on_card:
        return None, res
    need(host.calls == 0 or cfg.naive_aggregation
         or cfg.device_aggregate is False,
         f"{label}: {host.calls} steps took the host aggregation path on "
         "the card")
    for name, v in launches.items():
        totals[name] += v
    peak = torch.cuda.max_memory_allocated()
    steps = []
    for s in res.stats.steps:
        need(s.n_host_syncs <= 2,
             f"{label} step {s.step}: {s.n_host_syncs} host syncs")
        per = max(-(-s.n_frontier // workers), 1)
        hb = (shard.halo_bytes(halo_graph, app.mode, cfg.resolve_halo(),
                               per, s.size) * s.n_chunks
              if halo_graph is not None else 0)
        need(hb <= s.collective_bytes,
             f"{label} step {s.step}: halo {hb} B past the collective's "
             f"{s.collective_bytes} B")
        steps.append({
            "step": s.step, "frontier": s.n_frontier,
            "children": s.n_children, "n_chunks": s.n_chunks,
            "n_host_syncs": s.n_host_syncs,
            "collective_bytes": s.collective_bytes, "halo_bytes": hb,
            "bytes_to_host": s.bytes_to_host, "t_expand": s.t_expand,
            "t_aggregate": s.t_aggregate, "t_canon": s.t_canon,
            "t_storage": s.t_storage, "t_exchange": s.t_exchange})
    rec = {"run": label, "workers": workers, "wall_s": wall,
           "peak_bytes": peak, "launches": launches, "steps": steps,
           "host_aggregation_steps": host.calls,
           "patterns": len(res.patterns),
           "collective_bytes": sum(s.collective_bytes
                                   for s in res.stats.steps)}
    log(f"  {label}: wall {wall:.3f} s, peak {peak / 2**30:.2f} GiB, "
        f"{len(res.patterns)} patterns, collective "
        f"{rec['collective_bytes']} B, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    for st in steps:
        log(f"    step {st['step']}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in st.items() if k != "step"))
    return rec, res


def same_sets(np, a, b) -> bool:
    """Embeddings of two runs equal as sets, size by size."""
    if sorted(a.embeddings) != sorted(b.embeddings):
        return False
    return all(
        a.embeddings[k].shape == b.embeddings[k].shape and np.array_equal(
            np.unique(a.embeddings[k], axis=0),
            np.unique(b.embeddings[k], axis=0))
        for k in b.embeddings)


def shard_step_is_sync_free(torch, np, G):
    """One superstep over the four workers under sync debug mode "error",
    its inputs uploaded before and each control read made after: the
    expansion (whole graph with the fused kernel, and partitioned with
    the all-to-all halo exchange), then on the fused step's carried codes
    the two-level aggregation collective (the local bins, the gathered
    re-bin, the psum and the max of the local counts; sort and radix bin)
    and the FSM domain scatter with its OR. None of them takes a host
    sync."""
    from repro_torch.core import aggregation
    from repro_torch.core.apps import MotifsApp
    from repro_torch.core.runtime import shard
    from repro_torch.core.runtime.config import next_pow2

    g = G.mico_like(0.1)
    mesh = shard.make_mesh((PARTS,), ("data",))
    devs = mesh.worker_devices(("data",))
    app = MotifsApp(max_size=3)
    padded, counts = shard.partition_frontier(
        g.edges.astype(np.int32), PARTS)
    members, n_valid = shard._upload_parts(padded, counts, 2, devs)
    dg = G.to_device(g)
    pg = G.to_partitioned(g, PARTS)
    out_cap = 1 << 25        # the largest worker count is past 2^23

    def no_sync(fn):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")

    out, carried = {}, None
    for label, step, graphs, kw in (
        ("whole_fused", shard.make_sharded_expand(
            app, mesh, use_pallas=True, fused=True, compact_kernel=True,
            with_patterns=True, with_local_verts=True),
         [dg] * PARTS, {}),
        ("partitioned_alltoall", shard.make_sharded_expand_partitioned(
            app, mesh, halo="alltoall", use_pallas=True, compact_kernel=True,
            with_patterns=True, with_local_verts=False),
         [shard.local_shard(pg, s, d) for s, d in enumerate(devs)],
         {"w": pg.n_parts, "rows": pg.tile_rows, "n": pg.n}),
    ):
        outs = no_sync(lambda: step(graphs, members, n_valid, out_cap, **kw))
        cnt = torch.stack([c.to(torch.int64) for c in outs[1]]).cpu()
        out[label] = [int(c) for c in cnt]
        if carried is None:
            carried = (outs[4], outs[5])
        del outs
    need(out["whole_fused"] == out["partitioned_alltoall"]
         and sum(out["whole_fused"]) > 0
         and max(out["whole_fused"]) <= out_cap,
         f"sync-free shard steps disagree: {out}")
    del pg, members, n_valid

    codes, lv = carried
    valid = [torch.arange(out_cap, device=d) < c
             for c, d in zip(out["whole_fused"], devs)]
    local_cap = 1 << 17
    global_cap = PARTS * local_cap
    agg = {}
    for method in ("sort", "radix"):
        qbin = shard.make_sharded_quick_bin(mesh, use_kernel=True,
                                            bin_method=method)
        gu, gcounts, gn, nmax, row_slot = no_sync(
            lambda: qbin(codes, valid, local_cap, global_cap))
        n, m = (int(x) for x in torch.stack([gn.to(torch.int64),
                                             nmax]).cpu())
        need(0 < n and m <= local_cap,
             f"sync-free quick bin ({method}): {n} distinct, largest local "
             f"table {m} of {local_cap}")
        agg[method] = (n, int(gcounts.sum()))
    need(agg["sort"] == agg["radix"]
         and agg["sort"][1] == sum(out["whole_fused"]),
         f"sync-free quick bins disagree: {agg}")
    uniq, counts_q, _ = aggregation.drain_distinct(
        gu, gcounts, n, w1_used=True, w2_used=True, fit32=False)
    # the scatter reads sigma, not the orbits (the memo is warm from 10b)
    table, _ = aggregation.finish_quick_level2(uniq, counts_q, False)
    pc = len(table.canon_codes)
    tables = {d: aggregation.level2_device_tables(table, global_cap, d)
              for d in set(devs)}
    scat = shard.make_sharded_domain_scatter(mesh)
    bm = no_sync(lambda: scat(row_slot, lv, tables, next_pow2(pc), g.n))
    n_bits = int(bm[:pc].sum())
    need(n_bits > 0, "sync-free domain scatter set no bit")
    out["quick_bin"] = {"distinct": agg["sort"][0], "canonical": pc,
                        "domain_bits": n_bits}
    del dg, codes, lv, valid, gu, gcounts, row_slot, bm, carried
    torch.cuda.empty_cache()
    return out


def distributed_phase(torch, np, G, build, motifs5, cliques5, fsm7b):
    """Phase 10: the shard-map backend through ``run_distributed`` on a
    mesh of four virtual workers on the card (``make_mesh((4,),
    ("data",))``; the workers share the card, so their collectives are
    copies within it), ``cost_model="off"``. 10a the card against the CPU
    (per-step counters, ``collective_bytes`` included); 10b the main path
    on mico_like(0.1), each run equal to phase 5's; 10c 7b's FSM under the
    dense ODAG exchange; 10d an elastic resume and a supervised ``halo``
    fault. ``motifs5``/``cliques5`` are phase 5's runs, ``fsm7b`` 7b's
    patterns."""
    import dataclasses

    from repro_torch.core import FaultPlan, RunConfig, resume, run_supervised
    from repro_torch.core.apps import CliquesApp, FSMApp, MotifsApp
    from repro_torch.core.runtime import ShardMapBackend, make_mesh
    from repro_torch.core.runtime import checkpoint as ckpt_lib

    t_phase = time.perf_counter()
    totals = {name: 0 for name in build.LAUNCHES}
    out = {"workers": PARTS}
    off = RunConfig(cost_model="off")
    motifs = lambda: MotifsApp(max_size=3)      # noqa: E731
    cliques = lambda: CliquesApp(max_size=4)    # noqa: E731

    # ---- 10a: card against CPU --------------------------------------------
    log(f"[10a] shard-map backend, {PARTS} workers: card vs CPU on "
        f"mico_like({SHARD_SMALL}) and citeseer_like({FSM_SMALL})")
    small = {}
    cases = [
        ("motifs", SHARD_SMALL, motifs, {}),
        ("cliques", SHARD_SMALL, cliques, {}),
        ("motifs_alltoall", SHARD_SMALL, motifs,
         dict(graph_partition=PARTS)),
        ("motifs_gather", SHARD_SMALL, motifs,
         dict(graph_partition=PARTS, halo="gather")),
        ("cliques_alltoall", SHARD_SMALL, cliques,
         dict(graph_partition=PARTS)),
        ("cliques_gather", SHARD_SMALL, cliques,
         dict(graph_partition=PARTS, halo="gather")),
        ("motifs_odag", SHARD_SMALL, motifs, dict(store="odag")),
        ("motifs_two_level", SHARD_NAIVE, motifs, {}),
        ("motifs_naive", SHARD_NAIVE, motifs,
         dict(naive_aggregation=True)),
        ("fsm", None, lambda: FSMApp(**FSM_SMALL_APP), {}),
    ]
    for name, scale, mk, kw in cases:
        g = (G.citeseer_like(FSM_SMALL) if scale is None
             else G.mico_like(scale))
        cfg = dataclasses.replace(off, **kw)
        # the CPU run recovers from an overflowing per-worker table as the
        # card does (a re-bin on the workers' devices, not the host path),
        # so the two runs take one path and every counter compares
        ShardMapBackend.refold_on_device = True
        try:
            _, cpu = shard_run(torch, build, totals, name, g, mk(), cfg,
                               device="cpu")
        finally:
            ShardMapBackend.refold_on_device = None
        _, gpu = shard_run(torch, build, {k: 0 for k in totals}, name, g,
                           mk(), cfg)
        need(cpu.patterns == gpu.patterns, f"10a {name}: patterns differ")
        need(same_sets(np, cpu, gpu), f"10a {name}: embeddings differ")
        need(shard_counters(cpu) == shard_counters(gpu),
             f"10a {name}: step counters differ:\n{shard_counters(cpu)}\n"
             f"{shard_counters(gpu)}")
        need(sum(s.collective_bytes for s in gpu.stats.steps) > 0,
             f"10a {name}: no collective bytes")
        small[name] = {"patterns": len(gpu.patterns),
                       "steps": shard_counters(gpu)}
        log(f"  {name}: {len(gpu.patterns)} patterns, "
            f"{[s.n_children for s in gpu.stats.steps]} children, "
            f"collective {[s.collective_bytes for s in gpu.stats.steps]} B, "
            "identical")
    two = sum(s["collective_bytes"] for s in small["motifs_two_level"]["steps"])
    naive = sum(s["collective_bytes"] for s in small["motifs_naive"]["steps"])
    out["table4_collective_ratio"] = naive / two
    log(f"  Table 4: naive / two-level collective bytes {naive} / {two} = "
        f"{naive / two:.2f} (mico_like({SHARD_NAIVE}), size-3 motifs)")
    out["card_vs_cpu"] = small

    # ---- 10b: the main path --------------------------------------------------
    log(f"[10b] main path on mico_like(0.1), {PARTS} workers on the card, "
        f"default agg_qcap {off.agg_qcap}")
    g = G.mico_like(0.1)
    # the partitioned runs' graph, for their halo bytes
    pg = G.to_partitioned(g, PARTS)
    runs, results = [], {}
    for label, mk, cfg in (
        ("motifs_fused_device", motifs, dataclasses.replace(
            off, fused_expand=True, aggregate_bin="radix",
            canonical_placement="device")),
        ("motifs_alltoall", motifs, dataclasses.replace(
            off, graph_partition=PARTS)),
        ("motifs_odag", motifs, dataclasses.replace(off, store="odag")),
        ("cliques_alltoall", cliques, dataclasses.replace(
            off, graph_partition=PARTS)),
        # the halo exchange timed on its own (t_exchange) under trace_sync
        ("motifs_alltoall_trace_sync", motifs, dataclasses.replace(
            off, graph_partition=PARTS, trace=True, trace_sync=True)),
    ):
        rec, results[label] = shard_run(
            torch, build, totals, label, g, mk(), cfg,
            halo_graph=pg if cfg.graph_partition else None)
        base = cliques5 if label.startswith("cliques") else motifs5
        need(results[label].patterns == base.patterns,
             f"10b {label}: patterns differ from phase 5's run")
        need(same_sets(np, results[label], base),
             f"10b {label}: embeddings differ from phase 5's run as sets")
        need(rec["collective_bytes"] > 0, f"10b {label}: no collective bytes")
        runs.append(rec)
    on_path = ("canonical_check", "expand_canonical", "stream_compact",
               "seg_unique", "radix_hist", "radix_scatter",
               "canonical_refine", "canonical_check_tiles", "gather_rows")
    for name in on_path:
        need(sum(r["launches"].get(name, 0) for r in runs) > 0,
             f"10b: {name} never launched under the shard-map backend")
    synced = results["motifs_alltoall_trace_sync"]
    need([s.n_host_syncs for s in synced.stats.steps]
         == [s.n_host_syncs for s in results["motifs_alltoall"].stats.steps]
         and any(s.t_exchange > 0 for s in synced.stats.steps),
         "10b: trace_sync changed the syncs or timed no halo exchange")
    del pg
    out["main_path"] = runs
    out["sync_free_step"] = shard_step_is_sync_free(torch, np, G)
    log(f"  one superstep (the expansion whole graph fused and "
        f"partitioned all-to-all, the two-level aggregation's quick bins "
        f"and the domain scatter) ran under sync debug mode 'error': "
        f"children per worker {out['sync_free_step']['whole_fused']}, "
        f"{out['sync_free_step']['quick_bin']}")

    # ---- 10c: FSM under the dense ODAG exchange ---------------------------
    log(f"[10c] citeseer_like(1.0) FSM {FSM_MAIN_APP}, store='odag' (the "
        f"dense exchange), {PARTS} workers")
    rec, fsm = shard_run(torch, build, totals, "fsm_odag",
                         G.citeseer_like(1.0), FSMApp(**FSM_MAIN_APP),
                         dataclasses.replace(off, store="odag"))
    need(fsm.patterns == fsm7b, "10c: FSM patterns differ from 7b's")
    out["fsm_odag"] = rec

    # ---- 10d: elastic resume and a supervised halo fault -------------------
    log("[10d] partitioned motifs: a cut at 4 workers resumed at 3 and 5; "
        "run_supervised under a halo fault")
    clean = results["motifs_alltoall"]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-shard-") as td:
        cfg = dataclasses.replace(off, graph_partition=PARTS,
                                  checkpoint_dir=td)
        t0 = time.perf_counter()
        cut_run = shard_run(torch, build, totals, "motifs_checkpointed", g,
                            motifs(), cfg)[1]
        need(cut_run.patterns == motifs5.patterns,
             "10d: checkpointed run differs from phase 5's")
        first = ckpt_lib.list_checkpoints(td)[0]
        elastic, host = {}, HostAggregation()
        for w in (PARTS - 1, PARTS + 1):
            t1 = time.perf_counter()
            with host:
                res = resume(g, motifs(), first,
                             dataclasses.replace(off, graph_partition=w),
                             ShardMapBackend(make_mesh((w,), ("data",))))
            torch.cuda.synchronize()
            need(res.patterns == motifs5.patterns,
                 f"10d: resumed at {w} workers differs from phase 5's")
            elastic[w] = time.perf_counter() - t1
    plan = FaultPlan([("halo", 2, "halo")])
    t1 = time.perf_counter()
    with host:
        sup = run_supervised(g, motifs(), dataclasses.replace(
            off, graph_partition=PARTS, faults=plan),
            ShardMapBackend(make_mesh((PARTS,), ("data",))))
    torch.cuda.synchronize()
    t_sup = time.perf_counter() - t1
    need(host.calls == 0, f"10d: {host.calls} steps took the host "
         "aggregation path on the card")
    need(sup.recovery is not None
         and sup.recovery["degradations"] == ["halo_gather"],
         f"10d: the halo fault's recovery {sup.recovery}")
    need(sup.patterns == clean.patterns
         and [s.n_children for s in sup.stats.steps]
         == [s.n_children for s in clean.stats.steps],
         "10d: supervised run differs from the clean partitioned run")
    out["elastic_resume_s"] = elastic
    out["supervised_halo"] = {"wall_s": t_sup, "recovery": sup.recovery}
    log(f"  resumed at {PARTS - 1} / {PARTS + 1} workers in "
        f"{elastic[PARTS - 1]:.3f} / {elastic[PARTS + 1]:.3f} s; supervised "
        f"halo fault {t_sup:.3f} s, {sup.recovery}; all equal to phase 5 "
        f"(elastic setup {time.perf_counter() - t0:.1f} s)")
    build.reset_launches()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 10: {out['seconds']:.1f} s")
    return totals, out


# ---------------------------------------------------------------------------
# Phase 11: the exact oracles, Table 1's SN and Patents graphs, the examples
# ---------------------------------------------------------------------------

def sparse_adjacency(np, g):
    """The symmetric int64 adjacency matrix of ``g`` (scipy CSR)."""
    import scipy.sparse as sp

    u = g.edges[:, 0].astype(np.int64)
    v = g.edges[:, 1].astype(np.int64)
    return sp.csr_matrix(
        (np.ones(2 * g.m, dtype=np.int64),
         (np.concatenate([u, v]), np.concatenate([v, u]))), shape=(g.n, g.n))


def closed_forms(np, g):
    """The host's counts of ``g``'s size-3 vertex sets, independent of the
    port: triangles T = trace(A^3) / 6 (A^2 in blocks of rows), pairs of
    edges at a vertex P = sum C(d, 2), open wedges P - 3T, connected size-3
    sets P - 2T. Returns them and A."""
    t0 = time.perf_counter()
    a = sparse_adjacency(np, g)
    deg = np.diff(a.indptr).astype(np.int64)
    trace = 0
    for lo in range(0, g.n, HOST_ROWS):
        blk = a[lo:lo + HOST_ROWS]
        trace += int((blk @ a).multiply(blk).sum())
    need(trace % 6 == 0, f"trace(A^3) = {trace} is not a multiple of 6")
    tri = trace // 6
    pairs = int((deg * (deg - 1) // 2).sum())
    return {"triangles": tri, "pairs": pairs, "wedges": pairs - 3 * tri,
            "connected3": pairs - 2 * tri, "max_degree": int(deg.max()),
            "seconds": time.perf_counter() - t0}, a


def four_cliques(np, a, edges) -> int:
    """Size-4 cliques: over every edge, the edges among its endpoints'
    common neighbours, summed and divided by 6 (each clique has 6 edges,
    and each sees one edge among the other two vertices)."""
    total = 0
    for lo in range(0, len(edges), HOST_ROWS):
        e = edges[lo:lo + HOST_ROWS].astype(np.int64)
        common = a[e[:, 0]].multiply(a[e[:, 1]])
        # common A common^T summed: twice the edges among them, a row an edge
        total += int((common @ a).multiply(common).sum())
    need(total % 12 == 0, f"twice 6 x the 4-cliques = {total}, not a "
         "multiple of 12")
    return total // 12


def motif_sizes(res) -> dict:
    """Motif counts of a size-3 run by size, with size 3 split into the
    triangle (all three pair bits set) and the open wedges."""
    out = {}
    for code, cnt in res.patterns.items():
        key = code[0] & 0xF
        if key == 3:
            key = "triangles" if (code[0] >> 4) == 0b111 else "wedges"
        out[key] = out.get(key, 0) + cnt
    return out


def check_size3_motifs(label, g, res, forms):
    """A size-3 motif run against the host's closed forms."""
    got = motif_sizes(res)
    want = {1: g.n, 2: g.m, "triangles": forms["triangles"],
            "wedges": forms["wedges"]}
    need(got == want, f"{label}: motif counts {got} != closed forms {want}")
    total = g.n + g.m + forms["connected3"]
    need(res.stats.total_embeddings == total,
         f"{label}: {res.stats.total_embeddings} embeddings != n + m + "
         f"sum C(d,2) - 2T = {total}")


#: phase 11d: the examples, each run on the card with its defaults (but
#: ``traced_run``'s trace directory, a temporary one)
EXAMPLES = ("quickstart", "cliques", "fsm_end_to_end", "motifs_distributed",
            "motifs_odag_store", "resume_after_crash", "traced_run")


def run_example(torch, build, totals, name, argv):
    """One example's ``main(argv)`` on the card, its output captured, its
    launches counted (zeroed just before, read just after, added to
    ``totals``); an example's own failed check fails the phase."""
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            ret = mod.main(argv)
    except SystemExit as e:
        raise SmokeFailure(f"11d {name}: {e}") from e
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    for k, v in launches.items():
        totals[k] += v
    lines = buf.getvalue().splitlines()
    rec = {"example": name, "argv": argv, "wall_s": wall,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "last_line": lines[-1] if lines else ""}
    log(f"  {name}: wall {wall:.3f} s, peak "
        f"{rec['peak_bytes'] / 2**30:.2f} GiB, launches "
        f"{ {k: v for k, v in launches.items() if v} }; "
        f"'{rec['last_line'][:100]}'")
    return rec, ret


def oracle_phase(torch, np, run, RunConfig, G, build):
    """Phase 11: a. card runs at the default config against the port's
    brute-force oracles and TLV; b. bench_large.py's SN graph (size-3
    motifs, size-4 cliques) and SN at 5x (size-3 motifs) against the
    host's closed forms; c. Patents at 1/100 (size-3 motifs) against them;
    d. every example's ``main`` on the card. Kernels counted."""
    from repro_torch.core.apps import CliquesApp, FSMApp, MotifsApp
    from repro_torch.core.baselines import bruteforce as bf
    from repro_torch.core.baselines import tlv

    t_phase = time.perf_counter()
    totals = {name: 0 for name in build.LAUNCHES}
    out = {"runs": [], "oracle_s": 0.0}

    def card(label, g, app, cfg=None):
        rec, res, _ = counted_run(torch, run, build, totals, label, g, app,
                                  cfg or RunConfig())
        out["runs"].append(rec)
        return res

    def oracle(fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            out["oracle_s"] += time.perf_counter() - t0

    # ---- 11a. the card against the oracles -------------------------------
    log("[11a] card runs at the default config vs the port's brute-force "
        "oracles and TLV")
    for seed, n, m, labels in ORACLE_MOTIFS:
        g = G.random_labeled(n, m, n_labels=labels, seed=seed)
        res = card(f"oracle_motifs4_s{seed}", g, MotifsApp(max_size=4))
        need(res.patterns == oracle(bf.motif_counts, g, 4),
             f"11a motifs seed {seed}: the card differs from the oracle")
    for seed in ORACLE_CLIQUES:
        g = G.random_labeled(50, 180, n_labels=1, seed=seed)
        res = card(f"oracle_cliques4_s{seed}", g, CliquesApp(max_size=4))
        want = {k: v for k, v in oracle(bf.clique_counts, g, 4).items() if v}
        got = {k: len(v) for k, v in res.embeddings.items()}
        need(got == want, f"11a cliques seed {seed}: {got} != {want}")
    for seed, sup, ms in ORACLE_FSM:
        g = G.random_labeled(40, 90, n_labels=2, seed=seed)
        res = card(f"oracle_fsm_s{seed}", g, FSMApp(support=sup, max_size=ms))
        need(res.patterns == oracle(bf.fsm_supports, g, ms, sup),
             f"11a FSM seed {seed}: the card differs from the oracle")
    g = G.paper_figure2()
    res = card("oracle_figure2", g, FSMApp(support=1, max_size=1))
    need(res.patterns == oracle(bf.fsm_supports, g, 1, 1)
         and list(res.patterns.values()) == [2],
         f"11a Figure 2: supports {res.patterns}")
    res = card("oracle_figure2_counts", g,
               FSMApp(support=1, max_size=1, wants_domains=False))
    need(list(res.patterns.values()) == [3],
         f"11a Figure 2: embedding counts {res.patterns}")
    g = G.random_labeled(60, 150, n_labels=2, seed=3)
    res = card("oracle_tle_vs_tlv", g, MotifsApp(max_size=3))
    rep = oracle(tlv.run_tlv, g, 3)
    need(res.stats.total_embeddings == rep.n_embeddings,
         f"11a: the card explored {res.stats.total_embeddings} embeddings, "
         f"TLV {rep.n_embeddings}")
    need(rep.n_messages > 2 * rep.n_embeddings,
         f"11a: TLV sent {rep.n_messages} messages for {rep.n_embeddings} "
         "embeddings")
    out["tlv"] = {"n_messages": rep.n_messages,
                  "n_embeddings": rep.n_embeddings,
                  "max_vertex_load": rep.max_vertex_load,
                  "mean_vertex_load": rep.mean_vertex_load,
                  "host_s": rep.wall_time}
    log(f"  every card run equal to its oracle (host oracles "
        f"{out['oracle_s']:.1f} s); TLV: {rep.n_messages} messages for "
        f"{rep.n_embeddings} embeddings, vertex load max "
        f"{rep.max_vertex_load} mean {rep.mean_vertex_load:.1f}")

    # ---- 11b. paper Table 5's stress at SN scale ---------------------------
    graphs = {}
    for key, make, scale in (("sn", G.unlabeled_sn_like, SN_TABLE5),
                             ("sn_wide", G.unlabeled_sn_like, SN_WIDE),
                             ("patents", G.patents_like, PATENTS)):
        g = make(scale)
        forms, a = closed_forms(np, g)
        graphs[key] = (g, forms, a)
        out[f"{key}_graph"] = {"scale": scale, "n": g.n, "m": g.m, **forms}
        log(f"  {make.__name__}({scale}): {g.n} vertices, {g.m} edges, D "
            f"{forms['max_degree']}, T {forms['triangles']}, sum C(d,2) "
            f"{forms['pairs']} (host {forms['seconds']:.2f} s)")
    g, forms, a = graphs["sn"]
    log(f"[11b] Table 5 at SN scale: unlabeled_sn_like({SN_TABLE5}), "
        f"{TABLE5_CFG}")
    res = card("sn_motifs3", g, MotifsApp(max_size=3), RunConfig(**TABLE5_CFG))
    check_size3_motifs("11b SN motifs", g, res, forms)
    res = card("sn_cliques4", g, CliquesApp(max_size=4,
                                            collect_embeddings=False),
               RunConfig(**TABLE5_CFG))
    t0 = time.perf_counter()
    k4 = four_cliques(np, a, g.edges)
    out["sn_graph"]["four_cliques"] = k4
    out["sn_graph"]["four_cliques_s"] = time.perf_counter() - t0
    got = {1: res.stats.steps[0].n_frontier}
    got.update({s.size + 1: s.n_children for s in res.stats.steps
                if s.n_children})
    want = {1: g.n, 2: g.m, 3: forms["triangles"], 4: k4}
    need(got == want, f"11b SN cliques per size {got} != host counts {want}")
    log(f"  SN: motifs = closed forms, cliques per size {got} = host counts "
        f"(4-cliques over the edges' common neighbours, "
        f"{out['sn_graph']['four_cliques_s']:.2f} s)")
    g, forms, _ = graphs["sn_wide"]
    log(f"  size-3 motifs at full width on unlabeled_sn_like({SN_WIDE}): "
        f"{forms['connected3']} connected triples")
    res = card("sn_wide_motifs3", g, MotifsApp(max_size=3))
    check_size3_motifs("11b SN wide motifs", g, res, forms)

    # ---- 11c. Patents ------------------------------------------------------
    g, forms, _ = graphs["patents"]
    log(f"[11c] patents_like({PATENTS}): size-3 motifs, default config")
    res = card("patents_motifs3", g, MotifsApp(max_size=3))
    check_size3_motifs("11c Patents motifs", g, res, forms)
    log(f"  Patents: {len(res.patterns)} patterns, "
        f"{res.stats.total_embeddings} embeddings = n + m + sum C(d,2) - 2T")
    del graphs, a, res

    # ---- 11d. the examples ---------------------------------------------------
    log("[11d] the examples on the card (repro_torch.examples)")
    out["examples"] = []
    with tempfile.TemporaryDirectory() as traces:
        for name in EXAMPLES:
            argv = ["--trace-dir", traces] if name == "traced_run" else []
            rec, ret = run_example(torch, build, totals, name, argv)
            out["examples"].append(rec)
            if name == "quickstart":
                g = G.citeseer_like(0.05)
                need(ret.patterns == oracle(bf.motif_counts, g, 3),
                     "11d quickstart: motifs differ from the oracle")
            elif name == "fsm_end_to_end":
                cpu = run(G.citeseer_like(0.3), FSMApp(support=8, max_size=3),
                          RunConfig(chunk_size=8192, initial_capacity=1 << 15),
                          device="cpu")
                need(ret.patterns == cpu.patterns,
                     "11d fsm_end_to_end: patterns differ from the CPU port")
            elif name.startswith("motifs_"):
                cpu = run(G.mico_like(0.004), MotifsApp(max_size=3),
                          RunConfig(), device="cpu")
                need(ret.patterns == cpu.patterns,
                     f"11d {name}: patterns differ from the serial CPU run")
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 11: {out['seconds']:.1f} s")
    return totals, out


# ---------------------------------------------------------------------------
# Phase 6: the model zoo's dense decoder (qwen2.5-14b)
# ---------------------------------------------------------------------------

def keep_mask(torch, sq, sk, causal, window, device):
    """(Sq, Sk) bool: key j kept for query i when j <= i (causal) and
    j > i - window (window > 0)."""
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(sk, device=device)[None, :]
    keep = (i >= j) if causal else torch.ones_like(i >= j)
    return keep & (j > i - window) if window else keep


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
#: calls of a host piece that launches the gather (0.06 ms of device time
#: each): few enough that the launch queue never fills and blocks the host
GATHER_LAUNCH_CALLS = 200


def host_us(torch, piece, calls: int) -> float:
    """Host microseconds a call of ``piece()`` over ``calls`` calls after
    100 untimed ones, the card idle before and after."""
    for _ in range(100):
        piece()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        piece()
    t = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return t


def gather_host_pieces(torch, table, rows, fill) -> dict:
    """Phase 3: host microseconds a call of the halo gather at the
    neighbour tile's shape, with the host clock: the wrapper and the
    library gather (``index_select`` and the fill mask) over
    ``GATHER_LAUNCH_CALLS`` calls, as is the C entry by ``ctypes`` with its
    launch; over ``HOST_CALLS`` calls each, the other pieces the wrapper
    runs (the output allocation, the raw stream, the current device, the
    two contiguity probes, ``get_device``, ``int(fill)``) beside the forms
    it ran before (a ``torch.cuda.Stream`` object a call, a device guard,
    two ``contiguous()``, ``build.library()``)."""
    from repro_torch.kernels import build, gather

    dev = table.get_device()
    u, r = rows.shape[0], table.shape[1]
    out = torch.empty((u, r), dtype=torch.int32, device=table.device)
    fn = build.library().repro_gather_rows
    stream = build.raw_stream(dev)
    args = (table.data_ptr(), table.shape[0], r, rows.data_ptr(), u, fill,
            out.data_ptr())

    def guard():
        with torch.cuda.device(table.device):
            pass

    launching = {
        "wrapper (gather_rows_cuda)": lambda: gather.gather_rows_cuda(
            table, rows, fill),
        "index_select + fill mask": lambda: library_gather(
            torch, table, rows, fill),
        "C entry by ctypes, launch included": lambda: fn(*args, stream),
    }
    pieces = {
        "torch.empty": lambda: torch.empty((u, r), dtype=torch.int32,
                                           device=table.device),
        "build.raw_stream": lambda: build.raw_stream(dev),
        "torch.cuda.current_device": torch.cuda.current_device,
        "two is_contiguous": lambda: (table.is_contiguous(),
                                      rows.is_contiguous()),
        "get_device": table.get_device,
        "int(fill)": lambda: int(fill),
        "torch.cuda.current_stream().cuda_stream": lambda: build.stream_of(
            table),
        "with torch.cuda.device": guard,
        "two contiguous()": lambda: (table.contiguous(), rows.contiguous()),
        "build.library()": build.library,
    }
    us = {name: host_us(torch, piece, GATHER_LAUNCH_CALLS)
          for name, piece in launching.items()}
    us.update((name, host_us(torch, piece, HOST_CALLS))
              for name, piece in pieces.items())
    log("  gather_rows host us a call at the neighbour tile: " + "; ".join(
        f"{k} {v:.2f}" for k, v in us.items()))
    return us


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
    # the two whole calls in turns (a b b a ...), HOST_CALLS each in all
    turns = {"wrapper (rmsnorm_cuda)": [], "F.rms_norm": []}
    names = list(turns)
    for r in range(HOST_TURNS):
        for name in (names if r % 2 == 0 else names[::-1]):
            turns[name].append(host_us(torch, pieces[name],
                                       HOST_CALLS // HOST_TURNS))
    us = {name: statistics.median(t) for name, t in turns.items()}
    us.update((name, host_us(torch, piece, HOST_CALLS))
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
    (query, key) pairs where ``keep(qi, kj)`` is true, in place of the
    flash kernel's causal mask and window (the dense decoder passes 0)."""
    def attend(q, k, v, causal=True, window=0):
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


# ---------------------------------------------------------------------------
# Phase 12: the rest of the model zoo's serving path
# ---------------------------------------------------------------------------

#: 12c's models at their published widths, seed 0; deepseek-v2-236b cut to
#: its leading dense layer and two MoE layers (one MoE layer's experts are
#: 3.8e9 parameters; all 59 would be 472 GB), the others at full depth
ZOO = ("deepseek-v2-236b", "zamba2-2.7b", "xlstm-1.3b", "whisper-base",
       "internvl2-26b")
ZOO_CUT = {"deepseek-v2-236b": dict(n_layers=3, first_dense_layers=1)}
#: 12b's reduced models, card against CPU
ZOO_REDUCED = ("deepseek-v2-236b", "llama4-maverick-400b-a17b",
               "zamba2-2.7b", "xlstm-1.3b", "whisper-base", "internvl2-26b")
#: decode vs forward at B = 2: the attention decoders over phase 6's 256
#: positions (whisper: its decoder context), the recurrent families (whole
#: model and chunked blocks) over two 256-token chunks
ZOO_CHECK_B, ZOO_CHECK_S, ZOO_BLOCK_S = 2, 256, 512
#: 12b's input seeds, and its MoE rule: the card's router may send at
#: most this share of the positions more off the f32 run's experts than
#: the CPU's (PERF.md §6 holds the readings it is set from)
ZOO_ROUTE_SEEDS = (6, 7, 8, 9)
REROUTE_SLACK = 1 / 8
WHISPER_S = 448                      # whisper's decoder context
CONTROL_STEPS = 32                   # decode steps of the controls
#: decode vs forward at published widths: the JAX package's own bounds for
#: each family (tests/test_models_smoke.py): the deep stack's whose decode
#: associates differently (MLA: correlation > 0.995, argmax agreement >
#: 0.9), which the GQA decoders (internvl2 at 48 layers, whisper) take with
#: phase 6's relative RMS 0.06 (the JAX package's elementwise 3e-2 is its
#: bound at 2-4 reduced layers; phase 6 measured a relative RMS of 0.023
#: between decode and forward at 48 full layers, whose largest elements
#: pass 3e-2 on noise alone); and the recurrent families' (correlation >
#: 0.998, mean |diff| < 0.05, 99th percentile < 0.25), logged for zamba2
#: and xlstm but not held: with random weights their published stacks are
#: chaotic, so rounding alone moves the logits as far as the bound allows
#: many times over (the bf16 forward against the f32 forward of the same
#: weights on the card: correlation 0.888 for zamba2's 54 layers, 0.376 for
#: xlstm's 48). The reference is as chaotic: a 1e-6 relative change of one
#: published-width sLSTM block's input moves its output by 5.7 % at
#: position 511 in the JAX package, 6.3 % in the port
#: (tests/slstm_perturbation.py, on the CPU). Those two are held to the
#: recurrent bound block by block instead (:func:`chunked_blocks`: each
#: block of the first super block, chunked scans and the hybrid's shared
#: attention+MLP block, the same input to its forward and its step-by-step
#: decode, each with its control).
ZOO_BOUNDS = {
    "recurrent": dict(corr=0.998, mean=0.05, q99=0.25),
    "deep": dict(corr=0.995, agree=0.9),
    "gqa": dict(corr=0.995, agree=0.9, rel_rms=DECODE_VS_FORWARD_MAX),
}


def zoo_config(name, reduced=False):
    import dataclasses

    from repro_torch.configs.registry import get_arch
    cfg = get_arch(name)
    if reduced:
        return cfg.reduced()
    return dataclasses.replace(cfg, **ZOO_CUT.get(name, {}))


def zoo_launches(cfg) -> dict:
    """Exact kernel launches of one forward and of one decode step, from
    the config: every norm is one RMSNorm launch (MLA adds its q and kv
    norms, Mamba2 its gate norm, the mLSTM and sLSTM their output norms),
    every full-sequence attention one flash launch (the decode steps attend
    in plain PyTorch)."""
    L = cfg.n_layers
    if cfg.family == "hybrid":
        n_attn = L // cfg.attn_every
        rms, flash, dec = 2 * L + 2 * n_attn + 1, n_attn, 2 * L + 2 * n_attn + 1
    elif cfg.family == "ssm":
        rms, flash, dec = 2 * L + 1, 0, 2 * L + 1
    elif cfg.family == "encdec":
        rms = 2 * cfg.encoder_layers + 1 + 3 * L + 1
        flash, dec = cfg.encoder_layers + 2 * L, 3 * L + 1
    else:
        per = 4 if cfg.use_mla else 2
        rms, flash, dec = per * L + 1, L, per * L + 1
    return {"forward": {"rmsnorm": rms, "flash_attention": flash},
            "decode_step": {"rmsnorm": dec}}


def zoo_inputs(cfg, b, s, gen):
    """tokens (B, S) and the family's other forward inputs (patch
    embeddings, audio frames) from ``gen``, on its device
    (``models.make_batch``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import make_batch
    batch = make_batch(cfg, ShapeConfig("zoo", s, b, "prefill"), gen)
    return batch["tokens"], {k: v for k, v in batch.items()
                             if k in ("patch_embeds", "frames")}


def zoo_kernel_checks(torch):
    """12a: flash attention at the new families' shapes (the hybrid's
    window, MLA's prefill with v padded, whisper's encoder and its
    cross-attention) and RMSNorm at the new norms' widths, bf16, each
    against its plain version and timed beside it, its bound and the
    library call. Returns every case's record."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda, flash_attention_ref)
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda, rmsnorm_ref

    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    bf16 = torch.bfloat16
    cases = []
    rows = FWD_B * FWD_S
    for what, d in (("MLA q_norm", 1536), ("MLA kv_norm", 512),
                    ("Mamba2 gate_norm", 5120), ("mLSTM out_norm", 4096)):
        x = torch.randn((rows, d), generator=gen, device=dev).to(bf16)
        scale = (1 + 0.1 * torch.randn((d,), generator=gen, device=dev)
                 ).to(bf16)
        got = rmsnorm_cuda(x, scale, 1e-5)
        want = rmsnorm_ref(x, scale, 1e-5)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        need(bool((diff <= 2**-7 * want.float().abs()).all()),
             f"rmsnorm {what} ({rows}, {d}) differs from its plain version "
             f"by {float(diff.max())}")
        timed = time_call(torch, lambda: rmsnorm_cuda(x, scale, 1e-5),
                          device=True)
        plain = time_ms(torch, lambda: rmsnorm_ref(x, scale, 1e-5))
        lib = time_ms(torch, lambda: F.rms_norm(x, (d,), scale, 1e-5))
        row = kernel_row(
            "rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "src/repro/kernels/rmsnorm/rmsnorm.py:23", float(diff.max()),
            timed, plain, (2 * rows * d + d) * 2, lib, ops=4 * rows * d,
            op_rate=F32_FLOPS)
        cases.append(dict(row, shape=[rows, d], at=what))
        del x, got, want, diff

    for what, b, sq, sk, h, d, causal, window in (
            ("zamba2 window 512", FWD_B, FWD_S, FWD_S, 32, 80, True, 512),
            ("deepseek MLA prefill, v padded", FWD_B, FWD_S, FWD_S, 128, 192,
             True, 0),
            ("whisper encoder", FWD_B, 1500, 1500, 8, 64, False, 0),
            ("whisper cross-attention", FWD_B, WHISPER_S, 1500, 8, 64, False,
             0)):
        dv = 128 if "padded" in what else d      # MLA's v: 128 of its 192
        q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(bf16)
        k = torch.randn((b, sk, h, d), generator=gen, device=dev).to(bf16)
        v = torch.randn((b, sk, h, d), generator=gen, device=dev).to(bf16)
        v[..., dv:] = 0
        keep = keep_mask(torch, sq, sk, causal, window, dev)
        pairs = int(keep.sum())
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None if (not window and causal) else keep

        def sdpa():
            if mask is None:
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        got = flash_attention_cuda(q, k, v, causal, window)
        want = flash_attention_ref(q, k, v, causal, window).float()
        lib_out = sdpa().transpose(1, 2).float()
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        lib_err = float((lib_out - want).abs().max())
        need(bool((diff <= 2e-2 + 2e-2 * want.abs()).all()),
             f"flash_attention {what} differs from its plain version by "
             f"{float(diff.max())} (bound 2e-2)")
        need(float(diff.max()) <= 1.5 * lib_err,
             f"flash_attention {what}: max error {float(diff.max())} above "
             f"1.5x SDPA's {lib_err}")
        need(bool((got[..., dv:] == 0).all()),
             f"{what}: the padded v columns came out non-zero")
        del want, lib_out
        timed = time_call(torch, lambda: flash_attention_cuda(
            q, k, v, causal, window), device=True)
        plain = time_ms(torch, lambda: flash_attention_ref(
            q, k, v, causal, window), **PLAIN)
        lib = time_ms(torch, sdpa)
        # the function's work: QK^T at d and PV at dv a kept pair; q and k
        # read, v read and the output written at their dv real columns (the
        # padding is the kernel's cost, not the function's)
        flops = 2 * (d + dv) * pairs * b * h
        nbytes = (q.numel() + k.numel() + b * h * (sk + sq) * dv) * 2
        row = kernel_row(
            "flash_attention",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:68",
            float(diff.max()), timed, plain, nbytes, lib, ops=flops,
            op_rate=BF16_FLOPS)
        log(f"    {what}: SDPA's max_abs_err {lib_err}; kernel "
            f"{flops / timed['ms'] / 1e9:.1f} TFLOP/s, "
            f"{row['bound_ms'] / timed['ms']:.1%} of its bound, "
            f"{timed['ms'] / lib:.2f}x SDPA")
        cases.append(dict(row, shape=[b, sq, sk, h, d], causal=causal,
                          window=window, at=what, library_max_abs_err=lib_err))
        del q, k, v, qt, kt, vt, got, diff, keep
        torch.cuda.empty_cache()
    return cases


class RouteLog:
    """While active, records each MoE layer's own expert choice: one
    (tokens, k) tensor a call of ``layers._moe_route``, each token's
    experts in ascending order, tokens in the layer's input order. Given
    ``force`` (the record of another run of the same calls, in the same
    order), each call routes as that run did instead, and its own choice
    is recorded all the same."""

    def __init__(self, force=None):
        self.force = force

    def __enter__(self):
        from repro_torch.models import layers
        self.layers, self.orig = layers, layers._moe_route
        self.calls, self.chosen = [], []
        forced = iter(self.force.chosen) if self.force is not None else None

        def logged(cfg, p, xt):
            probs, topi = self.orig(cfg, p, xt)
            self.calls.append(topi.sort(dim=-1).values.reshape(
                -1, cfg.top_k).cpu())
            self.chosen.append(topi)
            if forced is not None:
                topi = next(forced).to(topi.device)
            return probs, topi
        layers._moe_route = logged
        return self

    def __exit__(self, *exc):
        self.layers._moe_route = self.orig

    def per_position(self, torch, b, steps=None):
        """(B, S, layers * k): a forward's calls (``steps`` None) or those
        of ``steps`` decode steps of B tokens."""
        if steps is None:
            return torch.cat(self.calls, dim=1).reshape(b, -1,
                                                        len(self.calls) *
                                                        self.calls[0].shape[1])
        c = torch.stack(self.calls).reshape(steps, -1, b,
                                            self.calls[0].shape[1])
        return c.permute(2, 0, 1, 3).reshape(b, steps, -1)


def routed_errors(torch, got, cpu, ref, routes):
    """6b's errors of a MoE model whose bf16 runs took the f32 run's
    experts (:class:`RouteLog` ``force``), so that no position is moved
    by a token sent elsewhere upstream, and how many positions each bf16
    run's own router sends off the f32 run's experts at some layer: a
    rounding that differs from the f32 run's can, at a near tie of two
    experts. ``routes`` (card, CPU bf16, CPU f32) own choices per
    position."""
    rc, rb, r32 = routes
    e = logit_errors(got, cpu, ref)
    e.update(positions=int(r32.shape[0] * r32.shape[1]),
             card_rerouted=int((~(rc == r32).all(-1)).sum()),
             cpu_rerouted=int((~(rb == r32).all(-1)).sum()))
    return e


def card_rule_holds(e) -> bool:
    """6b's rule: the card's bf16 logits at most 1.25x as far from the f32
    logits as the CPU's bf16 logits on average, at most 2x at the largest.
    With MoE routes (:func:`routed_errors`), the card's router also sends
    at most ``REROUTE_SLACK`` of the positions more off the f32 run's
    experts than the CPU's does."""
    ok = (e["card_mean"] <= 1.25 * e["cpu_mean"]
          and e["card_max"] <= 2 * e["cpu_max"])
    if "positions" in e:
        ok = ok and e["card_rerouted"] <= e["cpu_rerouted"] + math.ceil(
            REROUTE_SLACK * e["positions"])
    return ok


def decode_positions(cfg, steps):
    """The decode steps of :func:`card_vs_cpu_family`: (cache length,
    positions) runs, each from a fresh cache; the hybrid adds steps on
    both sides of its shared attention's clamp (a cache of
    ``sliding_window_long`` slots past 65,536 positions)."""
    runs = [(steps, list(range(steps)))]
    if cfg.family == "hybrid":
        w = cfg.sliding_window_long
        runs.append((65537, list(range(w - steps // 2, w + steps // 2))))
    return runs


def card_vs_cpu_family(torch, name, seed, steps=8):
    """One reduced model of 12b with the same weights (drawn on the CPU
    from a seed, then moved) on the card and on the CPU: a forward of 2 x
    32 tokens from input seed ``seed`` and ``steps`` decode steps (the
    hybrid's also past its clamp, :func:`decode_positions`), each under
    :func:`card_rule_holds`; the MoE archs' bf16 runs take the f32 run's
    experts, their own recorded beside them (:class:`RouteLog`). Returns
    {"forward": errors, "decode": errors}."""
    from repro_torch.models import build_model

    cfg = zoo_config(name, reduced=True)
    cpu = build_model(cfg, device="cpu", seed=5)
    cpu32 = build_model(cfg, device="cpu", seed=5)
    cpu32.float()
    card = build_model(cfg, device="cpu", seed=5).to("cuda")
    b = 2
    toks, extra = zoo_inputs(cfg, b, 32, torch.Generator().manual_seed(seed))
    fwd, dec, routes = [], [], {"forward": [], "decode": []}
    f32_f = f32_d = None
    for m in (cpu32, card, cpu):
        with RouteLog(force=f32_f) as log_f:
            fwd.append(m.forward(toks.to(m.device), **{
                k: v.to(m.device) for k, v in extra.items()}).float().cpu())
        out_m = []
        with RouteLog(force=f32_d) as log_d:
            for s_cache, positions in decode_positions(cfg, steps):
                cache = m.init_cache(b, s_cache)
                for i, pos in enumerate(positions):
                    logits, cache = m.decode_step(
                        cache, toks[:, i:i + 1].to(m.device), pos)
                    out_m.append(logits.float().cpu())
        dec.append(torch.cat(out_m, 1))
        f32_f = log_f if f32_f is None else f32_f
        f32_d = log_d if f32_d is None else f32_d
        if cfg.family == "moe":
            routes["forward"].append(log_f.per_position(torch, b))
            routes["decode"].append(log_d.per_position(torch, b, steps))
    rec = {}
    for part, runs in (("forward", fwd), ("decode", dec)):
        r, g, c = runs                        # f32, card, CPU bf16
        rr = routes[part][1:] + routes[part][:1]
        e = (routed_errors(torch, g, c, r, rr)
             if cfg.family == "moe" else logit_errors(g, c, r))
        need(card_rule_holds(e), f"{name} {part}, input seed {seed}: the "
             f"card's bf16 logits are further from the f32 logits than the "
             f"CPU's: {e} (reroute slack {REROUTE_SLACK} of the positions)")
        rec[part] = e
    return rec


def zoo_card_vs_cpu(torch):
    """12b: :func:`card_vs_cpu_family` for each reduced model, the MoE
    archs on ``ZOO_ROUTE_SEEDS`` (a reroute is rare, so its count is read
    on several batches), the others on the first of them."""
    out = {}
    for name in ZOO_REDUCED:
        moe = zoo_config(name, reduced=True).family == "moe"
        out[name] = {}
        for seed in ZOO_ROUTE_SEEDS if moe else ZOO_ROUTE_SEEDS[:1]:
            rec = card_vs_cpu_family(torch, name, seed)
            out[name][str(seed)] = rec
            routed = "".join(
                f"; {part} positions off the f32 run's experts: card "
                f"{rec[part]['card_rerouted']}, CPU "
                f"{rec[part]['cpu_rerouted']} of {rec[part]['positions']}"
                for part in rec if moe)
            log(f"  {name} (reduced, seed {seed}): forward |card - f32| mean "
                f"{rec['forward']['card_mean']:.5f} max "
                f"{rec['forward']['card_max']:.4f} (CPU bf16 "
                f"{rec['forward']['cpu_mean']:.5f} / "
                f"{rec['forward']['cpu_max']:.4f}); decode mean "
                f"{rec['decode']['card_mean']:.5f} (CPU "
                f"{rec['decode']['cpu_mean']:.5f}){routed}")
    return out


def fill_cross_cache(torch, model, cache, frames):
    """Whisper's cross-attention K/V of every decoder layer from the
    encoder's output over ``frames`` (the serving launcher, like the
    reference's, leaves them zero; the decode-vs-forward check needs the
    forward's)."""
    from repro_torch.models import layers as L
    cfg = model.cfg
    with torch.inference_mode():
        enc = model.encode(frames)
        b, se, _ = enc.shape
        for i, lp in enumerate(model.dec_layers):
            for key, w in (("cross_k", lp.cross_k.w), ("cross_v", lp.cross_v.w)):
                cache[key][i] = L.matmul(enc, w).reshape(
                    b, se, cfg.n_kv_heads, cfg.head_dim)


def decode_logits(torch, model, toks, extra, steps, zero_state=False):
    """(B, steps, V) f32 logits of decoding ``toks`` token by token; with
    ``zero_state`` every cache tensor but whisper's cross K/V is zeroed
    before each step (the control)."""
    b = toks.shape[0]
    cache = model.init_cache(b, toks.shape[1])
    if "frames" in extra:
        fill_cross_cache(torch, model, cache, extra["frames"])
    out = torch.empty((b, steps, model.cfg.vocab), dtype=torch.float32,
                      device=toks.device)

    def tensors(c):
        for key, v in c.items():
            if isinstance(v, dict):
                yield from tensors(v)
            elif not key.startswith("cross"):
                yield v

    for t in range(steps):
        if zero_state:
            for v in tensors(cache):
                v.zero_()
        logits, cache = model.decode_step(cache, toks[:, t:t + 1], t)
        out[:, t] = logits[:, 0].float()
    return out


def decode_metrics(torch, dec, full) -> dict:
    d = (dec - full).abs()
    a, b = dec.flatten().double(), full.flatten().double()
    a, b = a - a.mean(), b - b.mean()
    return {"corr": float((a * b).sum() / (a.norm() * b.norm())),
            "mean": float(d.mean()),
            # torch.quantile takes at most 2^24 elements: every k-th
            "q99": float(torch.quantile(
                d.flatten()[::math.ceil(d.numel() / 2**24)], 0.99)),
            "agree": float((dec.argmax(-1) == full.argmax(-1)).float().mean()),
            "rel_rms": rel_rms(dec, full), "max_abs": float(d.max())}


def chunked_blocks(torch, cfg, model) -> dict:
    """Each block of the first super block at published widths (zamba2's
    shared attention+MLP block, :func:`shared_block`, and its six Mamba2
    layers; xLSTM's seven mLSTM layers). A chunked block: N(0, 1) input
    of B = 2 x S = 512 (two 256-token chunks) through the block's own norm,
    the chunked forward against the step-by-step decode from zero states
    (f32), and the control (the states zeroed before each step, its first
    ``CONTROL_STEPS``), by :func:`decode_metrics` under the recurrent
    bound."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm

    b, s, dev = ZOO_CHECK_B, ZOO_BLOCK_S, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    if cfg.family == "hybrid":
        d_inner, h, n = ssm.mamba_dims(cfg)
        layers = [(mp.ln, mp.m) for mp in model.blocks[0].mamba]
        fwd, dec = ssm.mamba2_forward, ssm.mamba2_decode
        shapes = [((b, h, n, ssm.MAMBA_HEADDIM), torch.float32),
                  ((b, ssm.MAMBA_CONV - 1, d_inner + 2 * n), torch.bfloat16)]
    else:
        d_inner, h, dqk, dv = ssm.xlstm_dims(cfg)
        layers = [(mp.ln, mp.m) for mp in model.blocks[0].mlstm]
        fwd, dec = ssm.mlstm_forward, ssm.mlstm_decode
        shapes = [((b, h, dqk, dv), torch.float32),
                  ((b, h, dqk), torch.float32)]
    bound = ZOO_BOUNDS["recurrent"]
    out = []
    if cfg.family == "hybrid":
        out.append(shared_block(torch, cfg, model, gen))
    for i, (ln, m) in enumerate(layers):
        with torch.inference_mode():
            x = L.rmsnorm(torch.randn((b, s, cfg.d_model), generator=gen,
                                      device=dev).to(torch.bfloat16), ln,
                          cfg.norm_eps)
            y = fwd(cfg, m, x).float()
            runs = []
            for steps, zero in ((s, False), (CONTROL_STEPS, True)):
                states = [torch.zeros(sh, dtype=dt, device=dev)
                          for sh, dt in shapes]
                ys = []
                for t in range(steps):
                    if zero:
                        for st in states:
                            st.zero_()
                    ys.append(dec(cfg, m, x[:, t:t + 1], *states)[0])
                runs.append(torch.cat(ys, 1).float())
        rec = {"decode": decode_metrics(torch, runs[0], y),
               "control": decode_metrics(torch, runs[1], y[:, :CONTROL_STEPS])}
        need(within(rec["decode"], bound), f"{cfg.name} block {i}: the "
             f"decode disagrees with the chunked forward: {rec['decode']}, "
             f"bound {bound}")
        need(not within(rec["control"], bound), f"{cfg.name} block {i}: "
             f"the control ({rec['control']}) is inside the bound {bound}")
        out.append(rec)
    worst = min(out, key=lambda r: r["decode"]["corr"])["decode"]
    log(f"  {cfg.name}: {len(out)} blocks, decode vs the "
        f"forward at B={b} x S={s}, the worst: " + ", ".join(
            f"{k} {v:.5f}" for k, v in worst.items() if k != "agree")
        + f" (bound {bound}); controls corr <= "
        f"{max(r['control']['corr'] for r in out):.5f}")
    return out


def shared_block(torch, cfg, model, gen) -> dict:
    """The hybrid's shared attention+MLP block at published widths: N(0, 1)
    input of B = 2 x S = 512, what the block adds to it, its forward
    (flash) against its step-by-step decode through a K/V cache of S
    slots, and the control (the cache zeroed before each step, so that a
    token sees itself alone), by :func:`decode_metrics` under the
    recurrent bound (the hybrid's). The clamp past 65,536 positions has no
    forward to hold it to: 12b holds it against the CPU port."""
    from repro_torch.models import lm

    b, s, dev = ZOO_CHECK_B, ZOO_BLOCK_S, torch.device("cuda")
    bound = ZOO_BOUNDS["recurrent"]
    with torch.inference_mode():
        x = torch.randn((b, s, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        y = (lm._block_fwd(cfg, model.shared, x, lm._positions(b, s, dev))
             .float() - x.float())
        runs = []
        for steps, zero in ((s, False), (CONTROL_STEPS, True)):
            cache = lm._layer(lm._attn_cache(cfg, 1, b, s, dev), 0)
            ys = []
            for t in range(steps):
                if zero:
                    for v in cache.values():
                        v.zero_()
                xt = x[:, t:t + 1]
                ys.append(lm._block_decode(cfg, model.shared, xt, cache, t)
                          .float() - xt.float())
            runs.append(torch.cat(ys, 1))
    rec = {"block": "shared attention+MLP",
           "decode": decode_metrics(torch, runs[0], y),
           "control": decode_metrics(torch, runs[1], y[:, :CONTROL_STEPS])}
    need(within(rec["decode"], bound), f"{cfg.name} shared block: the "
         f"decode disagrees with the forward: {rec['decode']}, bound {bound}")
    need(not within(rec["control"], bound), f"{cfg.name} shared block: the "
         f"control ({rec['control']}) is inside the bound {bound}")
    log(f"  {cfg.name} shared attention+MLP block, decode vs forward at "
        f"B={b} x S={s}: " + ", ".join(
            f"{k} {v:.5f}" for k, v in rec["decode"].items() if k != "agree")
        + f"; control corr {rec['control']['corr']:.5f}")
    return rec


def within(m, bound) -> bool:
    return (m["corr"] > bound["corr"]
            and m["mean"] < bound.get("mean", math.inf)
            and m["q99"] < bound.get("q99", math.inf)
            and m["agree"] > bound.get("agree", 0.0)
            and m["rel_rms"] <= bound.get("rel_rms", math.inf))


@contextlib.contextmanager
def uncapped_moe(cfg):
    """Inside the block a MoE layer's capacity is Tg * k: no assignment is
    dropped, in the forward as in the decode step."""
    from repro_torch.models import layers
    orig = layers._moe_cap
    if cfg.family == "moe":
        layers._moe_cap = lambda c, tg: tg * c.top_k
    try:
        yield
    finally:
        layers._moe_cap = orig


def zoo_model(torch, build, name, totals) -> dict:
    """12c for one model at its published widths (random weights from seed
    0 on the card): a forward of 4 x 2,048 tokens (whisper 4 x 448 over 4 x
    1,500 frames; internvl2 with 256 patches) twice, the first warming up,
    with its exact launches; decode against the forward at B=2, S=256
    (whisper 448) under the family's bound (the MoE's capacity lifted in
    both, see :func:`uncapped_moe`), and the control (state zeroed each
    step) outside it; the recurrent families block by block at S=512
    (:func:`chunked_blocks`), their whole decode logged; one forward and one
    decode step under sync debug mode "error"; then, warm, ``generate``
    for 4 requests (prompt 16, gen 32) with its exact launches; the wall,
    the peaks and the weights' bytes."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    cfg = zoo_config(name)
    expect = zoo_launches(cfg)
    out = {"config": name, "n_layers": cfg.n_layers, "launches": expect}
    if name in ZOO_CUT:
        out["cut"] = ZOO_CUT[name]
        log(f"  {name}: depth cut to {ZOO_CUT[name]} of its published "
            f"{get_arch(name).n_layers} layers")
    t_model = time.perf_counter()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["n_params"] = model.n_params()
    out["weight_bytes"] = torch.cuda.memory_allocated() - before
    log(f"  {name}: {out['n_params'] / 1e9:.3f} B parameters, "
        f"{out['weight_bytes'] / 1e9:.2f} GB, drawn in {out['init_s']:.2f} s")
    gen = torch.Generator(device="cuda").manual_seed(1)
    peaks = {}

    def counted(label, fn, want):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peaks[label] = torch.cuda.max_memory_allocated()
        launches = dict(build.LAUNCHES)
        want = {k: want.get(k, 0) for k in launches}
        need(launches == want, f"{name} {label}: launches {launches}, "
             f"expected {want}")
        for k, v in launches.items():
            totals[k] += v
        return res, wall

    fwd_s = WHISPER_S if cfg.family == "encdec" else FWD_S
    toks, extra = zoo_inputs(cfg, FWD_B, fwd_s, gen)
    n_out = fwd_s + (cfg.n_patches if cfg.family == "vlm" else 0)
    fwd = []
    for i in range(2):
        logits, wall = counted(f"forward {i}", lambda: model.forward(
            toks, **extra), expect["forward"])
        need(logits.shape == (FWD_B, n_out, cfg.vocab)
             and logits.dtype == torch.bfloat16,
             f"{name} forward logits {tuple(logits.shape)} {logits.dtype}")
        need(bool(torch.isfinite(logits).all()), f"{name}: forward logits "
             "not finite")
        del logits
        fwd.append(wall)
        log(f"  {name} forward {FWD_B} x {n_out}: {wall * 1e3:.1f} ms "
            f"({FWD_B * n_out / wall:.0f} tokens/s)")
    out["forward_s"] = fwd
    if cfg.family == "ssm":
        # the sLSTM's loop over the 2,048 steps, one block alone
        from repro_torch.models import ssm
        x = torch.randn((FWD_B, fwd_s, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        with torch.inference_mode():
            ssm.slstm_forward(cfg, model.blocks[0].slstm, x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ssm.slstm_forward(cfg, model.blocks[0].slstm, x)
            torch.cuda.synchronize()
        t = time.perf_counter() - t0
        out["slstm_block_s"] = t
        log(f"  {name}: one sLSTM block's prefill of {FWD_B} x {fwd_s}: "
            f"{t * 1e3:.1f} ms; its {len(model.blocks)} blocks "
            f"{len(model.blocks) * t / min(fwd):.1%} of the forward")
        del x

    del toks, extra

    # decode through the cache against the forward, and the control
    s = (WHISPER_S if cfg.family == "encdec" else ZOO_BLOCK_S
         if cfg.family in ("hybrid", "ssm") else ZOO_CHECK_S)
    toks, extra = zoo_inputs(cfg, ZOO_CHECK_B, s, gen)
    if cfg.family == "vlm":
        extra = {}                     # decode takes tokens only
    t0 = time.perf_counter()
    capped = None
    if cfg.family == "moe":
        # the forward's capacity-bounded dispatch drops assignments past
        # Tg * k * 1.25 / E an expert a group (the reference's GShard
        # schedule); a one-token decode step never does. Both run with
        # the capacity at Tg * k (nothing dropped) for the check; the
        # forward as configured is logged beside it
        capped = decode_metrics(torch, decode_logits(
            torch, model, toks, extra, s), model.forward(toks).float())
    with uncapped_moe(cfg):
        full = model.forward(toks, **extra).float()
        dec = decode_logits(torch, model, toks, extra, s)
        ctl = decode_logits(torch, model, toks, extra, CONTROL_STEPS,
                            zero_state=True)
    kind = ("recurrent" if cfg.family in ("hybrid", "ssm")
            else "deep" if cfg.use_mla else "gqa")
    bound = ZOO_BOUNDS[kind]
    m = decode_metrics(torch, dec, full)
    mc = decode_metrics(torch, ctl, full[:, :CONTROL_STEPS])
    blocks = (chunked_blocks(torch, cfg, model) if kind == "recurrent"
              else None)
    out["decode_vs_forward"] = {"B": ZOO_CHECK_B, "S": s, "bound": bound,
                                "metrics": m, "control": mc,
                                "with_capacity": capped,
                                "blocks": blocks,
                                "seconds": time.perf_counter() - t0}
    if capped is not None:
        log(f"  {name} decode vs the forward at its configured capacity "
            "(not held to the bound): "
            + ", ".join(f"{k} {v:.5f}" for k, v in capped.items()))
    log(f"  {name} decode vs forward, B={ZOO_CHECK_B} x S={s}: "
        + ", ".join(f"{k} {v:.5f}" for k, v in m.items())
        + f" (bound {bound}); control (state zeroed each step, "
        f"{CONTROL_STEPS} steps): "
        + ", ".join(f"{k} {v:.5f}" for k, v in mc.items()))
    if blocks is None:
        need(within(m, bound), f"{name}: decode disagrees with the forward: "
             f"{m}, bound {bound}")
        need(not within(mc, bound), f"{name}: the control ({mc}) is inside "
             f"the bound {bound}: the check is not tight")
    del full, dec, ctl

    cache = model.init_cache(ZOO_CHECK_B, s)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_step(cache, toks[:, :1], 0)
        model.forward(toks, **extra)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"  {name}: one decode step and one forward ran under sync debug "
        "mode 'error': no host sync")

    prompt = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_P), generator=gen,
                           device="cuda", dtype=torch.int32)
    steps = SERVE_P + SERVE_G - 1
    # warm: the decode check above ran the same decode step
    got, wall = counted("generate", lambda: generate(model, prompt, SERVE_G),
                        {"rmsnorm": steps * expect["decode_step"]["rmsnorm"]})
    need(got.shape == (SERVE_B, SERVE_G) and got.dtype == torch.int32,
         f"{name} generated {tuple(got.shape)} {got.dtype}")
    host = got.cpu()
    need(bool(((host >= 0) & (host < cfg.vocab)).all()),
         f"{name}: generated token ids out of range")
    out["serve"] = {"wall_s": wall, "ms_per_step": wall / steps * 1e3,
                    "tokens_per_s": SERVE_B * SERVE_G / wall}
    log(f"  {name} generate {SERVE_B} x ({SERVE_P} + {SERVE_G}): "
        f"{wall:.3f} s, {wall / steps * 1e3:.2f} ms/step, "
        f"{SERVE_B * SERVE_G / wall:.1f} tokens/s; sample "
        f"{host[0, :8].tolist()}")
    out["peak_bytes"] = peaks
    log(f"  {name} peak device memory: " + ", ".join(
        f"{k} {v / 1e9:.2f} GB" for k, v in peaks.items()))
    del model, cache, toks, extra
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_model
    return out


def zoo_phase(torch, build) -> tuple:
    """Phase 12: 12a the kernels at the new families' shapes, 12b the
    reduced models card against CPU, 12c each family at published widths.
    Returns the launches of 12c's counted runs and the phase's record."""
    t_phase = time.perf_counter()
    out = {}
    log("[12a] flash attention and RMSNorm at the new families' shapes")
    out["kernels"] = zoo_kernel_checks(torch)
    build.reset_launches()
    log("[12b] card port vs CPU port on the reduced "
        + ", ".join(ZOO_REDUCED))
    out["card_vs_cpu"] = zoo_card_vs_cpu(torch)
    build.reset_launches()
    totals = {name: 0 for name in build.LAUNCHES}
    for name in ZOO:
        log(f"[12c] {name} at its published widths")
        out[name] = zoo_model(torch, build, name, totals)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 12: {out['seconds']:.1f} s")
    return totals, out


# ---------------------------------------------------------------------------
# Phase 13: training on the card
# ---------------------------------------------------------------------------

#: 13c: the widest registry arch whose AdamW state fits one card (1.64e9
#: parameters: 3.3 GB of bf16 weights, 3.3 GB of gradients, 19.7 GB of f32
#: master weights and moments), published widths and depth, random weights
#: from seed 0, batch 4 x 2,048; a checkpoint every 5 steps, and a resume
#: from step 5 whose losses must equal the uninterrupted run's
TRAIN_ARCH = "stablelm-1.6b"
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT_EVERY = 4, 2048, 10, 5
#: 13d: the train_lm example at published widths (smollm-135m, 8 x 128)
TRAIN_LM_STEPS = 12
#: 13b: the reduced archs' batch and TrainLoop steps on the card
TRAIN_SMALL_B, TRAIN_SMALL_S, TRAIN_SMALL_STEPS = 2, 32, 5
#: the backward kernels' timing: slow calls, few of them
BWD_TIMING = dict(calls=3, windows=3, warmup=1)
#: 13a's bf16 rule: the kernel's largest error against the f32 reference
#: (autograd through the plain f32 forward) at most twice that of autograd
#: through the plain bf16 forward, plus a floor of one bf16 rounding step
#: at the output's largest value (FlashAttention's own test rule, whose
#: bf16 reference runs in bf16; ours computes in f32 and rounds once, so
#: its error is at most half a step and the floor keeps a one-step
#: difference of rounding from failing the rule)
BWD_BF16_FLOOR = 2 ** -8
#: 13a's f32 rule (relative to the output's largest value) and the lse's
BWD_F32_TOL, LSE_TOL = 1e-4, 1e-4
#: 13a's flash shapes: (label, B, Sq, Sk, H, KV, D, causal, window,
#: offset). ``offset`` > 0 adds to q and to k a vector common to every row
#: of a head (offset x a standard normal draw), as trained activations
#: carry: dS sums to zero along each query row, so the keys' common part
#: cancels from dQ in exact arithmetic and an error in dS or in delta
#: shows against it
TRAIN_FLASH_SHAPES = (
    ("stablelm-1.6b", 4, 2048, 2048, 32, 32, 64, True, 0, 0),
    ("stablelm-1.6b, q and k offset", 4, 2048, 2048, 32, 32, 64, True, 0,
     2.0),
    ("qwen2.5-14b (GQA)", 4, 2048, 2048, 40, 8, 128, True, 0, 0),
    ("smollm-135m", 8, 128, 128, 9, 3, 64, True, 0, 0),
    ("zamba2 window 512", 4, 2048, 2048, 32, 32, 80, True, 512, 0),
    ("MLA prefill (B = 1)", 1, 2048, 2048, 128, 128, 192, True, 0, 0),
    ("MLA prefill, q and k offset", 1, 2048, 2048, 128, 128, 192, True, 0,
     2.0),
    ("whisper encoder", 4, 1500, 1500, 8, 8, 64, False, 0, 0),
    ("whisper cross", 4, 448, 1500, 8, 8, 64, False, 0, 0),
)
#: 13a's RMSNorm shapes: (label, rows, D)
TRAIN_NORM_SHAPES = (("smollm-135m", 8 * 128, 576),
                     ("stablelm-1.6b", TRAIN_B * TRAIN_S, 2048))


def grads_of(torch, fn, inputs, dout):
    """Autograd's gradients of ``fn(*inputs)`` against ``dout``, the inputs
    taken as fresh leaves."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, dout)


def bwd_errors(torch, got, plain, ref, dtype):
    """13a's rule for each output: f32 within ``BWD_F32_TOL`` of the
    reference's largest value; bf16 at most twice the plain bf16 autograd's
    largest error plus ``BWD_BF16_FLOOR`` of that value. Returns the
    kernel's largest error over the outputs and each output's record."""
    recs = []
    for g, p, r in zip(got, plain, ref):
        r = r.float()
        top = float(r.abs().max())
        err = float((g.float() - r).abs().max())
        perr = float((p.float() - r).abs().max())
        if dtype == torch.float32:
            ok = err <= BWD_F32_TOL * top
        else:
            ok = err <= 2 * perr + BWD_BF16_FLOOR * top
        recs.append({"err": err, "plain_err": perr, "max_ref": top,
                     "ok": ok})
    return max(r["err"] for r in recs), recs


def library_backward(torch, fn, inputs, dout):
    """A closure that runs only the backward of ``fn`` (a library call) on
    fresh leaves of ``inputs``: the graph is built once and kept."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def train_kernel_checks(torch):
    """13a: the RMSNorm and flash-attention backward kernels and the
    forward's lse against their plain versions at the training shapes, bf16
    and f32: the f32 reference is autograd through the plain f32 forward
    on f32 copies of the inputs; bf16 under the rule of
    :func:`bwd_errors`, f32 within 1e-4 relative, the lse within 1e-4. Each
    timed beside its plain version, its bound and the library's backward
    (``F.rms_norm``, SDPA with the same mask, through autograd; the port
    never calls them). Returns the two rows of the kernels line (bf16 at
    stablelm-1.6b's shapes) and every case's record."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_ref,
        flash_attention_cuda, flash_attention_lse_ref, flash_attention_ref)
    from repro_torch.kernels.rmsnorm.rmsnorm import (
        rmsnorm_bwd_cuda, rmsnorm_bwd_ref, rmsnorm_ref)

    F = torch.nn.functional
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    rows, cases, bad = {}, [], []
    eps = 1e-5
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.finfo(dtype).bits // 8
        for label, r, d in TRAIN_NORM_SHAPES:
            x = torch.randn((r, d), generator=gen, device=dev).to(dtype)
            scale = (1 + 0.1 * torch.randn((d,), generator=gen,
                                           device=dev)).to(dtype)
            dy = torch.randn((r, d), generator=gen, device=dev).to(dtype)
            got = rmsnorm_bwd_cuda(x, scale, dy, eps)
            plain = grads_of(torch, lambda a, s: rmsnorm_ref(a, s, eps),
                             (x, scale), dy)
            ref = grads_of(torch, lambda a, s: rmsnorm_ref(a, s, eps),
                           (x.float(), scale.float()), dy.float())
            torch.cuda.synchronize()
            err, recs = bwd_errors(torch, got, plain, ref, dtype)
            if not all(c["ok"] for c in recs):
                bad.append(f"rmsnorm_bwd {dtype} {label}: {recs}")
            timed = time_call(torch, lambda: rmsnorm_bwd_cuda(x, scale, dy,
                                                              eps),
                              device=True)
            plain_ms = time_ms(torch, lambda: rmsnorm_bwd_ref(x, scale, dy,
                                                              eps))
            lib = time_call(torch, library_backward(
                torch, lambda a, s: F.rms_norm(a, (d,), s, eps), (x, scale),
                dy), device=True)
            # x, dy and scale read once, dx and dscale written once (the
            # kernel's partial column sums are its own scratch)
            nbytes = 3 * r * d * es + 2 * d * es
            row = kernel_row(
                "rmsnorm_bwd", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                "none: the port's own backward of "
                "src/repro/kernels/rmsnorm/rmsnorm.py:23", err, timed,
                plain_ms, nbytes, lib["ms"], ops=10 * r * d,
                op_rate=F32_FLOPS)
            cases.append(dict(row, shape=[r, d], dtype=str(dtype), at=label,
                              outputs=recs, library=lib))
            if dtype == torch.bfloat16 and label == TRAIN_ARCH:
                rows["rmsnorm_bwd"] = row
            del x, scale, dy, got, plain, ref
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.finfo(dtype).bits // 8
        rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        for (label, b, sq, sk, h, kv, d, causal, window,
             offset) in TRAIN_FLASH_SHAPES:
            def draw(*shape, common=0.0):
                x = torch.randn(shape, generator=gen, device=dev)
                if common:  # one vector a head, shared by its rows
                    x += common * torch.randn((shape[0], 1, *shape[2:]),
                                              generator=gen, device=dev)
                return x.to(dtype)
            q, k = draw(b, sq, h, d, common=offset), draw(b, sk, kv, d,
                                                          common=offset)
            v, dout = draw(b, sk, kv, d), draw(b, sq, h, d)
            out, lse = flash_attention_cuda(q, k, v, causal, window,
                                            return_lse=True)
            want_lse = flash_attention_lse_ref(q, k, causal, window)
            lse_err = float((lse - want_lse).abs().max())
            if not lse_err <= LSE_TOL:
                bad.append(f"lse {dtype} {label}: {lse_err}")
            del want_lse
            got = flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal,
                                           window)
            again = flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal,
                                             window)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                bad.append(f"flash_attention_bwd {dtype} {label}: two calls "
                           "differ")
            del again
            fn = lambda a, b_, c: flash_attention_ref(a, b_, c, causal,
                                                      window)
            plain = grads_of(torch, fn, (q, k, v), dout)
            torch.cuda.empty_cache()
            ref = grads_of(torch, fn, (q.float(), k.float(), v.float()),
                           dout.float())
            torch.cuda.synchronize()
            err, recs = bwd_errors(torch, got, plain, ref, dtype)
            if not all(c["ok"] for c in recs):
                bad.append(f"flash_attention_bwd {dtype} {label}: {recs}")
            del plain, ref, got
            torch.cuda.empty_cache()
            timed = time_call(torch, lambda: flash_attention_bwd_cuda(
                q, k, v, out, dout, lse, causal, window), device=True,
                **BWD_TIMING)
            plain_ms = time_ms(torch, lambda: flash_attention_bwd_ref(
                q, k, v, out, dout, lse, causal, window), **PLAIN)
            torch.cuda.empty_cache()
            keep = keep_mask(torch, sq, sk, causal, window, dev)
            pairs = int(keep.sum())
            mask = keep if window else None
            sdpa = lambda a, b_, c: F.scaled_dot_product_attention(
                a.transpose(1, 2), b_.transpose(1, 2), c.transpose(1, 2),
                attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)
            lib = time_ms(torch, library_backward(
                torch, sdpa, (q, k, v), dout.transpose(1, 2)), **BWD_TIMING)
            flops = 10 * d * pairs * b * h
            # inputs q, k, v, out, dout, lse read once, dq, dk, dv written
            # once (the kernels' own delta scratch is not counted)
            nbytes = (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) * es \
                + lse.numel() * 4
            row = kernel_row(
                "flash_attention_bwd",
                "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                "none: the port's own backward of src/repro/kernels/"
                "flash_attention/flash_attention.py:68", err, timed,
                plain_ms, nbytes, lib, ops=flops, op_rate=rate)
            # flops a kept pair done: the dQ kernel recomputes S and dP; the
            # bf16 kernels multiply by dS twice (its hi and lo terms) and,
            # above D 64, run dK/dV in two passes that each recompute S^T
            done = (14 if dtype != torch.bfloat16
                    else 18 if d <= 64 else 20)
            log(f"    lse max_abs_err {lse_err:.2e}; kernel "
                f"{done * d * pairs * b * h / timed['ms'] / 1e9:.1f} TFLOP/s "
                f"done ({done} D a pair), {row['bound_ms'] / timed['ms']:.1%} "
                f"of its bound, {timed['ms'] / lib:.2f}x SDPA's backward")
            cases.append(dict(row, shape=[b, sq, sk, h, kv, d],
                              causal=causal, window=window, offset=offset,
                              dtype=str(dtype),
                              at=label, outputs=recs, lse_err=lse_err))
            if dtype == torch.bfloat16 and label == TRAIN_ARCH:
                rows["flash_attention_bwd"] = row
            del q, k, v, dout, out, lse
            torch.cuda.empty_cache()
    need(not bad, "13a: " + "; ".join(bad))
    return [rows["rmsnorm_bwd"], rows["flash_attention_bwd"]], cases


def grad_errors(torch, got, base, ref):
    """Per gradient leaf the mean absolute error relative to the f32
    reference's mean magnitude, of the card's (``got``) and the CPU's bf16
    (``base``) gradients; 6b's rule over the leaves: the card's mean at
    most 1.25x the CPU's, its largest at most 2x."""
    card, cpu = [], []
    for g, c, r in zip(got, base, ref):
        r = r.float()
        scale = float(r.abs().mean()) or 1.0
        card.append(float((g.float().cpu() - r).abs().mean()) / scale)
        cpu.append(float((c.float() - r).abs().mean()) / scale)
    e = {"card_mean": statistics.fmean(card), "card_max": max(card),
         "cpu_mean": statistics.fmean(cpu), "cpu_max": max(cpu),
         "leaves": len(card)}
    e["ok"] = (e["card_mean"] <= 1.25 * e["cpu_mean"]
               and e["card_max"] <= 2 * e["cpu_max"])
    return e


def train_card_vs_cpu(torch):
    """13b: every registry arch, reduced, the same bf16 weights on the card
    and on the CPU (drawn on the CPU from a seed, then moved): the loss and
    every gradient leaf against the CPU's f32 run of the same weights,
    under 6b's rule (the loss as one logit, the leaves by
    :func:`grad_errors`); the MoE archs' bf16 runs take the f32 run's
    experts (:class:`RouteLog`), as 12b's do. Then ``TrainLoop`` on the
    card for ``TRAIN_SMALL_STEPS`` steps of the synthetic tokens: the loss
    falls."""
    import copy

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import build_model, make_batch
    from repro_torch.training.data import DataConfig, global_batch
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import TrainLoop

    torch.backends.cuda.matmul.allow_tf32 = False
    out, bad = {}, []
    shape = ShapeConfig("t", seq_len=TRAIN_SMALL_S,
                        global_batch=TRAIN_SMALL_B, kind="train")
    for name in sorted(ARCHS):
        cfg = ARCHS[name].reduced()
        cpu = build_model(cfg, device="cpu", seed=5)
        cpu32 = copy.deepcopy(cpu).float()
        card = copy.deepcopy(cpu).to("cuda")
        batch = make_batch(cfg, shape, torch.Generator().manual_seed(6))
        runs, force = [], None
        for m in (cpu32, card, cpu):
            with RouteLog(force=force) as routes:
                loss = m.loss(batch)
                grads = torch.autograd.grad(loss, list(m.parameters()))
            force = routes if force is None else force
            runs.append((loss.detach().float().cpu(),
                         [g.detach().float().cpu() for g in grads]))
        (l32, g32), (lcard, gcard), (lcpu, gcpu) = runs
        rec = {"loss": logit_errors(lcard, lcpu, l32),
               "grads": grad_errors(torch, gcard, gcpu, g32)}
        e = rec["loss"]
        # one value: the card's loss as close as the CPU's, or within a
        # bf16 step of the f32 loss
        loss_ok = e["card_max"] <= max(2 * e["cpu_max"],
                                       2 ** -8 * float(l32.abs()))
        if not (loss_ok and rec["grads"]["ok"]):
            bad.append(f"{name}: {rec}")
        del cpu, cpu32, runs, g32, gcard, gcpu
        dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SMALL_S,
                        global_batch=TRAIN_SMALL_B, seed=7)
        steps = []
        for s in range(TRAIN_SMALL_STEPS):
            b = global_batch(dc, s)
            b.update({k: v for k, v in batch.items()
                      if k in ("patch_embeds", "frames")})
            steps.append(b)
        _, hist = TrainLoop(card, AdamWConfig(
            lr=3e-3, warmup_steps=1, total_steps=TRAIN_SMALL_STEPS)).run(steps)
        rec["losses"] = [h["loss"] for h in hist]
        if not (rec["losses"][-1] < rec["losses"][0]
                and not any(h["skipped"] for h in hist)):
            bad.append(f"{name}: the loss did not fall on the card: "
                       f"{rec['losses']}")
        out[name] = rec
        g = rec["grads"]
        log(f"  {name} (reduced): loss card {float(lcard):.5f} CPU bf16 "
            f"{float(lcpu):.5f} f32 {float(l32):.5f}; gradient leaves "
            f"|card - f32| / |f32| mean {g['card_mean']:.2e} max "
            f"{g['card_max']:.2e} (CPU bf16 {g['cpu_mean']:.2e} / "
            f"{g['cpu_max']:.2e}); TrainLoop losses "
            + " ".join(f"{x:.3f}" for x in rec["losses"]))
        del card
        torch.cuda.empty_cache()
    need(not bad, "13b: " + "; ".join(bad))
    return out


def train_launches(cfg) -> dict:
    """Exact kernel launches of one train step of a dense decoder: every
    norm once forward and once backward (2 a layer and the final one),
    every attention once forward and once backward (one counted call of the
    backward launches its three kernels: delta, dK/dV, dQ)."""
    norms, flash = 2 * cfg.n_layers + 1, cfg.n_layers
    return {"rmsnorm": norms, "rmsnorm_bwd": norms,
            "flash_attention": flash, "flash_attention_bwd": flash}


def train_profile(torch, step, state, batch, wall_s, top=10):
    """Device time by kernel of one train step (``torch.profiler``) and the
    device's busy share of the unprofiled step wall ``wall_s``; ``None``
    where the profiler records no device time on this machine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    recs = sorted(
        ((e.self_device_time_total, e.key, e.count)
         for e in prof.key_averages()
         if getattr(e, "device_type", None) == DeviceType.CUDA
         and e.self_device_time_total > 0
         and e.key != "Command Buffer Full"), reverse=True)
    if not recs:
        log("  profile train step: no device time recorded")
        return state, None
    busy = sum(r[0] for r in recs) / 1e3
    wall = wall_s * 1e3
    out = {"device_busy_ms": busy, "wall_ms": wall,
           "idle_share": max(0.0, 1 - busy / wall),
           "launches": sum(r[2] for r in recs),
           "top": [{"name": k[:90], "device_ms": us / 1e3, "count": c}
                   for us, k, c in recs[:top]]}
    log(f"  profile train step: device busy {busy:.1f} ms of {wall:.1f} ms "
        f"unprofiled wall (idle {out['idle_share']:.1%}), "
        f"{out['launches']} device records")
    for us, k, c in recs[:top]:
        log(f"    {us / 1e3:9.3f} ms  x{c:<5} {k[:80]}")
    return state, out


class Timed:
    """While active, the named functions of ``module`` are timed: the
    record maps each name to the wall seconds of its calls."""

    def __init__(self, module, *names):
        self.module, self.names = module, names

    def __enter__(self):
        self.orig = {n: getattr(self.module, n) for n in self.names}
        self.record = {n: [] for n in self.names}

        def timed(name, fn):
            def call(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    self.record[name].append(time.perf_counter() - t0)
            return call
        for n, fn in self.orig.items():
            setattr(self.module, n, timed(n, fn))
        return self.record

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.module, n, fn)


def train_main_path(torch, build, totals) -> dict:
    """13c: ``repro_torch.launch.train`` (through ``TrainLoop``) for
    ``TRAIN_ARCH`` at its published widths and depth, random weights from
    seed 0, ``TRAIN_B`` x ``TRAIN_S`` tokens, ``TRAIN_STEPS`` steps with a
    checkpoint every ``TRAIN_CKPT_EVERY``: the loss falls, the exact
    launches a step (:func:`train_launches`), ms a step, tokens/s, the
    peak; one more step profiled and one under sync debug mode "error" (the
    loss read after it); then a fresh model resumed from the step-5
    checkpoint trains steps 5..9, whose losses must equal the uninterrupted
    run's bit for bit. Launches of the two counted runs are added to
    ``totals``."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        BWD_COPIES)
    from repro_torch.launch import train
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import DataConfig, global_batch
    from repro_torch.training.train_step import make_train_step, to_device

    out = {}
    tmp = tempfile.mkdtemp(prefix="repro_train_ckpt_")
    try:
        argv = ["--arch", TRAIN_ARCH, "--full", "--steps", str(TRAIN_STEPS),
                "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
                "--ckpt-dir", tmp, "--ckpt-every", str(TRAIN_CKPT_EVERY)]
        args = train.parse_args(argv)
        t0 = time.perf_counter()
        model, loop, batches = train.setup(args)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        out["params"] = model.n_params()
        log(f"  {TRAIN_ARCH}: {out['params']:,} parameters drawn in "
            f"{out['init_s']:.2f} s; disk free for checkpoints "
            f"{shutil.disk_usage(tmp).free / 1e9:.1f} GB")
        want = train_launches(model.cfg)
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        copies = BWD_COPIES["flash_attention_bwd"]
        t0 = time.perf_counter()
        with Timed(ckpt, "save", "restore") as io_s:
            state, hist = loop.run(batches)
        torch.cuda.synchronize()
        out["run_s"] = time.perf_counter() - t0
        out["bwd_tma_copies"] = BWD_COPIES["flash_attention_bwd"] - copies
        out["save_s"] = io_s["save"]
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        got = {k: build.LAUNCHES[k] for k in want}
        for k, n in got.items():
            totals[k] += n
        need(all(got[k] == TRAIN_STEPS * n for k, n in want.items()),
             f"13c launches {got}, expected {TRAIN_STEPS} x {want}")
        need(sum(build.LAUNCHES.values()) == sum(got.values()),
             f"13c launched other kernels: {dict(build.LAUNCHES)}")
        losses = [h["loss"] for h in hist]
        step_s = statistics.median(h["time_s"] for h in hist[1:])
        out.update(losses=losses, step_ms=[h["time_s"] * 1e3 for h in hist],
                   median_step_ms=step_s * 1e3,
                   tokens_per_s=TRAIN_B * TRAIN_S / step_s,
                   launches_per_step=want,
                   skipped=[h["skipped"] for h in hist])
        need(len(hist) == TRAIN_STEPS and not any(out["skipped"]),
             f"13c: {len(hist)} steps, skipped {out['skipped']}")
        # the launcher's defaults (lr 1e-3, one warm-up step at 10 steps):
        # the loss rises at steps 2-4 before it falls, at lr 1e-3, 3e-4 and
        # 1e-4 alike, as the reference's does at smollm-135m's widths
        # (tests/train_full_width_parity.py; PERF.md, PR 26), so the end
        # of the run is held below its start
        need(losses[-1] < losses[0] and statistics.fmean(losses[-3:])
             < statistics.fmean(losses[:3]),
             f"13c: the loss did not fall: {losses}")
        log(f"  {TRAIN_STEPS} steps: losses "
            + " ".join(f"{x:.4f}" for x in losses))
        log(f"  step {step_s * 1e3:.1f} ms (median of steps 1-"
            f"{TRAIN_STEPS - 1}; step 0 {hist[0]['time_s'] * 1e3:.1f} ms), "
            f"{out['tokens_per_s']:,.0f} tokens/s, peak "
            f"{out['peak_bytes'] / 1e9:.2f} GB; launches a step {want} "
            f"(the backward's {want['flash_attention_bwd']} calls launch "
            "3 kernels each, its rmsnorm_bwd calls 2); operands the flash "
            f"backward copied for TMA: {out['bwd_tma_copies']}")

        step = make_train_step(model, loop.opt_cfg)
        dc = DataConfig(vocab=model.cfg.vocab, seq_len=TRAIN_S,
                        global_batch=TRAIN_B)
        batch = to_device(global_batch(dc, TRAIN_STEPS), model.device)
        state, out["profile"] = train_profile(torch, step, state, batch,
                                              step_s)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, metrics = step(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out["sync_debug_loss"] = float(metrics["loss"])
        need(math.isfinite(out["sync_debug_loss"]), "13c: sync-debug step")
        log(f"  one train step ran under sync debug mode 'error' (loss "
            f"{out['sync_debug_loss']:.4f}): no host sync")
        del model, loop, state, step, batch, metrics
        torch.cuda.empty_cache()

        # resume: the step-5 checkpoint is the latest once step 10's goes;
        # the resumed run saves nothing (its cadence past its last step)
        shutil.rmtree(os.path.join(tmp, f"step_{TRAIN_STEPS:08d}"))
        need(ckpt.latest_step(tmp) == TRAIN_CKPT_EVERY,
             f"13c: checkpoints {os.listdir(tmp)}")
        build.reset_launches()
        t0 = time.perf_counter()
        args.ckpt_every = TRAIN_STEPS + 1
        model, loop, batches = train.setup(args)
        with Timed(ckpt, "save", "restore") as io_s:
            _, hist2 = loop.run(batches)
        torch.cuda.synchronize()
        out["resume_s"] = time.perf_counter() - t0
        out["restore_s"] = io_s["restore"]
        for k in want:
            totals[k] += build.LAUNCHES[k]
        resumed = [h["loss"] for h in hist2]
        out["resumed_losses"] = resumed
        need([h["step"] for h in hist2]
             == list(range(TRAIN_CKPT_EVERY, TRAIN_STEPS))
             and resumed == losses[TRAIN_CKPT_EVERY:],
             f"13c: resumed losses {resumed} differ from the uninterrupted "
             f"run's {losses[TRAIN_CKPT_EVERY:]}")
        log(f"  checkpoints of {TRAIN_ARCH}: saves "
            + ", ".join(f"{x:.1f}" for x in out["save_s"])
            + f" s, restore {out['restore_s'][0]:.1f} s")
        log(f"  resumed from step {TRAIN_CKPT_EVERY} in a fresh model "
            f"({out['resume_s']:.1f} s with the restore): losses of steps "
            f"{TRAIN_CKPT_EVERY}-{TRAIN_STEPS - 1} equal the uninterrupted "
            "run's, bit for bit")
        del model, loop
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def train_example(torch, build, totals) -> dict:
    """13d: ``repro_torch.examples.train_lm --full`` (smollm-135m at its
    published widths and 30 layers, 8 x 128 tokens) for ``TRAIN_LM_STEPS``
    steps: the loss falls; its launches added to ``totals``."""
    from repro_torch.examples import train_lm

    build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        hist = train_lm.main(["--steps", str(TRAIN_LM_STEPS), "--full"])
    wall = time.perf_counter() - t0
    for k in ("rmsnorm", "rmsnorm_bwd", "flash_attention",
              "flash_attention_bwd"):
        totals[k] += build.LAUNCHES[k]
    losses = [h["loss"] for h in hist]
    need(len(hist) == TRAIN_LM_STEPS and losses[-1] < losses[0],
         f"13d: train_lm losses {losses}")
    step_ms = statistics.median(h["time_s"] for h in hist[1:]) * 1e3
    log(f"  train_lm --full: {TRAIN_LM_STEPS} steps in {wall:.1f} s, step "
        f"{step_ms:.1f} ms, losses {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"losses": losses, "wall_s": wall, "median_step_ms": step_ms}


def train_phase(torch, build) -> tuple:
    """Phase 13: 13a the backward kernels and the lse, 13b every reduced
    arch card against CPU and a short TrainLoop, 13c the main path at
    published widths with its checkpoint and resume, 13d the train_lm
    example. Returns the launches of 13c's and 13d's counted runs, the
    kernels line's two rows and the phase's record."""
    t_phase = time.perf_counter()
    out = {}
    log("[13a] the backward kernels and the lse vs their plain versions")
    rows, out["kernels"] = train_kernel_checks(torch)
    build.reset_launches()
    log("[13b] every reduced arch: card port vs CPU port, loss and "
        "gradients; TrainLoop on the card")
    out["card_vs_cpu"] = train_card_vs_cpu(torch)
    totals = {name: 0 for name in build.LAUNCHES}
    log(f"[13c] main path: repro_torch.launch.train, {TRAIN_ARCH} at its "
        f"published widths, {TRAIN_B} x {TRAIN_S}, {TRAIN_STEPS} steps")
    out["main_path"] = train_main_path(torch, build, totals)
    log("[13d] repro_torch.examples.train_lm --full")
    out["train_lm"] = train_example(torch, build, totals)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 13: {out['seconds']:.1f} s")
    return totals, rows, out


# ---------------------------------------------------------------------------
# Phase 14: the dry run
# ---------------------------------------------------------------------------

#: 14a: one cell a family, on the single (16 x 16) mesh
DRYRUN_CELLS = (("qwen2.5-14b", "train_4k"),
                ("deepseek-v2-236b", "prefill_32k"),
                ("zamba2-2.7b", "long_500k"),
                ("xlstm-1.3b", "decode_32k"),
                ("whisper-base", "decode_32k"),
                ("internvl2-26b", "prefill_32k"))
#: a 14a process's time limit, seconds
DRYRUN_TIMEOUT = 600
#: 14b: the mining step's graph (vertices, edges), frontier rows, k, the
#: quick-code dictionary and the workers
MINING_N, MINING_M = 65536, 65536 * 16
MINING_ROWS, MINING_K, MINING_Q, MINING_W = 1 << 20, 5, 512, 4
#: 14b: the rows the CPU's plain route also takes (about 0.8 s a thousand
#: rows on the CPU: the whole frontier would take ~15 min; the card's plain
#: route takes the whole frontier), and the rows whose children give the
#: dictionary
MINING_CPU_ROWS, MINING_DICT_ROWS = 8192, 2048


def dryrun_cells() -> dict:
    """14a: each cell of ``DRYRUN_CELLS`` and the mining cell on both
    meshes counted by ``python -m repro_torch.launch.dryrun`` in a process
    of its own, all at once (``dryrun.count_in_processes``; the counting
    runs on fake tensors: no card). Returns the cells' records by key."""
    from repro_torch.launch import dryrun

    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    jobs = [["--arch", a, "--shape", sh] for a, sh in DRYRUN_CELLS]
    jobs.append(["--mining", "--both-meshes"])
    with tempfile.TemporaryDirectory(prefix="repro_dryrun_") as tmp:
        path = Path(tmp) / "cells.json"
        done = dryrun.count_in_processes(jobs, str(path), len(jobs), env=env,
                                         timeout=DRYRUN_TIMEOUT)
        for flags, (rc, tail) in zip(jobs, done):
            need(rc == 0, f"dry run {' '.join(flags)} exited {rc}: {tail}")
        return json.loads(path.read_text())


def mining_inputs(np, G):
    """14b's inputs: the graph, a frontier of full rows (rows that stopped
    growing are dropped) and the dictionary: the most frequent quick codes
    of the children of one plain step on the frontier's first
    ``MINING_DICT_ROWS`` rows (on the CPU)."""
    import torch

    from repro_torch.core import pattern
    from repro_torch.core.distributed import mining_worker, random_frontier

    g = G.random_labeled(MINING_N, MINING_M, n_labels=8, seed=5,
                         power_law=False)
    deg = np.bincount(g.edges.ravel(), minlength=g.n)
    need(deg.max() <= 64, f"14b graph's maximum degree {deg.max()} > 64")
    members, n_valid = random_frontier(g, MINING_ROWS * 5 // 4, MINING_K,
                                       seed=6)
    full = n_valid == MINING_K
    need(full.sum() >= MINING_ROWS, f"14b: {full.sum()} full rows")
    members = members[full][:MINING_ROWS]
    per = MINING_DICT_ROWS
    dg = G.to_device(g, "cpu")
    m = torch.from_numpy(members[:per])
    nv = torch.full((per,), MINING_K, dtype=torch.int32)
    zero = torch.zeros((MINING_Q, 3), dtype=torch.int64)
    children, count, _ = mining_worker(dg, m, nv, zero, use_pallas=False)
    child_nv = torch.where(torch.arange(per) < count, MINING_K + 1,
                           0).to(torch.int32)
    codes = pattern.quick_pattern_vertex(dg, children, child_nv).codes
    uniq, freq = np.unique(codes[child_nv > 0].numpy(), axis=0,
                           return_counts=True)
    quick = uniq[np.argsort(-freq, kind="stable")][:MINING_Q]
    quick = np.concatenate([quick, np.full((MINING_Q - len(quick), 3), -7)])
    return g, members, int(deg.max()), quick.astype(np.int64)


def mining_step_check(torch, np, G, build) -> tuple:
    """14b (see the module's docstring). Returns the counted launches and
    the record."""
    from repro_torch.core.distributed import make_mesh, mining_step_for_dryrun

    t0 = time.perf_counter()
    g, members, max_deg, quick = mining_inputs(np, G)
    per = MINING_ROWS // MINING_W
    out = {"inputs_s": time.perf_counter() - t0, "max_degree": max_deg,
           "rows": MINING_ROWS, "k": MINING_K, "workers": MINING_W}

    def step(device, w, rows, use_pallas=None):
        """The step over ``w`` workers on ``device`` for ``rows``
        (``use_pallas=False``: the plain route, on the card too)."""
        mesh = make_mesh((w,), ("data",), device=device)
        fn = mining_step_for_dryrun(mesh, axes=("data",),
                                    use_pallas=use_pallas)
        dg = G.to_device(g, device)
        m = torch.from_numpy(rows).to(dg.device).reshape(w, -1, MINING_K)
        nv = torch.full(m.shape[:2], MINING_K, dtype=torch.int32,
                        device=dg.device)
        q = torch.from_numpy(quick).to(dg.device)
        return lambda: fn(dg, m, nv, q)

    card4 = step(None, MINING_W, members)
    torch.cuda.synchronize()
    build.reset_launches()
    got = card4()
    torch.cuda.synchronize()
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    need(launches == {"canonical_check": MINING_W},
         f"14b launches {launches}, expected canonical_check x {MINING_W}")
    got = [t.cpu().numpy() for t in got]
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        card4()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out.update(ms_per_step=statistics.median(walls) * 1e3,
               peak_bytes=torch.cuda.max_memory_allocated(),
               launches=launches)
    children, count, counts = got
    need((counts == counts[0]).all() and counts[0].sum() > 0,
         "14b: psum'd counts differ between workers or are all zero")
    total = np.zeros(MINING_Q, dtype=np.int64)
    for w in range(MINING_W):
        c1, n1, t1 = (t.cpu().numpy() for t in step(
            None, 1, members[w * per:(w + 1) * per])())
        need((c1[0] == children[w]).all() and n1[0] == count[w],
             f"14b: worker {w} differs from a one-worker step on its slice")
        total += t1[0]
    need((total == counts[0]).all(), "14b: psum'd counts differ from the "
         "one-worker steps' sum")
    # the plain route over the whole frontier, on the card
    plain4 = step(None, MINING_W, members, use_pallas=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    plain = plain4()
    torch.cuda.synchronize()
    out.update(plain_ms=(time.perf_counter() - t0) * 1e3,
               plain_peak_bytes=torch.cuda.max_memory_allocated())
    plain_launches = {k: v for k, v in build.LAUNCHES.items() if v}
    need(not plain_launches, f"14b: the plain route launched {plain_launches}")
    for a, b, name in zip(got, plain, ("children", "count", "counts")):
        b = b.cpu().numpy()
        need(a.shape == b.shape and (a == b).all(), f"14b: the kernel's "
             f"{name} differ from the plain route's on the whole frontier")
    del plain, plain4
    torch.cuda.empty_cache()
    few = members[:MINING_CPU_ROWS]
    card = [t.cpu().numpy() for t in step(None, MINING_W, few)()]
    t0 = time.perf_counter()
    cpu = [t.numpy() for t in step("cpu", MINING_W, few)()]
    out["cpu_s"] = time.perf_counter() - t0
    for a, b, name in zip(card, cpu, ("children", "count", "counts")):
        need(a.shape == b.shape and (a == b).all(),
             f"14b: the card's {name} differ from the CPU's plain route")
    out.update(children_kept=[int(c) for c in count],
               patterns_counted=int(counts[0].sum()))
    log(f"  14b: {MINING_W} workers x {per} rows (k {MINING_K}, maximum "
        f"degree {max_deg}): {out['ms_per_step']:.1f} ms a step, peak "
        f"{out['peak_bytes'] / 2**30:.2f} GiB, launches {launches}; "
        f"children {out['children_kept']}, {out['patterns_counted']} "
        f"matched; equal to 4 one-worker steps and, on the whole frontier, "
        f"to the plain route on the card ({out['plain_ms']:.1f} ms, peak "
        f"{out['plain_peak_bytes'] / 2**30:.2f} GiB); on the first "
        f"{MINING_CPU_ROWS} rows equal to the CPU's plain route "
        f"({out['cpu_s']:.1f} s)")
    return launches, out


def roofline_check(forward_s, train_step_ms) -> dict:
    """14c: the dry run's counter on one device for 13c's train step and
    6c's forward: the measured time is at least the bound."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis

    out = {}
    for label, arch, kind, b, s_, measured in (
            ("13c train step", TRAIN_ARCH, "train", TRAIN_B, TRAIN_S,
             train_step_ms / 1e3),
            ("6c forward", MODEL, "prefill", FWD_B, FWD_S, min(forward_s))):
        t0 = time.perf_counter()
        counter, _ = dryrun.count_program(get_arch(arch),
                                          ShapeConfig(label, s_, b, kind),
                                          None)
        roof = analysis.from_counts(counter, 1)
        rec = dict(roof.to_dict(), bound_s=roof.bound_s, measured_s=measured,
                   ratio=measured / roof.bound_s,
                   count_s=time.perf_counter() - t0)
        out[label] = rec
        log(f"  14c {label} ({arch}, {b} x {s_}): measured "
            f"{measured * 1e3:.1f} ms, bound {roof.bound_s * 1e3:.1f} ms "
            f"({roof.bottleneck}; compute {roof.t_compute * 1e3:.1f}, memory "
            f"{roof.t_memory * 1e3:.1f} ms), measured / bound "
            f"{rec['ratio']:.3f}")
        need(measured >= roof.bound_s, f"14c {label}: measured "
             f"{measured * 1e3:.1f} ms beats its bound "
             f"{roof.bound_s * 1e3:.1f} ms: the count is wrong")
    return out


def dryrun_phase(torch, np, G, build, forward_s, train_step_ms) -> tuple:
    """Phase 14: 14a the dry run's cells, 14b the mining step on the card,
    14c the roofline against 6c's and 13c's measured times. Returns 14b's
    counted launches and the phase's record."""
    t_phase = time.perf_counter()
    out = {"total_memory": torch.cuda.get_device_properties(0).total_memory}
    log(f"  card memory (total_memory): {out['total_memory']} B")
    log("[14a] dry-run cells on the fake 16 x 16 mesh (one a family) and "
        "the mining cell on both meshes")
    t0 = time.perf_counter()
    cells = dryrun_cells()
    out["cells_wall_s"] = time.perf_counter() - t0
    out["cells"] = cells
    for key in [f"{a}|{sh}|single" for a, sh in DRYRUN_CELLS] + [
            "mining|single", "mining|multi"]:
        cell = cells.get(key)
        need(cell is not None, f"14a: no record of {key}")
        if cell["status"] != "ok":
            need(cell["status"] == "error" and "aten." in cell["error"],
                 f"14a {key}: {cell}")
            log(f"  {key}: error {cell['error'][:200]}")
            continue
        r = cell["roofline"]
        log(f"  {key}: ok, {cell['count_s']} s, {r['bottleneck']}; compute "
            f"{r['t_compute_s'] * 1e3:.3f} ms, memory "
            f"{r['t_memory_s'] * 1e3:.3f} ms, collective "
            f"{r['t_collective_s'] * 1e3:.3f} ms; per device "
            f"{(r['per_device_hbm'] or 0) / 1e9:.2f} GB")
    log(f"  14a wall {out['cells_wall_s']:.1f} s")
    log("[14b] the fixed-shape mining step on the card")
    totals, out["mining_step"] = mining_step_check(torch, np, G, build)
    torch.cuda.empty_cache()
    log("[14c] the roofline against the card")
    out["roofline"] = roofline_check(forward_s, train_step_ms)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 14: {out['seconds']:.1f} s")
    return totals, out


def kernel_times(torch, np) -> dict:
    """The redesigned kernels of the ``repro_torch`` on ``sys.path`` at the
    main path's shapes on ``mico_like(0.1)``: the radix sort and
    ``seg_unique`` at the first size-2 chunk's child codes and at the
    canonical codes that the device level 2 of a motifs run under
    ``cost_model="force_device"`` re-bins (its last, step 3's), the refine
    at the distinct table that level 2 refines, and the refine of the
    seeded codes of every nv from 2 to 8, the expansion at the chunk
    and at the wide synthetic shape, the halo gather at phase 3's
    neighbour and adjacency tiles, and the bf16 flash backward at
    stablelm-1.6b's training shape (13a's first). At each, exact against
    the plain version (the flash backward: two calls bit for bit), then
    timed."""
    from repro_torch.core import RunConfig, aggregation, graph as G, run
    from repro_torch.core.apps import MotifsApp
    from repro_torch.kernels import aggregate, build, canonical_refine, gather
    from repro_torch.kernels import radix_bin as R
    ops = importlib.import_module(
        "repro_torch.kernels.canonical_check.canonical_check")
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")

    build.library()
    g = G.mico_like(0.1)
    out = {"card": torch.cuda.get_device_name(0),
           "nvidia_smi": nvidia_smi_line(), "gather": {}}
    pg = G.to_partitioned(g, PARTS)
    fi = first_halo(torch, np, pg, g)["fi"]
    for name, table, fill in (
            ("nbr", pg.nbr_sh.reshape(-1, pg.max_degree), -1),
            ("adj", pg.adj_sh.reshape(-1, pg.adj_sh.shape[2]), 0)):
        err = max_abs_err(torch, (gather.gather_rows_cuda(table, fi, fill),),
                          (gather.gather_rows_ref(table, fi, fill),))
        need(err == 0, f"gather_rows differs at the {name} tile ({err})")
        timed = time_call(torch, lambda: gather.gather_rows_cuda(
            table, fi, fill), device=True)
        out["gather"][name] = {k: timed[k] for k in (
            "ms", "host_ms", "device_ms", "host_bound")}
    del pg, fi, table
    label, b, sq, sk, h, kv, d, causal, window, _ = TRAIN_FLASH_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(13)
    q, dout = (torch.randn((b, sq, h, d), generator=gen, device="cuda")
               .bfloat16() for _ in range(2))
    k, v = (torch.randn((b, sk, kv, d), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    o, lse = fa.flash_attention_cuda(q, k, v, causal, window, return_lse=True)
    args = (q, k, v, o, dout, lse, causal, window)
    need(all(torch.equal(x, y) for x, y in zip(
        fa.flash_attention_bwd_cuda(*args), fa.flash_attention_bwd_cuda(*args))),
        "the flash backward's two calls differ")
    out["flash_bwd"] = {"at": label, "ms": time_call(
        torch, lambda: fa.flash_attention_bwd_cuda(*args), **BWD_TIMING)["ms"]}
    del q, k, v, o, dout, lse, args
    # the forward at phase 6a's shape (the shared header must not move it)
    q = torch.randn((FWD_B, FWD_S, 40, 128), generator=gen,
                    device="cuda").bfloat16()
    k, v = (torch.randn((FWD_B, FWD_S, 8, 128), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    out["flash_fwd_ms"] = time_call(
        torch, lambda: fa.flash_attention_cuda(q, k, v, True))["ms"]
    del q, k, v
    torch.cuda.empty_cache()
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
    out["expand"] = expand
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
        ga = res["gather"]
        log(f"{label}: flash_attention {res['flash_fwd_ms']:.4f} ms; "
            f"flash_attention_bwd {res['flash_bwd']['at']} "
            f"{res['flash_bwd']['ms']:.4f} ms; gather_rows nbr "
            f"{ga['nbr']['ms']:.4f} ms (host {ga['nbr']['host_ms']:.4f}, "
            f"device {ga['nbr']['device_ms']}), adj {ga['adj']['ms']:.4f} ms "
            f"(host {ga['adj']['host_ms']:.4f}, device "
            f"{ga['adj']['device_ms']})")
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


def add_launches(totals, phase_totals, phase: str):
    """Add a phase's main-path launches to ``totals`` (and return it), and
    log them: the kernels line's ``launches`` are these sums, and a change
    in one of them is found by its phase."""
    for name, v in phase_totals.items():
        totals[name] += v
    log(f"  phase {phase} main-path launches: "
        f"{ {k: v for k, v in phase_totals.items() if v} }")
    return totals


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", type=Path, default=None,
                        help="also write the run's details to this file")
    parser.add_argument("--kernel-ab", type=Path, default=None,
                        metavar="PARENT_SRC",
                        help="only time the expansion, the radix sort, "
                        "seg_unique, the canonical refine, the halo gather "
                        "and the bf16 flash backward of "
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
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:  # the kernel the next lines report on
            log(f"    {entry.group(1)[:120]}")
        elif ("registers" in line or "spill" in line or "error" in line
              or "C75" in line):
            log(f"      {line.strip()}")

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
        ("motifs", 0.005, MotifsApp(max_size=3), RunConfig(cost_model="off")),
        ("cliques", 0.005, CliquesApp(max_size=4),
         RunConfig(cost_model="off")),
        ("motifs_force_device", 0.005, MotifsApp(max_size=3),
         RunConfig(cost_model="force_device")),
        ("motifs_host_async", 0.005, MotifsApp(max_size=3),
         RunConfig(cost_model="off", canonical_placement="host_async")),
        ("motifs4_force_device", 0.001, MotifsApp(max_size=4),
         RunConfig(cost_model="force_device")),
        ("motifs_partitioned", 0.005, MotifsApp(max_size=3),
         RunConfig(cost_model="off", graph_partition=PARTS)),
        ("cliques_partitioned", 0.005, CliquesApp(max_size=4),
         RunConfig(cost_model="off", graph_partition=PARTS)),
    ])

    # ---- 5. the main path --------------------------------------------------
    log("[5] main path on mico_like(0.1) through repro_torch.core.run")
    totals, runs, level2_table, raw_runs = main_path(
        torch, np, run, RunConfig, G, build, [
        ("motifs_unfused", MotifsApp(max_size=3), RunConfig(cost_model="off")),
        ("motifs_fused", MotifsApp(max_size=3),
         RunConfig(cost_model="off", fused_expand=True)),
        ("cliques", CliquesApp(max_size=4), RunConfig(cost_model="off")),
        ("motifs_force_device", MotifsApp(max_size=3),
         RunConfig(cost_model="force_device")),
        ("motifs_partitioned", MotifsApp(max_size=3),
         RunConfig(cost_model="off", graph_partition=PARTS)),
        ("cliques_partitioned", CliquesApp(max_size=4),
         RunConfig(cost_model="off", graph_partition=PARTS)),
    ])
    totals = add_launches(dict.fromkeys(build.LAUNCHES, 0), totals, "5")
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
    add_launches(totals, model_totals, "6c")

    # ---- 7. frequent subgraph mining ---------------------------------------
    fsm_totals, extra["fsm"], fsm_3edges = fsm_phase(torch, np, run,
                                                     RunConfig, G, build)
    add_launches(totals, fsm_totals, "7")

    # ---- 8. the frontier stores ----------------------------------------------
    extra["stores_card_vs_cpu"] = store_card_vs_cpu(torch, run, RunConfig, G)
    store_totals, extra["stores_main_path"] = store_main_path(
        torch, np, run, RunConfig, G, build, raw_runs)
    motifs5, cliques5 = raw_runs["motifs"], raw_runs["cliques"]
    del raw_runs
    log(f"[8c] the paper's FSM graph at its depth: citeseer_like(1.0), "
        f"{dict(FSM_MAIN_APP, max_size=4)}, budget {FSM_DEPTH_BUDGET} B "
        "(the one-wave run: --fsm-full-depth)")
    extra["fsm_depth"] = fsm_depth_runs(torch, run, RunConfig, G, build,
                                        store_totals, fewer_edges=fsm_3edges,
                                        one_wave=False)
    add_launches(totals, store_totals, "8")

    # ---- 9. the runtime's control plane --------------------------------------
    log("[9] the runtime's control plane: cost model, checkpoints, "
        "supervised recovery, tracing")
    control_totals, extra["control_plane"] = control_plane_phase(
        torch, np, G, build, motifs5, fsm_3edges)
    add_launches(totals, control_totals, "9")

    # ---- 10. the distributed backend -----------------------------------------
    log(f"[10] the shard-map backend: {PARTS} virtual workers on the card")
    shard_totals, extra["distributed"] = distributed_phase(
        torch, np, G, build, motifs5, cliques5, fsm_3edges)
    del motifs5, cliques5, fsm_3edges
    add_launches(totals, shard_totals, "10")

    # ---- 11. the oracles, Table 1's SN and Patents graphs, the examples -----
    log("[11] the exact oracles, Table 1's SN and Patents graphs, the "
        "examples")
    oracle_totals, extra["oracles"] = oracle_phase(torch, np, run, RunConfig,
                                                   G, build)
    add_launches(totals, oracle_totals, "11")

    # ---- 12. the rest of the model zoo's serving path ----------------------
    log("[12] the model zoo's other families: MoE with MLA, the Mamba2 "
        "hybrid, xLSTM, Whisper, the VLM")
    zoo_totals, extra["zoo"] = zoo_phase(torch, build)
    add_launches(totals, zoo_totals, "12")

    # ---- 13. training ---------------------------------------------------------
    log("[13] training on the card: the loss, AdamW, the train loop and its "
        "checkpoints, both kernels in both directions")
    train_totals, rows, extra["training"] = train_phase(torch, build)
    kernels += rows
    add_launches(totals, train_totals, "13")

    # ---- 14. the dry run ------------------------------------------------------
    log("[14] the dry run: the fake production mesh, the mining step, the "
        "roofline against the card")
    dry_totals, extra["dryrun"] = dryrun_phase(
        torch, np, G, build, extra["model_main_path"]["forward_s"],
        extra["training"]["main_path"]["median_step_ms"])
    add_launches(totals, dry_totals, "14")
    for row in kernels:
        row["launches"] = totals[row["name"]]
        need(row["launches"] > 0,
             f"{row['name']} never launched on the main path")
    need(len(kernels) == 13, f"{len(kernels)} kernel rows, expected 13")

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
