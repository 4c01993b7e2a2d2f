"""Multi-pod dry run, port of ``repro.launch.dryrun``.

For every (architecture x shape) cell and production mesh, run the cell's
real step program — loss, backward and AdamW for train shapes,
``forward`` for prefill, ``decode_step`` for decode shapes — at full depth
and the published widths on a mesh of 256 or 512 devices, and record each
device's FLOPs, bytes, collective bytes and memory for the roofline.
Nothing is allocated and nothing runs on a device.

The reference AOT-compiles each program with XLA on 512 forced host
devices and reads the compiler's cost and memory analyses. The port's
analogue:

* the mesh is a ``torch.distributed`` ``DeviceMesh`` over a fake process
  group (``launch.mesh``), entered and left by each cell; the multi-pod
  mesh is counted as its equivalent 32 x 16 (``mesh.counting_mesh``);
* the parameters are the meta skeleton (``models.lm.skeleton``) placed as
  DTensors by the reference's spec rules (``models.layers.
  build_param_specs``; the optimizer state by ``training.optimizer.
  opt_state_specs``, the batch by :func:`batch_specs`, the cache by
  :func:`cache_specs_tree`), inside the reference's activation layout
  (``layers.activation_sharding``, unless ``--no-act-constraints``);
* the step runs on fake tensors under ``roofline.counter.StepCounter``,
  which counts each operation DTensor runs on a device's local shards:
  the count is one device's, as XLA's per-device module is;
* the work DTensor cannot partition by its own rules (the MoE's routing,
  the recurrent scans, pads, the loss, a decode step's merges of heads)
  runs on each device's own shards (``launch.sharded``), and three pieces
  of DTensor are changed for the count (``sharded.dtensor_patches``);
* the hand-written kernels charge their own FLOPs and bytes
  (``kernels.counting``) instead of running;
* the port's layers are Python loops, so every layer is counted: no depth
  ladder (``extrapolation`` is null);
* ``decode_step`` takes ``pos`` as a Python int: the count is at the last
  position (``seq_len - 1``), where it reads the whole cache, as the
  reference's masked step does at every position.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
      [--shape S] [--multi-pod | --both-meshes] [--all] [--mining]
      [--force] [--no-act-constraints] [--results PATH] [--jobs N]
Results accumulate in ``dryrun_results.json`` at the root of the
checkout (an incremental cache keyed "arch|shape|single|multi", and
"mining|single|multi"). ``--mining`` alone counts the mining cells, as the
reference's; with ``--all`` it also counts every model cell. ``--jobs N``
counts N (arch, shape, mesh) cells at once, each in a process of its own.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES, SHAPE_BY_NAME, cell_is_runnable
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.launch.mesh import counting_mesh, dp_axes, production_mesh
from repro_torch.models import lm
from repro_torch.models import layers as L
from repro_torch.roofline import analysis

RESULTS_PATH = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "dryrun_results.json"))


# ---------------------------------------------------------------------------
# Sharding assignment
# ---------------------------------------------------------------------------

def _axis_size(mesh, axes):
    sizes = L.mesh_sizes(mesh)
    s = 1
    for a in axes if isinstance(axes, tuple) else (axes,):
        s *= sizes[a]
    return s


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def batch_specs(batch_struct, mesh):
    """The batch dimension over the data axes where they divide it."""
    dp = dp_axes(mesh)
    dps = _axis_size(mesh, dp)

    def rule(leaf):
        spec = [None] * len(leaf.shape)
        if len(leaf.shape) >= 1 and leaf.shape[0] % dps == 0 and leaf.shape[0] > 1:
            spec[0] = dp
        return L.P(*spec)

    return _map(rule, batch_struct)


def cache_specs_tree(cache_struct, mesh, batch: int, seq: int):
    """Cache sharding by size matching: batch dim -> dp axes; the cache
    sequence dim -> 'model' (flash-decoding style KV split); fall back to
    sharding the largest divisible trailing dim over 'model'."""
    dp = dp_axes(mesh)
    dps = _axis_size(mesh, dp)
    tps = L.mesh_sizes(mesh)["model"]

    def rule(leaf):
        shape = leaf.shape
        spec = [None] * len(shape)
        used_tp = False
        bi = next((i for i in range(1, len(shape)) if shape[i] == batch), None)
        if bi is not None and batch % dps == 0 and batch > 1:
            spec[bi] = dp
        si = next(
            (i for i in range(1, len(shape)) if shape[i] == seq and i != bi), None
        )
        if si is not None and seq % tps == 0:
            spec[si] = "model"
            used_tp = True
        if not used_tp:
            cands = [
                i
                for i in range(1, len(shape))
                if i != bi and spec[i] is None and shape[i] % tps == 0 and shape[i] >= tps
            ]
            if cands:
                best = max(cands, key=lambda i: shape[i])
                spec[best] = "model"
        return L.P(*spec)

    return _map(rule, cache_struct)


def place(meta: torch.Tensor, spec, mesh):
    """A DTensor of ``meta``'s shape and dtype placed by ``spec`` on
    ``mesh``, its local shard an empty tensor of the active fake mode (with
    no mesh, that tensor itself: one device holds it whole)."""
    from torch.distributed.tensor import DTensor

    if mesh is None:
        return torch.empty(meta.shape, dtype=meta.dtype)
    sizes = L.mesh_sizes(mesh)
    local = list(meta.shape)
    for i, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            local[i] //= sizes[a]
    loc = torch.empty(local, dtype=meta.dtype)
    return DTensor.from_local(loc, mesh, L.spec_placements(spec, mesh),
                              run_check=False, shape=meta.shape,
                              stride=_contiguous(meta.shape))


def _contiguous(shape):
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def _local_bytes(tree) -> int:
    total = 0

    def add(t):
        nonlocal total
        loc = t.to_local() if hasattr(t, "to_local") else t
        total += loc.numel() * loc.element_size()

    _map(add, tree)
    return total


def _place_model(model, specs, mesh, requires_grad: bool):
    """Every parameter of the meta ``model`` replaced by its DTensor."""
    for name, prm in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        setattr(mod, leaf, torch.nn.Parameter(place(prm, specs[name], mesh),
                                              requires_grad=requires_grad))


# ---------------------------------------------------------------------------
# Counting one cell
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _counting_step(mesh, act_constraints: bool):
    """The fake mode and counter, DTensor's implicit replication of plain
    tensors, the kernels' counting mode and the layout, for one step."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.distributed.tensor.parallel import loss_parallel

    from repro_torch.kernels.counting import counting
    from repro_torch.launch.sharded import dtensor_patches, local_forms
    from repro_torch.roofline.counter import StepCounter

    token = L.LAYOUT.set("opt" if act_constraints else "baseline")
    act = (L.activation_sharding(dp_axes(mesh), "model",
                                 L.mesh_sizes(mesh)["model"])
           if act_constraints and mesh is not None
           else contextlib.nullcontext())
    counter = StepCounter()
    try:
        with counter, implicit_replication(), dtensor_patches(counter), \
                local_forms(), counting(counter), loss_parallel(), act:
            yield counter
    finally:
        L.LAYOUT.reset(token)


def count_program(cfg, shape, mesh, act_constraints: bool = True):
    """Run (cfg, shape)'s step program on ``mesh`` under a counter; returns
    the counter (stopped) and the skeleton. ``mesh=None``: the whole
    program on one device (no DTensor)."""
    from repro_torch.training.optimizer import (
        AdamWConfig, OptState, opt_state_specs)
    from repro_torch.training.train_step import make_train_step

    with _counting_step(mesh, act_constraints) as counter:
        model = lm.skeleton(cfg)
        meta_params = dict(model.named_parameters())
        if mesh is None:
            specs = dict.fromkeys(meta_params)
        else:
            fsdp = dp_axes(mesh)
            specs = L.build_param_specs(model, mesh, fsdp)
        train = shape.kind == "train"
        # serving steps run under inference mode, where a view of a tensor
        # made outside it cannot be taken: serving weights are made inside
        with torch.inference_mode(not train):
            _place_model(model, specs, mesh, requires_grad=train)
        params = dict(model.named_parameters())
        args = [params]
        if train:
            ospecs = (opt_state_specs(specs) if mesh is None else
                      opt_state_specs(specs, meta_params, mesh, fsdp))
            f32 = {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
                   for k, p in meta_params.items()}

            def state(spec_tree):
                return {k: place(f32[k], spec_tree[k], mesh) for k in f32}

            opt = OptState(step=place(torch.empty((), dtype=torch.int32,
                                                  device="meta"), L.P(), mesh),
                           master=state(ospecs.master), m=state(ospecs.m),
                           v=state(ospecs.v))
            batch = _placed(lm.train_inputs(cfg, shape), mesh)
            args += [opt.master, opt.m, opt.v, batch]
            step_fn = make_train_step(model, AdamWConfig())
            counter.start(_local_bytes(args))
            out = step_fn(opt, batch)
        elif shape.kind == "prefill":
            batch = _placed(lm.train_inputs(cfg, shape), mesh)
            extra = [batch[k] for k in ("patch_embeds", "frames") if k in batch]
            args.append(batch)
            counter.start(_local_bytes(args))
            out = model.forward(batch["tokens"], *extra)
        else:
            dec = lm.decode_inputs(cfg, shape, model)
            cspecs = (_map(lambda t: None, dec["cache"]) if mesh is None else
                      cache_specs_tree(dec["cache"], mesh,
                                       shape.global_batch, shape.seq_len))
            with torch.inference_mode():   # decode_step's own mode
                cache = _map_pair(lambda t, s: place(t, s, mesh),
                                  dec["cache"], cspecs)
            token = place(dec["token"], None if mesh is None else
                          batch_specs({"t": dec["token"]}, mesh)["t"], mesh)
            args += [cache, token]
            counter.start(_local_bytes(args))
            out = model.decode_step(cache, token, shape.seq_len - 1)
        counter.stop()
        del out
    return counter, model


def _placed(batch, mesh):
    specs = batch_specs(batch, mesh) if mesh is not None else dict.fromkeys(
        batch)
    return {k: place(v, specs[k], mesh) for k, v in batch.items()}


def _map_pair(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_pair(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def lower_cell(arch_name: str, shape_name: str, multi_pod: bool,
               extrapolate: bool = False, act_constraints: bool = True):
    """One cell's record (the reference's keys; ``count_s`` for its
    ``compile_s``). ``extrapolate`` is accepted for the reference's
    signature: the port counts every layer, so there is nothing to
    extrapolate."""
    del extrapolate
    cfg = get_arch(arch_name)
    shape = SHAPE_BY_NAME[shape_name]
    runnable, why = cell_is_runnable(cfg, shape)
    if not runnable:
        return {"status": "skipped", "reason": why}

    with counting_mesh(multi_pod=multi_pod) as mesh:
        chips = mesh.size()
        t0 = time.time()
        counter, model = count_program(cfg, shape, mesh,
                                       act_constraints=act_constraints)
        t_count = time.time() - t0
    mesh_shape = [2, 16, 16] if multi_pod else [16, 16]
    costs = {"flops": counter.flops, "hbm_bytes": counter.hbm_bytes,
             "coll_bytes": float(sum(counter.collectives.values()))}
    mf = analysis.model_flops_for(cfg, shape, model)
    roof = analysis.from_counts(counter, chips, model_flops=mf)
    return {
        "status": "ok",
        "arch": arch_name,
        "shape": shape_name,
        "mesh": mesh_shape,
        "chips": chips,
        "kind": shape.kind,
        "count_s": round(t_count, 1),
        "params": analysis.count_params(model),
        "memory_analysis": {
            "argument_bytes": int(counter.argument_bytes),
            "temp_bytes": int(counter.peak_bytes),
            "output_bytes": int(counter.live_bytes),
        },
        "collectives": dict(counter.collectives),
        "program_costs": costs,
        "kernel_charges": dict(counter.charged),
        "extrapolation": None,
        "roofline": roof.to_dict(),
    }


# ---------------------------------------------------------------------------
# Mining-engine dry-run cell (the paper's own workload on the mesh)
# ---------------------------------------------------------------------------

def lower_mining(multi_pod: bool, n_vertices=65536, max_deg=64,
                 frontier=1 << 20, k=5, n_quick=512):
    """One worker's mining step (``core.distributed.mining_worker``, the
    ``canonical_check`` kernel's route) counted on fake tensors at its
    slice of the frontier (``frontier`` rows over the data axes), plus the
    psum of its (Q,) int32 counts as an all-reduce. The worker holds the
    whole graph (the port's workers replicate it)."""
    from repro_torch.core.distributed import mining_worker
    from repro_torch.core.graph import DeviceGraph
    from repro_torch.kernels.counting import counting
    from repro_torch.roofline.counter import StepCounter

    with production_mesh(multi_pod=multi_pod) as mesh:
        chips = mesh.size()
        mesh_shape = list(mesh.shape)
        n_shards = _axis_size(mesh, dp_axes(mesh))
    per = frontier // n_shards
    w = (n_vertices + 31) // 32
    m = n_vertices * max_deg // 2
    i32 = torch.int32
    t0 = time.time()
    counter = StepCounter()
    with counter, counting(counter):
        g = DeviceGraph(
            labels=torch.empty((n_vertices,), dtype=i32),
            nbr=torch.empty((n_vertices, max_deg), dtype=i32),
            nbr_eid=torch.empty((n_vertices, max_deg), dtype=i32),
            deg=torch.empty((n_vertices,), dtype=i32),
            adj_bits=torch.empty((n_vertices, w), dtype=i32),
            edge_uv=torch.empty((m, 2), dtype=i32),
            edge_labels=torch.empty((m,), dtype=i32),
        )
        members = torch.empty((per, k), dtype=i32)
        n_valid = torch.empty((per,), dtype=i32)
        quick_dict = torch.empty((n_quick, 3), dtype=torch.int64)
        counter.start(_local_bytes(dict(g._asdict(), members=members,
                                        n_valid=n_valid, q=quick_dict)))
        out = mining_worker(g, members, n_valid, quick_dict, use_pallas=True)
        counter.collectives["all-reduce"] += n_quick * 4
        counter.stop()
        del out
    roof = analysis.from_counts(counter, chips)
    return {
        "status": "ok",
        "arch": "arabesque-mining-step",
        "shape": f"frontier{frontier}_n{n_vertices}",
        "mesh": mesh_shape,
        "chips": chips,
        "count_s": round(time.time() - t0, 1),
        "memory_analysis": {
            "argument_bytes": int(counter.argument_bytes),
            "temp_bytes": int(counter.peak_bytes),
        },
        "collectives": dict(counter.collectives),
        "kernel_charges": dict(counter.charged),
        "roofline": roof.to_dict(),
    }


# ---------------------------------------------------------------------------
# The command line, with an incremental cache
# ---------------------------------------------------------------------------

def load_results(path=None):
    path = path or RESULTS_PATH
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(res, path=None):
    path = path or RESULTS_PATH
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(res, f, indent=1, default=float)
    os.replace(tmp, path)


def _error(e: Exception) -> dict:
    return {"status": "error", "error": f"{type(e).__name__}: {e}"[:2000]}


def count_in_processes(jobs, results_path, n_parallel: int, env=None,
                       timeout=None) -> list:
    """Count each job (a list of this module's flags) in a child process
    of its own, at most ``n_parallel`` at once in the order given, each
    into a results file and a log of its own, and merge each finished
    child's cells into ``results_path``. A child still running after
    ``timeout`` seconds is killed. Returns each job's (return code, or
    None if it was killed; the end of its log), in order."""
    done = [None] * len(jobs)
    pending = list(enumerate(jobs))
    running = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            while pending or running:
                while pending and len(running) < n_parallel:
                    i, flags = pending.pop(0)
                    path = os.path.join(tmp, f"{i}.json")
                    log = open(os.path.join(tmp, f"{i}.log"), "w+")
                    running.append((i, path, log, time.time(), subprocess.Popen(
                        [sys.executable, "-m", "repro_torch.launch.dryrun",
                         "--results", path] + list(flags),
                        env=env, stdout=log, stderr=subprocess.STDOUT)))
                time.sleep(0.5)
                for job in list(running):
                    i, path, log, t0, proc = job
                    late = timeout is not None and time.time() - t0 > timeout
                    if proc.poll() is None and not late:
                        continue
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                    running.remove(job)
                    results = load_results(results_path)
                    results.update(load_results(path))
                    save_results(results, results_path)
                    log.seek(0)
                    done[i] = (None if late else proc.returncode,
                               log.read()[-2000:])
                    log.close()
        finally:
            for _, _, log, _, proc in running:
                proc.kill()
                proc.wait()
                log.close()
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mining", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-act-constraints", action="store_true",
                    help="the baseline layout: weights also sharded over "
                         "the data axes, no activation constraints")
    ap.add_argument("--results", default=None,
                    help="alternate results JSON path")
    ap.add_argument("--jobs", type=int, default=1,
                    help="(arch, shape) cells counted at once, each in a "
                         "process of its own")
    args = ap.parse_args(argv)
    global RESULTS_PATH
    if args.results:
        RESULTS_PATH = os.path.abspath(args.results)

    results = load_results()
    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else [s.name for s in SHAPES]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    if args.mining:
        for mp in meshes:
            key = f"mining|{'multi' if mp else 'single'}"
            if key in results and not args.force:
                continue
            print(f"[dryrun] {key} ...", flush=True)
            try:
                results[key] = lower_mining(mp)
                r = results[key]["roofline"]
                print(f"  ok count={results[key]['count_s']}s "
                      f"bottleneck={r['bottleneck']}", flush=True)
            except Exception as e:
                results[key] = _error(e)
                traceback.print_exc()
            save_results(results)
        if not args.all:
            return results

    if args.jobs > 1 and len(archs) * len(shapes) * len(meshes) > 1:
        # shape by shape, so that the long train and prefill cells start
        # first; each child counts its cell afresh, so cached cells stay
        flags = ["--no-act-constraints"] if args.no_act_constraints else []
        todo = [["--arch", a, "--shape", sh] + flags
                + (["--multi-pod"] if mp else [])
                for sh in shapes for a in archs for mp in meshes
                if args.force or results.get(
                    f"{a}|{sh}|{'multi' if mp else 'single'}", {}).get(
                        "status") not in ("ok", "skipped")]
        count_in_processes(todo, RESULTS_PATH, args.jobs)
        results = load_results()
    else:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    key = f"{arch}|{shape}|{'multi' if mp else 'single'}"
                    if (key in results and not args.force and
                            results[key].get("status") in ("ok", "skipped")):
                        continue
                    print(f"[dryrun] {key} ...", flush=True)
                    try:
                        results[key] = lower_cell(
                            arch, shape, mp,
                            act_constraints=not args.no_act_constraints)
                        st = results[key]["status"]
                        if st == "ok":
                            r = results[key]["roofline"]
                            print(f"  ok count={results[key]['count_s']}s "
                                  f"bottleneck={r['bottleneck']} "
                                  f"frac={r['roofline_fraction']:.3f}",
                                  flush=True)
                        else:
                            print(f"  {st}: {results[key].get('reason', '')}",
                                  flush=True)
                    except Exception as e:
                        results[key] = _error(e)
                        traceback.print_exc()
                    save_results(results)

    n_ok = sum(1 for v in results.values() if v.get("status") == "ok")
    n_err = sum(1 for v in results.values() if v.get("status") == "error")
    print(f"[dryrun] done: {n_ok} ok, {n_err} errors, {len(results)} total cells")
    return results


if __name__ == "__main__":
    main()
