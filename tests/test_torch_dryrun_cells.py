"""The port's dry run end to end on the CPU (``launch.dryrun``: one model
cell and the mining cell on the fake 256-device mesh, the results cache,
the production mesh) and its fixed-shape mining step
(``core.distributed.mining_step_for_dryrun``) against the JAX package's on
a 4-device CPU mesh, bit for bit. The reference runs in a subprocess
started when the module starts (its host platform needs four devices
before JAX starts); its mesh takes ``AxisType.Auto``, as
``tests/test_torch_distributed.py``'s does."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parity  # noqa: F401  (one torch thread per test process)
from repro_torch.core import graph as TG
from repro_torch.core.distributed import (
    make_mesh, mining_step_for_dryrun, mining_worker, random_frontier)
from repro_torch.launch import dryrun, mesh as mesh_lib

#: the mining step's small case: graph, frontier rows, k, dictionary size
N, M, ROWS, K, Q = 300, 1500, 256, 4, 64

REF_SCRIPT = textwrap.dedent(
    """
    import sys
    import jax
    import numpy as np
    from repro.core import graph as G
    from repro.core.distributed import mining_step_for_dryrun

    assert len(jax.devices()) == 4
    kw = ({"axis_types": (jax.sharding.AxisType.Auto,)}
          if hasattr(jax.sharding, "AxisType") else {})
    mesh = jax.make_mesh((4,), ("data",), **kw)
    d = np.load(sys.argv[1])
    g = G.to_device(G.Graph(n=int(d["n"]), labels=d["labels"],
                            edges=d["edges"]))
    step = mining_step_for_dryrun(mesh, axes=("data",), use_pallas=False)
    out = jax.jit(step)(g, d["members"], d["n_valid"], d["quick_dict"])
    np.savez(sys.argv[2], *[np.asarray(o) for o in out])
    """
)


#: the per-device count against the reference's compiler: a reduced dense
#: arch at widths that a 2 x 2 mesh divides, without remat (the port does
#: not recompute the forward) and unrolled (XLA counts a scanned layer
#: once), and one cell of each kind
COST_ARCH = "qwen2.5-14b"
COST_WIDTHS = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                   d_head=64, d_ff=512, vocab=512, remat=False, unroll=True)
COST_SHAPES = (("train", 128, 8, "train"), ("prefill", 256, 4, "prefill"),
               ("decode", 256, 4, "decode"))

REF_COST_SCRIPT = textwrap.dedent(
    r"""
    import dataclasses, json, re, sys
    import jax
    from repro.configs.base import ShapeConfig
    from repro.configs.registry import ARCHS
    from repro.launch import dryrun

    assert len(jax.devices()) == 4
    kw = ({"axis_types": (jax.sharding.AxisType.Auto,) * 2}
          if hasattr(jax.sharding, "AxisType") else {})
    mesh = jax.make_mesh((2, 2), ("data", "model"), **kw)
    arch, widths, shapes = json.loads(sys.argv[1])
    cfg = dataclasses.replace(ARCHS[arch], **widths)
    # an instruction's name and its result's dimensions
    DEF = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*\w+\[([\d,]*)\]")

    def dot_flops(hlo):
        # 2 x (output elements) x (contracted elements) of every dot
        lines = hlo.splitlines()
        shapes = {}
        for line in lines:
            m = DEF.match(line)
            if m:
                shapes[m.group(1)] = [int(x) for x in m.group(2).split(",")
                                      if x]
        total = 0.0
        for line in lines:
            m = DEF.match(line)
            if not m or " dot(" not in line:
                continue
            lhs = re.search(r" dot\(([^,)]*)", line).group(1)
            lhs = lhs.strip().split(" ")[-1].lstrip("%")
            dims = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", line)
            k = 1
            for i in dims.group(1).split(","):
                k *= shapes[lhs][int(i)] if i else 1
            out = 1
            for d in shapes[m.group(1)]:
                out *= d
            total += 2.0 * out * k
        return total

    res = {}
    for name, s, b, kind in shapes:
        low, _ = dryrun._lower_program(cfg, ShapeConfig(name, s, b, kind),
                                       mesh)
        compiled = low.compile()
        res[name] = dict(dryrun._raw_costs(compiled),
                         dot_flops=dot_flops(compiled.as_text()))
    print(json.dumps(res))
    """
)


def _inputs():
    """A seeded graph, its frontier in four slices and a dictionary of
    quick codes that the step's children meet (the distinct codes of one
    plain run's children, the rarest dropped)."""
    g = TG.random_labeled(N, M, n_labels=3, seed=4)
    members, n_valid = random_frontier(g, ROWS, K, seed=5)
    dg = TG.to_device(g, "cpu")
    m, nv = torch.from_numpy(members), torch.from_numpy(n_valid)
    zero = torch.zeros((Q, 3), dtype=torch.int64)
    children, count, _ = mining_worker(dg, m, nv, zero, use_pallas=False)
    from repro_torch.core import pattern

    slots = torch.arange(ROWS)
    child_nv = torch.where(slots < count, nv.max() + 1, 0).to(torch.int32)
    codes = pattern.quick_pattern_vertex(dg, children, child_nv).codes
    uniq, freq = np.unique(codes[child_nv > 0].numpy(), axis=0,
                           return_counts=True)
    quick = uniq[np.argsort(-freq, kind="stable")][:Q]
    quick = np.concatenate([quick, np.full((Q - len(quick), 3), -7)])
    return g, members, n_valid, quick.astype(np.int64)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, and the reference's outputs from a 4-device run started
    when the module starts."""
    g, members, n_valid, quick = _inputs()
    tmp = tmp_path_factory.mktemp("mining")
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, n=g.n, labels=g.labels, edges=g.edges,
             members=members.reshape(4, ROWS // 4, K),
             n_valid=n_valid.reshape(4, ROWS // 4), quick_dict=quick)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"),
                                           here]))
    proc = subprocess.Popen(
        [sys.executable, "-W", "ignore", "-c", REF_SCRIPT, str(src),
         str(dst)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield g, members, n_valid, quick, proc, dst
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _port_step(g, members, n_valid, quick, w, rows=ROWS):
    mesh = make_mesh((w,), ("data",), device="cpu")
    step = mining_step_for_dryrun(mesh, axes=("data",))
    out = step(TG.to_device(g, "cpu"),
               torch.from_numpy(members.reshape(w, rows // w, K)),
               torch.from_numpy(n_valid.reshape(w, rows // w)),
               torch.from_numpy(quick))
    return [o.numpy() for o in out]


def test_four_workers_are_four_one_worker_steps(case):
    """A worker's children capacity is its slice (the reference's
    fixed-shape rule), so four workers equal a one-worker mesh run on each
    slice in turn: children and counts slice by slice, and the psum'd
    pattern counts (every worker's row the same) the sum of the four."""
    g, members, n_valid, quick, _, _ = case
    c4, n4, t4 = _port_step(g, members, n_valid, quick, 4)
    per = ROWS // 4
    total = np.zeros(Q, dtype=np.int64)
    for w in range(4):
        sl = slice(w * per, (w + 1) * per)
        c1, n1, t1 = _port_step(g, members[sl], n_valid[sl], quick, 1,
                                rows=per)
        assert (c1[0] == c4[w]).all() and n1[0] == n4[w]
        total += t1[0]
    assert (t4 == t4[0]).all() and (t4[0] == total).all()
    assert total.sum() > 0


def test_production_mesh_on_a_fake_group():
    """16 x 16 ("data", "model") and 2 x 16 x 16 ("pod", "data", "model")
    over a fake group of 256 or 512 ranks, released after the block."""
    assert not dist.is_initialized()
    with mesh_lib.production_mesh() as m:
        assert tuple(m.shape) == (16, 16)
        assert m.mesh_dim_names == ("data", "model")
        assert mesh_lib.dp_axes(m) == ("data",)
        assert mesh_lib.tp_axis(m) == "model"
        assert dist.get_world_size() == 256
    assert not dist.is_initialized()
    with mesh_lib.production_mesh(multi_pod=True) as m:
        assert tuple(m.shape) == (2, 16, 16)
        assert mesh_lib.dp_axes(m) == ("pod", "data")
        assert dist.get_world_size() == 512
    assert not dist.is_initialized()


def test_decode_cell_end_to_end(tmp_path, monkeypatch):
    """smollm-135m decode_32k on the single mesh, through the CLI: status
    ok, FLOPs and bytes above 0, a bottleneck of the three; the fake group
    released; a second run reads the cache instead of counting again."""
    path = tmp_path / "dryrun.json"
    res = dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                       "--results", str(path)])
    assert not dist.is_initialized()
    cell = json.loads(path.read_text())["smollm-135m|decode_32k|single"]
    assert cell == res["smollm-135m|decode_32k|single"]
    assert cell["status"] == "ok" and cell["chips"] == 256
    assert cell["mesh"] == [16, 16] and cell["extrapolation"] is None
    r = cell["roofline"]
    assert r["flops"] > 0 and r["hbm_bytes"] > 0 and r["coll_bytes"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert set(cell["collectives"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert cell["kernel_charges"] == {"rmsnorm": 61}   # 2 a layer + ln_f
    assert cell["memory_analysis"]["argument_bytes"] > 0

    def fail(*a, **k):
        raise AssertionError("counted again")

    monkeypatch.setattr(dryrun, "lower_cell", fail)
    dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                 "--results", str(path)])


def test_skipped_and_failed_cells_are_recorded(tmp_path, monkeypatch):
    """A cell the registry does not run is "skipped" with its reason; a
    cell that raises is "error" with the exception, and the run goes on."""
    path = tmp_path / "dryrun.json"
    res = dryrun.main(["--arch", "qwen2.5-14b", "--shape", "long_500k",
                       "--results", str(path)])
    cell = res["qwen2.5-14b|long_500k|single"]
    assert cell["status"] == "skipped" and cell["reason"]

    def boom(*a, **k):
        raise NotImplementedError("Operator aten.foo.default does not have "
                                  "a sharding strategy registered.")

    monkeypatch.setattr(dryrun, "lower_cell", boom)
    res = dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k",
                       "--results", str(path)])
    cell = res["smollm-135m|train_4k|single"]
    assert cell["status"] == "error" and "aten.foo.default" in cell["error"]
    assert not dist.is_initialized()


def test_mining_cell_counts_one_worker():
    """The mining cell at the reference's shape: one worker's slice of 2^20
    rows on each mesh, the canonical_check kernel charged (not run), the
    psum's 512 int32 counts as the one all-reduce."""
    single = dryrun.lower_mining(False)
    multi = dryrun.lower_mining(True)
    assert not dist.is_initialized()
    for cell, chips in ((single, 256), (multi, 512)):
        assert cell["status"] == "ok" and cell["chips"] == chips
        assert cell["kernel_charges"] == {"canonical_check": 1}
        assert cell["collectives"]["all-reduce"] == 512 * 4
        assert cell["roofline"]["hbm_bytes"] > 0
    # half the rows a worker on twice the workers
    assert single["roofline"]["flops"] == 2 * multi["roofline"]["flops"]


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "xlstm-1.3b"])
def test_local_work_counts_on_the_mesh(arch):
    """The work that runs through ``launch.sharded``'s local forms — the
    MoE's routing, experts and combine, the sLSTM's time loop — counts
    on the fake mesh in a reduced train step: FLOPs and bytes above 0, and
    the gradients of the weights it shares across rows summed by a
    collective."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import ARCHS

    shape = ShapeConfig("t", 32, 32, "train")
    with mesh_lib.production_mesh() as m:
        c, _ = dryrun.count_program(ARCHS[arch].reduced(), shape, m)
    assert not dist.is_initialized()
    assert c.flops > 0 and c.hbm_bytes > 0 and c.peak_bytes > 0
    assert c.collectives["all-reduce"] + c.collectives["reduce-scatter"] > 0


def count_against_reference() -> dict:
    """Each ``COST_SHAPES`` cell counted by the port on a fake 2 x 2
    ("data", "model") mesh and compiled by the reference on four CPU
    devices: {cell: {"port": {"flops", "collectives"}, "ref": the
    reference's ``_raw_costs`` and ``dot_flops``}}."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import ARCHS

    here = os.path.dirname(os.path.abspath(__file__))
    flags = "--xla_force_host_platform_device_count=4"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags,
               REPRO_DRYRUN_XLA_FLAGS=flags,
               PYTHONPATH=os.path.join(here, "..", "src"))
    proc = subprocess.Popen(
        [sys.executable, "-W", "ignore", "-c", REF_COST_SCRIPT,
         json.dumps([COST_ARCH, COST_WIDTHS, COST_SHAPES])], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cfg = dataclasses.replace(ARCHS[COST_ARCH], **COST_WIDTHS)
        got = {}
        for name, s, b, kind in COST_SHAPES:
            mesh_lib.init_fake_world(4)
            try:
                m = init_device_mesh("cpu", (2, 2),
                                     mesh_dim_names=("data", "model"))
                c, _ = dryrun.count_program(cfg, ShapeConfig(name, s, b, kind),
                                            m)
            finally:
                mesh_lib.release_fake_world()
            got[name] = {"flops": c.flops, "collectives": dict(c.collectives)}
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    ref = json.loads(out.strip().splitlines()[-1])
    return {name: {"port": got[name], "ref": ref[name]} for name in got}


def test_per_device_count_against_the_reference():
    """The port's count on a 2 x 2 mesh against the reference's compiled
    program on four CPU devices, cell by cell (train, prefill, decode):
    each device's FLOPs within 10 % of the FLOPs of the reference's dot
    operations (XLA's CPU count adds every element-wise operation and
    conversion, which the port's count, as FlopCounterMode's, leaves out;
    the port charges the flash kernel's causal half where XLA multiplies
    all S x S scores), and the train and prefill steps' collective bytes
    within the mesh's size (4x) of the reference's either way: a count of
    the whole mesh's work, or a collective of the whole tensor, would fall
    outside. DTensor and XLA choose different collectives (ROADMAP.md
    queue C, "Differences"; ``python tests/test_torch_dryrun_cells.py``
    prints both by kind)."""
    for name, c in count_against_reference().items():
        port, ref = c["port"], c["ref"]
        assert abs(port["flops"] / ref["dot_flops"] - 1) <= 0.10, (name, c)
        if name != "decode":
            coll = sum(port["collectives"].values())
            assert 0.25 <= coll / ref["coll_bytes"] <= 4, (name, c)


def test_mining_step_matches_the_reference(case):
    """Children, counts and the psum'd pattern counts of four workers, bit
    for bit against the reference's shard_map program on four CPU
    devices (last in the file: the reference's subprocess, started when
    the module starts, runs while the tests above do)."""
    g, members, n_valid, quick, proc, dst = case
    got = _port_step(g, members, n_valid, quick, 4)
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    ref = np.load(dst)
    want = [ref[f"arr_{i}"] for i in range(3)]
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


if __name__ == "__main__":
    print(json.dumps(count_against_reference(), indent=1))
