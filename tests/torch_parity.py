"""Shared helpers of the port's parity tests (``test_torch_*.py``): one
seeded graph for both packages, the JAX package's whole run, the
whole-run comparison and the array-tuple comparison (tolerance 0).

Importing it pins PyTorch to one intra-op thread for the test process: the
suite runs several worker processes at once, and PyTorch's default (one
thread per core in every worker) oversubscribes the CPU against the JAX
tests that run beside it."""
import contextlib
import dataclasses
import weakref
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import canonical as jcanonical
from repro.core import graph as JG
from repro.core import odag as jodag
from repro.core import run as jrun
from repro.core.runtime import programs as jprograms
from repro.core.runtime import serial as jserial
from repro.core.stats import StepStats as JStepStats
from repro_torch.core import graph as TG

#: every integer StepStats counter (the t_* fields are wall times)
COUNTERS = [f.name for f in dataclasses.fields(JStepStats)
            if not f.name.startswith("t_")]
#: the port on the CPU with every kernel knob on: each wrapper takes its
#: plain version
KERNELS_ON = dict(use_pallas=True, compact_kernel=True, aggregate_kernel=True)

torch.set_num_threads(1)

#: ``cost_model`` modes under which the JAX package's run times nothing of
#: its own (``auto`` calibrates on timings of the functions swapped below)
UNTIMED_COST_MODELS = ("off", "force_device", "force_host")


def _jdevice_chunk_impl(wave_dev, lo, cb, bucket, k):
    chunk = jax.lax.dynamic_slice_in_dim(wave_dev, lo, cb)
    n_valid = jnp.full((cb,), k, jnp.int32)
    if bucket > cb:
        chunk = jnp.concatenate([chunk, jnp.full((bucket - cb, k), -1,
                                                 jnp.int32)])
        n_valid = jnp.concatenate([n_valid,
                                   jnp.zeros((bucket - cb,), jnp.int32)])
    return chunk, n_valid


class HostPrefix:
    """One output buffer of a chunk program whose prefix slices are taken
    on the host, after one copy of the whole buffer (the reference reads
    only ``buf[:count]`` of it, and ``delete`` to retire it)."""

    def __init__(self, buf):
        self.buf = buf

    def __getitem__(self, index):
        return np.asarray(self.buf)[index]

    def delete(self):
        self.buf.delete()


def _host_prefix_rec(rec):
    def wrapped(self, out, used_cap):
        p = rec(self, out, used_cap)
        for key in ("children", "codes", "lv"):
            if p.get(key) is not None:
                p[key] = HostPrefix(p[key])
        return p
    return wrapped


#: The JAX package's runs call some operations outside any jitted program,
#: and each new shape or static index compiles such an operation on its own
#: (~0.06 s a compile on a CPU, hundreds a run). ``jax_run`` swaps three of
#: them for versions that compute the same integers
#: (``test_torch_edge.py::test_jax_run_swaps_match_eager`` holds each to
#: its eager form):
#: - ``programs.quick_patterns``, the wave quick codes, as one program;
#: - ``programs.device_chunk``, the chunk slice, as one program a chunk
#:   shape, its start an argument;
#: - the prefix slices ``buf[:count]`` of the chunk programs' outputs
#:   (children, quick codes, local vertices), taken on the host.
SWAPS = {
    "quick_patterns": jax.jit(jprograms.quick_patterns, static_argnums=1),
    "device_chunk": jax.jit(_jdevice_chunk_impl, static_argnums=(2, 3, 4)),
    "rec": _host_prefix_rec(jserial.SerialBackend._rec),
}


def _next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def _bucketed(jfn, *fixed):
    """``jfn(*fixed, *arrays)``, a jitted per-row function of its arrays'
    leading axis, called at a power-of-two row bucket: the rows are padded
    with -1 up to the bucket, and the output is cut back to them (numpy).
    It compiles once a bucket."""

    def call(*arrays):
        arrays = [np.asarray(a) for a in arrays]
        b = arrays[0].shape[0]
        pad = _next_pow2(b) - b
        if pad:
            arrays = [np.concatenate([a, np.full((pad,) + a.shape[1:], -1,
                                                 a.dtype)]) for a in arrays]
        return np.asarray(jfn(*fixed, *arrays))[:b]

    return call


_IS_EDGE = jax.jit(lambda g, u, v: g.is_edge(u, v))
_VERTEX_CHECK = jax.jit(jcanonical.vertex_check)
_EDGE_CHECK = jax.jit(jcanonical.edge_check)
#: app filter -> its jitted form, one a run's store filter
_FILTERS = weakref.WeakKeyDictionary()


class _HostGraph:
    """What ``repro.core.odag.extract`` reads of its graph: ``edge_uv`` as
    a numpy array and ``is_edge`` as a bucketed program."""

    def __init__(self, g):
        self.g = g
        self.edge_uv = np.asarray(g.edge_uv)
        self.is_edge = _bucketed(_IS_EDGE, g)


class _HostJnp:
    """The ``jnp`` names ``repro.core.odag.extract`` calls between the
    graph's functions, on numpy: array glue of the same integers."""

    asarray = staticmethod(np.asarray)
    full = staticmethod(np.full)
    maximum = staticmethod(np.maximum)
    int32 = np.int32


class _HostCanonical:
    """``repro.core.canonical``'s two checks as bucketed programs over the
    real graph."""

    @staticmethod
    def vertex_check(hg, members, n_valid, cand):
        return _bucketed(_VERTEX_CHECK, hg.g)(members, n_valid, cand)

    @staticmethod
    def edge_check(hg, members, n_valid, cand):
        return _bucketed(_EDGE_CHECK, hg.g)(members, n_valid, cand)


_EXTRACT = jodag.extract


def _host_extract(g, odag, app_filter=None, chunk=65536, mode="vertex",
                  use_pallas=False, interpret=None):
    """``repro.core.odag.extract`` itself, with its graph's functions, its
    two checks and the app filter each a bucketed program and its array
    glue on numpy (the Pallas route is refused: ``jax_run`` takes the jnp
    routes)."""
    if use_pallas:
        raise ValueError("the extraction swap takes the jnp routes only")
    phi = None
    if app_filter is not None:
        if app_filter not in _FILTERS:
            _FILTERS[app_filter] = jax.jit(app_filter)
        phi = _bucketed(_FILTERS[app_filter])
    return _EXTRACT(_HostGraph(g), odag, app_filter=phi, chunk=chunk,
                    mode=mode)


@contextlib.contextmanager
def host_extract():
    """Inside the block, the JAX package's ODAG extraction (``odag.extract``
    and, through it, ``extract_partition`` and the ODAG store) runs as
    :func:`_host_extract`: the same integers, compiled once a row bucket
    where the eager form compiles each of its operations at every new
    shape (~5 s an extraction on a CPU).
    ``test_torch_odag.py::test_host_extract_swap_matches_eager`` holds it to
    the eager form."""
    with mock.patch.object(jodag, "extract", _host_extract), \
            mock.patch.object(jodag, "jnp", _HostJnp), \
            mock.patch.object(jodag, "canonical", _HostCanonical):
        yield


@contextlib.contextmanager
def quick_compiles():
    """XLA at its lowest optimization level inside the block. The JAX
    package's runs at test sizes compile a hundred small programs each,
    and compiling them costs more than running them. The level changes how
    a program is compiled, never the integers it computes; were it to, the
    reference would disagree with the port, not hide a fault of it. A
    program compiled here stays in the process's cache, as any other
    does."""
    flag = "jax_disable_most_optimizations"
    old = jax.config.read(flag)
    jax.config.update(flag, True)
    try:
        yield
    finally:
        jax.config.update(flag, old)


def jax_run(g, app, config):
    """The JAX package's ``run(g, app, config)`` with the swaps above (same
    results), compiled under ``quick_compiles``. Refuses a cost model that
    would time the swapped functions."""
    if config.cost_model not in UNTIMED_COST_MODELS:
        raise ValueError(f"jax_run takes cost_model in {UNTIMED_COST_MODELS},"
                         f" not {config.cost_model!r}")
    with quick_compiles(), host_extract(), \
            mock.patch.object(jprograms, "quick_patterns",
                              SWAPS["quick_patterns"]), \
            mock.patch.object(jprograms, "device_chunk",
                              SWAPS["device_chunk"]), \
            mock.patch.object(jserial.SerialBackend, "_rec", SWAPS["rec"]):
        return jrun(g, app, config)


def graph_pair(make):
    """``make(module)`` for the JAX package's graph module, and the same
    edges as the port's host graph."""
    jg = make(JG)
    return jg, TG.Graph(n=jg.n, labels=jg.labels, edges=jg.edges)


def assert_same_run(jres, tres):
    """Patterns, per-step counters, chunk signatures, embeddings (order
    included) and step aggregates of two runs are identical."""
    assert tres.patterns == jres.patterns
    assert len(tres.stats.steps) == len(jres.stats.steps)
    for js, ts in zip(jres.stats.steps, tres.stats.steps):
        for f in COUNTERS:
            assert getattr(ts, f) == getattr(js, f), (js.step, f)
    assert tres.stats.chunk_signatures == jres.stats.chunk_signatures
    assert sorted(tres.embeddings) == sorted(jres.embeddings)
    for size, emb in jres.embeddings.items():
        np.testing.assert_array_equal(tres.embeddings[size], np.asarray(emb))
    assert len(tres.aggregates) == len(jres.aggregates)
    for ja, ta in zip(jres.aggregates, tres.aggregates):
        for a, b in zip(ta, ja):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def assert_same_arrays(port, ref):
    """Each tensor of ``port`` equals the array at the same place of
    ``ref`` (a JAX or numpy array), values and shape."""
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
