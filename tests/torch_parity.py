"""Shared helpers of the port's parity tests (``test_torch_*.py``): one
seeded graph for both packages, the whole-run comparison and the
array-tuple comparison (tolerance 0).

Importing it pins PyTorch to one intra-op thread for the test process: the
suite runs several worker processes at once, and PyTorch's default (one
thread per core in every worker) oversubscribes the CPU against the JAX
tests that run beside it."""
import dataclasses

import numpy as np
import torch

from repro.core import graph as JG
from repro.core.stats import StepStats as JStepStats
from repro_torch.core import graph as TG

#: every integer StepStats counter (the t_* fields are wall times)
COUNTERS = [f.name for f in dataclasses.fields(JStepStats)
            if not f.name.startswith("t_")]
#: the port on the CPU with every kernel knob on: each wrapper takes its
#: plain version
KERNELS_ON = dict(use_pallas=True, compact_kernel=True, aggregate_kernel=True)

torch.set_num_threads(1)


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
