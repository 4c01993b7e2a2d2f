"""Whole runs of the port under ``cost_model="force_device"`` (the radix
level-1 bin and level 2 on the device) and every ``canonical_placement``,
against the JAX package under the same config: patterns, per-step
counters, embeddings and step aggregates identical (tolerance 0). Both
packages' process-wide canonical memos are cleared before each pair of
runs. The port runs on the CPU with its kernel knobs on (each wrapper
takes its plain version) and off (the plain routes)."""
import dataclasses

import numpy as np
import pytest

from repro.core import EngineConfig, pattern as jpattern
from repro.core.apps import CliquesApp as JCliques, MotifsApp as JMotifs
from repro_torch.core import RunConfig, aggregation, pattern as tpattern, run
from repro_torch.core.apps import CliquesApp, MotifsApp
from repro_torch.core.runtime import SerialBackend
from repro_torch.core import graph as TG
from torch_parity import KERNELS_ON, assert_same_run, graph_pair, jax_run

#: small chunks, capacities and ``agg_qcap``: every step spans several
#: chunks, capacity retries and overflowing partials (re-folded waves)
PIPELINE = dict(chunk_size=32, initial_capacity=16, agg_qcap=8)


def _graphs():
    return graph_pair(lambda G: G.random_labeled(30, 80, n_labels=2,
                                                   seed=21))


def _pair(jg, tg, japp, tapp, **knobs):
    """The JAX run, then the port's runs with kernel knobs on and off,
    each after clearing both memos."""
    jpattern.clear_memo()
    tpattern.clear_memo()
    jres = jax_run(jg, japp, EngineConfig(**knobs))
    for extra in (KERNELS_ON, {}):
        tpattern.clear_memo()
        tres = run(tg, tapp, RunConfig(**extra, **knobs), device="cpu")
        assert_same_run(jres, tres)
    return tres


@pytest.mark.parametrize("placement", ["device", "host", "host_async"])
def test_force_device_motifs_match_reference(placement):
    jg, tg = _graphs()
    tres = _pair(jg, tg, JMotifs(max_size=3), MotifsApp(max_size=3),
                 cost_model="force_device", canonical_placement=placement,
                 **PIPELINE)
    decided = tres.stats.cost_model
    assert decided["aggregate_bin"] == "radix"
    assert decided["canonical_placement"] == placement


def test_device_placement_over_host_level1_matches_reference():
    """``device_aggregate=False``: the host level 1 hands its cache misses
    to the refine (the ``canon_fn`` hook); ``host_async`` has no
    deferrable table there and runs the host placement."""
    jg, tg = _graphs()
    for placement in ("device", "host_async"):
        _pair(jg, tg, JMotifs(max_size=3), MotifsApp(max_size=3),
              cost_model="force_device", device_aggregate=False,
              canonical_placement=placement, **PIPELINE)


def test_force_device_cliques_match_reference():
    """Cliques aggregate no patterns: the forced table changes nothing
    but the knobs."""
    jg, tg = _graphs()
    _pair(jg, tg, JCliques(max_size=4), CliquesApp(max_size=4),
          cost_model="force_device", **PIPELINE)


def _prune_app(base):
    @dataclasses.dataclass
    class PruneApp(base):
        max_size: int = 3

        def pattern_filter(self, agg):
            return np.asarray(agg.counts) >= 4

    return PruneApp()


def test_host_async_downgrades_for_pruning_apps():
    """An app that prunes on patterns needs the table before expansion:
    ``host_async`` runs the synchronous host placement (the reference's
    ``async_level2_ok`` rule), with the host placement's result."""
    tapp = _prune_app(MotifsApp)
    assert not aggregation.async_level2_ok(tapp)
    assert aggregation.async_level2_ok(MotifsApp(max_size=3))
    _, tg = _graphs()
    backend = SerialBackend()
    backend.bind(TG.to_device(tg, "cpu"), tapp,
                 RunConfig(canonical_placement="host_async"))
    assert backend._canon_placement == "host"
    runs = [run(tg, tapp, RunConfig(canonical_placement=p, **PIPELINE),
                device="cpu") for p in ("host_async", "host")]
    assert runs[0].patterns == runs[1].patterns
    assert min(runs[0].patterns.values()) >= 4


def test_device_level2_seeds_the_memo():
    """The device placement warms the host memo with its results: a later
    host-placed run over the same patterns is all cache hits."""
    _, tg = _graphs()
    tpattern.clear_memo()
    assert tpattern.memo_sizes() == (0, 0)
    dev = run(tg, MotifsApp(max_size=3),
              RunConfig(canonical_placement="device", **KERNELS_ON),
              device="cpu")
    n_quick = sum(s.n_quick_patterns for s in dev.stats.steps)
    assert 0 < tpattern.memo_sizes()[0] <= n_quick
    host = run(tg, MotifsApp(max_size=3), RunConfig(), device="cpu")
    assert host.patterns == dev.patterns
    assert tpattern.memo_sizes()[0] <= n_quick


@pytest.mark.parametrize("knob", [dict(canonical_placement="gpu"),
                                  dict(aggregate_bin="bucket")])
def test_unknown_knob_values_raise(knob):
    with pytest.raises(ValueError, match="unknown"):
        run(TG.triangle_plus_tail(), MotifsApp(max_size=3), RunConfig(**knob),
            device="cpu")
