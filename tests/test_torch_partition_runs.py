"""The port's mining runs over the partitioned graph layout
(``RunConfig(graph_partition=4)``) vs the JAX package's partitioned run:
patterns, every ``StepStats`` counter, chunk signatures, embeddings and
aggregates, tolerance 0. The small pipeline sizes of
``test_torch_pipeline.py`` make every step span several chunks, capacity
retries and overflowing partials. The unit parity of the layout is in
``test_torch_partition.py``."""
import pytest

from repro.core import EngineConfig
from repro.core.apps import CliquesApp as JCliques, MotifsApp as JMotifs
from repro_torch.core import RunConfig, run
from repro_torch.core.apps import CliquesApp, MotifsApp
from torch_parity import KERNELS_ON, assert_same_run, graph_pair, jax_run

PIPELINE = dict(chunk_size=32, initial_capacity=16, agg_qcap=8)

PORT_KNOBS = [
    dict(),
    KERNELS_ON,
    dict(KERNELS_ON, fused_expand=True),
]


@pytest.mark.parametrize("app,knobs", [
    ("motifs", dict(device_aggregate=False)),
    ("motifs", dict(device_aggregate=True)),
    ("cliques", dict()),
], ids=["motifs_host_level1", "motifs_device_level1", "cliques"])
def test_partitioned_runs_match_reference(app, knobs):
    """One JAX partitioned run; the port with the kernel knobs off, on, and
    with ``fused_expand`` (which a tile view does not take, in both
    packages). Embeddings are collected, so they are compared too."""
    jg, tg = graph_pair(lambda G: G.random_labeled(30, 80, n_labels=2,
                                                   seed=21))
    if app == "motifs":
        japp = JMotifs(max_size=3, collect_embeddings=True)
        tapp = MotifsApp(max_size=3, collect_embeddings=True)
    else:
        japp, tapp = JCliques(max_size=4), CliquesApp(max_size=4)
    cfg = dict(graph_partition=4, cost_model="off", **knobs, **PIPELINE)
    jres = jax_run(jg, japp, EngineConfig(**cfg))
    for extra in PORT_KNOBS:
        tres = run(tg, tapp, RunConfig(**cfg, **extra), device="cpu")
        assert_same_run(jres, tres)
    # the partitioned run agrees with the whole-graph run of the port
    whole = run(tg, tapp, RunConfig(cost_model="off", **knobs, **PIPELINE),
                device="cpu")
    assert whole.patterns == tres.patterns
    assert ({s: len(e) for s, e in whole.embeddings.items()}
            == {s: len(e) for s, e in tres.embeddings.items()})
