"""The port's ``fused_chunk_step`` vs the JAX package's, with patterns
and with aggregates, unfused and fused (moved from
``test_torch_explore.py``, whose fixture and helpers this file imports).
Tolerance 0."""
import numpy as np
import pytest
import torch

from repro_torch.core import explore as texplore
from test_torch_explore import APPS, KNOB_IDS, KNOBS, _eq, setting  # noqa: F401


@pytest.mark.parametrize("app_name", ["motifs", "cliques"])
@pytest.mark.parametrize("knobs", KNOBS, ids=KNOB_IDS)
def test_fused_chunk_step_with_patterns(setting, app_name, knobs):
    _, tdg, frontiers, jax_chunk = setting
    for size in (2, 3):
        want = jax_chunk(app_name, size, 2048, with_patterns=True)
        tm, tn = (torch.from_numpy(np.array(a)) for a in frontiers[size])
        got = texplore.fused_chunk_step(
            tdg, tm, tn, 2048, mode="vertex", app=APPS[app_name][1],
            with_patterns=True, **knobs,
        )
        _eq(got, want, ("children", "count", "codes", "local_verts",
                        "n_generated", "n_canonical"))


@pytest.mark.parametrize("knobs", KNOBS, ids=KNOB_IDS)
@pytest.mark.parametrize("agg_qcap", [4, 4096])
def test_fused_chunk_step_with_aggregates(setting, knobs, agg_qcap):
    """Per-chunk level-1 partials, including a partial whose distinct count
    overflows ``agg_qcap`` (unclamped ``n_uniq``)."""
    _, tdg, frontiers, jax_chunk = setting
    want = jax_chunk("motifs", 2, 1024, with_aggregates=True,
                     agg_qcap=agg_qcap)
    tm, tn = (torch.from_numpy(np.array(a)) for a in frontiers[2])
    got = texplore.fused_chunk_step(
        tdg, tm, tn, 1024, mode="vertex", app=APPS["motifs"][1],
        with_aggregates=True, agg_qcap=agg_qcap, aggregate_kernel=True,
        **knobs,
    )
    _eq(got, want, ("children", "count", "uniq", "ucounts", "n_uniq",
                    "n_generated", "n_canonical"))
    assert got[3].dtype == torch.int32
    if agg_qcap == 4:
        assert int(got[4]) > 4

