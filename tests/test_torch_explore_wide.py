"""The port's ``expand_and_compact`` vs the JAX package's at a children
capacity that holds every child (out_cap 4,096; the capacity that
overflows, 16, is in ``test_torch_explore.py``, whose fixture and helpers
this file imports)."""
import pytest
import torch

from repro.core import explore as jexplore
from repro_torch.core import explore as texplore
from test_torch_explore import KNOB_IDS, KNOBS, _eq, _pair, setting  # noqa: F401


@pytest.mark.parametrize("size", [1, 2, 3])
@pytest.mark.parametrize("knobs", KNOBS, ids=KNOB_IDS)
@pytest.mark.parametrize("out_cap", [4096])
def test_expand_and_compact_matches_reference(setting, size, knobs, out_cap):
    jdg, tdg, frontiers, _ = setting
    (jm, tm), (jn, tn) = map(_pair, frontiers[size])
    want = jexplore.expand_and_compact(jdg, jm, jn, "vertex", out_cap)
    got = texplore.expand_and_compact(tdg, tm, tn, "vertex", out_cap, **knobs)
    _eq(got, want, ("children", "count", "n_generated", "n_canonical"))
    assert got[1].dtype == torch.int32 and got[1].shape == ()
