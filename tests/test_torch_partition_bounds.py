"""The port's shard bounds of the partitioned layout
(``graph.partition_bounds``) against the JAX package's, on graphs made
from one seed with numpy, by worker count and balance. Outputs are
integers: tolerance 0. The tables, the halo and the tile view are in
``test_torch_partition.py``.
"""
import numpy as np
import pytest

from repro.core import graph as JG
from repro_torch.core import graph as TG

from test_torch_partition import _graphs


@pytest.mark.parametrize("w", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("balance", ["vertex", "degree"])
def test_partition_bounds_match_reference(w, balance):
    for jg, tg in _graphs():
        want = np.asarray(JG.partition_bounds(jg, w, balance))
        got = TG.partition_bounds(tg, w, balance)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
