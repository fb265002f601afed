"""The 128² and 256² spatial-sharding cases of tests/test_torch_spatial.py
(the JAX package's tests/test_sharding.py:240-310: halos strictly inside a
shard, in eval and train, and os 8), in a file of their own so that their
JAX compiles run beside the other cases'.  The same ranks, grids and
tolerances: against the port's one process to 1e-12, against the JAX
package's spatially sharded step to 1e-10 of each tensor's scale."""

import pytest

from test_torch_spatial import (
    GRIDS,
    HALO_CASES,
    check_jax,
    check_one_process,
    check_ranks_agree,
    spatial_runs,
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spatial_runs(tmp_path_factory.mktemp("spatial_halo"), HALO_CASES, units=False)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("case", HALO_CASES)
def test_halo_ranks_equal_one_process(runs, case, grid):
    """float64: the ranks against one process (tests/test_torch_spatial.py
    ``test_spatial_ranks_equal_one_process``)."""
    check_one_process(runs, case, grid)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("case", HALO_CASES)
def test_halo_ranks_agree_and_exchange_alike(runs, case, grid):
    """Every rank's state, losses and exchanges alike."""
    check_ranks_agree(runs, case, grid)


@pytest.mark.parametrize("case", HALO_CASES)
def test_halo_ranks_equal_jax_spatial_mesh(runs, case):
    """float64: the ranks against the JAX step sharded with
    ``spatial=True`` on a mesh of the same shape."""
    check_jax(runs, case)
