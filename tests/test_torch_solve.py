"""The port's tile-store substitutions (``repro_torch.core.solve``) called
directly, against the reference's (``repro.core.solve``, scipy on the
host).

The three entry points run on the card unless the caller names another
device, as every entry point of the port does; here they are given
``device="cpu"``.  Factor and right-hand sides come from a seed; the sweeps
are f64, held to 1e-10.
"""
import inspect

import numpy as np
import pytest
import torch

from repro.core import solve as JS
from repro.core.tiling import random_spd, to_tiles

from repro_torch.core import solve as S

ENTRIES = ["solve_lower_tiles", "solve_lower_t_tiles", "cho_solve_tiles"]


@pytest.mark.parametrize("name", ENTRIES)
@pytest.mark.parametrize("nrhs,rhs_block", [(0, None), (3, None), (5, 2)])
def test_tile_solves_on_the_cpu_match_the_reference(name, nrhs, rhs_block):
    nt, tb = 4, 16
    n = nt * tb
    tiles = to_tiles(np.tril(np.linalg.cholesky(random_spd(n, seed=3))), tb)
    rng = np.random.default_rng(nrhs)
    b = rng.standard_normal(n if nrhs == 0 else (n, nrhs))
    want = getattr(JS, name)(tiles, b, rhs_block=rhs_block)
    got = getattr(S, name)(torch.from_numpy(tiles), b, device="cpu",
                           rhs_block=rhs_block)
    assert got.device.type == "cpu" and got.dtype == torch.float64
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() < 1e-10
    assert inspect.signature(getattr(S, name)).parameters[
        "device"].default == "cuda"
