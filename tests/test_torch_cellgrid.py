"""Port parity: the cell grid and its neighbour layout vs ops/cellgrid.py, on
CPU.

Tolerances:
- grids: exact equality, array for array (the same host numpy code on the
  same float64 points);
- the device maps (cell starts, slot mask, user-order pad map) and the
  neighbour slices: exact equality (integer maps, gathers and zero fill).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.ops import cellgrid as jcg
from nfft4gp_torch.ops import cellgrid as tcg


def _points(d, n=400, seed=3):
    return np.random.default_rng(seed + d).uniform(size=(n, d))


def _grids(X, **kw):
    return tcg.build_cell_grid(X, **kw), jcg.build_cell_grid(X, **kw)


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("kw", [dict(target_occupancy=8.0), dict(target_occupancy=5.0, min_h=0.2),
                                dict(h=0.3)],
                         ids=["uniform", "min_h", "pitch"])
def test_build_cell_grid(d, kw):
    t, j = _grids(_points(d), **kw)
    assert t is not None and j is not None and j.edges is None
    for name in tcg.CellGrid._fields:
        tv, jv = getattr(t, name), getattr(j, name)
        if isinstance(jv, np.ndarray):
            assert tv.dtype == jv.dtype, name
            np.testing.assert_array_equal(tv, jv)
        else:
            assert tv == jv, name
    assert (t.ncells, t.noffs) == (j.ncells, j.noffs)


def test_degenerate_grid_returns_none():
    """Duplicate-heavy (integer) data trips the capacity guard in both."""
    X = np.random.default_rng(0).integers(0, 3, size=(2000, 2)).astype(np.float64)
    assert _grids(X, target_occupancy=10.0) == (None, None)
    assert _grids(np.zeros((0, 2))) == (None, None)
    assert _grids(np.zeros((5, 4))) == (None, None)                 # d > 3


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("occupancy", [3.0, 6.0])
def test_layout_ops(d, occupancy):
    """The device maps and the neighbour slices of a user-order vector padded
    into cells, against the JAX to_device, pad_cells_user and
    stencil_neighbors."""
    X = _points(d)
    t, j = _grids(X, target_occupancy=occupancy)
    tdev, jdev = tcg.to_device(t), jcg.to_device(j)
    assert (tdev.ncells, tdev.noffs, tdev.c) == (jdev.ncells, jdev.noffs, jdev.c)
    for name in ("starts", "padmask", "pad_src_u"):
        np.testing.assert_array_equal(getattr(tdev, name).numpy(), np.asarray(getattr(jdev, name)))
    v = np.random.default_rng(9 + d).normal(size=X.shape[0])
    tp = torch.where(tdev.padmask, torch.tensor(v)[tdev.pad_src_u], 0.0)
    jp = jcg.pad_cells_user(jdev, jnp.asarray(v))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tcg.stencil_neighbors(tdev, tp).numpy(),
                                  np.asarray(jcg.stencil_neighbors(jdev, jp)))
    assert tcg._offsets(d) == jcg._offsets(d)
