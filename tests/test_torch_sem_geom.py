"""Port parity: SEM operators and box geometry are the reference's, exactly.

``repro_torch.core.sem`` and ``repro_torch.core.geom`` are numpy copies of
the reference modules (the port may not import ``repro``), so every array
must be bitwise equal.
"""
import numpy as np
import pytest

from repro.core import geom as jgeom
from repro.core import sem as jsem
from repro_torch.core import geom as tgeom
from repro_torch.core import sem as tsem


@pytest.mark.parametrize("n", [2, 3, 5, 8, 10, 16])
def test_sem_operators_equal(n):
    jz, jw = jsem.gll_points_weights(n)
    tz, tw = tsem.gll_points_weights(n)
    np.testing.assert_array_equal(tz, jz)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tsem.derivative_matrix(n),
                                  jsem.derivative_matrix(n))
    jops, tops = jsem.SEMOperators(n), tsem.SEMOperators(n)
    for name in ("z", "w", "D", "Dt", "w3"):
        np.testing.assert_array_equal(getattr(tops, name),
                                      getattr(jops, name), err_msg=name)


@pytest.mark.parametrize("n,grid,lengths", [
    (2, (1, 1, 1), (1.0, 1.0, 1.0)),
    (4, (2, 3, 2), (1.0, 2.0, 0.5)),
    (10, (2, 2, 4), (1.0, 1.0, 1.0)),
    (5, (3, 1, 2), (3.0, 1.0, 1.0)),
])
def test_box_mesh_fields_equal(n, grid, lengths):
    jm = jgeom.BoxMesh(n, grid, lengths)
    tm = tgeom.BoxMesh(n, grid, lengths)
    for name in ("geometric_factors", "dirichlet_mask", "multiplicity",
                 "mass", "coords"):
        np.testing.assert_array_equal(getattr(tm, name)(),
                                      getattr(jm, name)(), err_msg=name)
    assert (tm.nelt, tm.ndof, tm.nunique) == (jm.nelt, jm.ndof, jm.nunique)
    (jmk, jck) = jgeom.box_axis_factors(grid, n)
    (tmk, tck) = tgeom.box_axis_factors(grid, n)
    for a, b in zip(tmk + tck, jmk + jck):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tgeom.box_outer(*tmk[::-1]).reshape(-1, n, n, n),
        jm.dirichlet_mask())


@pytest.mark.parametrize("n", [2, 5, 10])
def test_random_spd_metric_equal(n):
    a = jgeom.random_spd_metric(np.random.default_rng(7), 3, n)
    b = tgeom.random_spd_metric(np.random.default_rng(7), 3, n)
    np.testing.assert_array_equal(b, a)
