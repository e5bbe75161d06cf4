"""Shallow-water test-case helpers the nonhydrostatic cases share.

Counterpart of the JAX package's ``testcases/shallow_water.py``; only the
velocity conversion is ported so far."""

from __future__ import annotations

import numpy as np

from ..constants import PhysicalConstants
from ..grid import cubed_sphere as cst
from ..grid.geometry import CubedSphereGeometry


def sphere_velocity_to_covariant(ulon, ulat, geom: CubedSphereGeometry,
                                 constants: PhysicalConstants):
    """Convert (ulon, ulat) m/s fields to prognostic covariant components.

    Matches the reference conversion at ``GridPatchCSGLL.cpp:744-752``:
    multiply by the Earth radius, then CoVecTransABPFromRLL per panel.
    """
    alpha = np.asarray(geom.alpha, dtype=np.float64)
    Xn = np.tan(alpha)
    A = len(alpha)
    X = Xn[:, None] * np.ones((1, A))
    Y = np.ones((A, 1)) * Xn[None, :]
    a_r = constants.earth_radius
    U = np.zeros((6, A, A))
    V = np.zeros((6, A, A))
    ulon = np.asarray(ulon, dtype=np.float64)
    ulat = np.asarray(ulat, dtype=np.float64)
    for p in range(6):
        U[p], V[p] = cst.vec_cov_from_sphere(
            X, Y, p, a_r * ulon[p], a_r * ulat[p])
    return U, V
