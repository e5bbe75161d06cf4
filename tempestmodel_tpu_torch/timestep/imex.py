"""IMEX additive Runge-Kutta (ARK) tableaux in U-form.

Counterpart of the JAX package's ``timestep/imex.py`` (``_tableaux``; the
reference's ``src/atm/TimestepSchemeARS222/ARS232/ARK232/ARS343/ARS443/
SSP3332.cpp``).  Each stage of a scheme with ``(Aexp, Aimp)`` is

    uf_i = DSS[ u0 + dt (sum_{j<=i} Aexp[i][j] F_j + sum_{j<i} Aimp[i][j] G_j) ]
    u_{i+1} = VerticalImplicit(uf_i, Aimp[i][i] dt)
    G_i = (u_{i+1} - uf_i) / (Aimp[i][i] dt)

with F_j the explicit (horizontal) tendency of u_j, followed by the
hyperdiffusion / Rayleigh tail over the full dt; the z-first engine's
``make_fast_imex_step`` runs it.  The reference-layout steppers
(``make_imex_step``, the GARK2 step) are not ported yet.
"""

from __future__ import annotations

import math

from ..config import TimestepSchemeType


def _tableaux(kind: TimestepSchemeType):
    """(Aexp, Aimp) stage coefficient tables (U-form, reference values)."""
    s2 = math.sqrt(2.0)
    if kind == TimestepSchemeType.ARS222:
        g = 1.0 - 0.5 * s2
        d = 1.0 - 1.0 / (2.0 * g)
        return ([[g, 0.0], [d, 1.0 - d]],
                [[g, 0.0], [1.0 - g, g]])
    if kind == TimestepSchemeType.ARS232:
        g = 1.0 - 1.0 / s2
        d = -2.0 * s2 / 3.0
        return ([[g, 0, 0], [d, 1.0 - d, 0], [0.0, 1.0 - g, g]],
                [[g, 0, 0], [1.0 - g, g, 0], [1.0 - g, g, 0.0]])
    if kind == TimestepSchemeType.ARK232:
        g = 1.0 - 1.0 / s2
        d = 1.0 / (2.0 * s2)
        al = (3.0 + 2.0 * s2) / 6.0
        return ([[2 * g, 0, 0], [1.0 - al, al, 0], [d, d, g]],
                [[g, g, 0], [d, d, g], [d, d, g]])
    if kind in (TimestepSchemeType.ARS343, TimestepSchemeType.ARS343B):
        # ARS343b carries the identical Ascher et al. 1997 tableau; the
        # reference variant differs only in how it combines the stages
        g = 0.4358665215084590
        b1 = -1.5 * g * g + 4.0 * g - 0.25
        b2 = 1.5 * g * g - 5.0 * g + 1.25
        a42 = 0.5529291480359398
        a43 = a42
        a31 = ((1.0 - 4.5 * g + 1.5 * g * g) * a42
               + (2.75 - 10.5 * g + 3.75 * g * g) * a43
               - 3.5 + 13.0 * g - 4.5 * g * g)
        a32 = ((-1.0 + 4.5 * g - 1.5 * g * g) * a42
               + (-2.75 + 10.5 * g - 3.75 * g * g) * a43
               + 4.0 - 12.5 * g + 4.5 * g * g)
        a41 = 1.0 - a42 - a43
        return ([[g, 0, 0, 0], [a31, a32, 0, 0], [a41, a42, a43, 0],
                 [0.0, b1, b2, g]],
                [[g, 0, 0, 0], [0.5 * (1.0 - g), g, 0, 0],
                 [b1, b2, g, 0], [b1, b2, g, 0.0]])
    if kind == TimestepSchemeType.ARS443:
        return ([[1 / 2, 0, 0, 0], [11 / 18, 1 / 18, 0, 0],
                 [5 / 6, -5 / 6, 1 / 2, 0], [1 / 4, 7 / 4, 3 / 4, -7 / 4]],
                [[1 / 2, 0, 0, 0], [1 / 6, 1 / 2, 0, 0],
                 [-1 / 2, 1 / 2, 1 / 2, 0], [3 / 2, -3 / 2, 1 / 2, 1 / 2]])
    if kind == TimestepSchemeType.SSP3332:
        g = 1.0 - 1.0 / s2
        return ([[0.0, 0, 0, 0], [1.0, 0, 0, 0], [1 / 4, 1 / 4, 0, 0],
                 [1 / 6, 1 / 6, 2 / 3, 0.0]],
                [[g, 0, 0, 0], [1.0 - 2.0 * g, g, 0, 0],
                 [0.5 - g, 0.0, g, 0], [1 / 6, 1 / 6, 2 / 3, 0.0]])
    raise ValueError(f"not an IMEX scheme: {kind}")
