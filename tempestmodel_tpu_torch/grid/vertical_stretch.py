"""Vertical stretch maps for non-uniform level placement.

Port of the reference ``src/atm/VerticalStretch.h:26-145``
(selected by ``--vstretch``): callables reta -> (reta_stretch, d/dreta)
fed to the vertical-coordinate construction (``ops/column_ops.py``).
"""

from __future__ import annotations


def stretch_uniform(reta):
    return reta, 1.0


def stretch_cubic(reta):
    """Cubic stretch with s1=0.1, s2=2.0 (reference values)."""
    s1, s2 = 0.1, 2.0
    val = (s1 * reta
           + (3.0 - 2.0 * s1 - s2) * reta * reta
           + (-2.0 + s1 + s2) * reta ** 3)
    deriv = (s1
             + 2.0 * (3.0 - 2.0 * s1 - s2) * reta
             + 3.0 * (-2.0 + s1 + s2) * reta * reta)
    return val, deriv


def stretch_piecewise_linear(reta):
    if reta < 2.0 / 3.0:
        return 0.5 * reta, 0.5
    return 2.0 * (reta - 2.0 / 3.0) + 1.0 / 3.0, 2.0


STRETCH_FUNCTIONS = {
    "uniform": None,                      # no map is applied at all
    "cubic": stretch_cubic,
    "pwlinear": stretch_piecewise_linear,
}


def get_stretch(name: str):
    try:
        return STRETCH_FUNCTIONS[name]
    except KeyError:
        raise ValueError(f"unknown vertical stretch {name!r}; "
                         f"options: {sorted(STRETCH_FUNCTIONS)}")
