"""Explicit Runge-Kutta sub-schemes used inside Strang/ERK stepping.

Counterpart of the JAX package's ``timestep/explicit.py``, the equivalent of
the explicit branches of ``TimestepSchemeStrang::Step`` (reference
``src/atm/TimestepSchemeStrang.cpp:460-690``) and the stage-combination
constants (``:55-140``).  The reference juggles 5 persistent state
instances with CopyData/LinearCombineData; here stages are dicts of tensors
(or single tensors) combined with the same coefficients in the same order.
The z-first engine keeps its own fused stage combinations
(``fast/engine``); the shallow-water and advection steps take these.

The caller provides ``stage(base, u_eval, dt_s) -> new_state``: one
forward-Euler-like substep evaluated at ``u_eval`` and added onto ``base``
(including DSS and any model-specific post-processing; the reference's
StepExplicit + PostProcessSubstage pair).
"""

from __future__ import annotations

from typing import Callable

from ..config import ExplicitSubScheme


def _comb(coeffs_states):
    """Linear combination of (coeff, state) pairs; a state is a dict of
    tensors or one tensor."""
    coeffs, states = zip(*coeffs_states)

    def lin(*xs):
        return sum(c * x for c, x in zip(coeffs, xs))

    if isinstance(states[0], dict):
        return {k: lin(*(s[k] for s in states)) for k in states[0]}
    return lin(*states)


def erk_substep(scheme: ExplicitSubScheme, u0, dt, stage: Callable,
                shadow0=None):
    """One full explicit RK step u0 -> u_new.

    ``stage(base, u_eval, dt_s)`` performs base + dt_s * T(u_eval) with DSS.

    ``shadow0``: optional "halo shadow" of u0 for no-flux boundary
    emulation (reference per-instance halos, which flow through
    CopyData/LinearCombineData like data and sync to the edge value at
    every DSS).  When given, ``stage`` is called with a 4th argument —
    the shadow of the stage's base (stage OUTPUTS are their own shadow,
    since DSS syncs halo = edge; only u0's interior has drifted from its
    halo).
    """
    if shadow0 is None:
        def S(base, ueval, dts, sh):
            return stage(base, ueval, dts)
    else:
        S = stage

    def comb_shadow(cs):
        """The shadow of a combination: u0's term takes u0's shadow."""
        if shadow0 is None:
            return None
        return _comb([(c, shadow0 if x is u0 else x) for c, x in cs])

    if scheme == ExplicitSubScheme.FORWARD_EULER:
        return S(u0, u0, dt, shadow0)

    if scheme == ExplicitSubScheme.RK4:
        u1 = S(u0, u0, 0.5 * dt, shadow0)
        u2 = S(u0, u1, 0.5 * dt, shadow0)
        u3 = S(u0, u2, dt, shadow0)
        cs = [(-1.0 / 3.0, u0), (1.0 / 3.0, u1),
              (2.0 / 3.0, u2), (1.0 / 3.0, u3)]
        return S(_comb(cs), u3, dt / 6.0, comb_shadow(cs))

    if scheme == ExplicitSubScheme.SSPRK3:
        u1 = S(u0, u0, dt, shadow0)
        cs = [(0.75, u0), (0.25, u1)]
        u2 = S(_comb(cs), u1, 0.25 * dt, comb_shadow(cs))
        cs = [(1.0 / 3.0, u0), (2.0 / 3.0, u2)]
        return S(_comb(cs), u2, (2.0 / 3.0) * dt, comb_shadow(cs))

    if scheme == ExplicitSubScheme.KGU35:
        u1 = S(u0, u0, dt / 5.0, shadow0)
        u2 = S(u0, u1, dt / 5.0, shadow0)
        u3 = S(u0, u2, dt / 3.0, shadow0)
        u2b = S(u0, u3, 2.0 * dt / 3.0, shadow0)
        cs = [(-0.25, u0), (1.25, u1)]
        return S(_comb(cs), u2b, 0.75 * dt, comb_shadow(cs))

    if scheme == ExplicitSubScheme.SSPRK53:
        c1 = 0.377268915331368
        c3 = 0.242995220537396
        c4 = 0.238458932846290
        c5 = 0.287632146308408
        u1 = S(u0, u0, c1 * dt, shadow0)
        u2 = S(u1, u1, c1 * dt, u1)
        cs = [(0.355909775063327, u0), (0.644090224936674, u2)]
        u3 = S(_comb(cs), u2, c3 * dt, comb_shadow(cs))
        cs = [(0.367933791638137, u0), (0.632066208361863, u3)]
        u0b = S(_comb(cs), u3, c4 * dt, comb_shadow(cs))
        cs = [(0.762406163401431, u0b), (0.237593836598569, u2)]
        return S(_comb(cs), u0b, c5 * dt, comb_shadow(cs))

    raise ValueError(f"unknown explicit scheme {scheme}")
