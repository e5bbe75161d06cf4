"""Vertical (column) finite-element operator matrices.

Analog of the reference's matrix-form 1-D column operators
(``src/atm/LinearColumnOperatorFEM.{h,cpp}``, ``src/atm/GridGLL.cpp:279-360``
for which variants are instantiated, ``src/atm/GridGLL.cpp:470-550`` for the
vertical coordinate).  Everything here is host-side float64 numpy run once at
model build; the resulting small dense matrices are contracted against the
level axis of the fields (one batched matmul per operator application,
vs the reference's per-column sparse row loops).

Conventions: a column field on "nodes" (model levels) has nz entries; on
"redges" (interfaces) nz+1.  Operators are dense matrices M with
``out = M @ f`` (out_index, in_index).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import quadrature as quad


def flux_correction_derivatives(itype: int, order: int,
                                nodes: np.ndarray) -> np.ndarray:
    """Derivatives of the DG flux-correction function on [0, 1] nodes.

    Reference: ``FluxCorrectionFunction::GetDerivatives``
    (``src/atm/FluxCorrectionFunction.cpp:26-110``): the degree-``order``
    polynomial with P(-1)=1, a zero of multiplicity ``itype`` at +1, and
    orthogonal to polynomials of degree <= order-itype-2 on [-1,1]; returns
    P'(2x-1)*2 evaluated at the given [0,1] nodes.
    """
    n = order
    # Solve for polynomial coefficients c (highest power first) via the
    # Vandermonde system of the constraints.
    van = np.zeros((n + 1, n + 1))
    rhs = np.zeros(n + 1)
    # Left value = 1 at x=-1: sum c_i (-1)^(n-i) over rows i (c stored from
    # x^n down to x^0 as in the reference indexing).
    sign = 1.0
    for i in range(n, -1, -1):
        van[i, 0] = sign
        sign = -sign
    rhs[0] = 1.0
    # Zero of multiplicity itype at x=+1 (derivatives of increasing order)
    coeff = np.ones(n + 1)
    for m in range(itype):
        van[:, m + 1] = coeff
        newc = np.zeros(n + 1)
        for i in range(0, n - m):
            newc[i] = (n - m - i) * coeff[i]
        coeff = newc
    # Orthogonality to monomials: integral over [-1,1] of P * x^m = 0
    for m in range(n - itype):
        for i in range(n + 1):
            s = (n - i) + m
            if s % 2 == 0:
                van[i, itype + 1 + m] = 2.0 / (s + 1.0)
    c = np.linalg.solve(van.T, rhs)
    # Derivative polynomial on [-1,1], with sign flip (x -> -x as reference)
    sign = 1.0
    for i in range(n, -1, -1):
        c[i] *= sign
        sign = -sign
    b = np.zeros(n + 1)
    for i in range(n):
        b[n - i] = (i + 1) * c[n - i - 1]
    b[0] = 0.0
    # Evaluate derivative at 2*x-1 for x in nodes, times 2 (chain rule)
    nodes = np.atleast_1d(np.asarray(nodes, dtype=np.float64))
    out = np.zeros(len(nodes))
    for j, xn in enumerate(nodes):
        dx = 1.0
        acc = 0.0
        for i in range(n):
            acc += b[n - i] * dx
            dx *= (2.0 * xn - 1.0)
        out[j] = 2.0 * acc
    return out


def vertical_coordinate(nz: int, vertical_order: int, stretch=None):
    """(reta_levels, reta_interfaces, norm_area_lev, norm_area_int).

    Levels at per-element Gauss points, interfaces at per-element GLL points
    (reference ``GridGLL::InitializeVerticalCoordinate``,
    ``GridGLL.cpp:470-550``).  ``stretch``: callable reta->(reta', d/dx) for
    non-uniform element spacing (reference VerticalStretch).
    """
    vo = vertical_order
    if nz % vo != 0:
        raise ValueError("vertical order must divide number of levels")
    nfe = nz // vo
    g, wg = quad.gauss(vo, 0.0, 1.0)
    gl, wl = quad.gauss_lobatto(vo + 1, 0.0, 1.0)

    lev = np.zeros(nz)
    na_lev = np.zeros(nz)
    intf = np.zeros(nz + 1)
    na_int = np.zeros(nz + 1)

    if stretch is None:
        bounds = np.linspace(0.0, 1.0, nfe + 1)
    else:
        bounds = np.array([stretch(x)[0]
                           for x in np.linspace(0.0, 1.0, nfe + 1)])
    for a in range(nfe):
        d = bounds[a + 1] - bounds[a]
        lev[a * vo:(a + 1) * vo] = bounds[a] + g * d
        na_lev[a * vo:(a + 1) * vo] = wg * d
        intf[a * vo:(a + 1) * vo + 1] = bounds[a] + gl * d
        na_int[a * vo:(a + 1) * vo + 1] += wl * d
    return lev, intf, na_lev, na_int


def _find_element(reta_redge: np.ndarray, vo: int, x: float):
    """(element index a, on_interior_edge) for output location x."""
    eps = 1.0e-12
    nfe = (len(reta_redge) - 1) // vo
    for a in range(nfe - 1):
        nxt = reta_redge[(a + 1) * vo] - eps
        if x < nxt:
            return a, False
        if x < nxt + 2 * eps:
            return a, True
    return nfe - 1, False


def interp_matrix(source: str, vo: int, reta_node, reta_redge, reta_out,
                  zero_boundaries: bool = False) -> np.ndarray:
    """Interpolation operator (reference ``LinearColumnInterpFEM::Initialize``).

    ``source``: "node" (discontinuous Gauss basis) or "redge" (continuous
    GLL basis).
    """
    eps = 1.0e-12
    nin = len(reta_node)
    nfe = nin // vo
    nout = len(reta_out)
    ncols = nin + 1 if source == "redge" else nin
    M = np.zeros((nout, ncols))

    lo, hi = 0, nout
    if zero_boundaries and abs(reta_out[0]) < eps:
        lo = 1
    if zero_boundaries and abs(reta_out[-1] - 1.0) < eps:
        hi = nout - 1

    for l in range(lo, hi):
        x = reta_out[l]
        a, on_edge = _find_element(reta_redge, vo, x)
        if source == "redge":
            if on_edge:
                M[l, (a + 1) * vo] = 1.0
            else:
                pts = reta_redge[a * vo:(a + 1) * vo + 1]
                M[l, a * vo:(a + 1) * vo + 1] = \
                    quad.lagrange_interp_coeffs(pts, x)
        else:
            if vo == 1 and l == 0:
                # O(dx^2) one-sided interpolant from the two lowest nodes
                pts = reta_node[0:2]
                M[l, 0:2] = quad.lagrange_interp_coeffs(pts, x)
                continue
            if vo == 1 and l == nout - 1:
                pts = reta_node[(a - 1) * vo:(a + 1) * vo]
                M[l, (a - 1) * vo:(a + 1) * vo] = \
                    quad.lagrange_interp_coeffs(pts, x)
                continue
            pts = reta_node[a * vo:(a + 1) * vo]
            cL = quad.lagrange_interp_coeffs(pts, x)
            if not on_edge:
                M[l, a * vo:(a + 1) * vo] = cL
            else:
                # error-weighted two-sided average at interior element edges
                dL = reta_redge[(a + 1) * vo] - reta_redge[a * vo]
                dR = reta_redge[(a + 2) * vo] - reta_redge[(a + 1) * vo]
                eL, eR = dL ** vo, dR ** vo
                wL, wR = eR / (eL + eR), eL / (eL + eR)
                ptsR = reta_node[(a + 1) * vo:(a + 2) * vo]
                cR = quad.lagrange_interp_coeffs(ptsR, x)
                M[l, a * vo:(a + 1) * vo] = wL * cL
                M[l, (a + 1) * vo:(a + 2) * vo] = wR * cR
    return M


def diff_interface_method(source: str, vo: int, reta_node, reta_redge,
                          reta_out, zero_boundaries: bool = False):
    """Differentiation via the continuous interface basis.

    Reference ``LinearColumnDiffFEM::InitializeInterfaceMethod``: derivative
    of the degree-vo GLL interface polynomial, error-weighted two-sided at
    interior element edges; composed with node->redge interpolation when the
    source is levels.
    """
    nin = len(reta_node)
    nfe = nin // vo
    nout = len(reta_out)
    D = np.zeros((nout, nin + 1))
    for l in range(nout):
        x = reta_out[l]
        a, on_edge = _find_element(reta_redge, vo, x)
        pts = reta_redge[a * vo:(a + 1) * vo + 1]
        cL = quad.lagrange_diff_coeffs(pts, x)
        if not on_edge:
            D[l, a * vo:(a + 1) * vo + 1] = cL
        else:
            dL = reta_redge[(a + 1) * vo] - reta_redge[a * vo]
            dR = reta_redge[(a + 2) * vo] - reta_redge[(a + 1) * vo]
            eL, eR = dL ** vo, dR ** vo
            wL, wR = eR / (eL + eR), eL / (eL + eR)
            ptsR = reta_redge[(a + 1) * vo:(a + 2) * vo + 1]
            cR = quad.lagrange_diff_coeffs(ptsR, x)
            D[l, a * vo:(a + 1) * vo + 1] = wL * cL
            D[l, (a + 1) * vo:(a + 2) * vo + 1] += wR * cR
    if source == "node":
        I = interp_matrix("node", vo, reta_node, reta_redge, reta_redge,
                          zero_boundaries)
        return D @ I
    return D


def diff_flux_correction(vo: int, reta_node, reta_redge, reta_out,
                         zero_boundaries: bool = True):
    """Node-source derivative by DG flux reconstruction (type-2 correction).

    Reference ``LinearColumnDiffFEM::InitializeFluxCorrectionMethod``
    (node source, output on interfaces for the HEVI solve).
    """
    ftype = 2
    nin = len(reta_node)
    nfe = nin // vo
    nout = len(reta_out)
    D = np.zeros((nout, nin))
    for l in range(nout):
        x = reta_out[l]
        a, on_edge = _find_element(reta_redge, vo, x)
        d_reta = reta_redge[(a + 1) * vo] - reta_redge[a * vo]

        row = np.zeros(nin)
        row[a * vo:(a + 1) * vo] = quad.lagrange_diff_coeffs(
            reta_node[a * vo:(a + 1) * vo], x)
        if on_edge:
            row[(a + 1) * vo:(a + 2) * vo] = quad.lagrange_diff_coeffs(
                reta_node[(a + 1) * vo:(a + 2) * vo], x)
            row *= 0.5 * d_reta
        else:
            row *= d_reta

        # flux-correction function derivatives at the local coordinate
        xr = (x - reta_redge[a * vo]) / d_reta
        dR = flux_correction_derivatives(ftype, vo + 1, [xr])[0]
        dLv = -flux_correction_derivatives(ftype, vo + 1, [1.0 - xr])[0]

        # interpolants of left/right element data to element edges
        cLR = quad.lagrange_interp_coeffs(
            reta_node[a * vo:(a + 1) * vo], reta_redge[a * vo])
        cRL = quad.lagrange_interp_coeffs(
            reta_node[a * vo:(a + 1) * vo], reta_redge[(a + 1) * vo])
        if a != 0:
            cLL = quad.lagrange_interp_coeffs(
                reta_node[(a - 1) * vo:a * vo], reta_redge[a * vo])
        if a != nfe - 1:
            cRR = quad.lagrange_interp_coeffs(
                reta_node[(a + 1) * vo:(a + 2) * vo],
                reta_redge[(a + 1) * vo])

        if a != 0:
            if not on_edge:
                row[(a - 1) * vo:a * vo] += 0.5 * dLv * cLL
            row[a * vo:(a + 1) * vo] -= 0.5 * dLv * cLR
        else:
            if (not zero_boundaries) and nfe != 1:
                row[a * vo:(a + 1) * vo] += 0.5 * dLv * cRL
                row[(a + 1) * vo:(a + 2) * vo] -= 0.5 * dLv * cRR

        if a != nfe - 1:
            row[(a + 1) * vo:(a + 2) * vo] += 0.5 * dR * cRR
            row[a * vo:(a + 1) * vo] -= 0.5 * dR * cRL
        else:
            if (not zero_boundaries) and nfe != 1:
                row[a * vo:(a + 1) * vo] += 0.5 * dR * cLR
                row[(a - 1) * vo:a * vo] -= 0.5 * dR * cLL

        D[l] = row / d_reta
    return D


def diffdiff_matrix(source: str, vo: int, reta_node, reta_redge):
    """Weak-form second derivative (reference ``LinearColumnDiffDiffFEM``)."""
    ftype = 2
    nfe = len(reta_node) // vo
    if source == "node":
        n = len(reta_node)
        M = np.zeros((n, n))
        # per-node Gauss weights
        w = np.zeros(n)
        for a in range(nfe):
            _, wt = quad.gauss(vo, reta_redge[a * vo], reta_redge[(a + 1) * vo])
            w[a * vo:(a + 1) * vo] = wt
        for a in range(nfe):
            ax = a * vo
            d_el = reta_redge[(a + 1) * vo] - reta_redge[a * vo]
            dcorr = flux_correction_derivatives(ftype, vo + 1, [1.0])[0] / d_el
            pts = reta_node[ax:ax + vo]
            Dloc = np.zeros((vo, vo))     # Dloc[n, m] = dL_m/dx at node n
            for nn in range(vo):
                Dloc[nn] = quad.lagrange_diff_coeffs(pts, pts[nn])
            # interior integral: -sum_s D[s,j] D[s,i] w[s]  (note Dloc[s] row
            # = coeffs at node s)
            M[ax:ax + vo, ax:ax + vo] -= np.einsum(
                "sj,si,s->ji", Dloc, Dloc, w[ax:ax + vo])
            # boundary terms
            for j in range(vo):
                basis = np.zeros(vo)
                basis[j] = 1.0
                phiL = quad.lagrange_interp_coeffs(
                    pts, reta_redge[a * vo]) @ basis
                phiR = quad.lagrange_interp_coeffs(
                    pts, reta_redge[(a + 1) * vo]) @ basis
                if a != 0:
                    cl = quad.lagrange_diff_coeffs(pts, reta_redge[a * vo])
                    M[ax + j, ax:ax + vo] -= 0.5 * phiL * cl
                    clm = quad.lagrange_diff_coeffs(
                        reta_node[(a - 1) * vo:a * vo], reta_redge[a * vo])
                    M[ax + j, ax - vo:ax] -= 0.5 * phiL * clm
                if a != nfe - 1:
                    cr = quad.lagrange_diff_coeffs(
                        pts, reta_redge[(a + 1) * vo])
                    M[ax + j, ax:ax + vo] += 0.5 * phiR * cr
                    crp = quad.lagrange_diff_coeffs(
                        reta_node[(a + 1) * vo:(a + 2) * vo],
                        reta_redge[(a + 1) * vo])
                    M[ax + j, ax + vo:ax + 2 * vo] += 0.5 * phiR * crp
                # flux correction at right edge
                if a + 1 < nfe:
                    cR = quad.lagrange_interp_coeffs(
                        reta_node[(a + 1) * vo:(a + 2) * vo],
                        reta_redge[(a + 1) * vo])
                    cL = quad.lagrange_interp_coeffs(
                        pts, reta_redge[(a + 1) * vo])
                    M[ax + j, ax:ax + vo] -= 0.5 * phiR * cL * dcorr
                    M[ax + j, ax + vo:ax + 2 * vo] += 0.5 * phiR * cR * dcorr
                # flux correction at left edge
                if a > 0:
                    cR = quad.lagrange_interp_coeffs(pts, reta_redge[a * vo])
                    cL = quad.lagrange_interp_coeffs(
                        reta_node[(a - 1) * vo:a * vo], reta_redge[a * vo])
                    M[ax + j, ax - vo:ax] += 0.5 * phiL * cL * dcorr
                    M[ax + j, ax:ax + vo] -= 0.5 * phiL * cR * dcorr
        M /= w[:, None]
        return M

    # interfaces -> interfaces
    n = len(reta_redge)
    M = np.zeros((n, n))
    for a in range(nfe):
        pts = reta_redge[a * vo:(a + 1) * vo + 1]
        _, w = quad.gauss_lobatto(vo + 1, pts[0], pts[-1])
        Dloc = np.zeros((vo + 1, vo + 1))
        for i in range(vo + 1):
            Dloc[i] = quad.lagrange_diff_coeffs(pts, pts[i])
        for j in range(vo + 1):
            jx = j + a * vo
            wl = w[j]
            if j == 0 and a != 0:
                wl *= 2.0
            if j == vo and a != nfe - 1:
                wl *= 2.0
            for i in range(vo + 1):
                ix = i + a * vo
                M[jx, ix] -= np.sum(Dloc[:, j] * Dloc[:, i] * w) / wl
    return M


def penalty_matrices(vo: int, reta_node, reta_redge):
    """Left/right discontinuous penalty operators + weight slots.

    Reference ``LinearColumnDiscPenaltyFEM::Initialize``.  Returns
    (op_left, op_right) with shape (nz, nz); the weight for interior element
    boundary a (a = 1..nfe-1) multiplies rows of element a-1 in op_left and
    element a in op_right.  Apply as::

        out += (op_left @ f) * w_elem_left + (op_right @ f) * w_elem_right

    where the weight arrays broadcast the per-boundary |u^xi| to the rows.
    """
    ftype = 2
    n = len(reta_node)
    nfe = n // vo
    L = np.zeros((n, n))
    R = np.zeros((n, n))
    if nfe == 1:
        return L, R
    interpL = np.zeros((nfe - 1, vo))
    interpR = np.zeros((nfe - 1, vo))
    for a in range(nfe - 1):
        interpL[a] = quad.lagrange_interp_coeffs(
            reta_node[a * vo:(a + 1) * vo], reta_redge[(a + 1) * vo])
        interpR[a] = quad.lagrange_interp_coeffs(
            reta_node[(a + 1) * vo:(a + 2) * vo], reta_redge[(a + 1) * vo])
    # penalty distributed to element left of edge a+1
    for a in range(nfe - 1):
        ax = a * vo
        lo, hi = reta_redge[a * vo], reta_redge[(a + 1) * vo]
        sub = (reta_node[ax:ax + vo] - lo) / (hi - lo)
        dflux = flux_correction_derivatives(ftype, vo + 1, sub) / (hi - lo)
        for i in range(vo):
            L[ax + i, ax:ax + vo] += -0.5 * dflux[i] * interpL[a]
            L[ax + i, ax + vo:ax + 2 * vo] += 0.5 * dflux[i] * interpR[a]
    # penalty distributed to element right of edge a
    for a in range(1, nfe):
        ax = a * vo
        lo, hi = reta_redge[a * vo], reta_redge[(a + 1) * vo]
        sub = 1.0 - (reta_node[ax:ax + vo] - lo) / (hi - lo)
        dflux = flux_correction_derivatives(ftype, vo + 1, sub) / (-(hi - lo))
        for i in range(vo):
            R[ax + i, ax - vo:ax] += -0.5 * dflux[i] * interpL[a - 1]
            R[ax + i, ax:ax + vo] += 0.5 * dflux[i] * interpR[a - 1]
    return L, R


@dataclasses.dataclass(frozen=True)
class ColumnOps:
    """All vertical operator matrices for one (nz, vertical_order) config."""
    nz: int
    vo: int
    reta_lev: np.ndarray      # (nz,)
    reta_int: np.ndarray      # (nz+1,)
    na_lev: np.ndarray        # (nz,) normalized areas
    na_int: np.ndarray        # (nz+1,)
    interp_n2i: np.ndarray    # (nz+1, nz)
    interp_i2n: np.ndarray    # (nz, nz+1)
    diff_n2n: np.ndarray      # (nz, nz)
    diff_n2n_zb: np.ndarray   # (nz, nz) zero-boundary variant
    diff_n2i: np.ndarray      # (nz+1, nz)  flux-correction method
    diff_i2n: np.ndarray      # (nz, nz+1)
    diff_i2i: np.ndarray      # (nz+1, nz+1)
    diffdiff_n2n: np.ndarray  # (nz, nz)
    diffdiff_i2i: np.ndarray  # (nz+1, nz+1)
    penalty_left: np.ndarray  # (nz, nz)
    penalty_right: np.ndarray # (nz, nz)
    # weight scatter: maps (nfe-1,) per-boundary weights to (nz,) rows
    wscat_left: np.ndarray    # (nz, nfe-1)
    wscat_right: np.ndarray   # (nz, nfe-1)


def build_column_ops(nz: int, vertical_order: int = 1,
                     stretch=None) -> ColumnOps:
    """Construct all operators (matches GridGLL non-FV, LOR/LEV branch)."""
    vo = vertical_order
    lev, intf, na_lev, na_int = vertical_coordinate(nz, vo, stretch)
    nfe = nz // vo
    L, R = penalty_matrices(vo, lev, intf)
    wsl = np.zeros((nz, max(nfe - 1, 1)))
    wsr = np.zeros((nz, max(nfe - 1, 1)))
    for a in range(nfe - 1):
        wsl[a * vo:(a + 1) * vo, a] = 1.0          # element left of edge a+1
        wsr[(a + 1) * vo:(a + 2) * vo, a] = 1.0    # element right of edge a+1
    return ColumnOps(
        nz=nz, vo=vo, reta_lev=lev, reta_int=intf,
        na_lev=na_lev, na_int=na_int,
        interp_n2i=interp_matrix("node", vo, lev, intf, intf),
        interp_i2n=interp_matrix("redge", vo, lev, intf, lev),
        diff_n2n=diff_interface_method("node", vo, lev, intf, lev, False),
        diff_n2n_zb=diff_interface_method("node", vo, lev, intf, lev, True),
        diff_n2i=diff_flux_correction(vo, lev, intf, intf, True),
        diff_i2n=diff_interface_method("redge", vo, lev, intf, lev),
        diff_i2i=diff_interface_method("redge", vo, lev, intf, intf),
        diffdiff_n2n=diffdiff_matrix("node", vo, lev, intf),
        diffdiff_i2i=diffdiff_matrix("redge", vo, lev, intf),
        penalty_left=L, penalty_right=R,
        wscat_left=wsl, wscat_right=wsr,
    )


# ---------------------------------------------------------------------------
# INT staggering (--vstagger INT): all variables on levels placed at
# element-shared GLL points spanning [0, 1] (boundary levels included)
# ---------------------------------------------------------------------------

def vertical_coordinate_int(nz: int, vertical_order: int, stretch=None):
    """(reta_levels, reta_interfaces, norm_area_lev, norm_area_int) for
    the INT staggering.

    Reference ``GridGLL::InitializeVerticalCoordinate`` INT branch
    (``GridGLL.cpp:385-455``): levels at per-element GLL points with
    shared element endpoints; requires (vertorder - 1) | (levels - 1)
    and vertorder >= 2; interior shared nodes carry the summed (2x)
    quadrature weight.  Interfaces keep the uniform base-grid placement
    (``Grid.cpp`` GridSpacingUniform).
    """
    vo = vertical_order
    if vo < 2:
        raise ValueError("INT staggering requires vertical order >= 2")
    if (nz - 1) % (vo - 1) != 0:
        raise ValueError("(vertorder - 1) must divide (levels - 1)")
    nfe = (nz - 1) // (vo - 1)
    gl, wl = quad.gauss_lobatto(vo, 0.0, 1.0)

    lev = np.zeros(nz)
    na_lev = np.zeros(nz)
    if stretch is None:
        bounds = np.linspace(0.0, 1.0, nfe + 1)
    else:
        bounds = np.array([stretch(x)[0]
                           for x in np.linspace(0.0, 1.0, nfe + 1)])
    for a in range(nfe):
        d = bounds[a + 1] - bounds[a]
        for k in range(vo):
            kx = a * (vo - 1) + k
            lev[kx] = bounds[a] + gl[k] * d
            na_lev[kx] += wl[k] * d

    if stretch is None:
        intf = np.linspace(0.0, 1.0, nz + 1)
    else:
        intf = np.array([stretch(x)[0]
                         for x in np.linspace(0.0, 1.0, nz + 1)])
    na_int = np.zeros(nz + 1)
    na_int[:-1] += 0.5 * np.diff(intf)
    na_int[1:] += 0.5 * np.diff(intf)
    return lev, intf, na_lev, na_int


def _int_element_of(vo: int, lev, x: float):
    """Element index containing x, and whether x sits on a shared edge."""
    eps = 1.0e-12
    nfe = (len(lev) - 1) // (vo - 1)
    for a in range(nfe - 1):
        nxt = lev[(a + 1) * (vo - 1)] - eps
        if x < nxt:
            return a, False
        if x < nxt + 2.0 * eps:
            return a, True
    return nfe - 1, False


def diff_gll_nodes(vo: int, lev, reta_out) -> np.ndarray:
    """Derivative operator on shared-GLL-node columns.

    Reference ``LinearColumnDiffFEM::InitializeGLLNodes``
    (``LinearColumnOperatorFEM.cpp:703-830``): per-element Lagrange
    derivative; at shared element edges the one-sided derivatives are
    averaged with truncation-error weights err_R/(err_L+err_R).
    """
    nin, nout = len(lev), len(reta_out)
    M = np.zeros((nout, nin))
    for l in range(nout):
        a, on_edge = _int_element_of(vo, lev, reta_out[l])
        i0 = a * (vo - 1)
        pts = lev[i0:i0 + vo]
        c = quad.lagrange_diff_coeffs(pts, reta_out[l])
        if not on_edge:
            M[l, i0:i0 + vo] = c
        else:
            dL = lev[(a + 1) * (vo - 1)] - lev[a * (vo - 1)]
            dR = lev[(a + 2) * (vo - 1)] - lev[(a + 1) * (vo - 1)]
            eL = dL ** (vo - 1)
            eR = dR ** (vo - 1)
            wL = eR / (eL + eR)
            wR = eL / (eL + eR)
            i1 = (a + 1) * (vo - 1)
            cR = quad.lagrange_diff_coeffs(lev[i1:i1 + vo], reta_out[l])
            M[l, i0:i0 + vo] += wL * c
            M[l, i1:i1 + vo] += wR * cR
    return M


def diffdiff_gll_nodes(vo: int, lev) -> np.ndarray:
    """Variational second-derivative operator on shared-GLL-node columns.

    Reference ``LinearColumnDiffDiffFEM::InitializeGLLNodes``
    (``LinearColumnOperatorFEM.cpp:1387-1480``): per element,
    M[j, i] -= sum_s D[s, j] D[s, i] w_s / w_j with the shared-node
    quadrature weight doubled.
    """
    nin = len(lev)
    nfe = (nin - 1) // (vo - 1)
    M = np.zeros((nin, nin))
    for a in range(nfe):
        i0 = a * (vo - 1)
        x0, x1 = lev[i0], lev[i0 + vo - 1]
        g, w = quad.gauss_lobatto(vo, x0, x1)
        D = np.stack([quad.lagrange_diff_coeffs(lev[i0:i0 + vo], g[s])
                      for s in range(vo)])          # (s, i)
        for j in range(vo):
            jx = i0 + j
            wloc = w[j]
            if j == 0 and a != 0:
                wloc *= 2.0
            if j == vo - 1 and a != nfe - 1:
                wloc *= 2.0
            for i in range(vo):
                M[jx, i0 + i] -= np.dot(D[:, j] * D[:, i], w) / wloc
    return M


def interp_gll_nodes(vo: int, lev, reta_out) -> np.ndarray:
    """Lagrange interpolation from shared-GLL-node levels to arbitrary
    output points (element-local)."""
    nin, nout = len(lev), len(reta_out)
    M = np.zeros((nout, nin))
    for l in range(nout):
        a, _ = _int_element_of(vo, lev, reta_out[l])
        i0 = a * (vo - 1)
        M[l, i0:i0 + vo] = quad.lagrange_interp_coeffs(
            lev[i0:i0 + vo], reta_out[l])
    return M


def build_column_ops_interfaces(nz: int, vertical_order: int,
                                stretch=None) -> ColumnOps:
    """ColumnOps for the INT staggering (all variables on levels at
    shared GLL points).  The level-space operators are the GLL-nodes
    variants; interface-space operators (used only by aux plumbing, not
    by the INT dynamics) are built by element-local Lagrange maps on the
    uniform interface grid."""
    vo = vertical_order
    lev, intf, na_lev, na_int = vertical_coordinate_int(nz, vo, stretch)

    # interface-space helpers on the uniform interface grid (treated as
    # shared linear elements)
    def from_intf(out):
        return interp_gll_nodes(2, intf, out)

    def diff_from_intf(out):
        return diff_gll_nodes(2, intf, out)

    return ColumnOps(
        nz=nz, vo=vo, reta_lev=lev, reta_int=intf,
        na_lev=na_lev, na_int=na_int,
        interp_n2i=interp_gll_nodes(vo, lev, intf),
        interp_i2n=from_intf(lev),
        diff_n2n=diff_gll_nodes(vo, lev, lev),
        diff_n2n_zb=diff_gll_nodes(vo, lev, lev),
        diff_n2i=diff_gll_nodes(vo, lev, intf),
        diff_i2n=diff_from_intf(lev),
        diff_i2i=diff_from_intf(intf),
        diffdiff_n2n=diffdiff_gll_nodes(vo, lev),
        diffdiff_i2i=diffdiff_gll_nodes(2, intf),
        penalty_left=None, penalty_right=None,
        wscat_left=None, wscat_right=None,
    )


# ---------------------------------------------------------------------------
# FV vertical discretization (--vdisc FV): cell-centered finite volumes
# with sliding-stencil polynomial reconstruction
# ---------------------------------------------------------------------------

def interp_n2i_fv(vo: int, lev, intf) -> np.ndarray:
    """Levels -> interfaces by averaged left/right sliding Lagrange
    stencils (``LinearColumnInterpFEM::InitializeReconstructed``,
    ``LinearColumnOperatorFEM.cpp:209-330``; one-sided with weight 1 at
    the boundaries)."""
    nn, ni = len(lev), len(intf)
    M = np.zeros((ni, nn))
    for k in range(ni):
        w = 1.0 if k in (0, ni - 1) else 0.5
        if k != 0:
            kb = max(k - (vo - 2) // 2 - 1, 0)
            kl = min(k + (vo - 2) // 2 - 1, nn - 1)
            M[k, kb:kl + 1] += w * quad.lagrange_interp_coeffs(
                lev[kb:kl + 1], intf[k])
        if k != ni - 1:
            kb = max(k - (vo - 2) // 2, 0)
            kl = min(k + (vo - 2) // 2, nn - 1)
            M[k, kb:kl + 1] += w * quad.lagrange_interp_coeffs(
                lev[kb:kl + 1], intf[k])
    return M


def build_column_ops_fv(nz: int, vertical_order: int,
                        stretch=None) -> ColumnOps:
    """ColumnOps for the FV vertical discretization
    (``GridGLL::Initialize`` FV branch, ``GridGLL.cpp:191-250``):
    cell-centered levels (one node per cell), conservative cell-flux
    divergence diff_i2n, reconstruction-order-``vertical_order`` sliding
    Lagrange interp/diff operators, order-1 variational diffdiff, and
    per-interface upwind penalties (nFiniteElements == nRElements,
    ``VerticalDynamicsFEM.cpp:2645-2660``)."""
    vo = vertical_order
    if vo < 2 or vo % 2 != 0:
        raise ValueError(
            "--vdisc FV requires an even --vertorder >= 2 "
            "(reconstruction order; LinearColumnOperatorFEM.cpp:942-947)")
    # FV vertical coordinate: one node per cell at the cell Gauss point
    lev, intf, na_lev, na_int = vertical_coordinate(nz, 1, stretch)

    # interfaces -> levels: central average / conservative divergence
    Ii2n = np.zeros((nz, nz + 1))
    Di2n = np.zeros((nz, nz + 1))
    for k in range(nz):
        dv = intf[k + 1] - intf[k]
        Ii2n[k, k] = Ii2n[k, k + 1] = 0.5
        Di2n[k, k] = -1.0 / dv
        Di2n[k, k + 1] = +1.0 / dv

    In2i = interp_n2i_fv(vo, lev, intf)

    Di2i = np.zeros((nz + 1, nz + 1))
    for k in range(nz + 1):
        kb = max(k - vo // 2, 0)
        kl = min(k + vo // 2, nz)
        Di2i[k, kb:kl + 1] = quad.lagrange_diff_coeffs(
            intf[kb:kl + 1], intf[k])
    Dn2i = np.zeros((nz + 1, nz))
    for k in range(nz + 1):
        kb = max(k - vo // 2, 0)
        kl = min(k + vo // 2 - 1, nz - 1)
        Dn2i[k, kb:kl + 1] = quad.lagrange_diff_coeffs(
            lev[kb:kl + 1], intf[k])

    L, R = penalty_matrices(1, lev, intf)
    nfe = nz
    wsl = np.zeros((nz, max(nfe - 1, 1)))
    wsr = np.zeros((nz, max(nfe - 1, 1)))
    for a in range(nfe - 1):
        wsl[a, a] = 1.0
        wsr[a + 1, a] = 1.0

    return ColumnOps(
        nz=nz, vo=1, reta_lev=lev, reta_int=intf,
        na_lev=na_lev, na_int=na_int,
        interp_n2i=In2i, interp_i2n=Ii2n,
        diff_n2n=Di2n @ In2i,
        diff_n2n_zb=Di2n @ In2i,
        diff_n2i=Dn2i, diff_i2n=Di2n, diff_i2i=Di2i,
        diffdiff_n2n=diffdiff_matrix("node", 1, lev, intf),
        diffdiff_i2i=diffdiff_matrix("redge", 1, lev, intf),
        penalty_left=L, penalty_right=R,
        wscat_left=wsl, wscat_right=wsr,
    )
