"""Semi-analytic linear mountain-wave solutions on the sphere.

Counterpart of the JAX package's ``utils/mountain_waves.py`` (host numpy
and scipy, imported where the eigenproblem is solved); an analog of the
reference ``util/MountainWavesSphere`` tools:

- :func:`generate_evolution_matrix` / :func:`compute_wave_modes` mirror
  ``ComputeWaveModes.cpp`` (``GenerateEvolutionMatrix`` :33-180,
  ``SolveEvolutionMatrix`` via LAPACK ``dggev_`` :183-260): build the
  linearized 5-field (u, p, w, rho, v-staggered) meridional operator for
  zonal wavenumber k and solve the generalized eigenproblem M x = lam B x.
- :func:`schar_topography` / :func:`wave_topography` mirror
  ``GenerateScharTopography.cpp`` / ``GenerateWaveTopography.cpp``.

The reference passes row-major arrays to Fortran ``dggev_``, i.e. it
solves the transposed pencil; we reproduce that exactly so mode sets
match bit-for-allclose.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class WaveParameters:
    """Analog of ``util/MountainWavesSphere/Parameters.h``."""
    n_phi_elements: int = 40
    xscale: float = 1.0
    t0: float = 300.0
    u0: float = 20.0
    g: float = 9.80616
    omega: float = 7.29212e-5
    gamma: float = 1.4
    earth_radius: float = 6.37122e6
    Rd: float = 287.0

    def latitude_arrays(self):
        """(nodes, edges) uniform latitude spacing (``GenerateLatituteArray``)."""
        n = self.n_phi_elements
        dphi = np.pi / n
        nodes = -0.5 * np.pi + (np.arange(n) + 0.5) * dphi
        edges = -0.5 * np.pi + np.arange(n + 1) * dphi
        return nodes, edges


def generate_evolution_matrix(k: int, param: WaveParameters):
    """(M, B, inv_Ro, Fr) for zonal wavenumber ``k``.

    Unknown ordering matches the reference: per latitude node j the block
    (U, P, W, R) at indices 4j..4j+3, then the staggered V at
    4*nphi + j - 1 (interior edges only).
    """
    n_phi = param.n_phi_elements
    nodes, edges = param.latitude_arrays()
    nsize = 5 * n_phi - 1
    M = np.zeros((nsize, nsize))
    B = np.zeros((nsize, nsize))

    inv_ro = 2.0 * param.earth_radius * param.omega * param.xscale / param.u0
    H = param.Rd * param.t0 / param.g
    fr = param.u0 / np.sqrt(param.g * H)
    fr2 = fr * fr
    a_s = H / (param.earth_radius / param.xscale)
    a_v = a_s
    k2 = float(k * k)
    inv_gamma = 1.0 / param.gamma
    dphi = nodes[1] - nodes[0]

    for j in range(n_phi):
        ix = 4 * j
        ixU, ixP, ixW, ixR = ix, ix + 1, ix + 2, ix + 3
        ixVL = 4 * n_phi + j - 1
        ixVR = 4 * n_phi + j
        phi = nodes[j]
        cphi, sphi = np.cos(phi), np.sin(phi)

        M[ixU][ixU] = fr2 * cphi * cphi
        M[ixP][ixU] = 1.0
        if j != 0:
            M[ixVL][ixU] = -0.5 * fr2 * (2.0 + inv_ro) * sphi * cphi
        if j != n_phi - 1:
            M[ixVR][ixU] = -0.5 * fr2 * (2.0 + inv_ro) * sphi * cphi

        if j != 0:
            ixV = ixVL
            ixUL, ixPL, ixRL = ix - 4, ix - 3, ix - 1
            ixUR, ixPR, ixRR = ix, ix + 1, ix + 3
            phis = edges[j]
            ss, cs = np.sin(phis), np.cos(phis)
            M[ixUL][ixV] = 0.5 * fr2 * (2.0 + inv_ro) * ss * cs
            M[ixUR][ixV] = 0.5 * fr2 * (2.0 + inv_ro) * ss * cs
            M[ixV][ixV] = -k2 * fr2
            M[ixPL][ixV] = (-0.5 * fr2 * (1.0 + inv_ro) * ss * cs
                            - 1.0 / dphi)
            M[ixPR][ixV] = (-0.5 * fr2 * (1.0 + inv_ro) * ss * cs
                            + 1.0 / dphi)
            M[ixRL][ixV] = 0.5 * fr2 * (1.0 + inv_ro) * ss * cs
            M[ixRR][ixV] = 0.5 * fr2 * (1.0 + inv_ro) * ss * cs

        M[ixU][ixP] = cphi
        M[ixR][ixP] = cphi
        if j != 0:
            M[ixVL][ixP] = (-0.5 * fr2 * (1.0 + inv_ro) * sphi * cphi * cphi
                            - 0.5 * sphi - cphi / dphi)
        if j != n_phi - 1:
            M[ixVR][ixP] = (-0.5 * fr2 * (1.0 + inv_ro) * sphi * cphi * cphi
                            - 0.5 * sphi + cphi / dphi)

        M[ixW][ixW] = -k2 * a_s * a_v * fr2
        M[ixR][ixW] = 1.0

        M[ixP][ixR] = inv_gamma / (1.0 - inv_gamma)
        M[ixW][ixR] = a_v / a_s
        M[ixR][ixR] = -1.0 / (1.0 - inv_gamma)
        if j != 0:
            M[ixVL][ixR] = 0.5 * fr2 * (1.0 + inv_ro) * sphi * cphi
        if j != n_phi - 1:
            M[ixVR][ixR] = 0.5 * fr2 * (1.0 + inv_ro) * sphi * cphi

        B[ixP][ixW] = -1.0
        B[ixW][ixP] = -1.0

    return M, B, inv_ro, fr


def wave_modes(k: int, param: WaveParameters):
    """(lam, modes): generalized eigenvalues + right eigenvectors of the
    transposed pencil M^T x = lam B^T x — the system the reference's
    row-major ``dggev_`` call actually solves (``SolveEvolutionMatrix``,
    ``ComputeWaveModes.cpp:183-260``).  Infinite eigenvalues (beta = 0)
    come back as ``inf``/``nan``; filter with :func:`finite_modes`."""
    import scipy.linalg
    M, B, _, _ = generate_evolution_matrix(k, param)
    lam, vr = scipy.linalg.eig(M.T, B.T, right=True)
    return lam, vr


def finite_modes(lam, vr, tol: float = 1e8):
    """Keep finite, nonzero-denominator modes, sorted by |Im lam|."""
    mask = np.isfinite(lam) & (np.abs(lam) < tol)
    lam, vr = lam[mask], vr[:, mask]
    order = np.argsort(np.abs(lam.imag))
    return lam[order], vr[:, order]


def schar_topography(lon, lat, h0: float = 250.0,
                     d: float = 5000.0, xi: float = 4000.0,
                     lon_c: float = np.pi / 4.0, lat_c: float = 0.0,
                     earth_radius: float = 6.37122e6):
    """Schar-type oscillatory ridge topography on the sphere.

    Analog of ``GenerateScharTopography.cpp``: great-circle distance r
    from (lon_c, lat_c), h = h0 exp(-(r/d)^2) cos^2(pi r / xi).
    """
    r = earth_radius * np.arccos(np.clip(
        np.sin(lat_c) * np.sin(lat)
        + np.cos(lat_c) * np.cos(lat) * np.cos(lon - lon_c), -1.0, 1.0))
    return h0 * np.exp(-(r / d) ** 2) * np.cos(np.pi * r / xi) ** 2


def wave_topography(lon, lat, h0: float = 250.0, k: int = 8,
                    lat_width: float = np.pi / 16.0,
                    lat_c: float = 0.0):
    """Zonal-wavenumber-k sinusoidal ridge with Gaussian latitude envelope.

    Analog of ``GenerateWaveTopography.cpp``.
    """
    return (h0 * np.cos(k * lon)
            * np.exp(-((lat - lat_c) / lat_width) ** 2))
