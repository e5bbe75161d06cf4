"""DSS, one launch per field or per group of fields: the CUDA kernels'
wrappers and their plain versions.

Counterpart of the JAX package's ``fast/dss_pallas.py`` (``dss_scalar``,
``dss_vector``, ``dss_uvw``, ``dss_state``, ``dss_scalar2``).  DSS (direct
stiffness summation) replaces every group of coincident GLL nodes by its
mean: interior element pair sums inside each panel (along a, then b), plus
the 24 panel-edge link lines taken from the PAIR-SUMMED neighbour panel
(reversed where ``flip``; rotated by the per-node 2x2 covariant transform
for the (U, V) pair), times the inverse multiplicity.  A cube-corner node
lies on two edges and receives two contributions.

A Cartesian grid is one panel without links (``links == ()``, A and B may
differ); ``wrap`` = (along a, along b) then adds the periodic wrap-sum: node
0 and node A-1 (B-1) of a periodic axis are one pair, as in
``grid/cartesian._pair_sum_axis``.

``dss_scalar``, ``dss_vector``, ``dss_uvw``, ``dss_scalar2`` and
``dss_state`` are the five modes of one band kernel (``MODES``): they stage
bands of whole element rows in shared memory (bulk asynchronous copies where
spans and pointers allow 16 bytes, else ``cp.async`` of 8 or 4 bytes;
``copy_width``) and sum there, a thread an element-row segment; their launch
shape comes from ``dss_launch_shape``.  See the note in ``csrc/dss.cu`` for
the design and the bound on the card.  Fields are z-first ``(K, 6, A,
B)``.

``dss_uvw`` is the DSS of U, V and W in one launch with the explicit
stage's W finish folded in (``w_finish_plain`` says what that is): W is
assembled from the stage's outputs wherever the gather reads it and is never
stored before its DSS.

``dss_state`` is the DSS of all five fields of the state in one launch,
optionally with the Rayleigh finish ``x <- fac * x + ref`` folded in;
``dss_scalar2`` is the DSS of two scalar fields of one shape in one launch.
Both give what the separate launches give, bit for bit.

A Cartesian grid with no-flux walls along one axis (``noflux`` = (along a,
along b), at most one) averages each wall node's result with its halo,
``0.5 * (x + h)``, after the inverse multiplicity and before the Rayleigh
finish, as ``grid/cartesian.apply_dss_cartesian(halo=)`` does.  Every mode
takes ``halo``: None (no average: the halo tracks the node), ``ZERO_HALO``
(the halo of the nu4 working state, which the reference zeroes) or, per
output field, the halo's wall rows alone: ``(levels, 2, L)`` as
``wall_rows`` takes them (L = B for walls along a, A along b; side 0 the
first wall).  Only wall rows are ever read, and a wall-row halo makes the
stage combinations of the halo cost O(walls) instead of O(state).
``dss_state`` can also return the wall rows of its result before the
Rayleigh finish (``walls_out``).

Every wrapper launches its kernel for CUDA
tensors — or raise — and run the plain version only for tensors that lie on
the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import math
import re
from typing import NamedTuple

import numpy as np
import torch

from ..grid.cartesian import _pair_sum_axis
from ..grid.geometry import EDGE_LEFT, EDGE_RIGHT, EDGE_BOTTOM, EDGE_TOP
from ..kernels import build
from ..kernels.counts import launch_counts


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

ZERO_HALO = "zero"   # the halo of a zeroed working state (nu4 pass 1)


def wall_rows(f, noflux):
    """The wall rows of a ``(K, 1, A, B)`` field: ``(K, 2, B)`` (rows a = 0
    and A - 1) for walls along a, ``(K, 2, A)`` (columns b = 0 and B - 1)
    along b; a fresh contiguous tensor."""
    # slices, not an index list: a CUDA graph capture cannot copy one
    if noflux[0]:
        return torch.stack((f[:, 0, 0, :], f[:, 0, -1, :]), 1)
    if noflux[1]:
        return torch.stack((f[:, 0, :, 0], f[:, 0, :, -1]), 1)
    raise ValueError("wall_rows needs a no-flux axis")


def _wall_average(o, h, noflux):
    """``o`` (a fresh DSS result) with its wall nodes averaged with the
    halo ``h`` (wall rows, or ``ZERO_HALO``), in place."""
    for side, idx in ((0, 0), (1, -1)):
        if noflux[0]:
            hv = 0.0 if h is ZERO_HALO else h[:, side]
            o[:, 0, idx, :] = 0.5 * (o[:, 0, idx, :] + hv)
        elif noflux[1]:
            hv = 0.0 if h is ZERO_HALO else h[:, side]
            o[:, 0, :, idx] = 0.5 * (o[:, 0, :, idx] + hv)
    return o


def _halo_part(halo, i):
    """The halo of output ``i`` of a mode (``halo``: None, ``ZERO_HALO``
    or a tuple a field)."""
    return halo if halo is None or halo is ZERO_HALO else halo[i]


def _walls_on(noflux, halo) -> bool:
    return halo is not None and any(noflux)

def _pair_sum_plain(f, p: int, wrap=(False, False)):
    """Interior element pair sums along axes 2 (a) and 3 (b) of a
    (K, P, A, B) field, with the periodic wrap-sum on the axes ``wrap``
    names.  Returns a fresh tensor."""
    K, P, A, B = f.shape
    f = _pair_sum_axis(f, A // p, p, 2, bool(wrap[0]))
    return _pair_sum_axis(f, B // p, p, 3, bool(wrap[1]))


def _edge_view(f, panel: int, edge: int):
    """(K, L) view of one panel edge of a (K, P, A, B) field."""
    if edge == EDGE_LEFT:
        return f[:, panel, 0, :]
    if edge == EDGE_RIGHT:
        return f[:, panel, -1, :]
    if edge == EDGE_BOTTOM:
        return f[:, panel, :, 0]
    if edge == EDGE_TOP:
        return f[:, panel, :, -1]
    raise ValueError(edge)


def dss_scalar_plain(f, imult, links, p: int, wrap=(False, False),
                     noflux=(False, False), halo=None):
    """Plain PyTorch DSS of a scalar (K, P, A, B) field; ``halo``: the
    no-flux walls' (see the module note)."""
    s = _pair_sum_plain(f, p, wrap)
    # every neighbour line is taken from the PRE-edge-sum panel sums
    out = s.clone()
    for (pa, e, qa, qe, flip) in links:
        line = _edge_view(s, qa, qe)
        if flip:
            line = line.flip(-1)
        _edge_view(out, pa, e).add_(line)            # in place on `out`
    out = out * imult[None]
    return _wall_average(out, halo, noflux) if _walls_on(noflux, halo) \
        else out


def dss_vector_plain(u, v, imult, rot, links, p: int, wrap=(False, False),
                     noflux=(False, False), halo=None):
    """Plain PyTorch DSS of a covariant (U, V) pair; ``rot`` is
    ``(4, nlinks, A)`` = [r00, r01, r10, r11] along each destination edge;
    ``halo``: None, ``ZERO_HALO`` or (U's, V's)."""
    su = _pair_sum_plain(u, p, wrap)
    sv = _pair_sum_plain(v, p, wrap)
    ou, ov = su.clone(), sv.clone()
    for i, (pa, e, qa, qe, flip) in enumerate(links):
        lu = _edge_view(su, qa, qe)
        lv = _edge_view(sv, qa, qe)
        if flip:
            lu, lv = lu.flip(-1), lv.flip(-1)
        _edge_view(ou, pa, e).add_(rot[0, i][None] * lu + rot[1, i][None] * lv)
        _edge_view(ov, pa, e).add_(rot[2, i][None] * lu + rot[3, i][None] * lv)
    w = imult[None]
    ou, ov = ou * w, ov * w
    if _walls_on(noflux, halo):
        _wall_average(ou, _halo_part(halo, 0), noflux)
        _wall_average(ov, _halo_part(halo, 1), noflux)
    return ou, ov


def w_finish_plain(u, v, wf):
    """The W of an explicit stage from its deferred finish ``wf`` (the dict
    that ``fused_stage(defer_w=True)`` returns): W = base + dt_s * dW with
    dW masked to the interior interfaces, base = ``bw1`` or ``cb1 * bw1 +
    cb2 * bw2``, and the diagnostic bottom row from u^xi(surface) = 0 with
    the post-stage, pre-DSS ``u``, ``v`` at levels 0 and 1.  Returns a fresh
    tensor."""
    dW = wf["dW"].clone()
    dW[0] = 0.0
    dW[-1] = 0.0
    base = wf["bw1"] if wf.get("bw2") is None else (
        wf["cb1"] * wf["bw1"] + wf["cb2"] * wf["bw2"])
    w = base + wf["dt_s"] * dW
    u0 = wf["c00"] * u[0] + wf["c01"] * u[1]
    v0 = wf["c00"] * v[0] + wf["c01"] * v[1]
    w[0] = -(wf["cax0"] * u0 + wf["cbx0"] * v0) / wf["cxx0"]
    return w


def dss_uvw_plain(u, v, imult, rot, links, p: int, w_finish,
                  wrap=(False, False), noflux=(False, False), halo=None):
    """Plain PyTorch version of ``dss_uvw``: the W finish, then the vector
    DSS of (U, V) and the scalar DSS of W; ``halo``: None, ``ZERO_HALO`` or
    (U's, V's, W's)."""
    w = w_finish_plain(u, v, w_finish)
    uo, vo = dss_vector_plain(u, v, imult, rot, links, p, wrap, noflux,
                              None if halo is None else (
                                  _halo_part(halo, 0), _halo_part(halo, 1)))
    return uo, vo, dss_scalar_plain(w, imult, links, p, wrap, noflux,
                                    _halo_part(halo, 2))


STATE_FIELDS = ("U", "V", "Rt", "Rho", "W")


def dss_scalar2_plain(f1, f2, imult, links, p: int, wrap=(False, False),
                      noflux=(False, False), halo=None):
    """Plain PyTorch version of ``dss_scalar2``: two scalar DSS; ``halo``:
    None, ``ZERO_HALO`` or (f1's, f2's)."""
    return (dss_scalar_plain(f1, imult, links, p, wrap, noflux,
                             _halo_part(halo, 0)),
            dss_scalar_plain(f2, imult, links, p, wrap, noflux,
                             _halo_part(halo, 1)))


def _state_halo(halo, k):
    return halo if halo is None or halo is ZERO_HALO else halo[k]


def dss_state_plain(d, imult, rot, links, p: int, rayleigh=None,
                    wrap=(False, False), noflux=(False, False), halo=None,
                    walls_out=False):
    """Plain PyTorch version of ``dss_state``: the vector DSS of (U, V), the
    scalar DSS of Rt, Rho and W (each averaged with its halo at the no-flux
    walls: ``halo`` None, ``ZERO_HALO`` or a dict of wall rows a field),
    then ``fac * x + ref`` per field where ``rayleigh = (fac, ref)`` (two
    state dicts) is given.  ``walls_out``: also return the wall rows of
    each field before the finish, ``(out, walls)``."""
    h = (lambda k: _state_halo(halo, k))
    u, v = dss_vector_plain(d["U"], d["V"], imult, rot, links, p, wrap,
                            noflux, None if halo is None else (h("U"),
                                                               h("V")))
    out = {"U": u, "V": v}
    for k in ("Rt", "Rho", "W"):
        out[k] = dss_scalar_plain(d[k], imult, links, p, wrap, noflux, h(k))
    walls = {k: wall_rows(out[k], noflux) for k in STATE_FIELDS} \
        if walls_out else None
    if rayleigh is not None:
        fac, ref = rayleigh
        out = {k: fac[k] * out[k] + ref[k] for k in STATE_FIELDS}
    return (out, walls) if walls_out else out


# ---------------------------------------------------------------------------
# launch shape of the band kernel (dss_scalar, dss_vector, dss_uvw,
# dss_scalar2, dss_state)
# ---------------------------------------------------------------------------

SMS = 132                  # streaming multiprocessors of an H100 SXM
SMEM_MAX = 232448          # shared memory a block can have
MAX_THREADS = 512          # the kernels' __launch_bounds__
MAX_P = 16                 # most nodes an element row (generic instantiation)
BAR_BYTES = 64             # the ring's mbarriers
MAX_RING = 4
# the band kernel's modes, in the order of its M_SCALAR, M_VECTOR, M_UVW,
# M_SCALAR2, M_STATE, and the fields a stage of each holds: dss_scalar,
# dss_vector (U, V), dss_uvw (U, V and three W inputs), dss_scalar2 (two
# scalars), dss_state (U, V, Rt, Rho, W)
MODES = ("scalar", "vector", "uvw", "scalar2", "state")
NFIELDS = {"scalar": 1, "vector": 2, "uvw": 5, "scalar2": 2, "state": 5}
ROTATES = ("vector", "uvw", "state")   # the modes that stage edge rotations
# the modes with a step beyond K levels, a run of its own: dss_uvw's bottom
# interface, dss_state's top interface of W
EXTRA_RUN = ("uvw", "state")
# the rule's targets by (mode, bytes a value), fitted to the sweeps of
# kernels/tune_dss.py on an H100: segments a block at most, blocks a launch
# at least when the band is chosen, and (where it differs) when the levels
# a block are: the float32 vector mode was fastest at the flagship with
# runs of 5 levels (216 blocks, 1.6 an SM), and on the plane with runs of 3;
# the float32 scalar2 mode with bands of 24 rows and runs of 4 (240 blocks),
# 8 % ahead of the vector mode's shape, and with runs of 2 on the plane; the
# state mode (five staged fields, at most 128 registers a thread) with
# shallower bands in runs of one level and one stage at the flagship (f32:
# 20 rows, 1116 blocks, 17 % ahead of the uvw mode's targets; f64: 8 rows)
# and with runs of 2 on the float32 plane (PERF.md section 6)
SEGMENTS = {("scalar", 4): 640, ("scalar", 8): 240, ("vector", 4): 640,
            ("vector", 8): 240, ("uvw", 4): 720, ("uvw", 8): 720,
            ("scalar2", 4): 720, ("scalar2", 8): 240, ("state", 4): 600,
            ("state", 8): 240}
TARGET_BLOCKS = {("scalar", 4): 330, ("scalar", 8): 450, ("vector", 4): 330,
                 ("vector", 8): 450, ("uvw", 4): 450, ("uvw", 8): 600,
                 ("scalar2", 4): 330, ("scalar2", 8): 450, ("state", 4): 1000,
                 ("state", 8): 1000}
RUN_BLOCKS = {("vector", 4): 216, ("scalar2", 4): 240, ("state", 4): 600,
              ("state", 8): 2000}


class DssLaunch(NamedTuple):
    """Launch shape of a band kernel: a block owns ``rows`` whole rows of
    one panel (a multiple of p dividing A) and walks ``levels`` steps
    (levels; ``dss_uvw``'s bottom interface and ``dss_state``'s top
    interface of W are a run of their own) with ``threads`` threads and a
    ring of ``ring`` stages in ``smem`` bytes of shared memory; ``blocks``
    blocks in all."""
    rows: int
    levels: int
    threads: int
    ring: int
    smem: int
    blocks: int


def dss_smem_bytes(rows: int, A: int, B: int, ring: int, mode: str,
                   esize: int, links: bool) -> int:
    """Shared memory of a band kernel's block in ``mode``, as
    ``csrc/dss.cu`` lays it out: the mbarriers, then ``ring`` stages of the
    mode's field slots (the span of rows + 2 rows of B values, then on the
    cubed sphere the neighbours' edge lines, 2 (rows + 2) + 2 A values), for
    ``dss_uvw`` one slot more for the assembled W, the band's inverse
    multiplicities (rows B values), and on the cubed sphere the (U, V)
    pair's edge rotations (``dss_vector``, ``dss_uvw`` and ``dss_state``: 4
    per edge-line value); each part rounded up to 16 bytes."""
    nfields = NFIELDS[mode]
    v16 = 16 // esize

    def up(n):
        return -(-n // v16) * v16

    nedge = 2 * (rows + 2) + 2 * A if links else 0
    fs = up((rows + 2) * B) + up(nedge)
    vals = (ring * nfields + (mode == "uvw")) * fs \
        + up(rows * B) + (up(4 * nedge) if mode in ROTATES else 0)
    return BAR_BYTES + vals * esize


@functools.lru_cache(maxsize=None)
def dss_launch_shape(K: int, P: int, A: int, B: int, p: int, dtype,
                     mode: str, rows=None, levels=None, ring=None,
                     threads=None, links=None) -> DssLaunch:
    """The launch shape of the band kernel in ``mode`` (``MODES``):
    ``dss_scalar``, ``dss_vector`` or ``dss_scalar2`` (``K`` levels), or
    ``dss_uvw`` and ``dss_state`` (``K`` levels of U and V, K + 1 steps, the
    extra one a run of its own).
    ``links``: a cubed-sphere grid (default: P > 1).  The keywords override
    the rule (``kernels/tune_dss.py`` sweeps them).  Cached: a launch
    asks for its shape on the host every time.

    The rule: the deepest band (fewest halo rows) of at most ``SEGMENTS``
    segments (p nodes of a row; a thread each, up to 512 threads, more in
    turn) that still gives ``TARGET_BLOCKS`` blocks one step a block (the
    shallowest band where none does), a ring of two stages (one where two
    do not fit a scalar's block), and as many steps a block as keep
    ``RUN_BLOCKS`` (default ``TARGET_BLOCKS``) blocks, at least one; the
    state mode stages no more steps ahead than a run walks (one stage for
    runs of one level).  Raises where no shape fits."""
    esize = 4 if dtype == torch.float32 else 8
    links = P > 1 if links is None else bool(links)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    uvw = mode == "uvw"
    extra = mode in EXTRA_RUN
    if p < 2 or p > MAX_P or A % p or B % p:
        raise ValueError(f"the band kernels take 2 <= p <= {MAX_P} with "
                         f"whole elements, got A={A} B={B} p={p}")
    if P * A * B >= 2 ** 31:
        raise ValueError(f"field too large: P*A*B={P * A * B}")
    rings = [ring] if ring is not None else ([2] if uvw else [2, 1])

    def fitting_ring(TA):
        return next((r for r in rings if dss_smem_bytes(
            TA, A, B, r, mode, esize, links) <= SMEM_MAX), None)

    cands = [p * d for d in range(1, A // p + 1) if (A // p) % d == 0]
    cands = [TA for TA in cands if fitting_ring(TA) is not None
             and (rows is None or TA == rows)]
    if not cands:
        raise ValueError(f"no band of the DSS kernel fits A={A} B={B} p={p} "
                         f"mode={mode} rows={rows} ring={ring} in "
                         f"{SMEM_MAX} bytes of shared memory")
    key = (mode, esize)
    good = [TA for TA in cands if TA * (B // p) <= SEGMENTS[key]
            and (A // TA) * P * (K + extra) >= TARGET_BLOCKS[key]]
    TA = max(good) if good else min(cands)
    r = fitting_ring(TA)
    nseg = TA * (B // p)
    nt = int(threads) if threads is not None else \
        32 * math.ceil(nseg / math.ceil(nseg / MAX_THREADS) / 32)
    if not (32 <= nt <= MAX_THREADS and nt % 32 == 0):
        raise ValueError(f"threads must be a multiple of 32 up to "
                         f"{MAX_THREADS}, got {nt}")
    if not (2 if uvw else 1) <= r <= MAX_RING:
        raise ValueError(f"ring depth {r} out of range")
    bands = (A // TA) * P
    if levels is None:
        least = RUN_BLOCKS.get(key, TARGET_BLOCKS[key])
        lv = max([1] + [c for c in range(1, max(K, 1) + 1)
                        if bands * (math.ceil(K / c) + extra) >= least])
    else:
        lv = int(levels)
        if lv < 1:
            raise ValueError(f"levels a block must be >= 1, got {lv}")
    lv = min(lv, max(K, 1))
    if mode == "state" and ring is None:
        r = min(r, lv)
    return DssLaunch(TA, lv, nt, r, dss_smem_bytes(TA, A, B, r, mode,
                                                   esize, links),
                     bands * (math.ceil(K / lv) + extra))


def copy_width(B: int, esize: int, ptrs) -> int:
    """Bytes a staging copy of the band kernels moves at a time: 16 (bulk
    copies of whole spans) where a row of B values and every pointer of
    ``ptrs`` (ints; 0 for an absent one) are 16-byte multiples, else 8
    (``cp.async``) where they are 8-byte multiples, else one value."""
    for nbytes in (16, 8):
        if nbytes >= esize and (B * esize) % nbytes == 0 \
                and all(q % nbytes == 0 for q in ptrs):
            return nbytes
    return esize


def launch_config(f, p: int, mode: str, ptrs, links: bool,
                  launch=None) -> dict:
    """What a band kernel launch in ``mode`` on the field ``f`` ((K, P, A,
    B); for ``dss_vector``, ``dss_uvw`` and ``dss_state`` U, for
    ``dss_scalar2`` the first field) takes: its launch shape (``launch``,
    default the rule's) and its copy width for the pointers ``ptrs``."""
    K, P, A, B = f.shape
    sh = launch or dss_launch_shape(K, P, A, B, p, f.dtype, mode,
                                    links=links)
    return dict(sh._asdict(), copy=copy_width(B, f.element_size(), ptrs))


# band_kernel<T, CART, PP, M> as nvcc mangles it; M indexes MODES
_ENTRY = re.compile(r"band_kernelI([fd])Lb([01])ELi(\d+)ELi(\d)E")


def kernel_resources() -> dict:
    """Registers and spill bytes of the band kernel's 40 instantiations
    (value type x mode x grid family x p 4 or any p) as ``nvcc -Xptxas -v``
    reported them at the build, keyed ``f32 vector sphere p4``, ``f64 uvw
    cart generic``, ... (empty before a build)."""
    out = {}
    for name, use in build.ptxas_usage("dss").items():
        m = _ENTRY.search(name)
        if m:
            out[f"{'f32' if m.group(1) == 'f' else 'f64'} "
                f"{MODES[int(m.group(4))]} "
                f"{'cart' if m.group(2) == '1' else 'sphere'} "
                f"{'p4' if m.group(3) == '4' else 'generic'}"] = use
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def link_table(links, npanels: int = 6) -> np.ndarray:
    """Per-(panel, edge) lookup of the link list: an int32 ``(npanels*4, 4)``
    array of (neighbour panel, neighbour edge, flip, link index).  Raises
    unless every (panel, edge) is the destination of exactly one link.  A
    grid without links (Cartesian) has the empty ``(0, 4)`` table."""
    if not links:
        return np.zeros((0, 4), np.int32)
    table = np.full((npanels * 4, 4), -1, np.int32)
    for i, (pa, e, qa, qe, flip) in enumerate(links):
        row = pa * 4 + e
        if table[row, 0] != -1:
            raise ValueError(f"two links end on panel {pa} edge {e}")
        table[row] = (qa, qe, int(bool(flip)), i)
    if (table < 0).any():
        raise ValueError("a panel edge has no link")
    return table


def edge_rotations(geom) -> np.ndarray:
    """The vector modes' edge rotations of a cubed-sphere geometry: a float64
    ``(4, n_links, A)`` array, row ``2 * i + j`` of link ``l`` the ``(i, j)``
    entry of the 2x2 covariant transform at each node of the destination
    edge of ``geom.edge_meta[l]``."""
    mats = np.asarray(geom.edge_mats, np.float64)     # (6, 4, A, 2, 2)
    A = mats.shape[2]
    rot = np.zeros((4, len(geom.edge_meta), A), np.float64)
    for i, (pa, e, qa, qe, flip) in enumerate(geom.edge_meta):
        rot[:, i] = mats[pa, e].reshape(A, 4).T
    return rot


def _check_field(name, f, ref=None):
    if f.dim() != 4:
        raise ValueError(f"{name} must be (K, P, A, B), got {tuple(f.shape)}")
    if f.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {f.dtype} is not float32/float64")
    if not f.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if ref is not None and (f.shape != ref.shape or f.dtype != ref.dtype
                            or f.device != ref.device):
        raise ValueError(f"{name} does not match the first field")


def _check_common(f, imult, links, p, wrap, table, noflux=(False, False)):
    """Raises on what the kernels do not take.  Returns ``(table, flags)``:
    the device link table (made when absent; checked on CUDA only) and the
    wrap bits of the kernels (1: along a, 2: along b) with the no-flux
    walls' (4: along a, 8: along b)."""
    K, P, A, B = f.shape
    if len(wrap) != 2 or len(noflux) != 2:
        raise ValueError(f"wrap and noflux must name the two axes, got "
                         f"{wrap}, {noflux}")
    flags = int(bool(wrap[0])) | 2 * int(bool(wrap[1]))
    nf = int(bool(noflux[0])) | 2 * int(bool(noflux[1]))
    if nf:
        if links or P != 1 or nf == 3 or nf & flags:
            raise ValueError(f"no-flux walls are for a Cartesian grid, "
                             f"along one axis that does not wrap: noflux "
                             f"{noflux}, wrap {wrap}")
        flags |= 4 * nf
    if p < 2 or A % p != 0 or B % p != 0:
        raise ValueError(f"panels must hold whole elements of p >= 2 nodes, "
                         f"got A={A} B={B} p={p}")
    if K > 5 * 65535 or P > 65535 or A * B >= 2 ** 31:
        raise ValueError(f"field too large for the kernel's grid: "
                         f"K={K}, P={P}, A*B={A * B}")
    if links:
        if len(links) != 4 * P:
            raise ValueError(f"{len(links)} links for {P} panels")
        if A != B:
            raise ValueError(f"panels with edge links must be square, got "
                             f"A={A} B={B}")
        if flags:
            raise ValueError("the periodic wrap is for a grid without edge "
                             "links")
    elif P != 1:
        raise ValueError(f"a grid without edge links has one panel, got {P}")
    if tuple(imult.shape) != (P, A, B) or imult.dtype != f.dtype \
            or imult.device != f.device or not imult.is_contiguous():
        raise ValueError("inv_mult must be a contiguous (P, A, B) tensor of "
                         "the field's dtype and device")
    if f.device.type == "cuda":
        if table is None:
            table = torch.as_tensor(link_table(links, P), device=f.device)
        rows = 4 * P if links else 0
        if tuple(table.shape) != (rows, 4) or table.dtype != torch.int32 \
                or table.device != f.device or not table.is_contiguous():
            raise ValueError(f"link table must be a contiguous int32 "
                             f"({rows}, 4) tensor on the field's device")
    return table, flags


def _check_halo(halo, outs, noflux):
    """``halo`` against the outputs it pairs with (``outs``: their shapes
    (K, P, A, B) in a mode's order, ``halo`` a sequence of as many wall-row
    tensors, or None, or ``ZERO_HALO``)."""
    if halo is None or halo is ZERO_HALO or not any(noflux):
        return
    if len(halo) != len(outs):
        raise ValueError(f"halo: {len(outs)} fields, got {len(halo)}")
    for h, (ref, shape) in zip(halo, outs):
        K, P, A, B = shape
        want = (K, 2, B if noflux[0] else A)
        if tuple(h.shape) != want or h.dtype != ref.dtype \
                or h.device != ref.device or not h.is_contiguous():
            raise ValueError(f"a halo's wall rows must be a contiguous "
                             f"{want} tensor of the field's dtype and device, "
                             f"got {tuple(h.shape)}")


def _walls_arg(flags, halo, hout=()):
    """The kernels' ``walls`` argument: None without no-flux walls, else
    the 10 pointers (the halo of each output, None for the zero halo; then
    ``hout``).  Returns ``(array, keep)``: keep the tensors alive."""
    if not flags & 12:
        return None, ()
    hs = [None] * 5 if halo is ZERO_HALO else list(halo)
    hs += [None] * (5 - len(hs))
    ho = list(hout) + [None] * (5 - len(hout))
    arr = (ctypes.c_void_p * 10)(
        *[None if t is None else t.data_ptr() for t in hs + ho])
    return arr, (hs, ho)


def _check_rot(rot, links, u):
    """``rot``: (4, nlinks, A); a grid without links has a one-link dummy."""
    if tuple(rot.shape) != (4, max(len(links), 1), u.shape[2]) \
            or rot.dtype != u.dtype or rot.device != u.device \
            or not rot.is_contiguous():
        raise ValueError("rot must be a contiguous (4, nlinks, A) tensor of "
                         "the fields' dtype and device")


def dss_scalar(f, imult, links, p: int, wrap=(False, False), table=None,
               noflux=(False, False), halo=None):
    """DSS of a scalar (K, P, A, B) field; one kernel launch.

    ``table``: the device copy of ``link_table(links)`` (built once with the
    geometry; made on the fly when absent).  ``noflux``, ``halo``: the
    no-flux walls (module note; ``halo`` one wall-row tensor)."""
    _check_field("f", f)
    table, flags = _check_common(f, imult, links, p, wrap, table,
                                 noflux if halo is not None else (0, 0))
    hs = None if halo is None or halo is ZERO_HALO else (halo,)
    _check_halo(hs, [(f, f.shape)], noflux)
    if f.device.type == "cpu":
        return dss_scalar_plain(f, imult, links, p, wrap, noflux, halo)
    if f.device.type != "cuda":
        raise ValueError(f"unsupported device {f.device}")
    return _dss_scalar_cuda(f, imult, links, p, flags,
                            halo=halo if hs is None else hs)


def _scalar_ptrs(f, imult):
    """The pointers a ``dss_scalar`` launch stages from."""
    return [f.data_ptr(), imult.data_ptr()]


@functools.lru_cache(maxsize=None)
def _host_table(links):
    """The link table on the host (the band kernels take it by value), kept
    for the life of the process; None without links."""
    return np.ascontiguousarray(link_table(links)) if links else None


def _table_ptr(links):
    table = _host_table(tuple(map(tuple, links)))
    return None if table is None else table.ctypes.data


def _dss_scalar_cuda(f, imult, links, p, flags, launch=None, halo=None):
    """The launch of ``dss_scalar``; ``launch``: a ``DssLaunch`` in place
    of the rule's; ``halo``: ``ZERO_HALO`` or a one-tensor tuple where the
    no-flux bits of ``flags`` are set."""
    K, P, A, B = f.shape
    nlinks = len(links)
    cfg = launch_config(f, p, "scalar", _scalar_ptrs(f, imult),
                        nlinks > 0, launch)
    lib = build.library("dss")
    fn = lib.dss_scalar_f32 if f.dtype == torch.float32 else lib.dss_scalar_f64
    walls, _keep = _walls_arg(flags, halo)
    with torch.cuda.device(f.device):
        out = torch.empty_like(f)
        err = fn(f.data_ptr(), imult.data_ptr(), _table_ptr(links),
                 out.data_ptr(), K, P, A, B, p, nlinks, flags, cfg["rows"],
                 cfg["levels"], cfg["threads"], cfg["ring"], cfg["copy"],
                 walls, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dss_scalar kernel launch failed (error {err}; "
                           f"-1: launch shape or copy width not taken, -2: "
                           f"shared memory; launch {cfg})")
    launch_counts["dss_scalar"] += 1
    return out


def dss_vector(u, v, imult, rot, links, p: int, wrap=(False, False),
               table=None, noflux=(False, False), halo=None):
    """DSS of a covariant vector pair (K, P, A, B) x 2; one kernel launch.
    ``table``: as ``dss_scalar``'s; ``halo``: None, ``ZERO_HALO`` or (U's,
    V's) wall rows."""
    _check_field("u", u)
    _check_field("v", v, ref=u)
    table, flags = _check_common(u, imult, links, p, wrap, table,
                                 noflux if halo is not None else (0, 0))
    _check_halo(halo, [(u, u.shape)] * 2, noflux)
    _check_rot(rot, links, u)
    if u.device.type == "cpu":
        return dss_vector_plain(u, v, imult, rot, links, p, wrap, noflux,
                                halo)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    return _dss_vector_cuda(u, v, imult, rot, links, p, flags, halo=halo)


def _vector_ptrs(u, v, imult):
    """The pointers a ``dss_vector`` launch stages from (the rotations go
    by one value a copy)."""
    return [u.data_ptr(), v.data_ptr(), imult.data_ptr()]


def _dss_vector_cuda(u, v, imult, rot, links, p, flags, launch=None,
                     halo=None):
    """The launch of ``dss_vector``; ``launch``: a ``DssLaunch`` in place
    of the rule's; ``halo``: as ``dss_vector``'s."""
    K, P, A, B = u.shape
    nlinks = len(links)
    cfg = launch_config(u, p, "vector", _vector_ptrs(u, v, imult),
                        nlinks > 0, launch)
    lib = build.library("dss")
    fn = lib.dss_vector_f32 if u.dtype == torch.float32 else lib.dss_vector_f64
    walls, _keep = _walls_arg(flags, halo)
    with torch.cuda.device(u.device):
        uo = torch.empty_like(u)
        vo = torch.empty_like(v)
        err = fn(u.data_ptr(), v.data_ptr(), imult.data_ptr(),
                 rot.data_ptr(), _table_ptr(links), uo.data_ptr(),
                 vo.data_ptr(), K, P, A, B, p, nlinks, flags, cfg["rows"],
                 cfg["levels"], cfg["threads"], cfg["ring"], cfg["copy"],
                 walls, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dss_vector kernel launch failed (error {err}; "
                           f"-1: launch shape or copy width not taken, -2: "
                           f"shared memory; launch {cfg})")
    launch_counts["dss_vector"] += 1
    return uo, vo


def _check_w_finish(wf, u):
    K, P, A, B = u.shape
    for key in ("bw1", "dW"):
        _check_field(key, wf[key])
    bw2 = wf.get("bw2")
    fields = [wf["bw1"], wf["dW"]] + ([] if bw2 is None else [bw2])
    if bw2 is not None:
        _check_field("bw2", bw2)
    for f in fields:
        if tuple(f.shape) != (K + 1, P, A, B) or f.dtype != u.dtype \
                or f.device != u.device:
            raise ValueError("bw1, bw2 and dW must be (K+1, P, A, B) tensors "
                             "of the fields' dtype and device")
    for key in ("cax0", "cbx0", "cxx0"):
        m = wf[key]
        if tuple(m.shape) != (P, A, B) or m.dtype != u.dtype \
                or m.device != u.device or not m.is_contiguous():
            raise ValueError(f"{key} must be a contiguous (P, A, B) tensor "
                             f"of the fields' dtype and device")
    if K < 2:
        raise ValueError("the bottom row reads levels 0 and 1: K >= 2")


def dss_uvw(u, v, imult, rot, links, p: int, w_finish, wrap=(False, False),
            table=None, noflux=(False, False), halo=None):
    """DSS of (U, V, W) in one kernel launch with the W stage finish folded
    in; returns ``(u, v, w)``.  ``w_finish``: see ``w_finish_plain``;
    ``halo``: None, ``ZERO_HALO`` or (U's, V's, W's) wall rows."""
    _check_field("u", u)
    _check_field("v", v, ref=u)
    table, flags = _check_common(u, imult, links, p, wrap, table,
                                 noflux if halo is not None else (0, 0))
    K, P, A, B = u.shape
    _check_halo(halo, [(u, u.shape)] * 2 + [(u, (K + 1, P, A, B))], noflux)
    _check_rot(rot, links, u)
    _check_w_finish(w_finish, u)
    if u.device.type == "cpu":
        return dss_uvw_plain(u, v, imult, rot, links, p, w_finish, wrap,
                             noflux, halo)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    return _dss_uvw_cuda(u, v, imult, rot, links, p, flags, w_finish,
                         halo=halo)


def _uvw_ptrs(u, v, wf, imult):
    """The pointers a ``dss_uvw`` launch stages from."""
    bw2 = wf.get("bw2")
    return [u.data_ptr(), v.data_ptr(), imult.data_ptr(),
            wf["bw1"].data_ptr(), 0 if bw2 is None else bw2.data_ptr(),
            wf["dW"].data_ptr(),
            wf["cax0"].data_ptr(), wf["cbx0"].data_ptr(),
            wf["cxx0"].data_ptr()]


def _dss_uvw_cuda(u, v, imult, rot, links, p, flags, wf, launch=None,
                  halo=None):
    """The launch of ``dss_uvw``; ``launch``: a ``DssLaunch`` in place of
    the rule's; ``halo``: as ``dss_uvw``'s."""
    K, P, A, B = u.shape
    nlinks = len(links)
    bw2 = wf.get("bw2")
    cfg = launch_config(u, p, "uvw", _uvw_ptrs(u, v, wf, imult),
                        nlinks > 0, launch)
    lib = build.library("dss")
    fn = lib.dss_uvw_f32 if u.dtype == torch.float32 else lib.dss_uvw_f64
    walls, _keep = _walls_arg(flags, halo)
    with torch.cuda.device(u.device):
        uo = torch.empty_like(u)
        vo = torch.empty_like(v)
        wo = torch.empty_like(wf["dW"])
        err = fn(u.data_ptr(), v.data_ptr(), wf["bw1"].data_ptr(),
                 None if bw2 is None else bw2.data_ptr(),
                 wf["dW"].data_ptr(), wf["cax0"].data_ptr(),
                 wf["cbx0"].data_ptr(), wf["cxx0"].data_ptr(),
                 imult.data_ptr(), rot.data_ptr(), _table_ptr(links),
                 uo.data_ptr(), vo.data_ptr(), wo.data_ptr(),
                 float(wf["dt_s"]), float(wf.get("cb1", 1.0)),
                 float(wf.get("cb2", 0.0)), float(wf["c00"]),
                 float(wf["c01"]), K, P, A, B, p, nlinks, flags, cfg["rows"],
                 cfg["levels"], cfg["threads"], cfg["ring"], cfg["copy"],
                 walls, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dss_uvw kernel launch failed (error {err}; "
                           f"-1: launch shape or copy width not taken, -2: "
                           f"shared memory; launch {cfg})")
    launch_counts["dss_uvw"] += 1
    return uo, vo, wo


def dss_scalar2(f1, f2, imult, links, p: int, wrap=(False, False),
                table=None, noflux=(False, False), halo=None):
    """DSS of two scalar (K, P, A, B) fields of one shape; one kernel
    launch.  Returns ``(out1, out2)``, equal to two ``dss_scalar`` calls.
    ``halo``: None, ``ZERO_HALO`` or (f1's, f2's) wall rows."""
    _check_field("f1", f1)
    _check_field("f2", f2, ref=f1)
    table, flags = _check_common(f1, imult, links, p, wrap, table,
                                 noflux if halo is not None else (0, 0))
    _check_halo(halo, [(f1, f1.shape)] * 2, noflux)
    if f1.device.type == "cpu":
        return dss_scalar2_plain(f1, f2, imult, links, p, wrap, noflux, halo)
    if f1.device.type != "cuda":
        raise ValueError(f"unsupported device {f1.device}")
    return _dss_scalar2_cuda(f1, f2, imult, links, p, flags, halo=halo)


def _scalar2_ptrs(f1, f2, imult):
    """The pointers a ``dss_scalar2`` launch stages from."""
    return [f1.data_ptr(), f2.data_ptr(), imult.data_ptr()]


def _dss_scalar2_cuda(f1, f2, imult, links, p, flags, launch=None,
                      halo=None):
    """The launch of ``dss_scalar2``; ``launch``: a ``DssLaunch`` in place
    of the rule's; ``halo``: as ``dss_scalar2``'s."""
    K, P, A, B = f1.shape
    nlinks = len(links)
    cfg = launch_config(f1, p, "scalar2", _scalar2_ptrs(f1, f2, imult),
                        nlinks > 0, launch)
    lib = build.library("dss")
    fn = lib.dss_scalar2_f32 if f1.dtype == torch.float32 \
        else lib.dss_scalar2_f64
    walls, _keep = _walls_arg(flags, halo)
    with torch.cuda.device(f1.device):
        o1 = torch.empty_like(f1)
        o2 = torch.empty_like(f2)
        err = fn(f1.data_ptr(), f2.data_ptr(), imult.data_ptr(),
                 _table_ptr(links), o1.data_ptr(), o2.data_ptr(), K, P, A, B,
                 p, nlinks, flags, cfg["rows"], cfg["levels"],
                 cfg["threads"], cfg["ring"], cfg["copy"], walls,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dss_scalar2 kernel launch failed (error {err}; "
                           f"-1: launch shape or copy width not taken, -2: "
                           f"shared memory; launch {cfg})")
    launch_counts["dss_scalar2"] += 1
    return o1, o2


def _check_state(name, d, u):
    K, P, A, B = u.shape
    for k in STATE_FIELDS:
        rows = K + 1 if k == "W" else K
        _check_field(f"{name}[{k!r}]", d[k])
        if tuple(d[k].shape) != (rows, P, A, B) or d[k].dtype != u.dtype \
                or d[k].device != u.device:
            raise ValueError(f"{name}[{k!r}] must be a ({rows}, {P}, {A}, "
                             f"{B}) tensor of the state's dtype and device")


def dss_state(d, imult, rot, links, p: int, rayleigh=None,
              wrap=(False, False), table=None, noflux=(False, False),
              halo=None, walls_out=False):
    """DSS of the full fast state in one kernel launch (the band kernel's
    state mode).

    ``d``: dict of U, V, Rt, Rho ``(nz, P, A, B)`` and W ``(nz+1, P, A,
    B)``.  ``rayleigh``: optional ``(fac, ref_term)`` state dicts folded
    into the same launch (``x <- fac * x + ref`` after the DSS).  ``table``:
    as ``dss_scalar``'s.  Returns a dict of fresh tensors, equal to
    ``dss_vector`` plus three ``dss_scalar`` calls (and the plain Rayleigh
    finish).  ``halo``: None, ``ZERO_HALO`` or a dict of wall rows a field
    (the no-flux walls); ``walls_out`` (with a halo): also return the wall
    rows of each field before the finish, ``(out, walls)``."""
    u = d["U"]
    _check_field("d['U']", u)
    table, flags = _check_common(u, imult, links, p, wrap, table,
                                 noflux if halo is not None else (0, 0))
    _check_state("d", d, u)
    hs = None if halo is None or halo is ZERO_HALO else \
        [halo[k] for k in STATE_FIELDS]
    _check_halo(hs, [(d[k], d[k].shape) for k in STATE_FIELDS], noflux)
    if walls_out and not flags & 12:
        raise ValueError("walls_out needs a halo and a no-flux axis")
    _check_rot(rot, links, u)
    if rayleigh is not None:
        for i, part in enumerate(rayleigh):
            _check_state(f"rayleigh[{i}]", part, u)
    if u.device.type == "cpu":
        return dss_state_plain(d, imult, rot, links, p, rayleigh, wrap,
                               noflux, halo, walls_out)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    return _dss_state_cuda(d, imult, rot, links, p, flags, rayleigh,
                           halo=halo if hs is None else hs,
                           walls_out=walls_out)


def _state_ptrs(d, imult):
    """The pointers a ``dss_state`` launch stages from (the Rayleigh finish's
    fields are read at the stores, not staged)."""
    return [d[k].data_ptr() for k in STATE_FIELDS] + [imult.data_ptr()]


def _dss_state_cuda(d, imult, rot, links, p, flags, rayleigh, launch=None,
                    halo=None, walls_out=False):
    """The launch of ``dss_state``; ``launch``: a ``DssLaunch`` in place of
    the rule's; ``halo``: ``ZERO_HALO`` or the five fields' wall rows in
    ``STATE_FIELDS`` order where the no-flux bits of ``flags`` are set;
    ``walls_out``: also return the wall rows before the finish."""
    u = d["U"]
    K, P, A, B = u.shape
    nlinks = len(links)
    cfg = launch_config(u, p, "state", _state_ptrs(d, imult), nlinks > 0,
                        launch)
    lib = build.library("dss")
    fn = lib.dss_state_f32 if u.dtype == torch.float32 else lib.dss_state_f64
    with torch.cuda.device(u.device):
        outs = [torch.empty_like(d[k]) for k in STATE_FIELDS]
        ray = [None] * 10 if rayleigh is None else \
            [part[k] for part in rayleigh for k in STATE_FIELDS]
        tensors = [d[k] for k in STATE_FIELDS] + ray + outs
        ptrs = (ctypes.c_void_p * len(tensors))(
            *[None if t is None else t.data_ptr() for t in tensors])
        hout = []
        if walls_out:
            L = B if flags & 4 else A
            hout = [torch.empty((d[k].shape[0], 2, L), dtype=u.dtype,
                                device=u.device) for k in STATE_FIELDS]
        walls, _keep = _walls_arg(flags, halo, hout)
        err = fn(ptrs, imult.data_ptr(), rot.data_ptr(), _table_ptr(links),
                 K, P, A, B, p, nlinks, flags, cfg["rows"], cfg["levels"],
                 cfg["threads"], cfg["ring"], cfg["copy"], walls,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dss_state kernel launch failed (error {err}; "
                           f"-1: launch shape, copy width or finish not "
                           f"taken, -2: shared memory; launch {cfg})")
    launch_counts["dss_state"] += 1
    out = dict(zip(STATE_FIELDS, outs))
    return (out, dict(zip(STATE_FIELDS, hout))) if walls_out else out
