"""Edge shapes of ``banded_solve_multi`` and ``banded_solve``
(``ops/cuda_banded.py``, ``csrc/banded_multi.cu``), each held against the
plain version.

The moist wave's systems (n 30, q 1, R 3) leave parts of the kernel unrun:
two rows, bandwidths 2, 4 and 8 (wider than two rows), one and five
right-hand sides, one column, 31 columns (less than a tile), a partial last
tile, inputs one or two values past an aligned address (4- and 8-byte
copies in float32, 8-byte and bulk copies in float64), an odd column count
(rows that are no 8-byte multiple in float32), tiles of 64 columns, one
group of threads for three right-hand sides and two for five (a group
substituting more than one), a chunk of two rows an mbarrier (15 of
them), and the stream form: forced on a shape whose tile fits, with every
U row on chip and with the U rows of 7 rows rebuilt chunk by chunk, and
chosen by the rule where no tile of 32 columns fits a block (91 rows of q
8, R 5; 300 rows of q 8).  ``banded_solve``'s cases (``SOLVE_CASES``) do
the same for its ring form: two rows (with q up to 8, wider than the
matrix), q 1-8, one, 31 and 1000 columns (a partial last block), inputs one
or two values past an aligned address, an odd column count, blocks of 16
and 8 columns, fewer rows than the ring has slots, 300 rows of q 8 (the
rule's narrower blocks), and the forms it does not choose at these shapes
forced (tile, stream) or chosen by the rule where no block of U rows fits
(800 rows of q 8: the stream form), and pivots past both ends of the range
where the kernel takes a quotient from the pivot's reciprocal (in the ring
form and the tile form forced).  Inputs are
diagonally dominant systems with zeros outside the matrix and right-hand
sides of different size per species, seeded with numpy.  Used by
``chip_smoke.py``, the ``gpu`` tests, and the CPU tests that hold each
case's plain result against the JAX package's Pallas kernel; nothing on the
model's path imports this module.
"""

from __future__ import annotations

import numpy as np
import torch

# name -> n, q, R, ncol, values the inputs start past an aligned address,
# overrides of ``banded_multi_launch_shape``, the form the launch takes
CASES = {
    "moist_ragged": (30, 1, 3, 1000, 0, {}, "tile"),
    "n2_q1_r1": (2, 1, 1, 64, 0, {}, "tile"),
    "n30_q2_r3_ncol31": (30, 2, 3, 31, 0, {}, "tile"),
    "n30_q4_r5": (30, 4, 5, 257, 0, {}, "tile"),
    "n30_q8_r1_ncol1": (30, 8, 1, 1, 0, {}, "tile"),
    "n2_q8_r5": (2, 8, 5, 70, 0, {}, "tile"),
    "offset1": (30, 1, 3, 70, 1, {}, "tile"),
    "offset2": (30, 2, 3, 70, 2, {}, "tile"),
    "odd_ncol": (30, 1, 3, 37, 0, {}, "tile"),
    "cols64": (30, 1, 3, 200, 0, dict(cols=64), "tile"),
    "one_group": (30, 2, 3, 96, 0, dict(threads=32), "tile"),
    "two_groups": (30, 1, 5, 64, 0, dict(threads=64), "tile"),
    "chunk2": (30, 2, 3, 96, 0, dict(chunk=2), "tile"),
    "stream_forced": (30, 4, 5, 70, 0, dict(form="stream"), "stream"),
    "stream_chunks": (30, 2, 3, 70, 0, dict(form="stream", chunk=7),
                      "stream"),
    "stream_by_shape": (91, 8, 5, 33, 0, {}, "stream"),
    "stream_long": (300, 8, 3, 40, 0, {}, "stream"),
}


# name -> n, q, ncol, values the inputs start past an aligned address,
# overrides of ``banded_solve_launch_shape``, the form the launch takes
SOLVE_CASES = {
    "solve_flagship_ragged": (91, 4, 1000, 0, {}, "ring"),
    "solve_n2_q1": (2, 1, 64, 0, {}, "ring"),
    "solve_n2_q8": (2, 8, 70, 0, {}, "ring"),
    "solve_n30_q4": (30, 4, 257, 0, {}, "ring"),
    "solve_q3_ncol31": (30, 3, 31, 0, {}, "ring"),
    "solve_q5": (40, 5, 96, 0, {}, "ring"),
    "solve_q6": (25, 6, 33, 0, {}, "ring"),
    "solve_q7_ncol1": (17, 7, 1, 0, {}, "ring"),
    "solve_offset1": (30, 1, 70, 1, {}, "ring"),
    "solve_offset2": (30, 2, 70, 2, {}, "ring"),
    "solve_odd_ncol": (30, 1, 37, 0, {}, "ring"),
    "solve_cols16": (91, 4, 100, 0, dict(cols=16), "ring"),
    "solve_cols8": (30, 3, 50, 0, dict(cols=8), "ring"),
    "solve_n3_q2": (3, 2, 96, 0, {}, "ring"),
    "solve_long_q8": (300, 8, 40, 0, {}, "ring"),
    "solve_tile_forced": (30, 4, 70, 0, dict(form="tile"), "tile"),
    "solve_stream_forced": (30, 4, 70, 0, dict(form="stream"), "stream"),
    "solve_stream_by_shape": (800, 8, 40, 0, {}, "stream"),
    "solve_extreme_pivots": (30, 2, 70, 0, {}, "ring"),
    "solve_extreme_tile": (30, 3, 40, 0, dict(form="tile"), "tile"),
}

# ``banded_solve`` cases with pivots past the ends of the range where the
# kernel's quotients come from the pivot's reciprocal (csrc/banded_multi.cu:
# ``Range``), one tiny and one huge a dtype: rows 1, 5, 9, ... hold the
# tiny pivot alone on their row (the rows below divide by it: huge
# quotients), rows 3, 7, ... the huge one alone on their row and column;
# each such row's right-hand side is its pivot times 1 to 1.5.  No value is
# subnormal, so that the Pallas kernel on the CPU (which flushes them)
# solves the same systems.
EXTREME_PIVOTS = {torch.float32: (1.3 * 2.0 ** -125, 1.3 * 2.0 ** 126),
                  torch.float64: (1.3 * 2.0 ** -1021, 1.3 * 2.0 ** 1022)}


def _cut(a, offset, dtype, device):
    """numpy ``a`` as a contiguous tensor that starts ``offset`` values
    past an aligned address."""
    buf = torch.empty(a.size + offset, dtype=dtype, device=device)
    out = buf[offset:].view(a.shape)
    out.copy_(torch.as_tensor(a, dtype=dtype))
    return out


def systems(n, q, R, ncol, seed=0):
    """numpy (bands (n, 2q+1, ncol), rhs (n, R, ncol)): diagonally dominant
    banded systems with the entries outside the matrix zero, right-hand
    sides of different size per species (so a mix-up of them shows)."""
    rng = np.random.default_rng(seed)
    b = 2 * q + 1
    bands = rng.standard_normal((n, b, ncol))
    bands[:, q, :] += 2.0 * b
    rows = np.arange(n)
    for d in range(b):
        col = rows + d - q
        bands[(col < 0) | (col >= n), d, :] = 0.0
    rhs = rng.standard_normal((n, R, ncol)) * 10.0 ** -np.arange(
        R).reshape(1, R, 1)
    return bands, rhs


def case_inputs(name: str, dtype, device):
    """(bands, rhs, q) of case ``name``, each tensor starting the case's
    offset past an aligned address."""
    n, q, R, ncol, offset = CASES[name][:5]
    bands, rhs = systems(n, q, R, ncol, seed=sum(map(ord, name)))
    return (_cut(bands, offset, dtype, device),
            _cut(rhs, offset, dtype, device), q)


def solve_inputs(name: str, dtype, device):
    """(bands, rhs (n, ncol), q) of ``banded_solve`` case ``name``, each
    tensor starting the case's offset past an aligned address."""
    n, q, ncol, offset = SOLVE_CASES[name][:4]
    bands, rhs = systems(n, q, 1, ncol, seed=sum(map(ord, name)))
    if name.startswith("solve_extreme"):
        tiny, huge = EXTREME_PIVOTS[dtype]
        scale = 1.0 + np.abs(rhs[:, 0]) / 8.0
        for k in range(1, n, 2):
            pivot = tiny if k % 4 == 1 else huge
            bands[k] = 0.0
            bands[k, q] = pivot
            rhs[k, 0] = pivot * np.minimum(scale[k], 1.5)
            if pivot == huge:      # alone on its column too
                for d in range(1, q + 1):
                    if k + d < n:
                        bands[k + d, q - d] = 0.0
                    if k - d >= 0:
                        bands[k - d, q + d] = 0.0
    return (_cut(bands, offset, dtype, device),
            _cut(rhs[:, 0], offset, dtype, device), q)


def solve_launch_shape(name: str, dtype):
    """The ``MultiLaunch`` of ``banded_solve`` case ``name`` (the rule's
    with the case's overrides)."""
    from tempestmodel_tpu_torch.ops import cuda_banded
    n, q, ncol, _, over, _ = SOLVE_CASES[name]
    return cuda_banded.banded_solve_launch_shape(n, q, ncol, dtype, **over)


def run_solve_case(name: str, dtype, device) -> dict:
    """``banded_solve``'s kernel against the plain version for case
    ``name`` on ``device`` (a CUDA device): ``{"max_err": the relative
    error, "shape", "q", "launch": launch_config}``."""
    from tempestmodel_tpu_torch.ops import cuda_banded
    bands, rhs, q = solve_inputs(name, dtype, device)
    sh = solve_launch_shape(name, dtype)
    got = cuda_banded._banded_solve_cuda(bands, rhs, q, sh)
    torch.cuda.synchronize()
    want = cuda_banded.banded_solve_plain(bands, rhs, q)
    e = float((got - want).abs().max() / want.abs().max())
    return {"max_err": e if e == e else float("inf"),   # NaN is the worst
            "shape": list(bands.shape), "q": q,
            "launch": cuda_banded.launch_config(bands, rhs, q, sh)}


def launch_shape(name: str, dtype):
    """The ``MultiLaunch`` of case ``name`` (the rule's with the case's
    overrides)."""
    from tempestmodel_tpu_torch.ops import cuda_banded
    n, q, R, ncol, _, over, _ = CASES[name]
    return cuda_banded.banded_multi_launch_shape(n, q, R, ncol, dtype,
                                                 **over)


def run_case(name: str, dtype, device) -> dict:
    """The kernel against the plain version for case ``name`` on
    ``device`` (a CUDA device): ``{"max_err": the worst relative error of a
    species, "err_by_species", "shape", "launch": launch_config}``."""
    from tempestmodel_tpu_torch.ops import cuda_banded
    bands, rhs, q = case_inputs(name, dtype, device)
    sh = launch_shape(name, dtype)
    got = cuda_banded._banded_solve_multi_cuda(bands, rhs, q, sh)
    torch.cuda.synchronize()
    want = cuda_banded.banded_solve_multi_plain(bands, rhs, q)
    errs = []
    for r in range(rhs.shape[1]):
        e = float((got[:, r] - want[:, r]).abs().max()
                  / want[:, r].abs().max())
        errs.append(e if e == e else float("inf"))   # NaN is the worst
    return {"max_err": max(errs), "err_by_species": errs,
            "shape": list(rhs.shape), "q": q,
            "launch": cuda_banded.launch_config(bands, rhs, q, sh)}
