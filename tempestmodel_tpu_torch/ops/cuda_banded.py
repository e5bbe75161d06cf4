"""Batched no-pivot banded LU solve: the CUDA kernel's wrapper and its
plain version.

Counterpart of the JAX package's ``ops/pallas_banded.py``
(``banded_solve_pallas``, ``banded_solve_multi_pallas``).  One source,
``csrc/banded_multi.cu``, holds both, with the half-bandwidth as a template
parameter.  ``banded_solve_multi`` stages a tile of columns (every band and
right-hand-side row) in shared memory by asynchronous copies, eliminates
there one thread a column, substitutes the right-hand sides side by side (a
group of threads each) and keeps the U-factor and the forward solutions on
chip: its launch shape comes from ``banded_multi_launch_shape`` (the tile
form, or for shapes whose tile does not fit a block the stream form).
``banded_solve`` (one right-hand side) runs the same launcher in its ring
form: the band rows stream through a ring of shared-memory slots (each
lane copying its own column by ``cp.async``), the
forward value folds into the elimination, and only each row's U row and
forward value stay on chip for the back substitution; its launch shape comes
from ``banded_solve_launch_shape`` (the ring form, or for shapes whose U
rows do not fit a block the stream form).  Above 8 the template forms
are instantiated at q 10 and 16 only (``TEMPLATE_Q``: the Lorenz column
systems of vertical orders 2 and 3), and there they run where their block
fits; every other half-bandwidth above 8 (the Lorenz systems from vertical
order 4 on, the tracer systems from vertical order 5 on), and q 10 and 16
where the template block does not fit, takes the wide form in either
wrapper: q known at run time, the row being eliminated and the U rows of
the last ``chunk`` rows in shared memory (``wide_smem_bytes``).
Neither keeps scratch in device memory: a launch allocates its output
only.  The copy route of the tile
form comes from ``copy_width``.  See the notes in the source for the
designs and the bounds on the card.

Layout contract (that of ``models/vertical_banded.banded_solve_t``):
``bands (n, 2q+1, ncol)`` with ``band[i, d] = A[i, i+d-q]``, ``rhs
(n, ncol)``; out-of-range band entries must be zero.
``banded_solve_multi`` takes ``rhs (n, R, ncol)``: R right-hand sides that
share the band matrix of their column, eliminated once.

Either wrapper launches its kernel for CUDA tensors — or raises — and runs
the plain version only for tensors that lie on the CPU.
"""

from __future__ import annotations

import functools
import re
from typing import NamedTuple

import torch

from ..kernels import build
from ..kernels.counts import launch_counts
from ..models.vertical_banded import banded_solve_t, banded_solve_multi_t

MAX_Q = 8      # the tile, stream and ring forms are instantiated for
               # q = 1..8 and at TEMPLATE_Q; the wide form takes any q whose
               # rows fit a block
TEMPLATE_Q = tuple(range(1, MAX_Q + 1)) + (10, 16)

banded_solve_plain = banded_solve_t
banded_solve_multi_plain = banded_solve_multi_t


def _check(bands, rhs, q, multi=False):
    """What neither route takes; the kernel route's limit on q is its
    launch shape's (``banded_solve_launch_shape``)."""
    if not isinstance(q, int) or q < 1:
        raise ValueError(f"half-bandwidth q={q!r}: must be an int >= 1")
    if bands.dim() != 3 or rhs.dim() != (3 if multi else 2):
        raise ValueError("bands must be (n, 2q+1, ncol) and rhs "
                         + ("(n, R, ncol)" if multi else "(n, ncol)"))
    n, b, ncol = bands.shape
    if b != 2 * q + 1 or (rhs.shape[0], rhs.shape[-1]) != (n, ncol) \
            or rhs.shape[1] < 1:
        raise ValueError(f"bands {tuple(bands.shape)} / rhs "
                         f"{tuple(rhs.shape)} do not match q={q}")
    if bands.dtype not in (torch.float32, torch.float64) \
            or rhs.dtype != bands.dtype:
        raise TypeError(f"bands {bands.dtype} / rhs {rhs.dtype}: both must "
                        f"be float32 or both float64")
    if rhs.device != bands.device:
        raise ValueError(f"bands on {bands.device}, rhs on {rhs.device}")
    if not (bands.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("bands and rhs must be contiguous")


def banded_solve(bands, rhs, q: int):
    """Solve ``A x = rhs`` for every column; returns ``x (n, ncol)``."""
    _check(bands, rhs, q)
    if bands.device.type == "cpu":
        return banded_solve_plain(bands, rhs, q)
    if bands.device.type != "cuda":
        raise ValueError(f"unsupported device {bands.device}")
    return _banded_solve_cuda(bands, rhs, q)


def _banded_solve_cuda(bands, rhs, q, launch: "MultiLaunch" = None):
    """Launch the kernel; ``launch``: a ``MultiLaunch`` in place of the
    rule's (the tests and ``kernels/tune_fused.py`` force each form)."""
    n, _, ncol = bands.shape
    x = _launch(bands, rhs.view(n, 1, ncol), q,
                launch_config(bands, rhs, q, launch), "banded_solve")
    launch_counts["banded_solve"] += 1
    return x.view(n, ncol)


def banded_solve_multi(bands, rhs, q: int):
    """Solve ``A x_r = rhs[:, r]`` for every column and each of the R
    right-hand sides of ``rhs (n, R, ncol)``, which share the column's band
    matrix: one kernel launch, one elimination per column.  Returns
    ``x (n, R, ncol)``."""
    _check(bands, rhs, q, multi=True)
    if bands.device.type == "cpu":
        return banded_solve_multi_plain(bands, rhs, q)
    if bands.device.type != "cuda":
        raise ValueError(f"unsupported device {bands.device}")
    return _banded_solve_multi_cuda(bands, rhs, q)


# ---------------------------------------------------------------------------
# launch shape of banded_solve_multi
# ---------------------------------------------------------------------------

SMEM_MAX = 232448          # shared memory a block can have
MAX_THREADS = 256          # threads a block at most
MAX_BARS = 16              # the tile form's mbarriers
BAR_BYTES = 8 * MAX_BARS
COLS = 32                  # the rule's columns a block
CHUNK = 4                  # the rule's rows an mbarrier (tile form)
# the kernel's FORM_TILE, FORM_STREAM, FORM_RING, FORM_WIDE
FORMS = ("tile", "stream", "ring", "wide")
SOLVE_FORMS = ("ring", "stream", "tile", "wide")   # what banded_solve can
                                                   # run
RING_SLOTS = 5             # the ring form's slots (csrc: RING_SLOTS)
RING_COLS = (32, 16, 8)    # the ring and wide forms' columns a block (a
                           # block is one warp)
SM_SMEM = 233472           # shared memory of an SM ...
BLOCK_SMEM = 1024          # ... of which each resident block holds this more
MAX_BLOCKS_SM = 32         # resident blocks an SM at most


class MultiLaunch(NamedTuple):
    """Launch shape of ``banded_solve_multi`` and ``banded_solve``:
    ``form`` ``"tile"`` (every row of a tile of ``cols`` columns staged in
    shared memory, ``chunk`` rows an mbarrier; ``threads`` = ``cols`` x the
    groups of right-hand sides that are substituted side by side),
    ``"stream"`` (a thread a column, rows read as they are eliminated, the U
    rows of ``chunk`` rows kept in shared memory) or, for one right-hand
    side, ``"ring"`` (a warp a block, ``cols`` columns, the staged rows
    through a ring of ``chunk`` = ``RING_SLOTS`` slots, every U row and
    forward value kept in shared memory) or, for any q, ``"wide"`` (a warp
    a block, ``cols`` columns, q known at run time, the U rows of ``chunk``
    rows in shared memory); ``smem`` bytes of shared memory, ``blocks``
    blocks."""
    form: str
    cols: int
    threads: int
    chunk: int
    smem: int
    blocks: int


def tile_smem_bytes(n: int, q: int, R: int, cols: int, esize: int) -> int:
    """Shared memory of the tile form's block, as ``csrc/banded_multi.cu``
    lays it out: the mbarriers, then n (2q + 1 + R) rows of ``cols``
    values."""
    return BAR_BYTES + n * (2 * q + 1 + R) * cols * esize


def stream_smem_bytes(q: int, chunk: int, cols: int, esize: int) -> int:
    """Shared memory of the stream form's block: the U rows (q + 1 values)
    of ``chunk`` rows of ``cols`` columns."""
    return chunk * (q + 1) * cols * esize


def ring_smem_bytes(n: int, q: int, cols: int, esize: int) -> int:
    """Shared memory of the ring form's block: ``RING_SLOTS`` slots of
    2q + 2 staged rows (the band rows and the right-hand side), then the U
    row and forward value (q + 2 values) of each of the n rows, ``cols``
    values each."""
    return (RING_SLOTS * (2 * q + 2) + n * (q + 2)) * cols * esize


def wide_smem_bytes(q: int, chunk: int, cols: int, esize: int) -> int:
    """Shared memory of the wide form's block: the U rows (q + 1 values)
    of ``chunk`` rows and the row being eliminated (2q + 1 values), ``cols``
    values each."""
    return (chunk * (q + 1) + 2 * q + 1) * cols * esize


def wide_launch_shape(n: int, q: int, ncol: int, dtype, cols=None,
                      chunk=None) -> "MultiLaunch":
    """The wide form's launch shape (both wrappers; R does not change
    it).  The rule: the widest block of ``RING_COLS`` that keeps every U
    row on chip; where none does, the widest that keeps at least min(q, n)
    (the rows the elimination reads), with as many as fit, rebuilt chunk by
    chunk.  Raises, naming the limit, where q is too wide for any block."""
    esize = 4 if dtype == torch.float32 else 8
    if q < 1 or n < 1 or ncol < 1:
        raise ValueError(f"the wide form takes q >= 1, n >= 1, ncol >= 1: "
                         f"got n={n} q={q} ncol={ncol}")
    need = min(q, n)
    opts = []
    for C in RING_COLS if cols is None else (int(cols),):
        if C not in RING_COLS:
            raise ValueError(f"the wide form takes {RING_COLS} columns a "
                             f"block, got {C}")
        most = min(n, (SMEM_MAX // (C * esize) - (2 * q + 1)) // (q + 1))
        h = most if chunk is None else int(chunk)
        if need <= h <= most:
            opts.append((h == n, C, h))
    if not opts:
        raise ValueError(
            f"q={q} n={n}: the wide form needs the U rows of min(q, n) = "
            f"{need} rows on chip, {wide_smem_bytes(q, need, 8, esize)} "
            f"bytes at 8 columns a block, more than {SMEM_MAX}: it takes "
            f"q up to {wide_max_q(dtype)} in {dtype}")
    _, C, h = max(opts)
    blocks = -(-ncol // C)
    if blocks >= 2 ** 31:
        raise ValueError(f"too many columns: {ncol}")
    return MultiLaunch("wide", C, 32, h, wide_smem_bytes(q, h, C, esize),
                       blocks)


def wide_max_q(dtype) -> int:
    """The largest q the wide form takes (a block of 8 columns holding
    the U rows of q rows)."""
    esize = 4 if dtype == torch.float32 else 8
    q = 1
    while wide_smem_bytes(q + 1, q + 1, 8, esize) <= SMEM_MAX:
        q += 1
    return q


def blocks_per_sm(smem: int) -> int:
    """One-warp blocks of ``smem`` bytes of shared memory that one SM
    holds (at most ``MAX_BLOCKS_SM``)."""
    return min(MAX_BLOCKS_SM, SM_SMEM // (smem + BLOCK_SMEM))


@functools.lru_cache(maxsize=None)
def banded_solve_launch_shape(n: int, q: int, ncol: int, dtype, form=None,
                              cols=None) -> "MultiLaunch":
    """The launch shape of ``banded_solve`` for ``ncol`` systems of ``n``
    rows and half-bandwidth ``q``.  The keywords override the rule
    (``kernels/tune_fused.py banded solve`` sweeps them; ``form="tile"``
    or ``"stream"`` gives ``banded_multi_launch_shape``'s shape with R = 1).
    Cached: a launch asks for its shape on the host every time.

    The rule: the ring form with the columns of ``RING_COLS`` that keep the
    most columns on an SM (columns x blocks an SM; the wider block where
    two tie), among those whose block fits; where none fits, the stream
    form.  Above ``MAX_Q``: the ring form where the template forms have q
    (``TEMPLATE_Q``) and its block fits, else the wide form
    (``wide_launch_shape``; also with ``form="wide"``).  Raises where the
    shape asked for does not fit or the kernel does not take it."""
    esize = 4 if dtype == torch.float32 else 8
    ring_fits = any(ring_smem_bytes(n, q, C, esize) <= SMEM_MAX
                    for C in RING_COLS if cols is None or C == int(cols))
    if form == "wide" or (form is None and q > MAX_Q and (
            q not in TEMPLATE_Q or not ring_fits)):
        return wide_launch_shape(n, q, ncol, dtype, cols=cols)
    if q not in TEMPLATE_Q or n < 1 or ncol < 1:
        raise ValueError(f"banded_solve's {form or 'ring'} form takes q in "
                         f"1..{MAX_Q} or {TEMPLATE_Q[MAX_Q:]}, n >= 1, ncol "
                         f">= 1: got n={n} q={q} ncol={ncol}")
    if cols is not None and form in (None, "ring") \
            and int(cols) not in RING_COLS:
        raise ValueError(f"the ring form takes {RING_COLS} columns a block, "
                         f"got {cols}")
    fits = [C for C in RING_COLS if (cols is None or C == int(cols))
            and ring_smem_bytes(n, q, C, esize) <= SMEM_MAX]
    if form is None:
        form = "ring" if fits else "stream"
    if form in ("tile", "stream"):
        return banded_multi_launch_shape(n, q, 1, ncol, dtype, cols=cols,
                                         form=form)
    if form != "ring":
        raise ValueError(f"form must be one of {SOLVE_FORMS}, got {form!r}")
    if not fits:
        raise ValueError(f"the ring form of n={n} q={q} needs more than "
                         f"{SMEM_MAX} bytes of shared memory at "
                         f"{cols or min(RING_COLS)} columns a block")
    C = max(fits, key=lambda c: (c * blocks_per_sm(
        ring_smem_bytes(n, q, c, esize)), c))
    blocks = -(-ncol // C)
    if blocks >= 2 ** 31:
        raise ValueError(f"too many columns: {ncol}")
    return MultiLaunch("ring", C, 32, RING_SLOTS,
                       ring_smem_bytes(n, q, C, esize), blocks)


@functools.lru_cache(maxsize=None)
def banded_multi_launch_shape(n: int, q: int, R: int, ncol: int, dtype,
                              cols=None, form=None, chunk=None,
                              threads=None) -> MultiLaunch:
    """The launch shape of ``banded_solve_multi`` for ``ncol`` systems of
    ``n`` rows, half-bandwidth ``q`` and ``R`` right-hand sides.  The
    keywords override the rule (``kernels/tune_fused.py banded`` sweeps
    them).  Cached: a launch asks for its shape on the host every time.

    The rule: the tile form with ``COLS`` columns a block, ``CHUNK`` rows
    an mbarrier (more where n needs more than ``MAX_BARS``) and a group of
    ``COLS`` threads for each right-hand side (as many as ``MAX_THREADS``
    allows), where its tile fits a block's shared memory; else the stream
    form with ``COLS`` columns and as many U rows on chip as fit (all n
    where they do).  Above ``MAX_Q``: the tile form where the template
    forms have q (``TEMPLATE_Q``) and its tile fits, else the wide form
    (``wide_launch_shape``; also with ``form="wide"``).  Raises where the
    shape asked for does not fit or the kernel does not take it."""
    esize = 4 if dtype == torch.float32 else 8
    tile_fits = tile_smem_bytes(n, q, R, COLS if cols is None else int(cols),
                                esize) <= SMEM_MAX
    if R >= 1 and (form == "wide" or (form is None and q > MAX_Q and (
            q not in TEMPLATE_Q or not tile_fits))):
        return wide_launch_shape(n, q, ncol, dtype, cols=cols, chunk=chunk)
    if q not in TEMPLATE_Q or R < 1 or n < 1 or ncol < 1:
        raise ValueError(f"banded_solve_multi's {form or 'tile'} form takes "
                         f"q in 1..{MAX_Q} or {TEMPLATE_Q[MAX_Q:]}, R >= 1, "
                         f"n >= 1, ncol >= 1: got n={n} q={q} R={R} "
                         f"ncol={ncol}")
    C = COLS if cols is None else int(cols)
    if not (32 <= C <= MAX_THREADS and C % 32 == 0):
        raise ValueError(f"columns a block must be a multiple of 32 up to "
                         f"{MAX_THREADS}, got {C}")
    blocks = -(-ncol // C)
    if blocks >= 2 ** 31:
        raise ValueError(f"too many columns: {ncol}")
    if form is None:
        form = "tile" if tile_smem_bytes(n, q, R, C, esize) <= SMEM_MAX \
            else "stream"
    if form == "tile":
        nt = C * min(R, MAX_THREADS // C) if threads is None else int(threads)
        h = max(CHUNK, -(-n // MAX_BARS)) if chunk is None else int(chunk)
        h = min(h, n)
        smem = tile_smem_bytes(n, q, R, C, esize)
        if h < 1 or -(-n // h) > MAX_BARS:
            raise ValueError(f"rows an mbarrier: {h} gives more than "
                             f"{MAX_BARS} chunks of {n} rows")
    elif form == "stream":
        nt = C if threads is None else int(threads)
        if nt != C:
            raise ValueError(f"the stream form runs a thread a column: "
                             f"{nt} threads for {C} columns")
        most = SMEM_MAX // stream_smem_bytes(q, 1, C, esize)
        h = min(n, most) if chunk is None else int(chunk)
        smem = stream_smem_bytes(q, h, C, esize)
        if not 1 <= h <= n:
            raise ValueError(f"U rows on chip must be 1..{n}, got {h}")
    else:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if nt % C or not C <= nt <= MAX_THREADS:
        raise ValueError(f"threads must be a multiple of the {C} columns up "
                         f"to {MAX_THREADS}, got {nt}")
    if smem > SMEM_MAX:
        raise ValueError(f"the {form} form of n={n} q={q} R={R} with {C} "
                         f"columns a block needs {smem} bytes of shared "
                         f"memory, more than {SMEM_MAX}")
    return MultiLaunch(form, C, nt, h, smem, blocks)


def copy_width(ncol: int, esize: int, ptrs) -> int:
    """Bytes a staging copy of the tile form moves: 16 (one bulk
    copy a row) where a row of ncol values and every pointer of ``ptrs``
    (ints) are 16-byte multiples, else 8 (``cp.async``) where they are
    8-byte multiples, else one value."""
    for nbytes in (16, 8):
        if nbytes >= esize and (ncol * esize) % nbytes == 0 \
                and all(p % nbytes == 0 for p in ptrs):
            return nbytes
    return esize


def launch_config(bands, rhs, q: int, launch: MultiLaunch = None) -> dict:
    """What a launch on these inputs takes: ``banded_solve_multi``'s for
    ``rhs (n, R, ncol)``, ``banded_solve``'s for ``rhs (n, ncol)``.  Its
    launch shape (``launch``, default the rule's), its copy width and route
    (for the report lines of ``chip_smoke.py``)."""
    n, ncol = rhs.shape[0], rhs.shape[-1]
    if launch is None:
        launch = banded_solve_launch_shape(n, q, ncol, bands.dtype) \
            if rhs.dim() == 2 else \
            banded_multi_launch_shape(n, q, rhs.shape[1], ncol, bands.dtype)
    esize = bands.element_size()
    copy = esize if launch.form in ("ring", "wide") else \
        copy_width(ncol, esize, [bands.data_ptr(), rhs.data_ptr()])
    route = ("none: rows read as eliminated"
             if launch.form in ("stream", "wide") else
             f"cp.async {copy} B, a lane its column, a commit group a row"
             if launch.form == "ring" else
             "cp.async.bulk (TMA 1-D), a row a copy" if copy == 16 else
             f"cp.async {copy} B")
    return dict(launch._asdict(), copy=copy, copy_route=route)


_ENTRY = re.compile(r"(tile|stream|ring)_kernelI([fd])Li(\d+)E")
_WIDE = re.compile(r"wide_kernelI([fd])E")


def resources_of(usage: dict) -> dict:
    """``build.parse_ptxas``'s report of a build of
    ``csrc/banded_multi.cu`` keyed ``tile f32 q1``, ``ring f64 q8``, ``wide
    f32``, ..."""
    out = {}
    for name, use in usage.items():
        m, w = _ENTRY.search(name), _WIDE.search(name)
        if m:
            out[f"{m.group(1)} {'f32' if m.group(2) == 'f' else 'f64'} "
                f"q{m.group(3)}"] = use
        elif w:
            out[f"wide {'f32' if w.group(1) == 'f' else 'f64'}"] = use
    return out


def kernel_resources() -> dict:
    """Registers and spill bytes of the 62 instantiations of
    ``csrc/banded_multi.cu`` (form x value type x q of ``TEMPLATE_Q``, and
    the wide form a value type) as ``nvcc -Xptxas -v`` reported them at the
    build (empty before a build; ``resources_of``)."""
    return resources_of(build.ptxas_usage("banded_multi"))


def _banded_solve_multi_cuda(bands, rhs, q, launch: MultiLaunch = None):
    """Launch the kernel; ``launch``: a ``MultiLaunch`` in place of the
    rule's (the tests and ``kernels/tune_fused.py`` force each form)."""
    x = _launch(bands, rhs, q, launch_config(bands, rhs, q, launch),
                "banded_solve_multi")
    launch_counts["banded_solve_multi"] += 1
    return x


def pivot_divide(w, p):
    """``w / p`` elementwise, each quotient as the ring form of
    ``banded_solve`` takes it (``recip`` and ``quick_div`` of
    ``csrc/banded_multi.cu``: from the pivot's reciprocal where Markstein's
    theorem gives the division's bits, else the division).  For the tests
    that hold it bit for bit against ``w / p``; on CPU tensors it is
    ``w / p``."""
    if w.shape != p.shape or w.dtype != p.dtype or w.device != p.device:
        raise ValueError("w and p must match in shape, dtype and device")
    if w.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{w.dtype}: float32 or float64")
    if w.device.type == "cpu":
        return w / p
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    w, p = w.contiguous(), p.contiguous()
    lib = build.library("banded_multi")
    fn = lib.banded_div_f32 if w.dtype == torch.float32 \
        else lib.banded_div_f64
    with torch.cuda.device(w.device):
        out = torch.empty_like(w)
        err = fn(w.data_ptr(), p.data_ptr(), out.data_ptr(), w.numel(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"banded_div kernel launch failed (error {err})")
    return out


def _launch(bands, rhs, q, cfg, what):
    """One launch of the kernel on ``rhs (n, R, ncol)`` as ``cfg``
    (``launch_config``) says; returns the solution ``(n, R, ncol)``."""
    n, R, ncol = rhs.shape
    lib = build.library("banded_multi")
    fn = lib.banded_solve_multi_f32 if bands.dtype == torch.float32 \
        else lib.banded_solve_multi_f64
    with torch.cuda.device(bands.device):
        x = torch.empty_like(rhs)
        err = fn(bands.data_ptr(), rhs.data_ptr(), x.data_ptr(), n, R, ncol,
                 q, FORMS.index(cfg["form"]), cfg["cols"], cfg["threads"],
                 cfg["chunk"], cfg["copy"],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed (error {err}; -1: "
                           f"launch shape or copy width not taken, -2: "
                           f"shared memory; launch {cfg})")
    return x
