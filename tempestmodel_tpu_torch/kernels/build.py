"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library under ``tempestmodel_tpu_torch/_build/`` (a git-ignored
directory) at first use, keyed by a hash of all the sources and the flags,
and loaded with ``ctypes``.  The sources include no PyTorch header (a plain
C interface), so a build takes seconds; all sources compile in parallel.
Only the sources in the package are built and nothing is downloaded.

Nothing here runs at import: the first kernel launch (or an explicit
``build_all()``) triggers the build.  A build or load failure raises — no
caller gives way to a plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_I64 = ctypes.c_longlong

# C entry points of each source: name -> argtypes (every one returns int,
# the value of cudaGetLastError()).  Pointers and the stream are c_void_p:
# without argtypes ctypes would pass them as 32-bit ints and cut them.
# the DSS entry points end in the halo wall pointers (an array, or null)
# and the stream
_WALLS = ctypes.POINTER(_PTR)
_DSS_SCALAR = [_PTR] * 4 + [_INT] * 12 + [_WALLS, _PTR]
_DSS_VECTOR = [_PTR] * 7 + [_INT] * 12 + [_WALLS, _PTR]
_BANDED_MULTI = [_PTR, _PTR, _PTR, _INT, _INT, _I64] + [_INT] * 6 + [_PTR]
_BANDED_DIV = [_PTR, _PTR, _PTR, _I64, _PTR]
_DBL = ctypes.c_double
_DSS_UVW = [_PTR] * 14 + [_DBL] * 5 + [_INT] * 12 + [_WALLS, _PTR]
# the fused kernels take their many operands as host arrays: pointers,
# doubles, ints (the wrappers build them with ctypes)
_ARRAYS = [ctypes.POINTER(_PTR), ctypes.POINTER(_DBL), ctypes.POINTER(_INT)]
_STAGE = _ARRAYS + [_PTR]
_DSS_SCALAR2 = [_PTR] * 6 + [_INT] * 12 + [_WALLS, _PTR]
_DSS_STATE = [ctypes.POINTER(_PTR)] + [_PTR] * 3 + [_INT] * 12 + [_WALLS,
                                                                   _PTR]
_IMPLICIT = _ARRAYS + [_I64, _PTR]
SIGNATURES = {
    "dss": {"dss_scalar_f32": _DSS_SCALAR, "dss_scalar_f64": _DSS_SCALAR,
            "dss_vector_f32": _DSS_VECTOR, "dss_vector_f64": _DSS_VECTOR,
            "dss_uvw_f32": _DSS_UVW, "dss_uvw_f64": _DSS_UVW,
            "dss_scalar2_f32": _DSS_SCALAR2, "dss_scalar2_f64": _DSS_SCALAR2,
            "dss_state_f32": _DSS_STATE, "dss_state_f64": _DSS_STATE},
    "banded_multi": {"banded_solve_multi_f32": _BANDED_MULTI,
                     "banded_solve_multi_f64": _BANDED_MULTI,
                     "banded_div_f32": _BANDED_DIV,
                     "banded_div_f64": _BANDED_DIV},
    "stage": {"fused_stage_f32": _STAGE, "fused_stage_f64": _STAGE},
    "hyper": {"nu4_f32": _STAGE, "nu4_f64": _STAGE},
    "implicit": {"fused_implicit_f32": _IMPLICIT,
                 "fused_implicit_f64": _IMPLICIT},
}

_libs: dict = {}      # source stem -> loaded ctypes library (per process)


def nvcc_path() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME, "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(stem: str, tag: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{stem}-{tag}.so"


def build_all(verbose: bool = False) -> dict:
    """Compile every source that has no up-to-date library (one ``nvcc``
    per source, all started together), load them all, and return
    ``{"seconds": wall time of the compile, "built": [stems compiled now],
    "libraries": [paths]}``."""
    tag = _source_hash()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in sources():
        out = _lib_path(src.stem, tag)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)]
        procs.append((src.stem, tmp, out, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for stem, tmp, out, cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)          # atomic: a reader never sees half a file
        out.with_suffix(".log").write_text(log)   # ptxas_usage reads it
        if verbose:
            print(f"[build] {stem}:\n{log}", flush=True)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    seconds = time.perf_counter() - t0
    for src in sources():
        _load(src.stem, tag)
    return {"seconds": seconds, "built": [p[0] for p in procs],
            "libraries": [str(_lib_path(s.stem, tag)) for s in sources()]}


def _load(stem: str, tag: str):
    if stem in _libs:
        return _libs[stem]
    lib = ctypes.CDLL(str(_lib_path(stem, tag)))
    for name, argtypes in SIGNATURES[stem].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _libs[stem] = lib
    return lib


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def parse_ptxas(text: str) -> dict:
    """``{mangled kernel name: {"registers", "spill_stores",
    "spill_loads"}}`` from the text of an ``nvcc -Xptxas -v`` report."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
        elif cur is not None and _SPILL.search(line):
            st, ld = _SPILL.search(line).groups()
            cur.update(spill_stores=int(st), spill_loads=int(ld))
        elif cur is not None and _REGS.search(line):
            cur["registers"] = int(_REGS.search(line).group(1))
    return out


def ptxas_usage(stem: str) -> dict:
    """``parse_ptxas`` of the report of the current build of
    ``csrc/<stem>.cu`` (empty when no build of these sources has one)."""
    path = _lib_path(stem, _source_hash()).with_suffix(".log")
    return parse_ptxas(path.read_text()) if path.exists() else {}


def library(stem: str):
    """The loaded library of ``csrc/<stem>.cu``, building first if needed."""
    if stem not in _libs:
        build_all()
    return _libs[stem]
