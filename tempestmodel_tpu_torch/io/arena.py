"""ctypes bindings for the native arena serialization library.

Counterpart of the JAX package's ``io/arena.py``; an analog of the
reference ``DataContainer`` arena (``src/base/DataContainer.{h,cpp}``)
used by the composite checkpoint: a C++ library (``native/arena.cpp``, the
repository's one source, shared with the JAX package) packs named arrays
into one contiguous 64-byte-aligned buffer with per-array checksums and
multithreaded memcpy.  It is compiled with g++ at first use into this
package's git-ignored ``_build/`` directory, named by a hash of the source
and the flags, and never next to the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SRC_PATH = _PKG.parent / "native" / "arena.cpp"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None


def _so_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC_PATH.read_bytes())
    return _BUILD_DIR / f"libtempest_arena-{h.hexdigest()[:16]}.so"


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so = _so_path()
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        subprocess.run(["g++", *_FLAGS, str(_SRC_PATH), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, so)       # atomic: a reader never sees half a file
    lib = ctypes.CDLL(str(so))
    lib.ta_required_bytes.restype = ctypes.c_int64
    lib.ta_required_bytes.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64)]
    lib.ta_pack.restype = ctypes.c_int64
    lib.ta_pack.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_void_p, ctypes.c_int64]
    lib.ta_count.restype = ctypes.c_int64
    lib.ta_count.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.ta_entry.restype = ctypes.c_int64
    lib.ta_entry.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.ta_unpack.restype = ctypes.c_int64
    lib.ta_unpack.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads here (g++ present)."""
    try:
        _load()
    except (OSError, subprocess.CalledProcessError):
        return False
    return True


def _meta_encode(name: str, arr: np.ndarray) -> str:
    shape = ",".join(str(s) for s in arr.shape)
    return f"{name}|{arr.dtype.str}|{shape}"


def _meta_decode(tag: str):
    name, dtype, shape = tag.split("|")
    shp = tuple(int(s) for s in shape.split(",")) if shape else ()
    return name, np.dtype(dtype), shp


def pack(arrays: dict) -> bytes:
    """Pack {name: ndarray} into one arena buffer."""
    lib = _load()
    items = [(k, np.ascontiguousarray(v)) for k, v in arrays.items()]
    n = len(items)
    names = (ctypes.c_char_p * n)(
        *[_meta_encode(k, v).encode() for k, v in items])
    ptrs = (ctypes.c_void_p * n)(
        *[v.ctypes.data_as(ctypes.c_void_p).value for _, v in items])
    sizes = (ctypes.c_int64 * n)(*[v.nbytes for _, v in items])
    need = lib.ta_required_bytes(n, names, sizes)
    buf = np.empty(need, dtype=np.uint8)
    written = lib.ta_pack(n, names, ptrs, sizes,
                          buf.ctypes.data_as(ctypes.c_void_p), need)
    if written < 0:
        raise RuntimeError("arena pack overflow")
    return buf[:written].tobytes()


def unpack(data: bytes) -> dict:
    """Restore {name: ndarray} from an arena buffer (checksum-verified)."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    ptr = buf.ctypes.data_as(ctypes.c_void_p)
    n = lib.ta_count(ptr, len(buf))
    if n < 0:
        raise ValueError("not an arena buffer")
    out = {}
    for i in range(n):
        name_buf = ctypes.create_string_buffer(4096)
        nbytes = ctypes.c_int64()
        if lib.ta_entry(ptr, i, name_buf, 4096, ctypes.byref(nbytes)) != 0:
            raise ValueError(f"bad arena entry {i}")
        name, dtype, shape = _meta_decode(name_buf.value.decode())
        arr = np.empty(shape, dtype=dtype)
        rc = lib.ta_unpack(ptr, i, arr.ctypes.data_as(ctypes.c_void_p),
                           arr.nbytes)
        if rc == -2:
            raise ValueError(f"checksum mismatch for {name!r}")
        if rc != 0:
            raise ValueError(f"unpack failure for {name!r}")
        out[name] = arr
    return out


def save(path: str, arrays: dict):
    with open(path, "wb") as f:
        f.write(pack(arrays))


def load(path: str) -> dict:
    with open(path, "rb") as f:
        return unpack(f.read())
