"""Hierarchical block logging (reference ``src/base/Announce.{h,cpp}``).

The reference's operational UX: nested announcement blocks with `..`
indentation per level, verbosity gating, rank-0-only output
(``Announce.h:40-95``; enabled in ``TempestInitialize.h:726``), and a
banner separator.  Process-rank gating uses the rank of the default
``torch.distributed`` process group when one is initialized, else rank 0.

Usage::

    from tempestmodel_tpu_torch.utils.announce import (
        announce, announce_start_block, announce_end_block,
        announce_banner, block)

    announce_banner("INITIALIZATION")
    with block("Model initialization"):
        announce("Loading geometry")
        announce(2, "a verbosity-2 detail")   # hidden at default level
"""

from __future__ import annotations

import contextlib
import sys
import threading

_state = threading.local()


def _st():
    if not hasattr(_state, "level"):
        _state.level = 0
        _state.verbosity = 1
        _state.rank0_only = False
        _state.stream = None
        _state.block_open = []
    return _state


def announce_set_output(stream):
    """Redirect output (reference ``AnnounceSetOutputBuffer``)."""
    _st().stream = stream


def announce_set_verbosity(level: int):
    """Messages with verbosity > level are suppressed
    (``AnnounceSetVerbosityLevel``)."""
    _st().verbosity = int(level)


def announce_only_rank_zero(enable: bool = True):
    """Gate output to process 0 (``AnnounceOnlyOutputOnRankZero``)."""
    _st().rank0_only = bool(enable)


def _emit_allowed(verbosity: int) -> bool:
    st = _st()
    if verbosity > st.verbosity:
        return False
    if st.rank0_only:
        import torch.distributed as dist
        if (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0):
            return False
    return True


def _write(text: str, newline: bool = True):
    st = _st()
    stream = st.stream if st.stream is not None else sys.stdout
    stream.write(text + ("\n" if newline else ""))
    try:
        stream.flush()
    except Exception:
        pass


def announce(*args):
    """announce(text) or announce(verbosity, text) — one indented line."""
    if len(args) == 2:
        verbosity, text = args
    else:
        (text,) = args
        verbosity = 1
    if not _emit_allowed(verbosity):
        return
    st = _st()
    _write(".." * st.level + str(text))


def announce_start_block(*args):
    """Open a nested block; subsequent announcements indent one level."""
    if len(args) == 2:
        verbosity, text = args
    else:
        (text,) = args
        verbosity = 1
    st = _st()
    emitted = _emit_allowed(verbosity)
    if emitted and text:
        _write(".." * st.level + str(text))
    st.level += 1
    st.block_open.append(emitted)


def announce_end_block(*args):
    """Close the innermost block, optionally with a closing message
    (printed at the block's indentation, e.g. "Done")."""
    if len(args) == 2:
        verbosity, text = args
    elif len(args) == 1:
        (text,) = args
        verbosity = 1
    else:
        text, verbosity = None, 1
    st = _st()
    if st.level > 0:
        st.level -= 1
    if st.block_open:
        st.block_open.pop()
    if text and _emit_allowed(verbosity):
        _write(".." * (st.level + 1) + str(text))


def announce_banner(text: str = None):
    """Banner separator line (``AnnounceBanner``)."""
    if not _emit_allowed(1):
        return
    if text:
        pad = max(0, 60 - len(text) - 2)
        _write("=" * (pad // 2) + f" {text} " + "=" * (pad - pad // 2))
    else:
        _write("=" * 60)


@contextlib.contextmanager
def block(text: str, done: str = "Done", verbosity: int = 1):
    """Context-manager form of Start/EndBlock."""
    announce_start_block(verbosity, text)
    try:
        yield
    finally:
        announce_end_block(verbosity, done)
