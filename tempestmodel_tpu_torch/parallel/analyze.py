"""Exchange analysis of a sharded step: what the mesh DSS moves.

Counterpart of the JAX package's ``parallel/analyze.py``, which compiles a
function under a sharding and tallies the collectives of its optimized HLO.
There is no HLO here: the transports of ``parallel.mesh`` tally every
exchange op as it is issued (its kind and the bytes of its per-shard
payload, the quantities the HLO tally reads from the ops' operand shapes),
and this module runs one call with the tally reset and reports it.  So "the
step moves only the routed edge segments, no all-gather, no all-reduce" is a
measured statement.

Usage::

    from tempestmodel_tpu_torch.parallel.analyze import collective_report
    rep = collective_report(first_step, (mesh.shard(X),), mesh)
    print(format_report(rep))
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch


@dataclass
class CollectiveReport:
    counts: dict = field(default_factory=dict)    # op kind -> count
    bytes_: dict = field(default_factory=dict)    # op kind -> total bytes
    largest: list = field(default_factory=list)   # (bytes, kind, shape)
    input_bytes: int = 0                          # total (global) arg bytes
    moved: int = 0                                # bytes between shards


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def collective_report(fn: Callable, args: tuple, mesh) -> CollectiveReport:
    """Run ``fn(*args)`` once (the arguments sharded for ``mesh``: a
    ``ShardMesh``'s lists of shards, a ``DistMesh`` rank's blocks) with
    ``mesh.tally`` reset, and report the exchange ops it issued: per kind
    their number and the bytes of their per-shard payloads, the largest
    ops, the bytes moved between shards (all shards of a ``ShardMesh``; the
    ones this rank sent on a ``DistMesh``) and the global bytes of the
    arguments."""
    from .mesh import ShardMesh
    mesh.tally.reset()
    fn(*args)
    t = mesh.tally
    nbytes = sum(v.numel() * v.element_size() for v in _tensors(args))
    if not isinstance(mesh, ShardMesh):
        nbytes *= mesh.size
    return CollectiveReport(counts=dict(t.counts), bytes_=dict(t.bytes_),
                            largest=list(t.largest), input_bytes=nbytes,
                            moved=t.moved)


def format_report(rep: CollectiveReport, label: str = "") -> str:
    lines = [f"collective report {label}".rstrip()]
    lines.append(f"  global input bytes: {rep.input_bytes:,}")
    total = sum(rep.bytes_.values())
    if not rep.counts:
        lines.append("  (no collectives issued)")
    for k in sorted(rep.counts):
        lines.append(f"  {k:22s} x{rep.counts[k]:<4d} {rep.bytes_[k]:,} B")
    lines.append(f"  total collective bytes: {total:,} "
                 f"({total / max(rep.input_bytes, 1):.3f}x of input)")
    lines.append(f"  bytes moved between shards: {rep.moved:,}")
    for b, kind, shape in rep.largest[:5]:
        lines.append(f"    largest: {kind} {list(shape)} = {b:,} B")
    return "\n".join(lines)
