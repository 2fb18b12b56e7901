"""The program's own span log and counters
(``mmdfn_torch/runtime/profiling.py``: ``spans()``, ``counters()``), as
the per-layer readers read them after a run.  The program records only
while a ``torch.profiler`` is active, which in a run is the traced
sub-window alone.  Both are empty where the program has no such log."""

from __future__ import annotations

from typing import Dict, List, Optional


def _profiling():
    try:
        from mmdfn_torch.runtime import profiling
    except ImportError:
        return None
    return profiling


def spans(name: Optional[str] = None) -> List:
    """The logged spans (name, id, parent, step, start_ns, end_ns,
    attrs), those named ``name`` where it is given."""
    log = getattr(_profiling(), "spans", None)
    if log is None:
        return []
    return [s for s in log() if name is None or s.name == name]


def counters() -> Dict[str, int]:
    """The program's counters."""
    got = getattr(_profiling(), "counters", None)
    return {} if got is None else got()
