"""``host.enqueue_ms``: the median host time of one ``VmapSweep.step``
call in the traced sub-window, in ms: its ``sweep.step`` span
(``mmdfn_torch/runtime/profiling.py``), the host's time to enqueue one
group step.  Read it beside ``sweep.step_ms``, the stream time of the
same calls.  Nothing where the program logs no such span."""

import statistics

from portbench import program


def read(ctx):
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in program.spans("sweep.step")]
    return statistics.median(ms) if ms else None
