"""``sweep.step_ms``: the median stream time of one ``VmapSweep.step`` call
of the window (CUDA events recorded around each call), in ms."""

import statistics


def read(ctx):
    return statistics.median(ctx["step_ms"]) if ctx["step_ms"] else None
