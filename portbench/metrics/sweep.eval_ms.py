"""``sweep.eval_ms``: the median stream time of one ``VmapSweep.evaluate``
call over the test split in the window (CUDA events around each call), in
ms; nothing where the window holds no evaluation."""

import statistics


def read(ctx):
    return statistics.median(ctx["eval_ms"]) if ctx["eval_ms"] else None
