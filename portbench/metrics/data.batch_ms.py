"""``data.batch_ms``: the median host time, over the training batches of
the traced sub-window, of a batch's way to the card, in ms: its
``data.collate`` span (``BucketBatcher``'s padding into one static
batch) plus its ``data.to_device`` span (``prepare_inputs``: the pinned
copies), matched by the group step they belong to.  A training batch is
one whose step has a ``sweep.step`` span.  Nothing where the program logs
no such spans."""

import statistics
from collections import defaultdict

from portbench import program


def read(ctx):
    steps = {s.step for s in program.spans("sweep.step")}
    ms = defaultdict(float)
    for name in ("data.collate", "data.to_device"):
        for s in program.spans(name):
            if s.step in steps:
                ms[s.step] += (s.end_ns - s.start_ns) / 1e6
    return statistics.median(ms.values()) if ms else None
