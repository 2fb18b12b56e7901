"""``data.pad_pct``: the share of the padded batch slots that hold no
utterance over the batches collated in the traced sub-window (its
training batches: the test split's are collated in set-up), in %:
100 (1 - ``data.utterances`` / ``data.slots``), the program's counters of
each batch's valid utterances and its batch_size x bucket slots
(``mmdfn_torch/data/batching.py``).  The data layer's useful work over
the work attempted.  Nothing where the program counts no slots."""

from portbench import program


def read(ctx):
    c = program.counters()
    slots = c.get("data.slots", 0)
    if slots <= 0:
        return None
    return 100.0 * (1.0 - c.get("data.utterances", 0) / slots)
