"""The traced sub-window's reduction: from torch.profiler's events to the
device's busy time, the device time of each kernel by name, the idle gaps
named by what the host was doing, and the ``breakdown`` of the result.

Busy time is the union of the intervals in which any device operation ran
(kernels on several streams at once count once); the window is the stream
time between two CUDA events recorded around the sub-window.  A gap is
named by the innermost of the harness's own host ranges (``portbench.*``,
``record_function``) open when the device fell idle.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

HOST_RANGES = ("portbench.batch", "portbench.step", "portbench.evaluate")

# kernels B and D's parts, each tiled product named by its epilogue's type
# (the bf16 scan mode's, named ...S, first: a name may hold another)
KERNEL_B_PARTS = ("F1GateS", "F1CellS", "F2HiS", "F3UpdateS", "F1Cell",
                  "F2Hi", "F3Update", "gcnii_fwd_init", "gcnii_layer_kernel",
                  "gcnii_resident_kernel")
KERNEL_D_PARTS = ("P1GateS", "P1CellS", "P2HiS", "P3PreS", "P4DProjS",
                  "P5DAdjS", "P6LstmS", "P7LstmInS", "P1Gates", "P1CellB",
                  "P2Hi", "P3Pre", "P4DProj", "P5DAdj", "P6Lstm", "P7LstmIn",
                  "WgradW", "WgradLstm", "gcnii_reduce_kernel",
                  "gcnii_scan_lstm_reduce_kernel")
KERNEL_A_PARTS = ("bigru_fwd",)
KERNEL_C_PARTS = ("bigru_bwd",)


def kernel_label(name: str) -> str:
    """A short name for a profiler kernel name: kernel B's or D's part
    (``gcnii_fwd F2Hi``), else the name without its namespace and
    arguments, cut to 60 characters."""
    for lib, parts in (("gcnii_fwd", KERNEL_B_PARTS),
                       ("gcnii_bwd", KERNEL_D_PARTS)):
        part = next((p for p in parts if p in name), None)
        if part:
            return f"{lib} {part}"
    head = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return head.split("(")[0][:60]


def union_s(spans: Sequence[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) microsecond intervals, in
    seconds."""
    busy, until = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > until:
            busy += b - max(a, until)
            until = b
    return busy / 1e6


def gaps(spans: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The (start, end) microsecond intervals between the union's pieces."""
    out, until = [], None
    for a, b in sorted(spans):
        if until is not None and a > until:
            out.append((until, a))
        until = b if until is None else max(until, b)
    return out


def reduce(device_events: Sequence[Tuple[str, float, float]],
           host_ranges: Sequence[Tuple[str, float, float]],
           window_s: float) -> dict:
    """``device_events``: (name, start_us, end_us) of every device
    operation in the sub-window; ``host_ranges``: (name, start_us, end_us)
    of the harness's host ranges on the same clock; ``window_s``: the
    sub-window's stream time.  Returns busy_s, window_s, the device
    seconds by label, and the breakdown's two lists."""
    spans = [(a, b) for _, a, b in device_events]
    by_label: Dict[str, float] = defaultdict(float)
    for name, a, b in device_events:
        by_label[kernel_label(name)] += (b - a) / 1e6
    named = []
    for a, b in gaps(spans):
        open_ = [(s, name) for name, s, e in host_ranges if s <= a < e]
        what = max(open_)[1] if open_ else "host"
        named.append((what, (b - a) / 1e6))
    named.sort(key=lambda x: -x[1])
    ops = sorted(by_label.items(), key=lambda x: -x[1])
    return dict(busy_s=union_s(spans), window_s=window_s,
                by_label=dict(by_label),
                breakdown=dict(device_ops=[[n, s] for n, s in ops[:10]],
                               idle_gaps=[[n, s] for n, s in named[:10]]))


def seconds_of(summary: dict, lib: str) -> float:
    """The device seconds of one kernel's parts (``gcnii_fwd`` for B,
    ``gcnii_bwd`` for D)."""
    return sum(s for n, s in summary["by_label"].items()
               if n.startswith(lib + " "))


def from_profiler(prof) -> Tuple[list, list]:
    """(device_events, host_ranges) from a finished ``torch.profiler``."""
    import torch

    dev, host = [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((e.name, a, b))
        elif e.name in HOST_RANGES:
            host.append((e.name, a, b))
    return dev, host
