"""Profiling, throughput metering and debug instrumentation
(``mmdfn_tpu/runtime/profiling.py``) on torch.profiler and CUDA events.

* :class:`ThroughputMeter`: dialogues/s and utterances/s of a region;
* :func:`trace`: a torch.profiler trace of a region, written for
  TensorBoard's profile plugin or Perfetto;
* :func:`annotate`: the program's span, a named sub-region of a traced
  region on the profiler's timeline, also kept with its parent, its group
  step and its attributes in an in-memory log (:func:`spans`), and
  :func:`count`, the program's counters (:func:`counters`): both record
  only while a ``torch.profiler`` is active;
* :func:`device_time_ms` / :func:`device_busy_ms`: what a callable keeps
  the card busy, and the window it spans;
* :func:`debug_numerics`: autograd's anomaly mode with NaN checks;
* :func:`grad_histograms_device`: per-parameter gradient histograms
  reduced on the device (the ``--tensorboard`` histograms), and
  :func:`grad_histograms`, numpy's on the host;
* :class:`JsonlWriter`: an append-only JSON-lines metric stream.

``mmdfn_tpu``'s ``enable_compilation_cache`` has no counterpart: it is
XLA's cache, and the kernels' build directory already keeps what nvcc
built.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import (Callable, Dict, Iterator, List, Mapping, NamedTuple,
                    Optional, Tuple)

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler


@dataclass
class ThroughputMeter:
    """Accumulates step timings into dialogues/sec and utterances/sec."""

    dialogues: int = 0
    utterances: int = 0
    seconds: float = 0.0
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_dialogues: int, n_utterances: int):
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        self.seconds += time.perf_counter() - self._t0
        self.dialogues += n_dialogues
        self.utterances += n_utterances
        self._t0 = None

    @contextlib.contextmanager
    def step(self, n_dialogues: int, n_utterances: int):
        self.start()
        try:
            yield
        finally:
            self.stop(n_dialogues, n_utterances)

    @property
    def dialogues_per_sec(self) -> float:
        return self.dialogues / self.seconds if self.seconds else 0.0

    @property
    def utterances_per_sec(self) -> float:
        return self.utterances / self.seconds if self.seconds else 0.0

    def summary(self) -> Dict[str, float]:
        return dict(dialogues=self.dialogues, utterances=self.utterances,
                    seconds=round(self.seconds, 3),
                    dialogues_per_sec=round(self.dialogues_per_sec, 2),
                    utterances_per_sec=round(self.utterances_per_sec, 2))


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """A torch.profiler trace of the region (host operators, and the card's
    kernels where there is one), written under ``log_dir`` as
    ``<host>_<pid>.<time>.pt.trace.json`` when the region ends; nothing
    when ``log_dir`` is None.  View it with TensorBoard's profile plugin
    or Perfetto."""
    if not log_dir:
        yield
        return
    from torch.profiler import profile, tensorboard_trace_handler

    with profile(activities=_activities(),
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def _union_ms(spans) -> float:
    """The length of the union of (start, end) microsecond intervals, in
    ms: kernels that overlap on several streams count once."""
    busy, until = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > until:
            busy += b - max(a, until)
            until = b
    return busy / 1e3


def device_time_ms(run: Callable[[], object]) -> Optional[Tuple[float, float]]:
    """``(busy_ms, total_ms)`` of what ``run()`` puts on the card: busy is
    the union of the intervals in which its kernels ran (torch.profiler;
    the GPU-side user annotations that cover kernels are left out), total
    the stream time between CUDA events recorded around it in the same
    traced run, so ``total - busy`` is the traced window's idle.  None
    where there is no card (no device reading); a ``run`` that launched
    nothing reads (0.0, total).  It synchronizes after ``run()``."""
    if not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    return _union_ms(spans), start.elapsed_time(end)


def device_busy_ms(run: Callable[[], object]) -> Optional[float]:
    """The card's busy time (ms) of ``run()``; see :func:`device_time_ms`."""
    t = device_time_ms(run)
    return None if t is None else t[0]


class Span(NamedTuple):
    """One finished span of the log.  ``step`` is the (epoch, i) of the
    group step it belongs to; the times are nanoseconds on the profiler's
    own clock."""

    name: str
    id: int
    parent: Optional[int]
    step: Optional[Tuple[int, int]]
    start_ns: int
    end_ns: int
    attrs: Dict[str, object]


# the log keeps the newest spans; a traced group step makes about twenty
LOG_SPANS = 1 << 16
_log: deque = deque(maxlen=LOG_SPANS)
_counters: Dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()
_top = None     # the outermost open span, parent of a thread's first one
_step = None    # the step id last declared
_OFF = contextlib.nullcontext()
# a span's profiler range: torch's C++ record function, whose range opens
# and closes within microseconds of the log's times (under a CUDA trace
# ``record_function``'s Python enter and exit spend tens of microseconds
# inside its range, so its ends and the log's would disagree by that)
_range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


class _Span:
    """An open span: a profiler range of its name, and its log row when it
    closes."""

    __slots__ = ("name", "step", "attrs", "id", "parent", "start", "_rf",
                 "_stack")

    def __init__(self, name: str, step, attrs: dict):
        self.name, self.step, self.attrs = name, step, attrs

    def __enter__(self):
        global _top, _step
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        # a thread's first span hangs under the outermost span open on
        # another thread: autograd's device thread launches kernels C and
        # D while the calling thread waits inside the group step
        parent = stack[-1] if stack else _top
        if parent is None:
            _top = self
        if self.step is not None:
            _step = self.step
        else:
            self.step = parent.step if parent is not None else _step
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self._rf = _range(self.name)
        self._rf.__enter__()
        self.start = time.time_ns()
        self._stack = stack
        stack.append(self)
        return self

    def __exit__(self, *exc):
        global _top
        end = time.time_ns()
        self._rf.__exit__(*exc)
        self._stack.pop()
        if _top is self:
            _top = None
        _log.append(Span(self.name, self.id, self.parent, self.step,
                         self.start, end, self.attrs))
        return False


def annotate(name: str, step: Optional[Tuple[int, int]] = None, **attrs):
    """The program's span: a context manager that names a sub-region of a
    traced step.  While a ``torch.profiler`` is active it opens a range
    of ``name`` on the trace's timeline (as ``record_function`` does) and,
    when it closes, appends to the log (:func:`spans`) its name, id,
    parent (the span open on its thread, else the outermost span open on
    another), its group step (``step``: the (epoch, i) it declares, else
    its parent's, else the one last declared) and ``attrs``.  The log's
    times are ``time.time_ns()``: CLOCK_REALTIME, the clock of
    torch.profiler's host events on Linux.  Otherwise it does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, step, attrs)


def count(name: str, n: int) -> None:
    """Adds ``n`` to the program's counter ``name`` while a
    ``torch.profiler`` is active (:func:`counters`)."""
    if _autograd_profiler._is_profiler_enabled:
        _counters[name] = _counters.get(name, 0) + int(n)


def spans() -> List[Span]:
    """The log: the spans that closed while a profiler was active, oldest
    first (at most ``LOG_SPANS``, the newest)."""
    return list(_log)


def counters() -> Dict[str, int]:
    """The counters :func:`count` added to while a profiler was active."""
    return dict(_counters)


def reset() -> None:
    """Empties the log and the counters."""
    global _step
    _log.clear()
    _counters.clear()
    _step = None


def debug_numerics(enable: bool = True) -> None:
    """Autograd's anomaly mode, with its NaN check: a backward that makes a
    NaN raises, naming the forward operator that led to it."""
    torch.autograd.set_detect_anomaly(enable, check_nan=enable)


def grad_histograms_device(grads: Mapping[str, torch.Tensor],
                           bins: int = 64) -> Dict[str, Dict]:
    """Per-parameter gradient histograms, reduced where the gradients are.

    The ``--tensorboard`` histograms of the reference's per-batch
    ``writer.add_histogram(name, param.grad)``: instead of copying every
    gradient to the host each batch, each row is ``bins + 1`` edges and
    ``bins`` counts plus the moments tensorboard wants, as
    ``jnp.histogram`` bins them (edges from min to max, a half unit either
    side when they are equal; each bin closed on the left, the last also
    on the right).  Nothing here waits for the card.

    Returns ``{name: {counts, edges, min, max, sum, sum_sq, num}}``, tensors
    on the gradients' device (``num`` an int).
    """
    out = {}
    for name, g in grads.items():
        flat = g.detach().reshape(-1).to(torch.float32)
        lo, hi = torch.aminmax(flat)
        same = lo == hi
        first = torch.where(same, lo - 0.5, lo)
        last = torch.where(same, hi + 0.5, hi)
        # jnp.linspace's f32 arithmetic: start (1 - t) + stop t, t = i / bins
        t = torch.arange(bins, device=flat.device,
                         dtype=torch.float32) / bins
        edges = torch.cat([first * (1 - t) + last * t, last[None]])
        idx = torch.searchsorted(edges, flat, right=True)
        idx = torch.where(flat == edges[-1], bins, idx)
        counts = torch.zeros(bins + 1, dtype=torch.int64,
                             device=flat.device).index_add_(
            0, idx, torch.ones_like(idx))[1:]
        out[name] = dict(counts=counts, edges=edges, min=lo, max=hi,
                         sum=flat.sum(), sum_sq=(flat * flat).sum(),
                         num=flat.numel())
    return out


_ROW_KEYS = ("counts", "edges", "min", "max", "sum", "sum_sq")


def histograms_to_host(rows: List[Dict[str, Dict]]) -> List[Dict[str, Dict]]:
    """:func:`grad_histograms_device` rows (one dict a step) as host numpy
    arrays, in one copy from the device: counts int64, the rest float32."""
    flat = [row[k].reshape(-1).to(torch.float64)
            for hists in rows for row in hists.values() for k in _ROW_KEYS]
    if not flat:
        return [{} for _ in rows]
    host = torch.cat(flat).cpu().numpy()
    out, at = [], 0
    for hists in rows:
        step = {}
        for name, row in hists.items():
            step[name] = {"num": row["num"]}
            for k in _ROW_KEYS:
                n = row[k].numel()
                v = host[at:at + n].reshape(row[k].shape)
                step[name][k] = v.astype(np.int64 if k == "counts"
                                         else np.float32)
                at += n
        out.append(step)
    return out


def grad_histograms(grads: Mapping[str, torch.Tensor],
                    bins: int = 64) -> Dict[str, tuple]:
    """Per-parameter gradient histograms on the host:
    ``{name: (counts, bin_edges)}`` as ``np.histogram`` gives them (one
    copy of each gradient to the host)."""
    return {name: np.histogram(g.detach().cpu().numpy().ravel(), bins=bins)
            for name, g in grads.items()}


class JsonlWriter:
    """An append-only JSON-lines metric stream: one row a ``write``,
    flushed at once."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, row: dict) -> None:
        self._f.write(json.dumps(row, default=float) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
