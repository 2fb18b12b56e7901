"""The readers of the program's own spans and counters
(``mmdfn_torch/runtime/profiling.py``): kernels A's and C's operation and
byte counts give the bounds PERF.md's kernel table states at their shapes,
and the config axis multiplies them; each reader gives its value on a
made-up log, and nothing on an empty one or where the program has no log
(a tree before the recorder)."""

import importlib.util
from pathlib import Path

import pytest

METRICS = Path(__file__).resolve().parent.parent / "metrics"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("metric,B,L,mode,ms", [
    ("kernel_a_roofline", 192, 80, "f32", 0.028060657),
    ("kernel_a_roofline", 864, 33, "f32", 0.052087594),
    ("kernel_a_roofline", 192, 80, "bf16_scan", 0.0073906388),
    ("kernel_c_roofline", 192, 80, "f32", 0.056671522),
    ("kernel_c_roofline", 864, 33, "f32", 0.10519651),
    ("kernel_c_roofline", 192, 80, "bf16_scan", 0.020265027),
])
def test_bigru_bounds_match_the_kernel_table(metric, B, L, mode, ms):
    m = _load(metric)
    assert m.bound_s(1, B, L, mode=mode) * 1e3 == pytest.approx(ms, rel=1e-7)
    assert m.bound_s(16, B, L, mode=mode) == pytest.approx(
        16 * m.bound_s(1, B, L, mode=mode))


def _span(name, i, step, ms, **attrs):
    from mmdfn_torch.runtime.profiling import Span

    return Span(name, i, None, step, 10 ** 9 * i, 10 ** 9 * i + int(ms * 1e6),
                attrs)


RNN = dict(H=100, G=300, mode="f32")
LOG = [_span("data.collate", 1, (0, 3), 2.0),
       _span("data.to_device", 2, (0, 3), 0.5),
       _span("sweep.step", 3, (0, 3), 40.0, K=16, B=32, L=96),
       _span("data.collate", 4, (0, 4), 3.0),
       _span("data.to_device", 5, (0, 4), 1.5),
       _span("sweep.step", 6, (0, 4), 50.0, K=16, B=32, L=96),
       _span("data.collate", 7, (0, 5), 1.0),
       _span("data.to_device", 8, (0, 5), 0.25),
       _span("sweep.step", 9, (0, 5), 45.0, K=16, B=32, L=64),
       _span("ops.bigru_fwd", 10, (0, 5), 0.1, K=16, B=32, L=64,
             train=True, **RNN),
       _span("ops.bigru_fwd", 11, (0, 5), 0.1, K=16, B=96, L=64,
             train=False, **RNN),
       _span("ops.bigru_bwd", 12, (0, 5), 0.1, K=16, B=32, L=64, **RNN),
       # a collate of no group step in the log (the test split's)
       _span("data.collate", 13, (0, 0), 9.0)]
COUNTS = {"data.utterances": 3 * 1500, "data.slots": 3 * 32 * 64}
TRACE = {"by_label": {"bigru_fwd_kernel<4, false, float>": 0.002,
                      "bigru_bwd_kernel<4, false, float>": 0.003,
                      "bigru_wgrad_kernel": 0.0005,
                      "bigru_wgrad_reduce": 0.0005,
                      "gcnii_bwd P1Gates": 0.5}}


def _by_hand(metric):
    a, c = _load("kernel_a_roofline"), _load("kernel_c_roofline")
    return {
        "host.enqueue_ms": 45.0,
        "data.batch_ms": 2.5,
        "data.pad_pct": 100 * (1 - 4500 / 6144),
        "kernel_a_roofline": 100 * (a.bound_s(16, 32, 64, train=True)
                                    + a.bound_s(16, 96, 64)) / 0.002,
        "kernel_c_roofline": 100 * c.bound_s(16, 32, 64) / 0.004,
    }[metric]


@pytest.mark.parametrize("metric", ["host.enqueue_ms", "data.batch_ms",
                                    "data.pad_pct", "kernel_a_roofline",
                                    "kernel_c_roofline"])
def test_span_readers_on_a_made_up_log(metric, monkeypatch):
    from mmdfn_torch.runtime import profiling

    read = _load(metric).read
    ctx = {"trace": TRACE}
    monkeypatch.setattr(profiling, "spans", lambda: list(LOG))
    monkeypatch.setattr(profiling, "counters", lambda: dict(COUNTS))
    assert read(ctx) == pytest.approx(_by_hand(metric), rel=1e-12)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert read(ctx) is None
    # a program without the log (the parent of the recorder) reads nothing
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counters")
    assert read(ctx) is None
