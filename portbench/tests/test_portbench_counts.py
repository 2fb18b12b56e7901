"""Kernels B's and D's operation and byte counts (the roofline readers'
own copies) give the bounds PERF.md's kernel table states at their
shapes, and the config axis multiplies them."""

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


@pytest.mark.parametrize("metric,B,N,nl,ms", [
    ("kernel_d_roofline", 32, 240, 16, 1.3718543),
    ("kernel_b_roofline", 32, 240, 16, 0.45850746),
    ("kernel_d_roofline", 32, 99, 64, 2.0075474),
    ("kernel_b_roofline", 32, 99, 64, 0.67119990),
])
def test_bounds_match_the_kernel_table(metric, B, N, nl, ms):
    got = _load(metric).bound_s(1, B, N, nl) * 1e3
    assert got == pytest.approx(ms, rel=1e-7)


@pytest.mark.parametrize("metric", ["kernel_d_roofline",
                                    "kernel_b_roofline"])
def test_config_axis_multiplies_the_bound(metric):
    m = _load(metric)
    assert m.bound_s(16, 32, 288, 16) == pytest.approx(
        16 * m.bound_s(1, 32, 288, 16))


def test_roofline_reads_nothing_without_kernel_time():
    m = _load("kernel_d_roofline")
    ctx = dict(trace=dict(by_label={"gcnii_fwd F2Hi": 1.0}), K=16,
               cfg={"model": {"Deep_GCN_nlayers": 16, "reason_flag": True}},
               prof_units=[("step", 32, 96)])
    assert m.read(ctx) is None
    ctx["trace"]["by_label"]["gcnii_bwd P2Hi"] = 0.5
    assert m.read(ctx) == pytest.approx(
        100 * m.bound_s(16, 32, 288, 16) / 0.5)
