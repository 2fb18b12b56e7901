"""The trace's arithmetic: the interval union, the gaps named by the host
range, the labels of kernels B and D."""

import pytest

from portbench import trace


def test_union_counts_overlaps_once():
    assert trace.union_s([(0, 10), (5, 20), (30, 40)]) == pytest.approx(
        30e-6)
    assert trace.union_s([]) == 0.0


def test_gaps_named_by_the_innermost_open_range():
    dev = [("a", 0, 10), ("b", 15, 20), ("c", 50, 60)]
    host = [("portbench.step", 0, 30), ("portbench.batch", 18, 40)]
    s = trace.reduce(dev, host, 60e-6)
    assert s["busy_s"] == pytest.approx(25e-6)
    assert s["breakdown"]["idle_gaps"] == [
        ["portbench.batch", pytest.approx(30e-6)],
        ["portbench.step", pytest.approx(5e-6)]]


def test_kernel_labels():
    assert trace.kernel_label(
        "void gemm_f32<(anonymous namespace)::P2Hi, 64>(float*)") \
        == "gcnii_bwd P2Hi"
    assert trace.kernel_label("void gemm<F3Update>(x)") == "gcnii_fwd F3Update"
    s = trace.reduce([("void gemm<F3Update>(x)", 0, 4),
                      ("void gemm<P3Pre>(x)", 4, 10)], [], 1e-5)
    assert trace.seconds_of(s, "gcnii_fwd") == pytest.approx(4e-6)
    assert trace.seconds_of(s, "gcnii_bwd") == pytest.approx(6e-6)
