"""The port's instrumentation against the JAX package's: the gradient
histograms reduced on the device, ``ThroughputMeter``, and the training
CLI's ``--profile_dir``, ``--debug_nans`` and ``--tensorboard``; and the
program's spans and counters (``annotate``, ``count``), which record only
under a ``torch.profiler``, on a tiny group step."""

import contextlib
import glob
import json
import time
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdfn_tpu.runtime import profiling as jprof

from mmdfn_torch.cli import run_train_erc
from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.data.batching import BucketBatcher
from mmdfn_torch.data.datasets import IEMOCAPDataset
from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
from mmdfn_torch.runtime import profiling
from mmdfn_torch.train import Trainer
from mmdfn_torch.train.trainer import prepare_inputs
from mmdfn_torch.train.vmap_sweep import VmapSweep


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors: with several test workers on a few cores, one torch
    # thread per core makes every op wait for the others
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gradients():
    """Leaves as a step gives them, and the cases jnp.histogram treats
    apart: all zeros (min = max: edges a half unit either side), a
    constant, values that fall on edges (an arange), a lone value."""
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((37, 53)).astype(np.float32) * 1e-3,
            "b": rng.standard_normal(200).astype(np.float32),
            "zeros": np.zeros((4, 5), np.float32),
            "const": np.full(7, -2.5, np.float32),
            "ramp": (np.arange(129, dtype=np.float32) - 64.0) / 8.0,
            "one": np.array([3.0], np.float32)}


def assert_same_histogram(values, counts, edges, want_counts, want_edges):
    """Two histograms of ``values``: the edges within 1e-6 of the range's
    magnitude (f32 edge arithmetic may round apart by a few ulps of it:
    XLA fuses ``start (1 - t) + stop t``, torch does not), the counts
    equal but for values that lie between two edges that round apart,
    each of which moves one count between neighbouring bins."""
    values = np.asarray(values, np.float32).ravel()
    edges, want_edges = np.asarray(edges), np.asarray(want_edges)
    scale = max(np.abs(want_edges).max(), 1e-30)
    np.testing.assert_allclose(edges, want_edges, rtol=0, atol=1e-6 * scale)
    apart = edges != want_edges
    between = sum(int(((values >= min(a, b)) & (values <= max(a, b))).sum())
                  for a, b in zip(edges[apart], want_edges[apart]))
    moved = np.abs(np.asarray(counts) - np.asarray(want_counts)).sum()
    assert moved <= 2 * between, (counts, want_counts, between)
    assert np.sum(counts) == np.sum(want_counts) == values.size


@pytest.mark.parametrize("bins", [8, 64])
def test_grad_histograms_device_match_jax(bins):
    grads = _gradients()
    got = profiling.grad_histograms_device(
        {k: torch.from_numpy(v) for k, v in grads.items()}, bins=bins)
    # in one compile, at XLA's CPU backend's lowest optimisation level
    want = jax.jit(partial(jprof.grad_histograms_device, bins=bins),
                   compiler_options=dict(xla_backend_optimization_level=0))(
        {k: jnp.asarray(v) for k, v in grads.items()})
    assert len(got) == len(want) == len(grads)
    for name, v in grads.items():
        g, w = got[name], want[f"['{name}']"]
        assert set(g) == set(w)
        assert g["num"] == int(w["num"]) == v.size
        assert_same_histogram(v, g["counts"].numpy(), g["edges"].numpy(),
                              w["counts"], w["edges"])
        for k in ("min", "max"):
            assert float(g[k]) == float(w[k])
        for k in ("sum", "sum_sq"):
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-6)
    # the one copy to the host keeps every value
    rows = profiling.histograms_to_host([got, got])
    assert len(rows) == 2
    for name, g in got.items():
        h = rows[1][name]
        assert h["num"] == g["num"] and h["counts"].dtype == np.int64
        for k in ("counts", "edges", "min", "max", "sum", "sum_sq"):
            np.testing.assert_array_equal(h[k], g[k].numpy())


def test_throughput_meter_behaves_as_jax():
    for meter in (profiling.ThroughputMeter(), jprof.ThroughputMeter()):
        with meter.step(4, 40):
            time.sleep(0.01)
        with meter.step(4, 32):
            time.sleep(0.01)
        s = meter.summary()
        assert list(s) == ["dialogues", "utterances", "seconds",
                           "dialogues_per_sec", "utterances_per_sec"]
        assert s["dialogues"] == 8 and s["utterances"] == 72
        assert s["seconds"] >= 0.02
        assert abs(meter.dialogues_per_sec - 8 / meter.seconds) < 1e-9
    with pytest.raises(RuntimeError, match="without start"):
        profiling.ThroughputMeter().stop(1, 1)


def test_trace_none_and_no_device_reading():
    with profiling.trace(None):
        pass
    if not torch.cuda.is_available():
        assert profiling.device_time_ms(lambda: None) is None
        assert profiling.device_busy_ms(lambda: None) is None


@pytest.fixture(scope="module")
def pickle_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("iem") / "iem.pkl")
    make_synthetic_iemocap_pickle(path, n_train=5, n_test=2, min_len=3,
                                  max_len=8, seed=5)
    return path


FLAGS = ["--device", "cpu", "--epochs", "1", "--Deep_GCN_nlayers", "1",
         "--reason_flag", "--batch-size", "2", "--buckets", "8"]


def test_trainer_hands_one_histogram_row_per_parameter_per_batch(
        pickle_path):
    cfg = ExperimentConfig(graph_type="GDF", reason_flag=True,
                           Deep_GCN_nlayers=1, epochs=2, batch_size=2,
                           buckets=(8,))
    tr = Trainer(cfg, device="cpu")
    tr.grad_hist_bins = 16
    got = []
    tr.grad_hist_sink = lambda step, hists: got.append((step, hists))
    dias = IEMOCAPDataset(pickle_path, train=True).dialogues()
    tr.fit(dias, IEMOCAPDataset(pickle_path, train=False).dialogues(),
           verbose=False)
    names = [n for n, _ in tr.model.named_parameters()]
    per_epoch = (len(dias) + 1) // 2
    assert [s for s, _ in got] == list(range(1, 2 * per_epoch + 1))
    for _, hists in got:
        assert list(hists) == names
        for name, p in tr.model.named_parameters():
            h = hists[name]
            assert h["num"] == p.numel() == int(h["counts"].sum())
            assert h["edges"].shape == (17,) and h["counts"].shape == (16,)


def test_cli_profile_dir_debug_nans_and_tensorboard(pickle_path, tmp_path,
                                                    monkeypatch):
    """``--profile_dir`` writes a torch.profiler trace; ``--debug_nans``
    runs with autograd's anomaly mode and leaves it off; ``--tensorboard``
    writes one histogram a parameter a batch under its tag."""
    calls = []

    class Writer:
        def add_histogram_raw(self, tag, **kw):
            calls.append((tag, kw))

        def add_scalar(self, *a):
            pass

        def close(self):
            pass

    monkeypatch.setattr(run_train_erc, "_tensorboard_writer",
                        lambda save_dir: Writer())
    seen = []
    fit = Trainer.fit

    def spy(self, *a, **kw):
        seen.append(torch.is_anomaly_enabled())
        return fit(self, *a, **kw)

    monkeypatch.setattr(Trainer, "fit", spy)
    trace_dir = tmp_path / "trace"
    assert run_train_erc.main([
        *FLAGS, "--data_dir", pickle_path, "--save_model_dir",
        str(tmp_path / "ckpt"), "--profile_dir", str(trace_dir),
        "--debug_nans", "--tensorboard"]) == 0
    assert seen == [True] and not torch.is_anomaly_enabled()
    traces = glob.glob(str(trace_dir / "*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(Path(traces[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    model = Trainer(run_train_erc.config_from_args(
        run_train_erc.build_parser().parse_args(FLAGS)), device="cpu").model
    names = ["grad/" + n.replace(".", "/")
             for n, _ in model.named_parameters()]
    batches = (5 + 1) // 2
    assert [t for t, _ in calls] == names * batches
    steps = sorted({kw["global_step"] for _, kw in calls})
    assert steps == list(range(1, batches + 1))
    tag, kw = calls[0]
    assert len(kw["bucket_limits"]) == len(kw["bucket_counts"]) == \
        run_train_erc.GRAD_HIST_BINS
    assert sum(kw["bucket_counts"]) == kw["num"]


@pytest.fixture(scope="module")
def group_step(pickle_path):
    """One step and one evaluation of a group of 2 (1 layer, B = 4, bucket
    8) on the CPU, without a profiler and under one: for each, the step's
    batch, the log, the counters and the profiler's range names."""
    cfg = ExperimentConfig(graph_type="GDF", reason_flag=True,
                           Deep_GCN_nlayers=1, batch_size=4, buckets=(8,))
    group = VmapSweep(cfg, [dict(lr=1e-3, l2=1e-4), dict(lr=3e-4, l2=2e-4)],
                      device="cpu")
    cpu = torch.device("cpu")
    train = IEMOCAPDataset(pickle_path, train=True).dialogues()
    test = [(b, prepare_inputs(b, cpu)) for b in BucketBatcher(
        IEMOCAPDataset(pickle_path, train=False).dialogues(), 4, 2,
        (8,)).epoch()]
    runs = {}
    for traced in (False, True):
        profiling.reset()
        with (torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) if traced
              else contextlib.nullcontext()) as prof:
            batch = next(BucketBatcher(train, 4, 2, (8,), shuffle=True,
                                       seed=1).epoch(3))
            group.step(prepare_inputs(batch, cpu), 3, 0, [True, True])
            group.evaluate(test)
        names = {e.name for e in prof.events()} if traced else set()
        runs[traced] = (batch, profiling.spans(), profiling.counters(),
                        names)
    profiling.reset()
    return runs


def test_spans_and_counters_record_nothing_without_a_profiler(group_step):
    _, spans, counters, _ = group_step[False]
    assert spans == []
    assert all(counters.get(n, 0) == 0 for n in ("data.utterances",
                                                 "data.slots"))


def test_group_step_spans_form_the_steps_tree_under_the_profiler(
        group_step):
    """The step's spans hang under ``sweep.step``, the evaluation's read-back
    under ``sweep.evaluate``; each carries the step's (epoch, i), the data
    spans that batch's, and each is also a profiler range of its name."""
    _, spans, _, names = group_step[True]
    by_name = {s.name: s for s in spans}
    assert sorted(by_name) == sorted(
        ["data.collate", "data.to_device", "sweep.step", "sweep.forward",
         "sweep.backward", "sweep.adam", "sweep.evaluate",
         "sweep.readback"])
    assert len(spans) == len(by_name)
    step = by_name["sweep.step"]
    assert step.parent is None and step.attrs == dict(K=2, B=4, L=8)
    for name in ("sweep.forward", "sweep.backward", "sweep.adam"):
        s = by_name[name]
        assert s.parent == step.id
        assert step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
    assert by_name["sweep.readback"].parent == by_name["sweep.evaluate"].id
    assert {s.step for s in spans} == {(3, 0)}
    assert {s.name for s in spans} <= names


def test_data_counters_count_the_batchs_utterances_and_slots(group_step):
    batch, _, counters, _ = group_step[True]
    B, L = batch.umask.shape
    assert counters["data.utterances"] == int(batch.umask.sum()) > 0
    assert counters["data.slots"] == B * L == 4 * 8
