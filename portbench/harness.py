"""One run of one cell: set-up, the measured window, the traced sub-window,
the check against the reference, and the result line.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<traffic>.json``, its limits in ``limits/<cell>.json``, each
per-layer metric's reader in ``metrics/<metric>.py``.

The loop (traffic ``"loop": "group_sweep"``) is ``VmapSweep.run``'s:
every configuration of the group active, each epoch's training batches
through ``VmapSweep.step``, then ``VmapSweep.evaluate`` over the test
split, and the epoch's losses read back once; no checkpoint.  Set-up
builds the group, evaluates it at the starting weights and drives its
first ``check_steps`` steps (epoch 0's first batches), recording what the
check compares, then one step at each bucket the window will meet that
those did not; the window goes on from there.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional


HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mmdfn_tpu")
# the host's share: one process, few threads (the card does the work)
HOST_THREADS = 4


def load_json(root: Path, kind: str, name: str) -> dict:
    with open(root / kind / f"{name}.json") as f:
        return json.load(f)


def load_reader(root: Path, metric: str) -> Callable:
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class _Init:
    """The starting weights as ``VmapSweep(model=)`` reads them."""

    def __init__(self, state: Dict):
        self._state = state

    def state_dict(self):
        return self._state


def _since_process_start() -> Optional[float]:
    """Seconds since this process started, from /proc (Linux)."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def _evaluate_logp(sweep, test_batches) -> list:
    """``sweep.evaluate`` over the test batches, and the log-probs (K, B, L,
    C) of each batch that its batched eval step computed on the way."""
    got = []
    real = sweep._batched

    def keep(inputs, train, generator=None):
        out = real(inputs, train, generator)
        got.append(out[1].detach().clone())
        return out
    sweep._batched = keep
    try:
        sweep.evaluate(test_batches)
    finally:
        del sweep._batched
    return [g.cpu().numpy() for g in got]


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str, root: Path = HERE, per_layer: Optional[list] = None,
             t_start: Optional[float] = None,
             fault: Optional[str] = None) -> dict:
    """One run; returns the result dict.  ``cell``: name, config, traffic;
    ``per_layer``: the per-layer metrics (name, unit) this cell reports
    under ``trace``; ``t_start``: ``time.perf_counter()`` at process
    start, where /proc cannot tell; ``fault``: a planted fault, for the harness's own
    tests (``"frozen"``: the step leaves the state as it was;
    ``"half_batch"``: the step sees half of the batch; ``"answer"``: an
    evaluation log-prob altered)."""
    import torch

    from mmdfn_torch.config import ExperimentConfig
    from mmdfn_torch.data.batching import BucketBatcher
    from mmdfn_torch.models import from_config
    from mmdfn_torch.train.trainer import prepare_inputs
    from mmdfn_torch.train.vmap_sweep import VmapSweep

    from portbench import check, data, follow
    from portbench import trace as tr
    from portbench.reference import batches as rb
    from portbench.reference import model as M
    from portbench.reference import train as rt

    t_proc = time.perf_counter()
    started = _since_process_start()
    elapsed = (lambda: time.perf_counter() - t_proc + started) \
        if started is not None else (lambda: time.perf_counter() - t_start)
    conf = load_json(root, "configs", cell["config"])
    traffic = load_json(root, "traffic", cell["traffic"])
    limits = load_json(root, "limits", cell["name"])
    if traffic["loop"] != "group_sweep":
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.set_num_threads(HOST_THREADS)
    if cuda:
        from mmdfn_torch.ops import _build
        _build.build_all()

    model_kw = dict(conf["model"])
    bs = int(traffic["batch_size"])
    cfg = ExperimentConfig(**{**model_kw, "buckets": tuple(
        model_kw.get("buckets", ExperimentConfig.buckets))},
        seed=int(seed), batch_size=bs)
    info = cfg.info
    K = int(traffic["K"])
    combos = follow.group_combos(conf["grid"], K,
                                 int(traffic.get("group", 0)))
    train, test = follow.split(conf, seed)
    shapes = M.param_shapes(conf["widths"], cfg.Deep_GCN_nlayers)
    with torch.device("meta"):
        theirs = {n: tuple(t.shape) for n, t in
                  from_config(cfg).state_dict().items()}
    if list(theirs.items()) != list(shapes.items()):
        raise RuntimeError("the program's parameters are not the "
                           "configuration's: " + str(set(theirs.items())
                                                     ^ set(shapes.items())))
    p0 = data.weights(shapes, seed, dev)
    sweep = VmapSweep(cfg, combos, device=dev, model=_Init(p0))
    if fault == "frozen":
        sweep.adam.step = lambda active: None
    if fault == "half_batch":
        real_step = sweep.step

        def half_step(inputs, epoch, i, active):
            inputs = dict(inputs, umask=inputs["umask"].clone())
            inputs["umask"][inputs["umask"].shape[0] // 2:] = 0.0
            return real_step(inputs, epoch, i, active)
        sweep.step = half_step
    test_batches = [(b, prepare_inputs(b, dev, cfg.transfer_dtype)) for b in
                    BucketBatcher(test, bs, info["n_speakers"],
                                  cfg.buckets).epoch()]
    shuffle_seed = int(traffic["shuffle_seed"])
    batcher = BucketBatcher(train, bs, info["n_speakers"], cfg.buckets,
                            shuffle=True, seed=shuffle_seed)
    active = [True] * K
    names = list(sweep.params)

    # the evaluation at the starting weights, then the checked steps:
    # epoch 0's first batches, through the window's calls
    eval0 = _evaluate_logp(sweep, test_batches)
    n_check = int(traffic["check_steps"])
    epoch0 = batcher.epoch(0)
    prog_loss, seen = [], set()
    for i in range(n_check):
        b = next(epoch0)
        seen.add(b.umask.shape[1])
        losses = sweep.step(prepare_inputs(b, dev, cfg.transfer_dtype), 0, i,
                            active)
        prog_loss.append(torch.stack(losses))
        with torch.no_grad():
            if i == 0:
                # Adam's first moment after one step is (1 - beta1) g
                g_norm = torch.stack([
                    (sweep.adam.exp_avg[j].flatten(1) / (1 - rt.BETAS[0]))
                    .double().norm(dim=1) for j in range(len(names))], 1)
        if i == n_check - 1:
            with torch.no_grad():
                c_norm = torch.stack([
                    (sweep.params[n].detach() - p0[n]).flatten(1).double()
                    .norm(dim=1) for n in names], 1)
    if fault == "answer":
        eval0[0][0, 0, 0] += 0.5
    prog = dict(loss=torch.stack(prog_loss, 1).double().cpu().numpy(),
                grad=g_norm.cpu().numpy(), change=c_norm.cpu().numpy(),
                eval0_logp=eval0)

    # warm-up: one step at each bucket the window can meet that the
    # checked steps did not (the batches' order is known beforehand)
    lens = [len(d) for d in train]
    plan = {}
    for e in range(int(traffic["warm_epochs"])):
        for i, (_, L) in enumerate(rb.schedule(lens, bs, cfg.buckets,
                                               shuffle_seed, e)):
            plan.setdefault(L, (e, i))
    for L, (e, i) in sorted(plan.items()):
        if L in seen:
            continue
        for j, b in enumerate(batcher.epoch(e)):
            if j == i:
                sweep.step(prepare_inputs(b, dev, cfg.transfer_dtype), e, i,
                           active)
                seen.add(L)
                break
    if cuda:
        torch.cuda.synchronize()
    setup_s = elapsed()

    # the window: from epoch 0's batch n_check on, in run()'s order
    def units():
        e = 0
        while True:
            for i, b in enumerate(batcher.epoch(e)):
                if e > 0 or i >= n_check:
                    yield "step", e, i, b
            yield "eval", e, None, None
            e += 1

    rf = torch.profiler.record_function
    ev = (lambda: torch.cuda.Event(enable_timing=True)) if cuda else None
    trace_skip = int(traffic["trace_skip"])
    trace_units = int(traffic["trace_units"])
    step_ev, eval_ev, log_units, prof_units = [], [], [], []
    epoch_losses, all_losses = [], []
    unwarmed, n_dialogues, n_steps, n_evals = 0, 0, 0, 0
    prof = prof_ev = inputs = None
    sched = units()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    u = 0
    while True:
        profiling = trace and cuda and trace_skip <= u < trace_skip \
            + trace_units
        if trace and cuda and u == trace_skip:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            prof_ev = [ev(), ev()]
            prof_ev[0].record()
        with rf("portbench.batch"):
            kind, e, i, b = next(sched)
            if kind == "step":
                inputs = prepare_inputs(b, dev, cfg.transfer_dtype)
        if kind == "step":
            L = b.umask.shape[1]
            unwarmed += L not in seen
            pair = [ev(), ev()] if trace and cuda else None
            with rf("portbench.step"):
                if pair:
                    pair[0].record()
                losses = sweep.step(inputs, e, i, active)
                if pair:
                    pair[1].record()
                    step_ev.append(pair)
            epoch_losses.append(torch.stack(losses))
            n_dialogues += len(b.vids)
            n_steps += 1
            unit = ("step", bs, L)
        else:
            pair = [ev(), ev()] if trace and cuda else None
            with rf("portbench.evaluate"):
                if pair:
                    pair[0].record()
                sweep.evaluate(test_batches)
                if pair:
                    pair[1].record()
                    eval_ev.append(pair)
            if epoch_losses:
                all_losses.append(torch.stack(epoch_losses).cpu())
                epoch_losses = []
            n_evals += 1
            unit = ("eval", [(bs, tb.umask.shape[1]) for tb, _ in
                             test_batches])
        log_units.append(unit)
        if profiling:
            prof_units.append(unit)
        u += 1
        if profiling and u == trace_skip + trace_units:
            prof_ev[1].record()
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        done_tracing = not (trace and cuda) or u >= trace_skip + trace_units
        if time.perf_counter() >= deadline and done_tracing:
            break
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    if epoch_losses:
        all_losses.append(torch.stack(epoch_losses).cpu())
    window_losses = torch.cat(all_losses) if all_losses else torch.zeros(0)
    failed = int((~torch.isfinite(window_losses)).sum())
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded after the window: {found}")
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0

    metrics = {}
    breakdown = None
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    if not trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        metrics["train_dialogues_per_s"] = {
            "value": K * n_dialogues / window_s, "unit": "dialogues/s"}
    ctx = dict(cfg=conf, traffic=traffic, K=K, window_s=window_s,
               units=log_units, prof_units=prof_units,
               step_ms=[a.elapsed_time(b) for a, b in step_ev],
               eval_ms=[a.elapsed_time(b) for a, b in eval_ev])
    if trace and cuda:
        dev_events, host = tr.from_profiler(prof)
        summary = tr.reduce(dev_events, host,
                            prof_ev[0].elapsed_time(prof_ev[1]) / 1e3)
        ctx["trace"] = summary
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        breakdown = summary["breakdown"]
        del prof
    # the program's state goes before the reference runs
    del sweep, test_batches, inputs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if trace:
        for name, unit in per_layer or []:
            value = load_reader(root, name)(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
    ref = follow.run(conf, traffic, seed, dev)
    nums = check.numbers(prog, ref, ref["umasks"])
    correct = check.verdict(nums, limits) and failed == 0
    out = {"correct": bool(correct), "attempted": K * n_steps,
           "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["window"] = {"steps": n_steps, "evaluations": n_evals,
                     "dialogues": n_dialogues, "seconds": window_s,
                     "unwarmed_steps": unwarmed}
    out["numbers"] = nums
    out["checks"] = check.report(nums, limits)
    return out
