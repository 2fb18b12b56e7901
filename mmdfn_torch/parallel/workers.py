"""Rank functions of the multi-device checks: ``tests/test_torch_parallel.py``
runs them on CPU ranks against the JAX package, and ``chip_smoke.py``'s
parallel phase on ranks that share the card.  They live in the package so
that a spawned rank imports ``mmdfn_torch`` alone.

Start them through :func:`mmdfn_torch.runtime.launch.run`, e.g.
``launch.run(run_jobs, 2, [(trainer_steps, {...}), ...])``: one group of
ranks runs every job in turn, and each job builds the mesh it needs over
that group.  Inputs and results are numpy arrays, CPU tensors and plain
data.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmdfn_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS, make_mesh

Job = Tuple[Callable, dict]


def run_jobs(jobs: Sequence[Job]) -> List[object]:
    """Every job ``fn(**kwargs)`` in turn on this rank; their results."""
    return [fn(**kw) for fn, kw in jobs]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def graph_products(adj: np.ndarray, h: np.ndarray, h0: np.ndarray,
                   W: np.ndarray, W_plain: np.ndarray, theta: np.ndarray,
                   alpha: float, adj_b: Sequence[np.ndarray],
                   h_b: Sequence[np.ndarray], g_b: Sequence[np.ndarray]
                   ) -> Dict[str, object]:
    """On a (1, world) mesh: this rank's row blocks of ``sharded_spmm`` and
    of ``sharded_gcnii_stack`` (variant with ``W``, else ``W_plain``), and
    for each batched case the hook's whole product with the gradients of
    ``sum(out * g)`` by ``adj`` and ``h``, beside the dense ``bmm``'s."""
    from mmdfn_torch.parallel import (sharded_gcnii_stack, sharded_spmm,
                                      sharded_spmm_batched)

    mesh = make_mesh(1, torch.distributed.get_world_size())
    T = torch.from_numpy
    out: Dict[str, object] = {"rank": mesh.get_local_rank(MODEL_AXIS)}
    out["spmm"] = _np(sharded_spmm(mesh, T(adj), T(h)))
    out["stack"] = _np(sharded_gcnii_stack(mesh, T(adj), T(h), T(h0), T(W),
                                           T(theta), alpha, variant=True))
    out["stack_plain"] = _np(sharded_gcnii_stack(
        mesh, T(adj), T(h), T(h0), T(W_plain), T(theta), alpha,
        variant=False))
    batched = []
    for a, x, g in zip(adj_b, h_b, g_b):
        case = {}
        for name, fn in (("hook", lambda p, q: sharded_spmm_batched(
                mesh, p, q)), ("dense", torch.bmm)):
            p = T(a).requires_grad_()
            q = T(x).requires_grad_()
            y = fn(p, q)
            (y * T(g)).sum().backward()
            case[name] = (_np(y), _np(p.grad), _np(q.grad))
        batched.append(case)
    out["batched"] = batched
    return out


def mmgcn_forward(kwargs: dict, state_dict: Dict[str, torch.Tensor],
                  feats: Dict[str, np.ndarray], qmask: np.ndarray,
                  umask: np.ndarray) -> np.ndarray:
    """``MMGCN(**kwargs)`` with the node-sharded product on a (1, world)
    mesh, from ``state_dict``: its output on this rank."""
    from functools import partial

    from mmdfn_torch.models.mm_gcn import MMGCN
    from mmdfn_torch.parallel import sharded_spmm_batched

    mesh = make_mesh(1, torch.distributed.get_world_size())
    model = MMGCN(**kwargs, spmm=partial(sharded_spmm_batched, mesh))
    model.load_state_dict(state_dict)
    T = torch.from_numpy
    with torch.no_grad():
        out = model({m: T(v) for m, v in feats.items()}, T(qmask),
                    T(umask))
    return _np(out)


def _collective_host_ms(prof) -> float:
    """Host ms in the process group's collectives of a profiled window."""
    return sum(e.cpu_time_total for e in prof.key_averages()
               if e.key.startswith(("c10d::", "nccl:", "gloo:"))) / 1e3


def trainer_steps(cfg, n_data: int, n_model: int, batches: Sequence,
                  seeds: Sequence[int], device: str = "cpu",
                  model: Optional[torch.nn.Module] = None,
                  profile: bool = False, logits_seed: Optional[int] = None,
                  record_relu: bool = False) -> Dict[str, object]:
    """``Trainer(cfg, mesh=make_mesh(n_data, n_model))`` (``DailyTrainer``
    for DailyDialogue; on ``model`` where given, a mesh without a model
    axis, else on the config's model from ``cfg.seed``) takes one step on
    each of ``batches`` (host batches; each rank takes its block) with the
    step seeds ``seeds``.  Returns this rank's mesh coordinates, the
    steps' losses and wall ms (each ended by a synchronize on a card), the
    first step's gradients, the launch counts of the steps; with
    ``profile`` one more step's device busy ms
    (``profiling.device_time_ms``) and the host ms of its collectives;
    with ``logits_seed`` the training forward's log-probs of the first
    batch's block under that step seed, taken before the steps; with
    ``record_relu`` the first step's ReLU decisions in each node-sharded
    GCNII stack (``GCNIIStack.relu_inputs``), a list of layer masks a
    stack."""
    from mmdfn_torch import ops
    from mmdfn_torch.nn.gcn import GCNIIStack
    from mmdfn_torch.train import DailyTrainer, Trainer

    mesh = make_mesh(n_data, n_model)
    cls = DailyTrainer if cfg.dataset == "DailyDialogue" else Trainer
    tr = cls(cfg, device=device, model=model, mesh=mesh)
    cuda = tr.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out: Dict[str, object] = {"data_rank": mesh.get_local_rank(DATA_AXIS),
                              "model_rank": mesh.get_local_rank(MODEL_AXIS)}
    if logits_seed is not None:
        gen = torch.Generator(device=tr.device)
        gen.manual_seed(tr.rank_seed(logits_seed))
        with torch.no_grad():
            out["logits"] = _np(tr._forward(tr._put(batches[0]), train=True,
                                            generator=gen))
    stacks = [m for m in tr.model.modules()
              if isinstance(m, GCNIIStack) and m.spmm is not None]
    for m in stacks if record_relu else ():
        m.relu_inputs = []
    losses, walls = [], []
    ops.reset_launch_counts()
    for i, (batch, seed) in enumerate(zip(batches, seeds)):
        inputs = tr._put(batch)
        sync()
        t0 = time.perf_counter()
        loss, _ = tr.train_step(inputs, seed)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if i == 0:
            out["grads"] = {n: _np(p.grad)
                            for n, p in tr.model.named_parameters()}
            if record_relu:
                out["relu_decisions"] = [[_np(pre > 0) for pre in
                                          m.relu_inputs] for m in stacks]
                for m in stacks:
                    m.relu_inputs = None
    out.update(losses=losses, step_ms=walls, launches=ops.launch_counts())
    if profile and cuda:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        from mmdfn_torch.runtime.profiling import device_time_ms

        inputs = tr._put(batches[0])
        busy, window = device_time_ms(lambda: tr.train_step(inputs, seeds[0]))
        with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
            tr.train_step(inputs, seeds[0])
            sync()
        out.update(busy_ms=busy, window_ms=window,
                   collective_host_ms=_collective_host_ms(prof))
    return out


def sweep_group(base_cfg, combos: Sequence[dict], train, test, n_data: int,
                device: str = "cpu"):
    """The group ``combos`` (``VmapSweep``) with its configs over the
    ``n_data`` ranks of a data mesh; the ``GroupResult``, on every rank."""
    from mmdfn_torch.train.vmap_sweep import VmapSweep

    mesh = make_mesh(n_data)
    return VmapSweep(base_cfg, combos, device=device, mesh=mesh).run(
        train, test, verbose=False)
