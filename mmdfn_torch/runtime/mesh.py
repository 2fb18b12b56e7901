"""The device mesh and its collectives (``mmdfn_tpu/runtime/mesh.py``),
over a ``torch.distributed`` process group that is already up
(:mod:`mmdfn_torch.runtime.launch` starts one).

The JAX package keeps its whole mesh in one process, and GSPMD inserts
every collective.  Here each rank is a process, and the collectives are
explicit:

* a 2-D ``DeviceMesh`` with a ``data`` axis and a ``model`` axis
  (``init_device_mesh``; the JAX mesh's ``(DATA_AXIS, MODEL_AXIS)``);
* batches shard on their leading (dialogue) axis over ``data``: each rank
  holds a contiguous block of ``B / n_data`` dialogues, JAX's ``P("data")``
  layout.  The MM-DFN adjacency is block-diagonal per dialogue, so data
  parallelism is exact graph parallelism;
* parameters are replicated: a broadcast from the mesh's first rank
  (:func:`replicate`), and the trainer sums the gradients over ``data``.

The collectives below take the group of one mesh axis: gloo's (the CPU
ranks, and ranks that share one card) or NCCL's (one rank a card).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

Tensor = torch.Tensor


def make_mesh(n_data: Optional[int] = None, n_model: int = 1):
    """A ``(data, model)`` ``DeviceMesh`` over every rank of the process
    group that is already up; ``n_data`` defaults to the world size over
    ``n_model``.  Its device kind is the group's: ``cuda`` on NCCL, else
    ``cpu`` (gloo's groups, whose collectives take host tensors and, for
    ranks that share a card, the card's tensors where they lie).

    Raises:
      ValueError: the world size is not ``n_data * n_model``.
      RuntimeError: no process group is up.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start the ranks "
                           "with mmdfn_torch.runtime.launch.run or torchrun")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    need = n_data * n_model
    if world != need:
        raise ValueError(
            f"mesh needs n_data*n_model={need} ranks, found {world}; start "
            f"{need} ranks (mmdfn_torch.runtime.launch.run)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def shard_batch(mesh, batch):
    """This rank's contiguous block of ``B / n_data`` dialogues of a batch:
    of every array or tensor of a mapping, or of a batch dataclass
    (``Batch``, ``TokenBatch``; other fields, such as the ids, are kept
    whole).  Sharding a host batch before it is copied to the card copies
    each rank's block alone."""
    n, r = mesh[DATA_AXIS].size(), mesh.get_local_rank(DATA_AXIS)

    def block(k, v):
        if not isinstance(v, (np.ndarray, Tensor)):
            return v
        B = v.shape[0]
        if B % n:
            raise ValueError(f"{k}: batch of {B} does not split over the "
                             f"mesh data axis ({n} ranks)")
        blk = B // n
        return v[r * blk:(r + 1) * blk]

    if dataclasses.is_dataclass(batch):
        return dataclasses.replace(batch, **{
            f.name: block(f.name, getattr(batch, f.name))
            for f in dataclasses.fields(batch)})
    return {k: block(k, v) for k, v in batch.items()}


def replicate(mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``module``, in place, as the mesh's
    first rank holds it (one broadcast of a flat buffer a dtype)."""
    src = int(mesh.mesh.flatten()[0])
    by_dtype: Dict[torch.dtype, list] = {}
    for t in list(module.parameters()) + list(module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in ts])
            dist.broadcast(flat, src=src)
            offset = 0
            for t in ts:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n
    return module


def is_first_rank() -> bool:
    """Rank 0 of the process group, or no group at all: the one rank that
    writes checkpoints, logs and prints."""
    return not dist.is_initialized() or dist.get_rank() == 0


# --------------------------------------------------------------------------
# collectives that allocate their output, over one axis's group; gloo (the
# CPU ranks, and ranks that share one card) and NCCL both take the tensors
# where they lie: gloo of torch 2.11 took CUDA tensors for these, and for
# all_reduce and broadcast, on the H100's machine

def all_gather(t: Tensor, group=None) -> Tensor:
    """The group's ``t``, concatenated along dim 0 in rank order."""
    n = dist.get_world_size(group)
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def reduce_scatter(t: Tensor, group=None) -> Tensor:
    """The sum of the group's ``t``, this rank's block of dim 0 (``t``'s
    dim 0 splits evenly over the group, in rank order)."""
    n = dist.get_world_size(group)
    out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
    dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
    return out
