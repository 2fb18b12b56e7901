"""Training checkpoints (``mmdfn_tpu/runtime/checkpoint.py``): the model's
state_dict, the optimiser's state and a plain-data ``meta`` dict, written
with ``torch.save`` under ``<save_dir>/<name>.pt`` and read back with
``weights_only`` loading (tensors and plain data only)."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch


def _path(save_dir: str, name: str) -> str:
    return os.path.join(save_dir, f"{name}.pt")


def has_checkpoint(save_dir: str, name: str = "best") -> bool:
    return os.path.exists(_path(save_dir, name))


def save_checkpoint(save_dir: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    meta: Optional[dict] = None, name: str = "best") -> str:
    """Write atomically (a temporary file, then a rename)."""
    os.makedirs(save_dir, exist_ok=True)
    path = _path(save_dir, name)
    blob = {"model": {k: v.detach().cpu()
                      for k, v in model.state_dict().items()},
            "optimizer": None if optimizer is None else optimizer.state_dict(),
            "meta": dict(meta or {})}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def read_meta(save_dir: str, name: str = "best") -> dict:
    return torch.load(_path(save_dir, name), map_location="cpu",
                      weights_only=True)["meta"]


def restore_checkpoint(save_dir: str, model: torch.nn.Module,
                       optimizer: Optional[torch.optim.Optimizer] = None,
                       name: str = "best") -> Tuple[torch.nn.Module, dict]:
    """Load the weights (strictly) and, if given, the optimiser state in
    place; returns (model, meta)."""
    blob = torch.load(_path(save_dir, name), map_location="cpu",
                      weights_only=True)
    model.load_state_dict(blob["model"])
    if optimizer is not None and blob["optimizer"] is not None:
        optimizer.load_state_dict(blob["optimizer"])
    return model, blob["meta"]
