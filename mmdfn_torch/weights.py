"""Weights: the JAX parameter tree -> the port's state_dict, and the port's
own checkpoint format.

The port's parameter names are the reference ``DialogueGNNModel``
state_dict keys, so ``mmdfn_tpu/tools/import_torch_checkpoint.py``
``state_dict_to_params`` inverts :func:`params_from_jax` with no mapping
code of its own.
"""

from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.models import DialogueGNN
from mmdfn_torch.runtime import checkpoint as ckpt_lib


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def gru_from_jax(p: Mapping) -> "OrderedDict":
    """A JAX ``BiRNN`` (GRU) parameter dict -> ``nn.GRU`` state_dict keys."""
    sd: "OrderedDict" = OrderedDict()
    layers = sorted({int(k.split("_l")[1].split("_")[0]) for k in p})
    for layer in layers:
        for d, suf in (("fwd", ""), ("bwd", "_reverse")):
            ours = f"l{layer}_{d}"
            sd[f"weight_ih_l{layer}{suf}"] = _t(p[f"w_ih_{ours}"]).t()
            sd[f"weight_hh_l{layer}{suf}"] = _t(p[f"w_hh_{ours}"]).t()
            sd[f"bias_ih_l{layer}{suf}"] = _t(p[f"b_ih_{ours}"])
            sd[f"bias_hh_l{layer}{suf}"] = _t(p[f"b_hh_{ours}"])
    return sd


def _linear(sd: "OrderedDict", prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["kernel"]).t()
    sd[f"{prefix}.bias"] = _t(p["bias"])


def gcnii_from_jax(g: Mapping) -> "OrderedDict":
    """A JAX ``GCNIIStack`` parameter dict -> the port's ``GCNIIStack``
    state_dict keys (``fcs.0``, ``convs.{i}``, ``rnn``)."""
    sd: "OrderedDict" = OrderedDict()
    _linear(sd, "fcs.0", g["fc_in"])
    for i, w in enumerate(np.asarray(g["conv_w"])):
        sd[f"convs.{i}.weight"] = _t(w)
    if "reason_w_ih" in g:
        sd["rnn.weight_ih_l0"] = _t(g["reason_w_ih"]).t()
        sd["rnn.weight_hh_l0"] = _t(g["reason_w_hh"]).t()
        sd["rnn.bias_ih_l0"] = _t(g["reason_b_ih"])
        sd["rnn.bias_hh_l0"] = _t(g["reason_b_hh"])
    return sd


def params_from_jax(params: Mapping[str, Any]) -> "OrderedDict":
    """Map the JAX ``DialogueGNN`` (GF/GDF, base LSTM) parameter tree, a
    nested dict of arrays as ``Trainer.init_state().params`` holds it, onto
    the port's state_dict."""
    sd: "OrderedDict" = OrderedDict()
    for m in "avl":
        if f"linear_{m}" in params:
            _linear(sd, f"linear_{m}", params[f"linear_{m}"])
    for name in ("lstm_l", "rnn_parties"):
        if name in params:
            for k, v in gru_from_jax(params[name]).items():
                sd[f"{name}.{k}"] = v
    for k, v in gcnii_from_jax(params["graph_model"]["graph_net"]).items():
        sd[f"graph_model.graph_net.{k}"] = v
    _linear(sd, "smax_fc", params["smax_fc"])
    return OrderedDict((k, v.contiguous()) for k, v in sd.items())


def save_model(path: str, cfg: ExperimentConfig, model: torch.nn.Module) -> None:
    """Write ``{config, state_dict}`` with ``torch.save``."""
    torch.save({"config": dataclasses.asdict(cfg),
                "state_dict": {k: v.detach().cpu()
                               for k, v in model.state_dict().items()}}, path)


def _config(saved: Mapping) -> ExperimentConfig:
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    return ExperimentConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                               for k, v in saved.items() if k in fields})


def load_model(path: str) -> Tuple[ExperimentConfig, "OrderedDict"]:
    """Read a file written by :func:`save_model` (tensors and plain data
    only: ``weights_only`` loading)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return _config(blob["config"]), blob["state_dict"]


class CheckpointError(ValueError):
    """A trainer's directory that holds no servable checkpoint."""


def load_served(path: str) -> Tuple[ExperimentConfig, DialogueGNN,
                                      Optional[int]]:
    """The model to serve from ``path``: a directory that
    ``Trainer.fit(save_dir=...)`` wrote (its ``best`` checkpoint, rebuilt
    from the config in its meta and restored strictly), or a file that
    :func:`save_model` wrote.  Returns (config, model, the checkpoint's
    epoch; None for a :func:`save_model` file).

    Raises:
      CheckpointError: a directory without a ``best`` checkpoint, or one whose
        meta holds no config.
    """
    if not os.path.isdir(path):
        cfg, state_dict = load_model(path)
        return cfg, build_model(cfg, state_dict), None
    if not ckpt_lib.has_checkpoint(path, "best"):
        raise CheckpointError(f"no checkpoint under {path!r}")
    # the model is rebuilt from the config it was trained with: flags
    # given to the server could mis-serve it or fail to load its weights
    meta = ckpt_lib.read_meta(path, "best")
    if not meta.get("config"):
        raise CheckpointError(f"the checkpoint under {path!r} has no config in "
                         "its meta; cannot rebuild its model")
    cfg = _config(meta["config"])
    model, _ = ckpt_lib.restore_checkpoint(path, DialogueGNN.from_config(cfg))
    return cfg, model, meta.get("epoch")


def build_model(cfg: ExperimentConfig, state_dict: Optional[Mapping] = None):
    """The config's model: fresh weights drawn from ``cfg.seed``, or
    ``state_dict`` loaded strictly (no missing or extra keys)."""
    model = DialogueGNN.from_config(cfg)
    if state_dict is None:
        model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    else:
        model.load_state_dict(state_dict)
    return model
