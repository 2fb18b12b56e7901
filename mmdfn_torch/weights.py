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

from mmdfn_torch import models
from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.runtime import checkpoint as ckpt_lib


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def gru_from_jax(p: Mapping) -> "OrderedDict":
    """A JAX ``BiRNN`` (GRU or LSTM) parameter dict -> ``nn.GRU`` /
    ``nn.LSTM`` state_dict keys."""
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
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _convs(sd: "OrderedDict", prefix: str, conv_w) -> None:
    """Each layer of ``conv_w``, (nl, 2H, H) or, without the variant,
    (nl, H, H), as ``convs.{i}.weight``."""
    for i, w in enumerate(np.asarray(conv_w)):   # torch.mm's orientation
        sd[f"{prefix}convs.{i}.weight"] = _t(w)


def gcnii_from_jax(g: Mapping, prefix: str = "") -> "OrderedDict":
    """A JAX ``GCNIIStack`` parameter dict -> the port's ``GCNIIStack``
    state_dict keys (``fcs.0``, ``convs.{i}``, ``rnn``) under ``prefix``."""
    sd: "OrderedDict" = OrderedDict()
    _linear(sd, f"{prefix}fcs.0", g["fc_in"])
    _convs(sd, prefix, g["conv_w"])
    if "reason_w_ih" in g:
        sd[f"{prefix}rnn.weight_ih_l0"] = _t(g["reason_w_ih"]).t()
        sd[f"{prefix}rnn.weight_hh_l0"] = _t(g["reason_w_hh"]).t()
        sd[f"{prefix}rnn.bias_ih_l0"] = _t(g["reason_b_ih"])
        sd[f"{prefix}rnn.bias_hh_l0"] = _t(g["reason_b_hh"])
    return sd


def _relation_net(sd: "OrderedDict", prefix: str, g: Mapping) -> None:
    """torch-geometric's orientations: ``basis``, ``att``, ``root`` and
    GraphConv's ``weight`` are (in, out) like the JAX kernels; only
    ``conv2.lin`` is an ``nn.Linear``."""
    c1 = g["conv1"]
    for ours, theirs in (("basis", "basis"), ("comp", "att"),
                         ("root", "root"), ("bias", "bias")):
        sd[f"{prefix}conv1.{theirs}"] = _t(c1[ours])
    sd[f"{prefix}conv2.weight"] = _t(g["conv2"]["nbr"]["kernel"])
    _linear(sd, f"{prefix}conv2.lin", g["conv2"]["root"])
    for conv in ("conv3", "conv4"):
        if conv in g:
            _linear(sd, f"{prefix}{conv}.linear", g[conv])


def _mfn(sd: "OrderedDict", p: Mapping) -> None:
    for m in "lav":
        sd[f"mfn.lstm_{m}.weight_ih"] = _t(p[f"lstm_{m}_w_ih"]).t()
        sd[f"mfn.lstm_{m}.weight_hh"] = _t(p[f"lstm_{m}_w_hh"]).t()
        sd[f"mfn.lstm_{m}.bias_ih"] = _t(p[f"lstm_{m}_b_ih"])
        sd[f"mfn.lstm_{m}.bias_hh"] = _t(p[f"lstm_{m}_b_hh"])
    for fc in ("att1_fc1", "att1_fc2", "att2_fc1", "att2_fc2",
               "gamma1_fc1", "gamma1_fc2", "gamma2_fc1", "gamma2_fc2"):
        _linear(sd, f"mfn.{fc}", {"kernel": p[f"{fc}_kernel"],
                                  "bias": p[f"{fc}_bias"]})


def _dense_tree(sd: "OrderedDict", prefix: str, tree: Mapping) -> None:
    """Subtrees whose names match the reference's: ``{kernel, bias}``
    children are ``nn.Linear``s, bare leaves map as they are."""
    for k, v in tree.items():
        if isinstance(v, Mapping) and "kernel" in v:
            _linear(sd, f"{prefix}{k}", v)
        elif isinstance(v, Mapping):
            _dense_tree(sd, f"{prefix}{k}.", v)
        else:
            sd[f"{prefix}{k}"] = _t(v)


# the JAX DialogueRNN cell's attention parameters -> the reference's
_DIALOGUE_ATT = {"att_scalar": "scalar", "att_transform": "transform",
                 "att_vector": "vector_prod"}


def _dialogue_rnn(sd: "OrderedDict", name: str, p: Mapping) -> None:
    """A JAX ``DialogueRNN`` (its ``nn.scan`` step named ``cell``) ->
    ``{name}.dialogue_cell.{g,p,e,l}_cell`` (``nn.GRUCell`` keys) and
    ``.attention``."""
    pre = f"{name}.dialogue_cell."
    for k, v in p["cell"].items():
        if k.endswith("_cell"):
            sd[f"{pre}{k}.weight_ih"] = _t(v["w_ih"]).t()
            sd[f"{pre}{k}.weight_hh"] = _t(v["w_hh"]).t()
            sd[f"{pre}{k}.bias_ih"] = _t(v["b_ih"])
            sd[f"{pre}{k}.bias_hh"] = _t(v["b_hh"])
        else:
            _linear(sd, f"{pre}attention.{_DIALOGUE_ATT[k]}", v)


def _single_graph_net(sd: "OrderedDict", g: Mapping) -> None:
    """The single-stream ``graph_net``: a relation net with its
    classifier, a GCNII network with ``fc_out`` (the reference's
    ``fcs.1``), a GCN3 with its ``linear``, or a bare linear."""
    pre = "graph_net."
    if "stack" in g:                                        # DeepGCN
        sd.update(gcnii_from_jax(g["stack"], pre))
        _linear(sd, f"{pre}fcs.1", g["fc_out"])
    elif "gcn1" in g:                                       # GCN3
        for layer in ("gcn1", "gcn2"):
            _linear(sd, f"{pre}{layer}.linear", g[layer]["TorchDense_0"])
        if "linear" in g:
            _linear(sd, f"{pre}linear", g["linear"])
    elif "conv1" in g:                                      # relation
        _relation_net(sd, pre, g)
        _dense_tree(sd, pre, {k: g[k] for k in ("matchatt", "linear",
                                                "smax_fc") if k in g})
    else:                                                   # 'None'
        _linear(sd, "graph_net", g)


def _text_cnn(sd: "OrderedDict", prefix: str, p: Mapping) -> None:
    """DailyDialogue's TextCNN: the table, each flax ``Conv`` kernel (K, E,
    F) as a ``Conv1d`` weight (F, E, K) in the order of K, and ``fc``."""
    sd[f"{prefix}embedding.weight"] = _t(p["embedding"])
    widths = sorted(int(k[4:]) for k in p if k.startswith("conv"))
    for i, K in enumerate(widths):
        conv = p[f"conv{K}"]
        sd[f"{prefix}convs.{i}.weight"] = _t(conv["kernel"]).permute(2, 1, 0)
        sd[f"{prefix}convs.{i}.bias"] = _t(conv["bias"])
    _linear(sd, f"{prefix}fc", p["fc"])


def params_from_jax(params: Mapping[str, Any]) -> "OrderedDict":
    """Map the JAX parameter tree of any model the port builds (every
    ``DialogueGNN`` family, multimodal or single-stream, the non-graph
    baselines and DailyDialogue's model), a nested dict of arrays as
    ``Trainer.init_state().params`` holds it, onto the port's state_dict
    (the reference's keys, as
    ``mmdfn_tpu/tools/import_torch_checkpoint.py`` reads them)."""
    sd: "OrderedDict" = OrderedDict()
    if "cnn_feat_extractor" in params:
        _text_cnn(sd, "cnn_feat_extractor.", params["cnn_feat_extractor"])
    for name in ("linear_", "base_linear"):
        if name in params:
            _linear(sd, name, params[name])
    for m in "avl":
        if f"linear_{m}" in params:
            _linear(sd, f"linear_{m}", params[f"linear_{m}"])
    for name in ("lstm_a", "lstm_v", "lstm_l", "lstm", "gru",
                 "rnn_parties"):
        if name in params:
            for k, v in gru_from_jax(params[name]).items():
                sd[f"{name}.{k}"] = v
    for name in ("dialog_rnn_f", "dialog_rnn_r"):
        if name in params:
            _dialogue_rnn(sd, name, params[name])
    gm = params.get("graph_model", {})
    if "graph_net" in gm:                                   # GF / GDF
        sd.update(gcnii_from_jax(gm["graph_net"], "graph_model.graph_net."))
        for name in ("speaker_embeddings", "modal_embeddings"):
            if name in gm:
                sd[f"graph_model.{name}.weight"] = _t(gm[name])
    elif "convs" in gm:                                     # GF2
        for idx, m in ((0, "a"), (1, "l"), (2, "v")):
            if f"fc_{m}" in gm:
                _linear(sd, f"graph_model.fcs.{idx}", gm[f"fc_{m}"])
        _convs(sd, "graph_model.", gm["convs"]["conv_w"])
    if "att_model" in params:
        att = params["att_model"]
        if "scalar" in att:
            _linear(sd, "att_model.scalar", att["scalar"])
        if "simpleatt_scalar" in att:
            _linear(sd, "att_model.simpleatt.scalar", att["simpleatt_scalar"])
    for m in "avl":
        g = params.get(f"graph_net_{m}")
        pre = f"graph_net_{m}."
        if g is None:
            continue
        if "stack" in g:                                    # DeepGCN
            sd.update(gcnii_from_jax(g["stack"], pre))
        elif "gcn1" in g:                                   # GCN3
            for layer in ("gcn1", "gcn2"):
                _linear(sd, f"{pre}{layer}.linear", g[layer]["TorchDense_0"])
        elif "conv1" in g:                                  # relation
            _relation_net(sd, pre, g)
        else:                                               # 'None'
            _linear(sd, f"graph_net_{m}", g)
    for head in ("gatedatt", "tfn", "lmf"):
        if head in params:
            _dense_tree(sd, f"{head}.", params[head])
    if "mfn" in params:
        _mfn(sd, params["mfn"])
    if "graph_net" in params:
        _single_graph_net(sd, params["graph_net"])
    if "head" in params:                          # the baselines' classifier
        _dense_tree(sd, "", params["head"])
    if "smax_fc" in params:
        _linear(sd, "smax_fc", params["smax_fc"])
    return OrderedDict((k, v.contiguous()) for k, v in sd.items())


def _conv_from_jax(sd: "OrderedDict", prefix: str, p: Mapping) -> None:
    """A flax ``Conv``: kernel (k, in, out) -> ``Conv1d`` (out, in, k), or
    HWIO -> ``Conv2d`` OIHW; the bias as it is."""
    w = _t(p["kernel"])
    sd[f"{prefix}.weight"] = w.permute(w.dim() - 1, w.dim() - 2,
                                       *range(w.dim() - 2))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _frontend_from_jax(sd: "OrderedDict", prefix: str, p: Mapping) -> None:
    """A frontend's subtree: flax ``Conv`` kernels, the adaptive GroupNorms
    (their scale and bias one level down, under ``gn``), ``TorchDense``
    heads; the port's submodules carry the JAX names."""
    for k, v in p.items():
        name = f"{prefix}{k}"
        if "gn" in v:
            sd[f"{name}.weight"] = _t(v["gn"]["scale"])
            sd[f"{name}.bias"] = _t(v["gn"]["bias"])
        elif "kernel" in v and np.ndim(v["kernel"]) > 2:
            _conv_from_jax(sd, name, v)
        elif "kernel" in v:
            _linear(sd, name, v)
        else:
            _frontend_from_jax(sd, f"{name}.", v)


def raw_params_from_jax(params: Mapping[str, Any]) -> "OrderedDict":
    """The JAX ``RawInputDialogueGNN`` parameter tree -> the port's
    state_dict: ``model`` through :func:`params_from_jax`, and the
    ``audio_frontend`` and ``visual_frontend`` subtrees."""
    sd: "OrderedDict" = OrderedDict(
        (f"model.{k}", v) for k, v in params_from_jax(params["model"]).items())
    for front in ("audio_frontend", "visual_frontend"):
        _frontend_from_jax(sd, f"{front}.", params[front])
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


def load_served(path: str) -> Tuple[ExperimentConfig, torch.nn.Module,
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
    model, _ = ckpt_lib.restore_checkpoint(path, models.from_config(cfg))
    return cfg, model, meta.get("epoch")


def build_model(cfg: ExperimentConfig, state_dict: Optional[Mapping] = None,
                gcn_spmm=None):
    """The config's model: fresh weights drawn from ``cfg.seed``, or
    ``state_dict`` loaded strictly (no missing or extra keys).
    ``gcn_spmm``: the GCNII stacks' ``adj @ h`` (``models.from_config``)."""
    model = models.from_config(cfg, gcn_spmm=gcn_spmm)
    if state_dict is None:
        model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    else:
        model.load_state_dict(state_dict)
    return model


def build_raw_model(cfg: ExperimentConfig,
                    state_dict: Optional[Mapping] = None, **frontend):
    """The raw-input model of the config (``RawInputDialogueGNN``: the
    config's multimodal ``DialogueGNN`` behind the log-mel and DenseNet
    frontends; ``frontend`` as its ``from_config`` takes): fresh weights
    drawn from ``cfg.seed``, the graph model's first, or ``state_dict``
    loaded strictly."""
    model = models.RawInputDialogueGNN.from_config(cfg, **frontend)
    if state_dict is None:
        model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    else:
        model.load_state_dict(state_dict)
    return model
