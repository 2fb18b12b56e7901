"""Import a reference (PyTorch) MM-DFN checkpoint into the port.

The reference's only checkpoint format is a whole-module pickle (test mode
loads ``model = torch.load(args.load_model)``, ``run_train_erc.py:532``);
a user may also arrive with a ``state_dict`` extracted from one.  The
port's parameter names are the reference ``DialogueGNNModel`` state_dict
keys, so the import is a key check: the parameters the reference allocates
but never runs on the configured path are dropped by prefix (those that
``mmdfn_tpu/tools/import_torch_checkpoint.py:_dead_prefixes`` names, each
dead exactly when the port's model has no key under it), and the rest
loads strictly into the port's ``DialogueGNN``.  A stray or a missing key
is an error that names it.

Scope: the families ``mmdfn_tpu``'s importer detects
(``_detect_family``), on IEMOCAP and MELD: every multimodal graph family
(GDF, GF, GF2, DeepGCN, GCN3, relation, 'None') with the base LSTM or
'None' and any fusion head; the single-stream relation net
(``mm_fusion_mthd='concat'`` or ``multi_modal`` off) on the LSTM base with
the attn1 edge weights; and the non-graph baselines GRU, LSTM and
DialogRNN (simple or general context attention).  Any other single-stream
model raises ``ValueError``, as the JAX importer does.

CLI (writes a checkpoint directory that ``cli/serve.py --load_model`` and
``cli/run_train_erc.py --test_label --load_model`` read):
    python -m mmdfn_torch.tools.import_torch_checkpoint \\
        --load_model reference_model.pkl --out ckpts/imported \\
        --dataset MELD --Deep_GCN_nlayers 64
"""

from __future__ import annotations

import dataclasses
import json
import pickle
from typing import Any, Mapping, Optional

import numpy as np
import torch

from mmdfn_torch import models
from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.runtime import checkpoint as ckpt_lib

# allocated by the reference on the GF/GDF path and never run there
# (model.py:983, model_mm.py:55-75): the relation family's edge attention,
# the gated fusion head, and MM_GCN's unused projections and embeddings
GDF_DEAD = ("att_model.", "gatedatt.", "graph_model.a_fc.",
            "graph_model.v_fc.", "graph_model.l_fc.",
            "graph_model.feature_fc.", "graph_model.final_fc.",
            "graph_model.modal_embeddings.", "graph_model.speaker_embeddings.",
            "graph_model.a_spk_embs.", "graph_model.v_spk_embs.",
            "graph_model.l_spk_embs.")
# GCNII_lyc allocates the reason-LSTM unconditionally (model_GCN.py:433);
# without the reason flag it never runs
REASON_LSTM = "graph_model.graph_net.rnn."
# the other families' (mmdfn_tpu's _dead_prefixes): the edge attention's
# other branches, MFN's output layers, and per modality the GCNII
# baseline's reason-LSTM and the classifiers of nets that return features
# (GCN_2Layers' linear, the relation net's linear and matchatt)
OTHER_DEAD = ("att_model.scalar.", "att_model.simpleatt.",
              "att_model.matchatt.", "att_model.att.", "mfn.out_fc1.",
              "mfn.out_fc2.") + tuple(
    f"graph_net_{m}.{part}." for m in "avl"
    for part in ("rnn", "linear", "matchatt"))


def dead_prefixes(model: torch.nn.Module) -> tuple:
    """The state_dict prefixes that the reference allocates and
    ``model``'s forward never reads: each candidate under which the model
    has no key; none for the baselines, which run every parameter."""
    if not isinstance(model, models.DialogueGNN):
        return ()
    live = model.state_dict()
    return tuple(p for p in GDF_DEAD + (REASON_LSTM,) + OTHER_DEAD
                 if not any(k.startswith(p) for k in live))


def load_reference(obj_or_path) -> Mapping[str, Any]:
    """A reference checkpoint's state_dict: from a ``torch.save`` file (a
    state_dict, or a whole-module pickle whose classes can be imported),
    or from an in-memory module or state_dict."""
    obj = obj_or_path
    if isinstance(obj, (str, bytes)):
        try:
            obj = torch.load(obj, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError:
            # a whole-module pickle: unpickling runs the module's classes'
            # code, so only a trusted file may be given
            obj = torch.load(obj_or_path, map_location="cpu",
                             weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return obj


def _name(cfg: ExperimentConfig) -> str:
    return cfg.graph_type if cfg.graph_model else f"{cfg.base_model} baseline"


def check_family(cfg: ExperimentConfig) -> None:
    """Raise ``ValueError`` for a model that ``mmdfn_tpu``'s importer has
    no family for: a single-stream model other than the relation net on
    the LSTM base with attn1 edge weights, a DialogRNN baseline whose
    context attention is neither simple nor general, or DailyDialogue's
    model."""
    if cfg.dataset == "DailyDialogue":
        raise ValueError("dataset 'DailyDialogue': the importer has no "
                         "family for its token model")
    if not cfg.graph_model:
        if cfg.base_model == "DialogRNN" and cfg.attention not in (
                "simple", "general"):
            raise ValueError(f"DialogRNN with attention {cfg.attention!r}: "
                             "the importer maps simple and general only")
    elif not cfg.multi_modal_path and (
            cfg.graph_type, cfg.base_model, cfg.edge_attn_type) != (
            "relation", "LSTM", "attn1"):
        raise ValueError(
            f"single-stream graph_type {cfg.graph_type!r} on base_model "
            f"{cfg.base_model!r} (edge_attn_type {cfg.edge_attn_type!r}): "
            "the importer takes the single-stream relation net on the LSTM "
            "base with attn1 edge weights only")


def import_state_dict(sd: Mapping[str, Any], cfg: ExperimentConfig,
                      model: Optional[torch.nn.Module] = None
                      ) -> torch.nn.Module:
    """The config's port model (or ``model``, a template built for it, as
    the JAX importer takes a parameter tree: one whose GCNII stacks were
    built with ``variant=False`` takes the reference's non-variant
    ``GraphConvolution(nhidden, nhidden)`` layers) with the reference
    weights ``sd`` (tensors or arrays) loaded strictly, the dead prefixes
    dropped first.

    Raises:
      NotImplementedError: the config selects a family the port lacks.
      ValueError: a family the importer does not take (:func:`check_family`).
      KeyError: a live key of ``sd`` the model lacks, or a key of the
        model that ``sd`` lacks; the message names them.
      ValueError: a key whose shape differs from the model's.
    """
    check_family(cfg)
    if model is None:
        model = models.from_config(cfg)
    dead = dead_prefixes(model)
    live = {k: v for k, v in sd.items() if not k.startswith(dead)}
    want = model.state_dict()
    stray = sorted(set(live) - set(want))
    missing = sorted(set(want) - set(live))
    if stray:
        raise KeyError(f"reference parameters the port's {_name(cfg)} "
                       f"model has no place for: {stray}")
    if missing:
        raise KeyError(f"parameters of the port's {_name(cfg)} model "
                       f"missing from the checkpoint: {missing}")
    tensors = {}
    for k, v in live.items():
        t = torch.as_tensor(np.asarray(
            v.detach().cpu() if isinstance(v, torch.Tensor) else v,
            dtype=np.float32))
        if t.shape != want[k].shape:
            raise ValueError(
                f"shape mismatch importing {k}: checkpoint "
                f"{tuple(t.shape)} vs model {tuple(want[k].shape)}; the "
                "architecture flags (Deep_GCN_nlayers, dataset) must match "
                "the checkpoint's")
        tensors[k] = t
    model.load_state_dict(tensors, strict=True)
    return model


def import_reference_checkpoint(obj_or_path, cfg: ExperimentConfig
                                ) -> torch.nn.Module:
    """:func:`load_reference` then :func:`import_state_dict`."""
    return import_state_dict(load_reference(obj_or_path), cfg)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--load_model", required=True,
                    help="reference torch.save file (whole-module pickle "
                         "or state_dict)")
    ap.add_argument("--out", required=True,
                    help="checkpoint directory to write (serve it with "
                         "mmdfn_torch.cli.serve --load_model)")
    ap.add_argument("--dataset", default="IEMOCAP",
                    choices=["IEMOCAP", "MELD"])
    ap.add_argument("--graph_type", default="GDF",
                    choices=["GDF", "GF", "GF2", "relation", "DeepGCN",
                             "GCN3", "None"])
    ap.add_argument("--Deep_GCN_nlayers", type=int, default=16)
    ap.add_argument("--no_use_residue", action="store_true",
                    help="the use_residue=False variant")
    ap.add_argument("--speaker_weights", type=str, default="3-0-1")
    ap.add_argument("--reason_flag", choices=["auto", "true", "false"],
                    default="auto",
                    help="reason-LSTM inside the GCNII stack; 'auto' = on "
                         "for GDF, off otherwise")
    ap.add_argument("--mm_fusion_mthd", default="concat_subsequently",
                    choices=["concat_subsequently", "concat_only", "gated",
                             "tfn_only", "lmf_only", "mfn_only", "mfn",
                             "concat"],
                    help="fusion head the checkpoint was trained with "
                         "('concat': the single-stream relation net)")
    ap.add_argument("--modals", default="avl",
                    help="the modalities the checkpoint was trained on")
    ap.add_argument("--no_multi_modal", dest="multi_modal",
                    action="store_false", default=True,
                    help="single-stream relation checkpoint of one modality")
    ap.add_argument("--av_using_lstm", action="store_true",
                    help="checkpoint has lstm_a/lstm_v encoders")
    ap.add_argument("--use_gcn", action="store_true",
                    help="relation: checkpoint trained with --use_gcn "
                         "(conv3/conv4 linears)")
    ap.add_argument("--graph_construct", default="direct",
                    choices=["direct", "single", "window", "fc"],
                    help="GF2's cross-modal graph (no parameters of its "
                         "own)")
    ap.add_argument("--edge_attn_type", default="attn1",
                    choices=["attn1", "attn2", "attn3"],
                    help="relation: the edge attention the checkpoint was "
                         "trained with")
    ap.add_argument("--no_graph_model", dest="graph_model",
                    action="store_false", default=True,
                    help="non-graph baseline checkpoint")
    ap.add_argument("--base_model", default="LSTM",
                    choices=["LSTM", "GRU", "DialogRNN"])
    ap.add_argument("--active_listener", action="store_true",
                    help="DialogRNN: the listener-state variant")
    ap.add_argument("--attention", default="general",
                    choices=["simple", "general"],
                    help="DialogRNN: the context attention")
    args = ap.parse_args(argv)

    reason = ((args.graph_type == "GDF") if args.reason_flag == "auto"
              else args.reason_flag == "true")
    cfg = ExperimentConfig(
        dataset=args.dataset, graph_type=args.graph_type,
        graph_model=args.graph_model, base_model=args.base_model,
        multi_modal=args.multi_modal, modals=args.modals,
        active_listener=args.active_listener, attention=args.attention,
        reason_flag=reason,
        Deep_GCN_nlayers=args.Deep_GCN_nlayers,
        use_residue=not args.no_use_residue,
        speaker_weights=args.speaker_weights,
        mm_fusion_mthd=args.mm_fusion_mthd,
        av_using_lstm=args.av_using_lstm, use_gcn=args.use_gcn,
        graph_construct=args.graph_construct,
        edge_attn_type=args.edge_attn_type)
    model = import_reference_checkpoint(args.load_model, cfg)
    path = ckpt_lib.save_checkpoint(
        args.out, model, meta={"imported_from": args.load_model,
                               "config": dataclasses.asdict(cfg)})
    print(json.dumps({"imported": args.load_model, "checkpoint": path}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
