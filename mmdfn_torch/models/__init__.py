"""The ERC models: ``DialogueGNN`` with its graph families and single
stream, the non-graph baselines, DailyDialogue's token model, and the
raw-input model (frontends in front of ``DialogueGNN``)."""

from mmdfn_torch.config import (D_A, D_E, D_G, D_H, D_P, DATASET_INFO,
                                GRAPH_H, MAX_SEQ_LEN, ExperimentConfig)
from mmdfn_torch.models.baselines import DialogRNNModel, GRUModel, LSTMModel
from mmdfn_torch.models.daily import DialogueGCNDailyModel
from mmdfn_torch.models.dialogue_gnn import DialogueGNN
from mmdfn_torch.models.raw_input import RawInputDialogueGNN

__all__ = ["DialogRNNModel", "DialogueGCNDailyModel", "DialogueGNN",
           "GRUModel", "LSTMModel", "RawInputDialogueGNN", "from_config"]


def from_config(cfg: ExperimentConfig, gcn_spmm=None):
    """The config's model (``mmdfn_tpu/train/trainer.py:157-176``): for
    DailyDialogue its token model with ``daily_trainer.py:42-52``'s
    arguments (the TextCNN's dropout 0.5 whatever ``cfg.dropout`` says),
    else ``DialogueGNN`` with ``graph_model``, else the baseline that
    ``base_model`` names, on the text features.  ``gcn_spmm``: the graph
    model's GCNII ``adj @ h`` (``DialogueGNN``); the other models run no
    stack."""
    if cfg.dataset == "DailyDialogue":
        info = cfg.info
        return DialogueGCNDailyModel(
            base_model=cfg.base_model, D_m=cfg.cnn_output_size, D_g=D_G,
            D_p=D_P, D_e=D_E, D_h=D_H, D_a=D_A, graph_hidden_size=GRAPH_H,
            n_speakers=info["n_speakers"], max_seq_len=MAX_SEQ_LEN,
            window_past=cfg.windowp, window_future=cfg.windowf,
            vocab_size=cfg.vocab_size, embedding_dim=cfg.embedding_dim,
            cnn_output_size=cfg.cnn_output_size,
            cnn_filters=cfg.cnn_filters, n_classes=info["n_classes"],
            listener_state=cfg.active_listener,
            context_attention=cfg.attention, dropout_rec=cfg.rec_dropout,
            dropout=cfg.dropout, nodal_attention=cfg.nodal_attention)
    if cfg.graph_model:
        return DialogueGNN.from_config(cfg, gcn_spmm=gcn_spmm)
    if cfg.dataset not in DATASET_INFO:
        raise ValueError(f"dataset {cfg.dataset!r}: the port knows "
                         f"{', '.join(DATASET_INFO)}")
    n_classes = cfg.info["n_classes"]
    if cfg.base_model in ("GRU", "LSTM"):
        cls = GRUModel if cfg.base_model == "GRU" else LSTMModel
        return cls(cfg.D_m, D_E, D_H, n_classes=n_classes,
                   dropout=cfg.dropout)
    if cfg.base_model == "DialogRNN":
        return DialogRNNModel(
            cfg.D_m, D_G, D_P, D_E, D_H, D_a=D_A, n_classes=n_classes,
            listener_state=cfg.active_listener,
            context_attention=cfg.attention, dropout_rec=cfg.rec_dropout,
            dropout=cfg.dropout)
    raise ValueError(f"unknown base_model {cfg.base_model!r} for "
                     "graph_model=False")
