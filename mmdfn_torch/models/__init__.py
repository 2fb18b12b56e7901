"""The ERC models: ``DialogueGNN`` with its graph families and single
stream, and the non-graph baselines."""

from mmdfn_torch.config import (D_A, D_E, D_G, D_H, D_P, DATASET_INFO,
                                ExperimentConfig)
from mmdfn_torch.models.baselines import DialogRNNModel, GRUModel, LSTMModel
from mmdfn_torch.models.dialogue_gnn import DialogueGNN

__all__ = ["DialogRNNModel", "DialogueGNN", "GRUModel", "LSTMModel",
           "from_config"]


def from_config(cfg: ExperimentConfig):
    """The config's model (``mmdfn_tpu/train/trainer.py:157-176``):
    ``DialogueGNN`` with ``graph_model``, else the baseline that
    ``base_model`` names, on the text features."""
    if cfg.graph_model:
        return DialogueGNN.from_config(cfg)
    if cfg.dataset not in DATASET_INFO:
        raise NotImplementedError(
            f"dataset {cfg.dataset!r}: a later slice of the port")
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
