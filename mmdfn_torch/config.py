"""The configuration fields that the serve and training paths read.

A subset of ``mmdfn_tpu/config.py`` with the same names and defaults, and
the constants the model needs.  The port keeps its own copy: it imports
nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from mmdfn_torch.data.datasets import FEAT2DIM

D_E = 100              # encoder hidden size (run_train_erc.py:387-392)
GRAPH_H = 100          # GCNII hidden size
HIDDEN_MODALITY = 200  # per-modality projection width (model.py:847-849)

# the reference's class weights (run_train_erc.py:398-414)
IEMOCAP_CLASS_WEIGHTS = [
    1 / 0.086747, 1 / 0.144406, 1 / 0.227883,
    1 / 0.160585, 1 / 0.127711, 1 / 0.252668,
]
MELD_CLASS_WEIGHTS = [
    1.0 / 0.466750766, 1.0 / 0.122094071, 1.0 / 0.027752748,
    1.0 / 0.071544422, 1.0 / 0.171742656, 1.0 / 0.026401153,
    1.0 / 0.113714183,
]

DATASET_INFO = {
    "IEMOCAP": dict(
        n_speakers=2, n_classes=6,
        target_names=["hap", "sad", "neu", "ang", "exc", "fru"],
        class_weights=IEMOCAP_CLASS_WEIGHTS,
        D_audio=FEAT2DIM["IS10"], D_visual=FEAT2DIM["denseface"],
        D_text=FEAT2DIM["textCNN"],
    ),
    "MELD": dict(
        n_speakers=9, n_classes=7,
        target_names=["neu", "sur", "fea", "sad", "joy", "dis", "ang"],
        class_weights=MELD_CLASS_WEIGHTS,
        D_audio=FEAT2DIM["MELD_audio"], D_visual=FEAT2DIM["denseface"],
        D_text=FEAT2DIM["MELD_text"],
    ),
}


@dataclass
class ExperimentConfig:
    """The serve- and training-path fields of the reference flag surface
    (same names, same defaults)."""

    dataset: str = "IEMOCAP"
    modals: str = "avl"
    mm_fusion_mthd: str = "concat_subsequently"
    base_model: str = "LSTM"
    graph_type: str = "GDF"
    reason_flag: bool = False
    Deep_GCN_nlayers: int = 16
    alpha: float = 0.2
    lamda: float = 0.5
    speaker_weights: str = "3-0-1"
    modal_weight: float = 1.0
    use_residue: bool = True
    use_speaker: bool = False
    use_modal: bool = False
    use_crn_speaker: bool = True
    seed: int = 2021
    # training (mmdfn_tpu/config.py:89-115)
    epochs: int = 30
    batch_size: int = 32
    valid_rate: float = 0.0
    lr: float = 0.0003
    l2: float = 0.0001
    dropout: float = 0.4
    gamma: float = 0.5
    loss: str = "FocalLoss"
    class_weight: bool = False
    patience: int = 5
    buckets: Tuple[int, ...] = (16, 24, 32, 48, 64, 96, 128, 160, 200)
    faithful_epoch_reseed: bool = True      # the same dropout seed stream
                                            # every epoch (reference
                                            # run_train_erc.py:164)
    log_jsonl: Optional[str] = None

    @property
    def info(self) -> dict:
        return DATASET_INFO[self.dataset]

    def class_weights_or_none(self) -> Optional[np.ndarray]:
        if self.class_weight:
            return np.asarray(self.info["class_weights"], dtype=np.float32)
        return None


def flagship_config(nlayers: int = 16, seed: int = 2021) -> ExperimentConfig:
    """The served flagship: IEMOCAP MM-DFN (GDF with the reason-LSTM),
    speaker weights 3-0-1, as ``mmdfn_tpu/serve/latency_bench.py`` builds
    it."""
    return ExperimentConfig(dataset="IEMOCAP", graph_type="GDF",
                            reason_flag=True, Deep_GCN_nlayers=nlayers,
                            speaker_weights="3-0-1", seed=seed)
