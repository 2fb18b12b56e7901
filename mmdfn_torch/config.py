"""The configuration fields that the serve and training paths read.

A subset of ``mmdfn_tpu/config.py`` with the same names and defaults, and
the constants the model needs.  The port keeps its own copy: it imports
nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np

from mmdfn_torch.data.datasets import FEAT2DIM

# fixed model widths (run_train_erc.py:387-392)
D_G = D_P = 150        # DialogueRNN's global and party states
D_E = 100              # encoder hidden size (DialogueRNN's emotion state)
D_H = D_A = 100        # the baselines' classifier and DialogueRNN's
                       # attention widths
GRAPH_H = 100          # GCNII hidden size
HIDDEN_MODALITY = 200  # per-modality projection width (model.py:847-849)
MAX_SEQ_LEN = 200      # the relation edge attention's channels
                       # (run_train_erc.py:421)

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

# the fusion heads of the multimodal path; any other ``mm_fusion_mthd``
# (the reference's 'concat': early fusion) runs one stream
# (``mmdfn_tpu/models/dialogue_gnn.py:107-109``)
MM_FUSIONS = ("concat_subsequently", "concat_only", "gated", "mfn",
              "mfn_only", "tfn_only", "lmf_only")

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
    # token ids through the trainable TextCNN (``models/daily.py``); the
    # labels follow the DailyDialog annotation scheme
    "DailyDialogue": dict(
        n_speakers=2, n_classes=7,
        target_names=["no_emo", "ang", "dis", "fea", "hap", "sad", "sur"],
        class_weights=[1.0] * 7,
        D_audio=0, D_visual=0, D_text=100,
    ),
}


@dataclass
class ExperimentConfig:
    """The serve- and training-path fields of the reference flag surface
    (same names, same defaults).  A checkpoint's saved config that lacks
    a field (one written before the field was added) takes its default."""

    dataset: str = "IEMOCAP"
    multi_modal: bool = True
    modals: str = "avl"
    mm_fusion_mthd: str = "concat_subsequently"
    base_model: str = "LSTM"
    graph_model: bool = True
    graph_type: str = "GDF"
    graph_construct: str = "direct"         # GF2's cross-modal graph
    use_gcn: bool = False                   # relation: conv3/conv4
    nodal_attention: bool = True
    av_using_lstm: bool = False             # bi-GRUs over audio and visual
    active_listener: bool = False           # DialogRNN: the listener state
    attention: str = "general"              # DialogRNN: context attention
    rec_dropout: float = 0.1                # DialogRNN: the cells' dropout
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
    windowp: int = 10                       # relation: the edge window
    windowf: int = 10
    edge_attn_type: str = "attn1"           # relation: edge weights
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
    sort_batches_by_length: bool = False    # training batches of similar
                                            # lengths (less padding)
    log_jsonl: Optional[str] = None
    # the JAX package's performance knobs (mmdfn_tpu/config.py:129-184),
    # as the port reads them:
    gcn_compute_dtype: Optional[str] = None  # 'bfloat16': where JAX runs
                                            # the layer scan in bf16 (no
                                            # fused kernel), kernels B and
                                            # D's bf16 scan mode
    rnn_compute_dtype: Optional[str] = None  # 'bfloat16': the encoders in
                                            # bf16 (nn/rnn.py:rnn_mode):
                                            # kernels A and C's bf16 scan
                                            # mode, or under rnn_backend=
                                            # 'pallas' their bf16 mode
    rnn_scan_remat: bool = False            # accepted: kernels A and C keep
                                            # what the backward reads either
                                            # way (memory only in JAX)
    rng_impl: Optional[str] = None          # accepted: the port's dropout
                                            # draws are its own (Philox and
                                            # torch's generator) either way
    gcn_backend: Optional[str] = None       # 'pallas' / 'pallas_fused': the
                                            # GCNII stack in the TPU training
                                            # kernel's bf16 numerics (kernels
                                            # B and D's bf16 mode), where
                                            # JAX's GCNIIStack takes that
                                            # kernel (nn/gcn.py:GCNIIStack)
    gcn_bwd_block: Optional[int] = None     # accepted: kernel D contracts
                                            # all rows in one product
    rnn_backend: Optional[str] = None       # 'pallas': with rnn_compute_
                                            # dtype='bfloat16', JAX's fused
                                            # kernel on bf16 operands
                                            # (kernels A and C's bf16 mode);
                                            # in f32 both JAX backends
                                            # compute kernels A and C's f32
                                            # function
    transfer_dtype: str = "float32"         # 'bfloat16': the features
                                            # rounded to bf16 on the host,
                                            # copied as bf16 and widened on
                                            # the device (prepare_inputs)
    # DailyDialogue's token frontend (mmdfn_tpu/config.py:190-194)
    vocab_size: int = 5000
    max_words: int = 20                     # the word axis, fixed per epoch
    embedding_dim: int = 300
    cnn_filters: int = 50
    cnn_output_size: int = 100

    @property
    def info(self) -> dict:
        return DATASET_INFO[self.dataset]

    @property
    def multi_modal_path(self) -> bool:
        """``multi_modal`` as the model reads it: on only with one of the
        multimodal fusion heads; 'concat' falls back to one stream."""
        return self.multi_modal and self.mm_fusion_mthd in MM_FUSIONS

    @property
    def input_modals(self) -> str:
        """The modalities that the model's ``text`` argument carries, in
        their order along the features (``mmdfn_tpu/train/trainer.py:
        88-113``): the text features for the multimodal heads and the
        non-graph models (which read the text alone), the concatenation
        a,v / a,v,l / v,l / a,l for 'concat', else the one modality."""
        if not self.graph_model:
            return "l"
        if self.multi_modal:
            if self.mm_fusion_mthd != "concat":
                return "l"
            if self.modals not in ("avl", "av", "vl", "al"):
                raise ValueError(f"mm_fusion_mthd 'concat' with modals "
                                 f"{self.modals!r}")
            return self.modals
        if self.modals not in ("a", "v", "l"):
            raise ValueError(f"multi_modal=False takes one modality, not "
                             f"modals={self.modals!r}")
        return self.modals

    @property
    def D_m(self) -> int:
        """The width of the model's ``text`` argument
        (``run_train_erc.py:364-386``)."""
        info = self.info
        dims = {"a": info["D_audio"], "v": info["D_visual"],
                "l": info["D_text"]}
        return sum(dims[m] for m in self.input_modals)

    def class_weights_or_none(self) -> Optional[np.ndarray]:
        if self.class_weight:
            return np.asarray(self.info["class_weights"], dtype=np.float32)
        return None

    # the JAX package's production configuration (mmdfn_tpu/config.py:
    # 222-236): in the port, the GCNII stack's bf16 mode where JAX takes
    # its fused training kernel and its bf16 scan mode elsewhere, and with
    # rnn_compute_dtype='bfloat16' the encoders' bf16 mode (rnn_backend);
    # the other knobs change nothing here
    TPU_FAST_KNOBS = dict(
        gcn_compute_dtype="bfloat16", rnn_scan_remat=True,
        rnn_backend="pallas", gcn_backend="pallas", gcn_bwd_block=2,
        rng_impl="rbg")

    def with_tpu_fast(self) -> "ExperimentConfig":
        """This config with every knob of ``TPU_FAST_KNOBS`` set."""
        return replace(self, **self.TPU_FAST_KNOBS)


def flagship_config(nlayers: int = 16, seed: int = 2021) -> ExperimentConfig:
    """The served flagship: IEMOCAP MM-DFN (GDF with the reason-LSTM),
    speaker weights 3-0-1, as ``mmdfn_tpu/serve/latency_bench.py`` builds
    it."""
    return ExperimentConfig(dataset="IEMOCAP", graph_type="GDF",
                            reason_flag=True, Deep_GCN_nlayers=nlayers,
                            speaker_weights="3-0-1", seed=seed)
