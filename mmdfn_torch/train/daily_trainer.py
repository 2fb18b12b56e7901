"""DailyDialogue's training path (``mmdfn_tpu/train/daily_trainer.py``):
token-id batches through the same engine as :class:`Trainer`, with the
same loss, optimiser, selection, early stopping and checkpoints.

A ``TokenBatch`` is (B, L, W) int32 token ids with W fixed for the epoch
(``TokenBucketBatcher``); the model is ``DialogueGCNDailyModel``
(``models/daily.py``), which :func:`mmdfn_torch.models.from_config`
builds for a DailyDialogue config.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mmdfn_torch.data.batching import TokenBucketBatcher
from mmdfn_torch.train.optim import torch_adam
from mmdfn_torch.train.trainer import Trainer, to_device

Tensor = torch.Tensor

EMBEDDING = "cnn_feat_extractor.embedding.weight"


class DailyTrainer(Trainer):
    """:class:`Trainer` over ``TokenDialogue`` / ``TokenBatch``
    (DailyDialogue ERC)."""

    _token_inputs = True

    def _prepare(self, batch) -> Dict[str, Tensor]:
        """The token batch's arrays on the device; tokens stay int32."""
        put = lambda a: to_device(a, self.device)
        return dict(tokens=put(batch.tokens), qmask=put(batch.qmask),
                    umask=put(batch.umask), label=put(batch.label))

    def _forward(self, inputs: Dict[str, Tensor], **kw) -> Tensor:
        return self.model(inputs["tokens"], inputs["qmask"], inputs["umask"],
                          **kw)

    def _batcher(self, dialogues, shuffle: bool = False
                 ) -> TokenBucketBatcher:
        cfg = self.cfg
        return TokenBucketBatcher(
            dialogues, cfg.batch_size, cfg.max_words, cfg.buckets,
            shuffle=shuffle, seed=cfg.seed,
            sort_by_length=cfg.sort_batches_by_length and shuffle,
            n_speakers=cfg.info["n_speakers"])

    def init_pretrained_embeddings(self, vectors: np.ndarray,
                                   freeze: bool = True) -> None:
        """Copy pretrained word vectors into the TextCNN's table (the
        reference's ``init_pretrained_embeddings_from_numpy``,
        ``model.py:1421-1423``).  With ``freeze`` the table never moves:
        it takes no gradient and is left out of Adam, its L2 included.
        The optimiser is rebuilt either way, its state fresh (call before
        training).

        Raises:
          ValueError: ``vectors`` is not (vocab_size, embedding_dim).
        """
        cfg = self.cfg
        vectors = np.asarray(vectors, np.float32)
        expect = (cfg.vocab_size, cfg.embedding_dim)
        if vectors.shape != expect:
            raise ValueError(f"pretrained embeddings shape {vectors.shape} "
                             f"!= (vocab_size, embedding_dim) {expect}")
        table = self.model.get_parameter(EMBEDDING)
        with torch.no_grad():
            table.copy_(torch.from_numpy(vectors))
        table.requires_grad_(not freeze)
        self.optimizer = torch_adam(
            [p for n, p in self.model.named_parameters()
             if not (freeze and n == EMBEDDING)], cfg.lr, cfg.l2)
