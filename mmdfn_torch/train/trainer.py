"""Training and evaluation engine (``mmdfn_tpu/train/trainer.py:235-568``,
reference ``code/run_train_erc.py:92-238,554-644``), on the card unless the
caller asks for the CPU.

One train step is the model's training forward (every dropout drawn from a
generator seeded for that step), the loss, ``backward()`` through kernels C
and D, and one Adam update.  The host never waits for the card inside an
epoch: losses and predictions stay on the device until the epoch ends.

Reference-parity details, as the JAX trainer keeps them:
* graph-path loss = mean over valid utterances; epoch loss = mean of the
  batch losses, rounded to 4 places (``run_train_erc.py:202,222``);
* accuracy and sklearn-weighted F1 (``run_train_erc.py:229-236``);
* selection on test when ``valid_rate == 0`` and the dual patience of
  early stopping (``run_train_erc.py:609-638``);
* the per-epoch reseed quirk (``run_train_erc.py:164``): with
  ``faithful_epoch_reseed`` every epoch draws the same per-step seed stream,
  as ``_epoch_key`` returns the same key (``trainer.py:294-298``).
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.data.batching import Batch, BucketBatcher
from mmdfn_torch.device import resolve_device
from mmdfn_torch.losses import focal_loss, masked_nll_loss
from mmdfn_torch.runtime import checkpoint as ckpt_lib
from mmdfn_torch.train import metrics as M
from mmdfn_torch.train.optim import torch_adam
from mmdfn_torch.weights import build_model

Tensor = torch.Tensor

# configuration fields a resumed run may change (mmdfn_tpu's list, less the
# flags the port does not have)
_RESUME_EXEMPT = {"epochs", "log_jsonl"}


@dataclass
class EpochMetrics:
    """One epoch's aggregate metrics (reference print contract)."""

    loss: float
    acc: float
    fscore: float
    labels: np.ndarray
    preds: np.ndarray
    report: str = ""
    per_class_acc: List[str] = field(default_factory=list)
    throughput: Dict = field(default_factory=dict)


@dataclass
class FitResult:
    state_dict: Dict[str, Tensor]     # the selected epoch's weights, on CPU
    best_epoch: int
    best_eval_fscore: float
    best_test_acc: float
    best_test_fscore: float
    all_test_fscore: List[float]
    all_test_acc: List[float]
    history: List[Dict] = field(default_factory=list)


def prepare_inputs(batch: Batch, device: torch.device) -> Dict[str, Tensor]:
    """The batch's arrays as tensors on ``device`` (pinned host copies, so
    that the copies to the card do not block the host)."""
    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t
    return dict(text=put(batch.text), audio=put(batch.audio),
                visual=put(batch.visual), qmask=put(batch.qmask),
                umask=put(batch.umask), label=put(batch.label))


class Trainer:
    """Trains the port's ``DialogueGNN`` (base LSTM, GF/GDF) with the
    reference's loss, optimiser and selection rules.

    ``model`` defaults to the config's model with fresh weights from
    ``cfg.seed``; ``device`` to the card (it raises without one unless
    ``device="cpu"``).
    """

    def __init__(self, cfg: ExperimentConfig, device=None,
                 model: Optional[torch.nn.Module] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = (model if model is not None
                      else build_model(cfg)).to(self.device)
        self.optimizer = torch_adam(self.model.parameters(), cfg.lr, cfg.l2)
        alpha = cfg.class_weights_or_none()
        self.alpha = (None if alpha is None
                      else torch.as_tensor(alpha, device=self.device))

    # ------------------------------------------------------------------
    def _loss(self, log_probs: Tensor, label: Tensor, umask: Tensor) -> Tensor:
        if self.cfg.loss == "FocalLoss":
            return focal_loss(log_probs, label, umask, gamma=self.cfg.gamma,
                              alpha=self.alpha)
        return masked_nll_loss(log_probs, label, umask, weight=self.alpha)

    def _forward(self, inputs: Dict[str, Tensor], **kw) -> Tensor:
        return self.model(inputs["text"], inputs["qmask"], inputs["umask"],
                          inputs["audio"], inputs["visual"], **kw)

    def step_seed(self, epoch: int, i: int) -> int:
        """The seed of step i of an epoch: the same stream every epoch with
        ``faithful_epoch_reseed``, else one per epoch."""
        e = 0 if self.cfg.faithful_epoch_reseed else epoch + 1
        state = np.random.SeedSequence([self.cfg.seed, e, i]).generate_state(
            1, np.uint64)
        return int(state[0] >> np.uint64(1))

    def train_step(self, inputs: Dict[str, Tensor], seed: int
                   ) -> Tuple[Tensor, Tensor]:
        """One optimiser step; returns (loss, predictions), on the device.
        The step's gradients stay in the parameters' ``.grad``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.optimizer.zero_grad(set_to_none=True)
        logp = self._forward(inputs, train=True, generator=gen)
        loss = self._loss(logp, inputs["label"], inputs["umask"])
        loss.backward()
        self.optimizer.step()
        return loss.detach(), logp.detach().argmax(dim=-1)

    def eval_step(self, inputs: Dict[str, Tensor]) -> Tuple[Tensor, Tensor]:
        with torch.no_grad():
            logp = self._forward(inputs)
            loss = self._loss(logp, inputs["label"], inputs["umask"])
        return loss, logp.argmax(dim=-1)

    def _batcher(self, dialogues, shuffle: bool = False) -> BucketBatcher:
        cfg = self.cfg
        return BucketBatcher(dialogues, cfg.batch_size,
                             cfg.info["n_speakers"], cfg.buckets,
                             shuffle=shuffle, seed=cfg.seed)

    # ------------------------------------------------------------------
    def run_epoch(self, batches: Sequence, train: bool = False,
                  epoch: int = 0, full_report: bool = False) -> EpochMetrics:
        """One pass over ``batches`` (``Batch`` objects, or (Batch, inputs)
        pairs prepared once); mirrors ``train_or_eval_graph_model``."""
        cfg = self.cfg
        losses, preds, masks, labels = [], [], [], []
        n_dia = n_utt = 0
        t0 = time.perf_counter()
        for i, item in enumerate(batches):
            batch, inputs = (item if isinstance(item, tuple)
                             else (item, prepare_inputs(item, self.device)))
            n_dia += int((batch.umask.sum(-1) > 0).sum())
            n_utt += batch.n_valid
            if train:
                loss, pred = self.train_step(inputs, self.step_seed(epoch, i))
            else:
                loss, pred = self.eval_step(inputs)
            m = batch.umask.reshape(-1) > 0
            losses.append(loss)
            preds.append(pred)
            masks.append(m)
            labels.append(batch.label.reshape(-1)[m])
        if not losses:
            nan, empty = float("nan"), np.zeros((0,), np.int64)
            return EpochMetrics(nan, nan, nan, empty, empty)
        # one copy back per epoch, not one wait per step
        losses = torch.stack(losses).cpu().numpy()
        preds = [p.reshape(-1).cpu().numpy()[m] for p, m in zip(preds, masks)]
        dt = time.perf_counter() - t0
        labels, preds = np.concatenate(labels), np.concatenate(preds)
        n_classes = cfg.info["n_classes"]
        result = EpochMetrics(
            loss=round(float(np.sum(losses) / len(losses)), 4),
            acc=M.reference_rounding(M.accuracy(labels, preds)),
            fscore=M.reference_rounding(M.f1_score(labels, preds, n_classes)),
            labels=labels, preds=preds,
            throughput=dict(seconds=dt, dialogues_per_sec=n_dia / dt,
                            utterances_per_sec=n_utt / dt))
        if full_report:
            names = cfg.info["target_names"]
            result.report = M.classification_report(labels, preds, names)
            result.per_class_acc = M.per_class_accuracy(labels, preds, names)
        return result

    def evaluate(self, dialogues) -> EpochMetrics:
        return self.run_epoch(list(self._batcher(dialogues).epoch()),
                              full_report=True)

    # ------------------------------------------------------------------
    def _state_cpu(self) -> Dict[str, Tensor]:
        return {k: v.detach().cpu().clone()
                for k, v in self.model.state_dict().items()}

    def fit(self, train_dialogues, test_dialogues, valid_dialogues=(),
            verbose: bool = True, log_path: Optional[str] = None,
            save_dir: Optional[str] = None, resume: bool = False
            ) -> FitResult:
        """A full run with the reference's selection and early-stop rules.

        With ``save_dir`` the selected epoch is written as ``best`` and
        every epoch as ``last`` (weights, optimiser state, selection
        counters); ``resume=True`` continues from ``last``.
        """
        cfg = self.cfg
        train_batcher = self._batcher(train_dialogues, shuffle=True)
        # the fixed eval splits are copied to the device once
        prep = lambda dias: [(b, prepare_inputs(b, self.device))
                             for b in self._batcher(dias).epoch()]
        valid_batches = prep(valid_dialogues)
        test_batches = prep(test_dialogues)

        best_epoch, best_eval_fscore = -1, None
        best_eval_loss, best_epoch2 = None, -1
        patience = patience2 = 0
        all_test_fscore: List[float] = []
        all_test_acc: List[float] = []
        history: List[Dict] = []
        best_state = self._state_cpu()
        start_epoch = 0
        can_resume = bool(resume and save_dir
                          and ckpt_lib.has_checkpoint(save_dir, "last"))
        if resume and not can_resume:
            print("resume requested but no 'last' checkpoint under "
                  f"{save_dir!r} — starting fresh")
        if can_resume:
            saved = ckpt_lib.read_meta(save_dir, "last").get("config", {})
            now = dataclasses.asdict(cfg)
            diff = {k for k, v in saved.items()
                    if k in now and k not in _RESUME_EXEMPT
                    and (tuple(v) if isinstance(v, list) else v) != now[k]}
            if diff:
                raise ValueError(f"resume config mismatch on fields "
                                 f"{sorted(diff)}; restart fresh or restore "
                                 "the original flags")
            _, meta = ckpt_lib.restore_checkpoint(
                save_dir, self.model, self.optimizer, "last")
            r = meta.get("resume", {})
            start_epoch = int(r.get("epoch", -1)) + 1
            best_epoch = int(r.get("best_epoch", -1))
            best_eval_fscore = r.get("best_eval_fscore")
            best_eval_loss = r.get("best_eval_loss")
            best_epoch2 = int(r.get("best_epoch2", -1))
            patience = int(r.get("patience", 0))
            patience2 = int(r.get("patience2", 0))
            all_test_fscore = list(r.get("all_test_fscore", []))
            all_test_acc = list(r.get("all_test_acc", []))
            history = list(r.get("history", []))
            best_state = (self._best_from(save_dir)
                          if ckpt_lib.has_checkpoint(save_dir, "best")
                          else self._state_cpu())
            if patience >= cfg.patience and patience2 >= cfg.patience:
                start_epoch = cfg.epochs     # the run had already stopped
            if verbose:
                print(f"resumed from epoch {start_epoch - 1} "
                      f"(best_epoch={best_epoch})")
        log_f = open(log_path, "a") if log_path else None
        try:
            for e in range(start_epoch, cfg.epochs):
                t0 = time.time()
                tr = self.run_epoch(list(train_batcher.epoch(e)), train=True,
                                    epoch=e)
                va = self.run_epoch(valid_batches, epoch=e)
                te = self.run_epoch(test_batches, epoch=e,
                                    full_report=verbose)
                all_test_fscore.append(te.fscore)
                all_test_acc.append(te.acc)
                # selection split: valid when valid_rate > 0, else test
                eval_loss, eval_fscore = ((va.loss, va.fscore)
                                          if cfg.valid_rate > 0
                                          else (te.loss, te.fscore))
                if e == 0 or (best_eval_fscore is not None
                              and best_eval_fscore < eval_fscore):
                    patience = 0
                    best_epoch, best_eval_fscore = e, eval_fscore
                    best_state = self._state_cpu()
                    if save_dir:
                        ckpt_lib.save_checkpoint(
                            save_dir, self.model,
                            meta=dict(epoch=e, eval_fscore=eval_fscore,
                                      config=dataclasses.asdict(cfg)))
                else:
                    patience += 1
                if best_eval_loss is None:
                    best_eval_loss, best_epoch2 = eval_loss, 0
                elif eval_loss < best_eval_loss:
                    best_epoch2, best_eval_loss = e, eval_loss
                    patience2 = 0
                else:
                    patience2 += 1

                row = dict(epoch=e, train_loss=tr.loss, train_acc=tr.acc,
                           train_fscore=tr.fscore, valid_loss=va.loss,
                           valid_acc=va.acc, valid_fscore=va.fscore,
                           test_loss=te.loss, test_acc=te.acc,
                           test_fscore=te.fscore,
                           time=round(time.time() - t0, 2),
                           train_dps=tr.throughput.get("dialogues_per_sec"),
                           train_ups=tr.throughput.get("utterances_per_sec"))
                history.append(row)
                if verbose:
                    print("epoch: {epoch}, train_loss: {train_loss}, "
                          "train_acc: {train_acc}, train_fscore: "
                          "{train_fscore}, valid_loss: {valid_loss}, "
                          "valid_acc: {valid_acc}, valid_fscore: "
                          "{valid_fscore}, test_loss: {test_loss}, "
                          "test_acc: {test_acc}, test_fscore: {test_fscore},"
                          " time: {time} sec".format(**row))
                    print(te.report)
                    print(te.per_class_acc)
                if log_f:
                    log_f.write(json.dumps(row) + "\n")
                    log_f.flush()
                if save_dir:
                    ckpt_lib.save_checkpoint(
                        save_dir, self.model, self.optimizer, name="last",
                        meta=dict(config=dataclasses.asdict(cfg), resume=dict(
                            epoch=e, best_epoch=best_epoch,
                            best_eval_fscore=best_eval_fscore,
                            best_eval_loss=(None if best_eval_loss is None
                                            else float(best_eval_loss)),
                            best_epoch2=best_epoch2, patience=patience,
                            patience2=patience2,
                            all_test_fscore=all_test_fscore,
                            all_test_acc=all_test_acc, history=history)))
                if patience >= cfg.patience and patience2 >= cfg.patience:
                    if verbose:
                        print("Early stoping...", patience, patience2)
                    break
        finally:
            if log_f:
                log_f.close()
        ok = best_epoch >= 0
        if verbose:
            print("Final Test performance...")
            print("Eval-metric: F1, Epoch: {}, best_eval_fscore: {}, "
                  "Accuracy: {}, F1-Score: {}".format(
                      best_epoch, best_eval_fscore,
                      all_test_acc[best_epoch] if ok else 0,
                      all_test_fscore[best_epoch] if ok else 0))
        return FitResult(
            state_dict=best_state, best_epoch=best_epoch,
            best_eval_fscore=best_eval_fscore or 0.0,
            best_test_acc=all_test_acc[best_epoch] if ok else 0.0,
            best_test_fscore=all_test_fscore[best_epoch] if ok else 0.0,
            all_test_fscore=all_test_fscore, all_test_acc=all_test_acc,
            history=history)

    def _best_from(self, save_dir: str) -> Dict[str, Tensor]:
        """The ``best`` checkpoint's weights, read without touching the
        live model."""
        model = build_model(self.cfg)
        ckpt_lib.restore_checkpoint(save_dir, model, name="best")
        return {k: v.detach().clone() for k, v in model.state_dict().items()}
