"""Training and evaluation engine (``mmdfn_tpu/train/trainer.py:235-568``,
reference ``code/run_train_erc.py:92-238,554-644``), on the card unless the
caller asks for the CPU.

One train step is the model's training forward (every dropout drawn from a
generator seeded for that step), the loss, ``backward()`` through kernels C
and D, and one Adam update.  The host never waits for the card inside an
epoch: losses and predictions stay on the device until the epoch ends.

Reference-parity details, as the JAX trainer keeps them:
* the model's input: the text features, or for the single stream the
  chosen modality or the concatenation ``ExperimentConfig.input_modals``
  names (``mmdfn_tpu/train/trainer.py:88-113``), built on the device;
* graph-path loss = ``cfg.loss`` (focal by default), mean over valid
  utterances; epoch loss = mean of the batch losses, rounded to 4 places
  (``run_train_erc.py:202,222``); the non-graph baselines always take the
  masked NLL, and their epoch loss weights each batch by its valid
  utterances (``mmdfn_tpu/train/trainer.py:131-132,381-385``);
* accuracy and sklearn-weighted F1 (``run_train_erc.py:229-236``);
* selection on test when ``valid_rate == 0`` and the dual patience of
  early stopping (``run_train_erc.py:609-638``);
* the per-epoch reseed quirk (``run_train_erc.py:164``): with
  ``faithful_epoch_reseed`` every epoch draws the same per-step seed stream,
  as ``_epoch_key`` returns the same key (``trainer.py:294-298``).

With ``grad_hist_bins`` set (64 under the CLI's ``--tensorboard``), every
training step also reduces each parameter's gradient to a histogram row on
the device, and the epoch hands the rows to ``grad_hist_sink`` once its
losses are copied back (``mmdfn_tpu/train/trainer.py:133-138,264-270``).

With a ``mesh`` (``runtime/mesh.py``; ``mmdfn_tpu/train/trainer.py:117-127,
145-155,300-304,452-456``), this process is one rank of a data-parallel
(and, on the graph path, node-sharded) run.  JAX's GSPMD makes that the
single-device step; here each part is explicit:
* every rank collates the same global batch (the same shuffle seed) and
  takes its block of ``B / n_data`` dialogues (``shard_batch``);
* each rank's loss divides its sum by the whole batch's denominator (the
  mask's sum over the data ranks), so the ranks' losses add up to the
  batch's loss and their gradients to its gradient; after ``backward()``
  one flat all-reduce over the data axis sums the gradients and the
  loss, which every rank then reports;
* with a model axis, the GCNII stacks' ``adj @ h`` is the node-sharded
  product (``parallel/graph_parallel.py``), whose gradients come out
  whole on every model rank: nothing is reduced over the model axis;
* the dropout seed of a step folds in the data rank (rank 0's is the
  seed of a run without a mesh), so the ranks of one model group draw the
  same masks;
* predictions are gathered over the data axis before the epoch's metrics;
* the mesh's first rank alone prints, logs and writes checkpoints (the
  module's own ``state_dict``: no wrapper prefix on its keys), and a
  resumed state is broadcast from it.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.data.batching import Batch, BucketBatcher
from mmdfn_torch.device import resolve_device
from mmdfn_torch.losses import focal_loss, masked_nll_loss
from mmdfn_torch.runtime import checkpoint as ckpt_lib
from mmdfn_torch.runtime.mesh import (DATA_AXIS, MODEL_AXIS, all_gather,
                                      is_first_rank, replicate, shard_batch)
from mmdfn_torch.runtime.profiling import (ThroughputMeter, annotate,
                                           grad_histograms_device,
                                           histograms_to_host)
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


def to_device(a, device: torch.device) -> Tensor:
    """An array (or a host tensor) as a tensor on ``device``: on the card
    from a pinned host copy, so that the copy does not block the host."""
    t = a if isinstance(a, Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def prepare_inputs(batch: Batch, device: torch.device,
                   transfer_dtype: str = "float32") -> Dict[str, Tensor]:
    """The batch's arrays as tensors on ``device`` (:func:`to_device`).
    ``transfer_dtype='bfloat16'`` (``mmdfn_tpu/train/trainer.py:106-107``):
    the features rounded to bf16 on the host, copied as bf16 (half the
    bytes) and widened to f32 on the device."""
    put = lambda a: to_device(a, device)
    if transfer_dtype == "bfloat16":
        feat = lambda a: put(torch.from_numpy(np.ascontiguousarray(
            a, dtype=np.float32)).to(torch.bfloat16)).float()
    elif transfer_dtype == "float32":
        feat = put
    else:
        raise ValueError(f"transfer_dtype {transfer_dtype!r}")
    with annotate("data.to_device"):
        return dict(text=feat(batch.text), audio=feat(batch.audio),
                    visual=feat(batch.visual), qmask=put(batch.qmask),
                    umask=put(batch.umask), label=put(batch.label))


def model_text(cfg: ExperimentConfig, inputs: Dict[str, Tensor]) -> Tensor:
    """The model's ``text`` argument from a batch's features: the
    modalities of ``cfg.input_modals``, concatenated in that order."""
    feats = {"a": inputs["audio"], "v": inputs["visual"],
             "l": inputs["text"]}
    modals = cfg.input_modals
    if len(modals) == 1:
        return feats[modals]
    return torch.cat([feats[m] for m in modals], dim=-1)


def epoch_loss(cfg: ExperimentConfig, losses: np.ndarray,
               mask_sums: Sequence[float]) -> float:
    """An epoch's loss from its batch losses (float64), rounded to 4
    places: their mean on the graph path, else weighted by each batch's
    valid utterances."""
    if cfg.graph_model:
        loss = np.sum(losses) / len(losses)
    else:
        loss = np.sum(losses * np.asarray(mask_sums)) / np.sum(mask_sums)
    return round(float(loss), 4)


def epoch_metrics(cfg: ExperimentConfig, losses: np.ndarray,
                  preds: Sequence[np.ndarray], labels: Sequence[np.ndarray],
                  mask_sums: Sequence[float]) -> EpochMetrics:
    """An epoch's metrics from its batch losses (float64) and each batch's
    predictions and labels at its valid utterances."""
    labels, preds = np.concatenate(labels), np.concatenate(preds)
    n_classes = cfg.info["n_classes"]
    return EpochMetrics(
        loss=epoch_loss(cfg, losses, mask_sums),
        acc=M.reference_rounding(M.accuracy(labels, preds)),
        fscore=M.reference_rounding(M.f1_score(labels, preds, n_classes)),
        labels=labels, preds=preds)


class Trainer:
    """Trains the port's ``DialogueGNN`` (any graph family, multimodal or
    single-stream) or a non-graph baseline with the reference's loss,
    optimiser and selection rules.

    ``model`` defaults to the config's model with fresh weights from
    ``cfg.seed``; ``device`` to the card (it raises without one unless
    ``device="cpu"``).  ``mesh``: this rank's ``(data, model)`` mesh
    (``runtime.mesh.make_mesh``), or None for one process.
    """

    _token_inputs = False        # DailyTrainer's token-id batches

    def __init__(self, cfg: ExperimentConfig, device=None,
                 model: Optional[torch.nn.Module] = None, mesh=None):
        if (cfg.dataset == "DailyDialogue") != self._token_inputs:
            raise ValueError(
                f"dataset {cfg.dataset!r}: DailyDialogue's token batches "
                "train with DailyTrainer, every other dataset with Trainer")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self._data_group, self._data_rank = None, 0
        gcn_spmm = None
        if mesh is not None:
            n_data = mesh[DATA_AXIS].size()
            if cfg.batch_size % n_data != 0:
                raise ValueError(
                    f"batch_size={cfg.batch_size} must be divisible by the "
                    f"mesh data axis ({n_data} devices) — every collated "
                    "batch is padded to exactly batch_size dialogues")
            self._data_group = mesh[DATA_AXIS].get_group()
            self._data_rank = mesh.get_local_rank(DATA_AXIS)
            if mesh[MODEL_AXIS].size() > 1:
                if self._token_inputs:
                    raise ValueError(
                        "DailyDialogue's model has no node-sharded path (as "
                        "in mmdfn_tpu); its mesh takes a data axis alone")
                if model is not None:
                    raise ValueError(
                        "a mesh with a model axis builds the model with the "
                        "node-sharded product: pass no model")
                if cfg.graph_model:
                    from mmdfn_torch.parallel import sharded_spmm_batched
                    gcn_spmm = functools.partial(sharded_spmm_batched, mesh)
        self.model = (model if model is not None
                      else build_model(cfg, gcn_spmm=gcn_spmm)
                      ).to(self.device)
        if mesh is not None:
            replicate(mesh, self.model)
        self.optimizer = torch_adam(self.model.parameters(), cfg.lr, cfg.l2)
        alpha = cfg.class_weights_or_none()
        self.alpha = (None if alpha is None
                      else torch.as_tensor(alpha, device=self.device))
        # bins of each training step's gradient histograms (0: none), and
        # the callback (global step, {parameter: row of host arrays}) that
        # receives them at the end of each epoch
        self.grad_hist_bins = 0
        self.grad_hist_sink: Optional[Callable[[int, Dict], None]] = None

    # ------------------------------------------------------------------
    def _global_sum(self, t: Tensor) -> Tensor:
        """``t`` summed over the data axis (a copy)."""
        t = t.detach().clone()
        dist.all_reduce(t, group=self._data_group)
        return t

    def _loss(self, log_probs: Tensor, label: Tensor, umask: Tensor) -> Tensor:
        """This rank's part of the batch's loss: with a mesh, its block's
        sum over the whole batch's denominator."""
        kw = {} if self.mesh is None else {"global_sum": self._global_sum}
        if self.cfg.graph_model and self.cfg.loss == "FocalLoss":
            return focal_loss(log_probs, label, umask, gamma=self.cfg.gamma,
                              alpha=self.alpha, **kw)
        return masked_nll_loss(log_probs, label, umask, weight=self.alpha,
                               **kw)

    def _forward(self, inputs: Dict[str, Tensor], **kw) -> Tensor:
        return self.model(model_text(self.cfg, inputs), inputs["qmask"],
                          inputs["umask"], inputs["audio"], inputs["visual"],
                          **kw)

    def step_seed(self, epoch: int, i: int) -> int:
        """The seed of step i of an epoch: the same stream every epoch with
        ``faithful_epoch_reseed``, else one per epoch."""
        e = 0 if self.cfg.faithful_epoch_reseed else epoch + 1
        state = np.random.SeedSequence([self.cfg.seed, e, i]).generate_state(
            1, np.uint64)
        return int(state[0] >> np.uint64(1))

    def rank_seed(self, seed: int) -> int:
        """The dropout seed of a step on this rank: ``seed`` itself on data
        rank 0 (and without a mesh), else ``seed`` folded with the data
        rank; the ranks of one model group share it."""
        if self._data_rank == 0:
            return seed
        state = np.random.SeedSequence([seed, self._data_rank]
                                       ).generate_state(1, np.uint64)
        return int(state[0] >> np.uint64(1))

    def train_step(self, inputs: Dict[str, Tensor], seed: int
                   ) -> Tuple[Tensor, Tensor]:
        """One optimiser step; returns (loss, predictions), on the device:
        with a mesh, the whole batch's loss and this rank's block's
        predictions.  The step's gradients (with a mesh, summed over the
        data axis) stay in the parameters' ``.grad``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.rank_seed(seed))
        self.optimizer.zero_grad(set_to_none=True)
        logp = self._forward(inputs, train=True, generator=gen)
        loss = self._loss(logp, inputs["label"], inputs["umask"])
        loss.backward()
        loss = loss.detach()
        if self.mesh is not None:
            loss = self._sum_gradients(loss)
        self.optimizer.step()
        return loss, logp.detach().argmax(dim=-1)

    def _sum_gradients(self, loss: Tensor) -> Tensor:
        """Sum every gradient and the loss over the data axis in one flat
        all-reduce; returns the summed loss.  A trained parameter without
        a gradient raises: the ranks' buffers would not line up."""
        named = [(n, p) for n, p in self.model.named_parameters()
                 if p.requires_grad]
        missing = [n for n, p in named if p.grad is None]
        if missing:
            raise RuntimeError(
                f"no gradient reached {missing}: a data-parallel step sums "
                "every trained parameter's gradient over the ranks")
        grads = [p.grad for _, p in named]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        dist.all_reduce(flat, group=self._data_group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return flat[-1]

    def eval_step(self, inputs: Dict[str, Tensor]) -> Tuple[Tensor, Tensor]:
        """(loss, predictions) on the device: with a mesh, the whole
        batch's loss and this rank's block's predictions."""
        with torch.no_grad():
            logp = self._forward(inputs)
            loss = self._loss(logp, inputs["label"], inputs["umask"])
            if self.mesh is not None:
                loss = self._global_sum(loss)
        return loss, logp.argmax(dim=-1)

    def _prepare(self, batch) -> Dict[str, Tensor]:
        """A batch's arrays as tensors on the trainer's device."""
        return prepare_inputs(batch, self.device, self.cfg.transfer_dtype)

    def _put(self, batch) -> Dict[str, Tensor]:
        """The step's inputs: the batch, or with a mesh this rank's block
        of it, on the device."""
        if self.mesh is None:
            return self._prepare(batch)
        return self._prepare(shard_batch(self.mesh, batch))

    def _batcher(self, dialogues, shuffle: bool = False) -> BucketBatcher:
        cfg = self.cfg
        return BucketBatcher(dialogues, cfg.batch_size,
                             cfg.info["n_speakers"], cfg.buckets,
                             shuffle=shuffle, seed=cfg.seed,
                             sort_by_length=(cfg.sort_batches_by_length
                                             and shuffle))

    # ------------------------------------------------------------------
    def run_epoch(self, batches: Sequence, train: bool = False,
                  epoch: int = 0, full_report: bool = False) -> EpochMetrics:
        """One pass over ``batches`` (``Batch`` objects, or (Batch, inputs)
        pairs prepared once); mirrors ``train_or_eval_graph_model``."""
        cfg = self.cfg
        losses, preds, masks, labels, mask_sums = [], [], [], [], []
        hist_rows = []
        n_dia = n_utt = 0
        meter = ThroughputMeter()
        meter.start()
        for i, item in enumerate(batches):
            batch, inputs = (item if isinstance(item, tuple)
                             else (item, self._put(item)))
            n_dia += int((batch.umask.sum(-1) > 0).sum())
            n_utt += batch.n_valid
            if train:
                loss, pred = self.train_step(inputs, self.step_seed(epoch, i))
                if self.grad_hist_bins:
                    hist_rows.append(grad_histograms_device(
                        {n: p.grad for n, p in self.model.named_parameters()
                         if p.grad is not None}, self.grad_hist_bins))
            else:
                loss, pred = self.eval_step(inputs)
            m = batch.umask.reshape(-1) > 0
            losses.append(loss)
            preds.append(pred)
            masks.append(m)
            mask_sums.append(float(m.sum()))
            labels.append(batch.label.reshape(-1)[m])
        if not losses:
            nan, empty = float("nan"), np.zeros((0,), np.int64)
            return EpochMetrics(nan, nan, nan, empty, empty)
        if self.mesh is not None:
            preds = self._gather_predictions(preds)
        # one copy back per epoch, not one wait per step
        losses = torch.stack(losses).cpu().numpy().astype(np.float64)
        preds = [p.reshape(-1).cpu().numpy()[m] for p, m in zip(preds, masks)]
        meter.stop(n_dia, n_utt)
        if hist_rows and self.grad_hist_sink is not None:
            # the rows' global step numbers, from the optimiser's step
            # count after the epoch (one step a batch; a resumed run's
            # restored count included)
            last = self._optimizer_steps()
            for k, hists in enumerate(histograms_to_host(hist_rows)):
                self.grad_hist_sink(last - len(hist_rows) + k + 1, hists)
        result = epoch_metrics(cfg, losses, preds, labels, mask_sums)
        result.throughput = meter.summary()
        if full_report:
            names = cfg.info["target_names"]
            result.report = M.classification_report(result.labels,
                                                    result.preds, names)
            result.per_class_acc = M.per_class_accuracy(result.labels,
                                                        result.preds, names)
        return result

    def _gather_predictions(self, preds: List[Tensor]) -> List[Tensor]:
        """Each batch's predictions over the whole batch, in its order: the
        data ranks' blocks of every batch, in one all-gather."""
        sizes = [p.numel() for p in preds]
        flat = torch.cat([p.reshape(-1) for p in preds])
        by_rank = all_gather(flat, self._data_group).view(-1, flat.numel())
        return list(torch.split(by_rank, sizes, dim=1))

    def _optimizer_steps(self) -> int:
        """Adam's step count (``TrainState.step`` in the JAX trainer)."""
        for state in self.optimizer.state.values():
            return int(state["step"])
        return 0

    def evaluate(self, dialogues) -> EpochMetrics:
        return self.run_epoch(list(self._batcher(dialogues).epoch()),
                              full_report=True)

    def dump_activations(self, dialogues, out_path: str) -> str:
        """Save every submodule's output for the first eval batch, keyed by
        its module name (``<name>/k`` for the k-th tensor of a tuple
        output; the whole model's as ``model``), as one ``.npz``: the
        reference's ``test_label`` per-layer dumps (``model_GCN.py:474-480``),
        as ``mmdfn_tpu``'s ``Trainer.dump_activations`` writes them by flax
        module path.  Every rank of a mesh runs the forward on the whole
        batch (a model axis's ranks take part in its products); the first
        writes the file."""
        batch = next(iter(self._batcher(dialogues).epoch()))
        inputs = self._prepare(batch)
        out: Dict[str, np.ndarray] = {}

        def hook(name):
            def save(module, args, output):
                if isinstance(output, Tensor):
                    out[name] = output.detach().cpu().numpy()
                else:
                    for i, t in enumerate(output):
                        out[f"{name}/{i}"] = t.detach().cpu().numpy()
            return save

        handles = [m.register_forward_hook(hook(name or "model"))
                   for name, m in self.model.named_modules()]
        try:
            with torch.no_grad():
                self._forward(inputs)
        finally:
            for h in handles:
                h.remove()
        if is_first_rank():
            np.savez(out_path, **out)
        return out_path

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
        counters); ``resume=True`` continues from ``last``.  On a mesh
        every rank runs this; the first alone prints, logs and writes.
        """
        cfg = self.cfg
        first = is_first_rank()
        verbose = verbose and first
        log_path = log_path if first else None
        writes = save_dir if first else None
        train_batcher = self._batcher(train_dialogues, shuffle=True)
        # the fixed eval splits are copied to the device once
        prep = lambda dias: [(b, self._put(b))
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
        if resume and not can_resume and first:
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
            if self.mesh is not None:
                # every rank read the same file; the state is the first
                # rank's all the same, as JAX replicates it
                replicate(self.mesh, self.model)
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
                    if writes:
                        ckpt_lib.save_checkpoint(
                            writes, self.model,
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
                if writes:
                    ckpt_lib.save_checkpoint(
                        writes, self.model, self.optimizer, name="last",
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
