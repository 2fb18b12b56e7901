"""The grouped hyperparameter sweep (``mmdfn_tpu/train/vmap_sweep.py``):
the combinations of a grid that share their shapes train as one group,
epoch by epoch over one batcher, each with its own selection and early
stop, behind one resumable checkpoint.

The reference runs its grids as nested bash loops, one process per
combination (``script/run_train_ie.sh:26-60``).  As the JAX package does,
the group stacks the K configurations' parameters on a leading axis and
maps one train step and one eval step over them: ``torch.func.vmap`` of
``torch.func.functional_call`` over the stacked parameters (the batch is
not mapped), one ``backward()`` of the K losses' sum (the configurations
share no parameter, so each gets its own gradient), and one Adam over the
stack (``train/optim.py:StackedAdam``, JAX's ``_adam_update`` with its
freeze mask).  Every matmul of the model becomes K-times batched, and
kernels A-D run once a batch for the whole group: their wrappers' ``vmap``
rules make one launch over a config axis (``ops/bigru.py``,
``ops/gcnii.py``).  What may vary inside a group is what JAX stacks:
``lr``, ``l2``, ``gamma`` and, on the graph path, ``dropout``; any other
key must be equal across the group and folds into the shared config, and
the layer count splits a grid into groups (:func:`group_combos`: IEMOCAP's
32 combinations are 2 groups of 16, MELD's 48 are 3).

Where the port departs from the JAX group, and why:

* Dropout is seeded per configuration as its run alone would seed it:
  step i of epoch e draws from ``Trainer.step_seed(e, i)``, which depends
  on ``cfg.seed`` only, so every configuration of a group shares it, and
  the draws are made once for the group (``vmap``'s ``randomness=
  "same"``).  Configuration k therefore draws its run alone's bits, dropout
  on too.  JAX splits one key over the K configurations
  (``vmap_sweep.py:266``); its threefry draws cannot be matched anyway,
  and the reference seeds every run with 2021.
* Rates that differ ride the config axis through ``nn/drop_override.py``
  (JAX's module of that name): the sites built from ``cfg.dropout`` (tag
  ``"dropout"``) compare the shared draw with each configuration's keep
  probability, and kernels B and D read each one's keep threshold and
  scale from memory.  Under the override every tagged site draws, so a
  rate-0 configuration beside a rate-0.4 one keeps all (bit for bit its
  run alone's values) but draws where its run alone does not: an untagged
  site after it (the gated head's 0.5, TFN's 0.4, MFN's 0.2) then takes
  later bits of the step's generator than in its run alone.  A group whose
  configurations share one rate folds it into the shared config and draws
  as a run alone does.
* Focal loss's ``(1 - pt) ** gamma`` is computed for each distinct gamma
  of the group with its Python exponent, as a run alone computes it, and
  each configuration takes its own (``losses.focal_loss``).
* A frozen (early-stopped) configuration is computed but not updated: its
  parameters, Adam moments and step count stay (JAX's freeze mask).  It
  is still evaluated and still gets its history rows, with ``train_loss``
  None, as before.
* Each configuration's loss is its ``Trainer``'s (focal loss with its
  ``gamma``; the masked NLL for a non-graph baseline), and the epoch's
  train loss is aggregated as ``Trainer.run_epoch`` aggregates it.
* The batcher is JAX's group batcher: shuffled with ``cfg.seed`` and never
  sorted by length, even where ``sort_batches_by_length`` would sort a
  run alone (``mmdfn_tpu/train/trainer.py:211``).
* With a ``mesh`` (``runtime/mesh.py``; JAX: the config axis sharded
  over the mesh's data axis, ``vmap_sweep.py:160-217``), the K configs
  split into contiguous blocks over the data ranks, and each rank steps
  and evaluates its own block as one batched step (a ragged K gives the
  last rank fewer).  JAX pads the config axis with frozen copies; a block
  of its own needs none.  Every rank keeps the whole stack, and after each
  epoch the ranks exchange their configs' counters and histories, so that
  each holds the whole group's and all stop together; where the group
  checkpoints, the first rank gathers the other ranks' configurations
  (weights and Adam states) and writes them as one process does, so a cut
  group resumes on any number of ranks.
* Each configuration keeps a ``Trainer`` (``trainers[k]``) whose model's
  parameters are views of its slice of the stack, and whose optimiser is
  its slice of the stacked Adam in ``torch.optim.Adam``'s layout: the
  checkpoint holds each configuration's ``state_dict`` and Adam state as a
  run alone writes them.
* How close a configuration in a group stays to its run alone.  On the
  CPU (one thread) it is bit for bit for the models whose ops treat each
  configuration's slice as they treat it alone; the linear layers are
  made so (``nn/linear.py``: torch's batching rule for ``linear`` splits
  the bias add from the product).  A ``sigmoid`` or ``tanh`` over
  a whole contiguous tensor (the MFN and gated heads' gates, the
  DialogueRNN's cells) runs the CPU kernel's vectorised loop and scalar
  tail over other elements once K slices are stacked, a last-bit
  difference.  On the card the kernels' config-axis launches equal their
  K solo launches bit for bit, and cuBLAS's batched products and the
  batched reductions sum in another order: the group's first step is
  within 1e-7 of the solo step's loss and 4e-6 of each gradient's scale
  (``chip_smoke.py``'s sweep phase).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call, vmap

from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.data.batching import BucketBatcher
from mmdfn_torch.device import resolve_device
from mmdfn_torch.losses import focal_loss, masked_nll_loss
from mmdfn_torch.models.dialogue_gnn import TAG
from mmdfn_torch.nn import drop_override
from mmdfn_torch.runtime import checkpoint as ckpt_lib
from mmdfn_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS, is_first_rank
from mmdfn_torch.train.optim import ConfigAdam, StackedAdam
from mmdfn_torch.train.trainer import (EpochMetrics, Trainer, epoch_loss,
                                       epoch_metrics, model_text,
                                       prepare_inputs)
from mmdfn_torch.weights import build_model

Tensor = torch.Tensor


def _canon_combos(combos):
    """A combo list as the checkpoint's meta holds it (JSON's model:
    tuples become lists), so that a group compares with its own save."""
    return json.loads(json.dumps(list(combos)))


@dataclass
class GroupResult:
    """Per-config outcomes of one group run."""

    combos: List[dict]
    best_epoch: List[int]
    best_test_fscore: List[float]
    best_test_acc: List[float]
    history: List[List[dict]]           # [config][epoch] metric rows


def group_combos(combos: Sequence[dict],
                 static_keys: Sequence[str] = ("Deep_GCN_nlayers",)
                 ) -> List[Tuple[dict, List[dict]]]:
    """Partition combos by the hyperparameters that must stay static."""
    groups: Dict[tuple, List[dict]] = {}
    for c in combos:
        key = tuple((k, c[k]) for k in static_keys if k in c)
        groups.setdefault(key, []).append(c)
    return [(dict(k), v) for k, v in groups.items()]


class _GroupOptimizers:
    """The group's K optimisers as the one optimiser that
    ``runtime/checkpoint.py`` saves and restores."""

    def __init__(self, trainers: Sequence[Trainer]):
        self.trainers = trainers

    def state_dict(self) -> dict:
        return {"per_config": [tr.optimizer.state_dict()
                               for tr in self.trainers]}

    def load_state_dict(self, state: dict) -> None:
        for tr, s in zip(self.trainers, state["per_config"]):
            tr.optimizer.load_state_dict(s)


class VmapSweep:
    """Train K same-shape configs as one group: one batched step over
    their stacked parameters on every batch.

    ``model`` gives every config its starting weights (default: the shared
    config's model, fresh from ``cfg.seed``: one init for all, as JAX
    broadcasts one); ``device`` defaults to the card; ``mesh``: this
    rank's data mesh, whose ranks share the configs out."""

    def __init__(self, base_cfg: ExperimentConfig, combos: Sequence[dict],
                 device=None, model: Optional[torch.nn.Module] = None,
                 mesh=None):
        # only lr/l2/gamma/dropout may vary across a group; any other key
        # must be identical (it folds into the shared config), since a key
        # that varied would train K copies of the base value while the
        # results report the asked-for grid.  A non-graph baseline keeps
        # JAX's rule that dropout is static there (identical -> folded,
        # varying -> refused)
        STACKABLE = (("lr", "l2", "gamma", "dropout")
                     if base_cfg.graph_model else ("lr", "l2", "gamma"))
        static = {}
        keys = {k for c in combos for k in c}
        for k in keys:
            vals = [c.get(k) for c in combos]
            if k in STACKABLE:
                if k in ("lr", "l2") and any(k not in c for c in combos):
                    raise ValueError(
                        f"stackable combo key {k!r} is missing from "
                        f"{sum(k not in c for c in combos)} of "
                        f"{len(combos)} combos; every combo needs it")
                continue
            if any(v != vals[0] for v in vals):
                raise ValueError(
                    f"combo key {k!r} varies across the group but only "
                    f"{STACKABLE} can be stacked; run it as a separate "
                    "group (run_grouped_sweep splits on static_keys)")
            static[k] = vals[0]
        self.combos = list(combos)
        self.K = len(self.combos)
        self.mesh = mesh
        self._group = None
        self._own = range(self.K)
        if mesh is not None:
            if mesh[MODEL_AXIS].size() > 1:
                raise ValueError("a group shards its configs over the mesh's "
                                 "data axis; it takes no model axis")
            n, r = mesh[DATA_AXIS].size(), mesh.get_local_rank(DATA_AXIS)
            blk = -(-self.K // n)
            self._own = range(min(self.K, r * blk),
                              min(self.K, (r + 1) * blk))
            self._group = mesh[DATA_AXIS].get_group()
        self.cfg = dataclasses.replace(base_cfg, **static)
        if ("dropout" in STACKABLE
                and any("dropout" in c for c in self.combos)):
            self.droprate = [float(c.get("dropout", self.cfg.dropout))
                             for c in self.combos]
        else:
            self.droprate = None
        self.device = resolve_device(device)
        # one rate for the whole group folds into the shared config (every
        # site draws as a run alone does); rates that differ ride the
        # config axis (nn/drop_override.py)
        self._drop = None
        if self.droprate is not None:
            if len(set(self.droprate)) == 1:
                self.cfg = dataclasses.replace(self.cfg,
                                               dropout=self.droprate[0])
            else:
                self._drop = drop_override.make_drop_rate(
                    self.droprate, device=self.device)
        base = model if model is not None else build_model(self.cfg)
        self._init = {k: v.detach().cpu().clone()
                      for k, v in base.state_dict().items()}
        self.trainers: List[Trainer] = []
        for k, c in enumerate(self.combos):
            over = dict(lr=c["lr"], l2=c["l2"],
                        gamma=c.get("gamma", base_cfg.gamma))
            if self.droprate is not None:
                over["dropout"] = self.droprate[k]
            cfg_k = dataclasses.replace(self.cfg, **over)
            self.trainers.append(Trainer(cfg_k, device=self.device,
                                         model=build_model(cfg_k, self._init)))
        # the stack: parameter n of configuration k is params[n][k], and
        # configuration k's model holds views of its slices
        self.params: Dict[str, Tensor] = {}
        for n, p in self.trainers[0].model.named_parameters():
            self.params[n] = torch.stack([
                tr.model.get_parameter(n).detach() for tr in self.trainers
            ]).requires_grad_(p.requires_grad)
        for k, tr in enumerate(self.trainers):
            for n, stacked in self.params.items():
                mod, _, attr = n.rpartition(".")
                owner = tr.model.get_submodule(mod)
                setattr(owner, attr, torch.nn.Parameter(
                    stacked.detach()[k], requires_grad=stacked.requires_grad))
        # the template the batched step calls with the stacked parameters
        self.model = self.trainers[0].model
        self._models = torch.nn.ModuleList([tr.model for tr in self.trainers])
        self._optimizers = _GroupOptimizers(self.trainers)
        gammas = [tr.cfg.gamma for tr in self.trainers]
        self._gammas = tuple(dict.fromkeys(gammas))
        self._gsel = torch.tensor([self._gammas.index(g) for g in gammas],
                                  device=self.device)
        self.alpha = self.trainers[0].alpha
        self._new_adam()

    # ------------------------------------------------------------------
    def _new_adam(self) -> None:
        """A fresh stacked Adam, each config's trainer holding its slice."""
        self.adam = StackedAdam(list(self.params.values()),
                                [tr.cfg.lr for tr in self.trainers],
                                [tr.cfg.l2 for tr in self.trainers])
        for k, tr in enumerate(self.trainers):
            tr.optimizer = ConfigAdam(self.adam, k)

    def init_states(self) -> None:
        """Every config back at the group's starting weights, with a fresh
        Adam."""
        with torch.no_grad():
            for n, stacked in self.params.items():
                stacked.copy_(self._init[n].to(stacked.device).expand_as(
                    stacked))
        self._new_adam()

    def _loss(self, logp: Tensor, inputs: Dict[str, Tensor],
              gsel: Tensor) -> Tensor:
        """One configuration's loss, as its ``Trainer._loss`` (its gamma
        picked by ``gsel`` from the group's)."""
        cfg = self.cfg
        if cfg.graph_model and cfg.loss == "FocalLoss":
            return focal_loss(logp, inputs["label"], inputs["umask"],
                              gamma=(self._gammas, gsel), alpha=self.alpha)
        return masked_nll_loss(logp, inputs["label"], inputs["umask"],
                               weight=self.alpha)

    def _batched(self, inputs: Dict[str, Tensor], train: bool,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[Tensor, Tensor]:
        """This rank's configurations' losses (K,) and log-probs (K, B, L,
        C) on a batch: the model over the stacked parameters under
        ``vmap``, one draw of each dropout for all (``randomness="same"``),
        each tagged site at its configuration's rate where the rates
        differ (training only)."""
        lo, hi = self._own.start, self._own.stop
        params = {n: t[lo:hi] for n, t in self.params.items()}
        args = (model_text(self.cfg, inputs), inputs["qmask"],
                inputs["umask"], inputs["audio"], inputs["visual"])
        kw = dict(train=True, generator=generator) if train else {}
        rate = (drop_override.DropRate(*(t[lo:hi] for t in self._drop))
                if train and self._drop is not None else None)

        def one(p, gsel, rate):
            ctx = (drop_override.override({TAG: rate}) if rate is not None
                   else contextlib.nullcontext())
            with ctx:
                logp = functional_call(self.model, p, args, kw)
            return self._loss(logp, inputs, gsel), logp

        return vmap(one, in_dims=(0, 0, None if rate is None else 0),
                    randomness="same")(params, self._gsel[lo:hi], rate)

    def step(self, inputs: Dict[str, Tensor], epoch: int, i: int,
             active: Sequence[bool]) -> List[Optional[torch.Tensor]]:
        """Batch i of an epoch for the group: one batched train step of
        this rank's configurations, seeded as each one's run alone seeds
        that step, and one Adam update of the active ones; each config's
        loss, on the device (None where the config is frozen or another
        rank's)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.trainers[0].step_seed(epoch, i))
        self.adam.zero_grad()
        losses, _ = self._batched(inputs, train=True, generator=gen)
        losses.sum().backward()
        self.adam.step(active)
        losses = losses.detach()
        lo = self._own.start
        return [losses[k - lo] if k in self._own and active[k] else None
                for k in range(self.K)]

    def evaluate(self, batches) -> Dict[int, EpochMetrics]:
        """Each of this rank's configurations' metrics over ``batches``
        ((Batch, inputs) pairs), from one batched eval step a batch, as
        ``Trainer.run_epoch`` gives them for that configuration alone."""
        losses, preds, masks, labels, mask_sums = [], [], [], [], []
        with torch.no_grad():
            for batch, inputs in batches:
                loss, logp = self._batched(inputs, train=False)
                m = batch.umask.reshape(-1) > 0
                losses.append(loss)
                preds.append(logp.argmax(dim=-1))
                masks.append(m)
                mask_sums.append(float(m.sum()))
                labels.append(batch.label.reshape(-1)[m])
        own = list(self._own)
        if not losses:
            nan, empty = float("nan"), np.zeros((0,), np.int64)
            return {k: EpochMetrics(nan, nan, nan, empty, empty)
                    for k in own}
        # one copy back per epoch
        losses = torch.stack(losses).cpu().numpy().astype(np.float64)
        preds = [p.reshape(len(own), -1).cpu().numpy() for p in preds]
        return {k: epoch_metrics(self.trainers[k].cfg, losses[:, j],
                                 [p[j][m] for p, m in zip(preds, masks)],
                                 labels, mask_sums)
                for j, k in enumerate(own)}

    def _result(self, best_epoch, all_f, all_a, history) -> GroupResult:
        K = self.K
        return GroupResult(
            combos=self.combos,
            best_epoch=[int(b) for b in best_epoch],
            best_test_fscore=[all_f[k][best_epoch[k]] for k in range(K)],
            best_test_acc=[all_a[k][best_epoch[k]] for k in range(K)],
            history=history)

    def _exchange(self, rows: Dict[int, tuple]) -> Dict[int, tuple]:
        """Every rank's per-config rows (config index -> row), on every
        rank."""
        if self.mesh is None:
            return rows
        got: List[Dict[int, tuple]] = [None] * dist.get_world_size(
            self._group)
        dist.all_gather_object(got, rows, group=self._group)
        return {k: v for part in got for k, v in part.items()}

    def _gather_states(self) -> None:
        """On the first rank, every other rank's configs' models and Adam
        states, loaded into its own copies of them (which put them back
        on its device).  Both travel on the host, so that no rank's card
        tensors are unpickled on the first rank's process."""
        if self.mesh is None:
            return
        host = lambda v: v.detach().cpu() if torch.is_tensor(v) else v
        mine = {}
        for k in self._own:
            opt = self.trainers[k].optimizer.state_dict()
            opt["state"] = {i: {n: host(v) for n, v in st.items()}
                            for i, st in opt["state"].items()}
            mine[k] = ({n: host(v) for n, v in
                        self.trainers[k].model.state_dict().items()}, opt)
        first = is_first_rank()
        got = [None] * dist.get_world_size(self._group) if first else None
        dist.gather_object(mine, got, dst=dist.get_global_rank(
            self._group, 0), group=self._group)
        if first:
            for part in got:
                for k, (model, opt) in part.items():
                    self.trainers[k].model.load_state_dict(model)
                    self.trainers[k].optimizer.load_state_dict(opt)

    def run(self, train_dialogues, test_dialogues, verbose: bool = True,
            save_dir: Optional[str] = None,
            resume: bool = False) -> GroupResult:
        """Train the group from its starting weights; with ``save_dir``,
        resumable.

        Every epoch writes a ``last`` checkpoint (the K models, the K Adam
        states and the selection counters) and the end a ``final`` one
        carrying the :class:`GroupResult`.  ``resume=True`` skips a group
        whose ``final`` exists, and otherwise continues from ``last`` at
        the next epoch, step for step as a run that was not cut (the seeds
        and the batcher's order depend on the epoch and step only).  On a
        mesh every rank runs this and returns the whole group's result;
        the first alone prints and writes."""
        cfg = self.cfg
        verbose = verbose and is_first_rank()
        info = cfg.info
        K = self.K
        canon = _canon_combos(self.combos)
        batcher = BucketBatcher(train_dialogues, cfg.batch_size,
                                info["n_speakers"], cfg.buckets,
                                shuffle=True, seed=cfg.seed)
        if resume and save_dir and ckpt_lib.has_checkpoint(save_dir, "final"):
            meta = ckpt_lib.read_meta(save_dir, "final")
            if meta.get("combos") != canon:
                raise ValueError(
                    f"final checkpoint under {save_dir!r} was written for a "
                    "different combo group; point each group at its own "
                    "save_dir")
            if verbose:
                print(f"group already complete under {save_dir!r} — skipping")
            return GroupResult(combos=self.combos,
                               best_epoch=meta["best_epoch"],
                               best_test_fscore=meta["best_test_fscore"],
                               best_test_acc=meta["best_test_acc"],
                               history=meta["history"])
        self.init_states()
        test_batches = [(b, prepare_inputs(b, self.device,
                                           cfg.transfer_dtype)) for b in
                        BucketBatcher(test_dialogues, cfg.batch_size,
                                      info["n_speakers"],
                                      cfg.buckets).epoch()]

        best_f = np.full(K, -1.0)
        best_epoch = np.full(K, -1, dtype=int)
        best_loss = np.full(K, np.inf)
        patience = np.zeros(K, dtype=int)
        patience2 = np.zeros(K, dtype=int)
        all_f: List[List[float]] = [[] for _ in range(K)]
        all_a: List[List[float]] = [[] for _ in range(K)]
        history: List[List[dict]] = [[] for _ in range(K)]
        stop = np.zeros(K, dtype=bool)
        start_epoch = 0

        if resume and save_dir and ckpt_lib.has_checkpoint(save_dir, "last"):
            # the group is checked before its weights load: another
            # group's may not even fit these models
            if ckpt_lib.read_meta(save_dir, "last").get("combos") != canon:
                raise ValueError(
                    f"'last' checkpoint under {save_dir!r} was written for a "
                    "different combo group")
            _, meta = ckpt_lib.restore_checkpoint(
                save_dir, self._models, self._optimizers, name="last")
            r = meta["counters"]
            start_epoch = int(meta["epoch"]) + 1
            best_f = np.asarray(r["best_f"])
            best_epoch = np.asarray(r["best_epoch"], dtype=int)
            best_loss = np.asarray(r["best_loss"], dtype=np.float64)
            patience = np.asarray(r["patience"], dtype=int)
            patience2 = np.asarray(r["patience2"], dtype=int)
            all_f = [list(x) for x in r["all_f"]]
            all_a = [list(x) for x in r["all_a"]]
            history = [list(x) for x in r["history"]]
            stop = np.asarray(r["stop"], dtype=bool)
            if verbose:
                print(f"resumed group from epoch {start_epoch - 1} "
                      f"({int(K - stop.sum())}/{K} configs active)")
            if stop.all():
                start_epoch = cfg.epochs    # had fully early-stopped already

        for e in range(start_epoch, cfg.epochs):
            frozen = stop.copy()
            active = np.zeros(K, dtype=bool)
            active[list(self._own)] = True
            active &= ~frozen
            losses: List[List[torch.Tensor]] = [[] for _ in range(K)]
            mask_sums: List[float] = []
            for i, batch in enumerate(batcher.epoch(e)):
                if active.any():
                    inputs = prepare_inputs(batch, self.device,
                                            self.cfg.transfer_dtype)
                    for k, loss in enumerate(self.step(inputs, e, i,
                                                       active)):
                        if loss is not None:
                            losses[k].append(loss)
                mask_sums.append(float((batch.umask > 0).sum()))
            evaluated = self.evaluate(test_batches)
            for k in self._own:
                tr = self.trainers[k]
                te = evaluated[k]
                train_loss = (epoch_loss(tr.cfg, torch.stack(losses[k]).cpu()
                                         .numpy().astype(np.float64),
                                         mask_sums)
                              if losses[k] else None)
                all_f[k].append(te.fscore)
                all_a[k].append(te.acc)
                history[k].append(dict(
                    epoch=e, train_loss=train_loss, test_fscore=te.fscore,
                    test_acc=te.acc, test_loss=te.loss))
                if frozen[k]:
                    continue
                if e == 0 or te.fscore > best_f[k]:
                    best_f[k], best_epoch[k], patience[k] = te.fscore, e, 0
                else:
                    patience[k] += 1
                if e == 0 or te.loss < best_loss[k]:
                    best_loss[k], patience2[k] = te.loss, 0
                else:
                    patience2[k] += 1
            rows = self._exchange({k: (
                all_f[k], all_a[k], history[k], best_f[k], best_epoch[k],
                best_loss[k], patience[k], patience2[k]) for k in self._own})
            for k, row in rows.items():
                (all_f[k], all_a[k], history[k], best_f[k], best_epoch[k],
                 best_loss[k], patience[k], patience2[k]) = row
            stop = (patience >= cfg.patience) & (patience2 >= cfg.patience)
            if save_dir:
                self._gather_states()
            if save_dir and is_first_rank():
                ckpt_lib.save_checkpoint(
                    save_dir, self._models, self._optimizers, name="last",
                    meta=dict(epoch=e, combos=canon, counters=dict(
                        best_f=best_f.tolist(),
                        best_epoch=best_epoch.tolist(),
                        best_loss=best_loss.tolist(),
                        patience=patience.tolist(),
                        patience2=patience2.tolist(),
                        all_f=all_f, all_a=all_a, history=history,
                        stop=stop.tolist())))
            if verbose:
                print(f"epoch {e}: fscores "
                      f"{[all_f[k][-1] for k in range(K)]} "
                      f"active {int(K - stop.sum())}/{K}")
            if stop.all():
                break

        result = self._result(best_epoch, all_f, all_a, history)
        if save_dir:
            self._gather_states()
        if save_dir and is_first_rank():
            # 'final' makes a finished group skip on the next invocation
            ckpt_lib.save_checkpoint(
                save_dir, self._models, self._optimizers, name="final",
                meta=dict(combos=canon, best_epoch=result.best_epoch,
                          best_test_fscore=result.best_test_fscore,
                          best_test_acc=result.best_test_acc,
                          history=result.history))
        return result


def run_grouped_sweep(base_cfg: ExperimentConfig, combos: Sequence[dict],
                      train_dialogues, test_dialogues,
                      verbose: bool = True, device=None, mesh=None,
                      save_dir: Optional[str] = None,
                      resume: bool = False) -> List[GroupResult]:
    """Partition a sweep grid into static groups and train each as one
    (with ``mesh``, each group's configs shared out over its data ranks).

    With ``save_dir``, each group checkpoints under
    ``<save_dir>/group_<slug>`` (named by its static keys), so a cut sweep
    resumes mid-group and skips finished groups."""
    results = []
    where = ("" if mesh is None else
             f" over {mesh[DATA_AXIS].size()} data ranks")
    for static, group in group_combos(combos):
        if verbose and is_first_rank():
            print(f"group {static}: {len(group)} configs, one batched "
                  f"step{where}")
        group_dir = None
        if save_dir:
            slug = "_".join(f"{k}{v}" for k, v in sorted(static.items())) \
                or "base"
            group_dir = os.path.join(save_dir, f"group_{slug}")
        cfg = dataclasses.replace(base_cfg, **static)
        sweep = VmapSweep(cfg, group, device=device, mesh=mesh)
        results.append(sweep.run(train_dialogues, test_dialogues, verbose,
                                 save_dir=group_dir, resume=resume))
    return results
