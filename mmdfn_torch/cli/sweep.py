"""The reference's hyperparameter sweeps (``script/run_train_ie.sh`` and
``run_train_me.sh``: nested bash loops, one process per combination) as
one process (``mmdfn_tpu/cli/sweep.py``):

  IEMOCAP: layers {16,32} x lr {1e-4,3e-4} x l2 {1e-4,2e-4} x dp {0.2,0.4}
           x gamma {0.5,1}, speaker_weights 3-0-1, --class_weight --reason_flag
  MELD:    layers {64,32,16} x lr {5e-4,1e-3} x l2 {1e-4,5e-4} x dp {0.4,0.2}
           x gamma {0.5,1}, speaker_weights 0.5-0.5-1.5, --reason_flag

By default the combinations train one after another.  Each trains under
``<out_dir>/<tag>`` with resume, so a preempted one continues from its
``last`` checkpoint; a finished one holds a ``final`` checkpoint (its
selected weights, the summary row as meta) and is skipped by later runs,
and ``summary.jsonl`` gains a row only for a combination finished in this
run.  With ``--vmap`` the combinations of one layer count train as one
group (``train/vmap_sweep.py``: IEMOCAP as 2 groups of 16, MELD as 3)
under ``<out_dir>/group_<slug>``, resumed and skipped the same way, and
``summary.jsonl`` is rewritten with every group's rows.  With
``--n_data_devices K`` a group's combinations are shared out over K ranks
(``runtime/launch.py``: one a card on NCCL, ``--device cpu`` on the CPU,
``--device cuda:N`` every rank on card N over gloo); the first rank
writes the checkpoints and the summary, as one process does.
``--graph_type`` runs the grid on another multimodal graph family than the
scripts' GDF (its tags then start with the family's name);
``mmdfn_tpu``'s sweep has no such flag.

Usage:
  python -m mmdfn_torch.cli.sweep --dataset MELD --data_dir .../features.pkl \\
      [--epochs 30] [--out_dir outputs/sweep_meld] [--limit N] [--vmap]
      [--n_data_devices K]
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import time

GRIDS = {
    "IEMOCAP": dict(
        Deep_GCN_nlayers=[16, 32], lr=[1e-4, 3e-4], l2=[1e-4, 2e-4],
        dropout=[0.2, 0.4], gamma=[0.5, 1.0],
        fixed=dict(speaker_weights="3-0-1", class_weight=True,
                   reason_flag=True, graph_type="GDF", valid_rate=0.0),
    ),
    "MELD": dict(
        Deep_GCN_nlayers=[64, 32, 16], lr=[5e-4, 1e-3], l2=[1e-4, 5e-4],
        dropout=[0.4, 0.2], gamma=[0.5, 1.0],
        fixed=dict(speaker_weights="0.5-0.5-1.5", class_weight=False,
                   reason_flag=True, graph_type="GDF", valid_rate=0.0),
    ),
}


def combos(dataset: str):
    grid = dict(GRIDS[dataset])
    fixed = grid.pop("fixed")
    keys = list(grid)
    for values in itertools.product(*(grid[k] for k in keys)):
        yield {**fixed, **dict(zip(keys, values))}


def combo_tag(c: dict) -> str:
    tag = ("L{Deep_GCN_nlayers}_lr{lr}_l2{l2}_dp{dropout}_g{gamma}"
           .format(**c))
    return tag if c["graph_type"] == "GDF" else f"{c['graph_type']}_{tag}"


def build_parser() -> argparse.ArgumentParser:
    """``mmdfn_tpu/cli/sweep.py``'s flags with their defaults, and the
    port's ``--graph_type`` and ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="IEMOCAP", choices=sorted(GRIDS))
    ap.add_argument("--data_dir", type=str, required=True)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=32, dest="batch_size")
    ap.add_argument("--out_dir", type=str, default=None)
    ap.add_argument("--limit", type=int, default=0,
                    help="run only the first N combos (0 = all)")
    ap.add_argument("--seed", type=int, default=2021)
    ap.add_argument("--graph_type", default="GDF",
                    choices=["GDF", "GF", "GF2", "DeepGCN", "GCN3",
                             "relation", "None"],
                    help="the graph family the grid trains")
    ap.add_argument("--vmap", action="store_true", default=False,
                    help="train the combinations of one layer count as one "
                         "group, one batched step over their stacked "
                         "parameters a batch (lr, l2, gamma and dropout "
                         "vary inside a group): IEMOCAP 2x16, MELD 3x16")
    ap.add_argument("--n_data_devices", type=int, default=0,
                    help="with --vmap: share a group's combinations out "
                         "over this many devices (config parallelism; each "
                         "device trains its slice of the grid)")
    ap.add_argument("--tpu_fast", action="store_true", default=False,
                    help="run every combination in the JAX package's "
                         "production configuration (the preset of "
                         "run_train_erc --tpu_fast): the GDF/GF stack in "
                         "the TPU training kernel's bf16 numerics, GF2's and "
                         "DeepGCN's in JAX's bf16 layer scan's")
    ap.add_argument("--device", type=str, default=None,
                    help="'cuda' (the default) or 'cpu'; with "
                         "--n_data_devices, 'cuda:N' runs every rank on "
                         "card N over gloo")
    return ap


def base_config(args):
    """The configuration every combination starts from
    (``mmdfn_tpu/cli/sweep.py:102-106``)."""
    from mmdfn_torch.config import ExperimentConfig

    base = ExperimentConfig(dataset=args.dataset, epochs=args.epochs,
                            batch_size=args.batch_size, seed=args.seed)
    return base.with_tpu_fast() if args.tpu_fast else base


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.vmap and args.n_data_devices:
        from mmdfn_torch.runtime import launch
        device = args.device or "cuda"
        return max(launch.run(_vmap_rank, args.n_data_devices, args,
                              device=device,
                              share_device=launch.names_one_card(device)))
    return _sweep(args)


def _vmap_rank(args) -> int:
    """One rank of a sharded ``--vmap`` sweep: its data mesh, then the
    sweep."""
    from mmdfn_torch.runtime.mesh import make_mesh

    return _sweep(args, make_mesh(n_data=args.n_data_devices))


def _sweep(args, mesh=None) -> int:
    out_dir = args.out_dir or f"outputs/sweep_{args.dataset.lower()}"
    os.makedirs(out_dir, exist_ok=True)

    from mmdfn_torch.cli.run_train_erc import load_dialogues
    from mmdfn_torch.config import ExperimentConfig
    from mmdfn_torch.runtime import checkpoint as ckpt_lib
    from mmdfn_torch.runtime.mesh import is_first_rank
    from mmdfn_torch.train import Trainer

    base = base_config(args)
    train, valid, test = load_dialogues(base, args.data_dir)

    summary_path = os.path.join(out_dir, "summary.jsonl")
    best = None
    todo = [dict(c, graph_type=args.graph_type)
            for c in combos(args.dataset)]
    if args.limit:
        todo = todo[: args.limit]

    if args.vmap:
        from mmdfn_torch.train.vmap_sweep import run_grouped_sweep
        results = run_grouped_sweep(base, todo, train, test, verbose=True,
                                    device=args.device, mesh=mesh,
                                    save_dir=out_dir, resume=True)
        if not is_first_rank():
            return 0
        # mode "w", not "a": resume returns every group's rows on every
        # invocation (finished groups from their 'final' checkpoints), so
        # rewriting keeps summary.jsonl the same across re-runs
        with open(summary_path, "w") as f:
            for res in results:
                for k, combo in enumerate(res.combos):
                    row = dict(tag=combo_tag(combo), **combo,
                               best_epoch=res.best_epoch[k],
                               best_test_fscore=res.best_test_fscore[k],
                               best_test_acc=res.best_test_acc[k])
                    f.write(json.dumps(row) + "\n")
                    if best is None or (row["best_test_fscore"]
                                        > best["best_test_fscore"]):
                        best = row
        if best:
            print("BEST:", json.dumps(best))
        return 0
    for i, combo in enumerate(todo):
        tag = combo_tag(combo)
        save_dir = os.path.join(out_dir, tag)
        if ckpt_lib.has_checkpoint(save_dir, name="final"):
            print(f"[{i + 1}/{len(todo)}] {tag}: already complete, skipping")
            continue
        print(f"[{i + 1}/{len(todo)}] {tag}: training")
        cfg = dataclasses.replace(base, **combo)
        t0 = time.time()
        trainer = Trainer(cfg, device=args.device)
        # resume=True: a preempted combination continues from its 'last'
        # checkpoint instead of restarting at epoch 0
        result = trainer.fit(train, test, valid_dialogues=valid,
                             verbose=False, save_dir=save_dir, resume=True)
        row = dict(tag=tag, **combo,
                   best_epoch=result.best_epoch,
                   best_test_fscore=result.best_test_fscore,
                   best_test_acc=result.best_test_acc,
                   seconds=round(time.time() - t0, 1))
        trainer.model.load_state_dict(result.state_dict)
        ckpt_lib.save_checkpoint(save_dir, trainer.model, meta=row,
                                 name="final")
        with open(summary_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        print("   ->", row)
        if best is None or row["best_test_fscore"] > best["best_test_fscore"]:
            best = row
    if best:
        print("BEST:", json.dumps(best))
    return 0


if __name__ == "__main__":
    sys.exit(main())
