"""Train MM-DFN with the reference's flags (``mmdfn_tpu/cli/run_train_erc.py``)
on the card, or on the CPU with ``--device cpu``:

    python -m mmdfn_torch.cli.run_train_erc --dataset IEMOCAP \\
        --data_dir IEMOCAP_features.pkl --Deep_GCN_nlayers 16 --lr 0.0003 \\
        --l2 0.0001 --dropout 0.4 --gamma 0.5 --speaker_weights 3-0-1 \\
        --class_weight --reason_flag

The flags are those of the JAX CLI that map onto this slice's fields (the
base LSTM, the GF/GDF graph, IEMOCAP), with the same names and defaults.
Flags of families the port does not have yet are accepted and raise
``NotImplementedError`` naming the later slice, as ``DialogueGNN.from_config``
does for the other graph families.  Per-epoch lines are the reference's.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

_LATER = "a later slice of the port"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="MM-DFN trainer on the card (reference-compatible flags)")
    add = p.add_argument
    add("--dataset", default="IEMOCAP")
    add("--data_dir", type=str,
        default="../data/iemocap/IEMOCAP_features.pkl")
    add("--modals", default="avl")
    add("--mm_fusion_mthd", default="concat_subsequently")
    add("--use_modal", action="store_true", default=False)
    add("--base_model", default="LSTM")
    add("--graph_model", action="store_true", default=True)
    add("--no_graph_model", dest="graph_model", action="store_false")
    add("--graph_type", default="GDF")
    add("--use_residue", action="store_true", default=True)
    add("--no_use_residue", dest="use_residue", action="store_false")
    add("--av_using_lstm", action="store_true", default=False)
    add("--use_crn_speaker", action="store_true", default=True)
    add("--no_use_crn_speaker", dest="use_crn_speaker", action="store_false")
    add("--speaker_weights", type=str, default="3-0-1")
    add("--use_speaker", action="store_true", default=False)
    add("--reason_flag", action="store_true", default=False)
    add("--epochs", type=int, default=30, metavar="E")
    add("--batch-size", type=int, default=32, metavar="BS", dest="batch_size")
    add("--valid_rate", type=float, default=0.0, metavar="valid_rate")
    add("--modal_weight", type=float, default=1.0)
    add("--Deep_GCN_nlayers", type=int, default=16)
    add("--lr", type=float, default=0.0003, metavar="LR")
    add("--l2", type=float, default=0.0001, metavar="L2")
    add("--dropout", type=float, default=0.4, metavar="dropout")
    add("--alpha", type=float, default=0.2)
    add("--lamda", type=float, default=0.5)
    add("--gamma", type=float, default=0.5)
    add("--loss", default="FocalLoss")
    add("--class_weight", action="store_true", default=False)
    add("--save_model_dir", type=str, default="outputs/iemocap_demo/")
    add("--seed", type=int, default=2021)
    add("--patience", type=int, default=5)
    add("--log_jsonl", type=str, default=None,
        help="append per-epoch metric rows to this JSONL file")
    add("--resume", action="store_true", default=False,
        help="continue from save_model_dir's 'last' checkpoint")
    add("--faithful_epoch_reseed", action="store_true", default=True,
        help="reference parity: the same dropout seed stream every epoch")
    add("--no_faithful_epoch_reseed", dest="faithful_epoch_reseed",
        action="store_false")
    add("--buckets", type=str, default=None,
        help="comma-separated padding lengths, e.g. 16,32,64,128,200")
    add("--device", type=str, default=None,
        help="'cuda' (the default) or 'cpu' for the plain PyTorch versions")
    return p


def config_from_args(args):
    from mmdfn_torch.config import ExperimentConfig
    if args.dataset != "IEMOCAP":
        raise NotImplementedError(f"--dataset {args.dataset}: {_LATER}")
    if not args.graph_model:
        raise NotImplementedError(f"--no_graph_model baselines: {_LATER}")
    if args.av_using_lstm:
        raise NotImplementedError(f"--av_using_lstm: {_LATER}")
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    if args.buckets:
        kw["buckets"] = tuple(int(b) for b in args.buckets.split(","))
    else:
        kw.pop("buckets", None)
    return ExperimentConfig(**kw)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(args)
    cfg = config_from_args(args)

    from mmdfn_torch.data.datasets import IEMOCAPDataset, train_valid_split
    from mmdfn_torch.train import Trainer

    trainer = Trainer(cfg, device=args.device)
    train_all = IEMOCAPDataset(args.data_dir, train=True).dialogues()
    test = IEMOCAPDataset(args.data_dir, train=False).dialogues()
    tr_idx, va_idx = train_valid_split(len(train_all), cfg.valid_rate)
    print("The model have {} parameters in total".format(
        sum(p.numel() for p in trainer.model.parameters())))
    trainer.fit([train_all[i] for i in tr_idx], test,
                valid_dialogues=[train_all[i] for i in va_idx],
                verbose=True, log_path=cfg.log_jsonl,
                save_dir=args.save_model_dir, resume=args.resume)
    return 0


if __name__ == "__main__":
    sys.exit(main())
