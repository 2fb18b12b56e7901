"""Train MM-DFN with the reference's flags (``mmdfn_tpu/cli/run_train_erc.py``)
on the card, or on the CPU with ``--device cpu`` (or ``--no_cuda``):

    python -m mmdfn_torch.cli.run_train_erc --dataset IEMOCAP \\
        --data_dir IEMOCAP_features.pkl --Deep_GCN_nlayers 16 --lr 0.0003 \\
        --l2 0.0001 --dropout 0.4 --gamma 0.5 --speaker_weights 3-0-1 \\
        --class_weight --reason_flag
    python -m mmdfn_torch.cli.run_train_erc --dataset MELD \\
        --data_dir MELD_features_raw.pkl --Deep_GCN_nlayers 64 --lr 0.0005 \\
        --l2 0.0001 --dropout 0.4 --gamma 0.5 --speaker_weights 0.5-0.5-1.5 \\
        --reason_flag

    python -m mmdfn_torch.cli.run_train_erc --no_graph_model \
        --base_model DialogRNN --attention general --data_dir ...
    python -m mmdfn_torch.cli.run_train_erc --graph_type DeepGCN \
        --mm_fusion_mthd concat --reason_flag --data_dir ...
    python -m mmdfn_torch.cli.run_train_erc --dataset DailyDialogue \
        --base_model GRU --data_dir dailydialog.pkl

Every flag of the JAX CLI is accepted with the same name and default,
except the JAX-only XLA/TPU knobs (:data:`JAX_ONLY_FLAGS`).  ``--tpu_fast``
sets the JAX package's production configuration
(``ExperimentConfig.with_tpu_fast``): the GDF/GF stack then runs in the
TPU training kernel's bf16 numerics (kernels B and D's bf16 mode), and
GF2's and DeepGCN's stacks, which JAX runs as its bf16 layer scan, in
kernels B and D's bf16 scan mode (as does every stack under
``--gcn_compute_dtype bfloat16`` alone); the relation, GCN3 and None
families and the baselines run no GCNII stack and train as without it.
``--transfer_dtype bfloat16`` copies the features to the card as bf16.
Every graph family trains with any multimodal ``--mm_fusion_mthd``;
relation, DeepGCN, GCN3 and None also on one stream (``--no_multi_modal
--modals l``, or ``--mm_fusion_mthd concat``: early fusion) over the
bases LSTM, GRU, DialogRNN and None; ``--no_graph_model`` trains the
GRU, LSTM or DialogRNN baseline (``--active_listener``, ``--attention``,
``--rec_dropout``) with the masked NLL loss.  ``--dataset DailyDialogue``
trains the token model (``DailyTrainer``: the TextCNN at ``--vocab_size``,
``--max_words``, ``--embedding_dim``, ``--cnn_filters``,
``--cnn_output_size``, then the base and the relation graph net) on the
pickle's own train/valid/test splits.  ``--test_label`` restores
``best`` from ``--load_model`` (else ``--save_model_dir``) and evaluates
on test.  Per-epoch lines are the reference's.  ``--profile_dir`` traces
the run with torch.profiler, ``--debug_nans`` turns on autograd's anomaly
mode, and ``--tensorboard`` also writes each batch's gradient histograms.

``--n_data_devices K`` (data parallelism) and ``--n_model_devices M``
(the GCNII stack node-sharded over M ranks) train over K x M ranks
(``runtime/launch.py``): one rank a card on NCCL, the ranks on the CPU
with ``--device cpu``, or every rank on one card over gloo with
``--device cuda:N`` (a check on one card: its walls measure sharing, not
scaling); under ``torchrun`` this process is one of them.
Every rank parses the same flags; the first alone prints, logs and
writes the checkpoints:

    python -m mmdfn_torch.cli.run_train_erc --n_data_devices 2 --data_dir ...
    torchrun --nproc_per_node 2 -m mmdfn_torch.cli.run_train_erc \
        --n_data_devices 2 --data_dir ...
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

# flags of the JAX CLI that tune XLA or the TPU and have no meaning here:
# the scan's unroll and remat and the fused GRU directions change how XLA
# schedules the same math, and --matmul_precision picks XLA's product
# precision, which has no f32-exact counterpart on this card (the port's
# products are f32 on the CUDA cores)
JAX_ONLY_FLAGS = (
    "--matmul_precision", "--gcn_scan_unroll", "--gcn_scan_remat",
    "--rnn_fuse_directions")
# the JAX CLI's off-values of the knobs, which its config keeps as None
# (mmdfn_tpu/cli/run_train_erc.py:199-210)
OFF_VALUES = {"gcn_compute_dtype": "float32", "rnn_compute_dtype": "float32",
              "rnn_backend": "xla", "gcn_backend": "xla",
              "rng_impl": "threefry"}
# the TensorBoard histograms' bins (mmdfn_tpu: 64 under --tensorboard)
GRAD_HIST_BINS = 64


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="MM-DFN trainer on the card (reference-compatible flags)")
    add = p.add_argument
    add("--no_cuda", action="store_true", default=False,
        help="run on the CPU (the plain PyTorch versions); same as "
             "--device cpu")
    add("--dataset", default="IEMOCAP")
    add("--data_dir", type=str,
        default="../data/iemocap/IEMOCAP_features.pkl")
    add("--multi_modal", action="store_true", default=True)
    add("--no_multi_modal", dest="multi_modal", action="store_false")
    add("--modals", default="avl")
    add("--mm_fusion_mthd", default="concat_subsequently")
    add("--use_modal", action="store_true", default=False)
    add("--base_model", default="LSTM")
    add("--graph_model", action="store_true", default=True)
    add("--no_graph_model", dest="graph_model", action="store_false")
    add("--graph_type", default="GDF")
    add("--graph_construct", default="direct")
    add("--use_gcn", action="store_true", default=False)
    add("--nodal_attention", action="store_true", default=True)
    add("--no_nodal_attention", dest="nodal_attention", action="store_false")
    add("--use_topic", action="store_true", default=False)
    add("--use_residue", action="store_true", default=True)
    add("--no_use_residue", dest="use_residue", action="store_false")
    add("--av_using_lstm", action="store_true", default=False)
    add("--active_listener", action="store_true", default=False)
    add("--attention", default="general")
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
    add("--rec_dropout", type=float, default=0.1, metavar="rec_dropout")
    add("--dropout", type=float, default=0.4, metavar="dropout")
    add("--alpha", type=float, default=0.2)
    add("--lamda", type=float, default=0.5)
    add("--gamma", type=float, default=0.5)
    add("--windowp", type=int, default=10)
    add("--windowf", type=int, default=10)
    add("--multiheads", type=int, default=6)
    add("--loss", default="FocalLoss")
    add("--class_weight", action="store_true", default=False)
    add("--save_model_dir", type=str, default="outputs/iemocap_demo/")
    add("--tensorboard", action="store_true", default=False,
        help="write the epoch metrics and each batch's gradient "
             "histograms to <save_model_dir>/tensorboard")
    add("--test_label", action="store_true", default=False,
        help="restore 'best' from --load_model (else --save_model_dir), "
             "evaluate on test and write the labels, predictions and "
             "activations")
    add("--load_model", type=str, default="")
    add("--seed", type=int, default=2021)
    add("--patience", type=int, default=5)
    add("--log_jsonl", type=str, default=None,
        help="append per-epoch metric rows to this JSONL file")
    add("--sort_batches_by_length", action="store_true", default=False,
        help="training batches of dialogues of similar lengths (less "
             "padding)")
    add("--n_data_devices", type=int, default=0,
        help="data-parallel over this many devices (0 = single device)")
    add("--n_model_devices", type=int, default=1,
        help="node-shard the GCNII stack's graph over this many devices "
             "(tensor parallelism for the single-huge-graph regime; "
             "composes with --n_data_devices on a 2-D mesh)")
    add("--profile_dir", type=str, default=None,
        help="write a torch.profiler trace of training to this dir")
    add("--debug_nans", action="store_true", default=False,
        help="raise at the first NaN a backward makes, naming the forward "
             "operator behind it (autograd's anomaly mode)")
    add("--resume", action="store_true", default=False,
        help="continue from save_model_dir's 'last' checkpoint")
    add("--faithful_epoch_reseed", action="store_true", default=True,
        help="reference parity: the same dropout seed stream every epoch")
    add("--no_faithful_epoch_reseed", dest="faithful_epoch_reseed",
        action="store_false")
    add("--edge_attn_type", type=str, default="attn1",
        choices=["attn1", "attn2", "attn3"],
        help="the relation family's edge weights")
    add("--buckets", type=str, default=None,
        help="comma-separated padding lengths, e.g. 16,32,64,128,200")
    # the JAX package's performance knobs, as the port reads them
    add("--tpu_fast", action="store_true",
        help="the JAX package's production configuration (every knob of "
             "ExperimentConfig.TPU_FAST_KNOBS; a knob also given explicitly "
             "keeps its value): the GDF/GF stack in the TPU training "
             "kernel's bf16 numerics, GF2's and DeepGCN's in JAX's bf16 "
             "layer scan's (kernels B and D's bf16 scan mode)")
    add("--gcn_backend", type=str, default=None,
        choices=["xla", "pallas", "pallas_fused"],
        help="'pallas' / 'pallas_fused': the GCNII stack in the TPU "
             "training kernel's bf16 numerics (kernels B and D's bf16 "
             "mode) wherever JAX takes that kernel; 'xla': f32")
    add("--gcn_compute_dtype", type=str, default=None,
        choices=["float32", "bfloat16"],
        help="'bfloat16' where JAX runs the GCNII layer scan in bf16 (no "
             "fused kernel): kernels B and D's bf16 scan mode")
    add("--rnn_compute_dtype", type=str, default=None,
        choices=["float32", "bfloat16"],
        help="'bfloat16' (the encoders' bf16 scans): not ported, raises")
    add("--gcn_bwd_block", type=int, default=None,
        help="accepted; changes nothing: kernel D contracts all rows in one "
             "product (the same sums up to their order)")
    add("--rnn_backend", type=str, default=None, choices=["xla", "pallas"],
        help="accepted; changes nothing: kernels A and C compute the f32 "
             "recurrence of either JAX backend")
    add("--rnn_scan_remat", action="store_true", default=False,
        help="accepted; changes nothing: JAX's remat saves memory only")
    add("--rng_impl", type=str, default=None,
        choices=["threefry", "rbg", "unsafe_rbg"],
        help="accepted; changes nothing: the port's dropout draws are its "
             "own (Philox, torch's generator) and match neither JAX's")
    add("--transfer_dtype", type=str, default="float32",
        choices=["float32", "bfloat16"],
        help="the features' host-to-device copy: 'bfloat16' rounds them to "
             "bf16 on the host, copies half the bytes and widens them on "
             "the card")
    add("--param_dtype", type=str, default="float32",
        choices=["float32", "bfloat16"],
        help="accepted and dropped: the JAX package reads it nowhere")
    add("--device", type=str, default=None,
        help="'cuda' (the default) or 'cpu' for the plain PyTorch versions; "
             "with --n_data_devices / --n_model_devices, 'cuda:N' runs "
             "every rank on card N over gloo")
    # DailyDialogue's token frontend
    add("--vocab_size", type=int, default=5000)
    add("--max_words", type=int, default=20,
        help="the word axis of every utterance (DailyDialogue)")
    add("--embedding_dim", type=int, default=300)
    add("--cnn_filters", type=int, default=50)
    add("--cnn_output_size", type=int, default=100)
    return p


def config_from_args(args):
    from mmdfn_torch.config import DATASET_INFO, ExperimentConfig
    if args.dataset not in DATASET_INFO:
        raise ValueError(f"--dataset {args.dataset}: the port knows "
                         f"{', '.join(DATASET_INFO)}")
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    if args.buckets:
        kw["buckets"] = tuple(int(b) for b in args.buckets.split(","))
    else:
        kw.pop("buckets", None)
    # mmdfn_tpu/cli/run_train_erc.py:186-214: the knobs as given (an
    # explicit opt-out such as --gcn_backend xla beats --tpu_fast), then the
    # off-values normalised to None
    given = {k: kw.get(k) for k in ExperimentConfig.TPU_FAST_KNOBS}
    for k, off in OFF_VALUES.items():
        if kw.get(k) == off:
            kw[k] = None
    cfg = ExperimentConfig(**kw)
    if getattr(args, "tpu_fast", False):
        cfg = dataclasses.replace(cfg, **{
            k: v for k, v in ExperimentConfig.TPU_FAST_KNOBS.items()
            if given.get(k) in (None, False)})
    return cfg


def load_dialogues(cfg, data_dir: str):
    """(train, valid, test) dialogues of the config's dataset (reference
    ``run_train_erc.py:29-89``): valid is the first ``valid_rate`` of the
    training split; DailyDialogue's pickle carries its own three splits
    (``dataloader.py:82-89``), and ``valid_rate`` does not apply."""
    from mmdfn_torch.data.datasets import (DailyDialogueDataset,
                                           IEMOCAPDataset, MELDDataset,
                                           train_valid_split)
    if cfg.dataset == "DailyDialogue":
        return tuple(DailyDialogueDataset(split, data_dir).dialogues()
                     for split in ("train", "valid", "test"))
    ds_cls = {"IEMOCAP": IEMOCAPDataset, "MELD": MELDDataset}[cfg.dataset]
    train_all = ds_cls(data_dir, train=True).dialogues()
    test = ds_cls(data_dir, train=False).dialogues()
    tr_idx, va_idx = train_valid_split(len(train_all), cfg.valid_rate)
    return ([train_all[i] for i in tr_idx], [train_all[i] for i in va_idx],
            test)


def _test_label(args, trainer, test) -> int:
    """Restore ``best`` and evaluate it on test (reference
    ``run_train_erc.py:531-549``); on a mesh every rank evaluates and the
    first writes and prints."""
    from mmdfn_torch.runtime import checkpoint as ckpt_lib
    from mmdfn_torch.runtime.mesh import is_first_rank

    load_dir = args.load_model or args.save_model_dir
    if not ckpt_lib.has_checkpoint(load_dir):
        print(f"no checkpoint found under {load_dir!r}", file=sys.stderr)
        return 1
    ckpt_lib.restore_checkpoint(load_dir, trainer.model)
    m = trainer.evaluate(test)
    first = is_first_rank()
    if first:
        os.makedirs(args.save_model_dir, exist_ok=True)
        np.save(os.path.join(args.save_model_dir, "test_label.npy"),
                m.labels)
        np.save(os.path.join(args.save_model_dir, "test_pred.npy"), m.preds)
    trainer.dump_activations(
        test, os.path.join(args.save_model_dir, "test_activations.npz"))
    if first:
        print(m.report)
        print("test_acc:", m.acc, "test_fscore:", m.fscore)
    return 0


def _tensorboard_writer(save_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        print("tensorboard not installed; epoch metrics go to stdout/JSONL, "
              "gradient histograms are skipped")
        return None
    return SummaryWriter(log_dir=os.path.join(save_dir, "tensorboard"))


def _grad_hist_sink(writer):
    """Per-batch per-parameter gradient histograms (reference
    ``run_train_erc.py:120-122,209-211``), fed from the rows the trainer
    reduced on the device (``mmdfn_tpu/cli/run_train_erc.py:329-344``):
    the tag is ``grad/`` and the parameter's name, ``/`` for ``.``."""
    def sink(step: int, hists: dict):
        for name, h in hists.items():
            writer.add_histogram_raw(
                "grad/" + name.replace(".", "/"), min=float(h["min"]),
                max=float(h["max"]), num=int(h["num"]), sum=float(h["sum"]),
                sum_squares=float(h["sum_sq"]),
                bucket_limits=h["edges"][1:].tolist(),
                bucket_counts=h["counts"].tolist(), global_step=step)
    return sink


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.n_data_devices or args.n_model_devices > 1:
        from mmdfn_torch.runtime import launch
        n_ranks = (args.n_data_devices or 1) * args.n_model_devices
        device = "cpu" if args.no_cuda else (args.device or "cuda")
        return max(launch.run(_rank_main, n_ranks, args, device=device,
                              share_device=launch.names_one_card(device)))
    return _train(args)


def _rank_main(args) -> int:
    """One rank of a multi-device run: its mesh, then the run."""
    from mmdfn_torch.runtime.mesh import make_mesh

    return _train(args, make_mesh(n_data=args.n_data_devices or 1,
                                  n_model=args.n_model_devices))


def _train(args, mesh=None) -> int:
    from mmdfn_torch.runtime.mesh import is_first_rank

    first = is_first_rank()
    if first:
        print(args)
    cfg = config_from_args(args)
    device = "cpu" if args.no_cuda else args.device

    from mmdfn_torch.train import DailyTrainer, Trainer

    cls = DailyTrainer if cfg.dataset == "DailyDialogue" else Trainer
    trainer = cls(cfg, device=device, mesh=mesh)
    train, valid, test = load_dialogues(cfg, args.data_dir)
    if args.test_label:
        return _test_label(args, trainer, test)

    from mmdfn_torch.runtime.profiling import debug_numerics, trace

    if first:
        print("The model have {} parameters in total".format(
            sum(p.numel() for p in trainer.model.parameters())))
    writer = _tensorboard_writer(args.save_model_dir) \
        if args.tensorboard and first else None
    if writer is not None:
        trainer.grad_hist_bins = GRAD_HIST_BINS
        trainer.grad_hist_sink = _grad_hist_sink(writer)
    debug_numerics(args.debug_nans)
    try:
        with trace(args.profile_dir if first else None):
            result = trainer.fit(train, test, valid_dialogues=valid,
                                 verbose=True, log_path=cfg.log_jsonl,
                                 save_dir=args.save_model_dir,
                                 resume=args.resume)
    finally:
        debug_numerics(False)
    if writer is not None:
        for row in result.history:
            for k, v in row.items():
                if isinstance(v, (int, float)) and v == v:
                    writer.add_scalar(k, v, row["epoch"])
        writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
