"""Streaming latency benchmark of the port: p50/p90/p99 as one JSON line,
with the card's stream and busy time per forward at each bucket.

Builds the flagship MM-DFN (IEMOCAP GDF with the reason-LSTM, 16 GCNII
layers, the model ``mmdfn_tpu/serve/latency_bench.py`` measures), feeds
synthetic dialogues utterance by utterance through
:func:`mmdfn_torch.serve.streaming.measure_latency`, and prints the summary.
Weights are fresh from ``--seed`` (latency does not depend on them) or
come from ``--load_model``: the trainer's save directory (its ``best``
checkpoint and the config in its meta; the summary then has its
``ckpt_epoch``) or a ``weights.save_model`` file.  ``--tpu_fast`` serves
the JAX package's production configuration (the GDF/GF stack in the TPU
training kernel's bf16 numerics, kernel B's bf16 mode; a loaded GF2 or
DeepGCN model in JAX's bf16 layer scan's, kernel B's bf16 scan mode), as
``mmdfn_tpu/serve/latency_bench.py --tpu_fast`` does; the summary's
``config`` says which.

    python -m mmdfn_torch.serve.latency_bench --out latency.json
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from typing import Optional, Sequence

from mmdfn_torch.config import ExperimentConfig, flagship_config
from mmdfn_torch.data.batching import SERVE_BUCKETS


def run(cfg: Optional[ExperimentConfig] = None, n_dialogues: int = 6,
        min_len: int = 20, max_len: int = 60,
        buckets: Sequence[int] = SERVE_BUCKETS, seed: int = 0,
        load_model: Optional[str] = None, device=None,
        tpu_fast: bool = False) -> dict:
    """Measure per-utterance streaming latency; returns the summary dict.
    ``tpu_fast``: serve the config (the loaded one too) under
    ``with_tpu_fast()``."""
    from mmdfn_torch.data.datasets import IEMOCAPDataset
    from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
    from mmdfn_torch.serve.streaming import measure_latency
    from mmdfn_torch.weights import build_model, load_served

    epoch = None
    if load_model is not None:
        cfg, model, epoch = load_served(load_model)
        if tpu_fast:
            cfg = cfg.with_tpu_fast()
            model = build_model(cfg, model.state_dict())
    else:
        cfg = cfg or flagship_config(seed=seed)
        if tpu_fast:
            cfg = cfg.with_tpu_fast()
        model = build_model(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/iemocap_synth.pkl"
        make_synthetic_iemocap_pickle(path, n_train=1, n_test=n_dialogues,
                                      min_len=min_len, max_len=max_len,
                                      seed=seed)
        dialogues = IEMOCAPDataset(path, train=False).dialogues()
    summary = measure_latency(model, cfg, dialogues, buckets=buckets,
                              warmup_dialogues=1, device=device)
    name = (f"MM-DFN {cfg.graph_type} {cfg.Deep_GCN_nlayers}L"
            if cfg.graph_model else f"{cfg.base_model} baseline")
    summary.update(
        model=f"{name} ({cfg.dataset})",
        buckets=list(buckets), n_dialogues=n_dialogues,
        dialogue_len=[min_len, max_len], ckpt_epoch=epoch)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=str, default=None,
                    help="write the JSON summary to this path")
    ap.add_argument("--n_dialogues", type=int, default=6)
    ap.add_argument("--min_len", type=int, default=20)
    ap.add_argument("--max_len", type=int, default=60)
    ap.add_argument("--buckets", type=str, default="8,16,32,64,128,200")
    ap.add_argument("--nlayers", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--load_model", type=str, default=None,
                    help="the trainer's save directory or a "
                         "weights.save_model file; default: fresh weights "
                         "from --seed")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--tpu_fast", action="store_true",
                    help="serve in the JAX package's production "
                         "configuration (ExperimentConfig.with_tpu_fast)")
    args = ap.parse_args(argv)
    try:
        summary = run(cfg=flagship_config(args.nlayers, seed=args.seed),
                      n_dialogues=args.n_dialogues, min_len=args.min_len,
                      max_len=args.max_len,
                      buckets=tuple(int(b) for b in args.buckets.split(",")),
                      seed=args.seed, load_model=args.load_model,
                      device=args.device, tpu_fast=args.tpu_fast)
    except ValueError as e:   # a directory it cannot serve (CheckpointError),
        print(e, file=sys.stderr)  # or a model whose input it cannot build
        return 1
    summary["config"] = "tpu_fast" if args.tpu_fast else "parity-default"
    line = json.dumps(summary)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
