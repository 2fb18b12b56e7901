"""Streaming serving CLI: per-utterance emotion predictions over stdio.

Each stdin line is a JSON utterance ``{"text": [...], "audio": [...],
"visual": [...], "speaker": int}`` (feature vectors in the dataset's dims);
the response line is ``{"pred": int, "label": str, "log_probs": [...],
"latency_ms": float}``.  A line ``{"reset": true}`` starts a new dialogue.
``--warmup`` runs every bucket once before reading input.  The protocol is
that of ``mmdfn_tpu/cli/serve.py``.

Weights come from ``--load_model``: the directory that the port's trainer
wrote (``run_train_erc --save_model_dir``; its ``best`` checkpoint, with
the model rebuilt from the config in its meta and the checkpoint's epoch
reported as ``ckpt_epoch``), or a ``weights.save_model`` file.  Without
it they are fresh from ``--seed`` for the flagship model (16 GCNII
layers).  A directory with no checkpoint, or whose meta holds no config,
exits 1, as does a model that reads another input than the text vector
(early fusion, or one other modality; see ``serve/streaming.py``).  The
non-graph baselines and single-stream models of the text serve as any
other.

Example:
  python -m mmdfn_torch.cli.serve --load_model ckpts/ < utterances.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--load_model", type=str, default=None)
    ap.add_argument("--seed", type=int, default=2021)
    ap.add_argument("--buckets", type=str, default="8,16,32,64,128,200")
    ap.add_argument("--warmup", action="store_true", default=True)
    ap.add_argument("--no-warmup", dest="warmup", action="store_false")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    from mmdfn_torch.config import flagship_config
    from mmdfn_torch.serve import StreamingSession
    from mmdfn_torch.weights import (CheckpointError, build_model,
                                     load_served)

    epoch = None
    if args.load_model is not None:
        try:
            cfg, model, epoch = load_served(args.load_model)
        except CheckpointError as e:
            print(e, file=sys.stderr)
            return 1
    else:
        cfg = flagship_config(seed=args.seed)
        model = build_model(cfg)
    names = cfg.info["target_names"]
    buckets = tuple(int(b) for b in args.buckets.split(","))
    try:
        session = StreamingSession(model, cfg, buckets=buckets,
                                   device=args.device)
    except ValueError as e:         # a model whose input the server lacks
        print(e, file=sys.stderr)
        return 1
    if args.warmup:
        t0 = time.perf_counter()
        session.warmup()
        print(json.dumps({"ready": True,
                          "warmup_s": round(time.perf_counter() - t0, 2),
                          "ckpt_epoch": epoch,
                          "device": str(session.device)}), flush=True)

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        # per-request isolation: a malformed line, an out-of-range speaker
        # or a dialogue past the largest bucket gets an error response and
        # the server keeps running
        try:
            msg = json.loads(line)
            if msg.get("reset"):
                session.reset()
                print(json.dumps({"reset": True}), flush=True)
                continue
            t0 = time.perf_counter()
            pred, logp = session.append(
                np.asarray(msg["text"], np.float32),
                np.asarray(msg["audio"], np.float32),
                np.asarray(msg["visual"], np.float32),
                int(msg.get("speaker", 0)))
            print(json.dumps({
                "pred": pred, "label": names[pred],
                "log_probs": [round(float(v), 4) for v in logp],
                "latency_ms": round((time.perf_counter() - t0) * 1e3, 2)}),
                flush=True)
        except Exception as e:                       # noqa: BLE001
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
